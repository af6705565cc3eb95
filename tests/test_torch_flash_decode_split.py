"""The split-KV flash-decode of the port, on the CPU.

``csrc/flash_decode.cu`` splits each row's cache blocks across thread
blocks by :func:`plan_flash_decode`, runs an online softmax in the
base-2 domain within each split (groups of lanes, each over a stride of
the split's tokens, then combined in a fixed order), and lets the last
thread block of each (row, head) combine the splits' partial
``(m, l, o)`` in split order, skipping dead splits (those wholly past
``pos``: ``m = -1e30``, ``l = 0``, ``o`` never written).  The CUDA code
runs only on a GPU (tests/test_torch_cuda.py, chip_smoke.py); here the
planner is checked as the pure function it is, and the kernel's
arithmetic is written out in PyTorch (in this file, not in the package)
and held against the JAX package's reference and its Pallas kernel in
interpret mode, on identical float32 inputs made with numpy, at every
split edge and with fully masked splits.  Tolerance 1e-5: float32 with
another summation order, as ``tests/test_torch_kernels.py``'s parity
test.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import flash_decode as jfd
from mxnet_tpu_torch.kernels import flash_decode as tfd
from mxnet_tpu_torch.kernels import rtc_kernels as rk

SMS = 132          # an H100 SXM's SMs
NEG_INF = -1e30
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mb", [1, 7, 32])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 8])
def test_plan_covers_every_block_once(b, mb):
    """Each of a row's MB table slots lies in exactly one split, no split
    is empty of slots, and the grid is (splits, H, B)."""
    plan = tfd.plan_flash_decode(b, 8, mb, 32, 64, SMS)
    bps, splits = plan["blocks_per_split"], plan["splits"]
    spans = [range(s * bps, min((s + 1) * bps, mb)) for s in range(splits)]
    assert all(len(sp) > 0 for sp in spans)
    assert sorted(j for sp in spans for j in sp) == list(range(mb))
    assert plan["grid"] == (splits, 8, b)
    assert plan["ctas"] == splits * 8 * b
    if splits > 1:
        assert plan["workspace"] == b * 8 * splits * (64 + 2)
        assert plan["counters"] == b * 8
    else:
        assert plan["workspace"] == 0 and plan["counters"] == 0
    # a function of its arguments alone
    assert tfd.plan_flash_decode(b, 8, mb, 32, 64, SMS) == plan


def test_plan_fills_the_card_at_the_decode_buckets():
    """At the serving shapes (H=8, 32 slots) the grid gives several
    thread blocks an SM at B=8 and at least one at B=1, when every row is
    full, and never splits finer than one slot."""
    for b in (1, 2, 4, 8):
        plan = tfd.plan_flash_decode(b, 8, 32, 32, 64, SMS)
        assert plan["ctas"] >= SMS
        assert plan["blocks_per_split"] >= 1
    assert tfd.plan_flash_decode(8, 8, 32, 32, 64, SMS)["ctas"] >= 3 * SMS


@pytest.mark.parametrize("sms,bps,splits", [
    (16, 32, 1), (64, 8, 4), (132, 4, 8), (176, 3, 11), (256, 2, 16),
    (512, 1, 32)])
def test_plan_split_follows_the_sm_count(sms, bps, splits):
    """B=8, H=8, 32 slots: the split follows the card's SM count, from
    no split on a small card to one slot a block on a large one, the
    last split shorter where MB is not a multiple (3 slots a split: 11
    splits, the last of 2)."""
    plan = tfd.plan_flash_decode(8, 8, 32, 32, 64, sms)
    assert (plan["blocks_per_split"], plan["splits"]) == (bps, splits)
    assert plan["ctas"] == splits * 64


# ---------------------------------------------------------------------------
# the kernel's arithmetic, written out in PyTorch
# ---------------------------------------------------------------------------
def split_combine_model(q, k_pool, v_pool, table, pos, scale, bps, gph=4,
                        tokens=8):
    """``csrc/flash_decode.cu``'s order of operations in float32: per
    split, ``gph`` groups each run an online softmax (base 2, q scaled by
    ``scale * log2(e)``) over every ``gph``-th token up to ``pos``,
    ``tokens`` at a time; the groups meet by their max; the splits
    combine in order, dead ones skipped.  A dead split's ``o`` is left as
    NaN, as an uninitialised workspace may hold.  A row with ``pos < 0``
    takes every slot of its table, each score set to -1e30.  Table
    entries are clamped into the pool."""
    B, H, D = q.shape
    NB, BS, MB = k_pool.shape[0], k_pool.shape[1], table.shape[1]
    splits = -(-MB // bps)
    qs = q.float() * (scale * LOG2E)
    table = table.clamp(0, NB - 1)
    out = torch.empty(B, H, D)
    for b in range(B):
        p = int(pos[b])
        ws_m = torch.full((splits, H), NEG_INF)
        ws_l = torch.zeros(splits, H)
        ws_o = torch.full((splits, H, D), float("nan"))
        for sp in range(splits):
            t_begin = sp * bps * BS
            t_end = min(t_begin + bps * BS, MB * BS)
            if p >= 0:
                t_end = min(t_end, p + 1)
            if t_begin >= t_end:
                continue                      # dead: m = -1e30, l = 0
            gm = torch.full((gph, H), NEG_INF)
            gl = torch.zeros(gph, H)
            go = torch.zeros(gph, H, D)
            for base in range(t_begin, t_end, tokens * gph):
                for tg in range(gph):
                    ts = [t for t in range(base + tg, base + tg + tokens * gph,
                                           gph) if t < t_end]
                    if not ts:
                        continue
                    blk = table[b, [t // BS for t in ts]].long()
                    off = torch.tensor([t % BS for t in ts])
                    kk = k_pool[blk, off].float()          # (n, H, D)
                    vv = v_pool[blk, off].float()
                    s = torch.einsum("hd,nhd->nh", qs[b], kk)
                    if p < 0:
                        s = torch.full_like(s, NEG_INF)
                    m_new = torch.maximum(gm[tg], s.max(0).values)
                    corr = torch.exp2(gm[tg] - m_new)
                    pu = torch.exp2(s - m_new)
                    gl[tg] = gl[tg] * corr + pu.sum(0)
                    go[tg] = go[tg] * corr[:, None] + torch.einsum(
                        "nh,nhd->hd", pu, vv)
                    gm[tg] = m_new
            m = gm.max(0).values
            w = torch.exp2(gm - m)
            ws_m[sp], ws_l[sp] = m, (gl * w).sum(0)
            ws_o[sp] = (go * w[..., None]).sum(0)
        live = ws_l > 0
        m = torch.where(live, ws_m, torch.full_like(ws_m, NEG_INF)).max(0)
        w = torch.where(live, torch.exp2(ws_m - m.values),
                        torch.zeros_like(ws_m))
        o = torch.where(live[..., None], ws_o, torch.zeros_like(ws_o))
        out[b] = ((o * w[..., None]).sum(0)
                  / torch.clamp((ws_l * w).sum(0), min=1e-30)[:, None])
    return out


def _case(pos, seed, h=2, d=16, bs=8, mb=8):
    """Row b at position pos[b], its live blocks distinct random pool
    blocks, trailing slots on trash block 0, random values everywhere."""
    rng = np.random.RandomState(seed)
    pos = np.asarray(pos, np.int32)
    b = len(pos)
    nb = b * mb + 1
    q = rng.randn(b, h, d).astype(np.float32)
    k_pool = rng.randn(nb, bs, h, d).astype(np.float32)
    v_pool = rng.randn(nb, bs, h, d).astype(np.float32)
    free = list(rng.permutation(np.arange(1, nb)))
    table = np.zeros((b, mb), np.int32)
    for i in range(b):
        n = min(mb, int(pos[i]) // bs + 1)
        table[i, :n] = [free.pop() for _ in range(n)]
    return q, k_pool, v_pool, table, pos


def _edges(bs, bps, mb):
    """First slot, end of the first block, start of the second, end and
    start of a split's span, the last slot: every split edge."""
    return [0, bs - 1, bs, bps * bs - 1, bps * bs, mb * bs - 1]


@pytest.mark.parametrize("bps,gph", [(1, 4), (2, 4), (3, 2), (4, 8),
                                     (8, 4)])
def test_split_model_matches_jax(bps, gph):
    """The split arithmetic == the JAX reference and its Pallas kernel
    (interpret), atol 1e-5, at every split edge (dead splits after each
    short row), with no NaN from the dead splits' workspace."""
    bs, mb = 8, 8
    pos = _edges(bs, bps, mb)
    case = _case(pos, seed=bps)
    scale = 1.0 / math.sqrt(case[0].shape[-1])
    got = split_combine_model(*[torch.from_numpy(a) for a in case],
                              scale=scale, bps=bps, gph=gph)
    assert not torch.isnan(got).any()
    jargs = [jnp.asarray(a) for a in case]
    kern = jfd.flash_decode_attention(*jargs, scale=scale, interpret=True)
    ref = jfd.decode_attention_reference(*jargs, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("b", [1, 2, 3, 4, 8])
def test_split_model_under_the_plan(b):
    """The plan the card would run at each decode bucket (and a ragged
    B=3), at the serving block and table widths, position 0 among them
    (every split but the first dead): the split arithmetic against the
    port's plain version, which tests/test_torch_kernels.py holds against
    the JAX package, atol 1e-5, and against the JAX reference."""
    bs, mb = 32, 32
    plan = tfd.plan_flash_decode(b, 2, mb, bs, 16, SMS)
    edges = _edges(bs, plan["blocks_per_split"], mb)
    pos = ([0] + edges[1:] + [700, 300])[:b]
    case = _case(pos, seed=b, bs=bs, mb=mb)
    targs = [torch.from_numpy(a) for a in case]
    got = split_combine_model(*targs, scale=0.25,
                              bps=plan["blocks_per_split"])
    assert not torch.isnan(got).any()
    plain = tfd.flash_decode_attention(*targs, scale=0.25)    # CPU: plain
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=0)
    ref = jfd.decode_attention_reference(*[jnp.asarray(a) for a in case],
                                         scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_fully_masked_splits_contribute_nothing():
    """pos = 0 leaves one live token: the result is that token's value,
    whatever the dead splits' workspace holds."""
    case = _case([0, 0], seed=7)
    targs = [torch.from_numpy(a) for a in case]
    got = split_combine_model(*targs, scale=0.5, bps=1)
    q, k_pool, v_pool, table, _ = targs
    want = v_pool[table[:, 0].long(), 0]                     # (B, H, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("bps,gph", [(1, 4), (3, 2), (8, 4)])
@pytest.mark.parametrize("pos", [[-1], [-5, 40], [-1, 700 % 64, 0]])
def test_split_model_negative_pos_matches_jax(pos, bps, gph):
    """pos < 0 (outside the engine's use): the split arithmetic, whose
    every split of such a row is live with all scores at -1e30, gives
    the JAX Pallas kernel's result (interpret) and its reference's, the
    mean of v over every slot of the row's table, atol 1e-5; a table
    entry past the pool is clamped as the JAX gather clamps it."""
    q, k_pool, v_pool, table, pos = _case(pos, seed=len(pos) + bps)
    table[0, -1] = k_pool.shape[0] + 5             # past the pool
    case = q, k_pool, v_pool, table, pos
    targs = [torch.from_numpy(a) for a in case]
    got = split_combine_model(*targs, scale=0.25, bps=bps, gph=gph)
    assert not torch.isnan(got).any()
    jargs = [jnp.asarray(a) for a in case]
    kern = jfd.flash_decode_attention(*jargs, scale=0.25, interpret=True)
    ref = jfd.decode_attention_reference(*jargs, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    plain = tfd.flash_decode_attention(*targs, scale=0.25)   # CPU: plain
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=0)
    bs, mb = v_pool.shape[1], table.shape[1]
    rows = np.minimum(table[0], k_pool.shape[0] - 1)
    avg = v_pool[rows].reshape(mb * bs, *v_pool.shape[2:]).mean(0)
    np.testing.assert_allclose(got[0].numpy(), avg, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pos", [[-1], [-5, 40]])
def test_negative_pos_plain_versions_agree(pos):
    """pos < 0 is outside the engine's use (decode_attention_reference's
    docstring): the port's plain version then gives, as the JAX
    reference and its Pallas kernel (interpret) do, the plain average of
    v over every slot of the row's table (as the CUDA kernel does:
    tests/test_torch_cuda.py, and the split model above); rows with
    pos >= 0 are unaffected."""
    case = _case(pos, seed=11)
    targs = [torch.from_numpy(a) for a in case]
    got = tfd.flash_decode_attention(*targs, scale=0.25)     # CPU: plain
    jargs = [jnp.asarray(a) for a in case]
    ref = jfd.decode_attention_reference(*jargs, scale=0.25)
    kern = jfd.flash_decode_attention(*jargs, scale=0.25, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5,
                               rtol=0)
    _q, _k, v_pool, table, _p = targs
    bs, mb = v_pool.shape[1], table.shape[1]
    avg = v_pool[table[0].long()].reshape(mb * bs, *v_pool.shape[2:])
    np.testing.assert_allclose(got[0].numpy(), avg.mean(0).numpy(),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# saxpy's grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_saxpy_grid_follows_the_card(sms):
    """At 2^24 elements the grid is SAXPY_BLOCKS_PER_SM blocks an SM
    (not n / 256); small arrays take only the tiles they fill; 256
    threads a block."""
    grid, block = rk.saxpy_dims(1 << 24, sms)
    assert grid == (sms * rk.SAXPY_BLOCKS_PER_SM, 1, 1)
    assert block == (256, 1, 1)
    assert rk.saxpy_dims(8 * 1024, sms)[0] == (1, 1, 1)
    assert rk.saxpy_dims(8 * 1024 + 1, sms)[0] == (min(2, sms * 8), 1, 1)
    assert rk.saxpy_dims(1, sms)[0] == (1, 1, 1)
