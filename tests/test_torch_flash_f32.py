"""The float32 flash-attention forward body of the port, on the CPU.

``csrc/flash_attention.cu``'s FMA body (``flash_forward_fma``) runs only
on a GPU (tests/test_torch_cuda.py, chip_smoke.py).  Here its planner
(``plan_flash_forward``, ``work_item``) is checked as the pure function
it is and held to the tiles, work order and mask tests written in the
kernel's source, and its arithmetic is written out in PyTorch (in this file, not in
the package): q tiles of ``block_q`` rows taken in the kernel's work
order, 64-key tiles in order, q pre-scaled by ``scale * log2(e)``,
``exp2``, the mask applied only on tiles that cross the causal diagonal
or the ragged edge, O rescaled only where a row max moved, each row sum
kept as 8 lane partials until the end.  (The kernel also skips the
products of a 128-row item's first 64 rows on its last causal tile,
where every key is masked for them: p = 0 there either way.)  That
model is held against the JAX package's Pallas ``_flash_kernel`` in
interpret mode (S a multiple of its block) and, at ragged S, against
its jnp ``attention_reference``, on identical float32 inputs made with
numpy.  Tolerances: 2e-5 on o and
1e-4 on lse, the GPU gate of the kernel (chip_smoke.py phase 5): float32
with another summation order and a base-2 exponential.
"""
import math
import os
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.parallel import ring_attention as jra
from mxnet_tpu_torch.kernels import flash_attention as tfa

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mxnet_tpu_torch", "csrc", "flash_attention.cu")


def _mask_tile(k0, q0, plan, Sk, causal):
    """The kernel's tile-level test: does tile k0 of item q0 need masks?"""
    return (k0 + plan["block_k"] > Sk
            or (causal and k0 + plan["block_k"] - 1 > q0))


def fma_body_model(q, k, v, causal, scale):
    """``flash_forward_fma``'s order of operations in float32, item by
    item in the kernel's order.  Returns ``(o, lse, visits)``, visits
    the ``(bh, q0)`` of each item as taken."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    BH = B * H
    plan = tfa.plan_flash_forward(BH, Sq, Sk, D, causal)
    bq, bk = plan["block_q"], plan["block_k"]
    q3, k3, v3 = (x.reshape(BH, -1, D).float() for x in (q, k, v))
    o = torch.empty(BH, Sq, D)
    lse = torch.empty(BH, Sq)
    visits = []
    for t in range(plan["items"]):
        bh, q0 = tfa.work_item(t, BH, plan["n_qtiles"], bq)
        visits.append((bh, q0))
        rows = torch.arange(q0, q0 + bq)
        qt = torch.zeros(bq, D)
        n = min(bq, Sq - q0)
        qt[:n] = q3[bh, q0:q0 + n]
        qt = qt * torch.tensor(scale * LOG2E, dtype=torch.float32)
        m = torch.full((bq,), NEG_INF)
        l = torch.zeros(bq, 8)                # lane tx's part of a row sum
        acc = torch.zeros(bq, D)
        for j in range(plan["k_tiles"](q0)):
            k0 = j * bk
            kt = torch.zeros(bk, D)
            vt = torch.zeros(bk, D)
            nk = min(bk, Sk - k0)
            kt[:nk] = k3[bh, k0:k0 + nk]
            vt[:nk] = v3[bh, k0:k0 + nk]
            s = qt @ kt.T
            if _mask_tile(k0, q0, plan, Sk, causal):
                cols = torch.arange(k0, k0 + bk)[None, :]
                bad = cols >= Sk
                if causal:
                    bad = bad | (cols > rows[:, None])
                s = torch.where(bad, torch.full_like(s, NEG_INF), s)
            m_new = torch.maximum(m, s.max(1).values)
            corr = torch.exp2(m - m_new)
            moved = m_new != m
            m = m_new
            p = torch.exp2(s - m_new[:, None])
            # key tx + 8 jj lies in lane tx: sum over jj per lane
            l = l * corr[:, None] + p.reshape(bq, bk // 8, 8).sum(1)
            acc = torch.where(moved[:, None], acc * corr[:, None], acc)
            acc = acc + p @ vt
        ls = torch.clamp(l.sum(1), min=1e-30)
        o[bh, q0:q0 + n] = (acc * (1.0 / ls)[:, None])[:n]
        lse[bh, q0:q0 + n] = (m * LN2 + torch.log(ls))[:n]
    return o.reshape(B, H, Sq, D), lse.reshape(B, H, Sq), visits


def _qkv(seed, B=1, H=2, Sq=256, Sk=None, D=64):
    rng = np.random.RandomState(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, H, Sk, D).astype(np.float32),
            rng.randn(B, H, Sk, D).astype(np.float32))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("BH,S,D", [(64, 1024, 64), (64, 1000, 64),
                                    (6, 77, 32), (64, 1024, 128),
                                    (3, 333, 128), (1, 1, 64)])
def test_plan_covers_every_item_once_longest_first(BH, S, D, causal):
    """Every (batch*head, q tile) is one work item, taken once, in an
    order whose causal walks never lengthen."""
    plan = tfa.plan_flash_forward(BH, S, S, D, causal)
    bq = plan["block_q"]
    assert bq == tfa.F32_BLOCK_Q[D] and plan["block_k"] == 64
    assert plan["n_qtiles"] == -(-S // bq)
    assert plan["items"] == BH * plan["n_qtiles"]
    order = [tfa.work_item(t, BH, plan["n_qtiles"], bq)
             for t in range(plan["items"])]
    assert sorted(order) == [(bh, i * bq) for bh in range(BH)
                             for i in range(plan["n_qtiles"])]
    walks = [plan["k_tiles"](q0) for _bh, q0 in order]
    assert walks == sorted(walks, reverse=True)
    assert walks[0] == -(-S // 64) and min(walks) >= 1


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,D", [(1024, 1024, 64), (1000, 1000, 64),
                                     (200, 77, 32), (77, 200, 128),
                                     (333, 333, 128)])
def test_unmasked_tiles_need_no_mask(Sq, Sk, D, causal):
    """The tile-level test is exact where it skips the mask: no stored
    row of an unflagged tile has a key past Sk or, causal, above the
    diagonal.  At S=1024, D=64 causal, 2 of each item's tiles are masked."""
    plan = tfa.plan_flash_forward(1, Sq, Sk, D, causal)
    bq, bk = plan["block_q"], plan["block_k"]
    masked = 0
    for t in range(plan["items"]):
        _bh, q0 = tfa.work_item(t, 1, plan["n_qtiles"], bq)
        last_row = min(q0 + bq, Sq) - 1
        for j in range(plan["k_tiles"](q0)):
            k0 = j * bk
            if _mask_tile(k0, q0, plan, Sk, causal):
                masked += 1
                continue
            assert k0 + bk <= Sk
            assert not causal or k0 + bk - 1 <= q0 <= last_row
    if (Sq, Sk, D, causal) == (1024, 1024, 64, True):
        assert masked == 2 * plan["items"]


def _kernel_exprs():
    """The float32 body's tiles, work order, walk and mask tests, read out
    of ``csrc/flash_attention.cu`` (``FmaCfg<D>``, ``flash_forward_fma``)
    as Python: name -> a function of the kernel's variables."""
    with open(_CU) as f:
        src = f.read()
    cfg = re.search(r"struct FmaCfg \{(.*?)\n\};", src, re.S).group(1)
    body = src[src.index("flash_forward_fma(const float*"):]
    body = body[:body.index("\n}\n")]
    found = {
        "BQ": re.search(r"\bBQ = ([^;]*);", cfg).group(1),
        "BK": re.search(r"\bBK = ([^;]*);", cfg).group(1),
        "RM": re.search(r"\bRM = ([^;]*);", cfg).group(1),
        "t": re.search(r"const int t = ([^;]*);", body).group(1),
        "bh": re.search(r"const int bh = ([^,]*), q0", body).group(1),
        "q0": re.search(r"q0 = ([^;]*);", body).group(1),
        "n_tiles": re.search(r"int n_tiles = ([^;]*);", body).group(1),
        "causal_tiles": re.search(r"if \(causal\) n_tiles = ([^;]*);",
                                  body).group(1),
        "mask": re.search(r"// the mask, only on a tile[^\n]*\n\s*if \((.*)\) \{",
                          body).group(1),
        "half": re.search(r"const bool half = ([^;]*);", body).group(1),
    }

    def python(c):
        c = re.sub(r"^(.*) \? (.*) : (.*)$", r"(\2 if \1 else \3)", c)
        c = c.replace("C::", "").replace("&&", " and ").replace("||", " or ")
        return re.sub(r"(?<![/])/(?!/)", "//", c)

    return {name: (lambda c: lambda **env: eval(c, {"min": min}, env))(
        python(c)) for name, c in found.items()}


@pytest.mark.parametrize("D", [32, 64, 128])
def test_planner_is_the_kernels_own(D):
    """plan_flash_forward and work_item state the kernel's own tiles, work
    order and causal walk, and the model's tile-level mask test is the
    kernel's: the expressions are read out of flash_forward_fma's source
    and evaluated over every item and tile of ragged and square shapes.
    The kernel's skip of an item's first half of rows (ty + 16 i, i <
    RM / 2) happens only on masked tiles whose every key lies past them."""
    ex = _kernel_exprs()
    bq, bk = ex["BQ"](D=D), ex["BK"](D=D)
    rm = ex["RM"](BQ=bq)
    assert (bq, bk) == (tfa.F32_BLOCK_Q[D], tfa.F32_BLOCK_K)
    for BH, Sq, Sk in [(3, 1024, 1024), (2, 200, 77), (2, 77, 200),
                       (1, 1, 1), (5, 333, 333), (1, 129, 1000)]:
        for causal in (False, True):
            plan = tfa.plan_flash_forward(BH, Sq, Sk, D, causal)
            n_qtiles = plan["n_qtiles"]
            assert plan["block_q"] == bq and plan["block_k"] == bk
            for cta in range(plan["items"]):
                t = ex["t"](blockIdx=types.SimpleNamespace(x=cta))
                env = dict(t=t, BH=BH, n_qtiles=n_qtiles, BQ=bq, BK=bk,
                           Sk=Sk, RM=rm, causal=causal)
                q0 = ex["q0"](**env)
                assert (ex["bh"](**env), q0) == tfa.work_item(
                    cta, BH, n_qtiles, bq)
                n_tiles = ex["n_tiles"](**env)
                if causal:
                    n_tiles = ex["causal_tiles"](n_tiles=n_tiles, q0=q0,
                                                 **env)
                assert n_tiles == plan["k_tiles"](q0)
                for j in range(n_tiles):
                    k0 = j * bk
                    mask = ex["mask"](k0=k0, q0=q0, **env)
                    assert bool(mask) == _mask_tile(k0, q0, plan, Sk, causal)
                    if ex["half"](k0=k0, q0=q0, **env):
                        assert mask and k0 >= q0 + 16 * (rm // 2)


# ---------------------------------------------------------------------------
# the body's arithmetic against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_model_matches_pallas_interpret(D, causal):
    """S = 256: the model == the JAX Pallas flash kernel (interpret,
    128-row blocks), o within 2e-5 and lse within 1e-4, every item
    visited once."""
    q, k, v = _qkv(D + causal, D=D)
    scale = 1.0 / math.sqrt(D)
    jo, jl = jra._flash_forward_kernel_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        128, 128, True)
    o, lse, visits = fma_body_model(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, scale=scale)
    assert len(set(visits)) == len(visits)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,D", [(200, 200, 64), (77, 77, 64),
                                     (200, 200, 128), (77, 77, 32),
                                     (200, 77, 64), (77, 200, 64)])
def test_model_ragged_matches_reference(Sq, Sk, D, causal):
    """Ragged S, q tiles that cross both the diagonal and the ragged
    edge, Sq != Sk too (where the Pallas kernel needs multiples of its
    block): o against the JAX package's jnp attention_reference within
    2e-5, lse against the port's plain version (held against the JAX
    kernel in tests/test_torch_flash_opt.py) within 1e-4."""
    q, k, v = _qkv(Sq + Sk + D, B=2, H=1, Sq=Sq, Sk=Sk, D=D)
    scale = 1.0 / math.sqrt(D)
    want = jra.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   scale=scale)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse, _visits = fma_body_model(tq, tk, tv, causal=causal, scale=scale)
    _ro, rl = tfa.flash_attention_forward_reference(tq, tk, tv,
                                                    causal=causal,
                                                    scale=scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), rl.numpy(), atol=1e-4, rtol=0)
