"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips without a CUDA device (this file makes
no decision at import time).  It imports neither JAX nor ``mxnet_tpu``,
so on a machine without JAX run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 kernel vs plain differ only in summation order;
bfloat16 rounds the output (and, in the plain version, intermediate
scores) to 8 mantissa bits.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels are CUDA C++ "
                    "for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 parity
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _decode_case(dev, dtype, b=5, h=3, d=48, nb=20, bs=16, mb=6, seed=0):
    rng = np.random.RandomState(seed)
    pos = np.array([0, bs - 1, bs, mb * bs - 1, 37][:b], np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    table = np.zeros((b, mb), np.int32)
    for i in range(b):
        n = pos[i] // bs + 1
        table[i, :n] = [free.pop() for _ in range(n)]
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(nb, bs, h, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(nb, bs, h, d).astype(np.float32))
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))


@pytest.mark.parametrize("dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    # a bfloat16 cache under float32 compute: the plain version widens
    # the pools to float32 too, so only the summation order differs
    (torch.float32, torch.bfloat16, 2e-5)])
def test_flash_decode_kernel_matches_plain(cuda, dtype, kv_dtype, tol):
    from mxnet_tpu_torch.kernels import flash_decode as fd
    q, k, v, table, pos = _decode_case(cuda, dtype)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    before = fd.flash_decode_attention.launches
    got = fd.flash_decode_attention(q, k, v, table, pos, scale=0.3)
    want = fd.decode_attention_reference(q, k, v, table, pos, scale=0.3)
    torch.cuda.synchronize()
    assert fd.flash_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_decode_kernel_rejects_bad_inputs(cuda):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.kernels import flash_decode as fd
    q, k, v, table, pos = _decode_case(cuda, torch.float32)
    with pytest.raises(MXNetError):
        fd.flash_decode_attention(q, k, v, table.long(), pos)
    with pytest.raises(MXNetError):
        fd.flash_decode_attention(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), k, v, table, pos)
    with pytest.raises(MXNetError):
        fd.flash_decode_attention(q.half(), k.half(), v.half(), table, pos)


#: the split edges of a plan: first slot, last of the first block, first
#: of the second, last and first of a split's span, the last slot
def _edges(bs, bps, mb):
    return [0, bs - 1, bs, bps * bs - 1, bps * bs, mb * bs - 1]


def _split_case(dev, dtype, kv_dtype, pos, h=8, d=64, bs=32, mb=32,
                seed=0):
    rng = np.random.RandomState(seed)
    pos = np.asarray(pos, np.int32)
    b = len(pos)
    nb = b * mb + 1
    free = list(rng.permutation(np.arange(1, nb)))
    table = np.zeros((b, mb), np.int32)
    for i in range(b):
        n = min(mb, int(pos[i]) // bs + 1)
        table[i, :n] = [free.pop() for _ in range(n)]
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(nb, bs, h, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(nb, bs, h, d).astype(np.float32))
    return (q.to(dev, dtype), k.to(dev, kv_dtype), v.to(dev, kv_dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 2e-5)])
def test_flash_decode_split_edges(cuda, b, d, dtype, kv_dtype, tol):
    """Every split edge of the card's plan, B rows at a time, at the
    serving shapes (H=8, 32-token blocks, 32 slots): within the
    tolerance, no NaN, and the same bits on a second call."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = fd.plan_flash_decode(b, 8, 32, 32, d, sms)
    assert plan["splits"] > 1
    edges = _edges(32, plan["blocks_per_split"], 32)
    for i in range(0, len(edges), b):
        pos = (edges[i:i + b] + [700, 300, 17, 900, 640, 1000, 5])[:b]
        q, k, v, table, p = _split_case(cuda, dtype, kv_dtype, pos, d=d,
                                        seed=i)
        got = fd.flash_decode_attention(q, k, v, table, p)
        again = fd.flash_decode_attention(q, k, v, table, p)
        want = fd.decode_attention_reference(q, k, v, table, p)
        torch.cuda.synchronize()
        assert not torch.isnan(got).any()
        assert torch.equal(got, again), pos
        assert float((got.float() - want.float()).abs().max()) <= tol, pos


@pytest.mark.parametrize("sms", [16, 176, 512])
def test_flash_decode_other_plans(cuda, monkeypatch, sms):
    """The kernel is right under any plan the planner makes for another
    card (B=8, H=8, 32 slots): no split (16 SMs), uneven splits of 3
    slots (176), one slot a split (512)."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    plan_fn = fd.plan_flash_decode
    monkeypatch.setattr(fd, "plan_flash_decode",
                        lambda B, H, MB, BS, D, _sms: plan_fn(B, H, MB, BS,
                                                              D, sms))
    monkeypatch.setattr(fd, "_PLANS", {})
    q, k, v, table, p = _split_case(cuda, torch.float32, torch.float32,
                                    _edges(32, 3, 32) + [700, 1000])
    got = fd.flash_decode_attention(q, k, v, table, p)
    again = fd.flash_decode_attention(q, k, v, table, p)
    want = fd.decode_attention_reference(q, k, v, table, p)
    torch.cuda.synchronize()
    assert fd._PLANS[(cuda.index, 8, 8, 32, 32, 64)] == plan_fn(
        8, 8, 32, 32, 64, sms)
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 2e-5)])
@pytest.mark.parametrize("pos", [[-1, 700, 0], [-7], [-1, -3, 1023, 31]])
def test_flash_decode_negative_pos_averages_every_slot(cuda, pos, dtype,
                                                       kv_dtype, tol):
    """pos < 0 is outside the engine's use: such a row gets, as from the
    plain version and the JAX package, the mean of v over every slot of
    its table (here a row with pos < 0 names trash block 0 in every
    slot, so one last entry is set past the pool: it is clamped); every
    row equals the plain version, bit for bit from run to run."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    q, k, v, table, p = _split_case(cuda, dtype, kv_dtype, pos)
    table[0, -1] = k.shape[0] + 3
    got = fd.flash_decode_attention(q, k, v, table, p)
    again = fd.flash_decode_attention(q, k, v, table, p)
    want = fd.decode_attention_reference(q, k, v, table, p)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) <= tol
    slots = table[0].long().clamp(0, k.shape[0] - 1)
    mean = v[slots].float().reshape(-1, *v.shape[2:]).mean(0)
    assert float((got[0].float() - mean).abs().max()) <= tol


def test_flash_decode_one_kernel_a_call(cuda):
    """torch.profiler sees exactly one kernel for each call (no memset of
    the counters, no combine launch), and the counters are back at zero
    after two calls in a row."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.kernels import flash_decode as fd
    q, k, v, table, p = _split_case(cuda, torch.float32, torch.float32,
                                    [0, 31, 32, 1023, 17, 300, 640, 900])
    fd.flash_decode_attention(q, k, v, table, p)        # counters made
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fd.flash_decode_attention(q, k, v, table, p)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and "memcpy" not in e.name.lower()]
    assert len(kernels) == 3, [e.name for e in kernels]
    assert all("flash_decode" in e.name for e in kernels)
    fd.flash_decode_attention(q, k, v, table, p)
    fd.flash_decode_attention(q, k, v, table, p)
    torch.cuda.synchronize()
    assert fd._SCRATCH and all(int(c.abs().sum()) == 0
                               for c, _ws in fd._SCRATCH.values())


def test_flash_decode_two_streams(cuda):
    """Calls on two streams at once keep their counters apart."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    case = _split_case(cuda, torch.float32, torch.float32, [1023] * 8)
    want = fd.decode_attention_reference(*case)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            outs.append([fd.flash_decode_attention(*case) for _ in range(4)])
    torch.cuda.synchronize()
    for o in outs:
        for got in o:
            assert float((got - want).abs().max()) <= 2e-5
    keys = {key for key in fd._SCRATCH if key[0] == cuda.index}
    assert {s.cuda_stream for s in streams} <= {key[1] for key in keys}


def test_flash_decode_rejects_wide_heads(cuda):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.kernels import flash_decode as fd
    q, k, v, table, p = _split_case(cuda, torch.float32, torch.float32,
                                    [5], h=1, d=264, mb=2)
    with pytest.raises(MXNetError, match="D=264"):
        fd.flash_decode_attention(q, k, v, table, p)


@pytest.mark.parametrize("m,k,n,dtype,tol", [
    (1, 512, 2048, torch.float32, 1e-4),
    (67, 100, 130, torch.float32, 1e-4),      # ragged on every dim
    (8, 2048, 512, torch.float32, 1e-4),
    (33, 512, 96, torch.bfloat16, 2e-2),
    # both sides of the route threshold (M <= 16: GEMV, else wgmma)
    (16, 2048, 512, torch.float32, 1e-4),
    (17, 512, 2048, torch.float32, 1e-4),
    (240, 512, 2048, torch.float32, 1e-4),    # wgmma with split K
    (960, 512, 8192, torch.float32, 1e-4),    # a prefill bucket, lm_head
    (8, 512, 8192, torch.bfloat16, 2e-2),
    (240, 2048, 512, torch.bfloat16, 2e-2),
    # the GEMV's instances for the decode buckets 2 and 4, and a ragged M
    (2, 512, 8192, torch.float32, 1e-4),
    (3, 2048, 512, torch.float32, 1e-4),
    (4, 512, 2048, torch.float32, 1e-4),
    # K that the GEMV splits so the CTA's x fits its shared memory: a
    # dim-4096 model's ffn2 at decode, a wide lm_head at M = 16
    (8, 16384, 4096, torch.float32, 1e-4),
    (16, 4096, 8192, torch.float32, 1e-4)])
def test_quantized_matmul_kernel_matches_plain(cuda, m, k, n, dtype, tol):
    """Both int8 bodies against the plain version.  float32 x: the GEMV
    sums in float32, the wgmma body takes x as three bfloat16 pieces
    (all 24 bits) whose exact products add up in float32, so either
    stays within 1e-4.  bfloat16 x: the output's rounding."""
    from mxnet_tpu_torch.kernels import quantize as qz
    rng = np.random.RandomState(m * n)
    q, scale = qz.quantize_array((rng.randn(n, k) * 0.02).astype(np.float32))
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda, dtype)
    wq, sc = torch.from_numpy(q).to(cuda), torch.from_numpy(scale).to(cuda)
    route = "gemv" if m <= qz.GEMV_MAX_M else "wgmma"
    before = qz.quantized_matmul.launches
    before_route = qz.quantized_matmul.launches_by_route[route]
    got = qz.quantized_matmul(x, wq, sc)
    want = qz.quantized_matmul_reference(x, wq, sc)
    torch.cuda.synchronize()
    assert qz.quantized_matmul.launches == before + 1
    assert qz.quantized_matmul.launches_by_route[route] == before_route + 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_quantized_matmul_is_the_same_run_to_run(cuda):
    """Split-K sums go through a fixed-order second pass, no float
    atomics: two calls give the same bits, on both bodies."""
    from mxnet_tpu_torch.kernels import quantize as qz
    rng = np.random.RandomState(5)
    q, scale = qz.quantize_array((rng.randn(512, 2048) * 0.02)
                                 .astype(np.float32))
    wq, sc = torch.from_numpy(q).to(cuda), torch.from_numpy(scale).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in (8, 240):
        assert qz.plan_quantized_matmul(m, 512, 2048, sms)["splits"] > 1
        x = torch.from_numpy(rng.randn(m, 2048).astype(np.float32)).to(cuda)
        assert torch.equal(qz.quantized_matmul(x, wq, sc),
                           qz.quantized_matmul(x, wq, sc))


DIMS = dict(vocab_size=64, num_layers=1, num_heads=2, dim=32,
            max_seq_len=64)


def _params():
    from mxnet_tpu_torch.models import transformer as tf
    sym = tf.get_decode_symbol(**DIMS)
    caches = {"layer0_att_k_cache": (4, 8, 2, 16),
              "layer0_att_v_cache": (4, 8, 2, 16)}
    shapes = sym.infer_shape(data=(1, 1), pos_ids=(1, 1), seq_pos=(1,),
                             block_table=(1, 2), **caches)[0]
    rng = np.random.RandomState(0)
    return {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in caches
            and n not in ("data", "pos_ids", "seq_pos", "block_table")}


def _engine(ctx, quantize=None, cache_dtype="float32"):
    import mxnet_tpu_torch as mx
    eng = mx.serving.GenerationEngine(
        _params(), ctx=ctx, quantize=quantize, max_new_tokens=4,
        prompt_buckets=(8,), decode_buckets=(1, 2), kv_blocks=8,
        kv_block_size=8, cache_dtype=cache_dtype, **DIMS)
    eng.collect_logits = True
    return eng


@pytest.mark.parametrize("quantize,cache_dtype", [
    (None, "float32"), ("int8", "float32"), (None, "bfloat16")])
def test_engine_gpu_matches_cpu(cuda, quantize, cache_dtype):
    """The engine on the GPU (the CUDA kernels) against the same engine
    on the CPU (their plain versions): same tokens, logits within 1e-4
    (float32 everywhere; only summation orders differ)."""
    import mxnet_tpu_torch as mx
    prompts = [[1, 2, 3], [4, 5]]
    gpu, cpu = _engine(cuda, quantize, cache_dtype), \
        _engine(mx.cpu(), quantize, cache_dtype)
    assert gpu.generate(prompts) == cpu.generate(prompts)
    for g_rows, c_rows in zip(gpu.last_logits, cpu.last_logits):
        for g, c in zip(g_rows, c_rows):
            np.testing.assert_allclose(g, c, atol=1e-4, rtol=0)


def test_engine_on_gpu_uses_both_kernels(cuda):
    """A tiny int8 engine on the GPU launches both kernels, and the int8
    matmul through both bodies: the 8-token prompt bucket is at most
    the GEMV's 16 rows, so here only the GEMV runs; prompts past 16
    tokens take the wgmma body (chip_smoke.py phase 4 runs both)."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    eng = _engine(cuda, "int8")
    fd.flash_decode_attention.launches = 0
    qz.quantized_matmul.launches = 0
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    out = eng.generate([[1, 2, 3], [4, 5]])
    assert [len(t) for t in out] == [4, 4]
    assert fd.flash_decode_attention.launches == 3       # 3 decode steps
    assert qz.quantized_matmul.launches == 2 * 3 + 3 * 3  # prefills + steps
    assert qz.quantized_matmul.launches_by_route == {"gemv": 15, "wgmma": 0}


def test_engine_on_gpu_runs_both_int8_bodies(cuda):
    """A 32-token prompt bucket (more than the GEMV's 16 rows) sends the
    prefill's int8 matmuls to the wgmma body and the decode steps' to the
    GEMV; tokens and logits as on the CPU (float32 sums on both bodies,
    within 1e-4)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import quantize as qz

    def engine(ctx):
        eng = mx.serving.GenerationEngine(
            _params(), ctx=ctx, quantize="int8", max_new_tokens=4,
            prompt_buckets=(32,), decode_buckets=(1,), kv_blocks=8,
            kv_block_size=8, **DIMS)
        eng.collect_logits = True
        return eng

    prompt = [list(range(1, 21))]
    gpu, cpu = engine(cuda), engine(mx.cpu())
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    assert gpu.generate(prompt) == cpu.generate(prompt)
    assert qz.quantized_matmul.launches_by_route == {"gemv": 3 * 3,
                                                     "wgmma": 3}
    for g, c in zip(gpu.last_logits[0], cpu.last_logits[0]):
        np.testing.assert_allclose(g, c, atol=1e-4, rtol=0)


# ----------------------------------------------------------------------
# the training slice: flash-attention forward and the fused sweep
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,rel,atol", [(torch.float32, 0.0, 2e-5),
                                            (torch.bfloat16, 2.0 ** -7, 1e-5)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,D", [(256, 64), (200, 64), (77, 32), (130, 128),
                                 (1000, 64), (1024, 32), (333, 128)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, rel, atol, causal,
                                              S, D):
    """o and lse of the CUDA kernels (float32: the FMA body; bfloat16:
    the wgmma body) against the plain version, ragged S included (200,
    77, 130, 1000, 333 are no multiple of the 64- or 128-row tiles).
    Each element of o is held to ``rel * |plain| + atol``.  float32:
    another summation order, 2e-5 absolute.  bfloat16: both compute in
    float32 and round o once, so a float32 difference can flip that
    rounding by one bfloat16 ulp (2**-7 |plain|, plus 1e-5 near zero),
    no more.  lse stays float32 and within 1e-4 either way."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(S + D)
    q, k, v = [torch.from_numpy(rng.randn(2, 3, S, D).astype(np.float32))
               .to(cuda, dtype) for _ in range(3)]
    body = str(dtype).replace("torch.", "")
    before = fa.flash_attention_forward.launches
    before_body = fa.flash_attention_forward.launches_by_dtype[body]
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.launches == before + 1
    assert fa.flash_attention_forward.launches_by_dtype[body] \
        == before_body + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 3, S)
    d = (o.float() - ro.float()).abs()
    assert bool((d <= ro.float().abs() * rel + atol).all()), float(d.max())
    assert float((lse - rl).abs().max()) <= 1e-4
    if dtype == torch.float32:
        # no atomics and a fixed order of every sum: bit for bit
        o2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype,rel,atol", [(torch.float32, 0.0, 2e-5),
                                            (torch.bfloat16, 2.0 ** -7, 1e-5)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,D", [(200, 77, 64), (77, 200, 64),
                                     (130, 1000, 128), (1000, 130, 32),
                                     (1, 300, 64), (300, 1, 64)])
def test_flash_attention_kernel_unequal_lengths(cuda, dtype, rel, atol,
                                                causal, Sq, Sk, D):
    """Sq != Sk: the tile-level mask tests (the ragged edge at Sk, the
    causal diagonal at row q0 of each q tile) and the float32 body's
    skip of a 128-row item's first 64 rows on its last causal tile hold
    where q and k tiles do not line up.  Tolerances as
    test_flash_attention_kernel_matches_plain; float32 repeats bit for
    bit."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(Sq + 3 * Sk + D)
    q = torch.from_numpy(rng.randn(2, 3, Sq, D).astype(np.float32))
    k, v = [torch.from_numpy(rng.randn(2, 3, Sk, D).astype(np.float32))
            for _ in range(2)]
    q, k, v = (x.to(cuda, dtype) for x in (q, k, v))
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tuple(o.shape) == (2, 3, Sq, D) and tuple(lse.shape) == (2, 3, Sq)
    d = (o.float() - ro.float()).abs()
    assert bool((d <= ro.float().abs() * rel + atol).all()), float(d.max())
    assert float((lse - rl).abs().max()) <= 1e-4
    if dtype == torch.float32:
        o2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_attention_kernel_rejects_bad_inputs(cuda):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.kernels import flash_attention as fa
    q = torch.randn(1, 2, 64, 48, device=cuda)
    with pytest.raises(MXNetError, match="head dims"):
        fa.flash_attention_forward(q, q, q)
    q = torch.randn(1, 2, 64, 64, device=cuda)
    with pytest.raises(MXNetError, match="contiguous"):
        fa.flash_attention_forward(q.transpose(2, 3), q, q)
    with pytest.raises(MXNetError):
        fa.flash_attention_forward(q.half(), q.half(), q.half())


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adam"])
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1001, 0), (4099, 1)])
def test_fused_sweep_kernel_matches_plain(cuda, name, n, offset):
    """The CUDA sweep against its plain version on the card: SGD bit
    for bit (every operation rounded as PyTorch rounds it), Adam within
    2 ulp (powf against PyTorch's pow in the bias corrections).  Sizes
    that are no multiple of 4 and a misaligned start (offset 1: the
    scalar path) included."""
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.kernels import fused_opt as fo
    kind = "adam" if name == "adam" else "sgd"
    kw = {"sgd": {}, "sgd_momentum": {"momentum": 0.9}, "adam": {}}[name]
    opt = opt_mod.create(kind, learning_rate=0.05, rescale_grad=0.5,
                         clip_gradient=1.5, **kw)
    rng = np.random.RandomState(n)

    def vec(scale=1.0, positive=False):
        a = rng.randn(n + offset).astype(np.float32) * scale
        a = np.abs(a) if positive else a
        return torch.from_numpy(a).to(cuda)[offset:]

    w, g = vec(), vec()
    states = {"sgd": [], "sgd_momentum": [vec(0.1)],
              "adam": [vec(0.1), vec(0.1, positive=True)]}[name]
    want_w, want_s = fo.sweep_reference(opt, w, g, states, 0.05, 0.01, 3)
    before = fo.sweep.launches
    fo.sweep(opt, w, g, states, 0.05, 0.01, 3)
    torch.cuda.synchronize()
    assert fo.sweep.launches == before + 1
    for got, want in zip([w] + states, [want_w] + want_s):
        if kind == "sgd":
            assert torch.equal(got, want)
        else:
            ulp = torch.abs(want) * 2.0 ** -23 + 1e-38
            assert float(((got - want).abs() / ulp).max()) <= 2.0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_trainer_gpu_matches_cpu_and_counts_launches(cuda, monkeypatch,
                                                     compute_dtype):
    """A 2-layer transformer trained 2 steps on the GPU (both kernels)
    against the same trainer on the CPU (their plain versions); the flash
    forward ran once per layer a step, on the body of the compute dtype
    (float32: FMA, bfloat16: wgmma), and the sweep once per bucket a step.

    float32: parameters within 1e-5 (summation orders only).  bfloat16:
    the two runs round their bfloat16 intermediates in different places
    (cuBLAS against the CPU's products, the wgmma kernel's o against the
    plain version's), so each parameter of the GPU run may be at most
    twice as far from the CPU run as the CPU's bfloat16 run is from its
    own float32 run (that distance is the size of bfloat16's rounding on
    this trajectory)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.models import transformer as tf
    monkeypatch.setenv("MXTPU_FUSED_OPT", "kernel")
    monkeypatch.setenv("MXTPU_FUSED_OPT_BUCKET_MB", "0.25")
    dims = dict(vocab_size=300, num_layers=2, num_heads=2, dim=64,
                seq_len=96)
    rng = np.random.RandomState(0)
    batch = {"data": rng.randint(0, 300, (2, 96)).astype(np.float32),
             "softmax_label": rng.randint(0, 300, (2, 96)).astype(np.float32)}
    bf16 = compute_dtype == "bfloat16"
    runs = [(cuda, compute_dtype), (mx.cpu(), compute_dtype)]
    if bf16:
        runs.append((mx.cpu(), "float32"))
    got = {}
    for dev, dt in runs:
        mx.random.seed(5)
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  rescale_grad=1.0 / 192)
        tr = mx.parallel.ShardedTrainer(
            tf.get_symbol(**dims), opt, ctx=dev,
            compute_dtype="bfloat16" if dt == "bfloat16" else None)
        p, s, a = tr.init_params({"data": (2, 96)},
                                 label_shapes={"softmax_label": (2, 96)})
        b = tr.shard_batch(batch)
        fa.flash_attention_forward.launches = 0
        fa.flash_attention_forward.launches_by_dtype.update(float32=0,
                                                            bfloat16=0)
        fo.sweep.launches = 0
        for _ in range(2):
            p, s, a, _o = tr.step(p, s, a, b)
        if dev is cuda:
            n_buckets = len(fo.plan_buckets(p))
            assert n_buckets > 1
            assert fa.flash_attention_forward.launches == 2 * 2
            assert fa.flash_attention_forward.launches_by_dtype == {
                "float32": 0 if bf16 else 4, "bfloat16": 4 if bf16 else 0}
            assert fo.sweep.launches == 2 * n_buckets
        got[(str(dev), dt)] = {n: w.cpu().float() for n, w in p.items()}
    gpu, cpu = got[(str(cuda), compute_dtype)], got[("cpu(0)", compute_dtype)]
    for n, w in cpu.items():
        err = float((gpu[n] - w).abs().max())
        if bf16:
            witness = float((w - got[("cpu(0)", "float32")][n]).abs().max())
            assert err <= 2.0 * witness, (n, err, witness)
        else:
            assert err <= 1e-5, n


# ---------------------------------------------------------------------------
# runtime-compiled kernels (rtc.Rtc over NVRTC) and the NDArray surface
# ---------------------------------------------------------------------------
def _ulps(got, want):
    """Largest |got - want| in units of the float32 spacing at want."""
    a = want.abs()
    spacing = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return float(((got - want).abs() / spacing).max())


def _rand(dev, shape, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    import mxnet_tpu_torch as mx
    return mx.nd.array(rng.rand(*shape).astype(np.float32), ctx=dev,
                       dtype=dtype)


@pytest.mark.parametrize("shape", [(8, 8), (4096, 4096), (3, 1001)])
@pytest.mark.parametrize("name", ["xy_plus_one", "saxpy"])
def test_rtc_elementwise_kernel_matches_plain(cuda, name, shape):
    """x*y + 1 and 2.5*x + y on [0, 1) inputs: NVRTC contracts the
    product and the sum into one FMA, the plain version rounds twice;
    with no cancellation the two stay within 1 ulp."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    x, y = _rand(cuda, shape, 0), _rand(cuda, shape, 1)
    before = rtc.launches
    (got,) = getattr(rk, name)(x, y)
    want = getattr(rk, name + "_reference")(x.data, y.data)
    torch.cuda.synchronize()
    assert rtc.launches == before + 1
    assert got.shape == shape and got.dtype == torch.float32
    assert got.context == x.context
    assert _ulps(got.data, want) <= 1.0


@pytest.mark.parametrize("n,offset", [((1 << 24) + 3, 0), (1 << 20, 1),
                                      (1001, 1), (7, 0)])
def test_rtc_saxpy_ragged_and_offset(cuda, n, offset):
    """The vector body's scalar tail (n % 4 != 0) and its scalar path (a
    view that starts one element into its array, not 16-byte aligned):
    within 1 ulp of the plain version."""
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    x = _rand(cuda, (n + offset,), 9)[offset:offset + n]
    y = _rand(cuda, (n + offset,), 10)[offset:offset + n]
    assert (x.data.data_ptr() % 16 == 0) == (offset == 0)
    (got,) = rk.saxpy(x, y)
    want = rk.saxpy_reference(x.data, y.data)
    torch.cuda.synchronize()
    assert got.shape == (n,)
    assert _ulps(got.data, want) <= 1.0


def test_rtc_shared_memory_kernel_matches_plain(cuda):
    """The reference MXNet's NVRTC test: grid (1,1,1), block (10,1,1),
    a static __shared__ array; expf within 2 ulp of torch.exp."""
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    x = _rand(cuda, (10,), 2) * 2 - 1
    (got,) = rk.exp_shared(x)
    want = rk.exp_shared_reference(x.data)
    torch.cuda.synchronize()
    assert _ulps(got.data, want) <= 2.0


def test_rtc_bfloat16_inputs_two_outputs_bitwise(cuda):
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    x = _rand(cuda, (37, 129), 3, torch.bfloat16) * 4 - 2
    y = _rand(cuda, (37, 129), 4, torch.bfloat16) * 4 - 2
    got = rk.add_mul_bf16(x, y)
    want = rk.add_mul_bf16_reference(x.data, y.data)
    torch.cuda.synchronize()
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g.data, w)


@pytest.mark.parametrize("shape", [(4096, 4096), (100, 70)])
def test_rtc_transpose_2d_grid_bitwise(cuda, shape):
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    x = _rand(cuda, shape, 5)
    (got,) = rk.transpose(x)
    torch.cuda.synchronize()
    assert got.shape == shape[::-1]
    assert torch.equal(got.data, rk.transpose_reference(x.data))


#: 2.5 x from one input, one element a thread
ONE_INPUT_BODY = r"""
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < out0_size) out0[i] = 2.5f * in0[i] + 0.0f;
"""


def test_rtc_errors_on_the_card(cuda):
    """A compile error carries NVRTC's log; a block over the kernel's
    thread limit and a grid dimension of 0 raise before launching."""
    import mxnet_tpu_torch as mx
    x = _rand(cuda, (64,), 6)
    bad = mx.rtc.Rtc("out0[threadIdx.x] = in0[threadIdx.x] +;", pallas=True)
    with pytest.raises(mx.MXNetError, match="NVRTC could not compile"
                       "(.|\n)*error"):
        bad.push([x], (1, 1, 1), (64, 1, 1))
    ok = mx.rtc.Rtc(ONE_INPUT_BODY, pallas=True)
    with pytest.raises(mx.MXNetError, match="more than the kernel's limit"):
        ok.push([x], (1, 1, 1), (2048, 1, 1))
    with pytest.raises(mx.MXNetError, match="at least 1"):
        ok.push([x], (0, 1, 1), (64, 1, 1))
    assert ok.launches == 0
    (out,) = ok.push([x], (1, 1, 1), (64, 1, 1))
    torch.cuda.synchronize()
    assert ok.launches == 1
    assert torch.equal(out.data, 2.5 * x.data)


def test_rtc_compiles_once_per_key_and_runs_from_a_new_thread(cuda):
    """One NVRTC compile per (shapes, dtypes); a push from a thread that
    has never touched CUDA finds no current context and sets the
    primary one."""
    import threading
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    rtc = mx.rtc.Rtc(rk.XY_PLUS_ONE, pallas=True)
    x, y = _rand(cuda, (300,), 7), _rand(cuda, (300,), 8)
    for _ in range(3):
        rtc.push([x, y], (2, 1, 1), (256, 1, 1))
    rtc.push([x[:100], y[:100]], (1, 1, 1), (128, 1, 1))
    assert len(rtc._compiled) == 2 and rtc.launches == 4
    box = {}

    def worker():
        try:
            box["out"] = rtc.push([x, y], (2, 1, 1), (256, 1, 1))[0]
        except Exception as err:    # reported in the main thread
            box["err"] = err

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "err" not in box, box.get("err")
    torch.cuda.synchronize()
    assert _ulps(box["out"].data, x.data * y.data + 1.0) <= 1.0


def test_imperative_surface_defaults_to_the_gpu(cuda):
    """No ctx and no scope: arrays and samples land on gpu(0); views
    write through; waitall synchronises."""
    import mxnet_tpu_torch as mx
    a = mx.nd.zeros((4, 3))
    assert a.context == mx.gpu(0) and a.data.is_cuda
    a[1:3][:] = 5
    a.reshape((3, 4))[0][:] = 1
    u = mx.random.uniform(0, 1, shape=(1000,))
    assert u.data.is_cuda
    mx.nd.waitall()
    want = np.zeros((4, 3), np.float32)
    want[1:3] = 5
    want.reshape(3, 4)[0] = 1
    np.testing.assert_array_equal(a.asnumpy(), want)
    with mx.cpu():
        assert mx.nd.ones((2,)).context == mx.cpu()
