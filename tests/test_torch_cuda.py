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


@pytest.mark.parametrize("m,k,n,dtype,tol", [
    (1, 512, 2048, torch.float32, 1e-4),
    (8, 512, 8192, torch.float32, 1e-4),      # decode lm_head (GEMV)
    (17, 512, 8192, torch.float32, 1e-4),     # past the threshold (wgmma)
    (67, 100, 130, torch.float32, 1e-4),      # ragged; K padded
    (240, 2048, 512, torch.float32, 1e-4),
    (960, 512, 8192, torch.float32, 1e-4),    # prefill lm_head
    (8, 16384, 4096, torch.float32, 1e-4),    # GEMV split for its x
    (8, 512, 8192, torch.bfloat16, 2e-2),
    (240, 512, 2048, torch.bfloat16, 2e-2)])
def test_quantized_matmul_fp8_kernel_matches_plain(cuda, m, k, n, dtype,
                                                   tol):
    """Both bodies with fp8 e4m3 weights against the plain version, and
    the same bits on a second call; counted as fp8 and by body."""
    from mxnet_tpu_torch.kernels import quantize as qz
    rng = np.random.RandomState(m + n)
    q, scale = qz.quantize_array((rng.randn(n, k) * 0.02).astype(np.float32),
                                 qdtype="fp8_e4m3")
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda, dtype)
    wq, sc = q.to(cuda), torch.from_numpy(scale).to(cuda)
    route = "gemv" if m <= qz.GEMV_MAX_M else "wgmma"
    before = dict(qz.quantized_matmul.launches_by_qdtype)
    before_route = qz.quantized_matmul.launches_by_route[route]
    got = qz.quantized_matmul(x, wq, sc)
    want = qz.quantized_matmul_reference(x, wq, sc)
    torch.cuda.synchronize()
    assert qz.quantized_matmul.launches_by_qdtype == dict(
        before, fp8_e4m3=before["fp8_e4m3"] + 1)
    assert qz.quantized_matmul.launches_by_route[route] == before_route + 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(qz.quantized_matmul(x, wq, sc), got)


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


@pytest.mark.parametrize("quantize", [None, "fp8_e4m3"])
def test_model_server_generates_on_gpu(cuda, quantize):
    """A ModelServer on the card: its batcher threads launch the kernels
    (flash-decode, and both fp8 bodies: a 32-token prompt bucket for the
    wgmma body, decode for the GEMV) and give the tokens the same engine
    gives on the CPU; an MLP served beside it matches its Predictor."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    kw = dict(quantize=quantize, max_new_tokens=4, prompt_buckets=(8, 32),
              decode_buckets=(1, 2, 4), kv_blocks=16, kv_block_size=8,
              **DIMS)
    prompts = [[1, 2, 3], list(range(1, 21)), [4, 5], [7] * 9]
    want = mx.serving.GenerationEngine(_params(), ctx=mx.cpu(),
                                       **kw).generate(prompts)
    net = mx.models.get_mlp(num_classes=3, hidden=(8,))
    shapes = net.infer_shape(data=(1, 10))[0]
    rng = np.random.RandomState(1)
    mlp = {n: rng.randn(*sh).astype(np.float32)
           for n, sh in zip(net.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    from mxnet_tpu_torch.executor import program_registry_stats
    with mx.serving.ModelServer(max_delay_ms=2) as srv:
        srv.add_generative_model("lm", _params(), ctx=cuda, **kw)
        srv.add_model("mlp", net.tojson(), mlp, {"data": (10,)},
                      buckets=(1, 4), ctx=cuda)
        lowerings = program_registry_stats()["lowerings"]
        fd.flash_decode_attention.launches = 0
        qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
        qz.quantized_matmul.launches_by_qdtype.update(int8=0, fp8_e4m3=0)
        handles = [srv.generate("lm", p) for p in prompts]
        xs = [rng.rand(n, 10).astype(np.float32) for n in (1, 3, 4)]
        futs = [srv.submit("mlp", x) for x in xs]
        got = [f.result(timeout=120)["tokens"] for f, _s in handles]
        outs = [f.result(timeout=60)[0] for f in futs]
        # each model's count starts at its own add_*: the last added's
        # reads 0, and the registry has built nothing since
        assert srv.stats()["models"]["mlp"]["lowerings_since_warmup"] == 0
        assert program_registry_stats()["lowerings"] == lowerings
    assert got == want
    assert fd.flash_decode_attention.launches >= 3
    if quantize:
        assert qz.quantized_matmul.launches_by_qdtype["int8"] == 0
        assert min(qz.quantized_matmul.launches_by_route.values()) > 0
    for x, out in zip(xs, outs):
        ref = mx.Predictor(net.tojson(), mlp, {"data": x.shape},
                           ctx=cuda).forward(data=x)[0]
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


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


#: every body of the sweep: (optimizer, its arguments, its body code)
SWEEP_BODIES = [
    ("sgd", {}, 0), ("sgd", {"momentum": 0.9}, 1), ("adam", {}, 2),
    ("nag", {"momentum": 0.9}, 3), ("nag", {}, 0),
    ("ccsgd", {"momentum": 0.9}, 1), ("adamw", {}, 4),
    ("adagrad", {}, 5), ("rmsprop", {}, 6), ("adadelta", {}, 7),
    ("test", {}, 8)]


def _sweep_case(cuda, kind, kw, n, offset, clip, seed):
    from mxnet_tpu_torch import optimizer as opt_mod
    opt = opt_mod.create(kind, learning_rate=0.05, rescale_grad=0.5,
                         clip_gradient=clip, **kw)
    rng = np.random.RandomState(seed)

    def vec(scale=1.0, positive=False):
        a = rng.randn(n + offset).astype(np.float32) * scale
        a = np.abs(a) if positive else a
        return torch.from_numpy(a).to(cuda)[offset:]

    w, g = vec(), vec()
    proto = opt.create_state_arrays((1,))
    n_state = 0 if proto is None else (
        len(proto) if isinstance(proto, tuple) else 1)
    # states of the sizes each formula keeps (variances positive)
    states = [vec(0.1, positive=(i > 0 or kind in ("adagrad",
                                                   "adadelta")))
              for i in range(n_state)]
    if kind == "rmsprop":      # n >= g^2, as the running means keep it
        states[0] = states[1] * states[1] + states[0].abs()
    return opt, w, g, states


@pytest.mark.parametrize("kind,kw,body", SWEEP_BODIES)
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1001, 0), (4099, 1)])
@pytest.mark.parametrize("clip,t", [(1.5, 3), (None, 1)])
def test_fused_sweep_kernel_matches_plain(cuda, kind, kw, body, n, offset,
                                          clip, t):
    """Every body of the CUDA sweep against its plain version on the
    card, bit for bit (each operation rounded as PyTorch rounds it, powf
    as PyTorch's pow), with and without clip_gradient, at t = 1 and 3;
    sizes that are no multiple of 4 and a misaligned start (offset 1:
    the scalar path) included."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    opt, w, g, states = _sweep_case(cuda, kind, kw, n, offset, clip, n)
    assert fo.sweep_body(opt) == body
    want_w, want_s = fo.sweep_reference(opt, w, g, states, 0.05, 0.01, t)
    before = fo.sweep.launches
    fo.sweep(opt, w, g, states, 0.05, 0.01, t)
    torch.cuda.synchronize()
    assert fo.sweep.launches == before + 1
    for got, want in zip([w] + states, [want_w] + want_s):
        assert bool(torch.isfinite(want).all())
        assert torch.equal(got, want), (kind, kw)


@pytest.mark.parametrize("kind,kw,body", [SWEEP_BODIES[1], SWEEP_BODIES[2]])
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (4099, 1)])
@pytest.mark.parametrize("flag", [None, 1, 0])
def test_gated_sweep_writes_nothing_on_zero(cuda, kind, kw, body, n, offset,
                                            flag):
    """The sweep's skip flag: null is the ungated sweep, 1 the same bits,
    0 leaves the weight and every state bit for bit as they were; one
    launch each time, counted as gated when a flag is given."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    opt, w, g, states = _sweep_case(cuda, kind, kw, n, offset, 1.5, n)
    old = [w.clone()] + [s.clone() for s in states]
    want_w, want_s = fo.sweep_reference(opt, w, g, states, 0.05, 0.01, 3)
    ok = None if flag is None else torch.full((), flag, dtype=torch.int32,
                                              device=cuda)
    before, gated = fo.sweep.launches, fo.sweep.launches_gated
    fo.sweep(opt, w, g, states, 0.05, 0.01, 3, ok=ok)
    torch.cuda.synchronize()
    assert fo.sweep.launches == before + 1
    assert fo.sweep.launches_gated == gated + (flag is not None)
    want = old if flag == 0 else [want_w] + want_s
    for got, ref in zip([w] + states, want):
        assert torch.equal(got, ref), (kind, flag)


def _user_optimizers():
    """Optimizers whose update_fn is their own: the generated body."""
    from mxnet_tpu_torch import optimizer as opt_mod

    class SignClip(opt_mod.Optimizer):
        elementwise = True

        def __init__(self, momentum=0.9, bound=0.05, **kwargs):
            super().__init__(**kwargs)
            self.momentum = momentum
            self.bound = bound

        def create_state_arrays(self, shape, dtype=torch.float32,
                                device=None):
            return torch.zeros(tuple(shape), dtype=dtype, device=device)

        def update_fn(self, weight, grad, state, lr, wd, t):
            m = self.momentum * state + (1.0 - self.momentum) * grad
            step = torch.clamp(torch.sign(m) * torch.sqrt(torch.abs(m)),
                               -self.bound, self.bound)
            return weight - lr * (step + wd * weight), m

    class Forms(SignClip):
        def update_fn(self, weight, grad, state, lr, wd, t):
            tf = torch.as_tensor(t, dtype=torch.float32, device=weight.device)
            m = state / 3.0 + grad ** 2 - 0.5 ** tf
            r = torch.where(m > 0, torch.rsqrt(m + 1.0), 2.0 / (1.0 - m))
            return weight - lr * torch.maximum(r, torch.exp(-weight)) \
                * torch.log(1.0 + torch.abs(grad)), m

    class MyAdam(opt_mod.Adam):
        def update_fn(self, weight, grad, state, lr, wd, t):
            return super().update_fn(weight, grad, state, lr, wd, t)
    return [("sign_clip", SignClip(learning_rate=0.05, rescale_grad=0.5,
                                   clip_gradient=0.8, wd=0.01)),
            ("forms", Forms(learning_rate=0.05, wd=0.01)),
            ("my_adam", MyAdam(learning_rate=0.01, rescale_grad=0.5))]


@pytest.mark.parametrize("name", ["sign_clip", "forms", "my_adam"])
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (4099, 1)])
def test_generated_sweep_body_bitwise_plain(cuda, name, n, offset):
    """The body generated from a user's update_fn (NVRTC, --fmad=false)
    against sweep_reference on the card, bit for bit, on both routes; the
    skip flag at 0 writes nothing."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    opt = dict(_user_optimizers())[name]
    assert fo.sweep_body(opt) == fo.GENERATED
    rng = np.random.RandomState(n)

    def vec(scale=1.0, positive=False):
        a = rng.randn(n + offset).astype(np.float32) * scale
        return torch.from_numpy(np.abs(a) if positive else a) \
            .to(cuda)[offset:]
    k = len(fo._state_leaves(opt.create_state_arrays((1,))))
    w, g = vec(), vec()
    states = [vec(0.1, positive=i > 0) for i in range(k)]
    old = [w.clone()] + [s.clone() for s in states]
    want_w, want_s = fo.sweep_reference(opt, w, g, states, 0.05, 0.01, 3)
    before = fo.sweep.launches_by_body.get(fo.GENERATED, 0)
    fo.sweep(opt, w, g, states, 0.05, 0.01, 3)
    torch.cuda.synchronize()
    assert fo.sweep.launches_by_body[fo.GENERATED] == before + 1
    for got, want in zip([w] + states, [want_w] + want_s):
        assert bool(torch.isfinite(want).all())
        assert torch.equal(got, want), (name, n, offset)
    ws = [x.clone() for x in old]
    fo.sweep(opt, ws[0], g, ws[1:], 0.05, 0.01, 3,
             ok=torch.zeros((), dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    for got, ref in zip(ws, old):
        assert torch.equal(got, ref)


def test_trainer_sentinel_on_the_card_skips_without_a_sync(cuda,
                                                           monkeypatch):
    """ShardedTrainer(sentinel=True) on the card with the kernel sweep:
    a NaN batch at step 2 leaves parameters and momentum bit for bit; the
    gated sweep launched; the counters stay on the card; and steps make
    no more synchronising calls than the sentinel-off trainer's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.resilience import faultinject
    monkeypatch.setenv("MXTPU_FUSED_OPT", "kernel")
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    batch = {"data": x, "softmax_label": (x.sum(1) > 0).astype(np.float32)}

    def trainer(sentinel):
        data = mx.sym.Variable("data")
        h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = mx.sym.FullyConnected(mx.sym.Activation(h, act_type="relu"),
                                  num_hidden=4, name="fc2")
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        tr = mx.parallel.ShardedTrainer(
            mx.sym.SoftmaxOutput(h, name="softmax"), opt, ctx=cuda,
            sentinel=sentinel)
        mx.random.seed(1)
        p, o, a = tr.init_params({"data": (16, 8)},
                                 label_shapes={"softmax_label": (16,)})
        return tr, p, o, a, tr.shard_batch(batch)
    counts = []
    for sentinel in (False, True):
        tr, p, o, a, b = trainer(sentinel)
        p, o, a, _ = tr.step(p, o, a, b)
        torch.cuda.synchronize()
        import warnings
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(2):
                    p, o, a, _ = tr.step(p, o, a, b)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts.append(len([w for w in caught
                           if "called a synchronizing" in str(w.message)]))
    assert counts[1] == counts[0], counts
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "step=5:kind=nan")
    faultinject.reset()
    try:
        p, o, a, _ = tr.step(p, o, a, b)      # step 4
        before = [v.clone() for v in list(p.values()) + list(o.values())]
        gated = fo.sweep.launches_gated
        p, o, a, _ = tr.step(p, o, a, b)      # step 5: NaN
        torch.cuda.synchronize()
    finally:
        faultinject.reset()
    assert fo.sweep.launches_gated > gated
    for x, y in zip(before, list(p.values()) + list(o.values())):
        assert torch.equal(x, y)
    stats = tr.sentinel_stats()
    assert stats["skipped"] == 1 and stats["last_good"] == 4
    assert all(v.device == cuda for v in tr._sentinel_state.values())


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


# ---------------------------------------------------------------------------
# image classification: ResNet through ShardedTrainer
# ---------------------------------------------------------------------------
def test_resnet18_trainer_step_on_the_sweep(cuda, monkeypatch):
    """One ResNet-18 step (cifar stem, batch 8) through ShardedTrainer
    with MXTPU_FUSED_OPT=kernel: the sweep once a bucket and no other
    kernel of the port, and parameters and aux bit for bit those of the
    same step with the leafwise update (cuDNN deterministic)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.model import params_from_numpy
    monkeypatch.setenv("MXTPU_FUSED_OPT_BUCKET_MB", "16")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    sym = mx.models.resnet.get_symbol(10, 18, (3, 32, 32))
    rng = np.random.RandomState(0)
    shapes, _, aux_shapes = sym.infer_shape(data=(8, 3, 32, 32))
    params = {n: (rng.randn(*s) * 0.05).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batch = {"data": rng.randn(8, 3, 32, 32).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 8).astype(np.float32)}
    got = {}
    for mode in ("kernel", ""):
        monkeypatch.setenv("MXTPU_FUSED_OPT", mode)
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  wd=1e-4, rescale_grad=1.0 / 8)
        tr = mx.parallel.ShardedTrainer(sym, opt, ctx=cuda)
        p, a = params_from_numpy(params, aux, ctx=cuda)
        st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
              for n, w in p.items()}
        fo.sweep.launches = 0
        fa.flash_attention_forward.launches = 0
        p, st, a, _o = tr.step(p, st, a, tr.shard_batch(batch))
        torch.cuda.synchronize()
        want = len(fo.plan_buckets(p)) if mode else 0
        assert fo.sweep.launches == want and (want > 1 or not mode)
        assert fa.flash_attention_forward.launches == 0
        got[mode] = dict(p, **a)
    for n, w in got[""].items():
        assert torch.equal(got["kernel"][n], w), n


def test_device_prefetcher_copies_from_pinned_buffers_on_its_stream(cuda):
    """The async feed on the card: each batch staged in a pinned buffer
    and copied on the prefetcher's own stream; the consumer's work on
    its stream (waiting on the copy's event) reads every batch exactly,
    also when a long kernel on the consumer's stream runs while later
    batches are copied and their buffers reused."""
    from mxnet_tpu_torch.parallel import overlap
    rng = np.random.RandomState(0)
    host = [rng.randint(0, 256, (16, 3, 64, 64)).astype(np.uint8)
            for _ in range(12)]
    copy = overlap.HostToDevice(cuda, slots=2)
    assert copy.stream is not None and copy.stream != \
        torch.cuda.current_stream(cuda)
    feed = overlap.DevicePrefetcher(
        iter(host), place_fn=lambda b: copy(b), depth=3, stream=copy.stream)
    sums = []
    for i, dev in enumerate(feed):
        assert dev.device == cuda and dev.dtype == torch.uint8
        torch.cuda._sleep(2000000)        # keep the consumer's stream busy
        sums.append(dev.to(torch.float32).sum(dim=(1, 2, 3)))
    torch.cuda.synchronize()
    assert len(sums) == len(host)
    for got, want in zip(sums, host):
        np.testing.assert_array_equal(
            got.cpu().numpy(), want.astype(np.float32).sum(axis=(1, 2, 3)))
    ring = next(iter(copy._pool.values()))[1]
    assert len(ring) == 2 and all(buf.is_pinned() for buf, _ in ring)
    feed.close()


def test_prefetch_feed_on_the_card_equals_serial(cuda, monkeypatch):
    """ResNet-18 (cifar stem) over ``prefetch_feed`` of uint8 batches:
    three steps bitwise the same as with ``shard_batch`` on the loop
    (cuDNN deterministic); the batch arrives as uint8 on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.model import params_from_numpy
    monkeypatch.setenv("MXTPU_FUSED_OPT", "kernel")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    sym = mx.models.resnet.get_symbol(10, 18, (3, 32, 32))
    rng = np.random.RandomState(1)
    shapes, _, aux_shapes = sym.infer_shape(data=(8, 3, 32, 32))
    params = {n: (rng.randn(*s) * 0.05).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batches = [{"data": rng.randint(0, 256, (8, 3, 32, 32)).astype(np.uint8),
                "softmax_label": rng.randint(0, 10, 8).astype(np.float32)}
               for _ in range(3)]
    got = {}
    for prefetch in (True, False):
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  wd=1e-4, rescale_grad=1.0 / 8)
        tr = mx.parallel.ShardedTrainer(sym, opt, ctx=cuda)
        p, a = params_from_numpy(params, aux, ctx=cuda)
        st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
              for n, w in p.items()}
        feed = tr.prefetch_feed(iter(batches), prefetch=prefetch)
        if not prefetch:
            feed = (tr.shard_batch(b) for b in feed)
        for b in feed:
            assert b["data"].dtype == torch.uint8 and b["data"].device == cuda
            p, st, a, _o = tr.step(p, st, a, b)
        torch.cuda.synchronize()
        got[prefetch] = dict(p, **a)
    for n, w in got[False].items():
        assert torch.equal(got[True][n], w), n


# ----------------------------------------------------------------------
# the fused RNN op (cuDNN on the card) and bucketing
# ----------------------------------------------------------------------
def _rnn_case(mode, layers, bidir, seq, batch, in_size, hidden, seed=0):
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    g = torch.Generator().manual_seed(seed)
    ndir = 2 if bidir else 1
    n = rnn_param_size(layers, in_size, hidden, bidir, mode)
    host = [torch.randn(seq, batch, in_size, generator=g),
            torch.randn(n, generator=g) * 0.1,
            torch.randn(ndir * layers, batch, hidden, generator=g)]
    if mode == "lstm":
        host.append(torch.randn(ndir * layers, batch, hidden, generator=g))
    return host


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("seq,batch,in_size,hidden", [(5, 32, 16, 48),
                                                      (40, 32, 200, 200)])
def test_rnn_op_cudnn_matches_plain(cuda, mode, layers, bidir, seq, batch,
                                    in_size, hidden):
    """The RNN op on CUDA tensors (cuDNN for lstm and gru, the plain loop
    for the vanilla modes): its float32 outputs, final states and the
    gradients of data, flat parameters and initial states are within
    1e-5 (of the larger of 1 and the max-abs) of the plain loop run in
    float64 on the same card, TF32 off; for lstm and gru they are
    cuDNN's."""
    from mxnet_tpu_torch.ops.registry import create_operator
    from mxnet_tpu_torch.ops.rnn import CUDNN_MODES, rnn_cudnn, rnn_reference
    host = _rnn_case(mode, layers, bidir, seq, batch, in_size, hidden)
    l32 = [t.to(cuda).requires_grad_() for t in host]
    l64 = [t.to(cuda, torch.float64).requires_grad_() for t in host]
    op = create_operator("RNN", state_size=hidden, num_layers=layers,
                         mode=mode, bidirectional=bidir, state_outputs=True)
    got, _ = op.forward(l32, [], True, None)
    if mode in CUDNN_MODES:
        direct = [t for t in rnn_cudnn(
            mode, l32[0], l32[1], l32[2], l32[3] if mode == "lstm" else None,
            layers, bidir) if t is not None]
        assert all(torch.equal(a, b) for a, b in zip(got, direct))
    want = [t for t in rnn_reference(
        mode, l64[0], l64[1], l64[2], l64[3] if mode == "lstm" else None,
        layers, bidir) if t is not None]
    g = torch.Generator().manual_seed(1)
    cots = [torch.randn(o.shape, generator=g, dtype=torch.float64).to(cuda)
            for o in want]
    gg = torch.autograd.grad(got, l32, [c.float() for c in cots])
    gw = torch.autograd.grad(want, l64, cots)
    for a, b in list(zip(got, want)) + list(zip(gg, gw)):
        a, b = a.detach().double(), b.detach()
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= 1e-5 * scale


def test_bucketing_lstm_on_the_card(cuda):
    """A small unrolled LSTM through BucketingModule on gpu(0): every
    bucket's executor holds the default bucket's parameter tensors on
    the card, and the trained parameters are finite."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.lstm import init_state_shapes, lstm_unroll
    states = init_state_shapes(2, 4, 16)

    def sym_gen(seq_len):
        return (lstm_unroll(2, seq_len, 30, num_hidden=16, num_embed=8,
                            num_label=30),
                ["data"] + [n for n, _ in states], ["softmax_label"])

    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=mx.gpu(0))
    mod.bind([("data", (4, 8))] + states, [("softmax_label", (4, 8))])
    mod.init_params(initializer=mx.init.Xavier(factor_type="in",
                                               magnitude=2.34))
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    for key in (8, 4, 6, 8, 4):
        tok = rng.randint(1, 30, (4, key)).astype(np.float32)
        batch = mx.io.DataBatch(
            [mx.nd.array(tok, ctx=mx.cpu())]
            + [mx.nd.zeros(s, ctx=mx.cpu()) for _, s in states],
            [mx.nd.array(np.roll(tok, -1, 1), ctx=mx.cpu())],
            bucket_key=key,
            provide_data=[("data", (4, key))] + states,
            provide_label=[("softmax_label", (4, key))])
        mod.forward_backward(batch)
        mod.update()
    base = mod._buckets[8]._exec_group.execs[0]
    for key in (4, 6):
        ex = mod._buckets[key]._exec_group.execs[0]
        assert ex.arg_dict["cls_weight"].data.data_ptr() == \
            base.arg_dict["cls_weight"].data.data_ptr()
        assert ex.arg_dict["data"].data.device.type == "cuda"
    arg, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in arg.values())


@pytest.mark.parametrize("pooled,scale", [((7, 7), 1.0 / 16), ((3, 2), 0.5)])
def test_roipooling_card_matches_cpu(cuda, pooled, scale):
    """ROIPooling on the card: forward bit for bit the CPU's, the gradient
    within 1e-6 of its max-abs (the shares are summed in float64 on
    both); a bin of four tied zeros gives each a quarter."""
    from mxnet_tpu_torch.ops.vision import _ROIPoolingFn
    rng = np.random.RandomState(3)
    data = np.maximum(rng.randn(2, 16, 20, 24) - 0.5, 0).astype(np.float32)
    data[0, :, 4:18, 4:18] = 0.0
    span = 1.0 / scale
    x1 = rng.uniform(0, 20, 40) * span
    y1 = rng.uniform(0, 16, 40) * span
    rois = np.stack([rng.randint(0, 2, 40), x1, y1,
                     x1 + rng.uniform(0, 12, 40) * span,
                     y1 + rng.uniform(0, 12, 40) * span], 1)
    rois[-1] = [0, 4 * span, 4 * span, 17 * span, 17 * span]
    rois = rois.astype(np.float32)
    cot = rng.randn(40, 16, *pooled).astype(np.float32)

    def run(dev, r, c):
        d = torch.from_numpy(data).to(dev).requires_grad_()
        out = _ROIPoolingFn.apply(d, torch.from_numpy(r).to(dev),
                                  pooled[0], pooled[1], scale)
        g, = torch.autograd.grad(out, d, torch.from_numpy(c).to(dev))
        return out.detach().cpu(), g.cpu()
    out_d, g_d = run(cuda, rois, cot)
    out_c, g_c = run("cpu", rois, cot)
    assert torch.equal(out_d, out_c)
    scale_g = g_c.abs().max().item()
    assert (g_d - g_c).abs().max().item() <= 1e-6 * scale_g
    if pooled == (7, 7):
        _o, g = run(cuda, rois[-1:], cot[-1:])
        want = (torch.from_numpy(cot[-1]) / 4.0).repeat_interleave(
            2, 1).repeat_interleave(2, 2)
        assert torch.equal(g[0, :, 4:18, 4:18], want)


def test_custom_op_on_the_card(cuda):
    """A Custom op bound on gpu(0): its outputs and gradients on the card,
    equal to the same graph on the CPU; the host bridge counts a forward
    and a backward and copies each way."""
    import mxnet_tpu_torch as mx

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1.0 / (1.0 + np.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @mx.operator.register("cuda_test_sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            assert ctx.device_type in ("gpu", "cpu")
            return Sigmoid()

    x = mx.sym.Variable("x")
    s = mx.sym.FullyConnected(
        mx.sym.Custom(data=x * 2.0, op_type="cuda_test_sigmoid"),
        num_hidden=3, name="fc")
    rng = np.random.RandomState(0)
    vals = {"x": rng.randn(4, 5).astype(np.float32),
            "fc_weight": rng.randn(3, 5).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}
    og = rng.randn(4, 3).astype(np.float32)
    got = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ex = s.simple_bind(ctx, grad_req="write", x=(4, 5))
        for k, v in vals.items():
            ex.arg_dict[k][:] = v
        mx.operator.host_stats(reset=True)
        out = ex.forward(is_train=True)[0]
        ex.backward([mx.nd.array(og, ctx=ctx)])
        stats = mx.operator.host_stats()
        assert stats["forward_calls"] == 1 and stats["backward_calls"] == 1
        assert stats["to_host_bytes"] > 0 and stats["to_device_bytes"] > 0
        assert out.data.device.type == ("cuda" if ctx.device_type == "gpu"
                                        else "cpu")
        got[ctx.device_type] = (out.asnumpy(),
                                ex.grad_dict["x"].asnumpy())
    for a, b in zip(got["gpu"], got["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_rcnn_example_steps_on_the_card(cuda):
    """``example/rcnn-torch`` at its defaults on gpu(0), two steps: every
    output on the card and finite, the rois real boxes."""
    import importlib.util
    import os
    import sys
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "example", "rcnn-torch")
    sys.path.insert(0, here)
    try:
        spec = importlib.util.spec_from_file_location(
            "cuda_rcnn_train", os.path.join(here, "train_end2end.py"))
        te = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(te)
    finally:
        sys.path.remove(here)
    import mxnet_tpu_torch as mx
    exe, shapes = te.bind(mx.gpu(0))
    te.init_params(exe, shapes)
    te.fill_inputs(exe, 128, 4, 16)
    for _ in range(2):
        outs = exe.forward(is_train=True)
        exe.backward()
        te.sgd_step(exe, 1e-4)
    for o in outs:
        assert o.data.device.type == "cuda"
        assert torch.isfinite(o.data).all()
    rois = outs[3].asnumpy()
    assert (rois[:, 3] - rois[:, 1]).max() > 0


# ----------------------------------------------------------------------
# data parallelism: the cross-replica BatchNorm, ZeRO-1's slices, dp
# ----------------------------------------------------------------------
@pytest.mark.parametrize("replicas", [2, 3])
def test_cross_replica_batchnorm_matches_one_batch(cuda, replicas):
    """The lockstep walk's BatchNorm over replicas on the card against
    its plain version (``F.batch_norm`` over the whole batch, and the
    moving statistics from its mean and biased variance): outputs,
    statistics and the gradients of data, gamma (summed over the
    replicas) and beta within 2e-5 (float32 sums in other orders)."""
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.parallel.collectives import ReplicaGroup
    op = registry.create_operator("BatchNorm", fix_gamma=False,
                                  momentum=0.9, eps=2e-5)
    rng = np.random.RandomState(replicas)
    x = torch.from_numpy(rng.randn(6 * replicas, 5, 4, 3)
                         .astype(np.float32) * 2 + 1).to(cuda)
    gamma = torch.from_numpy(1 + 0.1 * rng.randn(5).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.randn(5).astype(np.float32))
    dy = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(cuda)
    mm, mv = torch.zeros(5, device=cuda), torch.ones(5, device=cuda)
    group = ReplicaGroup([cuda] * replicas)
    xs = [t.clone().requires_grad_() for t in torch.chunk(x, replicas)]
    gs = [gamma.to(cuda).clone().requires_grad_() for _ in range(replicas)]
    bs = [beta.to(cuda).clone().requires_grad_() for _ in range(replicas)]
    outs, aux, rep = op.forward_replicas(
        [[a, g, b] for a, g, b in zip(xs, gs, bs)],
        [[mm, mv]] * replicas, True, [None] * replicas, group)
    assert not rep
    torch.autograd.backward([o[0] for o in outs], list(torch.chunk(dy,
                                                               replicas)))
    xw = x.clone().requires_grad_()
    gw = gamma.to(cuda).requires_grad_()
    bw = beta.to(cuda).requires_grad_()
    want = torch.nn.functional.batch_norm(xw, None, None, gw, bw, True,
                                          0.0, 2e-5)
    want.backward(dy)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.cuda.synchronize()
    got = torch.cat([o[0] for o in outs])
    assert (got - want).abs().max().item() <= 2e-5
    for a in aux:
        assert (a[0] - (0.9 * mm + 0.1 * mean)).abs().max().item() <= 2e-5
        assert (a[1] - (0.9 * mv + 0.1 * var)).abs().max().item() <= 2e-5
    dx = torch.cat([t.grad for t in xs])
    assert (dx - xw.grad).abs().max().item() <= 2e-5 * max(
        1.0, xw.grad.abs().max().item())
    assert (sum(g.grad for g in gs) - gw.grad).abs().max().item() <= 2e-4
    assert (sum(b.grad for b in bs) - bw.grad).abs().max().item() <= 2e-4


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_sweep_over_zero1_slices(cuda, offset):
    """The sweep over a flat vector of a device's ZeRO-1 slices (rows of
    several leaves, concatenated) at an offset of 0 (16-byte aligned: the
    vectorised route) or 1 or 3 elements (the scalar route), against its
    plain version, bit for bit; the route is counted by device."""
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.kernels import fused_opt as fo
    opt = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
                         rescale_grad=1.0 / 64)
    rng = np.random.RandomState(offset)
    leaves = [(64, 3, 3), (128,), (10, 7)]
    dp, d = 2, 1

    def slices(scale):
        parts = []
        for shape in leaves:
            a = torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                 * scale)
            rows = shape[0] // dp
            parts.append(a[d * rows:(d + 1) * rows].reshape(-1))
        flat = torch.cat(parts)
        buf = torch.zeros(flat.numel() + offset)
        buf[offset:] = flat
        return buf.to(cuda)[offset:]
    w, g, m = slices(1.0), slices(10.0), slices(0.01)
    want_w, want_s = fo.sweep_reference(opt, w, g, [m], 0.1, 1e-4, 3)
    route = fo.sweep_route(w, g, [m])
    assert route == ("vec4" if offset == 0 else "scalar")
    before = fo.sweep.launches_by_route.get(str(cuda), {}).get(route, 0)
    fo.sweep(opt, w, g, [m], 0.1, 1e-4, 3)
    torch.cuda.synchronize()
    assert fo.sweep.launches_by_route[str(cuda)][route] == before + 1
    assert torch.equal(w, want_w) and torch.equal(m, want_s[0])


def test_dp_trainer_on_the_card_matches_one_device(cuda, monkeypatch):
    """ShardedTrainer dp=2 on one card (two replicas, plain adds) with
    and without ZeRO-1, two steps of ResNet-18: ZeRO-1 bit for bit plain
    dp (the sweep on every replica, deterministic cuDNN), and the dp
    parameters and BatchNorm statistics no further from the same
    one-device steps run in float64 than twice the one-device float32
    steps are (the witness of ``chip_smoke.py``: BatchNorm's shift
    invariance leaves the first betas' gradients cancelling to float32
    rounding, so no fixed tolerance holds there)."""
    import mxnet_tpu_torch as mx
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    sym = mx.models.resnet.get_symbol(10, 18, (3, 32, 32))
    rng = np.random.RandomState(1)
    batch = {"data": rng.randn(8, 3, 32, 32).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 8).astype(np.float32)}
    got = {}
    for name, ctxs, zero1, dtype in (
            ("f64", [mx.gpu(0)], False, torch.float64),
            ("one", [mx.gpu(0)], False, torch.float32),
            ("dp", [mx.gpu(0), mx.gpu(0)], False, torch.float32),
            ("zero1", [mx.gpu(0), mx.gpu(0)], True, torch.float32)):
        # the sweep takes float32: the float64 reference updates leafwise
        monkeypatch.setenv("MXTPU_FUSED_OPT", "kernel"
                           if dtype == torch.float32 else "")
        mesh = mx.parallel.make_mesh(ctxs, dp=len(ctxs))
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  rescale_grad=1.0 / 8)
        tr = mx.parallel.ShardedTrainer(sym, opt, mesh, zero1=zero1)
        mx.random.seed(0)
        p, s, a = tr.init_params({"data": (8, 3, 32, 32)},
                                 label_shapes={"softmax_label": (8,)},
                                 dtype=dtype)
        b = tr.shard_batch(batch) if dtype == torch.float32 else {
            k: torch.from_numpy(v.astype(np.float64)).to(cuda)
            for k, v in batch.items()}
        for _ in range(2):
            p, s, a, _o = tr.step(p, s, a, b)
        got[name] = ({k: (v.global_tensor() if hasattr(v, "global_tensor")
                          else v).double().cpu() for k, v in p.items()},
                     {k: (v.global_tensor() if hasattr(v, "global_tensor")
                          else v).double().cpu() for k, v in a.items()})
    for i, what in ((0, "parameters"), (1, "aux")):
        for k in got["one"][i]:
            assert torch.equal(got["dp"][i][k], got["zero1"][i][k]), k

        def dist(run):
            return max((got[run][i][k] - w).abs().max().item()
                       for k, w in got["f64"][i].items())
        assert dist("dp") <= 2 * dist("one"), (what, dist("dp"),
                                              dist("one"))


# ----------------------------------------------------------------------
# the flat C ABI on the card (lib/libmxtpu_torch_capi.so)
# ----------------------------------------------------------------------
def _capi_bin():
    from mxnet_tpu_torch import libinfo
    try:
        return libinfo.build_capi()
    except libinfo.CapiBuildError as err:
        if err.missing_python_headers or "no " in str(err).split("\n")[0]:
            pytest.skip(str(err).split("\n")[0])
        raise


def _capi_env(**extra):
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkgs = [p for p in sys.path if p.endswith(("site-packages",
                                               "dist-packages"))]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root] + pkgs)
    env.pop("MXNET_CAPI_CONTEXT", None)
    env.update(extra)
    return env


def test_capi_consumers_on_the_card(cuda, tmp_path):
    """The unchanged C consumers against the port's library:
    ``capi_smoke`` and ``capi_threads`` on gpu(0) (no context set),
    ``capi_parity`` with ``MXNET_CAPI_CONTEXT=cpu`` (it binds on
    dev_type 1 itself)."""
    import os
    import subprocess
    import mxnet_tpu_torch as mx
    bindir = _capi_bin()
    prefix = str(tmp_path / "mlp")
    with mx.cpu():
        mod = mx.mod.Module(mx.models.get_mlp(num_classes=2, hidden=(8,)),
                            context=mx.cpu())
        mod.bind(data_shapes=[("data", (2, 10))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params(mx.init.Uniform(0.1))
        mod.save_checkpoint(prefix, 0)
    files = dict(MXTPU_SYMBOL_JSON=prefix + "-symbol.json",
                 MXTPU_PARAMS_FILE=prefix + "-0000.params",
                 MXTPU_SCRATCH=str(tmp_path))
    for prog, ok, extra in (("capi_smoke", "CAPI SMOKE OK", {}),
                            ("capi_threads", "CAPI THREADS OK", {}),
                            ("capi_parity", "capi_parity OK",
                             {"MXNET_CAPI_CONTEXT": "cpu"})):
        proc = subprocess.run([os.path.join(bindir, prog)],
                              env=_capi_env(**dict(files, **extra)),
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (prog, proc.stdout,
                                      proc.stderr[-2000:])
        assert ok in proc.stdout and "terminate called" not in proc.stderr


def test_capi_arrays_live_on_the_card(cuda, monkeypatch):
    """Through the library loaded in this process: MXNDArrayCreate (no
    context set) makes a gpu(0) array, MXNDArrayGetContext reports
    (2, 0), and MXNDArrayGetData gives a host snapshot."""
    import ctypes
    from mxnet_tpu_torch import libinfo
    _capi_bin()
    monkeypatch.delenv("MXNET_CAPI_CONTEXT", raising=False)
    lib = ctypes.CDLL(libinfo.CAPI_LIB_PATH)
    lib.MXGetLastError.restype = ctypes.c_char_p
    shape = (ctypes.c_uint32 * 2)(2, 3)
    h = ctypes.c_void_p()
    assert lib.MXNDArrayCreate(shape, 2, ctypes.byref(h)) == 0, \
        lib.MXGetLastError()
    vals = (ctypes.c_float * 6)(*range(6))
    assert lib.MXNDArraySyncCopyFromCPU(h, vals, ctypes.c_size_t(6)) == 0
    dev_type, dev_id = ctypes.c_int(-1), ctypes.c_int(-1)
    assert lib.MXNDArrayGetContext(h, ctypes.byref(dev_type),
                                   ctypes.byref(dev_id)) == 0
    assert (dev_type.value, dev_id.value) == (2, 0)
    arr = ctypes.cast(h.value, ctypes.py_object).value
    assert arr.data.is_cuda
    data = ctypes.POINTER(ctypes.c_float)()
    assert lib.MXNDArrayGetData(h, ctypes.byref(data)) == 0
    assert [data[i] for i in range(6)] == [0, 1, 2, 3, 4, 5]
    assert lib.MXNDArrayFree(h) == 0


def test_capi_rtc_saxpy_matches_plain(cuda, tmp_path):
    """``example/cpp-torch/rtc_saxpy.c`` (a CUDA C body through
    MXRtcCreate/MXRtcPush) within 1 float32 ulp of the plain
    ``2.5 * x + y``, at a size that is not a multiple of the block."""
    import os
    import subprocess
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    bindir = _capi_bin()
    n = (1 << 20) + 3
    rng = np.random.RandomState(16)
    # uniform in [0, 1), as chip_smoke.py's phase 8 holds saxpy to 1 ulp
    x = rng.rand(n).astype(np.float32)
    y = rng.rand(n).astype(np.float32)
    x.tofile(str(tmp_path / "x.f32"))
    y.tofile(str(tmp_path / "y.f32"))
    proc = subprocess.run(
        [os.path.join(bindir, "rtc_saxpy"), str(n), "x.f32", "y.f32",
         "out.f32"], env=_capi_env(), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-2000:])
    got = torch.from_numpy(np.fromfile(str(tmp_path / "out.f32"),
                                       dtype=np.float32))
    want = rk.saxpy_reference(torch.from_numpy(x).to(cuda),
                              torch.from_numpy(y).to(cuda)).cpu()
    a = want.abs()
    spacing = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    assert got.numel() == n
    assert float(((got - want).abs() / spacing).max()) <= 1.0


def test_profiler_traces_the_hand_kernels(cuda, tmp_path):
    """``mx.profiler`` on the card: a trace of 20 float32 flash forwards
    and 20 sweeps names both hand kernels among its CUDA kernels.  CUPTI
    drops records of a session now and then: after each test of this
    file, 2 of 278 such traces lacked every record of one of the two
    kernels, and others the first 1-12 iterations (H100 80GB HBM3,
    700.00 W).  So a trace is taken up to three times."""
    import json
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    q = torch.randn(2, 8, 1024, 64, device=cuda)
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    w = torch.randn(4096, device=cuda)
    g = torch.randn(4096, device=cuda)
    mom = torch.zeros(4096, device=cuda)
    mx.profiler.profiler_set_config(filename=str(tmp_path))
    traces = []
    for _ in range(3):
        mx.profiler.profiler_set_state("run")
        try:
            for _ in range(20):
                fa.flash_attention_forward(q, q, q, causal=True)
                fo.sweep(opt, w, g, [mom], 0.1, 0.0, 1)
        finally:
            path = mx.profiler.profiler_set_state("stop")
        names = [e["name"] for e in json.load(open(path))["traceEvents"]
                 if e.get("cat") == "kernel"]
        traces.append((sum("flash_forward_fma" in n for n in names),
                       sum("sweep_" in n for n in names)))
        if all(traces[-1]):
            break
    assert all(traces[-1]), traces


def test_peak_table_knows_the_card(cuda):
    """The card's name is a row of the peak table, so MFU is priced."""
    from mxnet_tpu_torch.observability import counters
    name = torch.cuda.get_device_name(cuda)
    assert name in counters.PEAKS, name
    assert counters.peak_tflops(dtype="float32") \
        == counters.PEAKS[name]["tflops"]["float32"]


def test_registered_kernel_specs_lint_clean_on_the_card(cuda):
    """Every launch the hand kernels register with the static analyzer
    (MXL-K), at the main paths' shapes and the card's own SM count, lints
    clean against the device's properties; the limits are the card's."""
    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.analysis import tiling
    from mxnet_tpu_torch.observability.counters import launch_limits
    lim = launch_limits(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert lim["sms"] == props.multi_processor_count
    assert lim["smem_per_block_optin"] == props.shared_memory_per_block_optin
    specs = [s for p in analysis.KERNEL_SPECS.values() for s in p()]
    assert len(specs) >= 10
    for spec in specs:
        assert tiling.spec_findings(spec, limits=lim) == [], spec["name"]
    assert analysis.hbm_capacity_bytes(cuda) == props.total_memory


def test_kernel_specs_shared_memory_is_the_built_librarys(cuda):
    """Each registered launch's dynamic shared memory and CTAs an SM, at
    the main paths' shapes and every head dim and x dtype the kernels
    take, are those the built library launches with."""
    from mxnet_tpu_torch.kernels import flash_attention, flash_decode, quantize
    from mxnet_tpu_torch.observability.counters import launch_limits
    sms = launch_limits(cuda)["sms"]
    pairs = []
    for q, kv in (("float32", "float32"), ("bfloat16", "bfloat16"),
                  ("float32", "bfloat16")):
        pairs.append(tuple(flash_decode.launch_spec(
            q_dtype=q, kv_dtype=kv, sms=sms, compiled=c,
            **flash_decode.MAIN_SHAPES) for c in (False, True)))
    for m, k, n in quantize.MAIN_SHAPES:
        for x in ("float32", "bfloat16"):
            for qd in ("int8", "fp8_e4m3"):
                pairs += zip(*(quantize.launch_specs(m, n, k, x, qd, sms,
                                                     compiled=c)
                               for c in (False, True)))
    sh = flash_attention.MAIN_SHAPES
    for D in (32, 64, 128):
        for dtype in ("float32", "bfloat16"):
            pairs.append(tuple(flash_attention.launch_spec(
                sh["B"], sh["H"], sh["S"], sh["S"], D, dtype, sms=sms,
                compiled=c) for c in (False, True)))
    # 3 decode launches, 6 flash bodies, at least one per matmul case
    assert len(pairs) >= 17
    for spec, built in pairs:
        assert spec == built, spec["name"]


def test_rtc_launch_lint_on_the_card(cuda, monkeypatch):
    """MXTPU_RTC_LINT=error refuses a 2048-thread block before the
    launch, naming MXL-K004; a clean launch runs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    body = ("long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;"
            "\nif (i < out0_size) out0[i] = in0[i] + 1.0f;")
    x = torch.ones(1024, device=cuda)
    monkeypatch.setenv("MXTPU_RTC_LINT", "error")
    rtc = mx.rtc.Rtc(body, pallas=True)
    with pytest.raises(MXNetError, match="MXL-K004"):
        rtc.push([x], (1, 1, 1), (2048, 1, 1))
    assert rtc.launches == 0
    (out,) = rtc.push([x], (4, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    assert float(out.data.sum()) == 2048.0


# ----------------------------------------------------------------------
# MoE and pipeline parallelism on the card against their CPU runs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("topk,cf", [(1, 1.25), (2, 0.0)])
def test_moe_op_on_the_card_matches_the_cpu(cuda, topk, cf):
    """The MoE op's forward and gradients on cuda:0 against the same op
    on the CPU (float32, TF32 off): the same experts routed and dropped,
    values within 1e-5 of each tensor's scale."""
    from mxnet_tpu_torch.ops.registry import create_operator
    rng = np.random.RandomState(3)
    K, E, H = 4, 16, 32
    ins = [rng.randn(64, E).astype(np.float32),
           rng.randn(K, E).astype(np.float32),
           (rng.randn(K, H, E) * 0.3).astype(np.float32),
           (rng.randn(K, H) * 0.1).astype(np.float32),
           (rng.randn(K, E, H) * 0.3).astype(np.float32),
           (rng.randn(K, E) * 0.1).astype(np.float32)]
    cot = rng.randn(64, E).astype(np.float32)
    got = {}
    for dev in ("cpu", cuda):
        op = create_operator("MoE", num_experts=K, hidden_size=H,
                             top_k=topk, capacity_factor=cf)
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in ins]
        outs, _ = op.forward(ts, [], True, None)
        grads = torch.autograd.grad(
            outs, ts, [torch.tensor(cot, device=dev),
                       torch.ones(1, device=dev)])
        got[str(dev)] = ([o.detach().cpu() for o in outs]
                         + [g.cpu() for g in grads], int(op.dropped))
    (card, drop_c), (host, drop_h) = got[str(cuda)], got["cpu"]
    assert drop_c == drop_h
    for c, h in zip(card, host):
        scale = max(1.0, float(h.abs().max()))
        assert float((c - h).abs().max()) <= 1e-5 * scale


def test_two_stage_pipeline_on_the_card_matches_the_cpu(cuda):
    """A two-stage GPipeTrainer (1f1b, M=4) on cuda:0: three steps'
    losses and the parameters after them within 1e-5 of the CPU run's,
    and the loss its microbatched sequential reference (bit for bit on
    the CPU, within 1e-5 on the card)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import pipeline as pipe
    D, V = 32, 16
    rs = np.random.RandomState(0)
    params = {"embed": {"table": rs.randn(V, D).astype(np.float32) * 0.1},
              "layers": {"w": rs.randn(4, D, D).astype(np.float32) * 0.1,
                         "b": np.zeros((4, D), np.float32)},
              "head": {"w": rs.randn(D, V).astype(np.float32) * 0.1}}
    batch = {"tokens": rs.randint(0, V, (32,)).astype(np.int32),
             "labels": rs.randint(0, V, (32,)).astype(np.int32)}

    def embed(ep, b):
        return ep["table"][b["tokens"].long()]

    def block(lp, h):
        return h + torch.tanh(h @ lp["w"] + lp["b"])

    def head(hp, h, b):
        logp = torch.log_softmax(h @ hp["w"], dim=-1)
        return -logp.gather(1, b["labels"].long()[:, None]).mean()
    runs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        tr = pipe.GPipeTrainer(
            embed, block, head, params, mx.parallel.make_mesh([ctx, ctx],
                                                              pp=2),
            mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
            num_microbatches=4, schedule="1f1b")
        ref = tr.sequential_loss_microbatched(batch)
        losses = [tr.step(batch) for _ in range(3)]
        # bit for bit on the CPU; cuBLAS may round the whole batch's rows
        # otherwise than a microbatch's
        assert abs(losses[0] - ref) < 1e-5 if ctx.device_type == "gpu" \
            else losses[0] == ref
        runs[ctx.device_type] = (losses, tr.params)
    (lc, pc), (lh, ph) = runs["gpu"], runs["cpu"]
    assert max(abs(a - b) for a, b in zip(lc, lh)) < 1e-5
    for part in ph:
        for k in ph[part]:
            assert np.abs(pc[part][k] - ph[part][k]).max() < 1e-5


def _tp_lm(mx, mesh, steps=2, **kw):
    """A small LM's steps on ``mesh`` (SGD with momentum, the CUDA sweep)."""
    import os
    sym = mx.models.transformer.get_symbol(vocab_size=256, num_layers=2,
                                          num_heads=4, dim=128, seq_len=64)
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    try:
        tr = mx.parallel.ShardedTrainer(
            sym, mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                     rescale_grad=1.0 / 256), mesh, **kw)
        mx.random.seed(2)
        p, s, a = tr.init_params({"data": (4, 64)},
                                 label_shapes={"softmax_label": (4, 64)})
        rng = np.random.RandomState(0)
        tok = rng.randint(0, 256, (4, 65)).astype(np.float32)
        b = tr.shard_batch({"data": tok[:, :-1], "softmax_label": tok[:, 1:]})
        for _ in range(steps):
            p, s, a, o = tr.step(p, s, a, b)
        torch.cuda.synchronize()
        return p, s, tr
    finally:
        os.environ.pop("MXTPU_FUSED_OPT", None)


def test_tp_member_launches_on_the_card(cuda):
    """The LM at tp=2 on one card: each member launches the flash forward
    over its 2 of 4 heads once a layer a step, and sweeps its own
    buckets; no whole weight is gathered; the weights come within 1e-4
    of the one-device step's, relative to the largest (cuBLAS sums
    products of other widths in other orders; ``chip_smoke.py`` phase 22
    holds the full-width LM to the float64 witness)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.parallel import tensor_parallel as tp
    one, _s, _t = _tp_lm(mx, mx.parallel.make_mesh([mx.gpu(0)], dp=1))
    fa.flash_attention_forward.launches_by_heads.clear()
    before = fo.sweep.launches
    tp.reset_counts()
    got, _s, tr = _tp_lm(mx, mx.parallel.make_mesh([mx.gpu(0)] * 2, tp=2))
    heads = dict(fa.flash_attention_forward.launches_by_heads)
    sweeps = fo.sweep.launches - before
    member = {k: v.shards[0] for k, v in got.items()}
    buckets = len(fo.plan_buckets({k: member[k] for k in tr.param_names}))
    assert tp.counts()["whole_weight_gathers"] == 0
    assert heads == {2: 2 * 2 * 2}, heads
    assert sweeps == buckets * 2 * 2, (sweeps, buckets)
    err = {k: float((got[k].global_tensor() - one[k]).abs().max())
           / max(1.0, float(one[k].abs().max())) for k in one}
    assert max(err.values()) <= 1e-4, sorted(err.items(),
                                            key=lambda kv: -kv[1])[:3]


def test_fsdp_on_the_card_is_zero1_bit_for_bit(cuda):
    """FSDP at dp=2 on one card: the parameters and momentum after two
    steps equal ZeRO-1's bit for bit, and each member keeps half."""
    import mxnet_tpu_torch as mx
    mesh = mx.parallel.make_mesh([mx.gpu(0)] * 2, dp=2)
    pf, sf, _t = _tp_lm(mx, mesh, fsdp=True)
    pz, sz, _t = _tp_lm(mx, mesh, zero1=True)
    for k in pf:
        assert torch.equal(pf[k].global_tensor(), pz[k].global_tensor()), k
        assert torch.equal(sf[k].global_tensor(), sz[k].global_tensor()), k
        assert pf[k].shards[0].numel() * 2 == pz[k].shards[0].numel()


def test_tp_engine_on_the_card_launches_each_members_heads(cuda):
    """A tp=2 engine on one card: its tokens equal the one-device
    engine's; each decode step launches flash-decode once a layer a
    member over 2 of 4 heads, and under fp8 the weight-only kernel on
    each member's half of the rows."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as q
    rng = np.random.RandomState(0)
    dims = dict(vocab_size=256, num_layers=2, num_heads=4, dim=128,
                max_seq_len=128)
    sym = mx.models.transformer.get_decode_symbol(**dims)
    cache = {"layer%d_att_%s_cache" % (i, c): (16, 32, 4, 32)
             for i in range(2) for c in "kv"}
    shapes, _, _ = sym.infer_shape(data=(1, 1), pos_ids=(1, 1),
                                   seq_pos=(1,), block_table=(1, 4), **cache)
    params = {n: (rng.randn(*s) * 0.05).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "pos_ids", "seq_pos", "block_table")
              and not n.endswith("_cache")}
    kw = dict(max_new_tokens=8, prompt_buckets=(16,), decode_buckets=(2,),
              kv_blocks=16, kv_block_size=32, quantize="fp8_e4m3", **dims)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    want = mx.serving.GenerationEngine(dict(params), ctx=mx.gpu(0),
                                       **kw).generate(prompts)
    eng = mx.serving.GenerationEngine(
        dict(params), mesh=mx.parallel.make_mesh([mx.gpu(0)] * 2, tp=2),
        **kw)
    fd.flash_decode_attention.launches_by_heads.clear()
    q.quantized_matmul.launches_by_rows.clear()
    assert eng.generate(prompts) == want
    steps = eng.stats()["decode_steps"]
    assert fd.flash_decode_attention.launches_by_heads == {2: steps * 2 * 2}
    assert set(q.quantized_matmul.launches_by_rows) == {128, 256, 64}


def _sp_lm(mx, mesh, mirror=False, steps=1, seq=128, compute_dtype=None):
    """The LM (vocab 64, 2 layers, 2 heads, dim 64) at ``seq``, batch 2,
    ``steps`` SGD-momentum steps from one seeded start; returns the
    global parameters after, the first step's outputs and the trainer."""
    rng = np.random.RandomState(3)
    dims = dict(vocab_size=64, num_layers=2, num_heads=2, dim=64,
                seq_len=seq)
    sym = mx.models.transformer.get_symbol(mirror_blocks=mirror, **dims)
    shapes, _, _ = sym.infer_shape(data=(2, seq), softmax_label=(2, seq))
    params = {n: (rng.randn(*s) * 0.05).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    batch = {"data": rng.randint(0, 64, (2, seq)).astype(np.float32),
             "softmax_label": rng.randint(0, 64, (2, seq))
             .astype(np.float32)}
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                              rescale_grad=1.0 / (2 * seq))
    tr = mx.parallel.ShardedTrainer(
        sym, opt, mesh, seq_axis=1 if mesh.shape.get("sp", 1) > 1 else None,
        compute_dtype=compute_dtype)
    p = tr.place_params(params)
    st = {k: torch.zeros(v.shape, device="cuda") for k, v in params.items()}
    if mesh.size > 1:
        from mxnet_tpu_torch.parallel.sharding import P, place
        st = {k: place(v, mesh, P(*([None] * v.dim())))
              for k, v in st.items()}
    b = tr.shard_batch(batch)
    first = None
    for _ in range(steps):
        p, st, _a, out = tr.step(p, st, {}, b)
        if first is None:
            first = out[0] if isinstance(out[0], torch.Tensor) \
                else out[0].global_tensor()
    torch.cuda.synchronize()
    whole = {k: v if isinstance(v, torch.Tensor) else v.global_tensor()
             for k, v in p.items()}
    return whole, first, tr


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, None)])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_hops_launch_the_flash_kernel(cuda, dtype, atol, causal):
    """Every ring hop that is not skipped is one launch of
    ``csrc/flash_attention.cu`` on its member's card (two members on the
    first card, and one a card where there are two), and the ring's
    output is one-card attention's: float32 within 2e-5 of the plain
    version, bfloat16 within a bfloat16 ulp of the float32 ring."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel import ring_attention as ra
    rng = np.random.RandomState(1)
    q, k, v = [torch.from_numpy(rng.randn(2, 4, 256, 64).astype(np.float32))
               .to(cuda) for _ in range(3)]
    want = fa.flash_attention_forward_reference(q, k, v, causal=causal)[0]
    layouts = [[cuda, cuda]]
    if torch.cuda.device_count() > 1:
        layouts.append([cuda, torch.device("cuda", 1)])
    for devs in layouts:
        chunks = [[c.to(d, dtype) for c, d in zip(t.chunk(2, dim=2), devs)]
                  for t in (q, k, v)]
        ra.reset_ring_counts()
        before = fa.flash_attention_forward.launches
        got = ra.ring_attention(*chunks, causal=causal)
        torch.cuda.synchronize()
        hops = ra.ring_counts()["hops"]
        assert hops == ({0: 1, 1: 2} if causal else {0: 2, 1: 2})
        assert fa.flash_attention_forward.launches - before \
            == sum(hops.values())
        got = torch.cat([o.to(cuda).float() for o in got], dim=2)
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= atol
        else:
            ulp = want.abs() * 2.0 ** -7 + 2e-2
            assert bool(((got - want).abs() <= ulp).all())


def test_sp_step_on_the_card_matches_one_card(cuda):
    """The LM at dp=1 x sp=2 on the first card (and, with two cards, one
    member a card) against the one-card step from the same weights: the
    outputs and the parameters after two steps within 1e-5 of the
    largest; every member's flash forward a hop and its own sweeps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    import os
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    try:
        one, o1, _t = _sp_lm(mx, mx.parallel.make_mesh([mx.gpu(0)], dp=1),
                             steps=2)
        layouts = [[mx.gpu(0)] * 2]
        if torch.cuda.device_count() > 1:
            layouts.append([mx.gpu(0), mx.gpu(1)])
        for ctxs in layouts:
            mesh = mx.parallel.make_mesh(ctxs, dp=1, sp=2)
            fa_before = fa.flash_attention_forward.launches
            fo_before = fo.sweep.launches
            got, o2, tr = _sp_lm(mx, mesh, steps=2)
            member = {k: torch.empty(v.shape) for k, v in one.items()}
            buckets = len(fo.plan_buckets(member))
            # causal: member 0 one hop, member 1 two, a layer a step
            assert fa.flash_attention_forward.launches - fa_before \
                == 2 * 2 * 3
            assert fo.sweep.launches - fo_before == buckets * 2 * 2
            assert float((o2 - o1).abs().max()) <= 1e-5
            for k in one:
                err = float((got[k] - one[k]).abs().max())
                assert err <= 1e-5 * max(1.0, float(one[k].abs().max())), k
    finally:
        os.environ.pop("MXTPU_FUSED_OPT", None)


def test_mirrored_sp_step_frees_its_segments(cuda):
    """The mirrored sp step on the card equals the unmirrored one bit for
    bit, and with the garbage collector off every segment's record (so
    every recomputed copy, the ring's included) is gone once the step has
    run."""
    import gc
    import weakref
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import executor as E
    mesh = mx.parallel.make_mesh([mx.gpu(0)] * 2, dp=1, sp=2)
    plain, _o, _t = _sp_lm(mx, mesh)
    made = []
    init = E._Recompute.__init__

    def tracking(self, *a, **k):
        init(self, *a, **k)
        made.append(weakref.ref(self))
    E._Recompute.__init__ = tracking
    gc.disable()
    try:
        got, _o, _t = _sp_lm(mx, mesh, mirror=True)
        assert len(made) == 2           # one segment a layer
        assert all(r() is None for r in made)
    finally:
        gc.enable()
        E._Recompute.__init__ = init
    for k in plain:
        assert torch.equal(got[k], plain[k]), k
