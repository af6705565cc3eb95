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


@pytest.mark.parametrize("m,k,n,dtype,tol", [
    (1, 512, 2048, torch.float32, 1e-4),
    (67, 100, 130, torch.float32, 1e-4),      # ragged on every dim
    (8, 2048, 512, torch.float32, 1e-4),
    (33, 512, 96, torch.bfloat16, 2e-2)])
def test_quantized_matmul_kernel_matches_plain(cuda, m, k, n, dtype, tol):
    from mxnet_tpu_torch.kernels import quantize as qz
    rng = np.random.RandomState(m * n)
    q, scale = qz.quantize_array((rng.randn(n, k) * 0.02).astype(np.float32))
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda, dtype)
    wq, sc = torch.from_numpy(q).to(cuda), torch.from_numpy(scale).to(cuda)
    before = qz.quantized_matmul.launches
    got = qz.quantized_matmul(x, wq, sc)
    want = qz.quantized_matmul_reference(x, wq, sc)
    torch.cuda.synchronize()
    assert qz.quantized_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert float((got.float() - want.float()).abs().max()) <= tol


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
    """A tiny int8 engine on the GPU launches both kernels."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    eng = _engine(cuda, "int8")
    fd.flash_decode_attention.launches = 0
    qz.quantized_matmul.launches = 0
    out = eng.generate([[1, 2, 3], [4, 5]])
    assert [len(t) for t in out] == [4, 4]
    assert fd.flash_decode_attention.launches == 3       # 3 decode steps
    assert qz.quantized_matmul.launches == 2 * 3 + 3 * 3  # prefills + steps


# ----------------------------------------------------------------------
# the training slice: flash-attention forward and the fused sweep
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,rel,atol", [(torch.float32, 0.0, 2e-5),
                                            (torch.bfloat16, 2.0 ** -7, 1e-5)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,D", [(256, 64), (200, 64), (77, 32), (130, 128)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, rel, atol, causal,
                                              S, D):
    """o and lse of the CUDA kernel against the plain version, ragged
    S included (200, 77, 130 are no multiple of the 64-row tile).
    Each element of o is held to ``rel * |plain| + atol``.  float32:
    another summation order, 2e-5 absolute.  bfloat16: both compute in
    float32 and round o once, so a float32 difference can flip that
    rounding by one bfloat16 ulp (2**-7 |plain|, plus 1e-5 near zero),
    no more.  lse stays float32 and within 1e-4 either way."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(S + D)
    q, k, v = [torch.from_numpy(rng.randn(2, 3, S, D).astype(np.float32))
               .to(cuda, dtype) for _ in range(3)]
    before = fa.flash_attention_forward.launches
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 3, S)
    d = (o.float() - ro.float()).abs()
    assert bool((d <= ro.float().abs() * rel + atol).all()), float(d.max())
    assert float((lse - rl).abs().max()) <= 1e-4


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


def test_trainer_gpu_matches_cpu_and_counts_launches(cuda, monkeypatch):
    """A 2-layer transformer trained 2 steps on the GPU (both kernels)
    against the same trainer on the CPU (their plain versions):
    parameters within 1e-5; the flash forward ran once per layer a step
    and the sweep once per bucket a step."""
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
    got = {}
    for dev in (cuda, mx.cpu()):
        mx.random.seed(5)
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  rescale_grad=1.0 / 192)
        tr = mx.parallel.ShardedTrainer(tf.get_symbol(**dims), opt, ctx=dev)
        p, s, a = tr.init_params({"data": (2, 96)},
                                 label_shapes={"softmax_label": (2, 96)})
        b = tr.shard_batch(batch)
        fa.flash_attention_forward.launches = 0
        fo.sweep.launches = 0
        for _ in range(2):
            p, s, a, _o = tr.step(p, s, a, b)
        if dev is cuda:
            n_buckets = len(fo.plan_buckets(p))
            assert n_buckets > 1
            assert fa.flash_attention_forward.launches == 2 * 2
            assert fo.sweep.launches == 2 * n_buckets
        got[str(dev)] = {n: w.cpu() for n, w in p.items()}
    for n, w in got["cpu(0)"].items():
        assert float((got[str(cuda)][n] - w).abs().max()) <= 1e-5, n


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


def test_rtc_errors_on_the_card(cuda):
    """A compile error carries NVRTC's log; a block over the kernel's
    thread limit and a grid dimension of 0 raise before launching."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    x = _rand(cuda, (64,), 6)
    bad = mx.rtc.Rtc("out0[threadIdx.x] = in0[threadIdx.x] +;", pallas=True)
    with pytest.raises(mx.MXNetError, match="NVRTC could not compile"
                       "(.|\n)*error"):
        bad.push([x], (1, 1, 1), (64, 1, 1))
    ok = mx.rtc.Rtc(rk.SAXPY.replace("in1[i]", "0.0f"), pallas=True)
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
