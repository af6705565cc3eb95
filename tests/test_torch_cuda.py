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
