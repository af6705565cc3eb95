"""The PyTorch port's kernel modules against the JAX package, on the CPU.

``mxnet_tpu_torch.kernels.flash_decode`` and ``.quantize`` hold the
hand-written CUDA kernels of the port; on CPU tensors their wrappers run
the plain PyTorch versions, which these tests hold against the JAX
package's Pallas kernels in interpret mode and its jnp references, on
identical float32 inputs made with numpy.  The CUDA kernels themselves
are held against the plain versions on the GPU (tests/test_torch_cuda.py
and chip_smoke.py).
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import flash_decode as jfd
from mxnet_tpu.kernels import quantize as jqz
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_decode as tfd
from mxnet_tpu_torch.kernels import quantize as tqz


def _decode_case(seed, dtype=np.float32, b=4, h=4, d=32, nb=16, bs=8, mb=4):
    """Mixed positions (first slot, block boundary, one past it, deep),
    each row's live blocks distinct, trailing slots on trash block 0,
    random values everywhere in the pools (block 0 included)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(dtype)
    k_pool = rng.randn(nb, bs, h, d).astype(dtype)
    v_pool = rng.randn(nb, bs, h, d).astype(dtype)
    pos = np.array([0, bs - 1, bs, mb * bs - 5][:b], np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    table = np.zeros((b, mb), np.int32)
    for i in range(b):
        n = pos[i] // bs + 1
        table[i, :n] = [free.pop() for _ in range(n)]
    return q, k_pool, v_pool, table, pos


def _torch_args(case):
    return [torch.from_numpy(a) for a in case]


def _jax_args(case):
    return [jnp.asarray(a) for a in case]


@pytest.mark.parametrize("scale", [None, 0.25])
def test_flash_decode_plain_matches_jax(scale):
    """Port plain version == JAX Pallas kernel (interpret) == JAX jnp
    reference, atol 1e-5: float32 with the same summation depth."""
    case = _decode_case(seed=11)
    got = tfd.flash_decode_attention(*_torch_args(case), scale=scale)
    assert got.dtype == torch.float32 and got.shape == (4, 4, 32)
    kern = jfd.flash_decode_attention(*_jax_args(case), scale=scale,
                                      interpret=True)
    ref = jfd.decode_attention_reference(*_jax_args(case), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_flash_decode_cpu_wrapper_is_plain_version():
    """On CPU tensors the wrapper runs the plain version and never
    counts a kernel launch."""
    case = _torch_args(_decode_case(seed=3))
    before = tfd.flash_decode_attention.launches
    got = tfd.flash_decode_attention(*case)
    want = tfd.decode_attention_reference(*case)
    assert torch.equal(got, want)
    assert tfd.flash_decode_attention.launches == before


def test_flash_decode_bfloat16_pools():
    """bfloat16 inputs: the plain version keeps q's dtype and tracks the
    float32 result within bfloat16 rounding."""
    case = _decode_case(seed=5)
    f32 = tfd.decode_attention_reference(*_torch_args(case))
    q, k, v, table, pos = _torch_args(case)
    bf = tfd.decode_attention_reference(q.bfloat16(), k.bfloat16(),
                                        v.bfloat16(), table, pos)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), f32.numpy(), atol=5e-2)


def test_quantize_array_bitwise_equal_to_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(24, 80).astype(np.float32)
    w[5] = 0.0                                  # all-zero row: scale 1
    q, scale = tqz.quantize_array(w)
    jq, jscale = jqz.quantize_array(w)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    assert np.array_equal(q, jq)
    assert np.array_equal(scale.view(np.int32), jscale.view(np.int32))
    np.testing.assert_array_equal(tqz.dequantize_array(q, scale),
                                  jqz.dequantize_array(jq, jscale))


def test_quantize_rejects_what_the_port_lacks():
    """A 1-D weight, and a qdtype that neither package has (the JAX
    package's ``storage_dtype`` raises for it too)."""
    with pytest.raises(MXNetError):
        tqz.quantize_array(np.zeros(8, np.float32))
    with pytest.raises(MXNetError):
        tqz.quantize_array(np.zeros((2, 2), np.float32), qdtype="int4")
    with pytest.raises(Exception):
        jqz.storage_dtype("int4")
    with pytest.raises(MXNetError):
        tqz.quantize_symbol("{}", qdtype="int4")


def _fp8_weight(seed, n=24, k=80):
    """A weight whose rows reach every e4m3 regime after scaling: the
    absmax (448 exactly), values that round up past 448 in float32
    division, e4m3 subnormals (below 2^-6) and the ties that round to
    even there, and an all-zero row."""
    rng = np.random.RandomState(seed)
    w = rng.randn(n, k).astype(np.float32)
    w[1, :8] = np.float32(448.0) * np.array(
        [1, -1, 2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10,
         0.99999, -0.5], np.float32)
    w[2] = np.linspace(-1.0, 1.0, k, dtype=np.float32) ** 9
    w[5] = 0.0
    return w


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_fp8_bytes_equal_to_jax(seed):
    """fp8 e4m3: the port's bytes and scales equal the JAX package's
    (ml_dtypes), with the scale absmax / 448; torch's cast saturates at
    448 as ml_dtypes' does (the bytes of 447.9 .. 460 are all 0x7e)."""
    w = _fp8_weight(seed)
    q, scale = tqz.quantize_array(w, qdtype="fp8_e4m3")
    jq, jscale = jqz.quantize_array(w, qdtype="fp8_e4m3")
    assert q.dtype == torch.float8_e4m3fn and q.shape == w.shape
    assert np.array_equal(q.view(torch.uint8).numpy(), jq.view(np.uint8))
    assert np.array_equal(scale.view(np.int32), jscale.view(np.int32))
    assert np.array_equal(tqz._to_numpy(q), jq.view(np.uint8))
    np.testing.assert_array_equal(tqz.dequantize_array(q, scale),
                                  jqz.dequantize_array(jq, jscale))
    edge = torch.tensor([447.9, 448.0, 448.01, 460.0, -460.0])
    assert edge.to(torch.float8_e4m3fn).view(torch.uint8).tolist() == \
        [0x7e, 0x7e, 0x7e, 0x7e, 0xfe]
    codes = q.view(torch.uint8)
    assert not ((codes & 0x7f) == 0x7f).any()        # no NaN code


def test_quantize_params_fp8_is_idempotent():
    w = _fp8_weight(3)
    once = tqz.quantize_params({"fc_weight": w, "b": np.ones(3)},
                               ["fc_weight"], qdtype="fp8_e4m3")
    assert once["fc_weight"].dtype == torch.float8_e4m3fn
    twice = tqz.quantize_params(once, ["fc_weight"], qdtype="fp8_e4m3")
    assert twice["fc_weight"] is once["fc_weight"]
    assert twice["fc_weight_scale"] is once["fc_weight_scale"]
    # an fp8 weight asked for as int8 is quantized from its values, as
    # the JAX package does from its ml_dtypes array
    as_int8 = tqz.quantize_params({"fc_weight": once["fc_weight"]},
                                  ["fc_weight"], qdtype="int8")
    jq = jqz.quantize_array(w, qdtype="fp8_e4m3")[0]
    want = jqz.quantize_params({"fc_weight": jq}, ["fc_weight"],
                               qdtype="int8")
    assert np.array_equal(as_int8["fc_weight"], want["fc_weight"])


@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (8, 256, 512),
                                   (17, 2048, 128)])
def test_quantized_matmul_fp8_plain_matches_jax(m, k, n):
    """fp8 e4m3 weights: the port's plain version == the JAX Pallas
    kernel in interpret mode, within 1e-5 (float32 sums of the same
    exact products in another order)."""
    rng = np.random.RandomState(m * k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(n, k) * 0.05).astype(np.float32)
    q, scale = tqz.quantize_array(w, qdtype="fp8_e4m3")
    jq, jscale = jqz.quantize_array(w, qdtype="fp8_e4m3")
    got = tqz.quantized_matmul(torch.from_numpy(x), q,
                               torch.from_numpy(scale))
    want = jqz.quantized_matmul(jnp.asarray(x), jnp.asarray(jq),
                                jnp.asarray(jscale), interpret=True)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_pad_depth_keeps_fp8_bytes():
    """K that is no multiple of 16 is zero-padded through w_q's bytes:
    fp8 weights keep their bytes and the product is unchanged."""
    rng = np.random.RandomState(4)
    q, scale = tqz.quantize_array(rng.randn(5, 40).astype(np.float32),
                                  qdtype="fp8_e4m3")
    x = torch.from_numpy(rng.randn(3, 40).astype(np.float32))
    xp, qp = tqz.pad_depth(x, q)
    assert xp.shape == (3, 48) and qp.shape == (5, 48)
    assert qp.dtype == torch.float8_e4m3fn
    assert torch.equal(qp[:, :40].view(torch.uint8), q.view(torch.uint8))
    assert not qp[:, 40:].view(torch.uint8).any()
    sc = torch.from_numpy(scale)
    assert torch.equal(tqz.quantized_matmul_reference(xp, qp, sc),
                       tqz.quantized_matmul_reference(x, q, sc))
    assert tqz.pad_depth(xp, qp)[1] is qp


@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (8, 256, 512),
                                   (6, 2048, 128)])
def test_quantized_matmul_plain_matches_jax(m, k, n):
    """Port plain version == JAX Pallas kernel (interpret), atol 1e-4
    rtol 1e-5: float32 sums over K <= 2048 in another order."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    q, scale = jqz.quantize_array((rng.randn(n, k) * 0.05).astype(np.float32))
    got = tqz.quantized_matmul(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(scale))
    want = jqz.quantized_matmul(jnp.asarray(x), jnp.asarray(q),
                                jnp.asarray(scale), interpret=True)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


def test_quantized_matmul_cpu_wrapper_is_plain_version():
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(3, 40).astype(np.float32))
    q, scale = tqz.quantize_array(rng.randn(7, 40).astype(np.float32))
    wq, sc = torch.from_numpy(q), torch.from_numpy(scale)
    before = tqz.quantized_matmul.launches
    assert torch.equal(tqz.quantized_matmul(x, wq, sc),
                       tqz.quantized_matmul_reference(x, wq, sc))
    assert tqz.quantized_matmul.launches == before


def _mlp_json():
    import mxnet_tpu as jmx
    data = jmx.sym.Variable("data")
    fc1 = jmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = jmx.sym.Activation(fc1, act_type="relu")
    fc2 = jmx.sym.FullyConnected(act, num_hidden=4, no_bias=True,
                                 name="fc2")
    return jmx.sym.Group([fc2, act]).tojson()


@pytest.mark.parametrize("rules", [None, (r"fc2_.*",)])
def test_quantize_symbol_same_json_as_jax(rules):
    js = _mlp_json()
    assert tqz.quantizable_weights(js, rules) == \
        jqz.quantizable_weights(js, rules)
    got, names = tqz.quantize_symbol(js, rules=rules)
    want, jnames = jqz.quantize_symbol(js, rules=rules)
    assert got == want and names == jnames
    ops = [n["op"] for n in json.loads(got)["nodes"]]
    assert ops.count("QuantizedDense") == len(names)


def test_quantize_params_idempotent_without_host_copy():
    rng = np.random.RandomState(1)
    params = {"fc1_weight": rng.randn(8, 16).astype(np.float32),
              "fc1_bias": np.zeros(8, np.float32)}
    once = tqz.quantize_params(params, ["fc1_weight"])
    jonce = jqz.quantize_params(params, ["fc1_weight"])
    assert np.array_equal(once["fc1_weight"], jonce["fc1_weight"])
    assert np.array_equal(once["fc1_weight_scale"], jonce["fc1_weight_scale"])
    on_device = {k: torch.from_numpy(v) for k, v in once.items()}
    twice = tqz.quantize_params(on_device, ["fc1_weight"])
    assert twice["fc1_weight"] is on_device["fc1_weight"]
