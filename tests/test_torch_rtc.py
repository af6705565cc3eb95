"""The port's ``rtc.Rtc`` against the JAX package's, on the CPU.

- ``pallas=False``: the same function (``x + 2.0*y``, a tanh-GELU) on the
  same numpy inputs through both packages' ``Rtc``; exact for the
  arithmetic, 2e-6 relative for ``tanh`` (XLA's and PyTorch's CPU
  libraries round it differently).
- ``pallas=True``: a CUDA C body cannot run here, so the plain versions
  of the port's kernels (``kernels/rtc_kernels.py``) are held against
  the JAX package's ``Rtc(..., pallas=True)`` on the Pallas bodies that
  ``tests/test_rtc_consistency.py`` and ``example/rtc/pallas_kernel.py``
  push, run in interpret mode as those run.  Tolerance 1 ulp: XLA's CPU
  backend may contract ``a*b + c`` into one FMA where PyTorch rounds
  twice.  The kernels themselves are held against the same plain
  versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
- The generated source, the errors, the compile cache and the launch
  path of the NVRTC binding, with the binding monkeypatched where a
  call would need CUDA.
"""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.rtc import Rtc as JRtc

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc as trtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import nvrtc
from mxnet_tpu_torch.kernels import rtc_kernels as rk


@pytest.fixture(autouse=True)
def cpu_scope():
    with tmx.cpu():
        yield


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(*shape).astype(np.float32) for _ in range(2)]


def _ulps(got, want):
    """Largest |got - want| in units of the float32 spacing at want."""
    a = np.abs(want)
    spacing = np.nextafter(a, np.float32(np.inf)) - a
    return float(np.max(np.abs(got - want) / spacing))


# ---------------------------------------------------------------------------
# pallas=False: a function of tensors, called eagerly
# ---------------------------------------------------------------------------
def _gelu_torch(x):
    c = 0.7978845608
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def _gelu_jax(x):
    import jax.numpy as jnp
    c = 0.7978845608
    return 0.5 * x * (1.0 + jnp.tanh(c * (x + 0.044715 * x ** 3)))


@pytest.mark.parametrize("name,tfn,jfn,tol", [
    ("x_plus_2y", lambda x, y: x + 2.0 * y, lambda x, y: x + 2.0 * y, 0.0),
    ("gelu", lambda x, y: _gelu_torch(x), lambda x, y: _gelu_jax(x), 2e-6),
    ("two_outputs", lambda x, y: (x * y, x - y),
     lambda x, y: (x * y, x - y), 0.0)])
def test_function_branch_matches_jax(name, tfn, jfn, tol):
    x, y = _inputs((4, 5), 0)
    got = trtc.Rtc(tfn, n_outputs=1).push([tmx.nd.array(x),
                                           tmx.nd.array(y)])
    want = JRtc(jfn, n_outputs=1).push([jmx.nd.array(x), jmx.nd.array(y)])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tmx.nd.NDArray) and g.context == tmx.cpu()
        np.testing.assert_allclose(g.asnumpy(), np.asarray(w.asnumpy()),
                                   rtol=tol, atol=tol)


def test_function_branch_caches_per_key_and_counts_no_launch():
    calls = []
    rtc = trtc.Rtc(lambda x: calls.append(1) or x * 2)
    before = trtc.launches
    for shape in ((3,), (3,), (4,)):
        (out,) = rtc.push([torch.ones(shape)])
        assert torch.equal(out.data, torch.full(shape, 2.0))
    assert len(rtc._compiled) == 2 and len(calls) == 3
    assert rtc.launches == 0 and trtc.launches == before


# ---------------------------------------------------------------------------
# pallas=True: the plain versions against the JAX package's Pallas kernels
# ---------------------------------------------------------------------------
def _xy1_pallas(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] * y_ref[...] + 1.0


def _saxpy_pallas(x_ref, y_ref, o_ref):
    o_ref[...] = 2.5 * x_ref[...] + y_ref[...]


@pytest.mark.parametrize("name,pallas_body,shape", [
    ("xy_plus_one", _xy1_pallas, (8, 8)),
    ("saxpy", _saxpy_pallas, (128, 128))])
def test_plain_versions_match_jax_pallas(name, pallas_body, shape):
    x, y = _inputs(shape, 3)
    (want,) = JRtc(pallas_body, n_outputs=1, pallas=True).push(
        [jmx.nd.array(x), jmx.nd.array(y)])
    plain = getattr(rk, name + "_reference")(torch.from_numpy(x),
                                             torch.from_numpy(y))
    before = trtc.launches
    (wrapped,) = getattr(rk, name)(tmx.nd.array(x), tmx.nd.array(y))
    want = np.asarray(want.asnumpy())
    assert trtc.launches == before          # CPU arrays: the plain version
    assert torch.equal(wrapped.data, plain)
    assert _ulps(plain.numpy(), want) <= 1.0


def test_other_plain_versions():
    """exp(5x), (x+y, x*y) from bfloat16 and the transpose, against
    numpy; the wrappers take them for CPU arrays."""
    rng = np.random.RandomState(4)
    x = rng.rand(10).astype(np.float32) * 2 - 1
    (e,) = rk.exp_shared(tmx.nd.array(x))
    np.testing.assert_allclose(e.asnumpy(), np.exp(5 * x), rtol=2e-6)
    a, b = (tmx.nd.array(rng.rand(6, 7).astype(np.float32),
                         dtype=torch.bfloat16) for _ in range(2))
    s, p = rk.add_mul_bf16(a, b)
    af, bf = a.asnumpy(), b.asnumpy()
    assert s.dtype == p.dtype == torch.float32
    np.testing.assert_array_equal(s.asnumpy(), af + bf)
    np.testing.assert_array_equal(p.asnumpy(), af * bf)
    m = rng.rand(5, 3).astype(np.float32)
    (t,) = rk.transpose(tmx.nd.array(m))
    np.testing.assert_array_equal(t.asnumpy(), m.T)


# ---------------------------------------------------------------------------
# the generated source
# ---------------------------------------------------------------------------
def test_kernel_source_signature_constants_headers():
    src = trtc.kernel_source(
        "out0[0] = in0[0];",
        [("x", (2, 3), torch.float32), ("idx", (7,), torch.int64)],
        [("out0", (3, 2), torch.float32)])
    assert ('extern "C" __global__ void rtc_kernel('
            'const float* __restrict__ x,\n'
            '    const long long* __restrict__ idx,\n'
            '    float* __restrict__ out0)') in src
    for line in ("constexpr long long x_size = 6LL;",
                 "constexpr int x_ndim = 2;",
                 "constexpr long long x_dim0 = 2LL;",
                 "constexpr long long x_dim1 = 3LL;",
                 "constexpr long long idx_size = 7LL;",
                 "constexpr int idx_ndim = 1;",
                 "constexpr long long out0_dim0 = 3LL;"):
        assert line in src
    assert "#include" not in src
    assert src.rstrip().endswith("{\nout0[0] = in0[0];\n}")
    half = trtc.kernel_source("", [("in0", (1,), torch.float16)],
                              [("out0", (1,), torch.float32)])
    assert "#include <cuda_fp16.h>" in half and "cuda_bf16" not in half
    bf = trtc.kernel_source("", [("in0", (1,), torch.bfloat16)],
                            [("out0", (1,), torch.bfloat16)])
    assert "#include <cuda_bf16.h>" in bf and "cuda_fp16" not in bf
    scalar = trtc.kernel_source("", [("in0", (), torch.float32)], [])
    assert "in0_size = 1LL;" in scalar and "in0_ndim = 0;" in scalar


@pytest.mark.parametrize("dtype,ctype", [
    (torch.float32, "float"), (torch.float64, "double"),
    (torch.float16, "__half"), (torch.bfloat16, "__nv_bfloat16"),
    (torch.int8, "signed char"), (torch.uint8, "unsigned char"),
    (torch.int32, "int"), (torch.int64, "long long"), (torch.bool, "bool")])
def test_dtype_map(dtype, ctype):
    src = trtc.kernel_source("", [("in0", (4,), dtype)],
                             [("out0", (4,), dtype)])
    assert "const %s* __restrict__ in0" % ctype in src
    assert "%s* __restrict__ out0" % ctype in src


@pytest.mark.parametrize("dtype", [torch.int16, torch.complex64])
def test_unknown_dtype_raises(dtype):
    with pytest.raises(MXNetError, match="no CUDA C element type"):
        trtc.kernel_source("", [("in0", (4,), dtype)], [])


# ---------------------------------------------------------------------------
# errors and the compile cache
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_compile(monkeypatch):
    """nvrtc.compile_cubin replaced by a recorder (no NVRTC here)."""
    sources = []

    def compile_cubin(source):
        sources.append(source)
        return b"cubin %d" % len(sources)

    monkeypatch.setattr(nvrtc, "compile_cubin", compile_cubin)
    return sources


def test_kernel_branch_refuses_cpu_tensors(fake_compile):
    x = tmx.nd.ones((8,))
    rtc = trtc.Rtc(rk.SAXPY, pallas=True)
    with pytest.raises(MXNetError, match="one CUDA device.*cannot run on "
                       "the CPU"):
        rtc.push([x, x], (1, 1, 1), (8, 1, 1))
    assert fake_compile == [] and rtc.launches == 0


@pytest.mark.parametrize("grid,block", [(None, (8, 1, 1)), ((1, 1, 1), None),
                                        (None, None)])
def test_kernel_branch_needs_grid_and_block(grid, block):
    x = tmx.nd.ones((8,))
    with pytest.raises(MXNetError, match="needs grid_dims and block_dims"):
        trtc.Rtc(rk.SAXPY, pallas=True).push([x, x], grid, block)


def test_kernel_branch_checks_dims_rank():
    x = tmx.nd.ones((8,))
    with pytest.raises(MXNetError, match="grid_dims needs 1 to 3"):
        trtc.Rtc(rk.SAXPY, pallas=True).push([x, x], (1, 1, 1, 1), (8,))


def test_kernel_branch_takes_cuda_c_only():
    with pytest.raises(MXNetError, match="kernel bodies are CUDA C"):
        trtc.Rtc(_saxpy_pallas, pallas=True)
    with pytest.raises(MXNetError, match="no interpret mode"):
        trtc.Rtc(rk.SAXPY, pallas=True, interpret=True)
    trtc.Rtc(rk.SAXPY, pallas=True, interpret=False)
    with pytest.raises(MXNetError, match="at least one input"):
        trtc.Rtc(rk.SAXPY, pallas=True).push([], (1,), (1,))
    with pytest.raises(MXNetError, match="NDArrays or tensors"):
        trtc.Rtc(rk.SAXPY, pallas=True).push([np.ones(3)], (1,), (1,))


def test_unknown_dtype_raises_at_compile(fake_compile):
    rtc = trtc.Rtc(rk.SAXPY, pallas=True)
    with pytest.raises(MXNetError, match="no CUDA C element type"):
        rtc.compile([(4,)], [torch.int16])
    assert fake_compile == []


def test_one_compile_per_key(fake_compile):
    rtc = trtc.Rtc(rk.ADD_MUL_BF16, n_outputs=2, pallas=True,
                   out_dtypes=[np.float32, "float32"])
    key = ([(4, 5), (4, 5)], [torch.bfloat16, torch.bfloat16])
    first = rtc.compile(*key)
    assert rtc.compile(*key) is first and len(fake_compile) == 1
    other = rtc.compile([(6,), (6,)], ["bfloat16", torch.bfloat16])
    assert other is not first and len(fake_compile) == 2
    assert first.out_shapes == [(4, 5), (4, 5)]
    assert first.out_dtypes == [torch.float32, torch.float32]
    assert first.cubin == b"cubin 1" and first.compile_seconds >= 0
    assert rk.ADD_MUL_BF16.strip() in first.source
    assert "in0_dim1 = 5LL" in first.source
    assert "float* __restrict__ out1" in first.source
    assert "in0_size = 6LL" in fake_compile[1]


def test_output_count_must_match(fake_compile):
    rtc = trtc.Rtc(rk.SAXPY, n_outputs=2, out_shapes=[(3,)], pallas=True)
    with pytest.raises(MXNetError, match="2 outputs, but 1 out_shapes"):
        rtc.compile([(3,), (3,)], [torch.float32] * 2)


# ---------------------------------------------------------------------------
# the NVRTC/driver binding, without CUDA
# ---------------------------------------------------------------------------
def test_missing_nvrtc_names_where_it_looked(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(nvrtc, "_LIBS", {})
    with pytest.raises(MXNetError, match="no libnvrtc.so.* in %s"
                       % (tmp_path / "lib64")):
        nvrtc.compile_cubin("int x;")


def test_missing_driver_names_libcuda(monkeypatch):
    def no_lib(name, *a, **kw):
        raise OSError("%s: cannot open shared object file" % name)

    monkeypatch.setattr(nvrtc, "_LIBS", {})
    monkeypatch.setattr(nvrtc.ctypes, "CDLL", no_lib)
    with pytest.raises(MXNetError, match="libcuda.so.1"):
        nvrtc.Module(b"", 0)


class _FakeDriver(object):
    """Records cuLaunchKernel's arguments, reading each kernel parameter
    through its pointer while the call is in progress."""

    def __init__(self):
        self.calls = []

    def cuLaunchKernel(self, fn, gx, gy, gz, bx, by, bz, shared, stream,
                       params, extra):
        ptrs = [ctypes.cast(params[i], ctypes.POINTER(ctypes.c_void_p))
                .contents.value for i in range(3)]
        self.calls.append(((gx, gy, gz), (bx, by, bz), shared,
                           stream.value, ptrs, extra))
        return 0


def _fake_function(monkeypatch, limit=1024):
    monkeypatch.setattr(nvrtc, "_make_current", lambda lib, device: None)
    module = nvrtc.Module.__new__(nvrtc.Module)
    module._lib, module.device = _FakeDriver(), 0
    fn = nvrtc.Function.__new__(nvrtc.Function)
    fn.module, fn.name, fn._handle = module, "rtc_kernel", ctypes.c_void_p(1)
    fn.max_threads_per_block = limit
    return fn, module._lib


def test_launch_packs_pointers_and_dims(monkeypatch):
    fn, driver = _fake_function(monkeypatch)
    ptrs = [0x7f0000001000, 0x7f0000002000, 0x7fffffff0000]
    fn.launch((128, 128, 1), (32, 8, 1), ptrs, stream=0xabc0)
    ((grid, block, shared, stream, got, extra),) = driver.calls
    assert grid == (128, 128, 1) and block == (32, 8, 1) and shared == 0
    assert stream == 0xabc0 and got == ptrs and extra is None


@pytest.mark.parametrize("grid,block,match", [
    ((1, 1, 1), (2048, 1, 1), "2048 threads, more than the kernel's limit"),
    ((1, 1, 1), (32, 32, 2), "2048 threads"),
    ((0, 1, 1), (64, 1, 1), "at least 1"),
    ((1, 1, 1), (64, 0, 1), "at least 1"),
    ((1, 1), (64, 1, 1), "3 dimensions")])
def test_launch_refuses_bad_dims_before_the_driver(monkeypatch, grid, block,
                                                   match):
    fn, driver = _fake_function(monkeypatch)
    with pytest.raises(MXNetError, match=match):
        fn.launch(grid, block, [1, 2, 3], stream=0)
    assert driver.calls == []
