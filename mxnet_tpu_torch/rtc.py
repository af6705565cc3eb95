"""Runtime-compiled CUDA kernels on NDArrays.

The port of ``mxnet_tpu/rtc.py``, and a return to the reference MXNet's
own ``python/mxnet/rtc.py``, which compiled CUDA C with NVRTC.  The JAX
package compiles a Pallas kernel body at runtime instead; a CUDA card
takes CUDA C again:

    body = '''
        long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
        if (i < out0_size) out0[i] = in0[i] + 2.0f * in1[i];
    '''
    rtc = mx.rtc.Rtc(body, n_outputs=1, pallas=True)
    (out,) = rtc.push([a, b], grid_dims=(n // 256, 1, 1),
                      block_dims=(256, 1, 1))      # a, b: NDArrays on a GPU

- ``pallas=True``: ``fn`` is the *body* of a CUDA C kernel, a ``str``.
  For each (shapes, dtypes) of the inputs, :func:`kernel_source` wraps it
  in ``extern "C" __global__ void rtc_kernel(const T0* in0, ..., T* out0,
  ...)`` with compile-time constants for every array's element count and
  dims (``in0_size``, ``in0_ndim``, ``in0_dim0``, ...), as Pallas refs
  carry their shapes.  NVRTC compiles it for ``sm_90a``
  (:mod:`.kernels.nvrtc`), once per key; ``push`` launches it on
  PyTorch's current stream with the ``grid_dims`` and ``block_dims``
  given, which it requires.  Outputs are new arrays of ``out_shapes`` and
  ``out_dtypes`` (input 0's by default) on the inputs' device.  A CUDA
  body cannot run on the CPU: a CPU tensor raises, as does
  ``interpret=True``, kept in the signature only.
- ``input_names``/``output_names`` name the kernel's parameters (and
  their constants) instead of ``in0``, ``out0``, ..., as the reference
  MXNet's ``Rtc(name, inputs, outputs, kernel)`` names them after the
  caller's arrays (``MXRtcCreate``).
- ``pallas=False``: ``fn`` is a function of torch tensors, called
  eagerly (the JAX package's ``jax.jit(fn)``), on any device.

Before a launch, ``push`` checks its grid and block against the card's
limits (threads a block, grid extents: the static analyzer's
``analysis.tiling.block_findings``, MXL-K), once for each launch shape,
as the JAX package lints its Pallas blocks at build time.
``MXTPU_RTC_LINT``: ``warn`` (the default) emits a ``GraphLintWarning``
and launches anyway (the CUDA driver then refuses what the card cannot
run),
``error`` raises :class:`MXNetError` before the launch, ``off`` skips.

Nothing falls back: a failed compile, load or launch raises
:class:`MXNetError`.  ``Rtc.launches`` counts one instance's kernel
launches and the module's ``launches`` those of every instance.
"""
from __future__ import annotations

import os
import threading
import time
import warnings

import torch

from .base import MXNetError
from .ndarray import NDArray, _torch_dtype

__all__ = ["Rtc", "kernel_source", "KERNEL_NAME", "CTYPES"]

#: the name of the generated ``__global__`` function
KERNEL_NAME = "rtc_kernel"

#: torch dtype -> CUDA C element type
CTYPES = {
    torch.float32: "float",
    torch.float64: "double",
    torch.float16: "__half",
    torch.bfloat16: "__nv_bfloat16",
    torch.int8: "signed char",
    torch.uint8: "unsigned char",
    torch.int32: "int",
    torch.int64: "long long",
    torch.bool: "bool",
}

#: kernel launches of every Rtc in this process
launches = 0


def _ctype(dtype):
    if dtype not in CTYPES:
        raise MXNetError("Rtc: no CUDA C element type for %s (supported: "
                         "%s)" % (dtype, ", ".join(str(d).replace(
                             "torch.", "") for d in CTYPES)))
    return CTYPES[dtype]


def kernel_source(body, inputs, outputs):
    """The CUDA C source of one kernel: ``body`` inside a generated
    ``extern "C" __global__`` function.

    ``inputs`` and ``outputs`` are sequences of ``(name, shape, dtype)``;
    inputs are ``const T* __restrict__``, outputs ``T* __restrict__``, in
    that order.  For each array ``a`` the source defines ``a_size``,
    ``a_ndim`` and ``a_dim0``, ``a_dim1``, ... as compile-time constants,
    and it includes ``cuda_fp16.h``/``cuda_bf16.h`` only when a dtype
    needs them."""
    arrays = list(inputs) + list(outputs)
    lines = ["// generated by mxnet_tpu_torch.rtc.kernel_source"]
    dtypes = {dt for _, _, dt in arrays}
    if torch.float16 in dtypes:
        lines.append("#include <cuda_fp16.h>")
    if torch.bfloat16 in dtypes:
        lines.append("#include <cuda_bf16.h>")
    params = []
    for i, (arr, shape, dtype) in enumerate(arrays):
        shape = tuple(int(s) for s in shape)
        size = 1
        for s in shape:
            size *= s
        lines.append("constexpr long long %s_size = %dLL;" % (arr, size))
        lines.append("constexpr int %s_ndim = %d;" % (arr, len(shape)))
        lines += ["constexpr long long %s_dim%d = %dLL;" % (arr, d, s)
                  for d, s in enumerate(shape)]
        const = "const " if i < len(inputs) else ""
        params.append("%s%s* __restrict__ %s" % (const, _ctype(dtype), arr))
    lines.append('extern "C" __global__ void %s(%s)'
                 % (KERNEL_NAME, ",\n    ".join(params)))
    lines += ["{", body.strip("\n"), "}", ""]
    return "\n".join(lines)


#: device index -> its launch limits (``counters.launch_limits``)
_LIMITS = {}
_LIMITS_LOCK = threading.Lock()


def _launch_lint(grid, block, device, mode):
    """The MXL-K launch check of one ``push``: ``mode`` "warn" emits a
    GraphLintWarning for each finding, "error" raises MXNetError on an
    error finding, "off" skips.  Returns the findings."""
    if mode == "off":
        return []
    from .analysis import GraphLintWarning
    from .analysis.tiling import block_findings
    with _LIMITS_LOCK:
        limits = _LIMITS.get(device.index)
        if limits is None:
            from .observability.counters import launch_limits
            limits = _LIMITS[device.index] = launch_limits(device)
    findings = block_findings(grid, block, 0, "Rtc.push", limits=limits)
    for rule_id, severity, message in findings:
        text = "[%s] rtc kernel: %s" % (rule_id, message)
        if mode == "error" and severity == "error":
            raise MXNetError(text)
        warnings.warn(text, GraphLintWarning, stacklevel=3)
    return findings


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3:
        raise MXNetError("Rtc.push: %s needs 1 to 3 dimensions, got %s"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


class _Kernel(object):
    """One compiled key of a kernel-branch Rtc: its source, CUBIN, output
    layout and the function loaded on each device."""

    def __init__(self, source, cubin, out_shapes, out_dtypes, seconds):
        self.source = source
        self.cubin = cubin
        self.out_shapes = out_shapes
        self.out_dtypes = out_dtypes
        #: NVRTC's compile time of this key
        self.compile_seconds = seconds
        self._functions = {}

    def function(self, device):
        fn = self._functions.get(device)
        if fn is None:
            from .kernels import nvrtc
            fn = nvrtc.Module(self.cubin, device).function(KERNEL_NAME)
            self._functions[device] = fn
        return fn


class Rtc(object):
    """Runtime-compiled kernel wrapper.

    Parameters
    ----------
    fn : with ``pallas=True``, the body of a CUDA C kernel (a ``str``);
        with ``pallas=False``, a function of torch tensors returning a
        tensor or a tuple of tensors.
    n_outputs : number of outputs.
    out_shapes / out_dtypes : the kernel's outputs (default: input 0's
        shape and dtype, for every output).
    interpret : kept for the JAX package's signature; a CUDA body has no
        interpret mode, so ``interpret=True`` with ``pallas=True`` raises.
    input_names / output_names : the CUDA C parameter names (default
        ``in0``, ``in1``, ... and ``out0``, ...).
    """

    def __init__(self, fn, n_outputs=1, pallas=False, out_shapes=None,
                 out_dtypes=None, interpret=None, input_names=None,
                 output_names=None):
        self._pallas = bool(pallas)
        if self._pallas and not isinstance(fn, str):
            raise MXNetError(
                "Rtc(pallas=True) takes the body of a CUDA C kernel as a "
                "str, got %r: the port's kernel bodies are CUDA C (a "
                "function of tensors runs with pallas=False)" % (fn,))
        if self._pallas and interpret:
            raise MXNetError("Rtc: a CUDA C kernel has no interpret mode; "
                             "interpret=True is not supported")
        self._fn = fn
        self._n_out = int(n_outputs)
        self._input_names = list(input_names) if input_names else None
        self._output_names = list(output_names) if output_names else None
        names = (self._input_names or []) + (self._output_names or [])
        bad = [n for n in names if not n.isidentifier()]
        if bad or len(set(names)) != len(names):
            raise MXNetError("Rtc: parameter names must be distinct C "
                             "identifiers, got %s" % names)
        if self._output_names and len(self._output_names) != self._n_out:
            raise MXNetError("Rtc: %d outputs but %d output names"
                             % (self._n_out, len(self._output_names)))
        self._out_shapes = out_shapes
        self._out_dtypes = out_dtypes
        self._compiled = {}
        #: launch shapes already checked (``_launch_lint``)
        self._linted = set()
        #: kernel launches of this instance
        self.launches = 0

    def _build(self, in_shapes, in_dtypes):
        if not self._pallas:
            fn = self._fn

            def run(*xs):
                out = fn(*xs)
                return out if isinstance(out, tuple) else (out,)

            return run

        from .kernels import nvrtc
        out_shapes = [tuple(int(d) for d in s) for s in
                      (self._out_shapes or [in_shapes[0]] * self._n_out)]
        out_dtypes = [_torch_dtype(d) for d in
                      (self._out_dtypes or [in_dtypes[0]] * self._n_out)]
        if len(out_shapes) != self._n_out or len(out_dtypes) != self._n_out:
            raise MXNetError("Rtc: %d outputs, but %d out_shapes and %d "
                             "out_dtypes" % (self._n_out, len(out_shapes),
                                             len(out_dtypes)))
        in_names = self._input_names or ["in%d" % i
                                         for i in range(len(in_shapes))]
        out_names = self._output_names or ["out%d" % i
                                           for i in range(self._n_out)]
        if len(in_names) != len(in_shapes):
            raise MXNetError("Rtc: %d inputs pushed but %d input names"
                             % (len(in_shapes), len(in_names)))
        source = kernel_source(self._fn,
                               list(zip(in_names, in_shapes, in_dtypes)),
                               list(zip(out_names, out_shapes, out_dtypes)))
        t0 = time.perf_counter()
        cubin = nvrtc.compile_cubin(source)
        return _Kernel(source, cubin, out_shapes, out_dtypes,
                       time.perf_counter() - t0)

    def compile(self, in_shapes, in_dtypes):
        """The compiled form of one key (input shapes and dtypes), built
        on first use and cached; :meth:`push` calls it."""
        in_dtypes = [_torch_dtype(d) for d in in_dtypes]
        key = tuple((tuple(int(d) for d in s), str(dt))
                    for s, dt in zip(in_shapes, in_dtypes))
        kernel = self._compiled.get(key)
        if kernel is None:
            kernel = self._build([s for s, _ in key], in_dtypes)
            self._compiled[key] = kernel
        return kernel

    def push(self, ins, grid_dims=None, block_dims=None):
        """Run on NDArray (or tensor) inputs; returns a tuple of new
        NDArrays.  The kernel branch launches ``grid_dims`` blocks of
        ``block_dims`` threads (1 to 3 ints each), both required."""
        global launches
        if not ins:
            raise MXNetError("Rtc.push needs at least one input")
        xs = []
        for x in ins:
            if isinstance(x, NDArray):
                x = x.data
            if not isinstance(x, torch.Tensor):
                raise MXNetError("Rtc.push takes NDArrays or tensors, got %r"
                                 % type(x))
            xs.append(x)
        if not self._pallas:
            outs = self.compile([x.shape for x in xs],
                                [x.dtype for x in xs])(*xs)
            return tuple(NDArray(o) for o in outs)

        if grid_dims is None or block_dims is None:
            raise MXNetError("Rtc.push of a CUDA C kernel needs grid_dims "
                             "and block_dims (the launch's blocks and "
                             "threads a block)")
        grid, block = _dims(grid_dims, "grid_dims"), _dims(block_dims,
                                                           "block_dims")
        device = xs[0].device
        if any(x.device != device for x in xs) or device.type != "cuda":
            raise MXNetError(
                "Rtc.push of a CUDA C kernel needs every input on one CUDA "
                "device, got %s (a CUDA C body cannot run on the CPU; use "
                "pallas=False with a function of tensors there)"
                % sorted({str(x.device) for x in xs}))
        mode = os.environ.get("MXTPU_RTC_LINT", "warn")
        if mode not in ("warn", "error", "off"):
            raise MXNetError("MXTPU_RTC_LINT must be warn, error or off, got "
                             "%r" % mode)
        if (device.index, grid, block, mode) not in self._linted:
            _launch_lint(grid, block, device, mode)
            self._linted.add((device.index, grid, block, mode))
        xs = [x.contiguous() for x in xs]
        kernel = self.compile([x.shape for x in xs], [x.dtype for x in xs])
        outs = [torch.empty(s, dtype=d, device=device)
                for s, d in zip(kernel.out_shapes, kernel.out_dtypes)]
        with torch.cuda.device(device):
            kernel.function(device.index).launch(
                grid, block, [t.data_ptr() for t in xs + outs],
                torch.cuda.current_stream(device).cuda_stream)
        self.launches += 1
        launches += 1
        return tuple(NDArray(o) for o in outs)
