"""Base error type and the saved-file dtype codes.

The port's counterpart of ``mxnet_tpu/base.py``: the error class and the
mshadow-compatible type flags of the 0x112 NDArray file format, mapped
onto torch dtypes (0=float32, 1=float64, 2=float16, 3=uint8, 4=int32,
5=bfloat16, 6=int64, 7=bool — the JAX package's numbering, so a file
saved by either package loads in the other), and the reference's numpy
names of them (``mx_real_t``, ``dtype_np_to_mx``, ``dtype_mx_to_np``;
numpy's bfloat16 is ``ml_dtypes``', where that package is installed).
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["MXNetError", "dtype_torch_to_mx", "dtype_mx_to_torch",
           "collective_seam", "thread_entry", "traced_scope", "mx_real_t",
           "mx_uint", "numeric_types", "string_types", "dtype_np_to_mx",
           "dtype_mx_to_np"]

#: the reference's default real type (real_t = float, fp32)
mx_real_t = _np.float32
mx_uint = int

string_types = (str,)
numeric_types = (float, int, _np.generic)


class MXNetError(Exception):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


def collective_seam(fn=None, **_meta):
    """Runtime no-op marker: this function implements a cluster-wide
    rendezvous or agreement protocol (every rank reaches it together and
    its result is identical on every rank).  The rank-divergence lint
    (``analysis/divergence.py``, MXL-D004..D006) reads it from the source:
    calls to the function are collective sinks, its return value is
    rank-uniform, and the rank asymmetry inside its body is exempt from
    MXL-D005.  At run time it returns ``fn`` unchanged."""
    if fn is None:
        return lambda f: f
    return fn


def thread_entry(fn=None, **_meta):
    """Runtime no-op marker: this function is a thread entry point (its
    body runs on a thread other than the one that built its object) that
    the concurrency lint (``analysis/concurrency.py``, MXL-Q) cannot infer
    from a ``Thread(target=...)`` or ``submit(...)`` call.  At run time it
    returns ``fn`` unchanged."""
    if fn is None:
        return lambda f: f
    return fn


def traced_scope(fn=None, **_meta):
    """Runtime no-op marker: this function's body is traced once and
    replayed (in the port, a formula ``kernels/sweep_codegen`` bakes into
    a generated kernel: the elementwise optimizers' ``update_fn``).  The
    retrace lint (``analysis/retrace.py``, MXL-X001/X002) reads it from the
    source and holds the body to no Python branch or host read on a
    tensor's value.  At run time it returns ``fn`` unchanged."""
    if fn is None:
        return lambda f: f
    return fn


_DTYPE_TORCH_TO_MX = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    torch.bfloat16: 5,
    torch.int64: 6,
    torch.bool: 7,
}
_DTYPE_MX_TO_TORCH = {v: k for k, v in _DTYPE_TORCH_TO_MX.items()}


def dtype_torch_to_mx(dtype) -> int:
    """torch dtype -> mshadow-compatible type flag."""
    if dtype not in _DTYPE_TORCH_TO_MX:
        raise MXNetError("unsupported dtype %s" % dtype)
    return _DTYPE_TORCH_TO_MX[dtype]


def dtype_mx_to_torch(flag: int):
    """mshadow-compatible type flag -> torch dtype."""
    if flag not in _DTYPE_MX_TO_TORCH:
        raise MXNetError("unsupported type flag %d" % flag)
    return _DTYPE_MX_TO_TORCH[flag]


try:            # numpy has no bfloat16 of its own
    import ml_dtypes as _ml_dtypes
    bfloat16 = _np.dtype(_ml_dtypes.bfloat16)
except ImportError:     # pragma: no cover
    bfloat16 = None

_DTYPE_NP_TO_MX = {
    _np.dtype(_np.float32): 0,
    _np.dtype(_np.float64): 1,
    _np.dtype(_np.float16): 2,
    _np.dtype(_np.uint8): 3,
    _np.dtype(_np.int32): 4,
    _np.dtype(_np.int64): 6,
    _np.dtype(_np.bool_): 7,
}
if bfloat16 is not None:
    _DTYPE_NP_TO_MX[bfloat16] = 5
_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}


def dtype_np_to_mx(dtype) -> int:
    """numpy dtype -> mshadow-compatible type flag."""
    dtype = _np.dtype(dtype)
    if dtype not in _DTYPE_NP_TO_MX:
        raise MXNetError("unsupported dtype %s" % dtype)
    return _DTYPE_NP_TO_MX[dtype]


def dtype_mx_to_np(flag: int):
    """mshadow-compatible type flag -> numpy dtype."""
    if flag not in _DTYPE_MX_TO_NP:
        raise MXNetError("unsupported type flag %d" % flag)
    return _DTYPE_MX_TO_NP[flag]
