"""Base error type and the saved-file dtype codes.

The port's counterpart of ``mxnet_tpu/base.py``: the error class and the
mshadow-compatible type flags of the 0x112 NDArray file format, mapped
onto torch dtypes (0=float32, 1=float64, 2=float16, 3=uint8, 4=int32,
5=bfloat16, 6=int64, 7=bool — the JAX package's numbering, so a file
saved by either package loads in the other).
"""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "dtype_torch_to_mx", "dtype_mx_to_torch",
           "collective_seam"]


class MXNetError(Exception):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


def collective_seam(fn=None, **_meta):
    """Runtime no-op marker: this function implements a cluster-wide
    rendezvous or agreement protocol (every rank reaches it together and
    its result is identical on every rank).  The JAX package's
    distributed lint reads the same decorator from its sources; in the
    port it documents the seam and changes nothing."""
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
