"""NDArray: a named handle on a torch tensor, plus the 0x112 file format.

The port's minimal counterpart of ``mxnet_tpu/ndarray.py``: the handle
the executor's ``arg_dict`` holds (``shape``, ``dtype``, ``context``,
``asnumpy``), :func:`array`/:func:`zeros`, and :func:`save`/:func:`load`
byte-compatible with the reference's magic-0x112 params files
(``src/ndarray/ndarray.cc:637-700``, ``mxnet_tpu/ndarray.py:683-771``):
a file saved by either package loads in the other.  Arrays are created
on the CPU unless a ``ctx`` names another device.
"""
from __future__ import annotations

import struct

import numpy as _np
import torch

from .base import MXNetError, dtype_mx_to_torch, dtype_torch_to_mx
from .context import Context

__all__ = ["NDArray", "array", "zeros", "save", "load", "load_raw"]


def _device(ctx):
    if ctx is None:
        return torch.device("cpu")
    if isinstance(ctx, torch.device):
        return ctx
    return Context(ctx).torch_device


class NDArray:
    """An n-dimensional array whose storage is a torch tensor."""

    __slots__ = ("_data",)

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %r"
                             % type(data))
        self._data = data

    @property
    def data(self):
        """The underlying tensor."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The torch dtype of the storage."""
        return self._data.dtype

    @property
    def context(self) -> Context:
        return Context.from_device(self._data.device)

    def asnumpy(self):
        """Blocking copy to host numpy.  numpy has no bfloat16, so a
        bfloat16 array comes back as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __setitem__(self, key, value):
        self._data[key] = _to_tensor(value, self._data.device,
                                     self._data.dtype)

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self.context)


def _to_tensor(source, device, dtype=None):
    if isinstance(source, NDArray):
        source = source.data
    if isinstance(source, torch.Tensor):
        return source.to(device=device, dtype=dtype or source.dtype)
    src = _np.asarray(source)
    if dtype is None and src.dtype == _np.float64:
        dtype = torch.float32            # the reference's default real type
    t = torch.from_numpy(_np.ascontiguousarray(src))
    return t.to(device=device, dtype=dtype or t.dtype)


def array(source, ctx=None, dtype=None):
    """NDArray from a numpy array, tensor or NDArray (float64 becomes
    float32, as in the reference).  A tensor already on the target
    device with the target dtype is wrapped without a copy."""
    return NDArray(_to_tensor(source, _device(ctx), dtype))


def zeros(shape, ctx=None, dtype=torch.float32):
    return NDArray(torch.zeros(tuple(shape), dtype=dtype,
                               device=_device(ctx)))


# ----------------------------------------------------------------------
# save / load (parity: src/ndarray/ndarray.cc:637-700; magic 0x112)
# ----------------------------------------------------------------------
_MAGIC = 0x112
_RESERVED = 0


def _write_str(fo, s):
    b = s.encode("utf-8")
    fo.write(struct.pack("<Q", len(b)))
    fo.write(b)


def _read_str(fi):
    (n,) = struct.unpack("<Q", fi.read(8))
    return fi.read(n).decode("utf-8")


def _raw_bytes(t):
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)          # numpy has no bfloat16
    return t.numpy().tobytes()


def _save_one(fo, arr):
    t = arr.data if isinstance(arr, NDArray) else arr
    ctx = Context.from_device(t.device)
    # TShape: uint32 ndim + uint32 dims (mshadow layout)
    fo.write(struct.pack("<I", t.dim()))
    fo.write(struct.pack("<%dI" % t.dim(), *t.shape))
    # Context: int32 dev_type, int32 dev_id (include/mxnet/base.h:85)
    fo.write(struct.pack("<ii", ctx.device_typeid, ctx.device_id))
    fo.write(struct.pack("<i", dtype_torch_to_mx(t.dtype)))
    fo.write(_raw_bytes(t))


def _load_one(fi):
    (ndim,) = struct.unpack("<I", fi.read(4))
    shape = struct.unpack("<%dI" % ndim, fi.read(4 * ndim)) if ndim else ()
    _dev_type, _dev_id = struct.unpack("<ii", fi.read(8))
    (flag,) = struct.unpack("<i", fi.read(4))
    dtype = dtype_mx_to_torch(flag)
    count = int(_np.prod(shape, dtype=_np.int64)) if shape else 1
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    buf = bytearray(fi.read(nbytes))
    if len(buf) != nbytes:
        raise MXNetError("truncated NDArray file: wanted %d bytes, got %d"
                         % (nbytes, len(buf)))
    t = torch.frombuffer(buf, dtype=dtype) if nbytes else \
        torch.empty(0, dtype=dtype)
    # arrays load onto the CPU: the file's context is where they were
    # saved from, not where the caller wants them
    return NDArray(t.reshape(shape).clone())


def save(fname, data):
    """Save NDArrays or tensors: a str->array dict, a list of arrays,
    or a list of (name, array) pairs, in the caller's order."""
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    names, arrays = [], []
    if isinstance(data, dict):
        for k in data:
            names.append(k)
            arrays.append(data[k])
    elif data and all(isinstance(item, tuple) and len(item) == 2
                      for item in data):
        for k, v in data:
            names.append(k)
            arrays.append(v)
    else:
        arrays = list(data)
    with open(fname, "wb") as fo:
        fo.write(struct.pack("<QQ", _MAGIC, _RESERVED))
        fo.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            _save_one(fo, arr)
        fo.write(struct.pack("<Q", len(names)))
        for name in names:
            _write_str(fo, name)


def load_raw(fname):
    """-> (names, arrays) exactly as stored, file order preserved."""
    with open(fname, "rb") as fi:
        magic, _ = struct.unpack("<QQ", fi.read(16))
        if magic != _MAGIC:
            raise MXNetError("invalid NDArray file %s (bad magic)" % fname)
        (n,) = struct.unpack("<Q", fi.read(8))
        arrays = [_load_one(fi) for _ in range(n)]
        (m,) = struct.unpack("<Q", fi.read(8))
        names = [_read_str(fi) for _ in range(m)]
    return names, arrays


def load(fname):
    """A name->NDArray dict when the file has names, else a list."""
    names, arrays = load_raw(fname)
    if names:
        return dict(zip(names, arrays))
    return arrays
