"""NDArray: the imperative n-d array on a torch tensor, and the 0x112 file
format.

The port of ``mxnet_tpu/ndarray.py`` (the reference's
``include/mxnet/ndarray.h``, ``src/ndarray/ndarray.cc`` and
``python/mxnet/ndarray.py``):

- Storage is one torch tensor.  PyTorch queues work on the device's
  stream, so, as with XLA's async dispatch in the JAX package, a call
  returns before the device is done; ``wait_to_read`` and
  :func:`waitall` synchronise.
- Views alias.  ``a[i]``, ``a[i:j]``, ``slice``, ``at`` and ``reshape``
  return arrays whose tensor is a torch view of the parent's storage,
  where the JAX package re-resolves a getter/setter pair against its
  immutable parent.  That holds only while no array rebinds its tensor,
  so every write goes in place (``copy_`` into the tensor or a view of
  it): ``__setitem__``, :meth:`NDArray._set_data`, ``+=`` and the other
  in-place operators, ``out=`` and ``copyto`` into an array.
- Every registered function returns a new array with storage of its
  own (a contiguous copy), as in the JAX package.
- Arrays are created on :func:`~.context.current_context` unless a
  ``ctx`` names another device: ``gpu(0)`` outside any ``with`` scope,
  which raises where CUDA has no device (``with mx.cpu():`` asks for the
  CPU).  :func:`load` follows the same rule.
- :func:`save`/:func:`load` are byte-compatible with the reference's
  magic-0x112 params files (``src/ndarray/ndarray.cc:637-700``,
  ``mxnet_tpu/ndarray.py:683-771``): a file saved by either package
  loads in the other.

``imdecode`` needs the native image decoder and comes with the IO slice.
"""
from __future__ import annotations

import math
import numbers
import operator
import struct

import numpy as _np
import torch

from .base import MXNetError, dtype_mx_to_torch, dtype_torch_to_mx
from .context import Context, current_context, resolve

__all__ = [
    "NDArray", "empty", "zeros", "ones", "full", "array", "arange",
    "concatenate", "waitall", "save", "load", "load_raw",
    "sqrt", "rsqrt", "exp", "log", "cos", "sin", "abs", "sign", "round",
    "ceil", "floor", "square", "negative", "dot", "batch_dot", "clip",
    "add", "subtract", "multiply", "divide", "true_divide", "power",
    "maximum", "minimum", "sum", "max", "min", "argmax", "argmax_channel",
    "norm", "transpose", "swapaxes", "expand_dims", "flip", "crop",
    "slice_axis", "broadcast_to", "broadcast_axis", "smooth_l1",
    "softmax_cross_entropy", "onehot_encode", "choose_element_0index",
    "fill_element_0index", "elementwise_sum", "add_n",
]

#: the reference's default real type (``mx_real_t``)
mx_real_t = torch.float32


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if "bfloat16" in str(dtype):         # numpy has no bfloat16 of its own
        return torch.bfloat16
    return torch.from_numpy(_np.empty(0, _np.dtype(dtype))).dtype


def _as_context(ctx, device):
    if ctx is None or isinstance(ctx, torch.device):
        return Context.from_device(device)
    return Context(ctx)


def _place(ctx):
    """``ctx`` (None: the current context) -> (Context, torch.device)."""
    if ctx is None:
        ctx = current_context()
    device = resolve(ctx)
    return _as_context(ctx, device), device


class NDArray:
    """An n-dimensional array whose storage is a torch tensor.

    ``NDArray(tensor)`` wraps ``tensor`` without a copy; with ``ctx`` the
    tensor is first moved to that context's device.
    """

    __slots__ = ("_data", "_ctx", "_writable")

    def __init__(self, data, ctx=None, writable=True):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %r"
                             % type(data))
        if ctx is not None:
            data = data.to(resolve(ctx))
        self._data = data
        self._ctx = _as_context(ctx, data.device)
        self._writable = bool(writable)

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------
    @property
    def data(self):
        """The underlying tensor (a view of the parent's for a view)."""
        return self._data

    def _set_data(self, value):
        """Write ``value`` into this array in place, in the array's dtype,
        broadcast to its shape; a view writes through to its parent."""
        if not self._writable:
            raise MXNetError("trying to write to a read-only NDArray")
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device)
            if (value.untyped_storage().data_ptr()
                    == self._data.untyped_storage().data_ptr()):
                value = value.clone()    # overlapping source and target
            self._data.copy_(value)
        elif isinstance(value, numbers.Number):
            self._data.fill_(value)
        else:
            self._data.copy_(_to_tensor(value, self._data.device,
                                        self._data.dtype))

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        """The torch dtype of the storage."""
        return self._data.dtype

    @property
    def context(self) -> Context:
        return self._ctx

    @property
    def writable(self):
        return self._writable

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self._ctx)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # ------------------------------------------------------------------
    # sync points (WaitToRead/WaitToWrite, include/mxnet/ndarray.h:108-124)
    # ------------------------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # ------------------------------------------------------------------
    # host interop
    # ------------------------------------------------------------------
    def asnumpy(self):
        """Blocking copy to host numpy.  numpy has no bfloat16, so a
        bfloat16 array comes back as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("the array is not a scalar (shape %s)"
                             % (self.shape,))
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        return NDArray(self._data.to(_torch_dtype(dtype), copy=True),
                       ctx=self._ctx)

    # ------------------------------------------------------------------
    # copies between arrays and contexts (CopyFromTo, ndarray.cc:286)
    # ------------------------------------------------------------------
    def copyto(self, other):
        if isinstance(other, NDArray):
            if other is not self:
                other._set_data(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(resolve(other), copy=True),
                           ctx=other)
        raise MXNetError("copyto does not support type %s" % type(other))

    def copy(self):
        return self.copyto(self._ctx)

    def as_in_context(self, context):
        if self._ctx == context:
            return self
        return self.copyto(context)

    # ------------------------------------------------------------------
    # views (zero-copy, include/mxnet/ndarray.h:241-275)
    # ------------------------------------------------------------------
    def _view(self, tensor):
        view = NDArray.__new__(NDArray)
        view._data, view._ctx, view._writable = tensor, self._ctx, \
            self._writable
        return view

    def slice(self, start, stop):
        return self._view(self._data[int(start):int(stop)])

    def at(self, idx):
        return self._view(self._data[int(idx)])

    def reshape(self, shape):
        shape = _as_shape(shape)
        if -1 in shape:
            known = math.prod(s for s in shape if s != -1)
            shape = tuple(self.size // known if s == -1 else s
                          for s in shape)
        if math.prod(shape) != self.size:
            raise MXNetError("reshape size mismatch %s -> %s"
                             % (self.shape, shape))
        try:
            return self._view(self._data.view(shape))
        except RuntimeError as err:
            raise MXNetError("reshape %s -> %s cannot be a view of this "
                             "array's storage (%s); copy it first"
                             % (self.shape, shape, err)) from None

    @property
    def T(self):
        return transpose(self)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, (int, _np.integer)):
            return self.at(key)
        if isinstance(key, slice):
            if key.step is not None and key.step != 1:
                raise MXNetError("slice step not supported")
            start = key.start if key.start is not None else 0
            stop = key.stop if key.stop is not None else self.shape[0]
            return self.slice(start, stop)
        raise MXNetError("NDArray only supports int and contiguous slice "
                         "indexing; use .asnumpy() for fancy indexing")

    def __setitem__(self, key, value):
        if not self._writable:
            raise MXNetError("trying to write to a read-only NDArray")
        if isinstance(key, slice) and key.start is None and key.stop is None:
            self._set_data(value)
        else:
            self[key]._set_data(value)

    # ------------------------------------------------------------------
    # arithmetic (imperative path; parity src/ndarray/ndarray.cc:96-225)
    # ------------------------------------------------------------------
    def _binary(self, other, fn, reverse=False):
        rhs = other._data if isinstance(other, NDArray) else other
        lhs = self._data
        if reverse:
            lhs, rhs = rhs, lhs
        return NDArray(fn(lhs, rhs), ctx=self._ctx)

    def __add__(self, other):
        return self._binary(other, operator.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, operator.sub)

    def __rsub__(self, other):
        return self._binary(other, operator.sub, reverse=True)

    def __mul__(self, other):
        return self._binary(other, operator.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, operator.truediv)

    def __rtruediv__(self, other):
        # torch's scalar / tensor multiplies by the reciprocal: divide
        return self._binary(other, torch.div, reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return self._binary(other, operator.pow)

    def __rpow__(self, other):
        return self._binary(other, operator.pow, reverse=True)

    def __neg__(self):
        return NDArray(-self._data, ctx=self._ctx)

    # comparisons give 0/1 in the left operand's dtype, not bool
    def _compare(self, other, fn):
        return self._binary(other, lambda a, b: fn(a, b).to(a.dtype))

    def __eq__(self, other):
        return self._compare(other, operator.eq)

    def __ne__(self, other):
        return self._compare(other, operator.ne)

    def __gt__(self, other):
        return self._compare(other, operator.gt)

    def __ge__(self, other):
        return self._compare(other, operator.ge)

    def __lt__(self, other):
        return self._compare(other, operator.lt)

    def __le__(self, other):
        return self._compare(other, operator.le)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise MXNetError("NDArray truth value is ambiguous; use .asscalar()")

    # in place: the result is written into this array's storage
    def _inplace(self, other, fn):
        rhs = other._data if isinstance(other, NDArray) else other
        self._set_data(fn(self._data, rhs))
        return self

    def __iadd__(self, other):
        return self._inplace(other, operator.add)

    def __isub__(self, other):
        return self._inplace(other, operator.sub)

    def __imul__(self, other):
        return self._inplace(other, operator.mul)

    def __itruediv__(self, other):
        return self._inplace(other, operator.truediv)

    __idiv__ = __itruediv__


def _to_tensor(source, device, dtype=None):
    """A new tensor on ``device`` from numpy data, a list or a scalar
    (float64 becomes float32 unless ``dtype`` says otherwise)."""
    src = _np.asarray(source)
    if "bfloat16" in str(src.dtype):
        src, dtype = src.astype(_np.float32), dtype or torch.bfloat16
    if dtype is None and src.dtype == _np.float64:
        dtype = mx_real_t
    t = torch.from_numpy(_np.array(src, order="C", copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _as_shape(shape):
    if isinstance(shape, (int, _np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


# ----------------------------------------------------------------------
# creation functions (python/mxnet/ndarray.py zeros/ones/array/... parity)
# ----------------------------------------------------------------------
def _create(fn, shape, ctx, dtype, *args):
    ctx, device = _place(ctx)
    return NDArray(fn(_as_shape(shape), *args, dtype=_torch_dtype(dtype),
                      device=device), ctx=ctx)


def empty(shape, ctx=None, dtype=mx_real_t):
    return _create(torch.empty, shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=mx_real_t):
    return _create(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=mx_real_t):
    return _create(torch.ones, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=mx_real_t):
    return _create(torch.full, shape, ctx, dtype, val)


def array(source, ctx=None, dtype=None):
    """NDArray from a numpy array, list, NDArray or tensor (float64 numpy
    data becomes float32, as in the reference).  numpy data and NDArrays
    are copied; a contiguous tensor already on the target device with
    the target dtype is wrapped without a copy."""
    ctx, device = _place(ctx)
    dtype = _torch_dtype(dtype)
    if isinstance(source, NDArray):
        t = source._data.to(device=device, dtype=dtype or source.dtype,
                            copy=True)
    elif isinstance(source, torch.Tensor):
        t = source.to(device=device, dtype=dtype or source.dtype)
        t = t.contiguous()
    else:
        t = _to_tensor(source, device, dtype)
    return NDArray(t, ctx=ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=mx_real_t):
    if stop is None:
        start, stop = 0, start
    ctx, device = _place(ctx)
    t = torch.arange(start, stop, step, dtype=_torch_dtype(dtype),
                     device=device)
    if repeat != 1:
        t = t.repeat_interleave(int(repeat))
    return NDArray(t, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    if not always_copy and len(arrays) == 1:
        return arrays[0]
    return NDArray(torch.cat([a.data for a in arrays], dim=axis),
                   ctx=arrays[0].context)


def waitall():
    """Block until the work queued on every CUDA device this process has
    used is done (Engine::WaitForAll parity)."""
    if not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        if torch._C._cuda_hasPrimaryContext(i):     # used by this process
            torch.cuda.synchronize(i)


# ----------------------------------------------------------------------
# registered functions (parity: src/ndarray/ndarray.cc:783-944 table)
# ----------------------------------------------------------------------
def _result(res, out, like):
    if out is not None:
        out._set_data(res)
        return out
    return NDArray(res, ctx=like.context)


def _fresh(t):
    """A contiguous copy: results never alias their inputs."""
    return t.clone(memory_format=torch.contiguous_format)


def _unary(fn):
    def wrapped(data, out=None):
        return _result(fn(data.data), out, data)
    return wrapped


sqrt = _unary(torch.sqrt)
rsqrt = _unary(lambda x: 1.0 / torch.sqrt(x))
exp = _unary(torch.exp)
log = _unary(torch.log)
cos = _unary(torch.cos)
sin = _unary(torch.sin)
abs = _unary(torch.abs)  # noqa: A001 - parity with mx.nd.abs
sign = _unary(torch.sign)
round = _unary(torch.round)  # noqa: A001 - half to even, as jnp.round
ceil = _unary(torch.ceil)
floor = _unary(torch.floor)
square = _unary(torch.square)
negative = _unary(torch.negative)


def dot(lhs, rhs, out=None):
    """``jnp.dot``: the last axis of ``lhs`` against the second-to-last
    of ``rhs`` (the only one of a vector)."""
    a, b = lhs.data, rhs.data
    if a.dim() == 0 or b.dim() == 0:
        res = a * b
    else:
        res = torch.tensordot(a, b, dims=([a.dim() - 1],
                                          [b.dim() - 2 if b.dim() > 1
                                           else 0]))
    return _result(res, out, lhs)


def batch_dot(lhs, rhs, out=None):
    return _result(torch.matmul(lhs.data, rhs.data), out, lhs)


def clip(data, a_min, a_max, out=None):
    return _result(torch.clamp(data.data, a_min, a_max), out, data)


def add(lhs, rhs):
    """Elementwise sum, either operand NDArray or scalar (reference
    ndarray.py add)."""
    return lhs + rhs if isinstance(lhs, NDArray) else rhs + lhs


def subtract(lhs, rhs):
    if isinstance(lhs, NDArray):
        return lhs - rhs
    return rhs.__rsub__(lhs)


def multiply(lhs, rhs):
    return lhs * rhs if isinstance(lhs, NDArray) else rhs * lhs


def divide(lhs, rhs):
    if isinstance(lhs, NDArray):
        return lhs / rhs
    return rhs.__rtruediv__(lhs)


true_divide = divide


def power(lhs, rhs):
    if isinstance(lhs, NDArray):
        return lhs ** rhs
    return rhs.__rpow__(lhs)


def _pair(lhs, rhs, fn):
    like = lhs if isinstance(lhs, NDArray) else rhs
    l, r = (x.data if isinstance(x, NDArray)
            else torch.as_tensor(x, device=like.data.device)
            for x in (lhs, rhs))
    return NDArray(fn(l, r), ctx=like.context)


def maximum(lhs, rhs):
    return _pair(lhs, rhs, torch.maximum)


def minimum(lhs, rhs):
    return _pair(lhs, rhs, torch.minimum)


def _dims(axis):
    return () if axis is None else axis


def sum(data, axis=None, keepdims=False):  # noqa: A001
    return NDArray(torch.sum(data.data, dim=_dims(axis), keepdim=keepdims),
                   ctx=data.context)


def max(data, axis=None, keepdims=False):  # noqa: A001
    return NDArray(torch.amax(data.data, dim=_dims(axis), keepdim=keepdims),
                   ctx=data.context)


def min(data, axis=None, keepdims=False):  # noqa: A001
    return NDArray(torch.amin(data.data, dim=_dims(axis), keepdim=keepdims),
                   ctx=data.context)


def argmax(data, axis=None, keepdims=False):
    """Index of the largest element (first on ties), in ``data``'s dtype."""
    t = data.data
    res = torch.argmax(t, dim=axis)
    if keepdims:
        res = res.reshape([1] * t.dim()) if axis is None \
            else res.unsqueeze(axis)
    return NDArray(res.to(t.dtype), ctx=data.context)


def argmax_channel(data):
    """argmax over axis 1 (channel), parity with the reference simple op."""
    return argmax(data, axis=1)


def norm(data):
    return NDArray(torch.sqrt(torch.sum(torch.square(data.data))),
                   ctx=data.context)


def transpose(data, axes=None):
    t = data.data
    axes = tuple(reversed(range(t.dim()))) if axes is None else axes
    return NDArray(_fresh(t.permute(*axes)), ctx=data.context)


def swapaxes(data, dim1, dim2):
    return NDArray(_fresh(torch.swapaxes(data.data, dim1, dim2)),
                   ctx=data.context)


def expand_dims(data, axis):
    return NDArray(_fresh(data.data.unsqueeze(axis)), ctx=data.context)


def flip(data, axis):
    return NDArray(torch.flip(data.data, (axis,)), ctx=data.context)


def crop(data, begin, end):
    idx = tuple(slice(b, e) for b, e in zip(begin, end))
    return NDArray(_fresh(data.data[idx]), ctx=data.context)


def slice_axis(data, axis, begin, end):
    idx = [slice(None)] * data.ndim
    if end is None or end == 0:
        end = data.shape[axis]
    idx[axis] = slice(begin, end)
    return NDArray(_fresh(data.data[tuple(idx)]), ctx=data.context)


def broadcast_to(data, shape):
    return NDArray(_fresh(data.data.expand(_as_shape(shape))),
                   ctx=data.context)


def broadcast_axis(data, axis, size):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    sizes = size if isinstance(size, (list, tuple)) else (size,)
    shape = list(data.shape)
    for ax, s in zip(axes, sizes):
        shape[ax] = s
    return broadcast_to(data, shape)


def smooth_l1(data, scalar=1.0):
    """Huber-ish loss used by Faster R-CNN (src/operator/smooth_l1_unary*)."""
    sigma2 = scalar * scalar
    x = data.data
    res = torch.where(torch.abs(x) < 1.0 / sigma2,
                      0.5 * sigma2 * torch.square(x),
                      torch.abs(x) - 0.5 / sigma2)
    return NDArray(res, ctx=data.context)


def softmax_cross_entropy(data, label):
    """Simple op ``softmax_cross_entropy`` (scalar output)."""
    logp = torch.log_softmax(data.data, dim=-1)
    lab = label.data.to(torch.int64)
    nll = -torch.gather(logp, -1, lab[:, None])
    return NDArray(torch.sum(nll), ctx=data.context)


def onehot_encode(indices, out):
    """_onehot_encode (ndarray.cc:795): out[i, indices[i]] = 1; an index
    outside ``[0, depth)`` gives a row of zeros, as ``jax.nn.one_hot``."""
    idx = indices.data.to(torch.int64)
    depth = out.shape[1]
    res = idx[..., None] == torch.arange(depth, device=idx.device)
    out._set_data(res.to(out.dtype))
    return out


def choose_element_0index(lhs, rhs, out=None):
    """out[i] = lhs[i, rhs[i]] (ndarray.cc registered fn)."""
    idx = rhs.data.to(torch.int64)
    return _result(torch.gather(lhs.data, 1, idx[:, None])[:, 0], out, lhs)


def fill_element_0index(lhs, mhs, rhs, out=None):
    """out = lhs with out[i, rhs[i]] = mhs[i] (three-operand fill)."""
    res = lhs.data.clone()
    rows = torch.arange(res.shape[0], device=res.device)
    res[rows, rhs.data.to(torch.int64)] = mhs.data.to(res.dtype)
    return _result(res, out, lhs)


def elementwise_sum(arrays, out=None):
    """ElementwiseSum (src/ndarray/ndarray.cc:352)."""
    res = arrays[0].data
    for a in arrays[1:]:
        res = res + a.data
    return _result(res, out, arrays[0])


add_n = elementwise_sum


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


def _load_one(fi, ctx, device):
    (ndim,) = struct.unpack("<I", fi.read(4))
    shape = struct.unpack("<%dI" % ndim, fi.read(4 * ndim)) if ndim else ()
    _dev_type, _dev_id = struct.unpack("<ii", fi.read(8))
    (flag,) = struct.unpack("<i", fi.read(4))
    dtype = dtype_mx_to_torch(flag)
    count = math.prod(shape)
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    buf = bytearray(fi.read(nbytes))
    if len(buf) != nbytes:
        raise MXNetError("truncated NDArray file: wanted %d bytes, got %d"
                         % (nbytes, len(buf)))
    t = torch.frombuffer(buf, dtype=dtype) if nbytes else \
        torch.empty(0, dtype=dtype)
    # the file's context is where the array was saved from, not where the
    # caller wants it: arrays load onto the current context
    return NDArray(t.reshape(shape).to(device, copy=True), ctx=ctx)


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
    """-> (names, arrays) exactly as stored, file order preserved; the
    arrays land on the current context."""
    ctx, device = _place(None)
    with open(fname, "rb") as fi:
        magic, _ = struct.unpack("<QQ", fi.read(16))
        if magic != _MAGIC:
            raise MXNetError("invalid NDArray file %s (bad magic)" % fname)
        (n,) = struct.unpack("<Q", fi.read(8))
        arrays = [_load_one(fi, ctx, device) for _ in range(n)]
        (m,) = struct.unpack("<Q", fi.read(8))
        names = [_read_str(fi) for _ in range(m)]
    return names, arrays


def load(fname):
    """A name->NDArray dict when the file has names, else a list."""
    names, arrays = load_raw(fname)
    if names:
        return dict(zip(names, arrays))
    return arrays
