"""Device contexts mapped onto torch devices.

Mirrors ``include/mxnet/base.h:85-170`` (Context) and the reference's
``python/mxnet/context.py``.  Unlike ``mxnet_tpu/context.py``, where
``gpu()`` aliases the TPU, ``gpu(i)`` here is the i-th CUDA device, as in
the reference MXNet.  ``tpu()`` raises: the port has no TPU.

:func:`resolve` is the one place that turns a caller's ``ctx`` into a
``torch.device``.  ``ctx=None`` means :func:`current_context`, and a
GPU context with no CUDA device raises: an entry point runs on the CPU
only when the caller asks for ``cpu()``, by argument or with a
``with mx.cpu():`` scope.

``with ctx:`` sets the default context of the calling thread, as in the
reference (``python/mxnet/context.py``).  A thread with no scope gets
``gpu(0)``, where the JAX package's default is ``cpu(0)``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "resolve"]

#: per thread: the stack of contexts entered with ``with``
_SCOPE = threading.local()


class Context:
    """Device context: ``Context('gpu', 0)`` or ``cpu()``/``gpu(i)``.

    The type ids match the reference (and the 0x112 file format's
    context field): 1 cpu, 2 gpu, 3 cpu_pinned.
    """

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
            return
        if device_type == "tpu":
            raise MXNetError("the PyTorch port has no TPU context; "
                             "use gpu(i)")
        if device_type not in Context.devstr2type:
            raise MXNetError("unknown device type %s" % device_type)
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The ``torch.device`` of this context (no availability check;
        :func:`resolve` does that)."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    @classmethod
    def from_device(cls, device):
        device = torch.device(device)
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls("cpu", 0)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    # -- `with` scoping (python/mxnet/context.py:40-58) --------------------
    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, ptype, value, trace):
        _stack().pop()


def _stack():
    if not hasattr(_SCOPE, "stack"):
        _SCOPE.stack = []
    return _SCOPE.stack


def current_context() -> Context:
    """The innermost ``with`` context of this thread, else ``gpu(0)``."""
    stack = _stack()
    return stack[-1] if stack else Context("gpu", 0)


def cpu(device_id=0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id=0) -> Context:
    """The ``device_id``-th CUDA device."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    raise MXNetError("the PyTorch port has no TPU context; use gpu(%d)"
                     % device_id)


def resolve(ctx=None):
    """``ctx`` (None, a Context, a device string or a ``torch.device``)
    -> ``torch.device``.

    ``None`` means :func:`current_context` (``gpu(0)`` outside any
    ``with`` scope).  A GPU context raises when CUDA has no such device,
    so an entry point never drops silently to the CPU."""
    if ctx is None:
        ctx = current_context()
    elif isinstance(ctx, torch.device):
        ctx = Context.from_device(ctx)
    elif not isinstance(ctx, Context):
        ctx = Context(ctx)
    if ctx.device_type == "gpu":
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but no CUDA device is available; pass "
                "ctx=cpu() to run on the CPU" % ctx)
        if ctx.device_id >= torch.cuda.device_count():
            raise MXNetError("%s: device_id out of range (%d CUDA devices)"
                             % (ctx, torch.cuda.device_count()))
    return ctx.torch_device
