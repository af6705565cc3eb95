"""Custom Python operators.

The port's counterpart of ``mxnet_tpu/operator.py``: both generations of
the reference's Python-op API,

- ``CustomOp``/``CustomOpProp`` with ``@register`` (reference
  operator.py:394,440,552), put in a graph by
  ``mx.sym.Custom(..., op_type='name')``;
- the legacy ``NumpyOp``/``NDArrayOp`` (reference operator.py:124,224),
  put in a graph by ``op_instance.get_symbol(...)`` as a ``_Native``
  node.

The user's ``forward`` and ``backward`` run on host numpy arrays.  The
bridge is a ``torch.autograd.Function`` (where the JAX package embeds a
``jax.pure_callback`` under ``jax.custom_vjp``): its forward copies the
inputs and aux states to the host, calls the user's ``forward`` and
copies the outputs back to the inputs' device; its backward does the
same around the user's ``backward``.  Every copy back is synchronous
from a private array, so the user may keep and mutate what it was
handed.  As in the JAX package, an output that receives no gradient is
handed to the user's ``backward`` as zeros, the ``forward`` sees
``is_train=True`` whenever the call is differentiated, aux states the
``forward`` mutates are carried out, and aux mutations made in
``backward`` are dropped (only the forward's updates reach the
executor).  The operator of a ``CustomOpProp`` is created once per
device and input shapes and dtypes, and reused by every later call.

:data:`HOST_STATS` counts the calls, the host time and the bytes copied
each way (:func:`host_stats`).
"""
from __future__ import annotations

import inspect
import threading
import time
import weakref

import numpy as np
import torch

from .base import MXNetError
from .context import Context
from .registry import Registry
from .ops.registry import (OperatorProperty, register_op, require_known,
                           IncompleteShape)

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "NumpyOp", "NDArrayOp", "host_stats", "HOST_STATS"]

# registry of user CustomOpProp classes, keyed by op_type
CUSTOM_OP_REGISTRY = Registry("custom_op")


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under ``reg_name``.

    Parity: operator.py:552 ``mx.operator.register``.
    """
    def _wrap(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register(%r): expected a CustomOpProp subclass"
                             % reg_name)
        CUSTOM_OP_REGISTRY.register(reg_name, prop_cls)
        return prop_cls
    return _wrap


def get_all_registered():
    return dict(CUSTOM_OP_REGISTRY.items())


class CustomOp(object):
    """Base class for custom-op *compute*; subclass forward/backward.

    Parity: operator.py:394.  ``in_data``/``out_data`` etc. are numpy
    arrays on the host; write ``out_data``/``in_grad`` with
    ``self.assign`` as in the reference.
    """

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Helper for assigning into dst honoring the OpReqType string."""
        if req == "null":
            return
        elif req in ("write", "inplace"):
            dst[...] = src
        elif req == "add":
            dst[...] += src
        else:
            raise MXNetError("unknown req %r" % req)


class CustomOpProp(object):
    """Metadata/factory for a custom op.  Parity: operator.py:440.

    ``need_top_grad=False`` declares a loss-style op whose backward does not
    consume the head gradient (DeclareBackwardDependency analog).
    """

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        base = in_type[0] if in_type and in_type[0] is not None else np.float32
        return ([base] * len(self.list_arguments()),
                [base] * len(self.list_outputs()),
                [base] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


# ----------------------------------------------------------------------
# The host bridge shared by Custom and _Native
# ----------------------------------------------------------------------
#: calls, seconds and bytes of every host op since the last reset:
#: ``forward_s``/``backward_s`` the whole bridge call (copies included),
#: ``forward_user_s``/``backward_user_s`` the user's own code,
#: ``to_host_bytes``/``to_device_bytes`` what the bridge copied each way
#: (a copy between two CPU arrays counts too)
HOST_STATS = {}
_STATS_LOCK = threading.Lock()
_STAT_KEYS = ("forward_calls", "backward_calls", "forward_s", "backward_s",
              "forward_user_s", "backward_user_s", "to_host_bytes",
              "to_device_bytes")


def host_stats(reset=False):
    """A copy of :data:`HOST_STATS`; ``reset`` zeroes it afterwards."""
    with _STATS_LOCK:
        out = dict(HOST_STATS)
        if reset:
            HOST_STATS.update({k: 0 for k in _STAT_KEYS})
    return out


host_stats(reset=True)


def _count(**kw):
    with _STATS_LOCK:
        for k, v in kw.items():
            HOST_STATS[k] += v


_NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32,
              torch.float64: np.float64, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.int32: np.int32,
              torch.int64: np.int64, torch.bool: np.bool_}


def _np_dtype(t):
    if t.dtype not in _NP_DTYPES:
        raise MXNetError("host op: numpy has no %s (cast the input first)"
                         % t.dtype)
    return np.dtype(_NP_DTYPES[t.dtype])


def _to_host(t):
    """A host numpy copy of ``t`` that the user may keep and mutate."""
    return t.detach().to("cpu", copy=True).numpy()


def _to_device(a, dtype, device):
    """A tensor on ``device`` holding ``a`` in ``dtype``, copied
    synchronously: nothing of it aliases the user's array."""
    t = torch.from_numpy(np.array(a, dtype=dtype, copy=True, order="C"))
    return t if device.type == "cpu" else t.to(device)


class _HostRun(object):
    """One host op at fixed shapes, dtypes and device: ``host_forward
    (train_flag, in_data, aux_data) -> (out_data, aux_data)`` and
    ``host_backward(out_grad, in_data, out_data, aux_data) -> in_grad``
    on numpy arrays, wrapped with the copies to and from ``device``."""

    def __init__(self, host_forward, host_backward, in_dtypes, out_dtypes,
                 device):
        self.host_forward = host_forward
        self.host_backward = host_backward
        self.in_dtypes = in_dtypes
        self.out_dtypes = out_dtypes
        self.device = device

    def forward(self, train_flag, ins, aux):
        t0 = time.perf_counter()
        in_data = [_to_host(x) for x in ins]
        aux_data = [_to_host(a) for a in aux]
        t1 = time.perf_counter()
        out_data, aux_data = self.host_forward(bool(train_flag), in_data,
                                               aux_data)
        t2 = time.perf_counter()
        outs = [_to_device(o, d, self.device)
                for o, d in zip(out_data, self.out_dtypes)]
        aux_out = [_to_device(a, _np_dtype(t), self.device)
                   for a, t in zip(aux_data, aux)]
        _count(forward_calls=1, forward_s=time.perf_counter() - t0,
               forward_user_s=t2 - t1,
               to_host_bytes=sum(a.nbytes for a in in_data + aux_data),
               to_device_bytes=sum(t.numel() * t.element_size()
                                   for t in outs + aux_out))
        return outs, aux_out

    def backward(self, out_grads, ins, outs, aux):
        t0 = time.perf_counter()
        host = [[_to_host(t) for t in group]
                for group in (out_grads, ins, outs, aux)]
        t1 = time.perf_counter()
        in_grad = self.host_backward(*host)
        t2 = time.perf_counter()
        grads = [_to_device(g, d, self.device)
                 for g, d in zip(in_grad, self.in_dtypes)]
        _count(backward_calls=1, backward_s=time.perf_counter() - t0,
               backward_user_s=t2 - t1,
               to_host_bytes=sum(a.nbytes for grp in host for a in grp),
               to_device_bytes=sum(t.numel() * t.element_size()
                                   for t in grads))
        return grads


class _HostOpFn(torch.autograd.Function):
    """The differentiated call of a host op: the user's forward with
    ``is_train=True``; the backward calls the user's backward with the
    inputs, outputs and the aux states as they were before the forward
    (zeros for an output that receives no gradient).  The aux outputs
    carry no gradient; what the user's backward does to aux is
    dropped."""

    @staticmethod
    def forward(ctx, run, n_in, *tensors):
        ins, aux = tensors[:n_in], tensors[n_in:]
        outs, aux_out = run.forward(True, ins, aux)
        ctx.run, ctx.n_in = run, n_in
        # the aux states as they were: the executor writes the forward's
        # updates into the bound arrays in place
        ctx.aux = [a.detach().clone() for a in aux]
        ctx.save_for_backward(*ins, *outs)
        if aux_out:
            ctx.mark_non_differentiable(*aux_out)
        return tuple(outs) + tuple(aux_out)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        out_grads = [torch.zeros_like(o) if g is None else g
                     for g, o in zip(grads[:len(outs)], outs)]
        in_grads = ctx.run.backward(out_grads, ins, outs, ctx.aux)
        in_grads = [g if x.is_floating_point() else None
                    for g, x in zip(in_grads, ins)]
        return (None, None) + tuple(in_grads) + (None,) * len(ctx.aux)


def _run_host_op(run, inputs, aux, is_train):
    """The outputs and aux of a host op call: through :class:`_HostOpFn`
    when autograd records it (the user's forward then sees
    ``is_train=True``), else a plain call with ``is_train``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        flat = _HostOpFn.apply(run, len(inputs), *inputs, *aux)
        n_out = len(flat) - len(aux)
        return list(flat[:n_out]), list(flat[n_out:])
    return run.forward(is_train, inputs, aux)


def _device_of(inputs, aux):
    return next((t.device for t in list(inputs) + list(aux)),
                torch.device("cpu"))


# ----------------------------------------------------------------------
# The 'Custom' graph op: bridges a CustomOpProp into the op registry
# ----------------------------------------------------------------------
@register_op("Custom")
class Custom(OperatorProperty):
    """Custom python op node (parity src/operator/custom-inl.h:30).

    Created as ``mx.sym.Custom(data=..., op_type='myop', **user_kwargs)``.
    All user kwargs are stored as string attrs (the JSON of the node)
    and handed to the registered CustomOpProp constructor; on
    ``load_json`` only the kwargs the constructor accepts are passed.
    """
    param_cls = None
    hint = "custom"
    accepts_any_attrs = True
    host_callback = True

    def __init__(self, **attrs):
        # arbitrary user kwargs: bypass OperatorProperty's field validation
        self.attrs = {k: str(v) for k, v in attrs.items()}
        if "op_type" not in self.attrs:
            raise MXNetError("Custom op requires op_type=")
        self.op_type = self.attrs["op_type"]
        prop_cls = CUSTOM_OP_REGISTRY.get(self.op_type)
        kwargs = {k: v for k, v in self.attrs.items()
                  if k != "op_type" and k not in self._SYSTEM_ATTRS
                  and not (k.startswith("__") and k.endswith("__"))}
        # on load_json every node attr comes through here (user graph attrs
        # included); keep only kwargs the prop constructor actually accepts
        sig = inspect.signature(prop_cls.__init__)
        has_var_kw = any(p.kind == p.VAR_KEYWORD
                         for p in sig.parameters.values())
        if not has_var_kw:
            accepted = {n for n, p in sig.parameters.items()
                        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
            accepted.discard("self")
            kwargs = {k: v for k, v in kwargs.items() if k in accepted}
        self.prop = prop_cls(**kwargs)
        self.param = None
        self._runs = {}     # (device, shapes, dtypes) -> _HostRun

    # -- metadata delegates to the user prop -------------------------------
    def list_arguments(self):
        return list(self.prop.list_arguments())

    def list_outputs(self):
        return list(self.prop.list_outputs())

    def list_auxiliary_states(self):
        return list(self.prop.list_auxiliary_states())

    def infer_shape(self, in_shapes):
        # only data (first input) must be known: user props conventionally
        # derive the rest (e.g. label = [data[0]]), and the symbol's
        # fixpoint loop backfills what we return
        if in_shapes[0] is None:
            require_known("Custom(%s)" % self.op_type, in_shapes[:1],
                          self.list_arguments()[:1])
        try:
            res = self.prop.infer_shape(
                [list(s) if s is not None else None for s in in_shapes])
        except (TypeError, IndexError, AttributeError):
            # prop needs shapes we don't have yet
            raise IncompleteShape(
                "Custom(%s): not enough input shapes" % self.op_type)
        if len(res) == 2:
            ins, outs = res
            aux = []
        else:
            ins, outs, aux = res
        to_t = lambda ss: [tuple(int(d) for d in s) for s in ss]
        return to_t(ins), to_t(outs), to_t(aux)

    def infer_type(self, in_types):
        # the user's prop sees numpy dtypes, as its arrays are numpy
        res = self.prop.infer_type(
            [np.dtype(_NP_DTYPES[t]) if isinstance(t, torch.dtype)
             and t in _NP_DTYPES else t for t in in_types])
        if len(res) == 2:
            ins, outs = res
            aux = [np.float32] * len(self.list_auxiliary_states())
        else:
            ins, outs, aux = res
        return list(ins), list(outs), list(aux)

    # -- compute: the host bridge ------------------------------------------
    def _run(self, inputs, aux):
        device = _device_of(inputs, aux)
        in_shapes = [tuple(int(d) for d in x.shape) for x in inputs]
        in_dtypes = [_np_dtype(x) for x in inputs]
        key = (str(device), tuple(in_shapes), tuple(in_dtypes))
        run = self._runs.get(key)
        if run is not None:
            return run
        res = self.prop.infer_shape([list(s) for s in in_shapes])
        out_shapes = [tuple(int(d) for d in s) for s in res[1]]
        tres = self.prop.infer_type(list(in_dtypes))
        out_dtypes = [np.dtype(t) for t in tres[1]]
        op = self.prop.create_operator(Context.from_device(device),
                                       in_shapes, in_dtypes)
        n_out, n_in = len(out_shapes), len(inputs)

        def host_forward(train_flag, in_data, aux_data):
            out_data = [np.zeros(s, d) for s, d in zip(out_shapes, out_dtypes)]
            op.forward(is_train=train_flag, req=["write"] * n_out,
                       in_data=in_data, out_data=out_data, aux=aux_data)
            return out_data, aux_data

        def host_backward(out_grad, in_data, out_data, aux_data):
            in_grad = [np.zeros(s, d) for s, d in zip(in_shapes, in_dtypes)]
            op.backward(req=["write"] * n_in, out_grad=out_grad,
                        in_data=in_data, out_data=out_data,
                        in_grad=in_grad, aux=aux_data)
            return in_grad

        run = _HostRun(host_forward, host_backward, in_dtypes, out_dtypes,
                       device)
        return self._runs.setdefault(key, run)

    def forward(self, inputs, aux, is_train, rng):
        outs, aux_out = _run_host_op(self._run(inputs, aux), inputs, aux,
                                     is_train)
        return outs, (aux_out if aux else None)


# ----------------------------------------------------------------------
# Legacy NumpyOp / NDArrayOp (operator.py:124,224) via a _Native node
# ----------------------------------------------------------------------
# The reference smuggles C function pointers through symbol attrs
# (non-portable across processes); this is the moral equivalent with an
# in-process token table.  Values are weak: the _Native node created by
# get_symbol holds the strong reference, so ops die with their graphs
# instead of accumulating for process lifetime.
_LEGACY_OPS = weakref.WeakValueDictionary()
_LEGACY_NEXT = [0]


class PythonOp(object):
    """Shared base for NumpyOp/NDArrayOp (parity operator.py:26)."""

    def __init__(self, need_top_grad=True):
        self.info_ = None
        self.need_top_grad_ = bool(need_top_grad)

    # metadata — same contract as CustomOpProp
    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def get_symbol(self, *args, **kwargs):
        """Create a Symbol running this op (parity operator.py:81)."""
        from . import symbol as _sym
        token = "_legacy_op_%d" % _LEGACY_NEXT[0]
        _LEGACY_NEXT[0] += 1
        _LEGACY_OPS[token] = self
        return _sym._create("_Native", *args, info=token, **kwargs)


class NumpyOp(PythonOp):
    """Legacy numpy custom op (parity operator.py:124, native_op-inl.h)."""


class NDArrayOp(PythonOp):
    """Legacy NDArray custom op (parity operator.py:224, ndarray_op-inl.h).

    As in the JAX package, both legacy flavors execute on host numpy
    buffers.
    """


@register_op("_Native", aliases=("_NDArray",))
class _Native(OperatorProperty):
    """Graph node for legacy PythonOp instances (native_op-inl.h)."""
    param_cls = None
    hint = "native"
    accepts_any_attrs = True
    host_callback = True

    def __init__(self, **attrs):
        self.attrs = {k: str(v) for k, v in attrs.items()}
        token = self.attrs.get("info")
        if token not in _LEGACY_OPS:
            raise MXNetError("_Native: unknown or out-of-process op token %r "
                             "(legacy python ops are not serializable, like "
                             "the reference's pointer attrs)" % token)
        self.pyop = _LEGACY_OPS[token]
        self.param = None
        self._runs = {}

    def list_arguments(self):
        return list(self.pyop.list_arguments())

    def list_outputs(self):
        return list(self.pyop.list_outputs())

    def infer_shape(self, in_shapes):
        if in_shapes[0] is None:
            require_known("_Native", in_shapes[:1],
                          self.list_arguments()[:1])
        try:
            ins, outs = self.pyop.infer_shape(
                [list(s) if s is not None else None for s in in_shapes])
        except (TypeError, IndexError, AttributeError):
            raise IncompleteShape("_Native: not enough input shapes")
        to_t = lambda ss: [tuple(int(d) for d in s) for s in ss]
        return to_t(ins), to_t(outs), []

    def _run(self, inputs):
        device = _device_of(inputs, ())
        in_shapes = [tuple(int(d) for d in x.shape) for x in inputs]
        dtype = _np_dtype(inputs[0]) if inputs else np.dtype(np.float32)
        key = (str(device), tuple(in_shapes), dtype)
        run = self._runs.get(key)
        if run is not None:
            return run
        pyop = self.pyop
        _, out_shapes = pyop.infer_shape([list(s) for s in in_shapes])
        out_shapes = [tuple(int(d) for d in s) for s in out_shapes]

        def host_forward(train_flag, in_data, aux_data):
            out_data = [np.zeros(s, dtype) for s in out_shapes]
            pyop.forward(in_data=in_data, out_data=out_data)
            return out_data, aux_data

        def host_backward(out_grad, in_data, out_data, aux_data):
            in_grad = [np.zeros(s, dtype) for s in in_shapes]
            pyop.backward(out_grad=out_grad, in_data=in_data,
                          out_data=out_data, in_grad=in_grad)
            return in_grad

        run = _HostRun(host_forward, host_backward, [dtype] * len(inputs),
                       [dtype] * len(out_shapes), device)
        return self._runs.setdefault(key, run)

    def forward(self, inputs, aux, is_train, rng):
        outs, _ = _run_host_op(self._run(inputs), inputs, aux, is_train)
        return outs, None
