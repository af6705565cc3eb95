"""Generated sweep bodies: an optimizer's own elementwise ``update_fn``
traced into a small IR, lowered to CUDA C and compiled by NVRTC.

The JAX sweep (``mxnet_tpu/kernels/fused_opt.py:_sweep_kernel``) traces
whatever ``update_fn`` an elementwise optimizer has into its Pallas
program, a user's subclass included.  CUDA cannot trace Python, so the
hand-written sweep (``csrc/fused_opt.cu``) has one body per optimizer of
the package; this module covers the rest:

1. :func:`program` calls ``_preprocess_grad`` (when asked) and
   ``update_fn`` on symbolic values (:class:`_Vec` for the weight, the
   gradient and each state vector; :class:`_Host` for ``lr``, ``wd`` and
   ``t``) and records every operation into a :class:`Program`.  The IR
   covers ``+ - * /``, ``neg``, ``abs``, ``sign``, ``sqrt``, ``rsqrt``,
   ``exp``, ``log``, ``reciprocal``, ``square``, ``pow``, ``clamp``,
   ``maximum``/``minimum``, ``where``, the comparisons, the logical ops,
   ``zeros_like``/``ones_like``/``full_like`` and ``torch.as_tensor`` of
   ``lr``/``wd``/``t`` as float32.  Anything else -- a norm, a reduction,
   a random draw, a tensor the formula did not get as an argument, Python
   control flow on a tensor's value -- raises :class:`MXNetError` naming
   it.
2. Arithmetic on ``lr``, ``wd``, ``t`` and Python numbers alone stays on
   the host in Python, as the plain formula computes it; where such a
   value meets a tensor it becomes a kernel argument, rounded to float32
   as PyTorch rounds a Python scalar (:func:`launch_arguments`).  The
   optimizer's own float attributes become float32 hexadecimal literals,
   so no decimal round trip changes them.
3. :func:`cuda_source` lowers the IR to CUDA C in the layout of the hand
   bodies: a grid-stride loop of 16-byte vectors where every buffer is
   16-byte aligned (the tail of ``n % 4`` elements done by the first
   threads of block 0), else single floats.  Every sum, difference,
   product, quotient and square root is written with its
   round-to-nearest intrinsic, in the formula's order, and the source is
   compiled with ``--fmad=false``: no product and sum are contracted into
   one fused multiply-add (such a contraction puts an ``a*x + y`` up to
   512 ulps off a cancelled result).  Each operation is lowered as
   PyTorch's CUDA kernel computes it: a tensor divided by a Python scalar
   is multiplied by the scalar's float32 reciprocal, ``pow`` by 2, 3,
   0.5, -0.5, -1 and -2 takes PyTorch's special forms, ``clamp``,
   ``maximum`` and ``minimum`` keep NaN, ``sign`` of NaN is 0.
4. The kernels take the same nullable skip flag as the hand bodies: where
   ``ok`` reads 0 every thread returns before it writes.

:func:`evaluate` runs the IR op by op with the PyTorch operators the
formula called: on the CPU it must equal the plain ``update_fn``
bitwise, which tests the translation where the CUDA text cannot run.
"""
from __future__ import annotations

import contextlib
import ctypes
import struct
import threading
import time

import numpy as _np
import torch

from ..base import MXNetError
from .fused_opt import _defining_class, _n_state, _state_leaves, _state_like

__all__ = ["Program", "program", "evaluate", "cuda_source",
           "launch_arguments", "launch", "compile_seconds", "cache_key"]


# ----------------------------------------------------------------------
# the IR
# ----------------------------------------------------------------------
class Program(object):
    """One traced update.

    ``nodes``: ``(op, args, kind)`` in order, ``kind`` ``"f"`` (float32)
    or ``"b"`` (bool).  An argument is ``("n", i)`` (node ``i``),
    ``("c", value)`` (a Python number: a CPU scalar to PyTorch) or
    ``("h", j)`` (host value ``j``, a CPU scalar computed from ``lr``,
    ``wd`` and ``t``).  Nodes 0 and 1 are the weight and the gradient,
    nodes 2.. the state vectors.  ``host``: ``(op, args)`` over
    ``("lr",)``, ``("wd",)``, ``("t",)`` and host arguments of the same
    form.  ``outputs``: the node of the new weight, then of each new
    state.  ``uniform[i]``: node ``i`` is the same for every element."""

    def __init__(self, name, n_state, preprocess):
        self.name = name
        self.n_state = n_state
        self.preprocess = preprocess
        self.nodes = []
        self.host = []
        self.outputs = []
        self.uniform = []
        #: the compiled source, after the first launch (:func:`_built`)
        self.built = None

    def add(self, op, args, kind="f"):
        args = tuple(args)
        uni = op in ("fill", "hostf") or (
            op not in ("input",)
            and all(a[0] != "n" or self.uniform[a[1]] for a in args))
        self.nodes.append((op, args, kind))
        self.uniform.append(uni)
        return len(self.nodes) - 1

    def add_host(self, op, args=()):
        self.host.append((op, tuple(args)))
        return len(self.host) - 1

    def params(self):
        """The host values the kernel takes as float32 arguments, in
        order (every host value an op reads)."""
        used = []
        for op, args, _k in self.nodes:
            for a in args:
                if a[0] == "h" and a[1] not in used:
                    used.append(a[1])
        return used

    def ops(self):
        return sorted({op for op, _a, _k in self.nodes if op != "input"})


def _outside(what):
    return MXNetError(
        "the generated sweep body takes elementwise formulas only: %s is "
        "outside its IR (a norm, a reduction, a random draw, a tensor the "
        "update was not given, or Python control flow on a tensor's value "
        "cannot be swept elementwise); use MXTPU_FUSED_OPT='1' or '' for "
        "this optimizer" % what)


def _fname(func):
    mod = getattr(func, "__module__", None) or ""
    name = getattr(func, "__name__", None) or repr(func)
    owner = getattr(func, "__objclass__", None)
    if owner is not None:
        return "Tensor.%s" % name
    return "%s.%s" % ("torch" if mod.startswith("torch") else mod, name) \
        if mod else "torch.%s" % name


class _Host(object):
    """A Python scalar computed from ``lr``, ``wd`` and ``t``."""

    __slots__ = ("_p", "_i")

    def __init__(self, prog, i):
        self._p, self._i = prog, i

    def _arg(self, o):
        if isinstance(o, _Host):
            return ("h", o._i)
        if isinstance(o, (bool, int, float)):
            return ("c", o)
        return None

    def _op(self, op, a, b):
        if b is None:
            return NotImplemented
        return _Host(self._p, self._p.add_host(op, (a, b)))

    def __add__(self, o):
        return self._op("add", ("h", self._i), self._arg(o))

    def __radd__(self, o):
        return self._op("add", self._arg(o), ("h", self._i))

    def __sub__(self, o):
        return self._op("sub", ("h", self._i), self._arg(o))

    def __rsub__(self, o):
        return self._op("sub", self._arg(o), ("h", self._i))

    def __mul__(self, o):
        return self._op("mul", ("h", self._i), self._arg(o))

    def __rmul__(self, o):
        return self._op("mul", self._arg(o), ("h", self._i))

    def __truediv__(self, o):
        return self._op("div", ("h", self._i), self._arg(o))

    def __rtruediv__(self, o):
        return self._op("div", self._arg(o), ("h", self._i))

    def __pow__(self, o):
        return self._op("pow", ("h", self._i), self._arg(o))

    def __rpow__(self, o):
        return self._op("pow", self._arg(o), ("h", self._i))

    def __neg__(self):
        return _Host(self._p, self._p.add_host("neg", (("h", self._i),)))

    def __pos__(self):
        return self

    def __abs__(self):
        return _Host(self._p, self._p.add_host("abs", (("h", self._i),)))

    def _control(self, *a):
        raise _outside("Python control flow or a conversion on lr, wd or t "
                       "(float(), int(), a comparison)")

    __float__ = __int__ = __index__ = __bool__ = _control
    __lt__ = __le__ = __gt__ = __ge__ = _control

    def __eq__(self, o):
        self._control()

    __ne__ = __eq__
    __hash__ = object.__hash__


class _Vec(object):
    """A symbolic float32 (or bool) vector of the sweep."""

    __slots__ = ("_p", "_i", "_kind")

    def __init__(self, prog, i, kind="f"):
        self._p, self._i, self._kind = prog, i, kind

    @property
    def dtype(self):
        return torch.bool if self._kind == "b" else torch.float32

    @property
    def device(self):
        return torch.device("cpu")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        handler = _TORCH.get(func)
        if handler is None:
            raise _outside(_fname(func))
        return handler(*args, **(kwargs or {}))

    def __getattr__(self, name):
        handler = _METHODS.get(name)
        if handler is None:
            raise _outside("Tensor.%s" % name)
        return lambda *a, **k: handler(self, *a, **k)

    def __add__(self, o):
        return _binary("add", self, o)

    def __radd__(self, o):
        return _binary("add", o, self)

    def __sub__(self, o):
        return _binary("sub", self, o)

    def __rsub__(self, o):
        return _binary("sub", o, self)

    def __mul__(self, o):
        return _binary("mul", self, o)

    def __rmul__(self, o):
        return _binary("mul", o, self)

    def __truediv__(self, o):
        return _binary("div", self, o)

    def __rtruediv__(self, o):
        # Tensor.__rtruediv__ is reciprocal(self) * other
        return _binary("mul", _unary("reciprocal", self), o)

    def __pow__(self, o):
        return _binary("pow", self, o)

    def __rpow__(self, o):
        return _binary("pow", o, self)

    def __neg__(self):
        return _unary("neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _unary("abs", self)

    def __lt__(self, o):
        return _binary("lt", self, o, "b")

    def __le__(self, o):
        return _binary("le", self, o, "b")

    def __gt__(self, o):
        return _binary("gt", self, o, "b")

    def __ge__(self, o):
        return _binary("ge", self, o, "b")

    def __eq__(self, o):
        return _binary("eq", self, o, "b")

    def __ne__(self, o):
        return _binary("ne", self, o, "b")

    def __and__(self, o):
        return _logical("and", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return _logical("or", self, o)

    __ror__ = __or__

    def __invert__(self):
        return _logical("not", self)

    __hash__ = object.__hash__

    def _control(self, *a):
        raise _outside("Python control flow or a conversion on a tensor's "
                       "value (bool(), float(), len(), iteration)")

    __bool__ = __float__ = __int__ = __index__ = __len__ = __iter__ = \
        _control


def _prog_of(*xs):
    for x in xs:
        if isinstance(x, (_Vec, _Host)):
            return x._p
    return None


def _arg(prog, x, float_only=True):
    """An operand of a node; a bool vector in an arithmetic op is widened
    to float32 first (as PyTorch promotes it)."""
    if isinstance(x, _Vec):
        if x._p is not prog:
            raise MXNetError("sweep trace: a value of another trace")
        if float_only and x._kind == "b":
            return ("n", prog.add("tofloat", [("n", x._i)]))
        return ("n", x._i)
    if isinstance(x, _Host):
        return ("h", x._i)
    if isinstance(x, (bool, int, float)):
        return ("c", x)
    if isinstance(x, torch.Tensor):
        raise _outside("a tensor of shape %s the update was not given (a "
                       "random draw, a captured buffer)" % (tuple(x.shape),))
    raise _outside("an operand of type %s" % type(x).__name__)


def _binary(op, a, b, kind="f"):
    prog = _prog_of(a, b)
    cmp = kind == "b"
    return _Vec(prog, prog.add(op, [_arg(prog, a, not cmp),
                                    _arg(prog, b, not cmp)], kind), kind)


def _unary(op, x):
    prog = _prog_of(x)
    return _Vec(prog, prog.add(op, [_arg(prog, x)]))


def _logical(op, *xs):
    prog = _prog_of(*xs)
    args = []
    for x in xs:
        if not isinstance(x, _Vec) or x._kind != "b":
            raise _outside("a logical op on a non-bool operand")
        args.append(("n", x._i))
    return _Vec(prog, prog.add(op, args, "b"), "b")


def _clamp(x, min=None, max=None):
    prog = _prog_of(x)
    for bound in (min, max):
        if isinstance(bound, (_Vec, torch.Tensor)):
            raise _outside("torch.clamp with tensor bounds")
    none = ("c", None)
    return _Vec(prog, prog.add("clamp", [
        _arg(prog, x), none if min is None else _arg(prog, min),
        none if max is None else _arg(prog, max)]))


def _where(cond, a, b):
    prog = _prog_of(cond, a, b)
    if not isinstance(cond, _Vec) or cond._kind != "b":
        raise _outside("torch.where with a condition that is not a traced "
                       "comparison")
    return _Vec(prog, prog.add("where", [("n", cond._i), _arg(prog, a),
                                         _arg(prog, b)]))


def _fill(like, value):
    prog = _prog_of(like)
    if isinstance(value, (_Vec, _Host)):
        raise _outside("full_like with a traced fill value")
    return _Vec(prog, prog.add("fill", [("c", value)]))


def _to(x, *args, **kwargs):
    dtype = kwargs.get("dtype")
    for a in args:
        if isinstance(a, torch.dtype):
            dtype = a
        elif isinstance(a, _Vec):
            dtype = a.dtype
    if dtype not in (None, torch.float32):
        raise _outside("a cast to %s" % dtype)
    if x._kind == "b":
        return _Vec(x._p, x._p.add("tofloat", [("n", x._i)]))
    return x


def _as_tensor(value, dtype=None, device=None):
    if not isinstance(value, _Host):
        raise _outside("torch.as_tensor of a traced tensor")
    if dtype is not torch.float32:
        raise _outside("torch.as_tensor of lr, wd or t without "
                       "dtype=torch.float32")
    return _Vec(value._p, value._p.add("hostf", [("h", value._i)]))


def _checked_binary(op, kind="f"):
    def run(a, b, *, alpha=None, out=None, rounding_mode=None):
        if alpha is not None or out is not None or rounding_mode is not None:
            raise _outside("torch.%s with alpha, out or rounding_mode" % op)
        return _binary(op, a, b, kind)
    return run


def _pow(a, b):
    return _binary("pow", a, b)


_UNARY = ("neg", "abs", "sign", "sqrt", "rsqrt", "exp", "log",
          "reciprocal", "square")

_TORCH = {
    torch.add: _checked_binary("add"), torch.sub: _checked_binary("sub"),
    torch.subtract: _checked_binary("sub"),
    torch.mul: _checked_binary("mul"), torch.multiply: _checked_binary("mul"),
    torch.div: _checked_binary("div"), torch.true_divide:
    _checked_binary("div"), torch.divide: _checked_binary("div"),
    torch.pow: _pow,
    torch.negative: lambda x: _unary("neg", x),
    torch.maximum: lambda a, b: _binary("maximum", a, b),
    torch.minimum: lambda a, b: _binary("minimum", a, b),
    torch.clamp: _clamp, torch.clip: _clamp,
    torch.clamp_min: lambda x, m: _clamp(x, min=m),
    torch.clamp_max: lambda x, m: _clamp(x, max=m),
    torch.where: _where,
    torch.lt: lambda a, b: _binary("lt", a, b, "b"),
    torch.le: lambda a, b: _binary("le", a, b, "b"),
    torch.gt: lambda a, b: _binary("gt", a, b, "b"),
    torch.ge: lambda a, b: _binary("ge", a, b, "b"),
    torch.eq: lambda a, b: _binary("eq", a, b, "b"),
    torch.ne: lambda a, b: _binary("ne", a, b, "b"),
    torch.logical_and: lambda a, b: _logical("and", a, b),
    torch.logical_or: lambda a, b: _logical("or", a, b),
    torch.logical_not: lambda a: _logical("not", a),
    torch.zeros_like: lambda x, **k: _fill(x, 0.0),
    torch.ones_like: lambda x, **k: _fill(x, 1.0),
    torch.full_like: lambda x, v, **k: _fill(x, v),
    torch.clone: lambda x, **k: x,
}
_TORCH.update({getattr(torch, op): (lambda x, _op=op: _unary(_op, x))
               for op in _UNARY})
for _name, _fn in list(_TORCH.items()):
    _meth = getattr(torch.Tensor, _fname(_name).split(".")[-1], None)
    if _meth is not None and _meth not in _TORCH:
        _TORCH[_meth] = _fn

_METHODS = {
    "add": _checked_binary("add"), "sub": _checked_binary("sub"),
    "mul": _checked_binary("mul"), "div": _checked_binary("div"),
    "pow": _pow, "maximum": _TORCH[torch.maximum],
    "minimum": _TORCH[torch.minimum], "clamp": _clamp, "clip": _clamp,
    "clamp_min": _TORCH[torch.clamp_min], "clamp_max": _TORCH[torch.clamp_max],
    "lt": _TORCH[torch.lt], "le": _TORCH[torch.le], "gt": _TORCH[torch.gt],
    "ge": _TORCH[torch.ge], "eq": _TORCH[torch.eq], "ne": _TORCH[torch.ne],
    "float": lambda x: _to(x, torch.float32), "to": _to,
    "type_as": lambda x, other: _to(x, other),
    "clone": lambda x, **k: x, "detach": lambda x: x,
    "negative": lambda x: _unary("neg", x),
}
_METHODS.update({op: (lambda x, _op=op: _unary(_op, x)) for op in _UNARY})

_PATCH_LOCK = threading.Lock()


@contextlib.contextmanager
def _symbolic_constructors():
    """``torch.as_tensor``/``torch.tensor`` of ``lr``, ``wd`` or ``t``
    record a float32 device scalar while a trace runs (neither function
    consults ``__torch_function__`` for its data argument); other calls
    pass through unchanged."""
    orig = {n: getattr(torch, n) for n in ("as_tensor", "tensor")}

    def wrap(name):
        def call(data, *a, **k):
            if isinstance(data, (_Host, _Vec)):
                return _as_tensor(data, *a, **k) if name == "as_tensor" \
                    else _as_tensor(data, k.get("dtype"))
            return orig[name](data, *a, **k)
        return call
    with _PATCH_LOCK:
        for n in orig:
            setattr(torch, n, wrap(n))
        try:
            yield
        finally:
            for n, f in orig.items():
                setattr(torch, n, f)


def _hyper_items(optimizer):
    """The optimizer's numbers, flags, strings and tuples of them: what a
    formula may read from ``self`` and a trace bakes in.  The imperative
    update counters are left out: they change every update and no
    formula of the sweep reads them (the sweep gets ``t``)."""
    skip = {"num_update", "begin_num_update", "_index_update_count"}
    out = []
    for k, v in sorted(vars(optimizer).items()):
        if k in skip:
            continue
        if v is None or isinstance(v, (bool, int, float, str)):
            out.append((k, v))
        elif isinstance(v, tuple) and all(
                isinstance(e, (bool, int, float, str)) for e in v):
            out.append((k, v))
    return tuple(out)


def cache_key(optimizer, preprocess):
    """(class defining ``update_fn``, class defining ``_preprocess_grad``,
    ``preprocess``, the number of state vectors, the hyper-parameters)."""
    return (_defining_class(optimizer, "update_fn"),
            _defining_class(optimizer, "_preprocess_grad"), bool(preprocess),
            _n_state(optimizer), _hyper_items(optimizer))


_PROGRAMS = {}
_LOCK = threading.Lock()


def program(optimizer, preprocess=True):
    """The optimizer's update traced into a :class:`Program`, cached per
    :func:`cache_key`; raises :class:`MXNetError` naming the first
    operation outside the IR."""
    key = cache_key(optimizer, preprocess)
    with _LOCK:
        got = _PROGRAMS.get(key)
    if got is not None:
        return got
    n_state = key[3]
    prog = Program(type(optimizer).__name__, n_state, bool(preprocess))
    w = _Vec(prog, prog.add("input", [("c", "w")]))
    g = _Vec(prog, prog.add("input", [("c", "g")]))
    states = [_Vec(prog, prog.add("input", [("c", "s%d" % i)]))
              for i in range(n_state)]
    lr = _Host(prog, prog.add_host("lr"))
    wd = _Host(prog, prog.add_host("wd"))
    t = _Host(prog, prog.add_host("t"))
    try:
        with _symbolic_constructors():
            if preprocess:
                g = optimizer._preprocess_grad(g)
            nw, ns = optimizer.update_fn(w, g, _state_like(optimizer,
                                                           states),
                                         lr, wd, t)
        outs = [nw] + _state_leaves(ns)
        if len(outs) != n_state + 1:
            raise MXNetError("update_fn returned %d state leaves, the "
                             "optimizer declares %d"
                             % (len(outs) - 1, n_state))
        for o in outs:
            if not isinstance(o, _Vec) or o._kind != "f":
                raise _outside("an update_fn result that is not a float32 "
                               "tensor of the formula (%s)"
                               % type(o).__name__)
            prog.outputs.append(o._i)
    except MXNetError as err:
        raise MXNetError("MXTPU_FUSED_OPT=kernel, sweep body of %s: %s"
                         % (prog.name, err)) from None
    with _LOCK:
        _PROGRAMS.setdefault(key, prog)
    return prog


# ----------------------------------------------------------------------
# the IR in PyTorch
# ----------------------------------------------------------------------
def _host_value(prog, j, lr, wd, t, memo):
    if j in memo:
        return memo[j]
    op, args = prog.host[j]
    if op in ("lr", "wd", "t"):
        val = {"lr": lr, "wd": wd, "t": t}[op]
    else:
        vals = [a[1] if a[0] == "c" else _host_value(prog, a[1], lr, wd, t,
                                                      memo) for a in args]
        if op == "add":
            val = vals[0] + vals[1]
        elif op == "sub":
            val = vals[0] - vals[1]
        elif op == "mul":
            val = vals[0] * vals[1]
        elif op == "div":
            val = vals[0] / vals[1]
        elif op == "pow":
            val = vals[0] ** vals[1]
        elif op == "neg":
            val = -vals[0]
        else:
            val = abs(vals[0])
    memo[j] = val
    return val


def evaluate(prog, w, g, states, lr, wd, t):
    """The IR op by op with the PyTorch operators the formula called, on
    the given tensors: ``(new_w, [new_state, ...])``."""
    memo = {}
    vals = []
    inputs = [w, g] + list(states)

    def arg(a):
        if a[0] == "n":
            return vals[a[1]]
        if a[0] == "h":
            return _host_value(prog, a[1], lr, wd, t, memo)
        return a[1]
    for op, args, _kind in prog.nodes:
        x = [arg(a) for a in args]
        if op == "input":
            v = inputs[len(vals)]
        elif op == "add":
            v = x[0] + x[1]
        elif op == "sub":
            v = x[0] - x[1]
        elif op == "mul":
            v = x[0] * x[1]
        elif op == "div":
            v = x[0] / x[1]
        elif op == "pow":
            v = x[0] ** x[1]
        elif op in _CMP:
            v = _compare(op, x[0], x[1])
        elif op == "and":
            v = torch.logical_and(x[0], x[1])
        elif op == "or":
            v = torch.logical_or(x[0], x[1])
        elif op == "not":
            v = torch.logical_not(x[0])
        elif op == "maximum":
            v = torch.maximum(x[0], x[1])
        elif op == "minimum":
            v = torch.minimum(x[0], x[1])
        elif op == "clamp":
            v = torch.clamp(x[0], x[1], x[2])
        elif op == "where":
            v = torch.where(x[0], x[1], x[2])
        elif op == "fill":
            v = torch.full_like(w, x[0])
        elif op == "hostf":
            v = torch.as_tensor(x[0], dtype=torch.float32, device=w.device)
        elif op == "tofloat":
            v = x[0].to(torch.float32)
        else:
            v = getattr(torch, op)(x[0])
        vals.append(v)
    outs = [vals[i] for i in prog.outputs]
    return outs[0], outs[1:]


def _compare(op, a, b):
    sym = {"lt": "__lt__", "le": "__le__", "gt": "__gt__", "ge": "__ge__",
           "eq": "__eq__", "ne": "__ne__"}[op]
    if isinstance(a, torch.Tensor):
        return getattr(a, sym)(b)
    flip = {"lt": "__gt__", "le": "__ge__", "gt": "__lt__", "ge": "__le__",
            "eq": "__eq__", "ne": "__ne__"}[op]
    return getattr(b, flip)(a)


# ----------------------------------------------------------------------
# the IR in CUDA C
# ----------------------------------------------------------------------
def _f32_literal(value):
    """A float32 literal of ``value`` rounded as PyTorch rounds a Python
    scalar (round to nearest even), in hexadecimal."""
    f = _np.float32(value)
    if not _np.isfinite(f):
        bits = struct.unpack("<I", struct.pack("<f", float(f)))[0]
        return "__int_as_float(0x%08x)" % bits
    return "(%sf)" % float(f).hex()


_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}

_POW_SCALAR = r"""
// tensor ** scalar as PyTorch's CUDA pow: its special exponents first
__device__ __forceinline__ float mxtt_pow_scalar(float a, float e) {
  if (e == 0.f) return 1.f;
  if (e == 1.f) return a;
  if (e == 0.5f) return __fsqrt_rn(a);
  if (e == 2.f) return __fmul_rn(a, a);
  if (e == 3.f) return __fmul_rn(__fmul_rn(a, a), a);
  if (e == -0.5f) return rsqrtf(a);
  if (e == -1.f) return __fdiv_rn(1.f, a);
  if (e == -2.f) return __fdiv_rn(1.f, __fmul_rn(a, a));
  return powf(a, e);
}
"""


def _lower(prog):
    """``(prologue lines, body lines)``: the uniform values, computed once
    a thread, and the per-element statements."""
    params = {j: "p%d" % k for k, j in enumerate(prog.params())}
    names = []
    pro, body = [], []

    def ref(a):
        if a[0] == "n":
            return names[a[1]]
        if a[0] == "h":
            return params[a[1]]
        if a[1] is None:
            return None
        return _f32_literal(a[1])

    def cpu_scalar(a):
        return a[0] in ("c", "h")
    for i, (op, args, kind) in enumerate(prog.nodes):
        if op == "input":
            names.append(["w", "g"][i] if i < 2 else "s%d" % (i - 2))
            continue
        x = [ref(a) for a in args]
        if op == "add":
            e = "__fadd_rn(%s, %s)" % (x[0], x[1])
        elif op == "sub":
            e = "__fsub_rn(%s, %s)" % (x[0], x[1])
        elif op == "mul":
            e = "__fmul_rn(%s, %s)" % (x[0], x[1])
        elif op == "div":
            # a tensor over a Python scalar: PyTorch multiplies by the
            # scalar's float32 reciprocal
            e = ("__fmul_rn(%s, __fdiv_rn(1.f, %s))" if cpu_scalar(args[1])
                 and not cpu_scalar(args[0]) else "__fdiv_rn(%s, %s)") \
                % (x[0], x[1])
        elif op == "pow":
            if cpu_scalar(args[1]) and not cpu_scalar(args[0]):
                if args[1][0] == "c":
                    ev = float(args[1][1])
                    special = {0.0: "1.f", 1.0: "%s", 0.5: "__fsqrt_rn(%s)",
                               2.0: "__fmul_rn(%s, %s)", -0.5: "rsqrtf(%s)",
                               -1.0: "__fdiv_rn(1.f, %s)"}
                    if ev == 3.0:
                        e = "__fmul_rn(__fmul_rn(%s, %s), %s)" % (
                            (x[0],) * 3)
                    elif ev == -2.0:
                        e = "__fdiv_rn(1.f, __fmul_rn(%s, %s))" % (x[0], x[0])
                    elif ev in special:
                        form = special[ev]
                        e = form % ((x[0],) * form.count("%s"))
                    else:
                        e = "powf(%s, %s)" % (x[0], x[1])
                else:
                    e = "mxtt_pow_scalar(%s, %s)" % (x[0], x[1])
            elif cpu_scalar(args[0]) and not cpu_scalar(args[1]):
                # Python scalar ** tensor: ones where the base is 1
                e = ("1.f" if args[0][0] == "c" and float(args[0][1]) == 1.0
                     else "powf(%s, %s)" % (x[0], x[1]))
            else:
                e = "powf(%s, %s)" % (x[0], x[1])
        elif op in _CMP:
            e = "(%s %s %s)" % (x[0], _CMP[op], x[1])
        elif op == "and":
            e = "(%s && %s)" % (x[0], x[1])
        elif op == "or":
            e = "(%s || %s)" % (x[0], x[1])
        elif op == "not":
            e = "(!%s)" % x[0]
        elif op == "maximum":
            e = "(%s != %s ? %s : (%s != %s ? %s : fmaxf(%s, %s)))" % (
                x[0], x[0], x[0], x[1], x[1], x[1], x[0], x[1])
        elif op == "minimum":
            e = "(%s != %s ? %s : (%s != %s ? %s : fminf(%s, %s)))" % (
                x[0], x[0], x[0], x[1], x[1], x[1], x[0], x[1])
        elif op == "clamp":
            v = x[0]
            if x[1] is not None:
                v = "fmaxf(%s, %s)" % (v, x[1])
            if x[2] is not None:
                v = "fminf(%s, %s)" % (v, x[2])
            e = "(isnan(%s) ? %s : %s)" % (x[0], x[0], v)
        elif op == "where":
            e = "(%s ? %s : %s)" % (x[0], x[1], x[2])
        elif op == "fill":
            e = x[0]
        elif op == "hostf":
            e = x[0]
        elif op == "tofloat":
            e = "(%s ? 1.f : 0.f)" % x[0]
        elif op == "neg":
            e = "(-%s)" % x[0]
        elif op == "abs":
            e = "fabsf(%s)" % x[0]
        elif op == "sign":
            e = "(float)((0.f < %s) - (%s < 0.f))" % (x[0], x[0])
        elif op == "sqrt":
            e = "__fsqrt_rn(%s)" % x[0]
        elif op == "rsqrt":
            e = "rsqrtf(%s)" % x[0]
        elif op == "exp":
            e = "expf(%s)" % x[0]
        elif op == "log":
            e = "logf(%s)" % x[0]
        elif op == "reciprocal":
            e = "__fdiv_rn(1.f, %s)" % x[0]
        elif op == "square":
            e = "__fmul_rn(%s, %s)" % (x[0], x[0])
        else:
            raise MXNetError("sweep codegen: no lowering for %r" % op)
        name = ("u%d" if prog.uniform[i] else "v%d") % i
        names.append(name)
        line = "const %s %s = %s;" % ("bool" if kind == "b" else "float",
                                      name, e)
        (pro if prog.uniform[i] else body).append(line)
    return pro, body, names


KERNEL_VEC4 = "mxtt_gen_sweep_vec4"
KERNEL_SCALAR = "mxtt_gen_sweep_scalar"


def cuda_source(prog):
    """The CUDA C of ``prog``: ``mxtt_gen_sweep_vec4`` and
    ``mxtt_gen_sweep_scalar``, each ``(w, g, s0.., n, ok, p0..)``."""
    pro, body, names = _lower(prog)
    n = prog.n_state
    uniforms = [names[i] for i in range(len(prog.nodes))
                if prog.uniform[i] and prog.nodes[i][0] != "input"]
    kinds = {names[i]: prog.nodes[i][2] for i in range(len(prog.nodes))}
    u_params = "".join(", const %s %s" % ("bool" if kinds[u] == "b"
                                          else "float", u)
                       for u in uniforms)
    n_params = len(prog.params())
    p_params = "".join(", const float p%d" % k for k in range(n_params))
    u_params += p_params
    u_args = "".join(", " + u for u in uniforms) + "".join(
        ", p%d" % k for k in range(n_params))
    st_ref = "".join(", float& s%d" % i for i in range(n))
    # the new values are all computed before any is stored
    tmp = ["const float o%d = %s;" % (i, names[o])
           for i, o in enumerate(prog.outputs)]
    store = ["w = o0;"] + ["s%d = o%d;" % (i, i + 1) for i in range(n)]
    ptr_params = "".join(", float* __restrict__ s%d" % i for i in range(n))
    st_vec = ["  float4* s%d4 = reinterpret_cast<float4*>(s%d);" % (i, i)
              for i in range(n)]
    lines = [
        "// Generated by mxnet_tpu_torch/kernels/sweep_codegen.py from",
        "// %s.update_fn%s (%d state vectors); compiled with --fmad=false."
        % (prog.name, " after _preprocess_grad" if prog.preprocess else "",
           n),
        "// Ops: %s." % ", ".join(prog.ops()),
        _POW_SCALAR if "mxtt_pow_scalar" in "\n".join(pro + body) else "",
        "__device__ __forceinline__ void mxtt_update(float& w, const float g"
        + st_ref + u_params + ") {",
    ]
    lines += ["  " + ln for ln in body + tmp + store]
    lines += ["}", ""]

    def prologue(indent):
        return [indent + ln for ln in pro]
    head_args = ("float* __restrict__ w, const float* __restrict__ g"
                 + ptr_params + ", const long long n, "
                 "const int* __restrict__ ok" + p_params)
    call_el = ("mxtt_update(wv.%c, gv.%c" + "".join(
        ", sv%d.%%c" % i for i in range(n)) + u_args + ");")
    lines += ["extern \"C\" __global__ void %s(%s) {" % (KERNEL_VEC4,
                                                          head_args),
              "  if (ok != nullptr && *ok == 0) return;"]
    lines += prologue("  ")
    lines += [
        "  const long long n4 = n / 4;",
        "  const long long stride = (long long)gridDim.x * blockDim.x;",
        "  float4* w4 = reinterpret_cast<float4*>(w);",
        "  const float4* g4 = reinterpret_cast<const float4*>(g);",
    ]
    lines += st_vec
    lines += ["  for (long long i = (long long)blockIdx.x * blockDim.x + "
              "threadIdx.x; i < n4; i += stride) {",
              "    float4 wv = w4[i];",
              "    const float4 gv = g4[i];"]
    lines += ["    float4 sv%d = s%d4[i];" % (i, i) for i in range(n)]
    for c in "xyzw":
        lines.append("    " + call_el.replace("%c", c))
    lines += ["    w4[i] = wv;"]
    lines += ["    s%d4[i] = sv%d;" % (i, i) for i in range(n)]
    lines += ["  }",
              "  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) {",
              "    const long long i = n4 * 4 + threadIdx.x;",
              "    float wi = w[i];"]
    lines += ["    float si%d = s%d[i];" % (i, i) for i in range(n)]
    lines += ["    mxtt_update(wi, g[i]" + "".join(", si%d" % i
                                                 for i in range(n))
              + u_args + ");",
              "    w[i] = wi;"]
    lines += ["    s%d[i] = si%d;" % (i, i) for i in range(n)]
    lines += ["  }", "}", ""]
    lines += ["extern \"C\" __global__ void %s(%s) {" % (KERNEL_SCALAR,
                                                          head_args),
              "  if (ok != nullptr && *ok == 0) return;"]
    lines += prologue("  ")
    lines += ["  const long long stride = (long long)gridDim.x * blockDim.x;",
              "  for (long long i = (long long)blockIdx.x * blockDim.x + "
              "threadIdx.x; i < n; i += stride) {",
              "    float wi = w[i];"]
    lines += ["    float si%d = s%d[i];" % (i, i) for i in range(n)]
    lines += ["    mxtt_update(wi, g[i]" + "".join(", si%d" % i
                                                 for i in range(n))
              + u_args + ");",
              "    w[i] = wi;"]
    lines += ["    s%d[i] = si%d;" % (i, i) for i in range(n)]
    lines += ["  }", "}", ""]
    return "\n".join(lines)


def launch_arguments(prog, lr, wd, t):
    """The kernel's float32 arguments for this step: each host value the
    formula reads, computed in Python as the plain formula computes it,
    then rounded to float32 as PyTorch rounds a Python scalar."""
    memo = {}
    return [float(_np.float32(_host_value(prog, j, lr, wd, t, memo)))
            for j in prog.params()]


# ----------------------------------------------------------------------
# compile and launch
# ----------------------------------------------------------------------
#: NVRTC options beyond kernels/nvrtc.py's (sm_90a, C++17): no
#: contraction of a product and a sum into one fused multiply-add
NVRTC_OPTIONS = ("--fmad=false",)

_BUILT = {}         # source -> {"cubin", "seconds", "functions": {dev: (v4, s)}}


def _built(prog):
    """The compiled source of ``prog`` (kept on it: a launch neither
    lowers nor looks up the source again)."""
    got = prog.built
    if got is not None:
        return got
    source = cuda_source(prog)
    with _LOCK:
        got = _BUILT.get(source)
    if got is None:
        from . import nvrtc
        t0 = time.perf_counter()
        cubin = nvrtc.compile_cubin(source, options=NVRTC_OPTIONS)
        got = {"cubin": cubin, "seconds": time.perf_counter() - t0,
               "functions": {}, "source": source}
        with _LOCK:
            got = _BUILT.setdefault(source, got)
    prog.built = got
    return got


def compile_seconds(prog):
    """NVRTC's compile time of ``prog``'s source (it compiles once a
    process), or None before its first launch."""
    return None if prog.built is None else prog.built["seconds"]


def launch(prog, w, g, states, lr, wd, t, ok=None):
    """``prog`` over the flat float32 CUDA vectors ``w``, ``g`` and
    ``states``, in place, on the current stream of ``w``'s device; ``ok``:
    the skip flag (an int32 CUDA tensor) or None.  Returns the route,
    ``"vec4"`` or ``"scalar"``."""
    from . import nvrtc
    built = _built(prog)
    device = w.device.index if w.device.index is not None \
        else torch.cuda.current_device()
    fns = built["functions"].get(device)
    if fns is None:
        module = nvrtc.Module(built["cubin"], device)
        fns = (module.function(KERNEL_VEC4), module.function(KERNEL_SCALAR))
        built["functions"][device] = fns
    bits = 0
    for x in [w, g] + list(states):
        bits |= x.data_ptr()
    vec = bits % 16 == 0
    n = w.numel()
    threads = 256
    work = (n + 3) // 4 if vec else n
    blocks = max(1, min((work + threads - 1) // threads, 132 * 16))
    args = [ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(g.data_ptr())]
    args += [ctypes.c_void_p(s.data_ptr()) for s in states]
    args += [ctypes.c_longlong(n),
             ctypes.c_void_p(ok.data_ptr() if ok is not None else None)]
    args += [ctypes.c_float(v) for v in launch_arguments(prog, lr, wd, t)]
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        fns[0 if vec else 1].launch_args((blocks, 1, 1), (threads, 1, 1),
                                         args, stream)
    return "vec4" if vec else "scalar"
