"""Symbol: the symbolic graph API.

The port's counterpart of ``mxnet_tpu/symbol.py``: a DAG of plain Python
nodes with variables, groups, operator composition (one creator function
per registered op, auto-created ``<name>_<arg>`` variables, NameManager
naming), partial shape inference that fills parameter shapes from data
shapes, and JSON in the reference's ``nodes``/``arg_nodes``/``heads``
layout.  The JSON is the same text the JAX package writes, so a symbol
saved by either package loads in the other.  The arithmetic operators
(``+ - * / **``, unary ``-``, and :func:`maximum`, :func:`minimum`,
:func:`pow`) create the binary ops with another Symbol and the scalar
ops with a number, as there; :meth:`Symbol.grad` builds the gradient
symbol, whose op runs the base graph under ``torch.autograd.grad``.
Attributes (:meth:`Symbol.attr`, ``list_attr``), ``get_internals``,
iteration over the outputs, :meth:`Symbol.infer_type` (in torch
dtypes), pickling through the JSON and ``debug_str`` are the JAX
package's.
"""
from __future__ import annotations

import json

import torch

from .base import MXNetError
from .attribute import AttrScope
from .dparam import parse_tuple
from .name import NameManager
from .ndarray import _torch_dtype
from .ops.registry import OP_REGISTRY, IncompleteShape, create_operator

__all__ = ["Symbol", "Variable", "Group", "load", "load_json", "maximum",
           "minimum", "pow"]


class _Node:
    __slots__ = ("op", "name", "inputs", "attrs")

    def __init__(self, op, name, inputs, attrs):
        self.op = op            # OperatorProperty | None (=> variable)
        self.name = name
        self.inputs = inputs    # list[(node, out_index)]
        self.attrs = dict(attrs or {})

    @property
    def is_variable(self):
        return self.op is None

    @property
    def num_outputs(self):
        return 1 if self.op is None else self.op.num_outputs


def _topo_order(head_nodes):
    """Post-DFS order (parity: static_graph.cc:17 PostDFSOrder)."""
    order, visited = [], set()
    for head in head_nodes:
        stack = [(head, 0)]
        while stack:
            node, child_idx = stack.pop()
            if id(node) in visited and child_idx == 0:
                continue
            if child_idx < len(node.inputs):
                stack.append((node, child_idx + 1))
                child = node.inputs[child_idx][0]
                if id(child) not in visited:
                    stack.append((child, 0))
            else:
                if id(node) not in visited:
                    visited.add(id(node))
                    order.append(node)
    return order


class Symbol:
    """Handle to one or more output entries of the DAG."""

    def __init__(self, heads):
        self._heads = list(heads)  # list[(node, out_index)]

    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def attr(self, key):
        """The head node's attribute ``key``, or None."""
        return self._heads[0][0].attrs.get(key)

    def _set_attr(self, **kwargs):
        for k, v in kwargs.items():
            self._heads[0][0].attrs[k] = str(v)

    def list_attr(self):
        """The head node's attributes."""
        return dict(self._heads[0][0].attrs)

    # -- traversal ---------------------------------------------------------
    def _topo(self):
        return _topo_order([n for n, _ in self._heads])

    def list_arguments(self):
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self):
        out = []
        for node, idx in self._heads:
            if node.is_variable:
                out.append(node.name)
            else:
                names = node.op.list_outputs()
                out.append("%s_%s" % (node.name, names[idx]))
        return out

    def list_auxiliary_states(self):
        out = []
        for node in self._topo():
            if not node.is_variable:
                for aux in node.op.list_auxiliary_states():
                    out.append("%s_%s" % (node.name, aux))
        return out

    def get_internals(self):
        """A group of every output of every node, in topological order."""
        heads = []
        for node in self._topo():
            for i in range(node.num_outputs):
                heads.append((node, i))
        return Symbol(heads)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("cannot find output %r in %s" % (index, names))
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (self[i] for i in range(len(self._heads)))

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    # -- composition sugar -------------------------------------------------
    def __call__(self, *args, **kwargs):
        raise MXNetError("Symbol composition via __call__ is not supported; "
                         "pass symbols as op arguments instead")

    def _binop(self, other, op_name, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _create(op_name, lhs, rhs)
        return _create(scalar_op, self, scalar=float(other))

    def __add__(self, other):
        return self._binop(other, "_Plus", "_PlusScalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "_Minus", "_MinusScalar")

    def __rsub__(self, other):
        if isinstance(other, Symbol):
            return other.__sub__(self)
        return _create("_RMinusScalar", self, scalar=float(other))

    def __mul__(self, other):
        return self._binop(other, "_Mul", "_MulScalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "_Div", "_DivScalar")

    def __rtruediv__(self, other):
        if isinstance(other, Symbol):
            return other.__truediv__(self)
        return _create("_RDivScalar", self, scalar=float(other))

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return self._binop(other, "_Power", "_PowerScalar")

    def __neg__(self):
        return _create("_MulScalar", self, scalar=-1.0)

    # -- inference ---------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes); (None,)*3 if incomplete."""
        arg_shapes, out_shapes, aux_shapes, complete = \
            self._infer_shape_impl(args, kwargs)
        if not complete:
            return None, None, None
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        a, o, x, _ = self._infer_shape_impl(args, kwargs)
        return a, o, x

    def _infer_shape_impl(self, args, kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            if len(args) > len(arg_names):
                raise MXNetError("too many positional shapes")
            for name, shape in zip(arg_names, args):
                if shape is not None:
                    known[name] = tuple(shape)
        for name, shape in kwargs.items():
            if name not in arg_names:
                raise MXNetError("infer_shape: unknown argument %r; arguments "
                                 "are %s" % (name, arg_names))
            known[name] = tuple(shape)

        topo = self._topo()
        shapes = {}  # (id(node), idx) -> tuple
        for node in topo:
            if node.is_variable:
                if node.name in known:
                    shapes[(id(node), 0)] = known[node.name]
                elif "__shape__" in node.attrs:
                    shapes[(id(node), 0)] = parse_tuple(node.attrs["__shape__"])

        while True:  # fixpoint: forward fill + param backfill until no progress
            progress = False
            for node in topo:
                if node.is_variable:
                    continue
                in_shapes = [shapes.get((id(c), ci)) for c, ci in node.inputs]
                try:
                    full_in, outs, _aux = node.op.infer_shape(in_shapes)
                except IncompleteShape:
                    continue
                for (c, ci), s in zip(node.inputs, full_in):
                    key = (id(c), ci)
                    if s is not None:
                        prev = shapes.get(key)
                        if prev is not None and tuple(prev) != tuple(s):
                            raise MXNetError(
                                "shape mismatch for input of %s: %s vs %s"
                                % (node.name, prev, s))
                        if prev is None:
                            shapes[key] = tuple(s)
                            progress = True
                for i, s in enumerate(outs):
                    key = (id(node), i)
                    if shapes.get(key) is None:
                        shapes[key] = tuple(s)
                        progress = True
            if not progress:
                break

        node_by_name = {n.name: n for n in topo if n.is_variable}
        arg_shapes = [shapes.get((id(node_by_name[n]), 0)) for n in arg_names]
        out_shapes = [shapes.get((id(n), i)) for n, i in self._heads]
        aux_shapes = []
        for node in topo:
            if not node.is_variable:
                in_shapes = [shapes.get((id(c), ci)) for c, ci in node.inputs]
                try:
                    _, _, aux = node.op.infer_shape(in_shapes)
                except IncompleteShape:
                    aux = [None] * len(node.op.list_auxiliary_states())
                aux_shapes.extend(aux)
        complete = (all(s is not None for s in arg_shapes)
                    and all(s is not None for s in out_shapes)
                    and all(s is not None for s in aux_shapes))
        return arg_shapes, out_shapes, aux_shapes, complete

    def infer_type(self, *args, **kwargs):
        """Forward type propagation through each op's ``infer_type``
        (Cast, QuantizedDense, Custom): ``(arg_types, out_types,
        aux_types)`` as torch dtypes.  Types are given positionally or
        by name, as numpy or torch dtypes or names; an argument left
        unknown takes the first known type (float32 when none is)."""
        arg_names = self.list_arguments()
        known = {}
        for name, t in zip(arg_names, args):
            if t is not None:
                known[name] = _torch_dtype(t)
        for name, t in kwargs.items():
            if name not in arg_names:
                raise MXNetError("infer_type: unknown argument %r; arguments "
                                 "are %s" % (name, arg_names))
            known[name] = _torch_dtype(t)
        base = next(iter(known.values()), torch.float32)

        topo = self._topo()
        types = {}
        for node in topo:
            if node.is_variable:
                types[(id(node), 0)] = known.get(node.name, base)
        aux_types = []
        for node in topo:
            if node.is_variable:
                continue
            in_types = [types.get((id(c), ci)) for c, ci in node.inputs]
            full_in, outs, aux = node.op.infer_type(in_types)
            for (c, ci), t in zip(node.inputs, full_in):
                if types.get((id(c), ci)) is None and t is not None:
                    types[(id(c), ci)] = _torch_dtype(t)
            for i, t in enumerate(outs):
                types[(id(node), i)] = base if t is None else _torch_dtype(t)
            aux_types.extend(base if t is None else _torch_dtype(t)
                             for t in aux)
        node_by_name = {n.name: n for n in topo if n.is_variable}
        arg_types = [types.get((id(node_by_name[n]), 0), base)
                     for n in arg_names]
        out_types = [types.get((id(n), i), base) for n, i in self._heads]
        return arg_types, out_types, aux_types

    # -- grad (Symbol::Grad symbol.cc:569) ---------------------------------
    def grad(self, wrt):
        """The gradient symbol: its arguments are this symbol's arguments
        and one head-gradient variable per output, named
        ``<headnode>_<index>_grad`` (static_graph.cc:448-452); its
        outputs are the gradients with respect to ``wrt``, in order.
        One op evaluates the whole base graph (in training mode) and
        differentiates it with ``torch.autograd.grad``."""
        if isinstance(wrt, str):
            wrt = [wrt]
        wrt = list(wrt)
        args = self.list_arguments()
        missing = [w for w in wrt if w not in args]
        if missing:
            raise MXNetError("Symbol.grad: %s not in arguments %s"
                             % (missing, args))
        op = _GradProp(self, wrt)
        name = NameManager.current().get(None, op.hint)
        attrs = dict(AttrScope.current().get(None))
        entries = [Variable(a)._heads[0] for a in op.list_arguments()]
        node = _Node(op, name, entries, attrs)
        return Symbol([(node, i) for i in range(op.num_outputs)])

    def attr_dict(self):
        """``{node name: {attr: value}}`` of every node that has attrs."""
        return {n.name: dict(n.attrs) for n in self._topo() if n.attrs}

    # -- static analysis (analysis/) ---------------------------------------
    def validate(self, shapes=None, type_dict=None, mesh=None,
                 sharding_rules=None, target="gpu", select=None, skip=None,
                 kvstore=None, hbm_bytes=None, grad_req=None,
                 data_names=None, label_names=None, compute_dtype=None,
                 device_kind=None, world_size=None, **shape_kwargs):
        """Run the static lint passes over this graph; returns
        ``list[analysis.GraphIssue]``, most severe first.

        The counterpart of the reference GraphExecutor's bind-time
        shape/type inference (static_graph.cc:59): catch shape/dtype
        conflicts, dead inputs and ops the target cannot run before the
        first walk.  ``shapes`` (or shape kwargs, ``infer_shape`` style)
        and ``type_dict`` seed propagation; ``mesh``/``sharding_rules``
        enable the SPMD passes (sharding propagation MXL-P, peak memory
        MXL-M, collective audit MXL-C) with ``kvstore``/``hbm_bytes``/
        ``grad_req`` refining their context; ``compute_dtype``/
        ``device_kind`` steer the static roofline (MXL-R, ``target="gpu"``
        only, as the launch-budget family MXL-K); ``world_size`` (or
        ``MXTPU_LINT_DISTRIBUTED=1`` + ``MXTPU_LINT_WORLD_SIZE``) enables
        the distributed trace diff (MXL-D001..003) over
        ``__rank_cond__``/``__collective__`` attrs; ``select``/``skip``
        filter rule ids (wildcards work).  The JAX package's signature,
        with ``target`` defaulting to ``"gpu"``.
        """
        from .analysis import analyze
        known = dict(shapes or {})
        known.update(shape_kwargs)
        return analyze(self, shapes=known, type_dict=type_dict, mesh=mesh,
                       sharding_rules=sharding_rules, target=target,
                       kvstore=kvstore, hbm_bytes=hbm_bytes,
                       grad_req=grad_req, data_names=data_names,
                       label_names=label_names,
                       compute_dtype=compute_dtype,
                       device_kind=device_kind, world_size=world_size,
                       select=select, skip=skip)

    # -- binding (executor.py) ---------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None,
             validate=None):
        """Bind to arrays: ``args``, ``args_grad`` and ``aux_states`` are
        lists or name->NDArray dicts (``executor.Executor``); ``validate``
        is the bind-time lint's mode (``"warn"``, ``"error"``, ``"off"``;
        default ``MXTPU_BIND_VALIDATE``, else ``"warn"``).
        ``shared_exec`` (the reference's memory sharing with another
        executor) changes no result and is ignored; ``group2ctx`` binds
        as usual when None or empty, and a placement map raises
        (ROADMAP.md queue 1 item 3 (j))."""
        from .executor import Executor, check_group2ctx
        check_group2ctx(group2ctx, "Symbol.bind")
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        validate=validate)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, validate=None,
                    **kwargs):
        """Allocate arrays from the shapes in ``kwargs`` and bind
        (``executor.simple_bind``; ``group2ctx`` and ``shared_exec`` as
        :meth:`bind` takes them)."""
        from .executor import simple_bind
        return simple_bind(self, ctx, grad_req=grad_req, type_dict=type_dict,
                           group2ctx=group2ctx, shared_exec=shared_exec,
                           validate=validate, **kwargs)

    # -- serialization (reference JSON layout) -----------------------------
    def tojson(self):
        topo = self._topo()
        node_index = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for n in topo:
            nodes.append({
                "op": "null" if n.is_variable else n.op.op_name,
                "name": n.name,
                "attr": {k: str(v) for k, v in n.attrs.items()},
                "inputs": [[node_index[id(c)], ci] for c, ci in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(topo) if n.is_variable]
        heads = [[node_index[id(n)], i] for n, i in self._heads]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "heads": heads}, indent=2)

    def save(self, fname):
        with open(fname, "w") as fo:
            fo.write(self.tojson())

    # -- pickling: the JSON is the state (the reference's Symbol
    # __getstate__/__setstate__) --------------------------------------------
    def __getstate__(self):
        return {"handle": self.tojson()}

    def __setstate__(self, state):
        self._heads = load_json(state["handle"])._heads

    def debug_str(self):
        """One line a node in topological order: ``Variable:<name>`` or
        ``<op>(<input>[<index>], ...) -> <name>``."""
        lines = []
        for n in self._topo():
            if n.is_variable:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join("%s[%d]" % (c.name, ci) for c, ci in n.inputs)
                lines.append("%s(%s) -> %s" % (n.op.op_name, ins, n.name))
        return "\n".join(lines)


class _GradProp:
    """The op of :meth:`Symbol.grad` (Symbol::Grad, symbol.cc:569).

    Holds the base symbol; ``forward`` runs the base graph's walk
    ``trace`` in training mode and returns the gradients of the ``wrt``
    arguments for the head gradients it is given.  The program that
    binds the grad symbol builds ``trace`` (``executor.build_program``),
    so the mirroring envs of that bind reach the base walk; the JAX
    package builds it once, in ``Symbol.grad``.  When the
    caller records gradients (a grad symbol bound for training), the
    gradients are built with ``create_graph`` and are differentiable in
    turn.  Not registered: a grad symbol is built, bound and run, not
    loaded from JSON (as in the JAX package)."""

    param_cls = None
    op_name = "_Grad"
    hint = "grad"

    def __init__(self, base, wrt):
        self.attrs = {}
        self.param = None
        self._base = base
        self._wrt = list(wrt)
        self._base_args = base.list_arguments()
        self._aux_names = base.list_auxiliary_states()
        self._head_names = ["%s_%d_grad" % (node.name, index)
                            for node, index in base._heads]
        self.need_rng = any(getattr(n.op, "need_rng", False)
                            for n in base._topo() if not n.is_variable)

    def list_arguments(self):
        return list(self._base_args) + list(self._head_names)

    def list_outputs(self):
        return ["%s_grad" % w for w in self._wrt]

    def list_auxiliary_states(self):
        return list(self._aux_names)

    @property
    def num_outputs(self):
        return len(self._wrt)

    def infer_shape(self, in_shapes):
        n = len(self._base_args)
        known = {k: v for k, v in zip(self._base_args, in_shapes[:n])
                 if v is not None}
        barg, bout, baux = self._base.infer_shape(**known)
        if barg is None:
            raise IncompleteShape("_Grad: the base graph's shapes are "
                                  "incomplete")
        full_in = list(barg) + list(bout)   # head grads shaped like outputs
        out_shapes = [barg[self._base_args.index(w)] for w in self._wrt]
        return full_in, out_shapes, list(baux)

    def infer_type(self, in_types):
        # the base graph's types; head gradients typed like its outputs
        n = len(self._base_args)
        known = {k: t for k, t in zip(self._base_args, in_types[:n])
                 if t is not None}
        barg, bout, baux = self._base.infer_type(**known)
        out_types = [barg[self._base_args.index(w)] for w in self._wrt]
        return list(barg) + list(bout), out_types, list(baux)

    def forward(self, inputs, aux, is_train, rng, trace):
        n = len(self._base_args)
        arg_vals = dict(zip(self._base_args, inputs[:n]))
        head_grads = list(inputs[n:])
        aux_vals = dict(zip(self._aux_names, aux))
        outer = torch.is_grad_enabled()
        with torch.enable_grad():
            wrt_in = {}
            for w in self._wrt:
                v = arg_vals[w]
                if not (outer and v.requires_grad):
                    v = v.detach().requires_grad_(True)
                wrt_in[w] = v
            merged = dict(arg_vals)
            merged.update(wrt_in)
            # the backward pass differentiates the TRAINING computation
            # (batch statistics, active Dropout), whatever is_train says
            outs, _aux_out = trace(merged, aux_vals, rng, True)
            got = torch.autograd.grad(
                outs, [wrt_in[w] for w in self._wrt],
                [h.to(o.dtype) for h, o in zip(head_grads, outs)],
                allow_unused=True, create_graph=outer)
        return [torch.zeros_like(wrt_in[w]) if g is None else g
                for w, g in zip(self._wrt, got)], None


def Variable(name, attr=None, shape=None, **kwargs):
    """Create a symbolic variable (parity symbol.cc CreateVariable)."""
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    attr = AttrScope.current().get(attr)
    if shape is not None:
        attr = dict(attr)
        attr["__shape__"] = str(tuple(shape))
    for k, v in kwargs.items():
        attr = dict(attr)
        attr[k] = str(v)
    return Symbol([(_Node(None, name, [], attr), 0)])


def _sym_or_scalar_binop(lhs, rhs, op_name, scalar_op, rscalar_op, what):
    """symbol op symbol, symbol op scalar, or scalar op symbol."""
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _create(op_name, lhs, rhs)
    if isinstance(lhs, Symbol):
        return _create(scalar_op, lhs, scalar=float(rhs))
    if isinstance(rhs, Symbol):
        return _create(rscalar_op, rhs, scalar=float(lhs))
    raise MXNetError("%s needs at least one Symbol operand" % what)


def maximum(lhs, rhs):
    """Elementwise max of Symbols or a Symbol and a number."""
    return _sym_or_scalar_binop(lhs, rhs, "_Maximum", "_MaximumScalar",
                                "_MaximumScalar", "maximum")


def minimum(lhs, rhs):
    """Elementwise min of Symbols or a Symbol and a number."""
    return _sym_or_scalar_binop(lhs, rhs, "_Minimum", "_MinimumScalar",
                                "_MinimumScalar", "minimum")


def pow(lhs, rhs):  # noqa: A001 (the reference's name)
    """Elementwise power of Symbols or a Symbol and a number."""
    return _sym_or_scalar_binop(lhs, rhs, "_Power", "_PowerScalar",
                                "_RPowerScalar", "pow")


def Group(symbols):
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for spec in data["nodes"]:
        attrs = spec.get("attr", spec.get("param", {})) or {}
        inputs = [(nodes[i], ci) for i, ci, *_ in spec["inputs"]]
        if spec["op"] in ("null", "None"):
            node = _Node(None, spec["name"], [], attrs)
        else:
            cls = OP_REGISTRY.get(spec["op"])
            fields = cls.param_cls._fields if cls.param_cls is not None else {}
            # only declared param fields configure the op; other attrs
            # (ctx_group, lr_mult, user tags) ride on the node, except
            # for ops that take free-form kwargs (Custom, _Native)
            if getattr(cls, "accepts_any_attrs", False):
                op_kwargs = dict(attrs)
            else:
                op_kwargs = {k: v for k, v in attrs.items() if k in fields}
            op = create_operator(spec["op"], **op_kwargs)
            node = _Node(op, spec["name"], inputs, attrs)
        nodes.append(node)
    heads = [(nodes[i], ci) for i, ci, *_ in data["heads"]]
    return Symbol(heads)


def load(fname):
    with open(fname, "r") as fi:
        return load_json(fi.read())


# ----------------------------------------------------------------------
# op creator functions (parity: symbol.py:1090-1104 _init_symbol_module)
# ----------------------------------------------------------------------
def _create(op_name, *args, **kwargs):
    explicit_name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)

    sym_kwargs = {}
    attr_kwargs = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            sym_kwargs[k] = v
        else:
            attr_kwargs[k] = v

    pos_syms = []
    for a in args:
        if isinstance(a, Symbol):
            pos_syms.append(a)
        else:
            raise MXNetError("%s: positional arguments must be Symbols, got %r"
                             % (op_name, type(a)))

    cls = OP_REGISTRY.get(op_name)
    if getattr(cls, "param_cls", None) is not None and \
            "num_args" in cls.param_cls._fields \
            and "num_args" not in attr_kwargs:
        attr_kwargs["num_args"] = len(pos_syms) + len(sym_kwargs)

    op = create_operator(op_name, **attr_kwargs)
    hint = op.hint or op_name.lower().strip("_")
    name = NameManager.current().get(explicit_name, hint)
    attrs = dict(AttrScope.current().get(attr))
    attrs.update(op.attrs)

    arg_names = op.list_arguments()
    inputs = {}
    for aname, s in zip(arg_names, pos_syms):
        inputs[aname] = s
    for aname, s in sym_kwargs.items():
        if aname not in arg_names:
            raise MXNetError("%s: unknown input %r; inputs are %s"
                             % (op_name, aname, arg_names))
        if aname in inputs:
            raise MXNetError("%s: input %r given twice" % (op_name, aname))
        inputs[aname] = s
    # auto-create missing inputs as variables named {name}_{arg}
    entries = []
    for aname in arg_names:
        if aname in inputs:
            s = inputs[aname]
            if len(s._heads) != 1:
                raise MXNetError("%s: input %r must have a single output"
                                 % (op_name, aname))
            entries.append(s._heads[0])
        else:
            entries.append(Variable("%s_%s" % (name, aname))._heads[0])

    node = _Node(op, name, entries, attrs)
    return Symbol([(node, i) for i in range(op.num_outputs)])


def _make_creator(op_name):
    def creator(*args, **kwargs):
        return _create(op_name, *args, **kwargs)
    creator.__name__ = op_name
    cls = OP_REGISTRY.get(op_name)
    doc = cls.__doc__ or ""
    if getattr(cls, "param_cls", None) is not None:
        doc += "\n\nParameters\n----------\n" + cls.param_cls.describe()
    creator.__doc__ = doc
    return creator


def _init_symbol_module():
    """Inject one creator per registered op into this module's namespace."""
    g = globals()
    for name, _cls in OP_REGISTRY.items():
        if name not in g:
            g[name] = _make_creator(name)


from . import ops as _ops  # noqa: E402,F401  (triggers op registration)
_init_symbol_module()
