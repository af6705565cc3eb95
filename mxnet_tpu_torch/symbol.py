"""Symbol: the symbolic graph API.

The port's counterpart of ``mxnet_tpu/symbol.py``: a DAG of plain Python
nodes with variables, groups, operator composition (one creator function
per registered op, auto-created ``<name>_<arg>`` variables, NameManager
naming), partial shape inference that fills parameter shapes from data
shapes, and JSON in the reference's ``nodes``/``arg_nodes``/``heads``
layout.  The JSON is the same text the JAX package writes, so a symbol
saved by either package loads in the other.
"""
from __future__ import annotations

import json

from .base import MXNetError
from .attribute import AttrScope
from .dparam import parse_tuple
from .name import NameManager
from .ops.registry import OP_REGISTRY, IncompleteShape, create_operator

__all__ = ["Symbol", "Variable", "Group", "load", "load_json"]


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

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("cannot find output %r in %s" % (index, names))
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    # -- composition sugar -------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise MXNetError("the port's Symbol adds Symbols only, got %r"
                             % type(other))
        return _create("_Plus", self, other)

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

    def attr_dict(self):
        """``{node name: {attr: value}}`` of every node that has attrs."""
        return {n.name: dict(n.attrs) for n in self._topo() if n.attrs}

    # -- binding (executor.py) ---------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind to arrays: ``args``, ``args_grad`` and ``aux_states`` are
        lists or name->NDArray dicts (``executor.Executor``).  Placement
        by ``group2ctx`` and memory sharing with another executor are not
        ported."""
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None, **kwargs):
        """Allocate arrays from the shapes in ``kwargs`` and bind
        (``executor.simple_bind``)."""
        from .executor import simple_bind
        return simple_bind(self, ctx, grad_req=grad_req, type_dict=type_dict,
                           **kwargs)

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
            # (ctx_group, lr_mult, user tags) ride on the node
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
