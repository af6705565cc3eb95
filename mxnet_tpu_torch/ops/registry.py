"""Operator registry: metadata + forward functions on torch tensors.

The port's counterpart of ``mxnet_tpu/ops/registry.py`` (the reference's
``OperatorProperty``, ``include/mxnet/operator.h:165-480``).  An operator
is metadata (argument/output/aux names, shape and type inference) plus a
``forward`` on torch tensors.  Backward is autograd through ``forward``
(ops whose reference backward differs, like SoftmaxOutput, wrap a
``torch.autograd.Function``).  Beside the compute, each op carries the
metadata the static analyzer (``analysis/``) reads: ``host_callback``
and ``unsupported_platforms`` (the lowering lint, MXL-L), the sharding
transfer rule ``infer_sharding`` (MXL-P) and the roofline cost hooks
``cost_*`` (MXL-R).  They are the JAX package's, rule for rule, so a
saved graph lints and prices the same in both packages.
"""
from __future__ import annotations

from ..base import MXNetError
from ..registry import Registry

__all__ = ["OperatorProperty", "register_op", "create_operator", "OP_REGISTRY",
           "require_known", "IncompleteShape", "SHARDING_XFER",
           "register_sharding_rule", "sharding_transfer", "contract_sharding",
           "dedup_axes", "reshape_carry", "COST_FLOPS", "register_cost_rule",
           "op_cost"]

OP_REGISTRY = Registry("operator")


def register_op(name, aliases=()):
    """Class decorator: register an OperatorProperty subclass under ``name``."""
    def _wrap(cls):
        cls.op_name = name
        OP_REGISTRY.register(name, cls)
        for a in aliases:
            OP_REGISTRY.register(a, cls)
        return cls
    return _wrap


def create_operator(op_name, **attrs):
    cls = OP_REGISTRY.get(op_name)
    return cls(**attrs)


class IncompleteShape(MXNetError):
    """Raised when infer_shape lacks information (caught by Symbol.infer_shape)."""


def require_known(op_name, in_shapes, arg_names):
    for shape, aname in zip(in_shapes, arg_names):
        if shape is None:
            raise IncompleteShape("%s: shape of input '%s' unknown" % (op_name, aname))
    return in_shapes


class OperatorProperty:
    """Base operator: subclass, set ``param_cls``, implement metadata+forward.

    ``forward(inputs, aux, is_train, rng) -> (outputs, aux_updates)``
    takes and returns torch tensors; ``aux_updates`` is None or aligns
    with ``list_auxiliary_states()``.  ``rng`` is a ``torch.Generator``
    for ops that set ``need_rng`` (the trainer passes its device's), and
    None otherwise.
    """

    op_name = None          # filled by register_op
    need_rng = False        # True: forward draws from ``rng``
    param_cls = None        # optional ParamStruct subclass
    hint = None             # name hint for auto naming (defaults to lowercased op)
    # lowering metadata read by the static analyzer (analysis/lowering.py):
    # host_callback marks ops whose forward round-trips through the host
    # (the CustomOp bridge: it must not sit inside a mirrored segment,
    # whose recompute would run it again); unsupported_platforms lists
    # target platforms ("gpu", "cpu") the op has no implementation for.
    host_callback = False
    unsupported_platforms = ()
    # roofline cost metadata (analysis/roofline.py): ``mxu`` marks the
    # dot/conv class (matrix products; the name is the JAX package's) —
    # the roofline prices their backward as two extra product passes
    # (dgrad + wgrad) where elementwise ops get one.
    mxu = False

    # graph-level attrs that ride on nodes but are not op params
    _SYSTEM_ATTRS = frozenset(
        {"ctx_group", "lr_mult", "wd_mult", "mirror_stage", "force_mirroring"})

    def __init__(self, **attrs):
        self.attrs = {k: str(v) for k, v in attrs.items()}
        fields = self.param_cls._fields if self.param_cls is not None else {}
        unknown = [k for k in attrs
                   if k not in fields and k not in self._SYSTEM_ATTRS
                   and not (k.startswith("__") and k.endswith("__"))]
        if unknown:
            raise MXNetError("%s: unknown arguments %s (valid: %s)"
                             % (type(self).op_name or type(self).__name__,
                                sorted(unknown), sorted(fields)))
        if self.param_cls is not None:
            self.param = self.param_cls.from_attrs(attrs)
        else:
            self.param = None

    # -- metadata ----------------------------------------------------------
    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    @property
    def num_outputs(self):
        return len(self.list_outputs())

    # -- inference ---------------------------------------------------------
    def infer_shape(self, in_shapes):
        """in_shapes: list aligned with list_arguments, entries tuple|None.

        Returns (in_shapes, out_shapes, aux_shapes) with everything known, or
        raises IncompleteShape.  Default: unary-ish same-shape op.
        """
        in_shapes = require_known(self.op_name, in_shapes, self.list_arguments())
        return in_shapes, [in_shapes[0]] * self.num_outputs, []

    def infer_type(self, in_types):
        """Default: all inputs, outputs and aux states take the first
        known input type (None when no input type is known)."""
        known = [t for t in in_types if t is not None]
        base = known[0] if known else None
        return ([base] * len(self.list_arguments()),
                [base] * self.num_outputs,
                [base] * len(self.list_auxiliary_states()))

    # -- SPMD sharding transfer (analysis/propagation.py) ------------------
    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        """Forward PartitionSpec transfer rule, registered alongside the
        lowering metadata above so an op's semantics and its sharding
        behavior live in one place.

        Specs here are NORMALIZED: one entry per dim, each entry a tuple
        of mesh-axis names (``()`` = replicated on that dim).
        ``mesh_shape`` maps axis name -> size.  Returns a dict:

        - ``out``    list of specs, one per output (required);
        - ``in``     required/resolved input layouts (``None`` entries =
          unconstrained).  The propagation pass diffs each actual input
          spec against this: replicated->sharded is a free reslice,
          sharded->replicated is an implicit all-gather (MXL-P002), two
          different axes on one dim is a forced reshard (MXL-P001);
        - ``reduce`` ``{axes: reason}`` — the output is a partial sum
          over those mesh axes (sharded contraction) and XLA inserts the
          matching psum (MXL-P004; audited by MXL-C003);
        - ``notes``  list of dicts ``{kind, arg, axes, message}`` —
          structural findings for the MXL-C pass (``matmul_gather``,
          ``attn_unreduced``).

        Default: dim-for-dim carry from input 0 onto every output where
        the dim size is unchanged; no constraints, no reductions.  Ops
        with real dataflow structure (matmuls, embeddings, reshapes,
        losses) override this next to their shape rules.
        """
        base = in_specs[0] if in_specs else ()
        base_shape = in_shapes[0] if in_shapes else None
        outs = []
        for oshape in out_shapes:
            spec = [()] * len(oshape)
            if base_shape is not None:
                for d in range(min(len(oshape), len(base_shape))):
                    if base[d] and oshape[d] == base_shape[d]:
                        spec[d] = base[d]
            outs.append(tuple(spec))
        return {"out": outs}

    # -- roofline cost hooks (analysis/roofline.py) ------------------------
    def cost_flops(self, in_shapes, out_shapes):
        """Forward-pass FLOP estimate, default one VPU flop per output
        element (the elementwise class).  MXU ops override with their
        matmul arithmetic (2 FLOPs per MAC)."""
        total = 0
        for s in out_shapes:
            n = 1
            for d in s:
                n *= int(d)
            total += n
        return float(total)

    def cost_mxu_dims(self, in_shapes, out_shapes):
        """``(m, k, n)`` triples of the op's matmul(s) as XLA lowers
        them (conv via im2col), or None for non-MXU ops.  The roofline
        pass derives MXU tile padding waste and contraction length
        (bf16 accumulation hazard) from these."""
        return None

    def cost_bytes_elements(self, in_shapes, out_shapes):
        """Elements moved through HBM by one forward pass, default
        sum(inputs) + sum(outputs).  Gather-class ops override (an
        Embedding reads the gathered rows, not the whole table)."""
        total = 0
        for s in list(in_shapes) + list(out_shapes):
            if s is None:
                continue
            n = 1
            for d in s:
                n *= int(d)
            total += n
        return float(total)

    def cost_reduce_len(self, in_shapes, out_shapes):
        """Length of the op's longest sum-accumulation chain (softmax
        denominator, avg-pool window, reduce over an axis), or None.
        Matmul contractions are covered by ``cost_mxu_dims`` ``k``."""
        return None

    # -- compute -----------------------------------------------------------
    def forward(self, inputs, aux, is_train, rng):
        raise NotImplementedError(self.op_name)


# ----------------------------------------------------------------------
# sharding transfer registry: name-keyed rules for ops whose classes are
# factory-generated (elementwise binaries) or live outside ops/ — the
# analyzer resolves SHARDING_XFER first, then the class method.
# ----------------------------------------------------------------------
SHARDING_XFER = {}      # op_name -> fn(op, in_specs, in_shapes, out_shapes, mesh_shape)


def register_sharding_rule(*op_names):
    """Function decorator: register a sharding transfer rule (same
    contract as ``OperatorProperty.infer_sharding``, with the op
    instance as first argument) under one or more op names."""
    def _wrap(fn):
        for n in op_names:
            SHARDING_XFER[n] = fn
        return fn
    return _wrap


def sharding_transfer(op, in_specs, in_shapes, out_shapes, mesh_shape):
    """Resolve and run the transfer rule for one op node."""
    fn = SHARDING_XFER.get(type(op).op_name)
    if fn is not None:
        return fn(op, in_specs, in_shapes, out_shapes, mesh_shape)
    return op.infer_sharding(in_specs, in_shapes, out_shapes, mesh_shape)


# ----------------------------------------------------------------------
# roofline cost registry: name-keyed overrides for ops whose classes are
# factory-generated, mirroring SHARDING_XFER — the analyzer resolves
# COST_FLOPS first, then the class hooks.
# ----------------------------------------------------------------------
COST_FLOPS = {}     # op_name -> fn(op, in_shapes, out_shapes) -> cost dict


def register_cost_rule(*op_names):
    """Function decorator: register a roofline cost rule under one or
    more op names.  The rule returns a dict with any of the ``op_cost``
    keys below; missing keys fall back to the class hooks."""
    def _wrap(fn):
        for n in op_names:
            COST_FLOPS[n] = fn
        return fn
    return _wrap


def op_cost(op, in_shapes, out_shapes):
    """Resolve one op node's roofline cost facts.

    Returns ``{"flops", "bytes_elements", "mxu", "mxu_dims",
    "reduce_len"}`` — forward-pass figures; the roofline pass applies
    the training multipliers."""
    hook = getattr(op, "cost_compute_dtype", None)
    out = {
        "flops": op.cost_flops(in_shapes, out_shapes),
        "bytes_elements": op.cost_bytes_elements(in_shapes, out_shapes),
        "mxu": bool(type(op).mxu),
        "mxu_dims": op.cost_mxu_dims(in_shapes, out_shapes),
        "reduce_len": op.cost_reduce_len(in_shapes, out_shapes),
        # an op whose MXU contraction runs at its own dtype (int8/fp8
        # QuantizedDense) declares it here; None = the graph-wide
        # compute dtype
        "compute_dtype": hook(in_shapes, out_shapes) if hook else None,
    }
    fn = COST_FLOPS.get(type(op).op_name)
    if fn is not None:
        out.update(fn(op, in_shapes, out_shapes) or {})
    return out


def contract_sharding(d_axes, w_axes, d_arg=0, w_arg=1, what="matmul"):
    """Shared contraction-dim classifier for matmul-like transfer rules.

    Both sides sharded over the SAME axes -> sharded contraction: the
    output is a partial sum and XLA inserts the matching psum
    (``reduce``).  One side sharded only -> XLA all-gathers that operand
    before the matmul (a ``matmul_gather`` note, audited by MXL-C003).
    Different axes on the two sides -> irreconcilable: the caller must
    emit a required-spec conflict (``conflict=True`` -> MXL-P001).

    Returns ``(reduce_dict, notes_list, conflict)``.
    """
    d_axes = tuple(d_axes or ())
    w_axes = tuple(w_axes or ())
    if d_axes and d_axes == w_axes:
        return ({d_axes: "%s contraction dim sharded over %s: output is a "
                         "partial sum" % (what, "+".join(d_axes))}, [], False)
    if d_axes and w_axes:
        return {}, [], True
    if d_axes or w_axes:
        arg = d_arg if d_axes else w_arg
        axes = d_axes or w_axes
        note = {"kind": "matmul_gather", "arg": arg, "axes": axes,
                "message": "%s contraction dim sharded over %s on one side "
                           "only: XLA all-gathers the sharded operand before "
                           "the matmul" % (what, "+".join(axes))}
        return {}, [note], False
    return {}, [], False


def dedup_axes(entry, used):
    """Clear ``entry`` when it reuses a mesh axis already spent on another
    dim of the same tensor (a spec may name each axis once)."""
    return () if set(entry or ()) & set(used or ()) else tuple(entry or ())


def reshape_carry(spec, ishape, oshape, mesh_shape):
    """Sharding carry rule for Reshape/Flatten: keep the spec on every
    leading/trailing dim whose size survives the reshape; the merged or
    split middle block keeps its combined axes on its first output dim
    iff the new dim size is still divisible by the axis product (else the
    layout degrades to replicated there)."""
    out = [()] * len(oshape)
    i = 0
    while i < min(len(ishape), len(oshape)) and ishape[i] == oshape[i]:
        out[i] = tuple(spec[i])
        i += 1
    j = 0
    while len(ishape) - 1 - j >= i and len(oshape) - 1 - j >= i and \
            ishape[-1 - j] == oshape[-1 - j]:
        out[len(oshape) - 1 - j] = tuple(spec[len(ishape) - 1 - j])
        j += 1
    mid = []
    for d in range(i, len(ishape) - j):
        mid.extend(spec[d])
    if mid and i < len(oshape) - j:
        prod = 1
        for a in mid:
            prod *= mesh_shape.get(a, 1)
        if oshape[i] % prod == 0:
            out[i] = tuple(mid)
    return tuple(out)


@register_sharding_rule("_Plus", "_Minus", "_Mul", "_Div", "_Power",
                        "_Maximum", "_Minimum", "ElementWiseSum",
                        "element_mask")
def _broadcast_join(op, in_specs, in_shapes, out_shapes, mesh_shape):
    """Elementwise/broadcast ops: each output dim takes the union of the
    (numpy trailing-broadcast) aligned input dims, and every input is
    then required to match the union on its own dims.  A replicated
    input is resliced for free; an input sharded over a *different* axis
    on some dim is the classic implicit-reshard conflict the MXL-P pass
    flags."""
    oshape = out_shapes[0]
    orank = len(oshape)
    joined = [()] * orank
    used = set()
    for spec, shape in zip(in_specs, in_shapes):
        if shape is None:
            continue
        off = orank - len(shape)
        for d, entry in enumerate(spec):
            # a broadcast (size-1) dim carries no sharding
            if not entry or shape[d] == 1:
                continue
            od = off + d
            if not joined[od] and not (set(entry) & used):
                joined[od] = entry
                used.update(entry)
    required = []
    for spec, shape in zip(in_specs, in_shapes):
        if shape is None:
            required.append(None)
            continue
        off = orank - len(shape)
        required.append(tuple(
            joined[off + d] if shape[d] != 1 else ()
            for d in range(len(shape))))
    return {"out": [tuple(joined) for _ in out_shapes], "in": required}
