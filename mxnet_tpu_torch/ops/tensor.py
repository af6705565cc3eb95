"""Tensor operators: Symbol arithmetic, the unary math, reductions and
matrix ops.

The port of ``mxnet_tpu/ops/tensor.py``: the elementwise binary
ops ``_Plus``, ``_Minus``, ``_Mul``, ``_Div``, ``_Power``, ``_Maximum``
and ``_Minimum`` with their ``elemwise_*``/``broadcast_*`` aliases (the
training graph broadcasts the position table with ``broadcast_add``),
the ten scalar ops ``_PlusScalar`` ... ``_MinimumScalar`` that
``Symbol``'s operators create (a scalar operand kept in the ``scalar``
attr), ``expand_dims``, ``transpose`` and the reductions, and the rest
of the JAX file: ``element_mask``, the unary math (``sqrt`` ... ``floor``,
``negative``, the copies), ``smooth_l1``, ``norm``, ``argmax_channel``,
``dot``/``batch_dot`` (``torch.matmul``), ``flip``, ``slice_axis``,
``broadcast_axis``/``broadcast_to``, ``softmax_cross_entropy`` and the
samplers, which draw float32 from the op's ``torch.Generator``.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from .registry import OperatorProperty, register_op, require_known


def _broadcast_shape(a, b):
    try:
        return tuple(_np.broadcast_shapes(a, b))
    except ValueError:
        raise MXNetError("incompatible shapes %s and %s" % (a, b))


def _make_binary(op_name, fn, aliases=()):
    @register_op(op_name, aliases=aliases)
    class _Binary(OperatorProperty):
        hint = op_name.strip("_").lower()

        def list_arguments(self):
            return ["lhs", "rhs"]

        def infer_shape(self, in_shapes):
            lhs, rhs = in_shapes
            if lhs is None and rhs is None:
                require_known(self.op_name, in_shapes, self.list_arguments())
            if lhs is None:
                lhs = rhs
            if rhs is None:
                rhs = lhs
            return [lhs, rhs], [_broadcast_shape(lhs, rhs)], []

        def forward(self, inputs, aux, is_train, rng):
            return [fn(inputs[0], inputs[1])], None

        def forward_tp(self, inputs, aux, is_train, rng):
            return [_binary_tp(self.op_name, fn, inputs[0], inputs[1])], None

        def forward_sp(self, ins, lays, walk):
            return _binary_sp(self.op_name, fn, ins, lays, walk)

    _Binary.__name__ = "Op" + op_name
    return _Binary


def _binary_tp(op_name, fn, lhs, rhs):
    """A broadcasting binary op with an operand split over tp (the LM's
    position table, split on its positions, added to the token rows):
    each member combines its part with its slice of the other operand
    along the split dimension (the whole operand where that dimension
    broadcasts), and the parts of the result are gathered.  Elementwise,
    so the result is the whole op's bit for bit."""
    from ..parallel import tensor_parallel as tp
    a, b = (lhs, rhs) if tp.is_split(lhs) else (rhs, lhs)
    g = a.group
    if tp.is_split(b):
        if b.dim - len(b.shape) != a.dim - len(a.shape) \
                or b.shape[b.dim] != a.shape[a.dim]:
            raise tp.unsupported(op_name, "two operands split on "
                                 "different dimensions")
        others = b.shards
    else:
        nd = max(len(a.shape), b.dim())
        d = a.dim + nd - len(a.shape)         # in the result's dims
        bd = d - (nd - b.dim())
        if bd >= 0 and b.shape[bd] != 1:
            others = tp.split(g, b, bd)
        else:
            others = tp.scatter(g, b)
    parts = []
    for e in range(g.n):
        x, y = (a.shards[e], others[e]) if a is lhs \
            else (others[e], a.shards[e])
        parts.append(fn(x, y))
    nd = parts[0].dim()
    return tp.gather(g, parts, a.dim + nd - len(a.shape))


def _binary_sp(op_name, fn, ins, lays, walk):
    """A broadcasting binary op with an operand split over sp
    (``parallel/sequence_parallel.py``): two split operands combine
    member by member; a replicated operand that spans the whole sequence
    (the LM's position table, broadcast over the batch) gives each
    member the rows of its own positions, so the table's gradient is
    each member's rows and sums over the members as a replicated
    parameter's does.  Elementwise, so the result is the whole op's bit
    for bit."""
    from ..parallel import sequence_parallel as sp
    la, lb = lays
    a, b = ins[0]
    nd = max(a.dim(), b.dim())
    if la is not None and lb is not None:
        if a.shape != b.shape or la != lb:
            raise sp.unsupported(op_name, "two operands split over sp "
                                 "differently: %s and %s"
                                 % (tuple(a.shape), tuple(b.shape)))
        return [[fn(x, y)] for x, y in ins], [la]
    first = la is not None
    x, y = (a, b) if first else (b, a)
    j = la if first else lb
    jr = j + nd - x.dim()
    bd = jr - (nd - y.dim())
    if bd >= 0 and y.shape[bd] != 1 and x.shape[j] != walk.chunk:
        raise sp.unsupported(op_name, "a replicated operand against rows "
                             "that merge the batch with the sequence")
    outs = []
    for r, (u, v) in enumerate(ins):
        if first:
            v = sp.slice_rows(walk, r, v, bd)
        else:
            u = sp.slice_rows(walk, r, u, bd)
        outs.append([fn(u, v)])
    return outs, [jr]


_make_binary("_Plus", torch.add,
             aliases=("elemwise_add", "broadcast_plus", "broadcast_add"))
_make_binary("_Minus", torch.sub,
             aliases=("elemwise_sub", "broadcast_minus", "broadcast_sub"))
_make_binary("_Mul", torch.mul, aliases=("elemwise_mul", "broadcast_mul"))
_make_binary("_Div", torch.div, aliases=("elemwise_div", "broadcast_div"))
_make_binary("_Power", torch.pow, aliases=("broadcast_power",))
_make_binary("_Maximum", torch.maximum, aliases=("broadcast_maximum",))
_make_binary("_Minimum", torch.minimum, aliases=("broadcast_minimum",))


# ----------------------------------------------------------------------
# scalar variants (the scalar rides in the node's attrs)
# ----------------------------------------------------------------------
class _ScalarParam(ParamStruct):
    scalar = Field(float, required=True, doc="scalar operand")


def _snake(name):
    """_DivScalar -> _div_scalar, _RDivScalar -> _rdiv_scalar (the
    reference's imperative registration names)."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper():
            if i > 1 and not name[i - 1].isupper():
                out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _make_scalar(op_name, fn):
    @register_op(op_name, aliases=(_snake(op_name),))
    class _Scalar(OperatorProperty):
        param_cls = _ScalarParam
        hint = op_name.strip("_").lower()

        def infer_shape(self, in_shapes):
            require_known(self.op_name, in_shapes, self.list_arguments())
            return in_shapes, [in_shapes[0]], []

        def forward(self, inputs, aux, is_train, rng):
            # the scalar in the input's dtype first, as jnp.asarray(s,
            # x.dtype) rounds it (a Python float would stay exact in a
            # bfloat16 op)
            x = inputs[0]
            s = torch.tensor(self.param.scalar, dtype=x.dtype,
                             device=x.device)
            return [fn(x, s)], None

    _Scalar.__name__ = "Op" + op_name
    return _Scalar


_make_scalar("_PlusScalar", torch.add)
_make_scalar("_MinusScalar", torch.sub)
_make_scalar("_RMinusScalar", lambda x, s: torch.sub(s, x))
_make_scalar("_MulScalar", torch.mul)
_make_scalar("_DivScalar", torch.div)
# s / x divides (a multiply by the reciprocal rounds differently)
_make_scalar("_RDivScalar", lambda x, s: torch.div(s, x))
_make_scalar("_PowerScalar", torch.pow)
_make_scalar("_RPowerScalar", lambda x, s: torch.pow(s, x))
_make_scalar("_MaximumScalar", torch.maximum)
_make_scalar("_MinimumScalar", torch.minimum)


class _ExpandDimsParam(ParamStruct):
    axis = Field(int, required=True)


@register_op("expand_dims")
class ExpandDims(OperatorProperty):
    """Insert a size-1 axis at ``axis`` (negative counts from the end of
    the output shape)."""
    param_cls = _ExpandDimsParam

    def infer_shape(self, in_shapes):
        require_known("expand_dims", in_shapes, self.list_arguments())
        s = list(in_shapes[0])
        ax = self.param.axis
        if ax < 0:
            ax += len(s) + 1
        s.insert(ax, 1)
        return in_shapes, [tuple(s)], []

    def forward(self, inputs, aux, is_train, rng):
        return [torch.unsqueeze(inputs[0], self.param.axis)], None

    def forward_tp(self, inputs, aux, is_train, rng):
        """A split value stays split: each part gains the axis, and the
        split dimension moves past it."""
        x = inputs[0]
        ax = self.param.axis
        if ax < 0:
            ax += len(x.shape) + 1
        return [x.map(lambda t: torch.unsqueeze(t, ax),
                      dim=x.dim + (1 if ax <= x.dim else 0))], None

    def forward_sp(self, ins, lays, walk):
        """A value split over sp stays split: each member's block gains
        the axis, and the sequence dimension moves past it."""
        ax = self.param.axis
        if ax < 0:
            ax += ins[0][0].dim() + 1
        return ([[torch.unsqueeze(x[0], ax)] for x in ins],
                [lays[0] + (1 if ax <= lays[0] else 0)])


# ----------------------------------------------------------------------
# reductions (broadcast_reduce_op-inl.h)
# ----------------------------------------------------------------------
class _ReduceParam(ParamStruct):
    axis = Field(tuple, default=None, doc="axes to reduce; None = all")
    keepdims = Field(bool, default=False)


def _reduced_shape(shape, axis, keepdims):
    if axis is None:
        return (1,) if not keepdims else (1,) * len(shape)
    axes = set(a % len(shape) for a in axis)
    out = []
    for i, s in enumerate(shape):
        if i in axes:
            if keepdims:
                out.append(1)
        else:
            out.append(s)
    return tuple(out) if out else (1,)


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim if dim is not None else (), keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim if dim is not None else (), keepdim=keepdim)


def _sum(x, dim, keepdim):
    if dim is None:
        return torch.sum(x).reshape((1,) * x.dim() if keepdim else ())
    return torch.sum(x, dim=dim, keepdim=keepdim)


def _make_reduce(op_name, fn, aliases=()):
    @register_op(op_name, aliases=aliases)
    class _Reduce(OperatorProperty):
        """A reduction over ``axis`` (all axes when None); reducing every
        axis without ``keepdims`` gives shape (1,), as the reference."""
        param_cls = _ReduceParam
        hint = op_name.lower()

        def infer_shape(self, in_shapes):
            require_known(self.op_name, in_shapes, self.list_arguments())
            p = self.param
            return in_shapes, [_reduced_shape(in_shapes[0], p.axis,
                                              p.keepdims)], []

        def forward(self, inputs, aux, is_train, rng):
            p = self.param
            axis = tuple(p.axis) if p.axis is not None else None
            out = fn(inputs[0], axis, p.keepdims)
            if axis is None and not p.keepdims:
                out = out.reshape((1,))
            return [out], None

        def forward_replicas(self, ins, aux, is_train, rngs, group):
            """Over the batch axis of a batch split across replicas: the
            reduction of every replica's rows, the same on each
            (:func:`_reduce_over_replicas`)."""
            p = self.param
            nd = ins[0][0].dim()
            if p.axis is not None and 0 not in {a % nd for a in p.axis}:
                return None
            outs = _reduce_over_replicas(
                op_name, [self.forward(i, None, is_train, None)[0][0]
                          if op_name == "sum" else i[0] for i in ins],
                p.axis, p.keepdims, group, self)
            return [[o] for o in outs], None, True

        def cost_reduce_len(self, in_shapes, out_shapes):
            if op_name != "sum":    # max/min accumulate exactly
                return None
            nin = int(_np.prod(in_shapes[0], dtype=_np.int64))
            nout = int(_np.prod(out_shapes[0], dtype=_np.int64))
            return max(1, nin // max(1, nout))

    _Reduce.__name__ = "Op" + op_name
    return _Reduce


class _ReplicaChooser(torch.autograd.Function):
    """The max (or min) over every replica's rows, the reduced axes kept:
    ``apply(group, op_name, axes, *xs)``.  The backward gives the
    replicas' summed gradient to the positions equal to the result,
    split evenly over all of them on every replica (``jnp.max``'s
    rule)."""

    @staticmethod
    def forward(ctx, group, op_name, axes, *xs):
        from ..parallel.collectives import all_gather, all_reduce
        fn = torch.amax if op_name == "max" else torch.amin
        locs = [fn(x, dim=axes, keepdim=True) for x in xs]
        shape = (group.world,) + tuple(locs[0].shape)
        best = [fn(g.reshape(shape), dim=0) for g in
                all_gather(group, [l.reshape(-1) for l in locs])]
        masks = [(x == b).to(x.dtype) for x, b in zip(xs, best)]
        ctx.group, ctx.masks = group, masks
        ctx.counts = all_reduce(group, [torch.sum(m, dim=axes, keepdim=True)
                                        for m in masks])
        return tuple(best)

    @staticmethod
    def backward(ctx, *gs):
        from ..parallel.collectives import all_reduce
        total = all_reduce(ctx.group, [g.contiguous() for g in gs])
        return (None, None, None) + tuple(
            m * (t / c) for m, t, c in zip(ctx.masks, total, ctx.counts))


def _reduce_over_replicas(op_name, xs, axis, keepdims, group, op):
    """``sum``/``max``/``min`` over ``axis`` (0 among them, or all) of a
    batch split across replicas.  ``sum`` is each replica's own sum
    (``xs``) summed over the replicas; the chooser reduces with the axes
    kept, then drops them as the op does."""
    from ..parallel.collectives import all_reduce_autograd
    if op_name == "sum":
        return all_reduce_autograd(group, xs)
    nd = xs[0].dim()
    axes = tuple(range(nd)) if axis is None else \
        tuple(sorted({a % nd for a in axis}))
    kept = _ReplicaChooser.apply(group, op_name, axes, *xs)
    want = _reduced_shape(tuple(xs[0].shape), axis, keepdims)
    return [k.reshape(want) for k in kept]


_make_reduce("sum", _sum, aliases=("sum_axis",))
_make_reduce("max", _amax, aliases=("max_axis",))
_make_reduce("min", _amin, aliases=("min_axis",))


class _TransposeParam(ParamStruct):
    axes = Field(tuple, default=None)


@register_op("transpose")
class Transpose(OperatorProperty):
    """The axes permuted by ``axes`` (reversed when None)."""
    param_cls = _TransposeParam

    def _axes(self, ndim):
        return tuple(self.param.axes) if self.param.axes \
            else tuple(reversed(range(ndim)))

    def infer_shape(self, in_shapes):
        require_known("transpose", in_shapes, self.list_arguments())
        s = in_shapes[0]
        return in_shapes, [tuple(s[a] for a in self._axes(len(s)))], []

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        return [x.permute(self._axes(x.dim()))], None


@register_op("element_mask")
class ElementMask(OperatorProperty):
    """broadcast_mask_op-inl.h:84: rhs (1-D, len == lhs.shape[0]) masks
    lhs row-wise, out[i, ...] = lhs[i, ...] * rhs[i]; the mask carries no
    gradient."""

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        lhs, rhs = in_shapes
        if lhs is None:
            require_known(self.op_name, in_shapes, self.list_arguments())
        if len(lhs) < 2:
            raise MXNetError("element_mask: lhs must be 2-D or more, got %s"
                             % (lhs,))
        if rhs is not None and (len(rhs) != 1 or rhs[0] != lhs[0]):
            raise MXNetError(
                "element_mask: rhs must be 1-D of length lhs.shape[0]=%d, "
                "got %s" % (lhs[0], rhs))
        return [lhs, (lhs[0],)], [lhs], []

    def forward(self, inputs, aux, is_train, rng):
        lhs, rhs = inputs
        mask = rhs.detach().reshape((lhs.shape[0],) + (1,) * (lhs.dim() - 1))
        return [lhs * mask.to(lhs.dtype)], None


# ----------------------------------------------------------------------
# unary math (src/ndarray/unary_function-inl.h)
# ----------------------------------------------------------------------
def _make_unary(op_name, fn, aliases=()):
    @register_op(op_name, aliases=aliases)
    class _Unary(OperatorProperty):
        hint = op_name.strip("_").lower()

        def forward(self, inputs, aux, is_train, rng):
            return [fn(inputs[0])], None

    _Unary.__name__ = "Op" + op_name
    return _Unary


_make_unary("sqrt", torch.sqrt)
# a division, as the JAX package's 1 / sqrt(x) (torch.rsqrt rounds apart)
_make_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_make_unary("exp", torch.exp)
_make_unary("log", torch.log)
_make_unary("cos", torch.cos)
_make_unary("sin", torch.sin)
_make_unary("abs", torch.abs)
_make_unary("sign", torch.sign)
_make_unary("round", torch.round)       # half to even, as jnp.round
_make_unary("ceil", torch.ceil)
_make_unary("floor", torch.floor)
_make_unary("square", torch.square)
_make_unary("negative", torch.neg, aliases=("_Negative",))
_make_unary("_copy", torch.clone, aliases=("identity",))
# cross_device_copy.cc: the copy to the node's context; on one device, a
# copy
_make_unary("_CrossDeviceCopy", torch.clone)


class _SmoothL1Param(ParamStruct):
    scalar = Field(float, default=1.0, doc="sigma of the smooth-l1 transition")


@register_op("smooth_l1")
class SmoothL1(OperatorProperty):
    """smooth_l1_unary-inl.h (Faster R-CNN's bbox loss): 0.5 (sigma x)^2
    inside |x| < 1 / sigma^2, |x| - 0.5 / sigma^2 outside."""
    param_cls = _SmoothL1Param

    def forward(self, inputs, aux, is_train, rng):
        sigma2 = self.param.scalar ** 2
        x = inputs[0]
        out = torch.where(torch.abs(x) < 1.0 / sigma2,
                          0.5 * sigma2 * torch.square(x),
                          torch.abs(x) - 0.5 / sigma2)
        return [out], None


@register_op("norm")
class Norm(OperatorProperty):
    """The L2 norm of all values, shape (1,)."""

    def infer_shape(self, in_shapes):
        require_known("norm", in_shapes, self.list_arguments())
        return in_shapes, [(1,)], []

    def forward(self, inputs, aux, is_train, rng):
        norm = torch.sqrt(torch.sum(torch.square(inputs[0])))
        return [norm.reshape((1,))], None

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """Over every replica's rows: the squares summed over the
        replicas, then the root."""
        from ..parallel.collectives import all_reduce_autograd
        sums = all_reduce_autograd(
            group, [torch.sum(torch.square(i[0])).reshape((1,))
                    for i in ins])
        return [[torch.sqrt(s)] for s in sums], None, True

    def cost_reduce_len(self, in_shapes, out_shapes):
        return int(_np.prod(in_shapes[0], dtype=_np.int64))


@register_op("argmax_channel")
class ArgmaxChannel(OperatorProperty):
    """The index of the largest value along axis 1 (the first of ties),
    in the input's dtype."""

    def infer_shape(self, in_shapes):
        require_known("argmax_channel", in_shapes, self.list_arguments())
        return in_shapes, [(in_shapes[0][0],)], []

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        return [torch.argmax(x, dim=1).to(x.dtype)], None


# ----------------------------------------------------------------------
# matrix ops (matrix_op-inl.h)
# ----------------------------------------------------------------------
class _DotParam(ParamStruct):
    transpose_a = Field(bool, default=False)
    transpose_b = Field(bool, default=False)


@register_op("dot")
class Dot(OperatorProperty):
    """The matrix product of 2-D operands (``torch.matmul``, cuBLAS on
    the card), either transposed first."""
    param_cls = _DotParam
    mxu = True

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        require_known("dot", in_shapes, self.list_arguments())
        (a, b) = in_shapes
        p = self.param
        m = a[1] if p.transpose_a else a[0]
        ka = a[0] if p.transpose_a else a[1]
        kb = b[1] if p.transpose_b else b[0]
        n = b[0] if p.transpose_b else b[1]
        if ka != kb:
            raise MXNetError("dot shape mismatch %s x %s" % (a, b))
        return in_shapes, [(m, n)], []

    def forward(self, inputs, aux, is_train, rng):
        a, b = inputs
        if self.param.transpose_a:
            a = a.t()
        if self.param.transpose_b:
            b = b.t()
        return [torch.matmul(a, b)], None

    def cost_mxu_dims(self, in_shapes, out_shapes):
        a = in_shapes[0]
        m, n = out_shapes[0]
        k = a[0] if self.param.transpose_a else a[1]
        return [(int(m), int(k), int(n))]

    def cost_flops(self, in_shapes, out_shapes):
        (m, k, n), = self.cost_mxu_dims(in_shapes, out_shapes)
        return float(2 * m * k * n)


@register_op("batch_dot")
class BatchDot(OperatorProperty):
    """The product of each pair of (B, m, k) and (B, k, n) matrices."""
    param_cls = _DotParam
    mxu = True

    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        require_known("batch_dot", in_shapes, self.list_arguments())
        a, b = in_shapes
        at = (a[0], a[2], a[1]) if self.param.transpose_a else a
        bt = (b[0], b[2], b[1]) if self.param.transpose_b else b
        return in_shapes, [(at[0], at[1], bt[2])], []

    def forward(self, inputs, aux, is_train, rng):
        a, b = inputs
        if self.param.transpose_a:
            a = torch.transpose(a, 1, 2)
        if self.param.transpose_b:
            b = torch.transpose(b, 1, 2)
        return [torch.matmul(a, b)], None

    def cost_mxu_dims(self, in_shapes, out_shapes):
        a = in_shapes[0]
        _batch, m, n = out_shapes[0]
        k = a[1] if self.param.transpose_a else a[2]
        return [(int(m), int(k), int(n))]

    def cost_flops(self, in_shapes, out_shapes):
        batch = out_shapes[0][0]
        (m, k, n), = self.cost_mxu_dims(in_shapes, out_shapes)
        return float(2 * batch * m * k * n)


class _FlipParam(ParamStruct):
    axis = Field(int, required=True)


@register_op("flip")
class Flip(OperatorProperty):
    param_cls = _FlipParam

    def forward(self, inputs, aux, is_train, rng):
        return [torch.flip(inputs[0], (self.param.axis,))], None


class _SliceAxisParam(ParamStruct):
    axis = Field(int, required=True)
    begin = Field(int, required=True)
    end = Field(int, default=None, doc="None/0 means to the end")


@register_op("slice_axis")
class SliceAxis(OperatorProperty):
    """``[begin, end)`` along ``axis``; negative bounds count from the
    end, an ``end`` of None or 0 means the end."""
    param_cls = _SliceAxisParam

    def _resolve(self, dim):
        p = self.param
        begin = p.begin if p.begin >= 0 else p.begin + dim
        end = p.end
        if end is None or end == 0:
            end = dim
        elif end < 0:
            end += dim
        return begin, end

    def infer_shape(self, in_shapes):
        require_known("slice_axis", in_shapes, self.list_arguments())
        s = list(in_shapes[0])
        begin, end = self._resolve(s[self.param.axis])
        s[self.param.axis] = end - begin
        return in_shapes, [tuple(s)], []

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        begin, end = self._resolve(x.shape[self.param.axis])
        return [torch.narrow(x, self.param.axis, begin, end - begin)], None


class _BroadcastAxisParam(ParamStruct):
    axis = Field(tuple, default=())
    size = Field(tuple, default=())


@register_op("broadcast_axis")
class BroadcastAxis(OperatorProperty):
    """Size-1 axes ``axis`` broadcast to ``size``."""
    param_cls = _BroadcastAxisParam

    def _target(self, shape):
        s = list(shape)
        for ax, sz in zip(self.param.axis, self.param.size):
            s[ax] = sz
        return tuple(s)

    def infer_shape(self, in_shapes):
        require_known("broadcast_axis", in_shapes, self.list_arguments())
        return in_shapes, [self._target(in_shapes[0])], []

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        return [torch.broadcast_to(x, self._target(x.shape))], None


class _BroadcastToParam(ParamStruct):
    shape = Field(tuple, required=True)


@register_op("broadcast_to")
class BroadcastTo(OperatorProperty):
    """Broadcast to ``shape``, whose 0 entries keep the input's axis."""
    param_cls = _BroadcastToParam

    def _target(self, shape):
        return tuple(d if t == 0 else t
                     for d, t in zip(shape, self.param.shape))

    def infer_shape(self, in_shapes):
        require_known("broadcast_to", in_shapes, self.list_arguments())
        return in_shapes, [self._target(in_shapes[0])], []

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        return [torch.broadcast_to(x, self._target(x.shape))], None


# ----------------------------------------------------------------------
# softmax_cross_entropy (a loss as a simple op)
# ----------------------------------------------------------------------
@register_op("softmax_cross_entropy")
class SoftmaxCrossEntropy(OperatorProperty):
    """The summed negative log-likelihood of the labels under the
    softmax of the last axis, shape (1,)."""

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data, label = in_shapes
        if data is None:
            require_known("softmax_cross_entropy", in_shapes,
                          self.list_arguments())
        if label is None:
            label = (data[0],)
        return [data, label], [(1,)], []

    def forward(self, inputs, aux, is_train, rng):
        logits, label = inputs
        logp = torch.log_softmax(logits, dim=-1)
        lab = label.detach().to(torch.int64)
        nll = -torch.gather(logp, -1, lab[:, None])
        return [torch.sum(nll).reshape((1,))], None

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """Summed over every replica's rows."""
        from ..parallel.collectives import all_reduce_autograd
        local = [self.forward(i, None, is_train, None)[0][0] for i in ins]
        return [[s] for s in all_reduce_autograd(group, local)], None, True


# ----------------------------------------------------------------------
# samplers (need_rng): _sample_uniform / _sample_normal
# ----------------------------------------------------------------------
def _draw(rng, shape, what):
    if rng is None:
        raise MXNetError("%s: needs a generator (the executor hands the "
                         "device's to a graph that declares need_rng)"
                         % what)
    return torch.empty(tuple(int(d) for d in shape), dtype=torch.float32,
                       device=rng.device)


class _SampleUniformParam(ParamStruct):
    low = Field(float, default=0.0)
    high = Field(float, default=1.0)
    shape = Field(tuple, required=True)


@register_op("_sample_uniform", aliases=("uniform",))
class SampleUniform(OperatorProperty):
    """Uniform draws on [low, high) of ``shape`` (float32) from the
    op's generator, on the generator's device."""
    param_cls = _SampleUniformParam
    need_rng = True

    def list_arguments(self):
        return []

    def infer_shape(self, in_shapes):
        return [], [tuple(self.param.shape)], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        out = _draw(rng, p.shape, "_sample_uniform")
        return [out.uniform_(p.low, p.high, generator=rng)], None


class _SampleNormalParam(ParamStruct):
    loc = Field(float, default=0.0)
    scale = Field(float, default=1.0)
    shape = Field(tuple, required=True)


@register_op("_sample_normal", aliases=("normal",))
class SampleNormal(OperatorProperty):
    """Normal draws of mean ``loc`` and deviation ``scale`` of ``shape``
    (float32) from the op's generator, on the generator's device."""
    param_cls = _SampleNormalParam
    need_rng = True

    def list_arguments(self):
        return []

    def infer_shape(self, in_shapes):
        return [], [tuple(self.param.shape)], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        out = _draw(rng, p.shape, "_sample_normal")
        return [p.loc + p.scale * out.normal_(generator=rng)], None
