"""Tensor operators: Symbol arithmetic and ``expand_dims``.

The port's slice of ``mxnet_tpu/ops/tensor.py``: the elementwise binary
ops ``_Plus``, ``_Minus``, ``_Mul``, ``_Div``, ``_Power``, ``_Maximum``
and ``_Minimum`` with their ``elemwise_*``/``broadcast_*`` aliases (the
training graph broadcasts the position table with ``broadcast_add``),
the ten scalar ops ``_PlusScalar`` ... ``_MinimumScalar`` that
``Symbol``'s operators create (a scalar operand kept in the ``scalar``
attr), and ``expand_dims``.
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

    _Binary.__name__ = "Op" + op_name
    return _Binary


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

    _Reduce.__name__ = "Op" + op_name
    return _Reduce


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
