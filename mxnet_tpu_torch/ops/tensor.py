"""Elementwise tensor operators used by the generation graphs.

The port's slice of ``mxnet_tpu/ops/tensor.py``: ``_Plus`` and its
aliases (``Symbol.__add__`` builds it).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
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
