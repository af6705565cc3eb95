"""Operator registry: metadata + forward functions on torch tensors.

The port's counterpart of ``mxnet_tpu/ops/registry.py`` (the reference's
``OperatorProperty``, ``include/mxnet/operator.h:165-480``).  An operator
is metadata (argument/output/aux names, shape and type inference) plus a
``forward`` on torch tensors.  Backward is autograd through ``forward``
(ops whose reference backward differs, like SoftmaxOutput, wrap a
``torch.autograd.Function``); the static-analysis hooks of the JAX
package (sharding transfer, roofline costs) are not ported.
"""
from __future__ import annotations

from ..base import MXNetError
from ..registry import Registry

__all__ = ["OperatorProperty", "register_op", "create_operator", "OP_REGISTRY",
           "require_known", "IncompleteShape"]

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

    # -- compute -----------------------------------------------------------
    def forward(self, inputs, aux, is_train, rng):
        raise NotImplementedError(self.op_name)
