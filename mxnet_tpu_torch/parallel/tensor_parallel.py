"""Tensor parallelism: values split over a tp group, and the helpers of
the ops' tensor-parallel forms.

The JAX package shards a parameter over the ``tp`` mesh axis with a
GSPMD annotation (``sharding.param_pspec``: axis 0 when it divides,
else axis 1, a divisible 1-D bias, normalization parameters replicated)
and lets XLA divide the work.  The port has no GSPMD, so the walk
divides it: the first member of each tp group walks the graph (as the
first member of an ep group does for MoE), every value outside a split
op stays whole on that member's device, and a split parameter (or a
head-split KV pool) arrives as a :class:`TPShards`, member ``e``'s part
on member ``e``'s device.  An op that reads one runs its
``forward_tp`` (``ops/nn.py``: FullyConnected, QuantizedDense,
Embedding, Convolution; ``ops/tensor.py``: ``expand_dims`` and the
broadcasting binary ops; ``ops/attention.py``: MultiHeadAttention and
CachedMultiHeadAttention over each member's heads): each member
computes its share on its own device from its part, and the shares are
concatenated (:func:`gather`) or summed (:func:`reduce`) onto the first
member under autograd (``collectives.gather_autograd`` and
``all_reduce_autograd``: NCCL between cards, adds and copies on one).

An op that meets a split input and has no tensor-parallel form raises
``MXNetError`` naming the op (:func:`run_tp`): nothing gathers a whole
weight quietly.  Every :func:`gather` and :func:`reduce` whose parts
are a parameter's parts (or views of them) counts a whole-weight gather
in :func:`counts`, which the tp paths hold at 0.
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..base import MXNetError
from . import collectives as _coll

__all__ = ["TPShards", "is_split", "run_tp", "scatter", "split", "gather",
           "reduce", "counts", "reset_counts", "group_of"]

_COUNTS = {"whole_weight_gathers": 0}
#: the parts of every split parameter alive (tensor -> True)
_WEIGHT_PARTS = WeakIdKeyDictionary()


def counts():
    """``{"whole_weight_gathers": n}`` since the last
    :func:`reset_counts`."""
    return dict(_COUNTS)


def reset_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


class TPShards:
    """A value split along ``dim`` over the members of ``group`` (a
    :class:`~.collectives.ReplicaGroup`): ``shards[e]`` lives on
    ``group.devices[e]`` and holds part ``e``.  ``weight`` marks a
    parameter (or a view of one), whose assembly :func:`gather` counts."""

    __slots__ = ("shards", "group", "dim", "weight")

    def __init__(self, shards, group, dim, weight=True):
        self.shards = list(shards)
        self.group = group
        self.dim = int(dim)
        self.weight = bool(weight)
        if len(self.shards) != group.n:
            raise MXNetError("TPShards: %d parts for a tp group of %d"
                             % (len(self.shards), group.n))
        if self.weight:
            for t in self.shards:
                _WEIGHT_PARTS[t] = True

    def map(self, fn, dim=None):
        """The same split with ``fn`` applied to each part (``dim``: the
        split dimension of the result, default unchanged)."""
        return TPShards([fn(s) for s in self.shards], self.group,
                        self.dim if dim is None else dim, self.weight)

    def to(self, *args, **kwargs):
        return self.map(lambda s: s.to(*args, **kwargs))

    def is_floating_point(self):
        return self.shards[0].is_floating_point()

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def shape(self):
        s = list(self.shards[0].shape)
        s[self.dim] *= len(self.shards)
        return tuple(s)

    def bounds(self, e):
        """Part ``e``'s ``[lo, hi)`` along the split dimension."""
        size = self.shards[0].shape[self.dim]
        return e * size, (e + 1) * size

    def __repr__(self):
        return "TPShards(%s split on dim %d over %s)" % (
            self.shape, self.dim, self.group)


def is_split(v):
    return isinstance(v, TPShards)


def group_of(*values):
    """The tp group of the split values among ``values`` (they must
    share one)."""
    groups = [v.group for v in values if isinstance(v, TPShards)]
    g = groups[0]
    for o in groups[1:]:
        if o is not g and o.devices != g.devices:
            raise MXNetError("tensor parallelism: inputs split over two tp "
                             "groups (%s, %s)" % (g, o))
    return g


def run_tp(op, name, ins, aux, is_train, rng):
    """Node ``name``'s forward when an input is a :class:`TPShards`: the
    op's ``forward_tp``, or a raise naming the op when it has none."""
    fwd = getattr(op, "forward_tp", None)
    if fwd is None:
        which = [i for i, v in enumerate(ins) if isinstance(v, TPShards)]
        args = op.list_arguments()
        raise MXNetError(
            "%s (node %s): input %s is split over tp (tensor parallelism) "
            "and %s has no tensor-parallel form; it would have to gather "
            "the whole value.  Replicate the parameter with a "
            "ShardingRules entry, or run without a tp axis"
            % (op.op_name, name,
               ", ".join(args[i] if i < len(args) else str(i)
                         for i in which), op.op_name))
    return fwd(ins, aux, is_train, rng)


def unsupported(op, why):
    return MXNetError("%s: tensor parallelism: %s" % (op, why))


def scatter(group, x):
    """A whole value on the first member's device, on every member's
    device (peer copies between cards, differentiable: the gradients
    come back and add up)."""
    return [_coll.send(x, d) for d in group.devices]


def split(group, x, dim):
    """Member ``e``'s part ``e`` of a whole value along ``dim``, on its
    device."""
    parts = torch.chunk(x, group.n, dim=dim)
    if len(parts) != group.n or parts[0].shape[dim] * group.n \
            != x.shape[dim]:
        raise MXNetError("tensor parallelism: dimension %d (%d) does not "
                         "divide over %d members" % (dim, x.shape[dim],
                                                     group.n))
    return [_coll.send(p, d) for p, d in zip(parts, group.devices)]


def _count_weights(parts):
    if any(p in _WEIGHT_PARTS or (p._base is not None
                                  and p._base in _WEIGHT_PARTS)
           for p in parts):
        _COUNTS["whole_weight_gathers"] += 1


def gather(group, parts, dim):
    """The members' parts concatenated along ``dim`` on the first
    member's device (an activation; the parts of a parameter count as a
    whole-weight gather)."""
    _count_weights(parts)
    return _coll.gather_autograd(group, parts, dim)


def reduce(group, parts):
    """The members' partial results summed on the first member's device
    (on one device, in member order)."""
    _count_weights(parts)
    return _coll.all_reduce_autograd(group, parts)[0]


def columns(parts, width, lo, hi, device):
    """Columns ``[lo, hi)`` of the last dimension of a value whose
    member ``e`` holds columns ``[e * width, (e + 1) * width)`` as
    ``parts[e]``, assembled on ``device`` (peer copies of the slices)."""
    pieces = []
    for e, p in enumerate(parts):
        a, b = max(lo, e * width), min(hi, (e + 1) * width)
        if a < b:
            pieces.append(_coll.send(p[..., a - e * width:b - e * width],
                                     device))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
