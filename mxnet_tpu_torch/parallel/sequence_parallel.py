"""Sequence parallelism: the lockstep walk over a sequence split across
the members of an ``sp`` mesh axis.

The JAX package shards the batch's sequence axis over ``sp`` with a
GSPMD annotation and lets XLA divide the work; ``MultiHeadAttention``
lowers to the ring (``ring_attention.sharded_self_attention`` under
``shard_map``).  The port has no GSPMD, so the walk divides it: every
member of a dp x sp mesh walks the graph on its own ``(B/dp, S/sp)``
block of the batch (``executor``'s ``trace_replicas`` with a
:class:`SeqWalk`), and the walk keeps, for each value, where the
sequence lies in it:

- a replicated value (a parameter, what is made from parameters only)
  is whole on every member;
- a value split over sp holds, in its local dimension ``j``, ``k`` runs
  of the member's ``S/sp`` positions (``k`` rows of the batch merged
  with the sequence, as a ``(B*S, E)`` reshape merges them), and per
  token features after ``j``.  Flattened, each dp part of its global
  value is ``(pre, S, post)`` and the member holds the ``(pre, S/sp,
  post)`` block of its sp index.

An op that meets a value split over sp has three cases:

1. it is per token (:data:`PER_TOKEN`: Embedding, LayerNorm,
   FullyConnected on rows, the activations, the scalar and unary ops,
   Dropout, Cast, the loss head's rows through its ``forward_replicas``,
   whose normalizers sum over every member): each member runs it on its
   block, and a rule says where the sequence lies in its output;
2. it has an sp form (``forward_sp``: ``expand_dims`` and the
   broadcasting binary ops of ``ops/tensor.py``, which read the
   member's rows of a replicated table such as the LM's position table;
   ``Reshape`` of ``ops/nn.py``, whose target names the whole sequence)
   or runs across the ring (``MultiHeadAttention.forward_replicas``:
   ring attention over the sp members of each dp replica);
3. or :func:`run_sp` raises ``MXNetError`` naming the op, as
   ``tensor_parallel.run_tp`` does for tp: nothing gathers a whole
   sequence quietly.

The replicated parameters' gradients are each member's share; the
trainer sums them over every dp x sp member (``overlap.GradBuckets``).
"""
from __future__ import annotations

import math

from ..base import MXNetError

__all__ = ["SeqWalk", "PER_TOKEN", "run_sp", "unsupported"]


def unsupported(op, why):
    return MXNetError("%s: sequence parallelism: %s" % (op, why))


class SeqWalk:
    """The sequence-parallel side of one lockstep walk over ``mesh``'s
    members (walk position = member index).

    ``seq_len``: the whole sequence; ``seq_dims``: for each input split
    over sp, its dimension holding the sequence.  After the walk,
    :attr:`head_dims` holds each head's sequence dimension (None for a
    replicated head)."""

    def __init__(self, mesh, seq_len, seq_dims, seq_axis="sp"):
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.n = int(mesh.shape[seq_axis])
        self.seq_len = int(seq_len)
        if self.seq_len % self.n:
            raise MXNetError("sequence parallelism: a sequence of %d does "
                             "not divide over sp=%d" % (self.seq_len, self.n))
        self.chunk = self.seq_len // self.n
        self.seq_dims = dict(seq_dims)
        self.index = [mesh.coords(r)[seq_axis]
                      for r in range(len(mesh.devices))]
        self.head_dims = None

    def rows(self, r):
        """Member ``r``'s ``[lo, hi)`` of the sequence."""
        lo = self.index[r] * self.chunk
        return lo, lo + self.chunk

    def post(self, t, j):
        """The per token elements of a value split at dimension ``j``."""
        return math.prod(t.shape[j + 1:])

    def runs(self, t, j):
        """``(pre, post)`` of a member's block: its rows before the
        sequence (the batch, with any runs merged into dimension ``j``)
        and its elements after."""
        return math.prod(t.shape[:j]) * (t.shape[j] // self.chunk), \
            self.post(t, j)


def _same(op, lays, ins):
    """Elementwise on one input: the sequence stays where it is."""
    return [lays[0]] * len(op.list_outputs())


def _embedding(op, lays, ins):
    return [lays[0]]


def _layer_norm(op, lays, ins):
    j, nd = lays[0], ins[0].dim()
    ax = op.param.axis % nd
    if ax == j:
        raise unsupported(op.op_name, "normalizing over the sequence axis")
    return [j]


def _dense(op, lays, ins):
    """FullyConnected flattens all but axis 0: the rows must carry the
    sequence (a ``Reshape`` to ``(-1, dim)`` first, as the LM does)."""
    if lays[0] != 0 or any(l is not None for l in lays[1:]):
        raise unsupported(op.op_name, "the data must be rows of tokens "
                          "(the sequence in axis 0) and the weight whole")
    return [0]


def _rows(op, lays, ins):
    """A loss head over rows of tokens and their labels."""
    if getattr(op.param, "multi_output", False) or lays[0] != 0 \
            or lays[1] != 0:
        raise unsupported(op.op_name, "the data and the label must be rows "
                          "of tokens (the sequence in axis 0)")
    return [0]


def _attention(op, lays, ins):
    if ins[0].dim() != 3 or lays[0] != 1 \
            or any(l is not None for l in lays[1:]):
        raise unsupported(op.op_name, "the data must be (B, S, E) with the "
                          "sequence in axis 1 and the weights whole")
    return [1]


#: the ops that are per token under sequence parallelism, and the rule
#: that checks the input layout and gives the output's
PER_TOKEN = {
    "Activation": _same, "Dropout": _same, "Cast": _same, "BlockGrad": _same,
    "_copy": _same, "sqrt": _same, "rsqrt": _same, "exp": _same,
    "log": _same, "abs": _same, "square": _same, "negative": _same,
    "_PlusScalar": _same, "_MinusScalar": _same, "_RMinusScalar": _same,
    "_MulScalar": _same, "_DivScalar": _same, "_RDivScalar": _same,
    "_PowerScalar": _same, "_RPowerScalar": _same, "_MaximumScalar": _same,
    "_MinimumScalar": _same,
    "Embedding": _embedding, "LayerNorm": _layer_norm,
    "FullyConnected": _dense, "SoftmaxOutput": _rows,
    "MultiHeadAttention": _attention,
}


def run_sp(op, name, ins, lays, aux, is_train, rngs, group, fwd, scope,
           walk):
    """Node ``name``'s forward when an input is split over sp:
    ``(outs, updates, replicated, out_lays)`` a member each.  ``ins``:
    each member's inputs; ``lays``: each input's sequence dimension
    (None: replicated); ``fwd``: the node's forward on one member."""
    n = len(ins)
    sp_form = getattr(op, "forward_sp", None)
    if sp_form is not None:
        outs, out_lays = sp_form(ins, lays, walk)
        return outs, None, False, out_lays
    rule = PER_TOKEN.get(op.op_name)
    if rule is None:
        which = [i for i, l in enumerate(lays) if l is not None]
        args = op.list_arguments()
        raise MXNetError(
            "%s (node %s): input %s is split over sp (sequence "
            "parallelism) and %s has no sequence-parallel form; it would "
            "have to gather the whole sequence.  Run it without an sp axis"
            % (op.op_name, name,
               ", ".join(args[i] if i < len(args) else str(i)
                         for i in which), op.op_name))
    out_lays = rule(op, lays, ins[0])
    got = None
    if hasattr(op, "forward_replicas"):
        got = op.forward_replicas(ins, aux, is_train, rngs, group)
    if got is not None:
        return got[0], got[1], False, out_lays
    outs, updates = [], []
    for r in range(n):
        with scope(r):
            o, u = fwd(ins[r], aux[r], is_train, rngs[r])
        outs.append(o)
        updates.append(u)
    return outs, updates, False, out_lays


def reshape_target(op, x, j, walk):
    """``Reshape``'s target on member block ``x`` (the sequence in its
    dimension ``j``): a target entry equal to the whole sequence, with
    exactly the block's per token elements after it, becomes the
    member's ``S/sp``; the result must keep the sequence whole in one
    dimension with the same per token elements after it."""
    post = walk.post(x, j)
    p = op.param
    shape = None
    if p.shape is not None:
        shape = list(p.shape)
        for i, s in enumerate(shape):
            after = [x.shape[i + 1 + a] if v == 0 else v
                     for a, v in enumerate(shape[i + 1:])]
            if s == walk.seq_len and -1 not in after \
                    and math.prod(after) == post:
                shape[i] = walk.chunk
    out = op._target(tuple(x.shape), shape)
    for jo in range(len(out) - 1, -1, -1):
        if math.prod(out[jo + 1:]) == post and out[jo] % walk.chunk == 0 \
                and out[jo] > 0:
            return out, jo
    raise unsupported(op.op_name, "reshape %s -> %s mixes the sequence "
                      "with the features" % (tuple(x.shape), out))


def slice_rows(walk, r, b, bd):
    """Member ``r``'s rows of a replicated operand ``b`` whose dimension
    ``bd`` spans the whole sequence (the LM's position table), or ``b``
    itself where that dimension broadcasts."""
    if bd < 0 or b.shape[bd] == 1:
        return b
    if b.shape[bd] != walk.seq_len:
        raise unsupported("broadcast", "a replicated operand of %s against "
                          "a sequence split over sp: its dimension %d is "
                          "neither 1 nor the sequence (%d)"
                          % (tuple(b.shape), bd, walk.seq_len))
    lo, _hi = walk.rows(r)
    return b.narrow(bd, lo, walk.chunk)
