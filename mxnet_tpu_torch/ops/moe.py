"""Mixture-of-Experts FFN, and its expert-parallel forms.

The port of ``mxnet_tpu/ops/moe.py``.  The ``MoE`` op (alias
``SwitchFFN``) is the JAX package's *dense* formulation: every expert
computes every token and the routing mask selects (the einsums are
plain ``torch.einsum`` products, as XLA carries them there).  Routing is
softmax gating, top-1 by ``argmax`` or top-k with ties taken at the
lowest expert index first (``lax.top_k``'s order; a stable descending
sort gives it), and an optional ``capacity_factor``: each expert takes at
most ``ceil(cf * T * top_k / K)`` tokens in token order, and the rest
are dropped from it.  The mask carries no gradient; the gate's gradient
flows through the probabilities, as in JAX.  The second output is the
load-balance aux loss (Switch eq. 4).  The queue positions are counted
in integers, so they stay exact at any compute dtype.

Under data parallelism (the lockstep walk's :meth:`MoE.forward_replicas`)
each replica holds only its own tokens, while the JAX op's ``cumsum`` and
means run over the whole logical batch.  So each replica adds to its
queue positions the exclusive prefix of the per-expert counts of the
replicas before it (``collectives.all_gather``, in replica order), and
the aux loss's means are summed over the replicas: ``dp=2`` drops the
tokens ``dp=1`` drops.

Under expert parallelism an expert stack arrives as an
:class:`ExpertShards` (``ShardedTrainer`` on a mesh with an ``ep`` axis):
member ``e`` of the replica's ep group holds experts ``[e*K/ep,
(e+1)*K/ep)`` and computes their share of the output for the replica's
tokens on its own device; the shares are summed by
``collectives.all_reduce_autograd``.

:func:`expert_parallel_moe` is the explicit form over a
``ReplicaGroup``: each replica holds one token shard and one expert
shard, and the capacity slots go out and come back through
``collectives.all_to_all`` (dispatch and combine).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from .registry import (OperatorProperty, register_cost_rule, register_op,
                       register_sharding_rule, require_known)

__all__ = ["moe_capacity", "MoE", "ExpertShards", "expert_parallel_moe"]


def moe_capacity(tokens, num_experts, top_k=1, capacity_factor=0.0):
    """Per-expert token capacity: ``ceil(cf * T * top_k / K)``, or 0
    meaning unbounded (``capacity_factor`` unset)."""
    if not capacity_factor or capacity_factor <= 0:
        return 0
    return int(math.ceil(int(tokens) * int(top_k) *
                         float(capacity_factor) / int(num_experts)))


def _gate(t, wg):
    """Softmax gate probabilities ``(T, K)``."""
    return torch.softmax(t @ wg.t(), dim=-1)


def _assign(probs, topk):
    """The ``(T, K)`` int32 top-k assignment (before any capacity drop):
    ``argmax`` for top-1, else the ``topk`` largest with ties at the
    lowest index first."""
    with torch.no_grad():
        if topk == 1:
            sel = torch.argmax(probs, dim=-1, keepdim=True)
        else:
            sel = torch.sort(probs, dim=-1, descending=True,
                             stable=True)[1][:, :topk]
        out = torch.zeros(probs.shape, dtype=torch.int32,
                          device=probs.device)
        return out.scatter_(1, sel, 1)


def _queue(sel, prefix=None):
    """Each assignment's queue position at its expert: the exclusive
    cumulative count over the tokens before it, plus ``prefix`` (the
    counts of the replicas before this one).  The scan runs along the
    last dimension of the ``(K, T)`` transpose: PyTorch's CUDA scan over
    the outer dimension of a ``(T, K)`` tensor gives each of the K
    columns one thread (1.28 ms at T=8192 on the H100)."""
    pos = torch.cumsum(sel.t().contiguous(), dim=1, dtype=torch.int32).t() \
        - sel
    return pos if prefix is None else pos + prefix


def _routing(t, wg, K, topk, capacity_factor):
    """``(probs, mask, combine, sel)`` of one token shard: ``mask`` the
    {0,1} assignment after any capacity drop, ``combine = probs *
    mask``."""
    probs = _gate(t, wg)
    sel = _assign(probs, topk)
    cap = moe_capacity(t.shape[0], K, topk, capacity_factor)
    keep = sel
    if cap:
        keep = sel * (_queue(sel) < cap).to(torch.int32)
    mask = keep.to(t.dtype)
    return probs, mask, probs * mask, sel


def _experts(t, w1, b1, w2, b2, combine):
    """The dense expert FFNs of ``t`` ``(T, E)`` weighted by ``combine``
    ``(T, K)``: every expert computes every token."""
    h = torch.relu(torch.einsum("te,khe->tkh", t, w1) + b1[None])
    y = torch.einsum("tkh,keh->tke", h, w2) + b2[None]
    return torch.einsum("tke,tk->te", y, combine)


class ExpertShards:
    """One replica's expert stack split over its ``ep`` members:
    ``shards[e]`` lives on ``group.devices[e]`` and holds experts ``[e *
    K/ep, (e+1) * K/ep)`` on axis 0 (``group`` is the replica's ep
    :class:`~mxnet_tpu_torch.parallel.collectives.ReplicaGroup`)."""

    __slots__ = ("shards", "group")

    def __init__(self, shards, group):
        self.shards = list(shards)
        self.group = group

    def map(self, fn):
        """The same split with ``fn`` applied to each shard."""
        return ExpertShards([fn(s) for s in self.shards], self.group)

    def to(self, *args, **kwargs):
        return self.map(lambda s: s.to(*args, **kwargs))

    def is_floating_point(self):
        return self.shards[0].is_floating_point()

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def shape(self):
        s = self.shards[0].shape
        return (s[0] * len(self.shards),) + tuple(s[1:])

    def __repr__(self):
        return "ExpertShards(%s over %s)" % (self.shape, self.group)


def _expert_out(t, w1, b1, w2, b2, combine):
    """The routed output: :func:`_experts` on one device, or each ep
    member's experts on its own device, their shares summed."""
    if not isinstance(w1, ExpertShards):
        return _experts(t, w1, b1, w2, b2, combine)
    from ..parallel import collectives as coll
    group = w1.group
    k_local = w1.shards[0].shape[0]
    shares = []
    for e, dev in enumerate(group.devices):
        sl = slice(e * k_local, (e + 1) * k_local)
        shares.append(_experts(coll.send(t, dev), w1.shards[e],
                               b1.shards[e], w2.shards[e], b2.shards[e],
                               coll.send(combine[:, sl], dev)))
    return coll.all_reduce_autograd(group, shares)[0]


def _aux_loss(K, topk, mask_sum, probs_sum, tokens):
    """Switch eq. 4: ``K * <fraction routed, mean probability>``, the
    fractions normalized by ``top_k`` so a balanced router scores 1."""
    frac = mask_sum / tokens / topk
    mean_p = probs_sum / tokens
    return (K * torch.sum(frac * mean_p)).reshape(1)


class _MoEParam(ParamStruct):
    num_experts = Field(int, required=True, lower=2)
    hidden_size = Field(int, required=True, lower=1)
    top_k = Field(int, default=1, lower=1,
                  doc="experts per token (Switch=1, GShard-style=2+)")
    capacity_factor = Field(
        float, default=0.0, lower=0.0,
        doc="per-expert capacity = ceil(cf*T*top_k/K); 0 = unbounded "
            "(overflow tokens are dropped from the expert)")


@register_op("MoE", aliases=("SwitchFFN",))
class MoE(OperatorProperty):
    """data (..., E) -> (..., E); outputs [y, aux_loss(1,)].

    ``dropped`` counts, after each forward, the token-expert assignments
    the capacity dropped (a device tensor, summed over the replicas of a
    lockstep walk)."""
    param_cls = _MoEParam
    dropped = None

    def list_arguments(self):
        return ["data", "gate_weight", "expert_fc1_weight",
                "expert_fc1_bias", "expert_fc2_weight",
                "expert_fc2_bias"]

    def list_outputs(self):
        return ["output", "aux_loss"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("MoE", in_shapes[:1], ["data"])
        if len(data) < 2:
            raise MXNetError("MoE: data must be (..., embed)")
        E = data[-1]
        K, H = self.param.num_experts, self.param.hidden_size
        if self.param.top_k > K:
            raise MXNetError("MoE: top_k (%d) > num_experts (%d)"
                             % (self.param.top_k, K))
        return ([data, (K, E), (K, H, E), (K, H), (K, E, H), (K, E)],
                [data, (1,)], [])

    def forward(self, inputs, aux, is_train, rng):
        outs, _aux, _rep = self._replicas([inputs], None)
        return outs[0], None

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """The lockstep walk over a batch split across replicas: the
        capacity and the aux loss over the whole batch (the module
        docstring).  The output is split like the data; the aux loss is
        the same on every replica."""
        return self._replicas(ins, group)

    def _replicas(self, ins, group):
        from ..parallel import collectives as coll
        K = self.param.num_experts
        topk = min(self.param.top_k, K)
        cf = self.param.capacity_factor
        n = len(ins)
        ts = [i[0].reshape(-1, i[0].shape[-1]) for i in ins]
        probs = [_gate(t, i[1]) for t, i in zip(ts, ins)]
        sels = [_assign(p, topk) for p in probs]
        multi = group is not None and not group.trivial
        tokens = sum(t.shape[0] for t in ts)
        prefixes = [None] * n
        if multi:
            # the processes of a group hold equal parts of the batch
            tokens *= group.num_processes
            # every replica's per-expert counts, in global replica
            # order, on every replica's device
            got = coll.all_gather(group, [s.sum(0, dtype=torch.int32)
                                          for s in sels])
            base = group.rank() * group.n
            for r in range(n):
                table = got[r].view(group.world, K)
                prefixes[r] = table[:base + r].sum(0, dtype=torch.int32)
        cap = moe_capacity(tokens, K, topk, cf)
        masks = []
        for t, s, pre in zip(ts, sels, prefixes):
            keep = s
            if cap:
                keep = s * (_queue(s, pre) < cap).to(torch.int32)
            masks.append(keep.to(t.dtype))
        with torch.no_grad():
            drops = [(s.sum() - m.sum().to(torch.int32)).reshape(1)
                     for s, m in zip(sels, masks)]
        mask_sums = [m.sum(0) for m in masks]
        probs_sums = [p.sum(0) for p in probs]
        if multi:
            mask_sums = coll.all_reduce(group, mask_sums)
            probs_sums = coll.all_reduce_autograd(group, probs_sums)
            drops = coll.all_reduce(group, drops)
        self.dropped = drops[0]
        outs = []
        for r, i in enumerate(ins):
            x = i[0]
            out = _expert_out(ts[r], i[2], i[3], i[4], i[5],
                              probs[r] * masks[r])
            outs.append([out.reshape(x.shape),
                         _aux_loss(K, topk, mask_sums[r], probs_sums[r],
                                   tokens)])
        return outs, None, [False, True]


def expert_parallel_moe(group, xs, wg, w1, b1, w2, b2, *, top_k=1,
                        capacity_factor=1.25):
    """The expert-parallel MoE block over the replicas of ``group``:
    ``xs[r]`` is replica r's token shard ``(..., E)``; ``w1``/``b1``/
    ``w2``/``b2`` are lists of each replica's expert shard (leading dim
    ``K/ep``); ``wg`` the replicated gate ``(K, E)`` (one tensor, or one
    a replica).  Routing is computed locally, tokens are packed into
    per-expert capacity slots and exchanged with one
    :func:`~mxnet_tpu_torch.parallel.collectives.all_to_all` (dispatch),
    the local experts run, and a second returns the routed outputs
    (combine).  The capacity is per member, ``ceil(cf * T_local * top_k
    / K)``, so ``capacity_factor > 0`` is required.  Returns ``(outs,
    aux_losses)``, one each a replica; differentiable.  Matches the
    dense :class:`MoE` forward applied to each member's shard."""
    from ..parallel import collectives as coll
    if not capacity_factor or capacity_factor <= 0:
        raise ValueError("expert_parallel_moe needs capacity_factor > 0")
    ep = group.world
    n = group.n
    wgs = list(wg) if isinstance(wg, (list, tuple)) else [wg] * n
    K = wgs[0].shape[0]
    k_local = w1[0].shape[0]
    if k_local * ep != K:
        raise ValueError("expert shard (%d) * ep (%d) != num_experts "
                         "(%d)" % (k_local, ep, K))
    topk = min(int(top_k), K)
    ts, dis, combines, ins, auxes = [], [], [], [], []
    for r in range(n):
        t = xs[r].reshape(-1, xs[r].shape[-1])
        probs, mask, combine, sel = _routing(t, wgs[r], K, topk,
                                             capacity_factor)
        cap = moe_capacity(t.shape[0], K, topk, capacity_factor)
        pos = _queue(sel)
        slots = torch.arange(cap, device=t.device, dtype=pos.dtype)
        d = mask[:, :, None] * (pos[:, :, None] == slots).to(t.dtype)
        ts.append(t)
        dis.append(d)
        combines.append(combine)
        ins.append(torch.einsum("tkc,te->kce", d, t))      # (K, C, E)
        auxes.append(_aux_loss(K, topk, mask.sum(0), probs.sum(0),
                               t.shape[0]).reshape(()))
    # dispatch: replica j gets its experts' slots from every replica,
    # along the capacity axis -> (K/ep, ep*C, E)
    got = coll.all_to_all_autograd(group, ins, 0, 1)
    ys = []
    for r in range(n):
        h = torch.relu(torch.einsum("kce,khe->kch", got[r], w1[r])
                       + b1[r][:, None, :])
        ys.append(torch.einsum("kch,keh->kce", h, w2[r])
                  + b2[r][:, None, :])
    # combine: each replica's slots back to the token owner -> (K, C, E)
    back = coll.all_to_all_autograd(group, ys, 1, 0)
    outs = []
    for r in range(n):
        out = torch.einsum("tkc,kce->te",
                           dis[r] * combines[r][:, :, None], back[r])
        outs.append(out.reshape(xs[r].shape))
    return outs, auxes


@register_sharding_rule("MoE")
def _moe_transfer(op, in_specs, in_shapes, out_shapes, mesh_shape):
    """Output follows the data spec; expert weights sharded over an
    expert-parallel axis turn the routed dispatch/combine into the
    all-to-all pair (priced per device like every reshard: each member
    keeps 1/ep of its tokens locally)."""
    data_spec = tuple(in_specs[0] or ())
    w1_spec = tuple(in_specs[2] or ())
    ep_axes = tuple(w1_spec[0]) if w1_spec else ()
    notes = []
    if ep_axes:
        for leg in ("dispatch", "combine"):
            notes.append({
                "kind": "alltoall", "arg": 0, "axes": ep_axes,
                "message": "MoE expert %s: routed tokens exchanged "
                           "with the %s expert shards over an "
                           "all-to-all" % (leg, "+".join(ep_axes))})
    aux_rank = len(out_shapes[1]) if len(out_shapes) > 1 and \
        out_shapes[1] is not None else 1
    return {"out": [data_spec, ((),) * aux_rank], "notes": notes}


@register_cost_rule("MoE")
def _moe_cost(op, in_shapes, out_shapes):
    """Price the ROUTED execution plan (each token visits ``top_k``
    experts), not the dense einsum the op computes, as the JAX package
    prices it."""
    data = in_shapes[0]
    if data is None:
        return {}
    T = 1
    for d in data[:-1]:
        T *= int(d)
    E = int(data[-1])
    K = int(op.param.num_experts)
    H = int(op.param.hidden_size)
    topk = min(int(op.param.top_k), K)
    gate = 2.0 * T * K * E
    ffn = 2.0 * T * topk * E * H * 2
    return {"flops": gate + ffn, "mxu": True,
            "mxu_dims": [(T * topk, E, H), (T * topk, H, E)]}
