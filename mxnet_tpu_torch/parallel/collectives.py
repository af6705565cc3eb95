"""Collectives over the replicas of a data-parallel step.

The port's counterpart of the JAX package's in-step psum (XLA inserts it
where a dp-sharded step sums over the mesh) and of
``kvstore._collective_sum`` (``mxnet_tpu/kvstore.py:708``, the
cross-process sum).  A :class:`ReplicaGroup` is either
several local replicas of one process, each on a ``torch.device``
(several may share one), or one replica in each process of a
``torch.distributed`` group; several cards per process within such a
group are not ported (ROADMAP.md queue 1 item 3 (g)).  The collectives
take one tensor for each local replica and return one for each, by one
of three routes:

- replicas that share a device sum with plain adds there, in replica
  order (the CPU tests' path, and the one-card run's);
- replicas on distinct cards of one process sum with NCCL through
  ``torch.cuda.nccl`` (``all_reduce``, ``reduce_scatter``,
  ``all_gather``, ``broadcast`` over a list of per-device tensors);
- one replica a process sums over the default ``torch.distributed``
  group: NCCL for CUDA tensors, gloo for CPU tensors.

An NCCL call that fails raises; nothing continues through host copies
or gloo.  The JAX package also carries an allreduce through its
coordination service's key-value store (``mxnet_tpu/kvstore.py:295-336``),
because multi-process CPU JAX cannot build cross-process programs; gloo
can, so the port has no such path.

Every collective runs under an ``observability.spans`` span of its name
and route.  :func:`all_reduce_autograd` is the
sum as an autograd function (its backward is the same sum of the
replicas' gradients), for the ops that reduce over the batch axis.

Tensor parallelism adds :func:`gather_autograd`: the parts of a value
that the members of a tp group computed, concatenated onto the group's
first member under autograd (the backward hands each member its part
of the gradient).  Between cards of one process it goes through
``torch.cuda.nccl`` (``all_gather``, the backward's ``broadcast``); on
one device it is a concatenation.  Its sums are
:func:`all_reduce_autograd`'s.

Expert and pipeline parallelism add :func:`all_to_all` (the MoE
dispatch and combine; :func:`all_to_all_autograd` under autograd) and
:func:`send` (a stage boundary's point-to-point copy).  Replicas that
share a device exchange by plain index copies there; replicas on
distinct cards of one process by peer copies (``Tensor.to`` of another
card: PyTorch orders the copy after the source card's current stream
and makes the destination's current stream wait for it, with events;
``torch.cuda.nccl`` has no all-to-all).  Across the processes of a
``torch.distributed`` group both raise (ROADMAP.md queue 1 item 3 (k):
gloo has no all-to-all).
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError
from ..observability import spans as _spans

__all__ = ["ReplicaGroup", "all_reduce", "reduce_scatter", "all_gather",
           "broadcast", "all_reduce_autograd", "all_to_all",
           "all_to_all_autograd", "send", "gather_autograd"]

_ACROSS_PROCESSES = ("across the processes of a torch.distributed group "
                     "is not ported yet (ROADMAP.md queue 1 item 3 (k)); "
                     "run expert and pipeline parallelism on the cards "
                     "of one process")

#: one NCCL call at a time: each launches on every device's stream, so
#: calls from the autograd engine's device threads keep one order
_LOCK = threading.RLock()


class ReplicaGroup:
    """The local replicas' devices (in replica order) and the number of
    processes: several replicas in one process, or one in each of
    ``num_processes`` (global replica ``p`` is process ``p``'s)."""

    def __init__(self, devices, num_processes=1):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self.num_processes = int(num_processes)
        if self.n > 1 and self.num_processes > 1:
            raise MXNetError(
                "ReplicaGroup: %d replicas in each of %d processes: "
                "several cards per process within a dist group are not "
                "ported yet (ROADMAP.md queue 1 item 3 (g)); launch one "
                "process per card" % (self.n, self.num_processes))
        self.world = self.n * self.num_processes
        self.distinct = []
        self.replicas_of = {}
        for r, d in enumerate(self.devices):
            if d not in self.replicas_of:
                self.distinct.append(d)
                self.replicas_of[d] = []
            self.replicas_of[d].append(r)
        self.nccl = len(self.distinct) > 1
        if self.nccl and any(d.type != "cuda" for d in self.distinct):
            raise MXNetError("ReplicaGroup: replicas on %s: several "
                             "devices must all be CUDA devices"
                             % self.distinct)

    @property
    def trivial(self):
        return self.world == 1

    def rank(self):
        if self.num_processes == 1:
            return 0
        import torch.distributed as dist
        return dist.get_rank()

    def route(self):
        """``"local"`` (one device), ``"nccl"`` (cards of one process) or
        ``"dist"`` (one replica a process)."""
        if self.num_processes > 1:
            return "dist"
        return "nccl" if self.nccl else "local"

    def __repr__(self):
        return "ReplicaGroup(%s x %d processes)" % (self.devices,
                                                   self.num_processes)


def _check(group, tensors, what):
    if len(tensors) != group.n:
        raise MXNetError("%s: %d tensors for %d replicas"
                         % (what, len(tensors), group.n))
    for t, d in zip(tensors, group.devices):
        if t.device != d:
            raise MXNetError("%s: a tensor on %s for the replica on %s"
                             % (what, t.device, d))


def _dist():
    import torch.distributed as dist
    return dist


def _per_device_sums(group, tensors):
    """One sum for each distinct device (its replicas added in order),
    fresh tensors (NCCL writes them in place)."""
    out = []
    for d in group.distinct:
        idx = group.replicas_of[d]
        acc = tensors[idx[0]].clone()
        for r in idx[1:]:
            acc += tensors[r]
        out.append(acc.contiguous())
    return out


def _spread(group, per_device):
    """One tensor for each replica from one for each distinct device: the
    first replica of a device takes it, the others a copy."""
    out = [None] * group.n
    for d, t in zip(group.distinct, per_device):
        idx = group.replicas_of[d]
        out[idx[0]] = t
        for r in idx[1:]:
            out[r] = t.clone()
    return out


def all_reduce(group, tensors):
    """The sum over every replica of every process, one copy for each
    local replica."""
    _check(group, tensors, "all_reduce")
    with _spans.span("allreduce", route=group.route()):
        if group.trivial:
            return [tensors[0]]
        sums = _per_device_sums(group, tensors)
        if group.num_processes > 1:
            with _LOCK:
                _dist().all_reduce(sums[0])
            return sums
        if group.nccl:
            with _LOCK:
                torch.cuda.nccl.all_reduce(sums)
        return _spread(group, sums)


def reduce_scatter(group, tensors):
    """The sum over every replica of flat tensors whose length divides
    by the world size; global replica ``i`` gets part ``i`` of it."""
    _check(group, tensors, "reduce_scatter")
    n = tensors[0].numel()
    if n % group.world:
        raise MXNetError("reduce_scatter: %d elements do not divide over "
                         "%d replicas" % (n, group.world))
    part = n // group.world
    with _spans.span("reduce_scatter", route=group.route()):
        if group.trivial:
            return [tensors[0]]
        if group.num_processes > 1 and tensors[0].is_cuda:
            out = torch.empty(part, dtype=tensors[0].dtype,
                              device=tensors[0].device)
            with _LOCK:
                _dist().reduce_scatter_tensor(out, tensors[0].contiguous())
            return [out]
        if group.nccl and len(group.distinct) == group.n:
            outs = [torch.empty(part, dtype=t.dtype, device=t.device)
                    for t in tensors]
            with _LOCK:
                torch.cuda.nccl.reduce_scatter(
                    [t.contiguous() for t in tensors], outs)
            return outs
        # one device, gloo, or replicas sharing cards: the sum, cut
        # (global replica group.rank() * group.n + r is local replica r)
        base = group.rank() * group.n
        total = all_reduce(group, tensors)
        return [t.narrow(0, (base + r) * part, part)
                for r, t in enumerate(total)]


def all_gather(group, tensors):
    """Every replica's flat tensor, concatenated in global replica order,
    on every local replica's device."""
    _check(group, tensors, "all_gather")
    part = tensors[0].numel()
    with _spans.span("all_gather", route=group.route()):
        if group.trivial:
            return [tensors[0]]
        if group.num_processes > 1:
            dist = _dist()
            t = tensors[0].contiguous()
            with _LOCK:
                if t.is_cuda:
                    out = torch.empty(part * group.world, dtype=t.dtype,
                                      device=t.device)
                    dist.all_gather_into_tensor(out, t)
                else:
                    parts = [torch.empty_like(t)
                             for _ in range(group.world)]
                    dist.all_gather(parts, t)
                    out = torch.cat(parts)
            return [out]
        if not group.nccl:
            whole = torch.cat([t.reshape(-1) for t in tensors])
            return [whole] + [whole.clone() for _ in range(group.n - 1)]
        if len(group.distinct) == group.n:
            outs = [torch.empty(part * group.n, dtype=t.dtype,
                                device=t.device) for t in tensors]
            with _LOCK:
                torch.cuda.nccl.all_gather(
                    [t.contiguous() for t in tensors], outs)
            return outs
        raise MXNetError("all_gather: replicas sharing cards of several "
                         "(%s) are not supported; give each replica its "
                         "own card, or every replica one card"
                         % group.distinct)


def broadcast(group, tensors, root=0):
    """Global replica ``root``'s tensor, copied into every local
    replica's (in place); returns the tensors."""
    _check(group, tensors, "broadcast")
    with _spans.span("broadcast", route=group.route()):
        if group.trivial:
            return tensors
        if group.num_processes > 1:
            with _LOCK:
                _dist().broadcast(tensors[0], src=root)
            return tensors
        src = tensors[root]
        with _LOCK:
            if group.nccl:
                heads = [tensors[group.replicas_of[d][0]]
                         for d in group.distinct]
                heads[group.distinct.index(src.device)] = src
                torch.cuda.nccl.broadcast(
                    heads, root=group.distinct.index(src.device))
                for d, h in zip(group.distinct, heads):
                    for r in group.replicas_of[d]:
                        if tensors[r] is not h:
                            tensors[r].copy_(h)
            else:
                for t in tensors:
                    if t is not src:
                        t.copy_(src)
        return tensors


class _AllReduceSum(torch.autograd.Function):
    """The sum over the replicas, each replica's output a copy; the
    backward sums the replicas' gradients the same way (each replica's
    share of a replicated value's gradient adds up to its whole)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(all_reduce(group, [x.detach() for x in xs]))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(all_reduce(ctx.group, [g.contiguous()
                                                       for g in gs]))


def all_reduce_autograd(group, tensors):
    """:func:`all_reduce` under autograd (see :class:`_AllReduceSum`)."""
    if group.trivial:
        return list(tensors)
    return list(_AllReduceSum.apply(group, *tensors))


def _flat_along(t, dim):
    """``t`` with ``dim`` moved first, contiguous and flat."""
    return t.movedim(dim, 0).contiguous().reshape(-1)


class _GatherToFirst(torch.autograd.Function):
    """The members' parts concatenated along ``dim`` on the first
    member's card (NCCL all-gather); the backward broadcasts the
    gradient and hands each member its part."""

    @staticmethod
    def forward(ctx, group, dim, *xs):
        ctx.group, ctx.dim = group, dim
        ctx.sizes = [x.shape[dim] for x in xs]
        shape = list(xs[0].shape)
        shape.pop(dim)
        with _spans.span("all_gather", route="nccl"):
            outs = [torch.empty(x.numel() * group.n, dtype=x.dtype,
                                device=x.device) for x in xs]
            with _LOCK:
                torch.cuda.nccl.all_gather(
                    [_flat_along(x.detach(), dim) for x in xs], outs)
        whole = outs[0].view([sum(ctx.sizes)] + shape)
        return whole.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        with _spans.span("broadcast", route="nccl"):
            heads = [g.contiguous()] + [
                torch.empty(g.shape, dtype=g.dtype, device=d)
                for d in group.devices[1:]]
            with _LOCK:
                torch.cuda.nccl.broadcast(heads, root=0)
        off, grads = 0, []
        for r, size in enumerate(ctx.sizes):
            grads.append(heads[r].narrow(dim, off, size))
            off += size
        return (None, None) + tuple(grads)


def gather_autograd(group, tensors, dim):
    """Member ``e``'s ``tensors[e]`` (on its own device) concatenated
    along ``dim`` in member order, on the first member's device, under
    autograd."""
    _check(group, tensors, "gather_autograd")
    if group.num_processes > 1:
        raise MXNetError("gather_autograd over a tp group across the "
                         "processes of a torch.distributed group is not "
                         "ported yet (ROADMAP.md queue 1 item 3 (k)); run "
                         "tensor parallelism on the cards of one process")
    if group.n == 1:
        return tensors[0]
    dim = dim % tensors[0].dim()
    if not group.nccl:
        with _spans.span("all_gather", route="local"):
            return torch.cat(tensors, dim=dim)
    if len(group.distinct) != group.n:
        raise MXNetError("gather_autograd: tp members sharing cards of "
                         "several (%s) are not supported; give each member "
                         "its own card, or every member one card"
                         % group.distinct)
    return _GatherToFirst.apply(group, dim, *tensors)


def all_to_all(group, tensors, split_dim, concat_dim):
    """Each replica's tensor cut into ``world`` equal parts along
    ``split_dim``; replica ``j`` gets part ``j`` of every replica's,
    concatenated along ``concat_dim`` in replica order (``lax.all_to_all``
    with ``tiled=True``)."""
    _check(group, tensors, "all_to_all")
    if group.num_processes > 1:
        raise MXNetError("all_to_all " + _ACROSS_PROCESSES)
    n = group.n
    size = tensors[0].shape[split_dim]
    if size % n:
        raise MXNetError("all_to_all: dimension %d (%d) does not divide "
                         "over %d replicas" % (split_dim, size, n))
    with _spans.span("all_to_all", route=group.route()):
        if n == 1:
            return [tensors[0]]
        parts = [torch.chunk(t, n, dim=split_dim) for t in tensors]
        return [torch.cat([parts[i][j].to(d, non_blocking=True)
                           for i in range(n)], dim=concat_dim)
                for j, d in enumerate(group.devices)]


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` whose backward is the all-to-all back (the
    split and concatenated dimensions swapped)."""

    @staticmethod
    def forward(ctx, group, split_dim, concat_dim, *xs):
        ctx.args = (group, split_dim, concat_dim)
        return tuple(all_to_all(group, [x.detach() for x in xs],
                                split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *gs):
        group, split_dim, concat_dim = ctx.args
        return (None, None, None) + tuple(all_to_all(
            group, [g.contiguous() for g in gs], concat_dim, split_dim))


def all_to_all_autograd(group, tensors, split_dim, concat_dim):
    """:func:`all_to_all` under autograd."""
    return list(_AllToAll.apply(group, split_dim, concat_dim, *tensors))


def send(tensor, device):
    """``tensor`` on ``device``: itself when it is there already, else a
    peer copy between two cards of this process (differentiable: the
    gradient comes back the same way).  A copy between a card and the
    host raises: a stage boundary or an expert exchange never goes
    through the host."""
    device = torch.device(device)
    if tensor.device == device:
        return tensor
    if tensor.device.type != device.type:
        raise MXNetError("send: %s -> %s would go through the host; put "
                         "every member of the mesh on the same kind of "
                         "device" % (tensor.device, device))
    with _spans.span("send", route="peer"):
        return tensor.to(device, non_blocking=True)
