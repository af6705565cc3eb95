"""Executor: a bound symbol, evaluated by a topological walk.

The port's counterpart of ``mxnet_tpu/executor.py``.  Where the JAX
package traces the whole graph into one jitted function, the port runs
each node's ``forward`` eagerly on torch tensors in post-DFS order.

- :func:`build_program` is the counterpart of
  ``_build_program(symbol, {}).trace``: the one graph walk, with
  autograd on, which ``parallel.trainer.ShardedTrainer`` and the
  Executor's backward differentiate.
- :class:`Executor`: ``forward``, ``backward`` (autograd through the
  graph the training forward kept; ``grad_req`` write/add/null),
  ``forward_backward``, and ``fused_step`` (forward, backward and a
  leafwise optimizer update in one call, the Module path's step);
  ``copy_params_from`` and ``reshape``.
  :meth:`Executor._forward_raw` is the counterpart of ``_jit_forward``
  (tensors in, tensors out, no NDArray bookkeeping): the walk under
  ``torch.no_grad``, what ``GenerationEngine.run_async`` calls on every
  step.
- :func:`simple_bind` allocates argument, gradient and aux arrays from
  inferred shapes.

Executors share programs through a registry keyed like the JAX
package's ``_lookup_program``: graph fingerprint, device,
``MXNET_COMPUTE_DTYPE`` and the mirroring envs.  ``build_program`` runs
once a key, so the per-bucket binds of one model share one program, and
:func:`program_registry_stats` counts the builds ("lowerings") and the
hits: a warmed server performs zero lowerings.  The walk is the same
function for inference and training, so one program serves both; the
fused step's own state (the optimizer's hyperparameters, multipliers
and compute dtype) is keyed on the executor (:meth:`Executor._fused`).

Mirroring (``force_mirroring``, ``MXNET_BACKWARD_DO_MIRROR``) recomputes
segments of the graph in the backward instead of keeping what they save
(:func:`build_program`); :meth:`Executor.set_monitor_callback` reports
every op output of a forward to a ``monitor.Monitor``.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .base import MXNetError
from .context import Context, resolve
from .ndarray import NDArray, zeros

__all__ = ["Executor", "build_program", "program_registry_stats",
           "simple_bind", "trace_residual_bytes"]


def _as_list(obj, names, what):
    if obj is None:
        return [None] * len(names)
    if isinstance(obj, dict):
        return [obj.get(n) for n in names]
    obj = list(obj)
    if len(obj) != len(names):
        raise MXNetError("%s: expected %d arrays, got %d"
                         % (what, len(names), len(obj)))
    return obj


class Program:
    """A symbol's graph walk: ``trace(arg_values, aux_values, rng,
    is_train, monitor=None, mirror=True) -> (outputs, aux_updates)`` on
    name -> tensor dicts, with autograd on; ``needs_rng``: whether an op
    of the graph declares ``need_rng``; ``segments``: the
    :func:`_mirror_segments` partition, and ``n_mirrored`` the number of
    its recomputed segments.  ``rng`` is a ``torch.Generator`` (or
    None), handed to every op that declares ``need_rng``; ``monitor``,
    a callable ``(name, tensor)``, sees every op output (and turns
    mirroring off for the call); ``mirror=False`` runs the graph
    unmirrored.  ``trace_replicas`` is the lockstep walk of a batch split
    across replicas (data parallelism; :func:`build_program`)."""

    __slots__ = ("trace", "needs_rng", "segments", "n_mirrored",
                 "trace_replicas")

    def __init__(self, trace, needs_rng, segments=(), n_mirrored=0):
        self.trace = trace
        self.needs_rng = needs_rng
        self.segments = segments
        self.n_mirrored = n_mirrored
        self.trace_replicas = None


def _mirror_segments(op_nodes):
    """Partition the op schedule into recompute segments (the mirror map
    of MakeBackwardPass, static_graph.cc:396-440), by the JAX package's
    rules: a node is mirrored when its ``force_mirroring`` attr is true,
    or with ``MXNET_BACKWARD_DO_MIRROR=1`` for every op type outside the
    skip list (Convolution, FullyConnected, Concat, SoftmaxOutput,
    CuDNNBatchNorm) except every ``MXNET_BACKWARD_MIRROR_STEP``-th
    eligible node (default 100; <= 0 means never).  Dropout is never
    mirrored.  Consecutive mirrored nodes form one segment, split where
    their ``mirror_stage`` attrs differ.  Returns ``[(is_mirror,
    [nodes])]``."""
    do_mirror = int(os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") or 0)
    mirror_step = int(os.environ.get("MXNET_BACKWARD_MIRROR_STEP",
                                     "100") or 100)
    if mirror_step <= 0:
        mirror_step = 1 << 62   # never hit the periodic keep
    counter = [0]
    env_skip = {"Convolution", "FullyConnected", "Concat", "SoftmaxOutput",
                "CuDNNBatchNorm"}

    def need(node):
        t = type(node.op).op_name or type(node.op).__name__
        if t == "Dropout":
            return False
        if str(node.attrs.get("force_mirroring", "")).lower() in ("true",
                                                                  "1"):
            return True
        if not do_mirror:
            return False
        if t in env_skip:
            return False
        counter[0] += 1
        if counter[0] % mirror_step == 0:
            return False
        return True

    segments = []
    for node in op_nodes:
        m = need(node)
        stage = node.attrs.get("mirror_stage") if m else None
        if segments and segments[-1][0] == m and segments[-1][2] == stage:
            segments[-1][1].append(node)
        else:
            segments.append([m, [node], stage])
    return [(m, nodes) for m, nodes, _stage in segments]


#: per thread: a list that collects the tensors a training walk keeps
#: for the backward (``trace_residual_bytes``), or None
_RESIDUALS = threading.local()


def _keep(t):
    """A tensor kept for the backward, as a pack hook returns it:
    detached (autograd puts its history back on unpack; the tensor itself
    would tie the graph into a reference cycle through its own grad_fn,
    freed only by the garbage collector)."""
    t = t.detach()
    col = getattr(_RESIDUALS, "tensors", None)
    if col is not None:
        col.append(t)
    return t


def _generator_at(device, state):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


class _Handle:
    """What the autograd graph keeps in place of a recomputed tensor: its
    segment and its key there (the k-th save, or a produced value)."""

    __slots__ = ("rec", "key", "__weakref__")

    def __init__(self, rec, key):
        self.rec = rec
        self.key = key


def _snapshot(rngs):
    """The distinct generators among ``rngs`` (one a member; members of
    one device may share one), their states, and each member's index
    among them."""
    uniq, idx = [], []
    for g in rngs:
        if g is None:
            idx.append(None)
            continue
        i = next((i for i, u in enumerate(uniq) if u is g), None)
        if i is None:
            i = len(uniq)
            uniq.append(g)
        idx.append(i)
    return uniq, [g.get_state() for g in uniq], idx


def _replay(snap):
    """Copies of the generators of a :func:`_snapshot` at its states:
    ``(each member's copy, the distinct copies)``."""
    uniq, states, idx = snap
    copies = [_generator_at(g.device, st) for g, st in zip(uniq, states)]
    return [None if i is None else copies[i] for i in idx], copies


class _Recompute:
    """One mirrored segment of one training walk: its input tensors (kept
    for the recompute), the generator states at its start, the handles
    the graph holds, and, once recomputed in the backward, the tensor of
    each live handle.  ``run(local, rngs)`` runs the segment again over
    ``local`` (input key -> tensor), adding the values it makes, with
    ``rngs`` (the generators' copies, or None).  A handle dies with the
    graph node that saved it (after that node's backward), and its
    tensor with it: the copies live from the first unpack to the last
    backward that reads them."""

    __slots__ = ("run", "ext_keys", "ext_vals", "ext_grad", "snap",
                 "n_saves", "handles", "cache", "__weakref__")

    def __init__(self, run, ext_keys, ext_vals, rngs):
        self.run = run
        self.ext_keys = ext_keys
        # detached copies and requires_grad flags: no reference to their
        # history
        self.ext_vals = [_keep(v) for v in ext_vals]
        self.ext_grad = [v.requires_grad for v in ext_vals]
        self.snap = _snapshot(rngs) if rngs is not None \
            and any(g is not None for g in rngs) else None
        self.n_saves = 0
        self.handles = weakref.WeakSet()
        self.cache = weakref.WeakKeyDictionary()

    def handle(self, key):
        h = _Handle(self, key)
        self.handles.add(h)
        return h

    def generators(self):
        """Each member's copy of its generator at the segment's start,
        and the distinct copies (None, None when it draws nothing)."""
        if self.snap is None:
            return None, None
        return _replay(self.snap)

    def _recompute(self):
        """Run the segment again from its inputs (detached, with their
        requires_grad) with autograd on, recording what its ops save, in
        order: the same ops on the same inputs save the same tensors in
        the same order as the first run, whose k-th save this answers."""
        saved = []

        def pack(t):
            saved.append(t.detach())
            return saved[-1]

        local = {}
        for k, v, g in zip(self.ext_keys, self.ext_vals, self.ext_grad):
            d = v.detach()
            local[k] = d.requires_grad_(g) if d.is_floating_point() else d
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            self.run(local, self.generators()[0])
        for h in list(self.handles):
            self.cache[h] = saved[h.key] if isinstance(h.key, int) \
                else local[h.key].detach()

    def get(self, h):
        if h not in self.cache:
            self._recompute()
        return self.cache[h]


class _MirrorHooks:
    """The saved-tensor hooks of one mirrored training walk.  A tensor an
    op saves inside a mirrored segment, or a value a mirrored node
    produced that an op outside saves (a convolution reading a mirrored
    ReLU's output), is packed as a handle and recomputed in the backward
    (the reference's backward reads the mirrored copies); anything else,
    and a segment's own inputs, is kept."""

    def __init__(self):
        self.current = None     # the _Recompute of the running segment
        self.inputs = ()        # its input tensors, while it runs
        self.produced = WeakIdKeyDictionary()   # tensor -> (_Recompute, key)

    def pack(self, t):
        rec = self.current
        if rec is not None:
            k = rec.n_saves
            rec.n_saves += 1
            if any(t is x for x in self.inputs):
                return t.detach()   # held by the segment anyway
            return rec.handle(k)
        ent = self.produced.get(t)
        if ent is not None:
            return ent[0].handle(ent[1])
        return _keep(t)

    @staticmethod
    def unpack(h):
        if isinstance(h, torch.Tensor):
            return h
        return h.rec.get(h)


def build_program(symbol):
    """The counterpart of ``mxnet_tpu.executor._build_program(symbol,
    {})``: flatten the graph into one schedule, once.

    The walk drops each value after its last consumer (the heads stay).
    Mirrored nodes (:func:`_mirror_segments`) run in the forward like
    any other, under saved-tensor hooks (:class:`_MirrorHooks`): what
    they save, and what outside ops save of their outputs, is recomputed
    from the segment's inputs when the backward first needs it.  This
    departs from the JAX package, which wraps each segment in
    ``jax.checkpoint`` and so keeps the segment's outputs: a
    BatchNorm-ReLU segment's output is what the next convolution saves,
    and the reference's backward reads its mirrored copy instead.  On
    Inception-BN the port's design keeps less than a per-segment
    ``torch.utils.checkpoint`` does (PERF.md, section 6).  A segment that
    draws random numbers draws them from a copy of the generator at the
    segment's state, and its recompute from another copy at that same
    state, so it replays the same stream; the caller's generator then
    moves on as if unmirrored.  The BatchNorm aux updates come from the
    forward only: the recompute's are dropped."""
    topo = symbol._topo()
    variables = [n for n in topo if n.is_variable]
    op_nodes = [n for n in topo if not n.is_variable]
    heads = list(symbol._heads)
    needs_rng = any(getattr(n.op, "need_rng", False) for n in op_nodes)
    segments = _mirror_segments(op_nodes)
    n_mirrored = sum(1 for m, _ in segments if m)

    head_keys = {(id(n), i) for n, i in heads}
    last_use = {}
    for pos, node in enumerate(op_nodes):
        for c, ci in node.inputs:
            last_use[(id(c), ci)] = pos
    frees = [[] for _ in op_nodes]     # values dead after position pos
    for pos, node in enumerate(op_nodes):
        for i in range(node.num_outputs):
            key = (id(node), i)
            if key not in head_keys and key not in last_use:
                frees[pos].append(key)
    for key, pos in last_use.items():
        if key not in head_keys:
            frees[pos].append(key)

    # the mirrored segments by their first position: (nodes, ordered
    # keys of the inputs from outside the segment)
    seg_at = {}
    pos_of = {id(n): p for p, n in enumerate(op_nodes)}
    for m, nodes in segments:
        if not m:
            continue
        inside = {id(n) for n in nodes}
        ext = []
        for n in nodes:
            for c, ci in n.inputs:
                if id(c) not in inside and (id(c), ci) not in ext:
                    ext.append((id(c), ci))
        seg_at[pos_of[id(nodes[0])]] = (nodes, ext)

    # a Symbol.grad node walks its base graph through a program built
    # here, under the envs this build reads (the registry keys on them)
    forwards = {id(n): functools.partial(n.op.forward,
                                         trace=build_program(n.op._base).trace)
                for n in op_nodes if hasattr(n.op, "_base")}
    from .parallel.ring_attention import (current_sequence_parallel,
                                          sequence_parallel)
    from .parallel.tensor_parallel import TPShards, run_tp

    def forward_of(node):
        """The node's forward: its op's, or, when an input is split over
        tp (a :class:`~.parallel.tensor_parallel.TPShards`), the op's
        tensor-parallel form (raising when it has none)."""
        fwd = forwards.get(id(node), node.op.forward)

        def run(ins, aux_in, is_train, key):
            if any(isinstance(v, TPShards) for v in ins):
                return run_tp(node.op, node.name, ins, aux_in, is_train, key)
            return fwd(ins, aux_in, is_train, key)
        return run

    def run_node(node, values, aux_values, aux_out, rng, is_train, monitor):
        op = node.op
        ins = [values[(id(c), ci)] for c, ci in node.inputs]
        aux_names = ["%s_%s" % (node.name, a)
                     for a in op.list_auxiliary_states()]
        aux_in = [aux_values[a] for a in aux_names]
        key = rng if getattr(op, "need_rng", False) else None
        outs, aux_updates = forward_of(node)(ins, aux_in, is_train, key)
        for i, o in enumerate(outs):
            values[(id(node), i)] = o
        if aux_updates is not None:
            for a, u in zip(aux_names, aux_updates):
                aux_out[a] = u
        if monitor is not None:
            for oname, o in zip(op.list_outputs(), outs):
                monitor("%s_%s" % (node.name, oname), o)

    def walk(step, values, aux_out, rngs, mirror):
        """Run every node over the members' ``values`` (one dict a member)
        by ``step(node, values, aux_out, rngs)``, dropping each value
        after its last consumer.  With ``mirror``, the mirrored segments
        run under :class:`_MirrorHooks`: each keeps its inputs, every
        member's, and its recompute runs ``step`` over the segment's
        nodes on every member again, from copies of the generators at
        the segment's start (the callers' generators then move on as if
        unmirrored), under the sequence-parallel context that was active
        (a ring inside it rotates as it did); its aux updates are
        dropped."""
        n = len(values)
        hooks = _MirrorHooks() if mirror else None
        sp_ctx = current_sequence_parallel()

        def segment(nodes):
            def run(local, gens):
                vals = [{} for _ in range(n)]
                for (r, k), v in local.items():
                    vals[r][k] = v
                with sequence_parallel(sp_ctx) if sp_ctx is not None \
                        else contextlib.nullcontext():
                    for node in nodes:
                        step(node, vals, [{} for _ in range(n)],
                             gens or rngs)
                for r in range(n):
                    for k, v in vals[r].items():
                        local[(r, k)] = v
            return run

        pos, cur, copies, end = 0, rngs, None, -1
        with torch.autograd.graph.saved_tensors_hooks(hooks.pack,
                                                      hooks.unpack) \
                if mirror else contextlib.nullcontext():
            while pos < len(op_nodes):
                if mirror and pos in seg_at:
                    nodes, ext = seg_at[pos]
                    ext_keys = [(r, k) for r in range(n) for k in ext]
                    hooks.inputs = [values[r][k] for r, k in ext_keys]
                    draws = any(getattr(m.op, "need_rng", False)
                                for m in nodes)
                    rec = _Recompute(segment(nodes), ext_keys, hooks.inputs,
                                     rngs if draws else None)
                    hooks.current, end = rec, pos + len(nodes)
                    gens, copies = rec.generators()
                    cur = gens or rngs
                node = op_nodes[pos]
                step(node, values, aux_out, cur)
                if mirror and hooks.current is not None:
                    for r in range(n):
                        for i in range(node.num_outputs):
                            o = values[r].get((id(node), i))
                            if isinstance(o, torch.Tensor):
                                hooks.produced[o] = (hooks.current,
                                                     (r, (id(node), i)))
                for key in frees[pos]:
                    for r in range(n):
                        values[r].pop(key, None)
                pos += 1
                if pos == end:
                    if copies:
                        for g, c in zip(hooks.current.snap[0], copies):
                            g.set_state(c.get_state())
                    hooks.current, hooks.inputs = None, ()
                    cur, copies, end = rngs, None, -1

    def trace(arg_values, aux_values, rng, is_train, monitor=None,
              mirror=True):
        values = {}
        aux_out = dict(aux_values)
        for node in variables:
            values[(id(node), 0)] = arg_values[node.name]

        def step(node, vals, aux_outs, rngs):
            run_node(node, vals[0], aux_values, aux_outs[0], rngs[0],
                     is_train, monitor)
        # a monitor observes every op output (a recompute would report
        # them twice): monitored walks run unmirrored, as in the JAX
        # package; so do walks that record no gradient
        walk(step, [values], [aux_out], [rng],
             bool(n_mirrored and mirror and monitor is None
                  and torch.is_grad_enabled()))
        return [values[(id(n), i)] for n, i in heads], aux_out

    def trace_replicas(arg_lists, aux_lists, rngs, is_train, group,
                       sharded=(), seq=None):
        """The lockstep walk over a batch split across replicas: each
        node runs on every replica (``arg_lists[r]``, ``aux_lists[r]``:
        name -> tensor on ``group.devices[r]``) before the next node
        runs.  ``sharded``: the inputs split over the batch axis (the
        data and labels); every other variable is replicated.

        A value is replicated when every input of the node that made it
        is; its gradient on each replica is that replica's share, and
        the shares sum to the whole, as the parameters' (summed over the
        replicas after the backward) do.  So a node that sums over the
        batch axis (``forward_replicas`` of BatchNorm, the loss heads'
        normalizers, ``sum``/``max``/``min`` over axis 0, ``norm``,
        ``softmax_cross_entropy``, the capacity and aux loss of ``MoE``)
        reduces across the replicas in its forward and in its backward
        (its third result says which outputs are replicated: one flag,
        or one an output), and a loss head whose backward is
        its own (``injects_grad``) reads a replicated input on replica 0
        alone.

        ``seq``: a :class:`~.parallel.sequence_parallel.SeqWalk` when the
        sharded inputs are split over an sp axis too: every node that
        reads a value split over sp runs through
        :func:`~.parallel.sequence_parallel.run_sp` (per token, its sp
        form, or a raise naming the op), and ``seq.head_dims`` gets each
        head's sequence dimension.

        Mirrored segments (``force_mirroring``, ``MXNET_BACKWARD_DO_MIRROR``)
        run under the saved-tensor hooks of :func:`build_program`'s walk,
        with every replica's share of a segment in one recompute: the
        backward runs the segment again on every replica in lockstep
        (a ring inside it rotates as it did), under the sequence-parallel
        context that was active.  Returns ``(outputs, aux_out,
        replicated)``: the heads of each replica, each replica's aux
        updates, and whether each head is replicated."""
        from .parallel.sequence_parallel import run_sp
        n = len(arg_lists)
        values = [{} for _ in range(n)]
        rep, lay = {}, {}
        aux_out = [dict(a) for a in aux_lists]
        sharded = set(sharded)
        for node in variables:
            key = (id(node), 0)
            for r in range(n):
                values[r][key] = arg_lists[r][node.name]
            rep[key] = node.name not in sharded
            if seq is not None and not rep[key]:
                if node.name not in seq.seq_dims:
                    raise MXNetError(
                        "sequence parallelism: input %s is split over the "
                        "batch but has no sequence axis" % node.name)
                lay[key] = seq.seq_dims[node.name]
        scope = _device_scopes(group)

        def step(node, values, aux_out, rngs):
            op = node.op
            keys = [(id(c), ci) for c, ci in node.inputs]
            all_rep = all(rep[k] for k in keys)
            ins = [[values[r][k] for k in keys] for r in range(n)]
            aux_names = ["%s_%s" % (node.name, a)
                         for a in op.list_auxiliary_states()]
            aux_in = [[aux_lists[r][a] for a in aux_names]
                      for r in range(n)]
            keyed = rngs if getattr(op, "need_rng", False) else [None] * n
            out_lays = None
            if seq is not None and not all_rep:
                outs, updates, out_rep, out_lays = run_sp(
                    op, node.name, ins, [lay.get(k) for k in keys], aux_in,
                    is_train, keyed, group, forward_of(node), scope, seq)
            else:
                got = None
                if not all_rep and hasattr(op, "forward_replicas"):
                    got = op.forward_replicas(ins, aux_in, is_train, keyed,
                                              group)
                if got is None:
                    fwd = forward_of(node)
                    outs, updates = [], []
                    for r in range(n):
                        x = ins[r]
                        if all_rep and r \
                                and getattr(op, "injects_grad", False):
                            x = [t.detach() for t in x]
                        with scope(r):
                            o, u = fwd(x, aux_in[r], is_train, keyed[r])
                        outs.append(o)
                        updates.append(u)
                    got = (outs, updates, all_rep)
                outs, updates, out_rep = got
            for r in range(n):
                for i, o in enumerate(outs[r]):
                    values[r][(id(node), i)] = o
                if updates is not None and updates[r] is not None:
                    for a, u in zip(aux_names, updates[r]):
                        aux_out[r][a] = u
            for i in range(node.num_outputs):
                rep[(id(node), i)] = out_rep[i] \
                    if isinstance(out_rep, (list, tuple)) else out_rep
                if out_lays is not None:
                    lay[(id(node), i)] = out_lays[i]

        walk(step, values, aux_out, rngs,
             bool(n_mirrored and torch.is_grad_enabled()))
        heads_out = [[values[r][(id(h), i)] for h, i in heads]
                     for r in range(n)]
        if seq is not None:
            seq.head_dims = [lay.get((id(h), i)) for h, i in heads]
        return heads_out, aux_out, [rep[(id(h), i)] for h, i in heads]

    prog = Program(trace, needs_rng, segments, n_mirrored)
    prog.trace_replicas = trace_replicas
    return prog


def _device_scopes(group):
    """``scope(r)``: ``torch.cuda.device`` of replica r's card when the
    replicas span several cards (the hand kernels' wrappers launch on the
    current device's stream), else nothing."""
    import contextlib
    if not getattr(group, "nccl", False):
        return lambda r: contextlib.nullcontext()
    return lambda r: torch.cuda.device(group.devices[r])


def replica_head_grads(outs, replicated):
    """Head gradients of a lockstep walk: ones for a head split across
    replicas; for a replicated head ones on replica 0 and zeros on the
    others (the shares of its gradient sum to ones)."""
    return [[torch.ones_like(o) if not rep or r == 0 else torch.zeros_like(o)
             for o, rep in zip(outs_r, replicated)]
            for r, outs_r in enumerate(outs)]


def trace_residual_bytes(trace, arg_values, aux_values, wrt_names):
    """Bytes of the tensors one training walk keeps for its backward,
    with gradients wanted for ``wrt_names``: every distinct storage that
    an op saves (``torch.autograd.graph.saved_tensors_hooks``) or that a
    mirrored segment keeps as its input; what a mirrored segment will
    recompute is not counted.  The counterpart of the JAX package's
    ``trace_residual_bytes``: the activation memory mirroring shrinks."""
    leaves = {n: arg_values[n].detach().requires_grad_(True)
              for n in wrt_names}
    merged = dict(arg_values)
    merged.update(leaves)
    _RESIDUALS.tensors = kept = []
    try:
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_keep, lambda t: t):
            outs, _aux = trace(merged, aux_values, None, True)
    finally:
        _RESIDUALS.tensors = None
    seen, total = set(), 0
    for t in kept:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    del outs
    return total


#: (graph key, device, compute dtype, mirror envs) -> Program
_PROGRAM_REGISTRY = {}
_REGISTRY_LOCK = threading.Lock()


def program_registry_stats():
    """``{"hits", "misses", "lowerings", "programs"}``: the compile-cache
    counters (a lowering is one ``build_program``) and the registry's
    size.  "Zero lowerings after warmup" is a delta of these."""
    from .parallel import overlap as _overlap
    stats = _overlap.compile_cache_stats()
    with _REGISTRY_LOCK:
        stats["programs"] = len(_PROGRAM_REGISTRY)
    return stats


def _graph_key(symbol):
    """The graph's fingerprint, with the base graph and the ``wrt`` list
    of each of its ``Symbol.grad`` nodes (whose JSON names only the
    op)."""
    from .parallel import overlap as _overlap
    bases = tuple((_graph_key(n.op._base), tuple(n.op._wrt))
                  for n in symbol._topo()
                  if n.op is not None and hasattr(n.op, "_base"))
    return (_overlap.graph_fingerprint(symbol),) + bases


def _lookup_program(symbol, device):
    """The registry's program for ``symbol`` on ``device``, built on a
    miss.  The key holds everything a build reads besides the graph: the
    compute dtype and the mirroring envs (a program built before
    ``MXNET_BACKWARD_DO_MIRROR=1`` is not reused after it)."""
    from .parallel import overlap as _overlap
    key = (_graph_key(symbol), str(device),
           os.environ.get("MXNET_COMPUTE_DTYPE", ""),
           os.environ.get("MXNET_BACKWARD_DO_MIRROR", ""),
           os.environ.get("MXNET_BACKWARD_MIRROR_STEP", ""))
    with _REGISTRY_LOCK:
        prog = _PROGRAM_REGISTRY.get(key)
        if prog is None:
            _overlap.note_lowering()
            prog = _PROGRAM_REGISTRY[key] = build_program(symbol)
        else:
            _overlap.note_hit()
    return prog


def _bind_compute_dtype(arrays):
    """The dtype a bind's products run at, which the roofline rules price:
    ``MXNET_COMPUTE_DTYPE`` when set, else the narrowest floating dtype of
    the bound arrays (bfloat16 weights make bfloat16 products; fp8 weights
    are QuantizedDense's, whose rows carry their own)."""
    name = os.environ.get("MXNET_COMPUTE_DTYPE", "").strip()
    if name:
        return "float32" if name == "f32" else name
    floats = {a.dtype for a in arrays if a is not None and a.dtype in (
        torch.float16, torch.bfloat16, torch.float32, torch.float64)}
    if not floats:
        return None
    return str(min(floats, key=lambda d: d.itemsize)).replace("torch.", "")


class Executor:
    """Parity: include/mxnet/symbolic.h:323 + python/mxnet/executor.py.

    ``args`` (and ``args_grad``, ``aux_states``) are lists aligned with
    the symbol's arguments (aux states) or name -> NDArray dicts.
    ``grad_req`` is ``"write"``, ``"add"`` or ``"null"``, a list, or a
    dict (missing names ``"null"``); an argument without a gradient array
    gets ``"null"``.  Missing aux states are allocated as zeros.

    ``validate`` is the bind-time lint (``analysis/``): ``"warn"`` (the
    default, or ``MXTPU_BIND_VALIDATE``) emits one ``GraphLintWarning``
    listing the warning and error findings, ``"error"`` refuses to bind
    a graph with an error finding (the reference GraphExecutor's
    fail-at-bind contract), ``"off"`` skips the pass.  The findings are
    kept as ``bind_issues``.  The lint's target is the bound context's
    ``device_type``: ``"gpu"`` runs the launch-budget (MXL-K) and
    roofline (MXL-R) families too."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, validate=None):
        self._symbol = symbol
        self._device = resolve(ctx)
        self._ctx = ctx if isinstance(ctx, Context) \
            else Context.from_device(self._device)
        if validate is None:
            validate = os.environ.get("MXTPU_BIND_VALIDATE", "warn")
        if validate not in ("warn", "error", "off"):
            raise MXNetError("validate must be 'warn', 'error' or 'off', "
                             "got %r" % (validate,))
        self._validate_mode = validate
        self._arg_names = symbol.list_arguments()
        self._out_names = symbol.list_outputs()
        self._aux_names = symbol.list_auxiliary_states()

        arg_list = _as_list(args, self._arg_names, "args")
        missing = [n for n, a in zip(self._arg_names, arg_list) if a is None]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self.arg_arrays = arg_list
        self.arg_dict = dict(zip(self._arg_names, arg_list))

        self.grad_arrays = _as_list(args_grad, self._arg_names, "args_grad")
        self.grad_dict = {n: g for n, g in zip(self._arg_names,
                                                self.grad_arrays)
                          if g is not None}
        if isinstance(grad_req, str):
            req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            req = dict(zip(self._arg_names, grad_req))
        else:
            req = {n: grad_req.get(n, "null") for n in self._arg_names}
        for n in self._arg_names:
            if req.get(n, "null") not in ("null", "write", "add"):
                raise MXNetError("invalid grad_req %r" % req[n])
            if req.get(n) != "null" and n not in self.grad_dict:
                req[n] = "null"
        self._grad_req = req

        aux_list = _as_list(aux_states, self._aux_names, "aux_states")
        if any(a is None for a in aux_list):
            _, _, aux_shapes = symbol.infer_shape(
                **{n: a.shape for n, a in self.arg_dict.items()})
            if aux_shapes is None:
                raise MXNetError("bind: cannot infer aux shapes")
            aux_list = [a if a is not None else zeros(s, ctx=self._ctx)
                        for a, s in zip(aux_list, aux_shapes)]
        self.aux_arrays = aux_list
        self.aux_dict = dict(zip(self._aux_names, aux_list))

        # static graph lint BEFORE the first walk: a bad graph fails here
        # with positioned findings instead of deep inside a forward
        # (GraphExecutor bind-time inference parity; analysis/)
        self.bind_issues = []
        if validate != "off":
            self._validate_bind(args, args_grad, grad_req, aux_states)

        self._program = _lookup_program(symbol, self._device)
        self._replicas = None       # (ReplicaGroup, sharded names)
        self._monitor_callback = None
        self.outputs = [None] * len(self._out_names)
        self._pending = None        # (outputs, leaves) of a training forward
        self._n_forward = 0
        self._n_fwd_bwd = 0
        self._n_fused_step = 0

    def _validate_bind(self, args, args_grad, grad_req, aux_states):
        """Run the static analyzer with the full bind context and apply
        the ``validate=`` policy: ``"warn"`` emits one GraphLintWarning
        summarizing the warning and error findings, ``"error"`` raises
        MXNetError when any error finding exists.  The roofline rules
        price the products at :func:`_bind_compute_dtype`."""
        from .analysis import analyze, format_issues, GraphLintWarning
        # no world_size= here: AnalysisContext reads
        # MXTPU_LINT_DISTRIBUTED / MXTPU_LINT_WORLD_SIZE itself
        issues = analyze(
            self._symbol,
            shapes={n: tuple(a.shape) for n, a in self.arg_dict.items()},
            type_dict={n: a.dtype for n, a in self.arg_dict.items()},
            args=args, args_grad=args_grad, grad_req=grad_req,
            aux_states=aux_states, target=self._ctx.device_type,
            compute_dtype=_bind_compute_dtype(self.arg_arrays))
        self.bind_issues = issues
        errors = [i for i in issues if i.severity == "error"]
        visible = [i for i in issues if i.severity != "info"]
        if errors and self._validate_mode == "error":
            raise MXNetError(
                "bind validation failed with %d error(s) (pass "
                "validate='warn'/'off' or fix the graph):\n%s"
                % (len(errors), format_issues(errors)))
        if visible:
            import warnings
            warnings.warn("graph lint found %d issue(s) at bind:\n%s"
                          % (len(visible), format_issues(visible)),
                          GraphLintWarning, stacklevel=3)

    @property
    def output_dict(self):
        if len(set(self._out_names)) != len(self._out_names):
            raise MXNetError("Duplicate names detected in outputs: %s"
                             % (self._out_names,))
        return dict(zip(self._out_names, self.outputs))

    def _wrt_names(self):
        return tuple(n for n in self._arg_names
                     if self._grad_req.get(n, "null") != "null")

    def _rng(self):
        if not self._program.needs_rng:
            return None
        from . import random as _random
        return _random.generator(self._device)

    def _set_args(self, kwargs):
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % name)
            self.arg_dict[name]._set_data(arr)

    def _forward_raw(self, arg_values, aux_values=None, is_train=False,
                     monitor=None):
        """Evaluate the graph on a name->tensor dict; returns the head
        tensors as a list (caller-owned; ``forward`` wraps them).  The
        walk's aux updates are dropped (forward only); a graph whose ops
        draw random numbers (the samplers) is handed the device's
        generator."""
        aux_values = aux_values or {n: a.data
                                    for n, a in self.aux_dict.items()}
        with torch.no_grad():
            outs, _aux_updates = self._program.trace(
                arg_values, aux_values, self._rng(), is_train,
                monitor=monitor)
        return outs

    def _publish(self, outs, aux_out, aux_values):
        self.outputs = [NDArray(o.detach()) for o in outs]
        for n, a in self.aux_dict.items():
            if aux_out[n] is not aux_values[n]:
                a._set_data(aux_out[n].detach())

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` overwrite bound arguments first.
        Returns the output NDArrays (also kept in ``outputs``).  With
        ``is_train`` the aux states take the walk's updates, and the
        graph is kept for :meth:`backward`.  An installed monitor
        callback sees every op output (the walk then runs unmirrored)."""
        return self._forward(is_train, kwargs, self._run_monitor
                             if self._monitor_callback is not None else None)

    def _forward(self, is_train, kwargs, monitor):
        self._set_args(kwargs)
        self._n_forward += 1
        self._pending = None
        if self._replicas is not None:
            if monitor is not None:
                raise MXNetError("a monitor on an executor over several "
                                 "devices is not ported yet (ROADMAP.md "
                                 "queue 1 item 3)")
            wrt = self._wrt_names() if is_train else ()
            with torch.set_grad_enabled(bool(wrt)):
                outs, aux_out = self._replica_forward(is_train, wrt)
            self._publish(outs, aux_out, {n: a.data for n, a
                                          in self.aux_dict.items()})
            return self.outputs
        args = {n: a.data for n, a in self.arg_dict.items()}
        aux_values = {n: a.data for n, a in self.aux_dict.items()}
        wrt = self._wrt_names() if is_train else ()
        if not is_train:
            outs = self._forward_raw(args, aux_values, monitor=monitor)
            self.outputs = [NDArray(o) for o in outs]
            return self.outputs
        leaves = {n: args[n].detach().requires_grad_(True) for n in wrt}
        args.update(leaves)
        with torch.set_grad_enabled(bool(wrt)):
            outs, aux_out = self._program.trace(args, aux_values,
                                                self._rng(), True,
                                                monitor=monitor)
        if wrt:
            self._pending = (outs, leaves)
        self._publish(outs, aux_out, aux_values)
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward into the gradient arrays
        (``write`` replaces, ``add`` accumulates).  ``out_grads`` are the
        head gradients (default ones; the loss heads ignore them)."""
        wrt = self._wrt_names()
        if not wrt:
            return
        if self._pending is None:
            raise MXNetError("backward called before forward(is_train=True)")
        if self._pending[0] == "replicas":
            grads = self._replica_backward(out_grads)
            self._n_fwd_bwd += 1
            with torch.no_grad():
                for n in wrt:
                    tgt = self.grad_dict[n]
                    if self._grad_req[n] == "add":
                        tgt._set_data(tgt.data + grads[n])
                    else:
                        tgt._set_data(grads[n])
            return
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            ograds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            ograds = [(g.data if isinstance(g, NDArray) else
                       torch.as_tensor(g)).to(o.device, o.dtype)
                      for g, o in zip(out_grads, outs)]
        self._n_fwd_bwd += 1
        grads = _grads(outs, leaves, ograds)
        with torch.no_grad():
            for n in wrt:
                tgt = self.grad_dict[n]
                if self._grad_req[n] == "add":
                    tgt._set_data(tgt.data + grads[n])
                else:
                    tgt._set_data(grads[n])

    def forward_backward(self, out_grads=None, **kwargs):
        """Forward in training mode, then backward; returns the outputs.
        The monitor is not called: as in the JAX package, only
        :meth:`forward` reports op outputs."""
        self._forward(True, kwargs, None)
        self.backward(out_grads)
        return self.outputs

    # -- the fused train step ------------------------------------------
    def _fused_compute_dtype(self):
        """``MXNET_COMPUTE_DTYPE`` (float32 when unset) and the inputs it
        must not cast: labels and Embedding ids (bfloat16 holds integers
        exactly only up to 256)."""
        name = os.environ.get("MXNET_COMPUTE_DTYPE", "").strip()
        if not name or name in ("float32", "f32"):
            return None, frozenset()
        table = {"bfloat16": torch.bfloat16, "float16": torch.float16}
        if name not in table:
            raise MXNetError("MXNET_COMPUTE_DTYPE must be float32, bfloat16 "
                             "or float16, got %r" % name)
        exempt = {n for n in self._arg_names if n.endswith("label")}
        for node in self._symbol._topo():
            if node.op is not None \
                    and getattr(node.op, "op_name", "") == "Embedding":
                src, _ = node.inputs[0]
                if src.is_variable:
                    exempt.add(src.name)
        return table[name], frozenset(exempt)

    def _fused(self, optimizer):
        """``(wrt names, {name: (lr mult, wd mult)})`` for ``optimizer``."""
        wrt = self._wrt_names()
        name2idx = {n: i for i, n in optimizer.idx2name.items()}
        mults = {}
        for n in wrt:
            idx = name2idx.get(n, n)
            mults[n] = (optimizer.lr_mult.get(
                idx, optimizer.lr_mult.get(n, 1.0)),
                optimizer.wd_mult.get(idx, optimizer.wd_mult.get(n, 1.0)))
        return wrt, mults

    def fused_step(self, optimizer, states, num_update, **kwargs):
        """One whole training step in one call: the forward in training
        mode, the gradients (ones as head gradients) and the optimizer's
        ``_preprocess_grad`` + ``update_fn`` on every learnable argument,
        leaf by leaf, with its lr and wd multipliers (the JAX package's
        ``fused_step``).  Under ``MXNET_COMPUTE_DTYPE`` the forward and
        backward run in that dtype on casts of the float32 weights and
        aux, whose updates are cast back.  Writes the new weights into the
        argument arrays, the gradients into the gradient arrays, the aux
        and the outputs; returns the new ``states`` (name -> state)."""
        wrt, mults = self._fused(optimizer)
        self._set_args(kwargs)
        self._pending = None
        cdt, exempt = self._fused_compute_dtype()

        def cast(name, t):
            if cdt is None or name in exempt or not t.is_floating_point():
                return t
            return t.to(cdt)

        args = {n: a.data for n, a in self.arg_dict.items()}
        aux_values = {n: a.data for n, a in self.aux_dict.items()}
        if self._replicas is not None:
            with torch.enable_grad():
                outs, aux_out = self._replica_forward(True, wrt, cast)
                grads = self._replica_backward(None)
        else:
            leaves = {n: args[n].detach().requires_grad_(True) for n in wrt}
            merged = {n: cast(n, v) for n, v in args.items()}
            merged.update({n: cast(n, v) for n, v in leaves.items()})
            with torch.enable_grad():
                outs, aux_out = self._program.trace(
                    merged, {n: cast(n, v) for n, v in aux_values.items()},
                    self._rng(), True)
            grads = _grads(outs, leaves, [torch.ones_like(o) for o in outs])
        aux_out = {k: v.detach().to(aux_values[k].dtype)
                   for k, v in aux_out.items()}
        lr = optimizer.lr_scheduler(num_update) \
            if optimizer.lr_scheduler is not None else optimizer.lr
        wd = optimizer.wd
        self._n_fused_step += 1
        new_states = dict(states)
        with torch.no_grad():
            for n in wrt:
                lrm, wdm = mults[n]
                w, st = optimizer._step(args[n], grads[n], states.get(n),
                                        lr * lrm, wd * wdm, num_update)
                self.grad_dict[n]._set_data(grads[n])
                self.arg_dict[n]._set_data(w)
                if st is not None:
                    new_states[n] = st
            self._publish(outs, aux_out, aux_values)
        return new_states

    # -- one executor over several devices (data parallelism) ---------
    def set_replicas(self, group, sharded):
        """Run this executor over the replicas of ``group`` (a
        ``parallel.collectives.ReplicaGroup`` whose first device is the
        executor's): the bound arrays are the global batch's, on the
        first device; each forward splits the ``sharded`` inputs (data
        and labels) on axis 0 over the replicas, hands every replica the
        parameters and aux states (the first device's tensors where a
        replica shares it, copies broadcast to the other cards) and runs
        the lockstep walk (``Program.trace_replicas``); the backward sums
        the replicas' parameter gradients bucket by bucket as it
        finishes them (``parallel.overlap.GradBuckets``) into the
        gradient arrays.  Outputs are the replicas' concatenated (or the
        first replica's, for a replicated head).  The JAX package's
        counterpart is one executor over a ``jax.sharding.Mesh``."""
        if group.devices[0] != self._device:
            raise MXNetError("set_replicas: the first replica is on %s, "
                             "the executor on %s" % (group.devices[0],
                                                     self._device))
        self._replicas = (group, tuple(sharded))
        self._replica_bufs = {}

    def _replicated_copies(self, values):
        """``values`` (``{name: tensor}`` on the first device) for each
        replica: a list of dicts.  A replica on the first device takes
        the tensors themselves; the others take views of one flat buffer
        a dtype, filled by one broadcast of the values packed together
        (one NCCL call a step and dtype, not one a tensor)."""
        group = self._replicas[0]
        if not group.nccl:
            return [values] * group.n
        from .parallel.collectives import broadcast
        out = [dict() for _ in range(group.n)]
        by_dtype = {}
        for name, v in values.items():
            by_dtype.setdefault(v.dtype, []).append(name)
        for dtype, names in by_dtype.items():
            flat = torch.cat([values[k].reshape(-1) for k in names])
            bufs = []
            for r, d in enumerate(group.devices):
                if d == flat.device:
                    bufs.append(flat)
                    continue
                buf = self._replica_bufs.get((dtype, r))
                if buf is None or buf.numel() != flat.numel():
                    buf = self._replica_bufs[(dtype, r)] = torch.empty_like(
                        flat, device=d)
                bufs.append(buf)
            broadcast(group, bufs, root=0)
            sizes = [values[k].numel() for k in names]
            for r, buf in enumerate(bufs):
                if buf is flat:
                    out[r].update((k, values[k]) for k in names)
                    continue
                for k, part in zip(names, torch.split(buf, sizes)):
                    out[r][k] = part.view(values[k].shape)
        return out

    def _replica_forward(self, is_train, wrt, cast=None):
        """The lockstep walk of every replica; returns the merged outputs
        and the first replica's aux updates, and keeps the graph for
        :meth:`_replica_backward` when ``wrt``."""
        group, sharded = self._replicas
        cast = cast or (lambda name, t: t)
        n = group.n
        shared = {name: a.data for name, a in self.arg_dict.items()
                  if name not in sharded}
        shared.update(("aux:" + name, a.data)
                      for name, a in self.aux_dict.items())
        copies = self._replicated_copies(shared)
        per = [{} for _ in range(n)]
        for name, a in self.arg_dict.items():
            v = a.data
            if name in sharded:
                if v.shape[0] % n:
                    raise MXNetError("executor over %d devices: %s has "
                                     "%d rows" % (n, name, v.shape[0]))
                parts = [p.to(d) for p, d in
                         zip(torch.chunk(v, n, dim=0), group.devices)]
            else:
                parts = [c[name] for c in copies]
            for r in range(n):
                per[r][name] = parts[r]
        leaves = [{k: per[r][k].detach().requires_grad_(True) for k in wrt}
                  for r in range(n)]
        args = []
        for r in range(n):
            a = {k: cast(k, v) for k, v in per[r].items()}
            a.update({k: cast(k, v) for k, v in leaves[r].items()})
            args.append(a)
        auxs = [{name: cast(name, copies[r]["aux:" + name])
                 for name in self.aux_dict} for r in range(n)]
        rngs = [None] * n
        if self._program.needs_rng:
            from . import random as _random
            rngs = [_random.generator(d) for d in group.devices]
        outs, aux_out, reps = self._program.trace_replicas(
            args, auxs or [{} for _ in range(n)], rngs, is_train, group,
            sharded)
        if wrt:
            self._pending = ("replicas", outs, reps, leaves)
        merged = []
        for i, rep in enumerate(reps):
            if rep:
                merged.append(outs[0][i])
            else:
                merged.append(torch.cat([o[i].detach().to(self._device)
                                         for o in outs]))
        return merged, aux_out[0]

    def _replica_backward(self, out_grads):
        """The backward of :meth:`_replica_forward`'s walk: ``{name:
        gradient}`` on the first device, the replicated arguments'
        summed over the replicas, a split input's concatenated."""
        from .parallel.collectives import all_reduce
        from .parallel.overlap import GradBuckets, interleave_grad_buckets
        _tag, outs, reps, leaves = self._pending
        self._pending = None
        group, sharded = self._replicas
        n = group.n
        if out_grads is None:
            hgrads = replica_head_grads(outs, reps)
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            hgrads = [[] for _ in range(n)]
            for i, (g, rep) in enumerate(zip(out_grads, reps)):
                g = g.data if isinstance(g, NDArray) else torch.as_tensor(g)
                parts = torch.chunk(g, n, dim=0) if not rep else \
                    [g] + [torch.zeros_like(g)] * (n - 1)
                for r in range(n):
                    hgrads[r].append(parts[r].to(outs[r][i].device,
                                                 outs[r][i].dtype))
        shared = [k for k in leaves[0] if k not in sharded]

        def reduce(names, grads):
            sums = all_reduce(group, [
                torch.cat([g[k].reshape(-1) for k in names]) for g in grads])
            sizes = [grads[0][k].numel() for k in names]
            return {k: part.view(grads[0][k].shape)
                    for k, part in zip(names, torch.split(sums[0], sizes))}
        plan = interleave_grad_buckets({k: leaves[0][k] for k in shared})
        reducer = GradBuckets([{k: lv[k] for k in shared} for lv in leaves],
                              plan, reduce)
        heads, hg = [], []
        for o_r, g_r in zip(outs, hgrads):
            for o, g in zip(o_r, g_r):
                if o.requires_grad:
                    heads.append(o)
                    hg.append(g)
        if heads:
            torch.autograd.backward(heads, hg)
        grads = {}
        for part in reducer.finish():
            grads.update(part)
        for k in leaves[0]:
            if k in sharded:
                grads[k] = torch.cat([
                    (lv[k].grad if lv[k].grad is not None
                     else torch.zeros_like(lv[k])).to(self._device)
                    for lv in leaves])
        return grads

    def init_fused_states(self, optimizer):
        """Optimizer state for every learnable argument (fused path)."""
        states = {}
        for n in self._wrt_names():
            a = self.arg_dict[n]
            s = optimizer.create_state_arrays(a.shape, a.dtype, a.data.device)
            if s is not None:
                states[n] = s
        return states

    def backward_residual_bytes(self):
        """Bytes the training walk keeps for the backward at the bound
        arrays (:func:`trace_residual_bytes`): what mirroring shrinks."""
        return trace_residual_bytes(
            self._program.trace, {n: a.data for n, a in self.arg_dict.items()},
            {n: a.data for n, a in self.aux_dict.items()}, self._wrt_names())

    def debug_str(self):
        """The symbol's ``debug_str`` and the megabytes of the bound
        arguments, gradients and aux states (GraphExecutor::Print)."""
        total = sum(a.size * a.data.element_size()
                    for a in self.arg_arrays + self.aux_arrays
                    + [g for g in self.grad_arrays if g is not None])
        return "\n".join([self._symbol.debug_str(), "",
                          "Total %d MB allocated (args+grads+aux)"
                          % (total // (1 << 20))])

    # -- monitor (MXExecutorSetMonitorCallback parity) ------------------
    def set_monitor_callback(self, callback):
        """``callback(name, NDArray)`` for every op output of each
        :meth:`forward`; None removes it."""
        self._monitor_callback = callback

    def _run_monitor(self, name, value):
        self._monitor_callback(name, NDArray(value.detach()))

    # -- parameters and shapes -----------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``arg_params``/``aux_params`` (name -> NDArray) into the
        bound arrays; an unknown name raises unless
        ``allow_extra_params``."""
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name]._set_data(arr)
            elif not allow_extra_params:
                raise MXNetError("unknown argument %r" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name]._set_data(arr)
            elif not allow_extra_params:
                raise MXNetError("unknown aux state %r" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **new_shapes):
        """A new executor for new input shapes (executor.py:270): arrays
        whose shape is unchanged are shared, the others allocated; an
        argument other than those named may change shape only with
        ``partial_shaping``."""
        arg_shapes, _, _ = self._symbol.infer_shape(**new_shapes)
        if arg_shapes is None:
            raise MXNetError("reshape: cannot infer shapes from %s"
                             % new_shapes)
        new_args, new_grads = {}, {}
        for name, shape in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict[name]
            if tuple(cur.shape) == tuple(shape):
                new_args[name] = cur
                if name in self.grad_dict:
                    new_grads[name] = self.grad_dict[name]
                continue
            if not partial_shaping and name not in new_shapes:
                raise MXNetError("reshape changed shape of %s; pass "
                                 "partial_shaping=True" % name)
            new_args[name] = zeros(shape, ctx=self._ctx, dtype=cur.dtype)
            if name in self.grad_dict:
                new_grads[name] = zeros(shape, ctx=self._ctx,
                                        dtype=cur.dtype)
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, dict(self.aux_dict),
                        validate=self._validate_mode)


def _grads(outs, leaves, head_grads):
    """``{name: gradient}`` of ``outs`` with respect to ``leaves``; an
    argument the heads do not reach (a fixed BatchNorm gamma) gets
    zeros, as the vjp gives in the JAX package."""
    names = list(leaves)
    got = torch.autograd.grad(outs, [leaves[n] for n in names], head_grads,
                              allow_unused=True)
    return {n: torch.zeros_like(leaves[n]) if g is None else g
            for n, g in zip(names, got)}


def check_group2ctx(group2ctx, what):
    """A ``group2ctx`` of None or ``{}`` binds every node on the bind
    context; a placement map raises: placement by ``ctx_group`` is not
    ported (ROADMAP.md queue 1 item 3 (j))."""
    if group2ctx:
        raise MXNetError(
            "%s: group2ctx placement by ctx_group (%s) is not ported yet "
            "(ROADMAP.md queue 1 item 3 (j)); bind without it"
            % (what, ", ".join(sorted(str(k) for k in group2ctx))))


def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                group2ctx=None, shared_exec=None, validate=None, **kwargs):
    """Allocate argument, gradient and aux arrays from the shapes inferred
    from ``kwargs`` (name -> shape), then bind (parity:
    symbol.py:630-710); ``validate`` as :class:`Executor`'s.
    ``shared_exec`` is ignored (the reference's memory sharing changes no
    result); a non-empty ``group2ctx`` raises (:func:`check_group2ctx`)."""
    check_group2ctx(group2ctx, "simple_bind")
    arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
    if arg_shapes is None:
        raise MXNetError("simple_bind: cannot infer shapes from %s" % kwargs)
    arg_names = symbol.list_arguments()
    type_dict = type_dict or {}
    if isinstance(grad_req, str):
        reqs = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, dict):
        reqs = {n: grad_req.get(n, "null") for n in arg_names}
    else:
        reqs = dict(zip(arg_names, grad_req))
    args, grads = {}, {}
    for name, shape in zip(arg_names, arg_shapes):
        dtype = type_dict.get(name, "float32")
        args[name] = zeros(shape, ctx=ctx, dtype=dtype)
        if reqs.get(name, "null") != "null":
            grads[name] = zeros(shape, ctx=ctx, dtype=dtype)
    aux = [zeros(s, ctx=ctx) for s in aux_shapes]
    return Executor(symbol, ctx, args, grads, grad_req, aux,
                    validate=validate)
