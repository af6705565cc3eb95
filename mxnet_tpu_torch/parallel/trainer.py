"""ShardedTrainer: one training step of a Symbol on a device mesh.

The port of ``mxnet_tpu/parallel/trainer.py``.  The JAX trainer
compiles forward, backward, gradient reduction and the optimizer update
into one jitted program over a device mesh; the port runs the same step
eagerly:

1. the graph walk (``executor.build_program``) with autograd on, the
   parameters cast to ``compute_dtype`` (Embedding ids and labels
   exempt: bfloat16 holds integers exactly only up to 256);
2. the backward of the outputs with ones as head gradients (the loss
   heads ignore them, as in the reference);
3. the optimizer update: leafwise ``_preprocess_grad`` + ``update_fn``,
   or the fused sweep (``MXTPU_FUSED_OPT``: ``'1'`` plain, ``'kernel'``
   the CUDA sweep of ``kernels/fused_opt.py``), bitwise equal.

On a mesh of one device the arrays are plain tensors.  On a ``dp`` mesh
of several (:func:`~.mesh.make_mesh`) they are
:class:`~.sharding.ShardedArray`s: parameters, aux states and (without
``zero1``) the optimizer state replicated, one copy a replica, and the
batch split over the replicas on axis 0 (:meth:`shard_batch`; in a
process group each process passes its own part).  The step is then the
lockstep walk of ``Program.trace_replicas`` (every node on every
replica before the next; BatchNorm and the other batch reductions
reduce across the replicas), one ``torch.autograd.backward`` over every
replica's heads, the gradients summed over the replicas bucket by
bucket as the backward finishes each (``overlap.GradBuckets``,
``MXTPU_BUCKET_MB``), and each replica's update (its own sweep).  It
equals the one-device step on the global batch, up to the order of the
sums.  ``zero1=True`` keeps each leaf's optimizer state split on axis 0
over dp where that axis divides, else whole on every replica
(:meth:`opt_state_sharding`, the JAX placement): each bucket is laid out
by device so that one reduce-scatter hands each device its slices, the
update runs once a device over one flat vector of its slices (the CUDA
sweep in kernel mode), and the new weights are all-gathered.  ZeRO-1
slices the update, so it takes elementwise optimizers only.

Batches come from :meth:`ShardedTrainer.shard_batch`, or from
:meth:`ShardedTrainer.prefetch_feed`, the async device feed
(``overlap.DevicePrefetcher``); a uint8 image batch crosses to the
device as uint8 and is widened there to the parameters' dtype (float32;
``compute_dtype`` when one is set).

On a mesh with an ``ep`` axis (expert parallelism, over an MoE graph)
each member holds only its ``K/ep`` slice of every expert stack (any
parameter whose name contains ``expert``: ``sharding.param_pspec``) and
that slice's optimizer state; the gate and the other parameters stay
replicated on every member.  The batch is split over ``dp`` alone, so
the ``ep`` members of one dp replica see the same tokens: the first
member of each replica walks the graph (the walkers' lockstep walk, as
in dp), and each ``MoE`` node hands every member of the replica's ep
group the replica's tokens; the member computes its experts' share of
the output on its own device, and the shares are summed by
``collectives.all_reduce_autograd`` (``ops.moe.ExpertShards``).  The
step is the dp step: the replicated parameters' gradients are summed
over the walkers in its buckets, each bucket's sums copied to the
walker's ep members; an expert slice's gradient is summed over the
members that hold it (one a dp replica).  Every member then updates its own leaves (its own sweep,
the CUDA one in kernel mode).  ``zero1=True`` with ``ep`` above 1 is not
ported (ROADMAP.md queue 1 item 3 (e2)).

On a mesh with a ``tp`` axis (tensor parallelism; members in row-major
``(dp, tp)`` order) the parameters split by the JAX package's tp policy
(:meth:`param_sharding`): each member holds its part of every split
parameter and of its optimizer state, the rest replicated.  The first
member of each dp replica's tp group walks the graph as with ep; a
split parameter reaches its ops as a
:class:`~.tensor_parallel.TPShards` of the group's parts, and each op's
tensor-parallel form computes every member's share on the member's own
device (``parallel/tensor_parallel.py``).  The gradients go as with ep:
the replicated leaves' summed over the walkers and copied to their tp
members, each split leaf's over the members that hold the same part.
``zero1=True`` splits the replicated leaves' state over dp (a split
leaf's state follows its tp split).  ``tp`` together with ``ep`` is not
ported (ROADMAP.md queue 1 item 3 (b2)).

``fsdp=True`` (on a dp mesh, with tp or without) keeps every
otherwise-replicated parameter whose axis 0 divides by dp split over dp,
with its optimizer state: each member persists 1/dp of it.  A step
all-gathers each such parameter on the walkers, walks, reduce-scatters
its gradient on ZeRO-1's layout (:meth:`_reduce_bucket`) and sweeps each
member's rows in place (:meth:`_update_zero1`); the gathered copies die
with the step.  Elementwise optimizers only, as ZeRO-1.

``remat=True`` recomputes the whole forward in the backward (one
device): the walk runs under one ``torch.utils.checkpoint`` (the JAX
trainer wraps its trace in one ``jax.checkpoint``).

Resilience, as in the JAX trainer:

- ``sentinel=True`` (or ``MXTPU_SENTINEL``; one device) gates the update
  on the device: when any preprocessed gradient is not finite the step
  keeps the old parameters, optimizer state and aux, halves the loss
  scale and counts a skip, with no host read (the fused CUDA sweep takes
  the flag as its skip flag; the plain paths keep the old values with
  ``torch.where``).  The counters ``scale``, ``good_steps``, ``skipped``
  and ``last_good`` stay on the device; :meth:`sentinel_stats` reads
  them.  ``loss_scale_init``/``loss_scale_growth`` set the scale's start
  and growth interval.
- ``step_timeout_s`` (or ``MXTPU_STEP_TIMEOUT_S``) runs each step under
  the watchdog: a step that does not finish in time raises a
  ``ResilienceError`` and dumps the flight recorder, whose ledger holds
  the step as ``train_step`` (op) and its update number (seq) until it
  completes.  The ``batch`` fault seam (``kind=nan`` poisons the data
  inputs) and the ``step`` seam (``hang``/``slow``) of
  ``MXTPU_FAULT_SPEC`` are on the step; with telemetry on each step is
  recorded (``observability.record_step``).
- The checkpoint methods (:meth:`save_checkpoint`,
  :meth:`save_checkpoint_versioned`, :meth:`auto_resume`,
  :meth:`elastic_resume`, ...) write and read the host format
  (``parallel.ckpt``, ``resilience.ckptmgr``, ``resilience.hotstate``):
  one ``.npz`` of ``{"params", "opt_state", "aux"}`` with a tuple state
  stored as ``{"0": ..., "1": ...}``; restored tensors are placed on
  the trainer's device and the update counter resumes.

Telemetry: :meth:`compiled_step_cost_analysis` gives the step's model
FLOPs, counted from the graph's shapes at the last step
(:mod:`.flops`), and :meth:`emit_telemetry_counters` emits them with the
MFU at the card's peak for ``compute_dtype`` (``trainer_cost``) and the
sentinel's counters.

On a mesh with an ``sp`` axis and ``seq_axis`` set (sequence
parallelism; members in row-major ``(dp, sp)`` order) the batch's axis
``seq_axis`` is split over sp as axis 0 is over dp, the labels too, so
that the per token loss lines up (:meth:`batch_sharding`; the JAX
package's ``batch_pspec``).  Every member walks the graph on its own
``(B/dp, S/sp)`` block (``parallel/sequence_parallel.py``: the ops are
per token, have a sequence-parallel form, or raise naming the op), and
``MultiHeadAttention`` runs ring attention over the sp members of each
dp replica (``ring_attention.ring_attention``: every hop the flash
forward).  The replicated parameters' gradients are summed over every dp
x sp member through the dp step's buckets, the loss heads' normalizers
sum over every member, each member updates its own copy (its own sweep),
and the heads come back in the global row order of the JAX step
(``ShardedArray`` interleaves the members' blocks).  Mirrored layers
(``mirror_blocks``) recompute every member's share of a segment in
lockstep, the ring included (``executor.trace_replicas``).  ``zero1``,
``fsdp``, ``tp`` and ``ep`` together with sp, and an sp axis without
``seq_axis``, are not ported (ROADMAP.md queue 1 item 3 (c2)) and raise.

``rules`` that split a parameter over an axis other than tp, ``remat``
and the sentinel on several devices belong to later slices (ROADMAP.md
queue 1 item 3) and raise; none is ignored.

:class:`ShardedPredictor` is the serving-side counterpart: the forward
of a symbol on a dp, dp x ep or dp x tp mesh, from host parameters or a
checkpoint, with the label slots bound as zeros.  With no ``ctx`` and no mesh, the
trainer runs on the current context (``gpu(0)`` outside a ``with``
scope).
"""
from __future__ import annotations

import functools

import torch

from ..base import MXNetError
from ..context import resolve

__all__ = ["ShardedTrainer", "ShardedPredictor", "ShapeDtypeStruct"]

_MULTI_GPU = "a later multi-GPU slice (ROADMAP.md queue 1 item 3)"


def _not_ported(what, slice_name):
    return MXNetError("ShardedTrainer: %s is not ported yet; it comes with "
                      "%s" % (what, slice_name))


def _state_leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return list(state)
    return [state]


def _state_map(fn, state):
    """``fn`` over an optimizer state's leaves (None, one, or a tuple)."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(fn(a) for a in state)
    return fn(state)


def _state_map2(fn, new, old):
    """``fn(new_leaf, old_leaf)`` over two optimizer states of one
    structure."""
    if new is None:
        return None
    if isinstance(new, (tuple, list)):
        return tuple(fn(a, b) for a, b in zip(new, old))
    return fn(new, old)


def _state_zip(placed, per_replica, mesh):
    """A placed state rebuilt from each replica's new leaves."""
    from .sharding import ShardedArray
    if placed is None:
        return None
    leaves = _state_leaves(placed)
    new = [_state_leaves(s) for s in per_replica]
    out = [ShardedArray([nr[i] for nr in new], mesh, leaf.sharding.spec,
                        leaf.shape) for i, leaf in enumerate(leaves)]
    return tuple(out) if isinstance(placed, (tuple, list)) else out[0]


def _compute_dtype(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    if name not in table:
        raise MXNetError("compute_dtype must be float32, bfloat16 or "
                         "float16, got %r" % (dtype,))
    return table[name]


def _remat(trace):
    """``trace`` under one non-reentrant ``torch.utils.checkpoint``: the
    backward recomputes the whole walk (its own mirrored segments off:
    the whole walk is recomputed anyway).  A walk that draws random
    numbers draws them from a copy of the generator, and its recompute
    from another copy at the same state; the caller's generator then
    moves on as if the walk ran once.  Without autograd the walk just
    runs."""
    from torch.utils.checkpoint import checkpoint

    def remat_trace(args, aux, rng, is_train):
        if not torch.is_grad_enabled():
            return trace(args, aux, rng, is_train)
        state = rng.get_state() if rng is not None else None
        first = []

        def run(a):
            gen = rng
            if state is not None:
                gen = torch.Generator(device=rng.device)
                gen.set_state(state)
                first.append(gen)
            return trace(a, aux, gen, is_train, mirror=False)
        out = checkpoint(run, args, use_reentrant=False)
        if first:
            rng.set_state(first[0].get_state())
        return out
    return remat_trace


class ShardedTrainer:
    """Train a Symbol's loss graph on one device or a dp x ep, dp x tp or
    dp x sp mesh.

    Parameters
    ----------
    symbol : Symbol with loss head(s) (e.g. SoftmaxOutput).
    optimizer : ``mxnet_tpu_torch.optimizer.Optimizer``.
    mesh : a mesh from ``parallel.make_mesh`` (data parallelism over its
        ``dp`` axis, expert parallelism over ``ep``, tensor parallelism
        over ``tp``, sequence parallelism over ``sp``), or None.
    data_names / label_names : input argument names.
    seq_axis : the batch arrays' sequence axis, split over ``sp`` (ring
        attention); no effect on a mesh without an sp axis, as in the JAX
        package.
    compute_dtype : dtype of the forward and backward (params, opt state
        and aux stay in their own dtype; gradients arrive in it).
    ctx : the device (a context, a ``torch.device`` or a string); None
        means the mesh's first device, else the current context.
    zero1 : on a dp mesh, split each leaf's optimizer state over dp
        (:meth:`opt_state_sharding`).
    fsdp : on a dp mesh, split the replicated parameters too, with their
        state (:meth:`param_sharding`).
    sentinel : gate each step on all preprocessed gradients finite, on the
        device (None: ``MXTPU_SENTINEL``); one device only.
    loss_scale_init / loss_scale_growth : the sentinel's dynamic loss
        scale: its start, and the good steps in a row that double it.
    step_timeout_s : bound each step with the watchdog (None:
        ``MXTPU_STEP_TIMEOUT_S`` at each step; unset: no bound).

    :meth:`step` updates ``params``, ``opt_state`` and ``aux`` IN PLACE:
    it replaces the entries of the dicts it is given (with the fused
    sweep, by views of each bucket's flat vector) and returns the same
    dict objects.  Hold no other reference to an entry across a step.
    """

    def __init__(self, symbol, optimizer, mesh=None, data_names=("data",),
                 label_names=("softmax_label",), rules=None, seq_axis=None,
                 donate=True, compute_dtype=None, remat=False,
                 cast_exempt=(), zero1=False, fsdp=False, sentinel=None,
                 loss_scale_init=2.0 ** 15, loss_scale_growth=200,
                 step_timeout_s=None, ctx=None):
        from .. import resilience as _resilience
        self.sentinel = _resilience.sentinel_enabled() if sentinel is None \
            else bool(sentinel)
        self._loss_scale_init = float(loss_scale_init)
        self._loss_scale_growth = int(loss_scale_growth)
        self._sentinel_state = None
        #: the step watchdog's timeout (None: MXTPU_STEP_TIMEOUT_S at each
        #: step, so a launcher can arm it without touching user code)
        self.step_timeout_s = step_timeout_s
        self.dp = mesh.shape.get("dp", 1) if mesh is not None else 1
        self.ep = mesh.shape.get("ep", 1) if mesh is not None else 1
        self.tp = mesh.shape.get("tp", 1) if mesh is not None else 1
        #: the sp axis's size (sequence parallelism over seq_axis)
        self.sp = mesh.shape.get("sp", 1) if mesh is not None else 1
        if self.sp > 1:
            _check_sp(self.sp, seq_axis, zero1, fsdp, self.tp, self.ep)
        if self.tp > 1 and self.ep > 1:
            raise MXNetError("ShardedTrainer: tp=%d together with ep=%d is "
                             "not ported yet (ROADMAP.md queue 1 item 3 "
                             "(b2)); run tensor parallelism on a dp x tp "
                             "mesh" % (self.tp, self.ep))
        #: the model-parallel axis (its members split some parameters
        #: and share one walker) and its size
        self._maxis = "ep" if self.ep > 1 else "tp" if self.tp > 1 \
            else None
        self._mp = self.ep * self.tp
        if mesh is not None and mesh.shape.get("pp", 1) > 1:
            raise MXNetError("ShardedTrainer: a pp axis (%d stages) is "
                             "pipeline parallelism: train with "
                             "parallel.pipeline.GPipeTrainer"
                             % mesh.shape["pp"])
        if self.ep > 1 and (zero1 or fsdp):
            raise MXNetError("ShardedTrainer: %s with ep=%d is not "
                             "ported yet (ROADMAP.md queue 1 item 3 (e2))"
                             % ("zero1=True" if zero1 else "fsdp=True",
                                self.ep))
        #: one device: plain tensors, no mesh collectives
        self._single = self.dp == 1 and self._mp == 1 and self.sp == 1
        if not self._single and remat:
            raise _not_ported("remat=True on a mesh of several devices",
                              _MULTI_GPU)
        if not self._single and self.sentinel:
            raise _not_ported("the in-step sentinel on a mesh of several "
                              "devices", _MULTI_GPU)
        if ctx is not None:
            self.device = resolve(ctx)
            if mesh is not None and mesh.device != self.device:
                raise MXNetError("ShardedTrainer: ctx %s differs from the "
                                 "mesh's device %s" % (self.device,
                                                       mesh.device))
        elif mesh is not None:
            self.device = mesh.device
        else:
            self.device = resolve(None)
        self.symbol = symbol
        self.optimizer = optimizer
        self.mesh = mesh
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        self.rules = rules
        self.seq_axis = seq_axis
        self.compute_dtype = _compute_dtype(compute_dtype)
        self.zero1 = bool(zero1) and self.dp > 1
        #: FSDP: parameters (and their state) persist as 1/dp shards
        self.fsdp = bool(fsdp) and self.dp > 1
        if self.mesh is None:
            from .mesh import Mesh
            self.mesh = Mesh([self.device], ("dp",), [1])
        self.group = self.mesh.replica_group() \
            if self.dp * self.sp > 1 else None
        # the members that walk the graph: every member of a dp mesh, the
        # first of each dp replica's ep or tp group otherwise
        self._walkers = self.mesh.members(ep=0, tp=0)
        # each walker's model-parallel group: the members that hold its
        # parameters' slices and take its gradients
        self._mp_members = [[w] for w in self._walkers]
        self._mp_groups = None
        # for each slice index, the members (one a dp replica) holding it
        self._slice_members = [list(range(len(self.mesh.devices)))]
        self._slice_groups = [self.group]
        if self._maxis is not None:
            self._mp_members = [self.mesh.axis_members(w, self._maxis)
                                for w in self._walkers]
            self._mp_groups = [self.mesh.group_of(m)
                               for m in self._mp_members]
            self._slice_members = [self.mesh.members(**{self._maxis: e})
                                   for e in range(self._mp)]
            self._slice_groups = [self.mesh.group_of(m)
                                  for m in self._slice_members]
            self.group = self.mesh.group_of(self._walkers)

        from ..kernels import fused_opt as _fused
        self._fused_mod = _fused
        self._fused_opt = _fused.fused_opt_mode() \
            if _fused.supports_fused(optimizer) else ""
        if self._fused_opt == "kernel":
            _fused.sweep_body(optimizer)    # raises when it has no body
        if (self.zero1 or self.fsdp) \
                and not _fused.supports_fused(optimizer):
            raise MXNetError(
                "ShardedTrainer(%s=True): %s is not elementwise; ZeRO-1 and "
                "FSDP update each device's slices of a leaf apart"
                % ("zero1" if self.zero1 else "fsdp",
                   type(optimizer).__name__))

        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self._arg_names
                            if n not in self.data_names
                            and n not in self.label_names]
        from ..executor import build_program
        program = build_program(symbol)
        self._trace_replicas = program.trace_replicas
        self.remat = bool(remat)
        self._trace = _remat(program.trace) if self.remat else program.trace
        self._needs_rng = program.needs_rng
        self.num_update = 0
        self._step_shapes = None     # input shapes of the last step
        self._flops = {}             # input shapes -> model FLOPs

        exempt = set(self.label_names) | set(cast_exempt)
        for node in symbol._topo():
            if node.op is not None \
                    and getattr(node.op, "op_name", "") == "Embedding":
                src, _ = node.inputs[0]
                if src.is_variable:
                    exempt.add(src.name)
        self._cast_exempt = frozenset(exempt)
        self._moe_slots = frozenset(
            src.name for node in symbol._topo()
            if node.op is not None
            and getattr(node.op, "op_name", "") == "MoE"
            for src, _ in node.inputs[2:6] if src.is_variable)

    # ------------------------------------------------------------------
    # casts
    # ------------------------------------------------------------------
    def _to_compute(self, tensors):
        cdt = self.compute_dtype
        if cdt is None:
            return dict(tensors)
        return {k: v.to(cdt) if v.is_floating_point() else v
                for k, v in tensors.items()}

    def _batch_to_compute(self, batch, params=None):
        """The batch as the graph reads it: floats in ``compute_dtype``,
        and a uint8 input (raw pixels from
        ``ImageRecordIter(dtype="uint8")``) widened on the device to
        ``compute_dtype``, or without one to the parameters' dtype, as
        ``jnp`` promotes it in the JAX package's trace (uint8 with
        float32 gives float32; float32 without ``params``): exactly a
        float batch of the same pixels.  Labels and other cast-exempt
        inputs stay."""
        cdt = self.compute_dtype
        widen = cdt or next(iter((params or {}).values()),
                            torch.empty(0)).dtype
        out = {}
        for k, v in batch.items():
            if k not in self._cast_exempt:
                if v.dtype == torch.uint8:
                    v = v.to(widen)
                elif cdt is not None and v.is_floating_point():
                    v = v.to(cdt)
            out[k] = v
        return out

    # ------------------------------------------------------------------
    # shardings
    # ------------------------------------------------------------------
    def param_sharding(self, name, shape):
        """Where a parameter lives (the JAX trainer's placement): an MoE
        expert stack split over ``ep`` (axis 0); on a tp axis the tp
        policy of ``sharding.param_pspec`` (or a ``rules`` entry over
        tp): axis 0 when it divides, else axis 1, a divisible bias, the
        normalization parameters replicated; under ``fsdp`` every
        otherwise-replicated parameter whose axis 0 divides split over
        dp; the rest replicated.  A rule that splits a parameter over
        another axis raises."""
        from .sharding import NamedSharding, P, param_pspec
        spec = param_pspec(name, shape, self.mesh, self.rules)
        if tuple(spec[:1]) == ("ep",) and not any(spec[1:]):
            if name not in self._moe_slots:
                raise MXNetError(
                    "ShardedTrainer: %s is split over ep (its name holds "
                    "'expert') but is not an MoE node's expert weight; "
                    "only MoE splits its experts over ep" % name)
            return NamedSharding(self.mesh, spec)
        axes = [e for e in spec
                if e is not None and self.mesh.shape.get(e, 1) > 1]
        if axes and axes != ["tp"]:
            raise _not_ported("sharding parameter %s as %s (a rule that "
                              "splits a parameter over %s)"
                              % (name, spec, "+".join(map(str, axes))),
                              _MULTI_GPU)
        if not axes:
            spec = P(*([None] * len(shape)))
            if self.fsdp and shape and shape[0] % self.dp == 0:
                spec = P("dp", *([None] * (len(shape) - 1)))
        return NamedSharding(self.mesh, spec)

    def batch_sharding(self, shape):
        """A batch tensor: axis 0 split over dp, and with an sp axis the
        axis ``seq_axis`` over sp (the labels' too)."""
        from .sharding import NamedSharding, batch_pspec
        return NamedSharding(self.mesh, batch_pspec(shape, self.mesh,
                                                    self.seq_axis))

    def opt_state_sharding(self, name, shape):
        """ZeRO-1 placement for one optimizer-state array: axis 0 split
        over dp when it divides, else the parameter's own placement (a
        tp-split leaf's state, and FSDP's, follow the leaf's split)."""
        from .sharding import NamedSharding, P
        own = self.param_sharding(name, shape)
        if self.zero1 and shape and shape[0] % self.dp == 0 \
                and all(e is None for e in own.spec):
            return NamedSharding(self.mesh,
                                 P("dp", *([None] * (len(shape) - 1))))
        return own

    def _place(self, value, sharding):
        from .sharding import place
        return place(value, self.mesh, sharding.spec)

    # ------------------------------------------------------------------
    # state init
    # ------------------------------------------------------------------
    def init_params(self, data_shapes, initializer=None, label_shapes=None,
                    dtype=torch.float32):
        """Infer shapes and allocate params, optimizer state and aux on
        the trainer's device (on a dp mesh, placed on it:
        :meth:`param_sharding`, :meth:`opt_state_sharding`, aux
        replicated).  Returns ``(params, opt_state, aux)`` dicts of
        tensors (or :class:`~.sharding.ShardedArray`).  ``initializer``
        defaults to ``Uniform(0.07)`` drawing from
        ``random.generator("cpu")``; in a process group rank 0's values
        are broadcast, so every process starts from the same weights."""
        from ..initializer import Uniform
        from ..ndarray import NDArray
        shape_map, aux_map = self._shape_maps(data_shapes, label_shapes)
        initializer = initializer or Uniform(0.07)
        host_params = {}
        for name in self.param_names:
            host = NDArray(torch.zeros(shape_map[name], dtype=dtype))
            initializer(name, host)
            host_params[name] = host.data
        if self._single:
            params = {n: v.to(self.device) for n, v in host_params.items()}
        else:
            params = self.place_params(host_params)
        opt_state = {}
        for name in self.param_names:
            s = self.optimizer.create_state_arrays(shape_map[name], dtype,
                                                   self.device)
            if s is not None:
                opt_state[name] = s if self._single else _state_map(
                    lambda a, _n=name: self._place(
                        a, self.opt_state_sharding(_n, a.shape)), s)
        aux = {}
        for name in self._aux_names:
            fill = torch.ones if name.endswith("moving_var") else torch.zeros
            aux[name] = fill(aux_map[name], dtype=dtype, device=self.device)
        if not self._single:
            aux = self.place_params(aux)
        return params, opt_state, aux

    def place_params(self, values):
        """``{name: array}`` (numpy, NDArray or tensor: the JAX package's
        parameters carried across as numpy, say) placed on the mesh as
        the trainer keeps them (:meth:`param_sharding`: replicated, an
        expert stack split over ep, a tp split, an FSDP split over dp); in
        a process group, rank 0's values broadcast to every process.  On
        a one-device mesh, tensors on the device."""
        from .sharding import place, P
        from .collectives import broadcast
        out = {}
        for name, v in values.items():
            if self._single:
                out[name] = place(v, self.mesh, P()).shards[0]
                continue
            spec = self.param_sharding(name, tuple(v.shape)).spec \
                if name in self.param_names else P(*([None] * len(v.shape)))
            if self.mesh.num_processes > 1:
                # rank 0's whole value first, then this process's part
                rep = place(v, self.mesh, P(*([None] * len(v.shape))))
                broadcast(self.group, rep.shards)
                v = rep.shards[0]
            out[name] = place(v, self.mesh, spec)
        return out

    def _shape_maps(self, data_shapes, label_shapes=None):
        shapes = dict(data_shapes)
        if label_shapes:
            shapes.update(label_shapes)
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % (shapes,))
        return (dict(zip(self._arg_names, arg_shapes)),
                dict(zip(self._aux_names, aux_shapes)))

    def shard_batch(self, batch, copy=None):
        """Place host batch arrays (numpy, NDArrays or tensors) on the
        trainer's device, keeping their dtype (float64 becomes float32,
        as in the reference; a uint8 batch crosses as uint8 and
        :meth:`step` widens it).  ``copy``: a
        :class:`~.overlap.HostToDevice` to place through (the async
        feed's pinned buffers and stream).  On a dp mesh each array is
        split on axis 0 over the replicas (:meth:`batch_sharding`); in a
        process group each process passes its own part of the global
        batch (the reference's ``num_parts``/``part_index`` shard)."""
        from .. import ndarray as nd
        from ..observability import spans as _spans
        if not self._single:
            from .sharding import place
            with _spans.span("h2d", step=self.num_update):
                return {name: place(arr, self.mesh,
                                    self.batch_sharding(arr.shape).spec,
                                    part_of_process=True)
                        for name, arr in batch.items()}
        out = {}
        for name, arr in batch.items():
            if copy is not None:
                out[name] = copy(arr)
                continue
            if hasattr(arr, "asnumpy") and not isinstance(arr, nd.NDArray):
                arr = arr.asnumpy()
            out[name] = nd.array(arr, ctx=self.device).data
        return out

    def prefetch_feed(self, batches, depth=None, prefetch=True):
        """Wrap an iterator of host batch dicts in a
        :class:`~.overlap.DevicePrefetcher` whose placement is
        :meth:`shard_batch` (timed as ``h2d``) on a background thread —
        batch N+1 transfers while step N runs; on a CUDA device from
        pinned buffers on a stream of its own.  Feed :meth:`step` its
        output directly; do not call ``shard_batch`` again.
        ``prefetch=None`` defers to ``MXTPU_PREFETCH``; returns
        ``batches`` unchanged when off."""
        from . import overlap
        if not overlap.prefetch_enabled(prefetch):
            return batches
        if not self._single:
            return overlap.DevicePrefetcher(
                batches, place_fn=self.shard_batch, depth=depth,
                name="trainer-feed")
        copy = overlap.HostToDevice(self.device,
                                    overlap.prefetch_depth(depth) + 2)
        return overlap.DevicePrefetcher(
            batches, place_fn=lambda b: self.shard_batch(b, copy=copy),
            depth=depth, name="trainer-feed", stream=copy.stream)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def _rng(self, rng):
        if rng is not None or not self._needs_rng:
            return rng
        from .. import random as _random
        return _random.generator(self.device)

    def _init_sentinel_state(self):
        """The sentinel's counters, on the device: ``scale`` (float32),
        ``good_steps``, ``skipped``, ``last_good`` (int32)."""
        def full(v, dtype):
            return torch.full((), v, dtype=dtype, device=self.device)
        return {"scale": full(self._loss_scale_init, torch.float32),
                "good_steps": full(0, torch.int32),
                "skipped": full(0, torch.int32),
                "last_good": full(0, torch.int32)}

    def sentinel_stats(self):
        """Host view of the sentinel counters: ``{"scale", "good_steps",
        "skipped", "last_good"}``, or None when the sentinel is off or no
        step has run.  Reads the device, so poll it at logging cadence,
        not every step."""
        if self._sentinel_state is None:
            return None
        return {k: v.item() for k, v in self._sentinel_state.items()}

    def _gate_sentinel(self, finite, t):
        """The sentinel's counters after a step whose gradients were
        ``finite`` (a bool tensor on the device), as the JAX trainer's
        compiled gate updates them: a bad step halves the scale (at least
        1) and counts a skip; ``loss_scale_growth`` good steps in a row
        double it (at most 2^24)."""
        s = self._sentinel_state
        good = torch.where(finite, s["good_steps"] + 1, 0)
        grow = good >= self._loss_scale_growth
        scale = s["scale"]
        self._sentinel_state = {
            "scale": torch.where(
                finite, torch.where(grow, torch.clamp(scale * 2.0,
                                                      max=2.0 ** 24), scale),
                torch.clamp(scale * 0.5, min=1.0)),
            "good_steps": torch.where(grow, 0, good),
            "skipped": s["skipped"] + torch.logical_not(finite).to(
                torch.int32),
            "last_good": torch.where(finite, t, s["last_good"]),
        }

    def step(self, params, opt_state, aux, batch, rng=None):
        """Run one training step; returns ``(params, opt_state, aux,
        outputs)``, the first three the dicts given, updated in place.

        The step runs under the watchdog when a timeout is set, and is
        ledgered in the flight recorder as (``train_step``, its update
        number) until it completes."""
        from .. import observability as _obs
        from .. import resilience as _resilience
        self.num_update += 1
        self._step_shapes = tuple(sorted(
            (n, tuple(v.shape)) for n, v in batch.items()
            if n in self.data_names or n in self.label_names))
        inj = _resilience.injector()
        if inj is not None:
            spec = inj.match("batch", step=self.num_update)
            if spec is not None and spec.kind == "nan":
                batch = dict(batch)
                for name in self.data_names:
                    if name in batch:
                        batch[name] = _resilience.poison_nan(batch[name])
        if self.sentinel and self._sentinel_state is None:
            self._sentinel_state = self._init_sentinel_state()
        one = self._step_one if self._single else self._step_dp
        dev = self.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None

        def dispatch():
            # inside the guarded region, so an injected hang is caught as
            # a wedged collective would be; the watchdog runs this on a
            # thread of its own, which must enter the caller's device and
            # stream (PyTorch keeps them per thread; the step sets its
            # own grad mode)
            _resilience.maybe_fault("step", step=self.num_update)
            if stream is None:
                return one(params, opt_state, aux, batch, rng)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                return one(params, opt_state, aux, batch, rng)

        timeout = self.step_timeout_s
        if timeout is None:
            timeout = _resilience.step_timeout_s()
        _obs.flight.collective_begin(
            "train_step", self.num_update,
            participants=list(range(self.mesh.num_processes)))
        if _obs.events.get() is not None:
            # host dispatch wall only: CUDA runs asynchronously
            import time as _time
            t0 = _time.perf_counter()
            try:
                out = _resilience.run_with_timeout(
                    dispatch, timeout, phase="train_step",
                    step=self.num_update) if timeout else dispatch()
            finally:
                _obs.record_step(self.num_update, _time.perf_counter() - t0,
                                 batch_size=self._batch_samples(batch),
                                 timing="dispatch")
        elif timeout:
            out = _resilience.run_with_timeout(
                dispatch, timeout, phase="train_step", step=self.num_update)
        else:
            out = dispatch()
        _obs.flight.collective_end("train_step", self.num_update)
        return out

    def compiled_step_cost_analysis(self):
        """``{"flops": F}``: the model FLOPs of one training step at the
        last step's input shapes (:func:`.flops.step_flops`: every
        product, a multiply-add as 2, 3 times the forward), or None
        before the first step.  On a mesh of several members it adds
        ``flops_per_member`` (``F`` over the members: each dp replica's
        share, split again over its tp or ep members) and ``members``.
        The JAX trainer's dict is XLA's cost analysis, which also counts
        elementwise work and bytes; the port has no count of bytes."""
        if self._step_shapes is None:
            return None
        flops = self._flops.get(self._step_shapes)
        if flops is None:
            from .flops import step_flops
            flops = self._flops[self._step_shapes] = step_flops(
                self.symbol, dict(self._step_shapes))
        out = {"flops": float(flops)}
        members = len(self.mesh.devices) * self.mesh.num_processes
        if members > 1:
            # the work of one member: the step's model FLOPs split evenly
            # over dp replicas and over the tp or ep members of each
            out.update(flops_per_member=float(flops) / members,
                       members=members)
        return out

    def emit_telemetry_counters(self, step_time_s=None):
        """Emit the ``trainer_cost`` counter (model FLOPs, and with
        ``step_time_s`` the MFU at the card's peak for the compute
        dtype) and, with the in-step sentinel on, the ``sentinel``
        counter (which reads the device counters: call at logging
        cadence).  Returns the cost fields emitted ({} with telemetry
        off)."""
        from .. import observability as _obs
        if not _obs.enabled():
            return {}
        fields = _obs.emit_trainer_counters(self, step_time_s)
        if self._sentinel_state is not None:
            _obs.emit_sentinel_counters(self.sentinel_stats(),
                                        step=self.num_update)
        return fields

    @staticmethod
    def _batch_samples(batch):
        """Leading-dim sample count of the first batch array (telemetry
        throughput only)."""
        try:
            return int(next(iter(batch.values())).shape[0])
        except Exception:
            return None

    def _step_one(self, params, opt_state, aux, batch, rng):
        """The step on one device."""
        opt = self.optimizer
        lr = opt.lr_scheduler(self.num_update) \
            if opt.lr_scheduler is not None else opt.lr
        wd = opt.wd
        t = self.num_update
        rng = self._rng(rng)

        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self.param_names}
        with torch.enable_grad():
            args = self._to_compute(leaves)
            args.update(self._batch_to_compute(batch, leaves))
            outs, aux_out = self._trace(args, self._to_compute(aux), rng,
                                        True)
            order = [leaves[n] for n in self.param_names]
            grads = torch.autograd.grad(
                outs, order, grad_outputs=[torch.ones_like(o) for o in outs],
                allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(leaves[n])
                 for n, g in zip(self.param_names, grads)}

        finite = None
        with torch.no_grad():
            if self._fused_opt:
                got = self._fused_mod.fused_apply(
                    opt, {n: params[n] for n in self.param_names}, grads,
                    opt_state, lr, wd, t, mode=self._fused_opt,
                    preprocess=True, gate=self.sentinel)
                new_w, new_s = got[0], got[1]
                if self.sentinel:
                    finite = got[2]
            else:
                new_w, new_s = {}, {}
                t_dev = torch.tensor(float(t), device=self.device)
                gs = {n: opt._preprocess_grad(grads[n])
                      for n in self.param_names}
                if self.sentinel:
                    # one check over the concatenated gradients (a check a
                    # leaf would add two launches a leaf)
                    finite = torch.isfinite(torch.cat(
                        [g.reshape(-1) for g in gs.values()])).all()
                for n in self.param_names:
                    new_w[n], new_s[n] = opt.update_fn(
                        params[n], gs[n], opt_state.get(n), lr, wd, t_dev)
                    if finite is not None:
                        new_w[n] = torch.where(finite, new_w[n], params[n])
                        new_s[n] = _state_map2(
                            lambda a, b: torch.where(finite, a, b),
                            new_s[n], opt_state.get(n))
            params.update(new_w)
            for n, s in new_s.items():
                if s is not None:
                    opt_state[n] = s
            for n, v in aux_out.items():
                v = v.detach().to(aux[n].dtype)
                aux[n] = v if finite is None else torch.where(finite, v,
                                                              aux[n])
            if finite is not None:
                self._gate_sentinel(finite, t)
        return params, opt_state, aux, [o.detach() for o in outs]

    def eval(self, params, aux, batch, rng=None):
        """Forward in ``compute_dtype`` with ``is_train=False``."""
        if not self._single:
            with torch.no_grad():
                outs, _aux, reps, dims = self._walk(params, aux, batch, rng,
                                                    False)
            return self._outputs(outs, reps, dims)
        with torch.no_grad():
            args = self._to_compute(params)
            args.update(self._batch_to_compute(batch, params))
            outs, _ = self._trace(args, self._to_compute(aux), rng, False)
        return outs

    # ------------------------------------------------------------------
    # the data-parallel step
    # ------------------------------------------------------------------
    def _walker_params(self, members, d, split):
        """Walker ``d``'s parameters from ``members`` (a dict a member):
        its own, with each parameter of ``split`` (name -> split
        dimension) its model-parallel group's slices: an
        :class:`~mxnet_tpu_torch.ops.moe.ExpertShards` over ep, a
        :class:`~.tensor_parallel.TPShards` over tp."""
        w = self._walkers[d]
        if not split:
            return members[w]
        out = dict(members[w])
        parts = {k: [members[i][k] for i in self._mp_members[d]]
                 for k in split}
        if self._maxis == "ep":
            from ..ops.moe import ExpertShards
            for k in split:
                out[k] = ExpertShards(parts[k], self._mp_groups[d])
        else:
            from .tensor_parallel import TPShards
            for k, dim in split.items():
                out[k] = TPShards(parts[k], self._mp_groups[d], dim)
        return out

    def _full_leaves(self, params, grad):
        """Each member's parameter tensors for the walk: its own shards,
        with FSDP's dp-split leaves all-gathered whole on the walkers
        (``grad``: fresh leaves that record a gradient)."""
        from .collectives import all_gather
        n = len(self.mesh.devices)

        def leaf(t):
            t = t.detach()
            return t.requires_grad_(True) if grad else t
        leaves = [{k: leaf(params[k].shards[r]) for k in self.param_names}
                  for r in range(n)]
        if self.fsdp:
            for k in self._fsdp_names(params):
                whole = all_gather(self.group, [
                    params[k].shards[w].detach().reshape(-1)
                    for w in self._walkers])
                for w, t in zip(self._walkers, whole):
                    leaves[w][k] = leaf(t.view(params[k].shape))
        return leaves

    def _fsdp_names(self, params):
        return [k for k in self.param_names
                if tuple(params[k].sharding.spec[:1]) == ("dp",)]

    def _walk(self, params, aux, batch, rng, is_train, leaves=None):
        """The lockstep walk of the walkers: ``(outputs, aux_out,
        replicated, dims)`` (``Program.trace_replicas``; ``dims``: for
        each head split over sp, its sequence dimension and its block's
        ``(pre, post)`` (``SeqWalk.runs``), else None)."""
        import contextlib
        from .ring_attention import sequence_parallel
        from .sequence_parallel import SeqWalk
        from .sharding import ShardedArray

        def shard(v, r):
            return v.shards[r] if isinstance(v, ShardedArray) else v
        if leaves is None:
            leaves = self._full_leaves(params, False)
        split = _model_split(params)
        args, auxs = [], []
        for d, r in enumerate(self._walkers):
            p = self._walker_params(leaves, d, split)
            a = self._to_compute(p)
            a.update(self._batch_to_compute(
                {k: shard(v, r) for k, v in batch.items()}, leaves[r]))
            args.append(a)
            auxs.append(self._to_compute({k: shard(v, r)
                                          for k, v in aux.items()}))
        # a graph that draws random numbers draws each replica's from its
        # device's generator (a caller's generator serves replicas on its
        # own device)
        devices = [self.mesh.devices[r] for r in self._walkers]
        rngs = [None] * len(devices)
        if self._needs_rng:
            from .. import random as _random
            rngs = [rng if rng is not None and rng.device == d
                    else _random.generator(d) for d in devices]
        group = self.group
        if group is None:
            from .collectives import ReplicaGroup
            group = ReplicaGroup(devices)
        seq, scope = None, contextlib.nullcontext()
        if self.sp > 1:
            seq = SeqWalk(self.mesh,
                          batch[self.data_names[0]].shape[self.seq_axis],
                          {k: self.seq_axis for k, v in batch.items()
                           if len(v.shape) > self.seq_axis})
            scope = sequence_parallel(self.mesh)
        with scope:
            outs, aux_out, reps = self._trace_replicas(
                args, auxs, rngs, is_train, group,
                sharded=self.data_names + self.label_names, seq=seq)
        dims = [None] * len(reps)
        if seq is not None:
            dims = [None if j is None else (j,) + seq.runs(outs[0][i], j)
                    for i, j in enumerate(seq.head_dims)]
        return outs, aux_out, reps, dims

    def _outputs(self, outs, reps, dims):
        """Heads as :class:`~.sharding.ShardedArray`s: split on axis 0,
        or replicated.  On an ep or tp mesh every member of a dp replica
        holds its walker's output.  Under sp a head split over the
        sequence (``dims``) assembles its members' blocks interleaved, in
        the global row order (``ShardedArray``'s ``seq``)."""
        from .sharding import ShardedArray, P
        # members are in (dp, ep or tp) order: member i walks with walker
        # i // (ep * tp)
        owner = [i // self._mp for i in range(len(self.mesh.devices))]
        got = []
        for i, rep in enumerate(reps):
            shards = [outs[owner[r]][i].detach() for r in range(len(owner))]
            nd_ = shards[0].dim()
            if dims[i] is not None:
                got.append(self._seq_output(shards, *dims[i]))
            elif rep:
                got.append(ShardedArray(shards, self.mesh,
                                        P(*([None] * nd_)), shards[0].shape))
            else:
                shape = list(shards[0].shape)
                shape[0] *= len(outs) * self.mesh.num_processes
                got.append(ShardedArray(shards, self.mesh,
                                        P("dp", *([None] * (nd_ - 1))),
                                        shape))
        return got

    def _seq_output(self, shards, j, pre, post):
        """A head split over sp at dimension ``j`` of each member's
        block, whose runs are ``(pre, post)``: its global shape (the
        sequence dimension ``sp`` times the block's, the batch ``dp``
        times) and its interleaved assembly."""
        from .sharding import ShardedArray, P
        t = shards[0]
        shape = list(t.shape)
        shape[j] *= self.sp
        shape[0] *= self.dp
        spec = [None] * t.dim()
        spec[j] = "sp"
        if self.dp > 1:
            spec[0] = ("dp", "sp") if j == 0 else "dp"
        return ShardedArray(shards, self.mesh, P(*spec), shape,
                            seq=(pre, post))

    def _step_dp(self, params, opt_state, aux, batch, rng):
        """The step on a dp mesh, with ep or tp: the walkers' gradients of
        the replicated leaves reduced bucket by bucket as the backward
        makes them and copied to each walker's model-parallel members;
        each split leaf's gradient summed over the members that hold the
        same slice.  Under FSDP the dp-split leaves are gathered whole for
        the walk and dropped after it, and their gradients
        reduce-scattered as ZeRO-1's."""
        from .. import executor as _executor
        from .overlap import GradBuckets, interleave_grad_buckets
        from .collectives import send
        from .sharding import ShardedArray
        opt = self.optimizer
        lr = opt.lr_scheduler(self.num_update) \
            if opt.lr_scheduler is not None else opt.lr
        wd, t = opt.wd, self.num_update
        n = len(self.mesh.devices)
        leaves = self._full_leaves(params, True)
        split = _model_split(params)
        first = leaves[self._walkers[0]]
        plan = interleave_grad_buckets(
            {k: first[k] for k in self.param_names if k not in split})
        layout = self._zero1_layout(params, split) \
            if self.zero1 or self.fsdp else None
        reducer = GradBuckets([leaves[w] for w in self._walkers], plan,
                              functools.partial(self._reduce_bucket, layout))
        with torch.enable_grad():
            outs, aux_out, reps, dims = self._walk(params, aux, batch, rng,
                                                   True, leaves=leaves)
            heads, hgrads = [], []
            for o_r, g_r in zip(outs, _executor.replica_head_grads(outs,
                                                                   reps)):
                for o, g in zip(o_r, g_r):
                    if o.requires_grad:
                        heads.append(o)
                        hgrads.append(g)
            if heads:
                torch.autograd.backward(heads, hgrads)
        reduced = [{} for _ in range(n)]
        for part in reducer.finish():
            for r in range(n):
                reduced[r].update(part[r])
        with torch.no_grad():
            if split:
                self._reduce_slices(leaves, split, reduced)
            del leaves, first
            if layout is not None:
                self._update_zero1(params, opt_state, reduced, layout, lr,
                                   wd, t)
            else:
                self._update_replicas(params, opt_state, reduced, lr, wd, t)
            for k in aux:
                aux[k] = ShardedArray(
                    [send(aux_out[r // self._mp][k].detach().to(
                        aux[k].dtype), self.mesh.devices[r])
                     for r in range(n)],
                    self.mesh, aux[k].sharding.spec, aux[k].shape)
        return params, opt_state, aux, self._outputs(outs, reps, dims)

    def _reduce_slices(self, leaves, split, grads):
        """The gradients of the split leaves (``split``) summed over the
        members that hold the same slice (one a dp replica), into
        ``grads`` (a dict a member)."""
        from .collectives import all_reduce
        names = list(split)
        sizes = [leaves[0][k].numel() for k in names]
        for members, group in zip(self._slice_members, self._slice_groups):
            flats = [torch.cat([
                (leaves[r][k].grad if leaves[r][k].grad is not None
                 else torch.zeros_like(leaves[r][k])).reshape(-1)
                for k in names]) for r in members]
            if len(flats) > 1:
                flats = all_reduce(group, flats)
            for r, flat in zip(members, flats):
                for k, part in zip(names, torch.split(flat, sizes)):
                    grads[r][k] = part.view(leaves[r][k].shape)

    def _reduce_bucket(self, layout, names, grads):
        """One bucket's gradients summed over the walkers (``grads``: a
        dict a walker): ``[{name: gradient}]`` a member of the mesh, each
        ep or tp member holding its walker's sums; under ZeRO-1 and FSDP
        a leaf of ``layout`` gets this replica's slice of rows
        (:meth:`_zero1_layout`)."""
        from .collectives import all_reduce, reduce_scatter, send
        out = [{} for _ in self.mesh.devices]
        whole = [k for k in names if layout is None or k not in layout]
        if whole:
            sums = all_reduce(self.group, [
                torch.cat([g[k].reshape(-1) for k in whole]) for g in grads])
            sizes = [grads[0][k].numel() for k in whole]
            for d, members in enumerate(self._mp_members):
                for r in members:
                    flat = send(sums[d], self.mesh.devices[r])
                    for k, part in zip(whole, torch.split(flat, sizes)):
                        out[r][k] = part.view(grads[d][k].shape)
        split = [k for k in names if layout is not None and k in layout]
        if split:
            world = self.group.world
            rows = {k: grads[0][k].shape[0] // world for k in split}
            sizes = [rows[k] * grads[0][k][0].numel() for k in split]
            chunk = sum(sizes)
            pad = (-chunk) % 4          # each device's part 16-byte aligned
            flats = []
            for g in grads:
                parts = []
                for d in range(world):
                    for k in split:
                        parts.append(g[k].narrow(0, d * rows[k], rows[k])
                                     .reshape(-1))
                    if pad:
                        parts.append(g[split[0]].new_zeros(pad))
                flats.append(torch.cat(parts))
            mine = reduce_scatter(self.group, flats)
            for d, members in enumerate(self._mp_members):
                for r in members:
                    flat = send(mine[d][:chunk], self.mesh.devices[r])
                    for k, part in zip(split, torch.split(flat, sizes)):
                        out[r][k] = part.view(
                            (rows[k],) + tuple(grads[d][k].shape[1:]))
        return out

    def _zero1_layout(self, params, split=()):
        """The names of the leaves ZeRO-1 and FSDP split over dp: the
        replicated ones whose axis 0 divides by dp."""
        return {k for k in self.param_names if k not in split
                and params[k].shape and params[k].shape[0] % self.dp == 0}

    def _dp_index(self, r):
        """Member ``r``'s global index along dp."""
        return self.group.rank() * len(self._walkers) \
            + self.mesh.coords(r).get("dp", 0)

    def _update_replicas(self, params, opt_state, grads, lr, wd, t):
        """Each member's update of its copy or its slices (its own sweep,
        or leafwise), from the summed gradients."""
        from .sharding import ShardedArray
        n = len(self.mesh.devices)
        new_w = [None] * n
        new_s = [None] * n
        for r, dev in enumerate(self.mesh.devices):
            w_r = {k: params[k].shards[r] for k in self.param_names}
            s_r = {k: _state_map(lambda a, _r=r: a.shards[_r], v)
                   for k, v in opt_state.items()}
            if self._fused_opt:
                new_w[r], new_s[r] = self._fused_mod.fused_apply(
                    self.optimizer, w_r, grads[r], s_r, lr, wd, t,
                    mode=self._fused_opt, preprocess=True)
            else:
                t_dev = torch.tensor(float(t), device=dev)
                new_w[r], new_s[r] = {}, {}
                for k in self.param_names:
                    new_w[r][k], new_s[r][k] = self.optimizer._step(
                        w_r[k], grads[r][k], s_r.get(k), lr, wd, t_dev)
        for k in self.param_names:
            params[k] = ShardedArray([w[k] for w in new_w], self.mesh,
                                     params[k].sharding.spec,
                                     params[k].shape)
            if k in opt_state:
                opt_state[k] = _state_zip(
                    opt_state[k], [s[k] for s in new_s], self.mesh)

    def _update_zero1(self, params, opt_state, grads, layout, lr, wd, t):
        """ZeRO-1 and FSDP: each member's update over one flat vector of
        its slices (the divisible leaves' rows of its dp index, then the
        other leaves whole: its copy or its tp slice), then, under
        ZeRO-1, the new weights all-gathered over each dp group; FSDP
        keeps its rows."""
        from .collectives import all_gather
        from .sharding import ShardedArray
        n = len(self.mesh.devices)
        div = [k for k in self.param_names if k in layout]
        rest = [k for k in self.param_names if k not in layout]
        n_state = len(_state_leaves(
            self.optimizer.create_state_arrays((1,))))
        vecs = []
        for r in range(n):
            g_idx = self._dp_index(r)
            w_parts, g_parts, s_parts = [], [], [[] for _ in range(n_state)]
            for k in div + rest:
                w = params[k].shards[r]
                if k in layout and not self.fsdp:
                    rows = w.shape[0] // self.dp
                    w = w.narrow(0, g_idx * rows, rows)
                w_parts.append(w.reshape(-1))
                g_parts.append(grads[r][k].reshape(-1))
                st = _state_leaves(opt_state.get(k))
                for i in range(n_state):
                    s_parts[i].append(st[i].shards[r].reshape(-1))
            w_vec = torch.cat(w_parts)
            g_vec = torch.cat(g_parts)
            s_vecs = [torch.cat(p) for p in s_parts]
            if self._fused_opt == "kernel":
                self._fused_mod.sweep(self.optimizer, w_vec, g_vec, s_vecs,
                                      lr, wd, t, preprocess=True)
            else:
                w_vec, s_vecs = self._fused_mod.sweep_reference(
                    self.optimizer, w_vec, g_vec, s_vecs, lr, wd, t,
                    preprocess=True)
            vecs.append((w_vec, s_vecs))
        sizes = [grads[0][k].numel() for k in div + rest]
        n_div = sum(sizes[:len(div)])
        gathered = [None] * n
        if not self.fsdp:
            for members, group in zip(self._slice_members,
                                      self._slice_groups):
                got = all_gather(group, [vecs[r][0][:n_div]
                                         for r in members])
                for r, g in zip(members, got):
                    gathered[r] = g
        for r in range(n):
            w_vec, s_vecs = vecs[r]
            w_parts = torch.split(w_vec, sizes)
            s_split = [torch.split(v, sizes) for v in s_vecs]
            for j, k in enumerate(div + rest):
                shard_shape = tuple(grads[r][k].shape)
                st = opt_state.get(k)
                if st is not None:
                    leaves = _state_leaves(st)
                    for i, leaf in enumerate(leaves):
                        leaf.shards[r] = s_split[i][j].view(shard_shape)
                if k in rest or self.fsdp:
                    params[k].shards[r] = w_parts[j].view(shard_shape)
            if self.fsdp:
                continue
            whole = gathered[r].view(self.group.world, n_div)
            off = 0
            for k, size in zip(div, sizes):
                rows = params[k].shape[0] // self.dp
                params[k].shards[r] = whole[:, off:off + size].reshape(
                    (self.group.world * rows,)
                    + tuple(params[k].shape[1:]))
                off += size
        for k in self.param_names:
            params[k] = ShardedArray(params[k].shards, self.mesh,
                                     params[k].sharding.spec,
                                     params[k].shape)

    # ------------------------------------------------------------------
    # checkpoints (host format)
    # ------------------------------------------------------------------
    def abstract_state(self, data_shapes, label_shapes=None,
                       dtype=torch.float32):
        """``(params, opt_state, aux)`` as :class:`ShapeDtypeStruct`s (shape,
        dtype and the trainer's placement), with no storage: the restore
        target of the checkpoint methods."""
        shape_map, aux_map = self._shape_maps(data_shapes, label_shapes)
        params = {n: ShapeDtypeStruct(tuple(shape_map[n]), dtype,
                                      self.param_sharding(n, shape_map[n]))
                  for n in self.param_names}
        opt_state = {}
        for n in self.param_names:
            proto = self.optimizer.create_state_arrays((1,), dtype)
            if proto is not None:
                opt_state[n] = _state_map(
                    lambda a, _n=n: ShapeDtypeStruct(
                        tuple(shape_map[_n]), a.dtype,
                        self.opt_state_sharding(_n, tuple(shape_map[_n]))),
                    proto)
        aux = {n: ShapeDtypeStruct(tuple(aux_map[n]), dtype, None)
               for n in self._aux_names}
        return params, opt_state, aux

    def _ckpt_tree(self, params, opt_state, aux):
        """The nested dict the host format stores: a tuple state becomes
        ``{"0": ..., "1": ...}``."""
        def state(v):
            return {str(i): a for i, a in enumerate(v)} \
                if isinstance(v, (tuple, list)) else v
        return {"params": dict(params),
                "opt_state": {n: state(v) for n, v in opt_state.items()},
                "aux": dict(aux)}

    def _ckpt_target(self, data_shapes, label_shapes, dtype):
        return self._ckpt_tree(*self.abstract_state(data_shapes,
                                                    label_shapes, dtype))

    def _placed(self, tree):
        """A restored host tree (numpy leaves) as the trainer keeps it:
        ``(params, opt_state, aux)`` on its device (on a dp mesh, placed
        as :meth:`init_params` places them), tuple states rebuilt."""
        def tensor(a):
            return torch.as_tensor(_np_array(a))

        def put(a, sharding):
            if self._single:
                return tensor(a).to(self.device)
            return self._place(tensor(a), sharding)
        params = {n: put(a, self.param_sharding(n, a.shape))
                  for n, a in tree["params"].items()}
        opt_state = {}
        for n, v in tree["opt_state"].items():
            leaves = [v[str(i)] for i in range(len(v))] \
                if isinstance(v, dict) else [v]
            placed = [put(a, self.opt_state_sharding(n, a.shape))
                      for a in leaves]
            opt_state[n] = tuple(placed) if isinstance(v, dict) \
                else placed[0]
        aux = {n: tensor(a).to(self.device) for n, a in tree["aux"].items()}
        if not self._single:
            aux = self.place_params(aux)
        return params, opt_state, aux

    def save_checkpoint(self, path, params, opt_state, aux):
        """Write ``(params, opt_state, aux)`` and the update counter to
        the directory ``path`` in the host format (the JAX trainer writes
        orbax's sharded format, which comes with ROADMAP.md queue 1 item
        3 (f))."""
        from .ckpt import host_save
        return host_save(path, self._ckpt_tree(params, opt_state, aux),
                         self.num_update)

    def load_checkpoint(self, path, data_shapes, label_shapes=None,
                        dtype=torch.float32):
        """Restore ``(params, opt_state, aux)`` on the trainer's device;
        the update counter resumes too (Adam's bias correction and the lr
        schedule continue where they stopped)."""
        from .ckpt import host_restore, is_host_format
        if not is_host_format(path):
            raise MXNetError("ShardedTrainer.load_checkpoint: %s is not a "
                             "host-format checkpoint (sharded checkpoints "
                             "come with %s)" % (path, _MULTI_GPU))
        tree, step = host_restore(path, self._ckpt_target(
            data_shapes, label_shapes, dtype))
        self.num_update = step
        return self._placed(tree)

    def checkpoint_manager(self, directory, keep=None):
        """A :class:`~mxnet_tpu_torch.resilience.CheckpointManager` rooted
        at ``directory`` (host format) for versioned keep-last-K
        checkpoints of this trainer's state."""
        from ..resilience import CheckpointManager
        return CheckpointManager(directory, keep=keep)

    def save_checkpoint_versioned(self, directory, params, opt_state, aux,
                                  keep=None):
        """Commit an atomic ``step_<NNNNNNNN>`` checkpoint under
        ``directory`` (pruned to keep-last-K)."""
        mgr = self.checkpoint_manager(directory, keep=keep)
        return mgr.save(self._ckpt_tree(params, opt_state, aux),
                        self.num_update)

    def latest_step(self, directory):
        """Newest committed step under ``directory``, or None."""
        return self.checkpoint_manager(directory).latest_step()

    def auto_resume(self, directory, data_shapes, label_shapes=None,
                    dtype=torch.float32):
        """Resume from the newest readable committed checkpoint under
        ``directory`` (walking back past damaged ones): ``(params,
        opt_state, aux, step)`` on the trainer's device with the update
        counter restored, or None when the run is fresh."""
        got = self.checkpoint_manager(directory).auto_resume(
            self._ckpt_target(data_shapes, label_shapes, dtype))
        if got is None:
            return None
        tree, step = got
        self.num_update = step
        return self._placed(tree) + (step,)

    def hotstate_snapshot(self, params, opt_state, aux):
        """Copy the training state into the warm-handoff area
        (``resilience.hotstate.snapshot``) at this update number."""
        from ..resilience import hotstate as _hotstate
        return _hotstate.snapshot(self._ckpt_tree(params, opt_state, aux),
                                  step=self.num_update)

    def elastic_resume(self, directory, data_shapes, label_shapes=None,
                       dtype=torch.float32, source="auto", kv=None):
        """:meth:`auto_resume` for a re-meshed incarnation.  ``source``:
        ``"warm"`` resumes from the host-memory handoff area
        (``resilience.hotstate``) and reads no checkpoint, degrading to
        the checkpoint on any missing or corrupt shard; ``"cold"`` is the
        versioned checkpoint under ``directory``; ``"auto"`` is warm when
        ``MXTPU_WARM_REMESH`` is on.  Either way an ``elastic`` ``resume``
        record names the path taken, the fallback reason and the restore
        time."""
        import time as _t
        from ..resilience import elastic as _elastic
        from ..resilience import hotstate as _hotstate
        t0 = _t.monotonic()
        got, path, fallback, meta = None, "cold", None, None
        if source == "warm" or (source == "auto"
                                and _hotstate.warm_enabled()):
            try:
                tree, step, meta = _hotstate.warm_resume(
                    self._ckpt_target(data_shapes, label_shapes, dtype),
                    kv=kv)
                self.num_update = step
                got = self._placed(tree) + (step,)
                path = "warm"
            except _hotstate.HotStateUnavailable as exc:
                fallback = exc.reason
        if got is None:
            got = self.auto_resume(directory, data_shapes, label_shapes,
                                   dtype)
        _elastic.emit_transition(
            "resume", step=None if got is None else got[3],
            world_size=self.mesh.num_processes, fresh=got is None,
            path=path, fallback_reason=fallback,
            n_payloads=None if meta is None else meta.get("n_payloads"),
            duration_ms=round((_t.monotonic() - t0) * 1000.0, 3),
            mesh=dict(self.mesh.shape))
        return got


class ShardedPredictor(object):
    """Mesh-sharded inference: the serving-side counterpart of
    :class:`ShardedTrainer` (the port of the JAX package's
    ``ShardedPredictor``).  The batch is split over dp (and with
    ``seq_axis`` its sequence over sp: the trainer's walk, the ring
    included, forward only), the parameters placed as the trainer places
    them (an MoE expert stack split over ep, the tp policy's splits over
    tp), and the forward runs with
    ``is_train=False``; the loss layers' label slots are bound as
    zeros.

    Parameters
    ----------
    symbol : inference symbol (loss heads fine: they run is_train=False).
    mesh : a mesh from ``parallel.make_mesh`` with dp and ep, tp or sp
        axes (tp splits the parameters by the tp policy, as the trainer
        does).
    seq_axis : as :class:`ShardedTrainer`'s.
    arg_params / aux_params : host dicts (e.g. from
        ``model.load_checkpoint``: numpy arrays or NDArrays).
    compute_dtype : dtype of the forward; floating outputs come back
        float32.
    """

    def __init__(self, symbol, mesh, arg_params, aux_params=None,
                 rules=None, seq_axis=None, data_names=("data",),
                 label_names=("softmax_label",), compute_dtype=None):
        from ..model import _host
        from ..optimizer import SGD
        self.symbol = symbol
        self.mesh = mesh
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        self._arg_names = symbol.list_arguments()
        missing = [n for n in self._arg_names
                   if n not in self.data_names and n not in arg_params
                   and n not in self.label_names]
        if missing:
            raise MXNetError("ShardedPredictor: missing parameters %s"
                             % missing)
        # the label slots (and any argument not given) are inputs here,
        # fed as zeros at predict time
        self._slots = [n for n in self._arg_names
                       if n not in self.data_names and n not in arg_params]
        self._tr = ShardedTrainer(symbol, SGD(), mesh,
                                  data_names=self.data_names,
                                  label_names=tuple(self._slots),
                                  rules=rules, seq_axis=seq_axis,
                                  compute_dtype=compute_dtype)
        self.compute_dtype = self._tr.compute_dtype
        self.params = self._tr.place_params(
            {n: _host(v) for n, v in arg_params.items()
             if n in self._tr.param_names})
        self.aux = self._tr.place_params(
            {n: _host(v) for n, v in (aux_params or {}).items()})
        self._slot_shapes = {}

    @classmethod
    def from_checkpoint(cls, prefix, epoch, mesh, **kwargs):
        """Build from a classic ``prefix-symbol.json`` + ``.params``
        checkpoint."""
        from ..model import load_checkpoint
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(sym, mesh, arg_params, aux_params, **kwargs)

    def batch_sharding(self, shape):
        return self._tr.batch_sharding(shape)

    def _zeros(self, batch):
        """Zeros for the label slots the batch does not give, at the
        shapes the batch implies."""
        import numpy as np
        key = tuple(sorted((k, tuple(np.shape(v))) for k, v in
                           batch.items()))
        shapes = self._slot_shapes.get(key)
        if shapes is None:
            arg_shapes, _, _ = self.symbol.infer_shape_partial(
                **{k: tuple(np.shape(v)) for k, v in batch.items()})
            known = dict(zip(self._arg_names, arg_shapes or []))
            shapes = {}
            for n in self._slots:
                if n in batch:
                    continue
                if known.get(n) is None:
                    raise MXNetError("cannot infer shape for %r" % n)
                shapes[n] = tuple(known[n])
            self._slot_shapes[key] = shapes
        return {n: np.zeros(s, np.float32) for n, s in shapes.items()}

    def predict(self, batch):
        """``batch``: ``{name: host array or NDArray}``.  Returns the
        outputs as host numpy arrays (the whole batch)."""
        from ..model import _host
        host = {k: _host(v) for k, v in batch.items()}
        host.update(self._zeros(host))
        placed = self._tr.shard_batch(host)
        outs = self._tr.eval(self.params, self.aux, placed)
        got = []
        for o in outs:
            if isinstance(o, torch.Tensor):
                o = o.detach()
                if self.compute_dtype is not None and o.is_floating_point():
                    o = o.float()
                got.append(o.cpu().numpy())
            else:
                arr = o.global_tensor()
                if self.compute_dtype is not None and arr.is_floating_point():
                    arr = arr.float()
                got.append(arr.detach().cpu().numpy())
        return got


class ShapeDtypeStruct(object):
    """A leaf of :meth:`ShardedTrainer.abstract_state`: shape, dtype and
    placement, no storage."""

    __slots__ = ("shape", "dtype", "sharding")

    def __init__(self, shape, dtype, sharding=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.sharding = sharding

    def __repr__(self):
        return "ShapeDtypeStruct(shape=%s, dtype=%s)" % (self.shape,
                                                         self.dtype)


def _check_sp(sp, seq_axis, zero1, fsdp, tp, ep):
    """What sequence parallelism does not carry yet raises, naming its
    item."""
    what = None
    if seq_axis is None:
        what = "an sp axis without seq_axis (the sequence axis to split)"
    elif zero1 or fsdp:
        what = "%s with seq_axis" % ("zero1=True" if zero1 else "fsdp=True")
    elif tp > 1 or ep > 1:
        what = "seq_axis together with %s=%d" % (
            ("tp", tp) if tp > 1 else ("ep", ep))
    if what is not None:
        raise MXNetError("ShardedTrainer: %s on an sp=%d mesh is not ported "
                         "yet (ROADMAP.md queue 1 item 3 (c2)); run sequence "
                         "parallelism on a dp x sp mesh" % (what, sp))


def _model_split(params):
    """The parameters split over ep or tp: ``{name: the split
    dimension}``, in name order."""
    from .sharding import ShardedArray
    out = {}
    for k in sorted(params):
        v = params[k]
        if isinstance(v, ShardedArray):
            for dim, e in enumerate(v.sharding.spec):
                if e in ("ep", "tp") \
                        and v.sharding.mesh.shape.get(e, 1) > 1:
                    out[k] = dim
                    break
    return out


def _np_array(a):
    import numpy as np
    return np.ascontiguousarray(np.asarray(a))
