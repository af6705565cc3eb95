"""ShardedTrainer: one training step of a Symbol on one GPU.

The port's slice of ``mxnet_tpu/parallel/trainer.py``.  The JAX trainer
compiles forward, backward, gradient reduction and the optimizer update
into one jitted program over a device mesh; the port runs the same step
eagerly on the one device of its mesh:

1. the graph walk (``executor.build_program``) with autograd on, the
   parameters cast to ``compute_dtype`` (Embedding ids and labels
   exempt: bfloat16 holds integers exactly only up to 256);
2. ``torch.autograd.grad`` of the outputs with ones as head gradients
   (the loss heads ignore them, as in the reference);
3. the optimizer update: leafwise ``_preprocess_grad`` + ``update_fn``,
   or the fused sweep (``MXTPU_FUSED_OPT``: ``'1'`` plain, ``'kernel'``
   the CUDA sweep of ``kernels/fused_opt.py``), bitwise equal.

Batches come from :meth:`ShardedTrainer.shard_batch`, or from
:meth:`ShardedTrainer.prefetch_feed`, the async device feed
(``overlap.DevicePrefetcher``); a uint8 image batch crosses to the
device as uint8 and is widened there to the parameters' dtype (float32;
``compute_dtype`` when one is set).

``remat=True`` recomputes the whole forward in the backward: the walk
runs under one ``torch.utils.checkpoint`` (the JAX trainer wraps its
trace in one ``jax.checkpoint``), and the update after it is the same.
``zero1``, ``fsdp``, ``seq_axis`` (ring attention), the in-step
sentinel, the step watchdog and the checkpoint methods belong to later
slices and raise; none is ignored.  With no ``ctx`` and no mesh,
the trainer runs on the current context (``gpu(0)`` outside a ``with``
scope).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import resolve
from ..kernels.common import env_flag

__all__ = ["ShardedTrainer"]

_MULTI_GPU = "the multi-GPU training slice"


def _not_ported(what, slice_name):
    return MXNetError("ShardedTrainer: %s is not ported yet; it comes with "
                      "%s" % (what, slice_name))


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
    """Train a Symbol's loss graph on one device.

    Parameters
    ----------
    symbol : Symbol with loss head(s) (e.g. SoftmaxOutput).
    optimizer : ``mxnet_tpu_torch.optimizer.Optimizer``.
    mesh : a one-device mesh from ``parallel.make_mesh``, or None.
    data_names / label_names : input argument names.
    compute_dtype : dtype of the forward and backward (params, opt state
        and aux stay in their own dtype; gradients arrive in it).
    ctx : the device (a context, a ``torch.device`` or a string); None
        means the mesh's device, else the current context.

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
        if zero1:
            raise _not_ported("zero1 (sharded optimizer state)", _MULTI_GPU)
        if fsdp:
            raise _not_ported("fsdp (sharded parameters)", _MULTI_GPU)
        if seq_axis is not None:
            raise _not_ported("seq_axis (ring attention)", _MULTI_GPU)
        if sentinel is None:
            sentinel = env_flag("MXTPU_SENTINEL") not in ("", "0", "false",
                                                          "off")
        if sentinel:
            raise _not_ported("the in-step numeric sentinel (sentinel=True "
                              "or MXTPU_SENTINEL)", "the resilience slice")
        if step_timeout_s or env_flag("MXTPU_STEP_TIMEOUT_S") not in ("",
                                                                   "0"):
            raise _not_ported("the step watchdog (step_timeout_s or "
                              "MXTPU_STEP_TIMEOUT_S)", "the resilience slice")
        if mesh is not None and mesh.size != 1:
            raise _not_ported("a mesh of %d devices" % mesh.size, _MULTI_GPU)
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
        self.rules = rules      # no effect: a one-device mesh places all on it
        self.compute_dtype = _compute_dtype(compute_dtype)

        from ..kernels import fused_opt as _fused
        self._fused_mod = _fused
        self._fused_opt = _fused.fused_opt_mode() \
            if _fused.supports_fused(optimizer) else ""
        if self._fused_opt == "kernel":
            _fused.sweep_body(optimizer)    # raises when it has no body

        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self._arg_names
                            if n not in self.data_names
                            and n not in self.label_names]
        from ..executor import build_program
        program = build_program(symbol)
        self.remat = bool(remat)
        self._trace = _remat(program.trace) if self.remat else program.trace
        self._needs_rng = program.needs_rng
        self.num_update = 0

        exempt = set(self.label_names) | set(cast_exempt)
        for node in symbol._topo():
            if node.op is not None \
                    and getattr(node.op, "op_name", "") == "Embedding":
                src, _ = node.inputs[0]
                if src.is_variable:
                    exempt.add(src.name)
        self._cast_exempt = frozenset(exempt)

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
    # state init
    # ------------------------------------------------------------------
    def init_params(self, data_shapes, initializer=None, label_shapes=None,
                    dtype=torch.float32):
        """Infer shapes and allocate params, optimizer state and aux on
        the trainer's device.  Returns ``(params, opt_state, aux)``
        dicts of tensors.  ``initializer`` defaults to ``Uniform(0.07)``
        drawing from ``random.generator("cpu")``."""
        from ..initializer import Uniform
        from ..ndarray import NDArray
        shape_map, aux_map = self._shape_maps(data_shapes, label_shapes)
        initializer = initializer or Uniform(0.07)
        params = {}
        for name in self.param_names:
            host = NDArray(torch.zeros(shape_map[name], dtype=dtype))
            initializer(name, host)
            params[name] = host.data.to(self.device)
        opt_state = {}
        for name in self.param_names:
            s = self.optimizer.create_state_arrays(shape_map[name], dtype,
                                                   self.device)
            if s is not None:
                opt_state[name] = s
        aux = {}
        for name in self._aux_names:
            fill = torch.ones if name.endswith("moving_var") else torch.zeros
            aux[name] = fill(aux_map[name], dtype=dtype, device=self.device)
        return params, opt_state, aux

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
        feed's pinned buffers and stream)."""
        from .. import ndarray as nd
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

    def step(self, params, opt_state, aux, batch, rng=None):
        """Run one training step; returns ``(params, opt_state, aux,
        outputs)``, the first three the dicts given, updated in place."""
        self.num_update += 1
        opt = self.optimizer
        lr = opt.lr_scheduler(self.num_update) \
            if opt.lr_scheduler is not None else opt.lr
        wd = opt.wd
        t = self.num_update
        rng = self._rng(rng)

        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self.param_names}
        args = self._to_compute(leaves)
        args.update(self._batch_to_compute(batch, leaves))
        outs, aux_out = self._trace(args, self._to_compute(aux), rng, True)
        order = [leaves[n] for n in self.param_names]
        grads = torch.autograd.grad(
            outs, order, grad_outputs=[torch.ones_like(o) for o in outs],
            allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(leaves[n])
                 for n, g in zip(self.param_names, grads)}

        with torch.no_grad():
            if self._fused_opt:
                new_w, new_s = self._fused_mod.fused_apply(
                    opt, {n: params[n] for n in self.param_names}, grads,
                    opt_state, lr, wd, t, mode=self._fused_opt,
                    preprocess=True)
            else:
                new_w, new_s = {}, {}
                t_dev = torch.tensor(float(t), device=self.device)
                for n in self.param_names:
                    new_w[n], new_s[n] = opt._step(
                        params[n], grads[n], opt_state.get(n), lr, wd, t_dev)
            params.update(new_w)
            for n, s in new_s.items():
                if s is not None:
                    opt_state[n] = s
            for n, v in aux_out.items():
                aux[n] = v.detach().to(aux[n].dtype)
        return params, opt_state, aux, [o.detach() for o in outs]

    def eval(self, params, aux, batch, rng=None):
        """Forward in ``compute_dtype`` with ``is_train=False``."""
        with torch.no_grad():
            args = self._to_compute(params)
            args.update(self._batch_to_compute(batch, params))
            outs, _ = self._trace(args, self._to_compute(aux), rng, False)
        return outs

    # ------------------------------------------------------------------
    # later slices
    # ------------------------------------------------------------------
    def _checkpoints(self, *args, **kwargs):
        raise _not_ported("checkpointing", "the resilience slice")

    save_checkpoint = load_checkpoint = checkpoint_manager = _checkpoints
    save_checkpoint_versioned = latest_step = auto_resume = _checkpoints
    hotstate_snapshot = elastic_resume = abstract_state = _checkpoints
