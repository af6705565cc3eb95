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
package's ``_lookup_program``: graph fingerprint, device and
``MXNET_COMPUTE_DTYPE``.  ``build_program`` runs once a key, so the
per-bucket binds of one model share one program, and
:func:`program_registry_stats` counts the builds ("lowerings") and the
hits: a warmed server performs zero lowerings.  The walk is the same
function for inference and training, so one program serves both; the
fused step's own state (the optimizer's hyperparameters, multipliers
and compute dtype) is keyed on the executor (:meth:`Executor._fused`).

Mirroring (recomputed segments) and the Monitor belong to later slices.
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError
from .context import Context, resolve
from .ndarray import NDArray, zeros

__all__ = ["Executor", "build_program", "program_registry_stats",
           "simple_bind"]


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
    is_train) -> (outputs, aux_updates)`` on name -> tensor dicts, with
    autograd on, and ``needs_rng``: whether an op of the graph declares
    ``need_rng``.  ``rng`` is a ``torch.Generator`` (or None), handed to
    every such op."""

    __slots__ = ("trace", "needs_rng")

    def __init__(self, trace, needs_rng):
        self.trace = trace
        self.needs_rng = needs_rng


def build_program(symbol):
    """The counterpart of ``mxnet_tpu.executor._build_program(symbol,
    {})``: flatten the graph into one schedule, once."""
    topo = symbol._topo()
    variables = [n for n in topo if n.is_variable]
    op_nodes = [n for n in topo if not n.is_variable]
    heads = list(symbol._heads)
    needs_rng = any(getattr(n.op, "need_rng", False) for n in op_nodes)
    for node in op_nodes:
        if node.attrs.get("force_mirroring") or "mirror_stage" in node.attrs:
            raise MXNetError("%s: mirrored (recomputed) segments are not "
                             "ported yet" % node.name)

    def trace(arg_values, aux_values, rng, is_train):
        values = {}
        aux_out = dict(aux_values)
        for node in variables:
            values[(id(node), 0)] = arg_values[node.name]
        for node in op_nodes:
            op = node.op
            ins = [values[(id(c), ci)] for c, ci in node.inputs]
            aux_names = ["%s_%s" % (node.name, a)
                         for a in op.list_auxiliary_states()]
            aux_in = [aux_values[a] for a in aux_names]
            key = rng if getattr(op, "need_rng", False) else None
            outs, aux_updates = op.forward(ins, aux_in, is_train, key)
            for i, o in enumerate(outs):
                values[(id(node), i)] = o
            if aux_updates is not None:
                for a, u in zip(aux_names, aux_updates):
                    aux_out[a] = u
        return [values[(id(n), i)] for n, i in heads], aux_out

    return Program(trace, needs_rng)


#: (graph fingerprint, device, compute dtype) -> Program
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


def _lookup_program(symbol, device):
    """The registry's program for ``symbol`` on ``device``, built on a
    miss."""
    from .parallel import overlap as _overlap
    key = (_overlap.graph_fingerprint(symbol), str(device),
           os.environ.get("MXNET_COMPUTE_DTYPE", ""))
    with _REGISTRY_LOCK:
        prog = _PROGRAM_REGISTRY.get(key)
        if prog is None:
            _overlap.note_lowering()
            prog = _PROGRAM_REGISTRY[key] = build_program(symbol)
        else:
            _overlap.note_hit()
    return prog


class Executor:
    """Parity: include/mxnet/symbolic.h:323 + python/mxnet/executor.py.

    ``args`` (and ``args_grad``, ``aux_states``) are lists aligned with
    the symbol's arguments (aux states) or name -> NDArray dicts.
    ``grad_req`` is ``"write"``, ``"add"`` or ``"null"``, a list, or a
    dict (missing names ``"null"``); an argument without a gradient array
    gets ``"null"``.  Missing aux states are allocated as zeros."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._device = resolve(ctx)
        self._ctx = ctx if isinstance(ctx, Context) \
            else Context.from_device(self._device)
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

        self._program = _lookup_program(symbol, self._device)
        self.outputs = [None] * len(self._out_names)
        self._pending = None        # (outputs, leaves) of a training forward
        self._n_forward = 0
        self._n_fwd_bwd = 0
        self._n_fused_step = 0

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

    def _forward_raw(self, arg_values, aux_values=None, is_train=False):
        """Evaluate the graph on a name->tensor dict; returns the head
        tensors as a list (caller-owned; ``forward`` wraps them).  The
        walk's aux updates are dropped (forward only), and no generator
        is handed to ops: the inference graphs draw no random numbers."""
        aux_values = aux_values or {n: a.data
                                    for n, a in self.aux_dict.items()}
        with torch.no_grad():
            outs, _aux_updates = self._program.trace(
                arg_values, aux_values, None, is_train)
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
        graph is kept for :meth:`backward`."""
        self._set_args(kwargs)
        self._n_forward += 1
        self._pending = None
        args = {n: a.data for n, a in self.arg_dict.items()}
        aux_values = {n: a.data for n, a in self.aux_dict.items()}
        wrt = self._wrt_names() if is_train else ()
        if not is_train:
            outs = self._forward_raw(args, aux_values)
            self.outputs = [NDArray(o) for o in outs]
            return self.outputs
        leaves = {n: args[n].detach().requires_grad_(True) for n in wrt}
        args.update(leaves)
        with torch.set_grad_enabled(bool(wrt)):
            outs, aux_out = self._program.trace(args, aux_values,
                                                self._rng(), True)
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
        """Forward in training mode, then backward; returns the outputs."""
        self.forward(is_train=True, **kwargs)
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
        leaves = {n: args[n].detach().requires_grad_(True) for n in wrt}
        merged = {n: cast(n, v) for n, v in args.items()}
        merged.update({n: cast(n, v) for n, v in leaves.items()})
        with torch.enable_grad():
            outs, aux_out = self._program.trace(
                merged, {n: cast(n, v) for n, v in aux_values.items()},
                self._rng(), True)
        aux_out = {k: v.detach().to(aux_values[k].dtype)
                   for k, v in aux_out.items()}
        grads = _grads(outs, leaves, [torch.ones_like(o) for o in outs])
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

    def init_fused_states(self, optimizer):
        """Optimizer state for every learnable argument (fused path)."""
        states = {}
        for n in self._wrt_names():
            a = self.arg_dict[n]
            s = optimizer.create_state_arrays(a.shape, a.dtype, a.data.device)
            if s is not None:
                states[n] = s
        return states

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
                        self._grad_req, dict(self.aux_dict))


def _grads(outs, leaves, head_grads):
    """``{name: gradient}`` of ``outs`` with respect to ``leaves``; an
    argument the heads do not reach (a fixed BatchNorm gamma) gets
    zeros, as the vjp gives in the JAX package."""
    names = list(leaves)
    got = torch.autograd.grad(outs, [leaves[n] for n in names], head_grads,
                              allow_unused=True)
    return {n: torch.zeros_like(leaves[n]) if g is None else g
            for n, g in zip(names, got)}


def simple_bind(symbol, ctx, grad_req="write", type_dict=None, **kwargs):
    """Allocate argument, gradient and aux arrays from the shapes inferred
    from ``kwargs`` (name -> shape), then bind (parity:
    symbol.py:630-710)."""
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
    return Executor(symbol, ctx, args, grads, grad_req, aux)
