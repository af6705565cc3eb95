"""Executor: a bound symbol, evaluated by a topological walk.

The port's counterpart of ``mxnet_tpu/executor.py``.  Where the JAX
package traces the whole graph into one jitted function, the port runs
each node's ``forward`` eagerly on torch tensors in post-DFS order.

- :func:`build_program` is the counterpart of
  ``_build_program(symbol, {}).trace``: the one graph walk, with
  autograd on, which ``parallel.trainer.ShardedTrainer`` differentiates.
- :class:`Executor` is forward only: :meth:`Executor._forward_raw` is
  the counterpart of ``_jit_forward`` (tensors in, tensors out, no
  NDArray bookkeeping): the same walk under ``torch.no_grad``, what
  ``GenerationEngine.run_async`` calls on every step.

Executors share programs through a registry keyed like the JAX
package's ``_lookup_program``: graph fingerprint, device and
``MXNET_COMPUTE_DTYPE``.  ``build_program`` runs once a key, so the
per-bucket binds of one model share one program, and
:func:`program_registry_stats` counts the builds ("lowerings") and the
hits: a warmed server performs zero lowerings.

``simple_bind``, backward through the Executor and mirroring belong to
later slices.
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError
from .context import resolve
from .ndarray import NDArray

__all__ = ["Executor", "build_program", "program_registry_stats"]


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
    """Parity: include/mxnet/symbolic.h:323 + python/mxnet/executor.py,
    forward only."""

    def __init__(self, symbol, ctx, args, aux_states=None):
        self._symbol = symbol
        self._device = resolve(ctx)
        self._arg_names = symbol.list_arguments()
        self._out_names = symbol.list_outputs()
        self._aux_names = symbol.list_auxiliary_states()

        arg_list = _as_list(args, self._arg_names, "args")
        missing = [n for n, a in zip(self._arg_names, arg_list) if a is None]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self.arg_arrays = arg_list
        self.arg_dict = dict(zip(self._arg_names, arg_list))

        aux_list = _as_list(aux_states, self._aux_names, "aux_states")
        missing = [n for n, a in zip(self._aux_names, aux_list) if a is None]
        if missing:
            raise MXNetError("bind: missing aux states %s" % missing)
        self.aux_arrays = aux_list
        self.aux_dict = dict(zip(self._aux_names, aux_list))

        self._program = _lookup_program(symbol, self._device)
        self.outputs = [None] * len(self._out_names)
        self._n_forward = 0

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

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` overwrite bound arguments first.
        Returns the output NDArrays (also kept in ``outputs``)."""
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % name)
            self.arg_dict[name][:] = arr
        self._n_forward += 1
        outs = self._forward_raw({n: a.data for n, a in self.arg_dict.items()},
                                 is_train=is_train)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs
