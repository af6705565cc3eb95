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

``simple_bind``, backward through the Executor, mirroring and the
program registry belong to later slices.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import resolve
from .ndarray import NDArray

__all__ = ["Executor", "build_program"]


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

        self._program = build_program(symbol)
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
