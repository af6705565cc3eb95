"""Executor: a bound symbol, evaluated forward by a topological walk.

The port's forward-only counterpart of ``mxnet_tpu/executor.py``.  Where
the JAX package traces the whole graph into one jitted function, the
port runs each node's ``forward`` eagerly on torch tensors in post-DFS
order.  :meth:`Executor._forward_raw` is the counterpart of
``_jit_forward``: tensors in, tensors out, no NDArray bookkeeping —
what ``GenerationEngine.run_async`` calls on every step.  Backward, the
fused training step, mirroring and the program registry belong to the
training slices.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import resolve
from .ndarray import NDArray

__all__ = ["Executor"]


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

        topo = symbol._topo()
        self._variables = [n for n in topo if n.is_variable]
        self._op_nodes = [n for n in topo if not n.is_variable]
        self._heads = list(symbol._heads)
        self.outputs = [None] * len(self._out_names)
        self._n_forward = 0

    def _forward_raw(self, arg_values, aux_values=None, is_train=False):
        """Evaluate the graph on a name->tensor dict; returns the head
        tensors as a list (caller-owned; ``forward`` wraps them)."""
        aux_values = aux_values or {n: a.data
                                    for n, a in self.aux_dict.items()}
        values = {}
        for node in self._variables:
            values[(id(node), 0)] = arg_values[node.name]
        with torch.no_grad():
            for node in self._op_nodes:
                op = node.op
                ins = [values[(id(c), ci)] for c, ci in node.inputs]
                aux_in = [aux_values["%s_%s" % (node.name, a)]
                          for a in op.list_auxiliary_states()]
                # no op of the inference graphs draws random numbers
                outs, _aux_updates = op.forward(ins, aux_in, is_train, None)
                for i, o in enumerate(outs):
                    values[(id(node), i)] = o
        return [values[(id(n), i)] for n, i in self._heads]

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
