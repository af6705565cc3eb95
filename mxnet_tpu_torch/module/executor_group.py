"""The executor group of a Module.

The port of ``mxnet_tpu/module/executor_group.py``, with the JAX
package's two modes:

- **sharded** (several contexts, ``MXNET_MODULE_SHARDED`` not ``0``):
  one executor bound on the global batch over every context, the
  port's counterpart of the JAX executor over a ``jax.sharding.Mesh``:
  each step splits the batch on axis 0 over the contexts and runs the
  lockstep walk, the gradients summed over them inside the backward
  (``Executor.set_replicas``), BatchNorm's statistics those of the
  whole batch.  The fused step (forward, backward, update) then runs as
  one call, as with one context.
- **slicing** (one context, the reference's per-context executors):
  one executor a context, each on its slice of the batch with its own
  parameters, gradients and BatchNorm statistics; the gradients are
  summed by the kvstore, or each executor is updated with its own.
  It is taken when the contexts repeat (the same context twice, not
  the same device: ``[gpu(0), gpu(0)]`` slices, ``[cpu(0), cpu(1)]``
  and ``[gpu(0), gpu(1)]`` are sharded), when their device types are
  mixed, or when the batch does not divide over them.

The grad_req rules are the reference's (fixed parameters and inputs get
``null``; data get ``write`` with ``inputs_need_grad``).  A shared group
(a ``BucketingModule``'s default bucket) lends its executors' parameter,
gradient and aux arrays, and its input buffers, whose heads the smaller
bucket's inputs view (``executor_manager._bind_exec``); a bucketing
module on several sharded contexts is not ported (ROADMAP.md queue 1
item 3) and raises.
"""
from __future__ import annotations

import logging
import os

import torch

from ..base import MXNetError
from ..executor_manager import (_bind_exec, _split_input_slice,
                                _load_data, _load_label)
from ..io import DataDesc
from ..ndarray import NDArray, concatenate

__all__ = ["DataParallelExecutorGroup"]


def _as_data_desc(pairs):
    return [item if isinstance(item, DataDesc)
            else DataDesc(item[0], tuple(item[1])) for item in pairs or []]


def _check_arguments(symbol):
    """Reject duplicate argument or aux names (executor_manager.py:42)."""
    for names in (symbol.list_arguments(), symbol.list_auxiliary_states()):
        seen = set()
        for name in names:
            if name in seen:
                raise ValueError("Find duplicated argument name \"%s\", please "
                                 "make the weight name non-duplicated (using "
                                 "name arguments), arguments are %s"
                                 % (name, names))
            seen.add(name)


def multi_context_dist_error(n_contexts, n_processes):
    """The error for a sharded group in a ``dist_*`` group of several
    processes, which this port does not run (ROADMAP.md queue 1 item 3
    (g)): its in-step sum covers only its own process's contexts."""
    return MXNetError(
        "Module on %d contexts in a process group of %d processes: "
        "several cards per process within a dist group are not "
        "ported yet (ROADMAP.md queue 1 item 3 (g)); launch one "
        "process per card" % (n_contexts, n_processes))


class DataParallelExecutorGroup:
    """Parity: module/executor_group.py:21."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write"):
        _check_arguments(symbol)
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = list(param_names)
        self.data_shapes = _as_data_desc(data_shapes)
        self.label_shapes = _as_data_desc(label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]

        # -- sharded single-executor mode ------------------------------
        self.sharded = False
        self._group = None
        if shared_group is not None:
            if shared_group.sharded:
                raise MXNetError(
                    "a BucketingModule (a shared executor group) on "
                    "several sharded contexts is not ported yet "
                    "(ROADMAP.md queue 1 item 3); set "
                    "MXNET_MODULE_SHARDED=0 to slice the batch instead")
        elif len(contexts) > 1 and os.environ.get(
                "MXNET_MODULE_SHARDED", "1") != "0":
            self._try_init_mesh(contexts, logger)
        if self.sharded:
            self.slices = [slice(0, self.batch_size)]
            contexts = [contexts[0]]
        else:
            self.slices = _split_input_slice(self.batch_size, self.workload)

        input_names = set(self.data_names) | set(self.label_names)
        if isinstance(grad_req, str):
            req = {}
            for name in self.arg_names:
                if name in self.fixed_param_names:
                    req[name] = "null"
                elif name in self.param_names:
                    req[name] = grad_req if for_training else "null"
                elif name in input_names:
                    req[name] = "write" if (
                        for_training and inputs_need_grad
                        and name in self.data_names) else "null"
                else:
                    req[name] = "null"
        else:
            req = dict(grad_req)
            for name in self.fixed_param_names:
                req[name] = "null"

        self.shared_data_arrays = [{} for _ in contexts] \
            if shared_group is None else shared_group.shared_data_arrays
        need_grad = {n for n, r in req.items() if r != "null"}
        self.execs = []
        for i, ctx in enumerate(contexts):
            islice = self.slices[i]
            shapes = {d.name: (islice.stop - islice.start,)
                      + tuple(d.shape[1:])
                      for d in self.data_shapes + self.label_shapes}
            self.execs.append(_bind_exec(
                symbol, ctx, shapes, self.param_names, need_grad=need_grad,
                base_exec=None if shared_group is None
                else shared_group.execs[i],
                shared_data_arrays=self.shared_data_arrays[i],
                grad_req=req))
        if self.sharded:
            self.execs[0].set_replicas(self._group, self.data_names
                                       + self.label_names)

        self.data_arrays = [[(self.slices[i], e.arg_dict[name])
                             for i, e in enumerate(self.execs)]
                            for name in self.data_names]
        self.label_arrays = [[(self.slices[i], e.arg_dict[name])
                              for i, e in enumerate(self.execs)]
                             for name in self.label_names]
        self.param_arrays = [[e.arg_dict[name] for e in self.execs]
                             for name in self.param_names]
        # aligned with param_names; [None] for fixed parameters, which
        # the update helpers skip
        self.grad_arrays = [[e.grad_dict.get(name) for e in self.execs]
                            for name in self.param_names] \
            if for_training else []
        self.aux_arrays = [[e.aux_dict[name] for e in self.execs]
                           for name in self.aux_names]

    # ------------------------------------------------------------------
    def _try_init_mesh(self, contexts, logger):
        """One data-parallel group over the contexts (the JAX package's
        ``_try_init_mesh``); slicing instead when the contexts repeat or
        mix device types, or the batch does not divide over them."""
        from ..parallel.collectives import ReplicaGroup
        from ..parallel.mesh import _world
        log = logger or logging
        if len({c.device_type for c in contexts}) != 1:
            return
        if len(set(contexts)) != len(contexts):
            return
        if _world() > 1:
            raise multi_context_dist_error(len(contexts), _world())
        if self.batch_size % len(contexts):
            log.warning(
                "batch %d not divisible by %d devices: using per-device "
                "slicing instead of the sharded executor",
                self.batch_size, len(contexts))
            return
        from ..context import resolve
        self._group = ReplicaGroup([resolve(c) for c in contexts])
        self.sharded = True

    # ------------------------------------------------------------------
    def load_data_batch(self, data_batch):
        """Copy the batch's data (and labels) into the bound arrays: the
        whole batch into the sharded executor's, each context's slice
        into its executor's."""
        _load_data(data_batch, self.data_arrays)
        if self.label_arrays and data_batch.label:
            _load_label(data_batch, self.label_arrays)

    def forward(self, data_batch=None, is_train=None):
        if data_batch is not None:
            self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        for exec_ in self.execs:
            exec_.forward(is_train=is_train)

    def forward_backward(self, data_batch):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        self.load_data_batch(data_batch)
        for exec_ in self.execs:
            exec_.forward_backward()

    def fused_step(self, data_batch, optimizer, states, num_update):
        """The whole training step (forward, backward, update) in one
        executor call; returns the new optimizer states.  One context,
        or the sharded executor (whose backward sums the gradients over
        the contexts: the in-step counterpart of kvstore device and
        dist_sync)."""
        if len(self.execs) != 1:
            raise MXNetError("fused_step requires a single-context or "
                             "sharded group")
        self.load_data_batch(data_batch)
        return self.execs[0].fused_step(optimizer, states, num_update)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        for i, exec_ in enumerate(self.execs):
            if out_grads is not None and len(self.execs) > 1:
                islice = self.slices[i]
                exec_.backward([g[islice] if g.shape[0] == self.batch_size
                                else g for g in out_grads])
            else:
                exec_.backward(out_grads)

    # ------------------------------------------------------------------
    def get_outputs(self, merge_multi_context=True):
        outputs = [[e.outputs[i] for e in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [_merge(parts) for parts in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        grads = [[e.grad_dict[name] for e in self.execs]
                 for name in self.data_names]
        if merge_multi_context:
            return [_merge(parts) for parts in grads]
        return grads

    def get_params(self, arg_params, aux_params):
        """The executors' parameters and aux states, averaged over the
        contexts (executor_group.py:470; one context: a copy), on the
        first context."""
        for name, block in zip(self.param_names, self.param_arrays):
            arg_params[name] = _average(block)
        for name, block in zip(self.aux_names, self.aux_arrays):
            aux_params[name] = _average(block)

    def set_params(self, arg_params, aux_params):
        for exec_ in self.execs:
            exec_.copy_params_from(arg_params, aux_params)

    def update_metric(self, eval_metric, labels):
        for texec, islice in zip(self.execs, self.slices):
            eval_metric.update([label[islice] for label in labels],
                               texec.outputs)

    def install_monitor(self, mon):
        for exec_ in self.execs:
            mon.install(exec_)


def _average(block):
    """The mean of one array's copies, summed in context order on the
    first one's device (a copy when there is one)."""
    if len(block) == 1:
        return block[0].copy()
    total = block[0].data.clone()
    for b in block[1:]:
        total += b.data.to(total.device)
    return NDArray(total / len(block), ctx=block[0].context)


def _merge(parts):
    if len(parts) == 1:
        return parts[0]
    return concatenate([NDArray(p.data.to(parts[0].data.device),
                                ctx=parts[0].context) for p in parts],
                       axis=0)
