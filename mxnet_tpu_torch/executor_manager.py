"""Executor management for the legacy FeedForward path.

The port of ``mxnet_tpu/executor_manager.py`` (the reference's
``python/mxnet/executor_manager.py``): ``_split_input_slice``,
``_check_arguments``, ``_load_data``/``_load_label``, ``_bind_exec``,
``DataParallelExecutorGroup`` and ``DataParallelExecutorManager`` over a
ctx list: each batch is sliced over the contexts by workload, one
executor a context, each with its own parameters, gradients and aux
states; the gradients are summed by the kvstore (``FeedForward(ctx=[...])``
with ``device``, or a ``dist_*`` store across processes), and the
parameters read back are the contexts' average.  With a ``sym_gen``
(bucketing) the manager binds one group per bucket key; every group's
executor shares the first group's parameter, gradient and aux arrays
(the same tensors), and its input arrays are views of the head of the
largest bucket's buffers (``_bind_exec``).
"""
from __future__ import annotations

import logging

import numpy as _np

from .base import MXNetError
from .ndarray import NDArray, zeros

__all__ = ["DataParallelExecutorManager", "_split_input_slice",
           "_check_arguments"]


def _split_input_slice(batch_size, work_load_list):
    """Slice batch rows by workload (parity: executor_manager.py:14)."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(work_load * batch_size / total_work_load)
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _check_arguments(symbol):
    """Reject duplicate arg/aux names (parity: executor_manager.py:42)."""
    arg_set = set()
    arg_names = symbol.list_arguments()
    for name in arg_names:
        if name in arg_set:
            raise ValueError(("Find duplicated argument name \"%s\", "
                              "please make the weight name non-duplicated(using name arguments), "
                              "arguments are %s") % (name, str(arg_names)))
        arg_set.add(name)
    aux_set = set()
    aux_names = symbol.list_auxiliary_states()
    for name in aux_names:
        if name in aux_set:
            raise ValueError(
                ("Find duplicated auxiliary param name \"%s\", "
                 "please make the weight name non-duplicated(using name arguments), "
                 "arguments are %s, auxiliary params are %s"
                 ) % (name, str(arg_names), str(aux_names)))
        aux_set.add(name)


def _load_general(data, targets):
    for d_src, d_targets in zip(data, targets):
        src = d_src.data if isinstance(d_src, NDArray) else d_src
        if isinstance(d_targets, NDArray):
            d_targets._set_data(src)
        else:  # list of (slice, NDArray) per device
            for slice_idx, d_dst in d_targets:
                d_dst._set_data(src[slice_idx])


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


class DataParallelExecutorGroup(object):
    """The executors of a ctx list (parity: executor_manager.py:180),
    each bound on its slice of the batch; the manager gives it one
    context.  With ``shared_group`` (another bucket's group) each
    executor borrows that group's parameters, gradients, aux states and
    input buffers (``_bind_exec``)."""

    def __init__(self, sym, arg_names, param_names, ctx, slices, train_data,
                 shared_group=None):
        _check_arguments(sym)
        self.ctx = ctx
        self.slices = slices

        if shared_group is None:
            self.shared_data_arrays = [{} for _ in ctx]
        else:
            self.shared_data_arrays = shared_group.shared_data_arrays

        self.data_names = [x[0] for x in train_data.provide_data]
        self.label_names = [x[0] for x in train_data.provide_label]
        self.aux_names = sym.list_auxiliary_states()
        self.param_names = [n for n in arg_names if n in param_names]
        self.arg_names = arg_names

        self.train_execs = []
        for i, ctx_i in enumerate(ctx):
            data_shapes = {}
            for k, v in train_data.provide_data + train_data.provide_label:
                shard = self.slices[i].stop - self.slices[i].start
                data_shapes[k] = tuple([shard] + list(v[1:]))
            grad_req = {name: ("write" if name in param_names else "null")
                        for name in arg_names}
            shared_exec = None if shared_group is None else \
                shared_group.train_execs[i]
            self.train_execs.append(_bind_exec(
                sym, ctx_i, data_shapes, param_names, need_grad=True,
                base_exec=shared_exec,
                shared_data_arrays=self.shared_data_arrays[i],
                grad_req=grad_req))

        self.data_arrays = [[(self.slices[i], e.arg_dict[name])
                             for i, e in enumerate(self.train_execs)]
                            for name in self.data_names]
        self.label_arrays = [[(self.slices[i], e.arg_dict[name])
                              for i, e in enumerate(self.train_execs)]
                             for name in self.label_names]

        self.param_arrays = [[e.arg_dict[name] for e in self.train_execs]
                             for name in self.param_names]
        self.grad_arrays = [[e.grad_dict[name] for e in self.train_execs]
                            for name in self.param_names]
        self.aux_arrays = [[e.aux_dict[name] for e in self.train_execs]
                           for name in self.aux_names]

    def load_data_batch(self, data_batch):
        _load_data(data_batch, self.data_arrays)
        _load_label(data_batch, self.label_arrays)

    def forward(self, is_train=False):
        for texec in self.train_execs:
            texec.forward(is_train=is_train)

    def backward(self):
        for texec in self.train_execs:
            texec.backward()

    def forward_backward(self):
        """Forward and backward of every executor, in one call each."""
        for texec in self.train_execs:
            texec.forward_backward()

    def update_metric(self, metric, labels):
        for texec, islice in zip(self.train_execs, self.slices):
            labels_slice = [label[islice] for label in labels]
            metric.update(labels_slice, texec.outputs)


def _bind_exec(sym, ctx, input_shapes, param_names, need_grad=False,
               base_exec=None, shared_data_arrays=None, grad_req=None):
    """Bind one executor, reusing another's arrays where it can (parity:
    executor_manager.py:95 ``_bind_exec``): gradients for ``need_grad``
    (a set of names, or True for every argument outside
    ``input_shapes``).  With ``base_exec``, each parameter and its
    gradient are the base executor's NDArrays (one storage: an update
    through either executor is an update of both), and so are the aux
    states.  With ``shared_data_arrays`` (name -> NDArray, kept across
    buckets), an input that fits in the stored array is a view of that
    array's head; a larger one is allocated and stored instead."""
    arg_shape, _, aux_shape = sym.infer_shape(**input_shapes)
    if arg_shape is None:
        raise ValueError("input_shapes are incomplete")
    arg_names = sym.list_arguments()
    if need_grad is True:
        need_grad = {name for name in arg_names if name not in input_shapes}
    elif need_grad is False:
        need_grad = set()

    args, grads = {}, {}
    for name, shape in zip(arg_names, arg_shape):
        shape = tuple(shape)
        if base_exec is not None and name in param_names:
            arr = base_exec.arg_dict[name]
            if tuple(arr.shape) != shape:
                raise MXNetError("bucket binds %s at %s, the shared "
                                 "executor holds %s"
                                 % (name, shape, tuple(arr.shape)))
            args[name] = arr
            if name in need_grad and name in base_exec.grad_dict:
                grads[name] = base_exec.grad_dict[name]
            continue
        if shared_data_arrays is not None and name not in param_names:
            size = int(_np.prod(shape, dtype=_np.int64))
            held = shared_data_arrays.get(name)
            if held is not None and held.size >= size:
                arr = held.reshape((-1,))[:size].reshape(shape)
            else:
                arr = shared_data_arrays[name] = zeros(shape, ctx=ctx)
        else:
            arr = zeros(shape, ctx=ctx)
        args[name] = arr
        if name in need_grad:
            grads[name] = zeros(shape, ctx=ctx)

    if base_exec is not None:
        aux_arrays = base_exec.aux_arrays
    else:
        aux_arrays = [zeros(s, ctx=ctx) for s in aux_shape]
    if grad_req is None:
        grad_req = {name: ("write" if name in need_grad else "null")
                    for name in arg_names}
    return sym.bind(ctx, args, grads, grad_req, aux_arrays)


class DataParallelExecutorManager(object):
    """Top-level manager (parity: executor_manager.py:264)."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))

        if work_load_list is None:
            work_load_list = [1] * num_device
        assert isinstance(work_load_list, list) and \
            len(work_load_list) == num_device

        self.batch_size = train_data.batch_size
        self.slices = _split_input_slice(self.batch_size, work_load_list)
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.train_data = train_data

        self.execgrp = DataParallelExecutorGroup(
            symbol, arg_names, param_names, ctx, self.slices, train_data)
        self.execgrp_bucket = {}
        if sym_gen is not None:
            self.execgrp_bucket[train_data.default_bucket_key] = self.execgrp
        self.curr_execgrp = self.execgrp

    def install_monitor(self, monitor):
        if self.sym_gen is not None:
            raise MXNetError("Monitoring is not implemented for bucketing")
        for train_exec in self.execgrp.train_execs:
            monitor.install(train_exec)

    def set_params(self, arg_params, aux_params):
        for texec in self.execgrp.train_execs:
            texec.copy_params_from(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """The executors' parameters and aux states into the dicts,
        averaged over the contexts (a copy with one), on the first."""
        from .module.executor_group import _average
        for name, block in zip(self.param_names, self.param_arrays):
            arg_params[name] = _average(block)
        for name, block in zip(self.aux_names, self.aux_arrays):
            aux_params[name] = _average(block)

    @property
    def param_arrays(self):
        return self.curr_execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.curr_execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.curr_execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        """Switch to the batch's bucket (binding its group on first
        sight, sharing the first group's arrays) and load the batch."""
        if self.sym_gen is not None:
            key = data_batch.bucket_key
            if key not in self.execgrp_bucket:
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    self.sym_gen(key), self.arg_names, self.param_names,
                    self.ctx, self.slices, data_batch,
                    shared_group=self.execgrp)
            self.curr_execgrp = self.execgrp_bucket[key]
        else:
            self.curr_execgrp = self.execgrp
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def forward_backward(self):
        self.curr_execgrp.forward_backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)
