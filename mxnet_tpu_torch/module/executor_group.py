"""The executor group of a Module on one context.

The port's slice of ``mxnet_tpu/module/executor_group.py``: one
executor bound on the Module's one context (the batch is not split),
with the reference's grad_req rules (fixed parameters and inputs get
``null``; data get ``write`` with ``inputs_need_grad``), the data and
label arrays the batches are copied into, and the executor's forward,
backward, ``forward_backward`` and ``fused_step``.  Several contexts
(the batch split across GPUs, or one executor over a mesh of them) and
a shared group (bucketing) belong to later slices and raise.
"""
from __future__ import annotations

from ..base import MXNetError
from ..io import DataDesc
from ..ndarray import zeros

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


class DataParallelExecutorGroup:
    """Parity: module/executor_group.py:21, on one context."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError("Module on %d contexts: several GPUs come with "
                             "the multi-GPU training slice" % len(contexts))
        if shared_group is not None:
            raise MXNetError("a shared executor group (BucketingModule) is "
                             "not ported yet")
        _check_arguments(symbol)
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1]
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
        self.slices = [slice(0, self.batch_size)]

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

        ctx = contexts[0]
        shapes = {d.name: tuple(d.shape)
                  for d in self.data_shapes + self.label_shapes}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        if arg_shapes is None:
            raise ValueError("input_shapes are incomplete")
        args, grads = {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            args[name] = zeros(shape, ctx=ctx)
            if req.get(name, "null") != "null":
                grads[name] = zeros(shape, ctx=ctx)
        aux = [zeros(s, ctx=ctx) for s in aux_shapes]
        exec_ = symbol.bind(ctx, args, grads, req, aux)
        self.execs = [exec_]

        self.data_arrays = [[(self.slices[0], exec_.arg_dict[name])]
                            for name in self.data_names]
        self.label_arrays = [[(self.slices[0], exec_.arg_dict[name])]
                             for name in self.label_names]
        self.param_arrays = [[exec_.arg_dict[name]]
                             for name in self.param_names]
        # aligned with param_names; [None] for fixed parameters, which
        # the update helpers skip
        self.grad_arrays = [[exec_.grad_dict.get(name)]
                            for name in self.param_names] \
            if for_training else []
        self.aux_arrays = [[exec_.aux_dict[name]] for name in self.aux_names]

    # ------------------------------------------------------------------
    def load_data_batch(self, data_batch):
        """Copy the batch's data (and labels) into the bound arrays, on
        the executor's device."""
        for src, targets in zip(data_batch.data, self.data_arrays):
            targets[0][1]._set_data(src)
        if self.label_arrays and data_batch.label:
            for src, targets in zip(data_batch.label, self.label_arrays):
                targets[0][1]._set_data(src)

    def forward(self, data_batch=None, is_train=None):
        if data_batch is not None:
            self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        self.execs[0].forward(is_train=is_train)

    def forward_backward(self, data_batch):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        self.load_data_batch(data_batch)
        self.execs[0].forward_backward()

    def fused_step(self, data_batch, optimizer, states, num_update):
        """The whole training step (forward, backward, update) in one
        executor call; returns the new optimizer states."""
        self.load_data_batch(data_batch)
        return self.execs[0].fused_step(optimizer, states, num_update)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        self.execs[0].backward(out_grads)

    # ------------------------------------------------------------------
    def get_outputs(self, merge_multi_context=True):
        outputs = [[o] for o in self.execs[0].outputs]
        if merge_multi_context:
            return [parts[0] for parts in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        grads = [[self.execs[0].grad_dict[name]] for name in self.data_names]
        if merge_multi_context:
            return [parts[0] for parts in grads]
        return grads

    def get_params(self, arg_params, aux_params):
        """Copies of the executor's parameters and aux into the dicts."""
        for name, block in zip(self.param_names, self.param_arrays):
            arg_params[name] = block[0].copy()
        for name, block in zip(self.aux_names, self.aux_arrays):
            aux_params[name] = block[0].copy()

    def set_params(self, arg_params, aux_params):
        self.execs[0].copy_params_from(arg_params, aux_params)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(list(labels), self.execs[0].outputs)

    def install_monitor(self, mon):
        raise MXNetError("the Monitor is not ported yet")
