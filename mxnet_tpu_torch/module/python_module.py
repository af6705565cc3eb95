"""PythonModule: user-defined computation inside the Module chain.

The port of ``mxnet_tpu/module/python_module.py`` (the reference's
``python/mxnet/module/python_module.py``): a module whose forward and
backward are plain Python, for losses and glue layers between modules
in a SequentialModule.  ``PythonLossModule``'s gradient, when its
``grad_func`` returns no NDArray, lands on the current context.
"""
from __future__ import annotations

import logging

from ..ndarray import NDArray, array as nd_array
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Parity: python_module.py:15."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        if isinstance(data_names, tuple):
            data_names = list(data_names)
        if isinstance(label_names, tuple):
            label_names = list(label_names)
        self._data_names = data_names
        self._label_names = label_names if label_names is not None else []
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # ------------------------------------------------------------------
    def get_params(self):
        return (dict(), dict())

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is None:
            pass
        else:
            raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert grad_req == "write"
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """Parity: python_module.py:192 — a pluggable python loss."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(list(data_names), list(label_names),
                         [name + "_output"], logger=logger)
        self._name = name
        assert len(data_names) == 1
        assert len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "For a loss module, out_grads is not supposed to be specified"
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, NDArray):
                grad = nd_array(grad)
            self._scores_grad = grad
        else:
            raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
