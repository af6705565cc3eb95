"""BaseModule: the abstract high-level training interface.

The port of ``mxnet_tpu/module/base_module.py`` (the reference's
``python/mxnet/module/base_module.py``): ``fit`` (:273), ``score``,
``predict``/``iter_predict``, ``save_params``/``load_params``.  ``fit``
runs the JAX package's loop without its async device feed
(``prefetch``), numeric sentinel, Monitor and step telemetry, which
belong to later slices (``prefetch=True`` and ``monitor`` raise).
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError
from .. import metric as _metric
from ..callback import BatchEndParam as _BatchEndParam

__all__ = ["BaseModule"]


def _as_metric(m):
    if isinstance(m, _metric.EvalMetric):
        return m
    return _metric.create(m)


def _check_input_names(symbol, names, typename, throw):
    args = set(symbol.list_arguments() + symbol.list_auxiliary_states())
    for name in names:
        if name not in args:
            msg = "You created Module with Module(..., %s_names=%s) but " \
                  "input with name '%s' is not found in symbol.list_arguments(). " \
                  % (typename, str(list(names)), name)
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


class BaseModule(object):
    """Parity: module/base_module.py:62."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0

    # ------------------------------------------------------------------
    # properties subclasses must provide
    # ------------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    # ------------------------------------------------------------------
    # abstract operations
    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()

    # ------------------------------------------------------------------
    # concrete conveniences
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Parity: base_module.py:480 — named dict with arg:/aux: prefixes."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        from ..ndarray import save as nd_save
        nd_save(fname, save_dict)

    def load_params(self, fname):
        """Parity: base_module.py:493."""
        from ..ndarray import load as nd_load
        save_dict = nd_load(fname)
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Parity: base_module.py:178."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                _call(batch_end_callback, _BatchEndParam(
                    epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                    locals=locals()))
            actual_num_batch += 1
        if score_end_callback is not None:
            _call(score_end_callback, _BatchEndParam(
                epoch=epoch, nbatch=actual_num_batch,
                eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params first")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)]
                       for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Parity: base_module.py:225."""
        output_list = []
        for outputs, _, _ in self.iter_predict(eval_data, num_batch=num_batch,
                                               reset=reset):
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise MXNetError(
                        "Cannot merge batches: different number of outputs")
            from ..ndarray import concatenate
            output_list2 = [concatenate([out[i] for out in output_list])
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, prefetch=None):
        """Parity: base_module.py:273 — the canonical train loop: bind,
        init_params (default ``Uniform(0.01)``), init_optimizer, then per
        batch ``forward_backward``, ``update``, ``update_metric`` and the
        batch callbacks; per epoch the log lines, ``epoch_end_callback``
        with the parameters, and ``score`` on ``eval_data``."""
        if num_epoch is None:
            raise MXNetError("please specify number of epochs")
        if prefetch:
            raise MXNetError("fit(prefetch=True): the async device feed is "
                             "not ported yet")
        if monitor is not None:
            raise MXNetError("fit(monitor=...): the Monitor is not ported "
                             "yet")
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    _call(batch_end_callback, _BatchEndParam(
                        epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                        locals=locals()))

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, (toc - tic))

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                _call(epoch_end_callback, epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
            train_data.reset()


def _call(callbacks, *args):
    if isinstance(callbacks, (list, tuple)):
        for cb in callbacks:
            cb(*args)
    else:
        callbacks(*args)
