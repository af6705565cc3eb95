"""SequentialModule: chain modules, feeding outputs to the next's inputs.

The port of ``mxnet_tpu/module/sequential_module.py`` (role parity:
python/mxnet/module/sequential_module.py): a container where stage k's
outputs become stage k+1's data, and the input gradients of stage k+1
stage k's head gradients.  Per-stage metadata:
``take_labels`` marks the stages that consume the label batch (and
update metrics); ``auto_wiring`` renames incoming shapes to the stage's
own data names.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """Parity: sequential_module.py:14."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    _KNOWN_METAS = frozenset({META_TAKE_LABELS, META_AUTO_WIRING})

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._chain = []        # [(module, meta dict), ...]
        self._label_shapes = None
        self._data_shapes = None

    # -- chain construction -----------------------------------------------
    def add(self, module, **meta):
        """Append a stage.  meta: take_labels=bool, auto_wiring=bool."""
        unknown = set(meta) - self._KNOWN_METAS
        assert not unknown, 'Unknown meta "%s", a typo?' % unknown.pop()
        self._chain.append((module, dict(meta)))
        # a structural change invalidates everything downstream
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _stages(self):
        return [m for m, _ in self._chain]

    @staticmethod
    def _takes_labels(meta):
        return bool(meta.get(SequentialModule.META_TAKE_LABELS, False))

    # -- shape/name surface -----------------------------------------------
    @property
    def data_names(self):
        return self._chain[0][0].data_names if self._chain else []

    @property
    def output_names(self):
        return self._chain[-1][0].output_names if self._chain else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._chain[0][0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._chain[-1][0].output_shapes

    # -- parameters --------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for stage in self._stages():
            a, x = stage.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for stage in self._stages():
            stage.init_params(initializer=initializer,
                              arg_params=arg_params,
                              aux_params=aux_params,
                              allow_missing=allow_missing,
                              force_init=force_init)

        # a name may belong to exactly one stage, per namespace (args
        # and aux states are distinct namespaces)
        arg_owners, aux_owners = {}, {}
        for idx, stage in enumerate(self._stages()):
            a, x = stage.get_params()
            for names, owners in ((a, arg_owners), (x, aux_owners)):
                for name in names:
                    assert name not in owners, (
                        'Duplicated parameter names: name "%s" in layer '
                        "%d (%s) is already used in layer %d (%s)"
                        % (name, idx, type(stage), owners[name][0],
                           type(owners[name][1])))
                    owners[name] = (idx, stage)
        self.params_initialized = True

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._chain

        self.binded = True
        self._label_shapes = label_shapes

        flowing = data_shapes
        label_seen = False
        for idx, (stage, meta) in enumerate(self._chain):
            wants_labels = self._takes_labels(meta)
            label_seen = label_seen or wants_labels
            if meta.get(self.META_AUTO_WIRING, False):
                names = stage.data_names
                assert len(names) == len(flowing)
                flowing = [(name, shape)
                           for name, (_, shape) in zip(names, flowing)]
            stage.bind(
                data_shapes=flowing,
                label_shapes=label_shapes if wants_labels else None,
                for_training=for_training,
                # every stage after the first needs upstream gradients
                inputs_need_grad=bool(for_training
                                      and (inputs_need_grad or idx > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            flowing = stage.output_shapes

        if not label_seen:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for stage in self._stages():
            stage.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                 optimizer_params=optimizer_params,
                                 force_init=force_init)
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch
        batch = data_batch
        last = len(self._chain) - 1
        for idx, (stage, _meta) in enumerate(self._chain):
            stage.forward(batch, is_train=is_train)
            if idx == last:
                break
            batch = DataBatch(data=stage.get_outputs(),
                              label=data_batch.label,
                              pad=getattr(data_batch, "pad", None))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for idx in range(len(self._chain) - 1, -1, -1):
            stage = self._chain[idx][0]
            stage.backward(out_grads=out_grads)
            if idx == 0:
                break
            out_grads = stage.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for stage in self._stages():
            stage.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._chain[-1][0].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._chain[0][0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for stage, meta in self._chain:
            if self._takes_labels(meta):
                stage.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for stage in self._stages():
            stage.install_monitor(mon)
