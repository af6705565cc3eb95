"""Module: symbol + executor group + optimizer.

The port of ``mxnet_tpu/module/module.py`` (the reference's Module.bind
:201, init_optimizer :275-338), on one context or several (the executor
group's sharded or slicing mode, ``module/executor_group.py``).  Two
update routes, as there:

- with no kvstore (``kvstore=None``, or the string ``"local"`` on one
  context), or a ``device`` store with a sharded group (whose backward
  sums the gradients over its contexts: ``_kv_inline``),
  ``forward_backward`` runs the executor's ``fused_step``: forward,
  backward and a leafwise ``update_fn`` in one call, and ``update`` has
  nothing left to do (:meth:`Module._fused_step_ok`);
- with a KVStore object, the update runs on the store
  (``update_on_kvstore``): gradients are pushed (summed over the
  contexts, and over the workers of a ``dist_*`` store), the store's
  updater (the optimizer's imperative ``update``) changes its weights,
  and the weights are pulled back (``model._update_params_on_kvstore``).

``rescale_grad`` defaults to one over the global batch: the bound batch
times the workers of a ``dist_*sync`` store.  Neither route uses the
fused optimizer sweep, in either package.
"""
from __future__ import annotations

import logging
import os
import pickle

from ..base import MXNetError
from .. import context as ctx_mod
from .. import optimizer as opt_mod
from ..initializer import Uniform
from ..ndarray import zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """Parity: module/module.py:33."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param", True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._kv_inline = False
        self._updater = None
        self._exec_group = None
        self._preload_opt_states = None
        # fused-step state (fwd+bwd+update as one XLA dispatch); the
        # holder is shared across modules that borrow_optimizer (bucketing)
        # so momentum/num_update stay consistent between buckets
        self._fused_holder = None       # {"states": name->pytree, "num_update": int}
        self._fused_update_done = False

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        self._assert_binded()
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        self._assert_binded()
        return self._exec_group.label_shapes

    @property
    def output_shapes(self):
        self._assert_binded()
        shapes = {d.name: d.shape for d in self._exec_group.data_shapes}
        shapes.update({d.name: d.shape
                       for d in self._exec_group.label_shapes})
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    def _assert_binded(self):
        if not self.binded:
            raise MXNetError("call bind before using the module")

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self.binded = True

        if not for_training:
            assert not inputs_need_grad

        shared_group = None
        if shared_module is not None:
            assert shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, data_shapes,
            label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)

        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            # rebound after init: push the params back in
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None

    # ------------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        self._assert_binded()
        if initializer is None and (arg_params is None or force_init is False):
            initializer = initializer if self.params_initialized else Uniform(0.01)

        ctx = self._context[0]
        if self._arg_params is None:
            self._arg_params = {
                name: zeros(block[0].shape, ctx=ctx, dtype=block[0].dtype)
                for name, block in zip(self._exec_group.param_names,
                                       self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: zeros(block[0].shape, ctx=ctx, dtype=block[0].dtype)
                for name, block in zip(self._exec_group.aux_names,
                                       self._exec_group.aux_arrays)}

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    cache_arr = cache[name]
                    if cache_arr is not arr:
                        arr._set_data(cache_arr)
                else:
                    if not allow_missing:
                        raise RuntimeError("%s is not presented" % name)
                    if initializer is not None:
                        initializer(name, arr)
            else:
                if initializer is not None:
                    initializer(name, arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def get_params(self):
        self._assert_binded()
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._assert_binded()
        if not self.params_initialized:
            raise MXNetError("init_params before init_optimizer")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return

        from ..model import _create_kvstore
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)

        sharded = getattr(self._exec_group, "sharded", False)
        # the group may have been bound before this store started the
        # process group: its in-step sum would then miss the other
        # workers, so it is refused here as at bind
        if sharded and kvstore is not None and "dist" in kvstore.type \
                and kvstore.num_workers > 1:
            from .executor_group import multi_context_dist_error
            raise multi_context_dist_error(len(self._context),
                                           kvstore.num_workers)
        # a sharded group with a device store: the gradients are summed
        # over the contexts inside the step (the executor's backward);
        # the store keeps the initial weights and carries no per-step
        # traffic.  Unlike the JAX package's mesh, which spans every
        # process, the port's group holds this process's contexts only,
        # so a dist store (of one worker here) keeps its update route.
        self._kv_inline = bool(
            kvstore is not None and sharded and "device" in kvstore.type)
        if self._kv_inline:
            update_on_kvstore = False

        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size

        if isinstance(optimizer, str):
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._exec_group.param_names))
            else:
                n_exec = len(self._exec_group.execs)
                for k in range(n_exec):
                    idx2name.update(
                        {i * n_exec + k: n for i, n
                         in enumerate(self._exec_group.param_names)})
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt_mod.create(optimizer,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        else:
            assert isinstance(optimizer, opt_mod.Optimizer)

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kvstore:
            from ..model import _initialize_kvstore
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._exec_group.param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self._fused_holder = {"states": None,
                              "num_update": optimizer.begin_num_update}

        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self._fused_holder = shared_module._fused_holder
        self._kv_inline = getattr(shared_module, "_kv_inline", False)
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._assert_binded()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._assert_binded()
        self._exec_group.backward(out_grads=out_grads)

    def _fused_step_ok(self):
        """The whole-step fusion is valid when the update is local (no
        kvstore), single-context, grad_req=write, the optimizer uses the
        pure update_fn path, and no monitor is installed
        (``MXNET_MODULE_FUSED=0`` turns it off, and so does ``fit``'s
        numeric sentinel, which must see the gradients before the
        update: the JAX package keeps the fused step there, and its
        sentinel's skip then comes after the update has landed)."""
        if os.environ.get("MXNET_MODULE_FUSED", "1") == "0" \
                or getattr(self, "_check_before_update", False):
            return False
        return (self.optimizer_initialized
                and not self._update_on_kvstore
                and (self._kvstore is None or self._kv_inline)
                and self._exec_group is not None
                and len(self._exec_group.execs) == 1
                and self._grad_req == "write"
                and type(self._optimizer).update is opt_mod.Optimizer.update
                and self._exec_group.execs[0]._monitor_callback is None)

    def forward_backward(self, data_batch):
        """Fit-path step: when the optimizer update can be folded in (no
        kvstore, one context) the executor's ``fused_step`` runs forward,
        backward and update together and the following ``update()`` is a
        no-op; otherwise forward and backward."""
        self._assert_binded()
        if self._fused_step_ok():
            holder = self._fused_holder
            exec_ = self._exec_group.execs[0]
            if holder["states"] is None:
                holder["states"] = exec_.init_fused_states(self._optimizer)
            holder["num_update"] += 1
            self._optimizer.num_update = holder["num_update"]
            holder["states"] = self._exec_group.fused_step(
                data_batch, self._optimizer, holder["states"],
                holder["num_update"])
            self._params_dirty = True
            self._fused_update_done = True
        else:
            self._exec_group.forward_backward(data_batch)
            self._fused_update_done = False

    def update(self):
        self._assert_binded()
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer before update")
        self._params_dirty = True
        if self._fused_update_done:
            # params were updated inside the fused step dispatch
            self._fused_update_done = False
            return
        from ..model import _update_params_on_kvstore, _update_params
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            # a sharded group's gradients are already summed over its
            # contexts: through the store again they would count twice
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._exec_group.execs),
                           kvstore=None if self._kv_inline
                           else self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        self._assert_binded()
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._assert_binded()
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._assert_binded()
        self._exec_group.install_monitor(mon)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Parity: module.py:525 — prefix-symbol.json + prefix-NNNN.params."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        self.logger.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """Parity: module.py:490."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    @staticmethod
    def load_latest(prefix, **kwargs):
        """``(module, epoch)`` from the newest ``prefix-NNNN.params`` on
        disk, or ``(None, None)`` when there is none: the auto-resume
        entry for preemptible jobs.  Keyword arguments pass through to
        :meth:`load` (``load_optimizer_states`` too)."""
        from ..resilience import latest_classic_epoch
        epoch = latest_classic_epoch(prefix)
        if epoch is None:
            return None, None
        return Module.load(prefix, epoch, **kwargs), epoch

    def save_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer first")
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            from ..kvstore import _to_host
            states = getattr(self._updater, "states", {})
            payload = {k: _to_host(v) for k, v in states.items()}
            holder = self._fused_holder
            if holder and holder["states"] is not None:
                payload = {
                    "__fused__": {k: _state_numpy(v)
                                  for k, v in holder["states"].items()},
                    "__num_update__": holder["num_update"],
                }
            with open(fname, "wb") as fout:
                fout.write(pickle.dumps(payload))

    def load_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer first")
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            from ..kvstore import _from_host
            with open(fname, "rb") as fin:
                states = pickle.loads(fin.read())
            if isinstance(states, dict) and "__fused__" in states:
                device = self._exec_group.execs[0]._device
                holder = self._fused_holder
                holder["states"] = {
                    k: _state_tensors(v, device)
                    for k, v in states["__fused__"].items()}
                holder["num_update"] = states.get("__num_update__", 0)
            elif hasattr(self._updater, "states"):
                self._updater.states.update(
                    {k: _from_host(v) for k, v in states.items()})

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new shapes, keeping params (parity: module.py:446)."""
        self._assert_binded()
        if self._params_dirty:
            self._sync_params_from_devices()
        self.binded = False
        self.bind(data_shapes, label_shapes,
                  for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad,
                  force_rebind=True, grad_req=self._grad_req)
        self._exec_group.set_params(self._arg_params, self._aux_params)


def _state_numpy(state):
    if isinstance(state, (tuple, list)):
        return tuple(s.detach().cpu().numpy() for s in state)
    return state.detach().cpu().numpy()


def _state_tensors(state, device):
    import torch
    if isinstance(state, (tuple, list)):
        return tuple(torch.from_numpy(s).to(device) for s in state)
    return torch.from_numpy(state).to(device)
