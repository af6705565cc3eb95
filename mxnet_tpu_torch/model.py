"""FeedForward, checkpoint helpers and the kvstore update helpers.

The port of ``mxnet_tpu/model.py``: ``_create_kvstore`` (the
``update_on_kvstore`` decision), ``_initialize_kvstore``,
``_update_params_on_kvstore``, ``_update_params``,
``save_checkpoint``/``load_checkpoint`` (``prefix-symbol.json`` and
``prefix-%04d.params``, the reference's 0x112 NDArray file with
``arg:``/``aux:`` keys, which the two packages read from each other),
and ``FeedForward``, the pre-Module training API, with its loop
(``_FitDriver``, ``_train_multi_device``) over one context, its numeric
sentinel (``MXTPU_SENTINEL`` or an instance: a non-finite or spiking
gradient norm skips the update), its fault-injection seam (the ``batch``
seam's ``kind=nan`` overwrites every gradient with NaN after the
backward) and its step telemetry (``observability.record_step``).
:func:`params_from_numpy` turns numpy parameters (the JAX package's,
say) into the port's tensors by name.
"""
from __future__ import annotations

import logging
import time

import numpy as _np

from .base import MXNetError
from . import io as _io
from . import kvstore as _kvs
from . import metric as _metric
from . import ndarray as nd
from . import optimizer as opt_mod
from .callback import BatchEndParam
from .context import Context, current_context, resolve
from .executor_manager import (DataParallelExecutorManager,
                               _check_arguments, _load_data as _load_data_to)
from .initializer import Uniform

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "params_from_numpy", "BatchEndParam"]


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore or None, update_on_kvstore)`` (parity: model.py:37): a
    KVStore object is used as it is and updates on the store; a string
    with one device and no ``dist`` means no store; ``local`` with
    several devices updates on the workers when every parameter is
    smaller than 16 M elements."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, _kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = _kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(_np.prod(p.shape) for p in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Seed the store with the initial weights (parity: model.py:66)."""
    for key, name in enumerate(param_names):
        kvstore.init(key, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(key, param_arrays[key], priority=-key)


def _learnable(param_arrays, grad_arrays):
    for key, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads[0] is not None:
            yield key, weights, grads


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """The update on the store: push every gradient, then pull every
    weight back (parity: model.py:76)."""
    learnable = list(_learnable(param_arrays, grad_arrays))
    for key, _weights, grads in learnable:
        kvstore.push_async(key, grads, priority=-key)
    kvstore.wait_all()
    for key, weights, _grads in learnable:
        kvstore.pull(key, weights, priority=-key)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """The update on the workers, after summing each key's gradients on
    the store when there is one (parity: model.py:91)."""
    learnable = list(_learnable(param_arrays, grad_arrays))
    if kvstore:
        for key, _weights, grads in learnable:
            kvstore.push_async(key, grads, priority=-key)
        kvstore.wait_all()
        for key, _weights, grads in learnable:
            kvstore.pull(key, grads, priority=-key)
    for key, weights, grads in learnable:
        for dev, (w, g) in enumerate(zip(weights, grads)):
            updater(key * num_device + dev, g, w)


def _batch_num_samples(batch):
    """Leading-dim sample count of a DataBatch (telemetry only)."""
    try:
        data = batch.data[0] if isinstance(batch.data, (list, tuple)) \
            else batch.data
        return int(data.shape[0])
    except Exception:
        return None


class _FitDriver:
    """Drives FeedForward's epochs (parity: model.py:115): load the
    batch, forward and backward, update through the store or the local
    updater, metrics and callbacks, recycling the iterator for the fixed
    epochs ``epoch_size`` asks for."""

    def __init__(self, manager, optimizer, kvstore, update_on_kvstore,
                 num_device, logger, monitor=None, sentinel=None):
        self.manager = manager
        self.optimizer = optimizer
        self.kvstore = kvstore
        self.update_on_kvstore = update_on_kvstore
        self.num_device = num_device
        self.logger = logger
        self.monitor = monitor
        self.updater = None if update_on_kvstore \
            else opt_mod.get_updater(optimizer)
        # numeric sentinel (MXTPU_SENTINEL / explicit instance): check the
        # global grad-norm each step and SKIP the update on NaN/Inf/spike
        from .resilience import Sentinel
        self.sentinel = Sentinel.from_env(logger=logger) \
            if sentinel is None else sentinel
        self.num_step = 0

    def _epoch_batches(self, train_data, epoch, epoch_size):
        """This epoch's batches: one pass, or exactly ``epoch_size``
        batches, resetting the iterator as it drains."""
        if epoch_size is None:
            for batch in train_data:
                yield batch
            self.logger.info("Epoch[%d] Resetting Data Iterator", epoch)
            train_data.reset()
            return
        drawn = 0
        just_reset = False
        while drawn < epoch_size:
            got_any = False
            for batch in train_data:
                got_any = True
                just_reset = False
                yield batch
                drawn += 1
                if drawn >= epoch_size:
                    return
            if not got_any and just_reset:
                # empty even immediately after a reset: genuinely no data
                raise MXNetError("training iterator produced no batches")
            self.logger.info("Epoch[%d] Resetting Data Iterator", epoch)
            train_data.reset()
            just_reset = True

    def _poison_grads(self):
        """Fault seam: overwrite every gradient with NaN (kind=nan) --
        the observable effect of a numerically-poisoned batch, planted
        deterministically after the backward pass."""
        from .resilience import poison_nan
        for per_param in self.manager.grad_arrays:
            devs = per_param if isinstance(per_param, (list, tuple)) \
                else [per_param]
            for g in devs:
                if g is not None:
                    g._set_data(poison_nan(g.data))

    def _step(self, batch):
        """One optimization step: load, forward and backward, the
        gradient update; recorded with telemetry on."""
        from . import resilience as _resilience
        from . import observability as _obs
        t0 = time.perf_counter() if _obs.events.get() is not None else None
        try:
            self._step_inner(batch, _resilience)
        finally:
            if t0 is not None:
                _obs.record_step(self.num_step, time.perf_counter() - t0,
                                 batch_size=getattr(batch, "batch_size",
                                                    None) or
                                 _batch_num_samples(batch))

    def _step_inner(self, batch, _resilience):
        m = self.manager
        self.num_step += 1
        m.load_data_batch(batch)
        if self.monitor is not None:
            self.monitor.tic()
        m.forward_backward()
        inj = _resilience.injector()
        if inj is not None:
            spec = inj.match("batch", step=self.num_step)
            if spec is not None and spec.kind == "nan":
                self._poison_grads()
        if self.sentinel is not None:
            from .resilience import sentinel as _sentinel_mod
            gnorm = _sentinel_mod.Sentinel.grad_norm(m.grad_arrays)
            verdict = self.sentinel.check(self.num_step, grad_norm=gnorm)
            if verdict != _sentinel_mod.OK:
                # skip the update; the parameters stay at the last good
                # state and training goes on with the next batch
                if self.monitor is not None:
                    self.monitor.toc_print()
                return
        if self.update_on_kvstore:
            _update_params_on_kvstore(m.param_arrays, m.grad_arrays,
                                      self.kvstore)
        else:
            _update_params(m.param_arrays, m.grad_arrays, self.updater,
                           self.num_device, kvstore=self.kvstore)
        if self.monitor is not None:
            self.monitor.toc_print()

    def train_epoch(self, epoch, train_data, epoch_size, metric,
                    batch_end_callback):
        from .observability.spans import timed_iter
        metric.reset()
        tic = time.time()
        batches = timed_iter(
            self._epoch_batches(train_data, epoch, epoch_size),
            name="data_wait", step_from=lambda: self.num_step)
        for nbatch, batch in enumerate(batches, 1):
            self._step(batch)
            self.manager.update_metric(metric, batch.label)
            if batch_end_callback is not None:
                _multiple_callbacks(batch_end_callback, BatchEndParam(
                    epoch=epoch, nbatch=nbatch, eval_metric=metric,
                    locals=locals()))
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                         time.time() - tic)

    def evaluate(self, epoch, eval_data, metric, batch_end_callback,
                 end_callback):
        metric.reset()
        eval_data.reset()
        count = 0
        for count, batch in enumerate(eval_data, 1):
            self.manager.load_data_batch(batch)
            self.manager.forward(is_train=False)
            self.manager.update_metric(metric, batch.label)
            if batch_end_callback is not None:
                _multiple_callbacks(batch_end_callback, BatchEndParam(
                    epoch=epoch, nbatch=count - 1, eval_metric=metric,
                    locals=locals()))
        if end_callback is not None:
            _multiple_callbacks(end_callback, BatchEndParam(
                epoch=epoch, nbatch=count, eval_metric=metric,
                locals=locals()))
        eval_data.reset()


def _train_multi_device(symbol, ctx, arg_names, param_names, aux_names,
                        arg_params, aux_params, begin_epoch, end_epoch,
                        epoch_size, optimizer, kvstore, update_on_kvstore,
                        train_data, eval_data=None, eval_metric=None,
                        epoch_end_callback=None, batch_end_callback=None,
                        logger=None, work_load_list=None, monitor=None,
                        eval_end_callback=None, eval_batch_end_callback=None,
                        sym_gen=None):
    """FeedForward's training entry (parity: model.py:115)."""
    logger = logger or logging
    manager = DataParallelExecutorManager(
        symbol=symbol, sym_gen=sym_gen, ctx=ctx, train_data=train_data,
        param_names=param_names, arg_names=arg_names, aux_names=aux_names,
        work_load_list=work_load_list, logger=logger)
    if monitor:
        manager.install_monitor(monitor)
    manager.set_params(arg_params, aux_params)

    if kvstore:
        _initialize_kvstore(kvstore=kvstore,
                            param_arrays=manager.param_arrays,
                            arg_params=arg_params,
                            param_names=manager.param_names,
                            update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(optimizer)

    loop = _FitDriver(manager, optimizer, kvstore, update_on_kvstore,
                      num_device=len(ctx), logger=logger, monitor=monitor)
    train_data.reset()
    for epoch in range(begin_epoch, end_epoch):
        loop.train_epoch(epoch, train_data, epoch_size, eval_metric,
                           batch_end_callback)
        last = epoch + 1 == end_epoch
        if epoch_end_callback or last:
            manager.copy_to(arg_params, aux_params)
        if epoch_end_callback is not None:
            _multiple_callbacks(epoch_end_callback, epoch, symbol,
                                arg_params, aux_params)
        if eval_data:
            loop.evaluate(epoch, eval_data, eval_metric,
                            eval_batch_end_callback, eval_end_callback)


def _multiple_callbacks(callbacks, *args):
    if isinstance(callbacks, (list, tuple)):
        for cb in callbacks:
            cb(*args)
    else:
        callbacks(*args)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """``prefix-symbol.json`` and ``prefix-%04d.params`` (parity:
    model.py:308)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` (parity: model.py:338); the
    arrays land on the current context."""
    from . import symbol as sym_mod
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    stored = nd.load("%s-%04d.params" % (prefix, epoch))
    groups = {"arg": {}, "aux": {}}
    for key, value in stored.items():
        kind, _, name = key.partition(":")
        if kind in groups:
            groups[kind][name] = value
    return symbol, groups["arg"], groups["aux"]


def _host(value):
    if hasattr(value, "asnumpy") and not isinstance(value, nd.NDArray):
        return value.asnumpy()
    return value


def params_from_numpy(arg_params, aux_params=None, ctx=None, mesh=None):
    """``(args, aux)``: ``{name: tensor}`` dicts on ``ctx``'s device
    (None: the current context) from ``{name: array}`` dicts of numpy
    arrays, NDArrays of either package or tensors, keeping each dtype
    (float64 becomes float32).  An ``arg:``/``aux:`` prefix, as a saved
    checkpoint's keys carry, is stripped.  The counterpart of
    ``models.transformer.params_from_numpy`` for any graph: how the JAX
    package's parameters come into the port.  With ``mesh`` (a
    ``parallel.make_mesh`` of several devices) each value is placed on
    it replicated (a ``parallel.ShardedArray``, as
    ``ShardedTrainer.init_params`` keeps parameters and aux states), so
    a data-parallel run starts from the same weights as the JAX one."""
    if mesh is not None and mesh.size > 1:
        from .parallel.sharding import P, place

        def convert(d):
            out = {}
            for name, value in (d or {}).items():
                if name.startswith(("arg:", "aux:")):
                    name = name[4:]
                value = _host(value)
                out[name] = place(value, mesh,
                                  P(*([None] * len(value.shape))))
            return out
        return convert(arg_params), convert(aux_params)
    device = resolve(ctx if mesh is None else mesh.contexts[0])

    def convert(d):
        out = {}
        for name, value in (d or {}).items():
            if name.startswith(("arg:", "aux:")):
                name = name[4:]
            out[name] = nd.array(_host(value), ctx=device).data
        return out
    return convert(arg_params), convert(aux_params)


class FeedForward(object):
    """Parity: model.py:383, the classic high-level model API, on one
    context: ``ctx=None`` means ``[current_context()]`` (``gpu(0)``
    outside a ``with`` scope).  Bucketing, as in the JAX package: set
    ``sym_gen`` (bucket key -> Symbol) after construction; ``fit`` then
    trains the default bucket's symbol and binds each other bucket's on
    its first batch, over the same parameter arrays."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.sym_gen = None
        if ctx is None:
            ctx = [current_context()]
        self.ctx = [ctx] if isinstance(ctx, Context) else ctx
        self.begin_epoch, self.num_epoch = begin_epoch, num_epoch
        self.epoch_size = epoch_size
        self.optimizer, self.kwargs = optimizer, kwargs.copy()
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params, self.aux_params = arg_params, aux_params
        self.allow_extra_params = allow_extra_params
        self.argument_checked = False
        self._pred_exec = None
        if self.sym_gen is None:
            self._check_arguments()

    def _check_arguments(self):
        if self.argument_checked:
            return
        assert self.symbol is not None
        self.argument_checked = True
        _check_arguments(self.symbol)
        if not self.allow_extra_params:
            return
        # drop params the current symbol doesn't know about
        for attr, names in (("arg_params", self.symbol.list_arguments()),
                            ("aux_params",
                             self.symbol.list_auxiliary_states())):
            cache = getattr(self, attr)
            if cache:
                keep = set(names)
                setattr(self, attr,
                        {k: v for k, v in cache.items() if k in keep})

    @staticmethod
    def _is_data_arg(name):
        return name.endswith("data") or name.endswith("label")

    def _init_params(self, inputs, overwrite=False):
        """Initialize weights given input descs (parity: model.py:482),
        on the model's context."""
        inputs = [x if isinstance(x, _io.DataDesc) else _io.DataDesc(*x)
                  for x in inputs]
        input_shapes = {item.name: item.shape for item in inputs}
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise ValueError("Input shape is incomplete")
        arg_names = self.symbol.list_arguments()
        input_names = input_shapes.keys()
        param_names = [key for key in arg_names if key not in input_names]
        aux_names = self.symbol.list_auxiliary_states()

        def _materialize(names, shapes, keep, cache):
            """Fresh arrays for ``names``; seed from ``cache`` (unless
            overwriting) else run the initializer."""
            out = {}
            for name, shape in zip(names, shapes):
                if name not in keep:
                    continue
                arr = nd.zeros(shape, ctx=self.ctx[0])
                if cache and name in cache and not overwrite:
                    arr[:] = cache[name][:]
                else:
                    self.initializer(name, arr)
                out[name] = arr
            return out

        self.arg_params = _materialize(arg_names, arg_shapes,
                                       set(param_names), self.arg_params)
        self.aux_params = _materialize(aux_names, aux_shapes,
                                       set(aux_names), self.aux_params)
        return (arg_names, list(param_names), aux_names)

    def __getstate__(self):
        this = self.__dict__.copy()
        this["_pred_exec"] = None
        return this

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _init_predictor(self, input_shapes, type_dict=None):
        shapes = {name: self.arg_params[name].shape
                  for name in self.arg_params}
        shapes.update(dict(input_shapes))
        if self._pred_exec is not None:
            arg_shapes, _, _ = self.symbol.infer_shape(**shapes)
            assert arg_shapes is not None, "Incomplete input shapes"
            pred_shapes = [x.shape for x in self._pred_exec.arg_arrays]
            if arg_shapes == pred_shapes:
                return
        pred_exec = self.symbol.simple_bind(self.ctx[0], grad_req="null",
                                            type_dict=type_dict,
                                            **dict(input_shapes))
        pred_exec.copy_params_from(self.arg_params, self.aux_params)
        self._pred_exec = pred_exec

    def _init_iter(self, X, y, is_train):
        """Accept a DataIter or raw (X, y) arrays; wrap arrays in an
        NDArrayIter sized by numpy_batch_size."""
        if isinstance(X, _io.DataIter):
            return X
        if not isinstance(X, (_np.ndarray, nd.NDArray)):
            raise TypeError("X must be DataIter, NDArray or numpy.ndarray")
        if y is None:
            if is_train:
                raise ValueError("y is required when X is an array")
            y = _np.zeros(X.shape[0])
        n = X.shape[0]
        if is_train:
            return _io.NDArrayIter(X, y, min(n // 2, self.numpy_batch_size),
                                   shuffle=True,
                                   last_batch_handle="roll_over")
        return _io.NDArrayIter(X, y, min(n, self.numpy_batch_size))

    def _init_eval_iter(self, eval_data):
        """Accept None, a DataIter, or an (X, y) pair (lists ok)."""
        if eval_data is None or isinstance(eval_data, _io.DataIter):
            return eval_data
        if not (isinstance(eval_data, (tuple, list))
                and len(eval_data) == 2):
            raise TypeError(
                "Eval data must be DataIter or NDArray/numpy pair")
        ex, ey = eval_data
        if ex is None:
            raise ValueError("Eval data is NONE")
        if ey is None and isinstance(ex, _io.DataIter):
            return ex
        as_arr = lambda v: _np.array(v) if isinstance(v, list) else v  # noqa: E731
        return self._init_iter(as_arr(ex), as_arr(ey), is_train=True)

    def _pred_batches(self, X, num_batch, reset):
        """Bind the predictor and yield (batch, outputs, valid_rows)."""
        if reset:
            X.reset()
        names = [d[0] for d in X.provide_data]
        self._init_predictor(X.provide_data,
                             {n: "float32" for n in names})
        feeds = [self._pred_exec.arg_dict[n] for n in names]
        for i, batch in enumerate(X):
            if num_batch is not None and i >= num_batch:
                return
            _load_data_to(batch, feeds)
            self._pred_exec.forward(is_train=False)
            yield batch, self._pred_exec.outputs, \
                X.batch_size - (batch.pad or 0)

    @staticmethod
    def _stack(columns):
        merged = [_np.concatenate(col) for col in columns]
        return merged[0] if len(merged) == 1 else merged

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Parity: model.py:602: numpy outputs of every batch."""
        X = self._init_iter(X, None, is_train=False)
        collected = {"out": None, "data": None, "label": None}
        for batch, outs, valid in self._pred_batches(X, num_batch, reset):
            rows = {"out": outs}
            if return_data:
                rows["data"], rows["label"] = batch.data, batch.label
            for key, arrs in rows.items():
                if collected[key] is None:
                    collected[key] = [[] for _ in arrs]
                for col, arr in zip(collected[key], arrs):
                    col.append(arr[0:valid].asnumpy())
        outputs = self._stack(collected["out"])
        if return_data:
            return (outputs, self._stack(collected["data"]),
                    self._stack(collected["label"]))
        return outputs

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """Parity: model.py:677."""
        X = self._init_iter(X, None, is_train=False)
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        for i, (batch, outs, _valid) in enumerate(
                self._pred_batches(X, num_batch, reset)):
            eval_metric.update(batch.label, outs)
            if batch_end_callback is not None:
                _multiple_callbacks(batch_end_callback, BatchEndParam(
                    epoch=0, nbatch=i, eval_metric=eval_metric,
                    locals=locals()))
        return eval_metric.get()[1]

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            checkpoint_prefix=None, resume=None, prefetch=None):
        """Parity: model.py:689, with the JAX package's extras:
        ``prefetch`` (True/False forces the async feed, a
        ``DevicePrefetcher``, on or off; None defers to
        ``MXTPU_PREFETCH``), ``checkpoint_prefix`` (a
        ``callback.do_checkpoint`` at every epoch end) and ``resume``
        (``"auto"``: the newest ``checkpoint_prefix-NNNN.params``, or an
        epoch number)."""
        if resume is not None:
            if not checkpoint_prefix:
                raise MXNetError(
                    "fit(resume=%r) needs checkpoint_prefix" % (resume,))
            if resume == "auto":
                from .resilience import latest_classic_epoch
                epoch = latest_classic_epoch(checkpoint_prefix)
            else:
                epoch = int(resume)
            if epoch is not None:
                with self.ctx[0]:
                    _, arg_params, aux_params = load_checkpoint(
                        checkpoint_prefix, epoch)
                self.arg_params = arg_params
                self.aux_params = aux_params
                self.begin_epoch = epoch
                (logger or logging).info(
                    "fit: resuming from %s-%04d.params (epoch %d)",
                    checkpoint_prefix, epoch, epoch)
        if checkpoint_prefix:
            from .callback import do_checkpoint
            ckpt_cb = do_checkpoint(checkpoint_prefix)
            if epoch_end_callback is None:
                epoch_end_callback = ckpt_cb
            elif isinstance(epoch_end_callback, (list, tuple)):
                epoch_end_callback = list(epoch_end_callback) + [ckpt_cb]
            else:
                epoch_end_callback = [epoch_end_callback, ckpt_cb]
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)

        from .parallel.overlap import DevicePrefetcher, prefetch_enabled
        own_prefetch = None
        if prefetch_enabled(prefetch):
            data = own_prefetch = DevicePrefetcher(data, name="ff-feed")

        if self.sym_gen:
            self.symbol = self.sym_gen(data.default_bucket_key)
            self._check_arguments()
        self.kwargs["sym"] = self.symbol

        arg_names, param_names, aux_names = self._init_params(
            data.provide_data + data.provide_label)

        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self.ctx), self.arg_params)
        n_dev = 1 if update_on_kvstore else len(self.ctx)
        self.kwargs["param_idx2name"] = {
            i * n_dev + k: n
            for i, n in enumerate(param_names) for k in range(n_dev)}

        if isinstance(self.optimizer, str):
            batch_size = data.batch_size
            if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
                batch_size *= kvstore.num_workers
            optimizer = opt_mod.create(self.optimizer,
                                       rescale_grad=(1.0 / batch_size),
                                       **self.kwargs)
        elif isinstance(self.optimizer, opt_mod.Optimizer):
            optimizer = self.optimizer
        else:
            raise TypeError("optimizer must be str or Optimizer")

        try:
            _train_multi_device(
                self.symbol, self.ctx, arg_names, param_names, aux_names,
                self.arg_params, self.aux_params,
                begin_epoch=self.begin_epoch, end_epoch=self.num_epoch,
                epoch_size=self.epoch_size, optimizer=optimizer,
                train_data=data, eval_data=eval_data,
                eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                update_on_kvstore=update_on_kvstore, logger=logger,
                work_load_list=work_load_list, monitor=monitor,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                sym_gen=self.sym_gen)
        finally:
            if own_prefetch is not None:
                own_prefetch.close()
        return self

    def save(self, prefix, epoch=None):
        """Parity: model.py:780."""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """Parity: model.py:813; the parameters land on ``ctx``."""
        first = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        with first or current_context():
            symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Parity: model.py:841: one call that trains and returns the
        model."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
