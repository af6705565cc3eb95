"""Checkpoint helpers and the kvstore update helpers of the Module path.

The port's slice of ``mxnet_tpu/model.py``: ``_create_kvstore`` (the
``update_on_kvstore`` decision), ``_initialize_kvstore``,
``_update_params_on_kvstore``, ``_update_params``, and
``save_checkpoint``/``load_checkpoint``: ``prefix-symbol.json`` and
``prefix-%04d.params`` (the reference's 0x112 NDArray file with
``arg:``/``aux:`` keys), which the two packages read from each other.
:func:`params_from_numpy` turns numpy parameters (the JAX package's,
say) into the port's tensors by name.  ``FeedForward`` belongs to a
later slice.
"""
from __future__ import annotations

import logging

import numpy as _np

from . import kvstore as _kvs
from . import ndarray as nd
from .callback import BatchEndParam   # noqa: F401  (re-exported, as there)
from .context import resolve

__all__ = ["save_checkpoint", "load_checkpoint", "params_from_numpy",
           "BatchEndParam"]


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


def params_from_numpy(arg_params, aux_params=None, ctx=None):
    """``(args, aux)``: ``{name: tensor}`` dicts on ``ctx``'s device
    (None: the current context) from ``{name: array}`` dicts of numpy
    arrays, NDArrays of either package or tensors, keeping each dtype
    (float64 becomes float32).  An ``arg:``/``aux:`` prefix, as a saved
    checkpoint's keys carry, is stripped.  The counterpart of
    ``models.transformer.params_from_numpy`` for any graph."""
    device = resolve(ctx)

    def convert(d):
        out = {}
        for name, value in (d or {}).items():
            if name.startswith(("arg:", "aux:")):
                name = name[4:]
            out[name] = nd.array(_host(value), ctx=device).data
        return out
    return convert(arg_params), convert(aux_params)
