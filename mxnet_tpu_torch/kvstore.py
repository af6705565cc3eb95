"""KVStore: parameter synchronization within one process.

The port's slice of ``mxnet_tpu/kvstore.py``: the ``local`` and
``device`` stores of one process (``create("local"|"device")``), with
``init``, ``push`` (copies of a key summed, then the updater run on the
sum and the stored weight, or the sum stored), ``pull``, ``push_async``
and ``wait_all`` (the update runs inline: one process has no peer to
wait for), ``set_updater``/``set_optimizer`` (the optimizer goes through
a pickle round trip, as the reference ships it to its servers),
``save_optimizer_states``/``load_optimizer_states``, ``rank`` 0,
``num_workers`` 1 and ``barrier``.  The ``dist_*`` stores (several
workers, collectives between GPUs) belong to the multi-GPU slice and
raise.
"""
from __future__ import annotations

import pickle

import numpy as _np

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_VALID_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device",
                "dist_sync", "dist_async", "dist_sync_device",
                "dist_async_device")


def _key_list(key):
    if isinstance(key, (int, str)):
        return [key], True
    return list(key), False


def _group_values(keys, values, single):
    """One list of NDArrays per key (kvstore_local.h GroupKVPairs)."""
    if single:
        if isinstance(values, NDArray):
            return [[values]]
        return [list(values)]
    if len(values) == len(keys) and all(isinstance(v, NDArray)
                                        for v in values):
        return [[v] for v in values]
    if len(values) % len(keys) == 0 and all(isinstance(v, NDArray)
                                            for v in values):
        per = len(values) // len(keys)
        return [values[i * per:(i + 1) * per] for i in range(len(keys))]
    out = [[v] if isinstance(v, NDArray) else list(v) for v in values]
    if len(out) != len(keys):
        raise MXNetError("kvstore: %d keys, %d value groups"
                         % (len(keys), len(out)))
    return out


class KVStore:
    """Key-value store of one process (parity: python/mxnet/kvstore.py).

    ``push`` sums the copies pushed for a key, then runs the updater on
    (summed gradient, stored weight), or stores the sum when no updater
    is set; ``pull`` copies the stored value into every out array."""

    def __init__(self, kvtype="local"):
        if kvtype.startswith("dist"):
            raise MXNetError(
                "kvstore %r: distributed stores are not ported yet; they "
                "come with the multi-GPU training slice" % kvtype)
        self.type = kvtype
        self._store = {}
        self._updater = None

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        keys, single = _key_list(key)
        for k, vals in zip(keys, _group_values(keys, value, single)):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = NDArray(vals[0].data.clone(),
                                     ctx=vals[0].context)

    def push(self, key, value, priority=0):
        keys, single = _key_list(key)
        for k, vals in zip(keys, _group_values(keys, value, single)):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            merged = vals[0].data
            for v in vals[1:]:
                merged = merged + v.data.to(merged.device)
            if self._updater is not None:
                self._updater(k, NDArray(merged), self._store[k])
            else:
                self._store[k]._set_data(merged)

    #: one process: the push completes before it returns
    push_async = push

    def wait_all(self, timeout=None):
        """Every push has completed (they run inline)."""

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("kvstore.pull needs out arrays")
        keys, single = _key_list(key)
        for k, outs in zip(keys, _group_values(keys, out, single)):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            for o in outs:
                o._set_data(self._store[k].data)

    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` as the store's updater (parity: kvstore.py:231;
        the copy through pickle keeps the reference's contract that the
        optimizer must be serializable for its server)."""
        from .optimizer import get_updater
        self.set_updater(get_updater(pickle.loads(pickle.dumps(optimizer))))

    def barrier(self):
        """One worker: nothing to wait for."""

    _barrier = barrier

    def _send_command_to_servers(self, head, body):
        """No servers: commands are accepted and ignored."""

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("kvstore: no updater to save states of")
        opt = getattr(self._updater, "optimizer", None)
        states = getattr(self._updater, "states", None) or {}
        with open(fname, "wb") as fout:
            fout.write(pickle.dumps((opt, {k: _to_host(v)
                                           for k, v in states.items()})))

    def load_optimizer_states(self, fname):
        from .optimizer import get_updater
        with open(fname, "rb") as fin:
            opt, states = pickle.loads(fin.read())
        updater = get_updater(opt)
        updater.states.update({k: _from_host(v) for k, v in states.items()})
        self.set_updater(updater)


def _to_host(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(s.asnumpy() for s in state)
    return state.asnumpy()


def _from_host(state):
    from .ndarray import array
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(array(_np.asarray(s)) for s in state)
    return array(_np.asarray(state))


def create(name="local"):
    """String factory (parity: kvstore.cc:17-45, kvstore.py create)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    base = name.lower()
    if base not in _VALID_TYPES and not any(
            t in base for t in ("local", "device", "dist")):
        raise MXNetError("unknown KVStore type %r" % name)
    return KVStore(base)
