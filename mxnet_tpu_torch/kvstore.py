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

The heartbeat half of the JAX package's store is here whole: the
stamping thread (:func:`_start_heartbeat`, ``mxtpu_hb/<rank>`` keys),
the liveness scan (:func:`scan_dead_ranks`) that fleet routers and
:meth:`KVStore.dead_nodes` share, over any coordination client with the
``resilience.netkv.CoordKV`` surface.  There is no coordination service
in one process (:func:`_dist_client` is None), so unless a fleet
replica hands :func:`_start_heartbeat` its KV client nothing stamps, and
``dead_nodes`` is ``[]``.
"""
from __future__ import annotations

import pickle

import numpy as _np

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create", "scan_dead_ranks"]

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
        self._created = _now()
        self._dead_hold = {"since": None, "last": []}

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

    # -- fault surface (kvstore.h:242 get_num_dead_node parity) ----------
    def dead_nodes(self, node_id=None, timeout=None):
        """Sorted ranks whose liveness heartbeat is stale or missing, as
        :func:`scan_dead_ranks` reads them from the coordination client
        (:func:`_dist_client`); ``[]`` without one.  ``timeout``
        defaults to 5 heartbeat intervals.  An unreachable KV holds the
        last verdict for up to ``timeout`` seconds, then re-raises the
        structured ``KVUnreachable``: a blip must not fabricate deaths."""
        if timeout is None:
            timeout = 5 * _HB_INTERVAL
        client = _dist_client()
        if client is None:
            return []
        from .resilience.netkv import KVUnreachable
        ranks = [node_id] if node_id is not None \
            else range(self.num_workers)
        try:
            dead = scan_dead_ranks(client, ranks, self._created, timeout)
        except KVUnreachable:
            since = self._dead_hold["since"]
            if since is None:
                since = _now()
                self._dead_hold["since"] = since
            if _now() - since <= timeout:
                held = self._dead_hold["last"]
                return [r for r in held if r == node_id] \
                    if node_id is not None else list(held)
            raise                   # outage outlived the grace window
        self._dead_hold["since"] = None
        if node_id is None:
            self._dead_hold["last"] = list(dead)
        return dead

    def num_dead_nodes(self, node_id=None, timeout=None):
        """Count of stale workers (parity: ``get_num_dead_node``)."""
        return len(self.dead_nodes(node_id=node_id, timeout=timeout))

    get_num_dead_node = num_dead_nodes

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


_HB_PREFIX = "mxtpu_hb/"
_HB_INTERVAL = 2.0


def scan_dead_ranks(client, ranks, created, timeout, prefix=_HB_PREFIX):
    """Sorted members of ``ranks`` whose ``<prefix><rank>`` heartbeat
    stamp is stale or missing -- the liveness scan shared by
    :meth:`KVStore.dead_nodes` and the fleet router.  ``client`` is
    anything with ``key_value_dir_get``; ``created`` is the scanner's own
    start time (a missing stamp counts as dead only once the peer has had
    ``timeout`` seconds since then to write one: the startup grace).

    An unreachable KV raises a structured
    :class:`~mxnet_tpu_torch.resilience.netkv.KVUnreachable`; it NEVER
    reports ranks dead."""
    from .resilience.netkv import KVUnreachable
    try:
        entries = dict(client.key_value_dir_get(prefix))
    except KVUnreachable:
        raise
    except Exception as exc:        # any backend's transport failure
        from . import observability as _obs
        _obs.emit("fault", fault="kv_unreachable", op="dir",
                  backend=type(client).__name__, error=repr(exc))
        raise KVUnreachable(
            "heartbeat scan: kv backend %s unreachable: %r"
            % (type(client).__name__, exc), op="dir")
    now = _now()
    dead = []
    for r in ranks:
        stamp = entries.get("%s%d" % (prefix, r))
        if stamp is None:
            if now - created > timeout:
                dead.append(r)
        elif now - float(stamp) > timeout:
            dead.append(r)
    return sorted(dead)


def _now():
    """Wall clock behind the liveness math -- module-level so tests can
    monkeypatch it to step time deterministically."""
    import time as _time
    return _time.time()


def _dist_client():
    """The process's coordination client: None in the port until the
    multi-GPU slice brings a process group with a KV."""
    return None


_HB_STATE = {"thread": None, "stop": None}


def _start_heartbeat(client=None, rank=None):
    """Background liveness stamping (ps-lite heartbeat analog): writes
    ``mxtpu_hb/<rank>`` = ``repr(time.time())`` every
    :data:`_HB_INTERVAL` seconds.  Idempotent per process; the thread is
    a daemon AND is stopped via atexit.  Fleet replicas inject their KV
    client and replica index; with neither, nothing stamps."""
    t = _HB_STATE["thread"]
    if t is not None and t.is_alive():
        return
    if client is None:
        client = _dist_client()
    if client is None:
        return
    import atexit
    import threading
    import time as _time
    if rank is None:
        from .observability.events import rank as _rank
        rank = _rank()
    key = "%s%d" % (_HB_PREFIX, int(rank))
    stop = threading.Event()

    def _beat():
        while not stop.is_set():
            try:
                client.key_value_set(key, repr(_time.time()),
                                     allow_overwrite=True)
            except Exception:
                # KV blip (partition, flap, coordinator restart): keep
                # trying -- a thread that exits here never stamps again,
                # so a healed partition would read as this rank dead
                pass
            stop.wait(_HB_INTERVAL)

    t = threading.Thread(target=_beat, daemon=True,
                         name="mxtpu-kv-heartbeat")
    t.start()
    if _HB_STATE["thread"] is None:          # register atexit hook once
        atexit.register(_stop_heartbeat)
    _HB_STATE["thread"] = t
    _HB_STATE["stop"] = stop


def _stop_heartbeat():
    """Signal the heartbeat thread to exit and wait (bounded) for it."""
    t, stop = _HB_STATE["thread"], _HB_STATE["stop"]
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(2 * _HB_INTERVAL)
    _HB_STATE["thread"] = None
    _HB_STATE["stop"] = None


def create(name="local"):
    """String factory (parity: kvstore.cc:17-45, kvstore.py create)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    base = name.lower()
    if base not in _VALID_TYPES and not any(
            t in base for t in ("local", "device", "dist")):
        raise MXNetError("unknown KVStore type %r" % name)
    return KVStore(base)
