"""KVStore: parameter synchronization.

The port of ``mxnet_tpu/kvstore.py``: the reference's string factory
(``create``) and Python API (``init``, ``push``, ``pull``,
``push_async``/``wait_all``, ``set_updater``/``set_optimizer``,
``rank``, ``num_workers``, ``barrier``, the optimizer states' files).

- ``local`` and ``device``: one process.  ``push`` sums the copies
  pushed for a key (one a context) on the first copy's device, in
  context order (the reference's ``comm.h`` reduces on a GPU for
  ``device``), then runs the updater on (sum, stored weight) or stores
  the sum; ``pull`` copies the stored value into every out array.
- ``dist_sync``, ``dist_device_sync``, ``dist_async`` (and
  ``dist_async_device``): several worker processes joined by
  ``torch.distributed`` (:func:`_maybe_init_distributed`, from
  ``tools/launch.py``'s env: ``MXTPU_COORDINATOR``,
  ``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_RANK``).  After the local sum, a
  push sums over the workers (:meth:`KVStore._allreduce`: NCCL for CUDA
  tensors, gloo for CPU tensors), so every worker's updater sees the
  same gradient and keeps the same weights.  ``dist_async`` runs with
  ``dist_sync``'s semantics, as in the JAX package: a collective has no
  asynchronous server to update.  With no coordinator in the env a dist
  store is one worker (rank 0 of 1).  :meth:`KVStore.push_async` merges
  inline and sums over the workers bucket by bucket (``MXTPU_BUCKET_MB``)
  on one background thread, in push order on every worker.

The JAX package's store also carries a sum through its coordination
service's key-value store, for backends that cannot build cross-process
programs; gloo can, so the port has no such path (``parallel/
collectives.py``).

The heartbeat: every dist worker stamps ``mxtpu_hb/<rank>`` in the
process group's TCP store (:func:`_start_heartbeat`), and
:meth:`KVStore.dead_nodes` scans the stamps (:func:`scan_dead_ranks`,
shared with the fleet router, over any client with the
``resilience.netkv.CoordKV`` surface: :class:`_StoreKV` here).
"""
from __future__ import annotations

import os
import pickle
import threading
import time

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create", "scan_dead_ranks", "global_barrier"]

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


def _merge(vals):
    """The copies of one key summed on the first one's device, in
    order."""
    merged = vals[0].data
    for v in vals[1:]:
        merged = merged + v.data.to(merged.device)
    return merged


def _world_size():
    """The size of the ``torch.distributed`` group (1 without one): the
    same on every rank."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _dist_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class KVStore:
    """Key-value store (parity: python/mxnet/kvstore.py).

    ``push`` sums the copies pushed for a key (and, in a dist store,
    over the workers), then runs the updater on (summed gradient, stored
    weight), or stores the sum when no updater is set; ``pull`` copies
    the stored value into every out array."""

    def __init__(self, kvtype="local"):
        self.type = kvtype
        self._store = {}
        self._updater = None
        self._created = _now()
        self._dead_hold = {"since": None, "last": []}
        self._async = None       # overlap.AsyncLauncher of push_async
        self._bucket = []        # pending (key, merged) gradients
        self._bucket_nbytes = 0

    @property
    def _dist(self):
        return self.type.startswith("dist") and _world_size() > 1

    @property
    def rank(self):
        return _dist_world()[1] if self.type.startswith("dist") else 0

    @property
    def num_workers(self):
        return _world_size() if self.type.startswith("dist") else 1

    def init(self, key, value):
        """Store each key's initial value once; in a dist store rank 0's
        value, broadcast to every worker (kvstore_dist.h:58-76)."""
        keys, single = _key_list(key)
        for k, vals in zip(keys, _group_values(keys, value, single)):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            data = vals[0].data.clone()
            if self._dist:
                import torch.distributed as dist
                dist.broadcast(data, src=0)
            # init() of a key happens-before any push of it: push_async
            # refuses a key not stored yet, on the caller's thread, before
            # it submits the bucket the worker reads the key from
            # mxl: thread-shared-ok (MXL-Q001)
            self._store[k] = NDArray(data, ctx=vals[0].context)

    def push(self, key, value, priority=0):
        keys, single = _key_list(key)
        for k, vals in zip(keys, _group_values(keys, value, single)):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            self._apply_merged(k, self._allreduce(_merge(vals)),
                               self._updater)

    def _apply_merged(self, k, merged, updater):
        if updater is not None:
            updater(k, NDArray(merged), self._store[k])
        else:
            self._store[k]._set_data(merged)

    def _allreduce(self, merged):
        """The sum over the workers of a dist store (the identity
        otherwise), under an ``allreduce`` span, with a ``collective``
        event (op, sequence number, bytes, ms, workers).  The flight
        recorder's ledger holds the (op, seq) until it completes, and
        with ``MXTPU_STEP_TIMEOUT_S`` set the watchdog bounds it: a
        peer that died mid-push then ends in a ``ResilienceError`` and a
        flight dump naming the pending collective, not a hang."""
        if not self._dist:
            return merged
        import torch.distributed as dist
        from .observability import events as _events, spans as _spans
        from .observability import flight as _flight, trace as _trace
        seq = _trace.next_seq("allreduce")
        nbytes = merged.numel() * merged.element_size()
        timeout = _collective_timeout_s()
        _flight.collective_begin(
            "allreduce", seq, participants=list(range(self.num_workers)),
            bytes=nbytes, rank=self.rank)
        t0 = time.perf_counter()
        out = merged.clone().contiguous()
        with _spans.span("allreduce"):
            if timeout:
                from .resilience import run_with_timeout
                run_with_timeout(_on_device(out.device, dist.all_reduce, out),
                                 timeout, phase="kvstore_push",
                                 rank=self.rank)
            else:
                dist.all_reduce(out)
        # only a completed collective leaves the ledger: on the exception
        # path the entry stays for the flight dump
        _flight.collective_end("allreduce", seq)
        _events.emit("collective", op="allreduce", seq=seq, bytes=nbytes,
                     dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                     num_workers=self.num_workers, **_trace.ids())
        return out

    # -- async + bucketed push -----------------------------------------
    def push_async(self, key, value, priority=0):
        """:meth:`push` that returns before the sum over the workers.

        The copies are merged inline, then the merged gradient joins the
        pending bucket; a bucket past ``MXTPU_BUCKET_MB`` flushes: one
        sum over the workers of its gradients concatenated, then the
        updater key by key, on one background thread (FIFO, so every
        worker runs the same collectives in the same order).  Call
        :meth:`wait_all` before ``pull``."""
        keys, single = _key_list(key)
        for k, vals in zip(keys, _group_values(keys, value, single)):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            self._bucket_add(k, _merge(vals))

    def wait_all(self, timeout=None):
        """Flush the tail bucket and wait until every :meth:`push_async`
        has been applied (re-raising the first failure)."""
        self._flush_bucket()
        if self._async is not None:
            self._async.wait_all(timeout if timeout is not None
                                 else _collective_timeout_s())

    def _bucket_add(self, k, merged):
        from .parallel.overlap import bucket_bytes
        target = bucket_bytes()
        nbytes = merged.numel() * merged.element_size()
        if self._bucket and (target <= 0
                             or self._bucket[-1][1].dtype != merged.dtype
                             or self._bucket[-1][1].device != merged.device
                             or self._bucket_nbytes + nbytes > target):
            self._flush_bucket()
        self._bucket.append((k, merged))
        self._bucket_nbytes += nbytes
        if target <= 0 or self._bucket_nbytes >= target:
            self._flush_bucket()

    def _flush_bucket(self):
        items, self._bucket, self._bucket_nbytes = self._bucket, [], 0
        if not items:
            return
        # the updater the gradients were pushed under: a set_updater
        # while the bucket is in flight applies from the next push on
        updater = self._updater
        if not self._dist:
            # one worker: nothing to wait for, the update runs inline
            for k, merged in items:
                self._apply_merged(k, merged, updater)
            return
        if self._async is None:
            from .parallel.overlap import AsyncLauncher
            self._async = AsyncLauncher(name="kv-async")
        self._async.submit(lambda: self._bucket_allreduce(items, updater))

    def _bucket_allreduce(self, items, updater):
        """One bucket: its gradients concatenated, summed over the
        workers once, split back, the updater key by key (elementwise
        sums: bit for bit the per-key result)."""
        if len(items) == 1:
            k, merged = items[0]
            self._apply_merged(k, self._allreduce(merged), updater)
            return
        fused = self._allreduce(torch.cat([m.reshape(-1) for _, m in items]))
        for (k, merged), part in zip(items, torch.split(
                fused, [m.numel() for _, m in items])):
            self._apply_merged(k, part.view(merged.shape), updater)

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
        """Run ``updater`` on every later push.  The pushes before it
        keep the updater they were pushed under: the pending bucket is
        flushed first, and a bucket in flight applies the updater it was
        flushed with."""
        self._flush_bucket()
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` as the store's updater (parity: kvstore.py:231;
        the copy through pickle keeps the reference's contract that the
        optimizer must be serializable for its server; every worker runs
        the update on the same summed gradient)."""
        from .optimizer import get_updater
        self.set_updater(get_updater(pickle.loads(pickle.dumps(optimizer))))

    # -- fault surface (kvstore.h:242 get_num_dead_node parity) ----------
    def dead_nodes(self, node_id=None, timeout=None):
        """Sorted ranks whose liveness heartbeat is stale or missing, as
        :func:`scan_dead_ranks` reads them from the process group's
        store (:func:`_dist_client`); ``[]`` without a group.  ``timeout`` defaults to 5 heartbeat
        intervals.  An unreachable store holds the last verdict for up
        to ``timeout`` seconds, then re-raises the structured
        ``KVUnreachable``: a blip must not fabricate deaths."""
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
        """Every worker of a dist store waits for the others (parity
        kvstore.h:249) under a ``kv_barrier`` span, ledgered in the
        flight recorder and bounded by the watchdog when
        ``MXTPU_STEP_TIMEOUT_S`` is set; one worker has nothing to wait
        for, armed or not."""
        if self._dist:
            from .observability import flight as _flight
            from .observability import spans as _spans, trace as _trace
            timeout = _collective_timeout_s()
            seq = _trace.next_seq("barrier")
            _flight.collective_begin(
                "barrier", seq, participants=list(range(self.num_workers)),
                rank=self.rank)
            with _spans.span("kv_barrier"):
                if timeout:
                    from .resilience import run_with_timeout
                    run_with_timeout(lambda: global_barrier("kv_barrier"),
                                     timeout, phase="kvstore_barrier",
                                     rank=self.rank)
                else:
                    global_barrier("kv_barrier")
            _flight.collective_end("barrier", seq)

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


def _on_device(device, fn, *args):
    """``fn(*args)`` as a thunk that enters ``device`` and the calling
    thread's current stream there: the watchdog runs it on a thread of
    its own, whose current device and stream are CUDA's defaults."""
    if device.type != "cuda":
        return lambda: fn(*args)
    stream = torch.cuda.current_stream(device)

    def run():
        with torch.cuda.device(device), torch.cuda.stream(stream):
            return fn(*args)
    return run


def _collective_timeout_s():
    """Timeout of a kvstore wait (``MXTPU_STEP_TIMEOUT_S``, else none)."""
    from .resilience import step_timeout_s
    return step_timeout_s()


def global_barrier(tag="barrier"):
    """Every process of the group waits for the others: a sum of one
    CPU value over gloo (``tag`` names it in the telemetry).  Nothing to
    wait for without a group of several."""
    import torch.distributed as dist
    if _world_size() <= 1:
        return
    from .observability import trace as _trace
    _trace.next_seq(tag)
    dist.all_reduce(torch.zeros(1))


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


class _StoreKV(object):
    """The process group's TCP store as a coordination client (the
    ``resilience.netkv.CoordKV`` surface the heartbeat, the liveness
    scan and the elastic protocol use).  Each thread talks through its
    own client connection.  ``key_value_dir_get(prefix)`` lists the
    keys ``<prefix><rank>`` of the group's ranks (a TCP store cannot
    list keys), which is what the heartbeat scan reads."""

    def __init__(self, host, port, world_size, timeout_s=300.0):
        self.host, self.port = host, int(port)
        self.world_size = int(world_size)
        self.timeout_s = float(timeout_s)
        self._local = threading.local()

    def _client(self):
        c = getattr(self._local, "store", None)
        if c is None:
            import datetime
            import torch.distributed as dist
            c = self._local.store = dist.TCPStore(
                self.host, self.port, self.world_size, False,
                timeout=datetime.timedelta(seconds=self.timeout_s))
        return c

    def key_value_set(self, key, value, allow_overwrite=True):
        self._client().set(key, str(value))

    def blocking_key_value_get(self, key, timeout_ms):
        import datetime
        c = self._client()
        c.set_timeout(datetime.timedelta(milliseconds=int(timeout_ms)))
        try:
            return c.get(key).decode()
        finally:
            c.set_timeout(datetime.timedelta(seconds=self.timeout_s))

    def key_value_try_get(self, key):
        c = self._client()
        return c.get(key).decode() if c.check([key]) else None

    def key_value_dir_get(self, prefix):
        out = []
        for r in range(self.world_size):
            key = "%s%d" % (prefix, r)
            got = self.key_value_try_get(key)
            if got is not None:
                out.append((key, got))
        return out

    def key_value_delete(self, key):
        self._client().delete_key(key)


_DIST = {"client": None, "done": False}


def _dist_client():
    """The process group's coordination client (:class:`_StoreKV`), or
    None outside a group started by :func:`_maybe_init_distributed`."""
    return _DIST["client"]


def _backend():
    """gloo for CPU tensors, and NCCL for CUDA tensors where there is
    CUDA (one group serves both: the backend follows the device).  A
    machine with CUDA and no NCCL raises: CUDA tensors never go through
    gloo's host copies."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        return "gloo"
    if not dist.is_nccl_available():
        raise MXNetError(
            "dist kvstore: CUDA is available but this PyTorch has no "
            "NCCL; the process group's CUDA tensors need NCCL and are "
            "never sent through gloo")
    return "cpu:gloo,cuda:nccl"


def _maybe_init_distributed():
    """Join the ``torch.distributed`` group that ``tools/launch.py``'s
    env describes (``MXTPU_COORDINATOR`` = host:port of rank 0's TCP
    store, ``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_RANK``): the ps-lite
    rendezvous's counterpart (``mxnet_tpu/kvstore.py:838-896`` joins
    ``jax.distributed``).  A no-op without ``MXTPU_COORDINATOR`` (a dist
    store of one worker) or when the group exists already.  The elastic
    generation fence runs first: a straggler of a superseded incarnation
    must exit for restart, not join the new group."""
    coord = os.environ.get("MXTPU_COORDINATOR")
    if not coord:
        return
    from .resilience import elastic
    elastic.check_generation_fence()
    import torch.distributed as dist
    if _DIST["done"] or dist.is_initialized():
        _DIST["done"] = True
        return
    missing = [k for k in ("MXTPU_NUM_WORKERS", "MXTPU_WORKER_RANK")
               if k not in os.environ]
    if missing:
        raise MXNetError(
            "partially-configured distributed launch: MXTPU_COORDINATOR is "
            "set but %s %s missing. tools/launch.py exports all three "
            "(MXTPU_COORDINATOR, MXTPU_NUM_WORKERS, MXTPU_WORKER_RANK); "
            "set them together or unset MXTPU_COORDINATOR for single-"
            "process mode." % (" and ".join(missing),
                               "is" if len(missing) == 1 else "are"))
    import datetime
    host, _, port = coord.rpartition(":")
    world = int(os.environ["MXTPU_NUM_WORKERS"])
    rank = int(os.environ["MXTPU_WORKER_RANK"])
    timeout = datetime.timedelta(seconds=float(
        os.environ.get("MXTPU_DIST_TIMEOUT_S", "300")))
    from .resilience import RetryPolicy, retry_call
    # a worker routinely dials before rank 0 listens: connect failures
    # are retried with backoff; anything else propagates at once
    store = retry_call(
        lambda: dist.TCPStore(host, int(port), world, rank == 0,
                              timeout=timeout),
        policy=RetryPolicy(), phase="torch.distributed rendezvous")
    dist.init_process_group(backend=_backend(), store=store,
                            world_size=world, rank=rank, timeout=timeout)
    import atexit
    atexit.register(_leave_group)
    _DIST["store"] = store
    _DIST["client"] = _StoreKV(host, port, world, timeout.total_seconds())
    _DIST["done"] = True


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


def _leave_group():
    """At exit: stop the heartbeat and the stores' ``push_async``
    workers, then leave the process group (NCCL's communicators are
    freed before the interpreter tears down).  No thread of ours may
    outlive the interpreter: one freeing a tensor during finalization
    aborts the process (``overlap.close_launchers``)."""
    _stop_heartbeat()
    from .parallel.overlap import close_launchers
    close_launchers()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def create(name="local"):
    """String factory (parity: kvstore.cc:17-45, kvstore.py create); a
    ``dist_*`` store joins the launch's process group first and starts
    the heartbeat."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    base = name.lower()
    if base not in _VALID_TYPES and not any(
            t in base for t in ("local", "device", "dist")):
        raise MXNetError("unknown KVStore type %r" % name)
    if base.startswith("dist"):
        _maybe_init_distributed()
        if _dist_client() is not None:
            _start_heartbeat(_dist_client(), _dist_world()[1])
    store = KVStore(base)
    if base.startswith("dist"):
        # the flight recorder's liveness probe: a hung-collective dump
        # then names the participants that never showed up
        try:
            from .observability import flight as _flight
            _flight.set_liveness_probe(lambda: store.dead_nodes())
        except Exception:
            pass
    return store
