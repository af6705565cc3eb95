"""Overlap machinery: the serving pipeline's worker, the compile-cache
counters, and bucket planning for the fused optimizer sweep.

Copies from ``mxnet_tpu/parallel/overlap.py``:

- :class:`AsyncLauncher`, the single-thread FIFO executor behind the
  serving batcher's dispatch and unpack stages (the JAX package's also
  registers its thread with the data-loader shutdown hook; here an
  ``atexit`` flag plays that part);
- the compile-cache counters (:func:`cache_key`,
  :func:`graph_fingerprint`, :func:`note_lowering`, :func:`note_hit`,
  :func:`compile_cache_stats`) that the executor's program registry
  feeds.  In the port a "lowering" is one ``build_program``: a registry
  miss;
- ``partition_buckets`` and ``_nbytes`` (``_nbytes`` here also reads
  torch tensors).  The rest of that module (the async device feed,
  gradient-bucket barriers and their ``MXTPU_BUCKET_MB`` target, the
  persistent XLA cache) belongs to the multi-GPU slice, so the target is
  always given here.
"""
from __future__ import annotations

import atexit
import hashlib
import queue as _queue
import threading

import numpy as _np

__all__ = ["partition_buckets", "AsyncLauncher", "cache_key",
           "graph_fingerprint", "note_lowering", "note_hit",
           "compile_cache_stats", "compile_cache_clear"]

#: set at interpreter exit: workers stop taking work and submit() runs
#: inline, so nothing is dropped and no daemon thread outlives its queue
_SHUTTING_DOWN = [False]


@atexit.register
def _mark_shutdown():
    _SHUTTING_DOWN[0] = True


class AsyncLauncher(object):
    """Single-worker FIFO executor: ``submit()`` returns immediately,
    ``wait_all()`` waits for every submitted closure and re-raises the
    first failure.

    ONE worker thread on purpose: closures run in submit order (the
    serving batcher relies on it to launch batches in pack order).  The
    worker starts lazily and parks on its queue when idle."""

    def __init__(self, name="async"):
        self._name = name
        self._queue = _queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._exc = None
        self._thread = None

    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return True
        if _SHUTTING_DOWN[0]:
            return False
        self._thread = threading.Thread(
            target=self._run, name="mxtpu-%s" % self._name, daemon=True)
        self._thread.start()
        return True

    def _run(self):
        while not _SHUTTING_DOWN[0]:
            try:
                fn = self._queue.get(timeout=0.2)
            except _queue.Empty:
                continue
            if fn is None:
                return
            try:
                fn()
            except BaseException as exc:
                with self._lock:
                    if self._exc is None:
                        self._exc = exc
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.notify_all()

    def submit(self, fn):
        """Queue ``fn`` for the worker; runs it inline when the
        interpreter is shutting down (never drops work)."""
        with self._lock:
            self._pending += 1
        if not self._ensure_thread():
            try:
                fn()
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.notify_all()
            return
        self._queue.put(fn)

    def pending(self):
        """Closures submitted but not yet finished (how the serving
        scheduler senses an idle pipeline)."""
        with self._lock:
            return self._pending

    def wait_all(self, timeout=None):
        """Block until every submitted closure finished; re-raise the
        first exception any of them hit."""
        with self._lock:
            if self._pending and not self._idle.wait_for(
                    lambda: self._pending == 0, timeout=timeout):
                raise TimeoutError(
                    "%s: %d closures still pending after %ss"
                    % (self._name, self._pending, timeout))
            exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def close(self):
        self._queue.put(None)
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None


# ---------------------------------------------------------------------------
# compile-cache counters
# ---------------------------------------------------------------------------

_CACHE_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0, "lowerings": 0}


def _stable_repr(part):
    """Deterministic textual form of one key component (dicts sorted)."""
    if isinstance(part, dict):
        return "{" + ",".join(
            "%s:%s" % (_stable_repr(k), _stable_repr(v))
            for k, v in sorted(part.items(), key=lambda kv: str(kv[0]))) + "}"
    if isinstance(part, (list, tuple)):
        return "[" + ",".join(_stable_repr(p) for p in part) + "]"
    return repr(part)


def cache_key(*parts):
    """sha256 over the stable repr of the parts."""
    h = hashlib.sha256()
    for part in parts:
        h.update(_stable_repr(part).encode("utf-8", "replace"))
        h.update(b"\x00")
    return h.hexdigest()


def graph_fingerprint(symbol):
    """Graph hash of ``Symbol.tojson``: two structurally identical
    Symbols (a server's per-bucket binds of one model) collide on
    purpose."""
    return hashlib.sha256(symbol.tojson().encode("utf-8")).hexdigest()


def note_lowering(n=1):
    """Count one program build: what the registry exists to avoid."""
    with _CACHE_LOCK:
        _STATS["lowerings"] += n
        _STATS["misses"] += n


def note_hit(n=1):
    """Count one registry hit."""
    with _CACHE_LOCK:
        _STATS["hits"] += n


def compile_cache_stats():
    """``{"hits", "misses", "lowerings"}`` of this process."""
    with _CACHE_LOCK:
        return dict(_STATS)


def compile_cache_clear():
    with _CACHE_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def partition_buckets(sized_items, bucket_nbytes):
    """Greedy size-targeted partition of ``[(key, nbytes), ...]`` into
    ``[[key, ...], ...]`` buckets, preserving input order.

    Every key lands in exactly one bucket; a single item larger than
    the target gets its own bucket.  ``bucket_nbytes`` of 0 means
    bucketing is off: everything lands in one all-covering bucket."""
    items = list(sized_items)
    if not items:
        return []
    if bucket_nbytes <= 0:
        return [[k for k, _ in items]]
    buckets, cur, cur_bytes = [], [], 0
    for key, nbytes in items:
        nbytes = int(nbytes or 0)
        if cur and cur_bytes + nbytes > bucket_nbytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(key)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _nbytes(x):
    """Bytes of a tensor or an array (0 when unknown)."""
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return int(x.element_size()) * int(x.numel())
    try:
        return int(_np.dtype(x.dtype).itemsize) * int(
            _np.prod(x.shape, dtype=_np.int64)) if x.shape else \
            int(_np.dtype(x.dtype).itemsize)
    except Exception:
        return 0
