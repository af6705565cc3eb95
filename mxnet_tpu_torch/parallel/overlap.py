"""Overlap machinery: the async device feed, the serving pipeline's
worker, the compile-cache counters, and bucket planning for the fused
optimizer sweep.

Copies from ``mxnet_tpu/parallel/overlap.py``:

- :class:`DevicePrefetcher`, the async device feed: one producer thread
  pulls batch N+1 from any iterator and places it on the device while
  step N runs (``prefetch_enabled``/``prefetch_depth``:
  ``MXTPU_PREFETCH``, ``MXTPU_PREFETCH_DEPTH``).  On a CUDA device the
  placement runs on the prefetcher's own stream: :class:`HostToDevice`
  stages each host array in a pinned buffer and copies it with
  ``non_blocking=True``; the consumer's stream waits on an event
  recorded after the copies, and a pinned buffer is rewritten only
  after its copy has completed;
- :class:`AsyncLauncher`, the single-thread FIFO executor behind the
  serving batcher's dispatch and unpack stages (the JAX package's also
  registers its thread with the data-loader shutdown hook; here an
  ``atexit`` flag plays that part);
- the compile-cache counters (:func:`cache_key`,
  :func:`graph_fingerprint`, :func:`note_lowering`, :func:`note_hit`,
  :func:`compile_cache_stats`) that the executor's program registry
  feeds.  In the port a "lowering" is one ``build_program``: a registry
  miss;
- gradient buckets: :func:`bucket_bytes` (``MXTPU_BUCKET_MB``),
  :func:`partition_buckets`, :func:`interleave_grad_buckets` and
  ``_nbytes`` (which also reads torch tensors).  The JAX package chains
  optimization barriers through a traced step's gradients so that XLA
  reduces each bucket over the mesh as soon as its gradients exist; the
  port does it eagerly: :class:`GradBuckets` hooks every replica's
  parameter leaves and reduces a bucket (``parallel/collectives.py``) in
  the autograd hook of its last gradient, on each device's current
  stream, while the backward goes on.  The persistent XLA cache has no
  counterpart.
"""
from __future__ import annotations

import atexit
import functools
import hashlib
import os
import queue as _queue
import threading
import weakref

import numpy as _np
import torch

__all__ = ["DevicePrefetcher", "HostToDevice", "prefetch_enabled",
           "prefetch_depth", "partition_buckets", "bucket_bytes",
           "interleave_grad_buckets", "GradBuckets", "AsyncLauncher",
           "cache_key", "graph_fingerprint", "note_lowering", "note_hit",
           "compile_cache_stats", "compile_cache_clear"]

#: set at interpreter exit: workers stop taking work and submit() runs
#: inline, so nothing is dropped and no daemon thread outlives its queue
_SHUTTING_DOWN = [False]
#: every AsyncLauncher, so exit can stop their workers
_LIVE_LAUNCHERS = weakref.WeakSet()


def close_launchers():
    """Stop the worker thread of every :class:`AsyncLauncher` and wait
    for it (a later ``submit`` starts a new one).  A worker must not
    outlive the interpreter: Python 3.12 ends a daemon thread that
    takes the GIL during finalization with ``pthread_exit``, and when
    that thread is inside a tensor's deallocation (which releases the
    GIL) the forced unwind through PyTorch's ``noexcept`` frame calls
    ``std::terminate``."""
    for launcher in list(_LIVE_LAUNCHERS):
        launcher.close()


@atexit.register
def _mark_shutdown():
    # a one-way flag, set once here (a GIL-atomic store) and polled by
    # the workers between closures; close_launchers then joins them
    # mxl: thread-shared-ok (MXL-Q001)
    _SHUTTING_DOWN[0] = True
    close_launchers()


# ---------------------------------------------------------------------------
# the async device feed
# ---------------------------------------------------------------------------
_TRUE = ("1", "true", "yes", "on")


def prefetch_enabled(explicit=None):
    """Resolve the prefetch switch: an explicit ``prefetch=`` argument
    wins; otherwise ``MXTPU_PREFETCH``."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get("MXTPU_PREFETCH", "").lower() in _TRUE


def prefetch_depth(explicit=None):
    """Queue depth for the async feed (``MXTPU_PREFETCH_DEPTH``,
    default 2 = double buffering).  Clamped to >= 1."""
    if explicit is not None:
        return max(1, int(explicit))
    try:
        return max(1, int(os.environ.get("MXTPU_PREFETCH_DEPTH", "2")))
    except ValueError:
        return 2


class HostToDevice(object):
    """Copies of host arrays (numpy, CPU tensors or NDArrays) to
    ``device``, keeping their dtype (float64 becomes float32, as in the
    reference).

    On a CUDA device each array is staged in a pinned buffer, one of
    ``slots`` kept per (shape, dtype) and used in turn, and copied with
    ``non_blocking=True`` on the caller's current stream (the
    prefetcher's own).  An event recorded after each copy guards its
    buffer: the buffer is rewritten only once that copy has completed.
    The device tensor is marked as used on ``consumer`` (the stream
    current when this object was made), so the caching allocator does
    not hand its memory out again before the consumer's work on it is
    done.  On another device it is a plain copy."""

    def __init__(self, device, slots=4):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.consumer = torch.cuda.current_stream(self.device) \
            if self.cuda else None
        self._slots = max(2, int(slots))
        self._pool = {}         # (shape, dtype) -> [next, [[buf, event]]]

    def _host(self, arr):
        if hasattr(arr, "asnumpy") and not isinstance(arr, torch.Tensor):
            t = getattr(arr, "data", None)
            arr = t if isinstance(t, torch.Tensor) else arr.asnumpy()
        t = arr if isinstance(arr, torch.Tensor) else \
            torch.from_numpy(_np.ascontiguousarray(arr))
        return t.float() if t.dtype == torch.float64 else t

    def _staging(self, shape, dtype):
        ring = self._pool.setdefault((tuple(shape), dtype), [0, []])
        i = ring[0]
        ring[0] = (i + 1) % self._slots
        if len(ring[1]) <= i:
            ring[1].append([torch.empty(shape, dtype=dtype,
                                        pin_memory=True), None])
        slot = ring[1][i]
        if slot[1] is not None:
            slot[1].synchronize()       # its last copy has completed
        return slot

    def __call__(self, arr):
        host = self._host(arr)
        if not self.cuda:
            return host.to(self.device, copy=True)
        slot = self._staging(host.shape, host.dtype)
        slot[0].copy_(host)
        dev = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.current_stream(self.device).record_event()
        dev.record_stream(self.consumer)
        return dev


class _Stop(object):
    """Queue sentinel: end of epoch."""
    __slots__ = ()


class _Raised(object):
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class DevicePrefetcher(object):
    """Double-buffered async device feed over any ``DataIter`` or
    iterator.

    A single background producer thread pulls batch N+1 from ``it`` and
    (optionally) places it on the device via ``place_fn`` while the
    consumer runs step N.  One producer + a FIFO queue keeps batch
    order exactly the serial order, so training is bit for bit the same
    with prefetch on or off.

    ``stream``: a CUDA stream (a :class:`HostToDevice`'s) that
    ``place_fn`` runs on; an event recorded on it after each placement
    is waited on by the consumer's current stream when the batch is
    handed out, so the consumer never reads a batch whose copy is still
    in flight.

    Spans: the producer times the inner fetch as ``data_wait`` and the
    placement as ``h2d`` (both tagged ``async=1``); the consumer's queue
    pop is timed as ``data_wait`` too — near zero when overlap works.

    DataIter surface: ``next``/``iter``/``reset``/``iter_next`` plus
    ``provide_data``/``provide_label``/``batch_size`` passthrough, so it
    drops into ``BaseModule.fit`` unchanged.  ``reset()`` is idempotent:
    it stops the producer, drains in-flight batches, resets the inner
    iter, and restarts.  ``close()`` joins the thread for good (also
    run at interpreter exit via io.py's producer registry, and on
    ``__del__``).
    """

    def __init__(self, it, place_fn=None, depth=None, name=None,
                 stream=None):
        self._it = it if hasattr(it, "__next__") else iter(it)
        self._resettable = it if hasattr(it, "reset") else None
        self._place_fn = place_fn
        self._stream = stream
        self._depth = prefetch_depth(depth)
        self._name = name or "prefetch"
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._closed = False
        self._n = 0
        self._cur = None
        self._start()

    # -- producer ----------------------------------------------------------

    def _start(self):
        from .. import io as _io
        if _io._SHUTTING_DOWN or self._closed:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._produce, name="mxtpu-%s" % self._name, daemon=True)
        _io._register_producer(self._thread)
        self._thread.start()

    def _place(self, batch):
        """``place_fn(batch)`` and the event the consumer waits on (None
        without a stream)."""
        if self._stream is None:
            return self._place_fn(batch), None
        with torch.cuda.stream(self._stream):
            placed = self._place_fn(batch)
            return placed, self._stream.record_event()

    def _produce(self):
        from .. import io as _io
        from ..observability.spans import span
        try:
            while not self._stop.is_set() and not _io._SHUTTING_DOWN:
                try:
                    with span("data_wait", step=self._n, **{"async": 1}):
                        batch = next(self._it)
                except StopIteration:
                    self._put(_Stop())
                    return
                ready = None
                if self._place_fn is not None:
                    with span("h2d", step=self._n, **{"async": 1}):
                        batch, ready = self._place(batch)
                self._put((batch, ready))
        except BaseException as exc:        # surfaced at the consumer
            self._put(_Raised(exc))

    def _put(self, item):
        """Blocking put that stays responsive to stop/shutdown."""
        from .. import io as _io
        while not self._stop.is_set() and not _io._SHUTTING_DOWN:
            try:
                self._queue.put(item, timeout=0.1)
                return
            except _queue.Full:
                continue

    # -- consumer (DataIter protocol) --------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        from ..observability.spans import span
        if self._thread is None:
            self._start()                   # restarted after reset/epoch end
        if self._thread is None:            # interpreter shutting down
            raise StopIteration
        with span("data_wait", step=self._n):
            item = self._queue.get()
        if isinstance(item, _Stop):
            self._join()
            raise StopIteration
        if isinstance(item, _Raised):
            self._join()
            raise item.exc
        batch, ready = item
        if ready is not None:
            torch.cuda.current_stream(self._stream.device).wait_event(ready)
        # single consumer owns the counter; the producer only reads it
        # for span step labels, where staleness is harmless
        # mxl: thread-shared-ok (MXL-Q001)
        self._n += 1
        return batch

    def next(self):
        return self.__next__()

    def iter_next(self):
        try:
            self._cur = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._cur.data

    def getlabel(self):
        return self._cur.label

    def getpad(self):
        return getattr(self._cur, "pad", None)

    def getindex(self):
        return getattr(self._cur, "index", None)

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label

    @property
    def batch_size(self):
        return getattr(self._it, "batch_size", 0)

    # -- lifecycle ---------------------------------------------------------

    def _drain(self):
        while True:
            try:
                self._queue.get_nowait()
            except _queue.Empty:
                return

    def _join(self, timeout=10.0):
        t, self._thread = self._thread, None
        if t is None:
            return
        self._stop.set()
        self._drain()                       # unblock a producer mid-put
        while t.is_alive():
            self._drain()
            t.join(timeout=0.1)
            timeout -= 0.1
            if timeout <= 0:
                break

    def reset(self):
        """Idempotent: drain in-flight batches, reset the inner iter,
        restart the producer.  Safe to call mid-epoch or twice in a
        row (every epoch boundary in the fit loops does)."""
        self._join()
        self._drain()
        if self._resettable is not None:
            self._resettable.reset()
        if not self._closed:
            self._start()

    def close(self):
        """Join the producer for good; the inner iter's ``close`` (if
        any) runs too.  Idempotent."""
        self._closed = True
        self._join()
        self._drain()
        inner_close = getattr(self._it, "close", None)
        if callable(inner_close):
            try:
                inner_close()
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


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
        _LIVE_LAUNCHERS.add(self)

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
                # an idle worker holds nothing: the closure's tensors are
                # freed here, not when the thread ends (close_launchers)
                fn = None
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
        """Stop the worker after the closures already queued, and wait
        for it (at most 5 s); a later ``submit`` starts a new one."""
        t = self._thread
        if t is not None and t.is_alive():
            self._queue.put(None)
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


def bucket_bytes(explicit_mb=None):
    """Gradient-bucket size target in bytes (``MXTPU_BUCKET_MB``,
    default 25 MB); 0 disables bucketing."""
    if explicit_mb is None:
        try:
            explicit_mb = float(os.environ.get("MXTPU_BUCKET_MB", "25"))
        except ValueError:
            explicit_mb = 25.0
    if explicit_mb <= 0:
        return 0
    return int(explicit_mb * (1 << 20))


def partition_buckets(sized_items, bucket_nbytes=None):
    """Greedy size-targeted partition of ``[(key, nbytes), ...]`` into
    ``[[key, ...], ...]`` buckets, preserving input order.

    Every key lands in exactly one bucket; a single item larger than
    the target gets its own bucket.  ``bucket_nbytes`` of 0 means
    bucketing is off: everything lands in one all-covering bucket;
    None means :func:`bucket_bytes`."""
    items = list(sized_items)
    if bucket_nbytes is None:
        bucket_nbytes = bucket_bytes()
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


def interleave_grad_buckets(named_grads, order=None, bucket_nbytes=None):
    """The reduction plan of a backward's gradients: ``named_grads``
    (name -> tensor, argument order) partitioned in production order
    (``order``, default the reverse of the arguments: the backward emits
    the last layer's gradients first) into buckets of about
    :func:`bucket_bytes`.  Returns ``[[name, ...], ...]`` in the order
    the backward finishes them (:class:`GradBuckets` reduces them so);
    one bucket of every name when bucketing is off.  The JAX function
    returns the gradients tied by barriers in this plan's order."""
    if order is None:
        order = list(reversed(list(named_grads)))
    sized = [(k, _nbytes(named_grads[k])) for k in order if k in named_grads]
    buckets = partition_buckets(sized, bucket_nbytes)
    from ..observability import events as _events
    sizes = dict(sized)
    _events.emit("counter", name="grad_buckets", n_buckets=len(buckets),
                 bucket_nbytes=[sum(sizes[k] for k in b) for b in buckets],
                 bucket_keys=[len(b) for b in buckets])
    return buckets


class GradBuckets(object):
    """Reduce the gradients of several replicas' leaves bucket by bucket
    as one backward produces them.

    ``leaves[r]``: name -> leaf tensor of replica r (``requires_grad``);
    ``plan``: :func:`interleave_grad_buckets`' buckets; ``reduce(names,
    grads)`` reduces one bucket (``grads[r]``: name -> gradient of
    replica r) and returns its result, kept by bucket.  A post-accumulate
    hook on each leaf counts its bucket down and runs ``reduce`` when
    the bucket's last gradient of the last replica arrives (on the
    thread of the device whose gradient came last; the collectives keep
    one order across devices).  :meth:`finish`, after the backward,
    reduces any bucket still open (a leaf the heads do not reach gives
    zeros, as ``torch.autograd.grad`` with ``allow_unused`` does here),
    drops the hooks and the leaves' ``.grad`` and returns ``[result of
    bucket 0, ...]``."""

    def __init__(self, leaves, plan, reduce):
        self.leaves = leaves
        self.plan = [list(b) for b in plan]
        self.reduce = reduce
        self.results = [None] * len(self.plan)
        self._left = [len(b) * len(leaves) for b in self.plan]
        self._bucket_of = {n: i for i, b in enumerate(self.plan) for n in b}
        self._lock = threading.Lock()
        self._handles = []
        for r, named in enumerate(leaves):
            for name, leaf in named.items():
                if name in self._bucket_of:
                    self._handles.append(leaf.register_post_accumulate_grad_hook(
                        functools.partial(self._arrived, name)))

    # the hook that counts a bucket to zero (under _lock) is the only one
    # to run it; finish() reads after backward() has returned, which
    # joins autograd's device threads  # mxl: thread-shared-ok (MXL-Q005)
    def _arrived(self, name, _leaf):
        i = self._bucket_of[name]
        with self._lock:
            self._left[i] -= 1
            ready = self._left[i] == 0
        if ready:
            self._run(i)

    # bucket i's results and count are written by the one caller that
    # found it complete: its last hook, or finish() after the backward
    # mxl: thread-shared-ok (MXL-Q005)
    def _run(self, i):
        names = self.plan[i]
        grads = []
        for named in self.leaves:
            got = {}
            for n in names:
                g = named[n].grad
                got[n] = g if g is not None else torch.zeros_like(named[n])
                named[n].grad = None
            grads.append(got)
        self.results[i] = self.reduce(names, grads)
        self._left[i] = -1

    def finish(self):
        for h in self._handles:
            h.remove()
        self._handles = []
        for i, left in enumerate(self._left):
            if left >= 0:
                self._run(i)
        return self.results
