"""Continuous batcher: bounded request queue + scheduler loop + the
two single-FIFO pipeline workers.

The port's copy of ``mxnet_tpu/serving/batcher.py``.  The pipeline is the
same; on the GPU "launch" enqueues CUDA work on the default stream from
the dispatch worker (every model of a server launches on that one
stream, so stream order serialises them) and "unpack" waits for it by
copying the results to the host.

The serving analog of the PR-8 overlap machinery: where training hides
``data_wait``/``h2d`` under the previous step, serving hides host-side
pack/unpack under device execution.  Three threads pipeline each batch:

- the **scheduler** (this module's loop) picks the highest-priority
  model with pending work, decides when a batch is ripe (bucket full,
  or the oldest request has waited ``max_delay_ms``), pops requests
  FIFO and packs them into the padded bucket array — host work that
  runs while the previous batch executes;
- the **dispatch worker** (an :class:`~mxnet_tpu_torch.parallel.overlap.
  AsyncLauncher`, ONE thread so batches launch in pack order) calls the
  entry's ``launch`` — an asynchronous launch that returns device
  tensors without waiting for the device;
- the **unpack worker** (a second single-FIFO ``AsyncLauncher``) blocks
  on the device arrays (the ``device`` phase), slices per-request
  results back out (``unpack``), completes futures, and emits one
  ``serve`` telemetry record per batch.

SLO knobs (``MXTPU_SERVE_*`` in docs/env_vars.md): ``max_delay_ms``
bounds the admission timer — a lone request never waits longer than
this for companions; ``max_queue`` bounds admission — beyond it
:meth:`submit` raises :class:`ServerBusy`, a structured 429 carrying
queue depth and a ``retry_after_ms`` hint, instead of letting latency
grow without bound.  ``drain()`` stops admission and flushes every
accepted request through the pipeline (graceful shutdown).

Model entries are duck-typed (see :class:`mxnet_tpu_torch.serving.
server.ModelServer` for the real one): ``name``, ``priority``, ``buckets``
(sorted admissible batch sizes), ``pack(requests, bucket)`` →
payload, ``launch(payload, bucket)`` → handle, ``unpack(handle,
requests, bucket)`` → ``(per-request results, phase dict)``.

**Generative entries** (``generative = True``, see :class:`mxnet_tpu_torch.
serving.generate.GenerativeEntry`) extend the protocol for
iteration-level decode batching: ``buckets`` are prompt-length buckets
and each queued request is ONE prompt (popped alone into a bucketed
prefill, so new prompts join without evicting running decodes), while
``has_decode_work()``/``pack_decode()`` surface decode iterations the
scheduler dispatches even with an empty queue — one step over every
active sequence, results settled through ``complete(handle, batch)``.
The scheduler runs at most one in-flight job per generative entry
(step N+1 consumes step N's tokens and cache pools) and alternates
prefill/decode when both pend, so neither phase starves the other.
"""
from __future__ import annotations

import os as _os
import threading
import time
from collections import deque

from ..base import MXNetError
from ..observability import trace as _trace
from ..parallel.overlap import AsyncLauncher
from . import telemetry as _tel
from .buckets import bucket_for

__all__ = ["ContinuousBatcher", "Request", "Future", "ServerBusy",
           "max_delay_ms", "max_queue"]


def max_delay_ms(explicit=None):
    """Admission timer (``MXTPU_SERVE_MAX_DELAY_MS``, default 10 ms):
    the longest a request may sit waiting for batch companions."""
    if explicit is not None:
        return float(explicit)
    try:
        return float(_os.environ.get("MXTPU_SERVE_MAX_DELAY_MS", "10"))
    except ValueError:
        return 10.0


def max_queue(explicit=None):
    """Admission bound (``MXTPU_SERVE_MAX_QUEUE``, default 1024
    requests across all models); 0/negative = unbounded."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(_os.environ.get("MXTPU_SERVE_MAX_QUEUE", "1024"))
    except ValueError:
        return 1024


class ServerBusy(MXNetError):
    """Structured backpressure rejection (the HTTP 429 analog): carries
    machine-readable fields so callers can back off instead of parsing
    a message string."""

    def __init__(self, model, queue_depth, limit, retry_after_ms=None,
                 code=429, reason="queue full", extra=None):
        self.model = model
        self.queue_depth = int(queue_depth)
        self.limit = int(limit)
        self.retry_after_ms = retry_after_ms
        self.code = int(code)
        self.reason = reason
        self.extra = dict(extra) if extra else None
        super(ServerBusy, self).__init__(
            "server busy (%d): %s — model %r queue depth %d >= limit %d"
            % (self.code, reason, model, self.queue_depth, self.limit))

    def to_dict(self):
        d = {"error": "server_busy", "code": self.code,
             "reason": self.reason, "model": self.model,
             "queue_depth": self.queue_depth, "limit": self.limit,
             "retry_after_ms": self.retry_after_ms}
        if self.extra:
            d.update(self.extra)         # e.g. blocks_free on KV 429s
        return d


class Future(object):
    """Completion handle for one request (threading.Event based — no
    concurrent.futures dependency on the hot path)."""

    __slots__ = ("_ev", "_result", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc = None

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request still pending after %ss" % timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def _set(self, result):
        self._result = result
        self._ev.set()

    def _fail(self, exc):
        self._exc = exc
        self._ev.set()


class Request(object):
    """One admitted inference request: ``n`` samples of payload for one
    model, plus the timing trail telemetry reads.  Under
    ``MXTPU_TRACE=1`` each request gets a trace id at admission; the
    batch's ``serve`` record carries all member ids, so a slow request
    is traceable through queue → pack → device → unpack."""

    __slots__ = ("model", "payload", "n", "t_arrival", "future",
                 "t_dispatch", "t_done", "trace_id")

    def __init__(self, model, payload, n, trace_id=None):
        self.model = model
        self.payload = payload
        self.n = int(n)
        self.t_arrival = time.perf_counter()
        self.future = Future()
        self.t_dispatch = None
        self.t_done = None
        # an explicit id wins: the fleet router mints the id at ITS
        # admission edge and threads it through so the replica's batch
        # record joins the router's span in one trace
        self.trace_id = trace_id or (_trace.new_id() if _trace.enabled()
                                     else None)


class _Batch(object):
    """In-flight batch bookkeeping between the three pipeline stages.
    ``phase`` is None for plain predict batches, "prefill"/"decode"
    for generative jobs (which settle via ``entry.complete``)."""

    __slots__ = ("entry", "requests", "bucket", "n_samples", "pack_ms",
                 "queue_depth", "t_packed", "phase", "payload")

    def __init__(self, entry, requests, bucket, n_samples, pack_ms,
                 queue_depth, phase=None, payload=None):
        self.entry = entry
        self.requests = requests
        self.bucket = bucket
        self.n_samples = n_samples
        self.pack_ms = pack_ms
        self.queue_depth = queue_depth
        self.t_packed = time.perf_counter()
        self.phase = phase
        self.payload = payload


class ContinuousBatcher(object):
    """Bounded multi-model request queue + scheduler + FIFO pipeline.

    Thread-safe: :meth:`submit` may be called from any number of client
    threads (the HTTP handler pool, the bench's closed-loop workers).
    """

    def __init__(self, max_delay_ms_=None, max_queue_=None, name="serve"):
        self.max_delay_ms = max_delay_ms(max_delay_ms_)
        self.max_queue = max_queue(max_queue_)
        self._name = name
        self._entries = {}
        self._pending = {}              # model -> deque[Request]
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._dispatch = AsyncLauncher(name="%s-dispatch" % name)
        self._unpack = AsyncLauncher(name="%s-unpack" % name)
        self._gen_busy = set()          # generative entries in flight
        self._thread = None
        self._stop = False
        self._accepting = True
        self._stats = {"requests": 0, "samples": 0, "batches": 0,
                       "rejected": 0, "failed": 0,
                       "occupancy_sum": 0.0, "waste_sum": 0.0}
        self._lat_ms = deque(maxlen=4096)

    # -- registration ------------------------------------------------------

    def register(self, entry):
        """Add a model entry (duck-typed; see module docstring).  The
        entry's ``buckets`` must be a non-empty sorted tuple."""
        if not getattr(entry, "buckets", None):
            raise MXNetError("entry %r has no buckets" % (entry,))
        with self._cv:
            self._entries[entry.name] = entry
            self._pending.setdefault(entry.name, deque())

    def models(self):
        with self._lock:
            return sorted(self._entries)

    # -- admission ---------------------------------------------------------

    def queue_depth(self):
        """Requests admitted but not yet dispatched (all models)."""
        with self._lock:
            return sum(len(q) for q in self._pending.values())

    def submit(self, model, payload, n=1, trace_id=None):
        """Admit one request (``n`` samples) and return its Future.
        Raises :class:`ServerBusy` on backpressure, MXNetError for an
        unknown model or an inadmissible sample count.  ``trace_id``:
        adopt a caller-minted trace id (the fleet router's) instead of
        minting one here."""
        with self._cv:
            entry = self._entries.get(model)
            if entry is None:
                raise MXNetError("unknown model %r (have: %s)"
                                 % (model, sorted(self._entries)))
            if n > entry.buckets[-1]:
                raise MXNetError(
                    "request of %d samples exceeds model %r's largest "
                    "bucket %d" % (n, model, entry.buckets[-1]))
            if not self._accepting:
                raise ServerBusy(model, 0, 0, code=503, reason="draining")
            depth = sum(len(q) for q in self._pending.values())
            if 0 < self.max_queue <= depth:
                self._stats["rejected"] += 1
                raise ServerBusy(model, depth, self.max_queue,
                                 retry_after_ms=self.max_delay_ms)
            req = Request(model, payload, n, trace_id=trace_id)
            self._pending[model].append(req)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="mxtpu-%s-sched" % self._name,
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return req.future

    # -- scheduler ---------------------------------------------------------

    def _pick(self):
        """The ripest (entry, deque, kind): highest priority first,
        then oldest head request.  ``kind`` is "predict" for plain
        entries, "prefill"/"decode" for generative ones.  A generative
        entry with a job in flight is skipped (iteration serialization);
        when it has both a queued prompt and active decodes, the phases
        alternate via ``prefer_prefill`` so neither starves.  None when
        nothing is runnable."""
        best = None
        now = time.perf_counter()
        for name, q in self._pending.items():
            entry = self._entries[name]
            gen = getattr(entry, "generative", False)
            if gen and name in self._gen_busy:
                continue
            has_req = bool(q)
            has_dec = gen and entry.has_decode_work()
            if not has_req and not has_dec:
                continue
            if not gen:
                kind = "predict"
            elif has_req and has_dec:
                kind = "prefill" if entry.prefer_prefill else "decode"
            elif has_req:
                kind = "prefill"
            else:
                kind = "decode"
            # decode-only work carries no queue timestamp: rank it at
            # `now` so an older queued request (any model) goes first
            age = q[0].t_arrival if has_req else now
            key = (-getattr(entry, "priority", 0), age)
            if best is None or key < best[0]:
                best = (key, entry, q, kind)
        return best[1:] if best else None

    def _loop(self):
        while True:
            with self._cv:
                picked = self._pick()
                if picked is None:
                    if self._stop:
                        return
                    self._cv.wait(0.05)
                    continue
                entry, q, kind = picked
                if kind == "decode":
                    self._gen_busy.add(entry.name)
                    entry.prefer_prefill = True
                    depth_after = sum(len(qq)
                                      for qq in self._pending.values())
                elif kind == "prefill":
                    self._gen_busy.add(entry.name)
                    entry.prefer_prefill = False
                    req = q.popleft()
                    depth_after = sum(len(qq)
                                      for qq in self._pending.values())
                if kind == "predict":
                    now = time.perf_counter()
                    samples = sum(r.n for r in q)
                    head_age_ms = (now - q[0].t_arrival) * 1e3
                    # iteration-level (ORCA-style) ripeness: a batch
                    # goes the moment the largest bucket fills, the
                    # head request exhausts its admission window, OR
                    # the pipeline has idle capacity (< 2 batches in
                    # flight keeps the device double-buffered) —
                    # waiting for companions only ever happens while
                    # the device is already busy, so batching never
                    # costs latency it isn't hiding
                    idle = (self._dispatch.pending() == 0
                            and self._unpack.pending() < 2)
                    ripe = (samples >= entry.buckets[-1]
                            or head_age_ms >= self.max_delay_ms
                            or idle
                            or not self._accepting or self._stop)
                    if not ripe:
                        # sleep until the head's admission deadline (a
                        # new arrival or a completed batch notifies
                        # sooner)
                        self._cv.wait(
                            max((self.max_delay_ms - head_age_ms) / 1e3,
                                1e-4))
                        continue
                    # pop FIFO while the batch still fits the bucket
                    reqs, total = [], 0
                    while q and total + q[0].n <= entry.buckets[-1]:
                        req = q.popleft()
                        reqs.append(req)
                        total += req.n
                    depth_after = sum(len(qq)
                                      for qq in self._pending.values())
            # pack OUTSIDE the lock: host work for batch N+1 overlaps
            # device execution of batch N (the whole point)
            t0 = time.perf_counter()
            if kind == "decode":
                # one decode iteration over every active sequence —
                # no queue involvement, ready the moment the previous
                # step lands (generative jobs are always ripe)
                try:
                    payload, bucket, n_active = entry.pack_decode()
                except BaseException:
                    with self._lock:
                        self._stats["failed"] += 1
                    self._gen_done(entry)
                    time.sleep(0.005)   # don't spin on a broken packer
                    continue
                pack_ms = (time.perf_counter() - t0) * 1e3
                batch = _Batch(entry, [], bucket, n_active, pack_ms,
                               depth_after, phase="decode",
                               payload=payload)
            elif kind == "prefill":
                # exactly one prompt per prefill dispatch: joining
                # sequences never evict or delay running decodes
                # beyond this single bucketed forward
                bucket = bucket_for(req.n, entry.buckets)
                try:
                    payload = entry.pack([req], bucket)
                except BaseException as exc:
                    self._fail_batch([req], exc)
                    self._gen_done(entry)
                    continue
                pack_ms = (time.perf_counter() - t0) * 1e3
                req.t_dispatch = time.perf_counter()
                batch = _Batch(entry, [req], bucket, req.n, pack_ms,
                               depth_after, phase="prefill",
                               payload=payload)
            else:
                bucket = bucket_for(total, entry.buckets)
                try:
                    payload = entry.pack(reqs, bucket)
                except BaseException as exc:
                    self._fail_batch(reqs, exc)
                    continue
                pack_ms = (time.perf_counter() - t0) * 1e3
                for req in reqs:
                    req.t_dispatch = time.perf_counter()
                batch = _Batch(entry, reqs, bucket, total, pack_ms,
                               depth_after)
            self._dispatch.submit(
                lambda b=batch, p=payload: self._launch(b, p))

    # -- pipeline stages ---------------------------------------------------

    def _gen_done(self, entry):
        """Clear a generative entry's in-flight gate (its next
        iteration becomes schedulable) and wake the scheduler."""
        with self._cv:
            self._gen_busy.discard(entry.name)
            self._cv.notify_all()

    def _launch(self, batch, payload):
        """Dispatch worker: asynchronous launch, then hand the handle to
        the unpack worker.  Runs on ONE thread, so batches reach the
        device in pack order."""
        try:
            # latency seam for the burn-rate drill: kind=slow:
            # seam=serve_dispatch sleeps here, inflating every request
            # in the batch exactly as a slow device would
            from ..resilience.faultinject import maybe_fault
            maybe_fault("serve_dispatch")
            handle = batch.entry.launch(payload, batch.bucket)
        except BaseException as exc:
            if batch.phase is not None:
                batch.entry.fail_inflight(exc, payload)
                self._gen_done(batch.entry)
            self._fail_batch(batch.requests, exc)
            return
        self._unpack.submit(lambda: self._finish(batch, handle))

    def _finish(self, batch, handle):
        """Unpack worker: block on the device arrays, slice results,
        complete futures, emit the per-batch ``serve`` record."""
        if batch.phase is not None:
            self._finish_generative(batch, handle)
            return
        try:
            results, phases = batch.entry.unpack(handle, batch.requests,
                                                 batch.bucket)
        except BaseException as exc:
            self._fail_batch(batch.requests, exc)
            return
        t_done = time.perf_counter()
        lat_ms, queue_wait = [], []
        for req, res in zip(batch.requests, results):
            req.t_done = t_done
            lat_ms.append((t_done - req.t_arrival) * 1e3)
            queue_wait.append((req.t_dispatch - req.t_arrival) * 1e3)
            req.future._set(res)
        occupancy = batch.n_samples / float(batch.bucket)
        waste = batch.entry.waste(batch.n_samples, batch.bucket)
        with self._cv:
            self._stats["requests"] += len(batch.requests)
            self._stats["samples"] += batch.n_samples
            self._stats["batches"] += 1
            self._stats["occupancy_sum"] += occupancy
            self._stats["waste_sum"] += waste
            self._lat_ms.extend(lat_ms)
            self._cv.notify_all()       # pipeline freed: scheduler may
            # have an eagerly-dispatchable batch waiting
        _tel.emit_batch(
            model=batch.entry.name, bucket=batch.bucket,
            n_requests=len(batch.requests), n_samples=batch.n_samples,
            occupancy=occupancy, padding_waste=waste,
            queue_depth=batch.queue_depth,
            queue_wait_ms=sum(queue_wait) / len(queue_wait),
            pack_ms=batch.pack_ms,
            device_ms=phases.get("device_ms"),
            unpack_ms=phases.get("unpack_ms"),
            lat_ms=lat_ms,
            trace_ids=[r.trace_id for r in batch.requests
                       if r.trace_id] or None)

    def _finish_generative(self, batch, handle):
        """Unpack worker, generative path: the entry settles its own
        sequences (streams, futures, block frees) and hands back the
        telemetry fields; the batcher keeps the ledger and re-opens
        the entry's iteration gate."""
        try:
            tel = batch.entry.complete(handle, batch)
        except BaseException as exc:
            batch.entry.fail_inflight(exc, batch.payload)
            self._fail_batch(batch.requests, exc)
            self._gen_done(batch.entry)
            return
        t_done = time.perf_counter()
        for req in batch.requests:
            req.t_done = t_done
        occupancy = batch.n_samples / float(batch.bucket)
        lat_ms = tel.get("lat_ms") or []
        with self._cv:
            self._stats["requests"] += len(lat_ms)   # finished seqs
            self._stats["samples"] += tel.get("tokens", 0)
            self._stats["batches"] += 1
            self._stats["occupancy_sum"] += occupancy
            self._lat_ms.extend(lat_ms)
            self._gen_busy.discard(batch.entry.name)
            self._cv.notify_all()
        queue_wait = [(r.t_dispatch - r.t_arrival) * 1e3
                      for r in batch.requests if r.t_dispatch]
        _tel.emit_batch(
            model=batch.entry.name, bucket=batch.bucket,
            n_requests=len(lat_ms),     # sequences FINISHED this step,
            n_samples=batch.n_samples,  # so qps = completions/sec
            occupancy=occupancy, padding_waste=1.0 - occupancy,
            queue_depth=batch.queue_depth,
            queue_wait_ms=(sum(queue_wait) / len(queue_wait)
                           if queue_wait else 0.0),
            pack_ms=batch.pack_ms,
            device_ms=tel.get("device_ms"),
            unpack_ms=tel.get("unpack_ms"),
            lat_ms=lat_ms or None,
            phase=batch.phase, tokens=tel.get("tokens"),
            kv_occupancy=tel.get("kv_occupancy"),
            ttft_ms=tel.get("ttft_ms") or None,
            itl_ms=tel.get("itl_ms") or None,
            dtype=tel.get("dtype"), kernel=tel.get("kernel"),
            trace_ids=[r.trace_id for r in batch.requests
                       if r.trace_id] or None)

    def _fail_batch(self, requests, exc):
        with self._lock:
            self._stats["failed"] += len(requests)
        for req in requests:
            req.future._fail(exc)

    # -- stats / lifecycle -------------------------------------------------

    def stats(self):
        """Snapshot of served/rejected counts, occupancy and padding
        waste means, and latency percentiles over the recent window."""
        from ..observability.counters import percentile
        with self._lock:
            s = dict(self._stats)
            lats = list(self._lat_ms)
            s["queue_depth"] = sum(len(q) for q in self._pending.values())
        batches = s.pop("occupancy_sum"), s.pop("waste_sum")
        if s["batches"]:
            s["occupancy"] = round(batches[0] / s["batches"], 4)
            s["padding_waste"] = round(batches[1] / s["batches"], 4)
        if lats:
            s["latency_ms"] = {
                "p50": round(percentile(lats, 50), 3),
                "p95": round(percentile(lats, 95), 3),
                "p99": round(percentile(lats, 99), 3),
                "mean": round(sum(lats) / len(lats), 3)}
        return s

    def drain(self, timeout=None):
        """Stop admission and flush every accepted request through the
        pipeline.  Returns once the queue is empty and both workers are
        idle; raises TimeoutError when ``timeout`` (seconds) expires."""
        if timeout is None:
            try:
                timeout = float(_os.environ.get(
                    "MXTPU_SERVE_DRAIN_TIMEOUT_S", "30"))
            except ValueError:
                timeout = 30.0
        deadline = time.monotonic() + timeout

        def busy():
            if any(q for q in self._pending.values()) or self._gen_busy:
                return True
            # active generations keep decoding while draining: flush
            # until every admitted sequence reaches EOS/length cap
            return any(getattr(e, "generative", False)
                       and e.has_decode_work()
                       for e in self._entries.values())

        with self._cv:
            self._accepting = False
            self._cv.notify_all()
            while busy():
                if not self._cv.wait(timeout=0.02):
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError("drain: requests still queued")
        self._dispatch.wait_all(timeout=max(deadline - time.monotonic(),
                                            0.1))
        self._unpack.wait_all(timeout=max(deadline - time.monotonic(),
                                          0.1))

    def close(self, drain=True, timeout=None):
        """Graceful shutdown: drain (unless told not to), stop the
        scheduler, close both workers.  Idempotent."""
        if drain and self._thread is not None:
            try:
                self.drain(timeout=timeout)
            except TimeoutError:
                pass
        with self._cv:
            self._stop = True
            self._accepting = False
            self._cv.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        self._dispatch.close()
        self._unpack.close()

    def __del__(self):
        try:
            self.close(drain=False)
        except Exception:
            pass
