"""Structured per-rank event log: append-only JSONL telemetry.

The port's copy of ``mxnet_tpu/observability/events.py``.  One change:
:func:`rank` asks ``torch.distributed`` where the JAX package asks jax.

The one sink every telemetry producer writes to.  Each record is one
JSON object per line carrying the correlation tuple ``run_id`` /
``rank`` / ``step`` / ``wall_ms`` plus a ``kind`` from the closed set
{``step``, ``span``, ``counter``, ``fault``, ``ckpt``, ``collective``,
``summary``} and kind-specific fields (schema: docs/observability.md).

Design constraints (docs/observability.md):

- **Off by default.**  Nothing is created, opened, or timed unless
  ``MXTPU_TELEMETRY=1`` or ``MXTPU_TELEMETRY_DIR`` is set; the
  disabled :func:`emit` is one cached boolean check.
- **Off the step path.**  :func:`emit` appends a tuple to an in-memory
  buffer (no serialization, no IO); a background daemon thread
  serializes and writes every ``_FLUSH_INTERVAL_S``, or sooner when
  the buffer passes the high-water mark.  :func:`flush` forces a
  synchronous drain (tests, exit paths).
- **Bounded.**  The per-rank file rotates at ``MXTPU_TELEMETRY_MAX_MB``
  (one ``.1`` predecessor kept), so a runaway loop can never fill a
  pod's shared scratch.
- **Per-rank files.**  ``events-rank00042.jsonl`` under the telemetry
  dir; ranks never contend on one file, and the aggregator/mxtop merge
  by reading the directory.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

__all__ = ["enabled", "telemetry_dir", "run_id", "rank", "get",
           "refresh", "emit", "flush", "last_fault", "EventLog", "KINDS"]

#: the closed set of record kinds (docs/observability.md); "elastic"
#: records are the re-mesh agreement trail (propose/adopt/resume with
#: generation stamps — docs/resilience.md "Elasticity"); "serve"
#: records are one-per-dispatched-batch serving telemetry
#: (docs/serving.md — queue_wait/pack/device/unpack phases, occupancy,
#: padding waste, per-request latencies); "retrace" records are the
#: retrace sentry's attributed post-warmup lowerings (docs/perf.md,
#: observability/retrace.py — the divergent cache-key ingredient, the
#: requesting site, component diffs); "slo_alert" records are the live
#: SLO engine's burn-rate alert edges (observability/sloengine.py —
#: tier, fire/clear, per-window burns; flight-ring automatic like
#: every emit)
KINDS = ("step", "span", "counter", "fault", "ckpt", "collective",
         "summary", "elastic", "serve", "retrace", "slo_alert")

_FLUSH_INTERVAL_S = 1.0
_HIGH_WATER = 256            # buffered records that trigger an early flush

_TRUE = ("1", "true", "on", "yes")
_FALSE = ("0", "false", "off", "no", "")


def enabled():
    """Telemetry on?  ``MXTPU_TELEMETRY`` wins; setting only
    ``MXTPU_TELEMETRY_DIR`` also enables (the common launcher idiom)."""
    raw = os.environ.get("MXTPU_TELEMETRY")
    if raw is not None:
        return raw.strip().lower() in _TRUE
    return bool(os.environ.get("MXTPU_TELEMETRY_DIR"))


def telemetry_dir():
    """Directory holding the per-rank JSONL files."""
    return os.environ.get("MXTPU_TELEMETRY_DIR") or \
        os.path.join(os.getcwd(), "mxtpu_telemetry")


def rank():
    """This process's rank: ``MXTPU_WORKER_RANK`` first (valid before
    the process group exists), then ``torch.distributed`` when a process
    group is initialised, then 0."""
    raw = os.environ.get("MXTPU_WORKER_RANK")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return 0


def _gen_run_id():
    return "%08x" % (int(time.time() * 1e3) ^ (os.getpid() << 16)
                     & 0xFFFFFFFF)


def run_id():
    """The run correlation id: ``MXTPU_RUN_ID`` (the launcher sets one
    id pod-wide) or a generated per-process hex stamp."""
    log = get()
    if log is not None:
        return log.run_id
    return os.environ.get("MXTPU_RUN_ID") or _gen_run_id()


def _max_bytes():
    try:
        mb = float(os.environ.get("MXTPU_TELEMETRY_MAX_MB", "64"))
    except ValueError:
        mb = 64.0
    return int(mb * 1024 * 1024)


class EventLog(object):
    """Buffered append-only JSONL writer for ONE rank.

    Use the module-level :func:`emit` in library code — it owns the
    process singleton and the enabled/disabled decision; construct an
    EventLog directly only in tests.
    """

    def __init__(self, directory, rank=0, run_id=None, max_bytes=None,
                 flush_interval_s=_FLUSH_INTERVAL_S,
                 high_water=_HIGH_WATER):
        self.directory = str(directory)
        self.rank = int(rank)
        self.run_id = run_id or os.environ.get("MXTPU_RUN_ID") \
            or _gen_run_id()
        self.max_bytes = _max_bytes() if max_bytes is None \
            else int(max_bytes)
        self.path = os.path.join(
            self.directory, "events-rank%05d.jsonl" % self.rank)
        self.flush_interval_s = flush_interval_s
        self.high_water = int(high_water)
        self.last_fault = None          # most recent fault record (dict)
        self._buf = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._fh = None
        self._thread = None
        os.makedirs(self.directory, exist_ok=True)

    # -- hot path ------------------------------------------------------
    def emit(self, kind, step=None, **fields):
        """Append one record.  No serialization, no IO — a tuple append
        plus a length check; the flusher thread does the rest."""
        # lock-free by design: list.append is GIL-atomic and flush()
        # drains via a single swap, so emitters never wait on json/IO
        self._buf.append(  # mxl: thread-shared-ok (MXL-Q001)
            (kind, step, time.time(), fields))
        if kind == "fault":
            self.last_fault = {"step": step, "wall_ms": None}
            self.last_fault.update(fields)
        if len(self._buf) >= self.high_water and not self._wake.is_set():
            self._wake.set()
        if self._thread is None:
            self._start_flusher()

    # -- flush machinery -----------------------------------------------
    def _start_flusher(self):
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="mxtpu-telemetry-rank%d" % self.rank)
            self._thread.start()
        atexit.register(self.close)

    def _run(self):
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            try:
                self.flush()
            except Exception:            # telemetry must never kill a job
                return

    def _serialize(self, kind, step, ts, fields):
        rec = {"run_id": self.run_id, "rank": self.rank, "kind": kind,
               "step": step, "wall_ms": int(ts * 1000.0)}
        rec.update(fields)
        return json.dumps(rec, default=str, separators=(",", ":"))

    def flush(self):
        """Synchronously drain the buffer to disk (rotating first if
        the file has outgrown ``max_bytes``)."""
        # swap the buffer under the GIL; serialization happens on the
        # drained copy so emitters never wait on json/IO
        buf, self._buf = self._buf, []
        if not buf:
            return
        lines = "".join(self._serialize(*rec) + "\n" for rec in buf)
        with self._lock:
            self._maybe_rotate()
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(lines)
            self._fh.flush()

    def _maybe_rotate(self):
        if self.max_bytes <= 0:
            return
        try:
            size = self._fh.tell() if self._fh is not None \
                else os.path.getsize(self.path)
        except OSError:
            return
        if size < self.max_bytes:
            return
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        old = self.path + ".1"
        try:
            if os.path.exists(old):
                os.remove(old)           # keep ONE predecessor: bounded
            os.rename(self.path, old)
        except OSError:
            pass

    def close(self):
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        try:
            self.flush()
        finally:
            with self._lock:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None


# ----------------------------------------------------------------------
# process singleton — rebuilt whenever the env-derived key changes.
# The env probe is rate-limited (once per _RECHECK_S) so the per-emit
# fast path is one clock read + one dict lookup; code that flips
# MXTPU_TELEMETRY* at runtime and needs the change NOW (tests) calls
# :func:`refresh`.
# ----------------------------------------------------------------------
_STATE = {"log": None, "key": None, "checked": -1.0}
_RECHECK_S = 1.0


def _env_key():
    return (enabled(), os.environ.get("MXTPU_TELEMETRY_DIR"),
            os.environ.get("MXTPU_RUN_ID"))


def get():
    """The process EventLog, or None when telemetry is off."""
    now = time.monotonic()
    if 0.0 <= now - _STATE["checked"] < _RECHECK_S:
        return _STATE["log"]
    _STATE["checked"] = now
    key = _env_key()
    if _STATE["key"] != key:
        old = _STATE["log"]
        if old is not None:
            try:
                old.close()
            except Exception:
                pass
        _STATE["log"] = EventLog(telemetry_dir(), rank=rank()) \
            if key[0] else None
        _STATE["key"] = key
    return _STATE["log"]


def refresh():
    """Re-derive the singleton from the environment immediately
    (bypasses the rate-limited recheck in :func:`get`)."""
    _STATE["checked"] = -1.0
    return get()


def emit(kind, step=None, **fields):
    """Record one event iff telemetry is enabled (the library seam —
    cheap no-op otherwise).  Every call ALSO lands in the crash flight
    recorder's bounded ring (:mod:`.flight`) first -- one deque append
    -- so a postmortem dump has the recent event tail even when
    telemetry never wrote a file."""
    _flight.note(kind, step, fields)
    log = get()
    if log is not None:
        log.emit(kind, step=step, **fields)


def flush():
    """Force-drain the buffer (exit paths, tests, bench emit points)."""
    log = _STATE["log"]
    if log is not None:
        log.flush()


def last_fault():
    """The most recent fault record emitted by THIS process, or None —
    ranks include it in their published pod summaries."""
    log = _STATE["log"]
    return log.last_fault if log is not None else None


from . import flight as _flight  # noqa: E402  (bottom: flight's lazy
#                                 events imports resolve against the
#                                 fully-defined module above)
