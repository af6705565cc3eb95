"""Crash flight recorder: always-on ring buffer + pending-collective
ledger, dumped at the crash seams.

The port's copy of ``mxnet_tpu/observability/flight.py``, unchanged but
for this paragraph: the ring, the ledger, and the dump's file name and
fields are the JAX package's.

The PyTorch collective-flight-recorder shape, grown for this tree's
failure mode: a pod wedges in an allreduce, the watchdog fires exit 3,
and the postmortem question is *which rank never launched seq K* — but
``MXTPU_TELEMETRY`` was off, so there is no event log.  This module is
the always-on answer:

- a bounded in-memory ring of the last ``MXTPU_FLIGHT_DEPTH`` (default
  512, ``0`` disables) events — every record that flows through
  :func:`events.emit` and :func:`observability.record_step` lands here
  FIRST, before (and regardless of) the telemetry-enabled check.  One
  ``deque.append`` of a tuple: allocation-bounded, no locks, no IO.
- a pending-collective ledger: :func:`collective_begin` records (op,
  seq, participants, launch wall time) when a collective is handed to
  the runtime, :func:`collective_end` retires it.  A hung collective is
  exactly an entry that never retired.
- :func:`dump`: serialize ring + ledger (+ a best-effort liveness probe
  naming the absent ranks) to ``MXTPU_TELEMETRY_DIR`` or a tmp
  fallback.  Wired into every crash seam: watchdog timeout/stall,
  sentinel escalation, ``exit_for_restart``/``exit_for_remesh``, the
  ResilienceError excepthook, and SIGTERM.

The ring records the same tuples :class:`events.EventLog` buffers, so
a dump reads like a tail of the event log even for runs that never had
one.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback

from . import trace as _trace

__all__ = ["depth", "get", "reset", "note", "collective_begin",
           "collective_end", "pending_collectives", "dump",
           "set_liveness_probe", "dump_dir", "thread_stacks",
           "FlightRecorder"]

_DEFAULT_DEPTH = 512


def depth():
    """``MXTPU_FLIGHT_DEPTH``: ring capacity in events (default 512;
    ``0`` disables the recorder entirely)."""
    raw = os.environ.get("MXTPU_FLIGHT_DEPTH", "")
    try:
        return int(raw) if raw.strip() else _DEFAULT_DEPTH
    except ValueError:
        return _DEFAULT_DEPTH


def dump_dir():
    """Where dumps land: the telemetry dir when one is configured
    (even with ``MXTPU_TELEMETRY=0`` — the operator named a scratch
    path; use it), else a per-user tmp fallback that needs no setup."""
    configured = os.environ.get("MXTPU_TELEMETRY_DIR")
    if configured:
        return configured
    from . import events
    if events.enabled():
        return events.telemetry_dir()
    return os.path.join(tempfile.gettempdir(), "mxtpu-flight")


def thread_stacks():
    """Every live thread's current frames — the "who is holding the
    wedged lock" half of a watchdog postmortem.  Pairs
    ``sys._current_frames()`` with ``threading.enumerate()`` so each
    stack carries the thread's name/daemon flag; threads the interpreter
    knows but :mod:`threading` doesn't (C-spawned) appear by ident
    only."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        out.append({
            "name": t.name if t is not None else "<non-python>",
            "ident": ident,
            "daemon": bool(t.daemon) if t is not None else None,
            "current": ident == threading.get_ident(),
            "stack": "".join(traceback.format_stack(frame)),
        })
    out.sort(key=lambda rec: (not rec["current"], rec["name"]))
    return out


class FlightRecorder(object):
    """Ring + ledger for ONE process (use the module-level functions in
    library code; construct directly only in tests)."""

    def __init__(self, depth=_DEFAULT_DEPTH):
        self.depth = int(depth)
        self._ring = collections.deque(maxlen=max(self.depth, 1))
        self._pending = {}          # (op, seq) -> ledger entry
        self._lock = threading.Lock()
        self._probe = None          # zero-arg -> absent rank list
        self.dumps = 0

    # -- hot path (one thread-safe deque append) -----------------------
    def note(self, kind, step, fields):
        self._ring.append((time.time(), kind, step, fields))

    # -- collective ledger ---------------------------------------------
    def collective_begin(self, op, seq, participants=None, **fields):
        entry = {"op": op, "seq": seq, "launch_wall_ms":
                 int(time.time() * 1000.0)}
        if participants is not None:
            entry["participants"] = list(participants)
        entry.update(fields)
        with self._lock:
            self._pending[(op, seq)] = entry
        return entry

    def collective_end(self, op, seq):
        with self._lock:
            self._pending.pop((op, seq), None)

    def pending_collectives(self):
        """Launched-but-unretired collectives, oldest first."""
        with self._lock:
            entries = list(self._pending.values())
        return sorted(entries, key=lambda e: e["launch_wall_ms"])

    def set_liveness_probe(self, probe):
        """Register a zero-arg callable naming the absent ranks (the
        kvstore wires ``dead_nodes`` here at ``create('dist_*')``)."""
        self._probe = probe

    # -- the postmortem artifact ---------------------------------------
    def snapshot(self, reason=None):
        from . import events
        now = time.time()
        recs = []
        for ts, kind, step, fields in list(self._ring):
            rec = {"kind": kind, "step": step,
                   "wall_ms": int(ts * 1000.0)}
            if fields:
                rec.update(fields)
            recs.append(rec)
        pend = self.pending_collectives()
        doc = {"reason": reason, "rank": events.rank(),
               "run_id": events.run_id(),
               "wall_ms": int(now * 1000.0), "depth": self.depth,
               "collective_seq": _trace.seq_snapshot(),
               "pending_collectives": [
                   dict(e, age_ms=int(now * 1000.0) - e["launch_wall_ms"])
                   for e in pend],
               "events": recs}
        if self._probe is not None:
            try:
                doc["absent_ranks"] = sorted(self._probe())
            except Exception:
                doc["absent_ranks"] = None
        try:
            doc["threads"] = thread_stacks()
        except Exception:
            doc["threads"] = None
        return doc

    def dump(self, reason, directory=None, extra=None):
        """Write the snapshot to ``<dir>/flight-rank%05d-%d.json`` and
        return the path (None on failure — a dump must never turn a
        crash into a different crash)."""
        try:
            doc = self.snapshot(reason=reason)
            if extra:
                doc.update(extra)
            directory = directory or dump_dir()
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, "flight-rank%05d-%d.json"
                                % (doc["rank"], self.dumps))
            self.dumps += 1
            with open(path + ".tmp", "w") as fout:
                json.dump(doc, fout, default=str, indent=1)
            os.replace(path + ".tmp", path)
            print("FLIGHT RECORDER: dumped %d events, %d pending "
                  "collective(s) to %s (reason: %s)"
                  % (len(doc["events"]),
                     len(doc["pending_collectives"]), path, reason),
                  file=sys.stderr, flush=True)
            return path
        except Exception:
            return None


# ----------------------------------------------------------------------
# process singleton
# ----------------------------------------------------------------------
_STATE = {"rec": None, "depth": None}
_SIG = {"installed": False}


def get():
    """The process FlightRecorder, or None when ``MXTPU_FLIGHT_DEPTH=0``.
    The depth env is read once at first use (:func:`reset` re-reads)."""
    if _STATE["depth"] is None:
        _STATE["depth"] = depth()
        if _STATE["depth"] > 0:
            _STATE["rec"] = FlightRecorder(_STATE["depth"])
    if _STATE["rec"] is not None:
        _install_sigterm()      # no-op once installed; retries when the
    return _STATE["rec"]        # first get() ran off the main thread


def reset():
    """Drop the singleton and re-read ``MXTPU_FLIGHT_DEPTH`` (tests)."""
    _STATE["rec"] = None
    _STATE["depth"] = None
    return get()


def note(kind, step, fields):
    """Ring-append one event (the :func:`events.emit` hook — called on
    every emit whether or not telemetry is enabled)."""
    rec = _STATE["rec"]
    if rec is None:
        if _STATE["depth"] is None:
            rec = get()
        if rec is None:
            return
    rec.note(kind, step, fields)


def collective_begin(op, seq, participants=None, **fields):
    rec = get()
    if rec is not None:
        rec.collective_begin(op, seq, participants=participants, **fields)


def collective_end(op, seq):
    rec = _STATE["rec"]
    if rec is not None:
        rec.collective_end(op, seq)


def pending_collectives():
    rec = _STATE["rec"]
    return rec.pending_collectives() if rec is not None else []


def set_liveness_probe(probe):
    rec = get()
    if rec is not None:
        rec.set_liveness_probe(probe)


def dump(reason, directory=None, extra=None):
    """Dump the singleton's snapshot (None when disabled/failed)."""
    rec = get()
    if rec is None:
        return None
    return rec.dump(reason, directory=directory, extra=extra)


def _install_sigterm():
    """Chain a SIGTERM handler that dumps before the previous behavior
    runs (the serving drain handler, the default kill).  Main-thread
    only (signal API constraint); a later main-thread get() retries."""
    if _SIG["installed"]:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            dump("sigterm")
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_term)
        _SIG["installed"] = True
    except (ValueError, OSError):       # non-main thread / exotic host
        pass
