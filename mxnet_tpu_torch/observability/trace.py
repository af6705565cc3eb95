"""Dapper-style trace/span ids over the existing telemetry events.

The port's copy of ``mxnet_tpu/observability/trace.py`` (host code
only, unchanged).

``MXTPU_TRACE=1`` threads three id fields through every span record the
tree already emits (serving request -> queue -> pack -> device ->
unpack; training ``data_wait``/``h2d``/``step``/``allreduce`` per
rank):

- ``trace_id`` — one id per logical unit of work (a training thread's
  run, a serving request),
- ``span_id`` — unique per span,
- ``parent_span`` — the enclosing span on the same thread, so nesting
  (``allreduce`` inside ``step``) reconstructs without timestamps.

Ids are maintained on a per-thread stack: :func:`begin_span` pushes,
:func:`end_span` pops, :func:`ids` reads the current frame for emits
that happen *inside* a span (the kvstore's ``collective`` record binds
to the enclosing ``allreduce`` span this way).

Cross-RANK stitching deliberately does not use trace ids (no rank ever
sees a peer's ids): each collective launch is tagged with a
**per-op sequence number** from :func:`next_seq`.  Launch order is
rank-uniform by construction (``@collective_seam`` — bucket layout and
the single-FIFO launcher make every rank run the same collectives in
the same order), so ``(op, seq)`` names the same physical collective
on every rank.  ``tools/mxtrace.py`` turns matching ``(op, seq)``
pairs into Chrome-trace flow arrows; ``flight.py`` keys its
pending-collective ledger on them.

Overhead: :func:`enabled` is one cached env probe (same rate-limited
pattern as :mod:`.events`); everything else is a couple of dict ops on
a ``threading.local``.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["enabled", "refresh", "new_id", "begin_span", "end_span",
           "ids", "current_trace", "set_trace", "clear_trace",
           "next_seq", "seq_snapshot"]

_TRUE = ("1", "true", "on", "yes")

# rate-limited env probe (mirrors events._STATE: the per-span fast
# path must not hit os.environ every call)
_STATE = {"on": False, "checked": -1.0}
_RECHECK_S = 1.0


def enabled():
    """Tracing on?  (``MXTPU_TRACE`` truthy; cached ~1s like the event
    log's env probe — tests flipping the env call :func:`refresh`.)"""
    now = time.monotonic()
    if 0.0 <= now - _STATE["checked"] < _RECHECK_S:
        return _STATE["on"]
    _STATE["checked"] = now
    raw = os.environ.get("MXTPU_TRACE")
    _STATE["on"] = raw is not None and raw.strip().lower() in _TRUE
    return _STATE["on"]


def refresh():
    """Re-probe ``MXTPU_TRACE`` immediately."""
    _STATE["checked"] = -1.0
    return enabled()


# ----------------------------------------------------------------------
# id generation + per-thread span stack
# ----------------------------------------------------------------------
_local = threading.local()
_COUNT_LOCK = threading.Lock()
_COUNTER = [0]


def new_id():
    """A fresh 64-bit hex id: wall-clock + pid + a process counter —
    unique across the pod without coordination (ranks differ by pid
    and clock; threads by the counter)."""
    with _COUNT_LOCK:
        _COUNTER[0] += 1
        n = _COUNTER[0]
    return "%016x" % (((int(time.time() * 1e6) & 0xFFFFFFFF) << 32)
                      ^ (os.getpid() << 16) ^ n)


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_trace():
    """This thread's trace id, creating one on first use (a training
    thread is one trace unless :func:`set_trace` scoped it)."""
    tid = getattr(_local, "trace_id", None)
    if tid is None:
        tid = _local.trace_id = new_id()
    return tid


def set_trace(trace_id):
    """Adopt ``trace_id`` as this thread's current trace (serving: the
    batch adopts the head request's trace).  Returns the previous id
    (or None) so the caller can restore it."""
    prev = getattr(_local, "trace_id", None)
    _local.trace_id = trace_id
    return prev


def clear_trace(prev=None):
    """Restore the thread's trace id (pair with :func:`set_trace`)."""
    _local.trace_id = prev


def begin_span(name):
    """Push a span frame; returns its id fields (the dict the span
    record will carry).  No-op returning ``{}`` when tracing is off."""
    if not enabled():
        return {}
    st = _stack()
    frame = {"trace_id": current_trace(), "span_id": new_id()}
    if st:
        frame["parent_span"] = st[-1]["span_id"]
    st.append(frame)
    return dict(frame)


def end_span():
    """Pop the innermost span frame (never raises on imbalance)."""
    st = _stack()
    if st:
        st.pop()


def ids():
    """Id fields binding an emit to the ENCLOSING span on this thread
    (``{}`` when tracing is off or no span is open).  The kvstore's
    ``collective`` record uses this to live inside its ``allreduce``
    span in the merged trace."""
    if not enabled():
        return {}
    st = _stack()
    if not st:
        return {"trace_id": current_trace()}
    top = st[-1]
    return {"trace_id": top["trace_id"], "span_id": top["span_id"]}


# ----------------------------------------------------------------------
# rank-uniform collective sequence numbers
# ----------------------------------------------------------------------
_SEQ_LOCK = threading.Lock()
_SEQ = {}


def next_seq(op):
    """The next sequence number for collective kind ``op`` (0-based,
    process-global, always on — the flight recorder needs it with
    telemetry off).  Rank-uniform because every rank launches the same
    collectives in the same order (``@collective_seam`` invariant), so
    ``(op, seq)`` identifies ONE pod-wide collective."""
    with _SEQ_LOCK:
        n = _SEQ.get(op, 0)
        _SEQ[op] = n + 1
        return n


def seq_snapshot():
    """{op: count issued so far} — flight dumps include it so "rank 3
    is one allreduce behind" is readable straight off two dumps."""
    with _SEQ_LOCK:
        return dict(_SEQ)
