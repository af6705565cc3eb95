"""Phase spans: one name shared by the event log and the device trace.

The port's copy of ``mxnet_tpu/observability/spans.py``.
``span("data_wait")`` / ``span("step")`` / ``span("hotstate_snapshot")``
time a phase on the host and (a) append a ``span`` record to the event
log, (b) when the process has a CUDA context, push the same name as an
NVTX range (``torch.cuda.nvtx``), so a profiler trace of the card
carries identical region names.

When telemetry is off, ``span()`` returns a shared null context: zero
allocation, zero timing.
"""
from __future__ import annotations

import time

import torch

from . import events
from . import trace as _trace
from .phases import TRAIN_PHASES

__all__ = ["span", "SPAN_NAMES", "timed_iter", "overlap_report"]

#: canonical phase names (free-form names are allowed); the ONE
#: definition lives in :mod:`.phases`.
SPAN_NAMES = TRAIN_PHASES


class _NullSpan(object):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _on_cuda():
    """Does this process drive a CUDA device?  Only then is there a
    device trace to carry NVTX ranges (no context is created here)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class _Span(object):
    __slots__ = ("name", "step", "fields", "_t0", "_nvtx", "_ids")

    def __init__(self, name, step, fields):
        self.name = name
        self.step = step
        self.fields = fields
        self._t0 = None
        self._nvtx = False
        self._ids = None

    def __enter__(self):
        self._nvtx = _on_cuda()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        # MXTPU_TRACE=1: push a trace frame so this span carries
        # trace/span/parent ids and emits inside it bind to it
        self._ids = _trace.begin_span(self.name) or None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        if self._ids is not None:
            _trace.end_span()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        events.emit("span", step=self.step, name=self.name,
                    dur_ms=round(dur_ms, 3), **(self._ids or {}),
                    **self.fields)
        return False


def span(name, step=None, **fields):
    """Context manager timing one phase.  Null (free) when telemetry is
    off; otherwise records a ``span`` event (and an NVTX range on a
    CUDA process)."""
    if events.get() is None:
        return _NULL
    return _Span(name, step, fields)


def timed_iter(iterable, name="data_wait", step_from=None):
    """Pass-through generator that times each ``next()`` under ``span``
    — the input-pipeline wait the fit loops can't see otherwise.  Plain
    iteration (no timing) when telemetry is off.

    ``step_from``: optional zero-arg callable giving the step to tag
    each span with (called per batch, AFTER the fetch).
    """
    if events.get() is None:
        for item in iterable:
            yield item
        return
    it = iter(iterable)
    while True:
        ids = _trace.begin_span(name)
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            if ids:
                _trace.end_span()
            return
        dur_ms = (time.perf_counter() - t0) * 1e3
        if ids:
            _trace.end_span()
        events.emit("span", name=name,
                    step=step_from() if step_from is not None else None,
                    dur_ms=round(dur_ms, 3), **ids)
        yield item


def overlap_report(records, phases=("data_wait", "h2d")):
    """Did the async machinery actually overlap?  From merged event
    records (any list of event-record dicts), compute per-rank and pod-wide::

        overlap_ratio = serial_ms / wall_ms

    where ``serial_ms`` sums every ``phases`` span PLUS every ``step``
    record's duration inside the steady-state window, and ``wall_ms``
    is the elapsed wall clock between the rank's first and last
    ``step`` record.  The first step record bounds the window but is
    excluded from the sums, so compile time never pollutes the ratio.

    Serial execution: phases and steps tile the wall exactly, ratio
    ≈ 1.0 (slightly below — metric/callback time belongs to no phase).
    With the async feed on, the producer thread's ``data_wait``/``h2d``
    spans run DURING device compute, the same host time is counted in
    two phases, and the ratio rises above 1 — "wall < Σ phases" is the
    proof the dead time went under the step.  ``phases`` deliberately
    excludes ``allreduce``/``kv_barrier``: those spans nest inside the
    ``step`` record's window and would double-count serially.

    Returns ``{"overlap_ratio", "wall_ms", "serial_ms", "steps",
    "phase_ms": {phase: total}, "phase_p50_ms": {phase: p50},
    "per_rank": {rank: {...same shape...}}}``; ratios are None when a
    rank has fewer than two step records.
    """
    per_rank_events = {}
    for rec in records:
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        if kind not in ("span", "step"):
            continue
        per_rank_events.setdefault(rec.get("rank") or 0, []).append(rec)

    def _p50(vals):
        vals = sorted(vals)
        n = len(vals)
        if not n:
            return None
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    per_rank = {}
    tot_wall = tot_serial = tot_steps = 0.0
    pod_phase = {}
    pod_phase_durs = {}
    for rank, recs in sorted(per_rank_events.items()):
        steps = [r for r in recs if r.get("kind") == "step"
                 and r.get("wall_ms") is not None
                 and r.get("dur_ms") is not None]
        steps.sort(key=lambda r: r["wall_ms"])
        entry = {"overlap_ratio": None, "wall_ms": None, "serial_ms": None,
                 "steps": len(steps), "phase_ms": {}, "phase_p50_ms": {}}
        per_rank[rank] = entry
        if len(steps) < 2:
            continue
        t0, t1 = steps[0]["wall_ms"], steps[-1]["wall_ms"]
        wall = float(t1) - float(t0)
        if wall <= 0:
            continue
        serial = sum(float(r["dur_ms"]) for r in steps[1:])
        phase_durs = {}
        for r in recs:
            if r.get("kind") != "span" or r.get("name") not in phases:
                continue
            w = r.get("wall_ms")
            if w is None or not (t0 < w <= t1):
                continue
            d = float(r.get("dur_ms") or 0.0)
            serial += d
            phase_durs.setdefault(r["name"], []).append(d)
        entry.update(
            wall_ms=round(wall, 3), serial_ms=round(serial, 3),
            overlap_ratio=round(serial / wall, 4),
            phase_ms={k: round(sum(v), 3)
                      for k, v in sorted(phase_durs.items())},
            phase_p50_ms={k: round(_p50(v), 3)
                          for k, v in sorted(phase_durs.items())})
        tot_wall += wall
        tot_serial += serial
        tot_steps += len(steps)
        for k, v in phase_durs.items():
            pod_phase[k] = pod_phase.get(k, 0.0) + sum(v)
            pod_phase_durs.setdefault(k, []).extend(v)
    return {
        "overlap_ratio": round(tot_serial / tot_wall, 4) if tot_wall else None,
        "wall_ms": round(tot_wall, 3) if tot_wall else None,
        "serial_ms": round(tot_serial, 3) if tot_wall else None,
        "steps": int(tot_steps),
        "phase_ms": {k: round(v, 3) for k, v in sorted(pod_phase.items())},
        "phase_p50_ms": {k: round(_p50(v), 3)
                         for k, v in sorted(pod_phase_durs.items())},
        "per_rank": per_rank,
    }
