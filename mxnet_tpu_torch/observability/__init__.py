"""observability: the port's telemetry.

Copies of ``mxnet_tpu/observability``'s modules: the per-rank JSONL
event log (:mod:`.events`, off unless ``MXTPU_TELEMETRY=1`` or
``MXTPU_TELEMETRY_DIR`` is set), request trace ids (:mod:`.trace`,
``MXTPU_TRACE=1``), the canonical phase names (:mod:`.phases`), the
always-on metrics registry and its mergeable :class:`QuantileSketch`
(:mod:`.metrics`), phase spans (:mod:`.spans`, NVTX ranges on a CUDA
process), the crash flight recorder (:mod:`.flight`), the step
statistics and MFU at the card's own peak (:mod:`.counters`), the pod
aggregate over the coordination KV and the telemetry dir
(:mod:`.aggregate`, what ``python -m mxnet_tpu_torch.tools.mxtop``
renders), the perf-regression sentry over a bench trajectory
(:mod:`.slo`, ``python -m mxnet_tpu_torch.tools.benchdiff``), the live
burn-rate SLO engine (:mod:`.sloengine`, ``MXTPU_SLO_SPEC``), the
retrace sentry (:mod:`.retrace`, ``MXTPU_RETRACE_SENTRY=1``) and the
lock-order sanitizer (:mod:`.locktrace`, ``MXTPU_LOCKCHECK=1``).

The fit loops, the trainer, the kvstore and the resilience seams call
:func:`record_step` and :func:`spans.span`; both are cheap no-ops when
telemetry is off.
"""
from __future__ import annotations

from . import (events, spans, counters, aggregate, phases, trace,  # noqa
               flight, slo, locktrace, retrace, metrics, sloengine)
from .events import (enabled, emit, flush, refresh, run_id,  # noqa: F401
                     last_fault, EventLog)
from .phases import PHASES, TRAIN_PHASES, SERVE_PHASES     # noqa: F401
from .spans import span, timed_iter, SPAN_NAMES, overlap_report  # noqa
from .counters import (StepStats, percentile, rel_spread,  # noqa: F401
                       global_stats, emit_trainer_counters,
                       emit_sentinel_counters)
from .aggregate import (publish_summary, collect_summaries,  # noqa: F401
                        heartbeat_ages, pod_view, read_events,
                        build_report, EventTailer)
from .metrics import QuantileSketch, registry              # noqa: F401

__all__ = [
    "events", "spans", "counters", "aggregate", "phases", "trace",
    "flight", "slo", "locktrace", "retrace", "metrics", "sloengine",
    "enabled", "emit", "flush", "refresh", "run_id", "last_fault",
    "EventLog",
    "PHASES", "TRAIN_PHASES", "SERVE_PHASES",
    "span", "timed_iter", "SPAN_NAMES", "overlap_report",
    "StepStats", "percentile", "rel_spread", "global_stats",
    "emit_trainer_counters", "emit_sentinel_counters",
    "publish_summary", "collect_summaries", "heartbeat_ages",
    "pod_view", "read_events", "build_report", "EventTailer",
    "QuantileSketch", "registry", "record_step",
]

#: publish a KV summary every N recorded steps
_PUBLISH_EVERY = 10


def record_step(step, dur_s, batch_size=None, epoch=None, **fields):
    """The one call a training loop makes per step when telemetry is
    on: emits the ``step`` record, folds the timing into the process
    :class:`StepStats`, and every ``_PUBLISH_EVERY`` steps pushes the
    compact summary to the coordination KV for the live pod view.
    No-op when telemetry is off (the step still lands in the crash
    flight recorder's bounded ring); never raises."""
    try:
        flight.note("step", step, {"dur_ms": round(float(dur_s) * 1e3, 3)})
    except Exception:
        pass
    log = events.get()
    if log is None:
        return
    try:
        stats = counters.global_stats()
        stats.observe(dur_s, step=step, batch_size=batch_size)
        rec = {"dur_ms": round(float(dur_s) * 1e3, 3)}
        if batch_size:
            rec["batch_size"] = batch_size
            if dur_s > 0:
                rec["samples_per_sec"] = round(batch_size / dur_s, 2)
        if epoch is not None:
            rec["epoch"] = epoch
        rec.update(fields)
        log.emit("step", step=step, **rec)
        if step is not None and step % _PUBLISH_EVERY == 0:
            aggregate.publish_summary(step=step)
    except Exception:
        pass
