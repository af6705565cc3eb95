"""observability: the port's telemetry for serving.

Copies of ``mxnet_tpu/observability``'s host-only modules: the per-rank
JSONL event log (:mod:`.events`, off unless ``MXTPU_TELEMETRY=1`` or
``MXTPU_TELEMETRY_DIR`` is set), request trace ids (:mod:`.trace`,
``MXTPU_TRACE=1``), the canonical phase names (:mod:`.phases`), the
always-on metrics registry and its mergeable :class:`QuantileSketch`
(:mod:`.metrics`), the :func:`percentile` helper (:mod:`.counters`),
phase spans (:mod:`.spans`, NVTX ranges on a CUDA process), the crash
flight recorder (:mod:`.flight`: the always-on ring every
:func:`emit` and :func:`record_step` lands in, the pending-collective
ledger, the dump at the crash seams) and :func:`record_step`.
Cross-rank aggregation, SLO engines and the trainer counters belong to
the observability slice (``ROADMAP.md`` queue 1 item 4 (f)).
"""
from __future__ import annotations

from . import counters, events, metrics, phases, trace    # noqa: F401
from . import flight, spans                                 # noqa: F401
from .events import emit, enabled, flush, refresh, run_id  # noqa: F401
from .phases import PHASES, SERVE_PHASES, TRAIN_PHASES     # noqa: F401
from .counters import percentile, rel_spread               # noqa: F401
from .metrics import QuantileSketch, registry              # noqa: F401

__all__ = ["counters", "events", "flight", "metrics", "phases", "spans",
           "trace", "emit", "record_step",
           "enabled", "flush", "refresh", "run_id", "PHASES",
           "SERVE_PHASES", "TRAIN_PHASES", "percentile", "rel_spread",
           "QuantileSketch", "registry"]


def record_step(step, dur_s, batch_size=None, epoch=None, **fields):
    """The one call a training loop makes per step: the step lands in
    the crash flight recorder's bounded ring, and, when telemetry is on,
    the ``step`` record (``dur_ms``, ``batch_size``,
    ``samples_per_sec``, ``epoch`` and ``fields``) is emitted.  The JAX
    package also folds the timing into its process ``StepStats`` and
    publishes a summary to the coordination KV every 10 steps; both
    belong to the observability slice.  Never raises."""
    try:
        flight.note("step", step, {"dur_ms": round(float(dur_s) * 1e3, 3)})
    except Exception:
        pass
    log = events.get()
    if log is None:
        return
    try:
        rec = {"dur_ms": round(float(dur_s) * 1e3, 3)}
        if batch_size:
            rec["batch_size"] = batch_size
            if dur_s > 0:
                rec["samples_per_sec"] = round(batch_size / dur_s, 2)
        if epoch is not None:
            rec["epoch"] = epoch
        rec.update(fields)
        log.emit("step", step=step, **rec)
    except Exception:
        pass
