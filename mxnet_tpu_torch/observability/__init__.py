"""observability: the port's telemetry for serving.

Copies of ``mxnet_tpu/observability``'s host-only modules: the per-rank
JSONL event log (:mod:`.events`, off unless ``MXTPU_TELEMETRY=1`` or
``MXTPU_TELEMETRY_DIR`` is set), request trace ids (:mod:`.trace`,
``MXTPU_TRACE=1``), the canonical phase names (:mod:`.phases`), the
always-on metrics registry and its mergeable :class:`QuantileSketch`
(:mod:`.metrics`) and the :func:`percentile` helper (:mod:`.counters`).
Spans, cross-rank aggregation, the flight recorder, SLO engines and the
trainer counters belong to the observability slice (``ROADMAP.md``).
"""
from __future__ import annotations

from . import counters, events, metrics, phases, trace    # noqa: F401
from .events import emit, enabled, flush, refresh, run_id  # noqa: F401
from .phases import PHASES, SERVE_PHASES, TRAIN_PHASES     # noqa: F401
from .counters import percentile, rel_spread               # noqa: F401
from .metrics import QuantileSketch, registry              # noqa: F401

__all__ = ["counters", "events", "metrics", "phases", "trace", "emit",
           "enabled", "flush", "refresh", "run_id", "PHASES",
           "SERVE_PHASES", "TRAIN_PHASES", "percentile", "rel_spread",
           "QuantileSketch", "registry"]
