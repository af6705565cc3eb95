"""Canonical phase-name registry: the ONE place a phase is named.

The port's copy of ``mxnet_tpu/observability/phases.py`` (host code
only, unchanged).

Before this module, the training phase names lived in
``spans.SPAN_NAMES``, the serving phase names were implicit in the
``serve`` record's ``*_ms`` field names, and ``tools/parse_log.py``
re-derived its column names from both — three copies that could (and
in review almost did) drift.  Everything now imports from here:

- :mod:`.spans` re-exports :data:`TRAIN_PHASES` as ``SPAN_NAMES``
  (compat alias) and the fit/trainer/kvstore wiring uses the named
  constants,
- :mod:`mxnet_tpu.profiler` exposes the same :data:`PHASES` so an
  xprof region name and an event-log span name can never disagree,
- :mod:`mxnet_tpu.serving.telemetry` derives its per-phase ``*_ms``
  fields from :data:`SERVE_PHASES`,
- ``tools/parse_log.py`` builds its serve phase columns from the same
  tuple.

Free-form span names remain legal everywhere (``span("my_phase")``
works); the registry fixes the *built-in* names, it does not close the
namespace.
"""
from __future__ import annotations

__all__ = ["TRAIN_PHASES", "SERVE_PHASES", "PHASES", "is_canonical",
           "DATA_WAIT", "H2D", "STEP", "ALLREDUCE", "KV_BARRIER",
           "CKPT_SAVE", "EVAL", "HOTSTATE_SNAPSHOT", "WARM_RESUME",
           "QUEUE_WAIT", "PACK", "DEVICE", "UNPACK"]

#: phases the training wiring emits (fit loops, ShardedTrainer, kvstore,
#: and the warm-elasticity transition: host offload + warm assembly)
TRAIN_PHASES = ("data_wait", "h2d", "step", "allreduce", "kv_barrier",
                "ckpt_save", "eval", "hotstate_snapshot", "warm_resume")

#: request-visible serving phases, in pipeline order (docs/serving.md)
SERVE_PHASES = ("queue_wait", "pack", "device", "unpack")

#: every built-in phase name, training first then serving
PHASES = TRAIN_PHASES + SERVE_PHASES

(DATA_WAIT, H2D, STEP, ALLREDUCE, KV_BARRIER, CKPT_SAVE, EVAL,
 HOTSTATE_SNAPSHOT, WARM_RESUME) = TRAIN_PHASES
(QUEUE_WAIT, PACK, DEVICE, UNPACK) = SERVE_PHASES

_CANON = frozenset(PHASES)


def is_canonical(name):
    """Is ``name`` one of the built-in phase names?"""
    return name in _CANON
