"""Derived counters: the port's copy of :func:`percentile` and
:func:`rel_spread` from ``mxnet_tpu/observability/counters.py``.

The trainer's step statistics, MFU and roofline counters there read the
JAX device and cost model; they come with the observability slice.
"""
from __future__ import annotations

__all__ = ["percentile", "rel_spread"]


def percentile(values, pct):
    """Nearest-rank percentile of a sequence (no numpy on the hot
    path); None for an empty input."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    idx = max(0, min(len(vals) - 1,
                     int(round(pct / 100.0 * (len(vals) - 1)))))
    return vals[idx]


def rel_spread(values):
    """Robust relative spread of a metric series: median absolute
    deviation over |median| (0.0 for <2 samples or a zero median).
    The noise estimate the SLO sentry (:mod:`.slo`) widens its
    regression thresholds by — MAD, not stddev, because a bench
    trajectory routinely contains one wild outlier round."""
    vals = [float(v) for v in values if v is not None]
    if len(vals) < 2:
        return 0.0
    med = percentile(vals, 50)
    if not med:
        return 0.0
    mad = percentile([abs(v - med) for v in vals], 50)
    return abs(mad / med)
