"""Perf-regression sentry: counters vs the committed bench trajectory.

The port's copy of ``mxnet_tpu/observability/slo.py`` (host code only,
unchanged).  The committed ``BENCH_*.json`` are the JAX package's TPU
records: they are no baseline for the port's numbers; point
``MXTPU_SLO_BASELINE`` (or ``--baseline``) at the port's own.

The repo commits one ``BENCH_*.json`` per PR round — a trajectory of
the numbers that must not silently regress (step time, images/sec,
allreduce time, transformer throughput) — and the telemetry stack
derives the live counterparts (step p50/p95, overlap_ratio, serving
padding waste, samples/sec).  Nothing compared them.  This module is
the comparison:

- :func:`load_bench` / :func:`load_trajectory` read the committed
  ``BENCH_*.json`` schema (``{"parsed": {...}, "rc": 0}``) into flat
  metric dicts; failed rounds (``rc != 0`` / null ``parsed``) are
  skipped, not fatal.
- :func:`telemetry_metrics` derives the same metric names from a
  merged telemetry report (``aggregate.build_report`` output), so a
  run's event dir can be diffed against a bench baseline directly.
- :func:`compare` applies **noise-aware thresholds**: a metric must
  move more than ``max(min_rel, sigma * rel_spread(trajectory))`` in
  its bad direction to count — a 10% floor keeps toy diffs quiet, the
  MAD-based spread keeps a historically-jittery metric (CPU-fallback
  images/sec swings round to round) from crying wolf.
- :func:`emit_regressions` records each finding as a structured
  ``perf_regression`` fault event, so regressions land in the mxtop
  incident timeline and the flight recorder like any other fault.

``python -m mxnet_tpu_torch.tools.benchdiff`` is the CLI/CI gate over
this module (nonzero exit on any regression). ``MXTPU_SLO_BASELINE``
names the default baseline file or glob (default: ``BENCH_*.json`` in
the repo root).
"""
from __future__ import annotations

import glob as _glob
import json
import os

from . import events
from .counters import rel_spread

__all__ = ["DIRECTIONS", "ZERO_ALERT", "baseline_spec", "load_bench",
           "load_trajectory", "telemetry_metrics", "trajectory_noise",
           "compare", "emit_regressions"]

#: metric -> which way is WORSE ("up" = a larger value is a
#: regression).  Only named metrics are compared; unknown keys in a
#: baseline are ignored rather than guessed at.
DIRECTIONS = {
    "step_time_ms": "up",
    "step_ms_p50": "up",
    "step_ms_p95": "up",
    "allreduce_time_ms": "up",
    "transformer_step_ms": "up",
    "serve_padding_waste": "up",
    "serve_ms_p95": "up",
    "serve_ttft_ms_p95": "up",
    "serve_itl_ms_p95": "up",
    "serve_tokens_per_sec": "down",
    "images_per_sec": "down",
    "module_path_images_per_sec": "down",
    "transformer_tokens_per_sec": "down",
    "samples_per_sec": "down",
    "serve_qps": "down",
    "overlap_ratio": "down",
    "mfu": "down",
    "allreduce_gbps": "down",
    # open-loop traffic realism (serve_bench --arrival / --tenant-mix):
    # achieved completion rate under the shaped offered load, and the
    # offered-minus-achieved deficit fraction (0 = the server kept up)
    "serve_achieved_rps": "down",
    "serve_rate_deficit": "up",
    # fleet serving (serve_bench --fleet / docs/serving.md "Fleet")
    "fleet_rps": "down",
    "fleet_balance_ratio": "up",
    "fleet_swap_pause_ms_p95": "up",
    "fleet_straggler_gap_ms": "up",
    # retrace sentry (observability/retrace.py): the steady-state
    # contract is exactly zero, so these sit in ZERO_ALERT too — any
    # nonzero value against a zero baseline flags regardless of the
    # relative-threshold math
    "retraces_after_warmup": "up",
    "lowerings_after_warmup": "up",
    "swap_lowerings": "up",
}

#: zero-contract metrics: the baseline is exactly 0 by design, so the
#: relative-delta machinery (undefined at base==0) is replaced by "any
#: nonzero current value is a regression"
ZERO_ALERT = ("retraces_after_warmup", "lowerings_after_warmup",
              "swap_lowerings")

#: default regression floor (relative) and noise multiplier
MIN_REL = 0.10
SIGMA = 3.0


def baseline_spec(default="BENCH_*.json"):
    """``MXTPU_SLO_BASELINE``: baseline file or glob for benchdiff and
    the sentry (a single file pins the baseline; a glob makes the
    newest file the baseline and the rest the noise trajectory)."""
    return os.environ.get("MXTPU_SLO_BASELINE") or default


def _bench_metrics(parsed):
    out = {}
    for key in ("step_time_ms", "allreduce_time_ms", "allreduce_gbps",
                "transformer_step_ms", "transformer_tokens_per_sec",
                "module_path_images_per_sec", "mfu",
                "retraces_after_warmup", "lowerings_after_warmup",
                "swap_lowerings"):
        if parsed.get(key) is not None:
            out[key] = float(parsed[key])
    if parsed.get("value") is not None \
            and parsed.get("unit") == "images/sec":
        out["images_per_sec"] = float(parsed["value"])
    if parsed.get("value") is not None \
            and parsed.get("metric") == "serve_tokens_per_sec":
        # serve_bench --generate BENCH line: throughput + the tail
        # latency pair the generation SLO story cares about
        out["serve_tokens_per_sec"] = float(parsed["value"])
        for src, dst in (("ttft_ms", "serve_ttft_ms_p95"),
                         ("itl_ms", "serve_itl_ms_p95")):
            p95 = (parsed.get(src) or {}).get("p95")
            if p95 is not None:
                out[dst] = float(p95)
    if parsed.get("achieved_rate") is not None:
        # serve_bench open-loop BENCH line (--arrival): achieved vs
        # offered rate — the traffic-realism pair benchdiff prices
        out["serve_achieved_rps"] = float(parsed["achieved_rate"])
        offered = parsed.get("offered_rate")
        if offered:
            out["serve_rate_deficit"] = round(max(
                0.0, (float(offered) - float(parsed["achieved_rate"]))
                / float(offered)), 4)
    if parsed.get("value") is not None \
            and parsed.get("metric") == "fleet_throughput_rps":
        # serve_bench --fleet BENCH line: fleet throughput plus the
        # two health numbers the fleet story gates on — dispatch
        # balance (1.0 = even) and the hot-swap rotation pause
        out["fleet_rps"] = float(parsed["value"])
        if parsed.get("balance_ratio") is not None:
            out["fleet_balance_ratio"] = float(parsed["balance_ratio"])
        if parsed.get("swap_pause_ms_p95") is not None:
            out["fleet_swap_pause_ms_p95"] = \
                float(parsed["swap_pause_ms_p95"])
    return out


def load_bench(path):
    """One committed ``BENCH_*.json`` -> flat metric dict, or None for
    a failed/unreadable round.  Also accepts a bare metric dict (a
    benchdiff ``--metrics`` snapshot) for synthetic comparisons."""
    try:
        with open(path) as fin:
            doc = json.load(fin)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    parsed = doc.get("parsed")
    if parsed is not None:
        if doc.get("rc") not in (0, None):
            return None
        return _bench_metrics(parsed) or None
    if "rc" in doc or "cmd" in doc:
        return None                     # failed round: no parsed payload
    # bare metric dict: keep the keys the sentry knows
    out = {k: float(v) for k, v in doc.items()
           if k in DIRECTIONS and isinstance(v, (int, float))}
    return out or None


def load_trajectory(spec):
    """Expand a file-or-glob spec into ``[(path, metrics), ...]`` in
    name order (the repo's BENCH_r01..r0N naming is the time axis)."""
    paths = sorted(_glob.glob(spec)) if _glob.has_magic(spec) \
        else [spec]
    out = []
    for path in paths:
        metrics = load_bench(path)
        if metrics:
            out.append((path, metrics))
    return out


def telemetry_metrics(report):
    """The sentry's metric names from a merged telemetry report
    (``aggregate.build_report`` output) — so ``benchdiff --telemetry
    DIR`` prices a live run against the committed trajectory."""
    pod = report.get("pod") or {}
    out = {}
    for key in ("step_ms_p50", "step_ms_p95", "samples_per_sec",
                "overlap_ratio", "mfu"):
        if pod.get(key) is not None:
            out[key] = float(pod[key])
    total = (report.get("serve") or {}).get("total") or {}
    if total.get("padding_waste") is not None:
        out["serve_padding_waste"] = float(total["padding_waste"])
    if total.get("qps") is not None:
        out["serve_qps"] = float(total["qps"])
    lat = total.get("latency_ms") or {}
    if lat.get("p95") is not None:
        out["serve_ms_p95"] = float(lat["p95"])
    if total.get("tokens_per_sec") is not None:
        out["serve_tokens_per_sec"] = float(total["tokens_per_sec"])
    for src, dst in (("ttft_ms", "serve_ttft_ms_p95"),
                     ("itl_ms", "serve_itl_ms_p95")):
        p95 = (total.get(src) or {}).get("p95")
        if p95 is not None:
            out[dst] = float(p95)
    fleet = report.get("fleet") or {}
    if fleet.get("straggler_gap_ms") is not None:
        out["fleet_straggler_gap_ms"] = \
            float(fleet["straggler_gap_ms"])
    if fleet.get("balance_ratio") is not None:
        out["fleet_balance_ratio"] = float(fleet["balance_ratio"])
    retrace = report.get("retrace") or {}
    if retrace.get("count") is not None:
        out["retraces_after_warmup"] = float(retrace["count"])
    return out


def trajectory_noise(trajectory):
    """{metric: rel_spread over the trajectory} — the per-metric noise
    floor.  ``trajectory`` is ``load_trajectory`` output."""
    series = {}
    for _path, metrics in trajectory:
        for key, val in metrics.items():
            series.setdefault(key, []).append(val)
    return {key: rel_spread(vals) for key, vals in series.items()}


def compare(current, baseline, noise=None, min_rel=MIN_REL,
            sigma=SIGMA):
    """Diff ``current`` against ``baseline`` (flat metric dicts).

    Returns ``(regressions, checked)``: ``checked`` is every metric
    present in both with a known direction (each a dict with
    ``metric/current/baseline/delta_pct/threshold_pct/regression``);
    ``regressions`` is the subset that moved past its threshold in the
    bad direction.  Improvements never flag, whatever their size.
    """
    noise = noise or {}
    checked, regressions = [], []
    for metric in sorted(set(current) & set(baseline)):
        direction = DIRECTIONS.get(metric)
        if direction is None:
            continue
        base, cur = float(baseline[metric]), float(current[metric])
        if base == 0.0:
            if metric in ZERO_ALERT and cur > 0.0 and direction == "up":
                # zero-contract metric: no relative threshold exists —
                # the contract IS the zero, so any count regresses
                finding = {"metric": metric, "current": cur,
                           "baseline": base, "delta_pct": None,
                           "threshold_pct": 0.0,
                           "direction": direction, "regression": True}
                checked.append(finding)
                regressions.append(finding)
            continue
        thr = max(float(min_rel), float(sigma) * noise.get(metric, 0.0))
        delta = (cur - base) / abs(base)
        bad = delta if direction == "up" else -delta
        finding = {"metric": metric, "current": cur, "baseline": base,
                   "delta_pct": round(delta * 100.0, 2),
                   "threshold_pct": round(thr * 100.0, 2),
                   "direction": direction, "regression": bad > thr}
        checked.append(finding)
        if finding["regression"]:
            regressions.append(finding)
    return regressions, checked


def emit_regressions(regressions, step=None, baseline_name=None):
    """One structured ``perf_regression`` fault event per finding —
    the incident timeline / flight ring representation of "this build
    got slower".  Safe no-op list for empty input."""
    for f in regressions:
        events.emit("fault", step=step, fault="perf_regression",
                    phase="slo", metric=f["metric"],
                    current=f["current"], baseline=f["baseline"],
                    delta_pct=f["delta_pct"],
                    threshold_pct=f["threshold_pct"],
                    baseline_name=baseline_name)
    if regressions:
        events.flush()
    return regressions
