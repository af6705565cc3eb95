r"""benchdiff: perf-regression gate over a BENCH trajectory.

The port's copy of ``tools/benchdiff.py``, over the port's
:mod:`~mxnet_tpu_torch.observability.slo` and ``aggregate``.  The
committed ``BENCH_*.json`` are the JAX package's TPU records, no
baseline for the port's numbers: pass ``--baseline`` (or set
``MXTPU_SLO_BASELINE``) to the port's own.

Compares a *current* set of perf counters against a committed baseline
(``BENCH_*.json``) with the noise-aware thresholds of
:mod:`mxnet_tpu_torch.observability.slo`: a metric flags only when it moves
more than ``max(--min-rel, --sigma * rel_spread(trajectory))`` in its
bad direction (larger step time, smaller images/sec, ...).
Improvements never flag.  Exit codes: 0 clean, 1 regression(s), 2
usage/IO error — the CI leg fails the build on 1.

Where *current* comes from (first match wins):

- ``--against FILE``     another BENCH json / bare metric-dict json
- ``--telemetry DIR``    a telemetry event dir — the live counters
                         (step p50/p95, samples/sec, overlap_ratio,
                         serving padding waste) derived by
                         ``aggregate.build_report``
- ``--metrics JSON``     an inline ``{"metric": value}`` literal
                         (smoke tests / synthetic drills)

The baseline is ``--baseline`` (file or glob), defaulting to
``MXTPU_SLO_BASELINE`` and then ``BENCH_*.json``; with a glob, the
newest file is the baseline and the whole series is the noise
trajectory.  ``--emit`` additionally records each finding as a
structured ``perf_regression`` fault event (telemetry must be on).

Usage::

    python -m mxnet_tpu_torch.tools.benchdiff --against BENCH_new.json
    python -m mxnet_tpu_torch.tools.benchdiff --telemetry DIR \
        --baseline 'my_bench_*.json'
    python -m mxnet_tpu_torch.tools.benchdiff \
        --metrics '{"step_time_ms": 120.0}'
"""
import argparse
import json
import os
import sys


def _slo():
    from mxnet_tpu_torch.observability import slo
    return slo


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="benchdiff", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", default=None,
                    help="baseline BENCH json file or glob (default: "
                         "$MXTPU_SLO_BASELINE, then BENCH_*.json)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--against", default=None,
                     help="current metrics from another BENCH json")
    src.add_argument("--telemetry", default=None,
                     help="current metrics from a telemetry event dir")
    src.add_argument("--metrics", default=None,
                     help="current metrics as an inline JSON dict")
    ap.add_argument("--min-rel", type=float, default=None,
                    help="regression floor (relative; default 0.10)")
    ap.add_argument("--sigma", type=float, default=None,
                    help="noise multiplier over the trajectory's "
                         "rel_spread (default 3.0)")
    ap.add_argument("--emit", action="store_true",
                    help="also emit perf_regression fault events")
    ap.add_argument("--json", action="store_true",
                    help="print the full finding list as JSON")
    args = ap.parse_args(argv)

    slo = _slo()
    spec = args.baseline or slo.baseline_spec()
    trajectory = slo.load_trajectory(spec)
    if not trajectory:
        sys.stderr.write("benchdiff: no usable baseline under %r\n" % spec)
        return 2
    baseline_path, baseline = trajectory[-1]
    noise = slo.trajectory_noise(trajectory)

    if args.against:
        current = slo.load_bench(args.against)
        source = args.against
    elif args.telemetry:
        from mxnet_tpu_torch.observability import aggregate
        report = aggregate.build_report(
            aggregate.read_events(args.telemetry))
        try:
            from mxnet_tpu_torch.serving.telemetry import serve_report
            report["serve"] = serve_report(
                aggregate.read_events(args.telemetry))
        except Exception:
            pass
        current = slo.telemetry_metrics(report)
        source = args.telemetry
    elif args.metrics:
        try:
            doc = json.loads(args.metrics)
        except ValueError as exc:
            sys.stderr.write("benchdiff: bad --metrics JSON: %s\n" % exc)
            return 2
        current = {k: float(v) for k, v in doc.items()
                   if k in slo.DIRECTIONS}
        source = "--metrics"
    else:
        sys.stderr.write("benchdiff: one of --against/--telemetry/"
                         "--metrics is required\n")
        return 2
    if not current:
        sys.stderr.write("benchdiff: no comparable metrics in %r\n"
                         % source)
        return 2

    kwargs = {}
    if args.min_rel is not None:
        kwargs["min_rel"] = args.min_rel
    if args.sigma is not None:
        kwargs["sigma"] = args.sigma
    regressions, checked = slo.compare(current, baseline, noise=noise,
                                       **kwargs)
    if args.emit and regressions:
        slo.emit_regressions(regressions,
                             baseline_name=os.path.basename(baseline_path))

    if args.json:
        json.dump({"baseline": baseline_path, "source": source,
                   "trajectory": [p for p, _m in trajectory],
                   "checked": checked, "regressions": regressions},
                  sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        print("benchdiff: %s vs %s (trajectory of %d)"
              % (source, baseline_path, len(trajectory)))
        for f in checked:
            mark = "REGRESSION" if f["regression"] else "ok"
            print("  %-28s %12g -> %-12g %+7.2f%% (thr %5.2f%%, "
                  "worse=%s)  %s"
                  % (f["metric"], f["baseline"], f["current"],
                     f["delta_pct"], f["threshold_pct"], f["direction"],
                     mark))
        if not checked:
            print("  (no overlapping metrics)")
    if regressions:
        sys.stderr.write("benchdiff: %d regression(s) past threshold\n"
                         % len(regressions))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
