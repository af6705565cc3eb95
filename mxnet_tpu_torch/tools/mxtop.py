"""mxtop — a training ``top`` for telemetry dirs.

The port's copy of ``tools/mxtop.py``, over the port's
:mod:`~mxnet_tpu_torch.observability.aggregate`.

Reads the per-rank ``events-rank*.jsonl`` files a run produced with
``MXTPU_TELEMETRY=1`` and renders the pod report: step-time
percentiles, samples/sec, MFU, straggler gap, slowest phase, per-rank
heartbeat ages, and the fault/checkpoint incident timeline.

    python -m mxnet_tpu_torch.tools.mxtop DIR             # one-shot report
    python -m mxnet_tpu_torch.tools.mxtop DIR --follow    # live, top-style
    python -m mxnet_tpu_torch.tools.mxtop DIR --json      # machine-readable
    python -m mxnet_tpu_torch.tools.mxtop DIR --fault     # timeline around
                                                          # each incident
    python -m mxnet_tpu_torch.tools.mxtop --watch http://host:8911
                                          # live /metrics from a serving door

``--json`` prints exactly one JSON document (the aggregate.build_report
dict) so CI can assert on it.

``--watch URL`` polls ``GET /metrics`` on an mxserve/mxfleet door and
renders the live registry (the same sketches the SLO engine reads) —
no telemetry dir needed.  When ``slo_alert`` events exist in a dir
view, the SLO pane shows the objective, per-window burn rates, the
last alert, and the last scale recommendation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mxnet_tpu_torch.observability import aggregate


def _fmt(val, suffix="", width=10):
    if val is None:
        return "-".rjust(width)
    if isinstance(val, float):
        return ("%.2f%s" % (val, suffix)).rjust(width)
    return ("%s%s" % (val, suffix)).rjust(width)


def render(report, stream=None):
    pod = report["pod"]
    w = (stream or sys.stdout).write
    w("mxtop — run %s — %d rank(s), %d events\n" % (
        ",".join(report["run_ids"]) or "?", len(report["ranks"]),
        report["events"]))
    w("pod   step p50 %s ms   p95 %s ms   samples/sec %s   mfu %s\n" % (
        _fmt(pod.get("step_ms_p50"), width=8),
        _fmt(pod.get("step_ms_p95"), width=8),
        _fmt(pod.get("samples_per_sec"), width=10),
        _fmt(pod.get("mfu"), width=7)))
    roof = pod.get("static_roofline")
    if roof:
        w("      static roofline: bound %s ms (%s-bound)   MFU ceiling %s"
          "   %s, %s\n" % (
              _fmt(roof.get("bound_ms"), width=8), roof.get("bound") or "?",
              _fmt(roof.get("mfu_ceiling"), width=6),
              roof.get("device_kind") or "?",
              roof.get("compute_dtype") or "?"))
    w("      straggler gap %s ms   slowest phase %s\n" % (
        _fmt(pod.get("straggler_gap_ms"), width=8),
        pod.get("slowest_phase") or "-"))
    if pod.get("generation") is not None:
        last = pod.get("last_elastic") or {}
        w("      elastic generation %s   world size %s   last %s\n" % (
            pod["generation"],
            pod.get("world_size", "?"),
            last.get("event") or "-"))
        tr = pod.get("last_transition")
        if tr:
            parts = ["      last transition resumed %s"
                     % (tr.get("path") or "?")]
            if tr.get("fallback_reason"):
                parts.append("(fell back: %s)" % tr["fallback_reason"])
            if tr.get("duration_ms") is not None:
                parts.append("restore %.0f ms" % tr["duration_ms"])
            if tr.get("transition_ms") is not None:
                parts.append("end-to-end %.0f ms" % tr["transition_ms"])
            w("   ".join(parts) + "\n")
    if pod.get("phase_totals_ms"):
        w("      phase totals: %s\n" % "  ".join(
            "%s=%.1fms" % (k, v)
            for k, v in pod["phase_totals_ms"].items()))
    if pod.get("overlap_ratio") is not None:
        p50 = pod.get("phase_p50_ms") or {}
        w("      overlap ratio %s (serial/wall; >1 = input pipeline "
          "hidden under compute)%s\n" % (
              _fmt(pod["overlap_ratio"], width=7).strip(),
              "".join("   %s p50 %.1fms" % (k, v)
                      for k, v in sorted(p50.items()))))
    w("%-6s %8s %10s %10s %12s %8s  %s\n" % (
        "rank", "steps", "p50 ms", "p95 ms", "samples/s", "hb age",
        "last fault"))
    for rank, s in sorted(report["per_rank"].items(),
                          key=lambda kv: int(kv[0]) if kv[0].isdigit()
                          else 1 << 30):
        fault = s.get("last_fault")
        fault_txt = "-"
        if fault:
            fault_txt = "%s@step %s" % (fault.get("fault", "?"),
                                        fault.get("step", "?"))
        w("%-6s %8s %10s %10s %12s %8s  %s\n" % (
            rank, s.get("steps", 0),
            _fmt(s.get("step_ms_p50"), width=10).strip(),
            _fmt(s.get("step_ms_p95"), width=10).strip(),
            _fmt(s.get("samples_per_sec"), width=12).strip(),
            _fmt(s.get("heartbeat_age_s"), "s", width=8).strip(),
            fault_txt))
    if report["incidents"]:
        w("incidents (%d):\n" % len(report["incidents"]))
        for rec in report["incidents"]:
            w("  [%s] rank %s step %s %s %s\n" % (
                rec.get("wall_ms"), rec.get("rank"), rec.get("step"),
                rec.get("kind"),
                rec.get("fault") or rec.get("event") or rec.get("phase")
                or rec.get("path") or ""))
    render_slo(report, stream=stream)
    render_retrace(report, stream=stream)
    render_schedule(report, stream=stream)


def render_serve(report, stream=None):
    """The serving view (--serve): per-model QPS, latency percentiles,
    occupancy, padding waste, queue depth from the ``serve`` events."""
    w = (stream or sys.stdout).write
    sv = report.get("serve") or {}
    models = sv.get("models") or {}
    if not models:
        w("no serve events.\n")
        render_fleet(report, stream=stream)
        return
    total = sv.get("total") or {}
    tlat = total.get("latency_ms") or {}
    w("mxserve — %d model(s)   qps %s   p95 %s ms   requests %s\n" % (
        len(models), _fmt(total.get("qps"), width=8).strip(),
        _fmt(tlat.get("p95"), width=8).strip(),
        total.get("requests", 0)))
    w("%-12s %8s %8s %10s %10s %10s %10s %8s  %s\n" % (
        "model", "reqs", "qps", "p50 ms", "p95 ms", "p99 ms",
        "occupancy", "waste", "queue max / buckets"))
    for name, m in sorted(models.items()):
        lat = m.get("latency_ms") or {}
        w("%-12s %8s %8s %10s %10s %10s %10s %8s  %s / %s\n" % (
            name, m.get("requests", 0),
            _fmt(m.get("qps"), width=8).strip(),
            _fmt(lat.get("p50"), width=10).strip(),
            _fmt(lat.get("p95"), width=10).strip(),
            _fmt(lat.get("p99"), width=10).strip(),
            _fmt(m.get("occupancy"), width=10).strip(),
            _fmt(m.get("padding_waste"), width=8).strip(),
            m.get("queue_depth_max", 0),
            " ".join("%s×%s" % (b, c)
                     for b, c in (m.get("buckets") or {}).items())))
    gen = {name: m for name, m in models.items() if m.get("phases")}
    if gen:
        # generative models: the token view under the request view
        w("generation:\n")
        w("%-12s %8s %10s %10s %10s %10s %10s %7s %12s  %s\n" % (
            "model", "tokens", "tok/s", "ttft p50", "ttft p95",
            "itl p95", "kv occ", "dtype", "kernel",
            "prefill/decode batches"))
        for name, m in sorted(gen.items()):
            ttft = m.get("ttft_ms") or {}
            itl = m.get("itl_ms") or {}
            phases = m.get("phases") or {}
            w("%-12s %8s %10s %10s %10s %10s %10s %7s %12s  %s/%s\n" % (
                name, m.get("tokens", 0),
                _fmt(m.get("tokens_per_sec"), width=10).strip(),
                _fmt(ttft.get("p50"), width=10).strip(),
                _fmt(ttft.get("p95"), width=10).strip(),
                _fmt(itl.get("p95"), width=10).strip(),
                _fmt(m.get("kv_occupancy"), width=10).strip(),
                m.get("dtype") or "-",
                m.get("kernel_path") or "-",
                phases.get("prefill", 0), phases.get("decode", 0)))
    render_fleet(report, stream=stream)
    render_slo(report, stream=stream)
    render_retrace(report, stream=stream)


def render_retrace(report, stream=None):
    """Steady-state retrace attributions from the runtime sentry
    (``MXTPU_RETRACE_SENTRY=1``): count of post-warmup lowerings plus
    the divergent cache-key ingredient histogram.  Nonzero here means
    the zero-steady-state-lowerings contract broke."""
    rt = report.get("retrace") or {}
    if not rt.get("count"):
        return
    w = (stream or sys.stdout).write
    w("RETRACE — %s post-warmup lowering(s)   divergent: %s\n" % (
        rt["count"],
        "  ".join("%s×%s" % (k, v)
                  for k, v in sorted((rt.get("divergent") or {}).items()))
        or "?"))
    for site in rt.get("sites") or []:
        w("      at %s\n" % site)


def render_schedule(report, stream=None):
    """Pipeline-schedule pane: the GPipe/1F1B shape the trainer runs
    (one ``schedule`` record per run), its measured bubble fraction,
    and the expert load balance when an MoE run reports one — the
    runtime counterparts of the ``mxlint --schedule`` predictions
    (docs/graph_lint.md "MXL-E").  Absent keys are skipped, not
    guessed at."""
    sc = report.get("schedule") or {}
    if not sc:
        return
    w = (stream or sys.stdout).write
    parts = ["SCHEDULE — %s  stages %s  microbatches %s" % (
        sc.get("schedule", "?"), sc.get("stages", "?"),
        sc.get("microbatches", "?"))]
    if sc.get("bubble_fraction") is not None:
        parts.append("bubble %.1f%%" % (100.0 * sc["bubble_fraction"]))
    if sc.get("expert_balance") is not None:
        parts.append("expert balance %.2f" % sc["expert_balance"])
    w("   ".join(parts) + "\n")


def render_fleet(report, stream=None):
    """The fleet rollup under the serving view: per-replica qps/p95/
    occupancy/param-version plus the fleet-wide straggler gap, dispatch
    balance, and version-skew map (docs/serving.md "Fleet")."""
    w = (stream or sys.stdout).write
    fl = report.get("fleet") or {}
    replicas = fl.get("replicas") or {}
    if not replicas:
        return
    w("fleet — %s replica(s)   straggler gap %s ms   balance %s\n" % (
        len(replicas),
        _fmt(fl.get("straggler_gap_ms"), width=8).strip(),
        _fmt(fl.get("balance_ratio"), width=6).strip()))
    w("%-8s %8s %8s %10s %10s %10s  %s\n" % (
        "replica", "reqs", "qps", "p50 ms", "p95 ms", "occupancy",
        "version"))
    for idx, m in sorted(replicas.items(), key=lambda kv: kv[0]):
        lat = m.get("latency_ms") or {}
        w("%-8s %8s %8s %10s %10s %10s  %s\n" % (
            idx, m.get("requests", 0),
            _fmt(m.get("qps"), width=8).strip(),
            _fmt(lat.get("p50"), width=10).strip(),
            _fmt(lat.get("p95"), width=10).strip(),
            _fmt(m.get("occupancy"), width=10).strip(),
            m.get("param_version") or "?"))
    skew = fl.get("version_skew") or {}
    if len(skew) > 1:
        w("VERSION SKEW: %s\n" % json.dumps(skew, sort_keys=True))


def render_slo(report, stream=None):
    """The SLO pane (pod and serve views): alert counts, currently
    active tiers, the last alert's objective + per-window burns, and
    the last scale recommendation — the live engine's trail
    (observability/sloengine.py)."""
    slo = report.get("slo") or {}
    if not slo:
        return
    w = (stream or sys.stdout).write
    w("SLO — %s alert(s) (%s page)   active: %s   recommendations: %s\n"
      % (slo.get("alerts", 0), slo.get("page_alerts", 0),
         " ".join(slo.get("active") or []) or "none",
         slo.get("recommendations", 0)))
    last = slo.get("last_alert")
    if last:
        burns = last.get("burns") or {}
        w("      last alert: %s %s %s   objective %s<=%s budget %s   "
          "burn %s\n" % (
              last.get("tier", "?"), last.get("edge", "?"),
              last.get("metric", "?"), last.get("metric", "?"),
              _fmt(last.get("target"), width=6).strip(),
              last.get("budget"),
              "  ".join("%ss=%sx" % (k, v)
                        for k, v in sorted(burns.items(),
                                           key=lambda kv: int(kv[0])))))
    reco = slo.get("last_recommendation")
    if reco:
        w("      last recommendation: %s gen %s (%s)\n" % (
            reco.get("action", "?"), reco.get("gen", "?"),
            reco.get("reason", "")))


def run_watch(url, interval, follow):
    """--watch: poll GET /metrics on a serving door and render the
    live registry — counters/gauges verbatim, histogram summaries as
    one row per metric (p50/p95/p99/count plus per-window p95s)."""
    import urllib.request
    from mxnet_tpu_torch.observability.metrics import parse_prometheus
    while True:
        try:
            with urllib.request.urlopen(url.rstrip("/") + "/metrics",
                                        timeout=10) as resp:
                text = resp.read().decode()
        except Exception as exc:
            sys.stderr.write("mxtop: scrape failed: %r\n" % (exc,))
            return 1
        rows = parse_prometheus(text)
        if follow:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write("mxtop --watch %s — %d sample(s)\n"
                         % (url, len(rows)))
        hists, scalars = {}, []
        for name, labels, value in rows:
            if "quantile" in labels or name.endswith(("_count", "_sum")):
                base = name
                for suffix in ("_window", "_count", "_sum"):
                    if base.endswith(suffix):
                        base = base[:-len(suffix)]
                key = "q" + labels["quantile"] if "quantile" in labels \
                    else name.rsplit("_", 1)[-1]
                if labels.get("window"):
                    key = "w%s_p95" % labels["window"]
                hists.setdefault(base, {})[key] = value
            else:
                scalars.append((name, labels, value))
        for name, labels, value in scalars:
            lbl = " ".join("%s=%s" % kv for kv in sorted(labels.items()))
            sys.stdout.write("  %-38s %12s  %s\n"
                             % (name, _fmt(value, width=12).strip(),
                                lbl))
        if hists:
            sys.stdout.write("  %-30s %10s %10s %10s %10s  %s\n" % (
                "histogram", "p50", "p95", "p99", "count", "window p95s"))
            for base, vals in sorted(hists.items()):
                wins = "  ".join(
                    "%s=%s" % (k[1:-4], _fmt(v, width=8).strip())
                    for k, v in sorted(
                        vals.items(),
                        key=lambda kv: (len(kv[0]), kv[0]))
                    if k.startswith("w") and k.endswith("_p95"))
                sys.stdout.write("  %-30s %10s %10s %10s %10s  %s\n" % (
                    base,
                    _fmt(vals.get("q0.5"), width=10).strip(),
                    _fmt(vals.get("q0.95"), width=10).strip(),
                    _fmt(vals.get("q0.99"), width=10).strip(),
                    int(vals.get("count", 0)), wins))
        if not follow:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0


def render_fault_timelines(records, before, after, stream=None):
    w = (stream or sys.stdout).write
    hits = [i for i, r in enumerate(records)
            if r.get("kind") in ("fault", "elastic")]
    if not hits:
        w("no fault events.\n")
        return
    for idx in hits:
        rec = records[idx]
        if rec.get("kind") == "elastic":
            w("--- elastic %s generation %s (world %s) at rank %s ---\n"
              % (rec.get("event", "?"), rec.get("generation", "?"),
                 rec.get("world_size", "?"), rec.get("rank")))
        else:
            w("--- fault %r at rank %s step %s ---\n" % (
                rec.get("fault"), rec.get("rank"), rec.get("step")))
        for ev in aggregate.timeline_around(records, idx, before, after):
            mark = ">>" if ev is rec else "  "
            w("%s [%s] r%s %-6s %s\n" % (
                mark, ev.get("wall_ms"), ev.get("rank"),
                ev.get("kind"),
                json.dumps({k: v for k, v in ev.items()
                            if k not in ("run_id", "rank", "kind",
                                         "wall_ms")},
                           default=str, separators=(",", ":"))))


def _render_once(args, tailer, records):
    """One report of the dir (--follow: with the records appended since
    the last poll); returns the records it covered."""
    if args.follow:
        new = tailer.poll()
        if new:
            records = records + new
            records.sort(key=lambda r: (r.get("wall_ms") or 0,
                                        r.get("rank") or 0))
    else:
        records = aggregate.read_events(args.directory)
    report = aggregate.build_report(records)
    if args.json:
        if args.serve:
            doc = dict(report.get("serve", {}))
            if report.get("fleet"):
                doc["fleet"] = report["fleet"]
        else:
            doc = report
        json.dump(doc, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    elif args.serve:
        render_serve(report)
    elif args.fault:
        render_fault_timelines(records, args.window, args.window)
    else:
        if args.follow:
            sys.stdout.write("\x1b[2J\x1b[H")
        render(report)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxtop", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("directory", nargs="?",
                    help="telemetry dir (MXTPU_TELEMETRY_DIR)")
    ap.add_argument("--watch", metavar="URL",
                    help="poll GET /metrics on an mxserve/mxfleet door "
                         "and render the live registry (no dir needed)")
    ap.add_argument("--json", action="store_true",
                    help="print the report as one JSON document")
    ap.add_argument("--follow", action="store_true",
                    help="re-render every --interval seconds")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--serve", action="store_true",
                    help="serving view: per-model QPS, p95, occupancy, "
                         "queue depth from serve events")
    ap.add_argument("--fault", action="store_true",
                    help="print the event timeline around each fault")
    ap.add_argument("--window", type=int, default=5,
                    help="events before/after each fault (--fault)")
    args = ap.parse_args(argv)

    if args.watch:
        return run_watch(args.watch, args.interval, args.follow)
    if not args.directory:
        ap.error("directory is required unless --watch is given")
    if not os.path.isdir(args.directory):
        sys.stderr.write("mxtop: no such directory: %s\n" % args.directory)
        return 2

    # --follow tails incrementally through aggregate.EventTailer, which
    # tracks per-inode offsets: when the writer rotates the live file to
    # ``.1`` at MXTPU_TELEMETRY_MAX_MB, the next poll drains the renamed
    # inode and picks up the fresh file from zero — no dead-inode tail,
    # no re-reading the whole directory every interval
    tailer = aggregate.EventTailer(args.directory)
    records = []
    try:
        while True:
            records = _render_once(args, tailer, records)
            if not args.follow:
                break
            # a follower reading through a pipe sees each report as it
            # lands, not when the pipe's buffer fills
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:       # Ctrl-C ends --follow, at any point
        pass
    if not records:
        sys.stderr.write("mxtop: no events under %s\n" % args.directory)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
