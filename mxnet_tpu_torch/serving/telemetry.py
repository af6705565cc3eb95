"""Serving telemetry: the ``serve`` event kind and its aggregation.

The port's copy of ``mxnet_tpu/serving/telemetry.py`` (host code,
unchanged).

One record per dispatched batch (not per request — bounded volume even
at high QPS) carrying the request-visible phases (``queue_wait_ms``
admission-to-dispatch, ``pack_ms`` host pack, ``device_ms`` execute,
``unpack_ms`` host slice/complete), the batch-shape economics
(``bucket``, ``n_samples``, ``occupancy``, ``padding_waste`` from the
planner's cost model), scheduler state (``queue_depth``), and the
per-request end-to-end latencies (``lat_ms`` list) so percentiles can
be computed over requests, not batches.

:func:`serve_report` folds merged event records (the
``aggregate.read_events`` output) into the per-model view ``mxtop
--serve`` and ``parse_log.py`` render: QPS, p50/p95/p99 latency,
mean occupancy and padding waste, phase means, max queue depth.
"""
from __future__ import annotations

import os as _os

from ..observability import events
from ..observability.counters import percentile
from ..observability.metrics import QuantileSketch, \
    registry as _metrics_registry
from ..observability.phases import SERVE_PHASES

__all__ = ["emit_batch", "serve_report", "fleet_report",
           "set_fleet_context", "SERVE_PHASES"]

#: fleet identity stamped onto every serve record this process emits:
#: replica index + the param version it currently serves.  Set by the
#: replica wrapper (serving.fleet) via :func:`set_fleet_context`; the
#: replica index falls back to MXTPU_FLEET_REPLICA so even a bare
#: ModelServer inside a fleet-launched process tags its records.
_FLEET = {"replica": None, "param_version": None}


def set_fleet_context(replica=None, param_version=None):
    """Stamp subsequent serve records with a replica index and/or param
    version (pass None to leave a field unchanged)."""
    if replica is not None:
        _FLEET["replica"] = int(replica)
    if param_version is not None:
        _FLEET["param_version"] = str(param_version)


def _fleet_fields():
    rep = _FLEET["replica"]
    if rep is None:
        raw = _os.environ.get("MXTPU_FLEET_REPLICA")
        if raw:
            try:
                rep = int(raw)
            except ValueError:
                rep = None
    if rep is None:
        return {}
    out = {"replica": rep}
    if _FLEET["param_version"] is not None:
        out["param_version"] = _FLEET["param_version"]
    return out

#: (accumulator key, record field) per canonical serving phase —
#: derived from the shared registry (:mod:`..observability.phases`) so
#: the serve record schema, this report, and parse_log's columns can't
#: drift apart
_PHASE_FIELDS = tuple(("_" + p, p + "_ms") for p in SERVE_PHASES)


def emit_batch(model, bucket, n_requests, n_samples, occupancy,
               padding_waste, queue_depth, queue_wait_ms, pack_ms,
               device_ms, unpack_ms, lat_ms, trace_ids=None,
               phase=None, tokens=None, kv_occupancy=None,
               ttft_ms=None, itl_ms=None, dtype=None, kernel=None):
    """Emit one ``serve`` record for a completed batch (no-op when
    telemetry is off, like every emit in the tree).  ``trace_ids``:
    the per-request trace ids of the batch's members when request
    tracing (``MXTPU_TRACE=1``) is on — how mxtrace links a request's
    lifecycle back to the batch that served it.

    Generative batches additionally carry ``phase`` ∈ {prefill,
    decode}, ``tokens`` (generated this step), ``kv_occupancy``
    (fraction of KV-cache blocks in use after the step), and the
    per-sequence ``ttft_ms``/``itl_ms`` samples that landed in it —
    the raw material for the tokens/sec, TTFT, and inter-token-latency
    columns downstream."""
    extra = dict(_fleet_fields())
    if trace_ids:
        extra["trace_ids"] = list(trace_ids)
    if phase is not None:
        extra["phase"] = str(phase)
        extra["tokens"] = int(tokens or 0)
        extra["kv_occupancy"] = _r(kv_occupancy, 4)
        if ttft_ms:
            extra["ttft_ms"] = [_r(v) for v in ttft_ms]
        if itl_ms:
            extra["itl_ms"] = [_r(v) for v in itl_ms]
        if dtype is not None:
            extra["dtype"] = str(dtype)      # serving compute dtype
        if kernel is not None:
            extra["kernel"] = str(kernel)    # decode-attention path
    events.emit(
        "serve", model=model, bucket=int(bucket),
        n_requests=int(n_requests), n_samples=int(n_samples),
        occupancy=round(float(occupancy), 4),
        padding_waste=round(float(padding_waste), 4),
        queue_depth=int(queue_depth),
        queue_wait_ms=_r(queue_wait_ms), pack_ms=_r(pack_ms),
        device_ms=_r(device_ms), unpack_ms=_r(unpack_ms),
        lat_ms=[_r(v) for v in lat_ms or ()], **extra)
    _feed_registry(model, n_requests, queue_depth, occupancy, lat_ms,
                   phase=phase, tokens=tokens,
                   kv_occupancy=kv_occupancy, ttft_ms=ttft_ms,
                   itl_ms=itl_ms)


def _feed_registry(model, n_requests, queue_depth, occupancy, lat_ms,
                   phase=None, tokens=None, kv_occupancy=None,
                   ttft_ms=None, itl_ms=None):
    """Mirror one batch into the live metrics registry — always on
    (unlike the event log): the /metrics door and the SLO engine read
    these regardless of MXTPU_TELEMETRY.  Per batch, not per request,
    so the cost is a handful of sketch increments."""
    try:
        reg = _metrics_registry()
        reg.counter("mxtpu_serve_requests_total",
                    help="requests completed").inc(int(n_requests))
        reg.counter("mxtpu_serve_batches_total",
                    help="batches dispatched").inc()
        reg.gauge("mxtpu_serve_queue_depth",
                  help="scheduler queue depth").set(int(queue_depth))
        reg.gauge("mxtpu_serve_occupancy",
                  help="last batch bucket occupancy").set(
                      float(occupancy))
        if lat_ms:
            hist = reg.histogram("mxtpu_serve_latency_ms",
                                 help="request end-to-end latency (ms)")
            for v in lat_ms:
                hist.observe(float(v))
        if phase is not None:
            if tokens:
                reg.counter("mxtpu_serve_tokens_total",
                            help="tokens generated").inc(int(tokens))
            if kv_occupancy is not None:
                hw = reg.gauge("mxtpu_serve_kv_occupancy_hw",
                               help="KV-block occupancy high water")
                hw.set(max(hw.value, float(kv_occupancy)))
            for vals, name in ((ttft_ms, "mxtpu_serve_ttft_ms"),
                               (itl_ms, "mxtpu_serve_itl_ms")):
                if vals:
                    hist = reg.histogram(
                        name, help="per-sequence %s (ms)"
                        % name.rsplit("_", 2)[-2])
                    for v in vals:
                        hist.observe(float(v))
    except Exception:
        pass                     # metrics must never fail a batch


def _r(v, nd=3):
    return None if v is None else round(float(v), nd)


def _mean(vals):
    return round(sum(vals) / len(vals), 3) if vals else None


def serve_report(records):
    """Per-model serving rollup from merged event records.

    Returns ``{"models": {name: {...}}, "total": {...}}`` where each
    model entry carries ``requests``, ``batches``, ``qps``,
    ``latency_ms`` {p50, p95, p99, mean}, ``occupancy``,
    ``padding_waste``, ``queue_depth_max``, per-phase means
    (``queue_wait_ms``/``pack_ms``/``device_ms``/``unpack_ms``), and
    the per-bucket dispatch histogram ``buckets`` {size: batches}.
    ``total`` aggregates across models.  Empty dicts when no ``serve``
    records exist (mxtop treats that as "no serving view").
    """
    per = {}
    walls = []
    for rec in records:
        if rec.get("kind") != "serve":
            continue
        model = rec.get("model") or "?"
        m = per.setdefault(model, dict(
            {"requests": 0, "samples": 0, "batches": 0,
             "_lat": QuantileSketch(),
             "_occ": [], "_waste": [], "queue_depth_max": 0,
             "buckets": {}, "tokens": 0, "_kv": [], "_ttft": [],
             "_itl": [], "phases": {}},
            **{key: [] for key, _field in _PHASE_FIELDS}))
        m["requests"] += int(rec.get("n_requests") or 0)
        m["samples"] += int(rec.get("n_samples") or 0)
        m["batches"] += 1
        m["_lat"].extend(float(v) for v in (rec.get("lat_ms") or ()))
        if rec.get("phase"):
            m["phases"][rec["phase"]] = \
                m["phases"].get(rec["phase"], 0) + 1
            m["tokens"] += int(rec.get("tokens") or 0)
            if rec.get("dtype"):
                m["dtype"] = rec["dtype"]          # last-seen wins
            if rec.get("kernel"):
                m["kernel_path"] = rec["kernel"]
            if rec.get("kv_occupancy") is not None:
                m["_kv"].append(float(rec["kv_occupancy"]))
            m["_ttft"].extend(float(v)
                              for v in (rec.get("ttft_ms") or ()))
            m["_itl"].extend(float(v) for v in (rec.get("itl_ms") or ()))
        for key, field in (("_occ", "occupancy"),
                           ("_waste", "padding_waste")) + _PHASE_FIELDS:
            if rec.get(field) is not None:
                m[key].append(float(rec[field]))
        m["queue_depth_max"] = max(m["queue_depth_max"],
                                   int(rec.get("queue_depth") or 0))
        b = str(rec.get("bucket"))
        m["buckets"][b] = m["buckets"].get(b, 0) + 1
        if rec.get("wall_ms") is not None:
            walls.append((model, float(rec["wall_ms"])))

    if not per:
        return {"models": {}, "total": {}}

    spans = {}
    for model, wall in walls:
        lo, hi = spans.get(model, (wall, wall))
        spans[model] = (min(lo, wall), max(hi, wall))

    models = {}
    all_lat = []                 # per-model sketches; total = merge
    all_ttft, all_itl, total_tokens = [], [], 0
    total = {"requests": 0, "samples": 0, "batches": 0}
    for model, m in sorted(per.items()):
        lat = m.pop("_lat")
        out = {"requests": m["requests"], "samples": m["samples"],
               "batches": m["batches"],
               "queue_depth_max": m["queue_depth_max"],
               "buckets": dict(sorted(m["buckets"].items(),
                                      key=lambda kv: int(kv[0])))}
        if m["phases"]:                 # generative model: token view
            out["phases"] = dict(sorted(m["phases"].items()))
            out["tokens"] = m["tokens"]
            out["kv_occupancy"] = _mean(m["_kv"])
            if m.get("dtype"):
                out["dtype"] = m["dtype"]
            if m.get("kernel_path"):
                out["kernel_path"] = m["kernel_path"]
            for key, name in (("_ttft", "ttft_ms"), ("_itl", "itl_ms")):
                vals = m[key]
                if vals:
                    out[name] = {"p50": _r(percentile(vals, 50)),
                                 "p95": _r(percentile(vals, 95)),
                                 "mean": _mean(vals)}
            total_tokens += m["tokens"]
            all_ttft.extend(m["_ttft"])
            all_itl.extend(m["_itl"])
        m.pop("_kv"), m.pop("_ttft"), m.pop("_itl")
        for key, field in (("_occ", "occupancy"),
                           ("_waste", "padding_waste")) + _PHASE_FIELDS:
            out[field] = _mean(m.pop(key))
        if lat.count:
            out["latency_ms"] = {"p50": _r(lat.percentile(50)),
                                 "p95": _r(lat.percentile(95)),
                                 "p99": _r(lat.percentile(99)),
                                 "mean": _r(lat.mean())}
        span = spans.get(model)
        if span and span[1] > span[0]:
            out["qps"] = round(m["requests"] / ((span[1] - span[0]) / 1e3),
                               2)
            if m["phases"]:
                out["tokens_per_sec"] = round(
                    m["tokens"] / ((span[1] - span[0]) / 1e3), 2)
        else:
            out["qps"] = None
            if m["phases"]:
                out["tokens_per_sec"] = None
        models[model] = out
        all_lat.append(lat)
        for k in ("requests", "samples", "batches"):
            total[k] += m[k]

    merged_lat = QuantileSketch.merged(all_lat)
    if merged_lat.count:
        # exact: the merge of per-model sketches answers the same
        # quantiles as one sketch fed every model's stream
        total["latency_ms"] = {"p50": _r(merged_lat.percentile(50)),
                               "p95": _r(merged_lat.percentile(95)),
                               "p99": _r(merged_lat.percentile(99)),
                               "mean": _r(merged_lat.mean())}
    lo = min(s[0] for s in spans.values()) if spans else None
    hi = max(s[1] for s in spans.values()) if spans else None
    if lo is not None and hi > lo:
        total["qps"] = round(total["requests"] / ((hi - lo) / 1e3), 2)
        if total_tokens:
            total["tokens_per_sec"] = round(
                total_tokens / ((hi - lo) / 1e3), 2)
    if total_tokens:
        total["tokens"] = total_tokens
    for vals, name in ((all_ttft, "ttft_ms"), (all_itl, "itl_ms")):
        if vals:
            total[name] = {"p50": _r(percentile(vals, 50)),
                           "p95": _r(percentile(vals, 95)),
                           "mean": _mean(vals)}
    occs = [m["occupancy"] for m in models.values()
            if m["occupancy"] is not None]
    wastes = [m["padding_waste"] for m in models.values()
              if m["padding_waste"] is not None]
    total["occupancy"] = _mean(occs)
    total["padding_waste"] = _mean(wastes)
    return {"models": models, "total": total}


def fleet_report(records):
    """Per-replica serving rollup from merged event records — the fleet
    view behind ``mxtop --serve`` and ``aggregate.build_report``.

    Groups ``serve`` records by their ``replica`` stamp (absent on
    single-process runs → ``{"replicas": {}}``).  Each replica entry
    carries ``requests``, ``batches``, ``qps`` (over that replica's
    own wall span), ``latency_ms`` {p50, p95}, ``occupancy``, and
    ``param_version`` (last seen).  Fleet-wide: ``latency_ms`` — the
    **exact sketch-merge** of the per-replica latency distributions
    (bit-identical to one sketch fed the concatenated streams; never
    an average of per-replica percentiles), ``straggler_gap_ms``
    (max p95 − median p95 across replicas — the serving analog of the
    training straggler gap), ``balance_ratio`` (max requests / mean
    requests; 1.0 = perfectly level), and ``version_skew``
    {param_version: [replicas]} — more than one key means a swap is in
    flight or failed partway.
    """
    per = {}
    for rec in records:
        if rec.get("kind") != "serve" or rec.get("replica") is None:
            continue
        r = int(rec["replica"])
        m = per.setdefault(r, {"requests": 0, "batches": 0,
                               "_lat": QuantileSketch(),
                               "_occ": [], "_walls": [],
                               "param_version": None})
        m["requests"] += int(rec.get("n_requests") or 0)
        m["batches"] += 1
        m["_lat"].extend(float(v) for v in (rec.get("lat_ms") or ()))
        if rec.get("occupancy") is not None:
            m["_occ"].append(float(rec["occupancy"]))
        if rec.get("wall_ms") is not None:
            m["_walls"].append(float(rec["wall_ms"]))
        if rec.get("param_version") is not None:
            m["param_version"] = str(rec["param_version"])
    if not per:
        return {"replicas": {}}
    replicas, p95s, reqs = {}, [], []
    sketches = []
    skew = {}
    for r, m in sorted(per.items()):
        lat = m.pop("_lat")
        occ = m.pop("_occ")
        walls = m.pop("_walls")
        out = {"requests": m["requests"], "batches": m["batches"],
               "param_version": m["param_version"],
               "occupancy": _mean(occ)}
        if lat.count:
            out["latency_ms"] = {"p50": _r(lat.percentile(50)),
                                 "p95": _r(lat.percentile(95))}
            p95s.append(lat.percentile(95))
            sketches.append(lat)
        span = (max(walls) - min(walls)) / 1e3 if len(walls) > 1 else 0.0
        out["qps"] = round(m["requests"] / span, 2) if span > 0 else None
        replicas[str(r)] = out
        reqs.append(m["requests"])
        skew.setdefault(m["param_version"] or "?", []).append(r)
    fleet = {"replicas": replicas,
             "version_skew": {v: sorted(rs)
                              for v, rs in sorted(skew.items())}}
    merged = QuantileSketch.merged(sketches)
    if merged.count:
        fleet["latency_ms"] = {"p50": _r(merged.percentile(50)),
                               "p95": _r(merged.percentile(95)),
                               "p99": _r(merged.percentile(99)),
                               "mean": _r(merged.mean())}
    if p95s:
        fleet["straggler_gap_ms"] = _r(
            max(p95s) - percentile(p95s, 50))
    if reqs and sum(reqs):
        fleet["balance_ratio"] = round(
            max(reqs) / (sum(reqs) / float(len(reqs))), 3)
    fleet["requests"] = sum(reqs)
    return fleet
