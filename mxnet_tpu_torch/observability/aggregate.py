"""Pod-wide aggregation: per-rank summaries -> one coherent pod view.

The port's copy of ``mxnet_tpu/observability/aggregate.py``.  Two data
paths, one report shape:

- **Live** (a running pod): every rank publishes its compact per-step
  summary through the coordination KV -- the process group's TCP store
  (``kvstore._dist_client``), the SAME channel the heartbeats and the
  elastic protocol ride, so there is no second RPC fabric to configure
  or fail independently.  Any rank merges them with :func:`pod_view`.
  Heartbeat ages come from the existing ``mxtpu_hb/<rank>`` liveness
  stamps (:func:`heartbeat_ages` -- the `kvstore.dead_nodes` data,
  exposed as ages instead of a dead list; deliberately NOT a second
  heartbeat).
- **Post-hoc** (a telemetry dir, live-tailed or after the job):
  :func:`read_events` merges the per-rank JSONL files and
  :func:`build_report` derives the same pod view from the records --
  what ``python -m mxnet_tpu_torch.tools.mxtop`` renders.

Report fields: step-time p50/p95 pod-wide, samples/sec (summed over
ranks), MFU, straggler gap (max - median of per-rank mean step time),
per-rank heartbeat age, last fault per rank, slowest phase, and the
ordered fault/ckpt incident timeline.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import time

from . import events, counters

__all__ = ["publish_summary", "collect_summaries", "heartbeat_ages",
           "pod_view", "read_events", "build_report", "timeline_around",
           "TEL_PREFIX"]

#: the fields of a ``static_roofline`` counter a report keeps
#: (``counters.emit_static_roofline``)
ROOFLINE_FIELDS = ("flops_per_step", "hbm_bytes_per_step", "intensity",
                   "ridge", "mfu_ceiling", "bound", "bound_ms",
                   "device_kind", "compute_dtype")

#: coordination-KV prefix for published per-rank summaries
TEL_PREFIX = "mxtpu_tel/"


def _client():
    from ..kvstore import _dist_client
    return _dist_client()


# KV fault discipline (docs/resilience.md): a coordination blip while
# reading summaries/heartbeat ages HOLDS the last good view instead of
# fabricating an empty pod — the same hold-the-verdict rule
# kvstore.dead_nodes applies — and telemeters the outage edge once
_HOLD = {"summaries": {}, "hb_ages": {}, "down": False}


def _kv_held(name, exc):
    """One read failed: note the outage once, serve the held copy."""
    if not _HOLD["down"]:
        _HOLD["down"] = True
        try:
            from .. import observability as _obs
            _obs.emit("fault", fault="kv_unreachable",
                      scope="telemetry_aggregate", op=name,
                      error=repr(exc))
        except Exception:
            pass
    return dict(_HOLD[name])


def _kv_good(name, value):
    """A read answered: refresh the held copy, close the outage."""
    _HOLD[name] = dict(value)
    if _HOLD["down"]:
        _HOLD["down"] = False
        try:
            from .. import observability as _obs
            _obs.emit("fault", fault="kv_recovered",
                      scope="telemetry_aggregate", op=name)
        except Exception:
            pass
    return value


# ----------------------------------------------------------------------
# live path (coordination-service KV)
# ----------------------------------------------------------------------
def publish_summary(step=None, extra=None):
    """Publish this rank's compact summary under ``mxtpu_tel/<rank>``
    (overwrite-in-place: one key per rank, O(ranks) total KV state).
    No-op without telemetry or a coordination client; never raises."""
    if not events.enabled():
        return False
    client = _client()
    if client is None:
        return False
    summary = counters.global_stats().snapshot()
    summary["rank"] = events.rank()
    summary["run_id"] = events.run_id()
    summary["published_at"] = time.time()
    if step is not None:
        summary["last_step"] = step
    fault = events.last_fault()
    if fault is not None:
        summary["last_fault"] = fault
    if extra:
        summary.update(extra)
    try:
        client.key_value_set(TEL_PREFIX + str(events.rank()),
                             json.dumps(summary, default=str),
                             allow_overwrite=True)
        return True
    except Exception:
        return False


def collect_summaries():
    """All published rank summaries: {rank: summary dict}.  Empty when
    no coordination service is up (single process)."""
    client = _client()
    if client is None:
        return {}
    try:
        entries = dict(client.key_value_dir_get(TEL_PREFIX))
    except Exception as exc:  # unreachable KV: hold the last view
        return _kv_held("summaries", exc)
    out = {}
    for key, val in entries.items():
        try:
            rank = int(key[len(TEL_PREFIX):]) if key.startswith(TEL_PREFIX) \
                else int(key.rsplit("/", 1)[-1])
            out[rank] = json.loads(val)
        except (ValueError, TypeError):
            continue
    return _kv_good("summaries", out)


def heartbeat_ages(num_workers=None, now=None):
    """{rank: seconds since last liveness stamp} from the EXISTING
    kvstore heartbeat keys (``mxtpu_hb/<rank>``) — the same stamps
    ``num_dead_nodes`` thresholds, surfaced as ages so an operator sees
    "rank 3 last breathed 47s ago" before the dead-count trips.
    Ranks with no stamp yet map to None."""
    from ..kvstore import _HB_PREFIX, _now
    client = _client()
    if client is None:
        return {}
    try:
        entries = dict(client.key_value_dir_get(_HB_PREFIX))
    except Exception as exc:  # unreachable KV: hold the last ages —
        ages = _kv_held("hb_ages", exc)   # never "everyone silent"
    else:
        now = _now() if now is None else now
        ages = {}
        for key, stamp in entries.items():
            try:
                rank = int(key[len(_HB_PREFIX):]) \
                    if key.startswith(_HB_PREFIX) \
                    else int(key.rsplit("/", 1)[-1])
                ages[rank] = round(now - float(stamp), 3)
            except (ValueError, TypeError):
                continue
        _kv_good("hb_ages", ages)
    if num_workers:
        for rank in range(int(num_workers)):
            ages.setdefault(rank, None)
    return ages


def pod_view(num_workers=None):
    """Merge the live published summaries + heartbeat ages into the pod
    report (coordinator-side; any rank may call it)."""
    summaries = collect_summaries()
    ages = heartbeat_ages(num_workers)
    per_rank = {str(r): s for r, s in sorted(summaries.items())}
    for rank, age in ages.items():
        per_rank.setdefault(str(rank), {})["heartbeat_age_s"] = age
    pod = _pod_rollup(per_rank)
    return {"per_rank": per_rank, "pod": pod,
            "ranks": sorted(int(r) for r in per_rank)}


def _median(vals):
    vals = sorted(vals)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


def _pod_merged_sketch(per_rank):
    """Exact pod step-time distribution: the merge of every rank's
    published ``step_sketch`` — bit-identical to one sketch fed all
    ranks' streams.  None when no rank published one (old-format
    summaries), which keeps the legacy median/max math as fallback."""
    from .metrics import QuantileSketch
    sketches = [QuantileSketch.from_dict(s.get("step_sketch"))
                for s in per_rank.values() if s.get("step_sketch")]
    sketches = [sk for sk in sketches if sk is not None and sk.count]
    return QuantileSketch.merged(sketches) if sketches else None


def _pod_rollup(per_rank):
    """Pod-level figures from per-rank summary dicts (shared by the
    live and post-hoc paths).  When ranks publish step sketches the
    pod p50/p95 are EXACT (merged distribution); otherwise the legacy
    approximation (median of rank p50s / max of rank p95s) applies."""
    means = [s["step_ms_mean"] for s in per_rank.values()
             if s.get("step_ms_mean") is not None]
    merged = _pod_merged_sketch(per_rank)
    pod = {
        "ranks": len(per_rank),
        "steps": max([s.get("last_step") or 0
                      for s in per_rank.values()] or [0]),
        "step_ms_p50": round(merged.percentile(50), 3) if merged
        else _median([s.get("step_ms_p50") for s in
                      per_rank.values()
                      if s.get("step_ms_p50") is not None]),
        "step_ms_p95": round(merged.percentile(95), 3) if merged
        else max([s.get("step_ms_p95") for s in
                  per_rank.values()
                  if s.get("step_ms_p95") is not None] or
                 [None], key=lambda v: v or 0),
        "samples_per_sec": round(sum(
            s.get("samples_per_sec") or 0 for s in per_rank.values()), 2)
        or None,
        "mfu": None,
        "straggler_gap_ms": None,
        "slowest_phase": None,
        "heartbeat_age_s": {r: s.get("heartbeat_age_s")
                            for r, s in per_rank.items()},
    }
    if means:
        pod["straggler_gap_ms"] = round(max(means) - _median(means), 3)
    mfus = [s.get("mfu") for s in per_rank.values()
            if s.get("mfu") is not None]
    if mfus:
        pod["mfu"] = round(sum(mfus) / len(mfus), 4)
    rooflines = [s["static_roofline"] for _r, s in sorted(per_rank.items())
                 if s.get("static_roofline")]
    if rooflines:
        pod["static_roofline"] = rooflines[0]
    return pod


# ----------------------------------------------------------------------
# post-hoc path (telemetry dir -> merged records -> report)
# ----------------------------------------------------------------------
def read_events(directory):
    """Merge every ``events-rank*.jsonl`` (rotated ``.1`` predecessors
    included) under ``directory`` into one wall-clock-ordered list of
    record dicts.  Unparseable lines (torn final write of a killed
    rank) are skipped, not fatal."""
    paths = sorted(_glob.glob(os.path.join(directory,
                                           "events-rank*.jsonl.1")))
    paths += sorted(_glob.glob(os.path.join(directory,
                                            "events-rank*.jsonl")))
    records = []
    for path in paths:
        try:
            with open(path) as fin:
                for line in fin:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict):
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: (r.get("wall_ms") or 0,
                                r.get("rank") or 0))
    return records


class EventTailer(object):
    """Rotation-safe incremental reader over one telemetry dir.

    Each :meth:`poll` returns only the records appended since the last
    call, across every ``events-rank*.jsonl`` (and rotated ``.1``)
    file.  Offsets are tracked **per inode**, not per path: when the
    writer hits ``MXTPU_TELEMETRY_MAX_MB`` and renames the live file to
    ``.1``, the next poll drains the renamed file from its prior offset
    and starts the fresh live file at zero — a follower never tails a
    dead inode and never re-reads what it already returned.  A partial
    trailing line (a record mid-write) is carried per inode until a
    later poll completes it, so rotation/kill can tear at most the
    final unflushed record, never a returned one.
    """

    def __init__(self, directory):
        self.directory = str(directory)
        self._state = {}        # inode -> (byte offset, carry bytes)

    def poll(self):
        """New records (wall-clock ordered) since the previous poll."""
        paths = sorted(_glob.glob(os.path.join(
            self.directory, "events-rank*.jsonl.1")))
        paths += sorted(_glob.glob(os.path.join(
            self.directory, "events-rank*.jsonl")))
        records = []
        seen = set()
        for path in paths:
            try:
                with open(path, "rb") as fin:
                    ino = os.fstat(fin.fileno()).st_ino
                    seen.add(ino)
                    offset, carry = self._state.get(ino, (0, b""))
                    fin.seek(offset)
                    chunk = fin.read()
                    offset = fin.tell()
            except OSError:
                continue
            if not chunk:
                self._state[ino] = (offset, carry)
                continue
            lines = (carry + chunk).split(b"\n")
            carry = lines.pop()          # b"" when chunk ended on \n
            self._state[ino] = (offset, carry)
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line.decode("utf-8", "replace"))
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
        for ino in list(self._state):    # bound: forget deleted files
            if ino not in seen:
                del self._state[ino]
        records.sort(key=lambda r: (r.get("wall_ms") or 0,
                                    r.get("rank") or 0))
        return records


def build_report(records, now=None):
    """The pod report from merged event records (what ``mxtop`` shows).

    Heartbeat ages: a live-published ``heartbeat_ages`` counter record
    (the drill/coordinator emits one from the KV liveness stamps) wins;
    otherwise each rank's age is derived from its LAST event — an
    honest "this rank last told us anything N seconds ago".
    """
    now_ms = (time.time() if now is None else now) * 1000.0
    ranks = sorted({r.get("rank") for r in records
                    if r.get("rank") is not None})
    run_ids = sorted({r.get("run_id") for r in records
                      if r.get("run_id")})
    per_rank = {}
    phase_totals = {}
    incidents = []
    kv_hb_ages = None
    last_elastic = None
    last_resume = None
    adopt_wall = {}             # generation -> newest propose/adopt wall
    for rec in records:
        kind = rec.get("kind")
        rank = rec.get("rank")
        state = per_rank.setdefault(str(rank), {
            "_durs": [], "_sps": [], "steps": 0, "last_step": None,
            "last_wall_ms": None, "last_fault": None})
        state["last_wall_ms"] = rec.get("wall_ms")
        if kind == "step":
            state["steps"] += 1
            if rec.get("step") is not None:
                state["last_step"] = rec["step"]
            if rec.get("dur_ms") is not None:
                state["_durs"].append(float(rec["dur_ms"]))
            if rec.get("samples_per_sec") is not None:
                state["_sps"].append(float(rec["samples_per_sec"]))
        elif kind == "span":
            name = rec.get("name") or "?"
            phase_totals[name] = phase_totals.get(name, 0.0) \
                + float(rec.get("dur_ms") or 0.0)
        elif kind == "fault":
            state["last_fault"] = {k: v for k, v in rec.items()
                                   if k not in ("run_id",)}
            incidents.append(rec)
        elif kind == "ckpt":
            incidents.append(rec)
        elif kind == "elastic":
            # re-mesh agreement trail: incident-worthy AND the pod's
            # generation/world_size come from the newest one (records
            # arrive wall-clock-sorted, so last seen wins)
            incidents.append(rec)
            if rec.get("generation") is not None:
                state["generation"] = rec.get("generation")
            last_elastic = rec
            event = rec.get("event")
            gen = rec.get("generation")
            if event in ("propose", "adopt") and gen is not None \
                    and rec.get("wall_ms") is not None:
                adopt_wall[gen] = max(adopt_wall.get(gen, 0),
                                      rec["wall_ms"])
            elif event == "resume":
                last_resume = rec
        elif kind == "counter" and rec.get("name") == "heartbeat_ages":
            kv_hb_ages = rec.get("ages")
        elif kind == "counter" and rec.get("name") == "static_roofline":
            # the analyzer's static bound of the step (newest wins)
            state["_roofline"] = {k: rec.get(k) for k in ROOFLINE_FIELDS
                                  if rec.get(k) is not None}
        elif kind == "counter" and rec.get("name") == "trainer_cost":
            if rec.get("mfu") is not None:
                state.setdefault("_mfus", []).append(float(rec["mfu"]))
            if rec.get("step_sketch"):
                # the emitter's own cumulative sketch: newest wins (a
                # sketch is monotone, so the last one is the union)
                state["_pub_sketch"] = rec["step_sketch"]

    from .metrics import QuantileSketch
    summaries = {}
    for rank, state in per_rank.items():
        durs = state.pop("_durs")
        sps = state.pop("_sps")
        mfus = state.pop("_mfus", [])
        roofline = state.pop("_roofline", None)
        pub = state.pop("_pub_sketch", None)
        s = dict(state)
        # per-rank step-time distribution: the rank's own published
        # sketch when it emitted one, else the step records folded
        # into a fresh sketch — either way percentiles come from the
        # sketch, and the dict rides along so _pod_rollup merges
        # rank distributions exactly
        sketch = QuantileSketch.from_dict(pub) if pub else None
        if sketch is None and durs:
            sketch = QuantileSketch(
                alpha=counters.StepStats.SKETCH_ALPHA)
            sketch.extend(durs)
        if durs:
            s["step_ms_mean"] = round(sum(durs) / len(durs), 3)
        if sketch is not None and sketch.count:
            s["step_ms_p50"] = round(sketch.percentile(50), 3)
            s["step_ms_p95"] = round(sketch.percentile(95), 3)
            s.setdefault("step_ms_mean", round(sketch.mean(), 3))
            s["step_sketch"] = sketch.to_dict()
        if sps:
            s["samples_per_sec"] = round(sps[-1], 2)
        elif durs and s.get("step_ms_mean"):
            pass                        # no batch size known: omit
        if mfus:
            s["mfu"] = round(sum(mfus) / len(mfus), 4)
        if roofline:
            s["static_roofline"] = roofline
        if kv_hb_ages and str(rank) in {str(k) for k in kv_hb_ages}:
            age = kv_hb_ages.get(rank, kv_hb_ages.get(str(rank)))
            s["heartbeat_age_s"] = age
        elif state.get("last_wall_ms"):
            s["heartbeat_age_s"] = round(
                (now_ms - state["last_wall_ms"]) / 1e3, 3)
        summaries[rank] = s

    pod = _pod_rollup(summaries)
    if last_elastic is not None:
        pod["generation"] = last_elastic.get("generation")
        if last_elastic.get("world_size") is not None:
            pod["world_size"] = last_elastic.get("world_size")
        pod["last_elastic"] = {
            k: last_elastic.get(k)
            for k in ("event", "generation", "world_size", "reason",
                      "from_world", "rank", "step", "path",
                      "fallback_reason", "duration_ms")
            if last_elastic.get(k) is not None}
    if last_resume is not None:
        # the recovery-cost rollup: which rung of the resume
        # ladder the last transition took (warm = host memory, cold =
        # checkpoint), the restore cost the resume event measured
        # itself, and the end-to-end transition wall — verdict
        # adopt/propose (old incarnation) to resume (new one), pairable
        # because both carry the agreed generation
        tr = {k: last_resume.get(k)
              for k in ("path", "generation", "step", "world_size",
                        "fallback_reason", "duration_ms")
              if last_resume.get(k) is not None}
        gen = last_resume.get("generation")
        if gen in adopt_wall and last_resume.get("wall_ms") is not None \
                and last_resume["wall_ms"] >= adopt_wall[gen]:
            tr["transition_ms"] = round(
                last_resume["wall_ms"] - adopt_wall[gen], 3)
        pod["last_transition"] = tr
    if phase_totals:
        pod["slowest_phase"] = max(phase_totals, key=phase_totals.get)
        pod["phase_totals_ms"] = {k: round(v, 3)
                                  for k, v in sorted(phase_totals.items())}
    # input-pipeline overlap proof (docs/perf.md "Overlap"): serial
    # phase time vs step wall — >1 means data_wait/h2d hid under compute
    from .spans import overlap_report
    ov = overlap_report(records)
    if ov["overlap_ratio"] is not None:
        pod["overlap_ratio"] = ov["overlap_ratio"]
        if ov["phase_p50_ms"]:
            pod["phase_p50_ms"] = ov["phase_p50_ms"]
    out = {"run_ids": run_ids, "ranks": ranks, "events": len(records),
           "pod": pod, "per_rank": summaries, "incidents": incidents}
    # serving rollup (docs/serving.md): per-model QPS/latency/occupancy
    # from "serve" records, when any exist (lazy import: serving is a
    # consumer of observability, not a dependency)
    try:
        from ..serving.telemetry import serve_report
        sv = serve_report(records)
    except Exception:
        sv = None
    if sv and sv.get("models"):
        out["serve"] = sv
    # fleet rollup (docs/serving.md "Fleet"): per-replica qps/p95/
    # occupancy/param-version + fleet-wide straggler gap and version
    # skew, from the replica-stamped serve records
    try:
        from ..serving.telemetry import fleet_report
        fl = fleet_report(records)
    except Exception:
        fl = None
    if fl and fl.get("replicas"):
        out["fleet"] = fl
    # retrace rollup (docs/perf.md, observability/retrace.py): the
    # sentry's attributed post-warmup lowerings — count, the divergent
    # cache-key ingredients, and the requesting sites.  Present only
    # when "retrace" records exist, i.e. the contract was violated.
    retraces = [r for r in records if r.get("kind") == "retrace"]
    if retraces:
        divergent = {}
        for r in retraces:
            for ingredient in (r.get("divergent") or ["unknown"]):
                divergent[ingredient] = divergent.get(ingredient, 0) \
                    + int(r.get("n") or 1)
        out["retrace"] = {
            "count": sum(int(r.get("n") or 1) for r in retraces),
            "divergent": dict(sorted(divergent.items())),
            "sites": sorted({r.get("site") for r in retraces
                             if r.get("site")})[:8],
        }
    # pipeline-schedule rollup (docs/graph_lint.md "MXL-E"): the
    # GPipe/1F1B shape + measured bubble fraction the GPipeTrainer
    # emits once on first build, and the expert load balance when an
    # MoE run reports one.  String-tolerant — these round-trip through
    # shell/env in the drills, so "0.33" reads like 0.33 and junk is
    # dropped rather than crashed on.
    scheds = [r for r in records if r.get("kind") == "schedule"]
    if scheds:
        def _flt(v):
            try:
                return float(v)
            except (TypeError, ValueError):
                return None
        last = scheds[-1]
        sched = {"schedule": str(last.get("schedule") or "?")}
        for key in ("stages", "microbatches"):
            n = _flt(last.get(key))
            if n is not None:
                sched[key] = int(n)
        for key in ("bubble_fraction", "expert_balance"):
            v = _flt(last.get(key))
            if v is not None:
                sched[key] = v
        out["schedule"] = sched
    # SLO rollup (observability/sloengine.py): alert edges and scale
    # recommendations, when the live engine emitted any — what the
    # mxtop SLO pane renders post-hoc
    alerts = [r for r in records if r.get("kind") == "slo_alert"]
    recos = [r for r in records if r.get("kind") == "counter"
             and r.get("name") == "slo_recommendation"]
    if alerts or recos:
        fires = [r for r in alerts if r.get("edge") == "fire"]
        active = {}
        for r in alerts:        # wall-clock order: last edge wins
            key = "%s/%s" % (r.get("metric"), r.get("tier"))
            active[key] = r.get("edge") == "fire"
        out["slo"] = {
            "alerts": len(fires),
            "page_alerts": len([r for r in fires
                                if r.get("tier") == "page"]),
            "active": sorted(k for k, v in active.items() if v),
            "last_alert": alerts[-1] if alerts else None,
            "recommendations": len(recos),
            "last_recommendation": recos[-1] if recos else None,
        }
    return out


def timeline_around(records, index, before=5, after=5):
    """The event window around ``records[index]`` (an incident) — what
    ``mxtop --fault`` prints so "what happened before the restart" is
    one command, not eight grepped logs."""
    lo = max(0, index - before)
    hi = min(len(records), index + after + 1)
    return records[lo:hi]
