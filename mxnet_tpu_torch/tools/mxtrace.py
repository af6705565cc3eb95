"""mxtrace: merge per-rank telemetry JSONLs into one Chrome trace.

The port's copy of ``tools/mxtrace.py``; the serving phases come from
:mod:`mxnet_tpu_torch.observability.phases`.

Reads every ``events-rank*.jsonl`` (rotated ``.1`` predecessors
included) and ``flight-rank*.json`` crash dump under a telemetry
directory and writes a single Chrome-trace/Perfetto JSON document
(load it at ``chrome://tracing`` or https://ui.perfetto.dev):

- one **process track per rank** (pid = rank), with named thread lanes:
  tid 0 steps, tid 1 host phases (spans + collectives), tid 2 the async
  producer's spans (records tagged ``async``), tid 3 serving batches;
- ``step`` / ``span`` records become complete ("X") slices laid
  backward from their emit wall time; span records carry their
  ``trace_id``/``span_id``/``parent_span`` fields (``MXTPU_TRACE=1``)
  in ``args``, so a Perfetto query can follow one request or one
  training thread across lanes;
- ``collective`` records with a ``seq`` are stitched **across ranks**
  with flow events ("s"/"f" arrows): launch order is rank-uniform
  (``@collective_seam``), so ``(op, seq)`` names the same physical
  collective on every rank and the arrow connects its participants;
- ``serve`` records expand into their queue_wait/pack/device/unpack
  phase slices on the serving lane;
- ``fault`` records and flight-dump pending collectives become instant
  events ("i") — the hung ``(op, seq)`` shows up as a marker on the
  rank that never finished it.

Usage::

    python -m mxnet_tpu_torch.tools.mxtrace TELEMETRY_DIR -o trace.json
    python -m mxnet_tpu_torch.tools.mxtrace TELEMETRY_DIR            # stdout
"""
import argparse
import glob
import json
import os
import sys

from mxnet_tpu_torch.observability.phases import SERVE_PHASES

#: thread-lane layout per rank process
TID_STEP, TID_HOST, TID_ASYNC, TID_SERVE = 0, 1, 2, 3
_LANES = {TID_STEP: "steps", TID_HOST: "host phases",
          TID_ASYNC: "async producer", TID_SERVE: "serving"}


def read_records(directory):
    """All event records under ``directory``, wall-clock ordered
    (rotated files first so order survives rotation; torn lines of a
    killed rank are skipped, not fatal)."""
    paths = sorted(glob.glob(os.path.join(directory,
                                          "events-rank*.jsonl.1")))
    paths += sorted(glob.glob(os.path.join(directory,
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


def read_flight_dumps(directory):
    """Every ``flight-rank*.json`` crash dump under ``directory``."""
    dumps = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              "flight-rank*.json"))):
        try:
            with open(path) as fin:
                doc = json.load(fin)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict):
            dumps.append(doc)
    return dumps


def _args_of(rec, skip=("run_id", "rank", "kind", "step", "wall_ms",
                        "dur_ms")):
    return {k: v for k, v in rec.items() if k not in skip}


def _slice(name, pid, tid, end_ms, dur_ms, step=None, args=None):
    """A complete ("X") event laid BACKWARD from its emit time — every
    record is emitted when its phase ends, so start = end - duration."""
    dur_us = max(int(float(dur_ms or 0.0) * 1000.0), 1)
    ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
          "ts": int(float(end_ms) * 1000.0) - dur_us, "dur": dur_us,
          "cat": "mxtpu"}
    a = dict(args or {})
    if step is not None:
        a["step"] = step
    if a:
        ev["args"] = a
    return ev


def build_trace(records, flight_dumps=()):
    """Event records (+ optional flight dumps) -> Chrome-trace doc."""
    events = []
    ranks = sorted({int(r.get("rank") or 0) for r in records}
                   | {int(d.get("rank") or 0) for d in flight_dumps})
    for rank in ranks:
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "args": {"name": "rank %d" % rank}})
        for tid, label in sorted(_LANES.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": tid, "args": {"name": label}})

    # (op, seq) -> [(rank, ts_us)] for cross-rank flow stitching
    collectives = {}
    flow_id = [0]

    for rec in records:
        kind = rec.get("kind")
        rank = int(rec.get("rank") or 0)
        wall = rec.get("wall_ms")
        if wall is None:
            continue
        if kind == "step":
            events.append(_slice(
                "step", rank, TID_STEP, wall, rec.get("dur_ms"),
                step=rec.get("step"), args=_args_of(rec)))
        elif kind == "span":
            tid = TID_ASYNC if rec.get("async") else TID_HOST
            events.append(_slice(
                rec.get("name") or "span", rank, tid, wall,
                rec.get("dur_ms"), step=rec.get("step"),
                args=_args_of(rec, skip=("run_id", "rank", "kind",
                                         "step", "wall_ms", "dur_ms",
                                         "name"))))
        elif kind == "collective":
            op, seq = rec.get("op") or "collective", rec.get("seq")
            name = op if seq is None else "%s seq=%s" % (op, seq)
            ev = _slice(name, rank, TID_HOST, wall, rec.get("dur_ms"),
                        step=rec.get("step"), args=_args_of(rec))
            events.append(ev)
            if seq is not None:
                collectives.setdefault((op, seq), []).append(
                    (rank, ev["ts"]))
        elif kind == "serve":
            end = float(wall)
            for phase in reversed(SERVE_PHASES):
                dur = rec.get(phase + "_ms")
                if dur is None:
                    continue
                events.append(_slice(
                    "%s %s" % (rec.get("model") or "serve", phase),
                    rank, TID_SERVE, end, dur,
                    args={"bucket": rec.get("bucket"),
                          "n_requests": rec.get("n_requests"),
                          "occupancy": rec.get("occupancy"),
                          "trace_ids": rec.get("trace_ids")}))
                end -= float(dur)
        elif kind == "counter" and rec.get("name") == "static_roofline":
            # the analyzer's static bound of a step, beside its steps
            events.append({
                "ph": "i", "s": "p", "cat": "mxtpu",
                "name": "static_roofline", "pid": rank, "tid": TID_STEP,
                "ts": int(float(wall) * 1000.0),
                "args": _args_of(rec)})
        elif kind in ("fault", "elastic"):
            events.append({
                "ph": "i", "s": "p", "cat": "mxtpu",
                "name": "%s:%s" % (kind, rec.get("fault")
                                   or rec.get("event") or "?"),
                "pid": rank, "tid": TID_HOST,
                "ts": int(float(wall) * 1000.0),
                "args": _args_of(rec)})

    # flow arrows: one per collective that ≥2 ranks reported.  "s"
    # starts at the first participant's slice, "f" (bp="e") lands on
    # each of the others — the visual "these slices are one collective"
    for (op, seq), parts in sorted(collectives.items()):
        if len(parts) < 2:
            continue
        flow_id[0] += 1
        parts.sort()
        first_rank, first_ts = parts[0]
        base = {"cat": "collective", "name": "%s seq=%s" % (op, seq),
                "id": flow_id[0]}
        events.append(dict(base, ph="s", pid=first_rank, tid=TID_HOST,
                           ts=first_ts))
        for rank, ts in parts[1:]:
            events.append(dict(base, ph="f", bp="e", pid=rank,
                               tid=TID_HOST, ts=ts))

    for doc in flight_dumps:
        rank = int(doc.get("rank") or 0)
        ts = int(float(doc.get("wall_ms") or 0) * 1000.0)
        for entry in doc.get("pending_collectives") or ():
            events.append({
                "ph": "i", "s": "g", "cat": "mxtpu-flight",
                "name": "PENDING %s seq=%s" % (entry.get("op"),
                                               entry.get("seq")),
                "pid": rank, "tid": TID_HOST, "ts": ts,
                "args": dict(entry, reason=doc.get("reason"),
                             absent_ranks=doc.get("absent_ranks"))})

    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"tool": "mxtrace",
                          "n_records": len(records),
                          "n_flight_dumps": len(flight_dumps)}}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxtrace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("directory", help="telemetry dir (MXTPU_TELEMETRY_DIR)")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--no-flight", action="store_true",
                    help="ignore flight-rank*.json crash dumps")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.directory):
        sys.stderr.write("mxtrace: no such directory: %s\n"
                         % args.directory)
        return 2
    records = read_records(args.directory)
    dumps = () if args.no_flight else read_flight_dumps(args.directory)
    if not records and not dumps:
        sys.stderr.write("mxtrace: no events under %s\n" % args.directory)
        return 1
    doc = build_trace(records, dumps)
    if args.output:
        with open(args.output, "w") as fout:
            json.dump(doc, fout, separators=(",", ":"))
        sys.stderr.write(
            "mxtrace: %d trace events (%d ranks) -> %s\n"
            % (len(doc["traceEvents"]),
               len({e["pid"] for e in doc["traceEvents"]}), args.output))
    else:
        json.dump(doc, sys.stdout, indent=1)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
