"""Seeded telemetry records for the observability twins: the same event
log goes through the JAX package's readers and the port's, which must
agree exactly.

:func:`records` draws, for each rank, step records, phase spans,
collectives with sequence numbers, serving batches (plain and
generative, stamped with a replica and a parameter version), faults,
checkpoint and elastic incidents, a ``trainer_cost`` counter with its
step sketch, a ``heartbeat_ages`` counter (so a report's heartbeat ages
do not depend on the wall clock), retrace records, a pipeline schedule
and SLO alert edges with a recommendation.  :func:`write_dir` writes
them as the per-rank JSONL files of a telemetry dir, with a torn final
line on the last rank.
"""
import json
import os

import numpy as np

BASE_MS = 1_700_000_000_000.0


def _sketch(durs, alpha=0.005):
    """A serialized QuantileSketch of ``durs`` as the emitter writes it
    (either package's; their formats are one)."""
    from mxnet_tpu_torch.observability.metrics import QuantileSketch
    sk = QuantileSketch(alpha=alpha)
    sk.extend(durs)
    return sk.to_dict()


def records(seed, ranks=2, steps=12):
    rng = np.random.RandomState(seed)
    out = []
    for rank in range(ranks):
        t = BASE_MS + rank * 0.5
        durs = []

        def rec(kind, **fields):
            r = {"run_id": "twin", "rank": rank, "kind": kind,
                 "wall_ms": round(t, 3), "step": fields.pop("step", None)}
            r.update(fields)
            out.append(r)

        for step in range(1, steps + 1):
            dur = float(round(10.0 + 5.0 * rank + rng.gamma(2.0, 1.5), 3))
            durs.append(dur)
            t += dur
            for name in ("data_wait", "h2d", "step", "allreduce"):
                rec("span", step=step, name=name,
                    dur_ms=round(float(rng.uniform(0.1, 4.0)), 3),
                    trace_id="t%d" % rank, span_id="s%d.%d" % (rank, step))
            rec("collective", step=step, op="allreduce", seq=step - 1,
                bytes=4096, dur_ms=round(float(rng.uniform(0.5, 2.0)), 3),
                num_workers=ranks)
            rec("step", step=step, dur_ms=dur, batch_size=8,
                samples_per_sec=round(8 / (dur / 1e3), 2))
            t += 1.0
            if step % 3 == 0:
                lats = [round(float(v), 3)
                        for v in rng.lognormal(3.0, 0.6, size=4)]
                rec("serve", model="lm", bucket=4, n_requests=4,
                    n_samples=4, occupancy=1.0, padding_waste=0.0,
                    queue_depth=int(rng.randint(0, 5)),
                    queue_wait_ms=1.5, pack_ms=0.25, device_ms=7.5,
                    unpack_ms=0.5, lat_ms=lats, phase="decode", tokens=4,
                    kv_occupancy=0.25, ttft_ms=lats[:2], itl_ms=lats[2:],
                    replica=rank, param_version="v1")
                rec("serve", model="mlp", bucket=8, n_requests=3,
                    n_samples=6, occupancy=0.75, padding_waste=0.25,
                    queue_depth=1, queue_wait_ms=0.5, pack_ms=0.125,
                    device_ms=2.0, unpack_ms=0.25,
                    lat_ms=[4.0, 5.5, 6.25], replica=rank,
                    param_version="v1")
            if step == 5:
                rec("fault", step=step, fault="sentinel_skip",
                    phase="step")
            if step == 8:
                rec("ckpt", step=step, phase="commit", path="/ckpt/8")
        rec("counter", step=steps, name="trainer_cost",
            flops_per_step=5505024.0, mfu=round(0.25 + 0.05 * rank, 4),
            step_time_s=0.012, step_sketch=_sketch(durs))
        rec("retrace", divergent=["graph_fingerprint"], site="x.py:1",
            detail={}, n=1)
        t += 2.0
        if rank == 0:
            rec("elastic", event="propose", generation=1, world_size=ranks,
                reason="dead_node", from_world=ranks + 1)
            rec("elastic", event="resume", generation=1, world_size=ranks,
                path="warm", duration_ms=12.5)
            rec("schedule", schedule="1f1b", stages="2", microbatches=4,
                bubble_fraction="0.33")
            rec("slo_alert", metric="mxtpu_serve_latency_ms", tier="page",
                edge="fire", target=250.0, budget=0.01,
                threshold_burn=14.0, windows_s=[60, 10],
                burns={"60": 31.2, "10": 48.0}, at=1.0, source="twin")
            rec("counter", name="slo_recommendation",
                action="recommend_grow", gen=1,
                metric="mxtpu_serve_latency_ms", reason="page-tier burn")
            rec("counter", name="heartbeat_ages",
                ages={str(r): 1.5 + r for r in range(ranks)})
    return out


def write_dir(directory, recs, torn=True):
    """The records as ``events-rank%05d.jsonl`` files under
    ``directory`` (a torn final line on the last rank's file)."""
    os.makedirs(directory, exist_ok=True)
    by_rank = {}
    for r in recs:
        by_rank.setdefault(r["rank"], []).append(r)
    last = max(by_rank)
    for rank, rs in by_rank.items():
        with open(os.path.join(directory, "events-rank%05d.jsonl" % rank),
                  "w") as f:
            for r in rs:
                f.write(json.dumps(r) + "\n")
            if torn and rank == last:
                f.write('{"kind": "st')
    return directory


def roundtrip(doc):
    """``doc`` after a JSON round trip (tuples become lists, keys
    strings), so two packages' dicts compare by value."""
    return json.loads(json.dumps(doc, sort_keys=True, default=str))
