"""The port's observability slice against the JAX package, on the CPU.

Twins of ``tests/test_observability.py`` (step statistics, the aggregate
report builder, ``mxtop --json``, the SLO pane, the two-process pod
drill) and of ``tests/test_metric_init.py``'s profiler test: the same
seeded records (``tests/torch_obs_records.py``) written as a telemetry
dir go through ``mxnet_tpu.observability.aggregate`` and
``mxnet_tpu_torch.observability.aggregate``, and the same step timings
through both packages' ``StepStats`` and ``record_step``.  Results must
be equal: dicts after a JSON round trip, text byte for byte.  The peak
table and MFU, the profiler over ``torch.profiler`` and the jax-free
import of the slice's modules are checked in the port alone.
"""
import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mxnet_tpu import observability as jobs
from mxnet_tpu.observability import aggregate as jagg
from mxnet_tpu.observability import counters as jcounters
from mxnet_tpu.observability import events as jevents

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import aggregate as tagg
from mxnet_tpu_torch.observability import counters as tcounters
from mxnet_tpu_torch.observability import events as tevents

import torch_obs_records as recs_mod

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
import launch  # noqa: E402
import mxtop as jmxtop  # noqa: E402
from mxnet_tpu_torch.tools import mxtop as tmxtop  # noqa: E402


def _reset():
    for ev, co in ((jevents, jcounters), (tevents, tcounters)):
        ev.refresh()
        co.reset()


@pytest.fixture(autouse=True)
def _telemetry_off(monkeypatch):
    """Each test starts with telemetry off and pristine singletons, in
    both packages."""
    for var in ("MXTPU_TELEMETRY", "MXTPU_TELEMETRY_DIR", "MXTPU_RUN_ID",
                "BENCH_PEAK_TFLOPS"):
        monkeypatch.delenv(var, raising=False)
    _reset()
    yield
    _reset()


def _enable(monkeypatch, directory, run_id="twin"):
    monkeypatch.setenv("MXTPU_TELEMETRY", "1")
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(directory))
    monkeypatch.setenv("MXTPU_RUN_ID", run_id)
    _reset()
    return str(directory)


# ----------------------------------------------------------------------
# the aggregate report over one seeded telemetry dir
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_events_and_build_report_equal(tmp_path, seed):
    """``read_events`` (torn final line skipped), ``build_report`` at a
    fixed clock and ``timeline_around`` each incident: equal in both
    packages."""
    d = recs_mod.write_dir(str(tmp_path / "tel"), recs_mod.records(seed))
    j_recs, t_recs = jagg.read_events(d), tagg.read_events(d)
    assert t_recs == j_recs and len(t_recs) > 100
    now = recs_mod.BASE_MS / 1e3 + 60.0
    j_rep = jagg.build_report(j_recs, now=now)
    t_rep = tagg.build_report(t_recs, now=now)
    assert recs_mod.roundtrip(t_rep) == recs_mod.roundtrip(j_rep)
    # every section of the report is exercised
    for key in ("pod", "per_rank", "incidents", "serve", "fleet",
                "retrace", "schedule", "slo"):
        assert t_rep.get(key), key
    assert t_rep["pod"]["mfu"] is not None
    assert t_rep["pod"]["last_transition"]["path"] == "warm"
    for i, r in enumerate(t_recs):
        if r["kind"] in ("fault", "ckpt", "elastic"):
            assert tagg.timeline_around(t_recs, i, 3, 4) == \
                jagg.timeline_around(j_recs, i, 3, 4)


def test_build_report_straggler_and_faults():
    """Twin of the JAX test of the same name: straggler gap, the
    heartbeat-ages counter, the last fault, the incident order."""
    def mk(kind, rank, wall_ms, **f):
        return dict(run_id="r", rank=rank, kind=kind, wall_ms=wall_ms,
                    step=f.pop("step", None), **f)
    recs = []
    t = 1000
    for step in range(10):
        recs.append(mk("step", 0, t, step=step, dur_ms=10.0,
                       samples_per_sec=100.0))
        recs.append(mk("step", 1, t + 1, step=step, dur_ms=30.0,
                       samples_per_sec=40.0))
        t += 40
    recs.append(mk("fault", 1, t, step=9, fault="sentinel_skip"))
    recs.append(mk("ckpt", 0, t + 1, step=9, phase="commit"))
    recs.append(mk("counter", 0, t + 2, name="heartbeat_ages",
                   ages={"0": 1.5, "1": 2.5}))
    rep = tagg.build_report(recs, now=5.0)
    assert recs_mod.roundtrip(rep) == recs_mod.roundtrip(
        jagg.build_report(recs, now=5.0))
    pod = rep["pod"]
    assert pod["samples_per_sec"] == pytest.approx(140.0)
    assert pod["straggler_gap_ms"] == pytest.approx(10.0)
    assert rep["per_rank"]["1"]["heartbeat_age_s"] == 2.5
    assert rep["per_rank"]["1"]["last_fault"]["fault"] == "sentinel_skip"
    assert [r["kind"] for r in rep["incidents"]] == ["fault", "ckpt"]


@pytest.mark.parametrize("ranks", [1, 3])
def test_pod_rollup_merges_step_sketches(ranks):
    """The pod p50/p95 are the exact merge of the ranks' sketches, as in
    the JAX package, and the rollups are equal."""
    from mxnet_tpu_torch.observability.metrics import QuantileSketch
    rng = np.random.RandomState(ranks)
    recs, all_durs = [], []
    for step in range(20):
        for rank in range(ranks):
            dur = float(round(10.0 * (rank + 1) + rng.rand(), 3))
            all_durs.append(dur)
            recs.append(dict(run_id="r", rank=rank, kind="step", step=step,
                             wall_ms=1000 + 40 * step + rank, dur_ms=dur))
    rep = tagg.build_report(recs, now=2.0)
    assert recs_mod.roundtrip(rep) == recs_mod.roundtrip(
        jagg.build_report(recs, now=2.0))
    whole = QuantileSketch(alpha=tcounters.StepStats.SKETCH_ALPHA)
    whole.extend(all_durs)
    assert rep["pod"]["step_ms_p50"] == round(whole.percentile(50), 3)
    assert rep["pod"]["step_ms_p95"] == round(whole.percentile(95), 3)


def test_event_tailer_across_rotation_equal(tmp_path):
    """``EventTailer`` in both packages over the same writes: a rotation
    (the live file renamed to ``.1`` with an unpolled record, a fresh
    live file) and a record torn mid-write, then completed."""
    d = str(tmp_path)
    path = os.path.join(d, "events-rank00000.jsonl")

    def rec(i):
        return json.dumps({"kind": "step", "step": i, "rank": 0,
                           "wall_ms": i * 10}) + "\n"

    tailers = (jagg.EventTailer(d), tagg.EventTailer(d))
    polls = []

    def poll():
        got = [t.poll() for t in tailers]
        assert got[1] == got[0]
        polls.append([r["step"] for r in got[1]])

    poll()
    with open(path, "w") as f:
        f.write(rec(1) + rec(2))
    poll()
    with open(path, "a") as f:
        f.write(rec(3))
    os.rename(path, path + ".1")
    with open(path, "w") as f:
        f.write(rec(4) + rec(5)[:9])
    poll()
    with open(path, "a") as f:
        f.write(rec(5)[9:])
    poll()
    poll()
    assert polls == [[], [1, 2], [3, 4], [5], []]


# ----------------------------------------------------------------------
# StepStats and record_step
# ----------------------------------------------------------------------
def test_step_stats_snapshot():
    """Twin of ``test_step_stats_snapshot``: the same 100 timings give
    the same snapshot in both packages."""
    snaps = []
    for co in (jcounters, tcounters):
        st = co.StepStats(batch_size=32)
        for i in range(100):
            st.observe(0.010 + (0.010 if i == 99 else 0.0), step=i)
        snaps.append(st.snapshot())
    assert snaps[1] == snaps[0]
    snap = snaps[1]
    assert snap["steps"] == 100 and snap["last_step"] == 99
    assert snap["step_ms_p50"] == pytest.approx(10.0, rel=0.01)
    assert snap["step_ms_ema"] > 10.0
    assert snap["samples_per_sec"] == pytest.approx(32 / 0.0101, rel=0.01)


def test_step_stats_sketch_backing():
    """Twin of ``test_step_stats_sketch_backing``."""
    from mxnet_tpu_torch.observability.metrics import QuantileSketch
    st = tcounters.StepStats(batch_size=8)
    jst = jcounters.StepStats(batch_size=8)
    for i in range(50):
        st.observe(0.010 + 0.0001 * i, step=i)
        jst.observe(0.010 + 0.0001 * i, step=i)
    snap = st.snapshot()
    assert snap == jst.snapshot()
    back = QuantileSketch.from_dict(snap["step_sketch"])
    assert back.count == 50
    assert back.quantile(0.5) == pytest.approx(snap["step_ms_p50"],
                                               abs=1e-3)


def test_record_step_feeds_global_stats(monkeypatch, tmp_path):
    """``record_step`` folds each step into ``global_stats()`` and the
    ``mxtpu_step_ms`` histogram, and publishes nothing without a
    coordination client; the snapshots and the step records (less their
    wall clocks) are equal in both packages."""
    from mxnet_tpu.observability import metrics as jmetrics
    from mxnet_tpu_torch.observability import metrics as tmetrics
    durs = np.random.RandomState(3).gamma(2.0, 0.004, size=25)
    out = {}
    for name, pkg, ev, mt in (("jax", jobs, jevents, jmetrics),
                              ("port", tobs, tevents, tmetrics)):
        d = _enable(monkeypatch, tmp_path / name)
        mt.reset_registry()
        for i, dur in enumerate(durs):
            pkg.record_step(i + 1, float(dur), batch_size=8, epoch=0)
        ev.flush()
        fed = sum(h.cumulative.count
                  for h in mt.registry().histograms("mxtpu_step_ms"))
        steps = [{k: v for k, v in r.items() if k != "wall_ms"}
                 for r in pkg.read_events(d) if r["kind"] == "step"]
        out[name] = (pkg.global_stats().snapshot(), fed, steps)
        monkeypatch.delenv("MXTPU_TELEMETRY")
        _reset()
    assert out["port"] == out["jax"]
    snap, fed, steps = out["port"]
    assert snap["steps"] == 25 and fed == 25 and len(steps) == 25
    assert tagg.publish_summary(step=10) is False     # telemetry off


def test_record_step_is_a_noop_when_off(tmp_path):
    tobs.record_step(1, 0.01, batch_size=4)
    assert tcounters._GLOBAL["stats"] is None
    assert not os.listdir(tmp_path)


# ----------------------------------------------------------------------
# the peak table and MFU
# ----------------------------------------------------------------------
def test_peak_table_by_card_and_dtype(monkeypatch):
    sxm = "NVIDIA H100 80GB HBM3"
    assert tcounters.peak_tflops(sxm) == 67.0
    assert tcounters.peak_tflops(sxm, "float32") == 67.0
    import torch
    assert tcounters.peak_tflops(sxm, torch.bfloat16) == 989.0
    assert tcounters.peak_tflops(sxm, "bfloat16") == 989.0
    assert tcounters.peak_tflops("NVIDIA H100 PCIe", "float32") == 51.0
    assert tcounters.PEAKS[sxm]["bytes_per_s"] == 3.35e12
    assert tcounters.peak_tflops("Some Other Card") is None
    assert tcounters.mfu(1e12, 1.0, device_name="Some Other Card") is None
    # float32 priced at the FMA peak, not the tensor cores'
    assert tcounters.mfu(6.7e12, 1.0, device_name=sxm) == pytest.approx(0.1)
    assert tcounters.mfu(6.7e12, 1.0, device_name=sxm, dtype="bfloat16") \
        == pytest.approx(6.7e12 / 989e12)
    assert tcounters.mfu(6.7e12, 1.0, n_devices=2, device_name=sxm) == \
        pytest.approx(0.05)
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123.5")
    assert tcounters.peak_tflops("Some Other Card") == 123.5
    assert tcounters.mfu(2.47e12, 0.1, device_name="x") == pytest.approx(
        jcounters.mfu(2.47e12, 0.1, device_kind="x"))


def test_analyzer_counters_raise_naming_the_queue_item():
    """The two analyzer counters raised naming ROADMAP item 4 (g) until
    the analyzer was ported; now they return the JAX package's values:
    ``collective_bytes`` its ``comm_report`` on the same graph and mesh,
    and both give nothing (not a raise) for a graph they cannot price."""
    import mxnet_tpu as jmx
    shapes = {"data": (2, 64), "softmax_label": (2, 64)}
    got = {}
    for mx, counters in ((jmx, jcounters), (tmx, tcounters)):
        from importlib import import_module
        tf = import_module(mx.__name__ + ".models.transformer")
        sym = tf.get_symbol(vocab_size=512, num_layers=2, num_heads=4,
                            dim=64, seq_len=64)
        got[mx.__name__] = counters.collective_bytes(
            sym, mx.parallel.LogicalMesh(dp=2, tp=2), shapes=shapes,
            target="cpu")
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"]
    assert got["mxnet_tpu_torch"]["total_bytes"] > 0
    assert tcounters.collective_bytes(None, None) is None
    assert tcounters.emit_static_roofline(None, {}) == {}


# ----------------------------------------------------------------------
# mxtop
# ----------------------------------------------------------------------
def _run(argv, env=None, timeout=120):
    return subprocess.run(argv, cwd=_ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_mxtop_json_equal(tmp_path):
    """``mxtop --json`` over the same dir: the port's ``python -m
    mxnet_tpu_torch.tools.mxtop`` prints the JAX ``tools/mxtop.py``'s
    report, its heartbeat ages from the dir's ``heartbeat_ages``
    counter."""
    d = recs_mod.write_dir(str(tmp_path / "tel"), recs_mod.records(5))
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = _run([sys.executable, "-m", "mxnet_tpu_torch.tools.mxtop", d,
                 "--json"], env)
    ref = _run([sys.executable, os.path.join(_ROOT, "tools", "mxtop.py"), d,
                "--json"], env)
    assert port.returncode == 0 and ref.returncode == 0, \
        port.stderr + ref.stderr
    assert json.loads(port.stdout) == json.loads(ref.stdout)
    assert json.loads(port.stdout)["pod"]["mfu"] is not None


@pytest.mark.parametrize("view", ["render", "render_serve",
                                  "render_fault_timelines", "render_slo"])
def test_mxtop_text_views_equal(tmp_path, view):
    """Each of mxtop's text views renders the same report to the same
    text in both packages (the pod view, the serving view, the fault
    timelines, the SLO pane)."""
    recs = recs_mod.records(7)
    now = recs_mod.BASE_MS / 1e3 + 30.0
    out = []
    for mod, agg in ((jmxtop, jagg), (tmxtop, tagg)):
        buf = io.StringIO()
        if view == "render_fault_timelines":
            mod.render_fault_timelines(recs, 2, 2, stream=buf)
        else:
            getattr(mod, view)(agg.build_report(recs, now=now),
                               stream=buf)
        out.append(buf.getvalue())
    assert out[1] == out[0] and out[1]
    if view == "render_slo":
        assert "SLO" in out[1] and "recommend_grow" in out[1]


def test_mxtop_cli_views(monkeypatch, tmp_path):
    """Twin of ``test_mxtop_json`` and ``test_mxtop_surfaces_elastic_
    generation``: the port's records through the port's CLI."""
    d = _enable(monkeypatch, tmp_path / "tel")
    for i in range(5):
        tobs.record_step(i, 0.01, batch_size=8)
    tevents.emit("fault", step=3, fault="watchdog_timeout", phase="step")
    tevents.emit("elastic", event="propose", generation=1, world_size=2,
                 reason="dead_node", from_world=3)
    tevents.flush()
    buf = io.StringIO()
    monkeypatch.setattr(sys, "stdout", buf)
    assert tmxtop.main([d, "--json"]) == 0
    rep = json.loads(buf.getvalue())
    assert rep["pod"]["step_ms_p50"] is not None and "mfu" in rep["pod"]
    assert rep["per_rank"]["0"]["last_fault"]["fault"] == "watchdog_timeout"
    buf.seek(0)
    buf.truncate()
    assert tmxtop.main([d]) == 0
    assert "elastic generation 1" in buf.getvalue()
    buf.seek(0)
    buf.truncate()
    assert tmxtop.main([d, "--fault"]) == 0
    assert "elastic propose generation 1 (world 2)" in buf.getvalue()
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    assert tmxtop.main([str(tmp_path / "missing")]) == 2
    os.makedirs(str(tmp_path / "empty"))
    assert tmxtop.main([str(tmp_path / "empty")]) == 1


# ----------------------------------------------------------------------
# the two-process pod drill (gloo)
# ----------------------------------------------------------------------
DRILL = r"""
import json, os, sys
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import observability as obs
kv = mx.kv.create("dist_sync")
rank, nw = kv.rank, kv.num_workers
for step in range(1, 11):               # step 10 publishes
    obs.record_step(step, 0.01 * (rank + 1), batch_size=4)
kv.barrier()
first = obs.collect_summaries()
kv.barrier()                            # both read before either republishes
assert obs.publish_summary(step=99, extra={"mfu": 0.5})
kv.barrier()
out = {"rank": rank, "workers": nw,
       "first": {str(k): v["last_step"] for k, v in first.items()}}
if rank == 0:
    view = obs.pod_view(num_workers=nw)
    out["pod_ranks"] = view["ranks"]
    out["pod"] = view["pod"]
    out["summaries"] = {str(k): v["last_step"]
                        for k, v in obs.collect_summaries().items()}
    out["ages"] = {str(k): v for k, v in
                   obs.heartbeat_ages(num_workers=nw).items()}
kv.barrier()
with open(os.path.join(sys.argv[1], "drill%d.json" % rank), "w") as f:
    json.dump(out, f)
print("POD DRILL OK", flush=True)
"""


def test_dist_telemetry_drill(tmp_path):
    """Twin of ``test_dist_telemetry_drill``'s live half: two processes
    over gloo (``tools/launch.py``'s env, a free port) publish their
    summaries through the process group's store; ``collect_summaries``,
    ``heartbeat_ages`` and ``pod_view`` see both ranks, and the pod
    view merges their step sketches."""
    script = tmp_path / "drill.py"
    script.write_text(DRILL)
    s = __import__("socket").socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    args = argparse.Namespace(coordinator="127.0.0.1", port=port,
                              num_workers=2)
    procs = []
    for rank in range(2):
        env = launch.build_env(rank, args)
        env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env.update(MXTPU_TELEMETRY="1", MXTPU_RUN_ID="drill",
                   MXTPU_TELEMETRY_DIR=str(tmp_path / "tel"))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0 and "POD DRILL OK" in out, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    res = [json.load(open(tmp_path / ("drill%d.json" % r))) for r in (0, 1)]
    assert [(r["rank"], r["workers"]) for r in res] == [(0, 2), (1, 2)]
    for r in res:                       # the step-10 publishes landed
        assert r["first"] == {"0": 10, "1": 10}
    r0 = res[0]
    assert r0["pod_ranks"] == [0, 1]
    assert r0["summaries"] == {"0": 99, "1": 99}
    assert all(a is not None and 0 <= a < 60 for a in r0["ages"].values())
    assert sorted(r0["ages"]) == ["0", "1"]
    pod = r0["pod"]
    assert pod["ranks"] == 2 and pod["steps"] == 99
    assert pod["mfu"] == 0.5
    assert pod["samples_per_sec"] == pytest.approx(400.0 + 200.0, rel=0.01)
    assert pod["straggler_gap_ms"] == pytest.approx(5.0, rel=0.02)
    # the merged sketch: half the steps at 10 ms, half at 20
    assert pod["step_ms_p50"] == pytest.approx(10.0, rel=0.01)
    assert pod["step_ms_p95"] == pytest.approx(20.0, rel=0.01)
    files = sorted(os.listdir(tmp_path / "tel"))
    assert files == ["events-rank00000.jsonl", "events-rank00001.jsonl"]


# ----------------------------------------------------------------------
# the profiler
# ----------------------------------------------------------------------
def test_profiler_step_timer_and_annotate():
    """Twin of ``tests/test_metric_init.py``'s profiler test."""
    t = tmx.profiler.StepTimer(batch_size=8)
    for _ in range(3):
        t.start()
        t.stop()
    s = t.summary()
    assert s["steps"] == 2 and s["samples_per_sec"] > 0
    with tmx.profiler.annotate("region"):
        pass
    with pytest.raises(MXNetError):
        tmx.profiler.StepTimer().stop()
    assert tmx.profiler.StepTimer().summary() == {}
    assert tmx.profiler.PHASES is tobs.phases.PHASES


def test_steptimer_summary_percentiles():
    """Twin of the JAX test of the same name."""
    t = tmx.profiler.StepTimer(batch_size=16)
    for dur in [0.01] * 94 + [0.10] * 6:
        t.times.append(dur)
    s = t.summary(skip_first=0)
    assert s["steps"] == 100
    assert s["p50_s"] == pytest.approx(0.01)
    assert s["p95_s"] == pytest.approx(0.10)


def test_profiler_writes_a_chrome_trace(monkeypatch, tmp_path):
    """``profiler_set_state('run')`` .. ``('stop')`` writes one Chrome
    trace into the configured directory, holding the annotated region
    and the spans recorded while it ran."""
    import torch
    prof = tmx.profiler
    d = str(tmp_path / "prof")
    prof.profiler_set_config(filename=d)
    assert prof.profiler_set_state("stop") is None       # none running
    _enable(monkeypatch, tmp_path / "tel")
    prof.profiler_set_state("run")
    assert prof.running()
    prof.profiler_set_state("run")                       # idempotent
    with prof.annotate("my_region"):
        x = torch.ones(64, 64)
        (x @ x).sum()
    with tobs.span("allreduce", step=1):
        pass
    path = prof.profiler_set_state("stop")
    assert not prof.running() and os.path.dirname(path) == d
    doc = json.load(open(path))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "my_region" in names and "allreduce" in names
    assert any(str(n).startswith("aten::mm") for n in names)
    with pytest.raises(MXNetError):
        prof.profiler_set_state("pause")
    prof.profiler_set_config(filename="mxtpu_profile")


def test_profiler_refuses_a_host_only_trace_of_the_card(monkeypatch):
    """Asked for the card, a probe that records no device event makes
    ``'run'`` raise instead of tracing the host alone."""
    import torch
    prof = tmx.profiler
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(prof._state, "cupti", None)
    monkeypatch.setattr(prof, "FLUSH_S", 0.0)
    probes = []

    class _Probe(object):
        def __init__(self, activities):
            probes.append(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return []                   # CUPTI recorded nothing

    monkeypatch.setattr(torch.profiler, "profile", _Probe)
    monkeypatch.setattr(torch, "ones", lambda *a, **k: torch.zeros(1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    prof.profiler_set_config(mode="symbolic")
    monkeypatch.setitem(prof._state, "probe", [])
    with pytest.raises(MXNetError, match="CUPTI"):
        prof.profiler_set_state("run")
    assert not prof.running() and len(probes) == prof._PROBE_TRIES
    assert prof._state["probe"] == [0] * prof._PROBE_TRIES


def test_profiler_card_session_probes_then_opens_with_its_lead_in(
        monkeypatch, tmp_path):
    """Asked for the card, ``'run'`` probes with ``PROBE_KERNELS`` kernels
    (a try that records a device event passes, and is kept), then opens
    the session with ``LEAD_IN`` kernels of its own, ahead of the
    caller's, under the ``mx.profiler.lead_in`` range."""
    import torch
    prof = tmx.profiler
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(prof._state, "cupti", None)
    monkeypatch.setitem(prof._state, "probe", [])
    monkeypatch.setattr(prof, "FLUSH_S", 0.0)
    sessions, ranges, made = [], [], []

    class _Dev(object):
        device_type = "DeviceType.CUDA"

    class _Session(object):
        def __init__(self, activities):
            sessions.append(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [_Dev()]             # CUPTI recorded a kernel

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                f.write("{}")

    class _Range(object):
        def __init__(self, name):
            ranges.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def _made(fill):
        def make(*a, **k):
            made.append(torch.full((1,), float(fill)))
            return made[-1]
        return make

    monkeypatch.setattr(torch.profiler, "profile", _Session)
    monkeypatch.setattr(torch.profiler, "record_function", _Range)
    monkeypatch.setattr(torch, "ones", _made(1))
    monkeypatch.setattr(torch, "zeros", _made(0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    prof.profiler_set_config(mode="symbolic", filename=str(tmp_path))
    prof.profiler_set_state("run")
    assert prof.running() and prof._state["cupti"]
    assert prof._state["probe"] == [1] and len(sessions) == 2
    probe, lead_in = made
    assert probe.item() == prof.PROBE_KERNELS       # 1 + (PROBE_KERNELS-1)
    assert lead_in.item() == prof.LEAD_IN
    assert ranges == ["mx.profiler.lead_in"]
    path = prof.profiler_set_state("stop")
    assert not prof.running() and os.path.dirname(path) == str(tmp_path)
    prof.profiler_set_config(filename="mxtpu_profile")


# ----------------------------------------------------------------------
# isolation
# ----------------------------------------------------------------------
def test_new_modules_import_without_jax():
    """Every module of the slice and the three tools import with JAX
    blocked, and nothing of ``mxnet_tpu`` is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import mxnet_tpu_torch\n"
        "from mxnet_tpu_torch.observability import (aggregate, slo,\n"
        "    sloengine, retrace, locktrace, counters)\n"
        "from mxnet_tpu_torch import profiler\n"
        "from mxnet_tpu_torch.parallel import flops\n"
        "from mxnet_tpu_torch.tools import mxtop, mxtrace, benchdiff\n"
        "assert mxnet_tpu_torch.profiler is profiler\n"
        "assert not any(m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = _run([sys.executable, "-c", code], env)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_enabled_overhead_under_2_percent(monkeypatch, tmp_path):
    """Twin of the JAX bound: the enabled ``record_step`` (with the
    registry live) adds under 2% to a small real step; the same
    median-of-medians methodology."""
    a = np.random.RandomState(0).rand(512, 512)

    def work():
        return (a @ a).sum()

    _enable(monkeypatch, tmp_path)
    tobs.record_step(0, 0.001)
    for _ in range(10):
        work()
    steps = []
    for _ in range(50):
        t0 = time.perf_counter()
        work()
        steps.append(time.perf_counter() - t0)
    steps.sort()
    step_s = steps[len(steps) // 2]
    costs = []
    for i in range(2000):
        t0 = time.perf_counter()
        tobs.record_step(i, 0.001, batch_size=8)
        costs.append(time.perf_counter() - t0)
    tevents.flush()
    costs.sort()
    cost_s = costs[len(costs) // 2]
    ratio = (step_s + cost_s) / step_s
    assert ratio < 1.02, "hook %.1fus on a %.2fms step" % (cost_s * 1e6,
                                                          step_s * 1e3)
