"""The port's SLO sentry, ``benchdiff`` and live SLO engine against the
JAX package's, on the CPU.

Twins of ``tests/test_tracing.py``'s slo/benchdiff tests and of the 15
tests of ``tests/test_sloengine.py``.  Every BENCH-shaped file is
written here under ``tmp_path`` (the committed ``BENCH_*.json`` are the
JAX package's TPU records, read by no test of the port).  The same
files, the same metric dicts, and the same spec strings and seeded
sample streams at fixed ``now`` values go through both packages:
trajectories, comparisons and regression events must be equal; the
engines' alert edges, tier states and the recommendations they write to
a dict KV must be equal, and their burn rates equal to 1e-12.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu.observability import aggregate as jagg
from mxnet_tpu.observability import events as jevents
from mxnet_tpu.observability import metrics as jmetrics
from mxnet_tpu.observability import slo as jslo
from mxnet_tpu.observability import sloengine as jse

from mxnet_tpu_torch.observability import aggregate as tagg
from mxnet_tpu_torch.observability import events as tevents
from mxnet_tpu_torch.observability import metrics as tmetrics
from mxnet_tpu_torch.observability import slo as tslo
from mxnet_tpu_torch.observability import sloengine as tse

import torch_obs_records as recs_mod

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ((jevents, jmetrics, jse), (tevents, tmetrics, tse))


@pytest.fixture(autouse=True)
def _pristine(monkeypatch):
    for var in ("MXTPU_TELEMETRY", "MXTPU_TELEMETRY_DIR", "MXTPU_SLO_SPEC",
                "MXTPU_METRICS_WINDOWS", "MXTPU_SLO_BASELINE",
                "MXTPU_RUN_ID"):
        monkeypatch.delenv(var, raising=False)
    for ev, mt, se in PKGS:
        ev.refresh()
        mt.reset_registry()
        se.reset_engine()
    yield
    for ev, mt, se in PKGS:
        ev.refresh()
        mt.reset_registry()
        se.reset_engine()


# ----------------------------------------------------------------------
# slo.py
# ----------------------------------------------------------------------
def test_rel_spread_equal():
    from mxnet_tpu.observability import counters as jc
    from mxnet_tpu_torch.observability import counters as tc
    rng = np.random.RandomState(1)
    for vals in ([], [5.0], [10.0] * 3, [100.0, 110.0, 90.0, 105.0],
                 list(rng.lognormal(2.0, 0.5, 17))):
        assert tc.rel_spread(vals) == jc.rel_spread(vals)
        assert tc.percentile(vals, 95) == jc.percentile(vals, 95)


def test_load_bench_schema(tmp_path):
    """Twin of ``test_load_bench_schema``: the BENCH schema, a failed
    round, a bare metric dict, a missing file."""
    p = tmp_path / "BENCH_a.json"
    p.write_text(json.dumps({
        "n": 1, "cmd": "bench", "rc": 0,
        "parsed": {"metric": "train_epoch", "value": 2.0,
                   "unit": "images/sec", "step_time_ms": 100.0}}))
    q = tmp_path / "BENCH_b.json"
    q.write_text(json.dumps({"n": 2, "cmd": "bench", "rc": 1,
                             "parsed": None}))
    r = tmp_path / "cur.json"
    r.write_text(json.dumps({"step_time_ms": 120.0, "unknown": 5}))
    for path in (p, q, r, tmp_path / "missing.json"):
        assert tslo.load_bench(str(path)) == jslo.load_bench(str(path))
    assert tslo.load_bench(str(p)) == {"step_time_ms": 100.0,
                                       "images_per_sec": 2.0}
    assert tslo.load_bench(str(q)) is None


def _trajectory(directory, seed, n=6):
    """n seeded BENCH rounds (one failed) under ``directory``."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        doc = {"rc": 0, "parsed": {
            "step_time_ms": float(round(100 * rng.lognormal(0, 0.05), 3)),
            "transformer_tokens_per_sec": float(round(
                5e4 * rng.lognormal(0, 0.1), 1)),
            "images_per_sec": float(round(300 * rng.lognormal(0, 0.2), 2)),
            "allreduce_ms": float(round(2 * rng.lognormal(0, 0.3), 4))}}
        if i == 2:
            doc = {"rc": 1, "parsed": None}
        with open(os.path.join(directory, "BENCH_r%02d.json" % i), "w") as f:
            json.dump(doc, f)
    return os.path.join(directory, "BENCH_*.json")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_noise_and_compare_equal(tmp_path, seed):
    """``load_trajectory`` (name order, failed round skipped),
    ``trajectory_noise`` and ``compare`` against perturbed currents:
    the same regressions in the same order, the same checked rows."""
    spec = _trajectory(str(tmp_path), seed)
    jt, tt = jslo.load_trajectory(spec), tslo.load_trajectory(spec)
    assert tt == jt and len(tt) == 5
    noise = tslo.trajectory_noise(tt)
    assert noise == jslo.trajectory_noise(jt)
    base = tt[-1][1]
    rng = np.random.RandomState(seed + 10)
    for _ in range(5):
        cur = {k: v * float(rng.choice([0.6, 0.95, 1.0, 1.2, 1.6]))
               for k, v in base.items()}
        for kw in ({}, {"noise": noise}, {"min_rel": 0.3, "sigma": 1.0}):
            got = tslo.compare(cur, base, **kw)
            assert recs_mod.roundtrip(got) == recs_mod.roundtrip(
                jslo.compare(cur, base, **kw))


def test_compare_directions_and_floor():
    """Twin of the JAX test of the same name."""
    base = {"step_time_ms": 100.0, "images_per_sec": 50.0}
    regs, checked = tslo.compare({"step_time_ms": 120.0,
                                  "images_per_sec": 40.0}, base)
    assert {f["metric"] for f in regs} == {"step_time_ms",
                                           "images_per_sec"}
    assert all(f["threshold_pct"] == 10.0 for f in checked)
    assert tslo.compare({"step_time_ms": 80.0, "images_per_sec": 60.0},
                        base)[0] == []
    assert tslo.compare({"step_time_ms": 105.0}, base)[0] == []
    regs, checked = tslo.compare({"step_time_ms": 125.0},
                                 {"step_time_ms": 100.0},
                                 noise={"step_time_ms": 0.15})
    assert regs == [] and checked[0]["threshold_pct"] == 45.0


@pytest.mark.parametrize("seed", [0, 3])
def test_telemetry_metrics_equal(tmp_path, seed):
    """``telemetry_metrics`` of the same seeded report, and the mapping
    twin of ``test_telemetry_metrics_mapping``."""
    recs = recs_mod.records(seed)
    now = recs_mod.BASE_MS / 1e3
    got = tslo.telemetry_metrics(tagg.build_report(recs, now=now))
    assert got == jslo.telemetry_metrics(jagg.build_report(recs, now=now))
    assert got["step_ms_p50"] and got["serve_qps"]
    report = {"pod": {"step_ms_p50": 10.0, "step_ms_p95": 12.0,
                      "samples_per_sec": 640.0, "overlap_ratio": 1.3,
                      "mfu": 0.41},
              "serve": {"total": {"padding_waste": 0.2, "qps": 55.0,
                                  "latency_ms": {"p95": 30.0}}}}
    assert tslo.telemetry_metrics(report) == {
        "step_ms_p50": 10.0, "step_ms_p95": 12.0,
        "samples_per_sec": 640.0, "overlap_ratio": 1.3, "mfu": 0.41,
        "serve_padding_waste": 0.2, "serve_qps": 55.0,
        "serve_ms_p95": 30.0}


def test_emit_regressions_equal(monkeypatch, tmp_path):
    """Twin of ``test_emit_regressions_lands_fault_events``: the same
    ``perf_regression`` fault records in both packages' logs."""
    out = {}
    for name, slo, ev, agg in (("jax", jslo, jevents, jagg),
                               ("port", tslo, tevents, tagg)):
        d = str(tmp_path / name)
        monkeypatch.setenv("MXTPU_TELEMETRY", "1")
        monkeypatch.setenv("MXTPU_TELEMETRY_DIR", d)
        monkeypatch.setenv("MXTPU_RUN_ID", "twin")
        ev.refresh()
        regs, _ = slo.compare({"step_time_ms": 200.0, "images_per_sec": 1.0},
                              {"step_time_ms": 100.0, "images_per_sec": 9.0})
        slo.emit_regressions(regs, step=9, baseline_name="BENCH_x.json")
        ev.flush()
        out[name] = [{k: v for k, v in r.items() if k != "wall_ms"}
                     for r in agg.read_events(d)
                     if r.get("fault") == "perf_regression"]
        monkeypatch.delenv("MXTPU_TELEMETRY")
        ev.refresh()
    assert out["port"] == out["jax"] and len(out["port"]) == 2
    assert out["port"][0]["baseline_name"] == "BENCH_x.json"


# ----------------------------------------------------------------------
# benchdiff
# ----------------------------------------------------------------------
def _benchdiff(capsys, *args):
    """The port's ``benchdiff`` in process: (exit code, stdout)."""
    from mxnet_tpu_torch.tools import benchdiff
    capsys.readouterr()
    rc = benchdiff.main(list(args))
    return rc, capsys.readouterr().out


def test_benchdiff_gate(tmp_path, capsys):
    """Twin of ``test_benchdiff_gate``: an unchanged run exits 0, a +20%
    step-time regression 1 (and ``--json`` names it), improvements 0,
    usage errors 2; ``--telemetry`` reads a dir; ``python -m
    mxnet_tpu_torch.tools.benchdiff`` exits with the gate's code."""
    baseline = {"rc": 0, "parsed": {"step_time_ms": 100.0,
                                    "transformer_tokens_per_sec": 5e4}}
    bpath = str(tmp_path / "BENCH_base.json")
    with open(bpath, "w") as f:
        json.dump(baseline, f)
    assert _benchdiff(capsys, "--baseline", bpath, "--against",
                      bpath)[0] == 0
    rc, out = _benchdiff(capsys, "--baseline", bpath, "--metrics",
                         json.dumps({"step_time_ms": 120.0}), "--json")
    assert rc == 1
    assert json.loads(out)["regressions"][0]["metric"] == "step_time_ms"
    assert _benchdiff(capsys, "--baseline", bpath, "--metrics",
                      json.dumps({"step_time_ms": 50.0,
                                  "transformer_tokens_per_sec": 9e4}))[0] \
        == 0
    assert _benchdiff(capsys, "--baseline", bpath)[0] == 2
    assert _benchdiff(capsys, "--baseline", str(tmp_path / "nope.json"),
                      "--metrics", "{}")[0] == 2
    tel = recs_mod.write_dir(str(tmp_path / "tel"), recs_mod.records(4))
    tb = str(tmp_path / "BENCH_tel.json")
    with open(tb, "w") as f:
        json.dump({"step_ms_p50": 1.0}, f)
    rc, out = _benchdiff(capsys, "--baseline", tb, "--telemetry", tel)
    assert rc == 1 and "step_ms_p50" in out
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.benchdiff",
         "--baseline", bpath, "--metrics",
         json.dumps({"step_time_ms": 120.0})], cwd=_ROOT,
        capture_output=True, text=True, timeout=180, env=env)
    assert proc.returncode == 1 and "REGRESSION" in proc.stdout, \
        proc.stdout + proc.stderr


def test_benchdiff_output_equal(tmp_path, capsys):
    """The port's ``benchdiff`` prints what ``tools/benchdiff.py`` does
    over the same seeded trajectory and current metrics (text and
    ``--json``), with the same exit code."""
    import importlib.util
    spec_ = importlib.util.spec_from_file_location(
        "jbenchdiff", os.path.join(_ROOT, "tools", "benchdiff.py"))
    jbenchdiff = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(jbenchdiff)
    spec = _trajectory(str(tmp_path), 7)
    cur = json.dumps({"step_time_ms": 150.0, "images_per_sec": 10.0,
                      "transformer_tokens_per_sec": 9e4})
    for extra in ([], ["--json"]):
        argv = ["--baseline", spec, "--metrics", cur] + extra
        port = _benchdiff(capsys, *argv)
        ref = (jbenchdiff.main(argv), capsys.readouterr().out)
        assert port == ref and port[0] == 1


# ----------------------------------------------------------------------
# the live SLO engine: one spec and one seeded stream through both
# ----------------------------------------------------------------------
class FakeKV(object):
    def __init__(self):
        self.store = {}

    def key_value_set(self, key, value, allow_overwrite=False):
        self.store[key] = value


class BadKV(object):
    def key_value_set(self, *a, **kw):
        raise OSError("kv down")


def _engines(spec="metric=lat_ms:target=100:hold=2", kv=FakeKV):
    """A (JAX, port) pair of engines over private registries, each with
    a ``lat_ms`` histogram on windows (10, 60, 300, 3600)."""
    out = []
    for _ev, mt, se in PKGS:
        reg = mt.MetricsRegistry()
        eng = se.SloEngine(specs=se.parse_specs(spec), reg=reg,
                           kv=kv() if kv else None, source="test")
        hist = reg.histogram("lat_ms", windows_s=(10, 60, 300, 3600))
        out.append((eng, hist))
    return out


def _feed(pair, t0, seconds, bad_frac, per_sec=10, seed=0):
    """per_sec samples a second for ``seconds``, into both histograms:
    ``bad_frac`` of them drawn above the 100 ms target (seeded values,
    the same in both)."""
    rng = np.random.RandomState(seed + int(t0))
    for s in range(int(seconds)):
        now = t0 + s
        nbad = int(round(per_sec * bad_frac))
        vals = list(rng.uniform(1.0, 99.0, per_sec - nbad)) \
            + list(rng.uniform(101.0, 900.0, nbad))
        for v in vals:
            for _eng, hist in pair:
                hist.observe(float(v), now=now)
    return t0 + seconds


def _evaluate(pair, now):
    """Both engines at ``now``: their alert lists (equal), and every
    spec's burn at every window equal to 1e-12."""
    got = [eng.evaluate(now=now) for eng, _h in pair]
    assert got[1] == got[0]
    for (je, _jh), (te, _th) in [pair]:
        for jsp, tsp in zip(je.specs, te.specs):
            for w in tsp.windows():
                jb, jn = je._burn(jsp, w, now)
                tb, tn = te._burn(tsp, w, now)
                assert tn == jn
                assert (tb is None) == (jb is None)
                if tb is not None:
                    assert abs(tb - jb) <= 1e-12
    return got[1]


def _states_equal(pair, now):
    sts = [eng.state(now=now) for eng, _h in pair]
    assert sts[1] == sts[0]
    stores = [getattr(eng._kv, "store", None) for eng, _h in pair]
    assert stores[1] == stores[0]
    return sts[1]


def test_parse_inline_spec_with_defaults():
    for se in (jse, tse):
        sp = se.parse_specs("metric=mxtpu_serve_latency_ms:target=250")[0]
        assert (sp.metric, sp.target, sp.budget) == \
            ("mxtpu_serve_latency_ms", 250.0, 0.01)
        assert (sp.page, sp.ticket, sp.fast, sp.slow, sp.tfast, sp.tslow) \
            == (14.0, 2.0, 10, 60, 60, 300)
        assert (sp.hold, sp.clear, sp.min_n) == (3, 0.5, 10)
    assert tse.parse_specs("metric=a:target=1")[0].to_dict() == \
        jse.parse_specs("metric=a:target=1")[0].to_dict()


def test_parse_multiple_specs_and_overrides():
    raw = ("metric=a:target=1:budget=0.05:page=10:fast=5:slow=30;"
           "metric=b:target=2:hold=1:min_n=2")
    got = [s.to_dict() for s in tse.parse_specs(raw)]
    assert got == [s.to_dict() for s in jse.parse_specs(raw)]
    assert [g["metric"] for g in got] == ["a", "b"]
    assert got[0]["fast"] == 5 and got[1]["min_n"] == 2


def test_parse_spec_file(tmp_path):
    f = tmp_path / "slo.spec"
    f.write_text("# objectives\nmetric=lat:target=100\n"
                 "metric=ttft:target=50:budget=0.02\n")
    got = [s.to_dict() for s in tse.parse_specs(str(f))]
    assert got == [s.to_dict() for s in jse.parse_specs(str(f))]
    assert got[1]["budget"] == 0.02


@pytest.mark.parametrize("raw", ["metric=a", "metric=a:target=1:junk"])
def test_parse_rejects_malformed(raw):
    for se in (jse, tse):
        with pytest.raises(ValueError):
            se.parse_specs(raw)
        with pytest.raises(ValueError):
            se.SloSpec("a", 1.0, budget=1.5)
        assert se.parse_specs("") == [] and se.parse_specs(None) == []


def test_steady_in_budget_load_never_alerts():
    pair = _engines()
    t = _feed(pair, 1000.0, 400, bad_frac=0.005, per_sec=200)
    for k in range(20):
        assert _evaluate(pair, t + k) == []
    st = _states_equal(pair, t)
    assert not st["specs"][0]["tiers"]["page"]["active"]
    assert not st["specs"][0]["tiers"]["ticket"]["active"]


def test_breach_fires_page_within_fast_window():
    pair = _engines()
    t = _feed(pair, 1000.0, 60, bad_frac=0.0)
    assert _evaluate(pair, t) == []
    t = _feed(pair, t, 30, bad_frac=0.5)
    alerts = _evaluate(pair, t)
    assert ("page", "fire") in {(a["tier"], a["edge"]) for a in alerts}
    page = [a for a in alerts if a["tier"] == "page"][0]
    assert page["windows_s"] == [60, 10]
    assert all(b >= 14.0 for b in page["burns"].values())
    assert _evaluate(pair, t) == []
    _states_equal(pair, t)


def test_recovery_clears_with_hysteresis_hold():
    pair = _engines()
    t = _feed(pair, 1000.0, 30, bad_frac=0.5)
    assert any(a["edge"] == "fire" for a in _evaluate(pair, t))
    t = _feed(pair, t, 70, bad_frac=0.0)
    assert _evaluate(pair, t) == []
    second = _evaluate(pair, t + 1)
    assert any(a["edge"] == "clear" and a["tier"] == "page"
               for a in second)
    assert not _states_equal(pair, t + 1)["specs"][0]["tiers"]["page"][
        "active"]


def test_relapse_resets_clear_streak():
    pair = _engines()
    t = _feed(pair, 1000.0, 30, bad_frac=0.5)
    _evaluate(pair, t)
    t = _feed(pair, t, 70, bad_frac=0.0)
    assert _evaluate(pair, t) == []
    t = _feed(pair, t, 15, bad_frac=0.5)
    assert _evaluate(pair, t) == []
    t = _feed(pair, t, 70, bad_frac=0.0)
    _evaluate(pair, t)
    assert any(a["edge"] == "clear" for a in _evaluate(pair, t + 1))
    _states_equal(pair, t + 1)


def test_thin_window_gives_no_verdict():
    pair = _engines()
    for i in range(5):
        for _eng, hist in pair:
            hist.observe(500.0, now=1000.0 + i)
    assert _evaluate(pair, 1005.0) == []
    st = _states_equal(pair, 1005.0)
    assert st["specs"][0]["burns"]["10"]["burn"] is None


def test_missing_histogram_is_silent():
    for _ev, mt, se in PKGS:
        eng = se.SloEngine(specs=[se.SloSpec("nope", 1.0)],
                           reg=mt.MetricsRegistry())
        assert eng.evaluate(now=1000.0) == []


def test_page_fire_writes_recommend_grow():
    pair = _engines(spec="metric=lat_ms:target=100:hold=2")
    t = _feed(pair, 1000.0, 30, bad_frac=0.5)
    _evaluate(pair, t)
    _states_equal(pair, t)
    store = pair[1][0]._kv.store
    latest = json.loads(store[tse.SLO_PREFIX + "latest"])
    assert (latest["action"], latest["gen"], latest["metric"],
            latest["source"]) == ("recommend_grow", 1, "lat_ms", "test")
    assert tse.SLO_PREFIX + "reco-lat_ms-00001" in store
    assert len(store) == 2


def test_sustained_idle_writes_recommend_shrink_once():
    pair = _engines()
    t = _feed(pair, 1000.0, 350, bad_frac=0.0, per_sec=5)
    for k in range(tse.SloEngine.IDLE_HOLD + 3):
        _evaluate(pair, t + k)
    _states_equal(pair, t)
    recos = [json.loads(v) for k, v in pair[1][0]._kv.store.items()
             if k.startswith(tse.SLO_PREFIX + "reco-")]
    assert [(r["action"], r["gen"]) for r in recos] == \
        [("recommend_shrink", 1)]


def test_kv_failure_is_swallowed():
    pair = _engines(kv=BadKV)
    t = _feed(pair, 1000.0, 30, bad_frac=0.5)
    assert any(a["edge"] == "fire" for a in _evaluate(pair, t))


def test_alert_events_reach_the_event_log(monkeypatch, tmp_path):
    out = {}
    for name, ev, agg in (("jax", jevents, jagg), ("port", tevents, tagg)):
        d = str(tmp_path / name)
        monkeypatch.setenv("MXTPU_TELEMETRY", "1")
        monkeypatch.setenv("MXTPU_TELEMETRY_DIR", d)
        monkeypatch.setenv("MXTPU_RUN_ID", "twin")
        ev.refresh()
        pair = _engines()
        eng = pair[0][0] if name == "jax" else pair[1][0]
        t = _feed(pair, 1000.0, 30, bad_frac=0.5)
        eng.evaluate(now=t)
        ev.flush()
        out[name] = [{k: v for k, v in r.items() if k != "wall_ms"}
                     for r in agg.read_events(d)
                     if r["kind"] in ("slo_alert", "counter")]
        monkeypatch.delenv("MXTPU_TELEMETRY")
        ev.refresh()
    assert out["port"] == out["jax"]
    alert = [r for r in out["port"] if r["kind"] == "slo_alert"][0]
    assert (alert["tier"], alert["edge"]) == ("page", "fire")


def test_maybe_start_requires_spec(monkeypatch):
    assert tse.maybe_start() is None
    monkeypatch.setenv("MXTPU_SLO_SPEC", "metric=lat:target=9")
    kv = FakeKV()
    eng = tse.maybe_start(source="door", kv=kv)
    try:
        assert eng is not None and eng.source == "door"
        assert [s.metric for s in eng.specs] == ["lat"]
        assert eng._kv is kv and eng._thread is not None
        assert tse.engine() is eng
    finally:
        eng.stop()


def test_windows_env_feeds_the_spec_defaults(monkeypatch):
    """``MXTPU_METRICS_WINDOWS`` sets the default window pairs alike in
    both packages."""
    monkeypatch.setenv("MXTPU_METRICS_WINDOWS", "5,30,120")
    got = tse.parse_specs("metric=a:target=1")[0].to_dict()
    assert got == jse.parse_specs("metric=a:target=1")[0].to_dict()
    assert (got["fast"], got["slow"], got["tslow"]) == (5, 30, 120)
