"""The MXL-E static schedule lint (``analysis/schedule.py``) and
``mxlint --schedule`` in the port, against the JAX package, on the CPU.

The twins of ``tests/test_schedule.py`` (partitions, the slot-synchronous
simulator against closed forms, every rule E001..E008 firing on a
known-bad graph and silent on clean or toy ones), then the E findings of
``tests/fixtures/schedule/*.json`` and of ``transformer_moe`` at
``dp=1,ep=4`` held to the JAX package's: the same rule ids, severities
and nodes, and the same messages where a finding prices nothing or where
both packages price it through the same overrides (``MXTPU_LINT_ICI_GBPS``
for the link, ``BENCH_PEAK_TFLOPS`` and ``BENCH_PEAK_HBM_GBPS`` for the
stages, which both packages' peak tables read).  The port names its
card's link ("NVLink") where the JAX package says "ICI", and its
messages name no knob for the E001, E002 and E007 bounds, which are
constants in the port.  The JAX package lints its ``"tpu"`` target, the
port its ``"gpu"`` one.
"""
import json
import os

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import analysis as jan
from mxnet_tpu.analysis import schedule as jsched
from mxnet_tpu.parallel import LogicalMesh as JLogicalMesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch.analysis import schedule as tsched
from mxnet_tpu_torch.observability import counters
from mxnet_tpu_torch.parallel import LogicalMesh
from mxnet_tpu_torch.tools import mxlint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "schedule")
_BIG = {"data": (256, 4096)}


def _ids(issues):
    return {i.rule_id for i in issues}


def _only(issues, rule_id):
    return [i for i in issues if i.rule_id == rule_id]


def _e(issues):
    return sorted((i.rule_id, i.severity, i.node or "") for i in issues
                  if i.rule_id.startswith("MXL-E"))


def _balanced_pipeline(mx, hidden=4096, per_stage=2):
    data = mx.sym.Variable("data")
    h = data
    i = 0
    for g in ("pp0", "pp1"):
        with mx.AttrScope(ctx_group=g):
            for _ in range(per_stage):
                h = mx.sym.FullyConnected(data=h, num_hidden=hidden,
                                          name="fc%d" % i)
                i += 1
    return h


def _imbalanced_pipeline(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="pp0"):
        h = mx.sym.FullyConnected(data=data, num_hidden=4096, name="fc0")
    with mx.AttrScope(ctx_group="pp1"):
        for i in range(1, 5):
            h = mx.sym.FullyConnected(data=h, num_hidden=4096,
                                      name="fc%d" % i)
    return h


def _backedge_pipeline(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="pp0"):
        a = mx.sym.FullyConnected(data=data, num_hidden=256, name="fc_a")
    with mx.AttrScope(ctx_group="pp1"):
        b = mx.sym.FullyConnected(data=a, num_hidden=256, name="fc_b")
    with mx.AttrScope(ctx_group="pp0"):
        c = mx.sym.FullyConnected(data=b, num_hidden=256, name="fc_c")
    return c


def _moe_net(mx, num_experts, capacity_factor, hidden_size=128):
    return mx.sym.MoE(data=mx.sym.Variable("data"),
                      num_experts=num_experts, hidden_size=hidden_size,
                      top_k=1, capacity_factor=capacity_factor, name="moe")


# ----------------------------------------------------------------------
# partitions and the simulator
# ----------------------------------------------------------------------
def test_partition_ctx_group_first_appearance_order():
    ctxs = []
    tan.analyze(_imbalanced_pipeline(tmx), shapes=_BIG, _ctx_out=ctxs)
    part = tan.stage_partition(ctxs[0])
    assert part["mode"] == "ctx_group" and part["k"] == 2
    assert part["groups"] == ["pp0", "pp1"]
    assert part["stage_of"]["fc0"] == 0
    assert all(part["stage_of"]["fc%d" % i] == 1 for i in range(1, 5))


def test_partition_pp_axis_flops_balanced_as_the_jax_package():
    with tmx.name.NameManager():
        tnet = tmx.models.get_mlp()
    with jmx.name.NameManager():
        jnet = jmx.models.get_mlp()
    tctx, jctx = [], []
    tan.analyze(tnet, shapes={"data": (32, 784)},
                mesh=LogicalMesh(dp=1, pp=2), _ctx_out=tctx)
    jan.analyze(jnet, shapes={"data": (32, 784)},
                mesh=JLogicalMesh(dp=1, pp=2), _ctx_out=jctx)
    tpart, jpart = tan.stage_partition(tctx[0]), \
        jsched.stage_partition(jctx[0])
    assert tpart["mode"] == "pp" and tpart["k"] == 2
    assert tpart["stages"] == jpart["stages"]
    none = []
    tan.analyze(tnet, shapes={"data": (32, 784)}, _ctx_out=none)
    assert tan.stage_partition(none[0]) is None
    assert tan.schedule_report(none[0]) is None


@pytest.mark.parametrize("k,m,expect", [
    (2, 2, 0.4), (4, 4, 0.5), (4, 8, 0.4), (2, 6, 0.3077)])
def test_1f1b_bubble_closed_forms(k, m, expect):
    sim = tsched.simulate_schedule(tsched._1f1b_kind_rows(k, m), [1.0] * k,
                                [2.0] * k)
    assert sim["bubble_fraction"] == pytest.approx(expect, abs=1e-4)
    assert sim == jsched.simulate_schedule(jsched._1f1b_kind_rows(k, m),
                                           [1.0] * k, [2.0] * k)


@pytest.mark.parametrize("k,m", [(2, 4), (4, 4), (4, 8)])
def test_gpipe_bubble_closed_form(k, m):
    rows = tsched.gpipe_kind_rows(k, m)
    assert rows == jsched.gpipe_kind_rows(k, m)
    sim = tsched.simulate_schedule(rows, [1.0] * k, [2.0] * k)
    assert sim["bubble_fraction"] == pytest.approx((k - 1) / (m + k - 1.0),
                                                   abs=1e-9)
    slow = tsched.simulate_schedule(tsched.gpipe_kind_rows(2, 2), [1.0] * 2,
                                 [2.0] * 2, xfer=10.0)
    assert slow["total_time"] == pytest.approx(10.0 * slow["slots"])


def test_schedule_report_prices_both_schedules_at_the_card():
    ctxs = []
    tan.analyze(_balanced_pipeline(tmx), shapes=_BIG, _ctx_out=ctxs,
                device_kind=counters.DEFAULT_CARD)
    rep = tan.schedule_report(ctxs[0])
    assert rep["partition"]["k"] == 2
    assert set(rep["schedules"]) == {"gpipe", "1f1b"}
    for h in rep["stage_hbm"]:
        assert h["stash_1f1b"] <= h["stash_gpipe"]
        assert h["peak_1f1b"] <= h["peak_gpipe"]
    # each stage priced at the H100's float32 peak (compute-bound), and
    # the boundary at its NVLink rate
    row = counters.PEAKS[counters.DEFAULT_CARD]
    s0 = rep["stages"][0]
    assert s0["time_s"] == pytest.approx(
        max(s0["flops"] / (row["tflops"]["float32"] * 1e12),
            s0["bytes"] / row["bytes_per_s"]))
    b = rep["boundaries"][0]
    assert b["time_s"] == pytest.approx(b["bytes"] / 900e9)
    assert row["link"] == "NVLink"
    assert counters.PEAKS["NVIDIA H100 PCIe"]["link_bytes_per_s"] == 128e9


# ----------------------------------------------------------------------
# the rules, in the port
# ----------------------------------------------------------------------
def test_pipeline_rules_fire_and_stay_silent(monkeypatch):
    issues = _only(tan.analyze(_imbalanced_pipeline(tmx), shapes=_BIG),
                   "MXL-E001")
    assert issues and "stage 1" in issues[0].message
    assert not _only(tan.analyze(_balanced_pipeline(tmx), shapes=_BIG),
                     "MXL-E001")
    toy = tan.analyze(_imbalanced_pipeline(tmx), shapes={"data": (8, 16)})
    assert not _ids(toy) & {"MXL-E001", "MXL-E002", "MXL-E005"}
    # off the gpu target the family is silent
    assert not _only(tan.analyze(_imbalanced_pipeline(tmx), shapes=_BIG,
                                 target="cpu"), "MXL-E001")
    issues = _only(tan.analyze(_backedge_pipeline(tmx),
                               shapes={"data": (8, 256)}), "MXL-E003")
    assert issues and "fc_c" in issues[0].message
    issues = _only(tan.analyze(_balanced_pipeline(tmx), shapes=_BIG,
                               hbm_bytes=1 << 20), "MXL-E004")
    assert issues and "stashed microbatch activations" in issues[0].message
    monkeypatch.setenv("MXTPU_LINT_MICROBATCHES", "1")
    issues = _only(tan.analyze(_balanced_pipeline(tmx), shapes=_BIG),
                   "MXL-E002")
    assert issues and ("microbatches would reach the bound"
                       in issues[0].message
                       or "rebalance stages first" in issues[0].message)
    monkeypatch.setenv("MXTPU_LINT_MICROBATCHES", "64")
    assert not _only(tan.analyze(_balanced_pipeline(tmx), shapes=_BIG),
                     "MXL-E002")
    monkeypatch.setenv("MXTPU_LINT_ICI_GBPS", "0.0001")
    issues = _only(tan.analyze(_balanced_pipeline(tmx), shapes=_BIG),
                   "MXL-E005")
    assert issues and "cannot hide under compute" in issues[0].message
    monkeypatch.setenv("MXTPU_LINT_SCHEDULE", "0")
    assert not {i for i in _ids(tan.analyze(_imbalanced_pipeline(tmx),
                                            shapes=_BIG))
                if i.startswith("MXL-E")}


def test_moe_rules_fire_and_stay_silent():
    shp = {"data": (512, 64)}
    issues = _only(tan.analyze(_moe_net(tmx, 6, 1.25), shapes=shp,
                               mesh=LogicalMesh(ep=4)), "MXL-E006")
    assert issues and "6 experts" in issues[0].message
    assert not _only(tan.analyze(_moe_net(tmx, 8, 1.25), shapes=shp,
                                 mesh=LogicalMesh(ep=4)), "MXL-E006")
    issues = _only(tan.analyze(_moe_net(tmx, 8, 0.5), shapes=shp),
                   "MXL-E007")
    assert issues and "dropped" in issues[0].message
    assert not _only(tan.analyze(_moe_net(tmx, 8, 0.0), shapes=shp),
                     "MXL-E007")
    issues = _only(tan.analyze(_moe_net(tmx, 8, 1.25), shapes=shp,
                               mesh=LogicalMesh(ep=4), world_size=4),
                   "MXL-E008")
    assert issues and issues[0].severity == "info"
    assert "all-to-all" in issues[0].message
    assert "MXL-D collective trace" in issues[0].message
    assert "NVLink" in issues[0].message
    assert not _only(tan.analyze(_moe_net(tmx, 8, 1.25), shapes=shp),
                     "MXL-E008")


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
def _price_alike(monkeypatch):
    """Both packages' stages, boundaries and all-to-alls at one set of
    rates: the stages compute-bound at 1 TFLOP/s."""
    monkeypatch.setenv("MXTPU_LINT_ICI_GBPS", "90")
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "1")
    monkeypatch.setenv("BENCH_PEAK_HBM_GBPS", "1000000")


#: the JAX messages' words that differ in the port: its link's name, and
#: the bounds that are environment knobs there and constants here
_JAX_TO_PORT = (("ICI", "NVLink"),
                (", MXTPU_LINT_STAGE_IMBALANCE)", ")"),
                ("(bound MXTPU_LINT_BUBBLE_MAX, microbatches",
                 "(microbatches"),
                (" (MXTPU_LINT_MOE_CAPACITY_MIN)", ""))


def _as_port(message):
    for a, b in _JAX_TO_PORT:
        message = message.replace(a, b)
    return message


def _same_findings(tissues, jissues):
    assert _e(tissues) == _e(jissues)
    tmsg = {(i.rule_id, i.node): i.message for i in tissues
            if i.rule_id.startswith("MXL-E")}
    for i in jissues:
        if i.rule_id.startswith("MXL-E"):
            assert tmsg[(i.rule_id, i.node)] == _as_port(i.message), \
                i.rule_id


@pytest.mark.parametrize("name,shapes,mesh", [
    ("imbalanced_stages.json", {"data": (256, 4096)}, None),
    ("cross_stage_backedge.json", {"data": (256, 4096)}, None),
    ("indivisible_experts.json", {"data": (512, 64)}, {"ep": 4}),
])
def test_fixture_findings_match_jax(monkeypatch, name, shapes, mesh):
    _price_alike(monkeypatch)
    with open(os.path.join(FIXTURES, name)) as f:
        graph = json.load(f)
    tissues = tan.analyze_json(graph, shapes=shapes,
                               mesh=LogicalMesh(**mesh) if mesh else None)
    jissues = jan.analyze_json(graph, shapes=shapes,
                               mesh=JLogicalMesh(**mesh) if mesh else None)
    assert _e(tissues), name
    _same_findings(tissues, jissues)


def test_transformer_moe_ep4_findings_match_jax(monkeypatch):
    _price_alike(monkeypatch)
    kw, shapes = next((k, s) for n, k, s in mxlint.MODEL_SWEEP
                      if n == "transformer_moe")
    with tmx.name.NameManager():
        tsym = tmx.models.transformer_moe.get_symbol(**kw)
    with jmx.name.NameManager():
        jsym = jmx.models.transformer_moe.get_symbol(**kw)
    tctx, jctx = [], []
    tissues = tan.analyze(tsym, shapes=shapes, mesh=LogicalMesh(dp=1, ep=4),
                          world_size=4, _ctx_out=tctx)
    jissues = jan.analyze(jsym, shapes=shapes,
                          mesh=JLogicalMesh(dp=1, ep=4), world_size=4,
                          _ctx_out=jctx)
    assert "MXL-E008" in _ids(tissues)
    _same_findings(tissues, jissues)
    assert tan.schedule_report(tctx[0])["moe"] == \
        jsched.schedule_report(jctx[0])["moe"]


def test_mxlint_schedule_against_the_jax_cli(capsys, monkeypatch):
    """``mxlint --model transformer_moe --mesh dp=1,ep=4 --schedule``:
    the exit code, the E findings and the report's routing rows as the
    JAX CLI's; the text report prints the schedule section."""
    import importlib.util
    _price_alike(monkeypatch)
    spec = importlib.util.spec_from_file_location(
        "_jax_mxlint_sched", os.path.join(ROOT, "tools", "mxlint.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    argv = ["--model", "transformer_moe", "--mesh", "dp=1,ep=4",
            "--schedule", "--microbatches", "4", "--format", "json"]
    rc_j = jcli.main(list(argv))
    doc_j = json.loads(capsys.readouterr().out)
    rc_t = mxlint.main(list(argv))
    doc_t = json.loads(capsys.readouterr().out)
    assert rc_t == rc_j == 0
    assert doc_t[0]["schedule"]["moe"] == doc_j[0]["schedule"]["moe"]
    assert doc_t[0]["schedule"]["microbatches"] == 4

    def e(doc):
        return sorted((i["rule_id"], i["severity"], i["node"] or "")
                      for i in doc[0]["issues"]
                      if i["rule_id"].startswith("MXL-E"))
    assert e(doc_t) == e(doc_j) and e(doc_t)
    rc = mxlint.main(["--model", "transformer", "--mesh", "pp=2",
                      "--schedule"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "-- schedule (pp, 2 stages x 4 microbatches)" in out
    assert "1f1b   bubble" in out
