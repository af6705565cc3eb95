"""The port's static analyzer (``mxnet_tpu_torch/analysis/``) against the
JAX package's on the same graphs.

Each case of ``tests/test_analysis.py`` (S001 to C003/M002) and the
D001-D003 cases of ``tests/test_distributed_lint.py`` is built by one
function in both packages (``mx`` and ``an`` are the package and its
analysis module), and for the families S, T, G, B, L, P, M, C and D the
two lists of ``(rule_id, severity, node)`` must be equal; the
communication and memory reports' byte counts and the roofline rows'
FLOPs and raw bytes (at float32) must be equal too.  Both run on the
``"cpu"`` target, where the hardware families K and R are silent in both
packages; K (the Hopper launch budget) and R (the H100 roofline) are
held to hand arithmetic from ``observability.counters``' tables.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import analysis as jan
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch.analysis import tiling
from mxnet_tpu_torch.observability import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the families whose findings the packages share (K and R are the
#: hardware's)
SHARED = ("MXL-S", "MXL-T", "MXL-G", "MXL-B", "MXL-L", "MXL-P", "MXL-M",
          "MXL-C", "MXL-D")
H100 = counters.LIMITS[counters.DEFAULT_CARD]


def _triples(issues):
    return [(i.rule_id, i.severity, i.node) for i in issues
            if i.rule_id.startswith(SHARED)]


def _pkgs():
    return ((jmx, jan, "jax"), (tmx, tan, "torch"))


def _fresh_names(mx):
    """A fresh name scope: auto-named nodes (``plus0``, ``flatten3``)
    count from 0 in both packages whatever ran before."""
    from importlib import import_module
    return import_module(mx.__name__ + ".name").NameManager()


def _P(mx, *entries):
    if mx is jmx:
        from jax.sharding import PartitionSpec
    else:
        from mxnet_tpu_torch.parallel.sharding import PartitionSpec
    return PartitionSpec(*entries)


def _mesh(mx, **axes):
    return mx.parallel.LogicalMesh(**axes)


def _zeros(mx, shape):
    if mx is tmx:
        return mx.nd.zeros(shape, ctx=mx.cpu(), dtype="float32")
    return mx.nd.zeros(shape, dtype=np.float32)


def _attr_scope(mx, **attrs):
    from importlib import import_module
    return import_module(mx.__name__ + ".attribute").AttrScope(**attrs)


def _bf16(mx):
    if mx is jmx:
        import jax.numpy as jnp
        return jnp.bfloat16
    return "bfloat16"


def _register_demo(mx):
    name = "analysis_lintdemo_twin"

    class Prop(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

    mx.operator.register(name)(Prop)
    return name


# ----------------------------------------------------------------------
# the cases: each returns the findings of one analyzer call
# ----------------------------------------------------------------------
def _mlp(mx):
    return mx.models.get_mlp()


def case_clean_mlp(mx, an):
    return _mlp(mx).validate(shapes={"data": (32, 784)}, target="cpu")


def case_no_shapes(mx, an):
    return _mlp(mx).validate(target="cpu")


def case_s002(mx, an):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=5, name="fc")
    return (fc + data).validate(data=(8, 784), target="cpu")


def case_t001(mx, an):
    a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
    return (a + b).validate(shapes={"a": (4, 4), "b": (4, 4)},
                            type_dict={"a": np.float32, "b": _bf16(mx)},
                            target="cpu")


def case_t002(mx, an):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=3, name="fc")

    def boom(in_types):
        raise TypeError("synthetic infer_type failure")

    fc._heads[0][0].op.infer_type = boom
    return fc.validate(data=(2, 8), select={"MXL-T002"}, target="cpu")


def _orphans_json(mx):
    graph = json.loads(_mlp(mx).tojson())
    n = len(graph["nodes"])
    graph["nodes"].append({"op": "null", "name": "orphan_var",
                           "attr": {}, "inputs": []})
    graph["nodes"].append({"op": "Flatten", "name": "orphan_op",
                           "attr": {}, "inputs": [[n, 0]]})
    graph["arg_nodes"].append(n)
    return graph


def case_g001_g002_saved(mx, an):
    return an.analyze_json(_orphans_json(jmx), target="cpu")


def case_g002_bind_keys(mx, an):
    return an.analyze(_mlp(mx), args={"data": None, "not_an_arg": None},
                      select={"MXL-G002"}, target="cpu")


def case_g003(mx, an):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=2, name="fc")
    return (mx.sym.Group([fc, data]).validate(target="cpu")
            + mx.sym.Group([fc, fc]).validate(target="cpu"))


def case_g004(mx, an):
    a = mx.sym.Variable("x")
    f1 = mx.sym.FullyConnected(data=a, num_hidden=2, name="same")
    f2 = mx.sym.FullyConnected(data=f1, num_hidden=2, name="same")
    return f2.validate(target="cpu")


def _two_var_sum(mx):
    return mx.sym.Variable("a") + mx.sym.Variable("b")


def case_b001(mx, an):
    g = _zeros(mx, (4,))
    net = _two_var_sum(mx)
    return (an.analyze(net, args_grad={"a": g, "b": g}, grad_req="write",
                       target="cpu")
            + an.analyze(net, args_grad={"a": g, "b": g}, grad_req="add",
                         target="cpu"))


def case_b002(mx, an):
    net = _two_var_sum(mx)
    return (an.analyze(net, args_grad={"a": _zeros(mx, (4,))},
                       grad_req="write", target="cpu")
            + an.analyze(net, grad_req="write", target="cpu"))


def case_b003(mx, an):
    data = mx.sym.Variable("data")
    bn1 = mx.sym.BatchNorm(data=data, name="bn")
    bn2 = mx.sym.BatchNorm(data=bn1, name="bn")
    return an.analyze(bn2, grad_req="write", target="cpu")


def case_b004(mx, an):
    return an.analyze(_two_var_sum(mx), grad_req="wirte", target="cpu")


def case_b005(mx, an):
    with _attr_scope(mx, ctx_group="dev1"):
        net = _two_var_sum(mx)
    return (an.analyze(net, group2ctx={"dev2": mx.cpu()}, target="cpu")
            + an.analyze(net, target="cpu"))


def case_l001_platform(mx, an):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=2, name="fc")
    target = "tpu" if mx is jmx else "gpu"
    fc._heads[0][0].op.unsupported_platforms = (target,)
    return (fc.validate(target=target, select={"MXL-L*"})
            + fc.validate(target="cpu"))


def case_l001_saved(mx, an):
    graph = json.loads(_mlp(jmx).tojson())
    for spec in graph["nodes"]:
        if spec["op"] == "FullyConnected":
            spec["op"] = "NoSuchOp"
            break
    return an.analyze_json(graph, target="cpu")


def case_l002_l003(mx, an):
    name = _register_demo(mx)
    data = mx.sym.Variable("data")
    plain = mx.sym.Custom(data=data, op_type=name)
    out = mx.sym.FullyConnected(data=plain, num_hidden=2, name="fc")
    mirrored = mx.sym.Custom(data=data, op_type=name,
                             attr={"force_mirroring": "1"})
    out2 = mx.sym.FullyConnected(data=mirrored, num_hidden=2, name="fc")
    return (out.validate(data=(2, 4), target="cpu")
            + out2.validate(data=(2, 4), target="cpu"))


def case_l004(mx, an):
    net = _mlp(mx)
    mesh = _mesh(mx, dp=2, tp=2)
    bad = mx.parallel.ShardingRules(
        [(r".*_weight", lambda s, m: _P(mx, "mp", None))])
    ok = mx.parallel.ShardingRules(
        [(r"fc1_weight", lambda s, m: _P(mx, None, "tp"))])
    return (net.validate(data=(8, 784), mesh=mesh, sharding_rules=bad,
                         target="cpu", select={"MXL-L004"})
            + net.validate(data=(8, 784), mesh=mesh, sharding_rules=ok,
                           target="cpu", select={"MXL-L004"}))


def case_suppression(mx, an):
    name = _register_demo(mx)
    data = mx.sym.Variable("data")
    out = []
    for ignore in ("MXL-L002,MXL-L003", "all"):
        quiet = mx.sym.Custom(data=data, op_type=name,
                              attr={"force_mirroring": "1",
                                    "__lint_ignore__": ignore})
        net = mx.sym.FullyConnected(data=quiet, num_hidden=2, name="fc")
        out += net.validate(data=(2, 4), target="cpu")
    return out


def case_select_skip(mx, an):
    net = _mlp(mx)
    return (net.validate(select={"MXL-S001"}, target="cpu")
            + net.validate(skip={"MXL-S001"}, target="cpu"))


def _transformer(mx):
    from importlib import import_module
    tf = import_module(mx.__name__ + ".models.transformer")
    return tf.get_symbol(vocab_size=512, num_layers=2, num_heads=4, dim=64,
                         seq_len=64), {"data": (2, 64),
                                       "softmax_label": (2, 64)}


def case_spmd_transformer(mx, an):
    net, shapes = _transformer(mx)
    return net.validate(shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                        target="cpu")


def _mis_sharded(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    fc2 = mx.sym.FullyConnected(data=fc1, num_hidden=4, name="fc2")
    net = mx.sym.SoftmaxOutput(data=fc2, name="softmax")
    rules = mx.parallel.ShardingRules([
        (r"fc1_weight", lambda s, m: _P(mx, "tp", None)),
        (r"fc2_weight", lambda s, m: _P(mx, None, "dp")),
        (r".*_bias", lambda s, m: _P(mx, None)),
    ])
    return net, {"data": (8, 16), "softmax_label": (8,)}, rules


def case_p001(mx, an):
    net, shapes, rules = _mis_sharded(mx)
    return (an.analyze(net, shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                       sharding_rules=rules, target="cpu")
            + an.analyze(net, shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                         target="cpu"))


def _fc_softmax(mx, hidden=8):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=hidden, name="fc1")
    return mx.sym.SoftmaxOutput(data=fc, name="softmax")


def case_p002(mx, an):
    rules = mx.parallel.ShardingRules(
        [(r"fc1_weight", lambda s, m: _P(mx, None, None)),
         (r"fc1_bias", lambda s, m: _P(mx, "tp"))])
    return an.analyze(_fc_softmax(mx),
                      shapes={"data": (8, 16), "softmax_label": (8,)},
                      mesh=_mesh(mx, dp=2, tp=2), sharding_rules=rules,
                      target="cpu")


def case_p003(mx, an):
    return an.analyze(_fc_softmax(mx, 3),
                      shapes={"data": (4, 5), "softmax_label": (4,)},
                      mesh=_mesh(mx, dp=2, tp=2), target="cpu")


def _two_fc(mx, stages=False):
    data = mx.sym.Variable("data")
    if stages:
        with _attr_scope(mx, ctx_group="stage0"):
            fc1 = mx.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
        with _attr_scope(mx, ctx_group="stage1"):
            fc2 = mx.sym.FullyConnected(data=fc1, num_hidden=4, name="fc2")
    else:
        fc1 = mx.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
        fc2 = mx.sym.FullyConnected(data=fc1, num_hidden=4, name="fc2")
    net = mx.sym.SoftmaxOutput(data=fc2, name="softmax")
    rules = mx.parallel.ShardingRules(
        [(r"fc1_weight", lambda s, m: _P(mx, "tp", None)),
         (r"fc2_weight", lambda s, m: _P(mx, None, "tp")),
         (r".*_bias", lambda s, m: _P(mx, None))])
    return net, rules


def case_p004(mx, an):
    net, rules = _two_fc(mx)
    return an.analyze(net, shapes={"data": (8, 16), "softmax_label": (8,)},
                      mesh=_mesh(mx, dp=2, tp=2), sharding_rules=rules,
                      target="cpu")


def case_c003(mx, an):
    rules = mx.parallel.ShardingRules(
        [(r"fc1_weight", lambda s, m: _P(mx, None, "tp")),
         (r"fc1_bias", lambda s, m: _P(mx, None))])
    return an.analyze(_fc_softmax(mx),
                      shapes={"data": (8, 16), "softmax_label": (8,)},
                      mesh=_mesh(mx, dp=2, tp=2), sharding_rules=rules,
                      target="cpu")


def case_c001(mx, an):
    net = _mlp(mx)
    big = _mesh(mx, dp=64, tp=4)
    out = an.analyze(net, shapes={"data": (8, 784)}, kvstore="bogus",
                     target="cpu")
    for kv in ("device", "dist_async", "dist_sync"):
        out += an.analyze(net, shapes={"data": (8, 784)}, kvstore=kv,
                          mesh=big, target="cpu")
    return out


def case_c002(mx, an):
    net, rules = _two_fc(mx, stages=True)
    shapes = {"data": (8, 16), "softmax_label": (8,)}
    single = _mis_sharded(mx)[0]
    return (an.analyze(net, shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                       sharding_rules=rules, target="cpu")
            + an.analyze(single, shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                         target="cpu"))


def case_m001(mx, an):
    net = _mlp(mx)
    return (net.validate(data=(8, 784), mesh=_mesh(mx, dp=2, tp=2),
                         hbm_bytes=1024, target="cpu")
            + net.validate(data=(8, 784), mesh=_mesh(mx, dp=2, tp=2),
                           hbm_bytes=1 << 40, target="cpu"))


def case_m002(mx, an):
    net = _mlp(mx)
    repl = mx.parallel.ShardingRules(
        [(r".*", lambda s, m: _P(mx, *([None] * len(s))))])
    return (net.validate(data=(8, 784), mesh=_mesh(mx, dp=2, tp=2),
                         sharding_rules=repl, hbm_bytes=1_500_000,
                         target="cpu")
            + net.validate(data=(8, 784), mesh=_mesh(mx, dp=2, tp=2),
                           hbm_bytes=1_500_000, target="cpu"))


def case_lint_ignore_spmd(mx, an):
    rules = mx.parallel.ShardingRules(
        [(r"fc1_weight", lambda s, m: _P(mx, None, "tp")),
         (r"fc1_bias", lambda s, m: _P(mx, None))])
    out = []
    for attr in (None, {"__lint_ignore__": "MXL-C003"}):
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data=data, num_hidden=8, name="fc1",
                                   attr=attr)
        net = mx.sym.SoftmaxOutput(data=fc, name="softmax")
        out += an.analyze(net, shapes={"data": (8, 16),
                                       "softmax_label": (8,)},
                          mesh=_mesh(mx, dp=2, tp=2), sharding_rules=rules,
                          target="cpu")
    return out


def case_wildcard(mx, an):
    net, shapes, rules = _mis_sharded(mx)
    return (an.analyze(net, shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                       sharding_rules=rules, select={"MXL-P*"},
                       target="cpu")
            + an.analyze(net, shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                         sharding_rules=rules, skip={"MXL-P*"},
                         target="cpu"))


def _dist(mx, build, world_size=4):
    return build(mx.sym).validate(data=(4, 8), world_size=world_size,
                                  select=["MXL-D*"], target="cpu")


def _d003_graph(sym):
    fc = sym.FullyConnected(data=sym.Variable("data"), num_hidden=8,
                            name="fc")
    fc._set_attr(__rank_cond__="coordinator", __collective__="barrier")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _d003_inherited(sym):
    gate = sym.FullyConnected(data=sym.Variable("data"), num_hidden=8,
                              name="gate")
    gate._set_attr(__rank_cond__="rank==0")
    act = sym.Activation(data=gate, act_type="relu", name="act")
    act._set_attr(__collective__="allreduce:dp")
    return sym.SoftmaxOutput(data=act, name="s")


def _d00x_pair(cond_a, coll_a, cond_b, coll_b):
    def build(sym):
        v = sym.Variable("data")
        a = sym.FullyConnected(data=v, num_hidden=8, name="a")
        a._set_attr(__rank_cond__=cond_a, __collective__=coll_a)
        b = sym.Activation(data=v, act_type="relu", name="b")
        b._set_attr(__rank_cond__=cond_b, __collective__=coll_b)
        return sym.Group([sym.SoftmaxOutput(data=a, name="s1"),
                          sym.SoftmaxOutput(data=b, name="s2")])
    return build


def _d003_bad_cond(sym):
    fc = sym.FullyConnected(data=sym.Variable("data"), num_hidden=8,
                            name="fc")
    fc._set_attr(__rank_cond__="rank**2", __collective__="barrier")
    return sym.SoftmaxOutput(data=fc, name="s")


def _unconditional(sym):
    fc = sym.FullyConnected(data=sym.Variable("data"), num_hidden=8,
                            name="fc")
    fc._set_attr(__collective__="allreduce:dp")
    return sym.SoftmaxOutput(data=fc, name="s")


def case_d003(mx, an):
    return (_dist(mx, _d003_graph) + _dist(mx, _d003_graph, 1)
            + _dist(mx, _d003_inherited))


def case_d001(mx, an):
    return _dist(mx, _d00x_pair("rank==0", "barrier", "rank!=0",
                                "allreduce:dp"))


def case_d002(mx, an):
    return _dist(mx, _d00x_pair("rank%2==0", "allreduce:dp", "rank%2==1",
                                "allreduce:tp"))


def case_d003_unparseable(mx, an):
    return _dist(mx, _d003_bad_cond, 2) + _dist(mx, _unconditional)


CASES = sorted(name for name in dir() if name.startswith("case_"))


@pytest.mark.parametrize("case", CASES)
def test_findings_equal_the_jax_package(case):
    fn = globals()[case]
    got = {}
    for mx, an, tag in _pkgs():
        with _fresh_names(mx):
            got[tag] = _triples(fn(mx, an))
    assert got["torch"] == got["jax"]


def test_env_knobs_enable_distributed_family(monkeypatch):
    monkeypatch.setenv("MXTPU_LINT_DISTRIBUTED", "1")
    monkeypatch.setenv("MXTPU_LINT_WORLD_SIZE", "8")
    got = {}
    for mx, an, tag in _pkgs():
        with _fresh_names(mx):
            got[tag] = _triples(_d003_graph(mx.sym).validate(
                data=(4, 8), select=["MXL-D*"], target="cpu"))
    assert got["torch"] == got["jax"] and got["torch"][0][0] == "MXL-D003"


# ----------------------------------------------------------------------
# the clean zoo at batch 2 (mxlint's sweep)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mlp", "lenet", "alexnet", "vgg",
                                  "googlenet", "inception_bn",
                                  "inception_v3", "resnet", "transformer"])
def test_zoo_clean_in_both_packages(name):
    from mxnet_tpu_torch.tools.mxlint import MODEL_SWEEP
    from importlib import import_module
    _n, kwargs, shapes = next(r for r in MODEL_SWEEP if r[0] == name)
    got = {}
    for mx, an, tag in _pkgs():
        sym = import_module(mx.__name__ + ".models." + name).get_symbol(
            **kwargs)
        got[tag] = _triples(an.analyze(sym, shapes=shapes, target="cpu"))
    assert got["torch"] == got["jax"] == []


# ----------------------------------------------------------------------
# byte counts: communication, memory, roofline rows
# ----------------------------------------------------------------------
def _ctx(an, net, **kw):
    out = []
    an.analyze(net, _ctx_out=out, target="cpu", **kw)
    return out[0]


def _strip_messages(rep):
    return json.loads(json.dumps(rep, default=str))


@pytest.mark.parametrize("which", ["transformer", "mis_sharded", "p004",
                                   "mlp_dp8"])
def test_comm_and_memory_reports_equal(which):
    reports = {}
    for mx, an, tag in _pkgs():
        scope = _fresh_names(mx)
        scope.__enter__()
        if which == "transformer":
            net, shapes = _transformer(mx)
            kw = dict(shapes=shapes, mesh=_mesh(mx, dp=2, tp=2))
        elif which == "mis_sharded":
            net, shapes, rules = _mis_sharded(mx)
            kw = dict(shapes=shapes, mesh=_mesh(mx, dp=2, tp=2),
                      sharding_rules=rules)
        elif which == "p004":
            net, rules = _two_fc(mx)
            kw = dict(shapes={"data": (8, 16), "softmax_label": (8,)},
                      mesh=_mesh(mx, dp=2, tp=2), sharding_rules=rules)
        else:
            net = _mlp(mx)
            kw = dict(shapes={"data": (32, 784)}, mesh=_mesh(mx, dp=8),
                      grad_req="write")
        scope.__exit__(None, None, None)
        ctx = _ctx(an, net, **kw)
        reports[tag] = (_strip_messages(an.comm_report(ctx)),
                        _strip_messages(an.peak_hbm_report(ctx)))
    assert reports["torch"] == reports["jax"]
    assert reports["torch"][1]["peak_bytes"] > 0


def test_memory_estimate_matches_analytic():
    """tests/test_analysis.py's hand-priced graph, in the port."""
    from mxnet_tpu_torch.analysis import AnalysisContext, peak_hbm_report
    mx = tmx
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(data=fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(data=act, num_hidden=2, name="fc2")
    net = mx.sym.SoftmaxOutput(data=fc2, name="softmax")
    shapes = {"data": (4, 8), "softmax_label": (4,)}
    rep = peak_hbm_report(AnalysisContext(
        net, shapes=shapes, mesh=mx.parallel.LogicalMesh(dp=1),
        grad_req="write"))
    assert rep["params_bytes"] == 4 * (16 * 8 + 16 + 2 * 16 + 2 + 4 * 8 + 4)
    assert rep["grads_bytes"] == 4 * (16 * 8 + 16 + 2 * 16 + 2)
    assert rep["activations_bytes"] == 4 * (4 * 16 + 4 * 16 + 4 * 2 + 4 * 2)
    irep = peak_hbm_report(AnalysisContext(
        net, shapes=shapes, mesh=mx.parallel.LogicalMesh(dp=1),
        grad_req="null"))
    assert irep["mode"] == "inference" and irep["grads_bytes"] == 0
    assert irep["peak_bytes"] < rep["peak_bytes"]


@pytest.mark.parametrize("which", ["transformer", "resnet18", "quantized"])
def test_roofline_rows_equal(which):
    rows = {}
    for mx, an, tag in _pkgs():
        from importlib import import_module
        scope = _fresh_names(mx)
        scope.__enter__()
        if which == "transformer":
            net, shapes = _transformer(mx)
            grad_req = "write"
        elif which == "resnet18":
            net = import_module(mx.__name__ + ".models.resnet").get_symbol(
                num_classes=10, num_layers=18, image_shape=(3, 32, 32))
            shapes, grad_req = {"data": (4, 3, 32, 32)}, "write"
        else:
            data = mx.sym.Variable("data")
            q = mx.sym.QuantizedDense(data=data, num_hidden=64,
                                      qdtype="fp8_e4m3", name="qd")
            net = mx.sym.SoftmaxOutput(data=q, name="softmax")
            shapes, grad_req = {"data": (8, 32)}, "null"
        ctx = _ctx(an, net, shapes=shapes, grad_req=grad_req,
                   compute_dtype="float32")
        scope.__exit__(None, None, None)
        rep = an.roofline_report(ctx)
        facts = an.roofline._op_costs(ctx)
        rows[tag] = ([(r["node"], r["op"], r["flops"], r["bytes"], r["mxu"],
                       [tuple(d) for d in (r["mxu_dims"] or ())],
                       r["reduce_len"], r["compute_dtype"])
                      for r in facts["rows"]],
                     rep["flops_per_step"], rep["op_hbm_bytes_per_step"],
                     rep["param_count"], rep["mode"], rep["complete"])
    assert rows["torch"] == rows["jax"]


# ----------------------------------------------------------------------
# MXL-R: the H100 roofline, by hand arithmetic from PEAKS
# ----------------------------------------------------------------------
def _big_fc(mx, num_hidden=4096, k=4096, batch=1024):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=num_hidden,
                               no_bias=True, name="fc")
    return fc, {"data": (batch, k)}


def test_r_roofline_by_hand():
    """One FullyConnected (m=1024, k=4096, n=4096, no bias), training at
    float32: 3 passes of 2mkn FLOPs; 2 passes... 3 of (mk + kn + mn)
    elements of 4 bytes, plus 24 bytes a weight; the H100 SXM's
    67 TFLOP/s over 3.35 TB/s."""
    net, shapes = _big_fc(tmx)
    rep = tan.static_mfu_ceiling(net, shapes, compute_dtype="float32",
                                 device_kind=counters.DEFAULT_CARD)
    m, k, n = 1024, 4096, 4096
    flops = 3 * 2 * m * k * n
    byts = 3 * 4 * (m * k + k * n + m * n) + 24 * k * n
    assert rep["flops_per_step"] == flops
    assert rep["hbm_bytes_per_step"] == byts == rep["op_hbm_bytes_per_step"]
    peak = counters.PEAKS[counters.DEFAULT_CARD]
    ridge = peak["tflops"]["float32"] * 1e12 / peak["bytes_per_s"]
    assert rep["ridge"] == pytest.approx(ridge)
    assert rep["mfu_ceiling"] == pytest.approx(min(1.0, flops / byts / ridge))
    assert rep["bound"] == ("compute" if flops / byts >= ridge
                            else "bandwidth")
    bf = tan.static_mfu_ceiling(net, shapes, compute_dtype="bfloat16",
                                device_kind=counters.DEFAULT_CARD)
    assert bf["peak_tflops"] == 989.0
    assert bf["hbm_bytes_per_step"] == \
        3 * 2 * (m * k + k * n + m * n) + 24 * k * n


def test_r_inference_pays_no_update_traffic():
    """Without a trained parameter: one pass of the op's traffic and no
    24 bytes a weight."""
    net, shapes = _big_fc(tmx)
    rep = tan.static_mfu_ceiling(net, shapes, compute_dtype="float32",
                                 grad_req="null")
    m, k, n = 1024, 4096, 4096
    assert rep["mode"] == "inference"
    assert rep["flops_per_step"] == 2 * m * k * n
    assert rep["hbm_bytes_per_step"] == 4 * (m * k + k * n + m * n)


def test_r_quantized_rows_price_at_fp8():
    data = tmx.sym.Variable("data")
    q = tmx.sym.QuantizedDense(data=data, num_hidden=4096, qdtype="fp8_e4m3",
                               name="qd")
    rep = tan.static_mfu_ceiling(q, {"data": (512, 4096)},
                                 compute_dtype="float32", grad_req="null",
                                 device_kind=counters.DEFAULT_CARD)
    # all FLOPs at fp8: the effective peak is the fp8 rate
    assert rep["peak_tflops"] == pytest.approx(1979.0)
    assert rep["quantized_flops"] == rep["flops_per_step"]


def test_r_padding_waste_against_wgmma_tile():
    waste = tan.mxu_padding_waste
    assert waste([(64, 16, 8)], "bfloat16") == 0.0
    assert waste([(128, 32, 256)], "bfloat16") == 0.0
    # m 65 pads to 128; k 17 to 32 (bf16 k16); n 9 to 16
    assert waste([(65, 17, 9)], "bfloat16") == pytest.approx(
        1 - 65 * 17 * 9 / (128 * 32 * 16))
    # fp8's k grain is 32, float32's 8
    assert waste([(64, 16, 8)], "fp8") == pytest.approx(0.5)
    assert waste([(64, 8, 8)], "float32") == 0.0


def test_r_rules_fire_on_gpu_only():
    net, shapes = _big_fc(tmx)
    gpu = net.validate(shapes=shapes, select={"MXL-R*"},
                       device_kind=counters.DEFAULT_CARD)
    ids = {i.rule_id for i in gpu}
    assert {"MXL-R003", "MXL-R005"} <= ids
    r003 = next(i for i in gpu if i.rule_id == "MXL-R003")
    assert "67" in r003.message and "989" in r003.message
    assert not net.validate(shapes=shapes, select={"MXL-R*"}, target="cpu")
    bf = net.validate(shapes=shapes, select={"MXL-R003"},
                      compute_dtype="bfloat16")
    assert not bf
    # R002: a product whose dims pad a quarter of the wgmma tiles away
    data = tmx.sym.Variable("data")
    odd = tmx.sym.FullyConnected(data=data, num_hidden=4100, no_bias=True,
                                 name="odd")
    hits = odd.validate(shapes={"data": (1040, 4100)}, select={"MXL-R002"},
                        compute_dtype="bfloat16",
                        device_kind=counters.DEFAULT_CARD)
    assert not hits       # m 1040 pads 1088, n 4100 to 4104: little waste
    tiny = tmx.sym.FullyConnected(data=data, num_hidden=9, no_bias=True,
                                  name="tiny")
    hits = tiny.validate(shapes={"data": (1 << 20, 4096)},
                         select={"MXL-R002"}, compute_dtype="bfloat16",
                         device_kind=counters.DEFAULT_CARD)
    assert [i.node for i in hits] == ["tiny"]


def test_r_peaks_come_from_the_one_table(monkeypatch):
    assert tan.device_peaks(counters.DEFAULT_CARD, "float32") == (
        67e12, 3.35e12)
    assert tan.device_peaks(counters.DEFAULT_CARD, "int8")[0] == 1979e12
    assert tan.device_peaks("no such card") == (None, None)
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "100")
    monkeypatch.setenv("BENCH_PEAK_HBM_GBPS", "1000")
    assert tan.device_peaks("no such card") == (100e12, 1000e9)


# ----------------------------------------------------------------------
# MXL-K: the Hopper launch budget, by hand from LIMITS
# ----------------------------------------------------------------------
def _launch(**kw):
    spec = {"name": "k", "grid": (1, 1, 1), "block": (128, 1, 1),
            "dynamic_smem": 0}
    spec.update(kw)
    return spec


def _rules(findings):
    return sorted({r for r, _s, _m in findings})


def test_k_limits_table_is_the_h100_data_sheet():
    assert H100["smem_per_block_optin"] == 227 * 1024
    assert H100["smem_per_sm"] == 228 * 1024
    assert (H100["regs_per_sm"], H100["regs_per_thread"], H100["sms"]) == \
        (65536, 255, 132)
    assert counters.launch_limits(counters.DEFAULT_CARD) == H100


@pytest.mark.parametrize("spec,want", [
    # K001: shared memory a block, at and over the opt-in limit
    (_launch(dynamic_smem=232448), []),
    (_launch(dynamic_smem=232449), ["MXL-K001"]),
    (_launch(dynamic_smem=232440, static_smem=16), ["MXL-K001"]),
    # without opting in, 48 KB
    (_launch(dynamic_smem=49152, optin=False), []),
    (_launch(dynamic_smem=49153, optin=False), ["MXL-K001"]),
    # a __launch_bounds__(128, 2) promise: 2 x (smem + 1 KB) <= 228 KB
    (_launch(dynamic_smem=115712, min_blocks=2), []),
    (_launch(dynamic_smem=115713, min_blocks=2), ["MXL-K001"]),
    # K002: TMA boxes, vector loads, wgmma tiles
    (_launch(tma=[{"box": (64, 128), "dtype": "bfloat16"}]), []),
    (_launch(tma=[{"box": (4, 128), "dtype": "bfloat16"}]), ["MXL-K002"]),
    (_launch(vectors=[{"extent": 4, "dtype": "float32"}]), []),
    (_launch(vectors=[{"extent": 6, "dtype": "bfloat16"}]), ["MXL-K002"]),
    (_launch(wgmma=[{"m": 64, "n": 240, "k": 16, "dtype": "bfloat16"}]), []),
    (_launch(wgmma=[{"m": 64, "n": 256, "k": 32, "dtype": "fp8"}]), []),
    (_launch(wgmma=[{"m": 128, "n": 64, "k": 16}]), ["MXL-K002"]),
    (_launch(wgmma=[{"m": 64, "n": 260, "k": 16}]), ["MXL-K002"]),
    (_launch(wgmma=[{"m": 64, "n": 12, "k": 16}]), ["MXL-K002"]),
    (_launch(wgmma=[{"m": 64, "n": 64, "k": 16, "dtype": "fp8"}]),
     ["MXL-K002"]),
    # K003: a grid's tail, warning only
    (_launch(tiles=[{"extent": 1024, "tile": 128}]), []),
    (_launch(tiles=[{"extent": 1000, "tile": 128}]), ["MXL-K003"]),
    (_launch(grid=(0, 1, 1)), ["MXL-K003"]),
    # K004: threads, grid extents, registers, malformed
    (_launch(block=(1024, 1, 1)), []),
    (_launch(block=(2048, 1, 1)), ["MXL-K004"]),
    (_launch(block=(32, 32, 2)), ["MXL-K004"]),
    (_launch(grid=(1, 65535, 65535)), []),
    (_launch(grid=(1, 65536, 1)), ["MXL-K004"]),
    (_launch(block=(256, 1, 1), regs=255), []),
    (_launch(block=(512, 1, 1), regs=255), ["MXL-K004"]),
    (_launch(regs=256), ["MXL-K004"]),
    (_launch(block=(384, 1, 1), setmaxnreg=[(128, 24), (256, 240)]), []),
    (_launch(block=(384, 1, 1), setmaxnreg=[(128, 240), (256, 240)]),
     ["MXL-K004"]),
    (_launch(block=(384, 1, 1), setmaxnreg=[(128, 24)]), ["MXL-K004"]),
    ({"name": "no launch"}, ["MXL-K004"]),
    ({"name": "grid only", "grid": (1,)}, ["MXL-K004"]),
])
def test_k_rules_over_and_under_each_limit(spec, want):
    got = tiling.spec_findings(spec, limits=H100)
    assert _rules(got) == want, got
    severity = {"MXL-K001": "error", "MXL-K002": "error",
                "MXL-K003": "warning", "MXL-K004": "error"}
    assert all(s == severity[r] for r, s, _m in got)


def test_k_register_budget():
    assert tiling.register_budget(384, 1, H100) == 168
    assert tiling.register_budget(128, 2, H100) == 255
    assert tiling.register_budget(160, 1, H100) == 255
    assert tiling.register_budget(1024, 1, H100) == 64
    assert tiling.register_budget(256, 4, H100) == 64


def test_k_registered_specs_are_clean():
    """Every launch the four hand kernels register (at the main paths'
    shapes) and the paged cache's layout lint clean against the H100."""
    names = set()
    for name, provider in tan.KERNEL_SPECS.items():
        for spec in provider():
            assert tiling.spec_findings(spec, limits=H100) == [], spec
            names.add(name)
    assert names >= {"kernels.flash_decode", "kernels.quantize",
                     "kernels.flash_attention", "kernels.fused_opt",
                     "paged_kv_cache"}
    assert tan.kernel_spec_issues(limits=H100) == []


def test_k_specs_follow_the_plans():
    from mxnet_tpu_torch.kernels import (flash_attention, flash_decode,
                                         fused_opt, quantize)
    fd = flash_decode.launch_spec(8, 8, 32, 32, 64, sms=132)
    plan = flash_decode.plan_flash_decode(8, 8, 32, 32, 64, 132)
    assert fd["grid"] == plan["grid"] and fd["block"] == (128, 1, 1)
    # G = 16 lanes a group of 4-float pieces: 8 groups x 64 floats of o,
    # their m and l, and the span's table slots
    assert fd["dynamic_smem"] == (8 * 64 + 2 * 8) * 4 + \
        plan["blocks_per_split"] * 4
    gemv = quantize.launch_specs(8, 8192, 512, sms=132)
    assert [s["name"] for s in gemv] == ["qmm_gemv<float32, int8, 8>"]
    assert gemv[0]["dynamic_smem"] == 8 * (512 // 16 * 20) * 4
    tc = quantize.launch_specs(960, 8192, 512, sms=132)
    assert [s["name"] for s in tc] == ["qmm_split",
                                       "qmm_wgmma<float32, int8, 240, 3>"]
    assert tc[1]["dynamic_smem"] == 1024 + 2 * (64 * 64 + 3 * 240 * 64 * 2) \
        + 32
    assert tc[1]["grid"] == (128, 4, 1)
    # a split K adds the reduction
    split = quantize.launch_specs(1, 512, 8192, sms=132)
    assert split[-1]["name"] == "qmm_reduce<float32>"
    f32 = flash_attention.launch_spec(8, 8, 1024, 1024, 64, "float32")
    assert f32["dynamic_smem"] == 114688 and f32["min_blocks"] == 2
    assert f32["grid"] == (64 * 8, 1, 1)
    bf = flash_attention.launch_spec(8, 8, 1024, 1024, 64, "bfloat16",
                                     sms=132)
    assert bf["dynamic_smem"] == 164960 and bf["grid"] == (132, 1, 1)
    assert tiling.register_budget(384, 1, H100) == 168
    ragged = flash_attention.launch_spec(8, 8, 1000, 1000, 64, "float32")
    assert _rules(tiling.spec_findings(ragged, H100)) == ["MXL-K003"]
    sw = fused_opt.launch_spec(16279040, 1, "vec4")
    assert sw["grid"] == (2112, 1, 1)
    assert fused_opt.launch_spec(100, 0, "scalar")["grid"] == (1, 1, 1)


def test_k_wgmma_tiles_are_generated_instructions():
    """Each wgmma tile a spec declares is an instruction that
    csrc/gen_wgmma.py generates (its N column)."""
    sys.path.insert(0, os.path.join(ROOT, "mxnet_tpu_torch", "csrc"))
    try:
        import gen_wgmma
    finally:
        sys.path.pop(0)
    ns = {n for _form, n, _t in gen_wgmma.SHAPES}
    seen = set()
    for provider in tan.KERNEL_SPECS.values():
        for spec in provider():
            for t in spec.get("wgmma", ()):
                assert t["n"] in ns, (spec["name"], t)
                seen.add(t["n"])
    assert seen


def test_k_rules_silent_off_gpu_target():
    bad = {"name": "too_many_threads", "grid": (1,), "block": (2048,)}
    tan.register_kernel_spec("test.bad", bad)
    try:
        net = _mlp(tmx)
        gpu = net.validate(shapes={"data": (2, 784)}, select={"MXL-K*"})
        assert [(i.rule_id, i.severity) for i in gpu] == [("MXL-K004",
                                                          "error")]
        assert not net.validate(shapes={"data": (2, 784)},
                                select={"MXL-K*"}, target="cpu")
        # a provider that raises is one K004 error
        tan.register_kernel_spec("test.bad", lambda: 1 / 0)
        issues = tan.kernel_spec_issues(limits=H100)
        assert [(n, r) for n, r, _s, _m in issues] == [("test.bad",
                                                        "MXL-K004")]
    finally:
        tan.unregister_kernel_spec("test.bad")


def test_k_findings_worked_out_once_a_device(monkeypatch):
    """Every bind on one card reads the same K findings: the registered
    specs are linted once, and again only after the registry changes."""
    calls = []
    orig = tiling.kernel_spec_issues

    def counted(limits=None):
        calls.append(limits)
        return orig(limits)
    monkeypatch.setattr(tiling, "kernel_spec_issues", counted)
    monkeypatch.setattr(tiling, "_ISSUES", {})
    net = _mlp(tmx)
    kw = dict(shapes={"data": (2, 784)}, select={"MXL-K*"})
    for _ in range(3):
        assert net.validate(**kw) == []
    assert len(calls) == 1
    tan.register_kernel_spec("test.bad", {"name": "too_many_threads",
                                          "grid": (1,), "block": (2048,)})
    try:
        assert [i.rule_id for i in net.validate(**kw)] == ["MXL-K004"]
        assert len(calls) == 2
    finally:
        tan.unregister_kernel_spec("test.bad")
    assert net.validate(**kw) == [] and len(calls) == 3


def test_block_findings_of_a_launch():
    assert tiling.block_findings((4, 1, 1), (256, 1, 1), limits=H100) == []
    got = tiling.block_findings((1, 1, 1), (2048, 1, 1), limits=H100)
    assert _rules(got) == ["MXL-K004"] and "CUDA_ERROR_INVALID_VALUE" in \
        got[0][2]
    assert _rules(tiling.block_findings((1, 1), (1, 2, 3, 4),
                                        limits=H100)) == ["MXL-K004"]


def test_hbm_capacity_from_the_table(monkeypatch):
    assert tan.hbm_capacity_bytes(counters.DEFAULT_CARD) == 80 * (1 << 30)
    assert tan.hbm_capacity_bytes("no such card") is None
    assert tan.hbm_capacity_bytes(None) is None
    monkeypatch.setenv("MXTPU_HBM_GB", "1.5")
    assert tan.hbm_capacity_bytes(counters.DEFAULT_CARD) == int(
        1.5 * (1 << 30))


# ----------------------------------------------------------------------
# the source half: the entry points and analyze(source_paths=...)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fn,family,rules", [
    ("analyze_source_paths", "divergence",
     {"MXL-D004", "MXL-D005", "MXL-D006"}),
    ("analyze_concurrency_paths", "concurrency",
     {"MXL-Q001", "MXL-Q004", "MXL-Q005"}),
    ("analyze_retrace_paths", "retrace", {"MXL-X002"})])
def test_source_entry_points_run(fn, family, rules):
    fixtures = os.path.join(ROOT, "tests", "fixtures", family)
    got = getattr(tan, fn)([fixtures], root=ROOT)
    assert {f["rule"] for f in got} == rules
    assert got == getattr(jan, fn)([fixtures], root=ROOT)
    issues = tan.analyze(None, source_paths=[fixtures],
                         select=[sorted(rules)[0][:5] + "*"])
    assert {i.rule_id for i in issues} == rules
    for i in issues:
        assert i.anchor.startswith("tests/fixtures/%s/" % family)
        assert isinstance(i.line, int) and i.line > 0
        assert i.severity == tan.RULE_REGISTRY[i.rule_id].severity


def test_source_families_silent_without_paths():
    """A graph lint runs no source family: they read ``source_paths``."""
    sym = tmx.models.get_mlp()
    issues = tan.analyze(sym, shapes={"data": (8, 784)}, target="cpu")
    assert not [i for i in issues if i.rule_id[:5] in ("MXL-Q", "MXL-X")
                or i.rule_id in ("MXL-D004", "MXL-D005", "MXL-D006")]


def test_markers_are_the_port_base_markers():
    from mxnet_tpu_torch import base
    assert tan.collective_seam is base.collective_seam
    assert tan.thread_entry is base.thread_entry
    assert tan.traced_scope is base.traced_scope

    @tan.thread_entry
    def f():
        return 3
    assert f() == 3


def test_rule_catalog_shares_ids_with_the_jax_package():
    port = set(tan.RULE_REGISTRY)
    jax_ids = set(jan.RULE_REGISTRY)
    # every rule of the JAX package, the source families D004-D006, Q and
    # X included (K and R keep their ids with the card's meaning)
    assert port == jax_ids
    for rid in port:
        if rid.startswith(SHARED + ("MXL-E", "MXL-Q", "MXL-X")):
            assert tan.RULE_REGISTRY[rid].severity == \
                jan.RULE_REGISTRY[rid].severity, rid


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import mxnet_tpu_torch.analysis as a\n"
            "import mxnet_tpu_torch.tools.mxlint as m\n"
            "assert not any(k == 'mxnet_tpu' or k.startswith('mxnet_tpu.')"
            " for k in sys.modules)\n"
            "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
            "print(len(a.RULE_REGISTRY), m.MODEL_SWEEP[0][0])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(tan.RULE_REGISTRY)), "mlp"]
