"""Bind-time validation in the port (``Executor(validate=...)``,
``Symbol.validate``), held to the JAX package's: the twins of
``tests/test_analysis.py``'s ``test_bind_validate_*`` and
``test_clean_bind_emits_no_warning``, the mode surviving ``reshape``,
the program registry counting the same programs within a mode, the
roofline priced at the bound dtype, Rtc's
launch lint (``MXTPU_RTC_LINT``), and the analyzer's telemetry counters
(``collective_bytes``, ``emit_static_roofline``) read back by the
port's ``mxtop`` and ``mxtrace``.
"""
import io
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import analysis as jan
from mxnet_tpu import executor as jexec
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch import executor as texec
from mxnet_tpu_torch import rtc as trtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import counters as tcounters
from mxnet_tpu_torch.observability import events as tevents


def _zeros(mx, shape):
    if mx is tmx:
        return mx.nd.zeros(shape, ctx=mx.cpu(), dtype="float32")
    return mx.nd.zeros(shape, dtype=np.float32)


def _bad_bind_kwargs(mx):
    net = mx.sym.Variable("a") + mx.sym.Variable("b")
    g = _zeros(mx, (4,))
    args = {"a": _zeros(mx, (4,)), "b": _zeros(mx, (4,))}
    return net, dict(args=args, args_grad={"a": g, "b": g},
                     grad_req="write")


PKGS = [(jmx, jan), (tmx, tan)]
IDS = ["jax", "torch"]


def _lint_warnings(rec, an):
    return [w for w in rec if issubclass(w.category, an.GraphLintWarning)]


@pytest.mark.parametrize("mx,an", PKGS, ids=IDS)
def test_bind_validate_default_warns(mx, an):
    net, kw = _bad_bind_kwargs(mx)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        exe = net.bind(mx.cpu(), **kw)
    lint = _lint_warnings(rec, an)
    assert len(lint) == 1 and "MXL-B001" in str(lint[0].message)
    assert {i.rule_id for i in exe.bind_issues} >= {"MXL-B001"}


@pytest.mark.parametrize("mx,an", PKGS, ids=IDS)
def test_bind_validate_error_raises(mx, an):
    net, kw = _bad_bind_kwargs(mx)
    with pytest.raises(mx.base.MXNetError, match="MXL-B001"):
        net.bind(mx.cpu(), validate="error", **kw)


@pytest.mark.parametrize("mx,an", PKGS, ids=IDS)
def test_bind_validate_off_is_silent(mx, an):
    net, kw = _bad_bind_kwargs(mx)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        exe = net.bind(mx.cpu(), validate="off", **kw)
    assert not _lint_warnings(rec, an)
    assert exe.bind_issues == []


@pytest.mark.parametrize("mx,an", PKGS, ids=IDS)
def test_bind_validate_env_default(mx, an, monkeypatch):
    monkeypatch.setenv("MXTPU_BIND_VALIDATE", "error")
    net, kw = _bad_bind_kwargs(mx)
    with pytest.raises(mx.base.MXNetError, match="bind validation failed"):
        net.bind(mx.cpu(), **kw)


@pytest.mark.parametrize("mx,an", PKGS, ids=IDS)
def test_bind_validate_bad_mode_rejected(mx, an):
    net, kw = _bad_bind_kwargs(mx)
    with pytest.raises(mx.base.MXNetError, match="validate"):
        net.bind(mx.cpu(), validate="loud", **kw)


@pytest.mark.parametrize("mx,an", PKGS, ids=IDS)
def test_clean_bind_emits_no_warning(mx, an):
    net = mx.models.get_mlp()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        exe = net.simple_bind(mx.cpu(), data=(8, 784))
    assert not _lint_warnings(rec, an)
    assert exe.bind_issues == []


def test_bind_refuses_the_same_graphs_as_the_jax_package():
    """validate="error" refuses a graph in the port exactly when it does
    in the JAX package, and the findings agree."""
    def graphs(mx):
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        x = mx.sym.Variable("x")
        f1 = mx.sym.FullyConnected(data=x, num_hidden=2, name="same")
        dup = mx.sym.FullyConnected(data=f1, num_hidden=2, name="same")
        fc = mx.sym.FullyConnected(data=x, num_hidden=3, name="fc")
        return [("shared grad", a + b, {"a": (4,), "b": (4,)}, True),
                ("duplicate names", dup, {"x": (2, 3)}, False),
                ("clean", fc, {"x": (2, 3)}, False)]

    results = {}
    for mx, an in PKGS:
        out = []
        for name, net, shapes, shared in graphs(mx):
            arg_shapes, _, _ = net.infer_shape(**shapes)
            args = {n: _zeros(mx, s) for n, s in
                    zip(net.list_arguments(), arg_shapes)}
            if shared:
                g = _zeros(mx, (4,))
                grads = {n: g for n in args}
            else:
                grads = {n: _zeros(mx, a.shape) for n, a in args.items()}
            try:
                exe = net.bind(mx.cpu(), args=args, args_grad=grads,
                               validate="error")
                out.append((name, "bound", sorted(
                    (i.rule_id, i.severity, i.node)
                    for i in exe.bind_issues)))
            except mx.base.MXNetError as exc:
                out.append((name, "refused", "MXL-" in str(exc)))
        results[mx.__name__] = out
    assert results["mxnet_tpu_torch"] == results["mxnet_tpu"]
    assert [r[1] for r in results["mxnet_tpu_torch"]] == \
        ["refused", "refused", "bound"]


def test_symbol_validate_signature_and_findings():
    net = tmx.models.get_mlp()
    assert net.validate(shapes={"data": (32, 784)}) == []
    # shape kwargs, infer_shape style; no shapes: infos only
    assert net.validate(data=(32, 784), target="cpu") == []
    assert {i.severity for i in net.validate(target="cpu")} == {"info"}
    import inspect
    tsig = inspect.signature(tmx.sym.Symbol.validate).parameters
    jsig = inspect.signature(jmx.sym.Symbol.validate).parameters
    assert list(tsig) == list(jsig)
    assert tsig["target"].default == "gpu"


def test_reshape_keeps_the_validation_mode():
    net, kw = _bad_bind_kwargs(tmx)
    exe = net.bind(tmx.cpu(), validate="off", **kw)
    assert exe.reshape(a=(4,), b=(4,))._validate_mode == "off"
    exe = tmx.models.get_mlp().simple_bind(tmx.cpu(), data=(8, 784),
                                           validate="error")
    re = exe.reshape(data=(4, 784), softmax_label=(4,))
    assert re._validate_mode == "error"
    assert re.bind_issues == []


def _unique_graph(mx, tag):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=7, name="fc_" + tag)
    return mx.sym.Activation(data=fc, act_type="tanh", name="act_" + tag)


@pytest.mark.parametrize("mode", ["warn", "off", "error"])
def test_program_counts_equal_within_a_mode(mode):
    """Binding one graph twice under one mode counts the same new
    programs and lowerings in both packages."""
    deltas = {}
    for mx, ex in ((jmx, jexec), (tmx, texec)):
        net = _unique_graph(mx, "mode_" + mode)
        before = ex.program_registry_stats()
        for _ in range(2):
            net.simple_bind(mx.cpu(), data=(2, 5), validate=mode)
        after = ex.program_registry_stats()
        deltas[mx.__name__] = {k: after[k] - before[k]
                               for k in ("programs", "lowerings")}
    assert deltas["mxnet_tpu_torch"] == deltas["mxnet_tpu"]
    assert deltas["mxnet_tpu_torch"] == {"programs": 1, "lowerings": 1}


def test_program_key_ignores_the_validation_mode():
    """The port's program reads neither the mode nor the rule set, so one
    graph bound under every mode, and after a rule is registered, is one
    program (the JAX package builds one a mode)."""
    net = _unique_graph(tmx, "all_modes")
    before = texec.program_registry_stats()
    for mode in ("warn", "off", "error", "off"):
        net.simple_bind(tmx.cpu(), data=(2, 5), validate=mode)

    @tan.register_rule("MXL-Z999", "info", "test-only rule")
    def _z(ctx):
        return []
    try:
        net.simple_bind(tmx.cpu(), data=(2, 5), validate="warn")
    finally:
        del tan.RULE_REGISTRY["MXL-Z999"]
    after = texec.program_registry_stats()
    assert {k: after[k] - before[k] for k in ("programs", "lowerings")} \
        == {"programs": 1, "lowerings": 1}


@pytest.mark.parametrize("dtype,env,priced", [
    ("float32", None, "float32"), ("bfloat16", None, "bfloat16"),
    ("float32", "bfloat16", "bfloat16")])
def test_bind_prices_products_at_the_bound_dtype(monkeypatch, dtype, env,
                                                 priced):
    """The roofline rules at bind price the products at the bound
    arrays' dtype, or at ``MXNET_COMPUTE_DTYPE``: above the FLOP floor a
    float32 bind gets MXL-R003 (the FMA pipes) and no MXL-R004, a
    bfloat16 one no R003 and R004 on its 4,096-long accumulation.  The
    lint's target is made ``gpu``, where the R family runs."""
    if env:
        monkeypatch.setenv("MXNET_COMPUTE_DTYPE", env)
    else:
        monkeypatch.delenv("MXNET_COMPUTE_DTYPE", raising=False)
    seen = []
    orig = tan.analyze

    def on_gpu(*args, **kwargs):
        seen.append(kwargs.get("compute_dtype"))
        kwargs["target"] = "gpu"
        return orig(*args, **kwargs)
    monkeypatch.setattr(tan, "analyze", on_gpu)
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data=data, num_hidden=4096, no_bias=True,
                                name="fc")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exe = fc.simple_bind(tmx.cpu(), type_dict={"data": dtype,
                                                   "fc_weight": dtype},
                             validate="error", data=(1024, 4096))
    assert seen == [priced]
    rules = {i.rule_id for i in exe.bind_issues}
    assert ("MXL-R003" in rules) == (priced == "float32")
    assert ("MXL-R004" in rules) == (priced == "bfloat16")


# ----------------------------------------------------------------------
# Rtc's launch lint
# ----------------------------------------------------------------------
@pytest.fixture
def card_limits(monkeypatch):
    """The launch limits of a stand-in CUDA device 0 (the H100's row):
    ``torch.device("cuda", 0)`` names a device without needing one."""
    monkeypatch.setitem(trtc._LIMITS, 0,
                        dict(tcounters.LIMITS[tcounters.DEFAULT_CARD]))
    return torch.device("cuda", 0)


def test_rtc_lint_warns_by_default(card_limits):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = trtc._launch_lint((1, 1, 1), (2048, 1, 1), card_limits,
                                "warn")
    assert [r for r, _s, _m in got] == ["MXL-K004"]
    lint = _lint_warnings(rec, tan)
    assert len(lint) == 1 and "MXL-K004" in str(lint[0].message)
    assert "rtc kernel" in str(lint[0].message)


def test_rtc_lint_error_raises_before_the_launch(card_limits):
    with pytest.raises(MXNetError, match="MXL-K004"):
        trtc._launch_lint((1, 70000, 1), (256, 1, 1), card_limits, "error")
    # a clean launch passes in every mode
    for mode in ("warn", "error", "off"):
        assert trtc._launch_lint((64, 1, 1), (256, 1, 1), card_limits,
                                 mode) == []
    assert trtc._launch_lint((1, 1, 1), (2048, 1, 1), card_limits,
                             "off") == []


# ----------------------------------------------------------------------
# the analyzer's counters
# ----------------------------------------------------------------------
def test_collective_bytes_equals_the_jax_comm_report():
    from mxnet_tpu.observability import counters as jcounters
    got = {}
    for mx, counters in ((jmx, jcounters), (tmx, tcounters)):
        data = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
        fc2 = mx.sym.FullyConnected(data=fc1, num_hidden=4, name="fc2")
        net = mx.sym.SoftmaxOutput(data=fc2, name="softmax")
        got[mx.__name__] = counters.collective_bytes(
            net, mx.parallel.LogicalMesh(dp=2, tp=2),
            shapes={"data": (8, 16), "softmax_label": (8,)}, target="cpu")
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"]


def test_emit_static_roofline_counter_read_by_mxtop_and_mxtrace(tmp_path,
                                                                monkeypatch):
    from mxnet_tpu_torch.observability import aggregate
    from mxnet_tpu_torch.tools import mxtop, mxtrace
    tel = str(tmp_path / "tel")
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", tel)
    monkeypatch.setenv("MXTPU_TELEMETRY", "1")
    tevents.refresh()
    try:
        assert tevents.enabled()
        data = tmx.sym.Variable("data")
        fc = tmx.sym.FullyConnected(data=data, num_hidden=4096,
                                    no_bias=True, name="fc")
        rep = tcounters.emit_static_roofline(
            fc, {"data": (1024, 4096)}, device_kind=tcounters.DEFAULT_CARD,
            compute_dtype="float32")
        tevents.emit("step", step=1, dur_ms=10.0)
        tevents.flush()
    finally:
        monkeypatch.delenv("MXTPU_TELEMETRY_DIR")
        monkeypatch.delenv("MXTPU_TELEMETRY")
        tevents.refresh()
    assert rep["flops_per_step"] == 3 * 2 * 1024 * 4096 * 4096
    recs = [r for r in aggregate.read_events(tel)
            if r.get("name") == "static_roofline"]
    assert len(recs) == 1
    bound = 1e3 * max(rep["flops_per_step"] / 67e12,
                      rep["hbm_bytes_per_step"] / 3.35e12)
    assert recs[0]["bound_ms"] == pytest.approx(bound)
    report = aggregate.build_report(aggregate.read_events(tel))
    assert report["pod"]["static_roofline"]["bound_ms"] == \
        pytest.approx(bound)
    out = io.StringIO()
    mxtop.render(report, out)
    assert "static roofline" in out.getvalue()
    trace = mxtrace.build_trace(mxtrace.read_records(tel))
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(e.get("name") == "static_roofline" for e in evs)
