"""The port's Custom python ops against the JAX package's, on the CPU.

Twins of ``tests/test_custom_op.py``: every scenario is built in both
packages from one definition (``_define``) and run on the same seeded
float32 inputs; outputs and gradients are held to numpy and to each
other at rtol 1e-5 and atol 1e-6.  Then the bridge's own contract: an
output that receives no gradient reaches the user's backward as zeros,
``is_train`` as the JAX package passes it, aux updated in ``forward``
carried out and in ``backward`` dropped, one operator a bound executor
and shape, mirroring (the user's forward re-run in the backward, the
results unchanged), copies that never alias the user's arrays, and a
failing user forward raising through ``forward``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _define(mx):
    """The test ops, registered under ``tc_*`` in ``mx``'s registry;
    returns a namespace with their classes and a call log."""
    op_mod = mx.operator
    log = {"forward_train": [], "backward_out_grad": [], "created": 0,
           "forward_calls": 0, "kept": []}

    class Sigmoid(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            log["forward_train"].append(is_train)
            log["forward_calls"] += 1
            y = 1.0 / (1.0 + np.exp(-in_data[0]))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @op_mod.register("tc_sigmoid")
    class SigmoidProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            log["created"] += 1
            return Sigmoid()

    class CustomSoftmax(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lbl = in_data[1].astype(np.int64)
            y = out_data[0].copy()
            y[np.arange(y.shape[0]), lbl] -= 1.0
            self.assign(in_grad[0], req[0], y)
            self.assign(in_grad[1], req[1], np.zeros_like(in_grad[1]))

    @op_mod.register("tc_softmax")
    class CustomSoftmaxProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            data = in_shape[0]
            return [data, [data[0]]], [data], []

        def create_operator(self, ctx, shapes, dtypes):
            return CustomSoftmax()

    class Counter(op_mod.CustomOp):
        """out = x + count; forward adds 1 to count, backward 100 (which
        must not persist)."""

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] + aux[0])
            aux[0][...] = aux[0] + 1.0

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0])
            aux[0][...] = aux[0] + 100.0

    @op_mod.register("tc_counter")
    class CounterProp(op_mod.CustomOpProp):
        def list_auxiliary_states(self):
            return ["count"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [[1]]

        def create_operator(self, ctx, shapes, dtypes):
            return Counter()

    class TwoOut(op_mod.CustomOp):
        """(2x, x^2); the backward logs the head gradients it gets."""

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], 2.0 * in_data[0])
            self.assign(out_data[1], req[1], in_data[0] ** 2)
            log["kept"] = [in_data[0], out_data[0]]

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            log["backward_out_grad"].append([g.copy() for g in out_grad])
            self.assign(in_grad[0], req[0], 2.0 * out_grad[0]
                        + 2.0 * in_data[0] * out_grad[1])

    @op_mod.register("tc_two_out")
    class TwoOutProp(op_mod.CustomOpProp):
        def __init__(self, scale="1"):      # a kwarg, for load_json
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_outputs(self):
            return ["double", "square"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]]

        def create_operator(self, ctx, shapes, dtypes):
            return TwoOut()

    class LegacySquare(op_mod.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def forward(self, in_data, out_data):
            out_data[0][...] = in_data[0] ** 2

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][...] = 2.0 * in_data[0] * out_grad[0]

    class Failing(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            raise ValueError("user forward failed")

    @op_mod.register("tc_failing")
    class FailingProp(op_mod.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Failing()

    return dict(mx=mx, log=log, LegacySquare=LegacySquare,
                TwoOutProp=TwoOutProp)


J = _define(jmx)
T = _define(tmx)
BOTH = [pytest.param(J, id="jax"), pytest.param(T, id="port")]


def _bind(ns, sym, shapes, **kw):
    return sym.simple_bind(ns["mx"].cpu(), **dict(shapes, **kw))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _both(fn):
    """``fn(ns)`` in the JAX package and the port; the port's results
    held to the JAX package's, and both returned."""
    j, t = fn(J), fn(T)
    for a, b in zip(j, t):
        _close(b, a)
    return j, t


# ----------------------------------------------------------------------
# twins of tests/test_custom_op.py
# ----------------------------------------------------------------------
def test_custom_forward_matches_native():
    a = np.random.RandomState(1).uniform(-2, 2, (4, 5)).astype(np.float32)

    def run(ns):
        sym = ns["mx"].sym
        s = sym.Custom(data=sym.Variable("x"), op_type="tc_sigmoid")
        ex = _bind(ns, s, {"x": a.shape})
        ex.arg_dict["x"][:] = a
        return [ex.forward()[0].asnumpy()]
    _j, t = _both(run)
    _close(t[0], 1.0 / (1.0 + np.exp(-a)))


def test_custom_backward_via_user_code():
    rng = np.random.RandomState(2)
    a = rng.uniform(-2, 2, (4, 5)).astype(np.float32)
    og = rng.uniform(-1, 1, (4, 5)).astype(np.float32)

    def run(ns):
        mx = ns["mx"]
        s = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="tc_sigmoid")
        ex = _bind(ns, s, {"x": a.shape}, grad_req="write")
        ex.arg_dict["x"][:] = a
        ex.forward(is_train=True)
        ex.backward([mx.nd.array(og, ctx=mx.cpu())])
        return [ex.grad_dict["x"].asnumpy()]
    _j, t = _both(run)
    y = 1.0 / (1.0 + np.exp(-a))
    _close(t[0], og * y * (1 - y))


def test_custom_softmax_loss_style():
    rng = np.random.RandomState(3)
    a = rng.uniform(-2, 2, (6, 4)).astype(np.float32)
    lbl = rng.randint(0, 4, (6,)).astype(np.float32)

    def run(ns):
        sym = ns["mx"].sym
        s = sym.Custom(data=sym.Variable("data"), label=sym.Variable("label"),
                       op_type="tc_softmax")
        ex = _bind(ns, s, {"data": a.shape, "label": lbl.shape},
                   grad_req={"data": "write", "label": "null"})
        ex.arg_dict["data"][:] = a
        ex.arg_dict["label"][:] = lbl
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()           # loss-style: no head gradient
        return [out, ex.grad_dict["data"].asnumpy()]
    _j, (out, grad) = _both(run)
    e = np.exp(a - a.max(axis=1, keepdims=True))
    want = e / e.sum(axis=1, keepdims=True)
    _close(out, want)
    want[np.arange(6), lbl.astype(np.int64)] -= 1.0
    _close(grad, want)


def test_custom_kwargs_roundtrip_json():
    """The JSON of either package loads in the port; a node's graph
    attrs and kwargs its prop does not take are filtered on load."""
    for src in (jmx, tmx):
        x = src.sym.Variable("x")
        s = src.sym.Custom(data=x, op_type="tc_two_out", scale="3",
                           attr={"ctx_group": "dev1", "tag": "t"})
        loaded = tmx.sym.load_json(s.tojson())
        assert loaded.list_arguments() == s.list_arguments()
        assert loaded.list_outputs() == s.list_outputs()
        node = loaded._topo()[-1]
        assert node.op.prop.scale == 3.0
        assert node.attrs["tag"] == "t"
    s = tmx.sym.Custom(data=tmx.sym.Variable("x"), op_type="tc_sigmoid")
    assert jmx.sym.load_json(s.tojson()).list_arguments() == ["x"]


def test_custom_in_network():
    a = np.random.RandomState(4).uniform(-1, 1, (3, 4)).astype(np.float32)

    def run(ns):
        mx = ns["mx"]
        x = mx.sym.Variable("x")
        s = mx.sym.sum(mx.sym.Custom(data=x * 2.0, op_type="tc_sigmoid"))
        ex = _bind(ns, s, {"x": a.shape}, grad_req="write")
        ex.arg_dict["x"][:] = a
        ex.forward(is_train=True)
        ex.backward([mx.nd.array(np.ones((1,), np.float32), ctx=mx.cpu())])
        return [ex.grad_dict["x"].asnumpy()]
    _j, t = _both(run)
    y = 1.0 / (1.0 + np.exp(-2 * a))
    _close(t[0], 2 * y * (1 - y))


def test_legacy_numpy_op():
    rng = np.random.RandomState(5)
    a = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
    og = rng.uniform(-1, 1, (3, 4)).astype(np.float32)

    def run(ns):
        mx = ns["mx"]
        s = ns["LegacySquare"]().get_symbol(data=mx.sym.Variable("x"))
        ex = _bind(ns, s, {"x": a.shape}, grad_req="write")
        ex.arg_dict["x"][:] = a
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([mx.nd.array(og, ctx=mx.cpu())])
        return [out, ex.grad_dict["x"].asnumpy()]
    _j, (out, grad) = _both(run)
    _close(out, a ** 2)
    _close(grad, 2 * a * og)
    s = T["LegacySquare"]().get_symbol(data=tmx.sym.Variable("x"))
    assert s._topo()[-1].op.op_name == "_Native"
    with pytest.raises(tmx.MXNetError, match="token"):
        tmx.sym.load_json(s.tojson().replace("_legacy_op_", "_gone_op_"))


@pytest.mark.parametrize("ns", BOTH)
def test_custom_op_with_aux_state(ns):
    """Trap (d): aux mutated in forward is carried out (count 0 -> 1), the
    backward's mutation (+100) is dropped, in both packages."""
    mx = ns["mx"]
    a = np.ones((2, 3), np.float32)
    s = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="tc_counter",
                      name="cnt")
    ex = _bind(ns, s, {"x": a.shape}, grad_req="write")
    ex.arg_dict["x"][:] = a
    ex.aux_dict["cnt_count"][:] = np.zeros((1,), np.float32)
    out = ex.forward(is_train=True)[0].asnumpy()
    _close(out, a)
    assert ex.aux_dict["cnt_count"].asnumpy().tolist() == [1.0]
    ex.backward([mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu())])
    assert ex.aux_dict["cnt_count"].asnumpy().tolist() == [1.0]
    _close(ex.grad_dict["x"].asnumpy(), np.ones((2, 3)))
    out = ex.forward(is_train=True)[0].asnumpy()
    _close(out, a + 1.0)
    assert ex.aux_dict["cnt_count"].asnumpy().tolist() == [2.0]


@pytest.mark.parametrize("ns", BOTH)
def test_custom_infers_label_shape_from_data(ns):
    sym = ns["mx"].sym
    s = sym.Custom(data=sym.Variable("data"), label=sym.Variable("label"),
                   op_type="tc_softmax")
    arg_shapes, out_shapes, _ = s.infer_shape(data=(6, 4))
    assert [tuple(x) for x in arg_shapes] == [(6, 4), (6,)]
    assert [tuple(x) for x in out_shapes] == [(6, 4)]
    ex = _bind(ns, s, {"data": (6, 4)})
    assert tuple(ex.arg_dict["label"].shape) == (6,)


def test_infer_shape_and_type_take_two_or_three_lists():
    """A prop's 2-list ``infer_shape`` (outputs, no aux) and 2-list
    ``infer_type`` (aux float32) give what the JAX op gives."""
    from mxnet_tpu.ops.registry import create_operator as jcreate
    from mxnet_tpu_torch.ops.registry import create_operator as tcreate
    for name, in_shapes in (("tc_two_out", [(3, 4)]),
                            ("tc_counter", [(2, 5)]),
                            ("tc_softmax", [(6, 4), None])):
        j = jcreate("Custom", op_type=name)
        t = tcreate("Custom", op_type=name)
        assert t.infer_shape(list(in_shapes)) == j.infer_shape(
            list(in_shapes))
        types = [np.float64] * len(t.list_arguments())
        assert [list(map(np.dtype, x)) for x in t.infer_type(types)] == \
            [list(map(np.dtype, x)) for x in j.infer_type(types)]


# ----------------------------------------------------------------------
# the bridge's contract
# ----------------------------------------------------------------------
def test_output_without_gradient_reaches_backward_as_zeros():
    """Trap (b): only the first of two outputs is used downstream; the
    user's backward is handed zeros for the second, as the JAX package's
    zero cotangent."""
    rng = np.random.RandomState(6)
    a = rng.randn(3, 4).astype(np.float32)
    og = rng.randn(3, 4).astype(np.float32)
    got = {}
    for key, ns in (("jax", J), ("port", T)):
        mx = ns["mx"]
        ns["log"]["backward_out_grad"].clear()
        s = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="tc_two_out")
        ex = _bind(ns, s[0] * 1.0, {"x": a.shape}, grad_req="write")
        ex.arg_dict["x"][:] = a
        ex.forward(is_train=True)
        ex.backward([mx.nd.array(og, ctx=mx.cpu())])
        (g0, g1), = ns["log"]["backward_out_grad"]
        got[key] = (g0, g1, ex.grad_dict["x"].asnumpy())
    for key in got:
        g0, g1, gx = got[key]
        _close(g0, og)
        assert g1.shape == (3, 4) and not g1.any(), key
        _close(gx, 2.0 * og)


@pytest.mark.parametrize("ns", BOTH)
def test_is_train_flag_as_the_jax_package_passes_it(ns):
    """Trap (c): an inference forward hands ``is_train=False``; a training
    forward, differentiated or not, ``True``."""
    mx, log = ns["mx"], ns["log"]
    a = np.zeros((2, 2), np.float32)
    s = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="tc_sigmoid")
    log["forward_train"].clear()
    ex = _bind(ns, s, {"x": a.shape}, grad_req="write")
    ex.forward(is_train=False)
    ex.forward(is_train=True)
    ex_null = _bind(ns, s, {"x": a.shape}, grad_req="null")
    ex_null.forward(is_train=True)
    assert log["forward_train"] == [False, True, True]


def test_operator_created_once_per_executor_and_shape():
    """Trap (e): three training steps create the user's operator once; a
    reshape to another batch creates one more."""
    mx, log = T["mx"], T["log"]
    s = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="tc_sigmoid",
                      name="once")
    ex = _bind(T, s, {"x": (3, 2)}, grad_req="write")
    before = log["created"]
    for _ in range(3):
        ex.forward(is_train=True)
        ex.backward([mx.nd.ones((3, 2), ctx=mx.cpu())])
    ex.forward(is_train=False)
    assert log["created"] - before == 1
    ex2 = ex.reshape(x=(5, 2))
    ex2.forward(is_train=True)
    assert log["created"] - before == 2


def test_mirrored_segment_reruns_the_user_forward(monkeypatch):
    """Trap (f): under ``MXNET_BACKWARD_DO_MIRROR=1`` the Custom node sits
    in a recomputed segment: its forward runs again in the backward (two
    calls a step, one unmirrored), and the outputs and gradients are the
    same bit for bit."""
    mx, log = T["mx"], T["log"]
    rng = np.random.RandomState(7)
    a = rng.randn(4, 6).astype(np.float32)
    og = rng.randn(4, 6).astype(np.float32)

    def step(mirror):
        if mirror:
            monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
        else:
            monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
        x = mx.sym.Variable("x")
        h = mx.sym.Custom(data=x * 3.0, op_type="tc_sigmoid")
        s = mx.sym.Activation(data=h * h, act_type="tanh")
        ex = _bind(T, s, {"x": a.shape}, grad_req="write")
        ex.arg_dict["x"][:] = a
        calls = log["forward_calls"]
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([mx.nd.array(og, ctx=mx.cpu())])
        return (out, ex.grad_dict["x"].asnumpy(),
                log["forward_calls"] - calls, ex._program.n_mirrored)
    out0, g0, calls0, seg0 = step(False)
    out1, g1, calls1, seg1 = step(True)
    assert (seg0, seg1) == (0, 1)
    assert (calls0, calls1) == (1, 2)
    np.testing.assert_array_equal(out1, out0)
    np.testing.assert_array_equal(g1, g0)


def test_copies_never_alias_the_users_arrays():
    """Trap (a): the user keeps its ``in_data`` and ``out_data`` and writes
    them after the call; the executor's input, output and gradient do not
    change."""
    mx, log = T["mx"], T["log"]
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    s = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="tc_two_out")
    ex = _bind(T, s, {"x": a.shape}, grad_req="write")
    ex.arg_dict["x"][:] = a
    outs = ex.forward(is_train=True)
    kept_in, kept_out = log["kept"]
    kept_in[...] = -7.0
    kept_out[...] = -7.0
    np.testing.assert_array_equal(outs[0].asnumpy(), 2.0 * a)
    np.testing.assert_array_equal(ex.arg_dict["x"].asnumpy(), a)
    stats = tmx.operator.host_stats()
    assert stats["forward_calls"] >= 1 and stats["to_host_bytes"] > 0


def test_failing_user_forward_raises_through_forward():
    mx = T["mx"]
    s = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="tc_failing")
    ex = _bind(T, s, {"x": (2, 2)}, grad_req="write")
    with pytest.raises(ValueError, match="user forward failed"):
        ex.forward(is_train=True)
    with pytest.raises(ValueError, match="user forward failed"):
        ex.forward(is_train=False)


def test_custom_op_registry_surface():
    assert "tc_sigmoid" in tmx.operator.get_all_registered()
    with pytest.raises(tmx.MXNetError, match="CustomOpProp"):
        tmx.operator.register("tc_bad")(object)
    with pytest.raises(tmx.MXNetError, match="op_type"):
        tmx.sym.Custom(data=tmx.sym.Variable("x"))
    x = torch.zeros(2, dtype=torch.bfloat16)
    with pytest.raises(tmx.MXNetError, match="numpy has no"):
        tmx.operator._np_dtype(x)


def test_custom_softmax_example_fits_on_the_cpu():
    """``example/numpy-ops-torch/custom_softmax.py``: Module.fit with the
    CustomOp loss reaches the JAX example's accuracy bar."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "example",
                        "numpy-ops-torch", "custom_softmax.py")
    spec = importlib.util.spec_from_file_location("tc_custom_softmax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(ctx=tmx.cpu(), num_epoch=2) > 0.8
