"""Concat, LRN, Symbol arithmetic and Symbol.grad of the port against the
JAX package, on the CPU.

The ops run on the same seeded numpy inputs in both packages (float32,
and bfloat16 for the scalar ops), with the vector-Jacobian product of a
seeded cotangent (``jax.vjp`` against ``torch.autograd.grad``).

Tolerances, relative to the larger of 1 and the reference's max-abs:
float32 forward 1e-5 and gradients 1e-4 (the op tests' own); bfloat16
forward and gradients 1e-2 (one bfloat16 rounding is 2^-8 = 3.9e-3
relative; ``torch.pow`` and ``jnp.power`` may round their last bit
differently).  LRN: 1e-5 forward and 1e-4 gradients (the window sum adds
in another order, and ``torch.pow(base, -beta)`` against ``jnp.power``).
Symbols: the JSON text equal op for op, the values within 1e-5.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import create_operator as jcreate

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.registry import create_operator as tcreate

from test_torch_resnet_ops import _check, _close, _run_both

BF16_TOL = 1e-2


# ----------------------------------------------------------------------
# Concat and LRN
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,dim", [(2, 1), (3, 1), (4, 1), (2, 0), (3, 3),
                                   (4, 0)])
def test_concat_matches_jax(n, dim):
    rng = np.random.RandomState(n * 10 + dim)
    shapes = []
    for i in range(n):
        s = [2, 3, 4, 5]
        s[dim] = i + 1
        shapes.append(tuple(s))
    ins = [rng.randn(*s).astype(np.float32) for s in shapes]
    j, t = _run_both("Concat", dict(num_args=n, dim=dim), ins)
    _check(j, t, ["arg%d" % i for i in range(n)])
    top = tcreate("Concat", num_args=n, dim=dim)
    want = jcreate("Concat", num_args=n, dim=dim).infer_shape(shapes)
    assert top.infer_shape(shapes) == ([tuple(s) for s in want[0]],
                                       [tuple(want[1][0])], [])


@pytest.mark.parametrize("nsize,shape", [(3, (2, 7, 5, 4)), (5, (2, 8, 3, 3)),
                                         (4, (2, 6, 3, 5)), (5, (3, 9))])
def test_lrn_matches_jax(nsize, shape):
    """nsize 3 and 5 (AlexNet's), 4 for the window's uneven padding, and
    a 2-D input."""
    rng = np.random.RandomState(nsize)
    x = rng.randn(*shape).astype(np.float32) * 2.0
    for attrs in (dict(nsize=nsize),
                  dict(nsize=nsize, alpha=0.0001, beta=0.75, knorm=1)):
        j, t = _run_both("LRN", attrs, [x])
        _check(j, t, ["data"])


# ----------------------------------------------------------------------
# the 16 arithmetic ops
# ----------------------------------------------------------------------
BINARY = ["_Plus", "_Minus", "_Mul", "_Div", "_Power", "_Maximum",
          "_Minimum"]
SCALAR = ["_PlusScalar", "_MinusScalar", "_RMinusScalar", "_MulScalar",
          "_DivScalar", "_RDivScalar", "_PowerScalar", "_RPowerScalar",
          "_MaximumScalar", "_MinimumScalar"]


def _positive(rng, *shape):
    return (0.5 + rng.rand(*shape)).astype(np.float32)


@pytest.mark.parametrize("op", BINARY)
def test_binary_op_matches_jax(op):
    """Same shapes and broadcast shapes; positive operands (``_Power``'s
    gradient takes the log of the base), with ties for max/min."""
    rng = np.random.RandomState(len(op))
    a = _positive(rng, 3, 4)
    for b in (_positive(rng, 3, 4), _positive(rng, 1, 4)):
        if op in ("_Maximum", "_Minimum"):
            b = np.where(rng.rand(*b.shape) < 0.3, a[:b.shape[0]], b)
        j, t = _run_both(op, {}, [a, b])
        _check(j, t, ["lhs", "rhs"])


@pytest.mark.parametrize("op", SCALAR)
@pytest.mark.parametrize("scalar", [0.3, 2.0, 1.7])
def test_scalar_op_matches_jax_float32(op, scalar):
    rng = np.random.RandomState(len(op))
    x = _positive(rng, 3, 5)
    j, t = _run_both(op, dict(scalar=scalar), [x])
    _check(j, t, ["data"])


def _bf16_both(op, scalar, x32, cot32):
    jop, top = jcreate(op, scalar=scalar), tcreate(op, scalar=scalar)
    jx = jnp.asarray(x32, jnp.bfloat16)
    (jo,), vjp = jax.vjp(lambda v: jop.forward([v], [], True, None)[0], jx)
    jg = vjp([jnp.asarray(cot32, jnp.bfloat16)])[0]
    tx = torch.from_numpy(x32).to(torch.bfloat16).requires_grad_()
    (to,), _ = top.forward([tx], [], True, None)
    (tg,) = torch.autograd.grad(to, tx, torch.from_numpy(cot32)
                                .to(torch.bfloat16))
    return ((np.asarray(jo.astype(jnp.float32)),
             np.asarray(jg.astype(jnp.float32))),
            (to.detach().float().numpy(), tg.float().numpy()),
            (to.dtype, tg.dtype))


@pytest.mark.parametrize("op", SCALAR)
def test_scalar_op_matches_jax_bfloat16(op):
    """The scalar is rounded to bfloat16 before the op, as
    ``jnp.asarray(scalar, x.dtype)`` rounds it: 0.3 is not a bfloat16,
    and ``s / x`` and ``s ** x`` use the rounded value."""
    rng = np.random.RandomState(7)
    x = _positive(rng, 4, 6)
    cot = rng.randn(4, 6).astype(np.float32)
    (jo, jg), (to, tg), dtypes = _bf16_both(op, 0.3, x, cot)
    assert dtypes == (torch.bfloat16, torch.bfloat16)
    _close(to, jo, BF16_TOL, op + " forward")
    _close(tg, jg, BF16_TOL, op + " gradient")
    if op == "_MulScalar":
        # the bfloat16 product uses the rounded scalar: exactly
        s16 = float(torch.tensor(0.3, dtype=torch.bfloat16))
        want = (torch.from_numpy(x).to(torch.bfloat16) * s16)
        np.testing.assert_array_equal(to, want.float().numpy())


def test_rdiv_scalar_divides():
    """``s / x`` is a division, not a multiply by the reciprocal (the
    two round differently for some x)."""
    x = np.array([3.0, 7.0, 11.0, 49.0, 0.1, 1e-3], np.float32)
    (out,), _ = tcreate("_RDivScalar", scalar=1.0).forward(
        [torch.from_numpy(x)], [], False, None)
    want = np.float32(1.0) / x
    np.testing.assert_array_equal(out.numpy(), want)


# ----------------------------------------------------------------------
# Symbol operators, maximum/minimum/pow and num_args
# ----------------------------------------------------------------------
def _build(mx, fn):
    with mx.name.NameManager():
        return fn(mx, mx.sym.Variable("a"), mx.sym.Variable("b"))


EXPRS = {
    "add": lambda mx, a, b: a + b,
    "add_scalar": lambda mx, a, b: a + 2,
    "radd_scalar": lambda mx, a, b: 2 + a,
    "sub": lambda mx, a, b: a - b,
    "sub_scalar": lambda mx, a, b: a - 0.5,
    "rsub_scalar": lambda mx, a, b: 3 - a,
    "mul": lambda mx, a, b: a * b,
    "mul_scalar": lambda mx, a, b: a * 1.5,
    "rmul_scalar": lambda mx, a, b: 1.5 * a,
    "div": lambda mx, a, b: a / b,
    "div_scalar": lambda mx, a, b: a / 4,
    "rdiv_scalar": lambda mx, a, b: 1 / a,
    "pow": lambda mx, a, b: a ** b,
    "pow_scalar": lambda mx, a, b: a ** 2,
    "neg": lambda mx, a, b: -a,
    "maximum": lambda mx, a, b: mx.sym.maximum(a, b),
    "maximum_scalar": lambda mx, a, b: mx.sym.maximum(a, 1.0),
    "rmaximum_scalar": lambda mx, a, b: mx.sym.maximum(1.0, a),
    "minimum": lambda mx, a, b: mx.sym.minimum(a, b),
    "minimum_scalar": lambda mx, a, b: mx.sym.minimum(1.0, a),
    "pow_fn": lambda mx, a, b: mx.sym.pow(a, b),
    "rpow_fn": lambda mx, a, b: mx.sym.pow(2.0, a),
    "chain": lambda mx, a, b: (2 - a * b) / (a + 1) + mx.sym.maximum(
        -a, b ** 0.5),
    "concat": lambda mx, a, b: mx.sym.Concat(a, b, a),
    "concat_dim0": lambda mx, a, b: mx.sym.Concat(a, b, dim=0),
    "ewsum": lambda mx, a, b: mx.sym.ElementWiseSum(a, b, a, b),
}


def _eval(mx, sym, a, b, ctx):
    args = {n: mx.nd.array(v, ctx=ctx) for n, v in (("a", a), ("b", b))
            if n in sym.list_arguments()}
    ex = sym.bind(ctx, args)
    return [o.asnumpy() for o in ex.forward()]


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_symbol_expression_matches_jax(name):
    js = _build(jmx, EXPRS[name])
    ts = _build(tmx, EXPRS[name])
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    assert ts.tojson() == js.tojson()
    rng = np.random.RandomState(3)
    a, b = _positive(rng, 2, 3), _positive(rng, 2, 3)
    for got, want in zip(_eval(tmx, ts, a, b, tmx.cpu()),
                         _eval(jmx, js, a, b, jmx.cpu())):
        _close(got, want, 1e-5, name)
    back = tmx.sym.load_json(js.tojson())
    for got, want in zip(_eval(tmx, back, a, b, tmx.cpu()),
                         _eval(tmx, ts, a, b, tmx.cpu())):
        np.testing.assert_array_equal(got, want)


def test_symbol_operators_refuse_two_numbers():
    with pytest.raises(tmx.MXNetError):
        tmx.sym.maximum(1.0, 2.0)


# ----------------------------------------------------------------------
# Symbol.grad
# ----------------------------------------------------------------------
def _mlp(mx):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        h = mx.sym.FullyConnected(x, num_hidden=6, name="fc1")
        h = mx.sym.Activation(h, act_type="tanh", name="act1")
        h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return mx.sym.SoftmaxOutput(h, name="softmax")


def _convnet(mx):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        h = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                               name="conv1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
        h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                           name="pool1")
        h = mx.sym.FullyConnected(mx.sym.Flatten(h), num_hidden=3,
                                  name="fc1")
        return mx.sym.SoftmaxOutput(h, name="softmax")


@pytest.mark.parametrize("builder,data_shape",
                         [(_mlp, (4, 5)), (_convnet, (2, 2, 6, 6))])
def test_symbol_grad_matches_jax(builder, data_shape):
    """The grad symbol's arguments (the base's and ``softmax_0_grad``)
    and its gradients with respect to every weight and the data."""
    jbase, tbase = builder(jmx), builder(tmx)
    wrt = [n for n in tbase.list_arguments() if n != "softmax_label"]
    jg, tg = jbase.grad(wrt), tbase.grad(wrt)
    assert tg.list_arguments() == jg.list_arguments()
    assert tg.list_outputs() == jg.list_outputs()
    assert "softmax_0_grad" in tg.list_arguments()
    rng = np.random.RandomState(5)
    arg_shapes, _, _ = tbase.infer_shape(data=data_shape)
    values = {n: rng.randn(*s).astype(np.float32) * 0.5
              for n, s in zip(tbase.list_arguments(), arg_shapes)}
    values["softmax_label"] = rng.randint(0, 3, data_shape[0]) \
        .astype(np.float32)
    values["softmax_0_grad"] = np.ones((data_shape[0], 3), np.float32)
    assert tg.infer_shape(data=data_shape)[0] == [
        tuple(s) for s in jg.infer_shape(data=data_shape)[0]]
    outs = []
    for mx, sym in ((jmx, jg), (tmx, tg)):
        args = {n: mx.nd.array(values[n], ctx=mx.cpu())
                for n in sym.list_arguments()}
        outs.append([o.asnumpy() for o in sym.bind(mx.cpu(), args)
                     .forward()])
    for got, want, name in zip(outs[1], outs[0], wrt):
        _close(got, want, 1e-4, "d/d" + name)
    # the port's gradients are autograd's through the base graph
    with tmx.cpu():
        ex = tbase.simple_bind(tmx.cpu(), data=data_shape)
    for n, a in ex.arg_dict.items():
        a[:] = values[n]
    ex.forward(is_train=True)
    ex.backward()
    for got, name in zip(outs[1], wrt):
        np.testing.assert_allclose(got, ex.grad_dict[name].asnumpy(),
                                   rtol=1e-6, atol=1e-6)


def test_grad_symbols_of_different_graphs_get_their_own_programs():
    """Two grad symbols whose JSON is the same text (the ``_Grad`` node
    names only its op) but whose base graphs differ: each binds its own
    program (the registry key holds the base graphs' fingerprints) and
    gives its own base's gradients."""
    def base(act):
        with tmx.name.NameManager():
            h = tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                       num_hidden=3, name="fc")
            if act:
                h = tmx.sym.Activation(h, act_type="tanh", name="act")
            return tmx.sym.SoftmaxOutput(h, name="softmax")
    rng = np.random.RandomState(9)
    values = {"data": rng.randn(4, 5), "fc_weight": rng.randn(3, 5),
              "fc_bias": rng.randn(3), "softmax_label": np.arange(4) % 3,
              "softmax_0_grad": np.ones((4, 3))}
    got = []
    for act in (False, True):
        b = base(act)
        with tmx.name.NameManager():
            g = b.grad(["fc_weight"])
        got.append((g, b))
    assert got[0][0].tojson() == got[1][0].tojson()
    for g, b in got:
        args = {n: tmx.nd.array(values[n].astype(np.float32),
                                ctx=tmx.cpu())
                for n in g.list_arguments()}
        (out,) = g.bind(tmx.cpu(), args).forward()
        with tmx.cpu():
            ex = b.simple_bind(tmx.cpu(), data=(4, 5))
        for n, a in ex.arg_dict.items():
            a[:] = values[n].astype(np.float32)
        ex.forward(is_train=True)
        ex.backward()
        np.testing.assert_array_equal(out.asnumpy(),
                                      ex.grad_dict["fc_weight"].asnumpy())


def test_grad_symbols_of_different_wrt_get_their_own_programs():
    """Two grad symbols over one base that differ only in ``wrt``, each
    built under its own NameManager (so their JSON is the same text),
    with arguments of equal shape: each binds its own program (the
    registry key holds each grad node's ``wrt``) and gives the gradient
    of its own argument."""
    with tmx.name.NameManager():
        h = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                                   name="fc1")
        h = tmx.sym.Activation(h, act_type="tanh", name="act1")
        h = tmx.sym.FullyConnected(h, num_hidden=3, name="fc2")
        b = tmx.sym.SoftmaxOutput(h, name="softmax")
    rng = np.random.RandomState(12)
    values = {"data": rng.randn(4, 5), "fc1_weight": rng.randn(3, 5),
              "fc1_bias": rng.randn(3), "fc2_weight": rng.randn(3, 3),
              "fc2_bias": rng.randn(3), "softmax_label": np.arange(4) % 3,
              "softmax_0_grad": np.ones((4, 3))}
    with tmx.cpu():
        ex = b.simple_bind(tmx.cpu(), data=(4, 5))
    for n, a in ex.arg_dict.items():
        a[:] = values[n].astype(np.float32)
    ex.forward(is_train=True)
    ex.backward()
    grads = []
    for w in ("fc1_bias", "fc2_bias"):
        with tmx.name.NameManager():
            grads.append(b.grad([w]))
    assert grads[0].tojson() == grads[1].tojson()
    for w, g in zip(("fc1_bias", "fc2_bias"), grads):
        args = {n: tmx.nd.array(values[n].astype(np.float32),
                                ctx=tmx.cpu())
                for n in g.list_arguments()}
        (out,) = g.bind(tmx.cpu(), args).forward()
        np.testing.assert_array_equal(out.asnumpy(),
                                      ex.grad_dict[w].asnumpy())
    assert not np.array_equal(ex.grad_dict["fc1_bias"].asnumpy(),
                              ex.grad_dict["fc2_bias"].asnumpy())


def test_grad_symbol_is_differentiable_like_jax():
    """A grad symbol bound for training is differentiated in turn (the
    JAX package's vjp is traceable; the port builds the first gradients
    with ``create_graph``): for a graph ending in a fully connected
    layer, the gradient of d(out)/d(fc1_weight) with respect to the
    data; and the same through SoftmaxOutput's backward, which both
    packages differentiate through the softmax."""
    def base(mx, loss):
        with mx.name.NameManager():
            h = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                      num_hidden=6, name="fc1")
            h = mx.sym.Activation(h, act_type="tanh", name="act1")
            h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
            return mx.sym.SoftmaxOutput(h, name="softmax") if loss else h

    def run(mx, loss):
        b = base(mx, loss)
        g = b.grad(["fc1_weight"])
        shapes = dict(zip(g.list_arguments(),
                          g.infer_shape(data=(4, 5))[0]))
        r = np.random.RandomState(14)
        args = {n: mx.nd.array(r.randn(*s).astype(np.float32) * 0.5,
                               ctx=mx.cpu()) for n, s in shapes.items()}
        if loss:
            args["softmax_label"] = mx.nd.array(
                np.arange(4, dtype=np.float32) % 3, ctx=mx.cpu())
        grads = {"data": mx.nd.zeros((4, 5), ctx=mx.cpu())}
        ex = g.bind(mx.cpu(), args, args_grad=grads,
                    grad_req={"data": "write"})
        (out,) = ex.forward(is_train=True)
        ex.backward([mx.nd.ones(out.shape, ctx=mx.cpu())])
        return out.asnumpy(), ex.grad_dict["data"].asnumpy()
    (jo, jd), (to, td) = run(jmx, False), run(tmx, False)
    _close(to, jo, 1e-5, "first gradients")
    _close(td, jd, 1e-4, "second gradients")
    assert np.abs(td).max() > 0
    (jo, jd), (to, td) = run(jmx, True), run(tmx, True)
    _close(to, jo, 1e-5, "first gradients through SoftmaxOutput")
    _close(td, jd, 1e-4, "second gradients through SoftmaxOutput")
    assert np.abs(td).max() > 0


_LOSS_HEADS = {
    "LinearRegressionOutput": ("label", (4, 3)),
    "LogisticRegressionOutput": ("label", (4, 3)),
    "MAERegressionOutput": ("label", (4, 3)),
    "SoftmaxOutput": ("label", (4,)),
    "MakeLoss": (None, None),
    "SVMOutput": ("label", (4,)),
    "IdentityAttachKLSparseReg": (None, None),
}


@pytest.mark.parametrize("head", sorted(_LOSS_HEADS))
def test_loss_head_second_derivative_matches_jax(head):
    """Each loss head at the end of FullyConnected(6), tanh,
    FullyConnected(3): the grad symbol d/d(fc1_weight), bound for
    training, then differentiated with respect to the data.  Both
    packages differentiate the head's backward through its forward (the
    JAX ``custom_vjp`` through its residuals): first gradients within
    1e-5, second within 1e-4 of the JAX package."""
    label, label_shape = _LOSS_HEADS[head]

    def run(mx):
        with mx.name.NameManager():
            h = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                      num_hidden=6, name="fc1")
            h = mx.sym.Activation(h, act_type="tanh", name="act1")
            h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
            b = getattr(mx.sym, head)(h, name="head")
        g = b.grad(["fc1_weight"])
        arg_shapes, _, aux_shapes = g.infer_shape(data=(4, 5))
        shapes = dict(zip(g.list_arguments(), arg_shapes))
        r = np.random.RandomState(15)
        vals = {n: r.randn(*s).astype(np.float32) * 0.5
                for n, s in shapes.items()}
        if label is not None:
            lab = np.arange(4, dtype=np.float32) % 3
            vals["head_label"] = (lab if len(label_shape) == 1 else
                                  r.rand(*label_shape).astype(np.float32))
        args = {n: mx.nd.array(v, ctx=mx.cpu()) for n, v in vals.items()}
        aux = [mx.nd.array(np.full(s, 0.3, np.float32), ctx=mx.cpu())
               for s in aux_shapes]
        grads = {"data": mx.nd.zeros((4, 5), ctx=mx.cpu())}
        ex = g.bind(mx.cpu(), args, args_grad=grads,
                    grad_req={"data": "write"}, aux_states=aux)
        (out,) = ex.forward(is_train=True)
        ex.backward([mx.nd.ones(out.shape, ctx=mx.cpu())])
        return out.asnumpy(), ex.grad_dict["data"].asnumpy()
    (jo, jd), (to, td) = run(jmx), run(tmx)
    _close(to, jo, 1e-5, head + " first gradients")
    _close(td, jd, 1e-4, head + " second gradients")


def test_bind_takes_group2ctx_and_shared_exec_as_jax():
    """``Symbol.bind``, ``Symbol.simple_bind`` and ``executor.simple_bind``
    take ``group2ctx`` and ``shared_exec`` as the JAX package's do:
    ``shared_exec`` is ignored, a ``group2ctx`` of None or ``{}`` binds as
    usual (the outputs the JAX package's), and a placement map raises
    naming ROADMAP item 3 (j)."""
    from mxnet_tpu_torch import executor as texec
    from mxnet_tpu_torch.base import MXNetError

    def net(mx):
        d = mx.sym.Variable("data")
        return mx.sym.FullyConnected(d, num_hidden=3, name="fc")
    rng = np.random.RandomState(0)
    vals = {"data": rng.randn(2, 4).astype(np.float32),
            "fc_weight": rng.randn(3, 4).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}
    jex = net(jmx).bind(jmx.cpu(), {k: jmx.nd.array(v)
                                    for k, v in vals.items()},
                        group2ctx=None, shared_exec=None)
    want = jex.forward()[0].asnumpy()
    with tmx.cpu():
        tsym = net(tmx)
        first = tsym.simple_bind(tmx.cpu(), data=(2, 4))
        for g2c in (None, {}):
            ex = tsym.bind(tmx.cpu(), {k: tmx.nd.array(v)
                                       for k, v in vals.items()},
                           group2ctx=g2c, shared_exec=first)
            np.testing.assert_allclose(ex.forward()[0].asnumpy(), want,
                                       rtol=1e-6, atol=1e-6)
        for bind in (lambda **kw: tsym.simple_bind(tmx.cpu(), data=(2, 4),
                                                   **kw),
                     lambda **kw: texec.simple_bind(tsym, tmx.cpu(),
                                                    data=(2, 4), **kw)):
            ex = bind(group2ctx=None, shared_exec=first)
            assert tuple(ex.arg_dict["fc_weight"].shape) == (3, 4)
            with pytest.raises(MXNetError, match=r"3 \(j\)"):
                bind(group2ctx={"dev1": tmx.cpu()})
        with pytest.raises(MXNetError, match=r"3 \(j\)"):
            tsym.bind(tmx.cpu(), {k: tmx.nd.array(v)
                                  for k, v in vals.items()},
                      group2ctx={"dev1": tmx.cpu(), "dev2": tmx.cpu(1)})
