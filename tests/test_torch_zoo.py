"""The port's model zoo against the JAX package, on the CPU.

AlexNet, VGG, GoogLeNet, Inception-BN and Inception-v3 of
``mxnet_tpu_torch.models``: the same JSON, argument, aux and output
names and inferred shapes as ``mxnet_tpu.models`` at the published input
sizes; then, at batch 2 and 10 classes, on the smallest input each
network takes (found by shape inference: every op's output has a
positive size, and every pooling window fits its padded input), one
forward and the gradient of every parameter and of the data from the
same seeded numpy weights, ones as head gradients
(``executor.build_program`` against the JAX package's
``_build_program``).  VGG 11 stands for VGG.  AlexNet and VGG run in
inference mode (their Dropout draws from each package's own generator);
the others in training mode, BatchNorm aux updates included.

AlexNet, VGG and GoogLeNet run in float32.  Inception-BN and
Inception-v3 run in float64: at their smallest inputs the last
BatchNorms normalise 2 values a channel (batch 2, 1 x 1), where
``(x - mean) / sqrt(var + eps)`` amplifies a float32 rounding
difference layer after layer, in both packages alike, far past these
tolerances.  Inception-BN runs at 32 x 32, not at its smallest 13 x 13:
there twenty BatchNorms see 2 values a channel, and even float64
rounding grows past the gradients' tolerance.

Tolerances: the softmax outputs and aux updates within 1e-5, each
gradient within 1e-4 of its max-abs (sums in another order).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.executor import _build_program as j_build_program

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.executor import build_program as t_build_program

CLASSES = 10
B = 2

#: (name, builder arguments, published input, smallest input, the
#: input and dtype of the forward and gradients)
NETS = [
    ("alexnet", {}, 224, 67, 67, np.float32),
    ("vgg", {"num_layers": 11}, 224, 32, 32, np.float32),
    ("googlenet", {}, 224, 61, 61, np.float32),
    ("inception_bn", {}, 224, 13, 32, np.float64),
    ("inception_v3", {}, 299, 75, 75, np.float64),
]
DROPOUT_NETS = ("alexnet", "vgg")


def _symbols(name, kwargs, classes=CLASSES):
    out = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            out.append(getattr(mx.models, "get_" + name)(classes, **kwargs))
    return tuple(out)


def _op_shapes(sym, data_shape):
    """Every op output's shape, inferred op by op in graph order.  A
    pooling window larger than its padded input raises (shape inference
    alone would give such a pooling one output)."""
    shapes, out = {}, []
    for node in sym._topo():
        if node.is_variable:
            if node.name == "data":
                shapes[(id(node), 0)] = data_shape
            elif node.name == "softmax_label":
                shapes[(id(node), 0)] = (data_shape[0],)
            continue
        ins = [shapes.get((id(c), ci)) for c, ci in node.inputs]
        p = node.op.param
        if node.op.op_name == "Pooling" and not p.global_pool:
            pad = p.pad or (0,) * len(p.kernel)
            if any(i + 2 * q < k for i, q, k in zip(ins[0][2:], pad,
                                                    p.kernel)):
                raise ValueError("%s: window %s over %s"
                                 % (node.name, p.kernel, ins[0]))
        full, outs, _aux = node.op.infer_shape(ins)
        for (c, ci), s in zip(node.inputs, full):
            shapes[(id(c), ci)] = tuple(s)
        for i, s in enumerate(outs):
            shapes[(id(node), i)] = tuple(s)
            out.append(tuple(s))
    return out


def smallest_input(sym, start=4, stop=400):
    """The smallest square input size whose every op output is positive
    and whose every pooling window fits."""
    for size in range(start, stop):
        try:
            shapes = _op_shapes(sym, (B, 3, size, size))
        except Exception:   # noqa: BLE001 (a negative size raises)
            continue
        if all(d > 0 for s in shapes for d in s):
            return size
    raise AssertionError("no input size up to %d" % stop)


@pytest.mark.parametrize("name,kwargs,size", [
    ("alexnet", {}, 224), ("vgg", {"num_layers": 11}, 224),
    ("vgg", {"num_layers": 16}, 224), ("vgg", {"num_layers": 19}, 224),
    ("vgg", {"num_layers": 13, "batch_norm": True}, 224),
    ("googlenet", {}, 224), ("inception_bn", {}, 224),
    ("inception_v3", {}, 299)])
def test_zoo_symbols_match_jax(name, kwargs, size):
    """The same JSON (so the same names, parameter for parameter) and the
    same inferred shapes at the published input, 1000 classes; each
    package loads the other's JSON."""
    js, ts = _symbols(name, kwargs, 1000)
    assert ts.tojson() == js.tojson()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    shape = (B, 3, size, size)
    got = ts.infer_shape(data=shape)
    assert got[1] == [(B, 1000)]
    assert got == tuple([list(map(tuple, x)) for x in js.infer_shape(
        data=shape)])
    assert tmx.sym.load_json(js.tojson()).tojson() == js.tojson()
    assert json.loads(jmx.sym.load_json(ts.tojson()).tojson()) \
        == json.loads(ts.tojson())


def test_zoo_get_aliases_and_unported():
    assert tmx.models.get_inception_bn is tmx.models.inception_bn.get_symbol
    for name in ("get_alexnet", "get_vgg", "get_googlenet",
                 "get_inception_v3", "get_resnet", "get_mlp", "get_lenet"):
        assert callable(getattr(tmx.models, name))
    # the recurrent models resolve (ported with the bucketing LSTM), and
    # transformer_moe builds the JAX package's graph (ported with expert
    # parallelism)
    assert tmx.models.lstm.lstm_unroll is not None
    assert callable(tmx.models.gru.gru_unroll)
    assert callable(tmx.models.rnn.rnn_unroll)
    kw = dict(vocab_size=32, num_layers=2, num_heads=2, dim=16, seq_len=8,
              num_experts=4)
    tsym = tmx.models.transformer_moe.get_symbol(**kw)
    jsym = jmx.models.transformer_moe.get_symbol(**kw)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert "layer0_moe_expert_fc1_weight" in tsym.list_arguments()
    with pytest.raises(ValueError, match="num_experts >= 2"):
        tmx.models.transformer_moe.get_symbol(num_experts=1)
    with pytest.raises(tmx.base.MXNetError):
        tmx.models.vgg.get_symbol(10, 12)


@pytest.mark.parametrize("name,kwargs,_published,size,_parity,_dtype",
                         NETS)
def test_zoo_smallest_input(name, kwargs, _published, size, _parity, _dtype):
    """Shape inference finds the smallest input stated in ``NETS`` (one
    pixel less leaves an op with no output or a pooling window that does
    not fit)."""
    _js, ts = _symbols(name, kwargs)
    assert smallest_input(ts) == size
    assert _op_shapes(ts, (B, 3, size, size))[-1] == (B, CLASSES)


def seeded(sym, size, seed=0):
    """He-scaled convolutions and classifiers, BatchNorm gamma 1 +
    N(0, 0.1), betas and biases N(0, 0.1), moving means N(0, 0.1) and
    variances 1 + |N(0, 0.1)|, images N(0, 1)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(B, 3, size, size))
    params, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith(("_beta", "_bias")):
            v = 0.1 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        params[name] = v.astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        v = 0.1 * rng.randn(*shape)
        if name.endswith("moving_var"):
            v = 1.0 + np.abs(v)
        aux[name] = v.astype(np.float32)
    data = {"data": rng.randn(B, 3, size, size).astype(np.float32),
            "softmax_label": rng.randint(0, CLASSES, B).astype(np.float32)}
    return params, aux, data


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol, "%s: max err %g > %g" % (what, err, tol)


@pytest.mark.parametrize("name,kwargs,_published,_smallest,size,dtype",
                         NETS)
def test_zoo_forward_and_gradients_match_jax(name, kwargs, _published,
                                             _smallest, size, dtype):
    js, ts = _symbols(name, kwargs)
    params, aux, data = (
        {k: v.astype(dtype) for k, v in d.items()}
        for d in seeded(ts, size))
    is_train = name not in DROPOUT_NETS
    wrt = dict(params, data=data["data"])
    jtrace = j_build_program(js, {}).trace
    ttrace = t_build_program(ts).trace

    def jf(p):
        args = dict({k: jnp.asarray(v) for k, v in data.items()}, **p)
        return jtrace(args, {k: jnp.asarray(v) for k, v in aux.items()},
                      jax.random.PRNGKey(0), is_train)

    (jo, ja), vjp = jax.vjp(jax.jit(jf), {k: jnp.asarray(v)
                                          for k, v in wrt.items()})
    jg = vjp(([jnp.ones_like(o) for o in jo],
              {k: jnp.zeros_like(v) for k, v in ja.items()}))[0]

    leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in wrt.items()}
    args = dict({k: torch.from_numpy(v) for k, v in data.items()}, **leaves)
    to, ta = ttrace(args, {k: torch.from_numpy(v) for k, v in aux.items()},
                    None, is_train)
    names = list(leaves)
    tg = torch.autograd.grad(to, [leaves[n] for n in names],
                             [torch.ones_like(o) for o in to],
                             allow_unused=True)
    assert to[0].shape == (B, CLASSES)
    _close(to[0].detach().numpy(), jo[0], 1e-5, name + " softmax outputs")
    for n in aux:
        _close(ta[n].numpy(), ja[n], 1e-5, "aux " + n)
    for n, g in zip(names, tg):
        want = np.asarray(jg[n])
        got = np.zeros_like(want) if g is None else g.numpy()
        scale = max(1.0, float(np.abs(want).max()))
        _close(got, want, 1e-4 * scale, "%s grad %s" % (name, n))
