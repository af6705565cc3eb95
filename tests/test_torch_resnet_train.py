"""ResNet through the port's training path against the JAX package, on
the CPU.

ResNet-18 at (3, 16, 16) (the cifar stem), 10 classes, batch 4, from
seeded numpy weights, aux and data in float32: the graph's forward and
gradients (``executor.build_program`` against the JAX package's
``_build_program``, ones as head gradients), then two
``parallel.ShardedTrainer`` steps (SGD lr 0.1, momentum 0.9, wd 1e-4,
rescale_grad 1/4, as ``bench.py`` trains ResNet-50) with the fused sweep
off and in mode ``'1'`` on both sides.

Tolerances: outputs, parameters, momentum and aux within 1e-5 after
each step of the JAX package's steps run in float64 from the same
float32 inputs (x64 is on in the tests), and after the first step within
1e-5 of its float32 step (the test says why not the second); gradients
within 1e-4 of each tensor's max-abs (float32 sums in another order;
BatchNorm over 16 values a channel in the last stage amplifies them).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.executor import _build_program as j_build_program
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import build_program as t_build_program
from mxnet_tpu_torch.model import params_from_numpy
from mxnet_tpu_torch.parallel import ShardedTrainer as TTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SHAPE, CLASSES = 4, (3, 16, 16), 10
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4, rescale_grad=1.0 / B)
TOL = 1e-5


def _symbols(num_layers=18, image_shape=SHAPE, classes=CLASSES):
    """Both packages' ResNet, each built under a fresh NameManager, so
    the automatic names (``_plus0``, ``pooling0``) do not depend on the
    symbols earlier tests of the process built."""
    out = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            out.append(mx.models.resnet.get_symbol(classes, num_layers,
                                                   image_shape))
    return tuple(out)


def seeded_resnet(sym, seed=0, batch=B, image_shape=SHAPE):
    """Weights, aux and a batch for ``sym`` from numpy: He-scaled
    convolutions, N(0, 0.01) classifier, BatchNorm gamma 1 + N(0, 0.1),
    beta and moving means N(0, 0.1), moving variances 1 + |N(0, 0.1)|."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(batch,) + image_shape)
    params, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith(("_beta", "_bias")):
            v = 0.1 * rng.randn(*shape)
        elif name == "fc1_weight":
            v = 0.01 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        params[name] = v.astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        v = 0.1 * rng.randn(*shape)
        if name.endswith("moving_var"):
            v = 1.0 + np.abs(v)
        aux[name] = v.astype(np.float32)
    data = {"data": rng.randn(batch, *image_shape).astype(np.float32),
            "softmax_label": rng.randint(0, CLASSES, batch)
            .astype(np.float32)}
    return params, aux, data


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol, "%s: max err %g > %g" % (what, err, tol)


def test_resnet_symbols_match_jax():
    """Same arguments, aux names, shapes and outputs as the JAX package's
    ResNets (18 at the cifar stem, 50 at 224 x 224); each package loads
    the other's JSON."""
    for layers, image_shape in ((18, SHAPE), (50, (3, 224, 224))):
        js, ts = _symbols(layers, image_shape, 1000)
        assert ts.list_arguments() == js.list_arguments()
        assert ts.list_auxiliary_states() == js.list_auxiliary_states()
        assert ts.list_outputs() == js.list_outputs()
        shapes = dict(data=(2,) + image_shape)
        assert ts.infer_shape(**shapes) == tuple(
            [list(map(tuple, x)) for x in js.infer_shape(**shapes)])
        back = tmx.sym.load_json(js.tojson())
        assert back.list_arguments() == js.list_arguments()
        assert json.loads(jmx.sym.load_json(ts.tojson()).tojson()) \
            == json.loads(js.tojson())
    with pytest.raises(MXNetError):
        tmx.models.resnet.get_symbol(10, 19, SHAPE)


def test_resnet18_forward_and_gradients_match_jax():
    """One training-mode forward (outputs and BatchNorm aux updates) and
    the gradient of every parameter, ones as head gradients."""
    js, ts = _symbols()
    params, aux, data = seeded_resnet(ts)
    jtrace = j_build_program(js, {}).trace
    ttrace = t_build_program(ts).trace

    def jf(p):
        args = dict({k: jnp.asarray(v) for k, v in data.items()}, **p)
        return jtrace(args, {k: jnp.asarray(v) for k, v in aux.items()},
                      jax.random.PRNGKey(0), True)

    (jo, ja), vjp = jax.vjp(jax.jit(jf), {k: jnp.asarray(v)
                                          for k, v in params.items()})
    jg = vjp(([jnp.ones_like(o) for o in jo],
              {k: jnp.zeros_like(v) for k, v in ja.items()}))[0]

    leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in params.items()}
    args = dict({k: torch.from_numpy(v) for k, v in data.items()}, **leaves)
    to, ta = ttrace(args, {k: torch.from_numpy(v) for k, v in aux.items()},
                    None, True)
    names = list(leaves)
    tg = torch.autograd.grad(to, [leaves[n] for n in names],
                             [torch.ones_like(o) for o in to],
                             allow_unused=True)
    _close(to[0].detach().numpy(), jo[0], TOL, "softmax outputs")
    for n in aux:
        _close(ta[n].numpy(), ja[n], TOL, "aux " + n)
    for n, g in zip(names, tg):
        want = np.asarray(jg[n])
        got = np.zeros_like(want) if g is None else g.numpy()
        if n == "bn_data_gamma":       # fix_gamma: exactly zero
            assert not got.any() and not want.any()
        scale = max(1.0, float(np.abs(want).max()))
        _close(got, want, 1e-4 * scale, "grad " + n)


def _jax_steps(js, params, aux, batches, dtype):
    """One step of the JAX package's ShardedTrainer (leafwise, on a
    one-device mesh) a batch of ``batches``, every array in ``dtype``:
    [(outputs, params, momentum, aux)] after each step, as float64
    numpy."""
    jtr = JTrainer(js, jmx.optimizer.create("sgd", **SGD),
                   jmake_mesh(jax.devices()[:1], dp=1))
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    jm = {k: jnp.zeros_like(v) for k, v in jp.items()}
    ja = {k: jnp.asarray(v, dtype) for k, v in aux.items()}
    out = []
    for batch in batches:
        jb = {k: jnp.asarray(v, dtype) for k, v in batch.items()}
        jp, jm, ja, jo = jtr.step(jp, jm, ja, jb)
        out.append(tuple({k: np.asarray(v, np.float64) for k, v in d.items()}
                         for d in ({"out": jo[0]}, jp, jm, ja)))
    return out


_JAX_REFERENCE = {}


def jax_reference(key, js, params, aux, batches, dtype):
    """:func:`_jax_steps`, computed once a test session for ``key``: the
    JAX steps do not depend on the port's settings a test varies."""
    if key not in _JAX_REFERENCE:
        _JAX_REFERENCE[key] = _jax_steps(js, params, aux, batches, dtype)
    return _JAX_REFERENCE[key]


@pytest.mark.parametrize("mode", ["", "1"])
def test_resnet18_sharded_trainer_matches_jax(monkeypatch, mode):
    """Two steps of both packages' ShardedTrainer from the same numpy
    weights, aux and batch: outputs, parameters, momentum and aux after
    each step within 1e-5 of the JAX package's steps run in float64, and
    after the first step within 1e-5 of its float32 step.  (The JAX
    package's own float32 steps drift 6e-5 from float64 at the second
    step, in conv0 and the first BatchNorm betas: BatchNorm is invariant
    to a per-channel shift, so those directions' true gradients nearly
    cancel and the vjp through jnp.mean/jnp.var keeps more rounding
    there than the fused BatchNorm backward; the port stays within 2e-7
    of float64.)  The JAX steps are leafwise: its mode '1' is bitwise
    the same, and the JAX trainer built here shows it takes the same
    route as the port's."""
    monkeypatch.setenv("MXTPU_FUSED_OPT", mode)
    js, ts = _symbols()
    params, aux, data = seeded_resnet(ts)
    want64 = jax_reference("trainer64", js, params, aux, [data, data],
                           np.float64)
    want32 = jax_reference("trainer32", js, params, aux, [data],
                           np.float32)
    jtr = JTrainer(js, jmx.optimizer.create("sgd", **SGD),
                   jmake_mesh(jax.devices()[:1], dp=1))
    ttr = TTrainer(ts, tmx.optimizer.create("sgd", **SGD), ctx=tmx.cpu())
    assert jtr._fused_opt == ttr._fused_opt == mode
    assert ttr.param_names == list(jtr.param_names)
    tp, ta = params_from_numpy(params, aux, ctx=tmx.cpu())
    tm = {k: torch.zeros_like(v) for k, v in tp.items()}
    tb = ttr.shard_batch(data)
    for step in (1, 2):
        tp, tm, ta, to = ttr.step(tp, tm, ta, tb)
        got = ({"out": to[0]}, tp, tm, ta)
        wants = [("float64", want64[step - 1])]
        if step == 1:
            wants.append(("float32", want32[0]))
        for ref, want in wants:
            for part, g, w in zip(("outputs", "param", "momentum", "aux"),
                                  got, want):
                assert set(g) == set(w)
                for n in w:
                    _close(g[n].numpy(), w[n], TOL, "step %d %s %s vs JAX "
                           "%s" % (step, part, n, ref))
    # fix_gamma: the data BatchNorm's gamma moves by weight decay alone
    g0 = params["bn_data_gamma"].astype(np.float64)
    assert np.all(np.abs(tp["bn_data_gamma"].numpy()) < np.abs(g0))


def _conv_bn_net(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.Convolution(data=data, num_filter=4, kernel=(3, 3),
                           no_bias=True, name="conv")
    h = mx.sym.BatchNorm(data=h, fix_gamma=False, name="bn")
    h = mx.sym.Pooling(data=h, kernel=(2, 2), global_pool=True,
                       pool_type="avg")
    h = mx.sym.FullyConnected(data=mx.sym.Flatten(data=h), num_hidden=3,
                              name="fc")
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def test_init_params_fills_aux_as_jax():
    """``init_params``: moving_var ones, every other aux zeros, in
    float32, and the shapes the JAX trainer allocates (a convolution,
    BatchNorm, pooling and classifier graph)."""
    jtr = JTrainer(_conv_bn_net(jmx), jmx.optimizer.create("sgd", **SGD),
                   jmake_mesh(jax.devices()[:1], dp=1))
    ttr = TTrainer(_conv_bn_net(tmx), tmx.optimizer.create("sgd", **SGD),
                   ctx=tmx.cpu())
    shapes = dict(data_shapes={"data": (B, 3, 6, 6)},
                  label_shapes={"softmax_label": (B,)})
    jp, _, ja = jtr.init_params(**shapes)
    tp, tst, ta = ttr.init_params(**shapes)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert set(ta) == set(ja) == {"bn_moving_mean", "bn_moving_var"}
    for n, v in ta.items():
        assert v.dtype == torch.float32
        want = np.ones if n.endswith("moving_var") else np.zeros
        assert np.array_equal(v.numpy(), want(v.shape, np.float32)), n
        assert np.array_equal(np.asarray(ja[n]), v.numpy()), n
    assert set(tst) == set(tp)


def test_resnet18_bfloat16_step_keeps_aux_float32():
    """A bfloat16 compute step: aux computed in bfloat16 and stored back
    in float32 (as the JAX step casts them), parameters float32 and
    finite, softmax outputs within 5e-2 of the float32 step's."""
    _, ts = _symbols()
    params, aux, data = seeded_resnet(ts)
    outs = {}
    for cdt in (None, "bfloat16"):
        tr = TTrainer(ts, tmx.optimizer.create("sgd", **SGD), ctx=tmx.cpu(),
                      compute_dtype=cdt)
        tp, ta = params_from_numpy(params, aux, ctx=tmx.cpu())
        st = {k: torch.zeros_like(v) for k, v in tp.items()}
        tp, st, ta, o = tr.step(tp, st, ta, tr.shard_batch(data))
        assert all(v.dtype == torch.float32 for v in ta.values())
        assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                   for v in tp.values())
        outs[cdt] = o[0].float()
    assert outs["bfloat16"].dtype == torch.float32
    assert float((outs["bfloat16"] - outs[None]).abs().max()) < 5e-2


def test_mirror_blocks_tags_and_is_refused():
    """``mirror_blocks=True`` tags each unit's ops (``mirror_scope``); the
    port's executor refuses the graph (recompute is not ported), and
    ``mirror_scope(..., enabled=False)`` tags nothing."""
    from mxnet_tpu_torch.attribute import mirror_scope
    sym = tmx.models.resnet.get_symbol(CLASSES, 18, SHAPE,
                                       mirror_blocks=True)
    tagged = [n for n in sym._topo() if n.attrs.get("mirror_stage")]
    assert tagged and all(n.attrs["force_mirroring"] == "true"
                          for n in tagged)
    with pytest.raises(MXNetError, match="mirrored"):
        t_build_program(sym)
    with mirror_scope("stage", enabled=False):
        v = tmx.sym.Variable("x")
    assert not v._heads[0][0].attrs


def test_port_imports_without_jax():
    """Every module of the image-classification slice imports with JAX
    unavailable, and no module of the port imports jax or mxnet_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import mxnet_tpu_torch as mx\n"
        "import mxnet_tpu_torch.models.resnet, mxnet_tpu_torch.lr_scheduler\n"
        "import mxnet_tpu_torch.metric, mxnet_tpu_torch.callback\n"
        "import mxnet_tpu_torch.io, mxnet_tpu_torch.kvstore\n"
        "import mxnet_tpu_torch.model, mxnet_tpu_torch.module\n"
        "mx.models.resnet; mx.mod.Module; mx.io.NDArrayIter\n"
        "mx.kvstore.create; mx.lr_scheduler; mx.metric; mx.callback\n"
        "bad = [m for m in sys.modules if m == 'mxnet_tpu' or "
        "m.startswith('mxnet_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
