"""Every optimizer and learning-rate scheduler of the port against the JAX
package, on the CPU.

The same numpy weights, gradients and optimizer state (float32, from a
seed) go through ``mxnet_tpu.optimizer`` and ``mxnet_tpu_torch.optimizer``:
the pure ``update_fn`` (after ``_preprocess_grad``, rescale 0.5 and clip
1.0) for 3 steps, and the imperative ``update(index, weight, grad,
state)`` of the kvstore path for 3 steps with an lr scheduler, lr/wd
multipliers and ``idx2name``.  SGLD runs with its noise set to zero on
both sides (the two packages draw different numbers); LAMB (per-tensor
norms) runs leafwise.  Then, in the port alone: the fused sweep's plain
version equal bit for bit to the leafwise update for every elementwise
optimizer, and ``sweep_body`` for every optimizer.

Tolerance: 2e-6 of the larger of 1 and each tensor's max-abs (XLA on the
CPU may fuse a product and a sum, or divide in another order; PyTorch
rounds each operator).
"""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt_mod

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt_mod
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import fused_opt as tfo

TOL = 2e-6

#: (name, constructor arguments) of every optimizer of the JAX package
OPTIMIZERS = [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("nag", {}), ("nag", {"momentum": 0.9}),
    ("ccsgd", {"momentum": 0.9}),
    ("sgld", {}),
    ("adam", {}), ("adamw", {}),
    ("adagrad", {}), ("rmsprop", {}), ("rmsprop", {"gamma1": 0.9,
                                                   "gamma2": 0.8}),
    ("adadelta", {}), ("adadelta", {"rho": 0.5, "epsilon": 1e-3}),
    ("lamb", {}), ("test", {}),
]
ELEMENTWISE = {"sgd", "nag", "ccsgd", "adam", "adamw", "adagrad",
               "rmsprop", "adadelta", "test"}
SHAPES = [(7, 5), (33,)]


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def _n_state(opt):
    proto = opt.create_state_arrays((1,))
    if proto is None:
        return 0
    return len(proto) if isinstance(proto, tuple) else 1


def _states(rng, name, n_state, shape):
    """State leaves of the sizes each formula keeps: running variances,
    histories and accumulators positive, RMSProp's n >= g^2."""
    s = [(rng.randn(*shape) * 0.1).astype(np.float32) for _ in range(n_state)]
    positive = {"adam": [1], "adamw": [1], "lamb": [1], "adagrad": [0],
                "adadelta": [0, 1], "rmsprop": [0]}.get(name, [])
    for i in positive:
        s[i] = np.abs(s[i])
    if name == "rmsprop":
        s[0] = (s[1] * s[1] + s[0]).astype(np.float32)
    return s


def _pack(state, n_state, to):
    if n_state == 0:
        return None
    leaves = [to(a) for a in state]
    return leaves[0] if n_state == 1 else tuple(leaves)


def _unpack(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return list(state)
    return [state]


def _no_noise(monkeypatch):
    """SGLD's noise set to zero in both packages."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.zeros(shape, dtype))
    monkeypatch.setattr(topt_mod.SGLD, "noise",
                        lambda self, w: torch.zeros_like(w))


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_update_fn_matches_jax(monkeypatch, name, kw):
    """Three steps of ``_preprocess_grad`` + ``update_fn`` on each shape,
    from the same numpy weights, gradients and state."""
    _no_noise(monkeypatch)
    common = dict(rescale_grad=0.5, clip_gradient=1.0, wd=0.01, **kw)
    jo = jopt_mod.create(name, **common)
    to = topt_mod.create(name, **common)
    assert to.elementwise == jo.elementwise == (name in ELEMENTWISE)
    n_state = _n_state(to)
    rng = np.random.RandomState(0)
    for shape in SHAPES:
        w = rng.randn(*shape).astype(np.float32)
        state = _states(rng, name, n_state, shape)
        jw, js = jnp.asarray(w), _pack(state, n_state, jnp.asarray)
        tw, ts = torch.from_numpy(w.copy()), _pack(state, n_state,
                                                   torch.from_numpy)
        for t in (1, 2, 3):
            g = (rng.randn(*shape) * 2).astype(np.float32)
            if name == "sgld":     # its formula lives in its jitted step
                jo._noise_key = jax.random.PRNGKey(t)
                jw, js = jo._jitted()(jw, jnp.asarray(g), js,
                                      jnp.float32(0.05), jnp.float32(0.01),
                                      jnp.int32(t))
            else:
                jw, js = jo.update_fn(jw, jo._preprocess_grad(jnp.asarray(g)),
                                      js, jnp.float32(0.05),
                                      jnp.float32(0.01), jnp.int32(t))
            tw, ts = to._step(tw, torch.from_numpy(g), ts, 0.05, 0.01, t)
            _close(tw.numpy(), jw, "%s step %d weight" % (name, t))
            for a, b in zip(_unpack(ts), _unpack(js)):
                _close(a.numpy(), b, "%s step %d state" % (name, t))


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_imperative_update_matches_jax(monkeypatch, name, kw):
    """``get_updater`` + ``update(index, weight, grad, state)`` (the
    kvstore path) for 3 steps: a FactorScheduler, ``lr_mult``/``wd_mult``
    by name through ``idx2name``, per-index update counts (Adam's t)."""
    _no_noise(monkeypatch)
    idx2name = {0: "fc_weight", 1: "fc_bias"}
    common = dict(rescale_grad=0.25, wd=0.02, param_idx2name=idx2name,
                  learning_rate=0.1, **kw)
    jo = jopt_mod.create(name, lr_scheduler=jsched.FactorScheduler(2, 0.5),
                         **common)
    to = topt_mod.create(name, lr_scheduler=tsched.FactorScheduler(2, 0.5),
                         **common)
    for o in (jo, to):
        o.set_lr_mult({"fc_bias": 2.0})
        o.set_wd_mult({})
    assert to.wd_mult == jo.wd_mult == {"fc_bias": 0.0}
    jup, tup = jopt_mod.get_updater(jo), topt_mod.get_updater(to)
    rng = np.random.RandomState(1)
    ws = {0: rng.randn(6, 4).astype(np.float32),
          1: rng.randn(6).astype(np.float32)}
    jw = {k: jmx.nd.array(v) for k, v in ws.items()}
    tw = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in ws.items()}
    for step in range(3):
        for k in (0, 1):
            g = rng.randn(*ws[k].shape).astype(np.float32)
            jup(k, jmx.nd.array(g), jw[k])
            tup(k, tmx.nd.array(g, ctx=tmx.cpu()), tw[k])
            _close(tw[k].asnumpy(), jw[k].asnumpy(),
                   "%s step %d key %d" % (name, step, k))
    assert to.num_update == jo.num_update == (0 if name == "test" else 3)
    for k in (0, 1):
        for a, b in zip(_unpack(tup.states[k]), _unpack(jup.states[k])):
            _close(a.asnumpy(), b.asnumpy(), "%s state %d" % (name, k))


@pytest.mark.parametrize("name,kw", [o for o in OPTIMIZERS
                                     if o[0] in ELEMENTWISE])
def test_sweep_reference_bitwise_equals_leafwise(name, kw):
    """The fused sweep's plain version over concatenated buckets (mode
    '1', preprocessing folded in) == the leafwise update, bit for bit,
    for every elementwise optimizer, with each leaf's state structure
    rebuilt; and ``sweep_body`` has a CUDA body for each."""
    opt = topt_mod.create(name, rescale_grad=0.5, clip_gradient=1.0, **kw)
    assert isinstance(tfo.sweep_body(opt), int)
    n_state = _n_state(opt)
    rng = np.random.RandomState(2)
    shapes = {"a": (40, 3), "b": (7,), "c": (5, 2, 2)}
    params = {n: torch.from_numpy(rng.randn(*s).astype(np.float32))
              for n, s in shapes.items()}
    grads = {n: torch.from_numpy(rng.randn(*s).astype(np.float32))
             for n, s in shapes.items()}
    states = {n: _pack(_states(rng, name, n_state, s), n_state,
                       torch.from_numpy) for n, s in shapes.items()}
    fw, fs = tfo.fused_apply(opt, params, grads, states, 0.05, 0.01, 3,
                             nbytes=256, mode="1", preprocess=True)
    for n in shapes:
        lw, ls = opt._step(params[n], grads[n], states[n], 0.05, 0.01, 3)
        assert torch.equal(fw[n], lw), n
        for a, b in zip(_unpack(fs[n]), _unpack(ls)):
            assert torch.equal(a, b), n


def test_sweep_body_codes_and_the_missing_piece():
    """A body for SGD (with and without momentum), NAG, ccSGD (SGD's),
    Adam, AdamW, AdaGrad, RMSProp, AdaDelta and Test; a subclass with its
    own update_fn gets the generated body; one whose _preprocess_grad
    leaves the generator's IR (tanh) raises, naming itself and the op;
    LAMB and SGLD are not elementwise, so the trainer stays leafwise with
    them."""
    want = {("sgd", 0.0): 0, ("sgd", 0.9): 1, ("adam", None): 2,
            ("nag", 0.9): 3, ("nag", 0.0): 0, ("ccsgd", 0.9): 1,
            ("adamw", None): 4, ("adagrad", None): 5, ("rmsprop", None): 6,
            ("adadelta", None): 7, ("test", None): 8}
    for (name, mom), code in want.items():
        kw = {} if mom is None else {"momentum": mom}
        assert tfo.sweep_body(topt_mod.create(name, **kw)) == code

    class MySGD(topt_mod.SGD):
        def update_fn(self, weight, grad, state, lr, wd, t):
            return weight - lr * grad, state

    class Clipped(topt_mod.Adam):
        def _preprocess_grad(self, grad):
            return torch.tanh(grad)

    class Same(topt_mod.AdamW):
        pass

    assert tfo.sweep_body(MySGD(momentum=0.9)) == tfo.GENERATED
    with pytest.raises(MXNetError, match="Clipped.*torch.tanh"):
        tfo.sweep_body(Clipped())
    assert tfo.sweep_body(Same()) == 4
    for name in ("lamb", "sgld"):
        opt = topt_mod.create(name)
        assert not tfo.supports_fused(opt)
        tr = tmx.parallel.ShardedTrainer(
            tmx.models.mlp.get_symbol(num_classes=3), opt, ctx=tmx.cpu())
        assert tr._fused_opt == ""


def test_rmsprop_states_are_separate_tensors():
    """The fused sweep writes state leaves in place: no two may share
    storage (the JAX package returns one zeros array three times)."""
    n, g, d = topt_mod.create("rmsprop").create_state_arrays((4,))
    ptrs = {t.untyped_storage().data_ptr() for t in (n, g, d)}
    assert len(ptrs) == 3


def test_sgld_noise_is_seeded_and_pickles():
    """SGLD draws N(0, 1) * sqrt(lr) from its own seeded CPU generator:
    the same seed gives the same trajectory, and a pickled copy (as the
    kvstore's set_optimizer makes) continues the same stream."""
    w0 = torch.zeros(1000)
    a, b = topt_mod.create("sgld", seed=3), topt_mod.create("sgld", seed=3)
    g = torch.zeros(1000)
    wa, _ = a._step(w0, g, None, 0.04, 0.0, 1)
    wb, _ = b._step(w0, g, None, 0.04, 0.0, 1)
    assert torch.equal(wa, wb)
    assert abs(float(wa.std()) - 0.2) < 0.02
    c = pickle.loads(pickle.dumps(a))
    assert torch.equal(a._step(w0, g, None, 0.04, 0.0, 2)[0],
                       c._step(w0, g, None, 0.04, 0.0, 2)[0])


def _schedulers(mod):
    return [
        mod.FactorScheduler(step=3, factor=0.5, stop_factor_lr=0.01),
        mod.MultiFactorScheduler(step=[2, 5, 9], factor=0.3),
        mod.PolyScheduler(max_update=12, power=2.0, base_lr=0.5,
                          final_lr=0.01),
        mod.CosineScheduler(max_update=10, base_lr=0.2, final_lr=0.0),
        mod.WarmupScheduler(4, mod.FactorScheduler(step=2, factor=0.9),
                            begin_lr=0.001),
        mod.WarmupScheduler(3, mod.CosineScheduler(max_update=8,
                                                   base_lr=0.3)),
    ]


def test_lr_schedulers_match_jax():
    """The six schedulers give the JAX package's learning rates over
    updates 0 to 20, base_lr set through an optimizer as Module does."""
    for js, ts in zip(_schedulers(jsched), _schedulers(tsched)):
        assert type(js).__name__ == type(ts).__name__
        jo = jopt_mod.create("sgd", learning_rate=0.4, lr_scheduler=js)
        to = topt_mod.create("sgd", learning_rate=0.4, lr_scheduler=ts)
        got = [to.lr_scheduler(n) for n in range(21)]
        want = [jo.lr_scheduler(n) for n in range(21)]
        assert got == want, type(ts).__name__
    with pytest.raises(ValueError):
        tsched.FactorScheduler(step=0)
    with pytest.raises(ValueError):
        tsched.MultiFactorScheduler(step=[3, 2])
