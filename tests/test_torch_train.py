"""The port's training slice against the JAX package, on the CPU.

``mxnet_tpu_torch.parallel.ShardedTrainer(ctx=cpu())`` trains the
transformer LM of ``models.transformer.get_symbol`` with the same
numpy parameters, optimizer state and batch as the JAX package's
``ShardedTrainer`` on a one-device mesh; outputs and every parameter are
compared after 3 steps, with the fused optimizer off and in kernel mode
on both sides (on the CPU the JAX sweep is its Pallas kernel in
interpret mode, the port's its plain version).  The JAX trainer's
attention on the CPU is its jnp reference; the port's is its flash
forward's plain version with the blockwise backward.

Tolerances: SGD with momentum, atol 1e-6 on parameters and outputs
(float32 rounding, lr 0.1, gradients rescaled by 1/(B*S)).  Adam,
atol 2e-5 on parameters: Adam divides each gradient element by its own
magnitude, so an element whose gradient sums terms that nearly cancel
carries its rounding (a relative 1e-4 here) into an lr-sized update.
Adam runs with epsilon 1e-6: the key bias of every layer has a true
gradient of exactly zero (softmax is shift-invariant per row), and the
computed gradient there is rounding noise of order 1e-10 that a 1e-8
epsilon would amplify to a sizeable fraction of lr in either package.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.parallel import ShardedTrainer as TTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=64, num_layers=2, num_heads=2, dim=32, seq_len=128)
B = 2
OPTS = {
    "sgd": (dict(learning_rate=0.1, momentum=0.9), 1e-6),
    "adam": (dict(learning_rate=0.01, epsilon=1e-6), 2e-5),
}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    S, V = DIMS["seq_len"], DIMS["vocab_size"]
    return {"data": rng.randint(0, V, (B, S)).astype(np.float32),
            "softmax_label": rng.randint(0, V, (B, S)).astype(np.float32)}


def _state_np(state):
    out = {}
    for n, s in state.items():
        if isinstance(s, tuple):
            out[n] = tuple(np.asarray(a) for a in s)
        else:
            out[n] = np.asarray(s)
    return out


@pytest.mark.parametrize("opt_name", sorted(OPTS))
@pytest.mark.parametrize("mode", ["", "kernel"])
def test_trainer_matches_jax(monkeypatch, opt_name, mode):
    """3 steps of the JAX trainer on a 1-device mesh == 3 steps of the
    port's trainer on the CPU, from the same numpy parameters and
    optimizer state, with MXTPU_FUSED_OPT '' and 'kernel' on both."""
    monkeypatch.setenv("MXTPU_FUSED_OPT", mode)
    kw, tol = OPTS[opt_name]
    rescale = 1.0 / (B * DIMS["seq_len"])
    jopt = jmx.optimizer.create(opt_name, rescale_grad=rescale, **kw)
    jtr = JTrainer(jmx.models.transformer.get_symbol(**DIMS), jopt,
                   jmake_mesh(jax.devices()[:1], dp=1))
    assert jtr._fused_opt == mode
    jmx.random.seed(3)
    shapes = dict(data_shapes={"data": (B, DIMS["seq_len"])},
                  label_shapes={"softmax_label": (B, DIMS["seq_len"])})
    jp, js, ja = jtr.init_params(**shapes)
    # non-zero optimizer state, from numpy, in both packages
    rng = np.random.RandomState(4)
    js = {n: (tuple(np.abs(rng.randn(*a.shape)).astype(np.float32) * 1e-4
                    for a in s) if isinstance(s, tuple)
              else (rng.randn(*s.shape) * 1e-3).astype(np.float32))
          for n, s in js.items()}
    p_np, s_np = {n: np.asarray(a) for n, a in jp.items()}, _state_np(js)

    topt = tmx.optimizer.create(opt_name, rescale_grad=rescale, **kw)
    ttr = TTrainer(ttf.get_symbol(**DIMS), topt, ctx=tmx.cpu())
    assert ttr._fused_opt == mode
    assert ttr.param_names == list(jtr.param_names)
    tp = ttf.params_from_numpy(p_np, ctx=tmx.cpu())
    ts = ttf.opt_state_from_numpy(s_np, ctx=tmx.cpu())
    ta = {}
    js = jax.tree_util.tree_map(jax.numpy.asarray, js)
    batch = _batch()
    jb, tb = jtr.shard_batch(batch), ttr.shard_batch(batch)
    for _ in range(3):
        jp, js, ja, jo = jtr.step(jp, js, ja, jb)
        tp, ts, ta, to = ttr.step(tp, ts, ta, tb)
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), atol=1e-6,
                               rtol=0)
    for n in p_np:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=tol, rtol=0, err_msg=n)
    for n in s_np:
        a = jax.tree_util.tree_leaves(js[n])
        b = list(ts[n]) if isinstance(ts[n], tuple) else [ts[n]]
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=tol,
                                       rtol=0, err_msg=n)


def test_fused_modes_bitwise_equal_leafwise(monkeypatch):
    """The port's trainer: MXTPU_FUSED_OPT '1' and 'kernel' give the
    parameters of the leafwise step bit for bit after 2 steps."""
    got = {}
    for mode in ("", "1", "kernel"):
        monkeypatch.setenv("MXTPU_FUSED_OPT", mode)
        tmx.random.seed(11)
        opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                   rescale_grad=1.0 / 256)
        tr = TTrainer(ttf.get_symbol(**DIMS), opt, ctx=tmx.cpu())
        p, s, a = tr.init_params({"data": (B, DIMS["seq_len"])},
                                 label_shapes={"softmax_label":
                                               (B, DIMS["seq_len"])})
        b = tr.shard_batch(_batch(1))
        for _ in range(2):
            p, s, a, _o = tr.step(p, s, a, b)
        got[mode] = p
    for mode in ("1", "kernel"):
        for n, w in got[""].items():
            assert torch.equal(got[mode][n], w), (mode, n)


def test_bfloat16_step_keeps_master_weights_and_ids():
    """compute_dtype='bfloat16': outputs in bfloat16, parameters and
    state stay float32, and Embedding ids and labels are never cast (a
    bfloat16 id above 256 rounds to another token)."""
    tmx.random.seed(0)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    tr = TTrainer(ttf.get_symbol(**DIMS), opt, ctx=tmx.cpu(),
                  compute_dtype="bfloat16")
    assert {"data", "softmax_label"} <= tr._cast_exempt
    p, s, a = tr.init_params({"data": (B, DIMS["seq_len"])},
                             label_shapes={"softmax_label":
                                           (B, DIMS["seq_len"])})
    batch = tr.shard_batch(_batch(2))
    cast = tr._batch_to_compute({"data": torch.tensor([257.0]),
                                 "x": torch.tensor([257.0])})
    assert cast["data"].item() == 257.0 and cast["x"].item() == 256.0
    p, s, a, outs = tr.step(p, s, a, batch)
    assert outs[0].dtype == torch.bfloat16
    assert torch.isfinite(outs[0].float()).all()
    assert all(w.dtype == torch.float32 for w in p.values())
    assert all(m.dtype == torch.float32 for m in s.values())
    ev = tr.eval(p, a, batch)
    assert ev[0].shape == (B * DIMS["seq_len"], DIMS["vocab_size"])


def test_trainer_refuses_what_later_slices_bring(monkeypatch):
    """No ctx and no mesh means gpu(0) (raises on a CPU-only box);
    seq_axis and the sentinel on a mesh of several devices raise.  The
    sentinel (``sentinel=True`` or ``MXTPU_SENTINEL``), the step watchdog
    and the checkpoint methods, which raised before the resilience slice,
    now build; so do ``remat`` and the mirrored symbol (``mirror_blocks``),
    ``zero1`` and ``fsdp`` (inert on one device, as in the JAX package), a
    dp mesh of two contexts, since the tensor-parallel slice a tp axis,
    and since the sequence-parallel slice ``seq_axis`` (a no-op on one
    device, as in the JAX package) and an sp axis, which raised before."""
    sym = ttf.get_symbol(**DIMS)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            TTrainer(sym, opt)
    assert not TTrainer(sym, opt, ctx=tmx.cpu(), zero1=True).zero1
    assert not TTrainer(sym, opt, ctx=tmx.cpu(), fsdp=True).fsdp
    assert TTrainer(sym, opt, ctx=tmx.cpu(), seq_axis=1).seq_axis == 1
    assert TTrainer(sym, opt, ctx=tmx.cpu(), sentinel=True).sentinel
    assert TTrainer(sym, opt, ctx=tmx.cpu(),
                    step_timeout_s=5.0).step_timeout_s == 5.0
    monkeypatch.setenv("MXTPU_SENTINEL", "1")
    assert TTrainer(sym, opt, ctx=tmx.cpu()).sentinel
    with pytest.raises(MXNetError, match="sentinel on a mesh"):
        TTrainer(sym, opt, tmx.parallel.make_mesh([tmx.cpu(), tmx.cpu()],
                                                  dp=2))
    monkeypatch.delenv("MXTPU_SENTINEL")
    tr = TTrainer(sym, opt, ctx=tmx.cpu())
    assert tr.latest_step("/nonexistent") is None
    # the MoE symbol builds (expert parallelism: tests/test_torch_moe.py)
    assert "layer0_moe_gate_weight" in \
        ttf.get_symbol(num_experts=2, **DIMS).list_arguments()
    assert TTrainer(sym, opt, ctx=tmx.cpu(), remat=True).remat
    mirrored = ttf.get_symbol(mirror_blocks=True, **DIMS)
    assert any(n.attrs.get("mirror_stage") == "layer0"
               for n in mirrored._topo())
    mesh = tmx.parallel.make_mesh([tmx.cpu(), tmx.cpu()], dp=2)
    assert mesh.size == 2 and TTrainer(sym, opt, mesh, zero1=True).zero1
    assert TTrainer(sym, opt, tmx.parallel.make_mesh(
        [tmx.cpu(), tmx.cpu()], dp=1, tp=2)).tp == 2
    assert TTrainer(sym, opt, tmx.parallel.make_mesh(
        [tmx.cpu(), tmx.cpu()], dp=1, sp=2), seq_axis=1).sp == 2


def test_training_symbol_matches_jax():
    """get_symbol: the same arguments, shapes and outputs as the JAX
    package's, and its JSON loads in the JAX package; the weight names
    are the generation graphs' (one checkpoint serves both)."""
    tsym = ttf.get_symbol(**DIMS)
    jsym = jmx.models.transformer.get_symbol(**DIMS)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    shapes = dict(data=(B, DIMS["seq_len"]),
                  softmax_label=(B, DIMS["seq_len"]))
    assert tsym.infer_shape(**shapes) == tuple(
        [tuple(x) for x in part] for part in jsym.infer_shape(**shapes))
    back = jmx.sym.load_json(tsym.tojson())
    assert back.list_arguments() == jsym.list_arguments()
    dec = ttf.get_decode_symbol(vocab_size=DIMS["vocab_size"],
                                num_layers=DIMS["num_layers"],
                                num_heads=DIMS["num_heads"], dim=DIMS["dim"],
                                max_seq_len=DIMS["seq_len"])
    weights = {n for n in dec.list_arguments()
               if n.endswith(("_weight", "_bias", "_gamma", "_beta"))}
    assert weights <= set(tsym.list_arguments())


def test_dropout_draws_from_the_seeded_generator():
    """MultiHeadAttention declares need_rng: the trainer hands it its
    device's generator, so a seed repeats a dropout step exactly, and
    dropout changes the outputs."""
    def run(dropout, seed):
        tmx.random.seed(seed)
        opt = tmx.optimizer.create("sgd", learning_rate=0.1)
        tr = TTrainer(ttf.get_symbol(dropout=dropout, **DIMS), opt,
                      ctx=tmx.cpu())
        assert tr._needs_rng
        p, s, a = tr.init_params({"data": (B, DIMS["seq_len"])},
                                 label_shapes={"softmax_label":
                                               (B, DIMS["seq_len"])})
        return tr.step(p, s, a, tr.shard_batch(_batch(3)))[3][0]

    a, b = run(0.5, 1), run(0.5, 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(0.0, 1))


def test_initializers_are_seeded_and_bounded():
    """Uniform and Xavier draw from the CPU generator: a seed repeats the
    weights; values stay inside the scale; biases 0, gammas 1."""
    from mxnet_tpu_torch import initializer as tinit
    from mxnet_tpu_torch.ndarray import NDArray

    def draw(init, name, shape):
        arr = NDArray(torch.full(shape, 5.0))
        init(name, arr)
        return arr.data

    tmx.random.seed(2)
    a = draw(tinit.Uniform(0.07), "fc_weight", (8, 16))
    tmx.random.seed(2)
    b = draw(tinit.Uniform(0.07), "fc_weight", (8, 16))
    assert torch.equal(a, b) and float(a.abs().max()) <= 0.07
    x = draw(tinit.Xavier(), "fc_weight", (8, 16))
    assert float(x.abs().max()) <= (3.0 / 12.0) ** 0.5
    assert torch.equal(draw(tinit.Xavier(), "fc_bias", (4,)), torch.zeros(4))
    assert torch.equal(draw(tinit.Uniform(), "ln_gamma", (4,)), torch.ones(4))


def test_training_runs_without_jax():
    """In a fresh interpreter where ``import jax`` fails: every module of
    the port imports (``rtc`` and ``kernels.nvrtc`` among them), the
    trainer takes two steps on the CPU with the fused sweep in kernel
    mode, and an NDArray goes through ``Rtc(pallas=False)``, touching no
    module of mxnet_tpu."""
    code = textwrap.dedent("""
        import importlib, os, pkgutil, sys
        sys.modules["jax"] = None
        os.environ["MXTPU_FUSED_OPT"] = "kernel"
        import numpy as np
        import mxnet_tpu_torch as mx
        for m in pkgutil.walk_packages(mx.__path__, "mxnet_tpu_torch."):
            importlib.import_module(m.name)
        from mxnet_tpu_torch.models import transformer as tf
        sym = tf.get_symbol(vocab_size=32, num_layers=1, num_heads=2,
                            dim=16, seq_len=16)
        opt = mx.optimizer.create("adam", rescale_grad=1.0 / 32)
        tr = mx.parallel.ShardedTrainer(sym, opt, ctx=mx.cpu())
        p, s, a = tr.init_params({"data": (2, 16)},
                                 label_shapes={"softmax_label": (2, 16)})
        rng = np.random.RandomState(0)
        b = tr.shard_batch({"data": rng.randint(0, 32, (2, 16)) * 1.0,
                            "softmax_label": rng.randint(0, 32, (2, 16)) * 1.0})
        for _ in range(2):
            p, s, a, out = tr.step(p, s, a, b)
        assert out[0].shape == (32, 32), out[0].shape
        with mx.cpu():
            a = mx.nd.array(np.arange(6.0).reshape(2, 3))
            (o,) = mx.rtc.Rtc(lambda x: x * 2.0 + 1.0).push([a])
        assert o.asnumpy().tolist() == [[1, 3, 5], [7, 9, 11]], o.asnumpy()
        import mxnet_tpu_torch.kernels.nvrtc, mxnet_tpu_torch.rtc
        bad = sorted(m for m in sys.modules if m == "mxnet_tpu"
                     or m.startswith("mxnet_tpu."))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


# ----------------------------------------------------------------------
# the rest of the initializers (mxnet_tpu/initializer.py:97-263), against
# the JAX package: the deterministic ones bit for bit, the random ones by
# their distribution (the two packages draw different numbers)
# ----------------------------------------------------------------------
def _init_both(make, name, shape, seed=0):
    """``make(initializer_module)`` applied to a zero array of ``shape``
    named ``name`` in both packages: ``(jax_values, port_values)``."""
    from mxnet_tpu import initializer as jinit
    from mxnet_tpu_torch import initializer as tinit
    jmx.random.seed(seed)
    tmx.random.seed(seed)
    ja = jmx.nd.zeros(shape)
    make(jinit)(name, ja)
    with tmx.cpu():
        ta = tmx.nd.zeros(shape)
    make(tinit)(name, ta)
    return ja.asnumpy(), ta.asnumpy()


@pytest.mark.parametrize("make,names", [
    (lambda m: m.Constant(0.25), ("upsampling0_weight", "fc_bias",
                                  "deconv_weight")),
    (lambda m: m.Zero(), ("upsampling0_weight", "fc_weight")),
    (lambda m: m.One(), ("upsampling0_weight", "fc_weight")),
    (lambda m: m.Bilinear(), ("upsampling0_weight", "deconv_weight",
                              "fc_bias")),
    (lambda m: m.Uniform(0.1), ("upsampling0_weight", "fc_bias")),
    (lambda m: m.Xavier(), ("upsampling1_weight", "bn_gamma"))],
    ids=["constant", "zero", "one", "bilinear", "uniform", "xavier"])
def test_deterministic_initializers_match_jax(make, names):
    """Constant, Zero, One and Bilinear give the JAX package's values bit
    for bit, and so does every dispatching initializer on an
    ``upsampling*`` weight (the bilinear kernel: 0.0625, 0.1875, 0.5625
    ... on (1, 1, 4, 4)) and on a bias or a gamma."""
    shapes = {"upsampling0_weight": (1, 1, 4, 4),
              "upsampling1_weight": (2, 1, 3, 5), "deconv_weight": (2, 3,
                                                                   5, 6),
              "fc_bias": (4,), "fc_weight": (3, 4), "bn_gamma": (5,)}
    for name in names:
        want, got = _init_both(make, name, shapes[name])
        np.testing.assert_array_equal(got, want, err_msg=name)
    if "upsampling0_weight" in names and \
            not isinstance(make(tmx.init), tmx.init.Constant):
        _j, got = _init_both(make, "upsampling0_weight", (1, 1, 4, 4))
        np.testing.assert_allclose(got[0, 0, 0], [0.0625, 0.1875, 0.1875,
                                                  0.0625])
        np.testing.assert_allclose(got[0, 0, 1, 1], 0.5625)


def test_random_initializers_match_jax_in_distribution():
    """Normal, Orthogonal, Xavier and MSRAPrelu against the JAX package's
    draws (``tests/test_metric_init.py:75-122``'s bounds): the range and
    mean, the standard deviation, orthogonality, the Xavier and MSRA
    scales; a seed repeats the port's draw."""
    for pkg, (a_j, a_t) in (("normal", _init_both(
            lambda m: m.Normal(2.0), "fc_weight", (100, 100), 42)),):
        for a in (a_j, a_t):
            assert abs(a.std() - 2.0) < 0.1 and abs(a.mean()) < 0.1, pkg
    for rand_type in ("uniform", "normal"):
        for a in _init_both(lambda m: m.Orthogonal(scale=1.0,
                                                    rand_type=rand_type),
                            "fc_weight", (16, 16)):
            np.testing.assert_allclose(a @ a.T, np.eye(16), atol=1e-4)
        for a in _init_both(lambda m: m.Orthogonal(rand_type=rand_type),
                            "fc_weight", (8, 4, 2)):
            flat = a.reshape(8, 8)
            np.testing.assert_allclose(flat @ flat.T / 1.414 ** 2,
                                       np.eye(8), atol=1e-4)
    bound = np.sqrt(3.0 / 64)
    for a in _init_both(lambda m: m.Xavier(factor_type="avg", magnitude=3),
                        "fc_weight", (64, 64)):
        assert a.min() >= -bound - 1e-6 and a.max() <= bound + 1e-6
        assert a.max() > 0.9 * bound
    want = np.sqrt(2.0 / (1 + 0.25 ** 2) / 128)
    for a in _init_both(lambda m: m.MSRAPrelu(), "fc_weight", (128, 128)):
        assert abs(a.std() - want) / want < 0.15
    one = _init_both(lambda m: m.Normal(0.5), "fc_weight", (8, 8), 3)[1]
    again = _init_both(lambda m: m.Normal(0.5), "fc_weight", (8, 8), 3)[1]
    np.testing.assert_array_equal(one, again)


def test_load_and_mixed_initializers_match_jax(tmp_path):
    """``Load`` (a dict or a saved file, ``arg:``/``aux:`` stripped, a
    default for the rest, a shape mismatch raising) and ``Mixed`` (the
    first matching pattern) as the JAX package's
    (``tests/test_metric_init.py:125-139``)."""
    from mxnet_tpu import initializer as jinit
    from mxnet_tpu_torch import initializer as tinit
    from mxnet_tpu_torch.base import MXNetError as TErr
    with tmx.cpu():
        src = {"arg:fc_weight": tmx.nd.array(np.arange(4.0).reshape(2, 2))}
        path = str(tmp_path / "w.params")
        tmx.nd.save(path, src)
        for given in (src, path):
            ini = tinit.Load(given, default_init=tinit.Zero())
            w = tmx.nd.zeros((2, 2))
            ini("fc_weight", w)
            np.testing.assert_array_equal(w.asnumpy(),
                                          np.arange(4.0).reshape(2, 2))
            other = tmx.nd.ones((3,))
            ini("other_weight", other)
            np.testing.assert_array_equal(other.asnumpy(), 0.0)
        with pytest.raises(TErr, match="Shape mismatch"):
            tinit.Load(src)("fc_weight", tmx.nd.zeros((3, 2)))
        with pytest.raises(TErr, match="no default"):
            tinit.Load(src)("x_weight", tmx.nd.zeros((3, 2)))
        mixed = tinit.Mixed([".*bias", ".*"], [tinit.One(), tinit.Zero()])
        b, w = tmx.nd.zeros((3,)), tmx.nd.ones((3,))
        mixed("fc_bias", b)
        mixed("fc_weight", w)
    jmixed = jinit.Mixed([".*bias", ".*"], [jinit.One(), jinit.Zero()])
    jb, jw = jmx.nd.zeros((3,)), jmx.nd.ones((3,))
    jmixed("fc_bias", jb)
    jmixed("fc_weight", jw)
    np.testing.assert_array_equal(b.asnumpy(), jb.asnumpy())
    np.testing.assert_array_equal(w.asnumpy(), jw.asnumpy())
    with pytest.raises(ValueError, match="did not match"):
        tinit.Mixed(["x"], [tinit.Zero()])("fc_weight", w)
    assert set(jinit.__all__) == set(tinit.__all__)
