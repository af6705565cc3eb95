"""Data parallelism in the port against the JAX package, on the CPU.

The twins of ``tests/test_parallel.py``'s mesh and data-parallel tests:
the JAX side runs on the 8 fake CPU devices ``tests/conftest.py`` sets
up, the port's on 8 contexts ``cpu(0)`` ... ``cpu(7)`` that share the
one CPU (a mesh may name one device for several replicas; their sums
are plain adds).  Inputs come from a numpy seed; the port starts from
the JAX package's initial weights, carried across with
``model.params_from_numpy(..., mesh=)``.

Tolerances: a dp step against the JAX dp step 2e-6 (float32 sums in
other orders), the port's dp=8 against its dp=1 2e-6 after three steps,
ZeRO-1 against plain dp bit for bit, BatchNorm's moving statistics
within 1e-6 of the JAX package's dp=8 step.  ``test_parallel.py``'s own
bound between dp and one device is 2e-4 / 2e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import collectives as tcoll

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = [tmx.cpu(i) for i in range(8)]
TOL = 2e-6


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _bn_net(mx):
    data = mx.sym.Variable("data")
    bn = mx.sym.BatchNorm(data, name="bn")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(bn, num_hidden=2,
                                                      name="fc"),
                                name="softmax")


def _close(got, want, tol=TOL, what=""):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol * scale, (what, k,
                                                    np.abs(g - w).max())


def _pair(sym_fn, opt_kw, shapes, batch, steps, devices=8, zero1=False,
          jax_too=True):
    """``steps`` steps of the JAX trainer on a dp mesh of ``devices``
    fake devices and of the port's on ``devices`` CPU contexts, from the
    JAX package's initial weights; returns both parameter, aux and
    output sets and the port's trainer and state."""
    data_shapes, label_shapes = shapes
    jout = None
    jopt = jmx.optimizer.create("sgd", **opt_kw)
    jtr = jpar.ShardedTrainer(sym_fn(jmx), jopt,
                              jpar.make_mesh(jax.devices()[:devices],
                                             dp=devices), zero1=zero1)
    jmx.random.seed(7)
    jp, js, ja = jtr.init_params(data_shapes, label_shapes=label_shapes)
    p_np = {k: np.asarray(v) for k, v in jp.items()}
    a_np = {k: np.asarray(v) for k, v in ja.items()}
    if jax_too:
        jb = jtr.shard_batch(batch)
        for _ in range(steps):
            jp, js, ja, jo = jtr.step(jp, js, ja, jb)
        jout = ({k: np.asarray(v) for k, v in jp.items()},
                {k: np.asarray(v) for k, v in ja.items()},
                np.asarray(jo[0]))
    mesh = tpar.make_mesh(CPUS[:devices], dp=devices)
    topt = tmx.optimizer.create("sgd", **opt_kw)
    ttr = tpar.ShardedTrainer(sym_fn(tmx), topt, mesh, zero1=zero1)
    _, ts, _ = ttr.init_params(data_shapes, label_shapes=label_shapes)
    tp, ta = tmx.model.params_from_numpy(p_np, a_np, mesh=mesh)
    tb = ttr.shard_batch(batch)
    for _ in range(steps):
        tp, ts, ta, to = ttr.step(tp, ts, ta, tb)
    tout = ({k: np.asarray(v) for k, v in tp.items()},
            {k: np.asarray(v) for k, v in ta.items()}, np.asarray(to[0]))
    return jout, tout, ttr, ts, tp


def test_make_mesh_shapes():
    """The JAX twin's shapes over 8 CPU contexts, tp and sp included
    (sp raised before the sequence-parallel slice ported it)."""
    assert len(jax.devices()) == 8
    mesh = tpar.make_mesh(CPUS, dp=8)
    assert dict(mesh.shape) == dict(jpar.make_mesh(dp=8).shape) == {"dp": 8}
    assert tpar.make_mesh(CPUS, dp=-1).shape["dp"] == 8
    assert mesh.size == 8 and len(mesh.devices) == 8
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        tpar.make_mesh(CPUS, dp=3)
    with pytest.raises(ValueError):
        jpar.make_mesh(dp=3, tp=2)
    assert dict(tpar.make_mesh(CPUS, dp=4, tp=2).shape) == \
        dict(jpar.make_mesh(dp=4, tp=2).shape) == {"dp": 4, "tp": 2}
    assert tpar.make_mesh(CPUS, dp=-1, tp=2).shape["dp"] == 4
    assert dict(tpar.make_mesh(CPUS, dp=4, sp=2).shape) == \
        dict(jpar.make_mesh(dp=4, sp=2).shape) == {"dp": 4, "sp": 2}
    assert dict(tpar.auto_mesh(devices=CPUS).shape) == \
        dict(jpar.auto_mesh().shape)
    # the same context twice is a mesh of two replicas on one device
    twice = tpar.make_mesh([tmx.cpu(0), tmx.cpu(0)], dp=2)
    assert twice.size == 2 and twice.replica_group().route() == "local"
    lm = tpar.LogicalMesh(dp=64, tp=4)
    assert dict(tpar.remesh(lm, total=128).shape) == \
        dict(jpar.remesh(jpar.LogicalMesh(dp=64, tp=4), total=128).shape)
    with tmx.cpu():
        assert dict(tpar.make_mesh(dp=1).shape) == {"dp": 1}


def test_param_pspec_rules():
    """The copied policy gives the JAX package's spec for every case of
    its twin, and for batches and named maps."""
    jmesh = jpar.make_mesh(dp=4, tp=2)
    tmesh = tpar.LogicalMesh(dp=4, tp=2)
    for name, shape in (("fc1_weight", (16, 8)), ("fc1_bias", (16,)),
                        ("w", (5, 3)), ("w", (5, 4)), ("bn_gamma", (16,)),
                        ("expert_w", (4, 8))):
        assert tuple(tpar.param_pspec(name, shape, tmesh)) == \
            tuple(jpar.param_pspec(name, shape, jmesh)), (name, shape)
    assert tuple(tpar.batch_pspec((32, 8), tmesh)) == \
        tuple(jpar.batch_pspec((32, 8), jmesh)) == ("dp", None)
    shapes = {"data": (8, 4), "softmax_label": (8,), "fc_weight": (6, 4)}
    assert {k: tuple(v) for k, v in
            tpar.named_pspecs(shapes, tmesh).items()} == \
        {k: tuple(v) for k, v in jpar.named_pspecs(shapes, jmesh).items()}
    for rule in ("dp2", "fsdp8", "dp2tp2", "dp2pp2ep2"):
        assert tpar.parse_sharding(rule) == jpar.parse_sharding(rule)
    with pytest.raises(ValueError):
        tpar.parse_sharding("tp2dp2")


def test_dp_trainer_step_runs_and_learns():
    """dp=8 learns the JAX twin's problem, step for step the JAX dp=8
    trainer's outputs (the accuracies agree at every step)."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32) * 3
    opt_kw = dict(learning_rate=0.5, rescale_grad=1.0 / 64)
    jout, tout, ttr, _, _ = _pair(_mlp, opt_kw, ({"data": (64, 8)},
                                                 {"softmax_label": (64,)}),
                                  {"data": x, "softmax_label": y}, 30)
    assert set(ttr.param_names) == {"fc1_weight", "fc1_bias",
                                    "fc2_weight", "fc2_bias"}
    acc = (tout[2].argmax(axis=1) == y).mean()
    assert acc > 0.9, acc
    assert acc == (jout[2].argmax(axis=1) == y).mean()
    _close(tout[0], jout[0], 1e-4, "params after 30 steps")


def test_dp_matches_single_device():
    """The port's dp=8 step == its one-device step and the JAX dp=8
    step, three steps from the same weights."""
    rng = np.random.RandomState(1)
    x = rng.randn(16, 8).astype(np.float32)
    y = (rng.rand(16) * 4).astype(np.float32)
    batch = {"data": x, "softmax_label": y}
    shapes = ({"data": (16, 8)}, {"softmax_label": (16,)})
    jout, tout, ttr, _, tp = _pair(_mlp, dict(learning_rate=0.1), shapes,
                                   batch, 3)
    assert all(isinstance(v, tpar.ShardedArray) for v in tp.values())
    assert tp["fc1_weight"].sharding.is_fully_replicated
    _close(tout[0], jout[0], what="dp=8 against JAX dp=8")
    _, one, _, _, _ = _pair(_mlp, dict(learning_rate=0.1), shapes, batch,
                            3, devices=1, jax_too=False)
    _close(tout[0], one[0], what="dp=8 against dp=1")
    np.testing.assert_allclose(tout[2], one[2], atol=TOL)


def test_batchnorm_aux_updates_in_sharded_step():
    """BatchNorm's batch statistics are the whole batch's over the 8
    replicas: the moving statistics equal the JAX dp=8 step's (and the
    port's one-device step's), not only "changed"."""
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32) * 3 + 1
    batch = {"data": x, "softmax_label": np.zeros(16, np.float32)}
    shapes = ({"data": (16, 4)}, {"softmax_label": (16,)})
    jout, tout, _, _, _ = _pair(_bn_net, dict(learning_rate=0.01), shapes,
                                batch, 2)
    assert set(tout[1]) == {"bn_moving_mean", "bn_moving_var"}
    assert not np.allclose(tout[1]["bn_moving_mean"], 0.0)
    _close(tout[1], jout[1], 1e-6, "moving statistics")
    _close(tout[0], jout[0], 1e-6, "parameters")
    _, one, _, _, _ = _pair(_bn_net, dict(learning_rate=0.01), shapes, batch,
                            2, devices=1, jax_too=False)
    _close(tout[1], one[1], 1e-6, "dp=8 against dp=1")
    # one replica's shard alone has other statistics
    assert np.abs(x[:2].mean(0) - x.mean(0)).max() > 0.1


@pytest.mark.parametrize("mode", ["", "1", "kernel"])
def test_zero1_optimizer_state_sharding(monkeypatch, mode):
    """ZeRO-1: the momentum of (16, 8) fc1_weight lives dp-sharded (a
    device holds 16 // 8 rows), the (4,) fc2_bias whole on every device,
    parameters replicated; training equals plain dp bit for bit (each
    fused mode) and the JAX zero1 run within 2e-6."""
    monkeypatch.setenv("MXTPU_FUSED_OPT", mode)
    rng = np.random.RandomState(3)
    x = rng.randn(16, 8).astype(np.float32)
    y = (rng.rand(16) * 4).astype(np.float32)
    batch = {"data": x, "softmax_label": y}
    shapes = ({"data": (16, 8)}, {"softmax_label": (16,)})
    kw = dict(learning_rate=0.1, momentum=0.9)
    jout, tout, ttr, ts, tp = _pair(_mlp, kw, shapes, batch, 4, zero1=True)
    assert ttr.zero1
    mom = ts["fc1_weight"]
    assert mom.sharding.spec[0] == "dp", mom.sharding
    assert mom.addressable_shards[0].data.shape[0] == mom.shape[0] // 8
    assert ts["fc2_bias"].sharding.is_fully_replicated      # 4 rows
    assert tuple(ttr.opt_state_sharding("fc2_bias", (4,)).spec) == (None,)
    assert tp["fc1_weight"].sharding.is_fully_replicated
    _close(tout[0], jout[0], what="zero1 against JAX zero1")
    _, base, _, bs, _ = _pair(_mlp, kw, shapes, batch, 4, jax_too=False)
    for k in base[0]:
        np.testing.assert_array_equal(tout[0][k], base[0][k])
    np.testing.assert_array_equal(np.asarray(mom),
                                  np.asarray(bs["fc1_weight"]))


def _reduce_net(mx):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    top = mx.sym.max(fc, axis=(0,))
    head = mx.sym.FullyConnected(mx.sym.Reshape(top, shape=(1, 3)),
                                 num_hidden=2, name="head")
    loss = mx.sym.sum(head) + mx.sym.norm(fc) \
        + mx.sym.sum(mx.sym.min(fc, axis=(0,))) \
        + mx.sym.sum(fc, axis=(0, 1))
    return mx.sym.Group([
        mx.sym.MakeLoss(loss, name="l"),
        mx.sym.MakeLoss(fc, normalization="batch", name="lb"),
        mx.sym.SoftmaxOutput(fc, mx.sym.Variable("lab"),
                             normalization="valid", use_ignore=True,
                             ignore_label=2, name="sm")])


def test_batch_reductions_across_replicas():
    """The ops that reduce over the batch axis (max, min and sum over
    axis 0, norm, the loss heads' batch and valid normalizers, a
    parameter after a replicated value, MakeLoss of a replicated value)
    give the one-device step's parameters and outputs on dp=4."""
    rng = np.random.RandomState(5)
    batch = {"data": rng.randn(8, 4).astype(np.float32),
             "lab": np.array([0, 1, 2, 2, 1, 0, 2, 1], np.float32)}
    got = {}
    for n in (1, 4):
        mesh = tpar.make_mesh(CPUS[:n], dp=n)
        tr = tpar.ShardedTrainer(_reduce_net(tmx), tmx.optimizer.create(
            "sgd", learning_rate=0.01), mesh, label_names=("lab",))
        tmx.random.seed(2)
        p, s, a = tr.init_params({"data": (8, 4)},
                                 label_shapes={"lab": (8,)})
        b = tr.shard_batch(batch)
        for _ in range(3):
            p, s, a, o = tr.step(p, s, a, b)
        got[n] = ({k: np.asarray(v) for k, v in p.items()},
                  [np.asarray(x) for x in o])
    _close(got[4][0], got[1][0], 1e-6, "parameters")
    for g, w in zip(got[4][1], got[1][1]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-6)


def test_collectives_on_shared_devices():
    """all_reduce, reduce_scatter, all_gather and broadcast over four
    replicas on the CPU against numpy; the autograd sum's backward sums
    the replicas' gradients."""
    group = tcoll.ReplicaGroup([torch.device("cpu")] * 4)
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.randn(8).astype(np.float32))
          for _ in range(4)]
    want = sum(x.numpy() for x in xs)
    for got in tcoll.all_reduce(group, xs):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    parts = tcoll.reduce_scatter(group, xs)
    np.testing.assert_allclose(torch.cat(parts).numpy(), want, rtol=1e-6)
    for got in tcoll.all_gather(group, [x[:2] for x in xs]):
        np.testing.assert_array_equal(
            got.numpy(), np.concatenate([x[:2].numpy() for x in xs]))
    ys = [x.clone() for x in xs]
    tcoll.broadcast(group, ys, root=2)
    for y in ys:
        np.testing.assert_array_equal(y.numpy(), xs[2].numpy())
    leaves = [x.clone().requires_grad_(True) for x in xs]
    outs = tcoll.all_reduce_autograd(group, leaves)
    torch.autograd.backward(outs, [torch.full_like(o, float(r + 1))
                                   for r, o in enumerate(outs)])
    for leaf in leaves:
        np.testing.assert_array_equal(leaf.grad.numpy(), np.full(8, 10.0))
    assert not tcoll.ReplicaGroup([torch.device("cpu")]).nccl
    # one replica a process, or several in one process; never both
    assert tcoll.ReplicaGroup([torch.device("cpu")], 2).route() == "dist"
    with pytest.raises(tmx.base.MXNetError, match=r"queue 1 item 3 \(g\)"):
        tcoll.ReplicaGroup([torch.device("cpu")] * 2, num_processes=2)


def test_grad_bucket_plan_matches_jax(monkeypatch):
    """``interleave_grad_buckets``' plan is the JAX partition of the
    gradients in production order (``MXTPU_BUCKET_MB``), and one bucket
    when bucketing is off."""
    from mxnet_tpu.parallel import overlap as jov
    from mxnet_tpu_torch.parallel import overlap as tov
    grads = {"w%d" % i: torch.zeros(1000 * (i + 1)) for i in range(6)}
    monkeypatch.setenv("MXTPU_BUCKET_MB", "0.02")
    assert tov.bucket_bytes() == jov.bucket_bytes() == int(0.02 * (1 << 20))
    plan = tov.interleave_grad_buckets(grads)
    sized = [(k, grads[k].numel() * 4) for k in reversed(list(grads))]
    assert plan == jov.partition_buckets(sized, jov.bucket_bytes())
    assert len(plan) > 2
    monkeypatch.setenv("MXTPU_BUCKET_MB", "0")
    assert tov.interleave_grad_buckets(grads) == [list(reversed(
        list(grads)))]


def test_sharded_array_placement():
    """``place`` splits a batch over dp in replica order and copies a
    replicated value to every replica (each its own tensor);
    ``numpy.asarray`` assembles the global value."""
    from mxnet_tpu_torch.parallel.sharding import P, place
    mesh = tpar.make_mesh(CPUS[:4], dp=4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    arr = place(x, mesh, P("dp", None))
    assert arr.shape == (8, 3) and not arr.sharding.is_fully_replicated
    assert [tuple(s.data.shape) for s in arr.addressable_shards] == \
        [(2, 3)] * 4
    np.testing.assert_array_equal(np.asarray(arr), x)
    rep = place(x, mesh, P(None, None))
    assert rep.sharding.is_fully_replicated
    assert len({s.data_ptr() for s in rep.shards}) == 4
    np.testing.assert_array_equal(np.asarray(rep), x)
    with pytest.raises(ValueError):
        place(np.zeros((6, 2), np.float32), mesh, P("dp", None))


def test_transformer_lm_dp_matches_single_device():
    """The transformer LM's dp=2 step (the flash forward's plain version
    on each replica) equals its one-device step at twice the batch."""
    dims = dict(vocab_size=32, num_layers=2, num_heads=2, dim=16,
                seq_len=8)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 32, (4, 9))
    batch = {"data": tokens[:, :-1].astype(np.float32),
             "softmax_label": tokens[:, 1:].astype(np.float32)}
    got = {}
    for n in (1, 2):
        mesh = tpar.make_mesh(CPUS[:n], dp=n)
        tr = tpar.ShardedTrainer(
            tmx.models.transformer.get_symbol(**dims),
            tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                 rescale_grad=1.0 / 32), mesh)
        tmx.random.seed(4)
        p, s, a = tr.init_params({"data": (4, 8)},
                                 label_shapes={"softmax_label": (4, 8)})
        b = tr.shard_batch(batch)
        for _ in range(2):
            p, s, a, o = tr.step(p, s, a, b)
        got[n] = {k: np.asarray(v) for k, v in p.items()}
    _close(got[2], got[1], 1e-6, "LM dp=2 against dp=1")


def test_trainer_raises_what_later_slices_bring():
    """A rule that splits a parameter over dp (outside fsdp) and remat
    on several devices raise, naming their slice; seq_axis (which raised
    before the sequence-parallel slice) does nothing without an sp axis,
    as in the JAX package, and with ZeRO-1 on a dp x sp mesh raises,
    naming item 3 (c2)."""
    mesh = tpar.make_mesh(CPUS[:2], dp=2)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1)
    assert tpar.ShardedTrainer(_mlp(tmx), opt, mesh, seq_axis=1).sp == 1
    with pytest.raises(MXNetError, match=r"seq_axis.*3 \(c2\)"):
        tpar.ShardedTrainer(_mlp(tmx), opt, tpar.make_mesh(
            CPUS[:4], dp=2, sp=2), seq_axis=1, zero1=True)
    with pytest.raises(MXNetError, match="remat"):
        tpar.ShardedTrainer(_mlp(tmx), opt, mesh, remat=True)
    rules = tpar.ShardingRules([(r"fc1_weight",
                                 lambda s, m: tpar.sharding.P("dp", None))])
    tr = tpar.ShardedTrainer(_mlp(tmx), opt, mesh, rules=rules)
    with pytest.raises(MXNetError, match="splits a parameter over dp"):
        tr.init_params({"data": (4, 8)},
                       label_shapes={"softmax_label": (4,)})
    with pytest.raises(MXNetError, match="elementwise"):
        tpar.ShardedTrainer(_mlp(tmx), tmx.optimizer.create("lamb"), mesh,
                            zero1=True)


def test_new_modules_import_without_jax():
    """The modules of this slice import with JAX blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mxnet_tpu'] = None; "
            "import mxnet_tpu_torch as mx; "
            "import mxnet_tpu_torch.parallel.collectives, "
            "mxnet_tpu_torch.parallel.sharding, "
            "mxnet_tpu_torch.parallel.mesh, mxnet_tpu_torch.kvstore_server; "
            "kv = mx.kvstore.create('dist_sync'); "
            "assert (kv.rank, kv.num_workers) == (0, 1); "
            "m = mx.parallel.make_mesh([mx.cpu(0), mx.cpu(1)], dp=2); "
            "print(m.size)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXTPU_COORDINATOR", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2"
