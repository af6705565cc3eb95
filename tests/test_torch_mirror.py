"""The executor's mirroring and ``ShardedTrainer(remat=True)`` in the port,
against its own unmirrored runs and the JAX package, on the CPU.

The twins of ``tests/test_mirror.py``: a mirrored graph (``force_mirroring``
or ``MXNET_BACKWARD_DO_MIRROR=1``) recomputes its segments in the
backward and gives the unmirrored gradients, aux and outputs bit for bit
here (the same ops on the same inputs); against the JAX package's
mirrored runs the tolerance is the op tests' (1e-5 forward, 1e-4 of the
max-abs for gradients).  What a walk keeps for its backward is counted
with ``torch.autograd.graph.saved_tensors_hooks``
(``executor.trace_residual_bytes``).
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu.executor import _mirror_segments as j_mirror_segments

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.executor import (_mirror_segments, build_program,
                                      trace_residual_bytes)
from mxnet_tpu_torch.parallel import ShardedTrainer as TTrainer

from test_torch_resnet_train import _symbols as resnet_symbols
from test_torch_resnet_train import seeded_resnet

MIRROR = {"force_mirroring": "true"}


def _mlp(mx, attr=None, n_layers=5, hidden=64, act="tanh"):
    with mx.name.NameManager():
        h = mx.sym.Variable("data")
        for i in range(n_layers):
            h = mx.sym.FullyConnected(h, num_hidden=hidden, name="fc%d" % i)
            h = mx.sym.Activation(h, act_type=act, name="act%d" % i,
                                  attr=attr or {})
        return mx.sym.SoftmaxOutput(h, mx.sym.Variable("softmax_label"),
                                    name="softmax")


def _bn_net(mx, attr=None):
    """conv -> BatchNorm -> ReLU twice, pooling, classifier: the unit the
    image models repeat."""
    attr = attr or {}
    with mx.name.NameManager():
        h = mx.sym.Variable("data")
        for i in range(2):
            h = mx.sym.Convolution(h, num_filter=8, kernel=(3, 3),
                                   pad=(1, 1), name="conv%d" % i)
            h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn%d" % i,
                                 attr=attr)
            h = mx.sym.Activation(h, act_type="relu", name="relu%d" % i,
                                  attr=attr)
        h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                           name="pool", attr=attr)
        h = mx.sym.FullyConnected(mx.sym.Flatten(h), num_hidden=10,
                                  name="fc")
        return mx.sym.SoftmaxOutput(h, mx.sym.Variable("softmax_label"),
                                    name="softmax")


def _bind_run(mx, sym, data_shape, seed=3, classes=10):
    ctx = mx.cpu()
    with ctx:
        ex = sym.simple_bind(ctx, data=data_shape, grad_req="write")
    rs = np.random.RandomState(seed)
    for n, a in ex.arg_dict.items():
        if n not in ("data", "softmax_label"):
            a[:] = (rs.rand(*a.shape).astype(np.float32) - 0.5) * 0.5
    ex.arg_dict["data"][:] = rs.rand(*data_shape).astype(np.float32)
    ex.arg_dict["softmax_label"][:] = rs.randint(
        0, classes, (data_shape[0],)).astype(np.float32)
    ex.forward(is_train=True)
    ex.backward()
    return ex


def _state(ex):
    out = {"out%d" % i: o.asnumpy() for i, o in enumerate(ex.outputs)}
    out.update({"grad:" + n: g.asnumpy() for n, g in ex.grad_dict.items()})
    out.update({"aux:" + n: a.asnumpy() for n, a in ex.aux_dict.items()})
    return out


def _bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _close(got, want, what):
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        tol = (1e-4 if k.startswith("grad:") else 1e-5) \
            * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= tol, (what, k)


CASES = [(_mlp, (16, 64), 64), (_bn_net, (4, 3, 8, 8), 10)]


@pytest.mark.parametrize("net,shape,classes", CASES)
def test_force_mirroring_bitwise_and_matches_jax(net, shape, classes):
    plain = _state(_bind_run(tmx, net(tmx), shape, classes=classes))
    mex = _bind_run(tmx, net(tmx, MIRROR), shape, classes=classes)
    assert mex._program.n_mirrored > 0
    _bitwise(plain, _state(mex))
    jex = _bind_run(jmx, net(jmx, MIRROR), shape, classes=classes)
    _close(_state(mex), _state(jex), "port vs JAX, mirrored")


@pytest.mark.parametrize("net,shape,classes", CASES)
def test_env_do_mirror_bitwise_and_matches_jax(monkeypatch, net, shape,
                                               classes):
    """MXNET_BACKWARD_DO_MIRROR=1 mirrors the ops outside the skip list
    with no attrs at all."""
    plain = _state(_bind_run(tmx, net(tmx), shape, classes=classes))
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    mex = _bind_run(tmx, net(tmx), shape, classes=classes)
    jex = _bind_run(jmx, net(jmx), shape, classes=classes)
    assert mex._program.n_mirrored > 0
    _bitwise(plain, _state(mex))
    _close(_state(mex), _state(jex), "port vs JAX, env mirrored")


def test_mirrored_walk_keeps_fewer_tensors(monkeypatch):
    """What the walk keeps for its backward, counted with saved-tensor
    hooks: conv -> BatchNorm -> ReLU keeps the convolution's output and
    the ReLU's (the next op reads it); mirrored, the ReLU's output and
    the pooling's indices are recomputed.  The JAX package's residual
    count does not fall on this graph: its ``jax.checkpoint`` segments
    hand their outputs to the next op, which keeps them; the port's
    backward recomputes those too, as the reference's reads its mirrored
    copies.  (An FC -> tanh chain keeps as much either way in the port:
    tanh saves only its output, which the next FC keeps.)"""
    plain = _bind_run(tmx, _bn_net(tmx), (4, 3, 8, 8))
    mirr = _bind_run(tmx, _bn_net(tmx, MIRROR), (4, 3, 8, 8))
    rp, rm = plain.backward_residual_bytes(), mirr.backward_residual_bytes()
    assert rm < rp, (rm, rp)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    env = _bind_run(tmx, _bn_net(tmx), (4, 3, 8, 8))
    assert env.backward_residual_bytes() < rp
    jp = _bind_run(jmx, _bn_net(jmx), (4, 3, 8, 8))
    jm = _bind_run(jmx, _bn_net(jmx, MIRROR), (4, 3, 8, 8))
    if jp.backward_residual_bytes() is not None:
        assert jm.backward_residual_bytes() <= jp.backward_residual_bytes()


def test_mirror_with_dropout_rng_replay():
    """Dropout beside mirrored nodes: never mirrored itself, it draws the
    same mask from the same seed, and the backward matches the
    unmirrored run bit for bit."""
    def net(attr):
        with tmx.name.NameManager():
            x = tmx.sym.Variable("data")
            h = tmx.sym.FullyConnected(x, num_hidden=32, name="fc0")
            h = tmx.sym.Activation(h, act_type="relu", name="a0", attr=attr)
            h = tmx.sym.Dropout(h, p=0.5, name="drop")
            h = tmx.sym.FullyConnected(h, num_hidden=32, name="fc1")
            h = tmx.sym.Activation(h, act_type="relu", name="a1", attr=attr)
            return tmx.sym.SoftmaxOutput(
                h, tmx.sym.Variable("softmax_label"), name="softmax")

    tmx.random.seed(1234)
    plain = _state(_bind_run(tmx, net({}), (16, 32), classes=32))
    tmx.random.seed(1234)
    mex = _bind_run(tmx, net(MIRROR), (16, 32), classes=32)
    assert [n.name for m, ns in mex._program.segments if m
            for n in ns] == ["a0", "a1"]
    _bitwise(plain, _state(mex))


def test_mirrored_segment_replays_its_draws():
    """A segment that draws random numbers (the LM's attention with
    dropout, ``mirror_blocks=True``) replays the same stream in its
    recompute, and the generator moves on as if unmirrored: two steps of
    gradients and the generator's state equal the unmirrored run's."""
    from mxnet_tpu_torch.models import transformer as ttf
    dims = dict(vocab_size=32, num_layers=2, num_heads=2, dim=16,
                seq_len=8, dropout=0.25)
    got = []
    for mb in (False, True):
        with tmx.name.NameManager():
            sym = ttf.get_symbol(mirror_blocks=mb, **dims)
        prog = build_program(sym)
        assert (prog.n_mirrored > 0) == mb
        tmx.random.seed(7)
        rs = np.random.RandomState(0)
        shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
            data=(2, 8), softmax_label=(2, 8))[0]))
        args = {n: torch.from_numpy((rs.rand(*s) * 0.2 - 0.1)
                                    .astype(np.float32))
                for n, s in shapes.items()}
        args["data"] = torch.from_numpy(rs.randint(0, 32, (2, 8))
                                        .astype(np.float32))
        args["softmax_label"] = args["data"].clone()
        gen = tmx.random.generator("cpu")
        grads = []
        for _ in range(2):
            leaves = {n: v.clone().requires_grad_()
                      for n, v in args.items()
                      if n not in ("data", "softmax_label")}
            outs, _ = prog.trace(dict(args, **leaves), {}, gen, True)
            g = torch.autograd.grad(outs, list(leaves.values()),
                                    [torch.ones_like(o) for o in outs])
            grads.append([x.numpy() for x in g])
        got.append((grads, gen.get_state().numpy()))
    for a, b in zip(got[0][0], got[1][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_mirror_batchnorm_aux_updates_once():
    """BatchNorm's moving statistics come from the forward only (the
    recompute's are dropped): equal to the unmirrored run's, and
    moved."""
    plain = _bind_run(tmx, _bn_net(tmx), (4, 3, 8, 8))
    mirr = _bind_run(tmx, _bn_net(tmx, MIRROR), (4, 3, 8, 8))
    for n, a in plain.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), mirr.aux_dict[n].asnumpy())
    mm = mirr.aux_dict["bn0_moving_mean"].asnumpy()
    assert np.abs(mm).max() > 0
    # a second backward-needing step keeps them single-counted
    mirr.forward(is_train=True)
    mirr.backward()
    plain.forward(is_train=True)
    plain.backward()
    for n, a in plain.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), mirr.aux_dict[n].asnumpy())


def test_mirror_monitor_unaffected():
    """A monitored forward runs unmirrored and sees the same records, with
    the same values, as the unmirrored graph's; the JAX package's monitor
    sees the same names."""
    def records(mx, sym):
        ex = _bind_run(mx, sym, (16, 64), classes=64)
        seen = {}
        ex.set_monitor_callback(lambda name, arr: seen.setdefault(
            name, arr.asnumpy()))
        ex.forward(is_train=True)
        return ex, seen
    ex, mirrored = records(tmx, _mlp(tmx, MIRROR, n_layers=2))
    _ex, plain = records(tmx, _mlp(tmx, None, n_layers=2))
    _jex, jseen = records(jmx, _mlp(jmx, MIRROR, n_layers=2))
    assert list(mirrored) == list(plain) == list(jseen)
    for k in plain:
        np.testing.assert_array_equal(mirrored[k], plain[k])
        np.testing.assert_allclose(mirrored[k], jseen[k], atol=1e-5)
    assert any(k.startswith("act") for k in mirrored)
    np.testing.assert_array_equal(mirrored["softmax_output"],
                                  ex.outputs[0].asnumpy())


def _segment_names(segments):
    return [(bool(m), [n.name for n in nodes]) for m, nodes in segments]


@pytest.mark.parametrize("env", [{}, {"MXNET_BACKWARD_DO_MIRROR": "1"},
                                 {"MXNET_BACKWARD_DO_MIRROR": "1",
                                  "MXNET_BACKWARD_MIRROR_STEP": "3"},
                                 {"MXNET_BACKWARD_DO_MIRROR": "1",
                                  "MXNET_BACKWARD_MIRROR_STEP": "0"}])
@pytest.mark.parametrize("mirror_blocks", [False, True])
def test_mirror_segments_match_jax(monkeypatch, env, mirror_blocks):
    """The segment lists of ResNet-18 (``mirror_blocks`` tags each unit
    with its own ``mirror_stage``) equal the JAX package's, node for
    node, under each env."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for mx, fn in ((jmx, j_mirror_segments), (tmx, _mirror_segments)):
        with mx.name.NameManager():
            sym = mx.models.resnet.get_symbol(10, 18, (3, 16, 16),
                                              mirror_blocks=mirror_blocks)
        out.append(_segment_names(fn([n for n in sym._topo()
                                      if not n.is_variable])))
    assert out[0] == out[1]
    assert any(m for m, _ in out[1]) == bool(mirror_blocks or env)


def test_rebind_after_env_is_mirrored(monkeypatch):
    """The program registry keys on the mirroring envs: the same graph
    bound again after ``MXNET_BACKWARD_DO_MIRROR=1`` gets a mirrored
    program, and after unsetting it the unmirrored one again."""
    monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    a = _bind_run(tmx, _bn_net(tmx), (4, 3, 8, 8))
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    b = _bind_run(tmx, _bn_net(tmx), (4, 3, 8, 8))
    monkeypatch.setenv("MXNET_BACKWARD_MIRROR_STEP", "2")
    c = _bind_run(tmx, _bn_net(tmx), (4, 3, 8, 8))
    monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR")
    monkeypatch.delenv("MXNET_BACKWARD_MIRROR_STEP")
    d = _bind_run(tmx, _bn_net(tmx), (4, 3, 8, 8))
    assert a._program.n_mirrored == 0 and d._program is a._program
    assert b._program.n_mirrored > 0
    assert c._program is not b._program
    assert _segment_names(c._program.segments) \
        != _segment_names(b._program.segments)
    _bitwise(_state(a), _state(b))


def test_grad_symbol_base_walk_follows_bind_env(monkeypatch):
    """A ``Symbol.grad`` symbol bound with ``MXNET_BACKWARD_DO_MIRROR=1``
    walks its base graph mirrored (the base's program is built with the
    grad symbol's, under the bind's envs), and one bound without it
    unmirrored; their gradients are equal bit for bit."""
    import mxnet_tpu_torch.executor as texec
    made = []

    class Counting(texec._MirrorHooks):
        def __init__(self):
            made.append(1)
            super().__init__()
    monkeypatch.setattr(texec, "_MirrorHooks", Counting)
    with tmx.name.NameManager():
        g = _bn_net(tmx).grad(["conv0_weight"])
    shapes = dict(zip(g.list_arguments(),
                      g.infer_shape(data=(4, 3, 8, 8))[0]))
    rs = np.random.RandomState(5)
    values = {n: (rs.rand(*s) - 0.5).astype(np.float32)
              for n, s in shapes.items()}
    values["softmax_label"] = (np.arange(4) % 10).astype(np.float32)
    got = []
    for env in ("", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", env)
        ex = g.bind(tmx.cpu(), {n: tmx.nd.array(v, ctx=tmx.cpu())
                                for n, v in values.items()})
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR")
        before = len(made)
        (out,) = ex.forward()
        got.append((out.asnumpy(), len(made) - before))
    assert [n for _o, n in got] == [0, 1]
    assert np.abs(got[0][0]).max() > 0
    np.testing.assert_array_equal(got[0][0], got[1][0])


def _trainer_run(sym, remat, steps=2):
    params, aux, data = seeded_resnet(sym)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               wd=1e-4, rescale_grad=0.25)
    tr = TTrainer(sym, opt, ctx=tmx.cpu(), remat=remat)
    p, a = tmx.model.params_from_numpy(params, aux, ctx=tmx.cpu())
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    b = tr.shard_batch(data)
    for _ in range(steps):
        p, st, a, outs = tr.step(p, st, a, b)
    return tr, p, st, a, outs


@pytest.mark.parametrize("mirror_blocks", [False, True])
def test_sharded_trainer_remat_bitwise(mirror_blocks):
    """``remat=True`` (the whole walk under one checkpoint) gives the
    parameters, momentum, aux and outputs of ``remat=False`` bit for bit
    after two steps, on ResNet-18; so does a ``mirror_blocks`` ResNet
    (its units recomputed) against the plain one."""
    _js, ts = resnet_symbols()
    with tmx.name.NameManager():
        tm = tmx.models.resnet.get_symbol(10, 18, (3, 16, 16),
                                          mirror_blocks=mirror_blocks)
    runs = [_trainer_run(ts, False), _trainer_run(tm, True),
            _trainer_run(tm, False)]
    assert runs[1][0].remat and not runs[0][0].remat
    for _tr, p, st, a, outs in runs[1:]:
        for got, want in ((p, runs[0][1]), (st, runs[0][2]),
                          (a, runs[0][3])):
            for n in want:
                assert torch.equal(got[n], want[n]), n
        assert torch.equal(outs[0], runs[0][4][0])


def test_remat_keeps_fewer_tensors():
    """Under ``remat=True`` the trainer's walk keeps only what the one
    checkpoint holds for its recompute."""
    _js, ts = resnet_symbols()
    params, aux, data = seeded_resnet(ts)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1)
    values = {k: torch.from_numpy(v) for k, v in
              dict(params, **data).items()}
    auxt = {k: torch.from_numpy(v) for k, v in aux.items()}
    sizes = []
    for remat in (False, True):
        tr = TTrainer(ts, opt, ctx=tmx.cpu(), remat=remat)
        sizes.append(trace_residual_bytes(
            lambda a, x, r, t: tr._trace(a, x, r, t), values, auxt,
            tr.param_names))
    assert sizes[1] < sizes[0] / 4, sizes


def test_sharded_trainer_force_mirroring_matches_jax():
    """The twin of the JAX package's trainer test: attr-tagged mirroring
    on the trainer's path gives the unmirrored parameters (bit for bit
    here), within 1e-5 of the JAX trainer's mirrored run."""
    from mxnet_tpu.parallel import make_mesh
    from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer

    rs = np.random.RandomState(0)
    host = {"data": rs.rand(8, 32).astype(np.float32),
            "softmax_label": rs.randint(0, 32, (8,)).astype(np.float32)}
    shapes = dict(zip(_mlp(tmx, n_layers=4, hidden=32).list_arguments(),
                      _mlp(tmx, n_layers=4, hidden=32).infer_shape(
                          data=(8, 32))[0]))
    init = {n: (rs.rand(*s).astype(np.float32) - 0.5) * 0.5
            for n, s in shapes.items() if n not in host}

    def port(attr):
        sym = _mlp(tmx, attr, n_layers=4, hidden=32)
        opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        tr = TTrainer(sym, opt, ctx=tmx.cpu())
        p, _ = tmx.model.params_from_numpy(init, {}, ctx=tmx.cpu())
        st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
              for n, w in p.items()}
        p, st, _a, _o = tr.step(p, st, {}, tr.shard_batch(host))
        return {k: v.numpy() for k, v in p.items()}

    sym = _mlp(jmx, MIRROR, n_layers=4, hidden=32)
    jtr = JTrainer(sym, jmx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9),
                   make_mesh(jax.devices()[:1], dp=1))
    jp = {k: jax.numpy.asarray(v) for k, v in init.items()}
    jm = {k: jax.numpy.zeros_like(v) for k, v in jp.items()}
    jp, _jm, _ja, _jo = jtr.step(jp, jm, {}, {k: jax.numpy.asarray(v)
                                              for k, v in host.items()})
    plain, mirr = port(None), port(MIRROR)
    for k in plain:
        np.testing.assert_array_equal(plain[k], mirr[k])
        np.testing.assert_allclose(mirr[k], np.asarray(jp[k]), atol=1e-5)


def test_mirrored_step_frees_everything_without_the_collector():
    """A pack hook that returned the saved tensor itself would tie it to
    its own grad_fn in a cycle only the garbage collector frees (on the
    card, memory held past the step): with the collector off, every
    tensor the walk kept and every segment's record (so every recomputed
    copy) is gone once the backward has run.  The ReLUs stay unmirrored
    here, so they keep their own outputs."""
    import gc
    import weakref
    from mxnet_tpu_torch import executor as E
    made = []
    init, keep = E._Recompute.__init__, E._keep

    def tracking(self, *a, **k):
        init(self, *a, **k)
        made.append(weakref.ref(self))

    def kept(t):
        out = keep(t)
        made.append(weakref.ref(out))
        return out
    with tmx.name.NameManager():
        h = tmx.sym.Variable("data")
        for i in range(2):
            h = tmx.sym.Convolution(h, num_filter=8, kernel=(3, 3),
                                    pad=(1, 1), name="conv%d" % i)
            h = tmx.sym.BatchNorm(h, name="bn%d" % i, attr=MIRROR)
            h = tmx.sym.Activation(h, act_type="relu", name="relu%d" % i)
        h = tmx.sym.FullyConnected(tmx.sym.Flatten(h), num_hidden=10,
                                   name="fc")
        sym = tmx.sym.SoftmaxOutput(h, name="softmax")
    prog = build_program(sym)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(4, 3, 8, 8))
    rs = np.random.RandomState(0)
    args = {n: torch.from_numpy(rs.rand(*s).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: torch.zeros(s)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    leaves = {n: args[n].clone().requires_grad_() for n in args
              if n not in ("data", "softmax_label")}
    was = gc.isenabled()
    gc.disable()
    try:
        E._Recompute.__init__, E._keep = tracking, kept
        outs, _ = prog.trace(dict(args, **leaves), aux, None, True)
        assert prog.n_mirrored == 2 and len(made) > 2
        torch.autograd.grad(outs, list(leaves.values()),
                            [torch.ones_like(o) for o in outs],
                            allow_unused=True)      # fix_gamma's gammas
        del outs, _
        assert all(r() is None for r in made)
    finally:
        E._Recompute.__init__, E._keep = init, keep
        if was:
            gc.enable()
