"""The port's Module family against the JAX package, on the CPU.

The twins of ``tests/test_module.py``'s FeedForward, SequentialModule
and Monitor tests, each run by both packages from the same numpy
weights and data (``NDArrayIter``'s shuffle draws from numpy's global
generator, seeded before each run): the parameters after training, and
the scores, predictions and monitor records.  Also a
``PythonLossModule`` inside a ``SequentialModule``, ``Module.load_latest``
and ``do_checkpoint(run_async=True)``.

Tolerance: 1e-5 on parameters, outputs and statistics (float32 sums in
another order, over at most 50 SGD steps of a 10-16-2 MLP).
"""
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_module import _toy_problem

TOL = 1e-5


def _mlp(mx, hidden=16):
    with mx.name.NameManager():
        return mx.models.get_mlp(2, (hidden,))


def _init(hidden=16, seed=11):
    """Numpy weights of the 10-hidden-2 MLP, by name."""
    rng = np.random.RandomState(seed)
    shapes = dict(zip(_mlp(tmx, hidden).list_arguments(),
                      _mlp(tmx, hidden).infer_shape(data=(20, 10))[0]))
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def _arrays(mx, d, ctx):
    return {k: mx.nd.array(v, ctx=ctx) for k, v in d.items()}


def _numpy(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg="%s %s" % (what, k))


def _feedforward(mx, ctx, **kw):
    X, y = _toy_problem()
    return mx.FeedForward(_mlp(mx), ctx=ctx, optimizer="sgd",
                          learning_rate=0.5,
                          arg_params=_arrays(mx, _init(), ctx), **kw), X, y


def test_feedforward_fit_score_predict(tmp_path):
    out = {}
    for mx in (jmx, tmx):
        ctx = mx.cpu()
        model, X, y = _feedforward(mx, ctx, num_epoch=5)
        np.random.seed(0)
        train = mx.io.NDArrayIter(X, y, batch_size=20, shuffle=True)
        val = mx.io.NDArrayIter(X, y, batch_size=20)
        model.fit(train, eval_data=val)
        score = model.score(val)
        pred = model.predict(val)
        prefix = str(tmp_path / ("ff_" + mx.__name__))
        model.save(prefix)
        m2 = mx.FeedForward.load(prefix, 5, ctx=ctx)
        if mx is tmx:      # loaded onto the ctx asked for
            assert all(v.context == ctx for v in m2.arg_params.values())
        out[mx] = (_numpy(model.arg_params), score, pred, m2.score(val),
                   _numpy(m2.arg_params))
    (jp, js, jpred, js2, jp2), (tp, ts, tpred, ts2, tp2) = out[jmx], out[tmx]
    _close(tp, jp, "params")
    _close(tp2, tp, "loaded params")
    assert ts > 0.9 and ts == js and ts2 == ts
    assert tpred.shape == (200, 2)
    np.testing.assert_allclose(tpred, jpred, atol=TOL)


def test_feedforward_epoch_size_exact_multiple():
    """``epoch_size`` equal to the batches a pass: each epoch after the
    first begins with the iterator drained, and the driver resets it."""
    out = {}
    for mx in (jmx, tmx):
        model, X, y = _feedforward(mx, mx.cpu(), num_epoch=3, epoch_size=10)
        model.fit(mx.io.NDArrayIter(X, y, batch_size=20))
        out[mx] = (_numpy(model.arg_params),
                   model.score(mx.io.NDArrayIter(X, y, batch_size=20)))
    _close(out[tmx][0], out[jmx][0], "params")
    assert out[tmx][1] == out[jmx][1] > 0.7


def test_feedforward_numpy_input():
    out = {}
    for mx in (jmx, tmx):
        model, X, y = _feedforward(mx, mx.cpu(), num_epoch=4,
                                   numpy_batch_size=20)
        np.random.seed(1)
        model.fit(X, y)
        out[mx] = (_numpy(model.arg_params), model.predict(X))
    _close(out[tmx][0], out[jmx][0], "params")
    np.testing.assert_allclose(out[tmx][1], out[jmx][1], atol=TOL)
    assert ((out[tmx][1].argmax(axis=1) == _toy_problem()[1]).mean()
            > 0.85)


def test_feedforward_context_and_exports(monkeypatch):
    """``ctx=None`` means ``[current_context()]``: ``gpu(0)`` outside a
    scope; ``mx.FeedForward`` and ``mx.Monitor`` are exported; two
    contexts slice each batch over two executors, whose gradients the
    ``device`` store sums: the JAX package's two-context fit within
    ``TOL``."""
    sym = _mlp(tmx)
    assert tmx.FeedForward(sym).ctx == [tmx.gpu(0)]
    with tmx.cpu():
        assert tmx.FeedForward(sym).ctx == [tmx.cpu()]
    assert tmx.Monitor is tmx.monitor.Monitor
    X, y = _toy_problem()
    out = {}
    for mx in (jmx, tmx):
        model = mx.FeedForward(_mlp(mx), ctx=[mx.cpu(0), mx.cpu(1)],
                               num_epoch=2, optimizer="sgd",
                               learning_rate=0.5, numpy_batch_size=20,
                               arg_params=_arrays(mx, _init(), mx.cpu()))
        np.random.seed(1)
        model.fit(X, y, kvstore="device")
        out[mx] = (_numpy(model.arg_params), model.predict(X))
    _close(out[tmx][0], out[jmx][0], "two contexts")
    np.testing.assert_allclose(out[tmx][1], out[jmx][1], atol=TOL)


def test_feedforward_checkpoint_resume(tmp_path):
    """``checkpoint_prefix`` writes an epoch's checkpoint; ``resume="auto"``
    starts from the newest."""
    prefix = str(tmp_path / "ff")
    model, X, y = _feedforward(tmx, tmx.cpu(), num_epoch=2)
    model.fit(X, y, checkpoint_prefix=prefix)
    assert os.path.exists(prefix + "-0002.params")
    again, _, _ = _feedforward(tmx, tmx.cpu(), num_epoch=3)
    again.fit(X, y, checkpoint_prefix=prefix, resume="auto")
    assert again.begin_epoch == 2
    assert os.path.exists(prefix + "-0003.params")


def _seq(mx, loss_module):
    with mx.name.NameManager():
        net1 = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc1",
                                     num_hidden=8)
        net1 = mx.sym.Activation(net1, act_type="relu")
        net2 = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc2",
                                     num_hidden=2)
        if not loss_module:
            net2 = mx.sym.SoftmaxOutput(net2, name="softmax")
    mod1 = mx.mod.Module(net1, label_names=None, context=mx.cpu())
    seq = mx.mod.SequentialModule()
    if loss_module:
        mod2 = mx.mod.Module(net2, label_names=None, context=mx.cpu())

        def grad(scores, labels):
            s = scores.asnumpy()
            p = np.exp(s - s.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1.0
            return p.astype(np.float32)
        seq.add(mod1).add(mod2, auto_wiring=True).add(
            mx.mod.PythonLossModule(grad_func=grad), take_labels=True,
            auto_wiring=True)
    else:
        mod2 = mx.mod.Module(net2, context=mx.cpu())
        seq.add(mod1).add(mod2, take_labels=True, auto_wiring=True)
    return seq


def _seq_init():
    rng = np.random.RandomState(2)
    return {"fc1_weight": rng.uniform(-0.1, 0.1, (8, 10)),
            "fc1_bias": np.zeros(8), "fc2_weight": rng.uniform(
                -0.1, 0.1, (2, 8)), "fc2_bias": np.zeros(2)}


def _train_seq(mx, loss_module, epochs=3):
    """``PythonLossModule`` puts a numpy gradient on the current context:
    the CPU here."""
    with mx.cpu():
        return _train_seq_on_cpu(mx, loss_module, epochs)


def _train_seq_on_cpu(mx, loss_module, epochs):
    seq = _seq(mx, loss_module)
    X, y = _toy_problem()
    np.random.seed(0)
    train = mx.io.NDArrayIter(X, y, batch_size=20, shuffle=True)
    seq.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    init = {k: mx.nd.array(v.astype(np.float32), ctx=mx.cpu())
            for k, v in _seq_init().items()}
    seq.init_params(arg_params=init, aux_params={}, allow_missing=True)
    seq.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    metric = mx.metric.create("acc")
    for _epoch in range(epochs):
        train.reset()
        metric.reset()
        for batch in train:
            seq.forward_backward(batch)
            seq.update()
            if not loss_module:
                seq.update_metric(metric, batch.label)
    arg, _aux = seq.get_params()
    return _numpy(arg), metric.get()[1]


def test_sequential_module():
    """Two Modules chained, labels to the second, data names wired: the
    parameters and the training accuracy of the JAX package's run."""
    (tp, tacc), (jp, jacc) = _train_seq(tmx, False), _train_seq(jmx, False)
    _close(tp, jp, "params")
    assert tacc == jacc and tacc > 0.8


def test_python_loss_module_in_sequential_module():
    """A ``PythonLossModule`` (softmax cross-entropy's gradient in numpy)
    as the last stage: the same parameters as the JAX package's, and as
    the port's SoftmaxOutput chain."""
    tp, _ = _train_seq(tmx, True)
    jp, _ = _train_seq(jmx, True)
    _close(tp, jp, "params vs JAX")
    ref, _ = _train_seq(tmx, False)
    _close(tp, ref, "params vs SoftmaxOutput")
    loss = tmx.mod.PythonLossModule()
    assert loss.output_names == ["pyloss_output"]
    with pytest.raises(NotImplementedError):
        loss.install_monitor(None)


def _monitor_records(mx, **mon_kw):
    mod = mx.mod.Module(_mlp(mx, 8), context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    mon = mx.Monitor(**mon_kw)
    mod.install_monitor(mon)
    mod.init_params(arg_params=_arrays(mx, _init(8), mx.cpu()))
    batch = mx.io.DataBatch(data=[mx.nd.ones((4, 10), ctx=mx.cpu())],
                            label=[mx.nd.zeros((4,), ctx=mx.cpu())])
    mon.tic()
    mod.forward(batch, is_train=False)
    return mod, mon, mon.toc()


@pytest.mark.parametrize("pattern,sort", [(".*weight", False), (".*", True),
                                          ("fc.*_output", False)])
def test_monitor(pattern, sort):
    """The records of one monitored forward: the op outputs and, at
    ``toc``, the bound arguments that match, as the JAX package's."""
    _m, _mon, got = _monitor_records(tmx, interval=1, pattern=pattern,
                                     sort=sort)
    _m, _mon, want = _monitor_records(jmx, interval=1, pattern=pattern,
                                      sort=sort)
    assert len(got) > 0
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    for (_, name, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(float(g.split("\t")[0]),
                                   float(w.split("\t")[0]), rtol=1e-5,
                                   err_msg=name)


def test_monitor_through_fit_and_nonfinite(caplog):
    """``fit(monitor=...)`` ticks every batch (its forward_backward, as in
    the JAX package, reports the arguments at ``toc``); ``interval``
    skips batches; ``alarm_nonfinite`` records a NaN statistic."""
    X, y = _toy_problem(n=40)
    logs = {}
    for mx in (jmx, tmx):
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mon = mx.Monitor(interval=2, pattern=".*weight")
        seen = []
        mon.toc_print = lambda m=mon, s=seen: s.extend(m.toc())
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=10), num_epoch=1,
                monitor=mon, optimizer_params={"learning_rate": 0.1},
                arg_params=_arrays(mx, _init(), mx.cpu()))
        logs[mx] = seen
    assert [(s, n) for s, n, _ in logs[tmx]] \
        == [(s, n) for s, n, _ in logs[jmx]] \
        == [(1, "fc1_weight"), (1, "fc2_weight"), (3, "fc1_weight"),
            (3, "fc2_weight")]
    with caplog.at_level(logging.WARNING):
        mod, mon, recs = _monitor_records(tmx, interval=1, pattern=".*",
                                          alarm_nonfinite=True,
                                          stat_func=lambda a: float("nan"))
    assert recs and mon.nonfinite_records
    assert "NON-FINITE" in caplog.text
    # a monitored Module takes the unfused step, as in the JAX package
    mod.init_optimizer(optimizer="sgd")
    assert not mod._fused_step_ok()


def test_module_load_latest(tmp_path):
    prefix = str(tmp_path / "mlp")
    assert tmx.mod.Module.load_latest(prefix) == (None, None)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (20, 10))],
             label_shapes=[("softmax_label", (20,))])
    mod.init_params(arg_params=_arrays(tmx, _init(), tmx.cpu()))
    with tmx.cpu():
        mod.save_checkpoint(prefix, 1)
        mod.save_checkpoint(prefix, 3)
        loaded, epoch = tmx.mod.Module.load_latest(prefix,
                                                   context=tmx.cpu())
    assert epoch == 3 and loaded.params_initialized
    jloaded, jepoch = jmx.mod.Module.load_latest(prefix)
    assert jepoch == 3
    for k, v in _init().items():
        np.testing.assert_array_equal(loaded._arg_params[k].asnumpy(), v)
        np.testing.assert_array_equal(jloaded._arg_params[k].asnumpy(), v)


def test_do_checkpoint_async_writes_the_same_bytes(tmp_path):
    """``run_async=True`` pushes the write through the engine: after
    ``wait_for_all`` the files are byte for byte the synchronous ones,
    and snapshot the parameters of the epoch that asked."""
    params = _arrays(tmx, _init(), tmx.cpu())
    sym = _mlp(tmx)
    sync = tmx.callback.do_checkpoint(str(tmp_path / "sync"))
    asyn = tmx.callback.do_checkpoint(str(tmp_path / "async"),
                                      run_async=True)
    sync(0, sym, params, {})
    asyn(0, sym, params, {})
    for v in params.values():
        v[:] = 0.0                   # the loop moves on
    tmx.engine.get().wait_for_all()
    for suffix in ("-0001.params", "-symbol.json"):
        with open(str(tmp_path / "sync") + suffix, "rb") as f:
            a = f.read()
        with open(str(tmp_path / "async") + suffix, "rb") as f:
            b = f.read()
        assert a == b, suffix
    skip = tmx.callback.do_checkpoint(str(tmp_path / "p2"), period=2,
                                      run_async=True)
    skip(0, sym, params, {})
    tmx.engine.get().wait_for_all()
    assert not os.path.exists(str(tmp_path / "p2") + "-0001.params")
