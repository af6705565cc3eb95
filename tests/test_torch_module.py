"""The port's Module path against the JAX package, on the CPU.

``io.NDArrayIter``, ``metric``, the ``local`` kvstore, ``Module.fit`` and
the checkpoint files of ``mxnet_tpu_torch``, each with the same numpy
inputs (float32, from a seed) as ``mxnet_tpu``'s.

``Module.fit`` trains ResNet-18 at (3, 16, 16) (10 classes, batches of
4, SGD lr 0.1, momentum 0.9, wd 1e-4, rescale_grad 1/4 as ``Module``
sets it) from the same weights and aux, with a ``KVStore("local")``
object (the update on the store) and with ``kvstore=None`` (the fused
step).  Tolerances: parameters and aux within 1e-5 of the JAX package's
``Module.fit`` after one batch, and after two batches within 1e-5 of
the JAX package's same two steps run in float64 (its float32 steps
drift 6e-5 from float64 at the second step: see
``test_torch_resnet_train``); the port's two routes within 1e-5 of each
other.  Iterators, metrics, the store's sums and the checkpoint bytes
are exact.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

from test_torch_resnet_train import (CLASSES, SGD, SHAPE, jax_reference,
                                     seeded_resnet)

TOL = 1e-5
B = 4
OPT_PARAMS = {"learning_rate": SGD["learning_rate"],
              "momentum": SGD["momentum"], "wd": SGD["wd"]}


# ----------------------------------------------------------------------
# NDArrayIter
# ----------------------------------------------------------------------
def _batches(it):
    out = []
    for batch in it:
        out.append(([d.asnumpy() for d in batch.data],
                    [lab.asnumpy() for lab in batch.label], batch.pad))
    return out


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 11)])
def test_ndarray_iter_matches_jax(handle, shuffle, seed):
    """The same batches, labels and pads, over two epochs (a seeded
    shuffle reshuffles at each reset), and the same provide_data and
    provide_label; the port's batches are host arrays."""
    rng = np.random.RandomState(0)
    x = rng.randn(10, 3, 2).astype(np.float32)
    y = rng.randint(0, 5, 10).astype(np.float32)
    kw = dict(batch_size=4, shuffle=shuffle, last_batch_handle=handle,
              seed=seed)
    jit, tit = jmx.io.NDArrayIter(x, y, **kw), tmx.io.NDArrayIter(x, y, **kw)
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    for _epoch in range(2):
        got, want = _batches(tit), _batches(jit)
        assert len(got) == len(want)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gp == wp
            for a, b in zip(gd + gl, wd + wl):
                np.testing.assert_array_equal(a, b)
        tit.reset()
        jit.reset()
    batch = next(iter(tmx.io.NDArrayIter(x, y, batch_size=4)))
    assert batch.data[0].context == tmx.cpu()


def test_ndarray_iter_dict_inputs_and_state():
    rng = np.random.RandomState(1)
    data = {"a": rng.randn(6, 2).astype(np.float32),
            "b": rng.randn(6, 3).astype(np.float32)}
    it = tmx.io.NDArrayIter(data, None, batch_size=3, shuffle=True, seed=2)
    assert sorted(d.name for d in it.provide_data) == ["a", "b"]
    assert it.provide_label == []
    first = _batches(it)
    it.set_state({"epoch": 0, "cursor": -3})
    assert all(np.array_equal(a, b) for x, y in zip(first, _batches(it))
               for a, b in zip(x[0], y[0]))
    with pytest.raises(MXNetError):
        tmx.io.NDArrayIter(data, None, batch_size=3, num_parts=2,
                           shuffle=True)


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [("acc", {}), ("ce", {}),
                                     ("top_k_accuracy", {"top_k": 3}),
                                     ("mse", {}), ("perplexity", {})])
def test_metrics_match_jax(name, kw):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 8, 5)
    preds = [np.exp(p) / np.exp(p).sum(1, keepdims=True) for p in logits]
    labels = [rng.randint(0, 5, 8).astype(np.float32) for _ in range(2)]
    if name == "mse":
        labels = [p[:, 0] for p in preds]
        preds = [p[:, :1] for p in preds]
    jm, tm = jmx.metric.create(name, **kw), tmx.metric.create(name, **kw)
    jm.update([jmx.nd.array(a) for a in labels],
              [jmx.nd.array(p.astype(np.float32)) for p in preds])
    tm.update([tmx.nd.array(a, ctx=tmx.cpu()) for a in labels],
              [tmx.nd.array(p.astype(np.float32), ctx=tmx.cpu())
               for p in preds])
    (gn, gv), (wn, wv) = tm.get(), jm.get()
    assert gn == wn
    assert gv == pytest.approx(wv, rel=1e-6)
    comp = tmx.metric.create(["acc", "ce"])
    assert [n for n, _ in comp.get_name_value()] == ["accuracy",
                                                     "cross-entropy"]


# ----------------------------------------------------------------------
# kvstore
# ----------------------------------------------------------------------
def test_kvstore_local_push_pull_and_optimizer():
    """init, push (copies summed), pull into several arrays, an updater
    run on the sum and the stored weight; set_optimizer against the JAX
    package's store over 3 pushes; rank 0, one worker; ``dist_sync``
    with no launch env is a store of one worker, which sums as local."""
    rng = np.random.RandomState(4)
    with tmx.cpu():
        kv = tmx.kvstore.create("local")
        assert (kv.type, kv.rank, kv.num_workers) == ("local", 0, 1)
        w0 = rng.randn(3, 4).astype(np.float32)
        kv.init(3, tmx.nd.array(w0))
        g = [rng.randn(3, 4).astype(np.float32) for _ in range(2)]
        kv.push(3, [tmx.nd.array(a) for a in g])
        outs = [tmx.nd.zeros((3, 4)) for _ in range(2)]
        kv.pull(3, out=outs)
        for o in outs:
            np.testing.assert_array_equal(o.asnumpy(), g[0] + g[1])
        with pytest.raises(MXNetError):
            kv.init(3, tmx.nd.array(w0))
        with pytest.raises(MXNetError):
            kv.push(9, tmx.nd.array(w0))
    with tmx.cpu():
        dkv = tmx.kvstore.create("dist_sync")
        assert (dkv.type, dkv.rank, dkv.num_workers) == ("dist_sync", 0, 1)
        dkv.init(3, tmx.nd.array(w0))
        dkv.push(3, [tmx.nd.array(a) for a in g])
        out = tmx.nd.zeros((3, 4))
        dkv.pull(3, out=out)
        np.testing.assert_array_equal(out.asnumpy(), g[0] + g[1])
        assert dkv.dead_nodes() == []
    with pytest.raises(MXNetError):
        tmx.kvstore.create("bogus")

    jkv, tkv = jmx.kvstore.create("local"), tmx.kvstore.create("device")
    for kv, mx in ((jkv, jmx), (tkv, tmx)):
        kv.set_optimizer(mx.optimizer.create("adam", learning_rate=0.01,
                                             rescale_grad=0.5))
    ctx = {"ctx": tmx.cpu()}
    jkv.init(["a", "b"], [jmx.nd.array(w0), jmx.nd.array(w0 * 2)])
    tkv.init(["a", "b"], [tmx.nd.array(w0, **ctx),
                          tmx.nd.array(w0 * 2, **ctx)])
    for _ in range(3):
        gs = [rng.randn(3, 4).astype(np.float32) for _ in range(2)]
        jkv.push_async(["a", "b"], [jmx.nd.array(a) for a in gs])
        tkv.push_async(["a", "b"], [tmx.nd.array(a, **ctx) for a in gs])
        jkv.wait_all()
        tkv.wait_all()
    jo = [jmx.nd.zeros((3, 4)) for _ in range(2)]
    to = [tmx.nd.zeros((3, 4), **ctx) for _ in range(2)]
    jkv.pull(["a", "b"], out=jo)
    tkv.pull(["a", "b"], out=to)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=0,
                                   atol=1e-6)


def test_kvstore_optimizer_states_round_trip(tmp_path):
    rng = np.random.RandomState(5)
    with tmx.cpu():
        kv = tmx.kvstore.create("local")
        kv.set_optimizer(tmx.optimizer.create("sgd", momentum=0.9))
        kv.init(0, tmx.nd.array(rng.randn(4).astype(np.float32)))
        kv.push(0, tmx.nd.array(rng.randn(4).astype(np.float32)))
        fname = str(tmp_path / "kv.states")
        kv.save_optimizer_states(fname)
        kv2 = tmx.kvstore.create("local")
        kv2.load_optimizer_states(fname)
        np.testing.assert_array_equal(
            kv2._updater.states[0].asnumpy(),
            kv._updater.states[0].asnumpy())
        assert kv2._updater.optimizer.momentum == 0.9


# ----------------------------------------------------------------------
# Module.fit
# ----------------------------------------------------------------------
def _data(n_batches):
    sym = tmx.models.resnet.get_symbol(CLASSES, 18, SHAPE)
    params, aux, _ = seeded_resnet(sym)
    rng = np.random.RandomState(6)
    x = rng.randn(n_batches * B, *SHAPE).astype(np.float32)
    y = rng.randint(0, CLASSES, n_batches * B).astype(np.float32)
    return params, aux, x, y


def _fit(mx, kvstore, n_batches, ctx=None, **fit_kw):
    params, aux, x, y = _data(n_batches)
    sym = mx.models.resnet.get_symbol(CLASSES, 18, SHAPE)
    kw = {} if ctx is None else {"context": ctx}
    mod = mx.mod.Module(sym, **kw)
    if kvstore == "object":
        kvstore = mx.kvstore.KVStore("local")
    arrays = (lambda d: {k: mx.nd.array(v, ctx=ctx) for k, v in d.items()}) \
        if ctx is not None else \
        (lambda d: {k: mx.nd.array(v) for k, v in d.items()})
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=B), num_epoch=1,
            kvstore=kvstore, optimizer="sgd", optimizer_params=OPT_PARAMS,
            arg_params=arrays(params), aux_params=arrays(aux), **fit_kw)
    arg, auxp = mod.get_params()
    return mod, ({k: v.asnumpy() for k, v in arg.items()},
                 {k: v.asnumpy() for k, v in auxp.items()})


def _close_all(got, want, what):
    for part, g, w in zip(("param", "aux"), got, want):
        assert set(g) == set(w), what
        for n in w:
            err = float(np.abs(np.asarray(g[n], np.float64)
                               - np.asarray(w[n], np.float64)).max())
            assert err <= TOL, "%s %s %s: %g" % (what, part, n, err)


@pytest.mark.parametrize("kvstore", ["object", None])
def test_module_fit_matches_jax(monkeypatch, kvstore):
    """``Module.fit`` on ResNet-18: one batch against the JAX package's
    ``Module.fit``, two batches against its steps in float64; the route
    (update on the store, or the fused step) as in the JAX package.  (The
    JAX executor's bind-time graph lint is off: it checks the graph, not
    the numbers.)"""
    monkeypatch.setenv("MXTPU_BIND_VALIDATE", "off")
    tmod, got1 = _fit(tmx, kvstore, 1, ctx=tmx.cpu())
    jmod, want1 = _fit(jmx, kvstore, 1)
    assert tmod._update_on_kvstore == jmod._update_on_kvstore \
        == (kvstore is not None)
    assert tmod._fused_step_ok() == jmod._fused_step_ok() \
        == (kvstore is None)
    _close_all(got1, want1, "1 batch vs JAX Module.fit")
    _, got2 = _fit(tmx, kvstore, 2, ctx=tmx.cpu())
    params, aux, x, y = _data(2)
    js = jmx.models.resnet.get_symbol(CLASSES, 18, SHAPE)
    batches = [{"data": x[i * B:(i + 1) * B],
                "softmax_label": y[i * B:(i + 1) * B]} for i in range(2)]
    want = jax_reference("module64", js, params, aux, batches,
                         np.float64)[-1]
    _close_all(got2, (want[1], want[3]), "2 batches vs JAX float64")


def test_module_routes_agree_and_predict():
    """The port's two update routes after two batches within 1e-5 of each
    other; ``score`` and ``predict`` after fit; a fixed parameter keeps
    its value; two contexts bind one sharded executor."""
    mod, by_store = _fit(tmx, "object", 2, ctx=tmx.cpu(),
                         eval_metric="acc",
                         batch_end_callback=tmx.callback.Speedometer(B, 1))
    _, fused = _fit(tmx, None, 2, ctx=tmx.cpu())
    _close_all(by_store, fused, "store vs fused")
    params, aux, x, y = _data(2)
    it = tmx.io.NDArrayIter(x, y, batch_size=B)
    (name, acc), = mod.score(it, "acc")
    assert name == "accuracy" and 0.0 <= acc <= 1.0
    probs = mod.predict(it)
    assert probs.shape == (2 * B, CLASSES)
    np.testing.assert_allclose(probs.asnumpy().sum(1), 1.0, rtol=1e-5)
    fixed = tmx.mod.Module(tmx.models.resnet.get_symbol(CLASSES, 18, SHAPE),
                           context=tmx.cpu(),
                           fixed_param_names=["fc1_bias"])
    fixed.fit(tmx.io.NDArrayIter(x, y, batch_size=B), num_epoch=1,
              optimizer_params=OPT_PARAMS,
              arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                          for k, v in params.items()},
              aux_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                          for k, v in aux.items()})
    np.testing.assert_array_equal(fixed.get_params()[0]["fc1_bias"]
                                  .asnumpy(), params["fc1_bias"])
    m = tmx.mod.Module(tmx.models.resnet.get_symbol(CLASSES, 18, SHAPE),
                       context=[tmx.cpu(0), tmx.cpu(1)])
    m.bind([("data", (B,) + SHAPE)], [("softmax_label", (B,))])
    assert m._exec_group.sharded and len(m._exec_group.execs) == 1


def test_checkpoints_load_across_packages(tmp_path):
    """``save_checkpoint`` of either package loads in the other, the
    symbol and every array bit for bit (the 0x112 file, ``arg:``/``aux:``
    keys); ``Module.save_checkpoint``/``Module.load`` and the
    ``do_checkpoint`` callback write the same files."""
    params, aux, x, y = _data(1)
    jsym = jmx.models.resnet.get_symbol(CLASSES, 18, SHAPE)
    tsym = tmx.models.resnet.get_symbol(CLASSES, 18, SHAPE)
    jp = str(tmp_path / "jax")
    tp = str(tmp_path / "port")
    jmx.model.save_checkpoint(
        jp, 3, jsym, {k: jmx.nd.array(v) for k, v in params.items()},
        {k: jmx.nd.array(v) for k, v in aux.items()})
    with tmx.cpu():
        tmx.model.save_checkpoint(
            tp, 3, tsym, {k: tmx.nd.array(v) for k, v in params.items()},
            {k: tmx.nd.array(v) for k, v in aux.items()})
        s1, a1, x1 = tmx.model.load_checkpoint(jp, 3)
    s2, a2, x2 = jmx.model.load_checkpoint(tp, 3)
    assert s1.list_arguments() == s2.list_arguments() == \
        jsym.list_arguments()
    for got, want in ((a1, params), (x1, aux), (a2, params), (x2, aux)):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].asnumpy(), v)
    with open(jp + "-0003.params", "rb") as f, \
            open(tp + "-0003.params", "rb") as g:
        jbytes, tbytes = f.read(), g.read()
    assert len(jbytes) == len(tbytes)

    mod, _ = _fit(tmx, None, 1, ctx=tmx.cpu())
    mp = str(tmp_path / "mod")
    mod.save_checkpoint(mp, 1, save_optimizer_states=True)
    with tmx.cpu():
        back = tmx.mod.Module.load(mp, 1, load_optimizer_states=True,
                                   context=tmx.cpu())
    arg, _ = mod.get_params()
    for k, v in arg.items():
        np.testing.assert_array_equal(back._arg_params[k].asnumpy(),
                                      v.asnumpy())
    jsym2, jarg, _ = jmx.model.load_checkpoint(mp, 1)
    for k, v in arg.items():
        np.testing.assert_array_equal(jarg[k].asnumpy(), v.asnumpy())
    cb = tmx.callback.do_checkpoint(str(tmp_path / "cb"))
    with tmx.cpu():
        cb(0, tsym, {k: tmx.nd.array(v) for k, v in params.items()},
           {k: tmx.nd.array(v) for k, v in aux.items()})
    assert os.path.exists(str(tmp_path / "cb-0001.params"))
