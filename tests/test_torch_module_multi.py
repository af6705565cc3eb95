"""``Module`` and ``FeedForward`` on several contexts, against the JAX
package, on the CPU.

The twins of ``tests/test_module.py``'s multi-context tests (``FeedForward``
on two contexts: ``test_torch_module_family.py``).  The JAX
side runs on the 8 fake CPU devices of ``tests/conftest.py``; the
port's contexts ``cpu(0)`` ... ``cpu(7)`` share the one CPU.  Both
packages pick the same mode: several distinct contexts bind one sharded
executor (the batch split over them inside the step, the gradients
summed in the backward, BatchNorm over the whole batch); a repeated
context, or ``MXNET_MODULE_SHARDED=0``, slices the batch over one
executor a context (each its own BatchNorm statistics, the gradients
summed by the kvstore).  Both start from the same numpy weights and
shuffle with numpy's global generator, seeded alike.

Tolerances: 2e-6 of each tensor's max-abs (at least 1) for the MLP's
parameters after ``fit`` and for ResNet-18 at 32 x 32 (float32, one
batch of 4: outputs, parameters and BatchNorm statistics) against the
JAX package (float32 sums in other orders); the port's sharded
ResNet-18 step against its one-context step 5e-5 (BatchNorm's batch
statistics summed over two replicas against one pass).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_module import _toy_problem

TOL = 2e-6


def _init(mx, net, batch, seed=11):
    rng = np.random.RandomState(seed)
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(batch, 10))[0]))
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def _fit(mx, ctx, X, y, batch, epochs, kvstore, opt, shuffle=False,
         sharded=None, monkeypatch=None, hidden=(8,)):
    if monkeypatch is not None and sharded is not None:
        monkeypatch.setenv("MXNET_MODULE_SHARDED", sharded)
    with mx.name.NameManager():
        net = mx.models.get_mlp(num_classes=2, hidden=hidden)
    np.random.seed(0)
    train = mx.io.NDArrayIter(X, y, batch_size=batch, shuffle=shuffle)
    mod = mx.mod.Module(net, context=ctx)
    cpu = mx.cpu()
    mod.fit(train, kvstore=kvstore, optimizer="sgd", optimizer_params=opt,
            arg_params={k: mx.nd.array(v, ctx=cpu)
                        for k, v in _init(mx, net, batch).items()},
            num_epoch=epochs)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _close(got, want, tol=TOL, what=""):
    assert set(got) == set(want), what
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        err = float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
        assert err <= tol * scale, (what, k, err)


def test_module_multi_context_slicing(monkeypatch):
    """``[cpu(0), cpu(1)]``: the JAX twin's fit (3 epochs, shuffled)
    reaches its accuracy, in both packages' sharded mode and with
    ``MXNET_MODULE_SHARDED=0`` in both slicing modes; the port's
    parameters are the JAX package's in each."""
    X, y = _toy_problem()
    opt = {"learning_rate": 0.5}
    for sharded in ("1", "0"):
        got = {}
        for mx in (jmx, tmx):
            mod, got[mx] = _fit(mx, [mx.cpu(0), mx.cpu(1)], X, y, 20, 3,
                                "local", opt, shuffle=True, sharded=sharded,
                                monkeypatch=monkeypatch, hidden=(16,))
            assert mod._exec_group.sharded == (sharded == "1")
            assert len(mod._exec_group.execs) == (1 if sharded == "1"
                                                  else 2)
            val = mx.io.NDArrayIter(X, y, batch_size=20)
            score = dict(mod.score(val, "acc"))
            assert score["accuracy"] > 0.85, score
        _close(got[tmx], got[jmx], what="sharded=%s" % sharded)


def test_repeated_context_slices(monkeypatch):
    """The same context twice slices in both packages (one executor a
    context, the ``device`` store summing their gradients on the store's
    device), and equals the one-context fit at the same batch."""
    monkeypatch.delenv("MXNET_MODULE_SHARDED", raising=False)
    X, y = _toy_problem(n=120)
    opt = {"learning_rate": 0.2, "momentum": 0.9}
    got = {}
    for mx in (jmx, tmx):
        mod, got[mx] = _fit(mx, [mx.cpu(0), mx.cpu(0)], X, y, 30, 2,
                            "device", opt)
        assert not mod._exec_group.sharded
        assert len(mod._exec_group.execs) == 2
        assert mod._update_on_kvstore
    _close(got[tmx], got[jmx], what="repeated context")
    _, one = _fit(tmx, tmx.cpu(), X, y, 30, 2, None, opt)
    _close(got[tmx], one, what="two slices against one context")


def test_sharded_multi_device_fused_fit():
    """Over 8 contexts with the ``device`` store: one sharded executor,
    one fused step a batch (the gradient sum inside it), no separate
    forward-backward, and the JAX twin's accuracy and parameters."""
    X, y = _toy_problem()
    n_batches = len(X) // 40
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    got = {}
    for mx in (jmx, tmx):
        mod, got[mx] = _fit(mx, [mx.cpu(i) for i in range(8)], X, y, 40, 4,
                            "device", opt, hidden=(16,))
        group = mod._exec_group
        assert group.sharded and len(group.execs) == 1
        exec_ = group.execs[0]
        assert exec_._n_fused_step == 4 * n_batches
        assert exec_._n_fwd_bwd == 0
        assert mod._kv_inline and mod._fused_step_ok()
        score = dict(mod.score(mx.io.NDArrayIter(X, y, batch_size=40),
                               "acc"))
        assert score["accuracy"] > 0.9, score
    _close(got[tmx], got[jmx], what="8 contexts")


def test_sharded_matches_single_device():
    """Same data, same initial weights: 8-context training equals one
    context (the summed gradient is the global batch's), in both
    packages, and the port equals the JAX package."""
    X, y = _toy_problem(n=128)
    opt = {"learning_rate": 0.2, "momentum": 0.9}
    res = {}
    for mx in (jmx, tmx):
        for tag, ctx in (("one", mx.cpu()),
                         ("mesh", [mx.cpu(i) for i in range(8)])):
            _, res[mx, tag] = _fit(mx, ctx, X, y, 32, 2,
                                   "device" if tag == "mesh" else None, opt)
    for mx in (jmx, tmx):
        _close(res[mx, "mesh"], res[mx, "one"], 2e-5, "mesh against one")
    _close(res[tmx, "mesh"], res[jmx, "mesh"], what="port against JAX")


def _resnet_module(mx, ctx, params, aux, batch):
    sym = mx.models.resnet.get_symbol(10, 18, (3, 32, 32))
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", batch["data"].shape)],
             [("softmax_label", batch["softmax_label"].shape)])
    cpu = mx.cpu()
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params.items()},
                    aux_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in aux.items()})
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    db = mx.io.DataBatch(data=[mx.nd.array(batch["data"], ctx=cpu)],
                         label=[mx.nd.array(batch["softmax_label"],
                                            ctx=cpu)])
    mod.forward_backward(db)
    mod.update()
    out = mod.get_outputs()[0].asnumpy()
    arg, auxp = mod.get_params()
    return mod, out, {k: v.asnumpy() for k, v in arg.items()}, \
        {k: v.asnumpy() for k, v in auxp.items()}


@pytest.mark.parametrize("ctxs", ["sharded", "slicing"])
def test_resnet_batchnorm_in_both_modes(ctxs):
    """ResNet-18 at 32 x 32 over two contexts, one batch of 4, against
    the JAX package in the same mode: in the sharded mode BatchNorm
    normalises over the whole batch (and the port's one-context step
    agrees with it), in the slicing mode each context over its half, the
    parameters and moving statistics averaged over the contexts."""
    from test_torch_resnet_train import seeded_resnet
    sym = tmx.models.resnet.get_symbol(10, 18, (3, 32, 32))
    params, aux, batch = seeded_resnet(sym, seed=3, batch=4,
                                       image_shape=(3, 32, 32))
    got = {}
    for mx in (jmx, tmx):
        ctx = [mx.cpu(0), mx.cpu(1)] if ctxs == "sharded" \
            else [mx.cpu(0), mx.cpu(0)]
        mod, out, p, a = _resnet_module(mx, ctx, params, aux, batch)
        assert mod._exec_group.sharded == (ctxs == "sharded")
        got[mx] = (out, p, a)
    np.testing.assert_allclose(got[tmx][0], got[jmx][0], atol=TOL)
    _close(got[tmx][1], got[jmx][1], TOL, "parameters")
    _close(got[tmx][2], got[jmx][2], TOL, "moving statistics")
    if ctxs == "sharded":
        _, out1, p1, a1 = _resnet_module(tmx, tmx.cpu(), params, aux, batch)
        _close(got[tmx][2], a1, 5e-5, "sharded against one context")
