"""BucketingModule, the shared executor group and FeedForward's
``sym_gen`` of the port against the JAX package, on the CPU.

- The twin of ``tests/test_module.py::test_bucketing_module``: the same
  embedding-and-sum network through buckets 12, 8, 12, 8 from the same
  numpy parameters; the trained parameters within 1e-5 (float32, four
  SGD steps).
- Shared storage: every bucket's executor holds the default bucket's
  parameter and gradient tensors, its inputs view the head of the
  default bucket's input buffers, the buckets share one optimizer,
  updater and fused-step state, and a program is built once a bucket.
- ``BucketingModule.fit`` of the unrolled LSTM (2 layers, hidden 8,
  vocab 20) over buckets 4, 6 and 8 of the example's synthetic corpus,
  and ``FeedForward`` with ``sym_gen`` on the same corpus: the trained
  parameters against the JAX package's, both in float32, within 1e-5
  of the larger of 1 and each parameter's max-abs (a few SGD steps;
  float32 drift stays two orders below that here, so no float64 run
  is needed).
- ``BucketSentenceIter`` of ``example/rnn-torch/bucket_io.py`` against
  the JAX example's (the same batches, bucket keys and shapes, the
  checks of ``tests/test_examples.py::test_bucket_sentence_iter``).
- ``example/rnn-torch/lstm_bucketing.py --cpu`` at tiny sizes and
  ``example/bi-lstm-sort-torch/sort_io.py --cpu`` (to its accuracy
  line) in subprocesses with JAX blocked.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _load(path, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(os.path.join(REPO, path)))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
    return mod


J_BUCKET_IO = _load("example/rnn/bucket_io.py", "j_bucket_io")
T_BUCKET_IO = _load("example/rnn-torch/bucket_io.py", "t_bucket_io")


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: max err %g > %g x %g" % (
        what, err, tol, scale)


# ----------------------------------------------------------------------
# the twin of tests/test_module.py::test_bucketing_module
# ----------------------------------------------------------------------
def _pooled_sym_gen(mx):
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, name="embed", input_dim=20,
                                 output_dim=6)
        pooled = mx.sym.sum_axis(embed, axis=1)
        fc = mx.sym.FullyConnected(pooled, name="fc", num_hidden=4)
        net = mx.sym.SoftmaxOutput(fc, label=label, name="softmax")
        return net, ("data",), ("softmax_label",)
    return sym_gen


def _pooled_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"embed_weight": rng.uniform(-0.1, 0.1, (20, 6)),
            "fc_weight": rng.uniform(-0.1, 0.1, (4, 6)),
            "fc_bias": rng.uniform(-0.1, 0.1, (4,))}


def _pooled_run(mx, ctx, buckets=(12, 8, 12, 8), batch_size=8,
                fused=False):
    """The test's bucket sequence: forward, backward and update, or
    with ``fused`` ``forward_backward`` (the fused step) and update."""
    rng = np.random.RandomState(5)
    mod = mx.mod.BucketingModule(_pooled_sym_gen(mx), default_bucket_key=12,
                                 context=ctx)
    mod.bind(data_shapes=[("data", (batch_size, 12))],
             label_shapes=[("softmax_label", (batch_size,))])
    mod.init_params(arg_params={
        k: mx.nd.array(v.astype(np.float32), ctx=ctx)
        for k, v in _pooled_params().items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    for seq_len in buckets:
        data = rng.randint(0, 20, (batch_size, seq_len)).astype(np.float32)
        label = rng.randint(0, 4, (batch_size,)).astype(np.float32)
        batch = mx.io.DataBatch(
            data=[mx.nd.array(data, ctx=ctx)],
            label=[mx.nd.array(label, ctx=ctx)],
            provide_data=[("data", (batch_size, seq_len))],
            provide_label=[("softmax_label", (batch_size,))],
            bucket_key=seq_len)
        if fused:
            mod.forward_backward(batch)
        else:
            mod.forward(batch, is_train=True)
            mod.backward()
        mod.update()
    return mod


def test_bucketing_module_matches_jax():
    jmod = _pooled_run(jmx, jmx.cpu())
    tmod = _pooled_run(tmx, tmx.cpu())
    assert tmod.get_outputs()[0].shape == (8, 4)
    _close(tmod.get_outputs()[0].asnumpy(), jmod.get_outputs()[0].asnumpy(),
           "outputs")
    jarg, _ = jmod.get_params()
    targ, _ = tmod.get_params()
    assert sorted(targ) == sorted(jarg) == ["embed_weight", "fc_bias",
                                            "fc_weight"]
    for name in jarg:
        _close(targ[name].asnumpy(), jarg[name].asnumpy(), name)
    # the updates moved the parameters
    assert not np.allclose(targ["fc_weight"].asnumpy(),
                           _pooled_params()["fc_weight"])


def test_buckets_share_storage_and_optimizer():
    stats0 = tmx.executor.program_registry_stats()
    mod = _pooled_run(tmx, tmx.cpu(), buckets=(12, 8, 5, 12, 8, 5),
                      fused=True)
    stats1 = tmx.executor.program_registry_stats()
    assert sorted(mod._buckets) == [5, 8, 12]
    base = mod._buckets[12]
    bexec = base._exec_group.execs[0]
    for key in (8, 5):
        child = mod._buckets[key]
        ex = child._exec_group.execs[0]
        for name in ("embed_weight", "fc_weight", "fc_bias"):
            assert ex.arg_dict[name] is bexec.arg_dict[name]
            assert ex.arg_dict[name].data.data_ptr() == \
                bexec.arg_dict[name].data.data_ptr()
            assert ex.grad_dict[name].data.data_ptr() == \
                bexec.grad_dict[name].data.data_ptr()
        # inputs view the head of the default bucket's buffers
        for name in ("data", "softmax_label"):
            assert ex.arg_dict[name].data.data_ptr() == \
                bexec.arg_dict[name].data.data_ptr()
        assert ex.arg_dict["data"].shape == (8, key)
        assert child._optimizer is base._optimizer
        assert child._updater is base._updater
        assert child._fused_holder is base._fused_holder
    # the fused step ran on every visit, counting in the one holder
    assert base._fused_holder["num_update"] == 6
    assert base._exec_group.execs[0]._n_fused_step == 2
    # one program a bucket, built on its first visit only (the registry
    # is process-wide: other tests may have built these graphs already)
    assert stats1["misses"] - stats0["misses"] <= 3
    assert stats1["hits"] + stats1["misses"] - stats0["hits"] \
        - stats0["misses"] == 3
    # an update through one bucket is visible through every other
    w = bexec.arg_dict["fc_weight"].asnumpy()
    np.testing.assert_array_equal(
        mod._buckets[5]._exec_group.execs[0].arg_dict["fc_weight"].asnumpy(),
        w)
    np.testing.assert_array_equal(mod.get_params()[0]["fc_weight"].asnumpy(),
                                  w)


def test_shared_data_array_grows_for_a_larger_bucket():
    """A bucket larger than the stored input buffer gets its own, which
    later smaller buckets view."""
    from mxnet_tpu_torch.executor_manager import _bind_exec
    sym, _, _ = _pooled_sym_gen(tmx)(4)
    shared = {}
    small = _bind_exec(sym, tmx.cpu(), {"data": (2, 4),
                                        "softmax_label": (2,)},
                       ["embed_weight", "fc_weight", "fc_bias"],
                       need_grad=True, shared_data_arrays=shared)
    big = _bind_exec(sym, tmx.cpu(), {"data": (2, 9),
                                      "softmax_label": (2,)},
                     ["embed_weight", "fc_weight", "fc_bias"],
                     need_grad=True, base_exec=small,
                     shared_data_arrays=shared)
    assert shared["data"].shape == (2, 9)
    assert big.arg_dict["data"].data.data_ptr() != \
        small.arg_dict["data"].data.data_ptr()
    mid = _bind_exec(sym, tmx.cpu(), {"data": (2, 6),
                                      "softmax_label": (2,)},
                     ["embed_weight", "fc_weight", "fc_bias"],
                     need_grad=True, base_exec=small,
                     shared_data_arrays=shared)
    assert mid.arg_dict["data"].data.data_ptr() == \
        big.arg_dict["data"].data.data_ptr()
    mid.arg_dict["data"][:] = 3.0
    assert (big.arg_dict["data"].asnumpy().ravel()[:12] == 3.0).all()
    # a parameter whose shape differs between buckets cannot be shared
    fc = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    base = fc.simple_bind(tmx.cpu(), data=(2, 4))
    with pytest.raises(tmx.MXNetError, match="shared executor"):
        _bind_exec(fc, tmx.cpu(), {"data": (2, 5)}, ["fc_weight", "fc_bias"],
                   base_exec=base)


# ----------------------------------------------------------------------
# the LSTM language model through BucketingModule.fit and FeedForward
# ----------------------------------------------------------------------
LM = dict(layers=2, hidden=8, embed=8, vocab=20, batch=4,
          buckets=(4, 6, 8))


def _lm_corpus():
    return J_BUCKET_IO.synthetic_corpus(num_sentences=40,
                                        vocab_size=LM["vocab"], seed=3,
                                        lengths=(5, 7, 9))


def _lm_params(mx):
    """Seeded numpy parameters at the unrolled graph's shapes."""
    sym = mx.models.lstm.lstm_unroll(LM["layers"], 4, LM["vocab"],
                                     num_hidden=LM["hidden"],
                                     num_embed=LM["embed"],
                                     num_label=LM["vocab"])
    states = dict(mx.models.lstm.init_state_shapes(
        LM["layers"], LM["batch"], LM["hidden"]))
    shapes = dict(states, data=(LM["batch"], 4),
                  softmax_label=(LM["batch"], 4))
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(7)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _lm_iter(bucket_io, mx):
    states = mx.models.lstm.init_state_shapes(LM["layers"], LM["batch"],
                                              LM["hidden"])
    return bucket_io.BucketSentenceIter(_lm_corpus(), LM["batch"],
                                        buckets=list(LM["buckets"]),
                                        init_states=states), states


def _lm_sym_gen(mx, states):
    def sym_gen(seq_len):
        s = mx.models.lstm.lstm_unroll(LM["layers"], seq_len, LM["vocab"],
                                       num_hidden=LM["hidden"],
                                       num_embed=LM["embed"],
                                       num_label=LM["vocab"])
        return s, ["data"] + [n for n, _ in states], ["softmax_label"]
    return sym_gen


def _lm_fit(mx, bucket_io, ctx):
    it, states = _lm_iter(bucket_io, mx)
    mod = mx.mod.BucketingModule(_lm_sym_gen(mx, states),
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    metric = mx.metric.Perplexity(ignore_label=None)
    mod.fit(it, eval_metric=metric, kvstore="local", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-5},
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in _lm_params(mx).items()},
            num_epoch=1)
    return mod, metric


def test_lstm_bucketing_fit_matches_jax():
    jmod, jmetric = _lm_fit(jmx, J_BUCKET_IO, jmx.cpu())
    tmod, tmetric = _lm_fit(tmx, T_BUCKET_IO, tmx.cpu())
    assert sorted(tmod._buckets) == sorted(jmod._buckets) == [4, 6, 8]
    jarg, _ = jmod.get_params()
    targ, _ = tmod.get_params()
    assert sorted(targ) == sorted(jarg)
    for name in jarg:
        _close(targ[name].asnumpy(), jarg[name].asnumpy(), name)
    # the metric saw the same batches
    _close(tmetric.get()[1], jmetric.get()[1], "perplexity")


def _ff_fit(mx, bucket_io, ctx):
    it, states = _lm_iter(bucket_io, mx)
    gen = _lm_sym_gen(mx, states)
    ff = mx.FeedForward(gen(it.default_bucket_key)[0], ctx=ctx, num_epoch=1,
                        optimizer="sgd", learning_rate=0.1,
                        arg_params={k: mx.nd.array(v, ctx=ctx)
                                    for k, v in _lm_params(mx).items()})
    ff.sym_gen = lambda key: gen(key)[0]
    ff.fit(it, eval_metric=mx.metric.Perplexity(ignore_label=None))
    return ff


def test_feedforward_sym_gen_matches_jax():
    jff = _ff_fit(jmx, J_BUCKET_IO, jmx.cpu())
    tff = _ff_fit(tmx, T_BUCKET_IO, tmx.cpu())
    assert sorted(tff.arg_params) == sorted(jff.arg_params)
    for name in jff.arg_params:
        _close(tff.arg_params[name].asnumpy(),
               jff.arg_params[name].asnumpy(), name)
    assert not np.allclose(tff.arg_params["cls_weight"].asnumpy(),
                           _lm_params(tmx)["cls_weight"])


# ----------------------------------------------------------------------
# the example's iterator and scripts
# ----------------------------------------------------------------------
def test_bucket_sentence_iter_matches_jax():
    sents = T_BUCKET_IO.synthetic_corpus(num_sentences=100, vocab_size=30)
    assert sents == J_BUCKET_IO.synthetic_corpus(num_sentences=100,
                                                 vocab_size=30)
    states = [("l0_init_c", (8, 5)), ("l0_init_h", (8, 5))]
    tit = T_BUCKET_IO.BucketSentenceIter(sents, batch_size=8,
                                         buckets=[8, 16, 24, 32],
                                         init_states=states)
    jit = J_BUCKET_IO.BucketSentenceIter(sents, batch_size=8,
                                         buckets=[8, 16, 24, 32],
                                         init_states=states)
    assert tit.provide_data == jit.provide_data
    assert tit.provide_label == jit.provide_label
    assert tit.default_bucket_key == jit.default_bucket_key == 32
    seen = 0
    for tb, jb in zip(tit, jit):
        seen += 1
        assert tb.bucket_key == jb.bucket_key
        assert tb.provide_data == jb.provide_data
        assert tb.data[0].shape == (8, tb.bucket_key)
        assert tb.data[0].context == tmx.cpu()
        for a, b in zip(tb.data + tb.label, jb.data + jb.label):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        lbl = tb.label[0].asnumpy()
        dat = tb.data[0].asnumpy()
        np.testing.assert_allclose(lbl[:, :-1], dat[:, 1:])
    assert seen > 0
    with pytest.raises(StopIteration):
        next(jit)
    with pytest.raises(StopIteration):
        tit.next()


def _run_blocked(script, args):
    """Run ``script`` with ``args`` in a subprocess with JAX blocked."""
    code = ("import runpy, sys; sys.modules['jax'] = None\n"
            "sys.argv = %r\n"
            "sys.path.insert(0, %r)\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "bad = [m for m in sys.modules if m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "assert not bad, bad\n"
            % ([script] + args, os.path.dirname(script)))
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script,args", [
    ("lstm_bucketing.py", ["--num-lstm-layer", "1"]),
    ("gru_bucketing.py", ["--num-gru-layer", "1"])])
def test_bucketing_example_runs_on_the_port(script, args):
    r = _run_blocked(os.path.join(REPO, "example", "rnn-torch", script),
                     ["--cpu", "--num-epochs", "1", "--batch-size", "8",
                      "--num-hidden", "16", "--num-embed", "16",
                      "--buckets", "8,16,24,32"] + args)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Train-Perplexity" in r.stderr


def test_sort_example_runs_on_the_port():
    r = _run_blocked(os.path.join(REPO, "example", "bi-lstm-sort-torch",
                                  "sort_io.py"), ["--cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK bi-lstm-sort example" in r.stdout
