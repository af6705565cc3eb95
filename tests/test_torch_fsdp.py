"""FSDP in the port against the JAX package, on the CPU.

The twin of ``tests/test_parallel.py:299-332``: ``ShardedTrainer(fsdp=
True)`` keeps every otherwise-replicated parameter whose axis 0 divides
split over dp (1/dp of it on each member, its optimizer state following),
gathers the whole parameter for the walk and reduce-scatters its
gradient on ZeRO-1's layout.  The JAX side runs on the 8 fake CPU
devices of ``tests/conftest.py``, the port's on ``cpu(0)`` ...
``cpu(7)``.

Tolerances: fsdp against the replicated run 2e-5 / 2e-6 (the JAX
test's), against the JAX fsdp run 2e-6 of the largest weight; fsdp
against ZeRO-1 and against plain dp on the same members bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import tensor_parallel as ttp

CPUS = [tmx.cpu(i) for i in range(8)]


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _run(mx, par, mesh, fsdp, start=None, steps=4, **kw):
    """``test_parallel.py:306-320``'s run: SGD with momentum, 4 steps."""
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    tr = par.ShardedTrainer(_mlp(mx), opt, mesh, fsdp=fsdp, **kw)
    mx.random.seed(13)
    params, opt_state, aux = tr.init_params(
        {"data": (16, 8)}, label_shapes={"softmax_label": (16,)})
    init = {k: np.asarray(v) for k, v in params.items()}
    if start is not None:
        params = tr.place_params(start)
    rng = np.random.RandomState(5)
    x = rng.randn(16, 8).astype(np.float32)
    y = (rng.rand(16) * 4).astype(np.float32)
    batch = tr.shard_batch({"data": x, "softmax_label": y})
    for _ in range(steps):
        params, opt_state, aux, _ = tr.step(params, opt_state, aux, batch)
    return init, params, opt_state, tr


def test_fsdp_param_sharding_matches_jax():
    """fc1_weight (16, 8) lives split over dp=8, 2 rows a member, its
    momentum split the same way; training matches the replicated run
    and the JAX fsdp run from the same weights."""
    init, jp, _js, _ = _run(jmx, jpar, jpar.make_mesh(dp=8), True)
    mesh = tpar.make_mesh(CPUS, dp=8)
    _i, params, opt_state, _t = _run(tmx, tpar, mesh, True, start=init)
    w = params["fc1_weight"]
    assert w.sharding.spec[0] == "dp"
    assert tuple(w.addressable_shards[0].data.shape) == (2, 8)
    mom = opt_state["fc1_weight"]
    assert mom.sharding.spec[0] == "dp"
    assert tuple(mom.shards[0].shape) == (2, 8)
    # fc2_weight (4, 16): axis 0 does not divide by 8, so it stays whole
    assert all(e is None for e in params["fc2_weight"].sharding.spec)
    _i, base, _s, _t = _run(tmx, tpar, mesh, False, start=init)
    for k in params:
        np.testing.assert_allclose(np.asarray(params[k]),
                                   np.asarray(base[k]), rtol=2e-5,
                                   atol=2e-6)
        want = np.asarray(jp[k])
        assert np.abs(np.asarray(params[k]) - want).max() <= \
            2e-6 * max(1.0, float(np.abs(want).max())), k


LM = dict(vocab_size=64, num_layers=2, num_heads=4, dim=32, seq_len=8)


def _lm(mesh, mode, **kw):
    os.environ["MXTPU_FUSED_OPT"] = mode
    try:
        sym = tmx.models.transformer.get_symbol(**LM)
        opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                   rescale_grad=1.0 / 32)
        tr = tpar.ShardedTrainer(sym, opt, mesh, **kw)
        tmx.random.seed(4)
        p, s, a = tr.init_params({"data": (4, 8)},
                                 label_shapes={"softmax_label": (4, 8)})
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, 64, (4, 9)).astype(np.float32)
        b = tr.shard_batch({"data": tokens[:, :-1],
                            "softmax_label": tokens[:, 1:]})
        for _ in range(3):
            p, s, a, o = tr.step(p, s, a, b)
        return p, s, tr
    finally:
        os.environ.pop("MXTPU_FUSED_OPT", None)


@pytest.mark.parametrize("mode", ["", "1"])
def test_fsdp_bit_for_bit_zero1_and_replicated(mode):
    """The LM at dp=2 on two members of one device: FSDP's parameters
    and momentum equal ZeRO-1's and plain dp's bit for bit, leafwise
    and through the fused sweep."""
    mesh = tpar.make_mesh(CPUS[:2], dp=2)
    pf, sf, trf = _lm(mesh, mode, fsdp=True)
    pz, sz, _t = _lm(mesh, mode, zero1=True)
    pr, sr, _t = _lm(mesh, mode)
    for k in pr:
        whole = np.asarray(pf[k])
        np.testing.assert_array_equal(whole, np.asarray(pz[k]), err_msg=k)
        np.testing.assert_array_equal(whole, np.asarray(pr[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(sf[k]), np.asarray(sr[k]),
                                      err_msg=k)
    assert set(trf._fsdp_names(pf)) == set(pf)     # every leaf divides


def test_fsdp_keeps_one_dp_share_of_the_state():
    """The persistent bytes of parameters and state on each member are
    1/dp of the replicated run's (every leaf of the LM divides)."""
    mesh = tpar.make_mesh(CPUS[:2], dp=2)

    def member_bytes(p, s, r):
        return sum(v.shards[r].numel() * 4 for v in p.values()) + \
            sum(v.shards[r].numel() * 4 for v in s.values())
    pf, sf, _t = _lm(mesh, "1", fsdp=True)
    pr, sr, _t = _lm(mesh, "1")
    for r in range(2):
        assert member_bytes(pf, sf, r) * 2 == member_bytes(pr, sr, r)


def test_fsdp_with_tp_keeps_the_tp_split():
    """FSDP on dp=2 x tp=2: a tp-split parameter keeps its tp spec (the
    JAX rule), the others split over dp; the step matches plain dp x tp
    bit for bit and gathers no whole tp-split weight."""
    mesh = tpar.make_mesh(CPUS[:4], dp=2, tp=2)
    ttp.reset_counts()
    pf, sf, tr = _lm(mesh, "1", fsdp=True)
    assert ttp.counts()["whole_weight_gathers"] == 0
    pr, _s, _t = _lm(mesh, "1")
    assert tuple(pf["lm_head_weight"].sharding.spec) == ("tp", None)
    assert tuple(pf["final_ln_gamma"].sharding.spec) == ("dp",)
    assert tuple(sf["final_ln_gamma"].sharding.spec) == ("dp",)
    assert tuple(tr.param_sharding("final_ln_gamma", (32,)).spec) == \
        tuple(jpar.ShardedTrainer(
            jmx.models.transformer.get_symbol(**LM),
            jmx.optimizer.create("sgd"), jpar.make_mesh(dp=4, tp=2),
            fsdp=True).param_sharding("final_ln_gamma", (32,)).spec)
    for k in pr:
        np.testing.assert_array_equal(np.asarray(pf[k]), np.asarray(pr[k]),
                                      err_msg=k)


def test_fsdp_checkpoint_round_trip(tmp_path):
    """An FSDP trainer saves the whole arrays and restores them split."""
    mesh = tpar.make_mesh(CPUS[:2], dp=2)
    p, s, tr = _lm(mesh, "1", fsdp=True)
    tr.save_checkpoint(str(tmp_path / "ck"), p, s, {})
    p2, s2, _a = tr.load_checkpoint(str(tmp_path / "ck"), {"data": (4, 8)},
                                    {"softmax_label": (4, 8)})
    for k in p:
        np.testing.assert_array_equal(np.asarray(p2[k]), np.asarray(p[k]))
        assert tuple(p2[k].sharding.spec) == tuple(p[k].sharding.spec)
        assert tuple(p2[k].shards[0].shape) == tuple(p[k].shards[0].shape)
        np.testing.assert_array_equal(np.asarray(s2[k]), np.asarray(s[k]))


def test_fsdp_eval_and_guards():
    """``eval`` gathers the split leaves for the forward; FSDP with a
    non-elementwise optimizer, or with ep, raises naming why."""
    mesh = tpar.make_mesh(CPUS[:2], dp=2)
    p, s, tr = _lm(mesh, "1", fsdp=True)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (4, 9)).astype(np.float32)
    b = tr.shard_batch({"data": tokens[:, :-1],
                        "softmax_label": tokens[:, 1:]})
    out = np.asarray(tr.eval(p, {}, b)[0])
    assert out.shape == (32, 64) and np.isfinite(out).all()
    with pytest.raises(MXNetError, match="elementwise"):
        tpar.ShardedTrainer(_mlp(tmx), tmx.optimizer.create("lamb"), mesh,
                            fsdp=True)
    with pytest.raises(MXNetError, match=r"3 \(e2\)"):
        tpar.ShardedTrainer(_mlp(tmx), tmx.optimizer.create("sgd"),
                            tpar.make_mesh(CPUS[:4], dp=2, ep=2), fsdp=True)
    assert not tpar.ShardedTrainer(_mlp(tmx), tmx.optimizer.create("sgd"),
                                   tpar.make_mesh(CPUS[:1], dp=1),
                                   fsdp=True).fsdp


def test_fsdp_step_frees_the_gathered_copies():
    """After a step no whole copy of a dp-split leaf is alive: the
    gathered tensors die with the step, the members hold their rows."""
    import gc
    import weakref
    mesh = tpar.make_mesh(CPUS[:2], dp=2)
    p, s, tr = _lm(mesh, "1", fsdp=True)
    refs = []
    full = tr._full_leaves

    def spy(params, grad):
        leaves = full(params, grad)
        refs.extend(weakref.ref(leaves[w][k]) for w in tr._walkers
                    for k in tr._fsdp_names(params))
        return leaves
    tr._full_leaves = spy
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (4, 9)).astype(np.float32)
    b = tr.shard_batch({"data": tokens[:, :-1],
                        "softmax_label": tokens[:, 1:]})
    p, s, _a, _o = tr.step(p, s, {}, b)
    gc.collect()
    assert refs and all(r() is None for r in refs)
    assert tuple(p["lm_head_weight"].shards[0].shape) == (32, 32)
