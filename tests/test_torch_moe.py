"""The MoE op and expert parallelism in the port against the JAX package,
on the CPU.

The twins of ``tests/test_parallel.py``'s MoE tests and more: the
``MoE`` op's forward and its six gradients (top-1 and top-2, capacity 0
and 1.25) against ``mxnet_tpu.ops.moe``, after checking that both
packages route every token to the same experts and that no token's top
two gate probabilities lie within 1e-6 of each other (a near tie would
flip the routing, not mark an error).  In float32 within rtol 1e-5 and
atol 1e-6 of the larger of 1 and the tensor's max-abs: a gradient sums
32 tokens' terms of order 1, and the float32 rounding of either package
alone, against a float64 run, reaches 1.3e-6; in float64 within rtol
1e-10, atol 1e-12;
``ShardedTrainer`` on a ``dp=2 x ep=2`` mesh against the JAX package's
``dp=2, ep=2`` step and the port's ``ep=2`` against its own ``ep=1``
(rtol 2e-4, atol 2e-5: ``test_moe_ep_sharded_matches_replicated``'s
bound); ``dp=2`` against ``dp=1`` with the capacity binding (the
capacity counted over the whole batch, through the replicas' prefix);
``expert_parallel_moe`` against the JAX one under ``shard_map``; and
``ShardedPredictor`` against ``predictor.Predictor`` and the JAX
``ShardedPredictor``.  The JAX side runs on the 8 fake CPU devices of
``tests/conftest.py``; the port's mesh members are contexts ``cpu(0)``
... ``cpu(7)`` of the one CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.ops import moe as jmoe
from mxnet_tpu.ops.registry import create_operator as jcreate
from mxnet_tpu.parallel.pipeline import shard_map as jshard_map

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import moe as tmoe
from mxnet_tpu_torch.ops.registry import create_operator as tcreate
from mxnet_tpu_torch.parallel import collectives as tcoll

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = [tmx.cpu(i) for i in range(8)]
E, K, H = 8, 4, 16


def _weights(rng, K=K, E=E, H=H):
    return [rng.randn(K, E).astype(np.float32),
            (rng.randn(K, H, E) * 0.3).astype(np.float32),
            (rng.randn(K, H) * 0.1).astype(np.float32),
            (rng.randn(K, E, H) * 0.3).astype(np.float32),
            (rng.randn(K, E) * 0.1).astype(np.float32)]


def _no_near_ties(x, wg, topk):
    """No token's k-th and (k+1)-th gate probabilities (the routing
    boundary) within 1e-6."""
    logits = x @ wg.T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    s = -np.sort(-p, axis=-1)
    assert (s[:, topk - 1] - s[:, topk]).min() > 1e-6


# ----------------------------------------------------------------------
# the op
# ----------------------------------------------------------------------
@pytest.mark.parametrize("topk,cf", [(1, 0.0), (1, 1.25), (2, 0.0),
                                     (2, 1.25)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_moe_op_forward_and_gradients_match_jax(topk, cf, dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(32, E).astype(np.float32)
    ws = _weights(rng)
    _no_near_ties(x, ws[0], topk)
    attrs = dict(num_experts=K, hidden_size=H, top_k=topk,
                 capacity_factor=cf)
    jop, top = jcreate("MoE", **attrs), tcreate("MoE", **attrs)
    # both packages pick the same experts, and drop the same tokens
    _jp, jmask, _ = jmoe._routing(jnp.asarray(x), jnp.asarray(ws[0]),
                                     K, topk, cf)
    probs, mask, _c, _s = tmoe._routing(torch.tensor(x),
                                        torch.tensor(ws[0]), K, topk, cf)
    np.testing.assert_array_equal(np.asarray(jmask), mask.numpy())

    ins = [a.astype(dtype) for a in [x] + ws]
    cot = [rng.randn(32, E).astype(dtype), np.ones((1,), dtype)]
    rtol, atol = (1e-5, 1e-6) if dtype == "float32" else (1e-10, 1e-12)

    def jf(*a):
        outs, _ = jop.forward(list(a), [], True, None)
        return outs
    jouts, pull = jax.vjp(jf, *[jnp.asarray(a) for a in ins])
    jgrads = pull([jnp.asarray(c) for c in cot])
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    touts, _ = top.forward(tins, [], True, None)
    tgrads = torch.autograd.grad(touts, tins,
                                 [torch.tensor(c) for c in cot])
    for name, j, t in zip(["output", "aux_loss"] + top.list_arguments(),
                          list(jouts) + list(jgrads),
                          list(touts) + list(tgrads)):
        j = np.asarray(j)
        assert t.dtype == getattr(torch, dtype) and j.dtype == dtype
        np.testing.assert_allclose(
            t.detach().numpy(), j, rtol=rtol,
            atol=atol * max(1.0, float(np.abs(j).max())), err_msg=name)
    # the drop count: assignments made less those kept
    assert int(top.dropped) == 32 * topk - int(np.asarray(jmask).sum())


def test_moe_topk_ties_take_the_lowest_index():
    """``lax.top_k``'s order: equal probabilities go to the lower
    expert."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.4, 0.1]])
    got = tmoe._assign(probs, 2)
    np.testing.assert_array_equal(got.numpy(), [[1, 1, 0, 0],
                                                [0, 1, 1, 0]])
    _, inds = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert sorted(np.asarray(inds)[0]) == [0, 1]


def test_moe_symbol_forward_matches_numpy():
    """The twin of ``test_moe_forward_matches_numpy`` through a bound
    symbol, and ``SwitchFFN`` the same op."""
    rng = np.random.RandomState(0)
    x = rng.randn(12, E).astype(np.float32)
    ws = _weights(rng)
    t = x
    logits = t @ ws[0].T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.zeros_like(t)
    for i, k in enumerate(p.argmax(-1)):
        h = np.maximum(t[i] @ ws[1][k].T + ws[2][k], 0)
        want[i] = (h @ ws[3][k].T + ws[4][k]) * p[i, k]
    for op in ("MoE", "SwitchFFN"):
        s = getattr(tmx.sym, op)(tmx.sym.Variable("x"), num_experts=K,
                                 hidden_size=H, name="moe")
        names = s.list_arguments()
        args = {n: tmx.nd.array(a, ctx=tmx.cpu())
                for n, a in zip(names, [x] + ws)}
        ex = s.bind(tmx.cpu(), args)
        out = ex.forward()[0].asnumpy()
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# ShardedTrainer over dp x ep
# ----------------------------------------------------------------------
def _net(mx, cf=0.0, topk=1):
    data = mx.sym.Variable("data")
    y, _aux = mx.sym.MoE(data, num_experts=K, hidden_size=H, top_k=topk,
                         capacity_factor=cf, name="moe")
    out = mx.sym.FullyConnected(y, num_hidden=4, name="cls")
    return mx.sym.SoftmaxOutput(out, name="softmax")


def _batch(n=16, seed=7):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(n, E).astype(np.float32),
            "softmax_label": (rng.rand(n) * 4).astype(np.float32)}


def _jax_run(cfg, cf, batch, steps=3):
    n = int(np.prod(list(cfg.values())))
    tr = jpar.ShardedTrainer(_net(jmx, cf),
                             jmx.optimizer.create("sgd", learning_rate=0.1,
                                                  momentum=0.9),
                             jpar.make_mesh(jax.devices()[:n], **cfg))
    jmx.random.seed(17)
    p, s, a = tr.init_params({"data": batch["data"].shape},
                             label_shapes={"softmax_label":
                                           batch["softmax_label"].shape})
    init = {k: np.array(v) for k, v in p.items()}
    b = tr.shard_batch(batch)
    for _ in range(steps):
        p, s, a, _o = tr.step(p, s, a, b)
    return init, {k: np.asarray(v) for k, v in p.items()}


def _port_run(cfg, cf, batch, init, steps=3, topk=1):
    n = int(np.prod(list(cfg.values())))
    mesh = tpar.make_mesh(CPUS[:n], **cfg)
    tr = tpar.ShardedTrainer(_net(tmx, cf, topk),
                             tmx.optimizer.create("sgd", learning_rate=0.1,
                                                  momentum=0.9), mesh)
    _p, s, a = tr.init_params({"data": batch["data"].shape},
                              label_shapes={"softmax_label":
                                            batch["softmax_label"].shape})
    p = tr.place_params(init)
    b = tr.shard_batch(batch)
    drops = []
    for _ in range(steps):
        p, s, a, _o = tr.step(p, s, a, b)
        op = next(n.op for n in tr.symbol._topo()
                  if n.op is not None and n.op.op_name == "MoE")
        drops.append(int(op.dropped))
    return tr, p, s, drops


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=2e-4,
                                   atol=2e-5, err_msg="%s %s" % (what, k))


def test_dp2_ep2_step_matches_jax_and_holds_expert_slices():
    batch = _batch()
    init, jwant = _jax_run({"dp": 2, "ep": 2}, 0.0, batch)
    tr, p, s, _d = _port_run({"dp": 2, "ep": 2}, 0.0, batch, init)
    _close(p, jwant, "dp2 x ep2 against JAX")
    # each member holds K/ep experts, and that slice's momentum
    w1 = p["moe_expert_fc1_weight"]
    assert w1.sharding.spec[0] == "ep"
    assert [tuple(t.shape) for t in w1.shards] == [(K // 2, H, E)] * 4
    m1 = s["moe_expert_fc1_weight"]
    assert [tuple(t.shape) for t in m1.shards] == [(K // 2, H, E)] * 4
    # member (d, e) holds experts [e*K/2, (e+1)*K/2)
    whole = np.asarray(w1)
    for i, t in enumerate(w1.shards):
        e = tr.mesh.coords(i)["ep"]
        np.testing.assert_array_equal(
            t.numpy(), whole[e * (K // 2):(e + 1) * (K // 2)])
    # the gate and the rest replicated on every member
    g = p["moe_gate_weight"]
    assert g.sharding.is_fully_replicated and len(g.shards) == 4


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_ep_sharded_matches_replicated(ep):
    """The port's twin of the JAX test: ep against ep=1 (one device)."""
    batch = _batch()
    init, _ = _jax_run({"dp": 1}, 1.25, batch, steps=0)
    _t, want, _s, _d = _port_run({"dp": 1}, 1.25, batch, init)
    want = {k: np.asarray(v) for k, v in want.items()}
    tr, got, _s, _d = _port_run({"ep": ep}, 1.25, batch, init)
    assert got["moe_expert_fc1_weight"].shards[0].shape[0] == K // ep
    _close(got, want, "ep=%d against ep=1" % ep)


def test_dp2_with_the_capacity_binding_matches_dp1():
    """The capacity and the aux loss count the whole batch: dp=2 drops
    the tokens dp=1 drops, so its step equals dp=1's and the JAX
    package's dp=2 step (whose cumsum runs over the logical batch)."""
    batch = _batch(32, seed=11)
    init, jwant = _jax_run({"dp": 2}, 0.5, batch)
    _t, want, _s, drops1 = _port_run({"dp": 1}, 0.5, batch, init)
    _t, got, _s, drops2 = _port_run({"dp": 2}, 0.5, batch, init)
    assert min(drops1) > 0, drops1
    assert drops2 == drops1
    want = {k: np.asarray(v) for k, v in want.items()}
    _close(got, want, "dp=2 against dp=1")
    _close(got, jwant, "dp=2 against JAX dp=2")


def test_moe_lm_dp_ep_matches_one_device():
    """transformer_moe through ShardedTrainer: dp=2 x ep=2 (capacity
    1.25, top-2) equals the one-device step."""
    dims = dict(vocab_size=32, num_layers=2, num_heads=2, dim=16,
                seq_len=8, num_experts=4, moe_top_k=2)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 32, (4, 9))
    batch = {"data": tokens[:, :-1].astype(np.float32),
             "softmax_label": tokens[:, 1:].astype(np.float32)}
    got = {}
    for cfg in ({"dp": 1}, {"dp": 2, "ep": 2}):
        n = int(np.prod(list(cfg.values())))
        tr = tpar.ShardedTrainer(
            tmx.models.transformer_moe.get_symbol(**dims),
            tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
            tpar.make_mesh(CPUS[:n], **cfg))
        tmx.random.seed(4)
        p, s, a = tr.init_params({"data": (4, 8)},
                                 label_shapes={"softmax_label": (4, 8)})
        b = tr.shard_batch(batch)
        for _ in range(2):
            p, s, a, o = tr.step(p, s, a, b)
        got[len(got)] = {k: np.asarray(v) for k, v in p.items()}
    _close(got[1], got[0], "LM dp2 x ep2 against one device")


def test_ep_guards_name_their_items():
    mesh = tpar.make_mesh(CPUS[:2], ep=2)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1)
    with pytest.raises(MXNetError, match=r"3 \(e2\)"):
        tpar.ShardedTrainer(_net(tmx), opt, mesh, zero1=True)
    with pytest.raises(MXNetError, match=r"3 \(b2\)"):
        tpar.ShardedTrainer(_net(tmx), opt,
                            tpar.make_mesh(CPUS[:4], ep=2, tp=2))
    with pytest.raises(MXNetError, match="GPipeTrainer"):
        tpar.ShardedTrainer(_net(tmx), opt, tpar.make_mesh(CPUS[:2], pp=2))
    # a parameter named like an expert stack that MoE does not read
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=4, name="expert_fc")
    tr = tpar.ShardedTrainer(tmx.sym.SoftmaxOutput(fc, name="softmax"),
                             opt, mesh)
    with pytest.raises(MXNetError, match="only MoE"):
        tr.init_params({"data": (4, 8)},
                       label_shapes={"softmax_label": (4,)})
    # a process group: ep and the all-to-all raise, naming item 3 (k)
    group = tcoll.ReplicaGroup([torch.device("cpu")], num_processes=2)
    with pytest.raises(MXNetError, match=r"3 \(k\)"):
        tcoll.all_to_all(group, [torch.zeros(2)], 0, 0)
    with pytest.raises(MXNetError, match="go through the host"):
        tcoll.send(torch.zeros(2), "meta")


def test_all_to_all_and_send_on_shared_devices():
    """lax.all_to_all(tiled=True)'s layout, its autograd twin, and a
    send that stays on its device."""
    group = tcoll.ReplicaGroup([torch.device("cpu")] * 3)
    xs = [torch.arange(12.).reshape(6, 2) + 100 * r for r in range(3)]
    got = tcoll.all_to_all(group, xs, 0, 1)
    for j in range(3):
        want = torch.cat([x[2 * j:2 * j + 2] for x in xs], dim=1)
        assert torch.equal(got[j], want)
    leaves = [x.clone().requires_grad_(True) for x in xs]
    outs = tcoll.all_to_all_autograd(group, leaves, 0, 1)
    torch.autograd.backward(outs, [torch.full_like(o, float(j + 1))
                                   for j, o in enumerate(outs)])
    for x in leaves:
        assert torch.equal(x.grad[:, 0], torch.tensor([1., 1, 2, 2, 3, 3]))
    t = torch.ones(3)
    assert tcoll.send(t, "cpu") is t


# ----------------------------------------------------------------------
# expert_parallel_moe
# ----------------------------------------------------------------------
@pytest.mark.parametrize("topk", [1, 2])
def test_expert_parallel_moe_matches_jax_shard_map(topk):
    rng = np.random.RandomState(5)
    ep = 2
    x = rng.randn(2, 16, E).astype(np.float32)      # one shard a member
    wg, w1, b1, w2, b2 = _weights(rng)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:ep]), ("ep",))

    def inner(xx, g, a1, c1, a2, c2):
        out, aux = jmoe.expert_parallel_moe(xx, g, a1, c1, a2, c2,
                                            axis="ep", top_k=topk,
                                            capacity_factor=1.0)
        return out, aux.reshape(1)
    f = jshard_map(inner, mesh=mesh,
                   in_specs=(JP("ep"), JP(), JP("ep"), JP("ep"), JP("ep"),
                             JP("ep")),
                   out_specs=(JP("ep"), JP("ep")))
    jout, jaux = f(jnp.asarray(x.reshape(-1, E)), *map(jnp.asarray,
                                                       (wg, w1, b1, w2, b2)))
    jout = np.asarray(jout).reshape(2, 16, E)
    group = tcoll.ReplicaGroup([torch.device("cpu")] * ep)
    kl = K // ep

    def split(a):
        return [torch.tensor(a[r * kl:(r + 1) * kl]) for r in range(ep)]
    outs, auxes = tmoe.expert_parallel_moe(
        group, [torch.tensor(x[r]) for r in range(ep)], torch.tensor(wg),
        split(w1), split(b1), split(w2), split(b2), top_k=topk,
        capacity_factor=1.0)
    for r in range(ep):
        np.testing.assert_allclose(outs[r].numpy(), jout[r], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(auxes[r]), float(jaux[r]),
                                   rtol=1e-5)
        # the dense op on each member's shard with the same capacity
        dense = tcreate("MoE", num_experts=K, hidden_size=H, top_k=topk,
                        capacity_factor=1.0)
        want, _ = dense.forward([torch.tensor(x[r])] + [
            torch.tensor(a) for a in (wg, w1, b1, w2, b2)], [], True, None)
        np.testing.assert_allclose(outs[r].numpy(), want[0].numpy(),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="capacity_factor"):
        tmoe.expert_parallel_moe(group, [torch.tensor(x[0])] * 2,
                                 torch.tensor(wg), split(w1), split(b1),
                                 split(w2), split(b2), capacity_factor=0)


# ----------------------------------------------------------------------
# ShardedPredictor
# ----------------------------------------------------------------------
def _lm_checkpoint(tmp_path):
    dims = dict(vocab_size=32, num_layers=2, num_heads=2, dim=16,
                seq_len=8, num_experts=4)
    sym = tmx.models.transformer_moe.get_symbol(**dims)
    jsym = jmx.models.transformer_moe.get_symbol(**dims)
    arg_shapes, _, _ = sym.infer_shape(data=(4, 8), softmax_label=(4, 8))
    rng = np.random.RandomState(2)
    params = {n: (rng.randn(*s) * 0.2).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    prefix = str(tmp_path / "moe_lm")
    tmx.model.save_checkpoint(prefix, 1, sym,
                              {k: tmx.nd.array(v, ctx=tmx.cpu())
                               for k, v in params.items()}, {})
    tokens = rng.randint(0, 32, (4, 8)).astype(np.float32)
    return prefix, sym, jsym, params, tokens


def test_sharded_predictor_matches_predictor_and_jax(tmp_path):
    prefix, sym, jsym, params, tokens = _lm_checkpoint(tmp_path)
    with tmx.cpu():
        pred = tmx.predictor.Predictor(
            sym.tojson(), params, {"data": (4, 8), "softmax_label": (4, 8)},
            ctx=tmx.cpu())
        pred.forward(data=tokens)
        want = pred.get_output(0)
        want = want.asnumpy() if hasattr(want, "asnumpy") \
            else np.asarray(want)
    jpred = jpar.ShardedPredictor(jsym, jpar.make_mesh(
        jax.devices()[:2], dp=2), params)
    # the LM's label shape does not follow from the data's (it is
    # reshaped flat), so the batch gives it; the MLP below binds it
    zeros = np.zeros_like(tokens)
    jwant = jpred.predict({"data": tokens, "softmax_label": zeros})[0]
    for cfg in ({"dp": 2}, {"dp": 2, "ep": 2}):
        n = int(np.prod(list(cfg.values())))
        with tmx.cpu():
            sp = tpar.ShardedPredictor.from_checkpoint(
                prefix, 1, tpar.make_mesh(CPUS[:n], **cfg))
        if "ep" in cfg:
            w = sp.params["layer0_moe_expert_fc1_weight"]
            assert w.shards[0].shape[0] == 2
        got = sp.predict({"data": tokens, "softmax_label": zeros})[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jwant, rtol=1e-5, atol=1e-5)
    with pytest.raises(MXNetError, match="missing parameters"):
        tpar.ShardedPredictor(sym, tpar.make_mesh(CPUS[:2], dp=2), {})


def test_sharded_predictor_binds_the_label_slot_as_zeros():
    """An MLP whose label shape follows from the data's: the label slot
    is bound as zeros, in both packages."""
    rng = np.random.RandomState(1)
    data = rng.randn(8, 10).astype(np.float32)
    params = {"fc1_weight": rng.randn(16, 10).astype(np.float32),
              "fc1_bias": rng.randn(16).astype(np.float32),
              "fc2_weight": rng.randn(4, 16).astype(np.float32),
              "fc2_bias": rng.randn(4).astype(np.float32)}

    def mlp(mx):
        x = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                  name="fc1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(x, name="softmax")
    jwant = jpar.ShardedPredictor(mlp(jmx), jpar.make_mesh(
        jax.devices()[:4], dp=4), params).predict({"data": data})[0]
    for n in (1, 4):
        sp = tpar.ShardedPredictor(mlp(tmx), tpar.make_mesh(CPUS[:n], dp=n),
                                   params, compute_dtype=None)
        got = sp.predict({"data": data})[0]
        assert got.shape == (8, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, jwant, rtol=1e-5, atol=1e-6)
    # at dp=2 x tp=2 the parameters split by the tp policy
    sp = tpar.ShardedPredictor(mlp(tmx), tpar.make_mesh(CPUS[:4], dp=2,
                                                        tp=2), params)
    np.testing.assert_allclose(sp.predict({"data": data})[0], jwant,
                               rtol=1e-5, atol=1e-6)


def test_new_modules_import_without_jax():
    """Every module of this slice imports with JAX blocked, and the MoE
    LM steps on an ep mesh there."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mxnet_tpu'] = None\n"
            "import mxnet_tpu_torch as mx\n"
            "import mxnet_tpu_torch.ops.moe, "
            "mxnet_tpu_torch.models.transformer_moe, "
            "mxnet_tpu_torch.parallel.pipeline, "
            "mxnet_tpu_torch.analysis.schedule\n"
            "from mxnet_tpu_torch.parallel import (ShardedPredictor, "
            "GPipeTrainer, build_1f1b_tables)\n"
            "from mxnet_tpu_torch.analysis import schedule_report\n"
            "m = mx.parallel.make_mesh([mx.cpu(0), mx.cpu(0)], ep=2)\n"
            "print(m.size, sorted(k for k in sys.modules "
            "if k == 'jax' or k.startswith('mxnet_tpu.')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2 ['jax']"


def test_ep_checkpoint_round_trip(tmp_path):
    """An ep=2 trainer's host checkpoint holds the whole expert stacks
    and restores each member's slice, with its momentum and the update
    counter."""
    batch = _batch()
    init, _ = _jax_run({"dp": 1}, 1.25, batch, steps=0)
    tr, p, s, _d = _port_run({"dp": 1, "ep": 2}, 1.25, batch, init, steps=2)
    tr.save_checkpoint(str(tmp_path / "ck"), p, s, {})
    fresh, _p, _s, _d = _port_run({"dp": 1, "ep": 2}, 1.25, batch, init,
                                  steps=0)
    got_p, got_s, _a = fresh.load_checkpoint(
        str(tmp_path / "ck"), {"data": batch["data"].shape},
        label_shapes={"softmax_label": batch["softmax_label"].shape})
    assert fresh.num_update == 2
    for k in p:
        np.testing.assert_array_equal(np.asarray(got_p[k]), np.asarray(p[k]))
        np.testing.assert_array_equal(np.asarray(got_s[k]), np.asarray(s[k]))
    assert got_p["moe_expert_fc2_weight"].shards[1].shape[0] == K // 2
