"""Tensor parallelism in the port against the JAX package, on the CPU.

The twins of ``tests/test_parallel.py``'s tp tests and of
``tests/test_kvcache.py``'s head-split pools: the JAX side runs on the 8
fake CPU devices ``tests/conftest.py`` sets up (GSPMD divides the work),
the port's on contexts ``cpu(0)`` ... ``cpu(7)`` that share the one CPU
(``parallel/tensor_parallel.py``: the tp forms of the ops, each member's
share computed from its part).  Inputs come from a numpy seed; the port
starts from the JAX package's initial weights, placed as its trainer
places them (``ShardedTrainer.place_params``).

Tolerances: the tp trainer against one device 2e-4 / 2e-5 (the JAX
test's own), against the JAX tp trainer 2e-6 of the largest weight;
``ShardedPredictor`` at dp=4 x tp=2 1e-5 of ``Predictor``; the tp engine's
tokens equal to the one-device engine's and the JAX tp engine's, its
logits within 1e-4; every tp path with zero whole-weight gathers.
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
from mxnet_tpu_torch.parallel import tensor_parallel as ttp
from mxnet_tpu_torch.parallel.collectives import ReplicaGroup
from mxnet_tpu_torch.parallel.sharding import P, place

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = [tmx.cpu(i) for i in range(8)]


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _close(got, want, tol, what=""):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol * scale, (what, k,
                                                    np.abs(g - w).max())


def test_make_mesh_and_pspecs_match_jax():
    """``test_parallel.py:28-41``: the mesh's shapes, and the tp policy's
    spec for every case, on the port's mesh of contexts; the tp and dp
    sub-groups of each member."""
    mesh = tpar.make_mesh(CPUS, dp=4, tp=2)
    assert dict(mesh.shape) == dict(jpar.make_mesh(dp=4, tp=2).shape)
    assert tpar.make_mesh(CPUS, dp=-1, tp=2).shape["dp"] == 4
    with pytest.raises(ValueError):
        tpar.make_mesh(CPUS, dp=3, tp=2)
    assert dict(tpar.auto_mesh(devices=CPUS, tp=2).shape) == \
        dict(jpar.auto_mesh(tp=2).shape)
    jmesh = jpar.make_mesh(dp=4, tp=2)
    for name, shape in (("fc1_weight", (16, 8)), ("fc1_bias", (16,)),
                        ("w", (5, 3)), ("w", (5, 4)), ("bn_gamma", (16,)),
                        ("x", (3,))):
        assert tuple(tpar.param_pspec(name, shape, mesh)) == \
            tuple(jpar.param_pspec(name, shape, jmesh)), (name, shape)
    assert tuple(tpar.batch_pspec((32, 8), mesh)) == ("dp", None)
    # members in row-major (dp, tp) order; each one's tp and dp group
    assert [mesh.coords(i) for i in (0, 1, 2)] == [
        {"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}, {"dp": 1, "tp": 0}]
    assert mesh.axis_members(5, "tp") == [4, 5]
    assert mesh.axis_members(5, "dp") == [1, 3, 5, 7]
    assert mesh.axis_group(5, "tp").n == 2


def test_named_pspecs_and_rule_validation_match_jax():
    """``named_pspecs`` and ``ShardingRules.validate`` report what the
    JAX package reports over a dp x tp mesh."""
    from jax.sharding import PartitionSpec as JP
    shapes = {"data": (8, 6), "softmax_label": (8,), "fc1_weight": (16, 6),
              "fc1_bias": (16,), "fc2_weight": (5, 16), "fc2_bias": (5,)}
    tmesh = tpar.make_mesh(CPUS[:4], dp=2, tp=2)
    jmesh = jpar.make_mesh(jax.devices()[:4], dp=2, tp=2)
    tn, jn = [], []
    got = tpar.named_pspecs(shapes, tmesh, notes=tn)
    want = jpar.named_pspecs(shapes, jmesh, notes=jn)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert tn == jn
    trules = tpar.ShardingRules([(r"fc2_weight",
                                  lambda s, m: P("tp", None)),
                                 (r"fc1_bias", lambda s, m: P("sp"))])
    jrules = jpar.ShardingRules([(r"fc2_weight",
                                  lambda s, m: JP("tp", None)),
                                 (r"fc1_bias", lambda s, m: JP("sp"))])
    t_issues = [(n, tuple(s), p, f) for n, s, p, f in
                trules.validate(tmesh, shapes)]
    j_issues = [(n, tuple(s), p, f) for n, s, p, f in
                jrules.validate(jmesh, shapes)]
    assert t_issues == j_issues and len(t_issues) == 2


@pytest.mark.parametrize("spec", [("tp", None), (None, "tp"),
                                  ("dp", None)])
def test_sharded_array_shards_match_jax(spec):
    """``place`` over dp=2 x tp=2: each member's shard is the JAX array's
    addressable shard of the same device, and ``numpy.asarray``
    assembles the whole."""
    from jax.sharding import NamedSharding, PartitionSpec as JP
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    tmesh = tpar.make_mesh(CPUS[:4], dp=2, tp=2)
    jmesh = jpar.make_mesh(jax.devices()[:4], dp=2, tp=2)
    arr = place(x, tmesh, P(*spec))
    jarr = jax.device_put(x, NamedSharding(jmesh, JP(*spec)))
    jshards = sorted(jarr.addressable_shards, key=lambda s: s.device.id)
    assert [tuple(s.data.shape) for s in arr.addressable_shards] == \
        [tuple(s.data.shape) for s in jshards]
    for mine, theirs in zip(arr.addressable_shards, jshards):
        np.testing.assert_array_equal(mine.data.numpy(),
                                      np.asarray(theirs.data))
    np.testing.assert_array_equal(np.asarray(arr), x)
    assert not arr.sharding.is_fully_replicated


def _tp_mlp_run(mx, par, mesh, steps, start=None):
    """``test_parallel.py:99-121``'s run: SGD steps of the MLP; the port
    starts from ``start`` (the JAX package's initial weights)."""
    opt = mx.optimizer.create("sgd", learning_rate=0.1)
    tr = par.ShardedTrainer(_mlp(mx), opt, mesh)
    mx.random.seed(3)
    params, opt_state, aux = tr.init_params(
        {"data": (8, 8)}, label_shapes={"softmax_label": (8,)})
    init = _np(params)
    if start is not None:
        params = tr.place_params(start)
    rng = np.random.RandomState(2)
    x = rng.randn(8, 8).astype(np.float32)
    y = (rng.rand(8) * 4).astype(np.float32)
    batch = tr.shard_batch({"data": x, "softmax_label": y})
    for _ in range(steps):
        params, opt_state, aux, outs = tr.step(params, opt_state, aux,
                                               batch)
    return init, _np(params), np.asarray(outs[0]), params


def test_tp_trainer_matches_replicated_and_jax():
    """The tp step (dp=2 x tp=4) equals the one-device step within the
    JAX test's bound, and the JAX tp trainer's from the same weights;
    each weight lives split as the policy says, no whole weight is
    gathered."""
    init, jp, jo, _ = _tp_mlp_run(jmx, jpar, jpar.make_mesh(dp=2, tp=4), 2)
    ttp.reset_counts()
    _i, tp_p, tp_o, placed = _tp_mlp_run(
        tmx, tpar, tpar.make_mesh(CPUS, dp=2, tp=4), 2, start=init)
    _i, one_p, one_o, _ = _tp_mlp_run(
        tmx, tpar, tpar.make_mesh(CPUS[:1], dp=1), 2, start=init)
    assert ttp.counts()["whole_weight_gathers"] == 0
    np.testing.assert_allclose(tp_o, one_o, rtol=2e-4, atol=2e-5)
    for k in tp_p:
        np.testing.assert_allclose(tp_p[k], one_p[k], rtol=2e-4, atol=2e-5)
    _close(tp_p, jp, 2e-6, "tp against JAX tp")
    np.testing.assert_allclose(tp_o, jo, rtol=1e-5, atol=2e-6)
    assert tuple(placed["fc1_weight"].sharding.spec) == ("tp", None)
    assert [tuple(s.shape) for s in placed["fc1_weight"].shards] == \
        [(4, 8)] * 8
    assert [tuple(s.shape) for s in placed["fc2_bias"].shards] == [(1,)] * 8


LM_DIMS = dict(vocab_size=64, num_layers=2, num_heads=4, dim=32)


def _lm_batch(seq=8, batch=4):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, LM_DIMS["vocab_size"], (batch, seq + 1))
    return {"data": tokens[:, :-1].astype(np.float32),
            "softmax_label": tokens[:, 1:].astype(np.float32)}


def _lm_run(mx, par, mesh, steps, start=None, **kw):
    sym = mx.models.transformer.get_symbol(seq_len=8, **LM_DIMS)
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                              rescale_grad=1.0 / 32)
    tr = par.ShardedTrainer(sym, opt, mesh, **kw)
    mx.random.seed(4)
    p, s, a = tr.init_params({"data": (4, 8)},
                             label_shapes={"softmax_label": (4, 8)})
    init = _np(p)
    if start is not None:
        p = tr.place_params(start)
    b = tr.shard_batch(_lm_batch())
    for _ in range(steps):
        p, s, a, o = tr.step(p, s, a, b)
    return init, _np(p), np.asarray(o[0]), tr


def test_tp_lm_trainer_matches_jax():
    """The transformer LM (2 layers, dim 32, 4 heads) at tp=2 and at dp=2
    x tp=2: the head-split attention, the vocabulary-split embedding and
    the split position table, against the JAX trainer at tp=2 and the
    port at one device; zero whole-weight gathers."""
    init, jp, jo, _ = _lm_run(jmx, jpar, jpar.make_mesh(
        jax.devices()[:2], tp=2), 2)
    _i, one, _o, _t = _lm_run(tmx, tpar, tpar.make_mesh(CPUS[:1], dp=1),
                              2, start=init)
    for mesh in (tpar.make_mesh(CPUS[:2], tp=2),
                 tpar.make_mesh(CPUS[:4], dp=2, tp=2)):
        ttp.reset_counts()
        _i, got, out, tr = _lm_run(tmx, tpar, mesh, 2, start=init)
        assert ttp.counts()["whole_weight_gathers"] == 0
        _close(got, jp, 2e-6, "LM %s against JAX tp=2" % dict(mesh.shape))
        _close(got, one, 2e-6, "LM %s against one device"
               % dict(mesh.shape))
        np.testing.assert_allclose(out, jo, rtol=1e-5, atol=1e-6)
        cost = tr.compiled_step_cost_analysis()
        assert cost["members"] == mesh.size
        assert cost["flops_per_member"] == cost["flops"] / mesh.size


def test_tp_zero1_matches_tp():
    """ZeRO-1 on a dp=2 x tp=2 mesh: the replicated leaves' state split
    over dp, a tp-split leaf's state following its split; the weights bit
    for bit those of the plain tp step."""
    os.environ["MXTPU_FUSED_OPT"] = "1"
    try:
        mesh = tpar.make_mesh(CPUS[:4], dp=2, tp=2)
        _i, plain, _o, _t = _lm_run(tmx, tpar, mesh, 2)
        _i, z1, _o, tr = _lm_run(tmx, tpar, mesh, 2, zero1=True)
    finally:
        os.environ.pop("MXTPU_FUSED_OPT", None)
    for k in plain:
        np.testing.assert_array_equal(z1[k], plain[k], err_msg=k)
    assert tuple(tr.opt_state_sharding("final_ln_gamma", (32,)).spec) == \
        ("dp",)
    assert tuple(tr.opt_state_sharding("lm_head_weight", (64, 32)).spec) \
        == ("tp", None)


def test_op_without_a_tp_form_raises_naming_it():
    """A tp-split parameter read by an op with no tensor-parallel form
    (``dot``) raises, naming the op; nothing gathers the weight."""
    data = tmx.sym.Variable("data")
    w = tmx.sym.Variable("proj_weight", shape=(8, 4))
    net = tmx.sym.SoftmaxOutput(tmx.sym.dot(data, w), name="softmax")
    tr = tpar.ShardedTrainer(net, tmx.optimizer.create("sgd"),
                             tpar.make_mesh(CPUS[:2], tp=2))
    p, s, a = tr.init_params({"data": (4, 8)},
                             label_shapes={"softmax_label": (4,)})
    assert tuple(p["proj_weight"].sharding.spec) == ("tp", None)
    b = tr.shard_batch({"data": np.ones((4, 8), np.float32),
                        "softmax_label": np.zeros(4, np.float32)})
    ttp.reset_counts()
    with pytest.raises(MXNetError, match="dot.*no tensor-parallel form"):
        tr.step(p, s, a, b)
    assert ttp.counts()["whole_weight_gathers"] == 0


def test_a_gather_of_weight_parts_is_counted():
    """The counter has teeth: gathering a split parameter's parts (or
    views of them) counts a whole-weight gather; gathering activations
    does not."""
    g = ReplicaGroup([torch.device("cpu")] * 2)
    w = ttp.TPShards([torch.ones(2, 3), torch.zeros(2, 3)], g, 0)
    ttp.reset_counts()
    ttp.gather(g, [torch.ones(2), torch.ones(2)], 0)
    assert ttp.counts()["whole_weight_gathers"] == 0
    whole = ttp.gather(g, w.shards, 0)
    assert tuple(whole.shape) == (4, 3)
    ttp.gather(g, [s.t() for s in w.shards], 1)
    assert ttp.counts()["whole_weight_gathers"] == 2


def _split(v, dim, n=2):
    g = ReplicaGroup([torch.device("cpu")] * n)
    return ttp.TPShards(list(torch.chunk(v, n, dim)), g, dim)


@pytest.mark.parametrize("dim", [0, 1])
def test_embedding_tp_forms_match_the_op(dim):
    """Embedding over a table split on its vocabulary or its features:
    bit for bit the whole op's rows, NaN for ids outside the vocabulary,
    negative ids counting from the end."""
    from mxnet_tpu_torch.ops.registry import create_operator
    op = create_operator("Embedding", input_dim=8, output_dim=6)
    table = torch.tensor(np.random.RandomState(1).randn(8, 6),
                         dtype=torch.float32)
    ids = torch.tensor([[0, 3, 7, -1], [9, float("nan"), -9, 5]])
    want = op.forward([ids, table], [], False, None)[0][0]
    got = op.forward_tp([ids, _split(table, dim)], [], False, None)[0][0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dim,nh", [(0, 6), (1, 3)])
def test_dense_and_conv_tp_forms_match_the_ops(dim, nh):
    """FullyConnected split on its output features (with the bias) or, when
    they do not divide, its input features (partial products summed);
    Convolution split on its output or input channels."""
    from mxnet_tpu_torch.ops.registry import create_operator
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(5, 8), dtype=torch.float32)
    w = torch.tensor(rng.randn(nh, 8), dtype=torch.float32)
    b = torch.tensor(rng.randn(nh), dtype=torch.float32)
    fc = create_operator("FullyConnected", num_hidden=nh)
    want = fc.forward([x, w, b], [], False, None)[0][0]
    bias = _split(b, 0) if dim == 0 else b
    got = fc.forward_tp([x, _split(w, dim), bias], [], False, None)[0][0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    conv = create_operator("Convolution", kernel=(3, 3), num_filter=4,
                           pad=(1, 1))
    xc = torch.tensor(rng.randn(2, 6, 5, 5), dtype=torch.float32)
    wc = torch.tensor(rng.randn(4, 6, 3, 3), dtype=torch.float32)
    bc = torch.tensor(rng.randn(4), dtype=torch.float32)
    want = conv.forward([xc, wc, bc], [], False, None)[0][0]
    bias = _split(bc, 0) if dim == 0 else bc
    got = conv.forward_tp([xc, _split(wc, dim), bias], [], False,
                          None)[0][0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sharded_predictor_dp4_tp2_from_checkpoint(tmp_path):
    """``test_parallel.py:507-545``: a JAX Module's checkpoint served by
    the port's ShardedPredictor at dp=4 x tp=2 matches the JAX
    Predictor within 1e-5, the label slot bound as zeros, and the
    weights land split over tp."""
    from mxnet_tpu.predictor import Predictor

    def net(mx):
        d = mx.sym.Variable("data")
        h = mx.sym.FullyConnected(d, num_hidden=16, name="fc1")
        h = mx.sym.Activation(h, act_type="relu")
        out = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(out, name="softmax")
    mod = jmx.mod.Module(net(jmx), context=jmx.context.cpu())
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(jmx.init.Xavier())
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 0)
    x = np.random.RandomState(2).rand(8, 6).astype(np.float32)
    want = np.asarray(Predictor(prefix + "-symbol.json",
                                prefix + "-0000.params",
                                {"data": (8, 6)}).forward(data=x)[0])
    ttp.reset_counts()
    with tmx.cpu():
        sp = tpar.ShardedPredictor.from_checkpoint(
            prefix, 0, tpar.make_mesh(CPUS, dp=4, tp=2))
    got = sp.predict({"data": x})[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert "tp" in tuple(sp.params["fc1_weight"].sharding.spec)
    assert ttp.counts()["whole_weight_gathers"] == 0


def test_tp_checkpoint_saves_whole_arrays(tmp_path):
    """A tp trainer's checkpoint holds the whole arrays (the host format,
    as the JAX package writes it) and restores split as before."""
    mesh = tpar.make_mesh(CPUS[:4], dp=2, tp=2)
    _i, p_np, _o, tr = _lm_run(tmx, tpar, mesh, 1)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               rescale_grad=1.0 / 32)
    p = tr.place_params(p_np)
    st = {k: place(np.full(v.shape, 0.5, np.float32), mesh,
                   tr.opt_state_sharding(k, v.shape).spec)
          for k, v in p_np.items()}
    tr.save_checkpoint(str(tmp_path / "ck"), p, st, {})
    tr2 = tpar.ShardedTrainer(tmx.models.transformer.get_symbol(
        seq_len=8, **LM_DIMS), opt, mesh)
    p2, s2, _a = tr2.load_checkpoint(str(tmp_path / "ck"),
                                     {"data": (4, 8)},
                                     {"softmax_label": (4, 8)})
    for k in p_np:
        np.testing.assert_array_equal(np.asarray(p2[k]), p_np[k])
        assert p2[k].sharding.spec == p[k].sharding.spec
        np.testing.assert_array_equal(np.asarray(s2[k]),
                                      np.full(p_np[k].shape, 0.5))


GEN = dict(vocab_size=64, num_layers=2, num_heads=4, dim=32,
           max_seq_len=64)
GEN_KW = dict(max_new_tokens=5, prompt_buckets=(8, 16),
              decode_buckets=(1, 4), kv_blocks=24, kv_block_size=8, **GEN)
PROMPTS = [[3, 5, 7], [2, 4, 6, 8, 10, 1, 9], [9] * 13]


@pytest.fixture(scope="module")
def gen_params():
    from mxnet_tpu.models import transformer as jtf
    sym = jtf.get_decode_symbol(**GEN)
    caches = {"layer%d_att_%s_cache" % (i, c): (24, 8, 4, 8)
              for i in range(2) for c in "kv"}
    shapes, _, _ = sym.infer_shape(data=(1, 1), pos_ids=(1, 1),
                                   seq_pos=(1,), block_table=(1, 4),
                                   **caches)
    rng = np.random.RandomState(0)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "pos_ids", "seq_pos", "block_table") \
                or name.endswith("_cache"):
            continue
        w = rng.randn(*shape).astype(np.float32)
        params[name] = ((1.0 + 0.1 * w) if name.endswith("_gamma")
                        else 0.1 * w).astype(np.float32)
    return params


@pytest.mark.parametrize("quantize", [None, "int8", "fp8_e4m3"])
def test_tp_engine_matches_one_device_and_jax(gen_params, quantize):
    """``GenerationEngine(mesh=make_mesh(tp=2))``: its pools split on the
    head axis, its tokens the one-device engine's and (float32, int8)
    the JAX engine's on a tp=2 mesh, its logits within 1e-4 of the
    one-device engine's; no whole weight gathered."""
    from mxnet_tpu.serving import GenerationEngine as JEngine
    from mxnet_tpu_torch.serving import GenerationEngine as TEngine
    one = TEngine(dict(gen_params), ctx=tmx.cpu(), quantize=quantize,
                  **GEN_KW)
    ttp.reset_counts()
    eng = TEngine(dict(gen_params), mesh=tpar.make_mesh(CPUS[:2], tp=2),
                  quantize=quantize, **GEN_KW)
    assert [tuple(s.shape) for s in eng.cache.k_pools[0].shards] == \
        [(24, 8, 2, 8)] * 2
    one.collect_logits = eng.collect_logits = True
    want, got = one.generate(PROMPTS), eng.generate(PROMPTS)
    assert got == want
    for a, b in zip(eng.last_logits, one.last_logits):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert ttp.counts()["whole_weight_gathers"] == 0
    if quantize != "fp8_e4m3":
        jeng = JEngine(params=dict(gen_params), quantize=quantize or "",
                       mesh=jpar.make_mesh(jax.devices()[:2], tp=2),
                       **GEN_KW)
        assert jeng.generate(PROMPTS) == got


def test_engine_mesh_guards():
    """The engine serves one replica: a dp axis above 1 raises."""
    from mxnet_tpu_torch.serving import GenerationEngine as TEngine
    with pytest.raises(MXNetError, match="one replica"):
        TEngine({}, mesh=tpar.make_mesh(CPUS[:4], dp=2, tp=2), **GEN_KW)


def test_cache_sharding_rules_and_shard_pools_match_jax():
    """``test_kvcache.py:199-221``: the rules split the pools head-wise
    and keep the tables whole; on a tp=2 mesh with two heads each member
    holds one head, ``(4, 8, 1, 8)``."""
    from mxnet_tpu.serving.kvcache import (
        cache_sharding_rules as jrules, KVCacheConfig as JConfig,
        PagedKVCache as JCache)
    from mxnet_tpu_torch.serving.kvcache import (
        cache_sharding_rules, KVCacheConfig, PagedKVCache)
    rules, want = cache_sharding_rules(tp_axis="tp"), jrules(tp_axis="tp")
    for name, shape in (("layer0_k_cache", (8, 8, 4, 16)),
                        ("layer3_v_cache", (8, 8, 4, 16)),
                        ("block_table", (4, 13))):
        assert tuple(rules.match(name, shape)) == \
            tuple(want.match(name, shape))
    kw = dict(num_layers=1, num_heads=2, head_dim=8, max_seq_len=32,
              num_blocks=4, block_size=8)
    cache = PagedKVCache(KVCacheConfig(**kw), torch.device("cpu"))
    spec = cache.shard_pools(tpar.make_mesh(CPUS[:2], tp=2), tp_axis="tp")
    jcache = JCache(JConfig(**kw), init_pools=True)
    jspec = jcache.shard_pools(jax.sharding.Mesh(
        np.array(jax.devices()[:2]), ("tp",)), tp_axis="tp")
    assert tuple(spec) == tuple(jspec) == (None, None, "tp", None)
    assert {tuple(s.data.shape) for s in
            cache.k_pools[0].addressable_shards} == \
        {tuple(s.data.shape) for s in
         jcache.k_pools[0].addressable_shards} == {(4, 8, 1, 8)}


def test_tp_across_processes_raises_naming_its_item():
    """tp over the processes of a torch.distributed group is item 3
    (k): the collectives refuse it."""
    group = ReplicaGroup([torch.device("cpu")], num_processes=2)
    with pytest.raises(MXNetError, match=r"3 \(k\)"):
        ttp.gather(group, [torch.zeros(2)], 0)


def test_new_modules_import_without_jax():
    """The tp modules import with JAX blocked, and a dp=2 x tp=2 LM step
    and a tp engine run there."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mxnet_tpu'] = None\n"
            "import numpy as np\n"
            "import mxnet_tpu_torch as mx\n"
            "import mxnet_tpu_torch.parallel.tensor_parallel as tp\n"
            "import mxnet_tpu_torch.tools.cupti_probe\n"
            "from mxnet_tpu_torch.serving.kvcache import "
            "cache_sharding_rules\n"
            "cpus = [mx.cpu(i) for i in range(4)]\n"
            "m = mx.parallel.make_mesh(cpus, dp=2, tp=2)\n"
            "sym = mx.models.transformer.get_symbol(vocab_size=16, "
            "num_layers=1, num_heads=2, dim=8, seq_len=4)\n"
            "tr = mx.parallel.ShardedTrainer(sym, mx.optimizer.create("
            "'sgd'), m, fsdp=True)\n"
            "p, s, a = tr.init_params({'data': (2, 4)}, "
            "label_shapes={'softmax_label': (2, 4)})\n"
            "b = tr.shard_batch({'data': np.zeros((2, 4), np.float32), "
            "'softmax_label': np.zeros((2, 4), np.float32)})\n"
            "p, s, a, o = tr.step(p, s, a, b)\n"
            "print(tp.counts()['whole_weight_gathers'], "
            "mx.num_gpus(), mx.num_tpus())")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0", "0"]
