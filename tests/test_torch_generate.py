"""The PyTorch port's generation slice against the JAX package, on the CPU.

Same inputs, made with numpy from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (with ``ctx=cpu()``): symbol JSON across the
packages, 0x112 params files across the packages, one prefill and three
teacher-forced decode steps through both Predictors, and whole-engine
greedy generation in float32 and int8.  A subprocess proves the port
imports and generates with no JAX present, and the entry points refuse
to fall back to the CPU when no GPU is there.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.predictor import Predictor as JPredictor
from mxnet_tpu.serving import GenerationEngine as JEngine
from mxnet_tpu.serving import buckets as jbuckets

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.serving import GenerationEngine as TEngine
from mxnet_tpu_torch.serving import TokenStream
from mxnet_tpu_torch.serving import buckets as tbuckets
from mxnet_tpu_torch.serving.kvcache import (CacheExhausted, KVCacheConfig,
                                             PagedKVCache)

V, L, H, E, MAXLEN = 128, 2, 4, 64, 128     # a small LM of the same shape
NB, BS = 32, 8                              # pool blocks, block size
DIMS = dict(vocab_size=V, num_layers=L, num_heads=H, dim=E,
            max_seq_len=MAXLEN)
INPUTS = ("data", "pos_ids", "seq_pos", "block_table")


def _caches(mb_pool=(NB, BS, H, E // H)):
    return {"layer%d_att_%s_cache" % (i, c): mb_pool
            for i in range(L) for c in "kv"}


@pytest.fixture(scope="module")
def lm_params():
    """Seeded float32 weights of the generation graphs (JAX names and
    (out, in) layouts), with LayerNorm gains near 1."""
    sym = jtf.get_decode_symbol(**DIMS)
    shapes, _, _ = sym.infer_shape(data=(1, 1), pos_ids=(1, 1),
                                   seq_pos=(1,), block_table=(1, 4),
                                   **_caches())
    rng = np.random.RandomState(0)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in INPUTS or name.endswith("_cache"):
            continue
        w = rng.randn(*shape).astype(np.float32)
        params[name] = (1.0 + 0.1 * w) if name.endswith("_gamma") \
            else (0.1 * w).astype(np.float32)
    return {k: v.astype(np.float32) for k, v in params.items()}


# ---------------------------------------------------------------------------
# symbol JSON and 0x112 files across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_symbol_json_crosses_packages(mode):
    """Each package's generation symbol loads in the other and infers
    the same shapes; the port's JSON has the JAX graph's structure."""
    build = {"prefill": lambda m: m.get_prefill_symbol(16, **DIMS),
             "decode": lambda m: m.get_decode_symbol(**DIMS)}[mode]
    S = 16 if mode == "prefill" else 1
    shapes = dict(data=(2, S), pos_ids=(2, S), seq_pos=(2,),
                  block_table=(2, 6), **_caches())
    jsym, tsym = build(jtf), build(ttf)
    from_t = jmx.sym.load_json(tsym.tojson())
    from_j = tmx.sym.load_json(jsym.tojson())
    want = jsym.infer_shape(**shapes)
    for s in (from_t, from_j, tsym):
        assert s.list_arguments() == jsym.list_arguments()
        assert s.list_outputs() == jsym.list_outputs()
        assert s.infer_shape(**shapes) == want
    # node for node the same graph; only auto-generated names may differ
    jn = json.loads(jsym.tojson())
    tn = json.loads(tsym.tojson())
    assert [(n["op"], n["inputs"]) for n in jn["nodes"]] == \
        [(n["op"], n["inputs"]) for n in tn["nodes"]]
    assert jn["heads"] == tn["heads"] and jn["arg_nodes"] == tn["arg_nodes"]
    assert tmx.sym.load_json(tsym.tojson()).tojson() == tsym.tojson()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_params_file_crosses_packages(tmp_path, lm_params, direction):
    """A 0x112 file saved by either package loads in the other to the
    same values, and both packages write the same bytes."""
    arrays = dict(("arg:" + k, v) for k, v in lm_params.items())
    arrays["aux:counts"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, {k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in arrays.items()})
    tmx.nd.save(tpath, {k: torch.from_numpy(v) for k, v in arrays.items()})
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    if direction == "jax_to_torch":
        with tmx.cpu():
            loaded = tmx.nd.load(jpath)
        got = {k: v.asnumpy() for k, v in loaded.items()}
        moved = ttf.params_from_numpy(loaded, tmx.cpu())
        assert set(moved) == set(k[4:] for k in arrays)
    else:
        got = {k: v.asnumpy() for k, v in jmx.nd.load(tpath).items()}
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


def test_params_file_bfloat16_crosses_packages(tmp_path):
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "bf.params")
    tmx.nd.save(path, {"w": w.bfloat16()})
    back = jmx.nd.load(path)["w"].asnumpy()
    np.testing.assert_array_equal(back.astype(np.float32),
                                  w.bfloat16().float().numpy())
    jmx.nd.save(path, {"w": jmx.nd.load(path)["w"]})
    with tmx.cpu():
        assert torch.equal(tmx.nd.load(path)["w"].data, w.bfloat16())


# ---------------------------------------------------------------------------
# one prefill + three decode steps through both Predictors
# ---------------------------------------------------------------------------

def _step_inputs(rng, n_prompt, table_row):
    S = 16
    data = np.zeros((1, S), np.float32)
    data[0, :n_prompt] = rng.randint(0, V, size=n_prompt)
    return {"data": data,
            "pos_ids": np.arange(S, dtype=np.float32)[None, :],
            "seq_pos": np.array([n_prompt], np.float32),
            "block_table": table_row[None, :].astype(np.float32)}


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_predictors_teacher_forced(lm_params, quantize):
    """Prefill a 11-token prompt, then three decode steps at batch 2 (one
    live row, one padded row) feeding fixed tokens; logits and every
    pool agree with the JAX Predictors at atol 1e-4 after each step."""
    rng = np.random.RandomState(7)
    mb = 4
    pools = {k: rng.randn(*s).astype(np.float32)
             for k, s in _caches().items()}
    table = np.array([5, 9, 0, 0], np.int32)
    pre_in = _step_inputs(rng, 11, table)
    shapes = {k: v.shape for k, v in pre_in.items()}
    shapes.update({k: v.shape for k, v in pools.items()})
    preds = []
    for P, tf, kw in ((JPredictor, jtf, {}), (tmx.Predictor, ttf,
                                               {"ctx": tmx.cpu()})):
        pj = tf.get_prefill_symbol(16, **DIMS).tojson()
        dj = tf.get_decode_symbol(**DIMS).tojson()
        dshapes = dict(shapes, data=(2, 1), pos_ids=(2, 1), seq_pos=(2,),
                       block_table=(2, mb))
        preds.append((P(pj, dict(lm_params), shapes, quantize=quantize, **kw),
                      P(dj, dict(lm_params), dshapes, quantize=quantize, **kw)))
    state = [dict(pools), dict(pools)]
    names = sorted(pools)
    feeds = [pre_in]
    for step, tok in enumerate((17, 3, 101)):
        pos = 11 + step
        feeds.append({"data": np.array([[tok], [0]], np.float32),
                      "pos_ids": np.array([[pos], [0]], np.float32),
                      "seq_pos": np.array([pos, 0], np.float32),
                      "block_table": np.stack([table, np.zeros(mb, np.int32)])
                      .astype(np.float32)})
    for i, feed in enumerate(feeds):
        outs = []
        for (pre, dec), st in zip(preds, state):
            pred = pre if i == 0 else dec
            res = pred.forward(**feed, **st)
            head_names = pred.symbol.list_outputs()
            for name, val in zip(head_names[1:], res[1:]):
                layer = name.split("_att_")[0]
                kind = "k" if name.endswith("k_cache_out") else "v"
                st["%s_att_%s_cache" % (layer, kind)] = np.asarray(val)
            outs.append(np.asarray(res[0]))
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-4, rtol=0)
        for n in names:
            np.testing.assert_allclose(state[1][n], state[0][n], atol=1e-4,
                                       rtol=0)


# ---------------------------------------------------------------------------
# the whole engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_new_tokens=6, prompt_buckets=(8, 16),
                 decode_buckets=(1, 4), kv_blocks=NB, kv_block_size=BS,
                 **DIMS)
PROMPTS = [[3, 5, 7], [2, 4, 6, 8, 10, 1, 9], [9] * 13]


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engine_matches_jax(lm_params, quantize):
    """Greedy generation of 3 prompts: tokens identical up to the first
    step whose JAX top-2 logit gap is below 1e-4 (a near tie either
    package may break), and the per-step logits within atol 1e-4 up to
    that step."""
    jeng = JEngine(params=dict(lm_params), quantize=quantize or "",
                   **ENGINE_KW)
    teng = TEngine(dict(lm_params), ctx=tmx.cpu(), quantize=quantize,
                   **ENGINE_KW)
    assert teng.prompt_buckets == jeng.prompt_buckets
    assert teng.decode_buckets == jeng.decode_buckets
    jeng.collect_logits = teng.collect_logits = True
    jtoks, ttoks = jeng.generate(PROMPTS), teng.generate(PROMPTS)
    compared = 0
    for jt, tt, jl, tl in zip(jtoks, ttoks, jeng.last_logits,
                              teng.last_logits):
        assert len(tt) == len(jt) == 6
        for i in range(6):
            np.testing.assert_allclose(tl[i], jl[i], atol=1e-4, rtol=0)
            compared += 1
            if jt[i] != tt[i]:
                top2 = np.sort(jl[i])[-2:]
                assert top2[1] - top2[0] < 1e-4, (i, jt, tt)
                break
    assert compared >= 6
    st = teng.stats()
    assert st["serving_dtype"] == (quantize or "float32")
    assert st["kernel_path"] == "reference" and st["blocks_used"] == 0
    assert st["tokens_generated"] == 18 and st["decode_steps"] == 5


def test_engine_bfloat16_cache_matches_jax(lm_params):
    """A bfloat16 KV cache (16-token blocks, the JAX package's bfloat16
    granule).  The port keeps its pools in bfloat16.  mxnet_tpu widens
    them to float32 at the first step (its Predictor binds float32
    placeholders for the pools and ``NDArray._set_data`` casts to them),
    so the two caches differ by bfloat16 rounding of k and v (2^-9
    relative), which moves the logits by a few 1e-3: atol 2e-2, and
    tokens identical up to the first JAX top-2 gap below that."""
    kw = dict(ENGINE_KW, kv_block_size=16, cache_dtype="bfloat16")
    jeng = JEngine(params=dict(lm_params), quantize="", **kw)
    teng = TEngine(dict(lm_params), ctx=tmx.cpu(), **kw)
    jeng.collect_logits = teng.collect_logits = True
    jtoks, ttoks = jeng.generate(PROMPTS), teng.generate(PROMPTS)
    assert all(p.dtype == torch.bfloat16
               for p in teng.cache.k_pools + teng.cache.v_pools)
    for jt, tt, jl, tl in zip(jtoks, ttoks, jeng.last_logits,
                              teng.last_logits):
        np.testing.assert_allclose(tl[0], jl[0], atol=1e-4, rtol=0)
        for i in range(6):
            np.testing.assert_allclose(tl[i], jl[i], atol=2e-2, rtol=0)
            if jt[i] != tt[i]:
                top2 = np.sort(jl[i])[-2:]
                assert top2[1] - top2[0] < 2e-2, (i, jt, tt)
                break


def test_bucket_plans_match_jax():
    """The port plans the same buckets as JAX (the planner is copied
    with its cost model), including the full-width engine's defaults."""
    from mxnet_tpu.serving.generate import generation_mats as jmats
    from mxnet_tpu_torch.serving.generate import generation_mats as tmats
    for dims in ((8192, 8, 8, 512), (V, L, H, E)):
        assert tmats(*dims) == jmats(*dims)
        lin, quad = tmats(*dims)
        for hist, dt in (({240: 2.0, 480: 1.0, 960: 1.0}, "float32"),
                         ({1: 5.0, 3: 1.0, 7: 2.0, 12: 1.0, 33: 1.0},
                          "bfloat16")):
            for q in ((), quad):
                t = tbuckets.plan_buckets(hist, mats=lin, quad_mats=q,
                                          compute_dtype=dt, max_buckets=3)
                j = jbuckets.plan_buckets(hist, mats=lin, quad_mats=q,
                                          compute_dtype=dt, max_buckets=3)
                assert t.buckets == j.buckets
                assert t.to_dict() == j.to_dict()


def test_kv_cache_allocator():
    cache = PagedKVCache(KVCacheConfig(num_layers=1, num_heads=2,
                                       head_dim=4, max_seq_len=40,
                                       num_blocks=5, block_size=8),
                         torch.device("cpu"))
    assert cache.k_pools[0].shape == (5, 8, 2, 4)
    row = cache.allocate("a", 17)                 # 3 blocks
    assert row.dtype == np.int32 and row.tolist() == [1, 2, 3, 0, 0]
    with pytest.raises(CacheExhausted) as exc:
        cache.allocate("b", 16)
    assert exc.value.to_dict()["blocks_free"] == 1
    assert cache.free("a") == 3 and cache.blocks_free() == 4
    with pytest.raises(MXNetError):
        cache.free("a")
    with pytest.raises(MXNetError):
        KVCacheConfig(1, 2, 4, 40, dtype="int8")


def test_token_stream():
    stream = TokenStream()
    for tok in (5, 7):
        stream._put(tok)
    stream._close()
    assert list(stream) == [5, 7]
    failed = TokenStream()
    failed._put(1)
    failed._fail(MXNetError("step died"))
    assert failed.next_token() == 1
    with pytest.raises(MXNetError, match="step died"):
        failed.next_token()
    with pytest.raises(TimeoutError):
        TokenStream().next_token(timeout=0.01)


# ---------------------------------------------------------------------------
# isolation and device rules
# ---------------------------------------------------------------------------

def test_port_runs_without_jax():
    """In a fresh interpreter with jax made unimportable: import every
    module of the port, generate on the CPU, and load no mxnet_tpu
    module (conftest imports jax here, so only a subprocess proves
    it)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import numpy as np
        import mxnet_tpu_torch as mx
        for m in pkgutil.walk_packages(mx.__path__, "mxnet_tpu_torch."):
            importlib.import_module(m.name)
        from mxnet_tpu_torch.models import transformer as tf
        sym = tf.get_decode_symbol(vocab_size=32, num_layers=1,
                                   num_heads=2, dim=16, max_seq_len=32)
        caches = {"layer0_att_k_cache": (4, 8, 2, 8),
                  "layer0_att_v_cache": (4, 8, 2, 8)}
        shapes = sym.infer_shape(data=(1, 1), pos_ids=(1, 1),
                                 seq_pos=(1,), block_table=(1, 2),
                                 **caches)[0]
        rng = np.random.RandomState(0)
        params = {n: rng.randn(*s).astype(np.float32)
                  for n, s in zip(sym.list_arguments(), shapes)
                  if n not in caches and n not in
                  ("data", "pos_ids", "seq_pos", "block_table")}
        out = tf.generate(params, [[1, 2, 3]], vocab_size=32, num_layers=1,
                          num_heads=2, dim=16, max_seq_len=32,
                          max_new_tokens=3, prompt_buckets=(8,),
                          decode_buckets=(1,), kv_blocks=8,
                          kv_block_size=8, ctx=mx.cpu())
        assert len(out) == 1 and len(out[0]) == 3, out
        bad = sorted(m for m in sys.modules if m == "mxnet_tpu"
                     or m.startswith("mxnet_tpu."))
        assert not bad, bad
        print("ISOLATED")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout


@pytest.mark.parametrize("entry", ["engine", "predictor", "generate"])
def test_entry_points_refuse_silent_cpu(monkeypatch, lm_params, entry):
    """With no CUDA device, an entry point given no ctx raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        if entry == "engine":
            TEngine(dict(lm_params), **ENGINE_KW)
        elif entry == "predictor":
            tmx.Predictor(ttf.get_decode_symbol(**DIMS).tojson(),
                          dict(lm_params), {"data": (1, 1)})
        else:
            ttf.generate(dict(lm_params), [[1, 2]], **DIMS)
    with pytest.raises(MXNetError):
        tmx.tpu()


def test_kvcache_allocator_names_match_jax():
    """``blocks_used``, ``can_admit``, ``table_row``, ``active`` and
    ``occupancy`` of ``PagedKVCache`` answer as the JAX package's over the
    same allocations and frees."""
    from mxnet_tpu.serving.kvcache import (KVCacheConfig as JConfig,
                                           PagedKVCache as JCache)
    kw = dict(num_layers=1, num_heads=2, head_dim=8, max_seq_len=64,
              num_blocks=9, block_size=8)
    j = JCache(JConfig(**kw), init_pools=False)
    t = PagedKVCache(KVCacheConfig(**kw), torch.device("cpu"))

    def same():
        assert t.blocks_used() == j.blocks_used()
        assert t.active() == j.active()
        assert t.occupancy() == j.occupancy()
        for n in (1, 8, 9, 40, 64):
            assert t.can_admit(n) == j.can_admit(n), n
    same()
    for sid, n in (("a", 20), ("b", 9), ("c", 1)):
        np.testing.assert_array_equal(t.allocate(sid, n), j.allocate(sid, n))
        same()
    np.testing.assert_array_equal(t.table_row("b"), j.table_row("b"))
    row = t.table_row("b")
    row[:] = -1
    np.testing.assert_array_equal(t.table_row("b"), j.table_row("b"))
    t.free("a")
    j.free("a")
    same()
    with pytest.raises(MXNetError):
        t.table_row("a")
