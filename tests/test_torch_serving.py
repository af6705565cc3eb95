"""The port's in-process model server against the JAX package, on the CPU.

``mxnet_tpu_torch.serving`` (ContinuousBatcher, ModelServer,
GenerativeEntry, serve telemetry) twinned with ``tests/test_serving.py``'s
batcher and server tests and ``tests/test_generate.py``'s server tests,
with every model on ``ctx=cpu()``.  Then the two packages side by side on
the same inputs, made with numpy from a seed: one MLP JSON and its
params served by both ModelServers (results within 1e-5), a small LM
served by both in float32 and fp8 e4m3 (the same tokens), and the
``MXTPU_SERVE_*`` knobs giving both engines the same KV pool and the same
429 decision.  A subprocess serves with JAX made unimportable.
"""
import glob
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.serving import GenerationEngine as JEngine
from mxnet_tpu.serving import ModelServer as JServer
from mxnet_tpu.models import transformer as jtf

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import program_registry_stats
from mxnet_tpu_torch.resilience import faultinject
from mxnet_tpu_torch.serving import (BucketPlan, ContinuousBatcher,
                                     GenerationEngine, ModelServer,
                                     ServerBusy, serve_report)
from mxnet_tpu_torch.serving import kvcache as tkv
from mxnet_tpu_torch.serving.batcher import Request

SKEWED = {3: 100, 5: 40, 65: 10, 70: 2}     # pow2 ceils to {4, 8, 128}


# ---------------------------------------------------------------------------
# continuous batcher (duck-typed fake entries)
# ---------------------------------------------------------------------------

class FakeEntry(object):
    """Model entry double: payloads are numbers, results double them."""

    def __init__(self, name, buckets=(8,), priority=0, delay_s=0.0):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.priority = priority
        self.delay_s = delay_s
        self.launched = []              # (bucket, n_requests) in order

    def pack(self, requests, bucket):
        return [r.payload for r in requests]

    def launch(self, payload, bucket):
        self.launched.append((bucket, len(payload)))
        if self.delay_s:
            time.sleep(self.delay_s)
        return payload

    def unpack(self, handle, requests, bucket):
        return [p * 2 for p in handle], {"device_ms": self.delay_s * 1e3,
                                         "unpack_ms": 0.0}

    def waste(self, n, bucket):
        return 1.0 - n / float(bucket)


def test_batcher_round_trip_and_stats():
    b = ContinuousBatcher(max_delay_ms_=5, max_queue_=64)
    b.register(FakeEntry("m", buckets=(4,)))
    futs = [b.submit("m", i) for i in range(10)]
    assert [f.result(timeout=10) for f in futs] == [2 * i
                                                    for i in range(10)]
    st = b.stats()
    assert st["requests"] == 10 and st["failed"] == 0
    assert st["latency_ms"]["p95"] is not None
    assert 0.0 < st["occupancy"] <= 1.0
    b.close()


def test_batcher_packs_up_to_bucket():
    """A busy pipeline lets companions accumulate; batches never exceed
    the largest bucket."""
    entry = FakeEntry("m", buckets=(4,), delay_s=0.02)
    b = ContinuousBatcher(max_delay_ms_=200, max_queue_=64)
    b.register(entry)
    futs = [b.submit("m", i) for i in range(12)]
    for f in futs:
        f.result(timeout=10)
    assert all(n <= 4 for _, n in entry.launched), entry.launched
    assert any(n == 4 for _, n in entry.launched), entry.launched
    b.close()


def test_batcher_priority_selection():
    """_pick prefers higher priority, then the oldest head request."""
    b = ContinuousBatcher(max_delay_ms_=1000)
    lo, hi = FakeEntry("lo", priority=0), FakeEntry("hi", priority=5)
    b.register(lo)
    b.register(hi)
    b._pending["lo"].append(Request("lo", 1, 1))
    time.sleep(0.002)
    b._pending["hi"].append(Request("hi", 2, 1))
    entry, _q, kind = b._pick()
    assert entry.name == "hi" and kind == "predict"
    b._pending["hi"].clear()
    entry, _q, kind = b._pick()
    assert entry.name == "lo" and kind == "predict"
    b.close(drain=False)


def test_batcher_backpressure_structured_429():
    entry = FakeEntry("m", buckets=(8,), delay_s=0.2)
    b = ContinuousBatcher(max_delay_ms_=10_000, max_queue_=2)
    b.register(entry)
    busy = None
    for i in range(5):
        try:
            b.submit("m", i)
        except ServerBusy as exc:
            busy = exc
            break
    assert busy is not None, "queue bound of 2 never tripped in 5 submits"
    assert isinstance(busy, MXNetError)
    assert busy.code == 429 and busy.limit == 2
    assert busy.queue_depth >= busy.limit
    doc = busy.to_dict()
    assert doc["error"] == "server_busy" and doc["retry_after_ms"] is not None
    assert b.stats()["rejected"] == 1
    b.close()


def test_batcher_rejects_unknown_and_oversized():
    b = ContinuousBatcher()
    b.register(FakeEntry("m", buckets=(4,)))
    with pytest.raises(MXNetError):
        b.submit("nope", 1)
    with pytest.raises(MXNetError):
        b.submit("m", 0, n=5)
    b.close(drain=False)


def test_batcher_drain_flushes_then_refuses():
    entry = FakeEntry("m", buckets=(8,), delay_s=0.01)
    b = ContinuousBatcher(max_delay_ms_=10_000, max_queue_=64)
    b.register(entry)
    futs = [b.submit("m", i) for i in range(5)]
    b.drain(timeout=10)
    assert [f.result(timeout=1) for f in futs] == [0, 2, 4, 6, 8]
    with pytest.raises(ServerBusy) as exc_info:
        b.submit("m", 9)
    assert exc_info.value.code == 503
    b.close()


def test_batcher_failure_propagates_to_futures():
    class Exploding(FakeEntry):
        def launch(self, payload, bucket):
            raise RuntimeError("kaboom")
    b = ContinuousBatcher(max_delay_ms_=5)
    b.register(Exploding("m", buckets=(4,)))
    fut = b.submit("m", 1)
    with pytest.raises(RuntimeError, match="kaboom"):
        fut.result(timeout=10)
    assert b.stats()["failed"] == 1
    b.close(drain=False)


def test_batcher_emits_serve_telemetry(tmp_path, monkeypatch):
    """Each dispatched batch lands one 'serve' record in the rank's JSONL
    file; serve_report derives per-model QPS/latency from them."""
    from mxnet_tpu_torch.observability import events
    monkeypatch.setenv("MXTPU_TELEMETRY", "1")
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path))
    events.refresh()
    try:
        b = ContinuousBatcher(max_delay_ms_=5)
        b.register(FakeEntry("m", buckets=(4,)))
        futs = [b.submit("m", i) for i in range(8)]
        for f in futs:
            f.result(timeout=10)
        b.close()
        events.flush()
        records = [json.loads(line)
                   for path in glob.glob(str(tmp_path / "events-rank*.jsonl"))
                   for line in open(path)]
        serves = [r for r in records if r["kind"] == "serve"]
        assert serves, records
        for field in ("model", "bucket", "n_requests", "occupancy",
                      "padding_waste", "queue_wait_ms", "pack_ms",
                      "device_ms", "unpack_ms", "lat_ms"):
            assert field in serves[0], serves[0]
        rep = serve_report(records)
        assert rep["models"]["m"]["requests"] == 8
        assert rep["models"]["m"]["latency_ms"]["p95"] is not None
        assert rep["total"]["requests"] == 8
    finally:
        monkeypatch.delenv("MXTPU_TELEMETRY")
        monkeypatch.delenv("MXTPU_TELEMETRY_DIR")
        events.refresh()


def test_serve_is_a_registered_event_kind():
    from mxnet_tpu_torch.observability.events import KINDS
    assert "serve" in KINDS


# ---------------------------------------------------------------------------
# ModelServer end to end (a toy MLP on the CPU)
# ---------------------------------------------------------------------------

def _mlp_params(net, seed, batch=2, **shapes):
    """Seeded weights for every argument of ``net`` but its inputs."""
    arg_shapes, _, _ = net.infer_shape(data=(batch,) + shapes["data"])
    rng = np.random.RandomState(seed)
    return {"arg:" + n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


@pytest.fixture(scope="module")
def toy_model():
    net = mx.models.get_mlp(num_classes=3, hidden=(8,))
    return net, _mlp_params(net, 0, data=(10,))


def test_server_matches_serial_predictor(toy_model):
    net, params = toy_model
    srv = ModelServer(max_delay_ms=5)
    srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                  buckets=(1, 4), ctx=mx.cpu())
    rng = np.random.RandomState(3)
    payloads = [rng.rand(n, 10).astype("float32")
                for n in (1, 2, 4, 3, 1, 2)]
    futs = [srv.submit("toy", x) for x in payloads]
    got = [f.result(timeout=30) for f in futs]
    srv.close()
    for x, out in zip(payloads, got):
        ref = mx.Predictor(net.tojson(), params, {"data": x.shape},
                           ctx=mx.cpu()).forward(data=x)
        assert out[0].shape == (x.shape[0], 3)
        np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-6)


def test_server_zero_lowerings_after_warmup(toy_model):
    net, params = toy_model
    srv = ModelServer(max_delay_ms=2)
    srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                  histogram={1: 10, 3: 5, 4: 1}, ctx=mx.cpu())
    before = program_registry_stats()["lowerings"]
    rng = np.random.RandomState(5)
    futs = [srv.submit("toy", rng.rand(n, 10).astype("float32"))
            for n in (1, 3, 4) * 10]
    for f in futs:
        f.result(timeout=30)
    stats = srv.stats()
    srv.close()
    assert program_registry_stats()["lowerings"] == before
    assert stats["models"]["toy"]["lowerings_since_warmup"] == 0
    assert stats["registry"]["programs"] >= 1


def test_server_validates_inputs(toy_model):
    net, params = toy_model
    srv = ModelServer(max_delay_ms=2)
    srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                  buckets=(2,), ctx=mx.cpu())
    with pytest.raises(MXNetError):
        srv.submit("nope", np.zeros((1, 10), "float32"))
    with pytest.raises(MXNetError):
        srv.submit("toy", np.zeros((1, 7), "float32"))
    with pytest.raises(MXNetError):
        srv.submit("toy", np.zeros((3, 10), "float32"))
    out = srv.predict("toy", np.zeros(10, "float32"))
    assert out[0].shape == (1, 3)
    srv.close()


def test_server_plans_from_histogram(toy_model):
    net, params = toy_model
    srv = ModelServer(max_delay_ms=2)
    plan = srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                         histogram=SKEWED, max_buckets=3, ctx=mx.cpu())
    srv.close()
    assert isinstance(plan, BucketPlan)
    assert len(plan.buckets) <= 3
    assert plan.cost < plan.pow2_cost
    for size in SKEWED:
        assert plan.bucket_for(size) is not None


def test_server_add_checkpoint_swap_and_unported(toy_model, tmp_path,
                                                 monkeypatch):
    """add_checkpoint reads a save_checkpoint file pair; swap_params
    re-binds with zero lowerings, and an injected swap_crash leaves the
    old version serving; the warm hand-off (ported with the fleet) is
    off until MXTPU_WARM_REMESH asks for it, then restores the swapped
    weights."""
    net, params = toy_model
    prefix = str(tmp_path / "toy")
    sym_path, params_path = mx.serving.checkpoint_files(prefix, 3)
    net.save(sym_path)
    mx.nd.save(params_path, {k: torch.from_numpy(v)
                             for k, v in params.items()})
    x = np.random.RandomState(2).rand(2, 10).astype("float32")
    srv = ModelServer(max_delay_ms=2)
    srv.add_checkpoint("toy", prefix, 3, {"data": (10,)}, buckets=(2,),
                       ctx=mx.cpu())
    before = srv.predict("toy", x)[0]
    doubled = {k: 2 * v for k, v in params.items()}
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "kind=swap_crash")
    faultinject.reset()
    with pytest.raises(faultinject.InjectedFault):
        srv.swap_params(doubled)
    monkeypatch.delenv("MXTPU_FAULT_SPEC")
    faultinject.reset()
    np.testing.assert_array_equal(srv.predict("toy", x)[0], before)
    res = srv.swap_params(doubled, version="v9")
    assert res["lowerings"] == 0 and res["version"] == "v9"
    after = srv.predict("toy", x)[0]
    want = mx.Predictor(net.tojson(), doubled, {"data": x.shape},
                        ctx=mx.cpu()).forward(data=x)[0]
    np.testing.assert_allclose(after, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(after, before)
    from mxnet_tpu_torch.resilience import HotStateUnavailable
    monkeypatch.setenv("MXTPU_HANDOFF_DIR", str(tmp_path / "handoff"))
    monkeypatch.delenv("MXTPU_WARM_REMESH", raising=False)
    srv.snapshot_hotstate(step=3)
    with pytest.raises(HotStateUnavailable, match="disabled"):
        ModelServer().warm_resume_models(ctx=mx.cpu())
    monkeypatch.setenv("MXTPU_WARM_REMESH", "1")
    warm = ModelServer(max_delay_ms=2)
    assert warm.warm_resume_models(ctx=mx.cpu()) == ["toy"]
    np.testing.assert_array_equal(warm.predict("toy", x)[0], after)
    warm.close()
    srv.close()


# ---------------------------------------------------------------------------
# predictor satellites
# ---------------------------------------------------------------------------

def test_second_predictor_zero_lowerings(toy_model):
    net, params = toy_model
    p1 = mx.Predictor(net.tojson(), params, {"data": (2, 10)}, ctx=mx.cpu())
    stats1 = mx.Predictor.compile_stats()
    p2 = mx.Predictor(net.tojson(), params, {"data": (2, 10)}, ctx=mx.cpu())
    stats2 = mx.Predictor.compile_stats()
    assert stats2["lowerings"] == stats1["lowerings"]
    assert stats2["hits"] > stats1["hits"]
    x = np.random.rand(2, 10).astype("float32")
    np.testing.assert_allclose(p1.forward(data=x)[0],
                               p2.forward(data=x)[0], rtol=1e-6)
    p3 = p1.reshape({"data": (5, 10)})
    assert mx.Predictor.compile_stats()["lowerings"] == stats1["lowerings"]
    assert p3.forward(data=np.zeros((5, 10), "float32"))[0].shape == (5, 3)


def test_program_registry_builds_once_under_threads():
    """Sixteen threads bind Predictors of one new symbol at once, with a
    short switch interval: the registry builds its program once and
    every other bind is a hit."""
    import threading
    net = mx.models.get_mlp(num_classes=7, hidden=(13, 11))
    params = _mlp_params(net, 9, data=(6,))
    before = program_registry_stats()
    preds, errors = [], []

    def bind():
        try:
            preds.append(mx.Predictor(net.tojson(), params, {"data": (2, 6)},
                                      ctx=mx.cpu()))
        except Exception as exc:
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bind) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    after = program_registry_stats()
    assert len(preds) == 16
    assert after["lowerings"] - before["lowerings"] == 1
    assert after["hits"] - before["hits"] == 15
    assert len({id(p._exec._program) for p in preds}) == 1


def test_forward_async_matches_forward(toy_model):
    net, params = toy_model
    pred = mx.Predictor(net.tojson(), params, {"data": (2, 10)},
                        ctx=mx.cpu())
    x = np.random.rand(2, 10).astype("float32")
    ref = pred.forward(data=x)
    raw = pred.forward_async(data=x)
    assert len(raw) == len(ref) and isinstance(raw[0], torch.Tensor)
    np.testing.assert_allclose(raw[0].numpy(), ref[0], rtol=1e-6)
    with pytest.raises(MXNetError):
        pred.forward_async(data=np.zeros((3, 10), "float32"))


def test_forward_async_results_survive_next_dispatch(toy_model):
    """Async results are owned by the caller: dispatching batch N+1 does
    not clobber batch N's tensors (plain forward's output slots would)."""
    net, params = toy_model
    pred = mx.Predictor(net.tojson(), params, {"data": (1, 10)},
                        ctx=mx.cpu())
    xa = np.full((1, 10), 0.25, "float32")
    xb = np.full((1, 10), 0.75, "float32")
    ref_a = pred.forward(data=xa)[0].copy()
    raw_a = pred.forward_async(data=xa)
    _raw_b = pred.forward_async(data=xb)
    pred.forward(data=xb)
    np.testing.assert_allclose(raw_a[0].numpy(), ref_a, rtol=1e-6)


# ---------------------------------------------------------------------------
# generative serving (a small LM)
# ---------------------------------------------------------------------------

V, L, H, E, S = 64, 2, 4, 32, 64
LM = dict(vocab_size=V, num_layers=L, num_heads=H, dim=E, max_seq_len=S)
GEN_KW = dict(LM, max_new_tokens=6, prompt_buckets=(8, 16),
              decode_buckets=(1, 2, 4), kv_blocks=32, kv_block_size=8)
PROMPTS = [[3, 5, 7], [2, 4, 6, 8, 10, 1], [9, 1] * 6]


@pytest.fixture(scope="module")
def lm_params():
    """Seeded float32 weights of the generation graphs (LayerNorm gains
    near 1), as numpy."""
    sym = jtf.get_decode_symbol(**LM)
    caches = {"layer%d_att_%s_cache" % (i, c): (4, 8, H, E // H)
              for i in range(L) for c in "kv"}
    shapes, _, _ = sym.infer_shape(data=(1, 1), pos_ids=(1, 1),
                                   seq_pos=(1,), block_table=(1, 2),
                                   **caches)
    rng = np.random.RandomState(0)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in caches or name in ("data", "pos_ids", "seq_pos",
                                      "block_table"):
            continue
        w = rng.randn(*shape).astype(np.float32)
        params[name] = (1.0 + 0.1 * w) if name.endswith("_gamma") \
            else (0.3 * w).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def gen_server(lm_params):
    srv = ModelServer(max_delay_ms=2.0)
    engine = srv.add_generative_model("lm", dict(lm_params), ctx=mx.cpu(),
                                      **GEN_KW)
    yield srv, engine
    srv.close()


def test_server_generate_matches_engine(gen_server):
    """The batcher-driven path gives the inline engine loop's tokens,
    streamed token by token."""
    srv, engine = gen_server
    expect = engine.generate(PROMPTS[:2], max_new_tokens=6)
    handles = [srv.generate("lm", p, max_new_tokens=6) for p in PROMPTS[:2]]
    for (future, stream), want, prompt in zip(handles, expect, PROMPTS):
        streamed = list(stream)
        res = future.result(timeout=60)
        assert res["tokens"] == want
        assert streamed == want
        assert res["finish_reason"] == "length"
        assert res["n_prompt"] == len(prompt)


def test_server_generate_zero_steady_state_lowerings(gen_server):
    srv, _engine = gen_server
    srv.generate_sync("lm", [1, 2, 3, 4, 5], timeout=60)
    for _ in range(3):
        srv.generate_sync("lm", [7, 8], timeout=60)
    m = srv.stats()["models"]["lm"]
    assert m["generative"] is True
    assert m["lowerings_since_warmup"] == 0
    assert m["tokens_generated"] > 0
    assert m["seqs_active"] == 0
    assert m["kernel_path"] == "reference"


def test_server_generate_eos_finishes_early(gen_server):
    srv, engine = gen_server
    full = engine.generate([PROMPTS[2]], max_new_tokens=6)[0]
    res = srv.generate_sync("lm", PROMPTS[2], eos_id=full[1], timeout=60)
    stop = full.index(full[1])
    assert res["tokens"] == full[:stop + 1]
    assert res["finish_reason"] == "eos"


def test_inline_generate_beside_an_open_server(gen_server):
    """``engine.generate()`` while the server's scheduler polls: the
    scheduler never steps the call's sequences (it would finish and
    release them under the call), whatever the poll's phase; the tokens
    stay the call's own."""
    srv, engine = gen_server
    want = engine.generate([PROMPTS[2]], max_new_tokens=6)[0]
    rng = np.random.RandomState(4)
    for delay in rng.uniform(0, 0.06, 30):
        srv.generate_sync("lm", PROMPTS[0], timeout=60)
        time.sleep(delay)
        assert engine.generate([PROMPTS[2]], max_new_tokens=6)[0] == want
    assert srv.stats()["models"]["lm"]["seqs_active"] == 0


def test_server_generate_429_with_blocks_free(lm_params):
    """KV exhaustion at admission is a structured 429 carrying
    blocks_free, while the running decode completes untouched."""
    srv = ModelServer(max_delay_ms=2.0)
    srv.add_generative_model(
        "lm", dict(lm_params), ctx=mx.cpu(),
        **dict(GEN_KW, prompt_buckets=(16,), decode_buckets=(1, 2),
               kv_blocks=4))
    try:
        future, _stream = srv.generate("lm", [1, 2, 3], max_new_tokens=6)
        rejected = None
        for _ in range(50):
            try:
                srv.generate("lm", [4, 5, 6], max_new_tokens=6)
            except ServerBusy as busy:
                rejected = busy
                break
        assert rejected is not None
        doc = rejected.to_dict()
        assert rejected.code == 429
        assert doc["error"] == "kv_cache_exhausted"
        assert doc["blocks_total"] == 3
        assert doc["blocks_free"] >= 0
        assert rejected.retry_after_ms > 0
        assert len(future.result(timeout=60)["tokens"]) == 6
        deadline = time.time() + 30
        while srv.stats()["models"]["lm"]["blocks_used"] and \
                time.time() < deadline:
            time.sleep(0.01)
        assert srv.stats()["models"]["lm"]["blocks_used"] == 0
    finally:
        srv.close()


def test_server_submit_rejects_generative(gen_server):
    srv, _engine = gen_server
    with pytest.raises(MXNetError):
        srv.submit("lm", np.zeros((1, 4), np.float32))
    with pytest.raises(MXNetError):
        srv.generate("nope", [1, 2])


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

def test_mlp_server_matches_jax_server():
    """One mxnet_tpu MLP JSON and its params, carried across as numpy,
    served by both ModelServers: the same bucket plan (planned from the
    model's own matmul rows) and results within 1e-5."""
    net_j = jmx.models.get_mlp(num_classes=10, hidden=(32, 16))
    params = _mlp_params(mx.sym.load_json(net_j.tojson()), 4, data=(20,))
    rng = np.random.RandomState(6)
    payloads = [rng.rand(n, 20).astype("float32") for n in (1, 3, 4, 2, 1)]
    results = []
    for server, kw in ((JServer, {}), (ModelServer, {"ctx": mx.cpu()})):
        srv = server(max_delay_ms=2)
        plan = srv.add_model("mlp", net_j.tojson(), dict(params),
                             {"data": (20,)}, histogram={1: 5, 2: 3, 4: 1},
                             **kw)
        futs = [srv.submit("mlp", x) for x in payloads]
        results.append((plan.to_dict(), [np.asarray(f.result(timeout=60)[0])
                                         for f in futs]))
        srv.close()
    (jb, jout), (tb, tout) = results
    assert tb == jb
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", ["float32", "fp8_e4m3"])
def test_lm_server_matches_jax_server(lm_params, quantize):
    """The small LM served by both packages' ModelServer, in float32 and
    with fp8 e4m3 weights: the same generated tokens."""
    q = None if quantize == "float32" else quantize
    tokens = []
    for server, kw in ((JServer, {"quantize": q or ""}),
                       (ModelServer, {"ctx": mx.cpu(), "quantize": q})):
        srv = server(max_delay_ms=2.0)
        eng = srv.add_generative_model("lm", dict(lm_params),
                                       **dict(GEN_KW, decode_buckets=(4,)),
                                       **kw)
        assert eng.serving_dtype == quantize
        handles = [srv.generate("lm", p) for p in PROMPTS]
        tokens.append([f.result(timeout=120)["tokens"] for f, _s in handles])
        srv.close()
    assert tokens[1] == tokens[0]
    assert all(len(t) == 6 for t in tokens[0])


@pytest.mark.parametrize("env", [
    {"MXTPU_SERVE_KV_BLOCKS": "6", "MXTPU_SERVE_KV_BLOCK_SIZE": "8",
     "MXTPU_SERVE_MAX_NEW_TOKENS": "5"},
    {"MXTPU_SERVE_KV_BLOCKS": "many", "MXTPU_SERVE_KV_BLOCK_SIZE": "",
     "MXTPU_SERVE_MAX_NEW_TOKENS": "4"}])
def test_env_knobs_match_jax(monkeypatch, lm_params, env):
    """With the MXTPU_SERVE_* knobs set (or unparsable: the defaults),
    both engines plan the same pool, block size and new-token cap, and
    admit and refuse the same requests."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(LM, prompt_buckets=(16,), decode_buckets=(1,))
    jeng = JEngine(params=dict(lm_params), quantize="", **kw)
    teng = GenerationEngine(dict(lm_params), ctx=mx.cpu(), **kw)
    for attr in ("num_blocks", "block_size", "blocks_per_seq"):
        assert getattr(teng.cache.config, attr) == \
            getattr(jeng.cache.config, attr), attr
    assert teng.max_new == jeng.max_new
    assert teng.cache.blocks_total() == jeng.cache.blocks_total()
    decisions = []
    for eng, exc in ((jeng, jmx.serving.CacheExhausted),
                     (teng, tkv.CacheExhausted)):
        out = []
        for i, n in enumerate((16, 3, 9, 16, 1, 16, 12)):
            try:
                eng.admit(i, list(range(1, n + 1)))
                out.append("ok")
            except exc as e:
                out.append(e.to_dict())
        decisions.append(out)
    assert decisions[1] == decisions[0]
    assert tkv.kv_blocks() == jmx.serving.kvcache.kv_blocks()
    assert tkv.kv_block_size() == jmx.serving.kvcache.kv_block_size()
    assert tkv.max_new_tokens() == jmx.serving.kvcache.max_new_tokens()


def test_unparsable_knobs_fall_back_as_jax(monkeypatch):
    for name in ("MXTPU_SERVE_KV_BLOCKS", "MXTPU_SERVE_KV_BLOCK_SIZE",
                 "MXTPU_SERVE_MAX_NEW_TOKENS"):
        monkeypatch.setenv(name, "1.5")
    assert (tkv.kv_blocks(), tkv.kv_block_size(), tkv.max_new_tokens()) \
        == (256, 32, 64)
    for fn in ("kv_blocks", "kv_block_size", "max_new_tokens"):
        assert getattr(tkv, fn)() == getattr(jmx.serving.kvcache, fn)()
        assert getattr(tkv, fn)(7) == getattr(jmx.serving.kvcache, fn)(7)


def test_max_buckets_knob_matches_jax(monkeypatch):
    """MXTPU_SERVE_MAX_BUCKETS bounds both planners alike."""
    from mxnet_tpu.serving import buckets as jbuckets
    from mxnet_tpu_torch.serving import buckets as tbuckets
    hist = {1: 50, 9: 30, 17: 20, 33: 10, 65: 5, 129: 1}
    for raw, k in (("2", 2), ("junk", 4)):
        monkeypatch.setenv("MXTPU_SERVE_MAX_BUCKETS", raw)
        t, j = tbuckets.plan_buckets(hist), jbuckets.plan_buckets(hist)
        assert t.buckets == j.buckets and len(t.buckets) == k


@pytest.mark.parametrize("graph", ["mlp", "decode"])
def test_model_matmul_dims_match_jax(graph):
    """The planner's per-sample matmul rows of a Symbol, as the JAX
    package's cost model gives them."""
    from mxnet_tpu.serving.buckets import model_matmul_dims as jrows
    from mxnet_tpu_torch.serving.buckets import model_matmul_dims as trows
    if graph == "mlp":
        jsym = jmx.models.get_mlp(num_classes=10, hidden=(128, 64))
        shapes, batch = {"data": (4, 96)}, 4
    else:
        jsym = jtf.get_decode_symbol(**LM)
        shapes = dict({"data": (2, 1), "pos_ids": (2, 1), "seq_pos": (2,),
                       "block_table": (2, 4)},
                      **{"layer%d_att_%s_cache" % (i, c): (8, 8, H, E // H)
                         for i in range(L) for c in "kv"})
        batch = 2
    tsym = mx.sym.load_json(jsym.tojson())
    assert trows(tsym, shapes, batch=batch) == jrows(jsym, shapes,
                                                     batch=batch)


def test_quantize_env_is_the_default(monkeypatch, lm_params):
    """MXTPU_QUANTIZE is the default of quantize in both entry points."""
    monkeypatch.setenv("MXTPU_QUANTIZE", "fp8_e4m3")
    eng = GenerationEngine(dict(lm_params), ctx=mx.cpu(),
                           **dict(GEN_KW, prompt_buckets=(8,),
                                  decode_buckets=(1,)))
    assert eng.serving_dtype == "fp8_e4m3"
    net = mx.models.get_mlp(num_classes=3, hidden=(16,))
    pred = mx.Predictor(net.tojson(), _mlp_params(net, 1, data=(16,)),
                        {"data": (1, 16)}, ctx=mx.cpu())
    assert [n["op"] for n in json.loads(pred.symbol.tojson())["nodes"]
            ].count("QuantizedDense") == 2
    w = pred._exec.arg_dict["fc1_weight"]
    assert w.dtype == torch.float8_e4m3fn
    host = w.asnumpy()                  # numpy has no fp8: the values
    assert host.dtype == np.float32
    assert np.array_equal(host, w.data.float().numpy())


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------

def test_server_runs_without_jax():
    """In a fresh interpreter with jax made unimportable: the serving and
    observability packages import, and a ModelServer serves an MLP and
    generates on the CPU, loading no mxnet_tpu module."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import mxnet_tpu_torch as mx
        import mxnet_tpu_torch.observability as obs
        from mxnet_tpu_torch.serving import (ContinuousBatcher,
                                             GenerativeEntry, ModelServer)
        from mxnet_tpu_torch.models import transformer as tf
        assert obs.percentile([1, 2, 3], 50) == 2
        net = mx.models.get_mlp(num_classes=3, hidden=(4,))
        shapes = net.infer_shape(data=(1, 5))[0]
        params = {n: np.ones(s, np.float32)
                  for n, s in zip(net.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        kw = dict(vocab_size=32, num_layers=1, num_heads=2, dim=16,
                  max_seq_len=32)
        sym = tf.get_decode_symbol(**kw)
        caches = {"layer0_att_k_cache": (4, 8, 2, 8),
                  "layer0_att_v_cache": (4, 8, 2, 8)}
        lshapes = sym.infer_shape(data=(1, 1), pos_ids=(1, 1),
                                  seq_pos=(1,), block_table=(1, 2),
                                  **caches)[0]
        rng = np.random.RandomState(0)
        lm = {n: rng.randn(*s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), lshapes)
              if n not in caches and n not in
              ("data", "pos_ids", "seq_pos", "block_table")}
        with ModelServer(max_delay_ms=1) as srv:
            srv.add_model("mlp", net.tojson(), params, {"data": (5,)},
                          buckets=(2,), ctx=mx.cpu())
            out = srv.predict("mlp", np.ones((2, 5), np.float32))
            assert out[0].shape == (2, 3)
            srv.add_generative_model("lm", lm, ctx=mx.cpu(),
                                     quantize="fp8_e4m3", max_new_tokens=3,
                                     prompt_buckets=(8,),
                                     decode_buckets=(1,), kv_blocks=8,
                                     kv_block_size=8, **kw)
            res = srv.generate_sync("lm", [1, 2, 3])
            assert len(res["tokens"]) == 3, res
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
