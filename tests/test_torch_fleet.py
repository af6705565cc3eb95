"""Parity twins of ``tests/test_fleet.py`` for the port's fleet
(``mxnet_tpu_torch.serving.fleet``): FileKV, heartbeat liveness scan,
router admission math, failover, live weight hot-swap, leader lease,
tenants, KV fault discipline, swap-on-commit, and the fleet telemetry
rollup -- the same tests over the port.

Router tests run against duck-typed fake replica clients (no
subprocesses, no HTTP); the swap tests drive ModelServer.swap_params on
a toy MLP on the CPU.  Cross-package cases hold the npz codec and
``fleet_report`` to the JAX package's, and pin the first-election KV
fault as recorded, not swallowed.  The last test launches a real
two-replica fleet (subprocesses, HTTP, a JAX-saved checkpoint) and
drives failover, respawn, the rolling swap and drain end to end.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import program_registry_stats
from mxnet_tpu_torch.kvstore import scan_dead_ranks
from mxnet_tpu_torch.resilience.netkv import CoordKV, KVUnreachable
from mxnet_tpu_torch.serving import ModelServer, ServerBusy
from mxnet_tpu_torch.serving.fleet import (_SWAP_PTR_KEY, FileKV, FleetRouter,
                                     NotLeader, ReplicaDead,
                                     decode_arrays, encode_arrays,
                                     fleet_ledger_path, fleet_max_queue,
                                     fleet_routers, fleet_tenants)
from mxnet_tpu_torch.serving.telemetry import fleet_report


# ---------------------------------------------------------------------------
# FileKV: the file-backed coordination-client stand-in
# ---------------------------------------------------------------------------

def test_filekv_roundtrip_and_prefix_scan(tmp_path):
    kv = FileKV(tmp_path / "kv")
    kv.key_value_set("mxtpu_hb/0", "1.5")
    kv.key_value_set("mxtpu_hb/1", "2.5")
    kv.key_value_set("other/0", "9")
    got = dict(kv.key_value_dir_get("mxtpu_hb/"))
    assert got == {"mxtpu_hb/0": "1.5", "mxtpu_hb/1": "2.5"}
    # last write wins (the heartbeat stamp pattern)
    kv.key_value_set("mxtpu_hb/0", "3.5")
    assert dict(kv.key_value_dir_get("mxtpu_hb/"))["mxtpu_hb/0"] == "3.5"
    kv.key_value_delete("mxtpu_hb/0")
    assert "mxtpu_hb/0" not in dict(kv.key_value_dir_get("mxtpu_hb/"))


def test_filekv_blocking_get(tmp_path):
    kv = FileKV(tmp_path / "kv")
    with pytest.raises(TimeoutError):
        kv.blocking_key_value_get("missing", 60)
    kv.key_value_set("k", "v")
    assert kv.blocking_key_value_get("k", 60) == "v"


def test_filekv_keys_with_slashes_are_flat_files(tmp_path):
    # heartbeat keys contain "/": they must quote into flat filenames,
    # never create subdirectories the prefix scan would miss
    kv = FileKV(tmp_path / "kv")
    kv.key_value_set("a/b/c", "x")
    assert dict(kv.key_value_dir_get("a/"))["a/b/c"] == "x"
    assert not any(p.is_dir() for p in (tmp_path / "kv").iterdir())


# ---------------------------------------------------------------------------
# liveness: the dead_nodes scan rule over a FileKV
# ---------------------------------------------------------------------------

@pytest.fixture(params=["file", "tcp"])
def any_kv(request, tmp_path):
    """A coordination KV over both backends — the router/heartbeat/
    ledger machinery must behave identically on file:// and tcp://."""
    if request.param == "file":
        yield FileKV(tmp_path / "kv")
        return
    from mxnet_tpu_torch.resilience.netkv import TcpKV, TcpKVServer
    srv = TcpKVServer(port=0).start()
    try:
        yield TcpKV(srv.host, srv.port, timeout_s=2.0)
    finally:
        srv.stop()


def test_scan_dead_ranks_fresh_vs_stale(tmp_path, monkeypatch):
    from mxnet_tpu_torch import kvstore as kvmod
    kv = FileKV(tmp_path / "kv")
    monkeypatch.setattr(kvmod, "_now", lambda: 100.0)
    kv.key_value_set("mxtpu_hb/0", "99.0")     # fresh
    kv.key_value_set("mxtpu_hb/1", "80.0")     # stale
    dead = scan_dead_ranks(kv, [0, 1, 2], created=95.0, timeout=10.0)
    # 1 is stale; 2 never stamped but the fleet is young (grace)
    assert dead == [1]
    dead = scan_dead_ranks(kv, [0, 1, 2], created=50.0, timeout=10.0)
    assert dead == [1, 2]                      # grace expired for 2


def test_router_health_loop_uses_shared_scan(tmp_path, any_kv):
    """A replica whose heartbeat goes stale is marked dead by the
    router's health loop — the same machinery dead_nodes uses, over
    file:// and tcp:// alike."""
    kv = any_kv
    now = time.time()
    kv.key_value_set("mxtpu_hb/0", str(now + 1000))  # forever fresh
    kv.key_value_set("mxtpu_hb/1", str(now - 1000))  # long stale
    router = FleetRouter([_OkClient(), _OkClient()], kv=kv,
                         max_queue=8, hb_timeout_s=5.0,
                         directory=str(tmp_path), respawn=False)
    try:
        from mxnet_tpu_torch.resilience import elastic
        led = None
        deadline = time.time() + 10
        while time.time() < deadline:
            st = router.stats()
            led = elastic.read_ledger(
                path=fleet_ledger_path(str(tmp_path)))
            # state flips before the fsync'd ledger write lands:
            # wait for both
            if st["replicas"]["1"]["state"] == "dead" and led:
                break
            time.sleep(0.1)
        st = router.stats()
        assert st["replicas"]["0"]["state"] == "ready"
        assert st["replicas"]["1"]["state"] == "dead"
        assert led["reason"] == "replica_death"
        assert led["members"] == [0]
        assert led["generation"] == 1
    finally:
        router.close(drain=False)


# ---------------------------------------------------------------------------
# fault seams
# ---------------------------------------------------------------------------

def test_replica_death_seam_returned_not_raised(monkeypatch):
    from mxnet_tpu_torch.resilience import faultinject
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "kind=replica_death:rank=2")
    faultinject.reset()
    assert faultinject.maybe_fault("replica_death", rank=1) is None
    spec = faultinject.maybe_fault("replica_death", rank=2)
    assert spec is not None and spec.kind == "replica_death"
    faultinject.reset()


def test_swap_crash_seam_raises(monkeypatch):
    from mxnet_tpu_torch.resilience import faultinject
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "kind=swap_crash")
    faultinject.reset()
    with pytest.raises(faultinject.InjectedFault):
        faultinject.maybe_fault("swap_install")
    faultinject.reset()


# ---------------------------------------------------------------------------
# router admission + dispatch over fake clients
# ---------------------------------------------------------------------------

class _OkClient(object):
    """Duck-typed replica client: records calls, returns instantly."""

    def __init__(self):
        self.calls = []
        self.trace_ids = []

    def predict(self, model, inputs, n=None, trace_id=None):
        self.calls.append(model)
        self.trace_ids.append(trace_id)
        return [np.zeros((int(n or 1), 2), dtype="float32")]

    def stats(self):
        return {"requests": len(self.calls)}

    def swap(self, params, version=None, timeout=None):
        return {"version": version or "v1", "lowerings": 0,
                "models": ["m"], "swap_ms": 0.1}

    def drain(self):
        return True

    def healthz(self):
        return True


class _BlockingClient(_OkClient):
    """Holds every predict until released — keeps work in flight so
    admission tests can fill the aggregate window deterministically."""

    def __init__(self):
        super(_BlockingClient, self).__init__()
        self.release = threading.Event()

    def predict(self, model, inputs, n=None, trace_id=None):
        assert self.release.wait(timeout=30)
        return super(_BlockingClient, self).predict(
            model, inputs, n=n, trace_id=trace_id)


class _DeadClient(_OkClient):
    def predict(self, model, inputs, n=None, trace_id=None):
        raise ConnectionError("replica gone")


def test_fleet_max_queue_defaults_to_replicas_times_serve(monkeypatch):
    monkeypatch.delenv("MXTPU_FLEET_MAX_QUEUE", raising=False)
    monkeypatch.setenv("MXTPU_SERVE_MAX_QUEUE", "32")
    assert fleet_max_queue(n_replicas=3) == 96
    monkeypatch.setenv("MXTPU_FLEET_MAX_QUEUE", "10")
    assert fleet_max_queue(n_replicas=3) == 10
    assert fleet_max_queue(7, n_replicas=3) == 7


def test_router_429_honors_aggregate_not_per_replica(tmp_path):
    """The fleet front door admits against the AGGREGATE depth (queue +
    total in-flight), not any single replica's bound: with max_queue=6
    over two blocked replicas, exactly 6 requests are admitted even
    though each replica alone would have rejected far sooner."""
    clients = [_BlockingClient(), _BlockingClient()]
    router = FleetRouter(clients, max_queue=6, directory=str(tmp_path),
                         respawn=False, threads=2)
    try:
        futs = [router.submit("m", {"x": np.zeros(1)}, n=1)
                for _ in range(6)]
        with pytest.raises(ServerBusy) as exc:
            router.submit("m", {"x": np.zeros(1)}, n=1)
        busy = exc.value
        assert busy.code == 429
        assert busy.queue_depth == 6          # aggregate, fleet-wide
        assert busy.limit == 6
        assert busy.retry_after_ms is not None
        for c in clients:
            c.release.set()
        for f in futs:
            f.result(timeout=30)
        # drained: the next request is admitted again
        router.submit("m", {"x": np.zeros(1)}, n=1).result(timeout=30)
    finally:
        router.close(drain=False)


def test_router_drain_returns_503_fleet_wide(tmp_path):
    clients = [_OkClient(), _OkClient()]
    router = FleetRouter(clients, max_queue=8, directory=str(tmp_path),
                         respawn=False, threads=2)
    try:
        router.predict("m", {"x": np.zeros(1)}, n=1, timeout=10)
        router.drain(timeout=10)
        with pytest.raises(ServerBusy) as exc:
            router.submit("m", {"x": np.zeros(1)}, n=1)
        assert exc.value.code == 503
        assert exc.value.reason == "draining"
    finally:
        router.close(drain=False)


def test_dead_replica_future_fails_structured_not_hangs(tmp_path):
    """Queued futures on a fleet with no survivors fail with a
    structured ReplicaDead carrying a to_dict payload — never hang."""
    router = FleetRouter([_DeadClient()], max_queue=8,
                         directory=str(tmp_path), respawn=False,
                         threads=1, rebind_wait_s=0.2)
    try:
        fut = router.submit("m", {"x": np.zeros(1)}, n=1)
        with pytest.raises(ReplicaDead) as exc:
            fut.result(timeout=15)
        doc = exc.value.to_dict()
        assert doc["error"] == "replica_dead"
        assert doc["model"] == "m"
        st = router.stats()
        assert st["replicas"]["0"]["state"] == "dead"
        assert st["generation"] == 1          # shrink verdict written
    finally:
        router.close(drain=False)


def test_router_fails_over_to_survivor(tmp_path):
    """Transport death on one replica retries on a sibling: the client
    sees a result, the dead replica leaves rotation, and the ledger
    records the shrink."""
    ok = _OkClient()
    router = FleetRouter([_DeadClient(), ok], max_queue=8,
                         directory=str(tmp_path), respawn=False,
                         threads=1)
    try:
        out = router.predict("m", {"x": np.zeros(1)}, n=1, timeout=15)
        assert out[0].shape == (1, 2)
        assert ok.calls == ["m"]
        st = router.stats()
        assert st["replicas"]["0"]["state"] == "dead"
        assert st["replicas"]["1"]["state"] == "ready"
        from mxnet_tpu_torch.resilience import elastic
        led = elastic.read_ledger(path=fleet_ledger_path(str(tmp_path)))
        assert led["reason"] == "replica_death"
        assert led["members"] == [1]
    finally:
        router.close(drain=False)


def test_router_least_loaded_spreads_work(tmp_path):
    class _SlowClient(_OkClient):
        def predict(self, model, inputs, n=None, trace_id=None):
            # long enough that requests overlap and inflight counts
            # drive the pick; instant fakes would let replica 0 (the
            # tie-break winner) legally serve everything
            time.sleep(0.02)
            return super(_SlowClient, self).predict(
                model, inputs, n=n, trace_id=trace_id)

    clients = [_SlowClient(), _SlowClient(), _SlowClient()]
    router = FleetRouter(clients, max_queue=64, directory=str(tmp_path),
                         respawn=False, threads=3)
    try:
        futs = [router.submit("m", {"x": np.zeros(1)}, n=1)
                for _ in range(30)]
        for f in futs:
            f.result(timeout=30)
        counts = [len(c.calls) for c in clients]
        assert sum(counts) == 30
        assert all(c > 0 for c in counts)     # nobody starved
    finally:
        router.close(drain=False)


def test_router_mints_and_threads_trace_ids(tmp_path):
    ok = _OkClient()
    router = FleetRouter([ok], max_queue=8, directory=str(tmp_path),
                         respawn=False, threads=1)
    try:
        router.predict("m", {"x": np.zeros(1)}, n=1, timeout=10)
        assert ok.trace_ids == [None]          # tracing off: no id
        fut = router.submit("m", {"x": np.zeros(1)}, n=1,
                            trace_id="req-42")
        fut.result(timeout=10)
        assert ok.trace_ids[-1] == "req-42"    # explicit id wins
    finally:
        router.close(drain=False)


def test_router_swap_holds_replica_out_only_during_rebind(tmp_path):
    clients = [_OkClient(), _OkClient()]
    router = FleetRouter(clients, max_queue=8, directory=str(tmp_path),
                         respawn=False, threads=2)
    try:
        res = router.swap("/dev/null", version="v2")
        assert sorted(res["replicas"]) == [0, 1]
        assert all(r["version"] == "v2"
                   for r in res["replicas"].values())
        assert len(res["swap_pause_ms"]) == 2
        st = router.stats()
        assert st["version_skew"] == {"v2": [0, 1]}
        assert all(r["state"] == "ready"
                   for r in st["replicas"].values())
        assert st["swap_pause_ms_p95"] is not None
    finally:
        router.close(drain=False)


def test_router_swap_failure_leaves_old_version_in_skew(tmp_path):
    class _BadSwap(_OkClient):
        def swap(self, params, version=None, timeout=None):
            raise ConnectionError("swap wire broke")

    router = FleetRouter([_OkClient(), _BadSwap()], max_queue=8,
                         directory=str(tmp_path), respawn=False,
                         threads=2)
    try:
        res = router.swap("/dev/null", version="v2")
        assert "error" in res["replicas"][1]
        st = router.stats()
        # skew report names the divergence: replica 0 on v2, 1 stale
        assert st["version_skew"]["v2"] == [0]
        assert 1 in st["version_skew"]["?"]
        assert st["replicas"]["1"]["state"] == "ready"   # still serving
        router.predict("m", {"x": np.zeros(1)}, n=1, timeout=10)
    finally:
        router.close(drain=False)


# ---------------------------------------------------------------------------
# npz transport codec
# ---------------------------------------------------------------------------

def test_npz_codec_roundtrip():
    arrays = {"data": np.arange(6, dtype="float32").reshape(2, 3),
              "mask": np.ones((2,), dtype="int32")}
    got = decode_arrays(encode_arrays(arrays))
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k])
    bare = np.arange(4, dtype="float32")
    np.testing.assert_array_equal(decode_arrays(encode_arrays(bare)),
                                  bare)


# ---------------------------------------------------------------------------
# live weight hot-swap on a real ModelServer (in-process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_model():
    net = mx.models.get_mlp(num_classes=3, hidden=(8,))
    arg_shapes, _, _ = net.infer_shape(data=(2, 10))
    rng = np.random.RandomState(5)
    params = {"arg:" + k: mx.nd.array(
        rng.uniform(-0.5, 0.5, shape).astype("float32"), ctx=mx.cpu())
        for k, shape in zip(net.list_arguments(), arg_shapes)
        if k not in ("data", "softmax_label")}
    return net, params


def _perturbed(params, scale=1.25, shift=0.01):
    return {k: mx.nd.array(v.asnumpy() * scale + shift, ctx=mx.cpu())
            for k, v in params.items()}


def test_swap_params_zero_lowerings_and_bit_identical(toy_model):
    """The hot-swap contract: new params re-bind through the program
    registry (zero new lowerings — the registry counters prove it) and
    post-swap outputs are bit-identical to a fresh Predictor over the
    new params."""
    net, params = toy_model
    v2 = _perturbed(params)
    v2_np = {k: v.asnumpy() for k, v in v2.items()}
    srv = ModelServer(max_delay_ms=2)
    srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                  buckets=(1, 4), ctx=mx.cpu())
    x = np.random.RandomState(11).rand(3, 10).astype("float32")
    before_out = srv.predict("toy", x, timeout=30)[0]
    before_lower = program_registry_stats()["lowerings"]
    res = srv.swap_params(v2, version="v2")
    assert res["version"] == "v2"
    assert res["lowerings"] == 0
    assert res["models"] == ["toy"]
    assert program_registry_stats()["lowerings"] == before_lower
    after_out = srv.predict("toy", x, timeout=30)[0]
    stats = srv.stats()
    srv.close()
    ref = mx.Predictor(net.tojson(), v2_np, {"data": x.shape},
                       ctx=mx.cpu()).forward(data=x)[0]
    assert np.array_equal(np.asarray(after_out), np.asarray(ref))
    assert not np.array_equal(np.asarray(after_out),
                              np.asarray(before_out))
    assert stats["param_version"] == "v2"


def test_swap_params_unknown_model_raises(toy_model):
    net, params = toy_model
    srv = ModelServer(max_delay_ms=2)
    srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                  buckets=(1,), ctx=mx.cpu())
    with pytest.raises(MXNetError):
        srv.swap_params(params, models=["nope"])
    srv.close()


def test_swap_crash_keeps_old_params_serving(toy_model, monkeypatch):
    """An injected swap_crash fires AFTER the new predictors are built
    but BEFORE install: the old version keeps serving untouched and
    param_version never advances — a failed swap is a no-op."""
    from mxnet_tpu_torch.resilience import faultinject
    net, params = toy_model
    srv = ModelServer(max_delay_ms=2)
    srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                  buckets=(1,), ctx=mx.cpu())
    x = np.random.RandomState(13).rand(1, 10).astype("float32")
    before_out = srv.predict("toy", x, timeout=30)[0]
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "kind=swap_crash")
    faultinject.reset()
    with pytest.raises(faultinject.InjectedFault):
        srv.swap_params(_perturbed(params), version="v2")
    monkeypatch.delenv("MXTPU_FAULT_SPEC")
    faultinject.reset()
    after_out = srv.predict("toy", x, timeout=30)[0]
    stats = srv.stats()
    srv.close()
    assert np.array_equal(np.asarray(after_out), np.asarray(before_out))
    assert stats["param_version"] == "v0"


@pytest.mark.parametrize("resume_env", ["fp8_e4m3", None, "int8"])
def test_quantized_model_keeps_its_weights_on_every_bucket_and_swap(
        tmp_path, monkeypatch, resume_env):
    """A model served under MXTPU_QUANTIZE=fp8_e4m3 computes with its
    quantized weights on every bucket, after swap_params and after a
    warm resume and a swap there: each equals a fresh quantized
    Predictor bit for bit and the JAX package's quantized Predictor at
    the same bucket.  The resuming process's MXTPU_QUANTIZE (the same,
    unset, another mode) changes nothing: the model keeps the mode it
    was served in."""
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu.models import transformer as jtf
    import mxnet_tpu as jmx
    monkeypatch.setenv("MXTPU_QUANTIZE", "fp8_e4m3")
    S, V = 8, 32
    cfg = dict(vocab_size=V, num_layers=1, num_heads=2, dim=16, seq_len=S)
    net = mx.sym.Reshape(tf.get_symbol(**cfg), shape=(-1, S, V))
    jnet = jmx.sym.Reshape(jtf.get_symbol(**cfg), shape=(-1, S, V))
    arg_shapes, _, _ = net.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.RandomState(7)

    def params(scale):
        return {"arg:" + k: (rng.uniform(-0.5, 0.5, shape) * scale)
                .astype("float32")
                for k, shape in zip(net.list_arguments(), arg_shapes)
                if k not in ("data", "softmax_label")}

    shapes = {"data": (S,), "softmax_label": (S,)}
    x = rng.randint(0, V, (2, S)).astype("float32")
    feed = {"data": x, "softmax_label": np.zeros_like(x)}

    def fresh(p, n):
        bound = {k: (n, S) for k in shapes}
        want = mx.Predictor(net.tojson(), p, bound, ctx=mx.cpu(),
                            quantize="fp8_e4m3").forward(
            data=x[:n], softmax_label=feed["softmax_label"][:n])[0]
        jwant = jmx.Predictor(jnet.tojson(), p, bound,
                              quantize="fp8_e4m3").forward(
            data=x[:n], softmax_label=feed["softmax_label"][:n])[0]
        want = want.asnumpy() if hasattr(want, "asnumpy") \
            else np.asarray(want)
        np.testing.assert_allclose(want, np.asarray(jwant), rtol=1e-5,
                                   atol=1e-6)
        return want

    v1, v2 = params(1.0), params(2.0)
    monkeypatch.setenv("MXTPU_WARM_REMESH", "1")
    monkeypatch.setenv("MXTPU_HANDOFF_DIR", str(tmp_path / "handoff"))
    srv = ModelServer(max_delay_ms=2)
    try:
        srv.add_model("lm", net.tojson(), v1, shapes, buckets=(1, 2),
                      ctx=mx.cpu())
        for n in (1, 2):
            got = srv.predict("lm", {k: v[:n] for k, v in feed.items()})
            np.testing.assert_array_equal(got[0], fresh(v1, n))
        assert srv.swap_params(v2, version="v2")["lowerings"] == 0
        for n in (1, 2):
            got = srv.predict("lm", {k: v[:n] for k, v in feed.items()})
            np.testing.assert_array_equal(got[0], fresh(v2, n))
        srv.snapshot_hotstate(step=1)
    finally:
        srv.close()
    if resume_env is None:
        monkeypatch.delenv("MXTPU_QUANTIZE")
    else:
        monkeypatch.setenv("MXTPU_QUANTIZE", resume_env)
    warm = ModelServer(max_delay_ms=2)
    try:
        assert warm.warm_resume_models(ctx=mx.cpu()) == ["lm"]
        np.testing.assert_array_equal(warm.predict("lm", feed)[0],
                                      fresh(v2, 2))
        assert warm.swap_params(v1, version="v3")["lowerings"] == 0
        np.testing.assert_array_equal(warm.predict("lm", feed)[0],
                                      fresh(v1, 2))
    finally:
        warm.close()


# ---------------------------------------------------------------------------
# fleet telemetry rollup
# ---------------------------------------------------------------------------

def _serve_rec(replica, version, lat, wall, n=2):
    return {"kind": "serve", "replica": replica,
            "param_version": version, "n_requests": n,
            "n_samples": n, "occupancy": 0.5, "lat_ms": lat,
            "wall_ms": wall}


def test_fleet_report_rollup_and_skew():
    records = [
        _serve_rec(0, "v1", [10.0, 12.0], 1000.0),
        _serve_rec(0, "v1", [11.0, 13.0], 2000.0),
        _serve_rec(1, "v2", [30.0, 50.0], 1000.0, n=6),
        _serve_rec(1, "v2", [40.0, 60.0], 3000.0, n=6),
        {"kind": "serve", "model": "m"},       # unstamped: ignored
        {"kind": "step", "replica": 0},        # wrong kind: ignored
    ]
    fl = fleet_report(records)
    assert sorted(fl["replicas"]) == ["0", "1"]
    r0, r1 = fl["replicas"]["0"], fl["replicas"]["1"]
    assert r0["requests"] == 4 and r1["requests"] == 12
    assert r0["param_version"] == "v1"
    assert r1["latency_ms"]["p95"] > r0["latency_ms"]["p95"]
    assert r0["qps"] == 4.0                    # 4 reqs over 1s span
    assert fl["version_skew"] == {"v1": [0], "v2": [1]}
    assert fl["straggler_gap_ms"] > 0
    assert fl["balance_ratio"] == 1.5          # 12 / mean(8)
    assert fl["requests"] == 16


def test_fleet_report_empty_without_replica_stamps():
    assert fleet_report([{"kind": "serve", "model": "m"}]) \
        == {"replicas": {}}


def test_build_report_carries_fleet_rollup():
    """The rollup a report carries is the JAX package's on the same
    records (the port has no ``observability.aggregate`` yet, so the
    twin holds ``fleet_report`` itself to the reference)."""
    from mxnet_tpu.serving.telemetry import fleet_report as jax_report
    records = [_serve_rec(0, "v1", [10.0], 1000.0),
               _serve_rec(1, "v1", [12.0], 1500.0)]
    for rec in records:
        rec.update(run_id="r", rank=0, model="m", bucket=2)
    got = fleet_report(records)
    assert sorted(got["replicas"]) == ["0", "1"]
    assert got == jax_report(records)


def test_set_fleet_context_stamps_serve_records(tmp_path, monkeypatch):
    from mxnet_tpu_torch.observability import events
    from mxnet_tpu_torch.serving import telemetry as tel
    monkeypatch.setenv("MXTPU_TELEMETRY", "1")
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path))
    events.refresh()
    try:
        tel.set_fleet_context(replica=3, param_version="v7")
        tel.emit_batch("m", 4, 2, 2, 0.5, 0.1, 0, 1.0, 0.1, 0.5, 0.1,
                       [3.0, 4.0])
        events.flush()
        recs = [json.loads(line)
                for p in tmp_path.glob("events-rank*.jsonl")
                for line in open(p) if line.strip()]
        serve = [r for r in recs if r.get("kind") == "serve"]
        assert serve and serve[-1]["replica"] == 3
        assert serve[-1]["param_version"] == "v7"
    finally:
        tel._FLEET.update(replica=None, param_version=None)
        monkeypatch.delenv("MXTPU_TELEMETRY")
        monkeypatch.delenv("MXTPU_TELEMETRY_DIR")
        events.refresh()


def test_fleet_names_are_exported():
    import mxnet_tpu_torch.serving as serving
    for name in ("FleetRouter", "FileKV", "ReplicaDead",
                 "fleet_report", "set_fleet_context", "FleetClient",
                 "NotLeader", "adopt_fleet", "connect_kv"):
        assert hasattr(serving, name)


# ---------------------------------------------------------------------------
# per-tenant admission lanes
# ---------------------------------------------------------------------------

def test_fleet_tenants_parsing(monkeypatch):
    monkeypatch.setenv("MXTPU_FLEET_TENANTS",
                       "teamA:50:100:3;teamB:10:20")
    cfg = fleet_tenants()
    assert cfg["teamA"] == {"rate": 50.0, "burst": 100.0, "weight": 3}
    assert cfg["teamB"] == {"rate": 10.0, "burst": 20.0, "weight": 1}
    assert fleet_tenants("") == {}
    with pytest.raises(ValueError):
        fleet_tenants("teamA:50")              # missing burst
    with pytest.raises(ValueError):
        fleet_tenants("a:1:2:3:4:5")           # too many fields


def test_hot_tenant_429s_while_default_flows(tmp_path):
    """A tenant over ITS token budget gets a structured 429 (reason
    "tenant budget") while the default lane keeps flowing — noisy
    neighbors burn their own bucket, never the fleet's door."""
    ok = _OkClient()
    router = FleetRouter([ok], max_queue=64, directory=str(tmp_path),
                         respawn=False, threads=1,
                         tenants="teamA:0.001:2")
    try:
        for _ in range(2):                     # burst=2 admitted
            router.submit("m", {"x": np.zeros(1)}, n=1,
                          tenant="teamA").result(timeout=10)
        with pytest.raises(ServerBusy) as exc:
            router.submit("m", {"x": np.zeros(1)}, n=1, tenant="teamA")
        busy = exc.value
        assert busy.code == 429
        assert busy.reason == "tenant budget"
        assert busy.to_dict()["tenant"] == "teamA"
        assert busy.limit == 2                 # the tenant's burst,
        assert busy.retry_after_ms is not None # not the fleet queue
        # siblings and the default lane are untouched by teamA's burn
        router.submit("m", {"x": np.zeros(1)}, n=1).result(timeout=10)
        st = router.stats()
        assert st["tenants"]["teamA"]["admitted"] == 2
        assert st["tenants"]["teamA"]["rejected"] == 1
    finally:
        router.close(drain=False)


def test_unknown_tenant_rides_default_lane(tmp_path):
    router = FleetRouter([_OkClient()], max_queue=8,
                         directory=str(tmp_path), respawn=False,
                         threads=1, tenants="teamA:100:100")
    try:
        # a tenant nobody configured is not rejected — it shares the
        # unbudgeted default lane
        router.submit("m", {"x": np.zeros(1)}, n=1,
                      tenant="stranger").result(timeout=10)
        st = router.stats()
        assert st["tenants"]["teamA"]["admitted"] == 0
    finally:
        router.close(drain=False)


def test_weighted_fair_dequeue_order(tmp_path):
    """Weight 3 vs 1 under contention: the dispatch order follows the
    weight-expanded cycle (a,a,a,b,...) deterministically."""
    client = _BlockingClient()
    router = FleetRouter([client], max_queue=64,
                         directory=str(tmp_path), respawn=False,
                         threads=1, tenants="a:100:100:3;b:100:100:1")
    try:
        futs = [router.submit("occupy", {"x": np.zeros(1)}, n=1)]
        deadline = time.time() + 10
        while time.time() < deadline:          # occupy is in flight:
            st = router.stats()                # everything else queues
            if st["replicas"]["0"]["inflight"] == 1:
                break
            time.sleep(0.02)
        for i in range(6):
            futs.append(router.submit("a", {"x": np.zeros(1)}, n=1,
                                      tenant="a"))
        for i in range(2):
            futs.append(router.submit("b", {"x": np.zeros(1)}, n=1,
                                      tenant="b"))
        client.release.set()
        for f in futs:
            f.result(timeout=30)
        assert client.calls == ["occupy",
                                "a", "a", "a", "b", "a", "a", "a", "b"]
    finally:
        router.close(drain=False)


def test_no_tenant_config_keeps_single_fifo(tmp_path):
    """Without MXTPU_FLEET_TENANTS the router is bit-for-bit the old
    single-FIFO front door: no tenant rollup, plain arrival order."""
    client = _BlockingClient()
    router = FleetRouter([client], max_queue=64,
                         directory=str(tmp_path), respawn=False,
                         threads=1)
    try:
        assert router._rr == ["default"]
        futs = [router.submit("m%d" % i, {"x": np.zeros(1)}, n=1,
                              tenant="ignored-%d" % i)
                for i in range(5)]
        client.release.set()
        for f in futs:
            f.result(timeout=30)
        assert client.calls == ["m%d" % i for i in range(5)]
        assert "tenants" not in router.stats()
    finally:
        router.close(drain=False)


# ---------------------------------------------------------------------------
# leader lease: N routers over one KV
# ---------------------------------------------------------------------------

def _fresh_stamps(kv, n):
    now = time.time()
    for i in range(n):
        kv.key_value_set("mxtpu_hb/%d" % i, str(now + 1000))


def _wait_for(predicate, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def test_standby_rejects_swap_and_takes_over_on_leader_exit(tmp_path,
                                                            any_kv):
    """Two routers, one KV: the second stands by, answers swap with a
    structured NotLeader naming the leader, and takes over within the
    health-loop cadence once the leader releases the lease."""
    kv = any_kv
    _fresh_stamps(kv, 1)
    a = FleetRouter([_OkClient()], kv=kv, max_queue=8,
                    directory=str(tmp_path / "a"), respawn=False,
                    threads=1, router_id="a", lease_ttl_s=2.0)
    b = None
    try:
        assert a.stats()["role"] == "leader"
        b = FleetRouter([_OkClient()], kv=kv, max_queue=8,
                        directory=str(tmp_path / "b"), respawn=False,
                        threads=1, router_id="b", lease_ttl_s=2.0)
        assert b.stats()["role"] == "standby"
        assert b.stats()["lease"]["holder"] == "b"
        with pytest.raises(NotLeader) as exc:
            b.swap("/dev/null", version="v2")
        doc = exc.value.to_dict()
        assert doc == {"error": "not_leader", "action": "swap",
                       "router_id": "b", "leader": "a"}
        # standbys still serve reads: predict works on either router
        b.predict("m", {"x": np.zeros(1)}, n=1, timeout=10)
        a.close(drain=False)                   # releases the lease
        assert _wait_for(
            lambda: b.stats()["role"] == "leader"), \
            "standby never took over after leader exit"
        st = b.stats()
        assert st["takeovers"] == 1
        res = b.swap("/dev/null", version="v2") # leader-only op now ok
        assert res["replicas"][0]["version"] == "v2"
    finally:
        if b is not None:
            b.close(drain=False)


def test_standby_mirrors_leader_death_verdicts(tmp_path):
    """The leader writes the shrink verdict ONCE; the standby adopts
    it from the published view (no double generation bump) and stops
    routing to the dead replica."""
    kv = FileKV(tmp_path / "kv")
    now = time.time()
    kv.key_value_set("mxtpu_hb/0", str(now + 1000))   # fresh
    kv.key_value_set("mxtpu_hb/1", str(now - 1000))   # long stale
    shared_dir = str(tmp_path / "fleet")
    a = FleetRouter([_OkClient(), _OkClient()], kv=kv, max_queue=8,
                    hb_timeout_s=5.0, directory=shared_dir,
                    respawn=False, threads=1, router_id="a",
                    lease_ttl_s=2.0)
    b = FleetRouter([_OkClient(), _OkClient()], kv=kv, max_queue=8,
                    hb_timeout_s=5.0, directory=shared_dir,
                    respawn=False, threads=1, router_id="b",
                    lease_ttl_s=2.0)
    try:
        assert _wait_for(lambda: b.stats()["replicas"]["1"]["state"]
                         == "dead"), "standby never mirrored verdict"
        st_a, st_b = a.stats(), b.stats()
        assert st_a["role"] == "leader" and st_b["role"] == "standby"
        assert st_b["replicas"]["1"]["reason"] == "leader verdict"
        from mxnet_tpu_torch.resilience import elastic
        led = elastic.read_ledger(path=fleet_ledger_path(shared_dir))
        assert led["generation"] == 1          # one verdict, not two
        assert st_a["generation"] == 1
        assert st_b["generation"] == 1         # adopted, not re-bumped
    finally:
        b.close(drain=False)
        a.close(drain=False)


# ---------------------------------------------------------------------------
# KV fault discipline in the router
# ---------------------------------------------------------------------------

class _PartitionableKV(CoordKV):
    """FileKV wrapper whose ``down`` flag simulates a KV partition."""

    def __init__(self, root):
        self.kv = FileKV(root)
        self.down = False

    def _gate(self):
        if self.down:
            raise KVUnreachable("injected partition", op="test")

    def key_value_set(self, key, value, allow_overwrite=True):
        self._gate()
        self.kv.key_value_set(key, value, allow_overwrite)

    def blocking_key_value_get(self, key, timeout_ms):
        self._gate()
        return self.kv.blocking_key_value_get(key, timeout_ms)

    def key_value_dir_get(self, prefix):
        self._gate()
        return self.kv.key_value_dir_get(prefix)

    def key_value_delete(self, key):
        self._gate()
        self.kv.key_value_delete(key)


def test_kv_partition_mid_scan_never_fabricates_deaths(tmp_path):
    """The regression: a KV partition mid-scan must hold the last
    verdict — zero death verdicts, zero generation bumps, replicas keep
    serving — and heal cleanly when the KV answers again."""
    kv = _PartitionableKV(tmp_path / "kv")
    _fresh_stamps(kv, 2)
    router = FleetRouter([_OkClient(), _OkClient()], kv=kv,
                         max_queue=8, hb_timeout_s=5.0,
                         directory=str(tmp_path), respawn=False,
                         threads=1, lease_ttl_s=60.0)
    try:
        assert _wait_for(lambda: not router.stats()["kv_held"],
                         timeout=5.0)
        kv.down = True                         # partition mid-scan
        assert _wait_for(lambda: router.stats()["kv_held"]), \
            "router never noticed the partition"
        time.sleep(1.2)                        # several held ticks
        st = router.stats()
        assert st["replicas"]["0"]["state"] == "ready"
        assert st["replicas"]["1"]["state"] == "ready"
        assert st["generation"] == 0           # no verdict fabricated
        assert st["role"] == "leader"          # lease held through blip
        from mxnet_tpu_torch.resilience import elastic
        assert not elastic.read_ledger(
            path=fleet_ledger_path(str(tmp_path)))
        # the serving path never depended on the KV: requests flow
        router.predict("m", {"x": np.zeros(1)}, n=1, timeout=10)
        kv.down = False                        # heal
        assert _wait_for(lambda: not router.stats()["kv_held"]), \
            "router never released the hold after heal"
        st = router.stats()
        assert st["replicas"]["0"]["state"] == "ready"
        assert st["generation"] == 0
    finally:
        router.close(drain=False)


def test_scan_dead_ranks_raises_structured_on_unreachable(tmp_path):
    """scan_dead_ranks NEVER answers 'all dead' for a dead KV — it
    raises KVUnreachable (both for structured and for generic backend
    failures)."""
    kv = _PartitionableKV(tmp_path / "kv")
    kv.down = True
    with pytest.raises(KVUnreachable):
        scan_dead_ranks(kv, [0, 1, 2], created=0.0, timeout=5.0)

    class _BrokenKV(object):
        def key_value_dir_get(self, prefix):
            raise OSError("stale NFS handle")

    with pytest.raises(KVUnreachable) as exc:
        scan_dead_ranks(_BrokenKV(), [0, 1], created=0.0, timeout=5.0)
    assert exc.value.kind == "kv_unreachable"


# ---------------------------------------------------------------------------
# swap on checkpoint commit
# ---------------------------------------------------------------------------

def test_leader_applies_published_swap_pointer_once(tmp_path):
    """The leader watches mxtpu_fleet/params_ptr and runs ONE drainless
    swap per published version — re-reading the same pointer never
    re-swaps."""
    kv = FileKV(tmp_path / "kv")
    _fresh_stamps(kv, 1)
    router = FleetRouter([_OkClient()], kv=kv, max_queue=8,
                         directory=str(tmp_path), respawn=False,
                         threads=1, lease_ttl_s=60.0)
    try:
        kv.key_value_set(_SWAP_PTR_KEY, json.dumps(
            {"params": "/dev/null", "version": "v9"}))
        assert _wait_for(
            lambda: router.stats()["replicas"]["0"]["param_version"]
            == "v9"), "leader never applied the published pointer"
        assert router.stats()["swaps"] == 1
        time.sleep(1.2)                        # more health ticks
        assert router.stats()["swaps"] == 1    # single-flight per version
        kv.key_value_set(_SWAP_PTR_KEY, json.dumps(
            {"params": "/dev/null", "version": "v10"}))
        assert _wait_for(
            lambda: router.stats()["replicas"]["0"]["param_version"]
            == "v10"), "new pointer version never applied"
        assert router.stats()["swaps"] == 2
    finally:
        router.close(drain=False)


def test_ckptmgr_commit_publishes_swap_pointer(tmp_path, monkeypatch):
    """MXTPU_FLEET_SWAP_ON_COMMIT=1: a committed checkpoint publishes
    the versioned-params pointer into the fleet KV; default off writes
    nothing."""
    from mxnet_tpu_torch.resilience.ckptmgr import CheckpointManager
    from mxnet_tpu_torch.resilience.netkv import KeyAbsent
    fleet_dir = tmp_path / "mxtpu_fleet"
    monkeypatch.setenv("MXTPU_FLEET_DIR", str(fleet_dir))
    monkeypatch.delenv("MXTPU_KV_URL", raising=False)
    tree = {"w": np.arange(8, dtype=np.float32)}
    kv = FileKV(fleet_dir / "kv")

    monkeypatch.delenv("MXTPU_FLEET_SWAP_ON_COMMIT", raising=False)
    mgr = CheckpointManager(str(tmp_path / "run"), keep=0,
                            payload_format="host")
    mgr.save(tree, 1)
    with pytest.raises(KeyAbsent):             # off by default
        kv.blocking_key_value_get(_SWAP_PTR_KEY, 60)

    monkeypatch.setenv("MXTPU_FLEET_SWAP_ON_COMMIT", "1")
    final = mgr.save(tree, 3)
    doc = json.loads(kv.blocking_key_value_get(_SWAP_PTR_KEY, 1000))
    assert doc["params"] == final
    assert doc["step"] == 3
    assert doc["version"] == "step_%08d" % 3


# ---------------------------------------------------------------------------
# front-door failover config
# ---------------------------------------------------------------------------

def test_fleet_routers_env_parsing(monkeypatch):
    monkeypatch.delenv("MXTPU_FLEET_ROUTERS", raising=False)
    monkeypatch.delenv("MXTPU_FLEET_PORT", raising=False)
    assert fleet_routers() == ["http://127.0.0.1:8930"]
    monkeypatch.setenv("MXTPU_FLEET_ROUTERS",
                       "http://r1:8930, http://r2:8931")
    assert fleet_routers() == ["http://r1:8930", "http://r2:8931"]
    assert fleet_routers(["http://x:1"]) == ["http://x:1"]


# ---------------------------------------------------------------------------
# cross-package: the npz codec, the telemetry rollup, the first election
# ---------------------------------------------------------------------------

def test_npz_codec_bytes_cross_packages():
    """Bodies encoded by either package decode in the other (a JAX
    router can talk to a port replica and the reverse)."""
    from mxnet_tpu.serving import fleet as jfleet
    arrays = {"data": np.arange(12, dtype="float32").reshape(3, 4),
              "ids": np.arange(5, dtype="int64")}
    for enc, dec in ((encode_arrays, jfleet.decode_arrays),
                     (jfleet.encode_arrays, decode_arrays)):
        got = dec(enc(arrays))
        assert sorted(got) == sorted(arrays)
        for k in arrays:
            assert got[k].dtype == arrays[k].dtype
            np.testing.assert_array_equal(got[k], arrays[k])
        bare = np.linspace(0, 1, 7, dtype="float32")
        np.testing.assert_array_equal(dec(enc(bare)), bare)


def test_fleet_report_equal_across_packages():
    from mxnet_tpu.serving.telemetry import fleet_report as jax_report
    records = [
        _serve_rec(0, "v1", [10.0, 12.0], 1000.0),
        _serve_rec(0, "v1", [11.0, 13.0], 2000.0),
        _serve_rec(1, "v2", [30.0, 50.0], 1000.0, n=6),
        _serve_rec(1, "v2", [40.0, 60.0], 3000.0, n=6),
        _serve_rec(2, "v2", [20.0], 1500.0, n=1),
        {"kind": "serve", "model": "m"},
        {"kind": "step", "replica": 0},
    ]
    assert fleet_report(records) == jax_report(records)
    assert fleet_report([]) == jax_report([])


def test_first_election_kv_fault_is_recorded_not_swallowed(tmp_path):
    """A router whose KV is unreachable at construction starts as a
    standby with the fault held (``kv_held``), exactly as the health
    loop records a mid-scan fault; when the KV answers, it elects
    itself and releases the hold.  Requests flow throughout."""
    kv = _PartitionableKV(tmp_path / "kv")
    _fresh_stamps(kv, 1)
    kv.down = True
    router = FleetRouter([_OkClient()], kv=kv, max_queue=8,
                         hb_timeout_s=5.0, directory=str(tmp_path),
                         respawn=False, threads=1, router_id="r0",
                         lease_ttl_s=60.0)
    try:
        st = router.stats()
        assert st["kv_held"] is True
        assert st["role"] == "standby"
        router.predict("m", {"x": np.zeros(1)}, n=1, timeout=10)
        kv.down = False
        assert _wait_for(lambda: router.stats()["role"] == "leader"), \
            "router never won the election after the KV healed"
        assert _wait_for(lambda: not router.stats()["kv_held"])
        assert router.stats()["generation"] == 0
    finally:
        router.close(drain=False)


# ---------------------------------------------------------------------------
# end to end: two replica processes behind a router and its front door
# ---------------------------------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_fleet_end_to_end_cpu_replicas(tmp_path, monkeypatch):
    """``launch_fleet`` spawns two ``mxfleet replica`` processes on the
    CPU serving the toy MLP of ``tools/serve_bench.py`` from a checkpoint
    the JAX package saved; HTTP results through the front door equal a
    JAX-package Predictor.  Then: SIGKILL replica 1 (failover, death
    verdict, respawn at generation 1), a rolling swap (zero lowerings,
    the skew map), drain (503), and no replica process left.  Bounded
    by its own 120 s wall-time limit."""
    import signal
    from http.server import ThreadingHTTPServer
    import mxnet_tpu as jmx
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.serving.fleet import FleetClient, launch_fleet
    from mxnet_tpu_torch.tools.mxfleet import make_front_handler

    t0 = time.monotonic()
    limit_s = 120.0

    def left():
        remaining = limit_s - (time.monotonic() - t0)
        assert remaining > 0, "end-to-end fleet test over 120 s"
        return remaining

    features = 32
    net = jmx.models.get_mlp(num_classes=10, hidden=(64, 32))
    arg_shapes, _, _ = net.infer_shape(data=(1, features))
    rng = np.random.RandomState(17)
    v1 = {"arg:" + k: rng.uniform(-0.3, 0.3, s).astype("float32")
          for k, s in zip(net.list_arguments(), arg_shapes)
          if k not in ("data", "softmax_label")}
    v2 = {k: (v * 1.25 + 0.01).astype("float32") for k, v in v1.items()}
    sym_path = str(tmp_path / "toy-symbol.json")
    with open(sym_path, "w") as fout:
        fout.write(net.tojson())
    paths = {}
    for tag, params in (("v1", v1), ("v2", v2)):
        paths[tag] = str(tmp_path / ("toy-%s.params" % tag))
        jmx.nd.save(paths[tag], {k: jmx.nd.array(v)
                                 for k, v in params.items()})
    spec_path = str(tmp_path / "fleet.json")
    with open(spec_path, "w") as fout:
        json.dump({"models": [{"name": "toy", "symbol": sym_path,
                               "params": paths["v1"],
                               "input_shapes": {"data": [features]},
                               "buckets": [1, 4]}],
                   "version": "v1", "ctx": "cpu", "max_delay_ms": 2},
                  fout)
    xs = [np.random.RandomState(i).rand(1 + i % 3, features)
          .astype("float32") for i in range(6)]

    def reference(tag, x):
        pred = jmx.Predictor(sym_path, paths[tag],
                             {"data": (x.shape[0], features)})
        return np.asarray(pred.forward(data=x)[0])

    fleet_dir_ = str(tmp_path / "fleet")
    monkeypatch.setenv("MXTPU_FLEET_HB_TIMEOUT_S", "3")
    router = launch_fleet(spec_path, n_replicas=2, directory=fleet_dir_,
                          ports=[_free_port(), _free_port()],
                          startup_timeout_s=left())
    procs = [r.proc for r in router._replicas.values()]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_front_handler(router))
    door = threading.Thread(target=httpd.serve_forever, daemon=True)
    door.start()
    client = FleetClient(["http://127.0.0.1:%d" % httpd.server_port],
                         timeout=30.0)
    try:
        for x in xs:
            out = client.predict("toy", {"data": x}, n=x.shape[0])[0]
            np.testing.assert_allclose(out, reference("v1", x),
                                       rtol=1e-5, atol=1e-7)

        # failover: replica 1 dies under load; every request completes
        # on the survivor or fails structured, none hangs
        results, errors = [], []

        def load():
            for x in xs:
                try:
                    results.append((x, router.predict(
                        "toy", {"data": x}, n=x.shape[0], timeout=30)[0]))
                except ReplicaDead as exc:
                    errors.append(exc)

        workers = [threading.Thread(target=load) for _ in range(3)]
        for w in workers:
            w.start()
        os.kill(procs[1].pid, signal.SIGKILL)
        for w in workers:
            w.join(timeout=left())
            assert not w.is_alive(), "a request hung past its timeout"
        assert len(results) + len(errors) == 3 * len(xs)
        for x, out in results:
            np.testing.assert_allclose(out, reference("v1", x),
                                       rtol=1e-5, atol=1e-7)
        assert _wait_for(lambda: router.stats()["replicas"]["1"]["deaths"]
                         == 1, timeout=min(30.0, left()))
        led = elastic.read_ledger(path=fleet_ledger_path(fleet_dir_))
        assert led["generation"] >= 1
        # respawned at generation 1, healthy again, serving bitwise v1
        assert _wait_for(lambda: router.stats()["replicas"]["1"]["state"]
                         == "ready", timeout=min(60.0, left())), \
            "respawned replica never became healthy"
        procs.append(router._replicas[1].proc)
        rep1 = router._replicas[1].client.stats()
        assert rep1["generation"] == 1 and rep1["pid"] != procs[1].pid
        out = router._replicas[1].client.predict(
            "toy", {"data": xs[0]}, n=xs[0].shape[0])[0]
        np.testing.assert_allclose(out, reference("v1", xs[0]),
                                   rtol=1e-5, atol=1e-7)

        # rolling swap: zero lowerings per replica, the skew map moves
        res = client.swap(paths["v2"], version="v2")
        assert sorted(res["replicas"]) == ["0", "1"]
        for rep in res["replicas"].values():
            assert rep["lowerings"] == 0 and rep["version"] == "v2"
        assert client.stats()["version_skew"] == {"v2": [0, 1]}
        for x in xs[:3]:
            out = client.predict("toy", {"data": x}, n=x.shape[0])[0]
            np.testing.assert_allclose(out, reference("v2", x),
                                       rtol=1e-5, atol=1e-7)

        # drain: the front door answers 503
        router.drain(timeout=min(30.0, left()))
        with pytest.raises(ServerBusy) as exc:
            client.predict("toy", {"data": xs[0]}, n=xs[0].shape[0])
        assert exc.value.code == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close(drain=False)
    for proc in procs:
        assert proc.poll() is not None, "replica %d left running" % proc.pid
    assert time.monotonic() - t0 < limit_s


# ---------------------------------------------------------------------------
# the port's CLIs and its isolation from JAX
# ---------------------------------------------------------------------------

def test_fleet_modules_import_without_jax():
    """The fleet, the resilience modules and the CLIs import with no
    JAX present (a replica subprocess imports only the port)."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import mxnet_tpu_torch.serving.fleet\n"
        "import mxnet_tpu_torch.resilience.netkv\n"
        "import mxnet_tpu_torch.resilience.elastic\n"
        "import mxnet_tpu_torch.resilience.hotstate\n"
        "import mxnet_tpu_torch.resilience.ckptmgr\n"
        "import mxnet_tpu_torch.tools.mxfleet\n"
        "import mxnet_tpu_torch.tools.mxkv\n"
        "import mxnet_tpu_torch.tools.mxserve\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_kernel_counters_are_registered_by_the_kernel_modules():
    """Each kernel module registers its own launch counters with
    ``observability.metrics``; a replica's ``/v1/stats`` reports that
    registry, and the fleet module names no kernel."""
    import inspect
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.observability import metrics
    from mxnet_tpu_torch.serving import fleet
    qmm, fwd = qz.quantized_matmul, fa.flash_attention_forward
    got = metrics.kernel_counters()
    assert got["quantized_matmul"] == {
        "launches": qmm.launches, "by_route": qmm.launches_by_route,
        "by_qdtype": qmm.launches_by_qdtype}
    assert got["flash_attention"] == {"launches": fwd.launches,
                                      "by_dtype": fwd.launches_by_dtype}
    assert got["flash_decode"] == {
        "launches": fd.flash_decode_attention.launches}
    assert got["fused_opt"] == {"launches": fo.sweep.launches,
                                "by_body": fo.sweep.launches_by_body}
    # a snapshot, not the live dicts
    got["quantized_matmul"]["by_route"]["wgmma"] += 1
    assert metrics.kernel_counters()["quantized_matmul"]["by_route"] \
        == qmm.launches_by_route
    assert "kernels" not in inspect.getsource(fleet)


def test_mxkv_cli_ops_over_a_file_kv(tmp_path, capsys):
    from mxnet_tpu_torch.tools import mxkv
    url = "file://%s" % (tmp_path / "kv")
    assert mxkv.main(["--kv", url, "set", "mxtpu_hb/0", "1.5"]) == 0
    assert mxkv.main(["--kv", url, "set", "lease", "a",
                      "--if-absent"]) == 0
    assert mxkv.main(["--kv", url, "set", "lease", "b",
                      "--if-absent"]) == 1
    capsys.readouterr()
    assert mxkv.main(["--kv", url, "get", "mxtpu_hb/0"]) == 0
    assert capsys.readouterr().out.strip() == "1.5"
    assert mxkv.main(["--kv", url, "dir", "mxtpu_hb/"]) == 0
    assert capsys.readouterr().out.strip() == "mxtpu_hb/0\t1.5"
    assert mxkv.main(["--kv", url, "del", "lease"]) == 0
    assert mxkv.main(["--kv", url, "get", "lease"]) == 1
    assert mxkv.main(["--kv", url, "ping"]) == 0


def test_mxserve_refuses_slo_spec_and_serves_on_cpu(tmp_path, monkeypatch,
                                                    toy_model):
    """``MXTPU_SLO_SPEC`` raises naming the unported SLO engine (never
    ignored); with ``--ctx cpu`` the HTTP door answers predict, stats
    and metrics like the JAX package's ``tools/mxserve.py``."""
    import http.client
    from http.server import ThreadingHTTPServer
    from mxnet_tpu_torch.tools import mxfleet, mxserve
    monkeypatch.setenv("MXTPU_SLO_SPEC", "latency_p99_ms<50")
    with pytest.raises(MXNetError, match="sloengine"):
        mxserve.main(["--symbol", "x.json", "--params", "x.params"])
    with pytest.raises(MXNetError, match="sloengine"):
        mxfleet.main(["serve", "--spec", "fleet.json"])
    monkeypatch.delenv("MXTPU_SLO_SPEC")

    net, params = toy_model
    sym_path, params_path = str(tmp_path / "t.json"), str(tmp_path / "t.p")
    net.save(sym_path)
    mx.nd.save(params_path, params)
    args = type("Args", (), dict(
        checkpoint=None, symbol=sym_path, params=params_path, name="toy",
        shapes="data=(10,)", histogram=None, buckets="1,4",
        max_buckets=None, max_delay_ms=2, max_queue=None, priority=0,
        generative=False, ctx="cpu"))()
    srv = mxserve.build_server(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), mxserve.make_handler(srv))
    door = threading.Thread(target=httpd.serve_forever, daemon=True)
    door.start()
    try:
        x = np.random.RandomState(4).rand(3, 10).astype("float32")
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_port,
                                          timeout=30)
        conn.request("POST", "/v1/predict", body=json.dumps(
            {"model": "toy", "inputs": {"data": x.tolist()}}))
        doc = json.loads(conn.getresponse().read())
        want = mx.Predictor(net.tojson(), params, {"data": x.shape},
                            ctx=mx.cpu()).forward(data=x)[0]
        np.testing.assert_allclose(np.asarray(doc["outputs"][0],
                                              np.float32), want,
                                   rtol=1e-6, atol=1e-7)
        assert doc["n"] == 3
        conn.request("GET", "/v1/stats")
        assert "toy" in json.loads(conn.getresponse().read())["models"]
        conn.request("GET", "/metrics")
        assert b"mxtpu_stats_requests" in conn.getresponse().read()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
