"""Parity twins of the JAX package's elastic-ledger, fence,
``poll_remesh``, hot-state and host-checkpoint tests
(``tests/test_resilience.py``) and of its serving warm re-mesh test
(``tests/test_serving.py``), run against the port's
``mxnet_tpu_torch.resilience``.

Cross-package cases hold the two packages to one ledger file, one
hot-state payload format (a JAX snapshot warm-resumed by the port and
the reverse) and one host checkpoint format.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.executor import program_registry_stats
from mxnet_tpu_torch.resilience import (CheckpointManager, InjectedFault,
                                        ResilienceError, elastic,
                                        faultinject, hotstate)
from mxnet_tpu_torch.resilience.hotstate import HotStateUnavailable
from mxnet_tpu_torch.serving import ModelServer


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """Each test starts and ends with no armed fault specs."""
    monkeypatch.delenv("MXTPU_FAULT_SPEC", raising=False)
    faultinject.reset()
    yield
    faultinject.reset()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("MXTPU_FAULT_SPEC", spec)
    faultinject.reset()


# ----------------------------------------------------------------------
# liveness identities over an injected coordination client
# ----------------------------------------------------------------------
class _FakeClient(object):
    def __init__(self):
        self.kv = {}

    def key_value_set(self, key, value, allow_overwrite=False):
        self.kv[key] = value

    def key_value_dir_get(self, prefix):
        return [(k, v) for k, v in self.kv.items()
                if k.startswith(prefix)]


def test_dead_nodes_returns_sorted_identities(monkeypatch):
    from mxnet_tpu_torch import kvstore as kvs
    clock = {"now": 1000.0}
    fake = _FakeClient()
    monkeypatch.setattr(kvs, "_now", lambda: clock["now"])
    # three workers seen through the patched client (the port's store
    # is one process; the scan is over the ranks the client stamps)
    monkeypatch.setattr(kvs.KVStore, "num_workers",
                        property(lambda self: 3))
    monkeypatch.setattr(kvs, "_dist_client", lambda: fake)
    kv = kvs.KVStore("local")
    fake.kv["mxtpu_hb/0"] = repr(1000.0)
    fake.kv["mxtpu_hb/1"] = repr(1000.0)
    fake.kv["mxtpu_hb/2"] = repr(1000.0)
    assert kv.dead_nodes(timeout=10.0) == []
    clock["now"] = 1011.0
    fake.kv["mxtpu_hb/1"] = repr(1010.0)       # only 1 kept beating
    assert kv.dead_nodes(timeout=10.0) == [0, 2]
    assert kv.dead_nodes(node_id=2, timeout=10.0) == [2]
    assert kv.dead_nodes(node_id=1, timeout=10.0) == []
    assert kv.num_dead_nodes(timeout=10.0) == 2
    monkeypatch.undo()
    assert kvs._dist_client() is None           # one process: no client,
    assert kvs.KVStore("local").dead_nodes() == []   # so no verdict


def test_heartbeat_thread_stamps_injected_client(tmp_path, monkeypatch):
    """``_start_heartbeat`` stamps ``mxtpu_hb/<rank>`` into the given
    client at once and stops promptly; the stamp scans as alive."""
    from mxnet_tpu_torch import kvstore as kvs
    from mxnet_tpu_torch.resilience.netkv import FileKV
    kv = FileKV(tmp_path / "kv")
    kvs._stop_heartbeat()
    kvs._start_heartbeat(client=kv, rank=5)
    try:
        raw = kv.blocking_key_value_get("mxtpu_hb/5", 2000)
        assert abs(float(raw) - kvs._now()) < 30.0
        assert kvs.scan_dead_ranks(kv, [5], kvs._now(), 10.0) == []
    finally:
        kvs._stop_heartbeat()
    assert kvs._HB_STATE["thread"] is None


# ----------------------------------------------------------------------
# elastic re-mesh: ledger/fence, decision protocol
# ----------------------------------------------------------------------
def test_elastic_ledger_round_trip_and_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_ELASTIC_DIR", str(tmp_path))
    assert elastic.read_ledger() is None       # fresh: unreadable = None
    verdict = {"generation": 3, "world_size": 2, "members": [0, 1],
               "reason": "dead_node", "from_world": 3}
    elastic.write_ledger(verdict)
    assert elastic.read_ledger() == verdict
    assert not os.path.exists(elastic.ledger_path() + ".tmp")
    # generation(): env stamp wins, ledger is the fallback
    monkeypatch.delenv("MXTPU_ELASTIC_GENERATION", raising=False)
    assert elastic.generation() == 3
    monkeypatch.setenv("MXTPU_ELASTIC_GENERATION", "5")
    assert elastic.generation() == 5
    # capacity file: absent -> default, garbage -> default
    assert elastic.capacity() is None
    with open(elastic.capacity_path(), "w") as f:
        f.write("2\n")
    assert elastic.capacity() == 2
    monkeypatch.setenv("MXTPU_ELASTIC_MIN_WORLD", "2")
    assert elastic.min_world() == 2
    monkeypatch.setenv("MXTPU_ELASTIC_TARGET_WORLD", "4")
    assert elastic.target_world() == 4


def test_generation_fence_stale_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_ELASTIC_DIR", str(tmp_path))
    monkeypatch.setenv("MXTPU_ELASTIC_GENERATION", "0")
    elastic.write_ledger({"generation": 1, "world_size": 2})
    # not elastic -> never fences (plain jobs must be unaffected)
    monkeypatch.delenv("MXTPU_ELASTIC", raising=False)
    elastic.check_generation_fence()
    monkeypatch.setenv("MXTPU_ELASTIC", "1")
    with pytest.raises(ResilienceError) as ei:
        elastic.check_generation_fence()
    assert ei.value.kind == "stale_generation"
    # at or past the agreed generation: clean
    monkeypatch.setenv("MXTPU_ELASTIC_GENERATION", "1")
    elastic.check_generation_fence()


class _FakeElasticKV(object):
    def __init__(self, rank, num_workers, dead=()):
        self.rank = rank
        self.num_workers = num_workers
        self._dead = sorted(dead)

    def dead_nodes(self, node_id=None, timeout=None):
        return list(self._dead)


class _FakePollClient(object):
    def __init__(self):
        self.kv = {}

    def key_value_set(self, key, value, allow_overwrite=False):
        self.kv[key] = value

    def blocking_key_value_get(self, key, timeout_ms):
        if key in self.kv:
            return self.kv[key]
        raise RuntimeError("DEADLINE_EXCEEDED waiting for %s" % key)

    def key_value_delete(self, key):
        self.kv.pop(key, None)


@pytest.fixture
def _elastic_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_ELASTIC", "1")
    monkeypatch.setenv("MXTPU_ELASTIC_DIR", str(tmp_path))
    monkeypatch.setenv("MXTPU_ELASTIC_GENERATION", "0")
    monkeypatch.setenv("MXTPU_ELASTIC_TARGET_WORLD", "3")
    client = _FakePollClient()
    monkeypatch.setattr(elastic, "_kv_client", lambda: client)
    return client


def test_poll_remesh_shrink_verdict(_elastic_env, monkeypatch):
    client = _elastic_env
    kv = _FakeElasticKV(0, 3, dead=[2])
    verdict = elastic.poll_remesh(kv, elastic.recover_round(2),
                                  dead_timeout=6.0)
    assert verdict["generation"] == 1
    assert verdict["world_size"] == 2
    assert verdict["members"] == [0, 1]
    assert verdict["reason"] == "dead_node"
    assert verdict["from_world"] == 3
    # ledger persisted BEFORE publication; key carries generation+round
    assert elastic.read_ledger() == verdict
    key = "mxtpu_elastic/poll/0/recover-2"
    assert json.loads(client.kv[key]) == verdict
    # a survivor adopting the same round reads the identical verdict
    kv1 = _FakeElasticKV(1, 3)
    assert elastic.poll_remesh(kv1, elastic.recover_round(2),
                               timeout_s=1.0) == verdict


def test_poll_remesh_grow_toward_capacity_capped_at_target(
        _elastic_env, tmp_path):
    with open(elastic.capacity_path(), "w") as f:
        f.write("5")                           # more than we ever want
    kv = _FakeElasticKV(0, 2)
    verdict = elastic.poll_remesh(kv, 7)
    assert verdict["reason"] == "grow"
    assert verdict["world_size"] == 3          # capped at target, not 5
    assert verdict["members"] == [0, 1, 2]


def test_poll_remesh_no_verdict_publishes_marker(_elastic_env):
    client = _elastic_env
    kv = _FakeElasticKV(0, 3)
    assert elastic.poll_remesh(kv, 4) is None
    assert client.kv["mxtpu_elastic/poll/0/4"] == "none"
    # the no-op marker is what non-coordinators read: no race, no guess
    assert elastic.poll_remesh(_FakeElasticKV(1, 3), 4,
                               timeout_s=1.0) is None


def test_poll_remesh_orphan_raises_for_restart(_elastic_env):
    kv = _FakeElasticKV(1, 3)                  # coordinator never writes
    with pytest.raises(ResilienceError) as ei:
        elastic.poll_remesh(kv, 9, timeout_s=0.1)
    assert ei.value.kind == "remesh_orphan"


def test_restore_mismatch_names_every_leaf_host_format(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0, payload_format="host")
    tree = {"w": np.ones((4, 4), np.float32),
            "b": np.zeros((4,), np.float32)}
    mgr.save(tree, 1)
    got, step = mgr.restore({"w": np.zeros((4, 4), np.float32),
                             "b": np.zeros((4,), np.float32)})
    assert step == 1
    assert np.array_equal(got["w"], tree["w"])
    with pytest.raises(ResilienceError) as ei:
        mgr.restore({"w": np.zeros((2, 4), np.float32),
                     "b": np.zeros((4,), np.float64)})
    err = ei.value
    assert err.kind == "restore_mismatch"
    msg = str(err)
    assert "w" in msg and "(2, 4)" in msg      # the mismatched leaf,
    assert "b" in msg and "float64" in msg     # named with its want/got


def test_ckptmgr_orbax_format_raises_naming_the_slice(tmp_path):
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="multi-GPU slice"):
        CheckpointManager(str(tmp_path), payload_format="orbax")


def test_ledger_file_shared_across_packages(tmp_path):
    """Either package reads the other's ledger, and both write the same
    bytes for the same verdict."""
    from mxnet_tpu.resilience import elastic as jelastic
    verdict = {"generation": 4, "world_size": 2, "members": [0, 2],
               "reason": "replica_death", "from_world": 3}
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jelastic.write_ledger(verdict, path=jpath)
    elastic.write_ledger(verdict, path=ppath)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    assert elastic.read_ledger(path=jpath) == verdict
    assert jelastic.read_ledger(path=ppath) == verdict


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_host_checkpoint_restores_across_packages(tmp_path, writer):
    from mxnet_tpu.resilience.ckptmgr import \
        CheckpointManager as JaxManager
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "b": np.ones(4, np.float32)},
            "step_count": np.array([7], np.int64)}
    target = {"params": {"w": np.zeros((3, 4), np.float32),
                         "b": np.zeros(4, np.float32)},
              "step_count": np.zeros(1, np.int64)}
    save_mgr = (JaxManager(str(tmp_path), keep=0, payload_format="host")
                if writer == "jax" else
                CheckpointManager(str(tmp_path), keep=0))
    load_mgr = (CheckpointManager(str(tmp_path), keep=0)
                if writer == "jax" else
                JaxManager(str(tmp_path), keep=0, payload_format="host"))
    save_mgr.save(tree, 3)
    got, step = load_mgr.restore(target)
    assert step == 3
    for leaf in ("w", "b"):
        np.testing.assert_array_equal(got["params"][leaf],
                                      tree["params"][leaf])
    np.testing.assert_array_equal(got["step_count"], tree["step_count"])


# ----------------------------------------------------------------------
# warm elasticity: redundant host-memory hot state
# ----------------------------------------------------------------------
def _warm_env(tmp_path, monkeypatch, **env):
    monkeypatch.setenv("MXTPU_WARM_REMESH", "1")
    monkeypatch.setenv("MXTPU_HANDOFF_DIR", str(tmp_path / "handoff"))
    for var in ("MXTPU_NUM_HOSTS", "MXTPU_HOST_INDEX",
                "MXTPU_HOTSTATE_BUDDIES", "MXTPU_ELASTIC_GENERATION"):
        monkeypatch.delenv(var, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)


def _warm_tree(scale=1.0):
    return {"params": {"w": np.arange(12, dtype=np.float32)
                       .reshape(3, 4) * scale,
                       "b": np.ones(4, np.float32) * scale},
            "opt_state": {"m": np.zeros((3, 4), np.float32)}}


def _warm_abstract():
    return {"params": {"w": np.zeros((3, 4), np.float32),
                       "b": np.zeros(4, np.float32)},
            "opt_state": {"m": np.zeros((3, 4), np.float32)}}


def test_hotstate_snapshot_warm_resume_roundtrip(tmp_path, monkeypatch):
    _warm_env(tmp_path, monkeypatch)
    tree = _warm_tree()
    hotstate.snapshot(tree, step=5)
    out, step, meta = hotstate.warm_resume(_warm_abstract())
    assert step == 5 and meta["n_payloads"] == 1
    for group in ("params", "opt_state"):
        for leaf, want in tree[group].items():
            assert np.array_equal(out[group][leaf], want), (group, leaf)
    # without an abstract target the manifests' own nesting comes back
    out2, step2, _ = hotstate.warm_resume(None)
    assert step2 == 5
    assert np.array_equal(out2["params"]["b"], tree["params"]["b"])


def test_hotstate_newest_complete_step_wins(tmp_path, monkeypatch):
    _warm_env(tmp_path, monkeypatch)
    hotstate.snapshot(_warm_tree(scale=1.0), step=3)
    hotstate.snapshot(_warm_tree(scale=7.0), step=9)
    out, step, _ = hotstate.warm_resume(_warm_abstract())
    assert step == 9
    assert np.array_equal(out["params"]["w"],
                          _warm_tree(scale=7.0)["params"]["w"])


def test_hotstate_disabled_and_cold_verdicts(tmp_path, monkeypatch):
    _warm_env(tmp_path, monkeypatch)
    # empty handoff area -> cold verdict, reason no_payloads
    verdict = hotstate.decide_sources()
    assert verdict == {"mode": "cold", "reason": "no_payloads"}
    with pytest.raises(HotStateUnavailable) as ei:
        hotstate.warm_resume(_warm_abstract())
    assert ei.value.reason == "cold_verdict"
    # a group missing one rank's payload never satisfies the directory
    hotstate._write_payload(
        {"params/w": [([[0, 3], [0, 4]],
                       np.zeros((3, 4), np.float32))]},
        step=4, rank=0, world=2, host=0, namespace="train")
    assert hotstate.decide_sources()["reason"] == "incomplete"
    # the knob itself off -> structured "disabled", nothing read
    monkeypatch.setenv("MXTPU_WARM_REMESH", "0")
    assert not hotstate.warm_enabled()
    with pytest.raises(HotStateUnavailable) as ei:
        hotstate.warm_resume(_warm_abstract())
    assert ei.value.reason == "disabled"


def test_hotstate_buddy_lands_off_host_and_survives_host_loss(
        tmp_path, monkeypatch):
    """4 ranks on 2 simulated hosts; burning host 1 leaves every rank's
    sharded state reconstructible from host 0 (owns + buddy replicas)."""
    _warm_env(tmp_path, monkeypatch, MXTPU_NUM_HOSTS="2")
    # contiguous-block host map, and buddies never on their own host
    assert [hotstate.host_index(r, 4) for r in range(4)] == [0, 0, 1, 1]
    assert hotstate.buddy_hosts(0, 4) == [1]
    assert hotstate.buddy_hosts(3, 4) == [0]
    w = np.arange(16, dtype=np.float32).reshape(4, 4)
    for rank in range(4):
        hotstate._write_payload(
            {"params/w": [([[rank, rank + 1], [0, 4]],
                           w[rank:rank + 1])]},
            step=7, rank=rank, world=4,
            host=hotstate.host_index(rank, 4), namespace="train")
    hotstate.simulate_host_loss(1)
    verdict = hotstate.decide_sources()
    assert verdict["mode"] == "warm" and verdict["step"] == 7
    assert verdict["n_buddy"] == 2          # ranks 2,3 serve via buddies
    out, step, meta = hotstate.load_sources(
        verdict, {"params": {"w": np.zeros((4, 4), np.float32)}})
    assert step == 7 and meta["n_payloads"] == 4
    assert np.array_equal(out["params"]["w"], w)


def test_hotstate_buddy_loss_seam_drops_redundancy(tmp_path, monkeypatch):
    _warm_env(tmp_path, monkeypatch, MXTPU_NUM_HOSTS="2")
    _arm(monkeypatch, "kind=buddy_loss:rank=0")
    hotstate.snapshot(_warm_tree(), step=2, rank=0, world=2)
    recs = hotstate.scan()
    assert {r["source"] for r in recs} == {"own"}   # replica push lost
    # own host burns -> nothing left to serve rank 0 -> cold
    hotstate.simulate_host_loss(0)
    assert hotstate.decide_sources()["mode"] == "cold"


def test_hotstate_corrupt_payload_is_rejected_by_crc(tmp_path,
                                                     monkeypatch):
    _warm_env(tmp_path, monkeypatch)
    hotstate.snapshot(_warm_tree(), step=5)
    _arm(monkeypatch, "kind=corrupt:rank=0")
    with pytest.raises(HotStateUnavailable) as ei:
        hotstate.warm_resume(_warm_abstract())
    assert ei.value.reason == "crc_mismatch"
    # the fault fired once: the next attempt reads clean bytes
    out, step, _ = hotstate.warm_resume(_warm_abstract())
    assert step == 5
    assert np.array_equal(out["params"]["b"], np.ones(4, np.float32))


def test_hotstate_snapshot_crash_seam_raises_injected(tmp_path,
                                                      monkeypatch):
    _warm_env(tmp_path, monkeypatch)
    _arm(monkeypatch, "kind=snapshot_crash:step=3")
    with pytest.raises(InjectedFault):
        hotstate.snapshot(_warm_tree(), step=3)
    assert hotstate.scan() == []            # nothing half-written


def test_hotstate_target_mismatch_names_leaf(tmp_path, monkeypatch):
    _warm_env(tmp_path, monkeypatch)
    hotstate.snapshot(_warm_tree(), step=1)
    bad = _warm_abstract()
    bad["params"]["w"] = np.zeros((5, 4), np.float32)
    with pytest.raises(HotStateUnavailable) as ei:
        hotstate.warm_resume(bad)
    assert ei.value.reason == "target_mismatch"
    assert "params/w" in str(ei.value)


def test_hotstate_snapshot_takes_torch_tensors_whole(tmp_path,
                                                     monkeypatch):
    """A torch tensor leaf is one full-extent shard copied to the host;
    a snapshot of tensors resumes to the same numbers as numpy."""
    _warm_env(tmp_path, monkeypatch)
    tree = {"params": {"w": torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4),
                       "b": torch.ones(4)},
            "opt_state": {"m": torch.zeros(3, 4)}}
    hotstate.snapshot(tree, step=6)
    out, step, _ = hotstate.warm_resume(_warm_abstract())
    assert step == 6
    np.testing.assert_array_equal(out["params"]["w"],
                                  tree["params"]["w"].numpy())
    # a torch target is checked leaf by leaf like a numpy one
    target = {"params": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
              "opt_state": {"m": torch.zeros(3, 4)}}
    out, _, _ = hotstate.warm_resume(target)
    np.testing.assert_array_equal(out["opt_state"]["m"],
                                  np.zeros((3, 4), np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hotstate_payload_warm_resumes_across_packages(tmp_path,
                                                       monkeypatch, writer):
    """A payload snapshotted by either package warm-resumes in the
    other, and both write the same manifest and CRCs for the same
    tree."""
    from mxnet_tpu.resilience import hotstate as jhotstate
    _warm_env(tmp_path, monkeypatch, MXTPU_NUM_HOSTS="2")
    tree = _warm_tree(scale=3.0)
    src, dst = (jhotstate, hotstate) if writer == "jax" \
        else (hotstate, jhotstate)
    for rank in range(2):
        src.snapshot(tree, step=8, rank=rank, world=2)
    out, step, meta = dst.warm_resume(_warm_abstract())
    assert step == 8 and meta["n_payloads"] == 1
    for group in ("params", "opt_state"):
        for leaf, want in tree[group].items():
            np.testing.assert_array_equal(out[group][leaf], want)
    # the other package's snapshot of the same tree: same manifests
    other = str(tmp_path / "other")
    monkeypatch.setenv("MXTPU_HANDOFF_DIR", other)
    for rank in range(2):
        dst.snapshot(tree, step=8, rank=rank, world=2)
    for rel in ("train/host-0/own/rank-0", "train/host-1/buddy/rank-0"):
        with open(os.path.join(str(tmp_path / "handoff"), rel,
                               "manifest.json")) as fin:
            a = json.load(fin)
        with open(os.path.join(other, rel, "manifest.json")) as fin:
            b = json.load(fin)
        assert a == b


# ----------------------------------------------------------------------
# serving warm re-mesh (twin of tests/test_serving.py's)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def toy_model():
    net = mx.models.get_mlp(num_classes=3, hidden=(8,))
    arg_shapes, _, _ = net.infer_shape(data=(2, 10))
    rng = np.random.RandomState(3)
    params = {"arg:" + k: mx.nd.array(
        rng.uniform(-0.5, 0.5, shape).astype("float32"), ctx=mx.cpu())
        for k, shape in zip(net.list_arguments(), arg_shapes)
        if k not in ("data", "softmax_label")}
    return net, params


def test_server_warm_remesh_rebind_zero_lowerings(toy_model, tmp_path,
                                                  monkeypatch):
    """snapshot_hotstate captures every model's params AND bind config
    into the ``serve`` handoff namespace; a fresh ModelServer rebuilds
    from host memory alone (warm_resume_models) -- no param files --
    answers bit-identically, and the per-bucket rebinds ride the
    program registry, so the resume performs zero new lowerings."""
    net, params = toy_model
    monkeypatch.setenv("MXTPU_WARM_REMESH", "1")
    monkeypatch.setenv("MXTPU_HANDOFF_DIR", str(tmp_path / "handoff"))
    srv = ModelServer(max_delay_ms=2)
    srv.add_model("toy", net.tojson(), params, {"data": (10,)},
                  buckets=(1, 4), priority=2, ctx=mx.cpu())
    x = np.random.RandomState(9).rand(3, 10).astype("float32")
    want = srv.predict("toy", x)
    srv.snapshot_hotstate(step=11)
    srv.close()

    srv2 = ModelServer(max_delay_ms=2)
    before = program_registry_stats()["lowerings"]
    restored = srv2.warm_resume_models(ctx=mx.cpu())
    assert restored == ["toy"]
    assert program_registry_stats()["lowerings"] == before
    got = srv2.predict("toy", x)
    stats = srv2.stats()
    srv2.close()
    np.testing.assert_array_equal(got[0], want[0])
    assert stats["models"]["toy"]["lowerings_since_warmup"] == 0
    assert list(srv2.plan("toy").buckets) == [1, 4]
    assert srv2._entries["toy"].priority == 2

    # no surviving payload -> structured HotStateUnavailable
    hotstate.clear("serve")
    srv3 = ModelServer(max_delay_ms=2)
    with pytest.raises(HotStateUnavailable):
        srv3.warm_resume_models(ctx=mx.cpu())
    srv3.close()


def test_server_warm_resume_from_jax_package_snapshot(tmp_path,
                                                      monkeypatch):
    """A JAX-package ModelServer's serve snapshot rebuilds the same
    model in the port's server, answering as the JAX server did."""
    import mxnet_tpu as jmx
    from mxnet_tpu.serving import ModelServer as JaxServer
    monkeypatch.setenv("MXTPU_WARM_REMESH", "1")
    monkeypatch.setenv("MXTPU_HANDOFF_DIR", str(tmp_path / "handoff"))
    net = jmx.models.get_mlp(num_classes=4, hidden=(6,))
    arg_shapes, _, _ = net.infer_shape(data=(1, 5))
    rng = np.random.RandomState(21)
    params = {"arg:" + k: jmx.nd.array(
        rng.uniform(-0.5, 0.5, shape).astype("float32"))
        for k, shape in zip(net.list_arguments(), arg_shapes)
        if k not in ("data", "softmax_label")}
    x = np.random.RandomState(22).rand(2, 5).astype("float32")
    jsrv = JaxServer(max_delay_ms=2)
    jsrv.add_model("mlp", net.tojson(), params, {"data": (5,)},
                   buckets=(2,))
    want = jsrv.predict("mlp", x)[0]
    jsrv.snapshot_hotstate(step=4)
    jsrv.close()
    srv = ModelServer(max_delay_ms=2)
    try:
        assert srv.warm_resume_models(ctx=mx.cpu()) == ["mlp"]
        got = srv.predict("mlp", x)[0]
    finally:
        srv.close()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-7)


# ----------------------------------------------------------------------
# phase spans (observability/spans.py), which snapshot and warm resume
# record
# ----------------------------------------------------------------------
@pytest.fixture
def _telemetry(monkeypatch, tmp_path):
    from mxnet_tpu_torch.observability import events, trace
    d = str(tmp_path / "tel")
    monkeypatch.setenv("MXTPU_TELEMETRY", "1")
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", d)
    monkeypatch.setenv("MXTPU_RUN_ID", "spanrun")
    monkeypatch.setenv("MXTPU_TRACE", "1")
    events.refresh()
    trace.refresh()
    yield d
    monkeypatch.undo()
    events.refresh()
    trace.refresh()


def _span_records(directory):
    from mxnet_tpu_torch.observability import events
    events.flush()
    out = []
    for name in sorted(os.listdir(directory)):
        if name.endswith(".jsonl"):
            with open(os.path.join(directory, name)) as fin:
                out.extend(json.loads(line) for line in fin if line.strip())
    return [r for r in out if r.get("kind") == "span"]


def test_span_null_when_disabled(monkeypatch):
    from mxnet_tpu_torch.observability import events, spans
    monkeypatch.delenv("MXTPU_TELEMETRY", raising=False)
    monkeypatch.delenv("MXTPU_TELEMETRY_DIR", raising=False)
    events.refresh()
    s1, s2 = spans.span("step"), spans.span("h2d")
    assert s1 is s2                          # shared null object
    with s1:
        pass


def test_span_records_duration_and_trace_ids(_telemetry):
    import time
    from mxnet_tpu_torch.observability import spans
    with spans.span("step", step=7, extra="x"):
        with spans.span("ckpt_save", step=7):
            time.sleep(0.01)
    list(spans.timed_iter([1, 2], name="data_wait"))
    recs = _span_records(_telemetry)
    by_name = {r["name"]: r for r in recs}
    assert by_name["step"]["extra"] == "x" and by_name["step"]["step"] == 7
    assert by_name["ckpt_save"]["dur_ms"] >= 9.0
    assert by_name["ckpt_save"]["trace_id"] == by_name["step"]["trace_id"]
    assert by_name["ckpt_save"]["parent_span"] == by_name["step"]["span_id"]
    assert [r["name"] for r in recs].count("data_wait") == 2


def test_span_pushes_nvtx_range_only_on_a_cuda_process(_telemetry,
                                                       monkeypatch):
    """The JAX package's profiler annotation becomes an NVTX range, taken
    by an explicit device check (no CUDA context here: no range)."""
    from mxnet_tpu_torch.observability import spans
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    with spans.span("warm_resume"):
        pass
    assert calls == [] and not spans._on_cuda()
    monkeypatch.setattr(spans, "_on_cuda", lambda: True)
    with spans.span("warm_resume"):
        pass
    assert calls == [("push", "warm_resume"), ("pop",)]


def test_overlap_report_equal_across_packages():
    from mxnet_tpu.observability.spans import overlap_report as jax_report
    from mxnet_tpu_torch.observability.spans import overlap_report

    def rec(kind, wall_ms, dur_ms, name=None, rank=0):
        r = {"kind": kind, "wall_ms": wall_ms, "dur_ms": dur_ms,
             "rank": rank}
        if name:
            r["name"] = name
        return r

    records = [rec("step", 1000.0 * i, 1000.0) for i in range(1, 6)]
    records += [rec("span", 1000.0 * i + 500.0, 900.0, name="data_wait")
                for i in range(2, 5)]
    records += [rec("step", 500.0 * i, 400.0, rank=1) for i in range(3)]
    records += [rec("span", -5.0, 500.0, name="h2d")]
    got = overlap_report(records)
    assert got == jax_report(records)
    assert got["overlap_ratio"] > 1.0
