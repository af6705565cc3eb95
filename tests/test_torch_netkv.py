"""Parity twins of ``tests/test_netkv.py`` for the port's coordination KV
(``mxnet_tpu_torch.resilience.netkv``): backend parity between FileKV
and TcpKV, the TcpKV server/client pair, the ResilientKV retry
discipline and its fault seams, leader-lease election, and connect_kv
URL selection -- the same tests run against the port.

Cross-package cases at the end hold the two packages to one on-disk
layout and one wire format: a JAX-package FileKV write read by the
port's and the reverse, a port TcpKV client against the JAX
TcpKVServer and the reverse, and scan_dead_ranks giving the same
verdicts in both packages on the same stamps.

All CPU-only and in-process: the TCP tests run a TcpKVServer thread
inside the test process on an ephemeral port.
"""
import json
import threading
import time

import pytest

from mxnet_tpu_torch.kvstore import scan_dead_ranks
from mxnet_tpu_torch.resilience.netkv import (CoordKV, FileKV, KVUnreachable,
                                        KeyAbsent, KeyExists, Lease,
                                        ResilientKV, TcpKV,
                                        TcpKVServer, connect_kv,
                                        kv_max_value_bytes, kv_retries,
                                        kv_timeout_s, kv_url)


# ---------------------------------------------------------------------------
# backend fixture: every contract test runs over file:// AND tcp://
# ---------------------------------------------------------------------------

@pytest.fixture(params=["file", "tcp"])
def kv_backend(request, tmp_path):
    """(kv, url) over both backends — the parity matrix the router,
    heartbeat scan, and ledger exchange rely on."""
    if request.param == "file":
        root = tmp_path / "kv"
        yield FileKV(root), "file://%s" % root
        return
    srv = TcpKVServer(port=0).start()
    try:
        yield TcpKV(srv.host, srv.port, timeout_s=2.0), srv.url
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# backend parity: one contract, two transports
# ---------------------------------------------------------------------------

def test_kv_roundtrip_and_prefix_scan(kv_backend):
    kv, _ = kv_backend
    kv.key_value_set("mxtpu_hb/0", "1.5")
    kv.key_value_set("mxtpu_hb/1", "2.5")
    kv.key_value_set("other/0", "9")
    assert dict(kv.key_value_dir_get("mxtpu_hb/")) == {
        "mxtpu_hb/0": "1.5", "mxtpu_hb/1": "2.5"}
    kv.key_value_set("mxtpu_hb/0", "3.5")    # last write wins
    assert dict(kv.key_value_dir_get("mxtpu_hb/"))["mxtpu_hb/0"] == "3.5"
    kv.key_value_delete("mxtpu_hb/0")
    kv.key_value_delete("mxtpu_hb/0")        # idempotent
    assert "mxtpu_hb/0" not in dict(kv.key_value_dir_get("mxtpu_hb/"))


def test_kv_set_if_absent_is_exclusive(kv_backend):
    """allow_overwrite=False is the lease primitive: exactly one of
    two writers may win, and KeyExists is still a ValueError (the
    FileKV contract existing callers catch)."""
    kv, _ = kv_backend
    kv.key_value_set("lease", "a", allow_overwrite=False)
    with pytest.raises(KeyExists):
        kv.key_value_set("lease", "b", allow_overwrite=False)
    assert isinstance(KeyExists("x"), ValueError)
    assert kv.blocking_key_value_get("lease", 50) == "a"
    kv.key_value_delete("lease")
    kv.key_value_set("lease", "b", allow_overwrite=False)
    assert kv.blocking_key_value_get("lease", 50) == "b"


def test_kv_blocking_get_absent_raises_keyabsent(kv_backend):
    """A bget deadline with the key never set is the SEMANTIC timeout
    KeyAbsent (a TimeoutError) — never a transport error."""
    kv, _ = kv_backend
    t0 = time.monotonic()
    with pytest.raises(KeyAbsent):
        kv.blocking_key_value_get("missing", 80)
    assert time.monotonic() - t0 < 5.0
    assert isinstance(KeyAbsent("x"), TimeoutError)
    kv.key_value_set("k", "v")
    assert kv.blocking_key_value_get("k", 80) == "v"


def test_dead_scan_matrix_over_both_backends(kv_backend, monkeypatch):
    """The heartbeat dead-scan rule gives the same verdicts over
    file:// and tcp:// — a backend swap is a URL change, not a
    behavior change."""
    from mxnet_tpu_torch import kvstore as kvmod
    kv, _ = kv_backend
    monkeypatch.setattr(kvmod, "_now", lambda: 100.0)
    kv.key_value_set("mxtpu_hb/0", "99.0")     # fresh
    kv.key_value_set("mxtpu_hb/1", "80.0")     # stale
    assert scan_dead_ranks(kv, [0, 1, 2], created=95.0,
                           timeout=10.0) == [1]
    assert scan_dead_ranks(kv, [0, 1, 2], created=50.0,
                           timeout=10.0) == [1, 2]


# ---------------------------------------------------------------------------
# TcpKV specifics
# ---------------------------------------------------------------------------

@pytest.fixture
def tcp_server():
    srv = TcpKVServer(port=0).start()
    yield srv
    srv.stop()


def test_tcpkv_concurrent_clients(tcp_server):
    """Many threads, each with its own per-op connections, never see
    each other's answers (the one-socket-per-op design)."""
    errors = []

    def worker(wid):
        kv = TcpKV(tcp_server.host, tcp_server.port, timeout_s=5.0)
        try:
            for i in range(20):
                kv.key_value_set("w%d/%d" % (wid, i), str(wid * 100 + i))
                got = kv.blocking_key_value_get("w%d/%d" % (wid, i), 500)
                assert got == str(wid * 100 + i)
        except Exception as exc:       # pragma: no cover - failure path
            errors.append((wid, exc))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    kv = TcpKV(tcp_server.host, tcp_server.port)
    assert len(kv.key_value_dir_get("w")) == 8 * 20


def test_tcpkv_blocking_get_wakes_on_set(tcp_server):
    """A parked bget wakes when another CONNECTION sets the key — the
    condition-variable path, not the poll path."""
    kv_get = TcpKV(tcp_server.host, tcp_server.port, timeout_s=5.0)
    kv_set = TcpKV(tcp_server.host, tcp_server.port, timeout_s=5.0)
    out = {}

    def getter():
        out["value"] = kv_get.blocking_key_value_get("wake", 5000)
        out["at"] = time.monotonic()

    t = threading.Thread(target=getter)
    t.start()
    time.sleep(0.25)
    t0 = time.monotonic()
    kv_set.key_value_set("wake", "now")
    t.join(timeout=10)
    assert out["value"] == "now"
    assert out["at"] - t0 < 2.0        # woke on notify, not at deadline


def test_tcpkv_oversized_value_rejected(tmp_path):
    """Values above MXTPU_KV_MAX_VALUE are rejected server-side with a
    plain ValueError (never retried by ResilientKV) and leave no key."""
    srv = TcpKVServer(port=0, max_value_bytes=64).start()
    try:
        kv = ResilientKV(TcpKV(srv.host, srv.port, timeout_s=2.0),
                         retries=3)
        kv.key_value_set("small", "x" * 32)
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="exceeds"):
            kv.key_value_set("big", "x" * 200)
        assert time.monotonic() - t0 < 1.0     # no retry loop burned
        with pytest.raises(KeyAbsent):
            kv.blocking_key_value_get("big", 60)
    finally:
        srv.stop()


def test_tcpkv_reconnects_after_server_restart():
    """One connection per op means a server restart needs no client
    state reset — the next op just dials the new listener."""
    srv = TcpKVServer(port=0).start()
    host, port = srv.host, srv.port
    kv = TcpKV(host, port, timeout_s=2.0)
    kv.key_value_set("k", "v1")
    srv.stop()
    with pytest.raises(ConnectionError):
        kv.key_value_set("k", "v2")
    srv2 = TcpKVServer(host=host, port=port).start()
    try:
        kv.key_value_set("k", "v2")    # same client object, new server
        assert kv.blocking_key_value_get("k", 100) == "v2"
        assert kv.ping()["ok"]
    finally:
        srv2.stop()


def test_tcpkv_partition_window_then_backoff_recovery(tcp_server):
    """The server-side partition hook drops connections; ResilientKV's
    backoff rides out the window and the op SUCCEEDS — the
    reconnect-with-backoff half of the chaos drill."""
    kv = ResilientKV(TcpKV(tcp_server.host, tcp_server.port,
                           timeout_s=2.0), retries=6)
    kv.key_value_set("k", "v")
    tcp_server.partition(0.4)
    raw = TcpKV(tcp_server.host, tcp_server.port, timeout_s=2.0)
    with pytest.raises(ConnectionError):
        raw.blocking_key_value_get("k", 50)    # unwrapped: transport loss
    assert kv.blocking_key_value_get("k", 50) == "v"   # retried past it


# ---------------------------------------------------------------------------
# ResilientKV: the retry discipline
# ---------------------------------------------------------------------------

class _FlakyKV(CoordKV):
    """Backend failing the first ``fail_n`` calls, counting attempts."""

    def __init__(self, fail_n=0, exc=ConnectionError("down")):
        self.fail_n = fail_n
        self.exc = exc
        self.calls = 0

    def _maybe_fail(self):
        self.calls += 1
        if self.calls <= self.fail_n:
            raise self.exc

    def key_value_set(self, key, value, allow_overwrite=True):
        self._maybe_fail()

    def blocking_key_value_get(self, key, timeout_ms):
        self._maybe_fail()
        return "v"

    def key_value_dir_get(self, prefix):
        self._maybe_fail()
        return []

    def key_value_delete(self, key):
        self._maybe_fail()


def test_resilientkv_retries_then_structured_unreachable():
    flaky = _FlakyKV(fail_n=10**9)
    kv = ResilientKV(flaky, retries=3, timeout_s=1.0, name="unit")
    with pytest.raises(KVUnreachable) as ei:
        kv.key_value_dir_get("mxtpu_hb/")
    err = ei.value
    assert err.kind == "kv_unreachable"
    assert err.op == "dir"
    assert err.attempts == 3
    assert flaky.calls == 3            # the whole budget was spent
    assert isinstance(err, Exception) and "unit" in str(err)


def test_resilientkv_recovers_and_rearms_outage_latch():
    """One outage stretch = one kv_unreachable emission; the next
    success re-arms the latch (asserted via the internal _down edge)."""
    flaky = _FlakyKV(fail_n=2)         # first op burns 2, succeeds 3rd
    kv = ResilientKV(flaky, retries=3, timeout_s=1.0)
    assert kv.blocking_key_value_get("k", 10) == "v"
    assert kv._down is False
    flaky.fail_n = flaky.calls + 10**9  # hard down from here
    with pytest.raises(KVUnreachable):
        kv.key_value_dir_get("x")
    assert kv._down is True
    flaky.fail_n = 0                    # heal
    assert kv.blocking_key_value_get("k", 10) == "v"
    assert kv._down is False


def test_resilientkv_semantic_errors_never_retried():
    class _AnsweredKV(_FlakyKV):
        def blocking_key_value_get(self, key, timeout_ms):
            self.calls += 1
            raise KeyAbsent("not set")

        def key_value_set(self, key, value, allow_overwrite=True):
            self.calls += 1
            raise KeyExists("already set")

    backend = _AnsweredKV()
    kv = ResilientKV(backend, retries=5, timeout_s=1.0)
    with pytest.raises(KeyAbsent):
        kv.blocking_key_value_get("k", 10)
    with pytest.raises(KeyExists):
        kv.key_value_set("k", "v", allow_overwrite=False)
    assert backend.calls == 2          # one attempt each: the KV answered


def test_resilientkv_backoff_is_deterministic():
    """No wall-clock or randomness in the delay schedule — a failing
    chaos drill replays exactly."""
    kv1 = ResilientKV(_FlakyKV(), retries=4, timeout_s=2.0, name="same")
    kv2 = ResilientKV(_FlakyKV(), retries=4, timeout_s=2.0, name="same")
    assert list(kv1._delays()) == list(kv2._delays())
    other = ResilientKV(_FlakyKV(), retries=4, timeout_s=2.0,
                        name="other-router")
    assert list(kv1._delays()) != list(other._delays())  # decorrelated


# ---------------------------------------------------------------------------
# fault seams (MXTPU_FAULT_SPEC, seam kv_op)
# ---------------------------------------------------------------------------

def test_kv_partition_seam_fails_ops_then_heals(tmp_path, monkeypatch):
    from mxnet_tpu_torch.resilience import faultinject
    monkeypatch.setenv("MXTPU_FAULT_SPEC",
                       "kind=kv_partition:seconds=0.3")
    faultinject.reset()
    try:
        kv = ResilientKV(FileKV(tmp_path / "kv"), retries=1,
                         timeout_s=0.2)
        with pytest.raises(KVUnreachable):
            kv.key_value_set("k", "v")
        time.sleep(0.35)               # window closes
        kv.key_value_set("k", "v")     # healed: same client works
        assert kv.blocking_key_value_get("k", 50) == "v"
        assert kv._down is False
    finally:
        faultinject.reset()


def test_kv_flap_seam_is_absorbed_by_retry(tmp_path, monkeypatch):
    """kv_flap alternates fail/ok per attempt — the retry budget
    absorbs it, so callers never see an error."""
    from mxnet_tpu_torch.resilience import faultinject
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "kind=kv_flap:sticky=1")
    faultinject.reset()
    try:
        kv = ResilientKV(FileKV(tmp_path / "kv"), retries=3,
                         timeout_s=0.5)
        kv.key_value_set("k", "v")     # attempt 1 flaps, attempt 2 ok
        assert kv.blocking_key_value_get("k", 50) == "v"
    finally:
        faultinject.reset()


def test_kv_slow_seam_delays_but_succeeds(tmp_path, monkeypatch):
    from mxnet_tpu_torch.resilience import faultinject
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "kind=kv_slow:seconds=0.2")
    faultinject.reset()
    try:
        kv = ResilientKV(FileKV(tmp_path / "kv"), retries=2)
        t0 = time.monotonic()
        kv.key_value_set("k", "v")
        assert time.monotonic() - t0 >= 0.2
    finally:
        faultinject.reset()


# ---------------------------------------------------------------------------
# leader lease
# ---------------------------------------------------------------------------

def test_lease_take_renew_and_stats(kv_backend):
    kv, _ = kv_backend
    lease = Lease(kv, "r1", ttl_s=0.6)
    assert lease.poll() is True
    assert lease.poll() is True        # renew path, still leading
    rec = lease.peek()
    assert rec["holder"] == "r1" and rec["expires"] > time.time()
    st = lease.stats()
    assert st["leading"] and st["holder"] == "r1" and st["takeovers"] == 1


def test_lease_standby_takes_over_on_expiry(kv_backend):
    kv, _ = kv_backend
    a = Lease(kv, "a", ttl_s=0.3)
    b = Lease(kv, "b", ttl_s=0.3)
    assert a.poll() is True
    assert b.poll() is False           # unexpired lease: stand by
    time.sleep(0.4)                    # a never renews (it "died")
    assert b.poll() is True            # expired: exactly one takeover
    assert b.peek()["holder"] == "b"


def test_deposed_incumbent_steps_down_never_stomps(kv_backend):
    """An incumbent paused/partitioned past its own TTL re-competes;
    it must NOT overwrite the successor's record."""
    kv, _ = kv_backend
    a = Lease(kv, "a", ttl_s=0.3)
    b = Lease(kv, "b", ttl_s=0.3)
    assert a.poll() is True
    time.sleep(0.4)                    # a pauses past its own expiry
    assert b.poll() is True            # b took over
    assert a.poll() is False           # a steps down, does not stomp
    assert a.leading is False
    assert a.peek()["holder"] == "b"
    assert b.poll() is True            # b unharmed


def test_lease_release_hands_over_in_one_poll(kv_backend):
    kv, _ = kv_backend
    a = Lease(kv, "a", ttl_s=5.0)
    b = Lease(kv, "b", ttl_s=5.0)
    assert a.poll() is True
    assert b.poll() is False
    a.release()                        # graceful close: no TTL wait
    assert a.leading is False
    assert b.poll() is True


def test_lease_same_holder_restart_renews_in_place(kv_backend):
    """A router restarting with the same id reclaims its own record
    immediately instead of waiting out its own TTL."""
    kv, _ = kv_backend
    old = Lease(kv, "r1", ttl_s=5.0)
    assert old.poll() is True
    fresh = Lease(kv, "r1", ttl_s=5.0)     # restarted incarnation
    assert fresh.poll() is True


def test_lease_holds_leadership_through_kv_blip(tmp_path):
    """KVUnreachable mid-poll: the incumbent keeps leading within its
    own written expiry (the KV being down says nothing about the
    leader), and steps down past it."""

    class _SwitchKV(CoordKV):
        def __init__(self, kv):
            self.kv, self.down = kv, False

        def _gate(self):
            if self.down:
                raise KVUnreachable("blip", op="test")

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

    kv = _SwitchKV(FileKV(tmp_path / "kv"))
    lease = Lease(kv, "a", ttl_s=0.5)
    assert lease.poll() is True
    kv.down = True
    assert lease.poll() is True        # hold within our written lease
    time.sleep(0.6)                    # ... but never past our own TTL
    assert lease.poll() is False
    assert lease.leading is False
    kv.down = False
    assert lease.poll() is True        # healed: re-elected normally


# ---------------------------------------------------------------------------
# connect_kv + env knobs
# ---------------------------------------------------------------------------

def test_connect_kv_url_selection(tmp_path, monkeypatch, tcp_server):
    monkeypatch.delenv("MXTPU_KV_URL", raising=False)
    # unset -> FileKV on the caller's default root, ResilientKV-wrapped
    kv = connect_kv(default_root=str(tmp_path / "kv"))
    assert isinstance(kv, ResilientKV)
    assert isinstance(kv.kv, FileKV)
    assert kv.kv.root == str(tmp_path / "kv")
    # file:// explicit
    kv = connect_kv(url="file://%s" % (tmp_path / "kv2"))
    assert isinstance(kv.kv, FileKV)
    # tcp:// explicit, and via the environment
    kv = connect_kv(url=tcp_server.url)
    assert isinstance(kv.kv, TcpKV)
    kv.key_value_set("k", "v")
    assert kv.blocking_key_value_get("k", 100) == "v"
    monkeypatch.setenv("MXTPU_KV_URL", tcp_server.url)
    kv = connect_kv()
    assert isinstance(kv.kv, TcpKV) and kv.kv.port == tcp_server.port
    # resilient=False hands back the raw backend
    raw = connect_kv(url=tcp_server.url, resilient=False)
    assert isinstance(raw, TcpKV)
    with pytest.raises(ValueError):
        connect_kv(url="tcp://nohost")         # missing port
    with pytest.raises(ValueError):
        connect_kv(url="zmq://x:1")            # unknown scheme


def test_kv_env_knobs(monkeypatch):
    monkeypatch.delenv("MXTPU_KV_URL", raising=False)
    assert kv_url() is None
    assert kv_url("tcp://h:1") == "tcp://h:1"
    monkeypatch.setenv("MXTPU_KV_TIMEOUT_S", "2.5")
    monkeypatch.setenv("MXTPU_KV_RETRIES", "7")
    monkeypatch.setenv("MXTPU_KV_MAX_VALUE", "4096")
    assert kv_timeout_s() == 2.5
    assert kv_retries() == 7
    assert kv_max_value_bytes() == 4096
    monkeypatch.setenv("MXTPU_KV_TIMEOUT_S", "junk")
    assert kv_timeout_s() == 5.0               # defaults, never raises
    monkeypatch.setenv("MXTPU_KV_RETRIES", "junk")
    assert kv_retries() == 3


def test_lease_record_is_plain_json(tmp_path):
    """The lease record is operator-readable JSON (mxkv get can show
    it) with exactly the documented fields."""
    kv = FileKV(tmp_path / "kv")
    lease = Lease(kv, "r1", ttl_s=2.0)
    assert lease.poll() is True
    doc = json.loads(kv.blocking_key_value_get("mxtpu_router/lease", 50))
    assert set(doc) == {"holder", "expires"}
    assert doc["holder"] == "r1"


# ---------------------------------------------------------------------------
# cross-package: one on-disk layout, one wire format, one dead-scan rule
# ---------------------------------------------------------------------------

def test_filekv_layout_shared_both_directions(tmp_path):
    """A key written by either package's FileKV is read by the other's:
    same quoted file names, same contents, same prefix scan."""
    from mxnet_tpu.resilience import netkv as jnetkv
    root = tmp_path / "kv"
    jkv, pkv = jnetkv.FileKV(root), FileKV(root)
    jkv.key_value_set("mxtpu_hb/3", "12.5")
    jkv.key_value_set("mxtpu_fleet/view", json.dumps({"a": [1, 2]}))
    assert pkv.blocking_key_value_get("mxtpu_hb/3", 50) == "12.5"
    assert json.loads(pkv.blocking_key_value_get(
        "mxtpu_fleet/view", 50)) == {"a": [1, 2]}
    pkv.key_value_set("mxtpu_hb/4", "13.5")
    pkv.key_value_set("mxtpu_router/lease", "x", allow_overwrite=False)
    assert dict(jkv.key_value_dir_get("mxtpu_hb/")) == dict(
        pkv.key_value_dir_get("mxtpu_hb/")) == {
            "mxtpu_hb/3": "12.5", "mxtpu_hb/4": "13.5"}
    with pytest.raises(jnetkv.KeyExists):
        jkv.key_value_set("mxtpu_router/lease", "y",
                          allow_overwrite=False)
    assert sorted(p.name for p in root.iterdir()) == sorted(
        ["mxtpu_hb%2F3", "mxtpu_hb%2F4", "mxtpu_fleet%2Fview",
         "mxtpu_router%2Flease"])


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_tcp_wire_shared_both_directions(server_pkg):
    """A port client against the JAX TcpKVServer, and a JAX client
    against the port's: every op, semantic errors included, crosses."""
    from mxnet_tpu.resilience import netkv as jnetkv
    if server_pkg == "jax":
        srv = jnetkv.TcpKVServer(port=0).start()
        client = TcpKV(srv.host, srv.port, timeout_s=2.0)
        exists, absent = KeyExists, KeyAbsent
        peer = jnetkv.TcpKV(srv.host, srv.port, timeout_s=2.0)
    else:
        srv = TcpKVServer(port=0).start()
        client = jnetkv.TcpKV(srv.host, srv.port, timeout_s=2.0)
        exists, absent = jnetkv.KeyExists, jnetkv.KeyAbsent
        peer = TcpKV(srv.host, srv.port, timeout_s=2.0)
    try:
        client.key_value_set("mxtpu_hb/0", "1.25")
        assert peer.blocking_key_value_get("mxtpu_hb/0", 50) == "1.25"
        peer.key_value_set("mxtpu_hb/1", "2.25")
        assert dict(client.key_value_dir_get("mxtpu_hb/")) == {
            "mxtpu_hb/0": "1.25", "mxtpu_hb/1": "2.25"}
        client.key_value_set("lease", "a", allow_overwrite=False)
        with pytest.raises(exists):
            client.key_value_set("lease", "b", allow_overwrite=False)
        with pytest.raises(absent):
            client.blocking_key_value_get("missing", 30)
        client.key_value_delete("lease")
        assert "lease" not in dict(peer.key_value_dir_get(""))
        assert client.ping()["ok"] is True
    finally:
        srv.stop()


@pytest.mark.parametrize("created,timeout", [(95.0, 10.0), (50.0, 10.0),
                                             (99.5, 0.4), (0.0, 30.0)])
def test_scan_dead_ranks_same_verdicts_both_packages(tmp_path, monkeypatch,
                                                     created, timeout):
    """The same heartbeat stamps give the same dead set in both
    packages (a JAX router scanning a port replica agrees with a port
    router)."""
    from mxnet_tpu import kvstore as jkvstore
    from mxnet_tpu_torch import kvstore as pkvstore
    monkeypatch.setattr(jkvstore, "_now", lambda: 100.0)
    monkeypatch.setattr(pkvstore, "_now", lambda: 100.0)
    kv = FileKV(tmp_path / "kv")
    for rank, stamp in ((0, 99.9), (1, 80.0), (3, 95.0), (4, 70.5)):
        kv.key_value_set("mxtpu_hb/%d" % rank, repr(stamp))
    ranks = list(range(6))
    want = jkvstore.scan_dead_ranks(kv, ranks, created, timeout)
    assert pkvstore.scan_dead_ranks(kv, ranks, created, timeout) == want
