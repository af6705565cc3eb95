"""Fleet serving: multi-replica router, replica lifecycle, live swap.

The port's copy of ``mxnet_tpu/serving/fleet.py``.  A front-end
:class:`FleetRouter` spawns (or adopts) N ``ModelServer`` replica
processes -- each with its own bucket set, program registry and, on a
GPU, its own CUDA context and kernel builds -- and owns everything
between the client and the replicas:

- **Least-loaded dispatch**: every request goes to the ready replica
  with the fewest in-flight requests (ties break on the lowest index).
- **Aggregate admission control**: the router rejects with a structured
  429 (:class:`~mxnet_tpu_torch.serving.batcher.ServerBusy`, a
  ``Retry-After`` hint included) against the FLEET-wide depth -- router
  queue plus the sum of per-replica in-flight -- never a single
  replica's; ``drain()`` turns the whole front door into 503s.
- **Replica health via the kvstore heartbeat machinery**: each replica
  runs the stamping thread (``kvstore._start_heartbeat``) against the
  coordination KV (``resilience.netkv``; file-backed by default) and
  the router scans liveness with ``kvstore.scan_dead_ranks``.
- **Generation-stamped shrink/grow**: a replica death writes a
  ``resilience/elastic.py``-format verdict into the fleet ledger
  (``<MXTPU_FLEET_DIR>/LEDGER.json``), bumps the generation and, when
  respawn is on, relaunches the replica at the new generation.  A
  straggler that wakes after being voted out sees ``ledger.generation
  > launched generation`` at startup and exits 3.
- **Live weight hot-swap**: :meth:`FleetRouter.swap` pushes a new
  versioned param set into replicas ONE AT A TIME without drain; each
  re-binds through its program registry (``ModelServer.swap_params``,
  zero new lowerings, reported back).  ``stats()`` carries the
  version-skew map.
- **Leader lease**: with a KV, several routers share one fleet and
  elect one writer (``resilience.netkv.Lease``); standbys mirror the
  leader's published view.

In-flight requests on a replica that dies fail over to a survivor; if
no ready replica remains they fail with :class:`ReplicaDead` -- a
structured error, never a hung future.

Transport is HTTP on localhost with npz bodies (:func:`encode_arrays`,
the JAX package's codec byte for byte).  Replicas are
``python -m mxnet_tpu_torch.tools.mxfleet replica`` processes
(:func:`run_replica`); the spec's ``"ctx"`` (``"gpu"`` by default,
``"cpu"`` to serve on the CPU) is passed to every ``add_model``, and a
replica asked for a GPU that finds none exits non-zero.  Unit tests
bypass HTTP entirely: the router accepts any duck-typed client with
``predict/stats/swap/drain``.
"""
from __future__ import annotations

import io as _io
import json as _json
import os as _os
import subprocess
import threading as _threading
import time as _time
from collections import deque as _deque

import numpy as _np

from ..base import MXNetError
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from ..resilience.netkv import (FileKV, KVUnreachable, KeyAbsent,
                                Lease, connect_kv)
from .batcher import ServerBusy, Future, max_queue as _serve_max_queue, \
    max_delay_ms as _serve_max_delay_ms

__all__ = ["FileKV", "FleetRouter", "FleetClient", "ReplicaDead",
           "NotLeader", "HTTPReplicaClient", "run_replica",
           "launch_fleet", "adopt_fleet", "spawn_replica", "connect_kv",
           "encode_arrays", "decode_arrays", "fleet_dir",
           "fleet_replicas", "fleet_max_queue", "fleet_base_port",
           "fleet_hb_timeout_s", "fleet_ledger_path",
           "fleet_generation", "fleet_routers", "fleet_tenants",
           "fleet_lease_ttl_s"]


# ----------------------------------------------------------------------
# env knobs — read at call time so tests can
# monkeypatch the environment
# ----------------------------------------------------------------------
def fleet_replicas(explicit=None):
    """``MXTPU_FLEET_REPLICAS``: replica count (default 2)."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(_os.environ.get("MXTPU_FLEET_REPLICAS", "2"))
    except ValueError:
        return 2


def fleet_dir(explicit=None):
    """``MXTPU_FLEET_DIR``: shared directory for the heartbeat KV and
    the fleet ledger (router and every replica must see it)."""
    return explicit or _os.environ.get("MXTPU_FLEET_DIR") or \
        _os.path.join(_os.getcwd(), "mxtpu_fleet")


def fleet_base_port(explicit=None):
    """``MXTPU_FLEET_BASE_PORT``: replica ``i`` listens on base+i."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(_os.environ.get("MXTPU_FLEET_BASE_PORT", "8931"))
    except ValueError:
        return 8931


def fleet_max_queue(explicit=None, n_replicas=None):
    """``MXTPU_FLEET_MAX_QUEUE``: fleet-wide admission bound (router
    queue + total in-flight).  Default: replicas x the per-replica
    ``MXTPU_SERVE_MAX_QUEUE`` — the fleet front door admits what the
    fleet can actually hold, not what one replica can."""
    if explicit is not None:
        return int(explicit)
    raw = _os.environ.get("MXTPU_FLEET_MAX_QUEUE")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return (n_replicas or fleet_replicas()) * _serve_max_queue()


def fleet_hb_timeout_s(explicit=None):
    """``MXTPU_FLEET_HB_TIMEOUT_S``: heartbeat staleness bound before a
    replica counts as dead (default 5x the stamp interval, the same
    slack ``dead_nodes`` gives training workers)."""
    if explicit is not None:
        return float(explicit)
    from ..kvstore import _HB_INTERVAL
    try:
        return float(_os.environ.get("MXTPU_FLEET_HB_TIMEOUT_S",
                                     str(5 * _HB_INTERVAL)))
    except ValueError:
        return 5 * 2.0


def fleet_respawn(default=True):
    """``MXTPU_FLEET_RESPAWN``: grow back after a replica death?"""
    raw = _os.environ.get("MXTPU_FLEET_RESPAWN")
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "off", "no")


def router_threads(explicit=None):
    """``MXTPU_FLEET_ROUTER_THREADS``: dispatch worker count."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(_os.environ.get("MXTPU_FLEET_ROUTER_THREADS", "8"))
    except ValueError:
        return 8


def fleet_generation(default=0):
    """``MXTPU_FLEET_GENERATION``: the generation a replica was
    launched at — its fence against stale incarnations."""
    raw = _os.environ.get("MXTPU_FLEET_GENERATION")
    return int(raw) if raw else default


def fleet_ledger_path(directory=None):
    """The fleet's generation ledger — same JSON schema and atomic
    writer as the elastic training ledger, different path."""
    return _os.path.join(fleet_dir(directory), "LEDGER.json")


def fleet_routers(explicit=None):
    """``MXTPU_FLEET_ROUTERS``: comma-separated front-door URLs a
    :class:`FleetClient` fails over between (default: the single
    local router on ``MXTPU_FLEET_PORT``)."""
    if explicit is not None:
        return [str(u).rstrip("/") for u in explicit]
    raw = _os.environ.get("MXTPU_FLEET_ROUTERS")
    if raw:
        return [u.strip().rstrip("/") for u in raw.split(",")
                if u.strip()]
    port = int(_os.environ.get("MXTPU_FLEET_PORT", "8930"))
    return ["http://127.0.0.1:%d" % port]


def fleet_router_id(explicit=None):
    """``MXTPU_FLEET_ROUTER_ID``: this router's lease identity
    (default ``r<pid>`` — unique per process, stable per restart of a
    supervised router that pins the env var)."""
    return explicit or _os.environ.get("MXTPU_FLEET_ROUTER_ID") or \
        "r%d" % _os.getpid()


def fleet_lease_ttl_s(explicit=None):
    """``MXTPU_FLEET_LEASE_TTL_S``: leader-lease TTL (default 3 s).
    Standby takeover happens within one TTL of leader death; the
    leader renews at a third of it."""
    if explicit is not None:
        return float(explicit)
    try:
        return float(_os.environ.get("MXTPU_FLEET_LEASE_TTL_S", "3"))
    except ValueError:
        return 3.0


def fleet_tenants(explicit=None):
    """``MXTPU_FLEET_TENANTS``: per-tenant admission budgets —
    ``name:rate:burst[:weight]`` clauses separated by ``;``, e.g.
    ``teamA:50:100:3;teamB:10:20:1``.  ``rate`` is requests/second
    refill, ``burst`` the token-bucket depth, ``weight`` the fair-
    dequeue share (default 1).  Unset/empty: no tenant lanes — the
    fleet behaves exactly as before (one FIFO, global bound only)."""
    raw = explicit if explicit is not None \
        else _os.environ.get("MXTPU_FLEET_TENANTS", "")
    tenants = {}
    for clause in (raw or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                "MXTPU_FLEET_TENANTS clause %r: want "
                "name:rate:burst[:weight]" % clause)
        name = parts[0].strip()
        tenants[name] = {"rate": float(parts[1]),
                         "burst": float(parts[2]),
                         "weight": max(1, int(parts[3]))
                         if len(parts) == 4 else 1}
    return tenants


class _TokenBucket(object):
    """Deterministic token bucket: ``burst`` depth, ``rate``/s refill
    computed on demand from the monotonic clock (no refill thread).
    Caller holds the router lock."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = _time.monotonic()

    def take(self):
        """Consume one token; False (and no consumption) when empty."""
        now = _time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after_ms(self):
        if self.rate <= 0:
            return None
        return max(1.0, (1.0 - self.tokens) / self.rate * 1e3)


# ----------------------------------------------------------------------
# coordination KV: surface + backends now live in resilience/netkv.py
# (FileKV re-exported above for compatibility); the router picks its
# backend with MXTPU_KV_URL via connect_kv()
# ----------------------------------------------------------------------
_FLEET_VIEW_KEY = "mxtpu_fleet/view"
_SWAP_PTR_KEY = "mxtpu_fleet/params_ptr"


class NotLeader(MXNetError):
    """A standby router was asked for a leader-only action (swap,
    verdict-writing).  Front doors answer 409 with the leader hint so
    clients re-aim instead of mutating through the wrong router."""

    def __init__(self, action, router_id=None, leader=None):
        self.action = action
        self.router_id = router_id
        self.leader = leader
        super(NotLeader, self).__init__(
            "router %s is standby: %s is leader-only (leader: %s)"
            % (router_id, action, leader or "unknown"))

    def to_dict(self):
        return {"error": "not_leader", "action": self.action,
                "router_id": self.router_id, "leader": self.leader}


class ReplicaDead(MXNetError):
    """A request's replica died (or no ready replica remains) and
    failover was exhausted — the structured failure a queued future
    receives instead of hanging."""

    def __init__(self, model, replica=None, reason="replica dead",
                 attempts=0):
        self.model = model
        self.replica = replica
        self.reason = reason
        self.attempts = int(attempts)
        super(ReplicaDead, self).__init__(
            "replica dead: model %r replica %s (%s) after %d attempt(s)"
            % (model, replica, reason, self.attempts))

    def to_dict(self):
        return {"error": "replica_dead", "model": self.model,
                "replica": self.replica, "reason": self.reason,
                "attempts": self.attempts}


# ----------------------------------------------------------------------
# npz transport codec (router <-> replica bodies)
# ----------------------------------------------------------------------
_BARE_KEY = "__bare__"


def encode_arrays(inputs):
    """numpy dict (or one bare array) -> npz bytes."""
    if not isinstance(inputs, dict):
        inputs = {_BARE_KEY: _np.asarray(inputs)}
    buf = _io.BytesIO()
    _np.savez(buf, **{k: _np.asarray(v) for k, v in inputs.items()})
    return buf.getvalue()


def decode_arrays(body):
    """npz bytes -> numpy dict (a ``__bare__`` key collapses back to
    the bare array)."""
    with _np.load(_io.BytesIO(body)) as zf:
        out = {k: zf[k] for k in zf.files}
    if set(out) == {_BARE_KEY}:
        return out[_BARE_KEY]
    return out


class HTTPReplicaClient(object):
    """The router's handle on one replica process (npz over HTTP on
    localhost).  Transport failures surface as OSError — the router's
    cue to mark the replica dead and fail over."""

    def __init__(self, host, port, timeout=30.0):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)

    def _request(self, method, path, body=None, headers=None,
                 timeout=None):
        import http.client
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=timeout or self.timeout)
        try:
            conn.request(method, path, body=body,
                         headers=dict(headers or {}))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    @staticmethod
    def _raise_busy(status, payload):
        doc = _json.loads(payload.decode() or "{}")
        raise ServerBusy(doc.get("model"),
                         doc.get("queue_depth", 0),
                         doc.get("limit", 0),
                         retry_after_ms=doc.get("retry_after_ms"),
                         code=status, reason=doc.get("reason", "busy"))

    def predict(self, model, inputs, n=None, trace_id=None,
                timeout=None):
        headers = {"Content-Type": "application/x-npz",
                   "X-MXTPU-Model": model}
        if n is not None:
            headers["X-MXTPU-N"] = str(int(n))
        if trace_id:
            headers["X-MXTPU-Trace"] = str(trace_id)
        status, payload = self._request(
            "POST", "/v1/predict", body=encode_arrays(inputs),
            headers=headers, timeout=timeout)
        if status in (429, 503):
            self._raise_busy(status, payload)
        if status != 200:
            raise MXNetError("replica %s:%d predict -> %d: %s"
                             % (self.host, self.port, status,
                                payload[:200]))
        arrays = decode_arrays(payload)
        return [arrays[k] for k in sorted(arrays)]

    def stats(self):
        status, payload = self._request("GET", "/v1/stats")
        if status != 200:
            raise MXNetError("replica stats -> %d" % status)
        return _json.loads(payload.decode())

    def healthz(self):
        status, _payload = self._request("GET", "/healthz", timeout=2.0)
        return status == 200

    def swap(self, params, version=None, timeout=None):
        body = _json.dumps({"params": _os.fspath(params),
                            "version": version}).encode()
        status, payload = self._request(
            "POST", "/v1/swap", body=body,
            headers={"Content-Type": "application/json"},
            timeout=timeout or max(self.timeout, 120.0))
        doc = _json.loads(payload.decode() or "{}")
        if status != 200:
            raise MXNetError("replica swap -> %d: %s" % (status, doc))
        return doc

    def drain(self):
        status, _payload = self._request("POST", "/v1/drain")
        return status == 200


# ----------------------------------------------------------------------
# the router
# ----------------------------------------------------------------------
class _Replica(object):
    """Router-side state for one replica."""

    __slots__ = ("index", "client", "state", "inflight", "requests",
                 "param_version", "proc", "port", "deaths", "reason")

    def __init__(self, index, client, proc=None, port=None):
        self.index = int(index)
        self.client = client
        self.state = "ready"     # ready | rebinding | starting | dead
        self.inflight = 0
        self.requests = 0
        self.param_version = None
        self.proc = proc
        self.port = port
        self.deaths = 0
        self.reason = None


class _Work(object):
    __slots__ = ("model", "inputs", "n", "trace_id", "tenant",
                 "future", "t_arrival")

    def __init__(self, model, inputs, n, trace_id, tenant=None):
        self.model = model
        self.inputs = inputs
        self.n = n
        self.trace_id = trace_id
        self.tenant = tenant
        self.future = Future()
        self.t_arrival = _time.perf_counter()


class FleetRouter(object):
    """Front-end router over N ModelServer replicas (module docstring).

    ``clients``: replica handles in index order — duck-typed with
    ``predict(model, inputs, n, trace_id)`` / ``stats()`` /
    ``swap(params, version)`` / ``drain()`` (unit tests pass fakes;
    production passes :class:`HTTPReplicaClient`).  ``kv``: a
    :class:`FileKV` (or any dir_get-capable client) whose
    ``mxtpu_hb/<index>`` stamps the health loop scans; None disables
    heartbeat scanning (deaths are then detected on transport failure
    only).  ``spawner``: ``spawner(index, generation) -> (proc,
    client)`` enables respawn-on-death (grow-back).
    """

    def __init__(self, clients, kv=None, max_queue=None,
                 hb_timeout_s=None, directory=None, spawner=None,
                 respawn=None, threads=None, rebind_wait_s=15.0,
                 router_id=None, lease_ttl_s=None, tenants=None):
        self._replicas = {i: _Replica(i, c)
                          for i, c in enumerate(clients)}
        self._kv = kv
        self._dir = fleet_dir(directory)
        self.max_queue = fleet_max_queue(max_queue,
                                         n_replicas=len(self._replicas))
        self._hb_timeout = fleet_hb_timeout_s(hb_timeout_s)
        self._spawner = spawner
        self._respawn = fleet_respawn() if respawn is None else respawn
        self._rebind_wait_s = float(rebind_wait_s)
        self._lock = _threading.Lock()
        self._cv = _threading.Condition(self._lock)
        # per-tenant admission lanes (module docstring): one
        # FIFO per configured tenant plus the unbudgeted default lane;
        # with no tenants the cycle is just ["default"] — dequeue order
        # is then bit-for-bit the old single-FIFO behavior
        cfgs = fleet_tenants(tenants)
        default_weight = cfgs.pop("default", {"weight": 1})["weight"]
        self._tenants = {
            name: {"bucket": _TokenBucket(cfg["rate"], cfg["burst"]),
                   "weight": cfg["weight"], "admitted": 0,
                   "rejected": 0}
            for name, cfg in cfgs.items()}
        self._lanes = {"default": _deque()}
        for name in self._tenants:
            self._lanes[name] = _deque()
        self._rr = ["default"] * max(1, default_weight) + \
            [name for name in sorted(self._tenants)
             for _ in range(self._tenants[name]["weight"])]
        self._rr_pos = 0
        self._accepting = True
        self._stop = False
        self._created = _time.time()
        self._threads = []
        self._health_thread = None
        self._stats = {"requests": 0, "rejected": 0, "failed": 0,
                       "retries": 0, "swaps": 0}
        self._swap_pause_ms = []
        led = self._read_ledger()
        self._generation = int(led.get("generation", 0)) if led else 0
        # leader lease: with a KV,
        # N routers share the fleet and elect one writer; without one
        # (unit fleets) this router is its own leader, as before
        self.router_id = fleet_router_id(router_id)
        self._lease = None
        self._takeovers = 0
        self._kv_fault_since = None
        self._scan_hold_until = 0.0
        self._swap_ptr_seen = None
        if self._kv is not None:
            self._lease = Lease(self._kv, self.router_id,
                                ttl_s=fleet_lease_ttl_s(lease_ttl_s))
            self._first_election()
        for _ in range(router_threads(threads)):
            t = _threading.Thread(target=self._dispatch_loop,
                                  daemon=True, name="mxfleet-dispatch")
            t.start()
            self._threads.append(t)
        if self._kv is not None:
            self._health_thread = _threading.Thread(
                target=self._health_loop, daemon=True,
                name="mxfleet-health")
            self._health_thread.start()

    def _first_election(self):
        """Synchronous first election, then the swap pointer that was
        already published (a pre-existing pointer is not a swap).  An
        unreachable KV is the fault the health loop holds through: it is
        recorded with :meth:`_note_kv_fault` (``stats()["kv_held"]``),
        the router starts as a standby unless its lease holds, and the
        health loop re-runs the election on its next tick."""
        try:
            # Lease.poll is an election over atomic KV writes, not a
            # rendezvous: no router waits inside it for this one, so one
            # that skips it on a KV fault only stays standby until the
            # health loop's next election
            # mxl: rank-divergent-ok (MXL-D006)
            self._lease.poll()
            self._swap_ptr_seen = self._kv.blocking_key_value_get(
                _SWAP_PTR_KEY, 50)
        except KeyAbsent:
            pass                    # the KV answered: no pointer yet
        except (KVUnreachable, OSError):
            self._note_kv_fault()

    # -- ledger / generation (elastic.py reuse) ------------------------

    def _read_ledger(self):
        from ..resilience import elastic as _elastic
        return _elastic.read_ledger(path=fleet_ledger_path(self._dir))

    def _write_verdict(self, members, reason, from_world):
        from ..resilience import elastic as _elastic
        # both the dispatch pool (swap) and the heartbeat thread land
        # here; an unguarded += would let two verdicts share a
        # generation number
        with self._cv:
            self._generation += 1
            generation = self._generation
        verdict = {"generation": generation,
                   "world_size": len(members),
                   "members": sorted(members),
                   "reason": reason,
                   "from_world": from_world}
        _elastic.write_ledger(verdict, path=fleet_ledger_path(self._dir))
        from .. import observability as _obs
        _obs.emit("elastic", event="propose", tier="serve",
                  **{k: verdict.get(k) for k in
                     ("generation", "world_size", "members", "reason",
                      "from_world")})
        _obs.flush()
        return verdict

    @property
    def generation(self):
        with self._lock:
            return self._generation

    # -- admission -----------------------------------------------------

    def _queued(self):
        """Total router-queued work across lanes (caller holds lock)."""
        return sum(len(q) for q in self._lanes.values())

    def aggregate_depth(self):
        """Fleet-wide pending work: router lanes + total in-flight."""
        with self._lock:
            return self._queued() + sum(r.inflight for r in
                                        self._replicas.values())

    def submit(self, model, inputs, n=None, trace_id=None,
               tenant=None):
        """Admit one request fleet-wide; returns a Future.  429 against
        the AGGREGATE depth (never one replica's) — or against the
        TENANT's token budget when ``tenant`` names a configured lane
        (``MXTPU_FLEET_TENANTS``; a hot tenant 429s against ITS bucket
        while siblings keep flowing) — 503 when draining, all as
        structured :class:`ServerBusy`.  Unknown/absent tenants ride
        the unbudgeted default lane."""
        if trace_id is None and _trace.enabled():
            trace_id = _trace.new_id()
        lane = tenant if tenant in self._tenants else "default"
        with self._cv:
            if not self._accepting:
                raise ServerBusy(model, 0, 0, code=503,
                                 reason="draining")
            if lane != "default":
                ten = self._tenants[lane]
                if not ten["bucket"].take():
                    ten["rejected"] += 1
                    self._stats["rejected"] += 1
                    raise ServerBusy(
                        model, len(self._lanes[lane]),
                        int(ten["bucket"].burst),
                        retry_after_ms=ten["bucket"].retry_after_ms(),
                        reason="tenant budget",
                        extra={"tenant": lane})
            depth = self._queued() + sum(
                r.inflight for r in self._replicas.values())
            if 0 < self.max_queue <= depth:
                self._stats["rejected"] += 1
                ready = sum(1 for r in self._replicas.values()
                            if r.state == "ready")
                raise ServerBusy(
                    model, depth, self.max_queue,
                    retry_after_ms=_serve_max_delay_ms(),
                    reason="fleet queue full",
                    extra={"replicas_ready": ready})
            work = _Work(model, inputs, n, trace_id, tenant=tenant)
            if lane != "default":
                self._tenants[lane]["admitted"] += 1
            self._lanes[lane].append(work)
            self._cv.notify()
        return work.future

    def predict(self, model, inputs, n=None, timeout=60.0):
        """Blocking convenience: submit + wait."""
        return self.submit(model, inputs, n=n).result(timeout=timeout)

    # -- dispatch ------------------------------------------------------

    def _pick(self, exclude):
        """Least-loaded ready replica not in ``exclude`` (ties -> the
        lowest index), or None.  Caller holds the lock."""
        best = None
        for rep in self._replicas.values():
            if rep.state != "ready" or rep.index in exclude:
                continue
            key = (rep.inflight, rep.index)
            if best is None or key < best[0]:
                best = (key, rep)
        return best[1] if best else None

    def _acquire(self, exclude):
        """Pick-and-reserve under the lock; waits (bounded) through a
        window where every live replica is rebinding/starting — the
        hot-swap hold-out must delay requests, not kill them."""
        deadline = _time.monotonic() + self._rebind_wait_s
        while True:
            with self._cv:
                rep = self._pick(exclude)
                if rep is not None:
                    rep.inflight += 1
                    return rep
                transitional = any(
                    r.state in ("rebinding", "starting")
                    and r.index not in exclude
                    for r in self._replicas.values())
            if not transitional or _time.monotonic() > deadline:
                return None
            _time.sleep(0.02)

    def _release(self, rep):
        with self._cv:
            rep.inflight -= 1
            self._cv.notify()

    def _next_work(self):
        """Weighted-fair dequeue over tenant lanes (caller holds the
        lock): walk the weight-expanded cycle from a rotating cursor
        and pop the first non-empty lane.  A tenant with weight 3
        appears 3x in the cycle and gets 3x the dequeue share under
        contention; with no tenants the cycle is ["default"] and this
        is a plain FIFO popleft."""
        n = len(self._rr)
        for off in range(n):
            lane = self._rr[(self._rr_pos + off) % n]
            q = self._lanes[lane]
            if q:
                self._rr_pos = (self._rr_pos + off + 1) % n
                return q.popleft()
        return None

    def _dispatch_loop(self):
        while True:
            with self._cv:
                while not self._queued() and not self._stop:
                    self._cv.wait(0.05)
                work = self._next_work()
                if work is None:
                    if self._stop:
                        return
                    continue
            self._dispatch_one(work)

    def _dispatch_one(self, work):
        tried = set()
        last_busy = None
        while True:
            rep = self._acquire(tried)
            if rep is None:
                with self._lock:
                    self._stats["failed"] += 1
                if last_busy is not None:
                    work.future._fail(last_busy)
                else:
                    work.future._fail(ReplicaDead(
                        work.model, reason="no ready replica",
                        attempts=len(tried)))
                return
            tried.add(rep.index)
            try:
                outs = rep.client.predict(work.model, work.inputs,
                                          n=work.n,
                                          trace_id=work.trace_id)
            except ServerBusy as busy:
                # the replica's OWN admission bound tripped (possible
                # under skewed load even when the fleet door admitted):
                # try a sibling; only if every replica is busy does the
                # 429 propagate to the client
                self._release(rep)
                last_busy = busy
                with self._lock:
                    self._stats["retries"] += 1
                continue
            except MXNetError as exc:
                self._release(rep)
                with self._lock:
                    self._stats["failed"] += 1
                work.future._fail(exc)      # client error (bad model/
                return                      # shape): no failover
            except Exception as exc:        # transport death
                self._release(rep)
                self._on_replica_death(rep, repr(exc))
                with self._lock:
                    self._stats["retries"] += 1
                last_busy = None
                continue
            self._release(rep)
            with self._lock:
                self._stats["requests"] += 1
                rep.requests += 1
            work.future._set(outs)
            return

    # -- health / lifecycle --------------------------------------------

    def _is_leader(self):
        """kv-less routers (unit fleets) are their own leader."""
        return self._lease is None or self._lease.leading

    def _leader_hint(self):
        """Best-effort current leader id (for 409 bodies / stats)."""
        if self._lease is None:
            return self.router_id
        rec = self._lease.peek()
        return rec["holder"] if rec else None

    def _on_replica_death(self, rep, reason):
        """Mark dead once; the LEADER also writes the shrink verdict
        and respawns.  A standby only stops routing there — the leader
        scans the same heartbeats and owns the ledger, so a standby
        verdict would double-bump the generation."""
        with self._cv:
            if rep.state == "dead":
                return
            rep.state = "dead"
            rep.reason = reason
            rep.deaths += 1
            alive = [r.index for r in self._replicas.values()
                     if r.state != "dead"]
            from_world = len(alive) + 1
        if not self._is_leader():
            return
        self._write_verdict(alive, "replica_death", from_world)
        if rep.proc is not None:
            try:
                rep.proc.kill()
                rep.proc.wait(timeout=5)
            except Exception:
                pass
        if self._respawn and self._spawner is not None:
            self._respawn_replica(rep)

    def _respawn_replica(self, rep):
        with self._cv:
            generation = self._generation
        try:
            proc, client = self._spawner(rep.index, generation)
        except Exception as exc:
            rep.reason = "respawn failed: %r" % (exc,)
            return
        with self._cv:
            rep.proc, rep.client = proc, client
            rep.state = "starting"
            rep.param_version = None
        # the health loop promotes it to ready once /healthz answers

    def _health_loop(self):
        from ..resilience.faultinject import maybe_fault
        while not self._stop:
            _time.sleep(0.5)
            if self._stop:
                return
            # drillable router death (faultinject kind=router_death):
            # hard-exit mid-tick — standbys must take over within one
            # lease TTL, clients fail over between front doors
            if maybe_fault("router_death") is not None:
                _os._exit(43)
            if self._lease is not None:
                was = self._lease.leading
                leading = self._lease.poll()
                if leading and not was:
                    self._on_takeover()
                elif was and not leading:
                    self._emit_role("stepdown")
                if not leading:
                    self._standby_tick()
                    continue
            self._leader_tick()

    def _emit_role(self, event):
        from .. import observability as _obs
        with self._lock:
            gen = self._generation
        _obs.emit("elastic", event="router_%s" % event, tier="serve",
                  router_id=self.router_id, generation=gen)
        _obs.flush()

    def _on_takeover(self):
        """A standby won the lease: adopt the ledger's generation (the
        dead leader may have written verdicts we never mirrored) and
        give heartbeat scanning one timeout of grace — this router's
        view starts cold and the fleet may be mid-recovery."""
        try:
            led = self._read_ledger()
        except Exception:
            led = None
        with self._cv:
            if led and int(led.get("generation", 0)) > self._generation:
                self._generation = int(led.get("generation", 0))
            self._takeovers += 1
            self._scan_hold_until = _time.monotonic() + self._hb_timeout
        self._emit_role("takeover")

    def _note_kv_fault(self):
        """KV went unreachable (mid-scan, or at the first election): hold
        the last verdict (the KV fault discipline) — replicas keep serving,
        no deaths are invented, and the hold is telemetered once."""
        with self._lock:
            first = self._kv_fault_since is None
            if first:
                self._kv_fault_since = _time.monotonic()
        if first:
            from .. import observability as _obs
            _obs.emit("fault", fault="kv_hold", scope="fleet_router",
                      router_id=self.router_id)
            _obs.flush()

    def _note_kv_ok(self):
        """KV answered again: stamps may be as stale as the outage was
        long, so skip heartbeat verdicts for one timeout while the
        stamping threads catch back up."""
        with self._lock:
            healed = self._kv_fault_since is not None
            if healed:
                self._kv_fault_since = None
                self._scan_hold_until = (_time.monotonic()
                                         + self._hb_timeout)
        if healed:
            from .. import observability as _obs
            _obs.emit("fault", fault="kv_hold_released",
                      scope="fleet_router", router_id=self.router_id)
            _obs.flush()

    def _leader_tick(self):
        from ..kvstore import scan_dead_ranks
        with self._lock:
            live = [r.index for r in self._replicas.values()
                    if r.state in ("ready", "rebinding")]
            starting = [r for r in self._replicas.values()
                        if r.state == "starting"]
            lost = [r for r in self._replicas.values()
                    if r.state == "dead" and r.proc is None]
            hold = _time.monotonic() < self._scan_hold_until
        dead = []
        if live:
            try:
                dead = scan_dead_ranks(self._kv, live, self._created,
                                       self._hb_timeout)
            except KVUnreachable:
                self._note_kv_fault()
                return
        self._note_kv_ok()
        if hold:
            dead = []
        for idx in dead:
            self._on_replica_death(self._replicas[idx],
                                   "heartbeat stale")
        for rep in starting:
            # a respawned replica joins rotation when it answers
            # health checks (its heartbeat follows)
            try:
                ok = rep.client.healthz()
            except Exception:
                ok = False
            if ok:
                with self._cv:
                    if rep.state == "starting":
                        rep.state = "ready"
                alive = [r.index for r in self._replicas.values()
                         if r.state != "dead"]
                self._write_verdict(alive, "grow", len(alive) - 1)
        for rep in lost:
            # a replica WE never spawned (adopted fleet / verdict
            # mirrored while standing by) that answers health checks
            # again is a live survivor — fenced stale incarnations
            # exited and can't answer
            try:
                ok = rep.client.healthz()
            except Exception:
                ok = False
            if ok:
                with self._cv:
                    if rep.state == "dead":
                        rep.state = "ready"
                        rep.reason = None
                alive = [r.index for r in self._replicas.values()
                         if r.state != "dead"]
                self._write_verdict(alive, "grow", len(alive) - 1)
        self._publish_view()
        self._check_swap_ptr()

    def _publish_view(self):
        """Leader publishes the fleet view (replica states, generation,
        applied params pointer) for standbys to reconcile from."""
        with self._lock:
            doc = {"leader": self.router_id,
                   "generation": self._generation,
                   "params_ptr": self._swap_ptr_seen,
                   "replicas": {
                       str(i): {"state": r.state, "port": r.port,
                                "param_version": r.param_version}
                       for i, r in self._replicas.items()}}
        try:
            self._kv.key_value_set(_FLEET_VIEW_KEY,
                                   _json.dumps(doc, sort_keys=True))
        except (KVUnreachable, OSError):
            pass                    # best-effort: next tick republishes

    def _standby_tick(self):
        """Standby: serve reads off the leader-published view — adopt
        its generation, mirror replica verdicts (probing health before
        resurrecting), and track the applied params pointer so a later
        takeover doesn't re-run an already-applied swap."""
        try:
            raw = self._kv.blocking_key_value_get(_FLEET_VIEW_KEY, 50)
        except (KeyAbsent, KVUnreachable, OSError):
            return
        try:
            view = _json.loads(raw)
        except (TypeError, ValueError):
            return
        with self._cv:
            if int(view.get("generation", 0)) > self._generation:
                self._generation = int(view.get("generation", 0))
            if view.get("params_ptr") is not None:
                self._swap_ptr_seen = view["params_ptr"]
        for key, info in (view.get("replicas") or {}).items():
            try:
                rep = self._replicas[int(key)]
            except (KeyError, ValueError):
                continue
            state = info.get("state")
            if state == "dead" and rep.state in ("ready", "rebinding"):
                with self._cv:
                    if rep.state in ("ready", "rebinding"):
                        rep.state = "dead"
                        rep.reason = "leader verdict"
            elif state == "ready" and rep.state == "dead":
                try:
                    ok = rep.client.healthz()
                except Exception:
                    ok = False
                if ok:
                    with self._cv:
                        if rep.state == "dead":
                            rep.state = "ready"
                            rep.reason = None

    def _check_swap_ptr(self):
        """``MXTPU_FLEET_SWAP_ON_COMMIT`` consumer: when the checkpoint
        manager publishes a new versioned-params pointer, the LEADER
        runs one drainless swap against it — one attempt per published
        version (a failed swap shows in the version-skew map, never a
        retry storm)."""
        try:
            raw = self._kv.blocking_key_value_get(_SWAP_PTR_KEY, 50)
        except (KeyAbsent, KVUnreachable, OSError):
            return
        with self._lock:
            if raw == self._swap_ptr_seen:
                return
            self._swap_ptr_seen = raw
        try:
            doc = _json.loads(raw)
            params = doc["params"]
            version = doc.get("version")
        except (TypeError, ValueError, KeyError):
            return
        from .. import observability as _obs
        _obs.emit("elastic", event="swap_on_commit", tier="serve",
                  router_id=self.router_id, version=version)
        try:
            self.swap(params, version=version)
        except Exception as exc:
            _obs.emit("fault", fault="swap_on_commit_failed",
                      router_id=self.router_id, version=version,
                      error=repr(exc))
            _obs.flush()

    # -- live weight hot-swap ------------------------------------------

    def swap(self, params, version=None):
        """Push new params into every ready replica, one at a time,
        WITHOUT drain: each replica leaves rotation only for its own
        re-bind window.  Returns per-replica results (including each
        replica's ``lowerings`` delta — the zero-new-lowerings proof)
        plus the pause distribution; a replica whose swap fails keeps
        serving the OLD version and shows up in the version-skew map
        rather than taking the fleet down.

        Leader-only when the fleet runs a lease: standbys raise
        :class:`NotLeader` (the front door answers 409 with the leader
        hint so clients re-aim).
        """
        if not self._is_leader():
            raise NotLeader("swap", router_id=self.router_id,
                            leader=self._leader_hint())
        results = {}
        with self._lock:
            order = sorted(i for i, r in self._replicas.items()
                           if r.state == "ready")
        for idx in order:
            rep = self._replicas[idx]
            with self._cv:
                if rep.state != "ready":
                    continue
                rep.state = "rebinding"      # out of rotation
            t0 = _time.perf_counter()
            try:
                res = rep.client.swap(params, version=version)
            except Exception as exc:
                # failed swap: the old predictors were never replaced —
                # back into rotation on the old version
                results[idx] = {"error": repr(exc)}
                with self._cv:
                    if rep.state == "rebinding":
                        rep.state = "ready"
                continue
            pause_ms = (_time.perf_counter() - t0) * 1e3
            with self._cv:
                rep.param_version = res.get("version")
                if rep.state == "rebinding":
                    rep.state = "ready"
                self._swap_pause_ms.append(round(pause_ms, 3))
            results[idx] = dict(res, swap_pause_ms=round(pause_ms, 3))
        with self._lock:
            self._stats["swaps"] += 1
            pauses = list(self._swap_pause_ms)
        return {"replicas": results, "version": version,
                "swap_pause_ms": pauses}

    # -- introspection / shutdown --------------------------------------

    def stats(self):
        """Router counters + per-replica state + the version-skew map
        (which replica serves which param version) + role/lease and the
        per-tenant admission rollup."""
        from ..observability.counters import percentile
        with self._lock:
            reps = {}
            skew = {}
            for i, r in sorted(self._replicas.items()):
                reps[str(i)] = {"state": r.state,
                                "inflight": r.inflight,
                                "requests": r.requests,
                                "param_version": r.param_version,
                                "deaths": r.deaths,
                                "reason": r.reason}
                skew.setdefault(r.param_version or "?", []).append(i)
            out = dict(self._stats)
            out["queue_depth"] = self._queued() + sum(
                r.inflight for r in self._replicas.values())
            pauses = list(self._swap_pause_ms)
            out["generation"] = self._generation
            out["takeovers"] = self._takeovers
            out["kv_held"] = self._kv_fault_since is not None
            tenants = {
                name: {"queued": len(self._lanes[name]),
                       "weight": t["weight"],
                       "admitted": t["admitted"],
                       "rejected": t["rejected"],
                       "tokens": round(t["bucket"].tokens, 3)}
                for name, t in sorted(self._tenants.items())}
        out["max_queue"] = self.max_queue
        out["router_id"] = self.router_id
        out["role"] = "leader" if self._is_leader() else "standby"
        if self._lease is not None:
            out["lease"] = self._lease.stats()
        if tenants:
            out["tenants"] = tenants
        out["replicas"] = reps
        out["version_skew"] = {v: sorted(idxs)
                               for v, idxs in sorted(skew.items())}
        if pauses:
            out["swap_pause_ms_p95"] = round(percentile(pauses, 95), 3)
        return out

    def replica_stats(self):
        """Fan out /v1/stats to every live replica (best-effort)."""
        out = {}
        for i, rep in sorted(self._replicas.items()):
            if rep.state == "dead":
                out[str(i)] = {"state": "dead", "reason": rep.reason}
                continue
            try:
                out[str(i)] = rep.client.stats()
            except Exception as exc:
                out[str(i)] = {"error": repr(exc)}
        return out

    def drain(self, timeout=30.0):
        """Stop admission fleet-wide (submit -> 503), flush the router
        queue and in-flight work, then drain every live replica."""
        deadline = _time.monotonic() + timeout
        with self._cv:
            self._accepting = False
            self._cv.notify_all()
            while self._queued() or any(r.inflight for r in
                                        self._replicas.values()):
                if _time.monotonic() > deadline:
                    raise TimeoutError("fleet drain: work still queued")
                self._cv.wait(0.05)
        for rep in self._replicas.values():
            if rep.state == "dead":
                continue
            try:
                rep.client.drain()
            except Exception:
                pass

    def close(self, drain=True, timeout=30.0):
        if drain and self._accepting:
            try:
                self.drain(timeout=timeout)
            except TimeoutError:
                pass
        with self._cv:
            # the heartbeat loop polls this GIL-atomic monotonic flag
            # unlocked; a stale read costs one 0.5 s beat, never a
            # torn value  # mxl: thread-shared-ok (MXL-Q001)
            self._stop = True
            self._accepting = False
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        if self._health_thread is not None:
            self._health_thread.join(timeout=2.0)
            self._health_thread = None
        if self._lease is not None:
            # hand the lease over NOW so a standby leads in one poll
            # instead of one TTL
            self._lease.release()
        for rep in self._replicas.values():
            if rep.proc is not None:
                rep.proc.terminate()
                try:
                    rep.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    rep.proc.kill()     # reaped too: no zombie is left
                    rep.proc.wait(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ----------------------------------------------------------------------
# front-door client: failover between router addresses
# ----------------------------------------------------------------------
class FleetClient(object):
    """Client over N router front doors (``MXTPU_FLEET_ROUTERS``).

    Sticky with failover: requests keep going to the router that
    answered last; a TRANSPORT failure (connect refused/reset — never
    a 4xx/5xx answer) rotates to the next address and retries the
    request there.  An answering router is a healthy router: 429/503
    bodies raise the same structured :class:`ServerBusy` the single-
    router path does, and a 409 ``not_leader`` on :meth:`swap` re-aims
    at the next address until the leader answers.  Predict is safe to
    retry across routers — the router dispatches to idempotent model
    replicas."""

    def __init__(self, routers=None, timeout=30.0):
        self.routers = fleet_routers(routers)
        self.timeout = float(timeout)
        self._idx = 0
        self.failovers = 0

    @staticmethod
    def _hostport(url):
        rest = url.split("://", 1)[-1].rstrip("/")
        host, _, port = rest.partition(":")
        return host, int(port or 80)

    def _request(self, method, path, body=None, headers=None,
                 timeout=None):
        """One HTTP round-trip with address failover; returns
        ``(status, payload)`` from the first router that ANSWERS."""
        import http.client
        last = None
        for off in range(len(self.routers)):
            i = (self._idx + off) % len(self.routers)
            host, port = self._hostport(self.routers[i])
            conn = http.client.HTTPConnection(
                host, port, timeout=timeout or self.timeout)
            try:
                conn.request(method, path, body=body,
                             headers=dict(headers or {}))
                resp = conn.getresponse()
                payload = resp.read()
            except OSError as exc:
                last = exc
                if off + 1 < len(self.routers):
                    self.failovers += 1
                continue
            finally:
                conn.close()
            self._idx = i
            return resp.status, payload
        raise MXNetError("fleet: no router reachable (%s): %r"
                         % (", ".join(self.routers), last))

    def predict(self, model, inputs, n=None, tenant=None,
                trace_id=None, timeout=None):
        headers = {"Content-Type": "application/x-npz",
                   "X-MXTPU-Model": model}
        if n is not None:
            headers["X-MXTPU-N"] = str(int(n))
        if tenant:
            headers["X-MXTPU-Tenant"] = str(tenant)
        if trace_id:
            headers["X-MXTPU-Trace"] = str(trace_id)
        status, payload = self._request(
            "POST", "/v1/predict", body=encode_arrays(inputs),
            headers=headers, timeout=timeout)
        if status in (429, 503):
            HTTPReplicaClient._raise_busy(status, payload)
        if status != 200:
            raise MXNetError("fleet predict -> %d: %s"
                             % (status, payload[:200]))
        arrays = decode_arrays(payload)
        return [arrays[k] for k in sorted(arrays)]

    def stats(self):
        status, payload = self._request("GET", "/v1/stats")
        if status != 200:
            raise MXNetError("fleet stats -> %d" % status)
        return _json.loads(payload.decode())

    def swap(self, params, version=None):
        body = _json.dumps({"params": _os.fspath(params),
                            "version": version}).encode()
        last = None
        for _ in range(len(self.routers)):
            status, payload = self._request(
                "POST", "/v1/swap", body=body,
                headers={"Content-Type": "application/json"},
                timeout=max(self.timeout, 120.0))
            doc = _json.loads(payload.decode() or "{}")
            if status == 409:       # standby: re-aim at the next door
                last = doc
                self._idx = (self._idx + 1) % len(self.routers)
                continue
            if status != 200:
                raise MXNetError("fleet swap -> %d: %s" % (status, doc))
            return doc
        raise NotLeader("swap", leader=(last or {}).get("leader"))


# ----------------------------------------------------------------------
# process lifecycle: spawning real replicas
# ----------------------------------------------------------------------
def _package_root():
    """The directory holding the ``mxnet_tpu_torch`` package."""
    here = _os.path.dirname(_os.path.abspath(__file__))
    return _os.path.dirname(_os.path.dirname(here))


def spawn_replica(spec_path, index, port, directory, generation=0,
                  host="127.0.0.1", extra_env=None):
    """Launch one replica subprocess (``python -m
    mxnet_tpu_torch.tools.mxfleet replica``, with the package's root on
    ``PYTHONPATH``).  Returns the Popen handle."""
    import sys
    env = dict(_os.environ)
    env["MXTPU_FLEET_REPLICA"] = str(index)
    env["MXTPU_FLEET_GENERATION"] = str(generation)
    env["MXTPU_FLEET_DIR"] = directory
    env.setdefault("MXTPU_WORKER_RANK", str(index))
    env["PYTHONPATH"] = _os.pathsep.join(
        p for p in (_package_root(), env.get("PYTHONPATH")) if p)
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.mxfleet",
           "replica", "--spec", _os.fspath(spec_path),
           "--index", str(index), "--port", str(port), "--host", host]
    return subprocess.Popen(cmd, env=env)


def _replica_ports(n, base_port, ports):
    """Replica ``i``'s port: ``ports[i]`` when given (callers that pick
    free ports at run time), else ``base + i``."""
    if ports is not None:
        ports = [int(p) for p in ports]
        if len(ports) != n:
            raise MXNetError("fleet: %d ports for %d replicas"
                             % (len(ports), n))
        return ports
    base = fleet_base_port(base_port)
    return [base + i for i in range(n)]


def launch_fleet(spec_path, n_replicas=None, directory=None,
                 base_port=None, host="127.0.0.1", max_queue=None,
                 respawn=None, startup_timeout_s=90.0, extra_env=None,
                 kv_url=None, router_id=None, lease_ttl_s=None,
                 tenants=None, ports=None):
    """Spawn N replicas + the router over them; returns the router.

    Writes generation 0 into the fleet ledger, spawns each replica
    with its index/port/generation, waits for every ``/healthz``, and
    wires the health loop to the shared coordination KV the replicas
    heartbeat into — ``MXTPU_KV_URL``/``kv_url`` picks the backend
    (file-backed by default, ``tcp://`` for a networked fleet); the
    replicas inherit the same URL through the environment.  The
    router's spawner closure re-uses the same recipe for grow-back
    respawns (at the then-current generation, on the same port).
    ``ports`` pins each replica's port (default ``base_port + i``).
    """
    import http.client
    directory = fleet_dir(directory)
    n = fleet_replicas(n_replicas)
    ports = _replica_ports(n, base_port, ports)
    _os.makedirs(directory, exist_ok=True)
    kv = connect_kv(url=kv_url,
                    default_root=_os.path.join(directory, "kv"))
    if kv_url:
        extra_env = dict(extra_env or {})
        extra_env.setdefault("MXTPU_KV_URL", kv_url)
    from ..resilience import elastic as _elastic
    if _elastic.read_ledger(path=fleet_ledger_path(directory)) is None:
        _elastic.write_ledger(
            {"generation": 0, "world_size": n,
             "members": list(range(n)), "reason": "launch",
             "from_world": 0},
            path=fleet_ledger_path(directory))
    procs, clients = [], []
    for i in range(n):
        procs.append(spawn_replica(spec_path, i, ports[i], directory,
                                   generation=0, host=host,
                                   extra_env=extra_env))
        clients.append(HTTPReplicaClient(host, ports[i]))
    deadline = _time.monotonic() + startup_timeout_s
    try:
        for i, client in enumerate(clients):
            while True:
                try:
                    if client.healthz():
                        break
                except (OSError, http.client.HTTPException):
                    pass            # not listening yet
                if procs[i].poll() is not None:
                    raise MXNetError("replica %d exited with %s during "
                                     "startup" % (i, procs[i].returncode))
                if _time.monotonic() > deadline:
                    raise MXNetError("replica %d not healthy within %.0fs"
                                     % (i, startup_timeout_s))
                _time.sleep(0.1)
    except MXNetError:
        for proc in procs:          # no replica outlives a failed launch
            proc.kill()
            proc.wait(timeout=10)
        raise

    def spawner(index, generation):
        proc = spawn_replica(spec_path, index, ports[index], directory,
                             generation=generation, host=host,
                             extra_env=extra_env)
        return proc, HTTPReplicaClient(host, ports[index])

    router = FleetRouter(clients, kv=kv, max_queue=max_queue,
                         directory=directory, spawner=spawner,
                         respawn=respawn, router_id=router_id,
                         lease_ttl_s=lease_ttl_s, tenants=tenants)
    for i, proc in enumerate(procs):
        router._replicas[i].proc = proc
        router._replicas[i].port = ports[i]
    return router


def adopt_fleet(n_replicas=None, directory=None, base_port=None,
                host="127.0.0.1", max_queue=None, kv_url=None,
                router_id=None, lease_ttl_s=None, tenants=None,
                spec_path=None, respawn=None, ports=None):
    """Build a router OVER an already-running fleet: no replica
    spawning, no ledger seeding, no process ownership.

    This is how standby routers come up (``mxfleet serve --adopt``):
    N processes call this against the same KV and replica ports; the
    expiring lease decides which one leads.  ``spec_path`` (optional)
    arms the respawn spawner so a standby that takes over can still
    grow the fleet back after a replica death; without it the adopted
    router never spawns (``respawn`` is forced off)."""
    directory = fleet_dir(directory)
    n = fleet_replicas(n_replicas)
    ports = _replica_ports(n, base_port, ports)
    _os.makedirs(directory, exist_ok=True)
    kv = connect_kv(url=kv_url,
                    default_root=_os.path.join(directory, "kv"))
    clients = [HTTPReplicaClient(host, ports[i]) for i in range(n)]
    spawner = None
    if spec_path is not None:
        def spawner(index, generation):
            proc = spawn_replica(spec_path, index, ports[index],
                                 directory, generation=generation,
                                 host=host)
            return proc, HTTPReplicaClient(host, ports[index])
    router = FleetRouter(
        clients, kv=kv, max_queue=max_queue, directory=directory,
        spawner=spawner,
        respawn=False if spec_path is None else respawn,
        router_id=router_id, lease_ttl_s=lease_ttl_s, tenants=tenants)
    for i in range(n):
        router._replicas[i].port = ports[i]
    return router


# ----------------------------------------------------------------------
# replica side: ModelServer behind the npz HTTP wrapper
# ----------------------------------------------------------------------
def _build_replica_server(spec):
    """ModelServer from a fleet spec dict: ``{"models": [{name,
    symbol, params, input_shapes, buckets|histogram, priority?,
    dtypes?}], "version"?, "max_delay_ms"?, "max_queue"?, "ctx"?}``.
    ``symbol`` is JSON text or a path; ``params`` a path (the checkpoint
    the replica loads).  ``ctx`` (``"gpu"`` by default, ``"cpu"`` to
    serve on the CPU) is passed to every ``add_model``; a GPU context
    raises when CUDA has no device, so a replica never serves on the
    CPU unless asked."""
    from ..context import Context
    from .server import ModelServer
    ctx = Context(spec.get("ctx") or "gpu")
    srv = ModelServer(max_delay_ms=spec.get("max_delay_ms"),
                      max_queue=spec.get("max_queue"))
    for m in spec.get("models", ()):
        srv.add_model(
            m["name"], m["symbol"], m["params"],
            {nm: tuple(shape) for nm, shape
             in m["input_shapes"].items()},
            histogram=m.get("histogram"),
            buckets=m.get("buckets"),
            ctx=ctx,
            priority=int(m.get("priority", 0)),
            dtypes=m.get("dtypes"))
    if spec.get("version"):
        srv.param_version = str(spec["version"])
    return srv


def cuda_memory():
    """This process's CUDA caching-allocator bytes (reserved, peak
    allocated), or None when it drives no CUDA device."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return {"reserved": torch.cuda.memory_reserved(),
            "max_allocated": torch.cuda.max_memory_allocated()}


def make_replica_handler(srv, index):
    """BaseHTTPRequestHandler subclass wrapping one ModelServer:
    ``/v1/predict`` (npz in/out), ``/v1/stats`` (with the process's
    ``observability.metrics.kernel_counters()`` and
    :func:`cuda_memory`), ``/healthz``,
    ``/v1/swap``, ``/v1/drain``.  Backpressure mirrors mxserve: 429/503
    with the structured ServerBusy dict and a Retry-After header."""
    from http.server import BaseHTTPRequestHandler
    from ..resilience.faultinject import maybe_fault
    from . import telemetry as _tel

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *fmt_args):
            if _os.environ.get("MXTPU_SERVE_VERBOSE"):
                import sys
                sys.stderr.write("mxfleet[%d]: %s\n"
                                 % (index, fmt % fmt_args))

        def _reply_json(self, code, doc, headers=()):
            body = _json.dumps(doc, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_npz(self, body):
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npz")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _busy(self, busy):
            hdrs = []
            if busy.retry_after_ms:
                hdrs.append(("Retry-After",
                             "%.3f" % (busy.retry_after_ms / 1e3)))
            self._reply_json(busy.code, busy.to_dict(), hdrs)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply_json(200, {"status": "ok", "index": index})
            elif self.path == "/v1/stats":
                doc = srv.stats()
                doc["index"] = index
                doc["pid"] = _os.getpid()
                doc["generation"] = fleet_generation()
                doc["kernel_launches"] = _metrics.kernel_counters()
                doc["cuda_memory"] = cuda_memory()
                self._reply_json(200, doc)
            else:
                self._reply_json(404, {"error": "not_found",
                                       "path": self.path})

        def do_POST(self):
            if self.path == "/v1/predict":
                self._predict()
            elif self.path == "/v1/swap":
                self._swap()
            elif self.path == "/v1/drain":
                srv.drain()
                self._reply_json(200, {"status": "drained"})
            else:
                self._reply_json(404, {"error": "not_found",
                                       "path": self.path})

        def _predict(self):
            # the replica_death seam: an injected fault here kills the
            # process mid-request — the drillable half of "router must
            # fail over without hanging the client's future"
            if maybe_fault("replica_death", rank=index) is not None:
                _os._exit(17)
            try:
                length = int(self.headers.get("Content-Length") or 0)
                inputs = decode_arrays(self.rfile.read(length))
                model = self.headers.get("X-MXTPU-Model") \
                    or srv.models()[0]
                n_raw = self.headers.get("X-MXTPU-N")
                trace_id = self.headers.get("X-MXTPU-Trace") or None
                fut = srv.submit(model, inputs,
                                 n=int(n_raw) if n_raw else None,
                                 trace_id=trace_id)
                outs = fut.result(timeout=60.0)
            except ServerBusy as busy:
                self._busy(busy)
                return
            except (KeyError, ValueError, TypeError, MXNetError) as exc:
                self._reply_json(400, {"error": "bad_request",
                                       "reason": str(exc)})
                return
            except Exception as exc:
                self._reply_json(500, {"error": "internal",
                                       "reason": str(exc)})
                return
            self._reply_npz(encode_arrays(
                {"out%03d" % i: o for i, o in enumerate(outs)}))

        def _swap(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
                doc = _json.loads(self.rfile.read(length) or b"{}")
                res = srv.swap_params(doc["params"],
                                      version=doc.get("version"))
                _tel.set_fleet_context(
                    param_version=res["version"])
            except (KeyError, ValueError, TypeError, MXNetError) as exc:
                self._reply_json(400, {"error": "bad_request",
                                       "reason": str(exc)})
                return
            except Exception as exc:
                # includes an injected swap_crash: the old predictors
                # were never replaced, so this replica keeps serving
                # the old version — report, don't die
                self._reply_json(500, {"error": "swap_failed",
                                       "reason": repr(exc),
                                       "version": srv.param_version})
                return
            self._reply_json(200, dict(res, index=index))

    return Handler


def run_replica(spec_path, index, port, host="127.0.0.1"):
    """Replica process main (``mxfleet replica``): generation
    fence -> build ModelServer from the spec -> start the shared
    kvstore heartbeat against the fleet FileKV -> serve HTTP until
    SIGTERM.  Exits 3 (the elastic restart code) when fenced."""
    import signal
    import sys
    from .. import kvstore as _kvstore
    from ..resilience import EXIT_RESTART
    from ..resilience import elastic as _elastic
    from . import telemetry as _tel

    directory = fleet_dir()
    my_gen = fleet_generation()
    led = _elastic.read_ledger(path=fleet_ledger_path(directory))
    if led and int(led.get("generation", 0)) > my_gen:
        sys.stderr.write(
            "mxfleet[%d]: stale generation %d (ledger at %s); exiting "
            "for restart\n" % (index, my_gen, led.get("generation")))
        return EXIT_RESTART

    with open(spec_path) as fin:
        spec = _json.load(fin)
    _os.environ["MXTPU_FLEET_REPLICA"] = str(index)
    _tel.set_fleet_context(replica=index,
                           param_version=spec.get("version") or "v0")
    srv = _build_replica_server(spec)

    # heartbeat into the same coordination backend the router scans
    # (MXTPU_KV_URL, inherited from the launcher) — through the
    # ResilientKV discipline, so a KV blip retries instead of
    # silently ending the stamping thread
    kv = connect_kv(default_root=_os.path.join(directory, "kv"))
    _kvstore._start_heartbeat(client=kv, rank=index)

    from http.server import ThreadingHTTPServer
    httpd = ThreadingHTTPServer((host, int(port)),
                                make_replica_handler(srv, int(index)))

    def shutdown(_sig, _frm):
        # deliberate fire-and-forget: httpd.shutdown() must run off the
        # signal frame (it joins serve_forever), and the process exits
        # right after it fires  # mxl: thread-shared-ok (MXL-Q004)
        _threading.Thread(target=httpd.shutdown, daemon=True).start()
    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    sys.stderr.write("mxfleet[%d]: replica on http://%s:%d (gen %d)\n"
                     % (index, host, int(port), my_gen))
    try:
        httpd.serve_forever()
    finally:
        srv.close()
        httpd.server_close()
        from ..observability import events as _events
        _events.flush()
    return 0
