"""Elastic re-mesh: generation ledger, fencing, the decision protocol.

The port's copy of ``mxnet_tpu/resilience/elastic.py``.  Serving fleets
use the ledger and the fence today; the training-side re-mesh runs
with the multi-GPU slice.

- **Ledger** (:func:`read_ledger` / :func:`write_ledger`): the last
  agreed transition as plain JSON, written atomically (tmp + fsync +
  rename), byte-compatible with the JAX package's::

      {"generation": 2, "world_size": 3, "members": [0, 1, 2],
       "reason": "grow", "from_world": 2}

- **Generation fencing** (:func:`check_generation_fence`): a straggler
  launched at generation ``g`` that finds ``ledger.generation > g``
  exits for restart instead of joining an incarnation it was voted out
  of.
- **Re-mesh decision protocol** (:func:`poll_remesh`): rank 0 proposes a
  new membership from heartbeat liveness (shrink) or from the capacity
  file (grow) and publishes a generation-stamped verdict in the
  coordination KV; every survivor adopts that one verdict.  The client
  is :func:`_kv_client` -- the process's coordination client, None in
  the port until the multi-GPU slice; with None, rank 0 still decides
  and persists the ledger and the others adopt nothing.

Capacity signal: an integer in ``<MXTPU_ELASTIC_DIR>/capacity`` (or
``MXTPU_ELASTIC_CAPACITY_FILE``).  Missing file = no constraint.
"""
from __future__ import annotations

import json as _json
import os as _os

from ..base import collective_seam
from . import ResilienceError, exit_for_restart, step_timeout_s

__all__ = [
    "enabled", "min_world", "target_world", "generation", "elastic_dir",
    "ledger_path", "read_ledger", "write_ledger", "capacity",
    "check_generation_fence", "poll_remesh", "recover_round",
    "exit_for_remesh", "emit_transition",
]

#: coordination-KV prefix for published re-mesh verdicts
_VERDICT_PREFIX = "mxtpu_elastic/"
#: published value meaning "this round decided no transition"
_NO_VERDICT = "none"

_LEDGER_NAME = "LEDGER.json"
_CAPACITY_NAME = "capacity"


# ----------------------------------------------------------------------
# env knobs — read at call time so tests can monkeypatch the
# environment, mirroring resilience.step_timeout_s
# ----------------------------------------------------------------------
def enabled(default=False):
    """``MXTPU_ELASTIC``: elastic mode on?"""
    raw = _os.environ.get("MXTPU_ELASTIC")
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "off", "no")


def min_world(default=1):
    """``MXTPU_ELASTIC_MIN_WORLD``: smallest world size worth running;
    the launcher refuses to respawn below it."""
    raw = _os.environ.get("MXTPU_ELASTIC_MIN_WORLD")
    return int(raw) if raw else default


def target_world(default=None):
    """``MXTPU_ELASTIC_TARGET_WORLD``: the world size grow-back aims
    for (never exceeded)."""
    raw = _os.environ.get("MXTPU_ELASTIC_TARGET_WORLD")
    return int(raw) if raw else default


def generation(default=0):
    """``MXTPU_ELASTIC_GENERATION``: this incarnation's generation,
    stamped by the launcher; falls back to the ledger."""
    raw = _os.environ.get("MXTPU_ELASTIC_GENERATION")
    if raw:
        return int(raw)
    led = read_ledger()
    if led is not None:
        return int(led.get("generation", default))
    return default


def elastic_dir():
    """``MXTPU_ELASTIC_DIR``: shared directory holding the ledger and
    the capacity file (must be visible to launcher and every worker)."""
    return _os.environ.get("MXTPU_ELASTIC_DIR") or \
        _os.path.join(_os.getcwd(), "mxtpu_elastic")


def ledger_path():
    return _os.path.join(elastic_dir(), _LEDGER_NAME)


def capacity_path():
    return _os.environ.get("MXTPU_ELASTIC_CAPACITY_FILE") or \
        _os.path.join(elastic_dir(), _CAPACITY_NAME)


# ----------------------------------------------------------------------
# ledger: generation state that survives incarnations
# ----------------------------------------------------------------------
def read_ledger(path=None):
    """The last agreed transition as a dict, or None (fresh run /
    unreadable file — a torn write can only be the pre-rename tmp,
    which this never reads)."""
    path = ledger_path() if path is None else path
    try:
        with open(path) as fin:
            led = _json.load(fin)
    except (OSError, ValueError):
        return None
    return led if isinstance(led, dict) else None


def write_ledger(verdict, path=None):
    """Atomically persist ``verdict`` (tmp + rename, same recipe as the
    checkpoint commit): a crash mid-write leaves the old ledger
    readable, never a half-written generation."""
    path = ledger_path() if path is None else path
    directory = _os.path.dirname(path) or "."
    _os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fout:
        _json.dump(verdict, fout, sort_keys=True)
        fout.flush()
        _os.fsync(fout.fileno())
    _os.rename(tmp, path)
    return path


def capacity(default=None):
    """Schedulable world size from the capacity file; ``default`` when
    the file is absent/unreadable (= unconstrained)."""
    try:
        with open(capacity_path()) as fin:
            return int(fin.read().strip())
    except (OSError, ValueError):
        return default


# ----------------------------------------------------------------------
# generation fencing
# ----------------------------------------------------------------------
def check_generation_fence():
    """Raise (kind=``stale_generation``) when the ledger has moved past
    this process's launched generation: a worker wedged through a whole
    re-mesh must not join the incarnation it was voted out of.  The
    raise unwinds to :func:`exit_for_restart` (exit 3).  No-op unless
    elastic mode is on.
    """
    if not enabled():
        return
    my_gen = generation()
    led = read_ledger()
    led_gen = int(led.get("generation", 0)) if led else 0
    if led_gen > my_gen:
        raise ResilienceError(
            "stale generation: launched at %d but the pod agreed "
            "generation %d (world %s); exiting for restart"
            % (my_gen, led_gen, led.get("world_size") if led else "?"),
            phase="elastic_fence", kind="stale_generation")


# ----------------------------------------------------------------------
# the re-mesh decision protocol
# ----------------------------------------------------------------------
def recover_round(epoch):
    """Round id for the fault path: every survivor of a mid-epoch
    collective failure lands on the same ``recover-<epoch>`` round (the
    epoch is rank-uniform), so the recovery agreement pairs up even
    though the failure hit each rank at a different batch."""
    return "recover-%s" % (epoch,)


def _decide(kv, world, dead_timeout):
    """Coordinator-side verdict, or None: shrink onto heartbeat
    survivors, else grow toward capacity (never past the target)."""
    dead = [r for r in kv.dead_nodes(timeout=dead_timeout) if r < world]
    if dead:
        members = [r for r in range(world) if r not in dead]
        return {
            "generation": generation() + 1,
            "world_size": len(members),
            "members": members,
            "reason": "dead_node",
            "from_world": world,
        }
    cap = capacity()
    target = target_world()
    if cap is not None and cap > world and \
            (target is None or world < target):
        new_world = min(cap, target) if target is not None else cap
        if new_world > world:
            return {
                "generation": generation() + 1,
                "world_size": new_world,
                "members": list(range(new_world)),
                "reason": "grow",
                "from_world": world,
            }
    return None


@collective_seam
def poll_remesh(kv, round_id, dead_timeout=None, timeout_s=None):
    """One agreement round: returns the adopted verdict dict, or None.

    Every rank calls this with the SAME ``round_id``.  Rank 0 decides --
    dead peers from ``kv.dead_nodes`` liveness, grow-back from
    :func:`capacity` -- persists the ledger, then publishes the verdict
    (or an explicit no-op marker) under a generation+round-unique key of
    the coordination client; every other rank blocks on that single
    key, so no rank ever guesses what rank 0 saw.  Rank 0 then lingers
    (bounded) for per-rank adoption acks.  A non-coordinator whose read
    times out raises (kind=``remesh_orphan``).  Certified rank-uniform
    (``@collective_seam``).
    """
    from .. import observability as _obs
    key = "%spoll/%d/%s" % (_VERDICT_PREFIX, generation(), round_id)
    client = _kv_client()
    if kv.rank != 0:
        if client is None:
            return None
        if timeout_s is None:
            timeout_s = step_timeout_s(default=60.0)
        try:
            raw = client.blocking_key_value_get(
                key, int(timeout_s * 1000.0))
        except Exception as exc:  # noqa: BLE001 - converted to abort
            raise ResilienceError(
                "re-mesh round %r: no verdict from rank 0 (%r); "
                "coordinator presumed dead, exiting for restart"
                % (round_id, exc), phase="elastic_poll", rank=kv.rank,
                kind="remesh_orphan", timeout_s=timeout_s)
        if raw == _NO_VERDICT:
            return None
        verdict = _json.loads(raw)
        _obs.emit("elastic", event="adopt", round=str(round_id),
                  **_verdict_fields(verdict))
        _obs.flush()        # adopter exits moments later; don't lose it
        try:                # ack releases the lingering coordinator
            client.key_value_set("%s/ack/%d" % (key, kv.rank), "1",
                                 allow_overwrite=True)
        except Exception:
            pass
        return verdict
    verdict = _decide(kv, kv.num_workers, dead_timeout)
    if verdict is not None:
        write_ledger(verdict)
        _obs.emit("elastic", event="propose", round=str(round_id),
                  **_verdict_fields(verdict))
        _obs.flush()
    if client is not None:
        client.key_value_set(
            key, _NO_VERDICT if verdict is None
            else _json.dumps(verdict, sort_keys=True),
            allow_overwrite=True)
        if verdict is not None:
            _await_adoption(client, key, kv, verdict)
        _gc_poll_key(client, round_id)
    return verdict


#: how long the publishing coordinator lingers for each survivor's ack
_ACK_WAIT_MS = 10_000


def _await_adoption(client, key, kv, verdict):
    """Rank 0 waits (bounded) until every surviving member has read the
    verdict: the coordination service lives in rank 0's process, so it
    must outlive the survivors' adopt-reads.  Best-effort — a survivor
    that never acks is someone the NEXT recovery round will vote out."""
    for r in verdict.get("members", []):
        if r == 0 or r >= kv.num_workers:
            continue        # rank 0 is us; grown-in ranks don't exist yet
        try:
            client.blocking_key_value_get("%s/ack/%d" % (key, r),
                                          _ACK_WAIT_MS)
        except Exception:
            pass
    return None


def _verdict_fields(verdict):
    return {k: verdict.get(k) for k in
            ("generation", "world_size", "members", "reason",
             "from_world")}


def _kv_client():
    """The coordination client the protocol publishes through (None in
    one process; tests inject one)."""
    from ..kvstore import _dist_client
    return _dist_client()


def _gc_poll_key(client, round_id):
    """Drop the round-2 poll key (every rank finished round-1 before
    contributing to this one — same aging rule as the kv allreduce)."""
    if not isinstance(round_id, int) or round_id < 2:
        return
    try:
        client.key_value_delete(
            "%spoll/%d/%s" % (_VERDICT_PREFIX, generation(),
                              round_id - 2))
    except Exception:
        pass


def exit_for_remesh(verdict, hot_state=None, step=None):
    """Flush telemetry and exit with the restart signal, carrying the
    adopted verdict's context.  ``hot_state`` (optional): a host tree to
    offload into the warm-handoff area first (``hotstate.snapshot``); a
    snapshot failure never blocks the restart, the next incarnation then
    takes the checkpoint rung.
    """
    if hot_state is not None:
        from . import hotstate as _hotstate
        try:
            if _hotstate.warm_enabled():
                _hotstate.snapshot(hot_state, step=step)
        except Exception as exc:  # noqa: BLE001 - degrade, never wedge
            emit_transition("snapshot_failed", step=step,
                            error=str(exc))
    exit_for_restart(ResilienceError(
        "re-mesh agreed: generation %s world %s (%s)"
        % (verdict.get("generation"), verdict.get("world_size"),
           verdict.get("reason")),
        phase="elastic_remesh", kind="remesh"))


def emit_transition(event, step=None, world_size=None, **fields):
    """Record an ``elastic`` telemetry event for this incarnation
    (``resume`` at startup after a transition; ``propose``/``adopt``
    are emitted by :func:`poll_remesh` itself)."""
    from .. import observability as _obs
    _obs.emit("elastic", step=step, event=event,
              generation=generation(), world_size=world_size, **fields)
    _obs.flush()            # transitions are rare and must survive kills
