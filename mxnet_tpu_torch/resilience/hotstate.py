"""Warm elasticity: diskless re-mesh via redundant host-memory hot state.

The port's copy of ``mxnet_tpu/resilience/hotstate.py``.  The payload
files (``shards.npz`` + ``manifest.json``) are the JAX package's byte
for byte, so either package warm-resumes the other's snapshot.

- **Snapshot** (:func:`snapshot`): each rank host-offloads its state --
  a torch tensor is one whole shard (a port tensor is unsharded on one
  device), copied to the host -- with per-shard index metadata and a
  CRC32 into the *handoff area* (``MXTPU_HANDOFF_DIR``; a tmpfs keeps
  the warm path off disk).
- **Ring-buddy redundancy**: each rank also pushes a replica of its
  payload into the NEXT host's area (``MXTPU_HOTSTATE_BUDDIES``), never
  its own, so losing one host leaves every shard readable.
- **Shard directory** (:func:`agree_warm_sources`): rank 0 picks the
  newest (generation, step) at which every old rank is still served
  and publishes ``{old_rank: payload}`` over the coordination KV.
- **Warm resume** (:func:`warm_resume`): assemble the full host tree
  from the agreed sources (CRC-verified reads); zero checkpoint reads.

**Fallback ladder**: any missing payload set -> cold verdict; any CRC
mismatch / unreadable payload / coverage hole -> :class:`HotStateUnavailable`
with a stable ``reason`` -- the caller falls back to the checkpoint.
Drillable through ``MXTPU_FAULT_SPEC`` (seams ``host_snapshot`` /
``handoff_read`` / ``buddy_loss``).

Host model: ranks are grouped into simulated hosts (``MXTPU_NUM_HOSTS``
/ ``MXTPU_HOST_INDEX``; default one host per rank).  Each host's RAM is
the directory ``<handoff>/<namespace>/host-<h>``; the drills simulate a
host loss by deleting it (:func:`simulate_host_loss`).

Layout (all writes tmp+rename)::

    <handoff>/<namespace>/host-<h>/own/rank-<r>/{shards.npz,manifest.json}
    <handoff>/<namespace>/host-<h>/buddy/rank-<r>/{...}   # replica of a
                                                          # NEIGHBOR's rank
"""
from __future__ import annotations

import json as _json
import os as _os
import shutil as _shutil
import time as _time
import zlib as _zlib

import numpy as _np

from ..base import collective_seam
from . import ResilienceError, step_timeout_s
from .faultinject import maybe_fault

__all__ = [
    "warm_enabled", "handoff_dir", "num_buddies", "num_hosts",
    "host_index", "buddy_hosts", "HotStateUnavailable",
    "snapshot", "scan", "decide_sources", "agree_warm_sources",
    "load_sources", "warm_resume", "host_area", "simulate_host_loss",
    "clear",
]

_MANIFEST = "manifest.json"
_SHARDS = "shards.npz"
#: coordination-KV prefix for published shard directories
_SOURCES_PREFIX = "mxtpu_hotstate/"
_FORMAT_VERSION = 1


class HotStateUnavailable(RuntimeError):
    """Warm resume cannot proceed — fall back to the checkpoint.

    ``reason`` is a stable token (``disabled``, ``no_payloads``,
    ``incomplete``, ``cold_verdict``, ``crc_mismatch``,
    ``payload_unreadable``, ``missing_coverage``, ``target_mismatch``)
    that the caller stamps into the ``elastic`` resume event, so the
    telemetry names exactly which rung of the ladder gave way.
    """

    def __init__(self, reason, detail=""):
        self.reason = reason
        super().__init__("hot state unavailable (%s)%s"
                         % (reason, ": " + detail if detail else ""))


# ----------------------------------------------------------------------
# env knobs — read at call time so tests can
# monkeypatch the environment, mirroring resilience.step_timeout_s
# ----------------------------------------------------------------------
def warm_enabled(default=False):
    """``MXTPU_WARM_REMESH``: attempt the warm (host-memory) resume
    path on elastic transitions."""
    raw = _os.environ.get("MXTPU_WARM_REMESH")
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "off", "no")


def handoff_dir():
    """``MXTPU_HANDOFF_DIR``: the handoff area root.  Defaults to
    ``<MXTPU_ELASTIC_DIR>/handoff``; production points it at a tmpfs
    (``/dev/shm/...``) so the warm path truly never touches disk."""
    raw = _os.environ.get("MXTPU_HANDOFF_DIR")
    if raw:
        return raw
    from . import elastic as _elastic
    return _os.path.join(_elastic.elastic_dir(), "handoff")


def num_buddies(default=1):
    """``MXTPU_HOTSTATE_BUDDIES``: ring-buddy replicas per payload
    (0 disables redundancy; capped at ``num_hosts - 1``)."""
    raw = _os.environ.get("MXTPU_HOTSTATE_BUDDIES")
    return int(raw) if raw else default


def num_hosts(world):
    """``MXTPU_NUM_HOSTS``: simulated host count (RAM-loss domains);
    default one host per rank."""
    raw = _os.environ.get("MXTPU_NUM_HOSTS")
    n = int(raw) if raw else int(world)
    return max(1, min(n, int(world)))


def host_index(rank, world):
    """Which host ``rank`` lives on: ``MXTPU_HOST_INDEX`` when set
    (per-process env), else contiguous blocks — world 4 over 2 hosts
    puts ranks 0,1 on host 0 and 2,3 on host 1."""
    raw = _os.environ.get("MXTPU_HOST_INDEX")
    if raw:
        return int(raw)
    return int(rank) * num_hosts(world) // max(1, int(world))


def buddy_hosts(rank, world):
    """The hosts this rank's replicas land on: the next
    ``num_buddies()`` hosts around the ring, never its own — on-host
    redundancy dies with the host it was guarding."""
    hosts = num_hosts(world)
    mine = host_index(rank, world)
    out = []
    for i in range(1, hosts):
        if len(out) >= max(0, num_buddies()):
            break
        out.append((mine + i) % hosts)
    return out


# ----------------------------------------------------------------------
# layout helpers
# ----------------------------------------------------------------------
def host_area(host, namespace="train"):
    """The directory standing in for host ``host``'s handoff RAM."""
    return _os.path.join(handoff_dir(), namespace, "host-%d" % int(host))


def _payload_dir(host, source, rank, namespace):
    return _os.path.join(host_area(host, namespace), source,
                         "rank-%d" % int(rank))


def simulate_host_loss(host, namespace="train"):
    """Drill hook: delete host ``host``'s entire handoff area — its
    own payloads AND the buddy replicas it was holding for neighbors —
    exactly what losing that host's RAM takes away."""
    _shutil.rmtree(host_area(host, namespace), ignore_errors=True)


def clear(namespace=None):
    """Remove the handoff area (one namespace, or all of it)."""
    root = handoff_dir() if namespace is None \
        else _os.path.join(handoff_dir(), namespace)
    _shutil.rmtree(root, ignore_errors=True)


def _process_rank_world():
    """(rank, world) of the ``torch.distributed`` group when one is
    initialised, else ``(0, 1)``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# ----------------------------------------------------------------------
# snapshot: device -> host offload + ring-buddy replication
# ----------------------------------------------------------------------
def _index_spec(index, shape):
    """A shard's position as ``[[start, stop], ...]`` per dim (JSON-
    stable; ``slice(None)`` normalizes to the full extent)."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def _leaf_shards(leaf):
    """This process's pieces of ``leaf`` as ``[(index_spec, host_array),
    ...]``: one full-extent entry -- a torch tensor lives whole on one
    device and is copied to the host; numpy arrays pass through."""
    if hasattr(leaf, "detach"):
        arr = leaf.detach().cpu().numpy()
    else:
        arr = _np.asarray(leaf)
    return [([[0, int(d)] for d in arr.shape], arr)]


def _flatten_tree(tree, prefix=""):
    flat = {}
    for key, val in tree.items():
        name = "%s%s" % (prefix, key)
        if isinstance(val, dict):
            flat.update(_flatten_tree(val, name + "/"))
        else:
            flat[name] = val
    return flat


def _unflatten(flat):
    """{'a/b': array} -> nested dicts (inverse of :func:`_flatten_tree`
    when no abstract structure is supplied)."""
    out = {}
    for name, val in flat.items():
        node, parts = out, name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return out


def _write_payload(flat_shards, step, rank, world, host, namespace,
                   extra=None):
    """Write one rank's payload (own copy + buddy replicas), atomically
    per copy: build ``rank-<r>.tmp``, drop the old payload, rename.  A
    crash in the tiny drop/rename window loses only this hot copy —
    the checkpoint rung of the ladder still stands.

    ``flat_shards``: ``{leaf: [(index_spec, host_array), ...]}``.
    Returns the own-copy path.
    """
    arrays, entries = {}, []
    for leaf in sorted(flat_shards):
        for idx, arr in flat_shards[leaf]:
            arr = _np.ascontiguousarray(arr)
            key = "s%d" % len(entries)
            arrays[key] = arr
            entries.append({
                "key": key,
                "leaf": leaf,
                "shape": [int(e - s) for s, e in idx],
                "dtype": arr.dtype.str,
                "index": idx,
                "crc": _zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
            })
    manifest = {
        "version": _FORMAT_VERSION,
        "step": int(step),
        "generation": _generation(),
        "rank": int(rank),
        "world": int(world),
        "host": int(host),
        "namespace": namespace,
        "extra": extra or {},
        "shards": entries,
    }

    def _commit(target):
        tmp = target + ".tmp"
        _shutil.rmtree(tmp, ignore_errors=True)
        _os.makedirs(tmp)
        with open(_os.path.join(tmp, _SHARDS), "wb") as fout:
            _np.savez(fout, **arrays)
            fout.flush()
            _os.fsync(fout.fileno())
        with open(_os.path.join(tmp, _MANIFEST), "w") as fout:
            _json.dump(manifest, fout, sort_keys=True)
            fout.flush()
            _os.fsync(fout.fileno())
        _shutil.rmtree(target, ignore_errors=True)
        _os.rename(tmp, target)

    own = _payload_dir(host, "own", rank, namespace)
    _commit(own)
    # ring-buddy replicas — unless the drill injected a lost push
    if maybe_fault("buddy_loss", step=step, rank=rank) is None:
        for bh in buddy_hosts(rank, world):
            _commit(_payload_dir(bh, "buddy", rank, namespace))
    return own


def _generation():
    from . import elastic as _elastic
    return _elastic.generation()


def snapshot(tree, step, namespace="train", rank=None, world=None,
             extra=None):
    """Host-offload this rank's shards of ``tree`` into the handoff
    area (own copy + ring-buddy replicas).  Called at every stable
    point — after a checkpoint commits, and again right before
    ``exit_for_remesh`` — so the newest consistent state is always one
    host-memory read away.  Cheap: device→host copies plus a CRC, no
    coordination.

    ``tree`` is a nested dict whose leaves are host arrays or torch
    tensors (each copied whole to the host).
    Raises :class:`~.faultinject.InjectedFault` under a
    ``snapshot_crash`` drill — callers on the exit path must treat
    that as "no fresh snapshot", never as "no restart".
    """
    from ..observability import spans as _spans
    if rank is None or world is None:
        prank, pworld = _process_rank_world()
        rank = prank if rank is None else rank
        world = pworld if world is None else world
    maybe_fault("host_snapshot", step=step, rank=rank)
    t0 = _time.monotonic()
    with _spans.span("hotstate_snapshot", step=step):
        flat = {leaf: _leaf_shards(val)
                for leaf, val in _flatten_tree(dict(tree)).items()}
        host = host_index(rank, world)
        path = _write_payload(flat, step, rank, world, host, namespace,
                              extra=extra)
    nbytes = sum(arr.nbytes for shards in flat.values()
                 for _idx, arr in shards)
    _emit("snapshot", step=step, namespace=namespace, rank=rank,
          host=host, bytes=int(nbytes),
          buddies=buddy_hosts(rank, world),
          duration_ms=round((_time.monotonic() - t0) * 1000.0, 3))
    return path


def _emit(event, **fields):
    from . import elastic as _elastic
    _elastic.emit_transition(event, **fields)


# ----------------------------------------------------------------------
# scan + shard directory agreement
# ----------------------------------------------------------------------
def scan(namespace="train"):
    """Every readable payload in the handoff area:
    ``[{rank, step, generation, world, source, relpath}, ...]``.
    Unreadable/partial payloads are skipped — a torn write can only be
    a ``.tmp`` the rename never promoted, but a simulated host loss
    can also vanish a manifest mid-read."""
    root = _os.path.join(handoff_dir(), namespace)
    out = []
    try:
        hosts = sorted(_os.listdir(root))
    except OSError:
        return out
    for hname in hosts:
        if not hname.startswith("host-"):
            continue
        for source in ("own", "buddy"):
            sdir = _os.path.join(root, hname, source)
            try:
                ranks = sorted(_os.listdir(sdir))
            except OSError:
                continue
            for rname in ranks:
                if rname.endswith(".tmp"):
                    continue
                relpath = _os.path.join(hname, source, rname)
                try:
                    with open(_os.path.join(root, relpath,
                                            _MANIFEST)) as fin:
                        man = _json.load(fin)
                except (OSError, ValueError):
                    continue
                out.append({"rank": int(man["rank"]),
                            "step": int(man["step"]),
                            "generation": int(man["generation"]),
                            "world": int(man["world"]),
                            "source": source,
                            "relpath": relpath})
    return out


def decide_sources(namespace="train"):
    """The coordinator's half of the shard directory: pick the newest
    ``(generation, step)`` at which every rank of the recorded world is
    still served — own copy preferred, buddy replica otherwise — and
    return the warm verdict ``{"mode": "warm", "step", "generation",
    "world", "sources": {rank: relpath}}``, or a cold verdict
    ``{"mode": "cold", "reason": ...}`` when no complete set survives.
    Pure host logic over :func:`scan`; no KV, no device."""
    records = scan(namespace)
    if not records:
        return {"mode": "cold", "reason": "no_payloads"}
    groups = {}
    for rec in records:
        groups.setdefault((rec["generation"], rec["step"]), []).append(rec)
    for gen_step in sorted(groups, reverse=True):
        recs = groups[gen_step]
        world = recs[0]["world"]
        sources = {}
        for rec in recs:
            if rec["world"] != world:
                continue        # torn group: mixed worlds never agree
            prev = sources.get(rec["rank"])
            if prev is None or (prev["source"] == "buddy"
                                and rec["source"] == "own"):
                sources[rec["rank"]] = rec
        if set(sources) == set(range(world)):
            return {"mode": "warm", "step": gen_step[1],
                    "generation": gen_step[0], "world": world,
                    "sources": {str(r): sources[r]["relpath"]
                                for r in sorted(sources)},
                    "n_buddy": sum(1 for r in sources.values()
                                   if r["source"] == "buddy")}
    return {"mode": "cold", "reason": "incomplete"}


@collective_seam
def agree_warm_sources(kv, round_id="resume", namespace="train",
                       timeout_s=None):
    """One shard-directory agreement round: every rank returns the SAME
    verdict dict (warm sources or an explicit cold verdict).

    Same decision-protocol shape as ``elastic.poll_remesh``: rank 0
    scans its view of the handoff area and publishes the verdict (cold
    too, so no rank guesses) under a generation+round-unique KV key of
    ``elastic._kv_client()``; every other rank blocks on that single
    key.  Certified rank-uniform (``@collective_seam``).
    """
    from . import elastic as _elastic
    key = "%ssources/%d/%s" % (_SOURCES_PREFIX, _generation(), round_id)
    client = _elastic._kv_client()
    if kv is not None and kv.rank != 0:
        if client is None:
            return decide_sources(namespace)
        if timeout_s is None:
            timeout_s = step_timeout_s(default=60.0)
        try:
            raw = client.blocking_key_value_get(
                key, int(timeout_s * 1000.0))
        except Exception as exc:  # noqa: BLE001 - converted to abort
            raise ResilienceError(
                "warm-source round %r: no directory from rank 0 (%r); "
                "coordinator presumed dead, exiting for restart"
                % (round_id, exc), phase="hotstate_agree", rank=kv.rank,
                kind="remesh_orphan", timeout_s=timeout_s)
        return _json.loads(raw)
    verdict = decide_sources(namespace)
    _emit("warm_agree", namespace=namespace, mode=verdict["mode"],
          step=verdict.get("step"), reason=verdict.get("reason"),
          n_sources=len(verdict.get("sources") or ()),
          n_buddy=verdict.get("n_buddy"))
    if client is not None:
        client.key_value_set(key, _json.dumps(verdict, sort_keys=True),
                             allow_overwrite=True)
    return verdict


# ----------------------------------------------------------------------
# warm load: CRC-verified assembly from the agreed sources
# ----------------------------------------------------------------------
def _read_payload(root, relpath, rank_hint):
    """One payload as (manifest, {key: array}); CRC-verified.  The
    ``handoff_read`` drill seam fires here — a ``corrupt`` spec flips
    the loaded bytes so the REAL CRC check does the rejecting."""
    path = _os.path.join(root, relpath)
    try:
        with open(_os.path.join(path, _MANIFEST)) as fin:
            man = _json.load(fin)
        with _np.load(_os.path.join(path, _SHARDS)) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except Exception as exc:  # noqa: BLE001 - any read tear = this rung
        raise HotStateUnavailable("payload_unreadable",
                                  "%s: %s" % (relpath, exc))
    spec = maybe_fault("handoff_read", rank=rank_hint)
    if spec is not None and spec.kind == "corrupt":
        first = next(iter(sorted(arrays)), None)
        if first is not None:
            buf = bytearray(arrays[first].tobytes())
            buf[0] ^= 0xFF
            arrays[first] = _np.frombuffer(
                bytes(buf), dtype=arrays[first].dtype).reshape(
                    arrays[first].shape)
    for ent in man.get("shards", ()):
        arr = arrays.get(ent["key"])
        if arr is None:
            raise HotStateUnavailable(
                "payload_unreadable", "%s: missing array %s"
                % (relpath, ent["key"]))
        crc = _zlib.crc32(_np.ascontiguousarray(arr).tobytes()) \
            & 0xFFFFFFFF
        if crc != int(ent["crc"]):
            raise HotStateUnavailable(
                "crc_mismatch", "%s leaf %s: crc %d != manifest %d"
                % (relpath, ent["leaf"], crc, int(ent["crc"])))
    return man, arrays


def load_sources(verdict, abstract_tree=None, namespace="train"):
    """Assemble the full host tree from a warm verdict's sources.

    Reads payloads in rank order, CRC-verifying each, splicing every
    shard into its global array by index; stops as soon as every leaf
    is fully covered (replicated state loads exactly one payload —
    rank 0's).  Returns ``(tree, step, meta)``; ``tree`` mirrors
    ``abstract_tree``'s structure when given (shape/dtype checked leaf
    by leaf), else the manifests' own nesting.  Raises
    :class:`HotStateUnavailable` on any tear — the caller's cue to
    take the checkpoint rung.
    """
    if verdict.get("mode") != "warm":
        raise HotStateUnavailable("cold_verdict",
                                  verdict.get("reason") or "")
    root = _os.path.join(handoff_dir(), namespace)
    rank, _world = _process_rank_world()
    sources = sorted(verdict["sources"].items(), key=lambda kv: int(kv[0]))
    # pass 1 — manifests only (cheap JSON, no arrays): union the shard
    # indices into each leaf's GLOBAL shape.  The early-break below
    # must judge coverage against the global extent, not the first
    # payload's slice of it, or a sharded leaf would look "done" after
    # one rank's rows
    specs, extra = {}, {}
    for _src_rank, relpath in sources:
        try:
            with open(_os.path.join(root, relpath, _MANIFEST)) as fin:
                man = _json.load(fin)
        except (OSError, ValueError) as exc:
            raise HotStateUnavailable("payload_unreadable",
                                      "%s: %s" % (relpath, exc))
        if not extra:
            extra = man.get("extra") or {}
        for ent in man.get("shards", ()):
            shape = [int(e) for _s, e in ent["index"]]
            prev = specs.get(ent["leaf"])
            specs[ent["leaf"]] = (shape, ent["dtype"]) if prev is None \
                else ([max(a, b) for a, b in zip(prev[0], shape)],
                      prev[1])
    out = {leaf: _np.zeros(shape, dtype=_np.dtype(dt))
           for leaf, (shape, dt) in specs.items()}
    masks = {leaf: _np.zeros(a.shape, dtype=bool)
             for leaf, a in out.items()}
    # pass 2 — CRC-verified array reads, rank order, until every leaf
    # is covered (replicated state loads exactly one payload)
    n_read = 0
    for _src_rank, relpath in sources:
        if n_read and all(m.all() for m in masks.values()):
            break               # fully covered; skip the remaining reads
        man, arrays = _read_payload(root, relpath, rank)
        n_read += 1
        for ent in man.get("shards", ()):
            idx = tuple(slice(s, e) for s, e in ent["index"])
            out[ent["leaf"]][idx] = arrays[ent["key"]].reshape(
                [e - s for s, e in ent["index"]])
            masks[ent["leaf"]][idx] = True
    for leaf, mask in masks.items():
        if not mask.all():
            raise HotStateUnavailable(
                "missing_coverage",
                "leaf %s: %d of %d elements unserved after %d payloads"
                % (leaf, int((~mask).sum()), mask.size, n_read))
    meta = {"step": int(verdict["step"]), "n_payloads": n_read,
            "n_buddy": verdict.get("n_buddy"),
            "bytes": int(sum(a.nbytes for a in out.values())),
            "extra": extra}
    if abstract_tree is None:
        return _unflatten(out), meta["step"], meta
    from ..parallel.ckpt import _leaf_specs, _unflatten_like
    want = _leaf_specs(dict(abstract_tree))
    mismatch = []
    for leaf in sorted(set(want) | set(out)):
        got = out.get(leaf)
        spec = want.get(leaf)
        if got is None or spec is None:
            mismatch.append("%s: %s" % (leaf, "absent in payload"
                                        if got is None else
                                        "absent in target"))
        elif tuple(got.shape) != spec[0] or got.dtype != spec[1]:
            mismatch.append("%s: payload %s/%s target %s/%s"
                            % (leaf, got.shape, got.dtype,
                               spec[0], spec[1]))
    if mismatch:
        raise HotStateUnavailable("target_mismatch",
                                  "; ".join(mismatch[:8]))
    return _unflatten_like(dict(abstract_tree), out), meta["step"], meta


def warm_resume(abstract_tree=None, kv=None, namespace="train",
                round_id="resume"):
    """The whole warm rung in one call: agree the shard directory
    (over ``kv`` when it spans several workers, locally otherwise),
    assemble, and
    return ``(host_tree, step, meta)``.  Raises
    :class:`HotStateUnavailable` (stable ``reason``) on every
    degradation — never returns a partial tree.
    """
    from ..observability import spans as _spans
    if not warm_enabled():
        raise HotStateUnavailable("disabled")
    with _spans.span("warm_resume"):
        if kv is not None and getattr(kv, "num_workers", 1) > 1:
            verdict = agree_warm_sources(kv, round_id=round_id,
                                         namespace=namespace)
        else:
            verdict = decide_sources(namespace)
        if verdict.get("mode") != "warm":
            raise HotStateUnavailable("cold_verdict",
                                      verdict.get("reason") or "")
        return load_sources(verdict, abstract_tree, namespace=namespace)
