"""Deterministic fault injection for the resilience test matrix.

The port's copy of ``mxnet_tpu/resilience/faultinject.py``; the process
index of a fault's ``rank=`` comes from
:func:`mxnet_tpu_torch.observability.events.rank`.  Of its seams the
port passes through ``serve_dispatch`` (the batcher's launch) and
``swap_install`` (``ModelServer.swap_params``).

Every recovery path in this package is only trustworthy if it can be
*exercised*, and the real failures (preemption mid-save, a wedged
collective, a bf16 overflow ten thousand steps in) are precisely the
ones a CPU dev box never produces on its own.  This module plants them
on demand at the seams the runtime already passes through:

- ``batch`` — trainer step input (kind ``nan``: poison the batch so
  the backward pass yields NaN gradients)
- ``step`` — trainer step dispatch (kinds ``hang``/``slow``: sleep)
- ``ckpt_write`` / ``ckpt_commit`` — checkpoint save, before the tmp
  write / between tmp write and the commit rename (kind
  ``ckpt_crash``: raise :class:`InjectedFault`, the preemption analog)
- ``dead_node`` — kvstore liveness scan (kind ``dead_node``: report
  ``n`` peers dead without any real process dying)
- ``host_snapshot`` — hot-state host offload, before any payload is
  written (kind ``snapshot_crash``: raise :class:`InjectedFault`, the
  preemption-mid-offload analog; the warm path must degrade to the
  checkpoint, never wedge the re-mesh)
- ``handoff_read`` — hot-state warm resume, per payload read (kind
  ``corrupt``: flip the payload bytes after load so the CRC check
  rejects it — the drillable half of "corrupt shard -> CRC reject ->
  checkpoint fallback")
- ``buddy_loss`` — hot-state snapshot, before the ring-buddy replica
  writes (kind ``buddy_loss``: skip them, simulating a lost replica
  push; a later host loss then has no redundant copy to serve)
- ``replica_death`` — fleet serving replica, request path (kind
  ``replica_death``: returned to the replica wrapper, which hard-kills
  its own process mid-request — the router must fail over, never hang
  the client's future)
- ``swap_install`` — live weight hot-swap, between building the new
  per-bucket Predictors and installing them (kind ``swap_crash``:
  raise :class:`InjectedFault`; the old param version must keep
  serving — a failed swap is a no-op, not an outage)
- ``kv_op`` — every ``ResilientKV`` operation (kinds ``kv_partition``:
  fail every op for ``seconds``, default 5; ``kv_flap``: alternate
  fail/ok per call; ``kv_slow``: sleep ``seconds`` before the op) —
  the coordination-plane outages behind the KV fault discipline
  (docs/resilience.md): a blip must hold the last liveness verdict,
  never fabricate deaths
- ``router_death`` — fleet router health tick (kind ``router_death``:
  returned to the router, which hard-kills its own process — the
  drillable half of "standby takes over within one lease period")

Faults are described by ``MXTPU_FAULT_SPEC``, a ``;``-separated list
of ``:``-separated ``key=value`` clauses (docs/resilience.md):

    MXTPU_FAULT_SPEC="step=7:kind=nan"
    MXTPU_FAULT_SPEC="step=3:kind=hang:seconds=60;step=9:kind=ckpt_crash"
    MXTPU_FAULT_SPEC="kind=dead_node:n=2:rank=0"

``step`` matches the trainer's update counter (omit to fire at the
first visit to the seam); ``rank`` restricts to one worker; each spec
fires **once** unless ``sticky=1``.  The injector is deterministic —
no randomness, no wall clock — so a failing matrix case replays
exactly.
"""
from __future__ import annotations

import os as _os
import time as _time

ENV_VAR = "MXTPU_FAULT_SPEC"

#: default seam for each fault kind (spec may override with ``seam=``)
KIND_SEAMS = {
    "nan": "batch",
    "hang": "step",
    "slow": "step",
    "ckpt_crash": "ckpt_commit",
    "crash": "ckpt_commit",
    "dead_node": "dead_node",
    "snapshot_crash": "host_snapshot",
    "corrupt": "handoff_read",
    "buddy_loss": "buddy_loss",
    "replica_death": "replica_death",
    "swap_crash": "swap_install",
    "kv_partition": "kv_op",
    "kv_slow": "kv_op",
    "kv_flap": "kv_op",
    "router_death": "router_death",
}

_KNOWN_KINDS = frozenset(KIND_SEAMS)


class InjectedFault(RuntimeError):
    """Raised at a seam to simulate a crash/preemption at that point."""


class FaultSpec(object):
    """One parsed fault clause."""

    __slots__ = ("kind", "seam", "step", "rank", "seconds", "n",
                 "sticky", "fired")

    def __init__(self, kind, seam=None, step=None, rank=None,
                 seconds=None, n=1, sticky=False):
        if kind not in _KNOWN_KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, sorted(_KNOWN_KINDS)))
        self.kind = kind
        self.seam = seam or KIND_SEAMS[kind]
        self.step = step
        self.rank = rank
        self.seconds = seconds
        self.n = n
        self.sticky = sticky
        self.fired = False

    def matches(self, seam, step=None, rank=None):
        if self.fired and not self.sticky:
            return False
        if seam != self.seam:
            return False
        if self.step is not None and step is not None \
                and int(step) != self.step:
            return False
        if self.step is not None and step is None:
            return False
        if self.rank is not None and rank is not None \
                and int(rank) != self.rank:
            return False
        return True

    def __repr__(self):
        return ("FaultSpec(kind=%r, seam=%r, step=%r, rank=%r, "
                "seconds=%r, n=%r)" % (self.kind, self.seam, self.step,
                                       self.rank, self.seconds, self.n))


def parse_fault_spec(text):
    """Parse a ``MXTPU_FAULT_SPEC`` string into a list of FaultSpec."""
    specs = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        fields = {}
        for pair in clause.split(":"):
            if "=" not in pair:
                raise ValueError("bad fault clause %r (want key=value)"
                                 % clause)
            key, _, val = pair.partition("=")
            fields[key.strip()] = val.strip()
        kind = fields.pop("kind", None)
        if kind is None:
            raise ValueError("fault clause %r has no kind=" % clause)
        spec = FaultSpec(
            kind,
            seam=fields.pop("seam", None),
            step=int(fields["step"]) if "step" in fields else None,
            rank=int(fields["rank"]) if "rank" in fields else None,
            seconds=float(fields["seconds"]) if "seconds" in fields
            else None,
            n=int(fields.pop("n", 1)),
            sticky=fields.pop("sticky", "0") not in ("", "0", "false"))
        for consumed in ("step", "rank", "seconds"):
            fields.pop(consumed, None)
        if fields:
            raise ValueError("unknown fault keys %s in %r"
                             % (sorted(fields), clause))
        specs.append(spec)
    return specs


class FaultInjector(object):
    """Holds parsed specs; hands each out once (unless sticky)."""

    def __init__(self, specs):
        self.specs = list(specs)

    def match(self, seam, step=None, rank=None):
        for spec in self.specs:
            if spec.matches(seam, step=step, rank=rank):
                spec.fired = True
                return spec
        return None


# process-global injector, cached against the env string so a changed
# spec (tests monkeypatching the env) rebuilds it while a stable one
# keeps per-spec fired state across calls
_CACHE = {"text": None, "injector": None}


def injector():
    """The process injector for the current env spec, or None."""
    text = _os.environ.get(ENV_VAR)
    if not text:
        if _CACHE["text"] is not None:
            _CACHE["text"] = None
            _CACHE["injector"] = None
        return None
    if text != _CACHE["text"]:
        _CACHE["text"] = text
        _CACHE["injector"] = FaultInjector(parse_fault_spec(text))
    return _CACHE["injector"]


def reset():
    """Testing hook: forget the cached injector (re-arm all specs)."""
    _CACHE["text"] = None
    _CACHE["injector"] = None


def _current_rank():
    from ..observability.events import rank
    return rank()


def maybe_fault(seam, step=None, rank=None):
    """Fire a matching fault at this seam, if any.

    Side effects by kind: ``ckpt_crash``/``crash``/``snapshot_crash``/
    ``swap_crash`` raise :class:`InjectedFault`; ``hang``/``slow``/
    ``kv_slow`` sleep (``seconds``, defaulting to 3600 for hang / 1
    otherwise).  Kinds the caller must act on itself (``nan``,
    ``dead_node``, ``corrupt``, ``buddy_loss``, ``replica_death``,
    ``kv_partition``, ``kv_flap``, ``router_death``) are returned.
    Returns the spec that fired, or None.  Near-zero cost when no spec
    is set.
    """
    inj = injector()
    if inj is None:
        return None
    if rank is None:
        rank = _current_rank()
    spec = inj.match(seam, step=step, rank=rank)
    if spec is None:
        return None
    if spec.kind in ("ckpt_crash", "crash", "snapshot_crash",
                     "swap_crash"):
        raise InjectedFault(
            "injected %s at seam=%s step=%s" % (spec.kind, seam, step))
    if spec.kind in ("hang", "slow", "kv_slow"):
        _time.sleep(spec.seconds if spec.seconds is not None
                    else (3600.0 if spec.kind == "hang" else 1.0))
    return spec


def poison_nan(array):
    """Return an all-NaN array like ``array`` (numpy or a tensor);
    integer arrays pass through.  Multiplying by NaN keeps shape, dtype
    and device, so the poisoned batch flows through a step exactly as a
    real numerically-corrupt batch would."""
    import numpy as _np
    if hasattr(array, "is_floating_point"):
        floating = array.is_floating_point()
    else:
        floating = not hasattr(array, "dtype") or _np.issubdtype(
            _np.dtype(array.dtype), _np.floating)
    return array * float("nan") if floating else array
