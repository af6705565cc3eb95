"""Runtime retrace sentry (``MXTPU_RETRACE_SENTRY=1``).

The port of ``mxnet_tpu/observability/retrace.py``: a test-mode
monkeypatch of ``parallel.overlap.note_lowering`` (one count per
program build) and the program registry's lookup
(``executor._lookup_program(symbol, device)``) that counts -- and
*attributes* -- every lowering after a serving warmup boundary.  The
zero-steady-state-lowerings contract says that number is zero; when it
is not, the sentry names *why*: it remembers the cache-key components of
every registry lookup and, on an unexpected lowering, diffs the incoming
components against the closest previously-seen key and reports the
divergent ingredient in a structured ``retrace`` telemetry event (and
therefore the flight recorder, since every emit passes through it).

The components are the port's registry key (``executor._lookup_program``):
``graph_fingerprint`` (the graph key), ``device``, ``compute_dtype``
(``MXNET_COMPUTE_DTYPE``) and the two mirroring envs
(``backward_do_mirror``, ``backward_mirror_step``).  A bucket bypass shows
up as ``graph_fingerprint`` divergence; an env flip mid-serve as
``compute_dtype``; a lowering that never went through the registry is
attributed ``outside_program_registry`` with the calling site.

Lifecycle -- mirrors how serving warms up:

- :func:`warmup_begin` disarms the sentry: a legitimate compile phase
  (model add, generation warmup) is starting.
- :func:`warmup_boundary` arms it: steady state begins, every lowering
  from here on is a contract violation.

The sentry never raises: callers read :func:`stats`.  Enable with
``MXTPU_RETRACE_SENTRY=1`` through :func:`maybe_install`, or call
:func:`install`.
"""
from __future__ import annotations

import os
import sys
import threading

__all__ = ["install", "uninstall", "installed", "maybe_install",
           "warmup_begin", "warmup_boundary", "armed", "stats",
           "attributions", "reset"]

_LOCK = threading.Lock()
_INSTALLED = False
_ARMED = False
_ORIG_NOTE_LOWERING = None
_ORIG_LOOKUP_PROGRAM = None

#: component dicts of recently seen registry keys (bounded)
_SEEN = []
_SEEN_MAX = 64

#: attribution records for post-warmup lowerings (bounded)
_ATTRIBUTIONS = []
_ATTRIBUTIONS_MAX = 32

_COUNTS = {"retraces_after_warmup": 0, "lowerings_seen": 0}

_TLS = threading.local()     # .incoming: component dict of the lookup
                             # currently in flight on this thread


def _caller_site():
    """file:line of the nearest frame outside this module, the overlap
    counters and the registry lookup -- where the lowering was
    requested."""
    frame = sys._getframe(2)
    skip = (__name__, __package__.rsplit(".", 1)[0] + ".parallel.overlap")
    while frame is not None and (
            frame.f_globals.get("__name__") in skip
            or frame.f_code.co_name == "_lookup_program"):
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    return "%s:%d" % (frame.f_code.co_filename, frame.f_lineno)


def _components(symbol, device):
    """The cache-key ingredients of one registry lookup, stringly --
    exactly what a divergence must be blamed on."""
    from .. import executor as _executor
    try:
        gf = repr(_executor._graph_key(symbol))
        import hashlib
        gf = hashlib.sha256(gf.encode()).hexdigest()[:16]
    except Exception:
        gf = "<unfingerprintable>"
    return {
        "graph_fingerprint": gf,
        "device": str(device),
        "compute_dtype": os.environ.get("MXNET_COMPUTE_DTYPE", ""),
        "backward_do_mirror": os.environ.get("MXNET_BACKWARD_DO_MIRROR", ""),
        "backward_mirror_step": os.environ.get("MXNET_BACKWARD_MIRROR_STEP",
                                               ""),
    }


def _attribute(incoming):
    """Name the divergent cache-key ingredient(s): diff ``incoming``
    against the closest previously seen key (most matching
    components).  None incoming means the lowering never went through
    the program registry."""
    if incoming is None:
        return {"divergent": ["outside_program_registry"],
                "detail": {}}
    with _LOCK:
        seen = list(_SEEN)
    best, best_score = None, -1
    for prior in seen:
        if prior is incoming:
            continue
        score = sum(1 for k in incoming if prior.get(k) == incoming[k])
        if score > best_score:
            best, best_score = prior, score
    if best is None:
        return {"divergent": ["no_prior_key"], "detail": dict(incoming)}
    divergent = sorted(k for k in incoming
                       if best.get(k) != incoming[k])
    detail = {k: {"incoming": incoming[k], "closest_seen": best.get(k)}
              for k in divergent}
    return {"divergent": divergent or ["identical_key_relowered"],
            "detail": detail}


def _note_lowering_sentry(n=1):
    """Replacement for ``overlap.note_lowering``: count, and when
    armed, attribute + emit.  Never raises."""
    _ORIG_NOTE_LOWERING(n)
    try:
        incoming = getattr(_TLS, "incoming", None)
        site = _caller_site()
        with _LOCK:
            _COUNTS["lowerings_seen"] += n
            if not _ARMED:
                return
            _COUNTS["retraces_after_warmup"] += n
        attribution = _attribute(incoming)
        record = {"site": site,
                  "divergent": attribution["divergent"],
                  "detail": attribution["detail"]}
        with _LOCK:
            if len(_ATTRIBUTIONS) < _ATTRIBUTIONS_MAX:
                _ATTRIBUTIONS.append(record)
        from . import events as _events
        _events.emit("retrace", divergent=attribution["divergent"],
                     site=site, detail=attribution["detail"], n=n)
    except Exception:       # the sentry must never take serving down
        pass


def _lookup_program_sentry(symbol, device):
    """Replacement for ``executor._lookup_program``: remember the
    incoming key components so a lowering fired underneath can be
    diffed against every key seen before it."""
    try:
        incoming = _components(symbol, device)
    except Exception:
        incoming = None
    _TLS.incoming = incoming
    try:
        return _ORIG_LOOKUP_PROGRAM(symbol, device)
    finally:
        _TLS.incoming = None
        if incoming is not None:
            with _LOCK:
                if not any(p == incoming for p in _SEEN):
                    _SEEN.append(incoming)
                    if len(_SEEN) > _SEEN_MAX:
                        del _SEEN[0]


def install():
    """Patch the lowering counter and the registry lookup.  Idempotent."""
    global _INSTALLED, _ORIG_NOTE_LOWERING, _ORIG_LOOKUP_PROGRAM
    if _INSTALLED:
        return
    from ..parallel import overlap as _overlap
    from .. import executor as _executor
    _ORIG_NOTE_LOWERING = _overlap.note_lowering
    _ORIG_LOOKUP_PROGRAM = _executor._lookup_program
    _overlap.note_lowering = _note_lowering_sentry
    _executor._lookup_program = _lookup_program_sentry
    _INSTALLED = True


def uninstall():
    """Restore the originals and disarm."""
    global _INSTALLED, _ARMED
    if not _INSTALLED:
        return
    from ..parallel import overlap as _overlap
    from .. import executor as _executor
    _overlap.note_lowering = _ORIG_NOTE_LOWERING
    _executor._lookup_program = _ORIG_LOOKUP_PROGRAM
    _INSTALLED = False
    _ARMED = False


def installed():
    return _INSTALLED


def maybe_install(env=os.environ):
    """Install iff ``MXTPU_RETRACE_SENTRY=1``."""
    if str(env.get("MXTPU_RETRACE_SENTRY", "")).strip().lower() in \
            ("1", "true", "yes", "on"):
        install()
        return True
    return False


def warmup_begin():
    """A legitimate compile phase is starting (model add, generation
    warmup): disarm so its lowerings are not counted as retraces.  Safe
    no-op when the sentry is not installed."""
    global _ARMED
    with _LOCK:
        _ARMED = False


def warmup_boundary():
    """Steady state begins: arm the sentry -- every lowering from here
    on is counted and attributed.  Safe no-op when not installed."""
    global _ARMED
    if not _INSTALLED:
        return
    with _LOCK:
        _ARMED = True


def armed():
    return _ARMED


def stats():
    """{"installed", "armed", "retraces_after_warmup",
    "lowerings_seen", "attributions"}."""
    with _LOCK:
        return {"installed": _INSTALLED, "armed": _ARMED,
                "retraces_after_warmup":
                    _COUNTS["retraces_after_warmup"],
                "lowerings_seen": _COUNTS["lowerings_seen"],
                "attributions": [dict(a) for a in _ATTRIBUTIONS]}


def attributions():
    """The bounded attribution records (most recent run)."""
    with _LOCK:
        return [dict(a) for a in _ATTRIBUTIONS]


def reset():
    """Forget counters, seen keys and attributions; disarm (tests)."""
    global _ARMED
    with _LOCK:
        _ARMED = False
        _SEEN[:] = []
        _ATTRIBUTIONS[:] = []
        for k in _COUNTS:
            _COUNTS[k] = 0
