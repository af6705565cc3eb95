"""Runtime lock-discipline sanitizer (``MXTPU_LOCKCHECK=1``).

The port's copy of ``mxnet_tpu/observability/locktrace.py``.  One
change: :func:`install` chains over the ``threading.Lock``/``RLock``
factories it finds (which may already be another sanitizer's, such as
the JAX package's in a test run that installed it first): its traced
locks wrap locks made by those factories, and :func:`uninstall`
restores them, not the interpreter's originals.  A lock-order inversion
raises :class:`~mxnet_tpu_torch.resilience.ResilienceError`.

The live witness for the static MXL-Q002 lock-order lint
(``analysis/concurrency.py``): a test-mode monkeypatch of
``threading.Lock`` / ``threading.RLock`` that records, per thread, the
stack of locks currently held and where each was acquired.  Whenever a
thread acquires lock B while holding lock A, the (A before B) edge is
added to a process-global order graph; if the graph already contains
(B before A) — observed on any thread, at any earlier point in the
run — the acquisition raises a structured
``ResilienceError(kind="lock_order")`` naming both acquisition sites,
instead of letting the suites deadlock-or-pass by scheduling luck.

This catches *potential* deadlocks: the two opposing acquisitions never
have to interleave in the failing run, they only both have to happen.
That is exactly what a CI suite can provide — serving and resilience
tests exercise each code path once, the graph remembers.

Scope and honesty:

- Only locks **created after** :func:`install` are traced (the factory
  is patched, not existing objects): install before the runtime state
  you want traced is built (a server, a batcher).
- ``threading.Condition`` cooperates for free: it delegates
  acquire/release to the wrapped lock, and ``wait()`` releases through
  the same traced methods, so a held-then-waited condition does not
  pin its edge.
- Re-acquiring an already-held traced RLock adds no edge (reentrancy
  is not an order).
- The order graph keys locks by **creation site** (``file:line``), not
  object identity: a thousand per-request locks born on one line are
  one node, which is also the right granularity for reporting.

Enable with ``MXTPU_LOCKCHECK=1`` (CI does, for the serving and
resilience suites); :func:`maybe_install` is the env-gated entry.
"""
from __future__ import annotations

import os
import sys
import threading
import traceback
import _thread

__all__ = ["install", "uninstall", "installed", "maybe_install",
           "order_edges", "reset_order_graph", "TracedLock",
           "TracedRLock"]

#: the factories the traced locks wrap and :func:`uninstall` restores:
#: the interpreter's at import, whatever :func:`install` found after
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

# native (untraced) leaf lock guarding the order graph itself
_GRAPH_LOCK = _thread.allocate_lock()
_EDGES = {}          # (site_a, site_b) -> (stack_a, stack_b) summaries
_INSTALLED = False

_TLS = threading.local()     # .held: list of (site, summary)


def _caller_site(depth=2):
    """file:line of the frame that called into the traced lock."""
    frame = sys._getframe(depth)
    # skip our own module frames (e.g. Condition delegating through us)
    while frame is not None and frame.f_globals.get("__name__") == \
            __name__:
        frame = frame.f_back
    if frame is None:
        return "<unknown>", "<unknown>"
    here = "%s:%d" % (frame.f_code.co_filename, frame.f_lineno)
    summary = "".join(traceback.format_stack(frame, limit=4))
    return here, summary


def _held_stack():
    held = getattr(_TLS, "held", None)
    if held is None:
        held = []
        _TLS.held = held
    return held


def _lock_order_error(site_a, site_b, stack_b, prior):
    from ..resilience import ResilienceError
    prior_a, prior_b = prior
    msg = (
        "lock-order inversion: this thread holds the lock from %s and "
        "is acquiring the lock from %s, but the opposite order was "
        "already observed in this process (MXL-Q002's runtime "
        "witness).\n--- this acquisition (%s while holding %s):\n%s"
        "--- prior opposite-order acquisition (%s while holding %s):\n%s"
        % (site_a, site_b, site_b, site_a, stack_b,
           site_a, site_b, prior_b))
    return ResilienceError(msg, phase="lockcheck", kind="lock_order")


class _TracedBase(object):
    """Shared acquire/release bookkeeping for traced Lock/RLock."""

    def __init__(self):
        site, _ = _caller_site(depth=3)
        self._mxtpu_site = site

    # -- the discipline check -----------------------------------------
    def _note_acquired(self, blocking=True):
        held = _held_stack()
        me = self._mxtpu_site
        if any(site is me or site == me for site, _s in held):
            # reentrant / same-site nesting: not an order
            held.append((me, ""))
            return
        _, summary = _caller_site(depth=3)
        err = None
        with _GRAPH_LOCK:
            for site_a, stack_a in held:
                if site_a == me:
                    continue
                key = (site_a, me)
                rev = (me, site_a)
                if rev in _EDGES and key not in _EDGES:
                    err = _lock_order_error(site_a, me, summary,
                                            _EDGES[rev])
                    break
                _EDGES.setdefault(key, (stack_a, summary))
        if err is not None:
            self._unlock_raw()
            raise err
        held.append((me, summary))

    def _note_released(self):
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self._mxtpu_site:
                del held[i]
                return

    def _at_fork_reinit(self):
        # stdlib (concurrent.futures, logging) reinits its module locks
        # in the forked child through this hook
        self._lock._at_fork_reinit()


class TracedLock(_TracedBase):
    """Drop-in for ``threading.Lock()`` with order tracing."""

    def __init__(self):
        _TracedBase.__init__(self)
        self._lock = _ORIG_LOCK()

    def acquire(self, blocking=True, timeout=-1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self):
        self._note_released()
        self._lock.release()

    def _unlock_raw(self):
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "<TracedLock %s %r>" % (
            "locked" if self._lock.locked() else "unlocked",
            self._mxtpu_site)


class TracedRLock(_TracedBase):
    """Drop-in for ``threading.RLock()`` with order tracing.  Keeps the
    underscore protocol (``_is_owned`` etc.) so ``threading.Condition``
    waits release/reacquire through the traced path."""

    def __init__(self):
        _TracedBase.__init__(self)
        self._lock = _ORIG_RLOCK()

    def acquire(self, blocking=True, timeout=-1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self):
        self._note_released()
        self._lock.release()

    def _unlock_raw(self):
        self._lock.release()

    # Condition integration: delegate the underscore protocol but keep
    # our bookkeeping consistent across wait()'s release/reacquire.
    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        self._note_released()
        return self._lock._release_save()

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        self._note_acquired()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "<TracedRLock %r>" % (self._mxtpu_site,)


def install():
    """Patch ``threading.Lock``/``RLock`` factories with the traced
    versions, over the factories found there.  Idempotent."""
    global _INSTALLED, _ORIG_LOCK, _ORIG_RLOCK
    if _INSTALLED:
        return
    _ORIG_LOCK = threading.Lock
    _ORIG_RLOCK = threading.RLock
    threading.Lock = TracedLock
    threading.RLock = TracedRLock
    _INSTALLED = True


def uninstall():
    """Restore the factories :func:`install` found (existing traced
    locks keep working — they wrap real locks)."""
    global _INSTALLED
    if not _INSTALLED:
        return
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    _INSTALLED = False


def installed():
    return _INSTALLED


def maybe_install(env=os.environ):
    """Install iff ``MXTPU_LOCKCHECK=1`` (the CI hook)."""
    if str(env.get("MXTPU_LOCKCHECK", "")).strip().lower() in \
            ("1", "true", "yes", "on"):
        install()
        return True
    return False


def order_edges():
    """Snapshot of the observed (A before B) site pairs."""
    with _GRAPH_LOCK:
        return sorted(_EDGES)


def reset_order_graph():
    """Forget observed edges + this thread's held stack (tests)."""
    with _GRAPH_LOCK:
        _EDGES.clear()
    _TLS.held = []
