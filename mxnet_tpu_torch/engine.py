"""Dependency engine: host-side async scheduler with var read/write sets.

The port's copy of ``mxnet_tpu/engine.py`` (parity:
include/mxnet/engine.h:74 + src/engine/).  The device's schedule is
PyTorch's streams; this engine orders *host-side* work (the image
decode pool of ``io.ImageRecordIter``) and provides the reference's
engine API surface (NewVariable/Push/WaitForVar/WaitForAll).

Engines (selected by MXNET_ENGINE_TYPE, parity engine.cc:13-39):
- ``ThreadedEngine``  — the native C++ var-queue engine (src/engine.cc),
  loaded via ctypes.  Ops run on a worker pool; callbacks re-enter python
  holding the GIL only for the op body.
- ``NaiveEngine``     — synchronous, for debugging (naive_engine.cc:14).
The factory falls back to Naive when the native library is unavailable.
"""
from __future__ import annotations

import atexit
import ctypes
import os
import threading
import weakref

from .base import MXNetError

__all__ = ["Engine", "NaiveEngine", "ThreadedEngine", "get", "create"]

_ENGINE_FN_TYPE = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class Engine(object):
    """Interface (engine.h:74)."""

    def new_variable(self):
        raise NotImplementedError

    def push(self, fn, const_vars=(), mutable_vars=()):
        raise NotImplementedError

    def wait_for_var(self, var):
        raise NotImplementedError

    def wait_for_all(self):
        raise NotImplementedError

    def delete_variable(self, var):
        raise NotImplementedError


class NaiveEngine(Engine):
    """Synchronous debug engine (naive_engine.cc:14): push == run."""

    def __init__(self):
        self._next = 1

    def new_variable(self):
        v = self._next
        self._next += 1
        return v

    def push(self, fn, const_vars=(), mutable_vars=()):
        fn()

    def wait_for_var(self, var):
        pass

    def wait_for_all(self):
        pass

    def delete_variable(self, var):
        pass


class ThreadedEngine(Engine):
    """ctypes facade over the native var-queue engine (src/engine.cc)."""

    def __init__(self, num_threads=None):
        from .libinfo import find_lib
        lib = find_lib()
        if lib is None:
            raise MXNetError("native engine unavailable (lib/libmxtpu.so "
                             "missing and build failed)")
        self._lib = lib
        if num_threads is None:
            num_threads = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS",
                                             "4"))
        self._h = lib.MXTPUEngineCreate(num_threads)
        # keep callbacks alive until they run; keyed by token
        self._cbs = {}
        self._cb_lock = threading.Lock()
        self._next_token = [1]
        # first exception raised by any pushed fn; ctypes swallows
        # exceptions escaping into the native worker thread (prints and
        # returns), so record it here and re-raise from wait_* — the
        # analog of the reference engine aborting on op error.
        self._first_exc = None

        def _trampoline(token):
            with self._cb_lock:
                fn = self._cbs.pop(token)
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001
                with self._cb_lock:
                    if self._first_exc is None:
                        self._first_exc = exc

        self._tramp = _ENGINE_FN_TYPE(
            lambda token: _trampoline(int(token)))
        self._closed = False
        _LIVE_ENGINES.add(self)

    def _reraise(self):
        with self._cb_lock:
            exc, self._first_exc = self._first_exc, None
        if exc is not None:
            raise exc

    def new_variable(self):
        return self._lib.MXTPUEngineNewVar(self._h)

    def push(self, fn, const_vars=(), mutable_vars=()):
        mutable = list(dict.fromkeys(mutable_vars))
        # dedup: a var that is written must not also appear as a read
        # (the reference dedups in Push, threaded_engine.cc:255)
        const = [v for v in dict.fromkeys(const_vars) if v not in mutable]
        with self._cb_lock:
            token = self._next_token[0]
            self._next_token[0] += 1
            self._cbs[token] = fn
        # a drained engine (close()/atexit) runs this push INLINE on the
        # calling thread, native-side — no handle race, no lock held
        # around user code (Engine::Shutdown in src/engine.cc)
        n_c, n_m = len(const), len(mutable)
        c_arr = (ctypes.c_uint64 * max(n_c, 1))(*const)
        m_arr = (ctypes.c_uint64 * max(n_m, 1))(*mutable)
        self._lib.MXTPUEnginePush(self._h, self._tramp,
                                  ctypes.c_void_p(token), c_arr, n_c,
                                  m_arr, n_m)

    def wait_for_var(self, var):
        self._lib.MXTPUEngineWaitForVar(self._h, var)
        self._reraise()

    def wait_for_all(self):
        self._lib.MXTPUEngineWaitForAll(self._h)
        self._reraise()

    def delete_variable(self, var):
        self._lib.MXTPUEngineDeleteVar(self._h, var)

    def close(self):
        """Drain pending work and join the native workers (the handle
        stays alive; later pushes run inline native-side).  Called from
        the atexit hook while the interpreter is still healthy: worker
        threads run Python callbacks, so letting them survive into
        interpreter FINALIZATION aborts the process (ctypes callback
        into a dying interpreter -> std::terminate)."""
        with self._cb_lock:
            if self._closed:
                return
            self._closed = True
        h = getattr(self, "_h", None)
        if h:
            self._lib.MXTPUEngineShutdown(h)

    def __del__(self):
        try:
            self.close()
            # free only during normal runtime: at interpreter exit the
            # drained handle is deliberately leaked (straggler daemon
            # threads may still inline-push through it)
            import sys
            if not sys.is_finalizing():
                h, self._h = getattr(self, "_h", None), None
                if h:
                    self._lib.MXTPUEngineFree(h)
        except Exception:
            pass


_ENGINE = None
_ENGINE_LOCK = threading.Lock()
_LIVE_ENGINES = weakref.WeakSet()


@atexit.register
def _close_live_engines():
    """Drain every native engine before interpreter teardown begins —
    after this, late GC of engines is a no-op (see ThreadedEngine.close)."""
    for eng in list(_LIVE_ENGINES):
        try:
            eng.close()
        except Exception:
            pass


def create(engine_type=None, num_threads=None):
    """Factory (parity engine.cc:13-39 CreateEngine)."""
    engine_type = engine_type or os.environ.get("MXNET_ENGINE_TYPE",
                                                "ThreadedEngine")
    if engine_type == "NaiveEngine":
        return NaiveEngine()
    try:
        return ThreadedEngine(num_threads)
    except MXNetError:
        return NaiveEngine()


def get():
    """Process singleton (parity Engine::Get)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = create()
        return _ENGINE
