"""Locate / build / load the native library (lib/libmxtpu.so).

The port's copy of ``mxnet_tpu/libinfo.py``: the same library, built
from the repo's ``src/engine.cc``, ``src/recordio.cc`` and
``src/image.cc`` by the ``Makefile``'s default target at first use, at
the same path, so both packages run one binary.  It carries the host
side of the image feed (the dependency engine that is the decode pool,
the RecordIO reader/writer, the libjpeg decode+augment kernel); every
consumer has a pure-python fallback, so a missing compiler degrades
speed, not capability.  ``MXTPU_NO_NATIVE=1`` turns it off.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_LIB = None
_TRIED = False
_LOCK = threading.Lock()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_ROOT, "lib", "libmxtpu.so")


def _try_build(only_if_missing=False):
    """Best-effort `make` of the native lib (once per process), under a
    file lock: processes of the port that start together (test workers)
    take turns, and none loads a library another is still linking.
    ``only_if_missing``: build only when the library is absent once the
    lock is held.  True when the library exists afterwards."""
    import shutil
    try:
        import fcntl
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        with open(_LIB_PATH + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if only_if_missing and os.path.exists(_LIB_PATH):
                return True
            if shutil.which("make") is None or shutil.which("g++") is None:
                return os.path.exists(_LIB_PATH)
            subprocess.run(["make", "-s", "-C", _ROOT],
                           check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def find_lib(build=True):
    """Return a loaded ctypes CDLL or None.

    MXTPU_NO_NATIVE=1 disables the native path entirely (load AND build) —
    checked on every call so the kill-switch works even after the lib was
    loaded earlier in the process.
    """
    global _LIB, _TRIED
    if os.environ.get("MXTPU_NO_NATIVE"):
        return None
    with _LOCK:
        return _find_lib_locked(build)


def _find_lib_locked(build):
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if build and not _try_build(only_if_missing=True):
        import shutil
        if shutil.which("make") and shutil.which("g++"):
            import warnings
            warnings.warn("mxnet_tpu_torch: native library build failed; "
                          "falling back to pure-python engine/recordio "
                          "(run `make` in %s for details)" % _ROOT)
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    # a stale .so from an older checkout may miss newer symbols: rebuild
    # once, and if still incomplete fall back to pure python rather than
    # crash with AttributeError at first use
    if not hasattr(lib, "MXTPUEngineShutdown"):
        rebuilt = False
        import shutil
        if build and shutil.which("make") and shutil.which("g++"):
            rebuilt = _try_build()
        if rebuilt:
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                return None
        if not hasattr(lib, "MXTPUEngineShutdown"):
            import warnings
            warnings.warn("mxnet_tpu_torch: lib/libmxtpu.so is stale (missing "
                          "MXTPUEngineShutdown); run `make` to rebuild — "
                          "using the pure-python fallback")
            return None

    lib.MXTPUEngineCreate.restype = ctypes.c_void_p
    lib.MXTPUEngineCreate.argtypes = [ctypes.c_int]
    lib.MXTPUEngineFree.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineShutdown.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineNewVar.restype = ctypes.c_uint64
    lib.MXTPUEngineNewVar.argtypes = [ctypes.c_void_p]
    lib.MXTPUEnginePush.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.MXTPUEngineWaitForVar.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.MXTPUEngineWaitForAll.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineDeleteVar.argtypes = [ctypes.c_void_p, ctypes.c_uint64]

    lib.MXTPURecordIOWriterCreate.restype = ctypes.c_void_p
    lib.MXTPURecordIOWriterCreate.argtypes = [ctypes.c_char_p]
    lib.MXTPURecordIOWriterWrite.restype = ctypes.c_int
    lib.MXTPURecordIOWriterWrite.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.MXTPURecordIOWriterTell.restype = ctypes.c_long
    lib.MXTPURecordIOWriterTell.argtypes = [ctypes.c_void_p]
    lib.MXTPURecordIOWriterFree.restype = ctypes.c_int
    lib.MXTPURecordIOWriterFree.argtypes = [ctypes.c_void_p]
    lib.MXTPURecordIOReaderCreate.restype = ctypes.c_void_p
    lib.MXTPURecordIOReaderCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
    lib.MXTPURecordIOReaderNext.restype = ctypes.c_long
    lib.MXTPURecordIOReaderNext.argtypes = [ctypes.c_void_p]
    lib.MXTPURecordIOReaderSkip.restype = ctypes.c_int
    lib.MXTPURecordIOReaderSkip.argtypes = [ctypes.c_void_p]
    lib.MXTPURecordIOReaderData.restype = ctypes.POINTER(ctypes.c_char)
    lib.MXTPURecordIOReaderData.argtypes = [ctypes.c_void_p]
    lib.MXTPURecordIOReaderTell.restype = ctypes.c_long
    lib.MXTPURecordIOReaderTell.argtypes = [ctypes.c_void_p]
    lib.MXTPURecordIOReaderSeek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.MXTPURecordIOReaderFree.argtypes = [ctypes.c_void_p]

    lib.MXTPUDecodeAugment.restype = ctypes.c_int
    lib.MXTPUDecodeAugment.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,                  # img, len
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # tc, th, tw
        ctypes.c_int, ctypes.c_int,                        # rand_crop, mirror
        ctypes.c_float, ctypes.c_float,                    # scale_lo, scale_hi
        ctypes.c_uint32,                                   # seed
        ctypes.c_void_p, ctypes.c_void_p,                  # out_f32, out_u8
        ctypes.c_void_p, ctypes.c_float]                   # mean, scale

    _LIB = lib
    return _LIB


#: the port's C ABI library and the C programs built against it
CAPI_LIB_PATH = os.path.join(_ROOT, "lib", "libmxtpu_torch_capi.so")
CAPI_BIN_DIR = os.path.join(_ROOT, "lib", "torch")


class CapiBuildError(RuntimeError):
    """``make capi-torch`` failed; ``missing_python_headers`` says
    whether it failed for want of ``Python.h``."""

    def __init__(self, message, missing_python_headers=False):
        super().__init__(message)
        self.missing_python_headers = missing_python_headers


def build_capi(timeout=600):
    """``make capi-torch``: the port's C ABI library
    (``lib/libmxtpu_torch_capi.so``, ``mxnet_tpu_torch/csrc/c_api.cc``)
    and the C programs linked against it under ``lib/torch/``, under the
    file lock ``lib/libmxtpu_torch_capi.so.lock``, so processes that
    start together take turns.  Returns ``CAPI_BIN_DIR``; a failed build
    raises :class:`CapiBuildError` with make's output."""
    import fcntl
    import shutil
    for tool in ("make", "g++", "cc"):
        if shutil.which(tool) is None:
            raise CapiBuildError("no %s to build the C ABI" % tool)
    os.makedirs(os.path.dirname(CAPI_LIB_PATH), exist_ok=True)
    with open(CAPI_LIB_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        out = subprocess.run(["make", "-s", "-j4", "-C", _ROOT, "capi-torch"],
                             capture_output=True, text=True,
                             timeout=timeout)
    if out.returncode != 0:
        text = (out.stdout + out.stderr)[-4000:]
        raise CapiBuildError("make capi-torch failed:\n" + text,
                             missing_python_headers="Python.h" in text)
    return CAPI_BIN_DIR
