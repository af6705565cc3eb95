"""Build and load the port's CUDA kernels.

Each source under ``mxnet_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and
loaded with ``ctypes``.  The build happens at first use, into
``build/mxnet_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``); a library's file name carries a hash of its source, so
an edited source is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per missing library, all at once.

Nothing here runs at import time: the CPU tests import every module of
the port on machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "library", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")

#: kernel name -> CUDA source under csrc/
SOURCES = {
    "flash_decode": "flash_decode.cu",
    "quantized_matmul": "quantized_matmul.cu",
    "flash_attention": "flash_attention.cu",
    "fused_opt": "fused_opt.cu",
}

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS = {}          # name -> ctypes.CDLL, loaded once per process
#: name -> {"seconds": build time or 0.0 when cached, "log": nvcc output}
BUILD_INFO = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (looked in %s and on PATH): the "
                         "CUDA kernels cannot be built" % path)
    return found


def _lib_path(name):
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "%s-%s.so" % (name,
                                                       digest.hexdigest()[:16]))


def _declare(lib, name):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_decode":
        fn, args = lib.mxtt_flash_decode, [i, i, vp, vp, vp, vp, vp, vp,
                                           i, i, i, i, i, f, vp]
    elif name == "quantized_matmul":
        fn, args = lib.mxtt_quantized_matmul, [i, vp, vp, vp, vp, i, i, i, vp]
    elif name == "flash_attention":
        fn, args = lib.mxtt_flash_attention_forward, [i, vp, vp, vp, vp, vp,
                                                      i, i, i, i, i, f, vp]
    else:
        fn, args = lib.mxtt_fused_opt_sweep, ([i, vp, vp, vp, vp,
                                               ctypes.c_longlong]
                                              + [f] * 11 + [vp])
    fn.argtypes = args
    fn.restype = i
    lib.mxtt_error_string.argtypes = [i]
    lib.mxtt_error_string.restype = ctypes.c_char_p
    return lib


def build_all():
    """Compile every missing kernel library (one ``nvcc`` per source,
    started together) and load all of them.  Returns ``BUILD_INFO``."""
    with _LOCK:
        pending = [n for n in SOURCES if n not in _LIBS]
        procs = {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        for name in pending:
            src, out = _lib_path(name)
            if os.path.exists(out):
                BUILD_INFO[name] = {"seconds": 0.0, "log": "cached"}
                continue
            tmp = "%s.%d.tmp.so" % (out[:-3], os.getpid())
            procs[name] = (subprocess.Popen(
                [_nvcc()] + _NVCC_FLAGS + ["-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                "log": log}
            if proc.returncode != 0:
                failed.append("%s (nvcc exit %d):\n%s"
                              % (name, proc.returncode, log))
            else:
                os.replace(tmp, out)
        if failed:
            raise MXNetError("kernel build failed: " + "\n".join(failed))
        for name in pending:
            _LIBS[name] = _declare(ctypes.CDLL(_lib_path(name)[1]), name)
    return BUILD_INFO


def library(name):
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


def check(lib, code, what):
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise MXNetError("%s launch failed: CUDA error %d (%s)"
                         % (what, code,
                            lib.mxtt_error_string(code).decode()))
