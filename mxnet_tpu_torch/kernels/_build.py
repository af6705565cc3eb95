"""Build and load the port's CUDA kernels.

Each source under ``mxnet_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and
loaded with ``ctypes``.  The build happens at first use, into
``build/mxnet_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``); a library's file name carries a hash of its source, of
every header under ``csrc/`` and of the flags, so an edited source or
shared header (``hopper.cuh``, ``wgmma.cuh``) is rebuilt and an
unchanged one is loaded as it is.  ``nvcc``'s output (with ``ptxas``'s
registers and spills) is kept beside each library as ``.log``, so a
cached library reports the same build log as a fresh one.
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

__all__ = ["SOURCES", "build_all", "library", "launch_smem", "check"]

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
#: name -> {"seconds": build time or 0.0 when cached, "log": nvcc output
#: (of the build that made a cached library)}
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


#: CUTLASS's headers on the GPU machine; passed to nvcc only for a source
#: that includes CuTe or CUTLASS
CUTLASS_INCLUDE = "/usr/local/cutlass/include"


def _flags(src_text):
    flags = list(_NVCC_FLAGS)
    if "#include <cute/" in src_text or "#include <cutlass/" in src_text:
        flags += ["-I", CUTLASS_INCLUDE]
    return flags


def _lib_path(name):
    """(source path, library path, nvcc flags) of kernel ``name``; the
    library's name hashes the source, every ``csrc/*.cuh`` and the flags."""
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        text = f.read()
    flags = _flags(text.decode())
    digest = hashlib.sha256(text + " ".join(flags).encode())
    for header in sorted(h for h in os.listdir(_CSRC) if h.endswith(".cuh")):
        with open(os.path.join(_CSRC, header), "rb") as f:
            digest.update(header.encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, "%s-%s.so" % (
        name, digest.hexdigest()[:16])), flags


def _declare(lib, name):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_decode":
        fn, args = lib.mxtt_flash_decode, ([i, i] + [vp] * 8
                                           + [i] * 7 + [f, vp])
    elif name == "quantized_matmul":
        lib.mxtt_qmm_gemv.argtypes = [i, i, vp, vp, vp, vp, vp, i, i, i, i,
                                      vp]
        lib.mxtt_qmm_gemv.restype = i
        fn, args = lib.mxtt_qmm_wgmma, [i, i, vp, vp, vp, vp, vp, vp, i, i,
                                        i, i, i, vp]
    elif name == "flash_attention":
        fn, args = lib.mxtt_flash_attention_forward, [i, vp, vp, vp, vp, vp,
                                                      i, i, i, i, i, f, vp]
    else:
        fn, args = lib.mxtt_fused_opt_sweep, ([i, vp, vp, vp, vp, vp,
                                               ctypes.c_longlong]
                                              + [f] * 11 + [vp, vp])
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
            src, out, flags = _lib_path(name)
            log_path = out[:-3] + ".log"
            if os.path.exists(out) and os.path.exists(log_path):
                with open(log_path) as f:
                    BUILD_INFO[name] = {"seconds": 0.0, "log": f.read()}
                continue
            tmp = "%s.%d.tmp" % (out[:-3], os.getpid())
            procs[name] = (subprocess.Popen(
                [_nvcc()] + flags + ["-o", tmp + ".so", src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            # nvcc runs under _LOCK by design: a second caller of
            # library() must wait for this build, not start a second
            # nvcc on the same output; nothing else takes _LOCK
            # mxl: thread-shared-ok (MXL-Q003)
            log, _ = proc.communicate()
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                "log": log}
            if proc.returncode != 0:
                failed.append("%s (nvcc exit %d):\n%s"
                              % (name, proc.returncode, log))
            else:
                with open(tmp + ".log", "w") as f:
                    f.write(log)
                os.replace(tmp + ".log", out[:-3] + ".log")
                os.replace(tmp + ".so", out)
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


#: kernel name -> its library's query of a launch's dynamic shared memory
_SMEM_QUERIES = {
    "flash_decode": ("mxtt_flash_decode_smem", [ctypes.c_int] * 4),
    "quantized_matmul": ("mxtt_qmm_smem", [ctypes.c_int] * 6),
    "flash_attention": ("mxtt_flash_attention_smem",
                        [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int)]),
}


def launch_smem(name, *args):
    """The dynamic shared memory (bytes) the built library of kernel
    ``name`` launches with for ``args`` (its ``mxtt_*_smem`` query), which
    the analyzer's launch specs are held to (``compiled=True``)."""
    fn_name, argtypes = _SMEM_QUERIES[name]
    fn = getattr(library(name), fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    got = fn(*args)
    if got < 0:
        raise MXNetError("%s: %s takes no launch %r" % (name, fn_name, args))
    return got


def check(lib, code, what):
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise MXNetError("%s launch failed: CUDA error %d (%s)"
                         % (what, code,
                            lib.mxtt_error_string(code).decode()))
