"""A ctypes binding of NVRTC and the CUDA driver API: compile CUDA C++ at
runtime, load it, launch it on PyTorch's stream.

:mod:`mxnet_tpu_torch.rtc` is its one user.  The libraries load at first
use, never at import: the CPU tests import every module of the port on
machines with no CUDA.

- :func:`compile_cubin` compiles one source with NVRTC for ``sm_90a``
  and returns the CUBIN (machine code, so the CUDA driver does no PTX JIT
  whose version could differ from the toolkit's).  A compile error
  raises :class:`MXNetError` carrying NVRTC's whole program log.
- :class:`Module` loads a CUBIN into the primary context of one device
  (the context PyTorch's runtime uses); :meth:`Module.function` looks a
  kernel up by name.
- :meth:`Function.launch` checks the launch dimensions against the
  kernel's thread limit, then calls ``cuLaunchKernel`` on a given stream
  with device pointers as the kernel's arguments.  It neither
  synchronises nor allocates.

Every driver call's ``CUresult`` is checked, and an error becomes an
``MXNetError`` with ``cuGetErrorString``'s text.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading

from ..base import MXNetError

__all__ = ["compile_cubin", "Module", "Function"]

_c_int, _c_uint, _c_size_t = ctypes.c_int, ctypes.c_uint, ctypes.c_size_t
_vp, _char_p = ctypes.c_void_p, ctypes.c_char_p
_P = ctypes.POINTER

#: CUfunction_attribute CU_FUNC_ATTRIBUTE_MAX_THREADS_PER_BLOCK
_MAX_THREADS_PER_BLOCK = 0
#: the one target: Hopper with its architecture-specific features
_ARCH = "sm_90a"

_LOCK = threading.Lock()
_LIBS = {}            # "nvrtc" / "cuda" -> ctypes.CDLL with declared types
_PRIMARY = {}         # device ordinal -> retained primary CUcontext


def _cuda_home():
    """``$CUDA_HOME``, else ``/usr/local/cuda``."""
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _declare(lib, table):
    for name, restype, argtypes in table:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_NVRTC_API = [
    ("nvrtcGetErrorString", _char_p, [_c_int]),
    ("nvrtcCreateProgram", _c_int, [_P(_vp), _char_p, _char_p, _c_int,
                                    _P(_char_p), _P(_char_p)]),
    ("nvrtcCompileProgram", _c_int, [_vp, _c_int, _P(_char_p)]),
    ("nvrtcGetProgramLogSize", _c_int, [_vp, _P(_c_size_t)]),
    ("nvrtcGetProgramLog", _c_int, [_vp, _char_p]),
    ("nvrtcGetCUBINSize", _c_int, [_vp, _P(_c_size_t)]),
    ("nvrtcGetCUBIN", _c_int, [_vp, _char_p]),
    ("nvrtcDestroyProgram", _c_int, [_P(_vp)]),
]

_CUDA_API = [
    ("cuInit", _c_int, [_c_uint]),
    ("cuGetErrorString", _c_int, [_c_int, _P(_char_p)]),
    ("cuDeviceGet", _c_int, [_P(_c_int), _c_int]),
    ("cuDevicePrimaryCtxRetain", _c_int, [_P(_vp), _c_int]),
    ("cuCtxGetCurrent", _c_int, [_P(_vp)]),
    ("cuCtxSetCurrent", _c_int, [_vp]),
    ("cuCtxGetDevice", _c_int, [_P(_c_int)]),
    ("cuModuleLoadData", _c_int, [_P(_vp), _vp]),
    ("cuModuleGetFunction", _c_int, [_P(_vp), _vp, _char_p]),
    ("cuFuncGetAttribute", _c_int, [_P(_c_int), _c_int, _vp]),
    ("cuLaunchKernel", _c_int, [_vp, _c_uint, _c_uint, _c_uint, _c_uint,
                                _c_uint, _c_uint, _c_uint, _vp, _P(_vp),
                                _P(_vp)]),
]


def _nvrtc():
    with _LOCK:
        lib = _LIBS.get("nvrtc")
        if lib is None:
            where = os.path.join(_cuda_home(), "lib64")
            found = sorted(glob.glob(os.path.join(where, "libnvrtc.so*")),
                           key=len)
            if not found:
                raise MXNetError(
                    "NVRTC not found: no libnvrtc.so* in %s (set CUDA_HOME "
                    "to the CUDA toolkit)" % where)
            try:
                lib = _declare(ctypes.CDLL(found[0]), _NVRTC_API)
            except OSError as err:
                raise MXNetError("cannot load %s: %s" % (found[0], err)) \
                    from None
            _LIBS["nvrtc"] = lib
        return lib


def _cuda():
    with _LOCK:
        lib = _LIBS.get("cuda")
        if lib is None:
            try:
                lib = _declare(ctypes.CDLL("libcuda.so.1"), _CUDA_API)
            except OSError as err:
                raise MXNetError(
                    "the CUDA driver library libcuda.so.1 was not found on "
                    "the dynamic loader's path (%s)" % err) from None
            _check(lib, lib.cuInit(0), "cuInit")
            _LIBS["cuda"] = lib
        return lib


def _check(lib, code, what):
    if code != 0:
        text = _char_p()
        if lib.cuGetErrorString(code, ctypes.byref(text)) != 0 \
                or not text.value:
            msg = "unknown error"
        else:
            msg = text.value.decode()
        raise MXNetError("%s failed: CUDA error %d (%s)" % (what, code, msg))


def _nvrtc_check(lib, code, what):
    if code != 0:
        raise MXNetError("%s failed: %s"
                         % (what, lib.nvrtcGetErrorString(code).decode()))


def compile_cubin(source, options=()):
    """Compile CUDA C++ ``source`` with NVRTC -> CUBIN bytes for sm_90a.

    Options: ``--gpu-architecture=sm_90a``, ``-std=c++17``, the
    toolkit's include directory (for ``cuda_fp16.h`` and ``cuda_bf16.h``)
    and ``options`` (strings, e.g. ``--fmad=false``).  Nothing is written
    to disk."""
    lib = _nvrtc()
    prog = _vp()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        opts = [b"--gpu-architecture=" + _ARCH.encode(), b"-std=c++17",
                b"--include-path=" + os.path.join(_cuda_home(),
                                                  "include").encode()]
        opts += [o.encode() for o in options]
        code = lib.nvrtcCompileProgram(prog, len(opts),
                                       (_char_p * len(opts))(*opts))
        if code != 0:
            size = _c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            buf = ctypes.create_string_buffer(size.value + 1)
            lib.nvrtcGetProgramLog(prog, buf)
            raise MXNetError(
                "NVRTC could not compile rtc.cu (%s):\n%s\n--- source ---"
                "\n%s" % (lib.nvrtcGetErrorString(code).decode(),
                   buf.value.decode(errors="replace"), source))
        size = _c_size_t()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        return buf.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(lib, device):
    """Make a context of ``device`` current on the calling thread: keep
    the current one when it is that device's, else set the device's
    primary context (retained once), the one PyTorch's runtime uses.  A
    fresh thread has no current context at all."""
    cur = _vp()
    _check(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value:
        dev = _c_int()
        _check(lib, lib.cuCtxGetDevice(ctypes.byref(dev)), "cuCtxGetDevice")
        if dev.value == device:
            return
    with _LOCK:
        ctx = _PRIMARY.get(device)
        if ctx is None:
            handle = _c_int()
            _check(lib, lib.cuDeviceGet(ctypes.byref(handle), device),
                   "cuDeviceGet")
            ctx = _vp()
            _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                     handle),
                   "cuDevicePrimaryCtxRetain")
            _PRIMARY[device] = ctx
    _check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


class Module(object):
    """A CUBIN loaded into the primary context of CUDA device ``device``
    (an ordinal).  Loaded once; it lives as long as the process."""

    def __init__(self, cubin, device):
        self._lib = _cuda()
        self.device = int(device)
        self._image = ctypes.create_string_buffer(cubin, len(cubin))
        _make_current(self._lib, self.device)
        self._handle = _vp()
        _check(self._lib, self._lib.cuModuleLoadData(
            ctypes.byref(self._handle), self._image), "cuModuleLoadData")

    def function(self, name):
        fn = _vp()
        _check(self._lib, self._lib.cuModuleGetFunction(
            ctypes.byref(fn), self._handle, name.encode()),
            "cuModuleGetFunction(%s)" % name)
        return Function(self, fn, name)


class Function(object):
    """One ``__global__`` function of a :class:`Module`."""

    def __init__(self, module, handle, name):
        self.module = module
        self.name = name
        self._handle = handle
        lib = module._lib
        limit = _c_int()
        _check(lib, lib.cuFuncGetAttribute(ctypes.byref(limit),
                                           _MAX_THREADS_PER_BLOCK, handle),
               "cuFuncGetAttribute")
        #: the most threads a block of this kernel may have
        self.max_threads_per_block = limit.value

    def launch(self, grid, block, pointers, stream):
        """``cuLaunchKernel`` with ``grid``/``block`` (3 ints each) and one
        kernel argument per device pointer in ``pointers`` (ints), on
        ``stream`` (a ``cudaStream_t`` as an int; 0 is the legacy default
        stream).  Raises before launching when a dimension is below 1 or
        the block has more threads than the kernel allows; raises when
        the CUDA driver refuses the launch."""
        self.launch_args(grid, block, [_vp(int(p)) for p in pointers],
                         stream)

    def launch_args(self, grid, block, args, stream):
        """:meth:`launch` with the kernel's arguments given as ctypes
        values in its parameter order (``c_void_p`` for a pointer,
        ``c_float``, ``c_longlong``, ...)."""
        grid, block = tuple(int(g) for g in grid), tuple(int(b)
                                                         for b in block)
        if len(grid) != 3 or len(block) != 3:
            raise MXNetError("grid and block need 3 dimensions each, got "
                             "%s and %s" % (grid, block))
        if min(grid) < 1 or min(block) < 1:
            raise MXNetError("%s: every grid and block dimension must be "
                             "at least 1, got grid %s block %s"
                             % (self.name, grid, block))
        threads = block[0] * block[1] * block[2]
        if threads > self.max_threads_per_block:
            raise MXNetError(
                "%s: block %s has %d threads, more than the kernel's limit "
                "of %d" % (self.name, block, threads,
                           self.max_threads_per_block))
        lib = self.module._lib
        _make_current(lib, self.module.device)
        # kernelParams: an array of void*, each pointing at one argument's
        # value; all alive until the call returns
        values = list(args)
        params = (_vp * max(len(values), 1))(
            *[ctypes.addressof(v) for v in values])
        _check(lib, lib.cuLaunchKernel(
            self._handle, grid[0], grid[1], grid[2], block[0], block[1],
            block[2], 0, _vp(int(stream)), params, None),
            "cuLaunchKernel(%s)" % self.name)
