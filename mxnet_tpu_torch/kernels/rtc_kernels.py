"""CUDA C kernel bodies pushed through :class:`mxnet_tpu_torch.rtc.Rtc`,
each with its launch dimensions and its plain PyTorch version.

They replace what the JAX package pushes through ``Rtc(...,
pallas=True)`` (``mxnet_tpu/rtc.py:79-110``), whose kernel is the body
the user supplies, plus the reference MXNet's own NVRTC test and two
kernels that reach the rest of the kernel branch:

- :func:`xy_plus_one`: ``x*y + 1`` (``tests/test_rtc_consistency.py``);
- :func:`saxpy`: ``2.5*x + y`` (``example/rtc/pallas_kernel.py``);
- :func:`exp_shared`: ``exp(5 x)`` through a static ``__shared__``
  array, one block of 10 threads (the reference MXNet's ``test_rtc``);
- :func:`add_mul_bf16`: ``(x+y, x*y)`` in float32 from bfloat16 inputs:
  two outputs and the bfloat16 header;
- :func:`transpose`: a 2-D array transposed through 32x32 shared-memory
  tiles, 2-D grid and 2-D blocks.

The elementwise ones are bound by bytes (each input read once, each
output written once).  :data:`XY_PLUS_ONE` and :data:`ADD_MUL_BF16` take
one element a thread, consecutive threads on consecutive addresses, the
simplest form of a body; :data:`SAXPY` moves 16-byte vectors in a
grid-stride loop over a grid sized from the card (:func:`saxpy_dims`).
The transpose reads and writes whole 128-byte rows of a tile; the
tile's padded column keeps the transposed reads of shared memory free
of bank conflicts.

Each wrapper takes NDArrays.  On arrays that lie on the CPU it runs the
plain version (a CUDA body cannot run there); on a GPU it pushes the
body through an ``Rtc`` (compiled once per shape) or raises.
"""
from __future__ import annotations

import torch

from ..ndarray import NDArray
from ..rtc import Rtc

__all__ = ["XY_PLUS_ONE", "SAXPY", "EXP_SHARED", "ADD_MUL_BF16",
           "TRANSPOSE", "xy_plus_one", "saxpy", "saxpy_dims", "exp_shared",
           "add_mul_bf16", "transpose", "xy_plus_one_reference",
           "saxpy_reference", "exp_shared_reference",
           "add_mul_bf16_reference", "transpose_reference"]

XY_PLUS_ONE = r"""
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < out0_size) out0[i] = in0[i] * in1[i] + 1.0f;
"""

SAXPY = r"""
    // 16-byte loads and stores in a grid-stride loop over tiles of
    // 8 x blockDim.x vectors: each thread has eight vectors in flight,
    // blockDim.x apart, so a block reads and writes one contiguous tile at
    // a time; a scalar tail for the last out0_size % 4 elements, and a
    // scalar loop when an array does not start on a 16-byte boundary (a
    // view can start anywhere)
    const long long n = out0_size, n4 = n / 4;
    const long long tile = 8LL * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (((unsigned long long)in0 | (unsigned long long)in1
         | (unsigned long long)out0) % 16 == 0) {
        const float4* x4 = reinterpret_cast<const float4*>(in0);
        const float4* y4 = reinterpret_cast<const float4*>(in1);
        float4* o4 = reinterpret_cast<float4*>(out0);
        for (long long t0 = (long long)blockIdx.x * tile; t0 < n4;
             t0 += (long long)gridDim.x * tile) {
            float4 x[8], y[8];
            #pragma unroll
            for (int u = 0; u < 8; ++u) {
                const long long j = t0 + threadIdx.x + u * blockDim.x;
                if (j < n4) {
                    x[u] = x4[j];
                    y[u] = y4[j];
                }
            }
            #pragma unroll
            for (int u = 0; u < 8; ++u) {
                const long long j = t0 + threadIdx.x + u * blockDim.x;
                if (j < n4)
                    o4[j] = make_float4(
                        2.5f * x[u].x + y[u].x, 2.5f * x[u].y + y[u].y,
                        2.5f * x[u].z + y[u].z, 2.5f * x[u].w + y[u].w);
            }
        }
        i += n4 * 4;
    }
    for (; i < n; i += (long long)gridDim.x * blockDim.x)
        out0[i] = 2.5f * in0[i] + in1[i];
"""

EXP_SHARED = r"""
    __shared__ float s[10];
    s[threadIdx.x] = in0[threadIdx.x];
    __syncthreads();
    out0[threadIdx.x] = expf(s[threadIdx.x] * 5.0f);
"""

ADD_MUL_BF16 = r"""
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < in0_size) {
        float a = __bfloat162float(in0[i]);
        float b = __bfloat162float(in1[i]);
        out0[i] = a + b;
        out1[i] = a * b;
    }
"""

TRANSPOSE = r"""
    __shared__ float tile[32][33];
    long long col = (long long)blockIdx.x * 32 + threadIdx.x;
    long long row = (long long)blockIdx.y * 32 + threadIdx.y;
    for (int j = 0; j < 32; j += 8)
        if (col < in0_dim1 && row + j < in0_dim0)
            tile[threadIdx.y + j][threadIdx.x] =
                in0[(row + j) * in0_dim1 + col];
    __syncthreads();
    col = (long long)blockIdx.y * 32 + threadIdx.x;
    row = (long long)blockIdx.x * 32 + threadIdx.y;
    for (int j = 0; j < 32; j += 8)
        if (col < out0_dim1 && row + j < out0_dim0)
            out0[(row + j) * out0_dim1 + col] =
                tile[threadIdx.x][threadIdx.y + j];
"""

_THREADS = 256
_RTCS = {}       # (body, n_outputs, out_shapes, out_dtypes) -> Rtc


def _rtc(body, n_outputs=1, out_shapes=None, out_dtypes=None):
    key = (body, n_outputs, out_shapes, out_dtypes)
    rtc = _RTCS.get(key)
    if rtc is None:
        rtc = _RTCS[key] = Rtc(body, n_outputs=n_outputs, pallas=True,
                               out_shapes=out_shapes, out_dtypes=out_dtypes)
    return rtc


def _elementwise_dims(n):
    return ((n + _THREADS - 1) // _THREADS, 1, 1), (_THREADS, 1, 1)


#: thread blocks an SM for :data:`SAXPY`: 8 of 256 threads fill an SM
SAXPY_BLOCKS_PER_SM = 8


def saxpy_dims(n, sms):
    """Grid and block of :data:`SAXPY` over ``n`` elements on a card
    with ``sms`` SMs: ``SAXPY_BLOCKS_PER_SM`` blocks of 256 threads an
    SM, fewer when ``n`` fills fewer tiles of 8 x 256 vectors (the
    grid-stride loop takes whatever is beyond one tile a block)."""
    blocks = min(sms * SAXPY_BLOCKS_PER_SM, -(-n // (4 * 8 * _THREADS)))
    return (max(1, blocks), 1, 1), (_THREADS, 1, 1)


def _on_cpu(arrays):
    return all(a.data.device.type == "cpu" for a in arrays)


def _wrap(tensors, like):
    return tuple(NDArray(t, ctx=like.context) for t in tensors)


# ----------------------------------------------------------------------
# plain versions: the same function in PyTorch, on tensors
# ----------------------------------------------------------------------
def xy_plus_one_reference(x, y):
    return x * y + 1.0


def saxpy_reference(x, y):
    return 2.5 * x + y


def exp_shared_reference(x):
    return torch.exp(x * 5.0)


def add_mul_bf16_reference(x, y):
    a, b = x.float(), y.float()
    return a + b, a * b


def transpose_reference(x):
    return x.t().contiguous()


# ----------------------------------------------------------------------
# wrappers: NDArrays in, a tuple of NDArrays out
# ----------------------------------------------------------------------
def xy_plus_one(x, y):
    if _on_cpu((x, y)):
        return _wrap([xy_plus_one_reference(x.data, y.data)], x)
    grid, block = _elementwise_dims(x.size)
    return _rtc(XY_PLUS_ONE).push([x, y], grid, block)


def saxpy(x, y):
    """``2.5 x + y`` on float32 arrays; on a GPU with the grid of
    :func:`saxpy_dims` for the card."""
    if _on_cpu((x, y)):
        return _wrap([saxpy_reference(x.data, y.data)], x)
    grid, block = saxpy_dims(x.size, torch.cuda.get_device_properties(
        x.data.device).multi_processor_count)
    return _rtc(SAXPY).push([x, y], grid, block)


def exp_shared(x):
    """One block of 10 threads over a 10-element float32 array."""
    if _on_cpu((x,)):
        return _wrap([exp_shared_reference(x.data)], x)
    return _rtc(EXP_SHARED).push([x], (1, 1, 1), (10, 1, 1))


def add_mul_bf16(x, y):
    if _on_cpu((x, y)):
        return _wrap(add_mul_bf16_reference(x.data, y.data), x)
    grid, block = _elementwise_dims(x.size)
    rtc = _rtc(ADD_MUL_BF16, n_outputs=2,
               out_dtypes=(torch.float32, torch.float32))
    return rtc.push([x, y], grid, block)


def transpose(x):
    """A 2-D float32 array, transposed; blocks of 32x8 threads move one
    32x32 tile each."""
    if _on_cpu((x,)):
        return _wrap([transpose_reference(x.data)], x)
    rows, cols = x.shape
    rtc = _rtc(TRANSPOSE, out_shapes=((cols, rows),))
    return rtc.push([x], ((cols + 31) // 32, (rows + 31) // 32, 1),
                    (32, 8, 1))
