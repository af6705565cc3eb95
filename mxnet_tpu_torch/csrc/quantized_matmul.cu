// Weight-only int8 matmul: y = (x @ dequant(w_q)^T), y[m, n] = scale[n] * sum_k x[m, k] * w_q[n, k].
//
// Replaces the TPU kernel mxnet_tpu/kernels/quantize.py:_qmm_kernel (a Pallas
// grid over (m, n, k) blocks that widens int8 weight blocks in registers,
// accumulates in float32 across k and applies the per-channel scale on the
// last k step).  Here one thread block computes a 64 x 64 tile of y with 256
// threads, each thread a 4 x 4 register tile.  It walks K in steps of 32: it
// loads a 64 x 32 tile of x and a 64 x 32 tile of w_q (int8) into shared
// memory, widening both to float32 on load, and accumulates with float32 FMA.
// The next step's tiles load into registers while this step's FMAs run.
// The scale is applied once, after the last k step, and the result is cast
// to x's type.  Loads and stores are masked at every edge, so any M, N and K
// work (the Pallas kernel needed block sizes that divide the problem,
// mxnet_tpu/kernels/common.py:pick_block).
//
// Bound on this card: at decode (M <= 8) the call must read the N * K bytes
// of w_q, so it is bound by HBM bandwidth; at prefill (M = prompt length, up
// to 960 here) it does 2 * M * N * K float32 operations, bound by the float32
// FMA rate (67 TFLOP/s on an H100 SXM, outside the tensor cores).  This
// kernel uses no tensor cores; a wgmma int8/bf16 path is later work.
//
// Layout: x (M, K) row-major, float32 or bfloat16; w_q (N, K) int8 row-major;
// scale (N,) float32; y (M, N) in x's type.  All contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int kPer = kBM * kBK / kThreads;  // tile elements a thread loads
static_assert(kBM == kBN && kPer * kThreads == kBM * kBK, "tile split");

// Load this thread's kPer elements of the x tile and of the w_q tile at
// k0 into registers, widened to float32, zero outside the matrices.
// Consecutive threads take consecutive k: coalesced row reads.
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int M, int N, int K, int m0, int n0,
                                           int k0, float (&xr)[kPer],
                                           float (&wr)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kBK, c = e % kBK;
    const int gk = k0 + c;
    xr[i] = (m0 + r < M && gk < K) ? to_f32(x[(size_t)(m0 + r) * K + gk]) : 0.f;
    wr[i] = (n0 + r < N && gk < K) ? (float)w[(size_t)(n0 + r) * K + gk] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantized_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, T* __restrict__ y,
                        int M, int N, int K) {
  // k-major tiles; the +1 pad keeps the transposing stores free of bank
  // conflicts
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns n0 + tx + 16 * j
  const int ty = tid / 16;  // output rows    m0 + ty + 16 * i
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // register double buffer: the loads of tile k0 + kBK are in flight
  // while the FMAs of tile k0 run
  float xr[kPer], wr[kPer];
  load_tiles(x, w, M, N, K, m0, n0, 0, xr, wr);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      xs[e % kBK][e / kBK] = xr[i];
      ws[e % kBK][e / kBK] = wr[i];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tiles(x, w, M, N, K, m0, n0, k0 + kBK, xr, wr);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm < M) store_as(y + (size_t)gm * N + gn, acc[i][j] * s);
    }
  }
}

}  // namespace

// dtype code of x and y: 0 float32, 1 bfloat16.  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for an unknown
// dtype code or an empty or too-large grid.
extern "C" int mxtt_quantized_matmul(int x_dtype, const void* x, const void* w_q,
                                     const void* scale, void* y, int M, int N,
                                     int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w_q);
  const float* sp = static_cast<const float*>(scale);
  if (x_dtype == 0)
    quantized_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), wp, sp, static_cast<float*>(y), M, N, K);
  else if (x_dtype == 1)
    quantized_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wp, sp,
        static_cast<__nv_bfloat16*>(y), M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
