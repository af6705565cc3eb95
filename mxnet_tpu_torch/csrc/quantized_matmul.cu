// Weight-only int8 or fp8 (e4m3) matmul: y = (x @ dequant(w_q)^T),
// y[m, n] = scale[n] * sum_k x[m, k] * w_q[n, k].
//
// Replaces the TPU kernel mxnet_tpu/kernels/quantize.py:_qmm_kernel (a Pallas
// grid over (m, n, k) blocks that widens int8 or fp8 e4m3 weight blocks in
// registers, accumulates in float32 across k and applies the per-channel
// scale on the last k step).  Two bodies, each a template over the weight
// type (WInt8, WE4M3: one byte a weight either way, so the same loads and
// tiles); the wrapper (kernels/quantize.py) picks one by M and plans the
// split of K.  Every e4m3 value is exact in float16 (cvt.rn.f16x2.e4m3x2
// widens a pair) and so in float32 and in bfloat16 (a 4-bit significand,
// exponents -9..8): both bodies compute the same function for e4m3 as for
// int8, and never round x to fp8 (Hopper's fp8 wgmma would):
//
// Decode, M <= 16 (qmm_gemv): bound by reading the N * K weight bytes (4.2 MB
// at the lm_head, 1.25 us at 3.35 TB/s); its 2 * M * N * K FMAs take about
// as long on the float32 pipes, so tensor cores buy nothing.  Exact float32
// arithmetic on the CUDA cores: a group of 8 lanes walks 128 contiguous
// bytes of two weight rows per step (one 16-byte load each, widened in
// registers) against x staged in shared memory as float32.  K is split so
// every model shape puts about 2 CTAs on each SM, and so a CTA's x fits in
// 48 KB of shared memory at any K; split partial sums go to a float32
// workspace and a second small pass (qmm_reduce) adds them in split
// order and applies the scale -- no float atomics, so a result is the same
// run to run.
//
// Prefill, M > 16 (qmm_wgmma): bound by the 2 * M * N * K operations, which
// the old kernel ran on the float32 FMA pipes (67 TFLOP/s).  Here the tensor
// cores run them in bfloat16 with A and B swapped: a CTA computes a 64 x TN
// tile of y^T, the weight tile as wgmma's A operand -- TMA brings it into
// shared memory (64-byte swizzle), each thread widens its fragment to
// bfloat16 in registers (every int8 and every e4m3 is exact in bfloat16) --
// and x as the B
// operand from shared memory (K-major, 128-byte swizzle), so the tokens sit
// on wgmma's N side (TN = 64 or 240: the 240/480/960-row prompt buckets need
// no padding).  float32 x keeps float32 accuracy: qmm_split writes it as
// three bfloat16 pieces hi + mid + lo (hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid), which hold all 24 bits of the significand), and
// the three products go into one float32 accumulator (a piece's 8-bit
// significand times a weight's 8 bits (int8) or 4 bits (e4m3) is exact in
// float32); bfloat16 x is one product.  One producer warp keeps a 2-stage ring of TMA loads ahead of the
// consumer warpgroup (full/empty mbarriers).  When the (n, token) tiles are
// too few to fill the card, K is split as at decode.
//
// Layout: x (M, K) row-major, float32 or bfloat16; w_q (N, K) int8 or e4m3
// (its bytes) row-major;
// scale (N,) float32; y (M, N) in x's type.  All contiguous, K a multiple of
// 16 (the wrapper pads), pointers 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// decode: split-K GEMV on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kGvThreads = 128;                      // 16 groups of 8 lanes
constexpr int kGvRows = 2 * kGvThreads / 8;          // 2 rows a group: 32 a CTA
constexpr int kGvStep = 8 * 16;                      // k bytes a group reads a step
// x in shared memory: each 16 floats of a row padded to 20, so the 8 lanes
// of a group (16 floats apart in k) read conflict-free float4s
constexpr int kGvChunk = 20;

// the most x a CTA stages: the default dynamic shared memory limit (no
// opt-in), so four CTAs fit an SM; the wrapper splits K until x fits
constexpr size_t kGvSmemMax = 48 * 1024;

__host__ __device__ constexpr int gv_row_floats(int kchunk) { return kchunk / 16 * kGvChunk; }

// the k bytes of one split, in whole steps, and the x a CTA of MT rows stages
constexpr int gv_kchunk(int K, int splits) {
  return ((K + splits - 1) / splits + kGvStep - 1) / kGvStep * kGvStep;
}
constexpr size_t gv_smem(int MT, int kchunk) {
  return (size_t)MT * gv_row_floats(kchunk) * sizeof(float);
}

// The weight types: how 16 weight bytes widen to float32 (the GEMV) and how
// two widen to a bfloat16 pair (the wgmma A fragment).  Both exact.
struct WInt8 {
  static __device__ __forceinline__ void widen16(const int4 v, float (&w)[16]) {
    const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[4 * i + b] = (float)(int8_t)((words[i] >> (8 * b)) & 0xff);
  }
  static __device__ __forceinline__ uint32_t bf16_pair(uint16_t v) {
    return mxtt::pack_bf16((float)(int8_t)(v & 0xff), (float)(int8_t)(v >> 8));
  }
};

struct WE4M3 {
  // bytes (lo, hi) -> (float(lo), float(hi)): one cvt.rn.f16x2.e4m3x2, exact
  static __device__ __forceinline__ float2 pair(uint16_t v) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)v, __NV_E4M3);
    return __half22float2(__half2(h));
  }
  static __device__ __forceinline__ void widen16(const int4 v, float (&w)[16]) {
    const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 lo = pair((uint16_t)(words[i] & 0xffff));
      const float2 hi = pair((uint16_t)((uint32_t)words[i] >> 16));
      w[4 * i] = lo.x;
      w[4 * i + 1] = lo.y;
      w[4 * i + 2] = hi.x;
      w[4 * i + 3] = hi.y;
    }
  }
  static __device__ __forceinline__ uint32_t bf16_pair(uint16_t v) {
    const float2 f = pair(v);
    return mxtt::pack_bf16(f.x, f.y);
  }
};

// CTA (blockIdx.x, blockIdx.y): rows [32 * x, 32 * x + 32) of w_q, k range
// [y * kchunk, (y + 1) * kchunk).  MT >= M rows of x, the rest zero.
template <typename T, typename W, int MT>
__global__ void __launch_bounds__(kGvThreads)
qmm_gemv(const T* __restrict__ x, const uint8_t* __restrict__ w,
         const float* __restrict__ scale, T* __restrict__ y,
         float* __restrict__ partial, int M, int N, int K, int kchunk) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);  // MT x kchunk, padded chunks
  const int row = gv_row_floats(kchunk);
  const int kb = blockIdx.y * kchunk;
  const int klen = min(kchunk, K - kb);
  const int g = threadIdx.x / 8, gl = threadIdx.x % 8;
  const int n_a = blockIdx.x * kGvRows + g, n_b = n_a + kGvRows / 2;
  const uint8_t* wa = w + (size_t)min(n_a, N - 1) * K + kb;
  const uint8_t* wb = w + (size_t)min(n_b, N - 1) * K + kb;
  // the first weight step is in flight while x is staged
  int4 next_a = make_int4(0, 0, 0, 0), next_b = next_a;
  if (gl * 16 < klen) {
    next_a = __ldg(reinterpret_cast<const int4*>(wa + gl * 16));
    next_b = __ldg(reinterpret_cast<const int4*>(wb + gl * 16));
  }
  for (int e = threadIdx.x; e < MT * kchunk; e += kGvThreads) {
    const int m = e / kchunk, c = e - m * kchunk;
    xs[m * row + (c / 16) * kGvChunk + c % 16] =
        (m < M && c < klen) ? to_f32(x[(size_t)m * K + kb + c]) : 0.f;
  }
  __syncthreads();

  float acc_a[MT], acc_b[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc_a[m] = acc_b[m] = 0.f;

#pragma unroll 2
  for (int c = gl * 16; c < klen; c += kGvStep) {
    float va[16], vb[16];
    W::widen16(next_a, va);
    W::widen16(next_b, vb);
    if (c + kGvStep < klen) {
      next_a = __ldg(reinterpret_cast<const int4*>(wa + c + kGvStep));
      next_b = __ldg(reinterpret_cast<const int4*>(wb + c + kGvStep));
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4* xr =
          reinterpret_cast<const float4*>(xs + m * row + (c / 16) * kGvChunk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 xv = xr[i];
        acc_a[m] = fmaf(xv.x, va[4 * i], acc_a[m]);
        acc_a[m] = fmaf(xv.y, va[4 * i + 1], acc_a[m]);
        acc_a[m] = fmaf(xv.z, va[4 * i + 2], acc_a[m]);
        acc_a[m] = fmaf(xv.w, va[4 * i + 3], acc_a[m]);
        acc_b[m] = fmaf(xv.x, vb[4 * i], acc_b[m]);
        acc_b[m] = fmaf(xv.y, vb[4 * i + 1], acc_b[m]);
        acc_b[m] = fmaf(xv.z, vb[4 * i + 2], acc_b[m]);
        acc_b[m] = fmaf(xv.w, vb[4 * i + 3], acc_b[m]);
      }
    }
  }
  // sum over the 8 lanes of the group (a fixed tree); lane gl stores the
  // rows m with m % 8 == gl
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int off = 4; off >= 1; off >>= 1) {
      acc_a[m] += __shfl_xor_sync(0xffffffffu, acc_a[m], off);
      acc_b[m] += __shfl_xor_sync(0xffffffffu, acc_b[m], off);
    }
  }
  const bool direct = gridDim.y == 1;
  float* part = partial + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if ((m & 7) != gl || m >= M) continue;
    if (n_a < N) {
      if (direct) store_as(y + (size_t)m * N + n_a, acc_a[m] * scale[n_a]);
      else part[(size_t)m * N + n_a] = acc_a[m];
    }
    if (n_b < N) {
      if (direct) store_as(y + (size_t)m * N + n_b, acc_b[m] * scale[n_b]);
      else part[(size_t)m * N + n_b] = acc_b[m];
    }
  }
}

// y[m, n] = scale[n] * sum over splits s, in order, of partial[s, m, n]
template <typename T>
__global__ void qmm_reduce(const float* __restrict__ partial,
                           const float* __restrict__ scale, T* __restrict__ y,
                           int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < mn;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += partial[i * mn + e];
    store_as(y + e, s * scale[e % N]);
  }
}

// ---------------------------------------------------------------------------
// prefill: wgmma with the weight tile as A (from registers)
// ---------------------------------------------------------------------------
constexpr int kTcBN = 64;      // output channels a CTA (wgmma M)
constexpr int kTcBK = 64;      // k a stage: 64 weight bytes, 128 bf16 bytes a row
constexpr int kTcStages = 2;
constexpr int kTcThreads = 160;  // one consumer warpgroup + one producer warp

template <int TN, int P>
struct QmmCfg {
  static constexpr int W_BYTES = kTcBN * kTcBK;          // weight tile (bytes)
  static constexpr int X_BYTES = TN * kTcBK * 2;         // one bf16 piece
  static constexpr int STAGE = W_BYTES + P * X_BYTES;    // multiples of 1024
  static constexpr int SMEM = 1024 + kTcStages * STAGE + 8 * 2 * kTcStages;
};

// x (M, K) float32 -> pieces (3, M, K) bfloat16 with hi + mid + lo == x
__global__ void qmm_split(const float* __restrict__ x, __nv_bfloat16* __restrict__ pieces,
                          size_t n) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const float v = x[e];
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const float r1 = v - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    pieces[e] = hi;
    pieces[n + e] = mid;
    pieces[2 * n + e] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  }
}

// one weight pair of the 64 x 64 weight tile (64-byte swizzle) as bf16x2
template <typename W>
__device__ __forceinline__ uint32_t w_pair(const uint8_t* tile, int r, int c) {
  const int lin = r * kTcBK + c;
  const int phys = lin ^ (((lin >> 7) & 3) << 4);
  return W::bf16_pair(*reinterpret_cast<const uint16_t*>(tile + phys));
}

// CTA (blockIdx.x, blockIdx.y, blockIdx.z): channels [64 x, 64 x + 64),
// tokens [TN y, TN y + TN), k tiles [z * kt_per, (z + 1) * kt_per).
template <typename T, typename W, int TN, int P>
__global__ void __launch_bounds__(kTcThreads, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap wmap,
          const __grid_constant__ CUtensorMap xmap,
          const float* __restrict__ scale, T* __restrict__ y,
          float* __restrict__ partial, int M, int N, int K, int kt_per) {
  using C = QmmCfg<TN, P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (mxtt::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTcStages * C::STAGE);
  uint64_t* empty = full + kTcStages;
  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * TN;
  const int kt0 = blockIdx.z * kt_per;
  const int kt1 = min((K + kTcBK - 1) / kTcBK, kt0 + kt_per);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mxtt::mbar_init(&full[s], 1);
      mxtt::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mxtt::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = kt0; t < kt1; ++t) {
        mxtt::mbar_wait(&empty[stage], phase ^ 1);
        mxtt::mbar_expect_tx(&full[stage], C::STAGE);
        uint8_t* st = ring + stage * C::STAGE;
        mxtt::tma_load_2d(st, &wmap, &full[stage], t * kTcBK, n0);
        for (int p = 0; p < P; ++p)
          mxtt::tma_load_3d(st + C::W_BYTES + p * C::X_BYTES, &xmap, &full[stage],
                            t * kTcBK, m0, p);
        if (++stage == kTcStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds channels r and r + 8 of the
  // tile, tokens 8 * i + 2 * (lane % 4) + {0, 1} of every 8
  const int r = 16 * warp + lane / 4;
  const int qd = lane % 4;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = kt0; t < kt1; ++t) {
    mxtt::mbar_wait(&full[stage], phase);
    const uint8_t* st = ring + stage * C::STAGE;
    uint32_t a[kTcBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const int c = 16 * kk + 2 * qd;
      a[kk][0] = w_pair<W>(st, r, c);
      a[kk][1] = w_pair<W>(st, r + 8, c);
      a[kk][2] = w_pair<W>(st, r, c + 8);
      a[kk][3] = w_pair<W>(st, r + 8, c + 8);
    }
    const uint32_t x_addr = mxtt::smem_addr(st + C::W_BYTES);
    mxtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p)
        mxtt::wgmma_rs(acc, a[kk],
                       mxtt::make_desc(x_addr + p * C::X_BYTES + kk * 32, 16, 1024,
                                       mxtt::kSwizzle128B),
                       1);
    mxtt::wgmma_commit();
    mxtt::wgmma_wait<0>();
    mxtt::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) mxtt::fence_regs(a[kk]);
    __syncwarp();
    if (lane == 0) mxtt::mbar_arrive(&empty[stage]);
    if (++stage == kTcStages) { stage = 0; phase ^= 1; }
  }

  const bool direct = gridDim.z == 1;
  float* part = partial + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r + 8 * h;
    if (n >= N) continue;
    const float s = direct ? scale[n] : 1.f;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * i + 2 * qd + e;
        if (m >= M) continue;
        const float v = acc[4 * i + 2 * h + e];
        if (direct) store_as(y + (size_t)m * N + n, v * s);
        else part[(size_t)m * N + n] = v;
      }
  }
}

template <typename T>
cudaError_t reduce(const float* partial, const float* scale, void* y, int M, int N,
                   int splits, cudaStream_t s) {
  const size_t mn = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((mn + 255) / 256, 4096);
  qmm_reduce<T><<<blocks, 256, 0, s>>>(partial, scale, static_cast<T*>(y), M, N, splits);
  return cudaSuccess;
}

template <typename T, typename W, int MT>
cudaError_t launch_gemv(const void* x, const uint8_t* w, const float* scale, void* y,
                        float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  const int kchunk = gv_kchunk(K, splits);
  const size_t smem = gv_smem(MT, kchunk);
  if (smem > kGvSmemMax) return cudaErrorInvalidValue;
  const dim3 grid((N + kGvRows - 1) / kGvRows, (K + kchunk - 1) / kchunk);
  qmm_gemv<T, W, MT><<<grid, kGvThreads, smem, s>>>(
      static_cast<const T*>(x), w, scale, static_cast<T*>(y), partial, M, N, K, kchunk);
  if ((int)grid.y > 1) return reduce<T>(partial, scale, y, M, N, (int)grid.y, s);
  return cudaSuccess;
}

template <typename T, typename W>
cudaError_t gemv(const void* x, const uint8_t* w, const float* scale, void* y,
                 float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  if (M <= 1) return launch_gemv<T, W, 1>(x, w, scale, y, partial, M, N, K, splits, s);
  if (M <= 2) return launch_gemv<T, W, 2>(x, w, scale, y, partial, M, N, K, splits, s);
  if (M <= 4) return launch_gemv<T, W, 4>(x, w, scale, y, partial, M, N, K, splits, s);
  if (M <= 8) return launch_gemv<T, W, 8>(x, w, scale, y, partial, M, N, K, splits, s);
  return launch_gemv<T, W, 16>(x, w, scale, y, partial, M, N, K, splits, s);
}

template <typename T, typename W, int TN, int P>
cudaError_t launch_wgmma(const void* xb, const uint8_t* w, const float* scale, void* y,
                         float* partial, int M, int N, int K, int splits,
                         cudaStream_t s) {
  using C = QmmCfg<TN, P>;
  CUtensorMap wm, xm;
  const uint64_t wdims[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t wbox[2] = {kTcBK, kTcBN};
  const uint64_t xdims[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)P};
  const uint32_t xbox[3] = {kTcBK, TN, 1};
  if (!mxtt::encode_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, K, 0, wbox,
                        CU_TENSOR_MAP_SWIZZLE_64B) ||
      !mxtt::encode_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, xb, xdims,
                        (uint64_t)K * 2, (uint64_t)M * K * 2, xbox,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static uint64_t smem_set = 0;
  const cudaError_t err = mxtt::max_smem_once(qmm_wgmma<T, W, TN, P>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int k_tiles = (K + kTcBK - 1) / kTcBK;
  const int kt_per = (k_tiles + splits - 1) / splits;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + TN - 1) / TN, (k_tiles + kt_per - 1) / kt_per);
  qmm_wgmma<T, W, TN, P><<<grid, kTcThreads, C::SMEM, s>>>(
      wm, xm, scale, static_cast<T*>(y), partial, M, N, K, kt_per);
  if ((int)grid.z > 1) return reduce<T>(partial, scale, y, M, N, (int)grid.z, s);
  return cudaSuccess;
}

template <typename T, typename W, int P>
cudaError_t wgmma_tn(int tn, const void* xb, const uint8_t* w, const float* scale, void* y,
                     float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  if (tn == 64) return launch_wgmma<T, W, 64, P>(xb, w, scale, y, partial, M, N, K, splits, s);
  if (tn == 240) return launch_wgmma<T, W, 240, P>(xb, w, scale, y, partial, M, N, K, splits, s);
  return cudaErrorInvalidValue;
}

template <typename T, int P>
cudaError_t wgmma_w(int w_dtype, int tn, const void* xb, const uint8_t* w, const float* scale,
                    void* y, float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  if (w_dtype == 0) return wgmma_tn<T, WInt8, P>(tn, xb, w, scale, y, partial, M, N, K, splits, s);
  if (w_dtype == 1) return wgmma_tn<T, WE4M3, P>(tn, xb, w, scale, y, partial, M, N, K, splits, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t gemv_w(int w_dtype, const void* x, const uint8_t* w, const float* scale, void* y,
                   float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  if (w_dtype == 0) return gemv<T, WInt8>(x, w, scale, y, partial, M, N, K, splits, s);
  if (w_dtype == 1) return gemv<T, WE4M3>(x, w, scale, y, partial, M, N, K, splits, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Both entry points: x_dtype 0 float32, 1 bfloat16 (x and y); w_dtype 0
// int8, 1 fp8 e4m3 (float8_e4m3fn: 0x7f and 0xff are NaN, which quantizing
// never writes); K a multiple of 16; `partial` a float32 workspace of splits * M * N (unused when
// splits == 1).  They return cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue / cudaErrorMisalignedAddress for
// arguments the kernels do not take (the GEMV: a split of K whose x,
// MT * kchunk * 5 bytes, exceeds 48 KB).

// decode body, M <= 16
extern "C" int mxtt_qmm_gemv(int x_dtype, int w_dtype, const void* x, const void* w_q,
                             const void* scale, void* y, void* partial, int M, int N,
                             int K, int splits, void* stream) {
  if (M < 1 || M > 16 || N < 1 || K < 16 || K % 16 != 0 || splits < 1 ||
      (K + kGvStep - 1) / kGvStep < splits)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w_q)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w_q);
  const float* sp = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(partial);
  cudaError_t err;
  if (x_dtype == 0)
    err = gemv_w<float>(w_dtype, x, wp, sp, y, pp, M, N, K, splits, s);
  else if (x_dtype == 1)
    err = gemv_w<__nv_bfloat16>(w_dtype, x, wp, sp, y, pp, M, N, K, splits, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// prefill body: `pieces` is a bfloat16 workspace of 3 * M * K for float32
// x (the split is written there first); bfloat16 x is read as it is.
// tn: the token tile, 64 or 240.
extern "C" int mxtt_qmm_wgmma(int x_dtype, int w_dtype, const void* x, const void* w_q,
                              const void* scale, void* y, void* pieces, void* partial,
                              int M, int N, int K, int tn, int splits, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || splits < 1 ||
      (M + tn - 1) / (tn > 0 ? tn : 1) > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w_q) || (x_dtype == 0 && !aligned16(pieces)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w_q);
  const float* sp = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(partial);
  cudaError_t err;
  if (x_dtype == 0) {
    const size_t n = (size_t)M * K;
    const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
    qmm_split<<<blocks, 256, 0, s>>>(static_cast<const float*>(x),
                                     static_cast<__nv_bfloat16*>(pieces), n);
    err = wgmma_w<float, 3>(w_dtype, tn, pieces, wp, sp, y, pp, M, N, K, splits, s);
  } else if (x_dtype == 1) {
    err = wgmma_w<__nv_bfloat16, 1>(w_dtype, tn, x, wp, sp, y, pp, M, N, K, splits, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) of a launch of the GEMV (route 0; tn and
// pieces unused) or of the wgmma body (route 1; tn 64 or 240, pieces 3 for
// float32 x and 1 for bfloat16), with M, K and splits as for the entry
// points; -1 for a route or tile the kernels do not take.  The static
// analyzer's launch specs of the kernels are held to these numbers on the
// card.
extern "C" int mxtt_qmm_smem(int route, int M, int K, int splits, int tn, int pieces) {
  if (M < 1 || K < 1 || splits < 1) return -1;
  if (route == 0 && M <= 16) {
    const int mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
    return (int)gv_smem(mt, gv_kchunk(K, splits));
  }
  if (route != 1) return -1;
  if (tn == 64 && pieces == 1) return QmmCfg<64, 1>::SMEM;
  if (tn == 64 && pieces == 3) return QmmCfg<64, 3>::SMEM;
  if (tn == 240 && pieces == 1) return QmmCfg<240, 1>::SMEM;
  if (tn == 240 && pieces == 3) return QmmCfg<240, 3>::SMEM;
  return -1;
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
