// Flash-attention forward: softmax(q k^T * scale [causal]) v, and the
// per-row logsumexp the backward recomputes from.
//
// Replaces the TPU kernel mxnet_tpu/parallel/ring_attention.py:_flash_kernel
// (a Pallas program per (batch*head, q block) that walks every k block with
// an online softmax in VMEM, and writes o plus the logsumexp broadcast over
// 128 lanes).  lse = m + log(max(l, 1e-30)) is written once per row as
// (B, H, S) float32 -- no lane broadcast.  Two bodies, by input type:
//
// bfloat16 inputs: a tensor-core kernel (flash_forward_wgmma below).  Bound
// on this card: the bytes (q, k, v, o once each, lse; 33.5 MB at B=8, H=8,
// S=1024, D=64) against 4*Sq*Sk*D operations (half of that causal) at the
// bf16 tensor rate, far under the float32 FMA rate the old path ran at.  A
// CTA of 384 threads holds 128 q rows: two consumer warpgroups of 64 rows,
// and a producer warpgroup (its registers handed to the consumers with
// setmaxnreg) whose one thread issues TMA loads of q once and of k and v
// tiles of 128 keys (64 at D=128) into a ring of 4 stages, each stage with
// a "full" and an "empty" mbarrier.  The tiles land 128-byte swizzled
// (64-byte at D=32) and D=128 is two 64-column panels.  S = q k^T is a wgmma with both operands in
// shared memory (K-major); the online softmax runs on the float32
// accumulator registers (row max and sum over the 4 threads of a quad);
// O += p v takes p from registers in wgmma's A layout (the accumulator
// layout lines up for 16-bit types) and v from shared memory MN-major
// (the transpose bit).  p is issued twice, p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), so it carries about 16 significant bits and o stays
// within one bfloat16 ulp of the float32 plain version: a single bf16 p
// would not.  What keeps the tensor cores busy: a warpgroup issues the next
// tile's S together with the previous tile's p v and runs the softmax while
// the latter is in flight, and the two warpgroups take turns issuing
// (named barriers), so one's softmax overlaps the other's products.  Tiles
// wholly above the causal diagonal are never loaded, only tiles on the
// diagonal or on the ragged edge are masked (-1e30, as in the reference),
// TMA zero-fills outside the tensors, rows at or past Sq are not stored.
// Persistent: one CTA an SM walks the (batch*head, 128-row q tile) items,
// the longest causal walks first, with q double-buffered so the next
// item's loads overlap this item's last tiles and its epilogue.
//
// float32 inputs keep the FMA kernel (flash_forward_kernel below): it is
// already faster than PyTorch's float32 attention, and a TF32 tensor-core
// path would round q and k to 10 mantissa bits and change the numerics.
// Grid (B*H, ceil(Sq/64)): one thread block of 128 threads holds a 64-row q
// tile and loops over 64-row k/v tiles staged in shared memory.  The
// statistics m (running max) and l (running sum) and the output rows o are
// float32 registers.
//
// Thread layout: thread (ty, tx) = (tid / 8, tid % 8) owns q rows
// 4*ty .. 4*ty+3 of the tile and, of the score tile, the 8 columns
// {32*g + 4*tx + u : g < 2, u < 4}; of the output, the D/8 columns
// {32*g + 4*tx + u : g < D/32, u < 4}.  The 8 threads of a row group are
// 8 neighbouring lanes, so row maxima and sums reduce with 3 shuffles.  q
// and k tiles are stored transposed (d-major, rows padded to 68 floats) so
// that every inner-loop read is a conflict-free float4; probabilities go
// through shared memory (transposed) from the score layout to the output
// layout.
//
// Masks: a key at or past Sk (the ragged edge), or above the diagonal when
// causal, scores -1e30 as in the reference -- not -inf -- and so adds
// exp(-1e30 - m) = 0.  With causal, k tiles that lie wholly above the
// diagonal are not visited at all, which is exact for the same reason.
// Rows at or past Sq are computed on zeros and not stored.  So the kernel
// takes any Sq and Sk, where the Pallas kernel needs multiples of its block.
//
// Bound of the float32 body: the arithmetic, 4*Sq*Sk*D flops per (b, h)
// (half of that causal), on the float32 FMA pipes (67 TFLOP/s on an H100
// SXM); 3 shared float4 loads per 32 FMAs in both inner loops.
//
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), o (BH, Sq, D) in the input
// type; lse (BH, Sq) float32.  All contiguous, 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // q rows per tile
constexpr int kBK = 64;          // k rows per tile
constexpr int kThreads = 128;
constexpr int kLD = kBQ + 4;     // padded stride of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int causal,
                     float scale) {
  constexpr int OG = D / 32;     // float4 groups of output columns a thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // D x kLD: q tile, transposed
  float* kt = qt + D * kLD;                     // D x kLD: k tile, transposed
  float* vs = kt + D * kLD;                     // kBK x D: v tile
  float* pt = vs + kBK * D;                     // kBK x kLD: p, transposed

  const int bh = blockIdx.x;
  const int n_qtiles = gridDim.y;
  const int q0 = (n_qtiles - 1 - blockIdx.y) * kBQ;  // longest causal walks first
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qt[d * kLD + r] = (q0 + r < Sq) ? to_f32(q[qbase + (size_t)(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * OG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) acc[i][c] = 0.f;
  }

  int n_ktiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last = (q0 + kBQ - 1) / kBK + 1;  // tiles touching the diagonal
    if (last < n_ktiles) n_ktiles = last;
  }

  for (int j = 0; j < n_ktiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's kt, vs and pt are no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk) {
        const size_t off = kbase + (size_t)(k0 + c) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kt[d * kLD + c] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    // scores of this thread's 4 rows x 8 columns
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * kLD + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&kt[d * kLD + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&kt[d * kLD + 32 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
    }

    // online softmax over the tile, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = k0 + (c >> 2) * 32 + tx * 4 + (c & 3);
        float x = s[i][c] * scale;
        if (col >= Sk || (causal && col > r)) x = kNegInf;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
      }
      l[i] = l[i] * corr + group8_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * OG; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c >> 2) * 32 + tx * 4 + (c & 3);
      *reinterpret_cast<float4*>(&pt[col * kLD + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

    // o += p v over the tile's keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pt[c * kLD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        const float4 w4 = *reinterpret_cast<const float4*>(&vs[c * D + g * 32 + tx * 4]);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[i][g * 4 + u] = fmaf(pv[i], wv[u], acc[i][g * 4 + u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = o + qbase + (size_t)r * D;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) store_as(orow + g * 32 + tx * 4 + u, acc[i][g * 4 + u] / ls);
    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(ls);
  }
}

constexpr size_t smem_bytes(int D) {
  return (size_t)(2 * D * kLD + kBK * D + kBK * kLD) * sizeof(float);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int BH, int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_forward_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_forward_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, causal, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                     int BH, int Sq, int Sk, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: the tensor-core body (wgmma fed by TMA into an mbarrier
// ring; see the head of this file)
// ---------------------------------------------------------------------------
template <int D>
struct TcCfg {
  static constexpr int BQ = 128;                  // q rows a CTA
  static constexpr int BK = D == 128 ? 64 : 128;  // keys a tile
  static constexpr int PANEL = D < 64 ? D : 64;   // columns of one swizzled panel
  static constexpr int NPANEL = D / PANEL;
  static constexpr int ROWB = PANEL * 2;          // bytes of a panel row
  static constexpr mxtt::Swizzle SW = ROWB == 128 ? mxtt::kSwizzle128B : mxtt::kSwizzle64B;
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int T_BYTES = BK * D * 2;      // one k or v tile
  static constexpr int THREADS = 384;             // 2 consumer warpgroups + the producer's
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * T_BYTES + 8 * (4 + 2 * STAGES);
  static constexpr int NS = BK / 2;               // score registers a thread
  static constexpr int NO = D / 2;                // output registers a thread
  static constexpr int NF = BK / 16;              // A fragments of p
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S = q k^T over the head dim: both operands in shared memory, K-major
template <int D>
__device__ __forceinline__ void issue_scores(float (&S)[TcCfg<D>::NS], uint32_t q_addr,
                                             uint32_t k_addr) {
  using C = TcCfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / C::PANEL;
    const uint32_t off = (kk * 16 % C::PANEL) * 2;
    mxtt::wgmma_ss(S, mxtt::make_desc(q_addr + p * C::BQ * C::ROWB + off, 16, 8 * C::ROWB, C::SW),
                   mxtt::make_desc(k_addr + p * C::BK * C::ROWB + off, 16, 8 * C::ROWB, C::SW),
                   kk > 0);
  }
}

// O += p_hi v + p_lo v: p from registers, v from shared memory MN-major
template <int D>
__device__ __forceinline__ void issue_pv(float (&O)[TcCfg<D>::NO],
                                         const uint32_t (&ph)[TcCfg<D>::NF][4],
                                         const uint32_t (&pl)[TcCfg<D>::NF][4],
                                         uint32_t v_addr) {
  using C = TcCfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::NF; ++kk) {
    const uint64_t vd = mxtt::make_desc(v_addr + kk * 16 * C::ROWB, C::BK * C::ROWB,
                                        8 * C::ROWB, C::SW);
    mxtt::wgmma_rs_bt(O, ph[kk], vd, 1);
    mxtt::wgmma_rs_bt(O, pl[kk], vd, 1);
  }
}

// Online softmax of one score tile on its accumulator registers: scale into
// the log2 domain, mask (only a tile on the diagonal or the ragged edge),
// new row maxima over the quad, p = 2^(s - m) in place, the row sums l and
// the factors c that rescale what O holds so far.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&S)[NS], bool mask, int k0, int Sk,
                                             int causal, int row_a, int row_b, int qd,
                                             float scale_log2, float& m_a, float& m_b,
                                             float& l_a, float& l_b, float& c_a, float& c_b) {
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = S[i] * scale_log2;
    if (mask) {
      const int col = k0 + 8 * (i / 4) + 2 * qd + (i & 1);
      if (col >= Sk || (causal && col > ((i & 2) ? row_b : row_a))) x = kNegInf;
    }
    S[i] = x;
    if (i & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
  }
  const float mn_a = fmaxf(m_a, quad_max(mx_a));
  const float mn_b = fmaxf(m_b, quad_max(mx_b));
  c_a = mxtt::exp2_approx(m_a - mn_a);
  c_b = mxtt::exp2_approx(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float s_a = 0.f, s_b = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    S[i] = mxtt::exp2_approx(S[i] - ((i & 2) ? mn_b : mn_a));
    if (i & 2) s_b += S[i]; else s_a += S[i];
  }
  l_a = l_a * c_a + s_a;
  l_b = l_b * c_b + s_b;
}

// p as wgmma A fragments, split into bf16 hi and lo parts: for the keys
// 16 * kk .. 16 * kk + 15 the fragment is S[8 * kk .. 8 * kk + 7]
template <int NF>
__device__ __forceinline__ void split_p(const float (&S)[NF * 8], uint32_t (&ph)[NF][4],
                                        uint32_t (&pl)[NF][4]) {
#pragma unroll
  for (int kk = 0; kk < NF; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = S[8 * kk + 2 * r], x1 = S[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kk][r] = mxtt::pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
    }
}

template <int NF>
__device__ __forceinline__ void fence_p(uint32_t (&ph)[NF][4], uint32_t (&pl)[NF][4]) {
#pragma unroll
  for (int kk = 0; kk < NF; ++kk) {
    mxtt::fence_regs(ph[kk]);
    mxtt::fence_regs(pl[kk]);
  }
}

// Scores are tracked in the log2 domain: s2 = (q . k) * scale * log2(e), so
// p = exp2(s2 - m2) = exp(s * scale - m); lse = m2 * ln(2) + log(l).
//
// Persistent: each CTA walks the work items (bh, q tile) t = blockIdx.x,
// blockIdx.x + gridDim.x, ... in the order t -> (bh = t % BH, q tile
// n_qtiles - 1 - t / BH), the longest causal walks first; q is double
// buffered, so the next item's q and first k/v tiles load while this
// item's last tiles and its epilogue run.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_forward_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int BH, int Sq, int Sk, int causal, float scale_log2) {
  using C = TcCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (mxtt::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + 2 * C::Q_BYTES;              // STAGES k tiles
  uint8_t* sv = sk + C::STAGES * C::T_BYTES;      // STAGES v tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + C::STAGES * C::T_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + C::STAGES;

  const int n_qtiles = (Sq + C::BQ - 1) / C::BQ;
  const int n_items = BH * n_qtiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mxtt::mbar_init(&q_full[b], 1);
      mxtt::mbar_init(&q_empty[b], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mxtt::mbar_init(&full[s], 1);
      mxtt::mbar_init(&empty[s], 8);
    }
    mxtt::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread keeps the ring full
    mxtt::setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x, li = 0; t < n_items; t += gridDim.x, ++li) {
        const int bh = t % BH, q0 = (n_qtiles - 1 - t / BH) * C::BQ;
        const int qb = li & 1;
        mxtt::mbar_wait(&q_empty[qb], ((li >> 1) & 1) ^ 1);
        mxtt::mbar_expect_tx(&q_full[qb], C::Q_BYTES);
        for (int p = 0; p < C::NPANEL; ++p)
          mxtt::tma_load_3d(sq + qb * C::Q_BYTES + p * C::BQ * C::ROWB, &qmap, &q_full[qb],
                            p * C::PANEL, q0, bh);
        int n_tiles = (Sk + C::BK - 1) / C::BK;
        if (causal) n_tiles = min(n_tiles, (q0 + C::BQ - 1) / C::BK + 1);
        for (int j = 0; j < n_tiles; ++j) {
          mxtt::mbar_wait(&empty[stage], phase ^ 1);
          mxtt::mbar_expect_tx(&full[stage], 2 * C::T_BYTES);
          for (int p = 0; p < C::NPANEL; ++p) {
            const int off = stage * C::T_BYTES + p * C::BK * C::ROWB;
            mxtt::tma_load_3d(sk + off, &kmap, &full[stage], p * C::PANEL, j * C::BK, bh);
            mxtt::tma_load_3d(sv + off, &vmap, &full[stage], p * C::PANEL, j * C::BK, bh);
          }
          if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }
  mxtt::setmaxnreg_inc<240>();

  // a consumer warpgroup: 64 q rows of each item.  This thread holds rows
  // row_a and row_b = row_a + 8 of them, columns 8 * i + 2 * (lane % 4) +
  // {0, 1} of every 8.  A turn issues S_j = q k_j^T and O += p_{j-1}
  // v_{j-1} together, then runs the softmax of S_j while the second
  // product is still on the tensor cores.  The two warpgroups take turns
  // (named barriers 1 and 2), so one's softmax overlaps the other's
  // products.
  const int wg = warp / 4;
  const int qd = lane % 4;
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  const uint32_t k_base = mxtt::smem_addr(sk), v_base = mxtt::smem_addr(sv);
  float O[C::NO], S[C::NS];
  uint32_t ph[C::NF][4], pl[C::NF][4];
  int stage = 0;
  uint32_t phase = 0;
  if (wg == 1) mxtt::named_arrive(1, 256);  // warpgroup 0 takes the first turn

  for (int t = blockIdx.x, li = 0; t < n_items; t += gridDim.x, ++li) {
    const int bh = t % BH, q0 = (n_qtiles - 1 - t / BH) * C::BQ;
    const bool last_item = t + (int)gridDim.x >= n_items;
    int n_tiles = (Sk + C::BK - 1) / C::BK;
    if (causal) n_tiles = min(n_tiles, (q0 + C::BQ - 1) / C::BK + 1);
    const int wg_first = q0 + 64 * wg;
    const int row_a = wg_first + 16 * (warp % 4) + lane / 4;
    const int row_b = row_a + 8;
    const int qb = li & 1;
    const uint32_t q_addr = mxtt::smem_addr(sq + qb * C::Q_BYTES) + 64 * wg * C::ROWB;
#pragma unroll
    for (int i = 0; i < C::NO; ++i) O[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f, c_a, c_b;
    mxtt::mbar_wait(&q_full[qb], (li >> 1) & 1);

    // tile 0: scores only
    mxtt::mbar_wait(&full[stage], phase);
    mxtt::named_sync(my_turn, 256);
    mxtt::wgmma_fence();
    issue_scores<D>(S, q_addr, k_base + stage * C::T_BYTES);
    mxtt::wgmma_commit();
    mxtt::named_arrive(other_turn, 256);
    mxtt::wgmma_wait<0>();
    mxtt::fence_regs(S);
    softmax_tile(S, C::BK > Sk || (causal && C::BK - 1 > wg_first), 0, Sk, causal, row_a,
                 row_b, qd, scale_log2, m_a, m_b, l_a, l_b, c_a, c_b);
    split_p<C::NF>(S, ph, pl);
    int prev = stage;
    if (++stage == C::STAGES) { stage = 0; phase ^= 1; }

    for (int j = 1; j < n_tiles; ++j) {
      const int k0 = j * C::BK;
      mxtt::mbar_wait(&full[stage], phase);
      mxtt::named_sync(my_turn, 256);
      mxtt::wgmma_fence();
      issue_scores<D>(S, q_addr, k_base + stage * C::T_BYTES);
      mxtt::wgmma_commit();
      issue_pv<D>(O, ph, pl, v_base + prev * C::T_BYTES);
      mxtt::wgmma_commit();
      mxtt::named_arrive(other_turn, 256);
      mxtt::wgmma_wait<1>();
      mxtt::fence_regs(S);
      softmax_tile(S, k0 + C::BK > Sk || (causal && k0 + C::BK - 1 > wg_first), k0, Sk,
                   causal, row_a, row_b, qd, scale_log2, m_a, m_b, l_a, l_b, c_a, c_b);
      mxtt::wgmma_wait<0>();
      mxtt::fence_regs(O);
      fence_p<C::NF>(ph, pl);
      __syncwarp();
      if (lane == 0) mxtt::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < C::NO; ++i) O[i] *= (i & 2) ? c_b : c_a;
      split_p<C::NF>(S, ph, pl);
      prev = stage;
      if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
    }

    // the last tile's p v; then q and the last stage are free
    mxtt::named_sync(my_turn, 256);
    mxtt::wgmma_fence();
    issue_pv<D>(O, ph, pl, v_base + prev * C::T_BYTES);
    mxtt::wgmma_commit();
    if (wg == 0 || !last_item) mxtt::named_arrive(other_turn, 256);
    mxtt::wgmma_wait<0>();
    mxtt::fence_regs(O);
    fence_p<C::NF>(ph, pl);
    __syncwarp();
    if (lane == 0) {
      mxtt::mbar_arrive(&empty[prev]);
      mxtt::mbar_arrive(&q_empty[qb]);
    }

    const float la = fmaxf(quad_sum(l_a), 1e-30f);
    const float lb = fmaxf(quad_sum(l_b), 1e-30f);
    __nv_bfloat16* ob = o + (size_t)bh * Sq * D;
    const float ra = 1.f / la, rb = 1.f / lb;  // one division a row, not D
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * D + col) =
            __floats2bfloat162_rn(O[4 * j] * ra, O[4 * j + 1] * ra);
      if (row_b < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * D + col) =
            __floats2bfloat162_rn(O[4 * j + 2] * rb, O[4 * j + 3] * rb);
    }
    if (qd == 0) {
      if (row_a < Sq) lse[(size_t)bh * Sq + row_a] = m_a * kLn2 + logf(la);
      if (row_b < Sq) lse[(size_t)bh * Sq + row_b] = m_b * kLn2 + logf(lb);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                         int BH, int Sq, int Sk, int causal, float scale,
                         cudaStream_t stream) {
  using C = TcCfg<D>;
  const CUtensorMapSwizzle sw =
      C::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qm, km, vm;
  const uint64_t qdims[3] = {(uint64_t)D, (uint64_t)Sq, (uint64_t)BH};
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)Sk, (uint64_t)BH};
  const uint32_t qbox[3] = {C::PANEL, C::BQ, 1};
  const uint32_t kbox[3] = {C::PANEL, C::BK, 1};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!mxtt::encode_map(&qm, bf, 3, q, qdims, D * 2, (uint64_t)Sq * D * 2, qbox, sw) ||
      !mxtt::encode_map(&km, bf, 3, k, kdims, D * 2, (uint64_t)Sk * D * 2, kbox, sw) ||
      !mxtt::encode_map(&vm, bf, 3, v, kdims, D * 2, (uint64_t)Sk * D * 2, kbox, sw))
    return cudaErrorInvalidValue;
  static uint64_t smem_set = 0;
  const cudaError_t err = mxtt::max_smem_once(flash_forward_wgmma<D>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  static int n_sms = 0;
  if (n_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const long long items = (long long)BH * ((Sq + C::BQ - 1) / C::BQ);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(items < n_sms ? items : n_sms);
  flash_forward_wgmma<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), BH, Sq, Sk,
      causal, scale * kLog2e);
  return cudaSuccess;
}

cudaError_t dispatch_wgmma(int D, const void* q, const void* k, const void* v, void* o,
                           void* lse, int BH, int Sq, int Sk, int causal, float scale,
                           cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;  // TMA reads 16-byte aligned tensors
  switch (D) {
    case 32: return launch_wgmma<32>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 64: return launch_wgmma<64>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32 (the FMA body), 1 bfloat16 (the wgmma body).  Head
// dims 32, 64 and 128.  Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for an unknown dtype code, a shape the
// kernel does not take or a tensor map the driver refuses, or
// cudaErrorMisalignedAddress for bfloat16 inputs not 16-byte aligned.
extern "C" int mxtt_flash_attention_forward(int dtype, const void* q, const void* k,
                                            const void* v, void* o, void* lse, int BH,
                                            int Sq, int Sk, int D, int causal, float scale,
                                            void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(D, q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
  else if (dtype == 1)
    err = dispatch_wgmma(D, q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
