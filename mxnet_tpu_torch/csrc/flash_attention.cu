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
// float32 inputs: an FMA kernel (flash_forward_fma below).  It stays in
// float32 on the FMA pipes: TF32 would round q and k to 10 mantissa bits.
// Bound on this card: the arithmetic, 4*Sq*Sk*D operations per (b, h)
// (half of that causal) at 67 TFLOP/s, 0.128 ms at B=8, H=8, S=1024, D=64
// causal.  What the design does about it (FmaCfg<D> below):
//
// - A CTA of 128 threads (16 row groups of 8 lanes) holds BQ = 128 q rows
//   (64 at D=128) and walks 64-key tiles.  Thread (ty, tx) = (tid / 8,
//   tid % 8) owns q rows ty + 16 i (i < BQ / 16) and, of a score tile,
//   keys tx + 8 j (j < 8): an 8x8 register micro-tile, whose inner loop
//   reads 16 floats of shared memory for 64 FMAs.  Of the output it owns
//   the same rows and columns 4 tx + 32 g + u (u < 4), an 8x8 tile at D=64,
//   whose loop reads p and v at the same rate.  Register-bound: 255 a
//   thread, no spills (chip_smoke.py checks the build log at D=64).
// - k and v tiles arrive by cp.async (16 bytes a copy, zero-filled past
//   Sk) into a ring of 2 stages: tile j + 1 loads while tile j computes,
//   one __syncthreads a tile.  Tiles are row-major as in memory, q and k
//   rows padded to D + 4 floats, so the float4 reads along d of 4 rows
//   (q) or 8 rows (k) of a warp fall in distinct banks; v's float4 reads
//   along a row are conflict-free unpadded.  q is loaded once per work
//   item and pre-scaled by scale * log2(e) as it lands, so the softmax is
//   exp2 of a difference.
// - p = exp2(s - m) moves from the score layout to the output layout
//   through shared memory, 16 keys at a time.  The lanes that hold a row's
//   keys and the lanes that need them are the same warp, so each warp has
//   its own 32 rows of p (padded to 24 floats: conflict-free writes and
//   float4 reads) and a __syncwarp is the only barrier.  The CTA stays at
//   112 KB: two CTAs an SM at D <= 64, each thread at up to 255 registers.
// - The mask (-1e30, as the reference) is applied only on a tile that
//   crosses the causal diagonal or the ragged edge, a branch uniform over
//   the CTA; causal tiles wholly above the diagonal are not visited, and
//   on the last tile of a 128-row item (keys from q0 + 64 on) the products
//   of rows q0 .. q0 + 63, all masked there, are skipped.  The row max
//   reduces over the 8 lanes by 3 shuffles; the row sum stays a per-lane
//   partial until the epilogue.  O is rescaled only when a row max of the
//   warp moved (exact: exp2(0) = 1).
// - Work items (batch*head, q tile) run the longest causal walks first, on
//   a plain grid of one CTA an item: the hardware hands the next item to
//   the first free slot.  A persistent grid of one or two CTAs an SM
//   measured slower at B=8, H=8, S=1024, D=64 (tools/ablate_flash_torch.py).
//   No atomics and a fixed order of every sum, so results repeat bit for
//   bit.
//
// Rows at or past Sq are computed on zeros and not stored, so both bodies
// take any Sq and Sk, where the Pallas kernel needs multiples of its block.
//
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), o (BH, Sq, D) in the input
// type; lse (BH, Sq) float32.  All contiguous, 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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
  switch (D) {
    case 32: return launch_wgmma<32>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 64: return launch_wgmma<64>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// float32 inputs: the FMA body (cp.async ring, 8x8 register micro-tiles;
// see the head of this file)
// ---------------------------------------------------------------------------
template <int D>
struct FmaCfg {
  static constexpr int THREADS = 128;             // 16 row groups of 8 lanes
  static constexpr int BQ = D == 128 ? 64 : 128;  // q rows a CTA
  static constexpr int BK = 64;                   // keys a tile
  static constexpr int RM = BQ / 16;              // q rows a thread
  static constexpr int KN = BK / 8;               // keys a thread, of a tile
  static constexpr int OG = D / 32;               // float4 column groups of o a thread
  static constexpr int QLD = D + 4;               // padded row stride of q and k (floats)
  static constexpr int VLD = D;                   // row stride of v
  static constexpr int CH = D / 4;                // 16-byte pieces a row
  static constexpr int STAGES = 2;
  static constexpr int DU = D == 128 ? 2 : 1;     // unroll of the score loop over d
  static constexpr int PK = 16;                   // keys of p exchanged at a time
  static constexpr int PLD = PK + 8;              // row stride of p (floats)
  static constexpr int WROWS = 4 * RM;            // q rows of a warp
  static constexpr int SMEM =
      (BQ * QLD + STAGES * BK * (QLD + VLD) + THREADS / 32 * WROWS * PLD) * 4;
  static constexpr int MIN_CTAS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;  // CTAs an SM
};

// one k and one v tile of keys k0 .. k0 + BK - 1 into a stage, by cp.async;
// rows at or past Sk are zero-filled (v must be: p = 0 times garbage could
// be NaN)
template <int D>
__device__ __forceinline__ void load_kv_tile(float* sk, float* sv, const float* kb,
                                             const float* vb, int k0, int Sk) {
  using C = FmaCfg<D>;
#pragma unroll
  for (int it = 0; it < C::BK * C::CH / C::THREADS; ++it) {
    const int e = threadIdx.x + it * C::THREADS;
    const int r = e / C::CH, c = e % C::CH;
    const bool ok = k0 + r < Sk;
    const size_t off = (size_t)(ok ? k0 + r : 0) * D + c * 4;
    mxtt::cp_async16(sk + r * C::QLD + c * 4, kb + off, ok);
    mxtt::cp_async16(sv + r * C::VLD + c * 4, vb + off, ok);
  }
}

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

// s = q k^T of one tile for this thread's rows ty + 16 i (i >= I0) and keys
// tx + 8 jj; rows i < I0 are left 0 (the caller masks them)
template <int D, int I0>
__device__ __forceinline__ void score_tile(float (&s)[FmaCfg<D>::RM][FmaCfg<D>::KN],
                                           const float* sq, const float* kt, int ty, int tx) {
  using C = FmaCfg<D>;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int jj = 0; jj < C::KN; ++jj) s[i][jj] = 0.f;
#pragma unroll C::DU
  for (int d = 0; d < D; d += 4) {
    float4 a[C::RM];
#pragma unroll
    for (int i = I0; i < C::RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * C::QLD + d);
#pragma unroll
    for (int jj = 0; jj < C::KN; ++jj) {
      const float4 b = *reinterpret_cast<const float4*>(kt + (tx + 8 * jj) * C::QLD + d);
#pragma unroll
      for (int i = I0; i < C::RM; ++i) {
        s[i][jj] = fmaf(a[i].x, b.x, s[i][jj]);
        s[i][jj] = fmaf(a[i].y, b.y, s[i][jj]);
        s[i][jj] = fmaf(a[i].z, b.z, s[i][jj]);
        s[i][jj] = fmaf(a[i].w, b.w, s[i][jj]);
      }
    }
  }
}

// o += p v over one tile for rows i >= I0.  p moves from the score layout
// (lane tx holds keys tx + 8 jj) to the output layout through this warp's
// rows of shared memory, PK keys at a time: lane (tl, tx) writes its
// keys of rows tl + 4 i, reads 4 keys of a row as one float4.
template <int D, int I0>
__device__ __forceinline__ void pv_tile(float (&acc)[FmaCfg<D>::RM][4 * FmaCfg<D>::OG],
                                        const float (&s)[FmaCfg<D>::RM][FmaCfg<D>::KN],
                                        float* pw, const float* vt, int tl, int tx) {
  using C = FmaCfg<D>;
  constexpr int JP = C::PK / 8;  // score columns jj a round
#pragma unroll
  for (int h = 0; h < C::KN / JP; ++h) {
    __syncwarp();  // the last round's p is read
#pragma unroll
    for (int i = I0; i < C::RM; ++i)
#pragma unroll
      for (int jp = 0; jp < JP; ++jp) pw[(tl + 4 * i) * C::PLD + 8 * jp + tx] = s[i][JP * h + jp];
    __syncwarp();
#pragma unroll
    for (int kc = 0; kc < C::PK; kc += 4) {
      float4 p4[C::RM];
#pragma unroll
      for (int i = I0; i < C::RM; ++i)
        p4[i] = *reinterpret_cast<const float4*>(pw + (tl + 4 * i) * C::PLD + kc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vr = vt + (C::PK * h + kc + kk) * C::VLD + 4 * tx;
#pragma unroll
        for (int g = 0; g < C::OG; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(vr + 32 * g);
#pragma unroll
          for (int i = I0; i < C::RM; ++i) {
            const float p = kk == 0 ? p4[i].x : kk == 1 ? p4[i].y : kk == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * g] = fmaf(p, w.x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(p, w.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, w.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, w.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }
}

// One CTA a work item: CTA t takes (bh = t % BH, q tile n_qtiles - 1 -
// t / BH), the longest causal walks first (kernels/flash_attention.py:
// plan_flash_forward gives the same tiles and order; tests/
// test_torch_flash_f32.py reads them out of this file).
template <int D>
__global__ void __launch_bounds__(FmaCfg<D>::THREADS, FmaCfg<D>::MIN_CTAS)
flash_forward_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int BH, int Sq, int Sk, int causal,
                  float scale_log2) {
  using C = FmaCfg<D>;
  constexpr int RM = C::RM, KN = C::KN, OG = C::OG;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // BQ x QLD: q, pre-scaled
  float* sk = sq + C::BQ * C::QLD;              // STAGES x BK x QLD: k tiles
  float* sv = sk + C::STAGES * C::BK * C::QLD;  // STAGES x BK x VLD: v tiles
  float* sp = sv + C::STAGES * C::BK * C::VLD;  // a warp's WROWS x PLD: p

  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  float* pw = sp + (tid >> 5) * C::WROWS * C::PLD;
  const int n_qtiles = (Sq + C::BQ - 1) / C::BQ;

  const int t = blockIdx.x;
  const int bh = t % BH, q0 = (n_qtiles - 1 - t / BH) * C::BQ;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  int n_tiles = (Sk + C::BK - 1) / C::BK;
  if (causal) n_tiles = min(n_tiles, (q0 + C::BQ - 1) / C::BK + 1);

  load_kv_tile<D>(sk, sv, kb, vb, 0, Sk);
  mxtt::cp_async_commit();
  const float* qb = q + (size_t)bh * Sq * D;
#pragma unroll
  for (int it = 0; it < C::BQ * C::CH / C::THREADS; ++it) {
    const int e = tid + it * C::THREADS;
    const int r = e / C::CH, c = e % C::CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = __ldg(reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * D) + c);
    x.x *= scale_log2;
    x.y *= scale_log2;
    x.z *= scale_log2;
    x.w *= scale_log2;
    *reinterpret_cast<float4*>(sq + r * C::QLD + c * 4) = x;
  }

  float m[RM], l[RM], acc[RM][4 * OG];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // this lane's part of the row sum
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const int k0 = j * C::BK;
    mxtt::cp_async_wait<0>();
    __syncthreads();  // tile j (and q) visible to all; tile j - 1's stage is free
    if (j + 1 < n_tiles)
      load_kv_tile<D>(sk + (st ^ 1) * C::BK * C::QLD, sv + (st ^ 1) * C::BK * C::VLD, kb,
                      vb, k0 + C::BK, Sk);
    mxtt::cp_async_commit();
    const float* kt = sk + st * C::BK * C::QLD;
    const float* vt = sv + st * C::BK * C::VLD;
    // causal, 128 q rows: a tile past row q0 + 63 is wholly masked for
    // rows i < RM / 2 (ty + 16 i < 64), whose products are skipped
    const bool half = RM == 8 && causal && k0 >= q0 + 64;

    float s[RM][KN];
    if (half)
      score_tile<D, RM / 2>(s, sq, kt, ty, tx);
    else
      score_tile<D, 0>(s, sq, kt, ty, tx);

    // the mask, only on a tile that crosses the ragged edge or the diagonal
    if (k0 + C::BK > Sk || (causal && k0 + C::BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < KN; ++jj) {
          const int col = k0 + tx + 8 * jj;
          if (col >= Sk || (causal && col > q0 + ty + 16 * i)) s[i][jj] = kNegInf;
        }
    }

    // online softmax in the log2 domain: p = 2^(s - m) in place
    float corr[RM];
    bool moved = false;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int jj = 1; jj < KN; ++jj) mx = fmaxf(mx, s[i][jj]);
      const float m_new = fmaxf(m[i], group8_max(mx));
      moved |= m_new != m[i];
      corr[i] = mxtt::exp2_approx(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        s[i][jj] = mxtt::exp2_approx(s[i][jj] - m_new);
        sum += s[i][jj];
      }
      l[i] = fmaf(l[i], corr[i], sum);
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < 4 * OG; ++c) acc[i][c] *= corr[i];
    }

    // o += p v
    if (half)
      pv_tile<D, RM / 2>(acc, s, pw, vt, ty & 3, tx);
    else
      pv_tile<D, 0>(acc, s, pw, vt, ty & 3, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + 16 * i;
    const float ls = fmaxf(group8_sum(l[i]), 1e-30f);
    if (r >= Sq) continue;
    const float rl = 1.f / ls;  // one division a row, not D
    float* orow = o + ((size_t)bh * Sq + r) * D + 4 * tx;
#pragma unroll
    for (int g = 0; g < OG; ++g)
      *reinterpret_cast<float4*>(orow + 32 * g) =
          make_float4(acc[i][4 * g] * rl, acc[i][4 * g + 1] * rl, acc[i][4 * g + 2] * rl,
                      acc[i][4 * g + 3] * rl);
    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] * kLn2 + logf(ls);
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, void* lse,
                       int BH, int Sq, int Sk, int causal, float scale,
                       cudaStream_t stream) {
  using C = FmaCfg<D>;
  static uint64_t smem_set = 0;
  const cudaError_t err = mxtt::max_smem_once(flash_forward_fma<D>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const long long items = (long long)BH * ((Sq + C::BQ - 1) / C::BQ);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_forward_fma<D><<<(int)items, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), BH, Sq, Sk, causal, scale * kLog2e);
  return cudaSuccess;
}

cudaError_t dispatch_fma(int D, const void* q, const void* k, const void* v, void* o,
                         void* lse, int BH, int Sq, int Sk, int causal, float scale,
                         cudaStream_t s) {
  switch (D) {
    case 32: return launch_fma<32>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 64: return launch_fma<64>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    case 128: return launch_fma<128>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32 (the FMA body), 1 bfloat16 (the wgmma body).  Head
// dims 32, 64 and 128.
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unknown dtype code, a shape the kernel does
// not take or a tensor map the driver refuses, or cudaErrorMisalignedAddress
// for tensors not 16-byte aligned.
extern "C" int mxtt_flash_attention_forward(int dtype, const void* q, const void* k,
                                            const void* v, void* o, void* lse, int BH,
                                            int Sq, int Sk, int D, int causal, float scale,
                                            void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;  // 16-byte loads, stores and TMA
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_fma(D, q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
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
