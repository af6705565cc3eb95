// Flash-decode: single-query attention over the block-paged KV cache, with
// each row's keys split across thread blocks (flash-decoding), in one launch.
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash_decode.py:_flash_decode_kernel
// (a Pallas program per batch row that walks the row's block table with an
// online softmax).  It computes decode_attention_reference: positions > pos
// take no part (the reference gives them -1e30, whose exp is 0 in float32
// once a real score sets the max, and position 0 is always real), the result
// is o / max(l, 1e-30), q and the pools are float32 or bfloat16 each, widened
// to float32; the output has q's type.
//
// Bound on this card: the cache bytes the call must read,
// 2 * sum_b (pos[b] + 1) * H * D * itemsize, over HBM bandwidth; the
// arithmetic (4 flops a cached element) is far below any peak.  At the
// serving shapes that is a few microseconds, so the design is about having
// enough loads in flight on every SM:
//
// - Grid (splits, H, B).  Each thread block (CTA) of 128 threads takes
//   `blocks_per_split` cache blocks of one row for one head and computes
//   the partial (m, l, o) of that span.  The grid comes from the shapes
//   alone (kernels/flash_decode.py:plan_flash_decode), never from pos,
//   which lives on the card.  A CTA whose span starts past pos[b] is
//   dead: it writes m = -1e30, l = 0 and no o.  A live CTA reads only the
//   tokens <= pos[b] of its span.
// - A row with pos < 0 (the engine never passes one) gets what the
//   reference and its Pallas kernel give: every slot is masked alike, so
//   every slot weighs exp2(0) = 1 and the result is the mean of v over the
//   row's MB * BS slots.  Each of its CTAs takes its whole span and sets
//   every score to -1e30.  Table entries are clamped into [0, NB), as the
//   reference's gather clamps, so no table entry reads outside the pool.
// - Inside a CTA, a group of G lanes (G a power of two, at most a warp)
//   takes one token at a time: lane j holds elements of 16-byte
//   pieces j, j + G, ... of the head's D values, loaded with one 16-byte
//   load each, straight into registers (q too, pre-scaled by
//   scale * log2(e) so the softmax uses exp2f).  The score is a sum over
//   the group by warp shuffles; each group runs its own online softmax over
//   a stride of the span's tokens, eight tokens (sixteen 16-byte loads a
//   lane) in flight at a time.  The groups' states meet in shared memory in a
//   fixed order.
// - One launch: the last CTA of each (row, head) to finish combines
//   the partials.  Each CTA writes its partials, fences, and adds one to a
//   per-(row, head) counter; the CTA that sees splits - 1 combines them in split
//   order, skipping dead splits (l = 0: their o is never read, so an
//   uninitialised workspace cannot make a NaN), and puts the counter back
//   to 0, so the counters need no clearing launch.  The combine's order is
//   fixed, so results repeat bit for bit from run to run.
// - Concurrent calls: the wrapper keeps one workspace and one counter
//   buffer per (device, stream), so calls on two streams never share
//   them, and calls on one stream run one after another.  A CUDA graph
//   that captures a call keeps the pointers of its capture stream's
//   buffers: two replays of it, or of two graphs captured on one stream,
//   must not run at once (give each graph its own capture stream).
// - A D * itemsize that is not a multiple of 16, or a pool that does not
//   start on a 16-byte boundary, takes element loads in the same kernel.
//
// Layout: q (B, H, D); pools (NB, BS, H, D), token stride H * D; table (B, MB)
// int32; pos (B,) int32; out (B, H, D) in q's type.  All contiguous.
// Workspace: o (B, H, splits, D), then m and l (B, H, splits), float32.
// Counters: (B, H) int32, all 0 between calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // threads a CTA, all on one (row, head)

// elements of T in one 16-byte piece
template <typename T> struct Piece;
template <> struct Piece<float> { static constexpr int N = 4; };
template <> struct Piece<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The 16 bytes holding elements [d0, d0 + N) of a row, zero where d >= D:
// one 16-byte load when `vec` (then D is a multiple of N and the row is
// 16-byte aligned), else element loads.
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* row, int d0, int D, bool vec) {
  constexpr int N = Piece<T>::N;
  if (vec) {
    if (d0 < D) return __ldg(reinterpret_cast<const uint4*>(row + d0));
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (N == 4) {
    const unsigned int* r = reinterpret_cast<const unsigned int*>(row);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < D) w[e] = __ldg(r + d0 + e);
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (d0 + e < D) w[e >> 1] |= (uint32_t)__ldg(r + d0 + e) << ((e & 1) * 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a piece's elements widened to float32 (bfloat16 is the top half of a float)
template <typename T>
__device__ __forceinline__ void widen(uint4 p, float* x) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
  if constexpr (Piece<T>::N == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(w[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// sum over the G lanes of a group (G a power of two <= 32, the same in
// every lane: each shuffle runs in all lanes of the warp or in none)
__device__ __forceinline__ float group_sum(float v, int G) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < G) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NV: 16-byte pieces a lane holds of one head's D values (1, or 2 for a
// float32 pool with D > 128)
template <typename TQ, typename TKV, int NV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const int* __restrict__ table,
                    const int* __restrict__ pos, TQ* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int H, int D, int BS, int MB, int NB, int bps, int G, bool vec,
                    float scale_log2) {
  constexpr int N = Piece<TKV>::N;
  constexpr int E = NV * N;  // elements a lane holds
  constexpr int kTokens = 8 / NV;  // tokens a group has in flight
  extern __shared__ float smem[];
  __shared__ int s_last;

  const int splits = gridDim.x;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ngroups = kThreads / G;
  const int gid = tid / G, lg = tid % G;  // group gid takes tokens gid, gid + ngroups, ...

  float* s_o = smem;                   // ngroups x D: each group's o
  float* s_m = s_o + ngroups * D;      // ngroups: its m
  float* s_l = s_m + ngroups;          // ngroups: its l
  int* s_tab = reinterpret_cast<int*>(s_l + ngroups);  // bps: the span's table

  // pos, the span's table slots and q are loaded together, before
  // anything waits on one of them
  const int t_begin = split * bps * BS;
  for (int j = tid; j < bps && split * bps + j < MB; j += kThreads)
    s_tab[j] = min(max(table[(size_t)b * MB + split * bps + j], 0), NB - 1);
  const int p = pos[b];
  const bool all_masked = p < 0;  // every slot of the row, each scoring -1e30
  float qr[E], o[E];
  const TQ* qp = q + ((size_t)b * H + h) * D;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int d = (c * G + lg) * N + e;
      qr[c * N + e] = d < D ? to_f32(qp[d]) * scale_log2 : 0.f;
      o[c * N + e] = 0.f;
    }
  const int span_end = min(t_begin + bps * BS, MB * BS);
  const int t_end = all_masked ? span_end : min(span_end, p + 1);
  const bool live = t_begin < t_end;

  const size_t row = (size_t)b * H + h;  // this (row, head)
  const size_t part = row * splits + split;
  float* ws_o = ws;
  float* ws_m = ws + (size_t)gridDim.z * H * splits * D;
  float* ws_l = ws_m + (size_t)gridDim.z * H * splits;

  if (live) {
    float m = kNegInf, l = 0.f;
    __syncthreads();  // s_tab

    const size_t tok_stride = (size_t)H * D;
    const size_t head_off = (size_t)h * D;
    // the same trip count in every group of the warp (the shuffles)
    for (int base = t_begin; base < t_end; base += kTokens * ngroups) {
      uint4 kr[kTokens][NV], vr[kTokens][NV];
#pragma unroll
      for (int u = 0; u < kTokens; ++u) {
        const int t = base + gid + u * ngroups;
        if (t < t_end) {
          const int blk = s_tab[(t - t_begin) / BS];
          const size_t off = ((size_t)blk * BS + t % BS) * tok_stride + head_off;
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            kr[u][c] = load_piece(k_pool + off, (c * G + lg) * N, D, vec);
            vr[u][c] = load_piece(v_pool + off, (c * G + lg) * N, D, vec);
          }
        } else {
#pragma unroll
          for (int c = 0; c < NV; ++c)
            kr[u][c] = vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float s[kTokens];
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kTokens; ++u) {
        float part_s = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float x[N];
          widen<TKV>(kr[u][c], x);
#pragma unroll
          for (int e = 0; e < N; ++e) part_s = fmaf(qr[c * N + e], x[e], part_s);
        }
        const float dot = group_sum(part_s, G);
        s[u] = all_masked ? kNegInf : dot;
        if (base + gid + u * ngroups < t_end) m_new = fmaxf(m_new, s[u]);
      }
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < E; ++i) o[i] *= corr;
#pragma unroll
      for (int u = 0; u < kTokens; ++u) {
        const float pu = base + gid + u * ngroups < t_end ? exp2f(s[u] - m_new) : 0.f;
        l += pu;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float x[N];
          widen<TKV>(vr[u][c], x);
#pragma unroll
          for (int e = 0; e < N; ++e) o[c * N + e] = fmaf(pu, x[e], o[c * N + e]);
        }
      }
      m = m_new;
    }

    // the groups' states in shared memory, then the CTA's (m, l, o)
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int d = (c * G + lg) * N + e;
        if (d < D) s_o[gid * D + d] = o[c * N + e];
      }
    if (lg == 0) {
      s_m[gid] = m;
      s_l[gid] = l;
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float M = kNegInf;
      for (int g = 0; g < ngroups; ++g) M = fmaxf(M, s_m[g]);
      float L = 0.f, O = 0.f;
      for (int g = 0; g < ngroups; ++g) {
        const float w = exp2f(s_m[g] - M);
        L = fmaf(s_l[g], w, L);
        O = fmaf(s_o[g * D + d], w, O);
      }
      if (splits == 1) {
        store_as(out + row * D + d, O / fmaxf(L, 1e-30f));
      } else {
        ws_o[part * D + d] = O;
        if (d == 0) {
          ws_m[part] = M;
          ws_l[part] = L;
        }
      }
    }
  } else if (splits == 1) {
    for (int d = tid; d < D; d += kThreads) store_as(out + row * D + d, 0.f);
  } else if (tid == 0) {
    ws_m[part] = kNegInf;
    ws_l[part] = 0.f;
  }
  if (splits == 1) return;

  // signal; the last CTA of this (row, head) combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + row;
    const int ticket = atomicAdd(counter, 1);
    s_last = ticket == splits - 1;
    if (s_last) *counter = 0;  // every split has arrived: ready for the next call
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  // the splits' m and l in shared memory (s_o is free again), the first
  // warp turns them into weights exp2(m - M), 0 for a dead split, and L;
  // then each thread sums one column of o over the live splits
  float* c_w = s_o;            // splits: weights
  float* c_l = c_w + splits;   // splits: l, then L at [0]
  const size_t first = row * splits;
  for (int i = tid; i < splits; i += kThreads) {
    const float ls = __ldcg(ws_l + first + i);
    c_l[i] = ls;
    c_w[i] = ls > 0.f ? __ldcg(ws_m + first + i) : kNegInf;
  }
  __syncthreads();
  if (tid < 32) {
    float M = kNegInf;
    for (int sp = tid; sp < splits; sp += 32) M = fmaxf(M, c_w[sp]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int sp = tid; sp < splits; sp += 32) {
      const float wt = c_l[sp] > 0.f ? exp2f(c_w[sp] - M) : 0.f;
      L = fmaf(c_l[sp], wt, L);
      c_w[sp] = wt;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    __syncwarp();
    if (tid == 0) c_l[0] = L;
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    const float* o_col = ws_o + first * D + d;
    float O = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      O = fmaf(c_w[sp] > 0.f ? __ldcg(o_col + (size_t)sp * D) : 0.f, c_w[sp], O);
    store_as(out + row * D + d, O / fmaxf(c_l[0], 1e-30f));
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// lanes that share a query row: D / N 16-byte pieces, rounded up to a power
// of two, at most a warp
int lane_group(int D, int N) {
  const int pieces = (D + N - 1) / N;
  return pieces < 32 ? pow2_at_least(pieces) : 32;
}

// the dynamic shared memory of a launch: each lane group's o, m and l, or the
// splits' weights, and the span's table slots
size_t launch_smem(int D, int G, int MB, int bps) {
  const int splits = (MB + bps - 1) / bps;
  const int ngroups = kThreads / G;
  const int tile = ngroups * D > 2 * splits ? ngroups * D : 2 * splits;
  return (size_t)(tile + 2 * ngroups) * sizeof(float) + bps * sizeof(int);
}

template <typename TQ, typename TKV, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* table,
                   const void* pos, void* out, void* ws, void* counters, int B,
                   int H, int D, int BS, int MB, int NB, int bps, int G, bool vec,
                   float scale, cudaStream_t stream) {
  const int splits = (MB + bps - 1) / bps;
  const size_t smem = launch_smem(D, G, MB, bps);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  flash_decode_kernel<TQ, TKV, NV><<<dim3(splits, H, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(table), static_cast<const int*>(pos), static_cast<TQ*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, D, BS, MB, NB, bps, G,
      vec, scale * kLog2e);
  return cudaSuccess;
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* table,
                     const void* pos, void* out, void* ws, void* counters, int B, int H,
                     int D, int BS, int MB, int NB, int bps, float scale,
                     cudaStream_t stream) {
  constexpr int N = Piece<TKV>::N;
  const int pieces = (D + N - 1) / N;
  const int G = lane_group(D, N);
  const int nv = (pieces + G - 1) / G;
  const bool vec = (D * sizeof(TKV)) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (nv == 1)
    return launch<TQ, TKV, 1>(q, k, v, table, pos, out, ws, counters, B, H, D, BS, MB, NB,
                              bps, G, vec, scale, stream);
  if constexpr (N == 4) {
    if (nv == 2)
      return launch<TQ, TKV, 2>(q, k, v, table, pos, out, ws, counters, B, H, D, BS, MB,
                                NB, bps, G, vec, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  NB: the pools' blocks, which table
// entries are clamped to.  `ws` holds B * H * splits * (D + 2) floats and
// `counters` B * H int32 zeros, where splits = ceil(MB / blocks_per_split);
// both may be null when splits is 1.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unknown dtype code
// or a shape the kernel does not take (D outside 1..256).
extern "C" int mxtt_flash_decode(int q_dtype, int kv_dtype, const void* q,
                                 const void* k_pool, const void* v_pool,
                                 const void* table, const void* pos, void* out,
                                 void* ws, void* counters, int B, int H, int D,
                                 int BS, int MB, int NB, int blocks_per_split,
                                 float scale, void* stream) {
  if (D < 1 || D > 256 || BS < 1 || B < 1 || H < 1 || MB < 1 || NB < 1 ||
      blocks_per_split < 1 ||
      B > 65535 || H > 65535 ||
      (blocks_per_split < MB && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MXTT_FD_ARGS q, k_pool, v_pool, table, pos, out, ws, counters, B, H, D, BS, MB, \
                     NB, blocks_per_split, scale, s
  if (q_dtype == 0 && kv_dtype == 0)
    err = dispatch<float, float>(MXTT_FD_ARGS);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = dispatch<float, __nv_bfloat16>(MXTT_FD_ARGS);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = dispatch<__nv_bfloat16, float>(MXTT_FD_ARGS);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(MXTT_FD_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef MXTT_FD_ARGS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) a launch with these arguments passes
// (kv_dtype and blocks_per_split as for mxtt_flash_decode), or -1 for an
// unknown dtype code.  The static analyzer's launch spec of the kernel is
// held to this number on the card.
extern "C" int mxtt_flash_decode_smem(int kv_dtype, int D, int MB, int blocks_per_split) {
  if ((kv_dtype != 0 && kv_dtype != 1) || D < 1 || MB < 1 || blocks_per_split < 1) return -1;
  const int N = kv_dtype == 0 ? Piece<float>::N : Piece<__nv_bfloat16>::N;
  return (int)launch_smem(D, lane_group(D, N), MB, blocks_per_split);
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
