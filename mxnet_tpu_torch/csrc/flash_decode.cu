// Flash-decode: single-query attention over the block-paged KV cache.
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash_decode.py:_flash_decode_kernel
// (a Pallas program per batch row that walks the row's block table with an
// online softmax).  Here the grid is (B, H): one thread block per (row, head).
// Each block reads table[b, :] and pos[b] itself and loops only over the
// cache blocks j <= pos / BS, so a short sequence reads only its own tokens.
// That is exact: positions > pos would get -1e30, exp(-1e30 - m) is 0 in
// float32, and block 0 of every live row holds position 0.
//
// Per cache block: all threads stage the block's (BS, D) keys and values in
// shared memory, widened to float32 (coalesced loads, several in flight a
// thread); one warp per token computes the score q . k[t]; the block's max
// updates the running max m, and every thread rescales its running sum l
// and its output column o[d] by exp(m_old - m_new) before adding the
// block's terms -- the online-softmax recurrence of the Pallas kernel, with
// m, l and o kept in float32 registers.  The result is o / max(l, 1e-30), as
// in the reference.  Pools of float32 or bfloat16 (and q of either type)
// are widened to float32 on load.
//
// Bound on this card: the cache bytes the call must read,
// 2 * sum_b (pos[b] + 1) * H * D * itemsize, over HBM bandwidth (3.35 TB/s on
// an H100 SXM); the arithmetic (4 flops a cached element) is far below the
// float32 rate.  The grid has B * H blocks: 64 at the slice's B=8, H=8, which
// underfills the 132 SMs at small B.  Splitting the table across blocks with
// a logsumexp combine (split-K flash-decoding) is the known fix and is later
// work.
//
// Layout: q (B, H, D); pools (NB, BS, H, D), token stride H * D; table (B, MB)
// int32; pos (B,) int32; out (B, H, D) in q's type.  All contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TQ, typename TKV>
__global__ void flash_decode_kernel(const TQ* __restrict__ q,
                                    const TKV* __restrict__ k_pool,
                                    const TKV* __restrict__ v_pool,
                                    const int* __restrict__ table,
                                    const int* __restrict__ pos,
                                    TQ* __restrict__ out,
                                    int H, int D, int BS, int MB, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;          // D: this (row, head)'s query, widened
  float* s_s = q_s + D;       // BS: scores of the current cache block
  float* k_s = s_s + BS;      // BS x D: the current cache block's keys
  float* v_s = k_s + BS * D;  // BS x D: and values, widened

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const TQ* qp = q + ((size_t)b * H + h) * D;
  for (int d = tid; d < D; d += blockDim.x) q_s[d] = to_f32(qp[d]);

  const int p = pos[b];
  int nblk = p < 0 ? 0 : p / BS + 1;
  if (nblk > MB) nblk = MB;
  const size_t tok_stride = (size_t)H * D;

  float m = kNegInf;   // running max (same value in every thread)
  float l = 0.f;       // running sum of exp(s - m)
  float acc = 0.f;     // running output column d = tid (threads tid < D)

  for (int j = 0; j < nblk; ++j) {
    const size_t base = (size_t)table[b * MB + j] * BS * tok_stride + (size_t)h * D;
    // stage the block's k and v rows in shared memory: consecutive
    // threads read consecutive elements of a token's D values, and the
    // unrolled loop keeps several loads in flight per thread
#pragma unroll 4
    for (int e = tid; e < BS * D; e += blockDim.x) {
      const int t = e / D;
      const size_t off = base + (size_t)t * tok_stride + (e - t * D);
      k_s[e] = to_f32(k_pool[off]);
      v_s[e] = to_f32(v_pool[off]);
    }
    __syncthreads();
    // scores: one warp per token, lanes split D
    for (int t = warp; t < BS; t += nwarps) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += q_s[d] * k_s[t * D + d];
      part = warp_sum(part);
      if (lane == 0) s_s[t] = (j * BS + t <= p) ? part * scale : kNegInf;
    }
    __syncthreads();

    float m_blk = kNegInf;
    for (int t = 0; t < BS; ++t) m_blk = fmaxf(m_blk, s_s[t]);
    const float m_new = fmaxf(m, m_blk);
    const float c = expf(m - m_new);
    float l_blk = 0.f;
    float o_blk = 0.f;
    for (int t = 0; t < BS; ++t) {
      const float pt = expf(s_s[t] - m_new);
      l_blk += pt;
      if (tid < D) o_blk += pt * v_s[t * D + tid];
    }
    l = l * c + l_blk;
    acc = acc * c + o_blk;
    m = m_new;
    __syncthreads();  // k_s, v_s and s_s are overwritten by the next block
  }
  if (tid < D) store_as(out + ((size_t)b * H + h) * D + tid, acc / fmaxf(l, 1e-30f));
}

// shared memory the kernel needs: q, the scores and one widened k/v block
size_t smem_bytes(int D, int BS) {
  return (size_t)(D + BS + 2 * BS * D) * sizeof(float);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* table,
                   const void* pos, void* out, int B, int H, int D, int BS, int MB,
                   float scale, cudaStream_t stream) {
  int threads = ((D + 31) / 32) * 32;
  if (threads < 256) threads = 256;
  const size_t smem = smem_bytes(D, BS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  flash_decode_kernel<TQ, TKV><<<dim3(B, H), threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<TQ*>(out), H, D, BS, MB, scale);
  return cudaSuccess;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unknown dtype code
// or a shape the kernel does not take (D > 1024, or a k/v block of more
// than the 227 KB of shared memory a block may have).
extern "C" int mxtt_flash_decode(int q_dtype, int kv_dtype, const void* q,
                                 const void* k_pool, const void* v_pool,
                                 const void* table, const void* pos, void* out,
                                 int B, int H, int D, int BS, int MB, float scale,
                                 void* stream) {
  if (D < 1 || D > 1024 || BS < 1 || B < 1 || H < 1 || MB < 1 ||
      smem_bytes(D, BS) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch<float, float>(q, k_pool, v_pool, table, pos, out, B, H, D, BS, MB, scale, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch<float, __nv_bfloat16>(q, k_pool, v_pool, table, pos, out, B, H, D, BS, MB, scale, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch<__nv_bfloat16, float>(q, k_pool, v_pool, table, pos, out, B, H, D, BS, MB, scale, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, table, pos, out, B, H, D, BS, MB, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
