// Flash-attention forward: softmax(q k^T * scale [causal]) v, and the
// per-row logsumexp the backward recomputes from.
//
// Replaces the TPU kernel mxnet_tpu/parallel/ring_attention.py:_flash_kernel
// (a Pallas program per (batch*head, q block) that walks every k block with
// an online softmax in VMEM, and writes o plus the logsumexp broadcast over
// 128 lanes).  Here the grid is (B*H, ceil(Sq/64)): one thread block of 128
// threads holds a 64-row q tile and loops over 64-row k/v tiles staged in
// shared memory.  The statistics m (running max) and l (running sum) and the
// output rows o are float32 registers; lse = m + log(max(l, 1e-30)) is
// written once per row as (B, H, S) float32 -- no lane broadcast.
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
// Bound on this card: the arithmetic, 4*Sq*Sk*D flops per (b, h) (half of
// that causal), on the float32 FMA pipes (67 TFLOP/s on an H100 SXM); the
// bytes (q, k, v, o once each, lse) are far below it at D=64.  This is a
// simple kernel on the FMA pipes: 3 shared float4 loads per 32 FMAs in
// both inner loops.  Tensor cores (wgmma, with TMA loads of the tiles,
// FlashAttention-3 style) are later work.
//
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), o (BH, Sq, D) in the input
// type (float32 or bfloat16, widened to float32 on load); lse (BH, Sq)
// float32.  All contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // q rows per tile
constexpr int kBK = 64;          // k rows per tile
constexpr int kThreads = 128;
constexpr int kLD = kBQ + 4;     // padded stride of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Head dims 32, 64 and 128.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown dtype code or a shape the kernel does
// not take.
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
    err = dispatch<__nv_bfloat16>(D, q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
