// Fused optimizer sweep: one elementwise optimizer update over a flat bucket
// of weights, gradients and optimizer state, in place.
//
// Replaces the TPU kernel mxnet_tpu/kernels/fused_opt.py:_sweep_kernel (a
// Pallas program over (rows, 128) sheets of the bucket, with the optimizer's
// update_fn traced into it).  CUDA cannot trace a Python update_fn, so the
// kernel holds one body per optimizer: SGD without and with momentum, and
// Adam.  The gradient's preprocessing (rescale_grad, then clip_gradient) is
// folded into the same pass.  A grid-stride loop reads 16-byte vectors
// where every buffer is 16-byte aligned (the tail of n % 4 elements is
// done by the first threads of block 0), else single floats.
//
// Rounding: every product, sum, quotient and square root is written with
// its round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), in the order of the plain PyTorch formula
// (mxnet_tpu_torch/optimizer.py, which is the JAX package's), so nvcc
// cannot contract a product and a sum into one fused multiply-add.  Each
// PyTorch operator rounds its result to float32, so the kernel reproduces
// SGD bit for bit; Adam's bias corrections 1 - beta^t use powf, as
// PyTorch's float32 pow does on the card.
//
// Bound on this card: the bytes, every buffer read once and the weight and
// state written once: 5 x 4 bytes an element for SGD with momentum, 7 x 4
// for Adam, 3 x 4 for plain SGD, over HBM bandwidth (3.35 TB/s on an H100
// SXM).  The arithmetic (about 10 to 25 flops an element) is far below the
// float32 rate.
//
// Layout: w, g, s0, s1 are flat float32 vectors of n elements; s0 is the
// momentum (SGD) or the mean (Adam), s1 Adam's variance.  w, s0 and s1 are
// overwritten.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Opt { kSgd = 0, kSgdMomentum = 1, kAdam = 2 };

struct Hyper {
  float lr, wd, rescale, clip;           // clip < 0: no clipping
  float momentum;                        // SGD
  float beta1, one_minus_beta1;          // Adam
  float beta2, one_minus_beta2, eps;
  float bc1, bc2;                        // 1 - beta^t, set in the kernel
};

template <int OPT>
__device__ __forceinline__ void update(float& w, float g, float& s0, float& s1, const Hyper& h) {
  g = __fmul_rn(g, h.rescale);
  if (h.clip >= 0.f) g = g < -h.clip ? -h.clip : (g > h.clip ? h.clip : g);
  g = __fadd_rn(g, __fmul_rn(h.wd, w));
  if (OPT == kSgd) {
    w = __fsub_rn(w, __fmul_rn(h.lr, g));
  } else if (OPT == kSgdMomentum) {
    const float m = __fsub_rn(__fmul_rn(h.momentum, s0), __fmul_rn(h.lr, g));
    w = __fadd_rn(w, m);
    s0 = m;
  } else {
    const float mean = __fadd_rn(__fmul_rn(h.beta1, s0), __fmul_rn(h.one_minus_beta1, g));
    const float var = __fadd_rn(__fmul_rn(h.beta2, s1),
                                __fmul_rn(__fmul_rn(h.one_minus_beta2, g), g));
    const float mhat = __fdiv_rn(mean, h.bc1);
    const float vhat = __fdiv_rn(var, h.bc2);
    const float den = __fadd_rn(__fsqrt_rn(vhat), h.eps);
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.lr, mhat), den));
    s0 = mean;
    s1 = var;
  }
}

__device__ __forceinline__ void bias_corrections(Hyper& h, float t) {
  h.bc1 = __fsub_rn(1.f, powf(h.beta1, t));
  h.bc2 = __fsub_rn(1.f, powf(h.beta2, t));
}

template <int OPT>
__device__ __forceinline__ void update_at(float* w, const float* g, float* s0, float* s1,
                                          long long i, const Hyper& h) {
  float wi = w[i], a = 0.f, b = 0.f;
  if (OPT != kSgd) a = s0[i];
  if (OPT == kAdam) b = s1[i];
  update<OPT>(wi, g[i], a, b, h);
  w[i] = wi;
  if (OPT != kSgd) s0[i] = a;
  if (OPT == kAdam) s1[i] = b;
}

template <int OPT>
__global__ void sweep_vec4(float* __restrict__ w, const float* __restrict__ g,
                           float* __restrict__ s0, float* __restrict__ s1, long long n,
                           Hyper h, float t) {
  if (OPT == kAdam) bias_corrections(h, t);
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float4* w4 = reinterpret_cast<float4*>(w);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* a4 = reinterpret_cast<float4*>(s0);
  float4* b4 = reinterpret_cast<float4*>(s1);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 wv = w4[i];
    const float4 gv = g4[i];
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (OPT != kSgd) av = a4[i];
    if (OPT == kAdam) bv = b4[i];
    update<OPT>(wv.x, gv.x, av.x, bv.x, h);
    update<OPT>(wv.y, gv.y, av.y, bv.y, h);
    update<OPT>(wv.z, gv.z, av.z, bv.z, h);
    update<OPT>(wv.w, gv.w, av.w, bv.w, h);
    w4[i] = wv;
    if (OPT != kSgd) a4[i] = av;
    if (OPT == kAdam) b4[i] = bv;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4)
    update_at<OPT>(w, g, s0, s1, n4 * 4 + threadIdx.x, h);
}

template <int OPT>
__global__ void sweep_scalar(float* __restrict__ w, const float* __restrict__ g,
                             float* __restrict__ s0, float* __restrict__ s1, long long n,
                             Hyper h, float t) {
  if (OPT == kAdam) bias_corrections(h, t);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    update_at<OPT>(w, g, s0, s1, i, h);
}

template <int OPT>
void launch(float* w, const float* g, float* s0, float* s1, long long n, const Hyper& h,
            float t, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr long long kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs
  const uintptr_t bits = reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
                         (OPT != kSgd ? reinterpret_cast<uintptr_t>(s0) : 0) |
                         (OPT == kAdam ? reinterpret_cast<uintptr_t>(s1) : 0);
  const bool vec = (bits & 15) == 0;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (vec)
    sweep_vec4<OPT><<<(unsigned)blocks, kThreads, 0, stream>>>(w, g, s0, s1, n, h, t);
  else
    sweep_scalar<OPT><<<(unsigned)blocks, kThreads, 0, stream>>>(w, g, s0, s1, n, h, t);
}

}  // namespace

// opt: 0 SGD, 1 SGD with momentum (s0 = momentum), 2 Adam (s0 = mean,
// s1 = var); unused state pointers may be null.  Scalars arrive already
// rounded to float32, as PyTorch rounds a Python float against a float32
// tensor.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown optimizer code or n < 1.
extern "C" int mxtt_fused_opt_sweep(int opt, void* w, const void* g, void* s0, void* s1,
                                    long long n, float lr, float wd, float t, float rescale,
                                    float clip, float momentum, float beta1,
                                    float one_minus_beta1, float beta2,
                                    float one_minus_beta2, float eps, void* stream) {
  if (n < 1 || opt < 0 || opt > 2) return (int)cudaErrorInvalidValue;
  Hyper h{lr, wd, rescale, clip, momentum, beta1, one_minus_beta1,
          beta2, one_minus_beta2, eps, 1.f, 1.f};
  float* wp = static_cast<float*>(w);
  const float* gp = static_cast<const float*>(g);
  float* ap = static_cast<float*>(s0);
  float* bp = static_cast<float*>(s1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (opt == kSgd)
    launch<kSgd>(wp, gp, ap, bp, n, h, t, s);
  else if (opt == kSgdMomentum)
    launch<kSgdMomentum>(wp, gp, ap, bp, n, h, t, s);
  else
    launch<kAdam>(wp, gp, ap, bp, n, h, t, s);
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
