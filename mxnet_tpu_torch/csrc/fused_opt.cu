// Fused optimizer sweep: one elementwise optimizer update over a flat bucket
// of weights, gradients and optimizer state, in place.
//
// Replaces the TPU kernel mxnet_tpu/kernels/fused_opt.py:_sweep_kernel (a
// Pallas program over (rows, 128) sheets of the bucket, with the optimizer's
// update_fn traced into it).  CUDA cannot trace a Python update_fn, so the
// kernel holds one body per elementwise optimizer of the JAX package: SGD
// without and with momentum (ccSGD, and NAG without momentum, are SGD's
// formula), NAG with momentum, Adam, AdamW, AdaGrad, RMSProp (Graves), AdaDelta
// and Test.  The gradient's preprocessing (rescale_grad, then clip_gradient)
// is folded into the same pass.  A grid-stride loop reads 16-byte vectors
// where every buffer the body touches is 16-byte aligned (the tail of n % 4
// elements is done by the first threads of block 0), else single floats.
//
// Rounding: every product, sum, quotient and square root is written with
// its round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), in the order of the plain PyTorch formula
// (mxnet_tpu_torch/optimizer.py, which is the JAX package's), so nvcc
// cannot contract a product and a sum into one fused multiply-add.  Each
// PyTorch operator rounds its result to float32, so every body reproduces
// its plain version bit for bit; the bias corrections 1 - beta^t of Adam
// and AdamW use powf, as PyTorch's float32 pow does on the card.
//
// Bound on this card: the bytes, every buffer the body needs read once and
// the weight and the state it changes written once, over HBM bandwidth
// (3.35 TB/s on an H100 SXM): 3 x 4 bytes an element for SGD and Test,
// 5 x 4 for SGD with momentum, NAG and AdaGrad, 7 x 4 for Adam, AdamW and
// AdaDelta, 9 x 4 for RMSProp.  The arithmetic (about 10 to 30 flops an
// element) is far below the float32 rate.
//
// Layout: w, g, s0, s1, s2 are flat float32 vectors of n elements; the
// states are the optimizer's in its create_state_arrays order (s0 the
// momentum of SGD and NAG, Adam's mean, AdaGrad's history, RMSProp's n,
// AdaDelta's acc_g; s1 Adam's var, RMSProp's g, AdaDelta's acc_delta; s2
// RMSProp's delta).  w and the states a body changes are overwritten.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Opt {
  kSgd = 0,
  kSgdMomentum = 1,
  kAdam = 2,
  kNag = 3,       // NAG with momentum
  kAdamW = 4,
  kAdaGrad = 5,
  kRmsProp = 6,
  kAdaDelta = 7,
  kTest = 8,
  kNumOpts = 9
};

// State vectors a body reads and writes (Test passes its state through).
__host__ __device__ constexpr int states_of(int opt) {
  return opt == kSgd || opt == kTest ? 0
       : opt == kSgdMomentum || opt == kNag || opt == kAdaGrad ? 1
       : opt == kRmsProp ? 3 : 2;
}

struct Hyper {
  float lr, wd, rescale, clip;           // clip < 0: no clipping
  float momentum;                        // SGD, NAG
  float a, one_minus_a;                  // beta1 (Adam, AdamW), gamma1 (RMSProp), rho (AdaDelta)
  float b, one_minus_b;                  // beta2 (Adam, AdamW), gamma2 (RMSProp)
  float eps;                             // epsilon; AdaGrad's float_stable_eps; RMSProp's 1e-4
  float bc1, bc2;                        // 1 - beta^t, set in the kernel
};

template <int OPT>
__device__ __forceinline__ void update(float& w, float g, float& s0, float& s1, float& s2,
                                       const Hyper& h) {
  g = __fmul_rn(g, h.rescale);
  if (h.clip >= 0.f) g = g < -h.clip ? -h.clip : (g > h.clip ? h.clip : g);
  if (OPT == kTest) {
    // w + grad * 1.0 - 0.0 * lr
    w = __fsub_rn(__fadd_rn(w, __fmul_rn(g, 1.f)), __fmul_rn(0.f, h.lr));
    return;
  }
  if (OPT == kAdamW) {
    const float mean = __fadd_rn(__fmul_rn(h.a, s0), __fmul_rn(h.one_minus_a, g));
    const float var = __fadd_rn(__fmul_rn(h.b, s1), __fmul_rn(__fmul_rn(h.one_minus_b, g), g));
    const float mhat = __fdiv_rn(mean, h.bc1);
    const float vhat = __fdiv_rn(var, h.bc2);
    const float r = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
    w = __fsub_rn(w, __fmul_rn(h.lr, __fadd_rn(r, __fmul_rn(h.wd, w))));
    s0 = mean;
    s1 = var;
    return;
  }
  // every other body first adds the weight decay to the gradient
  g = __fadd_rn(g, __fmul_rn(h.wd, w));
  if (OPT == kSgd) {
    w = __fsub_rn(w, __fmul_rn(h.lr, g));
  } else if (OPT == kSgdMomentum) {
    const float m = __fsub_rn(__fmul_rn(h.momentum, s0), __fmul_rn(h.lr, g));
    w = __fadd_rn(w, m);
    s0 = m;
  } else if (OPT == kNag) {
    const float m = __fadd_rn(__fmul_rn(h.momentum, s0), g);
    const float lookahead = __fadd_rn(g, __fmul_rn(h.momentum, m));
    w = __fsub_rn(w, __fmul_rn(h.lr, lookahead));
    s0 = m;
  } else if (OPT == kAdam) {
    const float mean = __fadd_rn(__fmul_rn(h.a, s0), __fmul_rn(h.one_minus_a, g));
    const float var = __fadd_rn(__fmul_rn(h.b, s1), __fmul_rn(__fmul_rn(h.one_minus_b, g), g));
    const float mhat = __fdiv_rn(mean, h.bc1);
    const float vhat = __fdiv_rn(var, h.bc2);
    const float den = __fadd_rn(__fsqrt_rn(vhat), h.eps);
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.lr, mhat), den));
    s0 = mean;
    s1 = var;
  } else if (OPT == kAdaGrad) {
    const float hist = __fadd_rn(s0, __fmul_rn(g, g));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.lr, g), __fsqrt_rn(__fadd_rn(hist, h.eps))));
    s0 = hist;
  } else if (OPT == kRmsProp) {
    // n = (1-g1)*grad*grad + g1*n; g = (1-g1)*grad + g1*g;
    // delta = g2*delta - lr*grad/sqrt(n - g*g + 1e-4); w += delta
    const float n = __fadd_rn(__fmul_rn(__fmul_rn(h.one_minus_a, g), g), __fmul_rn(h.a, s0));
    const float gm = __fadd_rn(__fmul_rn(h.one_minus_a, g), __fmul_rn(h.a, s1));
    const float den = __fsqrt_rn(__fadd_rn(__fsub_rn(n, __fmul_rn(gm, gm)), h.eps));
    const float delta = __fsub_rn(__fmul_rn(h.b, s2), __fdiv_rn(__fmul_rn(h.lr, g), den));
    w = __fadd_rn(w, delta);
    s0 = n;
    s1 = gm;
    s2 = delta;
  } else if (OPT == kAdaDelta) {
    // acc_g = rho*acc_g + (1-rho)*g*g;
    // delta = sqrt(acc_delta + eps) / sqrt(acc_g + eps) * g;
    // acc_delta = rho*acc_delta + (1-rho)*delta*delta; w -= delta
    const float acc_g = __fadd_rn(__fmul_rn(h.a, s0), __fmul_rn(__fmul_rn(h.one_minus_a, g), g));
    const float delta = __fmul_rn(__fdiv_rn(__fsqrt_rn(__fadd_rn(s1, h.eps)),
                                            __fsqrt_rn(__fadd_rn(acc_g, h.eps))), g);
    const float acc_delta = __fadd_rn(__fmul_rn(h.a, s1),
                                      __fmul_rn(__fmul_rn(h.one_minus_a, delta), delta));
    w = __fsub_rn(w, delta);
    s0 = acc_g;
    s1 = acc_delta;
  }
}

__device__ __forceinline__ void bias_corrections(Hyper& h, float t) {
  h.bc1 = __fsub_rn(1.f, powf(h.a, t));
  h.bc2 = __fsub_rn(1.f, powf(h.b, t));
}

template <int OPT>
__device__ __forceinline__ void update_at(float* w, const float* g, float* s0, float* s1,
                                          float* s2, long long i, const Hyper& h) {
  constexpr int S = states_of(OPT);
  float wi = w[i], a = 0.f, b = 0.f, c = 0.f;
  if (S > 0) a = s0[i];
  if (S > 1) b = s1[i];
  if (S > 2) c = s2[i];
  update<OPT>(wi, g[i], a, b, c, h);
  w[i] = wi;
  if (S > 0) s0[i] = a;
  if (S > 1) s1[i] = b;
  if (S > 2) s2[i] = c;
}

template <int OPT>
__global__ void sweep_vec4(float* __restrict__ w, const float* __restrict__ g,
                           float* __restrict__ s0, float* __restrict__ s1,
                           float* __restrict__ s2, long long n, Hyper h, float t) {
  constexpr int S = states_of(OPT);
  if (OPT == kAdam || OPT == kAdamW) bias_corrections(h, t);
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float4* w4 = reinterpret_cast<float4*>(w);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* a4 = reinterpret_cast<float4*>(s0);
  float4* b4 = reinterpret_cast<float4*>(s1);
  float4* c4 = reinterpret_cast<float4*>(s2);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 wv = w4[i];
    const float4 gv = g4[i];
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av, cv = av;
    if (S > 0) av = a4[i];
    if (S > 1) bv = b4[i];
    if (S > 2) cv = c4[i];
    update<OPT>(wv.x, gv.x, av.x, bv.x, cv.x, h);
    update<OPT>(wv.y, gv.y, av.y, bv.y, cv.y, h);
    update<OPT>(wv.z, gv.z, av.z, bv.z, cv.z, h);
    update<OPT>(wv.w, gv.w, av.w, bv.w, cv.w, h);
    w4[i] = wv;
    if (S > 0) a4[i] = av;
    if (S > 1) b4[i] = bv;
    if (S > 2) c4[i] = cv;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4)
    update_at<OPT>(w, g, s0, s1, s2, n4 * 4 + threadIdx.x, h);
}

template <int OPT>
__global__ void sweep_scalar(float* __restrict__ w, const float* __restrict__ g,
                             float* __restrict__ s0, float* __restrict__ s1,
                             float* __restrict__ s2, long long n, Hyper h, float t) {
  if (OPT == kAdam || OPT == kAdamW) bias_corrections(h, t);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    update_at<OPT>(w, g, s0, s1, s2, i, h);
}

template <int OPT>
void launch(float* w, const float* g, float* s0, float* s1, float* s2, long long n,
            const Hyper& h, float t, cudaStream_t stream) {
  constexpr int S = states_of(OPT);
  constexpr int kThreads = 256;
  constexpr long long kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs
  const uintptr_t bits = reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
                         (S > 0 ? reinterpret_cast<uintptr_t>(s0) : 0) |
                         (S > 1 ? reinterpret_cast<uintptr_t>(s1) : 0) |
                         (S > 2 ? reinterpret_cast<uintptr_t>(s2) : 0);
  const bool vec = (bits & 15) == 0;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (vec)
    sweep_vec4<OPT><<<(unsigned)blocks, kThreads, 0, stream>>>(w, g, s0, s1, s2, n, h, t);
  else
    sweep_scalar<OPT><<<(unsigned)blocks, kThreads, 0, stream>>>(w, g, s0, s1, s2, n, h, t);
}

}  // namespace

// opt: the Opt code of the body (kernels/fused_opt.py:sweep_body); s0, s1,
// s2 the state vectors in the optimizer's order, unused ones may be null.
// a/b and their complements are the optimizer's two decay coefficients
// (see Hyper).  Scalars arrive already rounded to float32, as PyTorch rounds
// a Python float against a float32 tensor.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an unknown optimizer code, n < 1
// or a missing state vector.
extern "C" int mxtt_fused_opt_sweep(int opt, void* w, const void* g, void* s0, void* s1,
                                    void* s2, long long n, float lr, float wd, float t,
                                    float rescale, float clip, float momentum, float a,
                                    float one_minus_a, float b, float one_minus_b, float eps,
                                    void* stream) {
  if (n < 1 || opt < 0 || opt >= kNumOpts) return (int)cudaErrorInvalidValue;
  const int S = states_of(opt);
  if ((S > 0 && !s0) || (S > 1 && !s1) || (S > 2 && !s2)) return (int)cudaErrorInvalidValue;
  Hyper h{lr, wd, rescale, clip, momentum, a, one_minus_a, b, one_minus_b, eps, 1.f, 1.f};
  float* wp = static_cast<float*>(w);
  const float* gp = static_cast<const float*>(g);
  float* ap = static_cast<float*>(s0);
  float* bp = static_cast<float*>(s1);
  float* cp = static_cast<float*>(s2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (opt) {
    case kSgd: launch<kSgd>(wp, gp, ap, bp, cp, n, h, t, s); break;
    case kSgdMomentum: launch<kSgdMomentum>(wp, gp, ap, bp, cp, n, h, t, s); break;
    case kAdam: launch<kAdam>(wp, gp, ap, bp, cp, n, h, t, s); break;
    case kNag: launch<kNag>(wp, gp, ap, bp, cp, n, h, t, s); break;
    case kAdamW: launch<kAdamW>(wp, gp, ap, bp, cp, n, h, t, s); break;
    case kAdaGrad: launch<kAdaGrad>(wp, gp, ap, bp, cp, n, h, t, s); break;
    case kRmsProp: launch<kRmsProp>(wp, gp, ap, bp, cp, n, h, t, s); break;
    case kAdaDelta: launch<kAdaDelta>(wp, gp, ap, bp, cp, n, h, t, s); break;
    default: launch<kTest>(wp, gp, ap, bp, cp, n, h, t, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
