// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tile loads, cp.async copies, wgmma fences and shared-memory matrix
// descriptors, and the host-side encoding of TMA tensor maps.  Raw PTX in
// one small header (no CuTe), so a kernel that includes it builds in
// seconds.  The wgmma instructions themselves are in wgmma.cuh.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtt {

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Arrive once and announce the bytes the TMA loads of this phase bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that never completes (a fault in the pipeline's bookkeeping) traps
// after 2^26 polls, seconds at least, so the launch fails with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA: one box of a 2-D or 3-D tensor map into shared memory; completion
// is counted on `bar` in bytes.  Coordinates are in elements, innermost
// first; parts of the box outside the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async: 16 bytes from global into shared memory, through L2 only;
// with `valid` false the 16 bytes are zero-filled and `src` is not read.
// Each thread's copies since its last commit form one group; wait<N>
// returns once at most N of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their uses across this point nor reuse them before it.
// Called on the accumulators and the A fragments right after wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Named barriers 1..15 over `threads` threads (a multiple of 32): sync
// waits for all of them, arrive only counts this warp in.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Hand registers between warpgroups (warp-specialised kernels): the
// producer gives up, the consumers take; every warp of a warpgroup runs it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 2^x on the special-function unit (relative error about 2^-22; 0 for
// x below about -126, as the softmax wants for masked scores)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory swizzle modes of a tile, as TMA writes it and as a wgmma
// descriptor names it: rows of 128 (or 64) bytes whose 16-byte chunks are
// XORed with the row's index within each group of 8 rows.
enum Swizzle { kSwizzle64B = 2, kSwizzle128B = 1 };

// wgmma matrix descriptor: start address, leading and stride byte offsets
// (both in 16-byte units), swizzle mode in bits 62-63.  The tile's swizzle
// atom (8 rows) must start 512- (64B) or 1024-byte (128B) aligned.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, Swizzle sw) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32)
         | ((uint64_t)sw << 62);
}

// bf16 pair (lo in the low half) as one 32-bit register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled reached through the runtime, so nothing links
// against libcuda.  Returns 0 when the driver does not have it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of a row-major tensor of `rank` (2 or 3) dimensions,
// `dims` innermost first, `row_bytes` the byte stride of dimension 1 and
// `plane_bytes` of dimension 2; boxes of `box` elements; zero fill out of
// bounds.  Returns false when the driver refuses it.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                       const void* base, const uint64_t* dims, uint64_t row_bytes,
                       uint64_t plane_bytes, const uint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t gdim[3] = {dims[0], dims[1], rank > 2 ? dims[2] : 1};
  cuuint64_t gstride[2] = {row_bytes, plane_bytes};
  cuuint32_t bdim[3] = {box[0], box[1], rank > 2 ? box[2] : 1};
  cuuint32_t estride[3] = {1, 1, 1};
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), gdim, gstride,
            bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for `kernel`, made once
// for each device: `devices_set` (one per kernel instance) keeps a bit per
// device already set.  Two threads racing set the attribute twice, which is
// harmless.
template <typename Kernel>
inline cudaError_t max_smem_once(Kernel kernel, int bytes, uint64_t& devices_set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (devices_set & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) devices_set |= bit;
  return err;
}

}  // namespace mxtt
