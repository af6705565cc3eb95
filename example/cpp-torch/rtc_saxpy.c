/* A runtime-compiled CUDA kernel through the flat C ABI: MXRtcCreate
 * with the body of a CUDA C kernel, out[i] = 2.5f * x[i] + y[i], over
 * parameters named x, y and out, pushed with MXRtcPush at a given size.
 * With the PyTorch port's library (lib/libmxtpu_torch_capi.so) NVRTC
 * compiles the body for sm_90a and it runs on gpu(0).
 *
 * Usage: rtc_saxpy <n> <x.f32> <y.f32> <out.f32>
 *   x.f32, y.f32: n raw float32 each; out.f32 receives n float32.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "mxtpu/c_api.h"

#define CHECK(call) do { \
    if ((call) != 0) { \
      fprintf(stderr, "rtc_saxpy: %s failed: %s\n", #call, \
              MXGetLastError()); \
      return 1; \
    } } while (0)

static const char* kBody =
    "  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
    "  if (i < out_size) out[i] = 2.5f * x[i] + y[i];\n";

static int read_floats(const char* path, float* dst, size_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  size_t got = fread(dst, sizeof(float), n, f);
  int extra = fgetc(f);
  fclose(f);
  return (got == n && extra == EOF) ? 0 : -1;
}

int main(int argc, char** argv) {
  if (argc != 5) {
    fprintf(stderr, "usage: %s <n> <x.f32> <y.f32> <out.f32>\n", argv[0]);
    return 2;
  }
  size_t n = (size_t)strtoull(argv[1], NULL, 10);
  if (n == 0 || n > 0xffffffffu) {
    fprintf(stderr, "rtc_saxpy: n must be in [1, 2^32)\n");
    return 2;
  }
  float* host = (float*)malloc(n * sizeof(float));
  uint32_t shape[1] = {(uint32_t)n};
  NDArrayHandle x, y, out;
  CHECK(MXNDArrayCreate(shape, 1, &x));
  CHECK(MXNDArrayCreate(shape, 1, &y));
  CHECK(MXNDArrayCreate(shape, 1, &out));
  if (read_floats(argv[2], host, n) != 0) {
    fprintf(stderr, "rtc_saxpy: %s must hold %zu float32\n", argv[2], n);
    return 2;
  }
  CHECK(MXNDArraySyncCopyFromCPU(x, host, n));
  if (read_floats(argv[3], host, n) != 0) {
    fprintf(stderr, "rtc_saxpy: %s must hold %zu float32\n", argv[3], n);
    return 2;
  }
  CHECK(MXNDArraySyncCopyFromCPU(y, host, n));

  char* in_names[2] = {(char*)"x", (char*)"y"};
  char* out_names[1] = {(char*)"out"};
  NDArrayHandle ins[2] = {x, y}, outs[1] = {out};
  RtcHandle rtc;
  CHECK(MXRtcCreate((char*)"saxpy", 2, 1, in_names, out_names, ins, outs,
                    (char*)kBody, &rtc));
  const uint32_t block = 256;
  const uint32_t grid = (uint32_t)((n + block - 1) / block);
  CHECK(MXRtcPush(rtc, 2, 1, ins, outs, grid, 1, 1, block, 1, 1));
  CHECK(MXNDArraySyncCopyToCPU(out, host, n));

  FILE* f = fopen(argv[4], "wb");
  if (!f || fwrite(host, sizeof(float), n, f) != n) {
    fprintf(stderr, "rtc_saxpy: cannot write %s\n", argv[4]);
    return 1;
  }
  fclose(f);
  CHECK(MXRtcFree(rtc));
  CHECK(MXNDArrayFree(x));
  CHECK(MXNDArrayFree(y));
  CHECK(MXNDArrayFree(out));
  CHECK(MXNotifyShutdown());
  free(host);
  printf("rtc_saxpy: n %zu grid %u block %u\n", n, grid, block);
  printf("RTC SAXPY OK\n");
  return 0;
}
