// PTX helpers of the two wgmma 3x3 conv kernels (conv3x3_wgmma.cu in bf16,
// conv3x3_tf32x3.cu in fp32): mbarriers, the copy engine's bulk and im2col
// copies, shared-memory matrix descriptors, the wgmma fences, and the im2col
// tensor map of an NHWC activation, all for sm_90a.  Each includer gets its
// own copies (everything lies in an anonymous namespace).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kBM = 256;    // padded coordinates a tile owns
constexpr int kLoad = 128;  // coordinates one TMA load brings
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete.  A copy that never
// completes fails the launch (after seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  unsigned spins = 0;
  do {
    if (++spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) global -> shared by the copy engine; completion
// is counted on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// kLoad consecutive padded coordinates by one 16-byte channel chunk, from
// the coordinate (w, h, n) on (the im2col walk of the tensor map: columns,
// then rows, then frames, zeros outside the image), global -> shared as
// [coordinate][16 bytes]
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           int c, int w, int h, int n,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], "
      "{%7, %8};\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"((uint16_t)0),
      "h"((uint16_t)0)
      : "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// stride between core matrices along K (leading) and along M or N (stride),
// all in units of 16 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int k_stride,
                                              int mn_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((k_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((mn_stride >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The im2col tensor map of x (N, H, W, C), elements of `elem` bytes: kLoad
// consecutive coordinates by `chunk` channels (16 bytes) a load, walking the
// columns -1 .. W-1, then the rows -1 .. H-1, then the frames: the padded
// line of the kernels' header notes, zeros outside the image.
cudaError_t make_x_map(const void* x, int N, int H, int W, int C,
                       CUtensorMapDataType type, int elem, int chunk,
                       CUtensorMap* map) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;  // libcuda's entry, looked up once
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* fn = lib ? dlsym(lib, "cuTensorMapEncodeIm2col") : nullptr;
    if (fn == nullptr) return cudaErrorNotSupported;
    encode = (Encode)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * elem,
                                 (cuuint64_t)W * C * elem,
                                 (cuuint64_t)H * W * C * elem};
  const int lower[2] = {-1, -1}, upper[2] = {0, 0};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, type, 4, (void*)x, dims, strides, lower, upper, chunk, kLoad,
      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The persistent grid: one block for every place the card has for one (the
// occupancy the runtime reports times the SMs), at most one a tile.
// Returns the block count in *blocks, after setting the kernel's dynamic
// shared memory to `bytes`.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t bytes,
                              long long tiles, unsigned* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidValue;
  const long long places = (long long)sms * resident;
  *blocks = (unsigned)(tiles < places ? tiles : places);
  return cudaSuccess;
}

}  // namespace
