// PTX helpers of the wgmma kernels (conv3x3_wgmma.cu and winograd_bf16.cu in
// bf16, conv3x3_tf32x3.cu, winograd_tf32x3.cu, tcn_block_tf32x3.cu,
// tcn_block_train_tf32x3.cu and fusion_tf32x3.cu in fp32,
// conv3x3_s8_wgmma.cu in s8):
// mbarriers (and a wait and an arrive without branches), the copy
// engine's bulk, im2col and tiled copies, shared-memory
// matrix descriptors, the wgmma fences, the split-TF32 rounding, the TF32
// and bf16 wgmma of 64 x 64 and 64 x 128 tiles (and the bf16 one of 64 x 64
// with A in registers), the s8 one of 64 x 128, the im2col tensor map of an
// NHWC activation and a 3-d tiled tensor map, all for sm_90a.  Each
// includer gets its own copies (everything lies in an anonymous namespace).
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
// [coordinate][16 bytes]; each coordinate's pixel is read (ow, oh) further
// (the im2col offsets along W and H)
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           int c, int w, int h, int n,
                                           uint32_t bar, int ow = 0,
                                           int oh = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], "
      "{%7, %8};\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"((uint16_t)ow),
      "h"((uint16_t)oh)
      : "memory");
}

// The box of a 3-d tiled tensor map at the element (c, r, p) on
// (innermost first; zeros where it lies outside the tensor), global ->
// shared in the box's own order
__device__ __forceinline__ void tma_tile3d(uint32_t dst, const CUtensorMap* map,
                                           int c, int r, int p, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(map), "r"(bar), "r"(c), "r"(r), "r"(p)
      : "memory");
}

// A consumer runs these while wgmma are in flight, so they hold no branch
// that ptxas could take for a divergent one (it would wait for the wgmma
// there): the spin loop lies inside the asm, the arrive and the stores are
// predicated.  Measured in turns, 9% less device time over the 12 serving
// blocks of tcn_conv_tf32x3.cuh than mbar_wait, `if (lane == 0)` and a
// loop over tid + 128*k < 2*box (tools/profile_tcn.py's numbers in
// PERF.md).

// mbar_wait as one asm loop; traps after 2^24 polls as mbar_wait does
__device__ __forceinline__ void mbar_wait_uniform(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 16777216;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_if(bool p, uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %0, 0;\n"
      "@q mbarrier.arrive.shared::cta.b64 _, [%1];\n"
      "}\n" ::"r"((int)p),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_if(bool p, uint32_t addr,
                                             float4 v) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %0, 0;\n"
      "@q st.shared.v4.f32 [%1], {%2, %3, %4, %5};\n"
      "}\n" ::"r"((int)p),
      "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
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

// The same for K-major rows of 32 bytes that the copy engine wrote under
// CU_TENSOR_MAP_SWIZZLE_32B (the 16-byte halves of row r swapped where bit 7
// of its address is set): 8-row groups 256 bytes apart.  The swizzle is a
// function of the absolute shared-memory address, for the copy engine and
// wgmma alike: a start address shifted by any number of rows reads them
// right with the base offset left 0 (measured: the base offset (addr >> 7)
// & 7 of the PTX manual read shifted rows wrong).
__device__ __forceinline__ uint64_t make_desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
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

// a rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
__device__ __forceinline__ float to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// d (64 x N, fp32, in the warpgroup's registers) = d * scale_d + A (64 x 8,
// K-major) @ B (8 x N, K-major), both tf32 in shared memory behind
// descriptors; scale_d is 0 (d need not be initialised) or 1.
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 64)
    wgmma_tf32_m64n64k8(d, desc_a, desc_b, scale_d);
  else
    wgmma_tf32_m64n128k8(d, desc_a, desc_b, scale_d);
}

// d (64 x N, fp32, in the warpgroup's registers) = d * scale_d + A (64 x 16,
// K-major) @ B (16 x N, N-major), both bf16 in shared memory behind
// descriptors; scale_d is 0 (d need not be initialised) or 1.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, s32, in the warpgroup's registers) = d * scale_d + A (64 x
// 32, K-major) @ B (32 x 128, K-major), both s8 in shared memory behind
// descriptors (8-bit wgmma takes no other layout); scale_d is 0 (d need
// not be initialised) or 1.  The sums wrap, no saturation.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) += kScaleA * A (64 x 16 bf16, in registers: each
// warp's 16 rows as mma.m16n8k16's A fragment, a[0] (row lane/4, columns
// 2*(lane%4) + {0, 1}), a[1] 8 rows below, a[2] and a[3] 8 columns right)
// @ B (16 x 64, N-major in shared memory behind its descriptor); kScaleA
// is 1 or -1 (the instruction's operand negation, exact)
template <int kScaleA>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kScaleA));
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2],
                                           uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 64)
    wgmma_m64n64k16(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n128k16(d, desc_a, desc_b, scale_d);
}

// An entry of libcuda, looked up by name: the tensor-map encoders live
// there, and the library links no -lcuda.  nullptr if there is none.
void* libcuda_entry(const char* name) {
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
  return lib ? dlsym(lib, name) : nullptr;
}

// The im2col tensor map of x (N, H, W, C), elements of `elem` bytes: kLoad
// consecutive coordinates by `chunk` channels (16 bytes, or 32 under
// `swizzle` CU_TENSOR_MAP_SWIZZLE_32B) a load, walking the
// columns -1 .. W-1, then the rows -1 .. H-1, then the frames: the padded
// line of the kernels' header notes, zeros outside the image.  With
// `stride` 2 and upper corners (upper_w, upper_h) the walk takes every
// other column from -1 to W-1 + upper_w and every other row from -1 to
// H-1 + upper_h (winograd_bf16.cu's extended tile grid); with upper
// corners -1 it takes the columns -1 .. W-2 (stride 1) or every other one
// from -1 (stride 2), the output pixels' filter origins
// (conv3x3_s8_wgmma.cu's per-tap walk).
cudaError_t make_x_map(
    const void* x, int N, int H, int W, int C, CUtensorMapDataType type,
    int elem, int chunk, CUtensorMap* map, int stride = 1, int upper_w = 0,
    int upper_h = 0, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = (Encode)libcuda_entry("cuTensorMapEncodeIm2col");
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * elem,
                                 (cuuint64_t)W * C * elem,
                                 (cuuint64_t)H * W * C * elem};
  const int lower[2] = {-1, -1}, upper[2] = {upper_w, upper_h};
  const cuuint32_t steps[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const CUresult res = encode(
      map, type, 4, (void*)x, dims, strides, lower, upper, chunk, kLoad,
      steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 3-d tiled tensor map of a (planes, rows, C) tensor of `elem`-byte
// elements of `type`, contiguous, C*elem a multiple of 16: boxes of
// box_rows rows by box_c channels (each at most 256; box_c*elem a multiple
// of 16) of one plane, zeros where a box lies outside the tensor (negative
// coordinates included).
cudaError_t make_tile3d_map(const void* t, CUtensorMapDataType type, int elem,
                            int planes, int rows, int C, int box_c,
                            int box_rows, CUtensorMap* map) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = (Encode)libcuda_entry("cuTensorMapEncodeTiled");
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)C * elem,
                                 (cuuint64_t)rows * C * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)box_rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, (void*)t, dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same map of a fp32 tensor, C a multiple of 4: boxes of 4 channels.
cudaError_t make_tile3d_map(const float* t, int planes, int rows, int C,
                            int box_rows, CUtensorMap* map) {
  return make_tile3d_map(t, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, planes, rows,
                         C, 4, box_rows, map);
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
