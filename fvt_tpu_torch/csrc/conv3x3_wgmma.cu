// 3x3 stride-1 pad-1 convolution, NHWC, no bias, bf16 in, fp32 sums, bf16
// out, as an implicit GEMM on Hopper's warpgroup matrix multiply (sm_90a).
//
// Replaces fvt_tpu/ops/conv_pallas.py::_conv3x3_kernel (the Pallas kernel
// behind conv3x3_pallas) for bf16 tensors, the type the JAX package hands it
// under --amp: y[n, i, j, :] = sum over the nine taps (dy, dx) of
// x[n, i + dy - 1, j + dx - 1, :] @ w[dy*3 + dx], x zero outside the image,
// the nine products summed in fp32 and rounded to bf16 once at the store.
// x (N, H, W, C), w (9, C, Co), y (N, H, W, Co).  conv3x3_tf32x3.cu is the
// route for fp32 tensors; the PTX helpers both use are in wgmma_common.cuh.
//
// What bounds it.  At the ArcFace shapes (N = 2400; 40x40x64 to 5x5x512) a
// conv is 2*9*C*Co operations a pixel against (C + Co)*2 bytes: 576 to 4608
// operations a byte, above the card's 295, so the tensor cores bound it
// (0.29 ms for the 283 GFLOP of a Cin = Cout conv) except at 40x40x64, where
// the 983 MB of x and y take as long.  Only wgmma reaches that rate.
//
// The design.  All frames lie in one padded line: pixel (f, i, j) has the
// coordinate q = f*(H+1)*(W+1) + (i+1)*(W+1) + (j+1), and every q whose row
// or column part is 0 is a zero.  One zero column serves as the right halo
// of a row and the left halo of the next, one zero row as the bottom halo of
// a frame and the top halo of the next, so the neighbour (dy, dx) of q is
// q + (dy-1)*(W+1) + (dx-1) for every pixel, at the image's edges too.  A
// tile is 256 consecutive q (any H and W, frames batched by construction, no
// ragged tile) by BN = 64 or 128 output channels; a warpgroup holds 64 rows
// x BN sums of it in registers per m64nBNk16 (32 or 64 registers a thread).
// Per 16-channel slice the 256 + 2*(W+1) + 2 coordinates the tile needs are
// staged ONCE, as [8-channel chunk][coordinate][8 bf16]: eight consecutive
// coordinates are one 8x16-byte core matrix of wgmma's unswizzled K-major
// layout, so the A operand of tap (dy, dx) is the same staged patch at a
// start address (dy*(W+1) + dx)*16 bytes further: nine descriptor offsets,
// not nine copies.  The sums at pad coordinates are computed and dropped by
// the store: (H+1)(W+1)/(HW) of the multiplies, 1.05x at 40x40, 1.21x at
// 10x10 and 1.44x at 5x5.
//
// Staging is the copy engine's (TMA), not the threads': on this card 16-byte
// cp.async copies by 512 threads filled a slice four times slower than the
// tensor cores emptied it.  The padded line is exactly the walk of an im2col
// tensor map over x with the corners (-1, -1) and (0, 0): columns -1 .. W-1,
// then rows -1 .. H-1, then frames, zeros outside the image, so a load of 128
// consecutive coordinates by 8 channels lands as 128 core-matrix rows (no
// padded copy of x in device memory).  The slice's weights for all nine taps
// are ONE contiguous bulk copy: the caller packs w once into the N-major
// core matrices the instruction's transposed-B form reads, per (column tile,
// slice) (see fvt_conv3x3_bf16_forward).  Both are counted on the ring
// slot's mbarrier.
//
// The grid is persistent: one block for every place the card has, each
// walking the tiles from its own index in steps of the grid, so that
// neighbours in time share an x tile and the weights (4.7 MB at C = Co = 512)
// stay in L2.  A block is a producer warp, which alone starts copies, and
// the consumer warpgroups, which alone multiply; between them a ring of
// three slots, each with a `full` mbarrier (the copies count on it) and an
// `empty` one (every consumer warp arrives after its wgmma of the slice have
// been waited for).  The producer runs up to three slices ahead, across the
// tiles' borders, so a tile's first slices land while the tile before is
// still multiplied and stored: with one tile a block, the first copies and
// the stores were in the open, a tenth of the time over a forward's 45
// convs on an H100 (a tile has only 4 slices at 40x40x64).  The sums leave
// through 16 staged rows of the warp's own, outside the ring, so that y is
// written 16 bytes a thread, a row's BN channels side by side (4-byte stores
// from the accumulator layout were a loss of their own) and no consumer
// waits for another.  At Co <= 64 (BN = 64) a block is two warpgroups of two
// 64-row sub-tiles each, so that two blocks share an SM and one's stores
// hide under the other's products; at BN = 128 four warpgroups of one
// sub-tile fill the SM.
//
// What is left: the products alone (no staging) run at 65-80% of the
// tensor peak here, by shape, pad rows counted, and the pads cost 1.05-1.44x
// of that; with the copies the kernel is about a seventh slower than the
// products alone at the deep shapes (they share the shared memory's bandwidth: an m64n128k16
// reads 6 KB of operands in its 64 cycles).  Next are clusters with multicast
// weights, 256 columns an instruction (setmaxnreg for the producer),
// 128-byte-swizzled operands, and smaller tiles for the last wave.
//
// The same kernel runs the fused BottleneckIR block on bf16 tensors (B5
// under --amp; replaces fvt_tpu/ops/bottleneck_pallas.py::_block_kernel, the
// Pallas kernel behind bottleneck_ir_fused, on bf16 arrays) as two launches,
// fvt_bottleneck_bf16_forward, the design of the fp32 block on
// conv3x3_tf32x3.cu: the block's elementwise work rides where values
// already pass through a thread, chosen at compile time (the plain conv
// takes neither and is the code it was).  The Pallas kernel's rounding
// points are the contract:
// - prologue kBn1.  Here the operands go from the copy engine straight to
//   wgmma, so this is a pass of its own: after a slot's `full` barrier the
//   consumer threads rewrite the staged x as bf16(a1[c]*x + b1[c]), the
//   affine in fp32 and one rounding, at image pixels, and write exact 0 at
//   every other coordinate (bn1 comes before conv1's zero pad: the image
//   border, the pad row two frames share, past the last frame); then
//   fence.proxy.async, so that wgmma's async proxy sees the writes, and a
//   named barrier of the consumers only (the producer warp runs on), so
//   that none multiplies a patch another is still writing.  A thread takes
//   one 8-channel chunk (warpgroup parity) and the coordinates of a fixed
//   stride in it, and tests which of its coordinates are pixels once a
//   tile.
// - the block's vectors (a1, b1, alpha or a2, b2; at most 6 KB) are copied
//   into shared memory beside the ring once, when the block starts: a warp
//   reads one chunk's values at one address, a broadcast, and no thread
//   holds them across a slice (in registers beside the accumulators they
//   spilled).
// - epilogue kPrelu, in the store: conv1's fp32 sums through PReLU
//   unrounded (alpha[n]*acc where acc <= 0), then v rounded to bf16 once.
// - epilogue kBn2Residual, in the store: (acc*a2[n] + b2[n]) + x at the
//   output's own index (C = Co), all in fp32, rounded to bf16 once.
// The affines round the product and the sum apart (__fmul_rn, __fadd_rn),
// in the plain version's order.  conv1 writes v (bf16) to device memory and
// conv2 stages it as any conv stages x; the copy engine's zero fill is
// conv2's pad.  The fp32 sums of a tile stay in one accumulator over the
// slices, as in the plain conv: bf16's rounding of v and y (2^-8) is far
// above wgmma's fp32 accumulation error.
//
// Two build switches split the time for tools/profile_conv_bf16.py, and give
// wrong sums: -DFVT_DIAG_PRODUCTS_ONLY starts no copy and waits for none,
// -DFVT_DIAG_COPIES_ONLY runs the wgmma of the first slice only.

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kKC = 16;  // input channels a slice (one k16 step)

// What a launch does besides the conv (the header note)
enum Prologue { kNoPrologue, kBn1 };
enum Epilogue { kStore, kPrelu, kBn2Residual };

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;  // packed: see fvt_conv3x3_bf16_forward
  __nv_bfloat16* y;
  int N, H, W, C, Co;
  int P;        // staged coordinates a tile: kBM + 2*(W+1) + 2, up to kLoad
  long long Q;  // padded coordinates in all: N*(H+1)*(W+1)
  int n_tiles;  // column tiles: ceil(Co / BN)
  int tiles;    // row tiles (kBM coordinates each) times column tiles
  // read only by the instantiations that use them (fp32 vectors)
  const float* a1;     // kBn1: bn1's affine (C)
  const float* b1;
  const float* alpha;  // kPrelu: the slopes (Co)
  const float* a2;     // kBn2Residual: bn2's affine (Co) and the residual,
  const float* b2;     // shaped as y
  const __nv_bfloat16* res;
};

// a*x + b, rounded after the product and after the sum (no FMA)
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// 8 bf16 of a staged 16-byte row through bn1: a1*v + b1 in fp32 with the
// chunk's 8 values of a1 at m and of b1 at b (shared memory), rounded once
__device__ __forceinline__ uint4 bn1_row(uint4 raw, const float* m,
                                         const float* b) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // four channels at a time
    const float4 mv = *reinterpret_cast<const float4*>(m + 4 * h);
    const float4 bv = *reinterpret_cast<const float4*>(b + 4 * h);
    const float2 v0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[2 * h]));
    const float2 v1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[2 * h + 1]));
    const __nv_bfloat162 o0 = __floats2bfloat162_rn(
        affine(v0.x, mv.x, bv.x), affine(v0.y, mv.y, bv.y));
    const __nv_bfloat162 o1 = __floats2bfloat162_rn(
        affine(v1.x, mv.z, bv.z), affine(v1.y, mv.w, bv.w));
    w[2 * h] = *reinterpret_cast<const uint32_t*>(&o0);
    w[2 * h + 1] = *reinterpret_cast<const uint32_t*>(&o1);
  }
  return raw;
}

// The block's vectors in shared memory, in floats: kBn1 a1 and b1 (C
// each), then kPrelu alpha or kBn2Residual a2 and b2 (Co each)
template <Prologue kPro, Epilogue kEpi>
__host__ __device__ constexpr int vec_floats(int C, int Co) {
  return (kPro == kBn1 ? 2 * C : 0) +
         (kEpi == kPrelu ? Co : kEpi == kBn2Residual ? 2 * Co : 0);
}

// A block is WG consumer warpgroups and one producer warp, and walks the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...  A ring of S slots lies
// between them, each with a `full` mbarrier (the copies of a slice have
// landed) and an `empty` one (every consumer warp has read it).
template <int BN, int WG, int S, Prologue kPro, Epilogue kEpi>
__global__ void __launch_bounds__(128 * WG + 32, BN == 64 ? 2 : 1)
    conv3x3_wgmma_kernel(ConvArgs a,
                         const __grid_constant__ CUtensorMap x_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kMSub = kBM / (64 * WG);     // 64-row sub-tiles a warpgroup
  constexpr int kBBytes = 9 * kKC * BN * 2;  // a slice's weights, nine taps
  constexpr int kTapBytes = kKC * BN * 2;
  constexpr int kPitch = BN * 2 + 16;  // a staged output row, see below
  const int tid = threadIdx.x, lane = tid & 31;
  const int P = a.P, W1 = a.W + 1;
  const int a_bytes = (kKC / 8) * P * 16;
  const int stage_bytes = a_bytes + kBBytes;
  // the vectors, past the ring and the consumers' staged output rows
  float* vec = reinterpret_cast<float*>(
      smem + 128 + (size_t)S * stage_bytes + (size_t)4 * WG * 16 * kPitch);
  const uint32_t full = smem_u32(smem), empty = full + 64;
  unsigned char* ring = smem + 128;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (vec_floats<kPro, kEpi>(1, 1) > 0) {
    const float* src[4] = {a.a1, a.b1, kEpi == kPrelu ? a.alpha : a.a2, a.b2};
    const int n[4] = {kPro == kBn1 ? a.C : 0, kPro == kBn1 ? a.C : 0,
                      kEpi != kStore ? a.Co : 0,
                      kEpi == kBn2Residual ? a.Co : 0};
    float* dst = vec;
    for (int v = 0; v < 4; ++v) {
      for (int i = tid; i < n[v]; i += blockDim.x) dst[i] = src[v][i];
      dst += n[v];
    }
  }
  __syncthreads();
  const int slices = a.C / kKC;
  const long long frame = (long long)(a.H + 1) * W1;

  if (tid >= 128 * WG) {
    // The producer.  Per slice it waits until the slot is empty, then its
    // first lanes each ask the copy engine for kLoad coordinates of one
    // 8-channel chunk (the tile stages the coordinates q0 + [0, P); the sums
    // are those of q0 + W1 + 1 + [0, kBM)) and lane 0 for the slice's
    // weights, packed by the caller in the layout wgmma reads (one contiguous
    // copy); all are counted on the slot's `full`.  A load that would start
    // beyond the last frame is left out and its coordinates are zeroed: the
    // pad row below the last frame lies there.
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    const int loads = P / kLoad;
    unsigned it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const long long q0 = (long long)(tile / a.n_tiles) * kBM;
      const int n_tile = tile % a.n_tiles;
      int valid = 0;  // loads a chunk that start inside the tensor
      while (valid < loads && q0 + (long long)valid * kLoad < a.Q) ++valid;
      int lw = 0, lh = 0, ln = 0;  // where this lane's load starts
      if (lane < 2 * valid) {
        const long long q = q0 + (long long)(lane >> 1) * kLoad;
        const long long f = q / frame;
        const int rem = (int)(q - f * frame);
        ln = (int)f, lh = rem / W1 - 1, lw = rem % W1 - 1;
      }
      for (int s = 0; s < slices; ++s, ++it) {
        const int slot = it % S;
        mbar_wait(empty + 8 * slot, ((it / S) & 1) ^ 1);
        unsigned char* sa = ring + (size_t)slot * stage_bytes;
        const uint32_t sa_u32 = smem_u32(sa), bar = full + 8 * slot;
        if (valid < loads) {
          const int rest = P - valid * kLoad;
          for (int i = lane; i < 2 * rest; i += 32)
            *reinterpret_cast<uint4*>(
                sa + ((i / rest) * P + valid * kLoad + i % rest) * 16) =
                make_uint4(0, 0, 0, 0);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
        }
        if (lane == 0) {
          mbar_expect_tx(bar, kBBytes + 2 * valid * kLoad * 16);
          bulk_copy(sa_u32 + a_bytes,
                    a.w + ((size_t)n_tile * slices + s) * (kBBytes / 2),
                    kBBytes, bar);
        }
        if (lane < 2 * valid)
          tma_im2col(sa_u32 + ((lane & 1) * P + (lane >> 1) * kLoad) * 16,
                     &x_map, s * kKC + (lane & 1) * 8, lw, lh, ln, bar);
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg holds the sums of the tile's rows
  // 64 * kMSub * wg + [0, 64 * kMSub) in registers.
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  // a warp's own 16 staged output rows
  unsigned char* out = ring + (size_t)S * stage_bytes +
                       (size_t)(wg * 4 + warp) * 16 * kPitch;
  float acc[kMSub][BN / 2];  // first written by a tile's first wgmma
  // kBn1: this thread rewrites the staged coordinates first + k*kStride,
  // k < steps_k, of the slot's chunk `chunk` (WG is even)
  static_assert(WG % 2 == 0, "a warpgroup pair takes the two chunks");
  constexpr int kStride = 64 * WG;
  const int chunk = wg & 1, first = (wg >> 1) * 128 + (tid & 127);
  const int steps_k = (P - first + kStride - 1) / kStride;  // P <= 16 kLoad
  unsigned it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long q0 = (long long)(tile / a.n_tiles) * kBM;
    const int n0 = (tile % a.n_tiles) * BN;
    // kBn1: bit k is set where this thread's coordinate q0 + first +
    // k*kStride is an image pixel, by the store's test
    unsigned pixel = 0;
    if constexpr (kPro == kBn1) {
      for (int k = 0; k < steps_k; ++k) {
        const long long q = q0 + first + k * kStride;
        if (q >= a.Q) break;
        const long long f = q / frame;
        const int rem = (int)(q - f * frame);
        const int row = rem / W1, col = rem - row * W1;
        if (row != 0 && col != 0) pixel |= 1u << k;
      }
    }
    for (int s = 0; s < slices; ++s, ++it) {
      const int slot = it % S;
#ifndef FVT_DIAG_PRODUCTS_ONLY
      mbar_wait(full + 8 * slot, (it / S) & 1);  // the slice has landed
#endif
      if constexpr (kPro == kBn1) {
        // bn1 over the slot's chunk: bf16(a1*x + b1) at this thread's
        // pixels, 0 elsewhere
        const float* m = vec + s * kKC + 8 * chunk;  // a1, then b1
        uint4* rows = reinterpret_cast<uint4*>(
            ring + (size_t)slot * stage_bytes + (size_t)chunk * P * 16);
        for (int k = 0; k < steps_k; ++k) {
          const int q = first + k * kStride;
          rows[q] = (pixel >> k) & 1u ? bn1_row(rows[q], m, m + a.C)
                                      : make_uint4(0, 0, 0, 0);
        }
        // seen by wgmma's async proxy, and every consumer's writes before
        // any of them multiplies
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG) : "memory");
      }
      const uint32_t sa_u32 = smem_u32(ring + (size_t)slot * stage_bytes);
      const uint64_t desc_b = make_desc(sa_u32 + a_bytes, (BN / 8) * 128, 128);
      wgmma_fence();
#ifdef FVT_DIAG_COPIES_ONLY
      if (s == 0)
#endif
#pragma unroll
      for (int sub = 0; sub < kMSub; ++sub) {
        const uint64_t desc_a = make_desc(
            sa_u32 + (wg * kMSub + sub) * 64 * 16, P * 16, 128);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          // a tap's rows start (dy*W1 + dx) coordinates of 16 B further
          const int shift = (tap / 3) * W1 + tap % 3;
          wgmma_bf16<BN>(acc[sub], desc_a + shift,
                         desc_b + tap * (kTapBytes >> 4), s > 0 || tap > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp has read it
    }

    // The sums leave through the warp's 16 staged rows, so that y is written
    // in whole 16-byte pieces, a row's BN channels side by side.  Thread
    // (warp, lane) of a warpgroup holds rows 16*warp + lane/4 (+ 8) and
    // columns 8*j + 2*(lane % 4) (+ 1) of a sub-tile in acc[4*j + 2*half
    // (+ 1)]; a staged row takes BN*2 + 16 bytes, which spreads a warp's
    // eight rows over the banks.  The epilogues act on the fp32 sums
    // before they are rounded and staged.
#pragma unroll
    for (int sub = 0; sub < kMSub; ++sub) {
      // pixel index (n*H + i)*W + j of the sum this lane's row holds, -1 for
      // a pad (lanes 0..15: one row each)
      int pix = -1;
      {
        const long long q =
            q0 + W1 + 1 + (wg * kMSub + sub) * 64 + warp * 16 + (lane & 15);
        if (q < a.Q) {
          const long long f = q / frame;
          const int rem = (int)(q - f * frame);
          const int row = rem / W1, col = rem - row * W1;
          if (row > 0 && col > 0)
            pix = (int)((f * a.H + row - 1) * a.W + col - 1);
        }
      }
      __syncwarp();  // the rows staged before have been read
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned char* row =
            out + ((lane >> 2) + 8 * half) * kPitch + (lane & 3) * 4;
        // kBn2Residual: the pixel of this thread's row
        int at = -1;
        if constexpr (kEpi == kBn2Residual)
          at = __shfl_sync(0xffffffffu, pix, (lane >> 2) + 8 * half);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float2 o = make_float2(acc[sub][4 * j + 2 * half],
                                 acc[sub][4 * j + 2 * half + 1]);
          const int n = n0 + 8 * j + 2 * (lane & 3);
          // the epilogue's vectors in shared memory, after bn1's
          const float* ev = vec + (kPro == kBn1 ? 2 * a.C : 0);
          if constexpr (kEpi == kPrelu) {
            if (n < a.Co) {
              const float2 al = *reinterpret_cast<const float2*>(ev + n);
              o.x = o.x > 0.f ? o.x : __fmul_rn(al.x, o.x);
              o.y = o.y > 0.f ? o.y : __fmul_rn(al.y, o.y);
            }
          } else if constexpr (kEpi == kBn2Residual) {
            if (n < a.Co && at >= 0) {
              const float2 m = *reinterpret_cast<const float2*>(ev + n);
              const float2 b = *reinterpret_cast<const float2*>(ev + a.Co + n);
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      a.res + (size_t)at * a.Co + n));
              o.x = __fadd_rn(affine(o.x, m.x, b.x), r.x);
              o.y = __fadd_rn(affine(o.y, m.y, b.y), r.y);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(row + j * 16) =
              __floats2bfloat162_rn(o.x, o.y);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = lane; i < 16 * (BN / 8); i += 32) {
        const int r = i / (BN / 8), j = i % (BN / 8);
        const int v = __shfl_sync(0xffffffffu, pix, r);
        if (v >= 0 && n0 + 8 * j < a.Co)
          *reinterpret_cast<uint4*>(a.y + (size_t)v * a.Co + n0 + 8 * j) =
              *reinterpret_cast<const uint4*>(out + r * kPitch + j * 16);
      }
    }
  }
}

constexpr size_t smem_bytes(int P, int BN, int WG, int S) {
  return 128 + (size_t)S * ((kKC / 8) * P * 16 + 9 * kKC * BN * 2) +
         (size_t)4 * WG * 16 * (BN * 2 + 16);
}

// The persistent grid of wgmma_common.cuh, one block a tile at most.
template <int BN, int WG, int S, Prologue kPro, Epilogue kEpi>
cudaError_t launch(ConvArgs a, const CUtensorMap& x_map, cudaStream_t stream) {
  constexpr int kThreads = 128 * WG + 32;
  a.n_tiles = (a.Co + BN - 1) / BN;
  const size_t bytes =
      smem_bytes(a.P, BN, WG, S) + 4 * vec_floats<kPro, kEpi>(a.C, a.Co);
  const long long tiles = (a.Q - (a.W + 2) + kBM - 1) / kBM * a.n_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_blocks(conv3x3_wgmma_kernel<BN, WG, S, kPro, kEpi>,
                        kThreads, bytes, tiles, &blocks);
  if (err != cudaSuccess) return err;
  conv3x3_wgmma_kernel<BN, WG, S, kPro, kEpi>
      <<<blocks, kThreads, bytes, stream>>>(a, x_map);
  return cudaGetLastError();
}

// The deepest ring of 3 or 2 slots that fits the shared memory.
template <int BN, int WG, Prologue kPro = kNoPrologue, Epilogue kEpi = kStore>
cudaError_t launch_ring(const ConvArgs& a, const CUtensorMap& x_map,
                        cudaStream_t stream) {
  // a lane of the producer warp for each load of a slice
  if (2 * (a.P / kLoad) > 32) return cudaErrorInvalidValue;
  const size_t vec = 4 * vec_floats<kPro, kEpi>(a.C, a.Co);
  if (smem_bytes(a.P, BN, WG, 3) + vec <= (size_t)kMaxSmem)
    return launch<BN, WG, 3, kPro, kEpi>(a, x_map, stream);
  if (smem_bytes(a.P, BN, WG, 2) + vec <= (size_t)kMaxSmem)
    return launch<BN, WG, 2, kPro, kEpi>(a, x_map, stream);
  return cudaErrorInvalidValue;
}

// The arguments of a conv of x (N, H, W, C) into y (N, H, W, Co) and its
// tensor map, or cudaErrorInvalidValue for a shape or bn no launch takes.
cudaError_t conv_args(const void* x, const void* wp, void* y, int N, int H,
                      int W, int C, int Co, int bn, ConvArgs* a,
                      CUtensorMap* x_map) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 || Co % 8 ||
      (bn != 64 && bn != 128))
    return cudaErrorInvalidValue;
  if ((long long)N * H * W > 2147483647LL) return cudaErrorInvalidValue;
  *a = ConvArgs{(const __nv_bfloat16*)x,
                (const __nv_bfloat16*)wp,
                (__nv_bfloat16*)y,
                N, H, W, C, Co,
                (kBM + 2 * (W + 1) + 2 + kLoad - 1) / kLoad * kLoad,
                (long long)N * (H + 1) * (W + 1),
                0, 0,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return make_x_map(x, N, H, W, C, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 8,
                    x_map);
}

// One launch of the conv with its prologue and epilogue: bn = 64 as two
// warpgroups of two sub-tiles each, so that two blocks share an SM; bn =
// 128 as four warpgroups of one.
template <Prologue kPro, Epilogue kEpi>
cudaError_t run(const ConvArgs& a, const CUtensorMap& x_map, int bn,
                cudaStream_t stream) {
  return bn == 64 ? launch_ring<64, 2, kPro, kEpi>(a, x_map, stream)
                  : launch_ring<128, 4, kPro, kEpi>(a, x_map, stream);
}

}  // namespace

extern "C" {

// y = conv3x3(x, w) on `stream`.  x (N, H, W, C) and y (N, H, W, Co) bf16,
// contiguous and 16-byte aligned; C a multiple of 16 (one k16 step of
// wgmma), Co a multiple of 8.  wp holds the weights w (9, C, Co) packed for
// column tiles of bn = 64 or 128 output channels, bf16, contiguous:
//   wp[tile][slice][tap][chunk][n8][k][n] =
//       w[tap][16*slice + 8*chunk + k][bn*tile + 8*n8 + n]
// with tile < ceil(Co / bn), slice < C/16, chunk < 2, n8 < bn/8, k, n < 8,
// and 0 where the output channel is beyond Co: per (tile, slice) the
// 9*16*bn values one ring slot takes, as wgmma reads them.  Returns
// cudaSuccess, the error of an attribute call or the launch, or
// cudaErrorInvalidValue for what the kernel does not take: another C, Co or
// bn, N*H*W beyond 2^31 - 1, or a W so wide (about 500 at bn = 128, 890 at
// bn = 64) that a ring of two staged slices leaves the 227 KB of shared
// memory or a tile's loads outnumber the producer's lanes.
int fvt_conv3x3_bf16_forward(const void* x, const void* wp, void* y, int N,
                             int H, int W, int C, int Co, int bn,
                             void* stream) {
  ConvArgs a;
  CUtensorMap x_map;
  const cudaError_t err = conv_args(x, wp, y, N, H, W, C, Co, bn, &a, &x_map);
  if (err != cudaSuccess) return (int)err;
  return (int)run<kNoPrologue, kStore>(a, x_map, bn, (cudaStream_t)stream);
}

// The eval-mode identity BottleneckIR block of x on bf16 tensors, on
// `stream`, as two launches of the conv (the header note):
//   stage 1, conv1:  v = bf16(prelu(conv3x3(bf16(a1*x + b1), w1), alpha)),
//                    the affine's input 0 outside the image;
//   stage 2, conv2:  y = bf16((a2*conv3x3(v, w2) + b2) + x).
// `stages` 3 runs both; 1 or 2 one alone, for measurements.  x, the
// workspace v and y (N, H, W, C) bf16, contiguous and 16-byte aligned, C a
// multiple of 16; w1p and w2p the two convs' weights (9, C, C) in bf16,
// packed as fvt_conv3x3_bf16_forward's for Co = C at column tiles of bn =
// 64 or 128; a1, b1 (bn1's affine), alpha (PReLU's slopes), a2, b2 (bn2's
// affine), each (C) fp32 and 16-byte aligned.  Returns cudaSuccess, the
// first error of a launch or an attribute call, or cudaErrorInvalidValue
// for what the conv does not take (the plain conv's shapes and bn) or a
// `stages` outside 1..3.
int fvt_bottleneck_bf16_forward(const void* x, const void* w1p,
                                const void* w2p, const void* a1,
                                const void* b1, const void* alpha,
                                const void* a2, const void* b2, void* v,
                                void* y, int N, int H, int W, int C, int bn,
                                int stages, void* stream) {
  if (stages < 1 || stages > 3) return (int)cudaErrorInvalidValue;
  ConvArgs c1, c2;
  CUtensorMap x_map, v_map;
  cudaError_t err = conv_args(x, w1p, v, N, H, W, C, C, bn, &c1, &x_map);
  if (err != cudaSuccess) return (int)err;
  err = conv_args(v, w2p, y, N, H, W, C, C, bn, &c2, &v_map);
  if (err != cudaSuccess) return (int)err;
  if (2 * (c1.P / kLoad) > 32) return (int)cudaErrorInvalidValue;
  c1.a1 = (const float*)a1;
  c1.b1 = (const float*)b1;
  c1.alpha = (const float*)alpha;
  c2.a2 = (const float*)a2;
  c2.b2 = (const float*)b2;
  c2.res = (const __nv_bfloat16*)x;
  cudaStream_t st = (cudaStream_t)stream;
  if (stages & 1) {
    err = run<kBn1, kPrelu>(c1, x_map, bn, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) err = run<kNoPrologue, kBn2Residual>(c2, v_map, bn, st);
  return (int)err;
}

}  // extern "C"
