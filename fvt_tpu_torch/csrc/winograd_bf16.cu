// 3x3 stride-1 pad-1 convolution by Winograd F(2x2, 3x3), NHWC, bf16 in and
// out, fp32 sums, in two launches for Hopper (sm_90a): an input transform
// on the CUDA cores, then one product on the warpgroup matrix multiply
// (wgmma, bf16 operands, fp32 accumulators) with the output transform in
// its epilogue.
//
// Replaces fvt_tpu/ops/winograd.py::_winograd_kernel (the Pallas kernel
// behind conv3x3_winograd_pallas) on bf16 arrays, the type the JAX package
// hands it under --amp.  winograd_tf32x3.cu is the route for fp32 tensors;
// the PTX helpers both use are in wgmma_common.cuh.  With U = G g G^T (16,
// C, Co) computed by the caller once per weight, for every 2x2 output tile
// p (P of them, over frames, tile rows and tile columns; odd H or W padded
// to whole tiles):
//
//   1. V[ab][p] = (B^T d B)[a][b] for the tile's 4x4 input patch d, x zero
//      outside the image: V in bf16 in device memory, (16, P, C) by its
//      values, kept as (16, C/8, P8, 8) with P8 = P rounded up to 8
//      (below);
//   2. for every position ab = 4a + b, a outer and b inner, M_ab = V[ab] @
//      U[ab] in a fresh fp32 accumulator, added into or subtracted from the
//      four output phases (i, j) where A^T[i][a] * A^T[j][b] = +-1 (zeros
//      skipped), then y = bf16 of the four phases, cropped to (N, H, W, Co).
//      M never reaches device memory.
//
// The rounding points are the JAX package's (ops/winograd.py
// conv3x3_winograd and _winograd_kernel on bf16 arrays) and those of
// ops/winograd.py::conv3x3_winograd_bf16_ref in this package:
//   - U is computed in fp32 from the bf16 kernel and rounded to bf16 once
//     (by the caller);
//   - V = B^T d B in bf16: over the rows (a) first, then over the columns
//     (b), every add and subtract rounded to bf16 (fp32 op on bf16 values,
//     then rounded to nearest even: the same bits as a bf16 op, since the
//     difference of two bf16 values is either exact in fp32 or its smaller
//     part lies far below half a bf16 unit).  The transform is not exact
//     in bf16;
//   - the products are bf16 x bf16, exact, summed in fp32 (wgmma);
//   - M and A^T M A stay fp32, y is rounded to bf16 once.
// So the kernel differs from the plain version only in the order of fp32
// sums: at most one unit in the last place of y where a sum straddles a
// rounding boundary.  V is bit-equal.
//
// What bounds it.  The products are 2*16*P*C*Co operations (0.44x the
// direct conv's, pads of odd H or W counted), 6.4 ms at the bf16 peak over
// the 45 convs of an ArcFace forward on 2400 frames.  V is 4x the input
// (in bf16) and is written once and read once; x and y once each: about
// 26.5 ms at 3.35 TB/s over the same convs.  So the route is bound by
// bytes, and mostly by V.  Keeping M (16, P, Co) out of device memory is
// what this design buys over three launches: in fp32 it would add 155 GB,
// 46 ms, over the forward.  A design with V on chip too (the Pallas
// kernel's) would be bound by the operations; that is later work.  What is
// left here: the product launch is bound by its copies into shared memory
// (a tile of the size the registers allow, 128 x 64, takes 6 KB of V and U
// a k16 step for 262 K operations), and the input transform runs below the
// memory rate.
//
// Launch 1: a thread takes one tile and 8 channels (16 bytes); C is a
// multiple of 16.  V is kept 8-channel chunk by chunk, (16, C/8, P8, 8),
// rows P .. P8-1 zero, so that the product's copy of 128 rows of a chunk
// is 2 KB in one piece, which its tensor map reads as 16 rows of 128
// bytes: the copy engine takes a box row by row, and with 16-byte rows
// (V as (16, P, C), as the fp32 route keeps it) the copies, not the
// products, bound the product launch.  A block is 32 tiles by 8 chunks; x
// is read 128 bytes of a pixel a warp, V written 512 bytes of a chunk a
// warp, through shared memory.
//
// Launch 2: a persistent block of kWG = 2 consumer warpgroups and one
// producer warpgroup walks the tiles (kRows = 128 rows of P by kBN = 64
// output channels; tile = row tile * column tiles + column tile, so that
// the blocks in flight share rows of V); for each tile it walks the 16
// positions and, in each, C in slots of 64 channels (16 where C is no
// multiple of 64).  A ring of slots lies between producer and consumers,
// with a `full` and an `empty` mbarrier each.  Per slot the producer's
// first thread asks the copy engine for boxes of 128 rows x 8 channels of
// V (a 3-d tiled tensor map over V as (64, P8/8, 16 * C/8): 8 rows of a
// chunk in a 128-byte box row; rows beyond P are zeros), which land as
// wgmma's K-major core matrices, and for the
// slot's packed U (one bulk copy).  Each consumer warpgroup multiplies its
// 64 rows into its fresh accumulator (32 registers), one k16 step a wgmma,
// with one slot's products in flight while the next slot's are issued,
// waits for the position's last, and adds the accumulator into the four
// phase accumulators (4 x 32 registers).  That is 160 fp32 registers a
// thread besides addresses and counters: hence BN = 64, two consumer
// warpgroups, and the producer a warpgroup that lowers its registers to 24
// so that the consumers can raise theirs to 240 (setmaxnreg).  ptxas hands
// out registers by whole warpgroups: with a producer warp alone (288
// threads) a thread got 168, as with 384, and the consumers spilled 5.5 KB
// a thread.  The 16 positions are unrolled, so the signs are constants.  y
// leaves through 16 staged rows of shared memory a warp, 16 bytes a
// thread.
//
// Three build switches split the product launch's time for
// tools/profile_conv_bf16.py --dtype winograd_bf16, and give wrong sums:
// -DFVT_DIAG_PRODUCTS_ONLY starts no copy and waits for none,
// -DFVT_DIAG_COPIES_ONLY runs the wgmma of each position's first slice
// only, -DFVT_DIAG_NO_STORE keeps y in the registers.

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kKC = 16;           // input channels a k16 step of wgmma
constexpr int kWG = 2;            // consumer warpgroups a block, 64 rows each
// a block is kWG consumer warpgroups and a producer warpgroup: ptxas hands
// out registers by warpgroups, so a producer warp alone would cost as much;
// the producer gives its registers to the consumers (setmaxnreg)
constexpr int kThreads = 128 * (kWG + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + 128 * kWG * kConsumerRegs <= 65536,
              "the registers of an SM");
constexpr int kRows = 64 * kWG;   // rows of P a tile
constexpr int kBN = 64;           // output channels a tile
constexpr int kTTiles = 32, kTChunks = 8;  // a block of the input transform
constexpr int kTThreads = kTTiles * kTChunks;
constexpr int kABytes = kRows * 16;      // one 8-channel chunk of V
constexpr int kBBytes = kKC * kBN * 2;   // a k16 step's U

constexpr int kPitch = kBN * 2 + 16;  // a staged output row, bytes
constexpr int kStageBytes = kWG * 4 * 16 * kPitch;  // 16 rows a warp

// A ring slot holds S k16 steps (16*S channels): V's 2*S chunks, then U's
// S steps; 6 slots of 4 steps (144 KB), or 8 of one; the consumers'
// staged output rows lie past the ring
template <int S>
struct Ring {
  static constexpr int kSlot = S * (2 * kABytes + kBBytes);
  static constexpr int kSlots = S == 1 ? 8 : 6;
  static constexpr size_t kSmemBytes =
      128 + (size_t)kSlots * kSlot + kStageBytes;
};

struct WinogradBf16Args {
  const __nv_bfloat16* x;  // (N, H, W, C)
  const __nv_bfloat16* u;  // packed: see fvt_winograd_bf16_forward
  __nv_bfloat16* v;        // (16, P, C)
  __nv_bfloat16* y;        // (N, H, W, Co)
  int N, H, W, C, Co;
  int th, tw;   // tiles a frame: ceil(H/2), ceil(W/2)
  int P;        // tiles in all: N * th * tw
  int P8;       // P rounded up to a multiple of 8: V's rows a chunk
  int n_tiles;  // column tiles: ceil(Co / kBN)
  int tiles;    // ceil(P / kRows) * n_tiles
};

// a + s*b on 8 bf16 (s = +1 or -1), each in fp32 and rounded to bf16 once
template <int S>
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  uint4 r;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    pr[i] = S > 0 ? __floats2bfloat162_rn(__fadd_rn(fa.x, fb.x),
                                          __fadd_rn(fa.y, fb.y))
                  : __floats2bfloat162_rn(__fsub_rn(fa.x, fb.x),
                                          __fsub_rn(fa.y, fb.y));
  }
  return r;
}

// B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] along one axis, in bf16
__device__ __forceinline__ void bt8(const uint4 (&d)[4], uint4 (&t)[4]) {
  t[0] = add8<-1>(d[0], d[2]);
  t[1] = add8<1>(d[1], d[2]);
  t[2] = add8<-1>(d[2], d[1]);
  t[3] = add8<-1>(d[1], d[3]);
}

// Launch 1: V[4a + b][c/8][p][0 .. 7] for tile p and channels c .. c+7.
// A block takes kTTiles tiles by kTChunks chunks.  A thread computes tile
// p0 + tid/8 at chunk c80 + tid%8, so that a warp reads 128 contiguous
// bytes of each of 4 pixels; the results pass through shared memory, 8
// positions at a time, and a thread stores chunk c80 + tid/32 of tiles p0
// + tid%32, so that a warp writes 512 contiguous bytes of V.  Tiles P ..
// P8-1 are zeros.
__global__ void __launch_bounds__(kTThreads)
    input_transform_kernel(WinogradBf16Args a) {
  // 8 positions' results; a row of kTTiles + 1 keeps the 8 lanes of a
  // quarter warp, which write one tile's 8 chunks, on distinct banks
  __shared__ uint4 stage[8][kTChunks][kTTiles + 1];
  const int c8s = a.C / 8;
  const int p0 = blockIdx.x * kTTiles, c80 = blockIdx.y * kTChunks;
  const int tl = threadIdx.x >> 3, cl = threadIdx.x & 7;
  const int p = p0 + tl, c8 = c80 + cl;
  const bool live = p < a.P && c8 < c8s;
  // rows first: t[b][k] = (B^T d)[k] of column b; zeros for a pad tile
  uint4 t[4][4];
  {
    const int per = a.th * a.tw;
    const int f = live ? p / per : 0, r = live ? p - f * per : 0;
    const int y0 = 2 * (r / a.tw) - 1, x0 = 2 * (r % a.tw) - 1;
    const __nv_bfloat16* xf = a.x + (size_t)f * a.H * a.W * a.C + c8 * 8;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gx = x0 + b;
      uint4 d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int gy = y0 + k;
        d[k] = live && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W
                   ? *reinterpret_cast<const uint4*>(
                         xf + ((size_t)gy * a.W + gx) * a.C)
                   : make_uint4(0, 0, 0, 0);
      }
      bt8(d, t[b]);
    }
  }
  const int sc = threadIdx.x >> 5, st = threadIdx.x & 31;
  const bool store = p0 + st < a.P8 && c80 + sc < c8s;
  __nv_bfloat16* v = a.v + ((size_t)(c80 + sc) * a.P8 + p0 + st) * 8;
  const size_t plane = (size_t)a.P8 * a.C;  // a position
  // then the columns of row k: positions 4k .. 4k+3, two rows a pass
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half) __syncthreads();  // the first pass has been read
#pragma unroll
    for (int k = 2 * half; k < 2 * half + 2; ++k) {
      const uint4 row[4] = {t[0][k], t[1][k], t[2][k], t[3][k]};
      uint4 out[4];
      bt8(row, out);
#pragma unroll
      for (int b = 0; b < 4; ++b) stage[4 * (k & 1) + b][cl][tl] = out[b];
    }
    __syncthreads();
    if (store) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint4*>(v + (8 * half + i) * plane) =
            stage[i][sc][st];
    }
  }
}

// A^T = [[1,1,1,0],[0,1,-1,-1]]: the sign of M_ab in output phase (i, j)
__host__ __device__ constexpr int at(int i, int a) {
  return i == 0 ? (a < 3 ? 1 : 0) : (a == 0 ? 0 : a == 1 ? 1 : -1);
}

// The warpgroup's registers a thread, raised or lowered to N
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Launch 2: y = A^T (V[ab] @ U[ab]) A, tile by tile, S k16 steps a ring
// slot (C a multiple of 16*S).  A block is kWG consumer warpgroups and one
// producer warpgroup and walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...
template <int S>
__global__ void __launch_bounds__(kThreads, 1)
    product_kernel(WinogradBf16Args a,
                   const __grid_constant__ CUtensorMap v_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRing = Ring<S>::kSlots, kSlot = Ring<S>::kSlot;
  static_assert(kRing <= 8, "the barriers take the first 128 bytes");
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t full = smem_u32(smem), empty = full + 64;
  unsigned char* ring = smem + 128;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slots = a.C / (kKC * S);  // ring slots a position
  // the warpgroup, as a value ptxas knows to be the same across a warp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (wg == kWG) {
    // The producer: one thread waits until the slot is empty, sets the
    // bytes to expect and starts the slot's copies (its 2*S chunks of V,
    // its S steps of U in one), all counted on its `full`.
    setmaxnreg_dec<kProducerRegs>();
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    if (tid != 128 * kWG) return;
    unsigned it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int n_tile = tile % a.n_tiles;
      const int r0 = (tile / a.n_tiles) * kRows;
      for (int pos = 0; pos < 16; ++pos) {
        const __nv_bfloat16* u =
            a.u + ((size_t)pos * a.n_tiles + n_tile) * slots * S *
                      (kBBytes / 2);
        for (int s = 0; s < slots; ++s, ++it) {
          const int slot = it % kRing;
          mbar_wait(empty + 8 * slot, ((it / kRing) & 1) ^ 1);
          const uint32_t sa = smem_u32(ring + (size_t)slot * kSlot);
          const uint32_t bar = full + 8 * slot;
          mbar_expect_tx(bar, kSlot);
          bulk_copy(sa + 2 * S * kABytes, u + (size_t)s * S * (kBBytes / 2),
                    S * kBBytes, bar);
          for (int ch = 0; ch < 2 * S; ++ch)
            tma_tile3d(sa + ch * kABytes, &v_map, 0, r0 / 8,
                       pos * (a.C / 8) + 2 * S * s + ch, bar);
        }
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg holds the tile's rows 64 * wg + [0, 64).
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = (tid >> 5) & 3;
  // this warp's 16 staged output rows
  unsigned char* stage =
      ring + (size_t)kRing * kSlot + (size_t)(wg * 4 + warp) * 16 * kPitch;
  float acc[kBN / 2];     // M_ab, first written by a position's first wgmma
  float out[4][kBN / 2];  // the output phases 2i + j
  unsigned it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int n0 = (tile % a.n_tiles) * kBN;
    const int r0 = (tile / a.n_tiles) * kRows;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) out[q][e] = 0.f;
#pragma unroll
    for (int pos = 0; pos < 16; ++pos) {
      for (int s = 0; s < slots; ++s, ++it) {
        const int slot = it % kRing;
#ifndef FVT_DIAG_PRODUCTS_ONLY
        mbar_wait(full + 8 * slot, (it / kRing) & 1);  // the slot has landed
#endif
        const uint32_t sa = smem_u32(ring + (size_t)slot * kSlot);
        // step j's two chunks of V and its U, 16 bytes a descriptor unit
        const uint64_t desc_a = make_desc(sa + wg * 64 * 16, kABytes, 128);
        const uint64_t desc_b =
            make_desc(sa + 2 * S * kABytes, (kBN / 8) * 128, 128);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < S; ++j) {
#ifdef FVT_DIAG_COPIES_ONLY
          if (s > 0) break;
#endif
          wgmma_bf16<kBN>(acc, desc_a + j * (2 * kABytes >> 4),
                          desc_b + j * (kBBytes >> 4), s > 0 || j > 0);
        }
        wgmma_commit();
        // one slot's products in flight: the slot before is read, and
        // this warp frees it
        wgmma_wait<1>();
        if (s > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kRing));
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kRing));
      // M_ab into the phases, in fp32: a = pos / 4 and b = pos % 4 are
      // constants here, so the signs are, and the zeros are skipped
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sign = at(q >> 1, pos >> 2) * at(q & 1, pos & 3);
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) {
          if (sign > 0) out[q][e] = __fadd_rn(out[q][e], acc[e]);
          if (sign < 0) out[q][e] = __fsub_rn(out[q][e], acc[e]);
        }
      }
    }

    // Thread (warp, lane) of a warpgroup holds rows 16*warp + lane/4 (+ 8)
    // and columns 8*j + 2*(lane % 4) (+ 1) of its 64 x kBN sub-tile in
    // out[q][4*j + 2*half (+ 1)]; row p is the 2x2 tile (f, ty, tx), phase
    // q = 2i + jj its pixel (f, 2ty + i, 2tx + jj), cropped at odd H or W.
    // A phase leaves through the warp's 16 staged rows, so that y is
    // written 16 bytes a thread, a pixel's kBN channels side by side (4-byte
    // stores straight from the accumulator layout took a third of it); a
    // staged row takes kPitch bytes, which spreads a warp's 8 rows over the
    // banks.
#ifdef FVT_DIAG_NO_STORE
    continue;
#endif
    // lanes 0..15: the tile of row lane, f = -1 beyond P
    int f = -1, oy = 0, ox = 0;
    {
      const int p = r0 + wg * 64 + warp * 16 + (lane & 15);
      if (p < a.P) {
        const int per = a.th * a.tw;
        f = p / per;
        const int r = p - f * per;
        oy = 2 * (r / a.tw), ox = 2 * (r % a.tw);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int py = oy + (q >> 1), px = ox + (q & 1);
      const int pix =
          f >= 0 && py < a.H && px < a.W ? (f * a.H + py) * a.W + px : -1;
      __syncwarp();  // the phase staged before has been read
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned char* row =
            stage + ((lane >> 2) + 8 * half) * kPitch + (lane & 3) * 4;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + j * 16) =
              __floats2bfloat162_rn(out[q][4 * j + 2 * half],
                                    out[q][4 * j + 2 * half + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int i = lane; i < 16 * (kBN / 8); i += 32) {
        const int r = i / (kBN / 8), j = i % (kBN / 8);
        const int v = __shfl_sync(0xffffffffu, pix, r);
        if (v >= 0 && n0 + 8 * j < a.Co)
          *reinterpret_cast<uint4*>(a.y + (size_t)v * a.Co + n0 + 8 * j) =
              *reinterpret_cast<const uint4*>(stage + r * kPitch + j * 16);
      }
    }
  }
}

template <int S>
cudaError_t launch_product(WinogradBf16Args a, cudaStream_t stream) {
  a.n_tiles = (a.Co + kBN - 1) / kBN;
  const long long tiles = ((long long)a.P + kRows - 1) / kRows * a.n_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  CUtensorMap v_map;
  // V as (16 * C/8, P8/8, 64): boxes of kRows rows of one position's
  // chunk, 8 rows (128 bytes) a box row
  cudaError_t err = make_tile3d_map(a.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                    16 * (a.C / 8), a.P8 / 8, 64, 64,
                                    kRows / 8, &v_map);
  if (err != cudaSuccess) return err;
  constexpr size_t bytes = Ring<S>::kSmemBytes;
  static_assert(bytes <= kMaxSmem, "the ring fits in shared memory");
  unsigned blocks = 0;
  err = persistent_blocks(product_kernel<S>, kThreads, bytes, tiles,
                          &blocks);
  if (err != cudaSuccess) return err;
  product_kernel<S><<<blocks, kThreads, bytes, stream>>>(a, v_map);
  return cudaGetLastError();
}

cudaError_t launch_input_transform(const WinogradBf16Args& a,
                                   cudaStream_t stream) {
  const dim3 grid((a.P8 + kTTiles - 1) / kTTiles,
                  (a.C / 8 + kTChunks - 1) / kTChunks);
  input_transform_kernel<<<grid, kTThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = conv3x3(x, g) by Winograd on `stream`, from u = bf16(G g G^T) (16, C,
// Co) packed.  The launches of `stages` run, in order: 1 the input
// transform x -> v, 2 the product v -> y with the output transform in its
// epilogue (3 both; one alone is for measurements).  x (N, H, W, C), v (16,
// C/8, P8, 8) (V[pos][p][c] at v[pos][c/8][p][c%8], rows P .. P8-1 zero)
// and y (N, H, W, Co) bf16, contiguous and 16-byte aligned, with P = N *
// ceil(H/2) * ceil(W/2) and P8 = P rounded up to a multiple of 8; C a
// multiple of 16 (one k16 step of wgmma), Co a multiple of 8.  up holds u
// packed for column tiles of 64 output channels, bf16, contiguous:
//   up[pos][tile][slice][chunk][n8][k][n] =
//       u[pos][16*slice + 8*chunk + k][64*tile + 8*n8 + n]
// with pos < 16, tile < ceil(Co / 64), slice < C/16, chunk < 2, n8, k, n <
// 8, and 0 where the output channel is beyond Co: per (position, tile,
// slice) the 16 x 64 values one ring slot takes, as wgmma reads them.
// Returns cudaSuccess, the error of the first launch or attribute call
// that failed, or cudaErrorInvalidValue for what the kernels do not take:
// another C, Co or stages, or N*H*W or P8 beyond 2^31 - 1.
int fvt_winograd_bf16_forward(const void* x, const void* up, void* v,
                              void* y, int N, int H, int W, int C, int Co,
                              int stages, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 || Co % 8 ||
      stages <= 0 || stages > 3)
    return (int)cudaErrorInvalidValue;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const long long P = (long long)N * th * tw, P8 = (P + 7) / 8 * 8;
  if (P8 > 2147483647LL || (long long)N * H * W > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  WinogradBf16Args a{(const __nv_bfloat16*)x,
                     (const __nv_bfloat16*)up,
                     (__nv_bfloat16*)v,
                     (__nv_bfloat16*)y,
                     N, H, W, C, Co,
                     th, tw, (int)P, (int)P8,
                     0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    err = launch_input_transform(a, st);
    if (err != cudaSuccess) return (int)err;
  }
  // 64 channels a ring slot where C allows (every ArcFace conv), else 16
  if (stages & 2)
    err = C % 64 == 0 ? launch_product<4>(a, st) : launch_product<1>(a, st);
  return (int)err;
}

}  // extern "C"
