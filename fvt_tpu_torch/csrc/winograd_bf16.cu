// 3x3 stride-1 pad-1 convolution by Winograd F(2x2, 3x3), NHWC, bf16 in and
// out, fp32 sums, for Hopper (sm_90a): one launch that builds V = B^T d B
// from x in registers and multiplies it on the warpgroup matrix multiply
// (wgmma, bf16 operands, fp32 accumulators), with the output transform
// folded into the accumulation (fvt_winograd_bf16_fused_forward, the main
// path), and the earlier design in two launches, kept to be timed
// (fvt_winograd_bf16_forward, on no path).
//
// Replaces fvt_tpu/ops/winograd.py::_winograd_kernel (the Pallas kernel
// behind conv3x3_winograd_pallas) on bf16 arrays, the type the JAX package
// hands it under --amp.  winograd_tf32x3.cu is the route for fp32 tensors;
// the PTX helpers both use are in wgmma_common.cuh.  With U = G g G^T (16,
// C, Co) computed by the caller once per weight, for every 2x2 output tile
// p (P of them, over frames, tile rows and tile columns; odd H or W padded
// to whole tiles): V[ab][p] = (B^T d B)[a][b] for the tile's 4x4 input
// patch d, x zero outside the image, and y = A^T (V[ab] @ U[ab]) A, the
// 16 products summed over C, cropped to (N, H, W, Co).
//
// The rounding points are the JAX package's (ops/winograd.py
// conv3x3_winograd and _winograd_kernel on bf16 arrays) and those of
// ops/winograd.py::conv3x3_winograd_bf16_ref in this package:
//   - U is computed in fp32 from the bf16 kernel and rounded to bf16 once
//     (by the caller);
//   - V = B^T d B in bf16: over the rows (a) first, then over the columns
//     (b), every add and subtract rounded to bf16 (the two-launch design:
//     an fp32 op on bf16 values, then rounded to nearest even; the fused
//     kernel: the bf16x2 add, rounded to nearest even once, the same bits,
//     since the difference of two bf16 values is either exact in fp32 or
//     its smaller part lies far below half a bf16 unit).  The transform is
//     not exact in bf16;
//   - the products are bf16 x bf16, exact, summed in fp32 (wgmma);
//   - the sums and A^T M A stay fp32, y is rounded to bf16 once.
// So both designs differ from the plain version only in the order of fp32
// sums: at most one unit in the last place of y where a sum straddles a
// rounding boundary.  V is bit-equal.
//
// THE FUSED KERNEL (one launch; V never leaves the registers).
//
// Order of the sums.  With V in registers the position loop cannot stay
// outside the channel loop, as in the two-launch design (a fresh M_ab over
// all of C for each of the 16 positions): x would be staged 16 times.  So
// C is the outer loop, in k16 steps, and each step forms all 16 V_ab from
// one staged patch.  The 16 M_ab cannot each keep an accumulator (16 x 32
// registers), so the products go straight where A^T (.) A sends them: for
// output phase (i, j) the sign A^T[i][a] * A^T[j][b], given to wgmma as
// its operand negation (exact), no signed copy of U.  A^T = [[1,1,1,0],
// [0,1,-1,-1]] has 6 nonzeros, so that is 6 x 6 = 36 products of 64 x 64 x
// 16 a k16 step, the direct conv's count of multiplies (Winograd needs
// 16), in 4 x 32 fp32 registers a consumer thread.  Fewer products cost
// registers or copies, and measured slower (tools/profile_conv_bf16.py,
// PERF.md): two sums S_j = sum over C and b of A^T[j][b] V_2b U_2b for row
// a = 2, folded in after the last channel (30 products, 192 registers),
// took 7% longer over a forward's 45 convs; a second pair would take 256
// registers; a outer in four passes over C (24 products) stages x four
// times, where copies already bound the two-launch design.
//
// What bounds it.  36 products of 64 x 64 x 16 a k16 step and 128 tiles:
// 2.25x Winograd's 2*16*P*C*Co, 14.2 ms at the bf16 peak over the 45
// convs of a 2400-frame ArcFace forward (Winograd's own products take
// 6.3).  The bytes it must move are x, U and y once: 5.5 ms; x is read
// again for every column tile of 64 output channels, from L2.  Per k16
// step a block stages 8 x e_pad x 16 bytes of x (e_pad = 256 at every
// ArcFace shape: 32 KB) and U at 16 positions (32 KB), 28 bytes a cycle of
// the tensor cores' time, where the two-launch product needed 94.  It runs
// at about twice its products' time: taking out the copies, forming V,
// the products or the stores alone (the build switches below) each saves
// 4-13% of it, the stores the most, so no one part bounds it; a
// warpgroup forms a position row's V, issues its products and waits for
// them in series, and the two warpgroups of a block reach their stores
// together, while no product runs.
//
// Staging: the extended tile grid.  Tile (f, ty, tx)'s patch is rows 2ty-1
// .. 2ty+2 and columns 2tx-1 .. 2tx+2.  Give every frame one tile row and
// one tile column more, (th+1) x (tw+1) positions e = f*(th+1)*(tw+1) +
// ey*(tw+1) + ex, the 2x2 pixels (2ey-1 + {0, 1}, 2ex-1 + {0, 1}) each:
// every pixel of every patch, pads included, lies at exactly one of them,
// and tile p = (f, ty, tx) at e(p) = f*(th+1)*(tw+1) + ty*(tw+1) + tx reads
// tap (r, c) at position e(p) + (r/2)*(tw+1) + c/2, pixel (r%2, c%2).  The
// positions are the walk of an im2col tensor map over x with traversal
// stride 2 from (-1, -1) to (2tw-1, 2th-1) (upper corners 2tw - W and 2th
// - H), and the pixel (r%2, c%2) of each is its im2col offset: one load
// brings kLoad = 128 consecutive positions of one pixel and one 8-channel
// chunk, zeros outside the image (the pad), in wgmma's row order.  A row
// tile of 128 tiles p0 .. p0+127 needs positions e(p0) .. e(p_last) + tw
// + 2: at most e_pad = 256 at every ArcFace shape (512 at 1x1 frames),
// `loads` = e_pad / 128 loads a pixel and chunk, 8 x loads a k16 step, the
// producer warp's lanes one each, and U's 16 positions as 16 bulk copies
// of the caller's packing (the two-launch design's).
//
// Blocks.  A persistent block of kWG = 2 consumer warpgroups (64 tiles
// each) and one producer warpgroup (setmaxnreg: 24 registers for the
// producer, 240 for the consumers) walks (row tile, column tile) pairs, the
// column tile inner, so that blocks in flight share x in L2; a ring of
// 2-3 slots, each a k16 step, with `full` and `empty` mbarriers, lies
// between producer and consumers.  A consumer thread holds rows lane/4 and
// lane/4 + 8 of its warp's 16 (two tiles) and input channels 2*(lane%4) +
// {0, 1} and + 8: wgmma's A fragment, which it forms in registers from the
// staged pixels (bf16x2 adds, 4 channels of 2 tiles a thread): row a = 0
// (V_00 .. V_03 in 16 registers, 6 products), rows 1 and 2 together
// (B^T's rows 1 and 2 add and subtract the same two tap rows, read once:
// 32 registers, 24 products; 6% faster than apart), row 3 (6), each
// followed by a wait for its products before the next overwrites the
// registers (a second set, to form the next rows during the products,
// measured no faster).  The other warpgroup's products run meanwhile.  y leaves through 16 staged rows of
// shared memory a warp, 16 bytes a thread, as in the two-launch design.
//
// THE TWO-LAUNCH DESIGN (fvt_winograd_bf16_forward, timed, on no path):
//
//   1. V[ab][p] in bf16 in device memory, (16, P, C) by its values, kept
//      as (16, C/8, P8, 8) with P8 = P rounded up to 8 (below);
//   2. for every position ab = 4a + b, a outer and b inner, M_ab = V[ab] @
//      U[ab] in a fresh fp32 accumulator, added into or subtracted from the
//      four output phases (i, j) where A^T[i][a] * A^T[j][b] = +-1 (zeros
//      skipped), then y = bf16 of the four phases, cropped to (N, H, W, Co).
//      M never reaches device memory.
//
// What bounds it.  The products are 2*16*P*C*Co operations (0.44x the
// direct conv's, pads of odd H or W counted), 6.4 ms at the bf16 peak over
// the 45 convs of an ArcFace forward on 2400 frames.  V is 4x the input
// (in bf16) and is written once and read once; x and y once each: about
// 26.5 ms at 3.35 TB/s over the same convs.  So the route is bound by
// bytes, and mostly by V.  Keeping M (16, P, Co) out of device memory is
// what this design buys over three launches: in fp32 it would add 155 GB,
// 46 ms, over the forward.  What is left here: the product launch is bound
// by its copies into shared memory (a tile of the size the registers
// allow, 128 x 64, takes 6 KB of V and U a k16 step for 262 K operations),
// and the input transform runs below the memory rate.
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
// Build switches split a launch's time for tools/profile_conv_bf16.py, and
// give wrong sums.  The two-launch product (--dtype winograd_bf16):
// -DFVT_DIAG_PRODUCTS_ONLY starts no copy and waits for none,
// -DFVT_DIAG_COPIES_ONLY runs the wgmma of each position's first slice
// only, -DFVT_DIAG_NO_STORE keeps y in the registers.  The fused kernel
// (--dtype winograd_bf16_fused): -DFVT_DIAG_PRODUCTS_ONLY as above (the
// fragments from whatever shared memory holds), -DFVT_DIAG_NO_FRAGMENTS
// forms V from no shared-memory read, -DFVT_DIAG_NO_PRODUCTS issues no
// wgmma, -DFVT_DIAG_NO_STORE as above, -DFVT_DIAG_NO_GLOBAL_STORE stages
// y in shared memory and writes none of it.

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

// The four output phases of a warp's 16 rows (tiles row0 .. row0+15) and
// kBN output channels from n0, as bf16, into y (N, H, W, Co).  Thread
// (warp, lane) holds rows lane/4 (+ 8) and columns 8*j + 2*(lane % 4) (+ 1)
// of its 16 x kBN block in out[q][4*j + 2*half (+ 1)]; row p is the 2x2
// tile (f, ty, tx), phase q = 2i + jj its pixel (f, 2ty + i, 2tx + jj),
// cropped at odd H or W.  A phase leaves through the warp's 16 staged rows
// at `stage`, so that y is written 16 bytes a thread, a pixel's kBN
// channels side by side (4-byte stores straight from the accumulator
// layout took a third of the product launch); a staged row takes kPitch
// bytes, which spreads a warp's 8 rows over the banks.
__device__ __forceinline__ void store_phases(__nv_bfloat16* y,
                                             const float (&out)[4][kBN / 2],
                                             unsigned char* stage, int row0,
                                             int n0, int P, int th, int tw,
                                             int H, int W, int Co) {
  const int lane = threadIdx.x & 31;
  // lanes 0..15: the tile of row lane, f = -1 beyond P
  int f = -1, oy = 0, ox = 0;
  {
    const int p = row0 + (lane & 15);
    if (p < P) {
      const int per = th * tw;
      f = p / per;
      const int r = p - f * per;
      oy = 2 * (r / tw), ox = 2 * (r % tw);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int py = oy + (q >> 1), px = ox + (q & 1);
    const int pix = f >= 0 && py < H && px < W ? (f * H + py) * W + px : -1;
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
#ifdef FVT_DIAG_NO_GLOBAL_STORE
      if (v == -2)  // never: y staged but not written
#else
      if (v >= 0 && n0 + 8 * j < Co)
#endif
        *reinterpret_cast<uint4*>(y + (size_t)v * Co + n0 + 8 * j) =
            *reinterpret_cast<const uint4*>(stage + r * kPitch + j * 16);
    }
  }
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

#ifdef FVT_DIAG_NO_STORE
    continue;
#endif
    store_phases(a.y, out, stage, r0 + wg * 64 + warp * 16, n0, a.P, a.th,
                 a.tw, a.H, a.W, a.Co);
  }
}

// ---------------------------------------------------------------------------
// The fused kernel (the header note's first part).

constexpr int kUBytes = 16 * kKC * kBN * 2;  // U of a k16 step, 16 positions
constexpr int kMaxLoads = 4;  // loads of kLoad positions a pixel and chunk

struct FusedArgs {
  const __nv_bfloat16* x;  // (N, H, W, C)
  const __nv_bfloat16* u;  // packed as fvt_winograd_bf16_forward's
  __nv_bfloat16* y;        // (N, H, W, Co)
  int N, H, W, C, Co;
  int th, tw;   // tiles a frame: ceil(H/2), ceil(W/2)
  int P;        // tiles in all: N * th * tw
  int ext;      // positions of the extended grid a frame: (th+1)*(tw+1)
  int E;        // positions in all: N * ext
  int e_pad;    // staged positions a pixel and chunk: loads * kLoad
  int loads;    // loads a pixel and chunk a k16 step
  int n_tiles;  // column tiles: ceil(Co / kBN)
  int tiles;    // ceil(P / kRows) * n_tiles
};

// the position of tile p on the extended grid
__host__ __device__ __forceinline__ int ext_index(const FusedArgs& a, int p) {
  const int per = a.th * a.tw;
  const int f = p / per, r = p - f * per;
  const int ty = r / a.tw;
  return f * a.ext + ty * (a.tw + 1) + (r - ty * a.tw);
}

// bf16x2 a + S*b (S = +1 or -1), rounded to nearest even once
template <int S>
__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162 r = S > 0 ? __hadd2(x, y) : __hsub2(x, y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// B^T's row K along one axis of the four taps z0 .. z3 (as bt8 above)
template <int K>
__device__ __forceinline__ uint32_t bt_row(uint32_t z0, uint32_t z1,
                                           uint32_t z2, uint32_t z3) {
  if constexpr (K == 0) return badd<-1>(z0, z2);
  if constexpr (K == 1) return badd<1>(z1, z2);
  if constexpr (K == 2) return badd<-1>(z2, z1);
  return badd<-1>(z1, z3);
}

// The staged tap (R, Cc) of a tile's patch (row R, column Cc), from the
// tile's base: `tap` bytes between the staged pixels (R%2, Cc%2), `row`
// bytes between rows of the extended grid, 16 bytes between its columns
template <int R, int Cc>
__device__ __forceinline__ uint32_t lds_tap(const unsigned char* base,
                                            int tap, int row) {
  return *reinterpret_cast<const uint32_t*>(
      base + (2 * (R & 1) + (Cc & 1)) * tap + (R >> 1) * row + (Cc >> 1) * 16);
}

// Position row A's fragments v[b][k] = V_Ab of this thread's tile k&1 and
// channel chunk k>>1: B^T's row A over the patch's rows first (tap rows r0
// and r1 of each column), then B^T's rows b over the columns, each add
// rounded to bf16, as input_transform
template <int A>
__device__ __forceinline__ void fragments(const unsigned char* const (&base)[4],
                                          int tap, int row,
                                          uint32_t (&v)[4][4]) {
  constexpr int r0 = A == 2 ? 2 : A == 0 ? 0 : 1;
  constexpr int r1 = A == 2 ? 1 : A == 3 ? 3 : 2;
  constexpr int sg = A == 1 ? 1 : -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t t0 = badd<sg>(lds_tap<r0, 0>(base[k], tap, row),
                                 lds_tap<r1, 0>(base[k], tap, row));
    const uint32_t t1 = badd<sg>(lds_tap<r0, 1>(base[k], tap, row),
                                 lds_tap<r1, 1>(base[k], tap, row));
    const uint32_t t2 = badd<sg>(lds_tap<r0, 2>(base[k], tap, row),
                                 lds_tap<r1, 2>(base[k], tap, row));
    const uint32_t t3 = badd<sg>(lds_tap<r0, 3>(base[k], tap, row),
                                 lds_tap<r1, 3>(base[k], tap, row));
    v[0][k] = bt_row<0>(t0, t1, t2, t3);
    v[1][k] = bt_row<1>(t0, t1, t2, t3);
    v[2][k] = bt_row<2>(t0, t1, t2, t3);
    v[3][k] = bt_row<3>(t0, t1, t2, t3);
  }
}

// d += Sign * V @ U, nothing where Sign is 0
template <int Sign>
__device__ __forceinline__ void product(float (&d)[kBN / 2],
                                        const uint32_t (&v)[4],
                                        uint64_t desc_b) {
  if constexpr (Sign != 0) wgmma_rs_m64n64k16<Sign>(d, v, desc_b);
}

// V_AB U_AB into output phase 2i + j with the sign A^T[i][A] * A^T[j][B]
// (none where it is 0); desc is U's at position 0
template <int A, int B>
__device__ __forceinline__ void products_b(float (&out)[4][kBN / 2],
                                           const uint32_t (&v)[4],
                                           uint64_t desc) {
  const uint64_t d = desc + (((4 * A + B) * kKC * kBN * 2) >> 4);
  product<at(0, A) * at(0, B)>(out[0], v, d);
  product<at(0, A) * at(1, B)>(out[1], v, d);
  product<at(1, A) * at(0, B)>(out[2], v, d);
  product<at(1, A) * at(1, B)>(out[3], v, d);
}

// Position rows 1 and 2 of one k16 step together, as position_row below:
// B^T's rows 1 and 2 take the same tap rows (1 and 2), read once for both
__device__ __forceinline__ void fragments12(
    const unsigned char* const (&base)[4], int tap, int row,
    uint32_t (&v1)[4][4], uint32_t (&v2)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t t1[4], t2[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t d1 = *reinterpret_cast<const uint32_t*>(
          base[k] + (2 + (c & 1)) * tap + (c >> 1) * 16);
      const uint32_t d2 = *reinterpret_cast<const uint32_t*>(
          base[k] + (c & 1) * tap + row + (c >> 1) * 16);
      t1[c] = badd<1>(d1, d2);
      t2[c] = badd<-1>(d2, d1);
    }
    v1[0][k] = bt_row<0>(t1[0], t1[1], t1[2], t1[3]);
    v1[1][k] = bt_row<1>(t1[0], t1[1], t1[2], t1[3]);
    v1[2][k] = bt_row<2>(t1[0], t1[1], t1[2], t1[3]);
    v1[3][k] = bt_row<3>(t1[0], t1[1], t1[2], t1[3]);
    v2[0][k] = bt_row<0>(t2[0], t2[1], t2[2], t2[3]);
    v2[1][k] = bt_row<1>(t2[0], t2[1], t2[2], t2[3]);
    v2[2][k] = bt_row<2>(t2[0], t2[1], t2[2], t2[3]);
    v2[3][k] = bt_row<3>(t2[0], t2[1], t2[2], t2[3]);
  }
}

__device__ __forceinline__ void position_rows12(
    const unsigned char* const (&base)[4], int tap, int row, uint64_t desc,
    float (&out)[4][kBN / 2]) {
  uint32_t v1[4][4], v2[4][4];
#ifdef FVT_DIAG_NO_FRAGMENTS
#pragma unroll
  for (int k = 0; k < 16; ++k) {  // no shared-memory read, no add
    v1[k / 4][k % 4] = (uint32_t)(size_t)base[k % 4] ^ (16 + k);
    v2[k / 4][k % 4] = (uint32_t)(size_t)base[k % 4] ^ (32 + k);
  }
#else
  fragments12(base, tap, row, v1, v2);
#endif
#ifdef FVT_DIAG_NO_PRODUCTS
#pragma unroll
  for (int k = 0; k < 16; ++k)  // the fragments stay computed
    asm volatile("" ::"r"(v1[k / 4][k % 4]), "r"(v2[k / 4][k % 4]));
  return;
#endif
  wgmma_fence();
  products_b<1, 0>(out, v1[0], desc);
  products_b<1, 1>(out, v1[1], desc);
  products_b<1, 2>(out, v1[2], desc);
  products_b<1, 3>(out, v1[3], desc);
  products_b<2, 0>(out, v2[0], desc);
  products_b<2, 1>(out, v2[1], desc);
  products_b<2, 2>(out, v2[2], desc);
  products_b<2, 3>(out, v2[3], desc);
  wgmma_commit();
  wgmma_wait<0>();
}

// Position row A (0 or 3) of one k16 step: its fragments, its products,
// and a wait for them before the next rows overwrite the fragments
template <int A>
__device__ __forceinline__ void position_row(
    const unsigned char* const (&base)[4], int tap, int row, uint64_t desc,
    float (&out)[4][kBN / 2]) {
  uint32_t v[4][4];
#ifdef FVT_DIAG_NO_FRAGMENTS
#pragma unroll
  for (int k = 0; k < 16; ++k)  // no shared-memory read, no add
    v[k / 4][k % 4] = (uint32_t)(size_t)base[k % 4] ^ (A * 16 + k);
#else
  fragments<A>(base, tap, row, v);
#endif
#ifdef FVT_DIAG_NO_PRODUCTS
#pragma unroll
  for (int k = 0; k < 16; ++k)  // the fragments stay computed
    asm volatile("" ::"r"(v[k / 4][k % 4]));
  return;
#endif
  wgmma_fence();  // v written (and the zeroed phases, before the first row)
  products_b<A, 0>(out, v[0], desc);
  products_b<A, 1>(out, v[1], desc);
  products_b<A, 2>(out, v[2], desc);
  products_b<A, 3>(out, v[3], desc);
  wgmma_commit();
  wgmma_wait<0>();
}

// A block is kWG consumer warpgroups and one producer warpgroup and walks
// the (row tile, column tile) pairs blockIdx.x, blockIdx.x + gridDim.x,
// ...  A ring of kRing slots of one k16 step each: x staged as [pixel
// (r%2, c%2)][chunk][e_pad positions][16 bytes], then U at the 16
// positions, 2 KB each, as wgmma reads them.
template <int kRing>
__global__ void __launch_bounds__(kThreads, 1)
    fused_kernel(FusedArgs a, const __grid_constant__ CUtensorMap x_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  static_assert(kRing <= 8, "the barriers take the first 128 bytes");
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t full = smem_u32(smem), empty = full + 64;
  unsigned char* ring = smem + 128;
  const int x_bytes = 128 * a.e_pad;
  const int slot_bytes = x_bytes + kUBytes;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slices = a.C / kKC;
  // the warpgroup, as a value ptxas knows to be the same across a warp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  if (wg == kWG) {
    // The producer's first warp.  Lane i < 8*loads brings load i % loads
    // of chunk (i / loads) % 2 of pixel i / (2*loads) (the pixel its im2col
    // offsets), lanes 0..15 U's position `lane`, and lane 0 sets the bytes
    // to expect; all counted on the slot's `full`.  A load that would
    // start past the last position is left out: no tile reads there.
    setmaxnreg_dec<kProducerRegs>();
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    if (tid >= 128 * kWG + 32) return;
    const int l = lane % a.loads, chunk = (lane / a.loads) & 1;
    const int pix = lane / (2 * a.loads);
    unsigned it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int n_tile = tile % a.n_tiles;
      const int e0 = ext_index(a, (tile / a.n_tiles) * kRows);
      int valid = 0;  // loads a pixel and chunk that start inside
      while (valid < a.loads && e0 + valid * kLoad < a.E) ++valid;
      const bool mine = lane < 8 * a.loads && l < valid;
      int w = 0, h = 0, n = 0;  // where this lane's load starts
      if (mine) {
        const int e = e0 + l * kLoad;
        n = e / a.ext;
        const int r = e - n * a.ext;
        h = 2 * (r / (a.tw + 1)) - 1;
        w = 2 * (r % (a.tw + 1)) - 1;
      }
      for (int s = 0; s < slices; ++s, ++it) {
        const int slot = it % kRing;
        mbar_wait(empty + 8 * slot, ((it / kRing) & 1) ^ 1);
        const uint32_t sa = smem_u32(ring + (size_t)slot * slot_bytes);
        const uint32_t bar = full + 8 * slot;
        if (lane == 0) mbar_expect_tx(bar, 8 * valid * kLoad * 16 + kUBytes);
        if (mine)
          tma_im2col(sa + ((2 * pix + chunk) * a.e_pad + l * kLoad) * 16,
                     &x_map, s * kKC + 8 * chunk, w, h, n, bar, pix & 1,
                     pix >> 1);
        if (lane < 16)
          bulk_copy(sa + x_bytes + lane * (kUBytes / 16),
                    a.u + (((size_t)lane * a.n_tiles + n_tile) * slices + s) *
                              (kKC * kBN),
                    kUBytes / 16, bar);
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg holds the row tile's tiles 64*wg + [0, 64).
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = (tid >> 5) & 3;
  unsigned char* stage = ring + (size_t)kRing * slot_bytes +
                         (size_t)(wg * 4 + warp) * 16 * kPitch;
  const int tap = 2 * a.e_pad * 16;  // bytes between staged pixels
  const int row = (a.tw + 1) * 16;   // bytes between extended grid rows
  float out[4][kBN / 2];             // the output phases 2i + j
  unsigned it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int n0 = (tile % a.n_tiles) * kBN;
    const int p0 = (tile / a.n_tiles) * kRows;
    const int e0 = ext_index(a, p0);
    // byte offsets of this thread's staged values, k = chunk*2 + tile:
    // its tiles are rows lane/4 and lane/4 + 8 of its warp's 16 (one
    // beyond P reads position 0; its sums are dropped), its channels
    // 2*(lane%4) + {0, 1} of each 8-channel chunk
    int off[4];
    {
      const int p = p0 + wg * 64 + warp * 16 + (lane >> 2);
      off[0] = (p < a.P ? (ext_index(a, p) - e0) * 16 : 0) + (lane & 3) * 4;
      off[1] = (p + 8 < a.P ? (ext_index(a, p + 8) - e0) * 16 : 0) +
               (lane & 3) * 4;
      off[2] = off[0] + a.e_pad * 16;
      off[3] = off[1] + a.e_pad * 16;
    }
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e)
      out[0][e] = out[1][e] = out[2][e] = out[3][e] = 0.f;
    for (int s = 0; s < slices; ++s, ++it) {
      const int slot = it % kRing;
#ifndef FVT_DIAG_PRODUCTS_ONLY
      mbar_wait(full + 8 * slot, (it / kRing) & 1);  // the step has landed
#endif
      const unsigned char* xs = ring + (size_t)slot * slot_bytes;
      const unsigned char* const base[4] = {xs + off[0], xs + off[1],
                                            xs + off[2], xs + off[3]};
      const uint64_t desc =
          make_desc(smem_u32(xs + x_bytes), (kBN / 8) * 128, 128);
      position_row<0>(base, tap, row, desc, out);
      position_rows12(base, tap, row, desc, out);
      position_row<3>(base, tap, row, desc, out);
      if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp has read it
    }
#ifdef FVT_DIAG_NO_STORE
    continue;
#endif
    store_phases(a.y, out, stage, p0 + wg * 64 + warp * 16, n0, a.P, a.th,
                 a.tw, a.H, a.W, a.Co);
  }
}

template <int kRing>
constexpr size_t fused_smem(int e_pad) {
  return 128 + (size_t)kRing * (128 * (size_t)e_pad + kUBytes) + kStageBytes;
}

template <int kRing>
cudaError_t launch_fused_ring(const FusedArgs& a, const CUtensorMap& map,
                              cudaStream_t stream) {
  const size_t bytes = fused_smem<kRing>(a.e_pad);
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(fused_kernel<kRing>, kThreads,
                                            bytes, a.tiles, &blocks);
  if (err != cudaSuccess) return err;
  fused_kernel<kRing><<<blocks, kThreads, bytes, stream>>>(a, map);
  return cudaGetLastError();
}

// e_pad and loads: the positions a row tile stages a pixel and chunk,
// e(p_last) + tw + 3 - e(p0), bounded over the row tiles by their 127 steps
// in p and the tile rows and frames those cross (at most the whole grid's
// span), rounded up to whole loads; more than kMaxLoads is refused (a row
// tile that crosses a frame of W above about 380).  ops/winograd.py's
// fused_plan is the same plan.
cudaError_t fused_plan(FusedArgs* a) {
  const long long tw = a->tw, per = (long long)a->th * a->tw;
  const long long steps = kRows - 1;
  long long rows = (steps + tw - 1) / tw, frames = (steps + per - 1) / per;
  if (rows > (long long)a->N * a->th - 1) rows = (long long)a->N * a->th - 1;
  if (frames > a->N - 1) frames = a->N - 1;
  long long span = steps + rows + frames * (tw + 1) + tw + 3;
  const long long whole = (long long)ext_index(*a, a->P - 1) + tw + 3;
  if (whole < span) span = whole;
  const long long loads = (span + kLoad - 1) / kLoad;
  if (loads > kMaxLoads) return cudaErrorInvalidValue;
  a->loads = (int)loads;
  a->e_pad = a->loads * kLoad;
  return cudaSuccess;
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

// y = conv3x3(x, g) by Winograd on `stream` in one launch (the fused
// kernel), from u = bf16(G g G^T) (16, C, Co) packed as for
// fvt_winograd_bf16_forward.  x (N, H, W, C) and y (N, H, W, Co) bf16,
// contiguous and 16-byte aligned; C a multiple of 16, Co of 8.  Returns
// cudaSuccess, the error of the launch or an attribute call, or
// cudaErrorInvalidValue for what the kernel does not take: another C or
// Co, N*H*W or N*(ceil(H/2)+1)*(ceil(W/2)+1) beyond 2^31 - 1, or a row
// tile whose staged positions pass kMaxLoads loads (fused_plan).
int fvt_winograd_bf16_fused_forward(const void* x, const void* up, void* y,
                                    int N, int H, int W, int C, int Co,
                                    void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 || Co % 8)
    return (int)cudaErrorInvalidValue;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const long long E = (long long)N * (th + 1) * (tw + 1);
  if (E + kMaxLoads * kLoad > 2147483647LL ||
      (long long)N * H * W > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  FusedArgs a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)up,
              (__nv_bfloat16*)y, N, H, W, C, Co, th, tw, N * th * tw,
              (th + 1) * (tw + 1), (int)E, 0, 0, 0, 0};
  cudaError_t err = fused_plan(&a);
  if (err != cudaSuccess) return (int)err;
  a.n_tiles = (Co + kBN - 1) / kBN;
  const long long tiles = ((long long)a.P + kRows - 1) / kRows * a.n_tiles;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  // the extended grid's walk: every other column from -1 to 2tw - 1, every
  // other row from -1 to 2th - 1
  CUtensorMap x_map;
  err = make_x_map(x, N, H, W, C, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 8,
                   &x_map, 2, 2 * tw - W, 2 * th - H);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(fused_smem<3>(a.e_pad) <= (size_t)kMaxSmem
                   ? launch_fused_ring<3>(a, x_map, st)
                   : launch_fused_ring<2>(a, x_map, st));
}

}  // extern "C"
