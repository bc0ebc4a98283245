// The eval-mode identity BottleneckIR block on bf16 tensors (B5 under
// --amp) on Hopper's warpgroup matrix multiply (sm_90a), in two launches of
// a kernel of its own:
//   conv1:  v = bf16(prelu(conv3x3(bf16(a1*x + b1), w1), alpha)), the
//           affine's input 0 outside the image;
//   conv2:  y = bf16((conv3x3(v, w2)*a2 + b2) + x).
// Replaces fvt_tpu/ops/bottleneck_pallas.py::_block_kernel (the Pallas
// kernel behind bottleneck_ir_fused) on bf16 arrays.  The Pallas kernel's
// rounding points are the contract: bn1's affine in fp32 (__fmul_rn, then
// __fadd_rn) rounded to bf16 once at image pixels and exact 0 at every pad;
// conv1's fp32 sums through PReLU unrounded, v rounded once; conv2's store
// (acc*a2 + b2) + x in fp32 in that order, rounded once.  The products of a
// tile are summed per 16-channel slice in order, nine taps a slice, as in
// conv3x3_wgmma.cu's design of this block (fvt_bottleneck_bf16_forward,
// kept there, timed, on no path), so v and y are that design's bit for bit.
//
// What bounds it.  A block is 2 * 2*9*C*C operations a pixel: 0.283 TFLOP
// at every stage of the IR-50 on 2400 frames, 0.57 ms at the bf16 peak,
// against 6*C bytes a pixel of x, v and y; the tensor cores bound it.  The
// padded line computes (H+1)(W+1)/(HW) of the products (1.05x at 40x40 to
// 1.44x at 5x5).
//
// What it keeps of the bf16 conv (conv3x3_wgmma.cu): the padded line (all
// frames on one line of Q = N*(H+1)*(W+1) coordinates, the neighbour (dy,
// dx) of a coordinate (dy-1)*(W+1) + dx-1 further, the nine taps as
// descriptor offsets into one staged patch a 16-channel slice), its TMA
// staging through an im2col tensor map whose zero fill is the pad, the
// persistent grid walking (row tile of 256 coordinates, column tile of BN
// output channels) pairs, and a ring of full / empty mbarriers between a
// producer warp and the consumer warpgroups.  A block is four consumer
// warpgroups (64 rows of a tile each) and a producer warpgroup whose
// registers go to the consumers (setmaxnreg): one block an SM at BN = 64 and
// at BN = 128.  What it does about the earlier design's elementwise work, each
// of which ran there while no product did:
// 1. bn1 under the products.  The consumers issue slice s's wgmma, and
//    while they run wait for slice s+1's copies (of the next tile where s is
//    the last), rewrite its staged x as bf16(a1*x + b1), 0 at the pads,
//    fence the rewrite for the async proxy and arrive on the slot's `ready`
//    barrier; then wait for slice s.  A warpgroup multiplies s+1 once every
//    consumer warp has arrived on its `ready`: no warpgroup waits for
//    another's products (a named barrier after the wait did, and cost
//    0.5-1 ms a forward, PERF.md §6).  The ring holds three or four slots
//    (multiplied, rewritten, landing).  Which staged rows of a tile are
//    pixels is found once a tile, as bits, before its products.
//    The other choice, warps 1-3 of the producer warpgroup rewriting each
//    slot between its `full` barrier and `ready`, measured 15% slower (96
//    threads rewrite 768 rows a step) and was left out (PERF.md §6).
// 2. v and y stored under the next tile's products.  A tile's rows stay
//    staged in shared memory and are written to device memory between the
//    next tile's first wgmma and its wait, 16 bytes a lane, with predicated
//    stores and no branch (conv3x3_s8_wgmma.cu's method).
// 3. The residual read whole.  For conv2 the producer asks the copy engine
//    for the tile's residual rows, the same im2col walk at the output
//    coordinates by 64 channels (128 bytes a row) under the 128-byte
//    swizzle, into the very rows y is staged in, counted on a barrier of
//    their own; it asks after every consumer warp has written the tile
//    before's y out (a second barrier).  The epilogue reads x there in the
//    accumulator's layout, adds it in fp32 and writes y in its place.  The
//    staged rows are 256 x BN bf16 in 64-channel chunks of 128-byte rows,
//    swizzled as the copy engine swizzles (the 16-byte unit u of row r at u
//    ^ (r % 8)), so that neither the accumulator layout's 4-byte accesses
//    nor the 16-byte ones of the stores meet on a bank.
// The pads stay: every tile multiplies its pad coordinates and drops them.
//
// Refused: C not a multiple of 16, frames wider than 126 (the staged patch
// a slice, 256 + 2*(W+1) + 2 coordinates rounded up to 128, must stay
// within 512 so that the ring of three or four slots and the staged rows
// fit the 227 KB of shared memory: 3 slots at BN = 128, 4 at BN = 64;
// at 512 coordinates and C = 512 even three do not), N*(H+1)*(W+1) or
// N*H*W past 2^31 - 4096.  Mirrored by ops/bottleneck.py bf16_block_plan.
//
// Build switches split the time for tools/profile_conv_bf16.py (--dtype
// bottleneck_bf16), and give wrong sums: -DFVT_DIAG_PRODUCTS_ONLY starts no
// copy and waits for none, -DFVT_DIAG_COPIES_ONLY runs the wgmma of a tile's
// first slice only, -DFVT_DIAG_NO_BN1 leaves conv1's staged x as it landed
// (no rewrite, no barrier), -DFVT_DIAG_NO_GLOBAL_STORE writes no v or y.

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kKC = 16;                    // input channels a slice (k16)
constexpr int kWG = 4;                     // consumer warpgroups, 64 rows each
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxP = 512;    // staged coordinates a slice, at most
constexpr int kRw = 2;        // rows a consumer rewrites a slice, at most
constexpr int kSwRow = 128;   // a staged row of one 64-channel chunk, bytes
constexpr int kChunkBytes = kBM * kSwRow;  // a chunk of a tile's rows
// the barriers (256 bytes), then up to 1023 bytes to align the staged rows
constexpr int kHead = 256 + 1024;
// the producer warpgroup gives registers to the consumers: ptxas hands them
// out by warpgroups, so a producer warp alone would cost as much.  A block
// starts with kStartRegs a thread (65536 / 640, rounded down to 8), and what
// the consumers take the producer must have given up: setmaxnreg.inc waits
// for the block's own pool
constexpr int kStartRegs = 96;
constexpr int kProducerRegs = 32, kConsumerRegs = 112;
static_assert(kThreads * kStartRegs <= 65536 &&
                  128 * (kStartRegs - kProducerRegs) >=
                      kConsumers * (kConsumerRegs - kStartRegs),
              "the registers of an SM");
static_assert(kRw * 2 * 128 >= kMaxP, "the rewrite covers a slot");

enum Stage { kConv1 = 1, kConv2 = 2 };

struct BlockArgs {
  const __nv_bfloat16* w;  // the conv's packed weights
  __nv_bfloat16* out;      // conv1: v; conv2: y
  const float* va;         // conv1: a1; conv2: a2
  const float* vb;         // conv1: b1; conv2: b2
  const float* alpha;      // conv1: the PReLU slopes
  int H, W, C;
  int P;        // staged coordinates a slice: kBM + 2*(W+1) + 2, up to kLoad
  int Q;        // padded coordinates: N*(H+1)*(W+1)
  int slices;   // C / 16
  int n_tiles;  // column tiles: ceil(C / BN)
  int tiles;    // row tiles times column tiles
};

// the ring's slots: BN = 64 four, BN = 128 three (what fits at P = 512)
__host__ __device__ constexpr int ring_slots(int BN) {
  return BN == 64 ? 4 : 3;
}

// a ring slot: the staged patch (two 8-channel chunks of P coordinates),
// then the nine taps' weights of the slice
__host__ __device__ constexpr int slot_bytes(int P, int BN) {
  return 2 * P * 16 + 9 * kKC * BN * 2;
}

// the vectors in shared memory, in floats: conv1 a1, b1 (C), alpha (T);
// conv2 a2, b2 (T); T = ceil(C / BN) * BN, zeros past C.  One bound for both.
__host__ __device__ constexpr int vec_floats(int C, int BN) {
  return 2 * C + 2 * ((C + BN - 1) / BN) * BN;
}

constexpr size_t smem_bytes(int P, int BN, int C) {
  return kHead + (size_t)kBM * BN * 2 +
         (size_t)ring_slots(BN) * slot_bytes(P, BN) + 4 * vec_floats(C, BN);
}

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

// Code a consumer runs while wgmma are in flight holds no branch that ptxas
// could take for a divergent one (it would wait for the wgmma there): these
// store and wait under a predicate.

__device__ __forceinline__ void st_global_if(bool p, void* ptr, uint4 v) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %0, 0;\n"
      "@q st.global.v4.b32 [%1], {%2, %3, %4, %5};\n"
      "}\n" ::"r"((int)p),
      "l"(ptr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}

// mbar_wait_uniform where p holds; nothing where it does not
__device__ __forceinline__ void mbar_wait_uniform_if(bool p, uint32_t bar,
                                                     int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "setp.eq.b32 p, %2, 0;\n"
      "@p bra DONE;\n"
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
      "r"(parity), "r"((int)p)
      : "memory");
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

// bn1 over the rows r = first + k*stride, k < kRows, of a slot's staged
// [chunk][coordinate] patch (row r is chunk r / P, coordinate r % P) where
// bit k of `rows` is set: bf16(a1*x + b1) where bit k of `pixel` is set, 0
// elsewhere, a1 and b1 of the slice at m and m + C; the other k read and
// write the 16 bytes at `spare`.  Branch-free and unpredicated (ptxas
// 12.9 crashed on predicated stores before the fence with wgmma in
// flight).  The caller fences the rows for wgmma's async proxy.
template <int kRows>
__device__ __forceinline__ void bn1_rows(unsigned char* slot, int first,
                                         int stride, unsigned rows,
                                         unsigned pixel, int P,
                                         const float* m, int C,
                                         unsigned char* spare) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = first + k * stride;
    uint4* at = reinterpret_cast<uint4*>((rows >> k) & 1u ? slot + r * 16
                                                          : spare);
    const float* mc = m + (r >= P ? 8 : 0);
    uint4 val = bn1_row(*at, mc, mc + C);
    const uint32_t keep = 0u - ((pixel >> k) & 1u);
    val.x &= keep, val.y &= keep, val.z &= keep, val.w &= keep;
    *at = val;
  }
}

// this thread's shared-memory writes, seen by wgmma's async proxy
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bit k set where the row first + k*stride (of the `rows` bits) of a slot
// staged for the tile at q0 is an image pixel: q0 + its coordinate below Q,
// the coordinate's row and column on the line not 0.
template <int kRows>
__device__ __forceinline__ unsigned pixel_bits(int q0, int first, int stride,
                                               unsigned rows, int P, int Q,
                                               int frame, int W1) {
  unsigned bits = 0;
  for (int k = 0; k < kRows; ++k) {
    const int r = first + k * stride;
    const int q = q0 + (r >= P ? r - P : r);
    if (!((rows >> k) & 1u) || q >= Q) continue;
    const int rem = q % frame, row = rem / W1;
    if (row != 0 && rem - row * W1 != 0) bits |= 1u << k;
  }
  return bits;
}

template <int BN, Stage kStage>
__global__ void __launch_bounds__(kThreads, 1)
    bottleneck_bf16_kernel(BlockArgs a,
                           const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap r_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int S = ring_slots(BN);
  constexpr bool kFirst = kStage == kConv1;
#ifdef FVT_DIAG_NO_BN1
  constexpr bool kBn1 = false;
#else
  constexpr bool kBn1 = kFirst;
#endif
  constexpr int kBBytes = 9 * kKC * BN * 2, kTapBytes = kKC * BN * 2;
  constexpr int kPieces = BN / 8;  // 16-byte pieces of a staged row
  const int tid = threadIdx.x, lane = tid & 31;
  const int P = a.P, W1 = a.W + 1, T = a.n_tiles * BN;
  const int frame = (a.H + 1) * W1;
  const int a_bytes = 2 * P * 16, stage_bytes = a_bytes + kBBytes;
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base, empty = base + 64, ready = base + 128;
  const uint32_t res_full = base + 192, res_empty = base + 200;
  unsigned char* spare = smem + 240;  // bn1's rows past the patch
  // the staged rows, 1024-aligned (the copy engine's 128-byte swizzle),
  // then the ring, then the vectors
  const uint32_t out_u32 = (base + 256 + 1023) & ~1023u;
  unsigned char* out = smem + (out_u32 - base);
  const uint32_t ring = out_u32 + kBM * BN * 2;
  float* vec = reinterpret_cast<float*>(smem + (ring - base) +
                                        (size_t)S * stage_bytes);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kWG);
      mbar_init(ready + 8 * i, 4 * kWG);
    }
    mbar_init(res_full, 1);
    mbar_init(res_empty, 4 * kWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const float* src[3] = {a.va, a.vb, a.alpha};
    const int len[3] = {kFirst ? a.C : T, kFirst ? a.C : T, kFirst ? T : 0};
    float* dst = vec;
    for (int v = 0; v < 3; ++v) {
      for (int i = tid; i < len[v]; i += kThreads)
        dst[i] = i < a.C ? src[v][i] : 0.f;
      dst += len[v];
    }
  }
  __syncthreads();
  // the warpgroup and warp, as values ptxas knows to be the same across a
  // warp (setmaxnreg wants its warpgroup's threads together)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);

  if (wg == kWG) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp > 0) return;
    // The producer warp.  Per slice it waits until the slot is empty, then
    // its first lanes each ask the copy engine for kLoad coordinates of one
    // 8-channel chunk (the tile stages q0 + [0, P); its sums are those of
    // q0 + W1 + 1 + [0, kBM)) and lane 0 for the slice's packed weights,
    // all counted on the slot's `full`.  A load that would start past the
    // last frame is left out and its coordinates zeroed.  conv2: after the
    // tile's S-th slice (or its last), once every consumer warp has written
    // the tile before's y out (`res_empty`), lanes 2c + h ask for the
    // residual rows q0 + W1 + 1 + h*kLoad + [0, kLoad) by the 64 channels
    // of chunk c, counted on `res_full`.
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    const int loads = P / kLoad;
    const int res_at = (S < a.slices ? S : a.slices) - 1;
    unsigned it = 0, t = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++t) {
      const int q0 = (tile / a.n_tiles) * kBM, n_tile = tile % a.n_tiles;
      int valid = 0;  // loads a chunk that start inside the tensor
      while (valid < loads && q0 + valid * kLoad < a.Q) ++valid;
      int lw = 0, lh = 0, ln = 0;  // where this lane's load starts
      if (lane < 2 * valid) {
        const int q = q0 + (lane >> 1) * kLoad;
        const int f = q / frame, rem = q - f * frame;
        ln = f, lh = rem / W1 - 1, lw = rem % W1 - 1;
      }
      // conv2: the residual's loads; the first starts at the tile's first
      // output coordinate, inside the tensor
      int rw = 0, rh = 0, rn = 0, r_valid = 0;
      bool r_mine = false;
      if constexpr (!kFirst) {
        const int qr = q0 + W1 + 1;
        r_valid = qr + kLoad < a.Q ? 2 : 1;
        r_mine = lane < 2 * (BN / 64) && (lane & 1) < r_valid;
        if (r_mine) {
          const int q = qr + (lane & 1) * kLoad;
          const int f = q / frame, rem = q - f * frame;
          rn = f, rh = rem / W1 - 1, rw = rem % W1 - 1;
        }
      }
      for (int s = 0; s < a.slices; ++s, ++it) {
        const int slot = it % S;
        mbar_wait(empty + 8 * slot, ((it / S) & 1) ^ 1);
        const uint32_t sa = ring + slot * stage_bytes, bar = full + 8 * slot;
        if (valid < loads) {
          const int rest = P - valid * kLoad;
          for (int i = lane; i < 2 * rest; i += 32)
            *reinterpret_cast<uint4*>(
                smem + (sa - base) +
                ((i / rest) * P + valid * kLoad + i % rest) * 16) =
                make_uint4(0, 0, 0, 0);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
        }
        if (lane == 0) {
          mbar_expect_tx(bar, kBBytes + 2 * valid * kLoad * 16);
          bulk_copy(sa + a_bytes,
                    a.w + ((size_t)n_tile * a.slices + s) * (kBBytes / 2),
                    kBBytes, bar);
        }
        if (lane < 2 * valid)
          tma_im2col(sa + ((lane & 1) * P + (lane >> 1) * kLoad) * 16,
                     &x_map, s * kKC + (lane & 1) * 8, lw, lh, ln, bar);
        if constexpr (!kFirst) {
          if (s == res_at) {
            mbar_wait(res_empty, t & 1);
            if (lane == 0)
              mbar_expect_tx(res_full, r_valid * (BN / 64) * kLoad * kSwRow);
            __syncwarp();
            if (r_mine)
              tma_im2col(out_u32 + (lane >> 1) * kChunkBytes +
                             (lane & 1) * kLoad * kSwRow,
                         &r_map, n_tile * BN + 64 * (lane >> 1), rw, rh, rn,
                         res_full);
          }
        }
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg holds the sums of the tile's rows 64*wg +
  // [0, 64): thread (warp, lane) rows 16*warp + lane/4 (+ 8) and columns
  // 8*j + 2*(lane % 4) (+ 1) in acc[4*j + 2*half (+ 1)].
  setmaxnreg_inc<kConsumerRegs>();
  float acc[BN / 2];  // first written by a tile's first wgmma
  // bn1: this thread rewrites the coordinates c0 + 256k, k < kRw, of the
  // slot's chunk wg % 2
  const int c0 = (wg >> 1) * 128 + (tid & 127);
  const int first = (wg & 1) * P + c0;
  unsigned rows = 0;
#pragma unroll
  for (int k = 0; k < kRw; ++k)
    if (c0 + 256 * k < P) rows |= 1u << k;

  // ring step i, slice s: its wgmma started and committed
  auto issue = [&](unsigned i, int s) {
    const uint32_t sa = ring + (i % S) * stage_bytes;
    const uint64_t desc_a = make_desc(sa + wg * 64 * 16, P * 16, 128);
    const uint64_t desc_b = make_desc(sa + a_bytes, (BN / 8) * 128, 128);
    wgmma_fence();
#ifdef FVT_DIAG_COPIES_ONLY
    if (s == 0)
#endif
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      // a tap's rows start (dy*W1 + dx) coordinates of 16 B further
      const int shift = (tap / 3) * W1 + tap % 3;
      wgmma_bf16<BN>(acc, desc_a + shift, desc_b + tap * (kTapBytes >> 4),
                     s > 0 || tap > 0);
    }
    wgmma_commit();
  };
  // before step i's products: its copies landed (conv1: and every warp's
  // rewrite of them is done)
  auto landed = [&](unsigned i) {
#ifdef FVT_DIAG_PRODUCTS_ONLY
    if constexpr (!kBn1) return;
#endif
    mbar_wait((kBn1 ? ready : full) + 8 * (i % S), (i / S) & 1);
  };
  // bn1 over step i (slice s), the tile's pixels `pixel`, where `more`
  // (else there is no step i), fenced, and this warp's arrival on `ready`
  auto rewrite = [&](unsigned i, int s, unsigned pixel, bool more) {
#ifndef FVT_DIAG_PRODUCTS_ONLY
    mbar_wait_uniform_if(more, full + 8 * (i % S), (i / S) & 1);
#endif
    bn1_rows<kRw>(smem + (ring - base) + (i % S) * stage_bytes, first, 256,
                  more ? rows : 0u, pixel, P, vec + s * kKC, a.C, spare);
    fence_async();
    __syncwarp();
    mbar_arrive_if(more && lane == 0, ready + 8 * (i % S));
  };
  // step i's products done: its slot is free
  auto retire = [&](unsigned i) {
    wgmma_wait<0>();
    mbar_arrive_if(lane == 0, empty + 8 * (i % S));
  };
  // The staged rows of the tile before (their pixels in lanes 0..15 of
  // pend_pix, their first column pend_n0; -1 for none) to device memory,
  // 16 bytes a lane, without a branch
  int pend_pix = -1, pend_n0 = 0;
  auto flush = [&]() {
    constexpr int kRowsAPass = 32 / kPieces;
    const int piece = lane % kPieces, col = pend_n0 + 8 * piece;
#pragma unroll
    for (int k = 0; k < 16 / kRowsAPass; ++k) {
      const int r = lane / kPieces + kRowsAPass * k;
      const int R = wg * 64 + warp * 16 + r;
      const int v = __shfl_sync(0xffffffffu, pend_pix, r);
      const uint4 d = *reinterpret_cast<const uint4*>(
          out + (piece >> 3) * kChunkBytes + R * kSwRow +
          (((piece & 7) ^ (r & 7)) << 4));
#ifndef FVT_DIAG_NO_GLOBAL_STORE
      st_global_if(v >= 0 && col < a.C,
                   a.out + (size_t)(v < 0 ? 0 : v) * a.C + col, d);
#endif
    }
  };

  unsigned it = 0, t = 0, pixel = 0;
  if constexpr (kBn1) {
    // the block's first slice, before its first products
    if (blockIdx.x < (unsigned)a.tiles) {
      pixel = pixel_bits<kRw>((blockIdx.x / a.n_tiles) * kBM, first, 256,
                              rows, P, a.Q, frame, W1);
      rewrite(0, 0, pixel, true);
    }
  }
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++t) {
    const int q0 = (tile / a.n_tiles) * kBM, n0 = (tile % a.n_tiles) * BN;
    const int next = tile + gridDim.x;
    const bool has_next = next < a.tiles;
    unsigned pixel_next = 0;
    if constexpr (kBn1)
      if (has_next)
        pixel_next = pixel_bits<kRw>((next / a.n_tiles) * kBM, first, 256,
                                     rows, P, a.Q, frame, W1);
    // the pixel index of row 16*warp + lane of the warpgroup's 64 (lanes
    // 0..15), -1 for a pad or past the last frame
    int pix = -1;
    {
      const int q = q0 + W1 + 1 + wg * 64 + warp * 16 + (lane & 15);
      if (q < a.Q) {
        const int f = q / frame, rem = q - f * frame;
        const int row = rem / W1, col = rem - row * W1;
        if (row > 0 && col > 0) pix = (f * a.H + row - 1) * a.W + col - 1;
      }
    }
    // conv1: while slice s is multiplied, slice s+1, or the next tile's
    // first, is rewritten
    auto after = [&](int s) {
      if constexpr (kBn1) {
        const bool last = s + 1 == a.slices;
        rewrite(it + 1, last ? 0 : s + 1, last ? pixel_next : pixel,
                !last || has_next);
      }
      retire(it);
    };
    // step 0: the tile before's rows leave under its products
    landed(it);
    issue(it, 0);
    flush();
    if constexpr (!kFirst) {  // the rows are free for the residual
      __syncwarp();
      mbar_arrive_if(lane == 0, res_empty);
    }
    after(0);
    ++it;
    for (int s = 1; s < a.slices; ++s, ++it) {
      landed(it);
      issue(it, s);
      after(s);
    }
    pixel = pixel_next;

    // The epilogue acts on the fp32 sums in the accumulator's layout and
    // stages bf16 in the swizzled rows: the 4-byte pair of row R, column n
    // lies in chunk n / 64, unit (n % 64) / 8 ^ R % 8 (R % 8 = lane / 4).
#ifndef FVT_DIAG_PRODUCTS_ONLY
    if constexpr (!kFirst) mbar_wait(res_full, t & 1);  // the residual
#endif
    const float* ev = vec + (kFirst ? 2 * a.C : 0);  // alpha, or a2 and b2
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned char* row = out +
                           (wg * 64 + warp * 16 + (lane >> 2) + 8 * half) *
                               kSwRow +
                           4 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
            row + (j >> 3) * kChunkBytes + (((j & 7) ^ (lane >> 2)) << 4));
        float2 o = make_float2(acc[4 * j + 2 * half],
                               acc[4 * j + 2 * half + 1]);
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if constexpr (kFirst) {
          const float2 al = *reinterpret_cast<const float2*>(ev + n);
          o.x = o.x > 0.f ? o.x : __fmul_rn(al.x, o.x);
          o.y = o.y > 0.f ? o.y : __fmul_rn(al.y, o.y);
        } else {
          const float2 m = *reinterpret_cast<const float2*>(ev + n);
          const float2 b = *reinterpret_cast<const float2*>(ev + T + n);
          const float2 r = __bfloat1622float2(*at);
          o.x = __fadd_rn(affine(o.x, m.x, b.x), r.x);
          o.y = __fadd_rn(affine(o.y, m.y, b.y), r.y);
        }
        *at = __floats2bfloat162_rn(o.x, o.y);
      }
    }
    __syncwarp();
    pend_pix = pix, pend_n0 = n0;
  }
  flush();  // the last tile's rows
}

// The plan of a block, as ops/bottleneck.py bf16_block_plan computes it.
struct Plan {
  int bn, P, Q, n_tiles, tiles;
};

cudaError_t block_plan(int N, int H, int W, int C, Plan* p) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16)
    return cudaErrorInvalidValue;
  const long long q = (long long)N * (H + 1) * (W + 1);
  // a coordinate, a staged one past the last tile's and a pixel index fit
  // an int
  if (q > 2147483647LL - 4096) return cudaErrorInvalidValue;
  p->bn = C <= 64 ? 64 : 128;
  p->P = (kBM + 2 * (W + 1) + 2 + kLoad - 1) / kLoad * kLoad;
  if (p->P > kMaxP || smem_bytes(p->P, p->bn, C) > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  p->Q = (int)q;
  p->n_tiles = (C + p->bn - 1) / p->bn;
  p->tiles = (p->Q - (W + 2) + kBM - 1) / kBM * p->n_tiles;
  return cudaSuccess;
}

// The persistent grid of wgmma_common.cuh, one block a tile at most.
template <int BN, Stage kStage>
cudaError_t launch(const BlockArgs& a, const Plan& p, const CUtensorMap& x_map,
                   const CUtensorMap& r_map, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.P, BN, a.C);
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_blocks(bottleneck_bf16_kernel<BN, kStage>, kThreads, bytes,
                        p.tiles, &blocks);
  if (err != cudaSuccess) return err;
  bottleneck_bf16_kernel<BN, kStage>
      <<<blocks, kThreads, bytes, stream>>>(a, x_map, r_map);
  return cudaGetLastError();
}

template <Stage kStage>
cudaError_t run(const BlockArgs& a, const Plan& p, const CUtensorMap& x_map,
                const CUtensorMap& r_map, cudaStream_t stream) {
  return p.bn == 64 ? launch<64, kStage>(a, p, x_map, r_map, stream)
                    : launch<128, kStage>(a, p, x_map, r_map, stream);
}

}  // namespace

extern "C" {

// The eval-mode identity BottleneckIR block of x on bf16 tensors, on
// `stream`, in two launches (the header note): stage 1, conv1, x -> v;
// stage 2, conv2, v -> y.  `stages` 3 runs both; 1 or 2 one alone, for
// measurements.  x, the workspace v and y (N, H, W, C) bf16, contiguous and
// 16-byte aligned, C a multiple of 16; w1p and w2p the two convs' weights
// (9, C, C) in bf16, packed as conv3x3_wgmma.cu's fvt_conv3x3_bf16_forward
// reads them for Co = C at column tiles of 64 output channels where C <= 64
// and 128 beyond; a1, b1 (bn1's affine), alpha (PReLU's slopes), a2, b2
// (bn2's affine), each (C) fp32.  Returns cudaSuccess, the first error of a
// launch or an attribute call, or cudaErrorInvalidValue for what the kernel
// does not take (the header note) or a `stages` outside 1..3.
int fvt_bottleneck_bf16_wgmma_forward(const void* x, const void* w1p,
                                      const void* w2p, const void* a1,
                                      const void* b1, const void* alpha,
                                      const void* a2, const void* b2, void* v,
                                      void* y, int N, int H, int W, int C,
                                      int stages, void* stream) {
  if (stages < 1 || stages > 3) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = block_plan(N, H, W, C, &p);
  if (err != cudaSuccess) return (int)err;
  const int slices = C / kKC;
  const BlockArgs c1{(const __nv_bfloat16*)w1p,
                     (__nv_bfloat16*)v,
                     (const float*)a1,
                     (const float*)b1,
                     (const float*)alpha,
                     H, W, C, p.P, p.Q, slices, p.n_tiles, p.tiles};
  const BlockArgs c2{(const __nv_bfloat16*)w2p,
                     (__nv_bfloat16*)y,
                     (const float*)a2,
                     (const float*)b2,
                     nullptr,
                     H, W, C, p.P, p.Q, slices, p.n_tiles, p.tiles};
  // conv1 stages x and conv2 v by 8-channel chunks; conv2's residual is x by
  // 64 channels under the 128-byte swizzle
  CUtensorMap x_map, v_map, r_map;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((err = make_x_map(x, N, H, W, C, bf16, 2, 8, &x_map)) != cudaSuccess ||
      (err = make_x_map(v, N, H, W, C, bf16, 2, 8, &v_map)) != cudaSuccess ||
      (err = make_x_map(x, N, H, W, C, bf16, 2, 64, &r_map, 1, 0, 0,
                        CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (stages & 1) {
    err = run<kConv1>(c1, p, x_map, r_map, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) err = run<kConv2>(c2, p, v_map, r_map, st);
  return (int)err;
}

}  // extern "C"
