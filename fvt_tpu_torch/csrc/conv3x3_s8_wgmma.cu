// The s8 3x3 convolution of int8 serving (--serve_quant int8 |
// int8_static) on Hopper's warpgroup matrix multiply (sm_90a): y (N, Ho,
// Wo, Co) = conv3x3(xq, w) * (x_scale * w_scale[co]), padding 1, stride 1
// or 2, xq (N, H, W, C) s8 NHWC, the int32 sums on 8-bit wgmma
// (m64n128k32.s32.s8.s8), y float32 or bfloat16.
//
// It replaces no Pallas kernel: fvt_tpu computes its int8 conv
// (fvt_tpu/ops/quant.py:75-108, conv3x3_int8) as one XLA convolution with
// s8 operands and an int32 accumulator.  conv3x3_int8.cu holds the
// activations' quantise pass and the earlier mma.sync design of this conv
// (timed, on no path).  The contract is that design's and the plain
// version's (fvt_tpu_torch/ops/quant.py conv3x3_s8_ref), bit for bit: the
// int32 sums are exact in any order (below 9*512*127^2 ~ 7.4e7 < 2^31, so
// wgmma's s32 accumulator neither wraps nor needs saturation), the
// accumulator goes to float32 once (__int2float_rn), times (x_scale *
// w_scale[co]), that product formed first, both with __fmul_rn; bfloat16
// is rounded to nearest even.  x_scale is read from device memory in the
// epilogue (the dynamic path's quantise launch writes it), so no pass over
// y is added.
//
// What bounds it.  2*M*Co*9*C int8 operations against (M*9*C read once as
// N*H*W*C, y written once): at the IR-50's shapes (N = 2400) the tensor
// cores, 0.143 ms for the 0.283 T operations of a Cin = Cout conv at the
// 1979 TOPS dense peak, 6.15 ms over the 41 convs of a forward.  8-bit
// wgmma reads both operands from shared memory, K-major only: an
// m64n128k32 is 64 cycles of one SM's tensor cores and reads 2 KB of A and
// 4 KB of B, 96 bytes a cycle of the 128 shared memory serves, before the
// copy engine's writes (conv3x3_wgmma.cu's ratio in bf16).
//
// The operands.  A k32 step is 32 one-byte channels.  The copy engine
// stages x through an im2col tensor map of 32 channels by kLoad = 128
// coordinates a load, as [coordinate][32 bytes] under its 32-byte swizzle
// (the two 16-byte halves of a row swapped where bit 7 of its address is
// set), which is wgmma's 32-byte-swizzled K-major layout: one row of 32
// bytes a coordinate, so one load brings a slice (16-byte rows, as the bf16
// kernel's [chunk][coordinate] layout would take, need two loads a slice,
// and the copy engine's im2col rate is rows, not bytes: about half a row a
// cycle an SM, PERF.md).  The swizzle is a function of the absolute
// address, so a descriptor whose start is any number of rows further reads
// the shifted rows right (base offset 0; wgmma_common.cuh make_desc_sw32).
// Channels past C (C an odd multiple of 16) are the copy engine's zero
// fill, and their weights are zero.  The weights are packed once per
// weight by the caller (ops/quant.py pack_weights_s8): per (column tile of
// kBN = 128 output channels, 32-channel slice, tap, 16-byte chunk) the kBN
// K-major rows of 16 bytes wgmma reads as B (no swizzle), zeros past C and
// Co; a ring slot takes a slice's taps in one bulk copy.
//
// Two routes, chosen by s8_plan (mirrored in ops/quant.py s8_plan):
// - the padded line (stride 1, 38 of the 41 convs): conv3x3_wgmma.cu's.
//   Frames lie on one line of Q = N*(H+1)*(W+1) coordinates, pixel (f, i,
//   j) at f*(H+1)*(W+1) + (i+1)*(W+1) + j+1, the rest zeros (the walk of
//   an im2col map from (-1, -1) to (W-1, H-1), the copy engine's zero fill
//   the pad).  A tile is kBM = 256 consecutive coordinates; per slice it
//   stages the P = kBM + 2*(W+1) + 2 (rounded up to kLoad) coordinates it
//   reads ONCE, and tap (dy, dx) is the same patch (dy*(W+1) + dx)*32 bytes
//   further: nine descriptor offsets, x read from L2 once a column tile.
//   The sums at pad coordinates are computed and dropped by the store:
//   (H+1)(W+1)/(HW) of the products, 1.10x at 20x20, 1.21x at 10x10 and
//   1.44x at 5x5.  A ring slot is one slice: its staged patch (12 KB at
//   the IR-50's widths) and the nine taps' weights (36 KB).
// - the per-tap walk (stride 2, and stride 1 where the padded line's
//   staging would not fit: W above 510): the walk of an im2col map of
//   traversal stride `stride` from (-1, -1) with upper corners -1, whose
//   positions are exactly the Ho x Wo output pixels' filter origins, frame
//   after frame; tap (dy, dx) is the same walk read (dx, dy) further (the
//   load's im2col offsets).  A tile is kBM consecutive output pixels; a
//   ring slot is a slice's taps of one row dy: three taps' kBM rows (24 KB,
//   nine loads a row block and slice in all) and their weights (12 KB).
//   No pad rows, x read nine times from L2.  Running stride 2 on the
//   padded line and dropping three quarters of it would add ~3 T
//   operations over a forward.
//
// The grid and the pipeline are conv3x3_wgmma.cu's: a persistent grid
// (one block an SM: 4 consumer warpgroups of 64 rows each and a producer
// warp), walking (row tile, column tile) pairs with the column tile inner
// so that neighbours in time share x in L2; a ring of `full` / `empty`
// mbarriers that the producer runs ahead on across tile borders.  A load
// of the padded line that would start past the last frame is left out and
// its coordinates zeroed (the pad row below the last frame lies there); a
// walk's load that starts past the last pixel is left out (its rows feed
// only their own dropped sums).  The epilogue stages each warp's 16 rows
// (scaled and rounded) and writes y 16 bytes a thread.  bfloat16: the rows
// stay staged and are written while the next tile's first ring step is
// multiplied, between its wgmma and the wait (predicated stores, no branch
// for ptxas to wait at), so that the stores do not run while no product
// does (they took a quarter of the kernel's time there); float32 (two
// halves of 64 channels, the staging holds one) is written at once.
//
// A pixel's index is an int where N*(H+1)*(W+1) < 2^31 and 64-bit
// beyond, chosen at launch: 64-bit indices throughout spilled registers
// and cost 4% (PERF.md).
//
// What is left (PERF.md §6): without its copies the kernel takes
// ~90% of its time, and its products run at ~70% of the tensor peak, pad
// rows counted; the rest is the copies' share of shared memory's
// bandwidth, the staging of y, and the last wave's idle SMs.  The walk is
// bound by the copy engine's im2col rows (nine loads a slice).  Tried and
// measured slower: a ring step's wgmma kept in flight across steps, the
// padded line on unswizzled 16-byte rows.
//
// Two build switches split the time for tools/profile_conv_bf16.py
// (--dtype s8), and give wrong sums: -DFVT_DIAG_PRODUCTS_ONLY starts no
// copy and waits for none, -DFVT_DIAG_COPIES_ONLY runs the wgmma of a
// tile's first ring step only.

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kBN = 128;  // output channels a tile
constexpr int kWG = 4;    // consumer warpgroups: 64 rows of the tile each
constexpr int kThreads = 128 * kWG + 32;
constexpr int kKC = 32;                    // input channels a slice (k32)
constexpr int kTapBytes = kKC * kBN;       // a tap's weights of a slice
// a staged output row: 256 bytes of y, then its pixel's index
constexpr int kPitch = 2 * kBN + 16;
constexpr int kOutBytes = kWG * 4 * 16 * kPitch;  // every warp's 16 rows

struct S8Args {
  const int8_t* wp;  // packed: see fvt_conv3x3_s8_forward
  const float* wscale;
  const float* xscale;
  void* y;
  int H, W, Co, Ho, Wo;
  int stride;
  int P;        // staged coordinates a tile (and tap, walk)
  long long Q;  // padded line: N*(H+1)*(W+1); walk: M = N*Ho*Wo
  int slices;   // ceil(C / 32)
  int n_tiles;  // column tiles
  int tiles;    // row tiles times column tiles
};

// a ring slot's bytes: the staged A (padded line: one patch; walk: three
// taps), 32 bytes a coordinate, then the weights of its taps
__host__ __device__ constexpr int slot_bytes(bool walk, int P) {
  return (walk ? 3 : 1) * P * 32 + (walk ? 3 : 9) * kTapBytes;
}

// the barriers, up to 1023 bytes to align the ring, the ring, the staged
// output rows
constexpr size_t smem_bytes(bool walk, int P, int S) {
  return 128 + 1024 + (size_t)S * slot_bytes(walk, P) + kOutBytes;
}

// 16 bytes to global memory where p holds, as one predicated store
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

// Pix: the type of a pixel's index and of a place in a frame, int where
// N*(H+1)*(W+1) < 2^31 (64-bit indices spill registers), long long beyond
template <bool kWalk, int S, typename OutT, typename Pix>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_s8_wgmma_kernel(S8Args a,
                            const __grid_constant__ CUtensorMap x_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  static_assert(S <= 8, "the barriers take the first 128 bytes");
  constexpr int kSteps = kWalk ? 3 : 1;  // ring steps a slice
  constexpr int kTaps = kWalk ? 3 : 9;   // taps a step
  const int tid = threadIdx.x, lane = tid & 31;
  const int P = a.P, W1 = a.W + 1;
  const int a_bytes = (kWalk ? 3 : 1) * P * 32;
  const int stage = slot_bytes(kWalk, P);
  const uint32_t full = smem_u32(smem), empty = full + 64;
  // the ring starts 1024-aligned (the copy engine's swizzled boxes)
  unsigned char* ring = smem + (((full + 128 + 1023) & ~1023u) - full);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long frame = (long long)(a.H + 1) * W1;
  const Pix hw = (Pix)a.Ho * a.Wo;

  if (tid >= 128 * kWG) {
    // The producer.  Padded line: lane l loads coordinates r0 + l*kLoad +
    // [0, kLoad) of the slice.  Walk: lane 2dx + l loads pixels r0 + l*kLoad
    // + [0, kLoad) of tap (dy, dx), dy the step's row.  Lane 0 sets the
    // bytes to expect and copies the step's weights; all are counted on the
    // slot's `full`.
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    const int loads = P / kLoad;
    const int l = kWalk ? lane & 1 : lane;
    const int dx = kWalk ? lane >> 1 : 0;
    unsigned it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const long long r0 = (long long)(tile / a.n_tiles) * kBM;
      const int n_tile = tile % a.n_tiles;
      int valid = 0;  // loads of a slice (and tap) that start inside
      while (valid < loads && r0 + (long long)valid * kLoad < a.Q) ++valid;
      const bool mine = (kWalk ? lane < 6 : true) && l < valid;
      int lw = 0, lh = 0, ln = 0;  // where this lane's load starts
      if (mine) {
        const long long q = r0 + (long long)l * kLoad;
        if (kWalk) {
          ln = (int)(q / hw);
          const Pix r = (Pix)(q - (long long)ln * hw);
          lh = (int)(r / a.Wo) * a.stride - 1;
          lw = (int)(r % a.Wo) * a.stride - 1;
        } else {
          const long long f = q / frame;
          const Pix rem = (Pix)(q - f * frame);
          ln = (int)f, lh = (int)(rem / W1) - 1, lw = (int)(rem % W1) - 1;
        }
      }
      for (int s = 0; s < a.slices; ++s) {
        for (int g = 0; g < kSteps; ++g, ++it) {
          const int slot = it % S;
          mbar_wait(empty + 8 * slot, ((it / S) & 1) ^ 1);
          unsigned char* sa = ring + (size_t)slot * stage;
          const uint32_t sa_u32 = smem_u32(sa), bar = full + 8 * slot;
          if (!kWalk && valid < loads) {
            for (int i = lane; i < 2 * (P - valid * kLoad); i += 32)
              *reinterpret_cast<uint4*>(sa + valid * kLoad * 32 + i * 16) =
                  make_uint4(0, 0, 0, 0);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
          }
          if (lane == 0) {
            mbar_expect_tx(bar, kTaps * kTapBytes +
                                    (kWalk ? 3 : 1) * valid * kLoad * 32);
            bulk_copy(sa_u32 + a_bytes,
                      a.wp + (((size_t)n_tile * a.slices + s) * 9 + 3 * g) *
                                 kTapBytes,
                      kTaps * kTapBytes, bar);
          }
          if (mine)
            tma_im2col(sa_u32 + (dx * P + l * kLoad) * 32, &x_map, s * kKC,
                       lw, lh, ln, bar, dx, g);
        }
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg holds the tile's rows 64*wg + [0, 64).
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  unsigned char* out =
      ring + (size_t)S * stage + (size_t)(wg * 4 + warp) * 16 * kPitch;
  const float xs = *a.xscale;
  const int steps = a.slices * kSteps;
  // bfloat16: a tile's rows stay staged and are written to y while the next
  // tile's first ring step is multiplied
  constexpr bool kDefer = sizeof(OutT) == 2;
  int pend_n0 = 0;  // the staged rows' first column
  int acc[kBN / 2];  // first written by a tile's first wgmma
  unsigned it = 0;
  // ring step k of a tile: wait for it, start its wgmma; returns the slot
  auto issue = [&](int k) {
    const int slot = it % S;
#ifndef FVT_DIAG_PRODUCTS_ONLY
    mbar_wait(full + 8 * slot, (it / S) & 1);  // the step has landed
#endif
    const uint32_t sa_u32 = smem_u32(ring + (size_t)slot * stage);
    const uint32_t a_u32 = sa_u32 + wg * 64 * 32;
    const uint64_t desc_b = make_desc(sa_u32 + a_bytes, kBN * 16, 128);
    wgmma_fence();
#ifdef FVT_DIAG_COPIES_ONLY
    if (k == 0)
#endif
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      // the padded line's tap rows start (dy*W1 + dx) coordinates
      // further, the walk's taps lie one after the other
      const int a_off = kWalk ? t * P : (t / 3) * W1 + t % 3;
      wgmma_s8_m64n128k32(acc, make_desc_sw32(a_u32 + a_off * 32),
                          desc_b + t * (kTapBytes >> 4), k > 0 || t > 0);
    }
    wgmma_commit();
    return slot;
  };
  // the step's wgmma done: its slot is free
  auto retire = [&](int slot) {
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp has read it
    ++it;
  };
  // each staged row's pixel, -1 for none (a pad coordinate, past the last
  // pixel, or nothing staged yet)
  auto row_pix = [&](int r) {
    return *reinterpret_cast<const Pix*>(out + r * kPitch + 2 * kBN);
  };
  if (lane < 16) *reinterpret_cast<Pix*>(out + lane * kPitch + 2 * kBN) = -1;
  __syncwarp();
  // the staged rows to y, 16 bytes a lane and store, without a branch (a
  // wgmma is in flight: ptxas would wait for it at one)
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = (lane >> 4) + 2 * k, piece = lane & 15;
      const Pix v = row_pix(r);
      const int col = pend_n0 + piece * 8;
      const uint4 d =
          *reinterpret_cast<const uint4*>(out + r * kPitch + piece * 16);
      st_global_if(v >= 0 && col < a.Co,
                   static_cast<OutT*>(a.y) + (size_t)(v < 0 ? 0 : v) * a.Co +
                       col,
                   d);
    }
  };
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long r0 = (long long)(tile / a.n_tiles) * kBM;
    const int n0 = (tile % a.n_tiles) * kBN;
    const int slot0 = issue(0);
    if constexpr (kDefer) flush();  // the tile before's rows
    retire(slot0);
    for (int k = 1; k < steps; ++k) retire(issue(k));

    // The sums leave through the warp's 16 staged rows, so that y is written
    // in whole 16-byte pieces.  Thread (warp, lane) holds rows 16*warp +
    // lane/4 (+ 8) and columns 8*j + 2*(lane % 4) (+ 1) in acc[4*j + 2*half
    // (+ 1)].  A staged row is 256 bytes: kBN bfloat16 values, or half of
    // the float32 ones (two passes).
    // the pixel of row 16*warp + lane (lanes 0..15), -1 for none
    Pix pix = -1;
    {
      const int row = wg * 64 + warp * 16 + (lane & 15);
      if (kWalk) {
        if (r0 + row < a.Q) pix = (Pix)(r0 + row);
      } else {
        const long long q = r0 + W1 + 1 + row;
        if (q < a.Q) {
          const long long f = q / frame;
          const Pix rem = (Pix)(q - f * frame);
          const Pix rr = rem / W1, cc = rem - rr * W1;
          if (rr > 0 && cc > 0)
            pix = (Pix)((f * a.H + rr - 1) * a.W + cc - 1);
        }
      }
    }
    constexpr int kPasses = sizeof(OutT) / 2;
    constexpr int kJ = kBN / 8 / kPasses;  // 8-column groups a pass
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      __syncwarp();  // the rows staged before have been read
      if (pass == 0 && lane < 16)
        *reinterpret_cast<Pix*>(out + lane * kPitch + 2 * kBN) = pix;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = pass * kJ + jj;
        const int n = n0 + 8 * j + 2 * (lane & 3);
        float2 sc = make_float2(0.f, 0.f);
        if (n < a.Co)  // Co % 8 == 0: n + 1 too
          sc = make_float2(__fmul_rn(xs, __ldg(a.wscale + n)),
                           __fmul_rn(xs, __ldg(a.wscale + n + 1)));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned char* row = out + ((lane >> 2) + 8 * half) * kPitch;
          const float v0 =
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), sc.x);
          const float v1 =
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), sc.y);
          if constexpr (sizeof(OutT) == 4)
            *reinterpret_cast<float2*>(row + jj * 32 + (lane & 3) * 8) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(row + jj * 16 +
                                               (lane & 3) * 4) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
      if constexpr (kDefer) {
        pend_n0 = n0;
      } else {
        constexpr int kPer = 16 / sizeof(OutT);  // values a 16-byte piece
#pragma unroll
        for (int i = lane; i < 16 * 16; i += 32) {
          const int r = i / 16, piece = i % 16;
          const Pix v = row_pix(r);
          const int col = n0 + pass * (kBN / kPasses) + piece * kPer;
          if (v >= 0 && col < a.Co)
            *reinterpret_cast<uint4*>(static_cast<OutT*>(a.y) +
                                      (size_t)v * a.Co + col) =
                *reinterpret_cast<const uint4*>(out + r * kPitch +
                                                piece * 16);
        }
      }
    }
  }
  if constexpr (kDefer) flush();  // the last tile's rows
}

// The route and ring of a conv: the per-tap walk for stride 2, and for
// stride 1 where the padded line's staging leaves no ring of two slots or
// outnumbers the producer's lanes; the padded line's ring of 3 slots, or
// 2 where 3 do not fit, the walk's of 4.  Mirrored by ops/quant.py
// s8_plan.
struct Plan {
  bool walk;
  int P, slots;
};

Plan s8_plan(int W, int stride) {
  if (stride == 1) {
    const int P = (kBM + 2 * (W + 1) + 2 + kLoad - 1) / kLoad * kLoad;
    if (P / kLoad <= 32) {  // a producer lane a load
      if (smem_bytes(false, P, 3) <= (size_t)kMaxSmem) return {false, P, 3};
      if (smem_bytes(false, P, 2) <= (size_t)kMaxSmem) return {false, P, 2};
    }
  }
  return {true, kBM, 4};
}
static_assert(smem_bytes(true, kBM, 4) <= (size_t)kMaxSmem,
              "the walk's ring of four slots fits");

template <bool kWalk, int S, typename OutT, typename Pix>
cudaError_t launch(const S8Args& a, const CUtensorMap& x_map,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(kWalk, a.P, S);
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_blocks(conv3x3_s8_wgmma_kernel<kWalk, S, OutT, Pix>,
                        kThreads, bytes, a.tiles, &blocks);
  if (err != cudaSuccess) return err;
  conv3x3_s8_wgmma_kernel<kWalk, S, OutT, Pix>
      <<<blocks, kThreads, bytes, stream>>>(a, x_map);
  return cudaGetLastError();
}

template <typename OutT, typename Pix>
cudaError_t run(const S8Args& a, const Plan& p, const CUtensorMap& x_map,
                cudaStream_t stream) {
  if (p.walk) return launch<true, 4, OutT, Pix>(a, x_map, stream);
  return p.slots == 3 ? launch<false, 3, OutT, Pix>(a, x_map, stream)
                      : launch<false, 2, OutT, Pix>(a, x_map, stream);
}

template <typename OutT>
cudaError_t run(const S8Args& a, const Plan& p, const CUtensorMap& x_map,
                bool wide, cudaStream_t stream) {
  return wide ? run<OutT, long long>(a, p, x_map, stream)
              : run<OutT, int>(a, p, x_map, stream);
}

}  // namespace

extern "C" {

// y = conv3x3(xq, w) * (xscale * wscale[co]) on `stream`: xq (N, H, W, C)
// s8, wscale (Co,) float32, xscale one float32 of device memory, y (N, Ho,
// Wo, Co) float32 (bf16_out = 0) or bfloat16, Ho = (H - 1) / stride + 1
// (padding 1); contiguous and 16-byte aligned.  C a multiple of 16, Co of
// 8, stride 1 or 2.  wp holds the s8 weights w (Co, 9, C) (tap = 3*ky +
// kx) packed for column tiles of 128 output channels and 32-channel
// slices, contiguous:
//   wp[tile][slice][tap][chunk][n][k] = w[128*tile + n][tap][32*slice +
//                                        16*chunk + k]
// with tile < ceil(Co / 128), slice < ceil(C / 32), chunk < 2, n < 128, k
// < 16, and 0 where the channel is beyond C or the output channel beyond
// Co: per (tile, slice) the 9 x 4096 bytes of K-major rows wgmma reads.
// One launch.  Returns cudaSuccess, the error of an attribute call or the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take
// (another C, Co or stride, or more than 2^31 - 1 tiles of 256 x 128
// outputs, as the mma.sync design refuses more than 2^31 - 1 blocks of 128
// x 128).
int fvt_conv3x3_s8_forward(const void* xq, const void* wp, const void* wscale,
                           const void* xscale, void* y, int bf16_out, int N,
                           int H, int W, int C, int Co, int stride,
                           void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 || Co % 8 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const long long M = (long long)N * Ho * Wo;
  const Plan p = s8_plan(W, stride);
  const long long Q = p.walk ? M : (long long)N * (H + 1) * (W + 1);
  // the padded line's sums start at the first pixel, W + 2 in
  const long long rows = p.walk ? M : Q - (W + 2);
  const int n_tiles = (Co + kBN - 1) / kBN;
  const long long tiles = (rows + kBM - 1) / kBM * n_tiles;
  // past 2^31 - 1 tiles y would take ~100 TB
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const S8Args a{(const int8_t*)wp, (const float*)wscale,
                 (const float*)xscale, y, H, W, Co, Ho, Wo, stride, p.P, Q,
                 (C + kKC - 1) / kKC, n_tiles, (int)tiles};
  // the padded line: stride 1 from (-1, -1) to (W-1, H-1); the walk: from
  // (-1, -1) to the last output pixel's filter origin
  CUtensorMap x_map;
  const int upper = p.walk ? -1 : 0;
  const cudaError_t err =
      make_x_map(xq, N, H, W, C, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kKC,
                 &x_map, p.walk ? stride : 1, upper, upper,
                 CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = (long long)N * (H + 1) * (W + 1) > 2147483647LL;
  return (int)(bf16_out ? run<__nv_bfloat16>(a, p, x_map, wide, st)
                        : run<float>(a, p, x_map, wide, st));
}

}  // extern "C"
