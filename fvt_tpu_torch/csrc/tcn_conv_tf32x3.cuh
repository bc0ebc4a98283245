// The split-TF32 dilated conv of the TCN kernels, for Hopper (sm_90a): one
// launch computes y (B, T, Co) = sum over K taps of x (B, T, C) at a row
// offset times the tap's (C, Co) weights, as an implicit GEMM on the
// warpgroup matrix multiply (wgmma) with three TF32 products a multiply,
// and stores it through one of the epilogues below.  The eval block
// (tcn_block_tf32x3.cu) runs it causally, tap k reading frame
// t - (K-1)*d + k*d; the train block (tcn_block_train_tf32x3.cu) also runs
// it anti-causally on the transposed weights for the input gradients, tap
// k reading frame s + k*d (the taps in reverse order: the transposed conv
// of a causal one).
//
// The design, on the split-TF32 machinery of conv3x3_tf32x3.cu and
// winograd_tf32x3.cu (read their header notes):
// - a tile is kRows = 64 output frames of one window by kBN = 64 output
//   channels (a Co below 64 takes one tile, its columns beyond Co packed
//   as zeros and not stored).  A ring slot stages one slice of 8 input
//   channels: two TMA boxes (3-d tiled tensor map over (C, T, B), 4
//   channels x (kRows + span) rows x 1 window) loaded from frame t0 -
//   lead (lead = (K-1)*d causally, 0 anti-causally), laid out
//   [chunk][row][16 bytes].  The copy engine fills frames before 0 and at
//   T or later with zeros, which is exactly the causal pad of x (and of h
//   for conv2) and the anti-causal conv's zeros beyond the last frame: no
//   test in the kernel.  Rows at T or later are not stored.
// - the K taps are K descriptor offsets into that one patch: tap k starts
//   k*d rows (of 16 bytes) in, and a core matrix is 8 consecutive rows, so
//   no tap needs its own copy (the nine taps of conv3x3_tf32x3.cu in one
//   dimension).  x is read once a slice, not K times.
// - a K above 9 (the instantiations) or a span (K-1)*d that one box of 256
//   rows cannot hold takes the taps in groups of G (tap_groups below, the
//   plan ops/tcn.py::tap_groups makes too): a reduction step is then one
//   (slice, group) pair, whose box starts g*G*d rows later and is
//   kRows + (G-1)*d rows long, G at most 9 and the box at most 256 rows.
//   The last group's taps beyond K are zero weights, packed by the caller;
//   they read real frames, or frames outside [0, T) that the copy engine
//   fills with zeros.  Where one group takes all K taps (every block of
//   the model), G = K and the launch is the one-box kernel.
// - the operands are split where they land: x = hi + lo, hi = tf32(v) in
//   place and lo = tf32(v - hi) beside it, by the consumer warpgroup after
//   the slot's `full` barrier; the weights come split and packed by the
//   caller, one bulk copy a part.  Each tap issues hi*lo, lo*hi, hi*hi;
//   the dropped lo*lo and lo's own rounding are 2^-21 of a product.
// - each slice's 3*K products go to a fresh accumulator that is added to
//   the tile's sum in fp32 after the slice (K reaches 5 * 768 = 3840: one
//   accumulator over all of it loses more than the 1e-4 gate allows).  Two
//   accumulators take the slices in turns, so that the next slice is split
//   and its products issued while the last one's run.
// - a block is one consumer warpgroup and one producer warp (lane 0 waits
//   for a slot's `empty` barrier and starts the slice's copies), and walks
//   the tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the ring is as deep
//   as lets two blocks share an SM (up to kMaxRing slots), so that the
//   copies run ahead of the products.
// - the sums leave straight from the registers as float2 through the
//   epilogue (bias, leaky, masks, the residual).
//
// Three build switches split the time for tools/profile_tcn.py --diag, and
// give wrong sums, as in conv3x3_tf32x3.cu: -DFVT_DIAG_PRODUCTS_ONLY
// starts no copy and waits for none, -DFVT_DIAG_COPIES_ONLY runs the
// wgmma of a tile's first slice only, -DFVT_DIAG_NO_SPLIT leaves the
// staged input as it landed.
#pragma once

#include "wgmma_common.cuh"

namespace {

constexpr int kKC = 8;         // input channels a slice (one k8 step)
constexpr int kRows = 64;      // output frames a tile
constexpr int kBN = 64;        // output channels a tile
constexpr int kMaxBox = 256;   // rows one TMA box may bring
constexpr int kThreads = 160;  // one consumer warpgroup, one producer warp
constexpr int kMaxRing = 8;    // ring slots at most
constexpr int kMaxTaps = 9;    // taps a group may have (instantiations)
// shared memory a block may take where two share an SM
constexpr int kHalfSmem = 113 * 1024;
constexpr float kSlope = 0.01f;  // leaky's slope below 0

// What a launch stores, a = acc + bias
enum Epilogue {
  kLeaky,      // eval conv1:  y = leaky(a)
  kBias,       // eval downsample: y = a
  kBlockOut,   // eval conv2:  y = leaky(leaky(a) + res)
  kPreAct,     // train conv1: y = a (a1), y2 = leaky(a) * mask (h)
  kTrainOut,   // train conv2: y = a (a2), y2 = leaky(leaky(a) * mask + res)
  kMaskGrad,   // train d_a1:  y = acc * mask * leaky'(pre), no bias
  kPlain,      // train dx:    y = acc, no bias
};

struct ConvArgs {
  const float* x;     // (B, T, C): the conv's input
  const float* w_hi;  // packed: see fvt_tcn_block_tf32x3_forward
  const float* w_lo;
  const float* bias;  // (Co); null for kMaskGrad and kPlain
  const float* res;   // kBlockOut, kTrainOut: the residual (B, T, Co)
  float* y;           // (B, T, Co)
  int B, T, C, Co;
  int taps, dil;  // taps: a group's, G
  int lead;     // rows the first box starts before the tile: (K-1)*dil
                // for the causal conv, 0 for the anti-causal one
  int groups;   // tap groups: a tile's steps are slices * groups
  int span;     // rows a box brings past the tile: (G-1)*dil
  int P;        // rows a chunk takes in a slot: kRows + span, up to 8s
  int ring;     // ring slots
  int r_tiles;  // row tiles a window: ceil(T / kRows)
  int n_tiles;  // column tiles: ceil(Co / kBN)
  int tiles;    // B * r_tiles * n_tiles
  const float* mask = nullptr;  // kPreAct, kTrainOut, kMaskGrad (B, T, Co)
  const float* pre = nullptr;   // kMaskGrad: the pre-activation (B, T, Co)
  float* y2 = nullptr;          // kPreAct, kTrainOut: (B, T, Co)
};

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * kSlope;
}

// leaky's derivative, 1 at 0 (the Pallas backward's rule)
__device__ __forceinline__ float dleaky(float v) {
  return v >= 0.f ? 1.f : kSlope;
}

// One part (hi or lo) of a slice: of the input, 2 chunks x P rows x 16
// bytes; of the weights, taps x 8 inputs x kBN outputs.
__host__ __device__ inline int a_part_bytes(int P) { return 2 * P * 16; }

__host__ __device__ constexpr int b_part_bytes(int taps) {
  return taps * kKC * kBN * 4;
}

__host__ __device__ inline int slot_bytes(int P, int taps) {
  return 2 * a_part_bytes(P) + 2 * b_part_bytes(taps);
}

template <Epilogue kEpi, int TAPS>
__global__ void __launch_bounds__(kThreads, 2)
    causal_conv_kernel(ConvArgs a,
                       const __grid_constant__ CUtensorMap x_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int a_bytes = a_part_bytes(a.P);
  constexpr int b_bytes = b_part_bytes(TAPS);
  const int stage_bytes = slot_bytes(a.P, TAPS);
  const int box = kRows + a.span;  // rows a load brings
  const int steps = (2 * box + 127) / 128;  // a thread's float4s of a split
  static_assert(kMaxRing <= 8, "the barriers take the first 128 bytes");
  const uint32_t full = smem_u32(smem), empty = full + 64;
  unsigned char* ring = smem + 128;
  if (tid == 0) {
    for (int i = 0; i < a.ring; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slices = (a.C + kKC - 1) / kKC;  // a tile's slices
  const int tile_steps = slices * a.groups;  // its (slice, group) pairs

  // The role, as a value ptxas knows to be the same across a warp: a
  // branch on tid itself would make it see the consumer's code as
  // divergent and serialise its wgmma around every branch there.
  if (__shfl_sync(0xffffffffu, tid >> 7, 0) == 1) {
    // The producer: lane 0 waits until the slot is empty, sets the bytes
    // to expect and starts the step's copies, all counted on its `full`:
    // slice s's channels from frame t0 - lead + g*G*dil for group g, and
    // the group's packed weights.  A chunk beyond C is not loaded; the
    // consumers zero it.
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    if (lane != 0) return;
    unsigned it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int n_tile = tile % a.n_tiles;
      const int row_tile = tile / a.n_tiles;
      const int b = row_tile / a.r_tiles;
      const int t0 = (row_tile % a.r_tiles) * kRows;
      // the packed weights of a step are contiguous: tile, slice, group
      const size_t w_off = (size_t)n_tile * tile_steps * (b_bytes / 4);
      for (int j = 0, s = 0, g = 0; j < tile_steps; ++j, ++it) {
        const int slot = it % a.ring;
        const int chunks = s * kKC + 4 < a.C ? 2 : 1;
        mbar_wait(empty + 8 * slot, ((it / a.ring) & 1) ^ 1);
        const uint32_t sa = smem_u32(ring + (size_t)slot * stage_bytes);
        const uint32_t bar = full + 8 * slot;
        mbar_expect_tx(bar, 2 * b_bytes + chunks * box * 16);
        const size_t w_step = w_off + (size_t)j * (b_bytes / 4);
        bulk_copy(sa + 2 * a_bytes, a.w_hi + w_step, b_bytes, bar);
        bulk_copy(sa + 2 * a_bytes + b_bytes, a.w_lo + w_step, b_bytes,
                  bar);
        for (int ch = 0; ch < chunks; ++ch)
          tma_tile3d(sa + ch * a.P * 16, &x_map, s * kKC + 4 * ch,
                     t0 - a.lead + g * TAPS * a.dil, b, bar);
        if (++g == a.groups) g = 0, ++s;
      }
    }
    return;
  }

  // The consumer warpgroup holds the tile's sums in registers.  Step j's
  // products go to one of two accumulators by parity: while they run, the
  // warpgroup splits step j + 1 and issues its products into the other,
  // then waits for step j's (ptxas waits for both where the sum reads the
  // first: C7517 in its report) and adds them to the sum.  A step is a
  // slice (one group) or a (slice, group) pair.
  const int warp = tid >> 5;
  float acc0[kBN / 2], acc1[kBN / 2];  // first written by a slice's wgmma
  float sum[kBN / 2];                  // the tile's sum over the slices
  unsigned it = 0;  // slices the block took before the tile
  // the slice and group of the next step issue() takes (steps come in
  // order): counted, not divided out of j, on the path to the products
  int next_s = 0, next_g = 0;

  // Waits for the tile's step j, splits it where it landed and issues its
  // 3*TAPS products into d, one commit group.
  auto issue = [&](int j, float(&d)[kBN / 2]) {
    const unsigned at = it + j;
    const int slot = at % a.ring;
    unsigned char* sa = ring + (size_t)slot * stage_bytes;
#ifndef FVT_DIAG_PRODUCTS_ONLY
    mbar_wait_uniform(full + 8 * slot, (at / a.ring) & 1);  // it landed
#endif
#ifndef FVT_DIAG_NO_SPLIT
    // v = hi + lo over the box's rows of both chunks: hi in place, lo into
    // the slot's second A part; a chunk beyond C becomes zeros.  A thread
    // takes the float4s tid + 128*k, k < steps (the same for all threads)
    const float4* hi = reinterpret_cast<const float4*>(sa);
    const uint32_t hi_u32 = smem_u32(sa), lo_u32 = hi_u32 + 2 * a.P * 16;
    const bool second = next_s * kKC + 4 < a.C;
    const bool wrap = next_g + 1 == a.groups;  // selects, not a branch
    next_g = wrap ? 0 : next_g + 1;
    next_s += wrap;
    for (int k = 0; k < steps; ++k) {
      const int i = tid + 128 * k;
      const bool in = i < 2 * box;
      const int ch = i >= box;
      const int row = in ? ch * a.P + i - ch * box : 0;
      const bool zero = ch && !second;
      const float4 v = zero ? make_float4(0.f, 0.f, 0.f, 0.f) : hi[row];
      const float4 h = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z),
                                   to_tf32(v.w));
      st_shared_if(in, hi_u32 + row * 16, h);
      st_shared_if(in, lo_u32 + row * 16,
                   make_float4(to_tf32(v.x - h.x), to_tf32(v.y - h.y),
                               to_tf32(v.z - h.z), to_tf32(v.w - h.w)));
    }
    // the writes are seen by wgmma's async proxy, and all of the
    // warpgroup's before any of it reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
#endif
    const uint32_t sa_u32 = smem_u32(sa);
    const uint64_t a_hi = make_desc(sa_u32, a.P * 16, 128);
    const uint64_t a_lo = a_hi + (a_bytes >> 4);
    const uint64_t b_hi =
        make_desc(sa_u32 + 2 * a_bytes, (kBN / 8) * 128, 128);
    const uint64_t b_lo = b_hi + (b_bytes >> 4);
    wgmma_fence();
#ifdef FVT_DIAG_COPIES_ONLY
    if (j == 0)
#endif
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      // tap k reads the patch from row k*d on: rows of 16 bytes
      const int shift = tap * a.dil;
      const int b_tap = tap * (kKC * kBN * 4 >> 4);
      // the small products first
      wgmma_tf32<kBN>(d, a_hi + shift, b_lo + b_tap, tap > 0);
      wgmma_tf32<kBN>(d, a_lo + shift, b_hi + b_tap, 1);
      wgmma_tf32<kBN>(d, a_hi + shift, b_hi + b_tap, 1);
    }
    wgmma_commit();
  };
  // The tile's step j has its products: its slot goes back to the
  // producer (this warp has read it) and they join the sum.
  auto retire = [&](int j, const float(&d)[kBN / 2]) {
    mbar_arrive_if(lane == 0, empty + 8 * ((it + j) % a.ring));
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      sum[i] = j == 0 ? d[i] : __fadd_rn(sum[i], d[i]);
  };

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int n0 = (tile % a.n_tiles) * kBN;
    const int row_tile = tile / a.n_tiles;
    const int b = row_tile / a.r_tiles;
    const int t0 = (row_tile % a.r_tiles) * kRows;
    next_s = next_g = 0;
    issue(0, acc0);
    for (int j = 0; j < tile_steps; j += 2) {
      if (j + 1 < tile_steps) {
        issue(j + 1, acc1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      retire(j, acc0);
      if (j + 1 == tile_steps) break;
      if (j + 2 < tile_steps) {
        issue(j + 2, acc0);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      retire(j + 1, acc1);
    }
    it += tile_steps;

    // Thread (warp, lane) holds rows 16*warp + lane/4 (+ 8) and columns
    // 8*j + 2*(lane % 4) (+ 1) of the tile in sum[4*j + 2*half (+ 1)]: one
    // float2 a row and j, four lanes a 32-byte sector.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + warp * 16 + (lane >> 2) + 8 * half;
      if (t >= a.T) continue;
      const size_t row = ((size_t)b * a.T + t) * a.Co;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (n >= a.Co) continue;  // Co is even: n + 1 < Co too
        float2 out = make_float2(sum[4 * j + 2 * half],
                                 sum[4 * j + 2 * half + 1]);
        if constexpr (kEpi != kMaskGrad && kEpi != kPlain) {
          const float2 bias =
              __ldg(reinterpret_cast<const float2*>(a.bias + n));
          out = make_float2(out.x + bias.x, out.y + bias.y);
        }
        if constexpr (kEpi == kLeaky) {
          out = make_float2(leaky(out.x), leaky(out.y));
        } else if constexpr (kEpi == kBlockOut) {
          const float2 r =
              __ldg(reinterpret_cast<const float2*>(a.res + row + n));
          out = make_float2(leaky(leaky(out.x) + r.x),
                            leaky(leaky(out.y) + r.y));
        } else if constexpr (kEpi == kPreAct) {
          const float2 m =
              __ldg(reinterpret_cast<const float2*>(a.mask + row + n));
          *reinterpret_cast<float2*>(a.y2 + row + n) =
              make_float2(leaky(out.x) * m.x, leaky(out.y) * m.y);
        } else if constexpr (kEpi == kTrainOut) {
          const float2 m =
              __ldg(reinterpret_cast<const float2*>(a.mask + row + n));
          const float2 r =
              __ldg(reinterpret_cast<const float2*>(a.res + row + n));
          *reinterpret_cast<float2*>(a.y2 + row + n) =
              make_float2(leaky(leaky(out.x) * m.x + r.x),
                          leaky(leaky(out.y) * m.y + r.y));
        } else if constexpr (kEpi == kMaskGrad) {
          const float2 m =
              __ldg(reinterpret_cast<const float2*>(a.mask + row + n));
          const float2 z =
              __ldg(reinterpret_cast<const float2*>(a.pre + row + n));
          out = make_float2(out.x * m.x * dleaky(z.x),
                            out.y * m.y * dleaky(z.y));
        }
        *reinterpret_cast<float2*>(a.y + row + n) = out;
      }
    }
  }
}

// The taps of a conv in groups (the header note): G at most kMaxTaps and
// kRows + (G-1)*dil at most kMaxBox, as few groups as that allows, as even
// as they can be.  ops/tcn.py::tap_groups is the same plan.
void tap_groups(int K, int dil, int* G, int* groups) {
  int g_max = 1 + (kMaxBox - kRows) / dil;
  if (g_max > kMaxTaps) g_max = kMaxTaps;
  *groups = (K + g_max - 1) / g_max;
  *G = (K + *groups - 1) / *groups;
}

// The arguments of a conv of x (B, T, C) into y (B, T, Co) with K taps at
// dilation `dil`: causal (tap k reads frame t - (K-1)*dil + k*dil) or
// anti-causal (tap k reads frame t + k*dil).
ConvArgs conv_args(const void* x, const void* w_hi, const void* w_lo,
                   const void* bias, const void* res, void* y, int B, int T,
                   int C, int Co, int K, int dil, bool causal = true) {
  int G = 0, groups = 0;
  tap_groups(K, dil, &G, &groups);
  const int span = (G - 1) * dil;
  return ConvArgs{(const float*)x, (const float*)w_hi, (const float*)w_lo,
                  (const float*)bias, (const float*)res, (float*)y,
                  B, T, C, Co, G, dil, causal ? (K - 1) * dil : 0, groups,
                  span, (kRows + span + 7) / 8 * 8,
                  0, (T + kRows - 1) / kRows, 0, 0};
}

// One launch of the conv of TAPS taps with its epilogue.
template <Epilogue kEpi, int TAPS>
cudaError_t run(ConvArgs a, cudaStream_t stream) {
  a.n_tiles = (a.Co + kBN - 1) / kBN;
  const long long tiles = (long long)a.B * a.r_tiles * a.n_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  // the deepest ring that lets two blocks share an SM, else the deepest
  // that fits one; two slots at least, for the two slices in flight
  const int slot = slot_bytes(a.P, a.taps);
  a.ring = (kHalfSmem - 128) / slot;
  if (a.ring < 2) a.ring = (kMaxSmem - 128) / slot;
  if (a.ring > kMaxRing) a.ring = kMaxRing;
  if (a.ring < 2) return cudaErrorInvalidValue;
  const size_t bytes = 128 + (size_t)a.ring * slot;
  CUtensorMap x_map;
  cudaError_t err =
      make_tile3d_map(a.x, a.B, a.T, a.C, kRows + a.span, &x_map);
  if (err != cudaSuccess) return err;
  // host time that a launch of a small conv would wait on: the attribute
  // call once a device (to the most any launch takes), and the places on
  // the card from the ring's size, two blocks an SM where each takes at
  // most kHalfSmem (__launch_bounds__ leaves two the registers), in place
  // of an occupancy query
  static int set_device = -1, sms = 0;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device != set_device) {
    err = cudaFuncSetAttribute(causal_conv_kernel<kEpi, TAPS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    set_device = device;
  }
  const long long places = (long long)sms * (bytes <= kHalfSmem ? 2 : 1);
  const unsigned blocks = (unsigned)(tiles < places ? tiles : places);
  causal_conv_kernel<kEpi, TAPS>
      <<<blocks, kThreads, bytes, stream>>>(a, x_map);
  return cudaGetLastError();
}

// run<kEpi, a.taps>: a group's taps are a compile-time count, so that the
// wgmma of a step form one unrolled chain (a loop over a runtime count
// makes ptxas fence between them).
template <Epilogue kEpi, int TAPS = 1>
cudaError_t run_taps(const ConvArgs& a, cudaStream_t stream) {
  if (a.taps == TAPS) return run<kEpi, TAPS>(a, stream);
  if constexpr (TAPS < kMaxTaps) return run_taps<kEpi, TAPS + 1>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
