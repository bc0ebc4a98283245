// Eval-mode TemporalBlock, fp32 in and out at fp32 accuracy, for Hopper
// (sm_90a): each causal dilated conv is an implicit GEMM on the warpgroup
// matrix multiply (wgmma) with split-TF32 (3xTF32) products, one launch a
// conv.
//
// Replaces fvt_tpu/ops/tcn_pallas.py::_block_kernel (the Pallas kernel
// behind fused_temporal_block / tcn_forward_pallas):
//
//     h = leaky(conv1(x) + b1)
//     y = leaky(leaky(conv2(h) + b2) + res)
//
// with x (B, T, C), conv1 and conv2 causal dilated convs of K taps (left
// pad (K-1)*d zeros: of x for conv1, of h, not leaky(b1), for conv2), leaky
// slope 0.01 and res = x @ wd + bd (the 1x1 downsample) where C != Co, else
// x.  The CUDA-core kernel of tcn_block.cu computes the same in one launch
// and stays beside it for measurements only.
//
// What bounds it.  At the serving shapes (B = 8 windows of T = 300 frames,
// M = 2400 rows; C up to 768, Co up to 256, K = 5) a block is 2*M*K*(C +
// Co)*Co operations (plus 2*M*C*Co for the downsample) against a few MB of
// activations and weights, so the operations bound it: three TF32 products
// a multiply (below), 3 * 23.78 GFLOP over the 12 blocks of a dispatch,
// 0.144 ms at the TF32 peak (494.7 TFLOP/s).  M is small: a 64-row by
// 64-column tile is one warpgroup's work, and a conv has 40 to 160 of
// them for 132 SMs, so how well the grid fills the card weighs as much as
// the products.
//
// The design, three simple launches on the split-TF32 machinery of
// conv3x3_tf32x3.cu and winograd_tf32x3.cu (read their header notes):
// - conv1 writes h = leaky(conv1(x) + b1) to a workspace (B, T, Co) in
//   device memory (2.4 MB at most at the serving shapes: it stays in the
//   50 MB L2); conv2 reads it back.  So nothing is recomputed over the
//   halo, which the one-launch design had to do for each tile.
// - the downsample, where there is one, is the same kernel with one tap
//   and a bias-only store into a second workspace r; conv2's store reads r
//   (or x) as the residual.
// - a tile is kRows = 64 output frames of one window by kBN = 64 output
//   channels (a Cout below 64 takes one tile, its columns beyond Cout
//   packed as zeros and not stored).  A ring slot stages one slice of 8
//   input channels: two TMA boxes (3-d tiled tensor map over (C, T, B), 4
//   channels x (kRows + pad) rows x 1 window) loaded from frame t0 - pad,
//   laid out [chunk][row][16 bytes].  The copy engine fills frames before
//   0 (and at T or later) with zeros, which is exactly the causal pad of
//   x, and of h for conv2: no test in the kernel.  Rows at T or later are
//   not stored.
// - the K taps are K descriptor offsets into that one patch: tap k starts
//   k*d rows (of 16 bytes) in, and a core matrix is 8 consecutive rows, so
//   no tap needs its own copy (the nine taps of conv3x3_tf32x3.cu in one
//   dimension).  x or h is read once a slice, not K times.
// - a K above 9 (the instantiations) or a halo (K-1)*d that one box of 256
//   rows cannot hold takes the taps in groups of G (tap_groups below, the
//   plan ops/tcn.py::tap_groups makes too): a reduction step is then one
//   (slice, group) pair, whose box starts g*G*d rows later and is
//   kRows + (G-1)*d rows long, G at most 9 and the box at most 256 rows.
//   The last group's taps beyond K are zero weights, packed by the caller;
//   they read real frames, or frames at T or later that the copy engine
//   fills with zeros.  Where one group takes all K taps (every block of
//   the model), G = K and the launch is the one-box kernel it was.
// - the operands are split where they land: x (or h) = hi + lo, hi =
//   tf32(v) in place and lo = tf32(v - hi) beside it, by the consumer
//   warpgroup after the slot's `full` barrier; the weights come split and
//   packed by the caller (once a parameter version), one bulk copy a part.
//   Each tap issues hi*lo, lo*hi, hi*hi; the dropped lo*lo and lo's own
//   rounding are 2^-21 of a product.
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
// - the sums leave straight from the registers as float2, bias, leaky and
//   the residual applied on the way.
//
// Three build switches split the time for tools/profile_tcn.py --diag, and
// give wrong sums, as in conv3x3_tf32x3.cu: -DFVT_DIAG_PRODUCTS_ONLY
// starts no copy and waits for none, -DFVT_DIAG_COPIES_ONLY runs the
// wgmma of a tile's first slice only, -DFVT_DIAG_NO_SPLIT leaves the
// staged input as it landed.

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

// What a launch stores (the header note)
enum Epilogue {
  kLeaky,     // conv1: leaky(acc + bias)
  kBias,      // downsample: acc + bias
  kBlockOut,  // conv2: leaky(leaky(acc + bias) + res)
};

struct ConvArgs {
  const float* x;     // (B, T, C): the conv's input
  const float* w_hi;  // packed: see fvt_tcn_block_tf32x3_forward
  const float* w_lo;
  const float* bias;  // (Co)
  const float* res;   // kBlockOut: the residual (B, T, Co)
  float* y;           // (B, T, Co)
  int B, T, C, Co;
  int taps, dil, pad;  // taps: a group's, G; pad: the causal (K-1)*dil
  int groups;   // tap groups: a tile's steps are slices * groups
  int span;     // rows a box brings past the tile: (G-1)*dil
  int P;        // rows a chunk takes in a slot: kRows + span, up to 8s
  int ring;     // ring slots
  int r_tiles;  // row tiles a window: ceil(T / kRows)
  int n_tiles;  // column tiles: ceil(Co / kBN)
  int tiles;    // B * r_tiles * n_tiles
};

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * 0.01f;
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

// The consumer runs these while a slice's wgmma are in flight, so they hold
// no branch that ptxas could take for a divergent one (it would wait for
// the wgmma there): the spin loop lies inside the asm, the arrive and the
// stores are predicated.  Measured in turns, 9% less device time over the
// 12 serving blocks than mbar_wait, `if (lane == 0)` and a loop over
// tid + 128*k < 2*box (tools/profile_tcn.py's numbers in PERF.md).

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
    // slice s's channels from frame t0 - pad + g*G*dil for group g, and
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
                     t0 - a.pad + g * TAPS * a.dil, b, bar);
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
        if (n >= a.Co) continue;  // Co is a multiple of 8: n + 1 < Co too
        const float2 bias = __ldg(reinterpret_cast<const float2*>(a.bias + n));
        float2 out = make_float2(sum[4 * j + 2 * half] + bias.x,
                                 sum[4 * j + 2 * half + 1] + bias.y);
        if constexpr (kEpi == kLeaky) {
          out = make_float2(leaky(out.x), leaky(out.y));
        } else if constexpr (kEpi == kBlockOut) {
          const float2 r =
              __ldg(reinterpret_cast<const float2*>(a.res + row + n));
          out = make_float2(leaky(leaky(out.x) + r.x),
                            leaky(leaky(out.y) + r.y));
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

// The arguments of a causal conv of x (B, T, C) into y (B, T, Co) with K
// taps at dilation `dil`.
ConvArgs conv_args(const void* x, const void* w_hi, const void* w_lo,
                   const void* bias, const void* res, void* y, int B, int T,
                   int C, int Co, int K, int dil) {
  int G = 0, groups = 0;
  tap_groups(K, dil, &G, &groups);
  const int span = (G - 1) * dil;
  return ConvArgs{(const float*)x, (const float*)w_hi, (const float*)w_lo,
                  (const float*)bias, (const float*)res, (float*)y,
                  B, T, C, Co, G, dil, (K - 1) * dil, groups, span,
                  (kRows + span + 7) / 8 * 8,
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

extern "C" {

// The eval-mode TemporalBlock of x on `stream`, as up to three launches of
// the split-TF32 causal conv (the header note):
//   stage 1, conv1:       h = leaky(conv1(x) + b1)
//   stage 2, downsample:  r = x @ wd + bd (only with a downsample)
//   stage 4, conv2:       y = leaky(leaky(conv2(h) + b2) + res),
//                         res = r with a downsample, else x.
// `stages` 7 runs all; fewer bits run those alone, for measurements.
// x (B, T, C), the workspaces h and r and y (B, T, Co) fp32, contiguous
// and 16-byte aligned; C a multiple of 4 (the caller pads channels with
// zeros), Co a multiple of 8.  Each weight comes as its two TF32 parts, hi
// = tf32(w) and lo = tf32(w - hi), packed for column tiles of 64 output
// channels:
//   wp[tile][slice][tap][chunk][n8][n][k] =
//       w[tap][8*slice + 4*chunk + k][64*tile + 8*n8 + n]
// with tile < ceil(Co / 64), slice < ceil(Cin / 8), chunk < 2, n8 < 8,
// n < 8, k < 4, and 0 where the input channel is beyond Cin or the output
// channel beyond Co: w1 (K, C, Co), w2 (K, Co, Co) and wd (1, C, Co), the
// convs' taps up to G * groups of tap_groups(K, dil) with zero weights
// beyond K (one group of K taps wherever K <= 9 and 64 + (K-1)*dil <=
// 256).  wd_hi, wd_lo, bd and r are null without a downsample, when C ==
// Co.  Returns cudaSuccess, the first error of a launch or an attribute
// call, or cudaErrorInvalidValue for what the kernel does not take:
// another C, Co or stages, a missing downsample where C != Co, or a halo
// (K-1)*dil of 2^30 or more (a TMA coordinate would overflow).
int fvt_tcn_block_tf32x3_forward(const void* x, const void* w1_hi,
                                 const void* w1_lo, const void* b1,
                                 const void* w2_hi, const void* w2_lo,
                                 const void* b2, const void* wd_hi,
                                 const void* wd_lo, const void* bd, void* h,
                                 void* r, void* y, int B, int T, int C,
                                 int Co, int K, int dil, int stages,
                                 void* stream) {
  const bool has_ds = wd_hi != nullptr;
  if (B <= 0 || T <= 0 || C <= 0 || Co <= 0 || K <= 0 || dil <= 0 ||
      C % 4 || Co % 8 || stages < 1 ||
      stages > 7 || (!has_ds && C != Co) ||
      (has_ds && (wd_lo == nullptr || bd == nullptr || r == nullptr)) ||
      (long long)(K - 1) * dil >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const ConvArgs c1 = conv_args(x, w1_hi, w1_lo, b1, nullptr, h, B, T, C,
                                Co, K, dil);
  const ConvArgs ds = conv_args(x, wd_hi, wd_lo, bd, nullptr, r, B, T, C,
                                Co, 1, 1);
  const ConvArgs c2 = conv_args(h, w2_hi, w2_lo, b2, has_ds ? r : x, y, B,
                                T, Co, Co, K, dil);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (stages & 1) err = run_taps<kLeaky>(c1, st);
  if (err == cudaSuccess && has_ds && (stages & 2))
    err = run<kBias, 1>(ds, st);
  if (err == cudaSuccess && (stages & 4)) err = run_taps<kBlockOut>(c2, st);
  return (int)err;
}

}  // extern "C"
