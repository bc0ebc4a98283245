// Fused eval-mode LFAN multimodal fusion block, fp32 in and out at fp32
// accuracy, in one launch for Hopper (sm_90a): the qkv projections and
// o_proj as split-TF32 (3xTF32) products on the warpgroup matrix multiply
// (wgmma), the attention over the modality slots in registers, the
// LayerNorm on o's accumulators.
//
// Replaces fvt_tpu/ops/fusion_pallas.py::_fusion_kernel (the Pallas kernel
// behind fused_multimodal_fusion).  Per frame, over M = 1..7 modalities:
//
//   qkv_m = x_m @ Wqkv_m + b_m                 packed head-major, [q|k|v]
//                                              inside each head
//   for each head and modality slot m1:
//     p = softmax_m2(q_m1 . k_m2 / sqrt(hd));  v' = sum_m2 p v_m2 + v_m1
//   cat = v' ordered head-major, then modality
//   y = LayerNorm(cat @ Wo + bo), eps 1e-5, no residual
//
// The CUDA-core kernel of fusion.cu computes the same and stays beside it
// for measurements only.
//
// What bounds it.  At the main path's shapes (N = B*T = 2400 frames; C =
// 128, 32, 128; E = 32, H = 2) a frame takes 27,648 qkv and 9,216 o_proj
// multiply-adds against ~1.6 KB of x and y, so the products bound it: three
// TF32 products a multiply, 3 x 0.177 GFLOP, ~1.1 us at the TF32 peak, and
// the bytes (~3.8 MB at 3.35 TB/s) about as much.  The frames are the rows
// of every product and are independent (the attention runs over the M
// slots, not over time): a tile is 64 frames, the one warpgroup's wgmma
// height, and needs no halo.  2400 frames make 38 tiles for 132 SMs, so a
// call lasts about one tile's chain of products: the design keeps that
// chain on the tensor cores and everything between the products in
// registers or shared memory.
//
// The design, on the split-TF32 machinery of tcn_conv_tf32x3.cuh (read its
// header note):
// - a block is one consumer warpgroup and one producer warp and walks the
//   tiles blockIdx.x, blockIdx.x + gridDim.x, ...  Every operand streams
//   through one ring of slots in the order the consumers take them; the
//   producer's lane 0 starts a slot's copies once the consumers gave it
//   back (a `full` and an `empty` mbarrier a slot).  No layout depends on
//   M: a step brings 32 input channels, as many slots as shared memory
//   holds beside cat.
// - qkv, one head at a time: the weights come split (hi and lo) and packed
//   by the caller as WqkvT per (head, slice of 16 head dims), 48 columns
//   [q | k | v] of 16 each, zero weights where a dim is beyond hd.  A step
//   is 32 channels of one modality: x_m's 64 rows x 32 channels (eight TMA
//   boxes of 4 channels of a tiled map over (C_m, N), rows at N or later
//   zeros; a chunk beyond C_m not loaded and zeroed by the consumers) and
//   the step's weight parts (one bulk copy each).  The consumers split x
//   where it landed (hi = tf32(v) in place, lo = tf32(v - hi) beside it)
//   and issue hi*lo, lo*hi, hi*hi for each of the four k8 slices into the
//   modality's own accumulator (64 x 48 fp32, 24 registers a thread; 168
//   at M = 7): 12 wgmma a step.  The dropped lo*lo and
//   lo's own rounding are 2^-21 of a product.
// - attention in registers: the M accumulators of a head hold q, k and v of
//   every modality at the same (row, column) positions, so q_m1 . k_m2 is a
//   partial dot over a thread's columns and two quad shuffles; softmax and
//   sum_m2 p v_m2 + v_m1 are thread-local.  cat is written split into
//   shared memory, in the layout in which wgmma reads A.  A head of more
//   than 16 dims takes its slices in two passes: the first adds the
//   partial logits into shared memory, the second (the products again)
//   reads p there.
// - o = cat @ WoT in column chunks of 32 (WoT split and packed by the
//   caller): a step brings 32 rows of a chunk's weights; cat is the A
//   operand where it lies.  The chunks' accumulators stay in registers
//   (E*M <= 256: 128 at most); a row lies in one quad, so the LayerNorm
//   runs on them with two quad shuffles a sum, and y is stored once.  qkv,
//   cat and o never reach device memory.
// - E*M above 256 (E above 36 at seven modalities; never an LFAN of E =
//   32) takes a wide path that the main one never enters, for any E*M:
//   cat does not fit shared memory beside the ring, so the consumers write
//   it in fp32 to the block's device workspace (the caller's, 8 KB a
//   32-column block, in the layout wgmma reads) and arrive on an mbarrier
//   once a tile; the producer waits there and brings each o step's block
//   of cat into the slot by a bulk copy beside the step's weights, and the
//   consumers split it where it landed as they split x.  o's chunks go
//   eight at a time, each group leaving for y with its bias, and the
//   LayerNorm reads y back (each thread the columns it wrote).
// - a step's 12 products run back to back and are waited for before the
//   next step is split: keeping them in flight across steps made ptxas
//   serialise every wgmma (C7515) and cost more than it hid.  A
//   modality's qkv and a chunk of o are one accumulation each, over C_m
//   and E*M terms: the 1e-4 gate holds without the fresh accumulator a
//   slice that the convs over K*C channels need (chip_smoke.py holds it
//   up to E*M = 1280).
// - with one warpgroup on an SM, a tile's time is the latency of its
//   instructions: everything between the products runs without branches
//   over the seven slots and the eight chunks (a slot or column beyond M
//   or E*M masked by selects; a branch between two shuffles or two loads
//   serialises them), and the biases and the LayerNorm's vectors are read
//   where they wait for no one (the qkv biases loaded into the
//   accumulators before the products, bo, ln_w and ln_b staged in shared
//   memory once a block on the main path).

#include "wgmma_common.cuh"

namespace {

constexpr int kMaxModal = 7;   // the LFAN modalities with embedding sizes
constexpr int kRows = 64;      // frames a tile: the wgmma height
constexpr int kKC = 32;        // input channels a step
constexpr int kSub = kKC / 8;  // its k8 products (of each of the 3 parts)
constexpr int kDS = 16;        // head dims a slice
constexpr int kQKV = 3 * kDS;  // columns of a (head, slice) product: 48
constexpr int kON = 32;        // o columns a chunk
constexpr int kMaxChunks = 8;  // o chunks in registers at a time
constexpr int kVec = kMaxChunks * kON;  // bo, ln_w, ln_b staged: E*M <= 256
constexpr int kMaxRing = 8;    // ring slots at most
constexpr int kHead = 256;     // the barriers, before the ring
constexpr int kThreads = 160;  // one consumer warpgroup, one producer warp
// a slot: x's step, or a wide o step's block of cat (hi and lo, each 8
// chunks of 4 channels x 64 rows x 16 bytes), and the step's weight parts
// (hi and lo)
constexpr int kAPart = (kKC / 4) * kRows * 16;  // 8192
constexpr int kBPart = kKC * kQKV * 4;          // 6144
constexpr int kOPart = kKC * kON * 4;           // 4096: an o step's part
constexpr int kSlot = 2 * kAPart + 2 * kBPart;
constexpr int kCatSlice = 2 * kRows * 16;  // a part of 8 columns of cat
constexpr int kLogits = kMaxModal * kMaxModal;  // a row's (m1, m2) logits
// two ring slots beside the largest split cat (E*M = 256), the logits and
// the vectors, so that the producer runs ahead
static_assert(kMaxSmem - kHead - 4 * (2 * kRows * kVec + kRows * kLogits +
                                      3 * kVec) >= 2 * kSlot,
              "the ring needs two slots");

struct FusionArgs {
  const float* w_hi[kMaxModal];  // packed: see fvt_fusion_tf32x3_forward
  const float* w_lo[kMaxModal];
  const float* bias[kMaxModal];  // (H*S, 48)
  int C[kMaxModal];
  int steps[kMaxModal];          // ceil(C_m / 32)
  const float* wo_hi;  // packed: see fvt_fusion_tf32x3_forward
  const float* wo_lo;
  const float* bo;    // (E*M)
  const float* ln_w;  // (E*M)
  const float* ln_b;  // (E*M)
  float* y;           // (N, E*M)
  float* ws;          // wide: cat of a block's tile, chunks * 8 KB a block
  int N, M, H, hd;
  int S;       // slices of 16 dims a head: ceil(hd / 16)
  int EM;      // E*M, the width of cat, o and y
  int chunks;  // o chunks of 32 columns, o's steps of 32 rows of Wo and
               // cat's 32-column blocks: ceil(EM / 32)
  int wide;    // E*M above 256: cat through ws, o through y (the header)
  int tiles;   // ceil(N / 64)
  int ring;    // ring slots
  int cat;     // byte offsets in shared memory: cat's hi part (lo follows)
  int lg;      //   the logits of a head of S > 1 slices
  int vec;     //   and bo, ln_w, ln_b, kVec floats apart (E*M <= 256)
  float scale;   // 1 / sqrt(hd)
  float inv_em;  // 1 / EM
};

#ifdef FVT_DIAG_CLOCK
// Block 0's first tile, thread 0: clock64() at each phase's end, from the
// tile's start (tools/profile_fusion.py reads them)
constexpr int kMarks = 64;
__device__ long long g_marks[kMarks];
#define FVT_MARK()                                                   \
  do {                                                               \
    if (blockIdx.x == 0 && tid == 0 && marks < kMarks)               \
      g_marks[marks++] = clock64() - clock0;                         \
  } while (0)
#else
#define FVT_MARK() \
  do {             \
  } while (0)
#endif

// one TMA map of x_m (C_m, N) a modality, boxes of 4 channels x 64 rows
struct XMaps {
  CUtensorMap m[kMaxModal];
};

// d (64 x 48, fp32) = d * scale_d + A (64 x 8) @ B (8 x 48), tf32 in
// shared memory behind descriptors, both K-major
__device__ __forceinline__ void wgmma_n48(float (&d)[24], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32, fp32) = d * scale_d + A (64 x 8) @ B (8 x 32), as above
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the low 13 bits cleared) in two integer instructions: a
// conversion issues at a quarter of their rate, and the split converts 64
// values a thread a step.  Infinities stay; this kernel's inputs are
// finite.
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The passes over a head's slices of 16 dims: kOnePass (one slice:
// logits, softmax and values from the registers), or two: kLogitsPass
// (partial logits added into shared memory), then kValuesPass (the
// products again, p read from shared memory)
enum Pass { kOnePass, kLogitsPass, kValuesPass };

// cat (64 x 32*chunks) as wgmma's A, in floats: per 8-column slice 2
// chunks of 4 columns x 64 rows, so each 32-column block is one step's A
// operand (kAPart bytes).  Column col of row r:
__device__ __forceinline__ int cat_at(int r, int col) {
  return ((col >> 3) * 2 + ((col >> 2) & 1)) * (kRows * 4) + r * 4 +
         (col & 3);
}

__global__ void __launch_bounds__(kThreads, 1)
    fusion_tf32x3_kernel(const __grid_constant__ FusionArgs a,
                         const __grid_constant__ XMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t full = smem_u32(smem), empty = full + 64;
  // wide: the consumers have written a tile's cat to ws (one phase a tile)
  const uint32_t cat_ready = full + 128;
  unsigned char* ring = smem + kHead;
  const int cat_slices = 4 * a.chunks;  // 8-column slices of cat
  float* cat_hi = reinterpret_cast<float*>(smem + a.cat);
  float* cat_lo = cat_hi + cat_slices * (kCatSlice / 4);
  float* lg = reinterpret_cast<float*>(smem + a.lg);
  // bo, ln_w and ln_b at 0, kVec and 2*kVec (read in the epilogue)
  float* vec = reinterpret_cast<float*>(smem + a.vec);
  // the block's cat where E*M is wide, one 32-column block a step
  float* ws = a.ws + (size_t)blockIdx.x * a.chunks * (kAPart / 4);
  static_assert(kMaxRing <= 8, "the ring's barriers take 128 bytes");
  if (tid == 0) {
    for (int i = 0; i < a.ring; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4);  // the consumer warps
    }
    mbar_init(cat_ready, kThreads - 32);  // every consumer thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!a.wide) {
    // cat's columns from E*M to its last block's end are zeros that o's
    // products read (both parts)
    for (int i = tid; i < cat_slices * (kCatSlice / 2); i += kThreads)
      cat_hi[i] = 0.f;
    for (int i = tid; i < a.EM; i += kThreads) {
      vec[i] = a.bo[i];
      vec[kVec + i] = a.ln_w[i];
      vec[2 * kVec + i] = a.ln_b[i];
    }
  }
  __syncthreads();
  const int passes = a.S == 1 ? 1 : 2;
#ifdef FVT_DIAG_CLOCK
  const long long clock0 = clock64();
  int marks = 0;
#endif

  // The role, as a value ptxas knows to be the same across a warp.
  if (__shfl_sync(0xffffffffu, tid >> 7, 0) == 1) {
    // The producer: lane 0 walks the consumers' steps in their order,
    // waits until a slot is empty, sets the bytes to expect and starts the
    // step's copies, all counted on the slot's `full`.
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    if (lane != 0) return;
    int slot = 0, phase = 0;
    auto next = [&](uint32_t* sa, uint32_t* bar) {
      mbar_wait(empty + 8 * slot, phase ^ 1);
      *sa = smem_u32(ring + (size_t)slot * kSlot);
      *bar = full + 8 * slot;
      if (++slot == a.ring) slot = 0, phase ^= 1;
    };
    for (int tile = blockIdx.x, it = 0; tile < a.tiles;
         tile += gridDim.x, ++it) {
      const int row0 = tile * kRows;
      for (int h = 0; h < a.H; ++h)
        for (int pass = 0; pass < passes; ++pass)
          for (int ds = 0; ds < a.S; ++ds)
            for (int m = 0; m < a.M; ++m) {
              // the (head, slice)'s packed weights: steps of 32 channels
              const size_t w0 =
                  (size_t)(h * a.S + ds) * a.steps[m] * (kKC * kQKV);
              for (int st = 0; st < a.steps[m]; ++st) {
                uint32_t sa, bar;
                next(&sa, &bar);
                // chunks of 4 channels below C_m; the rest are not loaded
                int chunks = (a.C[m] - st * kKC) / 4;
                if (chunks > kKC / 4) chunks = kKC / 4;
                const size_t w = w0 + (size_t)st * (kKC * kQKV);
                mbar_expect_tx(bar, 2 * kBPart + chunks * kRows * 16);
                bulk_copy(sa + 2 * kAPart, a.w_hi[m] + w, kBPart, bar);
                bulk_copy(sa + 2 * kAPart + kBPart, a.w_lo[m] + w, kBPart,
                          bar);
                for (int ch = 0; ch < chunks; ++ch)
                  tma_tile3d(sa + ch * kRows * 16, &maps.m[m],
                             st * kKC + 4 * ch, row0, 0, bar);
              }
            }
      // wide: the tile's cat is in ws once every consumer arrived; each
      // step brings its block beside the weights
      if (a.wide) mbar_wait(cat_ready, it & 1);
      for (int j = 0; j < a.chunks; ++j)
        for (int st = 0; st < a.chunks; ++st) {
          uint32_t sa, bar;
          next(&sa, &bar);
          const size_t w = ((size_t)j * a.chunks + st) * (kKC * kON);
          mbar_expect_tx(bar, 2 * kOPart + (a.wide ? kAPart : 0));
          if (a.wide) bulk_copy(sa, ws + st * (kAPart / 4), kAPart, bar);
          bulk_copy(sa + 2 * kAPart, a.wo_hi + w, kOPart, bar);
          bulk_copy(sa + 2 * kAPart + kOPart, a.wo_lo + w, kOPart, bar);
        }
    }
    return;
  }

  // The consumer warpgroup.  Thread (warp, lane) holds rows 16*warp +
  // lane/4 (+ 8) and columns 8*j + 2*(lane % 4) (+ 1) of a 64-row product
  // in d[4*j + 2*half (+ 1)], half 1 for the row + 8.
  const int warp = tid >> 5;
  const int quad = lane & 3;
  float acc[kMaxModal][kQKV / 2];  // a head slice's q, k, v a modality
  float o[kMaxChunks][kON / 2];    // o's chunks
  int slot = 0, phase = 0;  // the next step's slot and the parity it waits

  // Waits for the next step's copies; returns its slot.
  auto take = [&]() -> unsigned char* {
#ifndef FVT_DIAG_PRODUCTS_ONLY
    mbar_wait_uniform(full + 8 * slot, phase);
#endif
    return ring + (size_t)slot * kSlot;
  };
  // After a step's products are committed: wait for them and give the
  // slot back (each consumer warp arrives once).  Keeping them in flight
  // while the next step is split made ptxas serialise every wgmma (C7515)
  // and cost more than it hid (PERF.md, tools/profile_fusion.py).
  auto step_done = [&]() {
    wgmma_wait<0>();
    mbar_arrive_if(lane == 0, empty + 8 * slot);
    const bool wrap = slot + 1 == a.ring;  // selects, not a branch
    slot = wrap ? 0 : slot + 1;
    phase ^= wrap;
  };

  // A step's A operand (64 rows x 32 columns) split into the slot's two
  // parts, hi = tf32(v) and lo = tf32(v - hi), from src (the slot itself,
  // where x landed, or a block of a wide cat), in the layout wgmma reads:
  // float4 i of a part is chunk i / 64 (4 columns), row i % 64.  A chunk
  // from `loaded` on (beyond C_m: not loaded) becomes zeros.
  auto split = [&](unsigned char* sa, const float4* src, int loaded) {
#ifndef FVT_DIAG_NO_SPLIT
    float4* hi = reinterpret_cast<float4*>(sa);
    float4* lo = reinterpret_cast<float4*>(sa + kAPart);
#pragma unroll
    for (int k = 0; k < kAPart / 16 / 128; ++k) {
      const int i = tid + 128 * k;
      const float4 v =
          (i >> 6) < loaded ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vh = make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                    tf32_rna(v.z), tf32_rna(v.w));
      hi[i] = vh;
      lo[i] = make_float4(tf32_rna(v.x - vh.x), tf32_rna(v.y - vh.y),
                          tf32_rna(v.z - vh.z), tf32_rna(v.w - vh.w));
    }
#endif
    // the writes are seen by wgmma's async proxy, and all of the
    // warpgroup's before any of it reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  };

  // One step of a qkv product into d: x_m's 32 channels from st*32 on,
  // split where they landed, times the step's weights.
  auto qkv_step = [&](float(&d)[kQKV / 2], int c, int st) {
    unsigned char* sa = take();
    split(sa, reinterpret_cast<const float4*>(sa), (c - st * kKC) / 4);
    const uint32_t sa_u32 = smem_u32(sa);
    const uint64_t a_hi = make_desc(sa_u32, kRows * 16, 128);
    const uint64_t a_lo = a_hi + (kAPart >> 4);
    const uint64_t b_hi =
        make_desc(sa_u32 + 2 * kAPart, (kQKV / 8) * 128, 128);
    const uint64_t b_lo = b_hi + (kBPart >> 4);
    wgmma_fence();
#ifndef FVT_DIAG_NO_PRODUCTS
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      // k8 product q: chunks 2q and 2q + 1 of x, 8 rows of the weights
      const int aq = q * (kCatSlice >> 4), bq = q * (kBPart / kSub >> 4);
      // the small products first
      wgmma_n48(d, a_hi + aq, b_lo + bq, 1);
      wgmma_n48(d, a_lo + aq, b_hi + bq, 1);
      wgmma_n48(d, a_hi + aq, b_hi + bq, 1);
    }
#endif
    wgmma_commit();
    step_done();
  };

  // wide: the columns of ws from E*M to cat's last block's end are zeros
  // that o's products read (written once; seen by the copies with the
  // first tile's cat)
  if (a.wide) {
    const int pad = kON * a.chunks - a.EM;
    for (int i = tid; i < kRows * pad; i += kThreads - 32)
      ws[cat_at(i / pad, a.EM + i % pad)] = 0.f;
  }

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    for (int h = 0; h < a.H; ++h)
      for (int pass = 0; pass < passes; ++pass) {
        const Pass mode = passes == 1 ? kOnePass
                          : pass == 0 ? kLogitsPass : kValuesPass;
        for (int ds = 0; ds < a.S; ++ds) {
          FVT_MARK();  // a slice's start (the attention before it ended)
          // the accumulators start at the slice's biases, all loaded at
          // once (a slot from M on reads the first modality's and takes no
          // part: its p is 0)
          const int g = h * a.S + ds;
#pragma unroll
          for (int m = 0; m < kMaxModal; ++m) {
            const float* b = a.bias[m] + g * kQKV + 2 * quad;
#pragma unroll
            for (int j = 0; j < kQKV / 8; ++j) {
              const float2 bb =
                  __ldg(reinterpret_cast<const float2*>(b + 8 * j));
              acc[m][4 * j] = acc[m][4 * j + 2] = bb.x;
              acc[m][4 * j + 1] = acc[m][4 * j + 3] = bb.y;
            }
          }
#pragma unroll
          for (int m = 0; m < kMaxModal; ++m) {
            if (m < a.M) {
              for (int st = 0; st < a.steps[m]; ++st)
                qkv_step(acc[m], a.C[m], st);
            }
          }
          FVT_MARK();  // the slice's products
          // q at columns 0..15, k at 16..31, v at 32..47: the same head
          // dim d = 16*ds + 8*(j % 2) + 2*quad + c at j, j + 2 and j + 4.
          // The slots' sums are taken over all seven, without branches (a
          // branch between them would serialise their shuffles); a slot
          // from M on is masked to p = 0.
#pragma unroll
          for (int m1 = 0; m1 < kMaxModal; ++m1) {
            if (m1 >= a.M) continue;
            float p[2][kMaxModal];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 16 * warp + (lane >> 2) + 8 * half;
              float* row = lg + (r * kMaxModal + m1) * kMaxModal;
              if (mode == kValuesPass) {
#pragma unroll
                for (int m2 = 0; m2 < kMaxModal; ++m2)
                  p[half][m2] = m2 < a.M ? row[m2] : 0.f;
                continue;
              }
              float s[kMaxModal];
#pragma unroll
              for (int m2 = 0; m2 < kMaxModal; ++m2) {
                s[m2] = 0.f;
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                  for (int c = 0; c < 2; ++c)
                    s[m2] = fmaf(acc[m1][4 * j + 2 * half + c],
                                 acc[m2][4 * (j + 2) + 2 * half + c], s[m2]);
              }
#pragma unroll
              for (int m2 = 0; m2 < kMaxModal; ++m2) s[m2] = quad_sum(s[m2]);
              if (mode == kLogitsPass) {
#pragma unroll
                for (int m2 = 0; m2 < kMaxModal; ++m2)
                  if (quad == 0 && m2 < a.M)
                    row[m2] = ds == 0 ? s[m2] : row[m2] + s[m2];
                continue;
              }
              float mx = -INFINITY;
#pragma unroll
              for (int m2 = 0; m2 < kMaxModal; ++m2) {
                p[half][m2] = m2 < a.M ? s[m2] * a.scale : -INFINITY;
                mx = fmaxf(mx, p[half][m2]);
              }
              float denom = 0.f;
#pragma unroll
              for (int m2 = 0; m2 < kMaxModal; ++m2) {
                p[half][m2] = expf(p[half][m2] - mx);  // 0 from M on
                denom += p[half][m2];
              }
              const float rdenom = __frcp_rn(denom);
#pragma unroll
              for (int m2 = 0; m2 < kMaxModal; ++m2) p[half][m2] *= rdenom;
            }
            if (mode == kLogitsPass) continue;
            // v' = sum_m2 p v_m2 + v_m1, into cat at column (h*M + m1)*hd
            // + d, split
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 16 * warp + (lane >> 2) + 8 * half;
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int i = 4 * (j + 4) + 2 * half + c;
                  float v = 0.f;
#pragma unroll
                  for (int m2 = 0; m2 < kMaxModal; ++m2)
                    v = fmaf(p[half][m2], acc[m2][i], v);
                  v += acc[m1][i];
                  const int d = kDS * ds + 8 * j + 2 * quad + c;
                  const int at = cat_at(r, (h * a.M + m1) * a.hd + d);
                  const float vh = tf32_rna(v);
                  if (d < a.hd) {
                    if (a.wide) {
                      ws[at] = v;  // split where a step takes it
                    } else {
                      cat_hi[at] = vh;
                      cat_lo[at] = tf32_rna(v - vh);
                    }
                  }
                }
            }
          }
        }
        if (mode == kLogitsPass) {
          // the logits summed over the slices: lane 0 of a quad wrote its
          // rows and turns them into p in place for the quad
          if (quad == 0) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 16 * warp + (lane >> 2) + 8 * half;
              for (int m1 = 0; m1 < a.M; ++m1) {
                float* row = lg + (r * kMaxModal + m1) * kMaxModal;
                float mx = -INFINITY, denom = 0.f;
                for (int m2 = 0; m2 < a.M; ++m2)
                  mx = fmaxf(mx, row[m2] * a.scale);
                for (int m2 = 0; m2 < a.M; ++m2) {
                  row[m2] = expf(row[m2] * a.scale - mx);
                  denom += row[m2];
                }
                for (int m2 = 0; m2 < a.M; ++m2) row[m2] /= denom;
              }
            }
          }
          __syncwarp();
        }
      }

    FVT_MARK();  // the last attention
    if (!a.wide) {
      // o = cat @ WoT: cat's writes are seen by the async proxy, and all of
      // the warpgroup's before any of its wgmma reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      const uint32_t cat_u32 = smem_u32(cat_hi);
      const uint32_t lo_off = cat_slices * kCatSlice;
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
        for (int i = 0; i < kON / 2; ++i) o[j][i] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        if (j >= a.chunks) continue;
        for (int st = 0; st < a.chunks; ++st) {
          unsigned char* sa = take();
          const uint64_t a_hi = make_desc(cat_u32 + st * 4 * kCatSlice,
                                          kRows * 16, 128);
          const uint64_t a_lo = a_hi + (lo_off >> 4);
          const uint64_t b_hi =
              make_desc(smem_u32(sa + 2 * kAPart), (kON / 8) * 128, 128);
          const uint64_t b_lo = b_hi + (kOPart >> 4);
          wgmma_fence();
#ifndef FVT_DIAG_NO_PRODUCTS
#pragma unroll
          for (int q = 0; q < kSub; ++q) {
            const int aq = q * (kCatSlice >> 4), bq = q * (kOPart / kSub >> 4);
            wgmma_n32(o[j], a_hi + aq, b_lo + bq, 1);
            wgmma_n32(o[j], a_lo + aq, b_hi + bq, 1);
            wgmma_n32(o[j], a_hi + aq, b_hi + bq, 1);
          }
#endif
          wgmma_commit();
          step_done();
        }
      }

      FVT_MARK();  // o's products
      // + bo, then the LayerNorm over a row's E*M columns: a row's columns
      // lie in its quad.  Without branches over the chunks' columns: a column
      // from E*M on (zeros) is masked out of the sums.  Both rows of a
      // thread (half 0 and 1) share each vector load.
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
        for (int g = 0; g < kON / 8; ++g) {
          const int n = kON * j + 8 * g + 2 * quad;  // EM is even
          const bool in = n < a.EM;
          const float2 b = *reinterpret_cast<const float2*>(vec + n);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * g + 2 * half;
            o[j][i] = in ? o[j][i] + b.x : 0.f;
            o[j][i + 1] = in ? o[j][i + 1] + b.y : 0.f;
            sum[half] += o[j][i] + o[j][i + 1];
          }
        }
      float mean[2], inv[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mean[half] = quad_sum(sum[half]) * a.inv_em;
        float var = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
          for (int g = 0; g < kON / 8; ++g) {
            const bool in = kON * j + 8 * g + 2 * quad < a.EM;
            const float d0 = in ? o[j][4 * g + 2 * half] - mean[half] : 0.f;
            const float d1 = in ? o[j][4 * g + 2 * half + 1] - mean[half] : 0.f;
            var = fmaf(d0, d0, fmaf(d1, d1, var));
          }
        inv[half] = rsqrtf(fmaf(quad_sum(var), a.inv_em, 1e-5f));
      }
      const int t = row0 + 16 * warp + (lane >> 2);
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
        for (int g = 0; g < kON / 8; ++g) {
          const int n = kON * j + 8 * g + 2 * quad;
          const float2 w = *reinterpret_cast<const float2*>(vec + kVec + n);
          const float2 b =
              *reinterpret_cast<const float2*>(vec + 2 * kVec + n);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 out = make_float2(
                (o[j][4 * g + 2 * half] - mean[half]) * inv[half] * w.x + b.x,
                (o[j][4 * g + 2 * half + 1] - mean[half]) * inv[half] * w.y +
                    b.y);
            if (t + 8 * half < a.N && n < a.EM)
              *reinterpret_cast<float2*>(
                  a.y + (size_t)(t + 8 * half) * a.EM + n) = out;
          }
        }
    } else {
      // E*M above 256 (the header note): each thread's writes of cat are
      // seen by the async proxy before it arrives; o's chunks eight at a
      // time, each step splitting its block of cat where it landed; + bo,
      // o leaves for y with the row sums, and the LayerNorm reads it back
      // (each thread the columns 2*quad + 8k of its rows, which it wrote)
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      mbar_arrive(cat_ready);
      const int t = row0 + 16 * warp + (lane >> 2);  // rows t and t + 8
      float sum[2] = {0.f, 0.f};
      for (int j0 = 0; j0 < a.chunks; j0 += kMaxChunks) {
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
          for (int i = 0; i < kON / 2; ++i) o[j][i] = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {
          if (j0 + j >= a.chunks) continue;
          for (int st = 0; st < a.chunks; ++st) {
            unsigned char* sa = take();
            split(sa, reinterpret_cast<const float4*>(sa), kKC / 4);
            const uint32_t sa_u32 = smem_u32(sa);
            const uint64_t a_hi = make_desc(sa_u32, kRows * 16, 128);
            const uint64_t a_lo = a_hi + (kAPart >> 4);
            const uint64_t b_hi =
                make_desc(sa_u32 + 2 * kAPart, (kON / 8) * 128, 128);
            const uint64_t b_lo = b_hi + (kOPart >> 4);
            wgmma_fence();
#ifndef FVT_DIAG_NO_PRODUCTS
#pragma unroll
            for (int q = 0; q < kSub; ++q) {
              const int aq = q * (kCatSlice >> 4);
              const int bq = q * (kOPart / kSub >> 4);
              wgmma_n32(o[j], a_hi + aq, b_lo + bq, 1);
              wgmma_n32(o[j], a_lo + aq, b_hi + bq, 1);
              wgmma_n32(o[j], a_hi + aq, b_hi + bq, 1);
            }
#endif
            wgmma_commit();
            step_done();
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
          for (int g = 0; g < kON / 8; ++g) {
            const int n = kON * (j0 + j) + 8 * g + 2 * quad;  // EM is even
            if (n >= a.EM) continue;
            const float2 b = __ldg(reinterpret_cast<const float2*>(a.bo + n));
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float2 v = make_float2(o[j][4 * g + 2 * half] + b.x,
                                           o[j][4 * g + 2 * half + 1] + b.y);
              sum[half] += v.x + v.y;
              if (t + 8 * half < a.N)
                *reinterpret_cast<float2*>(
                    a.y + (size_t)(t + 8 * half) * a.EM + n) = v;
            }
          }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mean = quad_sum(sum[half]) * a.inv_em;
        const bool row_in = t + 8 * half < a.N;  // the same in a quad
        float* y = a.y + (size_t)(row_in ? t + 8 * half : 0) * a.EM;
        float var = 0.f;
        for (int n = 2 * quad; row_in && n < a.EM; n += 8) {
          const float2 v = *reinterpret_cast<const float2*>(y + n);
          var = fmaf(v.x - mean, v.x - mean, fmaf(v.y - mean, v.y - mean,
                                                   var));
        }
        const float inv = rsqrtf(fmaf(quad_sum(var), a.inv_em, 1e-5f));
        for (int n = 2 * quad; row_in && n < a.EM; n += 8) {
          const float2 v = *reinterpret_cast<const float2*>(y + n);
          const float2 w = __ldg(reinterpret_cast<const float2*>(a.ln_w + n));
          const float2 b = __ldg(reinterpret_cast<const float2*>(a.ln_b + n));
          *reinterpret_cast<float2*>(y + n) =
              make_float2((v.x - mean) * inv * w.x + b.x,
                          (v.y - mean) * inv * w.y + b.y);
        }
      }
    }
    FVT_MARK();  // the LayerNorm
  }
}

}  // namespace

extern "C" {

#ifdef FVT_DIAG_CLOCK
// The phase marks of the last launch (FVT_DIAG_CLOCK builds only).
int fvt_fusion_tf32x3_marks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
}
#endif

// The fusion block on `stream` over N frames of M modalities, M from 1 to
// 7, in one launch.  ptrs (a host array) holds 4M device pointers: each
// modality's x (N, C_m), then its packed w_hi, w_lo and bias; c (a host
// array) the M widths C_m, each a multiple of 4.  E % H == 0 and E a
// multiple of 4; any E*M.  Each modality's Wqkv (C_m, 3E) comes as its two
// TF32 parts, hi = tf32(w) and lo = tf32(w - hi), packed per (head h,
// slice ds of 16 head dims), S = ceil(hd / 16) slices a head of hd = E/H
// dims, 48 columns [q | k | v] of 16 dims each, the channels in steps of
// 32 (zero rows up to a multiple of 32):
//   w[h*S + ds][slice][chunk][n8][n][k] =
//       Wqkv[8*slice + 4*chunk + k][h*3*hd + part*hd + 16*ds + t]
// with part = (8*n8 + n) / 16, t = (8*n8 + n) % 16, slice < 4*ceil(C_m /
// 32), chunk < 2, n8 < 6, n < 8, k < 4, and 0 where the channel is beyond
// C_m or 16*ds + t >= hd; the bias (H*S, 48) the same way.  Wo (E*M, E*M)
// comes as its two parts packed for column chunks of 32:
//   wo[j][slice][chunk][n8][n][k] = Wo[8*slice + 4*chunk + k][32*j + 8*n8 +
//   n], j < ceil(E*M / 32), slice < 4*ceil(E*M / 32), n8 < 4, 0 beyond E*M.
// bo, ln_w, ln_b (E*M), out (N, E*M).  Where E*M is above 256, ws is a
// device workspace of ws_blocks blocks of ceil(E*M / 32) * 2048 floats
// (one a launched block: the launch takes at most ws_blocks blocks); unused
// otherwise.  Every pointer 16-byte aligned.  Returns cudaSuccess, the
// error of a device query, the attribute call, a tensor map or the launch
// (cudaGetLastError), or cudaErrorInvalidValue for shapes the kernel does
// not take or a wide E*M without a workspace.
int fvt_fusion_tf32x3_forward(const void* const* ptrs, const int* c,
                              const void* wo_hi, const void* wo_lo,
                              const void* bo, const void* ln_w,
                              const void* ln_b, void* out, void* ws,
                              int ws_blocks, int N, int M, int E, int H,
                              void* stream) {
  if (N <= 0 || M <= 0 || M > kMaxModal || E <= 0 || H <= 0 || E % H ||
      E % 4)
    return (int)cudaErrorInvalidValue;
  FusionArgs a{};
  XMaps maps;
  for (int m = 0; m < M; ++m) {
    if (c[m] <= 0 || c[m] % 4) return (int)cudaErrorInvalidValue;
    a.w_hi[m] = (const float*)ptrs[M + m];
    a.w_lo[m] = (const float*)ptrs[2 * M + m];
    a.bias[m] = (const float*)ptrs[3 * M + m];
    a.C[m] = c[m];
    a.steps[m] = (c[m] + kKC - 1) / kKC;
    const cudaError_t err = make_tile3d_map((const float*)ptrs[m], 1, N,
                                            c[m], kRows, &maps.m[m]);
    if (err != cudaSuccess) return (int)err;
  }
  for (int m = M; m < kMaxModal; ++m) a.bias[m] = a.bias[0];  // unused
  a.wo_hi = (const float*)wo_hi;
  a.wo_lo = (const float*)wo_lo;
  a.bo = (const float*)bo;
  a.ln_w = (const float*)ln_w;
  a.ln_b = (const float*)ln_b;
  a.y = (float*)out;
  a.ws = (float*)ws;
  a.N = N, a.M = M, a.H = H, a.hd = E / H;
  a.S = (a.hd + kDS - 1) / kDS;
  a.EM = E * M;
  a.chunks = (a.EM + kON - 1) / kON;
  a.tiles = (N + kRows - 1) / kRows;
  a.scale = 1.f / sqrtf((float)a.hd);
  a.inv_em = 1.f / (float)a.EM;
  // cat split and the vectors (not where E*M is wide: cat goes through
  // ws), the logits, then as deep a ring as the rest of shared memory
  // holds: 2 slots at E*M = 256 with the logits, 7 where E*M is wide
  a.wide = a.chunks > kMaxChunks;
  if (a.wide && (ws == nullptr || ws_blocks <= 0))
    return (int)cudaErrorInvalidValue;
  const int cat_bytes =
      a.wide ? 0 : 2 * kRows * kON * a.chunks * (int)sizeof(float);
  const int lg_bytes = a.S > 1 ? kRows * kLogits * (int)sizeof(float) : 0;
  const int vec_bytes = a.wide ? 0 : 3 * kVec * (int)sizeof(float);
  a.ring = (kMaxSmem - kHead - cat_bytes - lg_bytes - vec_bytes) / kSlot;
  if (a.ring > kMaxRing) a.ring = kMaxRing;
  a.cat = kHead + a.ring * kSlot;
  a.lg = a.cat + cat_bytes;
  a.vec = a.lg + lg_bytes;
  const int bytes = a.vec + vec_bytes;
  // host time on a dispatch's path: the attribute call and the SM count
  // once a device
  static int set_device = -1, sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != set_device) {
    err = cudaFuncSetAttribute(fusion_tf32x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    set_device = device;
  }
  int blocks = a.tiles < sms ? a.tiles : sms;
  if (a.wide && ws_blocks < blocks) blocks = ws_blocks;
  fusion_tf32x3_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      a, maps);
  return (int)cudaGetLastError();
}

}  // extern "C"
