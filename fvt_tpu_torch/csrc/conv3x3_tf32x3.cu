// 3x3 stride-1 pad-1 convolution, NHWC, no bias, fp32 in and out at fp32
// accuracy, as an implicit GEMM on Hopper's warpgroup matrix multiply
// (sm_90a) with split-TF32 (3xTF32) products.
//
// Replaces fvt_tpu/ops/conv_pallas.py::_conv3x3_kernel (the Pallas kernel
// behind conv3x3_pallas) for fp32 tensors: y[n, i, j, :] = sum over the nine
// taps (dy, dx) of x[n, i + dy - 1, j + dx - 1, :] @ w[dy*3 + dx], x zero
// outside the image.  x (N, H, W, C), w (9, C, Co), y (N, H, W, Co).  The
// CUDA-core kernel of conv3x3.cu computes the same and stays beside it for
// measurements only.
//
// What bounds it.  At the ArcFace shapes (N = 2400; 40x40x64 to 5x5x512) a
// conv is 2*9*C*Co operations a pixel against (C + Co)*4 bytes, so the
// operations bound it.  The CUDA cores' fp32 peak (67 TFLOP/s) is the wall
// the SIMT kernel sits at half of; the tensor cores take TF32 (10 explicit
// mantissa bits) at 494.7 TFLOP/s, too coarse alone for the 1e-4 gate.  So
// each operand is split, a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
// (both rounded to nearest, ties away, by cvt.rna), and the kernel sums
// hi*hi + hi*lo + lo*hi in the fp32 accumulators of wgmma: three TF32
// products a multiply, 3 * 13.58 TFLOP a forward's 45 convs, 82.4 ms at the
// TF32 peak.  The dropped lo*lo and lo's own rounding are 2^-21 of a product.
//
// The design is conv3x3_wgmma.cu's (read its header note): all frames in one
// padded line, a tile of 256 consecutive padded coordinates by BN output
// channels, the nine taps as nine descriptor offsets into one staged patch,
// TMA im2col loads and one bulk copy of packed weights a slice part,
// counted on a ring slot's `full` mbarrier, a producer warp and persistent
// blocks.  What differs in fp32:
// - A slice is 8 input channels (one k8 step of the TF32 wgmma), staged as
//   2 chunks of 4 channels x 16 bytes a coordinate: byte for byte the bf16
//   kernel's staging, so the tap offsets (dy*(W+1) + dx)*16 B and the
//   descriptor strides carry over.  C needs only be a multiple of 4: a chunk
//   beyond C is not loaded and is zeroed where x is split.
// - The TF32 wgmma takes no transpose: B must be K-major.  The caller packs
//   each part of w once (fvt_conv3x3_tf32x3_forward) as core matrices of 8
//   output channels x 4 inputs, a slice's nine taps contiguous.
// - x is split where it is staged: after a slot's `full` barrier the
//   consumer threads rewrite the patch as hi in place and write lo into the
//   slot's second A buffer, fence the writes to the async proxy, and meet
//   at a named barrier of the consumers only (the producer warp runs on);
//   then each warpgroup issues the slice's 27 wgmma (3 products x 9 taps)
//   into one accumulator before one commit and wait.
// - The sums leave straight from the registers: a thread holds two fp32
//   columns of a row side by side, four lanes 32 contiguous bytes, so a
//   float2 store fills whole sectors and no staging is needed.
// - Four warpgroups of one 64-row sub-tile each, one block an SM: a ring of
//   three slots at BN = 64 (61 KB a slot at W = 40) or two at BN = 128
//   (98 KB), hi and lo of x and of w each.  Wider rows take fewer slots,
//   down to one (W above about 190 at BN = 128, 440 at BN = 64): no copy
//   then overlaps the products, but the kernel takes every width the
//   producer warp's lanes can load, as the bf16 kernel does.
//
// The same kernel runs the fused BottleneckIR block (B5; replaces
// fvt_tpu/ops/bottleneck_pallas.py::_block_kernel, the Pallas kernel behind
// bottleneck_ir_fused) as two launches, fvt_bottleneck_tf32x3_forward: its
// elementwise work rides on the two places where every value already
// passes through a thread, chosen at compile time (the plain conv takes
// neither and is the code it was):
// - prologue kBn1, where x is split: each staged value becomes a1[c]*x +
//   b1[c] (bn1 folded to an affine), at image pixels only.  A pad stays
//   exactly 0 (bn1 comes before conv1's zero pad): a coordinate whose row
//   or column on the padded line is 0 (the image border, the pad row two
//   frames share), one at or beyond Q (past the last frame) and a chunk
//   beyond C.  The coordinates a thread splits repeat for every slice of
//   a tile, so the test is made once a tile, a bit a split step.
// - epilogue kPrelu, in the store: acc > 0 ? acc : alpha[n]*acc.
// - epilogue kBn2Residual, in the store: (acc*a2[n] + b2[n]) + res at the
//   output's own index (C = Co), read as a float2 beside the store.
// The affines round the product and the sum apart (__fmul_rn, __fadd_rn),
// in the plain version's order, so that no FMA contraction makes them
// differ from it.  conv1 (kBn1, kPrelu) writes v to device memory; conv2
// (no prologue, kBn2Residual) stages v as any conv stages x, and the copy
// engine fills its pads with 0: conv2's pad is 0, not PReLU of a halo
// pixel.  v costs one write and one read (0.15 ms at 10x10x256 on 2400
// frames at 3.35 TB/s, against a conv's ~2.7 ms).
// Accuracy.  wgmma's fp32 accumulation loses more than a rounding a step
// (the error of one accumulator grows with K ten times faster than a
// float32 sum's), and the block's gate is the conv's at outputs that x
// and b2 may bring near 0, through two convs.  So the block's launches sum
// each slice's 27 products in a fresh accumulator and add it to the
// tile's sum in fp32 after the slice: the wgmma sums stay the size of a
// slice's.  The second array of BN/2 registers fits at BN = 64 only (a
// thread has 96 registers: five warps share a quarter of the file), so the
// block's launches take column tiles of 64.
//
// Three build switches split the time for tools/profile_conv_bf16.py
// --dtype float32, and give wrong sums: -DFVT_DIAG_PRODUCTS_ONLY starts no
// copy and waits for none, -DFVT_DIAG_COPIES_ONLY runs the wgmma of the
// first slice only, -DFVT_DIAG_NO_SPLIT leaves the staged x as it landed
// (no split, no named barrier).

#include "wgmma_common.cuh"

namespace {

constexpr int kKC = 8;   // input channels a slice (one k8 step)
constexpr int kWG = 4;   // consumer warpgroups a block, one sub-tile each

// What a launch does besides the conv (the header note)
enum Prologue { kNoPrologue, kBn1 };
enum Epilogue { kStore, kPrelu, kBn2Residual };

struct ConvArgs {
  const float* x;
  const float* w_hi;  // packed: see fvt_conv3x3_tf32x3_forward
  const float* w_lo;
  float* y;
  int N, H, W, C, Co;
  int P;        // staged coordinates a tile: kBM + 2*(W+1) + 2, up to kLoad
  long long Q;  // padded coordinates in all: N*(H+1)*(W+1)
  int n_tiles;  // column tiles: ceil(Co / BN)
  int tiles;    // row tiles (kBM coordinates each) times column tiles
  // read only by the instantiations that use them
  const float* a1;     // kBn1: bn1's affine (C)
  const float* b1;
  const float* alpha;  // kPrelu: the slopes (Co)
  const float* a2;     // kBn2Residual: bn2's affine (Co) and the residual,
  const float* b2;     // shaped as y
  const float* res;
};

// a*x + b, rounded after the product and after the sum (no FMA)
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// A ring slot: x's hi and lo ([chunk][coordinate][4 floats] each, 2*P*16
// bytes), then w's hi and lo (a slice's nine taps each, 9*8*BN*4 bytes).
template <int BN>
__host__ __device__ constexpr size_t slot_bytes(int P) {
  return (size_t)2 * (2 * P * 16) + 2 * (9 * kKC * BN * 4);
}

template <int BN>
constexpr size_t smem_bytes(int P, int S) {
  return 128 + (size_t)S * slot_bytes<BN>(P);
}

// A block is kWG consumer warpgroups and one producer warp, and walks the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...  A ring of S slots lies
// between them, each with a `full` mbarrier (the copies of a slice have
// landed) and an `empty` one (every consumer warp has read it).
template <int BN, int S, Prologue kPro, Epilogue kEpi>
__global__ void __launch_bounds__(128 * kWG + 32, 1)
    conv3x3_tf32x3_kernel(ConvArgs a,
                          const __grid_constant__ CUtensorMap x_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kBBytes = 9 * kKC * BN * 4;  // one part of a slice's weights
  constexpr int kTapBytes = kKC * BN * 4;
  const int tid = threadIdx.x, lane = tid & 31;
  const int P = a.P, W1 = a.W + 1;
  const int a_bytes = 2 * P * 16;  // one part of a slice's x
  const int stage_bytes = (int)slot_bytes<BN>(P);
  const uint32_t full = smem_u32(smem), empty = full + 64;
  unsigned char* ring = smem + 128;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slices = (a.C + kKC - 1) / kKC;
  const long long frame = (long long)(a.H + 1) * W1;

  if (tid >= 128 * kWG) {
    // The producer.  Per slice it waits until the slot is empty, then its
    // first lanes each ask the copy engine for kLoad coordinates of one
    // 4-channel chunk (the tile stages the coordinates q0 + [0, P); the sums
    // are those of q0 + W1 + 1 + [0, kBM)) and lanes 0 and 1 for the hi and
    // lo parts of the slice's packed weights; all are counted on the slot's
    // `full`.  A load that would start beyond the last frame is left out
    // and its coordinates are zeroed (the pad row below the last frame lies
    // there); so is a chunk beyond C, which the consumers zero.
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
        const int chunks = s * kKC + 4 < a.C ? 2 : 1;
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
        if (lane == 0)
          mbar_expect_tx(bar, 2 * kBBytes + chunks * valid * kLoad * 16);
        __syncwarp();  // the expected bytes are set before any copy lands
        if (lane < 2) {
          const float* w = lane == 0 ? a.w_hi : a.w_lo;
          bulk_copy(sa_u32 + 2 * a_bytes + lane * kBBytes,
                    w + ((size_t)n_tile * slices + s) * (kBBytes / 4),
                    kBBytes, bar);
        }
        if (lane < 2 * valid && (lane & 1) < chunks)
          tma_im2col(sa_u32 + ((lane & 1) * P + (lane >> 1) * kLoad) * 16,
                     &x_map, s * kKC + (lane & 1) * 4, lw, lh, ln, bar);
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg holds the sums of the tile's rows
  // 64 * wg + [0, 64) in registers.
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  // The block's launches (those with an epilogue) take each slice's 27
  // products into a fresh accumulator and add it to the tile's sum in
  // fp32 (the header note); the plain conv sums all slices in acc.
  constexpr bool kFresh = kEpi != kStore;
  float acc[BN / 2];  // first written by a tile's (kFresh: slice's) first wgmma
  float sum[kFresh ? BN / 2 : 1];
  unsigned it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long q0 = (long long)(tile / a.n_tiles) * kBM;
    const int n0 = (tile % a.n_tiles) * BN;
    // kBn1: bit k is set where the coordinate of this thread's k-th split
    // step, q0 + i % P for i = tid + k*128*kWG (k < 8: P is at most 2048),
    // is an image pixel, by the store's test
    unsigned pixel = 0;
    if constexpr (kPro == kBn1) {
      for (int i = tid, k = 0; i < 2 * P; i += 128 * kWG, ++k) {
        const long long q = q0 + i % P;
        if (q >= a.Q) continue;
        const long long f = q / frame;
        const int rem = (int)(q - f * frame);
        const int row = rem / W1, col = rem - row * W1;
        if (row != 0 && col != 0) pixel |= 1u << k;
      }
    }
    for (int s = 0; s < slices; ++s, ++it) {
      const int slot = it % S;
      unsigned char* sa = ring + (size_t)slot * stage_bytes;
#ifndef FVT_DIAG_PRODUCTS_ONLY
      mbar_wait(full + 8 * slot, (it / S) & 1);  // the slice has landed
#endif
#ifndef FVT_DIAG_NO_SPLIT
      {
        // x = hi + lo, hi in place, lo into the slot's second A buffer; a
        // chunk beyond C (not loaded) becomes zeros; kBn1 first turns x
        // into a1*x + b1 at an image pixel of a real chunk
        float4* hi = reinterpret_cast<float4*>(sa);
        float4* lo = hi + 2 * P;
        const int real = s * kKC + 4 < a.C ? 2 * P : P;
        for (int i = tid, k = 0; i < 2 * P; i += 128 * kWG, ++k) {
          float4 v = i < real ? hi[i] : make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (kPro == kBn1) {
            if (i < real && ((pixel >> k) & 1u)) {
              const int c = s * kKC + (i < P ? 0 : 4);
              const float4 m = __ldg(reinterpret_cast<const float4*>(a.a1 + c));
              const float4 b = __ldg(reinterpret_cast<const float4*>(a.b1 + c));
              v = make_float4(affine(v.x, m.x, b.x), affine(v.y, m.y, b.y),
                              affine(v.z, m.z, b.z), affine(v.w, m.w, b.w));
            }
          }
          const float4 h = make_float4(to_tf32(v.x), to_tf32(v.y),
                                       to_tf32(v.z), to_tf32(v.w));
          hi[i] = h;
          lo[i] = make_float4(to_tf32(v.x - h.x), to_tf32(v.y - h.y),
                              to_tf32(v.z - h.z), to_tf32(v.w - h.w));
        }
        // the writes are seen by wgmma's async proxy, and all consumers'
        // before any reads them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
      }
#endif
      const uint32_t sa_u32 = smem_u32(sa);
      const uint64_t a_hi = make_desc(sa_u32 + wg * 64 * 16, P * 16, 128);
      const uint64_t a_lo = a_hi + (a_bytes >> 4);
      const uint64_t b_hi =
          make_desc(sa_u32 + 2 * a_bytes, (BN / 8) * 128, 128);
      const uint64_t b_lo = b_hi + (kBBytes >> 4);
      wgmma_fence();
#ifdef FVT_DIAG_COPIES_ONLY
      if (s == 0)
#endif
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // a tap's rows start (dy*W1 + dx) coordinates of 16 B further
        const int shift = (tap / 3) * W1 + tap % 3;
        const int b_tap = tap * (kTapBytes >> 4);
        // the small products first, into the sum of the slices before
        wgmma_tf32<BN>(acc, a_hi + shift, b_lo + b_tap,
                       kFresh ? tap > 0 : s > 0 || tap > 0);
        wgmma_tf32<BN>(acc, a_lo + shift, b_hi + b_tap, 1);
        wgmma_tf32<BN>(acc, a_hi + shift, b_hi + b_tap, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp has read it
      if constexpr (kFresh) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          sum[i] = s == 0 ? acc[i] : __fadd_rn(sum[i], acc[i]);
      }
    }

    // Thread (warp, lane) of a warpgroup holds rows 16*warp + lane/4 (+ 8)
    // and columns 8*j + 2*(lane % 4) (+ 1) of its sub-tile in acc[4*j +
    // 2*half (+ 1)]: one float2 a row and j, four lanes a 32-byte sector.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long q =
          q0 + W1 + 1 + wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
      if (q >= a.Q) continue;
      const long long f = q / frame;
      const int rem = (int)(q - f * frame);
      const int row = rem / W1, col = rem - row * W1;
      if (row == 0 || col == 0) continue;  // a pad coordinate
      const long long at = ((f * a.H + row - 1) * a.W + col - 1) * a.Co;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (n >= a.Co) continue;
        const int at_j = 4 * j + 2 * half;
        float2 out;
        if constexpr (kFresh)
          out = make_float2(sum[at_j], sum[at_j + 1]);
        else
          out = make_float2(acc[at_j], acc[at_j + 1]);
        if constexpr (kEpi == kPrelu) {
          const float2 al = __ldg(reinterpret_cast<const float2*>(a.alpha + n));
          out.x = out.x > 0.f ? out.x : __fmul_rn(al.x, out.x);
          out.y = out.y > 0.f ? out.y : __fmul_rn(al.y, out.y);
        } else if constexpr (kEpi == kBn2Residual) {
          const float2 m = __ldg(reinterpret_cast<const float2*>(a.a2 + n));
          const float2 b = __ldg(reinterpret_cast<const float2*>(a.b2 + n));
          const float2 r =
              __ldg(reinterpret_cast<const float2*>(a.res + at + n));
          out.x = __fadd_rn(affine(out.x, m.x, b.x), r.x);
          out.y = __fadd_rn(affine(out.y, m.y, b.y), r.y);
        }
        *reinterpret_cast<float2*>(a.y + at + n) = out;
      }
    }
  }
}

template <int BN, int S, Prologue kPro, Epilogue kEpi>
cudaError_t launch(ConvArgs a, const CUtensorMap& x_map, cudaStream_t stream) {
  constexpr int kThreads = 128 * kWG + 32;
  a.n_tiles = (a.Co + BN - 1) / BN;
  const size_t bytes = smem_bytes<BN>(a.P, S);
  const long long tiles = (a.Q - (a.W + 2) + kBM - 1) / kBM * a.n_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_blocks(conv3x3_tf32x3_kernel<BN, S, kPro, kEpi>, kThreads,
                        bytes, tiles, &blocks);
  if (err != cudaSuccess) return err;
  conv3x3_tf32x3_kernel<BN, S, kPro, kEpi>
      <<<blocks, kThreads, bytes, stream>>>(a, x_map);
  return cudaGetLastError();
}

// The deepest ring of 3, 2 or 1 slots that fits the shared memory.
template <int BN, Prologue kPro, Epilogue kEpi>
cudaError_t launch_ring(const ConvArgs& a, const CUtensorMap& x_map,
                        cudaStream_t stream) {
  // a lane of the producer warp for each load of a slice
  if (2 * (a.P / kLoad) > 32) return cudaErrorInvalidValue;
  if (smem_bytes<BN>(a.P, 3) <= (size_t)kMaxSmem)
    return launch<BN, 3, kPro, kEpi>(a, x_map, stream);
  if (smem_bytes<BN>(a.P, 2) <= (size_t)kMaxSmem)
    return launch<BN, 2, kPro, kEpi>(a, x_map, stream);
  if (smem_bytes<BN>(a.P, 1) <= (size_t)kMaxSmem)
    return launch<BN, 1, kPro, kEpi>(a, x_map, stream);
  return cudaErrorInvalidValue;
}

// The arguments of a conv of x (N, H, W, C) into y (N, H, W, Co), and
// cudaErrorInvalidValue for a shape or bn that no launch takes.
cudaError_t conv_args(const void* x, const void* w_hi, const void* w_lo,
                      void* y, int N, int H, int W, int C, int Co, int bn,
                      ConvArgs* a) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 4 || Co % 4 ||
      (bn != 64 && bn != 128))
    return cudaErrorInvalidValue;
  if ((long long)N * H * W > 2147483647LL) return cudaErrorInvalidValue;
  *a = ConvArgs{(const float*)x,
                (const float*)w_hi,
                (const float*)w_lo,
                (float*)y,
                N, H, W, C, Co,
                (kBM + 2 * (W + 1) + 2 + kLoad - 1) / kLoad * kLoad,
                (long long)N * (H + 1) * (W + 1),
                0, 0,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return cudaSuccess;
}

// One launch of the conv of a.x on `stream`, with its prologue and
// epilogue, at column tiles of BN.
template <int BN, Prologue kPro, Epilogue kEpi>
cudaError_t run(const ConvArgs& a, cudaStream_t stream) {
  CUtensorMap x_map;
  const cudaError_t err = make_x_map(a.x, a.N, a.H, a.W, a.C,
                                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 4,
                                     &x_map);
  if (err != cudaSuccess) return err;
  return launch_ring<BN, kPro, kEpi>(a, x_map, stream);
}

}  // namespace

extern "C" {

// y = conv3x3(x, w) on `stream`.  x (N, H, W, C) and y (N, H, W, Co) fp32,
// contiguous and 16-byte aligned; C and Co multiples of 4.  w_hi and w_lo
// hold the two TF32 parts of the weights w (9, C, Co), hi = tf32(w) and lo
// = tf32(w - hi), each packed for column tiles of bn = 64 or 128 output
// channels, fp32, contiguous:
//   wp[tile][slice][tap][chunk][n8][n][k] =
//       w[tap][8*slice + 4*chunk + k][bn*tile + 8*n8 + n]
// with tile < ceil(Co / bn), slice < ceil(C / 8), chunk < 2, n8 < bn/8,
// n < 8, k < 4, and 0 where the input channel is beyond C or the output
// channel beyond Co: per (tile, slice) the 9*8*bn values of a part one ring
// slot takes, K-major core matrices as wgmma reads them.  Returns
// cudaSuccess, the error of an attribute call or the launch, or
// cudaErrorInvalidValue for what the kernel does not take: another C, Co or
// bn, N*H*W beyond 2^31 - 1, or W beyond 894, where a tile's staged
// coordinates need more TMA loads than the producer warp has lanes (one
// staged slice then still fits the 227 KB of shared memory at either bn).
int fvt_conv3x3_tf32x3_forward(const void* x, const void* w_hi,
                               const void* w_lo, void* y, int N, int H, int W,
                               int C, int Co, int bn, void* stream) {
  ConvArgs a;
  const cudaError_t err =
      conv_args(x, w_hi, w_lo, y, N, H, W, C, Co, bn, &a);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bn == 64 ? run<64, kNoPrologue, kStore>(a, st)
                        : run<128, kNoPrologue, kStore>(a, st));
}

// The eval-mode identity BottleneckIR block of x on `stream`, as two
// launches of the conv (the header note):
//   stage 1, conv1:  v = prelu(conv3x3(a1*x + b1, w1), alpha), the affine
//                    zero outside the image;
//   stage 2, conv2:  y = (a2*conv3x3(v, w2) + b2) + x.
// `stages` 3 runs both; 1 or 2 one alone, for measurements.  x, the
// workspace v and y (N, H, W, C) fp32, contiguous and 16-byte aligned, C a
// multiple of 4; w1_hi, w1_lo and w2_hi, w2_lo the two convs' weights (9,
// C, C) split and packed as fvt_conv3x3_tf32x3_forward's for Co = C and
// column tiles of bn = 64, the only bn the block's launches take (the
// header note); a1, b1 (bn1's affine), alpha (PReLU's slopes), a2, b2
// (bn2's affine), each (C) fp32 and 16-byte aligned.  Returns cudaSuccess,
// the first error of a launch or an attribute call, or
// cudaErrorInvalidValue for what the conv does not take (the plain conv's
// shapes), another bn or a `stages` outside 1..3.
int fvt_bottleneck_tf32x3_forward(const void* x, const void* w1_hi,
                                  const void* w1_lo, const void* w2_hi,
                                  const void* w2_lo, const void* a1,
                                  const void* b1, const void* alpha,
                                  const void* a2, const void* b2, void* v,
                                  void* y, int N, int H, int W, int C, int bn,
                                  int stages, void* stream) {
  if (stages < 1 || stages > 3 || bn != 64) return (int)cudaErrorInvalidValue;
  ConvArgs c1, c2;
  cudaError_t err = conv_args(x, w1_hi, w1_lo, v, N, H, W, C, C, bn, &c1);
  if (err != cudaSuccess) return (int)err;
  err = conv_args(v, w2_hi, w2_lo, y, N, H, W, C, C, bn, &c2);
  if (err != cudaSuccess) return (int)err;
  if (2 * (c1.P / kLoad) > 32) return (int)cudaErrorInvalidValue;
  c1.a1 = (const float*)a1;
  c1.b1 = (const float*)b1;
  c1.alpha = (const float*)alpha;
  c2.a2 = (const float*)a2;
  c2.b2 = (const float*)b2;
  c2.res = (const float*)x;
  cudaStream_t st = (cudaStream_t)stream;
  if (stages & 1) {
    err = run<64, kBn1, kPrelu>(c1, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) err = run<64, kNoPrologue, kBn2Residual>(c2, st);
  return (int)err;
}

}  // extern "C"
