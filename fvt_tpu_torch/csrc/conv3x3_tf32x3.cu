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
// Three build switches split the time for tools/profile_conv_bf16.py
// --dtype float32, and give wrong sums: -DFVT_DIAG_PRODUCTS_ONLY starts no
// copy and waits for none, -DFVT_DIAG_COPIES_ONLY runs the wgmma of the
// first slice only, -DFVT_DIAG_NO_SPLIT leaves the staged x as it landed
// (no split, no named barrier).

#include "wgmma_common.cuh"

namespace {

constexpr int kKC = 8;   // input channels a slice (one k8 step)
constexpr int kWG = 4;   // consumer warpgroups a block, one sub-tile each

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
};

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
template <int BN, int S>
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
  float acc[BN / 2];  // first written by a tile's first wgmma
  unsigned it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long q0 = (long long)(tile / a.n_tiles) * kBM;
    const int n0 = (tile % a.n_tiles) * BN;
    for (int s = 0; s < slices; ++s, ++it) {
      const int slot = it % S;
      unsigned char* sa = ring + (size_t)slot * stage_bytes;
#ifndef FVT_DIAG_PRODUCTS_ONLY
      mbar_wait(full + 8 * slot, (it / S) & 1);  // the slice has landed
#endif
#ifndef FVT_DIAG_NO_SPLIT
      {
        // x = hi + lo, hi in place, lo into the slot's second A buffer; a
        // chunk beyond C (not loaded) becomes zeros
        float4* hi = reinterpret_cast<float4*>(sa);
        float4* lo = hi + 2 * P;
        const int real = s * kKC + 4 < a.C ? 2 * P : P;
        for (int i = tid; i < 2 * P; i += 128 * kWG) {
          const float4 v = i < real ? hi[i] : make_float4(0.f, 0.f, 0.f, 0.f);
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
        wgmma_tf32<BN>(acc, a_hi + shift, b_lo + b_tap, s > 0 || tap > 0);
        wgmma_tf32<BN>(acc, a_lo + shift, b_hi + b_tap, 1);
        wgmma_tf32<BN>(acc, a_hi + shift, b_hi + b_tap, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp has read it
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
      float* y = a.y + ((f * a.H + row - 1) * a.W + col - 1) * a.Co;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (n < a.Co)
          *reinterpret_cast<float2*>(y + n) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

template <int BN, int S>
cudaError_t launch(ConvArgs a, const CUtensorMap& x_map, cudaStream_t stream) {
  constexpr int kThreads = 128 * kWG + 32;
  a.n_tiles = (a.Co + BN - 1) / BN;
  const size_t bytes = smem_bytes<BN>(a.P, S);
  const long long tiles = (a.Q - (a.W + 2) + kBM - 1) / kBM * a.n_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(conv3x3_tf32x3_kernel<BN, S>,
                                            kThreads, bytes, tiles, &blocks);
  if (err != cudaSuccess) return err;
  conv3x3_tf32x3_kernel<BN, S><<<blocks, kThreads, bytes, stream>>>(a, x_map);
  return cudaGetLastError();
}

// The deepest ring of 3, 2 or 1 slots that fits the shared memory.
template <int BN>
cudaError_t launch_ring(const ConvArgs& a, const CUtensorMap& x_map,
                        cudaStream_t stream) {
  // a lane of the producer warp for each load of a slice
  if (2 * (a.P / kLoad) > 32) return cudaErrorInvalidValue;
  if (smem_bytes<BN>(a.P, 3) <= (size_t)kMaxSmem)
    return launch<BN, 3>(a, x_map, stream);
  if (smem_bytes<BN>(a.P, 2) <= (size_t)kMaxSmem)
    return launch<BN, 2>(a, x_map, stream);
  if (smem_bytes<BN>(a.P, 1) <= (size_t)kMaxSmem)
    return launch<BN, 1>(a, x_map, stream);
  return cudaErrorInvalidValue;
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
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 4 || Co % 4 ||
      (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W > 2147483647LL) return (int)cudaErrorInvalidValue;
  ConvArgs a{(const float*)x,
             (const float*)w_hi,
             (const float*)w_lo,
             (float*)y,
             N, H, W, C, Co,
             (kBM + 2 * (W + 1) + 2 + kLoad - 1) / kLoad * kLoad,
             (long long)N * (H + 1) * (W + 1),
             0, 0};
  CUtensorMap x_map;
  const cudaError_t err = make_x_map(x, N, H, W, C,
                                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 4,
                                     &x_map);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bn == 64 ? launch_ring<64>(a, x_map, st)
                        : launch_ring<128>(a, x_map, st));
}

}  // extern "C"
