// 3x3 stride-1 pad-1 convolution by Winograd F(2x2, 3x3), NHWC, fp32 in and
// out at fp32 accuracy, in three launches for Hopper (sm_90a): an input
// transform and an output transform on the CUDA cores, and between them one
// batched product on the warpgroup matrix multiply (wgmma) with split-TF32
// (3xTF32) products.
//
// Replaces fvt_tpu/ops/winograd.py::_winograd_kernel (the Pallas kernel
// behind conv3x3_winograd_pallas).  With U = G g G^T (16, C, Co) computed by
// the caller once per weight, for every 2x2 output tile p (P of them, over
// frames, tile rows and tile columns; odd H or W padded to whole tiles):
//
//   1. V[ab][p] = (B^T d B)[a][b] for the tile's 4x4 input patch d, x zero
//      outside the image: V (16, P, C) in device memory, adds only;
//   2. M[ab] = V[ab] @ U[ab] for the 16 positions ab: 16 independent
//      (P x C) @ (C x Co) products, M (16, P, Co) in device memory;
//   3. y = A^T M A per tile, cropped to (N, H, W, Co), adds only.
//
// What bounds it.  At the ArcFace shapes (N = 2400; 40x40x64 to 5x5x512) the
// products are 16 * 2*C*Co operations a tile where the direct conv takes
// 36, three times over for the split (below); at the TF32 peak (494.7
// TFLOP/s) they take 0.76 ms at a Cin = Cout = 64..512 conv.  V is 4x the
// input and M 4x the output, and each is written once and read once: about
// 18x the input's bytes at Cin = Cout, 5.3 ms at 40x40x64 at 3.35 TB/s,
// 1.3 ms at 10x10x256.  So the stages are bytes-bound where C is small and
// the products weigh most where C is large.  The design keeps each launch
// simple and leaves the fusion of the transforms into the product (V and M
// on chip) to later work.
//
// Launch 1 and 3: a thread takes one tile and 4 channels (float4, C or Co
// contiguous), so a warp reads and writes whole sectors.  The sums follow
// ops/winograd.py's plain version term for term (rows, then columns), so
// V and y's transform are that version's bits.
//
// Launch 2 is conv3x3_tf32x3.cu's kernel with one tap: a persistent block
// of four consumer warpgroups and one producer warp walks the tiles
// (position, 256 rows of P, BN output channels), a ring of slots between
// them with a `full` and an `empty` mbarrier each.  Per slice of 8 input
// channels the producer's lane 0 asks the copy engine for two boxes of 256
// rows x 4 channels of V (a 3-d tiled tensor map over (C, P, 16): rows
// beyond P come in as zeros; a chunk beyond C is not loaded and the
// consumers zero it), byte for byte the B4 kernel's staging of a chunk, and
// for the slice's packed U parts (hi and lo, one bulk copy each).  x is
// split where it lands: each warpgroup rewrites its own 64 rows as hi =
// tf32(v) in place and lo = tf32(v - hi) beside them, fences them to the
// async proxy and meets at a named barrier of its 128 threads only (a
// warpgroup reads no other's rows, as there is no tap shift here), then
// issues hi*lo, lo*hi, hi*hi into fp32 accumulators in its registers.  The
// dropped lo*lo and lo's own rounding are 2^-21 of a product.  M leaves from
// the registers as float2, four lanes a 32-byte sector.
//
// Four build switches split the product launch's time for
// tools/profile_conv_bf16.py --dtype winograd, and give wrong sums, as in
// conv3x3_tf32x3.cu: -DFVT_DIAG_PRODUCTS_ONLY starts no copy and waits for
// none, -DFVT_DIAG_COPIES_ONLY runs the wgmma of the first slice only,
// -DFVT_DIAG_NO_SPLIT leaves the staged V as it landed, and
// -DFVT_DIAG_NO_STORE keeps M in the registers (what writing M costs).

#include "wgmma_common.cuh"

namespace {

constexpr int kKC = 8;        // input channels a slice (one k8 step)
constexpr int kWG = 4;        // consumer warpgroups a block, 64 rows each
constexpr int kRing = 8;      // ring slots of the product kernel
constexpr int kTThreads = 256;  // threads a block of the transforms

struct WinogradArgs {
  const float* x;     // (N, H, W, C)
  const float* u_hi;  // packed: see fvt_winograd_tf32x3_forward
  const float* u_lo;
  float* v;           // (16, P, C)
  float* m;           // (16, P, Co)
  float* y;           // (N, H, W, Co)
  int N, H, W, C, Co;
  int th, tw;         // tiles a frame: ceil(H/2), ceil(W/2)
  int P;              // tiles in all: N * th * tw
  int r_tiles;        // row tiles of the product: ceil(P / kBM)
  int n_tiles;        // column tiles: ceil(Co / BN)
  int tiles;          // 16 * r_tiles * n_tiles
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] along one axis
__device__ __forceinline__ void bt4(const float4 (&d)[4], float4 (&t)[4]) {
  t[0] = sub4(d[0], d[2]);
  t[1] = add4(d[1], d[2]);
  t[2] = sub4(d[2], d[1]);
  t[3] = sub4(d[1], d[3]);
}

// Launch 1: V[4a + b][p][c .. c+3] for tile p, 4 channels a thread.
__global__ void __launch_bounds__(kTThreads)
    input_transform_kernel(WinogradArgs a) {
  const int c4s = a.C / 4;
  const long long i = (long long)blockIdx.x * kTThreads + threadIdx.x;
  if (i >= (long long)a.P * c4s) return;
  const int c = (int)(i % c4s) * 4;
  const int p = (int)(i / c4s);
  const int per = a.th * a.tw;
  const int f = p / per, r = p - f * per;
  const int y0 = 2 * (r / a.tw) - 1, x0 = 2 * (r % a.tw) - 1;
  const float* xf = a.x + (size_t)f * a.H * a.W * a.C + c;
  // rows first: t[b][k] = (B^T d)[k] of column b
  float4 t[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int gx = x0 + b;
    float4 d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int gy = y0 + k;
      d[k] = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W
                 ? *reinterpret_cast<const float4*>(
                       xf + ((size_t)gy * a.W + gx) * a.C)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    bt4(d, t[b]);
  }
  // then the columns of row k
  float* v = a.v + (size_t)p * a.C + c;
  const size_t plane = (size_t)a.P * a.C;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 row[4] = {t[0][k], t[1][k], t[2][k], t[3][k]};
    float4 out[4];
    bt4(row, out);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<float4*>(v + (4 * k + b) * plane) = out[b];
  }
}

// Launch 3: y of tile p, output channels co .. co+3 a thread.
// A^T = [[1,1,1,0],[0,1,-1,-1]]; over the rows first, then the columns.
__global__ void __launch_bounds__(kTThreads)
    output_transform_kernel(WinogradArgs a) {
  const int c4s = a.Co / 4;
  const long long i = (long long)blockIdx.x * kTThreads + threadIdx.x;
  if (i >= (long long)a.P * c4s) return;
  const int co = (int)(i % c4s) * 4;
  const int p = (int)(i / c4s);
  const float* m = a.m + (size_t)p * a.Co + co;
  const size_t plane = (size_t)a.P * a.Co;
  float4 ya[4][2];  // (A^T M)[i] of column b
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float4 mb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      mb[k] = *reinterpret_cast<const float4*>(m + (4 * k + b) * plane);
    ya[b][0] = add4(add4(mb[0], mb[1]), mb[2]);
    ya[b][1] = sub4(sub4(mb[1], mb[2]), mb[3]);
  }
  const int per = a.th * a.tw;
  const int f = p / per, r = p - f * per;
  const int oy = 2 * (r / a.tw), ox = 2 * (r % a.tw);
  float* yf = a.y + (size_t)f * a.H * a.W * a.Co + co;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (oy + k >= a.H) continue;
    float* row = yf + ((size_t)(oy + k) * a.W + ox) * a.Co;
    *reinterpret_cast<float4*>(row) =
        add4(add4(ya[0][k], ya[1][k]), ya[2][k]);
    if (ox + 1 < a.W)
      *reinterpret_cast<float4*>(row + a.Co) =
          sub4(sub4(ya[1][k], ya[2][k]), ya[3][k]);
  }
}

// A ring slot: V's hi and lo ([chunk][row][4 floats] each, 2*kBM*16
// bytes), then U's hi and lo (a slice, 8*BN*4 bytes each).
template <int BN>
__host__ __device__ constexpr int slot_bytes() {
  return 2 * (2 * kBM * 16) + 2 * (kKC * BN * 4);
}

template <int BN>
constexpr size_t smem_bytes() {
  return 128 + (size_t)kRing * slot_bytes<BN>();
}

// Launch 2: M[pos] = V[pos] @ U[pos].  A block is kWG consumer warpgroups
// and one producer warp and walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; tile = (pos * r_tiles + row tile) * n_tiles + column
// tile, so the blocks in flight share rows of V and slices of U.
template <int BN>
__global__ void __launch_bounds__(128 * kWG + 32, 1)
    product_kernel(WinogradArgs a, const __grid_constant__ CUtensorMap v_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kABytes = 2 * kBM * 16;  // one part of a slice's V
  constexpr int kBBytes = kKC * BN * 4;  // one part of a slice's U
  constexpr int kSlot = slot_bytes<BN>();
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
  const int slices = (a.C + kKC - 1) / kKC;

  if (tid >= 128 * kWG) {
    // The producer: lane 0 waits until the slot is empty, sets the bytes
    // to expect and starts the slice's copies, all counted on its `full`.
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    if (lane != 0) return;
    unsigned it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int n_tile = tile % a.n_tiles;
      const int rt = (tile / a.n_tiles) % a.r_tiles;
      const int pos = tile / (a.n_tiles * a.r_tiles);
      const size_t u_off =
          ((size_t)pos * a.n_tiles + n_tile) * slices * (kBBytes / 4);
      for (int s = 0; s < slices; ++s, ++it) {
        const int slot = it % kRing;
        const int chunks = s * kKC + 4 < a.C ? 2 : 1;
        mbar_wait(empty + 8 * slot, ((it / kRing) & 1) ^ 1);
        const uint32_t sa = smem_u32(ring + (size_t)slot * kSlot);
        const uint32_t bar = full + 8 * slot;
        mbar_expect_tx(bar, 2 * kBBytes + chunks * kBM * 16);
        const size_t u_slice = u_off + (size_t)s * (kBBytes / 4);
        bulk_copy(sa + 2 * kABytes, a.u_hi + u_slice, kBBytes, bar);
        bulk_copy(sa + 2 * kABytes + kBBytes, a.u_lo + u_slice, kBBytes,
                  bar);
        for (int ch = 0; ch < chunks; ++ch)
          tma_tile3d(sa + ch * kBM * 16, &v_map, s * kKC + 4 * ch, rt * kBM,
                     pos, bar);
      }
    }
    return;
  }

  // The consumers.  Warpgroup wg holds the sums of the tile's rows
  // 64 * wg + [0, 64) in registers.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, wtid = tid & 127;
  float acc[BN / 2];  // first written by a tile's first wgmma
  unsigned it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int n0 = (tile % a.n_tiles) * BN;
    const int rt = (tile / a.n_tiles) % a.r_tiles;
    const int pos = tile / (a.n_tiles * a.r_tiles);
    for (int s = 0; s < slices; ++s, ++it) {
      const int slot = it % kRing;
      unsigned char* sa = ring + (size_t)slot * kSlot;
#ifndef FVT_DIAG_PRODUCTS_ONLY
      mbar_wait(full + 8 * slot, (it / kRing) & 1);  // the slice has landed
#endif
#ifndef FVT_DIAG_NO_SPLIT
      {
        // v = hi + lo for this warpgroup's rows, one float4 of one chunk a
        // thread: hi in place, lo into the slot's second A buffer; a chunk
        // beyond C (not loaded) becomes zeros
        float4* hi = reinterpret_cast<float4*>(sa);
        float4* lo = hi + 2 * kBM;
        const int ch = wtid >> 6;
        const int i = ch * kBM + wg * 64 + (wtid & 63);
        const float4 v = ch == 0 || s * kKC + 4 < a.C
                             ? hi[i]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 h = make_float4(to_tf32(v.x), to_tf32(v.y),
                                     to_tf32(v.z), to_tf32(v.w));
        hi[i] = h;
        lo[i] = make_float4(to_tf32(v.x - h.x), to_tf32(v.y - h.y),
                            to_tf32(v.z - h.z), to_tf32(v.w - h.w));
        // the writes are seen by wgmma's async proxy, and all of the
        // warpgroup's before any of it reads them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
#endif
      const uint32_t sa_u32 = smem_u32(sa);
      const uint64_t a_hi = make_desc(sa_u32 + wg * 64 * 16, kBM * 16, 128);
      const uint64_t a_lo = a_hi + (kABytes >> 4);
      const uint64_t b_hi =
          make_desc(sa_u32 + 2 * kABytes, (BN / 8) * 128, 128);
      const uint64_t b_lo = b_hi + (kBBytes >> 4);
      wgmma_fence();
#ifdef FVT_DIAG_COPIES_ONLY
      if (s == 0)
#endif
      {
        // the small products first, into the sum of the slices before
        wgmma_tf32<BN>(acc, a_hi, b_lo, s > 0);
        wgmma_tf32<BN>(acc, a_lo, b_hi, 1);
        wgmma_tf32<BN>(acc, a_hi, b_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp has read it
    }

    // Thread (warp, lane) of a warpgroup holds rows 16*warp + lane/4 (+ 8)
    // and columns 8*j + 2*(lane % 4) (+ 1) of its sub-tile in acc[4*j +
    // 2*half (+ 1)]: one float2 a row and j, four lanes a 32-byte sector.
#ifdef FVT_DIAG_NO_STORE
    continue;
#endif
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row =
          rt * kBM + wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
      if (row >= a.P) continue;
      float* m = a.m + ((size_t)pos * a.P + row) * a.Co;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (n < a.Co)
          *reinterpret_cast<float2*>(m + n) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

template <int BN>
cudaError_t launch_product(WinogradArgs a, cudaStream_t stream) {
  constexpr int kThreads = 128 * kWG + 32;
  a.n_tiles = (a.Co + BN - 1) / BN;
  const long long tiles = 16LL * a.r_tiles * a.n_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  CUtensorMap v_map;
  // V (16, P, C): boxes of kBM rows by 4 channels of one position
  cudaError_t err = make_tile3d_map(a.v, 16, a.P, a.C, kBM, &v_map);
  if (err != cudaSuccess) return err;
  constexpr size_t bytes = smem_bytes<BN>();
  static_assert(bytes <= kMaxSmem, "the ring fits in shared memory");
  unsigned blocks = 0;
  err = persistent_blocks(product_kernel<BN>, kThreads, bytes, tiles,
                          &blocks);
  if (err != cudaSuccess) return err;
  product_kernel<BN><<<blocks, kThreads, bytes, stream>>>(a, v_map);
  return cudaGetLastError();
}

cudaError_t launch_transform(void (*kernel)(WinogradArgs),
                             const WinogradArgs& a, int channels,
                             cudaStream_t stream) {
  const long long threads = (long long)a.P * (channels / 4);
  const long long blocks = (threads + kTThreads - 1) / kTThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kTThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = conv3x3(x, g) by Winograd on `stream`, from the split parts of u = G
// g G^T (16, C, Co).  The launches of `stages` run, in order: 1 the input
// transform x -> v, 2 the product v -> m, 4 the output transform m -> y (7
// all three; one alone is for measurements).  x (N, H, W, C), v (16, P, C),
// m (16, P, Co) and y (N, H, W, Co) fp32, contiguous and 16-byte aligned,
// with P = N * ceil(H/2) * ceil(W/2); C and Co multiples of 4.  u_hi and
// u_lo hold the two TF32 parts of u, hi = tf32(u) and lo = tf32(u - hi),
// each packed for column tiles of bn = 64 or 128 output channels:
//   up[pos][tile][slice][chunk][n8][n][k] =
//       u[pos][8*slice + 4*chunk + k][bn*tile + 8*n8 + n]
// with pos < 16, tile < ceil(Co / bn), slice < ceil(C / 8), chunk < 2,
// n8 < bn/8, n < 8, k < 4, and 0 where the input channel is beyond C or
// the output channel beyond Co.  Returns cudaSuccess, the error of the
// first launch or attribute call that failed, or cudaErrorInvalidValue for
// what the kernels do not take: another C, Co, bn or stages, or P beyond
// 2^31 - 1.
int fvt_winograd_tf32x3_forward(const void* x, const void* u_hi,
                                const void* u_lo, void* v, void* m, void* y,
                                int N, int H, int W, int C, int Co, int bn,
                                int stages, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 4 || Co % 4 ||
      (bn != 64 && bn != 128) || stages <= 0 || stages > 7)
    return (int)cudaErrorInvalidValue;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const long long P = (long long)N * th * tw;
  if (P > 2147483647LL) return (int)cudaErrorInvalidValue;
  WinogradArgs a{(const float*)x,
                 (const float*)u_hi,
                 (const float*)u_lo,
                 (float*)v,
                 (float*)m,
                 (float*)y,
                 N, H, W, C, Co,
                 th, tw, (int)P,
                 (int)((P + kBM - 1) / kBM),
                 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    err = launch_transform(input_transform_kernel, a, C, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    err = bn == 64 ? launch_product<64>(a, st) : launch_product<128>(a, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 4) err = launch_transform(output_transform_kernel, a, Co, st);
  return (int)err;
}

}  // extern "C"
