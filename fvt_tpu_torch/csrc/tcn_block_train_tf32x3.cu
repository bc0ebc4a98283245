// Fused train-mode TemporalBlock, forward and backward, fp32 in and out at
// fp32 accuracy, for Hopper (sm_90a): every product on the warpgroup matrix
// multiply (wgmma) with split-TF32 (3xTF32) products.
//
// Replaces fvt_tpu/ops/tcn_pallas.py::_block_train_kernel (forward) and
// ::_block_bwd_kernel (backward), the Pallas kernels behind
// fused_temporal_block_train.  With causal dilated convolutions (left pad
// pad = (K-1)*d, zeros), dropout masks m1/m2 pre-scaled to {0, 1/(1-p)}
// and the residual stream `res` computed by the caller:
//
//     a1 = conv1(x) + b1        h   = leaky(a1) * m1
//     a2 = conv2(h) + b2        net = leaky(a2) * m2
//     out = leaky(net + res)
//
// and, for the cotangent g of out (leaky'(z) = 1 for z >= 0, else 0.01):
//
//     gz   = g * leaky'(net + res)            dres = gz
//     d_a2 = gz * m2 * leaky'(a2)
//     d_h[s]  = sum_k d_a2[s + pad - k*d] . w2[k]^T     (0 beyond T-1)
//     d_a1 = d_h * m1 * leaky'(a1)
//     dx[s]   = sum_k d_a1[s + pad - k*d] . w1[k]^T
//     dw2[k]  = sum_{b,t} h[t - pad + k*d]^T d_a2[t]    (h = 0 before 0)
//     dw1[k]  = sum_{b,t} x[t - pad + k*d]^T d_a1[t]
//     db2 = sum_{b,t} d_a2[t]                 db1 = sum_{b,t} d_a1[t]
//
// The CUDA-core kernels of tcn_block_train.cu compute the same and stay
// beside these for measurements only.
//
// What bounds it.  At the main path's shapes (the 8 blocks of vggish+bert,
// B = 16 windows of T = 300 frames, Cin up to 768, Cout up to 256, K = 5)
// the forward is 2*B*T*K*(Cin + Cout)*Cout operations, 24.0 GFLOP over
// the 8 blocks, and the backward twice that, against tens of MB of
// activations: the operations bound it.  Three TF32 products a multiply
// at the TF32 peak (494.7 TFLOP/s): 0.146 ms forward, 0.292 ms backward
// (0.232 with block 0's dx skipped, which nothing needs).
//
// The design.
// - The four convs are launches of the split-TF32 conv of
//   tcn_conv_tf32x3.cuh (read its header note): conv1 stores a1 and h =
//   leaky(a1)*m1 (one more (B, T, Cout) write, so that conv2 stages h as
//   the eval block's conv2 does, by TMA, and the backward reads h for
//   dw2 as it lies; applying leaky and m1 in conv2's split would need m1
//   staged beside a1); conv2 stores a2 and out; the backward runs the
//   same kernel anti-causally (tap k reads frame s + k*d, the box starts
//   at the tile and runs (K-1)*d frames past it, the copy engine's zero
//   fill at T or later is the pad) on the transposed weights, taps in
//   reverse order: d_h into d_a1 = d_h*m1*leaky'(a1) in its store, then
//   d_a1 into dx.  Taps in groups where the eval kernel takes them so.
// - The weights change every step (weight norm), so they cannot be kept
//   packed: one launch a direction (pack_kernel) splits and packs w1 and
//   w2 from their plain layout into a workspace, forward (w[k]) before
//   conv1 and transposed (w[K-1-k]^T) before the backward's convs.
// - The weight gradients (wgrad_kernel) are the one product the conv
//   kernel cannot take: they reduce over frames, and tf32 wgmma reads both
//   operands K-major from shared memory, while act and d_a land frame-
//   major.  A block owns one (tap, 64 act channels x 64 gradient channels)
//   tile of a batch share and walks its frames kWR = 32 at a time: the
//   producer warp loads a box of act from frame t - (K-1-k)*d (the tap's
//   shift, so no tap needs a shifted operand in shared memory; the copy
//   engine fills frames before 0 with zeros) and a box of d_a from frame
//   t, both 64 channels wide; the consumer warpgroup splits them into
//   hi and lo while writing them transposed ([4 frames][64 channels][4])
//   into one of two operand buffers, hands the ring slot back and issues
//   the slice's 4 x 3 products into a fresh accumulator, which joins the
//   tile's fp32 sum after the slice (4800 frames in one accumulator would
//   lose more than the 1e-4 gate allows).  Frames whose act rows all lie
//   in the causal pad are not walked.  Where the tiles alone would leave
//   SMs idle the batch is cut into S shares, whose partial tiles
//   reduce_shares_kernel adds in share order.
// - gz, d_a2 and dres are one elementwise pass; db1 and db2 column sums
//   with a fixed tree, one launch for both.
// - No float atomics anywhere: two runs give the same bits.
//
// Three build switches split the weight gradients' time for
// tools/profile_train.py --diag, and give wrong sums:
// -DFVT_DIAG_PRODUCTS_ONLY starts no copy and waits for none,
// -DFVT_DIAG_COPIES_ONLY runs the wgmma of a tile's first slice only,
// -DFVT_DIAG_NO_SPLIT leaves the operand buffers unwritten (the conv
// kernels of tcn_conv_tf32x3.cuh take the same switches).

#include "tcn_conv_tf32x3.cuh"

namespace {

constexpr int kEltThreads = 256;  // elementwise and reduction kernels
constexpr int kWR = 32;           // frames a weight-gradient slice
constexpr int kWT = 64;           // weight-gradient tile, both ways
constexpr int kWRing = 3;         // its ring slots
// a ring slot: act and d_a as they land, kWR x kWT floats each
constexpr int kWSlot = 2 * kWR * kWT * 4;
// an operand buffer: A (act) and B (d_a), hi and lo, kWR x kWT each
constexpr int kWOperand = 4 * kWR * kWT * 4;
constexpr int kWSmem = 128 + kWRing * kWSlot + 2 * kWOperand;
static_assert(kWSmem <= kHalfSmem, "two weight-gradient blocks an SM");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// ---------------------------------------------------------- weight packing
// One weight split and packed as the conv kernel reads it (tcn_conv's
// header note; ops/tcn.py::pack_train_weights):
//   hi/lo[tile][slice][tap][chunk][n8][n][k] = split(W_tap[c][o]),
//   c = 8*slice + 4*chunk + k < C, o = 64*tile + 8*n8 + n < Co, tap < K,
// 0 elsewhere, with W_tap = w[tap] of w (K, C, Co) for the forward and
// W_tap = w[K-1-tap]^T of w (K, Co, C) for the anti-causal conv.
struct PackJob {
  const float* w;
  float* hi;
  float* lo;
  int K, C, Co, taps, transposed;
  long long n;  // floats a part
};

// A thread writes the 4 input channels k of one output (n8, n), 16 bytes
// of each part; consecutive threads take consecutive outputs, so that the
// forward's loads (w[tap][c][o], o contiguous) read whole rows.
__global__ void __launch_bounds__(kEltThreads)
    pack_kernel(PackJob j0, PackJob j1) {
  const PackJob& j = blockIdx.y ? j1 : j0;
  const int slices = (j.C + kKC - 1) / kKC;
  for (long long i = (long long)blockIdx.x * kEltThreads + threadIdx.x;
       i < j.n / 4; i += (long long)gridDim.x * kEltThreads) {
    const int o = kBN * (int)(i / (2 * kBN * j.taps * slices)) +
                  (int)(i % kBN);
    long long r = i / kBN;
    const int chunk = r % 2;
    r /= 2;
    const int tap = r % j.taps;
    const int c = kKC * (int)(r / j.taps % slices) + 4 * chunk;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < j.C && o < j.Co && tap < j.K) {  // C % 4 == 0: c + 3 < C
      if (j.transposed) {
        v = ld4(j.w + ((size_t)(j.K - 1 - tap) * j.Co + o) * j.C + c);
      } else {
        const float* w = j.w + ((size_t)tap * j.C + c) * j.Co + o;
        v = make_float4(w[0], w[j.Co], w[2 * j.Co], w[3 * j.Co]);
      }
    }
    const float4 hi = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z),
                                  to_tf32(v.w));
    st4(j.hi + 4 * i, hi);
    st4(j.lo + 4 * i, make_float4(to_tf32(v.x - hi.x), to_tf32(v.y - hi.y),
                                  to_tf32(v.z - hi.z), to_tf32(v.w - hi.w)));
  }
}

// The packing of w for the conv of C inputs and Co outputs at (K, dil)
PackJob pack_job(const void* w, void* hi, void* lo, int K, int dil, int C,
                 int Co, bool transposed) {
  int G = 0, groups = 0;
  tap_groups(K, dil, &G, &groups);
  const long long n = (long long)((Co + kBN - 1) / kBN) *
                      ((C + kKC - 1) / kKC) * G * groups * kKC * kBN;
  return PackJob{(const float*)w, (float*)hi, (float*)lo, K, C, Co,
                 G * groups, transposed ? 1 : 0, n};
}

cudaError_t run_pack(const PackJob& j0, const PackJob& j1,
                     cudaStream_t stream) {
  const long long most = (j0.n > j1.n ? j0.n : j1.n) / 4;
  long long blocks = (most + kEltThreads - 1) / kEltThreads;
  if (blocks > 4096) blocks = 4096;  // a grid-stride loop takes the rest
  pack_kernel<<<dim3((unsigned)blocks, 2), kEltThreads, 0, stream>>>(j0,
                                                                     j1);
  return cudaGetLastError();
}

// ------------------------------------------------------- elementwise pass
// gz = g * leaky'(leaky(a2)*m2 + res) -> dres;  d_a2 = gz * m2 * leaky'(a2)
__global__ void __launch_bounds__(kEltThreads)
    out_grad_kernel(const float* g, const float* a2, const float* m2,
                    const float* res, float* dres, float* d_a2, size_t n4) {
  const size_t i = (size_t)blockIdx.x * kEltThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 gv = ld4(g + 4 * i), av = ld4(a2 + 4 * i);
  const float4 mv = ld4(m2 + 4 * i), rv = ld4(res + 4 * i);
  const float4 gz = make_float4(
      gv.x * dleaky(leaky(av.x) * mv.x + rv.x),
      gv.y * dleaky(leaky(av.y) * mv.y + rv.y),
      gv.z * dleaky(leaky(av.z) * mv.z + rv.z),
      gv.w * dleaky(leaky(av.w) * mv.w + rv.w));
  st4(dres + 4 * i, gz);
  st4(d_a2 + 4 * i,
      make_float4(gz.x * mv.x * dleaky(av.x), gz.y * mv.y * dleaky(av.y),
                  gz.z * mv.z * dleaky(av.z), gz.w * mv.w * dleaky(av.w)));
}

// ------------------------------------------------------ weight gradients
struct WgradArgs {
  float* out;  // (S, K, Ca, Cd) shares, or (K, Ca, Cd) when S == 1
  int B, T, Ca, Cd, K, dil, S;
  int ca_tiles, cd_tiles;
};

// The frames a share walks for tap k: from the first slice whose act rows
// (frame t - shift) are not all in the causal pad
__device__ __forceinline__ int first_frame(int shift) {
  return shift / kWR * kWR;
}

__global__ void __launch_bounds__(kThreads, 2)
    wgrad_kernel(WgradArgs a, const __grid_constant__ CUtensorMap act_map,
                 const __grid_constant__ CUtensorMap d_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t full = smem_u32(smem), empty = full + 64;
  unsigned char* ring = smem + 128;
  unsigned char* operands = ring + kWRing * kWSlot;
  if (tid == 0) {
    for (int i = 0; i < kWRing; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the block's tile: share s, tap k, act channels ca0.., gradient cd0..
  int rest = blockIdx.x;
  const int cd0 = rest % a.cd_tiles * kWT;
  rest /= a.cd_tiles;
  const int ca0 = rest % a.ca_tiles * kWT;
  rest /= a.ca_tiles;
  const int k = rest % a.K;
  const int s = rest / a.K;
  const int b_lo = (int)((long long)a.B * s / a.S);
  const int b_hi = (int)((long long)a.B * (s + 1) / a.S);
  const int shift = (a.K - 1 - k) * a.dil;
  const int t_first = first_frame(shift);
  const int per_row = t_first < a.T ? (a.T - t_first + kWR - 1) / kWR : 0;
  const int steps = (b_hi - b_lo) * per_row;

  if (__shfl_sync(0xffffffffu, tid >> 7, 0) == 1) {
    // The producer: lane 0 loads each slice's act and d_a boxes into the
    // next free slot, both counted on its `full` barrier.
#ifdef FVT_DIAG_PRODUCTS_ONLY
    return;
#endif
    if (lane != 0) return;
    for (int j = 0; j < steps; ++j) {
      const int slot = j % kWRing;
      const int b = b_lo + j / per_row;
      const int t0 = t_first + (j % per_row) * kWR;
      mbar_wait(empty + 8 * slot, ((j / kWRing) & 1) ^ 1);
      const uint32_t sa = smem_u32(ring + (size_t)slot * kWSlot);
      const uint32_t bar = full + 8 * slot;
      mbar_expect_tx(bar, kWSlot);
      tma_tile3d(sa, &act_map, ca0, t0 - shift, b, bar);
      tma_tile3d(sa + kWSlot / 2, &d_map, cd0, t0, b, bar);
    }
    return;
  }

  // The consumer warpgroup.  Warp w splits the 4-frame groups 2w and 2w + 1
  // of both boxes, lane l channels l and l + 32, and writes them
  // transposed into the operand buffer: [4 frames][64 channels][4 frames'
  // values], the K-major core matrices wgmma reads (8 channels x 4 frames,
  // 16 bytes a channel), hi in one part and lo in the next.  A warp's
  // loads read 32 consecutive floats of a frame, and each phase of its
  // 16-byte stores 8 consecutive channels: no bank conflict either way.
  const int warp = tid >> 5;
  float acc0[kWT / 2], acc1[kWT / 2], sum[kWT / 2];
#pragma unroll
  for (int i = 0; i < kWT / 2; ++i) sum[i] = 0.f;
  constexpr int kPart = kWR * kWT * 4;  // bytes of one part of an operand

  auto issue = [&](int j, float(&d)[kWT / 2]) {
    const int slot = j % kWRing;
#ifndef FVT_DIAG_PRODUCTS_ONLY
    mbar_wait_uniform(full + 8 * slot, (j / kWRing) & 1);
#endif
    const float* raw = reinterpret_cast<const float*>(ring + (size_t)slot *
                                                      kWSlot);
    const uint32_t op = smem_u32(operands + (size_t)(j & 1) * kWOperand);
#ifndef FVT_DIAG_NO_SPLIT
#pragma unroll
    for (int which = 0; which < 2; ++which) {  // act -> A, d_a -> B
      const float* box = raw + which * kWR * kWT;
      const uint32_t hi = op + which * 2 * kPart, lo = hi + kPart;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kg = 2 * warp + (q >> 1), ch = lane + 32 * (q & 1);
        const float* v = box + 4 * kg * kWT + ch;
        const float4 col = make_float4(v[0], v[kWT], v[2 * kWT], v[3 * kWT]);
        const float4 h = make_float4(to_tf32(col.x), to_tf32(col.y),
                                     to_tf32(col.z), to_tf32(col.w));
        const uint32_t at = (kg * kWT + ch) * 16;
        st_shared_if(true, hi + at, h);
        st_shared_if(true, lo + at,
                     make_float4(to_tf32(col.x - h.x), to_tf32(col.y - h.y),
                                 to_tf32(col.z - h.z), to_tf32(col.w - h.w)));
      }
    }
#endif
    // the raw slot is read: back to the producer once the whole
    // warpgroup's writes are visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    mbar_arrive_if(lane == 0, empty + 8 * slot);
    const uint64_t a_hi = make_desc(op, kWT * 16, 128);
    const uint64_t a_lo = a_hi + (kPart >> 4);
    const uint64_t b_hi = a_hi + (2 * kPart >> 4);
    const uint64_t b_lo = a_hi + (3 * kPart >> 4);
    wgmma_fence();
#ifdef FVT_DIAG_COPIES_ONLY
    if (j == 0)
#endif
#pragma unroll
    for (int ks = 0; ks < kWR / 8; ++ks) {
      // a k8 step spans two 4-frame groups of kWT*16 bytes each
      const int step = ks * (2 * kWT * 16 >> 4);
      wgmma_tf32<kWT>(d, a_hi + step, b_lo + step, ks > 0);
      wgmma_tf32<kWT>(d, a_lo + step, b_hi + step, 1);
      wgmma_tf32<kWT>(d, a_hi + step, b_hi + step, 1);
    }
    wgmma_commit();
  };
  auto retire = [&](const float(&d)[kWT / 2]) {
#pragma unroll
    for (int i = 0; i < kWT / 2; ++i) sum[i] = __fadd_rn(sum[i], d[i]);
  };

  if (steps > 0) issue(0, acc0);
  for (int j = 0; j < steps; j += 2) {
    if (j + 1 < steps) {
      issue(j + 1, acc1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    retire(acc0);
    if (j + 1 == steps) break;
    if (j + 2 < steps) {
      issue(j + 2, acc0);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    retire(acc1);
  }

  // Thread (warp, lane) holds act channels 16*warp + lane/4 (+ 8) and
  // gradient channels 8*j + 2*(lane % 4) (+ 1) in sum[4*j + 2*half (+ 1)]
  float* out = a.out + ((size_t)s * a.K + k) * a.Ca * a.Cd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ca = ca0 + warp * 16 + (lane >> 2) + 8 * half;
    if (ca >= a.Ca) continue;
#pragma unroll
    for (int j = 0; j < kWT / 8; ++j) {
      const int cd = cd0 + 8 * j + 2 * (lane & 3);
      if (cd >= a.Cd) continue;  // Cd is even: cd + 1 < Cd too
      *reinterpret_cast<float2*>(out + (size_t)ca * a.Cd + cd) =
          make_float2(sum[4 * j + 2 * half], sum[4 * j + 2 * half + 1]);
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in share order
__global__ void __launch_bounds__(kEltThreads)
    reduce_shares_kernel(const float* part, float* out, size_t n4, int S) {
  const size_t i = (size_t)blockIdx.x * kEltThreads + threadIdx.x;
  if (i >= n4) return;
  float4 sum = ld4(part + 4 * i);
  for (int s = 1; s < S; ++s) {
    const float4 v = ld4(part + 4 * (s * n4 + i));
    sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
  }
  st4(out + 4 * i, sum);
}

// dw (K, Ca, Cd) from act (B, T, Ca) and d (B, T, Cd) in S batch shares
cudaError_t run_wgrad(const float* act, const float* d, float* part,
                      float* dw, int B, int T, int Ca, int Cd, int K, int dil,
                      int S, cudaStream_t stream) {
  if (S < 1 || S > B || (S > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap act_map, d_map;
  cudaError_t err = make_tile3d_map(act, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                    B, T, Ca, kWT, kWR, &act_map);
  if (err != cudaSuccess) return err;
  err = make_tile3d_map(d, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, T, Cd, kWT,
                        kWR, &d_map);
  if (err != cudaSuccess) return err;
  static int set_device = -1;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device != set_device) {
    err = cudaFuncSetAttribute(wgrad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWSmem);
    if (err != cudaSuccess) return err;
    set_device = device;
  }
  const WgradArgs w{S > 1 ? part : dw, B, T, Ca, Cd, K, dil, S,
                    (Ca + kWT - 1) / kWT, (Cd + kWT - 1) / kWT};
  const long long blocks = (long long)S * K * w.ca_tiles * w.cd_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  wgrad_kernel<<<(unsigned)blocks, kThreads, kWSmem, stream>>>(w, act_map,
                                                               d_map);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const size_t n4 = (size_t)K * Ca * Cd / 4;
  reduce_shares_kernel<<<(unsigned)((n4 + kEltThreads - 1) / kEltThreads),
                         kEltThreads, 0, stream>>>(part, dw, n4, S);
  return cudaGetLastError();
}

// db[c] = sum_r d[r][c] for d_a2 -> db2 (blockIdx.y 0) and d_a1 -> db1
// (1): 32 columns a block, 32 lanes of rows a column, the lanes' sums
// added in lane order
__global__ void __launch_bounds__(1024)
    column_sums_kernel(const float* d0, float* out0, const float* d1,
                       float* out1, int rows, int C) {
  __shared__ float part[32][33];
  const float* d = blockIdx.y ? d1 : d0;
  float* out = blockIdx.y ? out1 : out0;
  const int cx = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + cx;
  float sum = 0.f;
  if (col < C)
    for (int r = lane; r < rows; r += 32) sum += d[(size_t)r * C + col];
  part[lane][cx] = sum;
  __syncthreads();
  if (lane == 0 && col < C) {
    float total = 0.f;
    for (int l = 0; l < 32; ++l) total += part[l][cx];
    out[col] = total;
  }
}

bool bad_shape(int B, int T, int Cin, int Cout, int K, int dil) {
  return B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || dil <= 0 ||
         Cin % 4 || Cout % 4 || (long long)(K - 1) * dil >= (1LL << 30) ||
         (long long)B * T > 2147483647LL / (Cin > Cout ? Cin : Cout);
}

}  // namespace

extern "C" {

// Forward of the train-mode block on `stream`, as up to three launches:
//   stage 1: w1, w2 split and packed into w1_hi/lo, w2_hi/lo (pack_kernel)
//   stage 2: conv1, a1 = conv1(x) + b1 and h = leaky(a1) * m1
//   stage 4: conv2, a2 = conv2(h) + b2 and out = leaky(leaky(a2)*m2 + res)
// `stages` 7 runs all; fewer bits run those alone, for measurements.  x
// (B, T, Cin); w1 (K, Cin, Cout); w2 (K, Cout, Cout); b1, b2 (Cout); m1,
// m2, res, a1, h, a2, out (B, T, Cout); all fp32, contiguous, 16-byte
// aligned; Cin and Cout multiples of 4.  The packed parts are workspaces
// of tiles x slices x G*groups x 512 floats each (tiles = ceil(Cout/64),
// slices = ceil(Cin/8) for w1 and ceil(Cout/8) for w2, tap_groups(K,
// dil)).  Returns cudaSuccess, the first error of a launch or an attribute
// call, or cudaErrorInvalidValue for a shape the kernels do not take.
int fvt_tcn_block_train_tf32x3_forward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* m1, const void* m2, const void* res,
    void* w1_hi, void* w1_lo, void* w2_hi, void* w2_lo, void* a1, void* h,
    void* a2, void* out, int B, int T, int Cin, int Cout, int K, int dil,
    int stages, void* stream) {
  if (bad_shape(B, T, Cin, Cout, K, dil) || stages < 1 || stages > 7)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (stages & 1)
    err = run_pack(pack_job(w1, w1_hi, w1_lo, K, dil, Cin, Cout, false),
                   pack_job(w2, w2_hi, w2_lo, K, dil, Cout, Cout, false), st);
  if (err == cudaSuccess && (stages & 2)) {
    ConvArgs c1 = conv_args(x, w1_hi, w1_lo, b1, nullptr, a1, B, T, Cin,
                            Cout, K, dil);
    c1.mask = (const float*)m1;
    c1.y2 = (float*)h;
    err = run_taps<kPreAct>(c1, st);
  }
  if (err == cudaSuccess && (stages & 4)) {
    ConvArgs c2 = conv_args(h, w2_hi, w2_lo, b2, res, a2, B, T, Cout, Cout,
                            K, dil);
    c2.mask = (const float*)m2;
    c2.y2 = (float*)out;
    err = run_taps<kTrainOut>(c2, st);
  }
  return (int)err;
}

// Backward of the block for the cotangent g (B, T, Cout) of out, from the
// forward's x, w1, w2, m1, m2, res and saved a1, h, a2, as up to eight
// launches:
//   stage 1:  dres = gz, d_a2 (out_grad_kernel)
//   stage 2:  w1, w2 split, transposed and packed into w1t_*, w2t_*
//   stage 4:  d_a1 = (d_a2 through conv2, anti-causally) * m1 * leaky'(a1)
//   stage 8:  dx = d_a1 through conv1, anti-causally (not with dx null)
//   stage 16: dw2 from h and d_a2 (and the shares' sum with S2 > 1)
//   stage 32: dw1 from x and d_a1 (and the shares' sum with S1 > 1)
//   stage 64: db2, db1 (one launch)
// `stages` 127 runs all.  Writes dx (B, T, Cin), dw1 (K, Cin, Cout), db1
// (Cout), dw2 (K, Cout, Cout), db2 (Cout), dres (B, T, Cout).  d_a2 and
// d_a1 are scratch of (B, T, Cout); the packed parts workspaces of tiles x
// slices x G*groups x 512 floats (w1t: tiles = ceil(Cin/64), slices =
// ceil(Cout/8); w2t: both of Cout); part1 / part2 scratch of (S1, K, Cin,
// Cout) / (S2, K, Cout, Cout) floats for the weight gradients' batch
// shares, null where the share count is 1.  1 <= S <= B.
int fvt_tcn_block_train_tf32x3_backward(
    const void* x, const void* w1, const void* w2, const void* m1,
    const void* m2, const void* res, const void* a1, const void* h,
    const void* a2, const void* g, void* d_a2, void* d_a1, void* w1t_hi,
    void* w1t_lo, void* w2t_hi, void* w2t_lo, void* part1, void* part2,
    void* dx, void* dw1, void* db1, void* dw2, void* db2, void* dres, int B,
    int T, int Cin, int Cout, int K, int dil, int S1, int S2, int stages,
    void* stream) {
  if (bad_shape(B, T, Cin, Cout, K, dil) || stages < 1 || stages > 127)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    const size_t n4 = (size_t)B * T * Cout / 4;
    out_grad_kernel<<<(unsigned)((n4 + kEltThreads - 1) / kEltThreads),
                      kEltThreads, 0, st>>>(
        (const float*)g, (const float*)a2, (const float*)m2,
        (const float*)res, (float*)dres, (float*)d_a2, n4);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && (stages & 2))
    err = run_pack(pack_job(w1, w1t_hi, w1t_lo, K, dil, Cout, Cin, true),
                   pack_job(w2, w2t_hi, w2t_lo, K, dil, Cout, Cout, true),
                   st);
  if (err == cudaSuccess && (stages & 4)) {
    ConvArgs ch = conv_args(d_a2, w2t_hi, w2t_lo, nullptr, nullptr, d_a1, B,
                            T, Cout, Cout, K, dil, false);
    ch.mask = (const float*)m1;
    ch.pre = (const float*)a1;
    err = run_taps<kMaskGrad>(ch, st);
  }
  if (err == cudaSuccess && (stages & 8) && dx != nullptr)
    err = run_taps<kPlain>(conv_args(d_a1, w1t_hi, w1t_lo, nullptr, nullptr,
                                     dx, B, T, Cout, Cin, K, dil, false),
                           st);
  if (err == cudaSuccess && (stages & 16))
    err = run_wgrad((const float*)h, (const float*)d_a2, (float*)part2,
                    (float*)dw2, B, T, Cout, Cout, K, dil, S2, st);
  if (err == cudaSuccess && (stages & 32))
    err = run_wgrad((const float*)x, (const float*)d_a1, (float*)part1,
                    (float*)dw1, B, T, Cin, Cout, K, dil, S1, st);
  if (err == cudaSuccess && (stages & 64)) {
    column_sums_kernel<<<dim3((unsigned)((Cout + 31) / 32), 2), 1024, 0,
                         st>>>((const float*)d_a2, (float*)db2,
                               (const float*)d_a1, (float*)db1, B * T, Cout);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
