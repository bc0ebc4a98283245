// 3x3 stride-1 pad-1 convolution by Winograd F(2x2, 3x3), NHWC, fp32, for
// Hopper (sm_90a).
//
// Replaces fvt_tpu/ops/winograd.py::_winograd_kernel (the Pallas kernel
// behind conv3x3_winograd_pallas).  With U = G g G^T (16, C, Co) computed by
// the caller once per weight, for every 2x2 tile of the output:
//
//     d    = the 4x4 input patch of the tile (x zero outside the image)
//     V    = B^T d B                        (16 values a channel, adds only)
//     M_ab = sum_c V_ab[c] * U_ab[c, :]     (16 products, a, b in 0..3)
//     Y    = A^T M A                        (the 2x2 outputs, adds only)
//
// so a tile costs 16 multiply-adds per (c, co) pair where the direct conv
// costs 36.  V and M never reach device memory.
//
// What was chosen, and what bounds it.  The TPU version pads x, splits it
// into four even/odd phases packed on the channel axis and de-interleaves
// the output afterwards, all in device memory, because its compiler cannot
// take stride-2 slices; and it folds A^T M A into four accumulators as it
// goes, which costs 36 multiply-adds a tile again once the products are
// scalar FMAs.  Here each thread computes its tiles' addresses itself, reads
// the 4x4 patches straight from NHWC x with a bounds mask, and the odd
// bottom row and right column of an odd image are a store mask.  To keep
// Winograd's count the 16 sums M_ab of a tile are held until all input
// channels are added up; that is 16 fp32 registers per tile and output
// channel, and it bounds the tile a block can take: 32 tiles (128 output
// pixels, taken in order over (n, tile row, tile column), so no block is
// ragged but the last) by 32 output channels, 64 sums a thread.  A thread
// owns one (a, b), 8 tiles and 8 output channels: per four input channels
// it reads 8 float4 of V and 8 float4 of U from shared memory for 256 FMAs.
// The input channels stream through shared memory 16 at a time: a thread
// loads and transforms one tile's patch for 4 channels and one half of the
// rows of V (a = 0, 1 or a = 2, 3), and all stage the 16 (16, 32) slices of
// U.  At the end M goes through shared memory once and each thread applies
// A^T M A to one tile's 4 output channels.
//
// At the ArcFace shapes (N = 2400; 40x40x64 to 5x5x512, and the widening
// convs 64->128 .. 256->512) the work is 2*16*C*Co flops a tile against
// 4*(C + Co)*4 bytes of device memory: fp32 FMA on the CUDA cores is the
// bound.  What the kernel pays beside it is traffic from L2: the slice of U
// a block stages (32 KB) is re-read by every block for only 32 tiles, which
// is the cost of the 16 sums, and neighbouring tiles and the two row halves
// read the same pixels of x again (24 patch loads a tile and 4 channels
// where 4 pixels are new).  Staging x once through shared memory, a slice
// of U shared by the blocks of a cluster, tensor cores and TMA are left to
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTiles = 32;   // 2x2 output tiles a block computes
constexpr int kTN = 32;      // output channels a block computes
constexpr int kChunk = 16;   // input channels staged per step
constexpr int kVStride = kChunk + 4;                // floats a tile of V_ab takes
constexpr int kVPlane = kTiles * kVStride + 16;     // floats V_ab takes
constexpr int kUPlane = kChunk * kTN + 4;           // floats U_ab takes
constexpr int kSmemFloats = 16 * kVPlane + 16 * kUPlane;
static_assert(kSmemFloats >= 16 * kTiles * kTN, "M reuses the staging space");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ void fma8(float (&acc)[8], float v, float4 u0,
                                     float4 u1) {
  acc[0] = fmaf(v, u0.x, acc[0]);
  acc[1] = fmaf(v, u0.y, acc[1]);
  acc[2] = fmaf(v, u0.z, acc[2]);
  acc[3] = fmaf(v, u0.w, acc[3]);
  acc[4] = fmaf(v, u1.x, acc[4]);
  acc[5] = fmaf(v, u1.y, acc[5]);
  acc[6] = fmaf(v, u1.z, acc[6]);
  acc[7] = fmaf(v, u1.w, acc[7]);
}

struct WinogradArgs {
  const float* x;  // (N, H, W, C)
  const float* u;  // (16, C, Co)
  float* y;        // (N, H, W, Co)
  int N, H, W, C, Co;
  int th, tw;      // tiles a frame: ceil(H/2), ceil(W/2)
};

__global__ void __launch_bounds__(kThreads, 2) winograd_kernel(WinogradArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* vsm = smem;                  // 16 x (kTiles, kVStride)
  float* usm = smem + 16 * kVPlane;   // 16 x (kChunk, kTN)
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kTN;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // the tile this thread stages and, at the end, writes: tile tid / 8
  const int sp = tid / 8;
  const long long tile = (long long)blockIdx.x * kTiles + sp;
  const bool tile_ok = tile < (long long)a.N * a.th * a.tw;
  const int per_frame = a.th * a.tw;
  const int fn = tile_ok ? (int)(tile / per_frame) : 0;
  const int fr = tile_ok ? (int)(tile % per_frame) : 0;
  const int oy = 2 * (fr / a.tw), ox = 2 * (fr % a.tw);  // the tile's outputs
  const float* xn = a.x + (size_t)fn * a.H * a.W * a.C;

  // staging role: 4 channels (sc), half sh of the rows of B^T
  const int sc = (tid % 4) * 4;
  const int sh = (tid / 4) % 2;

  // product role: one (a, b), tiles tg, tg + 4, .., 8 output channels
  const int ab = tid / 16;
  const int tg = (tid % 16) / 4;
  const int cg = tid % 4;
  const float* vb = vsm + ab * kVPlane + tg * kVStride;
  const float* ub = usm + ab * kUPlane + cg * 8;

  float acc[8][8] = {};
  for (int c0 = 0; c0 < a.C; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    {
      // rows oy - 1 + sh + {0, 1, 2} and columns ox - 1 + {0..3} of x
      float4 d[3][4];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int gy = oy - 1 + sh + r;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gx = ox - 1 + b;
          d[r][b] = zero4;
          if (tile_ok && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W &&
              c0 + sc < a.C)
            d[r][b] = ld4(xn + ((size_t)gy * a.W + gx) * a.C + c0 + sc);
        }
      }
      // B^T over the rows: a = 0: d0 - d2, a = 1: d1 + d2 from rows 0..2;
      // a = 2: d2 - d1, a = 3: d1 - d3 from rows 1..3
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float4 t[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (sh == 0)
            t[b] = k == 0 ? sub4(d[0][b], d[2][b]) : add4(d[1][b], d[2][b]);
          else
            t[b] = k == 0 ? sub4(d[1][b], d[0][b]) : sub4(d[0][b], d[2][b]);
        }
        float* dst = vsm + (sh * 2 + k) * 4 * kVPlane + sp * kVStride + sc;
        st4(dst, sub4(t[0], t[2]));
        st4(dst + kVPlane, add4(t[1], t[2]));
        st4(dst + 2 * kVPlane, sub4(t[2], t[1]));
        st4(dst + 3 * kVPlane, sub4(t[1], t[3]));
      }
    }
    for (int i = tid; i < 16 * kChunk * (kTN / 4); i += kThreads) {
      const int n = (i % (kTN / 4)) * 4;
      const int c = (i / (kTN / 4)) % kChunk;
      const int p = i / (kTN / 4 * kChunk);
      float4 v = zero4;
      if (c0 + c < a.C && n0 + n < a.Co)
        v = ld4(a.u + ((size_t)p * a.C + c0 + c) * a.Co + n0 + n);
      st4(usm + p * kUPlane + c * kTN + n, v);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; c += 4) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = ld4(vb + (half * 4 + i) * 4 * kVStride + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 u0 = ld4(ub + (c + j) * kTN);
          const float4 u1 = ld4(ub + (c + j) * kTN + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float vj = j == 0 ? v[i].x : j == 1 ? v[i].y
                           : j == 2 ? v[i].z : v[i].w;
            fma8(acc[half * 4 + i], vj, u0, u1);
          }
        }
      }
    }
  }

  // M through shared memory: msm[ab][tile][channel]
  __syncthreads();
  float* msm = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = msm + ((ab * kTiles) + tg + 4 * i) * kTN + cg * 8;
    st4(dst, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    st4(dst + 4, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
  __syncthreads();

  // Y = A^T M A for tile sp, 4 output channels; A^T = [[1,1,1,0],[0,1,-1,-1]]
  const int col = n0 + (tid % 8) * 4;
  if (!tile_ok || col >= a.Co) return;
  float4 ya[4][2];  // A^T over the rows, per column b
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float4 m[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      m[r] = ld4(msm + ((r * 4 + b) * kTiles + sp) * kTN + (tid % 8) * 4);
    ya[b][0] = add4(add4(m[0], m[1]), m[2]);
    ya[b][1] = sub4(sub4(m[1], m[2]), m[3]);
  }
  float* yn = a.y + (size_t)fn * a.H * a.W * a.Co;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (oy + i >= a.H) continue;
    float* row = yn + ((size_t)(oy + i) * a.W + ox) * a.Co + col;
    st4(row, add4(add4(ya[0][i], ya[1][i]), ya[2][i]));
    if (ox + 1 < a.W)
      st4(row + a.Co, sub4(sub4(ya[1][i], ya[2][i]), ya[3][i]));
  }
}

}  // namespace

extern "C" {

// y = conv3x3(x, g) by Winograd on `stream`, from u = G g G^T.  x (N, H, W,
// C), u (16, C, Co), y (N, H, W, Co), all fp32, contiguous and 16-byte
// aligned; C and Co multiples of 4.  Returns cudaSuccess, the error of an
// attribute call or the launch, or cudaErrorInvalidValue for a shape the
// kernel does not take.
int fvt_winograd_forward(const void* x, const void* u, void* y, int N, int H,
                         int W, int C, int Co, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 4 || Co % 4)
    return (int)cudaErrorInvalidValue;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const long long blocks = ((long long)N * th * tw + kTiles - 1) / kTiles;
  const int col_blocks = (Co + kTN - 1) / kTN;
  if (blocks > 2147483647LL || col_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  const int bytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      winograd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const WinogradArgs a{(const float*)x, (const float*)u, (float*)y,
                       N, H, W, C, Co, th, tw};
  winograd_kernel<<<dim3((unsigned)blocks, col_blocks), kThreads, bytes,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
