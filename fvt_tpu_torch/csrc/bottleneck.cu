// Fused eval-mode identity BottleneckIR block, NHWC, fp32, for Hopper
// (sm_90a).
//
// Replaces fvt_tpu/ops/bottleneck_pallas.py::_block_kernel (the Pallas
// kernel behind bottleneck_ir_fused).  In one launch, for x (N, H, W, C):
//
//     t = a1 * x + b1                     (bn1 folded to an affine)
//     u = conv3x3(t, w1)                  (t zero outside the image)
//     v = u > 0 ? u : alpha * u           (PReLU)
//     r = conv3x3(v, w2)                  (v zero outside the image)
//     y = a2 * r + b2 + x                 (bn2 affine, residual)
//
// with w1, w2 (9, C, C) and a1, b1, alpha, a2, b2 (C).  Neither t, u nor v
// reaches device memory.
//
// What was chosen, and what bounds it.  The TPU kernel holds whole padded
// frames of t and v and both weights on chip.  Here a 40x40x64 fp32 frame is
// 410 KB and the weights of a 512-channel block are 2 x 9.4 MB, against the
// 227 KB of shared memory a block may use.  So a block owns a tile of tf
// frames by th x tw pixels:
//
//  * conv1 + PReLU are computed on the tile plus a one-pixel halo (reading x
//    on a two-pixel halo, staged kChunk channels at a time with bn1 applied
//    on the way in), 64 to 256 output channels a pass, and written to a v
//    tile in shared memory that holds all C channels;
//  * conv2 + bn2 + residual then run from that v tile, as many output
//    channels a pass; both weights stream through shared memory in (9,
//    kChunk, 64..256) slices and stay in L2 across blocks.
//
// Two zeros are exact.  conv1's input outside the image is 0, not b1: bn1 is
// applied before the zero pad, so the staging writes 0 there.  conv2's input
// outside the image is 0, not PReLU(conv1(...)) of a halo pixel: the v tile
// is zeroed first and conv1 is computed only at the halo pixels that lie
// inside the image.
//
// At the ArcFace shapes (N = 2400; 40x40x64, 20x20x128, 10x10x256, 5x5x512)
// a block is 2*2*9*C*C flops a pixel against 2*C*4 bytes: fp32 FMA on the
// CUDA cores bounds it.  The halo recompute costs conv1 up to
// (th+2)(tw+2)/(th*tw) of its work where the tile is cut from a frame and
// nothing where a block takes whole frames.  The v tile is what limits a
// block: it bounds the pixels a block can take (one 5x5 frame at C = 512 if
// two blocks are to fit an SM), so the weight slices are re-read from L2 for
// few pixels there, and where only one block fits an SM its eight warps do
// not hide the latencies of the inner loop.  The caller picks the tile and
// the row groups per shape from measurements.  Tensor cores, TMA and a
// pipelined staging are left to later work.

#include "conv_tile.cuh"

namespace {

using namespace fvt_conv;

constexpr int kChunk = 8;             // input channels staged per step
constexpr int kXStride = kChunk + 4;  // floats a staged pixel of t takes

struct BottleneckArgs {
  const float* x;
  const float* w1;
  const float* w2;
  const float* a1;
  const float* b1;
  const float* alpha;
  const float* a2;
  const float* b2;
  float* y;
  int N, H, W, C;
  Tiling t;
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float prelu(float u, float alpha) {
  return u > 0.f ? u : alpha * u;
}

// Shared-memory layout, in floats: the v tile (all C channels, pixel stride
// C + 4 so that neighbouring pixels fall on other banks), the staged slice
// of t, the staged weight slice.
struct Smem {
  int vstride, ts, ws, total;
  __host__ __device__ Smem(const Tiling& t, int C, int tn) {
    vstride = C + 4;
    ts = t.tf * (t.th + 2) * (t.tw + 2) * vstride;
    ws = ts + t.tf * (t.th + 4) * (t.tw + 4) * kXStride;
    total = ws + 9 * kChunk * tn;
  }
};

// R pixels a thread; RG row groups, so 1024/RG output channels a pass
template <int R, int RG>
__global__ void __launch_bounds__(kThreads, 2)
bottleneck_kernel(BottleneckArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRowGroups = RG;
  constexpr int kTN = tile_cols(RG);
  constexpr int kColGroups = kTN / 4;
  const Tiling t = a.t;
  const Smem lay(t, a.C, kTN);
  const int vs = lay.vstride;
  const int vh = t.th + 2, vw = t.tw + 2;  // the v tile, per frame
  const int th4 = t.th + 4, tw4 = t.tw + 4;  // the staged t patch, per frame
  float* vt = smem;
  float* ts = smem + lay.ts;
  float* ws = smem + lay.ws;
  const int cg = threadIdx.x % kColGroups;
  const int rg = threadIdx.x / kColGroups;
  int n_base, y0, x0;
  tile_origin(t, n_base, y0, x0);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = threadIdx.x; i < lay.ts / 4; i += kThreads)
    st4(vt + i * 4, zero4);

  // conv1's pixels: the tile plus its halo, clipped to the image
  const int vy_lo = imax(y0 - 1, 0), vy_hi = imin(y0 + t.th + 1, a.H);
  const int vx_lo = imax(x0 - 1, 0), vx_hi = imin(x0 + t.tw + 1, a.W);
  const int ch = vy_hi - vy_lo, cw = vx_hi - vx_lo;
  const int pixels1 = imin(t.tf, a.N - n_base) * ch * cw;
  const int r1 = (pixels1 + kRowGroups - 1) / kRowGroups;

  {
    int base[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int p = rg + i * kRowGroups;
      if (p >= pixels1) p = 0;
      const int f = p / (ch * cw), r = p % (ch * cw);
      const int gy = vy_lo + r / cw, gx = vx_lo + r % cw;
      // the window of (gy, gx) starts at (gy - 1, gx - 1); the patch at
      // (y0 - 2, x0 - 2)
      base[i] = ((f * th4 + gy - y0 + 1) * tw4 + gx - x0 + 1) * kXStride;
    }
    const int patch = t.tf * th4 * tw4;

    for (int n0 = 0; n0 < a.C; n0 += kTN) {
      float acc[R][4] = {};
      for (int c0 = 0; c0 < a.C; c0 += kChunk) {
        __syncthreads();  // the previous slice's readers are done
        for (int i = threadIdx.x; i < patch * (kChunk / 4); i += kThreads) {
          const int px = i / (kChunk / 4);
          const int c = (i % (kChunk / 4)) * 4;
          const int f = px / (th4 * tw4), r = px % (th4 * tw4);
          const int n = n_base + f;
          const int gy = y0 - 2 + r / tw4, gx = x0 - 2 + r % tw4;
          float4 v = zero4;
          if (n < a.N && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W &&
              c0 + c < a.C) {
            const float4 xv =
                ld4(a.x + (((size_t)n * a.H + gy) * a.W + gx) * a.C + c0 + c);
            const float4 s = ld4(a.a1 + c0 + c), b = ld4(a.b1 + c0 + c);
            v = make_float4(fmaf(xv.x, s.x, b.x), fmaf(xv.y, s.y, b.y),
                            fmaf(xv.z, s.z, b.z), fmaf(xv.w, s.w, b.w));
          }
          st4(ts + px * kXStride + c, v);
        }
        stage_weights<kChunk, kTN>(ws, a.w1, a.C, a.C, c0, n0);
        __syncthreads();
        tile_fma<R, kChunk, kTN>(acc, ts, base, r1, tw4 * kXStride, kXStride,
                                 ws + cg * 4);
      }
      const int col = n0 + cg * 4;
      if (col < a.C) {
        const float4 al = ld4(a.alpha + col);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int p = rg + i * kRowGroups;
          if (p >= pixels1) continue;
          const int f = p / (ch * cw), r = p % (ch * cw);
          const int gy = vy_lo + r / cw, gx = vx_lo + r % cw;
          st4(vt + ((f * vh + gy - y0 + 1) * vw + gx - x0 + 1) * vs + col,
              make_float4(prelu(acc[i][0], al.x), prelu(acc[i][1], al.y),
                          prelu(acc[i][2], al.z), prelu(acc[i][3], al.w)));
        }
      }
    }
  }

  // conv2 + bn2 + residual from the v tile
  const int pixels2 = t.tf * t.th * t.tw;
  const int r2 = (pixels2 + kRowGroups - 1) / kRowGroups;
  int base[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int p = rg + i * kRowGroups;
    if (p >= pixels2) p = 0;
    const int f = p / (t.th * t.tw), r = p % (t.th * t.tw);
    base[i] = ((f * vh + r / t.tw) * vw + r % t.tw) * vs;
  }
  for (int n0 = 0; n0 < a.C; n0 += kTN) {
    float acc[R][4] = {};
    for (int c0 = 0; c0 < a.C; c0 += kChunk) {
      __syncthreads();  // v is written; the previous slice's readers are done
      stage_weights<kChunk, kTN>(ws, a.w2, a.C, a.C, c0, n0);
      __syncthreads();
      tile_fma<R, kChunk, kTN>(acc, vt + c0, base, r2, vw * vs, vs,
                               ws + cg * 4);
    }
    const int col = n0 + cg * 4;
    if (col >= a.C) continue;
    const float4 s = ld4(a.a2 + col), b = ld4(a.b2 + col);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = rg + i * kRowGroups;
      if (p >= pixels2) continue;
      const int f = p / (t.th * t.tw), r = p % (t.th * t.tw);
      const int n = n_base + f;
      const int gy = y0 + r / t.tw, gx = x0 + r % t.tw;
      if (n >= a.N || gy >= a.H || gx >= a.W) continue;
      const size_t off = (((size_t)n * a.H + gy) * a.W + gx) * a.C + col;
      const float4 xv = ld4(a.x + off);
      st4(a.y + off, make_float4(fmaf(acc[i][0], s.x, b.x) + xv.x,
                                 fmaf(acc[i][1], s.y, b.y) + xv.y,
                                 fmaf(acc[i][2], s.z, b.z) + xv.z,
                                 fmaf(acc[i][3], s.w, b.w) + xv.w));
    }
  }
}

template <int R, int RG>
cudaError_t launch(const BottleneckArgs& a, cudaStream_t stream) {
  const Tiling& t = a.t;
  const size_t bytes =
      (size_t)Smem(t, a.C, tile_cols(RG)).total * sizeof(float);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<R, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((a.N + t.tf - 1) / t.tf) * t.tiles_y * t.tiles_x;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  bottleneck_kernel<R, RG><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// rows (or columns) of the largest tile-plus-halo, clipped to the image
int max_clipped(int extent, int tile) {
  int best = 0;
  for (int o = 0; o < extent; o += tile)
    best = imax(best, imin(o + tile + 1, extent) - imax(o - 1, 0));
  return best;
}

}  // namespace

extern "C" {

// y = the fused block of x on `stream`.  x, y (N, H, W, C); w1, w2 (9, C,
// C); a1, b1, alpha, a2, b2 (C); all fp32, contiguous and 16-byte aligned;
// C a multiple of 4; y must not alias x.  A block takes tf frames by
// th x tw pixels and deals them to rg row groups (16, 8 or 4: 64, 128 or 256
// output channels a pass); the tile plus its halo, clipped to the image, may
// hold at most 16 * rg pixels over the tf frames, and the v tile must fit in
// shared memory.  Returns cudaSuccess, the error of an attribute call or the
// launch, or cudaErrorInvalidValue for a shape or a tile the kernel does
// not take.
int fvt_bottleneck_forward(const void* x, const void* w1, const void* w2,
                           const void* a1, const void* b1, const void* alpha,
                           const void* a2, const void* b2, void* y, int N,
                           int H, int W, int C, int tf, int th, int tw,
                           int rg, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 || tf <= 0 || th <= 0 ||
      tw <= 0 || th > H || tw > W || tf > N ||
      (rg != 16 && rg != 8 && rg != 4))
    return (int)cudaErrorInvalidValue;
  const long long pixels1 =
      (long long)tf * max_clipped(H, th) * max_clipped(W, tw);
  if (pixels1 > 16 * rg) return (int)cudaErrorInvalidValue;
  const BottleneckArgs a{(const float*)x, (const float*)w1, (const float*)w2,
                         (const float*)a1, (const float*)b1,
                         (const float*)alpha, (const float*)a2,
                         (const float*)b2, (float*)y, N, H, W, C,
                         make_tiling(H, W, tf, th, tw)};
  cudaStream_t st = (cudaStream_t)stream;
  const int r = ((int)pixels1 + rg - 1) / rg;
  if (rg == 16) {
    if (r <= 4) return (int)launch<4, 16>(a, st);
    if (r <= 8) return (int)launch<8, 16>(a, st);
    if (r <= 12) return (int)launch<12, 16>(a, st);
    return (int)launch<16, 16>(a, st);
  }
  if (rg == 8) {
    if (r <= 8) return (int)launch<8, 8>(a, st);
    if (r <= 12) return (int)launch<12, 8>(a, st);
    return (int)launch<16, 8>(a, st);
  }
  if (r <= 8) return (int)launch<8, 4>(a, st);
  return (int)launch<16, 4>(a, st);
}

}  // extern "C"
