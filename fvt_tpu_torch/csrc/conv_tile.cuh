// Shared pieces of the 3x3-convolution kernels (conv3x3.cu, bottleneck.cu):
// a block of 256 threads computes up to RG*R output pixels by TN = 1024/RG
// output channels of a 3x3 stride-1 convolution as nine shifted products,
// from an input patch (the pixels plus a one-pixel halo) that lies in shared
// memory.
//
// Threads form TN/4 column groups (4 output channels each, read as one
// float4 of the staged weights) by RG row groups (16, 8 or 4); a thread owns
// the pixels rg, rg + RG, ... of the block's pixel list, so it holds R x 4
// fp32 sums.  Per four input channels a thread reads four float4 of weights
// and one float4 of each of its pixels and does 16*R FMAs: the ratio of
// FMAs to shared-memory reads (11 at R = 10) keeps the CUDA cores, not the
// shared memory, the limit; with few pixels a block, fewer row groups keep R
// up.  The weights of all nine taps of a KC-channel slice are staged at
// once, so one pair of barriers covers 9*KC reduction steps.

#pragma once

#include <cuda_runtime.h>

namespace fvt_conv {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

// output channels a block computes per pass, with RG row groups
__host__ __device__ constexpr int tile_cols(int rg) {
  return 4 * kThreads / rg;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float v, float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// ws[tap][c][n] = w[tap][c0 + c][n0 + n] for the nine taps, KC input channels
// and TN output channels of w (9, C, Co); zero beyond C or Co, so the FMA
// loops need no channel guard.
template <int KC, int TN>
__device__ __forceinline__ void stage_weights(float* ws, const float* w,
                                              int C, int Co, int c0, int n0) {
  constexpr int kColGroups = TN / 4;
  for (int i = threadIdx.x; i < 9 * KC * kColGroups; i += kThreads) {
    const int n = (i % kColGroups) * 4;
    const int c = (i / kColGroups) % KC;
    const int tap = i / (kColGroups * KC);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + c < C && n0 + n < Co)
      v = ld4(w + ((size_t)tap * C + c0 + c) * Co + n0 + n);
    st4(ws + (tap * KC + c) * TN + n, v);
  }
}

// acc[i] += sum over the nine taps (dy, dx) and KC channels c of
//   xs[base[i] + dy*row_stride + dx*px_stride + c] * wk[(tap*KC + c)*TN ..+3]
// for the thread's first r pixels (r <= R).  base[i] is the offset, in
// floats, of the top-left pixel of pixel i's 3x3 window in the patch; wk
// points at the thread's four columns of the staged weights.
template <int R, int KC, int TN>
__device__ __forceinline__ void tile_fma(float (&acc)[R][4], const float* xs,
                                         const int (&base)[R], int r,
                                         int row_stride, int px_stride,
                                         const float* wk) {
  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const float* xt = xs + dy * row_stride + dx * px_stride;
      const float* wt = wk + (dy * 3 + dx) * KC * TN;
#pragma unroll
      for (int c = 0; c < KC; c += 4) {
        const float4 w0 = ld4(wt + (c + 0) * TN);
        const float4 w1 = ld4(wt + (c + 1) * TN);
        const float4 w2 = ld4(wt + (c + 2) * TN);
        const float4 w3 = ld4(wt + (c + 3) * TN);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i < r) {
            const float4 x = ld4(xt + base[i] + c);
            fma4(acc[i], x.x, w0);
            fma4(acc[i], x.y, w1);
            fma4(acc[i], x.z, w2);
            fma4(acc[i], x.w, w3);
          }
        }
      }
    }
  }
}

// How a launch cuts (N, H, W) into blocks: tf frames by th x tw pixels each.
struct Tiling {
  int tf, th, tw, tiles_y, tiles_x;
};

__host__ __device__ inline Tiling make_tiling(int H, int W, int tf, int th,
                                              int tw) {
  return Tiling{tf, th, tw, (H + th - 1) / th, (W + tw - 1) / tw};
}

// blockIdx.x -> first frame and top-left pixel of the block's tile
__device__ __forceinline__ void tile_origin(const Tiling& t, int& n_base,
                                            int& y0, int& x0) {
  const unsigned b = blockIdx.x;
  x0 = (int)(b % t.tiles_x) * t.tw;
  y0 = (int)((b / t.tiles_x) % t.tiles_y) * t.th;
  n_base = (int)(b / (t.tiles_x * t.tiles_y)) * t.tf;
}

}  // namespace fvt_conv
