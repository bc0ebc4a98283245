// 3x3 stride-1 pad-1 convolution, NHWC, no bias, fp32, for Hopper (sm_90a).
//
// Replaces fvt_tpu/ops/conv_pallas.py::_conv3x3_kernel (the Pallas kernel
// behind conv3x3_pallas): y[n, i, j, :] = sum over the nine taps (dy, dx) of
// x[n, i + dy - 1, j + dx - 1, :] @ w[dy*3 + dx], with x zero outside the
// image and fp32 sums.  x (N, H, W, C), w (9, C, Co), y (N, H, W, Co).
//
// What was chosen, and what bounds it.  The TPU version pads x in device
// memory first and holds whole padded frames and all nine (C, Co) weights
// on chip.  Here a block owns a tile of tf frames by th x tw pixels and 64
// output channels; it reads the tile and its one-pixel halo straight from x
// with a bounds mask (zero outside the image, no padded copy) and streams
// the input channels and the weights through shared memory kChunk channels
// at a time (conv_tile.cuh).  At the ArcFace shapes (N = 2400; 40x40x64 to
// 5x5x512) a conv is 2*9*C*Co flops a pixel against (C + Co)*4 bytes, 288 to
// 2304 flops a byte: fp32 FMA on the CUDA cores bounds it, not the memory.
// The weights (up to 9.4 MB) stay in L2 across blocks.  The caller picks
// the tile so that it divides the frames and 16*r pixels fill the block's
// threads (40x40: 8x20, 20x20: two frames of 4x20, 10x10: eight frames of
// 2x10, 5x5: five whole frames).  The fp32 route is now the tensor-core
// design of conv3x3_tf32x3.cu (TMA staging, split-TF32 wgmma); this kernel
// stays as ops.conv.conv3x3_simt, timed beside it and on no model path.

#include "conv_tile.cuh"

namespace {

using namespace fvt_conv;

constexpr int kChunk = 16;            // input channels staged per step
constexpr int kXStride = kChunk + 4;  // floats a staged pixel takes
constexpr int kRowGroups = 16;
constexpr int kTN = tile_cols(kRowGroups);  // 64 output channels a block
constexpr int kColGroups = kTN / 4;

struct Conv3x3Args {
  const float* x;
  const float* w;
  float* y;
  int N, H, W, C, Co;
  Tiling t;
};

template <int R>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(Conv3x3Args a) {
  extern __shared__ __align__(16) float smem[];
  const Tiling t = a.t;
  const int ph = t.th + 2, pw = t.tw + 2;
  const int patch = t.tf * ph * pw;
  float* xs = smem;                    // (patch, kXStride)
  float* ws = smem + patch * kXStride; // (9, kChunk, kTN)
  const int cg = threadIdx.x % kColGroups;
  const int rg = threadIdx.x / kColGroups;
  const int n0 = blockIdx.y * kTN;
  int n_base, y0, x0;
  tile_origin(t, n_base, y0, x0);
  const int pixels = t.tf * t.th * t.tw;

  int base[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int p = rg + i * kRowGroups;
    if (p >= pixels) p = 0;  // computed on pixel 0's window, never stored
    const int f = p / (t.th * t.tw), r = p % (t.th * t.tw);
    base[i] = ((f * ph + r / t.tw) * pw + r % t.tw) * kXStride;
  }

  float acc[R][4] = {};
  for (int c0 = 0; c0 < a.C; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < patch * (kChunk / 4); i += kThreads) {
      const int px = i / (kChunk / 4);
      const int c = (i % (kChunk / 4)) * 4;
      const int f = px / (ph * pw), r = px % (ph * pw);
      const int n = n_base + f;
      const int gy = y0 - 1 + r / pw, gx = x0 - 1 + r % pw;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < a.N && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W &&
          c0 + c < a.C)
        v = ld4(a.x + (((size_t)n * a.H + gy) * a.W + gx) * a.C + c0 + c);
      st4(xs + px * kXStride + c, v);
    }
    stage_weights<kChunk, kTN>(ws, a.w, a.C, a.Co, c0, n0);
    __syncthreads();
    tile_fma<R, kChunk, kTN>(acc, xs, base, R, pw * kXStride, kXStride,
                             ws + cg * 4);
  }

  const int col = n0 + cg * 4;
  if (col >= a.Co) return;  // no barrier follows
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int p = rg + i * kRowGroups;
    if (p >= pixels) continue;
    const int f = p / (t.th * t.tw), r = p % (t.th * t.tw);
    const int n = n_base + f;
    const int gy = y0 + r / t.tw, gx = x0 + r % t.tw;
    if (n >= a.N || gy >= a.H || gx >= a.W) continue;
    st4(a.y + (((size_t)n * a.H + gy) * a.W + gx) * a.Co + col,
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

template <int R>
cudaError_t launch(const Conv3x3Args& a, cudaStream_t stream) {
  const Tiling& t = a.t;
  const size_t bytes =
      ((size_t)t.tf * (t.th + 2) * (t.tw + 2) * kXStride +
       (size_t)9 * kChunk * kTN) * sizeof(float);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((a.N + t.tf - 1) / t.tf) * t.tiles_y * t.tiles_x;
  const int col_blocks = (a.Co + kTN - 1) / kTN;
  if (blocks > 2147483647LL || col_blocks > 65535)
    return cudaErrorInvalidValue;
  conv3x3_kernel<R><<<dim3((unsigned)blocks, col_blocks), kThreads, bytes,
                      stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = conv3x3(x, w) on `stream`.  x (N, H, W, C), w (9, C, Co), y (N, H, W,
// Co), all fp32, contiguous and 16-byte aligned; C and Co multiples of 4.  A
// block takes tf frames by th x tw pixels, tf*th*tw <= 160 (10 pixels a
// thread: with 12 or 16 the sums spill out of the 128 registers that two
// blocks an SM leave a thread).  Returns
// cudaSuccess, the error of an attribute call or the launch, or
// cudaErrorInvalidValue for a shape or a tile the kernel does not take.
int fvt_conv3x3_forward(const void* x, const void* w, void* y, int N, int H,
                        int W, int C, int Co, int tf, int th, int tw,
                        void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 4 || Co % 4 ||
      tf <= 0 || th <= 0 || tw <= 0 || th > H || tw > W || tf > N)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)tf * th * tw;
  if (pixels > 10 * kRowGroups) return (int)cudaErrorInvalidValue;
  const Conv3x3Args a{(const float*)x, (const float*)w, (float*)y, N, H, W,
                      C, Co, make_tiling(H, W, tf, th, tw)};
  cudaStream_t st = (cudaStream_t)stream;
  const int r = ((int)pixels + kRowGroups - 1) / kRowGroups;
  if (r <= 4) return (int)launch<4>(a, st);
  if (r <= 8) return (int)launch<8>(a, st);
  return (int)launch<10>(a, st);
}

}  // extern "C"
