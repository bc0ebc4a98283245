// Fused eval-mode TemporalBlock, fp32, for Hopper (sm_90a).
//
// Replaces fvt_tpu/ops/tcn_pallas.py::_block_kernel (the Pallas kernel
// behind fused_temporal_block / tcn_forward_pallas).  One block computes
//
//     y = leaky(leaky(conv2(leaky(conv1(x)))) + res)
//
// for one batch row and one tile of kTileT output frames, where conv1 and
// conv2 are causal dilated convolutions (left pad (K-1)*d, zeros) and res is
// the 1x1 downsample of x when a downsample is given, else x itself.  The
// hidden activation h = leaky(conv1(x)) never leaves shared memory.
//
// What bounds it on the card.  The TPU kernel keeps a whole (pad+T, Cin) row
// and every weight in VMEM; here w1 alone is up to 5*768*256*4 B = 3.9 MB,
// far above the 227 KB of shared memory a block may use.  So time is tiled:
// output frames [t0, t0+kTileT) need h on [t0-pad, t0+kTileT), which needs x
// on [t0-2*pad, t0+kTileT).  Each block recomputes conv1 over that halo
// (the recompute is (kTileT+pad)/kTileT of conv1's work) and streams Cin and
// the weights through shared memory kChunk channels at a time; a thread
// holds at most kMaxHRows rows of h in registers, so that two blocks fit an
// SM, and takes more passes over Cin where the halo is longer.  h at a
// negative time is exactly 0, because conv2's causal pad is zeros of h, not
// leaky(b1) of a zero-padded x.  At the main-path shapes (B=8, T=300) a
// block does ~2*(kTileT+pad)*Cout*K*Cin flops of fp32 FMA work on CUDA
// cores, and the weights come from L2 (every block reads them).  Device
// memory is not the bound: each step's weight loads, which nothing overlaps
// with the FMAs, are the likely one.  Tensor cores (wgmma), TMA and a
// pipelined weight stream are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 16;     // output frames per block
constexpr int kChunk = 32;     // input channels staged per step
constexpr int kMaxHRows = 8;   // h rows a thread holds at a time
constexpr int kMaxORows = 4;   // output rows a thread may own
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * 0.01f;
}

struct BlockArgs {
  const float* x;   // (B, T, Cin)
  const float* w1;  // (K, Cin, Cout)
  const float* b1;  // (Cout)
  const float* w2;  // (K, Cout, Cout)
  const float* b2;  // (Cout)
  const float* wd;  // (Cin, Cout), or null when Cin == Cout
  const float* bd;  // (Cout), or null
  float* out;       // (B, T, Cout)
  int T, Cin, Cout, K, dil;
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Shared-memory layout, in floats.
struct Smem {
  int xs, ws, wds, hs, total;
  __host__ __device__ Smem(int cout, int pad, bool has_ds) {
    const int xrows = kTileT + 2 * pad;
    xs = 0;
    ws = align4(xrows * (kChunk + 1));
    wds = ws + kChunk * cout;
    hs = wds + (has_ds ? kChunk * cout : 0);
    total = hs + (kTileT + pad) * (cout + 1);
  }
};

// Stages rows [c0, c0+n) of a (rows, cout) matrix into dst (kChunk, cout),
// zero-filling rows past n so the FMA loops need no channel guard.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int c0, int n, int cout) {
  const int cout4 = cout / 4;
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < kChunk * cout4; i += kThreads) {
    const int r = i / cout4;
    d4[i] = r < n ? s4[(size_t)(c0 + r) * cout4 + i % cout4]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float v, float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

__global__ void __launch_bounds__(kThreads, 2)  // two blocks per SM
tcn_block_kernel(BlockArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int pad = (a.K - 1) * a.dil;
  const bool has_ds = a.wd != nullptr;
  const Smem lay(a.Cout, pad, has_ds);
  float* xs = smem + lay.xs;
  float* ws = smem + lay.ws;
  float* wds = smem + lay.wds;
  float* hs = smem + lay.hs;
  const int xstride = kChunk + 1;
  const int hstride = a.Cout + 1;
  const int xrows = kTileT + 2 * pad;
  const int hrows = kTileT + pad;

  // thread -> (row group, 4-column group)
  const int ncg = a.Cout / 4;
  const int nrg = kThreads / ncg;
  const int cg = threadIdx.x % ncg;
  const int rg = threadIdx.x / ncg;
  const int c4 = cg * 4;
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  const float4* wds4 = reinterpret_cast<const float4*>(wds);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileT;
  const float* xb = a.x + (size_t)b * a.T * a.Cin;

  // rows of h (r = rg + i*nrg < hrows) and of the output this thread owns
  const int nh = (hrows - rg + nrg - 1) / nrg;
  const int no = (kTileT - rg + nrg - 1) / nrg;
  // h rows are done kMaxHRows per thread at a time, to bound registers;
  // every main-path shape takes one pass
  const int npass = ((hrows + nrg - 1) / nrg + kMaxHRows - 1) / kMaxHRows;

  // ---- conv1 over the halo (and the 1x1 downsample over the tile)
  float racc[kMaxORows][4] = {};
  for (int p = 0; p < npass; ++p) {
    const int i0 = p * kMaxHRows;
    float acc[kMaxHRows][4] = {};
    for (int c0 = 0; c0 < a.Cin; c0 += kChunk) {
      const int n = min(kChunk, a.Cin - c0);
      __syncthreads();  // previous chunk's readers are done
      for (int i = threadIdx.x; i < xrows * kChunk; i += kThreads) {
        const int r = i / kChunk, c = i % kChunk;
        const int t = t0 - 2 * pad + r;
        xs[r * xstride + c] = (t >= 0 && t < a.T && c < n)
                                  ? xb[(size_t)t * a.Cin + c0 + c]
                                  : 0.f;
      }
      const bool ds_now = has_ds && p == 0;
      if (ds_now) stage_rows(wds, a.wd, c0, n, a.Cout);
      for (int k = 0; k < a.K; ++k) {
        if (k > 0) __syncthreads();  // readers of the previous tap are done
        stage_rows(ws, a.w1 + (size_t)k * a.Cin * a.Cout, c0, n, a.Cout);
        __syncthreads();
        if (k == 0 && ds_now) {
          for (int c = 0; c < n; ++c) {
            const float4 w = wds4[c * ncg + cg];
#pragma unroll
            for (int i = 0; i < kMaxORows; ++i) {
              if (i >= no) break;
              fma4(racc[i], xs[(2 * pad + rg + i * nrg) * xstride + c], w);
            }
          }
        }
        const int shift = k * a.dil;
        for (int c = 0; c < n; ++c) {
          const float4 w = ws4[c * ncg + cg];
#pragma unroll
          for (int i = 0; i < kMaxHRows; ++i) {
            if (i0 + i >= nh) break;
            fma4(acc[i], xs[(rg + (i0 + i) * nrg + shift) * xstride + c], w);
          }
        }
      }
    }
    // h rows cover times t0-pad .. t0+kTileT-1; negative times are
    // conv2's zero pad
#pragma unroll
    for (int i = 0; i < kMaxHRows; ++i) {
      if (i0 + i >= nh) break;
      const int r = rg + (i0 + i) * nrg;
      const bool before_start = t0 - pad + r < 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hs[r * hstride + c4 + j] =
            before_start ? 0.f : leaky(acc[i][j] + a.b1[c4 + j]);
    }
  }

  // ---- conv2 over h, from shared memory
  float acc2[kMaxORows][4] = {};
  for (int c0 = 0; c0 < a.Cout; c0 += kChunk) {
    const int n = min(kChunk, a.Cout - c0);
    for (int k = 0; k < a.K; ++k) {
      __syncthreads();  // h written / previous tap's readers are done
      stage_rows(ws, a.w2 + (size_t)k * a.Cout * a.Cout, c0, n, a.Cout);
      __syncthreads();
      const int shift = k * a.dil;
      for (int c = 0; c < n; ++c) {
        const float4 w = ws4[c * ncg + cg];
#pragma unroll
        for (int i = 0; i < kMaxORows; ++i) {
          if (i >= no) break;
          fma4(acc2[i], hs[(rg + i * nrg + shift) * hstride + c0 + c], w);
        }
      }
    }
  }

  // ---- epilogue: leaky(leaky(conv2 + b2) + residual)
  const float4 bias2 = *reinterpret_cast<const float4*>(a.b2 + c4);
  float4 biasd = make_float4(0.f, 0.f, 0.f, 0.f);
  if (has_ds) biasd = *reinterpret_cast<const float4*>(a.bd + c4);
#pragma unroll
  for (int i = 0; i < kMaxORows; ++i) {
    const int r = rg + i * nrg;
    const int t = t0 + r;
    if (r < kTileT && t < a.T) {
      float4 res;
      if (has_ds) {
        res = make_float4(racc[i][0] + biasd.x, racc[i][1] + biasd.y,
                          racc[i][2] + biasd.z, racc[i][3] + biasd.w);
      } else {  // Cin == Cout: the unpadded input itself
        res = *reinterpret_cast<const float4*>(xb + (size_t)t * a.Cin + c4);
      }
      float4 y;
      y.x = leaky(leaky(acc2[i][0] + bias2.x) + res.x);
      y.y = leaky(leaky(acc2[i][1] + bias2.y) + res.y);
      y.z = leaky(leaky(acc2[i][2] + bias2.z) + res.z);
      y.w = leaky(leaky(acc2[i][3] + bias2.w) + res.w);
      *reinterpret_cast<float4*>(
          a.out + ((size_t)b * a.T + t) * a.Cout + c4) = y;
    }
  }
}

}  // namespace

extern "C" {

// Launches the fused block on `stream`.  Returns cudaSuccess, the error of
// the attribute call or the launch (cudaGetLastError), or
// cudaErrorInvalidValue for a shape the kernel does not take: Cout must be
// a power of two from 4 to 256 (a thread owns 4 columns, and at most
// kMaxORows output rows), and the shared memory must fit.  wd/bd are null
// when Cin == Cout.
int fvt_tcn_block_forward(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* wd,
                          const void* bd, void* out, int B, int T, int Cin,
                          int Cout, int K, int dil, void* stream) {
  const int pad = (K - 1) * dil;
  if (B <= 0 || T <= 0 || Cin <= 0 || K <= 0 || dil <= 0 || Cout % 4 ||
      Cout < 4 || kThreads % (Cout / 4) || (wd == nullptr && Cin != Cout))
    return (int)cudaErrorInvalidValue;
  if ((kTileT + kThreads / (Cout / 4) - 1) / (kThreads / (Cout / 4)) >
      kMaxORows)
    return (int)cudaErrorInvalidValue;
  const Smem lay(Cout, pad, wd != nullptr);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tcn_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  BlockArgs a{(const float*)x, (const float*)w1, (const float*)b1,
              (const float*)w2, (const float*)b2, (const float*)wd,
              (const float*)bd, (float*)out, T, Cin, Cout, K, dil};
  dim3 grid((T + kTileT - 1) / kTileT, B);
  tcn_block_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* fvt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
