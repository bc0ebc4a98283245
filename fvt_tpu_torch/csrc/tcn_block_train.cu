// Fused train-mode TemporalBlock, forward and backward, fp32, for Hopper
// (sm_90a).
//
// Replaces fvt_tpu/ops/tcn_pallas.py::_block_train_kernel (forward) and
// ::_block_bwd_kernel (backward), the Pallas kernels behind
// fused_temporal_block_train.  With causal dilated convolutions (left pad
// (K-1)*d, zeros), dropout masks m1/m2 pre-scaled to {0, 1/(1-p)} and the
// residual stream `res` computed by the caller:
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
// What was chosen, and what bounds it.  The TPU kernels hold one whole
// (pad+T, C) row in VMEM, recompute the forward inside the backward, and
// add the weight gradients up over a grid that runs in order on one core.
// None of that carries over: a row of h is up to 300*256*4 B = 307 KB,
// above the 227 KB a block may use, the backward reads d_a2 up to 2*pad
// frames into the future, and blocks here run in no order.  So
//
//  * the forward is two launches of one tiled GEMM-like kernel
//    (conv_gemm_kernel): conv1 writes a1, conv2 reads h = leaky(a1)*m1 back
//    while it stages its input, writes a2 and the block's output.  a1 and
//    a2 (2 x B*T*Cout floats, <= 9.8 MB at the widest block) are kept for
//    the backward, which therefore recomputes no convolution;
//  * the backward is one elementwise kernel (gz, d_a2), the same
//    conv_gemm_kernel run anti-causally on transposed weights for d_a1 and
//    dx, and wgrad_kernel for dw1/dw2, in which each block owns one
//    (tap, 64 x 64) tile of a weight gradient and loops over all rows of
//    its share of the batch itself.  Where the tiles alone would leave SMs
//    idle the batch is cut into S shares, whose partial tiles a second
//    kernel adds in share order.  db1/db2 are column sums with a fixed
//    tree.  No float atomics anywhere: two runs give the same bits.
//
// At the main-path shapes (B=16, T=300, Cout 32..256, Cin up to 768) the
// work is 2*K*(Cin+Cout)*Cout flops a frame forward and twice that
// backward, against ~10 tensors of B*T*C floats moved: operations bound
// it (fp32 FMA on CUDA cores), not bytes.  A block computes a 64-frame by
// 64-column tile with a 4x4 register tile a thread; the input tile (with
// its halo of pad frames) and all K taps of a 32-channel weight slice are
// staged in shared memory, so one pair of barriers covers K*32 reduction
// steps, and both operands are read as float4.  Tensor cores (wgmma), TMA
// and a pipelined staging are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 64;            // output frames per block
constexpr int kChunk = 32;            // reduction channels staged per step
constexpr int kXStride = kChunk + 4;  // floats a staged input row takes:
                                      // float4-aligned, rows on other banks
constexpr int kWTile = 64;            // weight-gradient tile, both ways
constexpr int kWRows = 32;            // rows staged per step of wgrad
constexpr int kMaxSmem = 227 * 1024;
constexpr float kSlope = 0.01f;

enum Epilogue {
  kStore = 0,     // out0 = acc + bias
  kBlockOut = 1,  // out0 = a = acc + bias; out1 = leaky(leaky(a)*e0 + e1)
  kMaskGrad = 2,  // out0 = acc * e0 * leaky'(e1)
};

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * kSlope;
}

__device__ __forceinline__ float dleaky(float v) {
  return v >= 0.f ? 1.f : kSlope;
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

// leaky(v) * m, elementwise: how h is read back from a1 and m1
__device__ __forceinline__ float4 masked_leaky(float4 v, float4 m) {
  return make_float4(leaky(v.x) * m.x, leaky(v.y) * m.y, leaky(v.z) * m.z,
                     leaky(v.w) * m.w);
}

// y[b, t, :] = sum_k in[b, t + off_k, :] . W_k   (+ bias), then an epilogue.
//   reverse == 0 (a causal conv):  off_k = k*d - pad, W_k = w[k], w (K, C, N)
//   reverse == 1 (its transpose):  off_k = pad - k*d, W_k = w[k]^T, w (K, N, C)
// `in` is zero outside [0, T).  With in_mask, in is read as
// leaky(in) * in_mask.
struct ConvArgs {
  const float* in;       // (B, T, C)
  const float* in_mask;  // (B, T, C) or null
  const float* w;
  const float* bias;     // (N) or null
  const float* e0;       // (B, T, N) epilogue operands, or null
  const float* e1;
  float* out0;           // (B, T, N)
  float* out1;           // (B, T, N) or null
  int T, C, N, K, dil, reverse, epilogue;
};

// TN output columns and kTileT frames a block; a thread owns R rows
// (strided by the number of row groups) and 4 columns.
template <int TN, int R>
__global__ void __launch_bounds__(kThreads) conv_gemm_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kColGroups = TN / 4;
  constexpr int kRowGroups = kThreads / kColGroups;
  static_assert(R * kRowGroups == kTileT, "tile rows");
  const int pad = (a.K - 1) * a.dil;
  const int xrows = kTileT + pad;
  float* xs = smem;                    // (xrows, kXStride)
  float* ws = smem + xrows * kXStride; // (K, kChunk, TN)
  const int cg = threadIdx.x % kColGroups;
  const int rg = threadIdx.x / kColGroups;
  const int n0 = blockIdx.x * TN;
  const int t0 = blockIdx.y * kTileT;
  const int b = blockIdx.z;
  const int base = a.reverse ? 0 : -pad;  // time of staged row 0, less t0
  const float* inb = a.in + (size_t)b * a.T * a.C;
  const float* maskb =
      a.in_mask ? a.in_mask + (size_t)b * a.T * a.C : nullptr;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[R][4] = {};
  for (int c0 = 0; c0 < a.C; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < xrows * (kChunk / 4); i += kThreads) {
      const int r = i / (kChunk / 4);
      const int c = (i % (kChunk / 4)) * 4;
      const int t = t0 + base + r;
      float4 v = zero4;
      if (t >= 0 && t < a.T && c0 + c < a.C) {
        const size_t off = (size_t)t * a.C + c0 + c;
        v = ld4(inb + off);
        if (maskb) v = masked_leaky(v, ld4(maskb + off));
      }
      st4(xs + r * kXStride + c, v);
    }
    if (!a.reverse) {
      for (int i = threadIdx.x; i < a.K * kChunk * kColGroups;
           i += kThreads) {
        const int n = (i % kColGroups) * 4;
        const int c = (i / kColGroups) % kChunk;
        const int k = i / (kColGroups * kChunk);
        float4 v = zero4;
        if (c0 + c < a.C && n0 + n < a.N)
          v = ld4(a.w + ((size_t)k * a.C + c0 + c) * a.N + n0 + n);
        st4(ws + (k * kChunk + c) * TN + n, v);
      }
    } else {  // W_k[c][n] = w[k][n0 + n][c0 + c]: transposed while staged
      for (int i = threadIdx.x; i < a.K * (kChunk / 4) * TN; i += kThreads) {
        const int n = i % TN;
        const int c = ((i / TN) % (kChunk / 4)) * 4;
        const int k = i / (TN * (kChunk / 4));
        float4 v = zero4;
        if (n0 + n < a.N && c0 + c < a.C)
          v = ld4(a.w + ((size_t)k * a.N + n0 + n) * a.C + c0 + c);
        float* d = ws + (k * kChunk + c) * TN + n;
        d[0] = v.x;
        d[TN] = v.y;
        d[2 * TN] = v.z;
        d[3 * TN] = v.w;
      }
    }
    __syncthreads();
    for (int k = 0; k < a.K; ++k) {
      const int rk = a.reverse ? pad - k * a.dil : k * a.dil;
      const float* xk = xs + (rg + rk) * kXStride;
      const float* wk = ws + k * kChunk * TN + cg * 4;
#pragma unroll 2
      for (int c = 0; c < kChunk; c += 4) {
        const float4 w0 = ld4(wk + (c + 0) * TN);
        const float4 w1 = ld4(wk + (c + 1) * TN);
        const float4 w2 = ld4(wk + (c + 2) * TN);
        const float4 w3 = ld4(wk + (c + 3) * TN);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 x = ld4(xk + i * kRowGroups * kXStride + c);
          fma4(acc[i], x.x, w0);
          fma4(acc[i], x.y, w1);
          fma4(acc[i], x.z, w2);
          fma4(acc[i], x.w, w3);
        }
      }
    }
  }

  const int n = n0 + cg * 4;
  if (n >= a.N) return;  // no barrier follows
  const float4 bias = a.bias ? ld4(a.bias + n) : zero4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = t0 + rg + i * kRowGroups;
    if (t >= a.T) continue;
    const size_t off = ((size_t)b * a.T + t) * a.N + n;
    const float4 v = make_float4(acc[i][0] + bias.x, acc[i][1] + bias.y,
                                 acc[i][2] + bias.z, acc[i][3] + bias.w);
    if (a.epilogue == kStore) {
      st4(a.out0 + off, v);
    } else if (a.epilogue == kBlockOut) {
      st4(a.out0 + off, v);
      const float4 net = masked_leaky(v, ld4(a.e0 + off));
      const float4 res = ld4(a.e1 + off);
      st4(a.out1 + off,
          make_float4(leaky(net.x + res.x), leaky(net.y + res.y),
                      leaky(net.z + res.z), leaky(net.w + res.w)));
    } else {  // kMaskGrad
      const float4 m = ld4(a.e0 + off);
      const float4 z = ld4(a.e1 + off);
      st4(a.out0 + off,
          make_float4(v.x * m.x * dleaky(z.x), v.y * m.y * dleaky(z.y),
                      v.z * m.z * dleaky(z.z), v.w * m.w * dleaky(z.w)));
    }
  }
}

cudaError_t launch_conv(const ConvArgs& a, int B, cudaStream_t stream) {
  const int pad = (a.K - 1) * a.dil;
  const bool narrow = a.N <= 32;
  const int tn = narrow ? 32 : 64;
  const size_t bytes =
      ((size_t)(kTileT + pad) * kXStride + (size_t)a.K * kChunk * tn) *
      sizeof(float);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = narrow ? conv_gemm_kernel<32, 2> : conv_gemm_kernel<64, 4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + tn - 1) / tn, (a.T + kTileT - 1) / kTileT, B);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// gz = g * leaky'(leaky(a2)*m2 + res) -> dres;  d_a2 = gz * m2 * leaky'(a2)
__global__ void __launch_bounds__(kThreads)
block_out_grad_kernel(const float* g, const float* a2, const float* m2,
                      const float* res, float* dres, float* d_a2,
                      size_t n4) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 gv = ld4(g + 4 * i);
  const float4 av = ld4(a2 + 4 * i);
  const float4 mv = ld4(m2 + 4 * i);
  const float4 rv = ld4(res + 4 * i);
  const float4 net = masked_leaky(av, mv);
  const float4 gz = make_float4(
      gv.x * dleaky(net.x + rv.x), gv.y * dleaky(net.y + rv.y),
      gv.z * dleaky(net.z + rv.z), gv.w * dleaky(net.w + rv.w));
  st4(dres + 4 * i, gz);
  st4(d_a2 + 4 * i,
      make_float4(gz.x * mv.x * dleaky(av.x), gz.y * mv.y * dleaky(av.y),
                  gz.z * mv.z * dleaky(av.z), gz.w * mv.w * dleaky(av.w)));
}

// out[s][k][ca][cd] = sum over the batch rows b of share s and all t of
//   act[b, t - (K-1-k)*d, ca] * d[b, t, cd]      (act = 0 before time 0)
// One block owns one (k, 64 x 64) tile of one share and adds its rows up in
// a fixed order.  With act_mask, act is read as leaky(act) * act_mask.
struct WgradArgs {
  const float* act;       // (B, T, Ca)
  const float* act_mask;  // (B, T, Ca) or null
  const float* d;         // (B, T, Cd)
  float* out;             // (S, K, Ca, Cd)
  int B, T, Ca, Cd, K, dil, S;
};

__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradArgs p) {
  __shared__ __align__(16) float as[kWRows][kWTile];
  __shared__ __align__(16) float ds[kWRows][kWTile];
  const int tiles_a = (p.Ca + kWTile - 1) / kWTile;
  const int k = blockIdx.y / tiles_a;
  const int ca0 = (blockIdx.y % tiles_a) * kWTile;
  const int cd0 = blockIdx.x * kWTile;
  const int s = blockIdx.z;
  const int shift = (p.K - 1 - k) * p.dil;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b_lo = (int)((long long)p.B * s / p.S);
  const int b_hi = (int)((long long)p.B * (s + 1) / p.S);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[4][4] = {};
  for (int b = b_lo; b < b_hi; ++b) {
    const float* actb = p.act + (size_t)b * p.T * p.Ca;
    const float* maskb =
        p.act_mask ? p.act_mask + (size_t)b * p.T * p.Ca : nullptr;
    const float* db = p.d + (size_t)b * p.T * p.Cd;
    // frames before `shift` meet the causal pad of act: nothing to add
    for (int r0 = shift; r0 < p.T; r0 += kWRows) {
      __syncthreads();  // the previous step's readers are done
      for (int i = threadIdx.x; i < kWRows * (kWTile / 4); i += kThreads) {
        const int r = i / (kWTile / 4);
        const int c = (i % (kWTile / 4)) * 4;
        const int t = r0 + r;
        float4 va = zero4, vd = zero4;
        if (t < p.T) {
          if (ca0 + c < p.Ca) {
            const size_t off = (size_t)(t - shift) * p.Ca + ca0 + c;
            va = ld4(actb + off);
            if (maskb) va = masked_leaky(va, ld4(maskb + off));
          }
          if (cd0 + c < p.Cd) vd = ld4(db + (size_t)t * p.Cd + cd0 + c);
        }
        st4(&as[r][c], va);
        st4(&ds[r][c], vd);
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < kWRows; ++r) {
        const float4 av = ld4(&as[r][ty * 4]);
        const float4 dv = ld4(&ds[r][tx * 4]);
        fma4(acc[0], av.x, dv);
        fma4(acc[1], av.y, dv);
        fma4(acc[2], av.z, dv);
        fma4(acc[3], av.w, dv);
      }
    }
  }
  const int cd = cd0 + tx * 4;
  if (cd >= p.Cd) return;
  float* out = p.out + (size_t)s * p.K * p.Ca * p.Cd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ca = ca0 + ty * 4 + i;
    if (ca < p.Ca)
      st4(out + ((size_t)k * p.Ca + ca) * p.Cd + cd,
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// out[i] = part[0][i] + part[1][i] + ... in share order
__global__ void __launch_bounds__(kThreads)
reduce_shares_kernel(const float* part, float* out, size_t n4, int S) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 sum = ld4(part + 4 * i);
  for (int s = 1; s < S; ++s) {
    const float4 v = ld4(part + 4 * (s * n4 + i));
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  st4(out + 4 * i, sum);
}

// out[c] = sum_r d[r][c]: 32 columns a block, 32 lanes of rows a column,
// the lanes' sums added in lane order
__global__ void __launch_bounds__(1024)
column_sum_kernel(const float* d, float* out, int rows, int C) {
  __shared__ float part[32][33];
  const int cx = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
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

cudaError_t launch_wgrad(const float* act, const float* act_mask,
                         const float* d, float* part, float* out, int B,
                         int T, int Ca, int Cd, int K, int dil, int S,
                         cudaStream_t stream) {
  if (S < 1 || S > B || (S > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  WgradArgs p{act, act_mask, d, S > 1 ? part : out, B, T, Ca, Cd, K, dil, S};
  const int tiles_a = (Ca + kWTile - 1) / kWTile;
  dim3 grid((Cd + kWTile - 1) / kWTile, tiles_a * K, S);
  wgrad_kernel<<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const size_t n4 = (size_t)K * Ca * Cd / 4;
  reduce_shares_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(part, out, n4, S);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int Cin, int Cout, int K, int dil) {
  return B <= 0 || B > 65535 || T <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 ||
         dil <= 0 || Cin % 4 || Cout % 4 ||
         (T + kTileT - 1) / kTileT > 65535;
}

}  // namespace

extern "C" {

// Forward of the train-mode block on `stream`: writes a1, a2 (kept for the
// backward) and out, all (B, T, Cout).  x (B, T, Cin); w1 (K, Cin, Cout);
// w2 (K, Cout, Cout); m1, m2, res (B, T, Cout).  Cin and Cout must be
// multiples of 4.  Returns cudaSuccess, the error of an attribute call or a
// launch, or cudaErrorInvalidValue for a shape the kernels do not take.
int fvt_tcn_block_train_forward(const void* x, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, const void* m1,
                                const void* m2, const void* res, void* a1,
                                void* a2, void* out, int B, int T, int Cin,
                                int Cout, int K, int dil, void* stream) {
  if (bad_shape(B, T, Cin, Cout, K, dil)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ConvArgs c1{(const float*)x, nullptr, (const float*)w1, (const float*)b1,
              nullptr, nullptr, (float*)a1, nullptr,
              T, Cin, Cout, K, dil, 0, kStore};
  cudaError_t err = launch_conv(c1, B, st);
  if (err != cudaSuccess) return (int)err;
  ConvArgs c2{(const float*)a1, (const float*)m1, (const float*)w2,
              (const float*)b2, (const float*)m2, (const float*)res,
              (float*)a2, (float*)out, T, Cout, Cout, K, dil, 0, kBlockOut};
  return (int)launch_conv(c2, B, st);
}

// Backward of the block for the cotangent g (B, T, Cout) of out.  Writes dx
// (B, T, Cin), dw1 (K, Cin, Cout), db1 (Cout), dw2 (K, Cout, Cout), db2
// (Cout), dres (B, T, Cout).  d_a2 and d_a1 are scratch of (B, T, Cout);
// part1 / part2 are scratch of (S1, K, Cin, Cout) / (S2, K, Cout, Cout)
// floats for the weight gradients' batch shares and may be null when the
// share count is 1.  1 <= S <= B.
int fvt_tcn_block_train_backward(
    const void* x, const void* w1, const void* w2, const void* m1,
    const void* m2, const void* res, const void* a1, const void* a2,
    const void* g, void* d_a2, void* d_a1, void* part1, void* part2,
    void* dx, void* dw1, void* db1, void* dw2, void* db2, void* dres, int B,
    int T, int Cin, int Cout, int K, int dil, int S1, int S2,
    void* stream) {
  if (bad_shape(B, T, Cin, Cout, K, dil)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n4 = (size_t)B * T * Cout / 4;
  block_out_grad_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads),
                          kThreads, 0, st>>>(
      (const float*)g, (const float*)a2, (const float*)m2,
      (const float*)res, (float*)dres, (float*)d_a2, n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // d_a1 = (d_a2 run back through conv2) * m1 * leaky'(a1)
  ConvArgs ch{(const float*)d_a2, nullptr, (const float*)w2, nullptr,
              (const float*)m1, (const float*)a1, (float*)d_a1, nullptr,
              T, Cout, Cout, K, dil, 1, kMaskGrad};
  err = launch_conv(ch, B, st);
  if (err != cudaSuccess) return (int)err;
  // dx = d_a1 run back through conv1
  ConvArgs cx{(const float*)d_a1, nullptr, (const float*)w1, nullptr,
              nullptr, nullptr, (float*)dx, nullptr,
              T, Cout, Cin, K, dil, 1, kStore};
  err = launch_conv(cx, B, st);
  if (err != cudaSuccess) return (int)err;

  // dw2 from h = leaky(a1)*m1 and d_a2; dw1 from x and d_a1
  err = launch_wgrad((const float*)a1, (const float*)m1, (const float*)d_a2,
                     (float*)part2, (float*)dw2, B, T, Cout, Cout, K, dil,
                     S2, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_wgrad((const float*)x, nullptr, (const float*)d_a1,
                     (float*)part1, (float*)dw1, B, T, Cin, Cout, K, dil, S1,
                     st);
  if (err != cudaSuccess) return (int)err;

  const unsigned col_blocks = (unsigned)((Cout + 31) / 32);
  column_sum_kernel<<<col_blocks, 1024, 0, st>>>((const float*)d_a2,
                                                 (float*)db2, B * T, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum_kernel<<<col_blocks, 1024, 0, st>>>((const float*)d_a1,
                                                 (float*)db1, B * T, Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
