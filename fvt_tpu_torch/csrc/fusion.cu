// Fused eval-mode LFAN multimodal fusion block, fp32, for Hopper (sm_90a).
//
// Replaces fvt_tpu/ops/fusion_pallas.py::_fusion_kernel (the Pallas kernel
// behind fused_multimodal_fusion).  Per frame it computes the whole
// MultimodalTransformerEncoder of models/fusion.py:22-90:
//
//   qkv_m = x_m @ Wqkv_m + b_m                 packed head-major, [q|k|v]
//                                              inside each head
//   for each head and modality slot m1:
//     p = softmax_m2(q_m1 . k_m2 / sqrt(hd));  v' = sum_m2 p v_m2 + v_m1
//   cat = v' ordered head-major, then modality
//   y = LayerNorm(cat @ Wo + bo), eps 1e-5, no residual
//
// What bounds it on the card.  Frames are independent (the attention runs
// over the M <= 7 modality slots, not over time), so tiles of kFrames frames
// of the flattened B*T axis need no halo.  At the main path's shapes the
// work is ~37 k multiply-adds a frame against ~1.5 KB of input and output a
// frame, so device memory is not the limit; what is, is reading the weights
// (~147 KB fp32) once per multiply-add.  Read from global memory they do
// not stay in L1 beside the blocks' shared memory, and every multiply-add
// waits on L2.  So the blocks are persistent, one per SM: each copies all
// weights into shared memory once and then walks over frame tiles.
//
// Where the weights and a tile's activations do not fit the 227 KB of
// shared memory together (more than four modalities, or four wide ones:
// video, bert and cnn_res50 at 128 with mfcc, whose Wqkv alone is 160 KB),
// a second instantiation keeps in shared memory the activations, the
// vectors and whichever weight matrices fit, and reads the rest (Wo, then
// Wqkv) from global memory through the read-only path: at seven modalities
// they are 0.4 MB, which stays in the 50 MB L2.  The caller picks the
// route from the layout's size (ops/fusion.py::fusion_route): the first of
// all weights staged, Wo read, both read that fits.  The main path's three
// modalities (174 KB) take the first, the kernel it was.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 8;  // frames per tile
constexpr int kMaxModal = 7;  // the LFAN modalities with embedding sizes
constexpr int kMaxSmem = 227 * 1024;
// a route's weights read from global memory, a bit each (0: none)
constexpr int kWqkvGlobal = 1, kWoGlobal = 2;

struct FusionArgs {
  const float* x[kMaxModal];     // (N, C_m)
  const float* wqkv[kMaxModal];  // (C_m, 3E)
  const float* bqkv[kMaxModal];  // (3E)
  int C[kMaxModal];
  const float* wo;    // (E*M, E*M)
  const float* bo;    // (E*M)
  const float* ln_w;  // (E*M)
  const float* ln_b;  // (E*M)
  float* out;         // (N, E*M)
  int N, M, E, H;
};

// Shared-memory layout of a route, in floats; every offset is a multiple
// of 4.  A weight matrix read from global memory takes no room.
struct Smem {
  int wq, bq, wo, bo, lnw, lnb, xs, qkv, cat, o, total;
  __host__ __device__ Smem(int ctot, int M, int E, int route) {
    const int e3 = 3 * E, em = E * M;
    wq = 0;                       // per modality (C_m, 3E), stacked
    bq = wq + (route & kWqkvGlobal ? 0 : ctot * e3);  // (M, 3E)
    wo = bq + M * e3;             // (EM, EM)
    bo = wo + (route & kWoGlobal ? 0 : em * em);
    lnw = bo + em;
    lnb = lnw + em;
    xs = lnb + em;                // (kFrames, ctot)
    qkv = xs + kFrames * ctot;    // (kFrames, M, 3E)
    cat = qkv + kFrames * M * e3; // (kFrames, EM)
    o = cat + kFrames * em;       // (kFrames, EM)
    total = o + kFrames * em;
  }
};

// n floats, n % 4 == 0, both pointers 16-byte aligned
__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < n / 4; i += kThreads) d[i] = s[i];
}

// kRoute: which weight matrices are read from global memory (the header
// note); 0 stages them all.
template <int kRoute>
__global__ void __launch_bounds__(kThreads) fusion_kernel(FusionArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int M = a.M, E = a.E, H = a.H;
  const int hd = E / H;
  const int e3 = 3 * E;
  const int em = E * M;
  const float scale = 1.f / sqrtf((float)hd);
  int off[kMaxModal];
  int ctot = 0;
  for (int m = 0; m < M; ++m) {
    off[m] = ctot;
    ctot += a.C[m];
  }
  const Smem lay(ctot, M, E, kRoute);
  float* wq = smem + lay.wq;
  float* bq = smem + lay.bq;
  float* wo = smem + lay.wo;
  float* bo = smem + lay.bo;
  float* lnw = smem + lay.lnw;
  float* lnb = smem + lay.lnb;
  float* xs = smem + lay.xs;
  float* qkv = smem + lay.qkv;
  float* cat = smem + lay.cat;
  float* o = smem + lay.o;

  for (int m = 0; m < M; ++m) {
    if constexpr (!(kRoute & kWqkvGlobal))
      copy4(wq + off[m] * e3, a.wqkv[m], a.C[m] * e3);
    copy4(bq + m * e3, a.bqkv[m], e3);
  }
  if constexpr (!(kRoute & kWoGlobal)) copy4(wo, a.wo, em * em);
  copy4(bo, a.bo, em);
  copy4(lnw, a.ln_w, em);
  copy4(lnb, a.ln_b, em);

  const int ntiles = (a.N + kFrames - 1) / kFrames;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kFrames;
    const int nf = min(kFrames, a.N - n0);
    __syncthreads();  // weights staged / previous tile's readers are done
    for (int m = 0; m < M; ++m) {
      const int c = a.C[m];
      const float* src = a.x[m] + (size_t)n0 * c;
      for (int i = threadIdx.x; i < nf * c; i += kThreads)
        xs[(i / c) * ctot + off[m] + i % c] = src[i];
    }
    __syncthreads();

    // packed qkv projection of every modality
    for (int i = threadIdx.x; i < nf * M * e3; i += kThreads) {
      const int j = i % e3;
      const int m = (i / e3) % M;
      const int f = i / (e3 * M);
      const float* xr = xs + f * ctot + off[m];
      float s = bq[m * e3 + j];
      if constexpr (kRoute & kWqkvGlobal) {
        const float* w = a.wqkv[m] + j;
        for (int c = 0; c < a.C[m]; ++c) s = fmaf(xr[c], __ldg(w + c * e3), s);
      } else {
        const float* w = wq + off[m] * e3 + j;
        for (int c = 0; c < a.C[m]; ++c) s = fmaf(xr[c], w[c * e3], s);
      }
      qkv[(f * M + m) * e3 + j] = s;
    }
    __syncthreads();

    // attention over the modality slots, +V residual
    for (int i = threadIdx.x; i < nf * H * M * hd; i += kThreads) {
      const int d = i % hd;
      const int m1 = (i / hd) % M;
      const int h = (i / (hd * M)) % H;
      const int f = i / (hd * M * H);
      const float* row = qkv + f * M * e3 + h * 3 * hd;  // slot 0, head h
      const float* q = row + m1 * e3;
      float logit[kMaxModal];
      float mx = -INFINITY;
      for (int m2 = 0; m2 < M; ++m2) {
        const float* k = row + m2 * e3 + hd;
        float s = 0.f;
        for (int dd = 0; dd < hd; ++dd) s = fmaf(q[dd], k[dd], s);
        logit[m2] = s * scale;
        mx = fmaxf(mx, logit[m2]);
      }
      float denom = 0.f;
      for (int m2 = 0; m2 < M; ++m2) {
        logit[m2] = expf(logit[m2] - mx);
        denom += logit[m2];
      }
      float val = 0.f;
      for (int m2 = 0; m2 < M; ++m2)
        val = fmaf(logit[m2] / denom, row[m2 * e3 + 2 * hd + d], val);
      cat[f * em + (h * M + m1) * hd + d] = val + row[m1 * e3 + 2 * hd + d];
    }
    __syncthreads();

    // output projection
    for (int i = threadIdx.x; i < nf * em; i += kThreads) {
      const int j = i % em;
      const int f = i / em;
      const float* cr = cat + f * em;
      float s = bo[j];
      if constexpr (kRoute & kWoGlobal) {
        for (int c = 0; c < em; ++c)
          s = fmaf(cr[c], __ldg(a.wo + c * em + j), s);
      } else {
        for (int c = 0; c < em; ++c) s = fmaf(cr[c], wo[c * em + j], s);
      }
      o[f * em + j] = s;
    }
    __syncthreads();

    // LayerNorm, one warp per frame
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int f = warp; f < nf; f += kThreads / 32) {
      const float* orow = o + f * em;
      float s = 0.f;
      for (int j = lane; j < em; j += 32) s += orow[j];
      for (int w = 16; w > 0; w /= 2) s += __shfl_xor_sync(0xffffffffu, s, w);
      const float mean = s / em;
      float v = 0.f;
      for (int j = lane; j < em; j += 32) {
        const float dv = orow[j] - mean;
        v = fmaf(dv, dv, v);
      }
      for (int w = 16; w > 0; w /= 2) v += __shfl_xor_sync(0xffffffffu, v, w);
      const float inv = 1.f / sqrtf(v / em + 1e-5f);
      float* dst = a.out + (size_t)(n0 + f) * em;
      for (int j = lane; j < em; j += 32)
        dst[j] = (orow[j] - mean) * inv * lnw[j] + lnb[j];
    }
  }
}


template <int kRoute>
cudaError_t launch(const FusionArgs& a, int bytes, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fusion_kernel<kRoute>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return err;
  const int ntiles = (a.N + kFrames - 1) / kFrames;
  fusion_kernel<kRoute>
      <<<ntiles < sms ? ntiles : sms, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the fusion block on `stream` over N frames of M modalities, M
// from 1 to 7: ptrs (a host array) holds the M pointers to each modality's
// x (N, C_m), then the M to its Wqkv (C_m, 3E), then the M to its bqkv
// (3E), every one 16-byte aligned; c (a host array) the M widths C_m.  `route` names the weight matrices read
// from global memory: 0 (all in shared memory), kWoGlobal, or kWqkvGlobal
// | kWoGlobal.
// Returns cudaSuccess, the error of a device query, the attribute call or
// the launch (cudaGetLastError), or cudaErrorInvalidValue for shapes the
// kernel does not take (widths not multiples of 4, more than 7 modalities)
// or a route whose layout is above shared memory.
int fvt_fusion_forward(const void* const* ptrs, const int* c, const void* wo,
                       const void* bo, const void* ln_w, const void* ln_b,
                       void* out, int N, int M, int E, int H, int route,
                       void* stream) {
  if (N <= 0 || M <= 0 || M > kMaxModal || E <= 0 || H <= 0 || E % H ||
      E % 4 ||
      (route != 0 && route != kWoGlobal && route != (kWqkvGlobal | kWoGlobal)))
    return (int)cudaErrorInvalidValue;
  FusionArgs a{};
  int ctot = 0;
  for (int m = 0; m < M; ++m) {
    if (c[m] <= 0 || c[m] % 4) return (int)cudaErrorInvalidValue;
    a.x[m] = (const float*)ptrs[m];
    a.wqkv[m] = (const float*)ptrs[M + m];
    a.bqkv[m] = (const float*)ptrs[2 * M + m];
    a.C[m] = c[m];
    ctot += c[m];
  }
  a.wo = (const float*)wo;
  a.bo = (const float*)bo;
  a.ln_w = (const float*)ln_w;
  a.ln_b = (const float*)ln_b;
  a.out = (float*)out;
  a.N = N, a.M = M, a.E = E, a.H = H;
  const long long bytes =
      (long long)Smem(ctot, M, E, route).total * (long long)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) return (int)launch<0>(a, (int)bytes, st);
  if (route == kWoGlobal) return (int)launch<kWoGlobal>(a, (int)bytes, st);
  return (int)launch<kWqkvGlobal | kWoGlobal>(a, (int)bytes, st);
}

}  // extern "C"
