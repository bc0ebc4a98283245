// int8 serving (--serve_quant int8 | int8_static): the earlier designs of
// the activations' quantisation and of the s8 3x3 convolution, both timed
// and on no path (quantize_int8_fused.cu is the quantisation's kernel,
// conv3x3_s8_wgmma.cu the conv's).
//
// These replace no Pallas kernel.  fvt_tpu computes its int8 conv
// (fvt_tpu/ops/quant.py:75-108, conv3x3_int8) as one XLA convolution with s8
// operands and an int32 accumulator, which XLA lowers onto the TPU's int8
// matrix path.  PyTorch has no int8 convolution on CUDA, so the port brings
// its own.  Their plain versions are in fvt_tpu_torch/ops/quant.py
// (quantize_symmetric, conv3x3_s8_ref), and both kernels equal them bit for
// bit:
//   - the amax is a max over the float bits of |x| (for |x| >= 0 a float's
//     bits order like an unsigned int's), so it is exact in any order;
//   - scale = max(amax, 1e-12) / 127 and x / scale are IEEE divisions
//     (__fdiv_rn; the library is built without --use_fast_math), rounded
//     half to even (rintf) and clipped to +-127, as jnp.round and jnp.clip;
//   - the int32 sums are exact; the accumulator goes to float32 with
//     __int2float_rn (a sum reaches 9*512*127^2 ~ 7.4e7 > 2^24) and is
//     multiplied by (x_scale * w_scale[co]), that product formed first,
//     both with __fmul_rn so that nothing is contracted.
//
// 1. fvt_quantize_int8 (ops/quant.py quantize_int8_atomic; on no path since
//    quantize_int8_fused.cu, which also applies the conv's producer as it
//    loads x, kept to be timed beside it on the producer's output):
//    x (float32 or bfloat16, widened exactly) -> q (s8),
//    the same element order (NHWC as the conv reads it).  Dynamic: a first
//    launch takes the per-tensor amax (atomicMax of each block's max into one
//    word, zeroed by a memset), the second divides by the scale it derives
//    and writes that scale for the conv's epilogue.  Static (--serve_quant
//    int8_static): the calibrated scale is given and the amax launch is
//    skipped.  A data-parallel serving call runs the two launches apart,
//    the ranks' amaxes reduced between them, so that the scale spans the
//    call.  Bound by bytes: x read twice (dynamic) and q written once.
//
// 2. fvt_conv3x3_s8_mma_forward (ops/quant.py conv3x3_s8_mma; on no path
//    since the wgmma design of conv3x3_s8_wgmma.cu, kept to be timed beside
//    it): y (N, Ho, Wo, Co) = conv3x3(q, wq), padding 1, stride 1 or 2, an
//    implicit GEMM of M = N*Ho*Wo pixels by Co by K = 9*C on
//    mma.sync.m16n8k32 s8 tensor-core tiles.  A block takes 128 pixels by
//    128 output channels; its K loop walks the nine taps and, in each, the
//    channels 64 at a time.  Each step copies the 128 pixels' s8 rows of the
//    tap (16-byte cp.async, zero-filled where the tap falls in the padding
//    or past C: q(0) = 0, so zero padding commutes with the quantisation)
//    and the 128 channels' weight rows (wq is (Co, 9, C): K-major, as the
//    s8 mma takes B) into a three-stage ring in shared memory.  The stride
//    is the address step between neighbouring pixels' rows, so stride 2
//    costs nothing more.  Rows are padded to 80 bytes so that the
//    fragments' 32-bit loads hit 32 banks.  Eight warps, 2 x 4, each 64
//    pixels by 32 channels: 4 x 4 mma tiles of int32 sums in registers.
//    The epilogue scales and stores float32 or bfloat16 (rounded to nearest
//    even) straight from the registers.  It ran at ~20% of its bound (2*M*
//    Co*9*C int8 operations over 1979 TOPS dense): every operand fragment
//    through a 32-bit ld.shared, the copies made by the threads, x copied
//    once a tap, no persistent grid (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// max of the bits of |x| over 16 values a step; bfloat16's are the high
// halves of float32's
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const void* __restrict__ x, long long n16,
            unsigned* __restrict__ amax) {
  unsigned m = 0;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16;
       i += step) {
    if (BF16) {
      const uint4* p = reinterpret_cast<const uint4*>(x) + 2 * i;
      const uint4 a = p[0], b = p[1];
      const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        m = max(m, (w[k] << 16) & 0x7fffffffu);
        m = max(m, w[k] & 0x7fff0000u);
      }
    } else {
      const float4* p = reinterpret_cast<const float4*>(x) + 4 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = p[k];
        m = max(max(m, abs_bits(v.x)), abs_bits(v.y));
        m = max(max(m, abs_bits(v.z)), abs_bits(v.w));
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ unsigned red[kThreads / 32];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0u;
#pragma unroll
    for (int o = 4; o; o >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(amax, m);
  }
}

__device__ __forceinline__ unsigned q8(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return (unsigned)__float2int_rn(r) & 0xffu;
}

__device__ __forceinline__ unsigned pack4(const float* v, float s) {
  return q8(v[0], s) | (q8(v[1], s) << 8) | (q8(v[2], s) << 16) |
         (q8(v[3], s) << 24);
}

// q = clip(rint(x / scale), -127, 127), 16 values a step; scale is
// scale_in's, or max(amax, 1e-12) / 127, then written to scale_out
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const void* __restrict__ x, long long n16,
                const float* __restrict__ scale_in,
                const unsigned* __restrict__ amax, float* __restrict__ scale_out,
                uint4* __restrict__ q) {
  float s;
  if (scale_in != nullptr) {
    s = *scale_in;
  } else {
    s = __fdiv_rn(fmaxf(__uint_as_float(*amax), 1e-12f), 127.0f);
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  }
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16;
       i += step) {
    float v[16];
    if (BF16) {
      const uint4* p = reinterpret_cast<const uint4*>(x) + 2 * i;
      const uint4 a = p[0], b = p[1];
      const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    } else {
      const float4* p = reinterpret_cast<const float4*>(x) + 4 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 f = p[k];
        v[4 * k] = f.x;
        v[4 * k + 1] = f.y;
        v[4 * k + 2] = f.z;
        v[4 * k + 3] = f.w;
      }
    }
    q[i] = make_uint4(pack4(v, s), pack4(v + 4, s), pack4(v + 8, s),
                      pack4(v + 12, s));
  }
}

// the s8 conv: tiles, ring and shared-memory rows
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int PITCH = BK + 16;  // bytes a row: 20 words, conflict-free
constexpr int SMEM_BYTES = STAGES * (BM + BN) * PITCH;  // 61440

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* y, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ wscale,
                  const float* __restrict__ xscale, OutT* __restrict__ y,
                  int H, int W, int C, int Co, int stride, int Ho, int Wo,
                  long long M) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                        // [STAGES][BM][PITCH]
  unsigned char* Bs = smem + STAGES * BM * PITCH;  // [STAGES][BN][PITCH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int g = lane >> 2, t4 = lane & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int cb = (C + BK - 1) / BK;  // channel slices a tap
  const int KT = 9 * cb;

  // the two pixel rows and two weight rows this thread copies, 16 bytes
  // of each at byte `chunk` of a step's 64 channels
  const int chunk = (tid & 3) * 16;
  const int row0 = tid >> 2;
  const int hw = Ho * Wo;
  long long pix[2];
  int hb[2], wb[2];
  bool mv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + row0 + 64 * i;
    mv[i] = m < M;
    const long long mm = mv[i] ? m : 0;
    const int n = (int)(mm / hw), r = (int)(mm % hw);
    pix[i] = (long long)n * H * W;
    hb[i] = (r / Wo) * stride - 1;
    wb[i] = (r % Wo) * stride - 1;
  }

  auto load = [&](int stage, int t) {
    const int tap = t / cb, c = (t % cb) * BK + chunk;
    const int ky = tap / 3, kx = tap % 3;
    const bool cv = c < C;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 64 * i;
      const int hi = hb[i] + ky, wi = wb[i] + kx;
      const bool va = cv && mv[i] && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const int8_t* sa =
          va ? x + ((pix[i] + (long long)hi * W + wi) * C + c) : x;
      cp_async16(As + (stage * BM + row) * PITCH + chunk, sa, va);
      const int co = co0 + row;
      const bool vb = cv && co < Co;
      const int8_t* sb = vb ? w + (((long long)co * 9 + tap) * C + c) : w;
      cp_async16(Bs + (stage * BN + row) * PITCH + chunk, sb, vb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < KT; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t landed; step t-1's stage is free
    const int tn = t + STAGES - 1;
    if (tn < KT) load(tn % STAGES, tn);
    cp_async_commit();
    const unsigned char* a = As + (t % STAGES) * BM * PITCH;
    const unsigned char* b = Bs + (t % STAGES) * BN * PITCH;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      const int k = ks + t4 * 4;
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* r = a + (wm * 64 + mt * 16 + g) * PITCH + k;
        af[mt][0] = *reinterpret_cast<const unsigned*>(r);
        af[mt][1] = *reinterpret_cast<const unsigned*>(r + 8 * PITCH);
        af[mt][2] = *reinterpret_cast<const unsigned*>(r + 16);
        af[mt][3] = *reinterpret_cast<const unsigned*>(r + 8 * PITCH + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* r = b + (wn * 32 + nt * 8 + g) * PITCH + k;
        bf[nt][0] = *reinterpret_cast<const unsigned*>(r);
        bf[nt][1] = *reinterpret_cast<const unsigned*>(r + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  const float xs = *xscale;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int co = co0 + wn * 32 + nt * 8 + t4 * 2;
    if (co >= Co) continue;  // Co % 8 == 0: a tile of 8 is in or out
    const float s0 = __fmul_rn(xs, wscale[co]);
    const float s1 = __fmul_rn(xs, wscale[co + 1]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (m < M)
          store2(y + m * Co + co,
                 __fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), s0),
                 __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), s1));
      }
  }
}

int grid_for(long long n16) {
  const long long blocks = (n16 + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 8 ? blocks : 132 * 8);
}

template <typename OutT>
int launch_conv(const void* xq, const void* wq, const void* wscale,
                const void* xscale, void* y, int H, int W, int C, int Co,
                int stride, int Ho, int Wo, long long M, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_s8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (Co + BN - 1) / BN);
  conv3x3_s8_kernel<OutT><<<grid, kThreads, SMEM_BYTES, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(wscale), static_cast<const float*>(xscale),
      static_cast<OutT*>(y), H, W, C, Co, stride, Ho, Wo, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q = quantize(x) on `stream`; x float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// n values, n a multiple of 16, x and q 16-byte aligned.  scale_in null:
// dynamic, amax (one uint32 word of device memory) takes the bits of
// max|x| and scale_out (one float) the scale; else scale_in (one float of
// device memory) is the scale and amax and scale_out are not touched.
// q null, dynamic: the amax launch alone (a sharded call reduces the
// ranks' amaxes before its quantise launch, which then takes scale_in).
// Returns the CUDA error of the memset or of a launch, or
// cudaErrorInvalidValue for a size the kernels do not take.
int fvt_quantize_int8(const void* x, int bf16, long long n, void* amax,
                      const void* scale_in, void* scale_out, void* q,
                      void* stream) {
  if (n <= 0 || n % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n16 = n / 16;
  const int blocks = grid_for(n16);
  const float* sin = static_cast<const float*>(scale_in);
  unsigned* am = static_cast<unsigned*>(amax);
  if (sin == nullptr) {
    const cudaError_t e = cudaMemsetAsync(am, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return e;
    if (bf16)
      amax_kernel<true><<<blocks, kThreads, 0, s>>>(x, n16, am);
    else
      amax_kernel<false><<<blocks, kThreads, 0, s>>>(x, n16, am);
    const cudaError_t l = cudaGetLastError();
    if (l != cudaSuccess) return l;
  }
  if (q == nullptr) return sin == nullptr ? cudaSuccess : cudaErrorInvalidValue;
  if (bf16)
    quantize_kernel<true><<<blocks, kThreads, 0, s>>>(
        x, n16, sin, am, static_cast<float*>(scale_out),
        static_cast<uint4*>(q));
  else
    quantize_kernel<false><<<blocks, kThreads, 0, s>>>(
        x, n16, sin, am, static_cast<float*>(scale_out),
        static_cast<uint4*>(q));
  return cudaGetLastError();
}

// The mma.sync design (on no path): y = conv3x3(xq, wq) * (xscale *
// wscale[co]) on `stream`: xq (N, H, W, C)
// s8, wq (Co, 9, C) s8 (tap = 3*ky + kx), wscale (Co,) float32, xscale one
// float32 of device memory, y (N, Ho, Wo, Co) float32 (bf16_out = 0) or
// bfloat16, Ho = (H - 1) / stride + 1 (padding 1); contiguous and 16-byte
// aligned.  C a multiple of 16, Co of 8, stride 1 or 2.  Returns the error
// of the attribute call or of the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
int fvt_conv3x3_s8_mma_forward(const void* xq, const void* wq,
                               const void* wscale, const void* xscale,
                               void* y, int bf16_out, int N, int H, int W,
                               int C, int Co, int stride, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 16 || Co % 8 ||
      (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const long long M = (long long)N * Ho * Wo;
  if ((M + BM - 1) / BM > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_out)
    return launch_conv<__nv_bfloat16>(xq, wq, wscale, xscale, y, H, W, C, Co,
                                      stride, Ho, Wo, M, s);
  return launch_conv<float>(xq, wq, wscale, xscale, y, H, W, C, Co, stride,
                            Ho, Wo, M, s);
}

}  // extern "C"
