// int8 serving (--serve_quant int8 | int8_static): the activations'
// quantisation pass, with the eval bn1 or PReLU that produces a quantised
// conv's input applied as the pass loads that input.
//
// It replaces no Pallas kernel.  fvt_tpu quantises a conv's input with XLA
// elementwise ops and a reduction (fvt_tpu/ops/quant.py:62-108), which XLA
// fuses into the producer's epilogue.  The plain version is
// fvt_tpu_torch/ops/quant.py quantize_int8_ref (prologue_ref, then the
// quantisation).  The earlier design of the pass, fvt_quantize_int8 in
// conv3x3_int8.cu (a memset, an amax launch with one atomicMax a block and
// a quantise launch, on the output of a producer run as a pass of its own),
// is kept there, timed and on no path.
//
// What it computes, bit for bit the plain version:
//   v = prologue(x) in x's type, each step rounded as PyTorch rounds a
//       bfloat16 op (in float32, then once to bfloat16):
//       none:  v = x
//       bn1:   v = ((x - mean_c) * inv_c) + bias_c, three IEEE operations,
//              never contracted
//       PReLU: v = x >= 0 ? x : x * alpha_c
//   dynamic: amax = max |v| (a max of the float bits of |v|, exact in any
//            order) and scale = max(amax, 1e-12) / 127 (an IEEE division);
//   static:  the scale is given (scale_in);
//   q = clip(rint(v / scale), -127, 127), rint half to even.
//
// Bound by bytes: a dynamic call reads x twice and writes q once (5 bytes a
// value in bfloat16, 9 in float32), a static call reads x once (3 and 5).
// Folding the producer in saves the producer's own pass over the tensor
// (x read and its output written: 4 bytes a value in bfloat16, 8 in
// float32).  The design:
//   - Pass A (dynamic only).  A persistent grid, sized from the device's SM
//     count and the kernel's occupancy (read once a device), walks x in
//     chunks of 16 values, which are 16 channels of one pixel since C is a
//     multiple of 16: 16-byte loads, the next step's issued before this
//     step's work (two chunks a step in bfloat16, one in float32), the
//     prologue in registers, the |v| max reduced in the block.  Each block
//     writes its max to partials[block]: no memset and no atomic.
//   - Pass B.  Each block first reduces the partials (a few thousand bytes,
//     L2 hits) into the amax and the scale, and block 0 writes both out,
//     for the caller and for the s8 conv's epilogue.  Then it applies the
//     prologue and quantises, walking x from its end, so that its first
//     reads meet what pass A left in the 50 MB L2.  Static runs pass B
//     alone.
//   - The bfloat16 prologue runs on bf16x2 words, each step one
//     fma.rn.bf16x2 (x - mean = mean * -1 + x, then * inv + -0, then * 1 +
//     bias): a bfloat16 (8-bit) operation computed in float32 (24 >= 2 * 8
//     + 2 bits) and rounded again is rounded once, so these are the float32
//     steps' bits at a sixth of their instructions; PReLU selects by x's
//     sign bits (-0 takes -0 * alpha, which quantises as -0 does).
//   - The division.  t = v * r with r = RN(1 / scale), once a block;
//     __fdiv_rn(v, scale) only where t lies within 2^-12 of a half-integer
//     or is not finite (everywhere if r is not a normal number).  Elsewhere
//     rint(t) = rint(RN(v / scale)): |t - RN(v / scale)| <= 3 * 2^-24 *
//     |v / scale| < 2^-15 for |v / scale| < 128, and past that both clip to
//     the same +-127.  rint and the byte come from adding 1.5 * 2^23, not
//     from conversions.
//   - A thread's per-channel constants are loaded once into registers: the
//     grid is cut to a multiple of the odd part of C / 16, so every chunk a
//     thread takes holds the same 16 channels.
// Diagnostic builds for tools/profile_conv_bf16.py --dtype quantise:
// FVT_DIAG_LOADS_ONLY (x read and q written, nothing computed) and
// FVT_DIAG_NO_PROLOGUE give wrong q; FVT_DIAG_EXACT_DIV (__fdiv_rn for every
// value) and FVT_DIAG_FORWARD_WALK (pass B from the start) the same q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
// partials the caller's words hold (ops/quant.py MAX_PARTS), channels a
// prologue may have (ops/quant.py MAX_C)
constexpr int kMaxParts = 4096;
constexpr int kMaxC = 4096;
constexpr int kNone = 0, kBn1 = 1, kPrelu = 2;
// |t - rint(t)| below this: t lies more than 2^-12 from every half-integer
constexpr float kFast = 0.5f - 1.0f / 4096.0f;
// 1.5 * 2^23: t + kMagic rounds t to an integer, half to even, for |t| <
// 2^22, and holds it in its low bits, two's complement; past that the
// rounded value is still beyond +-127
constexpr float kMagic = 12582912.0f;
#ifdef FVT_DIAG_FORWARD_WALK
constexpr bool kReverse = false;
#else
constexpr bool kReverse = true;
#endif

// 16-byte vectors of one chunk of 16 values
template <bool BF16>
struct Chunk {
  uint4 w[BF16 ? 2 : 4];
};

template <bool BF16>
__device__ __forceinline__ void load_chunk(const void* x, long long i,
                                           Chunk<BF16>& c) {
  constexpr int kVecs = BF16 ? 2 : 4;
  const uint4* p = reinterpret_cast<const uint4*>(x) + kVecs * i;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) c.w[k] = __ldg(p + k);
}

// word k of the chunk (k a constant once unrolled)
template <bool BF16>
__device__ __forceinline__ unsigned& word(Chunk<BF16>& c, int k) {
  uint4& a = c.w[k / 4];
  return (k & 3) == 0 ? a.x : (k & 3) == 1 ? a.y : (k & 3) == 2 ? a.z : a.w;
}

// the 16 values widened to float32 (exact); a bfloat16's are the high half
template <bool BF16>
__device__ __forceinline__ void unpack(Chunk<BF16>& c, float (&v)[16]) {
#pragma unroll
  for (int k = 0; k < (BF16 ? 8 : 16); ++k) {
    const unsigned u = word<BF16>(c, k);
    if (BF16) {
      v[2 * k] = __uint_as_float(u << 16);
      v[2 * k + 1] = __uint_as_float(u & 0xffff0000u);
    } else {
      v[k] = __uint_as_float(u);
    }
  }
}

// a thread's 16 channels of the prologue: bn1's mean, inv and bias, or
// PReLU's alpha in the first; float32 values, or bf16x2 words
struct Consts {
  float a[16], b[16], c[16];
  unsigned pa[8], pb[8], pc[8];
};

template <bool BF16, int P>
__device__ __forceinline__ void load_consts(long long chunk, int groups,
                                            const void* p0, const void* p1,
                                            const void* p2, Consts& k) {
  const int c0 = (int)(chunk % groups) * 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (BF16 && j < 8 && P != kNone) {
      k.pa[j] = static_cast<const unsigned*>(p0)[c0 / 2 + j];
      if (P == kBn1) {
        k.pb[j] = static_cast<const unsigned*>(p1)[c0 / 2 + j];
        k.pc[j] = static_cast<const unsigned*>(p2)[c0 / 2 + j];
      }
    } else if (!BF16 && P != kNone) {
      k.a[j] = static_cast<const float*>(p0)[c0 + j];
      if (P == kBn1) {
        k.b[j] = static_cast<const float*>(p1)[c0 + j];
        k.c[j] = static_cast<const float*>(p2)[c0 + j];
      }
    }
  }
}

__device__ __forceinline__ unsigned fma_bf16x2(unsigned a, unsigned b,
                                               unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// v of a chunk: the prologue on x's 16 values, widened to float32
template <bool BF16, int P>
__device__ __forceinline__ void prologue_chunk(Chunk<BF16> c, const Consts& k,
                                               float (&v)[16]) {
#ifndef FVT_DIAG_NO_PROLOGUE
  if (BF16 && P != kNone) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned& w = word<BF16>(c, j);
      if (P == kBn1) {
        const unsigned d = fma_bf16x2(k.pa[j], 0xbf80bf80u, w);  // x - mean
        w = fma_bf16x2(fma_bf16x2(d, k.pb[j], 0x80008000u),      // * inv
                       0x3f803f80u, k.pc[j]);                    // + bias
      } else {
        const unsigned p = fma_bf16x2(w, k.pa[j], 0x80008000u);  // x * alpha
        unsigned neg;  // 0xffff in each half whose sign bit is set
        asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(neg) : "r"(w));
        w = (p & neg) | (w & ~neg);
      }
    }
  }
#endif
  unpack<BF16>(c, v);
#ifndef FVT_DIAG_NO_PROLOGUE
  if (!BF16 && P == kBn1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], k.a[j]), k.b[j]), k.c[j]);
  } else if (!BF16 && P == kPrelu) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = v[j] >= 0.f ? v[j] : __fmul_rn(v[j], k.a[j]);
  }
#endif
}

// the max of m over the block, in every thread (once a kernel: the shared
// words are not reused)
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned red[kThreads / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[threadIdx.x & (kThreads / 32 - 1)];
#pragma unroll
  for (int o = kThreads / 64; o; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The logical chunk l of the walk is the chunk REV ? n16 - 1 - l : l.  A
// thread takes l = its index in the grid, then steps by the grid's
// threads, two chunks a step (bfloat16) or one (float32): 16-byte loads
// straight into registers, the next step's issued before f(chunk, data) of
// this step's.
template <bool BF16, bool REV, typename F>
__device__ __forceinline__ void walk(const void* x, long long n16, F f) {
  constexpr int kU = BF16 ? 2 : 1;
  const long long S = (long long)gridDim.x * kThreads;
  auto at = [&](long long l) { return REV ? n16 - 1 - l : l; };
  Chunk<BF16> c[kU], next[kU];
  long long l = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kU; ++u)
    if (l + u * S < n16) load_chunk<BF16>(x, at(l + u * S), c[u]);
  for (; l < n16; l += kU * S) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (l + (kU + u) * S < n16)
        load_chunk<BF16>(x, at(l + (kU + u) * S), next[u]);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (l + u * S < n16) f(at(l + u * S), c[u]);
#pragma unroll
    for (int u = 0; u < kU; ++u) c[u] = next[u];
  }
}

__device__ __forceinline__ float rint_magic(float t) {
  return __fsub_rn(__fadd_rn(t, kMagic), kMagic);
}

// the low byte of clip(t) + kMagic: q of an integer-valued t
__device__ __forceinline__ unsigned magic_byte(float t) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(t, -127.f), 127.f), kMagic));
}

// q of 16 values: rint(v * r) where that is rint(v / s), else rint(v / s)
__device__ __forceinline__ uint4 quantise16(const float (&v)[16], float s,
                                            float r, bool fast) {
  float t[16];
#ifdef FVT_DIAG_EXACT_DIV
#pragma unroll
  for (int j = 0; j < 16; ++j) t[j] = rintf(__fdiv_rn(v[j], s));
#else
  bool slow = !fast;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float p = __fmul_rn(v[j], r);
    t[j] = rint_magic(p);
    slow |= !(fabsf(p - t[j]) < kFast);
  }
  if (slow) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = __fmul_rn(v[j], r);
      if (!fast || !(fabsf(p - rint_magic(p)) < kFast))
        t[j] = rintf(__fdiv_rn(v[j], s));
    }
  }
#endif
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = __byte_perm(__byte_perm(magic_byte(t[4 * k]),
                                   magic_byte(t[4 * k + 1]), 0x0040),
                       __byte_perm(magic_byte(t[4 * k + 2]),
                                   magic_byte(t[4 * k + 3]), 0x0040),
                       0x5410);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool BF16>
__device__ __forceinline__ unsigned fold(Chunk<BF16>& c) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < (BF16 ? 8 : 16); ++k) m ^= word<BF16>(c, k);
  return m;
}

// pass A: partials[block] = the bits of max |prologue(x)| over its chunks
template <bool BF16, int P>
__global__ void __launch_bounds__(kThreads, 2)
amax_pass(const void* __restrict__ x, long long n16, int groups,
          const void* __restrict__ p0, const void* __restrict__ p1,
          const void* __restrict__ p2, unsigned* __restrict__ parts) {
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  Consts k;
  load_consts<BF16, P>(first < n16 ? first : 0, groups, p0, p1, p2, k);
  unsigned m = 0;
  walk<BF16, false>(x, n16, [&](long long, Chunk<BF16>& c) {
#ifdef FVT_DIAG_LOADS_ONLY
    m ^= fold<BF16>(c);
#else
    float v[16];
    prologue_chunk<BF16, P>(c, k, v);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      m = max(m, __float_as_uint(v[j]) & 0x7fffffffu);
#endif
  });
  m = block_max(m);
  if (threadIdx.x == 0) parts[blockIdx.x] = m;
}

// pass B: q = quantise(prologue(x)) with scale_in (static) or the scale of
// the partials' max (DYN: words = [amax, scale, partials[parts]], both
// written by block 0); q null: the scale alone (one block)
template <bool BF16, int P, bool DYN>
__global__ void __launch_bounds__(kThreads, 2)
quantize_pass(const void* __restrict__ x, long long n16, int groups,
              const void* __restrict__ p0, const void* __restrict__ p1,
              const void* __restrict__ p2, const float* __restrict__ scale_in,
              float* __restrict__ words, int parts, uint4* __restrict__ q) {
  float s;
  if (DYN) {
    const unsigned* pw = reinterpret_cast<const unsigned*>(words) + 2;
    unsigned m = 0;
    for (int b = threadIdx.x; b < parts; b += kThreads) m = max(m, pw[b]);
    const float amax = __uint_as_float(block_max(m));
    s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      words[0] = amax;
      words[1] = s;
    }
  } else {
    s = *scale_in;
  }
  if (q == nullptr) return;
  const float r = __frcp_rn(s);
  const bool fast = r >= FLT_MIN && r <= FLT_MAX;  // normal (NaN: false)
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  Consts k;
  load_consts<BF16, P>(
      first < n16 ? (kReverse ? n16 - 1 - first : first) : 0, groups, p0, p1,
      p2, k);
  walk<BF16, kReverse>(x, n16, [&](long long chunk, Chunk<BF16>& c) {
#ifdef FVT_DIAG_LOADS_ONLY
    const unsigned m = fold<BF16>(c);
    q[chunk] = make_uint4(m, m, m, m);
#else
    float v[16];
    prologue_chunk<BF16, P>(c, k, v);
    q[chunk] = quantise16(v, s, r, fast);
#endif
  });
}

// blocks of `fn` resident on the current device at once (SMs times the
// occupancy), read once a device and kernel; 0 on an error
int resident_blocks(const void* fn) {
  struct Entry {
    int dev;
    const void* fn;
    int blocks;
  };
  static Entry cache[256];
  static int used = 0;
  static std::mutex lock;
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].fn == fn) return cache[i].blocks;
  int sms = 0, per = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, kThreads, 0) !=
          cudaSuccess ||
      sms * per <= 0)
    return 0;
  const int blocks = sms * per < kMaxParts ? sms * per : kMaxParts;
  if (used < 256) cache[used++] = {dev, fn, blocks};
  return blocks;
}

// the grid over n16 chunks: one chunk a thread where the resident blocks
// cover them, else the resident blocks cut to a multiple of the odd part of
// `groups` (C / 16), so that the grid's threads are a multiple of `groups`
// and a thread's chunks share their channels
int grid_for(long long n16, int resident, int groups) {
  const long long need = (n16 + kThreads - 1) / kThreads;
  if (need <= resident) return (int)need;
  int odd = groups;
  while (odd % 2 == 0) odd /= 2;
  const int grid = resident - resident % odd;
  return grid > 0 ? grid : odd;
}

template <bool BF16, int P>
int run(const void* x, long long n16, int groups, const void* p0,
        const void* p1, const void* p2, const float* scale_in, float* words,
        void* q, cudaStream_t s) {
  uint4* q4 = static_cast<uint4*>(q);
  if (scale_in != nullptr) {
    const int rb = resident_blocks((const void*)quantize_pass<BF16, P, false>);
    if (rb <= 0) return cudaErrorInvalidConfiguration;
    quantize_pass<BF16, P, false><<<grid_for(n16, rb, groups), kThreads, 0,
                                    s>>>(x, n16, groups, p0, p1, p2, scale_in,
                                         nullptr, 0, q4);
    return cudaGetLastError();
  }
  const int ra = resident_blocks((const void*)amax_pass<BF16, P>);
  const int rb = resident_blocks((const void*)quantize_pass<BF16, P, true>);
  if (ra <= 0 || rb <= 0) return cudaErrorInvalidConfiguration;
  const int ga = grid_for(n16, ra, groups);
  if (ga > kMaxParts) return cudaErrorInvalidConfiguration;
  amax_pass<BF16, P><<<ga, kThreads, 0, s>>>(
      x, n16, groups, p0, p1, p2, reinterpret_cast<unsigned*>(words) + 2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  quantize_pass<BF16, P, true><<<q4 ? grid_for(n16, rb, groups) : 1, kThreads,
                                 0, s>>>(x, n16, groups, p0, p1, p2, nullptr,
                                         words, ga, q4);
  return cudaGetLastError();
}

template <bool BF16>
int run_prologue(int prologue, const void* x, long long n16, int groups,
                 const void* p0, const void* p1, const void* p2,
                 const float* scale_in, float* words, void* q,
                 cudaStream_t s) {
  if (prologue == kBn1)
    return run<BF16, kBn1>(x, n16, groups, p0, p1, p2, scale_in, words, q, s);
  if (prologue == kPrelu)
    return run<BF16, kPrelu>(x, n16, groups, p0, p1, p2, scale_in, words, q,
                             s);
  return run<BF16, kNone>(x, n16, groups, p0, p1, p2, scale_in, words, q, s);
}

}  // namespace

extern "C" {

// q = quantise(prologue(x)) on `stream`.  x float32 (bf16 = 0) or bfloat16
// (bf16 = 1), n values, NHWC-contiguous with C channels innermost, 16-byte
// aligned; C a multiple of 16 up to 4096 and n a multiple of C (with no
// prologue C is not read: pass 16).  prologue 0: none; 1: bn1, p0 p1 p2 the
// per-channel mean, inv and bias; 2: PReLU, p0 the per-channel alpha; each C
// values in x's type, 4-byte aligned.  scale_in (one float32 of device
// memory) given: static, one launch; words not touched.  Else dynamic, two
// launches: words (2 + 4096 floats of device memory) gets the amax in word
// 0, the scale in word 1 and the partials after them.  q null and dynamic:
// the amax and the scale alone (a sharded call reduces the ranks' amaxes
// before its static launch).  Returns the CUDA error of a launch,
// cudaErrorInvalidValue for what the kernels do not take,
// cudaErrorInvalidConfiguration if the device's occupancy could not be read.
int fvt_quantize_int8_fused(const void* x, int bf16, long long n, int C,
                            int prologue, const void* p0, const void* p1,
                            const void* p2, const void* scale_in, void* words,
                            void* q, void* stream) {
  if (n <= 0 || n % 16 || C < 16 || C % 16 || C > kMaxC || n % C ||
      prologue < kNone || prologue > kPrelu ||
      (prologue != kNone && p0 == nullptr) ||
      (prologue == kBn1 && (p1 == nullptr || p2 == nullptr)) ||
      (scale_in == nullptr && words == nullptr) ||
      (scale_in != nullptr && q == nullptr))
    return cudaErrorInvalidValue;
  const int groups = prologue == kNone ? 1 : C / 16;
  const float* sin = static_cast<const float*>(scale_in);
  float* w = static_cast<float*>(words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_prologue<true>(prologue, x, n / 16, groups, p0, p1, p2, sin, w,
                              q, s);
  return run_prologue<false>(prologue, x, n / 16, groups, p0, p1, p2, sin, w,
                             q, s);
}

}  // extern "C"
