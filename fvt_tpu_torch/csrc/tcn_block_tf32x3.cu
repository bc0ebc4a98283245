// Eval-mode TemporalBlock, fp32 in and out at fp32 accuracy, for Hopper
// (sm_90a): each causal dilated conv is an implicit GEMM on the warpgroup
// matrix multiply (wgmma) with split-TF32 (3xTF32) products, one launch a
// conv.
//
// Replaces fvt_tpu/ops/tcn_pallas.py::_block_kernel (the Pallas kernel
// behind fused_temporal_block / tcn_forward_pallas):
//
//     h = leaky(conv1(x) + b1)
//     y = leaky(leaky(conv2(h) + b2) + res)
//
// with x (B, T, C), conv1 and conv2 causal dilated convs of K taps (left
// pad (K-1)*d zeros: of x for conv1, of h, not leaky(b1), for conv2), leaky
// slope 0.01 and res = x @ wd + bd (the 1x1 downsample) where C != Co, else
// x.  The CUDA-core kernel of tcn_block.cu computes the same in one launch
// and stays beside it for measurements only.
//
// What bounds it.  At the serving shapes (B = 8 windows of T = 300 frames,
// M = 2400 rows; C up to 768, Co up to 256, K = 5) a block is 2*M*K*(C +
// Co)*Co operations (plus 2*M*C*Co for the downsample) against a few MB of
// activations and weights, so the operations bound it: three TF32 products
// a multiply (below), 3 * 23.78 GFLOP over the 12 blocks of a dispatch,
// 0.144 ms at the TF32 peak (494.7 TFLOP/s).  M is small: a 64-row by
// 64-column tile is one warpgroup's work, and a conv has 40 to 160 of
// them for 132 SMs, so how well the grid fills the card weighs as much as
// the products.
//
// The design, three simple launches of the split-TF32 causal conv of
// tcn_conv_tf32x3.cuh (read its header note), which the train block's
// kernels (tcn_block_train_tf32x3.cu) share:
// - conv1 writes h = leaky(conv1(x) + b1) to a workspace (B, T, Co) in
//   device memory (2.4 MB at most at the serving shapes: it stays in the
//   50 MB L2); conv2 reads it back.  So nothing is recomputed over the
//   halo, which the one-launch design had to do for each tile.
// - the downsample, where there is one, is the same kernel with one tap
//   and a bias-only store into a second workspace r; conv2's store reads r
//   (or x) as the residual.
// - the weights come split and packed by the caller (once a parameter
//   version).
// - a K above 9 or a halo (K-1)*d that one box of 256 rows cannot hold
//   takes the taps in groups (the conv's header note).

#include "tcn_conv_tf32x3.cuh"

extern "C" {

// The eval-mode TemporalBlock of x on `stream`, as up to three launches of
// the split-TF32 causal conv (the header note):
//   stage 1, conv1:       h = leaky(conv1(x) + b1)
//   stage 2, downsample:  r = x @ wd + bd (only with a downsample)
//   stage 4, conv2:       y = leaky(leaky(conv2(h) + b2) + res),
//                         res = r with a downsample, else x.
// `stages` 7 runs all; fewer bits run those alone, for measurements.
// x (B, T, C), the workspaces h and r and y (B, T, Co) fp32, contiguous
// and 16-byte aligned; C a multiple of 4 (the caller pads channels with
// zeros), Co a multiple of 8.  Each weight comes as its two TF32 parts, hi
// = tf32(w) and lo = tf32(w - hi), packed for column tiles of 64 output
// channels:
//   wp[tile][slice][tap][chunk][n8][n][k] =
//       w[tap][8*slice + 4*chunk + k][64*tile + 8*n8 + n]
// with tile < ceil(Co / 64), slice < ceil(Cin / 8), chunk < 2, n8 < 8,
// n < 8, k < 4, and 0 where the input channel is beyond Cin or the output
// channel beyond Co: w1 (K, C, Co), w2 (K, Co, Co) and wd (1, C, Co), the
// convs' taps up to G * groups of tap_groups(K, dil) with zero weights
// beyond K (one group of K taps wherever K <= 9 and 64 + (K-1)*dil <=
// 256).  wd_hi, wd_lo, bd and r are null without a downsample, when C ==
// Co.  Returns cudaSuccess, the first error of a launch or an attribute
// call, or cudaErrorInvalidValue for what the kernel does not take:
// another C, Co or stages, a missing downsample where C != Co, or a halo
// (K-1)*dil of 2^30 or more (a TMA coordinate would overflow).
int fvt_tcn_block_tf32x3_forward(const void* x, const void* w1_hi,
                                 const void* w1_lo, const void* b1,
                                 const void* w2_hi, const void* w2_lo,
                                 const void* b2, const void* wd_hi,
                                 const void* wd_lo, const void* bd, void* h,
                                 void* r, void* y, int B, int T, int C,
                                 int Co, int K, int dil, int stages,
                                 void* stream) {
  const bool has_ds = wd_hi != nullptr;
  if (B <= 0 || T <= 0 || C <= 0 || Co <= 0 || K <= 0 || dil <= 0 ||
      C % 4 || Co % 8 || stages < 1 ||
      stages > 7 || (!has_ds && C != Co) ||
      (has_ds && (wd_lo == nullptr || bd == nullptr || r == nullptr)) ||
      (long long)(K - 1) * dil >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const ConvArgs c1 = conv_args(x, w1_hi, w1_lo, b1, nullptr, h, B, T, C,
                                Co, K, dil);
  const ConvArgs ds = conv_args(x, wd_hi, wd_lo, bd, nullptr, r, B, T, C,
                                Co, 1, 1);
  const ConvArgs c2 = conv_args(h, w2_hi, w2_lo, b2, has_ds ? r : x, y, B,
                                T, Co, Co, K, dil);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (stages & 1) err = run_taps<kLeaky>(c1, st);
  if (err == cudaSuccess && has_ds && (stages & 2))
    err = run<kBias, 1>(ds, st);
  if (err == cudaSuccess && (stages & 4)) err = run_taps<kBlockOut>(c2, st);
  return (int)err;
}

}  // extern "C"
