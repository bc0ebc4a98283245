#!/usr/bin/env python3
"""Drives the PyTorch port's LFAN serving and training paths, the
ArcFace backbone's conv paths, the training and serving of CAN, JMT and
MT, the ``logmel`` modality, the regression task, serving from frozen
artifacts over HTTP, int8 serving and the offline audio and visual
features with the feature driver once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. build the CUDA kernels of ``fvt_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: the eval TCN block (the split-TF32
   tensor-core kernel that serving launches, its launches also timed
   each, and the earlier CUDA-core kernel ``fused_temporal_block_simt``,
   on no path) at all 12 block shapes of the tri-modal LFAN at (8, 300),
   plus edge shapes, the mfcc width Cin = 39, long kernels whose taps the
   kernel takes in groups (K = 11 at d = 8, K = 5 at d = 64) and its
   refusal of shapes it does not take; the fusion block (the split-TF32
   tensor-core kernel that serving launches, one launch for 1 to 7
   modalities, and the earlier CUDA-core kernel
   ``fused_multimodal_fusion_simt``, on no path, both also timed on the
   device alone) at (8, 300, {128, 32, 128}), at five, seven and four wide
   modalities, at a head padded to 16 dims (E = 36, H = 3) and two slices a
   head (E = 64, H = 2) and at E*M = 320, and its refusal of E*M above
   576; the train-mode
   TCN block (forward
   output and the backward's six results, against autograd of the plain
   version, the backward bit for bit twice; the split-TF32 kernels that
   training launches, each of their launches also timed alone, and the
   earlier CUDA-core ones ``fused_temporal_block_train_simt``, on no
   path) at the 8 block shapes of the ``vggish+bert`` LFAN at (16, 300)
   with dropout masks at p=0.1, plus edge shapes and mfcc's Cin = 39;
   the float32 3x3 conv kernels (the
   split-TF32 tensor-core kernel that ``shifted_kernel`` launches, the
   earlier CUDA-core kernel ``conv3x3_simt``, which no path launches, the
   split-TF32 Winograd kernel that ``winograd_kernel`` launches, its three
   launches also timed each, and the earlier CUDA-core Winograd kernel
   ``conv3x3_winograd_simt``, on no path either) against their plain
   versions and against ``F.conv2d`` at the seven conv shapes of the
   ArcFace body on 2400 frames, plus shapes the split-TF32 kernels refuse,
   and the fused BottleneckIR block (the split-TF32 kernel that
   ``fused_blocks`` launches, two launches a call with bn1, PReLU, bn2 and
   the residual fused, each also timed alone, and the earlier CUDA-core
   kernel ``bottleneck_ir_fused_simt``, on no path) against its plain
   version at the four stage shapes on 2400 frames, plus edge shapes (one
   with bn1's shift at 20) and shapes it refuses; the bfloat16 tensor-core
   (``wgmma``) 3x3 conv
   kernel against its plain version and ``F.conv2d`` on bfloat16 tensors
   at the same seven shapes and at edge shapes, and its refusal of a
   channel count it does not take; the fused block's bfloat16 route (two
   launches of that kernel, each also timed alone) against its plain
   version at the four stage shapes and edge shapes, beside the unfused
   bfloat16 block on cuDNN; the Winograd kernel's bfloat16 route (the
   input transform, then one bfloat16 ``wgmma`` product with the output
   transform in its epilogue; V of the first launch bit-equal to its plain
   version, the product on the plain V and the whole call within one unit
   in the last place, each launch also timed alone) at the seven conv
   shapes and edge shapes, beside the bfloat16 conv kernel and
   ``F.conv2d`` bf16, and its refusal of widths it does not take; print
   errors and median times (CUDA events);
3. serve three streams of 250, 700 and 1000 frames through the
   ``fvt_tpu_torch.streaming`` server core over a full-width tri-modal
   LFAN (``video+vggish+bert``, random init from seed 0); check every
   frame's logits against an offline stitch of the plain-version forward
   and the kernels' launch counts (12 eval TCN blocks and one split-TF32
   fusion a dispatch, no CUDA-core kernel); time full (8, 300)
   dispatches;
4. train a full-width ``vggish+bert`` LFAN for 10 steps at (16, 300)
   through ``Trainer`` with the fused train kernels; check the losses and
   final parameters against the same steps on the plain versions, that a
   step repeats bit for bit, and the launch counts (8 forward and 8
   backward calls a step of the split-TF32 train entries, printed by C
   entry, none of the SIMT ones, none of the eval-only kernels); time
   steps of the fused path and of the conv-by-conv path on cuDNN; then 4
   fused steps of the ``mfcc+vggish`` LFAN (mfcc's 39 channels through
   zero channels) against plain ones;
5. run the ArcFace IR-50 backbone alone on the 2400 frames of a full
   dispatch through each conv path (``cudnn``, ``shifted_kernel``,
   ``winograd_kernel``, ``fused_blocks``, ``fused_blocks`` with
   ``shifted_kernel``), check the embeddings against the default path's
   and the launch counts (45 of the split-TF32 kernel, 45, 21, and 21 + 3
   a forward, none of the SIMT kernels), time each; then serve the three
   streams again through a tri-modal LFAN built with
   ``fused_blocks=True``, one with ``fused_blocks=True,
   conv_impl='shifted_kernel'``, one with ``conv_impl='winograd_kernel'``
   and one with ``conv_impl='shifted_kernel'``, check the logits against
   the offline stitch of the plain versions and the launch counts a
   dispatch, and time full dispatches of the last three against the
   default, in turns; then the
   bfloat16 backbone (``dtype=torch.bfloat16``, ``--amp`` in ``fvt_tpu``)
   through ``cudnn``, ``shifted_kernel`` (45 bfloat16 launches a forward),
   ``fused_blocks`` (21 bfloat16 block launches), ``fused_blocks`` on
   ``shifted_kernel`` (21 block and 3 conv launches), ``winograd_kernel``
   (45 bfloat16 Winograd calls) and ``fused_blocks`` on
   ``winograd_kernel`` (21 block and 3 Winograd calls), each kernel path's
   embeddings against its plain
   version's within twice bfloat16's own distance from float32, timed in
   turns; tri-modal LFANs with ``backbone_dtype=torch.bfloat16`` on
   ``shifted_kernel``, on ``fused_blocks`` + ``shifted_kernel`` and on
   ``winograd_kernel`` on the three streams, and timed full dispatches of
   the four bfloat16 paths, in turns;
6. challenge inference from the on-disk store: a synthetic
   C-EXPR-DB-CHALLENGE store of 12 videos (60 to 2400 frames, 7490 in
   all; 48^2 uint8 crops, vggish, bert, labels) and a run directory
   (``config.yml`` of the port's flat writer; a seed-0 full-width
   tri-modal LFAN as ``best-models/FRAMES_AVG_LOGITS/model.pt``) through
   ``fvt_tpu_torch.inference_challenge.main`` on the card: the native
   gather loaded, every video's logits in ``prediction.pkl`` within 1e-3
   of an offline stitch of the plain-version forward, its keys in the
   fold's order, 12 eval TCN blocks and one fusion a forward and no other
   kernel, and B1 and B2 at every (B, T) the run launched them at (and at
   T = 100, 200 and B = 1, which a window of 300 never gives) against
   their plain versions at the phase-2 gate; the CLI's wall, served
   frames/s, the pass's timing by phase and the peak device memory;
7. the training run: ``fvt_tpu_torch.main`` on the card over a synthetic
   C-EXPR-DB store of 40 train and 10 val videos of 300 to 1800 frames
   (``tools/synth_store.py``; the videos labelled Other are left out, as
   without ``--use_other_class``), the full-width ``vggish+bert`` LFAN,
   window 300, hop 200, batch 16, default SGD, MYSTEP and dropouts, 3
   epochs with a checkpoint each, then ``passed.txt`` removed and the run
   resumed to 4 epochs: the run directory's files, the resumed run's log
   (the restore, no epoch 0, epoch 3 trained), 8 B3a and 8 B3b calls a
   step and 8 B1 and 1 B2 launches a validation or test forward and no
   other kernel, B1 and B2 at every (B, T) the eval passes launched and
   B3a/B3b at the ragged last batch against their plain versions at the
   phase-2 gate, and ``best-models/None/model.msgpack`` read back through
   ``inference_challenge`` (``load_best_model`` into a fresh LFAN,
   ``Trainer.inference`` on the val split) within 1e-4 of the run's test
   pass; each epoch's wall (and by phase), trained frames/s, each
   validation pass's wall, each checkpoint save and best-model write, the
   set-up walls, the peak device memory;
8. tri-modal training, the paper's default run: ``fvt_tpu_torch.main``
   on the full-width ``video+vggish+bert`` LFAN (the ArcFace IR-50 frozen
   in train mode: BatchNorm on batch statistics with the running ones
   updated, its dropout live) over a synthetic C-EXPR-DB store of 12
   train and 3 val videos of 250 to 450 frames at 256^2, read through the
   native host resize to 48^2 (the train transform's random crop and
   flip on the card), window 300, batch 16: 1 epoch with a checkpoint,
   resumed to 2, then 2 epochs under ``--amp`` (the backbone in
   bfloat16): 12 B3a and 12 B3b calls a step and 12 B1 and 1 B2 launches
   a validation or test forward and no other kernel, B1 and B2 at every
   (B, T) the eval passes launched and B3a/B3b at the video's four block
   shapes at every trained (B, T) and at (16, 300) against their plain
   versions at the phase-2 gate, every running statistic of the backbone
   moved, each run's best model (with ``fvt_tpu``'s ArcFace subtree) read
   back through ``inference_challenge`` within 1e-4 of its test pass; the
   train-mode backbone in float32 and bfloat16, embeddings and running
   statistics, against a composition of PyTorch's own train-mode calls
   on the same crops and dropout mask; epoch wall by phase, step_s,
   trained frames/s, validation passes, peak device memory a run; the
   step timed with ``tcn_fused`` on and off and with ``frozen_eval`` on
   and off in turns (float32 and ``--amp``), and the train-mode
   backbone's share of the step;
9. the other fusion families: ``fvt_tpu_torch.main`` trains CAN on
   ``video+vggish+bert`` and JMT, MT and JMT under ``--amp`` on
   ``video+vggish`` (full published widths: five-level video TCN with
   dilation 16, vggish 128->128,128,64,64) for 2 epochs on phase 8's
   store, then ``fvt_tpu_torch.inference_challenge`` serves each best
   model over phase 6's challenge store (whole videos in buckets, CAN up
   to ``eval_video_batch`` a forward, JMT and MT one a forward with the
   valid frames' mask): 13 (CAN) or 9 B3a and B3b calls a step and 13 or
   9 B1 launches a forward and no other kernel, each best model read back
   and written again to the same bytes, every video's served logits
   within 1e-4 (relative to their largest magnitude) of the offline
   plain-version composition on the loader's padded input, no eval
   backbone call above ``eval_window_batch * window_length`` frames, B1
   at every (B, T) of the eval passes (up to T = 2400) and B3a/B3b at
   every trained (B, T) and (16, 300) at all the model's blocks against
   their plain versions; CLI and epoch walls, step_s, frames/s, peak
   memory; a step at (16, 300) by CUDA events and JMT's and MT's fusion
   alone, its share; CAN's eval over a full bucket of 32 whole videos of
   1000 frames (the backbone in chunks), its peak memory;
10. the ``logmel`` modality, raw (96, 64) log-mel patches through the
   frozen VGGish in the model: ``fvt_tpu_torch.main`` on a ``logmel+bert``
   C-EXPR-DB store (phase 8's sizes, ``logmel.npy`` in float16) trains the
   LFAN in float32 (one epoch, then resumed to two) and under ``--amp``
   (the VGGish in bfloat16) and CAN in float32, 2 epochs; each best model
   (its VGGish in ``fvt_tpu``'s ``spatial_audio`` tree) written again to
   the same bytes, then served through ``fvt_tpu_torch.inference_challenge``
   over phase 6's store with ``logmel.npy``: 8 (LFAN) or 9 (CAN) B3a and
   B3b calls a step, 8 B1 and 1 B2 (LFAN) or 9 B1 launches a forward and
   no other kernel, every video's logits within 1e-4 (relative to their
   largest magnitude) of the offline plain composition, no eval VGGish call
   above ``eval_window_batch * window_length`` patches, CAN's eval over 32
   whole videos of 1000 frames (32 000 patches in chunks), B1 and B2 at
   every (B, T) of the eval passes and B3a/B3b at every trained (B, T) and
   (16, 300) at all the model's blocks (CAN's ``logmel`` d = 16 block at
   64 channels) against their plain versions; CLI and epoch walls, peak
   memory, a step at (16, 300) and the VGGish alone on its 4800 patches
   and on one 2400-patch eval chunk, its share and TFLOP/s;
11. the regression task: ``RegressionTrainer.fit`` of a full-width
   ``vggish+bert`` LFAN with ``task=REGRESSION`` (tanh head, CCC loss) on
   synthetic valence trials (8 train, 3 valid, 3 test of 700 to 1500
   frames from the seed), (16, 300) windows at hop 200, 3 epochs with a
   ``ParamControl`` release of the TCNs at epoch 1 (frozen before, trained
   after), then ``test`` and ``predict``: 8 B3a and B3b calls a step, 8 B1
   and 1 B2 launches a forward, the CSV, pickles, best model, checkpoint
   and per-trial txts (plots where matplotlib imports); the same fit
   stopped after epoch 1 and resumed from its checkpoint ends bit for bit
   like it; B1, B2 and B3 at the fit's shapes against their plain
   versions; the epoch walls and a step's time;
12. serving from frozen artifacts: a seed-0 full-width tri-modal LFAN,
   CAN on ``video+vggish+bert`` and JMT on ``video+vggish`` (their
   BatchNorm statistics drawn from the seed), each a run directory's best
   model exported by ``fvt_tpu_torch/tools/export_serving.py`` at (8,
   300), loaded, and served by ``fvt_tpu_torch/tools/serve_http.py`` on
   127.0.0.1 through ``fvt_tpu_torch/client.py``: five ``/logits`` on one
   (8, 300) batch (JMT with a length vector), phase 3's three streams in
   chunks (dynamic batching for LFAN and CAN, a batcher a session with
   lengths for JMT), ``/healthz``; the served logits within 1e-6 relative
   of the artifact's in-process offline stitch and within 1e-4 (relative
   to the largest logit) of the plain composition; 12 B1 and 1 B2 (LFAN),
   13 B1 (CAN) or 9 B1 (JMT) launches a forward and nothing else; artifact
   bytes, write and load seconds, ``/logits`` p50 / p99, served frames/s
   beside ``ServingModel.call``'s, peak memory; then
   ``TemporalConvNet(attention=1)`` at the LFAN's vggish widths (128 ->
   64, 64, 32, 32, K = 5) at T = max_length = 300, batch 8: eval through
   B1 block by block within 1e-4 of its plain version, one train step
   through B3a and B3b with its loss and gradients within 1e-4 of the
   plain version's;
13. int8 serving (``--serve_quant int8 | int8_static``) on the two int8
   kernels of ``csrc/conv3x3_int8.cu``, which replace no Pallas kernel
   (``fvt_tpu``'s int8 conv is one XLA convolution): the quantise pass
   (the per-tensor amax and the quantisation) and the s8 conv
   (``mma.sync`` s8 tiles, int32 sums, the scaling in its epilogue)
   against their plain versions bit for bit at the eight int8 shapes of
   the IR-50 at N = 2400 (the stride-2 convs, the stage entries' conv1,
   the stride-1 convs), float32 and bfloat16 in and out, dynamic and with
   a calibrated scale, and at edge shapes, each timed beside ``F.conv2d``
   and ``torch._int_mm`` over an im2col, and its refusals; the int8
   backbone alone on 2400 frames, dynamic and static, float32 and bf16,
   bit for bit its plain versions, 41 s8 convs and 41 quantise launches a
   forward, the embeddings' cosine to float32, the peak memory a frame
   against ``arcface.INT8_FRAME_BYTES``, ms beside cuDNN;
   ``inference_challenge --serve_quant int8`` and ``int8_static`` of a
   tri-modal LFAN under ``--amp`` over phase 6's store beside the float32
   run: every video's logits within 1e-4 (relative to the largest) of the
   same pass on the plain versions, 12 B1 and 1 B2 launches a forward, the
   int8 kernels' launches, dynamic int8's backbone calls whole, argmax
   agreement and logit delta against float32, wall, frames/s, peak
   memory; an ``int8_static`` artifact exported with ``--calib_store`` and
   served over HTTP, ``/logits`` bit for bit the in-process call; an
   ``h2d_bf16_features`` artifact (bfloat16 feature specs) served over
   HTTP, ``/logits`` and three streams within 1e-6 of the in-process call
   and stitch; one epoch of ``main --profile_epochs 1``, its trace and its
   device kernels;
14. the offline audio features (``fvt_tpu_torch/preprocess``), which
   launch no kernel of the port's (the STFT is cuFFT and cuBLAS, the
   VGGish cuDNN, as ``fvt_tpu``'s are XLA's): six 16-bit wavs written from
   the seed (0.5 s, 3 s at 30 and 29.97 fps, 60 s at 25, 300 s at 30,
   and 10 s at 44.1 kHz stereo), each through ``extract_logmel`` on the
   card (its float32 patches within 1e-5 of ``device='cpu'``'s, its
   float16 file within one unit in the last place),
   ``extract_vggish_embeddings`` with a full-width VGGish loaded from a
   seeded upstream-named ``vggish.pth`` in chunks of 500 (patches - 1
   rows, the annotated gather, indices past the end on one clip; the 60 s
   clip within 1e-4 of the largest magnitude of the VGGish in float64)
   and ``extract_mfcc`` on the host, ``extract_egemaps`` on the 60 s clip;
   each stage's wall, video frames/s, device time and peak memory beside
   the card's name and power limit;
15. the offline visual preprocessing and the feature driver
   (``fvt_tpu_torch/preprocess``), which launch no kernel of the port's
   either (cuDNN convolutions, gathers and elementwise ops, as
   ``fvt_tpu``'s are XLA's): full-width RetinaFace-R50, FAN-4, ArcFace
   IR-50 and VGGish drawn from the seed and loaded from files under the
   upstream names; two seeded trials (40 frames at 1280x720, 24 at
   640x480) as lossless video files with their audio where ffmpeg is on
   the machine (else frames, placed wavs and an injected probe); driver
   pass 1 over two shards, the faces (RetinaFace at 2048^2 with a
   threshold from frame 0's scores, the warp, frames 0-1 and a middle one
   dropped for the fallback and the carry), ``compact`` and
   ``recompact``, driver pass 2 (``cnn.npy``, ``--landmarks``), the
   merge; the card against ``device='cpu'``: RetinaFace's outputs at
   512^2 within 1e-4 of their largest magnitude and the same detections,
   the warp within one level, ``cnn.npy`` and FAN's heatmaps within 1e-4
   relative, landmarks equal but at counted ties, AU maps within 1e-5;
   every file's shape, dtype and length against ``video.npy``; each
   stage's wall, frames/s, device time, peak memory and idle share, and
   RetinaFace's ms a frame and share of the fp32 peak.

Everything runs in float32 with TF32 off for matmuls and cuDNN, except the
bfloat16 backbone and its kernel and phases 8, 9, 10 and 13's ``--amp``
runs, which say so.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels.  Without a CUDA card the script exits with
code 1 and prints no result.
"""
from __future__ import annotations

import copy
import ctypes
import json
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

WINDOW_BATCH, WINDOW, HOP = 8, 300, 200  # defaults.py:59-60,152
MODALITY = ('video', 'vggish', 'bert')
STREAM_LENGTHS = (250, 700, 1000)
CHUNK = 100
SEED = 0
RUNS = 20
# kernel vs plain version: both fp32, summed in another order
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# weight and bias gradients are sums over all B*T rows in another order
# than the plain version's: max|got - want| <= WGRAD_TOL * max|want|
WGRAD_TOL = 1e-4
# the training path: feature-only LFAN, defaults.py:65
TRAIN_MODALITY = ('vggish', 'bert')
TRAIN_BATCH = 16
TRAIN_STEPS = 10
TCN_DROPOUT = 0.1
# fused against plain training: per-step losses, then final parameters
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 2e-4, 1e-5
# training on the mfcc width (Cin = 39 through zero channels): a few steps
MFCC_MODALITY = ('mfcc', 'vggish')
MFCC_STEPS = 4
# published fp32 peaks of one H100 SXM, for the kernels' bounds
PEAK_FLOPS = 67e12
# the tensor cores' dense bf16 and TF32 peaks, for the bfloat16 and the
# split-TF32 kernels' bounds
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_TF32 = 494.7e12
PEAK_BYTES = 3.35e12
# served logits vs the offline stitch of the plain-version forward
SERVE_ATOL = 1e-3
# the backbone's conv kernels at N = 2400: long calls, fewer timed runs
CONV_RUNS = 5
# Winograd vs its plain version and vs the direct conv: the transforms
# reorder and enlarge the partial sums (tests/test_winograd.py)
WINOGRAD_RTOL = WINOGRAD_ATOL = 2e-4
# a conv path's l2-normalised 512-d embeddings vs the default path's
# (components ~0.04): fp32 through 50 conv layers summed in another order
EMBED_ATOL = 1e-4
# the bfloat16 conv kernel vs its plain version and vs F.conv2d on bfloat16
# tensors: each sums exact products in fp32 in another order and rounds to
# bfloat16 once, so two results differ by one unit in the last place (2^-8
# relative, 2^-7 with the boundary's slack) where the fp32 sums straddle a
# rounding boundary, and by an absolute 2^-9 near zero; and such flips are
# rare, so the mean difference stays below 1e-4 of the mean magnitude (a
# wrong tap or a dropped channel chunk breaks that by orders of magnitude)
BF16_RTOL, BF16_ATOL, BF16_MEAN_TOL = 2.0 ** -7, 2.0 ** -9, 1e-4
# end to end, two bfloat16 forwards of one model (the kernel path and its
# plain version) differ by such flips amplified through 50 layers, which
# is how bfloat16 differs from float32 too.  The yardstick is therefore
# bfloat16's own distance from float32, measured in the same run (bf16
# cudnn against fp32 cudnn on the same weights and inputs), and the
# tolerance twice that: two results each within that distance of the
# float32 one lie within twice it of each other (a wrong tap moves the
# embeddings by their own magnitude, ten times more)
BF16_PATHS_APART = 2.0
# the fusion beyond the main path's three modalities: five, all seven
# LFAN modalities with embedding sizes, and four whose weights overflow
# the kernel's shared memory
FUSION_MODALITIES = (('bert', 'vggish', 'mfcc', 'egemaps', 'cnn_res50'),
                     ('video', 'bert', 'cnn_res50', 'mfcc', 'vggish',
                      'logmel', 'egemaps'),
                     ('video', 'bert', 'cnn_res50', 'mfcc'))
# (H = W, Cin, Cout, launches a backbone forward) of the stride-1 3x3 convs
# of the ArcFace body: 24 conv1 and the 21 conv2 of the stride-1 blocks
CONV_SHAPES = ((40, 64, 64, 6), (40, 64, 128, 1), (20, 128, 128, 6),
               (20, 128, 256, 1), (10, 256, 256, 26), (10, 256, 512, 1),
               (5, 512, 512, 4))
# (H = W, C, launches a forward) of the stride-1 identity blocks
BLOCK_SHAPES = ((40, 64, 3), (20, 128, 3), (10, 256, 13), (5, 512, 2))
# phase 6: the challenge store's video lengths (7490 frames), bucket
# quantum; its logits against the offline plain stitch within SERVE_ATOL
CHALLENGE_LENGTHS = (60, 90, 150, 240, 299, 300, 301, 450, 700, 1000, 1500,
                     2400)
CHALLENGE_QUANTUM = 100
# (B, T) at which phase 6 also holds B1 and B2, beyond those the run gives
CHALLENGE_EXTRA_SHAPES = ((32, 100), (3, 200), (1, 300))
# phase 7: a C-EXPR-DB training store of 40 train and 10 val videos of
# 300 to 1800 frames (drawn from the seed), trained for RUN_EPOCHS with a
# checkpoint each epoch, then resumed to RESUMED_EPOCHS
TRAIN_STORE_VIDEOS, VAL_STORE_VIDEOS = 40, 10
TRAIN_STORE_LENGTHS = (300, 1800)
RUN_EPOCHS, RESUMED_EPOCHS = 3, 4
# a best model read back against the run's test pass
READBACK_ATOL = 1e-4
# phase 8: tri-modal training (the paper's default run) on a C-EXPR-DB
# store of 12 train and 3 val videos of 250 to 450 frames with 256^2 face
# crops (the disk contract, resized on the host), 2 epochs in float32
# with one resume and 2 under --amp; the step timed with tcn_fused and
# frozen_eval on and off in turns over AB_PAIRS pairs (AB_PAIRS_BF16
# under --amp, whose steps are shorter)
TRI_STORE_VIDEOS, TRI_VAL_VIDEOS = 12, 3
TRI_STORE_LENGTHS = (250, 450)
TRI_VIDEO_HW = 256
TRI_EPOCHS = 2
AB_PAIRS, AB_PAIRS_BF16 = 5, 10
# phase 9: CAN, JMT and MT (and JMT under --amp) trained through main on
# phase 8's store for FAMILY_EPOCHS, then served through
# inference_challenge on phase 6's store; the served logits against the
# offline plain composition within FAMILY_RTOL of their largest magnitude;
# a step timed at (TRAIN_BATCH, WINDOW) over FAMILY_STEP_RUNS; CAN's eval
# once more on a full bucket of whole videos of FAMILY_BUCKET_LENGTH
FAMILY_RUNS = (('CAN', MODALITY, False), ('JMT', ('video', 'vggish'), False),
               ('MT', ('video', 'vggish'), False),
               ('JMT', ('video', 'vggish'), True))
FAMILY_EPOCHS = 2
FAMILY_RTOL = 1e-4
FAMILY_STEP_RUNS = 5
FAMILY_BUCKET_LENGTH = 1000
# the train-mode backbone vs its composition of PyTorch's own train-mode
# calls (F.batch_norm computes the variance by another algorithm): the
# embeddings within EMBED_ATOL; each running statistic within
# STATS_RTOL of its value plus STATS_ATOL
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
# phase 10: the logmel modality, raw (96, 64) log-mel patches through the
# frozen VGGish in the model: a C-EXPR-DB store with logmel.npy of phase
# 8's sizes (48^2 video, unused); LFAN in float32 (one epoch with a
# checkpoint, then resumed to LOGMEL_EPOCHS), LFAN under --amp and CAN in
# float32 for LOGMEL_EPOCHS, each best model served through
# inference_challenge on a challenge store of CHALLENGE_LENGTHS with
# logmel.npy; the served logits against the offline plain composition
# within FAMILY_RTOL of their largest magnitude; a step at (TRAIN_BATCH,
# WINDOW) and the VGGish alone timed over FAMILY_STEP_RUNS
LOGMEL_MODALITY = ('logmel', 'bert')
LOGMEL_EPOCHS = 2
# phase 11: the regression task: RegressionTrainer.fit of a full-width
# vggish+bert LFAN (task REGRESSION) on synthetic valence trials (REG_TRIALS
# train, valid and test trials of REG_TRIAL_LENGTHS frames, drawn from the
# seed), (TRAIN_BATCH, WINDOW) windows at HOP, eval batches of
# WINDOW_BATCH windows, REG_EPOCHS epochs with a ParamControl release of
# the TCNs at epoch REG_MILESTONE; the same fit stopped after epoch
# REG_MILESTONE and resumed from its checkpoint ends bit for bit like it
REG_TRIALS = (8, 3, 3)
REG_TRIAL_LENGTHS = (700, 1500)
REG_EPOCHS = 3
REG_MILESTONE = 1


# phase 12: serving from a frozen artifact: each family's best model
# (seed 0, statistics drawn from the seed too) exported by
# tools/export_serving.py at (WINDOW_BATCH, WINDOW), loaded and served over
# HTTP on 127.0.0.1 through tools/serve_http.py and client.py
ARTIFACT_FAMILIES = (('LFAN', MODALITY), ('CAN', MODALITY),
                     ('JMT', ('video', 'vggish')))
ARTIFACT_LOGITS_CALLS = 5
# served logits vs the artifact's own in-process offline stitch
ARTIFACT_RTOL = 1e-6
# TemporalConvNet(attention=1) at the LFAN's vggish widths, T = max_length
ATTN_TCN = (128, (64, 64, 32, 32), 5)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = RUNS, warmup: int = 3) -> float:
    """Median time of ``fn()`` on the card over ``runs`` calls, after
    ``warmup`` calls, with CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float = KERNEL_RTOL, atol: float = KERNEL_ATOL,
            what: str = 'its plain version') -> float:
    torch.cuda.synchronize()
    # in place where it can be: the conv outputs are gigabytes
    err = (got - want).abs_()
    max_abs = err.max().item()
    excess = err.sub_(want.abs().mul_(rtol)).max().item() - atol
    del err
    finite = bool(torch.isfinite(got).all())
    print(f'  {name}: max_abs_err={max_abs:.3e} '
          f'max_rel_err={max_abs / want.abs().max().item():.3e} '
          f'finite={finite}')
    if not finite or excess > 0:
        fail(f'{name}: kernel disagrees with {what} '
             f'(rtol={rtol}, atol={atol})')
    return max_abs


def compare_bf16(name: str, got: torch.Tensor, want: torch.Tensor,
                 what: str = 'its plain version') -> float:
    """Two bfloat16 results of one fp32 sum rounded once: elementwise
    within BF16_RTOL and BF16_ATOL, and close in the mean."""
    torch.cuda.synchronize()
    got = got.to(torch.float32, copy=True)
    want = want.to(torch.float32, copy=True)
    finite = bool(torch.isfinite(got).all())
    err = got.sub_(want).abs_()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    scale = want.abs_().mean().item()
    excess = err.sub_(want.mul_(BF16_RTOL)).max().item() - BF16_ATOL
    print(f'  {name}: max_abs_err={max_abs:.3e} mean_abs_err={mean_abs:.3e} '
          f'of mean|want|={scale:.3e} finite={finite}')
    if not finite or excess > 0 or mean_abs > BF16_MEAN_TOL * scale:
        fail(f'{name}: kernel disagrees with {what} (|got - want| <= '
             f'{BF16_RTOL} |want| + {BF16_ATOL}, mean |got - want| <= '
             f'{BF16_MEAN_TOL} mean |want|)')
    return max_abs


def compare_block_bf16(name: str, got: torch.Tensor, x: torch.Tensor,
                       args: tuple, packed: tuple) -> float:
    """The bfloat16 block ``got`` (the wrapper's output on ``x``) against
    its plain version.  Each launch alone is one float32 sum rounded once,
    so each is held to compare_bf16's gate: conv1 against
    ``bottleneck_bf16_conv1_ref`` (v), conv2 run on that plain v against
    ``bottleneck_bf16_conv2_ref``.  The whole block rounds twice: v flips
    by one unit in the last place where conv1's sum straddles a rounding
    boundary (the two sides sum in another order), and conv2 carries each
    flip into y as one of its 9*C products.  So y is held to compare_bf16's
    gate plus exactly those flips, ``|a2 * conv3x3(v - v_plain, w2)|``
    computed from the kernel's own v, elementwise and in the mean; a wrong
    tap, channel or pad breaks the stage gates by orders of magnitude."""
    from fvt_tpu_torch.ops import bottleneck as block_ops
    from fvt_tpu_torch.ops import conv as conv_ops

    w1, w2, a1, b1, alpha, a2, b2 = args
    vecs = (a1, b1, alpha, a2, b2)
    v_plain = block_ops.bottleneck_bf16_conv1_ref(x, w1, a1, b1, alpha)
    v, y2 = torch.empty_like(x), torch.empty_like(x)
    block_ops.launch_bf16(x, packed, vecs, v, y2, block_ops.CONV1)
    compare_bf16(f'{name} conv1 (v)', v, v_plain)
    block_ops.launch_bf16(x, packed, vecs, v_plain, y2, block_ops.CONV2)
    want = block_ops.bottleneck_bf16_conv2_ref(v_plain, x, w2, a2, b2)
    compare_bf16(f'{name} conv2 on the plain v', y2, want)
    del y2
    flips = conv_ops.conv3x3_ref(v.float() - v_plain.float(), w2.float())
    flips = flips.mul_(a2).abs_()
    del v, v_plain
    torch.cuda.synchronize()
    err = got.float().sub_(want.float()).abs_()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    want = want.float().abs_()
    scale, carried = want.mean().item(), flips.mean().item()
    excess = err.sub_(want.mul_(BF16_RTOL)).sub_(flips).max().item() \
        - BF16_ATOL
    finite = bool(torch.isfinite(got).all())
    print(f'  {name}: max_abs_err={max_abs:.3e} mean_abs_err={mean_abs:.3e} '
          f'of mean|want|={scale:.3e}, v\'s flips carried through conv2: '
          f'max {flips.max().item():.3e} mean {carried:.3e} finite={finite}')
    if not finite or excess > 0 or mean_abs > BF16_MEAN_TOL * scale + carried:
        fail(f'{name}: kernel disagrees with its plain version beyond one '
             f'unit in the last place and v\'s flips carried through conv2')
    return max_abs


def compare_sum(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A gradient summed over all rows: error against the tensor's
    largest value."""
    torch.cuda.synchronize()
    max_abs = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f'  {name}: max_abs_err={max_abs:.3e} of max|want|={scale:.3e}')
    if not torch.isfinite(got).all() or max_abs > WGRAD_TOL * scale:
        fail(f'{name}: kernel disagrees with its plain version '
             f'(max|got - want| <= {WGRAD_TOL} * max|want|)')
    return max_abs


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> dict:
    """The least time the card could take: operations over ``peak`` (the
    fp32 peak unless given) against bytes over the memory rate, whichever
    is larger."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {'bound_ms': max(ops_ms, bytes_ms),
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes'}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def away_from_kink(x, w1, b1, w2, b2, m1, m2, res, dilation: int,
                   margin: float = 1e-4) -> tuple:
    """The block's gradient jumps where a pre-activation crosses 0 (the
    kink of leaky), so two fp32 forwards that round differently may take
    different sides there.  Returns (m1, m2, res) changed so that no
    decision lies within ``margin`` of it: the masks drop the elements of
    a1 and a2 that do, and res moves by 1 where ``net + res`` does."""
    from fvt_tpu_torch.ops import tcn as tcn_ops
    a1 = tcn_ops._causal_conv(x, w1, b1, dilation)
    m1 = m1 * (a1.abs() >= margin)
    a2 = tcn_ops._causal_conv(tcn_ops._leaky(a1) * m1, w2, b2, dilation)
    m2 = m2 * (a2.abs() >= margin)
    z = tcn_ops._leaky(a2) * m2 + res
    return m1, m2, res + (z.abs() < margin)


def train_block_shapes(k: int, modality=TRAIN_MODALITY) -> list:
    """(name, B, T, Cin, Cout, dilation) of the blocks of the full-width
    LFAN on ``modality`` (8 for vggish+bert) at the training batch."""
    from fvt_tpu_torch.config import model_config as MC
    shapes = []
    for m in modality:
        cin = MC.EMBEDDING_DIM[m]
        for i, cout in enumerate(MC.TCN_CHANNELS[m]):
            shapes.append((f'{m}.{i}', TRAIN_BATCH, WINDOW, cin, cout,
                           2 ** i))
            cin = cout
    return shapes


def check_train_kernels(device, k: int = 5) -> list:
    """Phase 2, the train-mode block: the forward's output and the
    backward's six results against autograd of the plain version, for the
    split-TF32 kernels (``fused_temporal_block_train``, the training
    path's) and the earlier CUDA-core ones
    (``fused_temporal_block_train_simt``, on no path), at the 8 block
    shapes of the training path and at edge shapes; the backward bit for
    bit twice; times of the forward and of the backward alone (on a
    retained graph), and of each launch of the split-TF32 C entries alone
    at the 8 blocks."""
    from fvt_tpu_torch.ops import tcn as tcn_ops

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    names = ('x', 'w1', 'b1', 'w2', 'b2', 'res')
    routes = {'tcn_block_train': tcn_ops.fused_temporal_block_train,
              'tcn_block_train_simt':
                  tcn_ops.fused_temporal_block_train_simt}
    tot = {r: {key: 0.0 for key in ('fwd_err', 'bwd_err', 'fwd_ms',
                                    'bwd_ms')} for r in routes}
    plain = {'fwd': 0.0, 'bwd': 0.0, 'fwd_flops': 0.0, 'fwd_bytes': 0.0,
             'bwd_bytes': 0.0}
    fwd_stages = {'pack': tcn_ops.PACK, 'conv1': tcn_ops.TRAIN_CONV1,
                  'conv2': tcn_ops.TRAIN_CONV2}
    bwd_stages = {'out_grad': tcn_ops.OUT_GRAD, 'pack_t': tcn_ops.PACK_T,
                  'd_a1': tcn_ops.D_A1, 'dx': tcn_ops.DX,
                  'dw2': tcn_ops.DW2, 'dw1': tcn_ops.DW1,
                  'db': tcn_ops.BIAS_GRADS}
    launch_ms = {key: 0.0 for key in (*fwd_stages, *bwd_stages)}
    # edge shapes, then mfcc's first block (Cin = 39, run on zero
    # channels) at the training batch, at dilations 1 and 8
    edge = [('edge T<halo', 2, 7, 64, 64, 8, TCN_DROPOUT),
            ('edge B=3', 3, 300, 128, 64, 1, TCN_DROPOUT),
            ('edge p=0', 2, 90, 48, 96, 4, 0.0),
            ('edge narrow', 1, 1, 20, 8, 2, TCN_DROPOUT),
            ('edge mfcc.0', TRAIN_BATCH, WINDOW, 39, 32, 1, TCN_DROPOUT),
            ('edge mfcc.0 d=8', TRAIN_BATCH, WINDOW, 39, 32, 8, TCN_DROPOUT)]
    main = [s + (TCN_DROPOUT,) for s in train_block_shapes(k)]
    for name, b, t, cin, cout, d, p in main + edge:
        timed = not name.startswith('edge')

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, device=device, generator=g) * scale

        def mask():
            keep = torch.full((b, t, cout), 1.0 - p, device=device)
            return torch.bernoulli(keep, generator=g) / (1.0 - p)

        a = {'x': randn(b, t, cin),
             'w1': randn(k, cin, cout, scale=(k * cin) ** -0.5),
             'b1': randn(cout, scale=0.1),
             'w2': randn(k, cout, cout, scale=(k * cout) ** -0.5),
             'b2': randn(cout, scale=0.1), 'res': randn(b, t, cout)}
        m1, m2, a['res'] = away_from_kink(
            a['x'], a['w1'], a['b1'], a['w2'], a['b2'], mask(), mask(),
            a['res'], d)
        cot = randn(b, t, cout)
        for v in a.values():
            v.requires_grad_(True)
        args = (a['x'], a['w1'], a['b1'], a['w2'], a['b2'], m1, m2, a['res'])
        kw = dict(kernel_size=k, dilation=d)
        leaves = [a[n] for n in names]

        def grads(out):
            return torch.autograd.grad(out, leaves, cot, retain_graph=True)

        want = tcn_ops.fused_temporal_block_train_ref(*args, **kw)
        want_g = grads(want)
        for route, fn in routes.items():
            got = fn(*args, **kw)
            label = f'{route} {name} ({b},{t},{cin})->{cout} d={d}'
            err = compare(label, got.detach(), want.detach())
            got_g = grads(got)
            bwd_err = 0.0
            for n, gg, wg in zip(names, got_g, want_g):
                check = compare if n in ('x', 'res') else compare_sum
                bwd_err = max(bwd_err, check(f'  d{n}', gg, wg))
            again = grads(got)
            if not all(torch.equal(p1, p2) for p1, p2 in zip(got_g, again)):
                fail(f'{label}: two runs of the backward differ in their '
                     f'bits')
            if not timed:
                continue
            with torch.no_grad():
                fwd = median_ms(lambda: fn(*args, **kw))
            bwd = median_ms(lambda: grads(got))
            print(f'    forward {fwd:.4f} ms, backward {bwd:.4f} ms')
            r = tot[route]
            r['fwd_err'] = max(r['fwd_err'], err)
            r['bwd_err'] = max(r['bwd_err'], bwd_err)
            r['fwd_ms'] += fwd
            r['bwd_ms'] += bwd
        if not timed:
            continue
        with torch.no_grad():
            fwd_plain = median_ms(
                lambda: tcn_ops.fused_temporal_block_train_ref(*args, **kw))
        bwd_plain = median_ms(lambda: grads(want))
        print(f'    plain: forward {fwd_plain:.4f} ms, backward '
              f'{bwd_plain:.4f} ms')
        plain['fwd'] += fwd_plain
        plain['bwd'] += bwd_plain
        # both convs forward; backward: an input-gradient and a
        # weight-gradient product of the same size for each conv
        plain['fwd_flops'] += 2.0 * b * t * k * (cin + cout) * cout
        # x w1 b1 w2 b2 m1 m2 res in; out and the saved a1, a2 out
        plain['fwd_bytes'] += nbytes(*args, want, want, want)
        # x w1 w2 m1 m2 res g and the saved a1, a2 in; six results out
        plain['bwd_bytes'] += nbytes(a['x'], a['w1'], a['w2'], m1, m2,
                                     a['res'], cot, want, want, *want_g)
        for key, ms in train_launch_ms(args, kw, cot, fwd_stages,
                                       bwd_stages).items():
            launch_ms[key] += ms
    for route in routes:
        r = tot[route]
        print(f'  {route} total over the 8 blocks: forward {r["fwd_ms"]:.4f}'
              f' ms, backward {r["bwd_ms"]:.4f} ms; plain forward '
              f'{plain["fwd"]:.4f} ms, backward {plain["bwd"]:.4f} ms')
    print('  tcn_block_train (split TF32) by launch over the 8 blocks: '
          + ', '.join(f'{key} {ms:.4f} ms' for key, ms in launch_ms.items()))
    rows = []
    for route, source, peak, products in (
            ('tcn_block_train', 'tcn_block_train_tf32x3.cu', PEAK_FLOPS_TF32,
             3), ('tcn_block_train_simt', 'tcn_block_train.cu', PEAK_FLOPS,
                  1)):
        r = tot[route]
        suffix = route[len('tcn_block_train'):]
        common = {'route': 'cuda', 'source': f'fvt_tpu_torch/csrc/{source}',
                  'library_ms': None}
        rows += [
            {'name': route, **common,
             'replaces': 'fvt_tpu/ops/tcn_pallas.py:143',
             'max_abs_err': r['fwd_err'], 'ms': r['fwd_ms'],
             'plain_ms': plain['fwd'],
             **bound(products * plain['fwd_flops'], plain['fwd_bytes'],
                     peak)},
            {'name': f'tcn_block_bwd{suffix}', **common,
             'replaces': 'fvt_tpu/ops/tcn_pallas.py:168',
             'max_abs_err': r['bwd_err'], 'ms': r['bwd_ms'],
             'plain_ms': plain['bwd'],
             **bound(products * 2.0 * plain['fwd_flops'],
                     plain['bwd_bytes'], peak)}]
    rows[0]['launch_ms'] = {n: launch_ms[n] for n in fwd_stages}
    rows[1]['launch_ms'] = {n: launch_ms[n] for n in bwd_stages}
    return rows


def train_launch_ms(args: tuple, kw: dict, cot, fwd_stages: dict,
                    bwd_stages: dict) -> dict:
    """Each launch of the split-TF32 train C entries alone, on one block's
    inputs and scratch (``ops.tcn.launch_train_tf32x3_forward`` and
    ``_backward`` with one stage bit), in ms."""
    from fvt_tpu_torch.ops import tcn as tcn_ops

    with torch.no_grad():
        x, w1, b1, w2, b2, m1, m2, res = (v.detach() for v in args)
        x, w1 = tcn_ops.pad_train_inputs(x, w1)
        b, t, cin = x.shape
        cout = w1.shape[-1]
        k, d = kw['kernel_size'], kw['dilation']
        saved = torch.empty(3, b, t, cout, device=x.device)
        out = torch.empty(b, t, cout, device=x.device)
        scratch = torch.empty(tcn_ops.train_scratch(b, t, cin, cout, k, d)[1],
                              device=x.device)
        fwd = (x, w1, b1, w2, b2, m1, m2, res, scratch, saved, out)
        tcn_ops.launch_train_tf32x3_forward(*fwd, **kw)
        ms = {key: median_ms(lambda: tcn_ops.launch_train_tf32x3_forward(
            *fwd, **kw, stages=stage)) for key, stage in fwd_stages.items()}
        shares = tcn_ops.train_shares(x, cout, k)
        scratch = torch.empty(tcn_ops.train_scratch(
            b, t, cin, cout, k, d, backward=True, shares=shares)[1],
            device=x.device)
        grads = (torch.empty_like(x), torch.empty_like(w1),
                 torch.empty(cout, device=x.device), torch.empty_like(w2),
                 torch.empty(cout, device=x.device), torch.empty_like(out))
        bwd = ((x, w1, w2, m1, m2, res), saved, cot, scratch, grads)
        bkw = dict(kw, shares=shares)
        tcn_ops.launch_train_tf32x3_backward(*bwd, **bkw)
        ms.update({key: median_ms(
            lambda: tcn_ops.launch_train_tf32x3_backward(
                *bwd, **bkw, stages=stage))
            for key, stage in bwd_stages.items()})
    return ms


def tcn_block_bounds(x, w: dict, out, k: int) -> tuple:
    """The eval TCN block's (operations, bytes) over the card's rates, in
    ms, for (the split-TF32 kernel, the SIMT kernel).  Operations: both
    convs and the downsample, three TF32 products a multiply at the TF32
    peak for the first, one at the fp32 peak for the second; bytes: x,
    the weights each reads (the kept packed parts; the plain weights), the
    biases and the output."""
    cin, cout = x.shape[-1], out.shape[-1]
    flops = 2.0 * x.shape[0] * x.shape[1] * cout * (
        k * (cin + cout) + (cin if w['wd'] is not None else 0))
    vecs = nbytes(w['b1'], w['b2'], w['bd'], x, out)
    packed = nbytes(*(t for pair in w['packed'] if pair is not None
                      for t in pair))
    plain = nbytes(w['w1'], w['w2'], w['wd'])
    return ((3 * flops / PEAK_FLOPS_TF32 * 1e3,
             (vecs + packed) / PEAK_BYTES * 1e3),
            (flops / PEAK_FLOPS * 1e3, (vecs + plain) / PEAK_BYTES * 1e3))


def check_kernels(model, device) -> list:
    """Phase 2: each kernel against its plain version at the serving
    path's shapes, on inputs that flow through the model's own weights.
    The eval TCN block: the split-TF32 kernel (``fused_temporal_block``,
    on the weights the model keeps packed) and the earlier CUDA-core
    kernel (``fused_temporal_block_simt``, timed, on no path) at the 12
    blocks, each launch of the first also timed alone, then at edge
    shapes and Cin = 39; shapes it must refuse.  Then the fusion on the
    TCNs' outputs (:func:`check_fusion_kernels`)."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import tcn as tcn_ops
    from fvt_tpu_torch.models.layers import fold_batchnorm

    g = torch.Generator(device=device).manual_seed(SEED)
    k = model.temporal[MODALITY[0]].kernel_size
    kernels = {'tcn_block': lambda args, kw, w: tcn_ops.fused_temporal_block(
                   *args, **kw, packed=w['packed']),
               'tcn_block_simt': lambda args, kw, w:
                   tcn_ops.fused_temporal_block_simt(*args, **kw)}
    tot = {name: {key: 0.0 for key in ('err', 'ms', 'ops_ms', 'bytes_ms')}
           for name in kernels}
    tcn_plain_ms = 0.0
    launch_ms = {'conv1': 0.0, 'downsample': 0.0, 'conv2': 0.0}
    stages = {'conv1': tcn_ops.CONV1, 'downsample': tcn_ops.DOWNSAMPLE,
              'conv2': tcn_ops.CONV2}
    feats = {}
    with torch.inference_mode():
        for m in MODALITY:
            net = model.temporal[m]
            cin = net.network[0].conv1.weight_v.shape[1]
            x = torch.randn(WINDOW_BATCH, WINDOW, cin, device=device,
                            generator=g)
            for i, blk in enumerate(net.network):
                w = blk.eval_weights()
                args = (x, w['w1'], w['b1'], w['w2'], w['b2'], w['wd'],
                        w['bd'])
                kw = dict(kernel_size=k, dilation=2 ** i)
                want = tcn_ops.fused_temporal_block_ref(*args, **kw)
                shape = (f'{m}.{i} ({WINDOW_BATCH},{WINDOW},'
                         f'{x.shape[-1]})->{want.shape[-1]} d={2 ** i}')
                errs = {name: compare(f'{name} {shape}', fn(args, kw, w),
                                      want)
                        for name, fn in kernels.items()}
                plain = median_ms(lambda: tcn_ops.fused_temporal_block_ref(
                    *args, **kw))
                tcn_plain_ms += plain
                bounds = dict(zip(kernels, tcn_block_bounds(x, w, want, k)))
                for name, fn in kernels.items():
                    t = tot[name]
                    ms = median_ms(lambda: fn(args, kw, w))
                    ops_ms, bytes_ms = bounds[name]
                    lower = max(ops_ms, bytes_ms)
                    print(f'    {name}: kernel {ms:.4f} ms, plain '
                          f'{plain:.4f} ms, bound {lower:.4f} ms by '
                          f'{"operations" if ops_ms >= bytes_ms else "bytes"}'
                          f', {lower / ms:.1%} of it')
                    t['err'] = max(t['err'], errs[name])
                    t['ms'] += ms
                    t['ops_ms'] += ops_ms
                    t['bytes_ms'] += bytes_ms
                # the split-TF32 kernel's launches, each alone on the same
                # workspaces
                xp = tcn_ops.pad_channels(x)
                h, r, out = (torch.empty(want.shape, device=device)
                             for _ in range(3))
                alone = {}
                for key, stage in stages.items():
                    if key == 'downsample' and w['wd'] is None:
                        continue
                    alone[key] = median_ms(lambda: tcn_ops.launch_tf32x3(
                        xp, w['packed'], w['b1'], w['b2'], w['bd'], h, r,
                        out, stages=stage, **kw))
                    launch_ms[key] += alone[key]
                print('    tcn_block launches alone: ' + ', '.join(
                    f'{key} {ms:.4f} ms' for key, ms in alone.items()))
                x = want.contiguous()
                del h, r, out
            scale, shift = fold_batchnorm(model.bn[m])
            feats[m] = x * scale + shift

        # edge cases the serving shapes do not reach: a row shorter than
        # the halo, a tile-multiple length, widths off the model's, a
        # dilation whose halo takes 128 rows, and the mfcc width (Cin = 39,
        # which the split-TF32 kernel takes through zero channels)
        for (b, t, cin, cout, d, ds) in [(2, 7, 64, 64, 8, False),
                                         (3, 32, 48, 128, 4, True),
                                         (1, 1, 20, 8, 1, True),
                                         (2, 90, 256, 256, 16, False),
                                         (WINDOW_BATCH, WINDOW, 39, 32, 1,
                                          True)]:
            x = torch.randn(b, t, cin, device=device, generator=g)
            w1 = torch.randn(k, cin, cout, device=device, generator=g) * 0.1
            w2 = torch.randn(k, cout, cout, device=device, generator=g) * 0.1
            b1, b2, bd = (torch.randn(cout, device=device, generator=g)
                          for _ in range(3))
            wd = torch.randn(cin, cout, device=device, generator=g) * 0.1
            args = (x, w1, b1, w2, b2, wd if ds else None,
                    bd if ds else None)
            kw = dict(kernel_size=k, dilation=d)
            want = tcn_ops.fused_temporal_block_ref(*args, **kw)
            w = {'packed': None}
            for name, fn in kernels.items():
                compare(f'{name} edge ({b},{t},{cin})->{cout} d={d} '
                        f'ds={ds}', fn(args, kw, w), want)

        # long kernels (the taps in groups, csrc/tcn_block_tf32x3.cu): at
        # full width and the serving shape, video.0's widths with K = 11 at
        # d = 8 (two groups of six, one zero tap) and 256 -> 256 with K = 5
        # at d = 64 (a halo of 256 rows: two boxes of three taps), weights
        # at the model's init scale; and d = 64 on a row shorter than a
        # tile, the shape the kernel refused before the groups
        long_ms = {}
        for (b, t, cin, cout, kk, d) in [
                (WINDOW_BATCH, WINDOW, 512, 256, 11, 8),
                (WINDOW_BATCH, WINDOW, 256, 256, 5, 64),
                (1, 8, 16, 16, k, 64)]:
            x = torch.randn(b, t, cin, device=device, generator=g)
            w1 = torch.randn(kk, cin, cout, device=device,
                             generator=g) * (kk * cin) ** -0.5
            w2 = torch.randn(kk, cout, cout, device=device,
                             generator=g) * (kk * cout) ** -0.5
            b1, b2, bd = (torch.randn(cout, device=device, generator=g) * 0.1
                          for _ in range(3))
            wd = (torch.randn(cin, cout, device=device, generator=g)
                  * cin ** -0.5 if cin != cout else None)
            args = (x, w1, b1, w2, b2, wd, None if wd is None else bd)
            kw = dict(kernel_size=kk, dilation=d)
            packed = tcn_ops.pack_block_weights(w1, w2, wd, dilation=d)
            want = tcn_ops.fused_temporal_block_ref(*args, **kw)
            label = (f'tcn_block long ({b},{t},{cin})->{cout} K={kk} d={d}, '
                     f'(G, groups) = {tcn_ops.tap_groups(kk, d)}')
            compare(label, tcn_ops.fused_temporal_block(
                *args, **kw, packed=packed), want)
            if b == WINDOW_BATCH:
                ms = median_ms(lambda: tcn_ops.fused_temporal_block(
                    *args, **kw, packed=packed))
                plain = median_ms(lambda: tcn_ops.fused_temporal_block_ref(
                    *args, **kw))
                long_ms[label.split(', ')[0]] = (ms, plain)
                print(f'    kernel {ms:.4f} ms, plain {plain:.4f} ms')

        # Cout = 12 is no multiple of 8: the wrapper raises; the C entry
        # refuses C = 6
        before = tcn_ops.fused_temporal_block.launches
        x = torch.randn(1, 8, 16, device=device, generator=g)
        w1 = torch.randn(k, 16, 12, device=device, generator=g)
        w2 = torch.randn(k, 12, 12, device=device, generator=g)
        bias = torch.zeros(12, device=device)
        try:
            tcn_ops.fused_temporal_block(
                x, w1, bias, w2, bias, torch.zeros(16, 12, device=device),
                bias, kernel_size=k, dilation=1)
        except ValueError as e:
            print(f'  tcn_block Cout=12 refused: {e}')
        else:
            fail('fused_temporal_block took Cout=12')
        code = build.library().fvt_tcn_block_tf32x3_forward(
            *([x.data_ptr()] * 13), 1, 8, 6, 8, k, 1, tcn_ops.ALL,
            torch.cuda.current_stream(device).cuda_stream)
        if code == 0:
            fail('the split-TF32 tcn_block entry took C = 6')
        if tcn_ops.fused_temporal_block.launches != before:
            fail('a refused tcn_block counted a launch')

        fusion_out = check_fusion_kernels(model.fusion, feats, device, g)
    out = []
    for name, source in (('tcn_block', 'tcn_block_tf32x3.cu'),
                         ('tcn_block_simt', 'tcn_block.cu')):
        t = tot[name]
        lower = max(t['ops_ms'], t['bytes_ms'])
        print(f'  {name} total over the 12 blocks: kernel {t["ms"]:.4f} ms, '
              f'plain {tcn_plain_ms:.4f} ms, bound {lower:.4f} ms '
              f'({lower / t["ms"]:.1%} of it)')
        out.append({'name': name, 'route': 'cuda',
                    'source': f'fvt_tpu_torch/csrc/{source}',
                    'replaces': 'fvt_tpu/ops/tcn_pallas.py:35',
                    'max_abs_err': t['err'], 'ms': t['ms'],
                    'plain_ms': tcn_plain_ms, 'library_ms': None,
                    'bound_ms': lower,
                    'bound_by': ('operations' if t['ops_ms'] >= t['bytes_ms']
                                 else 'bytes')})
    print('  tcn_block (split TF32) by launch over the 12 blocks: '
          + ', '.join(f'{key} {ms:.4f} ms' for key, ms in launch_ms.items()))
    out[0]['launch_ms'] = launch_ms
    out[0]['long_kernels_ms'] = long_ms
    return out + fusion_out


def fusion_bounds(args: tuple, modal_dim: int) -> tuple:
    """The fusion's (operations, bytes) over the card's rates, in ms, for
    (the split-TF32 kernel, the SIMT kernel).  Operations: the qkv
    projections and o_proj, three TF32 products a multiply at the TF32
    peak for the first, one at the fp32 peak for the second, and the
    M x M scores and values per head at the fp32 peak for both (the
    softmax and LayerNorm are not counted); bytes, the same for both: what
    the function must move, x, the plain weights and vectors read once
    and y written once (not the split kernel's packed, padded parts)."""
    xs, wqkv, bqkv, wo, bo, ln_s, ln_b = args
    m = len(xs)
    frames = xs[0].shape[0] * xs[0].shape[1]
    em = modal_dim * m
    products = 2.0 * frames * (sum(x.shape[-1] for x in xs) * 3 * modal_dim
                               + em * em)
    attention = 2.0 * frames * 2 * m * m * modal_dim
    bytes_ms = (nbytes(*xs, *wqkv, *bqkv, wo, bo, ln_s, ln_b)
                + frames * em * 4) / PEAK_BYTES * 1e3
    return (((3 * products / PEAK_FLOPS_TF32 + attention / PEAK_FLOPS) * 1e3,
             bytes_ms),
            ((products + attention) / PEAK_FLOPS * 1e3, bytes_ms))


def check_fusion_kernels(fusion, feats: dict, device, g) -> list:
    """Phase 2, the fusion (B2): the split-TF32 kernel that serving
    launches (``fused_multimodal_fusion`` on the weights the module keeps
    packed) and the earlier CUDA-core kernel (``fused_multimodal_fusion_
    simt``, timed, on no path) against the plain version at the main
    path's (8, 300, {128, 32, 128}), then at five, seven and four wide
    modalities, at a head size padded to a slice (E = 36, H = 3), at two
    slices a head (E = 64, H = 2) and at the wide E*M that take cat
    through the workspace: 320 (E = 64 at five modalities), 576 (E = 96,
    H = 3 at six), 640 (E = 128 at five) and 1280 (E = 256, H = 4 at
    five; the split-TF32 kernel alone: the SIMT one does not take it),
    random weights at Linear's init scale: each call's median time with
    its wrapper, its device time (``torch.profiler``) and its bound; the
    C entry must refuse a wide E*M without a workspace.  Returns the two
    kernels' entries of the kernels line."""
    from fvt_tpu_torch.config import model_config as MC
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import fusion as fusion_ops
    from fvt_tpu_torch.tools.timing import device_ms

    names = {'fusion': ('fusion_tf32x3_kernel',),
             'fusion_simt': ('fusion_kernel',)}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=g) * scale

    def random_args(widths, e):
        em = e * len(widths)
        return ([randn(WINDOW_BATCH, WINDOW, c) for c in widths],
                [randn(c, 3 * e, scale=c ** -0.5) for c in widths],
                [randn(3 * e, scale=0.1) for _ in widths],
                randn(em, em, scale=em ** -0.5), randn(em, scale=0.1),
                1.0 + randn(em, scale=0.2), randn(em, scale=0.1))

    # the module's parameters, laid out as the SIMT kernel reads them (the
    # split-TF32 kernel reads the packed weights the module keeps)
    attn = fusion.layers.self_attn
    lins = [attn.qkv_proj[m] for m in MODALITY]
    e, h = fusion.modal_dim, fusion.num_heads
    cases = [('M=3 ' + '+'.join(MODALITY),
              ([feats[m] for m in MODALITY],
               [lin.weight.t().contiguous() for lin in lins],
               [lin.bias for lin in lins],
               attn.o_proj.weight.t().contiguous(), attn.o_proj.bias,
               fusion.layers.norm1.weight, fusion.layers.norm1.bias), e, h,
              fusion.eval_weights())]
    for mods in FUSION_MODALITIES:
        cases.append((f'M={len(mods)} {"+".join(mods)}',
                      random_args([MC.ENCODER_DIM[m] for m in mods], e), e,
                      h, None))
    main_widths = [MC.ENCODER_DIM[m] for m in MODALITY]
    for ce, ch in ((36, 3), (64, 2)):
        cases.append((f'M=3 E={ce} H={ch}', random_args(main_widths, ce), ce,
                      ch, None))
    five = [MC.ENCODER_DIM[m] for m in FUSION_MODALITIES[0]]
    six = [MC.ENCODER_DIM[m] for m in FUSION_MODALITIES[1][:6]]
    for label, widths, ce, ch in (('M=5 E=64 H=2', five, 64, 2),
                                  ('M=6 E=96 H=3', six, 96, 3),
                                  ('M=5 E=128 H=2', five, 128, 2),
                                  ('M=5 E=256 H=4', five, 256, 4)):
        cases.append((label, random_args(widths, ce), ce, ch, None))
    tot = {name: {'err': 0.0} for name in names}
    rows = {}
    with torch.inference_mode():
        for label, args, ce, ch, packed in cases:
            kw = dict(modal_dim=ce, num_heads=ch)
            if packed is None:
                packed = fusion_ops.pack_fusion_weights(*args[1:4], **kw)
            calls = {'fusion': lambda: fusion_ops.fused_multimodal_fusion(
                         *args, **kw, packed=packed),
                     'fusion_simt': lambda:
                         fusion_ops.fused_multimodal_fusion_simt(*args, **kw)}
            widths = [x.shape[-1] for x in args[0]]
            try:
                fusion_ops.fusion_route(tuple(widths), ce)
            except ValueError:  # beyond the SIMT kernel's shared memory
                del calls['fusion_simt']
            want = fusion_ops.fused_multimodal_fusion_ref(*args, **kw)
            row = {'plain_ms': median_ms(
                lambda: fusion_ops.fused_multimodal_fusion_ref(*args, **kw))}
            bounds = dict(zip(names, fusion_bounds(args, ce)))
            for name, call in calls.items():
                err = compare(f'{name} {label} ({WINDOW_BATCH},{WINDOW},'
                              f'{widths})', call(), want)
                ops_ms, bytes_ms = bounds[name]
                row[name] = {'max_abs_err': err, 'ms': median_ms(call),
                             'device_ms': device_ms(call, names[name]),
                             'bound_ms': max(ops_ms, bytes_ms),
                             'bound_by': ('operations' if ops_ms >= bytes_ms
                                          else 'bytes')}
                tot[name]['err'] = max(tot[name]['err'], err)
            rows[label] = row
            print('    ' + ', '.join(
                f'{name} {row[name]["ms"]:.4f} ms (device '
                + ('not measured' if row[name]['device_ms'] is None else
                   f'{row[name]["device_ms"]:.4f}, '
                   f'{row[name]["bound_ms"] / row[name]["device_ms"]:.1%} '
                   f'of the bound')
                + f'; bound {row[name]["bound_ms"]:.5f} by '
                f'{row[name]["bound_by"]})' for name in calls)
                + f', plain {row["plain_ms"]:.4f} ms')

        # a wide E*M without a workspace: the C entry refuses, no launch
        before = fusion_ops.fused_multimodal_fusion.launches
        args = random_args([32] * 5, 128)
        ptrs = (ctypes.c_void_p * 20)(*([args[0][0].data_ptr()] * 20))
        widths = (ctypes.c_int * 5)(*([32] * 5))
        code = build.library().fvt_fusion_tf32x3_forward(
            ptrs, widths, *([args[3].data_ptr()] * 6), None, 0, 16, 5, 128,
            2, torch.cuda.current_stream(device).cuda_stream)
        if code == 0:
            fail('the split-TF32 fusion entry took E*M = 640 without a '
                 'workspace')
        print(f'  fusion E*M=640 without a workspace refused: code {code}')
        if fusion_ops.fused_multimodal_fusion.launches != before:
            fail('a refused fusion counted a launch')
    main = rows[cases[0][0]]
    out = []
    for name, source in (('fusion', 'fusion_tf32x3.cu'),
                         ('fusion_simt', 'fusion.cu')):
        out.append({'name': name, 'route': 'cuda',
                    'source': f'fvt_tpu_torch/csrc/{source}',
                    'replaces': 'fvt_tpu/ops/fusion_pallas.py:25',
                    'max_abs_err': tot[name]['err'], 'ms': main[name]['ms'],
                    'plain_ms': main['plain_ms'], 'library_ms': None,
                    'bound_ms': main[name]['bound_ms'],
                    'bound_by': main[name]['bound_by'],
                    'device_ms': main[name]['device_ms'],
                    'cases': {label: {'ms': row[name]['ms'],
                                      'device_ms': row[name]['device_ms'],
                                      'bound_ms': row[name]['bound_ms'],
                                      'plain_ms': row['plain_ms']}
                              for label, row in rows.items() if name in row}})
    return out


def conv2d_library(x: torch.Tensor, kernel: torch.Tensor):
    """``F.conv2d`` on the NHWC x and the HWIO kernel: the result (NHWC)
    and the faster of its channels_last and NCHW times."""
    x_cl = x.permute(0, 3, 1, 2)
    w = kernel.permute(3, 2, 0, 1).contiguous()
    w_cl = w.contiguous(memory_format=torch.channels_last)
    out = F.conv2d(x_cl, w_cl, padding=1).permute(0, 2, 3, 1)
    ms_cl = median_ms(lambda: F.conv2d(x_cl, w_cl, padding=1), CONV_RUNS)
    x_nchw = x_cl.contiguous()
    ms_nchw = median_ms(lambda: F.conv2d(x_nchw, w, padding=1), CONV_RUNS)
    return out, min(ms_cl, ms_nchw), ('channels_last' if ms_cl <= ms_nchw
                                      else 'NCHW')


def derived_weights(k: torch.Tensor) -> dict:
    """What a ``Conv3x3`` module keeps of the HWIO kernel ``k``: the
    split-TF32 packing of B4, the Winograd transform U and its split-TF32
    packing for B6."""
    from fvt_tpu_torch.ops import conv as conv_ops
    from fvt_tpu_torch.ops import winograd as winograd_ops

    u = winograd_ops.transform_weights(k)
    return {'conv3x3': conv_ops.pack_weights_tf32(k), 'u': u,
            'winograd': winograd_ops.pack_winograd_weights_tf32(u)}


def winograd_stage_ms(x: torch.Tensor, k: torch.Tensor, d: dict) -> dict:
    """The three launches of the split-TF32 Winograd kernel at x's shape,
    each timed alone on the same workspace (median of CONV_RUNS calls),
    beside its own bound: the transforms' bytes; the products' operations
    (three TF32 products a multiply) at the TF32 peak or V, U and M's
    bytes, whichever is larger."""
    from fvt_tpu_torch.ops import winograd as winograd_ops

    n, h, w, c = x.shape
    co = k.shape[3]
    v, m = winograd_ops.workspace(x, co)
    out = torch.empty((n, h, w, co), device=x.device)
    flops = 3 * 2.0 * 16 * v.shape[1] * c * co
    bounds = {
        'input_transform': (winograd_ops.INPUT_TRANSFORM,
                            bound(0, nbytes(x, v))),
        'product': (winograd_ops.PRODUCT, bound(
            flops, nbytes(v, m, *d['winograd']), PEAK_FLOPS_TF32)),
        'output_transform': (winograd_ops.OUTPUT_TRANSFORM,
                             bound(0, nbytes(m, out)))}
    times = {}
    for name, (stage, lower) in bounds.items():
        ms = median_ms(lambda: winograd_ops.launch_tf32x3(
            x, d['winograd'], v, m, out, stage), CONV_RUNS)
        times[name] = (ms, lower['bound_ms'])
    del v, m, out
    return times


def check_conv_kernels(device) -> list:
    """Phase 2, the ArcFace body's float32 3x3 convs: the split-TF32
    tensor-core kernel (``conv3x3``, the ``shifted_kernel`` path), the
    earlier CUDA-core kernel (``conv3x3_simt``, timed, on no path), the
    split-TF32 Winograd kernel (``conv3x3_winograd``, the
    ``winograd_kernel`` path: input transform, product on the tensor
    cores, output transform) and the earlier CUDA-core Winograd kernel
    (``conv3x3_winograd_simt``, timed, on no path) against their plain
    versions and against ``F.conv2d`` at the seven conv shapes on FRAMES
    frames and at edge shapes; shapes the split-TF32 kernels do not take
    must raise.  Times are per shape, the Winograd kernel's also per
    launch; the kernels' line sums them over the 45 launches of one
    backbone forward.  The split-TF32 kernels' bounds take their three
    TF32 products at the tensor cores' TF32 peak (the CUDA-core bound of
    the direct conv is printed beside it) and the bytes the function must
    move (x, the kept weights, y); for the Winograd kernel the bytes of
    its three launches, V and M included, are printed beside that."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import conv as conv_ops
    from fvt_tpu_torch.ops import winograd as winograd_ops

    g = torch.Generator(device=device).manual_seed(SEED + 4)
    frames = WINDOW_BATCH * WINDOW
    kernels = {
        # the weights derived once, as the module keeps them
        'conv3x3': dict(
            fn=lambda x, k, d: conv_ops.conv3x3(x, k, packed=d['conv3x3']),
            ref=conv_ops.conv3x3_ref, tol=KERNEL_RTOL),
        'conv3x3_simt': dict(fn=lambda x, k, d: conv_ops.conv3x3_simt(x, k),
                             ref=conv_ops.conv3x3_ref, tol=KERNEL_RTOL),
        'winograd': dict(
            fn=lambda x, k, d: winograd_ops.conv3x3_winograd(
                x, k, d['u'], packed=d['winograd']),
            ref=winograd_ops.conv3x3_winograd_ref, tol=WINOGRAD_RTOL),
        'winograd_simt': dict(
            fn=lambda x, k, d: winograd_ops.conv3x3_winograd_simt(
                x, k, d['u']),
            ref=winograd_ops.conv3x3_winograd_ref, tol=WINOGRAD_RTOL)}
    tot = {name: {key: 0.0 for key in (
        'err', 'ms', 'plain', 'library', 'ops_ms', 'bytes_ms', 'direct_ms')}
        for name in kernels}
    stages = {key: [0.0, 0.0] for key in (
        'input_transform', 'product', 'output_transform')}
    design_bytes_ms, workspace_gb = 0.0, 0.0

    def inputs(n, h, w, cin, cout):
        x = torch.randn(n, h, w, cin, device=device, generator=g)
        k = torch.randn(3, 3, cin, cout, device=device, generator=g)
        return x, k * (9 * cin) ** -0.5

    with torch.inference_mode():
        for h, cin, cout, count in CONV_SHAPES:
            x, k = inputs(frames, h, h, cin, cout)
            derived = derived_weights(k)
            cudnn, library_ms, layout = conv2d_library(x, k)
            shape = f'({frames},{h},{h},{cin})->{cout}'
            direct_flops = 2.0 * 9 * frames * h * h * cin * cout
            plain = {}
            for name, kern in kernels.items():
                t = tot[name]
                fn, ref, tol = kern['fn'], kern['ref'], kern['tol']
                got = fn(x, k, derived)
                want = ref(x, k)
                err = compare(f'{name} {shape}', got, want, tol, tol)
                compare(f'{name} {shape} vs F.conv2d', got, cudnn, tol, tol,
                        'F.conv2d')
                del want
                ms = median_ms(lambda: fn(x, k, derived), CONV_RUNS)
                # each pair of kernels shares one plain version
                if ref not in plain:
                    plain[ref] = median_ms(lambda: ref(x, k), 3, warmup=1)
                # Winograd's own count: 16 products a 2x2 tile
                winograd_flops = 2.0 * 16 * frames * (
                    (h + 1) // 2) ** 2 * cin * cout
                weights = k
                if name == 'conv3x3':  # three TF32 products a multiply
                    flops, peak = 3 * direct_flops, PEAK_FLOPS_TF32
                    weights = derived['conv3x3']
                elif name == 'conv3x3_simt':
                    flops, peak = direct_flops, PEAK_FLOPS
                elif name == 'winograd':
                    flops, peak = 3 * winograd_flops, PEAK_FLOPS_TF32
                    weights = derived['winograd']
                else:
                    flops, peak = winograd_flops, PEAK_FLOPS
                    weights = derived['u']
                moved = nbytes(x, got, *(
                    weights if isinstance(weights, tuple) else (weights,)))
                lower = bound(flops, moved, peak)
                print(f'    x{count} a forward: kernel {ms:.4f} ms '
                      f'({direct_flops / ms / 1e9:.1f} TFLOP/s of the direct '
                      f'conv), plain {plain[ref]:.4f} ms, F.conv2d ({layout}) '
                      f'{library_ms:.4f} ms, bound {lower["bound_ms"]:.4f} '
                      f'ms by {lower["bound_by"]} ({flops / 1e9:.1f} GFLOP '
                      f'at {peak / 1e12:.1f} TFLOP/s; the direct conv on the '
                      f'CUDA cores: {direct_flops / PEAK_FLOPS * 1e3:.4f} ms)')
                t['err'] = max(t['err'], err)
                t['ms'] += count * ms
                t['plain'] += count * plain[ref]
                t['library'] += count * library_ms
                t['ops_ms'] += count * flops / peak * 1e3
                t['bytes_ms'] += count * moved / PEAK_BYTES * 1e3
                t['direct_ms'] += count * direct_flops / PEAK_FLOPS * 1e3
                del got
            # the Winograd kernel's three launches, each alone
            split = winograd_stage_ms(x, k, derived)
            p = frames * ((h + 1) // 2) ** 2
            # V and M, written and read once each, beside x, U and y
            design = (2 * 16 * p * (cin + cout) * 4
                      + nbytes(x, *derived['winograd']) + 4 * frames * h * h
                      * cout) / PEAK_BYTES * 1e3
            work = 16 * p * (cin + cout) * 4 / 1e9
            workspace_gb = max(workspace_gb, work)
            design_bytes_ms += count * design
            print('    winograd by launch: ' + ', '.join(
                f'{key} {ms:.4f} ms (bound {b:.4f})'
                for key, (ms, b) in split.items())
                + f'; the three launches\' bytes at {PEAK_BYTES / 1e12} '
                f'TB/s {design:.4f} ms; workspace V + M {work:.3f} GB')
            for key, (ms, b) in split.items():
                stages[key][0] += count * ms
                stages[key][1] += count * b
            del x, k, cudnn, derived

        # odd extents, Cin != Cout below a column tile, single pixels, C not
        # a multiple of 8, ragged column tiles, and P over four row tiles of
        # the Winograd product with a ragged end (828 tiles); for the
        # split-TF32 kernel also rows so wide that
        # the ring has two slots (BN = 64 at W = 400, BN = 128 at W = 150)
        # or one (BN = 128 at W = 200; BN = 64 at W = 894, the widest)
        edge = [(3, 7, 9, 32, 16), (1, 1, 1, 4, 4), (1, 2, 2, 8, 4),
                (5, 5, 5, 64, 200), (2, 13, 6, 20, 36), (3, 23, 45, 12, 132)]
        wide = [(2, 3, 400, 16, 64), (2, 3, 150, 12, 128),
                (2, 3, 200, 16, 128), (1, 2, 894, 8, 64)]
        for n, h, w, cin, cout in edge + wide:
            x, k = inputs(n, h, w, cin, cout)
            cudnn = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                             padding=1).permute(0, 2, 3, 1)
            for name, kern in kernels.items():
                if (n, h, w, cin, cout) in wide and name != 'conv3x3':
                    continue
                shape = f'{name} edge ({n},{h},{w},{cin})->{cout}'
                got = kern['fn'](x, k, derived_weights(k))
                compare(shape, got, kern['ref'](x, k), kern['tol'],
                        kern['tol'])
                compare(f'{shape} vs F.conv2d', got, cudnn, kern['tol'],
                        kern['tol'], 'F.conv2d')

        # C = 6 is no multiple of 4 (a TMA chunk): the wrapper raises and the
        # C entry itself refuses; W = 895 needs more loads a slice than the
        # producer warp has lanes: the C entry refuses and the wrapper raises
        before = conv_ops.conv3x3.launches
        x, k = inputs(2, 5, 5, 6, 8)
        try:
            conv_ops.conv3x3(x, k)
        except ValueError as e:
            print(f'  conv3x3 C=6 refused: {e}')
        else:
            fail('conv3x3 took a float32 tensor with C = 6')
        code = build.library().fvt_conv3x3_tf32x3_forward(
            x.data_ptr(), k.data_ptr(), k.data_ptr(),
            torch.empty(2, 5, 5, 8, device=device).data_ptr(), 2, 5, 5, 6, 8,
            64, torch.cuda.current_stream(device).cuda_stream)
        if code == 0:
            fail('the split-TF32 conv entry took C = 6')
        x, k = inputs(1, 2, 895, 16, 128)
        try:
            conv_ops.conv3x3(x, k)
        except RuntimeError as e:
            print(f'  conv3x3 W=895 refused: {e}')
        else:
            fail('conv3x3 took a float32 tensor with W = 895')
        if conv_ops.conv3x3.launches != before:
            fail('a refused float32 conv counted a launch')

        # the Winograd kernel takes C and Co in multiples of 4 only: the
        # wrapper raises, and the C entry itself refuses C = 6
        before = winograd_ops.conv3x3_winograd.launches
        for cin, cout in ((6, 8), (8, 6)):
            x, k = inputs(2, 5, 5, cin, cout)
            try:
                winograd_ops.conv3x3_winograd(x, k)
            except ValueError as e:
                print(f'  winograd C={cin} Co={cout} refused: {e}')
            else:
                fail(f'conv3x3_winograd took C = {cin}, Co = {cout}')
        x, k = inputs(2, 5, 5, 6, 8)
        v, m = winograd_ops.workspace(x, 8)
        code = build.library().fvt_winograd_tf32x3_forward(
            x.data_ptr(), k.data_ptr(), k.data_ptr(), v.data_ptr(),
            m.data_ptr(), torch.empty(2, 5, 5, 8, device=device).data_ptr(),
            2, 5, 5, 6, 8, 64, winograd_ops.ALL_STAGES,
            torch.cuda.current_stream(device).cuda_stream)
        if code == 0:
            fail('the split-TF32 Winograd entry took C = 6')
        if winograd_ops.conv3x3_winograd.launches != before:
            fail('a refused Winograd conv counted a launch')
    print('  winograd (split TF32) by launch over the 45 convs: ' + ', '.join(
        f'{key} {ms:.4f} ms (bound {b:.4f})'
        for key, (ms, b) in stages.items())
        + f'; the three launches\' bytes {design_bytes_ms:.4f} ms; largest '
        f'workspace V + M {workspace_gb:.3f} GB')
    out = []
    for name, source, replaces in (
            ('conv3x3', 'conv3x3_tf32x3.cu', 'conv_pallas.py:20'),
            ('conv3x3_simt', 'conv3x3.cu', 'conv_pallas.py:20'),
            ('winograd', 'winograd_tf32x3.cu', 'winograd.py:148'),
            ('winograd_simt', 'winograd.cu', 'winograd.py:148')):
        t = tot[name]
        by_ops = t['ops_ms'] >= t['bytes_ms']
        lower = max(t['ops_ms'], t['bytes_ms'])
        print(f'  {name} total over the 45 convs of a forward: kernel '
              f'{t["ms"]:.4f} ms, plain {t["plain"]:.4f} ms, F.conv2d '
              f'{t["library"]:.4f} ms, bound {lower:.4f} ms '
              f'({lower / t["ms"]:.1%} of it), the direct conv on the CUDA '
              f'cores {t["direct_ms"]:.4f} ms')
        out.append({'name': name, 'route': 'cuda',
                    'source': f'fvt_tpu_torch/csrc/{source}',
                    'replaces': f'fvt_tpu/ops/{replaces}',
                    'max_abs_err': t['err'], 'ms': t['ms'],
                    'plain_ms': t['plain'], 'library_ms': t['library'],
                    'bound_ms': lower,
                    'bound_by': 'operations' if by_ops else 'bytes',
                    'direct_conv_bound_ms': t['direct_ms']})
    out[2]['launch_ms'] = {key: ms for key, (ms, _) in stages.items()}
    out[2]['launches_bytes_bound_ms'] = design_bytes_ms
    out[2]['workspace_gb'] = workspace_gb
    return out


def check_conv_bf16_kernel(device) -> dict:
    """Phase 2, the bfloat16 tensor-core 3x3 conv: the kernel against its
    plain version (fp32 sums of the exact products, one rounding) and
    against ``F.conv2d`` on the same bfloat16 tensors, at the seven conv
    shapes on FRAMES frames and at edge shapes; a channel count it does
    not take must raise.  The bound takes the tensor cores' bf16 peak and
    2-byte elements."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import conv as conv_ops

    g = torch.Generator(device=device).manual_seed(SEED + 6)
    frames = WINDOW_BATCH * WINDOW
    tot = {key: 0.0 for key in ('err', 'ms', 'plain', 'library', 'bound')}
    by = set()

    def inputs(n, h, w, cin, cout):
        x = torch.randn(n, h, w, cin, device=device, generator=g)
        k = torch.randn(3, 3, cin, cout, device=device, generator=g)
        return x.bfloat16(), (k * (9 * cin) ** -0.5).bfloat16()

    with torch.inference_mode():
        for h, cin, cout, count in CONV_SHAPES:
            x, k = inputs(frames, h, h, cin, cout)
            cudnn, library_ms, layout = conv2d_library(x, k)
            shape = f'conv3x3_bf16 ({frames},{h},{h},{cin})->{cout}'
            # the weights packed once, as the module keeps them
            packed = conv_ops.pack_weights(k)
            got = conv_ops.conv3x3(x, k, packed=packed)
            err = compare_bf16(shape, got, conv_ops.conv3x3_ref(x, k))
            compare_bf16(f'{shape} vs F.conv2d', got, cudnn, 'F.conv2d')
            del cudnn
            ms = median_ms(lambda: conv_ops.conv3x3(x, k, packed=packed),
                           CONV_RUNS)
            plain = median_ms(lambda: conv_ops.conv3x3_ref(x, k), 3,
                              warmup=1)
            flops = 2.0 * 9 * frames * h * h * cin * cout
            lower = bound(flops, nbytes(x, k, got), PEAK_FLOPS_BF16)
            print(f'    x{count} a forward: kernel {ms:.4f} ms '
                  f'({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, '
                  f'F.conv2d bf16 ({layout}) {library_ms:.4f} ms, bound '
                  f'{lower["bound_ms"]:.4f} ms by {lower["bound_by"]} '
                  f'({flops / 1e9:.1f} GFLOP, '
                  f'{nbytes(x, k, got) / 1e6:.1f} MB)')
            tot['err'] = max(tot['err'], err)
            tot['ms'] += count * ms
            tot['plain'] += count * plain
            tot['library'] += count * library_ms
            tot['bound'] += count * lower['bound_ms']
            by.add(lower['bound_by'])
            del x, k, got, packed

        # edge shapes, the weights packed by the call: odd extents, single
        # pixels, Cin != Cout, a ragged column tile (Co = 200), the
        # smallest C (one k16 step), a row so wide that the ring has two
        # slots (W = 720)
        for n, h, w, cin, cout in [(3, 7, 9, 32, 16), (1, 1, 1, 16, 8),
                                   (1, 2, 2, 16, 8), (5, 5, 5, 64, 200),
                                   (2, 13, 6, 16, 40), (7, 10, 10, 256, 256),
                                   (2, 3, 720, 16, 8)]:
            x, k = inputs(n, h, w, cin, cout)
            cudnn = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                             padding=1).permute(0, 2, 3, 1)
            shape = f'conv3x3_bf16 edge ({n},{h},{w},{cin})->{cout}'
            got = conv_ops.conv3x3(x, k)
            compare_bf16(shape, got, conv_ops.conv3x3_ref(x, k))
            compare_bf16(f'{shape} vs F.conv2d', got, cudnn, 'F.conv2d')

        # C = 20 is no multiple of wgmma's k16 step: the wrapper raises and
        # the C entry itself refuses, neither goes to another kernel
        x, k = inputs(2, 13, 6, 20, 40)
        before = conv_ops.conv3x3.launches
        try:
            conv_ops.conv3x3(x, k)
        except ValueError as e:
            print(f'  conv3x3_bf16 C=20 refused: {e}')
        else:
            fail('conv3x3 took a bfloat16 tensor with C = 20')
        code = build.library().fvt_conv3x3_bf16_forward(
            x.data_ptr(), k.data_ptr(), torch.empty_like(x).data_ptr(), 2, 13,
            6, 20, 40, 64, torch.cuda.current_stream(device).cuda_stream)
        if code == 0 or conv_ops.conv3x3.launches != before:
            fail(f'the bfloat16 conv entry returned {code} for C = 20')
        # a row too wide for the shared memory: the C entry refuses and
        # the wrapper raises
        x, k = inputs(1, 2, 1200, 16, 8)
        try:
            conv_ops.conv3x3(x, k)
        except RuntimeError as e:
            print(f'  conv3x3_bf16 W=1200 refused: {e}')
        else:
            fail('conv3x3 took a bfloat16 tensor with W = 1200')
        if conv_ops.conv3x3.launches != before:
            fail('a refused bfloat16 conv counted a launch')
    print(f'  conv3x3_bf16 total over the 45 convs of a forward: kernel '
          f'{tot["ms"]:.4f} ms, plain {tot["plain"]:.4f} ms, F.conv2d bf16 '
          f'{tot["library"]:.4f} ms, bound {tot["bound"]:.4f} ms')
    # bound_ms sums the per-shape bounds; bound_by names what bounds most
    # of it (40x40x64 alone is bound by bytes)
    return {'name': 'conv3x3_bf16', 'route': 'cuda',
            'source': 'fvt_tpu_torch/csrc/conv3x3_wgmma.cu',
            'replaces': 'fvt_tpu/ops/conv_pallas.py:20',
            'max_abs_err': tot['err'], 'ms': tot['ms'],
            'plain_ms': tot['plain'], 'library_ms': tot['library'],
            'bound_ms': tot['bound'],
            'bound_by': 'operations' if 'operations' in by else 'bytes'}


def check_bottleneck_kernel(device) -> list:
    """Phase 2, the fused BottleneckIR block (B5): the split-TF32 kernel
    (``bottleneck_ir_fused``, the ``fused_blocks`` path: conv1 with bn1
    applied where x is split and PReLU in its store, into the workspace v,
    then conv2 with bn2 and the residual in its store) and the earlier
    CUDA-core kernel (``bottleneck_ir_fused_simt``, timed, on no path)
    against their plain version (the eval block on cuDNN) at the four
    stage shapes on FRAMES frames, BatchNorm affines and PReLU slopes off
    their init values, and at edge shapes, one of them with bn1's shift
    at 20 so that a pad which took b1 would show; C = 6 and W = 895 must
    be refused.  Each launch of the split-TF32 kernel is timed alone too.
    Bounds: the split-TF32 kernel's three TF32 products a multiply at the
    TF32 peak (each launch's and the block's), the SIMT kernel's products
    at the fp32 peak, each against the bytes it must move (the block: x,
    the kept weights, the five vectors, y; a launch also v).  No single
    PyTorch call computes the block."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import bottleneck as block_ops

    g = torch.Generator(device=device).manual_seed(SEED + 5)
    frames = WINDOW_BATCH * WINDOW
    kernels = {
        'bottleneck': lambda args, packed: block_ops.bottleneck_ir_fused(
            *args, packed=packed),
        'bottleneck_simt': lambda args, packed:
            block_ops.bottleneck_ir_fused_simt(*args)}
    tot = {name: {key: 0.0 for key in ('err', 'ms', 'plain', 'ops_ms',
                                       'bytes_ms')} for name in kernels}
    launch_ms = {'conv1': [0.0, 0.0], 'conv2': [0.0, 0.0]}
    workspace_gb = 0.0

    def inputs(n, h, w, c, b1_shift=0.0):
        def randn(*shape, scale=1.0, shift=0.0):
            return torch.randn(*shape, device=device,
                               generator=g) * scale + shift

        return (randn(n, h, w, c), randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                randn(c, scale=0.2, shift=1.0),
                randn(c, scale=0.5, shift=b1_shift),
                randn(c, scale=0.1, shift=0.25),
                randn(c, scale=0.2, shift=1.0), randn(c, scale=0.5))

    with torch.inference_mode():
        for h, c, count in BLOCK_SHAPES:
            args = inputs(frames, h, h, c)
            x, vecs = args[0], args[3:]
            # the split weights derived once, as the module keeps them
            packed = block_ops.pack_block_weights(args[1], args[2])
            want = block_ops.bottleneck_ir_fused_ref(*args)
            shape = f'({frames},{h},{h},{c})'
            errs = {}
            for name, fn in kernels.items():
                got = fn(args, packed)
                errs[name] = compare(f'{name} {shape}', got, want)
                del got
            del want
            plain = median_ms(
                lambda: block_ops.bottleneck_ir_fused_ref(*args), CONV_RUNS)
            conv_flops = 2.0 * 9 * frames * h * h * c * c
            moved = nbytes(x, *vecs, x)  # x in, y out
            v, out = torch.empty_like(x), torch.empty_like(x)
            workspace_gb = max(workspace_gb, nbytes(v) / 1e9)
            for name, fn in kernels.items():
                t = tot[name]
                ms = median_ms(lambda: fn(args, packed), CONV_RUNS)
                if name == 'bottleneck':
                    flops, peak = 3 * 2 * conv_flops, PEAK_FLOPS_TF32
                    weights = nbytes(*packed[0], *packed[1])
                else:
                    flops, peak = 2 * conv_flops, PEAK_FLOPS
                    weights = nbytes(args[1], args[2])
                lower = bound(flops, moved + weights, peak)
                print(f'    {name} x{count} a forward: kernel {ms:.4f} ms, '
                      f'plain (eval block on cuDNN) {plain:.4f} ms, bound '
                      f'{lower["bound_ms"]:.4f} ms by {lower["bound_by"]} '
                      f'({flops / 1e9:.1f} GFLOP at {peak / 1e12:.1f} '
                      f'TFLOP/s), {lower["bound_ms"] / ms:.1%} of it')
                t['err'] = max(t['err'], errs[name])
                t['ms'] += count * ms
                t['plain'] += count * plain
                t['ops_ms'] += count * flops / peak * 1e3
                t['bytes_ms'] += count * (moved + weights) / PEAK_BYTES * 1e3
            # the split-TF32 kernel's two launches, each alone on the same
            # workspace, beside its own bound
            per_launch = {
                'conv1': (block_ops.CONV1, nbytes(x, *packed[0], *vecs[:3], v)),
                'conv2': (block_ops.CONV2,
                          nbytes(v, *packed[1], *vecs[3:], x, out))}
            for key, (stage, launch_bytes) in per_launch.items():
                ms = median_ms(lambda: block_ops.launch_tf32x3(
                    x, packed, vecs, v, out, stage), CONV_RUNS)
                lower = bound(3 * conv_flops, launch_bytes, PEAK_FLOPS_TF32)
                print(f'    bottleneck {key} launch alone: {ms:.4f} ms, '
                      f'bound {lower["bound_ms"]:.4f} ms by '
                      f'{lower["bound_by"]}, {lower["bound_ms"] / ms:.1%} '
                      f'of it')
                launch_ms[key][0] += count * ms
                launch_ms[key][1] += count * lower['bound_ms']
            print(f'    workspace v {nbytes(v) / 1e9:.3f} GB')
            del args, x, vecs, packed, v, out

        # odd extents, a tile cut from the frame off the stage shapes,
        # several frames a block, single pixels; last, C = 20 (a channel
        # chunk beyond C) with bn1's shift at 20 on a padded line that ends
        # inside a row tile
        for n, h, w, c, shift in [
                (3, 7, 9, 32, 0.0), (1, 1, 1, 4, 0.0), (1, 2, 2, 8, 0.0),
                (2, 12, 12, 128, 0.0), (5, 10, 10, 64, 0.0),
                (3, 23, 17, 16, 0.0), (7, 5, 5, 512, 0.0),
                (3, 9, 11, 20, 20.0)]:
            args = inputs(n, h, w, c, shift)
            want = block_ops.bottleneck_ir_fused_ref(*args)
            for name, fn in kernels.items():
                compare(f'{name} edge ({n},{h},{w},{c}) b1 shift {shift}',
                        fn(args, None), want)

        # C = 6 is no multiple of 4: the wrapper raises and the C entry
        # refuses; W = 895 needs more loads a slice than the producer warp
        # has lanes: the C entry refuses and the wrapper raises
        before = block_ops.bottleneck_ir_fused.launches
        for (n, h, w, c), error in (((2, 5, 5, 6), ValueError),
                                    ((1, 2, 895, 8), RuntimeError)):
            args = inputs(n, h, w, c)
            try:
                block_ops.bottleneck_ir_fused(*args)
            except error as e:
                print(f'  bottleneck ({n},{h},{w},{c}) refused: {e}')
            else:
                fail(f'bottleneck_ir_fused took ({n},{h},{w},{c})')
        x = args[0]
        code = build.library().fvt_bottleneck_tf32x3_forward(
            *([x.data_ptr()] * 12), 2, 5, 5, 6, 64, block_ops.BOTH,
            torch.cuda.current_stream(device).cuda_stream)
        if code == 0:
            fail('the split-TF32 bottleneck entry took C = 6')
        if block_ops.bottleneck_ir_fused.launches != before:
            fail('a refused bottleneck counted a launch')
    print('  bottleneck (split TF32) by launch over the 21 blocks: ' + ', '.join(
        f'{key} {ms:.4f} ms (bound {b:.4f})'
        for key, (ms, b) in launch_ms.items())
        + f'; largest workspace v {workspace_gb:.3f} GB')
    out = []
    for name, source in (('bottleneck', 'conv3x3_tf32x3.cu'),
                         ('bottleneck_simt', 'bottleneck.cu')):
        t = tot[name]
        lower = max(t['ops_ms'], t['bytes_ms'])
        print(f'  {name} total over the 21 blocks of a forward: kernel '
              f'{t["ms"]:.4f} ms, plain {t["plain"]:.4f} ms, bound '
              f'{lower:.4f} ms ({lower / t["ms"]:.1%} of it)')
        out.append({'name': name, 'route': 'cuda',
                    'source': f'fvt_tpu_torch/csrc/{source}',
                    'replaces': 'fvt_tpu/ops/bottleneck_pallas.py:122',
                    'max_abs_err': t['err'], 'ms': t['ms'],
                    'plain_ms': t['plain'], 'library_ms': None,
                    'bound_ms': lower,
                    'bound_by': ('operations' if t['ops_ms'] >= t['bytes_ms']
                                 else 'bytes')})
    out[0]['launch_ms'] = {key: ms for key, (ms, _) in launch_ms.items()}
    out[0]['launch_bound_ms'] = {key: b for key, (_, b) in launch_ms.items()}
    out[0]['workspace_gb'] = workspace_gb
    return out


def check_bottleneck_bf16_kernel(device) -> dict:
    """Phase 2, bfloat16: the fused BottleneckIR block's bfloat16 route
    (``bottleneck_ir_fused`` on bfloat16 tensors, the ``fused_blocks``
    path under ``--amp``: two launches of the bfloat16 ``wgmma`` conv, bn1
    in a pass over conv1's staged slice, PReLU in conv1's store, bn2 and
    the residual in conv2's, v a bfloat16 workspace) against its plain
    version (``bottleneck_ir_fused_bf16_ref``, the Pallas kernel's
    rounding points) at the four stage shapes on FRAMES frames and at edge
    shapes (bn1's shift at 20 in three), on the weights a bfloat16
    ``BottleneckIR`` derives from random parameters, under
    compare_block_bf16's gate (each launch alone within one unit in the
    last place, the block within that plus v's flips carried through
    conv2).  Times
    of the kernel (each launch also alone), the plain version and the
    unfused bfloat16 block on cuDNN (BatchNorm2d, PReLU and the add as
    passes of their own); the bound: both convs' operations at the bf16
    peak against x, the kept weights, the five vectors and y."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.models.arcface import BottleneckIR
    from fvt_tpu_torch.ops import bottleneck as block_ops

    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    frames = WINDOW_BATCH * WINDOW
    tot = {key: 0.0 for key in ('err', 'ms', 'plain', 'cudnn', 'ops_ms',
                                'bytes_ms', 'conv1', 'conv2')}

    def block(c, b1_shift=0.0):
        """A bfloat16 identity block on the card, every parameter and
        running statistic off its init value."""
        blk = BottleneckIR(c, c, 1, 'cudnn', bf16).to(device).eval()

        def randn(shape, scale=1.0, shift=0.0):
            return torch.randn(shape, device=device,
                               generator=g) * scale + shift
        with torch.no_grad():
            for conv in (blk.res_layer[1], blk.res_layer[3]):
                conv.weight.copy_(randn(conv.weight.shape, (9 * c) ** -0.5))
            for bn, shift in ((blk.res_layer[0], b1_shift),
                              (blk.res_layer[4], 0.0)):
                bn.weight.copy_(randn(c, 0.2, 1.0))
                bn.bias.copy_(randn(c, 0.5, shift))
                bn.running_mean.copy_(randn(c, 0.1))
                bn.running_var.copy_(0.5 + randn(c).abs())
            blk.res_layer[2].weight.copy_(randn(c, 0.1, 0.25))
        return blk

    with torch.inference_mode():
        for h, c, count in BLOCK_SHAPES:
            blk = block(c)
            *args, packed = blk.fused_weights()
            x = torch.randn(frames, h, h, c, device=device,
                            generator=g).to(bf16)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last, as the backbone
            shape = f'bottleneck_bf16 ({frames},{h},{h},{c})'
            got = block_ops.bottleneck_ir_fused(x, *args, packed=packed)
            err = compare_block_bf16(shape, got, x, args, packed)
            unfused = blk(x_nchw).permute(0, 2, 3, 1)
            own = (unfused.float() - got.float()).abs().max().item()
            print(f'    max |fused - unfused bf16 block on cuDNN| = '
                  f'{own:.3e} (other rounding points: bf16 BatchNorm, '
                  f'PReLU and add passes)')
            del got, unfused
            ms = median_ms(lambda: block_ops.bottleneck_ir_fused(
                x, *args, packed=packed), CONV_RUNS)
            plain = median_ms(lambda: block_ops.bottleneck_ir_fused_bf16_ref(
                x, *args), 3, warmup=1)
            cudnn = median_ms(lambda: blk(x_nchw), CONV_RUNS)
            flops = 2 * 2.0 * 9 * frames * h * h * c * c
            moved = nbytes(x, *packed, *args[2:], x)  # x in, y out
            lower = bound(flops, moved, PEAK_FLOPS_BF16)
            v, out = torch.empty_like(x), torch.empty_like(x)
            alone = {}
            for key, stage in (('conv1', block_ops.CONV1),
                               ('conv2', block_ops.CONV2)):
                alone[key] = median_ms(lambda: block_ops.launch_bf16(
                    x, packed, tuple(args[2:]), v, out, stage), CONV_RUNS)
                tot[key] += count * alone[key]
            print(f'    x{count} a forward: kernel {ms:.4f} ms (conv1 '
                  f'{alone["conv1"]:.4f}, conv2 {alone["conv2"]:.4f} alone), '
                  f'plain {plain:.4f} ms, unfused bf16 block on cuDNN '
                  f'{cudnn:.4f} ms, bound {lower["bound_ms"]:.4f} ms by '
                  f'{lower["bound_by"]} ({flops / 1e9:.1f} GFLOP at '
                  f'{PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s, {moved / 1e6:.1f} '
                  f'MB), {lower["bound_ms"] / ms:.1%} of it')
            tot['err'] = max(tot['err'], err)
            tot['ms'] += count * ms
            tot['plain'] += count * plain
            tot['cudnn'] += count * cudnn
            tot['ops_ms'] += count * flops / PEAK_FLOPS_BF16 * 1e3
            tot['bytes_ms'] += count * moved / PEAK_BYTES * 1e3
            del blk, args, packed, x, x_nchw, v, out

        # odd extents, single pixels, several frames a row tile, the
        # narrowest C (one k16 step), bn = 128 at 5x5x512, and bn1's shift
        # at 20 (a pad that took b1 would show) at both column tiles
        for n, h, w, c, shift in [(3, 7, 9, 32, 0.0), (1, 1, 1, 16, 0.0),
                                  (5, 10, 10, 64, 20.0),
                                  (2, 13, 6, 16, 20.0), (7, 5, 5, 512, 0.0),
                                  (3, 9, 11, 256, 20.0)]:
            blk = block(c, shift)
            *args, packed = blk.fused_weights()
            x = torch.randn(n, h, w, c, device=device, generator=g).to(bf16)
            compare_block_bf16(f'bottleneck_bf16 edge ({n},{h},{w},{c}) b1 '
                               f'shift {shift}',
                               block_ops.bottleneck_ir_fused(x, *args), x,
                               args, packed)

        # C = 20 is no multiple of 16: the wrapper raises and the C entry
        # refuses; W = 1200 leaves the shared memory: the C entry refuses
        # and the wrapper raises
        before = block_ops.bottleneck_ir_fused.launches
        for (n, h, w, c), error in (((2, 5, 5, 20), ValueError),
                                    ((1, 2, 1200, 16), RuntimeError)):
            blk = block(c)
            *args, _ = blk.fused_weights()
            x = torch.randn(n, h, w, c, device=device, generator=g).to(bf16)
            try:
                block_ops.bottleneck_ir_fused(x, *args)
            except error as e:
                print(f'  bottleneck_bf16 ({n},{h},{w},{c}) refused: {e}')
            else:
                fail(f'bottleneck_ir_fused took bfloat16 ({n},{h},{w},{c})')
        x = torch.zeros(2, 5, 5, 20, device=device, dtype=bf16)
        code = build.library().fvt_bottleneck_bf16_forward(
            *([x.data_ptr()] * 10), 2, 5, 5, 20, 64, block_ops.BOTH,
            torch.cuda.current_stream(device).cuda_stream)
        if code == 0:
            fail('the bfloat16 bottleneck entry took C = 20')
        if block_ops.bottleneck_ir_fused.launches != before:
            fail('a refused bfloat16 bottleneck counted a launch')
    lower = max(tot['ops_ms'], tot['bytes_ms'])
    print(f'  bottleneck_bf16 total over the 21 blocks of a forward: kernel '
          f'{tot["ms"]:.4f} ms (conv1 {tot["conv1"]:.4f}, conv2 '
          f'{tot["conv2"]:.4f} alone), plain {tot["plain"]:.4f} ms, unfused '
          f'bf16 block on cuDNN {tot["cudnn"]:.4f} ms, bound {lower:.4f} ms '
          f'({lower / tot["ms"]:.1%} of it)')
    return {'name': 'bottleneck_bf16', 'route': 'cuda',
            'source': 'fvt_tpu_torch/csrc/conv3x3_wgmma.cu',
            'replaces': 'fvt_tpu/ops/bottleneck_pallas.py:122',
            'max_abs_err': tot['err'], 'ms': tot['ms'],
            'plain_ms': tot['plain'], 'library_ms': None,
            'bound_ms': lower,
            'bound_by': ('operations' if tot['ops_ms'] >= tot['bytes_ms']
                         else 'bytes'),
            'launch_ms': {'conv1': tot['conv1'], 'conv2': tot['conv2']},
            'unfused_cudnn_block_ms': tot['cudnn']}


def check_winograd_bf16_kernel(device) -> dict:
    """Phase 2, bfloat16: the Winograd kernel's bfloat16 route
    (``conv3x3_winograd`` on bfloat16 tensors, the ``winograd_kernel``
    path under ``--amp``: the input transform, then one bfloat16 ``wgmma``
    product with the output transform in its epilogue) at the seven conv
    shapes on FRAMES frames and at edge shapes.  Gates: V of the first
    launch alone bit-equal to ``input_transform`` on the bfloat16 x; the
    second launch alone, on that plain V, and the whole call within
    compare_bf16's gate (one unit in the last place) of the plain
    version, ``conv3x3_winograd_bf16_ref`` (the same exact products, fp32
    sums in another order); the distance from ``F.conv2d`` bf16 printed,
    not gated (V's roundings make it another bfloat16 function).  Widths
    the kernel does not take must raise.  Times per shape: the call, each
    launch alone, the plain version, bf16 B4 (``conv3x3``) and
    ``F.conv2d`` bf16; the bound: the products' operations at the bf16
    peak against x, the packed U and y, with the bytes of its two launches
    (V written and read besides) printed beside it."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import conv as conv_ops
    from fvt_tpu_torch.ops import winograd as winograd_ops

    g = torch.Generator(device=device).manual_seed(SEED + 8)
    frames = WINDOW_BATCH * WINDOW
    tot = {key: 0.0 for key in (
        'err', 'ms', 'plain', 'library', 'b4', 'ops_ms', 'bytes_ms',
        'design_ms', 'input_transform', 'product')}
    workspace_gb = 0.0

    def inputs(n, h, w, cin, cout):
        x = torch.randn(n, h, w, cin, device=device, generator=g)
        k = torch.randn(3, 3, cin, cout, device=device, generator=g)
        return x.bfloat16(), (k * (9 * cin) ** -0.5).bfloat16()

    def check(shape, x, k):
        """The gates at x's shape; returns (y, max error, U, packed U)."""
        n, h, w, _ = x.shape
        u = winograd_ops.transform_weights_bf16(k)
        packed = winograd_ops.pack_winograd_weights_bf16(u)
        v = winograd_ops.workspace_bf16(x)
        out = torch.empty(n, h, w, k.shape[3], device=device,
                          dtype=torch.bfloat16)
        winograd_ops.launch_bf16(x, packed, v, out,
                                 winograd_ops.INPUT_TRANSFORM)
        v_plain = winograd_ops.v_chunks(winograd_ops.input_transform(x))
        torch.cuda.synchronize()
        flips = (v != v_plain).sum().item()
        print(f'  {shape} V: {flips} of {v.numel()} values differ from '
              f'input_transform\'s')
        if flips:
            fail(f'{shape}: the input transform is not bit-equal to its '
                 f'plain version')
        del v
        winograd_ops.launch_bf16(x, packed, v_plain, out,
                                 winograd_ops.PRODUCT)
        p = n * ((h + 1) // 2) * ((w + 1) // 2)
        want = winograd_ops.output_transform(torch.bmm(
            v_plain[:, :, :p].transpose(1, 2).reshape(16, p, -1).float(),
            u.float()), n, h, w).bfloat16()
        del v_plain
        compare_bf16(f'{shape} product on the plain V', out, want)
        del out, want
        got = winograd_ops.conv3x3_winograd(x, k, u, packed)
        err = compare_bf16(shape, got,
                           winograd_ops.conv3x3_winograd_bf16_ref(x, k, u))
        return got, err, u, packed

    with torch.inference_mode():
        for h, cin, cout, count in CONV_SHAPES:
            x, k = inputs(frames, h, h, cin, cout)
            shape = f'winograd_bf16 ({frames},{h},{h},{cin})->{cout}'
            got, err, u, packed = check(shape, x, k)
            cudnn, library_ms, layout = conv2d_library(x, k)
            apart = (got.float() - cudnn.float()).abs_()
            print(f'    vs F.conv2d bf16 (not gated): max '
                  f'{apart.max().item():.3e}, mean {apart.mean().item():.3e} '
                  f'of mean|y| {cudnn.float().abs().mean().item():.3e}')
            del cudnn, apart
            ms = median_ms(lambda: winograd_ops.conv3x3_winograd(
                x, k, u, packed), CONV_RUNS)
            v = winograd_ops.workspace_bf16(x)
            alone = {}
            for key, stage in (('input_transform',
                                winograd_ops.INPUT_TRANSFORM),
                               ('product', winograd_ops.PRODUCT)):
                alone[key] = median_ms(lambda: winograd_ops.launch_bf16(
                    x, packed, v, got, stage), CONV_RUNS)
                tot[key] += count * alone[key]
            plain = median_ms(lambda: winograd_ops.conv3x3_winograd_bf16_ref(
                x, k, u), 3, warmup=1)
            b4_packed = conv_ops.pack_weights(k)
            b4 = median_ms(lambda: conv_ops.conv3x3(x, k, packed=b4_packed),
                           CONV_RUNS)
            p = frames * ((h + 1) // 2) ** 2
            flops = 2.0 * 16 * p * cin * cout
            moved = nbytes(x, packed, got)
            lower = bound(flops, moved, PEAK_FLOPS_BF16)
            design = (moved + 2 * nbytes(v)) / PEAK_BYTES * 1e3
            workspace_gb = max(workspace_gb, nbytes(v) / 1e9)
            print(f'    x{count} a forward: kernel {ms:.4f} ms (input '
                  f'transform {alone["input_transform"]:.4f}, product '
                  f'{alone["product"]:.4f} alone), plain {plain:.4f} ms, '
                  f'bf16 B4 {b4:.4f} ms, F.conv2d bf16 ({layout}) '
                  f'{library_ms:.4f} ms, bound {lower["bound_ms"]:.4f} ms by '
                  f'{lower["bound_by"]} ({flops / 1e9:.1f} GFLOP, '
                  f'{moved / 1e6:.1f} MB), its launches\' bytes (V written '
                  f'and read) {design:.4f} ms, V {nbytes(v) / 1e9:.3f} GB')
            tot['err'] = max(tot['err'], err)
            tot['ms'] += count * ms
            tot['plain'] += count * plain
            tot['library'] += count * library_ms
            tot['b4'] += count * b4
            tot['ops_ms'] += count * flops / PEAK_FLOPS_BF16 * 1e3
            tot['bytes_ms'] += count * moved / PEAK_BYTES * 1e3
            tot['design_ms'] += count * design
            del x, k, got, u, packed, v, b4_packed

        # odd extents (7x9; 5x5 as the last stage), single pixels, Cin !=
        # Cout, a ragged column tile (Co = 200, 136), the smallest C (one
        # k16 step), P over several row tiles with a ragged end (828
        # tiles), and several tiles of wide channels
        for n, h, w, cin, cout in [(3, 7, 9, 32, 16), (1, 1, 1, 16, 8),
                                   (1, 2, 2, 16, 8), (5, 5, 5, 64, 200),
                                   (2, 13, 6, 16, 40), (3, 23, 45, 48, 136),
                                   (7, 10, 10, 256, 256)]:
            x, k = inputs(n, h, w, cin, cout)
            check(f'winograd_bf16 edge ({n},{h},{w},{cin})->{cout}', x, k)

        # C = 20 is no multiple of wgmma's k16 step and Co = 12 none of 8:
        # the wrapper raises, and the C entry itself refuses C = 20;
        # neither goes to another kernel
        before = (winograd_ops.conv3x3_winograd.launches,
                  conv_ops.conv3x3.launches)
        for cin, cout in ((20, 40), (16, 12)):
            x, k = inputs(2, 5, 5, cin, cout)
            try:
                winograd_ops.conv3x3_winograd(x, k)
            except ValueError as e:
                print(f'  winograd_bf16 C={cin} Co={cout} refused: {e}')
            else:
                fail(f'conv3x3_winograd took bfloat16 C = {cin}, Co = '
                     f'{cout}')
        x = torch.zeros(2, 5, 5, 20, device=device, dtype=torch.bfloat16)
        code = build.library().fvt_winograd_bf16_forward(
            *([x.data_ptr()] * 4), 2, 5, 5, 20, 40,
            winograd_ops.BF16_STAGES,
            torch.cuda.current_stream(device).cuda_stream)
        if code == 0:
            fail('the bfloat16 Winograd entry took C = 20')
        if (winograd_ops.conv3x3_winograd.launches,
                conv_ops.conv3x3.launches) != before:
            fail('a refused bfloat16 Winograd conv counted a launch')
    lower = max(tot['ops_ms'], tot['bytes_ms'])
    print(f'  winograd_bf16 total over the 45 convs of a forward: kernel '
          f'{tot["ms"]:.4f} ms (input transform {tot["input_transform"]:.4f}'
          f', product {tot["product"]:.4f} alone), plain {tot["plain"]:.4f} '
          f'ms, bf16 B4 {tot["b4"]:.4f} ms, F.conv2d bf16 '
          f'{tot["library"]:.4f} ms, bound {lower:.4f} ms '
          f'({lower / tot["ms"]:.1%} of it; operations {tot["ops_ms"]:.4f}, '
          f'x, U and y {tot["bytes_ms"]:.4f}), its launches\' bytes '
          f'{tot["design_ms"]:.4f} ms; largest V {workspace_gb:.3f} GB')
    return {'name': 'winograd_bf16', 'route': 'cuda',
            'source': 'fvt_tpu_torch/csrc/winograd_bf16.cu',
            'replaces': 'fvt_tpu/ops/winograd.py:148',
            'max_abs_err': tot['err'], 'ms': tot['ms'],
            'plain_ms': tot['plain'], 'library_ms': tot['library'],
            'bound_ms': lower,
            'bound_by': ('operations' if tot['ops_ms'] >= tot['bytes_ms']
                         else 'bytes'),
            'launch_ms': {'input_transform': tot['input_transform'],
                          'product': tot['product']},
            'launches_bytes_bound_ms': tot['design_ms'],
            'workspace_gb': workspace_gb, 'conv3x3_bf16_ms': tot['b4']}


def conv_counters() -> dict:
    from fvt_tpu_torch.ops.bottleneck import (bottleneck_ir_fused,
                                              bottleneck_ir_fused_simt)
    from fvt_tpu_torch.ops.conv import conv3x3, conv3x3_simt
    from fvt_tpu_torch.ops.winograd import (conv3x3_winograd,
                                            conv3x3_winograd_simt)
    return {'conv3x3': conv3x3, 'conv3x3_simt': conv3x3_simt,
            'winograd': conv3x3_winograd,
            'winograd_simt': conv3x3_winograd_simt,
            'bottleneck': bottleneck_ir_fused,
            'bottleneck_simt': bottleneck_ir_fused_simt}


def read_launches(counters: dict) -> dict:
    """The counters' launches, and those of the float32 and bfloat16 conv
    kernels apart."""
    launches = {k: fn.launches for k, fn in counters.items()}
    for name in ('conv3x3', 'winograd', 'bottleneck'):
        for dtype in ('fp32', 'bf16'):
            launches[f'{name}_{dtype}'] = getattr(counters[name],
                                                  f'launches_{dtype}')
    return launches


def zero_launches(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
    for name in ('conv3x3', 'winograd', 'bottleneck'):
        counters[name].launches_fp32 = counters[name].launches_bf16 = 0


def run_counters() -> tuple:
    """(zero, read) over the counters of every kernel a CLI run can
    launch: B1, B2, the conv kernels, B3a/B3b (``launches_fwd`` and
    ``launches_bwd``) and their SIMT twins.  ``read()`` returns
    :func:`read_launches` with the train kernels' counts added."""
    from fvt_tpu_torch.ops.fusion import (fused_multimodal_fusion,
                                          fused_multimodal_fusion_simt)
    from fvt_tpu_torch.ops.tcn import (fused_temporal_block,
                                       fused_temporal_block_simt,
                                       fused_temporal_block_train as block,
                                       fused_temporal_block_train_simt as
                                       simt)
    counters = {'tcn_block': fused_temporal_block,
                'tcn_block_simt': fused_temporal_block_simt,
                'fusion': fused_multimodal_fusion,
                'fusion_simt': fused_multimodal_fusion_simt,
                **conv_counters()}

    def zero():
        zero_launches(counters)
        for fn in (block, simt):
            fn.launches_fwd = fn.launches_bwd = 0

    def read():
        out = read_launches(counters)
        out.update(tcn_block_train=block.launches_fwd,
                   tcn_block_bwd=block.launches_bwd,
                   tcn_block_train_simt=simt.launches_fwd,
                   tcn_block_bwd_simt=simt.launches_bwd)
        return out

    return zero, read


def backbone_variants(model, crops: torch.Tensor, device) -> dict:
    """Phase 5, the backbone alone: each conv path on the same frames and
    weights against the default path; then ``fused_blocks`` on
    ``shifted_kernel``, ``shifted_kernel`` (the split-TF32 kernels) and
    ``cudnn`` timed again, in turns.  Returns the launches of each conv
    kernel over its own path's one checked forward (the SIMT kernels' over
    all of them: none)."""
    from fvt_tpu_torch.models.arcface import VisualBackbone

    counters = conv_counters()
    state = model.spatial.visual.state_dict()
    frames = crops.shape[0]
    variants = [('cudnn', {}, {}),
                ('shifted_kernel', {'conv_impl': 'shifted_kernel'},
                 {'conv3x3': 45, 'conv3x3_fp32': 45}),
                ('winograd_kernel', {'conv_impl': 'winograd_kernel'},
                 {'winograd': 45, 'winograd_fp32': 45}),
                ('fused_blocks', {'fused_blocks': True},
                 {'bottleneck': 21, 'bottleneck_fp32': 21}),
                # the 21 identity blocks fused, the other three stride-1
                # convs (each stage's first conv1) on the split-TF32 conv
                ('fused_blocks+shifted_kernel',
                 {'fused_blocks': True, 'conv_impl': 'shifted_kernel'},
                 {'bottleneck': 21, 'bottleneck_fp32': 21, 'conv3x3': 3,
                  'conv3x3_fp32': 3})]
    ref, out_launches, nets = None, {'conv3x3_simt': 0, 'winograd_simt': 0,
                                     'bottleneck_simt': 0}, {}
    with torch.inference_mode():
        for name, kw, expect in variants:
            net = VisualBackbone(**kw).eval()
            net.load_state_dict(state)
            net.to(device)
            zero_launches(counters)
            out = net(crops)
            torch.cuda.synchronize()
            launches = read_launches(counters)
            want = {k: expect.get(k, 0) for k in launches}
            if launches != want:
                fail(f'backbone {name}: launches {launches}, expected '
                     f'{want} a forward')
            for k, v in expect.items():  # each kernel's own path first
                out_launches.setdefault(k, v)
            if ref is None:
                ref = out
            err = (out - ref).abs().max().item()
            ok = (out.shape == (frames, 512)
                  and bool(torch.isfinite(out).all()))
            ms = median_ms(lambda: net(crops), CONV_RUNS, warmup=1)
            print(f'  backbone {name} on {frames} frames: {ms:.2f} ms, '
                  f'{frames / ms * 1e3:.1f} frames/s, launches {launches}, '
                  f'max |embedding - cudnn\'s| = {err:.3e} (atol '
                  f'{EMBED_ATOL})')
            if not ok or err > EMBED_ATOL:
                fail(f'backbone {name}: embeddings {tuple(out.shape)} differ '
                     f'from the default path\'s by {err}')
            if name in ('cudnn', 'shifted_kernel',
                        'fused_blocks+shifted_kernel'):
                nets[name] = net
            del net
        for name in ('fused_blocks+shifted_kernel', 'shifted_kernel',
                     'cudnn'):
            net = nets[name]
            ms = median_ms(lambda: net(crops), CONV_RUNS, warmup=1)
            print(f'  backbone {name} on {frames} frames, again: {ms:.2f} ms, '
                  f'{frames / ms * 1e3:.1f} frames/s')
    del nets
    return out_launches


def backbone_bf16(model, crops: torch.Tensor, device) -> dict:
    """Phase 5, the bfloat16 backbone alone: ``dtype=torch.bfloat16``
    through ``cudnn``, ``shifted_kernel``, ``fused_blocks``,
    ``fused_blocks`` on ``shifted_kernel``, ``winograd_kernel`` and
    ``fused_blocks`` on ``winograd_kernel`` on the same frames and
    weights.  Each kernel path's
    embeddings are held against the plain version's of the same bfloat16
    model; the tolerance is BF16_PATHS_APART times bfloat16's own distance
    from float32, max |bf16 cudnn - fp32 cudnn| on these weights and
    crops.  Returns the bfloat16 conv kernel's, the bfloat16 block's and
    the bfloat16 Winograd kernel's launches over their own path's one
    checked forward."""
    from fvt_tpu_torch.models.arcface import VisualBackbone

    counters = conv_counters()
    state = model.spatial.visual.state_dict()
    frames = crops.shape[0]
    bf16 = {'dtype': torch.bfloat16}
    paths = {  # the kernel paths and their launches a forward
        'bf16 shifted_kernel': ({'conv_impl': 'shifted_kernel'},
                                {'conv3x3': 45, 'conv3x3_bf16': 45}),
        # the 21 identity blocks fused, the rest on cuDNN
        'bf16 fused_blocks': ({'fused_blocks': True},
                              {'bottleneck': 21, 'bottleneck_bf16': 21}),
        # the 21 identity blocks fused, each stage's first conv1 on the
        # bfloat16 conv kernel
        'bf16 fused_blocks+shifted_kernel': (
            {'conv_impl': 'shifted_kernel', 'fused_blocks': True},
            {'conv3x3': 3, 'conv3x3_bf16': 3, 'bottleneck': 21,
             'bottleneck_bf16': 21}),
        # the 45 convs on the bfloat16 Winograd kernel
        'bf16 winograd_kernel': ({'conv_impl': 'winograd_kernel'},
                                 {'winograd': 45, 'winograd_bf16': 45}),
        # the 21 identity blocks fused, each stage's first conv1 on the
        # bfloat16 Winograd kernel
        'bf16 fused_blocks+winograd_kernel': (
            {'conv_impl': 'winograd_kernel', 'fused_blocks': True},
            {'winograd': 3, 'winograd_bf16': 3, 'bottleneck': 21,
             'bottleneck_bf16': 21})}
    nets = {}
    for name, kw in (('fp32 cudnn', {}), ('bf16 cudnn', bf16),
                     *((name, {**bf16, **kw})
                       for name, (kw, _) in paths.items())):
        nets[name] = VisualBackbone(**kw).eval()
        nets[name].load_state_dict(state)
        nets[name].to(device)
    out_launches = {}
    with torch.inference_mode():
        fp32 = nets['fp32 cudnn'](crops)
        cudnn = nets['bf16 cudnn'](crops)
        own = (cudnn - fp32).abs().max().item()
        tol = BF16_PATHS_APART * own
        print(f'  bf16 backbone on {frames} frames: max |bf16 cudnn - fp32 '
              f'cudnn| = {own:.3e} (bfloat16\'s own distance; the '
              f'tolerance is {BF16_PATHS_APART} of it, {tol:.3e})')
        for name, (_, expect) in paths.items():
            zero_launches(counters)
            got = nets[name](crops)
            torch.cuda.synchronize()
            launches = read_launches(counters)
            want = {k: expect.get(k, 0) for k in launches}
            if launches != want:
                fail(f'{name}: launches {launches}, expected {want} a '
                     f'forward')
            out_launches[name] = launches
            plain = nets[name](crops, reference=True)
            if read_launches(counters) != want:
                fail('the plain-version forward launched a kernel')
            err = (got - plain).abs().max().item()
            far = (got - fp32).abs().max().item()
            print(f'  {name}: max |kernel path - its plain version| = '
                  f'{err:.3e}; max |kernel path - fp32 cudnn| = {far:.3e}; '
                  f'launches {launches}')
            for what, out in (('cudnn', cudnn), (name, got)):
                if (out.shape != (frames, 512) or out.dtype != torch.float32
                        or not bool(torch.isfinite(out).all())):
                    fail(f'bf16 backbone {what}: embeddings '
                         f'{tuple(out.shape)} {out.dtype}, '
                         f'finite={bool(torch.isfinite(out).all())}')
            if err > tol:
                fail(f'{name}: the kernel path differs from its plain '
                     f'version by {err}, more than {BF16_PATHS_APART} of '
                     f'bfloat16\'s distance from float32 ({own})')
        turns = list(nets)[1:]
        for name in ['fp32 cudnn'] + turns + turns[::-1]:
            net = nets[name]
            ms = median_ms(lambda: net(crops), CONV_RUNS, warmup=1)
            print(f'  backbone {name} on {frames} frames: {ms:.2f} ms, '
                  f'{frames / ms * 1e3:.1f} frames/s')
    return {'conv3x3_bf16':
            out_launches['bf16 shifted_kernel']['conv3x3_bf16'],
            'bottleneck_bf16': out_launches[
                'bf16 fused_blocks+shifted_kernel']['bottleneck_bf16'],
            'winograd_bf16':
            out_launches['bf16 winograd_kernel']['winograd_bf16']}


def serve_variant(model, kw: dict, kernel: str, per_dispatch: int,
                  streams: dict, device, atol: float = SERVE_ATOL,
                  by_type: Optional[dict] = None) -> tuple:
    """Phase 5, serving: a tri-modal LFAN with the conv path ``kw`` on the
    weights of ``model`` serves ``streams``; logits against the offline
    stitch of the plain versions within ``atol``, launch counts a dispatch
    (``by_type``: those of ``conv3x3_fp32`` / ``conv3x3_bf16`` among the
    conv kernel's).  Returns (the launches of ``kernel`` over the run, the
    server)."""
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.ops.fusion import (fused_multimodal_fusion,
                                          fused_multimodal_fusion_simt)
    from fvt_tpu_torch.ops.tcn import (fused_temporal_block,
                                       fused_temporal_block_simt)
    from fvt_tpu_torch.serve import ServingModel

    variant = LFAN(MODALITY, output_dim=7, **kw)
    variant.load_state_dict(model.state_dict(), strict=True)
    server = ServingModel(variant, WINDOW_BATCH, WINDOW, HOP, device)
    counters = dict(conv_counters(), tcn_block=fused_temporal_block,
                    tcn_block_simt=fused_temporal_block_simt,
                    fusion=fused_multimodal_fusion,
                    fusion_simt=fused_multimodal_fusion_simt)
    zero_launches(counters)
    served, dispatches = serve_streams(server, streams)
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want.update({kernel: per_dispatch * dispatches,
                 'tcn_block': 12 * dispatches, 'fusion': dispatches})
    want.update({k: n * dispatches for k, n in (by_type or {}).items()})
    print(f'  LFAN {kw}: {dispatches} dispatches, launches {launches}')
    if dispatches < 1 or launches != want:
        fail(f'LFAN {kw}: expected {want} over {dispatches} dispatches, '
             f'got {launches}')
    offline = offline_reference(variant, streams, device)
    for n in STREAM_LENGTHS:
        got = served[n]
        if got.shape != (n, variant.output_dim) \
                or not np.isfinite(got).all():
            fail(f'LFAN {kw} stream {n}: got {got.shape} logits, finite='
                 f'{np.isfinite(got).all()}')
        err = float(np.abs(got - offline[n]).max())
        print(f'    stream {n}: max |served - offline plain| = {err:.3e} '
              f'(atol {atol:.3e})')
        if err > atol:
            fail(f'LFAN {kw} stream {n}: served logits differ from the '
                 f'offline reference by {err}')
    return launches[kernel], server


def make_streams() -> dict:
    rng = np.random.default_rng(SEED)
    return {n: {'video': rng.integers(0, 256, (n, 40, 40, 3), np.uint8),
                'vggish': rng.standard_normal((n, 128), np.float32),
                'bert': rng.standard_normal((n, 768), np.float32)}
            for n in STREAM_LENGTHS}


def serve_streams(server, streams: dict) -> tuple:
    """Feeds every stream through one StreamingRegistry in CHUNK-frame
    pieces, round-robin, then closes them.  Returns ({length: (L, C)
    logits}, dispatches)."""
    from fvt_tpu_torch.streaming import StreamingRegistry

    registry = StreamingRegistry(server, dynamic_batch=True)
    sids = {n: registry.open() for n in streams}
    pieces = {n: [] for n in streams}
    for c0 in range(0, max(streams), CHUNK):
        for n, frames in streams.items():
            if c0 < n:
                chunk = {k: v[c0:c0 + CHUNK] for k, v in frames.items()}
                pieces[n].append(registry.feed(sids[n], chunk))
    for n in streams:
        pieces[n].append(registry.close(sids[n]))
    out = {}
    for n, parts in pieces.items():
        nxt = 0
        for start, logits in parts:
            if len(logits) and start != nxt:
                fail(f'stream {n}: frames from {start} arrived, '
                     f'expected {nxt}')
            nxt += len(logits)
        out[n] = np.concatenate([p[1] for p in parts])
    return out, registry.batcher.dispatches


def offline_reference(model, streams: dict, device) -> dict:
    """The offline path: window each whole stream, run the plain-version
    forward, stitch (or take the first L rows of one pad-by-repeat window
    for a stream shorter than the window)."""
    from fvt_tpu_torch.data import windowing as W
    from fvt_tpu_torch.serve import lfan_serving_forward

    out = {}
    for n, frames in streams.items():
        if n < WINDOW:
            idx = W.pad_short_window_indices(n, WINDOW)[None]
        else:
            idx = W.window_index_matrix(n, WINDOW, HOP)
        batch = {k: torch.from_numpy(v[idx]).to(device)
                 for k, v in frames.items()}
        logits = lfan_serving_forward(model, batch, reference=True)
        logits = logits.cpu().numpy()
        out[n] = (logits[0, :n] if n < WINDOW
                  else W.stitch_windows_np(logits, idx, n))
    return out


def time_dispatches(name: str, server, inputs: dict) -> None:
    """RUNS warm full dispatches of ``server`` on numpy ``inputs``, host
    clock (``call`` returns numpy, so each is forced to the host)."""
    for _ in range(3):
        server.call(inputs)
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        out = server.call(inputs)
        times.append(time.perf_counter() - t0)
    if not np.isfinite(out).all():
        fail(f'{name}: timed dispatch gave non-finite logits')
    med = statistics.median(times)
    print(f'  {name}: full ({WINDOW_BATCH},{WINDOW}) dispatch, {RUNS} warm '
          f'runs: median {med * 1e3:.2f} ms, min {min(times) * 1e3:.2f} ms, '
          f'max {max(times) * 1e3:.2f} ms -> '
          f'{WINDOW_BATCH * WINDOW / med:.1f} frames/s')


def make_train_batches(n: int, modality=TRAIN_MODALITY) -> list:
    from fvt_tpu_torch.config import model_config as MC
    rng = np.random.default_rng(SEED + 3)
    shape = (TRAIN_BATCH, WINDOW)
    return [{**{m: rng.standard_normal(shape + tuple(MC.FEATURE_DIMENSION[m]),
                                       np.float32) for m in modality},
             'EXPR_continuous_label': rng.integers(0, 7, shape)}
            for _ in range(n)]


def fused_against_plain(trainers: dict, batches: list, epochs: int) -> dict:
    """Runs ``epochs`` over ``batches`` on the ``'fused'`` and the
    ``'plain'`` trainer (same model, same state) and holds the fused
    run to the plain one: the train kernels' launches (8 forward and 8
    backward calls a step of the split-TF32 entries, none of the SIMT
    ones, no eval-only kernel), the per-step losses within
    TRAIN_LOSS_RTOL and the final parameters and running statistics within
    TRAIN_PARAM_RTOL / TRAIN_PARAM_ATOL.  Returns the fused run's
    launches."""
    from fvt_tpu_torch.ops.fusion import (fused_multimodal_fusion,
                                          fused_multimodal_fusion_simt)
    from fvt_tpu_torch.ops.tcn import (fused_temporal_block,
                                       fused_temporal_block_train as block,
                                       fused_temporal_block_train_simt as
                                       simt)

    counters = (fused_temporal_block, fused_multimodal_fusion,
                fused_multimodal_fusion_simt)
    for fn in (block, simt):
        fn.launches_fwd = fn.launches_bwd = 0
    eval_before = [c.launches for c in counters]
    losses = {}
    for name in ('fused', 'plain'):
        losses[name] = []
        for e in range(epochs):
            trainers[name].train_one_epoch(batches, e)
            losses[name] += trainers[name].step_losses
        if name == 'fused':
            launches = {'tcn_block_train': block.launches_fwd,
                        'tcn_block_bwd': block.launches_bwd,
                        'tcn_block_train_simt': simt.launches_fwd,
                        'tcn_block_bwd_simt': simt.launches_bwd}
    steps = epochs * len(batches)
    print(f'  {steps} steps at ({TRAIN_BATCH},{WINDOW}): fused losses '
          f'{losses["fused"][0]:.6f} .. {losses["fused"][-1]:.6f}')
    print(f'  C entry calls a step: fvt_tcn_block_train_tf32x3_forward '
          f'{launches["tcn_block_train"] / steps:g} (3 launches each), '
          f'fvt_tcn_block_train_tf32x3_backward '
          f'{launches["tcn_block_bwd"] / steps:g}; the SIMT entries '
          f'fvt_tcn_block_train_forward {simt.launches_fwd / steps:g}, '
          f'fvt_tcn_block_train_backward {simt.launches_bwd / steps:g}')
    if not all(np.isfinite(losses['fused'])):
        fail(f'non-finite training loss: {losses["fused"]}')
    if launches != {'tcn_block_train': 8 * steps, 'tcn_block_bwd': 8 * steps,
                    'tcn_block_train_simt': 0, 'tcn_block_bwd_simt': 0}:
        fail(f'expected 8 forward and 8 backward calls of the split-TF32 '
             f'entries a step and none of the SIMT ones over {steps} '
             f'steps, got {launches}')
    if [c.launches for c in counters] != eval_before:
        fail('an eval-only kernel was launched while training')
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses['fused'], losses['plain']))
    print(f'  fused vs plain: max relative loss difference {rel:.3e} '
          f'(rtol {TRAIN_LOSS_RTOL})')
    if rel > TRAIN_LOSS_RTOL:
        fail(f'fused and plain training losses differ by {rel}')
    worst = 0.0
    plain_state = trainers['plain'].model.state_dict()
    for n, got in trainers['fused'].model.state_dict().items():
        want = plain_state[n]
        if not got.is_floating_point():
            continue
        excess = ((got - want).abs() - TRAIN_PARAM_ATOL
                  - TRAIN_PARAM_RTOL * want.abs()).max().item()
        worst = max(worst, (got - want).abs().max().item())
        if excess > 0 or not torch.isfinite(got).all():
            fail(f'{n}: fused and plain training disagree after {steps} '
                 f'steps (rtol {TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL})')
    print(f'  final parameters and running statistics: max abs difference '
          f'{worst:.3e} (rtol {TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL})')
    return launches


def train_lfan(device) -> dict:
    """Phase 4.  Returns the train kernels' launch counts over the fused
    run's TRAIN_STEPS steps."""
    from fvt_tpu_torch.config.defaults import get_train_config
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.train.steps import to_device
    from fvt_tpu_torch.train.trainer import Trainer

    config = get_train_config()
    config.update(seed=SEED, nan_guard=True)
    batches = make_train_batches(2)
    epochs = TRAIN_STEPS // len(batches)
    model = LFAN(TRAIN_MODALITY, output_dim=7, tcn_dropout=TCN_DROPOUT,
                 generator=torch.Generator().manual_seed(SEED))
    trainers = {
        'fused': Trainer(copy.deepcopy(model), config, device),
        'plain': Trainer(copy.deepcopy(model), config, device,
                         reference=True),
        'conv-by-conv': Trainer(copy.deepcopy(model), config, device,
                                tcn_fused=False),
    }

    # one step twice from the same state: the gradients' bits
    fused = trainers['fused']
    state = copy.deepcopy(fused.model.state_dict())
    first = to_device(batches[0], device)
    grads = []
    for _ in range(2):
        fused.model.load_state_dict(state)
        fused.model.zero_grad(set_to_none=True)
        fused.train_step.loss(first, fused.step_generator(0, 0)).backward()
        grads.append({n: p.grad.clone()
                      for n, p in fused.train_step.trainable.items()})
    fused.model.load_state_dict(state)
    fused.model.zero_grad(set_to_none=True)
    differ = [n for n in grads[0] if not torch.equal(grads[0][n],
                                                     grads[1][n])]
    print(f'  step 1 twice from one state: {len(grads[0])} gradients, '
          f'{len(differ)} differ in their bits')
    if differ:
        fail(f'gradients differ between two runs of one step: {differ}')

    launches = fused_against_plain(trainers, batches, epochs)

    frames = TRAIN_BATCH * WINDOW
    for name in ('fused', 'conv-by-conv', 'conv-by-conv', 'fused'):
        tr = trainers[name]
        for _ in range(3):
            tr.train_step(batches[0], tr.step_generator(9, 0))
        torch.cuda.synchronize()
        times = []
        for i in range(RUNS):
            t0 = time.perf_counter()
            tr.train_step(batches[i % 2], tr.step_generator(9, i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(f'  {name} step, {RUNS} warm runs from numpy batches: median '
              f'{med * 1e3:.3f} ms, min {min(times) * 1e3:.3f} ms, max '
              f'{max(times) * 1e3:.3f} ms -> {frames / med:.1f} trained '
              f'frames/s')
    return launches


def train_mfcc_lfan(device) -> dict:
    """Phase 4, the mfcc width: MFCC_STEPS fused ``Trainer`` steps of the
    full-width ``mfcc+vggish`` LFAN (mfcc's first block 39 -> 32, run on
    zero channels) against the same steps on the plain versions, under
    the training gate.  Returns the train kernels' launches."""
    from fvt_tpu_torch.config.defaults import get_train_config
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.train.trainer import Trainer

    config = get_train_config()
    config.update(seed=SEED, nan_guard=True)
    batches = make_train_batches(2, MFCC_MODALITY)
    model = LFAN(MFCC_MODALITY, output_dim=7, tcn_dropout=TCN_DROPOUT,
                 generator=torch.Generator().manual_seed(SEED))
    trainers = {'fused': Trainer(copy.deepcopy(model), config, device),
                'plain': Trainer(copy.deepcopy(model), config, device,
                                 reference=True)}
    return fused_against_plain(trainers, batches,
                               MFCC_STEPS // len(batches))


class ShapeRecorder:
    """Records, while installed, the (B, T) of every TemporalConvNet call
    (four B1 launches each at eval) and every fusion call (one B2 launch
    at eval) of any model, through a global forward pre-hook: the CLIs
    build their models themselves.  Eval calls go to ``tcn`` and
    ``fusion``, train-mode calls (``train=True``, B3a and B3b in each
    block) to ``tcn_train`` and ``fusion_train``.  The forwards of a whole
    model of any family go to ``model`` and ``model_train`` the same way,
    the frames of each call of the ArcFace backbone to ``backbone`` and the
    patches of each call of the VGGish to ``audio``."""

    def __enter__(self):
        from fvt_tpu_torch.models.arcface import VisualBackbone
        from fvt_tpu_torch.models.fusion import MultimodalTransformerEncoder
        from fvt_tpu_torch.models.models import FusionModel
        from fvt_tpu_torch.models.tcn import TemporalConvNet
        from fvt_tpu_torch.models.vggish import VGGish
        self.tcn, self.fusion = [], []
        self.tcn_train, self.fusion_train = [], []
        self.model, self.model_train, self.backbone = [], [], []
        self.audio = []

        def hook(module, args):
            train = len(args) > 1 and args[1] is True
            if isinstance(module, TemporalConvNet):
                (self.tcn_train if train else self.tcn).append(
                    tuple(args[0].shape[:2]))
            elif isinstance(module, MultimodalTransformerEncoder):
                (self.fusion_train if train else self.fusion).append(
                    tuple(next(iter(args[0].values())).shape[:2]))
            elif isinstance(module, FusionModel):
                (self.model_train if train else self.model).append(
                    tuple(next(iter(args[0].values())).shape[:2]))
            elif isinstance(module, VisualBackbone):
                self.backbone.append(args[0].shape[0])
            elif isinstance(module, VGGish):
                self.audio.append(args[0].shape[0])

        self.handle = torch.nn.modules.module \
            .register_module_forward_pre_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def challenge_videos(store: dict, mean_std: dict, modality):
    """Each video of the challenge store read with numpy, as the offline
    references take it: yields (``split/vid``, {modality: array}) with
    the features as float32, those of the fold's mean/std (vggish, bert)
    normalised with it, and the frames center-cropped to 40^2."""
    import os
    from fvt_tpu_torch.data.transforms import CROP_SIZE, center_crop_offset

    feat = os.path.join(store['dataset_path'], 'features', 'compacted_48')
    off = center_crop_offset(48, CROP_SIZE)
    for split in sorted(os.listdir(feat)):
        for vid in sorted(os.listdir(os.path.join(feat, split)),
                          key=lambda v: int(v[3:])):
            tdir = os.path.join(feat, split, vid)
            arrays = {m: np.load(os.path.join(tdir, f'{m}.npy'))
                      for m in modality}
            for m in modality:
                if m == 'video':
                    arrays[m] = arrays[m][:, off:off + CROP_SIZE,
                                          off:off + CROP_SIZE]
                    continue
                arrays[m] = arrays[m].astype(np.float32)
                if m in mean_std:
                    st = mean_std[m]
                    arrays[m] = ((arrays[m] - st['mean'].astype(np.float32))
                                 / st['std'].astype(np.float32))
            yield f'{split}/{vid}', arrays


def challenge_reference(model, store: dict, mean_std: dict, device,
                        modality=MODALITY) -> dict:
    """Phase 6's offline path (and phase 10's, on ``modality``): each
    video of :func:`challenge_videos` padded by repeat to the window or
    windowed, the plain-version forward over WINDOW_BATCH windows at a
    time, the windows stitched."""
    from fvt_tpu_torch.data import windowing as W
    from fvt_tpu_torch.serve import lfan_serving_forward

    out = {}
    for key, arrays in challenge_videos(store, mean_std, modality):
        n = len(arrays['bert'])
        idx = (W.pad_short_window_indices(n, WINDOW)[None] if n < WINDOW
               else W.window_index_matrix(n, WINDOW, HOP))
        logits = []
        for s in range(0, len(idx), WINDOW_BATCH):
            rows = idx[s:s + WINDOW_BATCH]
            batch = {k: torch.from_numpy(np.ascontiguousarray(a[rows]))
                     .to(device) for k, a in arrays.items()}
            logits.append(lfan_serving_forward(
                model, batch, reference=True).cpu().numpy())
        logits = np.concatenate(logits)
        out[key] = (logits[0] if n < WINDOW else
                    W.stitch_windows_np(logits, idx, n))
    return out


def check_at_shapes(model, shapes, device, modality=MODALITY) -> None:
    """B1 at each of the model's blocks of ``modality`` (12 for the
    tri-modal LFAN) and, for an LFAN, B2 at each (B, T) of ``shapes``, on
    random inputs, against their plain versions at the phase-2 gate."""
    from fvt_tpu_torch.ops import tcn as tcn_ops

    g = torch.Generator(device=device).manual_seed(SEED + 6)
    with torch.inference_mode():
        for b, t in shapes:
            errs = []
            feats = {}
            for m in modality:
                net = model.temporal[m]
                x = torch.randn(b, t, net.network[0].conv1.weight_v.shape[1],
                                device=device, generator=g)
                for i, blk in enumerate(net.network):
                    w = blk.eval_weights()
                    args = (x, w['w1'], w['b1'], w['w2'], w['b2'], w['wd'],
                            w['bd'])
                    kw = dict(kernel_size=net.kernel_size,
                              dilation=blk.dilation)
                    want = tcn_ops.fused_temporal_block_ref(*args, **kw)
                    errs.append(compare(
                        f'tcn_block {m}.{i} ({b},{t},{x.shape[-1]})->'
                        f'{want.shape[-1]} d={blk.dilation}',
                        tcn_ops.fused_temporal_block(
                            *args, **kw, packed=w['packed']), want))
                    x = want.contiguous()
                feats[m] = x
            if not hasattr(model, 'fusion'):
                print(f'  B1 at ({b},{t}): max_abs_err {max(errs):.3e}')
                continue
            errs.append(compare(f'fusion ({b},{t})',
                                model.fusion(feats),
                                model.fusion(feats, reference=True)))
            print(f'  B1 and B2 at ({b},{t}): max_abs_err {max(errs):.3e}')


def full_bucket(trainer, videos: int, device, length: int = WINDOW,
                modality=MODALITY, rtol: float = FAMILY_RTOL) -> tuple:
    """One forward of the CLI's model over a full bucket
    (``eval_video_batch`` videos of ``length`` frames), the most a store
    of videos that long hands one forward; a store of 12 videos has no
    such bucket.  Prints its time and peak device memory.  Fails if it
    does not fit on the card, if the eval backbone took it in fewer than
    two calls or any call above ``eval_frames`` frames, or if its logits
    differ from the same forward on the plain versions by more than
    ``rtol`` of their largest magnitude.  The backbone is the ArcFace of
    a ``video`` model or the VGGish of a ``logmel`` one.  Returns the
    bucket's (B, T)."""
    from fvt_tpu_torch.config import model_config as MC

    rng = np.random.default_rng(SEED + 7)
    shape = (videos, length)
    inputs = {}
    for m in modality:
        inputs[m] = (rng.integers(0, 256, shape + (40, 40, 3), np.uint8)
                     if m == 'video' else rng.standard_normal(
                         shape + tuple(MC.FEATURE_DIMENSION[m]), np.float32))
    batch = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    chunk = trainer.model.eval_frames
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with ShapeRecorder() as rec:
            t0 = time.perf_counter()
            out = trainer.forward(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    except torch.cuda.OutOfMemoryError:
        fail(f'a full bucket {shape} does not fit on the card: out of '
             f'memory after {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}'
             f' GiB')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    calls = rec.backbone + rec.audio
    print(f'  a full bucket {shape}, {videos * length} frames, one forward: '
          f'{ms:.1f} ms (host clock, first call at this shape), peak device '
          f'memory {peak:.2f} GiB; the backbone\'s calls {calls} '
          f'(chunk {chunk})')
    if len(calls) < 2 or max(calls) > chunk \
            or sum(calls) != videos * length:
        fail(f'a full bucket {shape} went through the eval backbone in '
             f'calls of {calls} frames, not in chunks of at most {chunk}')
    trainer.reference = True
    try:
        want = trainer.forward(batch)
    finally:
        trainer.reference = False
    if out.shape != want.shape or not bool(torch.isfinite(out).all()):
        fail(f'a full bucket gave logits {tuple(out.shape)}, want '
             f'{tuple(want.shape)}, finite={bool(torch.isfinite(out).all())}')
    err = float((out - want).abs().max() / want.abs().max().clamp_min(1e-30))
    print(f'  its logits within {err:.3e} of the same forward on the plain '
          f'versions, relative to their largest magnitude (gate {rtol})')
    if err > rtol:
        fail(f'a full bucket {shape}: logits differ from the plain versions '
             f'by {err} relative')
    del out, want, batch
    return shape


def challenge_inference(device) -> dict:
    """Phase 6.  Returns the launches of B1 and B2 over the CLI's run."""
    import os
    import pickle
    import tempfile
    from fvt_tpu_torch import inference_challenge
    from fvt_tpu_torch.config import flat_yaml
    from fvt_tpu_torch.config.defaults import get_config, to_namespace
    from fvt_tpu_torch.data import native_store
    from fvt_tpu_torch.models.registry import init_model
    from fvt_tpu_torch.ops.fusion import (fused_multimodal_fusion,
                                          fused_multimodal_fusion_simt)
    from fvt_tpu_torch.ops.tcn import (fused_temporal_block,
                                       fused_temporal_block_simt)
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    frames = sum(CHALLENGE_LENGTHS)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        store = make_cexpr_store(os.path.join(root, 'store'),
                                 CHALLENGE_LENGTHS, seed=SEED)
        run = os.path.join(root, 'run')
        best = os.path.join(run, 'best-models', 'FRAMES_AVG_LOGITS')
        os.makedirs(best)
        cfg = get_config('MELD')
        cfg.update(modality='video+vggish+bert+EXPR_continuous_label',
                   model_name='LFAN', window_length=WINDOW, hop_length=HOP,
                   eval_bucket_quantum=CHALLENGE_QUANTUM,
                   eval_window_batch=WINDOW_BATCH, outd=run, seed=SEED)
        flat_yaml.dump(cfg, os.path.join(run, 'config.yml'))
        model = init_model(to_namespace(cfg))  # from seed 0
        torch.save(model.state_dict(), os.path.join(best, 'model.pt'))
        print(f'  store of {len(CHALLENGE_LENGTHS)} videos, {frames} frames, '
              f'and run directory written in {time.perf_counter() - t0:.2f} s')

        counters = {'tcn_block': fused_temporal_block,
                    'tcn_block_simt': fused_temporal_block_simt,
                    'fusion': fused_multimodal_fusion,
                    'fusion_simt': fused_multimodal_fusion_simt,
                    **conv_counters()}
        outd = os.path.join(root, 'out')
        argv = ['--mode', 'EVALUATION', '--fd_exp', run, '--target_ds_name',
                'C-EXPR-DB-CHALLENGE', '--dataset_path',
                store['dataset_path'], '--folds_dir', store['folds_dir'],
                '--outd', outd]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(counters)
        with ShapeRecorder() as rec:
            t0 = time.perf_counter()
            exp = inference_challenge.main(argv)
            wall = time.perf_counter() - t0
        launches = read_launches(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timing = exp.trainer.last_inference_timing
        forwards = len(rec.fusion)
        print(f'  CLI wall {wall:.3f} s for {frames} frames: '
              f'{frames / wall:.1f} served frames/s; peak device memory '
              f'{peak:.2f} GiB; {forwards} forwards')
        print(f'  last_inference_timing {json.dumps(timing)}')
        print(f'  native gather loaded: {native_store.available()} '
              f'({os.path.basename(native_store.library_path())})')
        if not native_store.available():
            fail('the native feature-store gather did not build or load')
        if not timing['loader_s'] >= 0 or timing['h2d_bytes'] <= 0:
            fail(f'inference timing not reported: {timing}')
        want = {k: 0 for k in launches}
        want.update(tcn_block=12 * forwards, fusion=forwards)
        print(f'  launches {launches}')
        if forwards < 1 or launches != want or \
                len(rec.tcn) != len(MODALITY) * forwards:
            fail(f'expected 12 tcn_block and 1 fusion launches a forward '
                 f'and no other kernel over {forwards} forwards, got '
                 f'{launches}')
        shapes = sorted(set(rec.fusion), key=lambda bt: (bt[1], bt[0]))
        if sorted(set(rec.tcn)) != sorted(shapes):
            fail(f'B1 and B2 ran at other shapes: {rec.tcn} vs {shapes}')
        print(f'  (B, T) launched: {shapes}')

        with open(os.path.join(outd, 'pred-C-EXPR-DB-CHALLENGE',
                               'prediction.pkl'), 'rb') as f:
            pred = pickle.load(f)
        with open(os.path.join(store['folds_dir'], 'split-0',
                               'test.txt')) as f:
            work = [line.split(',')[0] for line in f.read().splitlines()
                    if line]
        if list(pred) != work:
            fail(f'prediction.pkl keys {list(pred)} are not the fold\'s '
                 f'order {work}')
        with open(os.path.join(store['dataset_path'],
                               'mean_std_info_fold-0.pkl'), 'rb') as f:
            mean_std = pickle.load(f)
        model = model.to(device).eval()
        offline = challenge_reference(model, store, mean_std, device)
        worst = 0.0
        for vid, n in zip(work, CHALLENGE_LENGTHS):
            got = pred[vid]['logits']
            if got.shape != (max(n, WINDOW), 7) or not np.isfinite(got).all():
                fail(f'{vid}: logits {got.shape}, finite='
                     f'{np.isfinite(got).all()}')
            err = float(np.abs(got - offline[vid]).max())
            worst = max(worst, err)
            print(f'    {vid} ({n} frames): max |CLI - offline plain| = '
                  f'{err:.3e}')
            if err > SERVE_ATOL:
                fail(f'{vid}: logits differ from the offline plain stitch '
                     f'by {err} (atol {SERVE_ATOL})')
        print(f'  every video within {worst:.3e} of the offline plain stitch '
              f'(atol {SERVE_ATOL})')
        bucket = full_bucket(exp.trainer, int(cfg['eval_video_batch']),
                             device)
        check_at_shapes(model, sorted(set(shapes) | {bucket}
                                      | set(CHALLENGE_EXTRA_SHAPES),
                                      key=lambda bt: (bt[1], bt[0])), device)
        del exp, model
    torch.cuda.empty_cache()
    return {'tcn_block': launches['tcn_block'], 'fusion': launches['fusion']}


def model_blocks(model, modality) -> list:
    """(name, B, T, Cin, Cout, dilation) of the TCN blocks of ``model`` on
    ``modality``, at the training batch."""
    return [(f'{m}.{i}', TRAIN_BATCH, WINDOW, blk.conv1.weight_v.shape[1],
             blk.n_outputs, blk.dilation)
            for m in modality
            for i, blk in enumerate(model.temporal[m].network)]


def check_train_at_shape(b: int, t: int, device, k: int = 5,
                         modality=TRAIN_MODALITY, blocks=None) -> float:
    """B3a and B3b (``fused_temporal_block_train``) at the blocks of the
    LFAN on ``modality`` (8 for ``vggish+bert``), or at ``blocks`` (as
    :func:`model_blocks` gives them), at (b, t): the forward's output and
    the six gradients against autograd of the plain version at the
    phase-2 gate.  Returns the largest error."""
    from fvt_tpu_torch.ops import tcn as tcn_ops

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    worst = 0.0
    for name, _, _, cin, cout, d in (blocks
                                     or train_block_shapes(k, modality)):
        def randn(*shape, scale=1.0):
            return torch.randn(*shape, device=device, generator=g) * scale

        def mask():
            keep = torch.full((b, t, cout), 1.0 - TCN_DROPOUT, device=device)
            return torch.bernoulli(keep, generator=g) / (1.0 - TCN_DROPOUT)

        a = {'x': randn(b, t, cin),
             'w1': randn(k, cin, cout, scale=(k * cin) ** -0.5),
             'b1': randn(cout, scale=0.1),
             'w2': randn(k, cout, cout, scale=(k * cout) ** -0.5),
             'b2': randn(cout, scale=0.1), 'res': randn(b, t, cout)}
        m1, m2, a['res'] = away_from_kink(
            a['x'], a['w1'], a['b1'], a['w2'], a['b2'], mask(), mask(),
            a['res'], d)
        cot = randn(b, t, cout)
        for v in a.values():
            v.requires_grad_(True)
        args = (a['x'], a['w1'], a['b1'], a['w2'], a['b2'], m1, m2, a['res'])
        kw = dict(kernel_size=k, dilation=d)
        leaves = list(a.values())
        want = tcn_ops.fused_temporal_block_train_ref(*args, **kw)
        want_g = torch.autograd.grad(want, leaves, cot)
        got = tcn_ops.fused_temporal_block_train(*args, **kw)
        worst = max(worst, compare(
            f'tcn_block_train {name} ({b},{t},{cin})->{cout} d={d}',
            got.detach(), want.detach()))
        for n, gg, wg in zip(a, torch.autograd.grad(got, leaves, cot),
                             want_g):
            check = compare if n in ('x', 'res') else compare_sum
            worst = max(worst, check(f'  d{n}', gg, wg))
    return worst


class MethodTimer:
    """Records, while installed, the wall of each call of the given
    methods (``{label: (owner, attribute name, attribute read after the
    call or None)}``): the run loop's epochs, validation passes,
    checkpoint saves and best-model writes, from inside the CLI.  Each
    ends on the host with its results, so the host clock holds the
    device's time too.  ``calls[label]`` lists (start, wall, the attribute
    read from the call's first argument)."""

    def __init__(self, methods: dict):
        self.methods = methods
        self.calls = {label: [] for label in methods}

    def __enter__(self):
        self.saved = []
        for label, (owner, attr, after) in self.methods.items():
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))

            def timed(*a, _fn=fn, _label=label, _after=after, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                wall = time.perf_counter() - t0
                self.calls[_label].append(
                    (t0, wall, getattr(a[0], _after) if _after else None))
                return out
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


def training_run(device) -> dict:
    """Phase 7.  Returns the launches of B1, B2, B3a and B3b over the
    CLI's two runs."""
    import os
    import pickle
    import tempfile
    from fvt_tpu_torch import inference_challenge
    from fvt_tpu_torch import main as train_cli
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store
    from fvt_tpu_torch.train import checkpoint, trainer

    rng = np.random.default_rng(SEED + 8)
    lo, hi = TRAIN_STORE_LENGTHS
    lengths = [int(n) for n in rng.integers(lo, hi + 1, TRAIN_STORE_VIDEOS)]
    val_lengths = [int(n) for n in rng.integers(lo, hi + 1,
                                                VAL_STORE_VIDEOS)]
    modality = '+'.join(TRAIN_MODALITY)

    zero, read = run_counters()
    timer_methods = {
        'epoch': (trainer.Trainer, 'train_one_epoch', 'last_epoch_timing'),
        'inference': (trainer.Trainer, 'inference', None),
        'save': (checkpoint.Checkpointer, 'save', None),
        'restore': (checkpoint.Checkpointer, 'restore', None),
        'best_model': (trainer, 'save_best_model', None)}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        store = make_cexpr_store(os.path.join(root, 'store'), lengths,
                                 ds='C-EXPR-DB', val_lengths=val_lengths,
                                 seed=SEED)
        print(f'  C-EXPR-DB store: {len(lengths)} train videos '
              f'({sum(lengths)} frames), {len(val_lengths)} val videos '
              f'({sum(val_lengths)} frames), written in '
              f'{time.perf_counter() - t0:.2f} s')
        outd = os.path.join(root, 'run')
        argv = ['--dataset_name', 'C-EXPR-DB',
                '--dataset_path', store['dataset_path'],
                '--folds_dir', store['folds_dir'],
                '--modality', f'{modality}+EXPR_continuous_label',
                '--model_name', 'LFAN', '--window_length', str(WINDOW),
                '--hop_length', str(HOP), '--train_batch_size',
                str(TRAIN_BATCH), '--seed', str(SEED),
                '--checkpoint_every', '1', '--outd', outd]

        runs = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        for name, extra in (('first', ['--num_epochs', str(RUN_EPOCHS)]),
                            ('resumed', ['--num_epochs', str(RESUMED_EPOCHS),
                                         '--resume', 'true'])):
            with ShapeRecorder() as rec, MethodTimer(timer_methods) as tm:
                t0 = time.perf_counter()
                exp = train_cli.main(argv + extra, device=device)
                runs[name] = dict(wall=time.perf_counter() - t0, t0=t0,
                                  rec=rec, calls=tm.calls,
                                  trainer=exp.trainer)
            if name == 'first':
                files = sorted(os.path.relpath(os.path.join(d, f), outd)
                               for d, _, fs in os.walk(outd) for f in fs)
                os.remove(os.path.join(outd, 'passed.txt'))
        launches = read()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        want_files = sorted(
            ['config.yml', 'log.json', 'log.txt', 'passed.txt',
             'test-None-perf.txt', 'test-None-perf.pkl',
             'pred-per-frame-test-None-perf.pkl',
             'best-models/None/model.msgpack', 'best-models/None/config.yml']
            + [f'checkpoints/{kind}_{e}.{ext}'
               for e in (RUN_EPOCHS - 2, RUN_EPOCHS - 1)
               for kind, ext in (('state', 'pt'), ('meta', 'pkl'))])
        print(f'  run directory after {RUN_EPOCHS} epochs: {files}')
        if files != want_files:
            fail(f'the run directory holds {files}, not {want_files}')
        with open(os.path.join(outd, 'log.txt')) as f:
            log = f.read()
        resumed_log = log[log.rindex('Starting experiment'):]
        for line, present in (
                (f'restored checkpoint from epoch {RUN_EPOCHS - 1}', True),
                (f'Train epoch (0/{RESUMED_EPOCHS})', False),
                (f'Train epoch ({RESUMED_EPOCHS - 1}/{RESUMED_EPOCHS})',
                 True)):
            if (line in resumed_log) != present:
                fail(f'the resumed run\'s log {"lacks" if present else "has"}'
                     f' {line!r}')
        losses = runs['resumed']['trainer'].loss_tracker
        print(f'  the resumed run restored epoch {RUN_EPOCHS - 1} and trained '
              f'epoch {RESUMED_EPOCHS - 1}; epoch losses {losses}')
        if len(losses) != RESUMED_EPOCHS or not np.all(np.isfinite(losses)):
            fail(f'expected {RESUMED_EPOCHS} finite epoch losses, got '
                 f'{losses}')

        # launches: 8 B3a and 8 B3b calls a step; 8 B1 and 1 B2 a forward
        steps = frames = forwards = 0
        train_shapes, eval_shapes = set(), set()
        for run in runs.values():
            rec = run['rec']
            steps += len(rec.fusion_train)
            frames += sum(b * t for b, t in rec.fusion_train)
            forwards += len(rec.fusion)
            train_shapes |= set(rec.fusion_train)
            eval_shapes |= set(rec.fusion)
            if sorted(set(rec.tcn)) != sorted(set(rec.fusion)) or \
                    len(rec.tcn) != len(TRAIN_MODALITY) * len(rec.fusion) or \
                    len(rec.tcn_train) != len(TRAIN_MODALITY) * len(
                        rec.fusion_train):
                fail('the TCN and the fusion ran at other shapes or counts')
        want = {k: 0 for k in launches}
        want.update(tcn_block=8 * forwards, fusion=forwards,
                    tcn_block_train=8 * steps, tcn_block_bwd=8 * steps)
        print(f'  {steps} training steps, {forwards} eval forwards; '
              f'launches {launches}')
        if steps < 1 or forwards < 1 or launches != want:
            fail(f'expected 8 B3a and 8 B3b calls a step, 8 B1 and 1 B2 '
                 f'launches a forward and no other kernel, got {launches}')
        trained = runs['resumed']['trainer'].train_step.step
        if trained != steps:
            fail(f'the resumed trainer counts {trained} steps, the run '
                 f'took {steps}')

        # times, from inside the CLI
        for name, run in runs.items():
            calls = run['calls']
            epochs = [w for _, w, _ in calls['epoch']]
            ntrain = len(run['rec'].fusion_train)
            nframes = sum(b * t for b, t in run['rec'].fusion_train)
            print(f'  {name} run: CLI wall {run["wall"]:.3f} s; epochs '
                  + ', '.join(f'{w:.3f}' for w in epochs) + f' s; {ntrain} '
                  f'steps, {nframes} frames: '
                  f'{nframes / max(sum(epochs), 1e-9):.1f} trained frames/s '
                  f'over the epochs; validation and test passes '
                  + ', '.join(f'{w:.3f}' for _, w, _ in calls['inference'])
                  + ' s; checkpoint saves '
                  + ', '.join(f'{w:.3f}' for _, w, _ in calls['save'])
                  + ' s; best-model writes '
                  + ', '.join(f'{w * 1e3:.1f}' for _, w, _ in
                              calls['best_model']) + ' ms')
            print('    epochs by phase (s): ' + '; '.join(
                ', '.join(f'{k} {v:.3f}' for k, v in t.items())
                for _, _, t in calls['epoch']))
        first = runs['first']
        print(f'  first run: set-up wall '
              f'{first["calls"]["inference"][0][0] - first["t0"]:.3f} s (CLI '
              f'start to its first validation pass)')
        resumed = runs['resumed']
        first_epoch = resumed['calls']['epoch'][0][0]
        print(f'  resume: set-up wall {first_epoch - resumed["t0"]:.3f} s '
              f'(CLI start to its first epoch, in the same process), of it '
              f'the restore {resumed["calls"]["restore"][0][1]:.3f} s; peak '
              f'device memory {peak:.2f} GiB')
        print(f'  (B, T) trained: {sorted(train_shapes)}; (B, T) of the '
              f'eval forwards: {sorted(eval_shapes)}')

        # each kernel at the shapes the run gave it
        model = runs['resumed']['trainer'].model
        check_at_shapes(model, sorted(eval_shapes,
                                      key=lambda bt: (bt[1], bt[0])),
                        device, modality=TRAIN_MODALITY)
        ragged = [bt for bt in train_shapes if bt != (TRAIN_BATCH, WINDOW)]
        if not ragged:
            fail('the run gave no ragged last batch to check B3 at')
        for b, t in ragged:
            err = check_train_at_shape(b, t, device)
            print(f'  B3a and B3b at the ragged batch ({b},{t}): max error '
                  f'{err:.3e}')

        # the best model read back through the challenge CLI: load_best_model
        # into a fresh LFAN, Trainer.inference on the val split
        evald = os.path.join(root, 'eval')
        inference_challenge.main(
            ['--mode', 'EVALUATION', '--fd_exp', outd, '--target_ds_name',
             'C-EXPR-DB', '--eval_set', 'test', '--case_best_model', 'None',
             '--dataset_path', store['dataset_path'], '--folds_dir',
             store['folds_dir'], '--outd', evald], device=device)
        with open(os.path.join(evald, 'pred-per-frame-eval-test.pkl'),
                  'rb') as f:
            got = pickle.load(f)
        with open(os.path.join(outd, 'pred-per-frame-test-None-perf.pkl'),
                  'rb') as f:
            want_pred = pickle.load(f)
        if list(got) != list(want_pred):
            fail('the read-back pass covers other videos')
        err = max(float(np.abs(got[v]['logits'] - want_pred[v]['logits'])
                        .max()) for v in want_pred)
        print(f'  best model read back from model.msgpack: logits within '
              f'{err:.3e} of the run\'s test pass (atol {READBACK_ATOL})')
        if err > READBACK_ATOL:
            fail(f'the read-back best model\'s logits differ by {err}')
        del runs, model, exp
    torch.cuda.empty_cache()
    return {'tcn_block': launches['tcn_block'], 'fusion': launches['fusion'],
            'tcn_block_train': launches['tcn_block_train'],
            'tcn_block_bwd': launches['tcn_block_bwd']}


def plain_backbone_train(backbone, crops: torch.Tensor,
                         keep: torch.Tensor, p: float) -> torch.Tensor:
    """Phase 8's plain composition of the train-mode backbone from
    PyTorch's own calls on ``backbone``'s weights: ``F.conv2d``,
    ``F.batch_norm(training=True)`` (updating the module's running
    statistics in place), ``F.prelu``, the dropout as ``where(keep, x / (1
    - p), 0)`` with the given mask, ``F.linear`` and the l2 normalisation;
    in the backbone's compute type up to the flatten, float32 after."""
    d = backbone.dtype

    def bn(mod, v):
        return F.batch_norm(v, mod.running_mean, mod.running_var,
                            mod.weight, mod.bias, True, mod.momentum,
                            mod.eps)

    def conv(mod, v, stride, pad):
        return F.conv2d(v, mod.weight.to(d), None, stride, pad)

    x = crops.to(d).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    c, b, pr = backbone.input_layer
    x = F.prelu(bn(b, conv(c, x, 1, 1)), pr.weight.to(d))
    for blk in backbone.body:
        if blk.shortcut_layer is None:
            short = x[:, :, ::blk.stride, ::blk.stride]
        else:
            c, b = blk.shortcut_layer
            short = bn(b, conv(c, x, blk.stride, 0))
        b1, c1, pr, c2, b2 = blk.res_layer
        r = F.prelu(conv(c1, bn(b1, x), 1, 1), pr.weight.to(d))
        x = bn(b2, conv(c2, r, blk.stride, 1)) + short
    b2d, _, _, lin, b1d = backbone.output_layer
    x = torch.where(keep, bn(b2d, x) / (1.0 - p), 0)
    x = bn(b1d, F.linear(x.flatten(1).float(), lin.weight, lin.bias))
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def check_backbone_train(state: dict, device) -> None:
    """Phase 8: the train-mode backbone (``VisualBackbone(train=True)``,
    float32 and bfloat16) on one training batch's crops (TRAIN_BATCH x
    WINDOW frames through the train transform) against
    :func:`plain_backbone_train` on the same crops and the same dropout
    mask: the embeddings and every running statistic after the step.
    bfloat16 is held within BF16_PATHS_APART of its own distance from
    float32 (each path's bfloat16 result against its float32 one, the
    larger): the two round at other places (flax's points in the port,
    one rounding in ``F.batch_norm``)."""
    from fvt_tpu_torch.data.transforms import (draw_crop_flip,
                                               train_video_transform)
    from fvt_tpu_torch.models.arcface import VisualBackbone, dropout_mask

    g = torch.Generator(device=device).manual_seed(SEED + 11)
    video = torch.randint(0, 256, (TRAIN_BATCH, WINDOW, 48, 48, 3),
                          dtype=torch.uint8, device=device, generator=g)
    crops = train_video_transform(video, *draw_crop_flip(TRAIN_BATCH, g))
    crops = crops.reshape(-1, 40, 40, 3)
    del video
    n = crops.shape[0]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        port = VisualBackbone(dtype=dtype).to(device)
        port.load_state_dict(state, strict=True)
        plain = copy.deepcopy(port)
        p = port.backbone.output_layer[1].p
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = port(crops, train=True,
                   generator=torch.Generator(device=device).manual_seed(5))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        keep = dropout_mask(torch.empty((n, 512, 5, 5), device=device), p,
                            torch.Generator(device=device).manual_seed(5))
        with torch.no_grad():
            want = plain_backbone_train(plain.backbone, crops, keep, p)
        stats = {k: (v, plain.state_dict()[k])
                 for k, v in port.state_dict().items() if 'running_' in k}
        results[dtype] = dict(got=got, want=want, stats=stats)
        print(f'  train-mode backbone, {dtype}: {n} frames in {wall:.3f} s '
              f'(host clock, first call), {peak:.2f} GiB of device memory '
              f'above its input; {len(stats)} running statistics moved')
        del port, plain
    f32, b16 = results[torch.float32], results[torch.bfloat16]
    emb = float((f32['got'] - f32['want']).abs().max())
    excess = max(float(((a - b).abs() - STATS_RTOL * b.abs()).max())
                 for a, b in f32['stats'].values())
    print(f'  fp32 vs the plain composition: embeddings {emb:.3e} (atol '
          f'{EMBED_ATOL}); running statistics within {STATS_RTOL} of their '
          f'value plus {excess:.3e} (atol {STATS_ATOL})')
    if emb > EMBED_ATOL or excess > STATS_ATOL:
        fail('the float32 train-mode backbone disagrees with its plain '
             'composition')
    # each bf16 result's distance from its float32 twin, the larger: two
    # results each within it of float32 lie within twice it of each other
    own = max(float((b16[k] - f32[k]).abs().max()) for k in ('got', 'want'))
    own_stats = max(float((b16['stats'][k][i] - f32['stats'][k][i]).abs()
                          .max()) for k in f32['stats'] for i in (0, 1))
    emb = float((b16['got'] - b16['want']).abs().max())
    stats = max(float((a - b).abs().max()) for a, b in b16['stats'].values())
    print(f'  bf16 vs the plain composition: embeddings {emb:.3e}, running '
          f'statistics {stats:.3e}; bf16\'s own distance from fp32 '
          f'{own:.3e} and {own_stats:.3e} (gate {BF16_PATHS_APART}x)')
    if emb > BF16_PATHS_APART * own or stats > BF16_PATHS_APART * own_stats:
        fail('the bfloat16 train-mode backbone disagrees with its plain '
             'composition')


def time_train_ab(trainer, device, pairs: int, label: str) -> None:
    """Phase 8's A/B of a tri-modal step at (TRAIN_BATCH, WINDOW): the
    trainer's step timed with CUDA events with ``tcn_fused`` on and off,
    then with ``frozen_eval`` on and off, in turns over ``pairs`` pairs
    (the order flipped every pair); and the train-mode backbone alone on
    the step's frames, its share of the default step."""
    from fvt_tpu_torch.config import model_config as MC
    from fvt_tpu_torch.data.transforms import (draw_crop_flip,
                                               train_video_transform)
    from fvt_tpu_torch.train.steps import to_device

    rng = np.random.default_rng(SEED + 12)
    shape = (TRAIN_BATCH, WINDOW)
    batch = {'video': rng.integers(0, 256, shape + (48, 48, 3), np.uint8),
             'EXPR_continuous_label': rng.integers(0, 7, shape)}
    for m in MODALITY[1:]:
        batch[m] = rng.standard_normal(
            shape + tuple(MC.FEATURE_DIMENSION[m]), np.float32)
    batch = to_device(batch, device)
    step, model = trainer.train_step, trainer.model
    calls = iter(range(10 ** 6))

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch, trainer.step_generator(99, next(calls)))
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    switches = {'tcn_fused': lambda on: setattr(step, 'tcn_fused', on),
                'frozen_eval': lambda on: setattr(model, 'frozen_eval', on)}
    defaults = {'tcn_fused': step.tcn_fused, 'frozen_eval': model.frozen_eval}
    medians = {}
    for name, switch in switches.items():
        times = {True: [], False: []}
        for on in (True, False):
            switch(on)
            timed()
        for i in range(pairs):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                switch(on)
                times[on].append(timed())
        switch(defaults[name])
        med = {on: statistics.median(t) for on, t in times.items()}
        medians[name] = med
        print(f'  {label} step, {name} on / off, {pairs} pairs in turns: '
              f'median {med[True]:.2f} / {med[False]:.2f} ms (min '
              f'{min(times[True]):.2f} / {min(times[False]):.2f}) -> '
              f'{TRAIN_BATCH * WINDOW / med[True] * 1e3:.1f} / '
              f'{TRAIN_BATCH * WINDOW / med[False] * 1e3:.1f} trained '
              f'frames/s')
    crops = train_video_transform(
        batch['video'], *draw_crop_flip(
            TRAIN_BATCH, torch.Generator(device=device).manual_seed(1)))
    crops = crops.reshape(-1, 40, 40, 3)
    g = torch.Generator(device=device).manual_seed(2)
    bb = median_ms(lambda: model.spatial.visual(crops, train=True,
                                                generator=g), runs=5,
                   warmup=1)
    default = medians['tcn_fused'][defaults['tcn_fused']]
    print(f'  {label}: the train-mode backbone alone on {crops.shape[0]} '
          f'frames {bb:.2f} ms (median of 5, CUDA events), '
          f'{100 * bb / default:.1f}% of the default step')


def make_tri_store(path: str) -> dict:
    """Phases 8 and 9's C-EXPR-DB store at TRI_VIDEO_HW^2 (video lengths
    drawn from the seed); returns ``make_cexpr_store``'s paths."""
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    rng = np.random.default_rng(SEED + 10)
    lo, hi = TRI_STORE_LENGTHS
    lengths = [int(n) for n in rng.integers(lo, hi + 1, TRI_STORE_VIDEOS)]
    val_lengths = [int(n) for n in rng.integers(lo, hi + 1, TRI_VAL_VIDEOS)]
    t0 = time.perf_counter()
    store = make_cexpr_store(path, lengths, ds='C-EXPR-DB',
                             val_lengths=val_lengths, seed=SEED,
                             video_hw=TRI_VIDEO_HW)
    print(f'  C-EXPR-DB store at {TRI_VIDEO_HW}^2: {len(lengths)} train '
          f'videos ({sum(lengths)} frames), {len(val_lengths)} val '
          f'videos ({sum(val_lengths)} frames), written in '
          f'{time.perf_counter() - t0:.2f} s')
    return store


def tri_modal_training(device) -> dict:
    """Phase 8.  Returns the launches of B1, B2, B3a and B3b over the
    CLI's three runs."""
    import os
    import pickle
    import tempfile
    from fvt_tpu_torch import inference_challenge
    from fvt_tpu_torch import main as train_cli
    from fvt_tpu_torch.data import native_store
    from fvt_tpu_torch.models.checkpoint import read_flax_variables
    from fvt_tpu_torch.train import trainer

    resized = []
    gather_resize = native_store.gather_resize_rows

    def counted_resize(*a, **kw):
        out = gather_resize(*a, **kw)
        resized.append(None if out is None else out.shape[1:3])
        return out

    zero, read = run_counters()
    timer_methods = {
        'epoch': (trainer.Trainer, 'train_one_epoch', 'last_epoch_timing'),
        'inference': (trainer.Trainer, 'inference', None),
        'best_model': (trainer, 'save_best_model', None)}
    total = {k: 0 for k in ('tcn_block', 'fusion', 'tcn_block_train',
                            'tcn_block_bwd')}
    with tempfile.TemporaryDirectory() as root:
        store = make_tri_store(os.path.join(root, 'store'))
        base = ['--dataset_name', 'C-EXPR-DB',
                '--dataset_path', store['dataset_path'],
                '--folds_dir', store['folds_dir'],
                '--modality', f'{"+".join(MODALITY)}+EXPR_continuous_label',
                '--model_name', 'LFAN', '--window_length', str(WINDOW),
                '--hop_length', str(HOP), '--train_batch_size',
                str(TRAIN_BATCH), '--seed', str(SEED)]
        fp32_dir = os.path.join(root, 'fp32')
        amp_dir = os.path.join(root, 'amp')
        runs = (
            ('fp32', fp32_dir, ['--num_epochs', str(TRI_EPOCHS - 1),
                                '--checkpoint_every', '1']),
            ('fp32 resumed', fp32_dir, ['--num_epochs', str(TRI_EPOCHS),
                                        '--checkpoint_every', '1',
                                        '--resume', 'true']),
            ('amp', amp_dir, ['--num_epochs', str(TRI_EPOCHS),
                              '--amp', 'true']))
        trainers, train_shapes = {}, set()
        native_store.gather_resize_rows = counted_resize
        try:
            for name, outd, extra in runs:
                zero()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with ShapeRecorder() as rec, \
                        MethodTimer(timer_methods) as tm:
                    t0 = time.perf_counter()
                    exp = train_cli.main(base + extra + ['--outd', outd],
                                         device=device)
                    wall = time.perf_counter() - t0
                launches = read()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                if name == 'fp32':
                    os.remove(os.path.join(outd, 'passed.txt'))
                else:
                    trainers[name] = exp.trainer
                steps, forwards = len(rec.fusion_train), len(rec.fusion)
                want = {k: 0 for k in launches}
                want.update(tcn_block=12 * forwards, fusion=forwards,
                            tcn_block_train=12 * steps,
                            tcn_block_bwd=12 * steps)
                print(f'  {name} run: {steps} training steps, {forwards} '
                      f'eval forwards; launches {launches}')
                if steps < 1 or forwards < 1 or launches != want:
                    fail(f'{name}: expected 12 B3a and 12 B3b calls a '
                         f'step, 12 B1 and 1 B2 launches a forward and no '
                         f'other kernel, got {launches}')
                for k in total:
                    total[k] += launches[k]
                frames = sum(b * t for b, t in rec.fusion_train)
                epochs = tm.calls['epoch']
                ep_wall = sum(w for _, w, _ in epochs)
                print(f'    CLI wall {wall:.3f} s; epochs '
                      + ', '.join(f'{w:.3f}' for _, w, _ in epochs)
                      + f' s; {frames} frames trained: '
                      f'{frames / max(ep_wall, 1e-9):.1f} trained frames/s '
                      f'over the epochs; step_s a step '
                      f'{sum(t["step_s"] for _, _, t in epochs) / steps:.3f}'
                      f' s; validation and test passes '
                      + ', '.join(f'{w:.3f}' for _, w, _ in
                                  tm.calls['inference'])
                      + ' s; best-model writes '
                      + ', '.join(f'{w:.3f}' for _, w, _ in
                                  tm.calls['best_model'])
                      + f' s; peak device memory {peak:.2f} GiB')
                print('    epochs by phase (s): ' + '; '.join(
                    ', '.join(f'{k} {v:.3f}' for k, v in t.items())
                    for _, _, t in epochs))
                print(f'    (B, T) trained: {sorted(set(rec.fusion_train))};'
                      f' eval: {sorted(set(rec.fusion))}')
                check_at_shapes(exp.trainer.model,
                                sorted(set(rec.fusion),
                                       key=lambda bt: (bt[1], bt[0])),
                                device)
                train_shapes |= set(rec.fusion_train)
        finally:
            native_store.gather_resize_rows = gather_resize
        # B3 at the video's four blocks: every trained (B, T), and the full
        # batch, which a store this small may not give
        for b, t in sorted(train_shapes | {(TRAIN_BATCH, WINDOW)}):
            err = check_train_at_shape(b, t, device, modality=('video',))
            print(f'  B3a and B3b at the video blocks ({b},{t}): max error '
                  f'{err:.3e}')
        sizes = sorted(set(resized))
        print(f'  the native host resize ran {len(resized)} times, to '
              f'{sizes}')
        # training's frames at 48^2; the eval passes' at 40^2, the center
        # crop folded into the resize
        if not resized or sizes != [(40, 40), (48, 48)]:
            fail(f'the 256^2 store was not read through the native resize '
                 f'to 48^2 and 40^2: {sizes}')
        with open(os.path.join(fp32_dir, 'log.txt')) as f:
            log = f.read()
        if f'restored checkpoint from epoch {TRI_EPOCHS - 2}' not in log:
            fail('the resumed float32 run did not restore its checkpoint')

        # the backbone's statistics moved; the best model carries fvt_tpu's
        # ArcFace subtree; read back through the challenge CLI
        live = trainers['fp32 resumed'].model
        moved = [k for k, v in live.state_dict().items()
                 if k.startswith('spatial.') and 'running_' in k
                 and not torch.equal(v, torch.full_like(
                     v, 0.0 if k.endswith('mean') else 1.0))]
        print(f'  {len(moved)} of the backbone\'s 108 running statistics '
              f'moved in training')
        if len(moved) != 108:
            fail('training left running statistics of the backbone unmoved')
        for name, outd in (('fp32', fp32_dir), ('amp', amp_dir)):
            params, _ = read_flax_variables(
                os.path.join(outd, 'best-models', 'None', 'model.msgpack'))
            if 'backbone' not in params.get('spatial_video', {}):
                fail(f'{name}: the best model lacks the ArcFace subtree')
            evald = os.path.join(root, f'eval_{name}')
            inference_challenge.main(
                ['--mode', 'EVALUATION', '--fd_exp', outd, '--target_ds_name',
                 'C-EXPR-DB', '--eval_set', 'test', '--case_best_model',
                 'None', '--dataset_path', store['dataset_path'],
                 '--folds_dir', store['folds_dir'], '--outd', evald],
                device=device)
            with open(os.path.join(evald, 'pred-per-frame-eval-test.pkl'),
                      'rb') as f:
                got = pickle.load(f)
            with open(os.path.join(outd, 'pred-per-frame-test-None-perf.pkl'),
                      'rb') as f:
                want_pred = pickle.load(f)
            if list(got) != list(want_pred):
                fail(f'{name}: the read-back pass covers other videos')
            err = max(float(np.abs(got[v]['logits'] - want_pred[v]['logits'])
                            .max()) for v in want_pred)
            print(f'  {name} best model read back from model.msgpack: logits '
                  f'within {err:.3e} of the run\'s test pass (atol '
                  f'{READBACK_ATOL})')
            if err > READBACK_ATOL:
                fail(f'{name}: the read-back logits differ by {err}')

        check_backbone_train(
            {k[len('spatial.visual.'):]: v
             for k, v in live.state_dict().items()
             if k.startswith('spatial.visual.')}, device)
        time_train_ab(trainers['fp32 resumed'], device, AB_PAIRS, 'fp32')
        time_train_ab(trainers['amp'], device, AB_PAIRS_BF16, 'bf16 (--amp)')
        del trainers, live, exp
    torch.cuda.empty_cache()
    return total


def family_reference(model, store: dict, mean_std: dict, modality,
                     quantum: int, device) -> dict:
    """Phase 9's offline composition: each video of
    :func:`challenge_videos` padded by repeat to the window and with zeros
    to its bucket, as the loader hands it over, then the plain-version
    forward of ``model`` on it alone (with the valid frames' mask where
    the model takes one) and the valid frames kept."""
    from fvt_tpu_torch.data import windowing as W
    from fvt_tpu_torch.serve import serving_forward, valid_frames

    out = {}
    for key, arrays in challenge_videos(store, mean_std, modality):
        n = len(arrays[modality[0]])
        rows = (W.pad_short_window_indices(n, WINDOW) if n < WINDOW
                else np.arange(n))
        true_len = len(rows)
        bucket = -(-true_len // quantum) * quantum
        batch = {}
        for k, a in arrays.items():
            a = a[rows]
            a = np.concatenate([a, np.zeros((bucket - true_len,)
                                            + a.shape[1:], a.dtype)])
            batch[k] = torch.from_numpy(a[None]).to(device)
        mask = (valid_frames([true_len], bucket, device)
                if model.needs_time_mask else None)
        logits = serving_forward(model, batch, time_mask=mask,
                                 reference=True)
        out[key] = logits[0, :true_len].cpu().numpy()
    return out


def time_family_step(trainer, modality, device, label: str) -> None:
    """Phase 9: the trainer's step at (TRAIN_BATCH, WINDOW) on a random
    batch, CUDA events, median of FAMILY_STEP_RUNS after a warm-up; for
    JMT and MT also the fusion's forward and backward alone on the
    step's (B, T), its share of the step."""
    from fvt_tpu_torch.config import model_config as MC
    from fvt_tpu_torch.train.steps import to_device

    rng = np.random.default_rng(SEED + 13)
    shape = (TRAIN_BATCH, WINDOW)
    batch = {'video': rng.integers(0, 256, shape + (48, 48, 3), np.uint8),
             'EXPR_continuous_label': rng.integers(0, 7, shape)}
    for m in modality[1:]:
        batch[m] = rng.standard_normal(
            shape + tuple(MC.FEATURE_DIMENSION[m]), np.float32)
    batch = to_device(batch, device)
    calls = iter(range(10 ** 6))

    def step():
        trainer.train_step(batch, trainer.step_generator(98, next(calls)))

    ms = median_ms(step, runs=FAMILY_STEP_RUNS, warmup=1)
    print(f'  {label}: a step at {shape} {ms:.2f} ms (median of '
          f'{FAMILY_STEP_RUNS}, CUDA events): '
          f'{TRAIN_BATCH * WINDOW / ms * 1e3:.1f} trained frames/s')
    fuse = trainer.model.fuse
    if not hasattr(fuse, 'joint'):
        return
    g = torch.Generator(device=device).manual_seed(SEED + 14)
    visual = torch.randn(shape + (128,), device=device, generator=g,
                         requires_grad=True)
    audio = torch.randn(shape + (fuse.augment_audio_feats_dim.in_features,),
                        device=device, generator=g, requires_grad=True)

    def fusion():
        fuse(visual, audio).sum().backward()

    fms = median_ms(fusion, runs=FAMILY_STEP_RUNS, warmup=1)
    fuse.zero_grad(set_to_none=True)
    print(f'  {label}: the fusion alone (attention over {TRAIN_BATCH} x '
          f'{WINDOW} frames, forward and backward) {fms:.2f} ms, '
          f'{100 * fms / ms:.1f}% of the step')


def fusion_families(device) -> dict:
    """Phase 9.  Returns the launches of B1, B2, B3a and B3b over the
    training and challenge CLIs of the four runs."""
    import os
    import pickle
    import tempfile
    from fvt_tpu_torch import inference_challenge
    from fvt_tpu_torch import main as train_cli
    from fvt_tpu_torch.config.defaults import to_namespace
    from fvt_tpu_torch.config.flat_yaml import load as load_yaml
    from fvt_tpu_torch.models.checkpoint import (load_best_model,
                                                 save_best_model)
    from fvt_tpu_torch.models.registry import init_model
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store
    from fvt_tpu_torch.train import trainer


    zero, read = run_counters()
    timer_methods = {
        'epoch': (trainer.Trainer, 'train_one_epoch', 'last_epoch_timing'),
        'inference': (trainer.Trainer, 'inference', None)}
    total = {k: 0 for k in ('tcn_block', 'fusion', 'tcn_block_train',
                            'tcn_block_bwd')}
    with tempfile.TemporaryDirectory() as root:
        store = make_tri_store(os.path.join(root, 'store'))
        t0 = time.perf_counter()
        chal = make_cexpr_store(os.path.join(root, 'challenge'),
                                CHALLENGE_LENGTHS, seed=SEED)
        print(f'  challenge store of {len(CHALLENGE_LENGTHS)} videos, '
              f'{sum(CHALLENGE_LENGTHS)} frames, written in '
              f'{time.perf_counter() - t0:.2f} s')
        for name, modality, amp in FAMILY_RUNS:
            label = name + (' --amp' if amp else '')
            outd = os.path.join(root, label.replace(' --', '_'))
            argv = ['--dataset_name', 'C-EXPR-DB',
                    '--dataset_path', store['dataset_path'],
                    '--folds_dir', store['folds_dir'],
                    '--modality',
                    f'{"+".join(modality)}+EXPR_continuous_label',
                    '--model_name', name, '--window_length', str(WINDOW),
                    '--hop_length', str(HOP), '--train_batch_size',
                    str(TRAIN_BATCH), '--seed', str(SEED), '--num_epochs',
                    str(FAMILY_EPOCHS), '--amp', str(amp).lower(),
                    '--outd', outd]
            print(f'  {label} on {"+".join(modality)}:')
            zero()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with ShapeRecorder() as rec, MethodTimer(timer_methods) as tm:
                t0 = time.perf_counter()
                exp = train_cli.main(argv, device=device)
                wall = time.perf_counter() - t0
            launches = read()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            model = exp.trainer.model
            fused = modality if name == 'CAN' else ('video', 'vggish')
            n_eval = sum(len(model.temporal[m].network) for m in fused)
            n_train = sum(len(model.temporal[m].network) for m in modality)
            steps, forwards = len(rec.model_train), len(rec.model)
            want = {k: 0 for k in launches}
            want.update(tcn_block=n_eval * forwards,
                        tcn_block_train=n_train * steps,
                        tcn_block_bwd=n_train * steps)
            print(f'    training CLI: {steps} steps, {forwards} eval '
                  f'forwards; launches {launches}')
            if steps < 1 or forwards < 1 or launches != want:
                fail(f'{label}: expected {n_train} B3a and {n_train} B3b '
                     f'calls a step, {n_eval} B1 launches a forward and no '
                     f'other kernel, got {launches}')
            for k in total:
                total[k] += launches[k]
            frames = sum(b * t for b, t in rec.model_train)
            epochs = tm.calls['epoch']
            ep_wall = sum(w for _, w, _ in epochs)
            print(f'    CLI wall {wall:.3f} s; epochs '
                  + ', '.join(f'{w:.3f}' for _, w, _ in epochs)
                  + f' s; {frames} frames trained: '
                  f'{frames / max(ep_wall, 1e-9):.1f} trained frames/s over '
                  f'the epochs; step_s a step '
                  f'{sum(t["step_s"] for _, _, t in epochs) / steps:.3f} s; '
                  f'validation and test passes '
                  + ', '.join(f'{w:.3f}' for _, w, _ in tm.calls['inference'])
                  + f' s; peak device memory {peak:.2f} GiB')
            print('    epochs by phase (s): ' + '; '.join(
                ', '.join(f'{k} {v:.3f}' for k, v in t.items())
                for _, _, t in epochs))
            train_shapes = set(rec.model_train)
            eval_shapes = set(rec.model)

            # the best model read back exactly: loaded into a fresh model
            # of the run's config and written again, the same bytes
            best = os.path.join(outd, 'best-models', 'None', 'model.msgpack')
            args = to_namespace(load_yaml(os.path.join(outd, 'config.yml')))
            fresh = init_model(args)
            load_best_model(fresh, best, modality)
            again = os.path.join(root, 'again.msgpack')
            save_best_model(fresh, again, modality)
            with open(best, 'rb') as f, open(again, 'rb') as g:
                same = f.read() == g.read()
            print(f'    best model read back: written again '
                  f'{"byte-equal" if same else "DIFFERENT"}')
            if not same:
                fail(f'{label}: the best model did not read back exactly')

            # served through the challenge CLI from that best model
            evald = os.path.join(root, f'eval_{label}')
            zero()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with ShapeRecorder() as crec, MethodTimer(timer_methods) as ctm:
                t0 = time.perf_counter()
                cexp = inference_challenge.main(
                    ['--mode', 'EVALUATION', '--fd_exp', outd,
                     '--case_best_model', 'None', '--target_ds_name',
                     'C-EXPR-DB-CHALLENGE', '--dataset_path',
                     chal['dataset_path'], '--folds_dir', chal['folds_dir'],
                     '--outd', evald], device=device)
                cwall = time.perf_counter() - t0
            launches = read()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            forwards = len(crec.model)
            want = {k: 0 for k in launches}
            want.update(tcn_block=n_eval * forwards)
            chunk = cexp.trainer.model.eval_frames
            print(f'    challenge CLI: {forwards} forwards at '
                  f'{sorted(set(crec.model))}; launches {launches}; the '
                  f'backbone\'s calls at most {max(crec.backbone)} frames '
                  f'(chunk {chunk})')
            if forwards < 1 or launches != want:
                fail(f'{label}: expected {n_eval} B1 launches a forward and '
                     f'no other kernel in the challenge pass, got '
                     f'{launches}')
            if max(crec.backbone) > chunk:
                fail(f'{label}: the eval backbone took {max(crec.backbone)} '
                     f'frames at once, above {chunk}')
            total['tcn_block'] += launches['tcn_block']
            pass_wall = ctm.calls['inference'][0][1]
            frames = sum(CHALLENGE_LENGTHS)
            print(f'    CLI wall {cwall:.3f} s, the pass {pass_wall:.3f} s: '
                  f'{frames / pass_wall:.1f} served frames/s; peak device '
                  f'memory {peak:.2f} GiB; last_inference_timing '
                  f'{json.dumps(cexp.trainer.last_inference_timing)}')
            eval_shapes |= set(crec.model)
            with open(os.path.join(evald, 'pred-C-EXPR-DB-CHALLENGE',
                                   'prediction.pkl'), 'rb') as f:
                pred = pickle.load(f)
            with open(os.path.join(chal['dataset_path'],
                                   'mean_std_info_fold-0.pkl'), 'rb') as f:
                mean_std = pickle.load(f)
            fresh = fresh.to(device)
            offline = family_reference(fresh, chal, mean_std, modality,
                                       int(args.eval_bucket_quantum), device)
            if list(pred) != list(offline):
                fail(f'{label}: prediction.pkl covers {list(pred)}, the '
                     f'store {list(offline)}')
            worst = 0.0
            for vid, want_v in offline.items():
                got = pred[vid]['logits']
                if got.shape != want_v.shape or not np.isfinite(got).all():
                    fail(f'{label} {vid}: logits {got.shape}, want '
                         f'{want_v.shape}, finite={np.isfinite(got).all()}')
                err = float(np.abs(got - want_v).max()
                            / max(np.abs(want_v).max(), 1e-30))
                worst = max(worst, err)
            print(f'    every video\'s logits within {worst:.3e} of the '
                  f'offline plain composition, relative to their largest '
                  f'magnitude (gate {FAMILY_RTOL})')
            if worst > FAMILY_RTOL:
                fail(f'{label}: served logits differ from the offline plain '
                     f'composition by {worst} relative')

            if name == 'CAN':
                eval_shapes.add(full_bucket(
                    cexp.trainer, int(args.eval_video_batch), device,
                    FAMILY_BUCKET_LENGTH, modality))

            # the kernels at every shape the run gave them
            print(f'    (B, T) trained: {sorted(train_shapes)}; eval: '
                  f'{sorted(eval_shapes, key=lambda bt: (bt[1], bt[0]))}')
            check_at_shapes(model, sorted(eval_shapes,
                                          key=lambda bt: (bt[1], bt[0])),
                            device, modality=fused)
            blocks = model_blocks(model, modality)
            for b, t in sorted(train_shapes | {(TRAIN_BATCH, WINDOW)}):
                err = check_train_at_shape(b, t, device, blocks=blocks)
                print(f'    B3a and B3b at the {len(blocks)} blocks at '
                      f'({b},{t}): max error {err:.3e}')
            time_family_step(exp.trainer, modality, device, label)
            del exp, cexp, model, fresh
            torch.cuda.empty_cache()
    return total


def vggish_flops(patches: int) -> float:
    """The VGGish's operations on ``patches`` log-mel patches: two a
    multiply-add of its six convolutions and three Linear layers."""
    from fvt_tpu_torch.models.vggish import EMBEDDING_DIM, PATCH, VGG_CFG

    macs, (h, w), cin = 0, PATCH, 1
    for v in VGG_CFG:
        if v == 'M':
            h, w = h // 2, w // 2
        else:
            macs += h * w * cin * v * 9
            cin = v
    macs += h * w * cin * 4096 + 4096 * 4096 + 4096 * EMBEDDING_DIM
    return 2.0 * macs * patches


def time_logmel_step(trainer, device, label: str) -> None:
    """Phase 10: the trainer's step at (TRAIN_BATCH, WINDOW) on a random
    ``logmel+bert`` batch and its peak device memory; the VGGish alone on
    the step's TRAIN_BATCH * WINDOW patches (its train call, under
    ``no_grad``) and on one eval chunk of WINDOW_BATCH * WINDOW patches;
    CUDA events, medians of FAMILY_STEP_RUNS after a warm-up."""
    from fvt_tpu_torch.config import model_config as MC
    from fvt_tpu_torch.train.steps import to_device

    rng = np.random.default_rng(SEED + 15)
    shape = (TRAIN_BATCH, WINDOW)
    batch = to_device({
        'logmel': rng.standard_normal(shape + (96, 64), np.float32),
        'bert': rng.standard_normal(
            shape + tuple(MC.FEATURE_DIMENSION['bert']), np.float32),
        'EXPR_continuous_label': rng.integers(0, 7, shape)}, device)
    calls = iter(range(10 ** 6))

    def step():
        trainer.train_step(batch, trainer.step_generator(97, next(calls)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(step, runs=FAMILY_STEP_RUNS, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vggish = trainer.model.spatial.audio.backbone
    patches = batch['logmel'].reshape(-1, 96, 64)
    chunk = patches[:WINDOW_BATCH * WINDOW]
    with torch.no_grad():
        train_ms = median_ms(lambda: vggish(patches),
                             runs=FAMILY_STEP_RUNS, warmup=1)
    with torch.inference_mode():
        eval_ms = median_ms(lambda: vggish(chunk), runs=FAMILY_STEP_RUNS,
                            warmup=1)
    peak_flops = (PEAK_FLOPS_BF16 if vggish.dtype == torch.bfloat16
                  else PEAK_FLOPS)
    flops = vggish_flops(len(chunk))
    print(f'  {label}: a step at {shape} {ms:.2f} ms (median of '
          f'{FAMILY_STEP_RUNS}, CUDA events), peak device memory '
          f'{peak:.2f} GiB; the VGGish ({vggish.dtype}) on its '
          f'{len(patches)} patches {train_ms:.2f} ms, '
          f'{100 * train_ms / ms:.1f}% of the step; on an eval chunk of '
          f'{len(chunk)} patches {eval_ms:.2f} ms, '
          f'{flops / eval_ms / 1e9:.1f} TFLOP/s ({flops / 1e12:.2f} TFLOP; '
          f'bound {flops / peak_flops * 1e3:.2f} ms at '
          f'{peak_flops / 1e12:.0f} TFLOP/s)')


def make_logmel_store(path: str) -> dict:
    """Phase 10's C-EXPR-DB store with logmel.npy (phase 8's video
    lengths, drawn from the seed); returns ``make_cexpr_store``'s
    paths."""
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    rng = np.random.default_rng(SEED + 10)
    lo, hi = TRI_STORE_LENGTHS
    lengths = [int(n) for n in rng.integers(lo, hi + 1, TRI_STORE_VIDEOS)]
    val_lengths = [int(n) for n in rng.integers(lo, hi + 1, TRI_VAL_VIDEOS)]
    t0 = time.perf_counter()
    store = make_cexpr_store(path, lengths, ds='C-EXPR-DB',
                             val_lengths=val_lengths, seed=SEED, logmel=True)
    print(f'  C-EXPR-DB store with logmel: {len(lengths)} train videos '
          f'({sum(lengths)} frames), {len(val_lengths)} val videos '
          f'({sum(val_lengths)} frames), written in '
          f'{time.perf_counter() - t0:.2f} s')
    return store


def logmel_training(device) -> dict:
    """Phase 10.  Returns the launches of B1, B2, B3a and B3b over the
    training and challenge CLIs of its runs."""
    import os
    import pickle
    import tempfile
    from fvt_tpu_torch import inference_challenge
    from fvt_tpu_torch import main as train_cli
    from fvt_tpu_torch.config.defaults import to_namespace
    from fvt_tpu_torch.config.flat_yaml import load as load_yaml
    from fvt_tpu_torch.models.checkpoint import (load_best_model,
                                                 read_flax_variables,
                                                 save_best_model)
    from fvt_tpu_torch.models.registry import init_model
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store
    from fvt_tpu_torch.train import trainer

    zero, read = run_counters()
    timer_methods = {
        'epoch': (trainer.Trainer, 'train_one_epoch', 'last_epoch_timing'),
        'inference': (trainer.Trainer, 'inference', None),
        'best_model': (trainer, 'save_best_model', None)}
    total = {k: 0 for k in ('tcn_block', 'fusion', 'tcn_block_train',
                            'tcn_block_bwd')}
    modality = LOGMEL_MODALITY
    with tempfile.TemporaryDirectory() as root:
        store = make_logmel_store(os.path.join(root, 'store'))
        t0 = time.perf_counter()
        chal = make_cexpr_store(os.path.join(root, 'challenge'),
                                CHALLENGE_LENGTHS, seed=SEED, logmel=True)
        print(f'  challenge store with logmel: {len(CHALLENGE_LENGTHS)} '
              f'videos, {sum(CHALLENGE_LENGTHS)} frames, written in '
              f'{time.perf_counter() - t0:.2f} s')
        base = ['--dataset_name', 'C-EXPR-DB',
                '--dataset_path', store['dataset_path'],
                '--folds_dir', store['folds_dir'],
                '--modality', f'{"+".join(modality)}+EXPR_continuous_label',
                '--window_length', str(WINDOW), '--hop_length', str(HOP),
                '--train_batch_size', str(TRAIN_BATCH), '--seed', str(SEED)]
        lfan_dir = os.path.join(root, 'lfan')
        runs = (
            ('LFAN', 'LFAN fp32', lfan_dir,
             ['--num_epochs', str(LOGMEL_EPOCHS - 1),
              '--checkpoint_every', '1']),
            ('LFAN', 'LFAN fp32 resumed', lfan_dir,
             ['--num_epochs', str(LOGMEL_EPOCHS), '--checkpoint_every', '1',
              '--resume', 'true']),
            ('LFAN', 'LFAN --amp', os.path.join(root, 'lfan_amp'),
             ['--num_epochs', str(LOGMEL_EPOCHS), '--amp', 'true']),
            ('CAN', 'CAN fp32', os.path.join(root, 'can'),
             ['--num_epochs', str(LOGMEL_EPOCHS)]))
        for name, label, outd, extra in runs:
            print(f'  {label} on {"+".join(modality)}:')
            zero()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with ShapeRecorder() as rec, MethodTimer(timer_methods) as tm:
                t0 = time.perf_counter()
                exp = train_cli.main(base + ['--model_name', name] + extra
                                     + ['--outd', outd], device=device)
                wall = time.perf_counter() - t0
            launches = read()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            model = exp.trainer.model
            n_blocks = sum(len(model.temporal[m].network) for m in modality)
            steps, forwards = len(rec.model_train), len(rec.model)
            want = {k: 0 for k in launches}
            want.update(tcn_block=n_blocks * forwards,
                        tcn_block_train=n_blocks * steps,
                        tcn_block_bwd=n_blocks * steps,
                        fusion=forwards if name == 'LFAN' else 0)
            print(f'    training CLI: {steps} steps, {forwards} eval '
                  f'forwards; launches {launches}; the VGGish\'s calls '
                  f'{sorted(set(rec.audio))} patches')
            if steps < 1 or forwards < 1 or launches != want:
                fail(f'{label}: expected {n_blocks} B3a and {n_blocks} B3b '
                     f'calls a step, {n_blocks} B1 launches a forward '
                     f'{"and one B2 " if name == "LFAN" else ""}and no '
                     f'other kernel, got {launches}')
            if len(rec.audio) < steps + forwards:
                fail(f'{label}: {len(rec.audio)} VGGish calls for {steps} '
                     f'steps and {forwards} forwards')
            for k in total:
                total[k] += launches[k]
            frames = sum(b * t for b, t in rec.model_train)
            epochs = tm.calls['epoch']
            ep_wall = sum(w for _, w, _ in epochs)
            print(f'    CLI wall {wall:.3f} s; epochs '
                  + ', '.join(f'{w:.3f}' for _, w, _ in epochs)
                  + f' s; {frames} frames trained: '
                  f'{frames / max(ep_wall, 1e-9):.1f} trained frames/s over '
                  f'the epochs; step_s a step '
                  f'{sum(t["step_s"] for _, _, t in epochs) / steps:.3f} s; '
                  f'validation and test passes '
                  + ', '.join(f'{w:.3f}' for _, w, _ in tm.calls['inference'])
                  + ' s; best-model writes '
                  + ', '.join(f'{w:.3f}' for _, w, _ in
                              tm.calls['best_model'])
                  + f' s; peak device memory {peak:.2f} GiB')
            print('    epochs by phase (s): ' + '; '.join(
                ', '.join(f'{k} {v:.3f}' for k, v in t.items())
                for _, _, t in epochs))
            train_shapes, eval_shapes = set(rec.model_train), set(rec.model)
            if label == 'LFAN fp32':
                os.remove(os.path.join(outd, 'passed.txt'))
                continue
            if label == 'LFAN fp32 resumed':
                with open(os.path.join(outd, 'log.txt')) as f:
                    if f'restored checkpoint from epoch {LOGMEL_EPOCHS - 2}' \
                            not in f.read():
                        fail('the resumed LFAN did not restore its '
                             'checkpoint')

            # the best model carries the VGGish in fvt_tpu's tree and reads
            # back exactly: loaded into a fresh model, written again
            best = os.path.join(outd, 'best-models', 'None', 'model.msgpack')
            params, _ = read_flax_variables(best)
            if sorted(params.get('spatial_audio', {})) != sorted(
                    [f'conv{i}' for i in range(6)] + ['fc0', 'fc1', 'fc2']):
                fail(f'{label}: the best model lacks the VGGish subtree')
            args = to_namespace(load_yaml(os.path.join(outd, 'config.yml')))
            fresh = init_model(args)
            load_best_model(fresh, best, modality)
            again = os.path.join(root, 'again.msgpack')
            save_best_model(fresh, again, modality)
            with open(best, 'rb') as f, open(again, 'rb') as g:
                same = f.read() == g.read()
            print(f'    best model ({os.path.getsize(best) / 2 ** 20:.1f} '
                  f'MiB) read back: written again '
                  f'{"byte-equal" if same else "DIFFERENT"}')
            if not same:
                fail(f'{label}: the best model did not read back exactly')
            del params

            # served through the challenge CLI from that best model
            evald = os.path.join(root, f'eval_{label.replace(" ", "_")}')
            zero()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with ShapeRecorder() as crec, MethodTimer(timer_methods) as ctm:
                t0 = time.perf_counter()
                cexp = inference_challenge.main(
                    ['--mode', 'EVALUATION', '--fd_exp', outd,
                     '--case_best_model', 'None', '--target_ds_name',
                     'C-EXPR-DB-CHALLENGE', '--dataset_path',
                     chal['dataset_path'], '--folds_dir', chal['folds_dir'],
                     '--outd', evald], device=device)
                cwall = time.perf_counter() - t0
            launches = read()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            forwards = len(crec.model)
            want = {k: 0 for k in launches}
            want.update(tcn_block=n_blocks * forwards,
                        fusion=forwards if name == 'LFAN' else 0)
            chunk = cexp.trainer.model.eval_frames
            print(f'    challenge CLI: {forwards} forwards at '
                  f'{sorted(set(crec.model))}; launches {launches}; the '
                  f'VGGish\'s calls at most {max(crec.audio)} patches '
                  f'(chunk {chunk})')
            if forwards < 1 or launches != want:
                fail(f'{label}: expected {n_blocks} B1 launches a forward '
                     f'{"and one B2 " if name == "LFAN" else ""}and no other'
                     f' kernel in the challenge pass, got {launches}')
            if max(crec.audio) > chunk:
                fail(f'{label}: the eval VGGish took {max(crec.audio)} '
                     f'patches at once, above {chunk}')
            total['tcn_block'] += launches['tcn_block']
            total['fusion'] += launches['fusion']
            pass_wall = ctm.calls['inference'][0][1]
            frames = sum(CHALLENGE_LENGTHS)
            print(f'    CLI wall {cwall:.3f} s, the pass {pass_wall:.3f} s: '
                  f'{frames / pass_wall:.1f} served frames/s; peak device '
                  f'memory {peak:.2f} GiB; last_inference_timing '
                  f'{json.dumps(cexp.trainer.last_inference_timing)}')
            eval_shapes |= set(crec.model)
            with open(os.path.join(evald, 'pred-C-EXPR-DB-CHALLENGE',
                                   'prediction.pkl'), 'rb') as f:
                pred = pickle.load(f)
            with open(os.path.join(chal['dataset_path'],
                                   'mean_std_info_fold-0.pkl'), 'rb') as f:
                mean_std = pickle.load(f)
            fresh = fresh.to(device)
            if name == 'LFAN':
                offline = challenge_reference(fresh, chal, mean_std, device,
                                              modality)
            else:
                offline = family_reference(fresh, chal, mean_std, modality,
                                           int(args.eval_bucket_quantum),
                                           device)
            if list(pred) != list(offline):
                fail(f'{label}: prediction.pkl covers {list(pred)}, the '
                     f'store {list(offline)}')
            worst = 0.0
            for vid, want_v in offline.items():
                got = pred[vid]['logits']
                if got.shape != want_v.shape or not np.isfinite(got).all():
                    fail(f'{label} {vid}: logits {got.shape}, want '
                         f'{want_v.shape}, finite={np.isfinite(got).all()}')
                worst = max(worst, float(np.abs(got - want_v).max()
                                         / max(np.abs(want_v).max(), 1e-30)))
            print(f'    every video\'s logits within {worst:.3e} of the '
                  f'offline plain composition, relative to their largest '
                  f'magnitude (gate {FAMILY_RTOL})')
            if worst > FAMILY_RTOL:
                fail(f'{label}: served logits differ from the offline plain '
                     f'composition by {worst} relative')
            if name == 'CAN':
                eval_shapes.add(full_bucket(
                    cexp.trainer, int(args.eval_video_batch), device,
                    FAMILY_BUCKET_LENGTH, modality))

            # the kernels at every shape the runs gave them
            print(f'    (B, T) trained: {sorted(train_shapes)}; eval: '
                  f'{sorted(eval_shapes, key=lambda bt: (bt[1], bt[0]))}')
            check_at_shapes(model, sorted(eval_shapes,
                                          key=lambda bt: (bt[1], bt[0])),
                            device, modality=modality)
            blocks = model_blocks(model, modality)
            for b, t in sorted(train_shapes | {(TRAIN_BATCH, WINDOW)}):
                err = check_train_at_shape(b, t, device, blocks=blocks)
                print(f'    B3a and B3b at the {len(blocks)} blocks at '
                      f'({b},{t}): max error {err:.3e}')
            time_logmel_step(exp.trainer, device, label)
            del exp, cexp, model, fresh
            torch.cuda.empty_cache()
    return total


def regression_trials(n: int, seed: int) -> dict:
    """Phase 11's synthetic valence trials: {name: (vggish (L, 128),
    bert (L, 768), label (L,))}, lengths in REG_TRIAL_LENGTHS, the label
    a smooth function of the vggish stream in (-1, 1)."""
    rng = np.random.default_rng(seed)
    lo, hi = REG_TRIAL_LENGTHS
    trials = {}
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        vggish = rng.standard_normal((length, 128), np.float32)
        bert = rng.standard_normal((length, 768), np.float32)
        trials[f's{seed}t{i}'] = (vggish, bert, np.tanh(
            4 * vggish[:, :16].mean(1)).astype(np.float32))
    return trials


def regression_loader(trials: dict, batch: int):
    """The regression trainer's batches: (X, trials, lengths, indices) of
    ``batch`` windows of WINDOW frames at HOP, each trial's last window
    ending on its last frame, so every frame is covered."""
    rows = []
    for name, (vggish, bert, label) in trials.items():
        n = len(label)
        starts = list(range(0, n - WINDOW + 1, HOP))
        if starts[-1] != n - WINDOW:
            starts.append(n - WINDOW)
        rows += [(name, n, np.arange(s, s + WINDOW)) for s in starts]
    for i in range(0, len(rows), batch):
        chunk = rows[i:i + batch]
        yield ({'vggish': np.stack([trials[r[0]][0][r[2]] for r in chunk]),
                'bert': np.stack([trials[r[0]][1][r[2]] for r in chunk]),
                'VA_continuous_label': np.stack([trials[r[0]][2][r[2]]
                                                 for r in chunk])},
               [r[0] for r in chunk], [r[1] for r in chunk],
               np.stack([r[2] for r in chunk]))


def regression_training(device) -> dict:
    """Phase 11.  Returns the launches of B1, B2, B3a and B3b over the
    uninterrupted fit, its test pass and its predict pass."""
    import csv
    import importlib.util
    import os
    import tempfile
    from types import SimpleNamespace
    from fvt_tpu_torch.config.defaults import get_config
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.train.param_control import ParamControl
    from fvt_tpu_torch.train.regression_trainer import RegressionTrainer

    train, valid, test = (regression_trials(n, SEED + 20 + i)
                          for i, n in enumerate(REG_TRIALS))
    plots = importlib.util.find_spec('matplotlib') is not None
    print(f'  trials: {len(train)} train '
          f'({sum(len(v[2]) for v in train.values())} frames), '
          f'{len(valid)} valid, {len(test)} test; matplotlib '
          f'{"present: plots on" if plots else "absent: no plots"}')
    zero, read = run_counters()

    def make(outd, epochs):
        cfg = dict(get_config('MELD'))
        cfg.update(num_epochs=epochs, min_num_epochs=1, early_stopping=0,
                   seed=SEED, outd=outd, milestone=(REG_MILESTONE,),
                   save_plot=plots, load_best_at_each_epoch=False)
        model = LFAN(TRAIN_MODALITY, 1, task='REGRESSION',
                     generator=torch.Generator().manual_seed(SEED))
        control = ParamControl([[r'temporal']], release_count=1,
                               base_patterns=[r'fusion', r'regressor',
                                              r'bn_'])
        tr = RegressionTrainer(model, SimpleNamespace(**cfg),
                               param_control=control, device=device)
        tr.init_state(next(regression_loader(train, TRAIN_BATCH))[0])
        return tr

    def fit(tr, probe=None):
        walls = []

        def train_fn(epoch):
            if probe is not None:
                probe(epoch)
            return regression_loader(train, TRAIN_BATCH)

        loop = tr.loop

        def timed(loader, epoch, train_mode):
            t0 = time.perf_counter()
            out = loop(loader, epoch, train_mode)
            walls.append((epoch, train_mode, time.perf_counter() - t0))
            return out

        tr.loop = timed
        try:
            best = tr.fit(train_fn,
                          lambda: regression_loader(valid, WINDOW_BATCH))
        finally:
            del tr.loop
        return best, walls

    with tempfile.TemporaryDirectory() as root:
        a = make(os.path.join(root, 'a'), REG_EPOCHS)
        temporal = {k: v.detach().clone()
                    for k, v in a.model.named_parameters()
                    if k.startswith('temporal.')}
        unmoved = {}

        def probe(epoch):
            # at REG_MILESTONE the release has just fired, after epochs
            # with the TCNs frozen; one epoch later they have trained
            if epoch in (REG_MILESTONE, REG_MILESTONE + 1):
                unmoved[epoch] = all(
                    torch.equal(v, temporal[k])
                    for k, v in a.model.named_parameters() if k in temporal)

        zero()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with ShapeRecorder() as rec:
            t0 = time.perf_counter()
            best, walls = fit(a, probe)
            wall = time.perf_counter() - t0
            fit_launches = read()
            t0 = time.perf_counter()
            test_loss, test_perf, _ = a.test(
                lambda: regression_loader(test, WINDOW_BATCH))
            written = a.predict(lambda: regression_loader(test, WINDOW_BATCH),
                                'test')
            test_wall = time.perf_counter() - t0
        launches = read()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps, forwards = len(rec.fusion_train), len(rec.fusion)
        n_blocks = sum(len(a.model.temporal[m].network)
                       for m in TRAIN_MODALITY)
        want = {k: 0 for k in launches}
        want.update(tcn_block=n_blocks * forwards, fusion=forwards,
                    tcn_block_train=n_blocks * steps,
                    tcn_block_bwd=n_blocks * steps)
        print(f'  fit, test and predict: {steps} steps, {forwards} eval '
              f'forwards; launches {launches} (the fit alone '
              f'{fit_launches})')
        if steps < 1 or forwards < 1 or launches != want:
            fail(f'regression: expected {n_blocks} B3a and {n_blocks} B3b '
                 f'calls a step, {n_blocks} B1 and one B2 launches a '
                 f'forward and no other kernel, got {launches}')
        print(f'  ParamControl: the TCNs unmoved at the start of epochs '
              f'{REG_MILESTONE} and {REG_MILESTONE + 1}: {unmoved}; '
              f'released {a.param_control.released}')
        if unmoved != {REG_MILESTONE: True, REG_MILESTONE + 1: False} \
                or a.param_control.released != 1:
            fail('regression: the ParamControl release did not freeze and '
                 'release the TCNs')
        train_frames = sum(b * t for b, t in rec.fusion_train)
        for epoch in range(REG_EPOCHS):
            tr_wall = sum(w for e, m, w in walls if e == epoch and m)
            va_wall = sum(w for e, m, w in walls if e == epoch and not m)
            print(f'  epoch {epoch}: train loop {tr_wall:.3f} s '
                  f'({train_frames / REG_EPOCHS / tr_wall:.1f} trained '
                  f'frames/s), validation loop {va_wall:.3f} s')
        print(f'  fit wall {wall:.3f} s; best epoch {best["epoch"]}, '
              f'validation CCC {best["ccc"]:.6f}; test and predict '
              f'{test_wall:.3f} s, test {json.dumps(test_perf)}, loss '
              f'{test_loss:.6f}; peak device memory {peak:.2f} GiB')
        if not all(np.isfinite([best['ccc'], test_loss,
                                *test_perf.values()])):
            fail('regression: non-finite metrics')

        # the artifacts
        outd = a.args.outd
        with open(os.path.join(outd, 'training_logs.csv')) as f:
            rows = list(csv.reader(f))
        txts = sorted(os.listdir(os.path.join(outd, 'predict', 'test',
                                              'valence')))
        expected = [os.path.join(outd, n) for n in (
            'model_state_dict.msgpack', 'checkpoint.pt', 'checkpoint.pkl',
            os.path.join('dict', 'valence', 'test.pkl'))]
        if len(rows) != REG_EPOCHS + 2 or rows[-1][0] != 'Test results:' \
                or txts != sorted(f'{t}.txt' for t in test) \
                or not all(os.path.isfile(p) for p in expected):
            fail(f'regression: artifacts missing: {len(rows)} CSV rows, '
                 f'txts {txts}')
        for trial, preds in written.items():
            with open(os.path.join(outd, 'predict', 'test', 'valence',
                                   f'{trial}.txt')) as f:
                lines = f.read().splitlines()
            if lines[0] != 'valence' or len(lines) != 1 + len(test[trial][2]) \
                    or not np.isfinite(preds).all():
                fail(f'regression: predict/{trial}.txt malformed')
        if plots and sorted(os.listdir(os.path.join(outd, 'plot', 'test'))) \
                != sorted(f'{t}.jpg' for t in test):
            fail('regression: the test plots are missing')
        print(f'  artifacts: training_logs.csv ({len(rows)} rows), '
              f'{len(txts)} predict txts, dict/valence pickles, '
              f'model_state_dict.msgpack, checkpoint.pt + checkpoint.pkl'
              + (', plots' if plots else ''))

        # stopped after the milestone epoch and resumed: bit for bit
        b = make(os.path.join(root, 'b'), REG_MILESTONE + 1)
        fit(b)
        b = make(os.path.join(root, 'b'), REG_EPOCHS)
        b.load_checkpoint()
        b.fit_finished = False
        best_b, _ = fit(b)
        same = (best_b['epoch'] == best['epoch']
                and best_b['ccc'] == best['ccc']
                and all(torch.equal(v.cpu(), b.model.state_dict()[k].cpu())
                        for k, v in a.model.state_dict().items()))
        with open(os.path.join(root, 'b', 'training_logs.csv')) as f:
            same = same and [r[1:] for r in list(csv.reader(f))[1:]] == \
                [r[1:] for r in rows[1:-1]]
        print(f'  stopped after epoch {REG_MILESTONE} and resumed from its '
              f'checkpoint: {"bit for bit" if same else "DIFFERENT"} '
              f'against the uninterrupted fit (state, best, CSV rows)')
        if not same:
            fail('regression: the resumed fit differs from the '
                 'uninterrupted one')

        # the kernels at every shape the fit gave them; a step timed
        check_at_shapes(a.model, sorted(set(rec.fusion),
                                        key=lambda bt: (bt[1], bt[0])),
                        device, modality=TRAIN_MODALITY)
        blocks = model_blocks(a.model, TRAIN_MODALITY)
        for bt in sorted(set(rec.fusion_train) | {(TRAIN_BATCH, WINDOW)}):
            err = check_train_at_shape(*bt, device, blocks=blocks)
            print(f'  B3a and B3b at the {len(blocks)} blocks at {bt}: max '
                  f'error {err:.3e}')
        batch = next(regression_loader(train, TRAIN_BATCH))[0]
        calls = iter(range(10 ** 6))
        ms = median_ms(lambda: a.train_step(batch, torch.Generator(
            device=device).manual_seed(next(calls))), runs=FAMILY_STEP_RUNS,
            warmup=1)
        print(f'  a regression step at ({TRAIN_BATCH},{WINDOW}) {ms:.2f} ms '
              f'(median of {FAMILY_STEP_RUNS}, CUDA events, the upload '
              f'included)')
        del a, b
    torch.cuda.empty_cache()
    return launches


def draw_statistics(model, seed: int) -> None:
    """The BatchNorms' running statistics drawn from ``seed`` (init leaves
    them at 0 and 1, which would hide a statistic read from the wrong
    place)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(torch.from_numpy(rng.normal(
                    0, 0.1, buf.shape).astype(np.float32)))
            elif name.endswith('running_var'):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, buf.shape).astype(np.float32)))


def window_stitch(call, frames: dict, needs_mask: bool) -> np.ndarray:
    """The offline stitch of one stream through ``call(batch, length)``:
    its windows in batches of WINDOW_BATCH, the last repeat-padded, as a
    stream's own batcher groups them (the grouping matters to JMT, whose
    final attention mixes a batch's rows); a stream shorter than the
    window is the first rows of its pad-by-repeat window."""
    from fvt_tpu_torch.data import windowing as W

    n = len(next(iter(frames.values())))
    if n < WINDOW:
        idx = W.pad_short_window_indices(n, WINDOW)[None]
    else:
        idx = W.window_index_matrix(n, WINDOW, HOP)
    outs = []
    for s in range(0, len(idx), WINDOW_BATCH):
        rows = list(idx[s:s + WINDOW_BATCH])
        rows += [rows[-1]] * (WINDOW_BATCH - len(rows))
        length = (np.full(WINDOW_BATCH, min(n, WINDOW), np.int32)
                  if needs_mask else None)
        outs.append(call({k: v[np.stack(rows)] for k, v in frames.items()},
                         length)[:len(idx) - s])
    logits = np.concatenate(outs)
    return logits[0, :n] if n < WINDOW else W.stitch_windows_np(
        logits, idx, n)


def relative_error(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f'got {got.shape} logits, want {want.shape}, finite='
             f'{np.isfinite(got).all()}')
    return float(np.abs(got - want).max() / np.abs(want).max())


def serve_artifact(name: str, modality, root: str, streams: dict,
                   device, zero, read) -> dict:
    """Phase 12, one family: its run directory's best model exported at
    (WINDOW_BATCH, WINDOW), loaded, served over HTTP; the served logits
    against the artifact's in-process offline stitch (ARTIFACT_RTOL) and
    the plain composition (FAMILY_RTOL, relative to the largest logit).
    Returns the launches over the HTTP traffic."""
    import os
    import threading
    from fvt_tpu_torch.client import ServingClient
    from fvt_tpu_torch.config import flat_yaml
    from fvt_tpu_torch.config.defaults import get_config, to_namespace
    from fvt_tpu_torch.export import load_artifact
    from fvt_tpu_torch.models.checkpoint import save_best_model
    from fvt_tpu_torch.models.registry import init_model
    from fvt_tpu_torch.serve import serving_forward, valid_frames
    from fvt_tpu_torch.tools import export_serving, serve_http

    cfg = get_config('MELD')
    cfg.update(model_name=name, seed=SEED, window_length=WINDOW,
               hop_length=HOP, eval_window_batch=WINDOW_BATCH,
               modality=f'{"+".join(modality)}+EXPR_continuous_label',
               verbose=False)
    run = os.path.join(root, name)
    os.makedirs(os.path.join(run, 'best-models', 'case'))
    flat_yaml.dump(cfg, os.path.join(run, 'config.yml'))
    model = init_model(to_namespace(cfg))
    draw_statistics(model, SEED + 30)
    save_best_model(model, os.path.join(run, 'best-models', 'case',
                                        'model.msgpack'), model.modality)
    del model
    t0 = time.perf_counter()
    path = export_serving.main(['--fd_exp', run, '--window_batch',
                                str(WINDOW_BATCH), '--seq_len',
                                str(WINDOW)])['artifact']
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = load_artifact(path, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    print(f'  {name}: artifact {os.path.getsize(path)} bytes, written in '
          f'{write_s:.3f} s, loaded onto the card in {load_s:.3f} s')

    t0 = time.perf_counter()
    srv = serve_http.build_server(path, '127.0.0.1', 0, device=device,
                                  dynamic_batch=not art.needs_mask,
                                  batch_delay_s=0.05)
    start_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client = ServingClient(f'http://127.0.0.1:{srv.server_port}',
                           timeout=300)
    spec = art.meta['shapes'][f'b{WINDOW_BATCH}xt{WINDOW}']['inputs']
    rng = np.random.default_rng(SEED + 31)
    batch = {k: (rng.integers(0, 256, v['shape'], np.uint8)
                 if v['dtype'] == 'uint8'
                 else rng.standard_normal(v['shape'], np.float32))
             for k, v in spec.items()}
    length = (np.array([WINDOW] * (WINDOW_BATCH - 2) + [250, 120],
                       np.int32) if art.needs_mask else None)
    frames = {n: {k: v for k, v in s.items() if k in spec}
              for n, s in streams.items()}

    zero()
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        served = client.logits(batch, length=length)
        for _ in range(ARTIFACT_LOGITS_CALLS - 1):
            client.logits(batch, length=length)
        logits_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        handles = {n: client.open_stream() for n in frames}
        for c0 in range(0, max(frames), CHUNK):
            for n, f in frames.items():
                if c0 < n:
                    handles[n].feed({k: v[c0:c0 + CHUNK]
                                     for k, v in f.items()})
        for h in handles.values():
            h.finish()
        got = {n: h.result(timeout_s=300) for n, h in handles.items()}
        stream_s = time.perf_counter() - t0
        health = client.healthz()
    launches = read()
    forwards = len(rec.model)
    serve_http.drain_and_shutdown(srv, timeout_s=5)
    thread.join(timeout=10)
    if thread.is_alive():
        fail(f'{name}: the server thread did not stop')

    model = art.model
    fused = getattr(model, 'FUSED', None) if art.needs_mask else None
    per_forward = sum(len(model.temporal[m].network)
                      for m in (fused or model.modality))
    want = {k: 0 for k in launches}
    want['tcn_block'] = per_forward * forwards
    want['fusion'] = forwards if name == 'LFAN' else 0
    print(f'  {name}: {forwards} forwards over HTTP ({ARTIFACT_LOGITS_CALLS} '
          f'/logits, the streams\' dispatches), launches '
          f'{ {k: n for k, n in launches.items() if n} } and none else')
    if forwards < ARTIFACT_LOGITS_CALLS + 1 or launches != want:
        fail(f'{name}: expected {want} over {forwards} forwards, got '
             f'{launches}')
    lat = health['latency']['/logits']
    frames_per_call = WINDOW_BATCH * WINDOW
    body = sum(a.nbytes for a in batch.values())
    batching = ('a batcher each, with lengths' if art.needs_mask
                else 'dynamic batching')
    print(f'  {name}: server start (load + warm-up) {start_s:.3f} s; '
          f'/logits (a {body} B body) p50 {lat["p50_ms"]} ms, p99 '
          f'{lat["p99_ms"]} ms over {lat["count"]} (/healthz), '
          f'{frames_per_call / lat["p50_ms"] * 1e3:.1f} frames/s at p50; '
          f'{ARTIFACT_LOGITS_CALLS} in {logits_s:.3f} s; three streams '
          f'({sum(frames)} frames in chunks of {CHUNK}, {batching}) in '
          f'{stream_s:.3f} s, {sum(frames) / stream_s:.1f} frames/s; '
          f'stream dispatches {health["stream_dispatches"]}')

    def in_process(b, n):
        return art.call(b, length=n)

    def plain(b, n):
        x = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        mask = (valid_frames(n, WINDOW, device) if art.needs_mask
                else None)
        return serving_forward(model, x, time_mask=mask,
                               reference=True).cpu().numpy()

    call_ms = []
    for _ in range(ARTIFACT_LOGITS_CALLS):
        t0 = time.perf_counter()
        want_logits = art.call(batch, length=length)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    call_ms = statistics.median(call_ms)
    print(f'  {name}: ServingModel.call in process, median of '
          f'{ARTIFACT_LOGITS_CALLS}: {call_ms:.2f} ms, '
          f'{frames_per_call / call_ms * 1e3:.1f} frames/s')
    errs = [relative_error(served, want_logits)]
    ref_errs = [relative_error(served, plain(batch, length))]
    for n, f in frames.items():
        errs.append(relative_error(got[n], window_stitch(
            in_process, f, art.needs_mask)))
        ref_errs.append(relative_error(got[n], window_stitch(
            plain, f, art.needs_mask)))
    print(f'  {name}: served /logits and streams vs the in-process offline '
          f'stitch: max relative error {max(errs):.3e} (gate '
          f'{ARTIFACT_RTOL}); vs the plain composition {max(ref_errs):.3e} '
          f'(gate {FAMILY_RTOL})')
    if max(errs) > ARTIFACT_RTOL or max(ref_errs) > FAMILY_RTOL:
        fail(f'{name}: served logits differ from the in-process stitch by '
             f'{max(errs)} or from the plain composition by '
             f'{max(ref_errs)} (relative)')
    del art, model
    return launches


def attention_tcn(device) -> dict:
    """Phase 12, the TCN with ``attention=1`` at the LFAN's vggish widths
    at T = max_length = WINDOW, batch WINDOW_BATCH: eval through B1 block
    by block against its plain version, then one train step through B3a
    and B3b against autograd of the plain version.  Returns the launches
    of each."""
    from fvt_tpu_torch.models.tcn import TemporalConvNet
    from fvt_tpu_torch.ops import tcn as tcn_ops
    from fvt_tpu_torch.ops.tcn import (fused_temporal_block,
                                       fused_temporal_block_train)

    cin, channels, k = ATTN_TCN
    tcn = TemporalConvNet(cin, channels, k, dropout=0.0, attention=1,
                          max_length=WINDOW)
    tcn.reset_parameters(torch.Generator().manual_seed(SEED + 32))
    tcn.to(device)
    g = torch.Generator(device=device).manual_seed(SEED + 33)
    x = torch.randn(WINDOW_BATCH, WINDOW, cin, device=device, generator=g)
    fused_temporal_block.launches = 0
    with torch.inference_mode():
        got = tcn(x)
        n_eval = fused_temporal_block.launches
        want = tcn(x, reference=True)
    compare(f'TemporalConvNet(attention=1) eval {cin}->{list(channels)} '
            f'K={k} at ({WINDOW_BATCH},{WINDOW})', got, want)

    # the train step at the model's own parameters: first through
    # TemporalConvNet.forward, for its launches and its loss (continuous
    # at leaky's kink); then its gradients, through the same blocks and
    # attention as forward runs them, with each block's masks (ones at
    # dropout 0) and residual changed by away_from_kink where the plain
    # version's pre-activation lies near the kink, where the kernel and
    # the plain version may round to different sides and take different
    # slopes
    r = torch.randn(WINDOW_BATCH, WINDOW, channels[-1], device=device,
                    generator=g)
    params = [p for _, p in tcn.named_parameters()]
    names = [n for n, _ in tcn.named_parameters()]
    fused_temporal_block_train.launches_fwd = 0
    fused_temporal_block_train.launches_bwd = 0
    loss = (tcn(x, True, g) * r).mean()
    torch.autograd.grad(loss, params)
    n_train = (fused_temporal_block_train.launches_fwd,
               fused_temporal_block_train.launches_bwd)
    want_loss = (tcn(x, True, g, reference=True) * r).mean()
    loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())

    def block(blk, h, kink, reference: bool) -> torch.Tensor:
        w = blk.kernel_weights()
        res = h if w['wd'] is None else h @ w['wd'] + w['bd']
        if kink is None:  # (m1, m2, the residual's shift) drawn here
            ones = torch.ones(res.shape, device=res.device)
            m1, m2, moved = away_from_kink(h, w['w1'], w['b1'], w['w2'],
                                           w['b2'], ones, ones, res,
                                           blk.dilation)
            # contiguous, as the kernel takes them: res may be a view of
            # the attention's transposed output
            kinks.append(tuple(t.contiguous() for t in
                               (m1, m2, moved - res)))
            kink = kinks[-1]
        fn = (tcn_ops.fused_temporal_block_train_ref if reference
              else fused_temporal_block_train)
        return fn(h, w['w1'], w['b1'], w['w2'], w['b2'], kink[0], kink[1],
                  res + kink[2], kernel_size=k, dilation=blk.dilation)

    kinks = []
    with torch.no_grad():
        h = x
        for i, blk in enumerate(tcn.network):
            h = tcn._attend(i, block(blk, h, None, True))
    cleared = sum(int((t != (1 if j < 2 else 0)).sum())
                  for kink in kinks for j, t in enumerate(kink))

    def step_grads(reference: bool) -> tuple:
        h = x
        for i, blk in enumerate(tcn.network):
            h = tcn._attend(i, block(blk, h, kinks[i], reference))
        return torch.autograd.grad((h * r).mean(), params)

    grads, want_grads = step_grads(False), step_grads(True)
    largest = max(w.abs().max().item() for w in want_grads)
    worst = 0.0
    for name, got_g, want_g in zip(names, grads, want_grads):
        scale = want_g.abs().max().item()
        # a query bias adds one logit to every query of a key and the
        # softmax runs over the queries: its gradient is zero, rounding
        # noise on both sides, held against the largest gradient
        if name.endswith('query_layer.bias'):
            if scale > 1e-6 * largest:
                fail(f'TemporalConvNet(attention=1) train: d{name} of the '
                     f'plain version is {scale}, not about 0 (largest '
                     f'gradient {largest})')
            scale = largest
        err = (got_g - want_g).abs().max().item()
        worst = max(worst, err / scale)
        if not torch.isfinite(got_g).all() or err > WGRAD_TOL * scale:
            fail(f'TemporalConvNet(attention=1) train: d{name} differs '
                 f'from the plain version by {err} (max|want| {scale})')
    print(f'  TemporalConvNet(attention=1) train step: loss relative error '
          f'{loss_err:.3e}, gradients within {worst:.3e} of their largest '
          f'value (gate {WGRAD_TOL}; {cleared} of '
          f'{sum(t.numel() for kink in kinks for t in kink)} pre-activations '
          f'moved off the kink); launches: B1 {n_eval} (eval), B3a '
          f'{n_train[0]}, B3b {n_train[1]}')
    if loss_err > KERNEL_RTOL or n_eval != len(channels) \
            or n_train != (len(channels), len(channels)):
        fail(f'TemporalConvNet(attention=1): loss error {loss_err}, '
             f'launches {n_eval}, {n_train}; expected '
             f'{len(channels)} each')
    return {'tcn_block': n_eval, 'tcn_block_train': n_train[0],
            'tcn_block_bwd': n_train[1]}


def artifact_serving(device) -> tuple:
    """Phase 12.  Returns (the launches of every kernel over the three
    families' HTTP traffic, those of the attention TCN)."""
    import tempfile

    zero, read = run_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streams = make_streams()
    total = None
    with tempfile.TemporaryDirectory() as root:
        for name, modality in ARTIFACT_FAMILIES:
            launches = serve_artifact(name, modality, root, streams, device,
                                      zero, read)
            total = launches if total is None else {
                k: total[k] + n for k, n in launches.items()}
            torch.cuda.empty_cache()
    attn = attention_tcn(device)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'  peak device memory {peak:.2f} GiB')
    return total, attn


# ---------------------------------------------------------------- phase 13
# the int8 convs of the IR-50 at N = 2400: (H, Cin, Cout, stride, convs of
# that shape a forward), 41 in all
INT8_SHAPES = ((40, 128, 128, 2, 1), (20, 128, 128, 1, 6),
               (20, 128, 256, 1, 1), (20, 256, 256, 2, 1),
               (10, 256, 256, 1, 26), (10, 256, 512, 1, 1),
               (10, 512, 512, 2, 1), (5, 512, 512, 1, 4))
INT8_FRAMES = 2400
# (N, H, W, Cin, Cout, stride) the kernels take at their edges: odd sizes,
# a partial channel slice (C = 80), few output channels (Co = 24), a pixel
# count no multiple of the 128-pixel tile
INT8_EDGE_SHAPES = ((3, 7, 9, 80, 24, 2), (3, 7, 9, 80, 24, 1),
                    (1, 5, 5, 16, 8, 2), (5, 11, 3, 128, 136, 1))
# the dense int8 tensor-core peak of one H100 SXM
PEAK_OPS_INT8 = 1979e12
# served int8 logits vs the plain composition, relative to the largest
INT8_RTOL = 1e-4
# a bfloat16-feature artifact over HTTP vs its in-process stitch
BF16_FEATURES_RTOL = 1e-6


def int8_inputs(n, h, w, c, co, dtype, device, seed):
    """x (N, H, W, C) in ``dtype`` and a float32 HWIO kernel, drawn on the
    card from ``seed``; one value of x scaled up, as a post-PReLU tail."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, h, w, c, device=device, generator=g)
    x.view(-1)[7] = 9.0
    k = torch.randn(3, 3, c, co, device=device, generator=g) * (9 * c) ** -0.5
    return x.to(dtype), k


def check_int8_pair(name, x, k, stride, out_dtype, static, timed):
    """The quantise kernel and the s8 conv against their plain versions on
    x, bit for bit (q, the scale, the amax, y), dynamic or with a
    calibrated scale.  Returns the largest |y - plain| (0), the largest
    |q - plain q| (0, an int) and, with ``timed``, the ms of the quantise
    kernel, the conv kernel and their plain versions (median of CONV_RUNS
    calls)."""
    from fvt_tpu_torch.ops import quant

    wq, wscale = quant.quantize_weights(k)
    scale_in = None
    if static:
        # a calibrated amax below the batch's own: the tail clips at 127
        scale_in = quant.act_scale(x.float().abs().amax().reshape(1) * 0.9)
    q, scale, amax = quant.quantize_int8(x, scale_in)
    q_ref, scale_ref, amax_ref = quant.quantize_int8_ref(x, scale_in)
    y = quant.conv3x3_s8(q, scale, wq, wscale, stride, out_dtype)
    y_ref = quant.conv3x3_s8_ref(q_ref, scale_ref, wq, wscale, stride,
                                 out_dtype)
    torch.cuda.synchronize()
    same = (torch.equal(q, q_ref)
            and torch.equal(scale.reshape(1), scale_ref.reshape(1))
            and (amax is None) == (amax_ref is None)
            and (amax is None or torch.equal(amax.reshape(1),
                                             amax_ref.reshape(1))))
    equal = torch.equal(y, y_ref)
    err = float((y.float() - y_ref.float()).abs().max())
    q_err = int((q.int() - q_ref.int()).abs().max())
    clipped = int((q_ref.abs() == 127).sum())
    if not same or not equal or not bool(torch.isfinite(y).all()):
        fail(f'{name}: the int8 kernels differ from their plain versions '
             f'(q, scale and amax equal: {same}, y equal: {equal}, max '
             f'|y - plain| {err:.3e}, max |q - plain| {q_err})')
    if not timed:
        print(f'  {name}: q, scale and y bit for bit ({clipped} values '
              f'at +-127)')
        return err, q_err, None
    times = (
        median_ms(lambda: quant.quantize_int8(x, scale_in), CONV_RUNS),
        median_ms(lambda: quant.conv3x3_s8(q, scale, wq, wscale, stride,
                                           out_dtype), CONV_RUNS),
        median_ms(lambda: quant.quantize_int8_ref(x, scale_in), 3,
                  warmup=1),
        median_ms(lambda: quant.conv3x3_s8_ref(q_ref, scale_ref, wq, wscale,
                                               stride, out_dtype), 3,
                  warmup=1))
    print(f'  {name}: q, scale and y bit for bit ({clipped} values at '
          f'+-127); quantise {times[0]:.4f} ms (plain {times[2]:.4f}), s8 '
          f'conv {times[1]:.4f} ms (plain {times[3]:.4f})')
    return err, q_err, times


def int_mm_ms(x, k, stride):
    """``torch._int_mm`` over the im2col of the quantised x (``tap_rows``,
    not timed) by the (9C, Co) s8 weights: the library's int8 product as
    a yardstick, or None where it refuses the shape."""
    from fvt_tpu_torch.ops import quant

    wq, _ = quant.quantize_weights(k)
    a = quant.tap_rows(quant.quantize_int8(x)[0], stride)
    a = a.reshape(a.shape[0], -1)
    b = wq.reshape(wq.shape[0], -1).t()
    try:
        ms = median_ms(lambda: torch._int_mm(a, b), CONV_RUNS)
    except RuntimeError as e:
        print(f'    torch._int_mm refused {tuple(a.shape)} x '
              f'{tuple(b.shape)}: {e}')
        ms = None
    del a
    return ms


def check_int8_kernels(device) -> list:
    """Phase 13, step 1: the quantise kernel and the s8 conv against their
    plain versions, bit for bit, at the eight int8 shapes of the IR-50 at
    N = 2400 (float32 in and out, and bfloat16 in and out as under --amp;
    dynamic and static) and at edge shapes, and the conv's refusals; each
    dynamic pair timed beside ``F.conv2d`` on bfloat16 and
    ``torch._int_mm`` over an im2col.  Returns the two kernels' entries:
    totals over the 41 convs of a forward, bfloat16 as under --amp (the
    float32 totals beside them)."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import quant

    tot = {f'{key}{dt}': 0.0 for key in ('quant', 'conv', 'quant_plain',
                                         'conv_plain', 'conv2d')
           for dt in ('', '_bf16')}
    tot.update(int_mm=0.0, ops=0.0, conv_bytes=0.0, quant_bytes=0.0)
    int_mm_ok, worst, worst_q = True, 0.0, 0
    with torch.inference_mode():
        for h, c, co, stride, count in INT8_SHAPES:
            ho = quant.out_size(h, stride)
            for dtype in (torch.float32, torch.bfloat16):
                x, k = int8_inputs(INT8_FRAMES, h, h, c, co, dtype, device,
                                   SEED + 40 + h + c)
                tag = (f'{INT8_FRAMES}x{h}x{h}x{c}->{co} s{stride} '
                       f'{str(dtype)[6:]}')
                err, q_err, _ = check_int8_pair(
                    f'int8 {tag} static', x, k, stride, dtype, True, False)
                worst, worst_q = max(worst, err), max(worst_q, q_err)
                err, q_err, times = check_int8_pair(
                    f'int8 {tag} dynamic', x, k, stride, dtype, False, True)
                worst, worst_q = max(worst, err), max(worst_q, q_err)
                dt = '' if dtype == torch.float32 else '_bf16'
                for key, ms in zip(('quant', 'conv', 'quant_plain',
                                    'conv_plain'), times):
                    tot[key + dt] += count * ms
                w = k.to(dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                x_cl = x.permute(0, 3, 1, 2)
                lib = median_ms(lambda: F.conv2d(x_cl, w, None, stride, 1),
                                CONV_RUNS)
                tot['conv2d' + dt] += count * lib
                line = f'    F.conv2d {str(dtype)[6:]} {lib:.4f} ms'
                if dtype == torch.bfloat16:
                    mm = int_mm_ms(x, k, stride)
                    int_mm_ok &= mm is not None
                    tot['int_mm'] += count * (mm or 0.0)
                    line += f'; torch._int_mm over the im2col {mm} ms'
                    m = INT8_FRAMES * ho * ho
                    tot['ops'] += count * quant.s8_conv_ops(
                        INT8_FRAMES, h, h, c, co, stride)
                    # the s8 conv reads q and wq once and writes y (bf16);
                    # the quantise pass reads x (bf16) and writes q
                    tot['conv_bytes'] += count * (INT8_FRAMES * h * h * c
                                                  + 9 * c * co + 2 * m * co)
                    tot['quant_bytes'] += count * 3 * INT8_FRAMES * h * h * c
                print(line)
                del x, k, w, x_cl
                torch.cuda.empty_cache()
        for n, h, w, c, co, stride in INT8_EDGE_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                x, k = int8_inputs(n, h, w, c, co, dtype, device, SEED + 50)
                for out_dtype in (torch.float32, torch.bfloat16):
                    for static in (False, True):
                        err, q_err, _ = check_int8_pair(
                            f'int8 edge {n}x{h}x{w}x{c}->{co} s{stride} '
                            f'{str(dtype)[6:]} in, {str(out_dtype)[6:]} out'
                            f'{" static" if static else ""}', x, k, stride,
                            out_dtype, static, False)
                        worst = max(worst, err)
                        worst_q = max(worst_q, q_err)
        # refused: C not a multiple of 16, Co of 8, stride 3; the C entry
        # refuses them too, and nothing counts a launch
        before = quant.conv3x3_s8.launches
        for c, co, stride in ((24, 16, 1), (32, 12, 1), (32, 16, 3)):
            xq = torch.zeros(2, 5, 5, c, dtype=torch.int8, device=device)
            wq = torch.zeros(co, 9, c, dtype=torch.int8, device=device)
            ws = torch.ones(co, device=device)
            one = torch.ones(1, device=device)
            try:
                quant.conv3x3_s8(xq, one, wq, ws, stride)
            except ValueError as e:
                print(f'  conv3x3_s8 C={c} Co={co} stride {stride} '
                      f'refused: {e}')
            else:
                fail(f'conv3x3_s8 took C={c}, Co={co}, stride {stride}')
            code = build.library().fvt_conv3x3_s8_forward(
                xq.data_ptr(), wq.data_ptr(), ws.data_ptr(), one.data_ptr(),
                torch.empty(2, 5, 5, co, device=device).data_ptr(), 0, 2, 5,
                5, c, co, stride,
                torch.cuda.current_stream(device).cuda_stream)
            if code == 0:
                fail(f'the s8 conv entry took C={c}, Co={co}, stride '
                     f'{stride}')
        if quant.conv3x3_s8.launches != before:
            fail('a refused s8 conv counted a launch')
    ops_ms = tot['ops'] / PEAK_OPS_INT8 * 1e3
    conv_bytes_ms = tot['conv_bytes'] / PEAK_BYTES * 1e3
    quant_bytes_ms = tot['quant_bytes'] / PEAK_BYTES * 1e3
    conv_bound = max(ops_ms, conv_bytes_ms)
    print(f'  over the 41 int8 convs of a {INT8_FRAMES}-frame forward: '
          f'{tot["ops"] / 1e12:.3f} T int8 operations, {ops_ms:.4f} ms at '
          f'{PEAK_OPS_INT8 / 1e12:.0f} TOPS (their bytes '
          f'{conv_bytes_ms:.4f} ms at {PEAK_BYTES / 1e12} TB/s)')
    for dt, label in (('_bf16', 'bfloat16 (--amp)'), ('', 'float32')):
        print(f'  {label}: s8 conv {tot["conv" + dt]:.4f} ms '
              f'({conv_bound / tot["conv" + dt]:.1%} of its bound), plain '
              f'{tot["conv_plain" + dt]:.4f} ms, F.conv2d '
              f'{tot["conv2d" + dt]:.4f} ms; quantise '
              f'{tot["quant" + dt]:.4f} ms, plain '
              f'{tot["quant_plain" + dt]:.4f} ms')
    print(f'  torch._int_mm over the im2col (bf16 shapes, im2col not '
          f'timed): {tot["int_mm"]:.4f} ms; quantise bytes bound (bf16) '
          f'{quant_bytes_ms:.4f} ms')
    return [{'name': 'conv3x3_int8', 'route': 'cuda',
             'source': 'fvt_tpu_torch/csrc/conv3x3_int8.cu',
             'replaces': 'fvt_tpu/ops/quant.py:102 (an XLA s8 convolution, '
                         'no Pallas kernel)',
             'max_abs_err': worst, 'ms': tot['conv_bf16'],
             'plain_ms': tot['conv_plain_bf16'],
             'library_ms': tot['conv2d_bf16'],
             'bound_ms': conv_bound,
             'bound_by': 'operations' if ops_ms >= conv_bytes_ms
             else 'bytes',
             'fp32_out': {'ms': tot['conv'], 'plain_ms': tot['conv_plain'],
                          'conv2d_fp32_ms': tot['conv2d']},
             'int_mm_im2col_ms': tot['int_mm'] if int_mm_ok else None},
            {'name': 'quantize_int8', 'route': 'cuda',
             'source': 'fvt_tpu_torch/csrc/conv3x3_int8.cu',
             'replaces': 'fvt_tpu/ops/quant.py:62 (XLA elementwise and '
                         'reduction, no Pallas kernel)',
             'max_abs_err': worst_q, 'ms': tot['quant_bf16'],
             'plain_ms': tot['quant_plain_bf16'], 'library_ms': None,
             'bound_ms': quant_bytes_ms, 'bound_by': 'bytes',
             'fp32_in': {'ms': tot['quant'],
                         'plain_ms': tot['quant_plain']}}]


def int8_counters() -> dict:
    from fvt_tpu_torch.ops import quant
    return {'conv3x3_int8': quant.conv3x3_s8,
            'quantize_int8': quant.quantize_int8}


def read_int8() -> dict:
    c = int8_counters()
    return {'conv3x3_int8': c['conv3x3_int8'].launches,
            'quantize_int8': c['quantize_int8'].launches,
            'quantize_int8_amax': c['quantize_int8'].launches_amax}


def zero_int8() -> None:
    c = int8_counters()
    c['conv3x3_int8'].launches = 0
    c['quantize_int8'].launches = c['quantize_int8'].launches_amax = 0


def int8_backbone(device) -> None:
    """Phase 13, step 2: the int8 ArcFace alone on INT8_FRAMES frames,
    dynamic and static, float32 and bfloat16 (--amp), beside cuDNN in the
    same type: bit for bit its plain versions (the int8 convs' kernels
    equal theirs, every other op is the same call), static on its own
    calibration batch bit for bit dynamic, 41 s8 convs and 41 quantise
    launches a forward (41 amax launches dynamic, none static), the
    embeddings' cosine to the float32 cuDNN path's above 0.97 (fvt_tpu's
    criterion), the peak device memory a frame of a dynamic call within
    ``arcface.INT8_FRAME_BYTES``, ms per forward."""
    from fvt_tpu_torch.data.transforms import eval_video_transform
    from fvt_tpu_torch.models.arcface import INT8_FRAME_BYTES, VisualBackbone

    base = VisualBackbone()
    base.reset_parameters(torch.Generator().manual_seed(SEED))
    draw_statistics(base, SEED + 41)
    base.to(device)
    rng = np.random.default_rng(SEED + 42)
    video = torch.from_numpy(rng.integers(0, 256, (1, INT8_FRAMES, 40, 40, 3),
                                          np.uint8)).to(device)
    x = eval_video_transform(video)[0]
    times = {}
    with torch.inference_mode():
        ref = base(x)
        for dtype in (torch.float32, torch.bfloat16):
            label = str(dtype)[6:]
            cudnn = VisualBackbone(dtype=dtype)
            cudnn.load_state_dict(base.state_dict())
            cudnn.to(device)
            times[f'cudnn {label}'] = median_ms(lambda: cudnn(x), CONV_RUNS)
            del cudnn
            q = VisualBackbone(conv_impl='int8', dtype=dtype)
            q.load_state_dict(base.state_dict())
            q.to(device)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_int8()
            dyn = q(x)
            launches = read_int8()
            torch.cuda.synchronize()
            per_frame = (torch.cuda.max_memory_allocated() - before) \
                / INT8_FRAMES
            plain = q(x, reference=True)
            cos = float((dyn * ref).sum(1).min())
            print(f'  int8 {label} dynamic: launches {launches}; bit for bit '
                  f'its plain versions: {torch.equal(dyn, plain)}; least '
                  f'cosine to float32 cudnn {cos:.6f}; peak '
                  f'{per_frame / 2 ** 20:.3f} MiB a frame (bound '
                  f'{INT8_FRAME_BYTES[dtype] / 2 ** 20:.3f})')
            if launches != {'conv3x3_int8': 41, 'quantize_int8': 41,
                            'quantize_int8_amax': 41}:
                fail(f'int8 {label} dynamic: launches {launches}')
            if not torch.equal(dyn, plain) or cos <= 0.97:
                fail(f'int8 {label} dynamic: not its plain versions bit for '
                     f'bit, or cosine {cos} to float32')
            if per_frame > INT8_FRAME_BYTES[dtype]:
                fail(f'int8 {label}: a frame took {per_frame} bytes of '
                     f'device memory, above INT8_FRAME_BYTES '
                     f'{INT8_FRAME_BYTES[dtype]}')
            times[f'int8 {label}'] = median_ms(lambda: q(x), CONV_RUNS)
            q.begin_calibration()
            q(x)
            q.end_calibration()
            zero_int8()
            sta = q(x)
            launches = read_int8()
            if launches != {'conv3x3_int8': 41, 'quantize_int8': 41,
                            'quantize_int8_amax': 0} \
                    or not torch.equal(sta, dyn):
                fail(f'int8 {label} static on its calibration batch: '
                     f'launches {launches}, equal to dynamic '
                     f'{torch.equal(sta, dyn)}')
            times[f'int8_static {label}'] = median_ms(lambda: q(x),
                                                      CONV_RUNS)
            print(f'  int8_static {label}: on its calibration batch bit for '
                  f'bit dynamic; launches {launches}')
            del q, dyn, plain, sta
            torch.cuda.empty_cache()
    print(f'  ms per {INT8_FRAMES}-frame forward: ' + ', '.join(
        f'{k} {v:.3f}' for k, v in times.items()))


def challenge_run_dir(root: str, name: str, model, **cfg_kw) -> str:
    """A run directory ``root/name`` of phase 6's shape: ``config.yml``
    (``cfg_kw`` over phase 6's config) and ``model``'s state_dict as
    ``best-models/FRAMES_AVG_LOGITS/model.pt``."""
    import os
    from fvt_tpu_torch.config import flat_yaml
    from fvt_tpu_torch.config.defaults import get_config

    run = os.path.join(root, name)
    best = os.path.join(run, 'best-models', 'FRAMES_AVG_LOGITS')
    os.makedirs(best)
    cfg = get_config('MELD')
    cfg.update(modality='video+vggish+bert+EXPR_continuous_label',
               model_name='LFAN', window_length=WINDOW, hop_length=HOP,
               eval_bucket_quantum=CHALLENGE_QUANTUM,
               eval_window_batch=WINDOW_BATCH, outd=run, seed=SEED,
               verbose=False, **cfg_kw)
    flat_yaml.dump(cfg, os.path.join(run, 'config.yml'))
    torch.save(model.state_dict(), os.path.join(best, 'model.pt'))
    return run


def plain_challenge(argv: list, device, static: bool) -> dict:
    """The eval pass of ``inference_challenge`` on ``argv`` with every
    kernel on its plain version (``Trainer(reference=True)``): the same
    calls, so the same call boundaries and quantisation; calibrated on the
    plain versions under int8_static.  Returns the per-video logits."""
    from fvt_tpu_torch.config.parse import parse_input
    from fvt_tpu_torch.experiment import Experiment
    from fvt_tpu_torch.inference_challenge import best_model_path
    from fvt_tpu_torch.models.registry import init_model
    from fvt_tpu_torch.train.trainer import Trainer

    args = parse_input(argv)
    exp = Experiment(args, device)
    exp.prepare()
    loaders = exp.init_loaders()
    trainer = Trainer(init_model(args), vars(args), device, reference=True,
                      int_to_cl=exp.data_arranger.int_to_cl)
    exp.load_weights(trainer, best_model_path(args.fd_exp))
    if static:
        trainer.calibrate_quant(exp.sample_batch(loaders))
    return trainer.inference(loaders['test'])[1]


def int8_challenge(device) -> dict:
    """Phase 13, step 3: ``inference_challenge --serve_quant int8`` and
    ``int8_static`` of a tri-modal LFAN under --amp over phase 6's store,
    beside the same model's float32 run: every video's logits within
    INT8_RTOL (relative to their largest) of the same pass on the plain
    versions, 12 B1 and 1 B2 launches a forward and no other float
    kernel, 41 s8 convs and 41 quantise launches a backbone call, amax
    launches only while calibrating under int8_static, the calibration in
    one backbone call, and under dynamic int8 each backbone call the whole
    of its forward's frames; argmax
    agreement and logit delta against the float32 run; wall, frames/s,
    peak memory.  Returns the int8 kernels' launches over the int8 run."""
    import os
    import pickle
    import tempfile
    from fvt_tpu_torch import inference_challenge
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    frames = sum(CHALLENGE_LENGTHS)
    model = LFAN(MODALITY, output_dim=7,
                 generator=torch.Generator().manual_seed(SEED))
    draw_statistics(model, SEED + 43)
    zero, read = run_counters()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        store = make_cexpr_store(os.path.join(root, 'store'),
                                 CHALLENGE_LENGTHS, seed=SEED)
        runs = {'fp32': challenge_run_dir(root, 'fp32', model),
                'amp': challenge_run_dir(root, 'amp', model, amp=True)}
        preds = {}
        for mode, run, quant_flag in (('fp32', runs['fp32'], 'none'),
                                      ('int8', runs['amp'], 'int8'),
                                      ('int8_static', runs['amp'],
                                       'int8_static')):
            argv = ['--mode', 'EVALUATION', '--fd_exp', run,
                    '--target_ds_name', 'C-EXPR-DB-CHALLENGE',
                    '--dataset_path', store['dataset_path'], '--folds_dir',
                    store['folds_dir'], '--serve_quant', quant_flag,
                    '--outd', os.path.join(root, f'out_{mode}')]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            zero_int8()
            with ShapeRecorder() as rec:
                t0 = time.perf_counter()
                inference_challenge.main(argv)
                wall = time.perf_counter() - t0
            launches = {**read(), **read_int8()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with open(os.path.join(root, f'out_{mode}',
                                   'pred-C-EXPR-DB-CHALLENGE',
                                   'prediction.pkl'), 'rb') as f:
                preds[mode] = pickle.load(f)
            forwards, calls = len(rec.fusion), len(rec.backbone)
            print(f'  {mode}: CLI wall {wall:.3f} s for {frames} frames, '
                  f'{frames / wall:.1f} served frames/s, peak device memory '
                  f'{peak:.2f} GiB; {forwards} forwards, {calls} backbone '
                  f'calls; launches '
                  f'{ {k: n for k, n in launches.items() if n} }')
            want = {k: 0 for k in launches}
            want.update(tcn_block=12 * forwards, fusion=forwards)
            if mode != 'fp32':
                # under int8_static the calibration forward (a train-loader
                # batch) comes first, in one backbone call, and is the only
                # one to take the amax
                calib = (0 if mode == 'int8' else
                         calls_of(rec.backbone, np.prod(rec.model[0])))
                if mode == 'int8_static' and calib != 1:
                    fail(f'the calibration split its backbone call: calls '
                         f'{rec.backbone[:calib]} for {rec.model[0]}')
                want.update(conv3x3_int8=41 * calls,
                            quantize_int8=41 * calls,
                            quantize_int8_amax=41 * (calls if mode == 'int8'
                                                     else calib))
            if forwards < 1 or launches != want:
                fail(f'{mode}: expected launches {want}, got {launches}')
            if mode == 'int8' and rec.backbone != [
                    int(np.prod(bt)) for bt in rec.model]:
                fail(f'dynamic int8 split a forward\'s backbone call: '
                     f'calls {rec.backbone}, forwards {rec.model}')
            if mode == 'int8':
                out = {k: launches[k] for k in ('conv3x3_int8',
                                                'quantize_int8')}
            if mode == 'fp32':
                continue
            plain = plain_challenge(argv[:-1] + [os.path.join(
                root, f'plain_{mode}')], device, mode == 'int8_static')
            errs = [relative_error(preds[mode][v]['logits'],
                                   plain[v]['logits']) for v in plain]
            fp = np.concatenate([preds['fp32'][v]['logits'] for v in plain])
            got = np.concatenate([preds[mode][v]['logits'] for v in plain])
            agree = float((fp.argmax(-1) == got.argmax(-1)).mean())
            delta = np.abs(fp - got)
            print(f'  {mode}: every video within {max(errs):.3e} of the '
                  f'same pass on the plain versions, relative to the '
                  f'largest logit (gate {INT8_RTOL}); against the float32 '
                  f'run: frame argmax agreement {agree:.4f}, logit delta '
                  f'max {delta.max():.4e} mean {delta.mean():.4e} (mean '
                  f'|logit| {np.abs(fp).mean():.4e})')
            if max(errs) > INT8_RTOL:
                fail(f'{mode}: served logits differ from the plain versions '
                     f'by {max(errs)} relative')
    torch.cuda.empty_cache()
    return out


def calls_of(calls: list, frames: int) -> int:
    """How many of the first backbone calls cover ``frames`` frames."""
    total = 0
    for i, n in enumerate(calls):
        total += n
        if total >= frames:
            return i + 1
    fail(f'backbone calls {calls} do not cover {frames} frames')


def serve_over_http(path: str, device, streams: Optional[dict] = None):
    """The artifact at ``path`` loaded and served on 127.0.0.1: (the
    in-process artifact, /logits of a seeded (WINDOW_BATCH, WINDOW) batch
    in float32, the same through ``art.call``, the streams' served logits
    or None, the /healthz latency of /logits)."""
    import threading
    from fvt_tpu_torch.client import ServingClient
    from fvt_tpu_torch.export import load_artifact
    from fvt_tpu_torch.tools import serve_http

    art = load_artifact(path, device=device)
    srv = serve_http.build_server(path, '127.0.0.1', 0, device=device,
                                  dynamic_batch=True, batch_delay_s=0.05)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client = ServingClient(f'http://127.0.0.1:{srv.server_port}',
                           timeout=300)
    spec = art.meta['shapes'][f'b{WINDOW_BATCH}xt{WINDOW}']['inputs']
    rng = np.random.default_rng(SEED + 44)
    batch = {k: (rng.integers(0, 256, v['shape'], np.uint8)
                 if v['dtype'] == 'uint8'
                 else rng.standard_normal(v['shape'], np.float32))
             for k, v in spec.items()}
    served = [client.logits(batch) for _ in range(ARTIFACT_LOGITS_CALLS)]
    got = None
    if streams is not None:
        handles = {n: client.open_stream() for n in streams}
        for c0 in range(0, max(streams), CHUNK):
            for n, f in streams.items():
                if c0 < n:
                    handles[n].feed({k: v[c0:c0 + CHUNK]
                                     for k, v in f.items()})
        for h in handles.values():
            h.finish()
        got = {n: h.result(timeout_s=300) for n, h in handles.items()}
    lat = client.healthz()['latency']['/logits']
    serve_http.drain_and_shutdown(srv, timeout_s=5)
    thread.join(timeout=10)
    if thread.is_alive():
        fail(f'{path}: the server thread did not stop')
    return art, served, art.call(batch), got, lat


def int8_artifacts(device) -> None:
    """Phase 13, steps 4 and 5: an int8_static artifact exported from a
    run directory with --calib_store (the scales calibrated on the card)
    and served over HTTP, /logits bit for bit its in-process call; a
    float32 LFAN artifact of --h2d_bf16_features (bfloat16 feature specs)
    served over HTTP, /logits and three streams within BF16_FEATURES_RTOL
    of the in-process call and stitch; latency p50 / p99."""
    import os
    import tempfile
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.tools import export_serving
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    model = LFAN(MODALITY, output_dim=7,
                 generator=torch.Generator().manual_seed(SEED))
    draw_statistics(model, SEED + 45)
    streams = make_streams()
    with tempfile.TemporaryDirectory() as root:
        store = make_cexpr_store(os.path.join(root, 'store'),
                                 CHALLENGE_LENGTHS[:6], seed=SEED)
        for name, kw in (('int8_static', {'amp': True,
                                          'serve_quant': 'int8_static'}),
                         ('h2d_bf16_features', {'h2d_bf16_features': True})):
            # the calibration reads the store as the run's dataset
            run = challenge_run_dir(root, name, model,
                                    dataset_name='C-EXPR-DB-CHALLENGE', **kw)
            t0 = time.perf_counter()
            path = export_serving.main(
                ['--fd_exp', run, '--calib_store', store['dataset_path'],
                 '--calib_folds_dir', store['folds_dir']])['artifact']
            write_s = time.perf_counter() - t0
            bf16 = name == 'h2d_bf16_features'
            art, served, want, got, lat = serve_over_http(
                path, device, streams if bf16 else None)
            mode = art.model.spatial.visual.int8_mode()
            specs = {k: v['dtype'] for k, v in
                     art.meta['shapes'][f'b{WINDOW_BATCH}xt{WINDOW}']
                     ['inputs'].items()}
            print(f'  {name}: artifact {os.path.getsize(path)} bytes, '
                  f'exported in {write_s:.3f} s; backbone int8 mode {mode}; '
                  f'input dtypes {specs}; /logits p50 {lat["p50_ms"]} ms, '
                  f'p99 {lat["p99_ms"]} ms over {lat["count"]}')
            if not bf16:
                same = all(np.array_equal(s, want) for s in served)
                print(f'  {name}: /logits bit for bit the in-process call: '
                      f'{same}')
                if mode != 'static' or not same:
                    fail(f'{name}: mode {mode}, /logits bit for bit the '
                         f'in-process call: {same}')
                continue
            if set(specs.values()) != {'uint8', 'bfloat16'}:
                fail(f'{name}: input dtypes {specs}')
            errs = [relative_error(s, want) for s in served]
            errs += [relative_error(got[n], window_stitch(
                lambda b, _: art.call(b), {k: v for k, v in f.items()
                                           if k in specs}, False))
                     for n, f in streams.items()]
            print(f'  {name}: /logits and three streams within '
                  f'{max(errs):.3e} of the in-process call and stitch '
                  f'(gate {BF16_FEATURES_RTOL})')
            if max(errs) > BF16_FEATURES_RTOL:
                fail(f'{name}: served logits differ from in-process by '
                     f'{max(errs)} relative')
            del art
    torch.cuda.empty_cache()


def profile_epoch(device) -> None:
    """Phase 13, step 6: one epoch of ``fvt_tpu_torch.main
    --profile_epochs 1`` on a small C-EXPR-DB store: the trace written
    under ``<outd>/profile``, with device kernels in it."""
    import os
    import tempfile
    from fvt_tpu_torch import main as train_cli
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    with tempfile.TemporaryDirectory() as root:
        store = make_cexpr_store(os.path.join(root, 'store'),
                                 (320, 450, 600, 700), ds='C-EXPR-DB',
                                 val_lengths=(400,), seed=SEED)
        outd = os.path.join(root, 'run')
        t0 = time.perf_counter()
        train_cli.main(['--dataset_name', 'C-EXPR-DB',
                        '--dataset_path', store['dataset_path'],
                        '--folds_dir', store['folds_dir'],
                        '--modality', 'vggish+bert+EXPR_continuous_label',
                        '--model_name', 'LFAN', '--window_length',
                        str(WINDOW), '--hop_length', str(HOP),
                        '--train_batch_size', '4', '--num_epochs', '1',
                        '--profile_epochs', '1', '--seed', str(SEED),
                        '--outd', outd], device=device)
        wall = time.perf_counter() - t0
        path = os.path.join(outd, 'profile', 'epoch0.pt.trace.json')
        if not os.path.isfile(path):
            fail(f'--profile_epochs 1 wrote no trace at {path}')
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
        kernels = sum(1 for e in events if e.get('cat') == 'kernel')
        print(f'  one epoch under --profile_epochs 1 in {wall:.2f} s: '
              f'{os.path.relpath(path, outd)} {os.path.getsize(path)} bytes, '
              f'{len(events)} events, {kernels} device kernels')
        if kernels < 1:
            fail('the trace holds no device kernel')


def int8_serving(device) -> dict:
    """Phase 13.  Returns the int8 kernels' launches over step 3's
    dynamic int8 run."""
    int8_backbone(device)
    launches = int8_challenge(device)
    int8_artifacts(device)
    profile_epoch(device)
    return launches


# ---------------------------------------------------------------- phase 14
# the audio chain's clips: (name, seconds, video fps, sample rate,
# channels); 0.5 s is shorter than the example window (the edge pad decides
# it), 3 s a MELD-sized utterance, 300 s a long C-EXPR-DB video, the
# 44.1 kHz stereo clip drives resample and the mono mix
AUDIO_CLIPS = (('0.5s', 0.5, 30.0, 16000, 1), ('3s@30', 3.0, 30.0, 16000, 1),
               ('3s@29.97', 3.0, 29.97, 16000, 1),
               ('60s@25', 60.0, 25.0, 16000, 1),
               ('300s@30', 300.0, 30.0, 16000, 1),
               ('10s@30-44.1k-stereo', 10.0, 30.0, 44100, 2))
# the clip whose annotated indices run AUDIO_PAST_END past its patches
AUDIO_PAST_END_CLIP, AUDIO_PAST_END = '3s@30', 45
# the clip held against the float64 VGGish and put through eGeMAPS
AUDIO_LONG_CLIP = '60s@25'
# the card's log-mel against the CPU's (both transform in float64)
AUDIO_LOGMEL_ATOL = 1e-5
# logmel.npy: every element within one float16 unit in the last place of
# the CPU's file, at most this share of them apart at all
AUDIO_HALF_FLIPS = 2e-3
# embeddings against the float64 VGGish, relative to the largest magnitude
AUDIO_EMBED_RTOL = 1e-4
AUDIO_INPUT_SIZE = 500


def audio_clip(seconds: float, sample_rate: int, channels: int,
               rng: np.random.Generator) -> np.ndarray:
    """int16 samples, (n,) or (n, channels): stretches of 0.15 to 1.5 s of
    a tone, noise, a tone over noise or silence, drawn from ``rng``."""
    n = int(round(seconds * sample_rate))
    out = np.zeros((n, channels))
    pos = 0
    while pos < n:
        length = min(n - pos, int(rng.uniform(0.15, 1.5) * sample_rate))
        t = np.arange(length) / sample_rate
        kind = rng.integers(4)
        tone = (rng.uniform(0.1, 0.5)
                * np.sin(2 * np.pi * rng.uniform(100, 4000) * t
                         + rng.uniform(0, 2 * np.pi)))[:, None]
        noise = rng.uniform(0.02, 0.2) * rng.standard_normal((length,
                                                              channels))
        out[pos:pos + length] = (tone if kind == 0 else noise if kind == 1
                                 else 0.5 * tone + noise if kind == 2
                                 else 0.0)
        pos += length
    data = np.clip(out * 32767, -32768, 32767).astype(np.int16)
    return data[:, 0] if channels == 1 else data


def traced_device_ms(fn, tries: int = 3) -> Optional[float]:
    """Device time (kernels and copies) of one call of ``fn``, from
    ``torch.profiler``.  The profiler now and then records no device
    activity for a window (``tools/timing.py``): the call is traced
    again, up to ``tries`` times, and None ("not measured") is returned
    if it never does.  The device events' durations are summed from the
    raw trace: building the profiler's event tree (``key_averages``) over
    a long trace (phase 15's forty FAN forwards) took tens of seconds."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total = sum(e.duration_ns() for e in
                    prof.profiler.kineto_results.events()
                    if e.device_type() == cuda
                    and not e.is_user_annotation())
        if total > 0:
            return total / 1e6
    return None


def audio_stage(name: str, clip: str, frames: int, fn, traced=None,
                host: bool = False) -> tuple:
    """One stage on one clip: ``fn()`` timed on the host clock with the
    device's peak memory around it, then, unless the stage runs on the
    ``host`` alone, ``traced()`` (``fn`` where None; it may be called more
    than once) under the profiler for the device time.  Prints the row;
    returns it and ``fn()``'s result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    device = None if host else traced_device_ms(traced or fn)
    row = {'stage': name, 'clip': clip, 'frames': frames,
           'wall_s': wall, 'frames_per_s': frames / wall,
           'device_ms': device, 'peak_mib': peak}
    print(f'  {name} {clip}: {frames} video frames, wall {wall:.4f} s, '
          f'{frames / wall:.1f} frames/s, device '
          + ('none (host)' if host else 'not measured' if device is None
             else f'{device:.3f} ms')
          + f', peak device memory {peak:.1f} MiB')
    return row, out


def compare_half(name: str, got: np.ndarray, want: np.ndarray) -> None:
    """float16 files: the same shape, every element within one unit in the
    last place, at most AUDIO_HALF_FLIPS of them apart."""
    if got.dtype != np.float16 or got.shape != want.shape:
        fail(f'{name}: {got.dtype} {got.shape} against {want.dtype} '
             f'{want.shape}')
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(got)))
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    share = np.count_nonzero(diff) / max(diff.size, 1)
    print(f'  {name}: logmel.npy {got.shape} float16, {share:.2e} of the '
          f'elements one unit apart from the CPU\'s')
    if (diff > ulp).any() or share > AUDIO_HALF_FLIPS:
        fail(f'{name}: the card\'s logmel.npy is more than one float16 ulp '
             f'from the CPU\'s, or in more than {AUDIO_HALF_FLIPS} of its '
             f'elements')


def audio_chain(device, card: str) -> None:
    """Phase 14: the offline audio extractors on the card over
    AUDIO_CLIPS, written from the seed as 16-bit PCM wavs: ``extract_logmel``
    (checked against ``device='cpu'``), ``extract_vggish_embeddings`` with
    a full-width VGGish loaded from a seeded upstream-named ``vggish.pth``
    (shapes; the long clip against the VGGish in float64), ``extract_mfcc``
    on every clip and ``extract_egemaps`` on the long one (on the host:
    shapes, finite).  No kernel of the port's may launch."""
    import os
    import tempfile

    from fvt_tpu_torch.models.vggish import VGGish
    from fvt_tpu_torch.preprocess import audio, melspec, mfcc
    from fvt_tpu_torch.preprocess.sharding import annotated_index

    t_phase = time.perf_counter()
    zero, read = run_counters()
    zero()
    rng = np.random.default_rng(SEED + 14)
    rows = []
    with tempfile.TemporaryDirectory() as root:
        seeded = VGGish()
        seeded.reset_parameters(torch.Generator().manual_seed(SEED))
        with torch.no_grad():  # He's gain over PyTorch's uniform init
            for p in seeded.parameters():
                if p.dim() > 1:
                    p.mul_(6 ** 0.5)
        pth = f'{root}/vggish.pth'
        torch.save(seeded.state_dict(), pth)
        n_params = sum(p.numel() for p in seeded.parameters())
        vggish = audio.vggish_from_pth(pth)
        print(f'  VGGish of {n_params / 1e6:.1f} M parameters from a seeded '
              f'upstream-named vggish.pth on {device}; {card}')
        for clip, seconds, fps, sr, channels in AUDIO_CLIPS:
            wav = f'{root}/{clip}.wav'
            melspec.write_wav(wav, audio_clip(seconds, sr, channels, rng), sr)
            frames = int(round(seconds * fps))
            idx = annotated_index(frames, fps)
            if clip == AUDIO_PAST_END_CLIP:
                idx = np.arange(frames + AUDIO_PAST_END)
            hop = 1.0 / fps

            # log-mel patches, float16 on disk
            def traced_logmel():
                out = f'{root}/{clip}.traced.npy'
                audio.extract_logmel(wav, out, hop_sec=hop, annotated_idx=idx)
                os.remove(out)

            row, _ = audio_stage(
                'logmel', clip, frames,
                lambda: audio.extract_logmel(wav, f'{root}/{clip}.card.npy',
                                             hop_sec=hop, annotated_idx=idx),
                traced_logmel)
            rows.append(row)
            audio.extract_logmel(wav, f'{root}/{clip}.cpu.npy', hop_sec=hop,
                                 annotated_idx=idx, device='cpu')
            written = np.load(f'{root}/{clip}.card.npy')
            if len(written) != len(idx):
                fail(f'{clip}: logmel.npy has {len(written)} rows for '
                     f'{len(idx)} annotated frames')
            compare_half(clip, written, np.load(f'{root}/{clip}.cpu.npy'))
            patches = melspec.wavfile_to_examples(wav, 0.96, hop,
                                                  device=device)
            want = melspec.wavfile_to_examples(wav, 0.96, hop, device='cpu')
            err = float(np.abs(patches - want).max())
            print(f'  {clip}: {patches.shape} float32 patches, max |card - '
                  f'cpu| = {err:.3e} (atol {AUDIO_LOGMEL_ATOL})')
            if patches.shape != want.shape or err > AUDIO_LOGMEL_ATOL:
                fail(f'{clip}: the card\'s log-mel patches differ from the '
                     f'CPU\'s by {err}')

            # VGGish embeddings: patches - 1 rows, then the annotated gather
            row, emb = audio_stage(
                'vggish', clip, frames,
                lambda: audio.extract_vggish_embeddings(
                    wav, vggish, 0.96, hop, AUDIO_INPUT_SIZE))
            rows.append(row)
            gathered = audio.extract_vggish_embeddings(
                wav, vggish, 0.96, hop, AUDIO_INPUT_SIZE, idx)
            if (emb.shape != (max(len(patches) - 1, 0), 128)
                    or gathered.shape != (len(idx), 128)
                    or not np.isfinite(gathered).all()):
                fail(f'{clip}: embeddings {emb.shape} and {gathered.shape} '
                     f'for {len(patches)} patches and {len(idx)} frames')
            regathered = audio._pad_to_annotated(emb, idx)[idx]
            if np.abs(gathered - regathered).max() > (
                    AUDIO_EMBED_RTOL * np.abs(regathered).max()):
                fail(f'{clip}: the annotated gather is not the rows\' own')
            if clip == AUDIO_LONG_CLIP:
                check_vggish_float64(vggish, patches, idx, gathered, device)

            # MFCC on every clip and eGeMAPS on the long one, on the host
            row, _ = audio_stage(
                'mfcc', clip, frames,
                lambda: mfcc.extract_mfcc(wav, f'{root}/{clip}.mfcc.npy',
                                          idx, hop), host=True)
            rows.append(row)
            check_host_feature(clip, np.load(f'{root}/{clip}.mfcc.npy'),
                               (len(idx), 39))
            if clip == AUDIO_LONG_CLIP:
                row, _ = audio_stage(
                    'egemaps', clip, frames,
                    lambda: mfcc.extract_egemaps(
                        wav, f'{root}/{clip}.egemaps.npy', frames, fps,
                        annotated_idx=idx), host=True)
                rows.append(row)
                check_host_feature(clip, np.load(
                    f'{root}/{clip}.egemaps.npy'), (len(idx), 88))
    launched = {k: n for k, n in read().items() if n}
    if launched:
        fail(f'the audio chain launched kernels of the port: {launched}')
    wall = time.perf_counter() - t_phase
    print(f'  audio chain rows: {json.dumps(rows)}')
    print(f'  phase 14 in {wall:.1f} s on {card}; no kernel of the port '
          f'launched')


def check_vggish_float64(vggish, patches: np.ndarray, idx: np.ndarray,
                         got: np.ndarray, device) -> None:
    """The extractor's embeddings against the same VGGish cast to float64
    on the card, on the same float32 patches, row-shifted and gathered."""
    from fvt_tpu_torch.models.vggish import VGGish
    from fvt_tpu_torch.preprocess import audio

    wide = VGGish(dtype=torch.float64)
    wide.load_state_dict(vggish.state_dict())
    wide = wide.double().to(device).eval()
    x = torch.from_numpy(patches).to(device)
    with torch.inference_mode():
        want = torch.cat([wide(x[s:s + AUDIO_INPUT_SIZE])
                          for s in range(0, len(x), AUDIO_INPUT_SIZE)])
    want = audio._pad_to_annotated(want.cpu().numpy()[1:], idx)[idx]
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f'  {AUDIO_LONG_CLIP}: embeddings vs the float64 VGGish: max abs '
          f'{err:.3e}, {err / scale:.3e} of the largest {scale:.3e} (rtol '
          f'{AUDIO_EMBED_RTOL})')
    if not scale > 0 or err > AUDIO_EMBED_RTOL * scale:
        fail(f'{AUDIO_LONG_CLIP}: embeddings differ from the float64 '
             f'VGGish\'s by {err / scale:.3e} of their largest magnitude')
    del wide, x
    torch.cuda.empty_cache()


def check_host_feature(clip: str, feats: np.ndarray, shape: tuple) -> None:
    if feats.shape != shape or not np.isfinite(feats).all():
        fail(f'{clip}: host feature {feats.shape} (want {shape}), finite='
             f'{np.isfinite(feats).all()}')


# ---------------------------------------------------------------- phase 15
# the visual chain's trials: (name, label, frames, height, width), both at
# VISUAL_FPS; a 720p and a VGA clip, their face crops warped at 256^2
VISUAL_TRIALS = (('trial_a', 0, 40, 720, 1280), ('trial_b', 3, 24, 480, 640))
VISUAL_FPS = 25.0
# the detector's longest side as the upstream runs it, and the smaller one
# at which the card is held against the CPU
DETECT_MAX_SIZE = 2048
DETECT_GATE_SIZE = 512
# the threshold is drawn from frame 0's scores so that this many anchors
# pass it (random weights score no face; the NMS then has work)
DETECT_ANCHORS = 300
# card against CPU on the same inputs and weights: the detector's outputs,
# FAN's heatmaps and the embeddings within this of their largest
# magnitude; AU maps (values in [0, 1]) absolute
VISUAL_RTOL = 1e-4
VISUAL_AU_ATOL = 1e-5
# crops of trial_a held against the CPU through FAN, and the AU maps' size
FAN_GATE_CROPS = 4
AU_GATE_SIZE = 128


def seeded_state(model: torch.nn.Module, rng: np.random.Generator,
                 gain: float = 2.0) -> dict:
    """``model``'s state_dict drawn from ``rng``: convolutions N(0, gain /
    fan_in) (a detector head's at a ninth of that), conv biases and
    BatchNorm shifts and means N(0, 0.1^2), BatchNorm scales U(0.6, 1),
    variances U(0.5, 1.5); what PyTorch counts stays."""
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith('num_batches_tracked'):
            out[k] = v
            continue
        if len(shape) == 4:
            std = np.sqrt(gain / np.prod(shape[1:]))
            if 'Head' in k:
                std /= 3
            a = rng.standard_normal(shape) * std
        elif k.endswith('running_var'):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith('.weight'):  # a BatchNorm's scale
            a = rng.uniform(0.6, 1.0, shape)
        else:
            a = rng.standard_normal(shape) * 0.1
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def visual_frames(n: int, h: int, w: int,
                  rng: np.random.Generator) -> np.ndarray:
    """(n, h, w, 3) uint8: a smooth background and a lit ellipse, a face's
    size and place, drifting a few pixels a frame, with light noise."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([60 + 40 * np.sin(xs * rng.uniform(0.005, 0.02)
                                      + ys * rng.uniform(0.005, 0.02)
                                      + rng.uniform(0, 6))
                     for _ in range(3)], axis=-1).astype(np.float32)
    tone = np.array([150, 110, 90], np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        cx, cy = w * 0.5 + 2 * i, h * 0.45 + i
        r = ((xs - cx) / (0.12 * w)) ** 2 + ((ys - cy) / (0.25 * h)) ** 2
        frame = base + np.clip(1.5 - r, 0, 1)[..., None] * tone
        frame += rng.integers(-4, 5, (h, w, 3), dtype=np.int8)
        out[i] = np.clip(np.rint(frame), 0, 255)
    return out


class DroppingDetector:
    """``detector`` but that the frames in ``drop`` (counted from 0 at
    this object's first call) find no face: the faces chain's leading
    fallback and its carry run."""

    def __init__(self, detector, drop):
        self.detector, self.drop, self.calls = detector, set(drop), 0

    def detect(self, img_rgb):
        i, self.calls = self.calls, self.calls + 1
        return [] if i in self.drop else self.detector.detect(img_rgb)


def conv_flops(model: torch.nn.Module, fn) -> float:
    """Operations of the convolutions of one call of ``fn()`` (which runs
    ``model``): 2 x output elements x input channels per group x kernel
    area, each counted from the shapes it ran at."""
    total = [0.0]

    def hook(mod, inputs, output):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2.0 * output.numel() * mod.in_channels // mod.groups * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def visual_stage(name: str, trial: str, frames: int, fn, traced=None,
                 host: bool = False) -> tuple:
    """:func:`audio_stage`'s row with the device's idle share: 1 - device
    time / wall."""
    t0 = time.perf_counter()
    row, out = audio_stage(name, trial, frames, fn, traced, host)
    if row['device_ms'] is not None:
        row['idle_share'] = 1 - row['device_ms'] / (row['wall_s'] * 1e3)
        print(f'    idle share {row["idle_share"]:.3f}; traced in '
              f'{time.perf_counter() - t0 - row["wall_s"]:.1f} s')
    return row, out


def encode_lossless(path: str, frames: np.ndarray, wav: str) -> None:
    """frames and the wav into one file: FFV1 (lossless) video at
    VISUAL_FPS, 16-bit PCM audio."""
    n, h, w, _ = frames.shape
    subprocess.run(['ffmpeg', '-v', 'error', '-nostdin', '-y', '-f',
                    'rawvideo', '-pix_fmt', 'rgb24', '-s', f'{w}x{h}', '-r',
                    str(VISUAL_FPS), '-i', '-', '-i', wav, '-c:v', 'ffv1',
                    '-c:a', 'pcm_s16le', path], input=frames.tobytes(),
                   check=True)


def compare_rel(name: str, got: np.ndarray, want: np.ndarray,
                rtol: float = VISUAL_RTOL) -> float:
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f'  {name}: max |card - cpu| = {err:.3e}, {err / scale:.3e} of the '
          f'largest {scale:.3e} (rtol {rtol})')
    if got.shape != want.shape or not scale > 0 or err > rtol * scale:
        fail(f'{name}: the card is {err / scale:.3e} of the largest '
             f'magnitude from the CPU')
    return err / scale


def compare_levels(name: str, got: np.ndarray, want: np.ndarray) -> int:
    """uint8 images: within one level; returns how many values differ."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    flips = int(np.count_nonzero(diff))
    print(f'  {name}: {flips} of {diff.size} values one level apart from '
          f'the CPU\'s ({flips / diff.size:.2e})')
    if got.shape != want.shape or diff.max(initial=0) > 1:
        fail(f'{name}: the card is more than one level from the CPU')
    return flips


def check_detector(det, det_cpu, frame: np.ndarray, threshold: float,
                   device) -> None:
    """The detector at DETECT_GATE_SIZE, card against CPU: ``_prepare``
    within one level; on the CPU's prepared frame the network's outputs
    within VISUAL_RTOL of their largest magnitude and the same detections
    (the same count and scores within 1e-5; boxes and landmarks within one
    pixel, the coordinates that the integer truncation moves counted)."""
    from fvt_tpu_torch.preprocess import retinaface as rf

    h, w = frame.shape[:2]
    x_cpu, top, left = det_cpu._prepare(frame)
    x_card, _, _ = det._prepare(frame)
    level = 1 / (255 * torch.from_numpy(rf.NORM_STD))
    compare_levels('RetinaFace _prepare (levels)',
                   torch.round(x_card.cpu() / level).numpy(),
                   torch.round(x_cpu / level).numpy())
    got = det.forward(x_cpu.to(device))
    want = det_cpu.forward(x_cpu)
    for name, g, w_ in zip(('loc', 'conf', 'ldm'), got, want):
        compare_rel(f'RetinaFace {name} at {DETECT_GATE_SIZE}^2',
                    g.cpu().numpy(), w_.numpy())
    det.threshold = det_cpu.threshold = threshold
    got = det.detect_prepared(x_cpu, top, left, h, w)
    want = det_cpu.detect_prepared(x_cpu, top, left, h, w)
    if len(got) != len(want) or not got:
        fail(f'detections: {len(got)} on the card, {len(want)} on the CPU')
    moved = 0
    for g, w_ in zip(got, want):
        d = np.abs(np.concatenate([g['bbox'] - w_['bbox'], (
            g['landmarks'] - w_['landmarks']).ravel()]))
        moved += int(np.count_nonzero(d))
        if d.max() > 1 or abs(g['score'] - w_['score']) > 1e-5:
            fail(f'detections differ: {g} against {w_}')
    print(f'  detections at {DETECT_GATE_SIZE}^2, threshold '
          f'{threshold:.6f}: {len(got)} on both, {moved} of '
          f'{14 * len(got)} integer coordinates one pixel apart')


def landmark_ties(hm_card: np.ndarray, hm_cpu: np.ndarray, got: np.ndarray,
                  want: np.ndarray) -> int:
    """Landmarks equal but where the CPU's heatmap ties: the card's argmax
    within VISUAL_RTOL of the largest magnitude of the CPU's maximum, or a
    sub-pixel step's neighbour difference within it.  Returns the ties."""
    tol = VISUAL_RTOL * np.abs(hm_cpu).max()
    ties = 0
    for j in np.nonzero((got != want).any(axis=1))[0]:
        a, b = hm_card[:, :, j], hm_cpu[:, :, j]
        iy, ix = np.unravel_index(a.argmax(), a.shape)
        tie = b.max() - b[iy, ix] <= tol
        if not tie and 0 < ix < a.shape[1] - 1 and 0 < iy < a.shape[0] - 1:
            tie = min(abs(b[iy, ix + 1] - b[iy, ix - 1]),
                      abs(b[iy + 1, ix] - b[iy - 1, ix])) <= tol
        if not tie:
            fail(f'landmark {j}: {got[j]} on the card, {want[j]} on the CPU, '
                 f'and no tie in the heatmap')
        ties += 1
    return ties


def visual_chain(device, card: str) -> None:
    """Phase 15: the offline visual preprocessing and the feature driver on
    the card, on two seeded trials (VISUAL_TRIALS) with full-width
    RetinaFace-R50, FAN-4, ArcFace IR-50 and VGGish drawn from the seed
    and loaded from files under the upstream names.  Where ffmpeg is on
    the machine the trials are lossless video files with their audio and
    the chain runs from them; else from the frames, the wavs placed and
    the probe injected.  Driver pass 1 (labels, log-mel, VGGish, BERT
    zeros; two shards), then the faces (RetinaFace at DETECT_MAX_SIZE, the
    warp; frames 0-1 and a middle one dropped), compaction and
    recompaction, driver pass 2 (``cnn.npy``, ``landmark.npy``), the
    merge; the card held against the CPU; no kernel of the port's may
    launch."""
    import importlib.util
    import os
    import shutil
    import tempfile

    from fvt_tpu_torch.models.arcface import VisualBackbone
    from fvt_tpu_torch.models.vggish import VGGish
    from fvt_tpu_torch.preprocess import (action_units, audio, compact,
                                          driver, facealign, faces, fan,
                                          melspec, merge, recompact,
                                          retinaface, visual)
    from fvt_tpu_torch.preprocess.fan import _resize_bilinear
    from fvt_tpu_torch.preprocess.sharding import divide

    t_phase = time.perf_counter()

    def mark(what: str) -> None:
        print(f'  [{time.perf_counter() - t_phase:.1f} s] {what}')

    zero, read = run_counters()
    zero()
    rng = np.random.default_rng(SEED + 15)
    has_ffmpeg = bool(shutil.which('ffmpeg') and shutil.which('ffprobe'))
    has_pil = importlib.util.find_spec('PIL') is not None
    print('  ffmpeg ' + ('present: the trials are video files' if has_ffmpeg
                         else 'absent: frames, placed wavs and an injected '
                         'probe') + '; PIL ' + (
        'present: jpgs and compact.main' if has_pil
        else 'absent: compact_video_npy'))
    rows = []
    with tempfile.TemporaryDirectory() as root:
        # full-width weights from the seed, under the upstream names
        paths = {'retinaface': f'{root}/retinaface_resnet50_2020-07-20.pth',
                 'fan': f'{root}/2DFAN4-cd938726ad.zip',
                 'arcface': f'{root}/res50_ir_0.887.pth',
                 'vggish': f'{root}/vggish.pth'}
        torch.save(seeded_state(retinaface.RetinaFaceNet(), rng),
                   paths['retinaface'])
        torch.save(seeded_state(fan.FAN(), rng, gain=1.0), paths['fan'])
        arcface = VisualBackbone()
        arcface.reset_parameters(torch.Generator().manual_seed(SEED))
        torch.save(arcface.state_dict(), paths['arcface'])
        vggish = VGGish()
        vggish.reset_parameters(torch.Generator().manual_seed(SEED))
        with torch.no_grad():  # He's gain over PyTorch's uniform init
            for p in vggish.parameters():
                if p.dim() > 1:
                    p.mul_(6 ** 0.5)
        torch.save(vggish.state_dict(), paths['vggish'])

        mark('weights written')

        # the trials: a fold, videos (or frames), wavs
        folds, videos = f'{root}/folds', f'{root}/videos'
        out, faces_root = f'{root}/store', f'{root}/cropped_aligned'
        feat = f'{out}/features'
        npy_root = f'{feat}/{driver.NPY_FOLDER}'
        os.makedirs(f'{folds}/split-0')
        os.makedirs(videos)
        os.makedirs(f'{feat}/wav')
        with open(f'{folds}/split-0/train.txt', 'w') as f:
            f.writelines(f'{name},{label},\n'
                         for name, label, *_ in VISUAL_TRIALS)
        clips = {}
        for name, _, n, h, w in VISUAL_TRIALS:
            frames = visual_frames(n, h, w, rng)
            wav = f'{root}/{name}.wav'
            melspec.write_wav(wav, audio_clip(n / VISUAL_FPS, 16000, 1, rng),
                              16000)
            if has_ffmpeg:
                path = f'{videos}/{name}.mkv'
                encode_lossless(path, frames, wav)
                decoded = np.stack(list(faces.read_video_frames(path)))
                if not np.array_equal(decoded, frames):
                    fail(f'{name}: the lossless video does not decode to '
                         f'its frames')
                if driver.probe_video(path) != (VISUAL_FPS, n):
                    fail(f'{name}: probe_video gives '
                         f'{driver.probe_video(path)}')
            else:
                open(f'{videos}/{name}.mp4', 'w').close()
                shutil.copy(wav, f'{feat}/wav/{name}.wav')
            clips[name] = frames
        lengths = {name: n for name, _, n, *_ in VISUAL_TRIALS}

        def probe(path):
            return VISUAL_FPS, lengths[os.path.basename(path).split('.')[0]]

        def run_driver(part: int, flags: list, models):
            """Shard ``part`` of 2 through ``driver.main`` with ``flags``
            (the video files probed by ffprobe), else through
            PreprocessingDriver with ``models()``' extractors and the
            injected probe."""
            argv = ['--dataset_name', 'C-EXPR-DB', '--split', 'train',
                    '--part', str(part), '--nparts', '2', '--video_root',
                    videos, '--output_root', out, '--folds_dir', folds]
            if has_ffmpeg:
                return driver.main(argv + flags)
            return driver.PreprocessingDriver(
                'C-EXPR-DB', 'train', part, 2, videos, out, folds,
                probe=probe, **models()).run()

        def check_records(records):
            for r in records:
                if r['processing_record']['issues']:
                    fail(f'driver: {r["processing_record"]}')

        mark('trials written')

        # driver pass 1: labels, log-mel, VGGish, BERT zeros, two shards
        total = sum(lengths.values())
        shards = [sum(lengths[t] for t in shard)
                  for shard in divide(2, list(lengths))]
        for part in range(2):
            row, records = visual_stage(
                f'driver pass 1, part {part}/2', 'shard', shards[part],
                lambda: run_driver(part, ['--vggish_pth', paths['vggish']],
                                   lambda: {'vggish': audio.vggish_from_pth(
                                       paths['vggish'])}), host=True)
            check_records(records)
            rows.append(row)

        mark('driver pass 1 done')

        # the detector at DETECT_MAX_SIZE and its threshold
        det = retinaface.RetinaFaceR50(weights_path=paths['retinaface'],
                                       max_size=DETECT_MAX_SIZE)
        first = clips[VISUAL_TRIALS[0][0]][0]
        x0, _, _ = det._prepare(first)
        scores = det.forward(x0)[1][0, :, 1]
        threshold = float(torch.sort(scores).values[-DETECT_ANCHORS - 1])
        det.threshold = threshold
        kept = det.detect(first)
        print(f'  RetinaFace-R50 at {DETECT_MAX_SIZE}^2: {scores.numel()} '
              f'anchors, threshold {threshold:.6f} from frame 0\'s scores: '
              f'{DETECT_ANCHORS} pass, {len(kept)} kept by the NMS')
        if not kept:
            fail('the detector kept no box on frame 0')
        flops = conv_flops(det.model, lambda: det.forward(x0))
        ms = median_ms(lambda: det.forward(x0), runs=5, warmup=2)
        print(f'  RetinaFace forward at {DETECT_MAX_SIZE}^2: {ms:.3f} ms a '
              f'frame (CUDA events), {flops / 1e9:.1f} GFLOP of '
              f'convolutions, {flops / ms / 1e9:.2f} TFLOP/s, '
              f'{flops / PEAK_FLOPS * 1e3 / ms:.1%} of the fp32 peak (bound '
              f'{flops / PEAK_FLOPS * 1e3:.3f} ms)')
        rows.append({'stage': 'retinaface forward', 'clip': 'frame 0',
                     'frames': 1, 'ms': ms, 'gflop': flops / 1e9,
                     'bound_ms': flops / PEAK_FLOPS * 1e3,
                     'share_of_fp32_peak': flops / PEAK_FLOPS * 1e3 / ms})
        del x0

        mark('detector timed')

        # the faces: detect, warp at 256^2, carry and fallback
        crops = {}
        for name, _, n, h, w in VISUAL_TRIALS:
            drop = {0, 1, n // 2}
            frames = clips[name]

            def run_faces():
                detector = DroppingDetector(det, drop)
                if has_ffmpeg:
                    return faces.process_one_video(
                        f'{videos}/{name}.mkv', f'{faces_root}/{name}',
                        detector, store_jpgs=has_pil)
                return faces.process_frames(
                    iter(frames), f'{faces_root}/{name}', detector,
                    store_jpgs=has_pil)

            def traced_faces():
                faces.process_frames(iter(frames), f'{root}/traced',
                                     DroppingDetector(det, drop),
                                     store_jpgs=False)

            row, got = visual_stage('faces (detect + warp)', name, n,
                                    run_faces, traced_faces)
            rows.append(row)
            if got.shape != (n, 256, 256, 3) or got.dtype != np.uint8:
                fail(f'{name}: faces {got.shape} {got.dtype}')
            for i in (0, 1):
                want = np.clip(np.rint(_resize_bilinear(
                    frames[i].astype(np.float32), 256, 256)), 0, 255)
                if not np.array_equal(got[i], want.astype(np.uint8)):
                    fail(f'{name}: frame {i} is not the resized frame')
            if not np.array_equal(got[n // 2], got[n // 2 - 1]):
                fail(f'{name}: frame {n // 2} did not carry the crop before')
            crops[name] = got

        mark('faces done')

        # the warp, card against CPU, on detections of trial_a
        name = VISUAL_TRIALS[0][0]
        sample = clips[name][2:6]
        dets = [det.detect(f) for f in sample]
        if not all(dets):
            fail(f'{name}: no detection on frames 2-5 at the threshold')
        lms = np.stack([d[0]['landmarks'] for d in dets])
        compare_levels('batched_warp_faces', facealign.batched_warp_faces(
            sample, lms), facealign.batched_warp_faces(sample, lms,
                                                       device='cpu'))

        mark('warp held against the CPU')

        # compaction (jpgs -> video.npy) and recompaction (video_48.npy)
        def run_compact():
            if has_pil:
                compact.main(['--faces_root', faces_root, '--features_root',
                              npy_root, '--ds', 'C-EXPR-DB'])
            else:
                for trial, c in crops.items():
                    faces.compact_video_npy(f'{npy_root}/{trial}', c)

        row, _ = visual_stage('compact', 'both', total, run_compact,
                              host=True)
        rows.append(row)
        row, _ = visual_stage('recompact', 'both', total, lambda:
                              recompact.main(['--features_path', npy_root]),
                              host=True)
        rows.append(row)

        mark('compacted')

        # driver pass 2: cnn.npy and landmark.npy
        was = os.environ.get('FVT_FAN_WEIGHTS')
        os.environ['FVT_FAN_WEIGHTS'] = paths['fan']
        try:
            for part in range(2):
                row, records = visual_stage(
                    f'driver pass 2, part {part}/2', 'shard', shards[part],
                    lambda: run_driver(
                        part, ['--arcface_pth', paths['arcface'],
                               '--landmarks'],
                        lambda: {'arcface': visual.backbone_from_pth(
                            paths['arcface']), 'landmarker':
                            fan.make_full_frame_landmarker()}),
                    host=True)
                check_records(records)
                rows.append(row)
        finally:
            if was is None:
                del os.environ['FVT_FAN_WEIGHTS']
            else:
                os.environ['FVT_FAN_WEIGHTS'] = was

        mark('driver pass 2 done')

        # the merge: each trial once
        info = merge.merge_results(feat, 'C-EXPR-DB', 'train')
        if sorted(info['trial']) != sorted(lengths) or \
                info['length'] != [lengths[t] for t in info['trial']]:
            fail(f'merged dataset_info: {info["trial"]} {info["length"]}')

        # every file's shape, dtype and length against video.npy
        want_files = {'video': ((256, 256, 3), np.uint8),
                      'video_48': ((48, 48, 3), np.uint8),
                      'cnn': ((512,), np.float32),
                      'landmark': ((136,), np.float32),
                      'logmel': ((96, 64), np.float16),
                      'vggish': ((128,), np.float32),
                      'bert': ((768,), np.float32),
                      'EXPR_continuous_label': ((), np.int64)}
        for trial, n in lengths.items():
            for f, (shape, dtype) in want_files.items():
                a = np.load(f'{npy_root}/{trial}/{f}.npy', mmap_mode='r')
                if a.shape != (n,) + shape or a.dtype != dtype:
                    fail(f'{trial}/{f}.npy: {a.shape} {a.dtype}, want '
                         f'{(n,) + shape} {np.dtype(dtype)}')
        print(f'  files of {sorted(lengths)}: {sorted(want_files)} of '
              f'{[lengths[t] for t in sorted(lengths)]} rows, as video.npy')

        # the extractors, timed on trial_a and held against the CPU
        name, n = VISUAL_TRIALS[0][0], VISUAL_TRIALS[0][2]
        video = np.load(f'{npy_root}/{name}/video.npy')
        backbone = visual.backbone_from_pth(paths['arcface'])
        row, cnn = visual_stage('cnn (ArcFace IR-50)', name, n,
                                lambda: visual.extract_cnn_features(
                                    video, backbone))
        rows.append(row)
        written = np.load(f'{npy_root}/{name}/cnn.npy')
        compare_rel('cnn.npy (driver, card) against the extractor', written,
                    cnn)
        compare_rel('cnn.npy', written, visual.extract_cnn_features(
            video, visual.backbone_from_pth(paths['arcface'], 'cpu'),
            device='cpu'))

        mark('cnn held against the CPU')
        fan_card = fan.FANLandmarks(paths['fan'])
        fan_cpu = fan.FANLandmarks(paths['fan'], device='cpu')
        landmarker = fan.make_full_frame_landmarker(paths['fan'])
        row, lm = visual_stage('landmarks (FAN-4)', name, n, lambda: np.stack(
            [landmarker(f) for f in video]))
        rows.append(row)
        written = np.load(f'{npy_root}/{name}/landmark.npy')
        if not (np.isfinite(written).all() and np.isfinite(lm).all()
                and np.abs(lm).max() < 1024):
            fail('landmarks: not finite, or far out of the crop')
        crops_in = []
        for f in video[:FAN_GATE_CROPS]:
            center, scale = fan.bbox_to_center_scale((0, 0, 256, 256))
            c = fan.crop_face(f.astype(np.float32), center, scale)
            crops_in.append(np.clip(np.rint(c), 0, 255) / 255.0)
        hm_card = fan_card.heatmaps(np.stack(crops_in))
        hm_cpu = fan_cpu.heatmaps(np.stack(crops_in))
        compare_rel(f'FAN heatmaps ({FAN_GATE_CROPS} crops)', hm_card, hm_cpu)
        ties = sum(landmark_ties(
            hm_card[i], hm_cpu[i],
            fan.decode_heatmaps(hm_card[i], center, scale),
            fan.decode_heatmaps(hm_cpu[i], center, scale))
            for i in range(FAN_GATE_CROPS))
        print(f'  landmarks of {FAN_GATE_CROPS} crops: card and CPU equal '
              f'but at {ties} argmax or sub-pixel ties')
        au_lms = lm[:FAN_GATE_CROPS]
        got = action_units.batched_au_heatmaps(au_lms, AU_GATE_SIZE)
        want = action_units.batched_au_heatmaps(au_lms, AU_GATE_SIZE,
                                                device='cpu')
        err = float(np.abs(got - want).max())
        print(f'  AU heatmaps {got.shape}: max |card - cpu| = {err:.3e} (atol '
              f'{VISUAL_AU_ATOL})')
        if got.shape != want.shape or err > VISUAL_AU_ATOL:
            fail(f'AU heatmaps differ from the CPU\'s by {err}')

        mark('FAN and AU maps held against the CPU')

        # the detector at DETECT_GATE_SIZE, card against CPU
        det_gate = retinaface.RetinaFaceR50(model=det.model,
                                            max_size=DETECT_GATE_SIZE)
        det_cpu = retinaface.RetinaFaceR50(weights_path=paths['retinaface'],
                                           max_size=DETECT_GATE_SIZE,
                                           device='cpu')
        gate_scores = det_gate.forward(det_gate._prepare(first)[0])[1][0, :, 1]
        check_detector(det_gate, det_cpu, first, float(torch.sort(
            gate_scores).values[-DETECT_ANCHORS - 1]), device)
        del det, det_gate, det_cpu, fan_card, fan_cpu, backbone
    torch.cuda.empty_cache()
    launched = {k: n for k, n in read().items() if n}
    if launched:
        fail(f'the visual chain launched kernels of the port: {launched}')
    wall = time.perf_counter() - t_phase
    print(f'  visual chain rows: {json.dumps(rows)}')
    print(f'  phase 15 in {wall:.1f} s on {card}; no kernel of the port '
          f'launched')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on a GPU',
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')

    from fvt_tpu_torch.data.transforms import eval_video_transform
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.ops.fusion import (fused_multimodal_fusion,
                                          fused_multimodal_fusion_simt)
    from fvt_tpu_torch.ops.tcn import (fused_temporal_block,
                                       fused_temporal_block_simt)
    from fvt_tpu_torch.serve import ServingModel

    device = torch.device('cuda', 0)
    print('phase 1: build')
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f'  {path.relative_to(build.BUILD_DIR.parent)} in '
          f'{time.perf_counter() - t0:.1f} s')
    log = path.with_suffix('.log').read_text().splitlines()
    for line in log:
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('  ' + line.strip())

    model = LFAN(MODALITY, output_dim=7,
                 generator=torch.Generator().manual_seed(SEED)).to(device)

    print('phase 2: kernels vs plain versions '
          f'(rtol={KERNEL_RTOL}, atol={KERNEL_ATOL}; fp32, other '
          f'summation order; weight and bias gradients '
          f'{WGRAD_TOL} of their largest value)')
    kernels = check_kernels(model, device)
    kernels += check_train_kernels(device)
    kernels += check_conv_kernels(device)
    kernels += check_bottleneck_kernel(device)
    print(f'phase 2, bfloat16: the tensor-core conv kernel vs its plain '
          f'version and F.conv2d on bfloat16 tensors, the fused block and '
          f'the Winograd kernel vs their plain versions (|got - want| <= '
          f'{BF16_RTOL} |want| + '
          f'{BF16_ATOL}: one unit in the last place; mean |got - want| <= '
          f'{BF16_MEAN_TOL} mean |want|)')
    kernels.append(check_conv_bf16_kernel(device))
    kernels.append(check_bottleneck_bf16_kernel(device))
    kernels.append(check_winograd_bf16_kernel(device))
    torch.cuda.empty_cache()

    print('phase 3: serving through fvt_tpu_torch.streaming')
    server = ServingModel(model, WINDOW_BATCH, WINDOW, HOP, device)
    streams = make_streams()
    counters = {'tcn_block': fused_temporal_block,
                'tcn_block_simt': fused_temporal_block_simt,
                'fusion': fused_multimodal_fusion,
                'fusion_simt': fused_multimodal_fusion_simt}
    for fn in counters.values():
        fn.launches = 0
    served, dispatches = serve_streams(server, streams)
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f'  {dispatches} dispatches, launches {launches}')
    if dispatches < 1 or launches != {'tcn_block': 12 * dispatches,
                                      'tcn_block_simt': 0,
                                      'fusion': dispatches,
                                      'fusion_simt': 0}:
        fail(f'expected 12 tcn_block, 1 split-TF32 fusion and no SIMT launch '
             f'per dispatch, got {launches} over {dispatches} dispatches')
    by_name = {kernel['name']: kernel for kernel in kernels}
    for name, n in launches.items():
        by_name[name]['launches'] = n

    want = offline_reference(model, streams, device)
    for n in STREAM_LENGTHS:
        got = served[n]
        if got.shape != (n, model.output_dim) or not np.isfinite(got).all():
            fail(f'stream {n}: got {got.shape} logits, finite='
                 f'{np.isfinite(got).all()}')
        err = float(np.abs(got - want[n]).max())
        print(f'  stream {n}: {got.shape} logits, max |served - offline '
              f'plain| = {err:.3e} (atol {SERVE_ATOL})')
        if err > SERVE_ATOL:
            fail(f'stream {n}: served logits differ from the offline '
                 f'reference by {err}')

    rng = np.random.default_rng(SEED + 1)
    inputs = {k: (rng.integers(0, 256, s['shape'], np.uint8)
                  if s['dtype'] == 'uint8'
                  else rng.standard_normal(s['shape'], np.float32))
              for k, s in server.specs.items()}
    time_dispatches('fp32 default', server, inputs)
    frames = WINDOW_BATCH * WINDOW
    video = torch.from_numpy(inputs['video']).to(device)
    crops = eval_video_transform(video).reshape(frames, 40, 40, 3)
    with torch.inference_mode():
        backbone_ms = median_ms(lambda: model.spatial.visual(crops))
    print(f'  ArcFace IR-50 alone on {frames} frames: {backbone_ms:.2f} ms')
    del server, video

    print(f'phase 4: training {"+".join(TRAIN_MODALITY)} through Trainer')
    train_launches = train_lfan(device)
    for name, n in train_launches.items():
        by_name[name]['launches'] = n
    print(f'phase 4, mfcc: training {"+".join(MFCC_MODALITY)} through '
          f'Trainer, fused against plain')
    train_mfcc_lfan(device)

    print('phase 5: the ArcFace backbone\'s conv paths, alone and served')
    launches = backbone_variants(model, crops, device)
    by_name['conv3x3']['launches'] = launches['conv3x3_fp32']
    by_name['conv3x3_simt']['launches'] = launches['conv3x3_simt']
    by_name['winograd_simt']['launches'] = launches['winograd_simt']
    by_name['bottleneck_simt']['launches'] = launches['bottleneck_simt']
    by_name['bottleneck']['launches'] = serve_variant(
        model, {'fused_blocks': True}, 'bottleneck', 21, streams, device,
        by_type={'bottleneck_fp32': 21})[0]
    _, fused = serve_variant(
        model, {'fused_blocks': True, 'conv_impl': 'shifted_kernel'},
        'bottleneck', 21, streams, device,
        by_type={'conv3x3': 3, 'conv3x3_fp32': 3, 'bottleneck_fp32': 21})
    by_name['winograd']['launches'], winograd = serve_variant(
        model, {'conv_impl': 'winograd_kernel'}, 'winograd', 45, streams,
        device, by_type={'winograd_fp32': 45})
    # the fp32 shifted_kernel LFAN (the split-TF32 kernel) served, then
    # the three split-TF32 LFANs timed against the default in turns
    _, shifted = serve_variant(
        model, {'conv_impl': 'shifted_kernel'}, 'conv3x3', 45, streams,
        device, by_type={'conv3x3_fp32': 45})
    servers = {'cudnn': ServingModel(model, WINDOW_BATCH, WINDOW, HOP,
                                     device), 'shifted_kernel': shifted,
               'fused_blocks+shifted_kernel': fused,
               'winograd_kernel': winograd}
    turns = list(servers)
    for impl in turns + turns[::-1]:
        time_dispatches(f'fp32 backbone, {impl}', servers[impl], inputs)
    del servers, shifted, fused, winograd

    print('phase 5, bfloat16: the backbone in bfloat16 (fvt_tpu\'s --amp), '
          'alone and served')
    launches = backbone_bf16(model, crops, device)
    by_name['conv3x3_bf16']['launches'] = launches['conv3x3_bf16']
    print(f'  bf16 winograd_kernel: {launches["winograd_bf16"]} launches of '
          f'the bfloat16 Winograd kernel a forward')
    del crops
    # served logits of the kernel path against the offline stitch of the
    # same model's plain versions.  The tolerance is derived as the
    # embeddings': BF16_PATHS_APART times bfloat16's own distance from
    # float32 at the logits, which is the bf16 cudnn model's offline logits
    # against the fp32 model's (`want`)
    from fvt_tpu_torch.models.models import LFAN
    bf16 = {'backbone_dtype': torch.bfloat16}
    servers = {}
    for impl in ('cudnn', 'shifted_kernel'):
        variant = LFAN(MODALITY, output_dim=7, conv_impl=impl, **bf16)
        variant.load_state_dict(model.state_dict(), strict=True)
        servers[impl] = ServingModel(variant, WINDOW_BATCH, WINDOW, HOP,
                                     device)
    offline = offline_reference(servers['cudnn'].model, streams, device)
    own = max(float(np.abs(offline[n] - want[n]).max())
              for n in STREAM_LENGTHS)
    serve_tol = BF16_PATHS_APART * own
    print(f'  max |bf16 cudnn offline - fp32 offline| over the streams\' '
          f'logits = {own:.3e}; the tolerance of the bf16 serving check is '
          f'{BF16_PATHS_APART} of it, {serve_tol:.3e}')
    serve_variant(model, {'conv_impl': 'shifted_kernel', **bf16}, 'conv3x3',
                  45, streams, device, atol=serve_tol,
                  by_type={'conv3x3_bf16': 45})
    # the bfloat16 fused blocks served: 21 block launches and 3 conv
    # launches a dispatch, all bfloat16
    by_name['bottleneck_bf16']['launches'], servers['fused_blocks'] = \
        serve_variant(model, {'conv_impl': 'shifted_kernel',
                              'fused_blocks': True, **bf16}, 'bottleneck',
                      21, streams, device, atol=serve_tol,
                      by_type={'bottleneck_bf16': 21, 'conv3x3': 3,
                               'conv3x3_bf16': 3})
    # the bfloat16 Winograd kernel served: 45 launches a dispatch
    by_name['winograd_bf16']['launches'], servers['winograd_kernel'] = \
        serve_variant(model, {'conv_impl': 'winograd_kernel', **bf16},
                      'winograd', 45, streams, device, atol=serve_tol,
                      by_type={'winograd_bf16': 45})
    turns = ['cudnn', 'shifted_kernel', 'fused_blocks', 'winograd_kernel']
    for impl in turns + turns[::-1]:
        time_dispatches(f'bf16 backbone, {impl}', servers[impl], inputs)
    del model, servers
    torch.cuda.empty_cache()

    print('phase 6: challenge inference from the on-disk store through '
          'fvt_tpu_torch.inference_challenge')
    for name, n in challenge_inference(device).items():
        by_name[name]['launches_challenge'] = n

    print(f'phase 7: training {"+".join(TRAIN_MODALITY)} through '
          f'fvt_tpu_torch.main on a C-EXPR-DB store, {RUN_EPOCHS} epochs '
          f'with checkpoints, then resumed to {RESUMED_EPOCHS}')
    for name, n in training_run(device).items():
        by_name[name]['launches_train_run'] = n

    print(f'phase 8: training {"+".join(MODALITY)} (the paper\'s default '
          f'LFAN) through fvt_tpu_torch.main from a {TRI_VIDEO_HW}^2 store, '
          f'fp32 with a resume and --amp')
    for name, n in tri_modal_training(device).items():
        by_name[name]['launches_tri_modal'] = n

    print(f'phase 9: CAN, JMT and MT trained through fvt_tpu_torch.main '
          f'({FAMILY_EPOCHS} epochs on phase 8\'s store) and served through '
          f'fvt_tpu_torch.inference_challenge (phase 6\'s store)')
    for name, n in fusion_families(device).items():
        by_name[name]['launches_families'] = n

    print(f'phase 10: the logmel modality (the frozen VGGish) trained '
          f'through fvt_tpu_torch.main (LFAN fp32 with a resume and --amp, '
          f'CAN) and served through fvt_tpu_torch.inference_challenge')
    for name, n in logmel_training(device).items():
        by_name[name]['launches_logmel'] = n

    print(f'phase 11: the regression task: RegressionTrainer.fit of a '
          f'{"+".join(TRAIN_MODALITY)} LFAN, {REG_EPOCHS} epochs with a '
          f'ParamControl release and a resume, then test and predict')
    launches = regression_training(device)
    for name in ('tcn_block', 'fusion', 'tcn_block_train', 'tcn_block_bwd'):
        by_name[name]['launches_regression'] = launches[name]

    print('phase 12: LFAN, CAN and JMT served from frozen .fvtserve '
          'artifacts over HTTP (tools/export_serving.py, '
          'tools/serve_http.py, client.py), and TemporalConvNet('
          'attention=1)')
    t0 = time.perf_counter()
    launches, attn = artifact_serving(device)
    for name in ('tcn_block', 'fusion'):
        by_name[name]['launches_artifact'] = launches[name]
    for name, n in attn.items():
        by_name[name]['launches_attention'] = n
    print(f'  phase 12 in {time.perf_counter() - t0:.1f} s')

    print('phase 13: int8 serving (--serve_quant int8 | int8_static) on the '
          'quantise and s8 conv kernels, bfloat16-feature serving and '
          '--profile_epochs')
    t0 = time.perf_counter()
    int8 = check_int8_kernels(device)
    kernels += int8
    by_name.update((kernel['name'], kernel) for kernel in int8)
    for name, n in int8_serving(device).items():
        by_name[name]['launches'] = n
    print(f'  phase 13 in {time.perf_counter() - t0:.1f} s')

    print('phase 14: the offline audio features on the card: log-mel '
          'patches and VGGish embeddings through fvt_tpu_torch.preprocess, '
          'MFCC and eGeMAPS on the host')
    audio_chain(device, card)

    print('phase 15: the offline visual preprocessing and the feature '
          'driver on the card: RetinaFace-R50, the 5-point warp, FAN-4 '
          'landmarks, ArcFace cnn.npy, compaction and the sharded driver '
          'with its merge')
    visual_chain(device, card)

    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
