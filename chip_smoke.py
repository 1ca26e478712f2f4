#!/usr/bin/env python3
"""Smoke test of the PyTorch port (casmtr_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

It drives the ported recipes outdoor_casmtr_4c and outdoor_casmtr_2c, the
flagship's ResNetFPN variant of 4c (RESNET: the backbone of
__graft_entry__._flagship_cfg(backbone="resnet")), the plain QuadtreeLoFTR
recipe quadtree_baseline (BASELINE: ResNetFPN_8_2, gray, eight quadtree
layers, no cascade), the indoor recipe indoor_casmtr_4c_runnable
(INDOOR: ResNetFPN_8_4_2, eight quadtree layers, POLA self layers and
relative-PE cross layers at 1/4, served at bucket 640 and trained at 640^2)
and the published indoor_casmtr_4c as the PMT-refine model (REFINE:
build_model(..., refine=True), a frozen gray quadtree trunk of 128 / [128,
196, 256], a ladder side network of 64 / 128 in RGB, the indoor 1/4 stack
and fine heads; bucket 640, 640^2), and the model zoo's three
configurations (phase 11), at full width.  Phases, each printing its own
lines and its seconds:

1. Environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA and numpy versions (utils/metrics.error_auc needs numpy 2's
   trapezoid), and the build of the CUDA kernels from csrc/ with nvcc.
2. Kernels: each CUDA kernel of the serving path against its plain PyTorch
   version on the card, at the shapes of the 832^2 eval with realistic
   indices (a real top-k, real window corners), in float32 with TF32 off:
   A at the finest 104^2 level (and at 52^2, beside A′), A′ at the
   intermediate 52^2 level (K = 32, top 16), B and C at the 1/4 level
   (208^2, C=128, H=4) and at 2c's 1/2 level (416^2, C=64, H=2); max abs
   error <= 1e-4.  A′ is held to its plain version by message (and LSE)
   within 1e-4, sorted top-k scores within 1e-5, equal index sets wherever
   the plain version's k-th and (k+1)-th scores are more than 1e-5 apart
   (near ties counted and printed), and the next level's message from both
   index sets within 1e-4 on those rows; A′ also on rows that hold a NaN
   (no fault, the NaN passed on, the other rows as the plain version).
   Kernel and plain version are timed with CUDA events (median of 25
   launches, L2 flushed before each, the card held busy while the host
   enqueues the call), beside the least time the card needs
   for the same work and a library yardstick, one PyTorch call on inputs
   gathered beforehand (gather not timed; checked against the plain
   version first): scaled_dot_product_attention, pinned to its
   memory-efficient backend (float32), over the gathered windows for A and
   C, torch.matmul against the gathered patch for B; A′ also beside the
   unfused route (kernel A plus a plain top-k selection).  Then the
   bf16-input instances of A, A′ and C (the card's eval default) at the
   same shapes on the inputs rounded to bf16, against their plain versions
   on the same bf16 values (f32 arithmetic; message within 1e-4, A′ as
   above), the yardstick SDPA on the bf16 windows and the bound's
   multiply-adds at the bf16 tensor-core rate; every bf16 instance of A
   and A′ (QUADTREE_BF16_CASES) and of C (WINDOW_BF16_CASES: other H and D,
   inputs 4 bytes off, edge corners, w = 1, a batch of two), each case also
   through the bf16 instances of A-bwd and C-bwd (below); and the
   refusals: an odd width and inputs 2 bytes off raise before any launch
   in A, A′, C, A-bwd and C-bwd.  Then A (104^2, K = 8) and A′ (52^2,
   K = 16, top 8) at quadtree_baseline's 832^2 shapes and A (80^2, K = 16),
   A′ (40^2, K = 32, top 16) and B (160^2) at the indoor recipe's 640^2
   shapes, A and A′ also through their bf16 instances.
3. Training kernels: the same at the shapes of the 704^2 training step for
   the forward kernels with their log-sum-exp output and for the three
   backward kernels (A-bwd at 88^2 and 44^2; B, B-bwd, C and C-bwd at 176^2
   and at 2c's 352^2; the yardstick of A-bwd and C-bwd is the backward of
   the forward's).  dq within 1e-4; the atomically summed dk, dv and
   dfeat1 within 1e-4 x max(1, max |plain|).  C and C-bwd also at 176^2 on
   corners whose patches run past the grid edge or are negative (the flat
   clipped-gather rule), against the plain versions, and through their
   public wrappers on tiny cases that take every instance of the two
   kernels (WINDOW_CASES: other H and D, misaligned inputs, w = 1, a batch
   of two); likewise B and B-bwd (SCORE_CASES: other C, misaligned inputs,
   several channel blocks, w = 1 and 9, corners past the edge under the gather
   and the scatter rule, a batch of two) and A, A′ and A-bwd through their public wrappers and
   launchers (QUADTREE_CASES: other H and D, misaligned inputs, K = 1,
   n_topk 1 and 4K, repeated ids, ids outside the block grid, a batch of
   two).  Then the bf16 instances of A-bwd (88^2, 44^2) and C-bwd (176^2
   H=4, 352^2 H=2) on inputs rounded to bf16, against their plain versions
   on the same bf16 values (f32 outputs; dq within 1e-4, dk and dv within
   1e-4 x max(1, max |plain|)), the bound's multiply-adds at the bf16
   tensor-core rate, the yardstick the backward of SDPA on the bf16
   windows; on every QUADTREE_BF16_CASES / WINDOW_BF16_CASES case the bf16
   A-bwd / C-bwd against their plain versions as above, and the gradients
   of the public wrappers through the bf16 instances (rounded to bf16)
   against the f32 instances' on the widened values, within (2^-8 + 1e-4)
   x max(1, max |f32 gradient|) (a finite difference in bf16 says
   nothing).  Then each autograd function on the card at a tiny shape: its
   kernel gradient against a central finite difference of its kernel
   forward along a random direction (float32 forward, so within 1e-2
   relative).  Then A with its log-sum-exp, A′ through its autograd
   function and A-bwd at both fine levels (f32 and bf16) of
   quadtree_baseline's 704^2 step (88^2 K = 8, 44^2 K = 16) and of the
   indoor recipe's 640^2 step (80^2, 40^2), and B and B-bwd at 160^2.
4. Serving: Matcher(recipe, bucket=832) at full width on the card with
   seeded random weights answers three requests (textured images and
   shifted copies, one non-square), for 4c and then 2c, first in the
   card's eval default (bf16 backbone and stacks, bf16 kernel inputs), then
   with CASMTR_BACKBONE_BF16=0 CASMTR_TRANSFORMER_BF16=0 (float32), from
   the same weights.  The kernels' launch counts are zeroed just before
   each precision's requests and read after each request; each must match
   the recipe's count per pair: in bf16 the bf16 instances A 12, A′ 12, C 4
   (4c) or 8 (2c) and no f32 A, A′ or C; in float32 the f32 ones and no
   bf16 instance; B (float32 in both) 2 or 4.  Steady latency and peak
   memory per precision.  The ResNetFPN variant answers the same requests
   in the card's default, with 4c's counts.  quadtree_baseline (A 16,
   A′ 16 per pair) and the indoor recipe at bucket 640 on 640x480 frames
   (A 16, A′ 16, B 2; its cross layers take the relative-PE gather path,
   so C 0) answer in both precisions; so does the refine model, through
   the Matcher's canvas, masks and selection around it (A 16, A′ 16, B 2;
   in training too the frozen trunk runs its eval forward, so its A and A′
   are the eval instances).
5. Profile: one more steady request of each recipe in each precision under
   torch.profiler (device busy share, device time by operator and by
   kernel); of quadtree_baseline and the indoor recipe in bf16 only.
6. Reference: each full-width recipe at bucket 256 with its match
   thresholds at 0, on one pair: the card with float32 forced against the
   CPU (plain versions) -- coarse and window confidences and final matches
   must agree as before; and the card's bf16 default against the CPU with
   both variables at 1 (bf16 stacks, f32 kernel inputs, the JAX package's
   CPU graph): at every stage, common confidences within max(5e-2, 1.5x)
   and, at stages of 20 matches or more, Jaccard at least min(0.9, its) -
   0.1, of the CPU's own bf16-against-f32 difference.  Likewise
   quadtree_baseline (no window confidences) and the indoor recipe.
7. Training: train_step on each recipe and the ResNetFPN variant at
   704^2, batch 1, full width and depth, seeded random weights, on a pair
   whose image1 is a shifted crop of image0 with the matching camera
   translation, first in the card's default (bf16 backbone and kernel
   inputs, float32 stacks: per step the bf16 instances A 12, A′ 12, A-bwd
   24, C 4 and C-bwd 4 per cascade level, no f32 A, A′, A-bwd, C or C-bwd)
   and then with float32 forced (the f32 instances, no bf16 one); B and
   B-bwd (float32 in both) 2 and 1 per cascade level.  One warm-up step
   and 4 timed steps, each with the launch counts zeroed just before and
   read just after; finite losses, matches to supervise at every cascade
   level, parameters that moved, nonzero finite gradients on the q/k/v
   projections that go through kernels A, A′ and C.  Then one more step
   under torch.profiler, per precision.  quadtree_baseline at 704^2 (per
   step A 16, A′ 16, A-bwd 32) and the indoor recipe at 640^2 (also B 2,
   B-bwd 1, no C) likewise; their profiled step in bf16 only.  The refine
   model at 640^2 likewise (A 16, A′ 16, B 2, B-bwd 1, no A-bwd: its trunk
   is frozen), and after its steps every trunk parameter and BatchNorm
   buffer must be bit-identical to its value before them.
8. Training reference: one step at 256^2 on the card and on the CPU from
   the same weights and batch.  With float32 forced on both (each recipe
   and the ResNetFPN variant): loss within 1e-4 relative, cosine of the
   whole flattened gradients >= 0.999; a loss term may differ by up to 10x
   its largest response on the CPU to two nudges of the images by 1e-6
   relative, where that is larger (a random model's discrete choices, the
   quadtree's top-k and the supervised matches at the threshold 1/Kw, can
   flip under float32 rounding).  For each
   recipe also the card's bf16 default against the CPU with
   CASMTR_BACKBONE_BF16=1 (bf16 backbone, f32 kernel inputs): each loss
   term within max(2e-2, 4x the CPU's own bf16-backbone-against-f32
   relative difference of that term), 1 - gradient cosine within
   max(1e-3, 4x the CPU's own).  quadtree_baseline and the indoor
   recipe are ResNetFPN-based as the variant: their whole f32 step is
   printed with the CPU's response to a nudge, their backbone gated as the
   variant's, and the indoor 1/4 stack alone (POLA and the relative-PE
   gather path) as the recipes' cascade stacks.  The refine model as the
   indoor recipe, its ladder (in train mode, on the trunk's maps taken once
   on the CPU) gated in place of the backbone.
9. Detector: one 4c step at 256^2 with the learnable keypoint-detector
   head and the ST detector on its 1/4 level (loss_4c_det printed), and
   the head alone on the tokens it took there, card f32 against CPU f32.
10. Checkpoints and staged training, in a temporary directory.  Serving:
   outdoor_casmtr_4c at bucket 832 with seeded random weights in memory;
   its state dict written as a reference-format .ckpt ("matcher."
   prefix), converted by casmtr_tpu_torch.cli.convert into a port
   checkpoint directory; Matcher(ckpt=file) and Matcher(ckpt=directory),
   built from another seed, must hold every parameter and buffer
   bit-identical to the in-memory Matcher's, answer phase 4's requests in
   the card's default with its per-pair launch counts, and give
   bit-identical coarse and window confidences and final matches (else
   the difference is printed and the three are held to phase 6's f32
   gates with float32 forced); then the first request's latency in a
   fresh process (this script with --first-request) without and with
   Matcher.warmup().  Staged training: outdoor_casmtr_2c at 704^2, batch
   1, full width, in the card's default, on phase 7's shifted pair, stage
   1 (the 1/8 stage alone), then stages 2 (plus the 1/4 level, no fine
   stage) and 3, each a fresh model of its stage resumed by
   cli.train.resume_state from the checkpoint (train.checkpoints.
   CheckpointManager) the stage before saved, then a same-stage resume at
   stage 3; per stage one warm-up step and 2 timed steps with the launch
   counts zeroed just before and read just after each (per step: stage 1
   the bf16 A 12, A′ 12, A-bwd 24 and nothing else; stage 2 also C 4,
   C-bwd 4, B 2, B-bwd 1; stage 3 as phase 7's 2c), finite losses of
   exactly the stage's terms, the kernel-path q/k/v projections moved,
   s/step and peak memory; after each resume the restored tensors
   bit-identical to the checkpoint and the new ones to their seeded init,
   each group's learning rate at the first resumed step the schedule's at
   the restore step ('new' restarting its warmup, STAGE_TRAINER), and on
   the same-stage resume the optimizer moments and Adam count
   bit-identical to the checkpoint's.
11. The model zoo (ZOO): three published recipes with two orthogonal
   switches each, at full width with seeded random weights.  Z1:
   outdoor_casmtr_4c with 'local_global' self layers at 1/4
   (DoubleGroupBlock, sr_ratio 4) and the 'dilated1' propagation at
   dilation 2 (the cascade gather paths: no B, no C); Z2:
   outdoor_casmtr_4c with 'LKA' self layers and the 1/8 stack's relative
   PE (its levels take the plain gather path: no A or A′ from the 1/8
   stack); Z3: outdoor_casmtr_2c with 'topk' self layers at 1/4 (Guided
   quadtree attention on the top 16 of the 1/8 cycle top-k, one level:
   kernel A, A-bwd in training) and 'linear' self layers at 1/2.  First
   kernel A at Z3's Guided shapes (208^2 K = 16 H = 4, and with its
   log-sum-exp and A-bwd at 176^2), f32 and bf16, against the plain
   versions as in phases 2 and 3, and the plain paths of Z1 (the dilated
   cross attention and window scores) and Z2 (attention B with the 1/8
   relative bias) timed beside the kernels of the recipes' own paths on
   the same grids (zoo_plain_paths).  Then per model: serving at bucket
   832 in the card's default, a warm request and two timed ones, each held
   to the per-pair count (Z1 A 12 / A′ 12 and no B or C, Z2 B 2 / C 4 and
   no A or A′, Z3 A 16 / A′ 12 / B 4 / C 8), and one more profiled; the
   serving reference of phase 6; training at 704^2 in the card's default,
   a warm-up step and two timed ones, each held to the per-step count (Z3
   also A-bwd 28), and one more profiled, with
   finite nonzero gradients on the new modules' parameters (the global
   block's sr and kv projections, the LKA convs, the 1/8 bias tables, the
   Guided layers' q/k/v) and the LKA BatchNorm statistics moved at every
   step; one f32 step at 256^2 on the card against the CPU, each loss
   term within 1e-4 relative (or 10x its largest response on the CPU to
   two nudges of the images by 1e-6, where larger) and the whole
   gradient's cosine >= 0.999.
12. The test-time filters and the evaluation.  (a) FILTERS on every
   cascade level (F1 local_window_nms window 4 top 2, F2 softargmax_nms
   window 5 stride 1, F3 window 4 stride 4, F4 d2d window 5, F5 sift, F6
   maxpool_nms window 5 with the rt 0.8 and rd 0.05 gates): 4c with each,
   2c with F4 and F6, phase 4's weights at bucket 832 in the card's
   default; per model three requests held to the recipe's per-pair
   launch counts (the filters launch no kernel; steady latency, peak
   memory), then the padded non-square request's filter chains captured
   and recomputed on the card and on the CPU from the same tensors with
   every threshold at 0: F1 and F6 bit-equal, F2-F5 differing only where
   the deciding value lies within 1e-4 of its boundary (relative for
   sift's responses), at most 0.1% of the positions; the detector reads
   the canvas's valid mask; phase 6's f32 reference at bucket 256; then
   each filter's chain timed at 208^2 and 416^2 (sift on the 832^2
   image).  (b) sfm.pose.estimate_pose_batch at B 8, M 8192, 512
   hypotheses on synthetic scenes with 0.3 px noise and 30% outliers:
   every pair ok, the CPU on the same draw within 0.1 degrees of the
   card, the poses whose inliers hold half the true matches (at least
   half the pairs) within 1 / 2 degrees of the true R / t, ms per
   batch.  (c)
   cli.evaluate.run_eval of 4c on 8 pairs of a textured plane at 832^2
   (known K, R, t) through the port's DataLoader: launches 8 x 4c's per
   pair, the AUC and precision finite (printed: random weights), pairs/s.
13. Files (the committed fixtures of scripts/make_port_io_fixtures.py under
   tests/data/port_io: small decode cases, a MegaDepth-layout scene of 4
   views at 1200x800 with h5 depth, a ScanNet-layout scene of 3 frames at
   1296x968 with 16-bit PNG depth).  (a) The host library built from
   csrc/host/ with c++; every manifest entry decoded by data/codecs and
   held bit-equal to cv2.imread's or h5py's result (sha256), the
   progressive JPEG refused; median ms per image of the decodes (the depth
   h5 also as h5py writes it by default, contiguous) and of the two
   resizes.  (b) cli.evaluate.main of 4c with megadepth_test_1500 on the
   MegaDepth-layout scene listed 4 times (24 pairs) in the card's default
   after a one-pair warm-up: its JSON, pairs/s beside phase 12's run_eval
   on arrays, the loader's share of the steady state (the pairs after its
   workers and prefetch have run out), launches 24 x 4c's per pair.  (c)
   cli.train.main of 4c with megadepth_trainval_704 on that scene, its
   depth files rewritten as h5py writes them by default (contiguous, as
   the real ones): 32 steps with 4 loader threads, a sanity validation of
   1 pair and a validation of 2 (launches 32 x per step + 3 x per pair),
   finite losses, ground-truth coarse matches at every step, the
   checkpoints and config.json written, step_s and data_s over steps 9-32
   beside phase 7's bf16 step, the loader alone in samples/s at 1 and 4
   threads on both depth layouts; then --resume on the committed files
   for 4 more steps (the step count continues to 36); then 2
   steps of the indoor recipe with scannet_trainval on the ScanNet-layout
   scene.  (d) Matcher.match on two image paths bit-identical to
   Matcher.match on the arrays data/io._imread gives for them (thresholds
   at 0).
14. Structure from motion (sfm/, cli/reconstruct.py).  (a) The card
   against the CPU: bundle adjustment, dense and CG, on
   tests/test_sfm.make_problem (C 4, P 60; numpy copies of the JAX tests'
   generators, projected in float64) within 1e-3 (the final cost
   relative, rotations, translations over their norm: the monocular scale
   is a near-null direction); reconstruct_sequence on
   tests/test_sfm_pipeline.synth_sequence (5 frames at 0.3 px, PGO) on one
   draw of the pose solver made on the CPU: keyframes, pairs and tracks
   identical, final rotations, similarity-aligned centres and cost within
   1e-3.  (b) scripts/sfm_scale_bench.py --big's 200-frame, 64000-point
   sequence (SFM_SEQ: fx 900, a pure lateral track, 0.3 px, every frame a
   keyframe, overlaps (1, 2), the device solver, PGO, quant 0.25, 25 BA
   iterations) on the card under the script's gate (rms < 2 px, ATE < 0.05
   x 200 x 0.35): rms, ATE and the chain init's, points and observations,
   the wall split by stage (matching, pose, chain, PGO, tracks, problem,
   BA), BA ms per LM iteration, the host's waits for the device, peak
   memory.  (c) bench_sharded_cg's problem on one card (C 240, P 56000,
   tracks of 8, 12 LM iterations of at most 60 CG steps) under its gate
   (rms < 1 px, ATE under half the init's), and one more LM iteration
   under torch.profiler (device time against wall, top operators).  (d) cli.reconstruct.main on
   the fixture's four MegaDepth-layout frames with their intrinsics, 4c
   at 640 in the card's default with seeded random weights and zero
   thresholds: the report (the JAX command's keys) and the PLY, the launch
   counts held to (matched pairs) x 4c's per pair, every kernel launch of
   the first matched pair (its non-square, masked 1/8 and 1/4 grids)
   held against its plain version on the captured inputs within 1e-4, s
   per pair, the ATE against the fixture's poses printed.

The line before the last is one JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.  Exits non-zero, without those lines, when
CUDA is unavailable or any phase fails.
"""

import contextlib
import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL_TOL = 1e-4   # f32, another summation order than the plain version
SCORE_TOL = 1e-5    # A′'s top-k probabilities, sorted
TIE_GAP = 1e-5      # A′ rows whose k-th and (k+1)-th scores are this close
                    # may select either candidate: excluded from the index
                    # checks, and counted
CONF_TOL = 1e-4     # match confidences, card vs CPU (f32, TF32 off)
PX_TOL = 1e-2       # final keypoints in pixels, card vs CPU
MIN_JACCARD = 0.99  # final match sets, card vs CPU (near-ties may flip)
# card bf16 vs CPU bf16 stacks, per stage, held to the CPU's own bf16
# against f32 difference (the scale of bf16 rounding there): common
# confidences within max(BF16_CONF_TOL, BF16_NOISE x its error); at stages
# of at least BF16_MIN_MATCHES matches, Jaccard at least min(BF16_MIN_JACCARD,
# its Jaccard) - BF16_JACCARD_SLACK
BF16_CONF_TOL = 5e-2
BF16_MIN_JACCARD = 0.9
BF16_JACCARD_SLACK = 0.1
BF16_NOISE = 1.5
BF16_MIN_MATCHES = 20
LIBRARY_BF16_TOL = 2e-2  # SDPA on bf16 windows rounds P and its output to
                         # bf16: its check against the f32 plain message
BF16_GRAD_TOL = 2.0 ** -8  # a bf16 autograd function's gradients (rounded
                           # to bf16) against the f32 kernel's on the
                           # widened values, of the largest gradient
FD_EPS = 1e-3       # finite-difference step along a unit-variance direction
FD_TOL = 1e-2       # relative: the kernels' float32 outputs round at 1e-7
TRAIN_LOSS_RTOL = 1e-4   # one training step, card vs CPU: each loss term
MIN_GRAD_COS = 0.999     # flattened gradients, card vs CPU
# The gradient of loss_8c on the kernel-path q/k/v projections of the 1/8
# stack (coarse_gradient): the gradients of kernel A-bwd (through A and
# A′), reached by no later stage's discrete choices; in f32 its cosine >=
# MIN_GRAD_COS.  Each cascade stack (kernels C and C-bwd) alone on the
# inputs it took in the CPU's f32 step, with a seeded cotangent of its
# outputs (cascade_stack_reference): no discrete choice inside.  In f32,
# card vs CPU, outputs within BACKBONE_RTOL of their largest value and the
# q/k/v gradients' cosine >= MIN_GRAD_COS; the card's bf16 q/k/v against
# the CPU's f32 ones (the CPU has no bf16 tables), outputs within
# BF16_STACK_RTOL by RMS (one bf16 rounding of every value) and the same
# cosine bound.
BF16_STACK_RTOL = 2.0 ** -8
# The ResNetFPN variant's step at 256^2 with random weights is held at its
# backbone: its quadtree's top-k picks in the 1/8 stack flip under a nudge
# of NUDGE of its images (the CPU's response is printed), so its whole step
# is printed, not gated.  The backbone in train mode in f32, card vs CPU:
# maps (of their largest value), running statistics and the maps' product
# with a seeded cotangent within BACKBONE_RTOL, gradient cosine >=
# MIN_GRAD_COS (the worst per-leaf error is printed, not gated: a
# BatchNorm bias's gradient under a random cotangent is a sum that largely
# cancels, so its relative error follows the summation order).
NUDGE = 1e-6
BACKBONE_RTOL = 1e-4
# the card's bf16 training default against the CPU with a bf16 backbone,
# held to the CPU's own bf16-against-f32 difference: each loss term within
# max(BF16_LOSS_RTOL, BF16_TRAIN_NOISE x its relative difference), and
# 1 - gradient cosine (whole, and coarse_gradient's) within max(1 -
# MIN_GRAD_COS, BF16_TRAIN_NOISE x its 1 - cosine); the variant's backbone
# (maps by RMS, running statistics, the cotangent product, 1 - cosine)
# within BF16_TRAIN_NOISE x the CPU's own.  Two roundings (the card's bf16
# kernel inputs and backbone against the CPU's backbone) each of the CPU's
# own scale, times 2 for a scale read from one sample; the floor is a
# cascade loss's move when one of its ~50 supervised matches flips at 256^2
BF16_TRAIN_NOISE = 4.0
BF16_LOSS_RTOL = 2e-2
# the reference's own GPU training step, 704^2, fp16: its cascade-free
# quadtree step (bench.py, BASELINE.md), quadtree_baseline's architecture
REFERENCE_S_PER_STEP = 1.19
# phase 12: a continuous filter's keep mask (soft-argmax, d2d, sift), card
# against CPU from the same tensors, may differ only at positions whose
# deciding value lies within NEAR_TOL of its boundary (relative to the
# value for sift's Hessian responses, whose scale is the image's), and at
# no more than MAX_FLIP_SHARE of the positions
NEAR_TOL = 1e-4
MAX_FLIP_SHARE = 1e-3
# the batched pose solver: B pairs, M matches (4c's final capacity), the
# hypotheses, 30% outliers among matches with 0.3 px noise.  Every pair
# ok, card against CPU on the same draw within POSE_CARD_CPU_DEG; within
# POSE_R_DEG / POSE_T_DEG of the truth every pose whose inliers hold at
# least POSE_SUPPORT of the true matches, and at least half the pairs so
# supported.  (At this outlier share and noise the hypotheses, 8-point
# fits of 8 noisy matches, often find too few inliers: the JAX package's
# own solver, on the same scenes with its own draw, left 3 of the 8 pairs
# at 32-2184 inliers of 5734 and 2.3-3.6 degrees of t error; float64
# gives the port the same.)
POSE_B, POSE_M, POSE_HYP = 8, 8192, 512
POSE_OUTLIERS, POSE_NOISE_PX = 0.3, 0.3
POSE_R_DEG, POSE_T_DEG, POSE_CARD_CPU_DEG = 1.0, 2.0, 0.1
POSE_SUPPORT = 0.5
# run_eval: pairs of a textured plane at the bucket's size
EVAL_PAIRS, EVAL_SIZE = 8, 832
# phase 14: card against CPU on the JAX tests' scenes (final BA cost
# relative, rotations and gauge-free translations / aligned centres)
SFM_COST_RTOL, SFM_POSE_ATOL = 1e-3, 1e-3
# (b) scripts/sfm_scale_bench.py --big's sequence (bench_sequence(200,
# P=64000, fx=900, full_span, overlaps (1, 2), ba_iters 25, pan_rate 0,
# y_half 2, y_rate 0, the device solver, quant 0.25), noise 0.3 px, with the
# script's gate (rms < 2 px, ATE < 0.05 x frames x 0.35); (c) its
# bench_sharded_cg problem on one device (C 240, P 56000, tracks of 8, 12
# LM iterations of at most 60 CG steps), gate rms < 1 px and ATE under
# half the init's
SFM_SEQ = dict(n_frames=200, P=64000, fx=900.0, full_span=True,
               pan_rate=0.0, y_half=2.0, y_rate=0.0, noise=0.3)
SFM_SEQ_RUN = dict(overlaps=(1, 2), ba_iters=25, quant=0.25, pgo=True)
SFM_BA = dict(C=240, P=56000, track_len=8)
SFM_BA_RUN = dict(iters=12, solver="cg", cg_iters=60)
SFM_RESIZE = 640
SFM_REPORT_KEYS = ("n_frames", "keyframes", "n_pairs", "n_matches",
                   "n_tracks", "n_obs", "ba_cost", "rms_reproj_px_rho",
                   "poses")
# phase 11's training reference: a loss term may also differ by up to this
# many times its largest response on the CPU to two nudges of NUDGE of the
# images (a random model's discrete choices flip under float32 rounding)
NUDGE_FACTOR = 10.0
# the detector branch's check (detector_phase): 4c's 1/4 level with the
# learnable head and the straight-through detector
DETECTOR = {"detector": "learnable", "detector_mode": "ST", "grid_size": 4}

HOLD_CYCLES = 1_000_000  # about 0.5 ms of the card's clock: longer than the
                         # host takes to enqueue one kernel wrapper

# H100 SXM published peaks: HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores and dense bf16 FLOP/s on them, at the full 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# the environment variables that force the stacks' precision
PRECISION_ENV = ("CASMTR_BACKBONE_BF16", "CASMTR_TRANSFORMER_BF16")

RECIPES = ("outdoor_casmtr_4c", "outdoor_casmtr_2c")
# the flagship's ResNetFPN variant: outdoor_casmtr_4c with the backbone of
# __graft_entry__._flagship_cfg(backbone="resnet")
RESNET = "outdoor_casmtr_4c ResNetFPN"
# the plain QuadtreeLoFTR (ResNetFPN_8_2, gray, no cascade) and the indoor
# CasMTR-4c (ResNetFPN_8_4_2, POLA self layers, relative-PE cross layers)
BASELINE = "quadtree_baseline"
INDOOR = "indoor_casmtr_4c_runnable"
# the published indoor recipe as the PMT-refine model (build_model(...,
# refine=True)): a frozen quadtree trunk, a ladder side network and new 4c
# heads; the trunk's parameters and statistics must not change in training
REFINE = "indoor_casmtr_4c refine"
REFINED = (REFINE,)
FROZEN_TRUNK = ("backbone", "loftr_coarse")
# the relative nudge of the images under which the refine model's trunk
# flips a 1/8 top-k pick on the CPU alone at the reference's 256^2 pair
# (frozen_trunk_reference)
TRUNK_NUDGE = 1e-5
MODELS = {r: (r, {}) for r in RECIPES}
MODELS[RESNET] = ("outdoor_casmtr_4c", {"loftr": {"backbone": {
    "backbone_type": "ResNetFPN", "initial_dim": 64,
    "block_dims": [64, 128, 256]}}})
MODELS[BASELINE] = (BASELINE, {})
MODELS[INDOOR] = (INDOOR, {})
MODELS[REFINE] = ("indoor_casmtr_4c", {})
# the models of phases 4-8
BASE_MODELS = tuple(MODELS)
# phase 11, the model zoo: published recipes with two orthogonal switches
# each (the full-width counterparts of tests/torch_parity.ZOO).  Z1: the
# 'local_global' self layers (DoubleGroupBlock, its global half with the
# recipe's sr_ratio 4) and the 'dilated1' propagation at dilation 2 (the
# cascade gather paths: no B, no C); Z2: the 'LKA' self layers and the 1/8
# stack's relative PE (its levels take the plain gather path: no A or A′
# there); Z3: 2c with Guided quadtree attention ('topk', top 16 of the 1/8
# cycle top-k, one level: kernel A at 1/4) and the 'linear' self layers at
# 1/2
Z1 = "outdoor_casmtr_4c local_global dilated1"
Z2 = "outdoor_casmtr_4c LKA coarse relative PE"
Z3 = "outdoor_casmtr_2c topk linear"
ZOO = (Z1, Z2, Z3)
MODELS[Z1] = ("outdoor_casmtr_4c", {"loftr": {"coarse2": {
    "self_attn_type": "local_global", "propagation": "dilated1",
    "dilated": 2}}})
MODELS[Z2] = ("outdoor_casmtr_4c", {"loftr": {
    "coarse2": {"self_attn_type": "LKA"}, "coarse": {"relative_pe": True}}})
MODELS[Z3] = ("outdoor_casmtr_2c", {"loftr": {
    "coarse2": {"self_attn_type": "topk", "topks": [16]},
    "coarse3": {"self_attn_type": "linear"}}})
# per model: quadtree layers at 1/8, cascade levels, and of those the levels
# whose two cross layers run kernel C (the indoor recipe's relative-PE cross
# layers take the gather path instead)
LAYOUT = {"outdoor_casmtr_4c": (6, 1, 1), "outdoor_casmtr_2c": (6, 2, 2),
          RESNET: (6, 1, 1), BASELINE: (8, 0, 0), INDOOR: (8, 1, 0),
          REFINE: (8, 1, 0), Z1: (6, 1, 0), Z2: (0, 1, 1), Z3: (6, 2, 2)}
# the cascade levels that do not score their windows with kernel B (the
# dilated propagation's gather path), and the Guided self layers at 1/4
# (kernel A once per image each)
SCORE_LEVELS = {Z1: 0}
GUIDED = {Z3: 2}
# phase 12: the test-time filters (post_config of every cascade level; the
# full-width counterparts of tests/torch_parity.FILTERS), 4c with each, 2c
# with F4 and F6 on both levels; the filters add no kernel launch
FILTERS = {
    "F1": {"method": "local_window_nms", "window_size": 4, "topk": 2},
    "F2": {"method": "softargmax_nms", "window_size": 5, "stride": 1},
    "F3": {"method": "softargmax_nms", "window_size": 4, "stride": 4},
    "F4": {"method": "d2d", "window_size": 5},
    "F5": {"method": "sift"},
    "F6": {"method": "maxpool_nms", "window_size": 5, "rt": 0.8,
           "rd": 0.05},
}
# the filters whose keep masks must be bit-equal card against CPU (the
# others decide on a continuous value near its boundary: NEAR_TOL)
DISCRETE_FILTERS = ("F1", "F6")
FILTER_RUNS = {"outdoor_casmtr_4c": tuple(FILTERS),
               "outdoor_casmtr_2c": ("F4", "F6")}
FILTERED = {}
for _recipe, _names in FILTER_RUNS.items():
    for _f in _names:
        _stages = ("coarse2", "coarse3")[:LAYOUT[_recipe][1]]
        FILTERED[f"{_recipe} {_f}"] = _f
        MODELS[f"{_recipe} {_f}"] = (_recipe, {"loftr": {
            s: {"post_config": dict(FILTERS[_f])} for s in _stages}})
        LAYOUT[f"{_recipe} {_f}"] = LAYOUT[_recipe]
# the evaluation run of phase 12 (cli.evaluate.run_eval, 4c)
EVAL_NAME = "outdoor_casmtr_4c run_eval"
MODELS[EVAL_NAME] = MODELS["outdoor_casmtr_4c"]
LAYOUT[EVAL_NAME] = LAYOUT["outdoor_casmtr_4c"]
# phase 13: the commands on the committed file fixtures
# (scripts/make_port_io_fixtures.py): evaluate on the MegaDepth-layout scene,
# train 4c on it (with a sanity validation and a validation), resume, and
# train the indoor recipe on the ScanNet-layout scene
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "port_io")
IO_EVAL = "outdoor_casmtr_4c evaluate"
IO_TRAIN = "outdoor_casmtr_4c train"
IO_RESUME = "outdoor_casmtr_4c train --resume"
IO_INDOOR = "indoor_casmtr_4c_runnable train"
for _name, _base in ((IO_EVAL, "outdoor_casmtr_4c"),
                     (IO_TRAIN, "outdoor_casmtr_4c"),
                     (IO_RESUME, "outdoor_casmtr_4c"), (IO_INDOOR, INDOOR)):
    MODELS[_name] = MODELS[_base]
    LAYOUT[_name] = LAYOUT[_base]
# phase 14: the SfM engine (sfm/) and the reconstruct command, whose matcher
# is 4c at bf16 on the fixture's MegaDepth-layout frames
SFM_NAME = "outdoor_casmtr_4c reconstruct"
MODELS[SFM_NAME] = MODELS["outdoor_casmtr_4c"]
LAYOUT[SFM_NAME] = LAYOUT["outdoor_casmtr_4c"]
# evaluate reads the scene IO_EVAL_REPEATS times over (its list file names
# it so often): IO_PAIRS pairs, enough that the loader's head start (its
# workers and prefetch) is spent well before the last pair
IO_SCENE_PAIRS, IO_EVAL_REPEATS = 6, 4
IO_PAIRS = IO_SCENE_PAIRS * IO_EVAL_REPEATS
# train: IO_STEPS samples drawn with replacement from the scene's pairs,
# the steady-state medians over the steps after the loader's head start;
# the resumed run takes IO_RESUME_STEPS more
IO_WORKERS = 4
IO_STEPS, IO_RESUME_STEPS, IO_SANITY, IO_VAL = 32, 4, 1, 2
IO_INDOOR_STEPS = 2
IO_LOADER_SAMPLES = 16   # the training loader timed alone, at 1 and 4 threads
IO_REPS = 10          # decode and resize timings: median of this many
# phase 10: the checkpointed serving recipe and the staged recipe, whose
# stages 1 and 2 run the 1/8 stack alone and with the 1/4 level
CKPT_RECIPE = "outdoor_casmtr_4c"
STAGED = "outdoor_casmtr_2c"
STAGES = (1, 2, 3)
STAGE_NAMES = {s: f"{STAGED} stage {s}" for s in STAGES}
LAYOUT.update({STAGE_NAMES[1]: (6, 0, 0), STAGE_NAMES[2]: (6, 1, 1),
               STAGE_NAMES[3]: LAYOUT[STAGED]})
# the staged run's new-stage warmup (the recipe's is 0 steps long): the
# 'new' group restarts at warmup_ratio_stages x base_lr / 2 at each resume
STAGE_TRAINER = {"warmup_step_stages": 200, "warmup_ratio_stages": 0.1}
STAGE_BASE_LR = 1e-3
STAGE_STEPS_PER_EPOCH = 1000
# serving canvas and training size per model: the indoor recipe serves a
# ScanNet 640x480 frame padded to 640^2 and trains at its train_size
BUCKET = {m: 832 for m in MODELS}
BUCKET[INDOOR] = BUCKET[REFINE] = 640
TPU_KERNELS = {
    "quadtree_fine_attention":
        "casmtr_tpu/ops/pallas/quadtree_kernels.py:118",
    # the same body with n_topk > 0; its pallas_call
    "quadtree_fine_topk": "casmtr_tpu/ops/pallas/quadtree_kernels.py:321",
    "window_patch_score": "casmtr_tpu/ops/pallas/window_kernels.py:75",
    "window_cross_attention": "casmtr_tpu/ops/pallas/window_kernels.py:289",
    "quadtree_fine_attention_bwd":
        "casmtr_tpu/ops/pallas/quadtree_kernels.py:178",
    # plain XLA in the JAX package (the custom VJP of the Pallas kernel)
    "window_patch_score_bwd": "casmtr_tpu/ops/pallas/window_kernels.py:152",
    "window_cross_attention_bwd":
        "casmtr_tpu/ops/pallas/window_kernels.py:356",
}
# the bf16-input instances of A, A′, C (the bf16 eval path and the bf16
# training step) and of A-bwd and C-bwd (the bf16 training step), counted
# and listed apart: the same TPU kernels fed bf16 q/k/v
BF16_KERNELS = ("quadtree_fine_attention", "quadtree_fine_topk",
                "window_cross_attention", "quadtree_fine_attention_bwd",
                "window_cross_attention_bwd")
for _name in BF16_KERNELS:
    TPU_KERNELS[_name + "_bf16"] = TPU_KERNELS[_name]
SOURCES = {
    "quadtree_fine_attention": "casmtr_tpu_torch/csrc/quadtree_fine.cu",
    "quadtree_fine_topk": "casmtr_tpu_torch/csrc/quadtree_fine.cu",
    "window_patch_score": "casmtr_tpu_torch/csrc/window_score.cu",
    "window_cross_attention": "casmtr_tpu_torch/csrc/window_attention.cu",
    "quadtree_fine_attention_bwd":
        "casmtr_tpu_torch/csrc/quadtree_fine_bwd.cu",
    "window_patch_score_bwd": "casmtr_tpu_torch/csrc/window_score_bwd.cu",
    "window_cross_attention_bwd":
        "casmtr_tpu_torch/csrc/window_attention_bwd.cu",
}
for _name in BF16_KERNELS:
    SOURCES[_name + "_bf16"] = SOURCES[_name]


def _typed(counts, bf16):
    """``counts`` of the kernels with bf16 instances, on their bf16
    instances (``bf16``) or on their f32 ones, the others at 0."""
    out = {}
    for k, v in counts.items():
        out[k], out[k + "_bf16"] = (0, v) if bf16 else (v, 0)
    return out


def per_pair(model, bf16):
    """Launches per image pair on the eval path (no backward): each 1/8
    quadtree layer that goes through the kernels runs A′ at the
    intermediate and A at the finest level once per image, and each Guided
    layer A once per image; per cascade level that scores with kernel B 2
    window-score directions, and on the levels that use kernel C 2 cross
    layers x 2 images.  With ``bf16`` (the card's eval default) A, A′ and C
    are their bf16 instances and their f32 instances launch 0 times; B
    stays f32."""
    qt, levels, c_levels = LAYOUT[model]
    guided = GUIDED.get(model, 0)
    return dict(_typed({"quadtree_fine_attention": 2 * (qt + guided),
                        "quadtree_fine_topk": 2 * qt,
                        "window_cross_attention": 4 * c_levels,
                        "quadtree_fine_attention_bwd": 0,
                        "window_cross_attention_bwd": 0}, bf16),
                window_patch_score=2 * SCORE_LEVELS.get(model, levels),
                window_patch_score_bwd=0)


def per_step(model, bf16):
    """Launches per training step (no rematerialization): the forward's,
    and one backward for each forward whose inputs need a gradient -- all
    but the detached 1->0 window scores; A and A′ share A-bwd, which a
    frozen trunk (REFINED) never launches.  With ``bf16`` (the card's
    training default) A, A′, A-bwd, C and C-bwd are their bf16 instances
    and their f32 instances launch 0 times; B and B-bwd stay f32."""
    qt, levels, c_levels = LAYOUT[model]
    a_fwd = 4 * qt + 2 * GUIDED.get(model, 0)
    return dict(per_pair(model, bf16), **_typed(
        {"quadtree_fine_attention_bwd": 0 if model in REFINED else a_fwd,
         "window_cross_attention_bwd": 4 * c_levels}, bf16),
        window_patch_score_bwd=SCORE_LEVELS.get(model, levels))


# per pair or step in the card's default (bf16), and with float32 forced
LAUNCHES_PER_PAIR = {m: per_pair(m, True) for m in MODELS}
LAUNCHES_PER_PAIR_F32 = {m: per_pair(m, False) for m in MODELS}
LAUNCHES_PER_TRAIN_STEP = {m: per_step(m, True) for m in MODELS}
LAUNCHES_PER_TRAIN_STEP_F32 = {m: per_step(m, False) for m in MODELS}
LAUNCHES_PER_STAGE_STEP = {s: per_step(STAGE_NAMES[s], True)
                           for s in STAGES}
TRAIN_SIZE = 704
TRAIN_SIZES = {m: TRAIN_SIZE for m in MODELS}
TRAIN_SIZES[INDOOR] = TRAIN_SIZES[REFINE] = 640
TRAIN_SHIFT = (16, 24)   # (dy, dx) pixels from image0 to image1
# The library yardstick of each row: one PyTorch call on inputs gathered
# beforehand (the gather is not timed).  scaled_dot_product_attention takes
# float32 only in its memory-efficient and math backends; it is pinned to
# the first.  The port never calls any of these.
SDPA_BACKEND = "EFFICIENT_ATTENTION"
SDPA_NOTE = ("torch.nn.functional.scaled_dot_product_attention (backend "
             f"{SDPA_BACKEND}) over the candidate windows gathered "
             "beforehand, one batch row per {rows}; gather not timed")
LIBRARY_NOTES = {
    "quadtree_fine_attention": SDPA_NOTE.format(rows="(parent, head)"),
    "window_cross_attention": SDPA_NOTE.format(rows="parent"),
    "quadtree_fine_attention_bwd":
        "backward of the row's forward yardstick (torch.autograd.grad of "
        "the same call), dq and the gathered rows' dk, dv; gather not "
        "timed, and no scatter of dk, dv back onto the key grid",
    "window_patch_score": "torch.matmul of the 2x2-blocked queries against "
                          "the patch rows gathered beforehand; gather not "
                          "timed",
    "quadtree_fine_topk": "null: no PyTorch call fuses a top-k selection "
                          "into attention; unfused_ms holds kernel A plus "
                          "the plain selection",
    "window_patch_score_bwd": "null: dq (a product with the gathered patch) "
                              "and dfeat1 (a scatter-add) need two calls",
}
LIBRARY_NOTES["window_cross_attention_bwd"] = \
    LIBRARY_NOTES["quadtree_fine_attention_bwd"]
for _name in BF16_KERNELS:
    LIBRARY_NOTES[_name + "_bf16"] = (
        LIBRARY_NOTES[_name] + "; on bf16 inputs and a bf16 cotangent"
        if _name.endswith("_bwd") else LIBRARY_NOTES[_name].replace(
            "over the candidate", "on bf16, over the bf16 candidate"))
LSE_NOTE = "; the message only: the public call returns no log-sum-exp"


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def time_ms(torch, fn, reps=25, warmup=3):
    """Median CUDA-event time of ``fn`` in ms; a 256 MB buffer is rewritten
    before each launch, so every launch starts with a cold 50 MB L2.  The
    card then spins for HOLD_CYCLES before the start event, so the host's
    time to enqueue ``fn`` (Python, argument checks, autograd) passes
    during the spin and not between the events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved, flops, bf16_flops=0):
    """Least time on the card (ms) and what bounds it: ``flops`` at the
    float32 rate, ``bf16_flops`` (multiply-adds on bf16 inputs) at the
    dense bf16 tensor-core rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases 2 and 3: kernels against their plain versions
# --------------------------------------------------------------------------

def quadtree_inputs(torch, gen, g, topks=(32, 16)):
    """The 1/8 quadtree pyramid on a g x g finest grid (g^2, (g/2)^2, (g/4)^2
    grids, H=8, D=32, the coarse and intermediate levels' ``topks``) from
    seeded features; the block ids of the two fine levels come from the
    real coarse-level top-k and the real intermediate-level selection.
    Returns {label: ((q, k, v), ids, hw)} for the intermediate and the
    finest level."""
    from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import \
        quadtree_fine_topk_plain
    from casmtr_tpu_torch.ops.quadtree import _coarse_level
    H, D, C = 8, 32, 256
    levels = []
    q, k, v = (torch.randn((1, C, g, g), generator=gen, device="cuda")
               for _ in range(3))
    for _ in range(3):
        toks = [t.flatten(2).transpose(1, 2).reshape(1, -1, H, D).contiguous()
                for t in (q, k, v)]
        levels.append((tuple(q.shape[-2:]), toks))
        q, k, v = avg_pool_2x2(q), avg_pool_2x2(k), avg_pool_2x2(v)
    (hw2, l2), (hw1, l1), (hw0, l0) = levels
    _, ids1 = _coarse_level(*l0, topks[0])
    ids2 = quadtree_fine_topk_plain(*l1, ids1, hw1, hw1,
                                    topks[1])[2].contiguous()
    return {f"intermediate {g // 2}x{g // 2}": (l1, ids1, hw1),
            f"finest {g}x{g}": (l2, ids2, hw2)}


def window_inputs(torch, gen, g2):
    """Window corners of a cascade level (w = 5) whose previous grid is
    g2 x g2: each previous cell's match is a cell a few steps away (a
    shifted image pair), turned into boundary-shifted windows by
    window_warp_idx."""
    from casmtr_tpu_torch.models.cascade_transformer import window_warp_idx
    from casmtr_tpu_torch.ops.propagation import get_propagations
    yy, xx = torch.meshgrid(torch.arange(g2, device="cuda"),
                            torch.arange(g2, device="cuda"), indexing="ij")
    dy, dx = (torch.randint(-4, 5, (g2, g2), generator=gen, device="cuda")
              for _ in range(2))
    nxt = ((yy + dy).clamp(0, g2 - 1) * g2 + (xx + dx).clamp(0, g2 - 1))
    window, _ = get_propagations("window", 5)
    win = window_warp_idx(nxt.reshape(1, -1), window, g2, g2)
    return win[:, :, 0, :].to(torch.int32).contiguous()


def kernel_row(torch, rows, name, label, path, kernel, plain, inputs,
               bytes_moved, flops, scattered=(), library=None, note="",
               bf16_flops=0):
    """Hold ``kernel()`` against ``plain()`` (a tensor or a tuple of them),
    time both and ``library()`` (the row's library yardstick, a callable
    returning its time in ms, or None), and append the row.  Outputs whose
    index is in ``scattered`` are sums of atomic adds: their tolerance
    scales with max |plain|.  ``note`` is added to the library note; the
    bound counts ``flops`` at the f32 rate and ``bf16_flops`` at the bf16
    tensor-core rate."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name} [{label}] output {i}: shape {tuple(a.shape)} or "
              "non-finite")
        err = float((a - b).abs().max())
        tol = KERNEL_TOL * (max(1.0, float(b.abs().max()))
                            if i in scattered else 1.0)
        errs.append((err, tol))
    t_kernel = time_ms(torch, kernel)
    t_plain = time_ms(torch, plain)
    t_library = library() if library is not None else None
    t_bound, by = bound(bytes_moved, flops, bf16_flops)
    err = max(e for e, _ in errs)
    log(f"kernel {name} [{label}] inputs {inputs}: max_abs_err "
        + ", ".join(f"{e:.3e} (tol {t:.3g})" for e, t in errs)
        + f", kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, library "
        + ("null" if t_library is None else f"{t_library:.4f} ms")
        + f", bound {t_bound:.4f} ms ({by}: {bytes_moved / 1e6:.1f} MB, "
        f"{(flops + bf16_flops) / 1e9:.3f} GFLOP)")
    for i, (e, t) in enumerate(errs):
        check(e <= t, f"{name} [{label}] output {i}: max abs error {e:.3e} "
              f"> {t:.3g}")
    return add_row(rows, name, label, path, err, t_kernel, t_plain, t_bound,
                   by, t_library, note)


def add_row(rows, name, label, path, err, t_kernel, t_plain, t_bound, by,
            t_library=None, note=""):
    row = {"name": name, "shape": label, "path": path, "route": "cuda",
           "source": SOURCES[name], "replaces": TPU_KERNELS[name],
           "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
           "bound_ms": t_bound, "bound_by": by, "library_ms": t_library,
           "library_note": LIBRARY_NOTES[name] + note,
           # max_err and kernel_ms repeat max_abs_err and ms
           "max_err": err, "kernel_ms": t_kernel}
    rows.append(row)
    return row


def sdpa_library(torch, qb, k_g, v_g, want, g=None):
    """The library yardstick of an attention row: a callable that times
    ``scaled_dot_product_attention`` (backend SDPA_BACKEND) on gathered
    queries qb [N, h, 4, D] and candidates k_g/v_g [N, h, C, D] -- with the
    cotangent ``g`` its backward alone, ``torch.autograd.grad`` of the same
    call.  Its forward output is first held against ``want`` (the plain
    message laid out as qb), within KERNEL_TOL, or LIBRARY_BF16_TOL on bf16
    inputs (the call rounds to bf16)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = getattr(SDPBackend, SDPA_BACKEND)

    def run():
        with sdpa_kernel(backend):
            if g is None:
                return time_ms(torch, lambda: sdpa(qb, k_g, v_g))
            xs = [t.detach().requires_grad_(True) for t in (qb, k_g, v_g)]
            out = sdpa(*xs)
            return time_ms(torch, lambda: torch.autograd.grad(
                out, xs, g, retain_graph=True))

    with sdpa_kernel(backend):
        err = float((sdpa(qb, k_g, v_g).float() - want).abs().max())
    tol = LIBRARY_BF16_TOL if qb.dtype == torch.bfloat16 else KERNEL_TOL
    check(err <= tol, f"library yardstick: {SDPA_BACKEND} differs from the "
          f"plain message by {err:.3e}")
    return run


def window_library(torch, q, k, v, corners, hw, w, with_grad):
    """C's (or with ``with_grad`` C-bwd's) library yardstick: the patch
    candidates gathered as in the plain version, laid out [B*P, H, C, D]."""
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    from casmtr_tpu_torch.ops.quadtree import block_children
    B, _, H, D = q.shape
    idx = kernels.clip_index(wk._expand_corner_indices(corners, w, hw[1]),
                             hw[0] * hw[1])
    bi = torch.arange(B, device=q.device)[:, None, None]

    def heads_first(t):          # [B, P, n, H, D] -> [B*P, H, n, D]
        return t.permute(0, 1, 3, 2, 4).flatten(0, 1).contiguous()

    k_g, v_g = heads_first(k[bi, idx]), heads_first(v[bi, idx])
    qb = heads_first(block_children(q, *hw))
    want = heads_first(wk.window_cross_attention_plain(q, k, v, corners, hw,
                                                       hw, w))
    g = (torch.randn(qb.shape, device=q.device, dtype=qb.dtype)
         if with_grad else None)
    return sdpa_library(torch, qb, k_g, v_g, want, g)


def quadtree_library(torch, q, k, v, ids, hw, with_grad):
    """A's (or A-bwd's) library yardstick: each (parent, head)'s 4K
    candidates gathered as in the plain version, [B*P*H, 1, 4K, D]."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.quadtree import block_children
    B, _, H, D = q.shape
    P, K = ids.shape[1:3]
    k_g, v_g, _ = qk_._candidates(k, v, ids, hw)        # [B, P, K, H, 4, D]

    def rows(t):
        return t.permute(0, 1, 3, 2, 4, 5).reshape(B * P * H, 1, 4 * K, D)

    def queries(t):             # [B, P, 4, H, D] -> [B*P*H, 1, 4, D]
        return t.permute(0, 1, 3, 2, 4).reshape(B * P * H, 1, 4, D)

    qb = queries(block_children(q, *hw)).contiguous()
    want = queries(qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw))
    g = (torch.randn(qb.shape, device=q.device, dtype=qb.dtype)
         if with_grad else None)
    return sdpa_library(torch, qb, rows(k_g).contiguous(),
                        rows(v_g).contiguous(), want, g)


def attention_flops(n_tasks, n_cand, D, backward=False):
    """QK and PV over n_cand candidates for 4 child queries per task (2 FLOP
    per multiply-add); the backward recomputes QK and adds dP, dQ, dK and
    dV."""
    return n_tasks * (5 if backward else 2) * 2 * 4 * n_cand * D


def unfused_selection(torch, q, k, ids, hw, topk):
    """The intermediate level's top-k selection without kernel A′, in plain
    torch beside kernel A: gather the candidate keys again, recompute the
    scores, softmax, top-k, map to key-grid positions [B, Lq, topk, H]."""
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.quadtree import (block_children,
                                               to_block_major,
                                               unblock_children)
    h, w = hw
    B, _, H, D = q.shape
    K = ids.shape[2]
    qb = block_children(q.float(), h, w)
    P = qb.shape[1]
    table = to_block_major(k.float(), h, w)
    blk_ids = kernels.clip_index(ids.long(), table.shape[1])
    bi = torch.arange(B, device=q.device)[:, None, None, None]
    hi = torch.arange(H, device=q.device)[None, None, None, :]
    k_g = table[bi, blk_ids, hi].reshape(B, P, K, H, 4, D)
    qk = torch.einsum("bpfhd,bpkhjd->bpfhkj", qb, k_g)
    qk = qk.reshape(B, P, 4, H, 4 * K) * (D ** -0.5)
    _, local = torch.topk(torch.softmax(qk, dim=-1), topk, dim=-1)
    ids_bh = blk_ids.transpose(2, 3)[:, :, None].expand(B, P, 4, H, K)
    blk = torch.gather(ids_bh, 4, local // 4)
    child = local % 4
    rows = (blk // (w // 2)) * 2 + child // 2
    cols = (blk % (w // 2)) * 2 + child % 2
    return unblock_children((rows * w + cols).transpose(3, 4), h // 2,
                            w // 2).to(torch.int32)


def selection_errors(torch, score, idx, p_score, p_idx, topk, rows):
    """A′'s selection against the plain version's top (topk + 1) on the
    child rows ``rows`` [B, Lq, H] (bool): max abs error of the sorted
    scores, the rows whose index sets differ although the plain version's
    k-th and (k+1)-th scores are more than TIE_GAP apart, the near-tie rows
    excluded from that check, and the plain version's top-k indices."""
    s_got = score.sort(dim=2, descending=True).values
    s_err = float(torch.where(rows[:, :, None],
                              (s_got - p_score[:, :, :topk]).abs(), 0).max())
    p_top = p_idx[:, :, :topk].contiguous()
    clear = rows & ((p_score[:, :, topk - 1] - p_score[:, :, topk])
                    > TIE_GAP)
    same = (idx.sort(dim=2).values == p_top.sort(dim=2).values).all(dim=2)
    return (s_err, int((clear & ~same).sum()), int((rows & ~clear).sum()),
            clear, p_top)


def topk_row(torch, rows, label, path, inter, finest, topk, with_lse):
    """Kernel A′ at the intermediate level ``inter`` against its plain
    version: through its public wrapper ``quadtree_fine_topk`` (serving), or
    with ``with_lse`` (training) through ``QuadtreeFineAttention`` with a
    gradient to come, which writes the log-sum-exp (read back through the
    launcher).  The next level's message is read from the ``finest``
    level's q/k/v.  Times the call beside its plain version, its bound and
    the unfused route (kernel A and ``unfused_selection``).  On bf16 q/k/v
    the row is the bf16 instance's."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    (q, k, v), ids, hw = inter
    (qn, kn, vn), _, hw_n = finest
    B, Lq, H, D = q.shape
    P, K = ids.shape[1:3]
    NC = 4 * K
    bf16 = q.dtype == torch.bfloat16
    name = "quadtree_fine_topk" + ("_bf16" if bf16 else "")

    def kernel():
        if with_lse:
            return qk_.QuadtreeFineAttention.apply(q, k, v, ids, hw, hw, True,
                                                   topk)
        return qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, topk)

    msg, score, idx = kernel()
    p_msg, p_score, p_idx, p_lse = qk_.quadtree_fine_topk_plain(
        q, k, v, ids, hw, hw, topk + 1, with_lse=True)
    outs = [("message", msg, p_msg)]
    lse = None
    if with_lse:
        lse = qk_._launch_fwd(q, k, v, ids, hw, hw, True, topk)[1]
        outs.append(("lse", lse, p_lse))
    torch.cuda.synchronize()
    for what, a, b in outs + [("score", score, p_score[:, :, :topk])]:
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name} [{label}] {what}: shape "
              f"{tuple(a.shape)} or non-finite")
    errs = {what: float((a - b).abs().max()) for what, a, b in outs}
    everywhere = torch.ones((B, Lq, H), dtype=torch.bool, device="cuda")
    errs["score"], idx_bad, excluded, clear, p_top = selection_errors(
        torch, score, idx, p_score, p_idx, topk, everywhere)
    nxt = [qk_.quadtree_fine_attention_plain(qn, kn, vn, i, hw_n, hw_n)
           for i in (idx, p_top)]
    nxt_err = float(((nxt[0] - nxt[1]).abs()
                     * clear[:, :, None, :, None]).max())
    t_kernel = time_ms(torch, kernel)
    t_plain = time_ms(torch, lambda: qk_.quadtree_fine_topk_plain(
        q, k, v, ids, hw, hw, topk, with_lse))
    t_unfused = time_ms(torch, lambda: (
        qk_._launch_fwd(q, k, v, ids, hw, hw, with_lse),
        unfused_selection(torch, q, k, ids, hw, topk)))
    bytes_moved = nbytes(q, k, v, ids, msg, score, idx) + (
        nbytes(lse) if with_lse else 0)
    # the attention (on the tensor cores for bf16 inputs), and the
    # selection at its least: one compare per candidate of each child row
    attn, sel = attention_flops(P * H, NC, D), P * H * 4 * NC
    t_bound, by = (bound(bytes_moved, sel, attn) if bf16
                   else bound(bytes_moved, attn + sel))
    flops = attn + sel
    log(f"kernel {name} [{label}] q/k/v {list(q.shape)} {q.dtype} ids "
        f"{list(ids.shape)} top {topk}: max_abs_err "
        + ", ".join(f"{w} {e:.3e}" for w, e in errs.items())
        + f" (tol {KERNEL_TOL:g}, score {SCORE_TOL:g}); index sets differ "
        f"on {idx_bad} of {B * Lq * H} rows, {excluded} rows excluded as "
        f"near ties (gap <= {TIE_GAP:g}); next level's message "
        f"max_abs_err {nxt_err:.3e}; kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.4f} ms, unfused (kernel A + plain selection) "
        f"{t_unfused:.4f} ms, bound {t_bound:.4f} ms ({by}: "
        f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    for what, e in errs.items():
        check(e <= (SCORE_TOL if what == "score" else KERNEL_TOL),
              f"{name} [{label}] {what}: max abs error {e:.3e}")
    check(idx_bad == 0, f"{name} [{label}]: {idx_bad} rows select other "
          "indices")
    check(nxt_err <= KERNEL_TOL, f"{name} [{label}]: next level's message "
          f"max abs error {nxt_err:.3e}")
    row = add_row(rows, name, label, path,
                  max(errs.values()), t_kernel, t_plain, t_bound, by)
    row.update(near_tie_rows_excluded=excluded, unfused_ms=t_unfused)


def topk_nan_check(torch, gen):
    """Kernel A′ on child rows whose scores hold a NaN (one NaN query row:
    all of its scores; one NaN key row: one score of every row that reads
    it).  The launch must not fault.  Rows without a NaN agree with the
    plain version; rows with one have NaN scores and in-range indices, as
    the plain version passes the NaN on; the all-NaN row selects its first
    ``topk`` candidates (a NaN ranks above every number, ties go to the
    lower candidate)."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    hw, H, D, K, topk = (8, 12), 2, 8, 4, 6
    Lq, n_blk = hw[0] * hw[1], (hw[0] // 2) * (hw[1] // 2)
    q, k, v = (torch.randn((1, Lq, H, D), generator=gen, device="cuda")
               for _ in range(3))
    ids = torch.randint(0, n_blk, (1, n_blk, K, H), generator=gen,
                        device="cuda", dtype=torch.int32)
    q[0, 13, 1] = float("nan")   # child 3 of parent 0, head 1
    k[0, 40, 0] = float("nan")
    msg, score, idx = qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, topk)
    torch.cuda.synchronize()
    p_msg, p_score, p_idx = qk_.quadtree_fine_topk_plain(q, k, v, ids, hw, hw,
                                                         topk + 1)
    nan_rows = torch.isnan(p_score).any(dim=2)
    fin = ~nan_rows
    s_err, idx_bad, _, _, _ = selection_errors(torch, score, idx, p_score,
                                               p_idx, topk, fin)
    msg_nan = torch.isnan(msg)
    msg_err = float((msg - p_msg).abs()[~msg_nan].max())
    first = qk_._candidates(k, v, ids, hw)[2][0, 0, 1, :topk].int()
    n_nan = int(nan_rows.sum())
    log(f"kernel quadtree_fine_topk [NaN rows] q/k/v {list(q.shape)} ids "
        f"{list(ids.shape)} top {topk}: {n_nan} of {nan_rows.numel()} rows "
        f"hold a NaN; on the others score max_abs_err {s_err:.3e}, index "
        f"sets differ on {idx_bad}, message max_abs_err {msg_err:.3e}; the "
        f"all-NaN row selects {idx[0, 13, :, 1].tolist()} (its first "
        f"candidates {first.tolist()})")
    check(0 < n_nan < nan_rows.numel(), "NaN check: no row or every row "
          "holds a NaN")
    check(torch.equal(msg_nan, torch.isnan(p_msg)),
          "NaN check: the message's NaNs differ from the plain version's")
    check(torch.equal(torch.isnan(score).all(dim=2), nan_rows)
          and torch.equal(torch.isfinite(score).all(dim=2), fin),
          "NaN check: NaN scores not where the plain version has them")
    check(bool(((idx >= 0) & (idx < Lq)).all()),
          "NaN check: index outside the key grid")
    check(s_err <= SCORE_TOL and idx_bad == 0 and msg_err <= KERNEL_TOL,
          "NaN check: rows without a NaN disagree with the plain version")
    check(torch.equal(idx[0, 13, :, 1], first),
          "NaN check: the all-NaN row does not select in candidate order")


def score_library(torch, q_blk, feat1, corners, w):
    """B's library yardstick: torch.matmul of q_blk [B, P, 4, C] against
    the patch rows [B, P, 4w^2, C] gathered beforehand."""
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    B, H1, W1, C = feat1.shape
    idx = kernels.clip_index(wk._expand_corner_indices(corners, w, W1),
                             H1 * W1)
    f1_g = feat1.reshape(B, H1 * W1, C)[
        torch.arange(B, device=feat1.device)[:, None, None], idx]
    f1_t = f1_g.transpose(-1, -2)
    err = float((torch.matmul(q_blk, f1_t) - wk.window_patch_score_plain(
        q_blk, feat1, corners, w)).abs().max())
    check(err <= KERNEL_TOL, f"library yardstick: matmul differs from the "
          f"plain scores by {err:.3e}")
    return lambda: time_ms(torch, lambda: torch.matmul(q_blk, f1_t))


def edge_corners(torch, gen, corners, g2):
    """A copy of ``corners`` (on a g2 x g2 half grid) whose patches leave
    the grid: a quarter of the parents take corners from [-3, g2 + 3), and
    four take (-1, -1), (g2 - 1, g2 - 1), (0, g2) and (-P, 3) -- a flat
    index below -n, which the clipped-gather rule clamps to row 0."""
    out = corners.clone()
    P = corners.shape[1]
    pick = torch.randperm(P, generator=gen, device="cuda")[:P // 4]
    out[0, pick] = torch.randint(-3, g2 + 3, (len(pick), 2), generator=gen,
                                 device="cuda", dtype=torch.int32)
    out[0, :4] = torch.tensor([[-1, -1], [g2 - 1, g2 - 1], [0, g2],
                               [-P, 3]], dtype=torch.int32)
    return out


def window_edge_check(torch, gen, q, k, v, corners, hw, w):
    """Kernels C (with its log-sum-exp) and C-bwd at the training shapes on
    corners whose patches run past the grid edge or are negative, against
    the plain versions: the flat clipped-gather rule on the card."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    edge = edge_corners(torch, gen, corners, hw[0] // 2)
    out, lse = wk._launch_wca_fwd(q, k, v, edge, hw, hw, w, True)
    p_out, p_lse = wk.window_cross_attention_plain(q, k, v, edge, hw, hw, w,
                                                   with_lse=True)
    g = torch.randn(out.shape, generator=gen, device="cuda")
    got = wk.window_cross_attention_bwd(q, k, v, edge, out, lse, g, hw, hw, w)
    want = wk.window_cross_attention_bwd_plain(
        q, k, v, edge, p_out.contiguous(), p_lse.contiguous(), g, hw, hw, w)
    torch.cuda.synchronize()
    errs = {"message": float((out - p_out).abs().max()),
            "lse": float((lse - p_lse).abs().max())}
    tols = {"message": KERNEL_TOL, "lse": KERNEL_TOL}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[name] = float((a - b).abs().max())
        tols[name] = KERNEL_TOL * (1.0 if name == "dq"
                                   else max(1.0, float(b.abs().max())))
    log(f"kernel window_cross_attention(_bwd) [{hw[0]}x{hw[1]} edge corners, "
        f"y {int(edge[..., 0].min())}..{int(edge[..., 0].max())}, x "
        f"{int(edge[..., 1].min())}..{int(edge[..., 1].max())}]: max_abs_err "
        + ", ".join(f"{n} {e:.3e} (tol {tols[n]:.3g})"
                    for n, e in errs.items()))
    for n, e in errs.items():
        check(e <= tols[n], f"window_cross_attention edge corners: {n} max "
              f"abs error {e:.3e}")


def offset_randn(torch, gen, offset, shape, dtype=None):
    """A contiguous normal tensor on the card (float32, or ``dtype``),
    ``offset`` elements off 16-byte alignment (a bool counts as 1)."""
    n = int(np.prod(shape)) + int(offset)
    x = torch.randn(n, generator=gen, device="cuda")
    return x.to(dtype or torch.float32)[int(offset):].view(shape)


# (B, H, D, grid, w, corners past the edge, inputs 4 bytes off 16-byte
# alignment).  Kernels C and C-bwd are instantiated for 16- or 4-byte copies
# (H*D % 4, alignment), float4 or float columns (D % 4) and one or four
# columns per thread (rows of more than 128 columns); these cases take all
# eight, and chunks cut short (rows of 2048 floats), w = 1 and a batch of two.
WINDOW_CASES = (
    (1, 3, 5, 12, 3, True, False),      # 4-byte copies, float columns
    (1, 2, 6, 12, 2, False, False),     # 16-byte copies, float columns
    (1, 4, 32, 16, 5, False, True),     # 4-byte copies, float4 columns
    (1, 4, 32, 24, 5, True, False),     # 16-byte, float4: the main paths'
    (1, 1, 64, 8, 1, False, False),     # w = 1, 4 candidates
    (1, 8, 256, 4, 1, True, False),     # 16-byte, float4, four per thread
    (1, 3, 45, 8, 2, True, False),      # 4-byte, float, four per thread
    (1, 40, 6, 8, 2, True, False),      # 16-byte, float, four per thread
    (1, 4, 160, 8, 2, True, True),      # 4-byte, float4, four per thread
    (2, 2, 32, 12, 5, True, False))     # a batch of two


def window_cases_check(torch):
    """Kernels C (with and without its log-sum-exp) and C-bwd through their
    public wrappers on WINDOW_CASES, against the plain versions."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    gen = torch.Generator(device="cuda").manual_seed(4)
    for B, H, D, grid, w, edge, offset in WINDOW_CASES:
        L, half, hw = grid * grid, grid // 2, (grid, grid)

        def randn(*shape):
            return offset_randn(torch, gen, offset, shape)

        q, k, v = (randn(B, L, H, D) for _ in range(3))
        lo, hi = (-2, half - w + 3) if edge else (0, half - w + 1)
        corners = torch.randint(lo, hi, (B, L // 4, 2), generator=gen,
                                device="cuda", dtype=torch.int32)
        if edge:
            corners[0, :4] = torch.tensor([[-1, -1], [half - 1, half - 1],
                                           [0, half], [-L, 3]])
        out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
            q, k, v, corners, hw, hw, w, with_lse=True))
        g = randn(*out.shape)
        want = (out, out, lse) + wk.window_cross_attention_bwd_plain(
            q, k, v, corners, out, lse, g, hw, hw, w)
        got = ((wk.window_cross_attention(q, k, v, corners, hw, hw, w),)
               + wk._launch_wca_fwd(q, k, v, corners, hw, hw, w, True)
               + wk.window_cross_attention_bwd(q, k, v, corners, out, lse, g,
                                               hw, hw, w))
        torch.cuda.synchronize()
        names = ("message", "message with LSE", "lse", "dq", "dk", "dv")
        errs = {}
        for n, a, b in zip(names, got, want):
            tol = KERNEL_TOL * (max(1.0, float(b.abs().max()))
                                if n in ("dk", "dv") else 1.0)
            errs[n] = (float((a - b).abs().max()), tol)
        log(f"kernel window_cross_attention(_bwd) [B={B} H={H} D={D} "
            f"{grid}x{grid} w={w}" + (" edge corners" if edge else "")
            + (" misaligned" if offset else "") + "]: max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items()))
        for n, (e, tol) in errs.items():
            check(e <= tol, f"window_cross_attention B={B} H={H} D={D} "
                  f"grid={grid} w={w}: {n} max abs error {e:.3e} > {tol:.3g}")


# (B, C, grid, w, corners past the edge, inputs 4 bytes off 16-byte
# alignment).  Kernels B and B-bwd are instantiated for 16- or 4-byte copies
# (C % 4, alignment) and float4 or float columns (C % 4; for B-bwd also the
# outputs' alignment), B also for its narrow tile (rows of at most 16
# columns) and its wide one; these cases take all six instances of B and
# the three of B-bwd, one and two channel blocks (of 128 floats, or 32 when
# C % 4 != 0), w = 1, a w beyond the old limit of 8 (324 candidates, 11
# chunks), corners past the edge under the gather and the scatter rule,
# and a batch of two.
SCORE_CASES = (
    (1, 128, 24, 5, False, False),   # 16-byte, float4, wide: 4c's
    (1, 64, 24, 5, True, True),      # 4-byte copies, float4, narrow
    (1, 6, 18, 3, True, False),      # 4-byte, float, narrow
    (1, 45, 16, 2, False, True),     # 4-byte, float, wide, two blocks
    (1, 256, 12, 2, True, True),     # 4-byte, float4, wide, two blocks
    (1, 32, 8, 1, False, False),     # 16-byte, narrow; w = 1
    (1, 64, 40, 9, True, False),     # 16-byte, narrow: 2c's; w = 9
    (2, 128, 14, 5, True, False))    # a batch of two


def score_cases_check(torch):
    """Kernels B (through its public wrapper) and B-bwd on SCORE_CASES,
    against the plain versions: scores and dq within KERNEL_TOL, the
    atomically summed dfeat1 within KERNEL_TOL x max(1, max |plain|)."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    gen = torch.Generator(device="cuda").manual_seed(6)
    for B, C, grid, w, edge, offset in SCORE_CASES:
        half, P = grid // 2, (grid // 2) ** 2

        def randn(*shape, scale=1.0):
            return offset_randn(torch, gen, offset, shape).mul_(scale)

        q = randn(B, P, 4, C, scale=C ** -0.25)
        feat1 = randn(B, grid, grid, C, scale=C ** -0.25)
        g = randn(B, P, 4, 4 * w * w)
        lo, hi = (-2, half - w + 3) if edge else (0, half - w + 1)
        corners = torch.randint(lo, hi, (B, P, 2), generator=gen,
                                device="cuda", dtype=torch.int32)
        if edge:
            corners[0, :4] = torch.tensor([[-1, -1], [half - 1, half - 1],
                                           [0, half], [-grid * grid, 3]])
        got = ((wk.window_patch_score(q, feat1, corners, w),)
               + wk.window_patch_score_bwd(q, feat1, corners, g, w))
        want = ((wk.window_patch_score_plain(q, feat1, corners, w),)
                + wk.window_patch_score_bwd_plain(q, feat1, corners, g, w))
        torch.cuda.synchronize()
        errs = {}
        for n, a, b in zip(("scores", "dq", "dfeat1"), got, want):
            tol = KERNEL_TOL * (max(1.0, float(b.abs().max()))
                                if n == "dfeat1" else 1.0)
            errs[n] = (float((a - b).abs().max()), tol)
        log(f"kernel window_patch_score(_bwd) [B={B} C={C} {grid}x{grid} "
            f"w={w}" + (" edge corners" if edge else "")
            + (" misaligned" if offset else "") + "]: max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items()))
        for n, (e, tol) in errs.items():
            check(e <= tol, f"window_patch_score B={B} C={C} grid={grid} "
                  f"w={w}: {n} max abs error {e:.3e} > {tol:.3g}")


# (B, H, D, grid, K, ids, n_topk, inputs 4 bytes off 16-byte alignment).
# Kernels A and A′ (one body, with and without the selection) and A-bwd are
# instantiated for 16- or 4-byte copies (16 only when D % 4 == 0 and the
# inputs are aligned), float4 or float columns (D % 4) and one or four
# columns per thread (rows of more than 128 columns); these cases take all
# six instances of each, K = 1, n_topk 1 and 4K, repeated ids, ids below 0
# and past the block grid (the clipped-gather rule) and a batch of two.
QUADTREE_CASES = (
    (1, 2, 8, (8, 12), 3, "repeated", 1, False),   # 16-byte, float4
    (1, 4, 32, (8, 8), 4, "distinct", 16, True),   # 4-byte copies, float4
    (1, 3, 5, (8, 12), 3, "clip", 12, False),      # 4-byte, float; all 4K
    (1, 8, 80, (4, 8), 2, "repeated", 3, False),   # 16-byte, float4, four
    (1, 8, 80, (4, 8), 2, "clip", 8, True),        # 4-byte, float4, four
    (1, 6, 30, (8, 8), 2, "distinct", 5, False),   # 4-byte, float, four
    (1, 2, 8, (8, 8), 1, "clip", 4, False),        # K = 1: 4 candidates
    (1, 8, 12, (8, 8), 16, "repeated", 16, False),  # the finest K, D = 12
    (2, 8, 32, (8, 12), 5, "clip", 7, False))      # a batch of two


def quadtree_cases_check(torch):
    """Kernels A (through its public wrapper, and with its log-sum-exp
    through the launcher), A′ (public wrapper) and A-bwd on
    QUADTREE_CASES, against the plain versions; A′'s selection as in
    phase 2 (every candidate when n_topk = 4K)."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, H, D, hw, K, kind, topk, offset in QUADTREE_CASES:
        L, n_blk = hw[0] * hw[1], (hw[0] // 2) * (hw[1] // 2)

        def randn(*shape):
            return offset_randn(torch, gen, offset, shape)

        q, k, v = (randn(B, L, H, D) for _ in range(3))
        ids = block_ids(torch, gen, B, n_blk, K, H, kind)
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = randn(*out.shape)
        want = (out, out, lse) + qk_.quadtree_fine_attention_bwd_plain(
            q, k, v, ids, out, lse, g, hw, hw)
        got = ((qk_.quadtree_fine_attention(q, k, v, ids, hw, hw),)
               + qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2]
               + qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse, g,
                                                 hw, hw))
        msg, score, idx = qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, topk)
        p_msg, p_score, p_idx = qk_.quadtree_fine_topk_plain(
            q, k, v, ids, hw, hw, min(topk + 1, 4 * K))
        torch.cuda.synchronize()
        names = ("message", "message with LSE", "lse", "dq", "dk", "dv")
        errs = {}
        for n, a, b in zip(names, got, want):
            tol = KERNEL_TOL * (max(1.0, float(b.abs().max()))
                                if n in ("dk", "dv") else 1.0)
            errs[n] = (float((a - b).abs().max()), tol)
        errs["A′ message"] = (float((msg - p_msg).abs().max()), KERNEL_TOL)
        if topk < 4 * K:
            everywhere = torch.ones((B, L, H), dtype=torch.bool,
                                    device="cuda")
            s_err, idx_bad, _, _, _ = selection_errors(
                torch, score, idx, p_score, p_idx, topk, everywhere)
        else:   # every candidate: the same scores and positions
            s_err = float((score - p_score).abs().max())
            idx_bad = int((idx.sort(dim=2).values
                           != p_idx.sort(dim=2).values).any(dim=2).sum())
        errs["A′ score"] = (s_err, SCORE_TOL)
        log(f"kernel quadtree_fine_attention(_topk, _bwd) [B={B} H={H} D={D} "
            f"{hw[0]}x{hw[1]} K={K} {kind} ids top {topk}"
            + (" misaligned" if offset else "") + "]: max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items())
            + f"; A′ index sets differ on {idx_bad} rows")
        for n, (e, tol) in errs.items():
            check(e <= tol, f"quadtree B={B} H={H} D={D} grid={hw} K={K} "
                  f"{kind}: {n} max abs error {e:.3e} > {tol:.3g}")
        check(idx_bad == 0, f"quadtree B={B} H={H} D={D} grid={hw} K={K} "
              f"{kind}: A′ selects other indices on {idx_bad} rows")


# The bf16 instances of A and A′: (B, H, D, grid, K, ids, n_topk, offset in
# bf16 elements).  They are instantiated for 16- or 4-byte copies (16 only
# when D % 8 == 0 and q/k/v are 16-byte aligned; 4-byte copies need D even
# and 4-byte alignment), float4-style or float columns (D % 8) and one or
# four columns per thread; these cases take all six instances of each, K =
# 1, n_topk 1 and 4K, repeated and clipped ids and a batch of two.
QUADTREE_BF16_CASES = (
    (1, 2, 8, (8, 12), 3, "repeated", 1, 0),    # 16-byte, vec
    (1, 4, 32, (8, 8), 4, "distinct", 16, 2),   # 4-byte (4 bytes off), vec
    (1, 3, 6, (8, 12), 3, "clip", 12, 0),       # 4-byte, float; all 4K
    (1, 8, 80, (4, 8), 2, "repeated", 3, 0),    # 16-byte, vec, four
    (1, 8, 80, (4, 8), 2, "clip", 8, 2),        # 4-byte, vec, four
    (1, 6, 30, (8, 8), 2, "distinct", 5, 0),    # 4-byte, float, four
    (1, 2, 8, (8, 8), 1, "clip", 4, 0),         # K = 1: 4 candidates
    (2, 8, 32, (8, 12), 5, "clip", 7, 0))       # a batch of two, main H, D

# The bf16 instance of C: (B, H, D, grid, w, corners past the edge, offset
# in bf16 elements).  16-byte copies when H*D % 8 == 0 and q/k/v are
# aligned, else 4-byte (H*D even); float4-style columns when D % 8 == 0;
# one or four columns per thread: all eight instances, w = 1, a batch of
# two.
WINDOW_BF16_CASES = (
    (1, 4, 32, 24, 5, True, 0),      # 16-byte, vec: 4c's 1/4 level
    (1, 2, 8, 12, 2, False, 2),      # 4-byte (4 bytes off), vec
    (1, 2, 6, 12, 2, True, 0),       # 4-byte (H*D % 8), float columns
    (1, 4, 6, 12, 2, False, 0),      # 16-byte, float columns
    (1, 8, 256, 4, 1, True, 0),      # 16-byte, vec, four per thread
    (1, 3, 46, 8, 2, True, 0),       # 4-byte, float, four per thread
    (1, 40, 6, 8, 2, True, 0),       # 16-byte, float, four per thread
    (1, 4, 160, 8, 2, True, 2),      # 4-byte, vec, four per thread
    (1, 1, 64, 8, 1, False, 0),      # w = 1
    (2, 2, 32, 12, 5, True, 0))      # a batch of two: 2c's 1/2 level H, D


def block_ids(torch, gen, B, n_blk, K, H, kind):
    """Quadtree block ids [B, n_blk, K, H] int32: distinct per (parent,
    head), repeated (one row all equal), or "clip" (below 0 and past the
    grid, the clipped-gather rule)."""
    if kind == "distinct":
        ids = torch.argsort(torch.rand((B, n_blk, n_blk, H), generator=gen,
                                       device="cuda"), dim=2)[:, :, :K]
    else:
        lo, hi = (0, n_blk) if kind == "repeated" else (-n_blk - 3,
                                                       n_blk + 3)
        ids = torch.randint(lo, hi, (B, n_blk, K, H), generator=gen,
                            device="cuda")
        if kind == "repeated":
            ids[0, 0, :, 0] = ids[0, 0, 0, 0]
        else:
            ids[0, 0, :3, 0] = torch.tensor([-1, -2 * n_blk, n_blk])[:K]
    return ids.to(torch.int32).contiguous()


def bf16_grad_errors(torch, fn, qkv, g):
    """A bf16 autograd function's gradients against the f32 kernel's: the
    gradients of sum(fn(q, k, v) * g) through the bf16 instances (rounded
    to bf16 on return) and through the f32 instances on the widened
    values, and their errors {name: (err, tol)}, the tolerance
    (BF16_GRAD_TOL + KERNEL_TOL) x max(1, max |f32 gradient|): one bf16
    rounding of each gradient and the f32 kernels' atomics order."""
    grads = {}
    for dt in (torch.bfloat16, torch.float32):
        xs = [t.detach().to(dt).requires_grad_(True) for t in qkv]
        (fn(*xs) * g).sum().backward()
        grads[dt] = [x.grad for x in xs]
    errs = {}
    for n, a, b in zip(("dq", "dk", "dv"), grads[torch.bfloat16],
                       grads[torch.float32]):
        check(a.dtype == torch.bfloat16 and b.dtype == torch.float32,
              f"bf16 gradient {n}: dtypes {a.dtype}, {b.dtype}")
        errs[f"autograd {n}"] = (
            float((a.float() - b).abs().max()),
            (BF16_GRAD_TOL + KERNEL_TOL) * max(1.0, float(b.abs().max())))
    return errs


def quadtree_bf16_cases_check(torch):
    """The bf16 instances of A (public wrapper, and with its log-sum-exp
    through the launcher), A′ (public wrapper) and A-bwd (wrapper) on
    QUADTREE_BF16_CASES, against the plain versions on the same bf16
    inputs (f32 arithmetic on the bf16 values); A′'s selection as in phase
    2; then the gradients of A's and A′'s public wrappers through the bf16
    instances against the f32 instances' on the widened values."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    gen = torch.Generator(device="cuda").manual_seed(7)
    for B, H, D, hw, K, kind, topk, offset in QUADTREE_BF16_CASES:
        L, n_blk = hw[0] * hw[1], (hw[0] // 2) * (hw[1] // 2)
        q, k, v = (offset_randn(torch, gen, offset, (B, L, H, D),
                                torch.bfloat16) for _ in range(3))
        ids = block_ids(torch, gen, B, n_blk, K, H, kind)
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        got = ((qk_.quadtree_fine_attention(q, k, v, ids, hw, hw),)
               + qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2])
        msg, score, idx = qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, topk)
        p_msg, p_score, p_idx = qk_.quadtree_fine_topk_plain(
            q, k, v, ids, hw, hw, min(topk + 1, 4 * K))
        d_got = qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse, g,
                                                hw, hw)
        d_want = qk_.quadtree_fine_attention_bwd_plain(q, k, v, ids, out,
                                                       lse, g, hw, hw)
        torch.cuda.synchronize()
        errs = {n: (float((a - b).abs().max()), KERNEL_TOL) for n, a, b in zip(
            ("message", "message with LSE", "lse", "A′ message"),
            got + (msg,), (out, out, lse, p_msg))}
        for n, a, b in zip(("dq", "dk", "dv"), d_got, d_want):
            errs[n] = (float((a - b).abs().max()), KERNEL_TOL * (
                1.0 if n == "dq" else max(1.0, float(b.abs().max()))))
        errs.update(bf16_grad_errors(
            torch, lambda q, k, v: qk_.quadtree_fine_attention(
                q, k, v, ids, hw, hw), (q, k, v), g))
        errs.update({"A′ " + n: e for n, e in bf16_grad_errors(
            torch, lambda q, k, v: qk_.quadtree_fine_topk(
                q, k, v, ids, hw, hw, topk)[0], (q, k, v), g).items()})
        if topk < 4 * K:
            everywhere = torch.ones((B, L, H), dtype=torch.bool,
                                    device="cuda")
            s_err, idx_bad, _, _, _ = selection_errors(
                torch, score, idx, p_score, p_idx, topk, everywhere)
        else:
            s_err = float((score - p_score).abs().max())
            idx_bad = int((idx.sort(dim=2).values
                           != p_idx.sort(dim=2).values).any(dim=2).sum())
        log(f"kernel quadtree_fine_attention(_topk, _bwd)_bf16 [B={B} H={H} "
            f"D={D} {hw[0]}x{hw[1]} K={K} {kind} ids top {topk}"
            + (f" {2 * offset} bytes off" if offset else "")
            + "]: max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items())
            + f", A′ score {s_err:.3e}; A′ index sets differ on {idx_bad} "
            "rows")
        for n, (e, tol) in errs.items():
            check(e <= tol, f"quadtree bf16 B={B} H={H} D={D} grid={hw} "
                  f"K={K} {kind}: {n} max abs error {e:.3e} > {tol:.3g}")
        check(s_err <= SCORE_TOL and idx_bad == 0, f"quadtree bf16 B={B} "
              f"H={H} D={D} grid={hw} K={K} {kind}: A′ selection")


def window_bf16_cases_check(torch):
    """The bf16 instances of C (public wrapper, and with its log-sum-exp
    through the launcher) and C-bwd (wrapper) on WINDOW_BF16_CASES, against
    the plain versions on the same bf16 inputs; then the gradients of C's
    public wrapper through the bf16 instances against the f32 instances'
    on the widened values."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    gen = torch.Generator(device="cuda").manual_seed(8)
    for B, H, D, grid, w, edge, offset in WINDOW_BF16_CASES:
        L, half, hw = grid * grid, grid // 2, (grid, grid)
        q, k, v = (offset_randn(torch, gen, offset, (B, L, H, D),
                                torch.bfloat16) for _ in range(3))
        lo, hi = (-2, half - w + 3) if edge else (0, half - w + 1)
        corners = torch.randint(lo, hi, (B, L // 4, 2), generator=gen,
                                device="cuda", dtype=torch.int32)
        if edge:
            corners[0, :4] = torch.tensor([[-1, -1], [half - 1, half - 1],
                                           [0, half], [-L, 3]])
        out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
            q, k, v, corners, hw, hw, w, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        got = ((wk.window_cross_attention(q, k, v, corners, hw, hw, w),)
               + wk._launch_wca_fwd(q, k, v, corners, hw, hw, w, True))
        d_got = wk.window_cross_attention_bwd(q, k, v, corners, out, lse, g,
                                              hw, hw, w)
        d_want = wk.window_cross_attention_bwd_plain(q, k, v, corners, out,
                                                     lse, g, hw, hw, w)
        torch.cuda.synchronize()
        errs = {n: (float((a - b).abs().max()), KERNEL_TOL) for n, a, b in zip(
            ("message", "message with LSE", "lse"), got, (out, out, lse))}
        for n, a, b in zip(("dq", "dk", "dv"), d_got, d_want):
            errs[n] = (float((a - b).abs().max()), KERNEL_TOL * (
                1.0 if n == "dq" else max(1.0, float(b.abs().max()))))
        errs.update(bf16_grad_errors(
            torch, lambda q, k, v: wk.window_cross_attention(
                q, k, v, corners, hw, hw, w), (q, k, v), g))
        log(f"kernel window_cross_attention(_bwd)_bf16 [B={B} H={H} D={D} "
            f"{grid}x{grid} w={w}" + (" edge corners" if edge else "")
            + (f" {2 * offset} bytes off" if offset else "") + "]: "
            "max_abs_err " + ", ".join(f"{n} {e:.3e}"
                                       for n, (e, _) in errs.items()))
        for n, (e, tol) in errs.items():
            check(e <= tol, f"window_cross_attention bf16 B={B} H={H} D={D} "
                  f"grid={grid} w={w}: {n} max abs error {e:.3e} > "
                  f"{tol:.3g}")


def bf16_refusals_check(torch):
    """What the bf16 instances do not take raises ValueError on the card
    before any launch: an odd head width (A, A′, A-bwd) or row width (C,
    C-bwd), and q/k/v 2 bytes off 4-byte alignment.  The forward wrappers
    are called with a gradient to come, so the backward's limits are the
    forward's: the refusal comes before any launch."""
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    gen = torch.Generator(device="cuda").manual_seed(9)
    hw, L = (8, 8), 64
    ids = block_ids(torch, gen, 1, 16, 2, 1, "distinct")
    corners = torch.zeros((1, 16, 2), dtype=torch.int32, device="cuda")

    def qkv(D, offset=0):
        return [offset_randn(torch, gen, offset, (1, L, 1, D),
                             torch.bfloat16).requires_grad_(True)
                for _ in range(3)]

    def saved(q):   # a forward's output, log-sum-exp and a cotangent
        o = torch.zeros((1, 16, 4, 1, q.shape[-1]), device="cuda")
        return o, o[..., 0].contiguous(), o

    calls = {
        "A": lambda q, k, v: qk_.quadtree_fine_attention(q, k, v, ids, hw,
                                                         hw),
        "A′": lambda q, k, v: qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, 2),
        "C": lambda q, k, v: wk.window_cross_attention(q, k, v, corners, hw,
                                                       hw, 2),
        "A-bwd": lambda q, k, v: qk_.quadtree_fine_attention_bwd(
            q, k, v, ids, *saved(q), hw, hw),
        "C-bwd": lambda q, k, v: wk.window_cross_attention_bwd(
            q, k, v, corners, *saved(q), hw, hw, 2)}
    before = dict(kernels.LAUNCHES)
    refused = []
    for kernel, fn in calls.items():
        for what, args in (("odd width", qkv(5)),
                           ("2 bytes off", qkv(8, offset=1))):
            try:
                fn(*args)
            except ValueError as e:
                refused.append(f"{kernel} {what}: {e}")
                continue
            raise AssertionError(f"bf16 {kernel} with {what} did not raise")
    torch.cuda.synchronize()
    check(kernels.LAUNCHES == before, "bf16 refusals: a kernel launched")
    for line in refused:
        log(f"kernel bf16 refusal: {line}")


def bf16_kernel_rows(torch, rows, gen, path, levels):
    """The bf16 instances of A (104^2), A′ (52^2, top 16) and C (208^2 H=4,
    416^2 H=2) at the 832^2 eval's shapes, on inputs rounded to bf16 (the
    bf16 eval path's gather tables), against their plain versions on the
    same bf16 inputs; the library yardstick is SDPA on the bf16 windows."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    bf = torch.bfloat16
    (l_inter, inter), (l_fine, fine) = [
        (label, (tuple(t.to(bf) for t in qkv), ids, hw))
        for label, (qkv, ids, hw) in levels.items()]
    (q, k, v), ids, hw = fine
    P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
    kernel_row(
        torch, rows, "quadtree_fine_attention_bf16", l_fine, path,
        lambda: qk_.quadtree_fine_attention(q, k, v, ids, hw, hw),
        lambda: qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw),
        f"q/k/v {list(q.shape)} bf16 ids {list(ids.shape)}",
        nbytes(q, k, v, ids) + P * 4 * H * D * 4, 0,
        library=quadtree_library(torch, q, k, v, ids, hw, False),
        bf16_flops=attention_flops(P * H, 4 * K, D))
    topk_row(torch, rows, l_inter, path, inter, fine, 16, False)
    for grid, H, suffix in ((208, 4, ""), (416, 2, " (2c)")):
        corners = window_inputs(torch, gen, grid // 2)
        w, D, P = 5, 32, corners.shape[1]
        q, k, v = (torch.randn((1, grid * grid, H, D), generator=gen,
                               device="cuda").to(bf) for _ in range(3))
        hw = (grid, grid)
        kernel_row(
            torch, rows, "window_cross_attention_bf16",
            f"{grid}x{grid} H={H} D={D} w={w}", path + suffix,
            lambda: wk.window_cross_attention(q, k, v, corners, hw, hw, w),
            lambda: wk.window_cross_attention_plain(q, k, v, corners, hw, hw,
                                                    w),
            f"q/k/v {list(q.shape)} bf16 corners {list(corners.shape)}",
            nbytes(q, k, v, corners) + P * 4 * H * D * 4, 0,
            library=window_library(torch, q, k, v, corners, hw, w, False),
            bf16_flops=attention_flops(P * H, 4 * w * w, D))


def bf16_bwd_rows(torch, rows, gen, path, levels):
    """The bf16 instances of A-bwd (88^2 and 44^2) and C-bwd (176^2 H=4,
    352^2 H=2) at the 704^2 training step's shapes, on inputs rounded to
    bf16 (the bf16 step's gather tables), against their plain versions on
    the same bf16 values, from the plain forward's output and log-sum-exp
    and a random f32 cotangent: dq within KERNEL_TOL, dk and dv within
    KERNEL_TOL x max(1, max |plain|).  The outputs are f32; the yardstick is
    the backward of SDPA on the bf16 windows."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    bf = torch.bfloat16
    for label, (qkv, ids, hw) in levels.items():
        q, k, v = (t.to(bf) for t in qkv)
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        kernel_row(
            torch, rows, "quadtree_fine_attention_bwd_bf16", label, path,
            lambda: qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse,
                                                    g, hw, hw),
            lambda: qk_.quadtree_fine_attention_bwd_plain(
                q, k, v, ids, out, lse, g, hw, hw),
            f"q/k/v {list(q.shape)} bf16 ids {list(ids.shape)}",
            nbytes(q, k, v, ids, out, lse, g) + 3 * q.numel() * 4, 0,
            scattered=(1, 2),
            library=quadtree_library(torch, q, k, v, ids, hw, True),
            bf16_flops=attention_flops(P * H, 4 * K, D, backward=True))
    for grid, H, suffix in ((TRAIN_SIZE // 4, 4, ""),
                            (TRAIN_SIZE // 2, 2, " (2c)")):
        corners = window_inputs(torch, gen, grid // 2)
        w, D, P = 5, 32, corners.shape[1]
        q, k, v = (torch.randn((1, grid * grid, H, D), generator=gen,
                               device="cuda").to(bf) for _ in range(3))
        hw = (grid, grid)
        out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
            q, k, v, corners, hw, hw, w, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        kernel_row(
            torch, rows, "window_cross_attention_bwd_bf16",
            f"{grid}x{grid} H={H} D={D} w={w}", path + suffix,
            lambda: wk.window_cross_attention_bwd(q, k, v, corners, out, lse,
                                                  g, hw, hw, w),
            lambda: wk.window_cross_attention_bwd_plain(
                q, k, v, corners, out, lse, g, hw, hw, w),
            f"q/k/v {list(q.shape)} bf16 corners {list(corners.shape)}",
            nbytes(q, k, v, corners, out, lse, g) + 3 * q.numel() * 4, 0,
            scattered=(1, 2),
            library=window_library(torch, q, k, v, corners, hw, w, True),
            bf16_flops=attention_flops(P * H, 4 * w * w, D, backward=True))


def window_rows(torch, rows, gen, path, grid, C, H, train, with_c=True):
    """Kernels B and C (B alone without ``with_c``) on a grid x grid cascade
    level (w = 5; window scores over C channels, cross-attention with H
    heads of 32); for training with C's log-sum-exp output, and B-bwd and
    C-bwd."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    corners = window_inputs(torch, gen, grid // 2)
    w, D = 5, 32
    P = corners.shape[1]
    NC = 4 * w * w
    q_blk = torch.randn((1, P, 4, C), generator=gen, device="cuda") * C ** -0.25
    feat1 = torch.randn((1, grid, grid, C), generator=gen,
                        device="cuda") * C ** -0.25
    label = f"{grid}x{grid} C={C} w={w}"
    desc = (f"q_blk {list(q_blk.shape)} feat1 {list(feat1.shape)} "
            f"corners {list(corners.shape)}")
    if not train:
        kernel_row(torch, rows, "window_patch_score", label, path,
                   lambda: wk.window_patch_score(q_blk, feat1, corners, w),
                   lambda: wk.window_patch_score_plain(q_blk, feat1,
                                                          corners, w),
                   desc, nbytes(q_blk, feat1, corners) + P * 4 * NC * 4,
                   P * 4 * NC * C * 2,
                   library=score_library(torch, q_blk, feat1, corners, w))
    else:
        g = torch.randn((1, P, 4, NC), generator=gen, device="cuda")
        kernel_row(torch, rows, "window_patch_score", label, path,
                   lambda: wk.window_patch_score(q_blk, feat1, corners, w),
                   lambda: wk.window_patch_score_plain(q_blk, feat1,
                                                          corners, w),
                   desc, nbytes(q_blk, feat1, corners, g), P * 2 * 4 * NC * C,
                   library=score_library(torch, q_blk, feat1, corners, w))
        kernel_row(torch, rows, "window_patch_score_bwd", label, path,
                   lambda: wk.window_patch_score_bwd(q_blk, feat1,
                                                        corners, g, w),
                   lambda: wk.window_patch_score_bwd_plain(
                       q_blk, feat1, corners, g, w),
                   desc, nbytes(q_blk, feat1, corners, g, q_blk, feat1),
                   P * 2 * (2 * 4 * NC * C), scattered=(1,))
    if not with_c:
        return

    q, k, v = (torch.randn((1, grid * grid, H, D), generator=gen,
                           device="cuda") for _ in range(3))
    hw = (grid, grid)
    desc = f"q/k/v {list(q.shape)} corners {list(corners.shape)}"
    label = f"{grid}x{grid} H={H} D={D} w={w}"
    if not train:
        kernel_row(torch, rows, "window_cross_attention", label, path,
                   lambda: wk.window_cross_attention(q, k, v, corners, hw,
                                                        hw, w),
                   lambda: wk.window_cross_attention_plain(
                       q, k, v, corners, hw, hw, w),
                   desc, nbytes(q, k, v, corners) + P * 4 * H * D * 4,
                   attention_flops(P * H, NC, D),
                   library=window_library(torch, q, k, v, corners, hw, w,
                                          False))
        return
    out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
        q, k, v, corners, hw, hw, w, with_lse=True))
    g = torch.randn(out.shape, generator=gen, device="cuda")
    kernel_row(torch, rows, "window_cross_attention", label + " with LSE",
               path,
               lambda: wk._launch_wca_fwd(q, k, v, corners, hw, hw, w,
                                             True),
               lambda: wk.window_cross_attention_plain(
                   q, k, v, corners, hw, hw, w, with_lse=True),
               desc, nbytes(q, k, v, corners, out, lse),
               attention_flops(P * H, NC, D),
               library=window_library(torch, q, k, v, corners, hw, w, False),
               note=LSE_NOTE)
    kernel_row(torch, rows, "window_cross_attention_bwd", label, path,
               lambda: wk.window_cross_attention_bwd(
                   q, k, v, corners, out, lse, g, hw, hw, w),
               lambda: wk.window_cross_attention_bwd_plain(
                   q, k, v, corners, out, lse, g, hw, hw, w),
               desc, nbytes(q, k, v, corners, out, lse, g) + 3 * nbytes(q),
               attention_flops(P * H, NC, D, backward=True), scattered=(1, 2),
               library=window_library(torch, q, k, v, corners, hw, w, True))
    if grid == TRAIN_SIZE // 4:
        window_edge_check(torch, gen, q, k, v, corners, hw, w)


def recipe_rows(torch, rows, gen, path, g, topks, train):
    """Kernels A (finest g x g level) and A′ (intermediate, top
    ``topks[1]``) of another recipe's 1/8 pyramid (coarse and intermediate
    top-k ``topks``), in f32 and through their bf16 instances on the inputs
    rounded to bf16; with ``train`` A with its log-sum-exp, A′ through its
    autograd function, and A-bwd (f32 and bf16) at both levels."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    levels = quadtree_inputs(torch, gen, g, topks)
    for bf16 in (False, True):
        lv = {label: ((tuple(t.to(torch.bfloat16) for t in qkv) if bf16
                       else qkv), ids, hw)
              for label, (qkv, ids, hw) in levels.items()}
        sfx = "_bf16" if bf16 else ""
        (l_inter, inter), (l_fine, fine) = lv.items()
        for label, ((q, k, v), ids, hw) in lv.items():
            if label == l_inter and not train:
                continue
            P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
            desc = (f"q/k/v {list(q.shape)} {str(q.dtype)[6:]} ids "
                    f"{list(ids.shape)}")
            if label == l_fine:
                fwd = attention_flops(P * H, 4 * K, D)
                kernel_row(
                    torch, rows, "quadtree_fine_attention" + sfx,
                    label + (" with LSE" if train else ""), path,
                    (lambda: qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2])
                    if train else
                    (lambda: qk_.quadtree_fine_attention(q, k, v, ids, hw,
                                                         hw)),
                    lambda: qk_.quadtree_fine_attention_plain(
                        q, k, v, ids, hw, hw, with_lse=train),
                    desc, nbytes(q, k, v, ids) + P * 4 * H * (D + train) * 4,
                    0 if bf16 else fwd, bf16_flops=fwd if bf16 else 0,
                    library=quadtree_library(torch, q, k, v, ids, hw, False),
                    note=LSE_NOTE if train else "")
            if train:
                out, lse = (t.contiguous() for t in
                            qk_.quadtree_fine_attention_plain(
                                q, k, v, ids, hw, hw, with_lse=True))
                g_ = torch.randn(out.shape, generator=gen, device="cuda")
                bwd = attention_flops(P * H, 4 * K, D, backward=True)
                kernel_row(
                    torch, rows, "quadtree_fine_attention_bwd" + sfx, label,
                    path,
                    lambda: qk_.quadtree_fine_attention_bwd(
                        q, k, v, ids, out, lse, g_, hw, hw),
                    lambda: qk_.quadtree_fine_attention_bwd_plain(
                        q, k, v, ids, out, lse, g_, hw, hw),
                    desc, nbytes(q, k, v, ids, out, lse, g_)
                    + 3 * q.numel() * 4,
                    0 if bf16 else bwd, bf16_flops=bwd if bf16 else 0,
                    scattered=(1, 2),
                    library=quadtree_library(torch, q, k, v, ids, hw, True))
        topk_row(torch, rows, l_inter + (" with LSE" if train else ""), path,
                 inter, fine, topks[1], train)


def indoor_plain_paths(torch, gen, grid=160, ws=7):
    """The indoor recipe's 1/4-level paths that run in plain PyTorch (no
    kernel, as in the JAX package), timed on the card at bucket 640's
    shapes beside kernel C on the same windows: the relative-PE cascade
    attention (gather path, bias [1, 4, grid^2, 100]) forward and forward
    plus backward, and a POLA block (C = 128, 4 heads, window ``ws``)
    forward and forward plus backward; each forward's output checked
    finite.  Returns {path: ms}."""
    from casmtr_tpu_torch.models.pola import POLATransBlock
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    from casmtr_tpu_torch.ops.quadtree import cascade_qtatt_b
    corners = window_inputs(torch, gen, grid // 2)
    w, H, D = 5, 4, 32
    hw = (grid, grid)
    pos = (corners[:, :, None, :].long() + torch.stack(torch.meshgrid(
        torch.arange(w, device="cuda"), torch.arange(w, device="cuda"),
        indexing="ij"), -1).reshape(1, 1, w * w, 2))
    q, k, v = (torch.randn((1, grid * grid, H, D), generator=gen,
                           device="cuda", requires_grad=True)
               for _ in range(3))
    rel = torch.randn((1, H, grid * grid, 4 * w * w), generator=gen,
                      device="cuda")
    block = POLATransBlock(H * D, H, ws).cuda()
    x = torch.randn((1, grid * grid, H * D), generator=gen, device="cuda",
                    requires_grad=True)

    def gather():
        return cascade_qtatt_b(q, k, v, pos, hw, hw, rel_pos=rel,
                               window_structured=True)[0]

    def kernel_c():
        return wk.window_cross_attention(q, k, v, corners, hw, hw, w)

    def pola():
        return block(x, grid, grid)

    out = {}
    for name, fn in (("relative-PE gather path", gather),
                     ("kernel C, same windows", kernel_c),
                     ("POLA block", pola)):
        with torch.no_grad():
            check(bool(torch.isfinite(fn()).all()), f"{name}: non-finite")
            out[name] = time_ms(torch, fn, reps=10)
        y = fn()
        g = torch.randn(y.shape, device="cuda")
        out[name + " fwd+bwd"] = time_ms(
            torch, lambda: torch.autograd.grad(fn(), [x] if fn is pola
                                               else [q, k, v], g), reps=10)
    log(f"plain paths of {INDOOR} at {grid}x{grid} (H={H}, D={D}, w={w}; "
        f"POLA ws={ws}): " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in out.items()))
    return out


def kernel_phase(torch):
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (
        quadtree_fine_attention, quadtree_fine_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    path = "serving 832^2"

    # kernel A at both fine levels (on the main path at the finest only)
    levels = quadtree_inputs(torch, gen, 104)
    for label, ((q, k, v), ids, hw) in levels.items():
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        kernel_row(
            torch, rows, "quadtree_fine_attention", label, path,
            lambda: quadtree_fine_attention(q, k, v, ids, hw, hw),
            lambda: quadtree_fine_attention_plain(q, k, v, ids, hw, hw),
            f"q/k/v {list(q.shape)} ids {list(ids.shape)}",
            nbytes(q, k, v, ids) + P * 4 * H * D * 4,
            attention_flops(P * H, 4 * K, D),
            library=quadtree_library(torch, q, k, v, ids, hw, False))
    # kernel A′ at the intermediate level, top 16 of 128 candidates
    inter, finest = levels.values()
    topk_row(torch, rows, "intermediate 52x52", path, inter, finest, 16,
             False)
    topk_nan_check(torch, gen)

    # kernels B and C at the 1/4 level, and at 2c's 1/2 level
    window_rows(torch, rows, gen, path, 208, 128, 4, False)
    window_rows(torch, rows, gen, path + " (2c)", 416, 64, 2, False)

    # the bf16 instances of A, A′ and C (the card's eval default)
    bf16_kernel_rows(torch, rows, gen, path, levels)
    quadtree_bf16_cases_check(torch)
    window_bf16_cases_check(torch)
    bf16_refusals_check(torch)

    # the shapes of quadtree_baseline at bucket 832 (topks 16 / 8: K = 16
    # at 52^2, K = 8 at 104^2) and of the indoor recipe at bucket 640
    # (topks 32 / 16 at 40^2 and 80^2; kernel B at the 1/4 level)
    recipe_rows(torch, rows, gen, f"serving 832^2 ({BASELINE})", 104,
                (16, 8), False)
    recipe_rows(torch, rows, gen, f"serving 640^2 ({INDOOR})", 80, (32, 16),
                False)
    window_rows(torch, rows, gen, f"serving 640^2 ({INDOOR})", 160, 128, 4,
                False, with_c=False)
    indoor_plain_paths(torch, gen)
    return rows


def train_kernel_phase(torch):
    """The kernels at the shapes of the 704^2 training step: kernels A, A′
    and C with their log-sum-exp output (written when a gradient will be
    needed), and the three backward kernels, each against its plain version
    from the same forward output, log-sum-exp and a random cotangent."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    path = "train 704^2"
    g8 = TRAIN_SIZE // 8

    levels = quadtree_inputs(torch, gen, g8)
    for label, ((q, k, v), ids, hw) in levels.items():
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        desc = f"q/k/v {list(q.shape)} ids {list(ids.shape)}"
        kernel_row(
            torch, rows, "quadtree_fine_attention", label + " with LSE", path,
            lambda: qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2],
            lambda: qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw,
                                                      with_lse=True),
            desc, nbytes(q, k, v, ids, out, lse),
            attention_flops(P * H, 4 * K, D),
            library=quadtree_library(torch, q, k, v, ids, hw, False),
            note=LSE_NOTE)
        kernel_row(
            torch, rows, "quadtree_fine_attention_bwd", label, path,
            lambda: qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse,
                                                    g, hw, hw),
            lambda: qk_.quadtree_fine_attention_bwd_plain(
                q, k, v, ids, out, lse, g, hw, hw),
            desc, nbytes(q, k, v, ids, out, lse, g) + 3 * nbytes(q),
            attention_flops(P * H, 4 * K, D, backward=True), scattered=(1, 2),
            library=quadtree_library(torch, q, k, v, ids, hw, True))
    inter, finest = levels.values()
    topk_row(torch, rows, f"intermediate {g8 // 2}x{g8 // 2} with LSE", path,
             inter, finest, 16, True)

    window_rows(torch, rows, gen, path, TRAIN_SIZE // 4, 128, 4, True)
    window_rows(torch, rows, gen, path + " (2c)", TRAIN_SIZE // 2, 64, 2,
                True)

    # the bf16 instances of A-bwd and C-bwd (the card's training default)
    bf16_bwd_rows(torch, rows, gen, path, levels)
    window_cases_check(torch)
    score_cases_check(torch)
    quadtree_cases_check(torch)

    # quadtree_baseline's step at 704^2 and the indoor recipe's at 640^2
    recipe_rows(torch, rows, gen, f"train 704^2 ({BASELINE})", g8, (16, 8),
                True)
    g8 = TRAIN_SIZES[INDOOR] // 8
    recipe_rows(torch, rows, gen, f"train {g8 * 8}^2 ({INDOOR})", g8,
                (32, 16), True)
    window_rows(torch, rows, gen, f"train {g8 * 8}^2 ({INDOOR})", g8 * 2, 128,
                4, True, with_c=False)
    return rows


def finite_difference_phase(torch):
    """Each autograd function on the card at a tiny shape: the gradient its
    backward kernel gives for sum(out * cot), along a random direction,
    against the central difference of its forward kernel (evaluated in
    float32, summed in float64)."""
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (
        quadtree_fine_attention, quadtree_fine_topk)
    from casmtr_tpu_torch.ops.kernels.window_kernels import (
        window_cross_attention, window_patch_score)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    hw = (8, 12)
    cases = {
        # block ids may repeat within one (parent, head)
        "QuadtreeFineAttention": (
            lambda q, k, v, i: quadtree_fine_attention(q, k, v, i, hw, hw),
            [randn(1, 96, 2, 8) for _ in range(3)],
            [randint(24, 1, 24, 3, 2)]),
        # the message of kernel A′ (its selection carries no gradient)
        "QuadtreeFineAttention with topk": (
            lambda q, k, v, i: quadtree_fine_topk(q, k, v, i, hw, hw, 4)[0],
            [randn(1, 96, 2, 8) for _ in range(3)],
            [randint(24, 1, 24, 3, 2)]),
        "WindowPatchScore": (
            lambda q, f1, c: window_patch_score(q, f1, c, 2),
            [randn(1, 48, 4, 12), randn(1, 12, 16, 12)],
            [torch.stack([randint(5, 1, 48), randint(7, 1, 48)], -1)]),
        "WindowCrossAttention": (
            lambda q, k, v, c: window_cross_attention(q, k, v, c, (12, 12),
                                                      (12, 12), 2),
            [randn(1, 144, 2, 8) for _ in range(3)], [randint(5, 1, 36, 2)]),
    }
    for name, (fn, floats, ints) in cases.items():
        xs = [x.clone().requires_grad_(True) for x in floats]
        out = fn(*xs, *ints)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        (out * cot).sum().backward()
        errs = []
        for i, x in enumerate(xs):
            direction = torch.randn(x.shape, generator=gen, device="cuda")
            analytic = float((x.grad.double() * direction.double()).sum())

            def f(delta):
                args = list(floats)
                args[i] = floats[i] + delta * direction
                with torch.no_grad():
                    return float((fn(*args, *ints).double()
                                  * cot.double()).sum())

            fd = (f(FD_EPS) - f(-FD_EPS)) / (2 * FD_EPS)
            errs.append(abs(fd - analytic) / max(abs(analytic), 1e-3))
        log(f"finite difference: {name} on the card, relative error per "
            f"input " + ", ".join(f"{e:.2e}" for e in errs)
            + f" (tol {FD_TOL:g}, eps {FD_EPS:g})")
        check(max(errs) <= FD_TOL, f"finite difference: {name} gradient "
              "disagrees with its forward")


# --------------------------------------------------------------------------
# phase 4: serving through the Matcher
# --------------------------------------------------------------------------

def texture(rng, h, w):
    """A uint8 RGB scene: smooth gratings plus random blobs and noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(0.01, 0.12, 2)
            img[..., c] += np.sin(fy * yy + fx * xx + rng.uniform(0, 6))
    for _ in range(60):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(4, 30)
        img += (rng.uniform(-1, 1, 3)
                * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2)[..., None])
    img += 0.1 * rng.standard_normal(img.shape)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def requests(rng, bucket=832):
    """(name, image0, image1): a scene and a shifted or cropped copy; at
    bucket 640 (the indoor recipe) three ScanNet-sized 640x480 frames."""
    out = []
    if bucket == 640:
        for dy, dx in ((13, 7), (9, 21), (17, 4)):
            big = texture(rng, 540, 700)
            out.append((f"480x640 shifted by ({dy}, {dx}) px", big[:480, :640],
                        big[dy:dy + 480, dx:dx + 640]))
        return out
    big = texture(rng, 900, 900)
    out.append(("832x832 shifted by (17, 9) px", big[:832, :832],
                big[17:849, 9:841]))
    big = texture(rng, 900, 900)
    out.append(("832x832 cropped to 768x768 (resized)", big[:832, :832],
                big[40:808, 30:798]))
    big = texture(rng, 700, 900)
    out.append(("600x800 non-square shifted by (11, 23) px", big[:600, :800],
                big[11:611, 23:823]))
    return out


@contextlib.contextmanager
def precision(name):
    """The card's default ("bf16": the variables of PRECISION_ENV unset),
    float32 forced ("f32": both "0"), bf16 forced ("bf16 forced": both "1",
    which on the CPU gives bf16 stacks and f32 kernel inputs) or a bf16
    backbone ("bf16 backbone": CASMTR_BACKBONE_BF16=1 alone, which on the
    CPU gives the bf16 training step's backbone with float32 stacks and
    kernel inputs)."""
    saved = {k: os.environ.pop(k, None) for k in PRECISION_ENV}
    if name == "bf16 backbone":
        os.environ["CASMTR_BACKBONE_BF16"] = "1"
    elif name != "bf16":
        value = {"f32": "0", "bf16 forced": "1"}[name]
        os.environ.update({k: value for k in PRECISION_ENV})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def matcher_for(name, **kw):
    """``serving.Matcher`` of MODELS[name] with ``kw`` (``overrides``
    replaces the model's own).  A REFINED model is the Matcher's canvas,
    masks and selection around the PMT-refine assembly: the port's Matcher,
    as the JAX package's, has no refine switch, so its factory is swapped
    for the construction only."""
    from casmtr_tpu_torch import serving
    base, overrides = MODELS[name]
    kw.setdefault("overrides", overrides or None)
    if name not in REFINED:
        return serving.Matcher(base, **kw)
    build = serving.build_model
    serving.build_model = functools.partial(build, refine=True)
    try:
        return serving.Matcher(base, **kw)
    finally:
        serving.build_model = build


def serve(torch, matcher, recipe, reqs, prec):
    """The requests through ``matcher`` (of MODELS[recipe]) in precision
    ``prec`` ("bf16", the card's default, or "f32" forced), the launch
    counts zeroed just before and each request's counts held to the
    model's per-pair count."""
    from casmtr_tpu_torch.ops import kernels
    expected = (LAUNCHES_PER_PAIR if prec == "bf16"
                else LAUNCHES_PER_PAIR_F32)[recipe]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    steady = []
    for i, (name, img0, img1) in enumerate(reqs):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = matcher.match(img0, img1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        n = len(res.mconf)
        check(res.mkpts0.shape == (n, 2) and res.mkpts1.shape == (n, 2),
              "serving: result shapes")
        check(bool(np.isfinite(res.mkpts0).all() and
                   np.isfinite(res.mkpts1).all() and
                   np.isfinite(res.mconf).all()), "serving: non-finite result")
        h0, w0 = img0.shape[:2]
        check(n == 0 or (res.mkpts0.min() >= 0 and
                         res.mkpts0[:, 0].max() <= w0 and
                         res.mkpts0[:, 1].max() <= h0),
              "serving: keypoints outside image0")
        tag = "warm-up" if i == 0 else "steady"
        if i:
            steady.append(ms)
        log(f"serving: {recipe} {prec} request {i} ({tag}) {name}: "
            f"{ms:.1f} ms, {n} matches at thr {matcher.thr}, kernel "
            f"launches {counts}")
        check(counts == expected,
              f"serving: {recipe} {prec} launches {counts}, expected "
              f"{expected}")
    totals = dict(kernels.LAUNCHES)
    log(f"serving: {recipe} {prec} steady latency "
        + ", ".join(f"{t:.1f}" for t in steady) + " ms; launches over the "
        f"{len(reqs)} requests {totals}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for k, v in totals.items():
        check(v > 0 or expected[k] == 0,
              f"serving: {recipe} {prec}: kernel {k} never launched on the "
              "path")
    return totals, counts, steady


def serving_phase(torch, recipe, precs=("bf16", "f32")):
    """Matcher(MODELS[recipe], bucket=BUCKET[recipe]) answers the requests
    in the card's eval default (bf16), then with float32 forced
    (``precs``), from the same weights in one process.  Returns
    ({precision: (launch totals, last request's counts, steady ms)}, the
    matcher, a request to profile)."""
    t0 = time.perf_counter()
    bucket = BUCKET[recipe]
    matcher = matcher_for(recipe, bucket=bucket, seed=0)
    n_params = sum(p.numel() for p in matcher.model.parameters())
    log(f"serving: Matcher('{recipe}', bucket={bucket}) on "
        f"{matcher.device}, {type(matcher.model).__name__}, {n_params} "
        f"parameters (seeded random), built in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = requests(np.random.default_rng(0), bucket)
    runs = {}
    for prec in precs:
        with precision(prec):
            runs[prec] = serve(torch, matcher, recipe, reqs, prec)
    return runs, matcher, reqs[1]


def top(avgs, keep, n):
    """The n profiler rows that ``keep`` selects with the most self device
    time (ms, count, name, input shapes), and their summed time over all
    selected rows."""
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key,
                    e.input_shapes) for e in avgs if keep(e)),
                  key=lambda r: -r[0])
    return rows[:n], sum(r[0] for r in rows)


def profile_phase(torch, recipe, matcher, request, prec, conv_ab=False):
    """One more steady request in precision ``prec`` under torch.profiler:
    device time summed over the request's kernels against its wall time,
    and device time by operator (the convolutions also by input shape) and
    by kernel; with ``conv_ab`` also the FPN conv's cuDNN algorithm
    choices."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    name, img0, img1 = request
    torch.cuda.synchronize()
    with precision(prec), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        t0 = time.perf_counter()
        matcher.match(img0, img1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    avgs = prof.key_averages()
    kern, busy = top(avgs, lambda e: e.device_type == DeviceType.CUDA, 10)
    if busy == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    ops, _ = top(avgs, lambda e: e.key.startswith("aten::")
                 and e.self_device_time_total > 0, 10)
    convs, _ = top(prof.key_averages(group_by_input_shape=True),
                   lambda e: e.key == "aten::cudnn_convolution", 6)
    ours, ours_ms = top(avgs, lambda e: e.device_type == DeviceType.CUDA
                        and "casmtr::" in e.key, 7)
    log(f"profile: {recipe} {prec} request {name} under the profiler: wall "
        f"{wall:.1f} ms, device time summed over kernels {busy:.1f} ms, of "
        f"which the CUDA kernels of this port {ours_ms:.1f} ms")
    for ms, n, key, _ in ops:
        log(f"profile: op     {ms:8.3f} ms {n:5d}x {key}")
    for ms, n, key, shapes in convs:
        log(f"profile: conv   {ms:8.3f} ms {n:5d}x input, weight "
            f"{shapes[:2]}")
    for ms, n, key, _ in kern:
        log(f"profile: kernel {ms:8.3f} ms {n:5d}x {key[:80]}")
    for ms, n, key, _ in ours:
        log(f"profile: ours   {ms:8.3f} ms {n:5d}x {key.split('(')[0]}")
    if conv_ab:
        conv_algorithm_ab()


# cuDNN caches the algorithm it first picks for a convolution's shapes,
# whatever mode picked it, so each mode is timed in a process of its own
CONV_PROBE = """
import statistics, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = sys.argv[1] == "1"
conv = torch.nn.Conv2d(256, 128, 3, padding=1, bias=False).cuda()
x = torch.randn(2, 256, 208, 208, device="cuda").contiguous(
    memory_format=torch.channels_last)
times = []
with torch.inference_mode():
    for i in range(6):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record(); conv(x); e.record(); torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
print(statistics.median(times[1:]))
"""


def conv_algorithm_ab():
    """The Twins FPN's 3x3 256->128 conv at its 832^2 input (2 images of
    256 x 208 x 208, channels-last as the FPN makes it): cuDNN's heuristic
    algorithm choice against its autotuner, each in a fresh process."""
    ms = {}
    for tuned in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", CONV_PROBE, tuned],
                             capture_output=True, text=True, check=True,
                             timeout=300)
        ms[tuned] = float(out.stdout.strip().splitlines()[-1])
    t_bound, by = bound((2 * 256 + 2 * 128) * 208 * 208 * 4
                        + 128 * 256 * 9 * 4, 2 * 208 * 208 * 128 * 256 * 9 * 2)
    log(f"profile: conv 3x3 256->128 on 2 x 256 x 208 x 208: cuDNN heuristic "
        f"{ms['0']:.3f} ms, autotuned {ms['1']:.3f} ms, bound {t_bound:.3f} "
        f"ms ({by})")


# --------------------------------------------------------------------------
# phase 6: the card against the CPU on a small input
# --------------------------------------------------------------------------

def zero_threshold_overrides(name):
    """MODELS[name]'s overrides with every match threshold at 0, so every
    stage matches."""
    n = LAYOUT[name][1]
    overrides = copy.deepcopy(MODELS[name][1])
    loftr = overrides.setdefault("loftr", {})
    loftr["match_coarse"] = {"thr": 0.0}
    if n:
        loftr["match_cascade"] = {
            "test_thr": [0.0] * n,
            "pre_thr": [[0.0] * (i + 1) for i in range(n)]}
    return overrides


def reference_forward(torch, recipe, dev, img0, img1, prepare=None,
                      nudge=0.0):
    """MODELS[recipe] at full width at bucket 256, thresholds 0, seeded
    random weights, on ``dev``, in the precision the environment gives
    there; ``prepare(model)`` runs first (to hook it), and ``nudge``
    multiplies the packed images by (1 + nudge x a seeded normal draw)."""
    m = matcher_for(recipe, bucket=256, thr=0.0,
                    overrides=zero_threshold_overrides(recipe), device=dev,
                    seed=0)
    batch = m._pack([(img0, img1)])
    if nudge:
        gen = torch.Generator().manual_seed(0)
        for k in ("image0", "image1"):
            batch[k] = batch[k] * (1 + nudge * torch.randn(
                tuple(batch[k].shape), generator=gen)).to(dev)
    if prepare is not None:
        prepare(m.model)
    with torch.inference_mode():
        return m.model(batch)


def compare_outputs(torch, a, b):
    """Coarse and per-level window confidences' max abs differences, and
    per stage (1/8, each cascade level, final) the valid (b, i, j) sets'
    sizes and Jaccard and the common matches' largest confidence and
    keypoint (mkpts1, px) differences, of outputs ``a`` against ``b``."""
    def by_pair(m):
        v = m.valid.cpu().numpy()
        keys = zip(*(getattr(m, n).cpu().numpy()[v]
                     for n in ("b_ids", "i_ids", "j_ids")))
        return ({tuple(int(x) for x in k): i for i, k in enumerate(keys)},
                m.mconf.cpu().numpy()[v], m.mkpts1.cpu().numpy()[v])

    conf = float((a.coarse.conf_matrix.cpu()
                  - b.coarse.conf_matrix.cpu()).abs().max())
    window = {lvl: float((a.cascades[lvl].conf_matrix.cpu()
                          - b.cascades[lvl].conf_matrix.cpu()).abs().max())
              for lvl in b.cascades}
    stages = {"1/8": (a.coarse.matches, b.coarse.matches)}
    stages.update({lvl: (a.cascades[lvl].matches, b.cascades[lvl].matches)
                   for lvl in b.cascades})
    stages["final"] = (a.final_matches, b.final_matches)
    out = {}
    for name, (ma, mb) in stages.items():
        (ka, ca, pa), (kb, cb, pb) = by_pair(ma), by_pair(mb)
        common = ka.keys() & kb.keys()
        out[name] = dict(
            n=(len(ka), len(kb)),
            jaccard=len(common) / max(1, len(ka.keys() | kb.keys())),
            conf=max((abs(float(ca[ka[k]] - cb[kb[k]])) for k in common),
                     default=0.0),
            px=max((float(np.abs(pa[ka[k]] - pb[kb[k]]).max())
                    for k in common), default=0.0))
    return conf, window, out


def describe(conf, window, stages):
    return (f"coarse conf max_abs_err {conf:.3e}, window conf max_abs_err "
            + ", ".join(f"{lvl} {e:.3e}" for lvl, e in window.items())
            + "; " + "; ".join(
                f"{n} matches {s['n'][0]} vs {s['n'][1]} Jaccard "
                f"{s['jaccard']:.4f} common conf {s['conf']:.3e} px "
                f"{s['px']:.3e}" for n, s in stages.items()))


def hook_trunk(store, feed, model):
    """Forward hooks on a REFINED model's frozen trunk (``backbone`` and
    ``loftr_coarse``): each module's output is kept in ``store``; with
    ``feed`` (outputs kept from another run) the module's output is
    replaced by that run's, moved to its device."""
    for name in FROZEN_TRUNK:
        def hook(module, args, out, name=name):
            store[name] = out
            if feed is not None:
                return type(out)(t.to(out[0].device) for t in feed[name])
        getattr(model, name).register_forward_hook(hook)


def frozen_trunk_reference(torch, recipe, img0, img1, cpu, trunk):
    """A REFINED model's f32 serving reference, card against CPU, held at
    what lies on either side of its trunk's discrete choices (the 1/8
    quadtree's top-k, which a relative nudge of TRUNK_NUDGE of the images
    flips on the CPU alone: printed).  The trunk's backbone maps within
    BACKBONE_RTOL of their largest value; the heads (ladder, 1/4 stack,
    window matching, fine stage) on the CPU's trunk outputs ``trunk``, the
    card against the CPU's output ``cpu``, at the recipes' gates, which
    the caller applies to the comparison returned."""
    with precision("f32"):
        nudged = reference_forward(torch, recipe, "cpu", img0, img1,
                                   nudge=TRUNK_NUDGE)
        own = {}
        card = reference_forward(torch, recipe, "cuda", img0, img1,
                                 functools.partial(hook_trunk, own, trunk))
    log(f"reference: {recipe} the CPU's own response to a nudge of "
        f"{TRUNK_NUDGE:g} of the images: "
        + describe(*compare_outputs(torch, nudged, cpu)))
    peak = max(float((a.double().cpu() - b.double()).abs().max()
                     / b.double().abs().max())
               for a, b in zip(own["backbone"], trunk["backbone"]))
    log(f"reference: {recipe} frozen trunk, card f32 vs CPU f32: backbone "
        f"maps {peak:.2e} of their largest value (tol {BACKBONE_RTOL:g})")
    check(peak <= BACKBONE_RTOL, "reference: trunk backbone maps disagree")
    out = compare_outputs(torch, card, cpu)
    log(f"reference: {recipe} heads on the CPU's trunk outputs, card f32 vs "
        f"CPU f32: {describe(*out)}")
    return out


def reference_pair():
    """Phase 6's 256^2 pair: a scene and a copy shifted by (7, 5) px."""
    big = texture(np.random.default_rng(1), 300, 300)
    return big[:256, :256], big[7:263, 5:261]


def check_f32_reference(conf, window, st):
    """Phase 6's f32 gates on compare_outputs(card, CPU)."""
    fin = st["final"]
    check(fin["n"][1] > 0, "reference: no final matches on the CPU")
    check(conf <= CONF_TOL, "reference: coarse confidences disagree")
    check(max(window.values(), default=0.0) <= CONF_TOL,
          "reference: window confidences disagree")
    check(fin["jaccard"] >= MIN_JACCARD,
          "reference: final match sets disagree")
    check(fin["px"] <= PX_TOL, "reference: final keypoints disagree")


def reference_phase(torch, recipe):
    """The card against the CPU on one 256^2 pair, in two precisions: the
    card with float32 forced against the CPU's float32 default (confidences
    within CONF_TOL, final match sets at Jaccard >= MIN_JACCARD, keypoints
    within PX_TOL); the card's bf16 default against the CPU with both
    variables at 1 (bf16 stacks, f32 kernel inputs, as the JAX package's
    CPU graph), at every stage within the CPU's own bf16 against float32
    difference (the scale of bf16 rounding; see BF16_CONF_TOL).  A REFINED
    model's f32 forward is printed whole and gated by
    frozen_trunk_reference (its trunk's 1/8 top-k flips under a nudge far
    below the card's rounding)."""
    img0, img1 = reference_pair()
    outs, trunk = {}, {}
    for prec, dev in (("f32", "cuda"), ("f32", "cpu"), ("bf16", "cuda"),
                      ("bf16 forced", "cpu")):
        grab = (functools.partial(hook_trunk, trunk, None)
                if (prec, dev) == ("f32", "cpu") and recipe in REFINED
                else None)
        with precision(prec):
            outs[prec, dev] = reference_forward(torch, recipe, dev, img0,
                                                img1, grab)
    conf, window, st = compare_outputs(torch, outs["f32", "cuda"],
                                       outs["f32", "cpu"])
    log(f"reference: {recipe} bucket 256, thresholds 0, card f32 vs CPU "
        f"f32: {describe(conf, window, st)} (tol conf {CONF_TOL:g}, final "
        f"Jaccard >= {MIN_JACCARD}, px {PX_TOL:g}"
        + ("; gated on the CPU's trunk below)" if recipe in REFINED
           else ")"))
    if recipe in REFINED:
        conf, window, st = frozen_trunk_reference(
            torch, recipe, img0, img1, outs["f32", "cpu"], trunk)
    check_f32_reference(conf, window, st)

    scale = compare_outputs(torch, outs["bf16 forced", "cpu"],
                            outs["f32", "cpu"])
    noise = scale[2]
    log(f"reference: {recipe} CPU bf16 stacks vs CPU f32 (the scale of bf16 "
        f"rounding): {describe(*scale)}")
    conf, window, st = compare_outputs(torch, outs["bf16", "cuda"],
                                       outs["bf16 forced", "cpu"])
    log(f"reference: {recipe} card bf16 default vs CPU bf16 stacks: "
        f"{describe(conf, window, st)}")
    check(st["final"]["n"][1] > 0,
          "reference: no final bf16 matches on the CPU")
    for name, got in st.items():
        ref = noise[name]
        conf_tol = max(BF16_CONF_TOL, BF16_NOISE * ref["conf"])
        jac_min = min(BF16_MIN_JACCARD, ref["jaccard"]) - BF16_JACCARD_SLACK
        gated = got["n"][1] >= BF16_MIN_MATCHES
        log(f"reference: {recipe} bf16 {name}: common conf {got['conf']:.3e}"
            f" (tol {conf_tol:.3e}), Jaccard {got['jaccard']:.4f} ("
            + (f"min {jac_min:.4f})" if gated else "not gated: fewer than "
               f"{BF16_MIN_MATCHES} matches)"))
        check(got["conf"] <= conf_tol,
              f"reference: bf16 {name} confidences disagree")
        check(not gated or got["jaccard"] >= jac_min,
              f"reference: bf16 {name} match sets disagree")


# --------------------------------------------------------------------------
# phases 7 and 8: training
# --------------------------------------------------------------------------

def train_batch(size, seed):
    """A batch of one pair as numpy arrays: image0 a textured scene, image1
    the same scene shifted by TRAIN_SHIFT (a crop of it), constant depth,
    focal length ``size`` and the camera translation that maps each pixel
    of image0 onto its shifted place in image1."""
    rng = np.random.default_rng(seed)
    dy, dx = TRAIN_SHIFT
    big = texture(rng, size + dy, size + dx).astype(np.float32) / 255.0
    depth, f = 5.0, float(size)
    K = np.array([[[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]]],
                 np.float32)
    T = np.eye(4, dtype=np.float32)[None].copy()
    T[0, 0, 3], T[0, 1, 3] = -dx * depth / f, -dy * depth / f
    return {"image0": big[None, :size, :size].copy(),
            "image1": big[None, dy:dy + size, dx:dx + size].copy(),
            "depth0": np.full((1, size, size), depth, np.float32),
            "depth1": np.full((1, size, size), depth, np.float32),
            "K0": K, "K1": K.copy(), "T_0to1": T,
            "T_1to0": np.linalg.inv(T[0])[None].astype(np.float32)}


def kernel_grad_params(model):
    """The q/k/v projections whose gradients go through kernel A-bwd (the
    1/8 quadtree layers, kernels A and A′) and C-bwd (the two cross layers
    of each cascade level; the indoor recipes' take the relative-PE gather
    path instead); not those of a frozen trunk."""
    from casmtr_tpu_torch.models.casmtr_refine import (CasMTRRefine,
                                                       frozen_param_label)
    frozen = isinstance(model, CasMTRRefine)
    return [n for n, _ in model.named_parameters()
            if n.split(".")[0] in ("loftr_coarse", "loftr_coarse_8c",
                                   "loftr_coarse_4c", "loftr_coarse_2c")
            and n.split(".")[-2] in ("q_proj", "k_proj", "v_proj")
            and not (frozen and frozen_param_label(n))]


def model_config(name, **loftr):
    """The configuration of MODELS[name] with the ``loftr`` overrides on
    top."""
    from casmtr_tpu_torch.configs import build_config
    recipe, overrides = MODELS[name]
    overrides = copy.deepcopy(overrides)
    overrides.setdefault("loftr", {}).update(loftr)
    return build_config(recipe, overrides=overrides)


def build_trainer(torch, name, size, device=None, model=None, **loftr):
    """MODELS[name] at ``size`` (with the ``loftr`` overrides) with seeded
    random weights (or a copy of ``model``), its optimizer state and its
    step; a REFINED model with its trunk frozen."""
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.models.casmtr_refine import frozen_param_label
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    cfg = model_config(name, train_size=size, **loftr)
    refine = name in REFINED
    if model is None:
        model = build_model(cfg.loftr, refine=refine)
        init_random_(model, torch.Generator().manual_seed(0))
    state, tx = init_train_state(
        model, cfg, steps_per_epoch=1000, base_lr=1e-3, device=device,
        frozen_label_fn=frozen_param_label if refine else None)
    return model, state, make_train_step(model, cfg, tx, device=device)


def zoo_watch(model):
    """A ZOO model's new modules: the parameters whose gradients must be
    finite and nonzero at every step (the global block's sr projection and
    its keys/values, the LKA convs, the 1/8 relative-PE tables, the Guided
    layers' q/k/v, which go through kernel A-bwd), and the LKABlocks'
    BatchNorm statistics, which must move at every step."""
    from casmtr_tpu_torch.models.cascade_attention import (DoubleGroupBlock,
                                                           LKABlock)
    from casmtr_tpu_torch.models.transformer import QuadtreeBlock
    params, stats = [], []
    for n, m in model.named_modules():
        if isinstance(m, DoubleGroupBlock):
            params += [f"{n}.block_global.attn.{p}.weight"
                       for p in ("sr", "kv")]
        elif isinstance(m, LKABlock):
            params += [f"{n}.attn.spatial_gating_unit.{c}.weight"
                       for c in ("conv0", "conv_spatial", "conv1")]
            stats += [f"{n}.norm{i}.running_{s}" for i in (1, 2)
                      for s in ("mean", "var")]
        elif isinstance(m, QuadtreeBlock) and m.attn.attn_type == "Guided":
            params += [f"{n}.attn.{p}_proj.weight" for p in "qkv"]
    params += [n for n, _ in model.named_parameters()
               if n.startswith("loftr_coarse_8c.") and "pos_bias" in n]
    return params, stats


def training_phase(torch, name, prec, steps=4):
    """MODELS[name] trained at TRAIN_SIZES[name] in precision ``prec``, which
    the
    caller sets ("bf16", the card's default: bf16 backbone and kernel
    inputs, float32 stacks; or "f32" forced): the step's dtypes, a warm-up
    step, then ``steps`` timed steps with the launch counts zeroed just
    before and read just after each, held to the precision's per-step
    count; a ZOO model also with finite nonzero gradients on its new
    modules and its LKA BatchNorm statistics moved at every step
    (zoo_watch)."""
    from casmtr_tpu_torch.models.backbone.resnet_fpn import backbone_dtype
    from casmtr_tpu_torch.models.transformer import (table_dtype,
                                                     transformer_dtype)
    from casmtr_tpu_torch.ops import kernels
    recipe = f"{name} {prec}"
    size = TRAIN_SIZES[name]
    model, state, step = build_trainer(torch, name, size)
    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    dts = (backbone_dtype(dev, True), transformer_dtype(dev, True),
           table_dtype(dev))
    log(f"training: {recipe} step precision: backbone {dts[0]}, stacks "
        f"{dts[1]}, kernel inputs {dts[2]}")
    check(dts == ((bf, f32, bf) if prec == "bf16" else (f32, f32, f32)),
          f"training: {recipe}: step dtypes {dts}")
    levels = ([f"{lvl}c" for lvl in model.config.cascade_levels]
              if model.config.cascade else [])
    expected = (LAUNCHES_PER_TRAIN_STEP if prec == "bf16"
                else LAUNCHES_PER_TRAIN_STEP_F32)[name]
    n_params = sum(p.numel() for p in model.parameters())
    watch = kernel_grad_params(model)
    refine = name in REFINED
    n_watch = 3 * LAYOUT[name][0] * (not refine) + 6 * len(levels)
    new, new_stats = zoo_watch(model)
    check(name in ZOO or len(watch) == n_watch, f"training: {len(watch)} "
          f"trainable q/k/v projections, expected {n_watch}")
    check((name in ZOO) == bool(new), f"training: {name}: new modules "
          f"{new}")
    watch += new
    buffers = dict(model.named_buffers())
    params = dict(model.named_parameters())
    start = {n: params[n].detach().clone() for n in watch}
    trunk = {}
    if refine:
        from casmtr_tpu_torch.models.casmtr_refine import frozen_param_label
        trunk = {n: t.clone() for n, t in model.state_dict().items()
                 if frozen_param_label(n)}
    batch = train_batch(size, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, scalars = step(state, batch)
    torch.cuda.synchronize()
    log(f"training: {recipe} {size}^2 batch 1, {n_params} "
        f"parameters (seeded random), warm-up step "
        f"{time.perf_counter() - t0:.2f} s, loss {float(scalars['loss']):.4f}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for i in range(steps):
        before = dict(kernels.LAUNCHES)
        stats = {n: buffers[n].clone() for n in new_stats}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, scalars = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        vals = {k: float(v) for k, v in scalars.items()}
        log(f"training: {recipe} step {i + 1}: {times[-1]:.4f} s, "
            + ", ".join(f"{k} {v:.4g}" for k, v in sorted(vals.items()))
            + f", kernel launches {counts}")
        check(all(np.isfinite(v) for v in vals.values()),
              "training: non-finite loss or gradient norm")
        for lvl in levels:
            check(vals[f"valid_n_{lvl}"] > 0,
                  f"training: no {lvl} match to supervise")
        check(counts == expected,
              f"training: {recipe} launches {counts}, expected {expected}")
        for n in watch:
            g = params[n].grad
            check(g is not None and bool(torch.isfinite(g).all())
                  and float(g.abs().max()) > 0,
                  f"training: no finite nonzero gradient on {n}")
        for n, t in stats.items():
            check(not torch.equal(t, buffers[n]),
                  f"training: {n} did not move")
    if new:
        log(f"training: {recipe} new modules: finite nonzero gradients at "
            f"every step on {len(new)} parameters ({', '.join(new)}); "
            f"{len(new_stats)} LKA BatchNorm statistics moved at every step")
    totals = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(start[n], params[n].detach()) for n in watch)
    check(moved == len(watch), f"training: {len(watch) - moved} q/k/v "
          "projections did not move")
    if refine:
        sd = model.state_dict()
        same = sum(torch.equal(t, sd[n]) for n, t in trunk.items())
        log(f"training: {recipe} frozen trunk after the {1 + len(times)} "
            f"steps: {same} of {len(trunk)} parameters and BatchNorm "
            "buffers bit-identical")
        check(same == len(trunk) > 0, "training: the frozen trunk changed")
    for k, v in totals.items():
        check(v > 0 or expected[k] == 0,
              f"training: kernel {k} never launched on the main path")
    log(f"training: {recipe} median {statistics.median(times):.4f} s/step "
        f"(steps {', '.join(f'{t:.4f}' for t in times)}), peak device "
        f"memory {peak:.2f} GiB, "
        f"launches over the {len(times)} steps {totals}"
        + ("; the reference's own quadtree GPU step (the architecture of "
           f"{BASELINE}), for context only: {REFERENCE_S_PER_STEP} s (fp16, "
           "704^2, bench.py)" if name == BASELINE else ""))
    return totals, counts, step, state, batch, times


def train_profile_phase(torch, recipe, step, state, batch, median_s):
    """One more training step under torch.profiler: device time summed over
    its kernels against its wall time (the host's and the idle share), and
    device time by operator and by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kern, busy = top(avgs, lambda e: e.device_type == DeviceType.CUDA, 12)
    if busy == 0:
        log("training profile: the profiler recorded no device time (not "
            "measured)")
        return
    ops, _ = top(avgs, lambda e: e.key.startswith("aten::")
                 and e.self_device_time_total > 0, 12)
    log(f"training profile: {recipe} one step: wall {wall:.1f} ms under the "
        f"profiler, device time summed over kernels {busy:.1f} ms; idle "
        f"share {1 - busy / wall:.3f} of the profiled step, "
        f"{1 - busy / (median_s * 1e3):.3f} of the median unprofiled step")
    ours, ours_ms = top(avgs, lambda e: e.device_type == DeviceType.CUDA
                        and "casmtr::" in e.key, 7)
    for ms, n, key, _ in ops:
        log(f"training profile: op     {ms:8.3f} ms {n:5d}x {key}")
    for ms, n, key, _ in kern:
        log(f"training profile: kernel {ms:8.3f} ms {n:5d}x {key[:80]}")
    for ms, n, key, _ in ours:
        log(f"training profile: ours   {ms:8.3f} ms {n:5d}x "
            f"{key.split('(')[0]}")
    log(f"training profile: the port's CUDA kernels {ours_ms:.1f} ms of the "
        f"{busy:.1f} ms of device time")


def coarse_gradient(torch, model, batch, dev):
    """The gradient of loss_8c on the kernel-path q/k/v projections of the
    1/8 stack (kernel_grad_params), from one forward in train mode and no
    update, flattened in float64 on the CPU.  The BatchNorm statistics are
    restored afterwards."""
    from casmtr_tpu_torch.train.train_step import (forward_loss,
                                                   prepare_batch)
    lcfg = model.config
    batch, gt = prepare_batch(batch, lcfg, torch.device(dev))
    stats = [b.clone() for b in model.buffers()]
    model.train()
    _, scalars = forward_loss(model, batch, gt, lcfg)
    params = dict(model.named_parameters())
    leaves = [params[n] for n in kernel_grad_params(model)
              if n.startswith(("loftr_coarse.", "loftr_coarse_8c."))]
    grads = torch.autograd.grad(scalars["loss_8c"], leaves)
    with torch.no_grad():
        for b, s in zip(model.buffers(), stats):
            b.copy_(s)
    return torch.cat([g.flatten() for g in grads]).double().cpu()


def reference_step(torch, name, size, dev, base, prec, nudge=None):
    """One step of MODELS[name] at ``size`` on ``dev`` from a copy of the
    CPU model ``base`` in precision ``prec``, with the images times (1 +
    NUDGE x a normal draw of seed ``nudge``) when given: (scalars, gradients
    by parameter in float64 on the CPU, seconds, coarse_gradient taken
    before the step)."""
    batch = train_batch(size, 1)
    if nudge is not None:
        rng = np.random.default_rng(nudge)
        for k in ("image0", "image1"):
            batch[k] = (batch[k] * (1 + NUDGE * rng.standard_normal(
                batch[k].shape))).astype(np.float32)
    with precision(prec):
        model, state, step = build_trainer(torch, name, size, device=dev,
                                           model=copy.deepcopy(base))
        # a frozen trunk's 1/8 stack takes no gradient
        coarse = (None if name in REFINED
                  else coarse_gradient(torch, model, batch, dev))
        t0 = time.perf_counter()
        _, scalars = step(state, batch)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().double().cpu() for n, p in model.named_parameters()}
    return ({k: float(v) for k, v in scalars.items()}, grads,
            time.perf_counter() - t0, coarse)


def cosine(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def leaf_errors(torch, ga, gb):
    """Gradients ``ga`` against ``gb`` (by name): the cosine of the whole
    flattened gradients and the worst per-leaf relative error (leaf norms
    floored at 1e-3 of the whole gradient's: a leaf whose gradient vanishes
    analytically, a bias in front of a training-mode BatchNorm, holds only
    rounding noise) with its leaf."""
    fa = torch.cat([ga[n].flatten() for n in gb])
    fb = torch.cat([gb[n].flatten() for n in gb])
    floor = 1e-3 * float(fb.norm())
    worst = max((float((ga[n] - gb[n]).norm()) / max(float(gb[n].norm()),
                                                      floor), n) for n in gb)
    return cosine(fa, fb), worst


def step_difference(torch, a, b):
    """Step ``a`` against step ``b`` (reference_step's results): the
    relative difference of each loss term, leaf_errors and the cosine of
    the coarse_gradients."""
    (sa, ga, _, ca), (sb, gb, _, cb) = a, b
    rel = {k: abs(sa[k] - sb[k]) / (abs(sb[k]) or 1.0) for k in sb
           if k.startswith("loss")}
    cos, worst = leaf_errors(torch, ga, gb)
    return rel, cos, worst, (float("nan") if cb is None else cosine(ca, cb))


def backbone_stage(torch, base, size, dev, prec):
    """The backbone of a copy of ``base`` (of a REFINED model: its ladder,
    fed the frozen trunk's 1/4 and 1/2 maps, taken once in f32 on the CPU)
    on ``dev`` in train mode in precision ``prec``, on the reference
    batch's two images as the model's forward feeds them, and the gradients
    of its parameters for a seeded cotangent of its maps: (maps, running
    statistics after the forward, the maps' product with the cotangent,
    gradients by parameter), in float64 on the CPU."""
    batch = train_batch(size, 1)
    x = torch.from_numpy(np.concatenate([batch["image0"], batch["image1"]])
                         ).permute(0, 3, 1, 2)
    feats = None
    if hasattr(base, "ladder"):
        with precision("f32"), torch.no_grad():
            feats = base.backbone(x)[1:]
    x = x.to(dev)
    rng = np.random.default_rng(2)
    with precision(prec):
        if feats is None:
            bb = copy.deepcopy(base.backbone).to(dev).train()
            maps = bb(x)
        else:
            bb = copy.deepcopy(base.ladder).to(dev).train()
            maps = bb(x, [f.to(dev) for f in feats])
        dot = sum((m * torch.from_numpy(rng.standard_normal(
            tuple(m.shape)).astype(np.float32)).to(dev)).sum() for m in maps)
        params = dict(bb.named_parameters())
        grads = torch.autograd.grad(dot, list(params.values()))

    def cpu(t):
        return t.detach().double().cpu()

    return ([cpu(m) for m in maps],
            {n: cpu(b) for n, b in bb.named_buffers()
             if not n.endswith("num_batches_tracked")},
            float(dot.detach()), dict(zip(params, map(cpu, grads))))


def backbone_difference(torch, a, b):
    """backbone_stage ``a`` against ``b``: the maps' largest error of their
    largest value and RMS error of their RMS (worst map), the running
    statistics' largest error, the relative error of the cotangent product,
    and leaf_errors."""
    (ma, sa, da, ga), (mb, sb, db, gb) = a, b
    peak = max(float((x - y).abs().max() / y.abs().max())
               for x, y in zip(ma, mb))
    rms = max(float((x - y).pow(2).mean().sqrt() / y.pow(2).mean().sqrt())
              for x, y in zip(ma, mb))
    stats = max(float((sa[n] - sb[n]).abs().max()) for n in sb)
    return peak, rms, stats, abs(da - db) / abs(db), leaf_errors(torch, ga,
                                                                   gb)


def backbone_reference(torch, name, base, size):
    """The variant's backbone stage (a REFINED model's ladder), card against
    CPU: in f32 within BACKBONE_RTOL and MIN_GRAD_COS; the card's bf16
    default against the CPU's bf16 backbone within BF16_TRAIN_NOISE x the
    CPU's own bf16-against-f32 difference."""
    res = {(dev, prec): backbone_stage(torch, base, size, dev, prec)
           for dev, prec in (("cuda", "f32"), ("cpu", "f32"), ("cuda", "bf16"),
                             ("cpu", "bf16 backbone"))}
    part = "ladder" if name in REFINED else "backbone"
    peak, rms, stats, dot, (cos, (worst, worst_name)) = backbone_difference(
        torch, res["cuda", "f32"], res["cpu", "f32"])
    log(f"training reference: {name} {part} {size}^2 train mode, card f32 "
        f"vs CPU f32: maps {peak:.2e} of their largest value, running "
        f"statistics {stats:.2e}, cotangent product {dot:.2e} (tol "
        f"{BACKBONE_RTOL:g} each); gradient cosine {cos:.8f} (min "
        f"{MIN_GRAD_COS}), worst per-leaf relative error {worst:.2e} "
        f"({worst_name}, not gated)")
    check(max(peak, stats, dot) <= BACKBONE_RTOL,
          f"training reference: {part} maps or statistics disagree")
    check(cos >= MIN_GRAD_COS,
          f"training reference: {part} gradients disagree")
    own = backbone_difference(torch, res["cpu", "bf16 backbone"],
                              res["cpu", "f32"])
    got = backbone_difference(torch, res["cuda", "bf16"],
                              res["cpu", "bf16 backbone"])
    for label, i in (("maps RMS error", 1), ("running statistics", 2),
                     ("cotangent product", 3)):
        tol = BF16_TRAIN_NOISE * own[i]
        log(f"training reference: {name} {part} bf16 {label}: {got[i]:.3e} "
            f"(tol {tol:.3e}; the CPU's own {own[i]:.3e})")
        check(got[i] <= tol, f"training reference: bf16 {part} {label} "
              "disagrees")
    tol = BF16_TRAIN_NOISE * (1 - own[4][0])
    log(f"training reference: {name} {part} bf16 1 - gradient cosine "
        f"{1 - got[4][0]:.3e} (tol {tol:.3e}; the CPU's own "
        f"{1 - own[4][0]:.3e})")
    check(1 - got[4][0] <= tol,
          f"training reference: bf16 {part} gradients disagree")


def cascade_stack_reference(torch, name, base, size):
    """Each cascade stack of MODELS[name] (kernels C and C-bwd) alone, in
    train mode, on the inputs it took in the CPU's f32 step, with a seeded
    cotangent of its two outputs: card f32 and the card's bf16 default
    (bf16 q/k/v) against CPU f32, the outputs and the gradients of the
    stack's kernel-path q/k/v projections (see BF16_STACK_RTOL)."""
    from casmtr_tpu_torch.train.train_step import (forward_loss,
                                                   prepare_batch)
    levels = base.config.cascade_levels
    grab = {}
    model = copy.deepcopy(base).train()
    hooks = [getattr(model, f"loftr_coarse_{lvl}c").register_forward_pre_hook(
        lambda m, args, lvl=lvl: grab.update({lvl: args}))
        for lvl in levels]
    with precision("f32"), torch.no_grad():
        batch, gt = prepare_batch(train_batch(size, 1), model.config,
                                  torch.device("cpu"))
        forward_loss(model, batch, gt, model.config)
    for h in hooks:
        h.remove()
    for lvl in levels:
        stack = f"loftr_coarse_{lvl}c"
        watch = [n.split(".", 1)[1] for n in kernel_grad_params(base)
                 if n.startswith(stack + ".")]
        res = {}
        for dev, prec in (("cpu", "f32"), ("cuda", "f32"), ("cuda", "bf16")):
            rng = np.random.default_rng(3)
            with precision(prec):
                st = copy.deepcopy(getattr(base, stack)).to(dev).train()
                args = [x.to(dev) if isinstance(x, torch.Tensor) else x
                        for x in grab[lvl]]
                outs = st(*args)[:2]
                dot = sum((o * torch.from_numpy(rng.standard_normal(
                    tuple(o.shape)).astype(np.float32)).to(dev)).sum()
                    for o in outs)
                params = dict(st.named_parameters())
                grads = torch.autograd.grad(dot, [params[n] for n in watch])
            res[prec if dev == "cuda" else "cpu"] = (
                [o.detach().double().cpu() for o in outs],
                torch.cat([g.flatten() for g in grads]).double().cpu())
        want, want_g = res["cpu"]
        for prec in ("f32", "bf16"):
            outs, g = res[prec]
            peak = max(float((x - y).abs().max() / y.abs().max())
                       for x, y in zip(outs, want))
            rms = max(float((x - y).pow(2).mean().sqrt()
                            / y.pow(2).mean().sqrt())
                      for x, y in zip(outs, want))
            cos = cosine(g, want_g)
            tol = (f"largest error {peak:.2e} of the largest value (tol "
                   f"{BACKBONE_RTOL:g})" if prec == "f32" else
                   f"RMS error {rms:.2e} of the RMS (tol "
                   f"{BF16_STACK_RTOL:.2e})")
            log(f"training reference: {name} {stack} alone, card {prec} vs "
                f"CPU f32: outputs {tol}; q/k/v gradients ({len(watch)} "
                f"leaves) 1 - cosine {1 - cos:.3e} (tol "
                f"{1 - MIN_GRAD_COS:.0e})")
            check((peak <= BACKBONE_RTOL) if prec == "f32"
                  else (rms <= BF16_STACK_RTOL),
                  f"training reference: {stack} {prec} outputs disagree")
            check(cos >= MIN_GRAD_COS,
                  f"training reference: {stack} {prec} gradients disagree")


def train_reference_phase(torch, name):
    """One step of MODELS[name] at 256^2 on the card and on the CPU (the
    kernels' plain versions) from the same weights and batch.  For the two
    recipes: with float32 forced on both, each loss term within
    TRAIN_LOSS_RTOL relative, the whole gradient's and coarse_gradient's
    cosine >= MIN_GRAD_COS; the card's bf16 default (bf16 backbone and
    kernel inputs) against the CPU with CASMTR_BACKBONE_BF16=1 (bf16
    backbone, f32 kernel inputs), each loss term and 1 - cosine (whole and
    coarse_gradient's) within BF16_TRAIN_NOISE x the CPU's own
    bf16-backbone-against-f32 difference (floors BF16_LOSS_RTOL and 1 -
    MIN_GRAD_COS); then cascade_stack_reference.  For the ResNetFPN-based
    models (the 4c variant, quadtree_baseline and the indoor recipe, whose
    1/8 top-k picks may flip under rounding): the f32 step printed beside
    the CPU's response to a nudge of its images, and backbone_reference;
    for the indoor recipe also cascade_stack_reference (its 1/4 stack:
    POLA and the relative-PE gather path, no discrete choice inside)."""
    size = 256
    base, _, _ = build_trainer(torch, name, size, device="cpu")
    runs = [("cuda", "f32"), ("cpu", "f32")]
    if name in RECIPES:
        runs += [("cuda", "bf16"), ("cpu", "bf16 backbone")]
    res = {(dev, prec): reference_step(torch, name, size, dev, base, prec)
           for dev, prec in runs}

    def valid(key):
        return ", ".join(f"{k} {res[key][0][k]:.0f}"
                         for k in sorted(res[key][0]) if "valid_n" in k)

    rel, cos, (worst, worst_name), coarse = step_difference(
        torch, res["cuda", "f32"], res["cpu", "f32"])
    (sg, _, tg, _), (sc, _, tc, _) = res["cuda", "f32"], res["cpu", "f32"]
    log(f"training reference: {name} {size}^2, one step, card f32 vs CPU "
        f"f32: loss {sg['loss']:.6f} vs {sc['loss']:.6f}; card "
        f"{valid(('cuda', 'f32'))}, CPU {valid(('cpu', 'f32'))}; relative "
        + ", ".join(f"{k} {r:.2e}" for k, r in rel.items())
        + f"; gradient cosine {cos:.6f}, of loss_8c on the 1/8 q/k/v "
        f"{coarse:.8f}; worst per-leaf relative error {worst:.2e} "
        f"({worst_name}, not gated); step {tg:.2f} s on the card, "
        f"{tc:.2f} s on the CPU")
    if name not in RECIPES:
        nudged = step_difference(torch, reference_step(
            torch, name, size, "cpu", base, "f32", 0), res["cpu", "f32"])
        log(f"training reference: {name} whole step not gated: the CPU's "
            f"response to a nudge of {NUDGE:g} of its images: relative "
            + ", ".join(f"{k} {r:.2e}" for k, r in nudged[0].items())
            + f"; gradient cosine {nudged[1]:.6f}, of loss_8c on the 1/8 "
            f"q/k/v {nudged[3]:.6f}")
        backbone_reference(torch, name, base, size)
        if name in (INDOOR, REFINE):
            cascade_stack_reference(torch, name, base, size)
        return
    log(f"training reference: {name} f32 gates: each loss term within "
        f"{TRAIN_LOSS_RTOL:g}, both cosines >= {MIN_GRAD_COS}")
    for k, r in rel.items():
        check(r <= TRAIN_LOSS_RTOL, f"training reference: {k} disagrees")
    check(min(cos, coarse) >= MIN_GRAD_COS,
          "training reference: gradients disagree")

    own_rel, own_cos, _, own_coarse = step_difference(
        torch, res["cpu", "bf16 backbone"], res["cpu", "f32"])
    rel, cos, (worst, worst_name), coarse = step_difference(
        torch, res["cuda", "bf16"], res["cpu", "bf16 backbone"])
    log(f"training reference: {name} {size}^2, one step, card bf16 default "
        f"vs CPU bf16 backbone: card {valid(('cuda', 'bf16'))}, CPU "
        f"{valid(('cpu', 'bf16 backbone'))}; worst per-leaf relative error "
        f"{worst:.2e} ({worst_name}, not gated)")
    for k, r in rel.items():
        tol = max(BF16_LOSS_RTOL, BF16_TRAIN_NOISE * own_rel[k])
        log(f"training reference: {name} bf16 {k}: relative {r:.3e} (tol "
            f"{tol:.3e}; the CPU's own {own_rel[k]:.3e})")
        check(r <= tol, f"training reference: bf16 {k} disagrees")
    for label, c, c_own in (("whole gradient", cos, own_cos),
                            ("loss_8c on the 1/8 q/k/v", coarse,
                             own_coarse)):
        tol = max(1 - MIN_GRAD_COS, BF16_TRAIN_NOISE * (1 - c_own))
        log(f"training reference: {name} bf16 {label}: 1 - cosine "
            f"{1 - c:.3e} (tol {tol:.3e}; the CPU's own {1 - c_own:.3e})")
        check(1 - c <= tol, f"training reference: bf16 {label} disagrees")
    cascade_stack_reference(torch, name, base, size)


def detector_phase(torch):
    """The keypoint-detector branch: one 4c training step at 256^2 on the
    card in its default precision with the learnable head and the ST
    detector on the 1/4 level (DETECTOR), its loss_4c_det printed, and the
    head alone, in train mode on the tokens it took in that step, card
    against CPU in f32: heatmap within BACKBONE_RTOL of its largest value,
    its BatchNorm statistics within BACKBONE_RTOL."""
    size = 256
    model, state, step = build_trainer(torch, RECIPES[0], size,
                                       coarse2=DETECTOR)
    head = model.loftr_coarse_4c.detector
    grab = []
    hook = head.register_forward_pre_hook(
        lambda m, args: grab.append(args[0].detach().clone()))
    _, scalars = step(state, train_batch(size, 1))
    hook.remove()
    vals = {k: float(v) for k, v in scalars.items()}
    log(f"detector: {RECIPES[0]} {size}^2 one step with {DETECTOR}: "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(vals.items())))
    check(all(np.isfinite(v) for v in vals.values()),
          "detector: non-finite loss or gradient norm")
    check("loss_4c_det" in vals, "detector: no detector loss term")
    out = {}
    for dev in ("cuda", "cpu"):
        with precision("f32"):
            h = copy.deepcopy(head).to(dev).train()
            with torch.no_grad():
                heat = h(grab[0].to(dev))
        out[dev] = (heat.double().cpu(),
                    [b.double().cpu() for n, b in h.named_buffers()
                     if not n.endswith("num_batches_tracked")])
    (hg, sg), (hc, sc) = out["cuda"], out["cpu"]
    err = float((hg - hc).abs().max() / hc.abs().max())
    stats = max(float((a - b).abs().max()) for a, b in zip(sg, sc))
    log(f"detector: head alone on the step's {tuple(grab[0].shape)} tokens, "
        f"card f32 vs CPU f32: heatmap {err:.2e} of its largest value, "
        f"statistics {stats:.2e} (tol {BACKBONE_RTOL:g} each)")
    check(max(err, stats) <= BACKBONE_RTOL, "detector: the head disagrees")

# --------------------------------------------------------------------------
# phase 10: checkpoints and staged training
# --------------------------------------------------------------------------

def same_outputs(torch, a, b):
    """Whether two forwards' coarse and window confidences and final
    matches are bit-identical."""
    pairs = [(a.coarse.conf_matrix, b.coarse.conf_matrix)]
    pairs += [(a.cascades[k].conf_matrix, b.cascades[k].conf_matrix)
              for k in b.cascades]
    pairs += [(getattr(a.final_matches, f), getattr(b.final_matches, f))
              for f in ("b_ids", "i_ids", "j_ids", "valid", "mconf",
                        "mkpts0", "mkpts1")]
    return all(torch.equal(x, y) for x, y in pairs)


def forwards(torch, matcher, reqs):
    """The model's outputs on each request's packed batch."""
    with torch.inference_mode():
        return [matcher.model(matcher._pack([(i0, i1)])) for _, i0, i1 in
                reqs]


def first_request_probe(ckpt, warm):
    """In a fresh process: Matcher(CKPT_RECIPE, ckpt=ckpt) at bucket 832,
    ``warmup()`` first when ``warm``, then one request; prints one JSON
    line with the seconds of the warm-up and the first request's ms."""
    import torch
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.serving import Matcher
    kernels.lib()
    t0 = time.perf_counter()
    m = Matcher(CKPT_RECIPE, ckpt=ckpt, bucket=BUCKET[CKPT_RECIPE])
    built = time.perf_counter() - t0
    warm_s = None
    if warm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    _, img0, img1 = requests(np.random.default_rng(0))[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.match(img0, img1)
    torch.cuda.synchronize()
    print(json.dumps({"built_s": built, "warmup_s": warm_s,
                      "first_request_ms": (time.perf_counter() - t0) * 1e3}))
    return 0


def checkpoint_serving_phase(torch, tmp):
    """CKPT_RECIPE at full width, bucket 832, seeded random weights held in
    memory by one Matcher; its state dict written as a reference-format
    .ckpt ({"state_dict": {"matcher." + key: tensor}}) and converted by
    cli.convert into a port directory; Matcher(ckpt=file) and
    Matcher(ckpt=dir), initialized from another seed, must hold every
    parameter and buffer bit-identical to the first, and answer phase 4's
    requests in the card's default with the per-pair launch counts and
    bit-identical outputs (confidences, window confidences, final matches);
    where cuDNN's autotuner makes them differ, the difference is printed
    and the three are held to phase 6's f32 gates with float32 forced.
    Then the first request's latency in a fresh process, with and without
    ``warmup()``.  Returns {matcher: (launch totals, last counts)}."""
    from casmtr_tpu_torch.cli import convert
    from casmtr_tpu_torch.serving import Matcher
    recipe, bucket = CKPT_RECIPE, BUCKET[CKPT_RECIPE]
    ref = matcher_for(recipe, bucket=bucket, seed=0)
    ckpt = os.path.join(tmp, "released.ckpt")
    out = os.path.join(tmp, "converted")
    torch.save({"state_dict": {"matcher." + k: v.cpu() for k, v in
                               ref.model.state_dict().items()}}, ckpt)
    t0 = time.perf_counter()
    check(convert.main([ckpt, out, "--model", recipe, "--strict"]) == 0,
          "checkpoints: cli.convert failed")
    log(f"checkpoints: cli.convert of the {os.path.getsize(ckpt) / 2 ** 20:.1f}"
        f" MiB reference-format file: {time.perf_counter() - t0:.1f} s")
    want = ref.model.state_dict()
    loaded = {}
    for label, path in (("file", ckpt), ("directory", out)):
        t0 = time.perf_counter()
        m = Matcher(recipe, ckpt=path, bucket=bucket, seed=1)
        got = m.model.state_dict()
        same = sum(torch.equal(got[k], v) for k, v in want.items())
        log(f"checkpoints: Matcher(ckpt={label}) built and loaded in "
            f"{time.perf_counter() - t0:.1f} s: {same} of {len(want)} "
            "parameters and buffers bit-identical to the in-memory weights")
        check(got.keys() == want.keys() and same == len(want),
              f"checkpoints: Matcher(ckpt={label}) holds other weights")
        loaded[label] = m
    reqs = requests(np.random.default_rng(0), bucket)
    runs = {}
    for label, m in [("memory", ref)] + list(loaded.items()):
        log(f"checkpoints: phase 4's requests through the Matcher of the "
            f"{label} weights")
        runs[label] = serve(torch, m, recipe, reqs, "bf16")[:2]
    base = forwards(torch, ref, reqs)
    exact = {label: [same_outputs(torch, a, b) for a, b in
                     zip(forwards(torch, m, reqs), base)]
             for label, m in loaded.items()}
    log(f"checkpoints: bf16 outputs bit-identical to the in-memory "
        f"Matcher's per request: {exact}")
    if not all(all(v) for v in exact.values()):
        with precision("f32"):
            base = forwards(torch, ref, reqs)
            for label, m in loaded.items():
                for (name, _, _), a, b in zip(reqs, forwards(torch, m, reqs),
                                              base):
                    conf, window, st = compare_outputs(torch, a, b)
                    fin = st["final"]
                    jac = 1.0 if fin["n"] == (0, 0) else fin["jaccard"]
                    log(f"checkpoints: f32 {label} vs memory, {name}: "
                        f"{describe(conf, window, st)}")
                    check(max([conf, *window.values()]) <= CONF_TOL
                          and jac >= MIN_JACCARD and fin["px"] <= PX_TOL,
                          f"checkpoints: Matcher(ckpt={label}) disagrees")
    for warm in (False, True):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--first-request",
             out, "--warm" if warm else "--cold"], capture_output=True,
            text=True, timeout=600)
        check(res.returncode == 0, "checkpoints: the first-request probe "
              f"failed: {res.stderr[-2000:]}")
        probe = json.loads(res.stdout.strip().splitlines()[-1])
        log(f"checkpoints: fresh process, Matcher(ckpt=directory) built in "
            f"{probe['built_s']:.1f} s, "
            + (f"warmup() {probe['warmup_s']:.2f} s, " if warm else
               "no warmup(), ")
            + f"first request {probe['first_request_ms']:.1f} ms")
    return runs


def stage_lrs(tx, opt_state):
    """The learning rate of each group that holds a parameter, at the
    optimizer's next update."""
    held = set(opt_state.labels.values())
    return {g: sched(opt_state.schedule_count) * scale
            for g, (scale, sched) in tx.groups.items() if g in held}


def staged_training_phase(torch, tmp):
    """STAGED at 704^2, batch 1, full width, in the card's default precision,
    on phase 7's shifted pair: stage 1 from seeded random weights, then
    stages 2 and 3, each a fresh model of its stage (another seed)
    resumed by cli.train.resume_state from the checkpoint the stage before
    saved through CheckpointManager, then a same-stage resume at stage 3.
    Per stage one warm-up step and 2 timed steps with the launch counts
    zeroed just before and read just after each (LAUNCHES_PER_STAGE_STEP),
    finite losses of exactly the stage's terms, the kernel-path q/k/v
    projections moved; after each resume the restored tensors bit-identical
    to the checkpoint and the others to their seeded init, each group's
    learning rate at the first resumed step the schedule's at the restore
    step (the 'new' group restarting its warmup at
    warmup_ratio_stages x base_lr / 2); on the same-stage resume the
    optimizer moments and counts bit-identical to the checkpoint's.
    Returns {stage: (launch totals, last counts)}."""
    from casmtr_tpu_torch.cli.train import resume_state
    from casmtr_tpu_torch.config import override
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                                    checkpoint_state)
    from casmtr_tpu_torch.train.optim import build_lr_schedule
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    size, base_lr, spe = TRAIN_SIZE, STAGE_BASE_LR, STAGE_STEPS_PER_EPOCH
    batch = train_batch(size, 0)
    ckpts = os.path.join(tmp, "run", "ckpts")
    runs = {}
    for run, stage in enumerate(STAGES + (STAGES[-1],)):
        tag = f"stage {stage}" + (" same-stage resume" if run == 3 else "")
        cfg = override(model_config(STAGED, train_size=size,
                                    training_stage=stage),
                       {"trainer": STAGE_TRAINER})
        model = build_model(cfg.loftr)
        init_random_(model, torch.Generator().manual_seed(run))
        fresh = {k: v.clone() for k, v in model.state_dict().items()}
        state, tx = init_train_state(model, cfg, spe, base_lr)
        if run:
            restored = CheckpointManager(ckpts).restore()
            t0 = time.perf_counter()
            state, tx, _ = resume_state(cfg, state, restored, base_lr, spe,
                                        reset_lr=True)
            rstep = restored["step"]
            sd, saved = model.state_dict(), restored["state_dict"]
            taken = [k for k in sd if k in saved]
            same = sum(torch.equal(sd[k].cpu(), saved[k]) for k in taken)
            kept = sum(torch.equal(sd[k].cpu(), fresh[k])
                       for k in sd if k not in saved)
            log(f"staged: {tag}: resume_state from step {rstep} in "
                f"{time.perf_counter() - t0:.2f} s: {same} of {len(taken)} "
                f"restored tensors bit-identical to the checkpoint, {kept} "
                f"of {len(sd) - len(taken)} new ones at their seeded init")
            check(same == len(taken) > 0 and kept == len(sd) - len(taken),
                  f"staged: {tag}: the resumed weights are not the "
                  "checkpoint's and the seeded init's")
            opt, sopt = state.opt_state, restored["opt_state"]
            check(opt.schedule_count == rstep == state.step,
                  f"staged: {tag}: the schedule does not continue from "
                  "the restore step")
            lrs = stage_lrs(tx, opt)
            main_lr = build_lr_schedule(cfg.trainer, base_lr, spe)(rstep)
            want = {"main": main_lr,
                    "vit": main_lr * cfg.trainer.vit_lr_scale,
                    "new": cfg.trainer.warmup_ratio_stages * base_lr / 2}
            log(f"staged: {tag}: learning rates at the first resumed step "
                f"{lrs} (expected {want})")
            check("new" in lrs and all(
                abs(v - want[g]) <= 1e-12 for g, v in lrs.items()),
                  f"staged: {tag}: learning rates {lrs}")
            if run == 3:
                same = sum(torch.equal(opt.mu[n].cpu(), sopt["mu"][n])
                           and torch.equal(opt.nu[n].cpu(), sopt["nu"][n])
                           for n in sopt["mu"])
                log(f"staged: {tag}: optimizer moments of {same} of "
                    f"{len(sopt['mu'])} parameters bit-identical, Adam "
                    f"count {opt.count} (saved {sopt['count']})")
                check(opt.mu.keys() == sopt["mu"].keys()
                      and same == len(sopt["mu"])
                      and opt.count == sopt["count"] > 0,
                      f"staged: {tag}: the optimizer state was not kept")
        step = make_train_step(model, cfg, tx)
        watch = kernel_grad_params(model)
        params = dict(model.named_parameters())
        start = {n: params[n].detach().clone() for n in watch}
        expected = LAUNCHES_PER_STAGE_STEP[stage]
        terms = {"loss", "loss_8c", "grad_norm"} | {
            f"{k}_{lvl}c" for lvl in (4, 2)[:stage - 1]
            for k in ("loss", "valid_n")} | (
            {"loss_f"} if stage == 3 else set())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, scalars = step(state, batch)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for i in range(2):
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, scalars = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            vals = {k: float(v) for k, v in scalars.items()}
            log(f"staged: {tag} step {i + 1}: {times[-1]:.4f} s, "
                + ", ".join(f"{k} {v:.4g}" for k, v in sorted(vals.items()))
                + f", kernel launches {counts}")
            check(set(vals) == terms,
                  f"staged: {tag}: loss terms {sorted(vals)}")
            check(all(np.isfinite(v) for v in vals.values()),
                  f"staged: {tag}: non-finite loss or gradient norm")
            check(counts == expected,
                  f"staged: {tag}: launches {counts}, expected {expected}")
        totals = dict(kernels.LAUNCHES)
        for k, v in totals.items():
            check(v > 0 or expected[k] == 0,
                  f"staged: {tag}: kernel {k} never launched")
        moved = sum(not torch.equal(start[n], params[n].detach())
                    for n in watch)
        check(moved == len(watch) > 0,
              f"staged: {tag}: {len(watch) - moved} q/k/v projections did "
              "not move")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"staged: {tag}: {sum(p.numel() for p in params.values())} "
            f"parameters, warm-up step {warm:.2f} s, median "
            f"{statistics.median(times):.4f} s/step, peak device memory "
            f"{peak:.2f} GiB, {moved} of {len(watch)} kernel-path q/k/v "
            "projections moved")
        runs[tag] = (totals, counts)
        if run < 3:
            t0 = time.perf_counter()
            CheckpointManager(ckpts).save(state.step,
                                          checkpoint_state(state))
            log(f"staged: {tag}: checkpoint of step {state.step} saved in "
                f"{time.perf_counter() - t0:.2f} s")
        del model, state, step, params, tx
        torch.cuda.empty_cache()
    return runs


def checkpoint_phase(torch):
    """Phase 10 in a temporary directory that is removed afterwards."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        serving = checkpoint_serving_phase(torch, tmp)
        torch.cuda.empty_cache()
        return serving, staged_training_phase(torch, tmp)


# --------------------------------------------------------------------------
# phase 11: the model zoo
# --------------------------------------------------------------------------

def guided_inputs(torch, gen, grid, k=16, H=4, D=32):
    """Z3's Guided level on a grid x grid 1/4 map: q/k/v [1, grid^2, H, D]
    and the guide [1, (grid/2)^2, k, H], the cycle top-k of a dual-softmax
    confidence matrix of seeded 1/8 features (the model's own
    ``_cycle_topk``)."""
    import types
    from casmtr_tpu_torch.models.cascade_transformer import \
        CascadeFeatureTransformer
    L8 = (grid // 2) ** 2
    f0, f1 = (torch.randn((1, L8, 64), generator=gen, device="cuda")
              for _ in range(2))
    sim = torch.einsum("blc,bsc->bls", f0, f1) / 8.0
    conf = torch.softmax(sim, 1) * torch.softmax(sim, 2)
    cfg = model_config(Z3).loftr.coarse2
    guide = CascadeFeatureTransformer._cycle_topk(
        types.SimpleNamespace(config=cfg), conf)[0]
    check(guide.shape == (1, L8, k, H), f"guide {tuple(guide.shape)}")
    qkv = tuple(torch.randn((1, grid * grid, H, D), generator=gen,
                            device="cuda") for _ in range(3))
    return qkv, guide, (grid, grid)


def guided_rows(torch, rows, gen, path, grid, train):
    """Kernel A (and in training A with its log-sum-exp and A-bwd) at Z3's
    Guided level, f32 and through the bf16 instances on the inputs rounded
    to bf16 (the card's default), against their plain versions on the same
    inputs, as phases 2 and 3 hold the 1/8 levels."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    qkv, ids, hw = guided_inputs(torch, gen, grid)
    label = f"Guided {grid}x{grid} K={ids.shape[2]}"
    for bf16 in (False, True):
        q, k, v = (t.to(torch.bfloat16) for t in qkv) if bf16 else qkv
        sfx = "_bf16" if bf16 else ""
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        desc = (f"q/k/v {list(q.shape)} {str(q.dtype)[6:]} guide "
                f"{list(ids.shape)}")
        fwd = attention_flops(P * H, 4 * K, D)
        kernel_row(
            torch, rows, "quadtree_fine_attention" + sfx,
            label + (" with LSE" if train else ""), path,
            (lambda: qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2])
            if train else
            (lambda: qk_.quadtree_fine_attention(q, k, v, ids, hw, hw)),
            lambda: qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw,
                                                      with_lse=train),
            desc, nbytes(q, k, v, ids) + P * 4 * H * (D + train) * 4,
            0 if bf16 else fwd, bf16_flops=fwd if bf16 else 0,
            library=quadtree_library(torch, q, k, v, ids, hw, False),
            note=LSE_NOTE if train else "")
        if not train:
            continue
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        bwd = attention_flops(P * H, 4 * K, D, backward=True)
        kernel_row(
            torch, rows, "quadtree_fine_attention_bwd" + sfx, label, path,
            lambda: qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse,
                                                    g, hw, hw),
            lambda: qk_.quadtree_fine_attention_bwd_plain(
                q, k, v, ids, out, lse, g, hw, hw),
            desc, nbytes(q, k, v, ids, out, lse, g) + 3 * q.numel() * 4,
            0 if bf16 else bwd, bf16_flops=bwd if bf16 else 0,
            scattered=(1, 2),
            library=quadtree_library(torch, q, k, v, ids, hw, True))


def zoo_plain_paths(torch, gen):
    """The ZOO models' paths that run in plain PyTorch (no kernel, as in
    the JAX package), timed on the card at the 832^2 eval's shapes
    (forward, bf16 q/k/v as the card's default feeds them) and the 704^2
    step's (forward plus backward, bf16 q/k/v), each beside the kernels
    that the recipe's own path takes on the same grid, with the calls per
    request and per step: Z1's dilated cross attention (cascade_qtatt_b,
    dilation 2, 100 candidates; kernel C on 100 structured ones) and
    window scores (window_score, 324 candidates, f32; kernel B on 100),
    Z2's 1/8 attention B with the relative bias (qtatt_b, 3 levels from
    104^2 / 88^2, H=8, D=32, topks 32 / 16 / 8; without the bias, kernels
    A and A′).  Each forward's output checked finite."""
    from casmtr_tpu_torch.models.cascade_transformer import (upsample_idx,
                                                             window_warp_idx)
    from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
    from casmtr_tpu_torch.ops import cascade_matching as cm
    from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    from casmtr_tpu_torch.ops.propagation import get_propagations
    from casmtr_tpu_torch.ops.quadtree import cascade_qtatt_b, qtatt_b
    bf = torch.bfloat16
    out = {}

    def clock(name, fn, leaves, calls):
        """fn's forward (no gradient) in ms, with ``leaves`` also its forward
        plus backward, and the last one's total over ``calls``."""
        with torch.no_grad():
            check(bool(torch.isfinite(fn()).all()), f"{name}: non-finite")
            t = time_ms(torch, fn, reps=10)
        out[name] = t
        if leaves:
            y = fn()
            g = torch.randn(y.shape, device="cuda")
            t = time_ms(torch, lambda: torch.autograd.grad(fn(), leaves, g),
                        reps=10)
            out[name + " fwd+bwd"] = t
        out[name + f" x{calls}"] = calls * t

    for grid, train in ((208, False), (TRAIN_SIZE // 4, True)):
        g2, hw, w, H, D, C = grid // 2, (grid, grid), 5, 4, 32, 128
        tag = f"{grid}x{grid}" + (" (704^2 step)" if train else "")
        window, full = get_propagations("dilated1", w, 2)
        nxt = torch.randint(0, g2 * g2, (1, g2 * g2), generator=gen,
                            device="cuda")
        win, full_pos = window_warp_idx(nxt, window, g2, g2, full)
        corners = window_inputs(torch, gen, g2)
        q, k, v = (torch.randn((1, grid * grid, H, D), generator=gen,
                               device="cuda").to(bf).requires_grad_(train)
                   for _ in range(3))
        qkv = [q, k, v] if train else []
        clock(f"Z1 dilated cross attention {tag}", lambda: cascade_qtatt_b(
            q, k, v, win, hw, hw, dilated=2)[0], qkv, 4)
        clock(f"kernel C, structured windows {tag}",
              lambda: wk.window_cross_attention(q, k, v, corners, hw, hw, w),
              qkv, 4)
        f0, f1 = (torch.randn((1, grid * grid, C), generator=gen,
                              device="cuda").requires_grad_(train)
                  for _ in range(2))
        idx = upsample_idx(full_pos, g2, g2, g2)
        check(idx.shape[-1] == 4 * full.shape[0], "Z1 window candidates")
        # per request both directions; per step the 0->1 one with gradient
        clock(f"Z1 window scores {tag}", lambda: cm.window_score(f0, f1, idx),
              [f0, f1] if train else [], 1 if train else 2)
        qb = f0.detach().reshape(1, g2, 2, g2, 2, C).transpose(2, 3).reshape(
            1, g2 * g2, 4, C).contiguous().requires_grad_(train)
        f1_2d = f1.detach().reshape(1, grid, grid, C).contiguous()
        f1_2d.requires_grad_(train)
        clock(f"kernel B, structured windows {tag}",
              lambda: wk.window_patch_score(qb, f1_2d, corners, w),
              [qb, f1_2d] if train else [], 1 if train else 2)

        g8 = grid // 2
        lft = LocalFeatureTransformer(model_config(Z2).loftr.coarse,
                                      TRAIN_SIZE // 8).cuda()
        rel = lft.relative_biases((g8, g8))
        levels = []
        x = torch.randn((1, 256, g8, g8), generator=gen, device="cuda")
        for _ in range(3):
            levels.append((tuple(x.shape[-2:]), x.flatten(2).transpose(
                1, 2).reshape(1, -1, 8, 32).contiguous().to(bf)))
            x = avg_pool_2x2(x)
        sizes = [hw_ for hw_, _ in levels]
        toks = [t.requires_grad_(train) for _, t in levels]
        weight = torch.randn(3, generator=gen, device="cuda")
        for label, r in (("Z2 1/8 attention B, relative bias", rel),
                         ("kernels A and A′, no bias", None)):
            clock(f"{label} {g8}x{g8}" + (" (704^2 step)" if train else ""),
                  lambda r=r: qtatt_b(toks, toks, toks, sizes, (32, 16, 8),
                                      weight, r),
                  toks if train else [], 12)
    log("plain paths of the zoo (ms; 'xN' the total over the N calls of a "
        "request, or of a step for the 704^2 rows): "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def zoo_kernel_phase(torch):
    """Z3's Guided level through kernel A at the 832^2 eval's 1/4 shape
    (208^2) and through A with its log-sum-exp and A-bwd at the 704^2
    step's (176^2), then the zoo's plain paths (zoo_plain_paths).  Returns
    (serving rows, training rows)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, train_rows = [], []
    guided_rows(torch, rows, gen, f"eval 832^2 ({Z3})", 208, False)
    guided_rows(torch, train_rows, gen, f"train 704^2 ({Z3})",
                TRAIN_SIZE // 4, True)
    zoo_plain_paths(torch, gen)
    return rows, train_rows


def zoo_train_reference(torch, name):
    """One step of a ZOO model at 256^2 with float32 forced, card against
    CPU: each loss term within TRAIN_LOSS_RTOL relative, or where that is
    larger within NUDGE_FACTOR x its largest response on the CPU to two
    nudges of the images by NUDGE (a random model's discrete choices can
    flip under float32 rounding); the whole gradient's cosine >=
    MIN_GRAD_COS."""
    size = 256
    base, _, _ = build_trainer(torch, name, size, device="cpu")
    res = {dev: reference_step(torch, name, size, dev, base, "f32")
           for dev in ("cuda", "cpu")}
    rel, cos, (worst, worst_name), coarse = step_difference(
        torch, res["cuda"], res["cpu"])
    (sg, _, tg, _), (sc, _, tc, _) = res["cuda"], res["cpu"]
    log(f"training reference: {name} {size}^2, one step, card f32 vs CPU "
        f"f32: loss {sg['loss']:.6f} vs {sc['loss']:.6f}; relative "
        + ", ".join(f"{k} {r:.2e}" for k, r in rel.items())
        + f"; gradient cosine {cos:.8f} (min {MIN_GRAD_COS}), of loss_8c "
        f"on the 1/8 q/k/v {coarse:.8f}; worst per-leaf relative error "
        f"{worst:.2e} ({worst_name}, not gated); step {tg:.2f} s on the "
        f"card, {tc:.2f} s on the CPU")
    allow = {}
    if any(r > TRAIN_LOSS_RTOL for r in rel.values()):
        nudged = [step_difference(torch, reference_step(
            torch, name, size, "cpu", base, "f32", seed), res["cpu"])[0]
            for seed in (0, 1)]
        allow = {k: NUDGE_FACTOR * max(n[k] for n in nudged) for k in rel}
        log(f"training reference: {name} the CPU's largest response to two "
            f"nudges of {NUDGE:g} of its images: "
            + ", ".join(f"{k} {allow[k] / NUDGE_FACTOR:.2e}" for k in rel))
    for k, r in rel.items():
        check(r <= max(TRAIN_LOSS_RTOL, allow.get(k, 0.0)),
              f"training reference: {name} {k} disagrees")
    check(cos >= MIN_GRAD_COS, f"training reference: {name} gradients "
          "disagree")


def zoo_phase(torch, name):
    """A ZOO model at full width: serving at bucket 832 in the card's
    default (a warm request and two timed ones, each held to its per-pair
    launch count) and one more request profiled, the serving reference at
    bucket 256 (phase 6), training at 704^2 in the card's default (a
    warm-up step and two timed ones, each held to its per-step count, with
    zoo_watch's checks) and one more step profiled, and the f32 training
    reference at 256^2 (zoo_train_reference).  Returns (serving
    runs, (training launch totals, last step's counts))."""
    runs, matcher, request = timed(f"serving {name}", serving_phase, torch,
                                   name, ("bf16",))
    timed(f"profile {name} bf16", profile_phase, torch, name, matcher,
          request, "bf16")
    del matcher
    torch.cuda.empty_cache()
    timed(f"reference {name}", reference_phase, torch, name)
    with precision("bf16"):
        totals, counts, step, state, batch, times = timed(
            f"training {name} bf16", training_phase, torch, name, "bf16", 2)
        timed(f"training profile {name} bf16", train_profile_phase, torch,
              f"{name} bf16", step, state, batch, statistics.median(times))
    del step, state
    torch.cuda.empty_cache()
    timed(f"training reference {name}", zoo_train_reference, torch, name)
    return runs, (totals, counts)


# --------------------------------------------------------------------------
# phase 12: the test-time filters and the evaluation
# --------------------------------------------------------------------------

def to_device(torch, x, dev):
    """The tensors in ``x`` (nested tuples, lists, named tuples) on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(torch, v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(torch, v, dev) for v in x)
    return x


def capture_levels(torch, matcher, img0, img1):
    """Every cascade level's filter chain (ops.cascade_matching.
    cascade_match_mask_test) of one request through ``matcher``: its
    arguments by name, and the level's tokens (``tokens``, what
    models.casmtr.stage_d2d reads)."""
    import inspect
    from casmtr_tpu_torch.models import casmtr
    from casmtr_tpu_torch.ops import cascade_matching as cm
    chain, d2d = cm.cascade_match_mask_test, casmtr.stage_d2d
    sig = inspect.signature(chain)
    levels, tokens = [], []

    def record_chain(*a, **kw):
        bound = sig.bind(*a, **kw)
        bound.apply_defaults()
        levels.append(dict(bound.arguments, tokens=tokens[-1]))
        return chain(*a, **kw)

    def record_d2d(stage_cfg, t, hw):
        tokens.append(t)
        return d2d(stage_cfg, t, hw)

    cm.cascade_match_mask_test, casmtr.stage_d2d = record_chain, record_d2d
    try:
        matcher.match(img0, img1)
    finally:
        cm.cascade_match_mask_test, casmtr.stage_d2d = chain, d2d
    return levels


def level_masks(torch, level, dev):
    """A captured level's keep masks computed on ``dev`` from its tensors,
    every threshold at 0: the filter alone (ops.nms.post_process_mask) and
    the whole chain; d2d's saliency from the level's tokens on dev.
    Returns (filter mask, chain mask) on the CPU and the arguments on dev."""
    from casmtr_tpu_torch.ops import cascade_matching as cm
    from casmtr_tpu_torch.ops import nms
    kw = {k: to_device(torch, v, dev) for k, v in level.items()}
    tokens = kw.pop("tokens")
    kw["test_thr"] = 0.0
    kw["pre_thrs"] = [0.0] * len(kw["pre_thrs"])
    if kw["post_method"] == "d2d":
        kw["s_d2d"] = nms.d2d_saliency(
            tokens.float() / tokens.shape[-1] ** 0.5, kw["hw0"])
    filt = nms.post_process_mask(
        kw["post_method"], kw["ws"].next_conf_c01, kw["hw0"], 0.0,
        window=kw["post_window"], topk=kw["post_topk"], s_d2d=kw["s_d2d"],
        d2d_w=kw["d2d_w"], temperature=kw["post_temperature"],
        stride=kw["post_stride"], image0=kw["image0"],
        image0_mask=kw["image0_mask"])
    return filt.cpu(), cm.cascade_match_mask_test(**kw).cpu(), kw


def scatter_near(torch, flat, near, L):
    """[B, L] bool: True at the flat positions ``flat`` where ``near``."""
    out = torch.zeros((flat.shape[0], L + 1), dtype=torch.bool)
    idx = torch.where(near, flat, torch.full_like(flat, L)).reshape(
        flat.shape[0], -1)
    return out.scatter_(1, idx, True)[:, :L]


def softargmax_near(torch, conf, hw, window, temperature, stride):
    """The positions a soft-argmax window may vote for when its expected
    position (float64 here) lies within NEAR_TOL of a rounding boundary:
    its rounding of the expectation moved by -NEAR_TOL and +NEAR_TOL in
    each coordinate."""
    import torch.nn.functional as F
    B = conf.shape[0]
    h, w = hw
    c = conf.double().reshape(B, h, w)
    if stride == 1:
        pad = window // 2
        win = F.pad(c, (pad,) * 4).unfold(1, window, 1).unfold(2, window, 1)
        base_y = torch.arange(h, dtype=torch.float64)[:, None] - pad
        base_x = torch.arange(w, dtype=torch.float64)[None, :] - pad
    else:
        hT, wT = h // window, w // window
        win = c[:, :hT * window, :wT * window].reshape(
            B, hT, window, wT, window).transpose(2, 3)
        base_y = torch.arange(hT, dtype=torch.float64)[:, None] * window
        base_x = torch.arange(wT, dtype=torch.float64)[None, :] * window
    p = torch.softmax(win.reshape(*win.shape[:3], -1) / temperature, -1
                      ).reshape(win.shape)               # [B, y, x, ky, kx]
    off = torch.arange(window, dtype=torch.float64)
    ey = (p.sum(-1) * off).sum(-1) + base_y
    ex = (p.sum(-2) * off).sum(-1) + base_x
    near = ((torch.round(ey - NEAR_TOL) != torch.round(ey + NEAR_TOL))
            | (torch.round(ex - NEAR_TOL) != torch.round(ex + NEAR_TOL)))
    out = torch.zeros((B, h * w), dtype=torch.bool)
    for sy in (-NEAR_TOL, NEAR_TOL):
        for sx in (-NEAR_TOL, NEAR_TOL):
            ty = torch.round(ey + sy).clamp(0, h - 1).long()
            tx = torch.round(ex + sx).clamp(0, w - 1).long()
            out |= scatter_near(torch, ty * w + tx, near, h * w)
    return out


def d2d_near(torch, conf, hw, window, s_d2d, d2d_w):
    """The d2d placements whose saliency lies within NEAR_TOL of the last
    one kept or the first one dropped (the maxpool count's boundary)."""
    from casmtr_tpu_torch.ops import nms
    B, L = conf.shape
    num = nms.maxpool_nms_mask(conf, hw, window).sum(1)
    srt = s_d2d.sort(dim=1, descending=True).values
    n = srt.shape[1]
    c_in = srt.gather(1, (num - 1).clamp(0, n - 1)[:, None])
    c_out = srt.gather(1, num.clamp(max=n - 1)[:, None])
    near = (((s_d2d - c_in).abs() <= NEAR_TOL)
            | ((s_d2d - c_out).abs() <= NEAR_TOL))
    pos = torch.arange(n)
    flat = (pos // d2d_w * 4 * (d2d_w * 4) + pos % d2d_w * 4).expand(B, n)
    return scatter_near(torch, flat, near & (flat < L), L)


def sift_near(torch, image0, hw_c, stride, valid_mask, max_kpts=4096,
              resp_thr=1e-5):
    """The coarse cells of the detector's candidates (ops/sift.py on the
    CPU) whose response lies within NEAR_TOL x its magnitude of a
    boundary: its largest neighbour, the response threshold, or the
    global top-4096's last value."""
    from casmtr_tpu_torch.ops import sift
    gray = (0.299 * image0[..., 0] + 0.587 * image0[..., 1]
            + 0.114 * image0[..., 2])
    img = sift._upsample2(gray)
    vm = (sift._upsample2(valid_mask.float()) > 0.5 if valid_mask is not None
          else torch.ones_like(img, dtype=torch.bool))
    sigmas = [1.6 * 2.0 ** (i / 3) for i in range(5)]
    octaves, flat, scale = [], [], 0.5
    while min(img.shape[1], img.shape[2]) >= 64:
        mid, neigh = sift.octave_responses(img, sigmas)
        ok = torch.zeros(img.shape[1:], dtype=torch.bool)
        ok[1:-1, 1:-1] = True
        ok = ok & vm[:, None]
        flat.append(torch.where((mid > neigh) & (mid > resp_thr) & ok, mid,
                                torch.full_like(mid, float("-inf"))
                                ).reshape(mid.shape[0], -1))
        octaves.append((mid, neigh, ok, scale))
        img, vm, scale = img[:, ::2, ::2], vm[:, ::2, ::2], scale * 2
    allr = torch.cat(flat, 1)
    cut = allr.topk(min(max_kpts, allr.shape[1]), dim=1).values[:, -1]
    h0, w0 = hw_c
    out = torch.zeros((gray.shape[0], h0 * w0), dtype=torch.bool)
    for mid, neigh, ok, s_o in octaves:
        tol = NEAR_TOL * mid.abs()
        kept = (mid > neigh) & (mid > resp_thr)
        near = ok & ((((mid - neigh).abs() <= tol) & (mid > resp_thr - tol))
                     | (((mid - resp_thr).abs() <= tol) & (mid > neigh - tol))
                     | (kept & ((mid - cut[:, None, None, None]).abs()
                                <= tol)))
        Ho, Wo = mid.shape[2:]
        y = torch.arange(Ho, dtype=torch.float32)[:, None] * s_o
        x = torch.arange(Wo, dtype=torch.float32)[None, :] * s_o
        cell = torch.round((y / stride * w0 + x / stride).clamp(
            0, h0 * w0 - 1)).long().expand_as(mid)
        out |= scatter_near(torch, cell, near, h0 * w0)
    return out


def near_positions(torch, kw):
    """The positions of a captured level (its arguments ``kw`` on the CPU)
    where its filter's decision lies within NEAR_TOL of its boundary."""
    conf, hw = kw["ws"].next_conf_c01, kw["hw0"]
    method = kw["post_method"]
    if method == "softargmax_nms":
        return softargmax_near(torch, conf, hw, kw["post_window"],
                               kw["post_temperature"], kw["post_stride"])
    if method == "d2d":
        return d2d_near(torch, conf, hw, kw["post_window"], kw["s_d2d"],
                        kw["d2d_w"])
    if method == "sift":
        return sift_near(torch, kw["image0"], hw,
                         kw["image0"].shape[1] // hw[0], kw["image0_mask"])
    return torch.zeros_like(conf, dtype=torch.bool)


def filter_masks_check(torch, name, levels):
    """Each captured level's keep masks, card against CPU from the same
    tensors: bit-equal for the discrete filters (DISCRETE_FILTERS); for
    the others the differing positions counted, each within NEAR_TOL of
    its boundary (near_positions), at most MAX_FLIP_SHARE of the
    positions, and the whole chain differing nowhere else."""
    f = FILTERED[name]
    for i, level in enumerate(levels):
        with torch.inference_mode():   # the captured tensors are so
            filt_g, full_g, _ = level_masks(torch, level, "cuda")
            filt_c, full_c, kw = level_masks(torch, level, "cpu")
            near = near_positions(torch, kw)
        diff = filt_g != filt_c
        n_diff, total = int(diff.sum()), diff.numel()
        outside = int(((full_g != full_c) & ~diff).sum())
        unexplained = int((diff & ~near).sum())
        log(f"filters: {name} level {i} ({kw['hw0'][0]}^2): kept "
            f"{int(filt_c.sum())} of {total} by the filter, "
            f"{int(full_c.sum())} by the chain (thresholds 0) on the CPU; "
            f"card differs at {n_diff} ({n_diff / total:.2e}; max "
            f"{MAX_FLIP_SHARE:g}), {unexplained} of them not within "
            f"{NEAR_TOL:g} of a boundary ({int(near.sum())} positions "
            f"are); the chain elsewhere at {outside}")
        if f in DISCRETE_FILTERS:
            check(n_diff == 0 and outside == 0,
                  f"filters: {name} level {i}: masks not bit-equal")
        check(unexplained == 0 and outside == 0,
              f"filters: {name} level {i}: masks differ away from a "
              "boundary")
        check(n_diff <= MAX_FLIP_SHARE * total,
              f"filters: {name} level {i}: too many flips")
        if f == "F5":
            m = kw["image0_mask"]
            check(m is not None and not bool(m.all()),
                  f"filters: {name}: the canvas's valid mask did not reach "
                  "the detector")


def filter_reference(torch, name):
    """Phase 6's f32 serving reference of a filtered model at bucket 256,
    thresholds at 0."""
    img0, img1 = reference_pair()
    with precision("f32"):
        card = reference_forward(torch, name, "cuda", img0, img1)
        cpu = reference_forward(torch, name, "cpu", img0, img1)
    conf, window, st = compare_outputs(torch, card, cpu)
    log(f"filters: {name} reference, bucket 256, thresholds 0, card f32 vs "
        f"CPU f32: {describe(conf, window, st)}")
    check_f32_reference(conf, window, st)


def synthetic_level(torch, gen, g, C, hw8=(104, 104)):
    """A level's filter-chain inputs at g x g under the 1/8 grid hw8 (and a
    1/4 grid for g = 416): random confidences and second bests, targets,
    the coarse targets of rd, tokens of width C, an all-valid grid."""
    from casmtr_tpu_torch.ops import cascade_matching as cm
    L = g * g
    dev = "cuda"

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ids(n, *shape):
        return torch.randint(0, n, shape, generator=gen, device=dev)

    conf = rand(1, L)
    ws = cm.WindowSoftmaxResult(None, None, ids(L, 1, L), ids(L, 1, L), conf,
                                conf, None, conf * rand(1, L), ids(L, 1, L))
    pre_hws = [hw8] + ([(g // 2, g // 2)] if g > 208 else [])
    pre = [rand(1, h * w) for h, w in pre_hws]
    grid = torch.ones((1, g, g), dtype=torch.bool, device=dev)
    return dict(ws=ws, hw0=(g, g), hw1=(g, g), bd=1, pre_confs=pre,
                pre_hws=pre_hws, pre_thrs=[0.2] * len(pre),
                mask0_2d=grid, mask1_2d=grid,
                pre_confs_s=[p * rand(*p.shape) for p in pre],
                rd_coarse=(ids(hw8[0] * hw8[1], 1, hw8[0] * hw8[1]),
                           ids(hw8[0] * hw8[1], 1, hw8[0] * hw8[1]), hw8),
                tokens=torch.randn((1, L, C), generator=gen, device=dev))


def filter_times(torch):
    """Each filter's own time on the card: the level's whole filter chain
    (cascade_match_mask_test, thresholds 0.2, border 1, the double check;
    d2d with its saliency from C-wide tokens) at 208^2 (4c's 1/4 level at
    bucket 832, C 128) and 416^2 (2c's 1/2 level, C 64), sift on an 832^2
    image; beside the chain without a filter (method None) and with the
    recipes' maxpool_nms.  CUDA events, median of 25."""
    from casmtr_tpu_torch.ops import cascade_matching as cm
    from casmtr_tpu_torch.ops import nms
    gen = torch.Generator(device="cuda").manual_seed(12)
    image0 = (torch.from_numpy(texture(np.random.default_rng(2), 832, 832))
              .float().div(255).cuda()[None])
    mask0 = torch.ones((1, 832, 832), dtype=torch.bool, device="cuda")
    configs = dict(FILTERS, none={"method": None},
                   maxpool={"method": "maxpool_nms", "window_size": 5})
    out = {}
    for g, C in ((208, 128), (416, 64)):
        lv = synthetic_level(torch, gen, g, C)
        tokens = lv.pop("tokens")
        for f, pc in configs.items():
            method = pc["method"]

            def chain():
                s_d2d = d2d_w = None
                if method == "d2d":
                    s_d2d = nms.d2d_saliency(tokens / C ** 0.5, (g, g))
                    d2d_w = g // 4
                sift = method == "sift"
                return cm.cascade_match_mask_test(
                    test_thr=0.2, post_method=method,
                    post_window=pc.get("window_size"),
                    post_topk=pc.get("topk"), double_check=True,
                    s_d2d=s_d2d, d2d_w=d2d_w,
                    post_temperature=pc.get("temperature", 1.0),
                    post_stride=pc.get("stride", 1), rt=pc.get("rt"),
                    rd=pc.get("rd"), image0=image0 if sift else None,
                    image0_mask=mask0 if sift else None, **lv)
            chain()
            out[f, g] = time_ms(torch, chain)
        log(f"filters: own time at {g}^2 (cascade_match_mask_test, ms): "
            + ", ".join(f"{f} {out[f, g]:.4f}" for f in configs))
    return out


def filter_phase(torch):
    """Phase 12(a): each filtered model (FILTERED) at full width with phase
    4's seeded weights: three requests at bucket 832 in the card's default
    held to the recipe's per-pair launch counts (serve: steady latency,
    peak memory); one more request, the padded non-square one, captured
    and its levels' keep masks held card against CPU
    (filter_masks_check); phase 6's f32 reference at bucket 256
    (filter_reference); then each filter's own time (filter_times).
    Returns the serving runs by model."""
    reqs = requests(np.random.default_rng(0))
    runs = {}
    for name in FILTERED:
        t0 = time.perf_counter()
        matcher = matcher_for(name, bucket=BUCKET[name], seed=0)
        log(f"filters: Matcher('{name}') built in "
            f"{time.perf_counter() - t0:.1f} s, post_config "
            f"{FILTERS[FILTERED[name]]}")
        with precision("bf16"):
            runs[name] = {"bf16": serve(torch, matcher, name, reqs, "bf16")}
            levels = capture_levels(torch, matcher, *reqs[2][1:])
        del matcher
        torch.cuda.empty_cache()
        filter_masks_check(torch, name, levels)
        del levels
        filter_reference(torch, name)
    filter_times(torch)
    return runs


def rodrigues(axis, angle):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def pose_scenes(rng, B, M, outlier_share, noise_px, f=800.0, c=416.0):
    """B two-view scenes of M matches each: points 4-10 in front of camera
    0, a random rotation of 0.1-0.3 rad and unit translation, pixel noise,
    and a share of uniform outlier matches.  Returns (kpts0, kpts1, valid,
    K) float32 and the true (R, t) per pair."""
    n_out = int(round(M * outlier_share))
    n = M - n_out
    K = np.array([[f, 0, c], [0, f, c], [0, 0, 1.0]])
    k0s, k1s, truth = [], [], []
    for _ in range(B):
        R = rodrigues(rng.standard_normal(3), rng.uniform(0.1, 0.3))
        t = rng.standard_normal(3)
        t /= np.linalg.norm(t)
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(4, 10, n)], 1)
        X1 = X @ R.T + t
        k0 = ((X / X[:, 2:]) @ K.T)[:, :2] + rng.normal(0, noise_px, (n, 2))
        k1 = ((X1 / X1[:, 2:]) @ K.T)[:, :2] + rng.normal(0, noise_px,
                                                          (n, 2))
        k0s.append(np.concatenate([k0, rng.uniform(0, 2 * c, (n_out, 2))]))
        k1s.append(np.concatenate([k1, rng.uniform(0, 2 * c, (n_out, 2))]))
        truth.append((R, t))
    return (np.stack(k0s).astype(np.float32), np.stack(k1s).astype(np.float32),
            np.ones((B, M), bool), np.repeat(K[None], B, 0).astype(np.float32),
            truth)


def rot_angle_deg(Ra, Rb):
    """The angle of Ra^T Rb in degrees, from the chord (exact near 0)."""
    return np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(
        np.asarray(Ra, np.float64) - Rb) / (2 * 2 ** 0.5))))


def dir_angle_deg(a, b):
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    return np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(a - b) / 2)))


def pose_phase(torch):
    """Phase 12(b): sfm.pose.estimate_pose_batch on the card at POSE_B
    pairs of POSE_M matches with POSE_HYP hypotheses, on pose_scenes with
    POSE_OUTLIERS outliers: ms per batch (CUDA events, median of 5), and
    apart the hypotheses' batched 8-point SVDs and their stable top-8
    draw; every pair ok, the CPU on the same draw within
    POSE_CARD_CPU_DEG of the card; the supported poses (POSE_SUPPORT)
    within POSE_R_DEG / POSE_T_DEG of the truth."""
    from casmtr_tpu_torch.ops.quadtree import topk_lowest_first
    from casmtr_tpu_torch.sfm import pose
    k0, k1, v, K, truth = pose_scenes(np.random.default_rng(5), POSE_B,
                                      POSE_M, POSE_OUTLIERS, POSE_NOISE_PX)
    args = [torch.from_numpy(a) for a in (k0, k1, v, K, K)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = pose.pose_noise(POSE_B, POSE_HYP, POSE_M, gen, "cuda")
    card_args = [a.cuda() for a in args]

    def solve():
        return pose.estimate_pose_batch(*card_args, n_hyp=POSE_HYP,
                                        noise=noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    ms = time_ms(torch, solve, reps=5, warmup=1)
    A = torch.randn((POSE_B, POSE_HYP, 8, 9), generator=gen, device="cuda")
    svd_ms = time_ms(torch, lambda: torch.linalg.svd(A, full_matrices=True),
                     reps=5, warmup=1)
    scores = torch.rand((POSE_B, POSE_HYP, POSE_M), generator=gen,
                        device="cuda")
    topk_ms = time_ms(torch, lambda: topk_lowest_first(scores, 8, 2),
                      reps=5, warmup=1)
    t0 = time.perf_counter()
    cpu = pose.estimate_pose_batch(*args, n_hyp=POSE_HYP, noise=noise.cpu())
    cpu_s = time.perf_counter() - t0
    errs, card_cpu = [], []
    for b, (R, t) in enumerate(truth):
        Rg, tg = res.R[b].cpu().numpy(), res.t[b].cpu().numpy()
        errs.append((rot_angle_deg(Rg, R), dir_angle_deg(tg, t)))
        card_cpu.append(max(rot_angle_deg(Rg, cpu.R[b].numpy()),
                            dir_angle_deg(tg, cpu.t[b].numpy())))
    log(f"pose: estimate_pose_batch B {POSE_B}, M {POSE_M}, {POSE_HYP} "
        f"hypotheses, {POSE_OUTLIERS:.0%} outliers, {POSE_NOISE_PX} px: "
        f"{ms:.3f} ms per batch on the card (first call {first * 1e3:.1f} "
        f"ms; the hypotheses' [{POSE_B}, {POSE_HYP}, 8, 9] SVDs "
        f"{svd_ms:.3f} ms, their stable top-8 {topk_ms:.3f} ms); CPU "
        f"{cpu_s:.2f} s; inliers {res.n_inliers.tolist()}; R / t error "
        "from the truth (deg) "
        + ", ".join(f"{r:.3f} / {t:.3f}" for r, t in errs)
        + f"; card vs CPU max {max(card_cpu):.2e} deg (tol "
        f"{POSE_CARD_CPU_DEG}); ok card {res.ok.tolist()}, CPU "
        f"{cpu.ok.tolist()}")
    n_true = POSE_M - int(round(POSE_M * POSE_OUTLIERS))
    supported = [int(n) >= POSE_SUPPORT * n_true for n in res.n_inliers]
    log(f"pose: supported (inliers >= {POSE_SUPPORT:g} x {n_true} true "
        f"matches): {supported}")
    check(bool(res.ok.all()), "pose: a pair not ok")
    check(max(card_cpu) <= POSE_CARD_CPU_DEG, "pose: card and CPU disagree")
    check(2 * sum(supported) >= POSE_B, "pose: too few supported poses")
    check(all(r <= POSE_R_DEG and t <= POSE_T_DEG
              for (r, t), sup in zip(errs, supported) if sup),
          "pose: a supported pose off the truth")
    return ms


def plane_pair(rng, size, K, R, t, normal=(0.1, -0.05, 1.0), depth=4.0):
    """image0 of a textured plane (n . X = depth in camera 0) and image1 of
    it from the pose (R, t), float32 [size, size, 3] in [0, 1]: image1 at
    p shows the texture at H^-1 p, H = K (R + t n^T / depth) K^-1."""
    n = np.asarray(normal) / np.linalg.norm(normal)
    H = K @ (R + np.outer(t, n) / depth) @ np.linalg.inv(K)
    f = rng.uniform(0.03, 0.2, (3, 3, 2))
    ph = rng.uniform(0, 6, (3, 3))

    def tex(x, y):
        return np.stack([sum(np.sin(f[c, i, 0] * x + f[c, i, 1] * y
                                    + ph[c, i]) for i in range(3))
                         for c in range(3)], -1) / 6 + 0.5

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    p = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(H).T
    img1 = tex(p[..., 0] / p[..., 2], p[..., 1] / p[..., 2])
    return tex(xx, yy).astype(np.float32), img1.astype(np.float32)


def plane_dataset(rng, n_pairs, size):
    """n_pairs samples of run_eval's dataset (plane_pair at a focal length
    of 0.9 size, a rotation of 0.05-0.15 rad, a mostly sideways
    translation): image0/1, K0/1, T_0to1."""
    K = np.array([[0.9 * size, 0, size / 2], [0, 0.9 * size, size / 2],
                  [0, 0, 1]])
    out = []
    for _ in range(n_pairs):
        R = rodrigues(rng.standard_normal(3), rng.uniform(0.05, 0.15))
        t = rng.standard_normal(3) * [0.3, 0.3, 0.1]
        img0, img1 = plane_pair(rng, size, K, R, t)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, t
        out.append({"image0": img0, "image1": img1,
                    "K0": K.astype(np.float32), "K1": K.astype(np.float32),
                    "T_0to1": T})
    return out


def evaluate_phase(torch):
    """Phase 12(c): cli.evaluate.run_eval of outdoor_casmtr_4c (phase 4's
    seeded weights, the card's default) on EVAL_PAIRS pairs of a textured
    plane at EVAL_SIZE^2 (plane_pair: a known K, R, t) through the port's
    DataLoader, after a one-pair warm-up; the launch counts zeroed just
    before and held to EVAL_PAIRS x 4c's per-pair counts after; the AUC
    and precision finite; pairs/s.  Returns its serving run and its
    pairs/s."""
    from casmtr_tpu_torch.cli.evaluate import run_eval
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.weights import init_random_
    t0 = time.perf_counter()
    s = EVAL_SIZE
    data = plane_dataset(np.random.default_rng(6), EVAL_PAIRS, s)
    cfg = build_config("outdoor_casmtr_4c")
    model = build_model(cfg.loftr)
    init_random_(model, torch.Generator().manual_seed(0))
    log(f"evaluate: {EVAL_PAIRS} pairs of {s}^2 made and the model built in "
        f"{time.perf_counter() - t0:.1f} s")
    with precision("bf16"):
        run_eval(cfg, model, data[:1])
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_eval(cfg, model, data, profiler_name="inference")
        wall = time.perf_counter() - t0
    totals = dict(kernels.LAUNCHES)
    per_pair = LAUNCHES_PER_PAIR[EVAL_NAME]
    log(f"evaluate: run_eval {EVAL_PAIRS} pairs in {wall:.2f} s, "
        f"{EVAL_PAIRS / wall:.2f} pairs/s; "
        + ", ".join(f"{k} {float(v):.4f}" for k, v in res.items())
        + f" (random weights: printed, not gated); launches {totals}")
    check(set(res) == {"auc@5", "auc@10", "auc@20", "prec@5e-04"},
          "evaluate: result keys")
    check(all(np.isfinite(float(v)) for v in res.values()),
          "evaluate: a non-finite result")
    check(totals == {k: v * EVAL_PAIRS for k, v in per_pair.items()},
          f"evaluate: launches {totals}, expected {EVAL_PAIRS} x {per_pair}")
    return {"bf16": (totals, per_pair, [])}, EVAL_PAIRS / wall


# --------------------------------------------------------------------------
# phase 13: files
# --------------------------------------------------------------------------

def raised(fn, *args):
    """The exception ``fn(*args)`` raises, or None."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the caller checks what it is
        return e
    return None


def digest(arr):
    """The manifest's entry of an array (native byte order)."""
    import hashlib
    arr = np.ascontiguousarray(arr)
    arr = arr.astype(arr.dtype.newbyteorder("="))
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def contiguous_h5(template, name, arr, path):
    """Write ``arr`` to ``path`` as the file h5py writes by default
    (version-0 superblock, one contiguous dataset ``name``), grown from
    ``template``: such a file of the same name, dtype and rank whose data
    ends it.  Its dims and max dims, its layout's size and its end-of-file
    address are rewritten and its data replaced (the card's machine has no
    h5py, and a full-size depth file is too large to commit)."""
    import struct
    from casmtr_tpu_torch.data import codecs
    raw = open(template, "rb").read()
    old = codecs.read_h5_dataset(template, name)
    addr = len(raw) - old.nbytes
    dims = [struct.pack(f"<{old.ndim}Q", *a.shape) for a in (old, arr)]
    layout = [struct.pack("<2Q", addr, a.nbytes) for a in (old, arr)]
    eof = struct.pack("<Q", len(raw))
    check(old.dtype == arr.dtype and old.ndim == arr.ndim
          and raw[:8] == b"\x89HDF\r\n\x1a\n" and raw[8] == 0
          and raw[40:48] == eof and raw.count(dims[0]) == 2
          and raw.count(layout[0]) == 1, f"{template}: not a version-0 "
          "file of one contiguous dataset that ends it")
    head = raw[:addr].replace(dims[0], dims[1]).replace(layout[0], layout[1])
    head = head[:40] + struct.pack("<Q", addr + arr.nbytes) + head[48:]
    with open(path, "wb") as f:
        f.write(head + np.ascontiguousarray(arr).tobytes())


def contiguous_scene(tmp):
    """The fixtures' MegaDepth-layout scene under ``tmp`` with its depth
    files as h5py writes them by default (contiguous, the layout of the
    real MegaDepth depth files; the committed ones are chunked and
    deflated to keep them small): the images linked, each depth file
    rewritten.  Returns the data root (the scene's index stays the
    fixtures')."""
    from casmtr_tpu_torch.data import codecs
    src = os.path.join(FIXTURES, "megadepth")
    root = os.path.join(tmp, "megadepth_contiguous")
    os.makedirs(root)
    os.symlink(os.path.join(src, "Undistorted_SfM"),
               os.path.join(root, "Undistorted_SfM"))
    info = np.load(os.path.join(src, "index", "scene_info", "0000.npz"),
                   allow_pickle=True)
    for rel in info["depth_paths"]:
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        contiguous_h5(os.path.join(FIXTURES, "decode", "h5_contiguous.h5"),
                      "depth", codecs.read_h5_dataset(
                          os.path.join(src, rel), "depth"),
                      os.path.join(root, rel))
    return root


def median_ms(fn, *args, reps=IO_REPS):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def decode_phase(torch, tmp):
    """Phase 13(a): the host library built from csrc/host/ with c++ (its
    seconds printed); every entry of the fixtures' manifest decoded and
    held bit-equal to cv2.imread's or h5py's result (its sha256), the
    progressive JPEG refused with an error naming the file and SOF2; the
    median ms per image of the MegaDepth-size JPEG (colour and gray), the
    640x480 16-bit depth PNG, one depth h5 as the fixtures hold it
    (chunked) and as h5py writes it by default (contiguous, written under
    ``tmp``), the padding resize to 832 and the uint8 resize of a 1296x968
    frame to 640x480."""
    from casmtr_tpu_torch.data import codecs, host
    from casmtr_tpu_torch.data import io as dio
    t0 = time.perf_counter()
    host.lib(fresh=True)
    log(f"decode: host library {host.CXX_FLAGS} built in "
        f"{host.build_seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)"
        f" into {host.library_path().parent.name}")
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    modes = {"color": codecs.IMREAD_COLOR, "gray": codecs.IMREAD_GRAYSCALE,
             "unchanged": codecs.IMREAD_UNCHANGED}
    n = 0
    for rel, want in sorted(manifest.items()):
        path = os.path.join(FIXTURES, rel)
        if "refused" in want:
            e = raised(codecs.imread, path)
            check(isinstance(e, ValueError) and want["refused"] in str(e)
                  and path in str(e), f"decode: {rel} not refused ({e!r})")
            log(f"decode: {rel} refused: {e}")
            continue
        for mode, entry in want.items():
            arr = (codecs.read_h5_dataset(path, mode) if rel.endswith(".h5")
                   else codecs.imread(path, modes[mode]))
            check(digest(arr) == entry, f"decode: {rel} {mode}: "
                  f"{digest(arr)} != {entry}")
            n += 1
    log(f"decode: {n} reads of {len(manifest) - 1} files bit-equal to the "
        "manifest (cv2.imread / h5py)")
    md = os.path.join(FIXTURES, "megadepth")
    sn = os.path.join(FIXTURES, "scannet", "scans", "scene0000_00")
    jpg = os.path.join(md, "Undistorted_SfM/0000/images/0000.jpg")
    h5 = os.path.join(md, "phoenix/S6/zl548/MegaDepth_v1/0000/dense0/"
                          "depths/0000.h5")
    png = os.path.join(sn, "depth", "0.png")
    frame = codecs.imread(os.path.join(sn, "color", "0.jpg"))
    img = codecs.imread(jpg)
    # the same depth as h5py writes it by default, the layout of the real
    # MegaDepth depth files (the fixtures' are chunked and deflated to keep
    # them small)
    depth = codecs.read_h5_dataset(h5, "depth")
    flat = os.path.join(tmp, "depth_contiguous.h5")
    contiguous_h5(os.path.join(FIXTURES, "decode", "h5_contiguous.h5"),
                  "depth", depth, flat)
    check(np.array_equal(codecs.read_h5_dataset(flat, "depth"), depth),
          "decode: the contiguous depth file reads back differently")
    times = {
        "jpeg 1200x800 color": median_ms(codecs.imread, jpg),
        "jpeg 1200x800 gray": median_ms(codecs.imread, jpg,
                                        codecs.IMREAD_GRAYSCALE),
        "png 640x480 uint16": median_ms(codecs.imread, png,
                                        codecs.IMREAD_UNCHANGED),
        "h5 depth 1200x800 chunked": median_ms(codecs.read_h5_dataset, h5,
                                               "depth"),
        "h5 depth 1200x800 contiguous": median_ms(codecs.read_h5_dataset,
                                                  flat, "depth"),
        "resize_pad_normalize 1200x800 -> 832": median_ms(
            dio.resize_pad_normalize, img, 512, 832, 832),
        "resize_u8 1296x968 -> 640x480": median_ms(dio.resize_u8, frame,
                                                   (640, 480)),
    }
    log("decode: median ms per image (one host thread): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    return times


class Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def captured(fn, *args):
    """(fn(*args), what it printed), the printing passed through."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(*args)
    return out, tee.text()


def fixture_overrides(split, dataset):
    """The data recipe's ``split`` ("test", "train", "val") pointed at the
    fixtures' MegaDepth- or ScanNet-layout scene."""
    if dataset == "MegaDepth":
        root = os.path.join(FIXTURES, "megadepth")
        index = os.path.join(root, "index")
        out = {f"{split}_npz_root": os.path.join(index, "scene_info")}
    else:
        root = os.path.join(FIXTURES, "scannet", "scans")
        index = os.path.join(FIXTURES, "scannet", "index")
        out = {f"{split}_npz_root": index, f"{split}_intrinsic_path":
               os.path.join(index, "intrinsics.npz")}
    return dict(out, **{f"{split}_data_root": root, f"{split}_list_path":
                        os.path.join(index, "list.txt")})


def io_evaluate_phase(torch, tmp, earlier):
    """Phase 13(b): python -m casmtr_tpu_torch.cli.evaluate (its main) of
    outdoor_casmtr_4c with megadepth_test_1500 pointed at the fixtures'
    MegaDepth-layout scene, listed IO_EVAL_REPEATS times (a list file
    under ``tmp``: IO_PAIRS pairs), in the card's default (bf16), after a
    one-pair warm-up: the printed JSON; pairs/s over the wall (the model
    build included) and in the steady state, beside phase 12's run_eval on
    arrays when ``earlier`` holds it; the loader's share of the steady
    state (the "Data loading" region, the wait for the next batch, over
    the three regions of the pairs after the loader's workers and prefetch
    have run out); the launches held to IO_PAIRS x 4c's per pair."""
    from casmtr_tpu_torch.cli import evaluate
    from casmtr_tpu_torch.data.loader import DataLoader
    from casmtr_tpu_torch.ops import kernels
    listing = os.path.join(tmp, "test_list.txt")
    with open(listing, "w") as f:
        f.write("0000\n" * IO_EVAL_REPEATS)
    ov = {"dataset": dict(fixture_overrides("test", "MegaDepth"),
                          test_list_path=listing)}
    argv = ["--model", "outdoor_casmtr_4c", "--data", "megadepth_test_1500",
            "--overrides-json", json.dumps(ov)]
    profilers = []
    build = evaluate.build_profiler

    def keeping(name):
        profilers.append(build(name))
        return profilers[-1]

    evaluate.build_profiler = keeping
    try:
        with precision("bf16"):
            evaluate.main(argv + ["--max-pairs", "1"])
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = evaluate.main(argv + ["--profiler", "inference"])
            wall = time.perf_counter() - t0
    finally:
        evaluate.build_profiler = build
    totals = dict(kernels.LAUNCHES)
    per_pair = LAUNCHES_PER_PAIR[IO_EVAL]
    # run_eval's loader: 4 workers and the default prefetch
    head = 4 + DataLoader(None).prefetch
    times = profilers[-1].times
    steady = {k: times[k][head:IO_PAIRS]
              for k in ("Data loading", "Model Matching", "RANSAC")}
    n = len(steady["Model Matching"])
    total = sum(sum(v) for v in steady.values())
    share = sum(steady["Data loading"]) / total
    beside = (f" (phase 12's run_eval on arrays: "
              f"{earlier['run_eval pairs/s']:.2f} pairs/s)"
              if "run_eval pairs/s" in earlier else "")
    log(f"evaluate main: {IO_PAIRS} pairs from files in {wall:.2f} s, "
        f"{IO_PAIRS / wall:.2f} pairs/s with the model build{beside}; "
        f"pairs {head + 1}-{IO_PAIRS} ({n}): {n / total:.2f} pairs/s, "
        "seconds per pair "
        + ", ".join(f"{k} {statistics.median(v):.4f}"
                    for k, v in steady.items())
        + f" (medians), loader share {share:.4f} of their time "
        f"(the wait for a batch at most "
        f"{max(steady['Data loading']):.4f} s); launches {totals}")
    check(set(res) == {"auc@5", "auc@10", "auc@20", "prec@1e-04"},
          f"evaluate main: result keys {sorted(res)}")
    check(all(np.isfinite(float(v)) for v in res.values()),
          "evaluate main: a non-finite result")
    check(n == IO_PAIRS - head and len(times["Data loading"]) == IO_PAIRS + 1,
          f"evaluate main: {len(times['Model Matching'])} pairs timed, "
          f"expected {IO_PAIRS}")
    check(totals == {k: v * IO_PAIRS for k, v in per_pair.items()},
          f"evaluate main: launches {totals}, expected {IO_PAIRS} x "
          f"{per_pair}")
    return {"bf16": (totals, per_pair, [])}


def window_times(text):
    """The (data_s, step_s) of each log line of the training command (its
    first window, compile_s, as step_s)."""
    import re
    out = []
    for m in re.finditer(r"data_s=([0-9.]+) (?:compile_s|step_s)=([0-9.]+)",
                         text):
        out.append((float(m.group(1)), float(m.group(2))))
    return out


def io_train_run(torch, name, argv, steps, val_pairs):
    """One run of the training command (its main) in the card's default:
    the launch counts zeroed before and held to steps x the recipe's per
    step plus val_pairs x its per pair after; every step's losses finite
    and its ground-truth coarse matches (conf_matrix_gt_8c) above 0.
    Returns (main's result, its output, the launches, the per-step
    scalars, the gt counts, peak GiB)."""
    from casmtr_tpu_torch.cli import train
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.train import supervision as spv
    gts, scalars = [], []
    compute, make = spv.compute_supervision, train.make_train_step

    def counting(batch, lcfg):
        gt = compute(batch, lcfg)
        gts.append(int(gt["conf_matrix_gt_8c"].sum()))
        return gt

    def recording(*a, **kw):
        step = make(*a, **kw)

        def fn(state, batch):
            state, s = step(state, batch)
            scalars.append({k: float(v) for k, v in s.items()})
            return state, s
        return fn

    spv.compute_supervision, train.make_train_step = counting, recording
    torch.cuda.reset_peak_memory_stats()
    with precision("bf16"):
        kernels.reset_launch_counts()
        try:
            out, text = captured(train.main, argv)
        finally:
            spv.compute_supervision, train.make_train_step = compute, make
    totals = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: steps * v + val_pairs * LAUNCHES_PER_PAIR[name][k]
            for k, v in LAUNCHES_PER_TRAIN_STEP[name].items()}
    check(len(scalars) == steps and len(gts) == steps,
          f"{name}: {len(scalars)} steps, expected {steps}")
    check(all(np.isfinite(v) for s in scalars for v in s.values()),
          f"{name}: a non-finite loss or gradient norm {scalars}")
    check(all(g > 0 for g in gts), f"{name}: a step without ground-truth "
          f"coarse matches {gts}")
    check(totals == want, f"{name}: launches {totals}, expected {want} "
          f"({steps} steps, {val_pairs} validation pairs)")
    log(f"{name}: {steps} steps, losses "
        f"{[round(s['loss'], 4) for s in scalars]}, gt coarse matches "
        f"{gts}, peak {peak:.2f} GiB; launches {totals}")
    return out, text, totals, scalars, peak


def loader_rate(cfg, workers):
    """Samples per second of the training split's loader of ``cfg`` alone
    (no model), at ``workers`` threads, from its start to its last batch."""
    from casmtr_tpu_torch.data.module import MultiSceneDataModule
    loader = MultiSceneDataModule(cfg).train_loader(1, num_workers=workers)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return n / (time.perf_counter() - t0)


def io_train_phase(torch, tmp, earlier):
    """Phase 13(c): python -m casmtr_tpu_torch.cli.train (its main) of
    outdoor_casmtr_4c with megadepth_trainval_704 on the fixtures'
    MegaDepth-layout scene with its depth files rewritten contiguous, as
    h5py writes them by default (contiguous_scene): one epoch of IO_STEPS
    steps (samples drawn with replacement from its pairs) with IO_WORKERS
    loader threads, a sanity validation of IO_SANITY pairs and a
    validation of IO_VAL; the checkpoints and config.json written; step_s
    and data_s (medians over the steps after the loader's workers and
    prefetch have run out) and peak memory, beside phase 7's bf16 step
    when ``earlier`` holds it; the loader alone in samples/s at 1 and
    IO_WORKERS threads, on those depth files and on the committed chunked
    ones, against steps/s.  Then --resume from its checkpoint directory for
    an epoch of IO_RESUME_STEPS on the committed files (the step count
    continues), and IO_INDOOR_STEPS steps of indoor_casmtr_4c_runnable
    with scannet_trainval on the ScanNet-layout scene (640x480 frames), no
    validation.  Runs go under ``tmp``."""
    from casmtr_tpu_torch.config import override
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.data.loader import DataLoader
    runs = {}
    data = {"train": fixture_overrides("train", "MegaDepth"),
            "val": fixture_overrides("val", "MegaDepth")}
    flat = contiguous_scene(tmp)

    def overrides(samples, contiguous):
        ov = {"dataset": dict(**data["train"], **data["val"]),
              "trainer": {"n_samples_per_subset": samples}}
        if contiguous:
            ov["dataset"].update(train_data_root=flat, val_data_root=flat)
        return ov

    run1, run2 = os.path.join(tmp, "run1"), os.path.join(tmp, "run2")
    common = ["--model", "outdoor_casmtr_4c", "--data",
              "megadepth_trainval_704", "--epochs", "1",
              "--num-workers", str(IO_WORKERS), "--log-every", "1",
              "--max-val-pairs", str(IO_VAL)]
    out, text, totals, _, peak = io_train_run(
        torch, IO_TRAIN, common + [
            "--run-dir", run1, "--sanity-val-steps", str(IO_SANITY),
            "--overrides-json", json.dumps(overrides(IO_STEPS, True))],
        IO_STEPS, IO_SANITY + IO_VAL)
    runs[IO_TRAIN, "bf16"] = (totals, LAUNCHES_PER_TRAIN_STEP[IO_TRAIN])
    for f in ("config.json", f"ckpts/{IO_STEPS}.pt",
              f"ckpts_last/{IO_STEPS}.pt", "ckpts/metrics.json"):
        check(os.path.exists(os.path.join(run1, f)), f"train: no {f}")
    check(out["step"] == IO_STEPS and "auc@10" in out["val"],
          f"train: {out}")
    head = IO_WORKERS + DataLoader(None).prefetch
    times = window_times(text)[head:]
    check(len(times) == IO_STEPS - head, f"train: {len(times)} steady "
          f"steps logged, expected {IO_STEPS - head}")
    data_s = statistics.median(t[0] for t in times)
    step_s = statistics.median(t[1] for t in times)
    beside = (f" (phase 7's 4c bf16 step, no loader: "
              f"{earlier['4c bf16 step_s']:.4f} s)"
              if "4c bf16 step_s" in earlier else "")
    log(f"train main 704^2, steps {head + 1}-{IO_STEPS} ({len(times)}): "
        f"step_s {step_s:.4f} s{beside}, data_s {data_s:.4f} s (at most "
        f"{max(t[0] for t in times):.4f}; {data_s / (data_s + step_s):.4f} "
        f"of the wall) with {IO_WORKERS} loader threads, peak {peak:.2f} GiB")
    base = build_config("outdoor_casmtr_4c", "megadepth_trainval_704")
    rates = {}
    for layout, contiguous in (("contiguous", True), ("chunked", False)):
        cfg = override(base, overrides(IO_LOADER_SAMPLES, contiguous))
        rates[layout] = {w: loader_rate(cfg, w) for w in (1, IO_WORKERS)}
        log(f"train loader alone, {IO_LOADER_SAMPLES} samples, depth h5 "
            f"{layout}: " + ", ".join(
                f"{w} threads {r:.2f} samples/s"
                for w, r in rates[layout].items())
            + f"; the training command's steps take {1 / step_s:.2f} "
            "samples/s")
    out, _, totals, _, _ = io_train_run(
        torch, IO_RESUME, common + [
            "--run-dir", run2, "--resume", os.path.join(run1, "ckpts"),
            "--sanity-val-steps", "0",
            "--overrides-json",
            json.dumps(overrides(IO_RESUME_STEPS, False))],
        IO_RESUME_STEPS, IO_VAL)
    runs[IO_RESUME, "bf16"] = (totals, LAUNCHES_PER_TRAIN_STEP[IO_RESUME])
    end = IO_STEPS + IO_RESUME_STEPS
    check(out["step"] == end, f"train --resume: step {out['step']}, "
          f"expected {end}")
    check(os.path.exists(os.path.join(run2, f"ckpts/{end}.pt")),
          "train --resume: no checkpoint")
    ov = {"dataset": dict(**fixture_overrides("train", "ScanNet"),
                          **fixture_overrides("val", "ScanNet")),
          "trainer": {"n_samples_per_subset": IO_INDOOR_STEPS}}
    out, _, totals, _, _ = io_train_run(
        torch, IO_INDOOR, ["--model", INDOOR, "--data",
                           "scannet_trainval", "--epochs", "1",
                           "--num-workers", str(IO_WORKERS),
                           "--log-every", "1", "--sanity-val-steps", "0",
                           "--val-every-epochs", "2",
                           "--run-dir", os.path.join(tmp, "run3"),
                           "--overrides-json", json.dumps(ov)],
        IO_INDOOR_STEPS, 0)
    runs[IO_INDOOR, "bf16"] = (totals, LAUNCHES_PER_TRAIN_STEP[IO_INDOOR])
    return runs, {"step_s": step_s, "data_s": data_s, "peak_gib": peak,
                  "loader samples/s": rates}


def io_matcher_phase(torch):
    """Phase 13(d): Matcher.match on two paths of the MegaDepth-layout
    scene against Matcher.match on the arrays data/io._imread returns for
    them (4c, bucket 832, thresholds at 0 so that every stage matches, the
    card's default): bit-identical outputs."""
    from casmtr_tpu_torch.data.io import _imread
    p0, p1 = (os.path.join(FIXTURES, "megadepth", "Undistorted_SfM", "0000",
                           "images", f"000{i}.jpg") for i in (0, 1))
    with precision("bf16"):
        m = matcher_for("outdoor_casmtr_4c", thr=0.0, overrides=
                        zero_threshold_overrides("outdoor_casmtr_4c"))
        a = m.match(p0, p1)
        b = m.match(_imread(p0, gray=False), _imread(p1, gray=False))
    same = all(np.array_equal(x, y) for x, y in zip(a, b))
    log(f"matcher: paths against arrays, {len(a.mconf)} matches, "
        f"bit-identical: {same}")
    check(same and len(a.mconf) > 0, "matcher: paths differ from arrays")


def files_phase(torch, earlier=None):
    """Phase 13: decoding, the evaluate and train commands, the Matcher's
    paths.  ``earlier`` holds this run's readings of phases 7 and 12
    ("4c bf16 step_s", "run_eval pairs/s") to print beside phase 13's;
    without them (phase 13 run alone) nothing is printed beside."""
    import tempfile
    earlier = earlier or {}
    with tempfile.TemporaryDirectory() as tmp:
        times = timed("files: decode", decode_phase, torch, tmp)
        serve = timed("files: evaluate", io_evaluate_phase, torch, tmp,
                      earlier)
        torch.cuda.empty_cache()
        train_runs, train_times = timed("files: train", io_train_phase,
                                        torch, tmp, earlier)
    torch.cuda.empty_cache()
    timed("files: matcher", io_matcher_phase, torch)
    return times, serve, train_runs, train_times


# --------------------------------------------------------------------------
# phase 14: SfM
# --------------------------------------------------------------------------

def rvec_matrix(rv):
    """Axis-angle [3] -> rotation [3, 3] in float64."""
    rv = np.asarray(rv, np.float64)
    theta = float(np.linalg.norm(rv))
    return np.eye(3) if theta < 1e-12 else rodrigues(rv, theta)


def project_np(rv, tv, X, K):
    """Pixels [N, 2] of world points X [N, 3] in the camera (rv, tv)."""
    uv = (X @ rvec_matrix(rv).T + tv) @ K.T
    return uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)


def sfm_problem(torch, rng, noise=0.5, perturb=0.02, C=4, P=60):
    """tests/test_sfm.make_problem (its synth_scene, projected in float64
    here) as the port's BAProblem on the CPU."""
    from casmtr_tpu_torch.sfm.ba import BAProblem
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                    rng.uniform(5, 9, P)], -1)
    rvecs = np.stack([[0.0, 0.04 * c, 0.0] for c in range(C)])
    tvecs = np.stack([[-0.4 * c, 0.02 * c, 0.0] for c in range(C)])
    obs = []
    for rv, tv in zip(rvecs, tvecs):
        uv = project_np(rv, tv, pts, K)
        obs.append(uv + rng.normal(0, noise, uv.shape) if noise else uv)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return BAProblem(
        f32(rvecs + rng.normal(0, perturb, rvecs.shape)),
        f32(tvecs + rng.normal(0, perturb, tvecs.shape)),
        f32(pts + rng.normal(0, perturb * 5, pts.shape)), f32(K),
        torch.from_numpy(np.repeat(np.arange(C), P)),
        torch.from_numpy(np.tile(np.arange(P), C)), f32(np.concatenate(obs)),
        torch.ones(C * P, dtype=torch.bool))


def sequence_views(rng, pts, rvecs, tvecs, K, noise):
    """The synthetic matcher of a camera path over a point cloud: every
    point seen (5 px inside a 640x480 frame) by both frames is a match.
    Returns (match_fn, K, true camera centres)."""
    uvs, vis = [], []
    for rv, tv in zip(rvecs, tvecs):
        uv = project_np(rv, tv, pts, K)
        if noise:
            uv = uv + rng.normal(0, noise, uv.shape)
        uvs.append(uv)
        vis.append((uv[:, 0] > 5) & (uv[:, 0] < 635) & (uv[:, 1] > 5)
                   & (uv[:, 1] < 475))

    def match_fn(i, j):
        m = vis[i] & vis[j]
        return uvs[i][m], uvs[j][m], np.ones(int(m.sum()))

    centers = np.stack([-rvec_matrix(rv).T @ tv
                        for rv, tv in zip(rvecs, tvecs)])
    return match_fn, K, centers


def sfm_sequence(rng, n_frames=5, P=120, noise=0.0, baseline=0.35):
    """tests/test_sfm_pipeline.synth_sequence: a textured wall, a
    translating and slowly turning camera."""
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P),
                    rng.uniform(6, 10, P)], -1)
    rvecs = np.stack([[0.0, 0.035 * c, 0.0] for c in range(n_frames)])
    tvecs = np.stack([[-baseline * c, 0.01 * c, 0.0]
                      for c in range(n_frames)])
    return sequence_views(rng, pts, rvecs, tvecs, K, noise)


def scale_sequence(rng, n_frames, P=400, noise=0.3, baseline=0.35,
                   fx=400.0, full_span=False, pan_rate=0.002, y_half=3.0,
                   y_rate=0.01):
    """scripts/sfm_scale_bench.synth_sequence: the wall spread over the
    camera's travel."""
    K = np.array([[fx, 0, 320], [0, fx, 240], [0, 0, 1]])
    span = baseline * n_frames * (1.0 if full_span else 0.6) + 8
    pts = np.stack([rng.uniform(-span, 4, P), rng.uniform(-y_half, y_half, P),
                    rng.uniform(6, 10, P)], -1)
    rvecs = np.stack([[0.0, pan_rate * c, 0.0] for c in range(n_frames)])
    tvecs = np.stack([[baseline * c, y_rate * c, 0.0]
                      for c in range(n_frames)])
    return sequence_views(rng, pts, rvecs, tvecs, K, noise)


def big_problem(torch, rng, C, P, track_len=5):
    """scripts/sfm_scale_bench.make_big_problem: cameras along x with a
    slow pan, each point anchored near the frustums of its track_len
    consecutive cameras, 0.5 px noise, a perturbed init.  Returns ((rv,
    tv) true, the port's BAProblem on the CPU)."""
    from casmtr_tpu_torch.sfm.ba import BAProblem
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    rv = np.stack([[0.0, 0.25 * c / max(C - 1, 1), 0.0] for c in range(C)])
    tv = np.stack([[0.1 * c, 0.0, 0.0] for c in range(C)])
    u = rng.uniform(0, C - track_len, P)
    first = np.floor(u).astype(np.int64)
    x_anchor = -0.1 * (u + track_len / 2)
    pts = np.stack([x_anchor + rng.uniform(-1.5, 1.5, P),
                    rng.uniform(-4, 4, P), rng.uniform(8, 14, P)], -1)
    obs_cam = (first[:, None] + np.arange(track_len)[None]).reshape(-1)
    obs_pt = np.repeat(np.arange(P), track_len)
    R = np.stack([rvec_matrix(r) for r in rv])
    uv = (np.einsum("nij,nj->ni", R[obs_cam], pts[obs_pt])
          + tv[obs_cam]) @ K.T
    uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    rv_n = rv + rng.normal(0, 0.005, rv.shape)
    tv_n = tv + rng.normal(0, 0.1, tv.shape)
    pts_n = pts + rng.normal(0, 0.1, pts.shape)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return (rv, tv), BAProblem(
        f32(rv_n), f32(tv_n), f32(pts_n), f32(K), torch.from_numpy(obs_cam),
        torch.from_numpy(obs_pt), f32(uv),
        torch.ones(len(obs_cam), dtype=torch.bool))


def gauge_free(torch, q):
    """(rotations, translations over their norm) of a BA problem, numpy:
    the monocular scale is a near-null direction of bundle adjustment."""
    t = q.cam_tvec.cpu().numpy()
    return q.cam_rvec.cpu().numpy(), t / np.linalg.norm(t)


def sfm_card_cpu_phase(torch, dev="cuda"):
    """Phase 14(a): the port on ``dev`` against the CPU.  BA (dense and
    CG, tests/test_sfm.make_problem, C 4, P 60, 10 iterations): final cost
    within SFM_COST_RTOL relative, rotations and gauge-free translations
    within SFM_POSE_ATOL.  The pipeline (tests/test_sfm_pipeline.
    synth_sequence, 5 frames at 0.3 px, overlaps (1, 2), PGO, 15 BA
    iterations) on one draw of the pose solver made on the CPU: keyframes,
    pairs and tracks identical, the final rotations within SFM_POSE_ATOL,
    the camera centres within it after similarity alignment, the cost
    within SFM_COST_RTOL."""
    from casmtr_tpu_torch.sfm import ba, pose
    from casmtr_tpu_torch.sfm import pipeline as pl
    from casmtr_tpu_torch.sfm import reconstruct as Rc
    prob = sfm_problem(torch, np.random.default_rng(0))
    for solver in ("dense", "cg"):
        out = {}
        for d in (dev, "cpu"):
            q, c = ba.run_ba(ba.to_device(prob, d), iters=10, solver=solver)
            out[d] = (gauge_free(torch, q), float(c))
        (rv_a, t_a), c_a = out[dev]
        (rv_b, t_b), c_b = out["cpu"]
        rel = abs(c_a - c_b) / c_b
        d_rv, d_t = np.abs(rv_a - rv_b).max(), np.abs(t_a - t_b).max()
        log(f"sfm: BA {solver} {dev} against CPU: cost {c_a:.6f} / "
            f"{c_b:.6f} (relative {rel:.2e}), rotations {d_rv:.2e}, "
            f"gauge-free translations {d_t:.2e}")
        check(rel <= SFM_COST_RTOL, f"sfm: BA {solver} cost")
        check(max(d_rv, d_t) <= SFM_POSE_ATOL, f"sfm: BA {solver} cameras")

    match_fn, K, _ = sfm_sequence(np.random.default_rng(0), noise=0.3)
    kfs = list(range(5))
    pairs = pl.pair_graph(kfs, (1, 2))
    M = pl._bucket([len(match_fn(i, j)[0]) for i, j in pairs])
    noise = pose.pose_noise(len(pairs), pl.N_HYP, M,
                            torch.Generator().manual_seed(0), "cpu")
    res = {d: pl.reconstruct_sequence(match_fn, 5, K, keyframes=kfs,
                                      overlaps=(1, 2), ba_iters=15, pgo=True,
                                      device=d, noise=noise)
           for d in (dev, "cpu")}
    a, b = res[dev], res["cpu"]
    same_tracks = (list(a.tracks) == list(b.tracks) and all(
        [f for f, _ in a.tracks[k]] == [f for f, _ in b.tracks[k]]
        and all(np.array_equal(u, v) for (_, u), (_, v)
                in zip(a.tracks[k], b.tracks[k])) for k in a.tracks))
    d_rv = float(np.abs(a.problem.cam_rvec.cpu().numpy()
                        - b.problem.cam_rvec.numpy()).max())
    d_c = Rc.ate_rmse(Rc.camera_centers(a.problem),
                      Rc.camera_centers(b.problem))
    rel = abs(a.cost - b.cost) / b.cost
    log(f"sfm: pipeline {dev} against CPU (5 frames, PGO): keyframes "
        f"{a.keyframes} / {b.keyframes}, pairs {len(a.matches)}, tracks "
        f"{len(a.tracks)} / {len(b.tracks)} identical {same_tracks}; chain "
        f"init rotations {np.abs(a.init_Rs - b.init_Rs).max():.2e}, "
        f"translations {np.abs(a.init_ts - b.init_ts).max():.2e}; final "
        f"rotations {d_rv:.2e}, aligned centres {d_c:.2e}, cost "
        f"{a.cost:.6f} / {b.cost:.6f} (relative {rel:.2e})")
    check(a.keyframes == b.keyframes and list(a.matches) == list(b.matches),
          "sfm: pipeline keyframes or pairs differ")
    check(same_tracks, "sfm: pipeline tracks differ")
    check(max(d_rv, d_c) <= SFM_POSE_ATOL, "sfm: pipeline poses differ")
    check(rel <= SFM_COST_RTOL, "sfm: pipeline cost differs")


@contextlib.contextmanager
def stage_clock(torch, targets, dev):
    """Each (module, attribute, stage) of ``targets`` wrapped in a timer
    that waits for the device after the call; yields the seconds per
    stage (summed over calls)."""
    secs, saved = {}, []
    for mod, attr, stage in targets:
        fn = getattr(mod, attr)

        def clocked(*a, _fn=fn, _stage=stage, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[_stage] = secs.get(_stage, 0.0) + time.perf_counter() - t0
            return out

        saved.append((mod, attr, fn))
        setattr(mod, attr, clocked)
    try:
        yield secs
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def peak_gib(torch, dev):
    return (torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda"
            else float("nan"))


def reset_peak(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def sfm_sequence_phase(torch, dev="cuda", seq=SFM_SEQ, run=SFM_SEQ_RUN):
    """Phase 14(b): reconstruct_sequence on ``dev`` over scripts/
    sfm_scale_bench.py --big's sequence (SFM_SEQ, SFM_SEQ_RUN; every frame
    a keyframe, the device solver, PGO): rms, ATE of the result and of the
    chain init, points and observations, the wall split by stage
    (matching, pose, chain, PGO, tracks, problem assembly, BA), BA per LM
    iteration, the host's waits for the device, peak memory; the script's
    gate (rms < 2 px, ATE < 0.05 x frames x 0.35)."""
    from casmtr_tpu_torch.sfm import ba
    from casmtr_tpu_torch.sfm import pipeline as pl
    from casmtr_tpu_torch.sfm import reconstruct as Rc
    n = seq["n_frames"]
    t0 = time.perf_counter()
    match_fn, K, gt = scale_sequence(np.random.default_rng(0), **seq)
    made = time.perf_counter() - t0
    targets = ((pl, "match_pairs", "matching"),
               (pl, "pair_relative_poses", "pose"),
               (pl, "chain_with_scale", "chain"),
               (pl, "refine_with_pose_graph", "PGO"),
               (pl, "build_tracks", "tracks"),
               (pl.Rc, "build_problem", "problem"),
               (pl.ba_mod, "run_ba", "BA"))
    syncs = dict(pl.HOST_SYNCS, pcg=ba.HOST_SYNCS["pcg"])
    reset_peak(torch, dev)
    with stage_clock(torch, targets, dev) as secs:
        t0 = time.perf_counter()
        res = pl.reconstruct_sequence(match_fn, n, K,
                                      keyframes=list(range(n)), device=dev,
                                      **run)
        wall = time.perf_counter() - t0
    waits = {k: v - syncs[k] for k, v in
             dict(pl.HOST_SYNCS, pcg=ba.HOST_SYNCS["pcg"]).items()}
    n_obs = int(res.problem.obs_valid.sum())
    rms = float(np.sqrt(res.cost / max(n_obs, 1) / 2))
    ate = Rc.ate_rmse(Rc.camera_centers(res.problem), gt[res.keyframes])
    init = np.stack([-R.T @ t for R, t in zip(res.init_Rs, res.init_ts)])
    ate_init = Rc.ate_rmse(init, gt[res.keyframes])
    bound = 0.05 * n * 0.35
    log(f"sfm: sequence {n} frames, {seq['P']} points, {len(res.matches)} "
        f"pairs (made in {made:.1f} s): {res.problem.points.shape[0]} "
        f"points, {n_obs} observations, rms {rms:.4f} px (gate < 2), ATE "
        f"{ate:.5f} (gate < {bound:.3f}), chain init ATE {ate_init:.5f}; "
        f"wall {wall:.2f} s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f" s; BA {secs['BA'] / run['ba_iters'] * 1e3:.1f} ms per LM "
        f"iteration; the host waited on the device {waits}; peak "
        f"{peak_gib(torch, dev):.2f} GiB")
    check(rms < 2.0 and ate < bound, "sfm: the sequence misses its gate")
    return wall, secs


def sfm_big_ba_phase(torch, dev="cuda", shape=SFM_BA, run=SFM_BA_RUN):
    """Phase 14(c): run_ba with the CG solver on ``dev`` on
    bench_sharded_cg's problem (SFM_BA, SFM_BA_RUN) from its perturbed
    init, after one warm-up iteration: rms and ATE before and after, wall
    per LM iteration, CG's host waits, peak memory; the script's gate
    (rms < 1 px, ATE under half the init's)."""
    from casmtr_tpu_torch.sfm import ba
    from casmtr_tpu_torch.sfm import reconstruct as Rc
    (rv_gt, tv_gt), p = big_problem(torch, np.random.default_rng(2), **shape)
    p = ba.to_device(p, dev)
    gt = np.stack([-rvec_matrix(r).T @ t for r, t in zip(rv_gt, tv_gt)])
    n_obs = int(p.obs_valid.sum())
    rms0 = float(np.sqrt(float(ba.robust_cost(p, None)) / n_obs / 2))
    ate0 = Rc.ate_rmse(Rc.camera_centers(p), gt)
    ba.run_ba(p, iters=1, solver=run["solver"], cg_iters=run["cg_iters"])
    before = ba.HOST_SYNCS["pcg"]
    reset_peak(torch, dev)
    t0 = time.perf_counter()
    q, c = ba.run_ba(p, **run)
    cost = float(c)                                # waits for the device
    wall = time.perf_counter() - t0
    rms1 = float(np.sqrt(cost / n_obs / 2))
    ate1 = Rc.ate_rmse(Rc.camera_centers(q), gt)
    log(f"sfm: CG BA C {shape['C']}, P {shape['P']}, N {n_obs}, "
        f"{run['iters']} LM iterations of at most {run['cg_iters']} CG "
        f"steps: rms {rms0:.3f} -> {rms1:.3f} px (gate < 1), ATE "
        f"{ate0:.5f} -> {ate1:.5f} (gate < {0.5 * ate0:.5f}); {wall:.2f} s, "
        f"{wall / run['iters'] * 1e3:.1f} ms per LM iteration, "
        f"{ba.HOST_SYNCS['pcg'] - before} CG steps read on the host; peak "
        f"{peak_gib(torch, dev):.2f} GiB")
    check(rms1 < 1.0 and ate1 < 0.5 * ate0, "sfm: the CG BA misses its gate")
    if dev == "cuda":
        sfm_ba_profile(torch, p, run)
    return wall


def sfm_ba_profile(torch, p, run):
    """One more LM iteration of ``p`` under torch.profiler: the device time
    summed over its kernels against its wall (the idle share, with the
    profiler's own host cost in the wall), and the operators with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from casmtr_tpu_torch.sfm import ba
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ba.run_ba(p, iters=1, solver=run["solver"], cg_iters=run["cg_iters"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    _, busy = top(avgs, lambda e: e.device_type == DeviceType.CUDA, 1)
    if busy == 0:
        log("sfm: BA profile: the profiler recorded no device time (not "
            "measured)")
        return
    ops, _ = top(avgs, lambda e: e.key.startswith("aten::")
                 and e.self_device_time_total > 0, 8)
    log(f"sfm: BA profile, one LM iteration: wall {wall:.1f} ms under the "
        f"profiler, device time summed over kernels {busy:.1f} ms, idle "
        f"share {1 - busy / wall:.3f}")
    for ms, n, key, _ in ops:
        log(f"sfm: BA profile: op {ms:8.3f} ms {n:5d}x {key}")


def sfm_command_phase(torch):
    """Phase 14(d): python -m casmtr_tpu_torch.cli.reconstruct (its main)
    on the fixture's four MegaDepth-layout frames (1200x800) with their
    intrinsics, 4c at SFM_RESIZE in the card's default (bf16) with seeded
    random weights and every match threshold at 0 (--thr -1: random weights
    match nothing at 0.2), --min-matches 100000 (every frame a keyframe)
    and --pgo: the report with the JAX command's keys and the PLY written;
    the launch counts, zeroed just before, held to (match_fn calls) x 4c's
    per-pair counts; seconds per matched pair; the poses' ATE against the
    fixture's poses, printed (random weights)."""
    import tempfile
    import warnings
    from casmtr_tpu_torch.cli import reconstruct as cli
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    from casmtr_tpu_torch.sfm import pipeline as pl
    from casmtr_tpu_torch.sfm import reconstruct as Rc
    scene = os.path.join(FIXTURES, "megadepth")
    frames = os.path.join(scene, "Undistorted_SfM", "0000", "images")
    info = np.load(os.path.join(scene, "index", "scene_info", "0000.npz"),
                   allow_pickle=True)
    K = info["intrinsics"][0]
    gt = np.stack([-T[:3, :3].T @ T[:3, 3] for T in info["poses"]])
    calls = []
    make = pl.model_match_fn
    seen = []          # (launcher, inputs, outputs) of the first matched pair
    launchers = ((qk_, "_launch_fwd"), (wk, "_launch_score_fwd"),
                 (wk, "_launch_wca_fwd"))
    saved = [getattr(m, a) for m, a in launchers]

    def copied(x):
        if isinstance(x, tuple):
            return tuple(copied(t) for t in x)
        return x.clone() if torch.is_tensor(x) else x

    def recording(attr, fn):
        def rec(*args):
            out = fn(*args)
            if not calls:
                seen.append((attr, copied(args), copied(out)))
            return out
        return rec

    def counting(*a, **k):
        fn = make(*a, **k)

        def timed_fn(i, j):
            t0 = time.perf_counter()
            out = fn(i, j)                   # numpy back: the card is done
            calls.append(time.perf_counter() - t0)
            return out
        return timed_fn

    with tempfile.TemporaryDirectory() as tmp:
        out, ply = os.path.join(tmp, "recon.json"), os.path.join(tmp, "r.ply")
        argv = [frames, "--fx", str(K[0, 0]), "--fy", str(K[1, 1]),
                "--cx", str(K[0, 2]), "--cy", str(K[1, 2]),
                "--resize", str(SFM_RESIZE), "--thr", "-1",
                "--min-matches", "100000", "--pgo", "--overrides-json",
                json.dumps(zero_threshold_overrides("outdoor_casmtr_4c")),
                "--out", out, "--ply", ply]
        pl.model_match_fn = counting
        for (m, a), fn in zip(launchers, saved):
            setattr(m, a, recording(a, fn))
        try:
            with precision("bf16"), warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always", RuntimeWarning)
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                report = cli.main(argv)
                wall = time.perf_counter() - t0
        finally:
            pl.model_match_fn = make
            for (m, a), fn in zip(launchers, saved):
                setattr(m, a, fn)
        totals = dict(kernels.LAUNCHES)
        with open(out) as f:
            written = json.load(f)
        with open(ply) as f:
            header, body = f.read().split("end_header\n")
    per_pair = LAUNCHES_PER_PAIR[SFM_NAME]
    n = len(calls)
    kfs = report["keyframes"]
    centers = np.array([p["center"] for p in report["poses"]])
    ate = Rc.ate_rmse(centers, gt[kfs]) if len(kfs) > 2 else float("nan")
    n_vertex = int(header.split("element vertex ")[1].split()[0])
    log(f"sfm: reconstruct main, 4 frames at {SFM_RESIZE}: {wall:.2f} s, "
        f"{n} matched pairs (first {calls[0]:.3f} s, median of the others "
        f"{statistics.median(calls[1:]):.3f} s per pair), keyframes {kfs}, "
        f"matches {report['n_matches']}, {report['n_tracks']} tracks, "
        f"{report['n_obs']} observations, cost {report['ba_cost']:.3f}; "
        f"ATE against the fixture's poses {ate:.4f} (random weights: "
        f"printed, not gated); {len(w)} RuntimeWarnings "
        f"({'; '.join(sorted({str(x.message)[:60] for x in w}))}); PLY "
        f"{n_vertex} vertices; launches {totals}")
    check(tuple(written) == SFM_REPORT_KEYS and written == json.loads(
        json.dumps(report)), f"sfm: report keys {sorted(written)}")
    check(n_vertex == report["n_tracks"] == len(body.splitlines()),
          "sfm: the PLY does not hold the points")
    check(totals == {k: v * n for k, v in per_pair.items()},
          f"sfm: launches {totals}, expected {n} x {per_pair}")
    reconstruct_kernels_check(torch, seen, per_pair)
    return {"bf16": (totals, per_pair, [])}


def reconstruct_kernels_check(torch, seen, per_pair):
    """14(d)'s own kernel shapes: every launch of the first matched pair
    (A and A′ on the 1/8 pyramid of the padded, masked non-square canvas, B
    and C on its 1/4 grid), its output as the main path got it held
    against the plain version on the same captured inputs.  A's, B's and
    C's outputs and A′'s message within KERNEL_TOL; A′'s sorted scores
    within SCORE_TOL and its index sets equal except on near ties
    (TIE_GAP).  Each kernel of the pair held as often as it launches.  All
    are logged before the first failure is raised."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    stats = {}
    for launcher, args, out in seen:
        extra = {}
        if launcher == "_launch_fwd":
            q, k, v, ids, hw_q, hw_k = args[:6]
            topk = args[7] if len(args) > 7 else 0
            name = "quadtree_fine_topk" if topk else "quadtree_fine_attention"
            shape = f"{hw_q[0]}x{hw_q[1]} K {ids.shape[2]}"
            if topk:
                p_msg, p_score, p_idx, _ = qk_.quadtree_fine_topk_plain(
                    q, k, v, ids, hw_q, hw_k, topk + 1, with_lse=True)
                pairs = [(out[0], p_msg)]
                rows = torch.ones(q.shape[:3], dtype=torch.bool,
                                  device=q.device)
                s_err, bad, near, _, _ = selection_errors(
                    torch, out[2], out[3], p_score, p_idx, topk, rows)
                extra = {"score": s_err, "bad": bad, "near": near}
            else:
                pairs = [(out[0], qk_.quadtree_fine_attention_plain(
                    q, k, v, ids, hw_q, hw_k))]
        elif launcher == "_launch_score_fwd":
            q_blk, feat1, corners, w = args
            q = q_blk
            name = "window_patch_score"
            shape = f"{feat1.shape[1]}x{feat1.shape[2]} C {feat1.shape[3]}"
            pairs = [(out, wk.window_patch_score_plain(q_blk, feat1, corners,
                                                       w))]
        else:
            q, k, v, corners, hw_q, hw_k, w = args[:7]
            name = "window_cross_attention"
            shape = f"{hw_q[0]}x{hw_q[1]} H {q.shape[2]}"
            pairs = [(out[0], wk.window_cross_attention_plain(
                q, k, v, corners, hw_q, hw_k, w))]
        if name != "window_patch_score" and q.dtype == torch.bfloat16:
            name += "_bf16"
        st = stats.setdefault(name, {"n": 0, "shapes": set(), "err": 0.0,
                                     "scale": 0.0, "score": 0.0, "bad": 0,
                                     "near": 0})
        st["n"] += 1
        st["shapes"].add(shape)
        for a, b in pairs:
            ok = a.shape == b.shape and bool(torch.isfinite(a).all())
            err = float((a - b).abs().max()) if ok else float("inf")
            st["err"] = max(st["err"], err)
            st["scale"] = max(st["scale"], float(b.abs().max()))
        if extra:
            st["score"] = max(st["score"], extra["score"])
            st["bad"] += extra["bad"]
            st["near"] += extra["near"]
    for name, st in sorted(stats.items()):
        log(f"sfm: kernel {name} on the first matched pair: {st['n']} "
            f"launches at {sorted(st['shapes'])}, max_abs_err "
            f"{st['err']:.3e} (tol {KERNEL_TOL:g}; max |plain| "
            f"{st['scale']:.3g})"
            + (f", sorted scores {st['score']:.3e} (tol {SCORE_TOL:g}), "
               f"{st['bad']} rows select other indices, {st['near']} near "
               "ties excluded" if name.startswith("quadtree_fine_topk")
               else ""))
    for name, st in sorted(stats.items()):
        check(st["err"] <= KERNEL_TOL, f"sfm: {name} on the first matched "
              f"pair: max abs error {st['err']:.3e} (or a shape or a "
              "non-finite value)")
        check(st["score"] <= SCORE_TOL and st["bad"] == 0,
              f"sfm: {name} on the first matched pair: scores "
              f"{st['score']:.3e}, {st['bad']} rows select other indices")
    held = {name: st["n"] for name, st in stats.items()}
    check(held == {k: v for k, v in per_pair.items() if v},
          f"sfm: held {held} on the first pair, it launches {per_pair}")


def sfm_ate_witness(torch, seeds=(0, 1, 2)):
    """14(b)'s sequence on the card with the pose solver's draw seeded
    with each of ``seeds``, then on the CPU (draw seeded 0): rms and ATE of
    each, the spread that the draw and the device make.  Not part of the
    default run (the CPU run takes minutes); run it as python -c 'import
    torch, chip_smoke as c; c.sfm_ate_witness(torch)'."""
    for dev, seed in [("cuda", s) for s in seeds] + [("cpu", 0)]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        timed(f"sfm: sequence on {dev}, draw seeded {seed}",
              sfm_sequence_phase, torch, dev, SFM_SEQ,
              dict(SFM_SEQ_RUN, generator=gen))


def sfm_phase(torch):
    """Phase 14: (a) card against CPU, (b) the 200-frame sequence, (c) the
    C 240 CG bundle adjustment, (d) the reconstruct command.  Returns (d)'s
    serving run."""
    timed("sfm: card against CPU", sfm_card_cpu_phase, torch)
    torch.cuda.empty_cache()
    timed("sfm: sequence", sfm_sequence_phase, torch)
    torch.cuda.empty_cache()
    timed("sfm: CG BA", sfm_big_ba_phase, torch)
    torch.cuda.empty_cache()
    return timed("sfm: command", sfm_command_phase, torch)


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import casmtr_tpu_torch  # noqa: F401  (fails outside the repository)
    from casmtr_tpu_torch.ops import kernels
    if argv[:1] == ["--first-request"]:   # phase 10's fresh-process probe
        return first_request_probe(argv[1], argv[2] == "--warm")
    if argv:
        print("usage: chip_smoke.py", file=sys.stderr)
        return 2

    # full float32 everywhere the port compares numbers, and bf16 products
    # summed in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, numpy {np.__version__}, device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.lib(fresh=True)
    log(f"build: nvcc {' '.join(kernels.NVCC_FLAGS)} of "
        f"{len(kernels.SOURCES)} sources, {kernels.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")
    for line in kernels.build_log().splitlines():
        if "Used" in line or "entry function" in line or "spill" in line:
            log(f"build: {line.strip()}")

    rows = timed("kernels", kernel_phase, torch)
    train_rows = timed("training kernels", train_kernel_phase, torch)
    timed("finite difference", finite_difference_phase, torch)
    serve_runs = {}
    for recipe in BASE_MODELS:
        # the ResNetFPN variant in the card's default only
        precs = ("bf16",) if recipe == RESNET else ("bf16", "f32")
        serve_runs[recipe], matcher, request = timed(
            f"serving {recipe}", serving_phase, torch, recipe, precs)
        # one request per precision of the two recipes, one in bf16 of the
        # baseline and the indoor recipe
        profiled = (precs if recipe in RECIPES else
                    ("bf16",) if recipe in (BASELINE, INDOOR, REFINE)
                    else ())
        for prec in profiled:
            timed(f"profile {recipe} {prec}", profile_phase, torch, recipe,
                  matcher, request, prec,
                  recipe == RECIPES[0] and prec == "f32")
        del matcher
        torch.cuda.empty_cache()
    for recipe in BASE_MODELS:
        if recipe != RESNET:
            timed(f"reference {recipe}", reference_phase, torch, recipe)
    train_runs = {}
    earlier = {}    # readings of phases 7 and 12 that phase 13 prints beside
    for recipe in BASE_MODELS:
        for prec in ("bf16", "f32"):
            with precision(prec):
                totals, counts, step, state, batch, times = timed(
                    f"training {recipe} {prec}", training_phase, torch,
                    recipe, prec)
                train_runs[recipe, prec] = (totals, counts)
                if (recipe, prec) == ("outdoor_casmtr_4c", "bf16"):
                    earlier["4c bf16 step_s"] = statistics.median(times)
                if prec == "bf16" or recipe not in (BASELINE, INDOOR,
                                                    REFINE):
                    timed(f"training profile {recipe} {prec}",
                          train_profile_phase, torch, f"{recipe} {prec}",
                          step, state, batch, statistics.median(times))
            del step, state
            torch.cuda.empty_cache()
    for recipe in BASE_MODELS:
        timed(f"training reference {recipe}", train_reference_phase, torch,
              recipe)
    timed("detector", detector_phase, torch)
    ckpt_runs, stage_runs = timed("checkpoints", checkpoint_phase, torch)
    zoo_rows, zoo_train_rows = timed("zoo kernels", zoo_kernel_phase, torch)
    rows += zoo_rows
    train_rows += zoo_train_rows
    for name in ZOO:
        serve_runs[name], train_runs[name, "bf16"] = zoo_phase(torch, name)
    serve_runs.update(timed("filters", filter_phase, torch))
    timed("pose", pose_phase, torch)
    serve_runs[EVAL_NAME], earlier["run_eval pairs/s"] = timed(
        "evaluate", evaluate_phase, torch)
    _, serve_runs[IO_EVAL], io_train_runs, _ = timed("files", files_phase,
                                                     torch, earlier)
    train_runs.update(io_train_runs)
    serve_runs[SFM_NAME] = timed("sfm", sfm_phase, torch)

    # launches: each path's counts, summed over the models' runs (phase 11's
    # ZOO models in the card's default only), and each model's count in its
    # last request and its last step.  A row reads the runs of its
    # precision: the bf16 instances, B and B-bwd the card's bf16 default,
    # the f32 A, A′, A-bwd, C and C-bwd the runs with float32 forced.
    for path, table, key in (("serving", rows, "launches_per_pair"),
                             ("training", train_rows, "launches_per_step")):
        for row in table:
            prec = "f32" if row["name"] in BF16_KERNELS else "bf16"
            if path == "serving":
                runs = {r: serve_runs[r][prec][:2] for r in serve_runs
                        if prec in serve_runs[r]}
            else:
                runs = {r: v for (r, p), v in train_runs.items()
                        if p == prec}
            row["launches_from"] = f"{path}, {prec}"
            row["launches"] = sum(t[row["name"]] for t, _ in runs.values())
            row[key] = {r: c[row["name"]] for r, (_, c) in runs.items()}
            # phase 10's paths, counted on their own: the checkpointed
            # Matchers per pair, the staged run per step of each stage
            if prec == "bf16":
                row["launches_checkpoints"] = (
                    {r: c[row["name"]] for r, (_, c) in ckpt_runs.items()}
                    if path == "serving" else
                    {r: c[row["name"]] for r, (_, c) in stage_runs.items()})
    log(json.dumps({"kernels": rows + train_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
