#!/usr/bin/env python3
"""Drive the PyTorch port's stereo paths on one H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(Phase 4i starts this script twice more, as the two ranks of a process
group, with ``--multihost-rank``.)

Phases, each of which raises (exit code 1, no result lines) on failure:

1. device: the card must be a Hopper (sm_90); prints its name and power limit.
2. build: compiles the ten CUDA kernels from ``stereo_match_tpu_torch/csrc``
   with nvcc (one process per source, all at once) and prints the
   ``-Xptxas -v`` report.
3. kernel parity at KITTI shape (1242x375, D=128, slanted random-dot scene,
   seed 1): each kernel against its plain PyTorch version on the same CUDA
   tensors. K1, K2 and the K3 totals must be bit-equal; K4 must give the
   same NaN mask and values within 1e-6. Then K4's three entries on a
   tie-heavy float32 total (``K.tie_heavy_total``: constant planes, minima
   at d = 0 and D - 1, equal minima over idx -+ 1, equal right-view
   diagonals) at KITTI and at 720p D=160: wta_stats and right_wta
   bit-equal, wta_lr as above, at three settings.
3b. post-stack kernel parity at full size: K5 (the whole speckle filter,
   one cooperative launch) on the KITTI and 720p disparity maps with 600
   injected 2x2 and 4x4 speckles (T=100, range 2) must give the plain
   filter's output, sweep count and unconverged flag bit for bit, in one
   launch and with no host sync (``torch.cuda.set_sync_debug_mode``); so
   must it on a serpentine at the k sweeps it needs and at k - 1 (which
   keeps everything), at W = 1, H = 1, on an all-NaN map and with no
   sweep. Where ``torch.profiler`` sees the card, the filter must show one
   device kernel. K7 (a row and a
   column solve of the (2, H, W) slab as it lies, at KITTI and 720p) must
   equal its partitioned model bit for bit, and against a float64 solve be
   off at most K7_F64_RATIO times the sequential float32 plain solve.
3c. K3 (one warp per path line) direction by direction, written and added
   onto a nonzero total, bit-equal to its plain version: float32 and int16
   at KITTI, float32 at 720p D=160, float32 and int16 at 1243x377 D=48.
3d. the multiword census and the float disp12 tolerance at KITTI: K1 with
   a 7x9 window (62 bits, two words), K2 on those words (float32, int16,
   transposed) and K4 ``lr_mask`` at the tolerances 1.5 and 2.0 (ELAS's
   ``lr_tol``), each bit-equal to its plain version; K1 at 720p and at
   the odd widths 1241 and 1243 (word-plane rows at every 16-byte
   alignment), 5x5 and 7x9, bit-equal; K2 at an odd width
   (1241), D = 1 and 128, min_d 0, 37 and 5, on one and two words, float32
   and int16, planes and transposed, bit-equal.
4. main path: ``StereoMatcher`` with the headline config, launch counts
   reset just before the run and read just after; the result against the
   plain path on the card (same NaN mask, values within 1e-6) and against
   the scene's ground truth (bad-3px < 0.05, density > 0.8). Then the same
   comparison at 1280x720, D=160.
4b. post-stack paths through ``StereoMatcher``, each with its launch
   counts: ``DisparityConfig()`` at 720p (D=160, WLS lambda 80000 sigma
   1.2, 3 iterations: settings.ini); KITTI D=128 with speckle 100 range 2
   and WLS; the same with ``wls_lr_confidence``. Raw must match the plain
   path (same NaN mask, 1e-6); filtered must be finite, its error against
   the float64 path (the same filter with float64 solves) at most
   K7_F64_RATIO times the plain path's, within K7_PLAIN_PX of the plain
   path beyond the plain path's own float64 error, and its bad-3px over
   the raw map's valid pixels < 0.05.
4c. the flagship flow: ``run_pipeline`` at 720p with the default config, a
   pure lateral baseline and one K; the PLY must round-trip through
   ``read_ply`` and the reprojected depth of the slanted plane must match
   f*B/d of the scene.
4d. the MC-CNN path with the shipped checkpoints (fast 4x64, accurate
   5x112): K8 against its plain version (cuDNN in full float32) for every
   layer of both at KITTI shape, within 1e-5, or, where a layer misses it,
   with its error against F.conv2d in float64 at most twice cuDNN float32's
   (both printed for every layer); K9 against its plain version
   at KITTI D=128 on both archs' features, at 720p D=160 and on an odd
   case (F=100 unit features, D=96, min_d=3, 1243x377), within 1e-4
   with the 1e4 mask exactly equal. Then ``StereoMatcher`` with
   ``MCCNNCost`` at the headline WTA settings (``bench.py``'s
   ``mccnn_sgm8``), per arch: launch counts (at D = 128 and min_d 0 the
   one-kernel path: K8 one per layer but the last, K11 1, K9 0, K3 8, K4 1,
   K1 = K2 = 0); agreement with the all-plain MC-CNN path on at least
   99.5 % of the pixels (same NaN state, |diff| <= 0.01: the tower's sums
   run in another order than cuDNN's, which can flip a WTA decision);
   bad-3px < 0.05 and density > 0.8 on the seed-1 scene; with noise=25,
   density above census's on the same frame and above 0.9, bad-3px
   < 0.05. The JAX package's CPU figures are printed beside the card's.
   Then both towers with ``compute_dtype=torch.bfloat16``: K8's bfloat16
   mode against its plain bfloat16 layer for every layer, on the tensors
   the module passes (bfloat16 channels-last between layers; at least
   K8_BF16_EQUAL of the outputs bit-equal where there is no norm, each
   within the ulp bound stated at K8_BF16_EQUAL), the tower within 1e-2 of
   the plain tower, ``mccnn_cost_volume(use_bf16=True)`` on the float32
   model (its ``bf16_twin``, made once) bit-equal to the bfloat16 model's
   volume with L - 1 K8 launches and 1 K11, and the matcher with the same
   launch counts, agreeing
   with its plain bfloat16 path on at least MC_BF16_AGREE of the pixels,
   with the same quality bars; its (bad-3px, density) are printed beside
   the float32 path's. K11 (the last layer, its norm and the volume in one
   launch) on both towers in both modes, on the last layer's input at
   KITTI D=128: against K8's last launch then K9 (the share of bit-equal
   cells printed; within K9_TOL, in bfloat16 plus what features off by
   twice the ulp bound of K8 bf16's normalised layer move a cell) and
   against its plain version (that bar plus K9_TOL plus what K8's measured
   feature errors move a cell), 1e4 masks equal (``k11_check``). K9
   stays on the path at min_d 4: the fast matcher there launches K8 4
   times and K9 once and agrees with its plain path on at least 99.5 % of
   the pixels.
4e. int16 volumes, the row-tiled SGM and the stage-pipelined stream, at
   KITTI on the seed-1 scene: K2 int16 and transposed, K3 int16 totals,
   K10 (forward and reverse, invalid 1e4 and 1024, min_d 0 and 5) and K4's
   int16, wta_stats, right_wta and lr_mask entries bit-equal to their plain
   versions, K10 at 1e4 equal to K2 + K3's horizontal pair; K4's entries on
   tie-heavy int16 totals at KITTI and 720p as in phase 3;
   ``extract_disparity_fast`` launching wta_stats, right_wta and lr_mask
   once each and equal to wta_lr's map;
   ``sgm_aggregate_sharded`` over 4 row shards of 96/96/96/87 rows on a
   device list repeating the card: exact bit-equal to the whole-frame K3
   total and to the plain chain (float32 and int16), halo 48 agreeing on
   the argmin for
   >= 0.985 of the pixels; ``StreamingPipeline`` with 4 stages on the
   device list cuda:{k % cards}, k < 4 (as 4i: one card repeated, or four
   cards), printed, over 6 frames, volume and census payloads: the float32
   wire bit-equal to
   ``_match_core`` frame by frame, the int16 wire bit-equal to the float32
   run with the 1024 sentinel, a 2-stage run with speckle 100 + WLS within
   1e-5 (raw) and 5e-3 (filtered); ``StereoMatcher`` with
   ``dtype="int16"`` bit-equal to its plain path and to the float32 path
   with the 1024 sentinel, equal to the float32 matcher for x >= D, with
   a lower peak memory. Each path with its launch counts, which must be
   exactly what its stages run (6 frames: volume stream K1 6, K2 6, K3 48,
   K4 6; census stream K1 6, K10 12, K2 12, K3 36, K4 6; tiling K3 32;
   int16 matcher K1 1, K2 1, K3 8, K4 1).
4f. the reference's other matchers at KITTI D=128 on the seed-1 scene, each
   through its entry point with its launch counts (exact), its agreement
   with the same path on the plain versions on the card, and its bad-3px
   and density against the ground truth: ``StereoMatcher`` with a 7x9
   census (K1 1, K2 1, K3 8, K4 1; equal to the plain path within 1e-6,
   the same NaN mask), with the Birchfield-Tomasi cost (``bench.py``'s
   ``bt_sgm8``: K3 8, K4 1, no K1 or K2) and with SAD on 2 paths
   (``sad_bm_wta``: K3 2, K4 1), the sad and bt volumes being plain torch
   on the card as they are XLA in the JAX package; ``block_match`` (block
   21, disp12 -1: ``stereobm_true``; K4 1); ``elas_match`` with
   ``ElasConfig()`` (K1 1, K2 1 + D, K4 ``wta_stats`` 1, ``right_wta`` 1,
   ``lr_mask`` 2), with the native library built by g++, the same support
   points as its plain path and at least 99.5 % of the pixels agreeing;
   the 4-stage volume stream with the 7x9 window over 3 frames, bit-equal
   to the plain scans added in the stream's order and agreeing with
   ``_match_core`` on at least 99.9 % of the pixels (P1 = 62/3 is
   fractional, so the total depends on the order of the paths and a
   near-tie may flip).
4g. monodepth and the ``smt-torch`` CLI: the shipped small checkpoint and
   the full arch (weights from a seeded ``torch.Generator``) on 375x1242
   ray-traced frames (seeds 904, 905) through the 96x160 protocol and
   natively (padded to 384x1248): the card's map within MONO_TOL of a
   width fraction of the port's CPU path on the same weights, also with
   TF32 allowed globally around the call (the net scopes it off; the error
   without that scope is printed), no port kernel launched; on the shipped
   checkpoint through 96x160 the affine-calibrated EPE at most MONO_BAR
   times the constant predictor's, printed beside the JAX package's CPU
   figures; ms a frame (CUDA events) and peak memory at both sizes. Then
   ``main([...])`` in-process on KITTI-size PNGs of the seed-1 scene:
   ``match`` (census, ``--write_ply``), ``match --method mccnn``, ``mono``,
   ``reproject``, ``costbin`` and ``stream --stages 1``, each exiting 0
   with its files written and its wall ms printed; the ``.npy`` maps
   bit-equal to the direct call on the card (``StereoMatcher``,
   ``predict_disparity``, ``external_volume_to_disparity``), ``match``'s
   with the same launch counts.
4h. training on the card (no kernel in the train step: ``F.conv2d`` under
   autograd and optax's Adam, as flax is XLA under ``jax.value_and_grad``):
   the MC-CNN fast and accurate towers at ``tools/train_mccnn.py``'s
   width (512 triplets of 16x16 patches, lr 2e-3) and the monodepth
   small and full nets at ``tools/train_monodepth.py``'s (batch 16 at
   96x160, lr 3e-4 cosine), card against CPU from the same weights and
   batches: the first loss within TRAIN_RTOL, gradients within
   TRAIN_GRAD_RTOL of their norm (MC-CNN on the card's branch: the CPU
   takes the card's ReLU and hinge signs), a TF32 backward as the control
   that must miss it; Adam on the same gradients within TRAIN_ADAM_TOL;
   3 trainer steps' losses and weights' move within per-model bars, a
   learning rate TRAIN_LR_FAULT off as the control that must miss one;
   then ms a step (CUDA events, 20 steps after 3), the host's time to
   issue a step, patches or images a second, the FP32 bound of the MC-CNN
   step and peak memory;
   the port's MC-CNN recipe end to end (fast, 27 scenes, 8 epochs): K8 on
   the trained weights within K8_TOL of the F.conv2d chain (or against
   float64 at most K8_F64_RATIO times cuDNN's error) and far from the
   initial weights' tower, ``tests/test_mccnn.py:153-185``'s held-out bars
   (clean within 0.03 of census; noise 25 below census and 0.25) through
   K8 -> K9 -> K3 -> K4 with exact launch counts, and the tool's held-out
   report; 200 monodepth distillation steps on ray-traced scenes labelled
   by the census matcher (K1 -> K4, exact launch counts), the last 20
   steps' mean loss below the first 20's; ``smt-torch train-mccnn`` on a
   ray-traced 1242x375 pair, then ``match --method mccnn
   --mccnn_checkpoint`` on its output, bit-equal to the direct call with
   the same launches, wall ms of each; ``calibrate_camera`` on synthetic
   views (``tests/test_calibration.py``'s bars) and ``undistort_image``
   at 1242x375 on the card within 1e-3 gray levels of the CPU's.
4i. multi-device, on the device list cuda:{k % cards} for k < 4 (4 cards:
   one shard each; one card: the list repeats it), printed: K1 and K2 over
   32-plane slices at min_d 0, 32, 64, 96, K3 over 96-row blocks (exact
   carries and halo 48) and K4 a block, each bit-equal to its plain
   version at 1242x384, float32 and int16; ``match_dsharded`` at KITTI
   D=128 over 4 shards, float32 and int16, exact and halo 48, with exact
   launch counts (K1 4, K2 4, K3 32, K4 4), bit-equal to the same call on
   the plain versions, bad-3px < 0.05 and density > 0.8 (its agreement
   with ``_match_core`` printed: the padded rows), at 1242x384 (no
   padding) in exact mode bit-equal to ``StereoMatcher``, and its peak
   memory on each card beside ``_match_core``'s; ``wta_dsharded`` on the
   headline total bit-equal to K4 ``wta_lr`` (no launch: plain torch);
   ``batched_matcher_multihost`` over 2 simulated hosts x 2 chips, 8 KITTI
   frames each bit-equal to ``_match_core`` (K1 8, K2 8, K3 64, K4 8),
   then in 2 processes (this script with ``--multihost-rank``: nccl with a
   card a rank when 2 or more cards are visible, else gloo on the one
   card, said on its own line), each loading and matching its own frames,
   the rows gathered by ``all_gather`` bit-equal to the one-process run;
   the MC-CNN fast mesh trainer (data 2 x model 2, 512 triplets of 16x16)
   against the single-device trainer on the card: its first step's loss
   and gradients (on the mesh's branch, the flips counted) within
   MESH_LOSS_RTOL and MESH_GRAD_RTOL, a TF32 backward missing the latter;
   3 steps within MESH_STEP_RTOL and MESH_MOVE_RTOL of the single-device
   and of the CPU trainer (the single-device trainer on the batches
   permuted printed as the floor), a learning rate TRAIN_LR_FAULT off
   missing them; gradients and Adam's state on each slice's device; then the ms a frame of each
   ``match_dsharded`` beside ``_match_core``'s, of ``wta_dsharded``, the
   multihost frames/s and the mesh train step's ms (host clock, every
   card synchronised), and K1, K2, K3 and K4 at the shard shapes beside
   the whole frame's (CUDA events). (The stream over the device list is
   4e's.)
4j. the accuracy record's blocks (``stereo_match_tpu_torch/tools/
   accuracy_eval.py``) at full size, cv2 on the host as the oracle, each
   row printed with the card's name: the six census scenes at KITTI D=128
   at settings.ini's settings (uniqueness 15, disp12 1), the two baseline
   scenes also with speckle 100 range 2, each within 0.02 of cv2's bad-3px
   and at most 0.10 under its density (``tests/test_accuracy.py``); the
   ray-traced rows (seed 9): clean within 0.02 of cv2's bad-3px and under
   0.05, with sensor noise and a right-view gain under 0.08; the 1280x720
   D=160 row; the fast MC-CNN checkpoint against census on rough terrain
   (clean within 0.03 of census, noise 25 below it); StereoBM against
   cv2.StereoBM (block 21); the phase's seconds.
5. timing with CUDA events after a warm-up: frames/s of the main path with
   the kernels and with the plain versions at KITTI shape, and with the
   kernels at 720p; each kernel's time beside its plain version's and its
   bound (bytes over 3.35 TB/s or operations over the peak of their type);
   K3 per direction with GB/s and the share of its bound, in float32 and
   int16; K8 per layer beside cuDNN float32 (``library_ms``) with the
   shares of its 3xTF32 and FP32 bounds, and in bfloat16 beside the
   float32 kernel and cuDNN on bfloat16 tensors (``library_ms``: the
   faster of NCHW and channels-last), with its bound (the bytes of its
   storage: 2 B a bfloat16 activation, 4 B the float32 image and last
   layer; products at the bfloat16 rate) beside the bound of float32
   storage; K1 at KITTI 5x5 and 7x9 and 720p 5x5 by events (the
   record's ``ms``, as every row's) and in a CUDA graph of 64 launches
   (the record's ``graph_ms``) beside its bound; the
   peak device memory of one KITTI frame; K7's row and column solves at
   KITTI and 720p beside the plain solve and, for the KITTI column solve, a
   dense batched ``torch.linalg.solve`` (``library_ms``; torch has no
   banded solver); K5 (the whole speckle filter) at KITTI and 720p beside
   its plain version, its sweeps, its bound (d in, out out), the cost of a
   further sweep and the traffic of its label words, and run to the
   fixpoint, bit-equal to the plain filter, on maps that need many sweeps
   (noisy ramps at KITTI and 720p, one of three column bands, the
   serpentine); the frame time of the
   three post-stack paths and the speckle sweeps per frame; the frame
   time and
   peak memory of both MC-CNN paths (and their frame time in bfloat16
   beside float32), each tower and mode's frame time and peak memory on
   the one-kernel path (K11) beside the two-kernel path
   (``single_kernel=False``), in turns; K11 beside K8's last launch + K9,
   in turns, its plain version and its bound (``k11_bound``); K8 per
   layer (C_in=1 and C_in=F) and
   K9 beside their plain versions, K9 at each of its shapes beside the
   bound of its 3xTF32 body and of an FP32 one (features read once, the
   volume written once, 2 F operations a cell with x >= d) and the share
   of each; the int16 and transposed K2, K10 per
   direction beside K3's horizontal directions, the int16 K3 and K4, K4's
   entries, K3 per row shard, the exact and halo tiling beside the
   whole-frame aggregation, the stream's frames/s in both payload modes
   and wires beside ``_match_core``'s, and the peak memory of the float32
   and int16 frames; the frame time of each 4f path beside one frame of its
   plain path, and K1 and K2 at 7x9 and the float-tolerance ``lr_mask``
   beside their bounds; K2 (float32, int16, transposed, 7x9, D = 1 in one
   CUDA graph) and K4's entries (float32, int16) at KITTI and at 720p
   beside their bounds, and two streaming yardsticks over the same bytes
   (a write of the volume, ``total.amin(0)``).

The last lines are the per-kernel JSON record (with ``bound_ms``,
``bound_by``, ``library_ms`` and ``graph_ms``, null where a row has no
graph time), the card's name and power limit from
nvidia-smi, and the result line.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KITTI = dict(H=375, W=1242, D=128, d_min=5.0, d_max=90.0, seed=1)
ARKIT_720P = dict(H=720, W=1280, D=160, d_min=5.0, d_max=110.0, seed=3)
ODD = dict(H=377, W=1243, D=48)    # K3 parity: no multiple of 8 or 32
K4_TOL = 1e-6
# K7 orders the elimination otherwise than the sequential plain solve and
# takes its pivots from a side of ones, so it is held to a float64 solve
# (as K8 is): per solve and per filter its error may be at most
# K7_F64_RATIO times the plain version's; the filtered map may differ from
# the plain path's by K7_PLAIN_PX beyond the plain path's own float64 error
# (up to 0.02 px on the LR-confidence path).
K7_F64_RATIO = 2.0
K7_PLAIN_PX = 1e-3
# K8 against cuDNN in full float32: the sums run in another order, and the
# C_in > 1 layers take 3xTF32 products (each within about 3 * 2^-22 of the
# float32 product). Where a layer misses it, both are held to F.conv2d in
# float64 on the card and K8's error may be at most K8_F64_RATIO times
# cuDNN's; the run prints both errors.
K8_TOL = 1e-5
K8_F64_RATIO = 2.0
K9_TOL = 1e-4      # a 64- or 112-term dot product, times scale 24
K9_ODD = dict(F=100, D=96, min_d=3, W=1243)   # phase 4d's odd K9 case
MC_AGREE = 0.995   # share of pixels the MC-CNN path must share with plain
# K8's bfloat16 mode against its plain layer: only the order of the float32
# sums differs, so a sum on a bfloat16 rounding boundary may round the other
# way. Without the norm at least K8_BF16_EQUAL of the outputs are bit-equal
# and each is within one bfloat16 ulp of the sum before the bias plus one of
# the result; the normalised layer, whose sum of squares is also ordered
# otherwise, within those ulps over the pixel's norm plus 1e-6. A flip
# carries through the later layers, so the bfloat16 MC-CNN path must agree
# with its plain path on MC_BF16_AGREE of the pixels (the CPU test's bar
# against JAX's bfloat16 matcher).
K8_BF16_EQUAL = 0.999
MC_BF16_AGREE = 0.99
STREAM_AGREE = 0.999   # the 7x9 stream against _match_core (path order)
# The JAX package's XLA path in float32 on a CPU, KITTI D=128, seed-1
# scene, headline WTA settings: (bad-3px, density)
JAX_CPU = {"mccnn fast": (0.0013987, 0.99550),
           "mccnn fast noise=25": (0.0018325, 0.97948),
           "census": (0.0012966, 0.99447),
           "census noise=25": (0.0039023, 0.73009)}
# Monodepth (phase 4g): the card's map against the port's CPU path on the
# same weights within MONO_TOL of a width fraction; on the shipped
# checkpoint through the 96x160 protocol the affine-calibrated EPE at most
# MONO_BAR times the constant predictor's (tests/test_monodepth.py:86-107).
# The JAX package's figures on a CPU, 375x1242 ray-traced frames:
# (seed, protocol) -> (calibrated EPE, constant predictor's EPE)
MONO_SEEDS = (904, 905)
MONO_TOL = 1e-5
MONO_BAR = 0.5
JAX_MONO = {(904, "96x160"): (7.100965996639127, 19.97925567626953),
            (905, "96x160"): (5.115472226638081, 18.470230102539062),
            (904, "native"): (18.39172597540874, 19.97925567626953),
            (905, "native"): (17.221547675555577, 18.470230102539062)}
SPECKLE = dict(T=100, range=2)
WIDE = (7, 9)      # a census window of 62 bits: two words
LR_TOLS = (1.5, 2.0)   # fractional disp12 tolerances; 2.0 is ELAS's lr_tol
PALLAS = "stereo_match_tpu/ops/pallas_kernels.py"
MAIN_PATH = ("census_words", "census_volume", "sgm_path_scan", "wta_lr")
KERNELS = {   # name -> (source, the TPU kernel(s) it replaces)
    "census_words": ("stereo_match_tpu_torch/csrc/census.cu",
                     f"{PALLAS}:750"),
    "census_volume": ("stereo_match_tpu_torch/csrc/cost_volume.cu",
                      f"{PALLAS}:892; {PALLAS}:970"),
    "sgm_path_scan": ("stereo_match_tpu_torch/csrc/sgm.cu",
                      f"{PALLAS}:530; {PALLAS}:1953; {PALLAS}:464; "
                      f"{PALLAS}:174"),
    "wta_lr": ("stereo_match_tpu_torch/csrc/wta.cu",
               f"{PALLAS}:825; {PALLAS}:464"),
    "wta_stats": ("stereo_match_tpu_torch/csrc/wta.cu", f"{PALLAS}:1146"),
    "right_wta": ("stereo_match_tpu_torch/csrc/wta.cu", f"{PALLAS}:1064"),
    "lr_mask": ("stereo_match_tpu_torch/csrc/wta.cu", f"{PALLAS}:825"),
    "speckle_filter": ("stereo_match_tpu_torch/csrc/speckle.cu",
                       "stereo_match_tpu/ops/pallas_speckle.py:276"),
    "fgs_solve": ("stereo_match_tpu_torch/csrc/wls.cu",
                  "stereo_match_tpu/ops/pallas_wls.py:93; "
                  "stereo_match_tpu/ops/pallas_wls.py:169"),
    "mccnn_conv3x3": ("stereo_match_tpu_torch/csrc/mccnn.cu",
                      f"{PALLAS}:1503; {PALLAS}:1712"),
    "mccnn_conv3x3 bf16": ("stereo_match_tpu_torch/csrc/mccnn.cu",
                           f"{PALLAS}:1503; {PALLAS}:1712"),
    "mccnn_volume": ("stereo_match_tpu_torch/csrc/mccnn.cu",
                     f"{PALLAS}:1226; {PALLAS}:1329; {PALLAS}:1639"),
    "mccnn_fused_volume": ("stereo_match_tpu_torch/csrc/mccnn.cu",
                           f"{PALLAS}:1712"),
    "mccnn_fused_volume bf16": ("stereo_match_tpu_torch/csrc/mccnn.cu",
                                f"{PALLAS}:1712"),
    "census_scan": ("stereo_match_tpu_torch/csrc/sgm.cu",
                    f"{PALLAS}:1924"),
    # the multiword and float-tolerance variants (a 7x9 window, ELAS)
    "census_words 7x9": ("stereo_match_tpu_torch/csrc/census.cu",
                         "stereo_match_tpu/pipeline/stereo.py:87; "
                         f"{PALLAS}:750"),
    "census_volume 7x9": ("stereo_match_tpu_torch/csrc/cost_volume.cu",
                          f"{PALLAS}:892; {PALLAS}:970"),
    "lr_mask lr_tol=2.0": ("stereo_match_tpu_torch/csrc/wta.cu",
                           f"{PALLAS}:825"),
}


HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 peak rate
PEAK_OPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound(nbytes: float, ops: float = 0.0, kind: str = "fp32"):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def k9_work(fl, fr, D: int, min_d: int) -> tuple[int, int]:
    """(bytes, operations) of one K9 volume: both views' features read once
    and the (D, H, W) float32 volume written once; 2 F operations for each
    cell with x >= d (the cells with x < d take 1e4 and no product)."""
    F, H, W = fl.shape
    cells = H * sum(max(0, W - d) for d in range(min_d, min_d + D))
    return 4 * (2 * F * H * W + D * H * W), 2 * F * cells


def k11_bound(x, w, D: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of one K11 launch: the last layer's input (its
    storage: bfloat16 or float32), the weights (bfloat16 or float32), the
    bias and the (D, H, W) float32 volume each moved once, against the
    last layer's products (bfloat16, or float32 as three TF32 products)
    plus the band's, three TF32 products for each of the 2 F operations of
    a cell with x >= d; both on the tensor cores, so their times add."""
    bf16 = x.dtype == torch.bfloat16
    V, C, H, W = x.shape
    F = w.shape[0]
    nbytes = (x.numel() * x.element_size() + w.numel() * (2 if bf16 else 4)
              + 4 * F + 4 * D * H * W)
    conv = 2 * 9 * F * C * V * H * W
    cells = H * sum(max(0, W - d) for d in range(D))
    t_ops = (conv / PEAK_OPS["bf16"] if bf16 else
             3 * conv / PEAK_OPS["tf32"]) + 3 * 2 * F * cells / \
        PEAK_OPS["tf32"]
    t_ops, t_bytes = t_ops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def label(spec: dict) -> str:
    return f"{spec['W']}x{spec['H']} D={spec['D']}"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, n calls captured in one
    CUDA graph: the kernels' time without the host's between launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 5) / n


def calibrated_epe(pred: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    """(EPE after a least-squares affine fit of pred to gt, the constant
    predictor's EPE), over the pixels with a ground truth."""
    m = np.isfinite(gt)
    a, b = np.polyfit(pred[m], gt[m], 1)
    return (float(np.mean(np.abs(a * pred[m] + b - gt[m]))),
            float(np.mean(np.abs(np.median(gt[m]) - gt[m]))))


def phase_4g(dev: torch.device, card: str, scene_pair) -> None:
    """4g. monodepth on the card (the shipped small checkpoint and a seeded
    full arch on 375x1242 ray-traced frames), then smt-torch's subcommands
    in-process on KITTI-size PNGs of ``scene_pair`` (left, right float
    images)."""
    from stereo_match_tpu_torch.cli.main import main as smt_main
    from stereo_match_tpu_torch.config import load_settings
    from stereo_match_tpu_torch.costs import MCCNNCost, census_cost
    from stereo_match_tpu_torch.data.costbin import (
        external_volume_to_disparity, write_cost_bin)
    from stereo_match_tpu_torch.data.image import (image_read, image_save,
                                                   to_grayscale)
    from stereo_match_tpu_torch.data.ply import read_ply
    from stereo_match_tpu_torch.data.raytrace import render_stereo
    from stereo_match_tpu_torch.models import mccnn
    from stereo_match_tpu_torch.models import monodepth as md
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher

    H, W = KITTI["H"], KITTI["W"]
    models = {"small (shipped)": (md.load_default(device="cpu"),
                                  md.load_default(device=dev)),
              "full (seeded)": (md.make_model("full", seed=7),
                                md.make_model("full", seed=7).to(dev))}
    frames = {}
    for s in MONO_SEEDS:
        l, _, gt = render_stereo(H, W, seed=s)
        frames[s] = (np.repeat(l[..., None], 3, -1), gt)
    protocols = {"96x160": (96, 160), "native": None}

    def set_tf32(cudnn: bool, matmul: bool) -> None:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul

    tf32_was = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    for arch, (cpu_model, card_model) in models.items():
        for s, (img, gt) in frames.items():
            for proto, internal in protocols.items():
                what = f"monodepth {arch}, seed {s}, {proto}"
                K.reset_launches()
                d = md.predict_disparity(card_model, img, internal)
                torch.cuda.synchronize()
                check(not any(K.launches.values()), f"{what}: launches none "
                      f"of the port's kernels ({dict(K.launches)})")
                check(d.device == dev and d.shape == (H, W)
                      and bool(torch.isfinite(d).all()),
                      f"{what}: a finite (H, W) map on the card")
                ref = md.predict_disparity(cpu_model, img, internal).numpy()
                err = float(np.abs(d.cpu().numpy() - ref).max()) / W
                check(err <= MONO_TOL, f"{what}: {err} width fractions "
                      f"off the CPU path (> {MONO_TOL})")
                try:
                    set_tf32(True, True)
                    d32 = md.predict_disparity(card_model, img, internal)
                    scope = md.fp32_cudnn
                    md.fp32_cudnn = contextlib.nullcontext
                    try:
                        unscoped = md.predict_disparity(card_model, img,
                                                        internal)
                    finally:
                        md.fp32_cudnn = scope
                finally:
                    set_tf32(*tf32_was)
                err32 = float(np.abs(d32.cpu().numpy() - ref).max()) / W
                check(err32 <= MONO_TOL, f"{what} with TF32 allowed "
                      f"globally: {err32} width fractions off the CPU path")
                err_tf32 = float(np.abs(unscoped.cpu().numpy() - ref).max()
                                 ) / W
                line = (f"[4g] {what}: max |card - CPU| {err} width "
                        f"fractions ({err * W} px); with TF32 allowed "
                        f"globally {err32} (bit-equal to the first: "
                        f"{torch.equal(d32, d)}); the same net with TF32 "
                        f"not scoped off: {err_tf32}")
                if arch.startswith("small"):
                    epe, const = calibrated_epe(d.cpu().numpy(), gt)
                    jepe, jconst = JAX_MONO[s, proto]
                    line += (f"; calibrated EPE {epe} px against the "
                             f"constant's {const} ({epe / const} of it); "
                             f"JAX on a CPU {jepe} against {jconst}")
                    if proto == "96x160":
                        check(epe <= MONO_BAR * const,
                              f"{what}: calibrated EPE {epe} > {MONO_BAR} "
                              f"x the constant's {const}")
                print(line + f" ({card})")
        for proto, internal in protocols.items():
            img_t = torch.from_numpy(frames[MONO_SEEDS[0]][0]).to(dev)
            t = cuda_ms(lambda: md.predict_disparity(card_model, img_t,
                                                     internal), 20, 2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            md.predict_disparity(card_model, img_t, internal)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - before
            print(f"[4g] monodepth {arch} {W}x{H} through {proto}: {t} "
                  f"ms/frame = {1000.0 / t} frames/s (CUDA events, 20 "
                  f"frames); peak device memory of a frame {peak} B "
                  f"({card})")

    cfg = load_settings(None, {"num_disparities": KITTI["D"]})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lp, rp = str(tmp / "left.png"), str(tmp / "right.png")
        image_save(lp, scene_pair[0].astype(np.uint8))
        image_save(rp, scene_pair[1].astype(np.uint8))
        gray = [torch.from_numpy(to_grayscale(image_read(p)).astype(
            np.float32)).to(dev) for p in (lp, rp)]

        def smt(name: str, argv: list, outputs: list) -> dict:
            K.reset_launches()
            t0 = time.perf_counter()
            rc = smt_main(argv + ["--device", str(dev)])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = dict(K.launches)
            check(rc == 0, f"smt-torch {name}: exit code {rc}")
            for out in outputs:
                check(os.path.getsize(out) > 0, f"smt-torch {name}: {out}")
            print(f"[4g] smt-torch {name} ({W}x{H}): exit 0, {wall} ms "
                  f"wall, launches {({k: v for k, v in counts.items() if v})}"
                  f" ({card})")
            return counts

        def direct(matcher) -> tuple[dict, np.ndarray, np.ndarray]:
            K.reset_launches()
            raw, filtered = matcher(*gray)
            torch.cuda.synchronize()
            return (dict(K.launches), raw.cpu().numpy(),
                    filtered.cpu().numpy())

        def same(npy: str, want: np.ndarray, what: str) -> None:
            check(np.array_equal(np.load(npy), want, equal_nan=True),
                  f"smt-torch {what}: its .npy is not bit-equal to the "
                  f"direct call's map")

        out = str(tmp / "census.png")
        counts = smt("match", ["match", "--left", lp, "--right", rp,
                               "--num_disparities", str(KITTI["D"]),
                               "--disp_out", out, "--write_ply",
                               "--ply_out", str(tmp / "census.ply")],
                     [out, out + ".npy", str(tmp / "census.ply")])
        want_counts, raw, filtered = direct(StereoMatcher(cfg, device=dev))
        same(out + ".npy", filtered, "match")
        check(counts == want_counts, f"smt-torch match launches {counts} != "
              f"StereoMatcher's {want_counts}")
        n_pts = len(read_ply(str(tmp / "census.ply"))[0])
        check(n_pts == int(np.isfinite(raw).sum()),
              f"smt-torch match: {n_pts} PLY points")

        out = str(tmp / "mccnn.png")
        counts = smt("match --method mccnn",
                     ["match", "--left", lp, "--right", rp,
                      "--num_disparities", str(KITTI["D"]), "--method",
                      "mccnn", "--disp_out", out], [out, out + ".npy"])
        mc_cfg = cfg.replace(cost="mccnn")
        model = mccnn.from_flax_params(mccnn.load_default_params("fast"),
                                       "fast").to(dev)
        want_counts, _, mc_filtered = direct(StereoMatcher(
            mc_cfg, cost_fn=MCCNNCost(model, mc_cfg), device=dev))
        same(out + ".npy", mc_filtered, "match --method mccnn")
        check(counts == want_counts, f"smt-torch match --method mccnn "
              f"launches {counts} != StereoMatcher's {want_counts}")

        out = str(tmp / "mono.png")
        counts = smt("mono", ["mono", lp, "--output", out],
                     [out, out + ".npy"])
        check(not any(counts.values()), "smt-torch mono: no port kernel")
        same(out + ".npy", md.predict_disparity(
            models["small (shipped)"][1], image_read(lp)).cpu().numpy(),
            "mono")

        disp8 = str(tmp / "disp8.png")
        d8 = np.clip(np.nan_to_num(filtered), 0, 255).astype(np.uint8)
        image_save(disp8, d8)
        smt("reproject", ["reproject", disp8, "--color", lp, "--output",
                          str(tmp / "reproject.ply"), "--min_value", "1"],
            [str(tmp / "reproject.ply")])
        n_pts = len(read_ply(str(tmp / "reproject.ply"))[0])
        check(n_pts == int((d8 > 1).sum()), f"smt-torch reproject: {n_pts} "
              "PLY points")

        vol = census_cost(gray[0], gray[1], cfg).cpu().numpy()
        write_cost_bin(str(tmp / "left.bin"), vol)
        out = str(tmp / "costbin.png")
        smt("costbin", ["costbin", str(tmp / "left.bin"), "--disp-max",
                        str(KITTI["D"]), "--width", str(W), "--height",
                        str(H), "--left", lp, "--disp-out", out, "--ply-out",
                        str(tmp / "costbin.ply")],
            [out, out + ".npy", str(tmp / "costbin.ply")])
        same(out + ".npy", external_volume_to_disparity(
            vol, guide=gray[0], lmbda=80000.0, sigma=1.2, device=dev),
            "costbin")
        del vol

        for i in range(3):    # a frame sequence: the pair, shifted
            for side, p in (("l", lp), ("r", rp)):
                image_save(str(tmp / f"{side}_{i}.png"),
                           np.roll(image_read(p), 7 * i, axis=1))
        out_dir = tmp / "stream"
        smt("stream --stages 1", ["stream", "--left-glob",
                                  str(tmp / "l_*.png"), "--right-glob",
                                  str(tmp / "r_*.png"), "--out-dir",
                                  str(out_dir), "--stages", "1",
                                  "--num_disparities", str(KITTI["D"])],
            [str(out_dir / f"disp_{i:04d}.npy") for i in range(3)])
        matcher = StereoMatcher(cfg, device=dev)
        for i in range(3):
            frame = [torch.from_numpy(to_grayscale(image_read(str(
                tmp / f"{side}_{i}.png"))).astype(np.float32)).to(dev)
                for side in "lr"]
            same(str(out_dir / f"disp_{i:04d}.npy"),
                 matcher(*frame)[1].cpu().numpy(), f"stream frame {i}")


# Training (phase 4h): card against the CPU from the same weights and
# batches, each bar with a control that must fail it.
# * The first step: the loss within TRAIN_RTOL relative, every gradient
#   within TRAIN_GRAD_RTOL of its norm. The MC-CNN tower's gradients are
#   compared on one branch: a pre-activation within rounding of 0 puts a
#   ReLU on either side in two float32 runs, and each such flip moves the
#   first layers' gradients by up to 1e-4 of their norm (the accurate
#   tower's). So the CPU (and float64) recompute the hinge loss with the
#   card's ReLU and hinge signs (``hinge_branch``); the flips are counted.
#   Control: the card's gradients with TF32 in the backward (the step
#   without ``float32_scope``) must miss TRAIN_GRAD_RTOL.
# * Adam on the card against the CPU on the same 3 gradients: parameters
#   within TRAIN_ADAM_TOL; control: a learning rate TRAIN_LR_FAULT off.
# * 3 steps of each trainer: the losses within TRAIN_STEP_RTOL and the
#   displacement of the weights (after - before) within TRAIN_MOVE_RTOL of
#   the CPU's, in norm; bars per model, set from their readings (PERF.md
#   §6, PR 14). Adam's step is about lr * m / sqrt(v) element by element,
#   so a weight whose gradient is at the rounding level of its sum moves by
#   O(lr) either way, and the MC-CNN towers' flips change their gradients
#   at each step: their moves differ by a few percent. Control: the card's
#   trainer with the learning rate TRAIN_LR_FAULT off must miss a bar.
TRAIN_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-5
TRAIN_ADAM_TOL = 1e-5
TRAIN_STEP_RTOL = {"fast": 1e-3, "accurate": 1e-3, "small": 1e-5,
                   "full": 1e-5}
TRAIN_MOVE_RTOL = {"fast": 0.03, "accurate": 0.08, "small": 1e-4,
                   "full": 1e-4}
TRAIN_LR_FAULT = 1.1
TRAIN_TOL = 1e-5
MCCNN_RECIPE = dict(batch=512, lr=2e-3)        # tools/train_mccnn.py
MONO_RECIPE = dict(batch=16, lr=3e-4, steps=6000, alpha=0.05)
MONO_SCENES = 32
MONO_STEPS = 200


def calibration_views(K, dist, n_views=6, cols=7, rows=5, seed=0):
    """A chessboard projected into n synthetic views
    (``tests/test_calibration.py``'s ``_render_views``)."""
    from stereo_match_tpu_torch.core.calibration import \
        chessboard_object_points
    from stereo_match_tpu_torch.core.camera import rodrigues
    rng = np.random.default_rng(seed)
    obj = chessboard_object_points(cols, rows, square=0.03)
    views = []
    k1, k2 = dist
    for _ in range(n_views):
        rvec = rng.normal(scale=0.25, size=3)
        t = np.array([rng.normal(scale=0.05), rng.normal(scale=0.05),
                      0.5 + rng.uniform(0, 0.3)])
        P = (rodrigues(rvec)[:, :2] @ obj.T).T + t
        x, y = P[:, 0] / P[:, 2], P[:, 1] / P[:, 2]
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 ** 2
        views.append(np.stack([K[0, 0] * x * rad + K[0, 2],
                               K[1, 1] * y * rad + K[1, 2]], axis=-1))
    return obj, views


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def flat_params(tree) -> np.ndarray:
    """A flax-layout parameter tree as one float64 vector (sorted keys)."""
    if isinstance(tree, dict):
        return np.concatenate([flat_params(tree[k]) for k in sorted(tree)])
    return np.ravel(np.asarray(tree, np.float64))


def tf32_scope(x):
    """The step without ``float32_scope``: cuDNN's default TF32 (the
    layers' own FP32 scopes close before their backward runs)."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=True)


def hinge_branch(model, batch, signs=None, margin=0.2):
    """``mccnn.hinge_loss`` as ``tower_plain`` computes it, each ReLU's
    and the hinge's active set taken from ``signs`` where given, else
    from the pre-activations: ``(loss, signs)``. With another run's
    signs its gradient is that of the branch the other run took."""
    from stereo_match_tpu_torch.models.optim import float32_scope
    n = batch[0].shape[0]
    h, out = torch.cat(batch)[:, None], []
    with float32_scope(h):
        for i in range(model.num_layers):
            z = torch.nn.functional.conv2d(h, model.weights[i],
                                           model.biases[i], padding=1)
            if i == model.num_layers - 1:
                h = z / torch.sqrt(torch.sum(z * z, 1, keepdim=True)
                                   + 1e-12)
                break
            out.append(z > 0 if signs is None else signs[i])
            h = z * out[-1].to(z.dtype)
        c = h.shape[2] // 2
        fa, fp, fn = h[:, :, c, c].split(n)
        x = margin + torch.sum(fa * fn, -1) - torch.sum(fa * fp, -1)
        out.append(x > 0 if signs is None else signs[-1])
        return torch.mean(x * out[-1].to(x.dtype)), out


def grads_of(model, loss_fn, batch, scope):
    """``(loss, gradients)`` of ``loss_fn(model, *batch)`` under ``scope``,
    the gradients on the host in float64."""
    model.requires_grad_(True)
    with scope(batch[0]):
        loss = loss_fn(model, *batch)
        loss.backward()
    return float(loss.detach()), [q.grad.detach().cpu().double()
                                  for q in model.parameters()]


def grad_err(got, want) -> float:
    """The largest gradient error, each over its reference's norm."""
    return max(float((g - w).abs().max() / w.norm())
               for g, w in zip(got, want))


def phase_4h(dev: torch.device, card: str) -> None:
    """4h. training on the card: MC-CNN and monodepth at their recipes'
    widths, card against CPU, their times; the MC-CNN recipe end to end
    with its held-out check through K8 -> K9 -> K3 -> K4; smt-torch
    train-mccnn then match; Zhang calibration and undistort_image."""
    from stereo_match_tpu_torch.cli.main import main as smt_main
    from stereo_match_tpu_torch.config import DisparityConfig, load_settings
    from stereo_match_tpu_torch.core import calibration as cal
    from stereo_match_tpu_torch.costs import MCCNNCost
    from stereo_match_tpu_torch.data.image import (image_read, image_save,
                                                   to_grayscale)
    from stereo_match_tpu_torch.data.raytrace import render_stereo
    from stereo_match_tpu_torch.data.synthetic import (random_dot_pair,
                                                       rough_scene)
    from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate
    from stereo_match_tpu_torch.models import mccnn
    from stereo_match_tpu_torch.models import monodepth as md
    from stereo_match_tpu_torch.models.optim import (Adam,
                                                     cosine_decay_schedule,
                                                     float32_scope)
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
    from stereo_match_tpu_torch.tools import train_mccnn, train_monodepth

    def rel(a: float, b: float) -> float:
        return abs(a - b) / abs(b)

    def peak_of(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - before

    def host_ms(fn, reps: int = 20) -> float:
        """The host's time to issue ``fn`` (mean of ``reps``, the queue
        drained before each): near the events' ms, the step is
        host-bound."""
        total = 0.0
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total / reps * 1e3

    def host_load() -> str:
        return (f"load average {os.getloadavg()[0]}, "
                f"{len(os.listdir('/proc/self/task'))} threads in the "
                f"process, torch {torch.get_num_threads()} CPU threads")

    def card_vs_cpu(what, arch, make, loss_fn, cpu_batch, card_batch,
                    train, to_flax, lr, branch=False) -> str:
        """The checks of TRAIN_RTOL ... TRAIN_MOVE_RTOL and their controls
        for ``make()``'s model; ``train(model, where, lr)`` runs its
        trainer for 3 steps. Returns a line of the readings."""
        loss_cpu, g_cpu = grads_of(make(), loss_fn, cpu_batch, float32_scope)
        loss_card, g_card = grads_of(make().to(dev), loss_fn, card_batch,
                                     float32_scope)
        _, g_tf32 = grads_of(make().to(dev), loss_fn, card_batch, tf32_scope)
        b64 = [x.double() if x.is_floating_point() else x for x in card_batch]
        ref_loss, note = loss_fn, ""
        if branch:
            with torch.no_grad():
                signs = hinge_branch(make().to(dev), card_batch)[1]
                own = hinge_branch(make().to(dev).double(), b64)[1]
            flips = [int((s != o).sum()) for s, o in zip(signs, own)]
            e_raw = grad_err(g_card, g_cpu)

            def ref_loss(model, *b):
                return hinge_branch(model, b, [x.to(b[0].device)
                                               for x in signs])[0]

            _, g_cpu = grads_of(make(), ref_loss, cpu_batch, float32_scope)
            note = (f"; {flips} signs of the card's ReLUs (by layer) and "
                    f"hinge differ from float64's; on their own branches "
                    f"the card's gradients are {e_raw} of their norm off "
                    f"the CPU's")
        _, g_64 = grads_of(make().to(dev).double(), ref_loss, b64,
                           float32_scope)
        loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
        e, e_tf32 = grad_err(g_card, g_cpu), grad_err(g_tf32, g_cpu)
        check(loss_err <= TRAIN_RTOL, f"{what}: first loss on the card "
              f"{loss_card} vs the CPU's {loss_cpu}")
        check(e <= TRAIN_GRAD_RTOL, f"{what}: gradients on the card {e} of "
              f"their norm off the CPU's")
        check(e_tf32 > TRAIN_GRAD_RTOL, f"{what}: control: a TF32 backward "
              f"is only {e_tf32} off the CPU's gradients")
        # Adam on the same gradients (scaled 1, -0.5, 2), card and CPU
        moved = {}
        for where, scale in (("cpu", 1.0), ("card", 1.0),
                             ("card", TRAIN_LR_FAULT)):
            ps = [q.detach().to("cpu" if where == "cpu" else dev)
                  .requires_grad_(True) for q in make().parameters()]
            opt = Adam(ps, lambda c: scale * (lr(c) if callable(lr) else lr))
            for k in (1.0, -0.5, 2.0):
                for q, g in zip(ps, g_cpu):
                    q.grad = (k * g).float().to(q.device)
                opt.step()
            moved[where, scale] = torch.cat([q.detach().cpu().double()
                                             .ravel() for q in ps])
        adam = max_abs(moved["card", 1.0], moved["cpu", 1.0])
        adam_ctrl = max_abs(moved["card", TRAIN_LR_FAULT], moved["cpu", 1.0])
        check(adam <= TRAIN_ADAM_TOL < adam_ctrl, f"{what}: Adam on the "
              f"same gradients, card vs CPU {adam} (lr x {TRAIN_LR_FAULT}: "
              f"{adam_ctrl})")
        # 3 steps of the trainer, card and CPU; the control on the card
        p0 = flat_params(to_flax(make()))
        runs = {}
        for where, scale in (("cpu", 1.0), (dev, 1.0), (dev, TRAIN_LR_FAULT)):
            model, losses = train(make(), where, lambda c: scale * (
                lr(c) if callable(lr) else lr))
            runs[scale, str(where)] = (flat_params(to_flax(model)) - p0,
                                       losses)
        m_cpu, l_cpu = runs[1.0, "cpu"]

        def errs(move, losses):
            check(len(losses) == len(l_cpu) == 3, f"{what}: {len(losses)} "
                  f"and {len(l_cpu)} steps")
            return (max(abs(c - w) / abs(w) for c, w in zip(losses, l_cpu)),
                    float(np.linalg.norm(move - m_cpu)
                          / np.linalg.norm(m_cpu)))

        step_err, move_err = errs(*runs[1.0, str(dev)])
        step_ctrl, move_ctrl = errs(*runs[TRAIN_LR_FAULT, str(dev)])
        check(step_err <= TRAIN_STEP_RTOL[arch]
              and move_err <= TRAIN_MOVE_RTOL[arch], f"{what}: 3 steps, "
              f"losses {runs[1.0, str(dev)][1]} vs the CPU's {l_cpu}, "
              f"{step_err} relative; the weights' move {move_err} off the "
              f"CPU's")
        check(step_ctrl > TRAIN_STEP_RTOL[arch]
              or move_ctrl > TRAIN_MOVE_RTOL[arch], f"{what}: control: lr x "
              f"{TRAIN_LR_FAULT} passes (losses {step_ctrl}, move "
              f"{move_ctrl})")
        off = int((np.abs(runs[1.0, str(dev)][0] - m_cpu) > TRAIN_TOL).sum())
        return (f"card vs CPU: first loss within {loss_err} relative, "
                f"gradients within {e} of their norm (float64: card "
                f"{grad_err(g_card, g_64)}, CPU {grad_err(g_cpu, g_64)}; "
                f"TF32 backward {e_tf32}, float64 "
                f"{grad_err(g_tf32, g_64)}){note}; Adam on the same "
                f"3 gradients within {adam} (lr x {TRAIN_LR_FAULT}: "
                f"{adam_ctrl}); 3 trainer steps: losses within {step_err} "
                f"(bar {TRAIN_STEP_RTOL[arch]}; lr x {TRAIN_LR_FAULT}: "
                f"{step_ctrl}), the weights' move within {move_err} of the "
                f"CPU's (bar {TRAIN_MOVE_RTOL[arch]}; lr x {TRAIN_LR_FAULT}: "
                f"{move_ctrl}), {off} of {p0.size} weights more than "
                f"{TRAIN_TOL} apart")

    # MC-CNN at the recipe's width: 512 triplets of 16x16 patches, lr 2e-3
    bs = MCCNN_RECIPE["batch"]
    pool = mccnn.make_training_pool(2, seed=1)
    batches = [tuple(torch.from_numpy(x[i * bs:(i + 1) * bs]) for x in pool)
               for i in range(3)]
    card_batches = [tuple(x.to(dev) for x in b) for b in batches]
    for arch in ("fast", "accurate"):
        flax = mccnn.to_flax_params(mccnn.make_model(arch, seed=0))
        parity = card_vs_cpu(
            f"MC-CNN {arch}", arch, lambda: mccnn.from_flax_params(flax, arch),
            mccnn.hinge_loss, batches[0], card_batches[0],
            lambda m, where, lr: mccnn.train(
                m, batches if where == "cpu" else card_batches, lr,
                device=where),
            mccnn.to_flax_params, MCCNN_RECIPE["lr"], branch=True)
        model = mccnn.make_model(arch, seed=0).to(dev).requires_grad_(True)
        step = mccnn.make_train_step(model, Adam(model.parameters(),
                                                 MCCNN_RECIPE["lr"]))
        a, p, n = card_batches[0]
        for _ in range(3):
            step(a, p, n)
        t = cuda_ms(lambda: step(a, p, n), 20, 0)
        t_host = host_ms(lambda: step(a, p, n))
        peak = peak_of(lambda: step(a, p, n))
        model.requires_grad_(False)
        # operations of a step: each layer's forward, its weight gradient
        # and (but the first layer's) its input gradient, 2 * 9 * C_in * F
        # a pixel each, on 3 * bs patches of 16x16; FP32 (no TF32)
        F_, L_ = model.features, model.num_layers
        fwd = [2 * 9 * (1 if i == 0 else F_) * F_ for i in range(L_)]
        ops = 3 * bs * 256 * (2 * sum(fwd) + sum(fwd[1:]))
        b_ms = bound(0.0, ops, "fp32")[0]
        print(f"[4h] MC-CNN {arch} train step ({bs} triplets of 16x16 "
              f"patches, lr {MCCNN_RECIPE['lr']}): {parity}; {t} ms a step "
              f"(CUDA events, 20 steps after 3; the host issues a step in "
              f"{t_host} ms), {bs / t * 1e3} triplets/s "
              f"= {3 * bs / t * 1e3} patches/s; {ops} FP32 operations a "
              f"step, bound {b_ms} ms ({b_ms / t} of it); peak device "
              f"memory of a step {peak} B ({card})")
        del model, step

    # the port's MC-CNN recipe end to end on the card (fast, its defaults)
    t0 = time.perf_counter()
    model, losses, n_pool = train_mccnn.train_recipe("fast", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    init = mccnn.make_model("fast", seed=0).to(dev)
    gt = rough_scene(96, 160, 999, 2, 24)
    clean = random_dot_pair(96, 160, gt, blur=1.0, seed=555)
    imgs = torch.stack([mccnn.normalize_image(torch.from_numpy(x).to(dev))
                        for x in clean])
    K.reset_launches()
    feats = model(imgs)
    torch.cuda.synchronize()
    check(K.launches["mccnn_conv3x3"] == model.num_layers,
          f"the trained tower launched K8 {K.launches['mccnn_conv3x3']}x")
    plain = mccnn.tower_plain(model, imgs)
    err = max_abs(feats, plain)
    if err > K8_TOL:
        ref = mccnn.tower_plain(mccnn.from_flax_params(
            mccnn.to_flax_params(model), "fast").to(dev).double(),
            imgs.double())
        e_k8, e_cudnn = max_abs(feats, ref), max_abs(plain, ref)
        check(e_k8 <= K8_F64_RATIO * e_cudnn, f"K8 on the trained weights: "
              f"{err} off the F.conv2d chain; against float64 {e_k8} > "
              f"{K8_F64_RATIO} x cuDNN's {e_cudnn}")
    stale = max_abs(feats, mccnn.tower_plain(init, imgs))
    check(stale > 100 * max(err, K8_TOL), f"K8's features are within "
          f"{stale} of the initial weights' tower: stale copies")
    cfg_c = DisparityConfig(num_disparities=32, cost="census",
                            uniqueness_ratio=15, disp12_max_diff=1,
                            wls=False)
    cfg_m = cfg_c.replace(cost="mccnn")
    m_census = StereoMatcher(cfg_c, device=dev)
    m_mccnn = StereoMatcher(cfg_m, cost_fn=MCCNNCost(model, cfg_m),
                            device=dev)
    bars = {}
    for noise in (0.0, 25.0):
        l, r = random_dot_pair(96, 160, gt, blur=1.0, seed=555, noise=noise)
        l, r = (torch.from_numpy(x).to(dev) for x in (l, r))
        dc, _ = m_census(l, r)
        K.reset_launches()
        dm, _ = m_mccnn(l, r)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        want = {"mccnn_conv3x3": 4, "mccnn_volume": 1, "sgm_path_scan": 8,
                "wta_lr": 1}
        check({k: v for k, v in counts.items() if v} == want,
              f"trained MC-CNN matcher launches {counts}")
        bars[noise] = (float(bad_pixel_rate(dc, gt, 3.0, 0.0)),
                       float(bad_pixel_rate(dm, gt, 3.0, 0.0)))
    (clean_c, clean_m), (noisy_c, noisy_m) = bars[0.0], bars[25.0]
    check(clean_m <= clean_c + 0.03, f"port-trained fast tower on the clean "
          f"held-out scene: bad-3px {clean_m} vs census {clean_c}")
    check(noisy_m < noisy_c and noisy_m < 0.25, f"port-trained fast tower "
          f"at noise 25: bad-3px {noisy_m} vs census {noisy_c}")
    report, oor = train_mccnn.held_out(model, dev)
    print(f"[4h] MC-CNN recipe (fast, 27 scenes, 8 epochs, {len(losses)} "
          f"steps on a pool of {n_pool}): {wall * 1e3} ms host wall, pool "
          f"made on the host; hinge loss {losses[0]} -> {losses[-1]}; K8 on "
          f"the trained weights within {err} of the F.conv2d chain, "
          f"{stale} off the initial weights' tower; held-out scene (tests/"
          f"test_mccnn.py:153-185) bad-3px clean {clean_m} vs census "
          f"{clean_c}, noise 25 {noisy_m} vs census {noisy_c}; launches of "
          f"the matcher {want}; the tool's held-out report {report}, out of "
          f"renderer {oor} ({card})")
    del model, init, m_mccnn

    # monodepth at the recipe's width: 96x160, batch 16, lr 3e-4 cosine
    scenes = [train_monodepth.scene_native(s, "raytrace")
              for s in range(MONO_SCENES)]
    lefts = np.stack([x[0] for x in scenes])
    rights = np.stack([x[1] for x in scenes])
    K.reset_launches()
    targets, valids = train_monodepth.stereo_labels(lefts, rights, dev)
    torch.cuda.synchronize()
    label_counts = {k: v for k, v in K.launches.items() if v}
    n = MONO_SCENES
    check(label_counts == {"census_words": n, "census_volume": n,
                           "sgm_path_scan": 8 * n, "wta_lr": n},
          f"monodepth labels: launches {label_counts}")
    sched = cosine_decay_schedule(MONO_RECIPE["lr"], MONO_RECIPE["steps"],
                                  MONO_RECIPE["alpha"])
    rng = np.random.default_rng(0)
    picks = rng.choice(n, (MONO_STEPS, MONO_RECIPE["batch"]))
    flips = rng.uniform(size=picks.shape) < 0.5
    cpu_labels = (targets.cpu(), valids.cpu())
    cpu_batch = (md._nchw(lefts, "cpu")[picks[0]], targets.cpu()[picks[0]],
                 valids.cpu()[picks[0]])
    card_batch = tuple(x.to(dev) for x in cpu_batch)
    for arch in ("small", "full"):
        flax = md.to_flax_params(md.make_model(arch, seed=0))
        parity = card_vs_cpu(
            f"monodepth {arch}", arch, lambda: md.from_flax_params(flax),
            md.distillation_loss, cpu_batch, card_batch,
            lambda m, where, lr: md.train_distilled_on_device(
                m, lefts, *(cpu_labels if where == "cpu"
                            else (targets, valids)), picks[:3], lr,
                chunk=3, flips=flips[:3], device=where),
            md.to_flax_params, sched)
        model = md.make_model(arch, seed=0).to(dev).requires_grad_(True)
        step = md.make_train_step(model, Adam(model.parameters(), sched),
                                  md.distillation_loss)
        idx = torch.as_tensor(picks[0], device=dev)
        batch = (md._nchw(lefts, dev)[idx], targets[idx], valids[idx])
        for _ in range(3):
            step(*batch)
        t = cuda_ms(lambda: step(*batch), 20, 0)
        t_host = host_ms(lambda: step(*batch))
        peak = peak_of(lambda: step(*batch))
        print(f"[4h] monodepth {arch} distillation step (batch "
              f"{MONO_RECIPE['batch']} at 96x160, lr {MONO_RECIPE['lr']} "
              f"cosine): {parity}; {t} ms a step (CUDA events, 20 steps "
              f"after 3; the host issues a step in {t_host} ms; "
              f"{host_load()}), {MONO_RECIPE['batch'] / t * 1e3} images/s; "
              f"peak device memory of a step {peak} B ({card})")
        del model, step
    t0 = time.perf_counter()
    model, losses = md.train_distilled_on_device(
        md.make_model("small", seed=0), lefts, targets, valids, picks, sched,
        flips=flips, device=dev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    check(len(losses) == MONO_STEPS and last < first, f"monodepth small: "
          f"{len(losses)} steps, mean loss of the first 20 {first}, of the "
          f"last 20 {last}")
    print(f"[4h] monodepth small, {MONO_STEPS} distillation steps on "
          f"{MONO_SCENES} ray-traced scenes labelled by the census matcher "
          f"(launches {label_counts}): mean loss of the first 20 steps "
          f"{first}, of the last 20 {last}; {wall} ms host wall "
          f"({wall / MONO_STEPS} ms a step) ({card})")
    del model

    # smt-torch train-mccnn, then match --method mccnn on its checkpoint
    H, W = KITTI["H"], KITTI["W"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        left, right, gt = render_stereo(H, W, seed=3)
        lp, rp, gp = (str(tmp / f) for f in ("l.png", "r.png", "gt.npy"))
        image_save(lp, np.clip(left, 0, 255).astype(np.uint8))
        image_save(rp, np.clip(right, 0, 255).astype(np.uint8))
        np.save(gp, gt)
        ckpt = tmp / "mccnn_ckpt.npz"
        walls = {}
        for name, argv in (
                ("train-mccnn", ["train-mccnn", "--left", lp, "--right", rp,
                                 "--gt", gp, "--output", str(ckpt)]),
                ("match --method mccnn --mccnn_checkpoint",
                 ["match", "--left", lp, "--right", rp, "--method", "mccnn",
                  "--mccnn_checkpoint", str(ckpt), "--num_disparities",
                  str(KITTI["D"]), "--disp_out", str(tmp / "d.png")])):
            K.reset_launches()
            t0 = time.perf_counter()
            rc = smt_main(argv + ["--device", str(dev)])
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3
            check(rc == 0, f"smt-torch {name}: exit code {rc}")
        counts = dict(K.launches)
        check(ckpt.stat().st_size > 0, "smt-torch train-mccnn wrote nothing")
        cfg = load_settings(None, {"num_disparities": KITTI["D"]}).replace(
            cost="mccnn")
        trained = mccnn.from_flax_params(mccnn.load_params_npz(ckpt),
                                         "fast").to(dev)
        gray = [torch.from_numpy(to_grayscale(image_read(x)).astype(
            np.float32)).to(dev) for x in (lp, rp)]
        K.reset_launches()
        _, want_map = StereoMatcher(cfg, cost_fn=MCCNNCost(trained, cfg),
                                    device=dev)(*gray)
        torch.cuda.synchronize()
        check(counts == dict(K.launches), f"smt-torch match launches "
              f"{counts} != StereoMatcher's {dict(K.launches)}")
        check(np.array_equal(np.load(str(tmp / "d.png.npy")),
                             want_map.cpu().numpy(), equal_nan=True),
              "smt-torch match on the trained checkpoint: its .npy is not "
              "bit-equal to the direct call's map")
    print(f"[4h] smt-torch on a ray-traced {W}x{H} pair: train-mccnn "
          f"{walls['train-mccnn']} ms wall (4096 patches of 12x12, 4 "
          f"epochs of 256), match --method mccnn on its checkpoint "
          f"{walls['match --method mccnn --mccnn_checkpoint']} ms wall, "
          f"launches {({k: v for k, v in counts.items() if v})} ({card})")

    # Zhang calibration (host float64), undistort_image on the card
    K_true = np.array([[600.0, 0, 310], [0, 600.0, 230], [0, 0, 1]])
    obj, views = calibration_views(K_true, (-0.15, 0.05), n_views=8, seed=3)
    t0 = time.perf_counter()
    res = cal.calibrate_camera(obj, views)
    t_cal = (time.perf_counter() - t0) * 1e3
    check(res.rms < 0.05 and abs(res.dist[0] + 0.15) <= 0.02
          and abs(res.K[0, 0] / 600.0 - 1) <= 5e-3,
          f"calibrate_camera: K {res.K.tolist()}, dist {res.dist}, rms "
          f"{res.rms}")
    img = render_stereo(H, W, seed=5)[0]
    got = cal.undistort_image(img, res.K, res.dist, device=dev)
    want_img = cal.undistort_image(img, res.K, res.dist, device="cpu")
    u_err = max_abs(got.cpu(), want_img)
    check(got.device == dev and got.shape == (H, W) and u_err <= 1e-3,
          f"undistort_image on the card: {u_err} gray levels off the CPU's")
    t_und = cuda_ms(lambda: cal.undistort_image(img, res.K, res.dist,
                                                device=dev), 10)
    print(f"[4h] calibrate_camera (8 views of 7x5, k1 -0.15): {t_cal} ms "
          f"host, K {res.K.tolist()}, dist {res.dist.tolist()}, rms "
          f"{res.rms} px; undistort_image {W}x{H} on the card {t_und} ms "
          f"(CUDA events, host upload and maps included), {u_err} gray "
          f"levels off the CPU's ({card})")


SHARDS = 4          # phase 4i: the device list is cuda:{k % cards}, k < 4
MULTIHOST_FRAMES = 8
UNPADDED_H = 384    # KITTI's width at a height every 4i unit divides


# The mesh trainer (phase 4i) against the single-device trainer, both on
# the card in full float32, from the same weights and batches; bars set
# from their readings (PERF.md §6, PR 15).
# * The first step: the loss within MESH_LOSS_RTOL relative, every gradient
#   (the slices joined) within MESH_GRAD_RTOL of its norm, the single-device
#   gradient taken on the mesh's branch (``hinge_branch`` with the ReLU and
#   hinge signs of the mesh's forward, ``mesh_branch``; the flips are
#   counted). Control: the mesh step with TF32 in the backward (without
#   ``float32_scope``) must miss MESH_GRAD_RTOL.
# * 3 steps: the losses within MESH_STEP_RTOL and the weights' move within
#   MESH_MOVE_RTOL of the single-device trainer's on the card and of the
#   CPU trainer's. From first gradients within 2e-6 of each other, Adam
#   moves a weight whose gradient is at the rounding level of its sum by
#   O(lr) either way, so two float32 runs that sum in other orders drift
#   apart by up to 1e-2 of the move; the single-device trainer on the
#   batches permuted (the same loss) is printed beside the mesh as that
#   floor. Control: the mesh trainer with the learning rate TRAIN_LR_FAULT
#   off must miss a bar.
MESH_LOSS_RTOL = 1e-6
MESH_GRAD_RTOL = 1e-5
MESH_STEP_RTOL = 5e-4
MESH_MOVE_RTOL = 0.02


def spread(n: int) -> list[torch.device]:
    """The device list cuda:{k % cards}, k < n: n distinct cards where that
    many are visible, else the visible cards repeated (phases 4e and 4i)."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", k % cards) for k in range(n)]


def wall_ms(fn, reps: int, devices) -> float:
    """Mean milliseconds of ``fn()`` by the host's clock, every card of
    ``devices`` synchronised before and after (the time of work spread
    over several cards)."""
    def sync():
        for d in devices:
            torch.cuda.synchronize(d)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


@contextlib.contextmanager
def plain_kernels(module, *names):
    """``module``'s calls of the kernel wrappers ``names`` run their plain
    versions (same arguments, no launch)."""
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    saved = {name: getattr(module, name) for name in names}
    try:
        for name in names:
            setattr(module, name, getattr(K, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def bit_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Check two disparity maps for the same NaN mask and equal values
    (``b`` brought to ``a``'s device); returns the max |diff| (0.0 once
    both checks pass)."""
    b = b.to(a.device)
    check(torch.equal(torch.isnan(a), torch.isnan(b)),
          f"{what}: NaN masks differ")
    check(torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)),
          f"{what}: values differ")
    return float((a - b).abs().nan_to_num(0.0).max())


def kitti_frame(i: int, H: int | None = None):
    """The i-th KITTI-width frame of phase 4i (i = 0: the seed-1 scene), of
    KITTI's height unless ``H`` is given."""
    from stereo_match_tpu_torch.data.synthetic import (random_dot_pair,
                                                       slanted_scene)
    H = KITTI["H"] if H is None else H
    gt = slanted_scene(H, KITTI["W"], KITTI["d_min"], KITTI["d_max"] - i)
    left, right = random_dot_pair(H, KITTI["W"], gt, blur=1.0,
                                  seed=KITTI["seed"] + i)
    return left, right, gt


def mesh_branch(tower, batch, margin=0.2) -> list[torch.Tensor]:
    """The ReLU and hinge signs of the mesh trainer's forward on ``batch``
    as ``ShardedTower.features`` computes it (data row r takes triplets
    [r N / R, (r + 1) N / R), each "model" device its output channels of
    every layer), in ``hinge_branch``'s order, on the mesh's first
    device."""
    from stereo_match_tpu_torch.ops.cuda_kernels import fp32_cudnn
    N, rows = batch[0].shape[0], tower.mesh.shape["data"]
    per, dev0, signs = N // rows, tower.mesh.devices[0, 0], None
    with torch.no_grad():
        for r in range(rows):
            part = torch.arange(r * per, (r + 1) * per)
            devs = list(tower.mesh.devices[r])
            h = torch.cat([x[part.to(x.device)] for x in batch])[:, None]
            out = []
            for i in range(tower.num_layers):
                z = []
                for m, d in enumerate(devs):
                    with fp32_cudnn():
                        z.append(torch.nn.functional.conv2d(
                            h.to(d), *tower.slices[r][m][i], padding=1)
                            .to(devs[0]))
                z = torch.cat(z, 1)
                if i == tower.num_layers - 1:
                    h = z / torch.sqrt(torch.sum(z * z, 1, keepdim=True)
                                       + 1e-12)
                    break
                out.append(z > 0)
                h = torch.relu(z)
            c = h.shape[2] // 2
            fa, fp, fn = h[:, :, c, c].split(per)
            out.append(margin + torch.sum(fa * fn, -1)
                       - torch.sum(fa * fp, -1) > 0)
            if signs is None:
                signs = [torch.empty((3 * N,) + o.shape[1:], dtype=torch.bool,
                                     device=dev0) for o in out[:-1]]
                signs.append(torch.empty(N, dtype=torch.bool, device=dev0))
            at = torch.cat([part + k * N for k in range(3)]).to(dev0)
            for sign, o in zip(signs[:-1], out[:-1]):
                sign[at] = o.to(dev0)
            signs[-1][part.to(dev0)] = out[-1].to(dev0)
    return signs


def multihost_rank(argv: list[str]) -> int:
    """One rank of phase 4i's two-process run: ``--multihost-rank RANK
    PORT BACKEND OUT``. Joins the group, loads its own half of the
    frames, matches them on its card, gathers every rank's rows to rank 0,
    which writes them to ``OUT``."""
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from stereo_match_tpu_torch.config import DisparityConfig
    from stereo_match_tpu_torch.parallel import (batched_matcher_multihost,
                                                 initialize_multihost,
                                                 load_host_sharded,
                                                 make_host_mesh)
    rank, port, backend, out = int(argv[0]), argv[1], argv[2], argv[3]
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend)
    try:
        mesh = make_host_mesh()        # this rank's visible card
        check(mesh.shape == {"host": 2, "chip": 1}, f"mesh {mesh.shape}")
        loaded = {}

        def load(i, view):
            if i not in loaded:
                loaded[i] = kitti_frame(i)
            return loaded[i][view]

        shape = (KITTI["H"], KITTI["W"])
        n = MULTIHOST_FRAMES
        lb = load_host_sharded(lambda i: load(i, 0), n, mesh, shape)
        rb = load_host_sharded(lambda i: load(i, 1), n, mesh, shape)
        mine = list(range(rank * n // 2, (rank + 1) * n // 2))
        check(sorted(loaded) == mine, f"rank {rank} loaded {sorted(loaded)}")
        cfg = DisparityConfig(num_disparities=KITTI["D"], cost="census",
                              uniqueness_ratio=15, disp12_max_diff=1,
                              wls=False, speckle_window_size=0)
        fn = batched_matcher_multihost(cfg, mesh)
        fn(lb, rb)
        dev = lb.shards[0].device
        ms = wall_ms(lambda: fn(lb, rb), 3, [dev])
        local = fn(lb, rb)[0].local()
        if backend == "gloo":          # gloo gathers host tensors
            local = local.cpu()
        parts = [torch.empty_like(local) for _ in range(2)]
        dist.all_gather(parts, local)
        if rank == 0:
            np.save(out, torch.cat(parts).cpu().numpy())
        check("jax" not in sys.modules, "the rank imported jax")
        print(f"[4i] rank {rank} ({backend}, {dev}, "
              f"{torch.cuda.get_device_name(dev)}): matched frames {mine} in "
              f"{ms} ms ({len(mine) / ms * 1e3} frames/s), gathered "
              f"{tuple(torch.cat(parts).shape)}")
    finally:
        dist.destroy_process_group()
    return 0


def phase_4i(dev: torch.device, card: str) -> None:
    """4i. multi-device: the D-sharded matcher, the sharded WTA, the
    multihost matcher in one process and in two, and the MC-CNN mesh
    trainer, on the device list cuda:{k % cards}, k < SHARDS."""
    from stereo_match_tpu_torch.config import DisparityConfig
    from stereo_match_tpu_torch.costs import census_cost
    from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate, density
    from stereo_match_tpu_torch.models import mccnn
    from stereo_match_tpu_torch.models.optim import Adam, float32_scope
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    from stereo_match_tpu_torch.parallel import dsharding
    from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
    from stereo_match_tpu_torch.parallel import (batched_matcher_multihost,
                                                 load_host_sharded,
                                                 make_host_mesh)
    from stereo_match_tpu_torch.parallel.mesh import named_mesh
    from stereo_match_tpu_torch.parallel.tiling import sgm_aggregate_blocks
    from stereo_match_tpu_torch.pipeline.stereo import (StereoMatcher,
                                                        _match_core)

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = spread(SHARDS)
    cards = sorted(set(devices), key=lambda d: d.index)
    where = f"on {[str(d) for d in devices]}"
    print(f"[4i] device list {[str(d) for d in devices]}: {n_cards} card(s) "
          f"visible ({card})")

    def counts_of(fn):
        K.reset_launches()
        out = fn()
        for d in cards:
            torch.cuda.synchronize(d)
        return out, {k: v for k, v in K.launches.items() if v}

    def peaks_of(fn):
        """(peak bytes above the start on each card of ``cards``)."""
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        before = [torch.cuda.memory_allocated(d) for d in cards]
        fn()
        for d in cards:
            torch.cuda.synchronize(d)
        return [torch.cuda.max_memory_allocated(d) - b
                for d, b in zip(cards, before)]

    mesh = dsharding.make_disp_mesh(devices=devices)
    headline = DisparityConfig(num_disparities=KITTI["D"], cost="census",
                               uniqueness_ratio=15, disp12_max_diff=1,
                               wls=False, speckle_window_size=0)
    wta_args = (headline.min_disparity, headline.uniqueness_ratio,
                headline.disp12_max_diff, headline.subpixel)
    left_np, right_np, gt = kitti_frame(0)
    left, right = (torch.from_numpy(x).to(dev, torch.float32)
                   for x in (left_np, right_np))
    left_u, right_u, _ = kitti_frame(0, UNPADDED_H)
    left_u, right_u = (torch.from_numpy(x).to(dev, torch.float32)
                       for x in (left_u, right_u))
    D, W = KITTI["D"], KITTI["W"]
    D_loc = D // SHARDS

    # each kernel at the shard shapes, against its plain version
    for dtype in ("float32", "int16"):
        k2 = [(dsharding._local_census_volume(left_u, right_u, D_loc, k * D_loc,
                                              (5, 5), 0, dtype),
               K.census_volume_plain(*K.census_words_plain(
                   torch.stack([left_u, right_u]))[:, 0], D_loc, k * D_loc,
                   dtype)) for k in range(SHARDS)]
        for k, (got, want) in enumerate(k2):
            check(torch.equal(got, want), f"K2 {dtype} shard {k} (planes "
                  f"{k * D_loc}..{(k + 1) * D_loc - 1}) bit-equal")
        rows = UNPADDED_H // SHARDS
        blocks = [torch.cat([s[:, j * rows:(j + 1) * rows] for s, _ in k2])
                  for j in range(SHARDS)]
        for mode in ("exact", "halo"):
            got = sgm_aggregate_blocks(blocks, headline.P1, headline.P2, 8,
                                       mode, 48)
            want = sgm_aggregate_blocks(blocks, headline.P1, headline.P2, 8,
                                        mode, 48, K.sgm_path_scan_plain)
            for j, (g, w) in enumerate(zip(got, want)):
                check(torch.equal(g, w), f"K3 {dtype} {mode} block {j} "
                      f"({rows} rows) bit-equal")
                bit_equal(K.wta_lr(g, *wta_args)[0],
                          K.wta_lr_plain(g, *wta_args)[0],
                          f"K4 {dtype} {mode} block {j}")
        del k2, blocks, got, want
    imgs_u = torch.stack([left_u, right_u]).contiguous()
    words_u = K.census_words(imgs_u)
    slice_u = K.census_volume(words_u[0], words_u[1], D_loc, D_loc)
    block = K.census_volume(words_u[0, :, :UNPADDED_H // SHARDS],
                            words_u[1, :, :UNPADDED_H // SHARDS], D)
    whole = K.census_volume(words_u[0], words_u[1], D)
    scratch = torch.empty_like(block)

    def block_scans():
        for i, (dy, dx) in enumerate(PATH_DIRECTIONS_8):
            K.sgm_path_scan(block, scratch, dy, dx, headline.P1,
                            headline.P2, i > 0)

    shard_ms = {"K1 both views, whole frame (a shard's)":
                cuda_ms(lambda: K.census_words(imgs_u), 20),
                f"K2 {D_loc} planes at min_d {D_loc}":
                cuda_ms(lambda: K.census_volume(words_u[0], words_u[1],
                                                D_loc, D_loc), 20),
                f"K2 {D} planes, whole frame":
                cuda_ms(lambda: K.census_volume(words_u[0], words_u[1], D),
                        20),
                f"K3 8 directions, {UNPADDED_H // SHARDS}-row block":
                cuda_ms(block_scans, 10),
                f"K4 wta_lr, {UNPADDED_H // SHARDS}-row block":
                cuda_ms(lambda: K.wta_lr(block, *wta_args), 20),
                "K4 wta_lr, whole frame":
                cuda_ms(lambda: K.wta_lr(whole, *wta_args), 20)}
    print(f"[timing] kernels at 4i's shard shapes, float32, {W}x"
          f"{UNPADDED_H} D={D} on {dev}: "
          f"{'; '.join(f'{k} {v} ms' for k, v in shard_ms.items())} "
          f"({card})")
    del words_u, slice_u, block, whole, scratch
    print(f"[4i] at the shard shapes ({W}x{UNPADDED_H}, the padded height "
          f"of either dtype): K1 and K2 over {D_loc}-plane slices at min_d "
          f"0, {D_loc}, {2 * D_loc}, {3 * D_loc}, K3 over "
          f"{UNPADDED_H // SHARDS}-row "
          f"blocks with carries (exact) and halo 48, K4 a block: bit-equal "
          f"to their plain versions, float32 and int16 ({card})")

    # the D-sharded matcher at KITTI, 4 shards
    want_counts = {"census_words": SHARDS, "census_volume": SHARDS,
                   "sgm_path_scan": 8 * SHARDS, "wta_lr": SHARDS}
    core_ms = cuda_ms(lambda: _match_core(left, right, headline), 10)
    core_peak = peaks_of(lambda: _match_core(left, right, headline))
    core = _match_core(left, right, headline)[0]
    timings = {}
    for dtype in ("float32", "int16"):
        cfg = headline.replace(dtype=dtype)
        for mode in ("exact", "halo"):
            unit = SHARDS * ((8 if dtype == "float32" else 16)
                             if mode == "exact" else 1)
            Hp = -(-KITTI["H"] // unit) * unit
            def run(lv=left, rv=right, cfg=cfg, mode=mode):
                return dsharding.match_dsharded(lv, rv, cfg, mesh, mode, 48)
            out, c = counts_of(run)
            check(c == want_counts, f"match_dsharded {dtype} {mode} "
                  f"launches {c} != {want_counts}")
            with plain_kernels(dsharding, "census_words", "census_volume",
                                "sgm_path_scan", "wta_lr"):
                plain, c_plain = counts_of(run)
            check(not c_plain, f"the plain path launched {c_plain}")
            bit_equal(out, plain, f"match_dsharded {dtype} {mode} vs its "
                      f"plain path")
            bad = float(bad_pixel_rate(out.cpu().numpy(), gt, 3.0, 0.0))
            dens = float(density(out.cpu().numpy()))
            check(bad < 0.05 and dens > 0.8, f"match_dsharded {dtype} "
                  f"{mode}: bad-3px {bad}, density {dens}")
            same = (out.nan_to_num(-1.0) == core.nan_to_num(-1.0))
            agree = float(same.float().mean())
            line = ""
            if mode == "exact":
                bit_equal(run(left_u, right_u), StereoMatcher(cfg, device=dev)(
                    left_u, right_u)[0], f"match_dsharded {dtype} at {UNPADDED_H} rows vs "
                    f"StereoMatcher")
                line = (f"; at {W}x{UNPADDED_H} (no padding) bit-equal to "
                        f"StereoMatcher")
            peaks = peaks_of(run)
            timings[dtype, mode] = wall_ms(run, 10, cards)
            print(f"[4i] match_dsharded {dtype} {mode} {label(KITTI)} over "
                  f"{SHARDS} shards {where}: launches {c}; bit-equal to its "
                  f"plain path on the card{line}; bad-3px {bad}, density "
                  f"{dens}; equal to _match_core on {agree} of the pixels "
                  f"(rows padded to {Hp}); "
                  f"peak memory by card {dict(zip(map(str, cards), peaks))} "
                  f"B, _match_core's {core_peak[cards.index(dev)]} B "
                  f"({card})")
    del out, plain
    for (dtype, mode), t in timings.items():
        print(f"[timing] match_dsharded {dtype} {mode} {label(KITTI)} "
              f"{where}: {t} ms/frame (host clock, every card synchronised, "
              f"10 frames after 1); _match_core float32 on {dev} {core_ms} "
              f"ms/frame (CUDA events) ({card})")

    # the sharded WTA on the headline total
    vol = census_cost(left, right, headline)
    total = K.aggregate_paths(vol, headline.P1, headline.P2, 8)
    del vol
    want = K.wta_lr(total, *wta_args)[0]
    got, c = counts_of(lambda: dsharding.wta_dsharded(total, mesh,
                                                       headline))
    check(not c, f"wta_dsharded launched {c}: it is plain torch")
    bit_equal(got, want, "wta_dsharded vs K4 wta_lr")
    t_wta = wall_ms(lambda: dsharding.wta_dsharded(total, mesh, headline),
                    5, cards)
    t_k4 = cuda_ms(lambda: K.wta_lr(total, *wta_args), 20)
    print(f"[4i] wta_dsharded {label(KITTI)} over {SHARDS} shards {where}: "
          f"bit-equal to K4 wta_lr's map, no kernel launched ({card})")
    print(f"[timing] wta_dsharded {label(KITTI)} {where}: {t_wta} ms (plain "
          f"torch pmin rounds); K4 wta_lr {t_k4} ms ({card})")
    del total, got, want

    # the multihost matcher: 2 simulated hosts x 2 chips, then 2 processes
    frames = [kitti_frame(i) for i in range(MULTIHOST_FRAMES)]
    host_mesh = make_host_mesh(n_hosts=2, devices=devices)
    shape = (KITTI["H"], KITTI["W"])
    lb = load_host_sharded(lambda i: frames[i][0], MULTIHOST_FRAMES,
                           host_mesh, shape)
    rb = load_host_sharded(lambda i: frames[i][1], MULTIHOST_FRAMES,
                           host_mesh, shape)
    fn = batched_matcher_multihost(headline, host_mesh)
    (raw, _), c = counts_of(lambda: fn(lb, rb))
    n = MULTIHOST_FRAMES
    check(c == {"census_words": n, "census_volume": n,
                "sgm_path_scan": 8 * n, "wta_lr": n},
          f"multihost matcher launches {c}")
    single = raw.local(dev)
    for i, (l, r, _) in enumerate(frames):
        bit_equal(single[i], _match_core(torch.from_numpy(l).to(dev),
                                         torch.from_numpy(r).to(dev),
                                         headline)[0],
                  f"multihost frame {i} vs _match_core")
    t_mh = wall_ms(lambda: fn(lb, rb), 3, cards)
    print(f"[4i] batched_matcher_multihost, 2 simulated hosts x 2 chips "
          f"{where}, {n} frames {label(KITTI)}: each bit-equal to "
          f"_match_core; launches {c} ({card})")
    print(f"[timing] batched_matcher_multihost 2 x 2 {where}: {t_mh} ms for "
          f"{n} frames = {n / t_mh * 1e3} frames/s (host clock) ({card})")

    backend = "nccl" if n_cards >= 2 else "gloo"
    if backend == "gloo":
        print(f"[4i] multihost 2 processes: gloo, both ranks on {dev}: one "
              f"card is visible, so the NCCL leg (a rank a card) is not run")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "gathered.npy")
        procs = []
        for rank in range(2):
            env = dict(os.environ)
            if backend == "nccl":
                env["CUDA_VISIBLE_DEVICES"] = str(rank)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--multihost-rank", str(rank), str(port), backend,
                 out_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, text=True))
        t0 = time.perf_counter()
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        for rank, (p, text) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"multihost rank {rank} exited "
                  f"{p.returncode}:\n{text[-4000:]}")
            for line in text.splitlines():
                if line.startswith("[4i] rank"):
                    print(f"{line} ({card})")
        gathered = torch.from_numpy(np.load(out_path)).to(dev)
    bit_equal(gathered, single, f"2 processes ({backend}) vs the "
              f"single-process multihost run")
    print(f"[4i] batched_matcher_multihost in 2 processes ({backend}, "
          f"tcp://127.0.0.1): each rank loaded and matched its own "
          f"{n // 2} frames; the gathered rows bit-equal to the single-"
          f"process run; {wall} s wall for both ranks, start-up included "
          f"({card})")
    del lb, rb, raw, single, gathered

    # the MC-CNN mesh trainer: fast at the recipe's width, (data 2, model 2)
    train_mesh = named_mesh(devices, (2, 2), ("data", "model"))
    bs, lr = MCCNN_RECIPE["batch"], MCCNN_RECIPE["lr"]
    pool = mccnn.make_training_pool(2, seed=1)
    batches = [tuple(torch.from_numpy(x[i * bs:(i + 1) * bs]).to(dev)
                     for x in pool) for i in range(3)]
    flax = mccnn.to_flax_params(mccnn.make_model("fast", seed=0))

    def fresh():
        return mccnn.from_flax_params(flax, "fast")

    def mesh_first_step(scope):
        """(loss, gradients in the order of ``fresh().parameters()``,
        tower) of one mesh step with ``scope`` in ``float32_scope``'s place
        (SGD at lr 0: the weights stay)."""
        tower = mccnn.shard_params(fresh(), train_mesh)
        saved, mccnn.float32_scope = mccnn.float32_scope, scope
        try:
            loss = float(mccnn.make_train_step(tower, torch.optim.SGD(
                tower.parameters(), lr=0.0), train_mesh)(*batches[0]))
        finally:
            mccnn.float32_scope = saved
        return loss, [torch.cat([col[i][k].grad.to(dev)
                                 for col in tower.slices[0]]).cpu().double()
                      for k in (0, 1) for i in range(tower.num_layers)], tower

    loss_mesh, g_mesh, tower = mesh_first_step(float32_scope)
    signs = mesh_branch(tower, batches[0])
    loss_one, g_one = grads_of(fresh().to(dev), mccnn.hinge_loss,
                               batches[0], float32_scope)
    with torch.no_grad():
        own = hinge_branch(fresh().to(dev), batches[0])[1]
    flips = [int((s != o).sum()) for s, o in zip(signs, own)]
    _, g_ref = grads_of(fresh().to(dev), lambda m, *b: hinge_branch(
        m, b, signs)[0], batches[0], float32_scope)
    g_tf32 = mesh_first_step(tf32_scope)[1]
    del tower, signs, own
    loss_err = abs(loss_mesh - loss_one) / abs(loss_one)
    e, e_tf32 = grad_err(g_mesh, g_ref), grad_err(g_tf32, g_ref)
    check(loss_err <= MESH_LOSS_RTOL, f"mesh trainer: first loss "
          f"{loss_mesh} vs the single-device step's {loss_one}")
    check(e <= MESH_GRAD_RTOL, f"mesh trainer: first gradients {e} of "
          f"their norm off the single-device step's")
    check(e_tf32 > MESH_GRAD_RTOL, f"mesh trainer control: a TF32 backward "
          f"is only {e_tf32} off the single-device gradients")
    # 3 steps of each trainer from the same weights
    p0 = flat_params(flax)
    perm = torch.randperm(bs, generator=torch.Generator().manual_seed(0))

    def trained(bt, where=dev, scale=1.0, mesh=None):
        model, losses = mccnn.train(fresh(), bt, lr * scale, device=where,
                                    mesh=mesh)
        return flat_params(mccnn.to_flax_params(model)) - p0, losses

    runs = {"single": trained(batches),
            "CPU": trained([tuple(x.cpu() for x in b) for b in batches],
                           "cpu"),
            "permuted": trained([tuple(x[perm.to(dev)] for x in b)
                                 for b in batches]),
            "mesh": trained(batches, mesh=train_mesh),
            "lr": trained(batches, scale=TRAIN_LR_FAULT, mesh=train_mesh)}

    def gap(run, ref):
        """(largest relative loss error, relative error of the move)."""
        (m, losses), (m_ref, l_ref) = runs[run], runs[ref]
        check(len(losses) == len(l_ref) == 3, f"{run}: {len(losses)} steps")
        return (max(abs(x - y) / abs(y) for x, y in zip(losses, l_ref)),
                float(np.linalg.norm(m - m_ref) / np.linalg.norm(m_ref)))

    def within(g) -> bool:
        return g[0] <= MESH_STEP_RTOL and g[1] <= MESH_MOVE_RTOL

    for ref in ("single", "CPU"):
        check(within(gap("mesh", ref)), f"mesh trainer vs the {ref} "
              f"trainer, 3 steps: (losses, move) {gap('mesh', ref)}")
    check(not within(gap("lr", "single")), f"mesh trainer control: lr x "
          f"{TRAIN_LR_FAULT} passes {gap('lr', 'single')}")
    tower = mccnn.shard_params(fresh(), train_mesh)
    opt = Adam(tower.parameters(), lr)
    step = mccnn.make_train_step(tower, opt, train_mesh)
    a, p, n_ = batches[0]
    step(a, p, n_)
    for q in tower.parameters():
        check(q.grad.device == q.device and all(
            s.device == q.device for s in opt.state[q].values()),
              "a gradient or Adam state off its slice's device")
    t_mesh = wall_ms(lambda: step(a, p, n_), 10, cards)
    model = mccnn.make_model("fast", seed=0).to(dev).requires_grad_(True)
    one = mccnn.make_train_step(model, Adam(model.parameters(), lr))
    t_one = wall_ms(lambda: one(a, p, n_), 10, [dev])
    print(f"[4i] MC-CNN fast mesh trainer (data 2 x model 2 {where}, {bs} "
          f"triplets of 16x16, lr {lr}) against the single-device trainer "
          f"on {dev}, both in float32: first step, loss within {loss_err} "
          f"(bar {MESH_LOSS_RTOL}), gradients within {e} of their norm on "
          f"the mesh's branch (bar {MESH_GRAD_RTOL}; {flips} signs of the "
          f"ReLUs (by layer) and hinge differ; as they are "
          f"{grad_err(g_mesh, g_one)}; TF32 backward {e_tf32}); 3 steps, "
          f"(losses, move) within {gap('mesh', 'single')} (bars "
          f"{MESH_STEP_RTOL}, {MESH_MOVE_RTOL}; lr x {TRAIN_LR_FAULT}: "
          f"{gap('lr', 'single')}) and of the CPU trainer's within "
          f"{gap('mesh', 'CPU')} (the single-device trainer "
          f"{gap('single', 'CPU')}; on the batches permuted, "
          f"{gap('permuted', 'single')} off its own run); gradients and "
          f"Adam's state on each slice's device ({card})")
    print(f"[timing] MC-CNN fast mesh train step (data 2 x model 2 {where}): "
          f"{t_mesh} ms a step (host clock, 10 steps after 1); the "
          f"single-device step {t_one} ms ({card})")
    print(f"[4i] the phase took {time.perf_counter() - t_phase} s ({card})")


ACCURACY_DENSITY = -0.10   # tests/test_accuracy.py: density at most 10
#                            points under cv2's


def phase_4j(dev: torch.device, card: str) -> None:
    """4j. the accuracy record's blocks (``tools/accuracy_eval.py``) at full
    size against cv2 on the host: the census rows at KITTI (speckle on the
    baseline scenes too), the two ray-traced rows, the 720p D=160 row, the
    fast MC-CNN checkpoint against census and StereoBM against
    cv2.StereoBM, with ``tests/test_accuracy.py``'s bars."""
    from stereo_match_tpu_torch.tools import accuracy_eval as A

    t_phase = time.perf_counter()

    def log(line: str) -> None:
        print(f"[4j] {line} ({card})")

    rows = A.census_rows(A.H, A.W, A.D, dev, log=log)
    for rep in rows:
        check(rep["bad3_delta"] <= A.TARGET
              and rep["density_delta"] >= ACCURACY_DENSITY,
              f"{rep['scene']} at {A.W}x{A.H} D={A.D}: bad-3px delta "
              f"{rep['bad3_delta']} (bar {A.TARGET}), density delta "
              f"{rep['density_delta']} (bar {ACCURACY_DENSITY})")
    clean, noisy = A.raytraced_rows(A.H, A.W, A.D, dev, log=log)
    b_ours, b_ref = clean["ours"]["bad3"], clean["opencv_sgbm"]["bad3"]
    check(b_ours <= b_ref + A.TARGET and b_ours < 0.05,
          f"ray-traced clean: bad-3px {b_ours}, cv2 {b_ref} (bars: cv2 + "
          f"{A.TARGET}, 0.05)")
    check(noisy["ours"]["bad3"] < 0.08, f"ray-traced with noise and gain: "
          f"bad-3px {noisy['ours']['bad3']} (bar 0.08)")
    prod = A.prod_720p_row(*A.PROD, dev, log=log)
    mc = A.mccnn_vs_census(A.H, A.W, A.D, dev, log=log)
    check(mc["pass"], f"MC-CNN fast against census: {mc} (clean within "
          f"0.03 of census, noise 25 below it)")
    _, bm_worst = A.bm_vs_cv2_stereobm(A.H, A.W, A.D, dev, log=log)
    worst = max([rep["bad3_delta"] for rep in rows + [clean, noisy, prod]]
                + [bm_worst])
    print(f"[4j] {len(rows)} census rows at {A.W}x{A.H} D={A.D} within "
          f"bad-3px {A.TARGET} and density {ACCURACY_DENSITY} of cv2; "
          f"worst bad-3px delta of the phase's rows {worst}; the phase took "
          f"{time.perf_counter() - t_phase} s ({card})")


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from stereo_match_tpu_torch import native
    from stereo_match_tpu_torch.config import DisparityConfig
    from stereo_match_tpu_torch.costs import (ClassicCost, MCCNNCost,
                                              census_cost)
    from stereo_match_tpu_torch.data.ply import read_ply
    from stereo_match_tpu_torch.data.speckle_maps import (noisy_ramp,
                                                          serpentine,
                                                          speckled)
    from stereo_match_tpu_torch.data.synthetic import (random_dot_pair,
                                                       slanted_scene)
    from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate, density
    from stereo_match_tpu_torch.models.mccnn import (
        from_flax_params, load_default_params, mccnn_cost_volume,
        mccnn_cost_volume_fused, normalize_image)
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    from stereo_match_tpu_torch.ops import wls
    from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
    from stereo_match_tpu_torch.ops.speckle import speckle_filter
    from stereo_match_tpu_torch.ops.wta import disparity_from_stats
    from stereo_match_tpu_torch.parallel.pipeline_stage import DOWN, UP
    from stereo_match_tpu_torch.parallel import (StreamingPipeline, make_mesh,
                                                 make_stage_mesh,
                                                 sgm_aggregate_sharded,
                                                 volume_sharding)
    from stereo_match_tpu_torch.pipeline import block_matching, elas
    from stereo_match_tpu_torch.pipeline.stereo import (StereoMatcher,
                                                        _match_core,
                                                        run_pipeline)
    from stereo_match_tpu_torch.utils.backend import require_hopper

    # 1. device
    dev = require_hopper(0)
    card = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    lib, log = K.build()
    print(f"[build] {lib}")
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print(f"[build] {line.strip()}")

    def scene(spec, noise=0.0):
        gt = slanted_scene(spec["H"], spec["W"], spec["d_min"], spec["d_max"])
        left, right = random_dot_pair(spec["H"], spec["W"], gt, blur=1.0,
                                      seed=spec["seed"], noise=noise)
        return (torch.from_numpy(left).to(dev, torch.float32),
                torch.from_numpy(right).to(dev, torch.float32), gt)

    def headline(D: int) -> DisparityConfig:
        return DisparityConfig(num_disparities=D, cost="census",
                               uniqueness_ratio=15, disp12_max_diff=1,
                               wls=False, speckle_window_size=0)

    def aggregate(scan, vol, cfg):
        return K.aggregate_paths(vol, cfg.P1, cfg.P2, cfg.num_paths, scan)

    def plain_path(left, right, cfg, both_views=False):
        """The main path with every kernel replaced by its plain version
        (sad, ssd and bt volumes are plain torch on either path)."""
        if cfg.cost == "census":
            words = K.census_words_plain(torch.stack([left, right]),
                                         cfg.census_window)
            vol = K.census_volume_plain(words[0], words[1],
                                        cfg.num_disparities,
                                        cfg.min_disparity, cfg.dtype)
        else:
            vol = ClassicCost(cfg)(left, right)
        total = aggregate(K.sgm_path_scan_plain, vol, cfg)
        del vol
        out = K.wta_lr_plain(total, cfg.min_disparity, cfg.uniqueness_ratio,
                             cfg.disp12_max_diff, cfg.subpixel)
        return out if both_views else out[0]

    def plain_speckle(d, cfg, max_iters=64):
        if cfg.speckle_window_size <= 0:
            return d
        return K.speckle_fixpoint_plain(d, cfg.speckle_window_size,
                                        cfg.speckle_range, max_iters)[0]

    def solve64(f, wp, wn, lam, axis):
        """The plain solve in float64: the reference of K7's checks."""
        return K.fgs_solve_plain(f.double(), wp.double(), wn.double(), lam,
                                 axis)

    def max_err(a, b):
        return float((a.double() - b.double()).abs().max())

    def plain_post_path(left, right, cfg):
        """_match_core with the post stack, every kernel plain: the raw map
        and the filtered one, and the filter with float64 solves."""
        disp, disp_right = plain_path(left, right, cfg, both_views=True)
        disp = plain_speckle(disp, cfg)
        conf = wls.wls_confidence_cv2(disp, disp_right) \
            if cfg.wls_lr_confidence else None
        return disp, *(wls.wls_filter_disparity(
            disp, left, cfg.lmbda, cfg.sigma, cfg.wls_iters, confidence=conf,
            solve=solve) for solve in (K.fgs_solve_plain, solve64))

    def plain_tower(model, imgs):
        """The MC-CNN tower on (V, H, W) images, every layer plain, in the
        model's compute dtype."""
        bf16 = model.compute_dtype == torch.bfloat16
        h = torch.stack([normalize_image(im) for im in imgs])[:, None]
        for i in range(model.num_layers):
            last = i == model.num_layers - 1
            h = K.mccnn_conv3x3_plain(h, model.weights[i], model.biases[i],
                                      not last, last, bf16)
        return h

    def plain_mccnn_path(left, right, cfg, model):
        """The MC-CNN main path with every kernel replaced by its plain
        version."""
        f = plain_tower(model, (left, right))
        vol = K.mccnn_volume_plain(f[0], f[1], cfg.num_disparities,
                                   cfg.min_disparity)
        del f
        total = aggregate(K.sgm_path_scan_plain, vol, cfg)
        del vol
        return K.wta_lr_plain(total, cfg.min_disparity, cfg.uniqueness_ratio,
                              cfg.disp12_max_diff, cfg.subpixel)[0]

    def bf16_ulp(v):
        """The spacing of bfloat16 values at |v| (0 at 0)."""
        _, e = torch.frexp(v.abs())
        return torch.where(v == 0, torch.zeros_like(v),
                           torch.ldexp(torch.ones_like(v), e - 8))

    def k8_bf16_check(args, layout, what, bf16_out=False):
        """K8's bfloat16 mode against its plain layer (K8_BF16_EQUAL and
        the ulp bounds above), x float32 or bfloat16 channels-last, the
        output float32 or (``bf16_out``) bfloat16 channels-last: (output,
        max |kernel - plain|, bit-equal share)."""
        x, w, b, _, normalize = args
        y = K.mccnn_conv3x3(*args, layout=layout, bf16=True,
                            bf16_out=bf16_out)
        y_ref = K.mccnn_conv3x3_plain(*args, bf16=True, bf16_out=bf16_out)
        fmt = torch.channels_last if bf16_out else torch.contiguous_format
        check(y.dtype == y_ref.dtype and y.is_contiguous(memory_format=fmt),
              f"K8 bf16 {what}: {y.dtype} {y.stride()} out, the plain "
              f"layer's {y_ref.dtype} {y_ref.stride()}")
        x32 = x.float()
        with K.fp32_cudnn():
            pre = torch.nn.functional.conv2d(K.bf16_round(x32),
                                             K.bf16_round(w), padding=1)
        raw = K.mccnn_conv3x3_plain(x, w, b, False, False, bf16=True)
        tol = bf16_ulp(pre) + bf16_ulp(raw)
        del pre, x32
        diff = (y.float() - y_ref.float()).abs()
        equal = float((y == y_ref).float().mean())
        if normalize:
            tol /= torch.sqrt((raw * raw).sum(1, keepdim=True) + 1e-12)
            tol += 1e-6
        within = bool((diff <= tol).all())
        e = float(diff.max())
        print(f"[mccnn] K8 bf16 {what} {tuple(x.shape)} {x.dtype} -> "
              f"{tuple(y.shape)} {y.dtype}: max |kernel - plain| = {e}, "
              f"{equal} of the outputs "
              f"bit-equal, all within the ulp bound: {within} ({card})")
        check(within, f"K8 bf16 {what}: an output past the ulp bound")
        check(normalize or equal >= K8_BF16_EQUAL, f"K8 bf16 {what}: "
              f"{equal} bit-equal < {K8_BF16_EQUAL}")
        return y, e, equal

    def band_sums(pairs, D):
        """(D, H, W): for each plane d, the sum over the (a, b) pairs of
        sum_f a[f, y, x] b[f, y, x - d] where x >= d (0 elsewhere)."""
        F, H, W = pairs[0][0].shape
        out = torch.zeros((D, H, W), device=pairs[0][0].device)
        for d in range(min(D, W)):
            for a, b in pairs:
                out[d, :, d:] += (a[:, :, d:] * b[:, :, :W - d]).sum(0)
        return out

    def k11_check(model, imgs, D, what):
        """K11 on the last layer's input of ``model``'s tower (K8 for the
        layers before) against K8's last launch then K9 and against its
        plain version, 1e4 masks equal: (max |K11 - plain|, K11's
        arguments). K11 repeats K8's and K9's arithmetic, so it should
        equal the two-kernel path bit for bit (the share is printed). The
        bars, a cell each: against K8 -> K9, K9_TOL in float32; in
        bfloat16 K9_TOL plus what features off by twice the ulp bound u of
        K8 bf16's normalised layer (K8_BF16_EQUAL's rule, each path's
        features within u of the plain layer's) move a cell, scale / 2 *
        sum_f (2 u_l |f_r| + |f_l| 2 u_r + 4 u_l u_r). Against the plain
        version: that bar plus K9_TOL (K9 against the plain volume) plus
        what K8's measured feature errors e move a cell, scale / 2 * sum_f
        (e_l |p_r| + |p_l| e_r + e_l e_r), p the plain features."""
        bf16 = model.compute_dtype == torch.bfloat16
        i = model.num_layers - 1
        x = model.hidden(imgs)
        # what the one-kernel path hands K11: the input channels-last (K8
        # writes it so in float32 too), K11's copy of the weights
        x_cl = model.hidden(imgs, channels_last=True)
        check(torch.equal(x_cl, x) and x_cl.is_contiguous(
            memory_format=torch.channels_last), f"K11 {what}: K8's "
              "channels-last output differs from its NCHW one")
        w, b = model.weights[i], model.biases[i]
        layout = getattr(model, f"layout{i}")
        scale = 24.0
        K.reset_launches()
        got = K.mccnn_fused_volume(x_cl, w, b, D, scale, model.layout_fused,
                                   bf16)
        torch.cuda.synchronize()
        check(K.launches["mccnn_fused_volume"] == 1, f"K11 {what}: "
              f"launches {dict(K.launches)}")
        f = K.mccnn_conv3x3(x, w, b, False, True, layout=layout, bf16=bf16)
        two = K.mccnn_volume(f[0], f[1], D, 0, scale)
        p = K.mccnn_conv3x3_plain(x, w, b, False, True, bf16)
        want = K.mccnn_volume_plain(p[0], p[1], D, 0, scale)
        bar_two = torch.full_like(got, K9_TOL)
        if bf16:
            with K.fp32_cudnn():
                pre = torch.nn.functional.conv2d(
                    K.bf16_round(x.float()), K.bf16_round(w), padding=1)
            raw = K.mccnn_conv3x3_plain(x, w, b, False, False, bf16=True)
            u = 2 * ((bf16_ulp(pre) + bf16_ulp(raw)) / torch.sqrt(
                (raw * raw).sum(1, keepdim=True) + 1e-12) + 1e-6)
            del pre, raw
            bar_two += scale / 2 * band_sums(
                [(u[0], f[1].abs()), (f[0].abs(), u[1]), (u[0], u[1])], D)
            del u
        e = (f - p).abs()
        bar_plain = bar_two + K9_TOL + scale / 2 * band_sums(
            [(e[0], p[1].abs()), (p[0].abs(), e[1]), (e[0], e[1])], D)
        del f, e
        for ref, name in ((two, "K8 -> K9"), (want, "plain")):
            check(torch.equal(got == 1e4, ref == 1e4),
                  f"K11 {what}: the 1e4 mask differs from {name}'s")
        d_two, d_plain = (got - two).abs(), (got - want).abs()
        e_two, e_plain = float(d_two.max()), float(d_plain.max())
        equal = float((got == two).float().mean())
        print(f"[mccnn] K11 {what} {tuple(x.shape)} {x.dtype} D={D}: max "
              f"|K11 - (K8 -> K9)| = {e_two} (least bar of a cell "
              f"{float(bar_two.min())}), {equal} of the cells bit-equal; "
              f"max |K11 - plain| = {e_plain} (largest share of its bar "
              f"{float((d_plain / bar_plain).max())}); 1e4 masks equal "
              f"({card})")
        check(bool((d_two <= bar_two).all()), f"K11 {what}: a cell past "
              f"its bar against K8 -> K9 (max {e_two})")
        check(bool((d_plain <= bar_plain).all()), f"K11 {what}: a cell "
              f"past its bar against the plain version (max {e_plain})")
        return e_plain, ((x_cl, w, b, D, scale, model.layout_fused, bf16),
                         (x, layout))

    def agreement(a, b):
        """Share of pixels with the same NaN state and |diff| <= 0.01."""
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        close = (a - b).abs().nan_to_num(0.0) <= 0.01
        return float(((nan_a == nan_b) & (close | nan_a | nan_b)).float()
                     .mean())

    def exact_counts(counts, want, what):
        """The launch counts must be ``want`` and 0 for every other
        kernel."""
        full = {name: 0 for name in counts}
        full.update(want)
        check(counts == full, f"{what} launch counts {counts} != {full}")

    def same_disparity(a, b, what):
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        check(torch.equal(nan_a, nan_b), f"{what}: NaN masks differ at "
              f"{int((nan_a != nan_b).sum())} pixels")
        err = float((a - b).abs().nan_to_num(0.0).max())
        check(err <= K4_TOL, f"{what}: max |diff| {err} > {K4_TOL}")
        return err

    # 3. kernel parity at KITTI shape
    left, right, gt = scene(KITTI)
    cfg = headline(KITTI["D"])
    imgs = torch.stack([left, right]).contiguous()
    err, ms, plain_ms = {}, {}, {}

    words = K.census_words(imgs, cfg.census_window)
    words_ref = K.census_words_plain(imgs, cfg.census_window)
    err["census_words"] = int((words.long() - words_ref.long()).abs().max())
    check(torch.equal(words, words_ref), "K1 census_words bit-equal")

    vol = K.census_volume(words[0], words[1], cfg.num_disparities, 0)
    vol_ref = K.census_volume_plain(words[0], words[1], cfg.num_disparities, 0)
    err["census_volume"] = float((vol - vol_ref).abs().max())
    check(torch.equal(vol, vol_ref), "K2 census_volume bit-equal")

    total = aggregate(K.sgm_path_scan, vol, cfg)
    total_ref = aggregate(K.sgm_path_scan_plain, vol, cfg)
    err["sgm_path_scan"] = float((total - total_ref).abs().max())
    check(torch.equal(total, total_ref), "K3 sgm_path_scan totals bit-equal")

    wta_args = (cfg.min_disparity, cfg.uniqueness_ratio, cfg.disp12_max_diff,
                cfg.subpixel)
    disp, disp_right = K.wta_lr(total, *wta_args)
    disp_ref, right_ref = K.wta_lr_plain(total, *wta_args)
    err["wta_lr"] = same_disparity(disp, disp_ref, "K4 wta_lr")
    check(torch.equal(disp_right, right_ref), "K4 right-view disparities")
    for name, e in err.items():
        print(f"[parity] {name}: max_abs_err={e} ({label(KITTI)})")

    def k4_ties(spec, dtype, seed):
        """K4's three entries on a tie-heavy total (K.tie_heavy_total:
        constant planes, minima at d = 0 and D - 1, equal minima over
        idx -+ 1, equal right-view diagonals), each against its plain
        version: wta_stats and right_wta bit-equal, wta_lr's NaN mask equal
        and values within K4_TOL."""
        tie = torch.from_numpy(K.tie_heavy_total(
            spec["D"], spec["H"], spec["W"], seed)).to(dev).to(dtype)
        for a, b in zip(K.wta_stats(tie), K.wta_stats_plain(tie)):
            check(torch.equal(a, b), f"K4 wta_stats tie-heavy {dtype} "
                  f"{label(spec)} bit-equal")
        check(torch.equal(K.right_wta(tie), K.right_wta_plain(tie)),
              f"K4 right_wta tie-heavy {dtype} {label(spec)} bit-equal")
        for args in (wta_args, (3, 5, 2, True), (0, 0, -1, False)):
            d_k, r_k = K.wta_lr(tie, *args)
            d_p, r_p = K.wta_lr_plain(tie, *args)
            same_disparity(d_k, d_p, f"K4 wta_lr tie-heavy {dtype} "
                           f"{label(spec)} {args}")
            check(torch.equal(r_k, r_p), f"K4 wta_lr tie-heavy right view "
                  f"{dtype} {label(spec)} {args}")
        print(f"[parity] K4 wta_lr, wta_stats, right_wta on a tie-heavy "
              f"{dtype} total {label(spec)}: equal to their plain versions "
              f"({card})")
        del tie, d_k, r_k, d_p, r_p

    for spec in (KITTI, ARKIT_720P):
        k4_ties(spec, torch.float32, seed=8)

    # 3b. post-stack kernel parity at full size
    left7, right7, gt7 = scene(ARKIT_720P)
    cfg7 = headline(ARKIT_720P["D"])
    disp7 = _match_core(left7, right7, cfg7)[0]

    def k5_vs_plain(d, T, max_diff, max_iters, what):
        """K5 in one launch against the plain filter: the map, the sweeps
        and the unconverged flag bit for bit; returns (out, sweeps,
        unconverged, max |diff|)."""
        K.reset_launches()
        out, stats = K.speckle_filter(d, T, max_diff, max_iters)
        torch.cuda.synchronize()
        exact_counts(dict(K.launches), {"speckle_filter": 1}, f"K5 {what}")
        ref, sweeps, unconv = K.speckle_fixpoint_plain(d, T, max_diff,
                                                       max_iters)
        e = bit_equal(out, ref, f"K5 speckle_filter {what}")
        check(stats.tolist() == [sweeps, int(unconv)], f"K5 {what}: "
              f"[sweeps, unconverged] {stats.tolist()}, plain "
              f"[{sweeps}, {int(unconv)}]")
        return out, sweeps, unconv, e

    spk_cfg = headline(KITTI["D"]).replace(
        speckle_window_size=SPECKLE["T"], speckle_range=SPECKLE["range"])
    spk_maps = {"KITTI": speckled(disp), "720p": speckled(disp7)}
    spk_sweeps = {}
    err["speckle_filter"] = 0.0
    for name, sp in spk_maps.items():
        out, n, unconv, e = k5_vs_plain(sp, SPECKLE["T"], SPECKLE["range"],
                                        64, name)
        err["speckle_filter"] = max(err["speckle_filter"], e)
        spk_sweeps[name] = n
        check(not unconv and n >= 2, f"K5 {name}: converged in {n} sweeps")
        bit_equal(speckle_filter(sp, SPECKLE["T"], SPECKLE["range"]),
                  plain_speckle(sp, spk_cfg), f"speckle_filter {name}")
        removed = int((torch.isfinite(sp) & torch.isnan(out)).sum())
        print(f"[parity] K5 speckle_filter {name} {tuple(sp.shape)}: one "
              f"launch, bit-equal to the plain filter; {n} sweeps (kernel "
              f"and plain), unconverged={unconv}; {removed} of "
              f"{int(torch.isfinite(sp).sum())} valid pixels removed "
              f"(T={SPECKLE['T']}, range={SPECKLE['range']}; {card})")
    sp = spk_maps["KITTI"]
    want = speckle_filter(sp, SPECKLE["T"], SPECKLE["range"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = speckle_filter(sp, SPECKLE["T"], SPECKLE["range"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    bit_equal(got, want, "K5 under set_sync_debug_mode('error')")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        speckle_filter(sp, SPECKLE["T"], SPECKLE["range"])
        torch.cuda.synchronize()
    device_ops = {e.key: e.count for e in prof.key_averages()
                  if e.device_time_total > 0}
    if device_ops:
        check(sum(device_ops.values()) == 1, f"K5: one device kernel in "
              f"the profiler's trace, got {device_ops}")
    print(f"[parity] K5 makes no host sync (set_sync_debug_mode 'error'); "
          f"torch.profiler's device operations of one filter: "
          f"{device_ops or 'none seen (no device trace)'} ({card})")

    serp = torch.from_numpy(serpentine(75, KITTI["W"])).to(dev)
    _, k, _, _ = k5_vs_plain(serp, 10 ** 6, 1.0, 64, "serpentine")
    kept, _, unconv, _ = k5_vs_plain(serp, 10 ** 6, 1.0, k - 1,
                                     f"serpentine max_iters={k - 1}")
    check(unconv and torch.equal(torch.isfinite(kept),
                                  torch.isfinite(serp)),
          "serpentine capped one sweep short keeps every pixel")
    gone, _, unconv, _ = k5_vs_plain(serp, 10 ** 6, 1.0, k,
                                     f"serpentine max_iters={k}")
    check(not unconv and bool(torch.isnan(gone).all()),
          "serpentine at its k sweeps is one component, removed")
    mid_x, mid_y = KITTI["W"] // 2, KITTI["H"] // 2
    edges = {"W=1": disp[:, mid_x:mid_x + 1].contiguous(),
             "H=1": disp[mid_y:mid_y + 1].contiguous(),
             "all-NaN": torch.full((64, 256), float("nan"), device=dev)}
    for name, edge in edges.items():
        k5_vs_plain(edge, 3, SPECKLE["range"], 64, name)
    k5_vs_plain(spk_maps["KITTI"], SPECKLE["T"], SPECKLE["range"], 0,
                "max_iters=0")
    print(f"[parity] K5 on a serpentine of 75 rows of {KITTI['W']}: {k} "
          f"sweeps; at max_iters {k} removed, at {k - 1} kept; W=1, H=1, "
          f"all-NaN and max_iters=0 bit-equal to the plain filter "
          f"({card})")
    del want, got, out, serp, kept, gone, edges, edge

    err["fgs_solve"] = 0.0
    k7_shapes, k7_args = [], {}
    lam = wls._lambda_schedule(80000.0, 3)[0]
    for spec, guide, d in ((KITTI, left, disp), (ARKIT_720P, left7, disp7)):
        valid = torch.isfinite(d)
        conf = valid.to(torch.float32)
        f = torch.stack([conf * torch.where(valid, d, 0.0), conf])
        for kind, axis in (("row", 1), ("column", 0)):
            wp, wn = wls._scan_weights(wls._edge_weights(guide, axis, 1.2),
                                       axis)
            u = K.fgs_solve(f, wp, wn, lam, axis)
            u_model = K.fgs_solve_partitioned_plain(f, wp, wn, lam, axis)
            check(torch.equal(u, u_model), f"K7 fgs_solve {kind} solve at "
                  f"{label(spec)} bit-equal to its partitioned model (max "
                  f"|diff| {max_err(u, u_model)})")
            u_ref = K.fgs_solve_plain(f, wp, wn, lam, axis)
            u64 = solve64(f, wp, wn, lam, axis)
            e_k, e_p = max_err(u, u64), max_err(u_ref, u64)
            check(e_k <= K7_F64_RATIO * e_p, f"K7 fgs_solve {kind} solve at "
                  f"{label(spec)}: float64 error {e_k} > {K7_F64_RATIO} x "
                  f"the plain solve's {e_p}")
            err["fgs_solve"] = max(err["fgs_solve"], max_err(u, u_ref))
            k7_shapes.append(f"{kind} {label(spec)}: float64 error {e_k} "
                             f"(plain {e_p}), |kernel - plain| "
                             f"{max_err(u, u_ref)}")
            k7_args[kind, spec["H"]] = (f, wp, wn, axis)
    del disp7, d, valid, conf, u, u_model, u_ref, u64
    print(f"[parity] fgs_solve (2, H, W) slabs at lambda {lam}: bit-equal to "
          f"the partitioned model; {k7_shapes} ({card})")

    # 3c. K3 direction by direction: every direction written and added onto
    # a nonzero total, bit-equal to the plain scan, in float32 and int16, at
    # KITTI, at 720p D=160 and at an odd shape (W and H not multiples of 8)
    def k3_directions(cost, what):
        rng = np.random.default_rng(cost.shape[0])
        hi = 999 if cost.dtype == torch.int16 else 99.0
        start = torch.from_numpy(rng.uniform(0, hi, cost.shape)).to(
            dev, cost.dtype)
        for dy, dx in PATH_DIRECTIONS_8:
            for acc in (False, True):
                got = K.sgm_path_scan(cost, start.clone(), dy, dx, cfg.P1,
                                      cfg.P2, acc)
                want = K.sgm_path_scan_plain(cost, start.clone(), dy, dx,
                                             cfg.P1, cfg.P2, acc)
                check(torch.equal(got, want), f"K3 {what} direction "
                      f"{(dy, dx)} accumulate={acc} bit-equal")
        del start, got, want

    words7 = K.census_words(torch.stack([left7, right7]).contiguous())
    odd = np.random.default_rng(7).uniform(0, 24, (ODD["D"], ODD["H"],
                                                   ODD["W"]))
    k3_cases = {
        f"float32 {label(KITTI)}": lambda: vol,
        f"int16 {label(KITTI)}": lambda: K.census_volume(
            words[0], words[1], KITTI["D"], 0, torch.int16),
        f"float32 {label(ARKIT_720P)}": lambda: K.census_volume(
            words7[0], words7[1], ARKIT_720P["D"]),
        f"float32 {label(ODD)}": lambda: torch.from_numpy(odd).to(
            dev, torch.float32),
        f"int16 {label(ODD)}": lambda: torch.from_numpy(odd).to(
            dev, torch.float32).to(torch.int16),
    }
    for what, make in k3_cases.items():
        k3_directions(make(), what)
    del odd, words7
    print(f"[parity] sgm_path_scan: all 8 directions, written and added, "
          f"bit-equal to the plain scan: {list(k3_cases)} ({card})")

    # 3d. multiword census (7x9: two words) and the float disp12 tolerance
    words79 = K.census_words(imgs, WIDE)
    check(tuple(words79.shape) == (2, 2, KITTI["H"], KITTI["W"]),
          f"K1 {WIDE} words shape {tuple(words79.shape)}")
    words79_ref = K.census_words_plain(imgs, WIDE)
    err["census_words 7x9"] = int((words79.long() - words79_ref.long())
                                  .abs().max())
    check(torch.equal(words79, words79_ref), f"K1 {WIDE} bit-equal")
    del words79_ref
    # K1 at 720p and at odd widths (word-plane rows at every 16-byte
    # alignment, so 16-, 8- and 4-byte stores and scalar row ends)
    for name, im in {
            label(ARKIT_720P): torch.stack([left7, right7]).contiguous(),
            "W=1241": imgs[:, :, :KITTI["W"] - 1].contiguous(),
            "W=1243": torch.cat([imgs, imgs[:, :, :1]], 2).contiguous()
    }.items():
        for win in (cfg.census_window, WIDE):
            check(torch.equal(K.census_words(im, win),
                              K.census_words_plain(im, win)),
                  f"K1 {win} at {name} bit-equal")
    print(f"[parity] census_words at {label(ARKIT_720P)}, W=1241 and "
          f"W=1243, {cfg.census_window} and {WIDE}: bit-equal ({card})")
    wT79 = words79.transpose(2, 3).contiguous()      # (2, 2, W, H)
    err["census_volume 7x9"] = 0.0
    for what, (cl, cr, dt, tr) in {
            "float32": (words79[0], words79[1], torch.float32, False),
            "int16": (words79[0], words79[1], torch.int16, False),
            "transposed float32": (wT79[0], wT79[1], torch.float32, True)
    }.items():
        got = K.census_volume(cl, cr, KITTI["D"], 0, dt, tr)
        want = K.census_volume_plain(cl, cr, KITTI["D"], 0, dt, tr)
        err["census_volume 7x9"] = max(err["census_volume 7x9"], float(
            (got.float() - want.float()).abs().max()))
        check(torch.equal(got, want), f"K2 {WIDE} {what} bit-equal")
    del got, want, wT79
    # the headline maps, and quarter-pixel maps whose differences land on
    # and between the fractional tolerances
    rng = np.random.default_rng(16)
    quarter = [torch.from_numpy(rng.integers(0, 512, disp.shape) / 4.0).to(
        dev, torch.float32) for _ in range(2)]
    err["lr_mask lr_tol=2.0"] = 0
    for what, (dl, dr) in (("headline", (disp, disp_right)),
                           ("quarter-pixel", quarter)):
        for tol in LR_TOLS:
            a = K.lr_mask(dl, dr, tol)
            b = K.lr_mask_plain(dl, dr, tol)
            err["lr_mask lr_tol=2.0"] = max(
                err["lr_mask lr_tol=2.0"], int((a.int() - b.int()).abs().max()))
            check(torch.equal(a, b), f"K4 lr_mask {what} tol={tol} bit-equal")
            print(f"[parity] lr_mask {what} maps tol={tol}: bit-equal, "
                  f"{int(a.sum())} pixels pass against "
                  f"{int(K.lr_mask(dl, dr, int(tol)).sum())} at "
                  f"tol={int(tol)} ({label(KITTI)}; {card})")
    del quarter, dl, dr, a, b
    print(f"[parity] census_words {WIDE} (2 words) and census_volume on them "
          f"(float32, int16, transposed): bit-equal ({label(KITTI)}; {card})")
    # K2 at D = 1 (ELAS's plane a launch), min_d > 0 and an odd width
    odd_words = {n: K.census_words(imgs[:, :, :KITTI["W"] - 1].contiguous(), w)
                 for n, w in (("5x5", cfg.census_window), ("7x9", WIDE))}
    k2_odd = []
    for name, ow in odd_words.items():
        owT = ow.transpose(2, 3).contiguous()
        for D_, min_d in ((1, 0), (1, 37), (KITTI["D"], 5)):
            for dt in (torch.float32, torch.int16):
                for tr, w in ((False, ow), (True, owT)):
                    got = K.census_volume(w[0], w[1], D_, min_d, dt, tr)
                    want = K.census_volume_plain(w[0], w[1], D_, min_d, dt,
                                                 tr)
                    check(torch.equal(got, want), f"K2 {name} D={D_} "
                          f"min_d={min_d} {dt} transposed={tr} at W="
                          f"{KITTI['W'] - 1} bit-equal")
                    k2_odd.append((name, D_, min_d, str(dt), tr))
    del odd_words, ow, owT, got, want
    print(f"[parity] census_volume at W={KITTI['W'] - 1} (odd), D = 1 and "
          f"{KITTI['D']}, min_d 0, 37 and 5, 5x5 and {WIDE}, float32 and "
          f"int16, planes and transposed: {len(k2_odd)} cases bit-equal "
          f"({card})")

    # 4. main path through the user's entry point
    matcher = StereoMatcher(cfg, device=dev)
    left_np, right_np = left.cpu().numpy(), right.cpu().numpy()
    K.reset_launches()
    raw, filtered = matcher(left_np, right_np)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"[main] launches {counts}")
    for name in MAIN_PATH:
        check(counts[name] > 0, f"kernel {name} launched on the main path")
    check(raw.shape == (KITTI["H"], KITTI["W"]) and raw.device == dev,
          "main path output shape and device")
    main_err = same_disparity(raw, plain_path(left, right, cfg),
                              "main path vs plain path, KITTI")
    bad3 = float(bad_pixel_rate(raw, gt, 3.0, 0.0))
    dens = float(density(raw))
    print(f"[main] {label(KITTI)}: max |kernel - plain| = {main_err}, "
          f"bad-3px = {bad3}, density = {dens}")
    check(bad3 < 0.05, f"bad-3px {bad3} < 0.05")
    check(dens > 0.8, f"density {dens} > 0.8")

    raw7, _ = _match_core(left7, right7, cfg7)
    err7 = same_disparity(raw7, plain_path(left7, right7, cfg7),
                          "main path vs plain path, 720p")
    print(f"[main] {label(ARKIT_720P)}: max |kernel - plain| = {err7}, "
          f"bad-3px = {float(bad_pixel_rate(raw7, gt7, 3.0, 0.0))}, density = "
          f"{float(density(raw7))}")
    del raw7

    # 4b. post-stack paths through the user's entry point
    spk_wls = spk_cfg.replace(wls=True, wls_iters=3)
    post_paths = {   # name -> (scene spec, left, right, gt, config)
        "settings.ini": (ARKIT_720P, left7, right7, gt7, DisparityConfig()),
        "speckle+wls": (KITTI, left, right, gt, spk_wls),
        "speckle+wls+lr_confidence": (KITTI, left, right, gt,
                                      spk_wls.replace(wls_lr_confidence=True)),
    }
    post_counts = {}
    for name, (spec, lft, rgt, g, pcfg) in post_paths.items():
        matcher = StereoMatcher(pcfg, device=dev)
        lft_np, rgt_np = lft.cpu().numpy(), rgt.cpu().numpy()
        K.reset_launches()
        raw_p, filt_p = matcher(lft_np, rgt_np)
        torch.cuda.synchronize()
        c = post_counts[name] = dict(K.launches)
        print(f"[post] {name} {label(spec)}: launches {c} ({card})")
        ran = MAIN_PATH + ("fgs_solve",) + (
            ("speckle_filter",) if pcfg.speckle_window_size > 0 else ())
        for k in ran:
            check(c[k] > 0, f"kernel {k} launched on the {name} path")
        check(c["speckle_filter"] == int(pcfg.speckle_window_size > 0),
              f"{name}: one K5 launch per speckle filter")
        check(c["fgs_solve"] == 2 * pcfg.wls_iters,
              f"{name}: two K7 solves per WLS iteration")
        raw_ref, filt_ref, filt64 = plain_post_path(lft, rgt, pcfg)
        e_raw = same_disparity(raw_p, raw_ref, f"{name}: raw vs plain path")
        check(bool(torch.isfinite(filt_p).all()), f"{name}: filtered finite")
        e_k, e_p = max_err(filt_p, filt64), max_err(filt_ref, filt64)
        e_filt = max_err(filt_p, filt_ref)
        check(e_k <= K7_F64_RATIO * e_p, f"{name}: filtered float64 error "
              f"{e_k} > {K7_F64_RATIO} x the plain path's {e_p}")
        check(e_filt <= K7_PLAIN_PX + e_p, f"{name}: filtered vs plain path "
              f"{e_filt} px > {K7_PLAIN_PX} + the plain path's float64 "
              f"error {e_p}")
        on_raw = torch.where(torch.isnan(raw_p), torch.nan, filt_p)
        bad3 = float(bad_pixel_rate(on_raw, g, 3.0, 0.0))
        print(f"[post] {name} {label(spec)}: raw max |kernel - plain| = "
              f"{e_raw}; filtered max |kernel - plain| = {e_filt} px, "
              f"against the float64 path: kernel {e_k} px, plain {e_p} px; "
              f"raw bad-3px = {float(bad_pixel_rate(raw_p, g, 3.0, 0.0))}, "
              f"density = {float(density(raw_p))}; filtered bad-3px over "
              f"raw-valid pixels = {bad3} ({card})")
        check(bad3 < 0.05, f"{name}: filtered bad-3px {bad3} < 0.05")
        del raw_p, filt_p, raw_ref, filt_ref, filt64, on_raw

    # 4c. the flagship flow: rectify from poses -> match -> WLS -> reproject
    f_px, baseline = 1164.0, 0.1
    H7, W7 = ARKIT_720P["H"], ARKIT_720P["W"]
    K_cam = np.array([[f_px, 0.0, W7 / 2.0], [0.0, f_px, H7 / 2.0],
                      [0.0, 0.0, 1.0]])
    pose_l, pose_r = np.eye(4), np.eye(4)
    pose_r[0, 3] = baseline                  # pure lateral baseline
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "cloud.ply")
        K.reset_launches()
        res = run_pipeline(pose_l, pose_r, K_cam, K_cam,
                           left7.cpu().numpy(), right7.cpu().numpy(),
                           ply_path=ply, device=dev)
        torch.cuda.synchronize()
        flow_counts = dict(K.launches)
        ply_pts, ply_cols = read_ply(ply)
    print(f"[flow] run_pipeline {W7}x{H7} DisparityConfig(): launches "
          f"{flow_counts} ({card})")
    for k in MAIN_PATH + ("fgs_solve",):
        check(flow_counts[k] > 0, f"kernel {k} launched by run_pipeline")
    valid = np.isfinite(res.disparity)
    want_pts = np.where(np.isfinite(res.points[valid]), res.points[valid],
                        0.0)
    check(len(ply_pts) == res.meta["ply_vertices"] == int(valid.sum())
          and np.allclose(ply_pts, want_pts, rtol=1e-6, atol=1e-5)
          and ply_cols.shape == (len(ply_pts), 3),
          "PLY round-trips through read_ply")
    z = res.points[..., 2][valid]
    z_true = f_px * baseline / gt7[valid]
    z_rel = np.abs(z - z_true) / z_true
    print(f"[flow] {len(ply_pts)} points; depth of the slanted plane "
          f"({float(z_true.min())}-{float(z_true.max())} m) vs f*B/d: median "
          f"relative error {float(np.median(z_rel))}, 95th percentile "
          f"{float(np.percentile(z_rel, 95))}; Q[2,3] = "
          f"{res.rectification.Q[2, 3]}, 1/Q[3,2] = "
          f"{1.0 / res.rectification.Q[3, 2]} ({card})")
    check(float(np.median(z_rel)) < 0.01 and
          float(np.percentile(z_rel, 95)) < 0.05,
          "reprojected depth matches f*B/d of the scene")
    del res

    # 4d. the MC-CNN path: shipped checkpoints, K8 per layer, K9, matcher
    models = {arch: from_flax_params(load_default_params(arch), arch).to(dev)
              for arch in ("fast", "accurate")}
    norm = torch.stack([normalize_image(left), normalize_image(right)])
    err["mccnn_conv3x3"] = err["mccnn_volume"] = 0.0
    k8_args, k9_args = {}, {}   # timing inputs: (arch, kind) -> args
    for arch, model in models.items():
        h = norm[:, None].contiguous()
        for i in range(model.num_layers):
            last = i == model.num_layers - 1
            args = (h, model.weights[i], model.biases[i], not last, last)
            layout = getattr(model, f"layout{i}")
            y = K.mccnn_conv3x3(*args, layout=layout)
            y_ref = K.mccnn_conv3x3_plain(*args)
            e = float((y - y_ref).abs().max())
            y64 = K.mccnn_conv3x3_plain(*(a.double() for a in args[:3]),
                                        *args[3:])
            e64 = float((y - y64).abs().max())
            e64_ref = float((y_ref - y64).abs().max())
            body = "FP32" if i == 0 else "3xTF32"
            print(f"[mccnn] K8 {arch} layer {i} ({body}) {tuple(h.shape)} -> "
                  f"{tuple(y.shape)} relu={not last} normalize={last}: "
                  f"max |kernel - plain| = {e}; against float64: kernel "
                  f"{e64}, cuDNN float32 {e64_ref} ({card})")
            if e > K8_TOL:
                print(f"[mccnn] K8 {arch} layer {i}: {e} > K8_TOL {K8_TOL}; "
                      f"held to float64 instead: kernel {e64} against "
                      f"{K8_F64_RATIO} x cuDNN float32 {e64_ref}")
                check(e64 <= K8_F64_RATIO * e64_ref, f"K8 {arch} layer {i}: "
                      f"max |diff| {e} > {K8_TOL} and its float64 error "
                      f"{e64} > {K8_F64_RATIO} x cuDNN's {e64_ref}")
            err["mccnn_conv3x3"] = max(err["mccnn_conv3x3"], e)
            if i < 2:
                k8_args[arch, "C_in=1" if i == 0 else "C_in=F"] = (
                    args, layout)
            h = y
            del y_ref, y64
        k9_args[arch, label(KITTI)] = (h[0], h[1], KITTI["D"], 0)
    f7 = models["fast"](torch.stack([normalize_image(left7),
                                     normalize_image(right7)]))
    k9_args["fast", label(ARKIT_720P)] = (f7[0], f7[1], ARKIT_720P["D"], 0)
    # an odd case: F and D no multiple of the kernel's steps, min_d > 0,
    # an odd width (unit features from a seed)
    fo = np.random.default_rng(9).normal(size=(2, K9_ODD["F"], ODD["H"],
                                               K9_ODD["W"]))
    fo = torch.from_numpy((fo / np.linalg.norm(fo, axis=1, keepdims=True))
                          .astype(np.float32)).to(dev)
    k9_args["odd", f"{K9_ODD['W']}x{ODD['H']} D={K9_ODD['D']} "
            f"min_d={K9_ODD['min_d']}"] = (fo[0], fo[1], K9_ODD["D"],
                                           K9_ODD["min_d"])
    for (arch, where), args in k9_args.items():
        mvol = K.mccnn_volume(*args)
        mvol_ref = K.mccnn_volume_plain(*args)
        check(torch.equal(mvol == 1e4, mvol_ref == 1e4),
              f"K9 {arch} {where}: the 1e4 masks differ")
        e = float((mvol - mvol_ref).abs().max())
        print(f"[mccnn] K9 {arch} {where} features {tuple(args[0].shape)}: "
              f"max |kernel - plain| = {e}, 1e4 mask equal ({card})")
        check(e <= K9_TOL, f"K9 {arch} {where}: max |diff| {e} > {K9_TOL}")
        err["mccnn_volume"] = max(err["mccnn_volume"], e)
    del h, y, mvol, mvol_ref, f7, fo

    mc_cfg = cfg.replace(cost="mccnn")   # bench.py's mccnn_sgm8
    noisy_l, noisy_r, _ = scene(KITTI, noise=25.0)
    noisy_np = (noisy_l.cpu().numpy(), noisy_r.cpu().numpy())
    census_noisy, _ = StereoMatcher(cfg, device=dev)(*noisy_np)
    census_noisy_q = (float(bad_pixel_rate(census_noisy, gt, 3.0, 0.0)),
                      float(density(census_noisy)))
    mc_counts, providers, mc_quality = {}, {}, {}
    for arch, model in models.items():
        providers[arch] = MCCNNCost(model, mc_cfg)
        matcher = StereoMatcher(mc_cfg, cost_fn=providers[arch], device=dev)
        K.reset_launches()
        mc_raw, _ = matcher(left_np, right_np)
        torch.cuda.synchronize()
        c = mc_counts[arch] = dict(K.launches)
        print(f"[mccnn] {arch} {label(KITTI)} launches {c} ({card})")
        want = {name: 0 for name in c}
        want.update(mccnn_conv3x3=model.num_layers - 1,
                    mccnn_fused_volume=1, sgm_path_scan=mc_cfg.num_paths,
                    wta_lr=1)
        check(c == want, f"MC-CNN {arch} launch counts {c} != {want}")
        share = agreement(mc_raw, plain_mccnn_path(left, right, mc_cfg, model))
        check(share >= MC_AGREE, f"MC-CNN {arch}: {share} of the pixels "
              f"agree with the plain path (< {MC_AGREE})")
        quality = {}
        for name, frame in (("clean", (left_np, right_np)),
                            ("noise=25", noisy_np)):
            d = mc_raw if name == "clean" else matcher(*frame)[0]
            quality[name] = (float(bad_pixel_rate(d, gt, 3.0, 0.0)),
                             float(density(d)))
        jax_ref = (f"JAX on a CPU {JAX_CPU['mccnn fast']} clean, "
                   f"{JAX_CPU['mccnn fast noise=25']} noise=25"
                   if arch == "fast" else "JAX on a CPU: not measured")
        print(f"[mccnn] {arch} {label(KITTI)}: {share} of the pixels agree "
              f"with the plain path; (bad-3px, density) clean "
              f"{quality['clean']}, noise=25 {quality['noise=25']}; census "
              f"on the noisy frame {census_noisy_q}; {jax_ref}; census "
              f"{JAX_CPU['census noise=25']} noise=25 ({card})")
        mc_quality[arch] = quality
        (bad3, dens), (nbad3, ndens) = quality["clean"], quality["noise=25"]
        check(bad3 < 0.05 and dens > 0.8, f"MC-CNN {arch} clean: bad-3px "
              f"{bad3} < 0.05 and density {dens} > 0.8")
        check(ndens > census_noisy_q[1] and ndens > 0.9 and nbad3 < 0.05,
              f"MC-CNN {arch} noise=25: density {ndens} above census "
              f"{census_noisy_q[1]} and 0.9, bad-3px {nbad3} < 0.05")

    # the same towers with compute_dtype bfloat16 (K8's bfloat16 mode; the
    # features and K9 stay float32): K8 against its plain bfloat16 layer,
    # the tower against the plain tower within JAX's 1e-2 contract, and the
    # matcher with its launch counts, agreement and quality
    models16 = {arch: from_flax_params(load_default_params(arch), arch,
                                       torch.bfloat16).to(dev)
                for arch in models}
    err["mccnn_conv3x3 bf16"] = 0.0
    for arch, model in models16.items():
        h = norm[:, None].contiguous()
        for i in range(model.num_layers):
            last = i == model.num_layers - 1
            args = (h, model.weights[i], model.biases[i], not last, last)
            layout = getattr(model, f"layout{i}")
            # the module's storage: bfloat16 channels-last between layers
            y, e, _ = k8_bf16_check(args, layout, f"{arch} layer {i}",
                                    bf16_out=not last)
            err["mccnn_conv3x3 bf16"] = max(err["mccnn_conv3x3 bf16"], e)
            if i < 2:
                k8_args[arch, ("C_in=1" if i == 0 else "C_in=F") +
                        " bf16"] = (args, layout)
            h = y
        e = float((model(norm) - plain_tower(model, (left, right))).abs()
                  .max())
        print(f"[mccnn] {arch} bf16 tower: max |kernel - plain| = {e} "
              f"({card})")
        check(e <= 1e-2, f"MC-CNN {arch} bf16 tower: {e} > 1e-2")
        # use_bf16=True on the float32 model: its bfloat16 twin, made once,
        # computes the bfloat16 model's volume on the same kernels
        D_mc = mc_cfg.num_disparities
        want_vol = mccnn_cost_volume(model, left, right, D_mc)
        twin = models[arch].bf16_twin()
        K.reset_launches()
        vol16 = mccnn_cost_volume(models[arch], left, right, D_mc,
                                  use_bf16=True)
        torch.cuda.synchronize()
        c = {k: v for k, v in K.launches.items() if v}
        check(models[arch].bf16_twin() is twin and torch.equal(vol16,
                                                              want_vol),
              f"MC-CNN {arch} use_bf16=True: the float32 model's twin is "
              f"made once and equals the bfloat16 model's volume")
        check(c == {"mccnn_conv3x3": model.num_layers - 1,
                    "mccnn_fused_volume": 1},
              f"MC-CNN {arch} use_bf16=True launches {c}")
        print(f"[mccnn] {arch} use_bf16=True on the float32 model: the "
              f"bfloat16 model's volume bit for bit, launches {c} ({card})")
        del want_vol, vol16
    del h, y
    # K11 (the last layer, its norm and the volume in one launch) on both
    # towers in both modes, against the two-kernel path and its plain
    # version
    err["mccnn_fused_volume"] = err["mccnn_fused_volume bf16"] = 0.0
    k11_args = {}   # (arch, mode) -> K11's arguments, for the timing
    for arch in models:
        for mode, model in (("float32", models[arch]),
                            ("bf16", models16[arch])):
            e, k11_args[arch, mode] = k11_check(model, norm, KITTI["D"],
                                                f"{arch} {mode}")
            key = "mccnn_fused_volume" + (" bf16" if mode == "bf16" else "")
            err[key] = max(err[key], e)
    mc16_counts, providers16 = {}, {}
    for arch, model in models16.items():
        providers16[arch] = MCCNNCost(model, mc_cfg)
        matcher = StereoMatcher(mc_cfg, cost_fn=providers16[arch],
                                device=dev)
        K.reset_launches()
        mc_raw, _ = matcher(left_np, right_np)
        torch.cuda.synchronize()
        c = mc16_counts[arch] = dict(K.launches)
        print(f"[mccnn] {arch} bf16 {label(KITTI)} launches {c} ({card})")
        want = {name: 0 for name in c}
        want.update(mccnn_conv3x3=model.num_layers - 1,
                    mccnn_fused_volume=1, sgm_path_scan=mc_cfg.num_paths,
                    wta_lr=1)
        check(c == want, f"MC-CNN {arch} bf16 launch counts {c} != {want}")
        share = agreement(mc_raw, plain_mccnn_path(left, right, mc_cfg, model))
        check(share >= MC_BF16_AGREE, f"MC-CNN {arch} bf16: {share} of the "
              f"pixels agree with the plain path (< {MC_BF16_AGREE})")
        quality = {}
        for name, frame in (("clean", (left_np, right_np)),
                            ("noise=25", noisy_np)):
            d = mc_raw if name == "clean" else matcher(*frame)[0]
            quality[name] = (float(bad_pixel_rate(d, gt, 3.0, 0.0)),
                             float(density(d)))
        print(f"[mccnn] {arch} bf16 {label(KITTI)}: {share} of the pixels "
              f"agree with the plain bf16 path; (bad-3px, density) clean "
              f"{quality['clean']}, noise=25 {quality['noise=25']}; float32 "
              f"clean {mc_quality[arch]['clean']}, noise=25 "
              f"{mc_quality[arch]['noise=25']}; census on the noisy frame "
              f"{census_noisy_q} ({card})")
        (bad3, dens), (nbad3, ndens) = quality["clean"], quality["noise=25"]
        check(bad3 < 0.05 and dens > 0.8, f"MC-CNN {arch} bf16 clean: "
              f"bad-3px {bad3} < 0.05 and density {dens} > 0.8")
        check(ndens > census_noisy_q[1] and ndens > 0.9 and nbad3 < 0.05,
              f"MC-CNN {arch} bf16 noise=25: density {ndens} above census "
              f"{census_noisy_q[1]} and 0.9, bad-3px {nbad3} < 0.05")
    # K9 stays on the MC-CNN path where K11 does not apply: min_d 4 (and
    # D not a multiple of 128, the 720p frames of phase 5)
    mc4_cfg = mc_cfg.replace(min_disparity=4)
    K.reset_launches()
    mc_raw, _ = StereoMatcher(mc4_cfg, cost_fn=MCCNNCost(models["fast"],
                                                         mc4_cfg),
                              device=dev)(left_np, right_np)
    torch.cuda.synchronize()
    mc4_counts = dict(K.launches)
    want = {name: 0 for name in mc4_counts}
    want.update(mccnn_conv3x3=models["fast"].num_layers, mccnn_volume=1,
                sgm_path_scan=mc4_cfg.num_paths, wta_lr=1)
    check(mc4_counts == want, f"MC-CNN fast min_d=4 launch counts "
          f"{mc4_counts} != {want}")
    share = agreement(mc_raw, plain_mccnn_path(left, right, mc4_cfg,
                                               models["fast"]))
    print(f"[mccnn] fast min_d=4 {label(KITTI)} (K8 x 4 -> K9): launches "
          f"{ {k: v for k, v in mc4_counts.items() if v} }, {share} of the "
          f"pixels agree with the plain path ({card})")
    check(share >= MC_AGREE, f"MC-CNN fast min_d=4: {share} of the pixels "
          f"agree with the plain path (< {MC_AGREE})")
    del mc_raw, census_noisy, noisy_l, noisy_r

    # 4e. int16 volumes, the row-tiled SGM and the stage-pipelined stream
    D = KITTI["D"]
    p1, p2 = cfg.P1, cfg.P2
    wT = words.transpose(2, 3).contiguous()          # (2, 1, W, H) words
    vol16 = K.census_volume(words[0], words[1], D, 0, torch.int16)
    check(torch.equal(vol16, K.census_volume_plain(
        words[0], words[1], D, 0, torch.int16)), "K2 int16 bit-equal")
    volT = K.census_volume(wT[0], wT[1], D, transposed=True)
    check(torch.equal(volT, K.census_volume_plain(wT[0], wT[1], D, 0,
                                                  transposed=True)),
          "K2 transposed bit-equal")
    check(torch.equal(K.census_volume(wT[0], wT[1], D, 0, torch.int16, True),
                      vol16.transpose(1, 2)), "K2 int16 transposed")
    total16 = aggregate(K.sgm_path_scan, vol16, cfg)
    check(torch.equal(total16, aggregate(K.sgm_path_scan_plain, vol16, cfg)),
          "K3 int16 totals bit-equal")
    print(f"[4e] K2 int16 and transposed, K3 int16 totals: bit-equal to the "
          f"plain versions ({label(KITTI)}; {card})")

    rows_mesh = make_mesh(1, 4, devices=[dev] * 4)
    shards = [hi - lo for lo, hi in volume_sharding(rows_mesh).bounds(
        KITTI["H"], 8)]
    check(shards == [96, 96, 96, 87], f"row shards {shards}")
    K.reset_launches()
    exact = sgm_aggregate_sharded(vol, p1, p2, rows_mesh, 8, "exact")
    torch.cuda.synchronize()
    tiling_counts = dict(K.launches)
    exact_counts(tiling_counts, {"sgm_path_scan": 8 * 4}, "tiling (8 "
                 "directions x 4 shards)")
    check(torch.equal(exact, total), "K3 carry chain over 4 row shards "
          "bit-equal to the whole-frame total")
    check(torch.equal(exact, sgm_aggregate_sharded(
        vol, p1, p2, rows_mesh, 8, "exact", scan=K.sgm_path_scan_plain)),
        "K3 carry chain bit-equal to the plain chain")
    check(torch.equal(sgm_aggregate_sharded(vol16, p1, p2, rows_mesh, 8,
                                            "exact"), total16),
          "K3 int16 carry chain over 4 row shards bit-equal to the "
          "whole-frame int16 total")
    halo = sgm_aggregate_sharded(vol, p1, p2, rows_mesh, 8, "halo", 48)
    halo_agree = float((halo.argmin(0) == total.argmin(0)).float().mean())
    check(halo_agree >= 0.985, f"halo argmin agreement {halo_agree}")
    print(f"[4e] sgm_aggregate_sharded on {list(rows_mesh.devices.ravel())}, "
          f"row shards {shards}: exact bit-equal to the whole-frame K3 total "
          f"and to the plain chain, int16 too; halo 48 argmin agreement "
          f"{halo_agree}; "
          f"launches {tiling_counts} ({card})")
    del exact, halo

    err["census_scan"] = 0.0
    for min_d in (0, 5):
        vol_d = K.census_volume(words[0], words[1], D, min_d)
        for reverse in (False, True):
            dx = -1 if reverse else 1
            pair = K.sgm_path_scan(vol_d, torch.empty_like(vol_d), 0, dx, p1,
                                   p2, False)
            for invalid in (1e4, 1024.0):
                args = (words[0], words[1], torch.empty_like(vol_d), min_d,
                        p1, p2, reverse, invalid, False)
                got = K.census_scan(*args)
                want = K.census_scan_plain(*args)
                err["census_scan"] = max(err["census_scan"],
                                         float((got - want).abs().max()))
                check(torch.equal(got, want), f"K10 min_d={min_d} "
                      f"reverse={reverse} invalid={invalid} bit-equal")
                if invalid == 1e4:
                    check(torch.equal(got, pair), f"K10 min_d={min_d} "
                          f"reverse={reverse} equals K2 + K3 (0, {dx})")
    del vol_d, pair, got, want
    print(f"[4e] K10 census_scan: bit-equal to its plain version (forward "
          f"and reverse, invalid 1e4 and 1024, min_d 0 and 5) and, at 1e4, "
          f"to K2 + K3's horizontal pair ({label(KITTI)}; {card})")

    wta16 = K.wta_lr(total16, *wta_args)
    same_disparity(wta16[0], K.wta_lr_plain(total16, *wta_args)[0],
                   "K4 int16 wta_lr")
    err["wta_stats"] = err["right_wta"] = 0.0
    fast_stats = K.wta_stats(total)
    fast_disp, _ = disparity_from_stats(fast_stats, D, *wta_args[:2],
                                        cfg.subpixel)
    fast_right = (K.right_wta(total) + cfg.min_disparity).float()
    for tol in (cfg.disp12_max_diff, 0, 3):
        a = K.lr_mask(fast_disp, fast_right, tol)
        b = K.lr_mask_plain(fast_disp, fast_right, tol)
        err["lr_mask"] = max(err.get("lr_mask", 0),
                             int((a.int() - b.int()).abs().max()))
        check(torch.equal(a, b), f"K4 lr_mask tol={tol} bit-equal")
    for t in (total, total16):
        for a, b in zip(K.wta_stats(t), K.wta_stats_plain(t)):
            err["wta_stats"] = max(err["wta_stats"],
                                   float((a.float() - b.float()).abs().max()))
            check(torch.equal(a, b), f"K4 wta_stats {t.dtype} bit-equal")
        a, b = K.right_wta(t), K.right_wta_plain(t)
        err["right_wta"] = max(err["right_wta"], int((a - b).abs().max()))
        check(torch.equal(a, b), f"K4 right_wta {t.dtype} bit-equal")
    for spec in (KITTI, ARKIT_720P):
        k4_ties(spec, torch.int16, seed=9)
    K.reset_launches()
    fast = K.extract_disparity_fast(total, *wta_args)
    torch.cuda.synchronize()
    fast_counts = dict(K.launches)
    exact_counts(fast_counts, {"wta_stats": 1, "right_wta": 1, "lr_mask": 1},
                 "extract_disparity_fast")
    same_disparity(fast, disp, "extract_disparity_fast vs K4 wta_lr")
    print(f"[4e] K4 int16 wta_lr, wta_stats and right_wta (float32 and "
          f"int16), lr_mask (tol {cfg.disp12_max_diff}, 0, 3) equal to their "
          f"plain versions; extract_disparity_fast equals wta_lr's map; "
          f"launches {fast_counts} ({card})")

    frames = [scene({**KITTI, "seed": s}) for s in range(1, 7)]
    stream_counts = {}
    n = len(frames)
    stream_want = {   # K3: 8 directions a frame, K10 taking 2 of them
        "volume": {"census_words": n, "census_volume": n,
                   "sgm_path_scan": 8 * n, "wta_lr": n},
        "census": {"census_words": n, "census_scan": 2 * n,
                   "census_volume": 2 * n, "sgm_path_scan": 6 * n,
                   "wta_lr": n}}

    stages = spread(4)
    stage_cards = sorted(set(stages), key=lambda d: d.index)
    on_stages = f"on {[str(d) for d in stages]}"

    def stream(mode, wire, n_stages=4, config=cfg, clamp=None):
        mesh = make_stage_mesh(n_stages, devices=stages[:n_stages])
        return StreamingPipeline(config, mesh, (KITTI["H"], KITTI["W"]),
                                 payload_mode=mode, payload_dtype=wire,
                                 _invalid_clamp=clamp)

    refs = [_match_core(lf, rf, cfg)[0] for lf, rf, _ in frames]
    pairs = [(lf, rf) for lf, rf, _ in frames]
    for mode in ("volume", "census"):
        pipe = stream(mode, "float32")
        K.reset_launches()
        outs = pipe.run(pairs)
        for d in stage_cards:
            torch.cuda.synchronize(d)
        c = stream_counts[mode] = dict(K.launches)
        exact_counts(c, stream_want[mode], f"{mode} stream")
        check(len(outs) == len(frames), f"{mode} stream: one result a frame")
        for i, ((raw, _), ref) in enumerate(zip(outs, refs)):
            bit_equal(raw, ref, f"{mode} stream frame {i} vs _match_core")
        clamped = stream(mode, "float32", clamp=1024.0).run(pairs)
        for i, ((raw, filt), (r16, f16)) in enumerate(
                zip(clamped, stream(mode, "int16").run(pairs))):
            bit_equal(r16, raw, f"{mode} int16 wire frame {i}")
            bit_equal(f16, filt, f"{mode} int16 wire frame {i} filtered")
        print(f"[4e] StreamingPipeline 4 stages {on_stages}, {mode} payload, "
              f"{len(frames)} frames {label(KITTI)}: float32 wire bit-equal "
              f"to _match_core frame by frame; int16 wire bit-equal to the "
              f"float32 run with the 1024 sentinel; launches {c} ({card})")
    del outs, clamped
    e_raw = e_filt = 0.0
    post = stream("volume", "float32", 2, spk_wls).run(pairs[:3])
    for (raw, filt), (lf, rf) in zip(post, pairs):
        raw, filt = raw.to(dev), filt.to(dev)
        ref_raw, ref_filt = _match_core(lf, rf, spk_wls)
        check(torch.equal(torch.isnan(raw), torch.isnan(ref_raw)),
              "2-stage stream with speckle + WLS: raw NaN masks")
        e_raw = max(e_raw, float((raw - ref_raw).abs().nan_to_num(0.0).max()))
        e_filt = max(e_filt, float((filt - ref_filt).abs().max()))
    check(e_raw <= 1e-5 and e_filt <= 5e-3, f"2-stage stream with speckle + "
          f"WLS: raw {e_raw}, filtered {e_filt}")
    print(f"[4e] 2-stage stream with speckle {SPECKLE['T']} + WLS: raw max "
          f"|diff| {e_raw}, filtered {e_filt} against _match_core (bounds "
          f"1e-5, 5e-3; {card})")
    del post

    cfg16 = cfg.replace(dtype="int16")
    K.reset_launches()
    raw16, _ = StereoMatcher(cfg16, device=dev)(left_np, right_np)
    torch.cuda.synchronize()
    int16_counts = dict(K.launches)
    exact_counts(int16_counts, {"census_words": 1, "census_volume": 1,
                                "sgm_path_scan": cfg.num_paths, "wta_lr": 1},
                 "int16 matcher")
    raw32 = _match_core(left, right, cfg)[0]
    clamped32 = K.wta_lr(aggregate(K.sgm_path_scan, vol.clamp(max=1024.0),
                                   cfg), *wta_args)[0]
    bit_equal(raw16, clamped32, "int16 matcher vs the float32 path with "
              "the 1024 sentinel")
    bit_equal(raw16[:, D:], raw32[:, D:], "int16 matcher vs float32 for "
              "x >= D")
    edge = int((~((raw16 == raw32) | (torch.isnan(raw16) & torch.isnan(raw32)))
                ).sum())
    bit_equal(raw16, plain_path(left, right, cfg16), "int16 matcher vs its "
              "plain path")
    print(f"[4e] StereoMatcher(dtype='int16') {label(KITTI)}: bit-equal to "
          f"its plain path and to the float32 path with the 1024 sentinel; "
          f"equal to the float32 matcher for x >= D, {edge} pixels differ "
          f"left of x = D (the sentinel enters the subpixel parabola); "
          f"launches {int16_counts} ({card})")
    del raw16, raw32, clamped32

    # 4f. the reference's other matchers at KITTI D=128, seed-1 scene
    check(native.available(), "the native library (Delaunay, plane "
          "rasterization) built with g++")
    def quality(d):
        return float(bad_pixel_rate(d, gt, 3.0, 0.0)), float(density(d))

    other_cfgs = {   # name -> (config, launches of one frame)
        "census 7x9": (cfg.replace(census_window=WIDE),
                       {"census_words": 1, "census_volume": 1,
                        "sgm_path_scan": 8, "wta_lr": 1}),
        "bt_sgm8": (cfg.replace(cost="bt"),
                    {"sgm_path_scan": 8, "wta_lr": 1}),
        "sad_bm_wta": (cfg.replace(cost="sad", num_paths=2, p1=1.0, p2=2.0),
                       {"sgm_path_scan": 2, "wta_lr": 1}),
    }
    other_counts, other_frames = {}, {}   # name -> counts; (run, plain) fns
    for name, (ocfg, want) in other_cfgs.items():
        matcher = StereoMatcher(ocfg, device=dev)
        K.reset_launches()
        o_raw, _ = matcher(left_np, right_np)
        torch.cuda.synchronize()
        c = other_counts[name] = dict(K.launches)
        exact_counts(c, want, name)
        o_ref = plain_path(left, right, ocfg)
        e = same_disparity(o_raw, o_ref, f"{name} vs its plain path")
        share = agreement(o_raw, o_ref)
        print(f"[4f] {name} {label(KITTI)}: launches {c}; max |kernel - "
              f"plain| = {e}, agreement {share}; (bad-3px, density) "
              f"{quality(o_raw)}; JAX on a CPU: not measured ({card})")
        check(bool(torch.isfinite(o_raw).any()), f"{name}: valid pixels")
        other_frames[name] = (
            lambda ocfg=ocfg: _match_core(left, right, ocfg),
            lambda ocfg=ocfg: plain_path(left, right, ocfg))
    del o_raw, o_ref

    bm_kw = dict(num_disparities=D, block_size=21, disp12_max_diff=-1)
    K.reset_launches()
    bm = block_matching.block_match(left_np, right_np, device=dev, **bm_kw)
    torch.cuda.synchronize()
    c = other_counts["stereobm_true"] = dict(K.launches)
    exact_counts(c, {"wta_lr": 1}, "stereobm_true")
    with plain_kernels(block_matching, "wta_lr"):
        bm_ref = block_matching.block_match(left, right, device=dev, **bm_kw)
    e = same_disparity(bm, bm_ref, "stereobm_true vs its plain path")
    print(f"[4f] stereobm_true (block 21, disp12 -1) {label(KITTI)}: launches "
          f"{c}; max |kernel - plain| = {e}, agreement "
          f"{agreement(bm, bm_ref)}; (bad-3px, density) {quality(bm)}; JAX on "
          f"a CPU: not measured ({card})")
    check(bool(torch.isfinite(bm).any()), "stereobm_true: valid pixels")

    def plain_bm():
        with plain_kernels(block_matching, "wta_lr"):
            return block_matching.block_match(left, right, device=dev,
                                              **bm_kw)
    other_frames["stereobm_true"] = (
        lambda: block_matching.block_match(left, right, device=dev, **bm_kw),
        plain_bm)
    del bm, bm_ref

    ecfg = elas.ElasConfig()
    elas_kernels = ("census_words", "census_volume", "wta_stats",
                    "right_wta", "lr_mask")

    def run_elas(lft, rgt):
        return elas.elas_match(lft, rgt, D, cfg=ecfg, return_support=True,
                               return_matched=True, device=dev)

    def plain_elas(lft, rgt):
        with plain_kernels(elas, *elas_kernels):
            return run_elas(lft, rgt)
    K.reset_launches()
    e_disp, e_sup, e_matched = run_elas(left_np, right_np)
    torch.cuda.synchronize()
    c = other_counts["elas"] = dict(K.launches)
    exact_counts(c, {"census_words": 1, "census_volume": 1 + D,
                     "wta_stats": 1, "right_wta": 1, "lr_mask": 2}, "elas")
    r_disp, r_sup, r_matched = plain_elas(left_np, right_np)
    check(np.array_equal(e_sup, r_sup), "elas: the same support points as "
          "its plain path")
    e_disp, e_matched, r_disp, r_matched = (
        torch.from_numpy(a).to(dev) for a in (e_disp, e_matched, r_disp,
                                              r_matched))
    share = agreement(e_disp, r_disp)
    check(share >= MC_AGREE, f"elas: {share} of the pixels agree with its "
          f"plain path (< {MC_AGREE})")
    print(f"[4f] elas ElasConfig() {label(KITTI)}: launches {c}; "
          f"{len(e_sup)} support points, equal to the plain path's; "
          f"agreement {share} (matched map {agreement(e_matched, r_matched)}, "
          f"max |diff| {float((e_disp - r_disp).abs().nan_to_num(0.0).max())}"
          f"); (bad-3px, density) {quality(e_disp)}, matched map "
          f"{quality(e_matched)}; JAX on a CPU: not measured ({card})")
    other_frames["elas"] = (lambda: run_elas(left_np, right_np),
                            lambda: plain_elas(left_np, right_np))
    del e_disp, e_matched, r_disp, r_matched

    cfg79 = other_cfgs["census 7x9"][0]
    pipe = stream("volume", "float32", config=cfg79)
    K.reset_launches()
    outs = pipe.run(pairs[:3])
    for d in stage_cards:
        torch.cuda.synchronize(d)
    c = other_counts["stream 7x9"] = dict(K.launches)
    exact_counts(c, {"census_words": 3, "census_volume": 3,
                     "sgm_path_scan": 24, "wta_lr": 3}, "7x9 volume stream")
    # P1 = 62/3 is fractional: the total depends on the order the paths are
    # added in, by stage in the stream, PATH_DIRECTIONS_8's in _match_core
    stage_order = PATH_DIRECTIONS_8[:2] + DOWN + UP
    e79, share79 = 0.0, 1.0
    for i, ((raw, _), (lf, rf)) in enumerate(zip(outs, pairs)):
        raw = raw.to(dev)
        vol79 = census_cost(lf, rf, cfg79)
        total79 = torch.empty_like(vol79)
        for j, (dy, dx) in enumerate(stage_order):
            K.sgm_path_scan_plain(vol79, total79, dy, dx, cfg79.P1, cfg79.P2,
                                  j > 0)
        bit_equal(raw, K.wta_lr_plain(total79, *wta_args)[0],
                  f"7x9 volume stream frame {i} vs its paths added in its "
                  f"order")
        ref79 = _match_core(lf, rf, cfg79)[0]
        share79 = min(share79, agreement(raw, ref79))
        e79 = max(e79, float((raw - ref79).abs().nan_to_num(0.0).max()))
    check(share79 >= STREAM_AGREE, f"7x9 volume stream: {share79} of the "
          f"pixels agree with _match_core (< {STREAM_AGREE})")
    print(f"[4f] StreamingPipeline 4 stages {on_stages}, volume payload, "
          f"census {WIDE}, 3 frames {label(KITTI)}: bit-equal to the plain "
          f"scans added in the stream's order; against _match_core "
          f"{share79} of the pixels agree, max |diff| {e79} (P1 = "
          f"{cfg79.P1}); launches {c} "
          f"({card})")
    del outs, pipe, vol79, total79, ref79

    # 4g. monodepth on the card, then smt-torch's subcommands in-process
    phase_4g(dev, card, (left_np, right_np))
    # 4h. training on the card, the training CLI and calibration
    phase_4h(dev, card)
    # 4i. multi-device: D-sharding, multihost, the MC-CNN mesh trainer
    phase_4i(dev, card)
    # 4j. the accuracy record's blocks at full size against cv2
    phase_4j(dev, card)

    # 5. timing (CUDA events, after a warm-up)
    # K1 takes less time than the host's call: its `ms` is the events' mean
    # over 50 back-to-back calls, as every other row's, which the host
    # bounds; the mean of 64 launches in one CUDA graph is the kernel's own
    # time, kept apart as the row's `graph_ms`
    imgs7 = torch.stack([left7, right7]).contiguous()
    k1_ev, k1_graph = {}, {}
    for name, (im, win) in {"KITTI 5x5": (imgs, (5, 5)),
                            "720p 5x5": (imgs7, (5, 5)),
                            "KITTI 7x9": (imgs, WIDE)}.items():
        k1_ev[name] = t_ev = cuda_ms(lambda: K.census_words(im, win), 50)
        k1_graph[name] = t = graph_ms(lambda: K.census_words(im, win), 64)
        k1_b = bound(im.numel() * 4 * (1 + K.n_census_words(win)))
        print(f"[timing] census_words {name} {tuple(im.shape)}: {t_ev} ms by "
              f"events over back-to-back calls, {t} ms a launch (CUDA graph "
              f"of 64); bound {k1_b[0]} ms ({k1_b[1]}), {k1_b[0] / t} of it "
              f"in the graph ({card})")
    del imgs7
    ms["census_words"] = k1_ev["KITTI 5x5"]
    graph = {"census_words": k1_graph["KITTI 5x5"],
             "census_words 7x9": k1_graph["KITTI 7x9"]}
    plain_ms["census_words"] = cuda_ms(lambda: K.census_words_plain(imgs), 5)
    ms["census_volume"] = cuda_ms(
        lambda: K.census_volume(words[0], words[1], cfg.num_disparities), 20)
    plain_ms["census_volume"] = cuda_ms(
        lambda: K.census_volume_plain(words[0], words[1],
                                      cfg.num_disparities), 3)
    n_paths = cfg.num_paths
    ms["sgm_path_scan"] = cuda_ms(
        lambda: aggregate(K.sgm_path_scan, vol, cfg), 10) / n_paths
    plain_ms["sgm_path_scan"] = cuda_ms(
        lambda: aggregate(K.sgm_path_scan_plain, vol, cfg), 2) / n_paths
    def k3_per_direction(cost, what):
        """K3 a direction, adding into a total: time, rate, bound share."""
        scratch = torch.zeros_like(cost)
        nbytes = 3 * cost.numel() * cost.element_size()
        floor_ms = bound(nbytes)[0]
        for dy, dx in PATH_DIRECTIONS_8:
            t = cuda_ms(lambda: K.sgm_path_scan(cost, scratch, dy, dx, cfg.P1,
                                                cfg.P2, accumulate=True), 10)
            print(f"[timing] sgm_path_scan {what} direction {(dy, dx)}: {t} "
                  f"ms, {nbytes / t / 1e6} GB/s, {floor_ms / t} of its "
                  f"{floor_ms} ms bound ({nbytes} B) ({card})")

    k3_per_direction(vol, f"float32 {label(KITTI)}")
    ms["wta_lr"] = cuda_ms(lambda: K.wta_lr(total, *wta_args), 20)
    plain_ms["wta_lr"] = cuda_ms(lambda: K.wta_lr_plain(total, *wta_args), 3)
    # 4e timing: int16 and transposed K2, K10 against K3's horizontal
    # directions, K3 per row shard, the tiling, the stream, int16 memory
    t16 = cuda_ms(lambda: K.census_volume(words[0], words[1], D, 0,
                                          torch.int16), 20)
    t16_plain = cuda_ms(lambda: K.census_volume_plain(
        words[0], words[1], D, 0, torch.int16), 3)
    tT = cuda_ms(lambda: K.census_volume(wT[0], wT[1], D, transposed=True),
                 20)
    tT_plain = cuda_ms(lambda: K.census_volume_plain(wT[0], wT[1], D, 0,
                                                     transposed=True), 3)
    print(f"[timing] census_volume {label(KITTI)}: int16 kernel {t16} ms, "
          f"plain {t16_plain} ms; transposed (D, W, H) float32 kernel {tT} "
          f"ms, plain {tT_plain} ms; planes float32 kernel "
          f"{ms['census_volume']} ms ({card})")
    scratch = torch.empty_like(vol)
    k10, k10_plain = [], []
    for reverse in (False, True):
        dx = -1 if reverse else 1
        k10.append(cuda_ms(lambda: K.census_scan(
            words[0], words[1], scratch, 0, p1, p2, reverse, 1e4, True), 20))
        k10_plain.append(cuda_ms(lambda: K.census_scan_plain(
            words[0], words[1], scratch, 0, p1, p2, reverse, 1e4, True), 2))
        k3 = cuda_ms(lambda: K.sgm_path_scan(vol, scratch, 0, dx, p1, p2,
                                             True), 20)
        print(f"[timing] census_scan direction (0, {dx}) {label(KITTI)}: "
              f"kernel {k10[-1]} ms, plain {k10_plain[-1]} ms; K3 on K2's "
              f"volume {k3} ms ({card})")
    ms["census_scan"] = sum(k10) / 2
    plain_ms["census_scan"] = sum(k10_plain) / 2
    k3_per_direction(vol16, f"int16 {label(KITTI)}")
    t3_16 = cuda_ms(lambda: aggregate(K.sgm_path_scan, vol16, cfg), 10)
    t4_16 = cuda_ms(lambda: K.wta_lr(total16, *wta_args), 20)
    print(f"[timing] int16 {label(KITTI)}: K3 8 directions {t3_16} ms "
          f"({t3_16 / 8} per direction), K4 wta_lr {t4_16} ms ({card})")
    k4_int16 = {"wta_lr": t4_16}
    for name, fn, plain in (("wta_stats", K.wta_stats, K.wta_stats_plain),
                            ("right_wta", K.right_wta, K.right_wta_plain)):
        ms[name] = cuda_ms(lambda: fn(total), 20)
        plain_ms[name] = cuda_ms(lambda: plain(total), 3)
        t = k4_int16[name] = cuda_ms(lambda: fn(total16), 20)
        print(f"[timing] {name} {label(KITTI)}: float32 {ms[name]} ms, "
              f"int16 {t} ms, plain {plain_ms[name]} ms ({card})")
    # K2 and K4 at the main path's shapes beside their bounds (each input
    # read once, each output written once), and two streaming passes over
    # the same bytes as yardsticks: a write of the float32 volume and a read
    # of the total. Neither computes the kernels' function (no library_ms).
    hw = KITTI["H"] * KITTI["W"]
    vol_f32 = KITTI["D"] * hw * 4
    t_zero = cuda_ms(lambda: torch.empty_like(vol).zero_(), 20)
    t_amin = cuda_ms(lambda: total.amin(0), 20)
    print(f"[yardstick] {label(KITTI)} float32, {vol_f32} B: "
          f"torch.empty_like(vol).zero_() {t_zero} ms ({vol_f32 / t_zero / 1e6}"
          f" GB/s); total.amin(0) {t_amin} ms ({vol_f32 / t_amin / 1e6} GB/s)"
          f" ({card})")
    k2_d1 = graph_ms(lambda: K.census_volume(words[0], words[1], 1, 64), 128)
    k24_rows = {   # name -> (ms, (bound_ms, bound_by))
        "census_volume float32": (ms["census_volume"],
                                  bound(2 * hw * 4 + vol_f32)),
        "census_volume int16": (t16, bound(2 * hw * 4 + vol_f32 / 2)),
        "census_volume transposed float32": (tT,
                                             bound(2 * hw * 4 + vol_f32)),
        "census_volume transposed int16": (
            cuda_ms(lambda: K.census_volume(wT[0], wT[1], D, 0, torch.int16,
                                            True), 20),
            bound(2 * hw * 4 + vol_f32 / 2)),
        "census_volume 7x9 float32": (
            cuda_ms(lambda: K.census_volume(words79[0], words79[1], D), 20),
            bound(2 * 2 * hw * 4 + vol_f32)),
        "census_volume D=1 min_d=64 (one CUDA graph of 128 launches)": (
            k2_d1, bound(2 * hw * 4 + hw * 4)),
        "wta_lr float32": (ms["wta_lr"], bound(vol_f32 + 2 * hw * 4)),
        "wta_lr int16": (t4_16, bound(vol_f32 / 2 + 2 * hw * 4)),
        "wta_stats float32": (ms["wta_stats"], bound(vol_f32 + 5 * hw * 4)),
        "wta_stats int16": (k4_int16["wta_stats"],
                            bound(vol_f32 / 2 + 5 * hw * 4)),
        "right_wta float32": (ms["right_wta"], bound(vol_f32 + hw * 4)),
        "right_wta int16": (k4_int16["right_wta"],
                            bound(vol_f32 / 2 + hw * 4)),
    }
    for name, (t, (b_ms, b_by)) in k24_rows.items():
        print(f"[k2k4] {name} {label(KITTI)}: {t} ms, bound {b_ms} ms "
              f"({b_by}) = {b_ms / t} of it ({card})")
    words7 = K.census_words(torch.stack([left7, right7]).contiguous())
    hw7 = ARKIT_720P["H"] * ARKIT_720P["W"]
    vol7_f32 = ARKIT_720P["D"] * hw7 * 4
    for dt, size in ((torch.float32, 1.0), (torch.int16, 0.5)):
        vol7 = K.census_volume(words7[0], words7[1], ARKIT_720P["D"], 0, dt)
        total7 = aggregate(K.sgm_path_scan, vol7, cfg7)
        for name, fn, maps in (   # maps: (H, W) words read or maps written
                ("census_volume", lambda: K.census_volume(
                    words7[0], words7[1], ARKIT_720P["D"], 0, dt), 2),
                ("wta_lr", lambda: K.wta_lr(total7, *wta_args), 2),
                ("wta_stats", lambda: K.wta_stats(total7), 5),
                ("right_wta", lambda: K.right_wta(total7), 1)):
            t = cuda_ms(fn, 10)
            b_ms, b_by = bound(vol7_f32 * size + maps * hw7 * 4)
            print(f"[k2k4] {name} {dt} {label(ARKIT_720P)}: {t} ms, bound "
                  f"{b_ms} ms ({b_by}) = {b_ms / t} of it ({card})")
        del vol7, total7
    del words7
    tol = cfg.disp12_max_diff
    ms["lr_mask"] = cuda_ms(lambda: K.lr_mask(fast_disp, fast_right, tol), 20)
    plain_ms["lr_mask"] = cuda_ms(
        lambda: K.lr_mask_plain(fast_disp, fast_right, tol), 5)
    print(f"[timing] lr_mask {label(KITTI)}: kernel {ms['lr_mask']} ms, plain "
          f"{plain_ms['lr_mask']} ms ({card})")
    del fast_stats, fast_disp, fast_right

    whole = cuda_ms(lambda: aggregate(K.sgm_path_scan, vol, cfg), 10)
    per_shard = []
    for lo, hi in volume_sharding(rows_mesh).bounds(KITTI["H"], 8):
        piece = vol[:, lo:hi].contiguous()
        piece_total = torch.empty_like(piece)
        piece_carry = torch.zeros((D, KITTI["W"]), device=dev)

        def shard_scans():
            for i, (dy, dx) in enumerate(PATH_DIRECTIONS_8):
                K.sgm_path_scan(piece, piece_total, dy, dx, p1, p2, i > 0,
                                init_carry=piece_carry if dy else None,
                                return_carry=bool(dy))
        per_shard.append(cuda_ms(shard_scans, 10))
    t_exact = cuda_ms(lambda: sgm_aggregate_sharded(vol, p1, p2, rows_mesh,
                                                    8, "exact"), 10)
    t_halo = cuda_ms(lambda: sgm_aggregate_sharded(vol, p1, p2, rows_mesh, 8,
                                                   "halo", 48), 10)
    print(f"[timing] K3 8 directions per row shard {shards}: {per_shard} ms "
          f"(sum {sum(per_shard)}); whole frame {whole} ms; "
          f"sgm_aggregate_sharded on one card: exact {t_exact} ms, halo 48 "
          f"{t_halo} ms ({card})")
    del scratch, piece, piece_total, piece_carry

    matcher_ms = cuda_ms(lambda: _match_core(left, right, cfg), 10)
    for mode in ("volume", "census"):
        for wire in ("float32", "int16"):
            pipe = stream(mode, wire)
            pipe.reset()
            for lf, rf in pairs[:3]:
                pipe.step(lf, rf)                  # fill
            if len(stage_cards) == 1:
                t = cuda_ms(lambda: pipe.step(left, right), 12, warmup=2)
                clock = "CUDA events"
            else:
                t = wall_ms(lambda: pipe.step(left, right), 12, stage_cards)
                clock = "host clock, every card synchronised"
            print(f"[timing] StreamingPipeline 4 stages {on_stages}, {mode} "
                  f"payload, {wire} wire, {label(KITTI)}: {t} ms/frame "
                  f"({clock}) = {1000.0 / t} frames/s; {pipe.wire_bytes()} "
                  f"B a hop; "
                  f"_match_core {matcher_ms} ms/frame = "
                  f"{1000.0 / matcher_ms} frames/s ({card})")
            del pipe
    for name, c in (("float32", cfg), ("int16", cfg16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        _match_core(left, right, c)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
        t = cuda_ms(lambda: _match_core(left, right, c), 10)
        print(f"[timing] {name} volumes {label(KITTI)}: {t} ms/frame, peak "
              f"device memory of the frame {peak} B ({card})")
        if name == "float32":
            peak32 = peak
    check(peak < peak32, f"int16 frame peak {peak} B below float32 {peak32}")
    del vol16, total16, volT, wT

    del vol, vol_ref, total, total_ref

    # K5 (the whole speckle filter, one launch) at KITTI and 720p. Its
    # bound, as every kernel's: d read once and the output written once, 8
    # bytes a pixel. The label words that the sweeps read and write are
    # the kernel's scratch, which the L2 holds; their traffic, (28 + 16 x
    # sweeps) bytes a pixel, is printed beside it, not used as the bound.
    # The filter cut at max_iters=1 gives the cost of a further sweep, both
    # timed in CUDA graphs, since one sweep takes less than the host's
    # call.
    spk_ms, spk_plain_ms, spk_bound = {}, {}, {}
    for name, sp in spk_maps.items():
        n = spk_sweeps[name]
        spk_ms[name] = cuda_ms(lambda: K.speckle_filter(
            sp, SPECKLE["T"], SPECKLE["range"]), 50, warmup=3)
        spk_plain_ms[name] = cuda_ms(lambda: K.speckle_fixpoint_plain(
            sp, SPECKLE["T"], SPECKLE["range"]), 3)
        in_graph = graph_ms(lambda: K.speckle_filter(
            sp, SPECKLE["T"], SPECKLE["range"]), 20)
        one_sweep = graph_ms(lambda: K.speckle_filter(
            sp, SPECKLE["T"], SPECKLE["range"], 1), 20)
        spk_bound[name] = bound(8 * sp.numel())
        traffic_ms = bound((28 + 16 * n) * sp.numel())[0]
        print(f"[timing] K5 speckle_filter {name} {tuple(sp.shape)} "
              f"({n} sweeps, one launch, no host sync): kernel "
              f"{spk_ms[name]} ms, plain {spk_plain_ms[name]} ms; bound "
              f"{spk_bound[name][0]} ms ({spk_bound[name][1]}: d in, out "
              f"out, 8 bytes a pixel) = {spk_bound[name][0] / spk_ms[name]} "
              f"of it; label-word traffic ((28 + 16 x sweeps) bytes a pixel)"
              f" over the memory rate {traffic_ms} ms; in a CUDA graph "
              f"{in_graph} ms, cut at max_iters=1 {one_sweep} ms, so "
              f"{(in_graph - one_sweep) / (n - 1)} ms a further sweep "
              f"({card})")
    # maps whose fixpoint is far: noisy ramps (holes make long, winding
    # components), one of 3300 rows (three bands of the column phase) and
    # the serpentine, each run to its fixpoint
    far = {"KITTI noisy ramp": noisy_ramp(KITTI["H"], KITTI["W"]),
           "720p noisy ramp": noisy_ramp(ARKIT_720P["H"], ARKIT_720P["W"]),
           "3-band noisy ramp": noisy_ramp(3300, 300, seed=3, holes=0.1,
                                           blobs=False),
           "serpentine": serpentine(75, KITTI["W"])}
    for name, m in far.items():
        sp = torch.from_numpy(m).to(dev)
        _, n, unconv, _ = k5_vs_plain(sp, SPECKLE["T"], SPECKLE["range"],
                                      1000, name)
        check(not unconv, f"K5 {name}: converged in {n} sweeps")
        t = cuda_ms(lambda: K.speckle_filter(sp, SPECKLE["T"],
                                             SPECKLE["range"], 1000), 10,
                    warmup=2)
        print(f"[timing] K5 speckle_filter {name} {tuple(sp.shape)} ({n} "
              f"sweeps, bit-equal to the plain filter): kernel {t} ms = "
              f"{t / n} ms a sweep; bound {bound(8 * sp.numel())[0]} ms "
              f"({card})")
    ms["speckle_filter"] = spk_ms["KITTI"]
    plain_ms["speckle_filter"] = spk_plain_ms["KITTI"]
    solve_ms, solve_plain_ms = {}, {}
    for (kind, H_), (f, wp, wn, axis) in k7_args.items():
        solve_ms[kind, H_] = cuda_ms(
            lambda: K.fgs_solve(f, wp, wn, lam, axis), 50)
        solve_plain_ms[kind, H_] = cuda_ms(
            lambda: K.fgs_solve_plain(f, wp, wn, lam, axis), 2)
        print(f"[timing] fgs_solve {kind} solve {tuple(f.shape)}: kernel "
              f"{solve_ms[kind, H_]} ms, plain {solve_plain_ms[kind, H_]} ms "
              f"({card})")
    kitti = [key for key in solve_ms if key[1] == KITTI["H"]]
    ms["fgs_solve"] = sum(solve_ms[key] for key in kitti) / len(kitti)
    plain_ms["fgs_solve"] = sum(solve_plain_ms[key] for key in kitti) / len(
        kitti)
    # library yardstick: torch has no banded solver, so the KITTI column
    # solve as W dense (H, H) systems (0.7 GB), timed, used nowhere
    f, wp, wn, _ = k7_args["column", KITTI["H"]]
    a, b, c = (t.T.contiguous() for t in K._tridiagonal(wp, wn, lam))
    dense = torch.diag_embed(b) + torch.diag_embed(a[:, 1:], -1) + \
        torch.diag_embed(c[:, :-1], 1)                       # (W, H, H)
    rhs = f.permute(2, 1, 0).contiguous()                    # (W, H, 2)
    dense_ms = cuda_ms(lambda: torch.linalg.solve(dense, rhs), 3)
    u_dense = torch.linalg.solve(dense, rhs).permute(2, 1, 0)
    check(bool(torch.isfinite(u_dense).all()), "dense torch.linalg.solve")
    print(f"[timing] fgs_solve column solve {tuple(f.shape)} as {KITTI['W']} "
          f"dense "
          f"({KITTI['H']}, {KITTI['H']}) systems, torch.linalg.solve: "
          f"{dense_ms} ms; its float64 error "
          f"{max_err(u_dense, solve64(f, wp, wn, lam, 0))} px ({card})")
    del dense, rhs, u_dense, a, b, c
    wls_ms = cuda_ms(lambda: wls.wls_filter_disparity(
        disp, left, 80000.0, 1.2, 3), 10)
    wls_plain_ms = cuda_ms(lambda: wls.wls_filter_disparity(
        disp, left, 80000.0, 1.2, 3, solve=K.fgs_solve_plain), 1)
    print(f"[timing] wls_filter_disparity {label(KITTI)} (3 iterations, 6 "
          f"solves): kernels {wls_ms} ms, plain {wls_plain_ms} ms ({card})")
    del spk_maps, sp, k7_args, f, wp, wn

    frame_ms = cuda_ms(lambda: _match_core(left, right, cfg), 20, warmup=2)
    frame7_ms = cuda_ms(lambda: _match_core(left7, right7, cfg7), 10)
    plain_frame_ms = cuda_ms(lambda: plain_path(left, right, cfg), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    _match_core(left, right, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[timing] main path {label(KITTI)}: kernels {frame_ms} ms/frame"
          f" = {1000.0 / frame_ms} frames/s; plain versions {plain_frame_ms} "
          f"ms/frame = {1000.0 / plain_frame_ms} frames/s; peak device memory "
          f"{peak} B, {peak - before} B of it for the frame ({card})")
    print(f"[timing] main path {label(ARKIT_720P)}: kernels {frame7_ms} "
          f"ms/frame = {1000.0 / frame7_ms} frames/s ({card})")

    for name, (spec, lft, rgt, _, pcfg) in post_paths.items():
        t = cuda_ms(lambda: _match_core(lft, rgt, pcfg), 10)
        sweeps = 0
        if pcfg.speckle_window_size > 0:
            wta = _match_core(lft, rgt, pcfg.replace(
                speckle_window_size=0, wls=False))[0]
            sweeps = int(K.speckle_filter(wta, pcfg.speckle_window_size,
                                          pcfg.speckle_range)[1][0])
        print(f"[timing] post-stack path {name} {label(spec)}: {t} ms/frame "
              f"= {1000.0 / t} frames/s; {sweeps} speckle sweeps per frame "
              f"({card})")

    # 4f: the other matchers' frames beside one plain frame each; K1, K2 at
    # 7x9 and lr_mask at ELAS's float tolerance
    for name, (run, plain) in other_frames.items():
        t = cuda_ms(run, 5)
        t_plain = cuda_ms(plain, 1, warmup=0)
        print(f"[timing] {name} {label(KITTI)}: {t} ms/frame = "
              f"{1000.0 / t} frames/s; plain versions {t_plain} ms/frame "
              f"({card})")
    ms["census_words 7x9"] = k1_ev["KITTI 7x9"]
    plain_ms["census_words 7x9"] = cuda_ms(
        lambda: K.census_words_plain(imgs, WIDE), 3)
    ms["census_volume 7x9"] = cuda_ms(
        lambda: K.census_volume(words79[0], words79[1], D), 20)
    plain_ms["census_volume 7x9"] = cuda_ms(
        lambda: K.census_volume_plain(words79[0], words79[1], D), 3)
    t16 = cuda_ms(lambda: K.census_volume(words79[0], words79[1], D, 0,
                                          torch.int16), 20)
    wT79 = words79.transpose(2, 3).contiguous()
    tT = cuda_ms(lambda: K.census_volume(wT79[0], wT79[1], D,
                                         transposed=True), 20)
    tT_plain = cuda_ms(lambda: K.census_volume_plain(wT79[0], wT79[1], D, 0,
                                                     transposed=True), 3)
    print(f"[timing] census_volume {WIDE} (2 words) {label(KITTI)}: float32 "
          f"{ms['census_volume 7x9']} ms, int16 {t16} ms, transposed (D, W, "
          f"H) float32 {tT} ms; plain float32 "
          f"{plain_ms['census_volume 7x9']} ms, transposed {tT_plain} ms "
          f"({card})")
    for name in ("bt_sgm8", "sad_bm_wta"):
        ocfg = other_cfgs[name][0]
        t = cuda_ms(lambda: ClassicCost(ocfg)(left, right), 5)
        print(f"[timing] {name} {label(KITTI)}: the plain torch volume "
              f"builder {t} ms of the frame ({card})")
    lp = block_matching.bm_prefilter_xsobel(left, 31)
    rp = block_matching.bm_prefilter_xsobel(right, 31)
    t = cuda_ms(lambda: block_matching.sad_volume(lp, rp, D, 0, 21), 5)
    print(f"[timing] stereobm_true {label(KITTI)}: the plain torch SAD sums "
          f"(block 21) {t} ms of the frame ({card})")
    del lp, rp
    # ELAS by stage: the device stages by CUDA events, the host stage
    # (support selection, Delaunay, rasterisation) by the host clock
    words_e = elas._census_pair(left, right, (5, 5))
    scores = elas._support_scores(left, right, D, grid_step=ecfg.grid_step,
                                  words=words_e)
    t_sup = cuda_ms(lambda: elas._support_scores(
        left, right, D, grid_step=ecfg.grid_step, words=words_e), 5)
    t0 = time.perf_counter()
    for _ in range(3):
        support = elas.extract_support_points(left, right, ecfg, D,
                                              scores=scores)
        tris = native.delaunay(support[:, :2])
        mu_np = native.rasterize_planes(tris, support, KITTI["H"],
                                        KITTI["W"])
    t_host = (time.perf_counter() - t0) / 3 * 1e3
    t_del = time.perf_counter()
    native.delaunay(support[:, :2])
    t_del = (time.perf_counter() - t_del) * 1e3
    mu = elas._extend_prior(torch.from_numpy(mu_np).to(dev))
    t_ext = cuda_ms(lambda: elas._extend_prior(
        torch.from_numpy(mu_np).to(dev)), 5)
    dense_kw = dict(band_radius=ecfg.band_radius,
                    band_pool_radius=ecfg.band_pool_radius,
                    prior_weight=ecfg.prior_weight,
                    prior_sigma=ecfg.prior_sigma,
                    prior_trunc=ecfg.prior_trunc, lr_tol=ecfg.lr_tol,
                    words=words_e)
    t_dense = cuda_ms(lambda: elas._dense_banded(left, right, mu, D,
                                                 **dense_kw), 3)
    dense = elas._dense_banded(left, right, mu, D, **dense_kw)
    t_fill = cuda_ms(lambda: elas.median_filter(elas.gap_interpolate(
        dense, ecfg.gap_max, ecfg.discont_jump, (left, right),
        ecfg.visibility_thresh), 3), 5)
    print(f"[timing] elas {label(KITTI)} by stage: K1 {ms.get('census_words')}"
          f" ms; support scores (K2 on every {ecfg.grid_step}th row, K4 "
          f"entries) {t_sup} ms; host (selection, Delaunay of "
          f"{len(support)} points, rasterisation) {t_host} ms, of it "
          f"Delaunay {t_del} ms; prior extension {t_ext} ms; dense banded "
          f"stage ({D} planes, K2 a plane, K4 lr_mask) {t_dense} ms; gap "
          f"fill + median {t_fill} ms ({card})")
    del words_e, scores, mu, dense
    lr_tol = ecfg.lr_tol
    ms["lr_mask lr_tol=2.0"] = cuda_ms(
        lambda: K.lr_mask(disp, disp_right, lr_tol), 20)
    plain_ms["lr_mask lr_tol=2.0"] = cuda_ms(
        lambda: K.lr_mask_plain(disp, disp_right, lr_tol), 5)
    del words79, wT79

    # the MC-CNN paths, K8 per layer and K9 (KITTI shape)
    def conv_cudnn(x, w, b):
        with K.fp32_cudnn():
            return torch.nn.functional.conv2d(x, w, b, padding=1)

    k8_layer = {}    # (arch, kind) -> (kernel, plain, library, bound) ms
    k8_last16 = {}   # arch -> the bfloat16 last layer's bound
    for (arch, kind), (args, layout) in k8_args.items():
        x, w = args[0], args[1]
        flop = 2 * 9 * w.shape[0] * w.shape[1] * x.shape[0] * x.shape[2] \
            * x.shape[3]
        nbytes = 4 * (x.numel() + w.numel() + x.shape[0] * w.shape[0]
                      * x.shape[2] * x.shape[3])
        if kind.endswith("bf16"):
            # as the module runs them: bfloat16 channels-last out (these
            # are layers 0 and 1), C_in = F reading bfloat16 channels-last.
            # The library: cuDNN on bfloat16 tensors (made outside the
            # timing), NCHW and channels-last, the faster of the two. The
            # bound: the bytes of this storage (2 B a bfloat16 activation,
            # 4 B the float32 image; the bfloat16 weights) against the
            # products at the bfloat16 rate, beside float32 storage's
            t = cuda_ms(lambda: K.mccnn_conv3x3(*args, layout=layout,
                                                bf16=True, bf16_out=True), 10)
            t_plain = cuda_ms(lambda: K.mccnn_conv3x3_plain(
                *args, bf16=True, bf16_out=True), 10)
            wb, bb = w.to(torch.bfloat16), args[2].to(torch.bfloat16)
            lib_t = {}
            for fmt in (torch.contiguous_format, torch.channels_last):
                xl = x.to(torch.bfloat16, memory_format=fmt)
                wl = wb.contiguous(memory_format=fmt)
                lib_t[str(fmt)] = cuda_ms(lambda: torch.nn.functional.conv2d(
                    xl, wl, bb, padding=1), 10)
                del xl, wl
            t_lib = min(lib_t.values())
            del wb, bb
            px = x.shape[0] * x.shape[2] * x.shape[3]
            nbytes16 = x.numel() * x.element_size() + 2 * w.numel() + \
                2 * px * w.shape[0]
            bf16_ms = bound(nbytes16, flop, "bf16")
            f32_ms = bound(nbytes, flop, "bf16")
            # the last layer reads the same and writes float32 features
            k8_last16[arch] = bound(nbytes16 + 2 * px * w.shape[0], flop,
                                    "bf16")
            k8_layer[arch, kind] = (t, t_plain, t_lib, bf16_ms)
            f32_t = k8_layer[arch, kind[:-len(" bf16")]][0]
            print(f"[timing] mccnn_conv3x3 bf16 {arch} {kind} "
                  f"{tuple(x.shape)} {x.dtype} -> {w.shape[0]} features "
                  f"bfloat16 channels-last: kernel {t} ms ({flop / t / 1e9} "
                  f"TFLOP/s), float32 kernel {f32_t} ms; {bf16_ms[0] / t} "
                  f"of the bound {bf16_ms[0]} ms ({bf16_ms[1]}; "
                  f"{nbytes16} B, products at the bfloat16 rate); with "
                  f"float32 storage the bound was {f32_ms[0]} ms "
                  f"({f32_ms[1]}); plain (cuDNN float32 on rounded operands "
                  f"+ roundings) {t_plain} ms; library F.conv2d (cuDNN, "
                  f"bfloat16 tensors) {t_lib} ms: {lib_t} ({card})")
            continue
        t = cuda_ms(lambda: K.mccnn_conv3x3(*args, layout=layout), 10)
        t_plain = cuda_ms(lambda: K.mccnn_conv3x3_plain(*args), 10)
        t_lib = cuda_ms(lambda: conv_cudnn(*args[:3]), 10)
        tf32_ms = bound(nbytes, 3 * flop, "tf32")
        fp32_ms = bound(nbytes, flop, "fp32")
        k8_layer[arch, kind] = (t, t_plain, t_lib,
                                fp32_ms if kind == "C_in=1" else tf32_ms)
        print(f"[timing] mccnn_conv3x3 {arch} {kind} {tuple(x.shape)} -> "
              f"{w.shape[0]} features: kernel {t} ms ({flop / t / 1e9} "
              f"TFLOP/s); {tf32_ms[0] / t} of the 3xTF32 bound "
              f"{tf32_ms[0]} ms ({tf32_ms[1]}), {fp32_ms[0] / t} of the FP32 "
              f"bound {fp32_ms[0]} ms ({fp32_ms[1]}); plain (cuDNN float32 "
              f"+ activation) {t_plain} ms; library F.conv2d (cuDNN, "
              f"float32) {t_lib} ms ({card})")
    tower_ms = {arch: cuda_ms(lambda: model(norm), 10)
                for arch, model in models.items()}
    tower_plain_ms = {arch: cuda_ms(lambda: plain_tower(model, (left, right)),
                                    5) for arch, model in models.items()}
    tower16_ms = {arch: cuda_ms(lambda: model(norm), 10)
                  for arch, model in models16.items()}
    tower16_plain_ms = {arch: cuda_ms(lambda: plain_tower(
        model, (left, right)), 5) for arch, model in models16.items()}
    k9_bound = {}    # (arch, where) -> the 3xTF32 body's bound
    for (arch, where), args in k9_args.items():
        t = cuda_ms(lambda: K.mccnn_volume(*args), 20)
        t_plain = cuda_ms(lambda: K.mccnn_volume_plain(*args), 3)
        nbytes, flop = k9_work(*args)
        tf32_b = k9_bound[arch, where] = bound(nbytes, 3 * flop, "tf32")
        fp32_b = bound(nbytes, flop, "fp32")
        print(f"[timing] mccnn_volume {arch} {where} F={args[0].shape[0]}: "
              f"kernel {t} ms ({flop / t / 1e9} TFLOP/s), plain {t_plain} "
              f"ms; bound of the 3xTF32 body {tf32_b[0]} ms ({tf32_b[1]}), "
              f"{tf32_b[0] / t} of it; of an FP32 body {fp32_b[0]} ms "
              f"({fp32_b[1]}), {fp32_b[0] / t} of it ({card})")
        if (arch, where) == ("fast", label(KITTI)):
            ms["mccnn_volume"], plain_ms["mccnn_volume"] = t, t_plain
    # K11 beside the two-kernel path it replaces (K8's last launch, then
    # K9), in turns, and its plain version, at KITTI D=128
    k11_bound_ms, k11_share = {}, {}
    for (arch, mode), (args, (x, layout)) in k11_args.items():
        _, w, b, D, scale, _, bf16 = args

        def two_kernel():
            f = K.mccnn_conv3x3(x, w, b, False, True, layout=layout,
                                bf16=bf16)
            return K.mccnn_volume(f[0], f[1], D, 0, scale)

        t = [cuda_ms(lambda: K.mccnn_fused_volume(*args), 10)]
        t_two = [cuda_ms(two_kernel, 10) for _ in range(2)]
        t.append(cuda_ms(lambda: K.mccnn_fused_volume(*args), 10))
        t_plain = cuda_ms(lambda: K.mccnn_fused_volume_plain(
            x, w, b, D, scale, bf16), 3)
        b_ms = k11_bound_ms[arch, mode] = k11_bound(x, w, D)
        t_k11, t_2k = sum(t) / 2, sum(t_two) / 2
        k11_share[f"{arch} {mode}"] = b_ms[0] / t_k11
        print(f"[timing] mccnn_fused_volume {arch} {mode} {tuple(x.shape)} "
              f"{x.dtype} D={D}: K11 {t} ms, mean {t_k11}; K8 last layer + "
              f"K9 {t_two} ms, mean {t_2k}; plain {t_plain} ms; bound "
              f"{b_ms[0]} ms ({b_ms[1]}), {b_ms[0] / t_k11} of it ({card})")
        if arch == "fast":
            key = "mccnn_fused_volume" + (" bf16" if bf16 else "")
            ms[key], plain_ms[key] = t_k11, t_plain
    print(f"[timing] K11's share of k11_bound by tower and mode: "
          f"{json.dumps(k11_share)} ({card})")
    ms["mccnn_conv3x3"] = tower_ms["fast"] / models["fast"].num_layers
    plain_ms["mccnn_conv3x3"] = tower_plain_ms["fast"] / \
        models["fast"].num_layers
    ms["mccnn_conv3x3 bf16"] = tower16_ms["fast"] / models["fast"].num_layers
    plain_ms["mccnn_conv3x3 bf16"] = tower16_plain_ms["fast"] / \
        models["fast"].num_layers
    for arch, provider in providers16.items():
        t = cuda_ms(lambda: _match_core(left, right, mc_cfg, provider), 10)
        t32 = cuda_ms(lambda: _match_core(left, right, mc_cfg,
                                          providers[arch]), 10)
        print(f"[timing] MC-CNN {arch} bf16 path {label(KITTI)}: {t} "
              f"ms/frame = {1000.0 / t} frames/s; float32 path in the same "
              f"run {t32} ms/frame; bf16 tower (K8 x "
              f"{models16[arch].num_layers}) {tower16_ms[arch]} ms against "
              f"float32 {tower_ms[arch]} ms, plain bf16 tower "
              f"{tower16_plain_ms[arch]} ms ({card})")
    for arch, provider in providers.items():
        t = cuda_ms(lambda: _match_core(left, right, mc_cfg, provider), 10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        _match_core(left, right, mc_cfg, provider)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[timing] MC-CNN {arch} path {label(KITTI)}: {t} ms/frame = "
              f"{1000.0 / t} frames/s; tower (K8 x "
              f"{models[arch].num_layers}) {tower_ms[arch]} ms, plain tower "
              f"{tower_plain_ms[arch]} ms; peak device memory {peak} B, "
              f"{peak - before} B of it for the frame ({card})")

    def frame_peak(provider) -> int:
        """The peak device memory of one MC-CNN frame, above what was
        allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        _match_core(left, right, mc_cfg, provider)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - before

    for arch in models:
        for mode, model, provider in (
                ("float32", models[arch], providers[arch]),
                ("bf16", models16[arch], providers16[arch])):
            def two_kernel(l, r, model=model):
                return mccnn_cost_volume_fused(
                    model, l, r, mc_cfg.num_disparities,
                    compute_dtype=model.compute_dtype, single_kernel=False)

            t = {"K11": [], "K8 -> K9": []}
            for name in ("K11", "K8 -> K9", "K8 -> K9", "K11"):
                fn = provider if name == "K11" else two_kernel
                t[name].append(cuda_ms(lambda: _match_core(left, right,
                                                           mc_cfg, fn), 10))
            peak = {name: frame_peak(provider if name == "K11" else
                                     two_kernel) for name in t}
            print(f"[timing] MC-CNN {arch} {mode} frame {label(KITTI)}: "
                  f"one-kernel path (K8 x {model.num_layers - 1} + K11) "
                  f"{t['K11']} ms, two-kernel path (K8 x {model.num_layers} "
                  f"+ K9) {t['K8 -> K9']} ms, in turns; peak device memory "
                  f"of the frame {peak['K11']} B against {peak['K8 -> K9']} "
                  f"B ({card})")

    for name in KERNELS:
        print(f"[timing] {name}: kernel {ms[name]} ms, plain {plain_ms[name]} "
              f"ms per launch ({card})")

    # launches: K1-K4 from the headline run (phase 4), K5-K7 from the KITTI
    # speckle + WLS run (phase 4b), K8 and K11 from the fast MC-CNN run
    # (4d; K11 bf16 from its bfloat16 run), K9 from its min_d 4 run (4d),
    # K10 from the census-payload stream and K4's wta_stats, right_wta and
    # lr_mask entries from extract_disparity_fast (4e); K1, K2 at 7x9 from
    # the 7x9 matcher and lr_mask at lr_tol from the ELAS run (4f)
    path_counts = {**post_counts["speckle+wls"],
                   **{k: counts[k] for k in MAIN_PATH},
                   "mccnn_conv3x3": mc_counts["fast"]["mccnn_conv3x3"],
                   "mccnn_conv3x3 bf16": mc16_counts["fast"][
                       "mccnn_conv3x3"],
                   "mccnn_volume": mc4_counts["mccnn_volume"],
                   "mccnn_fused_volume": mc_counts["fast"][
                       "mccnn_fused_volume"],
                   "mccnn_fused_volume bf16": mc16_counts["fast"][
                       "mccnn_fused_volume"],
                   "census_scan": stream_counts["census"]["census_scan"],
                   "wta_stats": fast_counts["wta_stats"],
                   "right_wta": fast_counts["right_wta"],
                   "lr_mask": fast_counts["lr_mask"],
                   "census_words 7x9": other_counts["census 7x9"][
                       "census_words"],
                   "census_volume 7x9": other_counts["census 7x9"][
                       "census_volume"],
                   "lr_mask lr_tol=2.0": other_counts["elas"]["lr_mask"]}
    # bounds at the shapes timed above: KITTI D=128 float32, each input
    # read once and each output written once; K3 the mean of a frame's 8
    # launches (the first writes the total without reading it); K8 the mean
    # layer of the fast tower (FP32 for C_in = 1, 3xTF32 products else);
    # K9 its 3xTF32 body's on the fast tower's features (k9_work)
    HW = KITTI["H"] * KITTI["W"]
    vol_b = KITTI["D"] * HW * 4
    k8_parts = {kind: k8_layer["fast", kind] for kind in ("C_in=1", "C_in=F")}
    n_cf = models["fast"].num_layers - 1
    k8_bound_ms = (k8_parts["C_in=1"][3][0] + n_cf * k8_parts["C_in=F"][3][0]
                   ) / models["fast"].num_layers
    k8_bound_by = max((k8_parts["C_in=1"][3][0], k8_parts["C_in=1"][3][1]),
                      (n_cf * k8_parts["C_in=F"][3][0],
                       k8_parts["C_in=F"][3][1]))[1]
    k8_16 = {kind: k8_layer["fast", kind + " bf16"]
             for kind in ("C_in=1", "C_in=F")}
    # bfloat16: C_in = 1, n_cf - 1 layers to bfloat16, the last to float32
    k8_16_cf = (n_cf - 1) * k8_16["C_in=F"][3][0] + k8_last16["fast"][0]
    k8_16_bound = ((k8_16["C_in=1"][3][0] + k8_16_cf)
                   / models["fast"].num_layers,
                   max((k8_16["C_in=1"][3][0], k8_16["C_in=1"][3][1]),
                       (k8_16_cf, k8_16["C_in=F"][3][1]))[1])
    bounds = {
        "census_words": bound(2 * HW * 4 * 2),
        "census_volume": bound(2 * HW * 4 + vol_b),
        "sgm_path_scan": bound((2 + 3 * (n_paths - 1)) / n_paths * vol_b),
        "wta_lr": bound(vol_b + 2 * HW * 4),
        "wta_stats": bound(vol_b + 5 * HW * 4),
        "right_wta": bound(vol_b + HW * 4),
        "lr_mask": bound(2 * HW * 4 + HW),
        "speckle_filter": spk_bound["KITTI"],
        "fgs_solve": bound(6 * HW * 4),
        "mccnn_conv3x3": (k8_bound_ms, k8_bound_by),
        "mccnn_conv3x3 bf16": k8_16_bound,
        "mccnn_volume": k9_bound["fast", label(KITTI)],
        "mccnn_fused_volume": k11_bound_ms["fast", "float32"],
        "mccnn_fused_volume bf16": k11_bound_ms["fast", "bf16"],
        "census_scan": bound(2 * HW * 4 + 2 * vol_b),
        "census_words 7x9": bound(2 * HW * 4 + 2 * 2 * HW * 4),
        "census_volume 7x9": bound(2 * 2 * HW * 4 + vol_b),
        "lr_mask lr_tol=2.0": bound(2 * HW * 4 + HW),
    }
    library_ms = {name: None for name in KERNELS}
    library_ms["fgs_solve"] = dense_ms
    library_ms["mccnn_conv3x3"] = (
        k8_parts["C_in=1"][2] + n_cf * k8_parts["C_in=F"][2]) / \
        models["fast"].num_layers
    library_ms["mccnn_conv3x3 bf16"] = (
        k8_16["C_in=1"][2] + n_cf * k8_16["C_in=F"][2]) / \
        models["fast"].num_layers
    for name, (b_ms, b_by) in bounds.items():
        print(f"[bound] {name}: {b_ms} ms ({b_by}); kernel {ms[name]} ms = "
              f"{b_ms / ms[name]} of it ({card})")
    record = [{"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": path_counts[name],
               "max_abs_err": err[name], "ms": ms[name],
               "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
               "bound_by": bounds[name][1], "library_ms": library_ms[name],
               "graph_ms": graph.get(name)}
              for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-rank"]:
        sys.exit(multihost_rank(sys.argv[2:]))
    sys.exit(main())
