#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and the exit code is not 0):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels with nvcc (one process per source, in parallel);
  3. hold each kernel's public wrapper against its plain PyTorch version on
     the card at the main paths' shapes (N = 5120, C = 128, S = 512, the last
     5% of points padded; the split pair of encoder-layer kernels, and the
     seed k-NN a second time and the NMS prefilter's top-M select, at
     N = 12288; the PointCN + QKV kernel also at N = 20480; the int8 cache
     build also at N = FULL_GRID_N, where it takes the full-grid kernel
     (at N = 5120 the symmetric one); the refinement
     also on a pair ~100 m from the origin; the seed stage after the seed
     k-NN, hypotheses, counts and selection, also at N = 12288 in a 100 m
     cube), and time both with CUDA events; then the seed NMS's gated
     prefilter at N = 12288, one input per branch, against the same entry on
     the CPU;
  4. load the Synthetic snapshot in the running-max configuration
     (``offset_softmax=False``) and run it through ``register`` (the fused
     path, which launches the kernels) with every launch count set
     to 0 just before and read just after: 3 synthetic pairs, and a 4th pair
     through a copy of the model whose logit bias is raised so that a share
     of the confidences is positive and NMS picks the seeds by score (the
     snapshot's logits are all negative on these pairs, so its seeds are the
     suppressed points in index order). Each result is held against the dense
     path (``fused=False``), and its seeds and seed fitness against the dense
     NMS and an [S, N] inlier count on the run's own confidences and seed
     transforms;
  5. hold the first 3 results against the JAX package's golden files: its
     dense path, and its fused running-max path with the attention fed bf16
     as on its accelerator;
  6. check that every kernel of that path was launched on it;
  7. time the fused forward (median of 10 after warm-up, CUDA events);
  8. the default configuration (offset softmax, whole-layer kernels) through
     ``Evaluator.run_dataset`` with the regime guard live, counts set to 0
     before each run and read after: 3 Synthetic pairs at N = 5120 (one
     kernel per layer) and 2 pairs at N = 12288 through the SyntheticKITTI
     snapshot (sigma_d 1.2; pairs of half-width 50 m, noise 0.05 m, inlier
     radius 0.6 m, the data that snapshot was trained on: the pair of kernels
     per layer, and the NMS top-M prefilter). The pairs are ones on which the
     snapshots stay inside the offset softmax's regime (the slack depends on
     the pair; tools/regime_scan.py). Each result is held against the dense
     path, the 5120 ones against a second golden file of the JAX dense path;
  9. one pair through ``half_precision=True`` (the per-op bf16 encoder around
     the offset attention kernel), against the f32 dense path;
 10. one pair through a copy whose key projections are scaled by 100: the
     guard must switch it to the running-max kernel;
 11. time the default forward at both sizes as in 7;
 11b. the limits the card used to have: two-layer models fused at C = 32,
     k = 16, N = 4096 (the kernels on the width zero-padded to 128); at
     ratio 1.0 on N = 8256 (8256 seeds, above the 8192 the select sorts in
     shared memory; its seeds equal to the same selection on the CPU); at
     C = 256 (two chunks of 128 channels; the split pair of layer kernels)
     at N = 4096 and 12288, and in the running max at 4096; at k = 160 (the
     hypotheses kernel's threads own several neighbour rows) at N = 4096 and
     5120; each against its dense path and timed; then one fused train step
     at C = 256, depth 2, against the dense step.
 11c. the seed stage on the seeds of a real forward: each snapshot fused at
     batch 2 (sample 1 with only 36 valid points, so that the NMS seeds hold
     outliers and masked points with fewer than k valid neighbours), every
     seed's transform from the hypotheses kernel inside the forward, and
     from the plain version on the card, against the f64 plain version within
     the seed's tolerance (``kernels/scoring.py::seed_trans_reference``).
Then training (``train/trainer.py``), at the reference training shape: 12
layers, C = 128, k = 40, bs 16, 1000 correspondences padded to 1024:
 12. hold the five training kernels' public entries (attention forward with
     the row LSE, backward dQ, backward dK and dV, SM-loss sums, SM-loss
     gradients) against their plain versions at bs 16 / N = 1024 with 24
     padded points, the attention trio also at one sample of N = 12288, and
     the eval attention without a cache (the running-max tensor-core loop on
     bf16 operands, the compat tile from the geometry) at one pair of
     N = 5120; time them;
 13. the eval forward with ``fused_cache_compat=False`` (that attention) against
     the dense path;
 14. one train step, fused against dense, from the same weights and batch:
     loss terms and every parameter's gradient, held to a tolerance at depth
     2 (full width) and printed at depth 12, where the train-mode forward is
     too ill-conditioned for two exact implementations to stay together;
 15. the ``Trainer`` on the synthetic loader, fused: two epochs of 12 steps
     (the same batches) through ``train_epoch``, ``evaluate`` and
     ``save_checkpoint`` with the counts set to 0 before and read after; the
     second epoch's mean loss must
     be finite and below the first's, every step's gradients finite;
 16. ms per step (median, host clock closed by a synchronise), peak memory
     and launches per step, fused and dense;
 17. two fused steps in the KITTI regime (N = 12288, bs 2, sigma_d 1.2) with
     their peak memory; the dense step is tried for its memory figure only,
     and an out-of-memory error is reported as a finding;
 18. the Trainer's checkpoint through ``load_pretrained`` and ``register``.
Then the registration path (``ops/icp.py``, ``descriptors/fpfh.py``,
``tools/demo_registration.py``) on a seeded indoor-like scene that the script
builds itself (``make_scene``; no demo data is needed):
 19. the nearest-neighbour kernel against its plain version at N = M = 20480,
     at 5120 with a mask and with every base point masked (d2 bit for bit),
     and the symmetric cache build against the full-grid kernel (byte for
     byte) and its plain version at N = 5120 and 20480; time them (the
     search also kernel only, in two device operations at 20480: the merge's
     workspace set to ones, then the kernel; its issue floor on a line of its own);
 20. ``tools/demo_registration.main`` on the scene written as PLY (~200k raw
     points a cloud, FPFH, 5000 correspondences, the Synthetic snapshot,
     ICP) with the counts set to 0 before and read after: it must register
     (RE < 15 deg, TE < 30 cm) with 20 nn-search launches; ICP from gt
     perturbed by 3 deg / 5 cm; ICP and the information matrix on the card
     against the plain search; both clouds' FPFH on the card against the CPU
     path (>= 99.5% of the entries within 1e-3);
 21. ``Evaluator(use_icp=True)`` on the 3 pairs of phase 8, beside it
     without ICP (recall, model_time, launches);
 22. the ICP crossover: kernel against plain search at N = M in ICP_SIZES;
 23. ``tools/exp_symcache.py``, the symmetric cache against the full grid,
     at each N of SYM_RUNS.
Then the dataset CLIs (``evaluation/test_3DMatch``, ``test_3DLoMatch``,
``test_KITTI``, ``train_3DMatch``, ``train_KITTI``) through ``main(argv)`` on
fake data roots in the reference's file layouts, written into a temporary
directory (each phase prints its seconds beside the card's name and power
limit):
 24. a 3DMatch test scene of 4 fragments of 5000 points with a snapshot of
     the Synthetic release: 6 pairs at N = 5000 (bucket 5120), full width,
     each held to the dense path of its sample (1e-3), the kernels of the
     configuration the guard left launched, recall >= 5/6; again with ICP
     (20 nn-search launches a forward); 3DLoMatch from a pickle and from 2
     Predator files;
 25. ``kitti_prep.process_kitti`` on a fake odometry drive (4 frames of ~60k
     points: ICP with the nn-search kernel, FPFH on the card), then the KITTI
     CLI on its 2 pairs at ``--num_node 12000`` with the SyntheticKITTI
     release, each pair held to the dense path;
 26. ``train_3DMatch`` for 4 steps at bs 16 / 1000 with the training kernels
     (66 pairs of 12 fragments), its checkpoint through ``load_pretrained``
     and ``register``; ``train_KITTI`` for one epoch at bs 2 on phase 25's
     pairs.
Then the classical baselines (``baselines/classical.py``, ``native/``,
``baseline_scripts/``) in the same directory (each line with the card and
its seconds):
 27a. ``baseline_3DMatch`` at ``--num_node 2048`` on phase 24's 6 pairs with
     SM, RANSAC, GCRANSAC (ICM and the exact native mincut), LS and PMC (the
     native max clique), each on the CPU and then on the card: the card's
     transform within 1e-4 of the CPU's (both draw one CPU generator's
     sets), labels on >= 0.99 of the points (PMC's clique the same), recall
     at least the CPU-set floor; the native libraries are built with g++
     into ``_build/`` at their first use here;
 27b. ``baseline_KITTI`` on the card on phase 25's 2 pairs at ``--num_node
     15000`` (SM, RANSAC, GCRANSAC, LS) and 2048 (PMC): recall, seconds a
     pair, peak memory;
 27c. ``Evaluator(solver="RANSAC")``, without and with ICP, on phase 8's 3
     pairs beside ``solver="SVD"`` (the default forward's kernels launched
     every forward), and the 3DMatch evaluation CLI with ``--solver RANSAC``
     on phase 24's scene.
Then multiway registration and RGB-D fusion (``fusion/``, ``multiway/``,
``data/redwood.py``, ``data/png.py``) in the same directory:
 28. ``multiway/make_fragments`` on a 640 x 480 RGB-D sequence the script
     renders and writes as PNGs with zlib alone (a textured box room, a
     smooth handheld path, 30 frames, 10 a fragment: the reference's 100
     cut), hybrid RGB-D odometry, the TSDF at 256^3 x 8 mm, FPFH on the
     card: the layout, the odometry against the truth, the surface points'
     distance to the true surfaces, both odometries and one TSDF
     integration on the card against the CPU, the stages timed;
 29. ``multiway/test_multi_ate`` with ICP at --num_node 20000 on 5 fake
     Redwood fragments (bucket 20480: 7b / 7c, the symmetric cache, then
     multi-scale ICP and the pose graph with the nn-search kernel): the ATE,
     the kept edges, the nn-search launches, pair 0 against the dense path,
     the forward at 20480 timed; ``test_multi`` at 5000 (bucket 5120, 7a):
     recall, every pair against the dense path; ``test_multi_ate`` on phase
     28's fragments with the true poses.
Then the FCGF descriptor network (``descriptors/fcgf.py``, ``fcgf_train.py``,
``tools/{cal_fcgf,train_fcgf}.py``) with ``snapshot/fcgf_synth_release.pkl``,
and OANet:
 30. ``cal_fcgf`` at its default 96^3 grid on a 3DMatch test scene of 4 raw
     fragments cut from one ``train_fcgf.make_scene`` world (fragment 0
     against the CPU), the 3DMatch CLI on those features into the fused
     forward with its kernels (each pair against the dense path and, where
     the guard flipped, each running-max launch against the attention in
     float64 at the kernel's precision; recall against its floor; the
     guard's verdicts),
     ``extract_features_tiled`` at 30 cm on a phase-25 frame against the
     CPU; the stages timed;
 31. three FCGF train steps at 64^3 (the first against the CPU), the
     held-out evaluation against the CPU, an OANet forward at N = 5120
     against the CPU.
Then the multi-device layer (``parallel/``), on meshes that name the one card
D times (what a second card would add is printed in phase 34):
 32. the rectangular cache and cached attentions (a row shard: N / D query
     rows over all N keys, the last 5% of the keys masked) against their
     plain versions at N = 5120, 12288 and 20480 and D = 2 and 4, C = 128,
     and C = 256 at one shape; each timed beside its bound;
 33. ``sp_testing_forward`` with the fused encoder at full width (12 layers,
     C = 128, k = 40) on the Synthetic snapshot at N = 20480, on a pair
     inside the offset regime, on meshes of 1, 2 and 4 entries: against the
     single-card forward, the dense-semantics ``sp_encode`` forward and each
     other; the counts set to 0 before each run and read after (one
     rectangular cache launch a shard, 12 attention launches a shard, no
     whole-layer kernel in their place); again with ``offset_softmax=False``;
     the forward timed per D; one SyntheticKITTI pair at N = 12288 through
     ``Evaluator(sp_mesh=[card] * 2)`` with the guard live;
 34. ``run_dataset_sharded`` on phase 24's scene on meshes of 1 and 2 entries
     against ``run_dataset``; the 3DMatch CLI with ``--sp true`` and with
     ``--sharded true``; ``torch.distributed`` over NCCL at world size 1 on
     127.0.0.1 (``initialize``, ``process_shard``, ``all_gather_rows``) and
     three fused DDP Trainer steps at bs 16 / 1024 against three steps of
     the plain Trainer from the same weights and batches.
Prints a JSON line per kernel, one {"kernels": [...]} line, and as the last
line {"ok": true, "device": {...}}. Needs a CUDA card; exits non-zero
without one or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "snapshot", "PointDSC_Synthetic_release")
SNAPSHOT_KITTI = os.path.join(ROOT, "snapshot", "PointDSC_SyntheticKITTI_release")
GOLDEN = os.path.join(ROOT, "pointdsc_tpu_torch", "testdata", "golden_n5120.npz")
GOLDEN_BF16 = os.path.join(ROOT, "pointdsc_tpu_torch", "testdata",
                           "golden_n5120_bf16_attention.npz")
GOLDEN_DEFAULT = os.path.join(ROOT, "pointdsc_tpu_torch", "testdata", "golden_n5120_seed1.npz")
N, C, PAIRS = 5120, 128, 3
N_KITTI, PAIRS_KITTI = 12288, 2
# the data the SyntheticKITTI snapshot was trained on
KITTI_DATA = dict(scene_scale=50.0, noise=0.05, inlier_threshold=0.6)
# pairs on which the snapshots stay inside the offset softmax's regime
DEFAULT_DATA = dict(seed=1, inlier_ratio=0.4)        # Synthetic, N = 5120
DEFAULT_DATA_KITTI = dict(seed=0, inlier_ratio=0.2)  # SyntheticKITTI, N = 12288
S, K = N // 10, 40
PAD_FRACTION = 0.05
DEVICE = "cuda"

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core
# FLOP/s, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

# f32 operations per element of each kernel's work, counted from its source
OPS_PER_NMS_PAIR = 13  # 3-dot (5), gram distance (4), two compares and the AND (4)
OPS_PER_SCORING_PAIR = 29  # three 4-term rows (18), residual (3), squared norm (5), test+count (3)
# per unordered neighbour pair (M is symmetric: the kernel builds its upper
# triangle): two distances (18), spatial (5) and feature (4) compat, product (1),
# beside the 2C of the feature gram
OPS_PER_HYP_PAIR = 28
OPS_PER_POWER_ENTRY = 2  # one multiply-add of M v per entry of M, per power step
HYP_ITERS = 10
OPS_PER_LABEL_POINT = 25  # three 4-term rows (18), residual (3), norm (4)
OPS_PER_ATTN_PAIR_EXTRA = 8  # scale, compat multiply, bias add, max, exp, sum per (q, k)
OPS_PER_CONF_ROW = 2 * (128 * 32 + 32 * 32 + 32) + 2 * 32 + 1  # three layers, biases, ReLUs
OPS_PER_KNN_PAIR = 2 * C + 1  # the 128-term dot product and one compare of the selection
OPS_PER_REFINE_POINT = 63  # warp (18), residual (5), test and weight (5), Gram terms (35)
OPS_PER_REFINE_MEAN_POINT = 7  # masked sums of 6 coordinates and the count
N_LARGE = 20480  # the Redwood scale: the split kernel is also timed there
# phase 11b: a C = 32 model's pair, a pair whose every point is a seed, and
# the width and neighbour count above the kernels' 128 (at C32_N)
C32_N, ALL_SEEDS_N = 4096, 8256
WIDE_C, WIDE_K = 256, 160

# the reference training shape and the KITTI regime of tools/train_synthetic.py
TRAIN_BS, TRAIN_NODE, TRAIN_N = 16, 1000, 1024
TRAIN_STEPS_PER_EPOCH = 12
KITTI_BS = 2

# the registration path: the demo's scene (raw points per cloud), its sample
# of correspondences (bucket 5120) and voxel, the nn-search sizes of phase 19,
# the sizes of the ICP crossover and of the symmetric-cache experiment
SCENE_POINTS, DEMO_NODE, DEMO_VOXEL = 200_000, 5000, 0.03
NN_N, NN_N_MASKED = 20480, N
ICP_SIZES = (2048, 5120, 8192, 20480)
SYM_RUNS = (5000, 5120, 12288, 20480)
# below the symmetric cache's gate (the demo's default num_node): the
# production cache build's full-grid route, phase 3's second cache row
FULL_GRID_N = 2048

# phases 24-26, the dataset CLIs on fake roots in the reference's layouts: a
# 3DMatch test scene of 4 fragments (6 pairs of N = 5000, bucket 5120), a
# KITTI drive of 4 frames (2 pairs) evaluated at 12000 correspondences, a
# training scene of 12 fragments (66 pairs: 4 steps of bs 16)
TEST_SCENE = "7-scenes-redkitchen"
SPLIT_SCENES = ("sun3d-brown_bm_1-brown_bm_1", "sun3d-brown_bm_4-brown_bm_4")  # train, val
CLI_FRAGMENTS, CLI_POINTS, PREDATOR_POINTS = 4, 5000, 6000
DRIVE_FRAMES, DRIVE_POINTS, KITTI_NODE = 4, 60_000, 12000
PREP_ICP_ITERS = 200  # data/kitti_prep.py::process_kitti's ICP
# phases 32-34, the multi-device layer: the rectangular kernels' shapes, the
# sequence-parallel forward's size (the Redwood scale, as N_LARGE) and meshes
RECT_SIZES, RECT_SHARDS, RECT_WIDE = (5120, 12288, 20480), (2, 4), (5120, 2)
SP_N, SP_SHARDS = 20480, (1, 2, 4)
# the DDP steps' depth: the train-mode forward at 12 layers is too
# ill-conditioned for two orders of the same sums to stay together (phase 14)
DDP_LAYERS, DDP_STEPS = 2, 3
# ``same_registration``'s rule (atol, deg, cm, label floor) for a fused
# transform against the dense one where a pair's refinement is bistable
# (phase 25's KITTI pairs, phase 29's Redwood pairs)
BISTABLE_RULE = (5e-3, 0.25, 5.0, 0.98)
TRAIN_FRAGMENTS, TRAIN_POINTS = 12, 3000

# phase 27, the classical baselines (baseline_scripts/): the 3DMatch CLI at
# its default --num_node 2048 on phase 24's scene, on the card and on the CPU;
# the KITTI CLI at its default 15000 on phase 25's pairs, PMC at 2048 (its
# numpy step forms [N, N, 3] differences in float64: 5.4 GB at 15000)
BASELINE_METHODS = (("SM", ()), ("RANSAC", ()), ("GCRANSAC", ("--gc_minimizer", "icm")),
                    ("GCRANSAC", ("--gc_minimizer", "exact")), ("LS", ()), ("PMC", ()))
BASELINE_NODE, BASELINE_KITTI_NODE, PMC_KITTI_NODE = 2048, 15000, 2048
# 27a's recall floors (%), set from the port's CPU run of the same root
# before the first card run (PERF.md, section 6)
BASELINE_RECALL_FLOORS = {"SM": 100.0, "RANSAC": 100.0, "GCRANSAC icm": 100.0,
                          "GCRANSAC exact": 100.0, "LS": 100.0, "PMC": 100.0}

# phase 28, RGB-D fusion: a 640 x 480 sequence rendered by the script
# (PrimeSense intrinsics), fragments of RGBD_PER_FRAGMENT frames (the
# reference's 100 cut to 10); the TSDF at its default 256^3 x 8 mm
RGBD_FRAMES, RGBD_PER_FRAGMENT = 30, 10
RGBD_SIZE = (640, 480)
RGBD_SCENE = "office2-simulated"
# phase 29, the multiway CLIs on fake Redwood scenes of shared-latent
# fragments: REDWOOD_POINTS of a REDWOOD_WORLD-point world, so that
# test_multi_ate's default --num_node 20000 gives ~18.2k mutual matches
# (bucket 20480); test_multi's default 5000 on MULTI_POINTS of MULTI_WORLD
# (~4.5k, bucket 5120)
REDWOOD_SCENE, MULTI_SCENE = "livingroom1-simulated", "office1-simulated"
REDWOOD_FRAGMENTS, REDWOOD_POINTS, REDWOOD_WORLD = 5, 20500, 22000
MULTI_POINTS, MULTI_WORLD = 5100, 5500
ATE_NODE, MULTI_NODE = 20000, 5000
# floors set from the port's CPU rehearsal of the same functions at reduced
# size before the first card run (PERF.md, section 6)
ODOMETRY_CEIL_DEG, ODOMETRY_CEIL_CM = 1.0, 2.0
SURFACE_MEDIAN_CEIL_MM, SURFACE_P95_CEIL_MM = 5.0, 20.0
REDWOOD_ATE_CEIL_CM, RGBD_ATE_CEIL_CM, MULTI_RECALL_FLOOR = 2.0, 5.0, 90.0

# phases 30-31, the FCGF descriptor network with its release checkpoint: a
# 3DMatch test scene of FCGF_FRAGMENTS raw fragments cut from one
# ``tools/train_fcgf.py::make_scene`` world (the regime the checkpoint was
# trained in), ``cal_fcgf`` at its default grid and voxel, the 3DMatch CLI on
# its features; ``extract_features_tiled`` at KITTI_VOXEL on a phase-25 frame;
# FCGF training steps and the held-out evaluation at the training grid; OANet
# at N
FCGF_CHECKPOINT = os.path.join(ROOT, "snapshot", "fcgf_synth_release.pkl")
FCGF_FRAGMENTS, FCGF_GRID, FCGF_VOXEL, KITTI_VOXEL = 4, 96, 0.05, 0.30
FCGF_TRAIN_GRID, FCGF_TRAIN_STEPS, FCGF_EVAL_PAIRS = 64, 3, 6
# card against the port's CPU run of the same function (full float32 on both):
# features, the first train step's loss and running statistics, per-pair
# inlier ratios, OANet's logits and transform
FCGF_FEATURE_ATOL, FCGF_LOSS_ATOL, FCGF_STATS_ATOL, FCGF_RATIO_ATOL = 1e-4, 1e-4, 1e-4, 0.01
OANET_LOGIT_ATOL, OANET_TRANS_ATOL = 1e-3, 1e-4
# ``same_registration``'s rule for the FCGF CLI's fused forward against the
# dense forward and against the sound one (fcgf_3dmatch says why), set from
# the card's readings (PERF.md, section 6): one float32 rounding of the dense
# forward's input moves a pair by 0.264 deg / 0.924 cm, and the sound forward
# at the kernel's precision agrees with the fused one on 0.949 of the labels
FCGF_RULE = (1e-3, 0.3, 1.0, 0.93)
# set from the port's CPU rehearsal of phases 30-31 before the first card run
# (PERF.md, section 6): the CLI's recall on the FCGF scene, the mean inlier
# ratio of the held-out evaluation (0.563 on the CPU; FPFH reads 0.593 on
# the same pairs, in both packages)
FCGF_RECALL_FLOOR, FCGF_EVAL_FLOOR = 100.0, 0.55


def _rot(axis, angle):
    """3x3 rotation by ``angle`` radians about ``axis`` (Rodrigues)."""
    import numpy as np

    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def make_scene(seed=0, n_points=200_000, room=2.5, noise=0.005, overlap_cut=(2.0, 0.6),
               angle_deg=25.0, shift=0.4):
    """A seeded indoor-like scan pair: floor, two walls, boxes of random size
    and yaw, spheres, in a room of side ``room`` metres, surfaces sampled
    uniformly by area (~n_points per cloud before cropping). Each cloud is
    sampled on its own with ``noise`` Gaussian noise; the source keeps
    x <= overlap_cut[0], the target x >= overlap_cut[1] (~70% overlap), and
    the target is moved by a rigid gt (rotation of angle_deg about a random
    axis, translation of norm ``shift``). Returns (src [P, 3], tgt [Q, 3],
    gt [4, 4]) with tgt ~ gt(src) on the overlap."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rects = [  # (origin, edge u, edge v): floor and two walls
        (np.zeros(3), np.array([room, 0, 0]), np.array([0, 0.8 * room, 0])),
        (np.zeros(3), np.array([0, 0.8 * room, 0]), np.array([0, 0, 0.4 * room])),
        (np.zeros(3), np.array([room, 0, 0]), np.array([0, 0, 0.4 * room])),
    ]
    spheres = []
    for _ in range(7):  # boxes: five faces each (not the bottom)
        sx, sy, sz = rng.uniform(0.06, 0.28, 3) * room
        cx, cy = rng.uniform(0.2, 0.8) * room, rng.uniform(0.2, 0.6) * room
        R = _rot([0, 0, 1], rng.uniform(0, np.pi))
        o = np.array([cx, cy, 0.0]) - R @ np.array([sx, sy, 0]) / 2
        ex, ey, ez = R @ [sx, 0, 0], R @ [0, sy, 0], np.array([0, 0, sz])
        rects += [(o + ez, ex, ey), (o, ex, ez), (o + ey, ex, ez), (o, ey, ez), (o + ex, ey, ez)]
        if rng.uniform() < 0.5:  # a ball on some boxes
            r = rng.uniform(0.032, 0.08) * room
            spheres.append((np.array([cx, cy, sz + r]), r))
    for _ in range(4):
        r = rng.uniform(0.04, 0.14) * room
        spheres.append((np.array([rng.uniform(0.16, 0.84) * room,
                                  rng.uniform(0.16, 0.64) * room, r]), r))
    areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rects]
                     + [4 * np.pi * r * r for _, r in spheres])
    ax = rng.normal(size=3)
    gt = np.eye(4)
    gt[:3, :3] = _rot(ax, np.deg2rad(angle_deg))
    d = rng.normal(size=3)
    gt[:3, 3] = shift * d / np.linalg.norm(d)

    def sample(gen):
        counts = gen.multinomial(n_points, areas / areas.sum())
        pts = []
        for (o, u, v), c in zip(rects, counts[:len(rects)]):
            a, b = gen.uniform(size=(2, c, 1))
            pts.append(o + a * u + b * v)
        for (cen, r), c in zip(spheres, counts[len(rects):]):
            dirs = gen.normal(size=(c, 3))
            pts.append(cen + r * dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
        pts = np.concatenate(pts)
        return pts + gen.normal(scale=noise, size=pts.shape)

    src = sample(np.random.default_rng([seed, 1]))
    tgt = sample(np.random.default_rng([seed, 2]))
    src = src[src[:, 0] <= overlap_cut[0]]
    tgt = tgt[tgt[:, 0] >= overlap_cut[1]]
    tgt = tgt @ gt[:3, :3].T + gt[:3, 3]
    return src, tgt, gt


def _box_faces(o, ex, ey, ez):
    """The five faces (not the bottom) of the box at corner o with edges ex, ey, ez."""
    return [(o + ez, ex, ey), (o, ex, ez), (o + ey, ex, ez), (o, ey, ez), (o + ex, ey, ez)]


def street_rects(seed, x0, x1, half_width=7.0, ground=-1.73, props=True):
    """A seeded street along x in [x0, x1] as (origin, edge u, edge v)
    rectangles, in metres in a frame whose origin is a LiDAR 1.73 m above the
    road: the road, a row of facades on each side (segments of 6-14 m set back
    0-1.5 m, joined by side walls) and, with ``props``, cars parked along both
    kerbs and poles."""
    import numpy as np

    rng = np.random.default_rng(seed)
    width = 2 * half_width
    rects = [(np.array([x0, -half_width, ground]), np.array([x1 - x0, 0, 0]),
              np.array([0, width, 0]))]
    for side in (-1.0, 1.0):
        x, prev = x0, None
        while x < x1:
            seg, h = rng.uniform(6, 14), rng.uniform(5, 12)
            y = side * (half_width + rng.uniform(0, 1.5))
            rects.append((np.array([x, y, ground]), np.array([seg, 0, 0]), np.array([0, 0, h])))
            if prev is not None:
                rects.append((np.array([x, prev, ground]), np.array([0, y - prev, 0]),
                              np.array([0, 0, h])))
            prev, x = y, x + seg
        if not props:
            continue
        x = x0 + rng.uniform(0, 4)
        while x < x1:  # parked cars: 4.2 x 1.8 x 1.5 m boxes with a small yaw
            R = _rot([0, 0, 1], rng.uniform(-0.1, 0.1))
            o = np.array([x, side * (half_width - 1.4) - 0.9, ground])
            rects += _box_faces(o, R @ [4.2, 0, 0], R @ [0, 1.8, 0], np.array([0, 0, 1.5]))
            x += rng.uniform(6, 12)
        for x in np.arange(x0 + rng.uniform(0, 15), x1, 15.0):  # poles
            o = np.array([x, side * (half_width - 0.4), ground])
            rects += _box_faces(o, np.array([0.2, 0, 0]), np.array([0, 0.2, 0]),
                                np.array([0, 0, 5.0]))
    return rects


def sample_rects(rects, n_points, gen):
    """n_points drawn uniformly by area over the rectangles."""
    import numpy as np

    areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rects])
    counts = gen.multinomial(n_points, areas / areas.sum())
    pts = []
    for (o, u, v), c in zip(rects, counts):
        a, b = gen.uniform(size=(2, c, 1))
        pts.append(o + a * u + b * v)
    return np.concatenate(pts)


def _unit_rows(x):
    import numpy as np

    return x / np.linalg.norm(x, axis=1, keepdims=True)


def scene_fragments(seed=0, n_frag=4, n_pts=5000, room=3.0, feat_noise=0.13):
    """Fragments of one seeded indoor scene: n_pts of 1.6 n_pts points in a
    ``room``-metre cube, each fragment seen from its own pose (a chain of
    random 10-25 deg turns and 0.3 m steps) with 2 mm noise, its 32-d unit
    "FCGF" features the points' shared latents plus ``feat_noise`` Gaussian
    noise, so that about half of the descriptor matches of a pair are
    inliers. Returns (poses, [(xyz float32, feature float32)], world,
    latents)."""
    import numpy as np

    gen = np.random.default_rng(seed)
    n_world = int(1.6 * n_pts)
    world = gen.uniform(0, room, (n_world, 3))
    latents = _unit_rows(gen.normal(size=(n_world, 32)))
    poses = [np.eye(4)]
    for _ in range(n_frag - 1):
        step = np.eye(4)
        step[:3, :3] = _rot(gen.normal(size=3), np.deg2rad(gen.uniform(10, 25)))
        step[:3, 3] = 0.3 * _unit_rows(gen.normal(size=(1, 3)))[0]
        poses.append(poses[-1] @ step)
    frags = []
    for pose in poses:
        sel = gen.choice(n_world, n_pts, replace=False)
        inv = np.linalg.inv(pose)
        local = world[sel] @ inv[:3, :3].T + inv[:3, 3] + gen.normal(scale=0.002, size=(n_pts, 3))
        feat = _unit_rows(latents[sel] + feat_noise * gen.normal(size=(n_pts, 32)))
        frags.append((local.astype(np.float32), feat.astype(np.float32)))
    return poses, frags, world, latents


def write_3dmatch_scene(root, scene, seed=0, **kw):
    """A 3DMatch test scene of ``scene_fragments`` in the reference's layout:
    ``fragments/<scene>/cloud_bin_<i>_fcgf.npz`` (xyz, feature) and
    ``gt_result/<scene>-evaluation/gt.log`` (target -> source, as the
    reference stores it). Returns (poses, world, latents)."""
    import numpy as np

    poses, frags, world, latents = scene_fragments(seed, **kw)
    frag_dir = os.path.join(root, "fragments", scene)
    os.makedirs(frag_dir, exist_ok=True)
    for i, (xyz, feat) in enumerate(frags):
        np.savez(os.path.join(frag_dir, f"cloud_bin_{i}_fcgf.npz"), xyz=xyz, feature=feat)
    write_gt_log(root, scene, poses)
    return poses, world, latents


def write_gt_log(root, scene, poses):
    """``gt_result/<scene>-evaluation/gt.log`` of fragments with the
    fragment -> world ``poses``: each pair's target -> source transform, as
    the reference stores it."""
    import numpy as np

    gt_dir = os.path.join(root, "gt_result", f"{scene}-evaluation")
    os.makedirs(gt_dir, exist_ok=True)
    n = len(poses)
    with open(os.path.join(gt_dir, "gt.log"), "w") as f:
        for i in range(n):
            for j in range(i + 1, n):
                stored = np.linalg.inv(np.linalg.inv(poses[j]) @ poses[i])
                f.write(f"{i}\t{j}\t{n}\n")
                f.write("".join("\t".join(f"{v:.8f}" for v in row) + "\n" for row in stored))


def write_fcgf_scene(root, scene, n_frag=FCGF_FRAGMENTS, seed=0):
    """A 3DMatch test scene of raw fragments, ``fragments/<scene>/
    cloud_bin_<i>.ply``, cut from one ``train_fcgf.make_scene`` world: each a
    random 70-90% of its points seen from a ``train_fcgf.random_pose`` (at
    most 30 deg and 0.3 m; the first fragment the world frame), with 4 mm
    jitter of its own; and ``gt.log``. Returns the poses."""
    import numpy as np

    from pointdsc_tpu_torch.data.ply import write_ply_xyz
    from pointdsc_tpu_torch.tools.train_fcgf import make_scene, random_pose

    gen = np.random.default_rng(seed)
    world = make_scene(gen).astype(np.float64)
    poses = [np.eye(4)] + [random_pose(gen).astype(np.float64) for _ in range(n_frag - 1)]
    frag_dir = os.path.join(root, "fragments", scene)
    os.makedirs(frag_dir, exist_ok=True)
    for i, pose in enumerate(poses):
        sel = world[gen.random(len(world)) < gen.uniform(0.7, 0.9)]
        inv = np.linalg.inv(pose)
        local = sel @ inv[:3, :3].T + inv[:3, 3] + gen.normal(scale=0.004, size=sel.shape)
        write_ply_xyz(os.path.join(frag_dir, f"cloud_bin_{i}.ply"), local.astype(np.float32))
    write_gt_log(root, scene, poses)
    return poses


def write_train_root(root, scenes, seed=0, **kw):
    """A 3DMatch training root in the reference's layout (that of the JAX
    tests' ``write_fake_train_root``): ``threedmatch_feat/<name>_fcgf.npz``
    fragments of ``scene_fragments`` and, for each of ``scenes`` (names from
    the packaged split files), a pair list ``threedmatch/<scene>@seq-01-0.30.txt``
    naming every pair of the fragments."""
    import numpy as np

    _, frags, _, _ = scene_fragments(seed, **kw)
    os.makedirs(os.path.join(root, "threedmatch_feat"), exist_ok=True)
    os.makedirs(os.path.join(root, "threedmatch"), exist_ok=True)
    names = [f"smoke-scene_{i:03d}.npz" for i in range(len(frags))]
    for name, (xyz, feat) in zip(names, frags):
        np.savez(os.path.join(root, "threedmatch_feat", name.replace(".npz", "_fcgf.npz")),
                 xyz=xyz, feature=feat)
    pairs = "".join(f"{a} {b} 0.5\n" for i, a in enumerate(names) for b in names[i + 1:])
    for scene in scenes:
        with open(os.path.join(root, "threedmatch", f"{scene}@seq-01-0.30.txt"), "w") as f:
            f.write(pairs)


def write_lomatch_pickle(root, scene, poses):
    """``3DLoMatch.pkl`` over every pair of the scene's fragments: the
    reference's fields, src -> tgt as ``rot`` [3, 3] and ``trans`` [3, 1]."""
    import pickle

    import numpy as np

    infos = {"rot": [], "trans": [], "src": [], "tgt": []}
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            gt = np.linalg.inv(poses[j]) @ poses[i]
            infos["rot"].append(gt[:3, :3])
            infos["trans"].append(gt[:3, 3:])
            infos["src"].append(f"test/{scene}/cloud_bin_{i}.pth")
            infos["tgt"].append(f"test/{scene}/cloud_bin_{j}.pth")
    with open(os.path.join(root, "3DLoMatch.pkl"), "wb") as f:
        pickle.dump(infos, f)


def write_predator_pair(path, src, tgt, src_feat, tgt_feat, gt, gen):
    """One OverlapPredator output file (``torch.save``): ``len_src``, ``pcd``
    and ``feats`` of both clouds stacked, per-point ``saliency`` and
    ``overlaps`` in (0.1, 1), and the src -> tgt ``rot`` and ``trans`` [3, 1]."""
    import numpy as np
    import torch

    n = len(src) + len(tgt)
    torch.save({
        "len_src": len(src),
        "pcd": torch.from_numpy(np.concatenate([src, tgt]).astype(np.float32)),
        "feats": torch.from_numpy(np.concatenate([src_feat, tgt_feat]).astype(np.float32)),
        "saliency": torch.from_numpy(gen.uniform(0.1, 1, n).astype(np.float32)),
        "overlaps": torch.from_numpy(gen.uniform(0.1, 1, n).astype(np.float32)),
        "rot": torch.from_numpy(np.asarray(gt[:3, :3], np.float64)),
        "trans": torch.from_numpy(np.asarray(gt[:3, 3:], np.float64)),
    }, path)


def write_fake_drive(root, drive=8, n_frames=4, n_points=60_000, spacing=8.0, noise=0.02,
                     half_range=35.0, half_width=7.0, props=True, seed=0, extra_poses=1):
    """A KITTI odometry drive in the reference's layout: ``poses/XX.txt`` (one
    row of the 3 x 4 camera-to-world pose a frame) and
    ``sequences/XX/velodyne/NNNNNN.bin`` (float32 x, y, z, reflectance). The
    LiDAR drives along x, ``spacing`` metres a frame, through the street of
    ``street_rects``; each frame holds ~n_points sampled on its own within
    ``half_range`` metres along the street, with ``noise`` Gaussian noise. The
    reference's pair rule takes the frame just before the first one more than
    10 m away, so frames 8 m apart pair 0-1, 2-3, ...: ``extra_poses`` poses
    past the last scan let the last pair form."""
    import numpy as np

    from pointdsc_tpu_torch.data.kitti_prep import VELO2CAM

    velo_dir = os.path.join(root, "sequences", f"{drive:02d}", "velodyne")
    os.makedirs(velo_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    x_end = spacing * (n_frames - 1)
    rects = street_rects(seed, -half_range - 1.0, x_end + half_range + 1.0, half_width,
                         props=props)
    total = x_end + 2 * half_range + 2.0
    velo_from_cam = np.linalg.inv(VELO2CAM.T)  # VELO2CAM is stored transposed
    rows = []
    for i in range(n_frames + extra_poses):
        world_from_velo = np.eye(4)
        world_from_velo[0, 3] = spacing * i
        rows.append((world_from_velo @ velo_from_cam)[:3, :4].reshape(-1))
        if i >= n_frames:
            continue
        gen = np.random.default_rng([seed, i])
        pts = sample_rects(rects, int(n_points * total / (2 * half_range)), gen)
        pts = pts[np.abs(pts[:, 0] - spacing * i) <= half_range]
        pts = pts - [spacing * i, 0.0, 0.0] + gen.normal(scale=noise, size=pts.shape)
        scan = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1).astype(np.float32)
        scan.tofile(os.path.join(velo_dir, f"{i:06d}.bin"))
    np.savetxt(os.path.join(root, "poses", f"{drive:02d}.txt"), np.array(rows))


# phase 28's room, (lo, hi) corners in metres (x right, y down, z forward from
# the first camera): its walls seen from the inside, and solid boxes in it
RGBD_ROOM = ((-1.6, -1.2, -0.2), (1.6, 1.3, 3.4))
RGBD_BOXES = (((-0.9, 0.6, 1.6), (-0.3, 1.3, 2.2)), ((0.2, 0.9, 2.2), (0.8, 1.3, 2.8)),
              ((0.6, -0.2, 2.6), (1.2, 0.5, 3.4)), ((-1.6, 0.2, 2.4), (-1.1, 1.3, 3.0)))


def rgbd_path(n_frames):
    """Camera -> world poses of a smooth handheld path through the room:
    ~1.3 cm and ~0.45 deg a frame, looking 10-13 deg down."""
    import numpy as np

    poses = []
    for k in range(n_frames):
        s = k / max(n_frames - 1, 1)
        pose = np.eye(4)
        pose[:3, :3] = (_rot([0, 1, 0], np.deg2rad(12.0 * s))
                        @ _rot([1, 0, 0], np.deg2rad(-10.0 - 3.0 * np.sin(np.pi * s))))
        pose[:3, 3] = [-0.2 + 0.35 * s, -0.05 * s, 0.3 + 0.15 * s]
        poses.append(pose)
    return poses


def _slabs(o, d, lo, hi):
    """Entry and exit ray parameters of the axis-aligned box (lo, hi)."""
    import numpy as np

    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (np.asarray(lo) - o) / d
        t2 = (np.asarray(hi) - o) / d
    return np.minimum(t1, t2).max(-1), np.maximum(t1, t2).min(-1)


def render_rgbd(pose, width, height, fx, fy, cx, cy):
    """Depth (metres along the optical axis) [H, W] and RGB uint8 [H, W, 3] of
    the room seen from ``pose`` (camera -> world), ray cast against its
    boxes; the intensity a smooth texture of the world point each pixel
    sees."""
    import numpy as np

    uu, vv = np.meshgrid(np.arange(width), np.arange(height))
    d_cam = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones(uu.shape)], -1).reshape(-1, 3)
    d = d_cam @ pose[:3, :3].T  # unit optical-axis component: t is the depth
    o = pose[:3, 3]
    t = _slabs(o, d, *RGBD_ROOM)[1]
    for lo, hi in RGBD_BOXES:
        t_in, t_out = _slabs(o, d, lo, hi)
        t = np.where((t_in <= t_out) & (t_in > 1e-6) & (t_in < t), t_in, t)
    x, y, z = (o + d * t[:, None]).T
    inten = np.clip(0.5 + 0.18 * np.sin(9.0 * x + 3.1 * z) + 0.15 * np.cos(11.0 * y - 2.3 * x)
                    + 0.1 * np.sin(17.0 * z + 5.0 * y) + 0.06 * np.sin(31 * x + 29 * y + 23 * z),
                    0.02, 0.98)
    rgb = np.stack([inten, 0.8 * inten + 0.1, 1.0 - 0.7 * inten], -1)
    return (t.reshape(height, width),
            (rgb.reshape(height, width, 3) * 255.0 + 0.5).astype(np.uint8))


def room_distance(p):
    """Distance of world points [N, 3] to the nearest true surface of the room."""
    import numpy as np

    lo, hi = (np.asarray(c) for c in RGBD_ROOM)
    dist = np.minimum(np.abs(p - lo), np.abs(hi - p)).min(-1)
    for lo, hi in RGBD_BOXES:
        lo, hi = np.asarray(lo), np.asarray(hi)
        q = np.abs(p - (lo + hi) / 2) - (hi - lo) / 2
        sdf = np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(q.max(-1), 0.0)
        dist = np.minimum(dist, np.abs(sdf))
    return dist


def png_bytes(img, paeth=False):
    """A PNG of uint8 / uint16 [H, W] or [H, W, 3], written with zlib alone
    (the card's machine has no PIL): every row Up-filtered, or Paeth."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    raw = raw.reshape(h, -1).astype(np.int16)
    bpp = ch * img.dtype.itemsize
    b = np.vstack([np.zeros_like(raw[:1]), raw[:-1]])  # the row above
    pred, ftype = b, 2
    if paeth:
        a = np.hstack([np.zeros_like(raw[:, :bpp]), raw[:, :-bpp]])  # the pixel to the left
        c = np.hstack([np.zeros_like(b[:, :bpp]), b[:, :-bpp]])
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ftype = 4
    rows = np.hstack([np.full((h, 1), ftype), (raw - pred) & 0xFF]).astype(np.uint8)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    color = {1: 0, 3: 2}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_rgbd_sequence(scene_dir, n_frames, width, height):
    """``depth/%06d.png`` (16-bit millimetres) and ``image/%06d.png`` (RGB) of
    ``render_rgbd`` along ``rgbd_path``, PrimeSense intrinsics scaled to the
    size. Returns the camera -> world poses."""
    import numpy as np

    fx = 525.0 * width / 640.0
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    poses = rgbd_path(n_frames)
    for sub in ("depth", "image"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    for k, pose in enumerate(poses):
        depth, rgb = render_rgbd(pose, width, height, fx, fx, cx, cy)
        mm = np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)
        with open(os.path.join(scene_dir, "depth", f"{k:06d}.png"), "wb") as f:
            f.write(png_bytes(mm))
        with open(os.path.join(scene_dir, "image", f"{k:06d}.png"), "wb") as f:
            f.write(png_bytes(rgb, paeth=True))
    return poses


def write_redwood_scene(root, scene, n_frag, n_pts, n_world, seed, feat_noise=0.05,
                        moved=0.4):
    """A Redwood scene of ``scene_fragments``-like fragments in the reference
    layout (``<scene>/fragments/fragment_%03d_fpfh.npz`` with xyz and 32-d
    features from shared latents, ``fragment_%03d.npy`` poses fragment ->
    world): each fragment ``n_pts`` of one ``n_world``-point 3 m cube, seen
    from a chain of random 10-25 deg turns and 0.3 m steps, 2 mm noise. A
    ``moved`` share of each fragment's points sits at a random place of the
    cube: its descriptor still matches its twin's, mutually, so a pair holds
    ~(1 - moved)^2 inliers (36%) among nearly as many mutual matches as
    points. (With every point in place, 99% inliers, the Synthetic snapshot
    leaves the offset softmax's regime by thousands of nats; at 36% its
    slack measured 19-27 nats at N = 5120 and 12288 on the CPU.) Returns the
    poses."""
    import numpy as np

    gen = np.random.default_rng(seed)
    world = gen.uniform(0, 3.0, (n_world, 3))
    latents = _unit_rows(gen.normal(size=(n_world, 32)))
    poses = [np.eye(4)]
    for _ in range(n_frag - 1):
        step = np.eye(4)
        step[:3, :3] = _rot(gen.normal(size=3), np.deg2rad(gen.uniform(10, 25)))
        step[:3, 3] = 0.3 * _unit_rows(gen.normal(size=(1, 3)))[0]
        poses.append(poses[-1] @ step)
    frag_dir = os.path.join(root, scene, "fragments")
    os.makedirs(frag_dir, exist_ok=True)
    for i, pose in enumerate(poses):
        sel = gen.choice(n_world, n_pts, replace=False)
        inv = np.linalg.inv(pose)
        pts = world[sel].copy()
        away = gen.random(n_pts) < moved
        pts[away] = gen.uniform(0, 3.0, (int(away.sum()), 3))
        local = pts @ inv[:3, :3].T + inv[:3, 3] + gen.normal(scale=0.002, size=(n_pts, 3))
        feat = _unit_rows(latents[sel] + feat_noise * gen.normal(size=(n_pts, 32)))
        np.savez(os.path.join(frag_dir, f"fragment_{i:03d}_fpfh.npz"),
                 xyz=local.astype(np.float32), feature=feat.astype(np.float32))
        np.save(os.path.join(frag_dir, f"fragment_{i:03d}.npy"), pose)
    return poses


def check(ok, message: str) -> None:
    """Fail the phase (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median wall time of fn on the device, from CUDA events per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(bytes_moved: float, ops: float, tensor_ops: float = 0.0) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over their
    peak: ``ops`` at the f32 CUDA-core rate, ``tensor_ops`` (products with
    bf16 operands and f32 accumulation) at the dense bf16 tensor-core rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_FLOP_PER_S + tensor_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, source, replaces, err, fn, plain_fn, bytes_moved, ops, tensor_ops=None,
               reps=20, **extra) -> dict:
    """One kernel's entry of the {"kernels": ...} line: its wrapper and its
    plain version timed, its bound from the bytes and operations of its
    work. ``ops`` counts every operation; ``tensor_ops`` of them are
    products with bf16 operands, which count at the tensor-core rate, and
    then ``bound_ms_f32_cores`` puts them all at the f32 rate."""
    if tensor_ops is None:
        b, o = bound_ms(bytes_moved, ops)
    else:
        b, o = bound_ms(bytes_moved, ops - tensor_ops, tensor_ops)
        fb, fo = bound_ms(bytes_moved, ops)
        extra.update(bound_ms_f32_cores=fb, bound_by_f32_cores=fo)
    if not replaces.startswith("pointdsc_tpu/"):
        replaces = f"pointdsc_tpu/kernels/{replaces}"
    return dict(name=name, route="cuda", source=f"pointdsc_tpu_torch/kernels/csrc/{source}",
                replaces=replaces, max_abs_err=err,
                ms=time_ms(fn, reps=reps), plain_ms=time_ms(plain_fn, reps=reps),
                bound_ms=b, bound_by=o, library_ms=None, **extra)


def kernel_inputs(torch, dev):
    """Inputs at the main path's shapes: one synthetic pair's geometry, the
    last 5% of points padded, features/scores/weights from a seeded
    generator and seed transforms near the pair's ground truth."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset

    ex = SyntheticPairDataset(num_pairs=1, num_corr=N, inlier_ratio=0.4, seed=1)[0]
    gen = torch.Generator().manual_seed(0)
    src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
    tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
    mask = (torch.arange(N) < N - int(N * PAD_FRACTION))[None].to(dev)
    qkv = [torch.randn((1, N, C), generator=gen).to(dev) for _ in range(3)]
    scores = torch.randn((1, N), generator=gen).to(dev)
    gt = torch.as_tensor(ex["gt_trans"]).to(dev)
    trans = gt.expand(1, S, 4, 4).clone()
    trans[:, :, :3, 3] += 0.05 * torch.randn((1, S, 3), generator=gen).to(dev)
    head = [(torch.randn(shape, generator=gen) * 0.2).to(dev)
            for shape in ((32, C), (32,), (32, 32), (32,), (1, 32), (1,))]
    seeds = torch.randperm(N, generator=gen)[None, :S].to(dev)
    init = gt[None].clone()
    init[:, :3, 3] += 0.03
    return dict(src=src, tgt=tgt, mask=mask, qkv=qkv, scores=scores, trans=trans, head=head,
                seeds=seeds, init=init)


def hypothesis_inputs(torch, dev, n, kitti=False):
    """The seed stage's arguments at N = n (batch 1, S = n / 10, k = 40,
    C = 128, sigma 0.8) from ``data.synthetic.seed_stage_inputs``, the last
    5% padded, the neighbours from the seed k-NN kernel."""
    from pointdsc_tpu_torch.data.synthetic import seed_stage_inputs
    from pointdsc_tpu_torch.kernels import seed_knn as kknn

    d = seed_stage_inputs(n, kitti=kitti, pad_fraction=PAD_FRACTION)
    f, sd, sp, tp, m = (torch.as_tensor(d[k]).to(dev)
                        for k in ("feats", "seeds", "src", "tgt", "mask"))
    return (f, sd, kknn.seed_knn_exact(f, sd, K, mask=m), sp, tp, m,
            torch.full((1,), 0.8, device=dev), d["sigma_d"], d["inlier_threshold"], 10)


def hypothesis_check(torch, kscore, args, atol) -> float:
    """The seed stage's three kernels against their plain versions on args:
    seed_trans within atol; the fitness equal to an [S, N] count of the
    kernel's own transforms but for points within 1e-5 of tau^2 (FMA
    rounding); final_trans the plain's where the argmax is the same seed,
    else a tie of equal fitness moved it, and always the winner's own;
    the labels those of its own final_trans but within 1e-5 of tau. Returns
    seed_trans's max error."""
    feats, seeds, knn, src, tgt, mask, sigma, sigma_d, thr, iters = args
    seed_trans, fitness, final_trans, labels = kscore.seed_hypotheses(*args)
    ref = kscore.seed_hypotheses_plain(*args)
    err = float((seed_trans - ref[0]).abs().max())
    check(err <= atol, f"seed hypotheses: seed_trans max err {err}")
    t2 = kscore.thr_sq(thr)
    own = kscore.seed_inlier_counts_plain(seed_trans, src, tgt, t2, mask)
    pred = torch.einsum("bsij,bnj->bsni", seed_trans[:, :, :3, :3], src) \
        + seed_trans[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    near = torch.sum(((res2 - t2).abs() < 1e-5 * max(1.0, t2)) & mask[:, None, :], dim=-1)
    denom = mask.sum(-1, keepdim=True).float()
    check(bool(torch.all((fitness * denom - own).abs() <= near + 1e-2)),
          "seed hypotheses: fitness disagrees with the [S, N] count of its own transforms")
    check(float(fitness.max()) > 0.1, "seed hypotheses: no seed found the motion")
    best, best_ref = int(torch.argmax(fitness)), int(torch.argmax(ref[1]))
    if best == best_ref:
        terr = float((final_trans - ref[2]).abs().max())
        check(terr <= atol, f"seed hypotheses: final_trans max err {terr}")
    else:
        check(float(fitness[0, best]) == float(fitness[0, best_ref]),
              "seed hypotheses: another winner without a tie")
    check(torch.equal(final_trans[0], seed_trans[0, best]), "seed hypotheses: not the winner's")
    dist = torch.linalg.norm(src @ final_trans[:, :3, :3].transpose(1, 2)
                             + final_trans[:, None, :3, 3] - tgt, dim=-1)
    off = (labels != ((dist < thr) & mask).float()) & ((dist - thr).abs() >= 1e-5 * max(1.0, thr))
    check(not bool(off.any()), "seed hypotheses: labels disagree")
    return err


def layer_inputs(torch, dev, n, sigma_d, **data):
    """One encoder layer's inputs at N = n, C = 128: a synthetic pair's cache
    (the last 5% of points padded), activations and weights from a seeded
    generator. The q and k projections are scaled so that the logits have a
    standard deviation of ~3 and the offsets sit near 40 nats: a sharp
    softmax inside the regime, where a wrong p would show."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.kernels import encoder_layer as kenc
    from pointdsc_tpu_torch.kernels import sc_attention as katt

    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.4, seed=1, **data)[0]
    src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
    tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
    mask = (torch.arange(n) < n - int(n * PAD_FRACTION))[None].to(dev)
    gen = torch.Generator().manual_seed(2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def bn(ch):
        return (1.0 + rnd(ch, scale=0.1), rnd(ch, scale=0.1), rnd(ch, scale=0.1),
                1.0 + rnd(ch, scale=0.1).abs())

    w, qk = C ** -0.5, (3.0 / 64.0) ** 0.5
    pcn = (rnd(C, C, scale=w), rnd(C, scale=0.1), bn(C))
    nl = (rnd(C, C, scale=qk), rnd(C, scale=0.1), rnd(C, C, scale=qk), rnd(C, scale=0.1),
          rnd(C, C, scale=w), rnd(C, scale=0.1), rnd(C // 2, C, scale=w), rnd(C // 2, scale=0.1),
          bn(C // 2), rnd(C // 2, C // 2, scale=w), rnd(C // 2, scale=0.1), bn(C // 2),
          rnd(C, C // 2, scale=w), rnd(C, scale=0.1))
    return dict(x=rnd(1, n, C), weights=kenc.fold_layer(pcn, nl), mask=mask,
                cache=katt.build_compat_cache_int8(src, tgt, sigma_d, mask=mask),
                kbias=katt.key_bias(mask, 1, n, dev))


def layer_counts(n):
    """(bytes, f32 operations, operations of the two N^2 C products) of one
    encoder layer's three parts at N = n: [PointCN + QKV, attention, MLP]."""
    act = n * C * 4
    w_a = (C * C + C + 3 * C * C + 3 * C) * 4
    w_b = (C * C // 2 + C // 2 + C * C // 4 + C // 2 + C * C // 2 + C) * 4
    ops_a = 2.0 * n * (C * C + 3 * C * C)
    ops_b = 2.0 * n * (C * C // 2 + C * C // 4 + C * C // 2)
    return dict(act=act, half=act // 2, w_a=w_a, w_b=w_b, ops_a=ops_a, ops_b=ops_b,
                cache=n * n + n * 4, attn=4.0 * n * n * C,
                attn_extra=float(OPS_PER_ATTN_PAIR_EXTRA) * n * n)


def knn_sets_agree(torch, idx, ref, sim, k) -> bool:
    """Per seed, the two index sets agree except for candidates whose
    similarity lies within 1e-5 of the k-th largest: a near tie that two
    summation orders of the same dot product may break either way."""
    kth = torch.gather(sim, -1, ref[..., k - 1:k])
    for got, other in ((idx, ref), (ref, idx)):
        missing = ~(got[..., :, None] == other[..., None, :]).any(-1)
        if bool((missing & ((torch.gather(sim, -1, got) - kth).abs() >= 1e-5)).any()):
            return False
    return True


def far_pair(torch, dev, n, seed=4):
    """One pair ~100 m from the origin, as KITTI's clouds sit: a 60 m cube of
    points 100 m out, a rigid motion, 0.2 m noise, half the targets moved
    ~10 m off, the last 5% of points padded with junk 1 km out, and the
    ground truth moved by 0.36 m as the initial transform. Returns (init,
    src, tgt, mask) for threshold 1.2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.linalg.det(q))
    t = rng.normal(size=3) * 2.0
    src = rng.uniform(-30.0, 30.0, size=(n, 3)) + 100.0
    tgt = src @ rot.T + t + rng.normal(size=(n, 3)) * 0.2
    tgt[: n // 2] += rng.normal(size=(n // 2, 3)) * 10.0
    mask = np.arange(n) < n - int(n * PAD_FRACTION)
    src[~mask], tgt[~mask] = 1000.0, -1000.0
    init = np.eye(4)
    init[:3, :3], init[:3, 3] = rot, t + 0.36
    return tuple(torch.as_tensor(a[None], dtype=dtype).to(dev) for a, dtype in (
        (init, torch.float32), (src, torch.float32), (tgt, torch.float32), (mask, torch.bool)))


def prefilter_case(torch, dev, case):
    """One cloud of N_KITTI points in the cube [-1, 1]^3 (the last 5%
    padded) with scores and radius for one branch of the seed NMS's
    prefilter: ``certificate`` (positive scores, radius 0.05: the subset's
    seeds stand), ``scarce_maxima`` (the cloud shrunk into a 0.02 cube,
    radius 0.2: the precheck holds, the certificate fails) and
    ``all_negative`` (the precheck fails)."""
    gen = torch.Generator().manual_seed(9)
    src = torch.rand((1, N_KITTI, 3), generator=gen) * 2.0 - 1.0
    radius = 0.05
    if case == "scarce_maxima":
        src, radius = src * 0.01, 0.2
    scores = 0.01 + 0.99 * torch.rand((1, N_KITTI), generator=gen)
    if case == "all_negative":
        scores = -scores
    mask = (torch.arange(N_KITTI) < N_KITTI - int(N_KITTI * PAD_FRACTION))[None]
    return src.to(dev), scores.to(dev), radius, mask.to(dev)


def prefilter_checks(torch, dev, knms, s_k, m_k) -> None:
    """End of phase 3: the seed NMS at N_KITTI through the entry the model
    calls (``pick_seeds_nms_prefiltered``: top-M select, the subset's flags
    and select behind the precheck, the full grid's behind the
    certificate), one input per branch, held exactly against the same entry
    on the same tensors on the CPU (the plain versions, the gates read on
    the host); the branch from the decisions ``pick_seeds_gated`` returns,
    on the card and on the CPU alike; the entry's time on the card."""
    want = {"certificate": "certificate", "scarce_maxima": "full grid after the subset",
            "all_negative": "full grid"}
    cases = []
    for case, expected in want.items():
        src, scores, radius, mask = prefilter_case(torch, dev, case)
        seeds = knms.pick_seeds_nms_prefiltered(src, scores, radius, s_k, mask=mask)
        ref = knms.pick_seeds_nms_prefiltered(src.cpu(), scores.cpu(), radius, s_k,
                                              mask=mask.cpu())
        _, pre_ok, cert = knms.pick_seeds_gated(src, scores, radius, s_k, mask, m_k)
        _, pre_ref, cert_ref = knms.pick_seeds_gated(src.cpu(), scores.cpu(), radius, s_k,
                                                     mask.cpu(), m_k)
        branch = ("certificate" if bool(cert.all()) else
                  "full grid after the subset" if bool(pre_ok.all()) else "full grid")
        same = (torch.equal(seeds.cpu(), ref) and torch.equal(pre_ok.cpu(), pre_ref)
                and torch.equal(cert.cpu(), cert_ref))
        cases.append(dict(case=case, branch=branch, equal=same, ms=time_ms(
            lambda: knms.pick_seeds_nms_prefiltered(src, scores, radius, s_k, mask=mask))))
        check(same, f"seed NMS prefilter ({case}): the card's seeds or decisions differ")
        check(branch == expected, f"seed NMS prefilter ({case}): took the {branch} branch")
    print(json.dumps({"phase": "seed_nms_prefilter", "n": N_KITTI, "s": s_k, "m": m_k,
                      "cases": cases}), flush=True)


def check_kernels(torch, dev) -> list[dict]:
    """Phase 3: every kernel's public wrapper against its plain version, on
    the card, on the same inputs.

    No single PyTorch call computes any of them (the attentions' compat
    factor multiplies the logits, which ``scaled_dot_product_attention``'s
    additive mask cannot express, and the encoder-layer kernels hold such an
    attention; PointCN + QKV is two products with a ReLU, a rounding and a
    norm, whose two products stand beside it as ``addmm_products_ms``; the
    k-NN a product and a selection; the refinement a loop), so ``library_ms``
    is null but for the confidence head, whose three ``F.linear`` calls and
    two ReLUs it times as the function in parts (``library_calls``), and the
    seed k-NN, timed as ``torch.cdist`` then ``torch.topk``.

    ``bound_ms`` takes every operation at the peak of its operands' type.
    Four kernels hold the two N^2 C attention products on bf16 operands with
    f32 accumulation (the running-max and the offset attention, and the two
    layer kernels around the latter): those products count at the dense bf16
    tensor-core peak, the rest at the f32 rate. They carry a second figure,
    ``bound_ms_f32_cores``, with everything at the f32 CUDA-core peak."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.kernels import conf_mlp as kconf
    from pointdsc_tpu_torch.kernels import encoder_layer as kenc
    from pointdsc_tpu_torch.kernels import nms as knms
    from pointdsc_tpu_torch.kernels import refine as kref
    from pointdsc_tpu_torch.kernels import sc_attention as katt
    from pointdsc_tpu_torch.kernels import scoring as kscore
    from pointdsc_tpu_torch.kernels import seed_knn as kknn
    from pointdsc_tpu_torch.ops.nms import _total_order_key, nms_key

    x = kernel_inputs(torch, dev)
    src, tgt, mask = x["src"], x["tgt"], x["mask"]
    q, k, v = x["qkv"]
    rows = []

    def row(*args, **kwargs):
        rows.append(kernel_row(*args, **kwargs))

    # -- int8 cache. Tolerance: the kernel's fused multiply-adds round the
    # gram-form distances differently from cuBLAS's, so an entry whose
    # 127 * compat lies within an ulp-sized distance of a .5 boundary may
    # round the other way: equal except for <= 0.1% of entries off by 1.
    geom = katt.pack_geometry(src, tgt, mask)
    coef = katt.cache_coef(0.1)
    cache = katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    diff = (cache.int() - katt.compat_cache_plain(geom, coef).int()).abs()
    off1 = int((diff == 1).sum())
    check(int(diff.max()) <= 1, f"cache differs by {int(diff.max())}")
    check(off1 <= 1e-3 * N * N, f"cache: {off1} entries off by 1")
    # the route the production wrapper takes at N (the symmetric kernel or the
    # full grid: the same bytes), named by the row's source
    # (its bound: the least work of the function, ``compat_cache_work``)
    sym_route = katt.use_symmetric_cache(N)
    row("compat_cache_int8", "compat_cache_sym.cu" if sym_route else "compat_cache.cu",
        "sc_attention.py:343,368" if sym_route else "sc_attention.py:236", float(diff.max()),
        lambda: katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask),
        lambda: katt.compat_cache_plain(katt.pack_geometry(src, tgt, mask), coef),
        *katt.compat_cache_work(1, N), off_by_one=off1,
        production_route="symmetric" if sym_route else "full_grid")
    # the same wrapper at FULL_GRID_N, below the gate: the full-grid kernel,
    # held to the plain version by the same rule; its launches are phase 17's
    # (the trainer's eval batches at TRAIN_N, also below the gate)
    check(not katt.use_symmetric_cache(FULL_GRID_N) and not katt.use_symmetric_cache(TRAIN_N),
          "the full-grid sizes are not below the symmetric gate")
    ex = SyntheticPairDataset(num_pairs=1, num_corr=FULL_GRID_N, inlier_ratio=0.4, seed=1)[0]
    fsrc, ftgt = (torch.as_tensor(ex[key])[None].to(dev) for key in ("src_keypts", "tgt_keypts"))
    fmask = (torch.arange(FULL_GRID_N) < FULL_GRID_N - int(FULL_GRID_N * PAD_FRACTION))[None]
    fmask = fmask.to(dev)
    fcache = katt.build_compat_cache_int8(fsrc, ftgt, 0.1, mask=fmask)
    fplain = katt.compat_cache_plain(katt.pack_geometry(fsrc, ftgt, fmask), coef)
    fdiff = (fcache.int() - fplain.int()).abs()
    foff1 = int((fdiff == 1).sum())
    check(int(fdiff.max()) <= 1, f"cache at N = {FULL_GRID_N} differs by {int(fdiff.max())}")
    check(foff1 <= 1e-3 * FULL_GRID_N ** 2, f"cache at N = {FULL_GRID_N}: {foff1} entries off by 1")
    row("compat_cache_int8_full_grid", "compat_cache.cu", "sc_attention.py:236",
        float(fdiff.max()), lambda: katt.build_compat_cache_int8(fsrc, ftgt, 0.1, mask=fmask),
        lambda: katt.compat_cache_plain(katt.pack_geometry(fsrc, ftgt, fmask), coef),
        *katt.compat_cache_work(1, FULL_GRID_N), off_by_one=foff1, n=FULL_GRID_N,
        production_route="full_grid")

    # -- running-max attention on the kernel's own cache, on the f32 q, k, v
    # the running-max encoder gives it: the wrapper rounds them to bf16 (as
    # the JAX wrapper does off the CPU) and the kernel rounds p to bf16 before
    # p v, so it is held to the plain version of the bf16 inputs. Tolerance
    # atol = rtol = 2e-3, as the offset attention below: a p on a bf16
    # rounding boundary may round either way (the kernel rounds p against
    # each tile's running max, the plain version against the row's maximum),
    # each flip moving one of 5120 terms of a row by 2^-9 relative. f32 and
    # bf16 inputs give the same result, bit for bit.
    bias = geom[:, 8].contiguous()
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                         offset_softmax=False)
    ref = katt.sc_attention_cached_plain(qh, kh, vh, cache, bias)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=2e-3, rtol=2e-3), f"attention max err {err}")
    check(torch.equal(katt.fused_sc_attention_cached(qh, kh, vh, cache, src, tgt, mask=mask,
                                                     offset_softmax=False), out),
          "running-max attention: f32 inputs are not the bf16 inputs' result")
    attn_bytes = 3 * N * C * 4 + N * N + N * 4 + N * C * 4
    attn_ops = 4.0 * N * N * C + OPS_PER_ATTN_PAIR_EXTRA * N * N
    row("sc_attention_cached", "sc_attention.cu", "sc_attention.py:417", err,
        lambda: katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                               offset_softmax=False),
        lambda: katt.sc_attention_cached_plain(qh, kh, vh, cache, bias), attn_bytes, attn_ops,
        tensor_ops=4.0 * N * N * C)

    # -- offset attention on the same cache, at the shapes and types the
    # half-precision path gives it: bf16 q, k, v, and p rounded to bf16 before
    # p v. Tolerance atol = rtol = 2e-3: a p whose f32 value sits on a bf16
    # rounding boundary may round either way in the two versions (their
    # exponents' arguments differ in the last bit), each such flip moving one
    # of 5120 terms of a row by 2^-9 relative; measured ~1e-4. f32 inputs are
    # rounded to bf16 by the wrapper: the same result, bit for bit.
    out = katt.fused_sc_attention_cached(qh, kh, vh, cache, src, tgt, mask=mask)
    ref = katt.sc_attention_cached_offset_plain(qh, kh, vh, cache, bias)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=2e-3, rtol=2e-3), f"offset attention max err {err}")
    check(torch.equal(katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask), out),
          "offset attention: f32 inputs are not the bf16 inputs' result")
    row("sc_attention_cached_offset", "sc_attention.cu", "sc_attention.py:472", err,
        lambda: katt.fused_sc_attention_cached(qh, kh, vh, cache, src, tgt, mask=mask),
        lambda: katt.sc_attention_cached_offset_plain(qh, kh, vh, cache, bias),
        attn_bytes - 3 * N * C * 2, attn_ops, tensor_ops=4.0 * N * N * C)

    # -- the whole encoder layer in one launch, N = 5120. Tolerance
    # atol = rtol = 2e-3: q, k, v and p are rounded to bf16 in both versions,
    # whose f32 sums run in another order; a value on a rounding boundary may
    # round either way, which moves one logit by 2^-9 relative or one of 5120
    # terms of a row's sum by as much. Activations are ~1; measured ~1e-4.
    lay = layer_inputs(torch, dev, N, 0.1)
    x5, w5, c5, kb5 = lay["x"], lay["weights"], lay["cache"], lay["kbias"]
    out = kenc.fused_encoder_layer(x5, c5, kb5, w5)
    ref = kenc.fused_layer_plain(x5, c5, kb5, w5)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=2e-3, rtol=2e-3), f"fused encoder layer max err {err}")
    cnt = layer_counts(N)
    row("fused_encoder_layer", "encoder_layer.cu", "encoder_layer.py:109", err,
        lambda: kenc.fused_encoder_layer(x5, c5, kb5, w5),
        lambda: kenc.fused_layer_plain(x5, c5, kb5, w5),
        2 * cnt["act"] + cnt["cache"] + cnt["w_a"] + cnt["w_b"],
        cnt["ops_a"] + cnt["ops_b"] + cnt["attn"] + cnt["attn_extra"], tensor_ops=cnt["attn"])
    del lay, x5, w5, c5, kb5, out, ref

    # -- the split pair, N = 12288 (a pair at the SyntheticKITTI scale,
    # sigma_d = 1.2). PointCN + QKV: h atol = rtol = 1e-5 (f32 dot products of
    # 128 terms in another order); q, k, v equal in bf16 except at rounding
    # boundaries (by one step, on <= 0.1% of entries); kscale rtol 1e-5. Held
    # and timed again at N = 20480 (the n20480 extra). ``library_ms`` stays
    # null: no one PyTorch call computes it; the two products alone as
    # ``torch.addmm`` in f32 (TF32 off: two calls, the products only) stand
    # beside as ``addmm_products_ms``; ``workspace_ms`` is the wrapper writing
    # into a workspace (no allocation), as the forward calls it.
    def pcn_check(xs, ws_):
        n = xs.shape[1]
        got = kenc.pcn_qkv(xs, ws_)
        ref = kenc.pcn_qkv_plain(xs, ws_)
        err = float((got[0] - ref[0]).abs().max())
        check(torch.allclose(got[0], ref[0], atol=1e-5, rtol=1e-5), f"pcn_qkv h max err {err}")
        flips = 0
        for a, b in zip(got[1:4], ref[1:4]):
            d = (a.float() - b.float()).abs()
            check(bool((d <= b.float().abs() * 2.0 ** -7).all()), "pcn_qkv: q/k/v off by > 1 step")
            flips += int((d > 0).sum())
        check(flips <= 1e-3 * 3 * n * C, f"pcn_qkv: {flips} bf16 entries differ")
        check(torch.allclose(got[4], ref[4], atol=0, rtol=1e-5), "pcn_qkv: kscale differs")
        work = kenc.new_workspace(1, n, C, dev)
        x2, h2 = xs.reshape(n, C), torch.empty((n, C), device=dev)

        def products():
            torch.addmm(ws_[1], x2, ws_[0], out=h2)
            return torch.addmm(ws_[3], h2, ws_[2])

        cnt_ = layer_counts(n)
        return ref, dict(
            max_abs_err=err, bf16_entries_off_by_one=flips,
            workspace_ms=time_ms(lambda: kenc.pcn_qkv(xs, ws_, work), reps=10),
            addmm_products_ms=time_ms(products, reps=10),
            bytes_ops=(2 * cnt_["act"] + 3 * cnt_["half"] + cnt_["w_a"] + 4, cnt_["ops_a"]))

    lay = layer_inputs(torch, dev, N_KITTI, 1.2, **KITTI_DATA)
    xk, wk, ck, kbk = lay["x"], lay["weights"], lay["cache"], lay["kbias"]
    ref, info = pcn_check(xk, wk)
    x_large = torch.randn((1, N_LARGE, C), generator=torch.Generator().manual_seed(5)).to(dev)
    _, info_l = pcn_check(x_large, wk)
    large = {k: v for k, v in info_l.items() if k != "bytes_ops"}
    large.update(ms=time_ms(lambda: kenc.pcn_qkv(x_large, wk), reps=10),
                 plain_ms=time_ms(lambda: kenc.pcn_qkv_plain(x_large, wk), reps=10),
                 bound_ms=bound_ms(*info_l["bytes_ops"])[0])
    row("pcn_qkv", "encoder_layer.cu", "encoder_layer.py:272", info.pop("max_abs_err"),
        lambda: kenc.pcn_qkv(xk, wk), lambda: kenc.pcn_qkv_plain(xk, wk),
        *info.pop("bytes_ops"), reps=10, n20480=large, **info)
    del x_large

    # -- attention + MLP + residual on the plain version's h, q, k, v, kscale.
    # Tolerance atol = rtol = 2e-3, for the p rounding as above (12288 terms).
    h, qb, kb_, vb, ks = ref
    out = kenc.attn_mlp_residual(ks, qb, kb_, vb, ck, kbk, h, wk)
    ref2 = kenc.attn_mlp_residual_plain(ks, qb, kb_, vb, ck, kbk, h, wk)
    err = float((out - ref2).abs().max())
    check(torch.allclose(out, ref2, atol=2e-3, rtol=2e-3), f"attn_mlp_residual max err {err}")
    row("attn_mlp_residual", "encoder_layer.cu", "encoder_layer.py:326", err,
        lambda: kenc.attn_mlp_residual(ks, qb, kb_, vb, ck, kbk, h, wk),
        lambda: kenc.attn_mlp_residual_plain(ks, qb, kb_, vb, ck, kbk, h, wk),
        2 * cnt["act"] + 3 * cnt["half"] + cnt["cache"] + cnt["w_b"] + 4,
        cnt["ops_b"] + cnt["attn"] + cnt["attn_extra"], tensor_ops=cnt["attn"], reps=10)
    del lay, xk, wk, ck, kbk, ref, ref2, out, h, qb, kb_, vb, ks
    torch.cuda.empty_cache()

    # -- confidence head, on the weights packed once as the model packs them.
    # Tolerance atol = rtol = 1e-5: f32 dot products of 128 and 32 terms
    # summed in another order than cuBLAS's. ``library_ms`` is the plain
    # version's three F.linear calls with their two ReLUs: the function in
    # five PyTorch calls, not one (``library_calls``). Also timed at
    # N = 12288 and 20480 (``sizes``), each with its bound.
    head = x["head"]
    packed = kconf.pack_head_weights(*head)
    logits = kconf.confidence_head(q, packed)
    ref = kconf.confidence_head_plain(q, *head)
    err = float((logits - ref).abs().max())
    check(torch.allclose(logits, ref, atol=1e-5, rtol=1e-5), f"confidence head max err {err}")

    def conf_bound(n):
        return bound_ms(n * C * 4 + packed.numel() * 4 + n * 4, n * OPS_PER_CONF_ROW)[0]

    sizes = {}
    for n_c in (N_KITTI, N_LARGE):
        x_c = torch.randn((1, n_c, C), generator=torch.Generator().manual_seed(n_c)).to(dev)
        got, want = kconf.confidence_head(x_c, packed), kconf.confidence_head_plain(x_c, *head)
        e_c = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=1e-5, rtol=1e-5), f"confidence head at {n_c}: {e_c}")
        sizes[str(n_c)] = dict(ms=time_ms(lambda: kconf.confidence_head(x_c, packed)),
                               bound_ms=conf_bound(n_c), max_abs_err=e_c)
    row("confidence_head", "conf_mlp.cu", "conf_mlp.py:43", err,
        lambda: kconf.confidence_head(q, packed), lambda: kconf.confidence_head_plain(q, *head),
        N * C * 4 + packed.numel() * 4 + N * 4, N * OPS_PER_CONF_ROW, sizes=sizes,
        library_calls="3 x F.linear + 2 x relu (the plain version; no one call)")
    rows[-1]["library_ms"] = time_ms(lambda: kconf.confidence_head_plain(q, *head))

    # -- NMS flags and seed keys, equal to the plain version's bit for bit:
    # both round each product and sum of d2 and of the squared norms on its
    # own, in one order (``flags_off``, the flags that differ, is 0). A
    # block's warps leave their key loops once its 32 queries are all
    # suppressed; the kernel counts the 32-key tiles its warps walked, and the
    # bound counts the pair tests of those tiles (``walked_share``: of the
    # full grid's). The timed call reads src, scores and mask and writes the
    # keys.
    scores = x["scores"]
    r2 = knms.radius_sq(0.1)
    flags = knms.nms_local_max(src, scores, 0.1, mask=mask)
    keys = knms.nms_local_max(src, scores, 0.1, mask=mask, keys=True)
    ref = knms.nms_local_max_plain(src, scores, mask, r2)
    flags_off = int((flags != ref).sum())
    check(flags_off == 0, f"NMS flags differ on {flags_off} points")
    check(torch.equal(keys, _total_order_key(nms_key(scores, ref, mask))), "NMS keys differ")
    tiles = torch.zeros(1, dtype=torch.int64, device=dev)
    knms._launch_flags(src, scores, mask, None, None, r2, True, tiles=tiles)
    walked = int(tiles)
    per_warp = -(-N // (32 * knms.FLAG_WARPS)) * 32
    grid_tiles = -(-N // 32) * sum(-(-(min(N, (w + 1) * per_warp) - w * per_warp) // 32)
                                   for w in range(knms.FLAG_WARPS) if w * per_warp < N)
    row("nms_local_max", "nms.cu", "nms.py:40", float((flags - ref).abs().max()),
        lambda: knms.nms_local_max(src, scores, 0.1, mask=mask, keys=True),
        lambda: knms.nms_local_max_plain(src, scores, mask, r2),
        src.numel() * 4 + N * 4 + N + N * 4, walked * 32 * 32 * OPS_PER_NMS_PAIR,
        flags_off=flags_off, tiles_walked=walked, walked_share=walked / grid_tiles)

    # -- the seed select on those keys (S = 512), exact against the plain
    # version's stable sort (JAX's lax.top_k order: +0.0 above -0.0, ties to
    # the lower index). ``library_ms`` stays null: torch.topk promises no
    # order on ties; one torch.topk call on the keys stands beside as
    # ``torch_topk_ms``. The bound: the keys read once, the seeds written
    # once, one compare a key.
    seeds = knms.nms_select(keys, S)
    check(torch.equal(seeds, knms.nms_select_plain(keys, S)), "NMS seed select differs")
    row("nms_select", "nms.cu", "nms.py:119", 0.0, lambda: knms.nms_select(keys, S),
        lambda: knms.nms_select_plain(keys, S), N * 4 + S * 8, N,
        torch_topk_ms=time_ms(lambda: torch.topk(keys, S, dim=-1)))

    # -- the prefilter's top-M select at the SyntheticKITTI scale (N = 12288,
    # M = 5120, S = 1228, the last 5% padded), exact against its plain
    # version: the indices in index order, tau_M and the precheck. The
    # bound: the scores and mask read once, the indices written once, one
    # compare a score.
    s_k = N_KITTI // 10
    m_k = -(-max(4 * s_k, 4096) // 1024) * 1024
    scores_k = torch.randn((1, N_KITTI), generator=torch.Generator().manual_seed(8)).to(dev)
    mask_k = (torch.arange(N_KITTI) < N_KITTI - int(N_KITTI * PAD_FRACTION))[None].to(dev)
    got = knms.nms_top_m(scores_k, mask_k, m_k, s_k)
    check(all(torch.equal(a, b) for a, b in zip(got, knms.nms_top_m_plain(scores_k, mask_k, m_k,
                                                                         s_k))),
          "NMS top-M select differs")
    row("nms_top_m", "nms.cu", "nms.py:170", 0.0,
        lambda: knms.nms_top_m(scores_k, mask_k, m_k, s_k),
        lambda: knms.nms_top_m_plain(scores_k, mask_k, m_k, s_k),
        N_KITTI * 5 + m_k * 4 + 8, N_KITTI, n=N_KITTI, m=m_k,
        torch_topk_ms=time_ms(lambda: torch.topk(scores_k, m_k, dim=-1)))
    del scores_k, mask_k
    prefilter_checks(torch, dev, knms, s_k, m_k)

    # -- seed k-NN, at N = 5120 / S = 512 and at the SyntheticKITTI scale
    # N = 12288 / S = 1228 (the n12288 extra). Tolerance: index sets equal
    # except at near ties of the k-th similarity (see knn_sets_agree); never
    # a seed itself or a padded point. The bound counts the 128-term product
    # and one compare per (seed, candidate) at the f32 rate.
    def knn_case(feats, seeds, msk):
        s = seeds.shape[1]
        idx = kknn.seed_knn_exact(feats, seeds, K, mask=msk)
        ref = kknn.seed_knn_plain(feats, seeds, K, kknn.knn_bias(msk, feats))
        sim = torch.einsum("bsc,bnc->bsn",
                           torch.gather(feats, 1, seeds[..., None].expand(-1, -1, C)), feats)
        check(knn_sets_agree(torch, idx, ref, sim, K),
              f"seed k-NN sets differ beyond near ties at S = {s}")
        check(bool(torch.gather(msk[:, None].expand(-1, s, -1), 2, idx).all())
              and not bool((idx == seeds[..., None]).any()),
              "seed k-NN returned a padded/self index")
        n = feats.shape[1]
        return (float((torch.gather(sim, -1, idx) - torch.gather(sim, -1, ref)).abs().max()),
                (n * C * 4 + n * 4 + s * 8 + s * K * 8, s * n * OPS_PER_KNN_PAIR))

    feats = torch.nn.functional.normalize(q, dim=-1).contiguous()
    seeds = x["seeds"]
    err, counts = knn_case(feats, seeds, mask)
    gen = torch.Generator().manual_seed(7)
    feats_k = torch.nn.functional.normalize(torch.randn((1, N_KITTI, C), generator=gen),
                                            dim=-1).to(dev)
    seeds_k = torch.randperm(N_KITTI, generator=gen)[None, :N_KITTI // 10].to(dev)
    mask_k = (torch.arange(N_KITTI) < N_KITTI - int(N_KITTI * PAD_FRACTION))[None].to(dev)
    err_k, counts_k = knn_case(feats_k, seeds_k, mask_k)

    # library_ms: torch.cdist of the seeds' features (gathered beforehand)
    # against all features, then torch.topk of the k smallest: the k-NN
    # without the kernel's exclusion of the seed itself and of padded points
    def library_knn(f, sd):
        seed_f = torch.gather(f, 1, sd[..., None].expand(-1, -1, C))
        return time_ms(lambda: torch.topk(torch.cdist(seed_f, f), K, dim=-1, largest=False))

    row("seed_knn_exact", "seed_knn.cu", "seed_knn.py:48", err,
        lambda: kknn.seed_knn_exact(feats, seeds, K, mask=mask),
        lambda: kknn.seed_knn_plain(feats, seeds, K, kknn.knn_bias(mask, feats)), *counts,
        library_calls="torch.cdist + torch.topk",
        n12288=dict(
            s=N_KITTI // 10, max_abs_err=err_k,
            ms=time_ms(lambda: kknn.seed_knn_exact(feats_k, seeds_k, K, mask=mask_k)),
            plain_ms=time_ms(lambda: kknn.seed_knn_plain(feats_k, seeds_k, K,
                                                         kknn.knn_bias(mask_k, feats_k))),
            bound_ms=bound_ms(*counts_k)[0], library_ms=library_knn(feats_k, seeds_k)))
    rows[-1]["library_ms"] = library_knn(feats, seeds)
    del feats_k, seeds_k, mask_k

    # -- the seed stage after the seed k-NN (``seed_hypotheses``, three
    # launches: the hypotheses, the counts (#11), the selection) at N = 5120
    # in the unit cube (seed_trans atol 1e-4) and at the SyntheticKITTI scale
    # N = 12288, S = 1228 in a 100 m cube (atol 1e-3: translations of tens of
    # metres), with the checks of ``hypothesis_check``. Its row times the
    # whole stage; its bound is the stage's: the neighbours' gather, the
    # k (k + 1) / 2 entries of the symmetric compatibility (the feature gram
    # at the f32 rate), the power steps over all k^2, the counts. No TPU
    # kernel: the XLA glue of the JAX model.
    hyp = hypothesis_inputs(torch, dev, N)
    err = hypothesis_check(torch, kscore, hyp, 1e-4)
    hyp_k = hypothesis_inputs(torch, dev, N_KITTI, kitti=True)
    err_k = hypothesis_check(torch, kscore, hyp_k, 1e-3)

    def stage_counts(n):
        s = n // 10
        return (s * K * (C + 7) * 4 + s * K * 8 + s * 8 + n * 25 + s * 16 * 4 + s * 4 + n * 4,
                s * K * (K + 1) // 2 * (2 * C + OPS_PER_HYP_PAIR)
                + s * HYP_ITERS * K * K * OPS_PER_POWER_ENTRY + s * n * OPS_PER_SCORING_PAIR
                + n * OPS_PER_LABEL_POINT)

    row("seed_hypotheses", "scoring.cu", "pointdsc_tpu/models/pointdsc.py:363", err,
        lambda: kscore.seed_hypotheses(*hyp), lambda: kscore.seed_hypotheses_plain(*hyp),
        *stage_counts(N), n12288=dict(
            s=N_KITTI // 10, max_abs_err=err_k, ms=time_ms(lambda: kscore.seed_hypotheses(*hyp_k)),
            plain_ms=time_ms(lambda: kscore.seed_hypotheses_plain(*hyp_k)),
            bound_ms=bound_ms(*stage_counts(N_KITTI))[0]))
    del hyp_k

    # -- the counts (#11) on transforms near the pair's ground truth, read in
    # place with the points. Tolerance: a point whose squared residual is
    # within 1e-5 of tau^2 may be counted by one version and not the other
    # (FMA rounding), so per seed |count - plain| <= the number of such points.
    trans = x["trans"]
    t2 = kscore.thr_sq(0.1)
    counts = kscore.seed_inlier_counts(trans, src, tgt, 0.1, mask=mask)
    ref = kscore.seed_inlier_counts_plain(trans, src, tgt, t2, mask)
    pred = torch.einsum("bsij,bnj->bsni", trans[:, :, :3, :3], src) + trans[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    near = torch.sum(((res2 - t2).abs() < 1e-5) & mask[:, None, :], dim=-1)
    cdiff = (counts - ref).abs()
    check(bool(torch.all(cdiff <= near)), f"counts differ by up to {float(cdiff.max())}")
    check(float(counts.sum()) > 0, "scoring counted no inliers")
    row("seed_inlier_counts", "scoring.cu", "scoring.py:56", float(cdiff.max()),
        lambda: kscore.seed_inlier_counts(trans, src, tgt, 0.1, mask=mask),
        lambda: kscore.seed_inlier_counts_plain(trans, src, tgt, t2, mask),
        S * 16 * 4 + src.numel() * 4 * 2 + N + S * 4, S * N * OPS_PER_SCORING_PAIR)

    # -- the selection on those counts: fitness, the first maximum, the
    # winner's transform and labels. Fitness and winner exact (the same
    # division and order); labels but within 1e-5 of tau (FMA rounding).
    seeds_sel = x["seeds"]
    got = kscore.select_hypothesis(trans, counts, seeds_sel, src, tgt, 0.1, mask)
    want = kscore.select_hypothesis_plain(trans, counts, seeds_sel, src, tgt, 0.1, mask)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "selection: fitness or winner differs")
    dist = torch.linalg.norm(src @ got[1][:, :3, :3].transpose(1, 2) + got[1][:, None, :3, 3]
                             - tgt, dim=-1)
    loff = int(((got[2] != want[2]) & ((dist - 0.1).abs() >= 1e-5)).sum())
    check(loff == 0, f"selection: {loff} labels differ")
    row("select_hypothesis", "scoring.cu", "pointdsc_tpu/models/pointdsc.py:415",
        float((got[2] - want[2]).abs().max()),
        lambda: kscore.select_hypothesis(trans, counts, seeds_sel, src, tgt, 0.1, mask),
        lambda: kscore.select_hypothesis_plain(trans, counts, seeds_sel, src, tgt, 0.1, mask),
        S * 16 * 4 + S * 4 + S * 8 + src.numel() * 4 * 2 + N + S * 4 + 64 + N * 4,
        S * 2 + N * OPS_PER_LABEL_POINT)

    # -- post-refinement, the whole function in one launch. Tolerance atol
    # 1e-4 on the transform: the kernel sums the Gram terms and the means in
    # another order than the plain einsums and solves in the same f32 closed
    # form; its rounds equal the plain loop's. Held again on a pair ~100 m
    # from the origin (N = 12288, threshold 1.2, padded points 1 km out: the
    # case the centring exists for; translations ~100 m, f32's ulp there
    # ~7.6e-6). The bound counts the rounds that ran.
    def refine_check(init_, src_, tgt_, mask_, thr):
        out, iters = kref.fused_post_refinement(init_, src_, tgt_, mask_, thr, 20,
                                                return_iters=True)
        ref, rounds_ = kref.fused_post_refinement_plain(init_, src_, tgt_, mask_, thr, 20,
                                                        return_iters=True)
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()) and err <= 1e-4,
              f"post-refinement max err {err} (thr {thr})")
        check(torch.equal(iters, rounds_), f"refinement rounds {iters.tolist()} against the "
              f"plain loop's {rounds_.tolist()}")
        return err, int(iters.sum())

    init = x["init"]
    err, rounds = refine_check(init, src, tgt, mask, 0.1)
    far = far_pair(torch, dev, N_KITTI)
    far_err, far_rounds = refine_check(*far, 1.2)
    row("fused_post_refinement", "refine.cu", "refine.py:55", err,
        lambda: kref.fused_post_refinement(init, src, tgt, mask, 0.1, 20),
        lambda: kref.fused_post_refinement_plain(init, src, tgt, mask, 0.1, 20),
        N * (3 * 4 * 2 + 1) + 16 * 4 * 2 + 4,
        rounds * N * OPS_PER_REFINE_POINT + N * OPS_PER_REFINE_MEAN_POINT, rounds=rounds,
        far_from_origin=dict(n=N_KITTI, thr=1.2, max_abs_err=far_err, rounds=far_rounds,
                             ms=time_ms(lambda: kref.fused_post_refinement(*far, 1.2, 20))))
    return rows


def seed_checks(torch, out, model, cp, src, tgt, tag: str) -> None:
    """Hold the run's seeds and seed fitness against the dense oracles on
    the run's own confidences and seed transforms."""
    from pointdsc_tpu_torch.ops.knn import pairwise_dists_exact
    from pointdsc_tpu_torch.ops.nms import pick_seeds_nms

    # NMS: the dense NMS (exact distances) on the same confidences. A flag
    # may differ only for a pair at |d - R| of a rounding, and one flip
    # shifts later positions, so the sets are compared: overlap >= 0.99.
    oracle = pick_seeds_nms(pairwise_dists_exact(src), out.confidence, model.nms_radius, S)
    same_pos = float((oracle == out.seeds).float().mean())
    overlap = len(set(oracle[0].tolist()) & set(out.seeds[0].tolist())) / S
    # scoring: the [S, N] inlier count of the run's own seed transforms; a
    # point within 1e-5 of tau^2 may count either way.
    st = out.seed_trans
    pred = torch.einsum("bsij,bnj->bsni", st[:, :, :3, :3], src) + st[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    t2 = model.inlier_threshold ** 2
    counts = torch.sum(res2 < t2, dim=-1).float()
    near = torch.sum((res2 - t2).abs() < 1e-5, dim=-1)
    fdiff = (out.seed_fitness * N - counts).abs()
    positive = float((out.confidence > 0).float().mean())
    print(f"{tag}: positive logits {positive:.4f}, seeds vs dense NMS on the same "
          f"confidences: same position {same_pos:.4f}, set overlap {overlap:.4f}; seed "
          f"fitness vs [S, N] count max diff {float(fdiff.max()):.1f} points", flush=True)
    check(overlap >= 0.99, f"{tag}: seeds disagree with the dense NMS")
    check(bool(torch.all(fdiff <= near + 1e-3)), f"{tag}: seed fitness disagrees with the count")


RUNNING_MAX_KERNELS = ("compat_cache_int8", "sc_attention_cached", "confidence_head",
                       "nms_local_max", "nms_select", "seed_knn_exact", "seed_hypotheses",
                       "seed_inlier_counts", "select_hypothesis", "fused_post_refinement")


class Recorded:
    """An Evaluator whose forwards are recorded (transform and labels of every
    call, the warm-up included), so that run_dataset's results can be held
    against the dense path."""

    def __init__(self, evaluator):
        self.ev = evaluator
        self.calls = []
        inner = evaluator._forward

        def forward(*args):
            out = inner(*args)
            self.calls.append(out)
            return out

        evaluator._forward = forward


def run_cell(torch, pt, kernels, dev, tag, model, ds, expect, trans_atol, golden=None):
    """Drive ``Evaluator.run_dataset`` over ds with the counts set to 0 just
    before and read just after; hold every pair against the dense path (and
    the golden file), print the guard's slack and the aggregate recall.
    ``expect``: kernel name -> launches per forward. Returns the counts."""
    import numpy as np

    rec = Recorded(pt.Evaluator(model, fused_attention=True, device=DEVICE))
    torch.cuda.synchronize()
    kernels.reset_launches()
    stats, agg = rec.ev.run_dataset(ds, verbose=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    forwards = len(rec.calls)  # the pairs and one warm-up per bucket
    print(f"{tag}: launches over {forwards} forwards ({len(ds)} pairs + warm-up): "
          f"{json.dumps(counts)}", flush=True)
    print(f"{tag}: guard slack of the last probe {rec.ev.last_slack:.3f} nats, flipped "
          f"{rec.ev.flipped}; registration recall {agg['pair_recall']:.1f}%, RE "
          f"{agg['re']:.4f} deg, TE {agg['te']:.4f} cm, model_time "
          f"{agg['model_time'] * 1e3:.3f} ms", flush=True)
    check(forwards == len(ds) + 1, f"{tag}: {forwards} forwards for {len(ds)} pairs")
    for name, count in counts.items():
        want = expect.get(name, 0) * forwards
        check(count == want, f"{tag}: {name} launched {count} times, expected {want}")
    check(np.isfinite(stats).all() and stats.shape == (len(ds), 12), f"{tag}: bad stats")

    for i in range(len(ds)):
        p = ds[i]
        trans, labels = rec.calls[forwards - len(ds) + i]
        n = p["corr_pos"].shape[0]
        cp, src, tgt = (torch.as_tensor(p[k])[None].to(dev)
                        for k in ("corr_pos", "src_keypts", "tgt_keypts"))
        check(trans.shape == (1, 4, 4) and bool(torch.isfinite(trans).all()),
              f"{tag} pair {i}: bad final_trans")
        dense = rec.ev.model(cp, src, tgt, mask=torch.ones((1, n), dtype=torch.bool, device=dev),
                             fused=False)
        terr = float((trans - dense.final_trans).abs().max())
        agree = float((labels[:, :n] == dense.final_labels).float().mean())
        print(f"{tag} pair {i}: fused-vs-dense final_trans max err {terr:.3e}, label agreement "
              f"{agree:.4f}, success {stats[i, 0]:.0f}", flush=True)
        check(terr <= trans_atol and agree > 0.99, f"{tag} pair {i}: disagrees with dense")
        if golden is not None:
            gerr = float(np.abs(trans[0].cpu().numpy() - golden["final_trans"][i]).max())
            gagree = float(((labels[0, :n].cpu().numpy() > 0.5)
                            == golden["final_labels"][i]).mean())
            print(f"{tag} pair {i}: vs JAX golden final_trans max err {gerr:.3e}, label "
                  f"agreement {gagree:.4f}", flush=True)
            check(gerr <= 1e-3 and gagree > 0.99, f"{tag} pair {i}: disagrees with JAX golden")
    return rec, counts


def default_configuration(torch, pt, kernels, dev) -> dict:
    """Phases 8 to 11. Returns the launches of the five kernels of these
    paths, each from its own path's run."""
    import numpy as np

    from pointdsc_tpu_torch.data import SyntheticPairDataset

    # the seed NMS: flags and keys, then the select (N = 5120); at 12288 the
    # prefilter's top-M select and both gated pairs, whatever the branch
    tail = {"compat_cache_int8": 1, "confidence_head": 1, "nms_local_max": 1, "nms_select": 1,
            "seed_knn_exact": 1, "seed_hypotheses": 1, "seed_inlier_counts": 1,
            "select_hypothesis": 1, "fused_post_refinement": 1}
    tail_kitti = {**tail, "nms_top_m": 1, "nms_local_max": 2, "nms_select": 2}
    launches = {}

    # 8a. Synthetic snapshot, N = 5120: one kernel per layer. Against the
    # dense path: final_trans atol 1e-3, labels > 0.99 (the JAX suite's
    # fused-vs-dense bound), and the same against the JAX dense golden file.
    model = pt.load_pretrained(SNAPSHOT, device=DEVICE)
    ds = SyntheticPairDataset(num_pairs=PAIRS, num_corr=N, **DEFAULT_DATA)
    gold = np.load(GOLDEN_DEFAULT)
    check(int(gold["n"]) == N and int(gold["seed"]) == DEFAULT_DATA["seed"], "wrong golden file")
    rec, counts = run_cell(torch, pt, kernels, dev, "default N=5120", model, ds,
                           {**tail, "fused_encoder_layer": 12}, 1e-3, golden=gold)
    check(not rec.ev.flipped, "the guard flipped on the Synthetic snapshot")
    launches["fused_encoder_layer"] = counts["fused_encoder_layer"]

    # 8b. SyntheticKITTI snapshot, N = 12288: the pair of kernels per layer.
    # Coordinates reach ~90 m, so f32 carries ~1e-5 m; the fused and the dense
    # path refine to the same inlier set: rotation and translation agree to
    # 5e-3 (metres for the translation column), labels > 0.99.
    kitti = pt.load_pretrained(SNAPSHOT_KITTI, device=DEVICE)
    check(kitti.sigma_d == 1.2 and kitti.inlier_threshold == 0.6, "not the KITTI configuration")
    ds_k = SyntheticPairDataset(num_pairs=PAIRS_KITTI, num_corr=N_KITTI, **DEFAULT_DATA_KITTI,
                                **KITTI_DATA)
    rec_k, counts = run_cell(torch, pt, kernels, dev, "default N=12288", kitti, ds_k,
                             {**tail_kitti, "pcn_qkv": 12, "attn_mlp_residual": 12}, 5e-3)
    check(not rec_k.ev.flipped, "the guard flipped on the SyntheticKITTI snapshot")
    launches["pcn_qkv"] = counts["pcn_qkv"]
    launches["attn_mlp_residual"] = counts["attn_mlp_residual"]
    launches["nms_top_m"] = counts["nms_top_m"]

    # 9. half precision: the per-op bf16 encoder around the offset attention
    # kernel, held against the f32 model's dense path. bf16 activations
    # through twelve layers move the features by ~1e-2, but the refinement
    # converges to the same inliers: final_trans atol 1e-3, labels > 0.99.
    half = pt.load_pretrained(SNAPSHOT, device=DEVICE, half_precision=True)
    one = SyntheticPairDataset(num_pairs=1, num_corr=N, **DEFAULT_DATA)
    rec_h, counts = run_cell(torch, pt, kernels, dev, "half precision N=5120", half, one,
                             {**tail, "sc_attention_cached_offset": 12}, 1e-3,
                             golden={k: gold[k][:1] for k in ("final_trans", "final_labels")})
    check(not rec_h.ev.flipped, "the guard flipped in half precision")
    launches["sc_attention_cached_offset"] = counts["sc_attention_cached_offset"]

    # 10. a copy with every key projection scaled by 100: far out of regime,
    # the guard switches to the running-max kernel before any recorded
    # forward; its result is the dense path's of the same weights (atol 5e-3,
    # the JAX suite's bound for this case: logits a hundred times larger also
    # magnify the int8 cache's quantisation)
    bad = pt.load_pretrained(SNAPSHOT, device=DEVICE)
    with torch.no_grad():
        for i in range(bad.encoder.num_layers):
            proj = getattr(bad.encoder, f"NonLocal_layer_{i}").projection_k
            proj.weight.mul_(100.0)
            proj.bias.mul_(100.0)
    rec_b, _ = run_cell(torch, pt, kernels, dev, "scaled keys N=5120", bad, one,
                        {**tail, "sc_attention_cached": 12}, 5e-3)
    check(rec_b.ev.flipped and rec_b.ev.model.offset_softmax is False,
          "the guard did not flip on the scaled copy")

    # 11. the default forward's time, as phase 7
    for tag, m, data, n in (("default", model, ds[0], N), ("default", kitti, ds_k[0], N_KITTI),
                            ("half_precision", half, ds[0], N)):
        ms = time_ms(lambda: pt.register(data["corr_pos"], data["src_keypts"],
                                         data["tgt_keypts"], model=m, device=DEVICE),
                     reps=10, warmup=2)
        print(json.dumps({"metric": "fused_forward_ms_per_pair", "config": tag, "n": n,
                          "value": ms}), flush=True)
    return launches


def lifted_limits(torch, pt, kernels, dev) -> None:
    """Phase 11b: widths, seed counts and neighbour counts the card used to
    refuse, each model (random weights of seed 0, two layers) fused with the
    counts set to 0 just before and read just after, and held against its
    dense path (final_trans atol 1e-3, labels > 0.99): C = 32, k = 16 at
    N = 4096 in the default configuration (the whole-layer kernels, the seed
    k-NN and the seed stage on the width zero-padded to 128; the confidence
    head stays plain below C = 128, as in JAX); ratio 1.0 at N = 8256 in the
    running max (8256 seeds sorted in the select's workspace), whose seeds
    equal the same selection on the CPU exactly; C = 256 at N = 4096 in the
    default configuration (the split pair of layer kernels, two chunks of 128
    channels) and in the running max; C = 128 with k = 160 at N = 4096 (the
    hypotheses kernel with several neighbour rows a thread; the seed k-NN
    plain above k = 128, JAX's gate); and, for their times, C = 256 at
    N = 12288 and k = 160 at N = 5120 (each forward timed, median of 5 after
    one warm-up). Then one fused train step at C = 256,
    depth 2, against the dense step (the tolerance of phase 14), its
    training kernels' counts set to 0 before and read after."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.kernels import nms as knms

    wide_default = {"pcn_qkv": 2, "attn_mlp_residual": 2, "fused_encoder_layer": 0,
                    "seed_knn_exact": 1, "seed_hypotheses": 1, "confidence_head": 0}
    cases = ((f"C=32 N={C32_N}", dict(num_layers=2, num_channels=32, k=16), C32_N,
              {"fused_encoder_layer": 2, "seed_knn_exact": 1, "seed_hypotheses": 1,
               "confidence_head": 0}),
             (f"S=N={ALL_SEEDS_N}", dict(num_layers=2, ratio=1.0, offset_softmax=False),
              ALL_SEEDS_N, {"sc_attention_cached": 2, "nms_select": 1, "seed_knn_exact": 1,
                            "seed_hypotheses": 1}),
             (f"C={WIDE_C} N={C32_N}", dict(num_layers=2, num_channels=WIDE_C), C32_N,
              wide_default),
             (f"C={WIDE_C} N={C32_N} running max",
              dict(num_layers=2, num_channels=WIDE_C, offset_softmax=False), C32_N,
              {"sc_attention_cached": 2, "seed_knn_exact": 1, "seed_hypotheses": 1,
               "confidence_head": 0}),
             (f"k={WIDE_K} N={C32_N}", dict(num_layers=2, k=WIDE_K), C32_N,
              {"fused_encoder_layer": 2, "seed_knn_exact": 0, "seed_hypotheses": 1,
               "confidence_head": 1}),
             (f"C={WIDE_C} N={N_KITTI}", dict(num_layers=2, num_channels=WIDE_C), N_KITTI,
              wide_default),
             (f"k={WIDE_K} N={N}", dict(num_layers=2, k=WIDE_K), N,
              {"fused_encoder_layer": 2, "seed_knn_exact": 0, "seed_hypotheses": 1,
               "confidence_head": 1}))
    for tag, kw, n, want in cases:
        model = pt.PointDSC(device=DEVICE, generator=torch.Generator().manual_seed(0), **kw)
        p = SyntheticPairDataset(num_pairs=1, num_corr=n, seed=4)[0]
        cp, src, tgt = (torch.as_tensor(p[k])[None].to(dev)
                        for k in ("corr_pos", "src_keypts", "tgt_keypts"))
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = model(cp, src, tgt, fused=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        dense = model(cp, src, tgt, fused=False)
        terr = float((out.final_trans - dense.final_trans).abs().max())
        agree = float((out.final_labels == dense.final_labels).float().mean())
        fwd_ms = time_ms(lambda: model(cp, src, tgt, fused=True), reps=5, warmup=1)
        print(json.dumps({"phase": "lifted_limits", "case": tag, "seeds": out.seeds.shape[1],
                          "trans_err_vs_dense": terr, "label_agreement": agree,
                          "fused_forward_ms": fwd_ms, "card": card_line(),
                          "launches": {k: v for k, v in counts.items() if v}}), flush=True)
        for name, count in want.items():
            check(counts[name] == count, f"{tag}: {name} launched {counts[name]} times")
        check(terr <= 1e-3 and agree > 0.99, f"{tag}: the fused forward disagrees with dense")
        if kw.get("ratio") == 1.0:
            plain = knms.pick_seeds_nms_prefiltered(src.cpu(), out.confidence.cpu(),
                                                    model.nms_radius, n)
            check(out.seeds.shape == (1, n) and torch.equal(out.seeds.cpu(), plain),
                  f"{tag}: the seeds differ from the CPU's selection")

    # a fused train step at C = 256 against the dense step
    with torch.enable_grad():
        batch = train_batch(TRAIN_BS, TRAIN_NODE)
        torch.cuda.synchronize()
        kernels.reset_launches()
        fused_step = train_step_grads(torch, pt, batch, True, 2, num_channels=WIDE_C)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        dense_step = train_step_grads(torch, pt, batch, False, 2, num_channels=WIDE_C)
    loss_rel, worst, worst_name = compare_steps(fused_step, dense_step)
    print(json.dumps({"phase": "lifted_limits", "case": f"train step C={WIDE_C}, 2 layers",
                      "loss_rel": loss_rel, "grad_rel": worst, "grad_worst": worst_name,
                      "launches": {k: v for k, v in counts.items() if v}}), flush=True)
    for name in TRAIN_KERNELS:
        check(counts[name] > 0, f"train step C={WIDE_C}: {name} launched no time")
    check(fused_step[0]["grad_finite"] == 1.0 and dense_step[0]["grad_finite"] == 1.0,
          f"train step C={WIDE_C}: a gradient is not finite")
    check(loss_rel <= 1e-4, f"train step C={WIDE_C}: loss terms differ by {loss_rel:.3e}")
    check(worst <= 2e-3, f"train step C={WIDE_C}: gradient of {worst_name} differs by {worst:.3e}")


def real_seeds(torch, pt, kernels, dev) -> None:
    """Phase 11c: each snapshot fused at batch 2 on Synthetic pairs of its
    scale (sample 0 with its last 5% masked, sample 1 with only its first 36
    points valid), the counts set to 0 just before and read just after; the
    forward's seed transforms (the hypotheses kernel's) and the plain
    version's on the card, on the forward's own features, NMS seeds and
    neighbours, against the f64 plain version: every seed's rotation and
    translation within its tolerance. Prints each one's largest error over
    its tolerance, for the inlier seeds and the others."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.kernels import scoring as kscore
    from pointdsc_tpu_torch.kernels import seed_knn as kknn

    for tag, snap, n, data in (("Synthetic", SNAPSHOT, N, {}),
                               ("SyntheticKITTI", SNAPSHOT_KITTI, N_KITTI, KITTI_DATA)):
        model = pt.load_pretrained(snap, device=DEVICE)
        ds = SyntheticPairDataset(num_pairs=2, num_corr=n, inlier_ratio=0.2, seed=5, **data)
        cp, src, tgt, labels = (torch.stack([torch.as_tensor(ds[i][k]) for i in range(2)]).to(dev)
                                for k in ("corr_pos", "src_keypts", "tgt_keypts", "gt_labels"))
        mask = torch.ones((2, n), dtype=torch.bool, device=dev)
        mask[0, n - int(n * PAD_FRACTION):] = False
        mask[1, 36:] = False
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = model(cp, src, tgt, mask=mask, fused=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(counts["seed_hypotheses"] == 1 and counts["seed_knn_exact"] == 1,
              f"real seeds {tag}: the seed stage's kernels were not launched")
        feats, seeds, sigma = out.normed_features, out.seeds, model.sigma.detach()
        knn = kknn.seed_knn_exact(feats, seeds, model.k, mask=mask)
        args = (feats, knn, src, tgt, mask, sigma, model.sigma_d, model.num_iterations)
        ref, tol_rot, tol_trans = kscore.seed_trans_reference(*args)
        inlier = torch.gather(labels.bool() & mask, 1, seeds)
        valid_nb = torch.gather(mask[:, None, :].expand(-1, seeds.shape[1], -1), 2, knn).sum(-1)
        line = {"phase": "real_seeds", "case": tag, "n": n, "seeds": seeds.shape[1],
                "outlier_seeds": int((~inlier).sum()),
                "masked_seeds": int((~torch.gather(mask, 1, seeds)).sum()),
                "fewest_valid_neighbours": int(valid_nb.min()),
                "tol_rot_max": float(tol_rot.max())}
        for name, got in (("kernel", out.seed_trans),
                          ("plain_f32", kscore.seed_transforms_plain(*args))):
            err = (got.double() - ref).abs()
            ratio = torch.maximum(err[..., :3, :3].amax((-1, -2)) / tol_rot,
                                  err[..., :3, 3].amax(-1) / tol_trans)
            line[name] = {"max_err_over_tol_inliers": float(ratio[inlier].max()),
                          "max_err_over_tol_others": float(ratio[~inlier].max()),
                          "max_abs_err_inliers": float(err[inlier].max()),
                          "max_abs_err_others": float(err[~inlier].max())}
            check(bool(torch.all(ratio <= 1.0)),
                  f"real seeds {tag}: the {name} transforms leave the f64 tolerance")
        print(json.dumps(line), flush=True)
        check(line["outlier_seeds"] > 0 and line["masked_seeds"] > 0
              and line["fewest_valid_neighbours"] < model.k,
              f"real seeds {tag}: the case lacks outlier or masked seeds")


TRAIN_KERNELS = ("sc_attention_forward", "sc_attention_backward_dq", "sc_attention_backward_dkv",
                 "sm_loss_sums", "sm_loss_grads")


def train_batch(bs, node, seed=3, inlier_ratio=0.35, **data):
    """A collated numpy batch of bs synthetic pairs of ``node`` correspondences,
    padded to their bucket with a mask (data/pipeline.py)."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset, collate_batch

    ds = SyntheticPairDataset(num_pairs=bs, num_corr=node, inlier_ratio=inlier_ratio, seed=seed,
                              **data)
    return collate_batch([ds[i] for i in range(bs)])


def check_train_kernels(torch, dev) -> list[dict]:
    """Phase 12: the training kernels' public entries against their plain
    versions at bs 16 / N = 1024 (24 padded points per sample), the attention
    trio also at one sample of N = 12288 in the KITTI regime.

    ``library_ms`` is null for all: the compat factor multiplies the logits,
    which ``scaled_dot_product_attention``'s additive mask cannot express, and
    the SM loss never forms M, which every PyTorch call that could compute it
    would. The training kernels' operands are f32, so their operations count
    at the f32 rate; the eval attention without a cache runs its two N^2 C
    products on bf16 operands, which count at the tensor-core rate (with
    ``bound_ms_f32_cores`` beside, as in phase 3)."""
    from pointdsc_tpu_torch.kernels import sc_attention as katt
    from pointdsc_tpu_torch.kernels import sm_loss as ksm
    from pointdsc_tpu_torch.ops.compatibility import feature_similarity
    from pointdsc_tpu_torch.train.losses import spectral_matching_loss

    rows = []

    def row(*args, **kwargs):
        rows.append(kernel_row(*args, **kwargs))

    def attention_case(bs, n, sigma_d, batch, seed):
        src, tgt = (torch.as_tensor(batch[k]).to(dev) for k in ("src_keypts", "tgt_keypts"))
        mask = torch.as_tensor(batch["mask"]).to(dev)
        gen = torch.Generator().manual_seed(seed)
        q, k, v, d_out = (torch.randn((bs, n, C), generator=gen).to(dev) for _ in range(4))
        geom = katt.pack_geometry(src, tgt, mask)
        ref, ref_lse = katt.sc_attention_forward_plain(q, k, v, geom, sigma_d)
        dvec = torch.sum(d_out * ref, dim=-1)
        bwd = (q, k, v, geom, ref_lse, dvec, d_out, sigma_d)
        return dict(fwd=(q, k, v, geom, sigma_d), bwd=bwd, ref=ref, ref_lse=ref_lse,
                    ref_grads=katt.sc_attention_backward_plain(*bwd))

    def attention_errors(case, tag):
        """Tolerances: compat is the same bit for bit in kernel and plain
        version (rounded operations in one order), the 128-term logits and the
        N-term sums run in another order: out and lse atol = rtol = 1e-4, the
        gradients (terms of either sign) 2e-4 at N = 1024 and 5e-4 at
        N = 12288."""
        tol = 2e-4 if case["ref"].shape[1] <= 2048 else 5e-4
        out, lse = katt.sc_attention_forward(*case["fwd"])
        e_out = float((out - case["ref"]).abs().max())
        e_lse = float((lse - case["ref_lse"]).abs().max())
        check(torch.allclose(out, case["ref"], atol=1e-4, rtol=1e-4)
              and torch.allclose(lse, case["ref_lse"], atol=1e-4, rtol=1e-4),
              f"{tag}: attention forward max err out {e_out}, lse {e_lse}")
        dq = katt.sc_attention_backward_dq(*case["bwd"])
        dk, dv = katt.sc_attention_backward_dkv(*case["bwd"])
        errs = {}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), case["ref_grads"]):
            errs[name] = float((got - ref).abs().max())
            check(torch.allclose(got, ref, atol=tol, rtol=tol),
                  f"{tag}: attention backward {name} max err {errs[name]}")
        print(f"{tag}: attention kernels vs plain: out {e_out:.3e}, lse {e_lse:.3e}, dq "
              f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e}", flush=True)
        return max(e_out, e_lse), errs["dq"], max(errs["dk"], errs["dv"])

    # -- the attention trio at the training shape, and at the KITTI scale
    main = attention_case(TRAIN_BS, TRAIN_N, 0.1, train_batch(TRAIN_BS, TRAIN_NODE), seed=4)
    e_f, e_q, e_kv = attention_errors(main, f"bs {TRAIN_BS} N={TRAIN_N}")
    big = attention_case(1, N_KITTI, 1.2, train_batch(1, N_KITTI, **KITTI_DATA), seed=5)
    b_f, b_q, b_kv = attention_errors(big, f"bs 1 N={N_KITTI}")
    # (bytes, operations) of each kernel: the port's yardstick, which
    # tools/time_attention.py also reads
    cm = katt.train_attention_work(TRAIN_BS, TRAIN_N, C)
    cb = katt.train_attention_work(1, N_KITTI, C)
    entries = (
        ("sc_attention_forward", "forward", "sc_attention.py:649", e_f, b_f,
         lambda c: katt.sc_attention_forward(*c["fwd"]),
         lambda c: katt.sc_attention_forward_plain(*c["fwd"])),
        ("sc_attention_backward_dq", "dq", "sc_attention.py:710", e_q, b_q,
         lambda c: katt.sc_attention_backward_dq(*c["bwd"]),
         lambda c: katt.sc_attention_backward_plain(*c["bwd"])),
        ("sc_attention_backward_dkv", "dkv", "sc_attention.py:742", e_kv, b_kv,
         lambda c: katt.sc_attention_backward_dkv(*c["bwd"]),
         lambda c: katt.sc_attention_backward_plain(*c["bwd"])),
    )
    for name, work, replaces, err, err_big, fn, plain_fn in entries:
        # the plain backward computes dq, dk and dv at once: its time stands
        # beside both backward kernels
        big_bound, _ = bound_ms(*cb[work])
        big_ms = time_ms(lambda: fn(big), reps=5, warmup=1)
        row(name, "sc_attention_train.cu", replaces, err, lambda: fn(main),
            lambda: plain_fn(main), *cm[work],
            n12288=dict(max_abs_err=err_big, ms=big_ms,
                        plain_ms=time_ms(lambda: plain_fn(big), reps=5, warmup=1),
                        bound_ms=big_bound, ms_over_bound=big_ms / big_bound))
        rows[-1]["ms_over_bound"] = rows[-1]["ms"] / rows[-1]["bound_ms"]
        print(f"{name}: {rows[-1]['ms']:.4f} ms at bs {TRAIN_BS} / N = {TRAIN_N} "
              f"({rows[-1]['ms_over_bound']:.2f} x its bound {rows[-1]['bound_ms']:.4f}), "
              f"{big_ms:.4f} ms at 1 x {N_KITTI} ({big_ms / big_bound:.2f} x "
              f"{big_bound:.4f})", flush=True)
    del main, big
    torch.cuda.empty_cache()

    # -- the eval attention without a cache, at its path's shape (one pair of
    # N = 5120): the running-max tensor-core loop with the geometry compat
    # source, on the bf16 operands the wrapper rounds the f32 q, k, v to (as
    # the JAX wrapper does off the CPU), p rounded to bf16 before p v. Held
    # to its plain version on those bf16 operands at atol = rtol = 2e-3, the
    # CPU test's tolerance against JAX's kernel fed bf16 (a p on a bf16
    # rounding boundary may round either way: the kernel rounds p against
    # each tile's running max, the plain version against the row's maximum);
    # the compat entries are the plain version's bit for bit. f32 and bf16
    # inputs give the same result, bit for bit.
    x = kernel_inputs(torch, dev)
    q, k, v = x["qkv"]
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    geom = katt.pack_geometry(x["src"], x["tgt"], x["mask"])
    out = katt.fused_sc_attention(q, k, v, x["src"], x["tgt"], 0.1, mask=x["mask"])
    ref = katt.sc_attention_nocache_plain(qh, kh, vh, geom, 0.1)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=2e-3, rtol=2e-3), f"fused_sc_attention max err {err}")
    check(torch.equal(katt.fused_sc_attention(qh, kh, vh, x["src"], x["tgt"], 0.1,
                                              mask=x["mask"]), out),
          "fused_sc_attention: f32 inputs are not the bf16 inputs' result")
    bytes_f, ops_f = katt.train_attention_work(1, N, C)["forward"]
    row("fused_sc_attention", "sc_attention.cu", "sc_attention.py:82", err,
        lambda: katt.fused_sc_attention(q, k, v, x["src"], x["tgt"], 0.1, mask=x["mask"]),
        lambda: katt.sc_attention_nocache_plain(qh, kh, vh, katt.pack_geometry(
            x["src"], x["tgt"], x["mask"]), 0.1), bytes_f - N * 4, ops_f,
        tensor_ops=4.0 * N * N * C)
    del x, q, k, v, qh, kh, vh, geom, out, ref

    # -- SM loss at the training shape and at one sample of N = 12288 in the
    # KITTI regime: unit features, the batch's labels and mask, sigma off its
    # initial 1 so that both sides of the clamp are live. Held to the plain
    # versions on the inputs widened to f64 (the f32 plain dF's own rounding,
    # ~1.5e-6 of its largest entry, exceeds the kernel's and the tolerance).
    # Tolerances: the sums (non-negative terms, added per block then over
    # blocks) rtol 1e-5; dF 1e-6 of its largest entry; dsigma rtol 1e-4. A
    # pair whose u lies within rounding of 0 or 1 may fall on either side of
    # the gate in the two versions: dF may then move by that pair's term
    # (ksm.grads_gate_slack), which the dF check adds where such a pair is.
    def sm_case(bs, n, node, seed, **data):
        batch = train_batch(bs, node, **data)
        gen = torch.Generator().manual_seed(seed)
        f = torch.nn.functional.normalize(torch.randn((bs, n, C), generator=gen),
                                          dim=-1).to(dev)
        gt = torch.as_tensor(batch["gt_labels"]).to(dev)
        mask = torch.as_tensor(batch["mask"]).to(dev)
        strips = ksm.pack_labels(gt, mask)
        wp, wn = ksm.balance_weights(strips, balanced=False)
        sigma = torch.full((bs,), 1.07, device=dev)
        return f, gt, mask, strips, torch.stack([sigma, wp, wn, torch.zeros_like(wp)],
                                                dim=-1).contiguous()

    def sm_errors(f, strips, scalars, tag):
        wide = (f.double(), strips.double(), scalars.double())
        got = [x.double() for x in ksm.sm_loss_sums(f, strips, scalars)]
        ref = ksm.sm_loss_sums_plain(*wide)
        e_sums = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        check(all(torch.allclose(a, b, atol=0, rtol=1e-5) for a, b in zip(got, ref)),
              f"{tag}: SM-loss sums max err {e_sums}")
        (df, ds), (rdf, rds) = ksm.sm_loss_grads(f, strips, scalars), \
            ksm.sm_loss_grads_plain(*wide)
        diff = (df.double() - rdf).abs()
        slack = ksm.grads_gate_slack(*wide)
        e_df, e_ds = float(diff.max()), float((ds.double() - rds).abs().max())
        check(float((diff - slack).max()) <= 1e-6 * float(rdf.abs().max()),
              f"{tag}: SM-loss dF max err {e_df}")
        check(torch.allclose(ds.double(), rds, atol=0, rtol=1e-4),
              f"{tag}: SM-loss dsigma max err {e_ds}")
        print(f"{tag}: SM-loss kernels vs plain (f64): sums {e_sums:.3e}, dF {e_df:.3e} of "
              f"{float(rdf.abs().max()):.3e} ({int((slack > 0).any(-1).sum())} rows with a pair "
              f"at the gate), dsigma {e_ds:.3e}", flush=True)
        return e_sums, e_df, e_ds

    f, gt, mask, strips, scalars = sm_case(TRAIN_BS, TRAIN_N, TRAIN_NODE, 6)
    e_sums, e_df, e_ds = sm_errors(f, strips, scalars, f"bs {TRAIN_BS} N={TRAIN_N}")
    sm_work = ksm.sm_loss_work(TRAIN_BS, TRAIN_N, C)
    row("sm_loss_sums", "sm_loss.cu", "sm_loss.py:87", e_sums,
        lambda: ksm.sm_loss_sums(f, strips, scalars),
        lambda: ksm.sm_loss_sums_plain(f, strips, scalars), *sm_work["sums"])
    row("sm_loss_grads", "sm_loss.cu", "sm_loss.py:108", e_df,
        lambda: ksm.sm_loss_grads(f, strips, scalars),
        lambda: ksm.sm_loss_grads_plain(f, strips, scalars), *sm_work["grads"],
        dsigma_max_abs_err=e_ds)
    big = sm_case(1, N_KITTI, N_KITTI, 7, **KITTI_DATA)
    b_sums, b_df, b_ds = sm_errors(big[0], big[3], big[4], f"bs 1 N={N_KITTI}")
    big_work = ksm.sm_loss_work(1, N_KITTI, C)
    line = []
    for name, fn, work, err in (("sm_loss_sums", ksm.sm_loss_sums, "sums", b_sums),
                                ("sm_loss_grads", ksm.sm_loss_grads, "grads", b_df)):
        ms = time_ms(lambda: fn(big[0], big[3], big[4]), reps=5, warmup=1)
        bound, _ = bound_ms(*big_work[work])
        line.append(f"{name} {ms:.4f} ms ({ms / bound:.2f} x its bound {bound:.4f}), "
                    f"max err {err:.3e}")
    print(f"SM loss at 1 x {N_KITTI}: " + "; ".join(line) + f"; dsigma max err {b_ds:.3e}",
          flush=True)
    del big

    # the public entry against the dense chain it replaces, value and gradients
    grads = []
    for fused in (True, False):
        ff = f.clone().requires_grad_()
        sg = torch.tensor([1.07], device=dev, requires_grad=True)
        if fused:
            loss = ksm.fused_spectral_matching_loss(ff, sg, gt, mask, False)
        else:
            loss = spectral_matching_loss(feature_similarity(ff, sg, mask=mask), gt, mask,
                                          balanced=False)
        loss.backward()
        grads.append((loss.detach(), ff.grad, sg.grad))
    (lf, dff, dsf), (ld, dfd, dsd) = grads
    print(f"fused_spectral_matching_loss vs the dense chain: loss {float(lf):.6f} / "
          f"{float(ld):.6f}, dF max err {float((dff - dfd).abs().max()):.3e} of "
          f"{float(dfd.abs().max()):.3e}, dsigma {float(dsf):.6e} / {float(dsd):.6e}", flush=True)
    check(torch.allclose(lf, ld, atol=0, rtol=1e-5)
          and float((dff - dfd).abs().max()) <= 1e-5 * float(dfd.abs().max())
          and torch.allclose(dsf, dsd, atol=0, rtol=1e-4),
          "fused_spectral_matching_loss disagrees with the dense chain")
    return rows


def no_cache_forward(torch, pt, kernels, dev) -> int:
    """Phase 13: the eval forward with ``fused_cache_compat=False`` on one
    Synthetic pair at N = 5120: twelve launches of the no-cache attention and
    no cache build, held against the dense path as in phase 4 (the f32 compat
    tile is closer to the dense path's than the int8 cache)."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset

    model = pt.load_pretrained(SNAPSHOT, device=DEVICE, fused_cache_compat=False)
    p = SyntheticPairDataset(num_pairs=1, num_corr=N, **DEFAULT_DATA)[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"], model=model,
                      device=DEVICE)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"no-cache forward launches: {json.dumps(counts)}", flush=True)
    check(counts["fused_sc_attention"] == 12 and counts["compat_cache_int8"] == 0
          and counts["fused_encoder_layer"] == 0, "the no-cache forward took another path")
    cp, src, tgt = (torch.as_tensor(p[k])[None].to(dev)
                    for k in ("corr_pos", "src_keypts", "tgt_keypts"))
    with torch.no_grad():
        dense = model(cp, src, tgt, fused=False)
    terr = float((out.final_trans - dense.final_trans).abs().max())
    agree = float((out.final_labels == dense.final_labels).float().mean())
    print(f"no-cache forward: fused-vs-dense final_trans max err {terr:.3e}, label agreement "
          f"{agree:.4f}", flush=True)
    check(terr <= 1e-3 and agree > 0.99, "the no-cache forward disagrees with dense")
    return counts["fused_sc_attention"]


def make_trainer(torch, pt, fused, dataset="3DMatch", model=None, **over):
    """A Trainer on DEVICE with the config's defaults and ``over``, and its
    initial state (seed 0)."""
    from pointdsc_tpu_torch.train.config import default_config
    from pointdsc_tpu_torch.train.trainer import Trainer

    cfg = default_config(dataset)
    cfg.fused_attention = cfg.fused_sm_loss = fused
    cfg.tboard_dir, cfg.verbose = "", False
    for key, value in over.items():
        setattr(cfg, key, value)
    trainer = Trainer(cfg, model=model, device=DEVICE)
    return trainer, trainer.init_state(steps_per_epoch=TRAIN_STEPS_PER_EPOCH, seed=0)


def train_step_grads(torch, pt, batch, fused, layers, eps=0.0, **over):
    """One train step on ``batch`` (its corr_pos scaled by 1 + eps): the
    metrics and every parameter's gradient. At 12 layers the model is the
    Synthetic snapshot, else random weights of seed 0."""
    model = None if layers != 12 else pt.load_pretrained(SNAPSHOT, device=DEVICE)
    trainer, state = make_trainer(torch, pt, fused, model=model, num_layers=layers, **over)
    dev_batch = trainer.to_device(batch)
    dev_batch["corr_pos"] = dev_batch["corr_pos"] * (1.0 + eps)
    state, metrics = trainer.train_step(state, dev_batch, 1)
    return ({k: float(v) for k, v in metrics.items()},
            {name: p.grad.clone() for name, p in state.model.named_parameters()})


def compare_steps(a, b):
    """Largest loss-term and gradient differences of two steps, relative:
    each parameter's gradient difference over its largest entry + 1e-2 of
    the largest entry of all."""
    (ma, ga), (mb, gb) = a, b
    scale = 1e-2 * max(float(g.abs().max()) for g in gb.values())
    worst, worst_name = 0.0, ""
    for name, g in gb.items():
        rel = float((ga[name] - g).abs().max()) / (float(g.abs().max()) + scale)
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = max(abs(ma[k] - mb[k]) / abs(mb[k]) for k in ("class_loss", "sm_loss"))
    return loss_rel, worst, worst_name


def training(torch, pt, kernels, dev) -> dict:
    """Phases 14 to 18. Returns the launches of the five training kernels
    over the Trainer's run of phase 15."""
    import tempfile
    import time

    from pointdsc_tpu_torch.data import Loader, SyntheticPairDataset

    def make(fused, dataset="3DMatch", model=None, **over):
        return make_trainer(torch, pt, fused, dataset, model, **over)

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30

    # 14. one step, fused against dense, same weights and batch. The two
    # differ in the compat matrix (gram-form distances in the kernels, the
    # difference form in the dense path: ~1e-4 of compat after the division by
    # sigma_d^2) and in summation order. The train-mode forward of the full
    # depth is ill-conditioned: through twelve layers (logits of tens of nats,
    # batch statistics) a difference of one f32 rounding grows by a factor of
    # 2 to 4 per layer, so the dense path moves by ~1e-3 of its own loss when
    # its input moves by 1e-6. The check is therefore made at depth 2 (full
    # width, random weights of seed 0): loss terms rtol 1e-4, each parameter's
    # gradient within 2e-3 of (its largest entry + 1e-2 of the largest entry
    # of all): a bias in front of a training BatchNorm has a true gradient of
    # zero, and what it holds is rounding of the terms that cancel. At depth
    # 12, on the Synthetic snapshot's weights, the same numbers are printed
    # beside the dense path's own movement under a 1e-6 input perturbation,
    # and decide nothing beyond being finite.
    batch = train_batch(TRAIN_BS, TRAIN_NODE)

    def one_step(fused, layers, eps=0.0):
        return train_step_grads(torch, pt, batch, fused, layers, eps)

    compare = compare_steps

    for layers in (2, 12):
        fused_step, dense_step = one_step(True, layers), one_step(False, layers)
        mf, md = fused_step[0], dense_step[0]
        loss_rel, worst, worst_name = compare(fused_step, dense_step)
        line = (f"train step fused vs dense, {layers} layers: class_loss {mf['class_loss']:.6f} / "
                f"{md['class_loss']:.6f}, sm_loss {mf['sm_loss']:.6f} / {md['sm_loss']:.6f}, "
                f"trans_loss {mf['trans_loss']:.6f} / {md['trans_loss']:.6f}; largest relative "
                f"gradient difference {worst:.3e} ({worst_name}, of {len(dense_step[1])} "
                "parameters)")
        check(mf["grad_finite"] == 1.0 and md["grad_finite"] == 1.0, "a gradient is not finite")
        if layers == 2:
            print(line, flush=True)
            check(loss_rel <= 1e-4, f"loss terms fused vs dense differ by {loss_rel:.3e}")
            check(worst <= 2e-3, f"gradient of {worst_name} differs by {worst:.3e}")
        else:
            own_loss, own_grad, _ = compare(one_step(False, layers, eps=1e-6), dense_step)
            print(f"{line}; the dense path against itself with its input scaled by 1 + 1e-6: "
                  f"loss terms {own_loss:.3e}, gradients {own_grad:.3e} (fused vs dense loss "
                  f"terms {loss_rel:.3e})", flush=True)
        del fused_step, dense_step
    torch.cuda.empty_cache()

    # 15. the Trainer, fused, on the synthetic loader: two epochs of 12 steps,
    # evaluate, save_checkpoint. Counts set to 0 just before, read just after.
    ds = SyntheticPairDataset(num_pairs=TRAIN_BS * TRAIN_STEPS_PER_EPOCH, num_corr=TRAIN_NODE,
                              inlier_ratio=0.35, seed=17)
    val = SyntheticPairDataset(num_pairs=TRAIN_BS * 2, num_corr=TRAIN_NODE, inlier_ratio=0.35,
                               seed=9999)
    # no shuffle: both epochs see the same batches, so their mean losses compare
    loader = Loader(ds, TRAIN_BS, shuffle=False, num_workers=4)
    val_loader = Loader(val, TRAIN_BS, num_workers=4)
    with tempfile.TemporaryDirectory() as tmp:
        trainer, state = make(True, verbose=True, tboard_dir=os.path.join(tmp, "tb"),
                              snapshot_dir=tmp, save_dir=os.path.join(tmp, "models"),
                              training_max_iter=TRAIN_STEPS_PER_EPOCH, val_max_iter=2)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for epoch in (1, 2):
            state = trainer.train_epoch(loader, state, epoch)
        res = trainer.evaluate(val_loader, state)
        path = trainer.save_checkpoint(state, "best")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        trainer.cfg.save(os.path.join(tmp, "config.json"))
        trainer.logger.close()
        # the same eval batches through the dense eval step on the same
        # half-trained weights: a finding, not a check (the fused eval step
        # runs the offset softmax with no regime guard, as the JAX Trainer's)
        dense_trainer, _ = make(False, model=state.model, val_max_iter=2)
        res_dense = dense_trainer.evaluate(val_loader, state)
        print("eval step fused vs dense after the steps: " + ", ".join(
            f"{k} {res[k]:.6f} / {res_dense[k]:.6f}"
            for k in ("class_loss", "sm_loss", "trans_loss", "reg_recall", "f1")), flush=True)
        with open(trainer.logger.path) as fh:
            events = [json.loads(line) for line in fh]
        steps = 2 * TRAIN_STEPS_PER_EPOCH
        print(f"trainer launches over {steps} steps + 2 eval batches: {json.dumps(counts)}",
              flush=True)
        losses = [e["value"] for e in events if e["tag"] == "Train/loss"]
        finite = [e["value"] for e in events if e["tag"] == "Train/grad_finite"]
        print(f"trainer: mean loss of epoch 1 {losses[0]:.6f}, of epoch 2 {losses[1]:.6f}; "
              f"grad_finite {finite}; step {state.step}; "
              f"lr {state.scheduler.get_last_lr()[0]:.6e}; "
              f"eval {json.dumps(res)}; {wall:.1f} s in all", flush=True)
        check(len(losses) == 2 and all(map(math.isfinite, losses)) and losses[1] < losses[0],
              "the training loss is not finite and falling")
        check(finite == [1.0, 1.0], "a step had non-finite gradients")
        check(all(math.isfinite(v) for v in res.values()), "evaluate returned a non-finite metric")
        check(state.step == steps and abs(state.scheduler.get_last_lr()[0]
                                          - 1e-4 * 0.99 ** 2) < 1e-12, "step or schedule count")
        # per train step: 12 forward + 12 dQ + 12 dK,dV launches and one SM
        # forward and backward; per eval batch the cache, 12 whole-layer
        # kernels and the SM forward; scoring once in each. The seed k-NN
        # kernel stays out below N = 4096, as in the JAX model.
        expect = {"sc_attention_forward": 12 * steps, "sc_attention_backward_dq": 12 * steps,
                  "sc_attention_backward_dkv": 12 * steps, "sm_loss_sums": steps + 2,
                  "sm_loss_grads": steps, "compat_cache_int8": 2, "fused_encoder_layer": 24,
                  "seed_inlier_counts": steps + 2}
        for name, count in counts.items():
            check(count == expect.get(name, 0),
                  f"trainer: {name} launched {count} times, expected {expect.get(name, 0)}")

        # 18. the checkpoint through load_pretrained and register
        model = pt.load_pretrained(tmp, device=DEVICE)
        for key, value in state.model.state_dict().items():
            check(torch.equal(value, model.state_dict()[key]), f"checkpoint: {key} differs")
        p = SyntheticPairDataset(num_pairs=1, num_corr=TRAIN_N, inlier_ratio=0.35, seed=5)[0]
        out = pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"], model=model,
                          device=DEVICE)
        check(out.final_trans.shape == (1, 4, 4) and bool(torch.isfinite(out.final_trans).all())
              and out.final_labels.shape == (1, TRAIN_N), "checkpoint: bad registration output")
        print(f"checkpoint {os.path.basename(path)} ({os.path.getsize(path)} bytes): loaded by "
              "load_pretrained, state dict equal, register gives a finite transform", flush=True)
    del trainer, state, model
    torch.cuda.empty_cache()

    # 16. ms per step, peak memory and launches per step, fused and dense
    # (host clock around a step that ends in a synchronise; median of 10
    # after 3 warm-ups)
    for fused in (True, False):
        trainer, state = make(fused)
        dev_batch = trainer.to_device(batch)
        for _ in range(3):
            state, _ = trainer.train_step(state, dev_batch, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            state, _ = trainer.train_step(state, dev_batch, 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v / 10 for k, v in kernels.launch_counts().items() if v}
        print(json.dumps({"metric": "train_step_ms", "config": "fused" if fused else "dense",
                          "bs": TRAIN_BS, "n": TRAIN_N, "value": statistics.median(times),
                          "peak_memory_gib": peak_gib(), "launches_per_step": per_step}),
              flush=True)
        del trainer, state
        torch.cuda.empty_cache()

    # 17. the KITTI regime: two fused steps through train_epoch, then one
    # dense step for its memory figure only (an out-of-memory error is a
    # finding, not a failure)
    kitti = dict(num_node=N_KITTI, batch_size=KITTI_BS, inlier_threshold=0.6, sigma_d=1.2,
                 training_max_iter=2)
    ds_k = SyntheticPairDataset(num_pairs=2 * KITTI_BS, num_corr=N_KITTI, inlier_ratio=0.35,
                                seed=17, **KITTI_DATA)
    with tempfile.TemporaryDirectory() as tmp:
        trainer, state = make(True, "KITTI", verbose=True, tboard_dir=tmp, **kitti)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = trainer.train_epoch(Loader(ds_k, KITTI_BS, num_workers=2), state, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer.logger.close()
        with open(trainer.logger.path) as fh:
            events = {e["tag"]: e["value"] for e in map(json.loads, fh)}
    print(json.dumps({"metric": "kitti_regime_fused", "bs": KITTI_BS, "n": N_KITTI, "steps": 2,
                      "mean_loss": events["Train/loss"], "grad_finite": events["Train/grad_finite"],
                      "s_per_step": wall / 2, "peak_memory_gib": peak_gib()}), flush=True)
    check(math.isfinite(events["Train/loss"]) and events["Train/grad_finite"] == 1.0
          and state.step == 2, "the KITTI-regime steps failed")
    del trainer, state
    torch.cuda.empty_cache()
    trainer, state = make(False, "KITTI", **kitti)
    kbatch = trainer.to_device(train_batch(KITTI_BS, N_KITTI, seed=17, **KITTI_DATA))
    torch.cuda.reset_peak_memory_stats()
    try:
        state, metrics = trainer.train_step(state, kbatch, 1)
        torch.cuda.synchronize()
        print(json.dumps({"finding": "kitti_regime_dense", "fits": True,
                          "loss": float(metrics["loss"]), "peak_memory_gib": peak_gib()}),
              flush=True)
    except torch.cuda.OutOfMemoryError:
        print(json.dumps({"finding": "kitti_regime_dense", "fits": False,
                          "peak_memory_gib_before_the_error": peak_gib()}), flush=True)
    del trainer, state, kbatch
    torch.cuda.empty_cache()
    # the eval batches' cache builds at TRAIN_N, below the symmetric gate: the
    # full-grid kernel's launches (phase 3's compat_cache_int8_full_grid row)
    return {**{name: counts[name] for name in TRAIN_KERNELS},
            "compat_cache_int8_full_grid": counts["compat_cache_int8"]}


def scene_keypoints(seed=0):
    """The demo scene's raw clouds, gt and voxel-downsampled keypoints."""
    from pointdsc_tpu_torch.descriptors import voxel_downsample

    src, tgt, gt = make_scene(seed, n_points=SCENE_POINTS)
    return src, tgt, gt, voxel_downsample(src, DEMO_VOXEL), voxel_downsample(tgt, DEMO_VOXEL)


def plain_nn(query, base, base_mask=None):
    """``kernels.nn_search.nearest_neighbors`` through its plain version, on
    the tensors' own device: the [N, M] matrix in the kernel's operations."""
    from pointdsc_tpu_torch.kernels import nn_search as knn

    single = query.ndim == 2
    qp, bp = knn.pack_points(query), knn.pack_points(base, base_mask)
    d2, idx = knn.nearest_neighbors_plain(qp[None] if single else qp, bp[None] if single else bp)
    return (d2[0], idx[0]) if single else (d2, idx)


def plain_icp_path():
    """A context in which ops/icp.py searches through the plain version."""
    from unittest import mock

    from pointdsc_tpu_torch.ops import icp as icp_mod

    return mock.patch.object(icp_mod, "nearest_neighbors", plain_nn)


def check_registration_kernels(torch, dev) -> list[dict]:
    """Phase 19: the nearest-neighbour kernel and the symmetric cache build
    against their plain versions on the card.

    nearest_neighbors: the demo scene's keypoints at N = M = 20480 (source
    points moved by gt onto the target), at 5120 with 30% of the base
    masked, and with every base point masked. d2 equal bit for bit (the
    kernel rounds each operation in the plain version's order); the index
    equal, or where not, the d2 at both indices equal. ``library_ms`` is null:
    ``torch.cdist(q, b).min(dim=1)`` computes the same function in two calls
    (a matrix and a reduction); its time stands beside as ``cdist_min_ms``.
    Beside the wrapper's time, the kernel's own (``kernel_ms``, torch.profiler)
    and the device operations of a search: 1, or 2 where the base is split
    over blocks (the merge's workspace set to ones, then the kernel). Phase 19's
    own line prints the launch's grid and, beside the bound (9 f32 operations
    a pair at the f32 rate), the issue floor of the kernel's 10 instructions
    a pair at the H100's published SM count and clock
    (``kernels/nn_search.py``); neither is measured, so neither is in the row.

    compat_cache_int8_sym: equal byte for byte to the full-grid kernel at
    N = 5120 and 20480 (compat_level is exactly symmetric), and within +-1 on
    <= 0.1% of entries of its plain version (cuBLAS's gram-form distances
    round otherwise); timed at N = 20480 beside the full-grid kernel's launch
    (``full_grid_ms``). Its bound counts the output written once (the N^2
    bytes) and the N(N+1)/2 entries a symmetric
    build must compute. ``library_ms`` is null: no PyTorch call builds it."""
    import numpy as np

    from pointdsc_tpu_torch.kernels import nn_search as knn
    from pointdsc_tpu_torch.kernels import sc_attention as katt
    from pointdsc_tpu_torch.kernels import symcache as ksym
    from pointdsc_tpu_torch.tools.time_attention import _device_split

    rows = []
    _, _, gt, skp, tkp = scene_keypoints()
    gen = np.random.default_rng(0)

    def case(n, mask_share):
        s = skp[gen.choice(len(skp), n, replace=len(skp) < n)]
        t = tkp[gen.choice(len(tkp), n, replace=len(tkp) < n)]
        q = torch.as_tensor(s @ gt[:3, :3].T.astype(np.float32) + gt[:3, 3].astype(np.float32))
        mask = None if mask_share is None else torch.as_tensor(gen.uniform(size=n) >= mask_share)
        return (q.float().contiguous().to(dev), torch.as_tensor(t).contiguous().to(dev),
                None if mask is None else mask.to(dev))

    errs = {}
    for tag, (n, share) in (("full", (NN_N, None)), ("masked", (NN_N_MASKED, 0.3)),
                            ("all_masked", (NN_N_MASKED, 1.0))):
        q, b, m = case(n, share)
        d2, idx = knn.nearest_neighbors(q, b, m)
        rd, ri = plain_nn(q, b, m)
        check(torch.equal(d2, rd), f"nn-search {tag}: d2 differs from the plain version's "
                                   f"by {float((d2 - rd).abs().max())}")
        diff = idx != ri
        if bool(diff.any()):  # the d2 at both indices, the plain way
            qp, bp = knn.pack_points(q[diff]), knn.pack_points(b, m)
            at = lambda i: ((qp[:, 3] + bp[i, 3]) - 2.0 * ((qp[:, 0] * bp[i, 0] + qp[:, 1]
                            * bp[i, 1]) + qp[:, 2] * bp[i, 2]))
            check(torch.equal(at(idx[diff]), at(ri[diff])), f"nn-search {tag}: indices differ")
        if share == 1.0:
            check(bool((idx == 0).all()) and bool((d2 == 1e30).all()),
                  "nn-search with every base point masked: not (1e30, 0)")
        errs[tag] = dict(index_mismatches=int(diff.sum()), max_abs_err=float((d2 - rd).abs().max()))
        if tag == "full":
            fq, fb = q, b
    print(f"nearest_neighbors vs plain: {json.dumps(errs)}", flush=True)
    n = NN_N
    b_, o_ = bound_ms(*knn.nn_search_work(1, n, n))
    split = _device_split(lambda: knn.nearest_neighbors(fq, fb), "nn_kernel")
    grid = knn.nn_grid(1, n, n, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"nearest_neighbors at N = M = {n}: grid (query blocks, splits, range) {list(grid)}, "
          f"issue floor {knn.nn_issue_floor_ms(1, n, n)} ms, bound {b_} ms ({o_})", flush=True)
    rows.append(dict(
        name="nearest_neighbors", route="cuda",
        source="pointdsc_tpu_torch/kernels/csrc/nn_search.cu",
        replaces="pointdsc_tpu/kernels/nn_search.py:38", max_abs_err=errs["full"]["max_abs_err"],
        ms=time_ms(lambda: knn.nearest_neighbors(fq, fb)),
        plain_ms=time_ms(lambda: plain_nn(fq, fb), reps=10),
        bound_ms=b_, bound_by=o_, library_ms=None,
        cdist_min_ms=time_ms(lambda: torch.cdist(fq, fb).min(dim=1), reps=10),
        kernel_ms=split["kernel_ms"], device_ops=split["device_ops"],
        n=n, m=n, index_mismatches=errs["full"]["index_mismatches"],
        masked_5120=errs["masked"], all_masked_5120=errs["all_masked"]))
    want = 2 if grid[1] > 1 else 1
    check(split["device_ops"] == want, f"nearest_neighbors: {split['device_ops']} device "
                                       f"operations a search, expected {want}")
    del fq, fb
    torch.cuda.empty_cache()

    from pointdsc_tpu_torch.data import SyntheticPairDataset

    for n in (N, NN_N):
        ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.3, seed=7)[0]
        src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
        tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
        full = katt._launch_compat_cache(src, tgt, katt.cache_coef(0.1))
        sym = ksym.build_compat_cache_int8_sym(src, tgt, 0.1)
        check(torch.equal(sym, full), f"symmetric cache differs from the full-grid one at N = {n}")
        plain = ksym.compat_cache_sym_plain(katt.pack_geometry(src, tgt), katt.cache_coef(0.1))
        d = (sym.int() - plain.int()).abs()
        off1 = int((d == 1).sum())
        check(int(d.max()) <= 1 and off1 <= 1e-3 * n * n,
              f"symmetric cache vs plain at N = {n}: max {int(d.max())}, {off1} off by 1")
        del full, sym, plain, d
        torch.cuda.empty_cache()
    b_, o_ = bound_ms(*katt.compat_cache_work(1, n))
    rows.append(dict(
        name="compat_cache_int8_sym", route="cuda",
        source="pointdsc_tpu_torch/kernels/csrc/compat_cache_sym.cu",
        replaces="tools/exp_symcache.py:49,73", max_abs_err=1.0 if off1 else 0.0,
        ms=time_ms(lambda: ksym.build_compat_cache_int8_sym(src, tgt, 0.1), reps=10),
        plain_ms=time_ms(lambda: ksym.compat_cache_sym_plain(katt.pack_geometry(src, tgt),
                                                             katt.cache_coef(0.1)), reps=5),
        bound_ms=b_, bound_by=o_, library_ms=None, n=n, off_by_one=off1,
        full_grid_ms=time_ms(lambda: katt._launch_compat_cache(src, tgt, katt.cache_coef(0.1)),
                             reps=10)))
    torch.cuda.empty_cache()
    return rows


def rot_error_deg(a, b):
    import numpy as np

    r = a[:3, :3] @ b[:3, :3].T
    return float(np.degrees(np.arccos(np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0))))


def registration_demo(torch, kernels, dev) -> int:
    """Phase 20: the registration demo (``tools/demo_registration.main``) on
    the seeded scene, written as PLY into a temporary directory: FPFH,
    matching, the forward with the Synthetic snapshot (5000 correspondences,
    bucket 5120), ICP on the whole keypoint clouds; counts set to 0 just
    before and read just after. The pair must register by the repository's
    rule (RE < 15 deg, TE < 30 cm), with the nn-search kernel launched once
    per ICP iteration (20). Then, on the same keypoint clouds: ICP from gt
    perturbed by 3 deg / 5 cm must come within 1 deg / 2 cm; ICP on the card
    must agree with ICP through the plain search within 1e-5 in the
    transform, and the information matrix within 1e-5 relative, its [5, 5]
    count exactly. Returns the nn-search launches of the demo's run."""
    import tempfile

    import numpy as np

    from pointdsc_tpu_torch.data.ply import write_ply_xyz
    from pointdsc_tpu_torch.ops.icp import icp_point_to_point, information_matrix
    from pointdsc_tpu_torch.tools import demo_registration

    src, tgt, gt, skp, tkp = scene_keypoints()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_ply_xyz(os.path.join(tmp, "src.ply"), src)
        write_ply_xyz(os.path.join(tmp, "tgt.ply"), tgt)
        os.chdir(ROOT)  # the demo reads snapshot/<name> from the working directory
        try:
            report = {}
            torch.cuda.synchronize()
            kernels.reset_launches()
            trans = demo_registration.main(
                ["--src_path", os.path.join(tmp, "src.ply"), "--tgt_path",
                 os.path.join(tmp, "tgt.ply"), "--chosen_snapshot", "PointDSC_Synthetic_release",
                 "--num_node", str(DEMO_NODE), "--voxel_size", str(DEMO_VOXEL), "--use_icp",
                 "true", "--out_dir", os.path.join(tmp, "out"), "--device", DEVICE],
                report=report)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            os.chdir(cwd)
    sample = report["sample"]
    warped = sample["src_keypts"] @ gt[:3, :3].T + gt[:3, 3]
    ratio = float(np.mean(np.linalg.norm(warped - sample["tgt_keypts"], axis=1) < 0.1))
    re, te = rot_error_deg(trans, gt), float(np.linalg.norm(trans[:3, 3] - gt[:3, 3]))
    print(json.dumps({"phase": "registration_demo", "raw_points": [len(src), len(tgt)],
                      "keypoints": list(report["keypoints"]), "correspondences": len(warped),
                      "inlier_ratio": ratio, "regime_slack": report["slack"],
                      "guard_flipped": report["flipped"], "stages_s": report["stages_s"],
                      "icp_fitness_rmse": report["icp"], "re_deg": re, "te_m": te,
                      "launches": {k: v for k, v in counts.items() if v}}), flush=True)
    check(np.isfinite(trans).all() and re < 15.0 and te < 0.30,
          f"the demo did not register the scene: RE {re:.3f} deg, TE {te:.4f} m")
    check(counts["nearest_neighbors"] == 20, f"nn-search launched {counts['nearest_neighbors']} "
                                             "times in the demo, expected 20")
    attention = "sc_attention_cached" if report["flipped"] else "fused_encoder_layer"
    for name in ("compat_cache_int8", attention, "confidence_head", "nms_local_max",
                 "nms_select", "seed_knn_exact", "seed_hypotheses", "seed_inlier_counts",
                 "select_hypothesis", "fused_post_refinement"):
        check(counts[name] > 0, f"the demo's forward did not launch {name}")

    s = torch.as_tensor(skp, device=dev)
    t = torch.as_tensor(tkp, device=dev)
    gen = np.random.default_rng(1)
    init = gt.copy()
    axis = gen.normal(size=3)
    init[:3, :3] = _rot(axis, np.deg2rad(3.0)) @ gt[:3, :3]
    step = gen.normal(size=3)
    init[:3, 3] += 0.05 * step / np.linalg.norm(step)
    init_t = torch.as_tensor(init, dtype=torch.float32, device=dev)
    got, fit, rmse = icp_point_to_point(s, t, init_t, 0.1)
    with plain_icp_path():
        ref, fit_p, rmse_p = icp_point_to_point(s, t, init_t, 0.1)
    g = got.cpu().numpy()
    re2, te2 = rot_error_deg(g, gt), float(np.linalg.norm(g[:3, 3] - gt[:3, 3]))
    err = float((got - ref).abs().max())
    gt_t = torch.as_tensor(gt, dtype=torch.float32, device=dev)
    info = information_matrix(s, t, gt_t, 0.1)
    with plain_icp_path():
        info_p = information_matrix(s, t, gt_t, 0.1)
    info_err = float((info - info_p).abs().max() / info_p.abs().max())
    print(json.dumps({"phase": "icp_from_perturbed_gt", "re_deg": re2, "te_m": te2,
                      "fitness": float(fit), "rmse": float(rmse), "vs_plain_max_abs_err": err,
                      "info_rel_err": info_err, "info_55": float(info[5, 5]),
                      "info_55_plain": float(info_p[5, 5])}), flush=True)
    check(re2 < 1.0 and te2 < 0.02, f"ICP from gt perturbed by 3 deg / 5 cm: {re2} deg, {te2} m")
    check(err <= 1e-5 and abs(float(fit) - float(fit_p)) <= 1e-6
          and abs(float(rmse) - float(rmse_p)) <= 1e-6, f"ICP on the card vs plain: {err}")
    check(info_err <= 1e-5 and float(info[5, 5]) == float(info_p[5, 5]),
          f"information matrix on the card vs plain: {info_err}")
    fpfh_card_vs_cpu(src, tgt)
    return counts["nearest_neighbors"]


def fpfh_card_vs_cpu(src, tgt) -> None:
    """End of phase 20: the demo clouds' FPFH features on the card against
    the same pipeline on the CPU, by the CPU parity rule of
    tests/test_torch_fpfh.py: the same keypoints, and at least 99.5% of the
    feature entries within 1e-3 (an angle on a bin edge may fall on either
    side of it)."""
    import time

    import numpy as np

    from pointdsc_tpu_torch.descriptors import extract_fpfh

    within, total, worst, seconds = 0, 0, 0.0, {}
    for cloud in (src, tgt):
        for where in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            keypts, feats = extract_fpfh(cloud, voxel_size=DEMO_VOXEL, device=where)
            seconds[where] = seconds.get(where, 0.0) + time.perf_counter() - t0
            if where == DEVICE:
                card_keypts, card_feats = keypts, feats
        check(np.array_equal(card_keypts, keypts), "FPFH keypoints differ between card and CPU")
        diff = np.abs(card_feats - feats)
        within += int((diff <= 1e-3).sum())
        total += diff.size
        worst = max(worst, float(diff.max()))
    share = within / total
    print(json.dumps({"phase": "fpfh_card_vs_cpu", "entries": total, "share_within_1e-3": share,
                      "max_abs_diff": worst, "seconds": seconds}), flush=True)
    check(share >= 0.995, f"FPFH on the card vs the CPU: {share:.6f} of the entries within 1e-3")


def evaluator_with_icp(torch, pt, kernels, dev) -> None:
    """Phase 21: ``Evaluator(use_icp=True, icp_threshold=0.1)`` with the
    default configuration on the three Synthetic pairs of phase 8 (N = 5120),
    beside the same Evaluator without ICP: recall no lower, nn-search launched
    20 times per forward (the pairs and the bucket's warm-up)."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset

    model = pt.load_pretrained(SNAPSHOT, device=DEVICE)
    ds = SyntheticPairDataset(num_pairs=PAIRS, num_corr=N, **DEFAULT_DATA)
    res = {}
    for icp in (False, True):
        ev = pt.Evaluator(model, fused_attention=True, use_icp=icp, icp_threshold=0.1,
                          device=DEVICE)
        torch.cuda.synchronize()
        kernels.reset_launches()
        stats, agg = ev.run_dataset(ds, verbose=False)
        torch.cuda.synchronize()
        res[icp] = dict(recall=agg["pair_recall"], re=agg["re"], te=agg["te"],
                        model_time_ms=agg["model_time"] * 1e3,
                        nn_launches=kernels.launch_counts()["nearest_neighbors"])
        check(stats.shape == (PAIRS, 12) and bool(torch.isfinite(torch.as_tensor(stats)).all()),
              "Evaluator with ICP: bad stats")
    print(json.dumps({"phase": "evaluator_use_icp", "n": N, "pairs": PAIRS,
                      "without_icp": res[False], "with_icp": res[True]}), flush=True)
    check(res[True]["recall"] >= res[False]["recall"], "ICP lowered the recall")
    check(res[True]["nn_launches"] == 20 * (PAIRS + 1) and res[False]["nn_launches"] == 0,
          f"nn-search launches {res[True]['nn_launches']} with ICP, expected {20 * (PAIRS + 1)}")


def icp_crossover(torch, dev) -> None:
    """Phase 22, a finding: ``icp_point_to_point`` (20 iterations) at
    N = M in ICP_SIZES with the kernel and with the plain search, on the
    same card (CUDA events, median of 5 after 1 warm-up), and one search
    alone each way (median of 10): the data for a size gate like the TPU's
    N * M >= 64M, which the port does not have."""
    import numpy as np

    from pointdsc_tpu_torch.kernels.nn_search import nearest_neighbors
    from pointdsc_tpu_torch.ops.icp import icp_point_to_point

    _, _, gt, skp, tkp = scene_keypoints()
    gen = np.random.default_rng(2)
    init = torch.as_tensor(gt, dtype=torch.float32, device=dev)
    out = []
    for n in ICP_SIZES:
        s = torch.as_tensor(skp[gen.choice(len(skp), n, replace=len(skp) < n)], device=dev)
        t = torch.as_tensor(tkp[gen.choice(len(tkp), n, replace=len(tkp) < n)], device=dev)
        kernel_ms = time_ms(lambda: icp_point_to_point(s, t, init, 0.1), reps=5, warmup=1)
        with plain_icp_path():
            plain_ms = time_ms(lambda: icp_point_to_point(s, t, init, 0.1), reps=5, warmup=1)
        out.append(dict(n=n, kernel_ms=kernel_ms, plain_ms=plain_ms,
                        search_kernel_ms=time_ms(lambda: nearest_neighbors(s, t), reps=10),
                        search_plain_ms=time_ms(lambda: plain_nn(s, t), reps=10)))
        torch.cuda.empty_cache()
    print(json.dumps({"finding": "icp_crossover", "iterations": 20, "card": card_line(),
                      "sizes": out}), flush=True)


def symcache_experiment(kernels) -> int:
    """Phase 23: the experiment tool ``tools/exp_symcache.py`` at each N of
    SYM_RUNS (both cache kernels' times, the card's name and power limit),
    counts set to 0 before the first and read after it. Returns the
    symmetric build's launches of that run."""
    from pointdsc_tpu_torch.tools import exp_symcache

    launches = None
    for n in SYM_RUNS:
        os.environ.update(PROFILE_N=str(n), PROFILE_ITERS="16")
        kernels.reset_launches()
        res = exp_symcache.main([])
        if launches is None:
            launches = kernels.launch_counts()["compat_cache_int8_sym"]
        check(res["bitwise_equal"], f"symmetric cache differs at N = {n}")
    return launches


def write_snapshot(workdir, name, release, **over):
    """``<workdir>/snapshot/<name>/``: the release's config.json with
    ``over`` applied and a copy of its ``models/model_best.pkl``."""
    import shutil

    with open(os.path.join(release, "config.json")) as f:
        cfg = json.load(f)
    cfg.update(over, exp_id=name)
    snap = os.path.join(workdir, "snapshot", name)
    os.makedirs(os.path.join(snap, "models"), exist_ok=True)
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    shutil.copy(os.path.join(release, "models", "model_best.pkl"), os.path.join(snap, "models"))


@contextlib.contextmanager
def recorded_cli_evaluators():
    """Every Evaluator the eval CLIs build (``evaluation/_cli.py::
    make_evaluator``) as a ``Recorded`` (its forwards, warm-ups included)
    whose ``pairs`` list each evaluated sample with its transform and
    labels."""
    from pointdsc_tpu_torch.evaluation import _cli

    made, make = [], _cli.make_evaluator

    def recording(*args, **kwargs):
        ev = make(*args, **kwargs)
        rec = Recorded(ev)
        rec.pairs = []
        run_pair = ev.run_pair

        def run(sample, scene_ind=0, data_time=0.0):
            row, trans = run_pair(sample, scene_ind=scene_ind, data_time=data_time)
            rec.pairs.append((sample, trans, rec.calls[-1][1]))  # the timed forward's labels
            return row, trans

        ev.run_pair = run
        made.append(rec)
        return ev

    _cli.make_evaluator = recording
    try:
        yield made
    finally:
        _cli.make_evaluator = make


@contextlib.contextmanager
def counted(torch, kernels):
    """Launch counts of the block: set to 0 just before, read just after
    (``counts`` of the yielded dict), with the block's seconds (``s``)."""
    res = {}
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    start = time.perf_counter()
    yield res
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    res["s"] = time.perf_counter() - start
    res["counts"] = kernels.launch_counts()


def registration_gap(trans, labels, out, sample) -> tuple[float, dict]:
    """A transform [4, 4] and its labels [n] (numpy) against a forward's
    output ``out`` on the same sample of n correspondences: the largest entry
    difference of the transforms, and their rotation (deg) and translation
    (cm) between them, their label agreement, and each one's rotation and
    translation error against the ground truth."""
    import numpy as np

    n = sample["corr_pos"].shape[0]
    ref = out.final_trans[0].cpu().numpy()
    gt = sample["gt_trans"]
    return float(np.abs(trans - ref).max()), {
        "re_deg": rot_error_deg(trans, ref),
        "te_cm": 100 * float(np.linalg.norm(trans[:3, 3] - ref[:3, 3])),
        "labels": float((labels[:n] == out.final_labels[0, :n].cpu().numpy()).mean()),
        "vs_gt_fused": [rot_error_deg(trans, gt),
                        100 * float(np.linalg.norm(trans[:3, 3] - gt[:3, 3]))],
        "vs_gt_ref": [rot_error_deg(ref, gt), 100 * float(np.linalg.norm(ref[:3, 3] - gt[:3, 3]))]}


def padded_inputs(torch, dev, sample):
    """corr_pos, src, tgt, mask of a sample padded to its bucket, as the
    Evaluator runs it (the seed count is the bucket's), [1, ...] on dev."""
    from pointdsc_tpu_torch.data.pipeline import pad_to_bucket

    padded = pad_to_bucket(sample)
    return [torch.as_tensor(padded[k])[None].to(dev)
            for k in ("corr_pos", "src_keypts", "tgt_keypts", "mask")]


def dense_errors(torch, dev, rec, details=None, reference=None) -> list[float]:
    """Each recorded pair's transform against the dense forward
    (``fused=False``) of the same sample, padded to its bucket, through the
    Evaluator's model, in whichever configuration the regime guard left it
    (or against ``reference(model, corr_pos, src, tgt, mask)``'s output where
    given): the largest entry difference a pair. ``details``, a list, gets
    each pair's ``registration_gap`` details."""
    errs = []
    for sample, trans, labels in rec.pairs:
        cp, src, tgt, mask = padded_inputs(torch, dev, sample)
        out = (rec.ev.model(cp, src, tgt, mask=mask, fused=False) if reference is None
               else reference(rec.ev.model, cp, src, tgt, mask))
        err, d = registration_gap(trans, labels[0].cpu().numpy(), out, sample)
        errs.append(err)
        if details is not None:
            details.append(d)
    return errs


def conditioning_control(torch, dev, rec, details) -> list[float]:
    """The dense forward of each recorded pair against itself with its input
    features (corr_pos) moved by at most one float32 rounding (a relative
    2^-24 each, seeded): how far the forward's own conditioning moves the
    registration. ``details`` gets each pair's ``registration_gap``
    details; returns each pair's largest entry difference."""
    gen = torch.Generator().manual_seed(0)
    errs = []
    for sample, *_ in rec.pairs:
        cp, src, tgt, mask = padded_inputs(torch, dev, sample)
        dense = rec.ev.model(cp, src, tgt, mask=mask, fused=False)
        nudge = (torch.rand(cp.shape, generator=gen) * 2 - 1).to(dev) * 2.0 ** -24
        moved = rec.ev.model(cp * (1 + nudge), src, tgt, mask=mask, fused=False)
        err, d = registration_gap(dense.final_trans[0].cpu().numpy(),
                                  dense.final_labels[0].cpu().numpy(), moved, sample)
        errs.append(err)
        details.append(d)
    return errs


def same_registration(err, d, rule, verdict=None) -> bool:
    """Whether a fused transform is its reference's registration under
    ``rule`` = (atol, deg, cm, label floor): within atol entrywise (``err``),
    or else within deg / cm of it (``d["re_deg"]``, ``d["te_cm"]``) with
    their labels agreeing on the floor (``d["labels"]``) and, given
    ``verdict`` = (RE deg, TE cm), the same verdict against the ground truth
    (``d["vs_gt_fused"]``, ``d["vs_gt_ref"]``)."""
    atol, deg, cm, label_floor = rule
    if err <= atol:
        return True
    close = d["re_deg"] <= deg and d["te_cm"] <= cm and d["labels"] >= label_floor
    if verdict is None:
        return close
    ok = [r < verdict[0] and t < verdict[1] for r, t in (d["vs_gt_fused"], d["vs_gt_ref"])]
    return close and ok[0] == ok[1]


def exact_attention(torch, q, k, v, compat, bias):
    """The running-max attention at the kernel's precision, computed in
    float64: q, k, v rounded to bf16, p rounded to bf16 before p v against
    the row's maximum (as the plain version rounds it), [B, N, C]; and each
    entry's allowance (2^-7 + 2^-17 A_i) sum_j p_ij |v_jc| / l_i + 1e-3. An
    implementation that rounds p to bf16 itself (bf16's unit roundoff, 2^-8
    relative a term, against another running maximum) is off the rounded
    reference by 2^-7 of sum_j p_ij |v_jc| / l_i at most, and its
    f32 logits move p_ij / p_i,max by two logits' rounding, where A_i is row
    i's largest sum of |compat q k| terms in nats: 2^-18 A_i a logit summed
    in 16 steps over C = 128, each truncating to f32 (a tensor-core
    accumulator)."""
    from pointdsc_tpu_torch.kernels.sc_attention import qk_scale

    q, k, v = (t.bfloat16().double() for t in (q, k, v))
    scale = qk_scale(q.shape[-1])
    cf = compat.double()
    valid = (bias == 0)[:, None, :]
    s = cf * (torch.einsum("bnc,bmc->bnm", q, k) * scale) + bias.double()[:, None, :]
    a = (cf.abs() * torch.einsum("bnc,bmc->bnm", q.abs(), k.abs()) * scale).masked_fill(
        ~valid, 0.0).amax(-1, keepdim=True)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    exact = torch.einsum("bnm,bmc->bnc", p.bfloat16().double(), v) / l
    allowance = (2.0 ** -7 + 2.0 ** -17 * a) * torch.einsum("bnm,bmc->bnc", p, v.abs()) / l
    return exact, allowance + 1e-3


def attention_witness(torch, shares, follow_plain=False):
    """A ``dense_errors`` reference: the fused eval forward of a model the
    guard flipped to the running max, each of whose attention launches is
    held, with its plain version on the same operands (the control), to
    ``exact_attention``: ``shares`` gets each call's (kernel, plain) largest
    share of the allowance (<= 1 within it). The forward goes on with the
    kernel's output, or with the plain version's (``follow_plain``: the
    whole forward at the kernel's precision through plain math)."""
    from pointdsc_tpu_torch.kernels.sc_attention import key_bias, sc_attention_cached_plain
    from pointdsc_tpu_torch.models import pointdsc as pdsc

    kernel = pdsc.fused_sc_attention_cached

    def attention(q, k, v, compat, src, tgt, mask=None, offset_softmax=True):
        check(not offset_softmax, "the witness holds the running max only")
        out = kernel(q, k, v, compat, src, tgt, mask=mask, offset_softmax=offset_softmax)
        bias = key_bias(mask, q.shape[0], q.shape[1], q.device)
        plain = sc_attention_cached_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), compat, bias)
        exact, allowance = exact_attention(torch, q, k, v, compat, bias)
        shares.append(tuple(float(((x.double() - exact).abs() / allowance).max())
                            for x in (out, plain)))
        return plain if follow_plain else out

    def forward(model, cp, src, tgt, mask):
        with patched(pdsc, "fused_sc_attention_cached", attention):
            return model(cp, src, tgt, mask=mask, fused=True)

    return forward


def eval_kernels(n: int, flipped: bool) -> tuple:
    """The kernels one eval forward of N = n launches: the default
    configuration's, or the running max's after the guard flipped."""
    if flipped:
        return RUNNING_MAX_KERNELS
    tail = ("compat_cache_int8", "confidence_head", "nms_local_max", "nms_select",
            "seed_knn_exact", "seed_hypotheses", "seed_inlier_counts", "select_hypothesis",
            "fused_post_refinement")
    encoder = (("fused_encoder_layer",) if n <= 6144 else
               ("pcn_qkv", "attn_mlp_residual", "nms_top_m"))
    return tail + encoder


def check_launched(counts, names, tag) -> None:
    missing = [name for name in names if counts[name] <= 0]
    check(not missing, f"{tag}: kernels not launched: {missing}")


def dataset_eval_3dmatch(torch, kernels, dev, tmp, card) -> dict:
    """Phase 24: the 3DMatch and 3DLoMatch CLIs (``evaluation/test_3DMatch``,
    ``test_3DLoMatch``) through ``main(argv)`` on a fake test root of one
    TEST_SCENES scene (``write_3dmatch_scene``: 4 fragments of 5000 points),
    with a snapshot directory of the Synthetic release (root overridden),
    counts set to 0 before each run and read after. 3DMatch with
    ``num_node all``: 6 pairs of N = 5000 (bucket 5120) at full width; each
    pair's transform equal to the dense forward of its sample within 1e-3,
    the kernels of the configuration the guard left launched, recall >=
    5/6, the log and .npy written; again with ``--use_icp true``: the
    nn-search kernel 20 times a forward. 3DLoMatch from a ``3DLoMatch.pkl``
    over the same fragments (``--num_corr 5000``) and from 2 Predator files
    (6000 points a cloud, sampled to 5000 by overlap x saliency; the
    benchmark reads 1781 files, so the dataset's length is set to 2 here).
    Returns the summary line."""
    import numpy as np

    from pointdsc_tpu_torch.data.predator import PredatorLoMatchDataset
    from pointdsc_tpu_torch.evaluation import test_3DLoMatch, test_3DMatch

    start = time.perf_counter()
    root = os.path.join(tmp, "3dmatch")
    poses, world, latents = write_3dmatch_scene(root, TEST_SCENE, n_frag=CLI_FRAGMENTS,
                                                n_pts=CLI_POINTS)
    n_pairs = CLI_FRAGMENTS * (CLI_FRAGMENTS - 1) // 2
    work = os.path.join(tmp, "work_3dmatch")
    write_snapshot(work, "smoke_3dmatch", SNAPSHOT, root=root)
    argv = ["--chosen_snapshot", "smoke_3dmatch", "--device", DEVICE]
    line = {"phase": "cli_3dmatch", "card": card, "pairs": n_pairs, "n": CLI_POINTS}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with recorded_cli_evaluators() as made, counted(torch, kernels) as run:
            stats, agg = test_3DMatch.main(argv + ["--save_npy", "true"])
        rec = made[-1]
        check(stats.shape == (n_pairs, 12) and np.isfinite(stats).all(), "3DMatch CLI: bad stats")
        check(all(s["corr_pos"].shape[0] == CLI_POINTS for s, *_ in rec.pairs),
              "3DMatch CLI: not num_node all")
        for ext in ("log", "npy"):
            check(os.path.exists(f"logs/smoke_3dmatch-SVD-fcgf.{ext}"), f"no .{ext} written")
        errs = dense_errors(torch, dev, rec)
        names = eval_kernels(CLI_POINTS, rec.ev.flipped)
        line.update(s=run["s"], recall=agg["pair_recall"], flipped=rec.ev.flipped,
                    last_slack=rec.ev.last_slack, forwards=len(rec.calls), max_err_vs_dense=max(errs),
                    launches={k: run["counts"][k] for k in names},
                    model_time_ms=agg["model_time"] * 1e3, data_time_ms=agg["data_time"] * 1e3)
        check_launched(run["counts"], names, "3DMatch CLI")
        check(max(errs) <= 1e-3, f"3DMatch CLI: fused against dense {max(errs):.3e} > 1e-3")
        check(agg["pair_recall"] >= 100.0 * (n_pairs - 1) / n_pairs - 1e-9,
              f"3DMatch CLI: recall {agg['pair_recall']:.1f}%")

        with recorded_cli_evaluators() as made, counted(torch, kernels) as run:
            stats, agg = test_3DMatch.main(argv + ["--use_icp", "true"])
        forwards = len(made[-1].calls)
        nn = run["counts"]["nearest_neighbors"]
        line.update(icp_s=run["s"], icp_recall=agg["pair_recall"], icp_nn_launches=nn)
        check(stats.shape == (n_pairs, 12) and np.isfinite(stats).all(), "ICP run: bad stats")
        check(os.path.exists("logs/smoke_3dmatch-SVD-fcgf-ICP.log"), "no ICP log written")
        check(nn == 20 * forwards, f"ICP run: {nn} nn-search launches for {forwards} forwards")

        write_lomatch_pickle(root, TEST_SCENE, poses)
        with recorded_cli_evaluators() as made, counted(torch, kernels) as run:
            stats, agg = test_3DLoMatch.main(argv + ["--num_corr", str(CLI_POINTS)])
        errs = dense_errors(torch, dev, made[-1])
        line.update(lomatch_s=run["s"], lomatch_recall=agg["pair_recall"],
                    lomatch_max_err_vs_dense=max(errs))
        check(stats.shape == (n_pairs, 12) and np.isfinite(stats).all(), "3DLoMatch: bad stats")
        check(max(errs) <= 1e-3, f"3DLoMatch CLI: fused against dense {max(errs):.3e}")
        check_launched(run["counts"], eval_kernels(CLI_POINTS, made[-1].ev.flipped), "3DLoMatch")

        pred = os.path.join(tmp, "predator")
        os.makedirs(pred, exist_ok=True)
        gen = np.random.default_rng(5)
        for p, (i, j) in enumerate(((0, 1), (2, 3))):
            clouds = []
            for pose in (poses[i], poses[j]):
                sel = gen.choice(len(world), PREDATOR_POINTS, replace=False)
                inv = np.linalg.inv(pose)
                feat = _unit_rows(latents[sel] + 0.13 * gen.normal(size=(len(sel), 32)))
                clouds.append((world[sel] @ inv[:3, :3].T + inv[:3, 3], feat))
            write_predator_pair(os.path.join(pred, f"{p}.pth"), clouds[0][0], clouds[1][0],
                                clouds[0][1], clouds[1][1], np.linalg.inv(poses[j]) @ poses[i],
                                gen)
        length = PredatorLoMatchDataset.__len__
        PredatorLoMatchDataset.__len__ = lambda self: 2
        try:
            with recorded_cli_evaluators() as made, counted(torch, kernels) as run:
                stats, agg = test_3DLoMatch.main(argv + ["--num_corr", str(CLI_POINTS),
                                                         "--use_predator", "true",
                                                         "--predator_root", pred])
        finally:
            PredatorLoMatchDataset.__len__ = length
        errs = dense_errors(torch, dev, made[-1])
        line.update(predator_s=run["s"], predator_recall=agg["pair_recall"],
                    predator_max_err_vs_dense=max(errs))
        check(stats.shape == (2, 12) and np.isfinite(stats).all(), "Predator: bad stats")
        check(all(s["corr_pos"].shape[0] == CLI_POINTS for s, *_ in made[-1].pairs),
              "Predator: not sampled to --num_corr")
        check(max(errs) <= 1e-3, f"Predator CLI: fused against dense {max(errs):.3e}")
    finally:
        os.chdir(cwd)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


def kitti_prep_and_eval(torch, kernels, dev, tmp, card) -> str:
    """Phase 25: ``data/kitti_prep.py::process_kitti`` on the card over a fake
    odometry drive (``write_fake_drive``: 4 frames of ~60k points, 8 m apart,
    2 cm noise; pairs 0-1 and 2-3): ICP (200 iterations at a 5 cm voxel, the
    nn-search kernel each) and FPFH at 0.30 m, written as ``fpfh_test``
    pairs; then the KITTI CLI (``evaluation/test_KITTI``) with the
    SyntheticKITTI release (root and descriptor overridden) at ``--num_node
    12000`` (bucket 12288): each pair's transform equal to the dense forward
    within 5e-3, or else within 0.25 deg and 5 cm of it with 98% of the
    labels and the same verdict against the ground truth; the
    configuration's kernels launched. Recall is printed, not required: FPFH
    pairs leave the offset regime (ROADMAP C4). Returns the root of the
    written pairs."""
    import numpy as np

    from pointdsc_tpu_torch.data import kitti_prep
    from pointdsc_tpu_torch.evaluation import test_KITTI

    start = time.perf_counter()
    drive = os.path.join(tmp, "drive")
    write_fake_drive(drive, drive=8, n_frames=DRIVE_FRAMES, n_points=DRIVE_POINTS)
    split_dir = os.path.join(tmp, "kitti_splits")  # the test split's drive 8 alone
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, "test_kitti.txt"), "w") as f:
        f.write("8\n")
    out = os.path.join(tmp, "kitti")
    fpfh_calls, extract = [], kitti_prep.extract_fpfh

    def extract_counted(points, **kw):
        fpfh_calls.append(len(points))
        return extract(points, **kw)

    kitti_prep.extract_fpfh = extract_counted
    try:
        with counted(torch, kernels) as prep:
            kitti_prep.process_kitti(drive, out, split="test", split_dir=split_dir, device=DEVICE)
    finally:
        kitti_prep.extract_fpfh = extract
    names = sorted(os.listdir(os.path.join(out, "fpfh_test")))
    n_pairs = DRIVE_FRAMES // 2
    nn = prep["counts"]["nearest_neighbors"]
    line = {"phase": "kitti_prep_and_cli", "card": card, "prep_s": prep["s"], "pairs": names,
            "raw_points": fpfh_calls, "prep_nn_launches": nn}
    check(names == [f"pair_8_{2 * i}_{2 * i + 1}.npz" for i in range(n_pairs)],
          f"process_kitti wrote {names}")
    check(nn == PREP_ICP_ITERS * n_pairs, f"process_kitti: {nn} nn-search launches")
    check(len(fpfh_calls) == 2 * n_pairs, "process_kitti: FPFH not run for every cloud")
    icp_moves = []
    for name in names:
        d = np.load(os.path.join(out, "fpfh_test", name))
        check(all(np.isfinite(d[k]).all() for k in d.files) and d["features0"].shape[1] == 33,
              f"{name}: bad pair file")
        # ICP starts at the odometry's transform, 8 m along x
        icp_moves.append(float(np.abs(d["gt_trans"][:3, 3] - [-8.0, 0, 0]).max()))
        line.setdefault("keypoints", []).append([len(d["xyz0"]), len(d["xyz1"])])
    line["icp_move_from_odometry_m"] = icp_moves
    check(max(icp_moves) < 0.2, f"ICP moved {max(icp_moves):.3f} m from the odometry")

    work = os.path.join(tmp, "work_kitti")
    write_snapshot(work, "smoke_kitti", SNAPSHOT_KITTI, root=out, descriptor="fpfh")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with recorded_cli_evaluators() as made, counted(torch, kernels) as run:
            stats, agg = test_KITTI.main(["--chosen_snapshot", "smoke_kitti", "--num_node",
                                          str(KITTI_NODE), "--device", DEVICE])
        rec = made[-1]
        details = []
        errs = dense_errors(torch, dev, rec, details)
        names = eval_kernels(KITTI_NODE, rec.ev.flipped)
        line.update(cli_s=run["s"], recall=agg["pair_recall"], flipped=rec.ev.flipped,
                    last_slack=rec.ev.last_slack, max_err_vs_dense=errs, vs_dense=details,
                    launches={k: run["counts"][k] for k in names},
                    model_time_ms=agg["model_time"] * 1e3)
        check(stats.shape == (n_pairs, 12) and np.isfinite(stats).all(), "KITTI CLI: bad stats")
        check(all(s["corr_pos"].shape[0] == KITTI_NODE for s, *_ in rec.pairs),
              "KITTI CLI: not --num_node correspondences")
        check(os.path.exists("logs/smoke_kitti-SVD-fpfh-KITTI.log"), "no KITTI log written")
        for i, (err, d) in enumerate(zip(errs, details)):
            # these pairs' refinement has two inlier sets ~2 cm apart, and which
            # one a path lands on turns on rounding, for the dense path on the
            # CPU and on the card too (PERF.md, section 6)
            check(same_registration(err, d, BISTABLE_RULE, verdict=(5.0, 60.0)),
                  f"KITTI CLI pair {i}: fused against dense {err:.3e}, {d}")
        check_launched(run["counts"], names, "KITTI CLI")
    finally:
        os.chdir(cwd)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return out


def training_clis(torch, pt, kernels, dev, tmp, card, kitti_pairs) -> dict:
    """Phase 26: ``train_3DMatch.main`` on a fake training root
    (``write_train_root``: 12 fragments of 3000 points, 66 pairs under a
    packaged train and val scene) at the reference training shape (bs 16,
    num_node 1000, 12 layers, C = 128, k = 40), ``--fused_attention true
    --fused_sm_loss true --max_epoch 1``: 4 steps, every loss finite, the
    five training kernels launched, ``config.json`` and
    ``models/model_best.pkl`` written and the checkpoint through
    ``load_pretrained`` and ``register`` on a validation sample. Then
    ``train_KITTI.main`` for one epoch at bs 2 on phase 25's pairs (as its
    train and val splits). Returns the launches of the 3DMatch run."""
    import shutil

    import numpy as np

    from pointdsc_tpu_torch import train_3DMatch, train_KITTI
    from pointdsc_tpu_torch.data.pipeline import pad_to_bucket
    from pointdsc_tpu_torch.data.threedmatch import ThreeDMatchTrainVal
    from pointdsc_tpu_torch.train.trainer import Trainer

    start = time.perf_counter()
    root = os.path.join(tmp, "train_3dmatch")
    write_train_root(root, SPLIT_SCENES, n_frag=TRAIN_FRAGMENTS, n_pts=TRAIN_POINTS)
    kroot = os.path.join(tmp, "train_kitti")
    for split in ("train", "val"):
        shutil.copytree(os.path.join(kitti_pairs, "fpfh_test"), os.path.join(kroot, f"fpfh_{split}"))
    work = os.path.join(tmp, "work_train")
    os.makedirs(work, exist_ok=True)
    common = ["--fused_attention", "true", "--fused_sm_loss", "true", "--max_epoch", "1",
              "--tboard_dir", "", "--num_workers", "4", "--val_max_iter", "2",
              "--device", DEVICE]
    steps, train_step = [], Trainer.train_step

    def recording_step(self, state, batch, epoch):
        state, metrics = train_step(self, state, batch, epoch)
        steps.append({k: float(metrics[k]) for k in ("loss", "class_loss", "sm_loss",
                                                     "grad_finite")})
        return state, metrics

    line = {"phase": "train_clis", "card": card}
    cwd = os.getcwd()
    os.chdir(work)
    Trainer.train_step = recording_step
    try:
        snap = os.path.join(work, "snapshot", "smoke_train")
        with counted(torch, kernels) as run:
            state = train_3DMatch.main(["--root", root, "--snapshot_dir", snap,
                                        "--batch_size", str(TRAIN_BS),
                                        "--num_node", str(TRAIN_NODE)] + common)
        n_pairs = TRAIN_FRAGMENTS * (TRAIN_FRAGMENTS - 1) // 2
        want = n_pairs // TRAIN_BS
        line.update(train_3dmatch_s=run["s"], steps=len(steps), losses=[s["loss"] for s in steps],
                    launches={k: run["counts"][k] for k in TRAIN_KERNELS})
        check(len(steps) == want and state.step == want, f"{len(steps)} steps, expected {want}")
        check(all(np.isfinite(list(s.values())).all() and s["grad_finite"] == 1.0 for s in steps),
              f"non-finite losses or gradients: {steps}")
        check_launched(run["counts"], TRAIN_KERNELS, "train_3DMatch")
        for rel in ("config.json", os.path.join("models", "model_best.pkl"), "trainer.py"):
            check(os.path.exists(os.path.join(snap, rel)), f"train_3DMatch wrote no {rel}")
        model = pt.load_pretrained(snap, device=DEVICE)
        # register takes the kernels' shapes: the sample padded to its bucket
        sample = pad_to_bucket(ThreeDMatchTrainVal(root, "val", num_node=TRAIN_NODE,
                                                   device=DEVICE)[0])
        out = pt.register(sample["corr_pos"], sample["src_keypts"], sample["tgt_keypts"],
                          sample["mask"], model=model, device=DEVICE)
        check(bool(torch.isfinite(out.final_trans).all()), "the trained snapshot: bad transform")

        steps.clear()
        ksnap = os.path.join(work, "snapshot", "smoke_train_kitti")
        with counted(torch, kernels) as run:
            state = train_KITTI.main(["--root", kroot, "--descriptor", "fpfh", "--batch_size", "2",
                                      "--snapshot_dir", ksnap] + common)
        line.update(train_kitti_s=run["s"], kitti_steps=len(steps),
                    kitti_losses=[s["loss"] for s in steps])
        want = len(os.listdir(os.path.join(kroot, "fpfh_train"))) // 2
        check(len(steps) == want and all(np.isfinite(list(s.values())).all() for s in steps),
              f"train_KITTI: steps {steps}, expected {want}")
        check(os.path.exists(os.path.join(ksnap, "models", "model_best.pkl")),
              "train_KITTI wrote no checkpoint")
    finally:
        Trainer.train_step = train_step
        os.chdir(cwd)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line["launches"]


@contextlib.contextmanager
def recorded_pair_stats():
    """Every (transform, labels) the baseline CLIs hand to
    ``eval/protocol.py::pair_stats``, in order (the yielded list)."""
    from pointdsc_tpu_torch.eval import protocol

    seen, pair_stats = [], protocol.pair_stats

    def recording(pred_trans, pred_labels, *args, **kwargs):
        seen.append((pred_trans, pred_labels))
        return pair_stats(pred_trans, pred_labels, *args, **kwargs)

    protocol.pair_stats = recording
    try:
        yield seen
    finally:
        protocol.pair_stats = pair_stats


def baseline_run(torch, kernels, main, argv, device):
    """One baseline CLI run on ``device`` through ``main(argv)``: its stats,
    aggregate, every pair's (transform, labels), the counts and seconds of
    ``counted`` and the peak device memory (GiB, 0 on the CPU)."""
    import numpy as np

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with recorded_pair_stats() as pairs, counted(torch, kernels) as run:
        stats, agg = main(list(argv) + ["--device", device])
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0
    check(np.isfinite(stats).all() and len(pairs) == len(stats), f"{argv}: bad stats")
    return dict(stats=stats, agg=agg, pairs=pairs, s=run["s"], counts=run["counts"], peak=peak)


def baselines_3dmatch(torch, kernels, tmp, card) -> dict:
    """Phase 27a: ``baseline_3DMatch.main`` at ``--num_node 2048`` on phase
    24's scene (6 pairs), each method (SM, RANSAC, GCRANSAC with ICM and
    with the exact mincut, LS, PMC) first with ``--device cpu`` and then on
    the card: both draw RANSAC's sets from one CPU generator, so each pair's
    transform on the card is the CPU's within 1e-4 and its labels agree on
    >= 0.99 of the points (PMC: the same clique); recall at least the floor
    the CPU run of this root set (BASELINE_RECALL_FLOORS); no kernel
    launched. Prints each method's recall, seconds a pair (the CLI's
    model_time) on both, and the card's peak memory."""
    import numpy as np

    from pointdsc_tpu_torch.baseline_scripts import baseline_3DMatch

    start = time.perf_counter()
    work = os.path.join(tmp, "work_baselines")
    os.makedirs(work, exist_ok=True)
    root = os.path.join(tmp, "3dmatch")
    cwd = os.getcwd()
    os.chdir(work)
    from pointdsc_tpu_torch import native

    line = {"phase": "baselines_3dmatch", "card": card, "n": BASELINE_NODE, "methods": {},
            "native_flags": " ".join(native.build_flags())}
    try:
        for method, extra in BASELINE_METHODS:
            tag = " ".join([method] + list(extra[1:]))
            argv = ["--method", method, "--root", root, "--num_node", str(BASELINE_NODE),
                    *extra]
            cpu = baseline_run(torch, kernels, baseline_3DMatch.main, argv, "cpu")
            gpu = baseline_run(torch, kernels, baseline_3DMatch.main, argv, DEVICE)
            terr = [float(np.abs(a[0] - b[0]).max()) for a, b in zip(gpu["pairs"], cpu["pairs"])]
            agree = [float((a[1] == b[1]).mean()) for a, b in zip(gpu["pairs"], cpu["pairs"])]
            launched = {k: v for k, v in gpu["counts"].items() if v}
            res = dict(recall=gpu["agg"]["pair_recall"], cpu_recall=cpu["agg"]["pair_recall"],
                       s_per_pair=float(gpu["stats"][:, 9].mean()),
                       cpu_s_per_pair=float(cpu["stats"][:, 9].mean()),
                       max_trans_err_vs_cpu=max(terr), min_label_agreement_vs_cpu=min(agree),
                       peak_gib=gpu["peak"], run_s=gpu["s"], cpu_run_s=cpu["s"])
            line["methods"][tag] = res
            print(json.dumps({"phase": "baselines_3dmatch", "card": card, "method": tag, **res}),
                  flush=True)
            check(len(gpu["stats"]) == CLI_FRAGMENTS * (CLI_FRAGMENTS - 1) // 2,
                  f"{tag}: {len(gpu['stats'])} pairs")
            check(not launched, f"{tag}: launched kernels {launched}")
            check(max(terr) <= 1e-4, f"{tag}: card against CPU {max(terr):.3e} > 1e-4")
            check(min(agree) >= (1.0 if method == "PMC" else 0.99),
                  f"{tag}: labels agree on {min(agree):.4f} of the points with the CPU's")
            check(res["recall"] >= BASELINE_RECALL_FLOORS[tag] - 1e-9,
                  f"{tag}: recall {res['recall']:.2f}% below {BASELINE_RECALL_FLOORS[tag]}%")
    finally:
        os.chdir(cwd)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


def baselines_kitti(torch, kernels, tmp, card) -> dict:
    """Phase 27b: ``baseline_KITTI.main`` on the card on phase 25's 2 FPFH
    pairs (~27k keypoints a cloud), at its default ``--num_node 15000`` with
    SM, RANSAC (4096 hypotheses), GCRANSAC (ICM) and LS, and PMC at 2048:
    recall, seconds a pair and peak memory of each. Finite stats and no
    kernel launched are required; recall is printed (FPFH pairs)."""
    import numpy as np

    from pointdsc_tpu_torch.baseline_scripts import baseline_KITTI

    start = time.perf_counter()
    work = os.path.join(tmp, "work_baselines_kitti")
    os.makedirs(work, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    line = {"phase": "baselines_kitti", "card": card, "methods": {}}
    try:
        for method in ("SM", "RANSAC", "GCRANSAC", "LS", "PMC"):
            node = PMC_KITTI_NODE if method == "PMC" else BASELINE_KITTI_NODE
            argv = ["--method", method, "--root", os.path.join(tmp, "kitti"), "--descriptor",
                    "fpfh", "--num_node", str(node), "--save_npy", "true"]
            run = baseline_run(torch, kernels, baseline_KITTI.main, argv, DEVICE)
            launched = {k: v for k, v in run["counts"].items() if v}
            n = [len(labels) for _, labels in run["pairs"]]
            res = dict(n=node, correspondences=n, recall=run["agg"]["pair_recall"],
                       s_per_pair=float(run["stats"][:, 9].mean()), peak_gib=run["peak"],
                       run_s=run["s"], re=run["stats"][:, 1].tolist(),
                       te_cm=run["stats"][:, 2].tolist())
            line["methods"][method] = res
            print(json.dumps({"phase": "baselines_kitti", "card": card, "method": method, **res}),
                  flush=True)
            check(len(run["stats"]) == DRIVE_FRAMES // 2 and np.isfinite(run["stats"]).all(),
                  f"KITTI {method}: bad stats")
            check(all(k == node for k in n), f"KITTI {method}: {n} correspondences, not {node}")
            check(not launched, f"KITTI {method}: launched kernels {launched}")
            check(os.path.exists(f"logs/baseline-kitti-{method}-fpfh.npy"), "no .npy written")
    finally:
        os.chdir(cwd)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


def ransac_solver(torch, pt, kernels, dev, tmp, card) -> dict:
    """Phase 27c: ``Evaluator(solver="RANSAC")``, without and with ICP, in the
    default configuration on the three Synthetic pairs of phase 8 (N = 5120),
    beside ``solver="SVD"``: recall, model_time, and the default forward's
    kernels launched at least once a forward (the pairs and the bucket's
    warm-up; with ICP the nn search 20 times a forward); each pair's RANSAC
    transform against the SVD one. Then the 3DMatch evaluation CLI with
    ``--solver RANSAC`` on phase 24's scene and snapshot: finite stats, the
    log, the kernels launched, recall >= 5/6."""
    import numpy as np

    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.evaluation import test_3DMatch

    start = time.perf_counter()
    model = pt.load_pretrained(SNAPSHOT, device=DEVICE)
    ds = SyntheticPairDataset(num_pairs=PAIRS, num_corr=N, **DEFAULT_DATA)
    line = {"phase": "ransac_solver", "card": card, "n": N, "pairs": PAIRS}
    trans = {}
    for solver, icp in (("SVD", False), ("RANSAC", False), ("RANSAC", True)):
        tag = solver + (" + ICP" if icp else "")
        rec = Recorded(pt.Evaluator(model, fused_attention=True, solver=solver, use_icp=icp,
                                    icp_threshold=0.1, device=DEVICE))
        with counted(torch, kernels) as run:
            stats, agg = rec.ev.run_dataset(ds, verbose=False)
        forwards = len(rec.calls)
        names = eval_kernels(N, rec.ev.flipped) + (("nearest_neighbors",) if icp else ())
        trans[tag] = [t[0].cpu().numpy() for t, _ in rec.calls[-PAIRS:]]
        line[tag] = dict(recall=agg["pair_recall"], re=agg["re"], te=agg["te"],
                         model_time_ms=agg["model_time"] * 1e3, forwards=forwards,
                         flipped=rec.ev.flipped,
                         launches={k: run["counts"][k] for k in names})
        check(stats.shape == (PAIRS, 12) and np.isfinite(stats).all(), f"{tag}: bad stats")
        short = [k for k in names if run["counts"][k] < forwards]
        check(not short, f"{tag}: launched less than once a forward: {short}")
        if icp:
            nn = run["counts"]["nearest_neighbors"]
            check(nn == 20 * forwards, f"{tag}: {nn} nn-search launches for {forwards} forwards")
    for tag in ("RANSAC", "RANSAC + ICP"):
        line[tag]["max_diff_vs_svd"] = [float(np.abs(a - b).max())
                                        for a, b in zip(trans[tag], trans["SVD"])]
        check(line[tag]["recall"] >= line["SVD"]["recall"],
              f"{tag}: recall {line[tag]['recall']} below SVD's {line['SVD']['recall']}")

    work = os.path.join(tmp, "work_3dmatch")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        n_pairs = CLI_FRAGMENTS * (CLI_FRAGMENTS - 1) // 2
        with recorded_cli_evaluators() as made, counted(torch, kernels) as run:
            stats, agg = test_3DMatch.main(["--chosen_snapshot", "smoke_3dmatch", "--device",
                                            DEVICE, "--solver", "RANSAC"])
        rec = made[-1]
        names = eval_kernels(CLI_POINTS, rec.ev.flipped)
        line["cli"] = dict(s=run["s"], recall=agg["pair_recall"], flipped=rec.ev.flipped,
                           model_time_ms=agg["model_time"] * 1e3,
                           launches={k: run["counts"][k] for k in names})
        check(stats.shape == (n_pairs, 12) and np.isfinite(stats).all(), "RANSAC CLI: bad stats")
        check(os.path.exists("logs/smoke_3dmatch-RANSAC-fcgf.log"), "no RANSAC log written")
        check_launched(run["counts"], names, "RANSAC CLI")
        check(agg["pair_recall"] >= 100.0 * (n_pairs - 1) / n_pairs - 1e-9,
              f"RANSAC CLI: recall {agg['pair_recall']:.1f}%")
    finally:
        os.chdir(cwd)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


@contextlib.contextmanager
def timed_calls(owner, name, sink):
    """Seconds of every call of ``owner.<name>`` appended to ``sink`` (host
    clock, closed by a synchronise on the card)."""
    import torch

    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        sink.append(time.perf_counter() - start)
        return out

    setattr(owner, name, timed)
    try:
        yield sink
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def patched(owner, name, replacement):
    fn = getattr(owner, name)
    setattr(owner, name, replacement)
    try:
        yield fn
    finally:
        setattr(owner, name, fn)


def rgbd_fusion(torch, kernels, dev, tmp, card) -> str:
    """Phase 28: ``multiway/make_fragments.main`` on an RGB-D sequence the
    script renders (``write_rgbd_sequence``: RGBD_FRAMES frames of 640 x 480,
    PrimeSense intrinsics, a textured box room with boxes in it, a smooth
    handheld path; 16-bit depth PNGs, Paeth-filtered RGB PNGs, written with
    zlib alone), RGBD_PER_FRAGMENT frames a fragment (the reference's 100,
    cut), hybrid RGB-D tracking, the TSDF at its default 256^3 x 8 mm, FPFH on
    the card: the written layout; each fragment's chained and pose-graph
    optimized odometry against the rendered truth (deg, cm); the surface
    points' distance to the true surfaces; ``depth_odometry`` and
    ``rgbd_odometry`` on the card within 1e-6 of the same calls on the CPU,
    one ``TSDFVolume.integrate`` at 256^3 equal to the CPU's on >= 99.99% of
    the voxels (bit for bit in the first card run). The stages are timed. The fragments' ``.npy``
    poses are then replaced by the true fragment -> world poses (phase 29
    runs ``test_multi_ate`` on them). Returns the Redwood root."""
    import numpy as np

    from pointdsc_tpu_torch.descriptors import fpfh
    from pointdsc_tpu_torch.fusion import camera, fragments, odometry, tsdf
    from pointdsc_tpu_torch.multiway import make_fragments

    start = time.perf_counter()
    width, height = RGBD_SIZE
    root = os.path.join(tmp, "redwood_rgbd")
    scene_dir = os.path.join(root, RGBD_SCENE)
    truth = write_rgbd_sequence(scene_dir, RGBD_FRAMES, width, height)
    line = {"phase": "rgbd_fusion", "card": card, "frames": RGBD_FRAMES, "size": [width, height],
            "per_fragment": RGBD_PER_FRAGMENT, "cut": "n_frames_per_fragment 100 -> "
            f"{RGBD_PER_FRAGMENT}", "render_s": time.perf_counter() - start}
    built, times = [], {k: [] for k in ("odometry", "pose_graph", "integrate", "surface", "fpfh",
                                        "read_depth", "read_color")}

    def recording_build(*args, **kwargs):
        out = build(*args, **kwargs)
        built.append(out)
        return out

    with contextlib.ExitStack() as stack:
        build = stack.enter_context(patched(fragments, "build_fragment", recording_build))
        for owner, name, key in ((fragments, "rgbd_odometry", "odometry"),
                                 (fragments, "optimize_pose_graph", "pose_graph"),
                                 (tsdf.TSDFVolume, "integrate", "integrate"),
                                 (fragments, "extract_surface_points", "surface"),
                                 (fpfh, "extract_fpfh", "fpfh"),
                                 (fragments, "read_depth_png", "read_depth"),
                                 (fragments, "read_intensity_png", "read_color")):
            stack.enter_context(timed_calls(owner, name, times[key]))
        with counted(torch, kernels) as run:
            out_dir = make_fragments.main(["--path_dataset", scene_dir, "--n_frames_per_fragment",
                                           str(RGBD_PER_FRAGMENT), "--device", DEVICE])
    n_frag = -(-RGBD_FRAMES // RGBD_PER_FRAGMENT)
    line.update(make_fragments_s=run["s"], fusion_fps=RGBD_FRAMES / run["s"],
                odometry_ms_per_pair=1e3 * float(np.median(times["odometry"])),
                odometry_pairs=len(times["odometry"]), pose_graph_s=times["pose_graph"],
                integrate_ms_per_frame=1e3 * float(np.median(times["integrate"])),
                surface_s=times["surface"], fpfh_s=times["fpfh"],
                png_ms_per_frame=[1e3 * float(np.median(times[k]))
                                  for k in ("read_depth", "read_color")])
    check(len(built) == n_frag, f"make_fragments built {len(built)} fragments, not {n_frag}")
    check(out_dir == os.path.join(scene_dir, "fragments"), f"fragments written to {out_dir}")

    # the layout the Redwood loader reads
    names = sorted(os.listdir(out_dir))
    want = sorted(f"fragment_{f:03d}{ext}" for f in range(n_frag)
                  for ext in (".ply", ".npy", "_fpfh.npz"))
    check(names == want, f"make_fragments wrote {names}")
    keypoints = []
    for f in range(n_frag):
        d = np.load(os.path.join(out_dir, f"fragment_{f:03d}_fpfh.npz"))
        keypoints.append(len(d["xyz"]))
        check(d["feature"].shape == (len(d["xyz"]), 33) and np.isfinite(d["feature"]).all()
              and len(d["xyz"]) > 1000, f"fragment {f}: bad FPFH file")
        pose = np.load(os.path.join(out_dir, f"fragment_{f:03d}.npy"))
        check(pose.shape == (4, 4) and np.isfinite(pose).all(), f"fragment {f}: bad pose")

    # odometry and surfaces against the rendered truth
    worst_deg = worst_cm = 0.0
    dists = []
    for f, (points, poses) in enumerate(built):
        first = truth[f * RGBD_PER_FRAGMENT]
        for k, est in enumerate(poses):
            ref = np.linalg.inv(first) @ truth[f * RGBD_PER_FRAGMENT + k]
            worst_deg = max(worst_deg, rot_error_deg(est, ref))
            worst_cm = max(worst_cm, 100.0 * float(np.linalg.norm(est[:3, 3] - ref[:3, 3])))
        dists.append(room_distance(points @ first[:3, :3].T + first[:3, 3]))
    dist = np.concatenate(dists) * 1e3
    line.update(surface_points=[len(p) for p, _ in built], keypoints=keypoints,
                odometry_max_deg=worst_deg, odometry_max_cm=worst_cm,
                surface_median_mm=float(np.median(dist)),
                surface_p95_mm=float(np.percentile(dist, 95)))
    check(worst_deg <= ODOMETRY_CEIL_DEG and worst_cm <= ODOMETRY_CEIL_CM,
          f"odometry against the truth: {worst_deg:.3f} deg, {worst_cm:.3f} cm")
    check(line["surface_median_mm"] <= SURFACE_MEDIAN_CEIL_MM
          and line["surface_p95_mm"] <= SURFACE_P95_CEIL_MM,
          f"surface points: median {line['surface_median_mm']:.2f} mm, 95% "
          f"{line['surface_p95_mm']:.2f} mm from the true surfaces")

    # the card against the CPU on frames 0 and 1
    intr = camera.PinholeIntrinsics.primesense_default()
    frames = [(fragments.read_intensity_png(os.path.join(scene_dir, "image", f"{k:06d}.png")),
               fragments.read_depth_png(os.path.join(scene_dir, "depth", f"{k:06d}.png")))
              for k in (0, 1)]
    (i0, d0), (i1, d1) = frames
    vs_cpu = {}
    for name, call in (("depth_odometry", lambda device: odometry.depth_odometry(
                            d0, d1, intr, device=device)),
                       ("rgbd_odometry", lambda device: odometry.rgbd_odometry(
                            i0, d0, i1, d1, intr, device=device))):
        (t_card, f_card), (t_cpu, f_cpu) = call(DEVICE), call("cpu")
        vs_cpu[name] = {"max_abs": float((t_card.cpu() - t_cpu).abs().max()),
                        "frac": [float(f_card), float(f_cpu)]}
        # the pixel associations round alike (fusion/camera.py); the 6x6
        # sums and the solve do not, so the transforms agree to ~1e-8, not bitwise
        check(vs_cpu[name]["max_abs"] <= 1e-6 and abs(float(f_card) - float(f_cpu)) <= 1e-3,
              f"{name}: card against CPU {vs_cpu[name]}")
    pts0, valid0 = camera.backproject_depth(torch.as_tensor(d0), intr)
    pts0 = pts0[valid0].numpy()
    origin = 0.5 * (pts0.min(0) + pts0.max(0)) - 0.5 * 256 * 0.008
    pose1 = built[0][1][1]
    vols = {}
    for device in (DEVICE, "cpu"):
        vols[device] = tsdf.TSDFVolume(origin=origin, device=device)
        vols[device].integrate(d1, intr, pose1)
    diff = (vols[DEVICE].tsdf.cpu() - vols["cpu"].tsdf).abs()
    vs_cpu["tsdf_integrate"] = {
        "voxels": diff.numel(), "bitwise_share": float((diff == 0).float().mean()),
        "share_within_1e-6": float((diff <= 1e-6).float().mean()), "max_abs": float(diff.max()),
        "weight_equal_share": float((vols[DEVICE].weight.cpu() == vols["cpu"].weight)
                                    .float().mean()),
        "updated_voxels": int((vols["cpu"].weight > 0).sum())}
    line["card_vs_cpu"] = vs_cpu
    check(vs_cpu["tsdf_integrate"]["share_within_1e-6"] >= 0.9999
          and vs_cpu["tsdf_integrate"]["weight_equal_share"] >= 0.9999,
          f"TSDF integrate: card against CPU {vs_cpu['tsdf_integrate']}")
    del vols

    for f in range(n_frag):  # the true fragment -> world poses, for phase 29
        np.save(os.path.join(out_dir, f"fragment_{f:03d}.npy"), truth[f * RGBD_PER_FRAGMENT])
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return root


def multiway_clis(torch, kernels, dev, tmp, card, rgbd_root) -> dict:
    """Phase 29: the multiway CLIs through ``main(argv)`` on fake Redwood
    scenes (``write_redwood_scene``) with a snapshot of the Synthetic
    release. ``test_multi_ate --use_icp true --save_traj true`` at its default
    --num_node 20000 on REDWOOD_FRAGMENTS fragments of REDWOOD_POINTS: every
    pair's correspondences pad to 20480 (the split layer kernels 7b / 7c, the
    symmetric cache), then multi-scale ICP (the nn-search kernel 94 times an
    edge, once more for its information matrix, once a loop closure's
    overlap gate) and the pose graph on the card; the ATE against its
    ceiling, the kept and pruned edges, the trajectory file, one pair held
    to the dense path (5e-3, or phase 25's rule for a bistable refinement)
    and the first whole forward at 20480 timed. ``test_multi`` at its default
    5000 on fragments of MULTI_POINTS (bucket 5120: the whole-layer kernel
    7a): recall against its floor, each pair held to the dense path. Then
    ``test_multi_ate`` on phase 28's fragments with the renderer's true
    poses: the chain from RGB-D frames to an ATE."""
    import io
    import re

    import numpy as np

    from pointdsc_tpu_torch.data import pipeline
    from pointdsc_tpu_torch.data.pipeline import bucket_size
    from pointdsc_tpu_torch.eval.redwood_protocol import read_trajectory
    from pointdsc_tpu_torch.kernels.sc_attention import use_symmetric_cache
    from pointdsc_tpu_torch.multiway import registration, test_multi, test_multi_ate

    start = time.perf_counter()
    root = os.path.join(tmp, "redwood")
    write_redwood_scene(root, REDWOOD_SCENE, REDWOOD_FRAGMENTS, REDWOOD_POINTS, REDWOOD_WORLD,
                        seed=0)
    write_redwood_scene(root, MULTI_SCENE, REDWOOD_FRAGMENTS, MULTI_POINTS, MULTI_WORLD, seed=1)
    work = os.path.join(tmp, "work_redwood")
    write_snapshot(work, "smoke_redwood", SNAPSHOT)
    argv = ["--chosen_snapshot", "smoke_redwood", "--root", root, "--device", DEVICE]
    n_pairs = REDWOOD_FRAGMENTS * (REDWOOD_FRAGMENTS - 1) // 2
    line = {"phase": "multiway_clis", "card": card, "fragments": REDWOOD_FRAGMENTS,
            "points": REDWOOD_POINTS, "num_node": ATE_NODE}
    captured, samples, icp_s, graphs = {}, [], [], []

    def capturing(model, dataset, fused, device):
        t0 = time.perf_counter()
        pairwise, model = register(model, dataset, fused, device)
        captured.update(model=model, pairwise=pairwise, fused=fused,
                        register_s=time.perf_counter() - t0)
        return pairwise, model

    def padding(sample, n_pad=None):
        samples.append(sample)
        return pad(sample, n_pad)

    def optimizing(graph, **kw):
        out = optimize(graph, **kw)
        graphs.append([len(graph.edges), len(out.edges)])
        return out

    cwd = os.getcwd()
    os.chdir(work)
    try:
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            register = stack.enter_context(patched(test_multi_ate, "register_pairs", capturing))
            pad = stack.enter_context(patched(pipeline, "pad_to_bucket", padding))
            optimize = stack.enter_context(patched(registration, "optimize_pose_graph",
                                                   optimizing))
            stack.enter_context(timed_calls(registration, "multi_scale_icp", icp_s))
            run = stack.enter_context(counted(torch, kernels))
            stack.enter_context(contextlib.redirect_stdout(buf))
            ates = test_multi_ate.main(argv + ["--scenes", REDWOOD_SCENE, "--num_node",
                                               str(ATE_NODE), "--use_icp", "true",
                                               "--save_traj", "true"])
        print(buf.getvalue(), end="", flush=True)
        model = captured["model"]
        flipped = not model.offset_softmax
        n_corr = [s["corr_pos"].shape[0] for s in samples]
        buckets = sorted({bucket_size(n) for n in n_corr})
        kept = int(re.search(r"\((\d+) edges kept\)", buf.getvalue()).group(1))
        nn = run["counts"]["nearest_neighbors"]
        loops = n_pairs - (REDWOOD_FRAGMENTS - 1)
        line.update(ate_cm=ates[0], s=run["s"], n_corr=n_corr, buckets=buckets,
                    symmetric_cache=use_symmetric_cache(buckets[-1]), flipped=flipped,
                    edges_in_out=graphs, kept=kept, nn_launches=nn,
                    icp_s_per_edge=icp_s, register_s=captured["register_s"],
                    launches={k: run["counts"][k] for k in eval_kernels(buckets[-1], flipped)
                              + ("nearest_neighbors",)})
        print(f"test_multi_ate: correspondences {n_corr}, buckets {buckets}", flush=True)
        check(len(ates) == 1 and np.isfinite(ates[0]) and ates[0] <= REDWOOD_ATE_CEIL_CM,
              f"test_multi_ate: ATE {ates} cm")
        check(buckets == [20480] and len(n_corr) == n_pairs, f"buckets {buckets} of {n_corr}")
        check(kept >= REDWOOD_FRAGMENTS - 1 and len(graphs) == 2 and graphs[1][1] == kept,
              f"kept edges {kept}, the pose graphs' edges in and out {graphs}")
        check(nn == 95 * len(icp_s) + loops,
              f"{nn} nn-search launches for {len(icp_s)} multi-scale ICP runs and {loops} loops")
        check_launched(run["counts"], eval_kernels(buckets[-1], flipped) + ("nearest_neighbors",),
                       "test_multi_ate")
        check(flipped or line["symmetric_cache"], "20480 did not take the symmetric cache")
        keys, traj = read_trajectory(os.path.join("logs", f"{REDWOOD_SCENE}_traj.log"))
        check(traj.shape == (REDWOOD_FRAGMENTS, 4, 4) and np.isfinite(traj).all(),
              "bad trajectory file")

        # pair 0 against the dense path, and the forward at 20480 timed
        padded = pipeline.pad_to_bucket(samples[0])
        cp, src, tgt, mask = (torch.as_tensor(padded[k])[None].to(dev)
                              for k in ("corr_pos", "src_keypts", "tgt_keypts", "mask"))
        fused_out = model(cp, src, tgt, mask=mask, fused=True)
        dense_out = model(cp, src, tgt, mask=mask, fused=False)
        ft, dt = (o.final_trans[0].cpu().numpy() for o in (fused_out, dense_out))
        n0 = n_corr[0]
        gt = samples[0]["gt_trans"]
        d = {"err": float(np.abs(ft - dt).max()), "re_deg": rot_error_deg(ft, dt),
             "te_cm": 100 * float(np.linalg.norm(ft[:3, 3] - dt[:3, 3])),
             "labels": float((fused_out.final_labels[0, :n0] == dense_out.final_labels[0, :n0])
                             .float().mean()),
             "same_as_cli": float(np.abs(ft - captured["pairwise"][(0, 1)]).max()),
             "vs_gt": [rot_error_deg(ft, gt), rot_error_deg(dt, gt)]}
        line["vs_dense"] = d
        check(same_registration(d["err"], d, BISTABLE_RULE),
              f"test_multi_ate pair 0: fused against dense {d}")
        line["forward_ms_20480"] = time_ms(lambda: model(cp, src, tgt, mask=mask, fused=True),
                                           reps=5, warmup=1) if DEVICE == "cuda" else None
        line["pose_graph_build"] = graphs

        # test_multi at its default 5000
        made = []

        def recording_evaluator(*args, **kwargs):
            ev = evaluator(*args, **kwargs)
            rec = Recorded(ev)
            rec.pairs = []
            run_pair = ev.run_pair

            def run_one(sample, scene_ind=0, data_time=0.0):
                row, trans = run_pair(sample, scene_ind=scene_ind, data_time=data_time)
                rec.pairs.append((sample, trans, rec.calls[-1][1]))
                return row, trans

            ev.run_pair = run_one
            made.append(rec)
            return ev

        with patched(test_multi, "Evaluator", recording_evaluator) as evaluator, \
                counted(torch, kernels) as run:
            stats, agg = test_multi.main(argv + ["--scenes", MULTI_SCENE, "--num_node",
                                                 str(MULTI_NODE)])
        rec = made[-1]
        details = []
        errs = dense_errors(torch, dev, rec, details)
        m_buckets = sorted({bucket_size(s["corr_pos"].shape[0]) for s, *_ in rec.pairs})
        names = eval_kernels(m_buckets[-1], rec.ev.flipped)
        line.update(multi_s=run["s"], multi_recall=agg["pair_recall"], multi_buckets=m_buckets,
                    multi_flipped=rec.ev.flipped, multi_last_slack=rec.ev.last_slack,
                    multi_max_err_vs_dense=max(errs),
                    multi_model_time_ms=agg["model_time"] * 1e3,
                    multi_data_time_ms=agg["data_time"] * 1e3,
                    multi_launches={k: run["counts"][k] for k in names})
        print(f"test_multi: buckets {m_buckets}", flush=True)
        check(stats.shape == (n_pairs, 12) and np.isfinite(stats).all(), "test_multi: bad stats")
        check(m_buckets == [5120], f"test_multi buckets {m_buckets}")
        check(agg["pair_recall"] >= MULTI_RECALL_FLOOR, f"test_multi recall {agg['pair_recall']}")
        for err, dd in zip(errs, details):
            check(same_registration(err, dd, BISTABLE_RULE),
                  f"test_multi: fused against dense {err:.3e}, {dd}")
        check_launched(run["counts"], names, "test_multi")

        # phase 28's fragments, with the renderer's true poses
        with counted(torch, kernels) as run:
            rgbd_ates = test_multi_ate.main(["--chosen_snapshot", "smoke_redwood", "--root",
                                             rgbd_root, "--scenes", RGBD_SCENE, "--num_node",
                                             str(MULTI_NODE), "--device", DEVICE])
        line.update(rgbd_ate_cm=rgbd_ates[0], rgbd_s=run["s"],
                    rgbd_nn_launches=run["counts"]["nearest_neighbors"])
        check(np.isfinite(rgbd_ates[0]) and rgbd_ates[0] <= RGBD_ATE_CEIL_CM,
              f"the RGB-D fragments' ATE {rgbd_ates[0]} cm")
    finally:
        os.chdir(cwd)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


def fcgf_3dmatch(torch, kernels, dev, tmp, card) -> dict:
    """Phase 30: FCGF features through the 3DMatch CLI. ``write_fcgf_scene``
    writes FCGF_FRAGMENTS raw fragments of one test scene; ``tools/cal_fcgf``
    (``main(argv)``, the release checkpoint, its default 96^3 grid and 5 cm
    voxels) writes their ``_fcgf.npz`` on the card; fragment 0's keypoints
    equal the port's CPU run of ``extract_features`` and its features lie
    within FCGF_FEATURE_ATOL. Then ``evaluation/test_3DMatch`` with the
    Synthetic release (descriptor fcgf, every keypoint a correspondence):
    finite stats; where the guard flipped to the running max (the
    reference's behaviour, C4), the forward rerun to the CLI's transforms,
    every attention launch of it and of the sound forward (the attention's
    plain version at the kernel's bf16 precision), and that plain version,
    within ``exact_attention``'s allowance, and each pair's transform within
    1e-3 of the sound forward's or else the same registration under
    FCGF_RULE; each pair's transform within 1e-3 of the dense forward of its
    sample (phase 24's rule) or else the same registration under FCGF_RULE;
    recall >= FCGF_RECALL_FLOOR; the kernels of the configuration the guard
    left launched. The dense forward against itself with its input moved by
    one rounding (``conditioning_control``) is printed. Then
    ``extract_features_tiled`` at KITTI_VOXEL (grid 96, halo 8) on frame 0 of
    phase 25's drive, on the card and on the CPU: keypoints equal, features
    within FCGF_FEATURE_ATOL. Times: ``cal_fcgf`` s a fragment, the tiled
    extraction s a frame, the VoxelFCGF forward ms at 64^3 and 96^3 (CUDA
    events after a warm-up). Returns the summary line."""
    import numpy as np

    from pointdsc_tpu_torch.data.pipeline import bucket_size
    from pointdsc_tpu_torch.data.ply import read_ply_xyz
    from pointdsc_tpu_torch.descriptors.fcgf import (
        extract_features,
        extract_features_tiled,
        load_fcgf,
    )
    from pointdsc_tpu_torch.evaluation import test_3DMatch
    from pointdsc_tpu_torch.tools import cal_fcgf

    start = time.perf_counter()
    root = os.path.join(tmp, "3dmatch_fcgf")
    write_fcgf_scene(root, TEST_SCENE)
    frag_dir = os.path.join(root, "fragments", TEST_SCENE)
    line = {"phase": "fcgf_3dmatch", "card": card, "fragments": FCGF_FRAGMENTS,
            "grid": FCGF_GRID, "voxel": FCGF_VOXEL}
    extract_s = []
    with timed_calls(cal_fcgf, "extract_features", extract_s), counted(torch, kernels) as run:
        n = cal_fcgf.main(["--job", "3dmatch_test", "--root", root, "--scenes", TEST_SCENE,
                           "--checkpoint", FCGF_CHECKPOINT, "--grid_size", str(FCGF_GRID),
                           "--device", DEVICE])
    line.update(cal_fcgf_s=run["s"], cal_fcgf_s_per_fragment=extract_s)
    check(n == FCGF_FRAGMENTS, f"cal_fcgf wrote {n} fragments")
    files = [np.load(os.path.join(frag_dir, f"cloud_bin_{i}_fcgf.npz")) for i in range(n)]
    line["keypoints"] = [len(d["xyz"]) for d in files]
    check(all(d["feature"].shape == (len(d["xyz"]), 32) and np.isfinite(d["feature"]).all()
              for d in files), "cal_fcgf: bad feature file")

    cpu_model = load_fcgf(FCGF_CHECKPOINT, device="cpu")
    kp, feat = extract_features(cpu_model, read_ply_xyz(os.path.join(frag_dir, "cloud_bin_0.ply")),
                                FCGF_VOXEL, FCGF_GRID)
    err = float(np.abs(files[0]["feature"] - feat).max())
    line["fragment0_vs_cpu"] = err
    check(np.array_equal(files[0]["xyz"], kp), "cal_fcgf: keypoints differ from the CPU's")
    check(err <= FCGF_FEATURE_ATOL, f"cal_fcgf: card against CPU {err:.3e}")

    work = os.path.join(tmp, "work_fcgf")
    write_snapshot(work, "smoke_fcgf", SNAPSHOT, root=root)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with recorded_cli_evaluators() as made, counted(torch, kernels) as run:
            stats, agg = test_3DMatch.main(["--chosen_snapshot", "smoke_fcgf", "--device",
                                            DEVICE])
        rec = made[-1]
        n_pairs = FCGF_FRAGMENTS * (FCGF_FRAGMENTS - 1) // 2
        n_corr = [s["corr_pos"].shape[0] for s, *_ in rec.pairs]
        bucket = max(bucket_size(c) for c in n_corr)
        details = []
        errs = dense_errors(torch, dev, rec, details)
        # where the guard flipped, the witness: the fused forward again, each
        # attention launch and its plain version held to the exact attention
        # at the kernel's precision, once going on with the kernel's output
        # and once with the plain version's (the sound forward); and the
        # control: the dense forward against itself with its input features
        # moved by one float32 rounding
        shares, sound, control = [], [], []
        if rec.ev.flipped:
            line["rerun_vs_cli"] = max(dense_errors(torch, dev, rec,
                                                    reference=attention_witness(torch, shares)))
            line["max_err_vs_sound"] = dense_errors(
                torch, dev, rec, sound, attention_witness(torch, shares, follow_plain=True))
            line["kernel_share"] = max(x for x, _ in shares)
            line["plain_share"] = max(x for _, x in shares)
        line["control_max_err"] = conditioning_control(torch, dev, rec, control)
        names = eval_kernels(bucket, rec.ev.flipped)
        # each pair's share of correspondences whose residual under the ground
        # truth lies within 1 cm of the inlier threshold (labels flip there)
        near = []
        for sample, *_ in rec.pairs:
            gt = sample["gt_trans"]
            res = np.linalg.norm(sample["src_keypts"] @ gt[:3, :3].T + gt[:3, 3]
                                 - sample["tgt_keypts"], axis=1)
            near.append(float(np.mean(np.abs(res - rec.ev.model.inlier_threshold) < 0.01)))
        line.update(cli_s=run["s"], n_corr=n_corr, bucket=bucket, recall=agg["pair_recall"],
                    flipped=rec.ev.flipped, last_slack=rec.ev.last_slack,
                    max_err_vs_dense=errs, vs_dense=details, vs_sound=sound, control=control,
                    near_threshold=near,
                    launches={k: run["counts"][k] for k in names},
                    model_time_ms=agg["model_time"] * 1e3, data_time_ms=agg["data_time"] * 1e3)
        print(json.dumps({**line, "phase": "fcgf_3dmatch_cli"}), flush=True)
        check(stats.shape == (n_pairs, 12) and np.isfinite(stats).all(), "FCGF CLI: bad stats")
        check(os.path.exists("logs/smoke_fcgf-SVD-fcgf.log"), "FCGF CLI: no log written")
        if rec.ev.flipped:
            # the forward reruns to the CLI's transforms, and every attention
            # launch of both forwards, and its plain version, lies within the
            # exact attention's allowance
            check(line["rerun_vs_cli"] <= 1e-6, f"FCGF CLI: rerun {line['rerun_vs_cli']:.3e}")
            check(len(shares) == 2 * rec.ev.model.encoder.num_layers * n_pairs
                  and max(line["kernel_share"], line["plain_share"]) <= 1.0,
                  f"FCGF CLI: attention off the exact one, shares {shares}")
            for err, d in zip(line["max_err_vs_sound"], sound):
                check(same_registration(err, d, FCGF_RULE, verdict=(15.0, 30.0)),
                      f"FCGF CLI: fused against the sound forward {err:.3e}, {d}")
        # against the dense f32 path: within 1e-3 (phase 24), or else the same
        # registration under FCGF_RULE with the same verdict against the
        # ground truth (RE < 15 deg, TE < 30 cm). These ~70%-inlier pairs
        # leave the offset regime by thousands of nats, and any change of
        # rounding moves their labels: keypoints are 5 cm voxel centres, so a
        # match one or two voxels off has a residual near 5 or 10 cm, the
        # latter on the inlier threshold (PERF.md, section 6)
        for err, d in zip(errs, details):
            check(same_registration(err, d, FCGF_RULE, verdict=(15.0, 30.0)),
                  f"FCGF CLI: fused against dense {err:.3e}, {d}")
        check(agg["pair_recall"] >= FCGF_RECALL_FLOOR - 1e-9,
              f"FCGF CLI: recall {agg['pair_recall']:.1f}%")
        check_launched(run["counts"], names, "FCGF 3DMatch CLI")
    finally:
        os.chdir(cwd)

    # the tiled extraction on a phase-25 KITTI frame, card against CPU
    frame = np.fromfile(os.path.join(tmp, "drive", "sequences", "08", "velodyne", "000000.bin"),
                        np.float32).reshape(-1, 4)[:, :3]
    card_model = load_fcgf(FCGF_CHECKPOINT, device=DEVICE)
    t0 = time.perf_counter()
    kp_card, feat_card = extract_features_tiled(card_model, frame, KITTI_VOXEL)
    tiled_s = time.perf_counter() - t0
    kp_cpu, feat_cpu = extract_features_tiled(cpu_model, frame, KITTI_VOXEL)
    err = float(np.abs(feat_card - feat_cpu).max())
    line.update(tiled_points=len(frame), tiled_keypoints=len(kp_card), tiled_s=tiled_s,
                tiled_vs_cpu=err)
    check(np.array_equal(kp_card, kp_cpu), "tiled extraction: keypoints differ from the CPU's")
    check(err <= FCGF_FEATURE_ATOL, f"tiled extraction: card against CPU {err:.3e}")
    del cpu_model

    if DEVICE == "cuda":
        with torch.no_grad():
            for g in (FCGF_TRAIN_GRID, FCGF_GRID):
                occ = torch.zeros((1, 1, g, g, g), device=dev)
                occ.view(-1)[torch.randperm(g ** 3, generator=torch.Generator().manual_seed(g))
                             [:g ** 3 // 50].to(dev)] = 1.0
                line[f"forward_ms_{g}"] = time_ms(lambda: card_model(occ), reps=10, warmup=2)
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


def held_out_fcgf_ratios(model, grid) -> list[float]:
    """VoxelFCGF's inlier ratio on each of ``train_fcgf.evaluate``'s
    FCGF_EVAL_PAIRS held-out pairs (``np.random.default_rng(777)``)."""
    import numpy as np

    from pointdsc_tpu_torch.descriptors.fcgf import extract_features
    from pointdsc_tpu_torch.tools import train_fcgf

    rng, ratios = np.random.default_rng(777), []
    for _ in range(FCGF_EVAL_PAIRS):
        *_, (v0, v1, pose) = train_fcgf.make_pair(rng, FCGF_VOXEL, grid)
        k0, f0 = extract_features(model, v0, FCGF_VOXEL, grid)
        k1, f1 = extract_features(model, v1, FCGF_VOXEL, grid)
        ratios.append(train_fcgf.inlier_ratio(k0, f0, k1, f1, pose))
    return ratios


def fcgf_training_oanet(torch, dev, card) -> dict:
    """Phase 31: FCGF training and OANet.

    * FCGF_TRAIN_STEPS steps of ``descriptors/fcgf_train.py``'s train step
      (Adam, lr 1e-3) from the release checkpoint on ``train_fcgf.make_pair``
      pairs at a 64^3 grid on the card: finite losses; the first step's loss
      and every running statistic within FCGF_LOSS_ATOL / FCGF_STATS_ATOL of
      the port's CPU step on the same pair; ms a step (host clock closed by a
      synchronise, after the first) and peak GiB;
    * ``train_fcgf.evaluate`` with the release checkpoint on FCGF_EVAL_PAIRS
      held-out pairs at 64^3 on the card: its VoxelFCGF mean at least
      FCGF_EVAL_FLOOR and equal to the mean of ``held_out_fcgf_ratios`` on
      the card, each of which lies within FCGF_RATIO_ATOL of the CPU's on the
      same pair; FPFH's mean on the same pairs printed beside it;
    * ``OANet`` (random weights of seed 0, no kernel) on one synthetic pair
      of N correspondences on the card against the CPU."""
    import numpy as np

    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.descriptors.fcgf import load_fcgf
    from pointdsc_tpu_torch.descriptors.fcgf_train import make_fcgf_train_step
    from pointdsc_tpu_torch.models import OANet
    from pointdsc_tpu_torch.tools import train_fcgf

    start = time.perf_counter()
    line = {"phase": "fcgf_training_oanet", "card": card, "grid": FCGF_TRAIN_GRID}
    g = FCGF_TRAIN_GRID

    # training steps, the first one against the CPU
    torch.set_grad_enabled(True)
    rng = np.random.default_rng(0)
    pairs = [train_fcgf.make_pair(rng, FCGF_VOXEL, g) for _ in range(FCGF_TRAIN_STEPS)]
    models, steps = {}, {}
    for key, device in (("card", DEVICE), ("cpu", "cpu")):
        models[key] = load_fcgf(FCGF_CHECKPOINT, device=device)
        steps[key] = make_fcgf_train_step(
            models[key], torch.optim.Adam(models[key].parameters(), lr=1e-3))

    def run_step(key, pair):
        occ0, occ1, i0, i1, ok, _ = pair
        device = next(models[key].parameters()).device
        return steps[key](torch.from_numpy(occ0)[None].to(device),
                          torch.from_numpy(occ1)[None].to(device),
                          torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(ok))

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i, pair in enumerate(pairs):
        t0 = time.perf_counter()
        losses.append(float(run_step("card", pair)["loss"]))
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            first = {k: v.detach().cpu().clone()
                     for k, v in models["card"].state_dict().items() if "running" in k}
    cpu_loss = float(run_step("cpu", pairs[0])["loss"])
    cpu_state = models["cpu"].state_dict()
    stats_err = max(float((v - cpu_state[k]).abs().max()) for k, v in first.items())
    line.update(losses=losses, cpu_first_loss=cpu_loss, step_ms=[1e3 * s for s in step_s],
                first_stats_vs_cpu=stats_err,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 if DEVICE == "cuda" else None)
    check(all(np.isfinite(losses)), f"FCGF train steps: losses {losses}")
    check(abs(losses[0] - cpu_loss) <= FCGF_LOSS_ATOL,
          f"FCGF train step: card loss {losses[0]} against CPU {cpu_loss}")
    check(stats_err <= FCGF_STATS_ATOL, f"FCGF train step: running statistics {stats_err:.3e}")
    del models, steps
    torch.set_grad_enabled(False)

    # the held-out evaluation for its two means; each pair's VoxelFCGF ratio
    # on the card against the CPU's
    card_model = load_fcgf(FCGF_CHECKPOINT, device=DEVICE)
    t0 = time.perf_counter()
    ir_fcgf, ir_fpfh = train_fcgf.evaluate(card_model, np.random.default_rng(777), FCGF_VOXEL, g,
                                           n_pairs=FCGF_EVAL_PAIRS)
    eval_s = time.perf_counter() - t0
    card_rows = held_out_fcgf_ratios(card_model, g)
    cpu_rows = held_out_fcgf_ratios(load_fcgf(FCGF_CHECKPOINT, device="cpu"), g)
    diffs = [abs(a - b) for a, b in zip(card_rows, cpu_rows)]
    line.update(eval_s=eval_s, inlier_ratio_fcgf=ir_fcgf, inlier_ratio_fpfh=ir_fpfh,
                card_fcgf=card_rows, cpu_fcgf=cpu_rows, ratio_vs_cpu=max(diffs))
    check(abs(float(np.mean(card_rows)) - ir_fcgf) <= 1e-9,
          f"evaluate: mean {ir_fcgf} is not its pairs' {card_rows}")
    check(max(diffs) <= FCGF_RATIO_ATOL, f"evaluate: card against CPU {diffs}")
    check(ir_fcgf >= FCGF_EVAL_FLOOR, f"evaluate: VoxelFCGF mean {ir_fcgf:.3f}")
    del card_model

    # OANet at N, card against CPU
    ex = SyntheticPairDataset(num_pairs=1, num_corr=N, seed=0)[0]
    outs = {}
    for device in (DEVICE, "cpu"):
        net = OANet(device=device, generator=torch.Generator().manual_seed(0))
        args = [torch.as_tensor(ex[k])[None].to(device)
                for k in ("corr_pos", "src_keypts", "tgt_keypts")]
        outs[device] = net(*args)
        if device == DEVICE and DEVICE == "cuda":
            line["oanet_ms"] = time_ms(lambda: net(*args), reps=10, warmup=2)
    logit_err = float((outs[DEVICE]["final_labels"].cpu() - outs["cpu"]["final_labels"])
                      .abs().max())
    trans_err = float((outs[DEVICE]["final_trans"].cpu() - outs["cpu"]["final_trans"])
                      .abs().max())
    line.update(oanet_n=N, oanet_logits_vs_cpu=logit_err, oanet_trans_vs_cpu=trans_err)
    check(bool(torch.isfinite(outs[DEVICE]["final_trans"]).all()), "OANet: bad transform")
    check(logit_err <= OANET_LOGIT_ATOL and trans_err <= OANET_TRANS_ATOL,
          f"OANet: card against CPU, logits {logit_err:.3e}, transform {trans_err:.3e}")

    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


def rect_inputs(torch, dev, n, d, c):
    """Phase 32's inputs: one synthetic pair of n points (the last 5% of the
    keys masked), the last of d row shards (n / d rows, the masked ones among
    them), and q [1, n / d, c], k, v [1, n, c] in bf16, the types the
    sequence-parallel encoder gives the kernels on the card."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset

    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.4, seed=1)[0]
    src, tgt = (torch.as_tensor(ex[key])[None].to(dev) for key in ("src_keypts", "tgt_keypts"))
    mask = (torch.arange(n) < n - int(n * PAD_FRACTION))[None].to(dev)
    nq = n // d
    rows = src[:, n - nq:].contiguous(), tgt[:, n - nq:].contiguous()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, nq, c), generator=gen).to(dev).bfloat16()
    k, v = (torch.randn((1, n, c), generator=gen).to(dev).bfloat16() for _ in range(2))
    return src, tgt, mask, rows, q, k, v


def check_rect_kernels(torch, dev) -> list[dict]:
    """Phase 32: the rectangular forms of rows 1, 3 and 4 (a row shard's
    int8 cache slice and its two cached attentions) against their plain
    versions on the card at N in RECT_SIZES and D in RECT_SHARDS, C = 128,
    and at RECT_WIDE with C = 256. The cache within one count on at most
    0.1% of the entries, the attentions at atol = rtol = 2e-3 (phase 3's
    rules). Each case timed, kernel and plain version, beside its bound: the
    slice's bytes (its n / d rows' and the n keys' coordinates read, the
    [n / d, n] bytes written) and 28 operations an entry; an attention's
    bytes (q, k, v in bf16, the slice, the key bias, the f32 output) and its
    two [n / d, n] x C products at the bf16 tensor-core rate. The row of
    the {"kernels": ...} line is the case N = 20480, D = 2 (the first sp
    shard count, at the size phase 33 runs); every case is under "cases".
    No single PyTorch call computes any of them (phase 3 says why)."""
    from pointdsc_tpu_torch.kernels import sc_attention as katt

    coef = katt.cache_coef(0.1)
    main_case = (RECT_SIZES[-1], RECT_SHARDS[0], C)
    cases = [(n, d, C) for n in RECT_SIZES for d in RECT_SHARDS] + [(*RECT_WIDE, 256)]
    found = {"compat_cache_int8_rect": [], "sc_attention_cached_rect": [],
             "sc_attention_cached_offset_rect": []}
    for n, d, c in cases:
        src, tgt, mask, (sr, tr), q, k, v = rect_inputs(torch, dev, n, d, c)
        nq = n // d
        reps = 10 if n * nq <= 12288 * 6144 else 5

        def plain_cache():
            return katt.compat_cache_plain(katt.pack_geometry(sr, tr), coef,
                                           katt.pack_geometry(src, tgt, mask))

        def build():
            return katt.build_compat_cache_int8(sr, tr, 0.1, mask=mask, src_cols=src,
                                                tgt_cols=tgt)

        cache = build()
        check(cache.shape == (1, nq, n), f"rect cache shape {tuple(cache.shape)}")
        diff = (cache.int() - plain_cache().int()).abs()
        off1 = int((diff == 1).sum())
        tag = f"N={n} D={d} C={c}"
        check(int(diff.max()) <= 1, f"rect cache {tag} differs by {int(diff.max())}")
        check(off1 <= 1e-3 * nq * n, f"rect cache {tag}: {off1} entries off by 1")
        del diff
        case = dict(n=n, d=d, c=c, rows=nq)
        if c == C:  # the cache does not depend on C: its row once a size
            found["compat_cache_int8_rect"].append(kernel_row(
                "compat_cache_int8_rect", "compat_cache.cu", "sc_attention.py:285",
                float(off1 > 0), build, plain_cache,
                float(2 * (nq + n) * 3 * 4 + nq * n),
                float(nq * n * katt.OPS_PER_CACHE_ENTRY), reps=reps, off_by_one=off1, **case))
        bias = katt.key_bias(mask, 1, n, dev)
        attn_bytes = float((nq + 2 * n) * c * 2 + nq * n + n * 4 + nq * c * 4)
        attn_ops = 4.0 * nq * n * c + OPS_PER_ATTN_PAIR_EXTRA * nq * n
        for name, offset, plain in (
                ("sc_attention_cached_rect", False, katt.sc_attention_cached_plain),
                ("sc_attention_cached_offset_rect", True, katt.sc_attention_cached_offset_plain)):
            def fused(offset=offset):
                return katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                                      offset_softmax=offset)

            def ref(plain=plain):
                return plain(q, k, v, cache, bias, c=c)

            out = fused()
            want = ref()
            err = float((out - want).abs().max())
            check(torch.allclose(out, want, atol=2e-3, rtol=2e-3),
                  f"{name} {tag}: max err {err}")
            del out, want
            found[name].append(kernel_row(
                name, "sc_attention.cu", "sc_attention.py:582" if offset else
                "sc_attention.py:590", err, fused, ref, attn_bytes, attn_ops,
                tensor_ops=4.0 * nq * n * c, reps=reps, **case))
        del cache
        torch.cuda.empty_cache()
    rows = []
    for name, per_case in found.items():
        keep = ("n", "d", "c", "rows", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        main = next(r for r in per_case if (r["n"], r["d"], r["c"]) == main_case)
        rows.append({**main, "cases": [{k: r[k] for k in keep} for r in per_case]})
        for r in per_case:
            print(json.dumps({"phase": "rect_kernels", "name": name,
                              **{k: r[k] for k in keep}}), flush=True)
    return rows


def sp_forward(torch, pt, kernels, dev, card) -> dict:
    """Phase 33. Returns the launches of the three rectangular kernels over
    the sequence-parallel forwards on meshes of more than one entry (on one
    entry the shard is the whole cloud and the attention the square kernel)."""
    import numpy as np

    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.models.regime import OFFSET_REGIME_MAX_SLACK, offset_regime_slack
    from pointdsc_tpu_torch.parallel import sp_testing_forward

    start = time.perf_counter()
    model = pt.load_pretrained(SNAPSHOT, device=DEVICE)
    running = pt.load_pretrained(SNAPSHOT, device=DEVICE, offset_softmax=False)
    # the first seeded pair of SP_N points inside the offset regime (the
    # slack depends on the pair; phase 8 says why)
    for seed in range(1, 9):
        ex = SyntheticPairDataset(num_pairs=1, num_corr=SP_N, inlier_ratio=0.4, seed=seed)[0]
        cp, src, tgt = (torch.as_tensor(ex[key])[None].to(dev)
                        for key in ("corr_pos", "src_keypts", "tgt_keypts"))
        slack = offset_regime_slack(model, cp, src, tgt)
        if slack < OFFSET_REGIME_MAX_SLACK:
            break
    check(slack < OFFSET_REGIME_MAX_SLACK, f"no pair of {SP_N} points inside the offset regime")
    line = {"phase": "sp_forward", "card": card, "n": SP_N, "seed": seed, "slack": slack,
            "layers": model.encoder.num_layers, "c": model.num_channels, "k": model.k}
    launches = {"compat_cache_int8_rect": 0, "sc_attention_cached_rect": 0,
                "sc_attention_cached_offset_rect": 0}
    tail = ("confidence_head", "nms_local_max", "nms_select", "seed_knn_exact",
            "seed_hypotheses", "seed_inlier_counts", "select_hypothesis",
            "fused_post_refinement")
    for tag, m, attn in (("offset", model, "sc_attention_cached_offset"),
                         ("running_max", running, "sc_attention_cached")):
        single = m(cp, src, tgt, testing=True, fused=True)
        dense = sp_testing_forward(m, cp, src, tgt, [dev] * SP_SHARDS[-1], fused_encoder=False)
        line[f"{tag}_single_ms"] = time_ms(lambda: m(cp, src, tgt, testing=True, fused=True),
                                           reps=5, warmup=1)
        outs = {}
        for d in SP_SHARDS:
            mesh = [dev] * d
            with counted(torch, kernels) as run:
                out = sp_testing_forward(m, cp, src, tgt, mesh, fused_encoder=True)
            counts = run["counts"]
            print(f"sp forward {tag} D={d}: launches {json.dumps(counts)}", flush=True)
            check(counts["compat_cache_int8"] == d,
                  f"{tag} D={d}: {counts['compat_cache_int8']} cache launches, expected {d}")
            check(counts[attn] == 12 * d,
                  f"{tag} D={d}: {counts[attn]} {attn} launches, expected {12 * d}")
            stray = [name for name in ("fused_encoder_layer", "pcn_qkv", "attn_mlp_residual",
                                       "fused_sc_attention", "compat_cache_int8_sym",
                                       "sc_attention_cached" if attn != "sc_attention_cached"
                                       else "sc_attention_cached_offset") if counts[name]]
            check(not stray, f"{tag} D={d}: launched {stray} in the sp encoder's place")
            missing = [name for name in tail if counts[name] <= 0]
            check(not missing, f"{tag} D={d}: tail kernels not launched: {missing}")
            if d > 1:
                launches["compat_cache_int8_rect"] += counts["compat_cache_int8"]
                launches[f"{attn}_rect"] += counts[attn]
            outs[d] = out
            for ref_tag, ref in (("single", single), ("dense_sp", dense)):
                terr = float((out.final_trans - ref.final_trans).abs().max())
                agree = float((out.final_labels == ref.final_labels).float().mean())
                line[f"{tag}_d{d}_vs_{ref_tag}"] = [terr, agree]
                check(terr <= 1e-3 and agree > 0.99,
                      f"{tag} D={d}: disagrees with the {ref_tag} forward ({terr}, {agree})")
            if d > 1:
                ferr = float((out.normed_features - outs[1].normed_features).abs().max())
                terr = float((out.final_trans - outs[1].final_trans).abs().max())
                agree = float((out.final_labels == outs[1].final_labels).float().mean())
                line[f"{tag}_d{d}_vs_d1"] = [ferr, terr, agree]
                check(terr <= 1e-3 and agree > 0.99, f"{tag} D={d}: disagrees with D=1")
            line[f"{tag}_ms_d{d}"] = time_ms(
                lambda: sp_testing_forward(m, cp, src, tgt, mesh, fused_encoder=True),
                reps=5, warmup=1)
        del single, dense, outs
        torch.cuda.empty_cache()

    # one SyntheticKITTI pair through the Evaluator on a mesh of two entries,
    # the guard live, against the single-card Evaluator (phase 8b's rule)
    kitti = pt.load_pretrained(SNAPSHOT_KITTI, device=DEVICE)
    ds_k = SyntheticPairDataset(num_pairs=1, num_corr=N_KITTI, **DEFAULT_DATA_KITTI, **KITTI_DATA)
    ev = pt.Evaluator(kitti, fused_attention=True, sp_mesh=[dev] * 2, device=DEVICE)
    with counted(torch, kernels) as run:
        stats, agg = ev.run_dataset(ds_k, verbose=False)
    counts = run["counts"]
    attn = "sc_attention_cached" if ev.flipped else "sc_attention_cached_offset"
    check(counts["compat_cache_int8"] == 2 * 2 and counts[attn] == 12 * 2 * 2,
          f"Evaluator(sp_mesh): launches {json.dumps(counts)}")
    launches["compat_cache_int8_rect"] += counts["compat_cache_int8"]
    launches[f"{attn}_rect"] += counts[attn]
    row_single, trans_single = pt.Evaluator(kitti, fused_attention=True,
                                            device=DEVICE).run_pair(ds_k[0])
    _, trans_sp = ev.run_pair(ds_k[0])
    terr = float(np.abs(trans_sp - trans_single).max())
    check(np.isfinite(stats).all() and stats[0, 0] == row_single[0] and terr <= 5e-3,
          f"Evaluator(sp_mesh) disagrees with the single card ({terr})")
    line.update(kitti_sp_flipped=ev.flipped, kitti_sp_slack=ev.last_slack,
                kitti_sp_vs_single=terr, kitti_sp_success=float(stats[0, 0]),
                kitti_sp_model_time_ms=float(stats[0, 9]) * 1e3,
                phase_s=time.perf_counter() - start)
    print(json.dumps(line), flush=True)
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multi_device(torch, pt, kernels, dev, tmp, card) -> dict:
    """Phase 34: sharded evaluation, the 3DMatch CLI's --sp and --sharded,
    and torch.distributed over NCCL at world size 1. Returns the summary
    line."""
    import numpy as np

    from pointdsc_tpu_torch.data.threedmatch import ThreeDMatchTest
    from pointdsc_tpu_torch.evaluation import test_3DMatch
    from pointdsc_tpu_torch.parallel import distributed as dist_mod
    from pointdsc_tpu_torch.train.config import Config

    start = time.perf_counter()
    line = {"phase": "multi_device", "card": card}
    # 34a. phase 24's scene: sharded over meshes of 1 and 2 entries against
    # the sequential run of the same Evaluator (two entries run two pairs as
    # one batch): success flags equal, TE within 1e-2 cm, cos(RE) within 1e-6
    # (near 0, arccos magnifies the trace's rounding). Not bit for bit even
    # at one entry: the first pass over a scene's first pairs already
    # differs from a second pass at that level on the CPU rehearsal
    cfg = Config.load(os.path.join(SNAPSHOT, "config.json"))
    ds = ThreeDMatchTest(root=os.path.join(tmp, "3dmatch"), descriptor=cfg.descriptor,
                         in_dim=cfg.in_dim, inlier_threshold=cfg.inlier_threshold,
                         num_node="all", use_mutual=cfg.use_mutual, device=DEVICE)
    ev = pt.Evaluator(pt.load_pretrained(SNAPSHOT, device=DEVICE), fused_attention=True,
                      device=DEVICE)
    seq, agg_seq = ev.run_dataset(ds, scene_of=ds.scene_of, verbose=False)
    for d in (1, 2):
        with counted(torch, kernels) as run:
            sh, agg = ev.run_dataset_sharded(ds, mesh=[dev] * d, scene_of=ds.scene_of,
                                             verbose=False)
        check(sh.shape == seq.shape and np.isfinite(sh).all(), f"sharded D={d}: bad stats")
        check(np.array_equal(sh[:, 0], seq[:, 0]), f"sharded D={d}: success flags differ")
        check(np.abs(sh[:, 2] - seq[:, 2]).max() <= 1e-2
              and np.abs(np.cos(np.radians(sh[:, 1])) - np.cos(np.radians(seq[:, 1]))).max()
              <= 1e-6, f"sharded D={d}: RE/TE differ")
        check(run["counts"]["confidence_head"] > 0, f"sharded D={d}: no kernel launched")
        line[f"sharded_d{d}"] = dict(recall=agg["pair_recall"], s=run["s"],
                                     model_time_ms=agg["model_time"] * 1e3,
                                     semantics=agg["model_time_semantics"])
    line["sequential"] = dict(recall=agg_seq["pair_recall"],
                              model_time_ms=agg_seq["model_time"] * 1e3, flipped=ev.flipped)

    # 34b. the 3DMatch CLI with --sp true (a mesh of every visible card) and
    # --sharded true on phase 24's root and snapshot
    cwd = os.getcwd()
    os.chdir(os.path.join(tmp, "work_3dmatch"))
    try:
        for flag in ("--sp", "--sharded"):
            with counted(torch, kernels) as run:
                stats, agg = test_3DMatch.main(["--chosen_snapshot", "smoke_3dmatch", "--device",
                                                DEVICE, flag, "true"])
            check(stats.shape == seq.shape and np.isfinite(stats).all(), f"CLI {flag}: bad stats")
            check(agg["pair_recall"] >= 100.0 * 5 / 6, f"CLI {flag}: recall {agg['pair_recall']}")
            counts = run["counts"]
            if flag == "--sp":  # one rectangular cache launch a forward on a one-card mesh
                check(counts["compat_cache_int8"] == len(ds) + 1
                      and counts["fused_encoder_layer"] == 0,
                      f"CLI --sp: launches {json.dumps(counts)}")
            line[f"cli{flag[1:]}"] = dict(recall=agg["pair_recall"], s=run["s"],
                                           launches={k: v for k, v in counts.items() if v})
    finally:
        os.chdir(cwd)

    # 34c. torch.distributed over NCCL at world size 1 on the loopback, and
    # DDP Trainer steps against the plain Trainer's from the same weights and
    # batches (fused, bs 16 / 1024, depth DDP_LAYERS at full width). The
    # plain Trainer is made before the process group exists, so it takes no
    # group. Rule: loss terms within 1e-5 relative, BatchNorm statistics
    # within 1e-5 + 1e-4 relative, parameters within 2 lr a step everywhere
    # and 99% of the entries within 1e-6 (Adam steps a rounding-noise gradient
    # by up to lr either way)
    batches = [train_batch(TRAIN_BS, TRAIN_NODE, seed=s) for s in range(3, 3 + DDP_STEPS)]
    with torch.enable_grad():
        plain_tr, plain_state = make_trainer(torch, pt, True, num_layers=DDP_LAYERS)
        check(plain_tr.group is None, "the plain Trainer took a process group")
        weights = {k: v.clone() for k, v in plain_state.model.state_dict().items()}
        plain_steps = []
        for b in batches:
            plain_state, m = plain_tr.train_step(plain_state, plain_tr.to_device(b), 1)
            plain_steps.append(({k: float(v) for k, v in m.items()},
                                {k: v.clone() for k, v in plain_state.model.state_dict().items()}))
        dist_mod.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=DEVICE)
        try:
            check(np.array_equal(dist_mod.process_shard(10), np.arange(10)), "process_shard")
            gathered = dist_mod.all_gather_rows(np.array([1.0, 2.0], np.float32))
            check(gathered.shape == (1, 2) and gathered.tolist() == [[1.0, 2.0]],
                  f"all_gather_rows gave {gathered}")
            ddp_tr, ddp_state = make_trainer(torch, pt, True, num_layers=DDP_LAYERS)
            check(ddp_tr._ddp is not None and ddp_tr.replicas == 1, "the Trainer took no DDP")
            ddp_state.model.load_state_dict(weights)
            lr = ddp_tr.cfg.lr
            worst = {"loss": 0.0, "stats": 0.0, "params": 0.0}
            with counted(torch, kernels) as run:
                for i, b in enumerate(batches):
                    ddp_state, m = ddp_tr.train_step(ddp_state, ddp_tr.to_device(b), 1)
                    pm, psd = plain_steps[i]
                    check(float(m["grad_finite"]) == 1.0, f"DDP step {i}: gradient not finite")
                    for key in ("class_loss", "sm_loss", "trans_loss", "loss"):
                        rel = abs(float(m[key]) - pm[key]) / max(abs(pm[key]), 1e-12)
                        worst["loss"] = max(worst["loss"], rel)
                        check(rel <= 1e-5, f"DDP step {i}: {key} differs by {rel:.3e}")
                    for name, ref in psd.items():
                        got = ddp_state.model.state_dict()[name]
                        diff = (got - ref).abs()
                        if "running_" in name:
                            worst["stats"] = max(worst["stats"], float(diff.max()))
                            check(bool(torch.allclose(got, ref, atol=1e-5, rtol=1e-4)),
                                  f"DDP step {i}: {name} differs")
                        elif "num_batches" not in name:
                            worst["params"] = max(worst["params"], float(diff.max()))
                            check(float(diff.max()) <= 2 * lr * (i + 1) + 1e-6
                                  and float((diff <= 1e-6).float().mean()) >= 0.99,
                                  f"DDP step {i}: {name} differs by {float(diff.max()):.3e}")
            for name in TRAIN_KERNELS:
                check(run["counts"][name] > 0, f"DDP steps launched no {name}")
            line["ddp"] = dict(world=1, backend=torch.distributed.get_backend(),
                               steps=DDP_STEPS, layers=DDP_LAYERS, worst=worst, s=run["s"])
        finally:
            torch.distributed.destroy_process_group()
    # what one card cannot show
    line["needs_a_second_card"] = [
        "NCCL collectives between devices (all_reduce, all_gather) and their time",
        "peer copies of k, v and the coordinates in the sp gather",
        "shards and sharded-eval replicas running at the same time on their own cards",
        "DDP's gradient all-reduce across ranks and its overlap with the backward pass"]
    line["phase_s"] = time.perf_counter() - start
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        import pointdsc_tpu_torch as pt
        from pointdsc_tpu_torch import kernels
        from pointdsc_tpu_torch._device import full_f32_matmul
        from pointdsc_tpu_torch.data import SyntheticPairDataset
        from pointdsc_tpu_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 3
    dev = torch.device(DEVICE)
    # phases 3 to 13 are eval forwards: no autograd graph (training turns it on again)
    torch.set_grad_enabled(False)

    # 1. the card
    print(card_line(), flush=True)

    # 2. build
    print(f"build_s: {_build.build_all():.3f}", flush=True)

    # 3. kernels against their plain versions (full f32 matmuls, as in the
    # forward); these launches are not the main path's
    with full_f32_matmul():
        rows = check_kernels(torch, dev)
    print("kernels_vs_plain: ok", flush=True)

    # 4. the running-max path: load_pretrained + register, fused
    model = pt.load_pretrained(SNAPSHOT, device=DEVICE, offset_softmax=False)
    shifted = pt.load_pretrained(SNAPSHOT, device=DEVICE, offset_softmax=False)
    ds = SyntheticPairDataset(num_pairs=PAIRS + 1, num_corr=N, inlier_ratio=0.4, seed=0)
    pairs = [ds[i] for i in range(PAIRS + 1)]
    runs = [(model, p) for p in pairs[:PAIRS]] + [(shifted, pairs[PAIRS])]
    torch.cuda.synchronize()
    kernels.reset_launches()
    fused = []
    for i, (m, p) in enumerate(runs):
        if m is shifted:
            # raise the logits by the first pair's lower quartile, so that
            # NMS picks seeds by score (a share of the logits positive)
            with torch.no_grad():
                shifted.classification_2.bias.sub_(torch.quantile(fused[0].confidence, 0.25))
        fused.append(pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"], model=m,
                                 device=DEVICE))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"main_path_launches: {json.dumps(launches)}", flush=True)
    for i, ((m, p), out) in enumerate(zip(runs, fused)):
        tag = f"pair {i}" + (" (raised logits)" if m is shifted else "")
        ft = out.final_trans
        check(ft.shape == (1, 4, 4) and bool(torch.isfinite(ft).all()), f"{tag}: bad final_trans")
        check(out.final_labels.shape == (1, N), f"{tag}: bad final_labels")
        cp, src, tgt = (torch.as_tensor(p[k])[None].to(dev)
                        for k in ("corr_pos", "src_keypts", "tgt_keypts"))
        dense = m(cp, src, tgt, fused=False)
        terr = float((ft - dense.final_trans).abs().max())
        agree = float((out.final_labels == dense.final_labels).float().mean())
        # the dense path's f32 compat moves the logits by up to ~7e-3 from the
        # int8 cache's, which may flip the NMS flag or the rank of near-equal
        # neighbours (measured 0.982-0.994 on the CPU): sets, overlap >= 0.95;
        # seed_checks holds the seeds exactly to the run's own confidences
        overlap = len(set(out.seeds[0].tolist()) & set(dense.seeds[0].tolist())) / S
        print(f"{tag}: fused-vs-dense final_trans max err {terr:.3e}, label agreement "
              f"{agree:.4f}, seed set overlap {overlap:.4f}", flush=True)
        check(terr <= 1e-3 and agree > 0.99, f"{tag}: fused path disagrees with dense")
        check(overlap >= 0.95, f"{tag}: fused seeds disagree with the dense path's")
        seed_checks(torch, out, m, cp, src, tgt, tag)
    check(float((fused[PAIRS].confidence > 0).float().mean()) > 0.2,
          "the raised-logit pair has too few positive confidences")

    # 5. the golden files of the JAX package: its dense path, and its fused
    # running-max path with the attention fed as its wrapper feeds it on its
    # accelerator (bf16 q, k, v and p), the function this path runs here.
    # final_trans and labels against both; the seeds as sets, for the reason
    # of phase 4: >= 0.98 against the bf16-attention file, and >= 0.97
    # against the dense file. With all-negative logits the seeds are the
    # suppressed points in index order, and a near-tie of two neighbours'
    # confidences decides each: against the dense file JAX's own fused
    # running max reads 0.990-0.994 on these pairs with f32 attention and
    # 0.9766-0.9863 with bf16 (``python -m tests.test_torch_port_model
    # --seed-overlaps``), so the bf16 operands alone move up to ~2% of them.
    gold = np.load(GOLDEN)
    gold_bf16 = np.load(GOLDEN_BF16)
    for i, out in enumerate(fused[:PAIRS]):
        trans = out.final_trans[0].cpu().numpy()
        labels = out.final_labels[0].cpu().numpy() > 0.5
        seeds = set(out.seeds[0].cpu().tolist())
        for name, g, seed_floor in (("JAX dense", gold, 0.97),
                                    ("JAX bf16 attention", gold_bf16, 0.98)):
            terr = float(np.abs(trans - g["final_trans"][i]).max())
            agree = float((labels == g["final_labels"][i]).mean())
            seed_overlap = len(seeds & set(g["seeds"][i].tolist())) / len(seeds)
            print(f"pair {i}: vs {name} golden final_trans max err {terr:.3e}, label agreement "
                  f"{agree:.4f}, seed set overlap {seed_overlap:.4f}", flush=True)
            check(terr <= 1e-3 and agree > 0.99, f"pair {i}: disagrees with the {name} golden")
            check(seed_overlap >= seed_floor, f"pair {i}: seeds disagree with the {name} golden")

    # 6. every kernel of the running-max path ran on it, and no other
    missing = [name for name in RUNNING_MAX_KERNELS if launches[name] <= 0]
    check(not missing, f"kernels not launched on the running-max path: {missing}")
    stray = [name for name, count in launches.items()
             if count and name not in RUNNING_MAX_KERNELS]
    check(not stray, f"the running-max path launched {stray}")

    # 7. end-to-end time of the fused forward, one pair
    p = pairs[0]
    fwd_ms = time_ms(lambda: pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"],
                                         model=model, device=DEVICE), reps=10, warmup=2)
    dense_in = [torch.as_tensor(p[k])[None].to(dev) for k in ("corr_pos", "src_keypts",
                                                               "tgt_keypts")]
    dense_ms = time_ms(lambda: model(*dense_in, fused=False), reps=10, warmup=2)
    print(json.dumps({"metric": "fused_forward_ms_per_pair", "config": "running_max", "n": N,
                      "value": fwd_ms, "dense_forward_ms": dense_ms}), flush=True)

    # 8-11. the default configuration, half precision, the guard's flip
    launches.update(default_configuration(torch, pt, kernels, dev))
    lifted_limits(torch, pt, kernels, dev)
    real_seeds(torch, pt, kernels, dev)

    # 12-13. the training kernels and the no-cache eval attention against
    # their plain versions; the eval forward without a cache
    torch.set_grad_enabled(True)
    with full_f32_matmul():
        rows += check_train_kernels(torch, dev)
    print("train_kernels_vs_plain: ok", flush=True)
    launches["fused_sc_attention"] = no_cache_forward(torch, pt, kernels, dev)

    # 14-18. training
    launches.update(training(torch, pt, kernels, dev))

    # 19-23. the registration path: the nn-search and symmetric-cache kernels
    # against their plain versions, the demo, the Evaluator with ICP, the ICP
    # crossover, the symmetric-cache experiment
    torch.set_grad_enabled(False)
    with full_f32_matmul():
        rows += check_registration_kernels(torch, dev)
    print("registration_kernels_vs_plain: ok", flush=True)
    launches["nearest_neighbors"] = registration_demo(torch, kernels, dev)
    evaluator_with_icp(torch, pt, kernels, dev)
    icp_crossover(torch, dev)
    launches["compat_cache_int8_sym"] = symcache_experiment(kernels)

    # 24-26. the dataset CLIs on fake roots in the reference's layouts
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        dataset_eval_3dmatch(torch, kernels, dev, tmp, card)
        kitti_pairs = kitti_prep_and_eval(torch, kernels, dev, tmp, card)
        torch.set_grad_enabled(True)
        training_clis(torch, pt, kernels, dev, tmp, card, kitti_pairs)

        # 27. the classical baselines and the RANSAC solver
        torch.set_grad_enabled(False)
        baselines_3dmatch(torch, kernels, tmp, card)
        baselines_kitti(torch, kernels, tmp, card)
        ransac_solver(torch, pt, kernels, dev, tmp, card)

        # 28-29. RGB-D fusion and the multiway CLIs
        rgbd_root = rgbd_fusion(torch, kernels, dev, tmp, card)
        multiway_clis(torch, kernels, dev, tmp, card, rgbd_root)

        # 30-31. FCGF features through the 3DMatch CLI; FCGF training, OANet
        fcgf_3dmatch(torch, kernels, dev, tmp, card)
        fcgf_training_oanet(torch, dev, card)

        # 32-34. the multi-device layer on meshes that name the one card
        torch.set_grad_enabled(False)
        with full_f32_matmul():
            rows += check_rect_kernels(torch, dev)
        print("rect_kernels_vs_plain: ok", flush=True)
        launches.update(sp_forward(torch, pt, kernels, dev, card))
        multi_device(torch, pt, kernels, dev, tmp, card)

    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']} was launched no time on its main path")
        print(json.dumps({"name": row["name"], "launches": row["launches"], "ms": row["ms"]}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
