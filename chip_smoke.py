#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. build   one nvcc per kernel source of interpret_quality_tpu_torch
             (csrc/*.cu), all started together, into build/torch_kernels/.
  2. kernels each of the eleven kernels at the main path's shapes — the
             masked-coalition batch of one synthetic cloud (50 orders x 33
             rows = 1650 clouds of 1024 points) and each layer or level a
             forward gives it, with a seeded model's own weights — against
             its plain version, with times and bounds:
               knn, gather_extrema, knn_gather_extrema (DGCNN/GCNN, k=20):
                 kNN selections held to the plain version's up to near ties
                 at f32 noise, gathers bit-equal (gather_extrema on the
                 route its shape takes and on the row route forced);
               fps (1024 -> 512 -> 128): bit-equal, with the route each N
                 takes and the clouds the card holds at once;
               knn_with_density (PointConv SA1 k=32, SA2 k=64): selections
                 up to near ties, densities bit-equal where they agree;
               knn and knn_with_density also on both routes forced (xyz,
                 tiled), which must be bit-equal, and on two worst-case
                 clouds (every point one of 8 exact copies; all regions but
                 one on the centre), each route timed;
               fused_ball_mlp3 (the six PointNet++ MSG branches) and
                 fused_pointconv_sa (PointConv SA1/SA2): rtol 1e-4 /
                 atol 1e-5, a ball-query row excused only where a point lies
                 on the ball's boundary at f32 noise (both run layers 2-3 on
                 the tensor cores as three TF32 products, fused_pointconv_sa
                 its contraction too: their bound is that route's, the f32
                 cores' figure beside it, and the first chunk is also held
                 against the plain version on the emulated split); then one
                 PointConv forward of the whole batch, split by CUDA events
                 into its parts; the plain versions run
                 a chunk of clouds at a time (the whole batch would need
                 (B, S, K, C) tensors of up to 55 GB);
               gather_rows (GCNN layer 2's 64-wide input at its kNN indices):
                 bit-equal, beside one torch.gather call, the library's
                 version of the same function;
               dense_pool (DGCNN's head on its four edge outputs): rtol
                 1e-4 / atol 1e-5, a second launch bit-equal, beside
                 today's cuBLAS product and PyTorch tail (library_ms);
                 its listed route on layer 1's copy lists (listed_ms) the
                 same, its max bit-equal to every row's;
               knn_group_max (PCT's two sample-and-group levels, on the
                 seeded model's own inputs: the plan's kNN indices, the
                 hoisted rows u and the centres' share c): rtol 1e-4 /
                 atol 1e-5 of its plain version a chunk of clouds at a time
                 (the plain version writes a (B, S, 32, C) tensor), a
                 second launch bit-equal;
               group_res_mlp (PointMLP's four stages, on the seeded model's
                 own inputs: the plan's kNN and FPS indices, each cloud's
                 scale, the hoisted rows u, the centres' share c and the
                 folded residual blocks): within 1e-4 of the largest value
                 of its plain version a chunk of clouds at a time, a second
                 launch bit-equal, launches counted.
  3. model   full-width logits of all seven families through the kernels vs
             the same modules on the plain versions (PointNet, which has no
             kernel: card vs CPU), every BatchNorm randomised, on one
             order's batch (33 clouds).
  4. small   on a small input, card vs CPU: the Shapley engine, the
             interaction engine with a short last chunk, and one smoothness
             epoch of all regions.
  5. main    the CLIs a user runs (MAIN_PATH_CUTS lists the cuts of depth):
             save_fps; Shapley init for DGCNN, GCNN, PointNet++, PointConv,
             PointNet, PCT and PointMLP; trans enumeration on the plan path
             for DGCNN, PointNet++, PointConv, PCT and PointMLP; gen_pair ->
             interaction_logits ->
             cal_interactions for DGCNN and PointNet++; smoothness_enum
             (linearity, both objectives) for DGCNN; then the results
             stage, cli.result (sensitivity, correlation, smoothness) for
             DGCNN, PointNet++, PointConv, PCT and PointMLP on the tree they
             wrote.  Every kernel on the path must launch there (OFF_PATH
             names the one no path reaches), every artifact must be finite and of its
             shape, every family's per-order estimates must sum to
             v(N) - v(empty), every pair's v(whole cloud) - v(all-centre
             cloud) must equal the norm factor, the smoothness run must
             keep its bounds, never move a region against its objective,
             and give Shapley values that sum to v(N) - v(empty) of their
             own logits, and every number the tables print must be finite.
  6. real_data  fixture ModelNet10 and ShapeNet trees for the port's own
             sample lists and seeded GCNN / adv-GCNN .t7 checkpoints at the
             default paths (adv-GCNN's as model_best.t7 only): save_fps and
             Shapley init on the card through --data_root, without
             --synthetic or --allow_random_init.  The eval clouds must be
             the fixture's, adv-GCNN must take the model_best fallback, the
             artifacts must be finite and efficient.
  7. train  per family (DGCNN, GCNN, PointNet++, PointConv, PointNet):
             cli.train at full width for two short epochs (TRAIN_CUTS),
             then cli.shapley_value on its model_best.t7 by the default
             path without --allow_random_init (run.log finite, the .backup
             files written, the checkpoint loads strict=True, estimates
             efficient); ten train steps on one fixed batch of 32 clouds
             (losses finite, the last below the first; clouds/s over steps
             2-10, CUDA-synchronised); one train step card against CPU, the
             dropouts off (loss, logits, every gradient, every running
             statistic; STEP_* tolerances).  The kNN kernel must launch in
             the edge-conv family's train steps, FPS in PointNet++'s and
             PointConv's, no kernel that folds BatchNorm in any train step,
             and every kernel of the family in fit's eval passes.
  7b. precision  the JAX package's --matmul_precision / --gather_precision
             on the card (PRECISION_SETTINGS: high with exact gathers, and
             default with bf16 gathers, the JAX package's defaults; the
             port's own are highest and hilo): kernel 2's and kernel 8's bf16
             routes bit-equal to their plain versions on the rounded values
             at the kernel phase's shapes (kernel 2 on the route the shape
             takes and on the row route forced), kernels 5 and 7 at each
             one-pass setting against their emulation
             (ops/cuda/emulation.py, ONE_PASS_* tolerances), each timed with
             its route's bound; per family, synthetic cloud 0's Shapley
             values through the train phase's checkpoint (trained on for
             PRECISION_MORE_EPOCHS epochs where its values' RMS is below
             PRECISION_MIN_SHAPLEY_RMS) at each setting
             against the exact ones on the same orders, whose deviation
             must stay below the estimator's own standard error (its ratio
             printed), the engine's forwards/s at
             each setting, and every kernel and route of the setting
             launched there (the counts set to 0 just before each setting
             and read just after); one GCNN and one PointNet train step at
             default against highest (PRECISION_STEP_LOSS_REL and
             PRECISION_STEP_COS), and the same step with each fault of
             PRECISION_STEP_FAULTS planted in the precision product's
             backward, whose gradient must fall below that cosine.  The phase's
             record is emitted before any of its failures is raised.
  7c. selection  the JAX package's kNN selection settings on the card
             (IQTPU_KNN_SELECT, IQTPU_KNN_LAYOUT; the port's default is the
             exact class, the JAX package's packed) at the settings packed
             and bf16 (SELECTION_SETTINGS), one for each class other than
             exact (config.knn_select_class): kernels 1, 3 and 6 at the kernel
             phase's shapes at each class, both kNN routes forced bit-equal
             to each other and to the route the shape takes (kernels 1 and
             6), kernel 3 bit-equal to the gather of kernel 1's indices at
             the class, each equal to its plain version at the class on an
             exact-duplicate cloud and within selection_gap's row limit of
             it on the masked batch (derived from the class's width: see
             selection_width), a planted fault (the plain version's
             neighbours 2..k+1) beyond that limit, the
             share of rows that differ from the exact class, each timed
             with its bound; JAX's truncation example through kernels 1
             and 6 on both routes (TRUNCATION_ORDER); kernel 3 at
             IQTPU_KNN_LAYOUT=nq the packed class whatever the setting;
             per family of SELECTION_FAMILIES the Shapley values at each
             class against the exact ones through the precision phase's
             models (deviation over the estimator's standard error below
             1), the engine's forwards/s, and every kNN route of the class
             launched there (the counts set to 0 just before each class's
             runs and read just after); a DGCNN train step with
             IQTPU_KNN_SELECT=packed bit-equal to the step without it, no
             route of another class launched.  The variables are unset at
             the start of the script, so every other phase runs at the
             defaults.
  8. adversarial  cli.train_adv resumed from the train phase's GCNN .t7
             (ADV_CUTS), then cli.shapley_value --model gcnn_adv by the
             default path (the run's model_best.t7 stands in for
             model_399.t7): the run.log lines in the JAX package's formats,
             the .backup files, a strict load, efficient estimates, kNN and
             gather_extrema launched and no other kernel; ten adversarial
             steps on one fixed batch of 16 clouds (clean clouds/s over
             steps 2-10, each step split by CUDA events into the rotation
             attack, the translation attack and the train passes; 12 kNN
             launches a step); the attack on 4 clouds card against CPU
             (ATTACK_* tolerances, sign flips counted) with its invariants
             on the card (norms kept, |alpha| <= pi/2, |t| <= 1) and the
             losses before and after it.
  8b. adv_robustness  scripts/adv_robustness_torch.py at its defaults
             (1024 points, 16 clouds, 8 rotation draws) on the train
             phase's GCNN and the adversarial phase's adv-GCNN checkpoints:
             its JSON at --out, accuracies finite in [0, 1]; the same
             clean and rotated clouds on the CPU, whose predictions the
             card's must equal where the CPU's top two logits lie more
             than ROBUST_TOP2_REL apart (the excused rows counted); the
             card's rotated accuracy recomputed equal to the script's;
             kNN and gather_extrema launched.

Plots (matplotlib) and flax .msgpack checkpoints (msgpack) are held by the
CPU tests only (tests/test_torch_results.py, tests/test_torch_checkpoint.py):
this script imports neither, so it needs neither on the card's machine.
The port's rates are measured by the benchmark (iqbench/run.py); the
data-parallel step, the split over cards and --mesh_devices are held on the
card by tests/test_torch_cuda.py.

Every line on stdout is one JSON object.  The first ("device") carries the
card's name and power limit as nvidia-smi prints them; the "kernels" line
comes just before the last, which is {"ok": true, "device": {...}}; its
rows carry each kernel's launches on the main path and in the train,
adversarial and adv_robustness phases; the rows of the precision phase's routes
("gather_extrema:bf16", "fused_ball_mlp3:default", ...) follow, their
launches those of that phase's Shapley runs, then those of the selection
phase's classes ("knn:packed", "knn_gather_extrema:bf16", ...), their
launches those of the selection phase's Shapley runs.
The run uses one card: the first that CUDA_VISIBLE_DEVICES names, else card 0.
Artifacts go to build/chip_smoke/ in the checkout.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K = 20
N = 1024
R = 32
ORDERS = 50                       # orders per forward: 50 x 33 = 1650 clouds
CHUNK = 330                       # clouds per plain-version call
REL_LIMIT = 1e-5                  # kNN selected-distance gap, relative to |x|^2
F32_OPS_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12           # H100 SXM TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12           # H100 SXM bf16 on the tensor cores, dense
TF32_PASSES = 3                   # products of the split that keeps f32 accuracy
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3
FPS_NPOINTS = (512, 128)          # the two SA levels of PointNet++/PointConv
BALL_TOL = 1e-6                   # |d - r^2| of a ball-boundary point (f32 noise)
BALL_CHUNK = 66                   # clouds per plain fused_ball_mlp3 call
PCONV_CHUNK = 165                 # clouds per plain fused_pointconv_sa call
GROUP_CHUNK = 165                 # clouds per plain knn_group_max call
RES_CHUNK = 55                    # clouds per plain group_res_mlp call

# The main path: (stage, CLI, argv).  Depth is cut (MAIN_PATH_CUTS); every
# forward is full width: 1024 points, 32 regions, 50 orders = 1650 clouds.
INIT_ORDERS = {"dgcnn": 100, "gcnn": 50, "pointnet2": 100, "pointconv": 100,
               "pointnet": 100, "pct": 100, "pointmlp": 100}
ENUM_MODELS = ("dgcnn", "pointnet2", "pointconv", "pct", "pointmlp")
POSES = 4
INTERACTION_MODELS = ("dgcnn", "pointnet2")
INTER_PAIRS = 20
INTER_RATIOS = ("0", "0.1", "0.5", "1")
SMOOTH_EPOCHS = 2
SMOOTH_MIN_POINTS = 4   # fewer points: a variance that is 0 exactly, f32 noise here
RESULT_SAMPLES = "0,1"  # clouds of the enumerated families, read by cli.result
RESULT_MODES = ("sensitivity", "correlation", "smoothness")
TABLE_NUMBER = re.compile(r"[-+]?(?:\d+\.\d+|nan|inf)")
# The real_data phase: fixture trees of the two eval sets under the port's
# own sample lists, seeded .t7 checkpoints at the default paths (adv-GCNN's
# as model_best.t7 only), and save_fps -> Shapley init on the card.
REAL_ROWS = 2048                  # rows of a fixture cloud (the eval set takes 1024)
REAL_ORDERS = 50
REAL_MODELS = ("gcnn", "gcnn_adv")
MAIN_PATH_CUTS = ("one eval cloud of 30 (two for the families enumerated, "
                  "whose tables the results stage reads); Shapley init 100 "
                  "orders of 1000 "
                  "(GCNN 50); trans enumeration on the plan path: the first "
                  "4 poses of 216 at 100 orders; interactions (trans) on "
                  "those 4 poses: 20 random pairs of 300, ratios 0, 0.1, 0.5 "
                  "and 1 of 13; smoothness: linearity of 3 modes, 2 epochs "
                  "of 50 at 100 orders; random weights from a seed")
# The train phase: cli.train of every family at full width for two short
# epochs, each run's model_best.t7 read back by Shapley init; ten steps of
# each family on one fixed batch; one step card against CPU.
TRAIN_MODELS = ("dgcnn", "gcnn", "pointnet2", "pointconv", "pointnet")
TRAIN_EPOCHS, TRAIN_SAMPLES, TRAIN_TEST_SAMPLES = 2, 256, 64
TRAIN_BATCH, TRAIN_STEPS = 32, 10
TRAIN_ORDERS = 50
# the kernels of each family's eval forward (fit's eval pass), and those a
# train step launches: the index kernels only, never one that folds BN
FAMILY_KERNELS = {"dgcnn": ("knn_gather_extrema", "dense_pool"),
                  "gcnn": ("knn", "gather_extrema", "dense_pool"),
                  "pointnet2": ("fps", "fused_ball_mlp3"),
                  "pointconv": ("fps", "knn_with_density", "fused_pointconv_sa"),
                  "pointnet": ()}
TRAIN_STEP_KERNELS = {"dgcnn": ("knn",), "gcnn": ("knn",),
                      "pointnet2": ("fps",), "pointconv": ("fps",),
                      "pointnet": ()}
# One train step card against CPU: STEP_BATCH synthetic clouds on a 1/64
# grid (every xyz distance exact in f32, so FPS, kNN and ball queries agree
# exactly; a squared distance, a multiple of 2^-12, lies at least 9.7e-6
# from every radius^2 of PointNet++); DGCNN at STEP_DGCNN_POINTS points, on
# the first seed whose feature-space selections keep every k-th and
# (k+1)-th distance at least STEP_TIE_MARGIN apart (relative to the cloud's
# largest |x|^2), where two f32 arithmetic orders cannot swap a neighbour.
STEP_BATCH, STEP_VALID, STEP_DGCNN_POINTS, STEP_TIE_MARGIN = 8, 7, 128, 1e-6
# f32 on both sides, sums in other orders, amplified by train-mode
# BatchNorm over a batch of 8 (on the CPU, f32 against f64 of the same
# step: loss and logits 2e-5 apart, gradients up to 1.7e-2 of their norm,
# running statistics up to 2.3e-4 of their largest value; on the card
# against the CPU: 2.6e-5, 6.3e-3 and 3.1e-6; at a batch of 4 PointNet's
# logits moved 3e-4 apart): loss and logits
# within rtol/atol STEP_LOGIT_TOL; each gradient within STEP_GRAD_REL of its
# norm plus STEP_GRAD_FLOOR of the largest gradient norm (the gradient of a
# bias that feeds a BatchNorm is 0 up to rounding); each running statistic
# within STEP_STAT_TOL of its buffer's largest value.
STEP_LOGIT_TOL = 2e-4
STEP_GRAD_REL, STEP_GRAD_FLOOR = 2e-2, 1e-3
STEP_STAT_TOL = 1e-4
TRAIN_CUTS = ("two epochs of the family's 200-400 (the schedules run over "
              "two) on 256 synthetic training clouds and 64 test clouds, at "
              "1024 points and full width; "
              "Shapley init on the trained model at 50 orders of 1000, one "
              "cloud; random initial weights from a seed")
# The adversarial phase: cli.train_adv resumed from the train phase's GCNN
# .t7 on its 64 synthetic clouds, Shapley init on the adv model by its
# default path; ADV_STEPS adversarial steps on one fixed batch; the attack
# card against CPU on ATTACK_CLOUDS clouds.  Its train steps and attacks
# launch kNN (the un-fused GCNN graph), its eval passes gather_extrema and
# dense_pool too.
ADV_EPOCHS, ADV_BATCH, ADV_ORDERS, ADV_STEPS = 2, 16, 50, 10
ADV_KERNELS = ("knn", "gather_extrema", "dense_pool")
ATTACK_CLOUDS = 4
# The attack card against CPU, both f32 through the same seeded GCNN: the
# first step's (g_alpha, g_theta, g_phi) within ATTACK_GRAD_REL of the
# CPU's norm; on the clouds whose g_alpha sign sequences match, the final
# (theta, phi), the rotated and the translated clouds within ATTACK_*_TOL:
# ten times the CPU's own f32 run's distance from its f64 run on these
# clouds, which check_attack reports as "cpu_f32_vs_f64" (7.0e-6, 3.8e-4,
# 7.7e-5 and 8.2e-3; the translation's direction g/|g| is the least well
# conditioned); at most ATTACK_MAX_FLIPS clouds may flip a sign (a whole
# step of pi/10).
ATTACK_GRAD_REL, ATTACK_MAX_FLIPS = 7e-5, 1
ATTACK_ANGLE_TOL, ATTACK_ROT_TOL, ATTACK_TRANS_TOL = 4e-3, 8e-4, 9e-2
ADV_CUTS = ("cli.train_adv: 2 epochs of 400 on the 64 synthetic training "
            "clouds (16 test clouds) at 1024 points, batch 16; Shapley init "
            "on its model_best.t7 at 50 orders of 1000, one cloud; weights "
            "resumed from the train phase's 2-epoch GCNN")
# The adv_robustness phase: scripts/adv_robustness_torch.py at its defaults
# (1024 points, 16 clouds, 8 rotation draws) on the train phase's GCNN and
# the adversarial phase's adv-GCNN; the same clouds on the CPU, whose
# predictions the card's must equal wherever the CPU logits' top two lie
# more than ROBUST_TOP2_REL of the row's largest |logit| apart.
ROBUST_TOP2_REL = 1e-3
ROBUST_CUTS = ("checkpoints of the train phase's 2-epoch GCNN and the "
               "adversarial phase's 2-epoch adv-GCNN, not trained models")
# The precision phase: the JAX package's default numerics on the card
# (--matmul_precision default with --gather_precision bf16) and
# --matmul_precision high, each against the port's exact settings (highest,
# hilo): the routes of those settings at the main path's shapes, every
# family's Shapley values on synthetic cloud 0 at PRECISION_ORDERS orders,
# and one train step at default.
PRECISION_SETTINGS = (("high", 2), ("default", 1))   # (matmul, value parts)
PRECISION_FAMILIES = ("dgcnn", "gcnn", "pointnet2", "pointconv", "pointnet")
PRECISION_ORDERS = 100
# The Shapley values are compared through the train phase's checkpoints
# (TRAIN_EPOCHS epochs on TRAIN_SAMPLES synthetic clouds), which respond to
# the coalition where seeded weights hardly do.  A checkpoint whose exact
# Shapley values have an RMS below PRECISION_MIN_SHAPLEY_RMS is trained on
# for PRECISION_MORE_EPOCHS epochs first: its values would lie below the
# rounding of a one-pass reward (about 2e-3 a region and order at default,
# PERF.md section 6), and no setting could be held to them.  The 2-epoch
# PointNet++ and PointConv hold about 1e-3, the other families 2.5e-2 and
# more.
PRECISION_MIN_SHAPLEY_RMS = 1e-2
PRECISION_MORE_EPOCHS = 8
# Kernels 5 and 7 at a one-pass setting against their emulation: f32 sums
# run in another order, so an activation at a rounding boundary of the
# one-pass operand can round the other way on one side (a bf16 ulp is 2^-8
# of the value), which moves an output as much as the rounding of one of
# its C inputs moves it.  The setting's own rounding moves every output by
# about sqrt(C) such steps (emulation against the exact f32 layers), so
# the kernel's gap to its emulation must stay a small share of that: RMS at
# most ONE_PASS_RMS_SHARE, the largest at most ONE_PASS_MAX_SHARE.  Three
# products, or another rounding, would come out near 1.
ONE_PASS_RMS_SHARE, ONE_PASS_MAX_SHARE = 0.1, 0.5
# One train step at default against highest through those checkpoints (bf16
# operands keep 2^-9 of each value; BatchNorm on a batch of 8): the loss
# within PRECISION_STEP_LOSS_REL of the exact step's.  The gradient is
# compared as a direction, its cosine with the exact one at least
# PRECISION_STEP_COS: upstream of a max (over the k neighbours, over the
# points) a value moved by rounding can hand the max to another row, and
# the gradient then flows to that row's parameters, so no tensor-by-tensor
# bound holds there (relative gaps are reported).  The limit is read off
# faults planted in the precision product's backward
# (``ops.precision.PrecisionMatmul``), each run once a phase at default:
# every fault of PRECISION_STEP_FAULTS must fall below it.  Measured on the
# H100 (PERF.md section 6): the right step 0.9918 and 0.9994, the faults
# 0.06-0.65; the limit sits midway in 1 - cosine between the two.
PRECISION_STEP_MODELS = ("gcnn", "pointnet")
PRECISION_STEP_LOSS_REL, PRECISION_STEP_COS = 1e-2, 0.95
PRECISION_STEP_FAULTS = ("no_input_grad", "no_weight_grad",
                         "weight_grad_half_rows")
# The selection phase: the JAX package's kNN selection settings
# (IQTPU_KNN_SELECT, IQTPU_KNN_LAYOUT) on the card, at one setting of each
# of their two classes other than exact (config.knn_select_class; the
# kernel phase checks the exact class): kernels 1, 3 and 6 at the main
# path's shapes, the JAX package's truncation example, the nq layout, the
# Shapley values of the families whose kernels select neighbours through
# the precision phase's models, and a DGCNN train step with the variable
# set.  SELECTION_ENV is unset for the whole script (IQTPU_ENUM_PLAN too:
# the main path runs the plan path).
SELECTION_SETTINGS = ("packed", "bf16")
SELECTION_FAMILIES = ("dgcnn", "gcnn", "pointconv")
SELECTION_ORDERS = PRECISION_ORDERS
SELECTION_ENV = ("IQTPU_KNN_SELECT", "IQTPU_KNN_LAYOUT", "IQTPU_ENUM_PLAN")
# operations a key adds to a distance (packed: clamp, mask; bf16: round,
# widen), counted in the bound of a class's route
SELECTION_KEY_OPS = 2
# JAX's truncation example (tests/test_knn_select.py:69-84): database points
# on the x axis, queried from the origin; the two first ones lie one ulp
# apart in distance, and only the exact class tells them apart
TRUNCATION_X = (float(np.nextafter(np.float32(5.0), np.float32(6.0))), 5.0,
                1.0, 2.0, 7.0, 8.0, 9.0, 10.0)
TRUNCATION_ORDER = {"exact": [2, 3, 1, 0], "packed": [2, 3, 0, 1],
                    "bf16": [2, 3, 0, 1]}
# Kernels that no entry point reaches, so the main path cannot launch them:
# they are held in the kernel phase alone.
# the kernels-line source and TPU kernel of the precision and selection
# phases' routes
ROUTE_SOURCES = {"gather_extrema": ("neighbors", "neighbors.py:424"),
                 "gather_rows": ("groups", "groups.py:171"),
                 "fused_ball_mlp3": ("groups", "groups.py:250"),
                 "fused_pointconv_sa": ("groups", "groups.py:469"),
                 "knn": ("neighbors", "neighbors.py:482"),
                 "knn_gather_extrema": ("neighbors", "neighbors.py:353"),
                 "knn_with_density": ("groups", "groups.py:337")}
OFF_PATH = {"gather_rows": "no entry point of the JAX package calls "
                           "gather_rows (only its kernel test does), so none "
                           "of the port's does"}
# Kernels that replace no TPU kernel, and why each was added
NO_TPU_KERNEL = {"dense_pool": "the JAX package leaves DGCNN's head to XLA, "
                               "which fuses it on the TPU; on the card the "
                               "head was a cuBLAS f32 product and six "
                               "PyTorch passes over a (B, N, 1024) "
                               "activation, 45% of a DGCNN forward",
                 "knn_group_max": "the JAX package has no PCT; in plain "
                                  "PyTorch each of its sample-and-group "
                                  "levels writes (B, S, 32, C) gathered rows "
                                  "and their product, 13.8 GB each a forward "
                                  "of 1650 clouds",
                 "group_res_mlp": "the JAX package has no PointMLP; in plain "
                                  "PyTorch each of its stages writes several "
                                  "(B, S, 24, C) tensors, 10.4 GB each a "
                                  "forward of 1650 clouds"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() in ms over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunks(B: int, size: int = CHUNK):
    for s in range(0, B, size):
        yield slice(s, min(B, s + size))


def bound_ms(nbytes: float, ops: float, matrix_ops: float = 0.0,
             tf32_ops: float = 0.0, bf16_ops: float = 0.0):
    """The least time for the work, and what sets it: bytes over the memory
    rate, f32 operations over the CUDA cores' rate, or the tensor cores'
    work at the rate of its operands' type: ``matrix_ops`` (those a kernel
    runs as a three-product TF32 split) times three and ``tf32_ops`` (one
    product of TF32 operands, the ``high`` setting) over the TF32 rate,
    ``bf16_ops`` (one product of bf16-rounded operands, the ``default``
    setting) over the bf16 rate; the largest of the three."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_mma = ((matrix_ops * TF32_PASSES + tf32_ops) / TF32_OPS_PER_S
             + bf16_ops / BF16_OPS_PER_S)
    t_ops = max(ops / F32_OPS_PER_S, t_mma) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def one_pass_ops(setting: str, ops: float) -> dict:
    """``bound_ms``'s keyword for one tensor-core pass at a matmul
    precision: TF32 operands at ``high``, bf16-rounded ones at ``default``."""
    return {"high": {"tf32_ops": ops}, "default": {"bf16_ops": ops}}[setting]


# ------------------------------------------------------------------ inputs
def coalition_batch(device):
    """The masked-coalition batch of synthetic cloud 0: (1650, 1024, 3)."""
    import torch
    from interpret_quality_tpu_torch.attrib.coalitions import (
        keep_matrix_from_orders, masked_coalitions)
    from interpret_quality_tpu_torch.attrib.shapley import (
        generate_all_orders, region_id_from_fps)
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.ops.geometry import farthest_point_sample
    data, _ = SyntheticClouds(30, N, 10, seed=1)[0]
    x = torch.from_numpy(data).to(device)
    fps = farthest_point_sample(x[None], R)[0]
    region_id = region_id_from_fps(x, fps).long()
    orders = generate_all_orders(ORDERS, R, rng=np.random.RandomState(1))
    keep = torch.from_numpy(keep_matrix_from_orders(orders)).to(device)
    return masked_coalitions(x, x.mean(0), keep, region_id).contiguous()


def seeded_model(name, device, seed=0):
    """A full-width model with weights from a seed and every BatchNorm
    randomised: statistics, and scales of both signs."""
    import torch
    from interpret_quality_tpu_torch.models import build_model
    torch.manual_seed(seed)
    model = build_model(name, 10, K)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.weight.uniform_(0.5, 1.5).mul_(
                    torch.where(torch.rand_like(bn.weight) < 0.5, -1.0, 1.0))
                bn.bias.normal_(0, 0.1)
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.5)
        if name == "pointconv":
            # a negative scale on DensityNet's last BatchNorm ReLUs the
            # density scale to 0 for every neighbour, and with it most of
            # the SA output that kernel 7 is held on: keep it positive
            for sa in (model.sa1, model.sa2, model.sa3):
                sa.densitynet.mlp_bns[-1].weight.abs_()
                sa.densitynet.mlp_bns[-1].bias.abs_()
    return model.to(device).eval()


def layer_inputs(masked, device):
    """(xs, a) of each edge conv at the main path's shapes: DGCNN's four
    layers on the masked batch (graph from features) and GCNN's four layers
    (fixed xyz graph)."""
    import torch
    from interpret_quality_tpu_torch.models.dgcnn import edge_conv
    from interpret_quality_tpu_torch.ops.cuda.neighbors import knn
    out = {}
    with torch.inference_mode():
        for name in ("dgcnn", "gcnn"):
            model = seeded_model(name, device)
            idx = knn(masked, masked, K) if name == "gcnn" else None
            h, layers = masked, []
            for block in (model.conv1, model.conv2, model.conv3, model.conv4):
                C = h.shape[-1]
                w = block[0].weight.reshape(block[0].weight.shape[0], 2 * C)
                layers.append((h, torch.matmul(h, w[:, :C].T).contiguous()))
                h = edge_conv(h, block, K, idx=idx)
            out[name] = (layers, idx)
    return out


# ----------------------------------------------------------------- kernels
def distinct_row_count(x) -> int:
    """Rows of x (B, N, C) that are no bit-for-bit copy of an earlier row of
    their cloud, summed over the clouds: the queries the selection kernels
    have to run (a copy takes its original's result).  Counted through a
    64-bit hash of each row's bits."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(1)
    mult = (torch.randint(1, 2 ** 62, (x.shape[-1],), generator=g) * 2 + 1).to(
        x.device)
    h = (x.contiguous().view(torch.int32).long() * mult).sum(-1)      # (B, N)
    h = h.sort(-1).values
    return int(x.shape[0] + (h[:, 1:] != h[:, :-1]).sum())


def selection_gap(query, db, idx_k, idx_p, width: float = 0.0):
    """Compare two kNN selections of the same queries (B, S, C) among the
    same database rows (B, N, C), made at a selection class of ``width``
    (selection_width; 0 at exact).

    Returns (rows whose index lists differ, rows whose index sets differ,
    max abs and max relative gap between the two selections' distances,
    the largest gap over its row's limit).  The distances of each
    differing row are recomputed exactly (f64) and sorted; the relative gap
    is taken against the cloud's largest |x|^2, the scale of the f32
    rounding error of |q|^2 - 2 q.d + |d|^2.  A row's limit is
    2 * width * d_k + REL_LIMIT * |x|^2 (d_k: the row's largest selected
    distance on either side; selection_width says why): a gap over it
    above 1 means a selection the class does not explain.  Rows that agree
    have a gap of 0."""
    import torch
    differ = (idx_k != idx_p).any(-1)                            # (B, S)
    sets_differ = (idx_k.sort(-1).values != idx_p.sort(-1).values).any(-1)
    scale = torch.maximum((db.double() ** 2).sum(-1).amax(-1),
                          (query.double() ** 2).sum(-1).amax(-1))   # (B,)
    bs, qs = differ.nonzero(as_tuple=True)
    max_abs = max_rel = over = 0.0
    for s in range(0, bs.numel(), 1 << 16):
        b, q = bs[s:s + (1 << 16)], qs[s:s + (1 << 16)]
        xq = query[b, q].double()                                # (M, C)

        def sel_dist(ix):
            xn = db[b[:, None], ix[b, q].long()].double()        # (M, k, C)
            return torch.sort(((xn - xq[:, None]) ** 2).sum(-1), -1).values
        dk, dp = sel_dist(idx_k), sel_dist(idx_p)
        gap = (dk - dp).abs()
        limit = (2 * width * torch.maximum(dk[:, -1], dp[:, -1])
                 + REL_LIMIT * scale[b])                         # (M,)
        max_abs = max(max_abs, float(gap.max()))
        max_rel = max(max_rel, float((gap / scale[b, None]).max()))
        over = max(over, float((gap.amax(-1) / limit).max()))
    return differ, sets_differ, max_abs, max_rel, over


def selection_width(cls: str, n: int) -> float:
    """The width of the kNN selection class ``cls`` over n database rows:
    how far apart, relative to the larger, two distances whose keys compare
    one way may lie in the other order.

    A class is an exact (key, index) selection on keys made from the f32
    distances, so a kernel and its plain version (an fmaf chain against a
    cuBLAS product) part only where their distances give other keys.
    Where the kernel selects a candidate A and the plain version a
    candidate B in its place, A's key is at most B's on one side and B's
    at most A's on the other.  Packed clears the low b = bit_length(n - 1)
    bits of a distance's pattern, so its key lies less than 2^b ulps, a
    share 2^(b - 23) (1.2e-4 at n = 1024), below it: A lies at most that
    share of itself above B.  bf16 rounds to 8 significant bits, to
    nearest, so its key lies within 2^-8 of it either way: A and B lie
    within 2^-7 of the larger.  So A and B lie within one width of the
    row's largest selected distance d_k, plus the f32 noise of the two
    sides' distances, REL_LIMIT of the cloud's largest |x|^2 (the exact
    class's limit, width 0); sorted, the two selections' distances differ
    position by position by no more.  selection_gap's row limit takes two
    widths, so that only a selection the class does not explain passes
    it: dropping the nearest neighbour moves the first sorted distance by
    d_2, far beyond (selection_fault)."""
    if cls == "exact":
        return 0.0
    return {"packed": 2.0 ** ((n - 1).bit_length() - 23),
            "bf16": 2.0 ** -7}[cls]


def selection_fault(query, db, k: int, cls: str) -> float:
    """selection_gap's gap over the row limit of a planted fault, on the
    first chunk: knn_plain's neighbours 2..k+1 at the class (the nearest
    dropped, the list shifted by one) against its neighbours 1..k.  The
    check's limit must catch it: its callers fail where this is not above
    1."""
    from interpret_quality_tpu_torch.ops.cuda.neighbors import knn_plain
    sl = slice(0, min(CHUNK, query.shape[0]))
    idx = knn_plain(query[sl], db[sl], k + 1, cls)
    return selection_gap(query[sl], db[sl], idx[..., 1:], idx[..., :-1],
                         selection_width(cls, db.shape[1]))[4]


def check_gap_limit(what: str, over: float, fault: float) -> None:
    """Fail where a kernel's selections lie beyond selection_gap's row
    limit (over > 1) or the planted fault within it (fault <= 1)."""
    if over > 1.0:
        raise AssertionError(f"{what}: selected distances differ from the "
                             f"plain version's by {over} of the row limit")
    if not fault > 1.0:
        raise AssertionError(f"{what}: a planted fault (neighbours 2..k+1) "
                             f"stays within the row limit ({fault})")


def duplicate_cloud(B: int, n: int, c: int, seed: int, device):
    """B clouds of n rows of c channels, each row one of 8 exact copies."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, n // 8, c, generator=g).repeat(1, 8, 1)
    return x.contiguous().to(device)


def selection_rows(query, db, idx, plain_fn, exact, cls):
    """Kernel indices ``idx`` against ``plain_fn(sl)`` chunk by chunk:
    every row within selection_gap's row limit at the class, a planted
    fault beyond it (check_gap_limit), and the rows that differ from the
    plain version and from the exact kernel's ``exact``.  Returns (max abs
    gap, max rel gap, largest gap over the row limit, the fault's, share of
    rows differing from the plain version, share differing from exact, the
    rows that equal the plain version's, per chunk)."""
    import torch
    width = selection_width(cls, db.shape[1])
    max_abs = max_rel = over = 0.0
    plain_rows = exact_rows = rows = 0
    same = []
    for sl in chunks(query.shape[0]):
        differ, _, g_abs, g_rel, g_over = selection_gap(
            query[sl], db[sl], idx[sl], plain_fn(sl), width)
        max_abs, max_rel = max(max_abs, g_abs), max(max_rel, g_rel)
        over = max(over, g_over)
        plain_rows += int(differ.sum())
        exact_rows += int((idx[sl] != exact[sl]).any(-1).sum())
        rows += differ.numel()
        same.append(~differ)
    fault = selection_fault(query, db, idx.shape[-1], cls)
    check_gap_limit(f"k={idx.shape[-1]} at {cls}", over, fault)
    torch.cuda.synchronize()
    return (max_abs, max_rel, over, fault, plain_rows / rows,
            exact_rows / rows, same)


def key_ops(cls: str) -> int:
    """Operations a kNN selection class's key adds to a distance."""
    return 0 if cls == "exact" else SELECTION_KEY_OPS


def row_name(kernel: str, cls: str) -> str:
    """A kernel's name on the kernels line at a kNN selection class."""
    return kernel if cls == "exact" else f"{kernel}:{cls}"


def route_outputs(run, what):
    """run(route) on both kNN routes forced (xyz, tiled): their outputs
    must be bit-equal.  Returns the xyz route's."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda.neighbors import KNN_ROUTES
    xyz, tiled = (run(KNN_ROUTES[name]) for name in ("xyz", "tiled"))
    if not all(torch.equal(a, b) for a, b in zip(xyz, tiled)):
        raise AssertionError(f"{what}: the xyz and tiled routes differ")
    return xyz


def route_times(run):
    """ms of run(route) on each kNN route forced."""
    from interpret_quality_tpu_torch.ops.cuda.neighbors import KNN_ROUTES
    return {name: cuda_ms(lambda: run(KNN_ROUTES[name]))
            for name in ("xyz", "tiled")}


def check_knn(nb, masked, device, select="two_pass"):
    """Kernel 1 at GCNN's graph at the selection setting ``select``: the
    route the shape takes (the main path's) and both routes forced,
    bit-equal to each other, so the selection gap against knn_plain at the
    setting's class (within selection_gap's row limit: REL_LIMIT at exact)
    holds for each; on an exact-duplicate cloud each route equals
    knn_plain.  At another class than exact, also the share of rows whose
    indices differ from the exact class's."""
    import torch
    from interpret_quality_tpu_torch.config import knn_select_class
    cls = knn_select_class(select)
    dup = duplicate_cloud(33, N, 3, 0, device)             # exact ties
    want = nb.knn_plain(dup, dup, K, cls)
    for name, route in nb.KNN_ROUTES.items():
        if not torch.equal(nb._knn(dup, dup, K, route, cls), want):
            raise AssertionError(f"knn ({name} route) at {cls}: indices "
                                 "differ from knn_plain on an "
                                 "exact-duplicate cloud")
    idx = nb.knn(masked, masked, K, select=select)
    if not torch.equal(route_outputs(
            lambda r: (nb._knn(masked, masked, K, r, cls),), "knn")[0], idx):
        raise AssertionError(f"knn at {cls}: the route the shape takes "
                             "differs from the same route forced")
    exact = idx if cls == "exact" else nb.knn(masked, masked, K,
                                              select="two_pass")
    max_abs, max_rel, over, fault, differ_share, exact_share, _ = \
        selection_rows(masked, masked, idx,
                       lambda sl: nb.knn_plain(masked[sl], masked[sl], K, cls),
                       exact, cls)
    t_k = cuda_ms(lambda: nb.knn(masked, masked, K, select=select))
    t_p = cuda_ms(lambda: [nb.knn_plain(masked[sl], masked[sl], K, cls)
                           for sl in chunks(masked.shape[0])], reps=1)
    B, C = masked.shape[0], masked.shape[2]
    queries = distinct_row_count(masked)
    bound, by = bound_ms(B * N * C * 4 * 2 + B * N * K * 4,
                         queries * N * (2 * C + 3 + key_ops(cls)))
    detail = {"kernel": row_name("knn", cls), "B": B, "N": N, "C": C, "k": K,
              "route": nb.knn_route(N, C, K), "ms": t_k, "plain_ms": t_p,
              "bound_ms": bound,
              "route_ms": route_times(lambda r: nb._knn(masked, masked, K, r,
                                                        cls)),
              "routes_bit_equal": True,
              "distinct_query_rows": queries / (B * N),
              "identical_index_rows": 1 - differ_share,
              "max_rel_selected_dist_err": max_rel,
              "width": selection_width(cls, N), "gap_over_limit": over,
              "fault_gap_over_limit": fault,
              "duplicate_cloud_indices_equal": True}
    if cls != "exact":
        detail["rows_differing_from_two_pass"] = exact_share
    return idx, dict(max_abs_err=max_abs, ms=t_k, plain_ms=t_p,
                     bound_ms=bound, bound_by=by,
                     main_path_route=detail["route"]["route"]), [detail]


def check_gather(nb, layers, idx):
    """Kernel 2 at each GCNN layer: the route its shape takes (the slice
    route at these shapes) and the row route forced, each bit-equal to the
    plain version on every chunk.  The bound counts device-memory bytes
    (``a`` and the indices read once, both outputs written once); beside it
    stand the L2 bytes the row route moves (every row read k times)."""
    import torch
    ms = plain = 0.0
    ops = nbytes = 0.0
    max_abs, details = 0.0, []
    for _, a in layers:
        B, F = a.shape[0], a.shape[2]
        outs = {route: nb._gather_extrema(idx, a, nb.ROUTES[route])
                for route in ("shape", "rows")}
        torch.cuda.synchronize()
        for sl in chunks(B):
            pmax, pmin = nb.gather_extrema_plain(idx[sl], a[sl])
            for route, (kmax, kmin) in outs.items():
                if not (torch.equal(kmax[sl], pmax) and torch.equal(kmin[sl], pmin)):
                    raise AssertionError(f"gather_extrema ({route} route) at "
                                         f"F={F}: kernel differs from its "
                                         "plain version")
                max_abs = max(max_abs, float((kmax[sl] - pmax).abs().max()),
                              float((kmin[sl] - pmin).abs().max()))
        del outs
        t_k = cuda_ms(lambda: nb.gather_extrema(idx, a))
        t_rows = cuda_ms(lambda: nb._gather_extrema(idx, a, nb.ROUTES["rows"]))
        t_p = cuda_ms(lambda: [nb.gather_extrema_plain(idx[sl], a[sl])
                               for sl in chunks(B)], reps=1)
        b_ = B * N * K * 4 + B * N * F * 4 + 2 * B * N * F * 4
        o_ = 2 * B * N * K * F
        details.append({"kernel": "gather_extrema", "B": B, "N": N, "F": F,
                        "k": K, **nb.gather_extrema_route(N, F, K),
                        "bit_equal_both_routes": True, "ms": t_k,
                        "rows_route_ms": t_rows, "plain_ms": t_p,
                        "bound_ms": bound_ms(b_, o_)[0],
                        "rows_route_l2_gather_gb": B * N * K * F * 4 / 1e9})
        ms, plain, nbytes, ops = ms + t_k, plain + t_p, nbytes + b_, ops + o_
    bound, by = bound_ms(nbytes, ops)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by), details


def check_fused(nb, layers, select="two_pass"):
    """Kernel 3 at each DGCNN layer at the selection setting ``select``
    (its class ``cls``), every chunk of the batch:
      1. bit-equal to the plain gather of kernel 1's indices at the class
         (one selection function serves both kernels);
      2. kernel 1's indices against knn_plain's at the class: every row
         within selection_gap's row limit, and a planted fault beyond it
         (check_gap_limit);
      3. against knn_gather_extrema_plain at the class: a row may differ
         only where the two neighbour sets differ, which 2 shows to be near
         ties; the largest such difference is kernel 3's max_abs_err;
      4. on an exact-duplicate 64-wide cloud equal to
         knn_gather_extrema_plain.
    At another class than exact, also the share of rows whose indices
    differ from the exact class's."""
    import torch
    from interpret_quality_tpu_torch.config import knn_select_class
    cls = knn_select_class(select)
    device = layers[0][0].device
    dup = duplicate_cloud(33, N, 64, 1, device)
    a_dup = torch.randn(33, N, 64, device=device)
    for got, want in zip(nb.knn_gather_extrema(dup, a_dup, K, select=select),
                         nb.knn_gather_extrema_plain(dup, a_dup, K, 2, cls)):
        if not torch.equal(got, want):
            raise AssertionError(f"knn_gather_extrema at {cls}: differs from "
                                 "its plain version on an exact-duplicate "
                                 "cloud")
    del dup, a_dup
    ms = plain = 0.0
    ops = all_ops = nbytes = 0.0
    max_abs, details = 0.0, []
    for xs, a in layers:
        kmax, kmin = nb.knn_gather_extrema(xs, a, K, select=select)
        # the same selection function
        idx = nb.knn(xs, xs, K, select=select)
        exact = idx if cls == "exact" else nb.knn(xs, xs, K, select="two_pass")
        torch.cuda.synchronize()
        out_rows = set_rows = exact_rows = rows = 0
        layer_abs = layer_rel = layer_over = 0.0
        width = selection_width(cls, N)
        for sl in chunks(a.shape[0]):
            pmax, pmin = nb.gather_extrema_plain(idx[sl], a[sl])
            if not (torch.equal(kmax[sl], pmax) and torch.equal(kmin[sl], pmin)):
                raise AssertionError(f"knn_gather_extrema at {cls}: kernel "
                                     "differs from the gather of the knn "
                                     "kernel's indices")
            pidx = nb.knn_plain(xs[sl], xs[sl], K, cls)
            _, sets_differ, _, gap_rel, gap_over = selection_gap(
                xs[sl], xs[sl], idx[sl], pidx, width)
            layer_rel, layer_over = max(layer_rel, gap_rel), max(layer_over,
                                                                 gap_over)
            qmax, qmin = nb.knn_gather_extrema_plain(xs[sl], a[sl], K, 2, cls)
            out_differ = ((qmax != kmax[sl]).any(-1) |
                          (qmin != kmin[sl]).any(-1))
            if bool((out_differ & ~sets_differ).any()):
                raise AssertionError(f"knn_gather_extrema at {cls}: rows "
                                     "differ from the all-plain version where "
                                     "both select the same neighbours")
            out_rows += int(out_differ.sum())
            set_rows += int(sets_differ.sum())
            exact_rows += int((idx[sl] != exact[sl]).any(-1).sum())
            rows += out_differ.numel()
            layer_abs = max(layer_abs, float((qmax - kmax[sl]).abs().max()),
                            float((qmin - kmin[sl]).abs().max()))
        del idx, exact
        C = xs.shape[2]
        fault = selection_fault(xs, xs, K, cls)
        check_gap_limit(f"knn at C={C} at {cls}", layer_over, fault)
        max_abs = max(max_abs, layer_abs)
        t_k = cuda_ms(lambda: nb.knn_gather_extrema(xs, a, K, select=select))
        t_p = cuda_ms(lambda: [nb.knn_gather_extrema_plain(
            xs[sl], a[sl], K, 2, cls) for sl in chunks(a.shape[0])],
            reps=1)
        B, F = xs.shape[0], a.shape[2]
        b_ = B * N * C * 4 + B * N * F * 4 + 2 * B * N * F * 4
        # the work the data needs: a row that is a bit-for-bit copy of an
        # earlier row of its cloud takes that row's result
        queries = distinct_row_count(xs)
        per_row = N * (2 * C + 3 + key_ops(cls)) + 2 * K * F
        o_, every_ = queries * per_row, B * N * per_row
        detail = {"kernel": row_name("knn_gather_extrema", cls), "B": B,
                  "N": N, "C": C, "F": F, "k": K, "ms": t_k, "plain_ms": t_p,
                  "distinct_query_rows": queries / (B * N),
                  "bound_ms": bound_ms(b_, o_)[0],
                  "bound_f32_cores_ms": bound_ms(b_, every_)[0],
                  "knn_max_rel_selected_dist_err": layer_rel,
                  "width": width, "gap_over_limit": layer_over,
                  "fault_gap_over_limit": fault,
                  "rows_with_other_neighbour_set": set_rows / rows,
                  "rows_differing_from_all_plain": out_rows / rows,
                  "max_abs_diff_to_all_plain": layer_abs,
                  "duplicate_cloud_equal": True}
        if cls != "exact":
            detail["rows_differing_from_two_pass"] = exact_rows / rows
        details.append(detail)
        ms, plain, nbytes, ops = ms + t_k, plain + t_p, nbytes + b_, ops + o_
        all_ops += every_
    # the distances are a blocked product on the f32 units (so that exact
    # ties stay exact), so the route's bound is the f32 cores' own, on the
    # distinct query rows; bound_f32_cores_ms counts every row, as the
    # earlier kernel ran them
    bound, by = bound_ms(nbytes, ops)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by,
                bound_f32_cores_ms=bound_ms(nbytes, all_ops)[0]), details


# -------------------------------- kernels 4-7 (PointNet++ and PointConv)
def check_fps(fp, masked):
    """Kernel 4 at both FPS levels of PointNet++ and PointConv (1024 -> 512,
    then 512 -> 128): bit-equal to fps_plain on the whole batch."""
    import torch
    from interpret_quality_tpu_torch.ops.geometry import index_points
    ms = plain = ops = nbytes = 0.0
    details, xyz = [], masked
    for npoint in FPS_NPOINTS:
        got = fp.fps(xyz, npoint)
        if not torch.equal(got, fp.fps_plain(xyz, npoint)):
            raise AssertionError(f"fps: indices differ from fps_plain at "
                                 f"npoint={npoint}")
        t_k = cuda_ms(lambda: fp.fps(xyz, npoint))
        t_p = cuda_ms(lambda: fp.fps_plain(xyz, npoint), reps=1)
        B, n = xyz.shape[:2]
        # per step and point: 3 sub, 3 mul, 2 add, 1 min, 1 compare
        b_, o_ = B * n * 3 * 4 + B * npoint * 4, 10.0 * B * npoint * n
        details.append({"kernel": "fps", "B": B, "N": n, "npoint": npoint,
                        "bit_equal": True, "ms": t_k, "plain_ms": t_p,
                        "bound_ms": bound_ms(b_, o_)[0],
                        **fp.fps_occupancy(n)})
        ms, plain, nbytes, ops = ms + t_k, plain + t_p, nbytes + b_, ops + o_
        xyz = index_points(xyz, got)
    bound, by = bound_ms(nbytes, ops)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by), details


def near_ball_boundary(new_xyz, xyz, radius):
    """(B, S) rows with a point whose exact (f64) squared distance to the
    centre lies within BALL_TOL of radius^2: there f32 rounding can move
    the point in or out of the ball."""
    d = ((xyz.double()[:, None] - new_xyz.double()[:, :, None]) ** 2).sum(-1)
    return ((d - radius ** 2).abs() <= BALL_TOL).any(-1), d


def check_ball_mlp3(gr, fp, model, masked):
    """Kernel 5 on the six PointNet++ MSG branches at the main path's
    shapes, with the seeded model's folded weights and its own inputs.  A
    row may leave rtol 1e-4 / atol 1e-5 of the plain version only where a
    point lies on its ball's boundary at f32 noise."""
    import torch
    from interpret_quality_tpu_torch.models.common import fold_stack
    from interpret_quality_tpu_torch.ops.geometry import index_points
    from interpret_quality_tpu_torch.ops.cuda.emulation import ball_mlp3_at
    ms = plain = ops = mops = f32_ops = nbytes = 0.0
    max_abs, details = 0.0, []
    xyz, points = masked, None
    for level, sa in enumerate((model.sa1, model.sa2)):
        new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
        D = 0 if points is None else points.shape[-1]
        outs = []
        for br, (convs, bns, radius, k) in enumerate(zip(
                sa.conv_blocks, sa.bn_blocks, sa.radius_list,
                sa.nsample_list)):
            (a1, b1), (a2, b2), (a3, b3) = fold_stack(convs, bns)
            uf = None if points is None else torch.matmul(points, a1[:D])
            w = (b1, a1[D:], a2, b2, a3, b3)
            got = gr.fused_ball_mlp3(new_xyz, xyz, uf, *w, radius=radius, k=k)
            torch.cuda.synchronize()

            def plain_on(sl):
                return gr.fused_ball_mlp3_plain(
                    new_xyz[sl], xyz[sl], None if uf is None else uf[sl], *w,
                    radius=radius, k=k)
            differ = near = rows = bit_equal = 0
            filled = needed = 0
            br_abs = same_abs = 0.0
            # second reference, first chunk: the plain version with its
            # layers 2-3 on the emulated three-product TF32 split
            sl = next(chunks(xyz.shape[0], BALL_CHUNK))
            emulated = ball_mlp3_at(new_xyz[sl], xyz[sl],
                                    None if uf is None else uf[sl], *w,
                                    radius=radius, k=k, precision="highest")
            edge = near_ball_boundary(new_xyz[sl], xyz[sl], radius)[0]
            emu_abs = float((got[sl] - emulated)[~edge].abs().max())
            del emulated, edge
            for sl in chunks(xyz.shape[0], BALL_CHUNK):
                want = plain_on(sl)
                ok = torch.isclose(got[sl], want, rtol=1e-4, atol=1e-5).all(-1)
                edge, d = near_ball_boundary(new_xyz[sl], xyz[sl], radius)
                if bool((~ok & ~edge).any()):
                    raise AssertionError(
                        f"fused_ball_mlp3 sa{level + 1} branch {br}: rows "
                        "differ from the plain version away from any ball "
                        "boundary")
                diff = (got[sl] - want).abs()
                bit_equal += int((diff == 0).sum())
                br_abs = max(br_abs, float(diff.max()))
                if bool(ok.any()):
                    same_abs = max(same_abs, float(diff[ok].max()))
                differ += int((~ok).sum())
                near += int(edge.sum())
                rows += ok.numel()
                inside = d <= radius ** 2
                filled += int(torch.clamp(inside.sum(-1), 1, k).sum())
                if uf is None:
                    # without feature rows a slot whose point has the very
                    # coordinates of an earlier point repeats that row: the
                    # rows the data needs are the distinct ones
                    first = (xyz[sl][:, :, None] == xyz[sl][:, None]).all(
                        -1).int().argmax(-1)                     # (b, n)
                    fresh = first == torch.arange(first.shape[1],
                                                  device=first.device)
                    slot = inside & (inside.cumsum(-1) <= k)
                    needed += int(torch.clamp(
                        (slot & fresh[:, None]).sum(-1), 1, k).sum())
                    del first, fresh, slot
                del want, d, inside
            max_abs = max(max_abs, br_abs)
            t_k = cuda_ms(lambda: gr.fused_ball_mlp3(new_xyz, xyz, uf, *w,
                                                     radius=radius, k=k))
            t_p = cuda_ms(lambda: [plain_on(sl) for sl in
                                   chunks(xyz.shape[0], BALL_CHUNK)],
                          reps=1)
            B, S, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
            C1, C2, C3 = a2.shape[0], a2.shape[1], a3.shape[1]
            b_ = (B * S * 3 + B * n * 3 + (0 if uf is None else B * n * C1)
                  + B * S * C3) * 4
            # ball query: distances of every centre to every point; the
            # filled slots' layer 1 (the 3-row product, bias, feature row,
            # relu) on the f32 units, their layers 2-3 on the tensor cores
            if uf is not None:
                needed = filled
            per_row, per_row_mm = 2 * 3 * C1 + 3 * C1, 2 * C1 * C2 + 2 * C2 * C3
            o_ = 8.0 * B * S * n + needed * per_row
            m_ = float(needed) * per_row_mm
            # every filled slot on the f32 cores: the earlier kernel's bound
            f32_ = 8.0 * B * S * n + filled * float(per_row + per_row_mm)
            details.append({
                "kernel": "fused_ball_mlp3", "level": level + 1,
                "branch": br, "B": B, "S": S, "N": n, "K": k,
                "radius": radius, "C": [C1, C2, C3],
                "filled_slot_rows": filled, "distinct_slot_rows": needed,
                "ms": t_k, "plain_ms": t_p,
                "bound_ms": bound_ms(b_, o_, m_)[0],
                "bound_f32_cores_ms": bound_ms(b_, f32_)[0],
                "max_abs_diff_to_3xtf32_emulation_first_chunk": emu_abs,
                "plain_compared_in_chunks_of": BALL_CHUNK,
                "rows_outside_rtol_1e-4": differ / rows,
                "rows_near_a_ball_boundary": near / rows,
                "max_abs_diff": br_abs,
                "max_abs_diff_rows_within_rtol": same_abs,
                "bit_equal_values": bit_equal / got.numel(),
                "max_abs_value": float(got.abs().max()),
                "nonzero_values": float((got != 0).float().mean())})
            ms, plain = ms + t_k, plain + t_p
            nbytes, ops, mops = nbytes + b_, ops + o_, mops + m_
            f32_ops += f32_
            outs.append(got)
            del uf
        xyz, points = new_xyz, torch.cat(outs, dim=-1)
        del outs
    # the bound of the route taken (the rows the data needs; layers 2-3 as
    # three TF32 products on the tensor cores), and the earlier kernel's
    # (every filled slot on the f32 cores)
    bound, by = bound_ms(nbytes, ops, mops)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by,
                bound_f32_cores_ms=bound_ms(nbytes, f32_ops)[0]), details


def check_pointconv_kernels(gr, fp, model, masked):
    """Kernels 6 and 7 at both PointConv SA levels, with the seeded model's
    folded weights and its own inputs.

    Kernel 6 against knn_with_density_plain on every chunk: selected
    distances within REL_LIMIT of |x|^2 (selection_gap), den bit-equal
    where the index rows are, dmax where the sets are; both of its routes
    forced (xyz, tiled) bit-equal in all three outputs, so each is held
    the same way, and timed apart.  Kernel 7 takes the
    kernel-6 indices; on the same indices it must stay within rtol 1e-4 /
    atol 1e-5 of fused_pointconv_sa_plain on every row (its first chunk is
    also compared with the plain version on the emulated TF32 split)."""
    import torch
    from interpret_quality_tpu_torch.models.common import fold_stack
    from interpret_quality_tpu_torch.ops.cuda.emulation import (
        pointconv_sa_3xtf32)
    from interpret_quality_tpu_torch.ops.geometry import (compute_density,
                                                          index_points)
    k6 = dict(ms=0.0, plain=0.0, ops=0.0, nbytes=0.0, max_abs=0.0, routes=[])
    k7 = dict(ms=0.0, plain=0.0, ops=0.0, mops=0.0, f32_ops=0.0, nbytes=0.0,
              max_abs=0.0)
    details = []
    xyz, points = masked, None
    for level, sa in enumerate((model.sa1, model.sa2)):
        inv = 1.0 / compute_density(xyz, sa.bandwidth)
        new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
        k = sa.nsample
        idx, den, dmax = gr.knn_with_density(new_xyz, xyz, inv, k)
        forced = route_outputs(lambda r: gr._knn_with_density(
            new_xyz, xyz, inv, k, r), f"knn_with_density sa{level + 1}")
        if not all(torch.equal(a, b) for a, b in zip(forced, (idx, den, dmax))):
            raise AssertionError("knn_with_density: the route the shape takes "
                                 "differs from the same route forced")
        del forced
        torch.cuda.synchronize()
        differ_rows = set_rows = rows = 0
        gap_abs = gap_rel = 0.0
        for sl in chunks(xyz.shape[0]):
            pidx, pden, pdmax = gr.knn_with_density_plain(new_xyz[sl],
                                                          xyz[sl], inv[sl], k)
            differ, sets_differ, g_abs, g_rel, _ = selection_gap(
                new_xyz[sl], xyz[sl], idx[sl], pidx)
            same = ~differ
            if not (torch.equal(den[sl][same], pden[same]) and torch.equal(
                    dmax[sl][~sets_differ], pdmax[~sets_differ])):
                raise AssertionError("knn_with_density: densities differ "
                                     "where the neighbours agree")
            differ_rows += int(differ.sum())
            set_rows += int(sets_differ.sum())
            rows += differ.numel()
            gap_abs, gap_rel = max(gap_abs, g_abs), max(gap_rel, g_rel)
        if gap_rel > REL_LIMIT:
            raise AssertionError(f"knn_with_density sa{level + 1}: selected "
                                 f"distances differ by {gap_rel} relative to "
                                 f"|x|^2 (limit {REL_LIMIT})")
        t_k = cuda_ms(lambda: gr.knn_with_density(new_xyz, xyz, inv, k))
        t_p = cuda_ms(lambda: [gr.knn_with_density_plain(
            new_xyz[sl], xyz[sl], inv[sl], k) for sl in chunks(xyz.shape[0])],
            reps=1)
        B, S, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
        b_ = (B * S * 3 + B * n * 3 + B * n + 2 * B * S * k + B * S) * 4
        # the work the data needs: the xyz route (the shape's) selects for
        # the distinct centres only, a repeated one takes its original's result
        queries = distinct_row_count(new_xyz)
        o_ = queries * n * (2 * 3 + 3)
        details.append({"kernel": "knn_with_density", "level": level + 1,
                        "B": B, "S": S, "N": n, "k": k,
                        "route": gr.knn_density_route(n, 3, k), "ms": t_k,
                        "plain_ms": t_p, "bound_ms": bound_ms(b_, o_)[0],
                        "route_ms": route_times(lambda r: gr._knn_with_density(
                            new_xyz, xyz, inv, k, r)),
                        "routes_bit_equal": True,
                        "distinct_query_rows": queries / (B * S),
                        "identical_index_rows": 1 - differ_rows / rows,
                        "rows_with_other_neighbour_set": set_rows / rows,
                        "max_rel_selected_dist_err": gap_rel})
        k6["routes"].append(details[-1]["route"]["route"])
        k6["ms"] += t_k
        k6["plain"] += t_p
        k6["nbytes"] += b_
        k6["ops"] += o_
        k6["max_abs"] = max(k6["max_abs"], gap_abs)

        # kernel 7, on the inputs PointConvDensitySA.forward builds
        (a1, b1), (a2, b2), (a3, b3) = fold_stack(sa.mlp_convs, sa.mlp_bns)
        src = xyz if points is None else torch.cat([xyz, points], dim=-1)
        u = torch.matmul(src, a1) + b1
        csw = torch.matmul(new_xyz, a1[:3])
        dnet = fold_stack(sa.densitynet.mlp_convs, sa.densitynet.mlp_bns)
        wnet = fold_stack(sa.weightnet.mlp_convs, sa.weightnet.mlp_bns)
        per_cloud = (idx, den, dmax, new_xyz, u, xyz, csw)
        w = (a2, b2, a3, b3, dnet, wnet)
        out = gr.fused_pointconv_sa(*per_cloud, *w, k=k)
        torch.cuda.synchronize()

        def plain_on(sl):
            return gr.fused_pointconv_sa_plain(*[t[sl] for t in per_cloud],
                                               *w, k=k)
        lvl_abs, bit_equal = 0.0, 0
        sl = next(chunks(B, PCONV_CHUNK))
        emu_abs = float((out[sl] - pointconv_sa_3xtf32(
            *[t[sl] for t in per_cloud], *w, k=k)).abs().max())
        for sl in chunks(B, PCONV_CHUNK):
            want = plain_on(sl)
            if not torch.allclose(out[sl], want, rtol=1e-4, atol=1e-5):
                bad = ~torch.isclose(out[sl], want, rtol=1e-4, atol=1e-5)
                raise AssertionError(
                    f"fused_pointconv_sa sa{level + 1}: {int(bad.sum())} "
                    f"values outside rtol 1e-4 of the plain version, max "
                    f"abs diff {float((out[sl] - want).abs().max())}")
            lvl_abs = max(lvl_abs, float((out[sl] - want).abs().max()))
            bit_equal += int((out[sl] == want).sum())
            del want
        t_k = cuda_ms(lambda: gr.fused_pointconv_sa(*per_cloud, *w, k=k))
        t_p = cuda_ms(lambda: [plain_on(sl) for sl in
                               chunks(B, PCONV_CHUNK)], reps=1)
        C1, C2, C3 = a2.shape[0], a2.shape[1], a3.shape[1]
        b_ = (B * S * k * 3 + B * S * 1 + B * S * 3 + B * n * C1 + B * n * 3
              + B * S * C1 + B * S * C3 * 16) * 4
        # per neighbour: layer 1 (sub, relu), the density scale and
        # WeightNet 3->8->8->16 on the f32 units; layers 2-3 and the
        # contraction into C3 x 16 on the tensor cores
        per_row = 2 * C1 + C3 + 2 * (3 * 8 + 8 * 8 + 8 * 16)
        per_row_mm = 2 * C1 * C2 + 2 * C2 * C3 + 2 * 16 * C3
        o_, m_ = float(B * S * k * per_row), float(B * S * k * per_row_mm)
        # everything on the f32 cores: the earlier kernel's bound
        f32_ = o_ + m_
        details.append({"kernel": "fused_pointconv_sa", "level": level + 1,
                        "B": B, "S": S, "N": n, "K": k, "C": [C1, C2, C3],
                        "ms": t_k, "plain_ms": t_p,
                        "bound_ms": bound_ms(b_, o_, m_)[0],
                        "bound_f32_cores_ms": bound_ms(b_, f32_)[0],
                        "max_abs_diff_to_3xtf32_emulation_first_chunk": emu_abs,
                        "plain_compared_in_chunks_of": PCONV_CHUNK,
                        "max_abs_diff": lvl_abs,
                        "bit_equal_values": bit_equal / out.numel(),
                        "max_abs_value": float(out.abs().max()),
                        "nonzero_values": float((out != 0).float().mean())})
        k7["ms"] += t_k
        k7["plain"] += t_p
        k7["nbytes"] += b_
        k7["ops"] += o_
        k7["mops"] += m_
        k7["f32_ops"] += f32_
        k7["max_abs"] = max(k7["max_abs"], lvl_abs)
        xyz, points = new_xyz, sa._head(out)
        del out, u, per_cloud, inv

    def summary(k):
        # the bound of the route taken (kernel 7: layers 2-3 and the
        # contraction as three TF32 products on the tensor cores), and for
        # kernel 7 the earlier kernel's beside it (everything on the f32 cores)
        bound, by = bound_ms(k["nbytes"], k["ops"], k.get("mops", 0.0))
        out = dict(max_abs_err=k["max_abs"], ms=k["ms"], plain_ms=k["plain"],
                   bound_ms=bound, bound_by=by)
        if "f32_ops" in k:
            out["bound_f32_cores_ms"] = bound_ms(k["nbytes"], k["f32_ops"])[0]
        if "routes" in k:
            out["main_path_route"] = k["routes"]
        return out
    return summary(k6), summary(k7), details


def check_knn_group(kg, model, masked):
    """Kernel 10 at both PCT levels on the seeded model's own inputs: the
    embedding of the masked batch, the plan's FPS and kNN indices (kernels
    4 and 1), the hoisted rows u and the centres' share c with BatchNorm 1
    folded, layer 2 with BatchNorm 2 folded, as ``models.pct.LocalOp``
    builds them.  Within rtol 1e-4 / atol 1e-5 of knn_group_max_plain on
    every chunk of GROUP_CHUNK clouds (the split drops lo*lo and sums in
    another order), a second launch bit-equal; the first chunk also against
    the plain version on the emulated TF32 split.  The bound counts layer 2
    on every slot (the kernel's work; the benchmark's reader counts the
    distinct ones).  Returns (numbers, details)."""
    import torch
    from interpret_quality_tpu_torch.models.common import (bn_affine,
                                                           conv_bn_relu)
    from interpret_quality_tpu_torch.models.pct import _weight
    from interpret_quality_tpu_torch.models.plans import pct_plan
    from interpret_quality_tpu_torch.ops.cuda.emulation import (
        knn_group_max_at)
    from interpret_quality_tpu_torch.ops.geometry import index_points
    plan = pct_plan(masked, model.levels)
    f = conv_bn_relu(masked, model.conv1, model.bn1)
    f = conv_bn_relu(f, model.conv2, model.bn2)
    tot = dict(ms=0.0, plain=0.0, nbytes=0.0, mops=0.0, f32=0.0, max_abs=0.0)
    details = []
    for level, (fps_idx, idx) in enumerate(plan):
        op = getattr(model, f"gather_local_{level}")
        C = f.shape[-1]
        w1 = _weight(op.conv1)
        mul1, shift1 = bn_affine(op.bn1)
        mul2, shift2 = bn_affine(op.bn2)
        u = torch.matmul(f, w1[:, :C].T * mul1).contiguous()
        c = (torch.matmul(index_points(f, fps_idx), (w1[:, C:] - w1[:, :C]).T
                          * mul1) + shift1).contiguous()
        a2 = (_weight(op.conv2).T * mul2).contiguous()
        args = (idx, u, c, a2, shift2)
        out = kg.knn_group_max(*args)
        torch.cuda.synchronize()
        if not torch.equal(kg.knn_group_max(*args), out):
            raise AssertionError("knn_group_max: two launches differ")
        B, S, K = idx.shape
        N, C1, C2 = u.shape[1], u.shape[2], a2.shape[1]

        def on(sl):
            return (idx[sl], u[sl], c[sl], a2, shift2)
        first = next(chunks(B, GROUP_CHUNK))
        emu_abs = float((out[first] - knn_group_max_at(
            *on(first), precision="highest")).abs().max())
        lvl_abs = 0.0
        for sl in chunks(B, GROUP_CHUNK):
            want = kg.knn_group_max_plain(*on(sl))
            if not torch.allclose(out[sl], want, rtol=1e-4, atol=1e-5):
                raise AssertionError(
                    f"knn_group_max level {level + 1}: max abs diff "
                    f"{float((out[sl] - want).abs().max())} outside rtol "
                    f"1e-4 / atol 1e-5 of the plain version")
            lvl_abs = max(lvl_abs, float((out[sl] - want).abs().max()))
            del want
        t_k = cuda_ms(lambda: kg.knn_group_max(*args))
        t_p = cuda_ms(lambda: [kg.knn_group_max_plain(*on(sl))
                               for sl in chunks(B, GROUP_CHUNK)], reps=1)
        b_ = 4.0 * (B * S * K + B * N * C1 + B * S * C1 + C1 * C2 + C2
                    + B * S * C2)
        m_ = 2.0 * B * S * K * C1 * C2
        f32_ = B * S * K * (2.0 * C1 + C2)      # layer 1's add and ReLU, the max
        details.append({"kernel": "knn_group_max", "level": level + 1,
                        "B": B, "S": S, "N": N, "K": K, "C": [C1, C2],
                        "ms": t_k, "plain_ms": t_p,
                        "bound_ms": bound_ms(b_, f32_, m_)[0],
                        "plain_compared_in_chunks_of": GROUP_CHUNK,
                        "max_abs_diff": lvl_abs,
                        "max_abs_diff_to_3xtf32_emulation_first_chunk": emu_abs,
                        "max_abs_value": float(out.abs().max()),
                        "repeat_bit_equal": True})
        for key, v in (("ms", t_k), ("plain", t_p), ("nbytes", b_),
                       ("mops", m_), ("f32", f32_)):
            tot[key] += v
        tot["max_abs"] = max(tot["max_abs"], lvl_abs)
        f = out
        del u, c, args
    bound, by = bound_ms(tot["nbytes"], tot["f32"], tot["mops"])
    return (dict(max_abs_err=tot["max_abs"], ms=tot["ms"],
                 plain_ms=tot["plain"], bound_ms=bound, bound_by=by), details)


def worst_case_clouds(masked):
    """The selection's two worst cases at the main path's size: every point
    one of 8 exact copies ("duplicate"), and clouds with all regions but one
    collapsed on the centre ("one_region": rows 1, 34, ... of the masked
    batch, cycled to its B clouds), where hundreds of candidates tie."""
    import torch
    B = masked.shape[0]
    g = torch.Generator(device="cpu").manual_seed(2)
    dup = torch.randn(B, N // 8, 3, generator=g).repeat(1, 8, 1)
    one = masked[1::R + 1]
    one = one.repeat(-(-B // one.shape[0]), 1, 1)[:B]
    return {"duplicate": dup.contiguous().to(masked.device),
            "one_region": one.contiguous()}


def check_selection_worst_cases(nb, gr, fp, model, masked):
    """Kernels 1 and 6 on worst_case_clouds: kernel 1 at GCNN's graph (k =
    K), kernel 6 at PointConv's two levels (FPS centres of the cloud, the
    model's k and bandwidths).  Both routes forced must be bit-equal, and
    their indices within REL_LIMIT of knn_plain's by selection_gap on every
    chunk; each route is timed."""
    import torch
    from interpret_quality_tpu_torch.ops.geometry import (compute_density,
                                                          index_points)
    details = []
    for cloud, x in worst_case_clouds(masked).items():
        B = x.shape[0]
        levels, xyz = [("knn", None, x, x, None, K)], x
        for level, sa in enumerate((model.sa1, model.sa2)):
            inv = 1.0 / compute_density(xyz, sa.bandwidth)
            new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
            levels.append(("knn_with_density", level + 1, new_xyz, xyz, inv,
                           sa.nsample))
            xyz = new_xyz
        for kernel, level, q, db, inv, k in levels:
            def run(route):
                if inv is None:
                    return (nb._knn(q, db, k, route),)
                return gr._knn_with_density(q, db, inv, k, route)
            idx = route_outputs(run, f"{kernel} on the {cloud} cloud")[0]
            gap = max(selection_gap(q[sl], db[sl], idx[sl],
                                    nb.knn_plain(q[sl], db[sl], k))[3]
                      for sl in chunks(B))
            if gap > REL_LIMIT:
                raise AssertionError(f"{kernel} on the {cloud} cloud: selected "
                                     f"distances differ by {gap} relative to "
                                     f"|x|^2 (limit {REL_LIMIT})")
            details.append({"kernel": kernel, "level": level, "cloud": cloud,
                            "B": B, "S": q.shape[1], "N": db.shape[1], "k": k,
                            "distinct_query_rows":
                                distinct_row_count(q) / (B * q.shape[1]),
                            "routes_bit_equal": True,
                            "max_rel_selected_dist_err": gap,
                            "route_ms": route_times(run)})
    return details


def pointconv_forward_split(model, masked):
    """One PointConv forward of the whole masked batch, as
    PointConvDensityClsSsg.forward runs it without a plan, with CUDA events
    between its parts: ms per part, summed over the two SA levels, and the
    logits' largest difference to the model's own forward.  Measurement
    only; the main path calls the model."""
    import torch
    from interpret_quality_tpu_torch.models.common import (bn_eval, fold_stack,
                                                           pointwise)
    from interpret_quality_tpu_torch.ops.cuda import fps as fp
    from interpret_quality_tpu_torch.ops.cuda import groups as gr
    from interpret_quality_tpu_torch.ops.geometry import (compute_density,
                                                          index_points)
    parts = ("density", "fps", "knn_with_density", "layer1_and_folds",
             "density_scale", "fused_pointconv_sa", "sa_head", "sa3",
             "classifier")

    def forward(marks):
        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        mark(None)
        xyz, points = masked, None
        for sa in (model.sa1, model.sa2):
            inv = 1.0 / compute_density(xyz, sa.bandwidth)
            mark("density")
            fps_idx = fp.fps(xyz, sa.npoint)
            new_xyz = index_points(xyz, fps_idx)
            mark("fps")
            idx, den, dmax = gr.knn_with_density(new_xyz, xyz, inv, sa.nsample)
            mark("knn_with_density")
            (a1, b1), (a2, b2), (a3, b3) = fold_stack(sa.mlp_convs, sa.mlp_bns)
            src = xyz if points is None else torch.cat([xyz, points], dim=-1)
            u = torch.matmul(src, a1) + b1
            csw = torch.matmul(new_xyz, a1[:3])
            dnet = fold_stack(sa.densitynet.mlp_convs, sa.densitynet.mlp_bns)
            wnet = fold_stack(sa.weightnet.mlp_convs, sa.weightnet.mlp_bns)
            mark("layer1_and_folds")
            # the wrapper's own first step, timed apart: DensityNet on (B, S, K)
            gr.density_scale(den, dmax, dnet)
            mark("density_scale")
            out = gr.fused_pointconv_sa(idx, den, dmax, new_xyz, u, xyz, csw,
                                        a2, b2, a3, b3, dnet, wnet, k=sa.nsample)
            mark("fused_pointconv_sa")
            xyz, points = new_xyz, sa._head(out)
            del out, u
            mark("sa_head")
        _, h = model.sa3(xyz, points)
        mark("sa3")
        h = torch.relu(bn_eval(pointwise(h, model.fc1), model.bn1))
        h = torch.relu(bn_eval(pointwise(h, model.fc2), model.bn2))
        logits = pointwise(h, model.fc3)
        mark("classifier")
        return logits
    forward([])                                             # warm-up
    torch.cuda.synchronize()
    marks = []
    logits = forward(marks)
    torch.cuda.synchronize()
    ms = dict.fromkeys(parts, 0.0)
    for (_, before), (name, after) in zip(marks[:-1], marks[1:]):
        ms[name] += before.elapsed_time(after)
    whole = cuda_ms(lambda: model(masked), reps=2)
    diff = float((logits - model(masked)).abs().max())
    if diff > 1e-4:
        raise AssertionError(f"pointconv forward split: logits differ from "
                             f"the model's forward by {diff}")
    # density_scale ran twice in the split (apart, and inside the wrapper)
    return {"B": masked.shape[0], "parts_ms": ms,
            "sum_of_parts_ms": marks[0][1].elapsed_time(marks[-1][1]),
            "model_forward_ms": whole,
            "max_abs_diff_to_model_forward": diff,
            "note": "fused_pointconv_sa includes the wrapper's own "
                    "density_scale, which is also timed apart"}


def check_gather_rows(gr, values, idx):
    """Kernel 8 at the shapes a graph layer gives it (values (B, N, 64) at
    kNN indices (B, N, K)): bit-equal to gather_rows_plain, timed beside one
    torch.gather call (library_ms).  Returns (numbers, detail, launches of
    this phase)."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import launch
    launch.reset_launches()
    got = gr.gather_rows(values, idx)
    want = gr.gather_rows_plain(values, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("gather_rows: kernel differs from its plain "
                             "version")
    del got, want
    B, N_, F = values.shape
    S, K_ = idx.shape[1], idx.shape[2]
    lidx = idx.reshape(B, -1).long()[..., None].expand(-1, -1, F)
    t_k = cuda_ms(lambda: gr.gather_rows(values, idx))
    t_p = cuda_ms(lambda: gr.gather_rows_plain(values, idx))
    t_l = cuda_ms(lambda: torch.gather(values, 1, lidx))
    del lidx
    bound, by = bound_ms((B * N_ * F + B * S * K_ + B * S * K_ * F) * 4, 0.0)
    detail = {"kernel": "gather_rows", "B": B, "N": N_, "S": S, "K": K_,
              "F": F, "bit_equal": True, "ms": t_k, "plain_ms": t_p,
              "library_ms": t_l, "bound_ms": bound,
              "output_gb": B * S * K_ * F * 4 / 1e9}
    return (dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=bound,
                 bound_by=by, library_ms=t_l), detail,
            launch.LAUNCHES["gather_rows"])


def check_dense(dn, masked, device):
    """Kernel 9 on DGCNN's four edge outputs of the masked batch (1650
    clouds of 1024 points): within rtol 1e-4 / atol 1e-5 of dense_pool_plain
    (the split drops lo*lo and sums in another order), a second launch
    bit-equal; timed beside its plain version and, as library_ms, today's
    cuBLAS product and PyTorch tail on the concatenated rows.  Its listed
    route on the copy lists of layer 1's kernel-3 launch (as DGCNN's forward
    without a plan passes them) is held the same way, its max bit-equal to
    the every-row launch's, and timed (listed_ms).  The bound counts the
    products on the distinct points.  Returns (numbers, detail)."""
    import torch
    from interpret_quality_tpu_torch.models.common import bn_eval, leaky_relu02
    from interpret_quality_tpu_torch.models.dgcnn import edge_conv
    model = seeded_model("dgcnn", device)
    conv, bn = model.conv5[0], model.bn5
    with torch.inference_mode():
        h, lists = edge_conv(masked, model.conv1, K, copy_lists=True)
        feats = [h]
        for block in (model.conv2, model.conv3, model.conv4):
            h = edge_conv(h, block, K)
            feats.append(h)
        want = dn.dense_pool_plain(feats, conv, bn)
        outs = {}
        for route, args in (("every row", ()), ("listed", (lists,))):
            got = outs[route] = dn.dense_pool(feats, conv, bn, *args)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"dense_pool ({route}): kernel differs "
                                     "from its plain version beyond rtol "
                                     "1e-4 / atol 1e-5")
            if not torch.equal(dn.dense_pool(feats, conv, bn, *args), got):
                raise AssertionError(f"dense_pool ({route}): two launches "
                                     "differ")
        C = conv.weight.shape[0]
        if not torch.equal(outs["listed"][:, :C], outs["every row"][:, :C]):
            raise AssertionError("dense_pool: the listed route's max differs "
                                 "from every row's")
        max_abs = {r: float((o - want).abs().max()) for r, o in outs.items()}
        del outs, got, want
        cat = torch.cat(feats, dim=-1)
        w = conv.weight.reshape(conv.weight.shape[0], -1)

        def library():
            y = leaky_relu02(bn_eval(torch.matmul(cat, w.T), bn))
            return torch.cat([y.amax(dim=1), y.mean(dim=1)], dim=-1)
        t_k = cuda_ms(lambda: dn.dense_pool(feats, conv, bn))
        t_listed = cuda_ms(lambda: dn.dense_pool(feats, conv, bn, lists))
        t_p = cuda_ms(lambda: dn.dense_pool_plain(feats, conv, bn))
        t_l = cuda_ms(library)
    B, Kin, C = masked.shape[0], cat.shape[2], w.shape[0]
    listed_rows = int(lists.nrows.sum())
    del feats, cat, lists
    distinct = distinct_row_count(masked)
    bound, by = bound_ms(4 * (B * N * Kin + Kin * C + 4 * C + 2 * B * C),
                         2 * C * distinct, matrix_ops=2 * Kin * C * distinct)
    detail = {"kernel": "dense_pool", "B": B, "N": N, "K": Kin, "C": C,
              "ms": t_k, "listed_ms": t_listed, "plain_ms": t_p,
              "library_ms": t_l, "bound_ms": bound,
              "distinct_rows": distinct / (B * N),
              "listed_rows": listed_rows / (B * N),
              "max_abs_diff": max_abs["every row"],
              "listed_max_abs_diff": max_abs["listed"],
              "repeat_bit_equal": True, "listed_max_bit_equal": True}
    return (dict(max_abs_err=max(max_abs.values()), ms=t_k,
                 listed_ms=t_listed, plain_ms=t_p, bound_ms=bound,
                 bound_by=by, library_ms=t_l), detail)


def check_group_res_mlp(gm, model, masked):
    """Kernel 11 at PointMLP's four stages on the seeded model's own inputs:
    the embedding of the masked batch, the plan's FPS and kNN indices
    (kernels 4 and 1), each stage's scale, hoisted rows, centres' share and
    folded residual blocks (``PointMLP.group_inputs``), the pos-blocks
    between stages.  Within 1e-4 of the largest value of
    group_res_mlp_plain on every chunk of RES_CHUNK clouds (the split drops
    lo*lo and sums in another order, through four chained products), a
    second launch bit-equal, one launch a stage; the first chunk also
    against the plain version on the emulated TF32 split.  The bound counts
    the four products on every slot (the kernel's work; the benchmark's
    reader counts the distinct ones).  Returns (numbers, details)."""
    import torch
    from interpret_quality_tpu_torch.models.plans import pointmlp_plan
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.ops.cuda.emulation import (
        group_res_mlp_at)
    plan = pointmlp_plan(masked, model.levels)
    f = model.embedding(masked, True)
    tot = dict(ms=0.0, plain=0.0, nbytes=0.0, mops=0.0, f32=0.0, rel=0.0)
    details = []
    for stage, (fps_idx, idx) in enumerate(plan):
        args = (idx, fps_idx, *model.group_inputs(stage, f, fps_idx, idx))
        before = launch.launches("group_res_mlp")
        out = gm.group_res_mlp(*args)
        torch.cuda.synchronize()
        if launch.launches("group_res_mlp", since=before) != {
                "group_res_mlp": 1}:
            raise AssertionError("group_res_mlp: not one launch a stage")
        if not torch.equal(gm.group_res_mlp(*args), out):
            raise AssertionError("group_res_mlp: two launches differ")
        B, S, K = idx.shape
        N, C = args[2].shape[1], args[2].shape[2]

        def on(sl):
            return (idx[sl], fps_idx[sl], args[2][sl], args[3][sl],
                    args[4][sl], args[5])
        first = next(chunks(B, RES_CHUNK))
        scale = float(out.abs().max())
        emu_rel = float((out[first] - group_res_mlp_at(
            *on(first), precision="highest")).abs().max()) / scale
        rel = 0.0
        for sl in chunks(B, RES_CHUNK):
            want = gm.group_res_mlp_plain(*on(sl))
            rel = max(rel, float((out[sl] - want).abs().max()) / scale)
            del want
        if rel > 1e-4:
            raise AssertionError(f"group_res_mlp stage {stage + 1}: "
                                 f"{rel} of the largest value from the "
                                 f"plain version, over 1e-4")
        t_k = cuda_ms(lambda: gm.group_res_mlp(*args))
        t_p = cuda_ms(lambda: [gm.group_res_mlp_plain(*on(sl))
                               for sl in chunks(B, RES_CHUNK)], reps=1)
        b_ = 4.0 * (B * S * K + B * S + B * N * C + 2 * B * S * C + B
                    + 4 * C * C + 4 * C)
        m_ = 2.0 * B * S * K * 4 * C * C
        f32_ = B * S * K * C * 10.0     # h0, the epilogues' adds and ReLUs, the max
        details.append({"kernel": "group_res_mlp", "stage": stage + 1,
                        "B": B, "S": S, "N": N, "K": K, "C": C,
                        "ms": t_k, "plain_ms": t_p,
                        "bound_ms": bound_ms(b_, f32_, m_)[0],
                        "plain_compared_in_chunks_of": RES_CHUNK,
                        "max_diff_of_largest": rel,
                        "max_diff_of_largest_to_3xtf32_emulation_first_chunk":
                            emu_rel,
                        "max_abs_value": scale, "repeat_bit_equal": True})
        for key, v in (("ms", t_k), ("plain", t_p), ("nbytes", b_),
                       ("mops", m_), ("f32", f32_)):
            tot[key] += v
        tot["rel"] = max(tot["rel"], rel)
        f = out
        for block in model.pos_blocks_list[stage].operation:
            f = block(f, True)
        del args, out
    bound, by = bound_ms(tot["nbytes"], tot["f32"], tot["mops"])
    return (dict(max_diff_of_largest=tot["rel"], ms=tot["ms"],
                 plain_ms=tot["plain"], bound_ms=bound, bound_by=by), details)


# Model attributes that hold a kernel wrapper, and the plain version each
# is swapped for in plain_kernels()
KERNEL_CALLS = {
    "dgcnn": {"knn": "neighbors.knn_plain",
              "gather_extrema": "neighbors.gather_extrema_plain",
              "knn_gather_extrema": "neighbors.knn_gather_extrema_plain",
              "dense_pool": "dense.dense_pool_plain"},
    "pointnet2": {"fps": "fps.fps_plain",
                  "fused_ball_mlp3": "groups.fused_ball_mlp3_plain"},
    "pointconv": {"fps": "fps.fps_plain",
                  "knn_with_density": "groups.knn_with_density_plain",
                  "fused_pointconv_sa": "groups.fused_pointconv_sa_plain"},
    "pct": {"knn_group_max": "knn_group.knn_group_max_plain",
            "dense_pool": "dense.dense_pool_plain"},
    "pointmlp": {"group_res_mlp": "group_mlp.group_res_mlp_plain"},
    # PCT's and PointMLP's plans when the forward is given none
    "plans": {"fps": "fps.fps_plain", "knn": "neighbors.knn_plain"},
}


@contextlib.contextmanager
def plain_kernels():
    """Route the models' kernel calls to the plain versions, for the
    kernels-vs-plain comparison of the model phase only."""
    import importlib
    saved = []
    for mod_name, calls in KERNEL_CALLS.items():
        mod = importlib.import_module(
            f"interpret_quality_tpu_torch.models.{mod_name}")
        for attr, plain in calls.items():
            ops_mod, fn = plain.split(".")
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, getattr(importlib.import_module(
                f"interpret_quality_tpu_torch.ops.cuda.{ops_mod}"), fn))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def selection_tie_clouds(name, model, batch):
    """(B,) clouds where the kernels and the plain versions may rightly
    select differently: for PointNet++, a point on a ball's boundary at f32
    noise (FPS is bit-equal, so the centres agree); for PointConv and PCT,
    another kNN neighbour set (near ties in xyz), for PointMLP too.  None
    for the other families."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import fps as fp
    from interpret_quality_tpu_torch.ops.cuda import groups as gr
    from interpret_quality_tpu_torch.ops.geometry import (compute_density,
                                                          index_points)
    tie = torch.zeros(batch.shape[0], dtype=torch.bool, device=batch.device)
    xyz = batch
    if name == "pointnet2":
        for sa in (model.sa1, model.sa2):
            new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
            for radius in sa.radius_list:
                tie |= near_ball_boundary(new_xyz, xyz, radius)[0].any(-1)
            xyz = new_xyz
        return tie
    if name == "pointconv":
        for sa in (model.sa1, model.sa2):
            inv = 1.0 / compute_density(xyz, sa.bandwidth)
            new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
            got = gr.knn_with_density(new_xyz, xyz, inv, sa.nsample)[0]
            want = gr.knn_with_density_plain(new_xyz, xyz, inv, sa.nsample)[0]
            tie |= (got.sort(-1).values != want.sort(-1).values).any(-1).any(-1)
            xyz = new_xyz
        return tie
    if name in ("pct", "pointmlp"):
        from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
        for npoint, nsample in model.levels:
            new_xyz = index_points(xyz, fp.fps(xyz, npoint))
            got = nb.knn(new_xyz, xyz, nsample)
            want = nb.knn_plain(new_xyz, xyz, nsample)
            tie |= (got.sort(-1).values != want.sort(-1).values).any(-1).any(-1)
            xyz = new_xyz
        return tie
    return None


def check_models(masked, device):
    """Full-width logits through the kernels vs through the plain versions
    on one order's batch (33 clouds), every BatchNorm randomised, within
    rtol 1e-3 / atol 1e-3; a PointNet++, PointConv, PCT or PointMLP cloud
    may leave it only where selection_tie_clouds finds a tie.  PointMLP's
    logits reach 1e3 and more (its randomised BatchNorms let 20 layers of
    residual activations grow), so each of its clouds is held within 1e-4
    of the batch's logit RMS instead (f32 rounding through those layers).
    PointNet has no kernel: its logits on the card are held against the
    CPU's."""
    import torch
    out = {}
    batch = masked[:R + 1]                         # one order: 33 clouds
    for name in ("dgcnn", "gcnn", "pointnet2", "pointconv", "pointnet",
                 "pct", "pointmlp"):
        model = seeded_model(name, device)
        with torch.inference_mode():
            if name == "pointnet":
                got = model(batch)[0]
                want = seeded_model(name, "cpu")(batch.cpu())[0].to(device)
            else:
                got = model(batch)
                with plain_kernels():
                    want = model(batch)
            tie = selection_tie_clouds(name, model, batch)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite logits")
        diff = (got - want).abs()
        if name == "pointmlp":
            ok = (diff <= 1e-4 * want.pow(2).mean().sqrt()).all(-1)
        else:
            ok = (diff <= 1e-3 + 1e-3 * want.abs()).all(-1)
        out[name] = {"max_abs_diff": float(diff.max()),
                     "rows_within_rtol_1e-3": float(ok.float().mean())}
        if tie is not None:
            out[name]["clouds_with_a_selection_tie"] = int(tie.sum())
            ok = ok | tie
        if not bool(ok.all()):
            raise AssertionError(f"{name}: logits through the kernels differ "
                                 f"from the plain versions: {out[name]}")
    return out


def check_small_reference(device):
    """The engine on the card vs on the CPU (plain versions), GCNN on a
    256-point cloud, 8 regions, 10 orders."""
    import torch
    from interpret_quality_tpu_torch.attrib.shapley import (
        ShapleyEngine, generate_all_orders, region_id_from_fps)
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.models import make_forward_fn
    from interpret_quality_tpu_torch.ops.geometry import farthest_point_sample
    data, label = SyntheticClouds(30, 256, 10, seed=1)[1]
    x = torch.from_numpy(data)
    region_id = region_id_from_fps(x, farthest_point_sample(x[None], 8)[0])
    orders = generate_all_orders(10, 8, rng=np.random.RandomState(2))
    res = {}
    for dev in ("cpu", device):
        fwd = make_forward_fn(seeded_model("gcnn", dev, seed=3))
        engine = ShapleyEngine(fwd, 8, batch_orders=5, device=dev)
        res[str(dev)] = engine.shapley_for_pose(data, label, region_id.numpy(),
                                                orders, return_logits=True)
    (sv_c, lg_c), (sv_g, lg_g) = res["cpu"], res[str(device)]
    np.testing.assert_allclose(sv_g, sv_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lg_g, lg_c, rtol=1e-4, atol=1e-4)
    return {"sv_max_abs_diff": float(np.abs(sv_g - sv_c).max()),
            "logits_max_abs_diff": float(np.abs(lg_g - lg_c).max())}


def small_cloud():
    """Synthetic cloud 1 at 256 points in 8 FPS regions (6 to 87 points
    each): (data, label, region_id)."""
    import torch
    from interpret_quality_tpu_torch.attrib.shapley import region_id_from_fps
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.ops.geometry import farthest_point_sample
    data, label = SyntheticClouds(30, 256, 10, seed=1)[1]
    x = torch.from_numpy(data)
    region_id = region_id_from_fps(x, farthest_point_sample(x[None], 8)[0])
    return data, label, region_id.numpy()


def check_small_interactions(device):
    """InteractionEngine.logits_for_pairs on the card vs the CPU, GCNN:
    3 pairs x 5 contexts at 4 cells per forward, so the last forward holds
    3; rtol 1e-4 / atol 1e-4."""
    from interpret_quality_tpu_torch.attrib.interactions import (
        InteractionEngine)
    from interpret_quality_tpu_torch.models import make_forward_fn
    data, _, region_id = small_cloud()
    rng = np.random.RandomState(4)
    pairs = np.array([[0, 5], [3, 7], [1, 2]])
    ctx = np.stack([np.stack([rng.choice([r for r in range(8) if r not in p],
                                         3, replace=False) for _ in range(5)])
                    for p in pairs])
    res = {}
    for dev in ("cpu", device):
        engine = InteractionEngine(make_forward_fn(seeded_model("gcnn", dev, 3)),
                                   8, batch_contexts=4, device=dev)
        res[str(dev)] = engine.logits_for_pairs(data, region_id, pairs, ctx)
    got, want = res[str(device)], res["cpu"]
    if got.shape != (3, 20, 10):
        raise AssertionError(f"interaction logits: shape {got.shape}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    return {"interaction_logits_max_abs_diff": float(np.abs(got - want).max())}


def check_small_smoothness(device):
    """One smoothness_epoch_all_regions (linearity, inc) on the card vs the
    CPU: cloud within rtol 1e-4 / atol 1e-5, smoothness likewise, the same
    regions still active."""
    import torch
    from interpret_quality_tpu_torch.attrib import smoothness as sm
    data, _, region_id = small_cloud()
    masks, orients, bounds, smooth = [], [], [], []
    for r in range(8):
        pts = data[region_id == r]
        ori = np.stack(sm.principal_orientations(pts))
        v = np.array([np.var(pts @ o, ddof=1) for o in ori])
        masks.append((region_id == r).astype(np.float32))
        orients.append(ori)
        bounds.append(np.stack([v + sm.VAR_THRESHOLD, v - sm.VAR_THRESHOLD]))
        smooth.append(sm.region_smoothness_np(pts, "linearity"))
    res = {}
    for dev in ("cpu", device):
        def t(a, dtype=torch.float32):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)
        s0 = t(smooth)
        out = sm.smoothness_epoch_all_regions(
            t(data), t(data), t(np.stack(masks)), t(np.stack(orients)),
            t(np.stack(bounds)), s0, t([True] * 8, torch.bool),
            s0 + sm.ENUM_STEP, "linearity", "inc")
        res[str(dev)] = [o.cpu().numpy() for o in out]
    (xg, sg, ag), (xc, sc, ac) = res[str(device)], res["cpu"]
    np.testing.assert_allclose(xg, xc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sg, sc, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ag, ac)
    return {"smoothness_epoch_max_abs_diff": float(np.abs(xg - xc).max()),
            "smoothness_epoch_points_moved": int((np.abs(xg - data) > 0).any(
                -1).sum())}


# --------------------------------------------------------------- precision
@contextlib.contextmanager
def precision_setting(matmul: str, parts: int):
    """The process's matmul precision and gather value parts (the JAX
    package's --matmul_precision and --gather_precision) for a block; the
    exact settings, highest and hilo, restored after it."""
    from interpret_quality_tpu_torch import config
    config.set_matmul_precision(matmul)
    config.set_gather_value_parts(parts)
    try:
        yield
    finally:
        config.set_matmul_precision("highest")
        config.set_gather_value_parts(2)


def check_gather_bf16(nb, layers, idx):
    """Kernel 2's bf16 route at each GCNN layer, on the route the shape
    takes and on the row route forced: bit-equal on every chunk to the
    plain version on the bf16-rounded values.  ``ms`` is the wrapper's
    (the bf16 copy of the values, then the launch), ``kernel_ms`` the
    launch alone on a prepared copy, ``f32_route_ms`` the exact route in
    the same call.  The bound counts the bf16 route's device-memory bytes:
    the indices, the values in bf16 once, both f32 outputs once."""
    import torch
    ms = plain = kernel = f32 = nbytes = ops = 0.0
    details = []
    for _, a in layers:
        B, F = a.shape[0], a.shape[2]
        outs = {route: nb._gather_extrema(idx, a, nb.ROUTES[route], parts=1)
                for route in ("shape", "rows")}
        torch.cuda.synchronize()
        for sl in chunks(B):
            pmax, pmin = nb.gather_extrema_plain(idx[sl], a[sl], parts=1)
            for route, (kmax, kmin) in outs.items():
                if not (torch.equal(kmax[sl], pmax)
                        and torch.equal(kmin[sl], pmin)):
                    raise AssertionError(f"gather_extrema bf16 ({route} "
                                         f"route) at F={F}: kernel differs "
                                         "from its plain version")
        del outs
        a16 = a.to(torch.bfloat16)
        t_k = cuda_ms(lambda: nb.gather_extrema(idx, a, parts=1))
        t_kernel = cuda_ms(lambda: nb._gather_extrema(idx, a16,
                                                      nb.ROUTES["shape"]))
        t_f32 = cuda_ms(lambda: nb.gather_extrema(idx, a, parts=2))
        t_p = cuda_ms(lambda: [nb.gather_extrema_plain(idx[sl], a[sl], 1)
                               for sl in chunks(B)], reps=1)
        del a16
        b_ = B * N * K * 4 + B * N * F * 2 + 2 * B * N * F * 4
        o_ = 2 * B * N * K * F
        details.append({"kernel": "gather_extrema", "route_of_setting": "bf16",
                        "B": B, "N": N, "F": F, "k": K,
                        **nb.gather_extrema_route(N, F, K, parts=1),
                        "bit_equal_both_routes": True, "ms": t_k,
                        "kernel_ms": t_kernel, "f32_route_ms": t_f32,
                        "plain_ms": t_p, "bound_ms": bound_ms(b_, o_)[0]})
        ms, plain, kernel, f32 = ms + t_k, plain + t_p, kernel + t_kernel, \
            f32 + t_f32
        nbytes, ops = nbytes + b_, ops + o_
    bound, by = bound_ms(nbytes, ops)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=None, kernel_ms=kernel,
                f32_route_ms=f32), details


def check_gather_rows_bf16(gr, values, idx):
    """Kernel 8's bf16 route at check_gather_rows's shapes: bit-equal to
    gather_rows_plain on the bf16-rounded values; ``kernel_ms`` on a
    prepared bf16 copy, ``library_ms`` one torch.gather call on the rounded
    values (the same function once they are rounded).  Returns (numbers,
    detail, launches of the route here)."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.ops.precision import round_bf16
    before = launch.LAUNCHES["gather_rows:bf16"]
    got = gr.gather_rows(values, idx, parts=1)
    want = gr.gather_rows_plain(values, idx, parts=1)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("gather_rows bf16: kernel differs from its "
                             "plain version")
    del got, want
    B, N_, F = values.shape
    S, K_ = idx.shape[1], idx.shape[2]
    v16, rounded = values.to(torch.bfloat16), round_bf16(values)
    lidx = idx.reshape(B, -1).long()[..., None].expand(-1, -1, F)
    t_k = cuda_ms(lambda: gr.gather_rows(values, idx, parts=1))
    t_kernel = cuda_ms(lambda: gr.gather_rows(v16, idx))
    t_p = cuda_ms(lambda: gr.gather_rows_plain(values, idx, parts=1))
    t_l = cuda_ms(lambda: torch.gather(rounded, 1, lidx))
    del lidx, v16, rounded
    bound, by = bound_ms(B * N_ * F * 2 + (B * S * K_ + B * S * K_ * F) * 4,
                         0.0)
    detail = {"kernel": "gather_rows", "route_of_setting": "bf16", "B": B,
              "N": N_, "S": S, "K": K_, "F": F, "bit_equal": True, "ms": t_k,
              "kernel_ms": t_kernel, "plain_ms": t_p, "library_ms": t_l,
              "bound_ms": bound}
    return (dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=bound,
                 bound_by=by, library_ms=t_l, kernel_ms=t_kernel), detail,
            launch.LAUNCHES["gather_rows:bf16"] - before)


def one_pass_gap(name, got, emulated, exact, excused=None):
    """Kernel against its emulation at a one-pass setting, beside the
    setting's own rounding (the emulation against the exact f32 version on
    the same gathered values), rows ``excused`` apart: the gap's RMS and
    maximum within ONE_PASS_RMS_SHARE and ONE_PASS_MAX_SHARE of the
    rounding's.  Returns (largest gap, RMS share, share of values beyond
    f32-level agreement: rtol 1e-4, atol 1e-5)."""
    import torch
    if excused is not None:
        got, emulated, exact = got[~excused], emulated[~excused], exact[~excused]
    gap, rounding = (got - emulated).double(), (emulated - exact).double()
    rms = float(gap.square().mean().sqrt() / rounding.square().mean().sqrt())
    top = float(gap.abs().max() / rounding.abs().max())
    if not (rms <= ONE_PASS_RMS_SHARE and top <= ONE_PASS_MAX_SHARE):
        raise AssertionError(
            f"{name}: the kernel's gap to its emulation is {rms} (RMS) and "
            f"{top} (largest) of the setting's own rounding")
    near = torch.isclose(got, emulated, rtol=1e-4, atol=1e-5)
    return float(gap.abs().max()), rms, float((~near).float().mean())


def check_one_pass(gr, fp, masked, ball_details):
    """Kernels 5 and 7 at each one-pass setting of PRECISION_SETTINGS (the
    matmul precision with its gather value parts) on the main path's
    inputs, with the seeded models' weights: the first chunk against the
    kernel's emulation at that setting (``emulation.ball_mlp3_at``,
    ``pointconv_sa_at``) beside the setting's own rounding (``one_pass_gap``;
    kernel 5's rows near a ball boundary excused, as in the kernel phase),
    each launch timed beside the highest setting's in
    the same call.  The bound is the route's: layers 2-3 one pass on TF32
    operands at high and on bf16 ones at default (``one_pass_ops``), kernel
    7's contraction three TF32 passes, over the rows the data needs (kernel
    5's from the kernel phase's count, ``ball_details``)."""
    import torch
    from interpret_quality_tpu_torch.models.common import fold_stack
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    from interpret_quality_tpu_torch.ops.geometry import (compute_density,
                                                          index_points)
    rows = {}
    totals = {(kname, mm): dict(ms=0.0, highest_ms=0.0, plain_ms=0.0,
                                nbytes=0.0, ops=0.0, mops=0.0, one_pass=0.0,
                                max_abs=0.0, rms=0.0, share=0.0)
              for kname in ("fused_ball_mlp3", "fused_pointconv_sa")
              for mm, _ in PRECISION_SETTINGS}
    details = []
    model = seeded_model("pointnet2", masked.device)
    needed = {(d["level"], d["branch"]): d["distinct_slot_rows"]
              for d in ball_details if d["kernel"] == "fused_ball_mlp3"}
    xyz, points = masked, None
    for level, sa in enumerate((model.sa1, model.sa2)):
        new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
        D = 0 if points is None else points.shape[-1]
        outs = []
        for br, (convs, bns, radius, k) in enumerate(zip(
                sa.conv_blocks, sa.bn_blocks, sa.radius_list,
                sa.nsample_list)):
            (a1, b1), (a2, b2), (a3, b3) = fold_stack(convs, bns)
            uf = None if points is None else torch.matmul(points, a1[:D])
            w = (b1, a1[D:], a2, b2, a3, b3)
            sl = next(chunks(xyz.shape[0], BALL_CHUNK))
            edge = near_ball_boundary(new_xyz[sl], xyz[sl], radius)[0]

            def run(mm, parts):
                with precision_setting(mm, parts):
                    return gr.fused_ball_mlp3(new_xyz, xyz, uf, *w,
                                              radius=radius, k=k)
            t_h = cuda_ms(lambda: run("highest", 2))
            B, S, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
            C1, C2, C3 = a2.shape[0], a2.shape[1], a3.shape[1]
            rows_needed = needed[(level + 1, br)]
            b_ = (B * S * 3 + B * n * 3 + (0 if uf is None else B * n * C1)
                  + B * S * C3) * 4
            o_ = 8.0 * B * S * n + rows_needed * (2 * 3 * C1 + 3 * C1)
            m_ = float(rows_needed) * (2 * C1 * C2 + 2 * C2 * C3)
            for mm, parts in PRECISION_SETTINGS:
                got = run(mm, parts)
                chunk = (new_xyz[sl], xyz[sl], None if uf is None else uf[sl],
                         *w)
                emulated = em.ball_mlp3_at(*chunk, radius=radius, k=k,
                                           precision=mm, parts=parts)
                exact = gr.fused_ball_mlp3_plain(*chunk, radius=radius, k=k,
                                                 parts=parts)
                gap, rms, share = one_pass_gap(
                    f"fused_ball_mlp3 {mm} sa{level + 1} branch {br}",
                    got[sl], emulated, exact, edge)
                del got, emulated, exact
                t_k = cuda_ms(lambda: run(mm, parts))
                t_p = cuda_ms(lambda: [em.ball_mlp3_at(
                    new_xyz[c], xyz[c], None if uf is None else uf[c], *w,
                    radius=radius, k=k, precision=mm, parts=parts)
                    for c in chunks(xyz.shape[0], BALL_CHUNK)], reps=1)
                details.append({"kernel": "fused_ball_mlp3", "setting": mm,
                                "gather_parts": parts, "level": level + 1,
                                "branch": br, "ms": t_k, "highest_ms": t_h,
                                "plain_ms": t_p,
                                "bound_ms": bound_ms(
                                    b_, o_, **one_pass_ops(mm, m_))[0],
                                "max_abs_diff_to_emulation_first_chunk": gap,
                                "gap_rms_over_rounding": rms,
                                "beyond_f32_agreement": share})
                tot = totals[("fused_ball_mlp3", mm)]
                tot["ms"] += t_k
                tot["plain_ms"] += t_p
                tot["highest_ms"] += t_h
                tot["nbytes"] += b_
                tot["ops"] += o_
                tot["one_pass"] += m_
                tot["max_abs"] = max(tot["max_abs"], gap)
                tot["rms"] = max(tot["rms"], rms)
                tot["share"] = max(tot["share"], share)
            outs.append(run("highest", 2))
            del uf, edge
        xyz, points = new_xyz, torch.cat(outs, dim=-1)
        del outs
    del model, xyz, points
    torch.cuda.empty_cache()

    model = seeded_model("pointconv", masked.device)
    xyz, points = masked, None
    for level, sa in enumerate((model.sa1, model.sa2)):
        inv = 1.0 / compute_density(xyz, sa.bandwidth)
        new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
        k = sa.nsample
        idx, den, dmax = gr.knn_with_density(new_xyz, xyz, inv, k)
        (a1, b1), (a2, b2), (a3, b3) = fold_stack(sa.mlp_convs, sa.mlp_bns)
        src = xyz if points is None else torch.cat([xyz, points], dim=-1)
        u = torch.matmul(src, a1) + b1
        csw = torch.matmul(new_xyz, a1[:3])
        dnet = fold_stack(sa.densitynet.mlp_convs, sa.densitynet.mlp_bns)
        wnet = fold_stack(sa.weightnet.mlp_convs, sa.weightnet.mlp_bns)
        per_cloud = (idx, den, dmax, new_xyz, u, xyz, csw)
        w = (a2, b2, a3, b3, dnet, wnet)
        sl = next(chunks(xyz.shape[0], PCONV_CHUNK))

        def run(mm, parts):
            with precision_setting(mm, parts):
                return gr.fused_pointconv_sa(*per_cloud, *w, k=k)
        t_h = cuda_ms(lambda: run("highest", 2))
        B, S, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
        C1, C2, C3 = a2.shape[0], a2.shape[1], a3.shape[1]
        b_ = (B * S * k * 3 + B * S * 1 + B * S * 3 + B * n * C1 + B * n * 3
              + B * S * C1 + B * S * C3 * 16) * 4
        o_ = float(B * S * k * (2 * C1 + C3 + 2 * (3 * 8 + 8 * 8 + 8 * 16)))
        # layers 2-3 one pass, the contraction three
        m_ = float(B * S * k) * (2 * C1 * C2 + 2 * C2 * C3)
        c_ = float(B * S * k) * 2 * 16 * C3
        for mm, parts in PRECISION_SETTINGS:
            got = run(mm, parts)
            chunk = [t[sl] for t in per_cloud]
            emulated = em.pointconv_sa_at(*chunk, *w, k=k, precision=mm,
                                          parts=parts)
            exact = gr.fused_pointconv_sa_plain(*chunk, *w, k=k, parts=parts)
            gap, rms, share = one_pass_gap(
                f"fused_pointconv_sa {mm} sa{level + 1}", got[sl], emulated,
                exact)
            del got, emulated, exact
            t_k = cuda_ms(lambda: run(mm, parts))
            t_p = cuda_ms(lambda: [em.pointconv_sa_at(
                *[t[c] for t in per_cloud], *w, k=k, precision=mm,
                parts=parts) for c in chunks(B, PCONV_CHUNK)], reps=1)
            details.append({"kernel": "fused_pointconv_sa", "setting": mm,
                            "gather_parts": parts, "level": level + 1,
                            "ms": t_k, "highest_ms": t_h, "plain_ms": t_p,
                            "bound_ms": bound_ms(
                                b_, o_, c_, **one_pass_ops(mm, m_))[0],
                            "max_abs_diff_to_emulation_first_chunk": gap,
                            "gap_rms_over_rounding": rms,
                            "beyond_f32_agreement": share})
            tot = totals[("fused_pointconv_sa", mm)]
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            tot["highest_ms"] += t_h
            tot["nbytes"] += b_
            tot["ops"] += o_
            tot["mops"] += c_
            tot["one_pass"] += m_
            tot["max_abs"] = max(tot["max_abs"], gap)
            tot["rms"] = max(tot["rms"], rms)
            tot["share"] = max(tot["share"], share)
        xyz, points = new_xyz, sa._head(run("highest", 2))
        del u, per_cloud, inv, idx, den, dmax
    for (kname, mm), tot in totals.items():
        bound, by = bound_ms(tot["nbytes"], tot["ops"], tot["mops"],
                             **one_pass_ops(mm, tot["one_pass"]))
        # plain_ms: the emulation, the plain PyTorch version of the
        # setting's arithmetic, over every chunk
        rows[(kname, mm)] = dict(max_abs_err=tot["max_abs"], ms=tot["ms"],
                                 plain_ms=tot["plain_ms"],
                                 highest_ms=tot["highest_ms"],
                                 bound_ms=bound, bound_by=by, library_ms=None,
                                 gap_rms_over_rounding=tot["rms"],
                                 beyond_f32_agreement=tot["share"])
    return rows, details


def model_from_state(name, state, device):
    """A family's model with ``state`` loaded strictly, in eval mode."""
    from interpret_quality_tpu_torch.models import build_model
    model = build_model(name, 10, K)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def trained_model(name, ck, device):
    """The train phase's model_best.t7 of a family, in eval mode."""
    import torch
    from interpret_quality_tpu_torch.config import ExperimentConfig
    path = ExperimentConfig(model=name, checkpoints_root=ck,
                            num_points=N).default_model_path()
    return model_from_state(name, torch.load(path, map_location="cpu"),
                            device)


def train_on(name, model, workdir):
    """Train ``model`` on, in place, for PRECISION_MORE_EPOCHS epochs on the
    train phase's synthetic clouds, as cli.train trains (batch 32, the
    family's schedule over those epochs, seed 1); its run.log under
    ``workdir``.  Returns the model in eval mode."""
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.train import trainer
    from interpret_quality_tpu_torch.utils.io import IOStream
    from interpret_quality_tpu_torch.utils.rng import set_random
    set_random(1)
    exp = os.path.join(workdir, name)
    os.makedirs(exp, exist_ok=True)
    train_ds = SyntheticClouds(num_samples=TRAIN_SAMPLES, num_points=N,
                               seed=1, train=True)
    test_ds = SyntheticClouds(num_samples=TRAIN_TEST_SAMPLES, num_points=N,
                              seed=2)
    with IOStream(os.path.join(exp, "run.log")) as io:
        trainer.fit(model, name, train_ds, test_ds, exp_dir=exp, io=io,
                    epochs=PRECISION_MORE_EPOCHS, best_acc_gate=0.0)
    return model.eval()


def precision_shapley(device, ck, workdir):
    """Per family, synthetic cloud 0's Shapley values (R FPS regions,
    PRECISION_ORDERS orders in chunks of ORDERS) through the train phase's
    checkpoint (under ``ck``; trained on first where its exact values' RMS
    is below PRECISION_MIN_SHAPLEY_RMS, ``train_on``) at each setting of
    PRECISION_SETTINGS against the exact one, on the same region ids (the
    highest setting's) and orders: the deviation over the estimator's own
    standard error at these orders (RMS over the regions, from the exact
    run's per-order marginals) must stay below 1.  Each run follows a
    one-chunk warm-up at its setting and is timed (forwards/s); the counts
    are set to 0 just before each setting's runs and read just after.
    Returns (record, launches by setting, the models' states, the seconds
    spent training, the checks that failed)."""
    import torch
    from interpret_quality_tpu_torch.attrib.shapley import (
        ShapleyEngine, generate_all_orders, region_id_from_fps)
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.models import make_forward_fn
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.ops.geometry import farthest_point_sample
    data, label = SyntheticClouds(30, N, 10, seed=1)[0]
    x = torch.from_numpy(data).to(device)
    centres = farthest_point_sample(x[None], R)[0]
    region_id = region_id_from_fps(x, centres)
    rid = region_id.cpu().numpy()
    orders = generate_all_orders(PRECISION_ORDERS, R,
                                 rng=np.random.RandomState(5))
    forwards = PRECISION_ORDERS * (R + 1)
    launches = {mm: {} for mm, _ in PRECISION_SETTINGS}
    out, states, failed, train_s = {}, {}, [], 0.0

    def run(model):
        engine = ShapleyEngine(make_forward_fn(model), R,
                               batch_orders=ORDERS, device=device)
        engine.shapley_for_pose(data, label, rid, orders[:ORDERS])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv, per = engine.shapley_for_pose(data, label, rid, orders,
                                          return_per_order=True)
        return sv, per, forwards / (time.perf_counter() - t0)
    for name in PRECISION_FAMILIES:
        model = trained_model(name, ck, device)
        sv_h, per_h, rate_h = run(model)
        rec = {"epochs": TRAIN_EPOCHS,
               "train_phase_shapley_rms": float(np.sqrt((sv_h ** 2).mean()))}
        if rec["train_phase_shapley_rms"] < PRECISION_MIN_SHAPLEY_RMS:
            t0 = time.perf_counter()
            model = train_on(name, model, workdir)
            train_s += time.perf_counter() - t0
            rec["epochs"] += PRECISION_MORE_EPOCHS
            sv_h, per_h, rate_h = run(model)
        states[name] = {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}
        se = per_h.std(0, ddof=1) / np.sqrt(PRECISION_ORDERS)
        rec.update({"highest_forwards_per_s": rate_h,
                    "se_rms": float(np.sqrt((se ** 2).mean())),
                    "shapley_rms": float(np.sqrt((sv_h ** 2).mean()))})
        if not rec["shapley_rms"] >= PRECISION_MIN_SHAPLEY_RMS:
            failed.append(f"{name}: Shapley values of RMS "
                          f"{rec['shapley_rms']} after {rec['epochs']} "
                          "epochs, too small to hold a setting to")
        for mm, parts in PRECISION_SETTINGS:
            with precision_setting(mm, parts):
                launch.reset_launches()
                sv, per, rate = run(model)
                ids = region_id_from_fps(x, centres)
                for key, v in launch.LAUNCHES.items():
                    launches[mm][key] = launches[mm].get(key, 0) + v
            dev = sv - sv_h
            spread, moved = np.sqrt((se ** 2).mean()), np.sqrt((dev ** 2).mean())
            ratio = float(moved / spread) if spread > 0 else (
                0.0 if moved == 0 else np.inf)
            if not ratio < 1.0:
                failed.append(f"{name} Shapley values at {mm}: deviation "
                              f"{ratio} of the estimator's standard error at "
                              f"{PRECISION_ORDERS} orders")
            rec[mm] = {"gather_parts": parts, "forwards_per_s": rate,
                       "deviation_over_se": ratio,
                       # per order: how much of the deviation averages out
                       "per_order_deviation_rms": float(np.sqrt(
                           ((per - per_h) ** 2).mean())),
                       "max_region_deviation_over_se": float(
                           (np.abs(dev)[se > 0] / se[se > 0]).max(
                               initial=0.0)),
                       "max_abs_deviation": float(np.abs(dev).max()),
                       "region_ids_equal_share": float(
                           (ids == region_id).float().mean())}
        out[name] = rec
        del model
        torch.cuda.empty_cache()
    need = {"default": ("gather_extrema:bf16", "fused_ball_mlp3:default",
                        "fused_pointconv_sa:default", "dense_pool:default",
                        "knn_gather_extrema", "gather_extrema", "knn", "fps",
                        "knn_with_density"),
            "high": ("fused_ball_mlp3:high", "fused_pointconv_sa:high",
                     "dense_pool:high")}
    for mm, keys in need.items():
        own = (f":{mm}",) + ((":bf16",) if dict(PRECISION_SETTINGS)[mm] == 1
                             else ())
        missing = [key for key in keys if not launches[mm].get(key)]
        stray = [key for key, v in launches[mm].items()
                 if v and ":" in key and not key.endswith(own)]
        if missing or stray:
            failed.append(f"the {mm} run launched {launches[mm]}: missing "
                          f"{missing}, other settings {stray}")
    out["launches"] = {mm: {k: v for k, v in c.items() if v}
                       for mm, c in launches.items()}
    return out, launches, states, train_s, failed


@contextlib.contextmanager
def planted_fault(fault):
    """``ops.precision.PrecisionMatmul``'s backward with a fault planted in
    it for a block (None: the right one): ``no_input_grad`` drops the
    gradient of the left operand, ``no_weight_grad`` that of the right one,
    ``weight_grad_half_rows`` takes a 2-d right operand's gradient over the
    first half of the rows only."""
    import torch
    from interpret_quality_tpu_torch.ops import precision as pr
    right = pr.PrecisionMatmul.backward

    def backward(ctx, grad):
        gx, gw, _ = right(ctx, grad)
        x, w = ctx.saved_tensors
        if fault == "no_input_grad" and gx is not None:
            gx = torch.zeros_like(gx)
        elif fault == "no_weight_grad" and gw is not None:
            gw = torch.zeros_like(gw)
        elif fault == "weight_grad_half_rows" and gw is not None \
                and w.dim() == 2:
            rows = x.reshape(-1, x.shape[-1])
            half = rows.shape[0] // 2
            gw = pr._product(ctx.product, rows[:half].transpose(0, 1),
                             grad.reshape(-1, grad.shape[-1])[:half])
        return gx, gw, None
    if fault is not None:
        pr.PrecisionMatmul.backward = staticmethod(backward)
    try:
        yield
    finally:
        pr.PrecisionMatmul.backward = staticmethod(right)


def grad_cosine(got, want) -> float:
    """Cosine of two gradients, every parameter as one float64 vector."""
    import torch
    a = torch.cat([got[p].flatten() for p in want]).double()
    b = torch.cat([g.flatten() for g in want.values()]).double()
    return float(torch.dot(a, b) / (a.norm() * b.norm()))


def precision_train_step(device, states):
    """One train step of each of PRECISION_STEP_MODELS from the precision
    phase's model (``states``; dropouts off, the grid batch at N points:
    GCNN's xyz graph, from the kNN kernel, the same at every setting) at
    default with bf16 gathers against the same step at the exact settings:
    the loss within PRECISION_STEP_LOSS_REL, the gradient (all parameters
    as one vector) at a cosine of at least PRECISION_STEP_COS, and each
    fault of PRECISION_STEP_FAULTS planted at default below it; the
    relative gap and the worst single tensor (gap over its norm plus
    STEP_GRAD_FLOOR of the largest norm) are reported."""
    import torch
    x, labels = grid_batch(N, 0)
    out, failed = {}, []
    for name in PRECISION_STEP_MODELS:
        def step(mm, parts, fault=None):
            with precision_setting(mm, parts), planted_fault(fault):
                model = dropouts_off(model_from_state(
                    name, states[name], device).train())
                loss, logits = one_train_step(
                    name, model, torch.from_numpy(x).to(device),
                    torch.from_numpy(labels).to(device))
                return (float(loss), logits.cpu(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()})
        l_h, lg_h, g_h = step("highest", 2)
        l_d, lg_d, g_d = step("default", 1)
        loss_rel = abs(l_d - l_h) / abs(l_h)
        floor = STEP_GRAD_FLOOR * max(float(g.norm()) for g in g_h.values())
        worst, worst_name = 0.0, None
        for pname, want in g_h.items():
            err = float((g_d[pname] - want).norm())
            rel = err / (float(want.norm()) + floor)
            if rel > worst:
                worst, worst_name = rel, pname
        flat_h = torch.cat([g.flatten() for g in g_h.values()])
        flat_d = torch.cat([g_d[p].flatten() for p in g_h])
        grad_rel = float((flat_d - flat_h).norm() / flat_h.norm())
        cos = grad_cosine(g_d, g_h)
        if not (loss_rel <= PRECISION_STEP_LOSS_REL
                and cos >= PRECISION_STEP_COS):
            failed.append(f"{name} train step at default: loss {loss_rel} "
                          f"apart, gradient cosine {cos}")
        faults = {f: grad_cosine(step("default", 1, f)[2], g_h)
                  for f in PRECISION_STEP_FAULTS}
        for fault, c in faults.items():
            if not c < PRECISION_STEP_COS:
                failed.append(f"{name} train step at default with the fault "
                              f"{fault} planted: gradient cosine {c} passes "
                              f"the limit {PRECISION_STEP_COS}")
        out[name] = {"loss_rel_diff": loss_rel,
                     "logits_max_abs_diff": float((lg_d - lg_h).abs().max()),
                     "logits_max_abs": float(lg_h.abs().max()),
                     "grad_cosine": cos, "grad_rel_err": grad_rel,
                     "worst_tensor_rel_err_with_floor": worst,
                     "worst_tensor": worst_name,
                     "planted_fault_grad_cosines": faults}
    return out, failed


def run_precision(device, ball_details, ck):
    """The precision phase, after the train phase: the routes of the
    non-exact settings against their plain versions and emulations at the
    main path's shapes, each family's Shapley values at those settings
    against the exact ones through the train phase's checkpoints (under
    ``ck``), and one train step at default.  Returns (record, kernels-line
    rows, the checks that failed, the models' states)."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import fps as fp
    from interpret_quality_tpu_torch.ops.cuda import groups as gr
    from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
    t0 = time.perf_counter()
    masked = coalition_batch(device)
    with torch.inference_mode():
        inputs = layer_inputs(masked, device)
        layers, idx = inputs["gcnn"]
        k2, d2 = check_gather_bf16(nb, layers, idx)
        k8, d8, k8_launches = check_gather_rows_bf16(
            gr, layers[1][0].contiguous(), idx)
        del inputs, layers, idx
        torch.cuda.empty_cache()
        one_pass, d57 = check_one_pass(gr, fp, masked, ball_details)
        del masked
        torch.cuda.empty_cache()
    kernel_s = time.perf_counter() - t0
    shapley, launches, states, train_s, failed = precision_shapley(
        device, ck, os.path.join(ck, "precision"))
    train, step_failed = precision_train_step(device, states)
    torch.cuda.empty_cache()
    rows = {"gather_extrema:bf16": (k2, launches["default"].get(
                "gather_extrema:bf16", 0)),
            "gather_rows:bf16": (dict(k8, kernel_phase_launches=k8_launches,
                                      off_path=OFF_PATH["gather_rows"]), 0)}
    for (kname, mm), numbers in one_pass.items():
        rows[f"{kname}:{mm}"] = (numbers, launches[mm].get(f"{kname}:{mm}", 0))
    record = {"kernel_checks_s": kernel_s, "checkpoints_train_s": train_s,
              "shapley": shapley, "train_step_default": train,
              "details": d2 + [d8] + d57,
              "seconds": time.perf_counter() - t0,
              "orders": PRECISION_ORDERS, "settings": PRECISION_SETTINGS}
    return record, rows, failed + step_failed, states


# --------------------------------------------------------------- selection
@contextlib.contextmanager
def knn_env(**settings):
    """The kNN selection variables set for a block, unset after it."""
    for key, value in settings.items():
        os.environ[key] = value
    try:
        yield
    finally:
        for key in settings:
            os.environ.pop(key, None)


def check_truncation(nb, gr, device):
    """JAX's truncation example through kernels 1 (one channel, as there)
    and 6 (padded to 3 channels with zeros, which leaves every distance as
    it was), each route forced, at every class: TRUNCATION_ORDER."""
    import torch
    x = torch.tensor(TRUNCATION_X, device=device)[None, :, None]
    db3 = torch.cat([x, torch.zeros(1, 8, 2, device=device)], -1)
    inv = torch.ones(1, 8, device=device)
    got = {}
    for cls, want in TRUNCATION_ORDER.items():
        for rname in ("xyz", "tiled"):
            route = nb.KNN_ROUTES[rname]
            for kernel, idx in (
                    ("knn", nb._knn(torch.zeros_like(x), x, 4, route, cls)),
                    ("knn_with_density", gr._knn_with_density(
                        torch.zeros_like(db3), db3, inv, 4, route, cls)[0])):
                got[f"{kernel}:{cls}:{rname}"] = idx[0, 0].tolist()
                if idx[0, 0].tolist() != want:
                    raise AssertionError(f"{kernel} ({rname} route) at {cls} "
                                         f"on the truncation example: "
                                         f"{idx[0, 0].tolist()}, not {want}")
    return got


def check_nq_layout(nb, xs, a):
    """IQTPU_KNN_LAYOUT=nq: kernel 3 through its wrapper takes the packed
    class whatever IQTPU_KNN_SELECT says (the JAX package's nq twin sweeps
    packed keys only), bit-equal to the packed launch, and counts as it."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import launch
    want = nb._knn_gather_extrema(xs, a, K, 2, "packed")
    out = {}
    for select in ("two_pass", "bf16", "packed"):
        with knn_env(IQTPU_KNN_SELECT=select, IQTPU_KNN_LAYOUT="nq"):
            before = launch.LAUNCHES["knn_gather_extrema:packed"]
            got = nb.knn_gather_extrema(xs, a, K)
            counted = launch.LAUNCHES["knn_gather_extrema:packed"] - before
        if not (all(torch.equal(g, w) for g, w in zip(got, want))
                and counted == 1):
            raise AssertionError(f"knn_gather_extrema at layout nq with "
                                 f"IQTPU_KNN_SELECT={select}: not the packed "
                                 f"class ({counted} packed launches)")
        out[select] = "packed"
    return out


def check_density_selection(gr, fp, model, masked, select, device):
    """Kernel 6 at both PointConv levels at the setting ``select`` (its
    class ``cls``): both routes forced bit-equal to each other and to the
    route the shape takes; on an exact-duplicate cloud equal to its plain
    version at the class; on the masked batch within selection_gap's row
    limit of it, a planted fault beyond that limit, densities bit-equal
    where the index rows are."""
    import torch
    from interpret_quality_tpu_torch.config import knn_select_class
    from interpret_quality_tpu_torch.ops.geometry import (compute_density,
                                                          index_points)
    cls = knn_select_class(select)
    ms = plain = nbytes = ops = max_abs = 0.0
    levels = []
    dup = duplicate_cloud(33, N, 3, 2, device)
    for cloud_name, cloud in (("duplicate", dup), ("masked", masked)):
        xyz = cloud
        for level, sa in enumerate((model.sa1, model.sa2)):
            inv = 1.0 / compute_density(xyz, sa.bandwidth)
            new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
            k = sa.nsample
            out = gr.knn_with_density(new_xyz, xyz, inv, k, select=select)
            forced = route_outputs(lambda r: gr._knn_with_density(
                new_xyz, xyz, inv, k, r, cls),
                f"knn_with_density sa{level + 1} at {cls}")
            if not all(torch.equal(a, b) for a, b in zip(forced, out)):
                raise AssertionError(f"knn_with_density at {cls}: the route "
                                     "the shape takes differs from the same "
                                     "route forced")

            def plain_on(sl):
                return gr.knn_with_density_plain(new_xyz[sl], xyz[sl],
                                                 inv[sl], k, cls)
            if cloud_name == "duplicate":
                if not all(torch.equal(a, b) for a, b in zip(
                        out, plain_on(slice(None)))):
                    raise AssertionError(f"knn_with_density sa{level + 1} at "
                                         f"{cls}: differs from its plain "
                                         "version on an exact-duplicate "
                                         "cloud")
                xyz = new_xyz
                continue
            exact = gr.knn_with_density(new_xyz, xyz, inv, k,
                                        select="two_pass")[0]
            g_abs, g_rel, over, fault, plain_share, exact_share, same = \
                selection_rows(new_xyz, xyz, out[0],
                               lambda sl: plain_on(sl)[0], exact, cls)
            for sl, rows in zip(chunks(xyz.shape[0]), same):
                if not torch.equal(out[1][sl][rows], plain_on(sl)[1][rows]):
                    raise AssertionError(f"knn_with_density at {cls}: "
                                         "densities differ where the "
                                         "neighbours agree")
            max_abs = max(max_abs, g_abs)
            ms += cuda_ms(lambda: gr.knn_with_density(new_xyz, xyz, inv, k,
                                                      select=select))
            plain += cuda_ms(lambda: [plain_on(sl) for sl in
                                      chunks(xyz.shape[0])], reps=1)
            B, S, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
            nbytes += (B * S * 3 + B * n * 3 + B * n + 2 * B * S * k
                       + B * S) * 4
            ops += distinct_row_count(new_xyz) * n * (2 * 3 + 3 + key_ops(cls))
            levels.append({"level": level + 1, "S": S, "N": n, "k": k,
                           "rows_differing_from_plain": plain_share,
                           "rows_differing_from_two_pass": exact_share,
                           "max_rel_selected_dist_err": g_rel,
                           "width": selection_width(cls, n),
                           "gap_over_limit": over,
                           "fault_gap_over_limit": fault})
            xyz = new_xyz
    bound, by = bound_ms(nbytes, ops)
    detail = {"kernel": row_name("knn_with_density", cls), "ms": ms,
              "plain_ms": plain, "bound_ms": bound, "routes_bit_equal": True,
              "duplicate_cloud_equal": True, "levels": levels}
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by), detail


def selection_shapley(device, states):
    """Per family of SELECTION_FAMILIES, synthetic cloud 0's Shapley values
    through the precision phase's models (``states``) at each setting of
    SELECTION_SETTINGS (IQTPU_KNN_SELECT set for the run) against the exact
    ones on the same regions and orders: the deviation over the estimator's
    standard error must stay below 1, as in precision_shapley.  Each run
    follows a one-chunk warm-up and is timed (forwards/s); the counts are
    set to 0 just before each setting's runs and read just after.  Returns
    (record, launches by class, the checks that failed)."""
    import torch
    from interpret_quality_tpu_torch.config import knn_select_class
    from interpret_quality_tpu_torch.attrib.shapley import (
        ShapleyEngine, generate_all_orders, region_id_from_fps)
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.models import make_forward_fn
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.ops.geometry import farthest_point_sample
    data, label = SyntheticClouds(30, N, 10, seed=1)[0]
    x = torch.from_numpy(data).to(device)
    rid = region_id_from_fps(x, farthest_point_sample(x[None], R)[0]
                             ).cpu().numpy()
    orders = generate_all_orders(SELECTION_ORDERS, R,
                                 rng=np.random.RandomState(6))
    forwards = SELECTION_ORDERS * (R + 1)
    classes = {select: knn_select_class(select)
               for select in SELECTION_SETTINGS}
    launches = {cls: {} for cls in classes.values()}
    out, failed = {}, []

    def run(model):
        engine = ShapleyEngine(make_forward_fn(model), R,
                               batch_orders=ORDERS, device=device)
        engine.shapley_for_pose(data, label, rid, orders[:ORDERS])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv, per = engine.shapley_for_pose(data, label, rid, orders,
                                          return_per_order=True)
        return sv, per, forwards / (time.perf_counter() - t0)
    for name in SELECTION_FAMILIES:
        model = model_from_state(name, states[name], device)
        sv_e, per_e, rate_e = run(model)
        se = per_e.std(0, ddof=1) / np.sqrt(SELECTION_ORDERS)
        spread = np.sqrt((se ** 2).mean())
        rec = {"two_pass_forwards_per_s": rate_e, "se_rms": float(spread),
               "shapley_rms": float(np.sqrt((sv_e ** 2).mean()))}
        for select, cls in classes.items():
            with knn_env(IQTPU_KNN_SELECT=select):
                launch.reset_launches()
                sv, per, rate = run(model)
                for key, v in launch.LAUNCHES.items():
                    launches[cls][key] = launches[cls].get(key, 0) + v
            dev = sv - sv_e
            moved = np.sqrt((dev ** 2).mean())
            ratio = float(moved / spread) if spread > 0 else (
                0.0 if moved == 0 else np.inf)
            if not ratio < 1.0:
                failed.append(f"{name} Shapley values at {cls}: deviation "
                              f"{ratio} of the estimator's standard error")
            rec[cls] = {"forwards_per_s": rate, "deviation_over_se": ratio,
                        "orders_moved": int((np.abs(per - per_e) > 0).any(
                            -1).sum()),
                        "max_abs_deviation": float(np.abs(dev).max())}
        out[name] = rec
        del model
        torch.cuda.empty_cache()
    need = ("knn", "knn_gather_extrema", "knn_with_density")
    for cls in classes.values():
        missing = [f"{k}:{cls}" for k in need
                   if not launches[cls].get(f"{k}:{cls}")]
        stray = [k for k, v in launches[cls].items()
                 if v and ":" in k and not k.endswith(f":{cls}")]
        if missing or stray:
            failed.append(f"the {cls} runs launched {launches[cls]}: missing "
                          f"{missing}, other routes {stray}")
    out["launches"] = {cls: {k: v for k, v in c.items() if v}
                       for cls, c in launches.items()}
    return out, launches, failed


def selection_train_step(device):
    """One DGCNN train step (dropouts off, a grid batch at N points) with
    IQTPU_KNN_SELECT=packed against the same step without it, from the same
    weights, with deterministic algorithms on: the training graphs are
    exact at every setting, so no route of another class may launch and
    the loss, logits, gradients and running statistics must be bit-equal.
    The step without the variable runs twice (the second a control of the
    step's own determinism)."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import launch
    x, labels = grid_batch(N, 0)
    x = torch.from_numpy(x).to(device)
    labels = torch.from_numpy(labels).to(device)

    def step():
        model = dropouts_off(seeded_model("dgcnn", device).train())
        loss, logits = one_train_step("dgcnn", model, x, labels)
        return [loss, logits] + [p.grad for p in model.parameters()] + [
            b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        launch.reset_launches()
        exact = step()
        control = step()
        with knn_env(IQTPU_KNN_SELECT="packed"):
            packed = step()
        routes = {k: v for k, v in launch.LAUNCHES.items()
                  if v and k not in launch.KERNELS}
    finally:
        torch.use_deterministic_algorithms(False)
    rec = {"control_bit_equal": all(torch.equal(a, b)
                                    for a, b in zip(exact, control)),
           "packed_bit_equal": all(torch.equal(a, b)
                                   for a, b in zip(exact, packed)),
           "tensors": len(exact), "knn_launches": launch.LAUNCHES["knn"],
           "route_launches": routes}
    failed = []
    if not rec["control_bit_equal"]:
        failed.append(f"a DGCNN train step differs from itself run again: "
                      f"{rec}")
    if routes or not rec["packed_bit_equal"]:
        failed.append(f"a DGCNN train step with IQTPU_KNN_SELECT=packed: "
                      f"{rec}")
    return rec, failed


def run_selection(device, states):
    """The selection phase, after the precision phase (whose trained-on
    models, ``states``, it reuses): kernels 1, 3 and 6 at each setting of
    SELECTION_SETTINGS at the main path's shapes, the truncation example,
    the nq layout, the Shapley values of SELECTION_FAMILIES at each
    setting, and a DGCNN train step with the variable set.  Returns
    (record, kernels-line rows by kernel and class, the checks that
    failed)."""
    import torch
    from interpret_quality_tpu_torch.config import knn_select_class
    from interpret_quality_tpu_torch.ops.cuda import fps as fp
    from interpret_quality_tpu_torch.ops.cuda import groups as gr
    from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
    t0 = time.perf_counter()
    masked = coalition_batch(device)
    numbers, details = {}, []
    with torch.inference_mode():
        truncation = check_truncation(nb, gr, device)
        layers = layer_inputs(masked, device)["dgcnn"][0]
        nq = check_nq_layout(nb, *layers[1])
        pconv = seeded_model("pointconv", device)
        for select in SELECTION_SETTINGS:
            cls = knn_select_class(select)
            _, numbers[f"knn:{cls}"], d1 = check_knn(nb, masked, device,
                                                     select)
            numbers[f"knn_gather_extrema:{cls}"], d3 = check_fused(
                nb, layers, select)
            numbers[f"knn_with_density:{cls}"], d6 = check_density_selection(
                gr, fp, pconv, masked, select, device)
            details += d1 + d3 + [d6]
            torch.cuda.empty_cache()
        del layers, pconv, masked
        torch.cuda.empty_cache()
    kernel_s = time.perf_counter() - t0
    shapley, launches, failed = selection_shapley(device, states)
    train, step_failed = selection_train_step(device)
    torch.cuda.empty_cache()
    rows = {name: (row, launches[name.split(":")[1]].get(name, 0))
            for name, row in numbers.items()}
    record = {"kernel_checks_s": kernel_s, "truncation": truncation,
              "nq_layout": nq, "shapley": shapley,
              "train_step_packed": train, "details": details,
              "seconds": time.perf_counter() - t0,
              "orders": SELECTION_ORDERS, "settings": SELECTION_SETTINGS}
    return record, rows, failed + step_failed


# --------------------------------------------------------------- main path
def stage_rate(log_path: str, prefix: str):
    with open(log_path) as f:
        for line in f:
            if line.startswith("{") and f'"stage": "{prefix}' in line:
                rec = json.loads(line)
                return rec["items"], rec["seconds"], rec["items_per_sec"]
    raise AssertionError(f"no StageTimer line {prefix!r} in {log_path}")


def main_path():
    """(stage, CLI, argv) of the main path, in order.  The enumerated
    families run two clouds, so that the tables' spread over samples is
    defined; the results stage reads what they wrote."""
    one, two = ["--samples", "0"], ["--samples", RESULT_SAMPLES]
    spec = [("save_fps", "save_fps", ["--model", "dgcnn", *one])]
    for model, orders in INIT_ORDERS.items():
        samples = two if model in ENUM_MODELS else one
        spec.append((f"shapley_init_{model}", "shapley_value",
                     ["--model", model, "--num_samples_save", str(orders),
                      *samples]))
        if model in ENUM_MODELS:
            spec.append((f"enum_trans_{model}", "enum", [
                "--model", model, "--mode", "trans", "--num_samples_save",
                str(orders), "--num_samples", str(orders), "--max_poses",
                str(POSES), *samples]))
    inter = ["--mode", "trans", "--ratio", *INTER_RATIOS, *one]
    for model in INTERACTION_MODELS:
        spec += [(f"gen_pair_{model}", "gen_pair", [
                     "--model", model, *inter, "--num_pairs_random",
                     str(INTER_PAIRS)]),
                 (f"interaction_logits_{model}", "interaction_logits",
                  ["--model", model, *inter]),
                 (f"cal_interactions_{model}", "cal_interactions",
                  ["--model", model, *inter])]
    spec.append(("smoothness_enum_dgcnn", "smoothness_enum", [
        "--model", "dgcnn", "--modes", "linearity", "--max_epochs",
        str(SMOOTH_EPOCHS), "--num_samples", str(INIT_ORDERS["dgcnn"]), *one]))
    for model in ENUM_MODELS:
        for mode in RESULT_MODES:
            spec.append((f"result_{mode}_{model}", "result",
                         ["--model", model, "--result_mode", mode, *two]))
    return spec


def table_numbers(text: str):
    """The lines cli.result printed and the numbers in them (after the
    dash: mean and spread over the samples); raises unless there is at
    least one line and every number is finite."""
    lines = [line for line in text.splitlines() if line.startswith("model: ")]
    values = [float(v) for line in lines
              for v in TABLE_NUMBER.findall(line.split("\u2014", 1)[-1])]
    if not lines or len(values) != 2 * len(lines) or \
            not np.isfinite(values).all():
        raise AssertionError(f"result printed {text!r}")
    return {"lines": lines, "values": values}


def run_main_path(workdir):
    """The CLIs a user runs, in order; every count is set to 0 just before.
    Returns (launches over the whole path, per-stage seconds and launches,
    forwards/s per stage, efficiency errors)."""
    import importlib

    import torch
    from interpret_quality_tpu_torch.config import ExperimentConfig
    from interpret_quality_tpu_torch.ops.cuda import launch
    common = ["--synthetic", "--allow_random_init", "--device", "cuda",
              "--checkpoints_root", workdir + "/ck",
              "--num_points", str(N), "--num_regions", str(R)]
    spec = main_path()
    launch.reset_launches()
    stages, tables, prev = {}, {}, launch.launches()
    for stage, cli, argv in spec:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            importlib.import_module(
                f"interpret_quality_tpu_torch.cli.{cli}").main(argv + common)
        torch.cuda.synchronize()
        now = launch.launches()
        stages[stage] = {"seconds": time.perf_counter() - t0,
                         "launches": {k: now[k] - prev[k] for k in now}}
        prev = now
        sys.stderr.write(out.getvalue())
        if cli == "result":
            tables[stage] = table_numbers(out.getvalue())
    total = launch.launches()
    missing = [k for k, v in total.items() if v == 0 and k not in OFF_PATH]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # artifacts: finite, of the expected shapes
    def folder(model):
        return ExperimentConfig(model=model, checkpoints_root=workdir + "/ck",
                                num_points=N, num_regions=R).exp_folder \
            + "synthetic_00/"
    fps = np.load(os.path.join(workdir, f"fps_modelnet10_{N}_{R}_index_final30.npy"))
    if fps.shape != (30, R) or not (fps[:, 0] == 0).all():
        raise AssertionError(f"fps indices: {fps.shape}")
    expect = {}
    for model, orders in INIT_ORDERS.items():
        expect[(folder(model), "region_sv_all.npy")] = (orders, R)
        expect[(folder(model), "region_id.npy")] = (N,)
        expect[(folder(model), "norm_factor.npy")] = ()
        expect[(folder(model), f"region_shapley/0_{orders}.npy")] = (R,)
    for model in ENUM_MODELS:
        expect[(folder(model), "trans_all/region_shapley_value.npy")] = (POSES, R)
        expect[(folder(model), "trans_all/orig_shapley_value.npy")] = (R,)
    for (d, f), shape in expect.items():
        arr = np.load(d + f)
        if arr.shape != shape or not np.isfinite(arr).all():
            raise AssertionError(f"{d + f}: shape {arr.shape}, want {shape}, "
                                 f"finite {np.isfinite(arr).all()}")
    for model in ENUM_MODELS:
        logits = torch.load(folder(model) + "trans_all/all_logits.pt")
        want = (POSES, INIT_ORDERS[model] * (R + 1), 10)
        if tuple(logits.shape) != want or not torch.isfinite(logits).all():
            raise AssertionError(f"{model} all_logits.pt: {tuple(logits.shape)}")
    # efficiency: every single-order estimate sums to v(N) - v(empty)
    efficiency = {}
    for model in INIT_ORDERS:
        sv_all = np.load(folder(model) + "region_sv_all.npy")
        nf = float(np.load(folder(model) + "norm_factor.npy"))
        err = float(np.abs(sv_all.sum(1) - nf).max())
        if err > 5e-3 * max(1.0, abs(nf)):
            raise AssertionError(f"{model}: efficiency off by {err}")
        efficiency[model] = err

    # where each timed stage writes its StageTimer line, and the line's name
    timed = {"shapley_init": ("log.txt", "shapley_init"),
             "enum": ("trans_all/log.txt", "enum"),
             "interaction_logits": ("interaction_seed1/log.txt", "interaction"),
             "smoothness_enum": ("linearity_all/allregion_{}/log.txt",
                                 "smoothness:linearity:{}")}
    rates = {}
    for stage, _, argv in spec:
        kind = next((k for k in timed if stage.startswith(k)), None)
        if kind is None:
            continue
        model = argv[argv.index("--model") + 1]
        for objective in (("inc", "dec") if kind == "smoothness_enum"
                          else ("",)):
            path, prefix = (x.format(objective) for x in timed[kind])
            items, seconds, rate = stage_rate(folder(model) + path, prefix)
            name = stage + (f"_{objective}" if objective else "")
            rates[name] = {"forwards": items, "seconds": seconds,
                           "forwards_per_s": rate}
    checks = {"interactions": check_interactions(folder),
              "smoothness": check_smoothness(folder("dgcnn")),
              "results": tables}
    return total, stages, rates, efficiency, checks


def synthetic_label() -> int:
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    return SyntheticClouds(30, N, 10, seed=1)[0][1]


def reward_np(logits):
    from interpret_quality_tpu_torch.attrib.reward import reward_from_logits_np
    return reward_from_logits_np(logits, synthetic_label())


def check_interactions(folder):
    """The interaction artifacts of each family: finite and of their shapes,
    single-region folders named range_rank%02d_region%02d with the ranks a
    permutation of 1..R; and, in every pose state at the normal pose, each
    pair's v(row 0 at ratio 1: the whole cloud) - v(row 3 at ratio 0: the
    all-centre cloud) equal to norm_factor.npy within rtol 1e-3 (atol
    1e-4): the two forwards differ from init's in batch, and DGCNN's
    feature-space near ties move a logit by up to ~1e-3."""
    import torch
    from scipy.special import comb
    out = {}
    for model in INTERACTION_MODELS:
        inter = folder(model) + "interaction_seed1/"
        single = inter + "trans_adv_single_region/"
        names = sorted(os.listdir(single))
        ranks = []
        for d in names:
            if not re.fullmatch(r"range_rank\d\d_region\d\d", d):
                raise AssertionError(f"{model}: single-region folder {d!r}")
            ranks.append(int(d[10:12]))
        if sorted(ranks) != list(range(1, R + 1)):
            raise AssertionError(f"{model}: ranks {sorted(ranks)}")
        rank1 = single + names[ranks.index(1)] + "/"
        nf = float(np.load(folder(model) + "norm_factor.npy"))
        worst, rows = 0.0, 0
        rank1_pairs = len(np.load(rank1 + "region_pair_list.npy"))
        # (folder, pairs, at the normal pose: v(N) is the norm factor's)
        for pose_dir, pairs, normal in ((inter + "normal/", INTER_PAIRS, True),
                                        (inter + "trans_adv/", INTER_PAIRS,
                                         False),
                                        (rank1 + "normal/", rank1_pairs, True)):
            if pairs == 0:
                continue                 # a region without neighbours
            logits = {}
            for ratio in map(float, INTER_RATIOS):
                r = int(ratio * 100)
                # every context of size m, or 100 drawn ones (gen_context)
                contexts = int(min(100, comb(R - 2, int((R - 2) * ratio))))
                lg = torch.load(pose_dir + f"ratio{r}_all_logits.pt").numpy()
                inter_v = np.load(pose_dir + f"ratio{r}_pred_interaction.npy")
                if (lg.shape != (pairs, 4 * contexts, 10)
                        or inter_v.shape != (pairs, contexts)
                        or not (np.isfinite(lg).all()
                                and np.isfinite(inter_v).all())):
                    raise AssertionError(f"{pose_dir} ratio {r}: {lg.shape} "
                                         f"{inter_v.shape}")
                logits[r] = lg
            if not normal:
                continue                     # another pose: another v(N)
            gap = reward_np(logits[100][:, 0]) - reward_np(logits[0][:, 3])
            err = np.abs(gap - nf)
            if not (err <= 1e-3 * np.abs(nf) + 1e-4).all():
                raise AssertionError(f"{pose_dir}: v(N) - v(empty) per pair "
                                     f"{gap} vs norm factor {nf}")
            worst, rows = max(worst, float(err.max())), rows + pairs
        out[model] = {"norm_factor": nf, "max_abs_err_to_norm_factor": worst,
                      "pairs_checked": rows, "rank1_folder": names[ranks.index(1)],
                      "rank1_pairs": rank1_pairs}
    return out


def check_smoothness(base):
    """DGCNN's smoothness run, both objectives: finite artifacts of their
    shapes; no point further than 0.03 + 1e-6 from the original; no region
    of at least SMOOTH_MIN_POINTS points moving against its objective from
    one epoch to the next (by more than 1e-5); each epoch's Shapley values
    summing to v(N) - v(empty) of that epoch's own logits within 5e-3."""
    import torch
    from interpret_quality_tpu_torch.attrib.smoothness import (
        DIST_THRESHOLD, region_smoothness_np)
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    data = SyntheticClouds(30, N, 10, seed=1)[0][0]
    region_id = np.load(base + "region_id.npy")
    sizes = np.bincount(region_id, minlength=R)
    out = {}
    for objective in ("inc", "dec"):
        d = base + f"linearity_all/allregion_{objective}/"
        sv = np.load(d + "region_shapley_value.npy")
        smooth = np.load(d + "linearity.npy")
        clouds = np.load(d + "data_smoothness.npy")
        logits = torch.load(d + "all_logits.pt").numpy()
        E = sv.shape[0]
        want = {"sv": (E, R), "smooth": (E, R), "clouds": (E, 1, N, 3),
                "logits": (E, INIT_ORDERS["dgcnn"] * (R + 1), 10)}
        got = {"sv": sv, "smooth": smooth, "clouds": clouds, "logits": logits}
        for k, shape in want.items():
            if not 1 <= E <= SMOOTH_EPOCHS or got[k].shape != shape or \
                    not np.isfinite(got[k]).all():
                raise AssertionError(f"{d} {k}: {got[k].shape}, want {shape}")
        disp = float(np.linalg.norm(clouds[:, 0] - data, axis=-1).max())
        if disp > DIST_THRESHOLD + 1e-6:
            raise AssertionError(f"{d}: a point moved {disp} from the original")
        prev = np.array([region_smoothness_np(data[region_id == r], "linearity")
                         for r in range(R)], np.float32)
        sign = 1.0 if objective == "inc" else -1.0
        moves = sign * (smooth - np.concatenate([prev[None], smooth[:-1]]))
        toward = float(moves[:, sizes >= SMOOTH_MIN_POINTS].min())
        if toward < -1e-5:
            raise AssertionError(f"{d}: a region moved against its objective "
                                 f"by {-toward}")
        v = reward_np(logits[:, :R + 1].reshape(-1, 10)).reshape(E, R + 1)
        eff = float(np.abs(sv.sum(1) - (v[:, R] - v[:, 0])).max())
        if eff > 5e-3 * max(1.0, float(np.abs(v[:, R] - v[:, 0]).max())):
            raise AssertionError(f"{d}: efficiency off by {eff}")
        out[objective] = {"epochs": E, "max_displacement": disp,
                          "min_move_toward_objective": toward,
                          "degenerate_regions_excused": int(
                              ((sizes > 0) & (sizes < SMOOTH_MIN_POINTS)).sum()),
                          "efficiency_err": eff,
                          "smoothness_change": float(np.abs(smooth[-1] - prev).max())}
    return out


def write_real_trees(root: str) -> None:
    """Fixture trees of the two eval sets, for the names in the port's own
    sample lists: seeded ModelNet10 .npy clouds of REAL_ROWS x 6 (xyz and
    normals) and ShapeNet .pts clouds of REAL_ROWS x 3."""
    from interpret_quality_tpu_torch.data.datasets import (
        _read_modelnet_names, _read_shapenet_selected)
    rng = np.random.RandomState(3)
    for name in _read_modelnet_names():
        d = os.path.join(root, "modelnet10_numpy", name[:-5])
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, name + ".npy"),
                rng.randn(REAL_ROWS, 6).astype(np.float32))
    base = os.path.join(root, "shapenetcore_partanno_segmentation_benchmark_v0")
    for cat, uuid in _read_shapenet_selected():
        d = os.path.join(base, cat, "points")
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, uuid + ".pts"),
                   rng.randn(REAL_ROWS, 3) * [1.0, 0.5, 2.0], fmt="%.6f")


def run_real_data(workdir):
    """save_fps and Shapley init on the card from fixture trees of both eval
    sets (--data_root, neither --synthetic nor --allow_random_init), with
    seeded GCNN and adv-GCNN .t7 checkpoints at the default paths; the
    adv-GCNN one is saved as model_best.t7 only, so the loader must take
    its fallback.  Checks: the eval clouds are the fixture's (ModelNet10:
    its first N rows; ShapeNet: centred, unit-sphere scaled and FPS
    resampled, recomputed here from np.loadtxt), the FPS indices and the
    init artifacts are finite and of their shapes, every order's estimate
    sums to v(N) - v(empty), and adv-GCNN printed the substitution."""
    import importlib

    import torch
    from interpret_quality_tpu_torch.config import ExperimentConfig
    from interpret_quality_tpu_torch.data.datasets import (
        farthest_point_sample_np)
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.pipeline import resolve_dataset
    root, ck = os.path.join(workdir, "data"), os.path.join(workdir, "ck")
    write_real_trees(root)
    out = {}
    launch.reset_launches()
    for dataset in ("modelnet10", "shapenet"):
        def cfg(model):
            return ExperimentConfig(model=model, dataset=dataset, data_root=root,
                                    checkpoints_root=ck, num_points=N,
                                    num_regions=R)
        for i, model in enumerate(REAL_MODELS):
            path = cfg(model).default_model_path()
            if model == "gcnn_adv":
                path = path.replace("model_399.t7", "model_best.t7")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(seeded_model(model, "cpu", seed=i).state_dict(), path)
        ds, names = resolve_dataset(cfg("gcnn"))
        cloud = ds[0][0]
        if dataset == "modelnet10":
            want = np.load(ds.items[0][0])[:N, :3]
            diff = float(np.abs(cloud - want).max())
            exact = bool(np.array_equal(cloud, want))
        else:
            raw = np.loadtxt(ds.items[0][0]).astype(np.float32)
            raw = raw - raw.mean(axis=0, keepdims=True)
            raw = raw / np.max(np.sqrt((raw ** 2).sum(1)))
            want = raw[farthest_point_sample_np(raw, N)]
            diff = float(np.abs(cloud - want).max())
            exact = diff <= 1e-6
        if cloud.shape != (N, 3) or not exact or len(names) != 30:
            raise AssertionError(f"{dataset}: eval cloud {cloud.shape} differs "
                                 f"from the fixture's by {diff}")
        common = ["--dataset", dataset, "--data_root", root, "--device", "cuda",
                  "--samples", "0", "--checkpoints_root", ck,
                  "--num_points", str(N), "--num_regions", str(R)]
        spec = [("save_fps", "save_fps", ["--model", "gcnn"])] + [
            (f"shapley_init_{model}", "shapley_value",
             ["--model", model, "--num_samples_save", str(REAL_ORDERS)])
            for model in REAL_MODELS]
        for stage, cli, argv in spec:
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                importlib.import_module(
                    f"interpret_quality_tpu_torch.cli.{cli}").main(argv + common)
            torch.cuda.synchronize()
            sys.stderr.write(text.getvalue())
            rec = {"seconds": time.perf_counter() - t0}
            if stage == "shapley_init_gcnn_adv":
                rec["model_best_fallback"] = \
                    "substituting best checkpoint" in text.getvalue()
                if not rec["model_best_fallback"]:
                    raise AssertionError(f"{dataset}: adv-GCNN did not take "
                                         "the model_best.t7 fallback")
            out[f"{dataset}/{stage}"] = rec
        fps_idx = np.load(f"fps_{dataset}_{N}_{R}_index_final30.npy")
        if fps_idx.shape != (30, R) or not (fps_idx[:, 0] == 0).all():
            raise AssertionError(f"{dataset}: fps indices {fps_idx.shape}")
        for model in REAL_MODELS:
            base = cfg(model).exp_folder + names[0] + "/"
            sv_all = np.load(base + "region_sv_all.npy")
            nf = float(np.load(base + "norm_factor.npy"))
            region_id = np.load(base + "region_id.npy")
            if (sv_all.shape != (REAL_ORDERS, R) or region_id.shape != (N,)
                    or not np.isfinite(sv_all).all() or not np.isfinite(nf)):
                raise AssertionError(f"{base}: {sv_all.shape} {region_id.shape}")
            err = float(np.abs(sv_all.sum(1) - nf).max())
            if err > 5e-3 * max(1.0, abs(nf)):
                raise AssertionError(f"{base}: efficiency off by {err}")
            out[f"{dataset}/shapley_init_{model}"].update(
                norm_factor=nf, efficiency_err=err)
        out[f"{dataset}/cloud_max_abs_diff_to_fixture"] = diff
    out["launches"] = launch.launches()
    if not (out["launches"]["knn"] and out["launches"]["gather_extrema"]):
        raise AssertionError(f"GCNN's kernels did not run: {out['launches']}")
    return out


# ------------------------------------------------------------------- train
@contextlib.contextmanager
def eval_pass_launches(counter):
    """Counts into ``counter`` the launches made inside fit's eval passes
    (``trainer.evaluate``), and their seconds under "seconds"; the rest of
    a cli.train run is train steps and set-up."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.train import trainer
    original = trainer.evaluate

    def evaluate(*args, **kwargs):
        before, t0 = launch.launches(), time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        counter["seconds"] = counter.get("seconds", 0.0) + (
            time.perf_counter() - t0)
        for k, v in launch.launches(since=before).items():
            counter[k] = counter.get(k, 0) + v
        return out

    trainer.evaluate = evaluate
    try:
        yield
    finally:
        trainer.evaluate = original


def dropouts_off(model):
    from interpret_quality_tpu_torch.models.common import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()
    return model


def grid_batch(n: int, seed: int):
    """STEP_BATCH synthetic clouds of n points on a 1/64 grid, and labels."""
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    ds = SyntheticClouds(STEP_BATCH, n, 10, seed=seed)
    x = np.stack([ds[i][0] for i in range(STEP_BATCH)])
    labels = np.array([ds[i][1] for i in range(STEP_BATCH)], np.int64)
    return (np.round(x * 64) / 64).astype(np.float32), labels


def one_train_step(name, model, x, labels):
    """Loss, logits and gradients of one train step of ``model`` (as
    trainer.make_train_step computes them, without the update), the last
    row masked out of the loss; the model keeps its new running stats."""
    from interpret_quality_tpu_torch.models import (
        feature_transform_regularizer, train_forward)
    from interpret_quality_tpu_torch.train.losses import cal_loss
    from interpret_quality_tpu_torch.train.trainer import (SMOOTHED,
                                                           valid_weights)
    logits, trans_feat = train_forward(model, x)
    loss = cal_loss(logits, labels, smoothing=name in SMOOTHED,
                    weights=valid_weights(x.shape[0], STEP_VALID, x.device))
    if name == "pointnet":
        loss = loss + feature_transform_regularizer(trans_feat) * 1e-3
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.detach(), logits.detach()


def feature_knn_margin(name, x):
    """The smallest gap between a k-th and (k+1)-th distance of DGCNN's
    feature-space selections (layers 2-4) in the port's own train forward
    on the CPU, relative to the cloud's largest |x|^2, exact in f64."""
    import torch
    from interpret_quality_tpu_torch.models import dgcnn
    rows, original = [], dgcnn.knn

    def knn(query, database, k, select=None):
        rows.append(query.detach().double())
        return original(query, database, k, select=select)
    dgcnn.knn = knn
    try:
        model = dropouts_off(seeded_model(name, "cpu").train())
        one_train_step(name, model, torch.from_numpy(x),
                       torch.zeros(x.shape[0], dtype=torch.long))
    finally:
        dgcnn.knn = original
    worst = np.inf
    for h in rows[1:]:
        d = ((h[:, :, None] - h[:, None]) ** 2).sum(-1).sort(-1).values
        scale = (h ** 2).sum(-1).amax(-1)[:, None]
        worst = min(worst, float(((d[..., K] - d[..., K - 1]) / scale).min()))
    return worst


def tie_free_dgcnn_batch():
    """The first grid batch of STEP_DGCNN_POINTS points whose DGCNN
    feature-space selections keep every k-th and (k+1)-th distance at least
    STEP_TIE_MARGIN apart: (x, labels, seed, margin)."""
    for seed in range(64):
        x, labels = grid_batch(STEP_DGCNN_POINTS, seed)
        margin = feature_knn_margin("dgcnn", x)
        if margin >= STEP_TIE_MARGIN:
            return x, labels, seed, margin
    raise AssertionError("no tie-free DGCNN batch in 64 seeds")


def check_train_step(name, device):
    """One train step on the card against the same step on the CPU (the
    plain versions), from the same weights, dropout off: loss, logits,
    every gradient and every running statistic, within the STEP_*
    tolerances."""
    import torch
    seed, margin = 0, None
    if name == "dgcnn":
        x, labels, seed, margin = tie_free_dgcnn_batch()
    else:
        x, labels = grid_batch(N, seed)
    out = {}
    for dev in ("cpu", device):
        model = dropouts_off(seeded_model(name, dev).train())
        loss, logits = one_train_step(name, model, torch.from_numpy(x).to(dev),
                                      torch.from_numpy(labels).to(dev))
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        stats = {n: b.cpu() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        out[dev] = (loss.cpu(), logits.cpu(), grads, stats)
    (l_c, lg_c, g_c, s_c), (l_g, lg_g, g_g, s_g) = out["cpu"], out[device]
    for got, want, what in ((l_g, l_c, "loss"), (lg_g, lg_c, "logits")):
        if not torch.allclose(got, want, rtol=STEP_LOGIT_TOL,
                              atol=STEP_LOGIT_TOL):
            raise AssertionError(f"{name} train step {what}: card {got} vs "
                                 f"CPU {want}")
    floor = STEP_GRAD_FLOOR * max(float(g.norm()) for g in g_c.values())
    grad_err = 0.0
    for pname, want in g_c.items():
        err = float((g_g[pname] - want).norm())
        if not err <= STEP_GRAD_REL * float(want.norm()) + floor:
            raise AssertionError(f"{name} gradient {pname}: |card - CPU| "
                                 f"{err} against |CPU| {float(want.norm())}")
        grad_err = max(grad_err, err / (float(want.norm()) + floor))
    stat_err = 0.0
    for bname, want in s_c.items():
        err = float((s_g[bname] - want).abs().max() / want.abs().max())
        if not err <= STEP_STAT_TOL:
            raise AssertionError(f"{name} {bname}: card vs CPU differ by "
                                 f"{err} of the largest value")
        stat_err = max(stat_err, err)
    rec = {"points": int(x.shape[1]), "batch_seed": seed,
           "loss_abs_diff": float((l_g - l_c).abs()),
           "logits_max_abs_diff": float((lg_g - lg_c).abs().max()),
           "grad_max_rel_norm_err": grad_err, "stats_max_rel_err": stat_err,
           "gradients": len(g_c), "statistics": len(s_c)}
    if margin is not None:
        rec["feature_knn_margin"] = margin
    return rec


def train_step_rate(name, device):
    """TRAIN_STEPS train steps (dropout on, the family's optimiser) on one
    fixed batch of TRAIN_BATCH full-width synthetic clouds: every loss
    finite and the last below the first; clouds/s over steps 2..n, timed
    with a CUDA synchronise at both ends; the launches of the steps."""
    import torch
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.train.trainer import (make_optimizer,
                                                           make_train_step)
    ds = SyntheticClouds(TRAIN_BATCH, N, 10, seed=7)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(TRAIN_BATCH)]))
    labels = torch.tensor([ds[i][1] for i in range(TRAIN_BATCH)])
    x, labels = x.to(device), labels.to(device)
    torch.manual_seed(0)
    from interpret_quality_tpu_torch.models import build_model
    model = build_model(name, 10, K).to(device).train()
    optimizer, scheduler, _ = make_optimizer(model, name, TRAIN_STEPS, 1)
    step = make_train_step(model, optimizer, scheduler, name,
                           torch.Generator(device=device).manual_seed(0))
    before = launch.launches()
    losses = []
    t_first = time.perf_counter()
    for i in range(TRAIN_STEPS):
        losses.append(step(x, labels, TRAIN_BATCH)[0])
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first_s = t0 - t_first
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = launch.launches(since=before)
    losses = [float(v) for v in losses]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: train losses {losses}")
    ms_per_step = seconds / (TRAIN_STEPS - 1) * 1e3
    profile = profile_steps(lambda: step(x, labels, TRAIN_BATCH), ms_per_step)
    return {"losses": losses,
            "clouds_per_s": (TRAIN_STEPS - 1) * TRAIN_BATCH / seconds,
            "ms_per_step": ms_per_step, "first_step_s": first_s,
            "launches": {k: v for k, v in launched.items() if v},
            "profile": profile}, launch.launches(since=before)


def profile_steps(run_step, ms_per_step, steps: int = 2):
    """Device time of a train step by kernel, from torch.profiler over two
    more steps: the summed kernel time per step, its share of the
    unprofiled step time (the device's busy share), and the kernels that
    take most of it.  The profiler is untried on the card's machine, so a
    failure is reported, not raised."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run_step()
            torch.cuda.synchronize()
        # the kernels themselves: the operators above them carry the same
        # device time again
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
    except Exception as e:                   # noqa: BLE001 (reported)
        return {"error": repr(e)}
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"device_ms_per_step": device_ms,
            "busy_share": device_ms / ms_per_step,
            "launches_per_step": sum(e.count for e in kernels) / steps,
            "top_ms_per_step": [[e.key[:90], e.self_device_time_total / 1e3
                                 / steps] for e in top]}


def check_cli_train(name, workdir, device):
    """cli.train for two short epochs, then Shapley init on its
    model_best.t7 by the default path.  Checks: two finite Train and two
    finite Test lines in run.log, the four .backup files, the checkpoint
    loads strict=True, every order's estimate sums to v(N) - v(empty)."""
    import importlib

    import torch
    from interpret_quality_tpu_torch.config import ExperimentConfig
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.ops.cuda import launch
    ck = os.path.join(workdir, "ck")
    argv = ["--model", name, "--synthetic", "--device", str(device),
            "--epochs", str(TRAIN_EPOCHS), "--train_samples",
            str(TRAIN_SAMPLES), "--test_samples", str(TRAIN_TEST_SAMPLES),
            "--best_acc_gate", "0", "--checkpoints_root", ck,
            "--num_points", str(N)]
    eval_launches = {}
    before = launch.launches()
    t0 = time.perf_counter()
    with eval_pass_launches(eval_launches):
        importlib.import_module("interpret_quality_tpu_torch.cli.train").main(
            argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    eval_s = eval_launches.pop("seconds")
    total = launch.launches(since=before)
    step_launches = {k: total[k] - eval_launches.get(k, 0) for k in total}
    cfg = ExperimentConfig(model=name, checkpoints_root=ck, num_points=N,
                           num_regions=R, num_samples_save=TRAIN_ORDERS)
    path = cfg.default_model_path()
    exp = os.path.dirname(os.path.dirname(path))
    with open(os.path.join(exp, "run.log")) as f:
        lines = f.read().splitlines()
    numbers = {kind: [float(line.split("loss: ")[1].split(",")[0])
                      for line in lines if line.startswith(kind + " ")]
               for kind in ("Train", "Test")}
    epochs_s = [float(line.rsplit("(", 1)[1].rstrip("s)"))
                for line in lines if line.startswith("Train ")]
    if any(len(v) != TRAIN_EPOCHS or not np.isfinite(v).all()
           for v in numbers.values()):
        raise AssertionError(f"{name} run.log: {numbers}")
    backups = sorted(f for f in os.listdir(exp) if f.endswith(".backup"))
    if backups != ["config.py.backup", "datasets.py.backup",
                   "registry.py.backup", "trainer.py.backup"]:
        raise AssertionError(f"{name}: .backup files {backups}")
    build_model(name, 10, K).load_state_dict(
        torch.load(path, map_location="cpu"), strict=True)
    missing = [k for k in TRAIN_STEP_KERNELS[name] if not step_launches[k]]
    missing += [k for k in FAMILY_KERNELS[name] if not eval_launches.get(k)]
    if missing:
        raise AssertionError(f"{name}: kernels not launched in cli.train: "
                             f"{missing}")

    t0 = time.perf_counter()
    importlib.import_module("interpret_quality_tpu_torch.cli.shapley_value"
                            ).main(["--model", name, "--synthetic", "--device",
                                    str(device), "--checkpoints_root", ck,
                                    "--num_points", str(N), "--num_regions",
                                    str(R), "--num_samples_save",
                                    str(TRAIN_ORDERS), "--samples", "0"])
    torch.cuda.synchronize()
    folder = cfg.exp_folder + "synthetic_00/"
    sv_all = np.load(folder + "region_sv_all.npy")
    nf = float(np.load(folder + "norm_factor.npy"))
    err = float(np.abs(sv_all.sum(1) - nf).max())
    if sv_all.shape != (TRAIN_ORDERS, R) or not np.isfinite(sv_all).all() \
            or err > 5e-3 * max(1.0, abs(nf)):
        raise AssertionError(f"{name}: Shapley init on the trained "
                             f"checkpoint: {sv_all.shape}, efficiency {err}")
    return {"train_s": train_s, "train_epochs_s": epochs_s,
            "eval_passes_s": eval_s, "shapley_s": time.perf_counter() - t0,
            "losses": numbers, "efficiency_err": err,
            "step_launches": {k: v for k, v in step_launches.items() if v},
            "eval_launches": {k: v for k, v in eval_launches.items() if v}
            }, launch.launches(since=before)


def run_train(workdir, device):
    """The train phase: per family the CLI run (train steps, eval passes,
    then Shapley init on its checkpoint), the fixed-batch steps and the
    card-vs-CPU step; its record holds the launches of the whole phase per
    kernel."""
    import torch
    from interpret_quality_tpu_torch.ops.cuda import launch
    out, phase = {}, dict.fromkeys(launch.launches(), 0)
    t0 = time.perf_counter()
    # the process's first optimiser pays a one-time set-up in torch.optim;
    # taken here, it stays out of the first family's numbers
    torch.optim.SGD([torch.zeros(1, device=device, requires_grad=True)],
                    lr=1.0)
    out["first_optimizer_s"] = time.perf_counter() - t0
    for name in TRAIN_MODELS:
        rec, launched = check_cli_train(name, workdir, device)
        rate, step_launched = train_step_rate(name, device)
        for k in phase:
            phase[k] += launched[k] + step_launched[k]
        wrong = [k for k, v in step_launched.items()
                 if bool(v) != (k in TRAIN_STEP_KERNELS[name])]
        if wrong:
            raise AssertionError(f"{name}: train steps launched "
                                 f"{rate['launches']}")
        before = launch.launches()
        rec["card_vs_cpu_step"] = check_train_step(name, device)
        for k, v in launch.launches(since=before).items():
            phase[k] += v
        rec["fixed_batch_steps"] = rate
        out[name] = rec
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = phase
    return out


# ------------------------------------------------------------- adversarial
def gcnn_checkpoint(ck: str) -> str:
    """The train phase's GCNN checkpoint, which cli.train_adv resumes."""
    from interpret_quality_tpu_torch.config import ExperimentConfig
    return ExperimentConfig(model="gcnn", checkpoints_root=ck,
                            num_points=N).default_model_path()


def check_cli_train_adv(workdir, device, resume_path):
    """cli.train_adv for ADV_EPOCHS epochs from the train phase's GCNN
    .t7, then Shapley init on adv-GCNN by its default path (model_399.t7
    absent: the run's model_best.t7).  Checks: per epoch the three run.log
    lines in the JAX package's formats, finite; the three .backup files;
    the checkpoint loads strict=True; kNN launched (attacks, train passes)
    and gather_extrema (the eval passes), no other kernel; every order's
    estimate sums to v(N) - v(empty)."""
    import importlib

    import torch
    from interpret_quality_tpu_torch.config import ExperimentConfig
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.ops.cuda import launch
    ck = os.path.join(workdir, "ck")
    before = launch.launches()
    t0 = time.perf_counter()
    importlib.import_module("interpret_quality_tpu_torch.cli.train_adv").main(
        ["--synthetic", "--device", str(device), "--num_points", str(N),
         "--epochs", str(ADV_EPOCHS), "--batch_size", str(ADV_BATCH),
         "--best_acc_gate", "0", "--checkpoints_root", ck,
         "--train_rot_all_perturbation", "--resume_path", resume_path])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launched = launch.launches(since=before)
    cfg = ExperimentConfig(model="gcnn_adv", checkpoints_root=ck,
                           num_points=N, num_regions=R,
                           num_samples_save=ADV_ORDERS)
    models = os.path.dirname(cfg.default_model_path())
    exp = os.path.dirname(models)
    with open(os.path.join(exp, "run.log")) as f:
        lines = f.read().splitlines()
    kinds = (r"Train %d, loss: (\S+), train acc: (\S+) \(\d+\.\ds\)",
             r"Test %d, loss: (\S+), test acc: (\S+), test avg acc: (\S+)",
             r"Test adv %d, rot-robust acc: (\S+)")
    logged = [line for line in lines if line.startswith(("Train", "Test"))]
    numbers = []
    for i, line in enumerate(logged):
        m = re.fullmatch(kinds[i % 3] % (i // 3), line)
        if m is None:
            raise AssertionError(f"adv run.log line {line!r}")
        numbers.append([float(v) for v in m.groups()])
    if len(logged) != 3 * ADV_EPOCHS or not lines[1].startswith(
            "resumed from ") or not np.isfinite(sum(numbers, [])).all():
        raise AssertionError(f"adv run.log: {lines}")
    backups = sorted(f for f in os.listdir(exp) if f.endswith(".backup"))
    if backups != ["adversarial.py.backup", "config.py.backup",
                   "registry.py.backup"]:
        raise AssertionError(f"adv .backup files {backups}")
    if os.path.exists(cfg.default_model_path()):
        raise AssertionError("model_399.t7 written by a 2-epoch run")
    build_model("gcnn_adv", 10, K).load_state_dict(torch.load(
        os.path.join(models, "model_best.t7"), map_location="cpu"),
        strict=True)
    wrong = {k: v for k, v in launched.items()
             if bool(v) != (k in ADV_KERNELS)}
    if wrong:
        raise AssertionError(f"cli.train_adv launched {launched}")

    t0 = time.perf_counter()
    importlib.import_module("interpret_quality_tpu_torch.cli.shapley_value"
                            ).main(["--model", "gcnn_adv", "--synthetic",
                                    "--device", str(device),
                                    "--checkpoints_root", ck, "--num_points",
                                    str(N), "--num_regions", str(R),
                                    "--num_samples_save", str(ADV_ORDERS),
                                    "--samples", "0"])
    torch.cuda.synchronize()
    folder = cfg.exp_folder + "synthetic_00/"
    sv_all = np.load(folder + "region_sv_all.npy")
    nf = float(np.load(folder + "norm_factor.npy"))
    err = float(np.abs(sv_all.sum(1) - nf).max())
    if sv_all.shape != (ADV_ORDERS, R) or not np.isfinite(sv_all).all() \
            or err > 5e-3 * max(1.0, abs(nf)):
        raise AssertionError(f"adv-GCNN Shapley init: {sv_all.shape}, "
                             f"efficiency {err}")
    return {"train_adv_s": train_s, "log": logged,
            "shapley_s": time.perf_counter() - t0, "efficiency_err": err,
            "cli_launches": {k: v for k, v in launched.items() if v}}


@contextlib.contextmanager
def attack_events(marks):
    """CUDA events around each BIM attack of the adversarial module, into
    ``marks`` as (name, start, end)."""
    import torch
    from interpret_quality_tpu_torch.train import adversarial as adv
    originals = adv.bim_rotation_attack, adv.bim_translation_attack

    def timed(fn, name):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            marks.append((name, start, end))
            return out
        return run
    adv.bim_rotation_attack = timed(originals[0], "rotation_attack")
    adv.bim_translation_attack = timed(originals[1], "translation_attack")
    try:
        yield
    finally:
        adv.bim_rotation_attack, adv.bim_translation_attack = originals


def adv_step_rate(device):
    """ADV_STEPS adversarial steps (dropout on, adv-GCNN's SGD) on one fixed
    batch of ADV_BATCH full-width clouds: losses finite; clean clouds/s over
    steps 2..n (host clock between CUDA synchronisations); each step split
    by CUDA events into the rotation attack, the translation attack and the
    rest (two train forwards and backwards, the update); kNN launched
    7 + 3 + 2 times a step and no other kernel."""
    import torch
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.ops.cuda import launch
    from interpret_quality_tpu_torch.train import adversarial as adv
    from interpret_quality_tpu_torch.train.trainer import make_optimizer
    ds = SyntheticClouds(ADV_BATCH, N, 10, seed=7)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(ADV_BATCH)]))
    labels = torch.tensor([ds[i][1] for i in range(ADV_BATCH)])
    x, labels = x.to(device), labels.to(device)
    torch.manual_seed(0)
    model = build_model("gcnn", 10, K).to(device).train()
    optimizer, scheduler, _ = make_optimizer(model, "gcnn_adv", ADV_STEPS, 1)
    step = adv.make_adv_step(model, optimizer, scheduler,
                             torch.Generator(device=device).manual_seed(0))
    marks, steps, losses = [], [], []
    before = launch.launches()
    torch.cuda.reset_peak_memory_stats()
    with attack_events(marks):
        for i in range(ADV_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(x, labels, ADV_BATCH)[0])
            end.record()
            steps.append((start, end))
            if i == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = launch.launches(since=before)
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"adv step losses {losses}")
    per_step = adv.ROT_ADV_ITER + adv.TRANS_ADV_ITER + 2   # a kNN a forward
    want = {k: per_step * ADV_STEPS if k == "knn" else 0 for k in launched}
    if launched != want:
        raise AssertionError(f"adv steps launched {launched}, want {want}")
    step_ms = [s.elapsed_time(e) for s, e in steps[1:]]
    part_ms = {}
    for name, s, e in marks[2:]:             # those of steps 2..n
        part_ms.setdefault(name, []).append(s.elapsed_time(e))
    split = {name: float(np.mean(v)) for name, v in part_ms.items()}
    split["train_passes_and_update"] = float(
        np.mean(step_ms) - sum(split.values()))
    return {"losses": losses,
            "clean_clouds_per_s": (ADV_STEPS - 1) * ADV_BATCH / seconds,
            "ms_per_step": seconds / (ADV_STEPS - 1) * 1e3,
            "event_ms_per_step": float(np.mean(step_ms)),
            "split_ms": split, "launches": {k: v for k, v in launched.items()
                                            if v},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


@contextlib.contextmanager
def recorded_attack(rec):
    """Records, per rotation step, the gradients of (alpha, theta, phi)
    into rec["grads"], and the final angles into rec["final"]."""
    import torch
    from interpret_quality_tpu_torch.train import adversarial as adv
    original = adv.rot_angle_axis

    def rot(x, angle, theta, phi):
        if angle.requires_grad:
            slot = [None] * 3
            rec["grads"].append(slot)
            for j, t in enumerate((angle, theta, phi)):
                t.register_hook(lambda g, j=j: slot.__setitem__(
                    j, g.detach().double().cpu()))
        else:
            rec["final"] = torch.stack([angle, theta, phi]).double().cpu()
        return original(x, angle, theta, phi)
    adv.rot_angle_axis = rot
    try:
        yield
    finally:
        adv.rot_angle_axis = original


def attack_on(device, x, labels, dtype=None):
    """The BIM variants of one batch through a seeded full-width GCNN in
    eval on ``device``: (record of recorded_attack, data_rot, data_dis,
    the smoothed losses of the clean, rotated and translated clouds)."""
    import torch
    from interpret_quality_tpu_torch.train import adversarial as adv
    from interpret_quality_tpu_torch.train.losses import cal_loss
    model = seeded_model("gcnn", device)
    x, labels = x.to(device), labels.to(device)
    if dtype is not None:
        model, x = model.to(dtype), x.to(dtype)
    rec = {"grads": []}
    with recorded_attack(rec):
        rot, dis = adv.make_adv_batch_fn(model)(x, labels)
    with torch.no_grad():
        losses = [float(cal_loss(model(c, fused=False), labels))
                  for c in (x, rot, dis)]
    return rec, rot.double().cpu(), dis.double().cpu(), losses


def attack_distance(run, ref):
    """How far one attack_on run lies from another: the first step's
    gradients relative to the reference's norm, the clouds whose g_alpha
    sign sequences differ, and on the others whether the alphas are equal
    and the largest differences of (theta, phi), the rotated and the
    translated clouds."""
    import torch
    (rec, rot, dis, _), (rec_r, rot_r, dis_r, _) = run, ref
    first, first_r = (torch.stack(r["grads"][0], -1) for r in (rec, rec_r))
    signs, signs_r = (torch.stack([torch.sign(g[0]) for g in r["grads"]])
                      for r in (rec, rec_r))
    same = (signs == signs_r).all(0)                      # (clouds,)
    fin, fin_r = rec["final"][:, same], rec_r["final"][:, same]
    out = {"first_step_grad_rel_err": float((first - first_r).norm()
                                            / first_r.norm()),
           "sign_flip_clouds": int((~same).sum()),
           "alphas_equal": bool(torch.equal(fin[0].float(),
                                            fin_r[0].float()))}
    for k, (a, b) in {"angles": (fin[1:], fin_r[1:]),
                      "rotated": (rot[same], rot_r[same]),
                      "translated": (dis[same], dis_r[same])}.items():
        out[f"{k}_max_abs_diff"] = float((a - b).abs().max()) \
            if same.any() else 0.0
    return out


def check_attack(device):
    """The attack on the card against the CPU from the same weights and
    ATTACK_CLOUDS clouds: the first step's gradients within
    ATTACK_GRAD_REL of the CPU's norm; sign sequences of g_alpha compared
    per cloud (a flip at f32 noise moves a whole step), at most
    ATTACK_MAX_FLIPS clouds flipped; on the clouds that match, the same
    alphas, and (theta, phi) and both attacked clouds within ATTACK_*_TOL.
    The card's output keeps each point's norm within 1e-5 relative,
    |alpha| <= pi/2 and |t| <= 1 + 1e-6.  The CPU's own f32 run against
    its f64 run, the yardstick of the tolerances, is reported beside."""
    import torch
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    ds = SyntheticClouds(ATTACK_CLOUDS, N, 10, seed=3)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(ATTACK_CLOUDS)]))
    labels = torch.tensor([ds[i][1] for i in range(ATTACK_CLOUDS)])
    cpu, card, cpu64 = (attack_on(dev, x, labels, dtype) for dev, dtype in
                        (("cpu", None), (device, None),
                         ("cpu", torch.float64)))
    diff = attack_distance(card, cpu)
    if diff["first_step_grad_rel_err"] > ATTACK_GRAD_REL or \
            diff["sign_flip_clouds"] > ATTACK_MAX_FLIPS:
        raise AssertionError(f"attack card vs CPU: {diff}")
    tols = {"angles": ATTACK_ANGLE_TOL, "rotated": ATTACK_ROT_TOL,
            "translated": ATTACK_TRANS_TOL}
    if not diff["alphas_equal"] or any(
            diff[f"{k}_max_abs_diff"] > tol for k, tol in tols.items()):
        raise AssertionError(f"attack card vs CPU on matching clouds: {diff}")
    rec_g, rot_g, dis_g, loss_g = card
    x64 = x.double()
    norm_err = float(((rot_g.norm(dim=-1) - x64.norm(dim=-1)).abs()
                      / x64.norm(dim=-1).clamp(min=1e-6)).max())
    alpha_max = float(rec_g["final"][0].abs().max())
    t = (dis_g - rot_g)[:, 0].norm(dim=-1)
    # the clip is to pi/2 rounded to f32 (1.2e-8 above pi/2)
    if norm_err > 1e-5 or alpha_max > float(np.float32(np.pi / 2)) \
            or float(t.max()) > 1 + 1e-6:
        raise AssertionError(f"attack invariants: norms {norm_err}, |alpha| "
                             f"{alpha_max}, |t| {t.tolist()}")
    return {"clouds": ATTACK_CLOUDS, **diff,
            "g_alpha_min_abs": float(torch.stack(
                [g[0].abs() for g in rec_g["grads"]]).min()),
            "norm_max_rel_err": norm_err, "alpha_max_abs": alpha_max,
            "translation_norms": t.tolist(),
            "loss_clean_rot_trans_card": loss_g,
            "loss_clean_rot_trans_cpu": cpu[3],
            "cpu_f32_vs_f64": attack_distance(cpu, cpu64)}


def run_adversarial(workdir, device, resume_path):
    """The adversarial phase: cli.train_adv and Shapley init on its
    checkpoint, the fixed-batch step rate and split, the attack card
    against CPU.  Returns (record, launches of the whole phase)."""
    import gc

    import torch
    from interpret_quality_tpu_torch.ops.cuda import launch
    before = launch.launches()
    gc.collect()                 # the train phase's cycles (optimisers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    out = check_cli_train_adv(workdir, device, resume_path)
    # Shapley init's 1650-cloud forward sets it
    out["cli_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["fixed_batch_steps"] = adv_step_rate(device)
    out["attack_card_vs_cpu"] = check_attack(device)
    out["seconds"] = time.perf_counter() - t0
    out["allocated_at_start_gb"] = allocated_gb
    launched = launch.launches(since=before)
    out["launches"] = {k: v for k, v in launched.items() if v}
    return out, launched


# ---------------------------------------------------------- adv_robustness
def robustness_script():
    """scripts/adv_robustness_torch.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "adv_robustness_torch",
        os.path.join(REPO, "scripts", "adv_robustness_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def top2_agree(logits_card, logits_cpu):
    """(rows whose predictions differ, rows excused: a CPU top-two gap
    within ROBUST_TOP2_REL of the row's largest |logit|)."""
    import torch
    top = logits_cpu.topk(2, dim=-1).values
    near = (top[:, 0] - top[:, 1]) <= ROBUST_TOP2_REL * \
        logits_cpu.abs().amax(-1)
    differ = logits_card.cpu().argmax(-1) != logits_cpu.argmax(-1)
    return int((differ & ~near).sum()), int((differ & near).sum())


def run_adv_robustness(workdir, device):
    """The adv_robustness phase on the train and adversarial phases'
    checkpoints under ``workdir``: the script's JSON at --out, finite
    accuracies in [0, 1]; card against CPU on the same clouds, clean and
    rotated; the card's per-draw accuracy recomputed equal to the
    script's.  Returns (record, launches)."""
    import torch
    from interpret_quality_tpu_torch.models.registry import _logits
    from interpret_quality_tpu_torch.ops.cuda import launch
    script = robustness_script()
    out_path = os.path.join(workdir, "robustness", "rob.json")
    before = launch.launches()
    t0 = time.perf_counter()
    out = script.main(["--device", str(device), "--checkpoints_root",
                       os.path.join(workdir, "ck"), "--out", out_path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = launch.launches(since=before)
    with open(out_path) as f:
        if json.load(f) != out:
            raise AssertionError("the robustness JSON differs from the run")
    test_ds = script.SyntheticClouds(num_samples=script.NUM_SAMPLES,
                                     num_points=script.NUM_POINTS, seed=2)
    rec = {"script_s": seconds, "card": out.get("card"), "models": {}}
    t0 = time.perf_counter()
    for name in script.RUNS:
        res = out["models"][name]
        numbers = [res[k] for k in ("clean_acc", "clean_balanced_acc",
                                    "rot_robust_acc_mean",
                                    "rot_robust_acc_std")]
        if not res["checkpoint"].endswith("model_best.t7") or not all(
                np.isfinite(v) and 0 <= v <= 1 for v in numbers):
            raise AssertionError(f"robustness of {name}: {res}")
        card = script.load_gcnn(res["checkpoint"], device)
        cpu = script.load_gcnn(res["checkpoint"], "cpu")
        wrong = excused = rows = 0
        hits = np.zeros(script.ROT_DRAWS)
        counts = np.zeros(script.ROT_DRAWS)
        clean = [(-1, torch.from_numpy(d).to(device), lab, v) for d, lab, v
                 in test_ds.batches(script.BATCH_SIZE, shuffle=False)]
        with torch.no_grad():
            for draw, x, labels, valid in clean + list(
                    script.rotated_batches(test_ds, device,
                                           script.ROT_DRAWS,
                                           script.BATCH_SIZE)):
                lg, lc = _logits(card(x)), _logits(cpu(x.cpu()))
                w, e = top2_agree(lg[:valid], lc[:valid])
                wrong, excused, rows = wrong + w, excused + e, rows + valid
                if draw >= 0:
                    hits[draw] += int((lg[:valid].argmax(-1).cpu().numpy()
                                       == labels[:valid]).sum())
                    counts[draw] += valid
        if wrong:
            raise AssertionError(f"robustness of {name}: {wrong} of {rows} "
                                 f"predictions differ from the CPU's")
        if float(np.mean(hits / counts)) != res["rot_robust_acc_mean"]:
            raise AssertionError(f"robustness of {name}: the card's rotated "
                                 f"accuracy {hits / counts} against the "
                                 f"script's {res['rot_robust_acc_mean']}")
        rec["models"][name] = {**res, "rows_vs_cpu": rows,
                               "rows_excused_top2": excused}
    rec["card_vs_cpu_s"] = time.perf_counter() - t0
    rec["launches"] = {k: v for k, v in launched.items() if v}
    if set(rec["launches"]) != set(FAMILY_KERNELS["gcnn"]):
        raise AssertionError(f"robustness launched {rec['launches']}")
    return rec, launched


def main() -> int:
    # the run uses one card: show it only that one
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: this script measures the port on an NVIDIA GPU")
        return 2
    for key in SELECTION_ENV:       # every phase at the port's defaults
        if os.environ.pop(key, None) is not None:
            log(f"{key} unset: the script runs at the port's defaults")
    sys.path.insert(0, REPO)
    from interpret_quality_tpu_torch.ops.cuda import build
    from interpret_quality_tpu_torch.ops.cuda import dense as dn
    from interpret_quality_tpu_torch.ops.cuda import fps as fp
    from interpret_quality_tpu_torch.ops.cuda import group_mlp as gm
    from interpret_quality_tpu_torch.ops.cuda import groups as gr
    from interpret_quality_tpu_torch.ops.cuda import knn_group as kg
    from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
    from interpret_quality_tpu_torch.ops.precision import set_matmul_precision
    set_matmul_precision("highest")
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)     # build from source
    for source, report in build.build().items():           # one nvcc each, at once
        log(f"ptxas report of {source}.cu:\n{report}")
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_build_s": build_s})

    masked = coalition_batch(device)
    inputs = layer_inputs(masked, device)
    idx, k1, d1 = check_knn(nb, masked, device)
    k2, d2 = check_gather(nb, inputs["gcnn"][0], inputs["gcnn"][1])
    k3, d3 = check_fused(nb, inputs["dgcnn"][0])
    # GCNN layer 2's input (B, N, 64) at the kNN indices of the masked batch
    k8, d8, k8_launches = check_gather_rows(
        gr, inputs["gcnn"][0][1][0].contiguous(), inputs["gcnn"][1])
    del inputs, idx
    torch.cuda.empty_cache()
    k9, d9 = check_dense(dn, masked, device)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        k4, d4 = check_fps(fp, masked)
        k5, d5 = check_ball_mlp3(gr, fp, seeded_model("pointnet2", device),
                                 masked)
        torch.cuda.empty_cache()
        pconv = seeded_model("pointconv", device)
        k6, k7, d67 = check_pointconv_kernels(gr, fp, pconv, masked)
        torch.cuda.empty_cache()
        d16 = check_selection_worst_cases(nb, gr, fp, pconv, masked)
        torch.cuda.empty_cache()
        split = pointconv_forward_split(pconv, masked)
        del pconv
        torch.cuda.empty_cache()
        k10, d10 = check_knn_group(kg, seeded_model("pct", device), masked)
        torch.cuda.empty_cache()
        k11, d11 = check_group_res_mlp(gm, seeded_model("pointmlp", device),
                                       masked)
    for d in d1 + d2 + d3 + d4 + d5 + d67 + d16 + d10 + d11 + [d8, d9]:
        emit({"phase": "kernel_shape", **d})
    emit({"phase": "pointconv_forward_split", **split})
    torch.cuda.empty_cache()

    emit({"phase": "model", **check_models(masked, device)})
    emit({"phase": "small_reference", **check_small_reference(device),
          **check_small_interactions(device), **check_small_smoothness(device)})
    del masked
    torch.cuda.empty_cache()

    workdir = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)                       # save_fps writes into the cwd
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.redirect_stdout(sys.stderr):   # the stages' own prints
            launches, stages, rates, efficiency, checks = run_main_path(
                workdir)
    finally:
        os.chdir(cwd)
    emit({"phase": "main_path", "launches": launches, "stages": stages,
          "rates": rates, "efficiency_err": efficiency, **checks,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "cuts": MAIN_PATH_CUTS})

    real = os.path.join(workdir, "real_data")
    os.makedirs(real)
    os.chdir(real)                          # save_fps writes into the cwd
    try:
        with contextlib.redirect_stdout(sys.stderr):
            real_checks = run_real_data(real)
    finally:
        os.chdir(cwd)
    shutil.rmtree(real, ignore_errors=True)
    emit({"phase": "real_data", **real_checks})

    train_dir = os.path.join(workdir, "train")
    os.makedirs(train_dir)
    os.chdir(train_dir)                     # Shapley init's FPS file
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            train = run_train(train_dir, device)
            train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.empty_cache()
            precision, precision_rows, precision_failed, states = \
                run_precision(device, d5, os.path.join(train_dir, "ck"))
            torch.cuda.empty_cache()
            selection, sel_rows, selection_failed = run_selection(
                device, states)
            del states
            torch.cuda.empty_cache()
            adversarial, adv_launches = run_adversarial(
                train_dir, device,
                gcnn_checkpoint(os.path.join(train_dir, "ck")))
            torch.cuda.empty_cache()
            robustness, rob_launches = run_adv_robustness(train_dir, device)
    finally:
        os.chdir(cwd)
    shutil.rmtree(train_dir, ignore_errors=True)
    emit({"phase": "train", **train, "nvidia_smi": smi,
          "peak_memory_gb": train_peak_gb, "cuts": TRAIN_CUTS})
    emit({"phase": "precision", **precision, "nvidia_smi": smi})
    if precision_failed:        # after the record: every number first
        raise AssertionError("precision phase: " + "; ".join(precision_failed))
    emit({"phase": "selection", **selection, "nvidia_smi": smi})
    if selection_failed:
        raise AssertionError("selection phase: " + "; ".join(selection_failed))
    emit({"phase": "adversarial", **adversarial, "nvidia_smi": smi,
          "cuts": ADV_CUTS})
    emit({"phase": "adv_robustness", **robustness, "cuts": ROBUST_CUTS})

    def src(module):
        return os.path.relpath(build.source_path(module), REPO)
    pallas = "interpret_quality_tpu/ops/pallas/"
    rows = (("knn", "neighbors", "neighbors.py:482", k1),
            ("gather_extrema", "neighbors", "neighbors.py:424", k2),
            ("knn_gather_extrema", "neighbors", "neighbors.py:353", k3),
            ("fps", "fps", "fps.py:78", k4),
            ("fused_ball_mlp3", "groups", "groups.py:250", k5),
            ("knn_with_density", "groups", "groups.py:337", k6),
            ("fused_pointconv_sa", "groups", "groups.py:469", k7),
            ("gather_rows", "groups", "groups.py:171", k8),
            ("dense_pool", "dense", None, k9),
            ("knn_group_max", "knn_group", None, k10),
            ("group_res_mlp", "group_mlp", None, k11))
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": src(module),
         "replaces": pallas + where if where else None,
         **({"note": NO_TPU_KERNEL[kname]} if kname in NO_TPU_KERNEL else {}),
         "launches": launches[kname],
         "train_launches": train["launches"][kname] + adv_launches[kname]
         + rob_launches[kname],
         "library_ms": None, **numbers,
         **({"kernel_phase_launches": k8_launches, "off_path": OFF_PATH[kname]}
            if kname in OFF_PATH else {})}
        for kname, module, where, numbers in rows] + [
        {"name": kname, "route": "cuda",
         "source": src(ROUTE_SOURCES[kname.split(":")[0]][0]),
         "replaces": pallas + ROUTE_SOURCES[kname.split(":")[0]][1],
         "launches": n, "launches_in": "precision phase", **numbers}
        for kname, (numbers, n) in precision_rows.items()] + [
        {"name": kname, "route": "cuda",
         "source": src(ROUTE_SOURCES[kname.split(":")[0]][0]),
         "replaces": pallas + ROUTE_SOURCES[kname.split(":")[0]][1],
         "launches": n, "launches_in": "selection phase", "library_ms": None,
         **numbers}
        for kname, (numbers, n) in sel_rows.items()]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
