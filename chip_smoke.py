#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`second_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--out detail.json]    # one card

Phases, one line each (any failure ends the run with a non-zero exit):

1. card: name and power limit, from nvidia-smi.
2. build: compile the hand-written kernels in second_tpu_torch/csrc/, one
   nvcc per source, all together.
3. capture: one warm-up run of the main path (the SECOND car.fhd eval
   forward: voxelize -> VFE-V3 -> SpMiddleFHD -> RPN -> decode + rotated
   NMS, batch 4, 40 000 voxels, 30 000 points, bf16 as the config asks)
   records the arguments of every kernel call.
4. kernels: each recorded call goes through the kernel and through its
   plain PyTorch version on the card, compared within the stated tolerance
   and timed with CUDA events (median, L2 flushed before each launch, host
   time of the call included where it outlasts the flush), next to one
   PyTorch library call that computes the same function where there is
   one; beside each event time, the device-only time of the same call from
   torch.profiler. Every row-gather call gets a line of its own. The sparse
   convs are checked again with fp32 inputs (bf16 must take the bf16
   tensor-core path, fp32 the fp32 path: 3xTF32 on the tensor cores), and
   every fp32 conv against the plain version in fp64 (FP32_ERR_RATIO
   times the fp32 plain version's own error at most). The batched rotated NMS
   call: pair counts and keep masks exact, overlap bits exact but at pairs
   printed as within RIOU_TOL of the threshold, each cluster shape of the
   overlap kernel timed, and the whole NMS against the per-example path it
   replaced (a `nonzero` pair list, the pair kernel, frontier rounds on the
   host). The dense rotated-IoU matrix at 1000 x 1000 for each criterion.
5. main path: launch counts reset, one forward, counts read: every kernel
   of the path must have launched (the sparse gather-GEMM once per sparse
   conv, 14, each bf16 conv on the tensor-core path; the overlap and the
   suppression kernels once each for the batch). predict must run under
   torch.cuda.set_sync_debug_mode("error"). Then frames/s over timed
   forwards, and one forward under torch.profiler: the device-busy share
   and the device time by kernel.
6. reference: predict on the batch's 4 examples on the card and on the CPU
   (plain versions): the same `valid` mask, and the batched NMS on the same
   candidates with the same indices and keep mask; one fp32 example on the
   card and on the CPU: voxels exact, predictions within tolerance, the
   same `valid` mask end to end, and predict on the same predictions with
   the same `valid` mask and boxes/scores within tolerance.
7. train: the SECOND car.fhd train step (batch 4 synthetic LiDAR scans
   prepared with targets, 16 000 voxels with shuffle_overflow, bf16 middle
   and RPN trunk, the config's Adam), started from flax's initialisers:
   - capture: one step records every sparse-conv call of the forward, of
     the input gradient (the gather-GEMM on the transposed rulebook) and of
     the weight gradient; each is held against its plain version and timed
     like the forward convs (event and device ms, bound, one library call:
     gather + torch.bmm; the call's found taps, their share of the
     rulebook and the device kernels it ran, one a weight-gradient call),
     and each conv's backward is held against autograd of the plain
     gather-GEMM;
   - launches in one counted step: gather-GEMM forward 14 and dX 13, all on
     the tensor-core path, weight gradient 14 on the tensor-core path; every
     sparse weight's gradient finite and not all zero; no host sync in a
     step (torch.cuda.set_sync_debug_mode; the eval forward's syncs are
     counted and printed);
   - determinism: two backward passes from the same state give bitwise-
     equal gradients (cuDNN set to deterministic algorithms);
   - learning: one fixed batch, Adam at OVERFIT_LR, the loss below half its
     first value within OVERFIT_STEPS steps;
   - speed: steps/s and examples/s (median of TIMED_STEPS synchronised
     steps), peak memory, a synchronised split (voxelize, forward + loss,
     backward, optimizer), and one profiled step (device-busy share, top
     kernels);
   - reference: one fp32 step on one example, card (kernels) against CPU
     (plain versions) from the same seeded weights: loss, every gradient,
     every parameter after the Adam step and every norm statistic within
     the stated tolerances.
8. pp eval: PointPillars car (configs/pointpillars_car.config), the JAX
   bench's second leg: batch 4, 12 000 pillars, 20 000 points, bf16 RPN
   trunk, random weights from seed 0 with the norm statistics calibrated
   on the batch (`calibrate_norms_`), and the eval reader's anchor-area
   mask computed on the card from the voxelizer's coords. Every kernel
   call against its plain version (gathers exact; NMS pair counts, bits and
   keep exact); launches: row gather 6, nms_overlap 1, nms_suppress 1, no
   sparse kernel; the mask and predict without a host sync; frames/s with
   peak memory, a split (voxelize, encoder + scatter, RPN, mask + predict)
   and a profile;
   the mask against the host SAT of the same voxel coords, predict and NMS
   over the 4 examples and one fp32 example card against CPU.
9. pp train: the PointPillars train step (the config's batch 2 of
   synthetic scans, targets assigned under the host anchor mask, 12 000
   pillars with shuffle_overflow, bf16, the config's one-cycle AdamW):
   its two row gathers against their plain version; launches row gather 2
   and nothing else; every gradient finite, the encoder's and the first
   RPN conv's nonzero; no host sync; bitwise-equal gradients over two
   runs; the loss halved on one batch; steps/s, peak memory, split,
   profile; one step on one example card against CPU, in fp64 and, against
   the fp64 step, in fp32 (REF64_TOL).

10. mc eval: SECOND multi-class (configs/second_multiclass.config: Car,
   Pedestrian, Cyclist), the config's eval batch 3 of the fhd bench scene,
   40 000 voxels, random weights from seed 0, fp32 as the config asks
   (211 200 anchors an example): every sparse conv and row gather against
   its plain version, each fp32 conv also against fp64 (FP32_ERR_RATIO)
   and timed like the fhd convs (event and device ms, plain, library,
   its bound as 3xTF32 and at the CUDA cores' fp32 rate), the NMS pair on the 9 (example, class)
   rows against its plain version and timed, the per-class keep sets card
   against CPU;
   launches sparse gather-GEMM 14, nms_overlap 1, nms_suppress 1;
   voxel_overflow and stage_overflow 0; predict without a host sync and
   equal to the CPU's on the same predictions; frames/s, split, profile;
   and frames/s again with cuDNN's TF32 on, torch's default.
11. mc train: the config's batch 3 of synthetic scans with pedestrians and
   cyclists (positives of all three classes), 17 000 voxels, bf16, the
   config's one-cycle AdamW: every forward, dX and weight-gradient call of
   one step against its plain version and timed (`mc train conv`,
   `mc train dgrad`, `mc train wgrad` lines); launches 14 / 13 / 14 on the
   tensor-core path, no host sync, gradients bitwise equal over two runs, the loss
   halved on one batch; steps/s, peak memory, split, profile.
12. kitti: a fake KITTI tree (`data/fake_kitti.py`) in a temporary
   directory, prepared by the port's create-data functions, then
   `Trainer(synthetic=False)` on second_multiclass.config for 3 steps and
   an `evaluate`: every kernel call of the three steps (forward, dX and
   weight-gradient convs, row gathers) and of the eval forwards (convs,
   row gathers, each forward's NMS pair by `check_nms_pair`) against its
   plain version; finite losses and the /3d AP keys.
13. fhd + IoU train: second_car_fhd.config with `use_iou_branch`, batch 4
   synthetic scans, 16 000 voxels, bf16: every forward, dX and
   weight-gradient call of one step against its plain version and timed;
   the 3-D IoU kernel (`d3_iou`) on the step's real call against its plain
   version (non-finite entries equal), its clipped count against the pairs
   `d3_cull_plain` keeps (exact, per example), every culled pair's plain
   value at most D3_CULLED_MAX, timed, with its bound counted from the
   kept pairs; launches
   14 / 13 / 14 and d3_iou 1; no
   host sync; the IoU loss finite and nonzero; an eval forward of the
   model with the IoU head (random weights), its NMS card against CPU, and
   predict ranked by an IoU free of near-ties card against CPU (the
   forward's own IoU logits tie over the empty BEV; their tie count is
   printed).

14. 2st eval: the two-stage detector (`build_two_stage_voxelnet`:
   second_car_fhd.config as stage 1, bf16, 512 proposals an example by
   standup NMS, 14 x 14 rotated crops, the refine head, rotated NMS over
   the refined proposals; random weights from seed 0) through the
   two-stage eval step on the fhd bench input (batch 4, 40 000 voxels):
   every sparse conv and row gather against its plain version, the
   ROI-align forward call against its plain version (ROI_FWD_TOL) and
   timed beside `F.grid_sample` + `F.avg_pool2d`, the standup bitmask bit
   for bit and its NMS keep, the final NMS pair (`check_nms_pair`);
   launches sparse gather-GEMM 14, roi_align_fwd 1, standup_overlap 1,
   nms_overlap 1, nms_suppress 2; no host sync; voxel_overflow and
   stage_overflow 0; frames/s, peak memory, a synchronised split
   (voxelize, stage 1, proposals, crops, head, predict) and a profile,
   with cuDNN TF32 off and on; one fp32 example card against CPU (stage 1,
   then the second stage on the card's stage 1: proposals equal, crops,
   predictions and detections within tolerance).
15. 2st train: the two-stage train step (`make_two_stage_steps`, bf16, the
   config's Adam) on batch 4 synthetic scans at 16 000 voxels: every sparse
   forward, dX and weight-gradient call against its plain version; the
   ROI-align forward and backward calls against their plain versions
   (the backward twice, bitwise equal; its counts of in-map samples and
   cell runs equal to the plain mirror's) and timed beside the library
   pair and its autograd, the backward's device time split by kernel; the
   standup bitmask; launches 14 / 13 / 14 and
   roi_align_fwd, roi_align_bwd, standup_overlap and nms_suppress once;
   every gradient finite, no host sync, gradients bitwise equal over two
   runs, the loss halved on one batch; steps/s, peak memory, split,
   profile; one fp64 step card against CPU of the two-stage detector on
   the PointPillars config (the sparse kernels take no fp64), one
   example, 64 proposals (REF64_TOL).

The line before the last is {"kernels": [...]}: per kernel its launches
summed over the ten paths (fhd eval, fhd train, pp eval, pp train, mc
eval, mc train, kitti, fhd + IoU train, 2st eval, 2st train) and by path,
the numbers of the fhd calls (of the IoU-branch step for d3_iou, of the
two-stage phases for the ROI-align and standup kernels), and those of the
PointPillars and multi-class calls under "pp_eval" / "pp_train" /
"mc_eval" (the mc eval's fp32 convs, bounded as 3xTF32 on the tensor
cores, with the bound at the CUDA cores' fp32 rate as "bound_cores_ms"). The last line is {"ok": true, "device": {...}}. With
--out, the per-call detail is written to that JSON file as well.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from second_tpu_torch.config import load_pipeline_config
from second_tpu_torch.core import box_np
from second_tpu_torch.data import ExamplePrep, PrepConfig, lidar_scan_scene
from second_tpu_torch.data.synthetic import SyntheticDataset
from second_tpu_torch.models import (build_two_stage_voxelnet,
                                     build_voxelnet, calibrate_norms_,
                                     compute_loss, compute_two_stage_loss,
                                     detect, init_train_weights_, predict,
                                     predict_two_stage)
from second_tpu_torch.ops import cuda as kernels
from second_tpu_torch.ops import nms as nms_ops
from second_tpu_torch.ops.anchors_mask import anchors_mask_from_coords
from second_tpu_torch.ops.box_ops import bev_boxes
from second_tpu_torch.ops.cuda import gather, riou, roi_align, subm
from second_tpu_torch.ops.rotated_iou import (_clip_halfplane, _next_vertex,
                                              _signed_area, rbbox_to_corners)
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import TrainState, make_train_step
from second_tpu_torch.train.steps_multistage import make_two_stage_steps

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "second_tpu_torch" / "configs" / "second_car_fhd.config"
BATCH, MAX_VOXELS, MAX_POINTS = 4, 40000, 30000
TIMED_FORWARDS = 12

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and fp32
# CUDA-core operations/s, and the TF32 tensor-core rate the fp32 sparse
# gather-GEMM runs at (3xTF32: three TF32 products for each fp32 one)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32_OPS_PER_S = 495e12
# fp32 operations of the rotated IoU, counted from the clip in
# csrc/riou.cu (a sin, cos, compare or select counts as one operation).
# Once a box: its corners (sin, cos, 4 corners x 11) and, as the clip quad,
# its winding sign (19). A pair: each of the four half-plane clips of an
# n-vertex polygon with e crossing edges takes 2 + 7n + 13e, the shoelace
# of the n >= 3 vertices left 4n + 2 (`riou_ops`), and the 2-D IoU from
# the two areas 6 (RIOU_IOU_OPS; the 3-D IoU takes D3_EXTRA_OPS instead).
RIOU_BOX_OPS = 46 + 19
RIOU_IOU_OPS = 6
# fp32 operations of one standup-bound test in nms_overlap (csrc/riou.cu),
# counted the same way: the envelopes' 2 max, 2 min, 2 differences and 2
# clamps, the product, the area sum, the union, its clamp, the quotient and
# the comparison; and of each box staged: RIOU_BOX_OPS, the envelope's 6
# min/max and its area
BOUND_TEST_OPS = 14
STANDUP_BOX_OPS = RIOU_BOX_OPS + 6 + 1

# the train step: batch, voxel capacity (the config's train reader), the
# overfit run's constant Adam lr and step budget, the timed steps
TRAIN_BATCH, TRAIN_VOXELS = 4, 16000
OVERFIT_LR, OVERFIT_STEPS = 1e-3, 100
TIMED_STEPS = 12

# PointPillars car (configs/pointpillars_car.config), the JAX bench's
# second leg: the eval batch, pillar capacity (the config's) and points
PP_CONFIG = REPO / "second_tpu_torch" / "configs" / "pointpillars_car.config"
PP_BATCH, PP_VOXELS, PP_POINTS = 4, 12000, 20000
# launches of one PointPillars eval forward: the row gather twice in the
# voxelizer and 4 times in predict (the candidates' box and anchor rows,
# the NMS candidates, the kept boxes), the NMS kernels once each for the
# batch, no sparse conv; of one train step: the voxelizer's two gathers
PP_EVAL_LAUNCHES = {"sparse_gather_gemm": 0, "row_gather": 6,
                    "rotated_iou": 1, "nms_suppress": 1,
                    "sparse_gather_gemm_dgrad": 0, "sparse_wgrad": 0,
                    "d3_iou": 0, "roi_align_fwd": 0, "roi_align_bwd": 0,
                    "standup_overlap": 0}
PP_TRAIN_LAUNCHES = {**{k: 0 for k in PP_EVAL_LAUNCHES}, "row_gather": 2}

# SECOND multi-class (configs/second_multiclass.config: Car, Pedestrian,
# Cyclist, per-class rotated NMS): eval at the config's eval batch (3) and
# voxel capacity (40 000), train at its train batch (3) and capacity
# (17 000) in bf16; the timed forwards and steps of these phases
MC_CONFIG = REPO / "second_tpu_torch" / "configs" / "second_multiclass.config"
MC_TIMED = 8
# the fake KITTI tree of the kitti phase: frames, ground clutter points
KITTI_FRAMES, KITTI_CLUTTER = 6, 20000
PATHS = ("fhd_eval", "fhd_train", "pp_eval", "pp_train", "mc_eval",
         "mc_train", "kitti", "fhd_iou_train", "2st_eval", "2st_train")
# the two-stage detector on second_car_fhd.config: proposals an example,
# the timed forwards and steps of its phases; its fp64 reference step runs
# the PointPillars config's two-stage detector (the sparse kernels take no
# fp64) on one example with fewer proposals
TWO_STAGE_PROPOSALS = 512
TWO_STAGE_TIMED = 8
TWO_STAGE_REF_PROPOSALS = 64
# its parameters after Adam's first step: see check_2st_train_reference
ADAM_STEP_TOL = 1e-6

# the PointPillars train step's reference, card against CPU. Its fp32
# gradients are ill-conditioned: a handful of ReLU inputs lie within fp32
# rounding of zero, so their sign, and whether their gradient passes,
# depends on the summation order (the forward agrees with fp64 to 1e-6 and
# replaying the fp64 ReLU masks brings every fp32 gradient within 1e-4:
# tests/test_torch_pointpillars_train.py). The CPU's own fp32 gradients lie
# up to 2% of their scale from the fp64 ones (one example), and which
# tensor comes out accurate depends on the summation order, so no fp32
# implementation meets the fhd phase's 1e-3 against another. The same
# function is held in fp64, card against CPU, on the same code path: the
# loss 1e-12 relative, every gradient within 1e-9 of its scale (fp64 sums
# in another order, the conditioning above), every parameter and norm
# statistic after the optimizer step within 1e-9. The fp32 step is held
# to the fp64 one: the loss 1e-4 relative; each of the card's gradients
# within the larger of 1e-3 of its scale and REF_FP32_NOISE times the
# step's fp32 noise, the largest error the CPU's fp32 step makes on any
# gradient (a wrong gradient is off by its own scale); each parameter
# after the step within 1e-6 of the CPU's fp32 one where the fp64
# gradient is above that tolerance (its sign settled on both devices), and
# elsewhere within the most the step can move it, lr (2 + wd |p|); the norm
# statistics within 1e-4 of the CPU's fp32 ones
REF64_LOSS_RTOL, REF64_TOL = 1e-12, 1e-9
REF_FP32_NOISE = 2.0

# stated tolerances, kernel against plain version on the same inputs
CONV_TOL = dict(atol=1e-4, rtol=1e-4)    # fp32 sums in another order
# the fp32 sparse convs against the plain version in fp64 on the same
# inputs: the kernel's relative error (largest error over the largest
# |reference|) at most this many times the fp32 plain version's own, so
# the kernel stays fp32-accurate (3xTF32), not TF32-accurate
FP32_ERR_RATIO = 2.0
# the backward kernels: fp32 sums of the same products in another order,
# within 1e-4 of the call's largest entry (gradients have no fixed scale)
GRAD_KERNEL_TOL = 1e-4
# a conv's backward against autograd of the plain gather-GEMM in fp32, on
# the bf16 path: the kernels round their fp32 sums to bf16 once, so one
# bf16 unit of the entry (2^-7 relative) plus 1e-6 of the largest entry
BF16_UNIT = 2.0 ** -7
# the fp32 train step, card against CPU: the loss 1e-4 relative; each
# gradient within 1e-3 of its tensor's largest entry (cuDNN and oneDNN sums
# in another order through 14 sparse convs and the RPN); each parameter
# after Adam's first step within 1e-6 where its gradient is above 1e-3 of
# the tensor's largest (the sign settled), elsewhere within the most that
# step can move it, lr (2 + wd |p|); the norm statistics 1e-4
REF_LOSS_RTOL, REF_GRAD_TOL, REF_PARAM_ATOL, REF_STAT_TOL = \
    1e-4, 1e-3, 1e-6, 1e-4
RIOU_TOL = 1e-5                          # same arithmetic (-fmad=false)
PRED_TOL = dict(atol=1e-3, rtol=1e-3)    # card vs CPU: cuDNN vs oneDNN sums
DET_TOL = dict(atol=1e-4, rtol=1e-4)

KERNELS = [
    dict(name="sparse_gather_gemm", module=subm, fn="gather_gemm",
         counter="launches", source="second_tpu_torch/csrc/subm.cu",
         replaces="second_tpu/ops/pallas/subm.py:82"),
    dict(name="row_gather", module=gather, fn="gather_rows",
         counter="launches", source="second_tpu_torch/csrc/gather.cu",
         replaces="second_tpu/ops/pallas/gather.py:57"),
    dict(name="rotated_iou", module=riou, fn="nms_overlap",
         counter="launches", source="second_tpu_torch/csrc/riou.cu",
         replaces="second_tpu/ops/pallas/riou.py:149"),
    dict(name="nms_suppress", module=riou, fn="nms_suppress",
         counter="launches_suppress", source="second_tpu_torch/csrc/riou.cu",
         replaces="second_tpu/ops/nms.py:44"),
]
# the train step's kernels: the gather-GEMM applied to the input gradient,
# and the weight gradient; both replace XLA's autodiff of the einsum that
# applies the rulebook in JAX (no Pallas kernel there has a VJP)
TRAIN_KERNELS = [
    dict(name="sparse_gather_gemm_dgrad", module=subm, fn="gather_gemm_dgrad",
         counter="launches_dgrad", source="second_tpu_torch/csrc/subm.cu",
         replaces="second_tpu/ops/sparse_conv.py:636"),
    dict(name="sparse_wgrad", module=subm, fn="sparse_wgrad",
         counter="launches_wgrad", source="second_tpu_torch/csrc/subm_grad.cu",
         replaces="second_tpu/ops/sparse_conv.py:636"),
]
# the IoU branch's kernel: the 3-D rotated IoU of its targets, the Pallas
# rotated-IoU kernel's geometry extended to 3-D (JAX computes it in XLA)
IOU_KERNELS = [
    dict(name="d3_iou", module=riou, fn="d3_iou", counter="launches_d3",
         source="second_tpu_torch/csrc/riou.cu",
         replaces="second_tpu/ops/rotated_iou.py:204"),
]
# the two-stage detector's kernels: the rotated ROI-align forward and
# backward, and the proposals' standup-NMS bitmask; they replace XLA code
# of the JAX package (gathers and their autodiff; a dense IoU matrix)
TWO_STAGE_KERNELS = [
    dict(name="roi_align_fwd", module=roi_align, fn="roi_align_fwd",
         counter="launches", source="second_tpu_torch/csrc/roi_align.cu",
         replaces="second_tpu/ops/roi_align_rotated.py:43"),
    dict(name="roi_align_bwd", module=roi_align, fn="roi_align_bwd",
         counter="launches_bwd", source="second_tpu_torch/csrc/roi_align.cu",
         replaces="second_tpu/ops/roi_align_rotated.py:43"),
    dict(name="standup_overlap", module=riou, fn="standup_overlap",
         counter="launches_standup", source="second_tpu_torch/csrc/riou.cu",
         replaces="second_tpu/ops/nms.py:183"),
]
ALL_KERNELS = KERNELS + TRAIN_KERNELS + IOU_KERNELS + TWO_STAGE_KERNELS
# the ROI-align kernels against their plain versions: the forward in the
# plain version's order of operations (-fmad=false), within ROI_FWD_TOL of
# the output's scale; the backward's sums in another order, within
# ROI_BWD_TOL of each gradient's scale (a bf16 trunk's plain backward runs
# on its fp32 copy: the kernel sums in fp32)
ROI_FWD_TOL, ROI_BWD_TOL = 1e-6, 1e-5
# crops card against CPU at the same proposal boxes: the sample points'
# sin and cos round an ulp apart on the two devices, which moves a sample
# of some 100 pixels by 1e-5 of a pixel
CROP_REF_TOL = 1e-4
# fp32 operations of the ROI-align, counted from csrc/roi_align.cu: a
# sample's taps (2 floors, 2 differences, 9 for the 4 weights, 8 bounds
# and 6 ands, 4 selects, 12 for the 4 offsets); an output bin's
# 8 s^2 + 1 (4 products and 4 sums a sample, the mean's division); in the
# backward, 2 an in-map tap and channel (the weighted product and its sum)
# plus 1 a sample and channel (g / s^2) for the map's gradient, and 15 a
# sample and channel for the coordinates' gradient
ROI_SAMPLE_OPS = 43
ROI_TAP_GRAD_OPS, ROI_SAMPLE_GRAD_OPS = 2, 1 + 15
# fp32 operations of one standup-IoU pair test (csrc/riou.cu
# `standup_overlap_kernel`): 2 max, 2 min, 2 differences, 2 comparisons
# and their and, the product and its select, the union's sum and
# difference, the quotient and its select, the threshold comparison and
# the bit's or; and of each box staged, its area (2 differences, 1
# product)
STANDUP_TEST_OPS = 17
STANDUP_AREA_OPS = 3
# fp32 operations of one clipped 3-D IoU pair beyond its BEV clip
# (csrc/riou.cu `d3_iou_kernel`): the min of the tops, the max of the
# bottoms, the overlap and its clamp, the product, the union (2) and its
# clamp, and the quotient
D3_EXTRA_OPS = 9
# ... of each box the kernel stages, counted the same way: RIOU_BOX_OPS
# (its corners and, as a gt box, its winding sign), the envelope's 12
# min/max, its top and volume 3, its tame flag 20 (7 magnitudes, 7
# comparisons, 6 ands), its solid flag 16 (4 magnitudes, 3 sums, 2
# products, 4 comparisons, 3 ands) and their packing 2; and of one pair's
# cull test: the x and y overlaps 2 x 3, the z overlap 3, the flags' and
# and two bit tests 3, 3 comparisons, 2 ors, 2 ands and the negation
D3_BOX_OPS = RIOU_BOX_OPS + 12 + 3 + 20 + 16 + 2
D3_TEST_OPS = 20
# the largest plain value of a culled pair (0 expected; a rounding sliver
# of the clip at most)
D3_CULLED_MAX = 1e-6
# the batched NMS is recorded too: its call is timed whole
RECORDED = [(k["module"], k["fn"]) for k in KERNELS] + [(nms_ops, "nms")]
# the multi-class forward: its kernels and its per-class NMS batch (every
# (example, class) row in one `nms_sorted` call)
MC_RECORDED = [(k["module"], k["fn"]) for k in KERNELS] + \
    [(nms_ops, "nms_sorted")]
RECORDED_TRAIN = [(subm, "gather_gemm")] + \
    [(k["module"], k["fn"]) for k in TRAIN_KERNELS]
# the two-stage forward's recorded calls: every kernel of its path
RECORDED_2ST = [(k["module"], k["fn"]) for k in KERNELS] + \
    [(roi_align, "roi_align_fwd"), (riou, "standup_overlap")]
RECORDED_2ST_TRAIN = RECORDED_TRAIN + \
    [(roi_align, "roi_align_fwd"), (roi_align, "roi_align_bwd"),
     (riou, "standup_overlap"), (riou, "nms_suppress")]
SPARSE_CONVS = 14      # 10 submanifold + 4 strided convs in SpMiddleFHD


def errors(got, want):
    """(max abs error, max abs error over the largest |reference|)."""
    if not want.numel():
        return 0.0, 0.0
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def fail(msg):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode or not out.stdout.strip():
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_syncs(fn):
    """Run fn under torch.cuda.set_sync_debug_mode("warn") and count the
    synchronising CUDA calls it made (torch warns once for each)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing" in str(w.message) for w in caught)


# ---------------------------------------------------------------- timing


class Timer:
    """Median device time of a callable by CUDA events, one pair per call,
    with the L2 cache flushed (a 128 MiB write) before each launch."""

    def __init__(self, device):
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device=device)

    def __call__(self, fn, reps):
        fn()                                        # warm-up
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


class DeviceTimer:
    """Median device-only time of each of a list of callables, from
    torch.profiler: each callable runs `reps` times, each time after an L2
    flush (an int16 fill, a kernel none of the callables launches), and one
    run's time is the sum of the device kernels between two flushes: no
    host time, no gaps."""

    PAD = 4
    RETRIES = 5

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.int16, device=device)
        self.flush_name = None
        self.kernels = []

    def _kernels(self, run):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)

    def __call__(self, fns, reps=5):
        """The median device ms of each callable; the median count of device
        kernels a run of each is left in `self.kernels`."""
        if self.flush_name is None:
            # an empty session is taken again, as the runs' are below
            for _ in range(self.RETRIES + 1):
                names = {n for _, _, n in
                         self._kernels(lambda: self.flush.fill_(1))}
                if names:
                    break
            if len(names) != 1:
                fail(f"device timer: the flush ran {sorted(names)}")
            self.flush_name = names.pop()
        for fn in fns:                               # warm-up
            fn()

        def run():
            # leading flushes: the trace can miss the first kernels of a
            # session, so the runs are counted from the end
            for _ in range(self.PAD):
                self.flush.fill_(1)
            for fn in fns:
                for _ in range(reps):
                    self.flush.fill_(1)
                    fn()
        n = len(fns) * reps
        # a profiling session can come back empty or short (seen once in
        # a dozen sessions of a run, and three in a row once); it is taken
        # again, at most RETRIES times
        for attempt in range(self.RETRIES + 1):
            runs, counts, seen = [], [], 0
            for start, end, name in self._kernels(run):
                seen += 1
                if name == self.flush_name:
                    runs.append(0.0)
                    counts.append(0)
                elif runs:
                    runs[-1] += (end - start) / 1e3
                    counts[-1] += 1
            if len(runs) >= n and not any(runs[-n - 1:-n]):
                break
            say(f"device timer: session {attempt + 1} traced {seen} "
                f"kernels, {len(runs)} flushes for {len(fns)} x {reps} "
                f"runs after {self.PAD} leading ones")
        else:
            fail(f"device timer: {len(runs)} flushes for {len(fns)} x "
                 f"{reps} runs after {self.PAD} leading ones, "
                 f"{self.RETRIES + 1} sessions")
        runs, counts = runs[-n:], counts[-n:]
        self.kernels = [statistics.median(counts[i * reps:(i + 1) * reps])
                        for i in range(len(fns))]
        return [statistics.median(runs[i * reps:(i + 1) * reps])
                for i in range(len(fns))]


def device_split(fn, dtimer, reps=5):
    """{device kernel name: (ms a call, launches a call)} of fn from
    torch.profiler: `reps` calls, each after the device timer's L2 flush,
    after its leading flushes (a session can miss its first kernels)."""
    from torch.profiler import ProfilerActivity, profile
    if dtimer.flush_name is None:
        dtimer([lambda: None], reps=1)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(dtimer.PAD):
            dtimer.flush.fill_(1)
        for _ in range(reps):
            dtimer.flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.name == dtimer.flush_name:
            continue
        ms, n = by.get(e.name, (0.0, 0))
        by[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                      n + 1)
    return {k: (ms / reps, n / reps) for k, (ms, n) in
            sorted(by.items(), key=lambda kv: -kv[1][0])}


# -------------------------------------------------------- the main path


def build_inputs(cfg, assigner, info, device, batch_size=BATCH):
    """The bench's fhd input: one LiDAR-scan scene (seed 0, 512 azimuth
    steps) prepared for eval and repeated `batch_size` times."""
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=MAX_POINTS, training=False))
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    rng = np.random.default_rng(0)
    p, b, n = lidar_scan_scene(rng, pc_range=pc_range, num_azimuth=512)
    ex = prep({"points": p, "gt_boxes": b, "gt_names": n, "image_idx": 0},
              rng)
    batch = prep.collate([ex] * batch_size)
    return [torch.as_tensor(batch[k], device=device)
            for k in ("points", "points_mask", "anchors")]


@contextmanager
def recording(wrappers=RECORDED):
    """Record the arguments of every call of the (module, name) wrappers made
    through the port's modules (each module that imported a wrapper by name
    sees the recording one)."""
    calls = {fn: [] for _, fn in wrappers}
    originals = {fn: getattr(mod, fn) for mod, fn in wrappers}

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("second_tpu_torch"):
            continue
        for name, fn in originals.items():
            if getattr(mod, name, None) is fn:
                patched.append((mod, name, fn))
                setattr(mod, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


# ------------------------------------------------- kernel versus plain


def conv_library(features, tap_idx, found, weights):
    """One gather of the tap stack plus a batched product over taps: the
    library yardstick of the sparse gather-GEMM."""
    B, N, C = features.shape
    K, Q = tap_idx.shape[1:]
    off = (torch.arange(B, device=features.device) * N).view(B, 1, 1)
    rows = (tap_idx.long() + off).permute(1, 0, 2).reshape(-1)
    taps = features.reshape(B * N, C).index_select(0, rows)
    taps = taps * found.permute(1, 0, 2).reshape(-1, 1)
    w = weights.to(features.dtype)
    prod = torch.bmm(taps.view(K, B * Q, C), w)
    return prod.float().sum(0).view(B, Q, -1)


def conv_bound(features, tap_idx, found, weights):
    """(bytes seconds, ops seconds) of one sparse conv, counted from what
    this run's rulebook needs: the found mask (one byte a tap), the int32
    row index of each found tap (the only ones read), each feature row
    that some found tap references, once, the weights in the feature dtype
    and the fp32 output, written once; 2*C*D operations per found tap."""
    B, N, C = features.shape
    D = weights.shape[2]
    Q = tap_idx.shape[2]
    n_found = int(found.sum())
    off = (torch.arange(B, device=features.device) * N).view(B, 1, 1)
    rows = int(torch.unique((tap_idx.long() + off)[found]).numel())
    esz = features.element_size()
    nbytes = (found.numel() + 4 * n_found + rows * C * esz +
              weights.numel() * esz + B * Q * D * 4)
    ops = 2.0 * C * D * n_found
    return nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[features.dtype]


def conv_occupancy(found):
    """Shares of the found taps, and of the (16-row block, tap) and
    (128-row tile, tap) pairs of the batch-flattened rows (m = b*Q + q) in
    which some tap is found: the work the tensor-core kernel keeps after its
    votes (it skips the other pairs)."""
    B, K, Q = found.shape
    f = found.permute(1, 0, 2).reshape(K, B * Q).to(torch.uint8)

    def share(rows):
        g = torch.nn.functional.pad(f, (0, -f.shape[1] % rows))
        return g.view(K, -1, rows).amax(-1).float().mean().item()
    return dict(found_share=f.float().mean().item(), block16_share=share(16),
                tile128_share=share(128))


def riou_ops(boxes1, boxes2, i, j, pair_ops=RIOU_IOU_OPS):
    """fp32 operations that these pairs need beyond their boxes' own
    (RIOU_BOX_OPS): each pair's polygon is clipped as the plain version
    clips it, each clip charged for the vertices it walks and the edges
    that cross, and `pair_ops` more a pair."""
    q1 = rbbox_to_corners(boxes1)[i.long()]
    q2 = rbbox_to_corners(boxes2)[j.long()]
    P = q1.shape[0]
    poly = torch.cat([q1, q1.new_zeros(P, 4, 2)], 1)
    cnt = torch.full((P,), 4, dtype=torch.int64, device=q1.device)
    s = torch.sign(_signed_area(q2))
    s = torch.where(s == 0, 1.0, s)
    ops = torch.full((P,), pair_ops, dtype=torch.int64, device=q1.device)
    slots = torch.arange(8, device=q1.device)
    for k in range(4):
        a, b = q2[:, k], q2[:, (k + 1) % 4]
        ab = b - a

        def side(p):
            return s[:, None] * (ab[:, None, 0] * (p[..., 1] - a[:, None, 1])
                                 - ab[:, None, 1] * (p[..., 0] -
                                                     a[:, None, 0])) >= 0
        crossing = (slots < cnt[:, None]) & \
            (side(poly) != side(_next_vertex(poly, cnt)))
        ops += 2 + 7 * cnt + 13 * crossing.sum(1)
        poly, cnt = _clip_halfplane(poly, cnt, a, b, s)
    ops += torch.where(cnt >= 3, 4 * cnt + 2, 0)
    return int(ops.sum())


def fp64_gate(args, got, tag):
    """An fp32 sparse conv's kernel output against the plain version in
    fp64 on the same inputs: its relative error at most FP32_ERR_RATIO
    times the fp32 plain version's own. Returns both errors."""
    f, tap_idx, found, w = args
    want = subm.gather_gemm_plain(f.double(), tap_idx, found, w.double())
    plain = subm.gather_gemm_plain(f, tap_idx, found, w)
    kernel_err = errors(got.double(), want)[1]
    plain_err = errors(plain.double(), want)[1]
    if kernel_err > FP32_ERR_RATIO * plain_err:
        fail(f"{tag}: {kernel_err:.3g} of the scale from the fp64 plain "
             f"version, over {FP32_ERR_RATIO} times the fp32 plain "
             f"version's {plain_err:.3g}")
    return dict(fp64_rel_err=kernel_err, plain_fp64_rel_err=plain_err)


def check_convs(calls, timer, dtimer, detail):
    """Each recorded sparse conv against its plain version (CONV_TOL), in
    its own dtype and in fp32 (fp32 also against fp64: `fp64_gate`), the
    own dtype's call timed by events and by the device timer beside the
    library yardstick, with its bound: `conv_bound` for bf16; for fp32,
    which runs as 3xTF32 on the tensor cores, the found taps' operations
    three times over at the TF32 tensor-core rate, or bytes, beside
    `conv_bound`'s count at the CUDA cores' fp32 rate ("cores"). Returns
    the aggregate."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0,
               library_device_ms=0.0, bytes_s=0.0, ops_s=0.0,
               ops_cores_s=0.0, err=0.0, fp64_ratio=0.0)
    timed = []
    for i, (args, _) in enumerate(calls):
        f, tap_idx, found, w = args
        occupancy = conv_occupancy(found)
        # the main path's own dtype, then fp32 inputs
        for dtype in dict.fromkeys((f.dtype, torch.float32)):
            fx = f.to(dtype)
            paths = (subm.launches_mma, subm.launches_fma)
            got = subm.gather_gemm(fx, tap_idx, found, w)
            want = subm.gather_gemm_plain(fx, tap_idx, found, w)
            torch.cuda.synchronize()
            path = "mma" if dtype == torch.bfloat16 else "fma"
            moved = (subm.launches_mma - paths[0], subm.launches_fma - paths[1])
            if moved != ((1, 0) if path == "mma" else (0, 1)):
                fail(f"conv {i} {dtype}: took the wrong kernel path "
                     f"(mma, fma launches {moved}, expected the {path} one)")
            err, rel = errors(got, want)
            ok = torch.allclose(got, want, **CONV_TOL)
            B, N, C = fx.shape
            K, Q = tap_idx.shape[1:]
            D = w.shape[2]
            tag = (f"conv {i:2d} {str(dtype)[6:]:8s} {path} B={B} N={N} "
                   f"Q={Q} K={K} {C}->{D}")
            if not ok:
                fail(f"{tag}: kernel disagrees with plain, max abs err "
                     f"{err:.3g} over {CONV_TOL}")
            row = dict(call=i, dtype=str(dtype), path=path, B=B, N=N, Q=Q,
                       K=K, C=C, D=D, max_abs_err=err, max_rel_err=rel,
                       found=int(found.sum()), **occupancy)
            if dtype == torch.float32:
                row.update(fp64_gate((fx, tap_idx, found, w), got, tag))
                agg["fp64_ratio"] = max(
                    agg["fp64_ratio"], row["fp64_rel_err"] /
                    max(row["plain_fp64_rel_err"], 1e-30))
            if dtype == f.dtype:
                row["ms"] = timer(lambda: subm.gather_gemm(fx, tap_idx, found,
                                                           w), 20)
                row["plain_ms"] = timer(lambda: subm.gather_gemm_plain(
                    fx, tap_idx, found, w), 5)
                row["library_ms"] = timer(lambda: conv_library(
                    fx, tap_idx, found, w), 5)
                bs, os_ = conv_bound(fx, tap_idx, found, w)
                if dtype == torch.float32:
                    row["bound_cores_ms"] = 1e3 * max(bs, os_)
                    agg["ops_cores_s"] += os_
                    os_ = 3 * 2.0 * C * D * row["found"] / PEAK_TF32_OPS_PER_S
                row["bound_ms"] = 1e3 * max(bs, os_)
                row["bound_by"] = "bytes" if bs >= os_ else "operations"
                for k in ("ms", "plain_ms", "library_ms"):
                    agg[k] += row[k]
                agg["bytes_s"] += bs
                agg["ops_s"] += os_
                timed.append((tag, row, (fx, tap_idx, found, w)))
            else:
                say(f"{tag}: err {err:.2e} rel {rel:.2e}  fp64: kernel "
                    f"{row['fp64_rel_err']:.2e} plain "
                    f"{row['plain_fp64_rel_err']:.2e}")
            agg["err"] = max(agg["err"], err)
            detail.append(row)
    # device-only times of the same calls, kernel and library
    kernel_dev = dtimer([lambda a=a: subm.gather_gemm(*a)
                         for _, _, a in timed])
    library_dev = dtimer([lambda a=a: conv_library(*a) for _, _, a in timed])
    for (tag, row, _), kd, ld in zip(timed, kernel_dev, library_dev):
        row["device_ms"], row["library_device_ms"] = kd, ld
        agg["device_ms"] += kd
        agg["library_device_ms"] += ld
        fp64 = (f"  fp64: kernel {row['fp64_rel_err']:.2e} plain "
                f"{row['plain_fp64_rel_err']:.2e}  bound at the CUDA cores' "
                f"fp32 rate {row['bound_cores_ms']:.4f} ms"
                if "bound_cores_ms" in row else "")
        say(f"{tag}: err {row['max_abs_err']:.2e} rel "
            f"{row['max_rel_err']:.2e}  taps found {row['found_share']:.3f}"
            f" blocks {row['block16_share']:.3f} tiles "
            f"{row['tile128_share']:.3f}  kernel {row['ms']:.4f} ms "
            f"(device {kd:.4f})  plain {row['plain_ms']:.4f} ms  library "
            f"{row['library_ms']:.4f} ms (device {ld:.4f})  bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})" + fp64)
    say(f"convs: {len(timed)} calls; kernel {agg['ms']:.4f} ms (device "
        f"{agg['device_ms']:.4f})  library {agg['library_ms']:.4f} ms "
        f"(device {agg['library_device_ms']:.4f})  bound "
        f"{1e3 * max(agg['bytes_s'], agg['ops_s']):.4f} ms" +
        (f"  bound at the CUDA cores' fp32 rate "
         f"{1e3 * max(agg['bytes_s'], agg['ops_cores_s']):.4f} ms"
         if agg["ops_cores_s"] else "") +
        f"; fp32 error against fp64 at most {agg['fp64_ratio']:.3f} times "
        f"the fp32 plain version's")
    return agg


def check_gathers(calls, timer, dtimer, detail):
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0,
               library_device_ms=0.0, bytes_s=0.0, ops_s=0.0, err=0.0)
    for i, (args, _) in enumerate(calls):
        src, idx = args
        got = gather.gather_rows(src, idx)
        want = gather.gather_rows_plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather {i}: kernel disagrees with plain (must be exact)")
        row_bytes = src.shape[1] * src.element_size()
        M = idx.numel()
        # the indices as the caller gives them, the referenced rows once,
        # the output once
        nbytes = M * idx.element_size() + \
            int(torch.unique(idx).numel()) * row_bytes + M * row_bytes
        row = dict(call=i, dtype=str(src.dtype), idx_dtype=str(idx.dtype),
                   R=src.shape[0], M=M, row_bytes=row_bytes, max_abs_err=0.0,
                   ms=timer(lambda: gather.gather_rows(src, idx), 20),
                   plain_ms=timer(lambda: gather.gather_rows_plain(
                       src, idx), 5),
                   library_ms=timer(lambda: torch.index_select(
                       src, 0, idx), 5),
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
        for k in ("ms", "plain_ms", "library_ms"):
            agg[k] += row[k]
        agg["bytes_s"] += nbytes / HBM_BYTES_PER_S
        detail.append(row)
    kernel_dev = dtimer([lambda a=a: gather.gather_rows(*a)
                         for a, _ in calls])
    library_dev = dtimer([lambda a=a: torch.index_select(a[0], 0, a[1])
                          for a, _ in calls])
    big = dict(device_ms=0.0, library_device_ms=0.0, bound_ms=0.0, n=0)
    for row, kd, ld in zip(detail, kernel_dev, library_dev):
        row["device_ms"], row["library_device_ms"] = kd, ld
        agg["device_ms"] += kd
        agg["library_device_ms"] += ld
        if row["M"] >= 1_000_000:
            big["n"] += 1
            for k in ("device_ms", "library_device_ms", "bound_ms"):
                big[k] += row[k]
        say(f"gather {row['call']:2d} {row['dtype'][6:]:8s} "
            f"[{row['R']}, {row['row_bytes']} B] <- {row['M']} "
            f"{row['idx_dtype'][6:]}: kernel {row['ms']:.4f} ms (device "
            f"{kd:.4f})  index_select {row['library_ms']:.4f} ms (device "
            f"{ld:.4f})  bound {row['bound_ms']:.4f} ms")
    say(f"gather: {len(calls)} calls exact; kernel {agg['ms']:.4f} ms "
        f"(device {agg['device_ms']:.4f})  plain {agg['plain_ms']:.4f} ms  "
        f"index_select {agg['library_ms']:.4f} ms (device "
        f"{agg['library_device_ms']:.4f})  bound "
        f"{1e3 * agg['bytes_s']:.4f} ms")
    if big["n"]:
        say(f"gather: the {big['n']} calls of 1 M+ rows: kernel device "
            f"{big['device_ms']:.4f} ms  index_select device "
            f"{big['library_device_ms']:.4f} ms  bound "
            f"{big['bound_ms']:.4f} ms  (kernel "
            f"{big['device_ms'] / big['bound_ms']:.2f} x bound)")
    return agg


def old_nms(boxes, scores, valid, *, pre_max_size, post_max_size,
            iou_threshold, max_pairs=8192):
    """The rotated NMS that the batched one replaced, one example at a time:
    a dense standup bound, a `nonzero` pair list cut at the cap, the pair
    kernel `riou_pairs`, a dense overlap matrix and frontier rounds on the
    host. The yardstick of the batched NMS, with the same results."""
    idxs, keeps = [], []
    for b in range(boxes.shape[0]):
        masked = torch.where(valid[b], scores[b], float("-inf"))
        k = min(pre_max_size, boxes.shape[1])
        top_scores, top_idx = nms_ops.top_k(masked, k)
        top_valid = torch.isfinite(top_scores)
        cand = gather.gather_rows(boxes[b], top_idx)
        maybe = riou.standup_maybe(cand[None], top_valid[None],
                                   iou_threshold)[0]
        plist = torch.nonzero(maybe.reshape(-1))[:min(max_pairs, k * k), 0]
        iou = riou.riou_pairs(cand, cand, plist // k, plist % k)
        over = torch.zeros((k * k,), dtype=torch.float32, device=cand.device)
        over[plist] = (iou > iou_threshold).float()
        over = over.reshape(k, k)
        undecided, kept = top_valid.clone(), torch.zeros_like(top_valid)
        while bool(undecided.any()):
            blocked = (undecided.float() @ over) > 0.5
            suppressed = (kept.float() @ over) > 0.5
            newly_kept = undecided & ~blocked & ~suppressed
            kept = kept | newly_kept
            undecided = undecided & ~newly_kept & ~suppressed
        out, sel = nms_ops.top_k(torch.where(kept, top_scores,
                                             float("-inf")),
                                 min(post_max_size, k))
        idxs.append(top_idx[sel])
        keeps.append(torch.isfinite(out))
    return torch.stack(idxs), torch.stack(keeps)


def check_nms_pair(calls, timer, dtimer, what="nms"):
    """The one recorded `nms_overlap` call and the one `nms_suppress` call
    of a forward against their plain versions on the same inputs: pair
    counts exact, bits exact but at pairs within RIOU_TOL of the threshold,
    keep exact (on the kernel's bitmask and along the all-plain chain);
    timed by events and by the device timer, with their bounds. Returns
    (overlap aggregate, suppression aggregate, detail)."""
    if len(calls["nms_overlap"]) != 1 or len(calls["nms_suppress"]) != 1:
        fail(f"{what}: expected one overlap and one suppression call a "
             f"forward, recorded {len(calls['nms_overlap'])} and "
             f"{len(calls['nms_suppress'])}")
    (cand, valid, thr, max_pairs), _ = calls["nms_overlap"][0]
    B, K = valid.shape
    got, count = riou.nms_overlap(cand, valid, thr, max_pairs)
    want, want_count = riou.nms_overlap_plain(cand, valid, thr, max_pairs)
    torch.cuda.synchronize()
    if not torch.equal(count, want_count):
        fail(f"{what} nms_overlap: pair counts {count.tolist()} against the "
             f"plain version's {want_count.tolist()}")
    diff = riou.unpack_bits(got, K) != riou.unpack_bits(want, K)
    flat = cand.reshape(B * K, 5)
    near = []
    if diff.any():
        b, i, j = diff.nonzero(as_tuple=True)
        iou = riou.riou_pairs_plain(flat, flat, b * K + i, b * K + j)
        near = [dict(b=int(x), i=int(y), j=int(z), iou=float(v),
                     margin=float(v - thr))
                for x, y, z, v in zip(b, i, j, iou)]
    for pair in near:
        say(f"{what} nms_overlap: bit differs at row {pair['b']} pair "
            f"({pair['i']}, {pair['j']}): plain IoU {pair['iou']:.9g}, "
            f"{pair['margin']:+.3g} from the threshold")
    if any(abs(pair["margin"]) > RIOU_TOL for pair in near):
        fail(f"{what} nms_overlap: a bit differs further than {RIOU_TOL} "
             f"from the threshold")
    keep = riou.nms_suppress(got, valid)
    same_in = riou.nms_suppress_plain(got, valid)
    plain_keep = riou.nms_suppress_plain(want, valid)
    torch.cuda.synchronize()
    if not torch.equal(keep, same_in):
        fail(f"{what} nms_suppress: keep differs from the plain version's "
             f"on the same bitmask")
    if not torch.equal(keep, plain_keep):
        fail(f"{what} nms_suppress: keep differs from the all-plain chain's")
    (sup_over, sup_valid), _ = calls["nms_suppress"][0]
    if not torch.equal(sup_over, got) or not torch.equal(sup_valid, valid):
        fail(f"{what} nms_suppress: the recorded call's bitmask is not the "
             f"overlap kernel's")

    # bounds, from this run's data: the valid pairs' bound tests, the boxes
    # staged, and the capped pairs' clips; bytes: boxes, valid flags and
    # counts in, bitmask out (the suppression reads it and the flags once
    # and writes keep)
    n_valid = valid.sum(1).double()
    pb, lin, _ = riou.capped_pairs(cand, valid, thr, max_pairs)
    clip_ops = riou_ops(flat, flat, pb * K + lin // K, pb * K + lin % K)
    tests = float((n_valid * (n_valid - 1) / 2).sum())
    ops = tests * BOUND_TEST_OPS + B * K * STANDUP_BOX_OPS + clip_ops
    ov_bytes = cand.numel() * 4 + valid.numel() + got.numel() * 4 + B * 4
    sup_bytes = got.numel() * 4 + 2 * valid.numel()
    ov = dict(bytes_s=ov_bytes / HBM_BYTES_PER_S,
              ops_s=ops / PEAK_OPS_PER_S[torch.float32])
    sup = dict(bytes_s=sup_bytes / HBM_BYTES_PER_S, ops_s=0.0)
    dev_ms = dtimer([lambda: riou.nms_overlap(cand, valid, thr, max_pairs),
                     lambda: riou.nms_suppress(got, valid)])
    ov.update(ms=timer(lambda: riou.nms_overlap(cand, valid, thr,
                                                max_pairs), 20),
              device_ms=dev_ms[0],
              plain_ms=timer(lambda: riou.nms_overlap_plain(
                  cand, valid, thr, max_pairs), 5),
              library_ms=None, library_device_ms=None, err=0.0)
    sup.update(ms=timer(lambda: riou.nms_suppress(got, valid), 20),
               device_ms=dev_ms[1],
               plain_ms=timer(lambda: riou.nms_suppress_plain(got, valid),
                              5),
               library_ms=None, library_device_ms=None, err=0.0)
    detail = dict(
        B=B, K=K, max_pairs=max_pairs, threshold=thr,
        pair_count=count.tolist(), clipped=int(pb.numel()),
        overlaps=int(riou.unpack_bits(got, K).sum()),
        kept=keep.sum(1).tolist(), near_threshold=near,
        ops_per_clipped_pair=clip_ops / max(int(pb.numel()), 1),
        bound_tests=tests,
        nms_overlap={k: v for k, v in ov.items() if k != "err"},
        nms_suppress={k: v for k, v in sup.items() if k != "err"})
    say(f"{what} nms_overlap B={B} K={K} cap={max_pairs}: pair counts "
        f"{count.tolist()} exact, {int(pb.numel())} pairs clipped "
        f"({clip_ops / max(int(pb.numel()), 1):.1f} ops a pair), "
        f"{len(near)} bits differ near the threshold; kernel "
        f"{ov['ms']:.4f} ms (device {ov['device_ms']:.4f})  plain "
        f"{ov['plain_ms']:.4f} ms  bound "
        f"{1e3 * max(ov['bytes_s'], ov['ops_s']):.6f} ms")
    say(f"{what} nms_suppress: keep exact ({keep.sum(1).tolist()} kept); "
        f"kernel {sup['ms']:.4f} ms (device {sup['device_ms']:.4f})  plain "
        f"{sup['plain_ms']:.4f} ms  bound {1e3 * sup['bytes_s']:.6f} ms")
    return ov, sup, detail


def check_riou(calls, timer, dtimer, detail, device, matrix=True):
    """The batched rotated NMS of the recorded forward: the overlap kernel
    (`nms_overlap`, the rotated IoU) and the suppression kernel against
    their plain versions on the same inputs, timed (`check_nms_pair`), each
    cluster shape of the overlap kernel timed, and the whole NMS against
    the per-example path it replaced; then, with `matrix`, the dense matrix
    entry point. Returns the two kernels' aggregates."""
    if len(calls["nms"]) != 1:
        fail(f"expected one batched NMS call a forward, recorded "
             f"{len(calls['nms'])}")
    ov, sup, pair = check_nms_pair(calls, timer, dtimer)
    (cand, valid, thr, max_pairs), _ = calls["nms_overlap"][0]
    B = valid.shape[0]
    got = riou.nms_overlap(cand, valid, thr, max_pairs)[0]
    nms_args, nms_kwargs = calls["nms"][0]
    new_idx, new_keep = nms_ops.nms(*nms_args, **nms_kwargs)
    old_idx, old_keep = old_nms(*nms_args, **nms_kwargs)
    if not (torch.equal(new_idx, old_idx) and torch.equal(new_keep,
                                                          old_keep)):
        fail("batched NMS differs from the per-example path")
    fns = [lambda: nms_ops.nms(*nms_args, **nms_kwargs),
           lambda: old_nms(*nms_args, **nms_kwargs)]
    fns += [lambda c=c: riou.nms_overlap(cand, valid, thr, max_pairs, c)
            for c in riou.NMS_CLUSTERS]
    dev_ms = dtimer(fns)
    for c in riou.NMS_CLUSTERS:
        if not torch.equal(riou.nms_overlap(cand, valid, thr, max_pairs,
                                            c)[0], got):
            fail(f"nms_overlap: cluster {c} gives another bitmask")
    cluster_ms = dict(zip(riou.NMS_CLUSTERS, dev_ms[2:]))
    whole = dict(ms=timer(fns[0], 20), device_ms=dev_ms[0],
                 old_ms=timer(fns[1], 10), old_device_ms=dev_ms[1])
    detail.append(dict(
        pair, cluster_device_ms={str(c): v for c, v in cluster_ms.items()},
        whole_nms=whole))
    say("nms_overlap device ms by cluster shape: " + ", ".join(
        f"{c} blocks {v:.4f}" for c, v in cluster_ms.items()) +
        f" (the wrapper's default: {riou.NMS_CLUSTER})")
    say(f"whole NMS (batch {B}): batched {whole['ms']:.4f} ms (device "
        f"{whole['device_ms']:.4f})  per-example path it replaced "
        f"{whole['old_ms']:.4f} ms (device {whole['old_device_ms']:.4f}); "
        f"same indices and keep")

    if not matrix:
        return ov, sup
    # the dense entry point, off the main path: crowded random boxes
    g = torch.Generator().manual_seed(1)
    n = 1000
    boxes = torch.stack([torch.rand(n, generator=g) * 40,
                         torch.rand(n, generator=g) * 40 - 20,
                         0.5 + 2.5 * torch.rand(n, generator=g),
                         0.5 + 5.5 * torch.rand(n, generator=g),
                         (torch.rand(n, generator=g) - 0.5) * 2 * np.pi],
                        1).to(device)
    for crit in (-1, 0, 1):
        got_m = riou.riou_matrix(boxes, boxes, crit)
        want_m = riou.riou_matrix_plain(boxes, boxes, crit)
        torch.cuda.synchronize()
        err, rel = errors(got_m, want_m)
        if err > RIOU_TOL:
            fail(f"riou matrix criterion {crit}: max abs err {err:.3g}")
        ov["err"] = max(ov["err"], err)
        ms = timer(lambda: riou.riou_matrix(boxes, boxes, crit), 10)
        pms = timer(lambda: riou.riou_matrix_plain(boxes, boxes, crit), 3)
        detail.append(dict(matrix=n, criterion=crit, max_abs_err=err, ms=ms,
                           plain_ms=pms,
                           overlapping=int((want_m > 0).sum())))
        say(f"riou matrix {n}x{n} criterion {crit}: err {err:.2e} rel "
            f"{rel:.2e}  kernel {ms:.4f} ms  plain {pms:.4f} ms")
    return ov, sup


# ---------------------------------------------------------------- main


def launch_counts():
    return {k["name"]: getattr(k["module"], k["counter"])
            for k in ALL_KERNELS}


def conv_path_counts():
    return {"mma": subm.launches_mma, "fma": subm.launches_fma,
            "wgrad_mma": subm.launches_wgrad_mma,
            "wgrad_fma": subm.launches_wgrad_fma}


def reset_counts():
    for k in ALL_KERNELS:
        setattr(k["module"], k["counter"], 0)
    subm.launches_mma = subm.launches_fma = 0
    subm.launches_wgrad_mma = subm.launches_wgrad_fma = 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path,
                        help="also write the per-call detail to this JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available",
              file=sys.stderr)
        sys.exit(1)
    run(torch.device("cuda", 0), args.out)


@torch.no_grad()
def run(dev, out=None):
    # fp32 checks compare against full-fp32 products: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    card = card_line()
    say(f"card: {card}")
    report["card"] = card
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = kernels.build()
    secs = time.perf_counter() - t0
    say(f"build: {sorted(logs)} in {secs:.2f} s")
    for name, log in sorted(logs.items()):
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()[:48]
            elif "registers" in line or "spill" in line:
                say(f"  ptxas {name} {fn}: {line.strip()}")
    report["build_s"] = secs
    report["ptxas"] = logs

    cfg = load_pipeline_config(CONFIG)
    mixed = cfg.train_config.enable_mixed_precision
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device=dev, mixed_precision=mixed, seed=0)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    points, mask, anchors = build_inputs(cfg, assigner, info, dev)
    say(f"inputs: points {tuple(points.shape)} ({int(mask.sum())} valid), "
        f"anchors {tuple(anchors.shape)}, mixed precision {mixed}")

    def forward():
        return detect(net, spec, vspec, points, mask, anchors, device=dev)

    with recording() as calls:
        forward()
        torch.cuda.synchronize()
    say("capture: " + ", ".join(f"{k} {len(v)} calls"
                                for k, v in calls.items()))
    nms_call = calls["nms"][0]
    if len(calls["gather_gemm"]) != SPARSE_CONVS:
        fail(f"expected {SPARSE_CONVS} sparse convs per forward, recorded "
             f"{len(calls['gather_gemm'])}")

    timer, dtimer = Timer(dev), DeviceTimer(dev)
    detail = {"sparse_gather_gemm": [], "row_gather": [], "rotated_iou": []}
    aggs = {
        "sparse_gather_gemm": check_convs(calls["gather_gemm"], timer,
                                          dtimer,
                                          detail["sparse_gather_gemm"]),
        "row_gather": check_gathers(calls["gather_rows"], timer, dtimer,
                                    detail["row_gather"]),
    }
    aggs["rotated_iou"], aggs["nms_suppress"] = check_riou(
        calls, timer, dtimer, detail["rotated_iou"], dev)
    del calls
    report["calls"] = detail

    # the main path, counted
    reset_counts()
    det, vox, preds = forward()
    torch.cuda.synchronize()
    counts = launch_counts()
    paths = conv_path_counts()
    say(f"launches in one forward: {counts}; sparse gather-GEMM by path: "
        f"{paths}")
    if counts["sparse_gather_gemm"] != SPARSE_CONVS:
        fail(f"sparse gather-GEMM launched {counts['sparse_gather_gemm']} "
             f"times, expected {SPARSE_CONVS}")
    if mixed and (paths["mma"], paths["fma"]) != (SPARSE_CONVS, 0):
        fail(f"not every bf16 sparse conv took the tensor-core path: "
             f"{paths}")
    if counts["rotated_iou"] != 1 or counts["nms_suppress"] != 1:
        fail(f"the NMS kernels launched {counts['rotated_iou']} and "
             f"{counts['nms_suppress']} times, expected once each for the "
             f"batch")
    if not all(counts[k["name"]] for k in KERNELS):
        fail(f"a kernel of the main path never launched: {counts}")
    if counts["sparse_gather_gemm_dgrad"] or counts["sparse_wgrad"]:
        fail(f"the eval forward launched a backward kernel: {counts}")
    say(f"row gathers in one forward: {counts['row_gather']}")
    # predict without a host sync: torch raises on a synchronising call
    predict_fails_on_sync(spec, preds, anchors, "fhd eval")
    say("predict: no host sync (torch.cuda.set_sync_debug_mode('error'))")
    report["forward_host_syncs"] = host_syncs(forward)
    say(f"forward: {report['forward_host_syncs']} host syncs in one forward "
        f"(torch.cuda.set_sync_debug_mode('warn'))")

    A = anchors.shape[1]
    for k, shape in (("box_preds", (BATCH, A, spec.box_code_size)),
                     ("cls_preds", (BATCH, A, 1))):
        if tuple(preds[k].shape) != shape or \
                not torch.isfinite(preds[k]).all():
            fail(f"{k}: shape {tuple(preds[k].shape)} (want {shape}) or "
                 f"non-finite values")
    n_valid = det["valid"].sum(1).tolist()
    if not all(torch.isfinite(det[k]).all() for k in ("boxes", "scores")):
        fail("non-finite detections")
    say(f"forward: voxel_overflow {int(vox['voxel_overflow'])} "
        f"stage_overflow {int(preds['stage_overflow'])} voxels "
        f"{vox['voxel_valid'].sum(1).tolist()} valid detections {n_valid}")

    times = []
    for _ in range(TIMED_FORWARDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    # one forward split at its stage boundaries (synchronised)
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        v = device_voxelize(vspec, points, mask, dev)
        torch.cuda.synchronize()
        stages["voxelize_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        p = net(v["voxels"], v["num_points"], v["coordinates"],
                v["voxel_valid"])
        torch.cuda.synchronize()
        stages["network_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        predict(spec, p, anchors)
        torch.cuda.synchronize()
        stages["predict_ms"] = 1e3 * (time.perf_counter() - t0)
    report["forward"] = dict(
        batch=BATCH, median_s=med, frames_per_s=BATCH / med, times_s=times,
        peak_mem_bytes=torch.cuda.max_memory_allocated(dev), **stages,
        voxel_overflow=int(vox["voxel_overflow"]),
        stage_overflow=int(preds["stage_overflow"]), valid=n_valid,
        launches=counts, conv_paths=paths)
    say(f"frames/s {BATCH / med:.3f} (median {1e3 * med:.2f} ms of "
        f"{TIMED_FORWARDS} batch-{BATCH} forwards; one split: "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + ")")

    report["profile"] = profile_forward(forward, med)
    report["reference"] = check_reference(cfg, vspec, points, mask, anchors,
                                          dev, spec, preds, nms_call)

    train_aggs, train_counts, report["train"] = run_train(cfg, dev, timer,
                                                          dtimer)
    aggs.update(train_aggs)
    pp_eval_aggs, pp_eval_counts, report["pp_eval"] = run_pp_eval(
        dev, timer, dtimer)
    pp_train_aggs, pp_train_counts, report["pp_train"] = run_pp_train(
        dev, timer, dtimer)
    mc_eval_aggs, mc_eval_counts, report["mc_eval"] = run_mc_eval(
        dev, timer, dtimer)
    mc_train_counts, report["mc_train"] = run_mc_train(dev, timer, dtimer)
    kitti_counts, report["kitti"] = run_kitti(dev, timer, dtimer)
    aggs["d3_iou"], iou_counts, report["fhd_iou_train"] = run_fhd_iou_train(
        dev, timer, dtimer)
    two_aggs, two_counts, report["2st_eval"] = run_2st_eval(dev, timer,
                                                            dtimer)
    aggs.update(two_aggs)
    aggs["roi_align_bwd"], two_train_counts, report["2st_train"] = \
        run_2st_train(dev, timer, dtimer)
    by_path = dict(zip(PATHS, (counts, train_counts, pp_eval_counts,
                               pp_train_counts, mc_eval_counts,
                               mc_train_counts, kitti_counts, iou_counts,
                               two_counts, two_train_counts)))
    path_aggs = {"pp_eval": pp_eval_aggs, "pp_train": pp_train_aggs,
                 "mc_eval": mc_eval_aggs}

    def numbers(a):
        out = dict(max_abs_err=a["err"], ms=a["ms"], plain_ms=a["plain_ms"],
                   bound_ms=1e3 * max(a["bytes_s"], a["ops_s"]),
                   bound_by="bytes" if a["bytes_s"] >= a["ops_s"]
                   else "operations",
                   library_ms=a["library_ms"], device_ms=a["device_ms"],
                   library_device_ms=a["library_device_ms"])
        if a.get("ops_cores_s"):
            out["bound_cores_ms"] = 1e3 * max(a["bytes_s"], a["ops_cores_s"])
            out["fp64_err_ratio"] = a["fp64_ratio"]
        return out

    lines = []
    for k in ALL_KERNELS:
        name = k["name"]
        line = dict(name=name, route="cuda", source=k["source"],
                    replaces=k["replaces"],
                    launches=sum(c[name] for c in by_path.values()),
                    launches_by_path={p: c[name]
                                      for p, c in by_path.items()},
                    **numbers(aggs[name]))
        # the PointPillars calls of the kernel, measured on their own
        for path, pa in path_aggs.items():
            if name in pa:
                line[path] = numbers(pa[name])
                line["max_abs_err"] = max(line["max_abs_err"],
                                          pa[name]["err"])
        lines.append(line)
    report["kernels"] = lines
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1, default=str))
    say(f"card: {card}")
    say(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def profile_forward(forward, median_s, what="forward"):
    """One call of `forward` (a forward, or a train step) under
    torch.profiler: device-busy time (the union of the kernels' intervals),
    its share of the median call, and the device time by kernel name. The
    profiler slows the host, not the kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = dict(device_busy_ms=busy_us / 1e3, profiled_wall_ms=wall * 1e3,
               busy_share_of_median=busy_us / 1e6 / median_s,
               kernels_launched=len(spans),
               top_ms={k: v / 1e3 for k, v in top})
    say(f"profile: device busy {busy_us / 1e3:.2f} ms in {len(spans)} "
        f"kernels = {100 * out['busy_share_of_median']:.1f}% of the "
        f"{1e3 * median_s:.2f} ms median {what} (profiled wall "
        f"{wall * 1e3:.2f} ms)")
    for name, us in top:
        say(f"  {us / 1e3:8.3f} ms  {name[:90]}")
    return out


def check_predict_batch(spec, preds, anchors, nms_call=None,
                        anchors_mask=None, what="reference"):
    """predict on the batch's examples, card (kernels) against CPU (plain
    versions), on the same predictions (and anchors mask): valid and labels
    exact, boxes and scores within DET_TOL; and, given its recorded call,
    the batched single-class NMS on the same candidates. Returns the CPU's
    detections."""
    det_c = predict(spec, preds, anchors, anchors_mask)
    det_h = predict(spec, {k: v.cpu() for k, v in preds.items()},
                    anchors.cpu(), None if anchors_mask is None
                    else anchors_mask.cpu())
    valid = det_c["valid"].cpu()
    n = valid.shape[0]
    if not torch.equal(valid, det_h["valid"]) or \
            not torch.equal(det_c["labels"].cpu(), det_h["labels"]):
        fail(f"{what}: predict over {n} examples, valid or labels differ "
             f"card vs CPU")
    for k in ("boxes", "scores"):
        a, b = det_c[k].cpu()[valid], det_h[k][valid]
        if not torch.allclose(a, b, **DET_TOL):
            fail(f"{what}: predict over {n} examples, {k} card vs CPU max "
                 f"abs err {(a - b).abs().max().item():.3g}")
    if nms_call is not None:
        args, kwargs = nms_call
        idx_c, keep_c = nms_ops.nms(*args, **kwargs)
        idx_h, keep_h = nms_ops.nms(*[a.cpu() for a in args], **kwargs)
        if not (torch.equal(idx_c.cpu(), idx_h) and
                torch.equal(keep_c.cpu(), keep_h)):
            fail(f"{what}: batched NMS indices or keep differ card vs CPU")
    say(f"{what} ({n} examples, card vs CPU): predict valid and labels equal "
        f"({valid.sum(1).tolist()} detections)" +
        (", NMS indices and keep equal" if nms_call is not None else ""))
    return det_h


def check_reference(cfg, vspec, points, mask, anchors, dev, spec4, preds4,
                    nms_call):
    """predict on the batch's 4 examples and the batched NMS on their
    candidates, card against CPU; then one fp32 example through the port on
    the card and on the CPU, with the same seeded weights."""
    check_predict_batch(spec4, preds4, anchors, nms_call)
    net_c, spec = build_voxelnet(cfg.model, device=dev,
                                 mixed_precision=False, seed=0)[:2]
    net_h = build_voxelnet(cfg.model, device="cpu", mixed_precision=False,
                           seed=0)[0]
    one = [t[:1] for t in (points, mask, anchors)]
    det_c, vox_c, preds_c = detect(net_c, spec, vspec, *one, device=dev)
    t0 = time.perf_counter()
    det_h, vox_h, preds_h = detect(net_h, spec, vspec,
                                   *[t.cpu() for t in one], device="cpu")
    cpu_s = time.perf_counter() - t0
    for k in ("voxels", "num_points", "coordinates", "voxel_valid"):
        if not torch.equal(vox_c[k].cpu(), vox_h[k]):
            fail(f"reference: voxelizer output {k} differs card vs CPU")
    errs = {}
    for k in ("box_preds", "cls_preds"):
        a, b = preds_c[k].cpu(), preds_h[k]
        errs[k] = (a - b).abs().max().item()
        if not torch.allclose(a, b, **PRED_TOL):
            fail(f"reference: {k} card vs CPU max abs err {errs[k]:.3g} "
                 f"over {PRED_TOL}")
    # predict on the same predictions: kernels against plain versions
    preds_same = {k: v.cpu() for k, v in preds_c.items()}
    det_p = predict(spec, preds_same, one[2].cpu())
    valid = det_c["valid"].cpu()
    if not torch.equal(valid, det_p["valid"]):
        fail("reference: predict valid mask differs card vs CPU")
    for k in ("boxes", "scores"):
        a, b = det_c[k].cpu()[valid], det_p[k][valid]
        errs[k] = (a - b).abs().max().item() if a.numel() else 0.0
        if not torch.allclose(a, b, **DET_TOL):
            fail(f"reference: predict {k} max abs err {errs[k]:.3g}")
    if not torch.equal(valid, det_h["valid"]):
        fail("reference: end-to-end valid mask differs card vs CPU")
    for k in ("boxes", "scores"):      # printed: the preds differ already
        a, b = det_c[k].cpu()[valid], det_h[k][valid]
        errs[f"end_to_end_{k}"] = (a - b).abs().max().item() \
            if a.numel() else 0.0
    say(f"reference (fp32, 1 example, card vs CPU in {cpu_s:.1f} s): voxels "
        f"exact; preds err box {errs['box_preds']:.2e} cls "
        f"{errs['cls_preds']:.2e}; predict on the card's preds: valid equal "
        f"({int(valid.sum())} detections), boxes err {errs['boxes']:.2e} "
        f"scores err {errs['scores']:.2e}; end-to-end valid equal, boxes "
        f"err {errs['end_to_end_boxes']:.2e} scores err "
        f"{errs['end_to_end_scores']:.2e}")
    return dict(cpu_s=cpu_s, errs=errs, n_valid=int(valid.sum()))


# ------------------------------------------------------------ the train step


def train_inputs(cfg, assigner, info, dev, n, max_points=MAX_POINTS):
    """n synthetic LiDAR scan scenes (`SyntheticDataset(scan=True)`, seed 1:
    the JAX trainer's --synthetic data, with pedestrians and cyclists where
    the config detects them, as the `Trainer` draws them) prepared for
    training (targets assigned under the train reader's anchor-area mask
    where it sets one, points shuffled as the reader asks), collated, on
    the card."""
    vg = cfg.model.voxel_generator
    reader = cfg.train_input_reader
    prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=max_points, training=True,
        shuffle_points=reader.shuffle_points,
        anchor_area_threshold=reader.anchor_area_threshold,
        voxel_size=tuple(vg.voxel_size), pc_range=tuple(vg.point_cloud_range)))
    cls = set(assigner.classes)
    cls_kwargs = {}
    if "Pedestrian" in cls:
        cls_kwargs["num_peds"] = (1, 6)
    if "Cyclist" in cls:
        cls_kwargs["num_cyclists"] = (1, 4)
    ds = SyntheticDataset(n, seed=1, pc_range=tuple(vg.point_cloud_range),
                          scan=True, **cls_kwargs)
    rng = np.random.default_rng(0)
    batch = prep.collate([prep(ds[i], rng) for i in range(n)])
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if k != "image_idx"}


def new_train_state(cfg, dev, mixed, lr=None, seed=0, dtype=None,
                    build=build_voxelnet):
    """The config's model (made by `build`: the one-stage builder, or the
    two-stage one) on `dev` with flax's initialisers drawn from `seed` (a
    CPU generator: the same weights on every device), in `dtype` where one
    is given (fp64 for a reference run), and the config's optimizer, at a
    constant `lr` where one is given."""
    net, spec, info, assigner, _ = build(
        cfg.model, device=dev, mixed_precision=mixed, seed=seed)
    init_train_weights_(net, seed)
    if dtype is not None:
        net.to(dtype)
    ocfg = copy.deepcopy(cfg.train_config.optimizer)
    if lr is not None:
        ocfg.learning_rate.kind = "manual_stepping"
        ocfg.learning_rate.rates, ocfg.learning_rate.boundaries = [lr], []
    opt, lr_sched = build_optimizer(ocfg, cfg.train_config.steps,
                                    net.parameters())
    return TrainState(net, opt, 0, lr_sched), spec, info, assigner


def record_grads(state):
    """Make the state's optimizer keep a copy of the gradients it is given
    (before its clip), by name; returns the list the copies go to."""
    grads = []
    step = state.optimizer.step

    def recording_step(count):
        grads.append({n: p.grad.detach().clone()
                      for n, p in state.module.named_parameters()})
        return step(count)
    state.optimizer.step = recording_step
    return grads


def wgrad_library(features, tap_idx, found, grad_out):
    """One gather of the tap stack plus a batched product over taps,
    dW[k] = taps[k]^T dOut: the library yardstick of the weight gradient."""
    B, N, C = features.shape
    K, Q = tap_idx.shape[1:]
    off = (torch.arange(B, device=features.device) * N).view(B, 1, 1)
    rows = (tap_idx.long() + off).permute(1, 0, 2).reshape(-1)
    taps = features.reshape(B * N, C).index_select(0, rows)
    taps = taps * found.permute(1, 0, 2).reshape(-1, 1)
    g = grad_out.reshape(1, B * Q, -1).expand(K, -1, -1)
    return torch.bmm(taps.view(K, B * Q, C).transpose(1, 2), g).float()


def wgrad_bound(features, tap_idx, found, grad_out):
    """(bytes seconds, ops seconds) of one weight gradient, from what this
    run's rulebook needs: the found mask, the row index of each found tap,
    each referenced feature row once, each dOut row of a query that found
    some tap once, and the fp32 [K, C, D] output; 2*C*D operations per
    found tap."""
    B, N, C = features.shape
    D = grad_out.shape[2]
    K = tap_idx.shape[1]
    n_found = int(found.sum())
    off = (torch.arange(B, device=features.device) * N).view(B, 1, 1)
    rows = int(torch.unique((tap_idx.long() + off)[found]).numel())
    queries = int(found.any(1).sum())
    esz = features.element_size()
    nbytes = (found.numel() + 4 * n_found + rows * C * esz +
              queries * D * grad_out.element_size() + K * C * D * 4)
    ops = 2.0 * C * D * n_found
    return nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[features.dtype]


def check_train_calls(name, calls, kernel, plain, library, bound, timer,
                      dtimer, detail, timed=True):
    """Each recorded call of a train-step kernel against its plain version
    (within GRAD_KERNEL_TOL of the call's largest entry) and, if `timed`,
    timed by events (kernel, plain, library) and by the device timer
    (kernel, library), with its bound. Returns the aggregate."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0,
               library_device_ms=0.0, bytes_s=0.0, ops_s=0.0, err=0.0)
    rows = []
    for i, (args, _) in enumerate(calls):
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        scale = want.abs().max().item()
        tol = GRAD_KERNEL_TOL * max(scale, 1e-30)
        if not torch.allclose(got, want, atol=tol, rtol=GRAD_KERNEL_TOL):
            fail(f"{name} {i}: kernel disagrees with plain, max abs err "
                 f"{err:.3g} against {tol:.3g}")
        B, K, Q = args[1].shape
        n_found = int(args[2].sum())
        row = dict(call=i, dtype=str(args[0].dtype), B=B, K=K, Q=Q,
                   N=args[0].shape[1], C=args[0].shape[2],
                   D=got.shape[-1], max_abs_err=err, max_rel_err=rel,
                   found=n_found, found_density=n_found / max(B * K * Q, 1))
        agg["err"] = max(agg["err"], err)
        rows.append(row)
        if not timed:
            continue
        bs, os_ = bound(*args)
        row.update(ms=timer(lambda: kernel(*args), 10),
                   plain_ms=timer(lambda: plain(*args), 3),
                   library_ms=timer(lambda: library(*args), 3),
                   bound_ms=1e3 * max(bs, os_))
        for k in ("ms", "plain_ms", "library_ms"):
            agg[k] += row[k]
        agg["bytes_s"] += bs
        agg["ops_s"] += os_
    detail.extend(rows)
    agg["found"] = sum(row["found"] for row in rows)
    if not timed:
        say(f"{name}: {len(calls)} calls within {GRAD_KERNEL_TOL} of their "
            f"plain version's scale (max abs err {agg['err']:.2e}), "
            f"{agg['found']} found taps")
        return agg
    kernel_dev = dtimer([lambda a=a: kernel(*a) for a, _ in calls])
    kernels_a_call = dtimer.kernels
    library_dev = dtimer([lambda a=a: library(*a) for a, _ in calls])
    agg["device_kernels"] = 0
    for row, kd, ld, nk in zip(rows, kernel_dev, library_dev,
                               kernels_a_call):
        row["device_ms"], row["library_device_ms"] = kd, ld
        row["device_kernels"] = nk
        agg["device_ms"] += kd
        agg["library_device_ms"] += ld
        agg["device_kernels"] += nk
        say(f"{name} {row['call']:2d} {row['dtype'][6:]:8s} B={row['B']} "
            f"N={row['N']} Q={row['Q']} K={row['K']} {row['C']}->"
            f"{row['D']}: found {row['found']} ({row['found_density']:.4f} "
            f"of the taps), {nk:g} device kernels; err "
            f"{row['max_abs_err']:.2e} rel {row['max_rel_err']:.2e}  kernel "
            f"{row['ms']:.4f} ms (device {kd:.4f})  plain "
            f"{row['plain_ms']:.4f} ms  library {row['library_ms']:.4f} ms "
            f"(device {ld:.4f})  bound {row['bound_ms']:.4f} ms")
    say(f"{name}: {len(calls)} calls, {agg['found']} found taps, "
        f"{agg['device_kernels']:g} device kernels; kernel {agg['ms']:.4f} "
        f"ms (device {agg['device_ms']:.4f})  plain {agg['plain_ms']:.4f} ms  "
        f"library "
        f"{agg['library_ms']:.4f} ms (device "
        f"{agg['library_device_ms']:.4f})  bound "
        f"{1e3 * max(agg['bytes_s'], agg['ops_s']):.4f} ms")
    return agg


def check_step_calls(what, calls, timer, dtimer, timed=True):
    """The recorded calls of a train step (RECORDED_TRAIN): every forward,
    dX and weight-gradient call against its plain version
    (`check_train_calls`). Returns (the dX and weight-gradient aggregates,
    the per-call detail)."""
    detail = {"forward": [], "dgrad": [], "wgrad": []}
    check_train_calls(f"{what} conv", calls["gather_gemm"], subm.gather_gemm,
                      subm.gather_gemm_plain, conv_library, conv_bound,
                      timer, dtimer, detail["forward"], timed)
    aggs = {
        "sparse_gather_gemm_dgrad": check_train_calls(
            f"{what} dgrad", calls["gather_gemm_dgrad"],
            subm.gather_gemm_dgrad, subm.gather_gemm_plain, conv_library,
            conv_bound, timer, dtimer, detail["dgrad"], timed),
        "sparse_wgrad": check_train_calls(
            f"{what} wgrad", calls["sparse_wgrad"], subm.sparse_wgrad,
            subm.gather_gemm_wgrad_plain, wgrad_library, wgrad_bound, timer,
            dtimer, detail["wgrad"], timed),
    }
    return aggs, detail


def check_conv_backward(fwd_calls, wgrad_calls):
    """Each conv of the step once more: its forward arguments and the
    gradient its backward received, through `gather_gemm` (the kernels'
    backward) and through autograd of `gather_gemm_plain` in fp32. The input
    gradient where the step computed one (every conv but the first), and
    the weight gradient; on the bf16 path the kernels' results are rounded
    to bf16 once, so within one bf16 unit (BF16_UNIT). Returns the largest
    error over the convs, relative to each tensor's largest entry."""
    by_input = {(a[0].data_ptr(), a[1].data_ptr()): a[3]
                for a, _ in wgrad_calls}
    worst = 0.0
    for i, (args, _) in enumerate(fwd_calls):
        f, tap_idx, found, w = args
        g = by_input.get((f.data_ptr(), tap_idx.data_ptr()))
        if g is None:
            fail(f"conv {i}: no weight-gradient call for its input")
        grads = []
        # the kernels on the step's own dtypes; autograd of the plain
        # version on fp32 copies of the values the kernels use (the features
        # and the weights rounded to the feature dtype), so its sums are
        # fp32 throughout: autograd through bf16 tensors would round each
        # tap's share and add them in bf16
        for fn, dtype in ((subm.gather_gemm, f.dtype),
                          (subm.gather_gemm_plain, torch.float32)):
            with torch.enable_grad():
                x = f.detach().to(dtype).requires_grad_(i > 0)
                ww = w.detach().to(f.dtype).to(w.dtype).requires_grad_(True)
                (fn(x, tap_idx, found, ww) * g.float()).sum().backward()
            grads.append((x.grad, ww.grad))
        torch.cuda.synchronize()
        for j, (got, want) in enumerate(zip(*grads)):
            if want is None:
                continue
            got, want = got.float(), want.float()
            scale = want.abs().max().item()
            if f.dtype == torch.bfloat16:
                ok = ((got - want).abs() <= BF16_UNIT * torch.maximum(
                    got.abs(), want.abs()) + 1e-6 * scale).all()
            else:
                ok = torch.allclose(got, want, rtol=GRAD_KERNEL_TOL,
                                    atol=GRAD_KERNEL_TOL * scale)
            err = (got - want).abs().max().item()
            worst = max(worst, err / max(scale, 1e-30))
            if not ok:
                fail(f"conv {i}: {('dX', 'dW')[j]} differs from autograd of "
                     f"the plain gather-GEMM, max abs err {err:.3g} at "
                     f"scale {scale:.3g}")
    say(f"conv backward: {len(fwd_calls)} convs' dX and dW equal autograd "
        f"of the plain gather-GEMM (largest error {worst:.2e} of the "
        f"tensor's scale)")
    return worst


def one_stage_loss(spec, net, vox, batch):
    """The one-stage model's train-mode forward and loss dict."""
    preds = net(vox["voxels"], vox["num_points"], vox["coordinates"],
                vox["voxel_valid"])
    return compute_loss(spec, preds, batch["labels"], batch["reg_targets"],
                        batch["anchors"], batch.get("gt_boxes_padded"),
                        batch.get("gt_valid"))


def two_stage_loss(spec, net, vox, batch):
    """The two-stage model's train-mode forward and loss dict."""
    preds = net(vox["voxels"], vox["num_points"], vox["coordinates"],
                vox["voxel_valid"], batch["anchors"],
                anchors_mask=batch.get("anchors_mask"))
    return compute_two_stage_loss(spec, preds, batch["labels"],
                                  batch["reg_targets"], batch["anchors"],
                                  batch.get("gt_boxes_padded"),
                                  batch.get("gt_valid"))


def grads_of(state, spec, vspec, batch, loss_of=one_stage_loss):
    """One forward and backward in train mode from the state as it is; the
    parameters' gradients, cloned (no optimizer step)."""
    net = state.module
    with torch.no_grad():
        vox = device_voxelize(vspec, batch["points"], batch["points_mask"],
                              state.device)
    net.train()
    with torch.enable_grad():
        loss = loss_of(spec, net, vox, batch)["loss"]
        state.optimizer.zero_grad()
        loss.backward()
    return [p.grad.detach().clone() for p in net.parameters()]


def timed_split(state, spec, vspec, batch, loss_of=one_stage_loss):
    """One train step cut at its stage boundaries, each synchronised: ms of
    voxelize, forward + loss, backward, optimizer."""
    net, dev = state.module, state.device
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        vox = device_voxelize(vspec, batch["points"], batch["points_mask"],
                              dev)
    torch.cuda.synchronize()
    out["voxelize_ms"] = 1e3 * (time.perf_counter() - t0)
    net.train()
    with torch.enable_grad():
        t0 = time.perf_counter()
        loss = loss_of(spec, net, vox, batch)["loss"]
        torch.cuda.synchronize()
        out["forward_loss_ms"] = 1e3 * (time.perf_counter() - t0)
        state.optimizer.zero_grad()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        out["backward_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    state.optimizer.step(state.step)
    state.step += 1
    torch.cuda.synchronize()
    out["optimizer_ms"] = 1e3 * (time.perf_counter() - t0)
    return out


def run_train(cfg, dev, timer, dtimer):
    """Phase 7: the train step on the card. Returns (the two backward
    kernels' aggregates, the launch counts of the counted step, the
    report)."""
    report = {}
    mixed = cfg.train_config.enable_mixed_precision
    # cuDNN's fastest algorithms for the RPN's backward add with atomics;
    # the deterministic ones make two runs of a step give the same bits
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, mixed)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     TRAIN_VOXELS, shuffle_overflow=True)
    batch = train_inputs(cfg, assigner, info, dev, TRAIN_BATCH)
    step = make_train_step(spec, vspec)
    say(f"train: batch {TRAIN_BATCH} synthetic scans, {TRAIN_VOXELS} voxels "
        f"(shuffle_overflow), mixed precision {mixed}, points "
        f"{tuple(batch['points'].shape)}, positive anchors "
        f"{(batch['labels'] > 0).sum(1).tolist()}")

    # capture
    with recording(RECORDED_TRAIN) as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"train capture: {n}; loss {float(metrics['loss']):.4f}")
    if n != {"gather_gemm": SPARSE_CONVS, "gather_gemm_dgrad":
             SPARSE_CONVS - 1, "sparse_wgrad": SPARSE_CONVS}:
        fail(f"expected {SPARSE_CONVS} forward, {SPARSE_CONVS - 1} dX and "
             f"{SPARSE_CONVS} weight-gradient calls a step, recorded {n}")
    aggs, detail = check_step_calls("train", calls, timer, dtimer)
    # one launch a call: the partials are summed in the same launch
    if aggs["sparse_wgrad"]["device_kernels"] != SPARSE_CONVS:
        fail(f"the weight gradient ran {aggs['sparse_wgrad']['device_kernels']}"
             f" device kernels over {SPARSE_CONVS} calls, expected one a call")
    report["calls"] = detail
    report["conv_backward_worst"] = check_conv_backward(
        calls["gather_gemm"], calls["sparse_wgrad"])
    del calls

    # the main path, counted
    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one train step: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS,
            "sparse_gather_gemm_dgrad": SPARSE_CONVS - 1,
            "sparse_wgrad": SPARSE_CONVS}
    if {k: counts[k] for k in want} != want:
        fail(f"train step launches {counts}, expected {want}")
    if mixed and paths != {"mma": 2 * SPARSE_CONVS - 1, "fma": 0,
                           "wgrad_mma": SPARSE_CONVS, "wgrad_fma": 0}:
        fail(f"not every bf16 train-step kernel took the tensor-core path: "
             f"{paths}")
    sparse = [(n, p) for n, p in state.module.named_parameters()
              if n.startswith("middle.") and p.dim() == 3]
    if len(sparse) != SPARSE_CONVS:
        fail(f"expected {SPARSE_CONVS} sparse weights, found {len(sparse)}")
    for name, p in sparse:
        if p.grad is None or not torch.isfinite(p.grad).all() or \
                not p.grad.abs().max() > 0:
            fail(f"{name}: gradient missing, not finite or all zero")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"train metrics not finite: {m}")
    say(f"train step: every sparse weight's gradient finite and nonzero; "
        + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    report["metrics"], report["launches"] = m, counts
    # the step syncs the host nowhere: the loop around it reads the step
    # count as a Python int
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the train step synchronised the host {n_syncs} times")
    say("train step: no host sync (torch.cuda.set_sync_debug_mode('warn'))")

    check_determinism(state, spec, vspec, batch, "train")
    report["speed"], report["profile"] = timed_steps(
        step, state, spec, vspec, batch, TIMED_STEPS, "train")
    del state
    report["overfit"] = check_overfit(cfg, dev, mixed, step, batch, "train")

    report["reference"] = check_train_reference(cfg, dev, vspec, batch)
    torch.backends.cudnn.deterministic = False
    return aggs, counts, report


def check_train_reference(cfg, dev, vspec, batch, what="train reference"):
    """One fp32 train step on the batch's first example at full width, on
    the card (kernels) and on the CPU (plain versions), from the same
    seeded weights with the config's optimizer: the loss, every gradient
    (before the clip), every parameter after the step and every norm
    statistic."""
    one = {k: v[:1] for k, v in batch.items()}
    runs = {}
    for device in (dev, torch.device("cpu")):
        state, spec, _, _ = new_train_state(cfg, device, mixed=False)
        lr = float(state.lr_sched(0))     # the first step's
        grads = record_grads(state)
        before = {k: v.detach().cpu().clone()
                  for k, v in state.module.state_dict().items()}
        t0 = time.perf_counter()
        state, metrics = make_train_step(spec, vspec)(
            state, {k: v.to(device) for k, v in one.items()})
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs[device.type] = dict(
            secs=time.perf_counter() - t0, loss=float(metrics["loss"]),
            grads={k: v.cpu() for k, v in grads[0].items()},
            after={k: v.detach().cpu()
                   for k, v in state.module.state_dict().items()},
            before=before)
    c, h = runs["cuda"], runs["cpu"]
    errs = {"loss_rel": abs(c["loss"] / h["loss"] - 1)}
    if errs["loss_rel"] > REF_LOSS_RTOL:
        fail(f"{what}: loss {c['loss']:.6f} on the card, "
             f"{h['loss']:.6f} on the CPU")
    grad_worst, param_worst, stat_worst = 0.0, 0.0, 0.0
    wd = cfg.train_config.optimizer.weight_decay
    for name, want in h["grads"].items():
        scale = want.abs().max().item()
        e = (c["grads"][name] - want).abs().max().item() / max(scale, 1e-30)
        grad_worst = max(grad_worst, e)
        if e > REF_GRAD_TOL:
            fail(f"{what}: gradient {name} differs by {e:.3g} of "
                 f"its scale")
        diff = (c["after"][name] - h["after"][name]).abs()
        settled = want.abs() > 1e-3 * scale
        if settled.any():
            param_worst = max(param_worst, diff[settled].max().item())
        limit = lr * (2 + wd * h["before"][name].abs()) + REF_PARAM_ATOL
        if (diff[settled] > REF_PARAM_ATOL).any() or (diff > limit).any():
            fail(f"{what}: parameter {name} after the step differs "
                 f"by {diff.max().item():.3g}")
    for name, want in h["after"].items():
        if "running" in name:
            e = (c["after"][name] - want).abs().max().item() / \
                max(want.abs().max().item(), 1e-30)
            stat_worst = max(stat_worst, e)
            if e > REF_STAT_TOL:
                fail(f"{what}: {name} differs by {e:.3g}")
    errs.update(grad=grad_worst, param_settled=param_worst, stat=stat_worst)
    say(f"{what} (fp32, 1 example, {vspec.max_voxels} voxels, card vs "
        f"CPU in {h['secs']:.1f} s): loss {c['loss']:.6f} / {h['loss']:.6f} "
        f"(rel {errs['loss_rel']:.2e}); gradients within {grad_worst:.2e} "
        f"of their scale; parameters after Adam within {param_worst:.2e} "
        f"where the gradient's sign is settled; norm statistics within "
        f"{stat_worst:.2e}")
    return dict(cpu_s=h["secs"], card_s=c["secs"], errs=errs)


# ------------------------------------------------------------ PointPillars


def pp_eval_inputs(cfg, assigner, info, dev):
    """The JAX bench's PointPillars input: one LiDAR-scan scene of the
    config's range (seed 0, 512 azimuth steps), prepared for eval with the
    eval reader's anchor-area threshold computed on the device (the SAT
    corners uploaded once), 20 000 points, repeated PP_BATCH times."""
    vg = cfg.model.voxel_generator
    pc_range = tuple(vg.point_cloud_range)
    prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=PP_POINTS, training=False,
        anchor_area_threshold=cfg.eval_input_reader.anchor_area_threshold,
        voxel_size=tuple(vg.voxel_size), pc_range=pc_range,
        device_anchors_mask=True))
    rng = np.random.default_rng(0)
    p, b, n = lidar_scan_scene(rng, pc_range=pc_range, num_azimuth=512)
    ex = prep({"points": p, "gt_boxes": b, "gt_names": n, "image_idx": 0},
              rng)
    batch = prep.collate([ex] * PP_BATCH)
    corners, grid_hw, thr = prep.sat_mask_info()
    mask_info = (torch.as_tensor(corners, device=dev), grid_hw, thr)
    return prep, [torch.as_tensor(batch[k], device=dev)
                  for k in ("points", "points_mask", "anchors")], mask_info


def calibrated(net, vspec, points, mask, dev):
    """`calibrate_norms_` on these points' voxels: the random model's norm
    statistics replaced by the batch's (see its docstring)."""
    with torch.no_grad():
        vox = device_voxelize(vspec, points, mask, dev)
        calibrate_norms_(net, vox["voxels"], vox["num_points"],
                         vox["coordinates"], vox["voxel_valid"])
    return net


def host_sat_mask(prep, coords, valid, mask_info):
    """The host's SAT anchors mask from these voxel coords, per example:
    `box_np.sparse_sum_for_anchors_mask` → two cumsums →
    `fused_get_anchors_area` > threshold ([B, A] numpy bool)."""
    _, (H, W), thr = mask_info
    vsize = np.asarray(prep._prep.voxel_size, np.float32)
    rng_ = np.asarray(prep._prep.pc_range, np.float32)
    out = []
    for c, v in zip(coords.cpu().numpy(), valid.cpu().numpy()):
        dense = box_np.sparse_sum_for_anchors_mask(c[v], (H, W))
        area = box_np.fused_get_anchors_area(
            dense.cumsum(0).cumsum(1), prep._anchors_bv, vsize[:2], rng_[:2],
            (W, H))
        out.append(area > thr)
    return np.stack(out)


def run_pp_eval(dev, timer, dtimer):
    """Phase 8: the PointPillars eval forward (the JAX bench's PointPillars
    leg, batch 4, 12 000 pillars, 20 000 points, bf16 RPN trunk, the
    in-graph anchors mask at the eval reader's threshold). Returns (the
    kernels' aggregates, the launch counts, the report)."""
    report = {}
    cfg = load_pipeline_config(PP_CONFIG)
    mixed = cfg.train_config.enable_mixed_precision
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device=dev, mixed_precision=mixed, seed=0)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, PP_VOXELS)
    prep, (points, mask, anchors), mask_info = pp_eval_inputs(
        cfg, assigner, info, dev)
    calibrated(net, vspec, points, mask, dev)
    say(f"pp eval: points {tuple(points.shape)} ({int(mask.sum())} valid), "
        f"anchors {tuple(anchors.shape)}, mask threshold {mask_info[2]}, "
        f"mixed precision {mixed}")

    def forward():
        return detect(net, spec, vspec, points, mask, anchors, device=dev,
                      mask_info=mask_info)

    with recording() as calls:
        forward()
        torch.cuda.synchronize()
    say("pp capture: " + ", ".join(f"{k} {len(v)} calls"
                                   for k, v in calls.items()))
    nms_call = calls["nms"][0]
    if calls["gather_gemm"]:
        fail(f"the PointPillars forward called the sparse gather-GEMM "
             f"{len(calls['gather_gemm'])} times")
    detail = {"row_gather": [], "rotated_iou": []}
    aggs = {"row_gather": check_gathers(calls["gather_rows"], timer, dtimer,
                                        detail["row_gather"])}
    aggs["rotated_iou"], aggs["nms_suppress"] = check_riou(
        calls, timer, dtimer, detail["rotated_iou"], dev, matrix=False)
    del calls
    report["calls"] = detail

    reset_counts()
    det, vox, preds = forward()
    torch.cuda.synchronize()
    counts = launch_counts()
    say(f"launches in one PointPillars forward: {counts}")
    if counts != PP_EVAL_LAUNCHES:
        fail(f"PointPillars forward launches {counts}, expected "
             f"{PP_EVAL_LAUNCHES}")
    # the mask and predict without a host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        amask = anchors_mask_from_coords(vox["coordinates"],
                                         vox["voxel_valid"], *mask_info)
        predict(spec, preds, anchors, amask)
    except RuntimeError as e:
        fail(f"the anchors mask or predict synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say("pp mask + predict: no host sync "
        "(torch.cuda.set_sync_debug_mode('error'))")
    report["forward_host_syncs"] = host_syncs(forward)
    say(f"pp forward: {report['forward_host_syncs']} host syncs in one "
        f"forward (torch.cuda.set_sync_debug_mode('warn'))")

    A = anchors.shape[1]
    for k, shape in (("box_preds", (PP_BATCH, A, spec.box_code_size)),
                     ("cls_preds", (PP_BATCH, A, 1)),
                     ("dir_cls_preds", (PP_BATCH, A, 2))):
        if tuple(preds[k].shape) != shape or \
                not torch.isfinite(preds[k]).all():
            fail(f"pp {k}: shape {tuple(preds[k].shape)} (want {shape}) or "
                 f"non-finite values")
    if not all(torch.isfinite(det[k]).all() for k in ("boxes", "scores")):
        fail("pp: non-finite detections")
    n_valid = det["valid"].sum(1).tolist()
    report["voxel_overflow"] = int(vox["voxel_overflow"])
    say(f"pp forward: voxel_overflow {report['voxel_overflow']} (capacity "
        f"{PP_VOXELS}) pillars {vox['voxel_valid'].sum(1).tolist()} anchors "
        f"kept by the mask {amask.sum(1).tolist()} of {A}, valid "
        f"detections {n_valid}")

    times = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TIMED_FORWARDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(dev)
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = device_voxelize(vspec, points, mask, dev)
    torch.cuda.synchronize()
    stages["voxelize_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    vf = net.vfe(v["voxels"], v["num_points"], v["coordinates"])
    vf = torch.where(v["voxel_valid"][..., None], vf, 0.0)
    bev, _ = net.middle(vf, v["coordinates"], v["voxel_valid"])
    torch.cuda.synchronize()
    stages["encoder_scatter_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    p = net.rpn(bev)
    torch.cuda.synchronize()
    stages["rpn_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    predict(spec, p, anchors, anchors_mask_from_coords(
        v["coordinates"], v["voxel_valid"], *mask_info))
    torch.cuda.synchronize()
    stages["mask_predict_ms"] = 1e3 * (time.perf_counter() - t0)
    report["forward"] = dict(
        batch=PP_BATCH, median_s=med, frames_per_s=PP_BATCH / med,
        times_s=times, peak_mem_bytes=peak, valid=n_valid, launches=counts,
        **stages)
    say(f"pp frames/s {PP_BATCH / med:.3f} (median {1e3 * med:.2f} ms of "
        f"{TIMED_FORWARDS} batch-{PP_BATCH} forwards, "
        f"{1e3 * min(times):.2f}-{1e3 * max(times):.2f}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB; one split: "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + ")")
    report["profile"] = profile_forward(forward, med, "PointPillars forward")

    # reference: the mask against the host's SAT on the same coords
    host = host_sat_mask(prep, vox["coordinates"], vox["voxel_valid"],
                         mask_info)
    if not np.array_equal(amask.cpu().numpy(), host):
        fail("pp reference: the in-graph anchors mask differs from the "
             "host's SAT on the same voxel coords")
    say(f"pp reference: the in-graph mask equals the host SAT mask of the "
        f"same voxel coords for all {PP_BATCH} examples "
        f"({host.sum(1).tolist()} anchors kept)")
    check_predict_batch(spec, preds, anchors, nms_call, amask,
                        "pp reference")
    report["reference"] = check_pp_reference(cfg, vspec, points, mask,
                                             anchors, mask_info, dev)
    return aggs, counts, report


def check_pp_reference(cfg, vspec, points, mask, anchors, mask_info, dev):
    """One fp32 example of the PointPillars forward on the card (kernels)
    and on the CPU (plain versions) with the same weights (seed 0, norm
    statistics calibrated on the CPU): voxels and the in-graph mask exact,
    predictions within PRED_TOL, predict on the card's predictions with
    `valid` exact and boxes and scores within DET_TOL, and the same
    `valid` end to end."""
    one = [t[:1] for t in (points, mask, anchors)]
    net_h, spec = build_voxelnet(cfg.model, device="cpu",
                                 mixed_precision=False, seed=0)[:2]
    calibrated(net_h, vspec, one[0].cpu(), one[1].cpu(), "cpu")
    net_c = build_voxelnet(cfg.model, device=dev, mixed_precision=False,
                           seed=0)[0]
    net_c.load_state_dict(net_h.state_dict())
    net_c.eval()
    det_c, vox_c, preds_c = detect(net_c, spec, vspec, *one, device=dev,
                                   mask_info=mask_info)
    mask_h = (mask_info[0].cpu(),) + tuple(mask_info[1:])
    t0 = time.perf_counter()
    det_h, vox_h, preds_h = detect(net_h, spec, vspec,
                                   *[t.cpu() for t in one], device="cpu",
                                   mask_info=mask_h)
    cpu_s = time.perf_counter() - t0
    for k in ("voxels", "num_points", "coordinates", "voxel_valid"):
        if not torch.equal(vox_c[k].cpu(), vox_h[k]):
            fail(f"pp reference: voxelizer output {k} differs card vs CPU")
    masks = [anchors_mask_from_coords(v["coordinates"], v["voxel_valid"], *m)
             for v, m in ((vox_c, mask_info), (vox_h, mask_h))]
    if not torch.equal(masks[0].cpu(), masks[1]):
        fail("pp reference: the in-graph mask differs card vs CPU")
    errs = {}
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        a, b = preds_c[k].cpu(), preds_h[k]
        errs[k] = (a - b).abs().max().item()
        if not torch.allclose(a, b, **PRED_TOL):
            fail(f"pp reference: {k} card vs CPU max abs err {errs[k]:.3g} "
                 f"over {PRED_TOL}")
    det_p = predict(spec, {k: v.cpu() for k, v in preds_c.items()},
                    one[2].cpu(), masks[1])
    valid = det_c["valid"].cpu()
    if not torch.equal(valid, det_p["valid"]):
        fail("pp reference: predict valid mask differs card vs CPU")
    for k in ("boxes", "scores"):
        a, b = det_c[k].cpu()[valid], det_p[k][valid]
        errs[k] = (a - b).abs().max().item() if a.numel() else 0.0
        if not torch.allclose(a, b, **DET_TOL):
            fail(f"pp reference: predict {k} max abs err {errs[k]:.3g}")
    if not torch.equal(valid, det_h["valid"]):
        fail("pp reference: end-to-end valid mask differs card vs CPU")
    say(f"pp reference (fp32, 1 example, card vs CPU in {cpu_s:.1f} s): "
        f"voxels and mask exact; preds err box {errs['box_preds']:.2e} cls "
        f"{errs['cls_preds']:.2e} dir {errs['dir_cls_preds']:.2e}; predict "
        f"on the card's preds: valid equal ({int(valid.sum())} detections), "
        f"boxes err {errs['boxes']:.2e} scores err {errs['scores']:.2e}; "
        f"end-to-end valid equal")
    return dict(cpu_s=cpu_s, errs=errs, n_valid=int(valid.sum()))


def run_pp_train(dev, timer, dtimer):
    """Phase 9: the PointPillars train step (the config's batch 2 of
    synthetic LiDAR scans prepared with targets under the host anchor mask,
    12 000 pillars with shuffle_overflow, bf16 RPN trunk, the config's
    one-cycle AdamW) from flax's initialisers. Returns (the row gather's
    aggregate, the launch counts of the counted step, the report)."""
    report = {}
    cfg = load_pipeline_config(PP_CONFIG)
    mixed = cfg.train_config.enable_mixed_precision
    reader = cfg.train_input_reader
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, mixed)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     reader.max_number_of_voxels,
                                     shuffle_overflow=True)
    batch = train_inputs(cfg, assigner, info, dev, reader.batch_size,
                         PP_POINTS)
    step = make_train_step(spec, vspec)
    n_batch = reader.batch_size
    say(f"pp train: batch {n_batch} synthetic scans, "
        f"{reader.max_number_of_voxels} pillars (shuffle_overflow), mixed "
        f"precision {mixed}, anchor-area threshold "
        f"{reader.anchor_area_threshold}, points "
        f"{tuple(batch['points'].shape)}, positive anchors "
        f"{(batch['labels'] > 0).sum(1).tolist()}, masked out "
        f"{(~batch['anchors_mask']).sum(1).tolist()}")

    with recording() as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"pp train capture: {n}; loss {float(metrics['loss']):.4f}")
    if n != {**{k: 0 for k in n}, "gather_rows": 2}:
        fail(f"expected the voxelizer's 2 row gathers and no other kernel "
             f"call in a PointPillars step, recorded {n}")
    detail = []
    aggs = {"row_gather": check_gathers(calls["gather_rows"], timer, dtimer,
                                        detail)}
    report["calls"] = detail
    del calls

    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    say(f"launches in one PointPillars train step: {counts}")
    if counts != PP_TRAIN_LAUNCHES:
        fail(f"PointPillars train step launches {counts}, expected "
             f"{PP_TRAIN_LAUNCHES}")
    for name, p in state.module.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"pp {name}: gradient missing or not finite")
    for name in ("vfe.layers.0.linear.weight",
                 "rpn.trunk.convs.0.conv.weight"):
        if not dict(state.module.named_parameters())[name].grad.abs() \
                .max() > 0:
            fail(f"pp {name}: gradient all zero")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"pp train metrics not finite: {m}")
    say("pp train step: every gradient finite, the encoder's and the first "
        "RPN conv's nonzero; " + ", ".join(f"{k} {v:.4g}"
                                           for k, v in m.items()))
    report["metrics"], report["launches"] = m, counts
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the PointPillars train step synchronised the host {n_syncs} "
             f"times")
    say("pp train step: no host sync (torch.cuda.set_sync_debug_mode("
        "'warn'))")

    check_determinism(state, spec, vspec, batch, "pp")
    report["speed"], report["profile"] = timed_steps(
        step, state, spec, vspec, batch, TIMED_STEPS, "pp train")
    del state
    report["overfit"] = check_overfit(cfg, dev, mixed, step, batch, "pp")

    report["reference"] = check_pp_train_reference(cfg, dev, vspec, batch)
    torch.backends.cudnn.deterministic = False
    return aggs, counts, report


def check_pp_train_reference(cfg, dev, vspec, batch):
    """One PointPillars train step on the batch's first example at full
    width, on the card (kernels) and on the CPU (plain versions), from the
    same seeded weights with the config's optimizer: in fp64, card against
    CPU; in fp32, each against the fp64 CPU step (see REF64_TOL)."""
    one = {k: v[:1] for k, v in batch.items()}
    cpu = torch.device("cpu")
    # the fp32 and the fp64 steps must see the same pillars: the voxelizer
    # bins each point in the points' dtype
    vox = [device_voxelize(vspec, one["points"].to(cpu, dtype),
                           one["points_mask"].cpu(), cpu)
           for dtype in (torch.float32, torch.float64)]
    for k in ("coordinates", "num_points", "voxel_valid"):
        if not torch.equal(vox[0][k], vox[1][k]):
            fail(f"pp train reference: the fp64 points give other pillars "
                 f"({k}) than the fp32 ones")
    runs = {}
    for device, dtype in ((dev, torch.float64), (cpu, torch.float64),
                          (dev, torch.float32), (cpu, torch.float32)):
        state, spec, _, _ = new_train_state(cfg, device, mixed=False,
                                            dtype=dtype)
        lr = float(state.lr_sched(0))     # the first step's
        grads = record_grads(state)
        before = {k: v.detach().cpu().clone()
                  for k, v in state.module.state_dict().items()}
        ex = {k: v.to(device, dtype) if v.is_floating_point()
              else v.to(device) for k, v in one.items()}
        t0 = time.perf_counter()
        state, metrics = make_train_step(spec, vspec)(state, ex)
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs[device.type, dtype] = dict(
            secs=time.perf_counter() - t0, loss=float(metrics["loss"]),
            grads={k: v.double().cpu() for k, v in grads[0].items()},
            after={k: v.detach().double().cpu()
                   for k, v in state.module.state_dict().items()
                   if v.is_floating_point()},
            before=before)
    wd = cfg.train_config.optimizer.weight_decay
    c64, h64 = runs["cuda", torch.float64], runs["cpu", torch.float64]
    c32, h32 = runs["cuda", torch.float32], runs["cpu", torch.float32]
    errs = {"loss64_rel": abs(c64["loss"] / h64["loss"] - 1),
            "loss32_rel": abs(c32["loss"] / h64["loss"] - 1)}
    if errs["loss64_rel"] > REF64_LOSS_RTOL:
        fail(f"pp train reference: fp64 loss {c64['loss']!r} on the card, "
             f"{h64['loss']!r} on the CPU")
    if errs["loss32_rel"] > REF_LOSS_RTOL:
        fail(f"pp train reference: fp32 loss {c32['loss']:.6f} on the card, "
             f"fp64 {h64['loss']:.6f} on the CPU")
    worst = dict(grad64=0.0, after64=0.0, grad32=0.0, cpu32=0.0,
                 param32=0.0, stat32=0.0)

    def err(g, name):
        exact = h64["grads"][name]
        return (g[name] - exact).abs().max().item() / \
            max(exact.abs().max().item(), 1e-30)
    e_cpu = {name: err(h32["grads"], name) for name in h64["grads"]}
    worst["cpu32"] = max(e_cpu.values())
    beyond = sum(e > REF_GRAD_TOL for e in e_cpu.values())
    tol = max(REF_GRAD_TOL, REF_FP32_NOISE * worst["cpu32"])
    for name, exact in h64["grads"].items():
        scale = max(exact.abs().max().item(), 1e-30)
        e64 = err(c64["grads"], name)
        worst["grad64"] = max(worst["grad64"], e64)
        if e64 > REF64_TOL:
            fail(f"pp train reference: fp64 gradient {name} differs card "
                 f"vs CPU by {e64:.3g} of its scale")
        e_card = err(c32["grads"], name)
        worst["grad32"] = max(worst["grad32"], e_card)
        if e_card > tol:
            fail(f"pp train reference: fp32 gradient {name} on the card is "
                 f"{e_card:.3g} of its scale from the fp64 one (the CPU's "
                 f"fp32: {e_cpu[name]:.3g}; the tolerance {tol:.3g})")
        diff = (c32["after"][name] - h32["after"][name]).abs()
        settled = exact.abs() > tol * scale
        if settled.any():
            worst["param32"] = max(worst["param32"],
                                   diff[settled].max().item())
        limit = lr * (2 + wd * h32["before"][name].double().abs()) + \
            REF_PARAM_ATOL
        if (diff[settled] > REF_PARAM_ATOL).any() or (diff > limit).any():
            fail(f"pp train reference: fp32 parameter {name} after the step "
                 f"differs card vs CPU by {diff.max().item():.3g}")
    for name, want in h64["after"].items():
        e = (c64["after"][name] - want).abs().max().item() / \
            max(want.abs().max().item(), 1e-30)
        worst["after64"] = max(worst["after64"], e)
        if e > REF64_TOL:
            fail(f"pp train reference: fp64 {name} after the step differs "
                 f"card vs CPU by {e:.3g}")
        if "running" in name:
            e = (c32["after"][name] - h32["after"][name]).abs().max().item() \
                / max(h32["after"][name].abs().max().item(), 1e-30)
            worst["stat32"] = max(worst["stat32"], e)
            if e > REF_STAT_TOL:
                fail(f"pp train reference: fp32 {name} differs card vs CPU "
                     f"by {e:.3g}")
    errs.update(worst, cpu32_beyond_1e3=beyond, n_grads=len(h64["grads"]))
    say(f"pp train reference (1 example, {vspec.max_voxels} pillars, card vs "
        f"CPU; the CPU's fp64 step in {h64['secs']:.1f} s): fp64 loss rel "
        f"{errs['loss64_rel']:.2e}, gradients within {worst['grad64']:.2e} "
        f"of their scale, state after the step within "
        f"{worst['after64']:.2e}; fp32 against fp64: loss rel "
        f"{errs['loss32_rel']:.2e}, the card's gradients within "
        f"{worst['grad32']:.2e} of their scale, the CPU's within "
        f"{worst['cpu32']:.2e} ({beyond} of {len(h64['grads'])} tensors "
        f"beyond 1e-3; the tolerance {tol:.2e}), parameters after the step "
        f"within {worst['param32']:.2e} of the CPU's where the sign is "
        f"settled, norm statistics within {worst['stat32']:.2e}")
    return dict(cpu64_s=h64["secs"], cpu32_s=h32["secs"], errs=errs)


# ------------------------------------------------------ SECOND multi-class


def timed_forwards(forward, reps, batch):
    """Median host time of `reps` synchronised forwards (and peak memory
    over them) and frames/s; returns a report."""
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return dict(batch=batch, median_s=med, frames_per_s=batch / med,
                times_s=times, peak_mem_bytes=torch.cuda.max_memory_allocated())


def timed_steps(step, state, spec, vspec, batch, reps, what, profile=True,
                loss_of=one_stage_loss):
    """Median host time of `reps` synchronised train steps (after two warm
    ones), steps/s, examples/s, peak memory of one step, a synchronised
    split of one (`timed_split`) and, with `profile`, one profiled step.
    Returns (the speed report, the profile or None)."""
    n = batch["points"].shape[0]
    for _ in range(2):
        step(state, batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    split = timed_split(state, spec, vspec, batch, loss_of)
    say(f"{what} steps/s {1 / med:.3f}, examples/s {n / med:.3f} (median "
        f"{1e3 * med:.2f} ms of {reps} batch-{n} steps, "
        f"{1e3 * min(times):.2f}-{1e3 * max(times):.2f}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB; one split: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    speed = dict(median_s=med, steps_per_s=1 / med, examples_per_s=n / med,
                 times_s=times, peak_mem_bytes=peak, **split)
    prof = profile_forward(lambda: step(state, batch), med,
                           f"{what} step") if profile else None
    return speed, prof


def check_determinism(state, spec, vspec, batch, what,
                      loss_of=one_stage_loss):
    """Two backward passes from the same state on the same batch give
    bitwise-equal gradients (cuDNN set to deterministic algorithms)."""
    g1 = grads_of(state, spec, vspec, batch, loss_of)
    g2 = grads_of(state, spec, vspec, batch, loss_of)
    same = sum(torch.equal(a, b) for a, b in zip(g1, g2))
    if same != len(g1):
        fail(f"{what}: two backward passes from one state: {len(g1) - same} "
             f"of {len(g1)} gradients differ")
    say(f"{what} determinism: {len(g1)} gradients bitwise equal over two "
        f"runs")


def check_overfit(cfg, dev, mixed, step, batch, what, build=build_voxelnet):
    """Learning: a fresh state at the constant lr OVERFIT_LR on one fixed
    batch; the loss must fall below half its first value within
    OVERFIT_STEPS steps. Returns the report."""
    state, _, _, _ = new_train_state(cfg, dev, mixed, lr=OVERFIT_LR,
                                     build=build)
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if losses[-1] < 0.5 * losses[0]:
            break
    if not losses[-1] < 0.5 * losses[0]:
        fail(f"{what} overfit at lr {OVERFIT_LR}: the loss went "
             f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}) "
             f"in {len(losses)} steps, not below half")
    say(f"{what} learning: Adam at lr {OVERFIT_LR} on one batch, the loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (below half) in "
        f"{len(losses)} steps")
    return dict(lr=OVERFIT_LR, losses=losses)


def check_calls_exact(calls, what):
    """Each recorded sparse-conv and row-gather call of a forward against
    its plain version (convs within CONV_TOL, gathers exactly); returns
    the largest conv error."""
    worst = 0.0
    for i, (args, _) in enumerate(calls["gather_gemm"]):
        got, want = subm.gather_gemm(*args), subm.gather_gemm_plain(*args)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, **CONV_TOL):
            fail(f"{what} conv {i}: kernel disagrees with plain, max abs "
                 f"err {errors(got, want)[0]:.3g}")
        worst = max(worst, errors(got, want)[0])
    for i, (args, _) in enumerate(calls["gather_rows"]):
        if not torch.equal(gather.gather_rows(*args),
                           gather.gather_rows_plain(*args)):
            fail(f"{what} gather {i}: kernel disagrees with plain")
    say(f"{what}: {len(calls['gather_gemm'])} sparse convs within "
        f"{CONV_TOL} of their plain version (max abs err {worst:.2e}), "
        f"{len(calls['gather_rows'])} row gathers exact")
    return worst


def predict_fails_on_sync(spec, preds, anchors, what):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        predict(spec, preds, anchors)
    except RuntimeError as e:
        fail(f"{what}: predict synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def run_mc_eval(dev, timer, dtimer):
    """SECOND multi-class eval (configs/second_multiclass.config): the
    config's eval batch 3 of the fhd bench scene, 40 000 voxels, random
    weights from seed 0, per-class rotated NMS. Returns (the NMS kernels'
    aggregates, the launch counts, the report)."""
    report = {}
    cfg = load_pipeline_config(MC_CONFIG)
    mixed = cfg.train_config.enable_mixed_precision
    reader = cfg.eval_input_reader
    n = reader.batch_size
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device=dev, mixed_precision=mixed, seed=0)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     reader.max_number_of_voxels)
    points, mask, anchors = build_inputs(cfg, assigner, info, dev, n)
    A = anchors.shape[1]
    say(f"mc eval: classes {assigner.classes}, batch {n}, "
        f"{reader.max_number_of_voxels} voxels, points "
        f"{tuple(points.shape)}, anchors {A} an example, mixed precision "
        f"{mixed}")

    def forward():
        return detect(net, spec, vspec, points, mask, anchors, device=dev)

    with recording(MC_RECORDED) as calls:
        forward()
        torch.cuda.synchronize()
    say("mc capture: " + ", ".join(f"{k} {len(v)} calls"
                                   for k, v in calls.items()))
    if len(calls["gather_gemm"]) != SPARSE_CONVS or \
            len(calls["nms_sorted"]) != 1:
        fail(f"mc: expected {SPARSE_CONVS} sparse convs and one per-class "
             f"NMS call a forward")
    report["conv_max_abs_err"] = check_calls_exact(calls, "mc eval")
    # the 14 fp32 convs, each timed and held against fp64 as well
    report["convs"] = []
    conv_agg = check_convs(calls["gather_gemm"], timer, dtimer,
                           report["convs"])
    say(f"mc eval: the {SPARSE_CONVS} fp32 sparse convs take "
        f"{conv_agg['device_ms']:.4f} ms device (the CUDA-core kernel "
        f"this one replaced: 3.70 ms); bound "
        f"{1e3 * max(conv_agg['bytes_s'], conv_agg['ops_s']):.4f} ms by "
        f"{'bytes' if conv_agg['bytes_s'] >= conv_agg['ops_s'] else 'operations'}"
        f" ({1e3 * conv_agg['bytes_s']:.4f} ms of bytes, "
        f"{1e3 * conv_agg['ops_s']:.4f} ms of the found taps' operations as "
        f"3xTF32 at 495 TF/s); "
        f"{1e3 * max(conv_agg['bytes_s'], conv_agg['ops_cores_s']):.4f} ms "
        f"with the found taps at the CUDA cores' 67 TF/s; card "
        f"{card_line()}")
    ov, sup, report["nms"] = check_nms_pair(calls, timer, dtimer, "mc eval")
    aggs = {"sparse_gather_gemm": conv_agg, "rotated_iou": ov,
            "nms_suppress": sup}
    # the per-class keep sets of the same candidates, card against CPU
    (cand, cand_scores), kw = calls["nms_sorted"][0]
    rel_c, keep_c = nms_ops.nms_sorted(cand, cand_scores, **kw)
    rel_h, keep_h = nms_ops.nms_sorted(cand.cpu(), cand_scores.cpu(), **kw)
    if not (torch.equal(rel_c.cpu(), rel_h) and
            torch.equal(keep_c.cpu(), keep_h)):
        fail("mc eval: per-class NMS keep sets differ card vs CPU")
    report["kept_per_class"] = keep_h.sum(-1).view(n, -1).tolist()
    say(f"mc eval: per-class NMS of {tuple(cand_scores.shape)} candidates "
        f"(example-class rows, k): keep sets equal card vs CPU, kept by "
        f"example and class {report['kept_per_class']}")
    del calls

    reset_counts()
    det, vox, preds = forward()
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one mc forward: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS, "rotated_iou": 1,
            "nms_suppress": 1, "sparse_gather_gemm_dgrad": 0,
            "sparse_wgrad": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want or not counts["row_gather"]:
        fail(f"mc forward launches {counts}, expected {want} and row "
             f"gathers")
    predict_fails_on_sync(spec, preds, anchors, "mc eval")
    report["forward_host_syncs"] = host_syncs(forward)
    say(f"mc predict: no host sync; the forward {report['forward_host_syncs']}"
        f" host syncs (torch.cuda.set_sync_debug_mode)")
    report["voxel_overflow"] = int(vox["voxel_overflow"])
    report["stage_overflow"] = int(preds["stage_overflow"])
    if report["voxel_overflow"] or report["stage_overflow"]:
        fail(f"mc eval: voxel_overflow {report['voxel_overflow']} "
             f"stage_overflow {report['stage_overflow']}, expected 0")
    for k, c in (("box_preds", spec.box_code_size), ("cls_preds", 3)):
        if tuple(preds[k].shape) != (n, A, c) or \
                not torch.isfinite(preds[k]).all():
            fail(f"mc {k}: shape {tuple(preds[k].shape)} or non-finite")
    det_h = check_predict_batch(spec, preds, anchors, what="mc eval")
    labels = det_h["labels"][det_h["valid"]]
    report["detections_by_class"] = [int((labels == c).sum())
                                     for c in range(3)]
    say(f"mc eval: voxel_overflow 0, stage_overflow 0, voxels "
        f"{vox['voxel_valid'].sum(1).tolist()}; detections by class "
        f"{report['detections_by_class']}")

    report["forward"] = timed_forwards(forward, MC_TIMED, n)
    med = report["forward"]["median_s"]
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = device_voxelize(vspec, points, mask, dev)
    torch.cuda.synchronize()
    stages["voxelize_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    p = net(v["voxels"], v["num_points"], v["coordinates"], v["voxel_valid"])
    torch.cuda.synchronize()
    stages["network_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    predict(spec, p, anchors)
    torch.cuda.synchronize()
    stages["predict_ms"] = 1e3 * (time.perf_counter() - t0)
    report["forward"].update(stages, launches=counts, conv_paths=paths)
    say(f"mc frames/s {n / med:.3f} (median {1e3 * med:.2f} ms of {MC_TIMED} "
        f"batch-{n} forwards); peak memory "
        f"{report['forward']['peak_mem_bytes'] / 2 ** 30:.2f} GiB; one "
        f"split: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    report["profile"] = profile_forward(forward, med, "mc forward")
    # the fp32 RPN as a user runs it: torch lets cuDNN use TF32 by default
    # (this script turns TF32 off for its fp32 comparisons)
    torch.backends.cudnn.allow_tf32 = True
    try:
        report["forward_tf32"] = timed_forwards(forward, MC_TIMED, n)
        report["profile_tf32"] = profile_forward(
            forward, report["forward_tf32"]["median_s"],
            "mc forward, cuDNN TF32 on")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    say(f"mc frames/s with cuDNN TF32 on (torch's default) "
        f"{report['forward_tf32']['frames_per_s']:.3f}")
    return aggs, counts, report


def run_mc_train(dev, timer, dtimer):
    """SECOND multi-class train step: the config's batch 3 of synthetic
    scans with pedestrians and cyclists, 17 000 voxels (shuffle_overflow),
    bf16, the config's one-cycle AdamW from flax's initialisers; every
    kernel call of one step against its plain version. Returns (the launch
    counts, the report)."""
    report = {}
    cfg = load_pipeline_config(MC_CONFIG)
    reader = cfg.train_input_reader
    n = reader.batch_size
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, True)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     reader.max_number_of_voxels,
                                     shuffle_overflow=True)
    batch = train_inputs(cfg, assigner, info, dev, n)
    pos = [int((batch["labels"] == c).sum()) for c in (1, 2, 3)]
    say(f"mc train: batch {n} synthetic scans, {reader.max_number_of_voxels} "
        f"voxels (shuffle_overflow), bf16, positives by class {pos}")
    if not all(pos):
        fail(f"mc train: positives by class {pos}, want every class")
    report["positives_by_class"] = pos
    step = make_train_step(spec, vspec)
    with recording(RECORDED_TRAIN) as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    aggs, report["calls"] = check_step_calls("mc train", calls, timer,
                                             dtimer)
    report["calls_ms"] = {k: {m: a[m] for m in ("ms", "device_ms",
                                                "plain_ms", "library_ms")}
                          for k, a in aggs.items()}
    del calls
    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one mc train step: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS,
            "sparse_gather_gemm_dgrad": SPARSE_CONVS - 1,
            "sparse_wgrad": SPARSE_CONVS, "rotated_iou": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want or paths != {
            "mma": 2 * SPARSE_CONVS - 1, "fma": 0,
            "wgrad_mma": SPARSE_CONVS, "wgrad_fma": 0}:
        fail(f"mc train step launches {counts} {paths}, expected {want} "
             f"on the tensor-core path")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"mc train metrics not finite: {m}")
    report["metrics"], report["launches"] = m, counts
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the mc train step synchronised the host {n_syncs} times")
    say("mc train step: no host sync; " +
        ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    check_determinism(state, spec, vspec, batch, "mc")
    report["speed"], report["profile"] = timed_steps(
        step, state, spec, vspec, batch, MC_TIMED, "mc train")
    del state
    report["overfit"] = check_overfit(cfg, dev, True, step, batch, "mc")
    torch.backends.cudnn.deterministic = False
    return counts, report


def run_kitti(dev, timer, dtimer):
    """The KITTI reader's path on the card: a fake tree (KITTI_FRAMES
    frames of cars, a pedestrian and a cyclist in ground clutter) in a
    temporary directory, prepared by the port's create-data functions, then
    `Trainer(synthetic=False)` on second_multiclass.config (its readers,
    database sampler and augmentation on the tree) for 3 steps and an
    `evaluate` with the official KITTI AP. Every kernel call of the
    Trainer's first step and of the first eval forward is held against its
    plain version. Returns (launch counts, report)."""
    import tempfile
    from second_tpu_torch.data import fake_kitti, kitti_dataset
    from second_tpu_torch.train.run import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root = fake_kitti.write_tree(
            tmp / "kitti", np.random.default_rng(0), ids=range(KITTI_FRAMES),
            label=fake_kitti.MULTICLASS_LABEL, clutter=KITTI_CLUTTER,
            splits=("train", "val"), shift=2.5)
        kitti_dataset.create_kitti_info_file(root)
        kitti_dataset.create_reduced_point_cloud(root)
        kitti_dataset.create_groundtruth_database(root)
        prep_s = time.perf_counter() - t0
        patches = [
            f"train_input_reader.kitti_info_path="
            f"'{root / 'kitti_infos_train.pkl'}'",
            f"train_input_reader.kitti_root_path='{root}'",
            f"train_input_reader.database_sampler.database_info_path="
            f"'{root / 'kitti_dbinfos_train.pkl'}'",
            f"eval_input_reader.kitti_info_path="
            f"'{root / 'kitti_infos_val.pkl'}'",
            f"eval_input_reader.kitti_root_path='{root}'",
            "train_config.steps_per_eval=0",
            "train_config.save_summary_steps=1"]
        reset_counts()
        tr = Trainer(MC_CONFIG, tmp / "run", synthetic=False,
                     max_points=MAX_POINTS, total_steps=3, patches=patches,
                     device=dev)
        try:
            t0 = time.perf_counter()
            with recording(RECORDED_TRAIN + [(gather, "gather_rows")]) \
                    as train_calls:
                state = tr.train(3)
            train_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with recording(RECORDED) as eval_calls:
                detail = tr.evaluate(state)
            eval_s = time.perf_counter() - t0
        finally:
            tr.logger.close()
        counts = launch_counts()
        log = [json.loads(line) for line in
               (tmp / "run" / "log.json").read_text().splitlines()]
    checked = check_kitti_calls(train_calls, eval_calls, timer, dtimer)
    del train_calls, eval_calls
    losses = [r["train.loss"] for r in log if "train.loss" in r]
    ap = {k: v[1] for k, v in detail.items() if "/3d" in k}
    if len(losses) != 3 or not all(np.isfinite(losses)):
        fail(f"kitti: train losses {losses}, want 3 finite")
    if not ap:
        fail(f"kitti: evaluate gave no /3d AP keys: {sorted(detail)}")
    if not (counts["sparse_gather_gemm"] and counts["rotated_iou"]):
        fail(f"kitti: the Trainer launched {counts}")
    say(f"kitti: {KITTI_FRAMES} fake frames prepared in {prep_s:.1f} s; "
        f"Trainer(synthetic=False) on {MC_CONFIG.name}: losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f" in {train_s:.1f} s, "
        f"evaluate in {eval_s:.1f} s with {len(ap)} /3d AP keys; launches "
        f"{counts}")
    return counts, dict(losses=losses, ap_3d=ap, prep_s=prep_s,
                        train_s=train_s, eval_s=eval_s, **checked)


def check_kitti_calls(train_calls, eval_calls, timer, dtimer):
    """The KITTI path's recorded kernel calls against their plain versions:
    the Trainer's steps (every forward, dX and weight-gradient call within
    GRAD_KERNEL_TOL of its scale, every row gather exact) and its eval
    forwards (`check_calls_exact`, then each forward's NMS pair by
    `check_nms_pair`). Returns the numbers of calls checked."""
    check_step_calls("kitti train", train_calls, timer, dtimer, timed=False)
    for i, (args, _) in enumerate(train_calls["gather_rows"]):
        if not torch.equal(gather.gather_rows(*args),
                           gather.gather_rows_plain(*args)):
            fail(f"kitti train gather {i}: kernel disagrees with plain")
    check_calls_exact(eval_calls, "kitti eval")
    pairs = list(zip(eval_calls["nms_overlap"], eval_calls["nms_suppress"]))
    if not pairs or len(eval_calls["nms_overlap"]) != \
            len(eval_calls["nms_suppress"]):
        fail(f"kitti eval: {len(eval_calls['nms_overlap'])} overlap and "
             f"{len(eval_calls['nms_suppress'])} suppression calls")
    for i, (ov, sup) in enumerate(pairs):
        check_nms_pair({"nms_overlap": [ov], "nms_suppress": [sup]}, timer,
                       dtimer, f"kitti eval forward {i}")
    checked = {f"train_{k}": len(v) for k, v in train_calls.items()}
    checked.update({f"eval_{k}": len(v) for k, v in eval_calls.items()})
    say(f"kitti: every recorded kernel call equals its plain version: "
        f"{checked}")
    return dict(checked_calls=checked)


# ------------------------------------------------- the IoU branch (fhd)


def d3_bound(boxes1, boxes2, cull):
    """(bytes seconds, ops seconds, ops) of one 3-D IoU call: the boxes read
    once and the [B, N, K] output written once; each box staged once
    (D3_BOX_OPS), a cull test a pair (D3_TEST_OPS), and the BEV clip as
    `riou_ops` counts it plus D3_EXTRA_OPS only for the pairs that `cull`
    (`d3_cull_plain`) keeps."""
    B, N = boxes1.shape[:2]
    K = boxes2.shape[1]
    bev1 = bev_boxes(boxes1).reshape(B * N, 5)
    bev2 = bev_boxes(boxes2).reshape(B * K, 5)
    kb, kn, kk = torch.nonzero(~cull, as_tuple=True)
    ops = B * (N + K) * D3_BOX_OPS + B * N * K * D3_TEST_OPS + \
        riou_ops(bev1, bev2, kb * N + kn, kb * K + kk, D3_EXTRA_OPS)
    nbytes = (boxes1.numel() + boxes2.numel() + B * N * K) * 4
    peak = PEAK_OPS_PER_S[torch.float32]
    return nbytes / HBM_BYTES_PER_S, ops / peak, ops


def run_fhd_iou_train(dev, timer, dtimer):
    """The fhd train step with the IoU branch (second_car_fhd.config with
    use_iou_branch): batch 4 synthetic scans, 16 000 voxels, bf16. Every
    sparse-conv kernel call of one step and the 3-D IoU kernel on the
    step's real call against their plain versions, timed, with bounds; launches and no host sync; the IoU loss; then an eval
    forward ranked by the predicted IoU, predict card against CPU. Returns
    (the kernel's aggregate, the launch counts, the report)."""
    report = {}
    cfg = load_pipeline_config(CONFIG)
    cfg.model.use_iou_branch = True
    mixed = cfg.train_config.enable_mixed_precision
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, mixed)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     TRAIN_VOXELS, shuffle_overflow=True)
    batch = train_inputs(cfg, assigner, info, dev, TRAIN_BATCH)
    step = make_train_step(spec, vspec)
    with recording(RECORDED_TRAIN + [(riou, "d3_iou")]) as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    if len(calls["d3_iou"]) != 1:
        fail(f"fhd iou: {len(calls['d3_iou'])} 3-D IoU calls a step, want 1")
    step_aggs, report["calls"] = check_step_calls("fhd iou train", calls,
                                                  timer, dtimer)
    report["calls_ms"] = {k: {m: a[m] for m in ("ms", "device_ms",
                                                "plain_ms", "library_ms")}
                          for k, a in step_aggs.items()}
    (b1, b2), _ = calls["d3_iou"][0]
    del calls
    got, clipped = riou.d3_iou(b1, b2, count=True)
    want = riou.d3_iou_plain(b1, b2)
    cull = riou.d3_cull_plain(b1, b2)
    kept = (~cull).sum((1, 2))
    torch.cuda.synchronize()
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)) or \
            not torch.allclose(got, want, atol=RIOU_TOL, rtol=0,
                               equal_nan=True):
        fail("fhd iou: the 3-D IoU kernel disagrees with its plain version")
    if not torch.equal(clipped.long(), kept):
        fail(f"fhd iou: the 3-D IoU kernel clipped {clipped.tolist()} pairs "
             f"an example, d3_cull_plain keeps {kept.tolist()}")
    culled_max = want[cull].max().item() if cull.any() else 0.0
    if not culled_max <= D3_CULLED_MAX:
        fail(f"fhd iou: a culled pair's plain 3-D IoU is {culled_max:.3g}, "
             f"above {D3_CULLED_MAX}")
    fin = torch.isfinite(want)
    err = (got - want)[fin].abs().max().item() if fin.any() else 0.0
    bs, os_, ops = d3_bound(b1, b2, cull)
    agg = dict(err=err, bytes_s=bs, ops_s=os_, library_ms=None,
               library_device_ms=None,
               ms=timer(lambda: riou.d3_iou(b1, b2), 10),
               plain_ms=timer(lambda: riou.d3_iou_plain(b1, b2), 3),
               device_ms=dtimer([lambda: riou.d3_iou(b1, b2)])[0])
    pairs = cull.numel()
    overlapping = int((want > 0).sum())
    report["d3_iou"] = dict(
        shape=[list(b1.shape), list(b2.shape)], non_finite=int((~fin).sum()),
        overlapping=overlapping, clipped=clipped.tolist(),
        clipped_share=int(kept.sum()) / pairs, culled_max=culled_max,
        ops=ops, **agg)
    say(f"d3_iou [{', '.join(map(str, b1.shape))}] x "
        f"[{', '.join(map(str, b2.shape))}]: err {err:.2e} "
        f"({int((~fin).sum())} non-finite entries equal); clipped "
        f"{int(kept.sum())} of {pairs} pairs ({clipped.tolist()} an "
        f"example, as d3_cull_plain), {overlapping} overlapping, culled "
        f"pairs' plain IoU at most {culled_max:.3g}; kernel "
        f"{agg['ms']:.4f} ms (device {agg['device_ms']:.4f})  plain "
        f"{agg['plain_ms']:.4f} ms  bound {1e3 * max(bs, os_):.4f} ms "
        f"({'bytes' if bs >= os_ else 'operations'}; {ops / 1e9:.4f} G "
        f"operations)")
    del b1, b2, got, want, cull

    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    say(f"launches in one fhd IoU-branch train step: {counts}")
    want_c = {"sparse_gather_gemm": SPARSE_CONVS,
              "sparse_gather_gemm_dgrad": SPARSE_CONVS - 1,
              "sparse_wgrad": SPARSE_CONVS, "d3_iou": 1}
    if {k: counts[k] for k in want_c} != want_c:
        fail(f"fhd iou train step launches {counts}, expected {want_c}")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()) or \
            not m.get("iou_loss", 0.0) > 0:
        fail(f"fhd iou: metrics not finite or no IoU loss: {m}")
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the fhd IoU-branch train step synchronised the host "
             f"{n_syncs} times")
    report["metrics"], report["launches"] = m, counts
    say(f"fhd iou train step: no host sync; iou_loss {m['iou_loss']:.4g}, "
        f"loss {m['loss']:.4g}")
    report["speed"], _ = timed_steps(step, state, spec, vspec, batch,
                                     MC_TIMED, "fhd iou train",
                                     profile=False)
    torch.backends.cudnn.deterministic = False

    # an eval forward ranked by the predicted IoU, predict card against CPU
    del state
    net = build_voxelnet(cfg.model, device=dev, mixed_precision=mixed,
                         seed=0)[0]
    points, mask, anchors = build_inputs(cfg, assigner, info, dev)
    evspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    with torch.no_grad(), recording() as calls:
        _, _, preds = detect(net, spec, evspec, points, mask, anchors,
                             device=dev)
        torch.cuda.synchronize()
    if "iou_preds" not in preds or not torch.isfinite(preds["iou_preds"]).all():
        fail("fhd iou: the eval forward has no finite iou_preds")
    # over the empty BEV a random IoU head's logits are nearly constant: its
    # ranking is decided by the devices' sigmoids a rounding unit apart, so
    # the card's and the CPU's predict are held on a ranking free of such
    # near-ties (logits a permutation of an even grid over [-4, 4])
    B, A = anchors.shape[:2]
    rank = torch.sigmoid(preds["iou_preds"].reshape(B, A))
    top = nms_ops.top_k(rank, spec.nms_pre_max_size)[0]
    report["rank_ties_top_k"] = [int(spec.nms_pre_max_size - r.unique().numel())
                                 for r in top]
    g = torch.Generator().manual_seed(0)
    grid = torch.randperm(B * A, generator=g).float() / (B * A) * 8 - 4
    with torch.no_grad():
        check_predict_batch(
            spec, dict(preds, iou_preds=grid.view(B, A, 1).to(dev)), anchors,
            calls["nms"][0], what="fhd iou reference")
    say(f"fhd iou: the forward's own IoU ranking has "
        f"{report['rank_ties_top_k']} exact ties among each example's top "
        f"{spec.nms_pre_max_size}")
    return agg, counts, report


# ------------------------------------------------ the two-stage detector


def build_two_stage(model, device, mixed_precision=False, seed=0,
                    proposals=TWO_STAGE_PROPOSALS):
    """`build_two_stage_voxelnet` with the signature of `build_voxelnet`."""
    return build_two_stage_voxelnet(model, proposals, device=device,
                                    mixed_precision=mixed_precision,
                                    seed=seed)


def roi_pixels(feat, coords):
    """(taps inside the map, distinct map pixels they touch) of these
    samples: what the ROI-align reads."""
    B, C, H, W = feat.shape
    x0, y0 = torch.floor(coords[..., 0]), torch.floor(coords[..., 1])
    b = torch.arange(B, device=feat.device).view(B, 1, 1, 1).expand_as(x0)
    keys, n_in = [], 0
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
            n_in += int(inb.sum())
            keys.append(((b * H + y.long()) * W + x.long())[inb])
    return n_in, int(torch.unique(torch.cat(keys)).numel())


def roi_library(feat, coords, samples):
    """One `F.grid_sample` (bilinear, zeros outside, the same sample points,
    the map in the coordinates' dtype) and one `F.avg_pool2d` over the
    s x s samples: the library yardstick of the ROI-align forward."""
    B, N, SH, SW, _ = coords.shape
    C, H, W = feat.shape[1:]
    grid = torch.stack([coords[..., 0] / (W - 1) * 2 - 1,
                        coords[..., 1] / (H - 1) * 2 - 1], -1)
    out = torch.nn.functional.grid_sample(
        feat.to(coords.dtype), grid.reshape(B, N * SH, SW, 2),
        mode="bilinear", padding_mode="zeros", align_corners=True)
    out = torch.nn.functional.avg_pool2d(out, samples)
    oh, ow = SH // samples, SW // samples
    return out.view(B, C, N, oh, ow).transpose(1, 2).reshape(B * N, C, oh,
                                                             ow)


def check_roi_calls(fwd_calls, bwd_calls, timer, dtimer, what):
    """Each recorded ROI-align forward (and backward) call against its plain
    version on the same inputs (ROI_FWD_TOL, ROI_BWD_TOL), timed by events
    and by the device timer beside its plain version and its library
    yardstick (`roi_library`, and autograd of it for the backward), with
    its bound counted from the samples this run's rois give. Returns the
    forward's and the backward's aggregates."""
    aggs = {}
    for name, calls in (("roi_align_fwd", fwd_calls),
                        ("roi_align_bwd", bwd_calls)):
        agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0,
                   library_device_ms=0.0, bytes_s=0.0, ops_s=0.0, err=0.0)
        for i, (args, _) in enumerate(calls):
            if name == "roi_align_fwd":
                feat, coords, s = args
            else:
                feat, coords, grad, s = args
            B, C, H, W = feat.shape
            _, N, SH, SW, _ = coords.shape
            R, nsamp, bins = B * N, SH * SW, SH * SW // (s * s)
            n_in, pixels = roi_pixels(feat, coords)
            esz = feat.element_size()
            cbytes = coords.numel() * coords.element_size()
            f32 = feat.to(coords.dtype)
            if name == "roi_align_fwd":
                got = roi_align.roi_align_fwd(feat, coords, s)
                want = roi_align.roi_align_plain(feat, coords, s)
                lib = roi_library(feat, coords, s)
                torch.cuda.synchronize()
                err, rel = errors(got, want)
                lib_err = errors(lib, want)[1]
                if rel > ROI_FWD_TOL:
                    fail(f"{what} roi_align_fwd {i}: {rel:.3g} of the scale "
                         f"from the plain version, over {ROI_FWD_TOL}")
                nbytes = cbytes + pixels * C * esz + got.numel() * 4
                ops = R * nsamp * ROI_SAMPLE_OPS + \
                    R * C * bins * (8 * s * s + 1)
                fns = (lambda: roi_align.roi_align_fwd(feat, coords, s),
                       lambda: roi_align.roi_align_plain(feat, coords, s),
                       lambda: roi_library(feat, coords, s))
            else:
                gf, gc, counts = roi_align.roi_align_bwd(feat, coords, grad,
                                                         s, counts=True)
                wf, wc = roi_align.roi_align_backward_plain(f32, coords,
                                                            grad, s)
                # the kernel's bookkeeping against the plain mirror's:
                # in-map samples and runs of one cell, exactly
                keys, ncells = roi_align.sample_cells(coords, H, W)
                want_counts = roi_align.cell_counts(keys, ncells)
                if tuple(counts.tolist()) != want_counts:
                    fail(f"{what} roi_align_bwd {i}: in-map samples and cell "
                         f"runs {tuple(counts.tolist())}, the plain mirror's "
                         f"{want_counts}")
                with torch.enable_grad():
                    lf = f32.detach().requires_grad_(True)
                    lc = coords.detach().requires_grad_(True)
                    lib_out = roi_library(lf, lc, s)
                lib = torch.autograd.grad(lib_out, (lf, lc), grad,
                                          retain_graph=True)
                torch.cuda.synchronize()
                again = roi_align.roi_align_bwd(feat, coords, grad, s)
                if not (torch.equal(again[0], gf) and
                        torch.equal(again[1], gc)):
                    fail(f"{what} roi_align_bwd {i}: two calls differ")
                ef, rf = errors(gf, wf)
                ec, rc = errors(gc, wc)
                err, rel = max(ef, ec), max(rf, rc)
                lib_err = max(errors(lib[0], wf)[1], errors(lib[1], wc)[1])
                if rf > ROI_BWD_TOL or rc > ROI_BWD_TOL:
                    fail(f"{what} roi_align_bwd {i}: the map's gradient "
                         f"{rf:.3g}, the coordinates' {rc:.3g} of their "
                         f"scale from autograd of the plain version, over "
                         f"{ROI_BWD_TOL}")
                nbytes = grad.numel() * 4 + cbytes + pixels * C * esz + \
                    gf.numel() * 4 + gc.numel() * gc.element_size()
                ops = n_in * C * ROI_TAP_GRAD_OPS + \
                    R * nsamp * C * ROI_SAMPLE_GRAD_OPS

                def library_bwd(out=lib_out, lf=lf, lc=lc, g=grad):
                    return torch.autograd.grad(out, (lf, lc), g,
                                               retain_graph=True)
                fns = (lambda: roi_align.roi_align_bwd(feat, coords, grad, s),
                       lambda: roi_align.roi_align_backward_plain(
                           f32, coords, grad, s),
                       library_bwd)
            bs = nbytes / HBM_BYTES_PER_S
            os_ = ops / PEAK_OPS_PER_S[torch.float32]
            ms = [timer(fns[0], 10), timer(fns[1], 3), timer(fns[2], 5)]
            dev_ms = dtimer([fns[0], fns[2]])
            for k, v in zip(("ms", "plain_ms", "library_ms"), ms):
                agg[k] += v
            agg["device_ms"] += dev_ms[0]
            agg["library_device_ms"] += dev_ms[1]
            agg["bytes_s"] += bs
            agg["ops_s"] += os_
            agg["err"] = max(agg["err"], err)
            say(f"{what} {name} {i} {str(feat.dtype)[6:]} map "
                f"[{B}, {C}, {H}, {W}], {R} rois x {nsamp} samples "
                f"({n_in} taps inside, {pixels} pixels): err {err:.2e} "
                f"rel {rel:.2e} (library {lib_err:.2e}); kernel "
                f"{ms[0]:.4f} ms (device {dev_ms[0]:.4f})  plain "
                f"{ms[1]:.4f} ms  library {ms[2]:.4f} ms (device "
                f"{dev_ms[1]:.4f})  bound {1e3 * max(bs, os_):.4f} ms "
                f"({'bytes' if bs >= os_ else 'operations'})")
            if name == "roi_align_bwd":
                split = device_split(fns[0], dtimer)
                agg["split"] = {k: ms for k, (ms, _) in split.items()}
                agg["counts"] = want_counts
                say(f"{what} roi_align_bwd {i}: {want_counts[0]} in-map "
                    f"samples in {want_counts[1]} cell runs, the kernel's "
                    f"counts equal; device "
                    f"{sum(agg['split'].values()):.4f} ms a call (the "
                    f"backward of a key a tap it replaced: 2.58 ms), by "
                    f"kernel: " + "; ".join(
                        f"{k[:60]} {v:.4f} x{n:g}"
                        for k, (v, n) in split.items()))
        aggs[name] = agg
    return aggs


def check_standup_calls(calls, sup_calls, timer, dtimer, what):
    """Each recorded standup-bitmask call against its plain version (every
    bit equal), the suppression that read it against the plain one (keep
    equal), timed with its bound (the valid pairs' tests, the boxes'
    areas, the bitmask written); the plain version's three calls are the
    library yardstick. Returns the aggregate."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0,
               library_device_ms=0.0, bytes_s=0.0, ops_s=0.0, err=0.0)
    for i, ((cand, valid, thr), _) in enumerate(calls):
        got = riou.standup_overlap(cand, valid, thr)
        want = riou.standup_overlap_plain(cand, valid, thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            n = int((riou.unpack_bits(got, cand.shape[1]) !=
                     riou.unpack_bits(want, cand.shape[1])).sum())
            fail(f"{what} standup_overlap {i}: {n} bits differ from the "
                 f"plain version")
        sup = [a for a, _ in sup_calls if torch.equal(a[0], got)]
        if not sup:
            fail(f"{what} standup_overlap {i}: no suppression read it")
        keep = riou.nms_suppress(got, valid)
        if not torch.equal(keep, riou.nms_suppress_plain(want, valid)):
            fail(f"{what} standup NMS {i}: keep differs from the plain "
                 f"chain's")
        B, K = valid.shape
        n_valid = valid.sum(1).double()
        tests = float((n_valid * (n_valid - 1) / 2).sum())
        nbytes = cand.numel() * cand.element_size() + valid.numel() + \
            got.numel() * 4
        bs = nbytes / HBM_BYTES_PER_S
        os_ = (tests * STANDUP_TEST_OPS + B * K * STANDUP_AREA_OPS) / \
            PEAK_OPS_PER_S[torch.float32]
        fns = (lambda: riou.standup_overlap(cand, valid, thr),
               lambda: riou.standup_overlap_plain(cand, valid, thr))
        ms = [timer(fns[0], 20), timer(fns[1], 5)]
        dev_ms = dtimer(list(fns))
        agg["ms"] += ms[0]
        agg["plain_ms"] += ms[1]
        agg["library_ms"] += ms[1]
        agg["device_ms"] += dev_ms[0]
        agg["library_device_ms"] += dev_ms[1]
        agg["bytes_s"] += bs
        agg["ops_s"] += os_
        say(f"{what} standup_overlap {i} B={B} K={K} thr={thr}: bits exact "
            f"({int(riou.unpack_bits(got, K).sum())} set), NMS keep exact "
            f"({keep.sum(1).tolist()} kept); kernel {ms[0]:.4f} ms (device "
            f"{dev_ms[0]:.4f})  plain (the library yardstick) {ms[1]:.4f} ms "
            f"(device {dev_ms[1]:.4f})  bound {1e3 * max(bs, os_):.6f} ms "
            f"({'bytes' if bs >= os_ else 'operations'}; {tests:.0f} pair "
            f"tests)")
    return agg


def two_stage_split(net, spec, vspec, points, mask, anchors, dev):
    """One two-stage eval forward cut at its stage boundaries, each
    synchronised: ms of voxelize, stage 1, proposals, crops, refine head,
    predict."""
    from second_tpu_torch.models.second_stage import select_proposals
    out, t0 = {}, None

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        if name:
            out[f"{name}_ms"] = 1e3 * (now - t0)
        t0 = now
    with torch.no_grad():
        lap(None)
        vox = device_voxelize(vspec, points, mask, dev)
        lap("voxelize")
        stage1 = net.stage1(vox["voxels"], vox["num_points"],
                            vox["coordinates"], vox["voxel_valid"])
        lap("stage1")
        proposals = select_proposals(net.pspec, spec, stage1, anchors)
        lap("proposals")
        crops = net.crops(stage1["trunk"], proposals)
        lap("crops")
        head = net.second_rpn(crops)
        B, N = proposals["indices"].shape
        preds = {**stage1, "proposals": proposals,
                 "second_box_preds": head["box_preds"].reshape(B, N, -1) +
                 proposals["box_enc"],
                 "second_cls_preds": head["cls_preds"].reshape(B, N, -1)}
        lap("head")
        predict_two_stage(spec, preds, anchors)
        lap("predict")
    return out


def run_2st_eval(dev, timer, dtimer):
    """The two-stage detector's eval forward (second_car_fhd.config as stage
    1, bf16 as the config asks, 512 proposals an example, random weights
    from seed 0) on the fhd bench input (batch 4, 40 000 voxels), through
    the two-stage eval step. Returns (the forward and standup kernels'
    aggregates, the launch counts, the report)."""
    report = {}
    cfg = load_pipeline_config(CONFIG)
    mixed = cfg.train_config.enable_mixed_precision
    net, spec, info, assigner, _ = build_two_stage(cfg.model, dev, mixed)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    points, mask, anchors = build_inputs(cfg, assigner, info, dev)
    eval_step = make_two_stage_steps(spec, vspec)[1]
    state = TrainState(net, None)
    batch = {"points": points, "points_mask": mask, "anchors": anchors}
    say(f"2st eval: batch {BATCH}, {MAX_VOXELS} voxels, "
        f"{TWO_STAGE_PROPOSALS} proposals an example, mixed precision "
        f"{mixed}")

    def forward():
        return eval_step(state, batch)

    with recording(RECORDED_2ST) as calls:
        forward()
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"2st capture: {n}")
    want_n = {"gather_gemm": SPARSE_CONVS, "nms_overlap": 1,
              "nms_suppress": 2, "roi_align_fwd": 1, "standup_overlap": 1}
    if {k: n[k] for k in want_n} != want_n:
        fail(f"2st eval: recorded {n}, expected {want_n}")
    report["conv_max_abs_err"] = check_calls_exact(calls, "2st eval")
    # the refined proposals' rotated NMS: the overlap call and the
    # suppression that read its bitmask
    over_bits = riou.nms_overlap(*calls["nms_overlap"][0][0])[0]
    rot_sup = [c for c in calls["nms_suppress"]
               if c[0][0].shape == over_bits.shape and
               torch.equal(c[0][0], over_bits)]
    if len(rot_sup) != 1:
        fail("2st eval: no suppression call read the overlap bitmask")
    ov, sup, report["nms"] = check_nms_pair(
        {"nms_overlap": calls["nms_overlap"], "nms_suppress": rot_sup},
        timer, dtimer, "2st eval")
    aggs = {"standup_overlap": check_standup_calls(
        calls["standup_overlap"], calls["nms_suppress"], timer, dtimer,
        "2st eval")}
    aggs.update(check_roi_calls(calls["roi_align_fwd"], [], timer, dtimer,
                                "2st eval"))
    del aggs["roi_align_bwd"], calls

    reset_counts()
    det = forward()
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one 2st forward: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS, "rotated_iou": 1,
            "nms_suppress": 2, "roi_align_fwd": 1, "standup_overlap": 1,
            "roi_align_bwd": 0, "sparse_gather_gemm_dgrad": 0,
            "sparse_wgrad": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want or not counts["row_gather"]:
        fail(f"2st forward launches {counts}, expected {want} and row "
             f"gathers")
    if mixed and (paths["mma"], paths["fma"]) != (SPARSE_CONVS, 0):
        fail(f"2st: not every bf16 sparse conv took the tensor-core path: "
             f"{paths}")
    report["launches"] = counts
    report["host_syncs"] = host_syncs(forward)
    if report["host_syncs"]:
        fail(f"the 2st eval step synchronised the host "
             f"{report['host_syncs']} times")
    for k in ("voxel_overflow", "stage_overflow"):
        report[k] = int(det[k])
        if report[k]:
            fail(f"2st eval: {k} {report[k]}, expected 0")
    for k in ("boxes", "scores"):
        if not torch.isfinite(det[k]).all():
            fail(f"2st eval: non-finite {k}")
    report["valid"] = det["valid"].sum(1).tolist()
    say(f"2st eval: no host sync; voxel_overflow 0, stage_overflow 0; "
        f"valid detections {report['valid']}")

    report["forward"] = timed_forwards(forward, TWO_STAGE_TIMED, BATCH)
    med = report["forward"]["median_s"]
    report["split"] = two_stage_split(net, spec, vspec, points, mask,
                                      anchors, dev)
    say(f"2st frames/s {BATCH / med:.3f} (median {1e3 * med:.2f} ms of "
        f"{TWO_STAGE_TIMED} batch-{BATCH} forwards, cuDNN TF32 off); peak "
        f"memory {report['forward']['peak_mem_bytes'] / 2 ** 30:.2f} GiB; "
        f"one split: " + ", ".join(f"{k} {v:.2f}"
                                   for k, v in report["split"].items()))
    report["profile"] = profile_forward(forward, med, "2st forward")
    torch.backends.cudnn.allow_tf32 = True
    try:
        report["forward_tf32"] = timed_forwards(forward, TWO_STAGE_TIMED,
                                                BATCH)
        report["split_tf32"] = two_stage_split(net, spec, vspec, points,
                                               mask, anchors, dev)
        report["profile_tf32"] = profile_forward(
            forward, report["forward_tf32"]["median_s"],
            "2st forward, cuDNN TF32 on")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    say(f"2st frames/s with cuDNN TF32 on (torch's default) "
        f"{report['forward_tf32']['frames_per_s']:.3f}; one split: " +
        ", ".join(f"{k} {v:.2f}" for k, v in report["split_tf32"].items()))
    del net, state
    report["reference"] = check_2st_reference(cfg, dev, vspec, points, mask,
                                              anchors)
    return aggs, counts, report


def check_2st_reference(cfg, dev, vspec, points, mask, anchors):
    """One fp32 example through the two-stage detector on the card and on
    the CPU, from the same seeded weights: stage 1 end to end within
    PRED_TOL; then each later step on the card's own inputs, card (kernels)
    against CPU (plain versions): the proposals' standup NMS on the same
    boxes and scores (indices and keep equal), the crops at the same
    proposal boxes (CROP_REF_TOL), the refine head on the same crops
    (PRED_TOL), the rotated NMS of `predict_two_stage` on the same
    candidates (indices and keep equal). `predict_two_stage` whole on the
    same predictions, and the CPU's proposals from its own stage 1, are
    compared and printed, not gated: a random head gives the proposals of
    empty regions tied scores, and boxes decoded an ulp apart on the two
    devices can trade places among them."""
    cpu = torch.device("cpu")
    net_c, spec = build_two_stage(cfg.model, dev)[:2]
    net_h = build_two_stage(cfg.model, cpu)[0]
    one = [t[:1] for t in (points, mask)]
    a_c = anchors[:1]
    a_h = a_c.cpu()

    def to_cpu(preds):
        out = {k: v.cpu() for k, v in preds.items() if k != "proposals"}
        if "proposals" in preds:
            out["proposals"] = {k: v.cpu()
                                for k, v in preds["proposals"].items()}
        return out
    with torch.no_grad():
        vox = device_voxelize(vspec, *one, dev)
        s1_c = net_c.stage1(vox["voxels"], vox["num_points"],
                            vox["coordinates"], vox["voxel_valid"])
        t0 = time.perf_counter()
        vox_h = device_voxelize(vspec, *[t.cpu() for t in one], cpu)
        s1_h = net_h.stage1(vox_h["voxels"], vox_h["num_points"],
                            vox_h["coordinates"], vox_h["voxel_valid"])
        own_h = net_h.refine(s1_h, a_h)["proposals"]
        cpu_s = time.perf_counter() - t0
        errs = {}
        for k in ("box_preds", "cls_preds", "trunk"):
            a, b = s1_c[k].cpu().float(), s1_h[k].float()
            errs[k] = (a - b).abs().max().item()
            if not torch.allclose(a, b, **PRED_TOL):
                fail(f"2st reference: stage 1 {k} card vs CPU max abs err "
                     f"{errs[k]:.3g} over {PRED_TOL}")
        with recording([(nms_ops, "nearest_nms")]) as calls:
            p_c = net_c.refine(s1_c, a_c)
        args, kwargs = calls["nearest_nms"][0]
        idx_c, keep_c = nms_ops.nearest_nms(*args, **kwargs)
        idx_h, keep_h = nms_ops.nearest_nms(*[a.cpu() for a in args],
                                            **kwargs)
        if not (torch.equal(idx_c.cpu(), idx_h) and
                torch.equal(keep_c.cpu(), keep_h) and
                torch.equal(idx_c, p_c["proposals"]["indices"])):
            fail("2st reference: the proposals' standup NMS differs card vs "
                 "CPU on the same boxes and scores")
        prop_h = to_cpu(p_c)["proposals"]
        c_c = net_c.crops(s1_c["trunk"], p_c["proposals"])
        c_h = net_h.crops(s1_c["trunk"].cpu(), prop_h)
        hd_c = net_c.second_rpn(c_c)
        hd_h = net_h.second_rpn(c_c.cpu())
        with recording([(nms_ops, "nms")]) as calls:
            det_c = predict_two_stage(spec, p_c, a_c)
        (args, kwargs), = calls["nms"]
        sel_c, keep_c = nms_ops.nms(*args, **kwargs)
        sel_h, keep_h = nms_ops.nms(*[a.cpu() for a in args], **kwargs)
        det_h = predict_two_stage(spec, to_cpu(p_c), a_h)
    errs["crops_rel"] = errors(c_c.cpu(), c_h)[1]
    if errs["crops_rel"] > CROP_REF_TOL:
        fail(f"2st reference: crops {errs['crops_rel']:.3g} of their scale "
             f"apart card vs CPU, over {CROP_REF_TOL}")
    for k in hd_c:
        a, b = hd_c[k].cpu(), hd_h[k]
        errs[f"head_{k}"] = (a - b).abs().max().item()
        if not torch.allclose(a, b, **PRED_TOL):
            fail(f"2st reference: head {k} card vs CPU max abs err "
                 f"{errs[f'head_{k}']:.3g}")
    if not (torch.equal(sel_c.cpu(), sel_h) and
            torch.equal(keep_c.cpu(), keep_h)):
        fail("2st reference: predict's rotated NMS differs card vs CPU on "
             "the same candidates")
    valid = det_c["valid"].cpu()
    errs["det_valid_equal"] = bool(torch.equal(valid, det_h["valid"]))
    both = valid & det_h["valid"]
    for k in ("boxes", "scores"):
        a, b = det_c[k].cpu()[both], det_h[k][both]
        errs[f"det_{k}"] = (a - b).abs().max().item() if a.numel() else 0.0
    same = (own_h["indices"] == prop_h["indices"]).float().mean().item()
    n_prop = int(prop_h["valid"].sum())
    say(f"2st reference (fp32, 1 example, card vs CPU; the CPU's stage 1 "
        f"and proposals in {cpu_s:.1f} s): stage 1 err box "
        f"{errs['box_preds']:.2e} cls {errs['cls_preds']:.2e} trunk "
        f"{errs['trunk']:.2e}; on the card's inputs: the standup NMS equal "
        f"({n_prop} valid proposals), crops within {errs['crops_rel']:.2e} "
        f"of their scale, head box {errs['head_box_preds']:.2e} cls "
        f"{errs['head_cls_preds']:.2e}, predict's rotated NMS equal on the "
        f"same candidates ({int(valid.sum())} detections); predict whole on "
        f"the same predictions (decoded on each device: the refined "
        f"proposals' scores tie where their crops are empty, so a box an "
        f"ulp apart can take another's place): valid "
        f"{'equal' if errs['det_valid_equal'] else 'different'}, boxes err "
        f"{errs['det_boxes']:.2e} scores err {errs['det_scores']:.2e}; the "
        f"CPU's own proposals share {100 * same:.1f}% of the card's "
        f"positions")
    return dict(cpu_s=cpu_s, errs=errs, proposals=n_prop,
                own_proposals_same=same, detections=int(valid.sum()))


def run_2st_train(dev, timer, dtimer):
    """The two-stage detector's train step (second_car_fhd.config as stage
    1, bf16, 512 proposals an example, the config's Adam) on the fhd train
    inputs (batch 4 synthetic scans, 16 000 voxels), through
    `make_two_stage_steps`. Returns (the backward kernel's aggregate, the
    launch counts, the report)."""
    report = {}
    cfg = load_pipeline_config(CONFIG)
    mixed = cfg.train_config.enable_mixed_precision
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, mixed,
                                                  build=build_two_stage)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     TRAIN_VOXELS, shuffle_overflow=True)
    batch = train_inputs(cfg, assigner, info, dev, TRAIN_BATCH)
    step = make_two_stage_steps(spec, vspec)[0]
    say(f"2st train: batch {TRAIN_BATCH} synthetic scans, {TRAIN_VOXELS} "
        f"voxels (shuffle_overflow), mixed precision {mixed}, "
        f"{TWO_STAGE_PROPOSALS} proposals an example")

    with recording(RECORDED_2ST_TRAIN) as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"2st train capture: {n}; loss {float(metrics['loss']):.4f}")
    want_n = {"gather_gemm": SPARSE_CONVS,
              "gather_gemm_dgrad": SPARSE_CONVS - 1,
              "sparse_wgrad": SPARSE_CONVS, "roi_align_fwd": 1,
              "roi_align_bwd": 1, "standup_overlap": 1, "nms_suppress": 1}
    if n != want_n:
        fail(f"2st train: recorded {n}, expected {want_n}")
    check_step_calls("2st train", calls, timer, dtimer, timed=False)
    aggs = check_roi_calls(calls["roi_align_fwd"], calls["roi_align_bwd"],
                           timer, dtimer, "2st train")
    report["roi_align_fwd"] = {k: aggs["roi_align_fwd"][k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms")}
    report["standup"] = check_standup_calls(
        calls["standup_overlap"], calls["nms_suppress"], timer, dtimer,
        "2st train")
    del calls

    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one 2st train step: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS,
            "sparse_gather_gemm_dgrad": SPARSE_CONVS - 1,
            "sparse_wgrad": SPARSE_CONVS, "roi_align_fwd": 1,
            "roi_align_bwd": 1, "standup_overlap": 1, "nms_suppress": 1,
            "rotated_iou": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"2st train step launches {counts}, expected {want}")
    params = dict(state.module.named_parameters())
    for name, p in params.items():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"2st {name}: gradient missing or not finite")
    for name in ("second_rpn.reg_tower.convs.0.weight",
                 "second_rpn.conv_box_second.weight",
                 "stage1.middle.subm.0.weight",
                 "stage1.rpn.trunk.convs.0.conv.weight"):
        if not params[name].grad.abs().max() > 0:
            fail(f"2st {name}: gradient all zero")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"2st train metrics not finite: {m}")
    report["metrics"], report["launches"] = m, counts
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the 2st train step synchronised the host {n_syncs} times")
    say("2st train step: no host sync; every gradient finite, the head's, "
        "the sparse middle's and the RPN's nonzero; " +
        ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    check_determinism(state, spec, vspec, batch, "2st", two_stage_loss)
    report["speed"], report["profile"] = timed_steps(
        step, state, spec, vspec, batch, TWO_STAGE_TIMED, "2st train",
        loss_of=two_stage_loss)
    del state
    report["overfit"] = check_overfit(cfg, dev, mixed, step, batch, "2st",
                                      build=build_two_stage)
    torch.backends.cudnn.deterministic = False
    report["reference"] = check_2st_train_reference(dev)
    return aggs["roi_align_bwd"], counts, report


def check_2st_train_reference(dev):
    """One fp64 two-stage train step on one example, card (kernels) against
    CPU (plain versions), from the same seeded weights with the config's
    optimizer. Stage 1 is the PointPillars config's (the sparse kernels
    take no fp64), full width, TWO_STAGE_REF_PROPOSALS proposals drawn
    from the positive anchors and a hundredth of the others: the same
    stage-2 positives on both, and some; the loss within REF64_LOSS_RTOL,
    every gradient and norm statistic within REF64_TOL of its scale, every
    parameter after the step within REF64_TOL of its scale plus
    ADAM_STEP_TOL of the step's lr where its gradient is settled (above
    REF_GRAD_TOL of the tensor's largest) and elsewhere within the most a
    step moves it, lr (2 + wd |p|)."""
    cfg = load_pipeline_config(PP_CONFIG)
    reader = cfg.train_input_reader
    cpu = torch.device("cpu")

    def build(model, device, mixed_precision=False, seed=0):
        return build_two_stage(model, device, mixed_precision, seed,
                               TWO_STAGE_REF_PROPOSALS)
    runs = {}
    for device in (dev, cpu):
        state, spec, info, assigner = new_train_state(
            cfg, device, False, dtype=torch.float64, build=build)
        if device == dev:
            one = {k: v[:1].to(torch.float64) if v.is_floating_point()
                   else v[:1] for k, v in train_inputs(
                       cfg, assigner, info, cpu, 1, PP_POINTS).items()}
            # the proposals' NMS may take the positive anchors and a
            # hundredth of the others: random stage-1 scores rank no
            # positive among 64 proposals, and the stage-2 losses need some
            g = torch.Generator().manual_seed(0)
            one["anchors_mask"] = (one["labels"] > 0) | (torch.rand(
                one["labels"].shape, generator=g) < 0.01)
        grads = record_grads(state)
        vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                         reader.max_number_of_voxels)
        step = make_two_stage_steps(spec, vspec)[0]
        t0 = time.perf_counter()
        state, metrics = step(state, {k: v.to(device)
                                      for k, v in one.items()})
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs[device.type] = dict(
            secs=time.perf_counter() - t0, loss=float(metrics["loss"]),
            pos2=int(metrics["second_num_pos"]),
            grads={k: v.cpu() for k, v in grads[0].items()},
            after={k: v.detach().cpu()
                   for k, v in state.module.state_dict().items()
                   if v.is_floating_point()})
    c, h = runs["cuda"], runs["cpu"]
    errs = {"loss_rel": abs(c["loss"] / h["loss"] - 1)}
    if errs["loss_rel"] > REF64_LOSS_RTOL or c["pos2"] != h["pos2"] or \
            not h["pos2"]:
        fail(f"2st train reference: fp64 loss {c['loss']!r} on the card, "
             f"{h['loss']!r} on the CPU (stage-2 positives {c['pos2']}, "
             f"{h['pos2']})")
    worst = dict(grad=0.0, after=0.0)
    lr = float(state.lr_sched(0))
    wd = cfg.train_config.optimizer.weight_decay
    for name, want in h["grads"].items():
        scale = max(want.abs().max().item(), 1e-30)
        e = (c["grads"][name] - want).abs().max().item() / scale
        worst["grad"] = max(worst["grad"], e)
        if e > REF64_TOL:
            fail(f"2st train reference: fp64 gradient {name} differs card "
                 f"vs CPU by {e:.3g} of its scale")
    for name, want in h["after"].items():
        diff = (c["after"][name] - want).abs()
        e = diff.max().item() / max(want.abs().max().item(), 1e-30)
        g = h["grads"].get(name)
        if g is None:                   # a norm statistic
            worst["after"] = max(worst["after"], e)
            if e > REF64_TOL:
                fail(f"2st train reference: fp64 {name} after the step "
                     f"differs card vs CPU by {e:.3g} of its scale")
            continue
        # Adam's first update is lr g / (|g| + eps): its error is
        # lr eps |dg| / |g|^2, up to ADAM_STEP_TOL of lr for settled
        # elements (above REF_GRAD_TOL of the tensor's largest gradient, as
        # the fhd reference has it) of tensors whose gradients are small
        # (a zero-initialised bias moves by lr alone); elsewhere the most
        # one step can move an element, lr (2 + wd |p|)
        settled = g.abs() > REF_GRAD_TOL * g.abs().max()
        if settled.any():
            worst["after"] = max(worst["after"], diff[settled].max().item() /
                                 max(want.abs().max().item(), 1e-30))
        limit = lr * (2 + wd * want.abs()) + REF_PARAM_ATOL
        tol = REF64_TOL * want.abs().max() + ADAM_STEP_TOL * lr
        if (diff[settled] > tol).any() or (diff > limit).any():
            fail(f"2st train reference: fp64 parameter {name} after the "
                 f"step differs card vs CPU by {e:.3g} of its scale")
    errs.update(worst)
    say(f"2st train reference (PointPillars stage 1, fp64, 1 example, "
        f"{TWO_STAGE_REF_PROPOSALS} proposals, {h['pos2']} stage-2 "
        f"positives, card vs CPU; the CPU's step in {h['secs']:.1f} s): "
        f"loss rel {errs['loss_rel']:.2e}, gradients within "
        f"{worst['grad']:.2e} of their scale, state after the step within "
        f"{worst['after']:.2e}")
    return dict(cpu_s=h["secs"], card_s=c["secs"], errs=errs,
                second_num_pos=h["pos2"])


if __name__ == "__main__":
    main()
