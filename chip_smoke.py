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
   second_car_fhd.config as stage 1, fp32 as JAX's builder makes it on
   every config, 512 proposals an example by
   standup NMS, 14 x 14 rotated crops, the refine head, rotated NMS over
   the refined proposals; random weights from seed 0) through the
   two-stage eval step on the fhd bench input (batch 4, 40 000 voxels):
   every sparse conv and row gather against its plain version, each fp32
   conv also against fp64 (FP32_ERR_RATIO), the
   ROI-align forward call against its plain version (bitwise) and
   timed, split by kernel (the channels-last copy, the crops), beside
   `F.grid_sample` + `F.avg_pool2d`, the standup bitmask bit for bit and
   its NMS keep, timed beside its plain version (no PyTorch call computes
   it: its library time is none), the final NMS pair (`check_nms_pair`);
   launches sparse gather-GEMM 14 (all on the fp32 path), roi_align_fwd
   1, standup_overlap 1, nms_overlap 1, nms_suppress 2; no host sync;
   voxel_overflow and stage_overflow 0; frames/s, peak memory, a synchronised split
   (voxelize, stage 1, proposals, crops, head, predict) and a profile,
   with cuDNN TF32 off and on; one fp32 example card against CPU (stage 1,
   then the second stage on the card's stage 1: proposals equal, crops,
   predictions and detections within tolerance).
15. 2st train: the two-stage train step (`make_two_stage_steps`, fp32, the
   config's Adam) on batch 4 synthetic scans at 16 000 voxels: every sparse
   forward, dX and weight-gradient call against its plain version and
   against fp64 (each at most FP32_ERR_RATIO times the fp32 plain
   version's error); the
   ROI-align forward and backward calls against their plain versions
   (the backward twice, bitwise equal; its counts of in-map samples and
   cell runs equal to the plain mirror's) and timed beside the library
   pair and its autograd, the backward's device time split by kernel; the
   standup bitmask; launches 14 / 13 / 14 (the gather-GEMM's fp32 path 27,
   the weight gradient's fp32 path 14) and
   roi_align_fwd, roi_align_bwd, standup_overlap and nms_suppress once;
   every gradient finite, no host sync, gradients bitwise equal over two
   runs, the loss halved on one batch; steps/s, peak memory, split,
   profile; one fp64 step card against CPU of the two-stage detector on
   the PointPillars config (the sparse kernels take no fp64), one
   example, 64 proposals (REF64_TOL).

16. tmp eval: the temporal detector (`build_temporal_voxelnet`:
   second_car_fhd.config, fp32 as JAX builds it, 512 proposals an example,
   random weights from seed 0) through `make_temporal_steps`' eval step on
   batch 4 pairs (the fhd bench scan of seed 0 as the current frame, a
   scan of seed 1 as the previous one), 40 000 voxels a frame (each
   frame's voxel count printed, no overflow): every sparse conv, row
   gather, ROI-align forward, standup bitmask and NMS pair against its
   plain version as in 2st eval, each fp32 conv against fp64; both frames
   folded into one backbone call (every conv takes 8 examples; the
   gather-GEMM 14 launches a forward, all fp32), roi_align_fwd 1,
   standup_overlap 1, nms_overlap 1, nms_suppress 2; no host sync in the
   eval step nor in `predict_temporal`; pairs/s, peak memory, a split
   (voxelize, backbone, fusion + RPN, proposals, crops, head, predict) and
   a profile, with cuDNN TF32 off and on; `TemporalSequenceVoxelNet` on a
   4-frame sequence against the pair model on its 3 pairs from the same
   state dict; one fp32 pair card against CPU (`check_refine_reference`,
   the crops of the gated map).
17. tmp train: the temporal train step (`make_temporal_steps`, fp32, the
   config's Adam) on batch 4 synthetic pairs (`SyntheticPairDataset`, the
   `Trainer`'s data) at 16 000 voxels a frame: every sparse forward, dX
   and weight-gradient call, the ROI-align forward and backward and the
   standup bitmask against their plain versions (and fp64), launches as
   2st train's with both frames folded; every gradient finite, the
   gate's nonzero; no host sync; bitwise gradients over two runs; the loss
   halved on one batch; steps/s, peak memory, split, profile; one fp32
   step on one pair card against CPU (the loss and the positives gated,
   the gradients printed) and one fp64 step of the PointPillars config's
   temporal detector card against CPU (REF64_TOL).
18-23. fusion eval / train, fusion 2st eval / train, tmpf eval / train:
   the camera-fusion family on second_car_fhd.config, fp32 as JAX builds
   it, random weights from seed 0 (flax's initialisers in training), the
   KITTI camera canvas 384 x 1248 (the scan rendered through
   `synthetic_calib`), through the steps makers' eval and train steps:
   `FusionVoxelNet` (the ResNet-18 FPN, the points' projection into BEV,
   the gates and the fused map; `make_fusion_steps`),
   `FusionTwoStageVoxelNet` (that stage 1, 512 proposals an example, crops
   of the BEV trunk and of the fused map; `make_fusion_two_stage_steps`)
   and `TemporalFusionVoxelNet` (both frames of a pair through one
   backbone call, the gate, the z-slice camera RPN over 4 slices, crops of
   the 128-channel trunk and of the 256-channel z-slice map;
   `make_temporal_fusion_steps`). Eval: batch 4 (pairs for tmpf) of the
   fhd bench scan at 40 000 voxels a frame; every sparse conv and row
   gather against its plain version and fp64, the NMS pair, the standup
   bitmask and each ROI-align call (by channel count: 128 and 128, or 128
   and 256) against its plain version; launches (gather-GEMM 14 on the
   fp32 path, roi_align_fwd 2, standup_overlap 1, nms_overlap 1,
   nms_suppress 2; the one-stage model nms 1 + 1 and no crop); no host
   sync; frames/s (pairs/s), peak memory, a split (voxelize, backbone,
   trunk, fpn, projection, fusion, heads, then proposals, crops, head,
   predict) and a profile (busy share); one fp32 example card against CPU
   (`check_refine_reference` with both crops for the two-stage kinds) and
   an fp64 forward of the PointPillars config's fusion model card against
   CPU (`check_fusion_forward64`). Train: batch 4 synthetic scans (pairs)
   with camera images, 16 000 voxels a frame: every sparse forward, dX and
   weight-gradient call, each ROI-align forward and backward (the
   backward's partials and peak scratch printed) and the standup bitmask
   against their plain versions; launches 14 / 13 / 14 on the fp32 path,
   roi_align_fwd 2 and roi_align_bwd 2 for the two-stage kinds; every
   gradient finite, the FPN's and the gates' nonzero (tmpf: the FPN's
   zero, JAX's stop_gradient); no host sync; bitwise gradients over two
   runs; the loss halved on one batch; steps/s, peak memory, split,
   profile and a train-mode forward split; one fp64 step of the
   PointPillars config's fusion model card against CPU
   (`check_2st_train_reference`, REF64_TOL).
24. tmp trainer: `Trainer(model_type="temporal")` on the card, 2 steps and
   an `evaluate`, on synthetic pairs and on a fake KITTI-tracking tree
   (`data/fake_tracking.py`): the model fp32 on a config that asks for
   mixed precision, finite losses, the /3d AP keys, 14 gather-GEMM
   launches a forward.
25. tracking: `train/run_tracking.py` on the card with the CLI's defaults:
   20 train steps, `evaluate` with the simple and the memory tracker, in
   3-frame windows and with the camera crops (CLEAR-MOT printed); the
   `SequenceTrackNet` forward card against CPU; train steps/s on one
   prepared sequence; `nms_vid` on 512 random detections card against
   CPU.

26. serve: the detection server (`serve.build_server`, port 0, max batch
   8, a 5 ms window) on second_car_fhd.config, fp32 as `InferenceContext`
   builds it (JAX's `build_voxelnet(cfg.model)` on every config), over a
   checkpoint the port's `Trainer` writes in 2 steps, max_points 30 000:
   the kernel calls of a batch-8 forward against their plain versions (and
   fp64; the NMS pair); each of 64 fhd bench scans (seeds 0-63) alone
   through `InferenceContext.inference` as the reference, and its noise
   across batch sizes 1-8; 64 octet-stream requests from 8 client threads,
   each answer held to its cloud's reference (keep sets equal but for as
   many flips as the batch-size sweep showed; boxes and scores within the
   answer's rounding and twice the sweep's difference); a batch larger
   than 1; the launches of the served batches (14 gather-GEMMs and one NMS
   pair a batch, all fp32); requests/s, /stats' batch histogram and
   p50/p90/p99; a JSON request, two malformed ones (400), /healthz.
27. trk-det: `TrackingTrainer(detector_config=second_car_fhd.config,
   detector_dir=<the serve checkpoint>)` on synthetic sequences: one
   sequence's detections (one `inference_batch`, its kernel calls against
   their plain versions) equal to the detector's own output through
   `nms_vid` and carried by the prepared sequence; 3 train steps and an
   evaluation (finite losses and MOTA); 14 gather-GEMMs and one NMS pair
   a detector forward.
28. joint train: `JointTrainer` (`models/joint_track.py`) on
   second_car_fhd.config, fp32, 4-frame synthetic windows, 16 detections a
   frame, 16 000 voxels a frame, Adam: every sparse forward, dX and
   weight-gradient call (and fp64), the ROI-align forward and backward at
   14 x 14 (proposals) and 16 x 16 (tracking crops), the standup bitmask
   and the det↔gt `riou_matrix` call against their plain versions;
   launches 14 / 13 / 14 (fp32, the window's 8 frames folded),
   roi_align_fwd 2, roi_align_bwd 2, standup_overlap 1, nms_suppress 1,
   rotated IoU 1; every gradient finite, the tracking loss's gradient into
   the second stage nonzero; no host sync; bitwise gradients over two
   runs; the loss halved on one window; steps/s, split, peak memory; the
   `detector_dir` graft of a temporal checkpoint.
29-33. resnet eval / train, large eval / train, vfe1 eval: the other
   middles and encoders, on second_car_fhd.config patched by the port's
   `apply_config_patches` (`run_middle_eval`, `run_middle_train`):
   SpMiddleResNetFHD (bf16 as build_voxelnet gives it: per forward 4 bf16 and
   4 fp32 submanifold and 4 bf16 strided gather-GEMM launches),
   SpMiddleFHDLarge (fp32, as JAX builds the stacks: 128-wide stages) and
   VoxelFeatureExtractor [32, 128] into SpMiddleFHD (the middle's config
   width left at 4; the bf16 first conv at 128 input channels; the
   encoder's norm statistics calibrated on the batch). Eval: fhd eval's
   input; every sparse conv against its plain version (and fp64 for fp32
   calls) and timed, the calls over 64 channels in a set of their own; the
   row gathers and the NMS pair against their plain versions; launches and
   gather-GEMM paths; predict without a host sync; frames/s, peak memory,
   the device time by kernel. Train: fhd train's batch; every forward, dX
   and weight-gradient call against its plain version (the calls over 64
   channels timed, fp32 calls bounded as 3xTF32; every fp32 call against
   fp64 too: resnet train's 4 forward, 4 dX and 4 weight-gradient calls
   on the fma paths, all of large train's), each conv's
   backward against autograd of the plain gather-GEMM; launches 12 / 11 /
   12 (resnet) or 14 / 13 / 14 (large) on their paths; every middle
   parameter's gradient finite and nonzero; no host sync; steps/s and peak
   memory.
34. soft-nms (`run_soft_nms`): `ops/nms.py` `soft_nms` on the fhd eval
   forward's NMS candidates (its recorded `nms` call: batch 4, 1000
   decoded boxes an example, post 100), rotated gaussian (sigma 0.5) and
   linear (threshold 0.3), and standup gaussian on their standup
   envelopes: launches counted (the pair-list decay kernel and the pair
   IoU once a rotated call, the standup decay kernel once in the standup
   call, the row gather once a call, for all rows), the standup call's
   peak allocation below a [B, K, K] matrix, each decay call's kernel
   against its plain version (picks exact, NaN where NaN, scores within
   SOFT_RTOL), the standup kernel on rows with NaN and +inf scores and
   NaN boxes, the pair IoU against its plain version, each call card
   against CPU (picks and keep exact, scores within SOFT_REF_RTOL), the
   pair cap's use; each decay call timed (events, device, plain, bound,
   the device time at m = 1 and so a later step's), the whole gaussian
   rotated and standup soft_nms timed; rows of 4096, 8192 and 16384
   crowded boxes (past 4096 with a NaN and a +inf score, and a NaN box:
   the kernels' wide routes), 100 steps: the pair kernel on their pair
   lists at 8192 pairs (and, at 4096, 32768: past shared memory) and the
   standup kernel on their standup envelopes, each against plain and
   timed.
35. dp (`run_dp`): an NCCL process group of one rank (the card is one):
   the fhd `Trainer`'s data-parallel train steps (DDP; at one rank the
   norms' statistics are the rank's own) against a plain `Trainer`'s on
   the same batches (the same launches; the state bit for bit, else gated
   at DP_PARAM_TOL of scale), steps/s of both and of the plain step with
   the norms' statistics all-reduced over the group, in turns (what DDP
   and what the norms' all-reduces cost a step); `make_dp_eval_step`
   on the fhd eval input (launches counted; its statistics equal a host
   count of its detections and the single-device eval's); the
   row-sharded RPN and the sequence-parallel forward (4 frames) against
   their unsharded forwards.
36. vfe256 eval and vfe256 train (`run_middle_eval` / `run_middle_train`
   on second_car_fhd.config with `VFE256_PATCHES`:
   `VoxelFeatureExtractor` [32, 256] into SpMiddleFHD, bf16): as vfe1
   eval (norms calibrated) and as resnet train; the first conv 256 -> 16,
   its dX 16 -> 256 (the encoder learns, so the first conv's input takes
   a gradient: 14 dX calls a step) and its weight gradient [27, 256, 16]
   timed apart; launches 14 mma (eval), 14 / 14 / 14 (paths mma 28,
   wgrad 14).
37. wide convs (`run_wide_convs`): the fhd eval forward's four stage
   rulebooks with random features and weights of 256 -> 256 and 200 ->
   136 channels, in bf16 and fp32: every forward, dX (the transposed
   rulebook, the weights [K, D, C]) and weight-gradient call against its
   plain version (CONV_TOL, GRAD_KERNEL_TOL; fp32 also against fp64 at
   FP32_ERR_RATIO) and timed (events, device, bound, library); one bf16
   5 x 5 x 5 conv (K = 125, 64 -> 64) on stage 0's sites. Compare-only
   launches: no path.

38. nms large k (`run_nms_large_k`): rotated and standup NMS
   (`nms_sorted`, threshold 0.01, the 8192-pair cap binding) on crowded
   synthetic boxes at K = 4097, 8192 and 16384 (batch 4) and 46340 (batch
   1, JAX's int32 pair-index bound), where the kernels take their wide
   routes: `nms_overlap` and `nms_suppress` against their plain versions
   (`check_nms_pair`: pair counts and keep exact, bits but at pairs
   within RIOU_TOL of the threshold), `standup_overlap` bit for bit and
   its keep, the standup bitmask's suppression, each timed (events,
   device) with its bound; the plain versions build their pair matrices a
   block of rows at a time.
39. k8192 eval (`run_middle_eval`, `K8192_PATCHES`): the fhd eval
   forward at `nms_pre_max_size` 8192 (batch 4, the fhd scene), its
   NMS through the wide routes: every conv and gather against plain, the
   NMS pair against plain and the whole `nms` call card against CPU
   (indices and keep exact), launches, predict without a host sync,
   frames/s.
40. vfe1 train (`run_middle_train`, `VFE1_PATCHES`):
   `VoxelFeatureExtractor` [32, 128] into SpMiddleFHD's bf16 train step:
   as vfe256 train; its first conv's weight gradient [27, 128, 16] (the
   tiled bf16 path up to 128 channels) printed as a share of the scale
   and of its bound in `check_conv_backward`; launches 14 / 14 / 14
   (paths mma 28, wgrad 14).
41. the other middles, encoders and RPN options (`run_config_evals`,
   `CONFIG_EVALS`): SpMiddleFHDLite, SparseMiddleExtractor,
   SpMiddleD4HD, SpResNetD4HD, SpMiddleD4HDLite, SpMiddleD8HD,
   SpMiddle2K, SpMiddleFHDV2, VoxelFeatureExtractorV2 and SimpleVoxel
   into SpMiddleFHD, the group-normed RPN and a stack whose bottleneck
   feeds 256 channels, each on second_car_fhd.config patched as JAX's
   builder needs it, batch 4, the fhd scene: every sparse conv against
   its plain version (fp32 ones also against fp64), the row gathers
   exact, the NMS pair against plain, launches and gather-GEMM paths,
   predict without a host sync, frames/s (`run_middle_eval` untimed by
   call).
42. fhdv2 train (`run_middle_train`, `FHDV2_PATCHES`): SpMiddleFHDV2's
   fp32 train step, the model path of the sparse max pool's gradient:
   every forward, dX and weight-gradient call against plain and fp64,
   each conv's backward against autograd of the plain gather-GEMM,
   launches 14 / 13 / 14 (fma 27, wgrad fma 14), steps/s.

The line before the last is {"kernels": [...]}: per kernel its launches
summed over the paths of `PATHS` (fhd eval, fhd train, pp eval, pp
train, mc eval, mc train, kitti, fhd + IoU train, 2st eval, 2st train, tmp
eval, tmp train, fusion eval, fusion train, fusion 2st eval, fusion 2st
train, tmpf eval, tmpf train, serve, trk det, joint train, resnet eval,
resnet train, large eval, large train, vfe1 eval, soft nms, dp train, dp
eval, vfe256 eval, vfe256 train, vfe1 train, k8192 eval, the twelve
CONFIG_EVALS phases and fhdv2 train) and by path,
the numbers of the fhd calls (of the IoU-branch step for d3_iou, of the
two-stage phases for the ROI-align and standup kernels), and those of the
PointPillars and multi-class calls under "pp_eval" / "pp_train" /
"mc_eval" (the mc eval's fp32 convs, bounded as 3xTF32 on the tensor
cores, with the bound at the CUDA cores' fp32 rate as "bound_cores_ms"),
the 256-channel ROI-align calls of the tmpf phases under
"tmpf_eval_c256" / "tmpf_train_c256", the joint step's `riou_matrix`
call under "joint_train" and its 16 x 16 ROI-align calls under
"joint_train_s16", the resnet eval's convs under "resnet_eval" and the
sparse-conv calls over 64 channels under "large_eval_c128",
"large_train_c128" (forward, dX, weight gradient; fp32, bounded as 3xTF32
with "bound_cores_ms" beside), "vfe1_eval_c128", "vfe1_train_c128",
"vfe256_eval_c256" and "vfe256_train_c256", the wide convs' calls under
"wide_c256" (bf16), "wide_c256_fp32" and "wide_k125" (forward, dX,
weight gradient), the NMS kernels past 4096 candidates under
"nms_k4097", "nms_k8192", "nms_k16384", "nms_k46340" (rotated_iou,
nms_suppress, standup_overlap) and "nms_standup_k<K>" (the suppression
of the standup bitmask), the k8192 eval's NMS pair under "k8192_eval",
and the soft-NMS decays: the pair kernel's linear fhd call under
"soft_nms_linear" and its long rows under "soft_nms_k<K>_p<P>", the
standup kernel's under "soft_nms_standup_k<K>" (the gaussian fhd call's
numbers are the pair and standup kernels' lines' own).
The last line is {"ok": true, "device": {...}}. With
--out, the per-call detail is written to that JSON file as well.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from second_tpu_torch.config import load_pipeline_config
from second_tpu_torch.core import box_np
from second_tpu_torch.data import ExamplePrep, PrepConfig, lidar_scan_scene
from second_tpu_torch.data.synthetic import (SyntheticDataset,
                                             SyntheticPairDataset,
                                             render_synthetic_image,
                                             synthetic_calib)
from second_tpu_torch.models import (build_fusion_two_stage_voxelnet,
                                     build_fusion_voxelnet,
                                     build_temporal_fusion_voxelnet,
                                     build_temporal_voxelnet,
                                     build_two_stage_voxelnet,
                                     build_voxelnet, calibrate_norms_,
                                     compute_loss, compute_temporal_loss,
                                     compute_two_stage_loss, detect,
                                     init_train_weights_, predict,
                                     predict_temporal, predict_two_stage)
from second_tpu_torch.ops import cuda as kernels
from second_tpu_torch.ops import nms as nms_ops
from second_tpu_torch.ops import sparse_conv
from second_tpu_torch.ops.anchors_mask import anchors_mask_from_coords
from second_tpu_torch.ops.box_ops import bev_boxes
from second_tpu_torch.ops.cuda import gather, riou, roi_align, subm
from second_tpu_torch.ops.rotated_iou import (_clip_halfplane, _next_vertex,
                                              _signed_area, rbbox_to_corners,
                                              standup_iou_matrix)
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import (TrainState, make_eval_step,
                                          make_train_step,
                                          voxelize_points)
from second_tpu_torch.train.steps_multistage import (
    make_fusion_steps, make_fusion_two_stage_steps,
    make_temporal_fusion_steps, make_temporal_steps, make_two_stage_steps,
    voxelize_pair)

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
                    "standup_overlap": 0, "soft_nms_standup": 0,
                    "soft_nms_pairs": 0}
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
         "mc_train", "kitti", "fhd_iou_train", "2st_eval", "2st_train",
         "tmp_eval", "tmp_train", "fusion_eval", "fusion_train",
         "fusion_2st_eval", "fusion_2st_train", "tmpf_eval", "tmpf_train",
         "serve", "trk_det", "joint_train", "resnet_eval", "resnet_train",
         "large_eval", "large_train", "vfe1_eval", "soft_nms", "dp_train",
         "dp_eval", "vfe256_eval", "vfe256_train", "vfe1_train",
         "k8192_eval", "lite_eval", "extractor_eval", "d4hd_eval",
         "resd4hd_eval", "d4hdlite_eval", "d8hd_eval", "2k_eval",
         "fhdv2_eval", "fhdv2_train", "vfev2_eval", "simplev_eval",
         "groupnorm_eval", "bottleneck256_eval")
# the two-stage detector on second_car_fhd.config: proposals an example,
# the timed forwards and steps of its phases; its fp64 reference step runs
# the PointPillars config's two-stage detector (the sparse kernels take no
# fp64) on one example with fewer proposals
TWO_STAGE_PROPOSALS = 512
TWO_STAGE_TIMED = 8
TWO_STAGE_REF_PROPOSALS = 64
# its parameters after Adam's first step: see check_2st_train_reference
ADAM_STEP_TOL = 1e-6
# the temporal detector on second_car_fhd.config: the timed forwards and
# steps of its phases, the frames of its sequence check; the tracking
# phase's train steps
TEMPORAL_TIMED = 8
TEMPORAL_SEQ_FRAMES = 4
TRACK_STEPS = 20

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
# soft-NMS's decay steps: JAX runs them as a `lax.scan` (no Pallas kernel);
# no config reaches soft-NMS, the soft-nms phase drives it
SOFT_NMS_KERNELS = [
    dict(name="soft_nms_standup", module=riou, fn="soft_nms_decay_standup",
         counter="launches_soft_standup",
         source="second_tpu_torch/csrc/riou.cu",
         replaces="second_tpu/ops/nms.py:230"),
    dict(name="soft_nms_pairs", module=riou, fn="soft_nms_decay_pairs",
         counter="launches_soft_pairs",
         source="second_tpu_torch/csrc/riou.cu",
         replaces="second_tpu/ops/nms.py:230"),
]
ALL_KERNELS = KERNELS + TRAIN_KERNELS + IOU_KERNELS + TWO_STAGE_KERNELS + \
    SOFT_NMS_KERNELS
# the ROI-align kernels against their plain versions: the forward in the
# plain version's order of operations (-fmad=false), bitwise; the
# backward's sums in another order, within ROI_BWD_TOL of each gradient's
# scale (a bf16 trunk's plain backward runs on its fp32 copy: the kernel
# sums in fp32)
ROI_BWD_TOL = 1e-5
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
# fp32 operations of the standup IoU thresholded, counted from the data
# as the function needs them, whatever kernel does it: of each valid pair
# of the upper triangle, whether its boxes meet (4 comparisons of their
# sides, whose ands fold into the compares, and the bit set); of each pair
# whose boxes meet, beyond that, the IoU (2 max, 2 min, 2 differences, the
# product and its test, the union's sum and difference, the quotient, the
# threshold comparison); and of each box, its area (2 differences, 1
# product). A pair whose boxes do not meet has IoU 0
STANDUP_TEST_OPS = 5
STANDUP_MEET_OPS = 12
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
# a device time or kernel count that the profiler did not trace
NOT_TRACED = float("nan")


def errors(got, want):
    """(max abs error, max abs error over the largest |reference|)."""
    if not want.numel():
        return 0.0, 0.0
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def fail(msg):
    # on both streams: a caller that keeps only the end of one still sees
    # which check failed
    print(f"FAIL {msg}", flush=True)
    print(f"chip_smoke.py: FAIL {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


# seconds of each phase timed by `phase_time`, in the order they ran
PHASE_S = {}


@contextmanager
def phase_time(name):
    """Times the block as the phase `name`: prints its seconds, keeps them
    in PHASE_S."""
    t0 = time.perf_counter()
    yield
    PHASE_S[name] = time.perf_counter() - t0
    say(f"phase {name}: {PHASE_S[name]:.1f} s")


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
    host time, no gaps. Where the profiler gives no whole trace, the times
    and kernel counts are NaN ("not traced"): they are reported, and no
    check of the run rests on them."""

    # leading flushes a session: a trace has missed up to its first 5
    # kernels, in every retry, late in a run of all the phases
    PAD = 16
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
                say(f"device timer: the flush traced as {sorted(names)}; "
                    f"device times not traced")
                self.kernels = [NOT_TRACED] * len(fns)
                return [NOT_TRACED] * len(fns)
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
            say(f"device timer: {len(runs)} flushes for {len(fns)} x "
                f"{reps} runs after {self.PAD} leading ones, "
                f"{self.RETRIES + 1} sessions; device times not traced")
            self.kernels = [NOT_TRACED] * len(fns)
            return [NOT_TRACED] * len(fns)
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


def split_line(split):
    """The device time a call and its kernels, from `device_split`."""
    if not split:
        return "device time not traced"
    return (f"device {sum(ms for ms, _ in split.values()):.4f} ms a call, "
            f"by kernel: " + "; ".join(f"{k[:60]} {v:.4f} x{n:g}"
                                       for k, (v, n) in split.items()))


def json_safe(x):
    """x with every NaN float (a time not traced) as None, so that the
    JSON it is written as is strict."""
    if isinstance(x, float) and x != x:
        return None
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    return x


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


def fp64_gate(args, got, tag, plain_fn=subm.gather_gemm_plain):
    """An fp32 sparse conv's kernel output against the plain version
    (`plain_fn`: the gather-GEMM's, or the weight gradient's) in fp64 on
    the same inputs: its relative error at most FP32_ERR_RATIO times the
    fp32 plain version's own. Returns both errors."""
    want = plain_fn(*[a.double() if a.is_floating_point() else a
                      for a in args])
    plain = plain_fn(*args)
    kernel_err = errors(got.double(), want)[1]
    plain_err = errors(plain.double(), want)[1]
    if kernel_err > FP32_ERR_RATIO * plain_err:
        fail(f"{tag}: {kernel_err:.3g} of the scale from the fp64 plain "
             f"version, over {FP32_ERR_RATIO} times the fp32 plain "
             f"version's {plain_err:.3g}")
    return dict(fp64_rel_err=kernel_err, plain_fp64_rel_err=plain_err)


def as_3xtf32(ops_cores_s):
    """The seconds that fp32 operations taking `ops_cores_s` at the CUDA
    cores' fp32 rate take as 3xTF32 on the tensor cores: three TF32
    products an operation at the TF32 tensor-core rate, the least time the
    card needs for products of fp32 accuracy."""
    return 3 * ops_cores_s * PEAK_OPS_PER_S[torch.float32] / \
        PEAK_TF32_OPS_PER_S


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
                    os_ = as_3xtf32(os_)
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


def check_nms_pair(calls, timer, dtimer, what="nms", reps=(20, 5)):
    """The one recorded `nms_overlap` call and the one `nms_suppress` call
    of a forward against their plain versions on the same inputs: pair
    counts exact, bits exact but at pairs within RIOU_TOL of the threshold,
    keep exact (on the kernel's bitmask and along the all-plain chain);
    timed by events (`reps`: the kernels', the plain versions') and by the
    device timer, with their bounds. Returns (overlap aggregate,
    suppression aggregate, detail)."""
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
                                                max_pairs), reps[0]),
              device_ms=dev_ms[0],
              plain_ms=timer(lambda: riou.nms_overlap_plain(
                  cand, valid, thr, max_pairs), reps[1]),
              library_ms=None, library_device_ms=None, err=0.0)
    sup.update(ms=timer(lambda: riou.nms_suppress(got, valid), reps[0]),
               device_ms=dev_ms[1],
               plain_ms=timer(lambda: riou.nms_suppress_plain(got, valid),
                              reps[1]),
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
    tmp_counts, report["tmp_eval"] = run_tmp_eval(dev, timer, dtimer)
    tmp_train_counts, report["tmp_train"] = run_tmp_train(dev, timer,
                                                          dtimer)
    fusion_counts, roi_256 = {}, {}
    for kind in FUSION_KINDS:
        for phase, fn in (("eval", run_fusion_eval),
                          ("train", run_fusion_train)):
            key = f"{kind}_{phase}"
            fusion_counts[key], report[key], roi = fn(dev, timer, dtimer,
                                                      kind)
            if 256 in roi:
                roi_256[key] = {k: v for k, v in roi[256].items()
                                if v["ms"]}
    report["tmp_trainer_launches"], report["tmp_trainer"] = \
        run_tmp_trainer(dev)
    report["tracking"] = run_tracking_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        serve_counts, serve_dir, report["serve"] = run_serve(
            dev, timer, dtimer, tmp)
        trk_det_counts, report["trk_det"] = run_trk_det(
            dev, timer, dtimer, serve_dir, tmp)
        joint_counts, joint_riou, joint_roi16, report["joint_train"] = \
            run_joint_train(dev, timer, dtimer, tmp)
    # the other middles and encoders: SpMiddleResNetFHD in bf16 (4 bf16 +
    # 4 fp32 submanifold and 4 bf16 strided convs a forward),
    # SpMiddleFHDLarge in fp32 (its 128-wide stages), and
    # VoxelFeatureExtractor's 128 channels into SpMiddleFHD's bf16 first conv
    resnet_agg, _, resnet_counts, report["resnet_eval"] = run_middle_eval(
        dev, timer, dtimer, "resnet eval", RESNET_PATCHES, RESNET_CONVS,
        {"mma": 8, "fma": 4})
    _, resnet_train_counts, report["resnet_train"] = run_middle_train(
        dev, timer, dtimer, "resnet train", RESNET_PATCHES, RESNET_CONVS,
        {"mma": 15, "fma": 8, "wgrad_mma": 8, "wgrad_fma": 4}, fp64=True)
    _, large_wide, large_counts, report["large_eval"] = run_middle_eval(
        dev, timer, dtimer, "large eval", LARGE_PATCHES, SPARSE_CONVS,
        {"mma": 0, "fma": SPARSE_CONVS})
    large_train_wide, large_train_counts, report["large_train"] = \
        run_middle_train(dev, timer, dtimer, "large train", LARGE_PATCHES,
                         SPARSE_CONVS,
                         {"mma": 0, "fma": 2 * SPARSE_CONVS - 1,
                          "wgrad_mma": 0, "wgrad_fma": SPARSE_CONVS},
                         fp64=True)
    _, vfe1_wide, vfe1_counts, report["vfe1_eval"] = run_middle_eval(
        dev, timer, dtimer, "vfe1 eval", VFE1_PATCHES, SPARSE_CONVS,
        {"mma": SPARSE_CONVS, "fma": 0}, calibrate=True)
    # soft-NMS on the fhd eval's decoded candidates, and multi-device at
    # world size 1 (one card): an NCCL group, the Trainer's DP steps
    with phase_time("soft-nms"):
        soft_aggs, soft_others, soft_counts, report["soft_nms"] = \
            run_soft_nms(dev, timer, dtimer, nms_call)
    aggs.update(soft_aggs)
    with tempfile.TemporaryDirectory() as tmp:
        dp_train_counts, dp_eval_counts, report["dp"] = run_dp(dev,
                                                               Path(tmp))
    # convs past 128 channels: VoxelFeatureExtractor's 256 into
    # SpMiddleFHD's first conv, eval and a train step (the encoder learns:
    # a dX for every conv), and the wide convs on the fhd stage rulebooks
    _, vfe256_wide, vfe256_counts, report["vfe256_eval"] = run_middle_eval(
        dev, timer, dtimer, "vfe256 eval", VFE256_PATCHES, SPARSE_CONVS,
        {"mma": SPARSE_CONVS, "fma": 0}, calibrate=True)
    vfe256_train_wide, vfe256_train_counts, report["vfe256_train"] = \
        run_middle_train(dev, timer, dtimer, "vfe256 train", VFE256_PATCHES,
                         SPARSE_CONVS,
                         {"mma": 2 * SPARSE_CONVS, "fma": 0,
                          "wgrad_mma": SPARSE_CONVS, "wgrad_fma": 0},
                         n_dgrad=SPARSE_CONVS)
    wide_aggs, report["wide_convs"] = run_wide_convs(dev, timer, dtimer)
    # NMS past 4096 candidates an example (the kernels' wide routes): on
    # crowded boxes up to JAX's bound, and the fhd eval forward at
    # nms_pre_max_size 8192, its NMS card against CPU
    with phase_time("nms large k"):
        nms_large_aggs, report["nms_large_k"] = run_nms_large_k(dev, timer,
                                                                dtimer)
    with phase_time("k8192 eval"):
        _, _, k8192_counts, report["k8192_eval"] = run_middle_eval(
            dev, timer, dtimer, "k8192 eval", K8192_PATCHES, SPARSE_CONVS,
            {"mma": SPARSE_CONVS, "fma": 0}, timed=False, nms_cpu=True)
    # VoxelFeatureExtractor [32, 128]'s train step: its first conv's
    # weight gradient [27, 128, 16], the tiled bf16 path up to 128 channels
    with phase_time("vfe1 train"):
        vfe1_train_wide, vfe1_train_counts, report["vfe1_train"] = \
            run_middle_train(dev, timer, dtimer, "vfe1 train", VFE1_PATCHES,
                             SPARSE_CONVS,
                             {"mma": 2 * SPARSE_CONVS, "fma": 0,
                              "wgrad_mma": SPARSE_CONVS, "wgrad_fma": 0},
                             n_dgrad=SPARSE_CONVS)
    # the other middles, encoders and RPN options, and SpMiddleFHDV2's
    # train step (the sparse max pool's gradient)
    config_counts, config_reports = run_config_evals(dev, timer, dtimer)
    report.update(config_reports)
    with phase_time("fhdv2 train"):
        _, fhdv2_train_counts, report["fhdv2_train"] = run_middle_train(
            dev, timer, dtimer, "fhdv2 train", FHDV2_PATCHES, 14,
            {"mma": 0, "fma": 27, "wgrad_mma": 0, "wgrad_fma": 14},
            fp64=True)
    report["phase_s"] = dict(PHASE_S)
    say(f"phases timed: {sum(PHASE_S.values()):.1f} s in all ("
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_S.items()) + ")")
    by_path = dict(zip(PATHS, (counts, train_counts, pp_eval_counts,
                               pp_train_counts, mc_eval_counts,
                               mc_train_counts, kitti_counts, iou_counts,
                               two_counts, two_train_counts, tmp_counts,
                               tmp_train_counts,
                               *(fusion_counts[f"{k}_{p}"]
                                 for k in FUSION_KINDS
                                 for p in ("eval", "train")),
                               serve_counts, trk_det_counts, joint_counts,
                               resnet_counts, resnet_train_counts,
                               large_counts, large_train_counts,
                               vfe1_counts, soft_counts, dp_train_counts,
                               dp_eval_counts, vfe256_counts,
                               vfe256_train_counts, vfe1_train_counts,
                               k8192_counts,
                               *(config_counts[w.replace(" ", "_")]
                                 for w, *_ in CONFIG_EVALS[:8]),
                               fhdv2_train_counts,
                               *(config_counts[w.replace(" ", "_")]
                                 for w, *_ in CONFIG_EVALS[8:]))))
    if len(by_path) != len(PATHS):
        fail(f"{len(by_path)} paths counted, {len(PATHS)} named")
    # the 256-channel ROI-align calls of the temporal-fusion phases, under
    # "tmpf_eval_c256" / "tmpf_train_c256"; the joint step's riou_matrix
    # call under "joint_train", its 16 x 16 tracking crops under
    # "joint_train_s16"
    path_aggs = {"pp_eval": pp_eval_aggs, "pp_train": pp_train_aggs,
                 "mc_eval": mc_eval_aggs,
                 **{f"{k}_c256": v for k, v in roi_256.items()},
                 "joint_train": {"rotated_iou": joint_riou},
                 "joint_train_s16": joint_roi16,
                 "resnet_eval": {"sparse_gather_gemm": resnet_agg},
                 "large_eval_c128": {"sparse_gather_gemm": large_wide},
                 "large_train_c128": large_train_wide,
                 "vfe1_eval_c128": {"sparse_gather_gemm": vfe1_wide},
                 "vfe256_eval_c256": {"sparse_gather_gemm": vfe256_wide},
                 "vfe256_train_c256": vfe256_train_wide,
                 "vfe1_train_c128": vfe1_train_wide,
                 "k8192_eval": report["k8192_eval"]["nms_kernels"],
                 **nms_large_aggs,
                 **wide_aggs,
                 **soft_others}

    def numbers(a):
        out = dict(max_abs_err=a["err"], ms=a["ms"], plain_ms=a["plain_ms"],
                   bound_ms=1e3 * max(a["bytes_s"], a["ops_s"]),
                   bound_by="bytes" if a["bytes_s"] >= a["ops_s"]
                   else "operations",
                   library_ms=a["library_ms"], device_ms=a["device_ms"],
                   library_device_ms=a["library_device_ms"])
        if "step_device_us" in a:
            out["step_device_us"] = a["step_device_us"]
        if a.get("ops_cores_s"):
            out["bound_cores_ms"] = 1e3 * max(a["bytes_s"], a["ops_cores_s"])
            if "fp64_ratio" in a:
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
        out.write_text(json.dumps(json_safe(report), indent=1, default=str))
    say(f"card: {card}")
    say(json.dumps({"kernels": json_safe(lines)}))
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
    if not spans:
        say(f"profile: no device kernel traced in the {what}; busy share "
            f"not traced (profiled wall {wall * 1e3:.2f} ms)")
        return dict(device_busy_ms=None, profiled_wall_ms=wall * 1e3,
                    busy_share_of_median=None, kernels_launched=0,
                    top_ms={})
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
    """The config's model (made by `build`: the one-stage builder, with
    mixed precision `mixed`, or the two-stage one, fp32 on every config as
    in JAX, with `mixed` None) on `dev` with flax's initialisers drawn from
    `seed` (a CPU generator: the same weights on every device), in `dtype`
    where one is given (fp64 for a reference run), and the config's
    optimizer, at a constant `lr` where one is given."""
    precision = {} if mixed is None else {"mixed_precision": mixed}
    net, spec, info, assigner, _ = build(cfg.model, device=dev, seed=seed,
                                         **precision)
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
        # a parameter no gradient reaches (the temporal-fusion FPN's) gets
        # the zeros the optimizer fills in
        grads.append({n: torch.zeros_like(p) if p.grad is None
                      else p.grad.detach().clone()
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
        if args[0].dtype == torch.float32:
            row["bound_cores_ms"] = 1e3 * max(bs, os_)
            agg["ops_cores_s"] = agg.get("ops_cores_s", 0.0) + os_
            os_ = as_3xtf32(os_)
        row.update(ms=timer(lambda: kernel(*args), 10),
                   plain_ms=timer(lambda: plain(*args), 3),
                   library_ms=timer(lambda: library(*args), 3),
                   bound_ms=1e3 * max(bs, os_),
                   bound_by="bytes" if bs >= os_ else "operations")
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
            f"(device {ld:.4f})  bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})" +
            (f"  bound at the CUDA cores' fp32 rate "
             f"{row['bound_cores_ms']:.4f} ms" if "bound_cores_ms" in row
             else ""))
    say(f"{name}: {len(calls)} calls, {agg['found']} found taps, "
        f"{agg['device_kernels']:g} device kernels; kernel {agg['ms']:.4f} "
        f"ms (device {agg['device_ms']:.4f})  plain {agg['plain_ms']:.4f} ms  "
        f"library "
        f"{agg['library_ms']:.4f} ms (device "
        f"{agg['library_device_ms']:.4f})  bound "
        f"{1e3 * max(agg['bytes_s'], agg['ops_s']):.4f} ms" +
        (f"  bound at the CUDA cores' fp32 rate "
         f"{1e3 * max(agg['bytes_s'], agg['ops_cores_s']):.4f} ms"
         if "ops_cores_s" in agg else ""))
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


def check_conv_backward(fwd_calls, wgrad_calls, detail=None):
    """Each conv of the step once more: its forward arguments and the
    gradient its backward received, through `gather_gemm` (the kernels'
    backward) and through autograd of `gather_gemm_plain` in fp64 (an fp32
    yardstick is itself off by more than a bf16 unit of an entry where a
    weight gradient's sum cancels: 0.057 at a scale of 18.7 on the vfe1
    step's [27, 128, 16] call). The input
    gradient where the step computed one (every conv but the first), and
    the weight gradient; on the bf16 path the kernels' results are rounded
    to bf16 once, so within one bf16 unit (BF16_UNIT). With `detail`, a
    list, each conv's widths and, for dX and dW, the largest error over
    the tensor's largest entry and over the bound at that entry (the
    margin: at most 1 passes). Returns the largest error over the convs,
    relative to each tensor's largest entry."""
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
        # version on fp64 copies of the values the kernels use (the features
        # and the weights rounded to the feature dtype), so its sums are
        # fp64 throughout: autograd through bf16 tensors would round each
        # tap's share and add them in bf16
        for fn, dtype, wdtype, gdtype in (
                (subm.gather_gemm, f.dtype, w.dtype, torch.float32),
                (subm.gather_gemm_plain, torch.float64, torch.float64,
                 torch.float64)):
            with torch.enable_grad():
                x = f.detach().to(dtype).requires_grad_(i > 0)
                ww = w.detach().to(f.dtype).to(wdtype).requires_grad_(True)
                (fn(x, tap_idx, found, ww) * g.to(gdtype)).sum().backward()
            grads.append((x.grad, ww.grad))
        torch.cuda.synchronize()
        row = dict(conv=i, K=tap_idx.shape[1], C=f.shape[2], D=w.shape[2],
                   dtype=str(f.dtype))
        for j, (got, want) in enumerate(zip(*grads)):
            if want is None:
                continue
            got, want = got.float(), want.float()
            scale = want.abs().max().item()
            if f.dtype == torch.bfloat16:
                bound = BF16_UNIT * torch.maximum(got.abs(), want.abs()) + \
                    1e-6 * scale
            else:
                bound = GRAD_KERNEL_TOL * (want.abs() + scale)
            margin = ((got - want).abs() / bound.clamp(min=1e-30)).max()
            ok = bool(margin <= 1)
            err = (got - want).abs().max().item()
            worst = max(worst, err / max(scale, 1e-30))
            name = ("dX", "dW")[j]
            row[f"{name}_rel"] = err / max(scale, 1e-30)
            row[f"{name}_margin"] = margin.item()
            if not ok:
                fail(f"conv {i}: {name} differs from autograd of the plain "
                     f"gather-GEMM, max abs err {err:.3g} at scale "
                     f"{scale:.3g}, {margin.item():.3g} times its bound")
        if detail is not None:
            detail.append(row)
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


def grads_of(state, spec, vspec, batch, loss_of=one_stage_loss,
             voxelize=voxelize_points):
    """One forward and backward in train mode from the state as it is; the
    parameters' gradients, cloned (no optimizer step)."""
    net = state.module
    with torch.no_grad():
        vox = voxelize(vspec, batch, state.device)[0]
    net.train()
    with torch.enable_grad():
        loss = loss_of(spec, net, vox, batch)["loss"]
        state.optimizer.zero_grad()
        loss.backward()
    # a parameter no gradient reaches (the temporal-fusion FPN's) has none
    return [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
            for p in net.parameters()]


def timed_split(state, spec, vspec, batch, loss_of=one_stage_loss,
                voxelize=voxelize_points):
    """One train step cut at its stage boundaries, each synchronised: ms of
    voxelize, forward + loss, backward, optimizer."""
    net, dev = state.module, state.device
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        vox = voxelize(vspec, batch, dev)[0]
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
    # one launch a call: the partials are summed in the same launch (where
    # the profiler traced the calls)
    traced = aggs["sparse_wgrad"]["device_kernels"] == \
        aggs["sparse_wgrad"]["device_kernels"]
    if traced and aggs["sparse_wgrad"]["device_kernels"] != SPARSE_CONVS:
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
                loss_of=one_stage_loss, voxelize=voxelize_points):
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
    split = timed_split(state, spec, vspec, batch, loss_of, voxelize)
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
                      loss_of=one_stage_loss, voxelize=voxelize_points):
    """Two backward passes from the same state on the same batch give
    bitwise-equal gradients (cuDNN set to deterministic algorithms)."""
    g1 = grads_of(state, spec, vspec, batch, loss_of, voxelize)
    g2 = grads_of(state, spec, vspec, batch, loss_of, voxelize)
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


# the fp32 sparse-conv calls held against fp64 (`fp64_gate`): the
# gather-GEMM's forward and dX (3xTF32, compensated) and the weight
# gradient (tile sums on the CUDA cores, compensated)
FP64_CHECKED = (("conv", "gather_gemm", subm.gather_gemm,
                 subm.gather_gemm_plain),
                ("dgrad", "gather_gemm_dgrad", subm.gather_gemm_dgrad,
                 subm.gather_gemm_plain),
                ("wgrad", "sparse_wgrad", subm.sparse_wgrad,
                 subm.gather_gemm_wgrad_plain))


def check_fp32_calls(calls, what, mixed=False):
    """Each recorded sparse-conv call of an fp32 path (forward, and in a
    train step dX and the weight gradient) in fp32, its kernel output
    against the plain version in fp64 (`fp64_gate`); on a `mixed` path
    (bf16 and fp32 calls, as a residual middle's under mixed precision)
    its fp32 calls, of which there must be some. Returns the largest ratio
    of the kernel's error to the fp32 plain version's, by kind."""
    worst, n = {}, 0
    for kind, key, kernel, plain in FP64_CHECKED:
        for i, (args, _) in enumerate(calls.get(key, ())):
            if args[0].dtype != torch.float32:
                if mixed:
                    continue
                fail(f"{what} {kind} {i}: {args[0].dtype} features on the "
                     f"fp32 path")
            e = fp64_gate(args, kernel(*args), f"{what} {kind} {i}", plain)
            worst[kind] = max(worst.get(kind, 0.0), e["fp64_rel_err"] /
                              max(e["plain_fp64_rel_err"], 1e-30))
            n += 1
    if not n:
        fail(f"{what}: no fp32 sparse-conv call to hold against fp64")
    say(f"{what}: {'the' if mixed else 'every'} sparse-conv call"
        f"{'s in' if mixed else ''} fp32 ({n}); error against fp64 at most "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()) +
        f" times the fp32 plain version's (gated at {FP32_ERR_RATIO})")
    return worst


def predict_fails_on_sync(spec, preds, anchors, what, predict_fn=predict):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        predict_fn(spec, preds, anchors)
    except RuntimeError as e:
        fail(f"{what}: {predict_fn.__name__} synchronised with the host: "
             f"{e}")
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


def build_two_stage(model, device, seed=0, proposals=TWO_STAGE_PROPOSALS):
    """`build_two_stage_voxelnet` at this script's proposals: stage 1 and
    the head fp32 on every config, as JAX's two-stage `Trainer` builds
    them."""
    return build_two_stage_voxelnet(model, proposals, device=device,
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
    version on the same inputs (bitwise, ROI_BWD_TOL), timed by events
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
                ints = torch.int64 if got.dtype == torch.float64 \
                    else torch.int32
                if not torch.equal(got.view(ints), want.view(ints)):
                    fail(f"{what} roi_align_fwd {i}: not bitwise the plain "
                         f"version (max abs err {err:.3g})")
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
            if name == "roi_align_fwd":
                split = device_split(fns[0], dtimer)
                agg["split"] = {k: ms for k, (ms, _) in split.items()}
                say(f"{what} roi_align_fwd {i}: bitwise the plain version; "
                    + split_line(split))
            if name == "roi_align_bwd":
                # the scratch a call takes beyond its inputs: the partials
                # [cells, 4, C] and the transposed gradient among it
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                roi_align.roi_align_bwd(feat, coords, grad, s)
                torch.cuda.synchronize()
                scratch = torch.cuda.max_memory_allocated() - base
                part = B * (H + 1) * (W + 1) * 4 * C * grad.element_size()
                agg["scratch_bytes"] = agg.get("scratch_bytes", 0) + scratch
                agg["partials_bytes"] = agg.get("partials_bytes", 0) + part
                say(f"{what} roi_align_bwd {i}: C={C}: partials [cells, 4, "
                    f"C] {part / 2 ** 20:.1f} MiB; peak scratch of the call "
                    f"{scratch / 2 ** 20:.1f} MiB")
                split = device_split(fns[0], dtimer)
                agg["split"] = {k: ms for k, (ms, _) in split.items()}
                agg["counts"] = want_counts
                say(f"{what} roi_align_bwd {i}: {want_counts[0]} in-map "
                    f"samples in {want_counts[1]} cell runs, the kernel's "
                    f"counts equal; " + split_line(split))
        aggs[name] = agg
    return aggs


def standup_meets(cand, valid):
    """[B, K, K] bool: the valid pairs i < j whose standup boxes meet (both
    widths > 0, NaN meets nothing), one example at a time."""
    K = valid.shape[1]
    upper = torch.ones((K, K), dtype=torch.bool, device=cand.device).triu(1)
    out = []
    for c, v in zip(cand, valid):
        lo = torch.maximum(c[:, None, :2], c[None, :, :2])
        hi = torch.minimum(c[:, None, 2:], c[None, :, 2:])
        out.append(((hi - lo) > 0).all(-1) & upper & v[:, None] & v[None])
    return torch.stack(out)


def standup_bound(cand, valid, peak=PEAK_OPS_PER_S[torch.float32]):
    """The standup bitmask's bound in seconds, by bytes (the boxes and
    valid flags read once, the bitmask written once) and by operations
    (each valid pair's meet test, the IoU of the pairs that meet, each
    box's area), the pairs tested and the pairs that meet."""
    B, K = valid.shape
    n_valid = valid.sum(1).double()
    tests = float((n_valid * (n_valid - 1) / 2).sum())
    # a block of rows at a time, as the plain versions build them
    meets = 0
    for r0, r1 in riou.row_blocks(B, K):
        lo = torch.maximum(cand[:, r0:r1, None, :2], cand[:, None, :, :2])
        hi = torch.minimum(cand[:, r0:r1, None, 2:], cand[:, None, :, 2:])
        upper = torch.arange(K, device=cand.device)[None, :] > \
            torch.arange(r0, r1, device=cand.device)[:, None]
        meets += int((((hi - lo) > 0).all(-1) & upper &
                      valid[:, r0:r1, None] & valid[:, None, :]).sum())
    nbytes = cand.numel() * cand.element_size() + valid.numel() + \
        B * K * ((K + 31) // 32) * 4
    ops = tests * STANDUP_TEST_OPS + meets * STANDUP_MEET_OPS + \
        B * K * STANDUP_AREA_OPS
    return nbytes / HBM_BYTES_PER_S, ops / peak, tests, meets


def check_standup_calls(calls, sup_calls, timer, dtimer, what,
                        reps=(20, 5)):
    """Each recorded standup-bitmask call against its plain version (every
    bit equal), the suppression that read it against the plain one (keep
    equal), timed beside the plain version (`reps` events each) with its
    bound (`standup_bound`: the valid pairs' meet tests, the IoU of those
    that meet, the boxes' areas, the bitmask written). The kernel's device
    time in a session of its own; the plain version's where it builds its
    matrix in one row block (`riou.row_blocks`), else not timed (NaN: its
    thousands of launches a run overflow a profiling session). No PyTorch
    call computes the function: the library time is none. Returns the
    aggregate."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=None, device_ms=0.0,
               plain_device_ms=0.0, library_device_ms=None, bytes_s=0.0,
               ops_s=0.0, err=0.0)
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
        bs, os_, tests, meets = standup_bound(cand, valid)
        fns = (lambda: riou.standup_overlap(cand, valid, thr),
               lambda: riou.standup_overlap_plain(cand, valid, thr))
        ms = [timer(fns[0], reps[0]), timer(fns[1], reps[1])]
        dev_ms = dtimer(list(fns)) if len(riou.row_blocks(B, K)) == 1 \
            else [dtimer(fns[:1])[0], float("nan")]
        agg["ms"] += ms[0]
        agg["plain_ms"] += ms[1]
        agg["device_ms"] += dev_ms[0]
        agg["plain_device_ms"] += dev_ms[1]
        agg["bytes_s"] += bs
        agg["ops_s"] += os_
        say(f"{what} standup_overlap {i} B={B} K={K} thr={thr}: bits exact "
            f"({int(riou.unpack_bits(got, K).sum())} set), NMS keep exact "
            f"({keep.sum(1).tolist()} kept); kernel {ms[0]:.4f} ms (device "
            f"{dev_ms[0]:.4f})  plain {ms[1]:.4f} ms (device {dev_ms[1]:.4f})  "
            f"library none  bound {1e3 * max(bs, os_):.6f} ms "
            f"({'bytes' if bs >= os_ else 'operations'}; {tests:.0f} pair "
            f"tests, {meets} meet)")
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
    1, fp32 as JAX builds the two-stage model, 512 proposals an example,
    random weights from seed 0) on the fhd bench input (batch 4, 40 000 voxels), through
    the two-stage eval step. Returns (the forward and standup kernels'
    aggregates, the launch counts, the report)."""
    report = {}
    cfg = load_pipeline_config(CONFIG)
    net, spec, info, assigner, _ = build_two_stage(cfg.model, dev)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    points, mask, anchors = build_inputs(cfg, assigner, info, dev)
    eval_step = make_two_stage_steps(spec, vspec)[1]
    state = TrainState(net, None)
    batch = {"points": points, "points_mask": mask, "anchors": anchors}
    say(f"2st eval: batch {BATCH}, {MAX_VOXELS} voxels, "
        f"{TWO_STAGE_PROPOSALS} proposals an example, fp32 stage 1 (the "
        f"config's mixed precision "
        f"{cfg.train_config.enable_mixed_precision} is the one-stage "
        f"model's; JAX builds the two-stage model fp32)")

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
    report["fp64_ratio"] = check_fp32_calls(calls, "2st eval")
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
    if (paths["mma"], paths["fma"]) != (0, SPARSE_CONVS):
        fail(f"2st: not every sparse conv took the fp32 path: {paths}")
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
    """`check_refine_reference` of the two-stage detector on one fp32
    example (its stage 1 the one-stage VoxelNet, the crops of its RPN
    trunk)."""
    def stage1(net, one, device):
        vox = device_voxelize(vspec, *one, device)
        return net.stage1(vox["voxels"], vox["num_points"],
                          vox["coordinates"], vox["voxel_valid"])
    return check_refine_reference(cfg, dev, "2st", build_two_stage, stage1,
                                  "trunk", [t[:1] for t in (points, mask)],
                                  anchors[:1])


def check_refine_reference(cfg, dev, what, build, stage1, crop_key, one,
                           a_c, concat_key=None):
    """One fp32 example through a detector with the second stage (the
    two-stage or the temporal one, made by `build`) on the card and on the
    CPU, from the same seeded weights: stage 1 (`stage1(net, one, device)`
    on the example's inputs `one`, a list or dict of tensors) end to end
    within PRED_TOL, its box and class predictions and the map the crops
    come from (`crop_key`); then each later step on the card's own inputs,
    card (kernels) against CPU (plain versions): the proposals' standup NMS
    on the same boxes and scores (indices and keep equal), the crops at the
    same proposal boxes (CROP_REF_TOL; with `concat_key` the crops of that
    map too, the classification tower's), the refine head on the same
    crops (PRED_TOL), the rotated NMS of `predict_two_stage` on the same
    candidates (indices and keep equal). `predict_two_stage` whole on the
    same predictions, and the CPU's proposals from its own stage 1, are
    compared and printed, not gated: a random head gives the proposals of
    empty regions tied scores, and boxes decoded an ulp apart on the two
    devices can trade places among them."""
    cpu = torch.device("cpu")
    net_c, spec = build(cfg.model, dev)[:2]
    net_h = build(cfg.model, cpu)[0]
    a_h = a_c.cpu()
    one_h = {k: v.cpu() for k, v in one.items()} if isinstance(one, dict) \
        else [t.cpu() for t in one]

    def to_cpu(preds):
        out = {k: v.cpu() for k, v in preds.items() if k != "proposals"}
        if "proposals" in preds:
            out["proposals"] = {k: v.cpu()
                                for k, v in preds["proposals"].items()}
        return out
    with torch.no_grad():
        s1_c = stage1(net_c, one, dev)
        t0 = time.perf_counter()
        s1_h = stage1(net_h, one_h, cpu)
        own_h = net_h.refine(s1_h, a_h, crop_map=s1_h[crop_key],
                             concat_map=s1_h.get(concat_key))["proposals"]
        cpu_s = time.perf_counter() - t0
        errs = {}
        for k in ("box_preds", "cls_preds", crop_key) + \
                ((concat_key,) if concat_key else ()):
            a, b = s1_c[k].cpu().float(), s1_h[k].float()
            errs[k] = (a - b).abs().max().item()
            if not torch.allclose(a, b, **PRED_TOL):
                fail(f"{what} reference: stage 1 {k} card vs CPU max abs err "
                     f"{errs[k]:.3g} over {PRED_TOL}")
        with recording([(nms_ops, "nearest_nms")]) as calls:
            p_c = net_c.refine(s1_c, a_c, crop_map=s1_c[crop_key],
                               concat_map=s1_c.get(concat_key))
        args, kwargs = calls["nearest_nms"][0]
        idx_c, keep_c = nms_ops.nearest_nms(*args, **kwargs)
        idx_h, keep_h = nms_ops.nearest_nms(*[a.cpu() for a in args],
                                            **kwargs)
        if not (torch.equal(idx_c.cpu(), idx_h) and
                torch.equal(keep_c.cpu(), keep_h) and
                torch.equal(idx_c, p_c["proposals"]["indices"])):
            fail(f"{what} reference: the proposals' standup NMS differs card "
                 f"vs CPU on the same boxes and scores")
        prop_h = to_cpu(p_c)["proposals"]
        c_c = net_c.crops(s1_c[crop_key], p_c["proposals"])
        c_h = net_h.crops(s1_c[crop_key].cpu(), prop_h)
        cc_c = cc_h = None
        if concat_key:
            cc_c = net_c.crops(s1_c[concat_key], p_c["proposals"])
            cc_h = net_h.crops(s1_c[concat_key].cpu(), prop_h)
        hd_c = net_c.second_rpn(c_c, cc_c)
        hd_h = net_h.second_rpn(c_c.cpu(), None if cc_c is None
                                else cc_c.cpu())
        with recording([(nms_ops, "nms")]) as calls:
            det_c = predict_two_stage(spec, p_c, a_c)
        (args, kwargs), = calls["nms"]
        sel_c, keep_c = nms_ops.nms(*args, **kwargs)
        sel_h, keep_h = nms_ops.nms(*[a.cpu() for a in args], **kwargs)
        det_h = predict_two_stage(spec, to_cpu(p_c), a_h)
    errs["crops_rel"] = errors(c_c.cpu(), c_h)[1]
    if concat_key:
        errs["crops_rel"] = max(errs["crops_rel"],
                                errors(cc_c.cpu(), cc_h)[1])
    if errs["crops_rel"] > CROP_REF_TOL:
        fail(f"{what} reference: crops {errs['crops_rel']:.3g} of their scale "
             f"apart card vs CPU, over {CROP_REF_TOL}")
    for k in hd_c:
        a, b = hd_c[k].cpu(), hd_h[k]
        errs[f"head_{k}"] = (a - b).abs().max().item()
        if not torch.allclose(a, b, **PRED_TOL):
            fail(f"{what} reference: head {k} card vs CPU max abs err "
                 f"{errs[f'head_{k}']:.3g}")
    if not (torch.equal(sel_c.cpu(), sel_h) and
            torch.equal(keep_c.cpu(), keep_h)):
        fail(f"{what} reference: predict's rotated NMS differs card vs CPU "
             f"on the same candidates")
    valid = det_c["valid"].cpu()
    errs["det_valid_equal"] = bool(torch.equal(valid, det_h["valid"]))
    both = valid & det_h["valid"]
    for k in ("boxes", "scores"):
        a, b = det_c[k].cpu()[both], det_h[k][both]
        errs[f"det_{k}"] = (a - b).abs().max().item() if a.numel() else 0.0
    same = (own_h["indices"] == prop_h["indices"]).float().mean().item()
    n_prop = int(prop_h["valid"].sum())
    say(f"{what} reference (fp32, 1 example, card vs CPU; the CPU's stage 1 "
        f"and proposals in {cpu_s:.1f} s): stage 1 err box "
        f"{errs['box_preds']:.2e} cls {errs['cls_preds']:.2e} {crop_key} "
        f"{errs[crop_key]:.2e}; on the card's inputs: the standup NMS equal "
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
    1, fp32, 512 proposals an example, the config's Adam) on the fhd train
    inputs (batch 4 synthetic scans, 16 000 voxels), through
    `make_two_stage_steps`. Returns (the backward kernel's aggregate, the
    launch counts, the report)."""
    report = {}
    cfg = load_pipeline_config(CONFIG)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, None,
                                                  build=build_two_stage)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     TRAIN_VOXELS, shuffle_overflow=True)
    batch = train_inputs(cfg, assigner, info, dev, TRAIN_BATCH)
    step = make_two_stage_steps(spec, vspec)[0]
    say(f"2st train: batch {TRAIN_BATCH} synthetic scans, {TRAIN_VOXELS} "
        f"voxels (shuffle_overflow), fp32 stage 1 as in JAX, "
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
    report["fp64_ratio"] = check_fp32_calls(calls, "2st train")
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
    # fp32 stage 1: the gather-GEMM's forward and dX on the 3xTF32 path,
    # the weight gradient on its fp32 path
    want_paths = {"mma": 0, "fma": 2 * SPARSE_CONVS - 1, "wgrad_mma": 0,
                  "wgrad_fma": SPARSE_CONVS}
    if paths != want_paths:
        fail(f"2st train step: sparse kernels by path {paths}, expected "
             f"{want_paths}")
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
    report["overfit"] = check_overfit(cfg, dev, None, step, batch, "2st",
                                      build=build_two_stage)
    torch.backends.cudnn.deterministic = False
    report["reference"] = check_2st_train_reference(dev)
    return aggs["roi_align_bwd"], counts, report


def check_2st_train_reference(dev, what="2st", build_fn=None,
                               make_steps=make_two_stage_steps,
                               inputs=None, pos_key="second_num_pos"):
    """One fp64 train step of a detector with the second stage (the
    two-stage one, or the temporal or a fusion one with `build_fn`,
    `make_steps` and its `inputs`; the one-stage fusion model, with
    `pos_key` "num_pos", has stage 1 only) on one example, card (kernels)
    against CPU (plain versions), from the same seeded weights with the
    config's
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

    build_fn = build_fn or build_two_stage
    inputs = inputs or train_inputs

    def build(model, device, seed=0):
        return build_fn(model, device, seed, TWO_STAGE_REF_PROPOSALS)
    runs = {}
    for device in (dev, cpu):
        state, spec, info, assigner = new_train_state(
            cfg, device, None, dtype=torch.float64, build=build)
        if device == dev:
            one = {k: v[:1].to(torch.float64) if v.is_floating_point()
                   else v[:1] for k, v in inputs(
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
        step = make_steps(spec, vspec)[0]
        t0 = time.perf_counter()
        state, metrics = step(state, {k: v.to(device)
                                      for k, v in one.items()})
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs[device.type] = dict(
            secs=time.perf_counter() - t0, loss=float(metrics["loss"]),
            pos2=int(metrics[pos_key]),
            grads={k: v.cpu() for k, v in grads[0].items()},
            after={k: v.detach().cpu()
                   for k, v in state.module.state_dict().items()
                   if v.is_floating_point()})
    c, h = runs["cuda"], runs["cpu"]
    errs = {"loss_rel": abs(c["loss"] / h["loss"] - 1)}
    if errs["loss_rel"] > REF64_LOSS_RTOL or c["pos2"] != h["pos2"] or \
            not h["pos2"]:
        fail(f"{what} train reference: fp64 loss {c['loss']!r} on the card, "
             f"{h['loss']!r} on the CPU ({pos_key} {c['pos2']}, "
             f"{h['pos2']})")
    worst = dict(grad=0.0, after=0.0)
    lr = float(state.lr_sched(0))
    wd = cfg.train_config.optimizer.weight_decay
    for name, want in h["grads"].items():
        scale = max(want.abs().max().item(), 1e-30)
        e = (c["grads"][name] - want).abs().max().item() / scale
        worst["grad"] = max(worst["grad"], e)
        if e > REF64_TOL:
            fail(f"{what} train reference: fp64 gradient {name} differs card "
                 f"vs CPU by {e:.3g} of its scale")
    for name, want in h["after"].items():
        diff = (c["after"][name] - want).abs()
        e = diff.max().item() / max(want.abs().max().item(), 1e-30)
        g = h["grads"].get(name)
        if g is None:                   # a norm statistic
            worst["after"] = max(worst["after"], e)
            if e > REF64_TOL:
                fail(f"{what} train reference: fp64 {name} after the step "
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
            fail(f"{what} train reference: fp64 parameter {name} after the "
                 f"step differs card vs CPU by {e:.3g} of its scale")
    errs.update(worst)
    say(f"{what} train reference (PointPillars stage 1, fp64, 1 example, "
        f"{TWO_STAGE_REF_PROPOSALS} proposals, {h['pos2']} {pos_key}, card "
        f"vs CPU; the CPU's step in {h['secs']:.1f} s): "
        f"loss rel {errs['loss_rel']:.2e}, gradients within "
        f"{worst['grad']:.2e} of their scale, state after the step within "
        f"{worst['after']:.2e}")
    return dict(cpu_s=h["secs"], card_s=c["secs"], errs=errs,
                **{pos_key: h["pos2"]})


# ------------------------------------------------------- the temporal model


def build_temporal(model, device, seed=0, proposals=TWO_STAGE_PROPOSALS,
                   sequence=False):
    """`build_temporal_voxelnet` at this script's proposals: fp32 on every
    config, as JAX's temporal `Trainer` builds it."""
    return build_temporal_voxelnet(model, proposals, device=device,
                                   seed=seed, sequence=sequence)


def temporal_loss(spec, net, pair, batch):
    """The temporal model's train-mode forward on the voxelized (cur, prev)
    frames and its loss dict."""
    preds = net(*pair, batch["anchors"],
                anchors_mask=batch.get("anchors_mask"))
    return compute_temporal_loss(spec, preds, batch["labels"],
                                 batch["reg_targets"], batch["anchors"],
                                 batch.get("gt_boxes_padded"),
                                 batch.get("gt_valid"))


def temporal_inputs(cfg, assigner, info, dev, seeds=(0, 1)):
    """The temporal eval input: BATCH pairs, each the fhd bench scan (a
    LiDAR scan of seed `seeds[0]`, 512 azimuth steps, as `build_inputs`
    draws it) as the current frame and a scan of the same kind from seed
    `seeds[1]` as the previous one, prepared for eval, on the card."""
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=MAX_POINTS, training=False))
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    p, b, n = lidar_scan_scene(np.random.default_rng(seeds[0]),
                               pc_range=pc_range, num_azimuth=512)
    prev = lidar_scan_scene(np.random.default_rng(seeds[1]),
                            pc_range=pc_range, num_azimuth=512)[0]
    ex = prep({"points": p, "p_points": prev, "gt_boxes": b, "gt_names": n,
               "image_idx": 0}, np.random.default_rng(0))
    batch = prep.collate([ex] * BATCH)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if k != "image_idx"}


def temporal_train_inputs(cfg, assigner, info, dev, n,
                          max_points=MAX_POINTS):
    """n synthetic (cur, prev) pairs (`SyntheticPairDataset`, seed 1, the
    config's range: the `Trainer`'s own synthetic data) prepared for
    training as `train_inputs` prepares scans, collated, on `dev`."""
    vg = cfg.model.voxel_generator
    reader = cfg.train_input_reader
    prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=max_points, training=True,
        shuffle_points=reader.shuffle_points,
        anchor_area_threshold=reader.anchor_area_threshold,
        voxel_size=tuple(vg.voxel_size), pc_range=tuple(vg.point_cloud_range)))
    ds = SyntheticPairDataset(n, seed=1, pc_range=tuple(vg.point_cloud_range))
    rng = np.random.default_rng(0)
    batch = prep.collate([prep(ds[i], rng) for i in range(n)])
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if k != "image_idx"}


def check_folded(calls, n_frames, what):
    """Every recorded forward sparse conv took both frames of every pair
    in one call: n_frames examples."""
    batches = sorted({args[0].shape[0] for args, _ in calls["gather_gemm"]})
    if batches != [n_frames]:
        fail(f"{what}: the sparse convs took batches {batches}, expected "
             f"both frames folded into one batch of {n_frames}")


def temporal_split(net, spec, vspec, batch, dev):
    """One temporal eval forward cut at its stage boundaries, each
    synchronised: ms of voxelize (both frames), backbone (both frames in
    one call), fusion + RPN, proposals, crops, refine head, predict."""
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
        cur, prev = voxelize_pair(vspec, batch, dev)[0]
        lap("voxelize")
        stacked = {k: torch.cat([cur[k], prev[k]], 0) for k in (
            "voxels", "num_points", "coordinates", "voxel_valid")}
        bev, _ = net.backbone(stacked)
        lap("backbone")
        B = cur["voxels"].shape[0]
        preds = net.fuse(bev[:B], bev[B:])
        lap("fusion_rpn")
        proposals = select_proposals(net.pspec, spec, preds,
                                     batch["anchors"])
        lap("proposals")
        crops = net.crops(preds["gated_bev_feat"], proposals)
        lap("crops")
        head = net.second_rpn(crops)
        N = proposals["indices"].shape[1]
        preds.update({"proposals": proposals,
                      "second_box_preds": head["box_preds"].reshape(B, N, -1)
                      + proposals["box_enc"],
                      "second_cls_preds": head["cls_preds"].reshape(B, N,
                                                                    -1)})
        lap("head")
        predict_temporal(spec, preds, batch["anchors"])
        lap("predict")
    return out


def run_tmp_eval(dev, timer, dtimer):
    """The temporal detector's eval forward (second_car_fhd.config, fp32 as
    JAX builds it, 512 proposals an example, random weights from seed 0)
    through `make_temporal_steps`' eval step on BATCH pairs at MAX_VOXELS
    voxels a frame (`temporal_inputs`). Returns (the launch counts, the
    report)."""
    report = {}
    cfg = load_pipeline_config(CONFIG)
    net, spec, info, assigner, _ = build_temporal(cfg.model, dev)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    batch = temporal_inputs(cfg, assigner, info, dev)
    eval_step = make_temporal_steps(spec, vspec)[1]
    state = TrainState(net, None)
    (cur, prev), _ = voxelize_pair(vspec, batch, dev)
    frames = {f: dict(voxels=v["voxel_valid"].sum(1).tolist(),
                      overflow=int(v["voxel_overflow"]))
              for f, v in (("cur", cur), ("prev", prev))}
    report["frames"] = frames
    say(f"tmp eval: batch {BATCH} pairs, {MAX_VOXELS} voxels a frame, "
        f"{TWO_STAGE_PROPOSALS} proposals an example, fp32 (the config's "
        f"mixed precision {cfg.train_config.enable_mixed_precision} is the "
        f"one-stage model's; JAX builds the temporal model fp32); voxels "
        f"cur {frames['cur']['voxels']} prev {frames['prev']['voxels']}, "
        f"overflow {frames['cur']['overflow']} / "
        f"{frames['prev']['overflow']}")
    if frames["cur"]["overflow"] or frames["prev"]["overflow"]:
        fail(f"tmp eval: a frame's voxels overflowed: {frames}")

    def forward():
        return eval_step(state, batch)

    with recording(RECORDED_2ST) as calls:
        forward()
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"tmp capture: {n}")
    want_n = {"gather_gemm": SPARSE_CONVS, "nms_overlap": 1,
              "nms_suppress": 2, "roi_align_fwd": 1, "standup_overlap": 1}
    if {k: n[k] for k in want_n} != want_n:
        fail(f"tmp eval: recorded {n}, expected {want_n}")
    check_folded(calls, 2 * BATCH, "tmp eval")
    report["conv_max_abs_err"] = check_calls_exact(calls, "tmp eval")
    report["fp64_ratio"] = check_fp32_calls(calls, "tmp eval")
    over_bits = riou.nms_overlap(*calls["nms_overlap"][0][0])[0]
    rot_sup = [c for c in calls["nms_suppress"]
               if c[0][0].shape == over_bits.shape and
               torch.equal(c[0][0], over_bits)]
    if len(rot_sup) != 1:
        fail("tmp eval: no suppression call read the overlap bitmask")
    ov, sup, report["nms"] = check_nms_pair(
        {"nms_overlap": calls["nms_overlap"], "nms_suppress": rot_sup},
        timer, dtimer, "tmp eval")
    report["standup"] = check_standup_calls(
        calls["standup_overlap"], calls["nms_suppress"], timer, dtimer,
        "tmp eval")
    roi = check_roi_calls(calls["roi_align_fwd"], [], timer, dtimer,
                          "tmp eval")["roi_align_fwd"]
    report["roi_align_fwd"] = {k: roi[k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "err")}
    del calls

    reset_counts()
    det = forward()
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one tmp forward: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS, "rotated_iou": 1,
            "nms_suppress": 2, "roi_align_fwd": 1, "standup_overlap": 1,
            "roi_align_bwd": 0, "sparse_gather_gemm_dgrad": 0,
            "sparse_wgrad": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want or not counts["row_gather"]:
        fail(f"tmp forward launches {counts}, expected {want} (the sparse "
             f"gather-GEMM once a conv for both frames) and row gathers")
    if (paths["mma"], paths["fma"]) != (0, SPARSE_CONVS):
        fail(f"tmp: not every sparse conv took the fp32 path: {paths}")
    report["launches"] = counts
    report["host_syncs"] = host_syncs(forward)
    if report["host_syncs"]:
        fail(f"the tmp eval step synchronised the host "
             f"{report['host_syncs']} times")
    with torch.no_grad():
        preds = net(cur, prev, batch["anchors"])
    predict_fails_on_sync(spec, preds, batch["anchors"], "tmp eval",
                          predict_temporal)
    for k in ("voxel_overflow", "stage_overflow"):
        report[k] = int(det[k])
        if report[k]:
            fail(f"tmp eval: {k} {report[k]}, expected 0")
    for k in ("boxes", "scores"):
        if not torch.isfinite(det[k]).all():
            fail(f"tmp eval: non-finite {k}")
    report["valid"] = det["valid"].sum(1).tolist()
    say(f"tmp eval: no host sync (the eval step, and predict_temporal under "
        f"set_sync_debug_mode('error')); voxel_overflow 0, stage_overflow "
        f"0; valid detections {report['valid']}")

    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            sfx = "_tf32" if tf32 else ""
            fwd = timed_forwards(forward, TEMPORAL_TIMED, BATCH)
            report["forward" + sfx] = fwd
            report["split" + sfx] = temporal_split(net, spec, vspec, batch,
                                                   dev)
            say(f"tmp pairs/s {BATCH / fwd['median_s']:.3f} (median "
                f"{1e3 * fwd['median_s']:.2f} ms of {TEMPORAL_TIMED} "
                f"batch-{BATCH} forwards, cuDNN TF32 "
                f"{'on' if tf32 else 'off'}); peak memory "
                f"{fwd['peak_mem_bytes'] / 2 ** 30:.2f} GiB; one split: " +
                ", ".join(f"{k} {v:.2f}"
                          for k, v in report["split" + sfx].items()))
            report["profile" + sfx] = profile_forward(
                forward, fwd["median_s"],
                f"tmp forward, cuDNN TF32 {'on' if tf32 else 'off'}")
        finally:
            torch.backends.cudnn.allow_tf32 = False
    report["sequence"] = check_tmp_sequence(cfg, dev, net, vspec, assigner,
                                            info)
    del net, state

    def stage1(net, one, device):
        return net.stage1(*voxelize_pair(vspec, one, device)[0])
    one = {k: v[:1] for k, v in batch.items()}
    report["reference"] = check_refine_reference(
        cfg, dev, "tmp", build_temporal, stage1, "gated_bev_feat", one,
        batch["anchors"][:1])
    return counts, report


def check_tmp_sequence(cfg, dev, net, vspec, assigner, info):
    """`TemporalSequenceVoxelNet` on a T = TEMPORAL_SEQ_FRAMES sequence
    (LiDAR scans of seeds 0.. T - 1 as its frames, at MAX_VOXELS), loaded
    from the pair model's state dict: its T - 1 pairs' outputs against the
    pair model on the same pairs (frames 1.. as cur, 0.. as prev), both on
    the card, one backbone call of T frames against one of 2 (T - 1):
    stage 1's predictions and the gated map within PRED_TOL; the refined
    predictions within PRED_TOL where the two picked the same proposal
    (their share printed: the random head's tied scores over empty regions
    take another order from stage 1 an ulp apart)."""
    T = TEMPORAL_SEQ_FRAMES
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=MAX_POINTS, training=False))
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    padded = [prep.pad_points(lidar_scan_scene(
        np.random.default_rng(s), pc_range=pc_range, num_azimuth=512)[0],
        np.random.default_rng(0)) for s in range(T)]
    points = torch.as_tensor(np.stack([p for p, _ in padded]), device=dev)
    mask = torch.as_tensor(np.stack([m for _, m in padded]), device=dev)
    anchors = torch.as_tensor(prep.anchors, device=dev)
    seq = build_temporal(cfg.model, dev, sequence=True)[0]
    seq.load_state_dict(net.state_dict(), strict=True)
    with torch.no_grad():
        frames = device_voxelize(vspec, points, mask, dev)
        reset_counts()
        sp = seq(frames, anchors)
        torch.cuda.synchronize()
        n_seq = subm.launches
        cur = {k: v[1:] for k, v in frames.items() if v.dim()}
        prev = {k: v[:-1] for k, v in frames.items() if v.dim()}
        pp = net(cur, prev, anchors[None].expand(T - 1, *anchors.shape))
    errs = {}
    for k in ("box_preds", "cls_preds", "gated_bev_feat"):
        errs[k] = (sp[k] - pp[k]).abs().max().item()
        if not torch.allclose(sp[k], pp[k], **PRED_TOL):
            fail(f"tmp sequence: stage 1 {k} differs from the pair model's "
                 f"by {errs[k]:.3g}")
    same = (sp["proposals"]["indices"] == pp["proposals"]["indices"]) & \
        (sp["proposals"]["valid"] == pp["proposals"]["valid"])
    for k in ("second_box_preds", "second_cls_preds"):
        errs[k] = (sp[k] - pp[k])[same].abs().max().item()
        if not torch.allclose(sp[k][same], pp[k][same], **PRED_TOL):
            fail(f"tmp sequence: {k} at the shared proposals differs from "
                 f"the pair model's by {errs[k]:.3g}")
    share = same.float().mean().item()
    say(f"tmp sequence: T = {T} frames in one backbone call ({n_seq} sparse "
        f"gather-GEMM launches), its {T - 1} pairs against the pair model's "
        f"on the same pairs: stage 1 within " + ", ".join(
            f"{k} {errs[k]:.2e}" for k in ("box_preds", "cls_preds",
                                           "gated_bev_feat")) +
        f"; {100 * share:.1f}% of the proposals the same (a random head "
        f"ties the scores of empty regions, and stage 1 an ulp apart "
        f"reorders ties), the refined predictions at those within "
        f"{errs['second_box_preds']:.2e} / {errs['second_cls_preds']:.2e}")
    if n_seq != SPARSE_CONVS:
        fail(f"tmp sequence: {n_seq} sparse gather-GEMM launches, expected "
             f"{SPARSE_CONVS}")
    return dict(frames=T, errs=errs, sparse_launches=n_seq,
                same_proposals=share)


def run_tmp_train(dev, timer, dtimer):
    """The temporal detector's train step (`make_temporal_steps`, fp32, the
    config's Adam) on TRAIN_BATCH synthetic pairs at TRAIN_VOXELS voxels a
    frame (`temporal_train_inputs`). Returns (the launch counts, the
    report)."""
    report = {}
    cfg = load_pipeline_config(CONFIG)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, None,
                                                  build=build_temporal)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     TRAIN_VOXELS, shuffle_overflow=True)
    batch = temporal_train_inputs(cfg, assigner, info, dev, TRAIN_BATCH)
    step = make_temporal_steps(spec, vspec)[0]
    say(f"tmp train: batch {TRAIN_BATCH} synthetic pairs "
        f"(SyntheticPairDataset), {TRAIN_VOXELS} voxels a frame "
        f"(shuffle_overflow), fp32 as in JAX, {TWO_STAGE_PROPOSALS} "
        f"proposals an example")

    with recording(RECORDED_2ST_TRAIN) as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"tmp train capture: {n}; loss {float(metrics['loss']):.4f}")
    want_n = {"gather_gemm": SPARSE_CONVS,
              "gather_gemm_dgrad": SPARSE_CONVS - 1,
              "sparse_wgrad": SPARSE_CONVS, "roi_align_fwd": 1,
              "roi_align_bwd": 1, "standup_overlap": 1, "nms_suppress": 1}
    if n != want_n:
        fail(f"tmp train: recorded {n}, expected {want_n}")
    check_folded(calls, 2 * TRAIN_BATCH, "tmp train")
    check_step_calls("tmp train", calls, timer, dtimer, timed=False)
    report["fp64_ratio"] = check_fp32_calls(calls, "tmp train")
    roi = check_roi_calls(calls["roi_align_fwd"], calls["roi_align_bwd"],
                          timer, dtimer, "tmp train")
    report["roi_align"] = {n: {k: a[k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "err")}
        for n, a in roi.items()}
    report["standup"] = check_standup_calls(
        calls["standup_overlap"], calls["nms_suppress"], timer, dtimer,
        "tmp train")
    del calls

    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one tmp train step: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS,
            "sparse_gather_gemm_dgrad": SPARSE_CONVS - 1,
            "sparse_wgrad": SPARSE_CONVS, "roi_align_fwd": 1,
            "roi_align_bwd": 1, "standup_overlap": 1, "nms_suppress": 1,
            "rotated_iou": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"tmp train step launches {counts}, expected {want}")
    want_paths = {"mma": 0, "fma": 2 * SPARSE_CONVS - 1, "wgrad_mma": 0,
                  "wgrad_fma": SPARSE_CONVS}
    if paths != want_paths:
        fail(f"tmp train step: sparse kernels by path {paths}, expected "
             f"{want_paths}")
    params = dict(state.module.named_parameters())
    for name, p in params.items():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"tmp {name}: gradient missing or not finite")
    for name in ("bev_fusion.conv_gating_bev.weight",
                 "second_rpn.conv_box_second.weight",
                 "middle.subm.0.weight", "rpn.trunk.convs.0.conv.weight"):
        if not params[name].grad.abs().max() > 0:
            fail(f"tmp {name}: gradient all zero")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"tmp train metrics not finite: {m}")
    report["metrics"], report["launches"] = m, counts
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the tmp train step synchronised the host {n_syncs} times")
    say("tmp train step: no host sync; every gradient finite, the gate's, "
        "the head's, the sparse middle's and the RPN's nonzero; " +
        ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    check_determinism(state, spec, vspec, batch, "tmp", temporal_loss,
                      voxelize_pair)
    report["speed"], report["profile"] = timed_steps(
        step, state, spec, vspec, batch, TEMPORAL_TIMED, "tmp train",
        loss_of=temporal_loss, voxelize=voxelize_pair)
    del state
    report["overfit"] = check_overfit(cfg, dev, None, step, batch, "tmp",
                                      build=build_temporal)
    torch.backends.cudnn.deterministic = False
    report["reference"] = check_tmp_train_reference(cfg, dev, batch)
    report["reference64"] = check_2st_train_reference(
        dev, "tmp", build_temporal, make_temporal_steps,
        temporal_train_inputs)
    return counts, report


def check_tmp_train_reference(cfg, dev, batch):
    """One fp32 temporal train step on one pair (the phase's first), card
    (kernels) against CPU (plain versions), from the same seeded weights
    with the config's optimizer, the proposals' NMS allowed the positive
    anchors and a hundredth of the others (as the fp64 reference): the
    loss within REF_LOSS_RTOL, the positives of both stages equal. The
    gradients are compared and printed, not gated: the refine head's ten
    unnormalised convs put ReLU inputs within fp32 rounding of zero, and
    each sign that flips moves the head's gradients, and those it sends
    back through the crops, by up to 4% of their scale
    (`tests/test_torch_two_stage.py`); the fp64 step is held card against
    CPU gradient by gradient (`check_2st_train_reference`)."""
    cpu = torch.device("cpu")
    one = {k: v[:1].cpu() for k, v in batch.items()}
    g = torch.Generator().manual_seed(0)
    one["anchors_mask"] = (one["labels"] > 0) | (torch.rand(
        one["labels"].shape, generator=g) < 0.01)
    runs = {}
    for device in (dev, cpu):
        state, spec = new_train_state(cfg, device, None,
                                      build=build_temporal)[:2]
        grads = record_grads(state)
        vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                         TRAIN_VOXELS)
        step = make_temporal_steps(spec, vspec)[0]
        t0 = time.perf_counter()
        state, metrics = step(state, {k: v.to(device)
                                      for k, v in one.items()})
        runs[device.type] = dict(
            secs=time.perf_counter() - t0, loss=float(metrics["loss"]),
            pos=(int(metrics["num_pos"]), int(metrics["second_num_pos"])),
            grads={k: v.cpu() for k, v in grads[0].items()})
    c, h = runs["cuda"], runs["cpu"]
    rel = abs(c["loss"] / h["loss"] - 1)
    if rel > REF_LOSS_RTOL or c["pos"] != h["pos"] or not h["pos"][1]:
        fail(f"tmp train reference: fp32 loss {c['loss']!r} on the card, "
             f"{h['loss']!r} on the CPU (positives {c['pos']}, {h['pos']})")
    worst = {}
    for name, want in h["grads"].items():
        part = "second_rpn" if name.startswith("second_rpn.") else "stage 1"
        e = (c["grads"][name] - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        worst[part] = max(worst.get(part, 0.0), e)
    say(f"tmp train reference (fp32, 1 pair, card vs CPU; the CPU's step in "
        f"{h['secs']:.1f} s): loss {c['loss']:.6f} / {h['loss']:.6f} (rel "
        f"{rel:.2e}), positives {h['pos']}; gradients within "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) +
        " of their scale (printed)")
    return dict(cpu_s=h["secs"], loss_rel=rel, positives=h["pos"],
                grads_rel=worst)


def run_tmp_trainer(dev):
    """`Trainer(model_type="temporal")` on the card with second_car_fhd.config
    (which asks for mixed precision; the temporal model is fp32), 2 steps
    and an `evaluate` each: on synthetic pairs, and on a fake KITTI-tracking
    tree (`data/fake_tracking.py`: one sequence of 4 frames, so 4 pairs)
    at batch 2. The model fp32; the losses finite; the /3d AP keys; the
    sparse gather-GEMM 14 launches a forward (both frames folded), over
    the steps and the eval batches. Returns (the launch counts of both
    runs, the report)."""
    import tempfile
    from second_tpu_torch.data.fake_tracking import write_tracking_tree
    from second_tpu_torch.train.run import Trainer
    report, total = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for kind in ("synthetic", "tracking"):
            patches = ["train_config.steps_per_eval=0",
                       "train_config.save_summary_steps=1"]
            if kind == "tracking":
                root = write_tracking_tree(tmp / "tracking" / "training",
                                           np.random.default_rng(0))
                patches += [
                    f"train_input_reader.kitti_root_path='{root}'",
                    f"eval_input_reader.kitti_root_path='{root}'",
                    "train_input_reader.batch_size=2",
                    "eval_input_reader.batch_size=2"]
            tr = Trainer(CONFIG, tmp / kind, synthetic=kind == "synthetic",
                         dataset_size=8, max_points=MAX_POINTS,
                         total_steps=2, model_type="temporal",
                         patches=patches, device=dev)
            if not tr.cfg.train_config.enable_mixed_precision or \
                    tr.module.middle.dtype is not None or any(
                        p.dtype != torch.float32
                        for p in tr.module.parameters()):
                fail(f"tmp trainer ({kind}): the model is not fp32 on a "
                     f"config that asks for mixed precision")
            reset_counts()
            try:
                t0 = time.perf_counter()
                state = tr.train(2)
                train_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                detail = tr.evaluate(state, max_frames=8)
                eval_s = time.perf_counter() - t0
            finally:
                tr.logger.close()
            counts = launch_counts()
            log = [json.loads(line) for line in
                   (tmp / kind / "log.json").read_text().splitlines()]
            losses = [r["train.loss"] for r in log if "train.loss" in r]
            ap = {k: v[1] for k, v in detail.items() if "/3d" in k}
            eval_batch = tr.cfg.eval_input_reader.batch_size
            forwards = 2 + min(len(tr.eval_ds), 8) // eval_batch
            if len(losses) != 2 or not all(np.isfinite(losses)) or not ap:
                fail(f"tmp trainer ({kind}): losses {losses}, /3d keys "
                     f"{sorted(ap)}")
            if counts["sparse_gather_gemm"] != SPARSE_CONVS * forwards or \
                    not counts["roi_align_fwd"] or \
                    not counts["roi_align_bwd"]:
                fail(f"tmp trainer ({kind}): launches {counts}, expected "
                     f"{SPARSE_CONVS} sparse convs in each of {forwards} "
                     f"forwards")
            say(f"tmp trainer ({kind}): {len(tr.train_ds)} train pairs, "
                f"losses " + ", ".join(f"{v:.4f}" for v in losses) +
                f" in {train_s:.1f} s, evaluate in {eval_s:.1f} s with "
                f"{len(ap)} /3d AP keys; launches {counts}")
            report[kind] = dict(losses=losses, ap_3d=ap, train_s=train_s,
                                eval_s=eval_s, launches=counts)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return total, report


# ------------------------------------------------ the camera-fusion models

# the camera canvas of the fusion phases: KITTI's, the JAX `Trainer`'s
# non-synthetic `image_shape` and the `PrepConfig` default; the fp64
# references' smaller canvas (the CPU runs the FPN in fp64 there); the
# timed forwards and steps of the fusion phases
FUSION_IMAGE_HW = (384, 1248)
REF_IMAGE_HW = (192, 624)
FUSION_TIMED = 8
# kind → (what, builder, steps maker, predict, pairs, second stage)
FUSION_KINDS = {
    "fusion": ("fusion", lambda m, device, seed=0, proposals=None:
               build_fusion_voxelnet(m, device=device, seed=seed),
               make_fusion_steps, predict, False, False),
    "fusion_2st": ("fusion 2st",
                   lambda m, device, seed=0, proposals=TWO_STAGE_PROPOSALS:
                   build_fusion_two_stage_voxelnet(m, proposals,
                                                   device=device, seed=seed),
                   make_fusion_two_stage_steps, predict_two_stage, False,
                   True),
    "tmpf": ("tmpf",
             lambda m, device, seed=0, proposals=TWO_STAGE_PROPOSALS:
             build_temporal_fusion_voxelnet(m, proposals, device=device,
                                            seed=seed),
             make_temporal_fusion_steps, predict_temporal, True, True),
}
PROJECTION_KEYS = ("image", "proj_pix", "proj_bev", "proj_valid")
ZSLICE_KEYS = ("image", "idxs_norm", "idxs_valid")


def fusion_forward(kind, net, vox, batch):
    """The fusion model's forward on voxelized input (one frame, or the
    (cur, prev) pair for tmpf) and the batch's camera inputs."""
    mask = batch.get("anchors_mask")
    if kind == "tmpf":
        return net(*vox, *[batch[k] for k in ZSLICE_KEYS], batch["anchors"],
                   anchors_mask=mask)
    args = [vox[k] for k in ("voxels", "num_points", "coordinates",
                             "voxel_valid")] + \
        [batch[k] for k in PROJECTION_KEYS]
    if kind == "fusion":
        return net(*args)
    return net(*args, batch["anchors"], anchors_mask=mask)


def fusion_loss_of(kind):
    """loss_of(spec, net, vox, batch) of the fusion model `kind`: its
    train-mode forward and loss dict."""
    def loss_of(spec, net, vox, batch):
        preds = fusion_forward(kind, net, vox, batch)
        fn = compute_loss if kind == "fusion" else compute_two_stage_loss
        return fn(spec, preds, batch["labels"], batch["reg_targets"],
                  batch["anchors"], batch.get("gt_boxes_padded"),
                  batch.get("gt_valid"))
    return loss_of


def fusion_prep(cfg, assigner, info, training, zslice, image_hw,
                max_points=MAX_POINTS):
    vg = cfg.model.voxel_generator
    reader = cfg.train_input_reader
    extra = dict(shuffle_points=reader.shuffle_points,
                 anchor_area_threshold=reader.anchor_area_threshold) \
        if training else {}
    return ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=max_points, training=training, use_fusion=True,
        image_shape=image_hw, out_stride=info.out_size_factor,
        voxel_size=tuple(vg.voxel_size), pc_range=tuple(vg.point_cloud_range),
        use_zslice=zslice, **extra))


def fusion_eval_inputs(cfg, assigner, info, dev, pairs=False):
    """The fusion eval input: BATCH copies of the fhd bench scan (seed 0,
    512 azimuth steps) with its camera image on the KITTI canvas (the scan
    rendered through `synthetic_calib`, as `SyntheticDataset(with_image=
    True)` renders it) and its points' projections; with `pairs` the scan
    of seed 1 as the previous frame and the z-slice grids. On the card."""
    prep = fusion_prep(cfg, assigner, info, False, pairs, FUSION_IMAGE_HW)
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    p, b, n = lidar_scan_scene(np.random.default_rng(0), pc_range=pc_range,
                               num_azimuth=512)
    rect, velo2cam, P2 = synthetic_calib(FUSION_IMAGE_HW)
    scene = {"points": p, "gt_boxes": b, "gt_names": n, "image_idx": 0,
             "image": render_synthetic_image(p, FUSION_IMAGE_HW, rect,
                                             velo2cam, P2),
             "img_shape": FUSION_IMAGE_HW, "calib/R0_rect": rect,
             "calib/Tr_velo_to_cam": velo2cam, "calib/P2": P2}
    if pairs:
        scene["p_points"] = lidar_scan_scene(
            np.random.default_rng(1), pc_range=pc_range,
            num_azimuth=512)[0]
    ex = prep(scene, np.random.default_rng(0))
    batch = prep.collate([ex] * BATCH)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if k != "image_idx"}


def fusion_train_inputs(cfg, assigner, info, dev, n, max_points=MAX_POINTS,
                        pairs=False, image_hw=FUSION_IMAGE_HW):
    """n synthetic scans (`SyntheticDataset(scan=True, with_image=True)`,
    seed 1) or pairs (`SyntheticPairDataset(with_image=True)`), the
    `Trainer`'s synthetic fusion data, with their camera images on
    `image_hw`, prepared for training, collated, on `dev`."""
    prep = fusion_prep(cfg, assigner, info, True, pairs, image_hw,
                       max_points)
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    if pairs:
        ds = SyntheticPairDataset(n, seed=1, pc_range=pc_range,
                                  with_image=True, image_shape=image_hw)
    else:
        ds = SyntheticDataset(n, seed=1, pc_range=pc_range, scan=True,
                              with_image=True, image_shape=image_hw)
    rng = np.random.default_rng(0)
    batch = prep.collate([prep(ds[i], rng) for i in range(n)])
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if k != "image_idx"}


def fusion_voxelize(kind):
    return voxelize_pair if kind == "tmpf" else voxelize_points


def fusion_split(kind, net, spec, vspec, batch, dev):
    """One forward of the fusion model `kind` cut at its stage boundaries,
    each synchronised (in the module's mode, without grad): ms of voxelize,
    backbone (VFE + middle; both frames and the gate for tmpf), trunk (the
    RPN's BEV trunk), fpn (the camera's ResNet-18 FPN), projection (the
    points' scatter into BEV; for tmpf the z-slice crops and their 1x1
    compress), fusion (the refine blocks, the gates, the fused convs; for
    tmpf nothing), heads (the 1x1 heads), then for the two-stage kinds
    proposals, crops (both maps), head, and predict."""
    from second_tpu_torch.models.fusion import project_image_to_bev
    from second_tpu_torch.models.second_stage import select_proposals
    out, t0 = {}, None

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        if name:
            out[f"{name}_ms"] = 1e3 * (now - t0)
        t0 = now
    s1 = net.stage1 if kind == "fusion_2st" else net
    rpn = s1.rpn
    with torch.no_grad():
        lap(None)
        vox = fusion_voxelize(kind)(vspec, batch, dev)[0]
        lap("voxelize")
        if kind == "tmpf":
            stacked = {k: torch.cat([vox[0][k], vox[1][k]], 0) for k in (
                "voxels", "num_points", "coordinates", "voxel_valid")}
            bev, _ = net.backbone(stacked)
            B = bev.shape[0] // 2
            bev = net.bev_fusion(bev[:B], bev[B:])
        else:
            vf = s1.vfe(vox["voxels"], vox["num_points"], vox["coordinates"])
            vf = torch.where(vox["voxel_valid"][..., None], vf, 0.0)
            bev, _ = s1.middle(vf, vox["coordinates"], vox["voxel_valid"])
        lap("backbone")
        trunk = rpn.trunk(bev)
        lap("trunk")
        p3 = rpn.fpn18(batch["image"].permute(0, 3, 1, 2))
        lap("fpn")
        if kind == "tmpf":
            concat = rpn.crops(p3, batch["idxs_norm"], batch["idxs_valid"])
            lap("projection")
            lap("fusion")
            preds = rpn._outputs(trunk, trunk, concat)
        else:
            projected = project_image_to_bev(
                p3, batch["proj_pix"], batch["proj_bev"],
                batch["proj_valid"], trunk.shape[-2:])
            lap("projection")
            fused = rpn.fuse(trunk, projected)
            lap("fusion")
            preds = rpn._outputs(trunk, fused, fused)
        lap("heads")
        if kind == "fusion":
            predict(spec, preds, batch["anchors"],
                    batch.get("anchors_mask"))
            lap("predict")
            return out
        proposals = select_proposals(net.pspec, spec, preds,
                                     batch["anchors"])
        lap("proposals")
        crops = net.crops(preds["gated_bev_feat"], proposals)
        concat_crops = net.crops(preds["gated_concat_feat"], proposals)
        lap("crops")
        head = net.second_rpn(crops, concat_crops)
        B, N = proposals["indices"].shape
        preds.update({"proposals": proposals,
                      "second_box_preds": head["box_preds"].reshape(B, N, -1)
                      + proposals["box_enc"],
                      "second_cls_preds": head["cls_preds"].reshape(B, N,
                                                                    -1)})
        lap("head")
        predict_two_stage(spec, preds, batch["anchors"])
        lap("predict")
    return out


def check_roi_by_channels(fwd_calls, bwd_calls, timer, dtimer, what):
    """`check_roi_calls` once for each channel count of the recorded calls
    (the fusion models crop two maps: the BEV trunk and the fused or
    z-slice map). Returns {channels: aggregates}."""
    out = {}
    for C in sorted({args[0].shape[1] for args, _ in fwd_calls}):
        out[C] = check_roi_calls(
            [c for c in fwd_calls if c[0][0].shape[1] == C],
            [c for c in bwd_calls if c[0][0].shape[1] == C], timer, dtimer,
            f"{what} C={C}")
    return out


def run_fusion_eval(dev, timer, dtimer, kind):
    """The eval forward of the fusion model `kind` ("fusion",
    "fusion_2st", "tmpf") on second_car_fhd.config, fp32 as JAX builds the
    fusion models, random weights from seed 0, through its steps maker's
    eval step, on BATCH examples (pairs for tmpf) at MAX_VOXELS voxels a
    frame with the KITTI camera canvas (`fusion_eval_inputs`). Returns
    (the launch counts, the report, {channels: ROI-align aggregates})."""
    what, build, make_steps, predict_fn, pairs, two = FUSION_KINDS[kind]
    report = {}
    cfg = load_pipeline_config(CONFIG)
    net, spec, info, assigner, _ = build(cfg.model, dev)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    batch = fusion_eval_inputs(cfg, assigner, info, dev, pairs)
    eval_step = make_steps(spec, vspec)[1]
    state = TrainState(net, None)
    cam = {k: tuple(batch[k].shape) for k in (
        ZSLICE_KEYS if pairs else PROJECTION_KEYS)}
    valid = batch["idxs_valid"] if pairs else batch["proj_valid"]
    report["inputs"] = dict(camera=cam, valid=valid.sum().item())
    say(f"{what} eval: batch {BATCH}{' pairs' if pairs else ''}, "
        f"{MAX_VOXELS} voxels a frame, camera {cam} "
        f"({report['inputs']['valid']} valid "
        f"{'z-slice cells' if pairs else 'projected points'}), fp32"
        + (f", {TWO_STAGE_PROPOSALS} proposals an example" if two else ""))

    def forward():
        return eval_step(state, batch)

    with recording(RECORDED_2ST) as calls:
        forward()
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"{what} eval capture: {n}")
    want_n = {"gather_gemm": SPARSE_CONVS, "nms_overlap": 1,
              "nms_suppress": 2 if two else 1,
              "roi_align_fwd": 2 if two else 0,
              "standup_overlap": 1 if two else 0}
    if {k: n[k] for k in want_n} != want_n:
        fail(f"{what} eval: recorded {n}, expected {want_n}")
    if pairs:
        check_folded(calls, 2 * BATCH, f"{what} eval")
    report["conv_max_abs_err"] = check_calls_exact(calls, f"{what} eval")
    report["fp64_ratio"] = check_fp32_calls(calls, f"{what} eval")
    over_bits = riou.nms_overlap(*calls["nms_overlap"][0][0])[0]
    rot_sup = [c for c in calls["nms_suppress"]
               if c[0][0].shape == over_bits.shape and
               torch.equal(c[0][0], over_bits)]
    if len(rot_sup) != 1:
        fail(f"{what} eval: no suppression call read the overlap bitmask")
    report["nms"] = check_nms_pair(
        {"nms_overlap": calls["nms_overlap"], "nms_suppress": rot_sup},
        timer, dtimer, f"{what} eval")[2]
    roi = {}
    if two:
        report["standup"] = check_standup_calls(
            calls["standup_overlap"], calls["nms_suppress"], timer, dtimer,
            f"{what} eval")
        roi = check_roi_by_channels(calls["roi_align_fwd"], [], timer,
                                    dtimer, f"{what} eval")
        report["roi_align_fwd"] = {C: {k: a["roi_align_fwd"][k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "err")}
            for C, a in roi.items()}
    del calls

    reset_counts()
    det = forward()
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one {what} forward: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS, "rotated_iou": 1,
            "nms_suppress": 2 if two else 1,
            "roi_align_fwd": 2 if two else 0,
            "standup_overlap": 1 if two else 0, "roi_align_bwd": 0,
            "sparse_gather_gemm_dgrad": 0, "sparse_wgrad": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want or not counts["row_gather"]:
        fail(f"{what} forward launches {counts}, expected {want} and row "
             f"gathers")
    if (paths["mma"], paths["fma"]) != (0, SPARSE_CONVS):
        fail(f"{what}: not every sparse conv took the fp32 path: {paths}")
    report["launches"] = counts
    report["host_syncs"] = host_syncs(forward)
    if report["host_syncs"]:
        fail(f"the {what} eval step synchronised the host "
             f"{report['host_syncs']} times")
    with torch.no_grad():
        vox = fusion_voxelize(kind)(vspec, batch, dev)[0]
        preds = fusion_forward(kind, net, vox, batch)
    predict_fails_on_sync(spec, preds, batch["anchors"], f"{what} eval",
                          predict_fn)
    for k in ("voxel_overflow", "stage_overflow"):
        report[k] = int(det[k])
        if report[k]:
            fail(f"{what} eval: {k} {report[k]}, expected 0")
    for k in ("boxes", "scores"):
        if not torch.isfinite(det[k]).all():
            fail(f"{what} eval: non-finite {k}")
    report["valid"] = det["valid"].sum(1).tolist()
    say(f"{what} eval: no host sync (the eval step, and "
        f"{predict_fn.__name__} under set_sync_debug_mode('error')); "
        f"voxel_overflow 0, stage_overflow 0; valid detections "
        f"{report['valid']}")

    fwd = timed_forwards(forward, FUSION_TIMED, BATCH)
    report["forward"] = fwd
    report["split"] = fusion_split(kind, net, spec, vspec, batch, dev)
    say(f"{what} {'pairs' if pairs else 'frames'}/s "
        f"{BATCH / fwd['median_s']:.3f} (median "
        f"{1e3 * fwd['median_s']:.2f} ms of {FUSION_TIMED} batch-{BATCH} "
        f"forwards, cuDNN TF32 off); peak memory "
        f"{fwd['peak_mem_bytes'] / 2 ** 30:.2f} GiB; one split: " +
        ", ".join(f"{k} {v:.2f}" for k, v in report["split"].items()))
    report["profile"] = profile_forward(forward, fwd["median_s"],
                                        f"{what} forward")
    del net, state
    report["reference"] = check_fusion_reference(cfg, dev, kind, batch)
    report["reference64"] = check_fusion_forward64(dev, kind)
    return counts, report, roi


def check_fusion_reference(cfg, dev, kind, batch):
    """One fp32 example (pair) of the phase's input through the fusion
    model card (kernels) against CPU (plain versions) from the same seeded
    weights: the two-stage kinds by `check_refine_reference` (stage 1 end
    to end, then the proposals, both crops, the head and predict's NMS on
    the card's inputs); the one-stage model's forward (box, class and
    direction predictions, the fused map) within PRED_TOL and predict's
    rotated NMS on the same candidates equal."""
    what, build, _, _, pairs, two = FUSION_KINDS[kind]
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    one = {k: v[:1] for k, v in batch.items()}
    if two:
        def stage1(net, one, device):
            vox = fusion_voxelize(kind)(vspec, one, device)[0]
            if kind == "tmpf":
                return net.stage1(*vox, *[one[k] for k in ZSLICE_KEYS])
            return net.stage1(*[vox[k] for k in (
                "voxels", "num_points", "coordinates", "voxel_valid")],
                *[one[k] for k in PROJECTION_KEYS])
        return check_refine_reference(
            cfg, dev, what, build, stage1, "gated_bev_feat", one,
            one["anchors"], concat_key="gated_concat_feat")
    cpu = torch.device("cpu")
    outs = {}
    for device in (dev, cpu):
        net, spec = build(cfg.model, device)[:2]
        b = {k: v.to(device) for k, v in one.items()}
        with torch.no_grad():
            vox = device_voxelize(vspec, b["points"], b["points_mask"],
                                  device)
            t0 = time.perf_counter()
            preds = fusion_forward(kind, net, vox, b)
            secs = time.perf_counter() - t0
            with recording([(nms_ops, "nms")]) as calls:
                predict(spec, preds, b["anchors"])
        outs[device.type] = (preds, calls["nms"][0], secs)
    errs = {}
    for k in ("box_preds", "cls_preds", "dir_cls_preds",
              "gated_concat_feat"):
        if k not in outs["cpu"][0]:
            continue
        a, h = outs["cuda"][0][k].cpu(), outs["cpu"][0][k]
        errs[k] = (a - h).abs().max().item()
        if not torch.allclose(a, h, **PRED_TOL):
            fail(f"{what} reference: {k} card vs CPU max abs err "
                 f"{errs[k]:.3g} over {PRED_TOL}")
    args, kwargs = outs["cuda"][1]
    sel_c, keep_c = nms_ops.nms(*args, **kwargs)
    sel_h, keep_h = nms_ops.nms(*[a.cpu() for a in args], **kwargs)
    if not (torch.equal(sel_c.cpu(), sel_h) and
            torch.equal(keep_c.cpu(), keep_h)):
        fail(f"{what} reference: predict's rotated NMS differs card vs CPU "
             f"on the same candidates")
    say(f"{what} reference (fp32, 1 example, card vs CPU; the CPU's forward "
        f"in {outs['cpu'][2]:.1f} s): " +
        ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
        f"; predict's rotated NMS equal on the same candidates "
        f"({int(keep_c.sum())} kept)")
    return dict(cpu_s=outs["cpu"][2], errs=errs, kept=int(keep_c.sum()))


def _flat_outputs(preds, prefix=""):
    out = {}
    for k, v in preds.items():
        if isinstance(v, dict):
            out.update(_flat_outputs(v, f"{prefix}{k}."))
        elif torch.is_tensor(v):
            out[prefix + k] = v.detach().cpu()
    return out


def check_fusion_forward64(dev, kind):
    """The fusion model `kind` in fp64 on one example (pair) of the
    PointPillars config (the sparse kernels take no fp64; full width, its
    fusion RPN, REF_IMAGE_HW camera canvas, TWO_STAGE_REF_PROPOSALS
    proposals drawn from the positive anchors and a hundredth of the
    others), card (kernels) against CPU (plain versions) from the same
    seeded weights, in train mode without grad (the norms on the batch's
    statistics: a random PointPillars model's eval outputs overflow,
    `calibrate_norms_`): every float output within REF64_TOL of its
    scale, every integer and boolean output (the proposals) equal."""
    what, build_fn, _, _, pairs, _ = FUSION_KINDS[kind]
    cfg = load_pipeline_config(PP_CONFIG)
    cpu = torch.device("cpu")
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     cfg.train_input_reader
                                     .max_number_of_voxels)
    outs = {}
    for device in (dev, cpu):
        net, spec, info, assigner, _ = build_fn(
            cfg.model, device, 0, TWO_STAGE_REF_PROPOSALS)
        net.double().train()
        if device == dev:
            one = {k: v.double() if v.is_floating_point() else v
                   for k, v in fusion_train_inputs(
                       cfg, assigner, info, cpu, 1, PP_POINTS, pairs,
                       REF_IMAGE_HW).items()}
            g = torch.Generator().manual_seed(0)
            one["anchors_mask"] = (one["labels"] > 0) | (torch.rand(
                one["labels"].shape, generator=g) < 0.01)
        b = {k: v.to(device) for k, v in one.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            vox = fusion_voxelize(kind)(vspec, b, device)[0]
            outs[device.type] = _flat_outputs(
                fusion_forward(kind, net, vox, b))
        outs[device.type + "_s"] = time.perf_counter() - t0
    c, h = outs["cuda"], outs["cpu"]
    if set(c) != set(h):
        fail(f"{what} fp64 reference: outputs {sorted(c)} vs {sorted(h)}")
    worst = 0.0
    for k, want in h.items():
        got = c[k]
        if want.is_floating_point():
            e = errors(got, want)[1]
            worst = max(worst, e)
            if not e <= REF64_TOL:
                fail(f"{what} fp64 reference: {k} {e:.3g} of its scale "
                     f"apart card vs CPU, over {REF64_TOL}")
        elif not torch.equal(got, want):
            fail(f"{what} fp64 reference: {k} differs card vs CPU")
    say(f"{what} fp64 forward reference (PointPillars config, 1 "
        f"{'pair' if pairs else 'example'}, camera {REF_IMAGE_HW}, train "
        f"mode, card vs CPU; the CPU's forward in {outs['cpu_s']:.1f} s): "
        f"{len(h)} outputs, floats within {worst:.2e} of their scale, "
        f"integers and masks equal")
    return dict(cpu_s=outs["cpu_s"], worst=worst, outputs=len(h))


def run_fusion_train(dev, timer, dtimer, kind):
    """The train step of the fusion model `kind` (its steps maker, fp32,
    the config's Adam) on TRAIN_BATCH synthetic scans (pairs for tmpf)
    with camera images on the KITTI canvas, TRAIN_VOXELS voxels a frame
    (shuffle_overflow). Returns (the launch counts, the report,
    {channels: ROI-align aggregates})."""
    what, build, make_steps, _, pairs, two = FUSION_KINDS[kind]
    report = {}
    cfg = load_pipeline_config(CONFIG)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, None,
                                                  build=build)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     TRAIN_VOXELS, shuffle_overflow=True)
    batch = fusion_train_inputs(cfg, assigner, info, dev, TRAIN_BATCH,
                                pairs=pairs)
    step = make_steps(spec, vspec)[0]
    loss_of, voxelize = fusion_loss_of(kind), fusion_voxelize(kind)
    say(f"{what} train: batch {TRAIN_BATCH} synthetic "
        f"{'pairs' if pairs else 'scans'} with camera images "
        f"{FUSION_IMAGE_HW}, {TRAIN_VOXELS} voxels a frame "
        f"(shuffle_overflow), fp32 as in JAX, positive anchors "
        f"{(batch['labels'] > 0).sum(1).tolist()}")

    with recording(RECORDED_2ST_TRAIN) as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(f"{what} train capture: {n}; loss {float(metrics['loss']):.4f}")
    want_n = {"gather_gemm": SPARSE_CONVS,
              "gather_gemm_dgrad": SPARSE_CONVS - 1,
              "sparse_wgrad": SPARSE_CONVS,
              "roi_align_fwd": 2 if two else 0,
              "roi_align_bwd": 2 if two else 0,
              "standup_overlap": 1 if two else 0,
              "nms_suppress": 1 if two else 0}
    if n != want_n:
        fail(f"{what} train: recorded {n}, expected {want_n}")
    if pairs:
        check_folded(calls, 2 * TRAIN_BATCH, f"{what} train")
    check_step_calls(f"{what} train", calls, timer, dtimer, timed=False)
    report["fp64_ratio"] = check_fp32_calls(calls, f"{what} train")
    roi = {}
    if two:
        roi = check_roi_by_channels(calls["roi_align_fwd"],
                                    calls["roi_align_bwd"], timer, dtimer,
                                    f"{what} train")
        report["roi_align"] = {C: {n: {k: a[k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "err")
            + (("scratch_bytes", "partials_bytes")
               if n == "roi_align_bwd" else ())}
            for n, a in aggs.items()} for C, aggs in roi.items()}
        report["standup"] = check_standup_calls(
            calls["standup_overlap"], calls["nms_suppress"], timer, dtimer,
            f"{what} train")
    del calls

    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one {what} train step: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS,
            "sparse_gather_gemm_dgrad": SPARSE_CONVS - 1,
            "sparse_wgrad": SPARSE_CONVS,
            "roi_align_fwd": 2 if two else 0,
            "roi_align_bwd": 2 if two else 0,
            "standup_overlap": 1 if two else 0,
            "nms_suppress": 1 if two else 0, "rotated_iou": 0, "d3_iou": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"{what} train step launches {counts}, expected {want}")
    want_paths = {"mma": 0, "fma": 2 * SPARSE_CONVS - 1, "wgrad_mma": 0,
                  "wgrad_fma": SPARSE_CONVS}
    if paths != want_paths:
        fail(f"{what} train step: sparse kernels by path {paths}, expected "
             f"{want_paths}")
    params = dict(state.module.named_parameters())
    for name, p in params.items():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"{what} {name}: gradient missing or not finite")
    nonzero = {
        "fusion": ("rpn.fpn18.stem.weight", "rpn.crop_gate.conv.weight",
                   "rpn.depth_refine0.conv.weight", "middle.subm.0.weight",
                   "rpn.conv_cls.weight"),
        "fusion_2st": ("stage1.rpn.fpn18.stem.weight",
                       "stage1.rpn.crop_gate.conv.weight",
                       "second_rpn.cls_tower.convs.0.weight",
                       "second_rpn.conv_box_second.weight",
                       "stage1.middle.subm.0.weight"),
        "tmpf": ("bev_fusion.conv_gating_bev.weight",
                 "rpn.concat_compress.weight",
                 "second_rpn.cls_tower.convs.0.weight",
                 "second_rpn.conv_box_second.weight",
                 "middle.subm.0.weight"),
    }[kind]
    for name in nonzero:
        if not params[name].grad.abs().max() > 0:
            fail(f"{what} {name}: gradient all zero")
    if kind == "tmpf" and any(p.grad.any() for n, p in params.items()
                              if n.startswith("rpn.fpn18.")):
        fail(f"{what}: a gradient reached the FPN, which JAX stops")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"{what} train metrics not finite: {m}")
    report["metrics"], report["launches"] = m, counts
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the {what} train step synchronised the host {n_syncs} times")
    say(f"{what} train step: no host sync; every gradient finite, "
        f"{', '.join(nonzero)} nonzero" +
        ("; the FPN's zero (JAX's stop_gradient)" if kind == "tmpf" else "")
        + "; " + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    check_determinism(state, spec, vspec, batch, what, loss_of, voxelize)
    report["speed"], report["profile"] = timed_steps(
        step, state, spec, vspec, batch, FUSION_TIMED, f"{what} train",
        loss_of=loss_of, voxelize=voxelize)
    state.module.train()
    report["forward_split"] = fusion_split(kind, state.module, spec, vspec,
                                           batch, dev)
    say(f"{what} train: one train-mode forward split: " + ", ".join(
        f"{k} {v:.2f}" for k, v in report["forward_split"].items()))
    del state
    report["overfit"] = check_overfit(cfg, dev, None, step, batch, what,
                                      build=build)
    torch.backends.cudnn.deterministic = False
    report["reference64"] = check_2st_train_reference(
        dev, what, build, make_steps,
        lambda c, a, i, d, n, mp: fusion_train_inputs(
            c, a, i, d, n, mp, pairs, REF_IMAGE_HW),
        "second_num_pos" if two else "num_pos")
    return counts, report, roi


def run_tracking_phase(dev):
    """Tracking-by-detection on the card (`train/run_tracking.py`, the CLI's
    defaults: synthetic sequences of 4 frames, 16 detections, feature dim
    128): train TRACK_STEPS steps, then `evaluate` with the simple and
    the memory tracker, in 3-frame windows, and with the camera crops;
    the `SequenceTrackNet` forward card against CPU from the same weights;
    steps/s of the train step on one prepared sequence; `nms_vid` on
    random detections card against CPU. Returns the report."""
    import tempfile
    from second_tpu_torch.models.tracking_train import nms_vid
    from second_tpu_torch.train import run_tracking as rt
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--model_dir", str(Path(tmp) / "trk"), "--num_sequences",
                "4"]
        t0 = time.perf_counter()
        rt.main(["train", *args, "--steps", str(TRACK_STEPS)])
        report["train_s"] = time.perf_counter() - t0
        runs = {"simple": [], "memory": ["--tracker", "memory"],
                "window3": ["--window", "3"], "camera": ["--camera"]}
        for name, extra in runs.items():
            summary = rt.main(["evaluate", *args, *extra])
            if not {"mota", "motp", "id_switches"} <= set(summary) or \
                    not np.isfinite(summary["mota"]):
                fail(f"tracking evaluate ({name}): {summary}")
            report[name] = summary
        say(f"tracking: {TRACK_STEPS} train steps in {report['train_s']:.1f} "
            f"s; CLEAR-MOT " + "; ".join(
                f"{n} mota {report[n]['mota']:.3f} id_switches "
                f"{report[n]['id_switches']:.0f}" for n in runs))
        tr = rt.TrackingTrainer(Path(tmp) / "speed", device=dev)
        arrays = tr._prep_item(0)
        batch = tr._tensors(arrays)
        net_h = copy.deepcopy(tr.net).cpu()
        with torch.no_grad():
            out_c = tr.net(batch["crops"], batch["points"], batch["pmask"])
            out_h = net_h(*(torch.as_tensor(arrays[k]) for k in (
                "crops", "points", "pmask")))
        errs = {}
        for k, v in out_h.items():
            errs[k] = (out_c[k].cpu() - v).abs().max().item()
            if not torch.allclose(out_c[k].cpu(), v, **PRED_TOL):
                fail(f"tracking: SequenceTrackNet {k} card vs CPU max abs "
                     f"err {errs[k]:.3g}")
        for _ in range(2):
            tr.train_step(batch)
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        syncs = host_syncs(lambda: tr.train_step(batch))
        report.update(forward_errs=errs, step_median_s=med,
                      steps_per_s=1 / med, host_syncs=syncs,
                      peak_mem_bytes=torch.cuda.max_memory_allocated())
        say(f"tracking: SequenceTrackNet forward card vs CPU within "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
            f"; train steps/s {1 / med:.3f} (median {1e3 * med:.2f} ms of "
            f"{TIMED_STEPS} steps on one prepared sequence, "
            f"{1e3 * min(times):.2f}-{1e3 * max(times):.2f}); peak memory "
            f"{report['peak_mem_bytes'] / 2 ** 30:.3f} GiB; {syncs} host "
            f"syncs in a step")
    rng = np.random.default_rng(7)
    n = 512
    ctr = rng.uniform(0, 40, (n, 2))
    boxes = np.concatenate([ctr, np.full((n, 1), -1.7),
                            rng.uniform(1.5, 4, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))],
                           1).astype(np.float32)
    cls = rng.normal(0, 2, (n, 1)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    reset_counts()
    got = nms_vid(*(torch.as_tensor(a, device=dev)
                    for a in (boxes, cls, valid)))
    torch.cuda.synchronize()
    counts = launch_counts()
    want = nms_vid(*map(torch.as_tensor, (boxes, cls, valid)))
    if counts["rotated_iou"] != 1 or counts["nms_suppress"] != 1:
        fail(f"tracking nms_vid launched {counts}")
    if not torch.equal(got[2].cpu(), want[2]) or not torch.allclose(
            got[0].cpu()[want[2]], want[0][want[2]], **DET_TOL):
        fail("tracking: nms_vid differs card vs CPU")
    report["nms_vid_kept"] = int(want[2].sum())
    say(f"tracking: nms_vid on {n} card detections equal to the CPU's "
        f"({report['nms_vid_kept']} kept; nms_overlap and nms_suppress once "
        f"each)")
    return report


# ------------------------------------- serving, detector tracking, joint

# the serve phase: requests (distinct `lidar_scan_scene` clouds, seeds
# 0..SERVE_REQUESTS-1) sent by SERVE_CLIENTS client threads to
# `build_server(port=0, max_batch=SERVE_MAX_BATCH, window_ms=SERVE_WINDOW_MS)`
SERVE_REQUESTS, SERVE_CLIENTS = 64, 8
SERVE_MAX_BATCH, SERVE_WINDOW_MS = 8, 5.0
# an answer's boxes and scores are rounded to 4 decimals by the server
ANSWER_ROUNDING = 5e-5
# the trk-det phase's train steps and evaluated sequences; the joint
# phase's window (frames) and detections a frame
TRK_DET_STEPS, TRK_DET_EVAL_SEQUENCES = 3, 2
JOINT_FRAMES, JOINT_DETS = 4, 16
# the joint step's recorded calls: the temporal step's and the det↔gt
# rotated-IoU matrix
RECORDED_JOINT = RECORDED_2ST_TRAIN + [(riou, "riou_matrix")]


def answer_diff(det, ref):
    """(keep set differs, largest abs difference of boxes and scores) of
    one cloud's detections against its reference."""
    if len(det["scores"]) != len(ref["scores"]) or \
            list(det["class_names"]) != list(ref["class_names"]):
        return True, 0.0
    if not len(ref["scores"]):
        return False, 0.0
    return False, float(max(
        np.abs(np.asarray(det["boxes"], np.float64) - ref["boxes"]).max(),
        np.abs(np.asarray(det["scores"], np.float64) - ref["scores"]).max()))


def serve_clouds(cfg):
    """SERVE_REQUESTS distinct fhd bench scans (seeds 0..), float32 [P, 4]."""
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    return [lidar_scan_scene(np.random.default_rng(s), pc_range=pc_range,
                             num_azimuth=512)[0].astype(np.float32)
            for s in range(SERVE_REQUESTS)]


def http_json(url, data=None, ctype="application/json"):
    """(status, decoded JSON) of one request to the local server."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": ctype} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run_serve(dev, timer, dtimer, tmp):
    """The detection server (`serve.build_server`) on the card with
    second_car_fhd.config, fp32 as `InferenceContext` builds it (JAX's
    `build_voxelnet(cfg.model)`), over the checkpoint of a 2-step port
    `Trainer` written here, max_points MAX_POINTS: every kernel call of a
    batch-8 forward against its plain version (and fp64), the reference
    (each cloud alone through `InferenceContext.inference`) and its noise
    across batch sizes 1-8 on the card, SERVE_REQUESTS octet-stream
    requests from SERVE_CLIENTS threads (each answer against its cloud's
    reference: keep sets equal but for as many flips as the batch-size
    sweep showed, boxes and scores within the rounding and twice the
    sweep's difference), the launches of the served batches, requests/s
    and /stats' batch histogram and latency quantiles, one JSON request
    and two malformed ones. Returns (the launch counts of the served
    requests, the checkpoint's directory, the report)."""
    import threading
    from second_tpu_torch.serve import build_server
    from second_tpu_torch.train.run import Trainer
    report = {}
    model_dir = tmp / "serve_model"
    tr = Trainer(CONFIG, model_dir, synthetic=True, dataset_size=8,
                 max_points=MAX_POINTS, total_steps=2,
                 patches=["train_config.steps_per_eval=0"], device=dev)
    try:
        tr.train(2)
    finally:
        tr.logger.close()
    del tr
    t0 = time.perf_counter()
    server, batcher = build_server(CONFIG, model_dir, port=0,
                                   max_batch=SERVE_MAX_BATCH,
                                   window_ms=SERVE_WINDOW_MS,
                                   max_points=MAX_POINTS, device=dev)
    report["build_s"] = time.perf_counter() - t0
    ctx = batcher.ctx
    if ctx.restored_step != 2 or any(p.dtype != torch.float32 for p in
                                     ctx.module.parameters()):
        fail(f"serve: restored step {ctx.restored_step} (want 2) or the "
             f"net not fp32")
    clouds = serve_clouds(ctx.cfg)
    sizes = [len(c) for c in clouds]
    say(f"serve: second_car_fhd.config fp32 from the Trainer's step-2 "
        f"checkpoint (built and warmed in {report['build_s']:.1f} s); "
        f"{SERVE_REQUESTS} scans of {min(sizes)}-{max(sizes)} points "
        f"({sum(s > MAX_POINTS for s in sizes)} above max_points "
        f"{MAX_POINTS})")
    try:
        # the kernel calls of one batch-8 forward against their plain
        # versions
        with recording() as calls:
            ctx.inference_batch(clouds[:SERVE_MAX_BATCH])
            torch.cuda.synchronize()
        check_calls_exact(calls, "serve")
        report["fp64_ratio"] = check_fp32_calls(calls, "serve")
        check_nms_pair(calls, timer, dtimer, "serve")
        del calls

        # the reference, each cloud alone, and its noise across batch sizes
        refs = [ctx.inference(c) for c in clouds]
        sweep_err, sweep_flips = 0.0, 0
        batches = [clouds[i:i + SERVE_MAX_BATCH]
                   for i in range(0, SERVE_REQUESTS, SERVE_MAX_BATCH)]
        batches += [clouds[:b] for b in range(2, SERVE_MAX_BATCH)]
        offsets = list(range(0, SERVE_REQUESTS, SERVE_MAX_BATCH)) + \
            [0] * (SERVE_MAX_BATCH - 2)
        for off, batch in zip(offsets, batches):
            for i, det in enumerate(ctx.inference_batch(batch)):
                flip, err = answer_diff(det, refs[off + i])
                sweep_flips += flip
                sweep_err = max(sweep_err, err)
        tol = ANSWER_ROUNDING + 2 * sweep_err + 1e-6
        kept = [len(r["scores"]) for r in refs]
        say(f"serve reference: {SERVE_REQUESTS} clouds alone, "
            f"{min(kept)}-{max(kept)} detections kept; batch sizes 2-"
            f"{SERVE_MAX_BATCH} against 1: largest difference "
            f"{sweep_err:.3g}, {sweep_flips} keep sets differ; answers held "
            f"within {tol:.3g}")

        port = server.server_address[1]
        url = f"http://127.0.0.1:{port}"
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        serving.start()
        answers = [None] * SERVE_REQUESTS

        def client(k):
            for i in range(k, SERVE_REQUESTS, SERVE_CLIENTS):
                answers[i] = http_json(f"{url}/v1/detect",
                                       clouds[i].tobytes(),
                                       "application/octet-stream")

        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        reset_counts()
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts, paths = launch_counts(), conv_path_counts()
        _, stats = http_json(f"{url}/stats")
        flips, worst = 0, 0.0
        for i, ((code, out), ref) in enumerate(zip(answers, refs)):
            if code != 200 or out["status"] != "ok":
                fail(f"serve request {i}: {code} {out}")
            det = {"boxes": np.asarray(out["boxes"]).reshape(-1, 7),
                   "scores": np.asarray(out["scores"]),
                   "class_names": out["class_names"]}
            if out["num_detections"] != len(out["scores"]):
                fail(f"serve request {i}: num_detections "
                     f"{out['num_detections']} for {len(out['scores'])}")
            flip, err = answer_diff(det, ref)
            flips += flip
            worst = max(worst, err)
        if flips > sweep_flips or worst > tol:
            fail(f"serve: {flips} answers' keep sets differ from their "
                 f"cloud's alone (the sweep: {sweep_flips}), the largest "
                 f"difference {worst:.3g} (tolerance {tol:.3g})")
        hist = {int(k): v for k, v in stats["batch_hist"].items()}
        nb = stats["batches"]
        if stats["requests"] != SERVE_REQUESTS or \
                sum(k * v for k, v in hist.items()) != SERVE_REQUESTS or \
                max(hist) < 2:
            fail(f"serve /stats: {stats} (want {SERVE_REQUESTS} requests "
                 f"and a batch larger than 1)")
        want = {"sparse_gather_gemm": SPARSE_CONVS * nb, "rotated_iou": nb,
                "nms_suppress": nb, "sparse_gather_gemm_dgrad": 0,
                "sparse_wgrad": 0, "d3_iou": 0, "roi_align_fwd": 0,
                "roi_align_bwd": 0, "standup_overlap": 0}
        if {k: counts[k] for k in want} != want or not counts["row_gather"] \
                or paths["fma"] != SPARSE_CONVS * nb:
            fail(f"serve: launches {counts} by path {paths} for {nb} "
                 f"batches, expected {want} on the fp32 path")
        lat = stats["latency_ms"]
        report.update(requests=SERVE_REQUESTS, clients=SERVE_CLIENTS,
                      wall_s=wall, requests_per_s=SERVE_REQUESTS / wall,
                      stats=stats, flips=flips, sweep_flips=sweep_flips,
                      worst_diff=worst, sweep_diff=sweep_err, tolerance=tol,
                      launches=counts)
        say(f"serve: {SERVE_REQUESTS} octet-stream requests from "
            f"{SERVE_CLIENTS} clients in {wall:.3f} s: requests/s "
            f"{SERVE_REQUESTS / wall:.3f}; {nb} batches, histogram "
            f"{dict(sorted(hist.items()))}; latency p50 {lat['p50']} p90 "
            f"{lat['p90']} p99 {lat['p99']} ms (/stats); every answer "
            f"its cloud's alone ({flips} keep sets differ, largest "
            f"difference {worst:.3g}); launches {counts} ({card_line()})")

        one = clouds[0][:2000].round(3)
        code, out = http_json(f"{url}/v1/detect", json.dumps(
            {"points": one.tolist()}).encode())
        flip, err = answer_diff(
            {"boxes": np.asarray(out.get("boxes", [])).reshape(-1, 7),
             "scores": np.asarray(out.get("scores", [])),
             "class_names": out.get("class_names", [])},
            ctx.inference(one)) if code == 200 else (True, 0.0)
        if flip or err > tol:
            fail(f"serve JSON request: {code}, keep differs {flip}, "
                 f"difference {err:.3g}")
        for body, ctype in ((b"\x00" * 10, "application/octet-stream"),
                            (b"{not json", "application/json")):
            code, out = http_json(f"{url}/v1/detect", body, ctype)
            if code != 400 or out.get("status") != "error":
                fail(f"serve malformed request: {code} {out}")
        code, health = http_json(f"{url}/healthz")
        if code != 200 or health["classes"] != ["Car"]:
            fail(f"serve /healthz: {code} {health}")
        say("serve: a JSON request answered as its cloud alone, two "
            "malformed ones 400 with their error, /healthz ok")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    return counts, model_dir, report


def run_trk_det(dev, timer, dtimer, detector_dir, tmp):
    """Tracking a detector's detections on the card:
    `TrackingTrainer(detector_config=second_car_fhd.config,
    detector_dir=<the serve phase's checkpoint>)` on synthetic sequences
    (4 frames, 16 detections): one sequence's detections, one
    `inference_batch`, against the detector's own output through
    `nms_vid`, their kernel calls against the plain versions, the prepared
    sequence carrying them; TRK_DET_STEPS train steps (finite losses) and
    an evaluation over TRK_DET_EVAL_SEQUENCES sequences (finite MOTA);
    the detector's launches, 14 gather-GEMMs and one NMS pair a sequence.
    Returns (the launch counts of the steps and the evaluation, the
    report)."""
    from second_tpu_torch.data.tracking import nms_vid
    from second_tpu_torch.train.run_tracking import TrackingTrainer
    report = {}
    t0 = time.perf_counter()
    tr = TrackingTrainer(tmp / "trk_det", detector_config=CONFIG,
                         detector_dir=detector_dir,
                         detector_max_points=MAX_POINTS, device=dev)
    report["build_s"] = time.perf_counter() - t0
    if tr.det_ctx.restored_step != 2:
        fail(f"trk-det: the detector restored step "
             f"{tr.det_ctx.restored_step}, not the serve checkpoint's 2")
    frames = tr._sequence(0)
    with recording() as calls:
        dets = tr._detections(frames)
        torch.cuda.synchronize()
    check_calls_exact(calls, "trk-det")
    check_nms_pair(calls, timer, dtimer, "trk-det")
    del calls
    want = [nms_vid(d["boxes"], d["scores"]) for d in
            tr.det_ctx.inference_batch([f["points"] for f in frames])]
    n = [len(s) for _, s in dets]
    if [len(s) for _, s in want] != n or not sum(n) or not all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(dets, want)):
        fail(f"trk-det: the sequence's detections {n} are not the "
             f"detector's through nms_vid ({[len(s) for _, s in want]})")
    arrays = tr.prep(frames, np.random.default_rng(0), detections=dets)
    D = arrays["det_valid"].shape[1]
    for t, (boxes, scores) in enumerate(dets):
        k = min(len(scores), D)
        order = np.argsort(-scores)[:D] if len(scores) > D else \
            np.arange(k)
        if arrays["det_valid"][t].sum() != k or not np.array_equal(
                arrays["det_boxes"][t, :k], boxes[order]):
            fail(f"trk-det: frame {t}'s prepared detections are not the "
                 f"detector's")
    reset_counts()
    t0 = time.perf_counter()
    res = tr.train(TRK_DET_STEPS, log_every=1)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = tr.evaluate(TRK_DET_EVAL_SEQUENCES)
    eval_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    forwards = TRK_DET_STEPS + TRK_DET_EVAL_SEQUENCES
    if not (np.isfinite(res["first_loss"]) and
            np.isfinite(res["last_loss"]) and np.isfinite(summary["mota"])):
        fail(f"trk-det: losses {res}, MOTA {summary.get('mota')}")
    if counts["sparse_gather_gemm"] != SPARSE_CONVS * forwards or \
            counts["rotated_iou"] != forwards or \
            counts["nms_suppress"] != forwards:
        fail(f"trk-det: launches {counts}, expected {SPARSE_CONVS} sparse "
             f"convs and one NMS pair in each of {forwards} detector "
             f"forwards")
    report.update(detections=n, losses=res, mota=summary, train_s=train_s,
                  eval_s=eval_s, launches=counts)
    say(f"trk-det: the step-2 detector's detections ({n} a frame after "
        f"nms_vid) on sequence 0, equal to its own output; {TRK_DET_STEPS} "
        f"steps in {train_s:.1f} s, losses {res['first_loss']:.4f} -> "
        f"{res['last_loss']:.4f}; evaluate on {TRK_DET_EVAL_SEQUENCES} "
        f"sequences in {eval_s:.1f} s: mota {summary['mota']:.3f} motp "
        f"{summary['motp']:.3f} id_switches {summary['id_switches']:.0f}; "
        f"launches {counts}")
    return counts, report


def check_riou_matrix_calls(calls, timer, dtimer, what):
    """Each recorded `riou_matrix` call against its plain version, timed
    beside it, with its bound counted from this call's boxes: every pair's
    clip as the plain version clips it (`riou_ops`), each box's corners,
    the boxes in and the matrix out. No PyTorch call computes it. The IoU
    is held within RIOU_TOL at every pair of boxes with a finite, positive
    area; a pair with a box of zero area (the zero boxes of the padded gt
    slots, which the caller masks out) has no IoU: the clip keeps all of
    the other box and the union rounds to 0, so both versions divide
    rounding noise by the clamp; those pairs are counted, not compared.
    Returns the aggregate."""
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=None, device_ms=0.0,
               library_device_ms=None, bytes_s=0.0, ops_s=0.0, err=0.0)
    for i, (args, _) in enumerate(calls):
        b1, b2 = args[0], args[1]
        crit = args[2] if len(args) > 2 else -1
        got = riou.riou_matrix(b1, b2, crit)
        want = riou.riou_matrix_plain(b1, b2, crit)
        torch.cuda.synchronize()

        def proper(b):
            area = b[:, 2] * b[:, 3]
            return torch.isfinite(b).all(1) & torch.isfinite(area) & \
                (area > 0)
        defined = proper(b1)[:, None] & proper(b2)[None, :]
        err = errors(got[defined], want[defined])[0]
        if err > RIOU_TOL or not torch.isfinite(got[defined]).all():
            fail(f"{what} riou_matrix {i}: max abs err {err:.3g} over the "
                 f"pairs of boxes with an area")
        N, K = b1.shape[0], b2.shape[0]
        ii = torch.arange(N, device=b1.device).repeat_interleave(K)
        jj = torch.arange(K, device=b1.device).repeat(N)
        ops = riou_ops(b1, b2, ii, jj) + (N + K) * RIOU_BOX_OPS
        nbytes = (N + K) * 5 * 4 + N * K * 4
        fns = [lambda: riou.riou_matrix(b1, b2, crit),
               lambda: riou.riou_matrix_plain(b1, b2, crit)]
        ms, pms = timer(fns[0], 20), timer(fns[1], 5)
        dev_ms = dtimer(fns[:1])[0]
        agg["ms"] += ms
        agg["plain_ms"] += pms
        agg["device_ms"] += dev_ms
        agg["bytes_s"] += nbytes / HBM_BYTES_PER_S
        agg["ops_s"] += ops / PEAK_OPS_PER_S[torch.float32]
        agg["err"] = max(agg["err"], err)
        say(f"{what} riou_matrix {i} [{N}, 5] x [{K}, 5]: err {err:.2e} "
            f"over {int(defined.sum())} pairs of boxes with an area "
            f"({int((~defined).sum())} with a zero-area box not compared), "
            f"{int((want[defined] > 0).sum())} overlapping; kernel "
            f"{ms:.4f} ms "
            f"(device {dev_ms:.4f})  plain {pms:.4f} ms  bound "
            f"{1e3 * max(agg['bytes_s'], agg['ops_s']):.6f} ms")
    return agg


def joint_grads(jt, batch, key="loss"):
    """The gradients of one loss term of the joint trainer's module on one
    window (train mode), without an optimizer step."""
    jt.optimizer.zero_grad()
    with torch.enable_grad():
        losses = jt.loss(batch)
        losses[key].backward()
    return {n: None if p.grad is None else p.grad.detach().clone()
            for n, p in jt.module.named_parameters()}, losses


def joint_split(jt, batch):
    """One joint step split at its stage boundaries (synchronised ms):
    voxelize, the detector (both stages on the window's 8 frames), the
    tracking half (`JointDetTrack.track`: selection, crops, point sets,
    heads), the loss, backward, the optimizer."""
    from second_tpu_torch.models import joint_track
    from second_tpu_torch.models.temporal import _FRAME_KEYS
    split, mod = {}, jt.module

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] = 1e3 * (time.perf_counter() - t0)
        return out
    frames = timed("voxelize_ms", lambda: jt.frames(batch))
    mod.train()
    jt.optimizer.zero_grad()
    cur = {k: frames[k] for k in _FRAME_KEYS}
    prev = {k: torch.cat([v[:1], v[:-1]], 0) for k, v in cur.items()}
    with torch.enable_grad():
        preds = timed("detector_ms", lambda: mod.detector(
            cur, prev, batch["anchors"]))
        preds = timed("tracking_ms", lambda: mod.track(
            preds, frames, batch["anchors"]))
        losses = timed("loss_ms", lambda: joint_track.compute_joint_loss(
            jt.spec, preds, batch))
        timed("backward_ms", lambda: losses["loss"].backward())
    timed("optimizer_ms", jt.optimizer.step)
    return split


def run_joint_train(dev, timer, dtimer, tmp):
    """Joint detector + tracker training on the card (`JointTrainer`,
    `models/joint_track.py`) with second_car_fhd.config, fp32 as JAX
    builds it, JOINT_FRAMES-frame synthetic windows, JOINT_DETS detections
    a frame, the train reader's 16 000 voxels a frame, Adam: every sparse
    forward, dX and weight-gradient call (and fp64), the ROI-align forward
    and backward calls of both crop sizes (the proposals' 14 x 14 and the
    tracking crops' 16 x 16), the standup bitmask and the det↔gt
    `riou_matrix` call against their plain versions; launches (gather-GEMM
    14 with the window's 8 frames folded, dX 13, weight gradient 14, all
    fp32; roi_align_fwd 2, roi_align_bwd 2, standup_overlap 1,
    nms_suppress 1, rotated IoU 1: the matrix); every gradient finite, the
    tracking loss's gradient into the second stage nonzero; no host sync
    in a step; gradients bitwise equal over two runs; the loss halved on
    one window; steps/s, a split, peak memory; and the `detector_dir`
    graft of a temporal checkpoint. Returns (the launch counts of one
    step, the riou_matrix and 16 x 16 ROI-align aggregates, the report)."""
    from second_tpu_torch.train.checkpoint import CheckpointManager
    from second_tpu_torch.train.run_tracking import JointTrainer
    from second_tpu_torch.train.state import create_state
    report = {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    jt = JointTrainer(tmp / "joint", CONFIG, num_frames=JOINT_FRAMES,
                      num_dets=JOINT_DETS, device=dev)
    if not jt.cfg.train_config.enable_mixed_precision or \
            jt.module.detector.middle.dtype is not None or any(
                p.dtype != torch.float32 for p in jt.module.parameters()):
        fail("joint train: the model is not fp32 on a config that asks for "
             "mixed precision")
    batch = jt._window(1)
    say(f"joint train: {JOINT_FRAMES}-frame synthetic windows, "
        f"{JOINT_DETS} detections a frame, {jt.vspec.max_voxels} voxels a "
        f"frame, fp32 as in JAX, "
        f"{jt.module.detector.pspec.num_proposals} proposals a frame")

    with recording(RECORDED_JOINT) as calls:
        jt.train_step(batch)
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    want_n = {"gather_gemm": SPARSE_CONVS,
              "gather_gemm_dgrad": SPARSE_CONVS - 1,
              "sparse_wgrad": SPARSE_CONVS, "roi_align_fwd": 2,
              "roi_align_bwd": 2, "standup_overlap": 1, "nms_suppress": 1,
              "riou_matrix": 1}
    if n != want_n:
        fail(f"joint train: recorded {n}, expected {want_n}")
    check_folded(calls, 2 * JOINT_FRAMES, "joint train")
    check_step_calls("joint train", calls, timer, dtimer, timed=False)
    report["fp64_ratio"] = check_fp32_calls(calls, "joint train")
    by_size = {}
    for key in ("roi_align_fwd", "roi_align_bwd"):
        for c in calls[key]:
            size = c[0][1].shape[2] // c[0][-1]
            by_size.setdefault(size, {}).setdefault(key, []).append(c)
    if sorted(by_size) != [14, 16]:
        fail(f"joint train: ROI-align crop sizes {sorted(by_size)}, "
             f"expected 14 (proposals) and 16 (tracking)")
    roi = {s: check_roi_calls(c["roi_align_fwd"], c["roi_align_bwd"],
                              timer, dtimer, f"joint train {s}x{s}")
           for s, c in sorted(by_size.items())}
    report["roi_align"] = {f"{s}x{s}": {n_: {k: a[k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "err")}
        for n_, a in aggs.items()} for s, aggs in roi.items()}
    report["standup"] = check_standup_calls(
        calls["standup_overlap"], calls["nms_suppress"], timer, dtimer,
        "joint train")
    riou_agg = check_riou_matrix_calls(calls["riou_matrix"], timer, dtimer,
                                       "joint train")
    del calls

    reset_counts()
    losses = jt.train_step(batch)
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one joint train step: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": SPARSE_CONVS,
            "sparse_gather_gemm_dgrad": SPARSE_CONVS - 1,
            "sparse_wgrad": SPARSE_CONVS, "roi_align_fwd": 2,
            "roi_align_bwd": 2, "standup_overlap": 1, "nms_suppress": 1,
            "rotated_iou": 1, "d3_iou": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"joint train step launches {counts}, expected {want}")
    want_paths = {"mma": 0, "fma": 2 * SPARSE_CONVS - 1, "wgrad_mma": 0,
                  "wgrad_fma": SPARSE_CONVS}
    if paths != want_paths:
        fail(f"joint train step: sparse kernels by path {paths}, expected "
             f"{want_paths}")
    for name, p in jt.module.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"joint {name}: gradient missing or not finite")
    m = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"joint train losses not finite: {m}")
    n_syncs = host_syncs(lambda: jt.train_step(batch))
    if n_syncs:
        fail(f"the joint train step synchronised the host {n_syncs} times")
    tg, tl = joint_grads(jt, batch, "tracking_loss")
    second = sum(float(g.abs().sum()) for k, g in tg.items()
                 if k.startswith("detector.second_rpn.") and g is not None)
    backbone = float(tg["detector.middle.subm.0.weight"].abs().sum())
    if not second > 0 or not float(tg["w_det.Dense_0.weight"].abs().sum()):
        fail(f"joint train: the tracking loss's gradient into the second "
             f"stage {second}, into w_det "
             f"{float(tg['w_det.Dense_0.weight'].abs().sum())}")
    report.update(losses=m, launches=counts,
                  tracking_grad_second_stage=second,
                  tracking_grad_backbone=backbone)
    say(f"joint train step: no host sync; every gradient finite; the "
        f"tracking loss's gradient (|sum|) into the second stage "
        f"{second:.4g}, the sparse middle {backbone:.4g}; "
        + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    g1, _ = joint_grads(jt, batch)
    g2, _ = joint_grads(jt, batch)
    same = sum(torch.equal(g1[k], g2[k]) for k in g1 if g1[k] is not None)
    if same != sum(g is not None for g in g1.values()):
        fail(f"joint train: two backward passes from one state: "
             f"{len(g1) - same} gradients differ")
    say(f"joint train determinism: {same} gradients bitwise equal over two "
        f"runs")

    for _ in range(2):
        jt.train_step(batch)
    times = []
    for _ in range(TEMPORAL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jt.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    torch.cuda.reset_peak_memory_stats()
    jt.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    split = joint_split(jt, batch)
    report["speed"] = dict(median_s=med, steps_per_s=1 / med, times_s=times,
                           peak_mem_bytes=peak, **split)
    say(f"joint train steps/s {1 / med:.3f} (median {1e3 * med:.2f} ms of "
        f"{TEMPORAL_TIMED} {JOINT_FRAMES}-frame windows, "
        f"{1e3 * min(times):.2f}-{1e3 * max(times):.2f}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB; one split: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f" ({card_line()})")
    del jt

    fit = JointTrainer(tmp / "joint_fit", CONFIG, num_frames=JOINT_FRAMES,
                       num_dets=JOINT_DETS, lr=OVERFIT_LR, device=dev)
    fit_losses = []
    for _ in range(OVERFIT_STEPS):
        fit_losses.append(float(fit.train_step(batch)["loss"]))
        if fit_losses[-1] < 0.5 * fit_losses[0]:
            break
    if not fit_losses[-1] < 0.5 * fit_losses[0]:
        fail(f"joint overfit at lr {OVERFIT_LR}: the loss went "
             f"{fit_losses[0]:.4f} -> {fit_losses[-1]:.4f} in "
             f"{len(fit_losses)} steps, not below half")
    say(f"joint learning: Adam at lr {OVERFIT_LR} on one window, the loss "
        f"{fit_losses[0]:.4f} -> {fit_losses[-1]:.4f} (below half) in "
        f"{len(fit_losses)} steps")
    report["overfit"] = fit_losses
    del fit
    torch.backends.cudnn.deterministic = False

    # the --detector_dir graft: a temporal model's checkpoint, strictly
    cfg = load_pipeline_config(CONFIG)
    det_state = create_state(build_temporal(cfg.model, dev)[0],
                             cfg.train_config.optimizer, 1)
    CheckpointManager(tmp / "joint_detector").save(det_state, 1)
    graft = JointTrainer(tmp / "joint_graft", CONFIG,
                         detector_dir=tmp / "joint_detector",
                         num_frames=JOINT_FRAMES, num_dets=JOINT_DETS,
                         device=dev)
    want_sd = det_state.module.state_dict()
    if not graft.restored_detector or not all(
            torch.equal(v, want_sd[k])
            for k, v in graft.module.detector.state_dict().items()):
        fail("joint train: the temporal checkpoint did not graft into the "
             "detector")
    say("joint train: a temporal detector's checkpoint grafted into the "
        "detector (strict), every tensor equal")
    return counts, riou_agg, roi[16], report


# ------------------------------------- the other middles and encoders

# second_car_fhd.config with another middle or encoder, through the port's
# `apply_config_patches` (the `--patchs` of the train CLI): the residual
# middle, the 128-wide one, and VoxelFeatureExtractor [32, 128] into
# SpMiddleFHD (the middle's config width left at 4)
RESNET_PATCHES = ['model.middle_feature_extractor.module_class_name='
                  '"SpMiddleResNetFHD"']
LARGE_PATCHES = ['model.middle_feature_extractor.module_class_name='
                 '"SpMiddleFHDLarge"']
VFE1_PATCHES = ['model.voxel_feature_extractor.module_class_name='
                '"VoxelFeatureExtractor"',
                "model.voxel_feature_extractor.num_filters=[32, 128]"]
# VoxelFeatureExtractor [32, 256] into SpMiddleFHD: its first conv 256 -> 16
VFE256_PATCHES = VFE1_PATCHES[:1] + [
    "model.voxel_feature_extractor.num_filters=[32, 256]"]
# the wide convs phase: (C, D) on the fhd scene's stage rulebooks, and the
# 5 x 5 x 5 conv's widths on stage 0's sites
WIDE_PAIRS = ((256, 256), (200, 136))
K125_WIDTHS = (64, 64)
# SpMiddleResNetFHD's sparse convs a forward: in each of its four residual
# blocks one on the block's (bf16) input and one on the first norm's fp32
# output, then the block's bf16 strided conv
RESNET_CONVS = 12
RESNET_TIMED = 8
# the timed forwards of a phase run untimed by call (`run_middle_eval`'s
# `timed` False)
LIGHT_TIMED = 5
# the sparse-conv calls wider than 64 channels in or out, timed on their
# own under "<path>_c128" in the kernels line
WIDE = 64


def patched_config(patches):
    from second_tpu_torch.train.run import apply_config_patches
    return apply_config_patches(load_pipeline_config(CONFIG), patches)


def split_wide(calls):
    """(narrow, wide): the recorded sparse-conv calls (forward, dX or
    weight gradient: args[3] is [K, C, D] or [B, Q, D]) with at most and
    with more than WIDE channels in or out."""
    is_wide = [max(a[0].shape[2], a[3].shape[2]) > WIDE for a, _ in calls]
    return ([c for c, w in zip(calls, is_wide) if not w],
            [c for c, w in zip(calls, is_wide) if w])


def conv_widths(calls):
    return sorted({(a[0].shape[2], a[3].shape[2], str(a[0].dtype)[6:])
                   for a, _ in calls})


def run_middle_eval(dev, timer, dtimer, what, patches, n_convs,
                    paths_want, calibrate=False, timed=True, nms_cpu=False):
    """A middle or encoder of the registry on second_car_fhd.config patched
    by `patches`, in the model's precision (the config's mixed precision:
    bf16 where build_voxelnet gives the middle bf16, fp32 otherwise), batch
    4, 40 000 voxels, the fhd bench scene: every sparse conv against its
    plain version (CONV_TOL; fp32 also against fp64, FP32_ERR_RATIO) and
    timed, the row gathers exact and timed, the NMS pair against its plain
    version; launches (`n_convs` gather-GEMMs on `paths_want`, the NMS pair
    once); predict without a host sync; frames/s, peak memory and the
    device time by kernel. With `calibrate`, the random model's batch-norm
    statistics are the batch's (`calibrated`): an encoder with norms (as
    VoxelFeatureExtractor) under random statistics feeds the middle values
    of 1e4 and more, where fp32 sums in another order differ by more than
    CONV_TOL. With `timed` False, the convs and gathers are held against
    their plain versions untimed (`check_calls_exact`, the fp32 convs also
    against fp64), and no device split is taken: the aggregates are None.
    With `nms_cpu`, the forward's NMS call also runs on the CPU (the plain
    versions), its indices and keep mask equal to the card's. Returns (the
    aggregates of all the convs and of the wide ones, the launch counts,
    the report)."""
    report = {}
    cfg = patched_config(patches)
    mixed = cfg.train_config.enable_mixed_precision
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device=dev, mixed_precision=mixed, seed=0)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    points, mask, anchors = build_inputs(cfg, assigner, info, dev)
    if calibrate:
        calibrated(net, vspec, points, mask, dev)
    vfe_cfg = cfg.model.voxel_feature_extractor
    vfe_out = type(net.vfe).out_width(tuple(vfe_cfg.num_filters),
                                      cfg.model.num_point_features)
    say(f"{what}: {type(net.vfe).__name__} ({vfe_out} out) -> "
        f"{type(net.middle).__name__} ({net.middle.out_channels} BEV "
        f"channels, dtype {getattr(net.middle, 'dtype', None)}), batch "
        f"{BATCH}, {MAX_VOXELS} voxels, mixed precision {mixed}"
        + (", norm statistics calibrated on the batch" if calibrate else ""))

    def forward():
        return detect(net, spec, vspec, points, mask, anchors, device=dev)

    with recording() as calls:
        forward()
        torch.cuda.synchronize()
    convs = calls["gather_gemm"]
    report["widths"] = conv_widths(convs)
    say(f"{what} capture: " + ", ".join(
        f"{k} {len(v)} calls" for k, v in calls.items()) +
        f"; conv widths (C, D, dtype) {report['widths']}")
    if len(convs) != n_convs:
        fail(f"{what}: expected {n_convs} sparse convs a forward, recorded "
             f"{len(convs)}")
    agg = agg_wide = None
    if timed:
        # the convs up to WIDE channels, then the wider ones, each set
        # summed
        report["convs"] = []
        narrow, wide = split_wide(convs)
        agg = check_convs(narrow, timer, dtimer, report["convs"])
        if wide:
            agg_wide = check_convs(wide, timer, dtimer, report["convs"])
            say(f"{what}: the {len(wide)} convs wider than {WIDE} channels "
                f"{conv_widths(wide)} above; card {card_line()}")
            agg = {k: max(v, agg_wide[k]) if k in ("err", "fp64_ratio")
                   else v + agg_wide[k] for k, v in agg.items()}
        report["gathers"] = []
        check_gathers(calls["gather_rows"], timer, dtimer, report["gathers"])
    else:
        report["conv_err"] = check_calls_exact(calls, what)
        if any(a[0].dtype == torch.float32 for a, _ in convs):
            report["fp64_ratio"] = check_fp32_calls(calls, what, mixed=True)
    ov, sup, report["nms"] = check_nms_pair(calls, timer, dtimer, what)
    report["nms_kernels"] = {"rotated_iou": ov, "nms_suppress": sup}
    if nms_cpu:
        (args, kwargs), = calls["nms"]
        got = nms_ops.nms(*args, **kwargs)
        want = nms_ops.nms(*(a.cpu() for a in args), **kwargs)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            fail(f"{what}: the NMS call's indices or keep differ card "
                 f"against CPU")
        report["nms_kept"] = got[1].sum(1).tolist()
        say(f"{what}: NMS of {args[0].shape[1]} boxes an example at "
            f"pre_max_size {kwargs['pre_max_size']}: card = CPU (indices "
            f"and keep exact; {report['nms_kept']} kept)")
    del calls

    reset_counts()
    det, vox, preds = forward()
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one {what} forward: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": n_convs, "rotated_iou": 1,
            "nms_suppress": 1, "sparse_gather_gemm_dgrad": 0,
            "sparse_wgrad": 0}
    if {k: counts[k] for k in want} != want or not counts["row_gather"] or \
            {k: paths[k] for k in paths_want} != paths_want:
        fail(f"{what} forward launches {counts} {paths}, expected {want} "
             f"and row gathers on {paths_want}")
    predict_fails_on_sync(spec, preds, anchors, what)
    A = anchors.shape[1]
    for k, shape in (("box_preds", (BATCH, A, spec.box_code_size)),
                     ("cls_preds", (BATCH, A, 1))):
        if tuple(preds[k].shape) != shape or \
                not torch.isfinite(preds[k]).all():
            fail(f"{what} {k}: shape {tuple(preds[k].shape)} (want "
                 f"{shape}) or non-finite values")
    if not all(torch.isfinite(det[k]).all() for k in ("boxes", "scores")):
        fail(f"{what}: non-finite detections")
    report["voxel_overflow"] = int(vox["voxel_overflow"])
    report["stage_overflow"] = int(preds["stage_overflow"])
    report["valid"] = det["valid"].sum(1).tolist()
    say(f"{what}: predict no host sync; voxel_overflow "
        f"{report['voxel_overflow']} stage_overflow "
        f"{report['stage_overflow']} valid detections {report['valid']}")
    reps = RESNET_TIMED if timed else LIGHT_TIMED
    report["forward"] = timed_forwards(forward, reps, BATCH)
    med = report["forward"]["median_s"]
    split = ""
    if timed:
        report["device_split"] = device_split(forward, dtimer, reps=3)
        split = f"; {split_line(report['device_split'])}"
    say(f"{what} frames/s {BATCH / med:.3f} (median {1e3 * med:.2f} ms of "
        f"{reps} batch-{BATCH} forwards); peak memory "
        f"{report['forward']['peak_mem_bytes'] / 2 ** 30:.2f} GiB" + split)
    report["launches"] = counts
    return agg, agg_wide, counts, report


def run_middle_train(dev, timer, dtimer, what, patches, n_convs,
                     paths_want, fp64=False, n_dgrad=None):
    """One train step of the patched config's model (second_car_fhd's
    batch 4 synthetic scans, 16 000 voxels with shuffle_overflow, the
    config's Adam from flax's initialisers; the middle bf16 or fp32 as
    `build_voxelnet` gives it): every forward, dX and weight-gradient call
    against its plain version (GRAD_KERNEL_TOL), the calls wider than WIDE
    channels timed (the others untimed), with `fp64` every fp32 call
    against fp64 (`check_fp32_calls`; under mixed precision the fp32 ones
    among the bf16); each conv's backward against autograd of the
    plain gather-GEMM; launches (`n_convs` forward and weight-gradient
    calls, one fewer dX where the first conv's input needs none, else
    `n_dgrad`) on `paths_want`; every sparse weight's gradient finite and
    nonzero; no host sync; steps/s and peak memory. Returns (the wide calls'
    aggregates by kernel, the launch counts, the report)."""
    report = {}
    cfg = patched_config(patches)
    mixed = cfg.train_config.enable_mixed_precision
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    state, spec, info, assigner = new_train_state(cfg, dev, mixed)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     TRAIN_VOXELS, shuffle_overflow=True)
    batch = train_inputs(cfg, assigner, info, dev, TRAIN_BATCH)
    step = make_train_step(spec, vspec)
    say(f"{what}: {type(state.module.middle).__name__}, batch {TRAIN_BATCH} "
        f"synthetic scans, {TRAIN_VOXELS} voxels, mixed precision {mixed}")
    with recording(RECORDED_TRAIN) as calls:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    n_dgrad = n_convs - 1 if n_dgrad is None else n_dgrad
    want_n = {"gather_gemm": n_convs, "gather_gemm_dgrad": n_dgrad,
              "sparse_wgrad": n_convs}
    if n != want_n:
        fail(f"{what}: expected {want_n} calls a step, recorded {n}")
    report["widths"] = conv_widths(calls["gather_gemm"])
    say(f"{what} capture: {n}; conv widths (C, D, dtype) "
        f"{report['widths']}")
    aggs_wide = {}
    report["calls"] = {}
    for key, kname, kernel, plain, library, bound in (
            ("gather_gemm", "sparse_gather_gemm", subm.gather_gemm,
             subm.gather_gemm_plain, conv_library, conv_bound),
            ("gather_gemm_dgrad", "sparse_gather_gemm_dgrad",
             subm.gather_gemm_dgrad, subm.gather_gemm_plain, conv_library,
             conv_bound),
            ("sparse_wgrad", "sparse_wgrad", subm.sparse_wgrad,
             subm.gather_gemm_wgrad_plain, wgrad_library, wgrad_bound)):
        narrow, wide = split_wide(calls[key])
        detail = report["calls"][key] = []
        check_train_calls(f"{what} {key}", narrow, kernel, plain, library,
                          bound, timer, dtimer, detail, timed=False)
        if wide:
            aggs_wide[kname] = check_train_calls(
                f"{what} {key} wide", wide, kernel, plain, library, bound,
                timer, dtimer, detail)
    if fp64:
        report["fp64_ratio"] = check_fp32_calls(calls, what, mixed)
    report["conv_backward"] = []
    report["conv_backward_worst"] = check_conv_backward(
        calls["gather_gemm"], calls["sparse_wgrad"], report["conv_backward"])
    for row in report["conv_backward"]:
        if max(row["C"], row["D"]) > WIDE:
            say(f"{what} conv {row['conv']} {row['C']} -> {row['D']} "
                f"{row['dtype'][6:]}: its weight gradient [{row['K']}, {row['C']}, "
                f"{row['D']}] lies {row['dW_rel']:.3g} of the scale from "
                f"autograd of the plain gather-GEMM in fp32, "
                f"{row['dW_margin']:.3g} times its bound (one bf16 unit of "
                f"the entry plus 1e-6 of the scale on the bf16 path); card "
                f"{card_line()}")
    del calls

    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts, paths = launch_counts(), conv_path_counts()
    say(f"launches in one {what} step: {counts}; by path: {paths}")
    want = {"sparse_gather_gemm": n_convs,
            "sparse_gather_gemm_dgrad": n_dgrad, "sparse_wgrad": n_convs}
    if {k: counts[k] for k in want} != want or paths != paths_want:
        fail(f"{what} step launches {counts} {paths}, expected {want} on "
             f"{paths_want}")
    sparse = [(name, p) for name, p in state.module.named_parameters()
              if name.startswith("middle.")]
    for name, p in sparse:
        if p.grad is None or not torch.isfinite(p.grad).all() or \
                not p.grad.abs().max() > 0:
            fail(f"{what} {name}: gradient missing, not finite or all zero")
    m = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"{what} metrics not finite: {m}")
    n_syncs = host_syncs(lambda: step(state, batch))
    if n_syncs:
        fail(f"the {what} step synchronised the host {n_syncs} times")
    say(f"{what}: {len(sparse)} middle parameters' gradients finite and "
        f"nonzero; no host sync; " +
        ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    report["metrics"], report["launches"] = m, counts
    report["speed"], _ = timed_steps(step, state, spec, vspec, batch,
                                     RESNET_TIMED, what, profile=False)
    del state
    torch.backends.cudnn.deterministic = False
    return aggs_wide, counts, report


def fp64_gates(name, calls, kernel, plain, agg):
    """The fp32 calls among `calls` once more through `kernel`, each against
    `plain` in fp64 (`fp64_gate`); the worst ratio to the fp32 plain
    version's own error goes into `agg` as "fp64_ratio"."""
    for i, (args, _) in enumerate(calls):
        if args[0].dtype != torch.float32:
            continue
        r = fp64_gate(args, kernel(*args), f"{name} {i}", plain)
        agg["fp64_ratio"] = max(agg.get("fp64_ratio", 0.0),
                                r["fp64_rel_err"] /
                                max(r["plain_fp64_rel_err"], 1e-30))


def run_wide_convs(dev, timer, dtimer):
    """Sparse convs wider than the repo's configs take, on the fhd eval
    forward's own active sets: its four stage rulebooks (recorded from
    `subm_rulebook_b`) with random features [4, N, C], weights [27, C, D]
    and output gradients of the WIDE_PAIRS widths, in bf16 and fp32: the
    forward (`check_convs`), dX on the transposed rulebook with the
    weights [27, D, C] as a view and the weight gradient
    (`check_train_calls`), the fp32 ones also against fp64 (FP32_ERR_RATIO);
    then one bf16 5 x 5 x 5 conv (K = 125) of K125_WIDTHS on stage 0's
    sites, forward and weight gradient. Launches made here compare
    kernels and count on no path. Returns ({key: {kernel: aggregate}}, the
    report)."""
    report = {"convs": [], "dgrad": [], "wgrad": []}
    cfg = load_pipeline_config(CONFIG)
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device=dev, mixed_precision=True, seed=0)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    points, mask, anchors = build_inputs(cfg, assigner, info, dev)
    with recording([(sparse_conv, "subm_rulebook_b")]) as calls:
        detect(net, spec, vspec, points, mask, anchors, device=dev)
        torch.cuda.synchronize()
    del net
    stages = [a for a, _ in calls["subm_rulebook_b"]]
    if len(stages) != 4:
        fail(f"wide convs: expected SpMiddleFHD's 4 stage rulebooks, "
             f"recorded {len(stages)}")
    g = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for dtype, key in ((torch.bfloat16, "wide_c256"),
                       (torch.float32, "wide_c256_fp32")):
        fwd, dgrad, wgrad = [], [], []
        for coords, keys, valid, grid in (a[:4] for a in stages):
            tap_idx, found = sparse_conv.subm_rulebook_b(coords, keys,
                                                         valid, grid)
            B, K, N = tap_idx.shape
            inv = sparse_conv.transpose_rulebook_b(tap_idx, found, N)
            for C, D in WIDE_PAIRS:
                f = torch.randn(B, N, C, device=dev, generator=g).to(dtype)
                w = torch.randn(K, C, D, device=dev, generator=g) / \
                    np.sqrt(K * C * 0.1)
                dout = torch.randn(B, N, D, device=dev, generator=g).to(dtype)
                fwd.append(((f, tap_idx, found, w), {}))
                dgrad.append(((dout, *inv, w.transpose(1, 2)), {}))
                wgrad.append(((f, tap_idx, found, dout), {}))
        say(f"wide convs {str(dtype)[6:]}: stages N "
            f"{[a[0].shape[1] for a in stages]}, widths {WIDE_PAIRS}")
        aggs = {"sparse_gather_gemm": check_convs(fwd, timer, dtimer,
                                                  report["convs"])}
        for name, kname, cl, kernel, plain, library, bound in (
                ("dgrad", "sparse_gather_gemm_dgrad", dgrad,
                 subm.gather_gemm_dgrad, subm.gather_gemm_plain,
                 conv_library, conv_bound),
                ("wgrad", "sparse_wgrad", wgrad, subm.sparse_wgrad,
                 subm.gather_gemm_wgrad_plain, wgrad_library, wgrad_bound)):
            aggs[kname] = check_train_calls(
                f"wide {name} {str(dtype)[6:]}", cl, kernel, plain, library,
                bound, timer, dtimer, report[name])
            fp64_gates(f"wide {name}", cl, kernel, plain, aggs[kname])
        out[key] = aggs
        del fwd, dgrad, wgrad
    # the 125-tap conv on stage 0's sites
    coords, keys, valid, grid = stages[0][:4]
    tap_idx, found = sparse_conv.subm_rulebook_b(coords, keys, valid, grid,
                                                 (5, 5, 5))
    B, K, N = tap_idx.shape
    C, D = K125_WIDTHS
    f = torch.randn(B, N, C, device=dev, generator=g).bfloat16()
    w = torch.randn(K, C, D, device=dev, generator=g) / np.sqrt(K * C * 0.1)
    dout = torch.randn(B, N, D, device=dev, generator=g).bfloat16()
    say(f"wide convs: K = {K} taps on stage 0 ({N} rows), {C} -> {D}, "
        f"{int(found.sum())} found taps")
    out["wide_k125"] = {
        "sparse_gather_gemm": check_convs([((f, tap_idx, found, w), {})],
                                          timer, dtimer, report["convs"]),
        "sparse_wgrad": check_train_calls(
            "wide k125 wgrad", [((f, tap_idx, found, dout), {})],
            subm.sparse_wgrad, subm.gather_gemm_wgrad_plain, wgrad_library,
            wgrad_bound, timer, dtimer, report["wgrad"])}
    say(f"wide convs: every call within its tolerance of its plain version; "
        f"card {card_line()}")
    return out, report


# --------------------- the other middles, encoders and RPN options

MIDDLE = "model.middle_feature_extractor."
VFE = "model.voxel_feature_extractor."
# second_car_fhd.config with each middle, encoder and RPN option of the
# port's registries that the phases above do not run, at full width: (what,
# patches, sparse convs a forward, gather-GEMM launches by path, the
# encoder's norm statistics calibrated). Where a middle's BEV map is not the
# fhd one, the patch sets the config as JAX's builder needs it: the BEV
# stride (`downsample_factor`: 4 for the D4HD family, 16 for SpMiddle2K, 2
# for the bottleneck stack, 1 for SparseMiddleExtractor), SpMiddle2K's z
# voxel 0.05 m (its five z-strided convs need 81 z cells; the fhd grid's 41
# leave none), and SparseMiddleExtractor's widths and voxels as SECOND's
# car.config gives them ([64], [64, 64]; 0.2 x 0.2 x 0.4 m). The stacks
# compute in fp32 (JAX's builder gives them no dtype), SpMiddleFHDLite and
# SpMiddleFHD in bf16.
CONFIG_EVALS = (
    ("lite eval", [f'{MIDDLE}module_class_name="SpMiddleFHDLite"'], 4,
     {"mma": 4, "fma": 0}, False),
    ("extractor eval",
     [f'{MIDDLE}module_class_name="SparseMiddleExtractor"',
      "model.voxel_generator.voxel_size=[0.2, 0.2, 0.4]",
      f"{MIDDLE}downsample_factor=1", f"{MIDDLE}num_filters_down1=[64]",
      f"{MIDDLE}num_filters_down2=[64, 64]"], 5, {"mma": 0, "fma": 5},
     False),
    ("d4hd eval", [f'{MIDDLE}module_class_name="SpMiddleD4HD"',
                   f"{MIDDLE}downsample_factor=4"], 11,
     {"mma": 0, "fma": 11}, False),
    ("resd4hd eval", [f'{MIDDLE}module_class_name="SpResNetD4HD"',
                      f"{MIDDLE}downsample_factor=4"], 16,
     {"mma": 0, "fma": 16}, False),
    ("d4hdlite eval", [f'{MIDDLE}module_class_name="SpMiddleD4HDLite"',
                       f"{MIDDLE}downsample_factor=4"], 11,
     {"mma": 0, "fma": 11}, False),
    ("d8hd eval", [f'{MIDDLE}module_class_name="SpMiddleD8HD"'], 15,
     {"mma": 0, "fma": 15}, False),
    ("2k eval", [f'{MIDDLE}module_class_name="SpMiddle2K"',
                 "model.voxel_generator.voxel_size=[0.05, 0.05, 0.05]",
                 f"{MIDDLE}downsample_factor=16"], 17,
     {"mma": 0, "fma": 17}, False),
    ("fhdv2 eval", [f'{MIDDLE}module_class_name="SpMiddleFHDV2"'], 14,
     {"mma": 0, "fma": 14}, False),
    ("vfev2 eval", [f'{VFE}module_class_name="VoxelFeatureExtractorV2"',
                    f"{VFE}num_filters=[32, 128]"], SPARSE_CONVS,
     {"mma": SPARSE_CONVS, "fma": 0}, True),
    ("simplev eval", [f'{VFE}module_class_name="SimpleVoxel"'],
     SPARSE_CONVS, {"mma": SPARSE_CONVS, "fma": 0}, False),
    ("groupnorm eval", ["model.rpn.use_groupnorm=True"], SPARSE_CONVS,
     {"mma": SPARSE_CONVS, "fma": 0}, False),
    ("bottleneck256 eval", [f'{MIDDLE}module_class_name="Bottleneck256"',
                            f"{MIDDLE}downsample_factor=2"], 4,
     {"mma": 0, "fma": 4}, False),
)
# tests/test_torch_sparse_middles.py's stack whose bottleneck feeds 256
# channels (4 x 64) to a 256 -> 256 submanifold conv and a 256 -> 32
# strided conv, registered for its phase as "Bottleneck256"
BOTTLENECK_256 = (("subm", 16), ("bottleneck", 64), ("subm", 256),
                  ("down", 32, (3, 3, 3), (2, 2, 2), (1, 1, 1)))
# the train step of SpMiddleFHDV2, the model path of the sparse max pool's
# gradient: fp32, 14 forward, 13 dX and 14 weight-gradient calls
FHDV2_PATCHES = CONFIG_EVALS[7][1]
# the fhd eval forward with NMS over 8192 candidates an example, past
# NMS_MAX_K: its NMS kernels take their wide routes
K8192_PATCHES = ["model.nms_pre_max_size=8192"]


def run_config_evals(dev, timer, dtimer):
    """Each CONFIG_EVALS phase through `run_middle_eval`, untimed by call:
    every sparse conv against its plain version (fp32 ones also against
    fp64), the row gathers exact, the NMS pair against its plain version,
    launches and gather-GEMM paths, predict without a host sync, frames/s.
    Returns ({path: launch counts}, {path: report})."""
    from second_tpu_torch.models.middle import MIDDLE_REGISTRY
    from second_tpu_torch.models.sparse_middle import partial_stack
    MIDDLE_REGISTRY.setdefault("Bottleneck256",
                               partial_stack(BOTTLENECK_256))
    counts, reports = {}, {}
    for what, patches, n_convs, paths, calibrate in CONFIG_EVALS:
        path = what.replace(" ", "_")
        with phase_time(what):
            _, _, counts[path], reports[path] = run_middle_eval(
                dev, timer, dtimer, what, patches, n_convs, paths,
                calibrate=calibrate, timed=False)
        torch.cuda.empty_cache()
    return counts, reports


# the NMS kernels past NMS_MAX_K (their wide routes): (candidates an
# example, batch), up to ROTATED_MAX_K; the threshold and the pair cap of
# the fhd config's NMS
NMS_LARGE_KS = ((4097, 4), (8192, 4), (16384, 4), (riou.ROTATED_MAX_K, 1))
NMS_LARGE_THR, NMS_LARGE_CAP = 0.01, 8192


def crowded_nms_boxes(g, B, K):
    """B examples of K BEV boxes (x, y, w, l, yaw) over a square of side
    1.2 sqrt(K) m, 0.5-3 m by 0.5-6 m: some 5 K pairs an example pass the
    standup bound at NMS_LARGE_THR, so the pair cap binds; scores sorted,
    10% invalid (-inf)."""
    side = 1.2 * K ** 0.5
    boxes = torch.stack([torch.rand(B, K, generator=g) * side,
                         torch.rand(B, K, generator=g) * side,
                         0.5 + 2.5 * torch.rand(B, K, generator=g),
                         0.5 + 5.5 * torch.rand(B, K, generator=g),
                         (torch.rand(B, K, generator=g) - 0.5) * 2 * np.pi],
                        -1)
    scores = torch.rand(B, K, generator=g).sort(1, descending=True)[0]
    scores[torch.rand(B, K, generator=g) < 0.1] = float("-inf")
    return boxes, scores


def run_nms_large_k(dev, timer, dtimer):
    """Rotated and standup NMS past NMS_MAX_K candidates an example, where
    the kernels take their wide routes, on crowded synthetic boxes at each
    of NMS_LARGE_KS: `nms_sorted` of the candidates (rotated, threshold
    NMS_LARGE_THR, the NMS_LARGE_CAP pair cap) recorded, its
    `nms_overlap` and `nms_suppress` calls against their plain versions
    (`check_nms_pair`: pair counts, keep and bits exact, bits but at pairs
    within RIOU_TOL of the threshold), and the same candidates' standup
    envelopes through standup NMS: `standup_overlap` bit for bit and its
    keep (`check_standup_calls`), the suppression of that bitmask timed
    beside its plain version; each call by events and device-only with its
    bound. The plain versions build their [B, K, K] pair matrices a block
    of rows at a time (`riou.row_blocks`), so they run on the card at every
    K. Returns ({kernels-line key: {kernel: aggregate}}, the report)."""
    aggs, report = {}, {}
    g = torch.Generator().manual_seed(21)
    for K, B in NMS_LARGE_KS:
        boxes, scores = crowded_nms_boxes(g, B, K)
        cand, scores = boxes.to(dev), scores.to(dev)
        reps = (3, 1) if K > 10000 else (10, 2)
        kw = dict(post_max_size=500, iou_threshold=NMS_LARGE_THR)
        what = f"nms K{K} B{B}"
        with recording([(riou, "nms_overlap"),
                        (riou, "nms_suppress")]) as calls:
            nms_ops.nms_sorted(cand, scores, max_pairs=NMS_LARGE_CAP, **kw)
            torch.cuda.synchronize()
        ov, sup, report[f"K{K}"] = check_nms_pair(calls, timer, dtimer,
                                                  what, reps)
        if report[f"K{K}"]["pair_count"][0] <= NMS_LARGE_CAP:
            fail(f"{what}: the pair cap does not bind")
        del calls
        standup = nms_ops.rbbox2d_to_near_bbox(cand)
        with recording([(riou, "standup_overlap"),
                        (riou, "nms_suppress")]) as calls:
            nms_ops.nms_sorted(standup, scores, rotated=False, **kw)
            torch.cuda.synchronize()
        st = check_standup_calls(calls["standup_overlap"],
                                 calls["nms_suppress"], timer, dtimer,
                                 f"{what} standup", reps)
        (bits, valid), _ = calls["nms_suppress"][0]
        fns = [lambda: riou.nms_suppress(bits, valid),
               lambda: riou.nms_suppress_plain(bits, valid)]
        st_sup = dict(ms=timer(fns[0], reps[0]), device_ms=dtimer(fns[:1])[0],
                      plain_ms=timer(fns[1], reps[1]), library_ms=None,
                      library_device_ms=None, err=0.0,
                      bytes_s=(bits.numel() * 4 + 2 * valid.numel()) /
                      HBM_BYTES_PER_S, ops_s=0.0)
        say(f"{what} standup nms_suppress: keep exact ({int(bits.ne(0).sum())}"
            f" nonzero words); kernel {st_sup['ms']:.4f} ms (device "
            f"{st_sup['device_ms']:.4f})  plain {st_sup['plain_ms']:.4f} ms  "
            f"bound {1e3 * st_sup['bytes_s']:.6f} ms")
        aggs[f"nms_k{K}"] = {"rotated_iou": ov, "nms_suppress": sup,
                             "standup_overlap": st}
        aggs[f"nms_standup_k{K}"] = {"nms_suppress": st_sup}
        del calls, bits, valid, fns, cand, scores, standup
        torch.cuda.empty_cache()
    say(f"nms past {riou.NMS_MAX_K}: every call within its tolerance of its "
        f"plain version up to K {riou.ROTATED_MAX_K}; card {card_line()}")
    return aggs, report


# ------------------------------------------------------------ soft-NMS

# soft-NMS (`ops/nms.py` soft_nms; no config reaches it, JAX's tests call
# it) on the fhd eval's decoded candidates: (method, sigma, iou_threshold)
SOFT_NMS_RUNS = (("gaussian", 0.5, 0.3), ("linear", 0.5, 0.3))
# the long rows: candidates, decay steps; the pair kernel's pair lists
# there: the fhd cap (at NMS_MAX_K its adjacency in shared memory) and, at
# NMS_MAX_K, one past shared memory (in the device scratch); past
# NMS_MAX_K both kernels take their wide routes
SOFT_NMS_KS, SOFT_NMS_STEPS = (4096, 8192, 16384), 100
SOFT_NMS_K_PAIRS = {4096: (8192, 32768), 8192: (8192,), 16384: (8192,)}
# the decay kernels against their plain versions on the same inputs: picks
# exact, the finite scores within SOFT_RTOL relative (the same fp32
# operations; torch's CUDA division by a scalar multiplies by its
# reciprocal, an ulp away); the whole soft_nms card against CPU: picks and
# keep exact, scores within SOFT_REF_RTOL (the corners' sin and cos an ulp
# apart move the IoU by up to RIOU_TOL)
SOFT_RTOL, SOFT_REF_RTOL = 1e-6, 1e-5
# fp32 operations of the decay over a pair list, as the function needs them whatever
# kernel does it: each step's argmax, a comparison a candidate; the decay
# of each of the pick's neighbours (the decay's 4 or 3, the finite test,
# the product and its select); the adjacency, a count and a placement
# each way of each ok pair
SOFT_PAIR_ARGMAX_OPS = 1
SOFT_PAIR_DECAY_OPS = {"gaussian": 4 + 3, "linear": 3 + 3}
SOFT_PAIR_BUILD_OPS = 4
# ... of the standup decay, as the function needs them: each step's
# argmax, a comparison a candidate; the test whether the pick meets each
# candidate (two maxima, two minima, two differences, two comparisons:
# 8); the decay of each candidate that meets it (the product of the
# widths, the sum of the areas, the difference, the division and its
# test: 5; the decay's 4 or 3; the finite test, the product and its
# select: 3)
SOFT_STANDUP_MEET_OPS = 8
SOFT_STANDUP_DECAY_OPS = {"gaussian": 5 + 4 + 3, "linear": 5 + 3 + 3}


def soft_standup_bound(cand, scores, picks, method):
    """The standup decay's bound on the card, from this call's data:
    bytes, the K boxes (16 B) and scores (4 B) a row read once, the m
    picks (int64) and their scores written; operations, the argmax and
    the meet test a candidate a step (SOFT_PAIR_ARGMAX_OPS +
    SOFT_STANDUP_MEET_OPS) and SOFT_STANDUP_DECAY_OPS for each pair of a
    pick and a candidate whose IoU is not 0 (counted from the picks), at
    the fp32 rate. The chain of m steps is not counted
    (scripts/torch_soft_nms_floor.py measures a step's floor)."""
    (R, K), m = scores.shape, picks.shape[1]
    pb = cand.gather(1, picks[..., None].expand(-1, -1, 4))
    met = int((standup_iou_matrix(pb, cand) != 0).sum())
    ops = R * m * K * (SOFT_PAIR_ARGMAX_OPS + SOFT_STANDUP_MEET_OPS) + \
        met * SOFT_STANDUP_DECAY_OPS[method]
    return dict(bytes_s=R * (20 * K + 12 * m) / HBM_BYTES_PER_S,
                ops_s=ops / PEAK_OPS_PER_S[torch.float32], pairs_met=met)


def soft_pairs_bound(plist, ok, scores, picks, method):
    """The pair-list decay's bound on the card, from this call's data:
    bytes, the pair list (int64), its ok flags and IoU (fp32) and the K
    scores read once, the m picks (int64) and their scores written;
    operations, SOFT_PAIR_ARGMAX_OPS a candidate a step, the decay of
    each pick's neighbours (counted from the ok pairs), the adjacency's
    SOFT_PAIR_BUILD_OPS an ok pair, at the fp32 rate. The chain of m steps
    is not counted (scripts/torch_soft_nms_floor.py)."""
    R, P = plist.shape
    K, m = scores.shape[1], picks.shape[1]
    rows = torch.arange(R, device=plist.device)[:, None].expand(-1, P)
    deg = torch.zeros((R, K), dtype=torch.int64, device=plist.device)
    for end in (plist // K, plist % K):
        deg.index_put_((rows[ok], end[ok]), torch.ones_like(end[ok]),
                       accumulate=True)
    walked = int(deg.gather(1, picks).sum())
    ops = R * m * K * SOFT_PAIR_ARGMAX_OPS + \
        walked * SOFT_PAIR_DECAY_OPS[method] + \
        int(ok.sum()) * SOFT_PAIR_BUILD_OPS
    return dict(bytes_s=(R * P * (8 + 1 + 4) + R * K * 4 + R * m * 12) /
                HBM_BYTES_PER_S,
                ops_s=ops / PEAK_OPS_PER_S[torch.float32],
                neighbours_walked=walked)


def check_decay(got, want, what):
    """A decay kernel's (picks, scores) against the plain version's: picks
    exact, NaN where NaN, the same entries finite and the others equal,
    the finite ones within SOFT_RTOL relative. Returns the largest
    absolute error."""
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        n = int((got[0] != want[0]).sum())
        fail(f"{what}: {n} picks differ from the plain version's")
    fin = torch.isfinite(want[1])
    odd = ~fin & ~want[1].isnan()
    if not (torch.equal(torch.isfinite(got[1]), fin) and
            torch.equal(got[1].isnan(), want[1].isnan()) and
            torch.equal(got[1][odd], want[1][odd])):
        fail(f"{what}: the kernel's non-finite scores are not the plain "
             f"version's")
    if not fin.any():
        return 0.0
    err = (got[1][fin] - want[1][fin]).abs()
    rel = (err / want[1][fin].abs().clamp(min=1e-30)).max().item()
    if rel > SOFT_RTOL:
        fail(f"{what}: scores {rel:.3g} relative from the plain version's")
    return err.max().item()


def run_soft_nms(dev, timer, dtimer, nms_call):
    """soft-NMS on the fhd eval forward's NMS candidates (the recorded
    `nms` call: batch 4, nms_pre_max_size 1000 decoded boxes an example,
    post 100), gaussian (sigma 0.5) and linear (threshold 0.3), rotated,
    and gaussian standup on the same boxes' standup envelopes; then rows
    of SOFT_NMS_KS candidates:
    - counted: launch counts set to 0, the three calls, counts read: the
      pair-list decay kernel once a rotated call for all 4 rows, with the
      pair IoU; the standup decay kernel once in the standup call, whose
      peak allocation stays below a [B, K, K] fp32 matrix; the row gather
      once a call; nothing else;
    - each decay call's kernel against its plain version on its own
      inputs (`check_decay`), each pair IoU call against its plain version
      (RIOU_TOL), the pair cap's use printed; the standup kernel on the
      standup call's rows with NaN and +inf scores and NaN boxes;
    - each call card against CPU (every wrapper's plain version): picks
      and keep exact, the rescored scores within SOFT_REF_RTOL;
    - each rotated call's pair-list decay timed (events, device, plain)
      with its bound (`soft_pairs_bound`) and, at m = 1, its prologue and
      one step; the standup call's standup decay (`soft_standup_bound`)
      the same; the whole gaussian soft_nms, rotated and standup, timed
      (events and device);
    - the long rows (SOFT_NMS_KS: 4096, and past NMS_MAX_K the kernels'
      wide routes): crowded boxes, with a NaN and a +inf score past K =
      4096, their pair lists at the SOFT_NMS_K_PAIRS caps, SOFT_NMS_STEPS
      steps, the pair kernel against plain and timed; the standup kernel
      on their standup envelopes (a NaN box past 4096), against plain and
      timed.
    Returns (the aggregates by kernel: the fhd gaussian calls' numbers;
    the aggregates of the other calls by kernels-line key, the launch
    counts, the report)."""
    (boxes, scores, valid), kw = nms_call
    pre, post = kw["pre_max_size"], kw["post_max_size"]
    B, N = scores.shape
    report = dict(batch=B, candidates=N, pre_max_size=pre,
                  post_max_size=post, runs={})
    standup = nms_ops.rbbox2d_to_near_bbox(boxes)

    def soft(method, sigma, thr, b=boxes, s=scores, v=valid, rotated=True):
        return nms_ops.soft_nms(b, s, v, pre_max_size=pre,
                                post_max_size=post, sigma=sigma,
                                iou_threshold=thr, method=method,
                                rotated=rotated)

    reset_counts()
    with recording([(riou, "soft_nms_decay_pairs"), (riou, "riou_pairs"),
                    (riou, "soft_nms_decay_standup")]) as calls:
        outs = [soft(*run) for run in SOFT_NMS_RUNS]
        torch.cuda.synchronize()
        # the standup call's peak allocation: no [B, K, K] matrix is built
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out_standup = soft(*SOFT_NMS_RUNS[0], b=standup, rotated=False)
        torch.cuda.synchronize()
        standup_peak = torch.cuda.max_memory_allocated(dev) - base
    counts = launch_counts()
    runs = len(SOFT_NMS_RUNS)
    want = {**{k: 0 for k in counts}, "soft_nms_pairs": runs,
            "rotated_iou": runs, "row_gather": runs + 1,
            "soft_nms_standup": 1}
    if counts != want:
        fail(f"soft-nms: launches {counts}, expected {want}")
    say(f"soft-nms: launches in the three calls {counts}")
    k_st = min(pre, N)
    matrix_bytes = B * k_st * k_st * 4
    if standup_peak >= matrix_bytes:
        fail(f"soft-nms standup: {standup_peak} bytes allocated at the "
             f"call's peak, as much as a [B, K, K] matrix ({matrix_bytes})")
    report["standup_peak_bytes"] = standup_peak
    say(f"soft-nms standup: the call's peak allocation {standup_peak} "
        f"bytes; a [B, K, K] fp32 matrix would take {matrix_bytes}")

    def card_vs_cpu(out, what, method, sigma, thr, b, rotated):
        ref = soft(method, sigma, thr, b.cpu(), scores.cpu(), valid.cpu(),
                   rotated)
        if not (torch.equal(out[0].cpu(), ref[0]) and
                torch.equal(out[2].cpu(), ref[2])):
            fail(f"{what}: picks or keep differ card against CPU")
        ref_rel = ((out[1].cpu() - ref[1]).abs() /
                   ref[1].abs().clamp(min=1e-30)).max().item()
        if ref_rel > SOFT_REF_RTOL:
            fail(f"{what}: scores {ref_rel:.3g} relative from the CPU's")
        return ref_rel

    errs = {}
    for ((args, kwargs), (pargs, _), (method, sigma, thr), out) in zip(
            calls["soft_nms_decay_pairs"], calls["riou_pairs"],
            SOFT_NMS_RUNS, outs):
        what = f"soft-nms {method}"
        plist, ok, _, top, m = args[:5]
        errs[method] = check_decay(
            riou.soft_nms_decay_pairs(*args, **kwargs),
            riou.soft_nms_decay_pairs_plain(*args, **kwargs), what)
        pair_err, _ = errors(riou.riou_pairs(*pargs),
                             riou.riou_pairs_plain(*pargs))
        if pair_err > RIOU_TOL:
            fail(f"{what}: the pair IoU {pair_err:.3g} from its plain "
                 f"version")
        ref_rel = card_vs_cpu(out, what, method, sigma, thr, boxes, True)
        run = dict(rows=int(top.shape[0]), K=int(top.shape[1]), steps=m,
                   pairs_clipped=ok.sum(1).tolist(),
                   kept=out[2].sum(1).tolist(), pair_err=pair_err,
                   card_vs_cpu_rel=ref_rel)
        report["runs"][method] = run
        say(f"{what}: pair-list decay kernel = plain (picks exact), pair "
            f"IoU within {pair_err:.2e}, card = CPU (picks and keep exact, "
            f"scores within {ref_rel:.2e}); pairs clipped "
            f"{run['pairs_clipped']} of the cap {plist.shape[1]}, kept "
            f"{run['kept']}")
    (args_st, kwargs_st), = calls["soft_nms_decay_standup"]
    errs["standup"] = check_decay(
        riou.soft_nms_decay_standup(*args_st, **kwargs_st),
        riou.soft_nms_decay_standup_plain(*args_st, **kwargs_st),
        "soft-nms standup")
    ref_rel = card_vs_cpu(out_standup, "soft-nms standup",
                          *SOFT_NMS_RUNS[0], standup, False)
    report["runs"]["standup"] = dict(kept=out_standup[2].sum(1).tolist(),
                                     card_vs_cpu_rel=ref_rel)
    say(f"soft-nms standup: standup decay kernel = plain (picks exact), "
        f"card = CPU (scores within {ref_rel:.2e}), kept "
        f"{report['runs']['standup']['kept']}")
    # the standup kernel on NaN rows: NaN and +inf scores (torch.argmax
    # ranks NaN first) and NaN IoU values (two overlapping infinite boxes:
    # the second decays to NaN by the first; a NaN coordinate)
    cand_st, top_st = args_st[:2]
    inf, nan = float("inf"), float("nan")
    cand_nan, top_nan = cand_st.clone(), top_st.clone()
    cand_nan[0, 3] = cand_nan[0, 20] = torch.tensor([-inf, -inf, inf, inf])
    cand_nan[0, 7, 0] = nan
    top_nan[0, 10], top_nan[0, 5] = nan, inf
    top_nan[0, 3], top_nan[0, 20] = 2.0, 1.5      # the infinite boxes next
    top_nan[1, 20], top_nan[1, 21] = inf, nan
    nan_args = (cand_nan, top_nan, *args_st[2:])
    dense_nan = (standup_iou_matrix(cand_nan, cand_nan), top_nan,
                 *args_st[2:])
    want_nan = riou.soft_nms_decay_plain(*dense_nan, **kwargs_st)
    if not (int(want_nan[0][0, 0]) == 10 and int(want_nan[0][1, 0]) == 21
            and int(want_nan[1].isnan().sum()) > 2):
        fail("soft-nms NaN row: the plain version does not pick the NaN "
             "scores first")
    errs["standup_nan"] = check_decay(
        riou.soft_nms_decay_standup(*nan_args, **kwargs_st),
        riou.soft_nms_decay_standup_plain(*nan_args, **kwargs_st),
        "soft-nms standup NaN row")
    say(f"soft-nms NaN row: standup decay kernel = plain (picks exact, "
        f"{int(want_nan[1].isnan().sum())} NaN scores in the same places, "
        f"the plain version picking the NaN scores first)")

    def timed(kernel, args, kwargs, method, what):
        """The decay kernel (`soft_nms_decay_pairs` or
        `soft_nms_decay_standup`) on `args` timed beside its plain
        version, with its bound, and at m = 1 (its prologue and one
        step)."""
        pairs = kernel == "soft_nms_decay_pairs"
        fn = getattr(riou, kernel)
        plain_fn = getattr(riou, f"{kernel}_plain")
        m_at = 4 if pairs else 2
        kern = (lambda: fn(*args, **kwargs))
        plain = (lambda: plain_fn(*args, **kwargs))
        one = (lambda: fn(*args[:m_at], 1, *args[m_at + 1:], **kwargs))
        top, m = args[m_at - 1], args[m_at]
        R, K = top.shape
        picks = kern()[0]
        # the kernel alone in the profiler: the plain version's some 700
        # kernels a call overran its traces on the H100
        dev_ms = dtimer([kern, one])
        agg = dict(ms=timer(kern, 20), device_ms=dev_ms[0],
                   step1_device_ms=dev_ms[1], plain_ms=timer(plain, 3),
                   library_ms=None, library_device_ms=None,
                   **(soft_pairs_bound(args[0], args[1], top, picks, method)
                      if pairs else soft_standup_bound(args[0], top, picks,
                                                       method)))
        steps_us = 1e3 * (agg["device_ms"] - agg["step1_device_ms"]) / \
            max(m - 1, 1)
        agg["step_device_us"] = steps_us
        say(f"{what} decay R={R} K={K} m={m}"
            + (f" P={args[0].shape[1]}" if pairs else "") +
            f": kernel {agg['ms']:.4f} ms (device {agg['device_ms']:.4f}; "
            f"m = 1 {agg['step1_device_ms']:.4f}, so {steps_us:.3f} us a "
            f"later step)  plain {agg['plain_ms']:.4f} ms  bound "
            f"{1e3 * max(agg['bytes_s'], agg['ops_s']):.6f} ms "
            f"({'bytes' if agg['bytes_s'] >= agg['ops_s'] else 'ops'})")
        return agg

    aggs, others = {}, {}
    for (args, kwargs), (method, _, _) in zip(calls["soft_nms_decay_pairs"],
                                              SOFT_NMS_RUNS):
        agg = timed("soft_nms_decay_pairs", args, kwargs, method,
                    f"soft-nms fhd {method}")
        agg["err"] = errs[method]
        if method == SOFT_NMS_RUNS[0][0]:
            aggs["soft_nms_pairs"] = agg
        else:
            others[f"soft_nms_{method}"] = {"soft_nms_pairs": agg}
    aggs["soft_nms_standup"] = timed("soft_nms_decay_standup", args_st,
                                     kwargs_st, SOFT_NMS_RUNS[0][0],
                                     "soft-nms fhd standup")
    aggs["soft_nms_standup"]["err"] = max(errs["standup"],
                                          errs["standup_nan"])

    def whole(fn, key, what):
        """The whole call timed by events (the host's enqueue included)
        and device-only."""
        report[f"{key}_ms"] = timer(fn, 10)
        report[f"{key}_device_ms"], = dtimer([fn])
        say(f"soft-nms fhd: {what} {report[f'{key}_ms']:.4f} ms (device "
            f"{report[f'{key}_device_ms']:.4f})")

    # the rotated call is some 40 small launches, the standup one some 10
    whole(lambda: soft(*SOFT_NMS_RUNS[0]), "whole",
          "the whole gaussian soft_nms (top-k, pair list, pair IoU, decay)")
    whole(lambda: soft(*SOFT_NMS_RUNS[0], b=standup, rotated=False),
          "whole_standup", "the whole gaussian standup soft_nms (top-k, "
          "the row gather, decay)")

    g = torch.Generator().manual_seed(7)
    for n in SOFT_NMS_KS:
        # crowded boxes over a square that grows with sqrt(n): as many
        # neighbours a box at every n
        side = (n / SOFT_NMS_KS[0]) ** 0.5
        big = torch.stack([torch.rand(n, generator=g) * 70.4 * side,
                           torch.rand(n, generator=g) * 80 * side - 40,
                           1.4 + 0.4 * torch.rand(n, generator=g),
                           3.5 + 0.8 * torch.rand(n, generator=g),
                           (torch.rand(n, generator=g) - 0.5) * 2 * np.pi],
                          1).to(dev)
        top = torch.rand(1, n, generator=g).sort(1, descending=True)[0]
        if n > riou.NMS_MAX_K:
            top[0, 5], top[0, 17] = nan, inf
        top = top.to(dev)
        for cap in SOFT_NMS_K_PAIRS[n]:
            plist, ok = nms_ops.soft_nms_pairs(big[None],
                                               torch.ones_like(top, dtype=torch.bool),
                                               cap)
            if not bool(ok.all()):
                fail(f"soft-nms K{n}: fewer than {cap} pairs")
            args_k = (plist, ok, nms_ops.pair_iou(big[None], plist), top,
                      SOFT_NMS_STEPS, "gaussian", 0.5, 0.3)
            what = f"soft-nms K{n} P{cap}"
            agg = timed("soft_nms_decay_pairs", args_k, {}, "gaussian", what)
            agg["err"] = check_decay(riou.soft_nms_decay_pairs(*args_k),
                                     riou.soft_nms_decay_pairs_plain(*args_k),
                                     what)
            agg["scratch_bytes"] = riou.soft_pairs_scratch(n, cap)
            others[f"soft_nms_k{n}_p{cap}"] = {"soft_nms_pairs": agg}
        cand_k = nms_ops.rbbox2d_to_near_bbox(big)[None].contiguous()
        if n > riou.NMS_MAX_K:
            cand_k[0, 40, 1] = nan
        args_k = (cand_k, top, SOFT_NMS_STEPS, "gaussian", 0.5, 0.3)
        what = f"soft-nms K{n} standup"
        agg = timed("soft_nms_decay_standup", args_k, {}, "gaussian", what)
        agg["err"] = check_decay(riou.soft_nms_decay_standup(*args_k),
                                 riou.soft_nms_decay_standup_plain(*args_k),
                                 what)
        others[f"soft_nms_standup_k{n}"] = {"soft_nms_standup": agg}
        del big, plist, ok, args_k, cand_k
    say(f"soft-nms long rows: every decay call within its tolerance of its "
        f"plain version; card {card_line()}")
    report["timing"] = {k: {f: v for f, v in a.items() if f != "err"}
                        for k, a in aggs.items()}
    report["timing_other"] = {
        key: {f: v for f, v in a.items() if f != "err"}
        for key, d in others.items() for a in d.values()}
    report["launches"] = counts
    return aggs, others, counts, report


# -------------------------------------------------------- multi-device

# the dp phase: Trainer steps compared, DP (and plain with the norms'
# all-reduces) against plain; steps timed each way, in turns; where their
# parameters are not bit for bit the plain steps', their largest
# difference over each tensor's scale
DP_STEPS, DP_TIMED = 3, 8
DP_PARAM_TOL = 1e-6


def run_dp(dev, tmp):
    """Multi-device at world size 1 (the machine has one card): a real
    NCCL process group of one rank (a `file://` rendezvous in `tmp`), then
    - dp train: two `Trainer`s on second_car_fhd.config (synthetic scans,
      the config's batch 4, bf16, its Adam, flax's initialisers), one on
      the data-parallel path (`_setup_dp_train`: DDP; the Trainer takes
      it by itself only above one rank, where the norms' statistics are
      all-reduced too), one plain; DP_STEPS steps each on the same
      batches, counted: the same kernel launches; the parameters and norm
      statistics after them bit for bit equal (else the largest difference
      printed and gated at DP_PARAM_TOL of each tensor's scale); steps/s
      in turns of the plain step, the DP step (the cost of DDP's buckets)
      and the plain step under `sync_norms` over the group (the cost of
      the norms' all-reduces, which a step above one rank pays; its
      state, a third Trainer's, checked bit for bit too);
    - dp eval: `make_dp_eval_step` on the fhd eval input (batch 4, 40 000
      voxels, the in-graph anchors mask), counted: its statistics equal a
      host count of its detections and the single-device eval's, its
      detections the single-device ones;
    - the row-sharded RPN (`make_spatial_forward`) on the fhd model's BEV
      map against its unsharded forward, and the sequence-parallel
      forward (`make_sp_sequence_forward`, the ring a local copy at one
      rank) of a 4-frame sequence against `TemporalSequenceVoxelNet`.
    Returns (the DP train steps' launch counts, the DP eval's, the
    report)."""
    import datetime

    import torch.distributed as dist

    from second_tpu_torch.parallel.eval_dp import (_local_stats,
                                                   SCORE_THRESHOLDS,
                                                   make_dp_eval_step,
                                                   stats_to_dict)
    from second_tpu_torch.parallel.mesh import make_group, sync_norms
    from second_tpu_torch.parallel.spatial import make_spatial_forward
    from second_tpu_torch.parallel.temporal_sp import \
        make_sp_sequence_forward
    from second_tpu_torch.train.run import Trainer
    report = {}
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp / 'dp_rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300),
        device_id=dev)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        group = make_group()
        trainers = {}
        for kind in ("plain", "dp", "norms"):
            tr = Trainer(CONFIG, tmp / f"dp_{kind}", synthetic=True,
                         dataset_size=8, max_points=MAX_POINTS, device=dev,
                         patches=["train_config.steps_per_eval=0"])
            if tr._train_group is not None:
                fail("dp train: a Trainer at world size 1 took the "
                     "data-parallel path by itself")
            if kind == "dp":
                tr._setup_dp_train()
            trainers[kind] = tr

        def norms_step(state, batch):
            with sync_norms(group):
                return trainers["norms"].train_step(state, batch)
        steps = {"plain": trainers["plain"].train_step,
                 "dp": trainers["dp"].train_step, "norms": norms_step}
        bs = trainers["plain"].cfg.train_input_reader.batch_size
        states, counts, losses = {}, {}, {}
        for kind, tr in trainers.items():
            it = tr._batch_iter(bs, np.random.default_rng(0))
            batches = [next(it) for _ in range(DP_STEPS)]
            state = tr._init_state()
            reset_counts()
            for b in batches:
                state, metrics = steps[kind](state, b)
                losses.setdefault(kind, []).append(float(metrics["loss"]))
            torch.cuda.synchronize()
            if (state.ddp is None) != (kind != "dp"):
                fail(f"dp train: the {kind} Trainer's module is "
                     f"{'' if state.ddp is None else 'not '}wrapped in DDP")
            counts[kind] = launch_counts()
            states[kind] = (state, batches)
        for kind in ("dp", "norms"):
            if counts[kind] != counts["plain"] or not all(
                    counts[kind][k["name"]] for k in KERNELS[:2] +
                    TRAIN_KERNELS):
                fail(f"dp train: {kind} launches {counts[kind]}, the plain "
                     f"steps' {counts['plain']}")
        b = states["plain"][0].module.state_dict()
        report["train"] = dict(steps=DP_STEPS, losses=losses,
                               launches=counts["dp"])
        for kind in ("dp", "norms"):
            a = states[kind][0].module.state_dict()
            worst, differ = 0.0, 0
            for k in a:
                if torch.equal(a[k], b[k]):
                    continue
                differ += 1
                diff = (a[k].double() - b[k].double()).abs().max().item()
                worst = max(worst, diff / max(
                    b[k].double().abs().max().item(), 1e-30))
            if worst > DP_PARAM_TOL:
                fail(f"dp train: {kind}: {differ} state tensors differ from "
                     f"the plain steps', by up to {worst:.3g} of their "
                     f"scale")
            report["train"][kind] = dict(tensors_differ=differ,
                                         worst_rel_diff=worst)
            say(f"dp train ({kind}): NCCL world size 1, {DP_STEPS} steps of "
                f"the fhd Trainer " + ("through DDP" if kind == "dp" else
                                       "with the norms' all-reduces")
                + f" against the plain Trainer: losses {losses[kind]} and "
                f"{losses['plain']}; "
                + ("state bit for bit equal" if not differ else
                   f"{differ} tensors differ, by at most {worst:.3g} of "
                   f"scale") + f"; launches {counts[kind]}")
        times = {k: [] for k in steps}
        for i in range(DP_TIMED):
            for kind, step in steps.items():
                state, batches = states[kind]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, batches[i % DP_STEPS])
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
        speed = {k: 1.0 / statistics.median(v) for k, v in times.items()}
        report["train"]["steps_per_s"] = speed
        report["train"]["times_s"] = times
        say(f"dp train steps/s {speed['dp']:.3f} (DDP) and "
            f"{speed['norms']:.3f} (the norms' statistics all-reduced) "
            f"against the plain Trainer's {speed['plain']:.3f} (median of "
            f"{DP_TIMED} synchronised steps each, in turns; batch {bs})")

        tr, state = trainers["dp"], states["dp"][0]
        points, mask, anchors = build_inputs(tr.cfg, tr.assigner, tr.info,
                                             dev)
        batch = {"points": points, "points_mask": mask, "anchors": anchors}
        dp_eval = make_dp_eval_step(tr.spec, tr.eval_vspec, group,
                                    tr._eval_mask_info)
        reset_counts()
        det, stats = dp_eval(state, batch)
        torch.cuda.synchronize()
        eval_counts = launch_counts()
        want = {"sparse_gather_gemm": SPARSE_CONVS, "rotated_iou": 1,
                "nms_suppress": 1}
        if {k: eval_counts[k] for k in want} != want or \
                not eval_counts["row_gather"]:
            fail(f"dp eval: launches {eval_counts}, expected {want} and "
                 f"row gathers")
        valid = det["valid"].cpu().numpy()
        sc = np.where(valid, det["scores"].cpu().numpy(), -1.0)
        host = [int(valid.sum())] + [int((sc >= t).sum())
                                     for t in SCORE_THRESHOLDS]
        ref = make_eval_step(tr.spec, tr.vspec, tr.eval_vspec,
                             mask_info=tr._eval_mask_info)(state, batch)
        ref_stats = _local_stats(ref).tolist() + \
            [int(ref["voxel_overflow"])]
        if stats[:-1].tolist() != host or stats.tolist() != ref_stats:
            fail(f"dp eval: stats {stats.tolist()}, host count {host}, "
                 f"single-device {ref_stats}")
        if not torch.equal(det["valid"], ref["valid"]) or not all(
                torch.allclose(det[k], ref[k], **DET_TOL)
                for k in ("boxes", "scores")):
            fail("dp eval: detections differ from the single-device eval's")
        report["eval"] = dict(stats=stats_to_dict(stats),
                              launches=eval_counts)
        say(f"dp eval: stats {stats_to_dict(stats)} = a host count of its "
            f"detections = the single-device eval's; detections equal; "
            f"launches {eval_counts}")

        net = state.module
        seen = []
        hook = net.rpn.register_forward_hook(
            lambda mod, args, out: seen.append(args[0]))
        detect(net, tr.spec, tr.eval_vspec, points, mask, anchors,
               device=dev)
        hook.remove()
        bev = seen[0]
        got = make_spatial_forward(net.rpn, group)(bev)
        own = net.rpn(bev)
        equal = all(torch.equal(got[k], own[k]) for k in own)
        if not equal:
            fail("dp spatial: the row-sharded RPN at world size 1 differs "
                 "from its unsharded forward")
        say(f"dp spatial: the fhd RPN on its BEV map {tuple(bev.shape)} "
            f"row-sharded over the group (world size 1: no halo) = its "
            f"unsharded forward, bit for bit")

        T = TEMPORAL_SEQ_FRAMES
        seq = build_temporal(tr.cfg.model, dev, sequence=True)[0]
        prep = ExamplePrep(tr.assigner, tr.info.feature_map_size,
                           PrepConfig(max_points=MAX_POINTS, training=False))
        pc_range = tuple(tr.cfg.model.voxel_generator.point_cloud_range)
        padded = [prep.pad_points(lidar_scan_scene(
            np.random.default_rng(s), pc_range=pc_range,
            num_azimuth=512)[0], np.random.default_rng(0))
            for s in range(T)]
        frames = device_voxelize(
            tr.eval_vspec,
            torch.as_tensor(np.stack([p for p, _ in padded]), device=dev),
            torch.as_tensor(np.stack([m for _, m in padded]), device=dev),
            dev)
        seq_anchors = torch.as_tensor(prep.anchors, device=dev)
        sp = make_sp_sequence_forward(seq, group)(frames, seq_anchors)
        own = seq(frames, seq_anchors)
        if sp["pair_valid"].tolist() != [False] + [True] * (T - 1):
            fail(f"dp sequence: pair_valid {sp['pair_valid'].tolist()}")
        errs = {}
        for k in ("box_preds", "cls_preds"):
            errs[k] = (sp[k][1:] - own[k]).abs().max().item()
            if not torch.allclose(sp[k][1:], own[k], **PRED_TOL):
                fail(f"dp sequence: {k} {errs[k]:.3g} from the unsharded "
                     f"sequence model's")
        same = (sp["proposals"]["indices"][1:] ==
                own["proposals"]["indices"]).float().mean().item()
        report["sequence"] = dict(frames=T, errs=errs, same_proposals=same)
        say(f"dp sequence: {T} frames, the ring a local copy at world size "
            f"1, pair_valid {sp['pair_valid'].tolist()}, its {T - 1} valid "
            f"pairs' stage 1 against the unsharded sequence model within "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; {100 * same:.1f}% of the proposals the same")
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    return counts["dp"], eval_counts, report


if __name__ == "__main__":
    main()
