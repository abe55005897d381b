"""second_tpu_torch — the PyTorch/CUDA port of `second_tpu`.

The one-stage detectors — SECOND car.fhd and multi-class (voxelize →
VFE-V3 → SpMiddleFHD sparse 3D backbone → RPN → decode + rotated NMS, per
class where the config asks, with the optional IoU branch) and PointPillars
— and their training (losses, optimizer stack, train and eval steps,
checkpoints, the `Trainer` on KITTI or synthetic scans) in PyTorch, with
the sparse gather-GEMM (forward and input gradient), the sparse conv's
weight gradient, the row gather, the rotated IoU behind NMS and its 3-D
form as CUDA kernels written for Hopper (`csrc/`). The layout mirrors `second_tpu`
(config/, core/, data/, ops/, models/, train/, utils/) so each counterpart
is found by name; the host layer is this package's own copy.

Entry points run on the CUDA card unless the caller passes `device="cpu"`;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
