"""second_tpu_torch — the PyTorch/CUDA port of `second_tpu`.

The SECOND car.fhd single-frame eval forward (voxelize → VFE-V3 → SpMiddleFHD
sparse 3D backbone → RPN → decode + rotated NMS) and its training (losses,
optimizer stack, train and eval steps, checkpoints, the `Trainer`) in
PyTorch, with the sparse gather-GEMM (forward and input gradient), the
sparse conv's weight gradient, the row gather and the rotated IoU as CUDA
kernels written for Hopper (`csrc/`). The layout mirrors `second_tpu`
(config/, core/, data/, ops/, models/, train/, utils/) so each counterpart
is found by name; the host layer is this package's own copy.

Entry points run on the CUDA card unless the caller passes `device="cpu"`;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
