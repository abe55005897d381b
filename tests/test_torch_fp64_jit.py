"""JAX's fp64 train-mode gradients jitted against the same gradients run op
by op, on the CPU. The port's fp64 train steps are held to JAX's fp64
gradients within GRAD64_TOL (1e-6 of a tensor's largest entry:
`test_torch_multiclass.py`, `test_torch_iou_branch.py`), and those run
jitted (`jax_grads64`): one compile serves every batch, where the op-by-op
run compiles each of its operations anew in every process. In fp32, XLA's
fusion of the whole step moves some gradients by up to 6% against the
eager step (batch-norm backward sums that nearly cancel,
`test_torch_train.py`); in fp64 the same reordering stays within JIT_TOL,
three orders inside GRAD64_TOL. This file holds that on every batch the
parity tests use: the three multi-class batches and the IoU branch's."""

import pytest

from test_torch_iou_branch import IOU_PIPELINE, iou_inputs
from test_torch_multiclass import (F4_SCENE, GRAD64_TOL, SCENE,
                                   TINY_SPARSE_MULTICLASS, _rel_err,
                                   jax_grads64, mc_inputs)

# measured worst over the tensors: 1.2e-14 (seed 0), 2.0e-10 (F4 seed 1)
JIT_TOL = 1e-3 * GRAD64_TOL


@pytest.mark.parametrize("case", ["mc_seed0", "mc_f4_seed1", "mc_f4_seed3",
                                  "iou"])
def test_jitted_fp64_grads_match_eager(case):
    """Every gradient tensor of the jitted fp64 run within JIT_TOL of its
    largest entry in the eager run."""
    if case == "iou":
        pipeline = IOU_PIPELINE
        batch, variables = iou_inputs()
    else:
        pipeline = TINY_SPARSE_MULTICLASS
        seed = int(case[-1])
        batch, variables = mc_inputs(seed, scene=SCENE if seed == 0
                                     else F4_SCENE)
    eager = jax_grads64(pipeline, variables, batch, eager=True)
    jitted = jax_grads64(pipeline, variables, batch)
    assert set(eager) == set(jitted)
    for name, g in eager.items():
        assert _rel_err(jitted[name], g) < JIT_TOL, name
