"""The two-stage `Trainer`'s stage-1 precision against the JAX package's.

JAX's `Trainer` builds the two-stage model with
`build_two_stage_voxelnet(cfg.model)`, which calls `build_voxelnet(cfg)`
with its default, no mixed precision: stage 1 is fp32 on every config,
`enable_mixed_precision: true` included, while the one-stage model follows
that flag. The port's `Trainer(model_type="two_stage")` builds the same:
held here on `second_car_fhd.config` (which asks for mixed precision),
shrunk through `patches` to the tiny sparse pipeline's range, RPN width and
batch, on the CPU."""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import load_pipeline_config as jax_load_config
from second_tpu.models.build import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector_two_stage import \
    build_two_stage_voxelnet as jax_build_two_stage
from second_tpu_torch.config import load_pipeline_config
from second_tpu_torch.models import build_two_stage_voxelnet
from second_tpu_torch.train.run import Trainer

FHD = "second_tpu_torch/configs/second_car_fhd.config"
JAX_FHD = "second_tpu/configs/second_car_fhd.config"
# the tiny sparse pipeline's 16 m x 16 m range at 0.25 m voxels (8 x 8 BEV
# cells after SpMiddleFHD's 8x downsampling), one narrow RPN stage, batch 2
SHRINK = [
    "model.voxel_generator.point_cloud_range=[0, -8, -3, 16, 8, 1]",
    "model.voxel_generator.voxel_size=[0.25, 0.25, 0.1]",
    "model.target_assigner.anchor_generators[0].anchor_ranges="
    "[0, -8, -1.78, 16, 8, -1.78]",
    "model.post_center_limit_range=[0, -8, -3.0, 16, 8, 0.0]",
    "model.rpn.layer_nums=[1]",
    "model.rpn.num_filters=[32]",
    "model.rpn.num_upsample_filters=[32]",
    "train_input_reader.batch_size=2",
    "train_input_reader.max_number_of_voxels=2048",
    "eval_input_reader.max_number_of_voxels=2048",
    "train_input_reader.num_workers=1",
    "train_config.steps_per_eval=0",
    "train_config.save_summary_steps=1",
]


def _trainer(tmp_path, model_type):
    return Trainer(FHD, tmp_path, synthetic=True, dataset_size=2,
                   max_points=3000, total_steps=1, model_type=model_type,
                   patches=SHRINK, device="cpu")


@pytest.fixture(scope="module")
def two_stage(tmp_path_factory):
    tr = _trainer(tmp_path_factory.mktemp("two_stage"), "two_stage")
    yield tr
    tr.logger.close()


def _stage1_outputs(tr):
    """dtypes of the middle's BEV map and the RPN trunk's output in one
    train-mode forward of the Trainer's model on a batch of its own data,
    by forward hooks."""
    seen = {}

    def hook(name, out_of):
        def record(module, inputs, output):
            seen[name] = out_of(output).dtype
        return record
    stage1 = tr.module.stage1
    hooks = [stage1.middle.register_forward_hook(hook("middle",
                                                      lambda o: o[0])),
             stage1.rpn.trunk.register_forward_hook(hook("trunk",
                                                         lambda o: o))]
    try:
        batch = next(tr._batch_iter(2, np.random.default_rng(0)))
        state = tr._init_state()
        tr.train_step(state, batch)
    finally:
        for h in hooks:
            h.remove()
    return seen


def test_two_stage_trainer_stage1_is_fp32(two_stage):
    """The config asks for mixed precision; the two-stage Trainer's stage 1
    keeps every parameter fp32 and computes its middle and RPN trunk in
    fp32 (the parent built them bf16)."""
    tr = two_stage
    assert tr.cfg.train_config.enable_mixed_precision
    stage1 = tr.module.stage1
    assert stage1.middle.dtype is None and stage1.rpn.trunk.dtype is None
    for name, p in tr.module.named_parameters():
        assert p.dtype == torch.float32, name
    assert _stage1_outputs(tr) == {"middle": torch.float32,
                                   "trunk": torch.float32}


def test_one_stage_trainer_keeps_mixed_precision(tmp_path):
    """The one-stage branch keeps the config's flag, as JAX's does: the
    same config's middle and RPN trunk compute in bf16."""
    tr = _trainer(tmp_path, "one_stage")
    try:
        assert tr.module.middle.dtype == torch.bfloat16
        assert tr.module.rpn.trunk.dtype == torch.bfloat16
    finally:
        tr.logger.close()


@pytest.mark.parametrize("mixed", [False, True])
def test_stage1_precision_matches_jax(two_stage, mixed):
    """JAX's two-stage builder gives stage 1 no bf16 `dtype` (its middle's
    and RPN's kwargs) on the same config, with or without the flag, and so
    does the port's Trainer; JAX's one-stage builder under the flag gives
    bf16, as the port's one-stage builder does."""
    jcfg = jax_load_config(JAX_FHD)
    assert jcfg.train_config.enable_mixed_precision
    jcfg.train_config.enable_mixed_precision = mixed
    jmod = jax_build_two_stage(jcfg.model)[0]
    assert dict(jmod.middle_kwargs).get("dtype") is None
    assert dict(jmod.rpn_kwargs)["dtype"] is None
    one = jax_build_voxelnet(jcfg.model, mixed_precision=True)[0]
    assert jnp.dtype(dict(one.middle_kwargs)["dtype"]) == jnp.bfloat16
    assert jnp.dtype(dict(one.rpn_kwargs)["dtype"]) == jnp.bfloat16
    stage1 = two_stage.module.stage1
    assert stage1.middle.dtype is None and stage1.rpn.trunk.dtype is None


def test_two_stage_builder_takes_no_precision():
    """The port's builder has JAX's arguments (plus the port's device and
    seed): no mixed-precision option the reference lacks."""
    params = inspect.signature(build_two_stage_voxelnet).parameters
    jparams = inspect.signature(jax_build_two_stage).parameters
    assert "mixed_precision" not in params and \
        "mixed_precision" not in jparams
    assert set(params) == set(jparams) | {"device", "seed"}
    cfg = load_pipeline_config(FHD)
    net = build_two_stage_voxelnet(cfg.model, 16, device="cpu")[0]
    assert net.stage1.middle.dtype is None
    assert net.stage1.rpn.trunk.dtype is None


def test_two_stage_trainer_step_is_finite(tmp_path):
    """One `Trainer.train` step of the fp32 two-stage model on the shrunk
    fhd config: every logged loss finite."""
    tr = _trainer(tmp_path, "two_stage")
    try:
        state = tr.train(1)
    finally:
        tr.logger.close()
    assert state.step == 1
    log = [json.loads(line) for line in
           (tmp_path / "log.json").read_text().splitlines()]
    steps = [r for r in log if "train.second_loc_loss" in r]
    assert len(steps) == 1
    losses = {k: v for k, v in steps[0].items() if k.endswith("loss")}
    assert "train.loss" in losses and "train.second_cls_loss" in losses
    assert all(np.isfinite(v) for v in losses.values()), losses
