"""The camera–LiDAR fusion modules and the one-stage fusion detector in the
port against the JAX package, on the CPU (the kernels' plain versions),
from JAX's weights carried across with `convert.py`, on the tiny sparse
pipeline (VFE-V3, SpMiddleFHD, the RPN: second_car_fhd.config's stack) with
the JAX fusion tests' 48 x 96 camera image: `ResNetFPN18` (the case where
torch's "nearest" upsampling would differ from JAX's), the projection and
its winner rule, `gather_image_features`, the host projections,
`FusionRPN`; the `FusionVoxelNet` forward, loss, predict, eval step and a
train step (fp64 against JAX's fp64 step), the converter's fusion tree and
the `Trainer` and CLI with `model_type="fusion"`. The helpers here serve
`test_torch_fusion_two_stage.py` and `test_torch_temporal_fusion.py` too.
The JAX side runs jitted."""

import contextlib
import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.data import ExamplePrep as JExamplePrep
from second_tpu.data import PrepConfig as JPrepConfig
from second_tpu.data.synthetic import sample_scene
from second_tpu.data.synthetic import render_synthetic_image, synthetic_calib
from second_tpu.models import fusion as jfusion
from second_tpu.models.detector import compute_loss as jax_compute_loss
from second_tpu.models.detector import predict as jax_predict
from second_tpu.testing import TINY_SPARSE_PIPELINE, tiny_scene_kwargs
from second_tpu.train.state import TrainState as JTrainState
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.steps_multistage import \
    make_fusion_steps as jax_make_fusion_steps
from second_tpu_torch import convert
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.models import compute_loss, predict
from second_tpu_torch.models import fusion
from second_tpu_torch.models.fusion import build_fusion_voxelnet
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.train import run
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.run import Trainer
from second_tpu_torch.train.state import TrainState
from second_tpu_torch.train.steps_multistage import make_fusion_steps

from test_torch_model import _random_variables
from test_torch_multiclass import GRAD64_TOL, _rel_err
from test_torch_temporal import one_thread
from test_torch_train import LOSS_RTOL, SGD_PATCH, _config

IMAGE_HW = (48, 96)
MAX_VOXELS = 2048
VOX_KEYS = ("voxels", "num_points", "coordinates", "voxel_valid")
CAMERA_KEYS = ("image", "proj_pix", "proj_bev", "proj_valid")
# fp32, port against JAX: as test_torch_temporal.py's for the same tensors
# (sums in another order through the sparse middle, the RPN and the FPN)
TOL = dict(rtol=1e-4, atol=1e-4)
# the FPN alone, of its output's largest entry: twenty convs whose fp32
# sums run in another order (oneDNN against XLA)
FPN_TOL = 1e-5
# ... in train mode: each of its 20 norms adds the rounding of its fp32
# batch statistics (flax's mean(x²) − mean(x)², here and in JAX; 1.1e-5
# seen)
FPN_TRAIN_TOL = 5e-5
# the port's fp32 step against its own fp32 backward: the sparse middle's
# backward sums in threads, in no fixed order
STEP_GRAD_TOL = 1e-5
# the two-stage models' proposals an example in the CPU smoke runs of the
# `Trainer` and the CLI (which build them at JAX's 512): the plain ROI-align
# and the refine head on 2 x 512 crops took most of each run's 20-50 s
TRAINER_PROPOSALS = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ the inputs


def camera_scene(rng, image_hw=IMAGE_HW):
    """A tiny scene with the synthetic camera (`synthetic_calib`,
    `render_synthetic_image`, as `SyntheticDataset(with_image=True)` draws
    it) and its flat calib keys."""
    p, b, names = sample_scene(rng, **tiny_scene_kwargs())
    rect, velo2cam, P2 = synthetic_calib(image_hw)
    return {"points": p, "gt_boxes": b, "gt_names": names,
            "image": render_synthetic_image(p, image_hw, rect, velo2cam, P2),
            "img_shape": image_hw, "calib/R0_rect": rect,
            "calib/Tr_velo_to_cam": velo2cam, "calib/P2": P2}


def camera_prep(cfg, info, assigner, zslice=False, training=True):
    """JAX's prep of the fusion examples: the image on the IMAGE_HW canvas,
    the points' projections (and the z-slice grids with `zslice`)."""
    vg = cfg.model.voxel_generator
    return JExamplePrep(assigner, info.feature_map_size, JPrepConfig(
        max_points=3000, training=training, use_fusion=True,
        image_shape=IMAGE_HW, out_stride=info.out_size_factor,
        voxel_size=tuple(vg.voxel_size),
        pc_range=tuple(vg.point_cloud_range), use_zslice=zslice))


def fusion_batch(cfg, info, assigner, seed=0, pairs=False):
    """Two camera scenes through `camera_prep`, with a previous frame each
    (p_points, and the z-slice grids) for `pairs`."""
    prep = camera_prep(cfg, info, assigner, zslice=pairs)
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(2):
        scene = camera_scene(rng)
        if pairs:
            scene["p_points"] = sample_scene(rng, **tiny_scene_kwargs())[0]
        examples.append(prep(scene, rng))
    return {k: v for k, v in prep.collate(examples).items()
            if k != "image_idx"}


def jax_vox(jcfg, points, mask):
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)
    out = jax_device_voxelize(vspec, jnp.asarray(points), jnp.asarray(mask))
    return {k: out[k] for k in VOX_KEYS}


def port_vox(cfg, points, mask):
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    return device_voxelize(vspec, _t(points), _t(mask), "cpu")


def variables_of(jmod, *args, **kwargs):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              **kwargs))
    return _random_variables(shapes, np.random.default_rng(1))


def load_fpn(port_fpn, variables):
    """flax ResNetFPN18 variables → the port's module (`convert._fpn18`)."""
    sd = {}
    convert._fpn18(sd, "fpn", variables["params"],
                   variables.get("batch_stats"))
    port_fpn.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)


# ------------------------------------------------- steps, JAX and port


def _grads_as_params():
    """An optax transformation that sets the parameters to the gradient it
    receives: a jitted JAX step's gradients come out as its params."""
    return optax.GradientTransformation(
        lambda params: optax.EmptyState(),
        lambda grads, state, params: (jax.tree.map(
            lambda g, p: g - p, grads, params), state))


def jax_step64(make_steps, jmod, jspec, jcfg, variables, batch):
    """One step of JAX's train step from `make_steps`, jitted, in fp64 (x64
    on, `jnp.float32` read as fp64 while it is traced, as
    `test_torch_temporal_train.py` does): its metrics, the gradients and
    the batch statistics after it, by the port's names."""
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f"
                           else a)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jnp, "float32", jnp.float64)
        v = jax.tree.map(f64, variables)
        tx = _grads_as_params()
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                            batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]), tx=tx,
                            apply_fn=jmod.apply)
        train_step, _ = make_steps(jspec, vspec)
        state, metrics = train_step(state, {k: f64(x)
                                            for k, x in batch.items()})
        grads, stats = jax.device_get((state.params, state.batch_stats))
        assert jax.tree.leaves(grads)[0].dtype == np.float64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_t", lambda a: torch.from_numpy(
            np.array(a, dtype=np.float64)))
        stats = convert.state_dict_from_jax({"params": grads,
                                             "batch_stats": stats})
        grads = convert.grads_from_jax(grads)
    return jax.device_get(metrics), grads, stats


def port_step(make_steps, net, spec, cfg, batch, dtype):
    """One step of the port's train step from `make_steps` on a copy of
    `net` in `dtype` under momentum SGD: its metrics, the gradients the
    optimizer receives, the state dict after it."""
    net = copy.deepcopy(net).to(dtype)
    opt, lr_sched = build_optimizer(cfg.train_config.optimizer,
                                    cfg.train_config.steps, net.parameters())
    grads = []
    step_opt = opt.step

    def recording_step(count):
        # a parameter no gradient reaches (the temporal-fusion FPN's) gets
        # the zeros the optimizer fills in
        grads.append({n: torch.zeros_like(p) if p.grad is None
                      else p.grad.clone()
                      for n, p in net.named_parameters()})
        return step_opt(count)
    opt.step = recording_step
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    train_step, _ = make_steps(spec, vspec)
    b = {k: _t(v) for k, v in batch.items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    _, metrics = train_step(TrainState(net, opt, 0, lr_sched), b)
    return metrics, grads[0], net.state_dict()


def check_step64(jax_run, port_run, extra_keys=()):
    """The port's fp64 step against JAX's: the metrics within 1e-10 of the
    loss (the counts exact, the gradient norm 1e-6: the port sums it in
    fp32), every gradient within GRAD64_TOL of its scale, the batch
    statistics within 1e-10. Returns the port's gradients."""
    jm, jgrads, jstats = jax_run
    tm, grads, tstats = port_run
    assert set(tm) == set(jm) | set(extra_keys)
    loss = float(jm["loss"])
    for k in jm:
        if k in ("num_pos", "second_num_pos", "voxel_overflow",
                 "stage_overflow"):
            assert int(tm[k]) == int(jm[k]), k
        elif k == "grad_norm":
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                       atol=1e-10 * loss, err_msg=k)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert g.dtype == torch.float64
        assert _rel_err(g, jgrads[name]) < GRAD64_TOL, name
    names = [n for n in jstats if "running" in n]
    assert any(".fpn18." in n for n in names)
    for name in names:
        np.testing.assert_allclose(tstats[name].numpy(), jstats[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    return grads


def check_step32(jax_run, port_run, backward):
    """The port's fp32 step: its loss and parts within LOSS_RTOL of JAX's
    fp64 step's loss, the counts exact, the gradients the optimizer receives
    those of one backward of the same loss (STEP_GRAD_TOL) and grad_norm
    their global norm."""
    jm = jax_run[0]
    tm, tgrads, _ = port_run
    loss = float(jm["loss"])
    for k in jm:
        if k in ("num_pos", "second_num_pos", "voxel_overflow",
                 "stage_overflow"):
            assert int(tm[k]) == int(jm[k]), k
        elif k != "grad_norm":
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                       atol=LOSS_RTOL * loss, err_msg=k)
    for name, g in tgrads.items():
        assert _rel_err(g, backward[name]) < STEP_GRAD_TOL, name
    norm = torch.sqrt(sum((g.double() ** 2).sum()
                          for g in backward.values()))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(norm),
                               rtol=STEP_GRAD_TOL)


def check_tree(net, variables, fresh):
    """The converter's map of `variables` covers every entry of the port
    module's state dict, and nothing else, with equal shapes; it loads
    strictly into `net` and into `fresh` (a second port module of the same
    config); its gradient map names every parameter."""
    sd = state_dict_from_jax(variables)
    want = net.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    n_leaves = len(jax.tree.leaves(variables["params"])) + \
        len(jax.tree.leaves(variables["batch_stats"]))
    n_tracked = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_tracked == n_leaves
    fresh.load_state_dict(sd, strict=True)
    assert set(grads_from_jax(variables["params"])) == \
        {n for n, _ in fresh.named_parameters()}
    return sd


# -------------------------------------------------- Trainer and the CLI


@contextlib.contextmanager
def few_proposals():
    """The `Trainer`'s two-stage builders at TRAINER_PROPOSALS proposals an
    example while the block runs."""
    saved = dict(run._MULTISTAGE)
    for kind in ("fusion_two_stage", "temporal_fusion"):
        build, steps = saved[kind]
        run._MULTISTAGE[kind] = (functools.partial(
            build, num_proposals=TRAINER_PROPOSALS), steps)
    try:
        yield
    finally:
        run._MULTISTAGE.update(saved)


def trainer(tmp_path, model_type, patches=(), synthetic=True,
            image_hw=IMAGE_HW, name="run"):
    path = tmp_path / "tiny_sparse.config"
    path.write_text(TINY_SPARSE_PIPELINE)
    with few_proposals():
        return Trainer(str(path), tmp_path / name, synthetic=synthetic,
                       dataset_size=4, max_points=3000, total_steps=2,
                       model_type=model_type,
                       patches=["train_config.steps_per_eval=0",
                                "train_config.save_summary_steps=1",
                                "train_input_reader.num_workers=1",
                                "eval_input_reader.num_workers=1",
                                *patches],
                       device="cpu", image_hw=image_hw)


def train_and_evaluate(tr, tmp_path, name="run", loss_key="train.loss"):
    """Two steps and an `evaluate` of 2 frames: finite losses logged each
    step, result.pkl and one KITTI txt file a frame. Returns the eval
    detail."""
    try:
        with one_thread():
            state = tr.train(2)
            assert state.step == 2
            detail = tr.evaluate(state, max_frames=2)
    finally:
        tr.logger.close()
    log = [json.loads(line) for line in
           (tmp_path / name / "log.json").read_text().splitlines()]
    steps = [r for r in log if loss_key in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["train.loss"]) and np.isfinite(r[loss_key])
               for r in steps)
    out = tmp_path / name / "eval_results" / "step_2"
    assert (out / "result.pkl").exists()
    assert len(list((out / "txt").iterdir())) == 2
    return detail


def cli_train_and_evaluate(tmp_path, model_type):
    """`python -m second_tpu_torch.train.run` (its `main`) with
    `--model_type` and `--image_hw`: one train step, then `evaluate` on
    two frames writing the eval results (`few_proposals`)."""
    path = tmp_path / "tiny_sparse.config"
    path.write_text(TINY_SPARSE_PIPELINE)
    args = ["--config_path", str(path), "--model_dir", str(tmp_path / "cli"),
            "--synthetic", "--steps", "1", "--dataset_size", "4",
            "--max_points", "3000", "--device", "cpu", "--model_type",
            model_type, "--image_hw", *map(str, IMAGE_HW),
            "--patchs", "train_config.steps_per_eval=0",
            "--patchs", "train_input_reader.num_workers=1",
            "--patchs", "eval_input_reader.num_workers=1"]
    with one_thread(), few_proposals():
        run.main(["train", *args])
        run.main(["evaluate", *args, "--max_frames", "2"])
    out = tmp_path / "cli" / "eval_results" / "step_1"
    assert (out / "result.pkl").exists()
    assert len(list((out / "txt").iterdir())) == 2


# ------------------------------------------------------------ modules


@pytest.fixture(scope="module")
def fpn_run():
    """flax's ResNetFPN18 on a 48 x 96 image from random variables, in
    eval mode and in train mode (its batch statistics), jitted; the port's
    FPN loaded from them."""
    rng = np.random.default_rng(4)
    image = rng.uniform(0, 1, (2, *IMAGE_HW, 3)).astype(np.float32)
    jfpn = jfusion.ResNetFPN18()
    variables = variables_of(jfpn, jnp.asarray(image))
    want = np.asarray(jax.jit(lambda v, x: jfpn.apply(v, x))(
        variables, jnp.asarray(image)))
    want_train, stats = jax.device_get(jax.jit(lambda v, x: jfpn.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                   jnp.asarray(image)))
    net = fusion.ResNetFPN18()
    load_fpn(net, variables)
    return dict(image=image, variables=variables, want=want,
                want_train=np.asarray(want_train), stats=stats, net=net)


def test_resnet_fpn18_matches_flax_at_48x96(fpn_run):
    """P3 of a 48 x 96 image: [2, 256, 6, 12], within FPN_TOL of flax's in
    eval mode (the stride-2 convs' and the max pool's asymmetric "SAME"
    padding, the nearest upsampling with half-pixel centres c5 2 x 3 →
    c4 3 x 6 → c3 6 x 12)."""
    net = fpn_run["net"].eval()
    with torch.no_grad():
        got = net(_nchw(fpn_run["image"]))
    assert tuple(got.shape) == (2, 256, 6, 12)
    assert _rel_err(_nhwc(got), fpn_run["want"]) < FPN_TOL


def test_resnet_fpn18_nearest_exact_is_the_rule(fpn_run, monkeypatch):
    """torch's "nearest" (the source pixel at floor(i · in / out)) instead
    of "nearest-exact" moves P3 by far more than FPN_TOL at 48 x 96, where
    the FPN upsamples 2 x 3 → 3 x 6: JAX's resize takes half-pixel
    centres."""
    interpolate = F.interpolate

    def nearest(x, size=None, mode=None, **kw):
        return interpolate(x, size=size, mode="nearest", **kw)
    monkeypatch.setattr(fusion.F, "interpolate", nearest)
    with torch.no_grad():
        got = fpn_run["net"].eval()(_nchw(fpn_run["image"]))
    assert _rel_err(_nhwc(got), fpn_run["want"]) > 100 * FPN_TOL


def test_resnet_fpn18_train_mode_matches_flax(fpn_run):
    """In train mode: P3 from the batch statistics within FPN_TRAIN_TOL,
    and
    every BatchNorm's running statistics after the step (flax's momentum
    0.9, eps 1e-5) within 1e-5 of flax's."""
    net = copy.deepcopy(fpn_run["net"]).train()
    with torch.no_grad():
        got = net(_nchw(fpn_run["image"]))
    assert _rel_err(_nhwc(got), fpn_run["want_train"]) < FPN_TRAIN_TOL
    sd = {}
    convert._fpn18(sd, "fpn", fpn_run["variables"]["params"],
                   fpn_run["stats"]["batch_stats"])
    after = net.state_dict()
    names = [k for k in sd if "running" in k]
    assert len(names) == 2 * 20
    for k in names:
        np.testing.assert_allclose(after[k[4:]].numpy(), sd[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _projection_inputs(seed=5, B=2, P=3000, Hf=6, Wf=12, C=8, hb=8, wb=8):
    """Random projections with many points to a cell (P points over hb · wb
    cells), some invalid, some pixels off the P3 map (clipped)."""
    rng = np.random.default_rng(seed)
    p3 = rng.normal(size=(B, Hf, Wf, C)).astype(np.float32)
    pix = np.stack([rng.integers(-2, Hf + 2, (B, P)),
                    rng.integers(-2, Wf + 2, (B, P))], -1).astype(np.int32)
    bev = np.stack([rng.integers(0, hb, (B, P)),
                    rng.integers(0, wb, (B, P))], -1).astype(np.int32)
    valid = rng.uniform(size=(B, P)) < 0.6
    return p3, pix, bev, valid, (hb, wb)


def test_project_image_to_bev_matches_jax_on_every_cell():
    """3000 points over 8 x 8 cells (some 30 valid points a cell), 40%
    invalid, pixels off the map clipped: the canvas exactly JAX's jitted
    scatter on every cell (JAX's CPU scatter writes the updates in order,
    so its last valid point wins: the port's rule), and the gradient of a
    weighted sum into P3 exactly `jax.grad`'s (only the winners' pixels
    receive it, as JAX's scatter-set JVP sends it)."""
    p3, pix, bev, valid, hw = _projection_inputs()
    w = np.random.default_rng(6).normal(size=(2, *hw, 8)).astype(np.float32)

    def jf(p):
        out = jfusion.project_image_to_bev(p, jnp.asarray(pix),
                                           jnp.asarray(bev),
                                           jnp.asarray(valid), hw)
        return (out * w).sum(), out
    (_, want), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(p3))
    tp3 = _nchw(p3).requires_grad_(True)
    got = fusion.project_image_to_bev(tp3, _t(pix), _t(bev), _t(valid), hw)
    (got * _nchw(w)).sum().backward()
    np.testing.assert_array_equal(_nhwc(got.detach()), np.asarray(want))
    np.testing.assert_allclose(_nhwc(tp3.grad), np.asarray(jgrad), rtol=0,
                               atol=1e-6)
    assert (np.asarray(want) != 0).any(axis=-1).mean() > 0.9


def test_projection_winner_rule():
    """`projection_winners` on hand-made duplicates: of the valid points
    that share a BEV cell the one with the highest index wins, whatever
    the invalid points around it (an invalid point of a higher index loses
    to a valid lower one; a cell of invalid points only stays empty, -1,
    and its canvas zero). A cell is JAX's flat index row · Wb + col: a
    column past the canvas's width lands in the next row's cell, as in
    JAX, and a point past the last cell writes nothing. Finding: JAX's own
    CPU scatter (`.at[].set(mode="drop")`, jitted or not) writes the
    updates in order, so its last valid point stays — the same winners
    (`test_project_image_to_bev_matches_jax_on_every_cell`), and the
    rule holds JAX's parity on every cell, not on single-writer cells
    only."""
    bev = torch.tensor([[[0, 0], [0, 0], [0, 0], [1, 1], [1, 1], [2, 0],
                         [0, 0], [1, 1], [2, 3], [0, 5]]])
    valid = torch.tensor([[True, True, False, True, False, False, True,
                           False, True, True]])
    win = fusion.projection_winners(bev, valid, (3, 4))
    want = torch.full((1, 12), -1)
    want[0, 0] = 6          # cell (0, 0): valid 0, 1, 6; invalid 2
    want[0, 5] = 9          # cell (1, 1): valid 3 and 9 (at (0, 5))
    want[0, 11] = 8         # cell (2, 3): valid 8
    assert torch.equal(win, want)   # cell (2, 0): its one point invalid
    beyond = fusion.projection_winners(torch.tensor([[[3, 0], [0, 0]]]),
                                       torch.tensor([[True, True]]), (3, 4))
    assert beyond[0, 0] == 1 and (beyond[0, 1:] == -1).all()
    p3 = torch.arange(1.0, 1.0 + 2 * 20).reshape(1, 2, 4, 5)
    pix = (torch.arange(10) % 4).reshape(1, 10, 1).expand(1, 10, 2)
    canvas = fusion.project_image_to_bev(p3, pix, bev, valid, (3, 4))
    assert canvas.shape == (1, 2, 3, 4)
    assert (canvas[0, :, 2, 0] == 0).all()
    assert torch.equal(canvas[0, :, 0, 0], p3[0, :, 2, 2])   # point 6
    assert torch.equal(canvas[0, :, 1, 1], p3[0, :, 1, 1])   # point 9


@pytest.mark.parametrize("bilinear", [False, True])
def test_gather_image_features_matches_jax(bilinear):
    """Fractional (row, col) pixels over a 6 x 12 map, halves among them
    (nearest rounds half to even in both), many off the map (clipped), some
    cells invalid: the port's crops exactly JAX's jitted nearest crops,
    and within 1e-6 of its bilinear ones."""
    rng = np.random.default_rng(7 + bilinear)
    p3 = rng.normal(size=(2, 6, 12, 16)).astype(np.float32)
    idxs = rng.uniform(-2, 14, (2, 5, 7, 2)).astype(np.float32)
    idxs[:, 0, :4] = np.array([0.5, 1.5], np.float32)
    idxs[:, 1, :3] = np.array([2.5, 3.5], np.float32)
    valid = rng.uniform(size=(2, 5, 7)) < 0.8
    want = np.asarray(jax.jit(
        lambda p, i, v: jfusion.gather_image_features(p, i, v, bilinear))(
            jnp.asarray(p3), jnp.asarray(idxs), jnp.asarray(valid)))
    got = fusion.gather_image_features(_nchw(p3), _t(idxs), _t(valid),
                                       bilinear)
    if bilinear:
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(_nhwc(got), want)
    assert (_nhwc(got)[~valid] == 0).all()


def test_host_projections_match_jax():
    """`compute_image_projection` and `compute_bev_zslice_projection`, the
    numpy copies: exactly JAX's on a tiny scene's padded cloud and grid,
    with the synthetic camera and with the KITTI-like one of JAX's test."""
    rng = np.random.default_rng(8)
    p = sample_scene(rng, **tiny_scene_kwargs())[0]
    padded = np.zeros((3000, 4), np.float32)
    padded[:len(p)] = p[:3000]
    mask = np.arange(3000) < len(p)
    pc = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
    calibs = [synthetic_calib(IMAGE_HW),
              (np.eye(4), synthetic_calib()[1],
               np.array([[100.0, 0, 48, 0], [0, 100, 24, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]]))]
    for rect, velo2cam, P2 in calibs:
        args = (padded, mask, rect, velo2cam, P2, IMAGE_HW, pc,
                (0.25, 0.25, 4.0), 8, (8, 8))
        got, want = fusion.compute_image_projection(*args), \
            jfusion.compute_image_projection(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[2].sum() > 100
        zargs = (rect, velo2cam, P2, IMAGE_HW, pc, (0.25, 0.25, 4.0), 8,
                 (8, 8), 4)
        for g, w in zip(fusion.compute_bev_zslice_projection(*zargs),
                        jfusion.compute_bev_zslice_projection(*zargs)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_fusion_rpn_matches_flax():
    """`FusionRPN` alone on the same BEV map and camera inputs (the tiny
    pipeline's RPN widths, a 32-channel trunk, 3000 projected points of a
    camera scene): every output within TOL of flax's (box from the trunk,
    cls and direction from the fused map, the ungated trunk as
    gated_bev_feat, the fused map as gated_concat_feat), in eval mode."""
    cfg = jax_loads(TINY_SPARSE_PIPELINE)
    jmod, _, info, assigner, _ = jfusion.build_fusion_voxelnet(cfg.model)
    kw = dict(jmod.rpn_kwargs)
    jrpn = jfusion.FusionRPN(**kw)
    batch = fusion_batch(cfg, info, assigner, seed=9)
    rng = np.random.default_rng(10)
    bev = rng.normal(size=(2, 8, 8, 128)).astype(np.float32)
    args = [jnp.asarray(bev)] + [jnp.asarray(batch[k]) for k in CAMERA_KEYS]
    variables = variables_of(jrpn, *args)
    want = jax.device_get(jax.jit(lambda v, *a: jrpn.apply(v, *a))(
        variables, *args))
    rpn = fusion.FusionRPN(128, **kw)
    sd = state_dict_from_jax({"params": {"rpn": variables["params"]},
                              "batch_stats": {"rpn": variables["batch_stats"]}
                              })
    rpn.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = rpn.eval()(_nchw(bev), *[_t(batch[k]) for k in CAMERA_KEYS])
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(want[k]).reshape(got[k].shape),
                                   **TOL, err_msg=k)
    for k in ("trunk", "gated_bev_feat", "gated_concat_feat"):
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]), **TOL,
                                   err_msg=k)
    assert got["gated_concat_feat"].shape[1] == 128
    assert batch["proj_valid"].sum() > 100


# --------------------------------------------------- the fusion detector


def models(optimizer=None):
    jcfg, cfg = jax_loads(TINY_SPARSE_PIPELINE), _config(optimizer)
    jcfg.train_config.optimizer = cfg.train_config.optimizer
    jmod, jspec, info, assigner, _ = jfusion.build_fusion_voxelnet(
        jcfg.model)
    net, spec = build_fusion_voxelnet(cfg.model, device="cpu")[:2]
    return jcfg, cfg, jmod, jspec, net, spec, info, assigner


@pytest.fixture(scope="module")
def fwd_run():
    """The fusion detector's eval forward, JAX's and the port's, from the
    same random variables on two camera scenes, with JAX's predict and
    loss (jitted)."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = models()
    batch = fusion_batch(jcfg, info, assigner)
    jv = jax_vox(jcfg, batch["points"], batch["points_mask"])
    cam = [jnp.asarray(batch[k]) for k in CAMERA_KEYS]
    args = [jv[k] for k in VOX_KEYS] + cam
    variables = variables_of(jmod, *args)
    jpreds = jax.device_get(jax.jit(lambda v, *a: jmod.apply(v, *a))(
        variables, *args))
    anchors = jnp.asarray(batch["anchors"])
    jdet = jax.device_get(jax.jit(lambda p, a: jax_predict(jspec, p, a))(
        jpreds, anchors))
    jloss = jax.device_get(jax.jit(lambda p: jax_compute_loss(
        jspec, p, jnp.asarray(batch["labels"]),
        jnp.asarray(batch["reg_targets"]), anchors))(jpreds))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tv = port_vox(cfg, batch["points"], batch["points_mask"])
    with torch.no_grad():
        tpreds = net(*[tv[k] for k in VOX_KEYS],
                     *[_t(batch[k]) for k in CAMERA_KEYS])
        tdet = predict(spec, tpreds, batch["anchors"])
        tloss = compute_loss(spec, tpreds, _t(batch["labels"]),
                             _t(batch["reg_targets"]), _t(batch["anchors"]))
    return dict(jcfg=jcfg, cfg=cfg, jmod=jmod, variables=variables,
                jpreds=jpreds, jdet=jdet, jloss=jloss, tpreds=tpreds,
                tdet=tdet, tloss=tloss, net=net, spec=spec, batch=batch)


def test_fusion_forward_matches_jax(fwd_run):
    """box, cls and direction predictions, the trunk and the fused map
    within TOL of JAX's."""
    jp, tp = fwd_run["jpreds"], fwd_run["tpreds"]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            tp[k].numpy(), np.asarray(jp[k]).reshape(tp[k].shape), **TOL,
            err_msg=k)
    for k in ("gated_bev_feat", "gated_concat_feat"):
        np.testing.assert_allclose(_nhwc(tp[k]), np.asarray(jp[k]), **TOL,
                                   err_msg=k)


def test_fusion_loss_matches_jax(fwd_run):
    """`compute_loss` on each side's predictions: the loss and its parts
    within TOL of JAX's, the positives equal."""
    jl, tl = fwd_run["jloss"], fwd_run["tloss"]
    assert int(tl["num_pos"]) == int(jl["num_pos"]) > 0
    for k in ("loss", "cls_loss_reduced", "loc_loss_reduced",
              "dir_loss_reduced"):
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), **TOL,
                                   err_msg=k)


def test_fusion_predict_matches_jax(fwd_run):
    """`predict` on JAX's predictions: valid and labels exactly JAX's,
    boxes and scores within 1e-5; on the port's own forward the same keep
    set."""
    jp, jdet = fwd_run["jpreds"], fwd_run["jdet"]
    preds = {k: _t(v) for k, v in jp.items()
             if k in ("box_preds", "cls_preds", "dir_cls_preds")}
    det = predict(fwd_run["spec"], preds, fwd_run["batch"]["anchors"])
    valid = np.asarray(jdet["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    np.testing.assert_array_equal(det["labels"].numpy(),
                                  np.asarray(jdet["labels"]))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(det[k].numpy()[valid],
                                   np.asarray(jdet[k])[valid], rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(fwd_run["tdet"]["valid"].numpy(), valid)


def test_fusion_eval_step_matches_jax(fwd_run):
    """`make_fusion_steps`' eval step on the same batch and weights: valid
    exactly JAX's predict's, boxes within TOL."""
    net, spec, batch = fwd_run["net"], fwd_run["spec"], fwd_run["batch"]
    vspec = VoxelizeSpec.from_config(fwd_run["cfg"].model.voxel_generator,
                                     MAX_VOXELS)
    _, eval_step = make_fusion_steps(spec, vspec)
    det = eval_step(TrainState(net, None), {k: _t(v)
                                            for k, v in batch.items()})
    valid = np.asarray(fwd_run["jdet"]["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               np.asarray(fwd_run["jdet"]["boxes"])[valid],
                               **TOL)
    assert int(det["voxel_overflow"]) == 0


def test_convert_fusion_tree(fwd_run):
    """JAX's fusion variables map onto the port's names: every leaf mapped
    (the FPN's auto-named convs and norms among them), none left over, the
    shapes equal; the map loads strictly into a fresh port model, and the
    gradient map names every parameter."""
    fresh = build_fusion_voxelnet(fwd_run["cfg"].model, device="cpu",
                                  seed=3)[0]
    sd = check_tree(fwd_run["net"], fwd_run["variables"], fresh)
    stem = fwd_run["variables"]["params"]["rpn"]["fpn18"]["Conv_0"]
    np.testing.assert_array_equal(
        sd["rpn.fpn18.stem.weight"].numpy(),
        np.asarray(stem["kernel"]).transpose(3, 2, 0, 1))
    assert sd["rpn.fpn18.blocks.2.down.weight"].shape == (128, 64, 1, 1)


@pytest.fixture(scope="module")
def step_runs():
    """One train step on two camera scenes from random variables under
    momentum SGD: JAX's `make_fusion_steps` step in fp64, the port's in
    fp64 and fp32, and one backward of the port's fp32 loss."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = models(SGD_PATCH)
    batch = fusion_batch(jcfg, info, assigner, seed=1)
    jv = jax_vox(jcfg, batch["points"], batch["points_mask"])
    variables = variables_of(jmod, *[jv[k] for k in VOX_KEYS],
                             *[jnp.asarray(batch[k]) for k in CAMERA_KEYS])
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with one_thread():
        tv = port_vox(cfg, batch["points"], batch["points_mask"])
        ref = copy.deepcopy(net).train()
        b = {k: _t(v) for k, v in batch.items()}
        preds = ref(*[tv[k] for k in VOX_KEYS],
                    *[b[k] for k in CAMERA_KEYS])
        compute_loss(spec, preds, b["labels"], b["reg_targets"],
                     b["anchors"])["loss"].backward()
        port = {str(d)[6:]: port_step(make_fusion_steps, net, spec, cfg,
                                      batch, d)
                for d in (torch.float64, torch.float32)}
    return dict(jax=jax_step64(jax_make_fusion_steps, jmod, jspec, jcfg,
                               variables, batch),
                backward={n: p.grad for n, p in ref.named_parameters()},
                **port)


def test_fusion_step64_matches_jax(step_runs):
    """The port's fp64 `make_fusion_steps` train step against JAX's: the
    metrics, every gradient (the FPN's, reached through the projection's
    winners, the gates' and the refine blocks' among them, nonzero) and the
    batch statistics (the FPN's flax norms among them)."""
    grads = check_step64(step_runs["jax"], step_runs["float64"])
    for name in ("rpn.fpn18.stem.weight", "rpn.fpn18.smooth.weight",
                 "rpn.bev_gate.conv.weight", "rpn.crop_gate.conv.weight",
                 "rpn.depth_refine0.conv.weight", "middle.subm.0.weight"):
        assert grads[name].abs().max() > 0, name


def test_fusion_step32_matches_jax(step_runs):
    """The port's fp32 step: the loss and its parts against JAX's fp64
    step (LOSS_RTOL), the gradients those of one fp32 backward."""
    check_step32(step_runs["jax"], step_runs["float32"],
                 step_runs["backward"])


def test_fusion_builder_is_fp32_as_jax():
    """JAX's fusion builder drops the RPN's bf16 `dtype` on a config that
    asks for mixed precision, and so does the port's: every parameter
    fp32, the trunk's dtype None."""
    jcfg = jax_loads(TINY_SPARSE_PIPELINE)
    jcfg.train_config.enable_mixed_precision = True
    assert "dtype" not in dict(jfusion.build_fusion_voxelnet(
        jcfg.model)[0].rpn_kwargs)
    net = build_fusion_voxelnet(jcfg.model, device="cpu")[0]
    assert net.rpn.trunk.dtype is None
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_trainer_fusion_trains_and_evaluates(tmp_path):
    """`Trainer(model_type="fusion", device="cpu", image_hw=(48, 96))` on
    synthetic scans with rendered camera images: the examples carry the
    image on the canvas and valid projections, the eval examples the host
    anchors mask where the config asks for one; two steps with finite
    losses, then `evaluate` on 2 frames."""
    tr = trainer(tmp_path, "fusion")
    assert tr.use_fusion and not tr.use_zslice
    ex = tr.prep(tr.train_ds[0], np.random.default_rng(0))
    assert ex["image"].shape == (*IMAGE_HW, 3) and ex["proj_valid"].any()
    assert not tr.eval_prep._prep.device_anchors_mask
    train_and_evaluate(tr, tmp_path)


def test_cli_fusion_trains_and_evaluates(tmp_path):
    """The CLI with `--model_type fusion --image_hw 48 96`."""
    cli_train_and_evaluate(tmp_path, "fusion")


def test_fusion_entry_points_default_to_the_card(tmp_path):
    """With no CUDA card, the fusion builders and the `Trainer` of every
    fusion type, called without a device, raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from second_tpu_torch.models import (build_fusion_two_stage_voxelnet,
                                         build_temporal_fusion_voxelnet)
    cfg = _config()
    for build in (build_fusion_voxelnet, build_fusion_two_stage_voxelnet,
                  build_temporal_fusion_voxelnet):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(cfg.model)
    path = tmp_path / "tiny_sparse.config"
    path.write_text(TINY_SPARSE_PIPELINE)
    for model_type in run.FUSION_TYPES:
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(str(path), tmp_path / model_type, synthetic=True,
                    model_type=model_type)
