"""Multi-class SECOND in the port against the JAX package, on the CPU:
`multiclass_nms` (every class of every example as one batch of the NMS
kernels) against `jax.vmap` of JAX's, the multi-class branch of `predict`
on the same predictions, the forward from converted weights, one train
step's loss and gradients against JAX's eager step (and fault F4 as it
stands), per-class targets with every class positive, and the published
config
(`configs/second_multiclass.config`) built at its real widths."""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.data import ExamplePrep as JExamplePrep
from second_tpu.data import PrepConfig as JPrepConfig
from second_tpu.data.synthetic import sample_scene
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import compute_loss as jax_compute_loss
from second_tpu.models.detector import predict as jax_predict
from second_tpu.ops import nms as jnms
from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from second_tpu.train.state import TrainState as JTrainState
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.state import make_train_step as jax_make_train_step
from second_tpu_torch.config import load_pipeline_config, loads_pipeline_config
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.data import ExamplePrep, PrepConfig
from second_tpu_torch.models import (build_voxelnet, compute_loss, detect,
                                     predict, sparse_middle)
from second_tpu_torch.ops import nms
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import TrainState, make_train_step

from test_torch_model import REPO, _random_variables
from test_torch_ops import _clear_boxes
from test_torch_train import (GRAD_TOL, LOSS_RTOL, SGD_PATCH, _config,
                              _recording, eager_compile_cache)

# the 2-class PointPillars pipeline of the JAX multi-class tests (a copy)
MINI_MULTICLASS = """
model: {
  second: {
    voxel_generator {
      point_cloud_range: [0, -8, -3, 16, 8, 1]
      voxel_size: [0.25, 0.25, 4.0]
      max_number_of_points_per_voxel: 8
    }
    voxel_feature_extractor: {
      module_class_name: "PillarFeatureNet"
      num_filters: [16]
      num_input_features: 4
    }
    middle_feature_extractor: {
      module_class_name: "PointPillarsScatter"
      downsample_factor: 1
      num_input_features: 16
    }
    rpn: {
      module_class_name: "RPNV2"
      layer_nums: [1]
      layer_strides: [2]
      num_filters: [32]
      upsample_strides: [1]
      num_upsample_filters: [32]
      num_input_features: 16
    }
    loss: {
      classification_loss: {
        weighted_sigmoid_focal: { alpha: 0.25 gamma: 2.0 anchorwise_output: true }
      }
      localization_loss: { weighted_smooth_l1: { sigma: 3.0 } }
      classification_weight: 1.0
      localization_weight: 2.0
    }
    use_sigmoid_score: true
    encode_background_as_zeros: true
    encode_rad_error_by_sin: true
    loss_norm_type: NormByNumPositives
    use_rotate_nms: true
    use_multi_class_nms: true
    nms_pre_max_size: 64
    nms_post_max_size: 16
    nms_score_threshold: 0.05
    nms_iou_threshold: 0.3
    num_point_features: 4
    box_coder: { ground_box3d_coder: {} }
    target_assigner: {
      anchor_generators: {
        anchor_generator_range: {
          sizes: [1.6, 3.9, 1.56]
          anchor_ranges: [0, -8, -1.78, 16, 8, -1.78]
          rotations: [0, 1.57]
          matched_threshold: 0.5
          unmatched_threshold: 0.35
          class_name: "Car"
        }
      }
      anchor_generators: {
        anchor_generator_range: {
          sizes: [0.6, 0.8, 1.73]
          anchor_ranges: [0, -8, -1.465, 16, 8, -1.465]
          rotations: [0, 1.57]
          matched_threshold: 0.35
          unmatched_threshold: 0.2
          class_name: "Pedestrian"
        }
      }
      sample_positive_fraction: -1
      sample_size: 512
      region_similarity_calculator: { nearest_iou_similarity: {} }
    }
  }
}
train_input_reader: { batch_size: 2 max_number_of_voxels: 1024 }
train_config: {
  optimizer: {
    adam_optimizer: {
      learning_rate: { one_cycle: { lr_max: 0.003 moms: [0.95, 0.85]
                                    div_factor: 10.0 pct_start: 0.4 } }
      weight_decay: 0.01
    }
    fixed_weight_decay: true
  }
  steps: 100
}
eval_input_reader: { batch_size: 2 max_number_of_voxels: 1024 }
"""

_CAR_GENERATOR = """      anchor_generators: {
        anchor_generator_range: {
          sizes: [1.6, 3.9, 1.56]
          anchor_ranges: [0, -8, -1.78, 16, 8, -1.78]
          rotations: [0, 1.57]
          matched_threshold: 0.5
          unmatched_threshold: 0.35
          class_name: "Car"
        }
      }"""
# the tiny sparse pipeline (VFE-V3, SpMiddleFHD) with the multi-class
# config's three classes and per-class NMS
TINY_SPARSE_MULTICLASS = TINY_SPARSE_PIPELINE.replace(
    _CAR_GENERATOR, _CAR_GENERATOR + """
      anchor_generators: {
        anchor_generator_range: {
          sizes: [0.6, 0.8, 1.73]
          anchor_ranges: [0, -8, -1.465, 16, 8, -1.465]
          rotations: [0, 1.57]
          matched_threshold: 0.35
          unmatched_threshold: 0.2
          class_name: "Pedestrian"
        }
      }
      anchor_generators: {
        anchor_generator_range: {
          sizes: [0.6, 1.76, 1.73]
          anchor_ranges: [0, -8, -1.465, 16, 8, -1.465]
          rotations: [0, 1.57]
          matched_threshold: 0.35
          unmatched_threshold: 0.2
          class_name: "Cyclist"
        }
      }""").replace("use_rotate_nms: true",
                    "use_rotate_nms: true\n    use_multi_class_nms: true")
assert TINY_SPARSE_MULTICLASS.count("anchor_generator_range") == 3
MAX_VOXELS = 2048
# few points: JAX's eager sparse middle costs grow with the active sites
SCENE = dict(pc_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0), num_cars=(1, 2),
             points_per_car=(30, 60), num_ground=300, num_peds=(1, 2),
             num_cyclists=(1, 2))
# denser scenes, whose batch of seed 3 shows fault F4
F4_SCENE = dict(SCENE, num_cars=(2, 3), points_per_car=(40, 120),
                num_ground=1500, num_peds=(2, 3), num_cyclists=(2, 3))


def _mc_batch(prep, n=2, seed=0, scene=SCENE):
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        p, b, names = sample_scene(rng, **scene)
        examples.append(prep({"points": p, "gt_boxes": b, "gt_names": names},
                             rng))
    return {k: v for k, v in prep.collate(examples).items()
            if k != "image_idx"}


def _nms_inputs(rng, C=3):
    """Two examples of 72 clustered BEV boxes (IoUs far from the threshold)
    with C class scores each: scores on a grid of 8 levels (ties), class 2
    of example 1 entirely below the score threshold, ten boxes of example 0
    duplicated, 85% valid."""
    boxes = np.stack([_clear_boxes(rng) for _ in range(2)])
    n = boxes.shape[1]
    boxes[0, 10:20] = boxes[0, 0:10]
    scores = (rng.integers(0, 8, (2, n, C)) / 8).astype(np.float32)
    scores[1, :, 2] = 0.1
    valid = rng.uniform(size=(2, n)) > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("pre,post", [(32, 8), (100, 16)])
def test_multiclass_nms_matches_vmap_jax(pre, post):
    """Indices and keep masks exact, per-class scores within 1e-6, against
    `jax.vmap` of JAX's `multiclass_nms`; ties resolve lowest index first,
    a class with no candidate keeps nothing."""
    boxes, scores, valid = _nms_inputs(np.random.default_rng(40))
    kw = dict(num_classes=3, pre_max_size=pre, post_max_size=post,
              iou_threshold=0.01, score_threshold=0.2)
    want = jax.jit(jax.vmap(lambda b, s, v: jnms.multiclass_nms(
        b, s, v, **kw)))(jnp.asarray(boxes), jnp.asarray(scores),
                         jnp.asarray(valid))
    got = nms.multiclass_nms(torch.from_numpy(boxes),
                             torch.from_numpy(scores),
                             torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=0, atol=1e-6)
    keep = got[1].numpy()
    assert not keep[1, 2].any()                   # the empty class
    assert keep[0].sum(-1).min() > 0 and keep[1, :2].sum(-1).min() > 0
    # a batch of one example against JAX's function on that example
    one = nms.multiclass_nms(torch.from_numpy(boxes[:1]),
                             torch.from_numpy(scores[:1]),
                             torch.from_numpy(valid[:1]), **kw)
    want0 = jax.jit(lambda b, s, v: jnms.multiclass_nms(b, s, v, **kw))(
        jnp.asarray(boxes[0]), jnp.asarray(scores[0]), jnp.asarray(valid[0]))
    np.testing.assert_array_equal(one[0][0].numpy(), np.asarray(want0[0]))
    np.testing.assert_array_equal(one[1][0].numpy(), np.asarray(want0[1]))
    # boxes given as a function of the candidate rows (how predict decodes
    # only the candidates): the same result
    rows = nms.multiclass_nms(
        lambda idx: torch.from_numpy(boxes)[torch.arange(2)[:, None], idx],
        torch.from_numpy(scores), torch.from_numpy(valid), **kw)
    for a, b in zip(rows, got):
        assert torch.equal(a, b)


def test_multiclass_standup_nms_is_refused():
    """Multi-class NMS is rotated only: a config asking for it with
    `use_rotate_nms: false` (no reference: the JAX package's fails on the
    5-wide boxes) is refused when the model is built."""
    text = TINY_SPARSE_MULTICLASS.replace("use_rotate_nms: true",
                                          "use_rotate_nms: false")
    assert "use_rotate_nms: false" in text
    with pytest.raises(NotImplementedError, match="rotated only"):
        build_voxelnet(loads_pipeline_config(text).model, device="cpu")


@pytest.fixture(scope="module")
def sparse_run():
    """TINY_SPARSE_MULTICLASS on both sides from the same random weights:
    the JAX forward's predictions and detections, the port's forward and
    detections from the converted weights, at batch 2."""
    jcfg = jax_loads(TINY_SPARSE_MULTICLASS)
    module, jspec, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    prep = JExamplePrep(assigner, info.feature_map_size,
                        JPrepConfig(max_points=6000, training=False))
    batch = _mc_batch(prep, seed=1)
    pts, mask, anchors = batch["points"], batch["points_mask"], \
        batch["anchors"]
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)
    vox = jax_device_voxelize(vspec, jnp.asarray(pts), jnp.asarray(mask))
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    jpreds = jax.jit(module.apply)(variables, *args)
    jdet = jax.jit(lambda p, a: jax_predict(jspec, p, a))(
        jpreds, jnp.asarray(anchors))

    cfg = loads_pipeline_config(TINY_SPARSE_MULTICLASS)
    net, tspec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tvspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    tdet, _, tpreds = detect(net, tspec, tvspec, pts, mask, anchors,
                             device="cpu")
    return dict(jpreds=jpreds, tpreds=tpreds, jdet=jdet, tdet=tdet)


def test_multiclass_forward_matches_jax(sparse_run):
    """The converted 3-class sparse model: its predictions within 1e-4 of
    JAX's; predict on each side's own predictions gives the same valid
    mask and labels, and boxes within 1e-4."""
    t, j = sparse_run["tpreds"], sparse_run["jpreds"]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(t[k].numpy(),
                                   np.asarray(j[k]).reshape(t[k].shape),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert t["cls_preds"].shape[-1] == 3
    td, jd = sparse_run["tdet"], sparse_run["jdet"]
    valid = np.asarray(jd["valid"])
    np.testing.assert_array_equal(td["valid"].numpy(), valid)
    np.testing.assert_array_equal(td["labels"].numpy(),
                                  np.asarray(jd["labels"]))
    np.testing.assert_allclose(td["boxes"].numpy()[valid],
                               np.asarray(jd["boxes"])[valid], rtol=1e-4,
                               atol=1e-4)
    assert valid.sum() > 0


@pytest.fixture(scope="module")
def mini_preds():
    """MINI_MULTICLASS's specs (JAX's and the port's), its anchors for a
    batch of 2, and random predictions of a trained model's scale."""
    jcfg = jax_loads(MINI_MULTICLASS)
    _, jspec, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    _, tspec, _, _, _ = build_voxelnet(
        loads_pipeline_config(MINI_MULTICLASS).model, device="cpu")
    anchors = np.broadcast_to(
        assigner.generate_anchors(info.feature_map_size)["anchors"].reshape(
            1, -1, 7), (2, info.num_anchors, 7)).astype(np.float32)
    rng = np.random.default_rng(7)
    A = info.num_anchors
    preds = {"box_preds": rng.normal(0, 0.3, (2, A, 7)).astype(np.float32),
             "cls_preds": rng.normal(-3, 1.5, (2, A, 2)).astype(np.float32)}
    return jspec, tspec, anchors, preds


@pytest.mark.parametrize("center_range", [False, True])
def test_multiclass_predict_matches_jax(mini_preds, center_range):
    """`predict`'s multi-class branch on the same predictions as JAX's:
    labels and the valid mask exact, boxes within 1e-5 where valid, scores
    within 1e-6 (0 where not kept, as JAX's); both classes detected. With a
    center range that cuts some detections, the cut is JAX's too."""
    jspec, tspec, anchors, preds = mini_preds
    if center_range:
        lim = (0.0, -8.0, -3.0, 9.0, 4.0, 1.0)
        jspec = jspec.__class__(**{**jspec.__dict__,
                                   "post_center_limit_range": lim})
        tspec = tspec.__class__(**{**tspec.__dict__,
                                   "post_center_limit_range": lim})
    want = jax.jit(lambda p, a: jax_predict(jspec, p, a))(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(anchors))
    got = predict(tspec, {k: torch.from_numpy(v) for k, v in preds.items()},
                  anchors)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_allclose(got["boxes"].numpy()[valid],
                               np.asarray(want["boxes"])[valid], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)
    assert got["boxes"].shape == (2, tspec.nms_post_max_size, 7)
    assert set(got["labels"].numpy()[valid]) == {0, 1}
    scores = got["scores"].numpy()
    assert (scores > 0).sum() == tspec.nms_post_max_size * 2
    if center_range:
        assert 0 < valid.sum() < (scores > 0).sum()


def test_multiclass_targets_have_every_class():
    """The port's per-class target assignment on scenes with cars,
    pedestrians and cyclists: labels 1, 2 and 3 all among the positives."""
    cfg = loads_pipeline_config(TINY_SPARSE_MULTICLASS)
    _, spec, info, assigner, _ = build_voxelnet(cfg.model, device="cpu")
    assert spec.num_class == 3 and spec.use_multi_class_nms
    assert assigner.classes == ["Car", "Pedestrian", "Cyclist"]
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=6000, training=True))
    labels = _mc_batch(prep)["labels"]
    assert {1, 2, 3} <= set(np.unique(labels))


class ReluTap:
    """Stands in for `torch` in the port's sparse middle
    (`models/sparse_middle.py`, whose blocks call `torch.relu`): keeps
    each ReLU's input, in call order, in `pre`; given `masks` (a recorded
    run's `pre[i] > 0`), applies those in place of the ReLU's own."""

    def __init__(self, masks=None):
        self.pre, self.masks = [], masks

    def __getattr__(self, name):
        return getattr(torch, name)

    def relu(self, x):
        self.pre.append(x.detach().clone())
        if self.masks is None:
            return torch.relu(x)
        return x * (self.masks[len(self.pre) - 1] > 0).to(x.dtype)


def _port_grads(net, spec, vspec, batch, dtype, tap=None):
    """The port's parameter gradients of one train-mode forward and
    backward in `dtype` (a copy of `net`), by name; with a `ReluTap`
    standing in for the sparse middle's ReLUs."""
    net = copy.deepcopy(net).to(dtype)
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in b.items()}
    vox = device_voxelize(vspec, b["points"], b["points_mask"], "cpu")
    net.train()
    with pytest.MonkeyPatch.context() as mp:
        if tap is not None:
            mp.setattr(sparse_middle, "torch", tap)
        preds = net(vox["voxels"], vox["num_points"], vox["coordinates"],
                    vox["voxel_valid"])
        compute_loss(spec, preds, b["labels"], b["reg_targets"],
                     b["anchors"], b["gt_boxes_padded"],
                     b["gt_valid"])["loss"].backward()
    return {n: p.grad for n, p in net.named_parameters()}


# jitted fp64 gradient functions by (pipeline, max_voxels): one compile
# serves every batch of those shapes
_JAX_GRAD64 = {}


def jax_grads64(pipeline, variables, batch, max_voxels=MAX_VOXELS,
                eager=False):
    """JAX's train-mode loss gradients of `pipeline` in fp64 on the same
    weights and batch: the independent fp64 witness of the port's fp64
    step. The JAX package pins fp32 in its norms, its sparse-conv
    accumulation and its RPN input (`jnp.float32`), so x64 alone leaves
    those fp32; `jnp.float32` reads as fp64 while the gradient is traced.
    Jitted: XLA's fusion moves fp32 gradients by up to 6% (batch-norm sums
    that cancel, `test_torch_train.py`), but in fp64 the same cancellation
    leaves it within 1e-9 of the eager gradient
    (`test_torch_fp64_jit.py` holds it there); `eager=True` runs it op by
    op under `jax.disable_jit()`. Returns the gradients by the port's
    parameter names."""
    jcfg = jax_loads(pipeline)
    module, jspec, _, _, _ = jax_build_voxelnet(jcfg.model)
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, max_voxels,
                                      shuffle_overflow=True)

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f"
                           else a)

    def loss(params, batch_stats, b):
        vox = jax_device_voxelize(vspec, b["points"], b["points_mask"])
        preds, _ = module.apply(
            {"params": params, "batch_stats": batch_stats},
            vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"], train=True,
            mutable=["batch_stats", "intermediates"])
        return jax_compute_loss(jspec, preds, b["labels"], b["reg_targets"],
                                b["anchors"], b["gt_boxes_padded"],
                                b["gt_valid"])["loss"]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            (jax.disable_jit() if eager else contextlib.nullcontext()), \
            eager_compile_cache():
        mp.setattr(jnp, "float32", jnp.float64)
        v = jax.tree.map(f64, variables)
        b = {k: f64(x) for k, x in batch.items()}
        if eager:
            grad = jax.grad(loss)
        else:
            grad = _JAX_GRAD64.setdefault((pipeline, max_voxels),
                                          jax.jit(jax.grad(loss)))
        grads = grad(v["params"], v["batch_stats"], b)
        assert jax.tree.leaves(grads)[0].dtype == jnp.float64
        return grads_from_jax(jax.device_get(grads))


def mc_inputs(seed, pipeline=TINY_SPARSE_MULTICLASS, scene=SCENE):
    """The batch of 2 `scene`s with every class drawn from `seed` (numpy)
    and the random variables (`_random_variables`, seed 1) of `pipeline`'s
    JAX model."""
    jcfg = jax_loads(pipeline)
    module, _, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    prep = JExamplePrep(assigner, info.feature_map_size,
                        JPrepConfig(max_points=6000, training=True))
    batch = _mc_batch(prep, seed=seed, scene=scene)
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    vox = jax_device_voxelize(vspec, jnp.asarray(batch["points"]),
                              jnp.asarray(batch["points_mask"]))
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return batch, _random_variables(shapes, np.random.default_rng(1))


def mc_train(seed, pipeline=TINY_SPARSE_MULTICLASS, scene=SCENE):
    """One momentum-SGD train step of `pipeline` on a batch of 2 `scene`s
    with every class (drawn from `seed`), JAX eagerly and the port from the
    same converted weights: the metrics and the gradients. Also the same
    step's gradients in fp64, the port's (`grads64`, its sparse middle's
    ReLU inputs `pre64`) and JAX's (`jgrads64`, jitted), and the port's fp32
    gradients with the fp64 ReLU masks replayed (`replayed32`) and its
    fp32 ReLU inputs (`pre32`)."""
    cfg = _config(SGD_PATCH, pipeline)
    jcfg = jax_loads(pipeline)
    jcfg.train_config.optimizer = cfg.train_config.optimizer
    module, jspec, _, _, _ = jax_build_voxelnet(jcfg.model)
    batch, variables = mc_inputs(seed, pipeline, scene)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    grads = []
    tx, _ = jax_build_optimizer(jcfg.train_config.optimizer,
                                jcfg.train_config.steps)
    tx = _recording(tx, grads)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=module.apply)
    with jax.disable_jit(), eager_compile_cache():
        _, jm = jax_make_train_step(jspec, vspec)(state, jbatch)

    net, spec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tvspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    tap64 = ReluTap()
    grads64 = _port_grads(net, spec, tvspec, batch, torch.float64, tap64)
    tap32 = ReluTap(masks=tap64.pre)
    replayed32 = _port_grads(net, spec, tvspec, batch, torch.float32, tap32)
    pre32 = ReluTap()
    _port_grads(net, spec, tvspec, batch, torch.float32, pre32)
    opt, lr_sched = build_optimizer(cfg.train_config.optimizer,
                                    cfg.train_config.steps, net.parameters())
    tgrads = []
    step_opt = opt.step

    def recording_step(count):
        tgrads.append({n: p.grad.clone() for n, p in net.named_parameters()})
        return step_opt(count)
    opt.step = recording_step
    _, tm = make_train_step(spec, tvspec)(
        TrainState(net, opt, 0, lr_sched),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return dict(jm=jax.device_get(jm), jgrads=grads[0], tm=tm,
                tgrads=tgrads[0], grads64=grads64, replayed32=replayed32,
                pre64=tap64.pre, pre32=pre32.pre,
                jgrads64=jax_grads64(pipeline, variables, batch),
                labels=batch["labels"], variables=variables, batch=batch)


@pytest.fixture(scope="module")
def mc_train_runs():
    return mc_train(0)


def test_multiclass_train_step_matches_jax(mc_train_runs):
    """The loss within LOSS_RTOL relative and each part within LOSS_RTOL of
    it, the counts exact, the gradient norm within 1e-4; positives of all
    three classes in the batch."""
    jm, tm = mc_train_runs["jm"], mc_train_runs["tm"]
    assert set(tm) == set(jm)
    loss = float(jm["loss"])
    np.testing.assert_allclose(float(tm["loss"]), loss, rtol=LOSS_RTOL)
    for k in ("cls_loss", "loc_loss", "cls_pos_loss", "cls_neg_loss",
              "dir_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                   atol=LOSS_RTOL * loss, err_msg=k)
    for k in ("num_pos", "voxel_overflow", "stage_overflow"):
        assert int(tm[k]) == int(jm[k]), k
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert {1, 2, 3} <= set(np.unique(mc_train_runs["labels"]))


def test_multiclass_train_step_grads_match_jax(mc_train_runs):
    """Every gradient within GRAD_TOL of its tensor's largest entry; the
    3-class head's gradients among them."""
    want = grads_from_jax(mc_train_runs["jgrads"])
    got = mc_train_runs["tgrads"]
    assert set(want) == set(got)
    for name, w in want.items():
        scale = max(np.abs(w.numpy()).max(), 1e-12)
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    assert got["rpn.head.cls.weight"].shape[0] == 2 * 3 * 3


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# the port's fp64 step against JAX's (jax_grads64), of each tensor's
# largest entry: they agree to 6e-8 on the batches below (some inputs,
# the voxel size among them, stay fp32 constants on both sides), fp32
# rounding lies at 1e-5
GRAD64_TOL = 1e-6
# the port's fp32 step with the fp64 ReLU masks replayed, against its
# fp64 step: 1e-5 of the scale on these batches, 2e-2 without the replay
# where a ReLU flips (fault F4)
REPLAYED_TOL = 1e-4


@pytest.fixture(scope="module")
def f4_run():
    return mc_train(3, scene=F4_SCENE)


@pytest.fixture(scope="module")
def f4_seed1_run():
    return mc_train(1, scene=F4_SCENE)


@pytest.mark.parametrize("run_name", ["mc_train_runs", "f4_seed1_run",
                                      "f4_run"])
def test_multiclass_train_step_fp64_grads_match_jax(request, run_name):
    """Over three batches (seed 0 of the sparse scenes, seeds 1 and 3 of
    the denser F4_SCENE): the loss within LOSS_RTOL of JAX's; the port's
    fp64 gradients within GRAD64_TOL of JAX's fp64 gradients (jitted, within
    1e-9 of its eager ones: `test_torch_fp64_jit.py`), every tensor (the
    independent witness); and the port's fp32 gradients, with
    its fp64 step's ReLU masks replayed in the sparse middle, within
    REPLAYED_TOL of its fp64 ones: the fp32 step differs from exact
    arithmetic only where a ReLU flips."""
    run = request.getfixturevalue(run_name)
    np.testing.assert_allclose(float(run["tm"]["loss"]),
                               float(run["jm"]["loss"]), rtol=LOSS_RTOL)
    assert set(run["jgrads64"]) == set(run["grads64"])
    for name, g in run["grads64"].items():
        assert g.dtype == torch.float64, name
        assert _rel_err(g, run["jgrads64"][name]) < GRAD64_TOL, name
        assert _rel_err(run["replayed32"][name], g) < REPLAYED_TOL, name


def test_f4_sparse_middle_fp32_grads_are_ill_conditioned(f4_run):
    """Fault F4 (ROADMAP §3), a ReLU kink: on the batch of seed 3 of the
    denser scenes (F4_SCENE) the port's fp64 step agrees with JAX's fp64
    step (`test_multiclass_train_step_fp64_grads_match_jax`), and so do
    JAX's fp32 gradients within 1e-4, while the port's fp32 gradients of
    the sparse middle's first stages lie more than 1e-3 of their scale off
    (from the RPN on within 1e-4). The cause: the port's fp32 forward puts
    a ReLU input on the other side of zero than fp64 does, at a site whose
    fp64 input lies within that layer's fp32 rounding; with the fp64 masks
    replayed the port's fp32 gradients agree within REPLAYED_TOL. On seed
    1 of F4_SCENE JAX's fp32 gradients are off as well (7.6e-2 of a
    tensor's scale; `scripts/torch_f4_sparse_grads.py`)."""
    run = f4_run
    want = grads_from_jax(run["jgrads"])
    off = set()
    for name, g in run["tgrads"].items():
        ref = run["jgrads64"][name]
        assert _rel_err(want[name], ref) < 1e-4, name
        if _rel_err(g, ref) > 1e-3:
            off.add(name)
        elif not name.startswith("middle."):
            assert _rel_err(g, ref) < 1e-4, name
    assert off and all(n.startswith("middle.") for n in off)
    assert {"middle.subm.0.weight", "middle.subm.4.weight"} <= off
    flips = 0
    for a, b in zip(run["pre32"], run["pre64"]):
        flip = (a > 0) != (b > 0)
        if flip.any():
            rounding = (a.double() - b).abs().max()
            assert b[flip].abs().max() <= rounding
            flips += int(flip.sum())
    assert flips > 0


def test_second_multiclass_config_builds_at_full_width():
    """The published multi-class config (a byte-for-byte copy of the JAX
    package's) builds on the CPU: 3 classes, per-class rotated NMS,
    211 200 anchors an example, the one-cycle config copied too."""
    path = REPO / "second_tpu_torch" / "configs" / "second_multiclass.config"
    assert path.read_bytes() == (REPO / "second_tpu" / "configs" /
                                 "second_multiclass.config").read_bytes()
    onecycle = "second_car_fhd_onecycle.config"
    assert (REPO / "second_tpu_torch" / "configs" / onecycle).read_bytes() \
        == (REPO / "second_tpu" / "configs" / onecycle).read_bytes()
    cfg = load_pipeline_config(path)
    net, spec, info, assigner, _ = build_voxelnet(cfg.model, device="cpu")
    assert spec.num_class == 3 and spec.use_multi_class_nms
    assert spec.use_rotate_nms and spec.nms_pre_max_size == 1000
    assert info.num_anchors == 211200
    assert net.rpn.head.cls.out_channels == 2 * 3 * 3
