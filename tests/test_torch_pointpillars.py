"""The port's PointPillars forward (`second_tpu_torch`) against the JAX
package's, on the CPU, with the same weights carried across by
`second_tpu_torch.convert`: `DenseBNReLU` and `PillarFeatureNet` in eval and
train mode (the batch statistics after the call, and the gradient through
the max over points where points tie), `PointPillarsScatter` exactly,
the in-graph SAT anchors mask exactly (against JAX's and against the host
mask), the RPN at the real config's widths in fp32 and bf16, the whole
`TINY_PIPELINE` forward and predict with the in-graph mask, the real
PointPillars config at batch 1 on a range cropped to a quarter of its grid,
the converter, and `entry()`. The train step is in
`test_torch_pointpillars_train.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads_config
from second_tpu.data import ExamplePrep as JExamplePrep
from second_tpu.data import PrepConfig as JPrepConfig
from second_tpu.data.synthetic import lidar_scan_scene, sample_scene
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import predict as jax_predict
from second_tpu.models.layers import DenseBNReLU as JDenseBNReLU
from second_tpu.models.middle import PointPillarsScatter as JScatter
from second_tpu.models.rpn import RPN as JRPN
from second_tpu.models.voxel_encoder import PillarFeatureNet as JPFN
from second_tpu.ops.anchors_mask import \
    anchors_mask_from_coords as jax_anchors_mask
from second_tpu.testing import TINY_PIPELINE, tiny_scene_kwargs
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.data import ExamplePrep, PrepConfig
from second_tpu_torch.entry import entry
from second_tpu_torch.models import (build_voxelnet, calibrate_norms_, detect,
                                     init_train_weights_)
from second_tpu_torch.models.layers import DenseBNReLU
from second_tpu_torch.models.middle import PointPillarsScatter
from second_tpu_torch.models.rpn import RPN
from second_tpu_torch.models.voxel_encoder import PillarFeatureNet
from second_tpu_torch.ops.anchors_mask import anchors_mask_from_coords
from second_tpu_torch.ops.voxelize import VoxelizeSpec

from test_torch_model import REPO, _random_variables

PP_CONFIG = (REPO / "second_tpu" / "configs" /
             "pointpillars_car.config").read_text()
TINY_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
TINY_VSIZE = (0.25, 0.25, 4.0)
TINY_VOXELS = 4096           # the tiny grid's 64 x 64 pillars: no overflow
# fp32 tolerance, port against JAX: sums of the same products in another
# order (oneDNN against XLA)
TOL = dict(rtol=1e-4, atol=1e-4)
# the batch statistics after a train-mode call: fp32 means over the rows
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _quarter_config():
    """The real PointPillars config on a range cropped to a quarter of its
    grid (216 x 248 pillars of 432 x 496): every width and depth as
    published, the x range halved, the y range halved about 0."""
    return (PP_CONFIG
            .replace("point_cloud_range: [0, -39.68, -3, 69.12, 39.68, 1]",
                     "point_cloud_range: [0, -19.84, -3, 34.56, 19.84, 1]")
            .replace("anchor_ranges: [0, -39.68, -1.78, 69.12, 39.68, -1.78]",
                     "anchor_ranges: [0, -19.84, -1.78, 34.56, 19.84, -1.78]")
            .replace("post_center_limit_range: [0, -39.68, -5.0, 69.12, "
                     "39.68, 5.0]",
                     "post_center_limit_range: [0, -19.84, -5.0, 34.56, "
                     "19.84, 5.0]"))


def _dense_state(variables, stats=None):
    """A flax `DenseBNReLU`'s variables → the port's `DenseBNReLU`
    state_dict: the [in, out] kernel transposed, the norm's scale, bias and
    running statistics."""
    p = variables["params"]
    s = stats if stats is not None else variables["batch_stats"]
    return {"linear.weight": _t(_np(p["Dense_0"]["kernel"]).T),
            "norm.weight": _t(p["BatchNorm_0"]["scale"]),
            "norm.bias": _t(p["BatchNorm_0"]["bias"]),
            "norm.running_mean": _t(s["BatchNorm_0"]["mean"]),
            "norm.running_var": _t(s["BatchNorm_0"]["var"]),
            "norm.num_batches_tracked": torch.zeros((), dtype=torch.int64)}


def _pillar_inputs(seed=0, duplicate=False):
    """The JAX voxelizer's pillars of two tiny scenes: voxels [2, V, 8, 4],
    num_points, coords zyx, valid. With `duplicate`, the second point of
    every pillar is a copy of its first (a pillar of one point gets it as
    its second), so every pillar's two rows are equal once decorated (the
    slot sums over the voxels that JAX's cluster offset takes are equal
    too) and the max over points ties at every channel."""
    rng = np.random.default_rng(seed)
    pts, masks = [], []
    for _ in range(2):
        p = sample_scene(rng, **tiny_scene_kwargs())[0][:3000]
        pad = np.zeros((3000, 4), np.float32)
        pad[:len(p)] = p
        mask = np.zeros((3000,), bool)
        mask[:len(p)] = True
        pts.append(pad)
        masks.append(mask)
    vspec = JVoxelizeSpec(voxel_size=TINY_VSIZE, point_cloud_range=TINY_RANGE,
                          max_points=8, max_voxels=1024)
    vox = jax_device_voxelize(vspec, jnp.asarray(np.stack(pts)),
                              jnp.asarray(np.stack(masks)))
    voxels = np.array(vox["voxels"])
    num = np.array(vox["num_points"])
    if duplicate:
        some = num >= 1
        voxels[:, :, 1][some] = voxels[:, :, 0][some]
        num = np.where(some, np.maximum(num, 2), num).astype(num.dtype)
    return (voxels, num, np.array(vox["coordinates"]),
            np.array(vox["voxel_valid"]))


@pytest.mark.parametrize("train", [False, True])
def test_dense_bn_relu_matches_jax(train):
    """Linear → flax BatchNorm over all B·V·T rows (padded points and padded
    pillars included) → ReLU: the output within TOL and, in train mode, the
    running statistics after the call within STAT_TOL."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 50, 8, 9)).astype(np.float32)
    x[:, 40:] = 0.0                     # padded pillars
    x[:, :, 5:] = 0.0                   # padded points
    m = JDenseBNReLU(64)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x))
    variables = _random_variables(shapes, np.random.default_rng(1))
    layer = DenseBNReLU(9, 64)
    layer.load_state_dict(_dense_state(variables), strict=True)
    if train:
        want, mut = m.apply(variables, x, train=True,
                            mutable=["batch_stats"])
        layer.train()
        got = layer(_t(x))
        for k, name in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                getattr(layer.norm, name).numpy(),
                _np(mut["batch_stats"]["BatchNorm_0"][k]), **STAT_TOL,
                err_msg=k)
        assert int(layer.norm.num_batches_tracked) == 1
    else:
        want = m.apply(variables, x)
        layer.eval()
        with torch.no_grad():
            got = layer(_t(x))
    assert got.shape == (2, 50, 8, 64)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def _pfn_pair(inputs, with_distance=False):
    voxels, num, coords, _ = inputs
    m = JPFN(num_filters=(16,), voxel_size=TINY_VSIZE, pc_range=TINY_RANGE,
             with_distance=with_distance)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), voxels,
                                           num, coords))
    variables = _random_variables(shapes, np.random.default_rng(2))
    net = PillarFeatureNet(num_filters=(16,), voxel_size=TINY_VSIZE,
                           pc_range=TINY_RANGE, with_distance=with_distance)
    net.layers[0].load_state_dict(_dense_state(
        {"params": variables["params"]["DenseBNReLU_0"],
         "batch_stats": variables["batch_stats"]["DenseBNReLU_0"]}),
        strict=True)
    return m, variables, net


@pytest.mark.parametrize("train,with_distance", [(False, False),
                                                 (True, False),
                                                 (False, True)])
def test_pillar_feature_net_matches_jax(train, with_distance):
    """The pillar encoder on the JAX voxelizer's pillars: 9 decorated
    features (10 with the point's distance), the mask, Linear + BN + ReLU,
    the mask, the max over points; [B, V, 16] within TOL, and in train mode
    the batch statistics after the call within STAT_TOL."""
    inputs = _pillar_inputs()
    voxels, num, coords, _ = inputs
    m, variables, net = _pfn_pair(inputs, with_distance)
    args = (_t(voxels), _t(num), _t(coords))
    if train:
        want, mut = m.apply(variables, voxels, num, coords, train=True,
                            mutable=["batch_stats"])
        net.train()
        got = net(*args)
        stats = mut["batch_stats"]["DenseBNReLU_0"]["BatchNorm_0"]
        np.testing.assert_allclose(net.layers[0].norm.running_mean.numpy(),
                                   _np(stats["mean"]), **STAT_TOL)
        np.testing.assert_allclose(net.layers[0].norm.running_var.numpy(),
                                   _np(stats["var"]), **STAT_TOL)
    else:
        want = m.apply(variables, voxels, num, coords)
        net.eval()
        with torch.no_grad():
            got = net(*args)
    assert got.shape == (2, voxels.shape[1], 16)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_pillar_feature_net_grads_share_ties_like_jax():
    """The gradients of a train-mode encoder output, where the second point
    of each pillar repeats its first (so the max over points ties at every
    channel), against JAX's: the input points' gradient, and the kernel's
    and the norm's, each within 1e-4 of its largest entry. The max shares a
    tied gradient evenly between the copies, as JAX's does; one that gives
    it all to one copy (`torch.max(dim)`) moves the input gradient of both
    copies by half of it. (The parameters' gradients are the same either
    way: the copies' rows are equal.)"""
    inputs = _pillar_inputs(duplicate=True)
    voxels, num, coords, _ = inputs
    assert (num >= 2).sum() > 100
    np.testing.assert_array_equal(voxels[:, :, 1], voxels[:, :, 0])
    m, variables, net = _pfn_pair(inputs)
    r = np.random.default_rng(3).normal(
        size=(2, voxels.shape[1], 16)).astype(np.float32)

    def loss(params, x):
        out, _ = m.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         x, num, coords, train=True, mutable=["batch_stats"])
        return (out * r).sum()
    jgrads, jx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, variables["params"]), jnp.asarray(voxels))
    net.train()
    x = _t(voxels).requires_grad_(True)
    (net(x, _t(num), _t(coords)) * _t(r)).sum().backward()
    jl = jgrads["DenseBNReLU_0"]
    for name, got, want in (
            ("points", x.grad, _np(jx)),
            ("kernel", net.layers[0].linear.weight.grad,
             _np(jl["Dense_0"]["kernel"]).T),
            ("scale", net.layers[0].norm.weight.grad,
             _np(jl["BatchNorm_0"]["scale"])),
            ("bias", net.layers[0].norm.bias.grad,
             _np(jl["BatchNorm_0"]["bias"]))):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_scatter_matches_jax():
    """`PointPillarsScatter`: the canvas (NHWC in JAX, NCHW here) exactly,
    invalid rows dropped, stage_overflow 0; its gradient is the gather of
    the canvas gradient at each valid pillar, exactly, and 0 at invalid
    rows."""
    voxels, num, coords, valid = _pillar_inputs()
    B, V = valid.shape
    valid[:, 900:] = False              # padded pillars, coords zeroed
    coords[:, 900:] = 0
    feats = np.random.default_rng(4).normal(size=(B, V, 16)).astype(
        np.float32)
    m = JScatter(output_shape=(64, 64), num_input_features=16)
    want = m.apply({}, feats, coords, valid)
    scatter = PointPillarsScatter((64, 64), 16)
    f = _t(feats).requires_grad_(True)
    got, overflow = scatter(f, _t(coords), _t(valid))
    assert got.shape == (B, 16, 64, 64) and int(overflow) == 0
    np.testing.assert_array_equal(got.detach().permute(0, 2, 3, 1).numpy(),
                                  _np(want))
    assert 0 < valid.sum() < valid.size
    g = np.random.default_rng(5).normal(size=got.shape).astype(np.float32)
    got.backward(_t(g))
    _, vjp = jax.vjp(lambda x: m.apply({}, x, coords, valid), feats)
    (jgrad,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(f.grad.numpy(), _np(jgrad))
    assert not f.grad.numpy()[~valid].any()


def _mask_cases():
    """(config text, points, voxel size, range, max voxels) of each mask
    case: three tiny scenes, and a LiDAR scan at the real config's range."""
    cases = []
    for seed in range(3):
        pts = np.concatenate(
            [np.random.default_rng(seed).uniform([0, -8, -2], [16, 8, 0],
                                                 (400, 3)),
             np.zeros((400, 1))], 1).astype(np.float32)
        cases.append((TINY_PIPELINE, pts, TINY_VSIZE, TINY_RANGE, 4096))
    pp_range = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    scan = lidar_scan_scene(np.random.default_rng(0), pc_range=pp_range,
                            num_azimuth=512)[0]
    cases.append((PP_CONFIG, scan, (0.16, 0.16, 4.0), pp_range, 12000))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_anchors_mask_matches_jax_and_host(case):
    """`anchors_mask_from_coords` over the JAX voxelizer's coords equals
    JAX's in-graph mask and the host mask (`_compute_anchors_mask`, the
    port's and JAX's, equal to each other), exactly, where voxel_overflow
    is 0; and the port's `sat_mask_info` equals JAX's."""
    text, pts, vsize, rng_, max_voxels = _mask_cases()[case]
    preps = []
    for load, build, Prep, Cfg, kw in (
            (jax_loads_config, jax_build_voxelnet, JExamplePrep, JPrepConfig,
             {}),
            (loads_pipeline_config, build_voxelnet, ExamplePrep, PrepConfig,
             {"device": "cpu"})):
        cfg = load(text)
        _, _, info, assigner, _ = build(cfg.model, **kw)
        preps.append(Prep(assigner, info.feature_map_size,
                          Cfg(max_points=30000, training=False,
                              anchor_area_threshold=1, voxel_size=vsize,
                              pc_range=rng_)))
    jprep, tprep = preps
    jinfo, tinfo = jprep.sat_mask_info(), tprep.sat_mask_info()
    np.testing.assert_array_equal(tinfo[0], jinfo[0])
    assert tinfo[1:] == jinfo[1:]
    host = tprep._compute_anchors_mask(pts)
    np.testing.assert_array_equal(host, jprep._compute_anchors_mask(pts))
    padded, pmask = tprep.pad_points(pts)
    vspec = JVoxelizeSpec(voxel_size=vsize, point_cloud_range=rng_,
                          max_points=8, max_voxels=max_voxels)
    vox = jax_device_voxelize(vspec, jnp.asarray(padded[None]),
                              jnp.asarray(pmask[None]))
    assert int(vox["voxel_overflow"]) == 0
    corners, grid_hw, thr = tinfo
    want = _np(jax_anchors_mask(vox["coordinates"], vox["voxel_valid"],
                                jnp.asarray(corners), grid_hw, thr))
    got = anchors_mask_from_coords(_t(vox["coordinates"]),
                                   _t(vox["voxel_valid"]), corners, grid_hw,
                                   thr)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0], host)
    # the corners as a tensor, as the eval step passes them
    again = anchors_mask_from_coords(_t(vox["coordinates"]),
                                     _t(vox["voxel_valid"]), _t(corners),
                                     grid_hw, thr)
    assert torch.equal(again, got)
    assert 0 < host.sum() < host.size


RPN_KW = dict(layer_nums=(3, 5, 5), layer_strides=(2, 2, 2),
              num_filters=(64, 128, 256), upsample_strides=(1, 2, 4),
              num_upsample_filters=(128, 128, 128), num_class=1,
              num_anchor_per_loc=2, box_code_size=7,
              encode_background_as_zeros=True, use_direction_classifier=True,
              use_groupnorm=False, num_groups=32)


@pytest.mark.parametrize("mixed", [False, True])
def test_rpn_at_pointpillars_widths_matches_jax(mixed):
    """The PointPillars RPN at its published widths (3 stages of 3/5/5
    convs, 64/128/256 channels, stride-2 SAME padding, transposed convs at
    upsample 1, 2 and 4, 384 channels out) on a 64 x 56 BEV crop, from
    converted weights: fp32 within TOL; bf16 trunk (JAX compiled without
    excess precision, so every bf16 cast rounds) with the heads within one
    bf16 unit of their scale, 2^-7 · max|head| (measured: see the assert
    message)."""
    bev = np.random.default_rng(6).normal(size=(2, 64, 56, 64)).astype(
        np.float32)
    m = JRPN(dtype="bfloat16" if mixed else None, **RPN_KW)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), bev))
    variables = _random_variables(shapes, np.random.default_rng(7))
    fwd = jax.jit(lambda v, x: m.apply(v, x))
    if mixed:
        fwd = fwd.lower(variables, bev).compile(
            {"xla_allow_excess_precision": False})
    want = fwd(variables, bev)
    sd = state_dict_from_jax({"params": {"rpn": variables["params"]},
                              "batch_stats": {"rpn":
                                              variables["batch_stats"]}})
    net = RPN(64, dtype=torch.bfloat16 if mixed else None, **RPN_KW)
    net.load_state_dict({k[len("rpn."):]: v for k, v in sd.items()},
                        strict=True)
    net.eval()
    with torch.no_grad():
        got = net(_t(bev).permute(0, 3, 1, 2))
    assert got["trunk"].shape == (2, 384, 32, 28)
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        g = got[k].numpy()
        w = _np(want[k]).reshape(g.shape)
        assert got[k].dtype == torch.float32
        if mixed:
            scale = np.abs(w).max()
            err = np.abs(g - w).max()
            assert err <= 2.0 ** -7 * scale, (k, err, scale)
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=k)


def _calibrated(module, variables, args):
    """The variables with every norm's running statistics set to the batch
    statistics of a train-mode forward on `args` (flax's running update from
    zero statistics, ra = 0.01 · stat, scaled back by 100): eval-mode
    activations then have the scale a trained model's have. JAX's pillar
    encoder feeds its norm offsets of some 1e4-1e5 (ROADMAP §3, the
    cluster-offset axis), so with `_random_variables`' statistics the
    predictions reach 1e3 and the decoded boxes overflow."""
    zero = jax.tree.map(np.zeros_like, variables["batch_stats"])
    _, mut = module.apply({"params": variables["params"],
                           "batch_stats": zero}, *args, train=True,
                          mutable=["batch_stats"])
    return {"params": variables["params"],
            "batch_stats": jax.tree.map(lambda s: np.asarray(s) * 100.0,
                                        mut["batch_stats"])}


def _jax_forward(jcfg, pts, mask, anchors, variables_seed, max_voxels,
                 mask_info):
    """JAX: voxelize, the model's forward from `_random_variables` with
    calibrated norm statistics, the in-graph anchors mask and predict."""
    module, spec, _, _, _ = jax_build_voxelnet(jcfg.model)
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, max_voxels)
    vox = jax_device_voxelize(vspec, jnp.asarray(pts), jnp.asarray(mask))
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    variables = _calibrated(module, _random_variables(
        shapes, np.random.default_rng(variables_seed)), args)
    preds = jax.jit(module.apply)(variables, *args)
    corners, grid_hw, thr = mask_info
    amask = jax_anchors_mask(vox["coordinates"], vox["voxel_valid"],
                             jnp.asarray(corners), grid_hw, thr)
    det = jax_predict(spec, preds, jnp.asarray(anchors), amask)
    return variables, vox, preds, amask, det


def _check_forward(text, pts, mask, anchors, mask_info, max_voxels,
                   variables_seed=1):
    """The JAX and port forwards of one config from the same weights:
    voxels and the anchors mask exact, preds within TOL, `valid` exact, the
    detections within TOL where valid."""
    variables, vox, preds, amask, jdet = _jax_forward(
        jax_loads_config(text), pts, mask, anchors, variables_seed,
        max_voxels, mask_info)
    tcfg = loads_pipeline_config(text)
    net, spec, _, _, _ = build_voxelnet(tcfg.model, device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    vspec = VoxelizeSpec.from_config(tcfg.model.voxel_generator, max_voxels)
    det, tvox, tpreds = detect(net, spec, vspec, pts, mask, anchors,
                               device="cpu", mask_info=mask_info)
    for k in ("voxels", "num_points", "coordinates", "voxel_valid",
              "voxel_overflow"):
        np.testing.assert_array_equal(tvox[k].numpy(), _np(vox[k]),
                                      err_msg=k)
    assert int(tvox["voxel_overflow"]) == 0
    np.testing.assert_array_equal(
        anchors_mask_from_coords(tvox["coordinates"], tvox["voxel_valid"],
                                 *mask_info).numpy(), _np(amask))
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            tpreds[k].numpy(), _np(preds[k]).reshape(tpreds[k].shape),
            **TOL, err_msg=k)
    valid = _np(jdet["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               _np(jdet["boxes"])[valid], **TOL)
    np.testing.assert_allclose(det["scores"].numpy(), _np(jdet["scores"]),
                               **TOL)
    np.testing.assert_array_equal(det["labels"].numpy()[valid],
                                  _np(jdet["labels"])[valid])
    return net, _np(amask)


def test_tiny_pipeline_forward_and_predict_match_jax():
    """`TINY_PIPELINE` (pillar encoder, scatter, 2-stage RPN) at batch 2:
    voxelize → forward → the in-graph anchors mask at threshold 1 →
    predict, port against JAX, fp32; the mask prunes some anchors."""
    cfg = loads_pipeline_config(TINY_PIPELINE)
    _, _, info, assigner, _ = build_voxelnet(cfg.model, device="cpu")
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=3000, training=False,
                                  anchor_area_threshold=1,
                                  voxel_size=TINY_VSIZE, pc_range=TINY_RANGE,
                                  device_anchors_mask=True))
    rng = np.random.default_rng(0)
    examples = []
    for i in range(2):
        p, b, n = sample_scene(rng, **tiny_scene_kwargs())
        if i:                   # an empty far end: the mask prunes there
            p = p[p[:, 0] < 10.0]
        examples.append(prep({"points": p, "gt_boxes": b, "gt_names": n},
                             rng))
    batch = prep.collate(examples)
    assert "anchors_mask" not in batch      # computed on the device
    _, amask = _check_forward(TINY_PIPELINE, batch["points"],
                              batch["points_mask"], batch["anchors"],
                              prep.sat_mask_info(), TINY_VOXELS)
    assert 0 < amask.sum() < amask.size


@pytest.fixture(scope="module")
def quarter_run():
    """The real PointPillars config cropped to a quarter of its grid, at
    batch 1: a LiDAR scan of that range, 20 000 points, 12 000 pillars."""
    text = _quarter_config()
    cfg = loads_pipeline_config(text)
    _, _, info, assigner, _ = build_voxelnet(cfg.model, device="cpu")
    vg = cfg.model.voxel_generator
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=20000, training=False,
                                  anchor_area_threshold=1,
                                  voxel_size=tuple(vg.voxel_size),
                                  pc_range=tuple(vg.point_cloud_range),
                                  device_anchors_mask=True))
    rng = np.random.default_rng(0)
    p, b, n = lidar_scan_scene(rng, pc_range=tuple(vg.point_cloud_range),
                               num_azimuth=512)
    batch = prep.collate([prep({"points": p, "gt_boxes": b,
                                "gt_names": n}, rng)])
    return text, batch, prep.sat_mask_info(), info


def test_pointpillars_config_forward_matches_jax(quarter_run):
    """The PointPillars config at its published widths and depth (64-filter
    pillar encoder, 3-stage RPN 64/128/256 → 384 channels) on a quarter of
    its grid: 248 x 216 pillars, 124 x 108 x 2 anchors, batch 1, fp32, with
    the in-graph mask; port against JAX as in the tiny test."""
    text, batch, mask_info, info = quarter_run
    assert info.feature_map_size == (1, 124, 108)
    net, amask = _check_forward(text, batch["points"], batch["points_mask"],
                                batch["anchors"], mask_info, 12000)
    assert net.middle.out_channels == 64 and net.vfe.layers[0].linear \
        .weight.shape == (64, 9)
    assert amask.shape == (1, 124 * 108 * 2) and 0 < amask.sum()


def test_convert_pointpillars_round_trip():
    """Every flax leaf of the PointPillars model (the tiny pipeline's:
    encoder, RPN, heads) lands in the port's state_dict with its layout
    change and nothing else is there; the tree has no `middle` params, and
    a gradient tree with the params' structure maps to the port's
    parameter names."""
    jcfg = jax_loads_config(TINY_PIPELINE)
    module = jax_build_voxelnet(jcfg.model)[0]
    V, T = 64, 8
    args = (np.zeros((1, V, T, 4), np.float32), np.zeros((1, V), np.int32),
            np.zeros((1, V, 3), np.int32), np.zeros((1, V), bool))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    variables = _random_variables(shapes, np.random.default_rng(8))
    assert "middle" not in variables["params"]
    sd = state_dict_from_jax(variables)
    net = build_voxelnet(loads_pipeline_config(TINY_PIPELINE).model,
                         device="cpu")[0]
    assert set(sd) == set(net.state_dict())
    p, s = variables["params"]["vfe"], variables["batch_stats"]["vfe"]
    np.testing.assert_array_equal(
        sd["vfe.layers.0.linear.weight"].numpy(),
        p["DenseBNReLU_0"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["vfe.layers.0.norm.running_var"].numpy(),
        s["DenseBNReLU_0"]["BatchNorm_0"]["var"])
    conv = variables["params"]["rpn"]["trunk"]["ConvBlock_0"]["Conv_0"]
    np.testing.assert_array_equal(sd["rpn.trunk.convs.0.conv.weight"].numpy(),
                                  conv["kernel"].transpose(3, 2, 0, 1))
    grads = grads_from_jax(variables["params"])
    assert set(grads) == {n for n, _ in net.named_parameters()}


def test_entry_runs_pointpillars_on_the_cpu():
    """`entry(device="cpu")`: the PointPillars config at full width, batch
    1, 20 000 points and 12 000 pillars, flax's initialisers (as JAX's
    `entry()` starts from); its forward gives detections of the post-NMS
    size with finite scores. (Under the initial norm statistics the
    decoded box sizes overflow, in JAX's as in the port's: see
    `_calibrated`.)"""
    forward, args = entry(device="cpu")
    points, points_mask, anchors = args
    assert points.shape == (1, 20000, 4) and anchors.shape == (1, 107136, 7)
    assert points_mask.dtype == torch.bool and points_mask.any()
    det = forward(*args)
    assert det["boxes"].shape == (1, 100, 7)
    assert det["valid"].shape == (1, 100) and det["valid"].dtype == torch.bool
    assert torch.isfinite(det["scores"]).all()


def test_init_weights_cover_the_pillar_encoder():
    """The PointPillars config's encoder under both initialisers: flax's
    (`init_train_weights_`: the [64, 9] Linear a truncated normal of std
    9^-0.5, within 10%, no sample past 2 std of the untruncated normal;
    the 1-D norm at scale 1, bias 0, running statistics 0 and 1) and the
    random eval-test weights (`init_weights_`: a normal of std 9^-0.5, the
    norm's scale in [0.5, 1.5] and running variance in [0.5, 2])."""
    cfg = loads_pipeline_config(PP_CONFIG)
    net = build_voxelnet(cfg.model, device="cpu", seed=4)[0]
    lin, norm = net.vfe.layers[0].linear, net.vfe.layers[0].norm
    std = 9 ** -0.5
    assert lin.weight.shape == (64, 9) and lin.bias is None
    assert abs(lin.weight.std().item() / std - 1) < 0.1
    assert ((0.5 <= norm.weight) & (norm.weight <= 1.5)).all()
    assert ((0.5 <= norm.running_var) & (norm.running_var <= 2.0)).all()
    init_train_weights_(net, 4)
    w = lin.weight.detach()
    assert abs(w.std().item() / std - 1) < 0.1
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    assert torch.equal(norm.weight, torch.ones(64)) and not norm.bias.any()
    assert not norm.running_mean.any()
    assert torch.equal(norm.running_var, torch.ones(64))


def test_calibrate_norms_sets_the_batch_statistics():
    """`calibrate_norms_` leaves the module in eval mode with each norm's
    running statistics equal to the batch statistics of a train-mode
    forward on the same voxels (here the encoder's: the mean and biased
    variance of its Linear output over all B·V·T rows), and its momentum
    as it was."""
    inputs = _pillar_inputs()
    cfg = loads_pipeline_config(TINY_PIPELINE)
    net = build_voxelnet(cfg.model, device="cpu", seed=5)[0]
    calibrate_norms_(net, *map(_t, inputs))
    assert not net.training
    layer = net.vfe.layers[0]
    assert layer.norm.momentum == 0.01
    with torch.no_grad():
        voxels, num, coords, _ = map(_t, inputs)
        mask = (torch.arange(8) < num[..., None]).float()[..., None]
        feats = torch.cat([voxels, voxels[..., :3] - voxels[..., :3].sum(
            -3, keepdim=True) / num.clamp(min=1)[..., None, None].float(),
            voxels[..., :2] - torch.stack(
                [(coords[..., 2] + 0.5) * 0.25, (coords[..., 1] + 0.5) * 0.25
                 - 8.0], -1)[..., None, :]], -1) * mask
        y = layer.linear(feats).reshape(-1, 16)
    torch.testing.assert_close(layer.norm.running_mean, y.mean(0),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(layer.norm.running_var, y.var(0,
                                                              unbiased=False),
                               rtol=1e-4, atol=1e-5)
