"""The port's voxel encoders (`second_tpu_torch.models.voxel_encoder`) and
`build_voxelnet` against the JAX package's, on the CPU:
`VoxelFeatureExtractor`, `VoxelFeatureExtractorV2`,
`VoxelFeatureExtractorV3` and `SimpleVoxel`, each with and without
`with_distance`, in eval mode (and the two with norms in train mode,
with their running statistics), from the same numpy-drawn weights; every middle name builds through the port's registry
and runs forward at the grids of `test_round2_parity.py` with the BEV
shape expected there; every encoder name builds through `build_voxelnet`;
a config with `VoxelFeatureExtractor` [32, 128] whose middle's
`num_input_features` stays at 4 builds (the middle takes its width from
the encoder) and its forward matches JAX's; the camera-fusion model builds
and runs with `SpMiddleResNetFHD`; convs wider than 128 channels
(SparseMiddleExtractor's 160-wide chain, a [32, 256] encoder into
SpMiddleFHD) build and match JAX's forward; the [32, 128] encoder trains
through the sparse middle (an fp64 step's gradients against JAX's within
GRAD64_TOL). fp32 within 1e-4 (`TOL`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import linen as nn
from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.data import ExamplePrep, PrepConfig
from second_tpu.data.synthetic import sample_scene
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import compute_loss as jax_compute_loss
from second_tpu.models.middle import MIDDLE_REGISTRY as JAX_MIDDLES
from second_tpu.models.voxel_encoder import VFE_REGISTRY as JAX_VFES
from second_tpu.testing import TINY_SPARSE_PIPELINE, tiny_scene_kwargs
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.state import sum_stage_overflow
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.models import build_voxelnet, init_weights_
from second_tpu_torch.models.fusion import build_fusion_voxelnet
from second_tpu_torch.models.middle import MIDDLE_REGISTRY
from second_tpu_torch.models.voxel_encoder import VFE_REGISTRY
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize

import test_round2_parity
from test_torch_fusion import CAMERA_KEYS, VOX_KEYS, fusion_batch, port_vox
from test_torch_model import MAX_VOXELS, TOL, _random_variables
from test_torch_multiclass import GRAD64_TOL, _port_grads, _rel_err
from test_torch_temporal import one_thread
from test_torch_train import _tiny_batch


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


# the encoders' filters in these tests: two VFE layers for
# VoxelFeatureExtractor, three widths (two layers) for V2
FILTERS = {"VoxelFeatureExtractor": (32, 128),
           "VoxelFeatureExtractorV2": (16, 32, 48),
           "VoxelFeatureExtractorV3": (4,), "SimpleVoxel": (16,)}


def _voxels(rng, B=2, V=64, T=5, C=4):
    """Voxels as the voxelizer gives them: num_points in 0..T, the slots
    past it zero, coords zyx."""
    num = rng.integers(0, T + 1, (B, V)).astype(np.int32)
    vox = rng.normal(0, 2, (B, V, T, C)).astype(np.float32)
    vox *= (np.arange(T) < num[..., None])[..., None]
    coords = rng.integers(0, 16, (B, V, 3)).astype(np.int32)
    return vox, num, coords


def _vfe_state(variables):
    """The converter's entries of a lone encoder tree, by the encoder's
    own names."""
    sd = state_dict_from_jax({
        "params": {"vfe": variables.get("params", {}),
                   "rpn": {"trunk": {}, "head": {}}},
        "batch_stats": {"vfe": variables.get("batch_stats", {})}})
    return {k[len("vfe."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("with_distance", [False, True])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_vfe_matches_jax(name, with_distance):
    """Eval mode (random running statistics): the encoder's output within
    1e-4 of JAX's, its `out_width` the width JAX's output has. The
    maxes are `amax`, the cluster offset sums over the voxels as JAX's,
    SimpleVoxel's reflectance max takes the padded zero slots."""
    rng = np.random.default_rng(len(name) + 10 * with_distance)
    vox, num, coords = _voxels(rng)
    kw = dict(num_filters=FILTERS[name], with_distance=with_distance)
    jmod = JAX_VFES[name](**kw)
    args = tuple(jnp.asarray(a) for a in (vox, num, coords))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(2))
    want = np.asarray(jax.jit(lambda v, *a: jmod.apply(v, *a))(variables,
                                                               *args))
    cls = VFE_REGISTRY[name]
    if cls.takes_point_width:
        kw["num_input_features"] = 4
    port = cls(**kw).eval()
    port.load_state_dict(_vfe_state(variables), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (vox, num, coords)))
    assert cls.out_width(FILTERS[name], 4) == want.shape[-1] == \
        got.shape[-1]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["VoxelFeatureExtractor",
                                  "VoxelFeatureExtractorV2"])
def test_vfe_train_mode_matches_jax(name):
    """Train mode: the norms normalise with the statistics of every row,
    padded points and voxels too, as JAX's; the output and the updated
    running statistics within 1e-4."""
    vox, num, coords = _voxels(np.random.default_rng(3))
    jmod = JAX_VFES[name](num_filters=FILTERS[name])
    args = tuple(jnp.asarray(a) for a in (vox, num, coords))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(4))
    want, state = jax.jit(lambda v, *a: jmod.apply(
        v, *a, train=True, mutable=["batch_stats"]))(variables, *args)
    port = VFE_REGISTRY[name](num_filters=FILTERS[name]).train()
    port.load_state_dict(_vfe_state(variables), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (vox, num, coords)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stats = _vfe_state({"params": variables["params"],
                        "batch_stats": jax.device_get(state["batch_stats"])})
    sd = port.state_dict()
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TOL,
                                       err_msg=k)


# BEV (stride, C*D) of the middles the parity file leaves out, at the fhd
# family's (41, 16, 16) grid; SparseMiddleExtractor as its parity test has
# it: (21, 16, 16), two z-only downs of 16
FHD_FAMILY = {"SpMiddleFHD": (41, 8, 128), "SpMiddleFHDLite": (41, 8, 128),
              "SpMiddleResNetFHD": (41, 8, 128)}


@pytest.mark.parametrize("name", sorted(n for n in JAX_MIDDLES
                                        if n != "PointPillarsScatter"))
def test_every_middle_builds_and_runs(name):
    """Every name of JAX's middle registry builds through the port's and
    runs forward on the CPU (weights from `init_weights_`), with the BEV
    shape `test_round2_parity.py` expects, finite."""
    cases = dict(test_round2_parity.TestMiddleVariants.CASES, **FHD_FAMILY)
    kw = {}
    if name == "SparseMiddleExtractor":
        D, stride, cd = 21, 1, 64
        kw = dict(num_filters_down1=(16,), num_filters_down2=(16, 16))
    else:
        D, stride, cd = cases[name]
    grid = (D, 16, 16)
    rng = np.random.default_rng(0)
    lin = rng.choice(D * 256, size=32, replace=False)
    coords = np.stack([lin // 256, (lin // 16) % 16, lin % 16], -1)
    m = MIDDLE_REGISTRY[name](output_shape=grid, num_input_features=4, **kw)
    init_weights_(m, 0)
    with torch.no_grad():
        bev, overflow = m.eval()(
            torch.from_numpy(rng.normal(size=(1, 32, 4)).astype(np.float32)),
            torch.from_numpy(coords[None].astype(np.int32)),
            torch.ones(1, 32, dtype=torch.bool))
    assert bev.shape == (1, cd, 16 // stride, 16 // stride)
    assert m.out_channels == cd
    assert torch.isfinite(bev).all() and bev.abs().sum() > 0
    assert int(overflow) >= 0


def _pipeline(vfe=None, filters=None, middle=None, down1=None):
    """The tiny sparse pipeline with another encoder (and its filters), or
    another middle (and SparseMiddleExtractor's num_filters_down1); the
    middle's `num_input_features` stays at 4."""
    text = TINY_SPARSE_PIPELINE
    if vfe is not None:
        text = text.replace('module_class_name: "VoxelFeatureExtractorV3"\n'
                            '      num_filters: [4]',
                            f'module_class_name: "{vfe}"\n'
                            f'      num_filters: {list(filters)}')
        assert vfe in text
    if middle is not None:
        extra = f"\n      num_filters_down1: {list(down1)}" if down1 else ""
        text = text.replace('module_class_name: "SpMiddleFHD"',
                            f'module_class_name: "{middle}"{extra}')
        assert middle in text
    return text


def _tiny_voxels(cfg, seed=0, n=2):
    """Two tiny synthetic scenes voxelized by the port."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 3000, 4), np.float32)
    mask = np.zeros((n, 3000), bool)
    for b in range(n):
        p = sample_scene(rng, **tiny_scene_kwargs())[0][:3000]
        pts[b, :len(p)], mask[b, :len(p)] = p, True
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    return pts, mask, device_voxelize(vspec, torch.from_numpy(pts),
                                      torch.from_numpy(mask), "cpu")


@pytest.mark.parametrize("name", sorted(JAX_VFES))
def test_every_vfe_builds_through_build_voxelnet(name):
    """Each encoder name in the tiny sparse pipeline (SpMiddleFHD, whose
    config width stays 4): the middle's first conv takes the encoder's
    output width, and the forward runs with finite outputs."""
    filters = {"PillarFeatureNet": (16,)}.get(name, FILTERS.get(name))
    cfg = loads_pipeline_config(_pipeline(name, filters))
    net = build_voxelnet(cfg.model, device="cpu")[0]
    width = net.middle.subm[0].weight.shape[1]
    assert width == {"VoxelFeatureExtractor": 128,
                     "VoxelFeatureExtractorV2": 48,
                     "PillarFeatureNet": 16}.get(name, 4)
    _, _, vox = _tiny_voxels(cfg)
    with torch.no_grad():
        preds = net(vox["voxels"], vox["num_points"], vox["coordinates"],
                    vox["voxel_valid"])
    assert all(torch.isfinite(preds[k]).all()
               for k in ("box_preds", "cls_preds"))


def test_vfe_128_into_sparse_middle_matches_jax():
    """`VoxelFeatureExtractor` [32, 128] into SpMiddleFHD with the middle's
    config width left at 4: both `build_voxelnet`s size the first SubM
    conv from the encoder (128 -> 16), and the whole forward from JAX's
    voxels and weights (JAX jitted) agrees within 1e-4, its overflow count
    exactly."""
    text = _pipeline("VoxelFeatureExtractor", (32, 128))
    jcfg, cfg = jax_loads(text), loads_pipeline_config(text)
    assert cfg.model.middle_feature_extractor.num_input_features == 4
    jmod = jax_build_voxelnet(jcfg.model)[0]
    net = build_voxelnet(cfg.model, device="cpu")[0]
    _, _, vox = _tiny_voxels(cfg)
    args = tuple(jnp.asarray(vox[k].numpy()) for k in VOX_KEYS)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    assert variables["params"]["middle"]["SubMBlock_0"]["kernel"].shape == \
        (27, 128, 16)
    want, state = jax.jit(lambda v, *a: jmod.apply(
        v, *a, mutable=["intermediates"]))(variables, *args)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = net(*(vox[k] for k in VOX_KEYS))
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
            **TOL, err_msg=k)
    assert int(got["stage_overflow"]) == int(
        sum_stage_overflow(state["intermediates"]))


def test_fusion_model_runs_with_resnet_middle():
    """The camera-fusion detector (the reference's conv fusion family,
    whose config names SpMiddleResNetFHD) builds with the residual middle
    and runs forward on two camera scenes, finite, on the CPU."""
    text = _pipeline(middle="SpMiddleResNetFHD")
    cfg = loads_pipeline_config(text)
    net, _, info, _, _ = build_fusion_voxelnet(cfg.model, device="cpu")
    assert type(net.middle).__name__ == "SparseMiddleResNetFHD"
    jcfg = jax_loads(text)
    _, _, jinfo, jassigner, _ = jax_build_voxelnet(jcfg.model)
    batch = fusion_batch(jcfg, jinfo, jassigner)
    tv = port_vox(cfg, batch["points"], batch["points_mask"])
    with torch.no_grad():
        out = net(*[tv[k] for k in VOX_KEYS],
                  *[torch.from_numpy(np.asarray(batch[k]))
                    for k in CAMERA_KEYS])
    assert out["box_preds"].shape[1] == info.num_anchors
    assert all(torch.isfinite(out[k]).all()
               for k in ("box_preds", "cls_preds"))


@pytest.mark.parametrize("case", ["extractor", "vfe"])
def test_conv_wider_than_128_matches_jax(case):
    """Sparse convs past 128 channels build and run as JAX's: the tiny
    pipeline with SparseMiddleExtractor's 160-wide chain (a submanifold
    conv 4 -> 160, then two z-only strided convs 160 -> 160), or
    `VoxelFeatureExtractor` [32, 256] into SpMiddleFHD (its first conv
    256 -> 16). The whole forward from JAX's voxels and weights (JAX
    jitted) agrees within 1e-4, as the 128-wide encoder's test holds it,
    and its overflow count exactly."""
    text = _pipeline(middle="SparseMiddleExtractor", down1=(160,)) \
        if case == "extractor" else _pipeline("VoxelFeatureExtractor",
                                              (32, 256))
    jcfg, cfg = jax_loads(text), loads_pipeline_config(text)
    jmod = jax_build_voxelnet(jcfg.model)[0]
    net = build_voxelnet(cfg.model, device="cpu")[0]
    widths = [m.weight.shape[1:] for m in net.middle.modules()
              if getattr(m, "weight", None) is not None and
              m.weight.dim() == 3]
    assert max(max(w) for w in widths) == (160 if case == "extractor"
                                           else 256)
    _, _, vox = _tiny_voxels(cfg)
    args = tuple(jnp.asarray(vox[k].numpy()) for k in VOX_KEYS)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    want, state = jax.jit(lambda v, *a: jmod.apply(
        v, *a, mutable=["intermediates"]))(variables, *args)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = net(*(vox[k] for k in VOX_KEYS))
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
            **TOL, err_msg=k)
    assert int(got["stage_overflow"]) == int(
        sum_stage_overflow(state["intermediates"]))


def _jax_grads64_at_encoder(text, variables, batch):
    """JAX's fp64 train-mode loss gradients of `text`'s model (x64, and
    `jnp.float32` read as fp64 while traced, as `jax_grads64`): every
    parameter's from the jitted step, the loss's gradient at the encoder's
    output (a zero added there by a flax method interceptor), and the
    encoder's parameters' from its own vector-Jacobian product with that
    cotangent, op by op. Jitted on the CPU, XLA gives the encoder's own
    train-mode backward wrong (the maxes over the points lose shares of
    their gradient; ROADMAP §3), while the cotangent reaching it and the
    gradients of everything after it are right (within 6e-8 of JAX's
    eager step, which costs some 120 s more). Returns (gradients by the
    port's names, the cotangent [B, V, C])."""
    jcfg = jax_loads(text)
    module, jspec, _, _, _ = jax_build_voxelnet(jcfg.model)
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    vfe = JAX_VFES[jcfg.model.voxel_feature_extractor.module_class_name](
        num_filters=tuple(jcfg.model.voxel_feature_extractor.num_filters))

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f"
                           else a)

    def loss(params, batch_stats, b, delta):
        vox = jax_device_voxelize(vspec, b["points"], b["points_mask"])

        def add_delta(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.module.name == "vfe" and \
                    context.method_name == "__call__":
                out = out + delta
            return out
        with nn.intercept_methods(add_delta):
            preds, _ = module.apply(
                {"params": params, "batch_stats": batch_stats},
                vox["voxels"], vox["num_points"], vox["coordinates"],
                vox["voxel_valid"], train=True,
                mutable=["batch_stats", "intermediates"])
        return jax_compute_loss(jspec, preds, b["labels"], b["reg_targets"],
                                b["anchors"], b["gt_boxes_padded"],
                                b["gt_valid"])["loss"]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jnp, "float32", jnp.float64)
        v = jax.tree.map(f64, variables)
        b = {k: f64(x) for k, x in batch.items()}
        vox = jax_device_voxelize(vspec, b["points"], b["points_mask"])
        args = (vox["voxels"], vox["num_points"], vox["coordinates"])
        delta = jnp.zeros(vox["voxels"].shape[:2] +
                          (vfe.num_filters[-1],), jnp.float64)
        grads, cot = jax.jit(jax.grad(loss, argnums=(0, 3)))(
            v["params"], v["batch_stats"], b, delta)
        with jax.disable_jit():
            _, vjp = jax.vjp(lambda p: vfe.apply(
                {"params": p, "batch_stats": v["batch_stats"]["vfe"]},
                *args, train=True, mutable=["batch_stats"])[0],
                v["params"]["vfe"])
            grads = dict(grads, vfe=vjp(cot)[0])
        return grads_from_jax(jax.device_get(grads)), np.asarray(cot)


def test_vfe_128_train_step_fp64_grads_match_jax():
    """The encoder's parameters train through the active-set sort (its rows
    gathered with a gradient, scattered back by `index_add_`) and the
    first sparse conv's input gradient: one train-mode forward and
    backward in fp64 of the [32, 128] encoder into SpMiddleFHD. The
    gradient at the encoder's output and every parameter's gradient (the
    encoder's among them, nonzero) within GRAD64_TOL of JAX's fp64 ones
    (`_jax_grads64_at_encoder`)."""
    text = _pipeline("VoxelFeatureExtractor", (32, 128))
    jcfg, cfg = jax_loads(text), loads_pipeline_config(text)
    _, _, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=3000, training=True))
    batch = {k: v for k, v in _tiny_batch(prep, seed=2).items()
             if k != "image_idx"}
    jmod = jax_build_voxelnet(jcfg.model)[0]
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS,
                                     shuffle_overflow=True)
    vox = device_voxelize(vspec, torch.from_numpy(batch["points"]),
                          torch.from_numpy(batch["points_mask"]), "cpu")
    args = tuple(jnp.asarray(vox[k].numpy()) for k in VOX_KEYS)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    net, spec = build_voxelnet(cfg.model, device="cpu")[:2]
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    at_encoder = []

    def keep(module, inputs, out):
        out.retain_grad()
        at_encoder.append(out)
    net.vfe.register_forward_hook(keep)
    got = _port_grads(net, spec, vspec, batch, torch.float64)
    want, cot = _jax_grads64_at_encoder(text, variables, batch)
    assert _rel_err(at_encoder[-1].grad.numpy(), cot) < GRAD64_TOL
    assert set(got) == set(want)
    assert any(n.startswith("vfe.vfe_layers.0") for n in got)
    for name, g in got.items():
        assert g.abs().max() > 0, name
        assert _rel_err(g.numpy(), want[name].numpy()) < GRAD64_TOL, name
