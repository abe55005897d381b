"""The port's model (`second_tpu_torch.models`) against the JAX package's,
with the same weights carried across by `second_tpu_torch.convert`: the
weight conversion, VFE-V3, SpMiddleFHD and the RPN module by module, and
the whole eval slice (voxelize → forward → predict) on the tiny sparse
pipeline at batch 2, fp32, on the CPU; the mixed-precision (bf16) middle,
RPN and forward against JAX's. Also: the port imports nothing of
JAX or the JAX package, and its entry points refuse to fall back to the CPU
when no card is there."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.data import ExamplePrep, PrepConfig
from second_tpu.data.synthetic import sample_scene
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import predict as jax_predict
from second_tpu.testing import TINY_SPARSE_PIPELINE, tiny_scene_kwargs
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.state import sum_stage_overflow
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import state_dict_from_jax
from second_tpu_torch.entry import entry
from second_tpu_torch.models import build_voxelnet, detect, predict
from second_tpu_torch.models.sparse_middle import _round_cap
from second_tpu_torch.ops import sparse_conv as sp
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize

REPO = Path(__file__).resolve().parents[1]
MAX_VOXELS = 2048          # the tiny sparse pipeline's voxel capacity
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_variables(shapes, rng):
    """Fan-in-scaled kernels, non-trivial norm scales, shifts and running
    statistics, as numpy arrays in the flax variable tree."""
    def draw(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)   # bias, mean
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def slice_run():
    """Both models on the same inputs and weights; the JAX side's forward
    runs once, capturing each top-level module's output."""
    jcfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    module, spec, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=3000, training=False))
    rng = np.random.default_rng(0)
    examples = []
    for _ in range(2):
        p, b, n = sample_scene(rng, **tiny_scene_kwargs())
        examples.append(prep({"points": p, "gt_boxes": b, "gt_names": n},
                             rng))
    batch = prep.collate(examples)
    pts, mask, anchors = batch["points"], batch["points_mask"], \
        batch["anchors"]

    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)
    vox = jax_device_voxelize(vspec, jnp.asarray(pts), jnp.asarray(mask))
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(1))

    def forward(v, *a):
        return module.apply(
            v, *a, mutable=["intermediates"],
            capture_intermediates=lambda m, _: m.name in ("vfe", "middle",
                                                          "rpn"))
    preds, state = jax.jit(forward)(variables, *args)
    inter = state["intermediates"]
    jdet = jax_predict(spec, preds, jnp.asarray(anchors))

    tcfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    net, tspec, _, _, _ = build_voxelnet(tcfg.model, device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tvspec = VoxelizeSpec.from_config(tcfg.model.voxel_generator, MAX_VOXELS)
    tdet, tvox, tpreds = detect(net, tspec, tvspec, pts, mask, anchors,
                                device="cpu")
    return dict(variables=variables, vox=vox, preds=preds, inter=inter,
                jdet=jdet, net=net, tdet=tdet, tvox=tvox, tpreds=tpreds,
                inputs=(pts, mask, anchors), tcfg=tcfg, tvspec=tvspec,
                tspec=tspec, jspec=spec)


def _np(x):
    return np.asarray(x)


def test_convert_round_trip(slice_run):
    """Every flax leaf lands in the port's state_dict with the documented
    layout change, and the port's state_dict has nothing else."""
    v = slice_run["variables"]
    sd = slice_run["net"].state_dict()
    p, s = v["params"], v["batch_stats"]
    expect = {}
    for kind, attr in (("SubMBlock", "subm"), ("DownBlock", "down")):
        i = 0
        while f"{kind}_{i}" in p["middle"]:
            m, ms = p["middle"][f"{kind}_{i}"], s["middle"][f"{kind}_{i}"]
            pre = f"middle.{attr}.{i}"
            expect[f"{pre}.weight"] = m["kernel"]
            bn = m["MaskedBatchNorm_0"]
            expect[f"{pre}.bn.weight"] = bn["scale"]
            expect[f"{pre}.bn.bias"] = bn["bias"]
            expect[f"{pre}.bn.running_mean"] = ms["MaskedBatchNorm_0"]["mean"]
            expect[f"{pre}.bn.running_var"] = ms["MaskedBatchNorm_0"]["var"]
            i += 1
    trunk, tstats = p["rpn"]["trunk"], s["rpn"]["trunk"]
    for kind, attr, conv in (("ConvBlock", "convs", "Conv_0"),
                             ("DeconvBlock", "deconvs", "ConvTranspose_0")):
        i = 0
        while f"{kind}_{i}" in trunk:
            k = trunk[f"{kind}_{i}"][conv]["kernel"]
            pre = f"rpn.trunk.{attr}.{i}"
            # OIHW for convs; (I, O, H, W), spatially flipped, for deconvs
            expect[f"{pre}.conv.weight"] = k.transpose(3, 2, 0, 1) \
                if conv == "Conv_0" else k[::-1, ::-1].transpose(2, 3, 0, 1)
            bn, bs = trunk[f"{kind}_{i}"]["BatchNorm_0"], \
                tstats[f"{kind}_{i}"]["BatchNorm_0"]
            expect[f"{pre}.norm.weight"] = bn["scale"]
            expect[f"{pre}.norm.bias"] = bn["bias"]
            expect[f"{pre}.norm.running_mean"] = bs["mean"]
            expect[f"{pre}.norm.running_var"] = bs["var"]
            expect[f"{pre}.norm.num_batches_tracked"] = np.zeros((), np.int64)
            i += 1
    for i, attr in enumerate(("box", "cls", "dir")):
        c = p["rpn"]["head"][f"Conv_{i}"]
        expect[f"rpn.head.{attr}.weight"] = c["kernel"].transpose(3, 2, 0, 1)
        expect[f"rpn.head.{attr}.bias"] = c["bias"]
    assert set(sd) == set(expect)
    for k, want in expect.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(want),
                                      err_msg=k)


def test_vfe_matches_jax(slice_run):
    vox = slice_run["vox"]
    want = slice_run["inter"]["vfe"]["__call__"][0]
    got = slice_run["net"].vfe(torch.from_numpy(np.array(vox["voxels"])),
                               torch.from_numpy(np.array(vox["num_points"])))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_sparse_middle_matches_jax(slice_run):
    """SpMiddleFHD from the JAX VFE output: the dense BEV map (NHWC there,
    NCHW here) and the stage-capacity overflow count."""
    vox = slice_run["vox"]
    valid = np.array(vox["voxel_valid"])
    vf = np.where(valid[..., None],
                  _np(slice_run["inter"]["vfe"]["__call__"][0]), 0.0)
    want = _np(slice_run["inter"]["middle"]["__call__"][0])
    with torch.no_grad():
        got, overflow = slice_run["net"].middle(
            torch.from_numpy(vf.astype(np.float32)),
            torch.from_numpy(np.array(vox["coordinates"])),
            torch.from_numpy(valid))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    assert int(overflow) == int(sum_stage_overflow(slice_run["inter"]))
    assert int(overflow) > 0     # the stage caps cut sites at this size


def test_rpn_matches_jax(slice_run):
    bev = _np(slice_run["inter"]["middle"]["__call__"][0])
    want = slice_run["inter"]["rpn"]["__call__"][0]
    with torch.no_grad():
        got = slice_run["net"].rpn(
            torch.from_numpy(bev.transpose(0, 3, 1, 2).copy()))
    B = bev.shape[0]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            got[k].numpy(), _np(want[k]).reshape(got[k].shape), **TOL,
            err_msg=k)
    np.testing.assert_allclose(got["trunk"].permute(0, 2, 3, 1).numpy(),
                               _np(want["trunk"]), **TOL)
    assert got["box_preds"].shape[:2] == (B, slice_run["inputs"][2].shape[1])


def test_whole_slice_matches_jax(slice_run):
    """voxelize → forward → predict: voxels exact, preds within 1e-4,
    `valid` exact, boxes/scores/labels within 1e-4 where valid."""
    vox, tvox = slice_run["vox"], slice_run["tvox"]
    for k in ("voxels", "num_points", "coordinates", "voxel_valid",
              "voxel_overflow"):
        np.testing.assert_array_equal(tvox[k].numpy(), _np(vox[k]),
                                      err_msg=k)
    preds, tpreds = slice_run["preds"], slice_run["tpreds"]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            tpreds[k].numpy(), _np(preds[k]).reshape(tpreds[k].shape),
            **TOL, err_msg=k)
    jdet, tdet = slice_run["jdet"], slice_run["tdet"]
    valid = _np(jdet["valid"])
    np.testing.assert_array_equal(tdet["valid"].numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(tdet["boxes"].numpy()[valid],
                               _np(jdet["boxes"])[valid], **TOL)
    # scores follow the NMS keep mask, so they agree past the center-range
    # cut too
    np.testing.assert_allclose(tdet["scores"].numpy(), _np(jdet["scores"]),
                               **TOL)
    np.testing.assert_array_equal(tdet["labels"].numpy()[valid],
                                  _np(jdet["labels"])[valid])


def test_predict_center_range_matches_jax(slice_run):
    """A post-center range that cuts some detections: `valid` drops them,
    while their scores stay those of the NMS keep mask, as in JAX."""
    rng = (0.0, -8.0, -3.0, 8.0, 8.0, 1.0)
    jspec = dataclasses.replace(slice_run["jspec"],
                                post_center_limit_range=rng)
    tspec = dataclasses.replace(slice_run["tspec"],
                                post_center_limit_range=rng)
    anchors = slice_run["inputs"][2]
    jdet = jax_predict(jspec, slice_run["preds"], jnp.asarray(anchors))
    tdet = predict(tspec, slice_run["tpreds"], anchors)
    valid = _np(jdet["valid"])
    np.testing.assert_array_equal(tdet["valid"].numpy(), valid)
    assert 0 < valid.sum() < _np(slice_run["jdet"]["valid"]).sum()
    np.testing.assert_allclose(tdet["scores"].numpy(), _np(jdet["scores"]),
                               **TOL)
    np.testing.assert_allclose(tdet["boxes"].numpy()[valid],
                               _np(jdet["boxes"])[valid], **TOL)


@pytest.fixture(scope="module")
def mixed_run(slice_run):
    """JAX's mixed-precision forward of the same weights and voxels, with
    every module's output, and the port's mixed-precision model. XLA on the
    CPU may keep fp32 through a bf16 round trip (its excess-precision
    rewrite drops the rounding between a bf16 conv and the fp32 norm), so
    the JAX side is compiled without it: every bf16 cast then rounds."""
    jcfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    module = jax_build_voxelnet(jcfg.model, mixed_precision=True)[0]
    vox, variables = slice_run["vox"], slice_run["variables"]
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    fwd = jax.jit(lambda v, *a: module.apply(
        v, *a, mutable=["intermediates"], capture_intermediates=True))
    preds, state = fwd.lower(variables, *args).compile(
        {"xla_allow_excess_precision": False})(variables, *args)
    net, spec, _, _, _ = build_voxelnet(slice_run["tcfg"].model, device="cpu",
                                       mixed_precision=True)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(preds=preds, inter=state["intermediates"], net=net,
                spec=spec)


def _bf16_tensor(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()


def _assert_bf16_rounding_equal(got, want, name):
    """bf16 outputs of one computation in two frameworks: the fp32 sums
    before each rounding differ only in order, so at most 0.1% of the
    entries round the other way, by one bf16 unit (2^-7 of the value), or
    land on the other side of the ReLU's zero by less than 1e-5."""
    assert got.dtype == torch.bfloat16, name
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    diff = np.abs(g - w)
    assert (diff > 0).mean() <= 1e-3, (name, (diff > 0).mean())
    assert np.all(diff <= 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)) +
                  1e-5), name


def test_mixed_precision_middle_blocks_match_jax(slice_run, mixed_run):
    """Each bf16 SpMiddleFHD block, given JAX's input to that block, rounds
    as JAX's does: the fp32 conv sums, the fp32 masked norm and one cast
    back to bf16 after the ReLU. A block computing in fp32, or rounding the
    conv sums to bf16 before the norm, differs in most entries."""
    mid = mixed_run["inter"]["middle"]
    net = mixed_run["net"].middle
    vox = slice_run["vox"]
    valid = torch.from_numpy(np.array(vox["voxel_valid"]))
    vf = torch.from_numpy(np.where(
        valid.numpy()[..., None],
        _np(mixed_run["inter"]["vfe"]["__call__"][0]), 0.0).astype(
            np.float32)).bfloat16()
    grid = net.grid0
    coords, feats, valid, keys = sp.sort_active(
        torch.from_numpy(np.array(vox["coordinates"])), vf, valid, grid)
    caps = [_round_cap(vf.shape[1] * f) for f in net.cap_factors]
    j = 0
    with torch.no_grad():
        for stage, n_subm in enumerate(net.stage_subm):
            rb = sp.subm_rulebook_b(coords, keys, valid, grid)
            for _ in range(n_subm):
                want = mid[f"SubMBlock_{j}"]["__call__"][0]
                got = net.subm[j](feats, coords, keys, valid, grid, rb)
                _assert_bf16_rounding_equal(got, want, f"SubMBlock_{j}")
                feats = _bf16_tensor(want)
                j += 1
            wf, wc, wk, wv, wgrid = mid[f"DownBlock_{stage}"]["__call__"][0]
            got, coords, keys, valid, grid, _ = net.down[stage](
                feats, coords, keys, valid, grid, caps[stage])
            _assert_bf16_rounding_equal(got, wf, f"DownBlock_{stage}")
            np.testing.assert_array_equal(coords.numpy(), _np(wc))
            np.testing.assert_array_equal(keys.numpy(), _np(wk))
            np.testing.assert_array_equal(valid.numpy(), _np(wv))
            assert tuple(grid) == tuple(int(g) for g in wgrid)
            feats = _bf16_tensor(wf)


def test_mixed_precision_rpn_matches_jax(mixed_run):
    """The bf16 RPN trunk and the fp32 heads from JAX's bf16 BEV map:
    within 1e-5 (measured 1.8e-7); an fp32 trunk, or bf16 heads, is off by
    some 1e-3."""
    bev = mixed_run["inter"]["middle"]["__call__"][0]
    want = mixed_run["inter"]["rpn"]["__call__"][0]
    with torch.no_grad():
        got = mixed_run["net"].rpn(_bf16_tensor(bev).permute(0, 3, 1, 2))
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(
            got[k].numpy(), _np(want[k]).reshape(got[k].shape),
            rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["trunk"].permute(0, 2, 3, 1).numpy(),
                               _np(want["trunk"]), rtol=1e-5, atol=1e-5)


def test_mixed_precision_forward(slice_run, mixed_run):
    """The whole mixed-precision forward against JAX's: the middle and the
    RPN trunk compute in bf16, the sparse-conv sums, the norms and the
    heads in fp32. The rare one-unit bf16 rounding differences of the
    middle (see the block test) grow over its 14 convs, so the predictions
    agree to a bf16 unit at their scale, 4e-3 (measured 1.6e-3)."""
    net, spec = mixed_run["net"], mixed_run["spec"]
    pts, mask, anchors = slice_run["inputs"]
    det, _, preds = detect(net, spec, slice_run["tvspec"], pts, mask,
                           anchors, device="cpu")
    assert preds["trunk"].dtype == torch.float32      # norm output, fp32
    assert net.middle.dtype == torch.bfloat16
    assert net.rpn.trunk.dtype == torch.bfloat16
    want = mixed_run["preds"]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        assert preds[k].dtype == torch.float32
        np.testing.assert_allclose(
            preds[k].numpy(), _np(want[k]).reshape(preds[k].shape),
            rtol=0, atol=4e-3, err_msg=k)
    assert det["valid"].shape == slice_run["tdet"]["valid"].shape


PORT_FILES = sorted(p for p in (REPO / "second_tpu_torch").rglob("*.py")
                    if "_build" not in p.parts) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "optax", "second_tpu")


def test_port_imports_nothing_of_jax():
    """AST scan of every port file and chip_smoke.py (the train/ and utils/
    packages and the host runtime among them), then a fresh interpreter
    that imports the port and checks sys.modules."""
    scanned = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"second_tpu_torch/train/run.py", "second_tpu_torch/train/state.py",
            "second_tpu_torch/train/optimizer.py",
            "second_tpu_torch/train/checkpoint.py",
            "second_tpu_torch/utils/kitti_eval.py",
            "second_tpu_torch/models/losses.py",
            "second_tpu_torch/runtime/__init__.py",
            "second_tpu_torch/entry.py",
            "second_tpu_torch/ops/anchors_mask.py",
            "second_tpu_torch/core/voxelize_np.py",
            "second_tpu_torch/ops/roi_align_rotated.py",
            "second_tpu_torch/ops/cuda/roi_align.py",
            "second_tpu_torch/models/second_stage.py",
            "second_tpu_torch/models/detector_two_stage.py",
            "second_tpu_torch/models/fusion.py",
            "second_tpu_torch/models/detector_fusion_two_stage.py",
            "second_tpu_torch/models/temporal.py",
            "second_tpu_torch/data/fake_tracking.py",
            "second_tpu_torch/train/steps_multistage.py"} <= scanned
    bad = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    code = (
        "import sys, importlib, pkgutil\n"
        "import second_tpu_torch\n"
        "for m in pkgutil.walk_packages(second_tpu_torch.__path__, "
        "'second_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card(slice_run):
    """With no CUDA card, the entry points called without a device raise
    instead of running on the CPU: `build_voxelnet`, the voxelizer, `detect`
    (with and without the in-graph anchors mask of `ops/anchors_mask.py`)
    and `entry.entry()`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    pts, mask, anchors = slice_run["inputs"]
    corners = np.zeros((anchors.shape[1], 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        detect(slice_run["net"], slice_run["tspec"], slice_run["tvspec"],
               pts, mask, anchors, mask_info=(corners, (4, 4), 1.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_voxelnet(slice_run["tcfg"].model)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_voxelize(slice_run["tvspec"], pts, mask)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect(slice_run["net"], slice_run["tspec"], slice_run["tvspec"],
               pts, mask, anchors)
