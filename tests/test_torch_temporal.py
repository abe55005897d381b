"""The temporal two-frame detector in the port against the JAX package, on
the CPU (the kernels' plain versions), from JAX's weights carried across
with `convert.py`, on the tiny sparse pipeline (VFE-V3, SpMiddleFHD, the
RPN): the gate against flax; the pair forward (stage 1, the fused map, the
proposals, crops, refine head), `predict_temporal` and the eval step; the
N-frame sequence model against JAX's and against the pair model; the
converter's temporal tree; the builder's precision;
`Trainer(model_type="temporal")` on synthetic pairs and on a
KITTI-tracking tree; and the tracking reader and writer against JAX's.
The train step (the loss and gradients against JAX's fp64 step, the
folded batch statistics) is in `test_torch_temporal_train.py`. The JAX
side runs jitted: eager JAX runs the NMS loops op by op."""

import contextlib
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.data import ExamplePrep as JExamplePrep
from second_tpu.data import PrepConfig as JPrepConfig
from second_tpu.data import tracking as jtracking
from second_tpu.data.synthetic import sample_scene
from second_tpu.models.temporal import GatedBEVFusion as JGatedBEVFusion
from second_tpu.models.temporal import \
    TemporalSequenceVoxelNet as JSequenceNet
from second_tpu.models.temporal import \
    build_temporal_voxelnet as jax_build_temporal
from second_tpu.models.temporal import predict_temporal as jax_predict
from second_tpu.models.second_stage import crop_rois as jax_crop_rois
from second_tpu.testing import TINY_SPARSE_PIPELINE, tiny_scene_kwargs
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.data import tracking
from second_tpu_torch.data.fake_tracking import write_tracking_tree
from second_tpu_torch.models import build_temporal_voxelnet, predict_temporal
from second_tpu_torch.models.second_stage import crop_rois
from second_tpu_torch.models.temporal import GatedBEVFusion
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.train.run import Trainer
from second_tpu_torch.train.state import TrainState
from second_tpu_torch.train.steps_multistage import make_temporal_steps

from test_torch_model import _random_variables
from test_torch_train import _config

NUM_PROPOSALS = 16
MAX_VOXELS = 2048
KEYS = ("voxels", "num_points", "coordinates", "voxel_valid")
# fp32, port against JAX: as test_torch_two_stage.py's (sums in another
# order through the sparse middle, the gate and the RPN; the crops' sample
# coordinates an ulp apart; the decoded detections)
TOL = dict(rtol=1e-4, atol=1e-4)
CROP_TOL = 1e-5
DET_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(optimizer=None):
    """(JAX config, port config, JAX module and spec, port module and spec,
    info, assigner): the temporal detector of the tiny sparse pipeline at
    NUM_PROPOSALS."""
    jcfg, cfg = jax_loads(TINY_SPARSE_PIPELINE), _config(optimizer)
    jcfg.train_config.optimizer = cfg.train_config.optimizer
    jmod, jspec, info, assigner, _ = jax_build_temporal(
        jcfg.model, num_proposals=NUM_PROPOSALS)
    net, spec = build_temporal_voxelnet(cfg.model, NUM_PROPOSALS,
                                        device="cpu")[:2]
    return jcfg, cfg, jmod, jspec, net, spec, info, assigner


def _pair_batch(info, assigner, seed=0):
    """Two pairs of tiny scenes (a current and a previous scan each) through
    JAX's prep: targets of the current frame, p_points / p_points_mask."""
    prep = JExamplePrep(assigner, info.feature_map_size,
                        JPrepConfig(max_points=3000, training=True))
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(2):
        p, b, names = sample_scene(rng, **tiny_scene_kwargs())
        prev = sample_scene(rng, **tiny_scene_kwargs())[0]
        examples.append(prep({"points": p, "p_points": prev, "gt_boxes": b,
                              "gt_names": names}, rng))
    return {k: v for k, v in prep.collate(examples).items()
            if k != "image_idx"}


def _jax_frames(jcfg, batch):
    """JAX's voxelized current and previous frames of `batch`."""
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)

    def vox(p, m):
        out = jax_device_voxelize(vspec, jnp.asarray(p), jnp.asarray(m))
        return {k: out[k] for k in KEYS}
    return vspec, vox(batch["points"], batch["points_mask"]), \
        vox(batch["p_points"], batch["p_points_mask"])


def _port_frames(cfg, batch):
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    return tuple(device_voxelize(vspec, _t(batch[p]), _t(batch[f"{p}_mask"]),
                                 "cpu")
                 for p in ("points", "p_points"))


def _variables(jmod, cur, prev, anchors):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), cur,
                                              prev, anchors))
    return _random_variables(shapes, np.random.default_rng(1))


def test_gated_bev_fusion_matches_flax():
    """The gate on random maps from flax's weights: prev·g + cur·(1−g) with
    g from the 3x3 conv over [prev; cur], within 1e-6."""
    rng = np.random.default_rng(3)
    cur = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    prev = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    gate = JGatedBEVFusion()
    params = gate.init(jax.random.PRNGKey(1), jnp.asarray(cur),
                       jnp.asarray(prev))["params"]
    want = np.asarray(gate.apply({"params": params}, jnp.asarray(cur),
                                 jnp.asarray(prev)))
    net = GatedBEVFusion(8)
    net.load_state_dict(
        {"conv_gating_bev.weight": _t(np.asarray(
            params["conv_gating_bev"]["kernel"]).transpose(3, 2, 0, 1)),
         "conv_gating_bev.bias": _t(params["conv_gating_bev"]["bias"])})
    with torch.no_grad():
        got = net(_t(cur.transpose(0, 3, 1, 2)), _t(prev.transpose(0, 3, 1,
                                                                   2)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


# --------------------------------------------------------------- forward


@pytest.fixture(scope="module")
def fwd_run():
    """The eval forward of both detectors from the same `_random_variables`
    on two pairs, and JAX's predict (jitted)."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = _models()
    batch = _pair_batch(info, assigner)
    _, cur, prev = _jax_frames(jcfg, batch)
    anchors = jnp.asarray(batch["anchors"])
    variables = _variables(jmod, cur, prev, anchors)
    jpreds = jax.jit(lambda v, c, p, a: jmod.apply(v, c, p, a))(
        variables, cur, prev, anchors)
    jdet = jax.device_get(jax.jit(lambda p, a: jax_predict(jspec, p, a))(
        jpreds, anchors))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tcur, tprev = _port_frames(cfg, batch)
    with torch.no_grad():
        tpreds = net(tcur, tprev, _t(batch["anchors"]))
        tdet = predict_temporal(spec, tpreds, batch["anchors"])
    return dict(jcfg=jcfg, cfg=cfg, jmod=jmod, variables=variables,
                jpreds=jax.device_get(jpreds), jdet=jdet, tpreds=tpreds,
                tdet=tdet, net=net, spec=spec, batch=batch, cur=cur,
                prev=prev)


def test_temporal_forward_matches_jax(fwd_run):
    """Stage 1 and the gated BEV map within TOL; the proposals' indices and
    valid exactly JAX's, their boxes within TOL; the refined predictions
    within TOL."""
    jp, tp = fwd_run["jpreds"], fwd_run["tpreds"]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            tp[k].numpy(), np.asarray(jp[k]).reshape(tp[k].shape), **TOL,
            err_msg=k)
    np.testing.assert_allclose(
        tp["gated_bev_feat"].permute(0, 2, 3, 1).numpy(),
        np.asarray(jp["gated_bev_feat"]), **TOL)
    for k in ("indices", "valid"):
        np.testing.assert_array_equal(tp["proposals"][k].numpy(),
                                      np.asarray(jp["proposals"][k]))
    assert tp["proposals"]["valid"].sum() > 0
    np.testing.assert_allclose(tp["proposals"]["boxes"].numpy(),
                               np.asarray(jp["proposals"]["boxes"]), **TOL)
    for k in ("second_box_preds", "second_cls_preds"):
        assert tp[k].shape == (2, NUM_PROPOSALS, jp[k].shape[-1])
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)


def test_temporal_crops_come_from_the_fused_map(fwd_run):
    """The refine head's crops are of the gated BEV map (not the RPN's
    trunk): `crop_rois` of JAX's fused map at JAX's proposal boxes within
    CROP_TOL of JAX's crops, and the port's head on them (the port's own
    forward's crop source) gives JAX's refined predictions within TOL."""
    jp, net = fwd_run["jpreds"], fwd_run["net"]
    roi = net.roi
    fused = np.asarray(jp["gated_bev_feat"])
    boxes = np.asarray(jp["proposals"]["boxes"])
    jcrops = np.asarray(jax.jit(lambda t, b: jax_crop_rois(
        t, b, roi.pc_range, roi.voxel_size, roi.out_stride, roi.crop_size,
        roi.samples))(jnp.asarray(fused), jnp.asarray(boxes)))
    B, N = boxes.shape[:2]
    jcrops = jcrops.reshape(B * N, *jcrops.shape[2:])
    crops = crop_rois(_t(fused.transpose(0, 3, 1, 2)), _t(boxes),
                      roi.pc_range, roi.voxel_size, roi.out_stride,
                      roi.crop_size, roi.samples)
    np.testing.assert_allclose(crops.permute(0, 2, 3, 1).numpy(), jcrops,
                               rtol=0, atol=CROP_TOL)
    assert crops.shape[1] == net.middle.out_channels
    with torch.no_grad():
        out = net.second_rpn(crops)
    enc = out["box_preds"].reshape(B, N, -1).numpy() + \
        np.asarray(jp["proposals"]["box_enc"])
    np.testing.assert_allclose(enc, np.asarray(jp["second_box_preds"]),
                               **TOL)


def test_predict_temporal_matches_jax(fwd_run):
    """`predict_temporal` on JAX's predictions: valid and labels exactly
    JAX's, boxes within DET_TOL, scores within 1e-6; on the port's own
    forward the same keep set as JAX's."""
    jp, jdet = fwd_run["jpreds"], fwd_run["jdet"]
    preds = {k: _t(v) for k, v in jp.items() if k.startswith("second_")}
    preds["proposals"] = {k: _t(v) for k, v in jp["proposals"].items()}
    with torch.no_grad():
        det = predict_temporal(fwd_run["spec"], preds,
                               fwd_run["batch"]["anchors"])
    valid = np.asarray(jdet["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    np.testing.assert_array_equal(det["labels"].numpy(),
                                  np.asarray(jdet["labels"]))
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               np.asarray(jdet["boxes"])[valid], rtol=0,
                               atol=DET_TOL)
    np.testing.assert_allclose(det["scores"].numpy(),
                               np.asarray(jdet["scores"]), rtol=0, atol=1e-6)
    assert valid.sum() > 0
    np.testing.assert_array_equal(fwd_run["tdet"]["valid"].numpy(), valid)


def test_sequence_model_matches_jax_and_the_pair_model(fwd_run):
    """`TemporalSequenceVoxelNet` on a T = 3 sequence (the two pairs' frames:
    prev 0, cur 0, cur 1), loaded from the pair model's state dict: its
    outputs for the T - 1 adjacent pairs within TOL of JAX's sequence model
    and of the port's pair model on the same pairs, the proposals exactly
    both's."""
    jmod, variables = fwd_run["jmod"], fwd_run["variables"]
    cur, prev = fwd_run["cur"], fwd_run["prev"]
    frames = {k: jnp.concatenate([prev[k][:1], cur[k][:1], cur[k][1:2]])
              for k in KEYS}
    anchors = jnp.asarray(fwd_run["batch"]["anchors"][0])
    jseq = JSequenceNet(
        vfe_class_name=jmod.vfe_class_name, vfe_kwargs=jmod.vfe_kwargs,
        middle_class_name=jmod.middle_class_name,
        middle_kwargs=jmod.middle_kwargs, rpn_kwargs=jmod.rpn_kwargs,
        spec=jmod.spec, pspec=jmod.pspec, roi=jmod.roi)
    jp = jax.device_get(jax.jit(lambda v, f, a: jseq.apply(v, f, a))(
        variables, frames, anchors))
    seq = build_temporal_voxelnet(fwd_run["cfg"].model, NUM_PROPOSALS,
                                  device="cpu", sequence=True)[0]
    seq.load_state_dict(fwd_run["net"].state_dict(), strict=True)
    tframes = {k: _t(v) for k, v in frames.items()}
    pair_cur = {k: v[1:] for k, v in tframes.items()}
    pair_prev = {k: v[:-1] for k, v in tframes.items()}
    with torch.no_grad():
        tp = seq(tframes, _t(anchors))
        pp = fwd_run["net"](pair_cur, pair_prev,
                            _t(anchors)[None].expand(2, *anchors.shape))
    for k in ("indices", "valid"):
        np.testing.assert_array_equal(tp["proposals"][k].numpy(),
                                      np.asarray(jp["proposals"][k]))
        np.testing.assert_array_equal(tp["proposals"][k].numpy(),
                                      pp["proposals"][k].numpy())
    for k in ("box_preds", "cls_preds", "second_box_preds",
              "second_cls_preds"):
        np.testing.assert_allclose(
            tp[k].numpy(), np.asarray(jp[k]).reshape(tp[k].shape), **TOL,
            err_msg=k)
        np.testing.assert_allclose(tp[k].numpy(), pp[k].numpy(), **TOL,
                                   err_msg=k)
    assert tp["second_box_preds"].shape[0] == 2


def test_convert_temporal_tree(fwd_run):
    """JAX's temporal variables map onto the port's names: vfe, middle and
    rpn as the one-stage converter maps them, the gate's conv HWIO → OIHW,
    the refine head as the two-stage converter's; the map loads strictly
    into the pair and the sequence model, and the gradient tree covers
    every parameter name."""
    v = fwd_run["variables"]
    sd = state_dict_from_jax(v)
    gate = v["params"]["bev_fusion"]["conv_gating_bev"]
    np.testing.assert_array_equal(
        sd["bev_fusion.conv_gating_bev.weight"].numpy(),
        np.asarray(gate["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["bev_fusion.conv_gating_bev.bias"],
                                  np.asarray(gate["bias"]))
    assert sd["bev_fusion.conv_gating_bev.weight"].shape[1] == \
        2 * fwd_run["net"].middle.out_channels
    one = state_dict_from_jax(
        {"params": {k: v["params"][k] for k in ("middle", "rpn")},
         "batch_stats": v["batch_stats"]})
    for k, w in one.items():
        np.testing.assert_array_equal(sd[k].numpy(), w.numpy(), err_msg=k)
    seq = build_temporal_voxelnet(fwd_run["cfg"].model, NUM_PROPOSALS,
                                  device="cpu", sequence=True)[0]
    for m in (fwd_run["net"], seq):
        m.load_state_dict(sd, strict=True)
        assert set(grads_from_jax(v["params"])) == \
            {n for n, _ in m.named_parameters()}


def test_temporal_eval_step_matches_jax(fwd_run):
    """`make_temporal_steps`' eval step on `fwd_run`'s batch and weights:
    valid exactly that of JAX's eval (its forward and `predict_temporal`,
    jitted), boxes within TOL, voxel_overflow counting both frames."""
    net, spec, batch = fwd_run["net"], fwd_run["spec"], fwd_run["batch"]
    tvspec = VoxelizeSpec.from_config(fwd_run["cfg"].model.voxel_generator,
                                      MAX_VOXELS)
    _, eval_step = make_temporal_steps(spec, tvspec)
    det = eval_step(TrainState(net, None), {k: _t(v)
                                            for k, v in batch.items()})
    jdet = fwd_run["jdet"]
    valid = np.asarray(jdet["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               np.asarray(jdet["boxes"])[valid], **TOL)
    tcur, tprev = _port_frames(fwd_run["cfg"], batch)
    assert int(det["voxel_overflow"]) == int(tcur["voxel_overflow"]) + \
        int(tprev["voxel_overflow"])


# --------------------------------------------- builder, trainer, reader


def test_temporal_builder_is_fp32_as_jax():
    """JAX's temporal builder gives the middle and the RPN no bf16 `dtype`
    with the config's mixed-precision flag on, and the port's builder takes
    no precision argument and builds fp32 (its arguments are JAX's plus
    the device, the seed and the sequence form)."""
    jcfg = jax_loads(TINY_SPARSE_PIPELINE)
    jcfg.train_config.enable_mixed_precision = True
    jmod = jax_build_temporal(jcfg.model)[0]
    assert dict(jmod.middle_kwargs).get("dtype") is None
    assert dict(jmod.rpn_kwargs)["dtype"] is None
    params = inspect.signature(build_temporal_voxelnet).parameters
    assert set(params) == set(inspect.signature(
        jax_build_temporal).parameters) | {"device", "seed", "sequence"}


def _trainer(tmp_path, patches=(), synthetic=True):
    path = tmp_path / "tiny_sparse.config"
    path.write_text(TINY_SPARSE_PIPELINE)
    return Trainer(str(path), tmp_path / "run", synthetic=synthetic,
                   dataset_size=4, max_points=3000, total_steps=2,
                   model_type="temporal",
                   patches=["train_config.steps_per_eval=0",
                            "train_config.save_summary_steps=1",
                            "train_input_reader.num_workers=1",
                            "eval_input_reader.num_workers=1",
                            *patches], device="cpu")


@contextlib.contextmanager
def one_thread():
    """torch on one thread for the port's side of a test on the tiny model:
    its small ops gain little from threads, and six test workers sharing
    the machine's cores make each worker's threads wait on each other (the
    Trainer tests took half the time on one thread beside five busy
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _train_and_evaluate(tr, tmp_path):
    try:
        with one_thread():
            state = tr.train(2)
            assert state.step == 2
            detail = tr.evaluate(state, max_frames=2)
    finally:
        tr.logger.close()
    log = [json.loads(line) for line in
           (tmp_path / "run" / "log.json").read_text().splitlines()]
    steps = [r for r in log if "train.second_loc_loss" in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["train.loss"]) and
               np.isfinite(r["train.second_cls_loss"]) for r in steps)
    out = tmp_path / "run" / "eval_results" / "step_2"
    assert (out / "result.pkl").exists()
    assert len(list((out / "txt").iterdir())) == 2
    return detail


def test_trainer_temporal_on_synthetic_pairs(tmp_path):
    """`Trainer(model_type="temporal", device="cpu")` with the config's
    mixed-precision flag on: the model is fp32 (every parameter, no bf16
    middle or trunk); two steps on `SyntheticPairDataset` pairs with finite
    stage-1 and stage-2 losses, then `evaluate` on one batch of 2 pairs
    writes result.pkl and one KITTI txt file a frame."""
    tr = _trainer(tmp_path, ["train_config.enable_mixed_precision=True"])
    assert tr.cfg.train_config.enable_mixed_precision
    assert tr.module.middle.dtype is None and tr.module.rpn.trunk.dtype is None
    assert all(p.dtype == torch.float32 for p in tr.module.parameters())
    ex = tr.train_ds[0]
    assert "p_points" in ex and not np.array_equal(ex["points"],
                                                   ex["p_points"])
    _train_and_evaluate(tr, tmp_path)


def test_trainer_temporal_on_tracking_tree(tmp_path):
    """The same on a KITTI-tracking tree (`data/fake_tracking.py`: four
    frames of one sequence, so four (cur, prev) pairs, frame 0 with
    itself): the readers' root is the split directory; evaluate reports
    the /3d keys."""
    root = write_tracking_tree(tmp_path / "training",
                               np.random.default_rng(0))
    tr = _trainer(tmp_path, [f"train_input_reader.kitti_root_path='{root}'",
                             f"eval_input_reader.kitti_root_path='{root}'"],
                  synthetic=False)
    assert len(tr.train_ds) == 4
    ex = tr.train_ds[1]
    assert not np.array_equal(ex["points"], ex["p_points"])
    detail = _train_and_evaluate(tr, tmp_path)
    assert any("/3d" in k for k in detail)


def _equal(a, b, path=""):
    """Nested dicts / lists / arrays equal in value, dtype and shape."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_tracking_reader_and_writer_match_jax(tmp_path):
    """The KITTI-tracking reader on the fake tree (the label parser, the
    sequences, the (cur, prev) pairs) equal to JAX's copy item by item, and
    the result writer's files byte for byte JAX's."""
    root = write_tracking_tree(tmp_path / "training",
                               np.random.default_rng(5), num_frames=3)
    label = root / "label_02" / "0000.txt"
    _equal(tracking.parse_tracking_label(label),
           jtracking.parse_tracking_label(label))
    seqs = tracking.KittiTrackingDataset(root)
    jseqs = jtracking.KittiTrackingDataset(root)
    assert len(seqs) == len(jseqs) == 1 and len(seqs[0]) == 3
    for t in range(3):
        _equal(seqs[0][t], jseqs[0][t], f"frame {t}")
    pairs = tracking.TrackingPairDataset(seqs)
    jpairs = jtracking.TrackingPairDataset(jseqs)
    for i in range(len(jpairs)):
        _equal(pairs[i], jpairs[i], f"pair {i}")
    rng = np.random.default_rng(6)
    ids = [rng.integers(0, 9, 3) for _ in range(3)]
    dets = [{"frame_idx": t, "location": rng.normal(size=(3, 3)),
             "dimensions": rng.uniform(1, 4, (3, 3)),
             "rotation_y": rng.normal(size=3),
             "bbox": rng.uniform(0, 300, (3, 4)),
             "score": rng.uniform(size=3), "name": ["Car"] * 3}
            for t in range(3)]
    got = tracking.write_kitti_tracking_result(tmp_path / "port", "0000",
                                               ids, dets)
    want = jtracking.write_kitti_tracking_result(tmp_path / "jax", "0000",
                                                 ids, dets)
    assert got.endswith("port/val/0000.txt")
    assert open(got, "rb").read() == open(want, "rb").read()
    assert len(open(want).read().splitlines()) == 9
