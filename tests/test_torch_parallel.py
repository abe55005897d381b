"""Multi-device execution in the port (`second_tpu_torch/parallel/`, the
`Trainer`'s data parallelism) on the CPU: one world of 2 gloo processes
(`parallel/launch.py`: a `file://` rendezvous in a temporary directory, a
DEADLINE past which the world is killed and the test fails) runs every
rank-side check of `test_torch_parallel_ranks.py`; this process builds the
inputs, runs the JAX references and the port's single-device references,
and compares. On the tiny sparse pipeline (`configs/tiny_sparse.config`,
JAX's `TINY_SPARSE_PIPELINE`), global batch 4, 2 examples a rank.

The JAX references, each JAX's single-device function (JAX's own tests hold
its mesh versions to them; a sharded JAX train step on 2 of the 8 virtual
devices compiles for far longer than this file's budget):
- the DP train step: JAX's train-step forward and loss jitted (voxelize,
  `module.apply(train=True, mutable batch_stats)`, `compute_loss`): the
  loss and the norms' running statistics after the step within 1e-4
  relative (`tests/test_model_train.py:125`'s bound) — against per-rank
  statistics, which this batch moves by more than that;
- the row-sharded RPN: JAX's `RPN` jitted, within 2e-4
  (`tests/test_model_train.py:430`'s bound);
- the sequence-parallel forward: JAX's unsharded `TemporalSequenceVoxelNet`
  jitted, within 1e-4 (`tests/test_torch_temporal.py`'s TOL), pair_valid
  exact.
The port's own single-device references: the DP step's parameters within
1e-5 of each tensor's scale (momentum SGD: the update is linear in the
gradient, whose all-reduced sums round in another order); the DP eval
step's statistics exact and its gathered detections (valid exact, boxes and
scores within 1e-5); `make_dp_eval_any` around the temporal eval step the
same; the row-sharded RPN within 1e-5 of the port's unsharded forward and
the sequence-parallel forward within 1e-5 of the port's unsharded one; a
`Trainer` at world 2 taking the data-parallel path where the train batch
divides by 2 (first loss within 1e-4 relative of a one-rank `Trainer` on
the same data stream) and refusing it where it does not; its train loop
over 3 steps, input from 4 prefetch workers, taking the global batches in
the reader's order on both ranks (exact) with each loss within 1e-4
relative of a one-rank Trainer's loop.
"""

import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.data import ExamplePrep as JExamplePrep
from second_tpu.data import PrepConfig as JPrepConfig
from second_tpu.data.synthetic import sample_scene as jsample_scene
from second_tpu.data.synthetic import sample_sequence as jsample_sequence
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import compute_loss as jax_compute_loss
from second_tpu.models.rpn import RPN as JRPN
from second_tpu.models.temporal import TemporalSequenceVoxelNet as JSeq
from second_tpu.models.temporal import \
    build_temporal_voxelnet as jax_build_temporal
from second_tpu.testing import TINY_SPARSE_PIPELINE, tiny_scene_kwargs
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu_torch.config import load_pipeline_config, \
    loads_pipeline_config
from second_tpu_torch.convert import state_dict_from_jax
from second_tpu_torch.data import ExamplePrep, PrepConfig
from second_tpu_torch.entry import TINY_CONFIG
from second_tpu_torch.models import build_temporal_voxelnet, build_voxelnet
from second_tpu_torch.models.rpn import RPN
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.parallel.eval_dp import _local_stats
from second_tpu_torch.parallel.launch import run_world
from second_tpu_torch.parallel.spatial import make_spatial_forward
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.run import apply_config_patches
from second_tpu_torch.train.state import (TrainState, make_eval_step,
                                          make_train_step)

from test_torch_model import _random_variables
from test_torch_parallel_ranks import _here, trainer_steps
from test_torch_temporal import one_thread

WORLD = 2
BATCH = 4
MAX_VOXELS = 2048
PROPOSALS = 16
# the world's deadline, there to turn a hang into a failure: the world
# took 95 s beside 8 busy processes on 8 cores and passed 120 s (its
# earlier deadline) beside 16 before its Trainer jobs shared a build and
# dropped TensorBoard's import; since, 86 s beside 13. DEADLINE is some 4
# times that, for a host more loaded than any measured here
DEADLINE = 360.0
TRAIN_STEPS = 3          # the Trainer's train loop, at world 2 and at 1
# the three-step optimizer of test_torch_train: momentum SGD at a fixed lr
SGD_PATCHES = ['train_config.optimizer.kind="momentum_optimizer"',
               "train_config.optimizer.momentum_optimizer_value=0.9",
               'train_config.optimizer.learning_rate.kind="manual_stepping"',
               "train_config.optimizer.learning_rate.rates=[1e-3]",
               "train_config.optimizer.learning_rate.boundaries=[]"]
TRAINER_PATCHES = ["train_input_reader.num_workers=1",
                   "eval_input_reader.num_workers=1"]
JAX_RTOL = 1e-4          # the DP step's loss and statistics against JAX's
PARAM_TOL = 1e-5         # of each tensor's scale, against the port's step
DET_TOL = dict(rtol=1e-5, atol=1e-5)
RPN_JAX_TOL = dict(rtol=2e-4, atol=2e-4)
SEQ_JAX_TOL = dict(rtol=1e-4, atol=1e-4)
OWN_TOL = dict(rtol=1e-5, atol=1e-5)
# the row-sharded RPNs: (H, layer strides, upsample strides, group norm);
# global SAME pads each stride-2 conv (0, 1), and at H = 40 both stages
# stride 2; the group-normed RPN runs with train=True (a forward, as JAX's
# `run` applies it)
RPN_CASES = [(64, (1, 2), (1, 2), False), (40, (2, 2), (1, 2), False),
             (64, (1, 2), (1, 2), True)]


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _save(path, **arrays):
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return str(path)


def _rpn_kwargs(strides, ups, groupnorm=False):
    return dict(layer_nums=(2, 2), layer_strides=strides,
                num_filters=(32, 32), upsample_strides=ups,
                num_upsample_filters=(32, 32), num_anchor_per_loc=2,
                use_direction_classifier=True, use_groupnorm=groupnorm,
                num_groups=8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs written, the world of 2 run once over every check, the JAX
    and single-device references computed here."""
    tmp = tmp_path_factory.mktemp("parallel")
    jcfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    out, jobs = {"tmp": tmp, "cfg": jcfg}, []

    # the one-stage model: JAX's random variables, a batch of 4 with targets
    module, jspec, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    prep = JExamplePrep(assigner, info.feature_map_size,
                        JPrepConfig(max_points=3000, training=True))
    rng = np.random.default_rng(0)
    examples = []
    for _ in range(BATCH):
        p, b, names = jsample_scene(rng, **tiny_scene_kwargs())
        examples.append(prep({"points": p, "gt_boxes": b, "gt_names": names},
                             rng))
    batch = {k: v for k, v in prep.collate(examples).items()
             if k != "image_idx"}
    jvspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator,
                                       MAX_VOXELS, shuffle_overflow=True)
    vox = jax_device_voxelize(jvspec, jnp.asarray(batch["points"]),
                              jnp.asarray(batch["points_mask"]))
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    state_path = tmp / "one_stage.pt"
    torch.save(state_dict_from_jax(variables), state_path)
    batch_path = _save(tmp / "batch.npz", **batch)
    out.update(batch=batch, variables=variables, state_path=state_path)
    jobs.append(("dp_train", (str(TINY_CONFIG), SGD_PATCHES, str(state_path),
                              batch_path, MAX_VOXELS)))

    # the eval mask's SAT corners, as the Trainer computes them
    vg = jcfg.model.voxel_generator
    port_cfg = load_pipeline_config(TINY_CONFIG)
    _, _, pinfo, passigner, _ = build_voxelnet(port_cfg.model, device="cpu")
    eval_prep = ExamplePrep(passigner, pinfo.feature_map_size, PrepConfig(
        max_points=3000, training=False, anchor_area_threshold=1.0,
        voxel_size=tuple(vg.voxel_size), pc_range=tuple(vg.point_cloud_range),
        device_anchors_mask=True))
    corners, grid_hw, thr = eval_prep.sat_mask_info()
    mask_path = _save(tmp / "mask.npz", corners=corners, grid_hw=grid_hw,
                      threshold=thr)
    out["mask_info"] = (torch.from_numpy(corners), grid_hw, thr)
    jobs.append(("dp_eval", (str(TINY_CONFIG), str(state_path), batch_path,
                             mask_path, MAX_VOXELS)))
    pair = {"points": batch["points"], "points_mask": batch["points_mask"],
            "p_points": np.roll(batch["points"], 1, 0),
            "p_points_mask": np.roll(batch["points_mask"], 1, 0),
            "anchors": batch["anchors"]}
    jobs.append(("dp_eval_temporal", (str(TINY_CONFIG),
                                      _save(tmp / "pair.npz", **pair),
                                      MAX_VOXELS, PROPOSALS)))

    # the row-sharded RPNs: JAX's RPN, random variables
    out["rpn"] = []
    for i, (H, strides, ups, gn) in enumerate(RPN_CASES):
        x = np.random.default_rng(i).normal(0, 1, (2, H, 48, 16)).astype(
            np.float32)
        jrpn = JRPN(**_rpn_kwargs(strides, ups, gn))
        shapes = jax.eval_shape(lambda: jrpn.init(
            jax.random.PRNGKey(0), jnp.asarray(x), train=False))
        rv = _random_variables(shapes, np.random.default_rng(10 + i))
        sd = state_dict_from_jax({
            "params": {"rpn": rv["params"]},
            "batch_stats": {"rpn": rv.get("batch_stats", {})}})
        sd = {k[len("rpn."):]: v for k, v in sd.items()}
        path = tmp / f"rpn{i}.pt"
        torch.save(sd, path)
        xt = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        kwargs = dict(in_channels=16, **_rpn_kwargs(strides, ups, gn))
        out["rpn"].append(dict(x=x, xt=xt, variables=rv, sd=sd,
                               kwargs=kwargs, jrpn=jrpn, train=gn))
        jobs.append(("spatial_rpn", (kwargs, str(path),
                                     _save(tmp / f"x{i}.npz", x=xt), gn)))

    # the 4-frame sequence: JAX's model, its voxelized frames
    base = jax_build_temporal(jcfg.model, num_proposals=PROPOSALS)[0]
    jseq = JSeq(vfe_class_name=base.vfe_class_name,
                vfe_kwargs=base.vfe_kwargs,
                middle_class_name=base.middle_class_name,
                middle_kwargs=base.middle_kwargs, rpn_kwargs=base.rpn_kwargs,
                spec=base.spec, pspec=base.pspec, roi=base.roi)
    seq_prep = JExamplePrep(assigner, info.feature_map_size,
                            JPrepConfig(max_points=2000, training=False))
    k = tiny_scene_kwargs()
    seq = jsample_sequence(np.random.default_rng(0), num_frames=4,
                           pc_range=k["pc_range"], num_cars=(2, 4),
                           num_ground=1000)
    srng = np.random.default_rng(1)
    exs = [seq_prep({**f, "image_idx": t}, srng) for t, f in enumerate(seq)]
    fvox = jax_device_voxelize(
        JVoxelizeSpec.from_config(vg, 512),
        jnp.asarray(np.stack([e["points"] for e in exs])),
        jnp.asarray(np.stack([e["points_mask"] for e in exs])))
    frames = {key: fvox[key] for key in ("voxels", "num_points",
                                         "coordinates", "voxel_valid")}
    anchors = jnp.asarray(seq_prep.anchors)
    shapes = jax.eval_shape(lambda: jseq.init(jax.random.PRNGKey(0), frames,
                                              anchors, train=False))
    sv = _random_variables(shapes, np.random.default_rng(2))
    seq_path = tmp / "seq.pt"
    torch.save(state_dict_from_jax(sv), seq_path)
    out.update(frames=_np(frames), anchors=np.asarray(anchors), seq_vars=sv,
               jseq=jseq, seq_path=seq_path)
    jobs.append(("sp_sequence", (
        str(TINY_CONFIG), str(seq_path),
        _save(tmp / "frames.npz", anchors=anchors, **_np(frames)),
        PROPOSALS)))

    # the Trainer's train loop over a few steps with a train batch
    # divisible by 2, then its evaluate; its first step with one that is
    # not
    jobs.append(("trainer_steps", (str(TINY_CONFIG),
                                   str(tmp / f"trainer{BATCH}"), BATCH,
                                   TRAIN_STEPS, True)))
    jobs.append(("trainer_first_step", (str(TINY_CONFIG),
                                        str(tmp / "trainer3"), 3,
                                        TRAINER_PATCHES)))

    # the world runs while this process computes the references
    ranks = []
    runner = threading.Thread(target=lambda: ranks.append(_catch(
        run_world, "test_torch_parallel_ranks:bundle", WORLD, tmp / "world",
        args=(jobs,), deadline=DEADLINE, paths=[_here()])))
    runner.start()
    try:
        # the port's side here on one thread, beside the world's two
        with one_thread():
            out["refs"] = _references(out)
    finally:
        runner.join()
    if isinstance(ranks[0], BaseException):
        raise ranks[0]
    out["results"] = ranks[0]
    return out


def _catch(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except BaseException as e:          # re-raised by the fixture
        return e


def _references(w):
    """What the ranks' results are held to, computed in this process: JAX's
    forward and loss, RPNs and sequence model (jitted), and the port's
    single-device train step, eval steps, forwards and one-rank Trainer."""
    refs = {}
    refs["jax_loss"], refs["jax_state"] = _jax_forward_loss(w)
    cfg, net, spec = _port_one_stage(w, SGD_PATCHES)
    opt, lr = build_optimizer(cfg.train_config.optimizer,
                              cfg.train_config.steps, net.parameters())
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS,
                                     shuffle_overflow=True)
    _, refs["metrics"] = make_train_step(spec, vspec)(
        TrainState(net, opt, 0, lr), _tensors(w["batch"]))
    refs["state"] = {k: v.clone() for k, v in net.state_dict().items()}

    # one rank's half of the batch through the train-mode forward alone
    _, net, _ = _port_one_stage(w)
    half = _tensors({k: v[:BATCH // WORLD] for k, v in w["batch"].items()})
    vox = device_voxelize(vspec, half["points"], half["points_mask"], "cpu")
    net.train()
    with torch.no_grad():
        net(vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    refs["half_stats"] = _stats_of(net.state_dict())

    _, net, spec = _port_one_stage(w)
    evspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    refs["eval"] = make_eval_step(spec, evspec, mask_info=w["mask_info"])(
        TrainState(net, None), _tensors(w["batch"]))

    refs["rpn"] = []
    for r in w["rpn"]:
        want = jax.jit(lambda v, x, m=r["jrpn"], t=r["train"]: m.apply(
            v, x, train=t))(r["variables"], jnp.asarray(r["x"]))
        rpn = RPN(**r["kwargs"])
        rpn.load_state_dict(r["sd"], strict=True)
        refs["rpn"].append((_np(want),
                            make_spatial_forward(rpn, train=r["train"])(
                                torch.from_numpy(r["xt"]))))

    frames, anchors = w["frames"], w["anchors"]
    refs["seq_jax"] = _np(jax.jit(lambda v, f, a: w["jseq"].apply(
        v, f, a, train=False))(w["seq_vars"], frames, anchors))
    seq = build_temporal_voxelnet(w["cfg"].model, PROPOSALS, device="cpu",
                                  sequence=True)[0]
    seq.load_state_dict(torch.load(w["seq_path"]), strict=True)
    with torch.no_grad():
        refs["seq_own"] = seq(_tensors(frames),
                              torch.from_numpy(np.array(anchors)))

    # the first TRAIN_STEPS global batches as the reader makes them, and a
    # one-rank Trainer's train loop over them
    refs["steps"] = trainer_steps(TINY_CONFIG, w["tmp"] / "one_steps",
                                  BATCH, TRAIN_STEPS, stream=True)
    return refs


def _port_one_stage(w, patches=()):
    cfg = apply_config_patches(load_pipeline_config(TINY_CONFIG), patches)
    net, spec, *_ = build_voxelnet(cfg.model, device="cpu",
                                   mixed_precision=False)
    net.load_state_dict(torch.load(w["state_path"]), strict=True)
    return cfg, net, spec


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_forward_loss(w):
    """JAX's train-step forward and loss (`second_tpu/train/state.py`
    `loss_fn`), jitted: the loss and the batch statistics after it."""
    module, spec, *_ = jax_build_voxelnet(w["cfg"].model)
    vspec = JVoxelizeSpec.from_config(w["cfg"].model.voxel_generator,
                                      MAX_VOXELS, shuffle_overflow=True)

    @jax.jit
    def run(variables, batch):
        vox = jax_device_voxelize(vspec, batch["points"],
                                  batch["points_mask"])
        preds, mutated = module.apply(
            variables, vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"], train=True, mutable=["batch_stats"])
        loss = jax_compute_loss(spec, preds, batch["labels"],
                                batch["reg_targets"], batch["anchors"])
        return loss["loss"], mutated["batch_stats"]

    loss, stats = run(w["variables"], {k: jnp.asarray(v)
                                       for k, v in w["batch"].items()})
    return float(loss), state_dict_from_jax(
        {"params": w["variables"]["params"], "batch_stats": _np(stats)})


def _stats_of(state):
    return {k: v for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


def _result(w, i):
    """Job i's result on rank 0, after checking that rank 1's is the
    same."""
    a, b = (r[i] for r in w["results"])
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    return a


def test_tiny_config_is_jaxs(world):
    """The port's `configs/tiny_sparse.config` parses to JAX's tiny sparse
    pipeline."""
    assert load_pipeline_config(TINY_CONFIG) == world["cfg"]


def test_dp_train_step_matches_jax_and_the_single_device_step(world):
    """One DP step at world 2: the loss and every norm's running
    statistics within JAX_RTOL of JAX's forward over the global batch,
    every parameter within PARAM_TOL of the port's single-device step; the
    two ranks hold the same state."""
    dp, refs = _result(world, 0), world["refs"]
    np.testing.assert_allclose(float(dp["metrics"]["loss"]),
                               refs["jax_loss"], rtol=JAX_RTOL)
    jstats = _stats_of(refs["jax_state"])
    assert len(jstats) > 20
    for k, want in jstats.items():
        want = want.numpy()
        np.testing.assert_allclose(dp["state"][k], want, rtol=JAX_RTOL,
                                   atol=JAX_RTOL * np.abs(want).max(),
                                   err_msg=k)
    np.testing.assert_allclose(float(dp["metrics"]["loss"]),
                               float(refs["metrics"]["loss"]), rtol=JAX_RTOL)
    assert int(dp["metrics"]["num_pos"]) == int(refs["metrics"]["num_pos"])
    for k, want in refs["state"].items():
        want = want.numpy()
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(dp["state"][k] - want).max() <= PARAM_TOL * scale, k


def test_dp_step_on_one_rank_is_the_plain_step(world):
    """Two DP steps on a group of one rank (DDP, the norms' all-reduces
    over that rank) give the plain steps' state bit for bit, on each of the
    two ranks' slices."""
    for r in range(WORLD):
        assert world["results"][r][0]["one_rank_diff"] == 0.0


def test_per_rank_statistics_would_fail(world):
    """On this batch one rank's half alone moves the norms' running
    statistics by more than ten times JAX_RTOL (of each tensor's scale)
    from the global batch's, the DP step's: a DP step whose norms reduced
    per rank could not pass the test above."""
    dp = _result(world, 0)
    worst = max(np.abs(v.numpy() - dp["state"][k]).max() /
                np.abs(dp["state"][k]).max()
                for k, v in world["refs"]["half_stats"].items())
    assert worst > 10 * JAX_RTOL, worst


def test_dp_eval_step_stats_exact_and_detections_gathered(world):
    """`make_dp_eval_step` at world 2 with the in-graph anchors mask: the
    stats vector equal to the single-device eval's counts and to a host
    count of the gathered detections; those detections the single-device
    ones (valid exact, boxes and scores within DET_TOL) on both ranks."""
    got, ref = _result(world, 1), world["refs"]["eval"]
    want = np.concatenate([_local_stats(ref).numpy(),
                           [int(ref["voxel_overflow"])]])
    np.testing.assert_array_equal(got["stats"], want)
    det = got["det"]
    assert got["stats"][0] == det["valid"].sum() > 0
    assert det["boxes"].shape[0] == BATCH
    np.testing.assert_array_equal(det["valid"], ref["valid"].numpy())
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(det[k], ref[k].numpy(), **DET_TOL)
    assert int(det["stage_overflow"]) == int(ref["stage_overflow"])


def test_dp_eval_any_temporal_matches_single_device(world):
    """`make_dp_eval_any` around the temporal eval step at world 2: the
    reduced stats equal the single-device eval's counts, the gathered
    detections the single-device ones, the overflow counts summed."""
    got = _result(world, 2)
    ref = got["ref"]
    np.testing.assert_array_equal(got["stats"], got["ref_stats"])
    assert got["stats"][0] > 0
    np.testing.assert_array_equal(got["det"]["valid"], ref["valid"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got["det"][k], ref[k], **DET_TOL)
    for k in ("voxel_overflow", "stage_overflow"):
        assert int(got["det"][k]) == int(ref[k])


@pytest.mark.parametrize("case", range(len(RPN_CASES)),
                         ids=[f"H{h}" + ("_groupnorm" if gn else "")
                              for h, _, _, gn in RPN_CASES])
def test_spatial_rpn_matches_jax_and_unsharded(world, case):
    """The RPN's forward with its rows sharded over 2 ranks (halos from the
    neighbours under the global SAME padding; a group norm's sums
    all-reduced over the ranks) against JAX's unsharded RPN (RPN_JAX_TOL)
    and the port's unsharded forward (OWN_TOL): in eval, and the
    group-normed RPN with train=True."""
    got = _result(world, 3 + case)
    want, own = world["refs"]["rpn"][case]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(got[k], want[k].reshape(got[k].shape),
                                   **RPN_JAX_TOL, err_msg=k)
        np.testing.assert_allclose(got[k], own[k].numpy(), **OWN_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["trunk"].transpose(0, 2, 3, 1),
                               want["trunk"], **RPN_JAX_TOL)


def test_spatial_forward_refuses_what_the_rule_does_not_cover():
    """Training a batch-normed RPN (its batch statistics) is refused by
    layer name, and so is a gradient (the halo exchange has no backward)
    and a layer outside the rule; a group-normed RPN takes train=True."""
    kw = dict(layer_nums=(1,), layer_strides=(1,), num_filters=(32,),
              upsample_strides=(1,), num_upsample_filters=(32,))
    with pytest.raises(ValueError, match="trunk.convs.0.norm"):
        make_spatial_forward(RPN(16, **kw), train=True)
    run = make_spatial_forward(RPN(16, use_groupnorm=True, num_groups=8,
                                   **kw), train=True)
    with pytest.raises(ValueError, match="no gradient"):
        run(torch.zeros(1, 16, 8, 8, requires_grad=True))
    assert run(torch.zeros(1, 16, 8, 8))["box_preds"].shape[0] == 1
    rpn = RPN(16, **kw)
    rpn.trunk.extra = torch.nn.Dropout()
    with pytest.raises(ValueError, match="trunk.extra"):
        make_spatial_forward(rpn)


def test_sequence_parallel_forward_matches_jax(world):
    """4 frames on 2 ranks, the boundary BEV map passed round the ring:
    pair_valid exactly [F, T, T, T], the valid pairs within SEQ_JAX_TOL of
    JAX's unsharded sequence model and within OWN_TOL of the port's, the
    proposals exactly JAX's."""
    got = _result(world, 3 + len(RPN_CASES))
    want, own = world["refs"]["seq_jax"], world["refs"]["seq_own"]
    np.testing.assert_array_equal(got["pair_valid"],
                                  [False, True, True, True])
    for k in ("indices", "valid"):
        np.testing.assert_array_equal(got["proposals"][k][1:],
                                      want["proposals"][k])
    for k in ("box_preds", "cls_preds", "second_box_preds",
              "second_cls_preds"):
        np.testing.assert_allclose(got[k][1:],
                                   want[k].reshape(got[k][1:].shape),
                                   **SEQ_JAX_TOL, err_msg=k)
        np.testing.assert_allclose(got[k][1:], own[k].numpy(), **OWN_TOL,
                                   err_msg=k)


def test_trainer_data_parallel_train_loop_keeps_the_batch_order(world):
    """`Trainer.train` at world 2 over TRAIN_STEPS steps, its input from 4
    prefetch workers: both ranks take the global batches in the order the
    reader makes them (their points' sums exact, the same on both ranks),
    so every step is the single-device step over one global batch: each
    step's loss within JAX_RTOL of a one-rank Trainer's train loop on the
    same stream."""
    got, one = _result(world, -2), world["refs"]["steps"]
    assert got["data_parallel"] and not one["data_parallel"]
    stream = one["stream"]
    assert got["seen"][:, 0].tolist() == stream
    assert one["seen"][:, 0].tolist() == stream
    np.testing.assert_allclose(got["seen"][:, 1], one["seen"][:, 1],
                               rtol=JAX_RTOL)


def test_trainer_data_parallel_by_batch_divisibility(world):
    """`Trainer` at world 2 takes the data-parallel path for a train batch
    of 4 (its first loss within JAX_RTOL of a one-rank Trainer's on the
    same data stream) and not for 3, where each rank trains alone. Its
    `evaluate` then runs data-parallel (the eval batch of 2 divides), the
    same reduced statistics on both ranks, and rank 0 alone writes the
    results: one file of 4 frames' detections."""
    dp, solo = _result(world, -2), _result(world, -1)
    assert dp["data_parallel"] and not solo["data_parallel"]
    one = world["refs"]["steps"]
    assert not one["data_parallel"]
    np.testing.assert_allclose(dp["seen"][0, 1], one["seen"][0, 1],
                               rtol=JAX_RTOL)
    assert dp["eval_stats"]["num_detections"] > 0
    results = list((world["tmp"] / f"trainer{BATCH}").glob(
        "predict_test/step_*/result.pkl"))
    assert len(results) == 1
    with open(results[0], "rb") as f:
        assert len(pickle.load(f)) == 4
