"""The port's KITTI reader (`data/kitti_dataset.py`, `core/db_sampler.py`)
and the `Trainer`'s real-data path against the JAX package's, on the CPU,
on a fake KITTI tree written by `second_tpu_torch.data.fake_kitti` (the
tree of `tests/test_data_kitti.py`'s `fake_kitti` fixture, and the same
with a pedestrian and a cyclist): the info files, the reduced clouds and
the gt database byte for byte, the augmented training items (database
sampling with the multi-class config's groups and filters, every noise)
and the eval items under one numpy seed exactly, the database sampler's
quota, collision and group cases, `Trainer(synthetic=False)` training and
evaluating with KITTI AP, and `--profile_steps`."""

import filecmp
import pickle
import shutil

import numpy as np
import pytest

from second_tpu.config import load_pipeline_config as jax_load_config
from second_tpu.core.db_sampler import BatchSampler as JBatchSampler
from second_tpu.core.db_sampler import DataBaseSampler as JDataBaseSampler
from second_tpu.data import kitti_dataset as jkd
from second_tpu.testing import TINY_PIPELINE
from second_tpu_torch.config import load_pipeline_config
from second_tpu_torch.core import augment
from second_tpu_torch.core.db_sampler import BatchSampler, DataBaseSampler
from second_tpu_torch.data import fake_kitti
from second_tpu_torch.data import kitti_dataset as kd
from second_tpu_torch.train import run as run_mod
from second_tpu_torch.train.run import Trainer

import test_data_kitti
from test_torch_model import REPO
from test_torch_trainer import TRAINER_PATCHES

MC_CONFIG = "second_multiclass.config"
# the tiny pipeline over a range that holds the fake tree's objects
TINY_KITTI = TINY_PIPELINE.replace(
    "point_cloud_range: [0, -8, -3, 16, 8, 1]",
    "point_cloud_range: [0, -24, -3, 64, 24, 1]").replace(
    "voxel_size: [0.25, 0.25, 4.0]", "voxel_size: [1.0, 1.0, 4.0]").replace(
    "anchor_ranges: [0, -8, -1.78, 16, 8, -1.78]",
    "anchor_ranges: [0, -24, -1.78, 64, 24, -1.78]")
assert TINY_KITTI.count("64, 24") == 2


def _tree(root, label, frames=2, splits=("train",), shift=0.0):
    return fake_kitti.write_tree(root, np.random.default_rng(7),
                                 ids=range(frames), label=label,
                                 clutter=500, splits=splits, shift=shift)


def _create_data(mod, root):
    mod.create_kitti_info_file(root)
    mod.create_reduced_point_cloud(root)
    mod.create_groundtruth_database(root)


def _assert_same(a, b, where=""):
    """Deep equality of pickled infos: dicts, lists, arrays (dtype too)."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_fake_tree_is_the_fixtures(tmp_path):
    """The port's writer, with the fixture's seed and labels, writes the
    tree of `tests/test_data_kitti.py`'s `fake_kitti` fixture byte for
    byte."""
    want = test_data_kitti.fake_kitti._get_wrapped_function()(tmp_path)
    got = _tree(tmp_path / "b" / "kitti", fake_kitti.CAR_LABEL)
    files = sorted(p.relative_to(want) for p in want.rglob("*")
                   if p.is_file())
    assert len(files) == 9
    assert files == sorted(p.relative_to(got) for p in got.rglob("*")
                           if p.is_file())
    for f in files:
        assert filecmp.cmp(want / f, got / f, shallow=False), f


@pytest.mark.parametrize("label", ["car", "multiclass"])
def test_create_data_matches_jax(tmp_path, label):
    """create_kitti_info_file, create_reduced_point_cloud and
    create_groundtruth_database on two copies of one tree: the same infos
    (with per-gt point counts from the port's runtime), the same db infos,
    and the same reduced clouds and gt-database files, byte for byte."""
    text = fake_kitti.CAR_LABEL if label == "car" else \
        fake_kitti.MULTICLASS_LABEL
    a = _tree(tmp_path / "jax", text, frames=3, splits=("train", "val"),
              shift=2.5)
    b = tmp_path / "port"
    shutil.copytree(a, b)
    _create_data(jkd, a)
    _create_data(kd, b)
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_infos_trainval.pkl", "kitti_dbinfos_train.pkl"):
        _assert_same(pickle.loads((a / name).read_bytes()),
                     pickle.loads((b / name).read_bytes()), name)
    db = pickle.loads((b / "kitti_dbinfos_train.pkl").read_bytes())
    want = {"Car"} if label == "car" else {"Car", "Pedestrian", "Cyclist"}
    assert set(db) == want and len(db["Car"]) == 6
    made = sorted(p.relative_to(a) for p in a.rglob("*.bin")
                  if "velodyne_reduced" in str(p) or "gt_database" in str(p))
    assert len(made) == 3 + sum(len(v) for v in db.values())
    for f in made:
        assert filecmp.cmp(a / f, b / f, shallow=False), f


@pytest.fixture(scope="module")
def mc_trees(tmp_path_factory):
    """One prepared multi-class tree (4 frames, train and val) and the
    multi-class config of each package with its readers' paths on it."""
    root = _tree(tmp_path_factory.mktemp("mc") / "kitti",
                 fake_kitti.MULTICLASS_LABEL, frames=4,
                 splits=("train", "val"), shift=2.5)
    _create_data(kd, root)
    cfgs = []
    for load in (jax_load_config, load_pipeline_config):
        cfg = load(REPO / "second_tpu_torch" / "configs" / MC_CONFIG)
        cfg.train_input_reader.database_sampler.database_info_path = str(
            root / "kitti_dbinfos_train.pkl")
        cfgs.append(cfg)
    return root, cfgs


@pytest.mark.parametrize("training", [True, False])
def test_kitti_dataset_items_match_jax(mc_trees, training):
    """KittiDataset items of the multi-class config's readers under one
    numpy seed: in training the database sampler's three class groups
    (their point and difficulty filters), per-object and global noise and
    the flip; in eval none. Points, gt boxes, names and calibration equal
    JAX's exactly, item by item over two passes."""
    root, (jcfg, tcfg) = mc_trees
    reader = "train_input_reader" if training else "eval_input_reader"
    info = root / ("kitti_infos_train.pkl" if training
                   else "kitti_infos_val.pkl")
    jds = jkd.KittiDataset(info, root, training=training,
                           input_cfg=getattr(jcfg, reader),
                           rng=np.random.default_rng(8))
    tds = kd.KittiDataset(info, root, training=training,
                          input_cfg=getattr(tcfg, reader),
                          rng=np.random.default_rng(8))
    assert (tds._sampler is not None) == training
    sampled = 0
    for idx in [0, 1, 2, 3, 0, 2]:
        j, t = jds[idx], tds[idx]
        assert sorted(j) == sorted(t)
        for k in ("points", "gt_boxes", "gt_names", "calib/R0_rect",
                  "calib/Tr_velo_to_cam", "calib/P2", "img_shape"):
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["image_idx"] == j["image_idx"]
        sampled += len(t["gt_boxes"]) - 4
    assert (sampled > 0) == training


def test_db_sampler_quota_and_collisions():
    """The port's DataBaseSampler (a copy of JAX's): per-class quota less
    the scene's boxes, no collision among scene and sampled boxes, the
    sampled objects' points pasted; the same draws as JAX's under one
    seed; and BatchSampler's epochs."""
    db = test_data_kitti.TestDBSampler()._db()
    gt = np.array([[20.0, 0, -1.7, 1.6, 3.9, 1.56, 0.0]])
    out = DataBaseSampler(db, {"Car": 10},
                          rng=np.random.default_rng(5)).sample_all(
        gt, np.array(["Car"]))
    want = JDataBaseSampler(db, {"Car": 10},
                            rng=np.random.default_rng(5)).sample_all(
        gt, np.array(["Car"]))
    assert out is not None and sorted(out) == sorted(want)
    for k in out:
        np.testing.assert_array_equal(out[k], want[k])
    assert len(out["gt_boxes"]) <= 9
    allb = np.concatenate([gt, out["gt_boxes"]])
    coll = augment.box_collision_test(allb[:, [0, 1, 3, 4, 6]],
                                      allb[:, [0, 1, 3, 4, 6]])
    np.fill_diagonal(coll, False)
    assert not coll.any()
    assert len(out["points"]) == 10 * len(out["gt_boxes"])
    s = BatchSampler(list(range(5)), rng=np.random.default_rng(6))
    j = JBatchSampler(list(range(5)), rng=np.random.default_rng(6))
    assert [s.sample(3) for _ in range(3)] == [j.sample(3) for _ in range(3)]


def test_db_sampler_group_mode():
    """Multi-class sample groups: whole co-occurring groups sampled, fresh
    group ids past the scene's, no collision with the scene's boxes, the
    same draws as JAX's; a flat dict stays per class."""
    db = test_data_kitti.TestGroupSampling()._group_db()
    gt = np.array([[20.0, 0, -1.7, 1.6, 3.9, 1.56, 0.0]])
    groups = [{"Pedestrian": 6, "Cyclist": 6}]
    sampler = DataBaseSampler(db, groups, rng=np.random.default_rng(3))
    assert sampler._group_mode
    out = sampler.sample_all(gt, np.array(["Car"]),
                             gt_group_ids=np.array([4]))
    want = JDataBaseSampler(db, groups,
                            rng=np.random.default_rng(3)).sample_all(
        gt, np.array(["Car"]), gt_group_ids=np.array([4]))
    for k in want:
        np.testing.assert_array_equal(out[k], want[k])
    gids = out["group_ids"]
    assert gids.min() >= 5
    for g in np.unique(gids):
        assert set(out["gt_names"][gids == g]) == {"Pedestrian", "Cyclist"}
    assert not augment.box_collision_test(
        out["gt_boxes"][:, [0, 1, 3, 4, 6]], gt[:, [0, 1, 3, 4, 6]]).any()
    flat = DataBaseSampler(db, {"Pedestrian": 4},
                           rng=np.random.default_rng(3))
    assert not flat._group_mode
    out = flat.sample_all(np.zeros((0, 7)), np.array([]))
    assert "group_ids" not in out and set(out["gt_names"]) == {"Pedestrian"}


@pytest.fixture
def kitti_trainer_args(tmp_path):
    """A prepared multi-class tree (4 frames in train and val) and the tiny
    pipeline's config file with its readers on the tree."""
    root = _tree(tmp_path / "kitti", fake_kitti.MULTICLASS_LABEL, frames=4,
                 splits=("train", "val"), shift=2.5)
    _create_data(kd, root)
    cfg = tmp_path / "tiny_kitti.config"
    cfg.write_text(TINY_KITTI)
    patches = TRAINER_PATCHES + [
        f"train_input_reader.kitti_info_path="
        f"'{root / 'kitti_infos_train.pkl'}'",
        f"train_input_reader.kitti_root_path='{root}'",
        f"eval_input_reader.kitti_info_path='{root / 'kitti_infos_val.pkl'}'",
        f"eval_input_reader.kitti_root_path='{root}'"]
    return cfg, patches


def test_trainer_trains_and_evaluates_on_kitti(kitti_trainer_args, tmp_path):
    """Trainer(synthetic=False) on the CPU: three steps on the tree's
    frames, then `evaluate` with the official KITTI AP (its "/3d" keys),
    detections through the frames' calibration, result.pkl and one KITTI
    txt file a frame."""
    cfg, patches = kitti_trainer_args
    tr = Trainer(str(cfg), tmp_path / "run", synthetic=False,
                 max_points=6000, total_steps=3, patches=patches,
                 device="cpu")
    try:
        assert isinstance(tr.train_ds, kd.KittiDataset)
        state = tr.train(3)
        assert state.step == 3
        detail = tr.evaluate(state)
    finally:
        tr.logger.close()
    assert any("/3d" in k for k in detail)
    out = tmp_path / "run" / "eval_results" / "step_3"
    gt = pickle.loads((out / "gt.pkl").read_bytes())
    assert len(gt) == 4 and "Pedestrian" in gt[0]["name"]
    assert sorted(p.name for p in (out / "txt").iterdir()) == \
        [f"{i:06d}.txt" for i in range(4)]


def test_profile_steps_writes_a_trace(kitti_trainer_args, tmp_path):
    """`python -m second_tpu_torch.train.run train ... --profile_steps 1`
    traces the first step with torch.profiler into model_dir/profile."""
    cfg, patches = kitti_trainer_args
    model_dir = tmp_path / "prof"
    argv = ["train", "--config_path", str(cfg), "--model_dir",
            str(model_dir), "--steps", "2", "--profile_steps", "1",
            "--device", "cpu", "--max_points", "6000"]
    for p in patches:
        argv += ["--patchs", p]
    run_mod.main(argv)
    traces = list((model_dir / "profile").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 1000
    assert (model_dir / "checkpoints.json").exists()
