"""The port's `Trainer` (`second_tpu_torch/train/run.py`) and checkpoint
manager on the CPU, on the tiny sparse config: two steps on synthetic scans,
the checkpoint restored by a second Trainer, the crash-save, `evaluate`'s
result.pkl and KITTI txt files, what is not ported yet refused by name, and
the manifest's max_to_keep and restore semantics."""

import json
import pickle

import numpy as np
import pytest
import torch

from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu_torch.train import checkpoint, run
from second_tpu_torch.train.run import Trainer


TRAINER_PATCHES = ["train_config.steps_per_eval=0",
                   "train_config.save_summary_steps=1",
                   "train_input_reader.num_workers=1",
                   "eval_input_reader.num_workers=1"]


@pytest.fixture
def make_trainer():
    """Trainer(...) whose log files are closed at the test's end."""
    made = []

    def make(*args, **kwargs):
        made.append(Trainer(*args, **kwargs))
        return made[-1]
    yield make
    for tr in made:
        tr.logger.close()


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny_sparse.config"
    path.write_text(TINY_SPARSE_PIPELINE)
    return path


def test_trainer_trains_restores_and_evaluates(tiny_config, tmp_path,
                                                make_trainer):
    """The Trainer on the CPU: two steps on synthetic scans, the final
    checkpoint in the manifest, a second Trainer over the same model_dir
    restores it (same parameters, optimizer moments and step) and trains on
    from step 2, and `evaluate` writes result.pkl, gt.pkl and one KITTI txt
    file a frame."""
    kw = dict(synthetic=True, dataset_size=4, max_points=3000,
              total_steps=4, patches=TRAINER_PATCHES, device="cpu")
    tr = make_trainer(str(tiny_config), tmp_path, **kw)
    state = tr.train(2)
    assert state.step == 2
    manifest = json.loads((tmp_path / "checkpoints.json").read_text())
    assert manifest["latest"]["model"] == "model-2"
    log = [json.loads(line) for line in
           (tmp_path / "log.json").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    assert np.isfinite(log[-1]["train.loss"])
    assert {"train.grad_norm", "train.dir_loss", "train.lr"} <= set(log[-1])

    tr2 = make_trainer(str(tiny_config), tmp_path, **kw)
    restored = tr2._init_state()
    assert restored.step == 2
    for (n, a), b in zip(state.module.state_dict().items(),
                         restored.module.state_dict().values()):
        assert torch.equal(a, b), n
    opt_a = state.optimizer.state_dict()["state"]
    opt_b = restored.optimizer.state_dict()["state"]
    assert torch.equal(opt_a[0]["exp_avg"], opt_b[0]["exp_avg"])
    state = tr2.train(3)
    assert state.step == 3

    detail = tr2.evaluate(state, max_frames=4)
    out = tmp_path / "eval_results" / "step_3"
    dt = pickle.loads((out / "result.pkl").read_bytes())
    assert len(dt) == 4 and (out / "gt.pkl").exists()
    assert sorted(p.name for p in (out / "txt").iterdir()) == \
        [f"{i:06d}.txt" for i in range(4)]
    assert isinstance(detail, dict)


def test_trainer_crash_saves(tiny_config, tmp_path, monkeypatch,
                             make_trainer):
    """An exception inside the loop saves a checkpoint at the step reached,
    then propagates (the reference's try/except around the loop)."""
    tr = make_trainer(str(tiny_config), tmp_path, synthetic=True,
                      dataset_size=4, max_points=3000, total_steps=4,
                      patches=TRAINER_PATCHES, device="cpu")
    step = tr.train_step
    calls = []

    def failing(state, batch):
        if calls:
            raise RuntimeError("a crash in the second step")
        calls.append(1)
        return step(state, batch)
    monkeypatch.setattr(tr, "train_step", failing)
    with pytest.raises(RuntimeError, match="crash in the second step"):
        tr.train(4)
    assert checkpoint.CheckpointManager(tmp_path).latest_step() == 1


def test_trainer_refuses_what_is_not_ported(tiny_config, tmp_path):
    """Every model type of JAX's trainer is ported (the KITTI reader, the
    two-stage, the temporal and, with item 14, the three camera-fusion
    types, once refused here: `test_torch_kitti.py`,
    `test_torch_two_stage.py`, `test_torch_temporal.py`,
    `test_torch_fusion*.py`, `test_torch_temporal_fusion.py`): the
    Trainer and the CLI offer exactly JAX's six, and refuse any other
    type by name."""
    assert run.MODEL_TYPES == ("one_stage", "two_stage", "temporal",
                               "fusion", "fusion_two_stage",
                               "temporal_fusion")
    with pytest.raises(ValueError, match="'fusion_3d'"):
        Trainer(str(tiny_config), tmp_path, synthetic=True,
                model_type="fusion_3d", device="cpu")
    with pytest.raises(SystemExit):
        run.main(["train", "--config_path", str(tiny_config),
                  "--model_dir", str(tmp_path), "--model_type",
                  "fusion_3d"])


def test_checkpoint_manager_keeps_max_and_restores(tmp_path):
    """The manifest's latest/all, step-suffixed names, max_to_keep GC, and
    restore of the latest or of a given step."""
    class Holder:
        def __init__(self, v):
            self.v = torch.tensor(float(v))

        def state_dict(self):
            return {"v": self.v}

        def load_state_dict(self, s):
            self.v = s["v"].clone()

    mgr = checkpoint.CheckpointManager(tmp_path, max_to_keep=2)
    assert mgr.try_restore_latest(Holder(0)) is None
    for step in (1, 2, 3):
        mgr.save(Holder(step), step)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not (tmp_path / "model-1.pt").exists()
    assert float(mgr.restore(Holder(0)).v) == 3.0
    assert float(mgr.restore(Holder(0), step=2).v) == 2.0
    with pytest.raises(FileNotFoundError):
        mgr.restore(Holder(0), step=1)
