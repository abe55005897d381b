"""The port's native runtime (`second_tpu_torch/runtime/`) built by several
processes at once: a copy of the package directory without its library,
six processes that call `available()` together, each of which must load a
whole library (none may see a half-linked one), and whose native results
on one seeded input equal the numpy oracles."""

import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from second_tpu_torch.core import augment, box_np
from second_tpu_torch.core.voxelize_np import points_to_voxel as np_voxelize

RUNTIME = Path(__file__).resolve().parents[1] / "second_tpu_torch" / "runtime"
PROCESSES = 6
VOXEL_ARGS = ([0.2, 0.2, 0.4], [0, -8, -3, 16, 8, 1], 5, 4000)

# one process: wait for the start file, call available(), run each native
# function on the seeded input and save the results
CHILD = """
import pickle, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import runtime
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.001)
ok = runtime.available()
out = {"ok": ok}
if ok:
    import numpy as np
    data = np.load(sys.argv[3])
    out["voxels"] = runtime.points_to_voxel(data["points"], *%r)
    out["inside"] = runtime.points_in_rbbox(data["points"], data["boxes"])
    out["collide"] = runtime.box_collision_test(data["bev"], data["bev"])
    out["iou"] = runtime.iou_matrix(data["xyxy"], data["xyxy"][:7])
Path(sys.argv[4]).write_bytes(pickle.dumps(out))
""" % (VOXEL_ARGS,)


def _inputs(rng):
    points = np.concatenate(
        [rng.uniform([0, -8, -3], [16, 8, 1], (3000, 3)),
         rng.uniform(0, 1, (3000, 1))], 1).astype(np.float32)
    boxes = np.concatenate(
        [rng.uniform([1, -6, -2], [15, 6, -1], (12, 3)),
         rng.uniform([0.5, 1.0, 1.0], [2.0, 4.0, 2.0], (12, 3)),
         rng.uniform(-np.pi, np.pi, (12, 1))], 1).astype(np.float32)
    bev = boxes[:, [0, 1, 3, 4, 6]]
    lo = rng.uniform(0, 10, (20, 2))
    xyxy = np.concatenate([lo, lo + rng.uniform(0.5, 4, (20, 2))],
                          1).astype(np.float32)
    return dict(points=points, boxes=boxes, bev=bev, xyxy=xyxy)


@pytest.mark.skipif(not (shutil.which("make") and shutil.which("g++")),
                    reason="make and g++ are needed to build the runtime")
def test_concurrent_builds_all_load_and_match_numpy(tmp_path):
    import pickle
    copy = tmp_path / "pkg" / "runtime"
    shutil.copytree(RUNTIME, copy, ignore=shutil.ignore_patterns(
        "*.so", "*.o", "*.tmp", ".build.lock", "__pycache__"))
    assert not (copy / "native" / "libhost_ops.so").exists()
    data = _inputs(np.random.default_rng(0))
    np.savez(tmp_path / "inputs.npz", **data)
    go = tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(copy.parent), str(go),
         str(tmp_path / "inputs.npz"), str(tmp_path / f"out{i}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(PROCESSES)]
    time.sleep(2.0)            # every child waits on the start file
    go.touch()
    for p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log
    outs = [pickle.loads((tmp_path / f"out{i}.pkl").read_bytes())
            for i in range(PROCESSES)]
    assert [o["ok"] for o in outs] == [True] * PROCESSES
    assert (copy / "native" / "libhost_ops.so").exists()
    assert not list((copy / "native").glob("*.tmp"))

    want_vox = np_voxelize(data["points"], *VOXEL_ARGS)
    want_inside = box_np.points_in_rbbox(data["points"], data["boxes"])
    want_collide = augment.box_collision_test(data["bev"], data["bev"])
    want_iou = box_np.iou_matrix(data["xyxy"], data["xyxy"][:7])
    assert want_inside.any() and want_collide.sum() > len(data["bev"])
    for o in outs:
        for got, want in zip(o["voxels"], want_vox):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(o["inside"], want_inside)
        np.testing.assert_array_equal(o["collide"], want_collide)
        np.testing.assert_allclose(o["iou"], want_iou, rtol=1e-6, atol=1e-7)
