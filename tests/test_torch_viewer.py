"""The port's viewer (`viewer/backend.py`, `viewer/desktop.py`,
`viewer/plot.py`) on the CPU: the image-plane box wireframes exactly
JAX's, the frontend page, the backend's REST handlers over HTTP (the
dataset's frames, images and saved detections exactly as JAX's backend
gives them; `build_network` + `inference_points` / `inference_by_idx`
equal to the port's `InferenceContext`), the desktop viewer's frames
against JAX's and its headless `save` with live inference, and the BEV
plot, on a fake KITTI tree (`data/fake_kitti.py`)."""

import json
import pickle
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu.viewer import backend as jbackend
from second_tpu.viewer import desktop as jdesktop
from second_tpu_torch.data import fake_kitti
from second_tpu_torch.data import kitti_dataset as kd
from second_tpu_torch.data.synthetic import synthetic_calib
from second_tpu_torch.viewer import backend, desktop, plot

from test_torch_inference_ctx import clouds
from test_torch_temporal import one_thread


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """The port's side on one thread: beside the other test workers its
    small ops gain nothing from threads (`test_torch_temporal.one_thread`)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A fake KITTI tree of 3 frames with its infos, a saved-detections
    pickle (the val annos with scores), and the tiny sparse config."""
    tmp = tmp_path_factory.mktemp("viewer")
    root = fake_kitti.write_tree(tmp / "kitti", np.random.default_rng(3),
                                 ids=range(3), label=fake_kitti.CAR_LABEL,
                                 clutter=300, splits=("train", "val"))
    kd.create_kitti_info_file(root)
    info_path = root / "kitti_infos_val.pkl"
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    dets = []
    for k, info in enumerate(infos):
        anno = {key: np.asarray(v) for key, v in info["annos"].items()}
        keep = anno["name"] != "DontCare"
        anno = {key: v[keep] for key, v in anno.items()}
        anno["score"] = np.linspace(0.9, 0.2, keep.sum()) - 0.1 * k
        dets.append(anno)
    det_path = tmp / "result.pkl"
    det_path.write_bytes(pickle.dumps(dets))
    cfg_path = tmp / "tiny.config"
    cfg_path.write_text(TINY_SPARSE_PIPELINE)
    return dict(root=root, info_path=info_path, det_path=det_path,
                cfg_path=cfg_path, tmp=tmp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_box_corners_equals_jax(seed):
    """Lidar boxes → the [N, 8, 2] image-plane wireframes, bitwise JAX's
    (both on the host copies of `core/box_np.py`), none for no boxes."""
    rng = np.random.default_rng(seed)
    rect, velo2cam, P2 = synthetic_calib((375, 1242))
    boxes = np.concatenate([rng.uniform([5, -10, -2], [40, 10, 0], (7, 3)),
                            rng.uniform(1, 4, (7, 3)),
                            rng.uniform(-np.pi, np.pi, (7, 1))], 1)
    got = backend._project_box_corners(boxes, rect, velo2cam, P2)
    assert got.shape == (7, 8, 2)
    np.testing.assert_array_equal(
        got, jbackend._project_box_corners(boxes, rect, velo2cam, P2))
    assert backend._project_box_corners(np.zeros((0, 7)), rect, velo2cam,
                                        P2).shape == (0, 8, 2)


@pytest.fixture(scope="module")
def http(tree):
    """The port's backend on the CPU, served on a free local port."""
    state = backend.BackendState(device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), backend.make_handler(state))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    port = server.server_address[1]

    def post(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    yield port, post, state
    server.shutdown()


def test_frontend_served(http):
    """GET / returns the self-contained BEV viewer page, the JAX package's
    byte for byte; an unknown path is 404."""
    port = http[0]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
        page = r.read()
        assert r.status == 200
    assert b"<canvas" in page and b"inference_by_idx" in page
    from pathlib import Path
    assert page == (Path(jbackend.__file__).parent /
                    "frontend.html").read_bytes()
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    assert e.value.code == 404


def test_backend_dataset_handlers_match_jax(http, tree):
    """readinfo, get_pointcloud (points, gt boxes, their wireframes, the
    camera image as JPEG), get_image, read_detection and get_pointcloud
    with the saved detections over HTTP: JAX's backend's handlers' answers
    on the same tree, exactly; a frame before readinfo is an error."""
    _, post, _ = http
    code, out = post("/api/get_image", {"image_idx": 0})
    assert code == 500 and out["status"] == "error"
    jstate = jbackend.BackendState()
    req = {"info_path": str(tree["info_path"]),
           "root_path": str(tree["root"])}
    code, out = post("/api/readinfo", req)
    assert code == 200 and out["image_indexes"] == [0, 1, 2]
    assert jstate.readinfo(req)["image_indexes"] == [0, 1, 2]
    det_req = {"det_path": str(tree["det_path"])}
    assert post("/api/read_detection", det_req)[1]["num_frames"] == 3
    jstate.read_detection(det_req)
    for idx in range(3):
        for with_det in (False, True):
            req = {"image_idx": idx, "with_det": with_det}
            code, out = post("/api/get_pointcloud", req)
            assert code == 200 and out.pop("status") == "ok"
            want = json.loads(json.dumps(jstate.get_pointcloud(req)))
            assert out == want
            assert "gt_image_corners" in out and "image_b64" in out
            assert ("dt_image_corners" in out) == with_det
        code, out = post("/api/get_image", {"image_idx": idx})
        assert out["image_b64"] == \
            jstate.get_image({"image_idx": idx})["image_b64"]
        assert out["image_b64"].startswith("data:image/png;base64,")


def test_backend_inference_over_http(http, tree):
    """build_network on the CPU, then inference_points and
    inference_by_idx: the detections of the port's `InferenceContext` for
    the same points (boxes to 3 decimals, scores to 4), with wireframes
    once a frame with calib is loaded."""
    _, post, state = http
    code, out = post("/api/build_network",
                     {"config_path": str(tree["cfg_path"])})
    assert code == 200 and out["ok"] and state.ctx.device.type == "cpu"
    pts = clouds(21, n=1)[0].round(3)
    code, out = post("/api/inference_points", {"points": pts.tolist()})
    assert code == 200
    det = state.ctx.inference(pts)
    assert out["dt_names"] == det["class_names"] and len(out["dt_names"])
    np.testing.assert_array_equal(out["dt_boxes"],
                                  det["boxes"].round(3).tolist())
    np.testing.assert_array_equal(out["dt_scores"],
                                  det["scores"].round(4).tolist())
    post("/api/readinfo", {"info_path": str(tree["info_path"]),
                           "root_path": str(tree["root"])})
    post("/api/get_pointcloud", {"image_idx": 1})
    code, out = post("/api/inference_by_idx", {"image_idx": 1})
    det = state.ctx.inference(state.dataset[1]["points"])
    assert code == 200
    np.testing.assert_array_equal(out["dt_boxes"],
                                  det["boxes"].round(3).tolist())
    assert len(out["dt_image_corners"]) == len(det["boxes"])


def test_desktop_frames_match_jax(tree):
    """The desktop viewer's frame assembly (points, gt, the saved
    detections in lidar boxes above the score threshold, calib, image)
    with frame stepping: JAX's, exactly."""
    args = (str(tree["info_path"]), str(tree["root"]), str(tree["det_path"]))
    v, jv = desktop.DesktopViewer(*args), jdesktop.DesktopViewer(*args)
    v.draw = jv.draw = lambda fig: None       # on_key's redraw
    for _ in range(3):
        got, want = v.frame(), jv.frame()
        assert sorted(got) == sorted(want)
        for k in got:
            if k == "calib":
                for a, b in zip(got[k], want[k]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]), k)
        assert 0 < len(got["dt_boxes"]) <= len(got["gt_boxes"])
        for key in ("n", "+"):
            event = type("E", (), {"key": key})()
            v.on_key(event, None)
            jv.on_key(event, None)
        assert v.pos == jv.pos and v.score_threshold == jv.score_threshold


def test_desktop_headless_save_with_inference(tree, monkeypatch):
    """`desktop.main --save` with `--config_path` on the CPU: the frame's
    live detections drawn into a PNG of the three panes."""
    out = tree["tmp"] / "frame.png"
    drawn = []
    real_draw = desktop.DesktopViewer.draw
    monkeypatch.setattr(desktop.DesktopViewer, "draw",
                        lambda self, fig: (drawn.append(self.frame()),
                                           real_draw(self, fig)))
    monkeypatch.setattr(
        desktop.DesktopViewer, "save",
        lambda self, path, image_idx=None, _save=desktop.DesktopViewer.save:
        (self.run_inference(), _save(self, path, image_idx))[1])
    desktop.main(["--info_path", str(tree["info_path"]), "--root_path",
                  str(tree["root"]), "--config_path", str(tree["cfg_path"]),
                  "--score_threshold", "0", "--save", str(out),
                  "--image_idx", "2", "--device", "cpu"])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert drawn[0]["image_idx"] == 2 and len(drawn[0]["dt_boxes"])
    assert drawn[0]["image"] is not None


def test_plot_bev_writes_a_png(tree):
    rng = np.random.default_rng(0)
    pts = clouds(1, n=1)[0]
    boxes = np.concatenate([rng.uniform([2, -6, -2], [14, 6, 0], (3, 3)),
                            rng.uniform(1, 4, (3, 3)),
                            rng.uniform(-np.pi, np.pi, (3, 1))], 1)
    out = tree["tmp"] / "bev.png"
    ax = plot.plot_bev(pts, gt_boxes=boxes, dt_boxes=boxes[:2],
                       dt_scores=np.array([0.9, 0.4]),
                       pc_range=(0, -8, 16, 8), save_path=str(out))
    assert len(ax.lines) == 5 and out.read_bytes()[:4] == b"\x89PNG"
