"""Visualization / serving backend — JSON-over-HTTP inference server, the
port of `second_tpu/viewer/backend.py` (its inference on the port's
`InferenceContext`: the card unless `--device cpu` is given).

Equivalent of the reference's kittiviewer Flask backend
(`second/kittiviewer/backend.py:28-311`: `readinfo`, `get_pointcloud`,
`build_network`, `inference_by_idx` REST endpoints consumed by the three.js
frontend), built on the stdlib http.server (flask is not in this image).

Endpoints (POST JSON):
    /api/readinfo          {"info_path", "root_path"} → frame index list
    /api/read_detection    {"det_path"} → load saved detections (pkl of anno
                           dicts, or a KITTI label dir) for overlay
                           (reference backend.py:81-101)
    /api/get_pointcloud    {"image_idx", "with_det"?} → points (+gt boxes if
                           labeled, +dt boxes if read_detection loaded)
    /api/get_image         {"image_idx"} → raw camera image as a base64 data
                           URI (reference backend.py:184-219)
    /api/build_network     {"config_path", "model_dir"} → ok
    /api/inference_by_idx  {"image_idx"} → detections
    /api/inference_points  {"points": [[x,y,z,i], ...]} → detections

Run:  python -m second_tpu_torch.viewer.backend --port 16666 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _project_box_corners(boxes_lidar, rect, velo2cam, P2):
    """Lidar boxes [N, 7] → image-plane wireframe corners [N, 8, 2] px
    (the reference frontend's boxEdges projection,
    `kittiviewer/frontend/js/KittiViewer.js` image overlay row)."""
    from ..core import box_np
    boxes_lidar = np.asarray(boxes_lidar, np.float64).reshape(-1, 7)
    if len(boxes_lidar) == 0:
        return np.zeros((0, 8, 2))
    cam = box_np.box_lidar_to_camera(boxes_lidar, rect, velo2cam)
    corners = box_np.center_to_corner_box3d(
        cam[:, :3], cam[:, 3:6], cam[:, 6], origin=(0.5, 1.0, 0.5), axis=1)
    pts = box_np.project_to_image(corners.reshape(-1, 3), P2)
    return pts.reshape(-1, 8, 2)


class BackendState:
    def __init__(self, device="cuda"):
        self.device = device        # where build_network puts the net
        self.dataset = None
        self.ctx = None
        self.calib = None           # (rect, velo2cam, P2) of the last frame
        self.dt_annos = None        # loaded by read_detection, index-aligned

    # -- handlers -----------------------------------------------------------
    def readinfo(self, req):
        from ..data.kitti_dataset import KittiDataset
        self.dataset = KittiDataset(req["info_path"], req["root_path"],
                                    training=False, load_image=True)
        idx = [info["image_idx"] for info in self.dataset.kitti_infos]
        return {"image_indexes": idx}

    def read_detection(self, req):
        """Load saved detections for overlay: a pickle of per-frame KITTI
        anno dicts (what `run.py evaluate` writes) or a directory of KITTI
        label txt files (reference `kittiviewer/backend.py:81-101`)."""
        import pathlib
        import pickle
        from ..data import kitti
        if self.dataset is None:
            raise RuntimeError("call readinfo first")
        det_path = pathlib.Path(req["det_path"])
        if det_path.is_file():
            with open(det_path, "rb") as f:
                self.dt_annos = pickle.load(f)
        else:
            idx = [info["image_idx"] for info in self.dataset.kitti_infos]
            self.dt_annos = kitti.get_label_annos(det_path, image_ids=idx)
        return {"num_frames": len(self.dt_annos)}

    def _frame_pos(self, image_idx):
        idxes = [info["image_idx"] for info in self.dataset.kitti_infos]
        return idxes.index(int(image_idx))

    def get_image(self, req):
        """Raw camera image of a frame as a base64 data URI (reference
        `kittiviewer/backend.py:184-219` sends the on-disk file bytes)."""
        import base64
        import pathlib
        if self.dataset is None:
            raise RuntimeError("call readinfo first")
        info = self.dataset.kitti_infos[self._frame_pos(req["image_idx"])]
        img_path = info.get("img_path", "")
        if not img_path:
            raise RuntimeError("frame has no image")
        path = pathlib.Path(self.dataset.root_path) / img_path
        data = base64.b64encode(path.read_bytes()).decode()
        return {"image_b64": f"data:image/{path.suffix[1:]};base64,{data}"}

    def get_pointcloud(self, req):
        scene = self.dataset[int(req["image_idx"])]
        out = {"num_features": scene["points"].shape[1],
               "pointcloud": scene["points"].round(3).tolist()}
        if "gt_boxes" in scene:
            out["gt_boxes"] = scene["gt_boxes"].tolist()
            out["gt_names"] = list(map(str, scene["gt_names"]))
        self.calib = None
        if all(f"calib/{k}" in scene for k in
               ("R0_rect", "Tr_velo_to_cam", "P2")):
            self.calib = (scene["calib/R0_rect"],
                          scene["calib/Tr_velo_to_cam"], scene["calib/P2"])
            if "gt_boxes" in scene and len(scene["gt_boxes"]):
                out["gt_image_corners"] = _project_box_corners(
                    scene["gt_boxes"], *self.calib).round(1).tolist()
        if req.get("with_det"):
            if self.dt_annos is None:
                raise RuntimeError("call read_detection first")
            from ..core import box_np
            anno = self.dt_annos[self._frame_pos(req["image_idx"])]
            if len(anno["name"]):
                cam = np.concatenate(
                    [anno["location"], anno["dimensions"],
                     anno["rotation_y"][:, None]], axis=1)
                rect = scene["calib/R0_rect"]
                Trv2c = scene["calib/Tr_velo_to_cam"]
                dt_boxes = box_np.box_camera_to_lidar(cam, rect, Trv2c)
            else:
                dt_boxes = np.zeros((0, 7))
            out["dt_boxes"] = dt_boxes.round(3).tolist()
            out["dt_names"] = list(map(str, anno["name"]))
            if "score" in anno:
                out["dt_scores"] = np.asarray(
                    anno["score"]).round(4).tolist()
            if self.calib is not None and len(dt_boxes):
                out["dt_image_corners"] = _project_box_corners(
                    dt_boxes, *self.calib).round(1).tolist()
        img = scene.get("image")
        if img is not None:
            import base64
            import io
            from PIL import Image
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=85)
            out["image_b64"] = base64.b64encode(buf.getvalue()).decode()
        return out

    def build_network(self, req):
        from ..core.inference_ctx import InferenceContext
        self.ctx = InferenceContext(req["config_path"])
        self.ctx.build(req.get("model_dir"), device=self.device)
        return {"ok": True}

    def inference_by_idx(self, req):
        scene = self.dataset[int(req["image_idx"])]
        return self._detect(scene["points"])

    def inference_points(self, req):
        points = np.asarray(req["points"], np.float32)
        return self._detect(points)

    def _detect(self, points):
        det = self.ctx.inference(points)
        out = {"dt_boxes": det["boxes"].round(3).tolist(),
               "dt_scores": det["scores"].round(4).tolist(),
               "dt_names": det["class_names"]}
        if self.calib is not None and len(det["boxes"]):
            out["dt_image_corners"] = _project_box_corners(
                det["boxes"], *self.calib).round(1).tolist()
        return out


def make_handler(state: BackendState):
    routes = {
        "/api/readinfo": state.readinfo,
        "/api/read_detection": state.read_detection,
        "/api/get_image": state.get_image,
        "/api/get_pointcloud": state.get_pointcloud,
        "/api/build_network": state.build_network,
        "/api/inference_by_idx": state.inference_by_idx,
        "/api/inference_points": state.inference_points,
    }

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            # browser frontend: a dependency-free canvas BEV viewer (the
            # three.js kittiviewer frontend equivalent)
            if self.path in ("/", "/viewer"):
                import pathlib
                page = (pathlib.Path(__file__).parent /
                        "frontend.html").read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
            else:
                self.send_error(404)

        def do_POST(self):
            handler = routes.get(self.path)
            if handler is None:
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                result = handler(req)
                body = json.dumps({"status": "ok", **result}).encode()
                self.send_response(200)
            except Exception as e:      # surfaced to the client, not fatal
                body = json.dumps({"status": "error",
                                   "message": str(e)}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve(port=16666, device="cuda"):
    server = ThreadingHTTPServer(("0.0.0.0", port),
                                 make_handler(BackendState(device)))
    print(f"viewer backend listening on :{port}")
    server.serve_forever()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=16666)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the CUDA card by default")
    args = parser.parse_args()
    serve(args.port, args.device)
