"""Desktop viewer — the port of `second_tpu/viewer/desktop.py` (its live
inference on the port's `InferenceContext`: the card unless `--device
cpu` is given); the matplotlib equivalent of the reference's Qt/pyqtgraph
kittiviewer (`second/kittiviewer/viewer.py`, `glwidget.py`,
`control_panel.py`, ~2.3k LoC of Qt scaffolding).

Same inspection workflow with few dependencies (matplotlib, imported only
when a figure is drawn; no Qt/OpenGL): a three-pane figure — BEV point cloud with
gt/detection wireframes, the camera image with projected 3D boxes, and a
3D scatter — plus keyboard frame stepping, a score threshold, and live
inference through `InferenceContext` (the reference viewer's
`build_network` / `inference` buttons).

Keys: n/p next/prev frame · +/- score threshold · i run inference on the
current frame (needs --config_path) · w write PNG · q quit.

Run:
    python -m second_tpu_torch.viewer.desktop --info_path ... --root_path ... \
        [--det_path result.pkl] [--config_path cfg --model_dir dir] \
        [--save out.png [--image_idx N]] [--device cpu]

`--save` renders one frame headless (Agg) and exits — used by tests and
remote boxes without a display.
"""

from __future__ import annotations

import argparse

import numpy as np

_EDGES_3D = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


def _bev_corners(boxes_lidar):
    """[N, 7] lidar boxes → BEV corner loops [N, 4, 2]."""
    from ..core import box_np
    b = np.asarray(boxes_lidar, np.float64).reshape(-1, 7)
    if len(b) == 0:
        return np.zeros((0, 4, 2))
    return box_np.center_to_corner_box2d(b[:, :2], b[:, 3:5], b[:, 6])


class DesktopViewer:
    def __init__(self, info_path, root_path, det_path=None,
                 config_path=None, model_dir=None, score_threshold=0.3,
                 device="cuda"):
        from ..data.kitti_dataset import KittiDataset
        self.dataset = KittiDataset(info_path, root_path, training=False,
                                    load_image=True)
        self.frame_ids = [info["image_idx"]
                          for info in self.dataset.kitti_infos]
        self.pos = 0
        self.score_threshold = score_threshold
        self.dt_annos = None
        self.live_det = None        # last InferenceContext result
        self.ctx = None
        if det_path:
            self._load_detections(det_path)
        if config_path:
            from ..core.inference_ctx import InferenceContext
            self.ctx = InferenceContext(config_path)
            self.ctx.build(model_dir, device=device)

    def _load_detections(self, det_path):
        import pathlib
        import pickle
        p = pathlib.Path(det_path)
        if p.is_file():
            with open(p, "rb") as f:
                self.dt_annos = pickle.load(f)
        else:
            from ..data import kitti
            self.dt_annos = kitti.get_label_annos(p,
                                                  image_ids=self.frame_ids)

    # -- frame assembly ------------------------------------------------------
    def frame(self):
        """Points, boxes, calib, image of the current frame."""
        from ..core import box_np
        scene = self.dataset[self.pos]
        out = {"points": scene["points"],
               "image_idx": self.frame_ids[self.pos],
               "gt_boxes": scene.get("gt_boxes", np.zeros((0, 7))),
               "gt_names": scene.get("gt_names", np.array([])),
               "image": scene.get("image"), "calib": None,
               "dt_boxes": np.zeros((0, 7)), "dt_scores": np.zeros(0),
               "dt_names": np.array([])}
        if all(f"calib/{k}" in scene for k in
               ("R0_rect", "Tr_velo_to_cam", "P2")):
            out["calib"] = (scene["calib/R0_rect"],
                            scene["calib/Tr_velo_to_cam"],
                            scene["calib/P2"])
        det = None
        if self.live_det is not None:
            out["dt_boxes"] = np.asarray(self.live_det["boxes"])
            out["dt_scores"] = np.asarray(self.live_det["scores"])
            out["dt_names"] = np.asarray(self.live_det["class_names"])
        elif self.dt_annos is not None:
            det = self.dt_annos[self.pos]
            if len(det["name"]) and out["calib"] is not None:
                cam = np.concatenate(
                    [det["location"], det["dimensions"],
                     det["rotation_y"][:, None]], axis=1)
                rect, Trv2c, _ = out["calib"]
                out["dt_boxes"] = box_np.box_camera_to_lidar(cam, rect,
                                                             Trv2c)
                out["dt_scores"] = np.asarray(det.get(
                    "score", np.ones(len(det["name"]))))
                out["dt_names"] = det["name"]
        keep = out["dt_scores"] >= self.score_threshold
        out["dt_boxes"] = out["dt_boxes"][keep]
        out["dt_scores"] = out["dt_scores"][keep]
        out["dt_names"] = np.asarray(out["dt_names"])[keep]
        return out

    def run_inference(self):
        if self.ctx is None:
            print("no network: pass --config_path/--model_dir")
            return
        scene = self.dataset[self.pos]
        self.live_det = self.ctx.inference(scene["points"])

    # -- drawing -------------------------------------------------------------
    def draw(self, fig):
        from .backend import _project_box_corners
        fig.clf()
        f = self.frame()
        has_img = f["image"] is not None
        ax_bev = fig.add_subplot(1, 3, (1, 2) if not has_img else 1)
        ax3d = fig.add_subplot(1, 3, 3, projection="3d")
        pts = f["points"]
        ax_bev.scatter(pts[:, 0], pts[:, 1], s=0.3, c=pts[:, 2],
                       cmap="viridis", linewidths=0)
        for boxes, color in ((f["gt_boxes"], "lime"),
                             (f["dt_boxes"], "red")):
            for loop in _bev_corners(boxes):
                ax_bev.plot(*np.vstack([loop, loop[:1]]).T, color=color,
                            linewidth=1.0)
        ax_bev.set_aspect("equal")
        ax_bev.set_title(f"frame {f['image_idx']}  "
                         f"gt={len(f['gt_boxes'])} dt={len(f['dt_boxes'])} "
                         f"thr={self.score_threshold:.2f}")
        ax_bev.set_xlabel("x [m]")
        ax_bev.set_ylabel("y [m]")

        sub = pts[:: max(1, len(pts) // 20000)]
        ax3d.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.2,
                     c=sub[:, 2], cmap="viridis", linewidths=0)
        from ..core import box_np
        for boxes, color in ((f["gt_boxes"], "lime"),
                             (f["dt_boxes"], "red")):
            b = np.asarray(boxes, np.float64).reshape(-1, 7)
            if not len(b):
                continue
            corners = box_np.center_to_corner_box3d(
                b[:, :3], b[:, 3:6], b[:, 6], origin=(0.5, 0.5, 0),
                axis=2)
            for c8 in corners:
                for i, j in _EDGES_3D:
                    ax3d.plot(*np.stack([c8[i], c8[j]]).T, color=color,
                              linewidth=0.8)
        ax3d.set_title("3D")

        if has_img:
            ax_img = fig.add_subplot(1, 3, 2)
            img = np.asarray(f["image"])
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            ax_img.imshow(img)
            if f["calib"] is not None:
                h, w = img.shape[:2]
                for boxes, color in ((f["gt_boxes"], "lime"),
                                     (f["dt_boxes"], "red")):
                    if not len(boxes):
                        continue
                    for c8 in _project_box_corners(boxes, *f["calib"]):
                        if not ((c8[:, 0] > -w) & (c8[:, 0] < 2 * w)).all():
                            continue
                        for i, j in _EDGES_3D:
                            ax_img.plot(*np.stack([c8[i], c8[j]]).T,
                                        color=color, linewidth=0.7)
                ax_img.set_xlim(0, w)
                ax_img.set_ylim(h, 0)
            ax_img.set_title("camera")
            ax_img.axis("off")
        fig.canvas.draw_idle()

    # -- event loop ----------------------------------------------------------
    def on_key(self, event, fig):
        if event.key == "n":
            self.pos = (self.pos + 1) % len(self.frame_ids)
            self.live_det = None
        elif event.key == "p":
            self.pos = (self.pos - 1) % len(self.frame_ids)
            self.live_det = None
        elif event.key in ("+", "="):
            self.score_threshold = min(1.0, self.score_threshold + 0.05)
        elif event.key == "-":
            self.score_threshold = max(0.0, self.score_threshold - 0.05)
        elif event.key == "i":
            self.run_inference()
        elif event.key == "w":
            fig.savefig(f"frame_{self.frame_ids[self.pos]}.png", dpi=120)
            print(f"wrote frame_{self.frame_ids[self.pos]}.png")
        elif event.key == "q":
            import matplotlib.pyplot as plt
            plt.close(fig)
            return
        self.draw(fig)

    def show(self):
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(16, 6))
        fig.canvas.mpl_connect(
            "key_press_event", lambda e: self.on_key(e, fig))
        self.draw(fig)
        plt.show()

    def save(self, out_path, image_idx=None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        if image_idx is not None:
            self.pos = self.frame_ids.index(int(image_idx))
        fig = plt.figure(figsize=(16, 6))
        self.draw(fig)
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--info_path", required=True)
    parser.add_argument("--root_path", required=True)
    parser.add_argument("--det_path", default=None)
    parser.add_argument("--config_path", default=None)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--score_threshold", type=float, default=0.3)
    parser.add_argument("--save", default=None,
                        help="render one frame to this PNG and exit")
    parser.add_argument("--image_idx", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of --config_path's net; the "
                             "CUDA card by default")
    args = parser.parse_args(argv)
    v = DesktopViewer(args.info_path, args.root_path, args.det_path,
                      args.config_path, args.model_dir,
                      args.score_threshold, args.device)
    if args.save:
        print(v.save(args.save, args.image_idx))
    else:
        v.show()


if __name__ == "__main__":
    main()
