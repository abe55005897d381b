"""BEV scene plotting (matplotlib) — bbox_plot equivalent, the port of
`second_tpu/viewer/plot.py` (matplotlib is imported only when a plot is
drawn).

Equivalent of the reference's `second/utils/bbox_plot.py` drawing helpers:
point clouds + rotated gt/detection boxes on a BEV axis, for debugging and
the viewer.
"""

from __future__ import annotations

import numpy as np

from ..core.box_np import center_to_corner_box2d


def plot_bev(points=None, gt_boxes=None, dt_boxes=None, dt_scores=None,
             pc_range=(0, -40, 70.4, 40), ax=None, save_path=None):
    """Scatter points + draw rotated boxes (gt green, detections red)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(12, 12 * (pc_range[3] - pc_range[1])
                                        / (pc_range[2] - pc_range[0])))
    else:
        fig = ax.figure
    if points is not None:
        ax.scatter(points[:, 0], points[:, 1], s=0.2, c="#445566",
                   linewidths=0)

    def draw(boxes, color, scores=None):
        if boxes is None or len(boxes) == 0:
            return
        corners = center_to_corner_box2d(
            boxes[:, :2], boxes[:, 3:5], boxes[:, 6])
        for i, c in enumerate(corners):
            loop = np.concatenate([c, c[:1]])
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=1.2)
            if scores is not None:
                ax.text(c[0, 0], c[0, 1], f"{scores[i]:.2f}", color=color,
                        fontsize=7)

    draw(gt_boxes, "#2ca02c")
    draw(dt_boxes, "#d62728", dt_scores)
    ax.set_xlim(pc_range[0], pc_range[2])
    ax.set_ylim(pc_range[1], pc_range[3])
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return ax
