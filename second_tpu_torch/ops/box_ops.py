"""Box math on tensors — the port of `second_tpu/ops/box_ops.py`: the box
coding, 2-D and 3-D corners and rotations, the camera / lidar / image
projections and the loss-side helpers. Elementwise where JAX's is,
shape-polymorphic."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import constant


def second_box_encode(boxes, anchors, encode_angle_to_vector=False,
                      smooth_dim=False):
    """SECOND residual encoding of [..., 7] lidar boxes against [..., 7]
    anchors (`second_tpu/ops/box_ops.py:25`)."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
    xg, yg, zg, wg, lg, hg, rg = torch.split(boxes, 1, dim=-1)
    zg = zg + hg / 2
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    zt = (zg - za) / ha
    if smooth_dim:
        lt, wt, ht = lg / la - 1, wg / wa - 1, hg / ha - 1
    else:
        lt, wt, ht = torch.log(lg / la), torch.log(wg / wa), \
            torch.log(hg / ha)
    if encode_angle_to_vector:
        rtx = torch.cos(rg) - torch.cos(ra)
        rty = torch.sin(rg) - torch.sin(ra)
        return torch.cat([xt, yt, zt, wt, lt, ht, rtx, rty], dim=-1)
    return torch.cat([xt, yt, zt, wt, lt, ht, rg - ra], dim=-1)


def second_box_decode(encodings, anchors, encode_angle_to_vector=False,
                      smooth_dim=False):
    """SECOND residual decoding of [..., 7] (or [..., 8] with the angle as a
    vector) encodings against [..., 7] anchors → [..., 7] lidar boxes."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
    if encode_angle_to_vector:
        xt, yt, zt, wt, lt, ht, rtx, rty = torch.split(encodings, 1, dim=-1)
    else:
        xt, yt, zt, wt, lt, ht, rt = torch.split(encodings, 1, dim=-1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    if smooth_dim:
        lg, wg, hg = (lt + 1) * la, (wt + 1) * wa, (ht + 1) * ha
    else:
        lg, wg, hg = torch.exp(lt) * la, torch.exp(wt) * wa, torch.exp(ht) * ha
    if encode_angle_to_vector:
        rg = torch.atan2(rty + torch.sin(ra), rtx + torch.cos(ra))
    else:
        rg = rt + ra
    zg = zg - hg / 2
    return torch.cat([xg, yg, zg, wg, lg, hg, rg], dim=-1)


_CORNER_ORDER_2D = np.array([0, 1, 3, 2])
_CORNER_ORDER_3D = np.array([0, 1, 3, 2, 4, 5, 7, 6])


def corners_nd(dims, origin=0.5):
    """[..., 2] or [..., 3] dims → [..., 4, 2] or [..., 8, 3] unit-box
    corners scaled by dims."""
    ndim = dims.shape[-1]
    if ndim not in (2, 3):
        raise ValueError(f"corners_nd: 2-D or 3-D dims, got {ndim}")
    norm = np.stack(np.unravel_index(np.arange(2 ** ndim), [2] * ndim),
                    axis=1).astype(np.float32)
    norm = norm[_CORNER_ORDER_2D if ndim == 2 else _CORNER_ORDER_3D]
    norm = norm - np.array(origin, dtype=np.float32)
    return dims[..., None, :] * constant(norm, dims.device)


def rotation_2d(points, angles):
    """Rotate [..., P, 2] points by per-box angles, elementwise:
    p @ [[c, -s], [s, c]]."""
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x * c + y * s, -x * s + y * c], dim=-1)


def rotation_3d_in_axis(points, angles, axis=0):
    """Rotate [..., P, 3] point sets about a coordinate axis, elementwise
    (p @ rot_mat_T with the reference's row layouts)."""
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    if axis == 1:
        out = (x * c + z * s, y, -x * s + z * c)
    elif axis in (2, -1):
        out = (x * c + y * s, -x * s + y * c, z)
    elif axis == 0:
        out = (x, y * c + z * s, -y * s + z * c)
    else:
        raise ValueError("axis must be 0, 1, or 2")
    return torch.stack(out, dim=-1)


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 1.0, 0.5),
                           axis=1):
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers[..., None, :]


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers[..., None, :]


def corner_to_standup_nd(boxes_corner):
    return torch.cat([boxes_corner.amin(-2), boxes_corner.amax(-2)], -1)


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def bev_boxes(boxes):
    """[..., 7] lidar boxes → [..., 5] BEV boxes (x, y, w, l, yaw), by
    slices: a list index would copy its indices to the card."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], -1)


def rbbox2d_to_near_bbox(rbboxes):
    """[N, 5(x, y, w, l, yaw)] rotated → [N, 4 xyxy] nearest axis-aligned."""
    rots = torch.abs(limit_period(rbboxes[..., -1], 0.5, math.pi))
    cond = (rots > math.pi / 4)[..., None]
    # by slices: a list index would copy its indices to the card
    swapped = torch.cat([rbboxes[..., 0:2], rbboxes[..., 3:4],
                         rbboxes[..., 2:3]], -1)
    centers_dims = torch.where(cond, swapped, rbboxes[..., :4])
    centers, dims = centers_dims[..., :2], centers_dims[..., 2:]
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


# ---------------------------------------------------------------------------
# Camera / lidar / projection
# ---------------------------------------------------------------------------

def project_to_image(points_3d, proj_mat):
    """Camera-frame points [..., 3] → pixels [..., 2] through the 3 x 4
    `proj_mat`; the homogeneous coordinate is 0, as the reference's."""
    pts4 = torch.cat([points_3d, torch.zeros_like(points_3d[..., :1])], -1)
    pts2 = pts4 @ proj_mat.T
    return pts2[..., :2] / pts2[..., 2:3]


def lidar_to_camera(points, r_rect, velo2cam):
    pts = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    return (pts @ (r_rect @ velo2cam).T)[..., :3]


def camera_to_lidar(points, r_rect, velo2cam):
    pts = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    return (pts @ torch.linalg.inv((r_rect @ velo2cam).T))[..., :3]


def box_lidar_to_camera(data, r_rect, velo2cam):
    """Lidar [x, y, z, w, l, h, yaw] → camera [x, y, z, l, h, w, ry]."""
    xyz = lidar_to_camera(data[..., 0:3], r_rect, velo2cam)
    w, l, h = data[..., 3:4], data[..., 4:5], data[..., 5:6]
    return torch.cat([xyz, l, h, w, data[..., 6:7]], -1)


def boxes3d_to_image_bbox(box3d_camera, P2):
    """Camera-frame 3D boxes → image-plane xyxy 2D boxes."""
    corners = center_to_corner_box3d(
        box3d_camera[..., :3], box3d_camera[..., 3:6], box3d_camera[..., 6],
        origin=(0.5, 1.0, 0.5), axis=1)
    uv = project_to_image(corners, P2)
    return torch.cat([uv.amin(-2), uv.amax(-2)], -1)


# ---------------------------------------------------------------------------
# Loss-side helpers (reference voxelnet.py:642-747)
# ---------------------------------------------------------------------------

def add_sin_difference(boxes1, boxes2):
    """Encode the angle residual as sin(a - b) split across prediction and
    target (`second_tpu/ops/box_ops.py:199`)."""
    rad_pred = torch.sin(boxes1[..., -1:]) * torch.cos(boxes2[..., -1:])
    rad_tg = torch.cos(boxes1[..., -1:]) * torch.sin(boxes2[..., -1:])
    b1 = torch.cat([boxes1[..., :-1], rad_pred], dim=-1)
    b2 = torch.cat([boxes2[..., :-1], rad_tg], dim=-1)
    return b1, b2


def get_direction_target(anchors, reg_targets):
    """Direction-classifier targets: 1 where the gt yaw is above 0
    (`second_tpu/ops/box_ops.py:209`)."""
    rot_gt = reg_targets[..., -1] + anchors[..., -1]
    return (rot_gt > 0).to(torch.int64)
