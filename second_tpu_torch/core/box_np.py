"""Host-side (numpy) box math — the framework's golden-oracle numeric core.

Provides the behavior of the reference's `second/core/box_np_ops.py` (SECOND box
encode/decode at `box_np_ops.py:36-110`, corners `:176-207`, rotations `:265-338`,
anchors `:525-601`, camera/lidar transforms `:604-642`, frustum `:471-522`,
axis-aligned IoU `:659-688`, summed-area-table anchor masking `:776-810`) as
vectorized numpy, with no numba dependency. The JAX device twins live in
`second_tpu/ops/box_ops.py` and are unit-tested against this module.

Box convention (lidar): [x, y, z, w, l, h, yaw] with z the *bottom* of the box,
origin (0.5, 0.5, 0); yaw rotates about +z. Camera boxes use origin
(0.5, 1.0, 0.5) and rotate about +y.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Encode / decode (reference box_np_ops.py:36-110)
# ---------------------------------------------------------------------------

def second_box_encode(boxes, anchors, encode_angle_to_vector=False,
                      smooth_dim=False):
    """SECOND residual encoding of 7-dof boxes against anchors.

    Offsets are normalized by the anchor BEV diagonal; z by anchor height
    (after shifting both to z-center); dims are log ratios (or linear if
    `smooth_dim`); angle is a plain difference (or cos/sin pair).
    """
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    xg, yg, zg, wg, lg, hg, rg = np.split(boxes, 7, axis=-1)
    zg = zg + hg / 2
    za = za + ha / 2
    diag = np.sqrt(la ** 2 + wa ** 2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    zt = (zg - za) / ha
    if smooth_dim:
        lt, wt, ht = lg / la - 1, wg / wa - 1, hg / ha - 1
    else:
        lt, wt, ht = np.log(lg / la), np.log(wg / wa), np.log(hg / ha)
    if encode_angle_to_vector:
        rtx = np.cos(rg) - np.cos(ra)
        rty = np.sin(rg) - np.sin(ra)
        return np.concatenate([xt, yt, zt, wt, lt, ht, rtx, rty], axis=-1)
    return np.concatenate([xt, yt, zt, wt, lt, ht, rg - ra], axis=-1)


def second_box_decode(encodings, anchors, encode_angle_to_vector=False,
                      smooth_dim=False):
    """Inverse of `second_box_encode`."""
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    if encode_angle_to_vector:
        xt, yt, zt, wt, lt, ht, rtx, rty = np.split(encodings, 8, axis=-1)
    else:
        xt, yt, zt, wt, lt, ht, rt = np.split(encodings, 7, axis=-1)
    za = za + ha / 2
    diag = np.sqrt(la ** 2 + wa ** 2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    if smooth_dim:
        lg, wg, hg = (lt + 1) * la, (wt + 1) * wa, (ht + 1) * ha
    else:
        lg, wg, hg = np.exp(lt) * la, np.exp(wt) * wa, np.exp(ht) * ha
    if encode_angle_to_vector:
        rg = np.arctan2(rty + np.sin(ra), rtx + np.cos(ra))
    else:
        rg = rt + ra
    zg = zg - hg / 2
    return np.concatenate([xg, yg, zg, wg, lg, hg, rg], axis=-1)


def bev_box_encode(boxes, anchors, encode_angle_to_vector=False,
                   smooth_dim=False):
    """BEV (5-dof) variant of the SECOND encoding (reference :112-142)."""
    xa, ya, wa, la, ra = np.split(anchors, 5, axis=-1)
    xg, yg, wg, lg, rg = np.split(boxes, 5, axis=-1)
    diag = np.sqrt(la ** 2 + wa ** 2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    if smooth_dim:
        lt, wt = lg / la - 1, wg / wa - 1
    else:
        lt, wt = np.log(lg / la), np.log(wg / wa)
    if encode_angle_to_vector:
        rtx = np.cos(rg) - np.cos(ra)
        rty = np.sin(rg) - np.sin(ra)
        return np.concatenate([xt, yt, wt, lt, rtx, rty], axis=-1)
    return np.concatenate([xt, yt, wt, lt, rg - ra], axis=-1)


def bev_box_decode(encodings, anchors, encode_angle_to_vector=False,
                   smooth_dim=False):
    xa, ya, wa, la, ra = np.split(anchors, 5, axis=-1)
    if encode_angle_to_vector:
        xt, yt, wt, lt, rtx, rty = np.split(encodings, 6, axis=-1)
    else:
        xt, yt, wt, lt, rt = np.split(encodings, 5, axis=-1)
    diag = np.sqrt(la ** 2 + wa ** 2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    if smooth_dim:
        lg, wg = (lt + 1) * la, (wt + 1) * wa
    else:
        lg, wg = np.exp(lt) * la, np.exp(wt) * wa
    if encode_angle_to_vector:
        rg = np.arctan2(rty + np.sin(ra), rtx + np.cos(ra))
    else:
        rg = rt + ra
    return np.concatenate([xg, yg, wg, lg, rg], axis=-1)


# ---------------------------------------------------------------------------
# Corners / rotations (reference :176-338)
# ---------------------------------------------------------------------------

def corners_nd(dims, origin=0.5):
    """Relative corner offsets for N-d boxes given per-dim extents.

    2D corner order is clockwise starting at the minimum corner; 3D follows the
    reference layout [000,001,011,010,100,101,111,110] (x-major bit order with
    the last two swapped per 4-group).
    """
    ndim = int(dims.shape[-1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1
    ).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape([-1, 1, ndim]) * corners_norm.reshape([1, 2 ** ndim, ndim])


def rotation_2d(points, angles):
    """Rotate [N, P, 2] point sets by per-box angles (clockwise-positive
    convention of the reference, `box_np_ops.py:308-321`)."""
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum("npi,nij->npj", points, rot)


def rotation_3d_in_axis(points, angles, axis=0):
    """Rotate [N, P, 3] point sets about a coordinate axis (reference :265-283)."""
    c, s = np.cos(angles), np.sin(angles)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif axis in (2, -1):
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    elif axis == 0:
        # standard x-axis rotation (the reference's axis-0 branch at
        # box_np_ops.py:277-279 is a mis-permuted matrix and is never called;
        # camera boxes use axis=1, lidar axis=2)
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    else:
        raise ValueError("axis must be 0, 1, or 2")
    rot_mat_T = np.stack([np.stack(r) for r in rows])  # [3, 3, N]
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def rotation_points_single_angle(points, angle, axis=0):
    """Rotate [N, 3] points by one scalar angle (reference :286-305)."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == 1:
        rot_mat_T = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=points.dtype)
    elif axis in (2, -1):
        rot_mat_T = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=points.dtype)
    elif axis == 0:
        rot_mat_T = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=points.dtype)
    else:
        raise ValueError("axis must be 0, 1, or 2")
    return points @ rot_mat_T


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 1.0, 0.5),
                           axis=1):
    """KITTI center/dims/yaw → 8 corners (reference :341-366). Use origin
    (0.5, 1.0, 0.5), axis=1 for camera boxes; (0.5, 0.5, 0), axis=2 for lidar."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers.reshape([-1, 1, 3])


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """BEV boxes → 4 corners (reference :369-389)."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape([-1, 1, 2])


def corner_to_standup_nd(boxes_corner):
    """Corner sets → axis-aligned [min..., max...] boxes (reference :242-247)."""
    return np.concatenate(
        [boxes_corner.min(axis=1), boxes_corner.max(axis=1)], axis=-1)


def rbbox2d_to_near_bbox(rbboxes):
    """Rotated BEV box → nearest axis-aligned box by snapping yaw to 0 or π/2
    (reference :250-262). Input [N, 5(x, y, w, l, yaw)], output [N, 4 xyxy]."""
    rots = np.abs(limit_period(rbboxes[..., -1], 0.5, np.pi))
    cond = (rots > np.pi / 4)[..., np.newaxis]
    centers_dims = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(centers_dims[:, :2], centers_dims[:, 2:])


def center_to_minmax_2d(centers, dims):
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def minmax_to_corner_2d(minmax_box):
    ndim = minmax_box.shape[-1] // 2
    center = minmax_box[..., :ndim]
    dims = minmax_box[..., ndim:] - center
    return center_to_corner_box2d(center, dims, origin=0.0)


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap angles into [-offset*period, (1-offset)*period) (reference :467)."""
    return val - np.floor(val / period + offset) * period


def rbbox3d_to_bev_corners(rbboxes, origin=0.5):
    return center_to_corner_box2d(
        rbboxes[..., :2], rbboxes[..., 3:5], rbboxes[..., 6], origin)


# ---------------------------------------------------------------------------
# Anchor grids (reference :525-601)
# ---------------------------------------------------------------------------

def create_anchors_3d_stride(feature_size, sizes=(1.6, 3.9, 1.56),
                             anchor_strides=(0.4, 0.4, 0.0),
                             anchor_offsets=(0.2, -39.8, -1.78),
                             rotations=(0, np.pi / 2), dtype=np.float32):
    """Anchor grid on a [D, H, W] feature map with explicit strides/offsets.

    Returns [D, H, W, num_sizes, num_rots, 7] ordered (z, y, x) to match the
    reference layout (`box_np_ops.py:525-563`).
    """
    zs = np.arange(feature_size[0], dtype=dtype) * anchor_strides[2] + anchor_offsets[2]
    ys = np.arange(feature_size[1], dtype=dtype) * anchor_strides[1] + anchor_offsets[1]
    xs = np.arange(feature_size[2], dtype=dtype) * anchor_strides[0] + anchor_offsets[0]
    return _assemble_anchor_grid(zs, ys, xs, sizes, rotations, dtype)


def create_anchors_3d_range(feature_size, anchor_range, sizes=(1.6, 3.9, 1.56),
                            rotations=(0, np.pi / 2), dtype=np.float32):
    """Anchor grid with centers linspaced over an inclusive xyz range
    (`box_np_ops.py:566-601`). feature_size is [D, H, W] (zyx)."""
    anchor_range = np.asarray(anchor_range, dtype)
    zs = np.linspace(anchor_range[2], anchor_range[5], feature_size[0], dtype=dtype)
    ys = np.linspace(anchor_range[1], anchor_range[4], feature_size[1], dtype=dtype)
    xs = np.linspace(anchor_range[0], anchor_range[3], feature_size[2], dtype=dtype)
    return _assemble_anchor_grid(zs, ys, xs, sizes, rotations, dtype)


def _assemble_anchor_grid(zs, ys, xs, sizes, rotations, dtype):
    sizes = np.reshape(np.array(sizes, dtype=dtype), [-1, 3])
    rotations = np.array(rotations, dtype=dtype)
    num_sizes, num_rots = sizes.shape[0], len(rotations)
    D, H, W = len(zs), len(ys), len(xs)
    # Broadcast to [D, H, W, num_sizes, num_rots, ...]
    zg, yg, xg, rg = np.meshgrid(zs, ys, xs, rotations, indexing="ij")
    # current layout [D, H, W, R]; insert size axis
    def _tile(a):
        return np.broadcast_to(a[:, :, :, None, :], (D, H, W, num_sizes, num_rots))
    xg, yg, zg, rg = _tile(xg), _tile(yg), _tile(zg), _tile(rg)
    sz = np.broadcast_to(sizes[None, None, None, :, None, :],
                         (D, H, W, num_sizes, num_rots, 3))
    out = np.concatenate([
        np.stack([xg, yg, zg], axis=-1), sz, rg[..., None]], axis=-1)
    return out.astype(dtype)


# ---------------------------------------------------------------------------
# Axis-aligned IoU (reference iou_jit :659-688) — vectorized
# ---------------------------------------------------------------------------

def iou_matrix(boxes, query_boxes, eps=0.0):
    """Pairwise IoU of [N, 4] and [K, 4] xyxy boxes."""
    boxes = np.asarray(boxes)
    query_boxes = np.asarray(query_boxes)
    lt = np.maximum(boxes[:, None, :2], query_boxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], query_boxes[None, :, 2:])
    wh = rb - lt + eps
    inter = np.where((wh > 0).all(-1), wh[..., 0] * wh[..., 1], 0.0)
    area_a = ((boxes[:, 2] - boxes[:, 0] + eps) *
              (boxes[:, 3] - boxes[:, 1] + eps))[:, None]
    area_b = ((query_boxes[:, 2] - query_boxes[:, 0] + eps) *
              (query_boxes[:, 3] - query_boxes[:, 1] + eps))[None, :]
    union = area_a + area_b - inter
    return np.where(inter > 0, inter / union, 0.0).astype(boxes.dtype)


# ---------------------------------------------------------------------------
# Camera / lidar / image transforms (reference :471-522, :604-656)
# ---------------------------------------------------------------------------

def projection_matrix_to_CRT_kitti(proj):
    """Decompose P = C[R|T] via QR (reference :471-482)."""
    CR = proj[0:3, 0:3]
    CT = proj[0:3, 3]
    RinvCinv = np.linalg.inv(CR)
    Rinv, Cinv = np.linalg.qr(RinvCinv)
    return np.linalg.inv(Cinv), np.linalg.inv(Rinv), Cinv @ CT


def get_frustum(bbox_image, C, near_clip=0.001, far_clip=100.0):
    """Image bbox → 8-corner camera-frame frustum (reference :485-502)."""
    fku = C[0, 0]
    fkv = -C[1, 1]
    u0v0 = C[0:2, 2]
    z_points = np.array([near_clip] * 4 + [far_clip] * 4, dtype=C.dtype)[:, None]
    b = bbox_image
    box_corners = np.array(
        [[b[0], b[1]], [b[0], b[3]], [b[2], b[3]], [b[2], b[1]]], dtype=C.dtype)
    near = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=C.dtype)
    far = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=C.dtype)
    return np.concatenate([np.concatenate([near, far], axis=0), z_points], axis=1)


def project_to_image(points_3d, proj_mat):
    """Homogeneous projection of camera-frame points to pixels (reference :604-610)."""
    shape = list(points_3d.shape)
    shape[-1] = 1
    pts4 = np.concatenate([points_3d, np.zeros(shape, points_3d.dtype)], axis=-1)
    pts2 = pts4 @ proj_mat.T
    return pts2[..., :2] / pts2[..., 2:3]


def camera_to_lidar(points, r_rect, velo2cam):
    shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(shape + [1])], axis=-1)
    lidar = points @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar[..., :3]


def lidar_to_camera(points, r_rect, velo2cam):
    shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(shape + [1])], axis=-1)
    cam = points @ (r_rect @ velo2cam).T
    return cam[..., :3]


def box_camera_to_lidar(data, r_rect, velo2cam):
    """Camera-frame [x,y,z,l,h,w,ry] → lidar [x,y,z,w,l,h,yaw] (reference :629-634)."""
    xyz = camera_to_lidar(data[:, 0:3], r_rect, velo2cam)
    l, h, w, r = data[:, 3:4], data[:, 4:5], data[:, 5:6], data[:, 6:7]
    return np.concatenate([xyz, w, l, h, r], axis=1)


def box_lidar_to_camera(data, r_rect, velo2cam):
    xyz = lidar_to_camera(data[:, 0:3], r_rect, velo2cam)
    w, l, h, r = data[:, 3:4], data[:, 4:5], data[:, 5:6], data[:, 6:7]
    return np.concatenate([xyz, l, h, w, r], axis=1)


def box3d_to_bbox(box3d, P2):
    """Camera-frame 3D boxes → image-plane 2D xyxy boxes (reference :840-848)."""
    corners = center_to_corner_box3d(
        box3d[:, :3], box3d[:, 3:6], box3d[:, 6], (0.5, 1.0, 0.5), axis=1)
    in_image = project_to_image(corners, P2)
    return np.concatenate([in_image.min(axis=1), in_image.max(axis=1)], axis=1)


def remove_outside_points(points, rect, Trv2c, P2, image_shape):
    """Frustum-cull lidar points outside the camera FOV (reference :645-656)."""
    from .geometry_np import points_in_convex_polygon_3d, corner_to_surfaces_3d
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    image_bbox = [0, 0, image_shape[1], image_shape[0]]
    frustum = get_frustum(image_bbox, C)
    frustum -= T
    frustum = np.linalg.inv(R) @ frustum.T
    frustum = camera_to_lidar(frustum.T, rect, Trv2c)
    surfaces = corner_to_surfaces_3d(frustum[np.newaxis, ...])
    indices = points_in_convex_polygon_3d(points[:, :3], surfaces)
    return points[indices.reshape([-1])]


def points_in_rbbox(points, rbbox, lidar=True):
    """Boolean [num_points, num_boxes] membership matrix (reference :691-702)."""
    from .geometry_np import points_in_convex_polygon_3d, corner_to_surfaces_3d
    if lidar:
        h_axis, origin = 2, (0.5, 0.5, 0.0)
    else:
        h_axis, origin = 1, (0.5, 1.0, 0.5)
    corners = center_to_corner_box3d(
        rbbox[:, :3], rbbox[:, 3:6], rbbox[:, 6], origin=origin, axis=h_axis)
    surfaces = corner_to_surfaces_3d(corners)
    return points_in_convex_polygon_3d(points[:, :3], surfaces)


# ---------------------------------------------------------------------------
# Summed-area-table anchor masking (reference :776-810)
# ---------------------------------------------------------------------------

def sparse_sum_for_anchors_mask(coors, shape):
    """Scatter voxel coords (zyx) into a dense [H, W] occupancy-count map."""
    ret = np.zeros(shape, dtype=np.float32)
    np.add.at(ret, (coors[:, 1], coors[:, 2]), 1.0)
    return ret


def fused_get_anchors_area(dense_map, anchors_bv, stride, offset, grid_size):
    """Occupied-voxel count inside each BEV anchor via a summed-area table.

    `dense_map` must already be cumsum'ed over both axes. `anchors_bv` are
    [N, 4] xyxy metric BEV boxes.
    """
    x0 = np.clip(np.floor((anchors_bv[:, 0] - offset[0]) / stride[0]).astype(np.int64),
                 0, grid_size[0] - 1)
    y0 = np.clip(np.floor((anchors_bv[:, 1] - offset[1]) / stride[1]).astype(np.int64),
                 0, grid_size[1] - 1)
    x1 = np.clip(np.floor((anchors_bv[:, 2] - offset[0]) / stride[0]).astype(np.int64),
                 0, grid_size[0] - 1)
    y1 = np.clip(np.floor((anchors_bv[:, 3] - offset[1]) / stride[1]).astype(np.int64),
                 0, grid_size[1] - 1)
    ID = dense_map[y1, x1]
    IA = dense_map[y0, x0]
    IB = dense_map[y1, x0]
    IC = dense_map[y0, x1]
    return ID - IB - IC + IA
