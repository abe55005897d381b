"""The rotated ROI-align and the standup-NMS bitmask in the port against the
JAX package, on the CPU (the kernels' plain versions): JAX's six geometry
cases, random, rotated, edge-straddling and far-off rois, the batched crop
the two-stage detector takes, the gradients of both against `jax.grad`,
and the standup bitmask and keep sets against JAX's `nms(rotated=False)`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.models.second_stage import crop_rois as jax_crop_rois
from second_tpu.ops.nms import nms as jax_nms
from second_tpu.ops.roi_align_rotated import bilinear_sample as jax_bilinear
from second_tpu.ops.roi_align_rotated import \
    boxes_to_bev_rois as jax_boxes_to_rois
from second_tpu.ops.roi_align_rotated import \
    roi_align_rotated as jax_roi_align
from second_tpu.ops.rotated_iou import \
    standup_iou_matrix as jax_standup_iou
from second_tpu_torch.models.second_stage import crop_rois
from second_tpu_torch.ops import nms
from second_tpu_torch.ops.cuda import riou
from second_tpu_torch.ops.cuda import roi_align as ra
from second_tpu_torch.ops.roi_align_rotated import (bilinear_sample,
                                                    boxes_to_bev_rois,
                                                    roi_align_rotated,
                                                    sample_points)

# the forward on the same sample coordinates: the same arithmetic, bit for
# bit; from the rois: the sample coordinates round differently (sin and cos
# of XLA and of torch differ by an ulp), so the crops within 4e-6 of values
# of order 1 on these maps
SAME_POINTS_TOL = 1e-6
FWD_TOL = 1e-5
# gradients, of each tensor's largest entry
GRAD_TOL = 1e-5
# a sample closer than this to a cell boundary (an integer coordinate) has
# no derivative there: its coordinate's ulp decides the cell, so the rois'
# end-to-end gradient is held only away from it
KINK = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------- JAX's six geometry cases


def test_bilinear_exact_at_pixels():
    rng = np.random.default_rng(0)
    feat = rng.normal(0, 1, (8, 10, 3)).astype(np.float32)
    ys, xs = np.array([2.0, 5.0], np.float32), np.array([3.0, 7.0],
                                                         np.float32)
    got = bilinear_sample(_t(feat), _t(xs), _t(ys)).numpy()
    want = np.asarray(jax_bilinear(jnp.asarray(feat), jnp.asarray(xs),
                                   jnp.asarray(ys)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], feat[2, 3], atol=1e-6)
    np.testing.assert_allclose(got[1], feat[5, 7], atol=1e-6)


def _both(feat, rois, out, samples=2):
    got = roi_align_rotated(_t(feat), _t(rois), out, samples).numpy()
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                    out, samples))
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    return got


def test_constant_map_average():
    feat = np.full((32, 32, 2), 5.0, np.float32)
    got = _both(feat, np.array([[16.0, 16.0, 8.0, 12.0, 0.7]], np.float32),
                (4, 4))
    np.testing.assert_allclose(got, 5.0, atol=1e-5)


def test_axis_aligned_crop_reads_right_region():
    feat = np.broadcast_to(np.arange(32, dtype=np.float32)[None, :, None],
                           (32, 32, 1)).copy()
    got = _both(feat, np.array([[10.0, 16.0, 8.0, 4.0, 0.0]], np.float32),
                (4, 4))
    np.testing.assert_allclose(got[0, 0, :, 0], [7, 9, 11, 13], atol=0.1)


def test_rotated_crop_follows_box_axis():
    feat = np.broadcast_to(np.arange(40, dtype=np.float32)[:, None, None],
                           (40, 40, 1)).copy()
    got = _both(feat, np.array([[20.0, 20.0, 10.0, 4.0, np.pi / 2]],
                               np.float32), (4, 4))
    col_means = got[0].mean(axis=0)[:, 0]
    assert (np.diff(col_means) < 0).all()
    np.testing.assert_allclose(abs(col_means[0] - col_means[-1]), 7.5,
                               atol=0.2)


def test_out_of_bounds_zero():
    got = _both(np.ones((8, 8, 1), np.float32),
                np.array([[100.0, 100.0, 4.0, 4.0, 0.0]], np.float32),
                (2, 2))
    assert (got == 0).all()


def test_boxes_to_rois_geometry():
    boxes = np.array([[35.2, 0.0, -1.0, 1.6, 3.9, 1.5, 0.3]], np.float32)
    args = ((0, -40, -3, 70.4, 40, 1), 8, (0.05, 0.05, 0.1))
    got = boxes_to_bev_rois(_t(boxes), *args).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_boxes_to_rois(jnp.asarray(boxes), *args)))
    np.testing.assert_allclose(got[0, :2], [88.0, 100.0], atol=1e-5)
    np.testing.assert_allclose(got[0, 2], 1.6 / 0.4, atol=1e-5)
    np.testing.assert_allclose(got[0, 4], 0.3, atol=1e-6)


# --------------------------------------------- random, edge, far rois


def _rois(rng, R, H, W, kind):
    rois = np.stack([rng.uniform(0, W, R), rng.uniform(0, H, R),
                     rng.uniform(1, 12, R), rng.uniform(1, 12, R),
                     rng.uniform(-np.pi, np.pi, R)], 1)
    if kind == "edge":
        rois[::2, 0] = rng.uniform(-3, 3, R)[::2]
        rois[1::2, 1] = H + rng.uniform(-3, 3, R)[1::2]
    elif kind == "far":
        rois[::3, 0] = 5000.0
        rois[1::3, 1] = -7000.5
    elif kind == "axis":
        rois[:, 4] = rng.choice([0.0, np.pi / 2, -np.pi], R)
    return rois.astype(np.float32)


def _jax_points(rois, out=(14, 14), samples=2):
    """JAX's sample coordinates (`roi_align_rotated`'s lines), [R, oh * s,
    ow * s] each."""
    def centers(n, s):
        return (jnp.arange(n * s) + 0.5) / (n * s) - 0.5
    uu, vv = jnp.meshgrid(centers(out[1], samples), centers(out[0], samples))
    r = jnp.asarray(rois)
    lx = uu[None] * r[:, 2, None, None]
    ly = vv[None] * r[:, 3, None, None]
    c = jnp.cos(r[:, 4])[:, None, None]
    s = jnp.sin(r[:, 4])[:, None, None]
    return (np.asarray(r[:, 0, None, None] + lx * c + ly * s),
            np.asarray(r[:, 1, None, None] - lx * s + ly * c))


@pytest.mark.parametrize("kind", ["random", "edge", "far", "axis"])
def test_roi_align_matches_jax(kind):
    """The crops from the rois within FWD_TOL of JAX's; the bilinear
    samples on JAX's own sample coordinates within SAME_POINTS_TOL; the
    port's sample coordinates within two ulps of JAX's; zeros off the
    map."""
    rng = np.random.default_rng({"random": 1, "edge": 2, "far": 3,
                                 "axis": 4}[kind])
    feat = rng.normal(0, 1, (30, 26, 6)).astype(np.float32)
    rois = _rois(rng, 40, 30, 26, kind)
    got = _both(feat, rois, (14, 14))
    gx, gy = _jax_points(rois)
    pts = sample_points(_t(rois)).numpy()
    for i, g in enumerate((gx, gy)):
        np.testing.assert_allclose(pts[..., i], g, rtol=0,
                                   atol=2 * np.spacing(np.abs(g).max()))
    same = bilinear_sample(_t(feat), _t(gx), _t(gy)).numpy()
    np.testing.assert_allclose(
        same, np.asarray(jax_bilinear(jnp.asarray(feat), jnp.asarray(gx),
                                      jnp.asarray(gy))),
        rtol=0, atol=SAME_POINTS_TOL)
    if kind == "far":
        assert (got[::3] == 0).all() and (got[1::3] == 0).all()
    else:
        assert (np.abs(got) > 0).mean() > 0.5


def _grads_jax(feat, rois, w):
    return [np.asarray(g) for g in jax.grad(
        lambda f, r: (jax_roi_align(f, r, (14, 14), 2) * w).sum(),
        argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(rois))]


@pytest.mark.parametrize("kind", ["random", "edge", "far"])
def test_roi_align_grads_match_jax(kind):
    """`jax.grad` of a weighted sum of the crops against the port's
    autograd: the map's gradient within GRAD_TOL of its scale; the
    coordinates' gradient on JAX's sample points within SAME_POINTS_TOL of
    its scale (the same products, summed in another order); the rois'
    gradient through the port's `sample_points`
    from it within GRAD_TOL, and end to end within GRAD_TOL at the rois
    none of whose samples lies within KINK of a cell boundary (there the
    derivative jumps, and an ulp of the coordinate decides it)."""
    rng = np.random.default_rng({"random": 5, "edge": 6, "far": 7}[kind])
    feat = rng.normal(0, 1, (30, 26, 6)).astype(np.float32)
    rois = _rois(rng, 24, 30, 26, kind)
    w = rng.normal(0, 1, (24, 14, 14, 6)).astype(np.float32)
    jf, jr = _grads_jax(feat, rois, w)
    f, r = _t(feat).requires_grad_(), _t(rois).requires_grad_()
    (roi_align_rotated(f, r) * _t(w)).sum().backward()
    assert _rel(f.grad, jf) < GRAD_TOL

    # the coordinates' gradient on JAX's points, then through sample_points
    gx, gy = _jax_points(rois)
    ws = np.repeat(np.repeat(w, 2, 1), 2, 2) / 4      # d crop / d sample
    jgx, jgy = jax.grad(
        lambda x, y: (jax_bilinear(jnp.asarray(feat), x, y) * ws).sum(),
        argnums=(0, 1))(jnp.asarray(gx), jnp.asarray(gy))
    tx, ty = _t(gx).requires_grad_(), _t(gy).requires_grad_()
    (bilinear_sample(_t(feat), tx, ty) * _t(ws)).sum().backward()
    assert _rel(tx.grad, jgx) < SAME_POINTS_TOL
    assert _rel(ty.grad, jgy) < SAME_POINTS_TOL
    r2 = _t(rois).requires_grad_()
    (gr,) = torch.autograd.grad(
        sample_points(r2), r2, torch.stack([tx.grad, ty.grad], -1))
    assert _rel(gr, jr) < GRAD_TOL

    frac = np.stack([gx, gy]) % 1.0
    smooth = ((frac > KINK) & (frac < 1 - KINK)).all((0, 2, 3))
    assert smooth.sum() >= len(rois) // 2
    scale = np.abs(jr).max()
    np.testing.assert_allclose(r.grad.numpy()[smooth], jr[smooth], rtol=0,
                               atol=GRAD_TOL * scale)
    if kind == "far":
        assert (r.grad.numpy()[::3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_crop_matches_jax(dtype):
    """`crop_rois` on a batch [B, C, H, W] (the trunk's layout) through the
    kernel's plain version against JAX's `crop_rois` on [B, H, W, C]:
    [B * N, C, k, k] within FWD_TOL; in fp64 against JAX under x64."""
    rng = np.random.default_rng(8)
    B, N, H, W, C = 2, 9, 32, 28, 5
    trunk = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    boxes = np.concatenate([rng.uniform([0, -5, -2], [11, 5, -1], (B, N, 3)),
                            rng.uniform([0.5, 1.0, 1.0], [2.0, 4.5, 2.0],
                                        (B, N, 3)),
                            rng.uniform(-np.pi, np.pi, (B, N, 1))],
                           -1).astype(np.float32)
    args = ((0.0, -6.4, -3.0, 11.2, 6.4, 1.0), (0.2, 0.2, 0.1), 2)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        want = np.asarray(jax_crop_rois(
            jnp.asarray(trunk.astype(np_dtype)),
            jnp.asarray(boxes.astype(np_dtype)), args[0], args[1], args[2]))
    got = crop_rois(_t(trunk.transpose(0, 3, 1, 2)).to(dtype),
                    _t(boxes).to(dtype), *args)
    assert got.shape == (B * N, C, 14, 14) and got.dtype == dtype
    np.testing.assert_allclose(
        got.numpy(), want.reshape(B * N, 14, 14, C).transpose(0, 3, 1, 2),
        rtol=0, atol=FWD_TOL if dtype == torch.float32 else 1e-12)


def test_batched_plain_backward_is_autograd_of_plain():
    """`roi_align_backward_plain` (the kernels' yardstick) is autograd of
    `roi_align_plain`, and a bf16 map promotes to fp32 crops."""
    rng = np.random.default_rng(9)
    feat = _t(rng.normal(0, 1, (2, 4, 12, 10)).astype(np.float32))
    rois = _t(_rois(rng, 6, 12, 10, "edge").reshape(2, 3, 5))
    coords = sample_points(rois)
    grad = _t(rng.normal(0, 1, (6, 4, 14, 14)).astype(np.float32))
    gf, gc = ra.roi_align_backward_plain(feat, coords, grad, 2)
    f, c = feat.clone().requires_grad_(), coords.clone().requires_grad_()
    (ra.roi_align(f, c, 2) * grad).sum().backward()
    assert torch.equal(gf, f.grad) and torch.equal(gc, c.grad)
    out = ra.roi_align(feat.bfloat16(), coords, 2)
    assert out.dtype == torch.float32
    torch.testing.assert_close(
        out, ra.roi_align_plain(feat.bfloat16().float(), coords, 2),
        rtol=0, atol=0)


# ------------------------------------------------- the standup bitmask


def _standup_case(rng, K):
    lo = rng.uniform(0, 25, (K, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.5, 4, (K, 2))], 1)
    dup = rng.uniform(size=K) < 0.3
    boxes[dup] = boxes[rng.integers(0, K, dup.sum())]
    scores = rng.uniform(size=K).astype(np.float32)
    valid = rng.uniform(size=K) < 0.9
    return boxes.astype(np.float32), scores, valid


@pytest.mark.parametrize("K", [33, 512, 2048])
def test_standup_bitmask_and_keep_match_jax(K):
    """The plain standup bitmask (`standup_overlap_plain`, the kernel's
    plain version) bit for bit JAX's `standup_iou_matrix > threshold` over
    the valid upper pairs, and the port's `nms(rotated=False)` indices and
    keep exactly JAX's, on crowded boxes with duplicates."""
    rng = np.random.default_rng(K)
    boxes, scores, valid = _standup_case(rng, K)
    thr = 0.7
    got = riou.unpack_bits(riou.standup_overlap_plain(
        _t(boxes)[None], _t(valid)[None], thr), K)[0].numpy()
    iou = np.asarray(jax_standup_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    want = (iou > np.float32(thr)) & np.triu(np.ones((K, K), bool), 1) & \
        valid[:, None] & valid[None, :]
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    idx, keep = nms.nms(_t(boxes), _t(scores), _t(valid), pre_max_size=K,
                        post_max_size=K // 2, iou_threshold=thr,
                        rotated=False)
    jidx, jkeep = jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(valid), pre_max_size=K,
                          post_max_size=K // 2, iou_threshold=thr,
                          rotated=False)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
