"""The port's ops (`second_tpu_torch.ops`) against the JAX package on the same
numpy-seeded inputs: box decode, voxelize, the rotated-IoU and row-gather
kernels' plain versions (against the Pallas kernels in interpret mode and
the XLA paths), and NMS. CPU only: the CUDA kernels themselves are checked
on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops import box_ops as jbox
from second_tpu.ops import nms as jnms
from second_tpu.ops import rotated_iou as jriou
from second_tpu.ops import sparse_conv as jsp
from second_tpu.ops.voxelize import voxelize_batch
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jdevice_voxelize
from second_tpu_torch.ops import box_ops, nms, rotated_iou
from second_tpu_torch.ops.cuda import gather, riou
from second_tpu_torch.ops.voxelize import (VoxelizeSpec, device_voxelize,
                                           voxelize)


def random_boxes(rng, n):
    return np.stack([
        rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
        rng.uniform(-3, 1, n), rng.uniform(0.5, 3, n),
        rng.uniform(0.5, 6, n), rng.uniform(0.5, 3, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


def bev(boxes):
    return boxes[:, [0, 1, 3, 4, 6]]


class TestBoxOps:
    @pytest.mark.parametrize("vec,smooth", [(False, False), (True, False),
                                            (False, True)])
    def test_second_box_decode(self, vec, smooth):
        rng = np.random.default_rng(0)
        anchors = random_boxes(rng, 64)
        enc = rng.normal(0, 0.3, (64, 8 if vec else 7)).astype(np.float32)
        want = jbox.second_box_decode(jnp.asarray(enc), jnp.asarray(anchors),
                                      vec, smooth)
        got = box_ops.second_box_decode(torch.from_numpy(enc),
                                        torch.from_numpy(anchors), vec, smooth)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_corners_near_bbox_limit_period(self):
        rng = np.random.default_rng(1)
        b = bev(random_boxes(rng, 50))
        np.testing.assert_allclose(
            rotated_iou.rbbox_to_corners(torch.from_numpy(b)).numpy(),
            np.asarray(jriou.rbbox_to_corners(jnp.asarray(b))), atol=1e-5)
        np.testing.assert_allclose(
            box_ops.rbbox2d_to_near_bbox(torch.from_numpy(b)).numpy(),
            np.asarray(jbox.rbbox2d_to_near_bbox(jnp.asarray(b))), atol=1e-5)
        v = rng.uniform(-10, 10, 100).astype(np.float32)
        np.testing.assert_allclose(
            box_ops.limit_period(torch.from_numpy(v)).numpy(),
            np.asarray(jbox.limit_period(jnp.asarray(v))), atol=1e-5)


def _clustered_points(rng, B, P, pc_range):
    """Points clustered onto few voxels (so voxels fill up and overflow),
    some out of range, the tail of each cloud masked off."""
    lo, hi = np.array(pc_range[:3]), np.array(pc_range[3:])
    centers = rng.uniform(lo, hi, (B, 40, 3))
    pick = rng.integers(0, 40, (B, P))
    xyz = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, 0.15, (B, P, 3))
    xyz[:, :20] = rng.uniform(lo - 2, hi + 2, (B, 20, 3))   # some outside
    pts = np.concatenate([xyz, rng.uniform(0, 1, (B, P, 1))], -1)
    mask = np.arange(P)[None] < rng.integers(P // 2, P, (B, 1))
    return pts.astype(np.float32), mask


class TestVoxelize:
    PC_RANGE = (0.0, -4.0, -2.0, 8.0, 4.0, 2.0)
    VSIZE = (0.5, 0.5, 0.5)

    @pytest.mark.parametrize("max_voxels,max_points,shuffle", [
        (256, 6, False),      # every occupied voxel fits; slots overflow
        (24, 4, False),       # voxel overflow: the smallest keys win
        (24, 4, True),        # voxel overflow under the Knuth-hashed keys
    ])
    def test_matches_jax(self, max_voxels, max_points, shuffle):
        rng = np.random.default_rng(2)
        pts, mask = _clustered_points(rng, 2, 300, self.PC_RANGE)
        kw = dict(voxel_size=self.VSIZE, point_cloud_range=self.PC_RANGE,
                  max_points=max_points, max_voxels=max_voxels,
                  shuffle_overflow=shuffle)
        want = voxelize_batch(jnp.asarray(pts), jnp.asarray(mask), **kw)
        got = voxelize(torch.from_numpy(pts), torch.from_numpy(mask), **kw)
        for k in ("voxels", "coords", "num_points", "num_voxels",
                  "point_voxel", "voxel_overflow"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        if max_voxels < 100:
            assert (got["voxel_overflow"] > 0).all()

    def test_device_voxelize_matches_jax(self):
        rng = np.random.default_rng(3)
        pts, mask = _clustered_points(rng, 3, 200, self.PC_RANGE)
        spec = dict(voxel_size=self.VSIZE, point_cloud_range=self.PC_RANGE,
                    max_points=5, max_voxels=64)
        want = jdevice_voxelize(JVoxelizeSpec(**spec), jnp.asarray(pts),
                                jnp.asarray(mask))
        got = device_voxelize(VoxelizeSpec(**spec), pts, mask, device="cpu")
        for k in ("voxels", "num_points", "coordinates", "voxel_valid",
                  "voxel_overflow"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


class TestRotatedIoU:
    @pytest.mark.parametrize("criterion", [-1, 0, 1])
    def test_plain_matches_pallas_interpret(self, criterion):
        from second_tpu.ops.pallas.riou import rotated_iou_matrix_pallas
        rng = np.random.default_rng(10 + criterion)
        # crowded boxes, so most pairs overlap
        b1 = bev(random_boxes(rng, 20)) * [0.3, 0.3, 1, 1, 1]
        b2 = bev(random_boxes(rng, 30)) * [0.3, 0.3, 1, 1, 1]
        b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
        want = rotated_iou_matrix_pallas(jnp.asarray(b1), jnp.asarray(b2),
                                         criterion=criterion, interpret=True)
        got = riou.riou_matrix_plain(torch.from_numpy(b1),
                                     torch.from_numpy(b2), criterion)
        assert (np.asarray(want) > 0).mean() > 0.2
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_matrix_matches_xla(self):
        rng = np.random.default_rng(14)
        b1 = bev(random_boxes(rng, 150)) * [0.4, 0.4, 1, 1, 1]
        b2 = bev(random_boxes(rng, 90)) * [0.4, 0.4, 1, 1, 1]
        b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
        want = jriou.rotated_iou_matrix(jnp.asarray(b1), jnp.asarray(b2))
        got = rotated_iou.rotated_iou_matrix(torch.from_numpy(b1),
                                             torch.from_numpy(b2))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_pairs_match_quad_intersection_area(self):
        rng = np.random.default_rng(15)
        b = bev(random_boxes(rng, 60)) * [0.3, 0.3, 1, 1, 1]
        b = b.astype(np.float32)
        i = rng.integers(0, 60, 500)
        j = rng.integers(0, 60, 500)
        c = jriou.rbbox_to_corners(jnp.asarray(b))
        inter = jriou.quad_intersection_area(c[i], c[j])
        area = b[:, 2] * b[:, 3]
        want = np.asarray(inter) / np.maximum(
            area[i] + area[j] - np.asarray(inter), 1e-12)
        got = riou.riou_pairs(torch.from_numpy(b), torch.from_numpy(b),
                              torch.from_numpy(i), torch.from_numpy(j))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        tc = torch.from_numpy(np.array(c))
        np.testing.assert_allclose(
            rotated_iou.quad_intersection_area(tc[i], tc[j]).numpy(),
            np.asarray(inter), atol=1e-5)


class TestGather:
    def test_plain_matches_pallas_interpret(self):
        from second_tpu.ops.pallas.gather import gather_rows_pallas
        rng = np.random.default_rng(21)
        src = rng.standard_normal((96, 40)).astype(np.float32)
        idx = np.concatenate([rng.integers(0, 96, 50), [0, 95, 95]]
                             ).astype(np.int32)
        want = gather_rows_pallas(jnp.asarray(src), jnp.asarray(idx),
                                  rows_per_tile=16, inflight=4,
                                  interpret=True)
        got = gather.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64,
                                       np.uint8])
    def test_flat_rows_matches_xla(self, dtype):
        rng = np.random.default_rng(22)
        src = (rng.standard_normal((3, 48, 6)) * 100).astype(dtype)
        idx = rng.integers(0, 48, size=(3, 5, 7)).astype(np.int32)
        want = jsp.flat_rows(jnp.asarray(src), jnp.asarray(idx))
        got = gather.flat_rows(torch.from_numpy(src), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
    def test_flat_rows_index_dtypes_match_xla(self, idx_dtype):
        """The row gather takes int32 and int64 indices as they come (the
        sort orders, searchsorted positions and top-k indices the callers
        pass are int64); both give JAX's flat_rows."""
        rng = np.random.default_rng(23)
        src = rng.standard_normal((4, 64, 3)).astype(np.float32)
        idx = rng.integers(0, 64, size=(4, 50)).astype(idx_dtype)
        want = jsp.flat_rows(jnp.asarray(src),
                             jnp.asarray(idx.astype(np.int32)))
        got = gather.flat_rows(torch.from_numpy(src), torch.from_numpy(idx))
        assert got.shape == (4, 50, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_kernel_wrapper_refuses_other_devices(self):
        """A tensor that is not on the CPU goes to the kernel or raises: the
        wrappers never fall back to the plain version."""
        src = torch.empty((8, 4), device="meta")
        idx = torch.zeros((3,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            gather.gather_rows(src, idx)
        b = torch.empty((3, 5), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            riou.riou_matrix(b, b)
        cand = torch.empty((2, 3, 5), device="meta")
        valid = torch.ones((2, 3), dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            riou.nms_overlap(cand, valid, 0.01, 16)
        with pytest.raises(ValueError, match="unsupported device"):
            riou.nms_suppress(torch.zeros((2, 3, 1), dtype=torch.int32,
                                          device="meta"), valid)


def _clear_boxes(rng, n_clusters=12, per=6):
    """BEV boxes whose pairwise IoU is either 0 (other clusters) or far above
    the 0.01 NMS threshold (same cluster)."""
    out = []
    for c in range(n_clusters):
        cx, cy = 12.0 * (c % 4), 12.0 * (c // 4)
        w, l, yaw = rng.uniform(1.5, 2), rng.uniform(3.5, 4.5), \
            rng.uniform(-np.pi, np.pi)
        for _ in range(per):
            out.append([cx + rng.normal(0, 0.4), cy + rng.normal(0, 0.4),
                        w * rng.uniform(0.9, 1.1), l * rng.uniform(0.9, 1.1),
                        yaw + rng.normal(0, 0.2)])
    return np.asarray(out, np.float32)


def _standup_pairs(boxes, scores, valid, k, threshold):
    """The number of candidate pairs (i < j among the top-k valid boxes)
    whose standup-envelope IoU bound exceeds the threshold: the pairs that
    rotated NMS clips, before its `max_pairs` cap."""
    top = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")[:k]
    top = top[valid[top]]
    return _maybe_pairs(boxes[top], threshold)


def _maybe_pairs(boxes, threshold):
    """The pairs i < j of these boxes whose standup-envelope IoU bound
    exceeds the threshold."""
    c = np.asarray(jriou.rbbox_to_corners(jnp.asarray(boxes)))
    lo, hi = c.min(1), c.max(1)
    wh = np.clip(np.minimum(hi[:, None], hi[None]) -
                 np.maximum(lo[:, None], lo[None]), 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = boxes[:, 2] * boxes[:, 3]
    # the envelopes' overlap can exceed both areas: then the bound is huge
    bound = inter / np.maximum(area[:, None] + area[None] - inter, 1e-12)
    return int(np.triu(bound > threshold, 1).sum())


def _nms_batch(rng):
    """Three examples of 72 BEV boxes: one with 80% valid and distinct
    scores, one with no valid box, and one with tied scores (four levels)
    and tied boxes (ten boxes duplicated)."""
    boxes = np.stack([_clear_boxes(rng) for _ in range(3)])
    n = boxes.shape[1]
    boxes[2, 10:20] = boxes[2, 0:10]
    scores = np.stack([rng.permutation(n) / n, rng.permutation(n) / n,
                       rng.integers(1, 5, n) / 4]).astype(np.float32)
    valid = np.stack([rng.uniform(size=n) > 0.2, np.zeros(n, bool),
                      rng.uniform(size=n) > 0.1])
    return boxes, scores, valid


class TestNMS:
    # max_pairs 16 keeps the first 16 row-major candidate pairs and counts
    # the rest as non-overlapping, as every fhd example on the card does at
    # its cap of 8192
    @pytest.mark.parametrize("rotated,max_pairs", [
        pytest.param(True, 8192, id="True"),
        pytest.param(False, 8192, id="False"),
        pytest.param(True, 16, id="True-capped")])
    def test_matches_jax(self, rotated, max_pairs):
        rng = np.random.default_rng(30)
        boxes = _clear_boxes(rng)
        n = boxes.shape[0]
        iou = np.asarray(jriou.rotated_iou_matrix(jnp.asarray(boxes),
                                                  jnp.asarray(boxes)))
        assert not ((iou > 0.005) & (iou < 0.05)).any()
        scores = rng.permutation(n).astype(np.float32) / n
        valid = rng.uniform(size=n) > 0.2
        kw = dict(pre_max_size=48, post_max_size=20, iou_threshold=0.01)
        pairs = _standup_pairs(boxes, scores, valid, 48, 0.01)
        assert (pairs > max_pairs) == (max_pairs == 16), pairs
        if rotated:
            kw["max_pairs"] = max_pairs
            want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(valid), **kw)
            got = nms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), **kw)
        else:
            want = jnms.nearest_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), **kw)
            got = nms.nearest_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores),
                                  torch.from_numpy(valid), **kw)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        kept = int(got[1].sum())
        if pairs > max_pairs:
            # overlaps past the cap go unclipped, so all 20 output slots fill
            assert kept == 20
        else:
            assert 0 < kept < 20

    @pytest.mark.parametrize("rotated,max_pairs", [
        pytest.param(True, 8192, id="True"),
        pytest.param(False, 8192, id="False"),
        pytest.param(True, 16, id="True-capped")])
    def test_batched_matches_vmap_jax(self, rotated, max_pairs):
        """The batched NMS (one call over [B, N]) against `jax.vmap` of the
        JAX function: an example with no valid box, tied scores and tied
        boxes among the top-k, and the 16-pair cap; indices and keep
        exact."""
        rng = np.random.default_rng(31)
        boxes, scores, valid = _nms_batch(rng)
        kw = dict(pre_max_size=48, post_max_size=20, iou_threshold=0.01)
        if rotated:
            kw["max_pairs"] = max_pairs
            pairs = [_standup_pairs(boxes[b], scores[b], valid[b], 48, 0.01)
                     for b in range(3)]
            assert pairs[1] == 0 and (min(pairs[0], pairs[2]) > 16)
        jfn = jnms.nms if rotated else jnms.nearest_nms
        want = jax.vmap(lambda b, s, v: jfn(b, s, v, **kw))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
        tfn = nms.nms if rotated else nms.nearest_nms
        got = tfn(torch.from_numpy(boxes), torch.from_numpy(scores),
                  torch.from_numpy(valid), **kw)
        assert got[0].shape == (3, 20)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert not got[1][1].any() and got[1][0].any() and got[1][2].any()

    @pytest.mark.parametrize("max_pairs", [16, 8192])
    def test_packed_overlap_matches_jax(self, max_pairs):
        """The plain `nms_overlap` bitmask, unpacked, is JAX's
        `_sparse_rotated_over(...) > 0.5` example by example; its pair count
        is the standup-bound pairs' before the cap."""
        rng = np.random.default_rng(32)
        boxes, _, valid = _nms_batch(rng)
        over, count = riou.nms_overlap_plain(
            torch.from_numpy(boxes), torch.from_numpy(valid), 0.01, max_pairs)
        K = boxes.shape[1]
        assert over.shape == (3, K, 3) and over.dtype == torch.int32
        got = riou.unpack_bits(over, K).numpy()
        for b in range(3):
            want = jnms._sparse_rotated_over(
                jnp.asarray(boxes[b]), jnp.asarray(valid[b]), 0.01,
                max_pairs)
            np.testing.assert_array_equal(got[b], np.asarray(want) > 0.5)
            assert int(count[b]) == _maybe_pairs(boxes[b][valid[b]], 0.01)
        assert int(count[1]) == 0 and int(count[0]) > 16
        assert got[0].sum() > 0 and got[2].sum() > 0

    def test_plain_suppression_matches_jax(self):
        """The plain suppression over a packed random strictly-upper overlap
        matrix (valid pairs only) is JAX's `_greedy_suppress_over`, and the
        sequential greedy walk the suppression kernel runs."""
        rng = np.random.default_rng(33)
        B, K = 3, 70
        valid = rng.uniform(size=(B, K)) > 0.15
        valid[1] = False
        over = np.triu(rng.uniform(size=(B, K, K)) < 0.08, 1) & \
            valid[:, :, None] & valid[:, None, :]
        want = jax.vmap(jnms._greedy_suppress_over)(
            jnp.asarray(over, jnp.float32), jnp.asarray(valid))
        got = riou.nms_suppress_plain(riou.pack_bits(torch.from_numpy(over)),
                                      torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        walk = np.zeros((B, K), bool)
        for b in range(B):
            removed = np.zeros(K, bool)
            for i in range(K):
                if valid[b, i] and not removed[i]:
                    walk[b, i] = True
                    removed |= over[b, i]
        np.testing.assert_array_equal(got.numpy(), walk)
        assert walk[0].sum() < valid[0].sum() and not walk[1].any()

    @pytest.mark.parametrize("K", [1, 31, 32, 33, 70])
    def test_pack_bits_round_trip(self, K):
        rng = np.random.default_rng(K)
        mask = torch.from_numpy(rng.uniform(size=(2, 3, K)) < 0.5)
        mask[1, 2, K - 1] = True            # bit 31 (the sign) at K = 32
        words = riou.pack_bits(mask)
        assert words.shape == (2, 3, (K + 31) // 32)
        assert words.dtype == torch.int32
        assert torch.equal(riou.unpack_bits(words, K), mask)
        assert (int(words[1, 2, (K - 1) // 32]) >> ((K - 1) % 32)) & 1

    def test_top_k_ties_resolve_lowest_index_first(self):
        v = np.array([0.5, -np.inf, 0.9, 0.5, -np.inf, 0.9, -np.inf],
                     np.float32)
        want_v, want_i = jax.lax.top_k(jnp.asarray(v), 6)
        got_v, got_i = nms.top_k(torch.from_numpy(v), 6)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
