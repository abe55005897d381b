"""The cull rule of the 3-D IoU kernel (`d3_cull_plain`, in
`second_tpu_torch/ops/cuda/riou.py`) on the CPU: a pair it culls, which the
kernel writes as 0 without clipping, has a plain 3-D IoU (`d3_iou_plain`)
of at most CULLED_MAX, and a pair with a box that is not tame (a field
non-finite or beyond D3_TAME) is never culled. Held on seeded random,
rotated, touching (a shared edge, a shared corner), 1-ulp-apart,
degenerate, zero-size, z-stacked, padded and non-finite box pairs, as a
hypothesis property and as exact cases; the padded gt slots (zeros) are
culled against every anchor of the SECOND car.fhd config; `d3_iou` on CPU
tensors is `d3_iou_plain`, bitwise, with its count of kept pairs.

`d3_case` builds the cases; the card tests (`tests/test_torch_cuda.py`)
hold the kernel to the plain version on the same ones. This file imports
torch, numpy, hypothesis and the port only."""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from second_tpu_torch.config import load_pipeline_config
from second_tpu_torch.models import build_voxelnet
from second_tpu_torch.ops.box_ops import bev_boxes
from second_tpu_torch.ops.cuda import riou
from second_tpu_torch.ops.rotated_iou import rbbox_to_corners

# a culled pair's plain value: 0, or a rounding sliver of the fp32 clip
CULLED_MAX = 1e-6
CASES = ("random", "touching_edge", "shared_corner", "touching_rotated",
         "ulp_apart", "degenerate", "zero_size", "z_stacked", "padding",
         "non_finite")
REPO = Path(__file__).resolve().parents[1]


def _boxes(rng, shape, spread):
    """Lidar boxes (x, y, z, w, l, h, yaw) fp32, crowded at `spread` m."""
    return np.concatenate([
        rng.uniform([0, -spread / 2, -2.5], [spread, spread / 2, -0.5],
                    shape + (3,)),
        rng.uniform([0.4, 0.6, 1.0], [2.4, 4.6, 2.0], shape + (3,)),
        rng.uniform(-np.pi, np.pi, shape + (1,))], -1).astype(np.float32)


def _envelope_x(b):
    """(lo, hi) x of the BEV corners of [..., 7] boxes, as the cull sees
    them."""
    c = rbbox_to_corners(bev_boxes(torch.from_numpy(b)))[..., 0]
    return c.amin(-1).numpy(), c.amax(-1).numpy()


def _place_right_of(a, b, gap_ulps):
    """Move boxes a along x so their envelope starts at b's envelope end:
    touching (gap_ulps None: placed once, so the gap is 0 or a rounding of
    it either way) or strictly apart by the fewest ulps of x that make the
    gap at least gap_ulps units of the envelope's last place."""
    lo_a, _ = _envelope_x(a)
    _, hi_b = _envelope_x(b)
    a = a.copy()
    a[..., 0] += hi_b - lo_a
    if gap_ulps is None:
        return a
    for _ in range(64):
        lo_a, _ = _envelope_x(a)
        short = lo_a < hi_b + gap_ulps * np.spacing(np.abs(hi_b))
        if not short.any():
            return a
        a[..., 0] = np.where(short, np.nextafter(a[..., 0], np.float32(np.inf)),
                             a[..., 0])
    raise AssertionError("could not place the boxes apart")


def d3_case(name, rng, B=2, N=40, K=9):
    """(boxes1 [B, N, 7], boxes2 [B, K, 7]) fp32 numpy for one geometry:
    the first K rows of boxes1 are built against boxes2 (row i against gt
    box i), the others are random boxes among them."""
    a = _boxes(rng, (B, N), 10.0)
    b = _boxes(rng, (B, K), 10.0)
    k = min(K, N)
    if name == "touching_edge":               # axis-aligned, x edges meet
        b[..., 6] = 0.0
        a[:, :k] = b[:, :k]
        a[:, :k, 0] += 0.5 * (a[:, :k, 3] + b[:, :k, 3])
    elif name == "shared_corner":             # axis-aligned, corners meet
        b[..., 6] = 0.0
        a[:, :k] = b[:, :k]
        a[:, :k, 3:5] *= rng.uniform(0.5, 1.5, (B, k, 2)).astype(np.float32)
        a[:, :k, 0] += 0.5 * (a[:, :k, 3] + b[:, :k, 3])
        a[:, :k, 1] += 0.5 * (a[:, :k, 4] + b[:, :k, 4])
    elif name in ("touching_rotated", "ulp_apart"):
        a[:, :k, 1:3] = b[:, :k, 1:3]          # same y and z: they would meet
        a[:, :k] = _place_right_of(a[:, :k], b[:, :k],
                                   None if name == "touching_rotated" else 1)
    elif name == "degenerate":                 # gt segments, points, specks
        b[:, 0::3, 3] = 0.0
        b[:, 1::3, 3:5] = 0.0
        b[:, 2::3, 3:5] = 1e-3
        a[:, :k, 1:3] = b[:, :k, 1:3]
        a[:, :k] = _place_right_of(a[:, :k], b[:, :k], 1)
    elif name == "zero_size":
        a[:, :k] = b[:, :k]
        a[:, :k:3, 3] = 0.0                    # zero width
        a[:, 1:k:3, 5] = 0.0                   # flat
        b[:, 2::3, 4] = 0.0                    # zero length gt
        b[:, 0, 3:6] = 0.0
    elif name == "z_stacked":                  # same BEV, stacked in z
        a[:, :k] = b[:, :k]
        top = b[:, :k, 2] + b[:, :k, 5]
        a[:, :k, 2] = top                      # touching: overlap 0
        a[:, 1:k:3, 2] = np.nextafter(top[:, 1::3], np.float32(np.inf))
        a[:, 2:k:3, 2] = np.nextafter(top[:, 2::3], np.float32(-np.inf))
    elif name == "padding":                    # padded gt slots
        b[:, K // 2:] = 0.0
    elif name == "non_finite":
        a[:, :k] = b[:, :k]
        a[:, 0, 5], a[:, 0, 2] = np.inf, -np.inf
        a[:, 1, 3] = np.inf
        a[:, 2, 6] = np.nan
        a[:, 3, 0] = 1e13                      # finite, but not tame
        b[:, -1, 1] = np.nan
    elif name != "random":
        raise ValueError(name)
    return a, b


def _tame(x):
    return (x.abs() <= riou.D3_TAME).all(-1)


def _check_cull(a, b):
    """The cull's two properties on one case; returns (cull, plain)."""
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    cull = riou.d3_cull_plain(a, b)
    plain = riou.d3_iou_plain(a, b)
    assert cull.shape == plain.shape == (a.shape[0], a.shape[1], b.shape[1])
    assert torch.isfinite(plain[cull]).all()
    assert not (plain[cull] > CULLED_MAX).any(), float(plain[cull].max())
    wild = ~(_tame(a)[:, :, None] & _tame(b)[:, None])
    assert not (cull & wild).any()
    return cull, plain


@settings(max_examples=60, deadline=None, database=None)
@given(case=st.sampled_from(CASES), seed=st.integers(0, 2 ** 32 - 1))
def test_culled_pairs_have_no_overlap(case, seed):
    """Any seed, any geometry: every culled pair's plain 3-D IoU is at most
    CULLED_MAX, and no pair with a box that is not tame is culled."""
    _check_cull(*d3_case(case, np.random.default_rng(seed)))


@pytest.mark.parametrize("case", CASES)
def test_cull_on_each_geometry(case):
    """The cull's properties and what each geometry must give exactly:
    boxes 1 ulp apart culled with plain value 0; z-stacked boxes culled at
    a touching or 1-ulp gap (plain 0) and kept at a 1-ulp overlap; padded
    gt slots culled against every box; non-finite and huge boxes kept;
    touching boxes culled or kept with a plain value within CULLED_MAX; gt
    segments, points and specks (not solid) never culled by their
    envelopes."""
    rng = np.random.default_rng(CASES.index(case) + 60)
    a, b = d3_case(case, rng)
    cull, plain = _check_cull(a, b)
    K = b.shape[1]
    rows = torch.arange(K)
    pair_cull, pair_plain = cull[:, rows, rows], plain[:, rows, rows]
    if case == "ulp_apart":
        assert pair_cull.all() and (pair_plain == 0).all()
    elif case == "degenerate":
        # apart, but not solid: clipped (the plain clip by a point keeps
        # the whole box)
        assert not pair_cull.any()
        assert (pair_plain[:, 1::3] > 0.1).all()
    elif case == "z_stacked":
        assert pair_cull[:, 0::3].all() and pair_cull[:, 1::3].all()
        assert (pair_plain[:, 0::3] == 0).all()
        assert not pair_cull[:, 2::3].any()
    elif case == "padding":
        assert cull[:, :, K // 2:].all()
        assert (plain[:, :, K // 2:] == 0).all()
    elif case == "non_finite":
        assert not cull[:, :4].any() and not cull[:, :, -1].any()
        assert not torch.isfinite(plain[:, 0]).any()
    elif case in ("touching_edge", "shared_corner", "touching_rotated"):
        assert (pair_plain <= CULLED_MAX).all()
    elif case == "random":
        assert cull.any() and not cull.all() and (plain > 0.05).any()
    elif case == "zero_size":
        assert (pair_plain[:, 0::3] == 0).all() and (plain[:, :, 0] == 0).all()
    # the wrapper on CPU tensors: the plain version bitwise, and its count
    # the kept pairs
    got, count = riou.d3_iou(torch.from_numpy(a), torch.from_numpy(b),
                             count=True)
    assert torch.equal(got.isnan(), plain.isnan())
    assert torch.equal(got.nan_to_num(), plain.nan_to_num())
    assert count.dtype == torch.int32
    assert count.tolist() == (~cull).sum((1, 2)).tolist()


def test_padded_gt_culled_against_fhd_anchors():
    """The IoU branch's layout: the fhd config's 70 400 anchors against a
    gt array of 64 slots, 5 of them boxes among the anchors and 59 padding
    (zeros): every padding pair culled, the few pairs kept all near the gt
    boxes, and the kept count the wrapper reports."""
    cfg = load_pipeline_config(REPO / "second_tpu_torch" / "configs" /
                               "second_car_fhd.config")
    _, _, info, assigner, _ = build_voxelnet(cfg.model, device="cpu")
    anchors = torch.as_tensor(assigner.generate_anchors(
        info.feature_map_size)["anchors"]).reshape(1, -1, 7)
    assert anchors.shape == (1, 70400, 7)
    gt = torch.zeros(1, 64, 7)
    gt[0, :5] = anchors[0, [100, 9000, 30001, 52000, 70399]]
    gt[0, :5, 3:6] *= 1.1
    cull = riou.d3_cull_plain(anchors, gt)
    assert cull[:, :, 5:].all()
    kept = ~cull[0, :, :5]
    assert 5 <= int(kept.sum()) < 2000
    assert kept[[100, 9000, 30001, 52000, 70399], torch.arange(5)].all()
    _, count = riou.d3_iou(anchors, gt, count=True)
    assert count.tolist() == [int(kept.sum())]


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 0), (2, 0, 5),
                                   (3, 130, 70)])
def test_d3_iou_cpu_is_plain(shape):
    """`d3_iou` on CPU tensors is `d3_iou_plain`, bitwise, at the edges of
    the kernel's tiling (one row, no gt, no rows, a tile and two rows over
    a chunk of 64 gt boxes and 6 beyond), and counts the pairs
    `d3_cull_plain` keeps."""
    B, N, K = shape
    rng = np.random.default_rng(61 + N)
    a = torch.from_numpy(_boxes(rng, (B, N), 8.0))
    b = torch.from_numpy(_boxes(rng, (B, K), 8.0))
    got, count = riou.d3_iou(a, b, count=True)
    assert got.shape == (B, N, K)
    assert torch.equal(got, riou.d3_iou_plain(a, b))
    assert torch.equal(riou.d3_iou(a, b), got)
    assert count.tolist() == (~riou.d3_cull_plain(a, b)).sum((1, 2)).tolist()
