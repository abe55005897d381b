"""The plain mirrors of three kernels' orders of work, on the CPU.

`roi_align_fwd_cells_plain` is the ROI-align forward kernel's order: the
map channels-last, each sample's staged cell (base offset, inside mask,
weights), each bin summed from the pixels' rows in sample order, a tile
[R, bins, C] written out transposed. It must equal the plain version
(`roi_align_plain`) bit for bit, and JAX's `roi_align_rotated` within fp32
rounding of the sample points, on bf16, fp32 and fp64 maps, any channel
count, 1 or 2 samples a bin side, rois half off the map, far off it,
non-finite, and one whose samples all land in one pixel.

`nms_suppress_walk_plain` is the suppression kernel's walk: words of 32
rows, each word's diagonal block transposed up front, the rows removed by
earlier words' kept rows ORed ahead of the walk, each word settled in
rounds. Its keep set must equal the frontier rounds' (`nms_suppress_plain`)
and JAX's `_greedy_suppress_over` (jitted), on seeded bitmasks: random,
dense, long chains (each row overlapping the next), all rows invalid.

`standup_overlap_tiles_plain`, here, is the standup-NMS bitmask kernel's
order, at the tile that csrc/riou.cu compiles: tiles of rows by words, the
tiles at or below the diagonal zeros with no test, a box with a NaN taken
as the empty box and the widths by fmin / fmax, each row's limit (the row,
none for an invalid row), each word the ballot of its lanes' bits. It must
equal the plain version (`standup_overlap_plain`) bit for bit, and JAX's
`standup_iou_matrix` thresholded, masked to the strict upper triangle of
valid pairs and packed, in fp32 and fp64, at thresholds 0.7, 0 and below
0, at K on either side of a word and of a tile's rows and columns, with
duplicates, NaN and zero-area boxes, and with every row invalid."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops.nms import _greedy_suppress_over as jax_greedy
from second_tpu.ops.roi_align_rotated import \
    roi_align_rotated as jax_roi_align
from second_tpu.ops.rotated_iou import \
    standup_iou_matrix as jax_standup_iou
from second_tpu_torch.ops.cuda import riou
from second_tpu_torch.ops.cuda import roi_align as ra
from second_tpu_torch.ops.roi_align_rotated import sample_points

# the port's crops against JAX's at the same rois: the sample points' sin
# and cos round an ulp apart in the two frameworks
CROP_TOL = 1e-5
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
          "fp64": torch.float64}


def _rois(rng, B, N, H, W, odd=True):
    """[B, N, 5] rois (cx, cy, w, l, yaw) in pixels: random rotated ones;
    with `odd`, every other straddling the left edge, one far off the map,
    one zero-sized inside a single pixel, one NaN."""
    rois = np.stack([rng.uniform(0, W, (B, N)), rng.uniform(0, H, (B, N)),
                     rng.uniform(1, 12, (B, N)), rng.uniform(1, 12, (B, N)),
                     rng.uniform(-np.pi, np.pi, (B, N))], -1)
    if odd:
        rois[:, ::2, 0] = rng.uniform(-3, 3, (B, N))[:, ::2]
        rois[:, 1, :2] = (3.0e6, -7000.5)
        rois[:, 3, :4] = (W // 2 + 0.5, H // 2 + 0.5, 0.2, 0.1)
        rois[:, 5, 0] = np.nan
    return rois


def _case(dtype, C, samples, odd=True, B=2, N=8, H=21, W=18, seed=0):
    rng = np.random.default_rng(seed + C + 10 * samples)
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    feat = torch.from_numpy(rng.normal(0, 1, (B, C, H, W))).to(dtype)
    rois = torch.from_numpy(_rois(rng, B, N, H, W, odd)).to(cdt)
    return feat, rois, sample_points(rois, (14, 14), samples)


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("samples", [1, 2])
@pytest.mark.parametrize("C", [1, 33, 64, 128, 160])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_roi_align_fwd_mirror_is_plain_bitwise(dtype, C, samples):
    """The forward kernel's order of work gives the plain version's crops
    bit for bit (NaN where the plain version has NaN: the NaN roi's bins;
    zeros off the map), in the coordinates' dtype."""
    feat, rois, coords = _case(DTYPES[dtype], C, samples)
    got = ra.roi_align_fwd_cells_plain(feat, coords, samples)
    want = ra.roi_align_plain(feat, coords, samples)
    assert got.shape == want.shape == (16, C, 14, 14)
    assert got.dtype == want.dtype == coords.dtype
    assert torch.equal(_bits(got), _bits(want))
    crops = got.reshape(2, 8, -1)
    assert torch.isnan(crops[:, 5]).all() and not torch.isnan(
        crops[:, :5]).any()
    assert (crops[:, 1] == 0).all()
    # the tiny roi: every sample in one cell, all four taps inside
    base, mask, _ = ra.sample_taps(coords[:, 3], *feat.shape[2:])
    assert (base == base[:, :1, :1]).all() and (mask == 15).all()


def test_sample_taps_are_the_plain_taps():
    """The staged cell of each sample names the plain version's four taps:
    tap t at base + (t // 2) W + t % 2, inside exactly where the plain
    version reads the map."""
    feat, rois, coords = _case(torch.float32, 3, 2)
    H, W = feat.shape[2:]
    base, mask, w = ra.sample_taps(coords, H, W)
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    for t in range(4):
        xt, yt = x0 + t % 2, y0 + t // 2
        inb = (xt >= 0) & (xt <= W - 1) & (yt >= 0) & (yt <= H - 1)
        assert torch.equal((mask >> t) & 1 == 1, inb)
        off = base + (t // 2) * W + t % 2
        assert torch.equal(off[inb], (yt * W + xt)[inb].long())
    finite = torch.isfinite(coords).all(-1)
    torch.testing.assert_close(w.sum(-1)[finite],
                               torch.ones(int(finite.sum())))


@pytest.mark.parametrize("samples", [1, 2])
@pytest.mark.parametrize("C", [5, 128])
def test_roi_align_fwd_mirror_matches_jax(C, samples):
    """Against JAX's `roi_align_rotated`, one example's map [H, W, C] and
    rois at a time, fp32, finite rois (edge-straddling, far off, tiny):
    within CROP_TOL of the crops' scale."""
    feat, rois, coords = _case(torch.float32, C, samples)
    keep = [i for i in range(rois.shape[1]) if i != 5]
    rois, coords = rois[:, keep], coords[:, keep]
    got = ra.roi_align_fwd_cells_plain(feat, coords, samples)
    got = got.reshape(2, len(keep), C, 14, 14).permute(0, 1, 3, 4, 2)
    for b in range(2):
        want = np.asarray(jax_roi_align(
            jnp.asarray(feat[b].permute(1, 2, 0).numpy()),
            jnp.asarray(rois[b].numpy()), (14, 14), samples))
        err = np.abs(got[b].numpy() - want).max() / np.abs(want).max()
        assert err <= CROP_TOL, err


def _bitmask(kind, B, K, seed):
    """[B, K, K] strictly-upper overlaps of valid rows, and valid [B, K]."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand(B, K, generator=g) > 0.2
    if kind == "random":
        over = torch.rand(B, K, K, generator=g) < 4.0 / max(K, 1)
    elif kind == "dense":
        over = torch.rand(B, K, K, generator=g) < 0.3
    elif kind == "chain":
        # each row overlaps the next: the greedy keeps every other row
        valid[:] = True
        over = torch.zeros(B, K, K, dtype=torch.bool)
        i = torch.arange(K - 1)
        over[:, i, i + 1] = True
    else:
        valid[:] = False
        over = torch.rand(B, K, K, generator=g) < 0.5
    over = torch.triu(over, 1) & valid[:, :, None] & valid[:, None, :]
    return over, valid


_jax_greedy = jax.jit(jax_greedy)


@pytest.mark.parametrize("kind", ["random", "dense", "chain", "invalid"])
@pytest.mark.parametrize("K", [1, 31, 32, 33, 100, 1000])
def test_nms_suppress_walk_mirror(K, kind):
    """The walk keeps what the frontier rounds keep, and what JAX's greedy
    suppression keeps, example by example."""
    B = 3
    over, valid = _bitmask(kind, B, K, seed=K * 4 + len(kind))
    bits = riou.pack_bits(over)
    got = riou.nms_suppress_walk_plain(bits, valid)
    assert got.dtype == torch.bool and got.shape == (B, K)
    assert torch.equal(got, riou.nms_suppress_plain(bits, valid))
    for b in range(B):
        want = np.asarray(_jax_greedy(jnp.asarray(over[b].numpy(),
                                                  jnp.float32),
                                      jnp.asarray(valid[b].numpy())))
        np.testing.assert_array_equal(got[b].numpy(), want)
    if kind == "chain":
        assert torch.equal(got, (torch.arange(K) % 2 == 0).expand(B, K))
    if kind == "invalid":
        assert not got.any()


def _standup_tile():
    """The standup kernel's tile, rows by words, as csrc/riou.cu compiles
    it (SU_ROWS, SU_WORDS)."""
    src = (Path(riou.__file__).resolve().parents[2] / "csrc" /
           "riou.cu").read_text()
    tile = dict(re.findall(r"constexpr int (SU_ROWS|SU_WORDS) = (\d+);",
                           src))
    return int(tile["SU_ROWS"]), int(tile["SU_WORDS"])


def standup_overlap_tiles_plain(cand, valid, iou_threshold):
    """The standup kernel's order of work in plain PyTorch: cand [B, K, 4]
    xyxy, valid [B, K] → [B, K, ceil(K / 32)] int32. Tiles of SU_ROWS rows
    by SU_WORDS words; a tile whose columns all lie at or before its first
    row is zeros, with no test. A box with a NaN, or empty in x or y, is
    taken as the empty box (+inf, +inf, -inf, -inf), and so is an invalid
    column. In a tile each word is a warp's, a lane a column
    j = 32 w + lane: the warp walks the tile's valid rows i before the
    word's last column (an invalid row's words stay 0); a lane's boxes
    meet where j > i and each box's x2 lies after the other's x1, and the
    same in y. Only there are the widths (`fmin` / `fmax`), product, union
    and quotient taken: the bit is `iou > thr` in the boxes' dtype, or
    `0 > thr` where the product is 0. A threshold below 0 also sets the
    valid pairs j > i that do not meet. The word is the ballot of the
    lanes' bits, lane n its bit n."""
    B, K = valid.shape
    W = (K + 31) // 32
    R, T = _standup_tile()
    dt = cand.dtype
    inf = float("inf")
    empty = torch.tensor([inf, inf, -inf, -inf], dtype=dt)
    meets = (cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1])
    box = torch.where(meets[..., None], cand, empty)
    area = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
    thr = torch.tensor(iou_threshold, dtype=dt)
    zero_hit = bool(torch.zeros((), dtype=dt) > thr)
    lanes = torch.arange(32)
    over = torch.zeros((B, K, W), dtype=torch.int64)
    for b in range(B):
        for r0 in range(0, K, R):
            # the tile's valid rows, in order
            rows = r0 + torch.nonzero(valid[b, r0:r0 + R])[:, 0]
            for w0 in range(0, W, T):
                if min(32 * (w0 + T), K) - 1 <= r0:
                    continue
                for w in range(w0, min(w0 + T, W)):
                    j = 32 * w + lanes
                    jc = j.clamp(max=K - 1)
                    okc = (j < K) & valid[b, jc]
                    c = torch.where(okc[:, None], box[b, jc], empty)
                    ac = (c[:, 2] - c[:, 0]) * (c[:, 3] - c[:, 1])
                    i = rows[rows < 32 * w + 31]
                    a = box[b, i][:, None]
                    pair = j > i[:, None]
                    meet = pair & (a[..., 0] < c[:, 2]) & \
                        (c[:, 0] < a[..., 2]) & (a[..., 1] < c[:, 3]) & \
                        (c[:, 1] < a[..., 3])
                    wx = torch.fmin(a[..., 2], c[:, 2]) - \
                        torch.fmax(a[..., 0], c[:, 0])
                    wy = torch.fmin(a[..., 3], c[:, 3]) - \
                        torch.fmax(a[..., 1], c[:, 1])
                    inter = wx * wy
                    iou_hit = inter / (area[b, i][:, None] + ac - inter) > thr
                    hit = meet & torch.where(inter > 0, iou_hit, zero_hit)
                    if zero_hit:
                        hit |= okc & pair & ~meet
                    over[b, i, w] = (hit.long() << lanes).sum(1)
    return torch.where(over >= 2 ** 31, over - 2 ** 32, over).to(
        torch.int32)


def _standup_case(K, kind, seed):
    """[B, K, 4] xyxy boxes crowded on a square that grows with K (a third
    duplicated from others: IoU 1), one with a NaN x2, one with a NaN y1,
    two of zero area (one duplicated), 15% invalid (or all, for
    "invalid"); fp64 numpy, and valid [B, K]."""
    rng = np.random.default_rng(seed)
    B = 2
    side = 4.0 + 2.0 * np.sqrt(K)
    lo = rng.uniform(0, side, (B, K, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.5, 4.5, (B, K, 2))], -1)
    if K > 1:
        src = rng.integers(0, K, (B, K))
        dup = rng.uniform(size=(B, K)) < 0.3
        boxes = np.where(dup[..., None],
                         np.take_along_axis(boxes, src[..., None], 1), boxes)
    odd = {2: (2, np.nan), 5: (1, np.nan)}
    for i, (c, v) in odd.items():
        if i < K:
            boxes[:, i, c] = v
    if K > 8:
        boxes[:, 3, 2] = boxes[:, 3, 0]             # zero width
        boxes[:, 7] = boxes[:, 6]
        boxes[:, 6, 3] = boxes[:, 6, 1]             # zero height, and the
        boxes[:, 7, 3] = boxes[:, 7, 1]             # same box again
    valid = rng.uniform(size=(B, K)) < 0.85
    if kind == "invalid":
        valid[:] = False
    return boxes, valid


# K on either side of a word and of the tile's rows (32), two tiles' rows,
# and either side of the tile's columns (8 words, 256)
STANDUP_KS = [1, 31, 32, 33, 63, 64, 65, 255, 256, 257]
STANDUP_CASES = [(K, "crowded") for K in STANDUP_KS] + \
    [(33, "invalid"), (257, "invalid")]


# 0.7 as the two-stage proposals' NMS; 0, where every meeting pair is a
# bit; below 0, where every valid pair is one (its IoU is at least 0)
STANDUP_THRESHOLDS = (0.7, 0.0, -0.1)


def _jax_standup_bits(boxes, valid):
    """JAX's dense standup IoU, eager (one op at a time, as the port's
    plain version runs it), thresholded at each of STANDUP_THRESHOLDS,
    masked to the strict upper triangle of valid pairs, packed. The boxes
    are padded to the largest K of the cases, so that every case runs ops
    of one shape (a pair's IoU does not depend on the others)."""
    K = boxes.shape[1]
    pad = np.zeros((max(STANDUP_KS), 4), boxes.dtype)
    upper = np.triu(np.ones((K, K), bool), 1)
    ious = []
    for b in boxes:
        pad[:K] = b
        iou = np.asarray(jax_standup_iou(jnp.asarray(pad), jnp.asarray(pad)))
        ious.append(iou[:K, :K])
    pairs = upper & valid[:, :, None] & valid[:, None, :]
    return [riou.pack_bits(torch.from_numpy((np.stack(ious) > thr) & pairs))
            for thr in STANDUP_THRESHOLDS]


@pytest.mark.parametrize("K,kind", STANDUP_CASES)
@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
def test_standup_overlap_tiles_mirror(dtype, K, kind):
    """The kernel's order of work sets the plain version's bits and JAX's,
    at each of STANDUP_THRESHOLDS."""
    boxes, valid = _standup_case(K, kind, seed=K + 3 * len(kind))
    cand = torch.from_numpy(boxes).to(DTYPES[dtype])
    v = torch.from_numpy(valid)
    with jax.enable_x64(dtype == "fp64"):
        wants = _jax_standup_bits(cand.numpy(), valid)
    pairs = torch.ones(K, K, dtype=torch.bool).triu(1) & v[:, :, None] & \
        v[:, None, :]
    for thr, want in zip(STANDUP_THRESHOLDS, wants):
        got = standup_overlap_tiles_plain(cand, v, thr)
        assert got.dtype == torch.int32 and got.shape == (2, K,
                                                          (K + 31) // 32)
        assert torch.equal(got, riou.standup_overlap_plain(cand, v, thr))
        assert torch.equal(got, want)
        bits = riou.unpack_bits(got, K)
        if thr < 0:
            # the NaN and zero-area boxes too
            assert torch.equal(bits, pairs)
        elif kind == "invalid":
            assert not bits.any()
        elif K >= 33:
            assert bits.any()
            # the duplicates meet their sources at IoU 1; the NaN and
            # zero-area boxes meet nothing
            assert not bits[:, [2, 5]].any() and not bits[..., [2, 5]].any()
            if K > 8:
                assert not bits[:, [3, 6, 7]].any() and \
                    not bits[..., [3, 6, 7]].any()
