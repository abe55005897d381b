"""The plain mirrors of two kernels' orders of work, on the CPU.

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
dense, long chains (each row overlapping the next), all rows invalid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops.nms import _greedy_suppress_over as jax_greedy
from second_tpu.ops.roi_align_rotated import \
    roi_align_rotated as jax_roi_align
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
