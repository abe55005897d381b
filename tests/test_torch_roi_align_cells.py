"""The rotated ROI-align backward's bookkeeping on the CPU:
`roi_align_bwd_cells_plain` (one key a sample, its cell; partial sums per
(cell, corner); each pixel's fixed-order sum of the partials whose corner
it is), the plain mirror of the backward kernel, against autograd of the
plain version (`roi_align_backward_plain`) and against `jax.grad` of JAX's
`roi_align_rotated` (the map's gradient) and `bilinear_sample` (the
coordinates' gradient, on the port's sample points), in fp32 and fp64, on
random, edge-straddling, far-off, degenerate (zero-sized rois piling their
samples on one cell) and non-finite rois; and its counts of in-map samples
and cell runs against a direct count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops.roi_align_rotated import bilinear_sample as jax_bilinear
from second_tpu.ops.roi_align_rotated import \
    roi_align_rotated as jax_roi_align
from second_tpu_torch.ops.cuda import roi_align as ra
from second_tpu_torch.ops.roi_align_rotated import sample_points

# of each gradient's scale: sums of the same products in another order
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KINDS = ["random", "edge", "far", "degenerate", "nonfinite"]


def _rois(rng, B, N, H, W, kind):
    """[B, N, 5] rois (cx, cy, w, l, yaw) in pixels over an H x W map."""
    rois = np.stack([rng.uniform(0, W, (B, N)), rng.uniform(0, H, (B, N)),
                     rng.uniform(1, 12, (B, N)), rng.uniform(1, 12, (B, N)),
                     rng.uniform(-np.pi, np.pi, (B, N))], -1)
    if kind == "edge":
        rois[:, ::2, 0] = rng.uniform(-3, 3, (B, N))[:, ::2]
        rois[:, 1::2, 1] = H + rng.uniform(-3, 3, (B, N))[:, 1::2]
    elif kind == "far":
        rois[:, ::3, 0] = 5000.0
        rois[:, 1::3, 1] = -7000.5
    elif kind == "degenerate":
        # zero width or length, and a pile: many zero-sized rois on one
        # point, so one cell holds thousands of samples
        rois[:, ::2, 2] = 0.0
        rois[:, 1::2, 3] = 0.0
        rois[:, N // 2:, :4] = (W / 2 + 0.25, H / 2 + 0.75, 0.0, 0.0)
    elif kind == "nonfinite":
        rois[:, 0, 0] = np.nan
        rois[:, 1, 1] = np.inf
    return rois


def _case(kind, dtype, B=2, N=12, C=6, H=20, W=17, seed=0):
    rng = np.random.default_rng(seed + KINDS.index(kind))
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    feat = rng.normal(0, 1, (B, C, H, W)).astype(np_dt)
    rois = _rois(rng, B, N, H, W, kind).astype(np_dt)
    grad = rng.normal(0, 1, (B * N, C, 14, 14)).astype(np_dt)
    return feat, rois, grad


def _scaled_err(got, want):
    """The largest error over the finite entries of `want`, over its
    largest |entry|; the non-finite entries must sit where want's do."""
    got, want = torch.as_tensor(got), torch.as_tensor(np.array(want))
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    if not fin.any():
        return 0.0
    err = (got.double() - want.double())[fin].abs().max().item()
    return err / max(want[fin].abs().max().item(), 1e-300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_cells_mirror_matches_autograd_of_plain(kind, dtype):
    """The mirror's map and coordinates' gradients against autograd of the
    plain version on the same sample points, within TOL of their scale
    (non-finite entries in the same places); its counts against a direct
    count of the in-map samples and their distinct cells."""
    feat, rois, grad = _case(kind, dtype)
    B, C, H, W = feat.shape
    f, g = torch.from_numpy(feat), torch.from_numpy(grad)
    coords = sample_points(torch.from_numpy(rois)).view(B, -1, 28, 28, 2)
    gf, gc, (n_in, runs) = ra.roi_align_bwd_cells_plain(f, coords, g, 2)
    wf, wc = ra.roi_align_backward_plain(f, coords, g, 2)
    assert gf.dtype == gc.dtype == dtype and gf.shape == f.shape
    assert _scaled_err(gf, wf) <= TOL[dtype]
    assert _scaled_err(gc, wc) <= TOL[dtype]
    x0, y0 = torch.floor(coords[..., 0]), torch.floor(coords[..., 1])
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    b = torch.arange(B).view(B, 1, 1, 1).expand_as(x0)
    cells = torch.stack([b[inside], y0[inside].long(), x0[inside].long()])
    assert n_in == int(inside.sum())
    assert runs == int(torch.unique(cells, dim=1).shape[1])
    if kind == "far":
        assert n_in < inside.numel()
    if kind == "degenerate":
        # the pile: the cell under the zero-sized rois holds all their
        # samples
        keys, _ = ra.sample_cells(coords, H, W)
        assert torch.bincount(keys).max() >= (rois.shape[1] // 2) * 784


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_cells_mirror_matches_jax_grad(kind, dtype):
    """The mirror against `jax.grad` of a weighted sum of JAX's crops, one
    example at a time: the map's gradient through JAX's `roi_align_rotated`
    from the same rois, and the coordinates' gradient through JAX's
    `bilinear_sample` on the port's sample points (the bins' gradients
    spread over their s x s samples), within TOL of their scale; fp64
    under x64. JAX turns a non-finite coordinate into a clipped index and
    reads the map there (NaN times its weight); the port reads nothing, so
    a non-finite roi adds nothing to the port's map gradient: JAX's is
    taken over the finite rois, and the coordinates' over finite points."""
    feat, rois, grad = _case(kind, dtype, seed=10)
    B, C, H, W = feat.shape
    N = rois.shape[1]
    f, g = torch.from_numpy(feat), torch.from_numpy(grad)
    coords = sample_points(torch.from_numpy(rois)).view(B, N, 28, 28, 2)
    gf, gc, _ = ra.roi_align_bwd_cells_plain(f, coords, g, 2)
    with jax.enable_x64(dtype == torch.float64):
        for b in range(B):
            fb = jnp.asarray(feat[b].transpose(1, 2, 0))       # [H, W, C]
            wb = jnp.asarray(grad[b * N:(b + 1) * N].transpose(0, 2, 3, 1))
            ok = np.isfinite(rois[b]).all(-1)
            jf = jax.grad(lambda m: (jax_roi_align(
                m, jnp.asarray(rois[b][ok]), (14, 14), 2) *
                wb[ok]).sum())(fb)
            assert _scaled_err(gf[b].permute(1, 2, 0),
                               np.asarray(jf)) <= TOL[dtype]
            pts = coords[b].numpy()
            ws = jnp.repeat(jnp.repeat(wb, 2, 1), 2, 2) / 4
            jx, jy = jax.grad(lambda x, y: (jax_bilinear(fb, x, y) *
                                            ws).sum(), argnums=(0, 1))(
                jnp.asarray(pts[..., 0]), jnp.asarray(pts[..., 1]))
            fin = np.isfinite(pts).all(-1)           # JAX's NaN paths differ
            for i, j in enumerate((jx, jy)):
                got = gc[b][..., i][torch.from_numpy(fin)]
                assert _scaled_err(got, np.asarray(j)[fin]) <= TOL[dtype]
