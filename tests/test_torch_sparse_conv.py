"""The port's sparse convolution (`second_tpu_torch/ops/sparse_conv.py`)
against the JAX package's batch-native path on the same numpy-seeded active
sets: sorts, rulebooks (as exact (query, tap) → row maps), the gather-GEMM
kernel's plain version (against the fused Pallas kernel in interpret mode
and the XLA einsum apply), strided convs with capacity overflow, and
densify."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops import sparse_conv as jsp
from second_tpu_torch.ops import sparse_conv as sp
from second_tpu_torch.ops.cuda.subm import (gather_gemm, gather_gemm_plain,
                                            pack_weights, padded_widths)


def make_batch(rng, grid, cap, cin, B=2, fill=(0.4, 0.9)):
    """Unsorted numpy active sets: distinct sites per example, zero-padded
    invalid tail rows."""
    D, H, W = grid
    coords = np.zeros((B, cap, 3), np.int32)
    feats = np.zeros((B, cap, cin), np.float32)
    valid = np.zeros((B, cap), bool)
    for b in range(B):
        n = int(rng.integers(int(cap * fill[0]), int(cap * fill[1])))
        lin = rng.choice(D * H * W, size=n, replace=False)
        coords[b, :n] = np.stack([lin // (H * W), (lin // W) % H, lin % W], 1)
        feats[b, :n] = rng.normal(0, 1, (n, cin))
        valid[b, :n] = True
    return coords, feats, valid


def sorted_pair(coords, feats, valid, grid):
    """The same active sets sorted by the JAX package and by the port."""
    j = jax.vmap(lambda c, f, v: jsp.sort_active(c, f, v, grid))(
        jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid))
    t = sp.sort_active(torch.from_numpy(coords), torch.from_numpy(feats),
                       torch.from_numpy(valid), grid)
    return j, t


def assert_same_taps(jrb, tap_idx, found):
    """A JAX tap-form rulebook and the port's agree as (b, k, q) → row."""
    tag, jidx, jfound = jrb
    assert tag == "tap"
    jfound = np.asarray(jfound)
    np.testing.assert_array_equal(found.numpy(), jfound)
    np.testing.assert_array_equal(tap_idx.numpy()[jfound],
                                  np.asarray(jidx)[jfound])


GRID = (6, 12, 10)


def test_sort_active_matches_jax():
    rng = np.random.default_rng(0)
    coords, feats, valid = make_batch(rng, GRID, 64, 3, B=3)
    j, t = sorted_pair(coords, feats, valid, GRID)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("cap", [64, 512])
def test_subm_rulebook_matches_jax(cap):
    rng = np.random.default_rng(1)
    grid = (8, 16, 16) if cap > 64 else GRID
    coords, feats, valid = make_batch(rng, grid, cap, 2)
    (jc, _, jv, jk), (tc, _, tv, tk) = sorted_pair(coords, feats, valid, grid)
    jrb = jsp.subm_rulebook_b(jc, jk, jv, grid)
    tap_idx, found = sp.subm_rulebook_b(tc, tk, tv, grid)
    assert found.shape == (2, 27, cap) and found.any()
    assert_same_taps(jrb, tap_idx, found)


@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
])
def test_strided_rulebook_matches_jax(kernel, stride, padding):
    rng = np.random.default_rng(2)
    coords, feats, valid = make_batch(rng, GRID, 96, 2)
    (jc, _, jv, jk), (tc, _, tv, tk) = sorted_pair(coords, feats, valid, GRID)
    cap = 96
    joc, jov, jok, jnu, jog = jsp._gen_output_sites_b(
        jc, jv, GRID, kernel, stride, padding, cap)
    toc, tov, tok, tog, tnu = sp.downsample_coords_b(
        tc, tv, GRID, kernel, stride, padding, cap)
    assert tog == jog
    for a, b in ((joc, toc), (jov, tov), (jok, tok), (jnu, tnu)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    base_j = joc * np.array(stride, np.int32) - np.array(padding, np.int32)
    jrb = jsp.build_rulebook_b(jk, base_j, jov, GRID, kernel)
    base_t = toc * torch.tensor(stride, dtype=torch.int32) - \
        torch.tensor(padding, dtype=torch.int32)
    tap_idx, found = sp.build_rulebook_b(tk, base_t, tov, GRID, kernel)
    assert_same_taps(jrb, tap_idx, found)


def test_gather_gemm_plain_matches_fused_pallas_interpret(monkeypatch):
    """The plain version of the gather-GEMM kernel against the fused Pallas
    kernel on the window rulebook the JAX package builds, converted to the
    port's per-tap form. fp32, atol 1e-4 (sums in another order)."""
    from second_tpu.ops.pallas.subm import subm_conv3d_fused_pallas
    rng = np.random.default_rng(3)
    coords, feats, valid = make_batch(rng, GRID, 64, 5)
    (jc, jf, jv, jk), _ = sorted_pair(coords, feats, valid, GRID)
    monkeypatch.setattr(jsp, "TAP_APPLY", False)
    tag, safe, sel = jsp.subm_rulebook_b(jc, jk, jv, GRID)
    assert tag == "win"
    w = rng.normal(0, 0.3, (27, 5, 7)).astype(np.float32)
    want = subm_conv3d_fused_pallas(jf, safe, sel, jnp.asarray(w),
                                    rows_per_tile=16, interpret=True)
    tap_idx, found = jsp.window_to_taps_rulebook(safe, sel)
    got = gather_gemm(torch.from_numpy(np.array(jf)),
                      torch.from_numpy(np.array(tap_idx)),
                      torch.from_numpy(np.array(found)),
                      torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 32), (32, 64)])
def test_subm_conv_matches_jax(cin, cout):
    rng = np.random.default_rng(4)
    grid = (8, 16, 16)
    coords, feats, valid = make_batch(rng, grid, 512, cin)
    (jc, jf, jv, jk), (tc, tf, tv, tk) = sorted_pair(coords, feats, valid,
                                                     grid)
    w = rng.normal(0, 1 / np.sqrt(27 * cin), (27, cin, cout)
                   ).astype(np.float32)
    want = jsp.subm_conv3d_b(jf, jc, jk, jv, grid, jnp.asarray(w))
    got = sp.subm_conv3d_b(tf, tc, tk, tv, grid, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_strided_conv_over_capacity_matches_jax():
    """out_cap < n_unique: the rank-stratified subset of output sites, with
    coords, keys, valid and n_unique exact."""
    rng = np.random.default_rng(5)
    grid = (8, 16, 16)
    coords, feats, valid = make_batch(rng, grid, 256, 8, fill=(0.8, 0.95))
    (jc, jf, jv, jk), (tc, tf, tv, tk) = sorted_pair(coords, feats, valid,
                                                     grid)
    w = rng.normal(0, 0.1, (27, 8, 16)).astype(np.float32)
    args = ((3, 3, 3), (2, 2, 2), (1, 1, 1), 48)
    want = jsp.sparse_conv3d_b(jf, jc, jk, jv, grid, jnp.asarray(w), *args)
    got = sp.sparse_conv3d_b(tf, tc, tk, tv, grid, torch.from_numpy(w), *args)
    assert (got[5] > 48).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4)
    for i in (1, 2, 3, 5):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert got[4] == tuple(want[4])


def test_gather_gemm_plain_bf16_sums_in_fp32():
    """bf16 features and weights: products and sums are fp32, so the result
    equals the fp32 product of the bf16-rounded inputs."""
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.normal(0, 1, (2, 40, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.2, (27, 16, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (2, 27, 30)).astype(np.int32))
    found = torch.from_numpy(rng.uniform(size=(2, 27, 30)) > 0.5)
    got = gather_gemm_plain(f.bfloat16(), idx, found, w)
    want = gather_gemm_plain(f.bfloat16().float(), idx, found,
                             w.bfloat16().float())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("C,D", [(4, 16), (5, 7), (16, 32), (33, 9),
                                 (64, 64)])
def test_pack_weights_round_trips(C, D):
    """The tensor-core kernel's weight layout: [K, C, D] zero-padded to
    [K, CP, DP] and walked as [K*CP, DP] rows, tap k's channels at rows
    k*CP .. k*CP + C - 1; the unpadded corner gives the weights back, and at
    the main path's widths packing copies nothing."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.normal(size=(27, C, D)).astype(np.float32)
                         ).bfloat16()
    CP, DP = padded_widths(C, D)
    assert CP in (4, 8, 16, 32, 64) and C <= CP < max(2 * C, 5)
    assert DP % 8 == 0 and D <= DP < D + 8
    packed = pack_weights(w, CP, DP)
    assert packed.shape == (27, CP, DP) and packed.is_contiguous()
    assert torch.equal(packed[:, :C, :D], w)
    rows = packed.reshape(27 * CP, DP)
    for k in (0, 13, 26):
        assert torch.equal(rows[k * CP:k * CP + C, :D], w[k])
    assert not packed[:, C:].any() and not packed[:, :, D:].any()
    if (C, D) == (CP, DP):
        assert packed.data_ptr() == w.data_ptr()


def test_densify_matches_jax():
    rng = np.random.default_rng(7)
    coords, feats, valid = make_batch(rng, GRID, 64, 3)
    want = jax.vmap(lambda f, c, v: jsp.densify(f, c, v, GRID))(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid))
    got = sp.densify_b(torch.from_numpy(feats), torch.from_numpy(coords),
                       torch.from_numpy(valid), GRID)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
