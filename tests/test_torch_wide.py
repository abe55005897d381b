"""Sparse convs of any width and JAX's single-example sparse functions, on
the CPU: the port's packed widths past 64 channels (a multiple of 64) and
the weight gradient's scratch budget; a 256 -> 256 submanifold conv's
gradients (autograd through the port's `subm_conv3d_b`, the kernels'
backward in their plain versions) against JAX's jitted fp64 VJP of its
`subm_conv3d_b`; and the single-example functions (`lookup`,
`subm_rulebook`, `subm_conv3d` with 27 and 125 taps, `downsample_coords`,
`sparse_conv3d`, `sparse_max_pool3d`, `densify`, `voxelize_batch`) against
JAX's, jitted, on the same numpy-seeded inputs: integer outputs exactly,
fp32 features within 1e-4 (`TOL`, as the model tests')."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops import sparse_conv as jsp
from second_tpu.ops import voxelize as jvox
from second_tpu_torch.ops import sparse_conv as sp
from second_tpu_torch.ops import voxelize as tvox
from second_tpu_torch.ops.cuda import subm

from test_torch_model import TOL
from test_torch_sparse_conv import GRID, make_batch, sorted_pair
from test_torch_temporal import one_thread

# the port's fp64 gradients against JAX's fp64 VJP, of each tensor's
# largest entry: the same fp64 products summed in another order
GRAD64_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("C", [65, 96, 128, 129, 136, 200, 256, 320, 384,
                               512])
def test_packed_widths_past_64(C):
    """Past 64 input channels the kernels' packed width is the next
    multiple of 64 (at most 128: the power of two it was), so a 64-column
    bf16 stage or a 32-column fp32 stage lies within one tap; the weights
    pack to it and back."""
    CP, DP = subm.padded_widths(C, 40)
    assert CP % 64 == 0 and C <= CP < C + 64 and DP == 40
    if C <= 128:
        assert CP == 128
    w = torch.from_numpy(np.random.default_rng(C).normal(
        size=(3, C, 40)).astype(np.float32))
    packed = subm.pack_weights(w, CP, DP)
    assert packed.shape == (3, CP, DP)
    assert torch.equal(packed[:, :C], w) and not packed[:, C:].any()


def test_wgrad_scratch_budget():
    """The weight gradient's chunks a tap: WGRAD_MAX_CHUNKS wherever the
    partials fit WGRAD_SCRATCH_BYTES (every call of the repo's configs, so
    their sums keep their order), fewer past it; `wgrad_plan` shares the
    blocks over (tap, tile) pairs up to 128 channels and over the taps past
    it; the partials of the chunks a call takes on a 132-SM card stay
    within the budget at any width."""
    budget = subm.WGRAD_SCRATCH_BYTES
    for K, C, D in ((27, 16, 16), (27, 64, 64), (27, 128, 128), (3, 128, 128),
                    (125, 64, 64)):
        assert subm.wgrad_max_chunks(K, C, D) == subm.WGRAD_MAX_CHUNKS
    assert subm.wgrad_max_chunks(27, 1024, 1024) == 2
    assert subm.wgrad_max_chunks(27, 2048, 2048) == 1
    for K, C, D, M in ((27, 128, 128, 160_000), (27, 256, 256, 160_000),
                       (27, 256, 16, 64_000), (27, 512, 512, 160_000),
                       (3, 512, 512, 160_000), (1, 1024, 512, 10 ** 6),
                       (125, 256, 256, 64_000)):
        tiles = subm.wgrad_tiles(C, D)
        _, chunks = subm.wgrad_plan(M, K, C, D, 132)
        # up to 128 channels the blocks are shared over (tap, tile) pairs,
        # past it over the taps
        assert chunks == subm.wgrad_chunks(
            M, K * tiles if max(C, D) <= 128 else K, 132,
            subm.wgrad_max_chunks(K, C, D))[1]
        groups = -(-chunks // subm.WGRAD_GROUP)
        scratch = 4 * K * C * D * ((chunks > 1) * chunks + (groups > 1) *
                                   groups)
        assert scratch <= budget, (K, C, D, chunks)


def test_conv_256_grads_match_jax_fp64():
    """A 256 -> 256 submanifold conv on a small active set: dX (the
    gather-GEMM's plain version on the transposed rulebook, D = 256 in)
    and dW (the weight gradient's plain version) by autograd through the
    port's `subm_conv3d_b` in fp64, against JAX's jitted fp64 VJP of its
    `subm_conv3d_b` (x64 on, `jnp.float32` read as fp64 while traced: the
    JAX package pins the conv's sums to fp32), within GRAD64_TOL of each
    tensor's largest entry."""
    rng = np.random.default_rng(40)
    coords, feats, valid = make_batch(rng, GRID, 64, 256)
    (jc, jf, jv, jk), (tc, tf, tv, tk) = sorted_pair(coords, feats, valid,
                                                     GRID)
    w = rng.normal(0, 1 / 80, (27, 256, 256))
    cot = rng.normal(0, 1, (2, 64, 256))
    x = np.asarray(jf, np.float64)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jnp, "float32", jnp.float64)

        def loss(f, wt):
            out = jsp.subm_conv3d_b(f, jc, jk, jv, GRID, wt)
            return (out * cot).sum()
        jgx, jgw = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(x), jnp.asarray(w))
        assert jgw.dtype == jnp.float64
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = sp.subm_conv3d_b(xt, tc, tk, tv, GRID, wt)
    assert out.dtype == torch.float64
    (out * torch.from_numpy(cot)).sum().backward()
    for got, want in ((xt.grad, jgx), (wt.grad, jgw)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD64_TOL * scale)


# ---------------------------------------------- single-example functions


def _one(seed, cin=8, cap=64, grid=GRID):
    """One example's active set, sorted by JAX and by the port: (JAX's
    coords, features, valid, keys), (the port's)."""
    coords, feats, valid = make_batch(np.random.default_rng(seed), grid, cap,
                                      cin, B=1)
    j, t = sorted_pair(coords, feats, valid, grid)
    return tuple(a[0] for a in j), tuple(a[0] for a in t)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("seed", [0])
def test_lookup_matches_jax(seed):
    """Keys of the active set, keys absent from it, the sentinel and keys
    past it, some queries invalid: the clamped row and the hit exactly."""
    (_, _, _, jk), (_, _, _, tk) = _one(seed)
    rng = np.random.default_rng(seed + 10)
    sen = sp.sentinel(GRID)
    q = np.concatenate([np.asarray(jk)[rng.integers(0, 64, 40)],
                        rng.integers(0, sen + 50, 60)]).astype(np.int32)
    qv = rng.random(q.shape[0]) < 0.8
    jidx, jfound = jax.jit(jsp.lookup)(jk, jnp.asarray(q), jnp.asarray(qv))
    idx, found = sp.lookup(tk, torch.from_numpy(q), torch.from_numpy(qv))
    assert idx.dtype == torch.int32 and found.any()
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_array_equal(found.numpy(), _np(jfound))


@pytest.mark.parametrize("k", [3, 5])
def test_subm_rulebook_and_conv_match_jax(k):
    """`subm_rulebook` (the port's per-tap form, against JAX's window
    rulebook read back per tap) exactly, and `subm_conv3d` with K = k³
    taps (125 at k = 5; JAX's given its rulebook), with and without the
    prebuilt rulebook, within TOL of JAX's."""
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _one(20 + k, cin=12)
    K = k ** 3
    w = np.random.default_rng(k).normal(0, 1 / np.sqrt(K * 12),
                                        (K, 12, 20)).astype(np.float32)
    safe, sel = jax.jit(partial(jsp.subm_rulebook, grid_dhw=GRID,
                                kernel_size=(k, k, k)))(jc, jk, jv)
    jidx, jfound = jsp.window_to_taps_rulebook(safe[None], sel[None])
    tap_idx, found = sp.subm_rulebook(tc, tk, tv, GRID, (k, k, k))
    assert found.shape == (K, 64) and found.any()
    np.testing.assert_array_equal(found.numpy(), _np(jfound)[0])
    np.testing.assert_array_equal(tap_idx.numpy()[found.numpy()],
                                  _np(jidx)[0][_np(jfound)[0]])
    want = jax.jit(partial(jsp.subm_conv3d, grid_dhw=GRID))(
        jf, jc, jk, jv, weights=jnp.asarray(w), rulebook=(safe, sel))
    wt = torch.from_numpy(w)
    got = sp.subm_conv3d(tf, tc, tk, tv, GRID, wt)
    again = sp.subm_conv3d(tf, tc, tk, tv, GRID, wt,
                           rulebook=(tap_idx, found))
    assert got.shape == (64, 20)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert torch.equal(got, again)


@pytest.mark.parametrize("cap", [20])
def test_downsample_and_sparse_conv3d_match_jax(cap):
    """`downsample_coords` (sites, validity, keys, grid and the unique
    count exactly; over capacity, the rank-stratified cut) and
    `sparse_conv3d` with and without `precomputed`, within TOL."""
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _one(30, cin=6)
    kern, stride, pad = (3, 3, 3), (2, 2, 2), (1, 1, 1)
    w = np.random.default_rng(31).normal(0, 0.2, (27, 6, 10)).astype(
        np.float32)
    jds = jax.jit(partial(jsp.downsample_coords, grid_dhw=GRID,
                          kernel_size=kern, stride=stride, padding=pad,
                          out_cap=cap))(jc, jv)
    tds = sp.downsample_coords(tc, tv, GRID, kern, stride, pad, cap)
    assert tds[3] == jds[3] and int(tds[4]) > cap
    for a, b in zip(jds[:3] + jds[4:], tds[:3] + tds[4:]):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    want = jax.jit(partial(jsp.sparse_conv3d, grid_dhw=GRID,
                           kernel_size=kern, stride=stride, padding=pad,
                           out_cap=cap))(jf, jc, jk, jv,
                                         weights=jnp.asarray(w))
    for pre in (None, tds):
        got = sp.sparse_conv3d(tf, tc, tk, tv, GRID, torch.from_numpy(w),
                               kern, stride, pad, cap, precomputed=pre)
        np.testing.assert_allclose(got[0].numpy(), _np(want[0]), **TOL)
        for a, b in zip((want[1], want[2], want[3], want[5]),
                        (got[1], got[2], got[3], got[5])):
            np.testing.assert_array_equal(b.numpy(), _np(a))
        assert got[4] == want[4]


@pytest.mark.parametrize("kern,stride,pad", [
    ((2, 2, 2), None, (0, 0, 0)), ((3, 3, 3), (2, 2, 2), (1, 1, 1))])
def test_sparse_max_pool3d_matches_jax(kern, stride, pad):
    """`sparse_max_pool3d`, stride the kernel and a strided, padded pool:
    the pooled features exactly (a max picks one of the inputs), the sites
    and counts exactly."""
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _one(50, cin=5)
    want = jax.jit(partial(jsp.sparse_max_pool3d, grid_dhw=GRID,
                           kernel_size=kern, out_cap=48, stride=stride,
                           padding=pad))(jf, jc, jk, jv)
    got = sp.sparse_max_pool3d(tf, tc, tk, tv, GRID, kern, 48, stride, pad)
    assert got[4] == want[4]
    for a, b in zip(want[:4] + want[5:], got[:4] + got[5:]):
        np.testing.assert_array_equal(b.numpy(), _np(a))


def test_densify_single_matches_jax():
    """`densify` of one example (its `batch_idx` taken and unused, as
    JAX's) exactly."""
    (jc, jf, jv, _), (tc, tf, tv, _) = _one(60, cin=3)
    want = jax.jit(partial(jsp.densify, grid_dhw=GRID))(jf, jc, jv)
    got = sp.densify(tf, tc, tv, GRID, batch_idx=0)
    assert got.shape == GRID + (3,)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("shuffle", [False, True])
def test_voxelize_batch_matches_jax(shuffle):
    """`voxelize_batch` (JAX's vmap of `voxelize`) on three padded clouds,
    one over the voxel capacity: every output exactly."""
    rng = np.random.default_rng(70 + shuffle)
    pts = rng.uniform([0, -4, -2, 0], [8, 4, 2, 1], (3, 400, 4)).astype(
        np.float32)
    mask = rng.random((3, 400)) < 0.9
    kw = dict(voxel_size=(0.5, 0.5, 1.0),
              point_cloud_range=(0.0, -4.0, -2.0, 8.0, 4.0, 2.0),
              max_points=4, max_voxels=150, shuffle_overflow=shuffle)
    want = jax.jit(partial(jvox.voxelize_batch, **kw))(jnp.asarray(pts),
                                                       jnp.asarray(mask))
    got = tvox.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(mask),
                              **kw)
    assert int(got["voxel_overflow"].max()) > 0
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), _np(want[key]),
                                      err_msg=key)
