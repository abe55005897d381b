"""Soft-NMS in the port against the JAX package's, on the CPU: `soft_nms`
(gaussian and linear, rotated and standup, one example and a batch of rows,
a pair cap that binds), its sparse rotated-IoU matrix and pair list, the
port's host oracle (`core/nms_np.py`), and the decay steps' plain version
(`soft_nms_decay_plain`, what the CUDA kernel is held to on the card)
against a step-by-step numpy loop. The pair-list decay's plain version
(`soft_nms_decay_pairs_plain`, rotated soft-NMS's path) bit for bit the
dense one on the same pairs, its pair values' edge cases (negative and NaN
IoU, slots that are not ok), and a numpy mirror of its kernel's walk
(`_walk_mirror`: per-warp slot maxima carried over, only the pick's
neighbours decayed, non-finite scores swept a step later) against it.
The standup decay (`soft_nms_decay_standup`, standup soft-NMS's path,
whose kernel computes the pick's IoU row from the boxes): a numpy mirror of
the kernel's IoU bit for bit `standup_iou_matrix`'s rows, edge boxes
included, and its plain version's steps against JAX's `lax.scan` on JAX's
own standup matrix, NaN scores and NaN IoU values included.

JAX's functions run jitted (eagerly, the decay scan runs op by op). The
tolerances: picks, keep masks and pair lists exact; the rescored scores
within 1e-6 relative where both sides decay by the same IoU values (the
standup matrix, or JAX's own rotated matrix fed to the port's decay);
the rotated IoU matrices equal where either is 0 and within 1e-5
elsewhere, and the scores rescored by them within 1e-5 relative: XLA's and
torch's fp32 sin and cos put the box corners one ulp apart (9.5e-7 at
coordinates of 20 m), and the clip turns that into IoU values up to
2.6e-6 apart on these boxes (3.1e-6 relative in a score decayed some 15
times), the bound `tests/test_torch_ops.py` holds the rotated IoU to; the
fp64 oracle within 1e-4 relative, as `tests/test_round2_parity.py` holds
JAX's to it.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops import nms as jax_nms
from second_tpu.ops.rotated_iou import rbbox_to_corners as jax_corners
from second_tpu_torch.core.nms_np import soft_nms as soft_nms_np
from second_tpu_torch.ops.cuda.riou import (
    pair_matrix, soft_nms_decay_pairs,
    soft_nms_decay_pairs_plain, soft_nms_decay_plain,
    soft_nms_decay_standup, soft_nms_decay_standup_plain)
from second_tpu_torch.ops.nms import (pair_iou, soft_nms, soft_nms_pairs,
                                      sparse_rotated_iou_matrix, top_k)
from second_tpu_torch.ops.rotated_iou import standup_iou_matrix

SCORE_RTOL = 1e-6
ROTATED_SCORE_RTOL = 1e-5
IOU_ATOL = 1e-5
ORACLE_RTOL = 1e-4


def _boxes(rng, n, rotated=True, spread=20.0, size=(2.0, 5.0)):
    """n boxes in a few clusters, so that many pairs overlap."""
    centers = rng.uniform(0, spread, (max(n // 6, 1), 2))
    xy = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 1.0,
                                                                (n, 2))
    wl = rng.uniform(*size, (n, 2))
    if rotated:
        yaw = rng.uniform(-np.pi, np.pi, (n, 1))
        return np.concatenate([xy, wl, yaw], 1).astype(np.float32)
    return np.concatenate([xy - wl / 2, xy + wl / 2], 1).astype(np.float32)


def _inputs(seed, rows, n, rotated):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes(rng, n, rotated) for _ in range(rows)])
    scores = rng.uniform(0.05, 1.0, (rows, n)).astype(np.float32)
    valid = rng.uniform(size=(rows, n)) < 0.85
    return boxes, scores, valid


@partial(jax.jit, static_argnames=("kw",))
def _jax_soft_nms(boxes, scores, valid, kw):
    fn = partial(jax_nms.soft_nms, **dict(kw))
    return jax.vmap(fn)(boxes, scores, valid)


def _jax_run(boxes, scores, valid, **kw):
    out = _jax_soft_nms(jnp.asarray(boxes), jnp.asarray(scores),
                        jnp.asarray(valid), tuple(sorted(kw.items())))
    return [np.asarray(o) for o in out]


def _port_run(boxes, scores, valid, **kw):
    out = soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), **kw)
    return [o.numpy() for o in out]


def _assert_same(port, ref, rtol=SCORE_RTOL):
    (idx, rescored, keep), (jidx, jrescored, jkeep) = port, ref
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(rescored, jrescored, rtol=rtol, atol=0)


@pytest.mark.parametrize("rows", [1, 3], ids=["one", "batch"])
@pytest.mark.parametrize("rotated", [True, False],
                         ids=["rotated", "standup"])
@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_matches_jax(method, rotated, rows):
    """Picks, keep and the rescored scores against JAX's `soft_nms`
    (`jax.vmap` of it over the rows): 64 boxes a row, 15% invalid, the top
    48 as candidates, 40 steps, the score threshold among the decayed
    scores."""
    boxes, scores, valid = _inputs(7, rows, 64, rotated)
    kw = dict(pre_max_size=48, post_max_size=40, sigma=0.5,
              iou_threshold=0.3, score_threshold=0.4, method=method,
              rotated=rotated)
    ref = _jax_run(boxes, scores, valid, **kw)
    if rows == 1:
        port = _port_run(boxes[0], scores[0], valid[0], **kw)
        port = [p[None] for p in port]
    else:
        port = _port_run(boxes, scores, valid, **kw)
    _assert_same(port, ref, ROTATED_SCORE_RTOL if rotated else SCORE_RTOL)
    # the case is not trivial: scores decayed, some dropped by the threshold
    assert ref[2].any() and not ref[2].all()
    picked = np.take_along_axis(scores, ref[0], 1)
    assert (ref[1][ref[2]] < picked[ref[2]]).any()


def _jax_pair_list(cand, valid, max_pairs, min_bound=0.0):
    """The pair list of JAX's `_sparse_rotated_iou_matrix`
    (second_tpu/ops/nms.py:127-146): its own operations on its own
    corners, returned as (plist, pair_ok)."""
    K = cand.shape[0]
    corners = jax_corners(cand)
    standup = jnp.concatenate([corners.min(-2), corners.max(-2)], -1)
    lt = jnp.maximum(standup[:, None, :2], standup[None, :, :2])
    rb = jnp.minimum(standup[:, None, 2:], standup[None, :, 2:])
    wh = jnp.maximum(rb - lt, 0.0)
    inter_st = wh[..., 0] * wh[..., 1]
    areas = cand[:, 2] * cand[:, 3]
    asum = areas[:, None] + areas[None, :]
    bound = inter_st / jnp.maximum(asum - inter_st, 1e-12)
    upper = jnp.triu(jnp.ones((K, K), bool), k=1)
    maybe = (bound > min_bound) & upper & valid[:, None] & valid[None, :]
    flat = maybe.reshape(-1)
    pos = jnp.cumsum(flat) - 1
    lin = jnp.arange(K * K, dtype=jnp.int32)
    scatter_to = jnp.where(flat & (pos < max_pairs), pos, max_pairs)
    plist = jnp.zeros((max_pairs,), jnp.int32).at[scatter_to].set(
        lin, mode="drop")
    pair_n = jnp.minimum(flat.sum(), max_pairs)
    return plist, jnp.arange(max_pairs) < pair_n, flat.sum()


@pytest.mark.parametrize("max_pairs", [4096, 96], ids=["all", "capped"])
def test_sparse_iou_matrix_and_pairs_match_jax(max_pairs):
    """The pair list exactly JAX's (capped and not), and the sparse IoU
    matrix JAX's `_sparse_rotated_iou_matrix`: 0 at the same entries (the
    pairs past the cap too), within IOU_ATOL elsewhere; one example and a
    batch of two."""
    boxes, _, valid = _inputs(3, 2, 64, True)
    jpairs = jax.jit(_jax_pair_list, static_argnums=2)
    jmatrix = jax.jit(jax_nms._sparse_rotated_iou_matrix, static_argnums=2)
    plist, ok = soft_nms_pairs(torch.from_numpy(boxes),
                               torch.from_numpy(valid), max_pairs)
    got = sparse_rotated_iou_matrix(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), max_pairs)
    for b in range(2):
        jplist, jok, total = jpairs(jnp.asarray(boxes[b]),
                                    jnp.asarray(valid[b]), max_pairs)
        np.testing.assert_array_equal(plist[b].numpy(), np.asarray(jplist))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jok))
        if max_pairs < 4096:
            assert int(total) > max_pairs, "the cap does not bind"
        ref = np.asarray(jmatrix(jnp.asarray(boxes[b]),
                                 jnp.asarray(valid[b]), max_pairs))
        one = sparse_rotated_iou_matrix(torch.from_numpy(boxes[b]),
                                        torch.from_numpy(valid[b]),
                                        max_pairs).numpy()
        for mat in (got[b].numpy(), one):
            np.testing.assert_array_equal(mat == 0, ref == 0)
            np.testing.assert_allclose(mat, ref, rtol=0, atol=IOU_ATOL)
        assert (ref > 0).sum() > 20


def test_pair_iou_denominator_is_jaxs_bit_for_bit():
    """`riou_pairs`' criterion -1 (`iou_from_inter`, what the plain version
    and the kernel compute) against JAX's expression in
    `_sparse_rotated_iou_matrix`, inter / max(a_i + a_j - inter, 1e-12)
    with a = w · l, on the same intersections and boxes, run op by op: bit
    for bit, touching and zero-area boxes included. (XLA's jit of the
    expression fuses it and rounds 14% of these values 1-2 ulp apart.)"""
    from second_tpu_torch.ops.rotated_iou import iou_from_inter
    rng = np.random.default_rng(2)
    n = 4096
    boxes = np.concatenate([rng.uniform(-40, 40, (n, 2)),
                            rng.uniform(0, 6, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))],
                           1).astype(np.float32)
    boxes[:8, 2] = 0.0                          # zero-area boxes
    pi, pj = rng.integers(0, n, n), rng.integers(0, n, n)
    areas = boxes[:, 2] * boxes[:, 3]
    inter = (rng.uniform(0, 1, n) * np.minimum(areas[pi], areas[pj])
             ).astype(np.float32)
    inter[:16] = 0.0

    def jax_iou(cand, inter, pi, pj):
        a = cand[:, 2] * cand[:, 3]
        return inter / jnp.maximum(a[pi] + a[pj] - inter, 1e-12)

    with jax.disable_jit():
        want = np.asarray(jax_iou(jnp.asarray(boxes), jnp.asarray(inter),
                                  jnp.asarray(pi), jnp.asarray(pj)))
    tb = torch.from_numpy(boxes)
    ta = tb[:, 2] * tb[:, 3]
    got = iou_from_inter(torch.from_numpy(inter), ta[pi], ta[pj], -1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_max_pairs_binds(method):
    """A cap that binds: 300 crowded candidates, more than 512 pairs that
    can overlap, cut at 512 (the pairs past it decay nothing), against
    JAX's at the same cap; and the same boxes uncapped pick otherwise."""
    rng = np.random.default_rng(11)
    boxes = _boxes(rng, 300, spread=12.0)[None]
    scores = rng.uniform(0.05, 1.0, (1, 300)).astype(np.float32)
    valid = np.ones((1, 300), bool)
    kw = dict(pre_max_size=300, post_max_size=40, sigma=0.5,
              iou_threshold=0.3, score_threshold=0.05, method=method,
              max_pairs=512)
    _, ok = soft_nms_pairs(torch.from_numpy(boxes), torch.from_numpy(valid),
                           512)
    assert bool(ok.all())
    ref = _jax_run(boxes, scores, valid, **kw)
    _assert_same(_port_run(boxes, scores, valid, **kw), ref,
                 ROTATED_SCORE_RTOL)
    uncapped = _port_run(boxes, scores, valid, **{**kw, "max_pairs": 8192})
    assert not np.array_equal(uncapped[1], ref[1])


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_decay_on_jax_iou_matches_jax(method):
    """The decay steps alone: the port's `soft_nms_decay_plain` on JAX's own
    rotated IoU matrix of JAX's candidates gives JAX's picks exactly and
    its rescored scores within SCORE_RTOL (a batch of 3 rows, the pair cap
    binding in none)."""
    boxes, scores, valid = _inputs(9, 3, 64, True)
    kw = dict(pre_max_size=48, post_max_size=24, sigma=0.5,
              iou_threshold=0.3, score_threshold=0.05, method=method)
    ref = _jax_run(boxes, scores, valid, **kw)
    masked = torch.from_numpy(np.where(valid, scores, -np.inf))
    top, top_idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top, top_idx = top[:, :48], top_idx[:, :48]
    jmatrix = jax.jit(jax_nms._sparse_rotated_iou_matrix, static_argnums=2)
    iou = torch.stack([torch.from_numpy(np.array(jmatrix(
        jnp.asarray(boxes[b][top_idx[b].numpy()]),
        jnp.asarray(np.isfinite(top[b].numpy())), 8192)))
        for b in range(3)])
    picks, picked = soft_nms_decay_plain(iou, top, 24, method, 0.5, 0.3)
    keep = torch.isfinite(picked) & (picked >= 0.05)
    port = [top_idx.gather(1, picks).numpy(),
            torch.where(keep, picked, 0.0).numpy(), keep.numpy()]
    _assert_same(port, ref)


def test_soft_nms_matches_host_oracle():
    """Standup gaussian soft-NMS against the port's fp64 host oracle, as
    `tests/test_round2_parity.py` holds JAX's: the kept indices in pick
    order and their rescored values."""
    rng = np.random.default_rng(0)
    n = 32
    centers = rng.uniform(0, 20, (n, 2))
    sizes = rng.uniform(2, 5, (n, 2))
    xyxy = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          1).astype(np.float32)
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    keep_np, scores_np = soft_nms_np(xyxy, scores, sigma=0.5,
                                     score_threshold=0.05,
                                     method="gaussian")
    idx, rescored, keep = soft_nms(
        torch.from_numpy(xyxy), torch.from_numpy(scores),
        torch.ones(n, dtype=torch.bool), pre_max_size=n, post_max_size=n,
        sigma=0.5, score_threshold=0.05, method="gaussian", rotated=False)
    np.testing.assert_array_equal(idx[keep].numpy(), keep_np)
    np.testing.assert_allclose(rescored[keep].numpy(), scores_np,
                               rtol=ORACLE_RTOL)


def _decay_loop(iou, scores, m, method, sigma, thr):
    """The decay steps, one row at a time, one candidate at a time, in
    numpy fp32."""
    picks, picked = [], []
    for r in range(scores.shape[0]):
        cur = scores[r].copy()
        pr, sr = [], []
        for _ in range(m):
            best = 0
            for j in range(len(cur)):       # the first of the largest
                if cur[j] > cur[best]:
                    best = j
            pr.append(best)
            sr.append(cur[best])
            for j in range(len(cur)):
                x = iou[r, best, j]
                if method == "gaussian":
                    d = np.exp(np.float32(-(x * x)) / np.float32(sigma))
                else:
                    d = np.float32(1.0) - x if x > thr else np.float32(1.0)
                cur[j] = cur[j] * d if np.isfinite(cur[j]) else -np.inf
            cur[best] = -np.inf
        picks.append(pr)
        picked.append(sr)
    return np.asarray(picks), np.asarray(picked, np.float32)


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_decay_plain_matches_loop(method):
    """`soft_nms_decay_plain` (the kernel's reference on the card) against
    a scalar numpy loop: 4 rows of 40 candidates, one of them all -inf
    (it picks index 0 every step, with score -inf), one with ties and
    invalid tails; picks exact, scores within SCORE_RTOL."""
    rng = np.random.default_rng(5)
    R, K, m = 4, 40, 30
    iou = rng.uniform(0, 1, (R, K, K)).astype(np.float32)
    iou = np.where(rng.uniform(size=(R, K, K)) < 0.7, 0.0, iou)
    iou = np.maximum(iou, iou.transpose(0, 2, 1)).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.01, 1, (R, K)), 1).astype(np.float32)
    scores[1] = -np.inf
    scores[2, 5:9] = scores[2, 5]              # ties
    scores[3, 30:] = -np.inf                   # invalid candidates
    want = _decay_loop(iou, scores, m, method, 0.5, 0.3)
    got = soft_nms_decay_plain(torch.from_numpy(iou),
                               torch.from_numpy(scores), m, method, 0.5,
                               0.3)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=SCORE_RTOL,
                               atol=0)
    assert (want[0][1] == 0).all() and np.isneginf(want[1][1]).all()


def test_soft_nms_decay_refuses_grad():
    """The decay wrappers have no backward: scores or IoU values that
    require grad raise under grad mode."""
    scores = torch.zeros(1, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        soft_nms_decay_standup(torch.zeros(1, 4, 4), scores, 2)
    plist = torch.zeros(1, 2, dtype=torch.int64)
    iou = torch.zeros(1, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        soft_nms_decay_pairs(plist, torch.ones(1, 2, dtype=torch.bool), iou,
                             torch.zeros(1, 4), 2)


# ------------------------------------------------- the pair-list decay


def _candidates(seed, rows, n, k):
    """The top k of n clustered rotated boxes a row, as soft_nms takes
    them: (cand [rows, k, 5], their scores [rows, k], -inf where
    invalid)."""
    boxes, scores, valid = _inputs(seed, rows, n, True)
    masked = torch.from_numpy(np.where(valid, scores, -np.inf))
    top, idx = top_k(masked, k)
    cand = torch.from_numpy(boxes).gather(1, idx[..., None].expand(-1, -1,
                                                                   5))
    return cand.contiguous(), top


@pytest.mark.parametrize("max_pairs", [2304, 96], ids=["all", "capped"])
@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_pairs_plain_is_the_dense_decay_bit_for_bit(method, max_pairs):
    """`soft_nms_decay_pairs_plain` on the pair list equals
    `soft_nms_decay_plain` on `sparse_rotated_iou_matrix`'s matrix of the
    same candidates bit for bit, picks and scores: 3 rows of 48
    candidates, every pair listed (48² slots) or the cap binding (96)."""
    cand, top = _candidates(4, 3, 64, 48)
    valid = torch.isfinite(top)
    plist, ok = soft_nms_pairs(cand, valid, max_pairs)
    if max_pairs < 2304:
        assert bool(ok.all())
    else:
        assert not bool(ok.all())
    got = soft_nms_decay_pairs_plain(plist, ok, pair_iou(cand, plist), top,
                                     40, method, 0.5, 0.3)
    want = soft_nms_decay_plain(sparse_rotated_iou_matrix(cand, valid,
                                                          max_pairs),
                                top, 40, method, 0.5, 0.3)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.isfinite(want[1]).any()


def _edge_pairs():
    """One row of 12 candidates and 10 pair slots: IoU -0.0, -1e-7, NaN
    and values in (0, 1]; two slots that are not ok, holding pairs and
    values that must add nothing. Returns (plist, ok, iou, scores, the
    dense matrix written out by hand: max(iou, 0) with NaN kept, at (i, j)
    and (j, i))."""
    K = 12
    pairs = [(0, 1, 0.6), (0, 2, -0.0), (0, 3, -1e-7), (1, 4, 0.45),
             (2, 5, float("nan")), (3, 6, 0.31), (0, 7, 1.0), (4, 8, 0.2),
             (5, 9, 0.9), (6, 10, 0.8)]
    plist = torch.tensor([[i * K + j for i, j, _ in pairs]])
    iou = torch.tensor([[v for _, _, v in pairs]], dtype=torch.float32)
    ok = torch.ones_like(plist, dtype=torch.bool)
    ok[0, 8:] = False
    dense = torch.zeros(1, K, K)
    for q, (i, j, v) in enumerate(pairs):
        if ok[0, q]:
            v = v if v != v or v > 0 else 0.0
            dense[0, i, j] = dense[0, j, i] = v
    scores = torch.tensor([[0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65, 0.6,
                            0.55, 0.5, 0.45, float("-inf")]])
    return plist, ok, iou, scores, dense


@pytest.mark.parametrize("method,thr", [("gaussian", 0.3), ("linear", 0.3),
                                        ("linear", -0.1)])
def test_pairs_plain_edge_values_decay_as_the_dense_matrix(method, thr):
    """The pair values' edge cases give the dense matrix's decay: -0.0 and
    -1e-7 act as 0 (at threshold -0.1 a 0 decays by 1 - 0, -1e-7 would
    raise its neighbour's score), a NaN IoU is NaN both ways (gaussian:
    its neighbour's score turns NaN, is picked next as torch.argmax ranks
    NaN, and the other non-finite scores turn -inf; linear: NaN > thr is
    false, it decays by 1), slots that are not ok add nothing; and the
    kernel's walk (`_walk_mirror`) the same."""
    plist, ok, iou, scores, dense = _edge_pairs()
    assert torch.equal(pair_matrix(plist, ok, iou, 12).isnan(),
                       dense.isnan())
    assert torch.equal(torch.nan_to_num(pair_matrix(plist, ok, iou, 12)),
                       torch.nan_to_num(dense))
    got = soft_nms_decay_pairs_plain(plist, ok, iou, scores, 12, method,
                                     0.5, thr)
    want = soft_nms_decay_plain(dense, scores, 12, method, 0.5, thr)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].isnan(), want[1].isnan())
    assert torch.equal(torch.nan_to_num(got[1]), torch.nan_to_num(want[1]))
    assert want[1].isnan().any() == (method == "gaussian")
    mirror = _walk_mirror(plist.numpy(), ok.numpy(), iou.numpy(),
                          scores.numpy(), 12, method, 0.5, thr)
    np.testing.assert_array_equal(mirror[0], want[0].numpy())
    np.testing.assert_allclose(mirror[1], want[1].numpy(), rtol=SCORE_RTOL,
                               atol=0)


def _order(v):
    """torch.argmax's order of a score: NaN above +inf, -0 equal to 0."""
    return (1, 0.0) if np.isnan(v) else (0, float(v))


def _walk_mirror(plist, ok, iou, scores, m, method, sigma, thr, span=32):
    """The decay steps as `soft_nms_decay_pairs_kernel` (csrc/riou.cu)
    takes them, in numpy fp32: each candidate's neighbours listed in both
    directions; the scores in spans of `span`, each span's (largest by
    `_order`, lowest index) kept as its slot and recomputed only where the
    step changed the span; a step picks the best slot, writes the pick
    out, sweeps the non-finite scores (other than -inf) of the spans that
    held one to -inf, decays the pick's neighbours and sets the pick to
    -inf."""
    R, K = scores.shape
    picks = np.zeros((R, m), np.int64)
    picked = np.zeros((R, m), np.float32)
    spans = [(lo, min(lo + span, K)) for lo in range(0, K, span)]

    def best_of(cur, lo, hi):
        b = lo
        for j in range(lo + 1, hi):
            if _order(cur[j]) > _order(cur[b]):
                b = j
        odd = any(not np.isfinite(v) and v != -np.inf for v in cur[lo:hi])
        return (_order(cur[b]), b), odd

    for r in range(R):
        adj = [[] for _ in range(K)]
        for q in np.flatnonzero(ok[r]):
            i, j = divmod(int(plist[r, q]), K)
            v = iou[r, q]
            v = v if np.isnan(v) or v > 0 else np.float32(0.0)
            adj[i].append((j, v))
            adj[j].append((i, v))
        cur = scores[r].astype(np.float32).copy()
        slots = [best_of(cur, lo, hi) for lo, hi in spans]
        for s in range(m):
            b = max(slots, key=lambda x: (x[0][0], -x[0][1]))[0][1]
            picks[r, s], picked[r, s] = b, cur[b]
            changed = {w for w, (_, odd) in enumerate(slots) if odd}
            for w in changed:
                lo, hi = spans[w]
                cur[lo:hi] = np.where(np.isfinite(cur[lo:hi]), cur[lo:hi],
                                      -np.inf)
            for j, v in adj[b]:
                if method == "gaussian":
                    d = np.exp(np.float32(-(v * v)) / np.float32(sigma))
                else:
                    d = np.float32(1.0) - v if v > thr else np.float32(1.0)
                cur[j] = cur[j] * d if np.isfinite(cur[j]) else -np.inf
                changed.add(j // span)
            cur[b] = -np.inf
            changed.add(b // span)
            for w in changed:
                slots[w] = best_of(cur, *spans[w])
    return picks, picked


@pytest.mark.parametrize("span", [32, 128])
@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_walk_mirror_matches_pairs_plain(method, span):
    """The kernel's walk (`_walk_mirror`) against the plain version on
    random pair lists: 4 rows of 300 candidates, 600 slots (10% not ok),
    picks exact and scores within SCORE_RTOL (numpy's exp and torch's an
    ulp apart; NaN where NaN); row 1 all -inf
    (it picks 0 each step), row 2 with ties and a NaN and a +inf score,
    row 3 with NaN IoU values; 120 steps, at the kernel's span of 32
    scores a warp and at 128 (K = 4096's)."""
    rng = np.random.default_rng(21)
    R, K, P, m = 4, 300, 600, 120
    iu, ju = np.triu_indices(K, 1)
    plist = np.stack([np.sort(rng.choice(iu * K + ju, P, replace=False))
                      for _ in range(R)])
    ok = rng.uniform(size=(R, P)) < 0.9
    iou = rng.uniform(-0.05, 1.0, (R, P)).astype(np.float32)
    iou[3, :40] = np.nan
    scores = -np.sort(-rng.uniform(0.01, 1, (R, K))).astype(np.float32)
    scores[1] = -np.inf
    scores[2, 50:60] = scores[2, 50]
    scores[2, 70], scores[2, 80] = np.nan, np.inf
    want = soft_nms_decay_pairs_plain(
        torch.from_numpy(plist), torch.from_numpy(ok),
        torch.from_numpy(iou), torch.from_numpy(scores), m, method, 0.5,
        0.3)
    got = _walk_mirror(plist, ok, iou, scores, m, method, 0.5, 0.3, span)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_allclose(got[1], want[1].numpy(), rtol=SCORE_RTOL,
                               atol=0)
    assert (want[0][1] == 0).all() and torch.isnan(want[1][2]).any()
    # a NaN IoU decays by NaN (gaussian) or by 1 (NaN > thr is false)
    assert bool(torch.isnan(want[1][3]).any()) == (method == "gaussian")


def test_soft_nms_decay_pairs_on_cpu_is_the_plain_version():
    """`soft_nms_decay_pairs` on CPU tensors is its plain version; it
    refuses a gradient."""
    plist, ok, iou, scores, _ = _edge_pairs()
    got = soft_nms_decay_pairs(plist, ok, iou, scores, 6)
    want = soft_nms_decay_pairs_plain(plist, ok, iou, scores, 6)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].nan_to_num(), want[1].nan_to_num())
    with pytest.raises(RuntimeError, match="no backward"):
        soft_nms_decay_pairs(plist, ok, iou.requires_grad_(), scores, 2)


# ------------------------------------------------------ the standup decay


def _standup_row_mirror(pick, boxes):
    """The IoU of box `pick` [4] with each of `boxes` [K, 4] as
    `soft_nms_decay_standup_kernel` (csrc/riou.cu) computes it, in numpy
    fp32 with no fused multiply-add: the widths by fmin and fmax, the pair
    meeting where both are > 0 and neither box holds a NaN, inter = (wx +
    0) * (wy + 0) where it meets, iou = inter / ((a_pick + a_j) - inter)
    where inter > 0, each area (x2 - x1 + 0) * (y2 - y1 + 0). Returns
    (iou [K], meet [K])."""
    zero = np.float32(0.0)
    with np.errstate(all="ignore"):
        wx = np.fmin(pick[2], boxes[:, 2]) - np.fmax(pick[0], boxes[:, 0])
        wy = np.fmin(pick[3], boxes[:, 3]) - np.fmax(pick[1], boxes[:, 1])
        meet = (wx > 0) & (wy > 0) & ~np.isnan(boxes).any(1) & \
            ~np.isnan(pick).any()
        inter = np.where(meet, (wx + zero) * (wy + zero), zero)
        ap = (pick[2] - pick[0] + zero) * (pick[3] - pick[1] + zero)
        area = (boxes[:, 2] - boxes[:, 0] + zero) * \
            (boxes[:, 3] - boxes[:, 1] + zero)
        iou = np.where(inter > 0, inter / ((ap + area) - inter), zero)
    return iou.astype(np.float32), meet


def _standup_edge_boxes():
    """xyxy boxes that meet the IoU's edge cases: NaN and +-inf
    coordinates, two infinite boxes (their IoU inf / (inf + inf - inf) is
    NaN), zero width and height, touching edges, -0.0 coordinates, an
    inverted box, and areas that overflow."""
    inf, nan = np.inf, np.nan
    return np.array([
        [0.0, 0.0, 2.0, 2.0], [2.0, 0.0, 4.0, 2.0],     # touching edges
        [1.0, 1.0, 3.0, 3.0], [-0.0, -0.0, 1.0, 1.0],
        [0.0, -0.0, -0.0, 1.0],                         # zero width
        [0.5, 0.5, 1.5, 0.5],                           # zero height
        [nan, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, nan],
        [-inf, -inf, inf, inf], [-inf, -inf, inf, inf],
        [-inf, 0.0, 1.0, 1.0], [0.0, 0.0, inf, 1.0],
        [3.0, 3.0, 1.0, 1.0],                           # inverted
        [-3e38, -3e38, 3e38, 3e38], [-1e-38, 0.0, 1e-38, 1.0],
        [0.25, 0.25, 0.75, 0.75], [1.0 - 2 ** -23, 0.0, 2.0, 2.0],
    ], np.float32)


@pytest.mark.parametrize("kind", ["seeded", "edge"])
def test_standup_kernel_iou_mirror_is_the_matrix_bit_for_bit(kind):
    """The kernel's per-lane IoU (`_standup_row_mirror`, the pick as
    `boxes1`) equals every row of `standup_iou_matrix(cand, cand)` (what
    the plain version decays by) bit for bit, NaN where it is NaN, and
    every pair it does not meet is 0 there: 300 seeded clustered boxes with
    some copied exactly, or the edge boxes against themselves and 40
    seeded ones."""
    rng = np.random.default_rng(13)
    boxes = _boxes(rng, 300, rotated=False, spread=15.0)
    boxes[::17] = boxes[1::17][:len(boxes[::17])]       # identical pairs
    if kind == "edge":
        boxes = np.concatenate([_standup_edge_boxes(), boxes[:40]])
    want = standup_iou_matrix(torch.from_numpy(boxes),
                              torch.from_numpy(boxes)).numpy()
    rows = [_standup_row_mirror(b, boxes) for b in boxes]
    got = np.stack([iou for iou, _ in rows])
    meet = np.stack([m for _, m in rows])
    assert (want[~meet] == 0).all()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    assert (want > 0).sum() > len(boxes)
    if kind == "edge":
        assert nan.sum() >= 4 and np.isinf(boxes).any()


def _identity_top_k(x, k):
    """`lax.top_k` that keeps the input order, so that JAX's `soft_nms`
    decays its own candidates as given."""
    idx = jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32),
                           x.shape[:-1] + (k,))
    return x[..., :k], idx


def _standup_rows():
    """5 rows of 40 standup candidates, scores sorted descending: seeded
    clustered boxes; a row with a NaN and a +inf score (NaN is picked
    first, the +inf turns -inf); a row with two overlapping infinite boxes
    (their IoU NaN: gaussian decays the second to NaN, picked next) and a
    NaN coordinate; a row with ties, an invalid tail and a NaN and a +inf
    score 20 apart, the +inf among 8 boxes far from the others; a row of
    -inf."""
    rng = np.random.default_rng(17)
    R, K = 5, 40
    cand = np.stack([_boxes(rng, K, rotated=False, spread=10.0)
                     for _ in range(R)])
    scores = -np.sort(-rng.uniform(0.05, 1.0, (R, K)), 1).astype(np.float32)
    scores[1, 6], scores[1, 3] = np.nan, np.inf
    cand[2, 2] = cand[2, 5] = [-np.inf, -np.inf, np.inf, np.inf]
    cand[2, 9, 1] = np.nan
    scores[3, 10:16] = scores[3, 10]
    scores[3, 30:] = -np.inf
    scores[3, 5], scores[3, 25] = np.nan, np.inf
    cand[3, 24:32] += 1000.0
    scores[4] = -np.inf
    return cand, scores


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_standup_decay_plain_matches_jax_scan(method, monkeypatch):
    """The plain version's decay steps (`soft_nms_decay_standup_plain`, the
    kernel's reference on the card) against JAX's `soft_nms` scan on JAX's
    own `standup_iou_matrix` of the same candidates, jitted, its top-k
    replaced by the identity so that only the decay is compared: picks
    exact (torch.argmax's and jnp.argmax's NaN order), the finite scores
    where JAX's are finite and within SCORE_RTOL."""
    cand, scores = _standup_rows()
    R, K = scores.shape
    m = 30
    monkeypatch.setattr(jax.lax, "top_k", _identity_top_k)
    fn = jax.jit(jax.vmap(partial(
        jax_nms.soft_nms, pre_max_size=K, post_max_size=m, sigma=0.5,
        iou_threshold=0.3, score_threshold=-np.inf, method=method,
        rotated=False)))
    jidx, jscores, jkeep = (np.asarray(o) for o in fn(
        jnp.asarray(cand), jnp.asarray(scores), jnp.ones((R, K), bool)))
    picks, picked = soft_nms_decay_standup_plain(
        torch.from_numpy(cand), torch.from_numpy(scores), m, method, 0.5,
        0.3)
    picks, picked = picks.numpy(), picked.numpy()
    np.testing.assert_array_equal(picks, jidx)
    np.testing.assert_array_equal(np.isfinite(picked), jkeep)
    np.testing.assert_allclose(picked[jkeep], jscores[jkeep],
                               rtol=SCORE_RTOL, atol=0)
    assert picks[1, 0] == 6 and np.isnan(picked[1, 0]) and 3 not in picks[1]
    # the second infinite box: NaN by the gaussian decay, picked at once
    first = list(picks[2]).index(2)
    assert (picks[2, first + 1] == 5) == (method == "gaussian")
    assert np.isnan(picked[2, first + 1]) == (method == "gaussian")
    assert (picks[4] == 0).all()


def test_soft_nms_decay_standup_on_cpu_is_the_plain_version():
    """`soft_nms_decay_standup` on CPU tensors is its plain version, NaN
    where it is NaN."""
    cand, scores = (torch.from_numpy(a) for a in _standup_rows())
    for method in ("gaussian", "linear"):
        got = soft_nms_decay_standup(cand, scores, 40, method, 0.5, 0.3)
        want = soft_nms_decay_standup_plain(cand, scores, 40, method, 0.5,
                                            0.3)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].isnan(), want[1].isnan())
        assert torch.equal(got[1].nan_to_num(), want[1].nan_to_num())


def test_soft_nms_decay_standup_refuses_grad_and_bad_shapes():
    cand, scores = torch.zeros(2, 8, 4), torch.zeros(2, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        soft_nms_decay_standup(cand.requires_grad_(), scores, 2)
    cand = cand.detach()
    for c, sc, m in ((torch.zeros(2, 8, 5), scores, 2),
                     (torch.zeros(2, 7, 4), scores, 2),
                     (cand, torch.zeros(16), 2), (cand, scores, 9),
                     (cand, scores, -1)):
        with pytest.raises(ValueError, match="cand \\[R, K, 4\\]"):
            soft_nms_decay_standup(c, sc, m)


def _decay_np(r, method, sigma, thr):
    with np.errstate(all="ignore"):
        if method == "gaussian":
            return np.exp(np.float32(-(r * r)) / np.float32(sigma))
        return np.where(r > np.float32(thr), np.float32(1.0) - r,
                        np.float32(1.0)).astype(np.float32)


def _standup_steps_mirror(cand, scores, m, method, sigma, thr, span=32):
    """The decay steps as `soft_nms_decay_standup_kernel` takes them, in
    numpy fp32: each step picks the best of the spans' slots (`_order`,
    the lowest index), computes the pick's meet test with every candidate
    (`_standup_row_mirror`) and decays only the finite candidates that
    meet it (all of them where d0, the decay of a 0 IoU, is not 1), turns
    NaN and +inf scores to -inf, sets the pick to -inf, and recomputes
    only the slots of spans where a candidate changed."""
    R, K = scores.shape
    picks = np.zeros((R, m), np.int64)
    picked = np.zeros((R, m), np.float32)
    spans = [(lo, min(lo + span, K)) for lo in range(0, K, span)]
    d0 = _decay_np(np.float32(0.0), method, sigma, thr)
    every = not d0 == 1

    def best_of(cur, lo, hi):
        b = lo
        for j in range(lo + 1, hi):
            if _order(cur[j]) > _order(cur[b]):
                b = j
        return _order(cur[b]), b

    for r in range(R):
        boxes, cur = cand[r], scores[r].astype(np.float32).copy()
        slots = [best_of(cur, lo, hi) for lo, hi in spans]
        for s in range(m):
            b = max(slots, key=lambda x: (x[0], -x[1]))[1]
            picks[r, s], picked[r, s] = b, cur[b]
            iou, meet = _standup_row_mirror(boxes[b], boxes)
            fin = np.isfinite(cur)
            upd = fin & (meet | every)
            with np.errstate(all="ignore"):
                new = np.where(upd, cur * _decay_np(iou, method, sigma, thr),
                               cur).astype(np.float32)
            new = np.where(fin, new, np.float32(-np.inf))
            new[b] = -np.inf
            changed = upd | (~fin & (cur != -np.inf))
            changed[b] = True
            cur = new
            for w, (lo, hi) in enumerate(spans):
                if changed[lo:hi].any():
                    slots[w] = best_of(cur, lo, hi)
    return picks, picked


@pytest.mark.parametrize("sigma", [0.5, 0.0], ids=["sigma", "sigma0"])
@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_standup_steps_mirror_matches_plain(method, sigma):
    """The standup kernel's steps (`_standup_steps_mirror`: the meet test,
    the decay of meeting pairs only, the slots of unchanged spans carried
    over) against its plain version, which decays every candidate by its
    whole IoU row: picks exact, NaN where NaN, the finite scores within
    SCORE_RTOL (numpy's exp and torch's an ulp apart); the rows of
    `_standup_rows` (NaN and +inf scores, infinite and NaN boxes, ties,
    -inf rows) and 100 crowded boxes, at spans of 32 and 8; sigma 0 decays
    every pair that does not meet by NaN (-0 / 0)."""
    cand, scores = _standup_rows()
    rng = np.random.default_rng(23)
    crowd = _boxes(rng, 40, rotated=False, spread=4.0)[None]
    cand = np.concatenate([cand, crowd])
    scores = np.concatenate([scores, -np.sort(-rng.uniform(
        0.05, 1, (1, 40))).astype(np.float32)])
    want = soft_nms_decay_standup_plain(torch.from_numpy(cand),
                                        torch.from_numpy(scores), 36,
                                        method, sigma, 0.3)
    for span in (32, 8):
        got = _standup_steps_mirror(cand, scores, 36, method, sigma, 0.3,
                                    span)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(np.isnan(got[1]),
                                      want[1].isnan().numpy())
        fin = np.isfinite(got[1])
        np.testing.assert_array_equal(fin, torch.isfinite(want[1]).numpy())
        np.testing.assert_allclose(got[1][fin], want[1].numpy()[fin],
                                   rtol=SCORE_RTOL, atol=0)
    assert bool(want[1].isnan().any())
