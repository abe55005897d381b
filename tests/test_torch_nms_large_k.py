"""The port's NMS and soft-NMS past 4096 candidates an example, where the
card's kernels take their wide routes (`csrc/riou.cu`), against JAX's on the
CPU: `nms` rotated (its pair cap binding) and standup, and `soft_nms`
rotated gaussian and standup linear, at K = 4500 candidates of 5000 crowded
boxes made from a numpy seed. The port runs its plain versions here, the
card kernels' yardstick; JAX runs jitted. Indices and keep masks exactly,
rescored scores within `tests/test_torch_soft_nms.py`'s tolerances (the
rotated ones looser: XLA's and torch's sin and cos put the corners an ulp
apart). The port's side runs on one thread."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.ops import nms as jax_nms
from second_tpu_torch.ops import nms as port_nms
from second_tpu_torch.ops.cuda import riou

from test_torch_soft_nms import ROTATED_SCORE_RTOL, SCORE_RTOL
from test_torch_temporal import one_thread

N, K = 5000, 4500          # boxes, candidates (pre_max_size)
assert K > riou.NMS_MAX_K


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _crowded(seed, rotated, spread=2.5):
    """N boxes over a square of side `spread` sqrt(N) m, 0.5-3 m by 0.5-6
    m: at 2.5 a few standup-overlapping neighbours each, some 10 000 pairs
    whose bound passes 0.1, more than the 8192-pair cap; scores in (0, 1),
    10% of the boxes invalid."""
    rng = np.random.default_rng(seed)
    side = spread * np.sqrt(N)
    xy = rng.uniform(0, side, (N, 2))
    wl = np.stack([rng.uniform(0.5, 3.0, N), rng.uniform(0.5, 6.0, N)], 1)
    if rotated:
        yaw = rng.uniform(-np.pi, np.pi, (N, 1))
        boxes = np.concatenate([xy, wl, yaw], 1)
    else:
        boxes = np.concatenate([xy - wl / 2, xy + wl / 2], 1)
    scores = rng.uniform(0.01, 1.0, N)
    valid = rng.uniform(size=N) > 0.1
    return (boxes.astype(np.float32), scores.astype(np.float32), valid)


@partial(jax.jit, static_argnames=("kw",))
def _jax_nms(boxes, scores, valid, kw):
    return jax_nms.nms(boxes, scores, valid, **dict(kw))


@partial(jax.jit, static_argnames=("kw",))
def _jax_soft_nms(boxes, scores, valid, kw):
    return jax_nms.soft_nms(boxes, scores, valid, **dict(kw))


def _both(jax_fn, port_fn, inputs, kw):
    ref = jax_fn(*(jnp.asarray(a) for a in inputs), tuple(sorted(kw.items())))
    port = port_fn(*(torch.from_numpy(a) for a in inputs), **kw)
    return [np.asarray(r) for r in ref], [p.numpy() for p in port]


@pytest.mark.parametrize("rotated", [True, False],
                         ids=["rotated", "standup"])
def test_nms_past_4096_matches_jax(rotated):
    """Hard NMS at pre_max_size 4500, post 500, threshold 0.1: the same
    indices in the same order and the same keep mask. Rotated, the
    standup bound passes more pairs than the 8192-pair cap, so JAX's cap
    (the first 8192 in row-major order; a pair past it does not overlap)
    decides the result."""
    inputs = _crowded(21, rotated)
    kw = dict(pre_max_size=K, post_max_size=500, iou_threshold=0.1,
              rotated=rotated)
    (jidx, jkeep), (idx, keep) = _both(_jax_nms, port_nms.nms, inputs, kw)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(idx, jidx)
    assert 0 < keep.sum() < 500 or keep.all()
    if rotated:
        boxes, scores, valid = (torch.from_numpy(a) for a in inputs)
        top, top_idx = port_nms.top_k(torch.where(valid, scores, -np.inf),
                                      K)
        _, _, count = riou.capped_pairs(boxes[top_idx][None],
                                        torch.isfinite(top)[None], 0.1, 8192)
        assert int(count[0]) > 8192


@pytest.mark.parametrize("rotated,method", [(True, "gaussian"),
                                            (False, "linear")],
                         ids=["rotated_gaussian", "standup_linear"])
def test_soft_nms_past_4096_matches_jax(rotated, method):
    """Soft-NMS at pre_max_size 4500, 100 steps (sigma 0.5, threshold 0.3,
    score threshold 0.05) on boxes 25 times as dense as NMS's: the same picks,
    keep mask and rescored scores within SCORE_RTOL (ROTATED_SCORE_RTOL
    rotated)."""
    inputs = _crowded(22, rotated, spread=0.5)
    kw = dict(pre_max_size=K, post_max_size=100, sigma=0.5,
              iou_threshold=0.3, score_threshold=0.05, method=method,
              rotated=rotated)
    (jidx, jout, jkeep), (idx, out, keep) = _both(
        _jax_soft_nms, port_nms.soft_nms, inputs, kw)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(out, jout, atol=0,
                               rtol=ROTATED_SCORE_RTOL if rotated
                               else SCORE_RTOL)
    # the decay moved the order: some of the 100 highest scores were
    # passed over
    top100 = np.argsort(-np.where(inputs[2], inputs[1], -np.inf),
                        kind="stable")[:100]
    assert set(idx.tolist()) != set(top100.tolist())
