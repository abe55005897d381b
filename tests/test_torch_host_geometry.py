"""The port's host geometry against the JAX package's, on the CPU: the
frustum cull and the point-in-box membership of `core/box_np.py` (which
reach `core/geometry_np.py`), and the numpy fallbacks of the runtime's
`points_in_rbbox` and `box_collision_test` (the latter reaches
`core/augment.py`), forced by a `get_lib` that finds no native library.
Inputs from numpy seeds; masks and kept points exactly equal."""

import numpy as np
import pytest

from second_tpu import runtime as jax_runtime
from second_tpu.core import augment as jax_augment
from second_tpu.core import box_np as jax_box_np
from second_tpu.core import geometry_np as jax_geometry_np
from second_tpu_torch import runtime
from second_tpu_torch.core import augment, box_np, geometry_np

# a KITTI training frame's calibration (velodyne -> rectified camera 2)
P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
               [0.0, 721.5377, 172.854, 0.2163791],
               [0.0, 0.0, 1.0, 0.002745884],
               [0.0, 0.0, 0.0, 1.0]])
RECT = np.array([[0.9999239, 0.00983776, -0.007445048, 0.0],
                 [-0.009869795, 0.9999421, -0.004278459, 0.0],
                 [0.007402527, 0.004351614, 0.9999631, 0.0],
                 [0.0, 0.0, 0.0, 1.0]])
TRV2C = np.array([[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
                  [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
                  [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
                  [0.0, 0.0, 0.0, 1.0]])
IMAGE_SHAPE = (375, 1242)


def _points(rng, n=20_000):
    pts = rng.uniform([-20.0, -40.0, -3.0], [70.0, 40.0, 1.0], (n, 3))
    return np.concatenate([pts, rng.uniform(0, 1, (n, 1))], 1).astype(
        np.float32)


def _boxes(rng, n=25):
    return np.stack([rng.uniform(-10, 40, n), rng.uniform(-20, 20, n),
                     rng.uniform(-2, 0, n), rng.uniform(1, 3, n),
                     rng.uniform(2, 5, n), rng.uniform(1, 2, n),
                     rng.uniform(-np.pi, np.pi, n)], 1)


def _bev(rng, n):
    return np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                     rng.uniform(1, 3, n), rng.uniform(2, 5, n),
                     rng.uniform(-np.pi, np.pi, n)], 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_remove_outside_points_matches_jax(seed):
    """The camera-frustum cull keeps the same points, in the same order."""
    pts = _points(np.random.default_rng(seed))
    got = box_np.remove_outside_points(pts, RECT, TRV2C, P2, IMAGE_SHAPE)
    want = jax_box_np.remove_outside_points(pts, RECT, TRV2C, P2,
                                            IMAGE_SHAPE)
    assert 0 < len(want) < len(pts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lidar", [True, False])
def test_points_in_rbbox_matches_jax(lidar):
    """The [points, boxes] membership mask, lidar and camera frames."""
    rng = np.random.default_rng(10 + lidar)
    pts, boxes = _points(rng, 5_000), _boxes(rng)
    if not lidar:
        pts = pts[:, [1, 2, 0, 3]]
    got = box_np.points_in_rbbox(pts, boxes, lidar=lidar)
    want = jax_box_np.points_in_rbbox(pts, boxes, lidar=lidar)
    assert got.dtype == want.dtype == bool and got.shape == (5_000, 25)
    np.testing.assert_array_equal(got, want)
    if lidar:
        assert want.any()


def test_geometry_surfaces_and_polygons_match_jax():
    """The two geometry_np functions the cull and the mask go through."""
    rng = np.random.default_rng(12)
    boxes = _boxes(rng, 8)
    corners = box_np.center_to_corner_box3d(
        boxes[:, :3], boxes[:, 3:6], boxes[:, 6], origin=(0.5, 0.5, 0.0),
        axis=2)
    surfaces = geometry_np.corner_to_surfaces_3d(corners)
    np.testing.assert_array_equal(
        surfaces, jax_geometry_np.corner_to_surfaces_3d(corners))
    pts = _points(rng, 3_000)[:, :3]
    np.testing.assert_array_equal(
        geometry_np.points_in_convex_polygon_3d(pts, surfaces),
        jax_geometry_np.points_in_convex_polygon_3d(pts, surfaces))


@pytest.fixture
def no_native(monkeypatch):
    """Both runtimes without their native library: the numpy fallbacks."""
    monkeypatch.setattr(runtime, "get_lib", lambda: None)
    monkeypatch.setattr(jax_runtime, "get_lib", lambda: None)


@pytest.mark.parametrize("seed", [0, 1])
def test_runtime_points_in_rbbox_fallback_matches_jax(no_native, seed):
    rng = np.random.default_rng(20 + seed)
    pts, boxes = _points(rng, 5_000), _boxes(rng)
    got = runtime.points_in_rbbox(pts, boxes)
    want = jax_runtime.points_in_rbbox(pts, boxes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_box_np.points_in_rbbox(pts, boxes))


@pytest.mark.parametrize("seed", [0, 1])
def test_runtime_box_collision_fallback_matches_jax(no_native, seed):
    rng = np.random.default_rng(30 + seed)
    b1, b2 = _bev(rng, 40), _bev(rng, 30)
    got = runtime.box_collision_test(b1, b2)
    want = jax_runtime.box_collision_test(b1, b2)
    assert got.shape == (40, 30) and want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_augment.box_collision_test(b1, b2))
    np.testing.assert_array_equal(augment.box_collision_test(b1, b2), want)
