"""Native host runtime: ctypes bindings over the C++ data-prep kernels.

Provides accelerated versions of the host-side hot loops (first-come
voxelization, point-in-box tests, BEV collision tests) with automatic
build-on-first-use (`make` + g++, safe when several processes build at
once) and transparent numpy fallback when the toolchain is unavailable. The numpy implementations in `second_tpu.core` are
the behavioral oracles.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).parent / "native"
_LIB_PATH = _NATIVE_DIR / "libhost_ops.so"
_LOCK_PATH = _NATIVE_DIR / ".build.lock"
_lib = None
_load_failed = False


def _build_library() -> bool:
    """Build `libhost_ops.so` unless another process has: under an
    exclusive `fcntl` lock on a file in `native/`, re-check for the library,
    link it to a name of this process's own and `os.replace` it into place,
    so no process ever sees a half-linked library."""
    try:
        with open(_LOCK_PATH, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if _LIB_PATH.exists():
                    return True
                tmp = f"{_LIB_PATH.name}.{os.getpid()}.tmp"
                subprocess.run(["make", "-C", str(_NATIVE_DIR), f"OUT={tmp}"],
                               check=True, capture_output=True, timeout=120)
                os.replace(_NATIVE_DIR / tmp, _LIB_PATH)
                return True
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except Exception:
        return False


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C functions' signatures; raises AttributeError where the
    library lacks one."""
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.points_to_voxel.restype = ctypes.c_int64
    lib.points_to_voxel.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int64, c_f32p, c_f32p,
        ctypes.c_int64, ctypes.c_int64, c_f32p, c_i32p, c_i32p]
    lib.points_in_rbbox.restype = None
    lib.points_in_rbbox.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int64, c_f32p, ctypes.c_int64,
        c_u8p]
    lib.box_collision_test.restype = None
    lib.box_collision_test.argtypes = [
        c_f32p, ctypes.c_int64, c_f32p, ctypes.c_int64, c_u8p]
    lib.iou_matrix.restype = None
    lib.iou_matrix.argtypes = [
        c_f32p, ctypes.c_int64, c_f32p, ctypes.c_int64, c_f32p]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None (the numpy fallbacks)
    where it cannot be built or loaded, or lacks a function."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists() and not _build_library():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        _bind(lib)
    except (OSError, AttributeError):
        _load_failed = True
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def points_to_voxel(points, voxel_size, point_cloud_range, max_points=35,
                    max_voxels=20000):
    """Native first-come voxelizer; falls back to the numpy oracle."""
    lib = get_lib()
    if lib is None:
        from ..core.voxelize_np import points_to_voxel as np_impl
        return np_impl(points, voxel_size, point_cloud_range, max_points,
                       max_voxels)
    points = np.ascontiguousarray(points, np.float32)
    vsize = np.ascontiguousarray(voxel_size, np.float32)
    rng = np.ascontiguousarray(point_cloud_range, np.float32)
    voxels = np.zeros((max_voxels, max_points, points.shape[1]), np.float32)
    coords = np.zeros((max_voxels, 3), np.int32)
    counts = np.zeros((max_voxels,), np.int32)
    n = lib.points_to_voxel(
        _fp(points), points.shape[0], points.shape[1], _fp(vsize), _fp(rng),
        max_points, max_voxels, _fp(voxels),
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return voxels[:n], coords[:n], counts[:n]


def points_in_rbbox(points, boxes):
    """Native point-in-rotated-box test; falls back to the numpy oracle."""
    lib = get_lib()
    if lib is None:
        from ..core.box_np import points_in_rbbox as np_impl
        return np_impl(points, boxes)
    points = np.ascontiguousarray(points, np.float32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    out = np.zeros((points.shape[0], boxes.shape[0]), np.uint8)
    lib.points_in_rbbox(
        _fp(points), points.shape[0], points.shape[1], _fp(boxes),
        boxes.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def iou_matrix(boxes, query_boxes):
    """Native pairwise xyxy IoU (anchors-vs-gt similarity hot loop);
    falls back to the numpy oracle."""
    lib = get_lib()
    if lib is None:
        from ..core.box_np import iou_matrix as np_impl
        return np_impl(boxes, query_boxes)
    boxes = np.ascontiguousarray(boxes, np.float32)
    query_boxes = np.ascontiguousarray(query_boxes, np.float32)
    out = np.empty((boxes.shape[0], query_boxes.shape[0]), np.float32)
    lib.iou_matrix(_fp(boxes), boxes.shape[0], _fp(query_boxes),
                   query_boxes.shape[0], _fp(out))
    return out


def box_collision_test(boxes1, boxes2):
    """Native SAT collision test for BEV boxes [*, 5(x, y, w, l, yaw)]."""
    lib = get_lib()
    if lib is None:
        from ..core.augment import box_collision_test as np_impl
        return np_impl(boxes1, boxes2)
    boxes1 = np.ascontiguousarray(boxes1, np.float32)
    boxes2 = np.ascontiguousarray(boxes2, np.float32)
    out = np.zeros((boxes1.shape[0], boxes2.shape[0]), np.uint8)
    lib.box_collision_test(
        _fp(boxes1), boxes1.shape[0], _fp(boxes2), boxes2.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)
