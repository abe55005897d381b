from . import sparse_middle  # registers SpMiddleFHD
from .build import NetInfo, build_voxelnet, init_weights_
from .detector import DetectorSpec, VoxelNet, detect, predict

__all__ = ["NetInfo", "build_voxelnet", "init_weights_", "DetectorSpec",
           "VoxelNet", "detect", "predict"]
