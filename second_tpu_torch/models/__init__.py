from . import sparse_middle  # registers SpMiddleFHD
from .build import (NetInfo, build_voxelnet, init_train_weights_,
                    init_weights_)
from .detector import DetectorSpec, VoxelNet, compute_loss, detect, predict

__all__ = ["NetInfo", "build_voxelnet", "init_train_weights_",
           "init_weights_", "DetectorSpec", "VoxelNet", "compute_loss",
           "detect", "predict"]
