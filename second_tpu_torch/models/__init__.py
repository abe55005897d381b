from . import middle, sparse_middle  # register the middles
from .build import (NetInfo, build_voxelnet, calibrate_norms_,
                    init_train_weights_, init_weights_)
from .detector import DetectorSpec, VoxelNet, compute_loss, detect, predict

__all__ = ["NetInfo", "build_voxelnet", "calibrate_norms_",
           "init_train_weights_", "init_weights_", "DetectorSpec",
           "VoxelNet", "compute_loss", "detect", "predict"]
