from .optimizer import build_lr_schedules, build_optimizer
from .state import (TrainState, VoxelizeSpec, device_voxelize, make_eval_step,
                    make_train_step)

__all__ = ["build_optimizer", "build_lr_schedules", "TrainState",
           "VoxelizeSpec", "device_voxelize", "make_eval_step",
           "make_train_step"]
