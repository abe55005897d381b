from . import assignment, kitti_eval, misc, mot_metrics

__all__ = ["assignment", "kitti_eval", "misc", "mot_metrics"]
