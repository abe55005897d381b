from . import kitti_eval, misc

__all__ = ["kitti_eval", "misc"]
