from . import anchors, box_np, region_similarity, target_np
from .rotated_iou_np import d3_box_overlap, rotated_iou

__all__ = ["anchors", "box_np", "region_similarity", "target_np",
           "rotated_iou", "d3_box_overlap"]
