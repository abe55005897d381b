from . import middle, sparse_middle  # register the middles
from .build import (NetInfo, build_voxelnet, calibrate_norms_,
                    init_train_weights_, init_weights_)
from .detector import DetectorSpec, VoxelNet, compute_loss, detect, predict
from .detector_fusion_two_stage import (FusionTwoStageVoxelNet,
                                        build_fusion_two_stage_voxelnet,
                                        compute_fusion_two_stage_loss,
                                        predict_fusion_two_stage)
from .detector_two_stage import (TwoStageVoxelNet, build_two_stage_voxelnet,
                                 compute_two_stage_loss, predict_two_stage)
from .fusion import (FusionRPN, FusionVoxelNet, ResNetFPN18,
                     ZSliceFusionRPN, build_fusion_voxelnet,
                     compute_bev_zslice_projection, compute_image_projection,
                     gather_image_features, project_image_to_bev)
from .joint_track import (JointDetTrack, build_joint_det_track,
                          compute_joint_loss)
from .temporal import (TemporalFusionVoxelNet, TemporalSequenceVoxelNet,
                       TemporalVoxelNet, build_temporal_fusion_voxelnet,
                       build_temporal_voxelnet, compute_temporal_loss,
                       predict_temporal)

__all__ = ["NetInfo", "build_voxelnet", "calibrate_norms_",
           "init_train_weights_", "init_weights_", "DetectorSpec",
           "VoxelNet", "compute_loss", "detect", "predict",
           "TwoStageVoxelNet", "build_two_stage_voxelnet",
           "compute_two_stage_loss", "predict_two_stage",
           "TemporalVoxelNet", "TemporalSequenceVoxelNet",
           "build_temporal_voxelnet", "compute_temporal_loss",
           "predict_temporal", "ResNetFPN18", "FusionRPN",
           "ZSliceFusionRPN", "FusionVoxelNet", "build_fusion_voxelnet",
           "project_image_to_bev", "gather_image_features",
           "compute_image_projection", "compute_bev_zslice_projection",
           "FusionTwoStageVoxelNet", "build_fusion_two_stage_voxelnet",
           "compute_fusion_two_stage_loss", "predict_fusion_two_stage",
           "TemporalFusionVoxelNet", "build_temporal_fusion_voxelnet",
           "JointDetTrack", "build_joint_det_track", "compute_joint_loss"]
