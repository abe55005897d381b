"""Typed pipeline-config schema.

Mirrors the message structure of the reference's protobuf schema
(`/root/reference/second/protos/*.proto`, esp. `second.proto`, `input_reader.proto`,
`optimizer.proto`, `pipeline.proto`) as plain dataclasses, populated from the
text-format tree produced by `textproto.py`. Field names and defaults follow the
reference so its `.config` files load unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class VoxelGeneratorConfig:
    point_cloud_range: List[float] = field(
        default_factory=lambda: [0.0, -40.0, -3.0, 70.4, 40.0, 1.0])
    voxel_size: List[float] = field(default_factory=lambda: [0.05, 0.05, 0.1])
    max_number_of_points_per_voxel: int = 5

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """Integer grid size (x, y, z), matching spconv VoxelGenerator.grid_size."""
        out = []
        for i in range(3):
            extent = self.point_cloud_range[i + 3] - self.point_cloud_range[i]
            out.append(int(round(extent / self.voxel_size[i])))
        return tuple(out)


@dataclass
class VFEConfig:
    module_class_name: str = "VoxelFeatureExtractorV3"
    num_filters: List[int] = field(default_factory=lambda: [16])
    with_distance: bool = False
    num_input_features: int = 4


@dataclass
class MiddleConfig:
    module_class_name: str = "SpMiddleFHD"
    num_filters_down1: List[int] = field(default_factory=list)
    num_filters_down2: List[int] = field(default_factory=list)
    num_input_features: int = 4
    downsample_factor: int = 8


@dataclass
class RPNConfig:
    module_class_name: str = "RPN"
    layer_nums: List[int] = field(default_factory=lambda: [5])
    layer_strides: List[int] = field(default_factory=lambda: [1])
    num_filters: List[int] = field(default_factory=lambda: [128])
    upsample_strides: List[int] = field(default_factory=lambda: [1])
    num_upsample_filters: List[int] = field(default_factory=lambda: [128])
    use_groupnorm: bool = False
    num_groups: int = 32
    num_input_features: int = 128


@dataclass
class IOUHeadConfig:
    module_class_name: str = "IOU"
    num_filters: List[int] = field(default_factory=lambda: [128, 128])
    num_input_features: int = 128


@dataclass
class ClassificationLossConfig:
    # oneof: weighted_sigmoid | weighted_sigmoid_focal | weighted_softmax |
    #        weighted_softmax_focal | bootstrapped_sigmoid
    kind: str = "weighted_sigmoid_focal"
    alpha: float = 0.25
    gamma: float = 2.0
    anchorwise_output: bool = True
    logit_scale: float = 1.0


@dataclass
class LocalizationLossConfig:
    # oneof: weighted_l2 | weighted_smooth_l1
    kind: str = "weighted_smooth_l1"
    sigma: float = 3.0
    code_weight: List[float] = field(default_factory=list)


@dataclass
class LossConfig:
    classification_loss: ClassificationLossConfig = field(
        default_factory=ClassificationLossConfig)
    localization_loss: LocalizationLossConfig = field(
        default_factory=LocalizationLossConfig)
    classification_weight: float = 1.0
    localization_weight: float = 1.0
    use_iou_loss: bool = False
    iou_loss: ClassificationLossConfig = field(
        default_factory=ClassificationLossConfig)
    iou_loss_weight: float = 1.0
    hard_example_miner: Optional[dict] = None


@dataclass
class BoxCoderConfig:
    # oneof: ground_box3d_coder | bev_box_coder
    kind: str = "ground_box3d_coder"
    linear_dim: bool = False
    encode_angle_vector: bool = False
    z_fixed: float = -1.0   # bev coder only
    h_fixed: float = 2.0    # bev coder only


@dataclass
class AnchorGeneratorConfig:
    # oneof: anchor_generator_stride | anchor_generator_range
    kind: str = "anchor_generator_range"
    sizes: List[float] = field(default_factory=lambda: [1.6, 3.9, 1.56])
    anchor_ranges: List[float] = field(default_factory=list)   # range variant
    strides: List[float] = field(default_factory=list)         # stride variant
    offsets: List[float] = field(default_factory=list)         # stride variant
    rotations: List[float] = field(default_factory=lambda: [0.0, 1.57])
    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45
    class_name: str = "Car"


@dataclass
class SimilarityConfig:
    # oneof: rotate_iou_similarity | nearest_iou_similarity | distance_similarity
    kind: str = "nearest_iou_similarity"
    distance_norm: float = 1.0
    with_rotation: bool = False
    rotation_alpha: float = 0.5


@dataclass
class TargetAssignerConfig:
    anchor_generators: List[AnchorGeneratorConfig] = field(default_factory=list)
    sample_positive_fraction: float = -1.0
    sample_size: int = 512
    use_iou_param_partaa: bool = False
    region_similarity_calculator: SimilarityConfig = field(
        default_factory=SimilarityConfig)


@dataclass
class ModelConfig:
    """model.second message (reference `second.proto` VoxelNet)."""
    voxel_generator: VoxelGeneratorConfig = field(default_factory=VoxelGeneratorConfig)
    voxel_feature_extractor: VFEConfig = field(default_factory=VFEConfig)
    middle_feature_extractor: MiddleConfig = field(default_factory=MiddleConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    use_iou_branch: bool = False
    iou: IOUHeadConfig = field(default_factory=IOUHeadConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    use_sigmoid_score: bool = True
    encode_background_as_zeros: bool = True
    encode_rad_error_by_sin: bool = True
    use_direction_classifier: bool = False
    direction_loss_weight: float = 0.2
    use_aux_classifier: bool = False
    pos_class_weight: float = 1.0
    neg_class_weight: float = 1.0
    loss_norm_type: str = "NormByNumPositives"
    post_center_limit_range: List[float] = field(default_factory=list)
    use_rotate_nms: bool = True
    use_multi_class_nms: bool = False
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 100
    nms_score_threshold: float = 0.3
    nms_iou_threshold: float = 0.01
    use_bev: bool = False
    num_point_features: int = 4
    without_reflectivity: bool = False
    lidar_input: bool = False
    box_coder: BoxCoderConfig = field(default_factory=BoxCoderConfig)
    target_assigner: TargetAssignerConfig = field(default_factory=TargetAssignerConfig)


@dataclass
class SamplerGroupConfig:
    name_to_max_num: Dict[str, int] = field(default_factory=dict)


@dataclass
class DBPrepStepConfig:
    # oneof: filter_by_difficulty | filter_by_min_num_points
    kind: str = "filter_by_difficulty"
    removed_difficulties: List[int] = field(default_factory=list)
    min_num_point_pairs: Dict[str, int] = field(default_factory=dict)


@dataclass
class SamplerConfig:
    database_info_path: str = ""
    sample_groups: List[SamplerGroupConfig] = field(default_factory=list)
    database_prep_steps: List[DBPrepStepConfig] = field(default_factory=list)
    global_random_rotation_range_per_object: List[float] = field(default_factory=list)
    rate: float = 1.0


@dataclass
class InputReaderConfig:
    batch_size: int = 4
    max_num_epochs: int = 160
    prefetch_size: int = 25
    max_number_of_voxels: int = 16000
    shuffle_points: bool = False
    num_workers: int = 8
    groundtruth_localization_noise_std: List[float] = field(default_factory=list)
    groundtruth_rotation_uniform_noise: List[float] = field(default_factory=list)
    global_rotation_uniform_noise: List[float] = field(default_factory=list)
    global_scaling_uniform_noise: List[float] = field(default_factory=list)
    global_random_rotation_range_per_object: List[float] = field(default_factory=list)
    anchor_area_threshold: float = -1.0
    remove_points_after_sample: bool = False
    groundtruth_points_drop_percentage: float = 0.0
    groundtruth_drop_max_keep_points: int = 15
    remove_unknown_examples: bool = False
    remove_environment: bool = False
    unlabeled_training: bool = False
    use_group_id: bool = False
    kitti_info_path: str = ""
    kitti_root_path: str = ""
    database_sampler: Optional[SamplerConfig] = None


@dataclass
class LearningRateConfig:
    # oneof: multi_phase | one_cycle | manual_stepping
    kind: str = "manual_stepping"
    # manual_stepping
    boundaries: List[float] = field(default_factory=list)
    rates: List[float] = field(default_factory=lambda: [1e-4])
    # one_cycle
    lr_max: float = 2.25e-3
    moms: List[float] = field(default_factory=lambda: [0.95, 0.85])
    div_factor: float = 10.0
    pct_start: float = 0.4
    # multi_phase
    phases: List[dict] = field(default_factory=list)


@dataclass
class OptimizerConfig:
    kind: str = "adam_optimizer"  # oneof: rms_prop | momentum | adam
    learning_rate: LearningRateConfig = field(default_factory=LearningRateConfig)
    weight_decay: float = 0.0001
    amsgrad: bool = False
    momentum_optimizer_value: float = 0.9
    decay: float = 0.9
    epsilon: float = 1e-8
    use_moving_average: bool = False
    moving_average_decay: float = 0.0
    fixed_weight_decay: bool = False


@dataclass
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    steps: int = 30950
    steps_per_eval: int = 3095
    save_checkpoints_secs: int = 1800
    save_summary_steps: int = 10
    enable_mixed_precision: bool = False
    loss_scale_factor: float = 512.0
    clear_metrics_every_epoch: bool = True


@dataclass
class PipelineConfig:
    """Top-level TrainEvalPipelineConfig (reference `pipeline.proto:9-15`)."""
    model: ModelConfig = field(default_factory=ModelConfig)
    train_input_reader: InputReaderConfig = field(default_factory=InputReaderConfig)
    train_config: TrainConfig = field(default_factory=TrainConfig)
    eval_input_reader: InputReaderConfig = field(default_factory=InputReaderConfig)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
