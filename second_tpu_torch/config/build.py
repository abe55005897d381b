"""ConfigNode → typed schema conversion.

`load_pipeline_config(path)` is the framework's equivalent of the reference's
`text_format.Merge` into `TrainEvalPipelineConfig` (`second/pytorch/train.py:115-118`):
it accepts the reference's `.config` files verbatim.
"""

from __future__ import annotations

from typing import Any, List

from . import schema
from .textproto import ConfigNode, parse_file, parse_text


def _as_list(val: Any) -> List:
    if val is None:
        return []
    if isinstance(val, list):
        return list(val)
    return [val]


def _fill(node: ConfigNode | None, obj, fields: dict):
    """Populate dataclass `obj` attributes from scalar fields of `node`.

    `fields` maps config field name -> attribute name (or None for same name).
    List-valued dataclass defaults force list conversion.
    """
    if node is None:
        return obj
    for key, attr in fields.items():
        attr = attr or key
        if key in node:
            cur = getattr(obj, attr)
            val = node.get(key)
            if isinstance(cur, list):
                setattr(obj, attr, _as_list(val))
            else:
                setattr(obj, attr, val)
    return obj


def _oneof(node: ConfigNode | None, names: List[str], default: str) -> tuple:
    """Return (kind, sub_node) for a oneof-style message field."""
    if node is None:
        return default, None
    for name in names:
        sub = node.get(name)
        if isinstance(sub, ConfigNode):
            return name, sub
    return default, None


def _classification_loss(node: ConfigNode | None) -> schema.ClassificationLossConfig:
    cfg = schema.ClassificationLossConfig()
    kind, sub = _oneof(node, [
        "weighted_sigmoid_focal", "weighted_softmax_focal", "weighted_sigmoid",
        "weighted_softmax", "bootstrapped_sigmoid"], cfg.kind)
    cfg.kind = kind
    _fill(sub, cfg, {"alpha": None, "gamma": None, "anchorwise_output": None,
                     "logit_scale": None})
    return cfg


def _localization_loss(node: ConfigNode | None) -> schema.LocalizationLossConfig:
    cfg = schema.LocalizationLossConfig()
    kind, sub = _oneof(node, ["weighted_smooth_l1", "weighted_l2"], cfg.kind)
    cfg.kind = kind
    _fill(sub, cfg, {"sigma": None, "code_weight": None})
    return cfg


def _loss(node: ConfigNode | None) -> schema.LossConfig:
    cfg = schema.LossConfig()
    if node is None:
        return cfg
    cfg.classification_loss = _classification_loss(node.child("classification_loss"))
    cfg.localization_loss = _localization_loss(node.child("localization_loss"))
    cfg.iou_loss = _classification_loss(node.child("iou_loss"))
    _fill(node, cfg, {"classification_weight": None, "localization_weight": None,
                      "use_iou_loss": None, "iou_loss_weight": None})
    return cfg


def _box_coder(node: ConfigNode | None) -> schema.BoxCoderConfig:
    cfg = schema.BoxCoderConfig()
    kind, sub = _oneof(node, ["ground_box3d_coder", "bev_box_coder"], cfg.kind)
    cfg.kind = kind
    _fill(sub, cfg, {"linear_dim": None, "encode_angle_vector": None,
                     "z_fixed": None, "h_fixed": None})
    return cfg


def _anchor_generator(node: ConfigNode) -> schema.AnchorGeneratorConfig:
    cfg = schema.AnchorGeneratorConfig()
    kind, sub = _oneof(node, ["anchor_generator_range", "anchor_generator_stride"],
                       cfg.kind)
    cfg.kind = kind
    _fill(sub, cfg, {
        "sizes": None, "anchor_ranges": None, "strides": None, "offsets": None,
        "rotations": None, "matched_threshold": None, "unmatched_threshold": None,
        "class_name": None})
    return cfg


def _similarity(node: ConfigNode | None) -> schema.SimilarityConfig:
    cfg = schema.SimilarityConfig()
    kind, sub = _oneof(node, ["nearest_iou_similarity", "rotate_iou_similarity",
                              "distance_similarity"], cfg.kind)
    cfg.kind = kind
    _fill(sub, cfg, {"distance_norm": None, "with_rotation": None,
                     "rotation_alpha": None})
    return cfg


def _target_assigner(node: ConfigNode | None) -> schema.TargetAssignerConfig:
    cfg = schema.TargetAssignerConfig()
    if node is None:
        return cfg
    cfg.anchor_generators = [
        _anchor_generator(ag) for ag in node.get_all("anchor_generators")
        if isinstance(ag, ConfigNode)]
    cfg.region_similarity_calculator = _similarity(
        node.child("region_similarity_calculator"))
    _fill(node, cfg, {"sample_positive_fraction": None, "sample_size": None,
                      "use_iou_param_partaa": None})
    return cfg


def build_model_config(node: ConfigNode | None) -> schema.ModelConfig:
    cfg = schema.ModelConfig()
    if node is None:
        return cfg
    cfg.voxel_generator = _fill(
        node.child("voxel_generator"), schema.VoxelGeneratorConfig(),
        {"point_cloud_range": None, "voxel_size": None,
         "max_number_of_points_per_voxel": None})
    cfg.voxel_feature_extractor = _fill(
        node.child("voxel_feature_extractor"), schema.VFEConfig(),
        {"module_class_name": None, "num_filters": None, "with_distance": None,
         "num_input_features": None})
    cfg.middle_feature_extractor = _fill(
        node.child("middle_feature_extractor"), schema.MiddleConfig(),
        {"module_class_name": None, "num_filters_down1": None,
         "num_filters_down2": None, "num_input_features": None,
         "downsample_factor": None})
    cfg.rpn = _fill(
        node.child("rpn"), schema.RPNConfig(),
        {"module_class_name": None, "layer_nums": None, "layer_strides": None,
         "num_filters": None, "upsample_strides": None,
         "num_upsample_filters": None, "use_groupnorm": None, "num_groups": None,
         "num_input_features": None})
    cfg.iou = _fill(
        node.child("iou"), schema.IOUHeadConfig(),
        {"module_class_name": None, "num_filters": None, "num_input_features": None})
    cfg.loss = _loss(node.child("loss"))
    cfg.box_coder = _box_coder(node.child("box_coder"))
    cfg.target_assigner = _target_assigner(node.child("target_assigner"))
    _fill(node, cfg, {
        "use_iou_branch": None, "use_sigmoid_score": None,
        "encode_background_as_zeros": None, "encode_rad_error_by_sin": None,
        "use_direction_classifier": None, "direction_loss_weight": None,
        "use_aux_classifier": None,
        "pos_class_weight": "pos_class_weight", "neg_class_weight": None,
        "loss_norm_type": None, "post_center_limit_range": None,
        "use_rotate_nms": None, "use_multi_class_nms": None,
        "nms_pre_max_size": None, "nms_post_max_size": None,
        "nms_score_threshold": None, "nms_iou_threshold": None,
        "use_bev": None, "num_point_features": None, "without_reflectivity": None,
        "lidar_input": None})
    return cfg


def _sampler(node: ConfigNode | None) -> schema.SamplerConfig | None:
    if node is None:
        return None
    cfg = schema.SamplerConfig()
    _fill(node, cfg, {"database_info_path": None, "rate": None,
                      "global_random_rotation_range_per_object": None})
    for grp in node.get_all("sample_groups"):
        if not isinstance(grp, ConfigNode):
            continue
        g = schema.SamplerGroupConfig()
        for pair in grp.get_all("name_to_max_num"):
            if isinstance(pair, ConfigNode):
                g.name_to_max_num[pair.get("key")] = pair.get("value")
        cfg.sample_groups.append(g)
    for step in node.get_all("database_prep_steps"):
        if not isinstance(step, ConfigNode):
            continue
        s = schema.DBPrepStepConfig()
        kind, sub = _oneof(step, ["filter_by_difficulty", "filter_by_min_num_points"],
                           s.kind)
        s.kind = kind
        if sub is not None:
            s.removed_difficulties = _as_list(sub.get("removed_difficulties"))
            for pair in sub.get_all("min_num_point_pairs"):
                if isinstance(pair, ConfigNode):
                    s.min_num_point_pairs[pair.get("key")] = pair.get("value")
        cfg.database_prep_steps.append(s)
    return cfg


def build_input_reader_config(node: ConfigNode | None) -> schema.InputReaderConfig:
    cfg = schema.InputReaderConfig()
    if node is None:
        return cfg
    _fill(node, cfg, {
        "batch_size": None, "max_num_epochs": None, "prefetch_size": None,
        "max_number_of_voxels": None, "shuffle_points": None, "num_workers": None,
        "groundtruth_localization_noise_std": None,
        "groundtruth_rotation_uniform_noise": None,
        "global_rotation_uniform_noise": None,
        "global_scaling_uniform_noise": None,
        "global_random_rotation_range_per_object": None,
        "anchor_area_threshold": None, "remove_points_after_sample": None,
        "groundtruth_points_drop_percentage": None,
        "groundtruth_drop_max_keep_points": None,
        "remove_unknown_examples": None, "remove_environment": None,
        "unlabeled_training": None, "use_group_id": None,
        "kitti_info_path": None, "kitti_root_path": None})
    cfg.database_sampler = _sampler(node.child("database_sampler"))
    return cfg


def _learning_rate(node: ConfigNode | None) -> schema.LearningRateConfig:
    cfg = schema.LearningRateConfig()
    kind, sub = _oneof(node, ["manual_stepping", "one_cycle", "multi_phase"], cfg.kind)
    cfg.kind = kind
    if kind == "multi_phase" and sub is not None:
        cfg.phases = [p.to_dict() for p in sub.get_all("phases")
                      if isinstance(p, ConfigNode)]
    _fill(sub, cfg, {"boundaries": None, "rates": None, "lr_max": None,
                     "moms": None, "div_factor": None, "pct_start": None})
    return cfg


def build_optimizer_config(node: ConfigNode | None) -> schema.OptimizerConfig:
    cfg = schema.OptimizerConfig()
    if node is None:
        return cfg
    kind, sub = _oneof(node, ["adam_optimizer", "momentum_optimizer",
                              "rms_prop_optimizer"], cfg.kind)
    cfg.kind = kind
    if sub is not None:
        cfg.learning_rate = _learning_rate(sub.child("learning_rate"))
        _fill(sub, cfg, {"weight_decay": None, "amsgrad": None,
                         "momentum_optimizer_value": None, "decay": None,
                         "epsilon": None})
    _fill(node, cfg, {"use_moving_average": None, "moving_average_decay": None,
                      "fixed_weight_decay": None})
    return cfg


def build_train_config(node: ConfigNode | None) -> schema.TrainConfig:
    cfg = schema.TrainConfig()
    if node is None:
        return cfg
    cfg.optimizer = build_optimizer_config(node.child("optimizer"))
    _fill(node, cfg, {
        "steps": None, "steps_per_eval": None, "save_checkpoints_secs": None,
        "save_summary_steps": None, "enable_mixed_precision": None,
        "loss_scale_factor": None, "clear_metrics_every_epoch": None})
    return cfg


def build_pipeline_config(tree: ConfigNode) -> schema.PipelineConfig:
    cfg = schema.PipelineConfig()
    cfg.model = build_model_config(tree.child("model", "second"))
    cfg.train_input_reader = build_input_reader_config(tree.child("train_input_reader"))
    cfg.train_config = build_train_config(tree.child("train_config"))
    cfg.eval_input_reader = build_input_reader_config(tree.child("eval_input_reader"))
    return cfg


def load_pipeline_config(path) -> schema.PipelineConfig:
    return build_pipeline_config(parse_file(path))


def loads_pipeline_config(text: str) -> schema.PipelineConfig:
    return build_pipeline_config(parse_text(text))
