from .pipeline import ExamplePrep, PrepConfig
from .synthetic import lidar_scan_scene, sample_scene

__all__ = ["ExamplePrep", "PrepConfig", "lidar_scan_scene", "sample_scene"]
