from .textproto import ConfigNode, parse_file, parse_text
from .build import (load_pipeline_config, loads_pipeline_config,
                    build_pipeline_config)
from . import schema

__all__ = ["ConfigNode", "parse_file", "parse_text", "load_pipeline_config",
           "loads_pipeline_config", "build_pipeline_config", "schema"]
