"""Middle feature extractors: voxel features → dense BEV maps — the port of
`second_tpu/models/middle.py`'s registry. The sparse middles register
themselves from `sparse_middle.py`."""

from __future__ import annotations

MIDDLE_REGISTRY = {}


def register_middle(name, cls):
    MIDDLE_REGISTRY[name] = cls
    return cls
