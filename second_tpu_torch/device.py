"""Device resolution for the port's entry points.

Entry points default to the CUDA card. Asking for it where there is none
raises instead of carrying on on the CPU: a CPU run must be asked for by
name (`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "second_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
