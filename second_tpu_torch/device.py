"""Device resolution for the port's entry points, device constants, and
the compute dtype of a reference run.

Entry points default to the CUDA card. Asking for it where there is none
raises instead of carrying on on the CPU: a CPU run must be asked for by
name (`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "second_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def constant(values, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(values, dtype=dtype, device=device)` for a small
    Python or numpy constant (offsets, grid sizes, strides, ranges), made
    once per value, dtype and device and kept. A copy from pageable host
    memory to the card waits for the stream to drain, so per-call code that
    made its constants anew synchronised the host with the card at each of
    them. The tensors are shared: callers must not write to them."""
    arr = np.asarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(values, dtype=dtype,
                                              device=device)
    return t


def at_least_fp32(x):
    """x in fp32, or as it is in fp64: the norms, the heads and the plain
    sparse-conv sums compute in fp32 whatever the trunk's dtype, and an
    fp64 model (a reference run) stays fp64."""
    return x if x.dtype == torch.float64 else x.float()
