"""Build and load the hand-written CUDA kernels in `second_tpu_torch/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by its own
`nvcc` process into `second_tpu_torch/_build/lib<name>-<hash>.so` (the hash
covers the source and the flags), then loaded with `ctypes`. `build()`
starts one `nvcc` per missing library, all together, and waits for them;
`library(name)` builds on first use. Nothing is compiled when this package
is imported: the CPU tests import every module, and the CPU has no `nvcc`.

The Python wrappers beside this file (`gather.py`, `riou.py`, `subm.py`)
mirror `second_tpu/ops/pallas/` by name; `subm.py` also wraps
`csrc/subm_grad.cu`, the sparse conv's weight gradient, and `roi_align.py`
wraps `csrc/roi_align.cu`, the two-stage detector's rotated ROI-align.
Each resolves its C launch functions once, at its first launch
(`function`), and keeps them in a module global, so a launch takes no lock
and looks nothing up.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gather", "riou", "roi_align", "subm", "subm_grad")

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# riou, roi_align: no fused multiply-add, so the clip and the bilinear
# arithmetic round like the plain PyTorch version's separate elementwise ops
_EXTRA_FLAGS = {"riou": ["-fmad=false"], "roi_align": ["-fmad=false"]}

_LOCK = threading.Lock()
_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return str(path)


def _flags(name: str):
    return _FLAGS + _EXTRA_FLAGS.get(name, [])


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one `nvcc` per
    source, all started together. Returns {name: ptxas report} for what was
    compiled; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, errors = {}, []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def build_variant(src, name: str, flags_of: str | None = None,
                  extra=()) -> tuple[ctypes.CDLL, str]:
    """Another version of a kernel source (a parent commit's, a variant's),
    for the scripts that time versions against each other: `src` compiled
    with the port's flags for `flags_of` (by default the source's own
    name) and `extra` into `_build/lib<name>.so`, and loaded. Returns (the
    library, nvcc's output, ptxas's register and spill lines among it);
    raises with that output if the build fails."""
    src = Path(src)
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / f"lib{name}.so"
    cmd = [_nvcc(), *_flags(flags_of or src.stem), *extra, "-o", str(out),
           str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        raise RuntimeError(f"nvcc {src} failed ({done.returncode}):\n{log}")
    return ctypes.CDLL(str(out)), log


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if it is missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C launch function `name` of library `lib` (built and loaded
    first if need be), returning an int CUDA error code, with its argument
    types declared. A wrapper calls this once and keeps the result."""
    fn = getattr(library(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, rc: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc:
        msg = getattr(library(name), f"{name}_error_string")(rc)
        raise RuntimeError(f"CUDA kernel {name} failed: {rc} "
                           f"({msg.decode(errors='replace')})")


def stream_ptr(device: torch.device) -> int:
    """The raw handle of `device`'s current CUDA stream."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through a wrapper that
    has no backward: under grad mode, an input that requires grad. The
    kernels write into fresh tensors, so without this a gradient would
    vanish on the card while the CPU's plain version carried it."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            f"tensors that do not require grad")
