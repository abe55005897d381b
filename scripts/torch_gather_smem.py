"""Gather-to-shared-memory throughput on one NVIDIA card.

    python3 scripts/torch_gather_smem.py      # on the machine with the card

Builds scripts/torch_gather_smem.cu with nvcc (sm_90a) into
second_tpu_torch/_build/ and gathers 432 220 rows (the found taps of the
largest fhd train weight-gradient call) of 64 and 128 bytes (32 and 64 bf16
channels) from a 4 MB source into 64-row shared-memory tiles, by random and
by sequential indices, per method (16-byte cp.async, one cp.async.bulk a
row, 16-byte vector loads), ring depth, blocks and threads per SM and SMs
used. Prints the median of 10 launches (L2 warm) and the rate. Imports
torch and the port's build helpers only.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from second_tpu_torch.ops.cuda import BUILD_DIR, _nvcc  # noqa: E402

ROWS = 432_220


def build():
    BUILD_DIR.mkdir(exist_ok=True)
    lib = BUILD_DIR / "libtorch_gather_smem.so"
    out = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
         str(ROOT / "scripts" / "torch_gather_smem.cu")],
        capture_output=True, text=True)
    if out.returncode:
        sys.exit(out.stdout + out.stderr)
    fn = ctypes.CDLL(str(lib)).gbench_run
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    fn = build()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(4, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), f"{sms} SMs")
    for rb in (64, 128):
        R = (4 << 20) // rb
        src = torch.randint(0, 1 << 20, (R * rb // 4,), dtype=torch.int32,
                            device=dev)
        for order in ("random", "seq"):
            idx = (torch.randint(0, R, (ROWS,), device=dev)
                   if order == "random"
                   else torch.arange(ROWS, device=dev) % R).int()
            for mode, stages, bps, threads, used in [
                    (0, 4, 3, 128, sms), (0, 8, 3, 128, sms),
                    (0, 4, 6, 128, sms), (0, 4, 3, 256, sms),
                    (0, 4, 3, 128, sms // 4), (1, 4, 3, 128, sms),
                    (1, 8, 3, 128, sms), (1, 4, 6, 128, sms),
                    (1, 4, 3, 128, sms // 4), (2, 1, 3, 128, sms),
                    (2, 1, 8, 256, sms)]:
                def call():
                    return fn(mode, stages, src.data_ptr(), idx.data_ptr(),
                              ROWS, rb, out.data_ptr(), bps * used, threads,
                              stream)
                if call():
                    sys.exit("launch failed")
                torch.cuda.synchronize()
                pairs = []
                for _ in range(10):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    pairs.append((a, b))
                torch.cuda.synchronize()
                ms = statistics.median(a.elapsed_time(b) for a, b in pairs)
                name = ("cp.async16", "bulk/row", "ldg.v4")[mode]
                print(f"rb {rb:3d} {order:6s} {name:10s} stages {stages} "
                      f"blocks/SM {bps} threads {threads} SMs {used:3d}: "
                      f"{ms * 1e3:8.2f} us {ROWS * rb / ms / 1e9:7.3f} TB/s")


if __name__ == "__main__":
    main()
