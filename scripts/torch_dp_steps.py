"""What a data-parallel train step costs beyond the plain one, on one NVIDIA
card: an NCCL process group of one rank, the fhd `Trainer`'s train step
(second_car_fhd.config, synthetic scans, batch 4, bf16, its Adam) in four
forms, in turns:

    python3 scripts/torch_dp_steps.py [--steps N]   # on the machine with the card

- plain: the Trainer's own step;
- dp: `parallel.mesh.make_dp_train_step` (DDP; at one rank the norms'
  statistics are the rank's own);
- ddp_norms: the same with the norms' statistics all-reduced over the
  group (`sync_norms`), what a step above one rank runs;
- norms: the plain step under `sync_norms` (the norms' all-reduces
  alone).

Prints the median host time of each (synchronised, the first two steps
left out), then for one plain and one ddp_norms step under torch.profiler
the collectives a step launches and the host time they take
(`c10d::allreduce_`, the autograd function around the norms'
all-reduces), and the card's name and power limit. Imports torch, numpy
and the port only.
"""

import argparse
import contextlib
import datetime
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.parallel import mesh  # noqa: E402
from second_tpu_torch.train.run import Trainer  # noqa: E402

CONFIG = ROOT / "second_tpu_torch" / "configs" / "second_car_fhd.config"


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_dp_steps.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    print(f"card: {card_line()}", flush=True)
    kernels.build()
    tmp = Path(tempfile.mkdtemp())
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'r'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=dev)
    try:
        run(dev, tmp, args.steps)
    finally:
        dist.destroy_process_group()


def run(dev, tmp, n):
    group = mesh.make_group()
    trainers, states, batches = {}, {}, {}
    for kind in ("plain", "dp", "ddp_norms", "norms"):
        tr = Trainer(CONFIG, tmp / kind, synthetic=True, dataset_size=8,
                     max_points=30000, device=dev,
                     patches=["train_config.steps_per_eval=0"])
        it = tr._batch_iter(4, np.random.default_rng(0))
        batches[kind] = [next(it) for _ in range(3)]
        states[kind] = tr._init_state()
        trainers[kind] = tr

    def synced(step):
        def run_step(state, batch):
            with mesh.sync_norms(group):
                return step(state, batch)
        return run_step

    @contextlib.contextmanager
    def forced():
        # make_dp_train_step leaves one rank's statistics its own; here
        # every sync_norms block takes the group
        old = mesh.sync_norms
        mesh.sync_norms = lambda g: old(group)
        try:
            yield
        finally:
            mesh.sync_norms = old

    dp_step = mesh.make_dp_train_step(trainers["dp"].train_step, group)
    ddp_step = mesh.make_dp_train_step(trainers["ddp_norms"].train_step,
                                       group)

    def ddp_norms(state, batch):
        with forced():
            return ddp_step(state, batch)

    steps = {"plain": trainers["plain"].train_step, "dp": dp_step,
             "ddp_norms": ddp_norms,
             "norms": synced(trainers["norms"].train_step)}
    times = {k: [] for k in steps}
    for i in range(n):
        for kind, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(states[kind], batches[kind][i % 3])
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
    for kind, t in times.items():
        print(f"{kind}: median {1e3 * statistics.median(t[2:]):.2f} ms a "
              f"step over {n - 2} steps", flush=True)
    from torch.profiler import ProfilerActivity, profile
    for kind in ("plain", "ddp_norms"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps[kind](states[kind], batches[kind][0])
            torch.cuda.synchronize()
        by = {e.key: e for e in prof.key_averages()}
        total = sum(e.self_cpu_time_total for e in by.values()) / 1e3
        line = [f"{kind} (profiled): host {total:.2f} ms"]
        for key in ("c10d::allreduce_", "nccl:all_reduce", "_SumRanks",
                    "_SumRanksBackward", "record_param_comms"):
            if key in by:
                e = by[key]
                line.append(f"{key} x{e.count} {e.cpu_time_total / 1e3:.2f}"
                            f" ms")
        print("; ".join(line), flush=True)


if __name__ == "__main__":
    with torch.no_grad():
        main()
