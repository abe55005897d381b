"""A world of CPU processes on one `torch.distributed` group — what the
multi-device tests, `entry.dryrun_multichip` and their helpers share.

    results = run_world("pkg.module:function", world=2, rundir=tmp,
                        args=(...,), deadline=360)

`run_world` starts `world` children of this interpreter (`python -m
second_tpu_torch.parallel.launch RUNDIR RANK`), each on one thread. Each
joins a gloo process group through a `file://` rendezvous in `rundir` (no
TCP port, so concurrent test workers cannot collide), with a timeout on
its collectives, calls `function(*args)` and writes what it returns, with
every tensor turned into numpy, to `rundir` (its output goes to
`rundir/log_<rank>.txt`, with the seconds it took to join the group, to
run `function` and to wait for the other ranks at the end). The parent
joins the children by a deadline: past it, or as soon as one child fails,
it kills them all and raises with the failed child's traceback. It
returns each rank's result, rank 0 first. The children import the named
module and what it imports, nothing of the parent's; `paths` are put
before the package's root on their `sys.path`.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# the children's group: gloo on the CPU (one card cannot hold a world of
# more than one NCCL rank), its collectives timing out after TIMEOUT s: a
# rank that hangs in a collective fails with its traceback before a
# caller's deadline. A rank waits there for the slowest rank, 0.5 s at
# most in the multi-device tests' world on a loaded host (its log's
# "waited"), but a rank's own work between two collectives can take
# tens of seconds there
BACKEND = "gloo"
TIMEOUT = 180.0


def to_numpy(x):
    """x with every tensor in it (nested in dicts, lists and tuples) as a
    numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


def run_world(fn: str, world: int, rundir, args=(), deadline: float = 120.0,
              paths=()):
    """`fn` ("module:function") called in each of `world` processes of a
    gloo group (BACKEND, its collectives timing out after TIMEOUT s); the
    whole world killed and an error raised after `deadline` s. Returns
    [rank 0's result, rank 1's, ...], tensors as numpy."""
    rundir = Path(rundir)
    rundir.mkdir(parents=True, exist_ok=True)
    store = rundir / "rendezvous"
    if store.exists():
        raise FileExistsError(f"run_world: {store} is left from another "
                              f"world; give each world a directory of its "
                              f"own")
    with open(rundir / "job.pkl", "wb") as f:
        pickle.dump(dict(fn=fn, args=tuple(args), world=world), f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [*map(str, paths), str(ROOT),
                    *filter(None, [os.environ.get("PYTHONPATH")])]))
    logs = [open(rundir / f"log_{rank}.txt", "wb") for rank in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "second_tpu_torch.parallel.launch",
         str(rundir), str(rank)], env=env, cwd=str(ROOT),
        stdout=logs[rank], stderr=subprocess.STDOUT)
        for rank in range(world)]
    end = time.monotonic() + deadline
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > end:
                break
            time.sleep(0.05)
        else:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    logs = [(rundir / f"log_{r}.txt").read_text(errors="replace")
            for r in range(world)]
    if failed is not None:
        err = rundir / f"error_{failed}.txt"
        raise RuntimeError(
            f"run_world({fn}): rank {failed} of {world} failed (exit "
            f"{procs[failed].returncode}):\n"
            + (err.read_text() if err.exists() else logs[failed][-4000:]))
    if any(p.returncode for p in procs) or \
            not all((rundir / f"result_{r}.pkl").exists()
                    for r in range(world)):
        raise TimeoutError(
            f"run_world({fn}): the world of {world} did not finish within "
            f"{deadline} s and was killed; its output:\n"
            + "\n".join(f"[rank {r}] {log[-2000:]}"
                        for r, log in enumerate(logs)))
    out = []
    for r in range(world):
        with open(rundir / f"result_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _child(rundir: Path, rank: int) -> int:
    import torch.distributed as dist
    t0 = time.monotonic()
    torch.set_num_threads(1)
    with open(rundir / "job.pkl", "rb") as f:
        job = pickle.load(f)
    try:
        dist.init_process_group(
            BACKEND, init_method=f"file://{rundir / 'rendezvous'}",
            rank=rank, world_size=job["world"],
            timeout=datetime.timedelta(seconds=TIMEOUT))
        t1 = time.monotonic()
        module, name = job["fn"].split(":")
        result = to_numpy(getattr(importlib.import_module(module), name)(
            *job["args"]))
        t2 = time.monotonic()
        # no rank leaves the group before every rank has joined it and
        # returned: a peer that closes its connections early fails the
        # others' (gloo's full mesh is still being connected)
        dist.barrier()
        print(f"run_world: rank {rank} joined in {t1 - t0:.1f} s, ran in "
              f"{t2 - t1:.1f} s, waited {time.monotonic() - t2:.1f} s",
              flush=True)
        tmp = rundir / f"result_{rank}.pkl.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, rundir / f"result_{rank}.pkl")
    except BaseException:
        (rundir / f"error_{rank}.txt").write_text(traceback.format_exc())
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_child(Path(sys.argv[1]), int(sys.argv[2])))


__all__ = ["run_world", "to_numpy"]
