"""The sparse-conv kernels of this tree against other versions, on one card.

    python3 scripts/torch_wide_kernels.py --parent_src SUBM_CU \
        --parent_grad_src SUBM_GRAD_CU [--grad_variant NAME=SUBM_GRAD_CU ...]

SUBM_CU and SUBM_GRAD_CU are the parent's `subm.cu` and `subm_grad.cu`
with the C entries `subm_gather_gemm_mma` / `subm_gather_gemm_fma` (whose
packed-width argument is log2 CP, as before the kernels took any width:
the script passes it so) and `subm_wgrad`, unpacked with `git show`. Each
`--grad_variant` is another `subm_grad.cu` with this tree's `subm_wgrad`
entry, for instance an earlier version of the 128-channel tiling.

The script captures the SECOND car.fhd eval forward's 14 bf16 gather-GEMM
calls (chip_smoke.py's fhd inputs), the fhd train step's 14 bf16
weight-gradient calls (chip_smoke.py's train batch), and the fp32 forward
and weight-gradient calls of SpMiddleFHDLarge's train step (chip_smoke.py's
LARGE_PATCHES), the weight gradients of 64 channels at most and those over
64 as two sets: every call at most 128 channels wide, the widths the
parent took. It builds the other sources into `second_tpu_torch/_build/`
under other names with this tree's flags, checks that every version gives
this tree's bits on every call, and times each set with each version in
turns (the versions in
order, then reversed, twice): device-only ms from chip_smoke.py's
DeviceTimer (L2 flushed before each call, median of 5), summed over the
set. It prints the card's name and power limit, and the registers and
spills of each build's weight-gradient instantiations.
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.models import build_voxelnet, detect  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import subm  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import make_train_step  # noqa: E402


def wgrad_stats(log: str):
    """'instantiation: registers, spill stores / loads' for each
    weight-gradient kernel in an nvcc log (names demangled where c++filt
    is found)."""
    demangle = shutil.which("c++filt")
    out, name, spills = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True,
                                      text=True).stdout.strip()
            name = name.replace("(anonymous namespace)::", "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name and "wgrad_kernel" in name:
            spills = f"{m.group(1)} / {m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and "wgrad_kernel" in name:
            out.append(f"{name}: {m.group(1)} registers, spills {spills}")
    return out


def captured(dev):
    """(fhd eval forward convs, the large middle's fp32 forward convs, fhd
    train weight gradients, the large middle's fp32 weight gradients of at
    most and over 64 channels)."""
    cfg = load_pipeline_config(cs.CONFIG)
    with torch.no_grad():
        net, spec, info, assigner, _ = build_voxelnet(
            cfg.model, device=dev, mixed_precision=True, seed=0)
        vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                         cs.MAX_VOXELS)
        points, mask, anchors = cs.build_inputs(cfg, assigner, info, dev)
        with cs.recording() as calls:
            detect(net, spec, vspec, points, mask, anchors, device=dev)
            torch.cuda.synchronize()
    convs = [a for a, _ in calls["gather_gemm"]]
    del net
    torch.backends.cudnn.deterministic = True
    sets, large_convs = [], []
    for patches in ((), cs.LARGE_PATCHES):
        pcfg = cs.patched_config(patches) if patches else cfg
        state, spec, info, assigner = cs.new_train_state(
            pcfg, dev, pcfg.train_config.enable_mixed_precision)
        tvspec = VoxelizeSpec.from_config(pcfg.model.voxel_generator,
                                          cs.TRAIN_VOXELS,
                                          shuffle_overflow=True)
        batch = cs.train_inputs(pcfg, assigner, info, dev, cs.TRAIN_BATCH)
        with cs.recording(cs.RECORDED_TRAIN) as calls:
            make_train_step(spec, tvspec)(state, batch)
            torch.cuda.synchronize()
        sets.append(calls["sparse_wgrad"])
        large_convs = [a for a, _ in calls["gather_gemm"]]
        del state
    narrow32, wide = cs.split_wide(sets[1])
    return convs, large_convs, *([a for a, _ in s]
                                 for s in (sets[0], narrow32, wide))


def shift_entry(fn):
    """A gather-GEMM entry that takes log2 CP (the parent's) as one that
    takes CP (this tree's wrapper passes CP)."""
    def call(*a):
        a = list(a)
        a[10] = int(a[10]).bit_length() - 1
        return fn(*a)
    return call


def in_turns(dt, fns, wrapper, calls, launch):
    """{version: [device ms of `wrapper` summed over the calls] x 4}, the
    versions in order, reversed, in order, reversed; `launch(fn)` makes a
    version's function the one the wrapper launches."""
    order = list(fns) + list(fns)[::-1]
    times = {tag: [] for tag in fns}
    for tag in order + order:
        launch(fns[tag])
        times[tag].append(sum(dt([lambda a=a: wrapper(*a) for a in calls])))
    return times


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path, required=True,
                        help="the parent's subm.cu")
    parser.add_argument("--parent_grad_src", type=Path, required=True,
                        help="the parent's subm_grad.cu")
    parser.add_argument("--grad_variant", action="append", default=[],
                        metavar="NAME=SUBM_GRAD_CU",
                        help="another subm_grad.cu with this tree's entry")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}")
    logs = kernels.build(("subm", "subm_grad"))
    srcs = {"parent_subm": args.parent_src,
            "parent": args.parent_grad_src,
            **dict(v.split("=", 1) for v in args.grad_variant)}
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = dict(zip(srcs, ex.map(
            lambda kv: kernels.build_variant(kv[1], f"other_{kv[0]}",
                                             "subm_grad" if kv[0] !=
                                             "parent_subm" else "subm"),
            srcs.items())))
    for ln in wgrad_stats(logs.get("subm_grad", "")):
        print(f"ptxas this: {ln}")
    for tag, (_, log) in built.items():
        for ln in wgrad_stats(log):
            print(f"ptxas {tag}: {ln}")

    this_mma, this_wgrad = subm._resolve_mma(), subm._resolve_wgrad()
    this_fma = subm._resolve_fma()
    others = {}
    for entry in ("mma", "fma"):
        fn = getattr(built["parent_subm"][0], f"subm_gather_gemm_{entry}")
        fn.argtypes, fn.restype = subm._MMA_ARGTYPES, ctypes.c_int
        others[entry] = shift_entry(fn)
    other_mma, other_fma = others["mma"], others["fma"]
    wgrads = {"this": this_wgrad}
    for tag, (lib, _) in built.items():
        if tag != "parent_subm":
            fn = lib.subm_wgrad
            fn.argtypes, fn.restype = subm._WGRAD_ARGTYPES, ctypes.c_int
            wgrads[tag] = fn

    convs, large_convs, fhd, narrow32, wide = captured(dev)
    print(f"calls: {len(convs)} forward convs "
          f"{sorted({(a[0].shape[2], a[3].shape[2]) for a in convs})}, "
          f"{len(large_convs)} large train fp32 forward convs "
          f"{sorted({(a[0].shape[2], a[3].shape[2]) for a in large_convs})}; "
          f"weight gradients: fhd train {len(fhd)} bf16, large train "
          f"{len(narrow32)} fp32 of 64 channels at most and {len(wide)} "
          f"over 64 {sorted({(a[0].shape[2], a[3].shape[2]) for a in wide})}")

    def use_mma(fn):
        subm._mma_launch = fn

    def use_fma(fn):
        subm._fma_launch = fn

    def use_wgrad(fn):
        subm._wgrad_launch = fn

    with torch.no_grad():
        dt = cs.DeviceTimer(dev)
        outs = {}
        for tag, fn in (("this", this_mma), ("parent", other_mma)):
            use_mma(fn)
            outs[tag] = [subm.gather_gemm(*a) for a in convs]
        same = sum(torch.equal(x, y) for x, y in zip(outs["this"],
                                                     outs["parent"]))
        print(f"bits forward: parent {same} of {len(convs)} calls equal")
        times = in_turns(dt, {"this": this_mma, "parent": other_mma},
                         subm.gather_gemm, convs, use_mma)
        for tag, ts in times.items():
            print(f"forward {tag}: " + " ".join(f"{t:.4f}" for t in ts) +
                  " ms (device, summed over the calls)")
        use_mma(this_mma)
        outs = {}
        for tag, fn in (("this", this_fma), ("parent", other_fma)):
            use_fma(fn)
            outs[tag] = [subm.gather_gemm(*a) for a in large_convs]
        same = sum(torch.equal(x, y) for x, y in zip(outs["this"],
                                                     outs["parent"]))
        print(f"bits large train fp32 forward: parent {same} of "
              f"{len(large_convs)} calls equal")
        times = in_turns(dt, {"this": this_fma, "parent": other_fma},
                         subm.gather_gemm, large_convs, use_fma)
        for tag, ts in times.items():
            print(f"large train fp32 forward {tag}: " +
                  " ".join(f"{t:.4f}" for t in ts) +
                  " ms (device, summed over the calls)")
        use_fma(this_fma)
        for what, calls in (("fhd train bf16", fhd),
                            ("large train fp32 <= 64", narrow32),
                            ("large train fp32 > 64", wide)):
            fns = wgrads
            outs = {}
            for tag, fn in fns.items():
                use_wgrad(fn)
                outs[tag] = [subm.sparse_wgrad(*a) for a in calls]
            print(f"bits weight gradient, {what}: " + ", ".join(
                f"{tag} {sum(torch.equal(x, y) for x, y in zip(o, outs['this']))}"
                f" of {len(calls)}" for tag, o in outs.items()
                if tag != "this"))
            times = in_turns(dt, fns, subm.sparse_wgrad, calls, use_wgrad)
            for tag, ts in times.items():
                print(f"weight gradient, {what}, {tag}: " +
                      " ".join(f"{t:.4f}" for t in ts) +
                      " ms (device, summed over the calls)")
        use_wgrad(this_wgrad)


if __name__ == "__main__":
    main()
