"""The greedy suppression kernel on the eval paths' real calls, on one card:
its device time beside an empty launch of the same shape, and beside the
parent's kernel in turns.

    python3 scripts/torch_nms_suppress.py [--parent_src RIOU_CU]

Captures the `nms_suppress` calls of one eval forward of each path that
chip_smoke.py drives: fhd (second_car_fhd.config, batch 4, K 1000), pp
(pointpillars_car.config, norms calibrated, batch 4, K 1000), mc
(second_multiclass.config, fp32, 9 example-class rows, K 1000) and 2st
(the two-stage detector on second_car_fhd.config: the proposals' standup
NMS at K 2048, and the refined proposals' rotated NMS at K 512). For each
call it prints:

- rows, K, whether the bitmask fits shared memory (staged), the kept rows
  and overlaps, and the keep set against `nms_suppress_plain` (exact);
- the walk's work: the words, and the rounds of ballots they take to
  settle (`nms_suppress_walk_plain`'s count, on the CPU);
- its bound: the bitmask and the valid flags read once, keep written
  (chip_smoke's count), over the card's memory rate;
- device times (torch.profiler, REPS calls each after an L2 flush): the
  port's kernel; an empty kernel launched with the same grid (a block of
  1024 threads a row), the floor of a latency-bound launch; and with
  `--parent_src` (the parent's riou.cu, unpacked with git into a
  gitignored directory, built with the port's flags for riou) the
  parent's kernel, in turns: parent, port, staging, empty and back;
  and a build of this tree's riou.cu with NMS_SUPPRESS_STAGE_ONLY defined
  (the staging of the bitmask and the diagonal blocks' transposes alone),
  which splits the port's time into those and the walk. A variant of
  the kernel (another helper count, say) is timed the same way: pass a
  changed copy of riou.cu as `--parent_src`.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.models import build_voxelnet, detect  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import riou  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import TrainState  # noqa: E402
from second_tpu_torch.train.steps_multistage import \
    make_two_stage_steps  # noqa: E402

REPS = 9
EMPTY_CU = """
extern "C" __global__ void nms_empty_kernel() {}
extern "C" int nms_empty(int batch, void* stream) {
  nms_empty_kernel<<<batch, 1024, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch():
    """An empty kernel of a suppression's grid: (batch, stream) → None."""
    src = kernels.BUILD_DIR / "nms_empty.cu"
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    src.write_text(EMPTY_CU)
    fn = kernels.build_variant(src, "nms_empty", "gather")[0].nms_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(bits):
        rc = fn(bits.shape[0], kernels.stream_ptr(bits.device))
        if rc:
            sys.exit(f"the empty launch failed: CUDA error {rc}")
    return launch


def suppressor(lib):
    """The `nms_suppress` entry of a built riou.cu as a function (bits,
    valid) → keep."""
    fn = lib.nms_suppress
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def suppress(bits, valid):
        keep = torch.empty(valid.shape, dtype=torch.bool, device=bits.device)
        rc = fn(bits.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                valid.shape[0], valid.shape[1],
                kernels.stream_ptr(bits.device))
        if rc:
            sys.exit(f"a build's suppression failed: CUDA error {rc}")
        return keep
    return suppress


def this_tree(name, macros):
    """This tree's riou.cu built with the port's flags and these macros."""
    return kernels.build_variant(kernels.CSRC / "riou.cu", name, "riou",
                                 [f"-D{m}" for m in macros])[0]


def captured(dev):
    """{path: [(bits, valid), ...]}: the suppression calls of one eval
    forward of each path."""
    out = {}
    with torch.no_grad():
        for path, config, n in (("fhd", cs.CONFIG, cs.BATCH),
                                ("mc", cs.MC_CONFIG, None)):
            cfg = load_pipeline_config(config)
            reader = cfg.eval_input_reader
            net, spec, info, assigner, _ = build_voxelnet(
                cfg.model, device=dev,
                mixed_precision=cfg.train_config.enable_mixed_precision)
            voxels = cs.MAX_VOXELS if n else reader.max_number_of_voxels
            vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                             voxels)
            points, mask, anchors = cs.build_inputs(
                cfg, assigner, info, dev, n or reader.batch_size)
            with cs.recording([(riou, "nms_suppress")]) as calls:
                detect(net, spec, vspec, points, mask, anchors, device=dev)
                torch.cuda.synchronize()
            out[path] = [a for a, _ in calls["nms_suppress"]]
        cfg = load_pipeline_config(cs.PP_CONFIG)
        net, spec, info, assigner, _ = build_voxelnet(
            cfg.model, device=dev,
            mixed_precision=cfg.train_config.enable_mixed_precision)
        vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                         cs.PP_VOXELS)
        _, (points, mask, anchors), mask_info = cs.pp_eval_inputs(
            cfg, assigner, info, dev)
        cs.calibrated(net, vspec, points, mask, dev)
        with cs.recording([(riou, "nms_suppress")]) as calls:
            detect(net, spec, vspec, points, mask, anchors, device=dev,
                   mask_info=mask_info)
            torch.cuda.synchronize()
        out["pp"] = [a for a, _ in calls["nms_suppress"]]
        cfg = load_pipeline_config(cs.CONFIG)
        net, spec, info, assigner, _ = cs.build_two_stage(cfg.model, dev)
        vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                         cs.MAX_VOXELS)
        points, mask, anchors = cs.build_inputs(cfg, assigner, info, dev)
        with cs.recording([(riou, "nms_suppress")]) as calls:
            make_two_stage_steps(spec, vspec)[1](
                TrainState(net, None),
                {"points": points, "points_mask": mask, "anchors": anchors})
            torch.cuda.synchronize()
        out["2st"] = [a for a, _ in calls["nms_suppress"]]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path,
                        help="the parent's riou.cu, whose suppression to "
                        "time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    calls = captured(dev)
    empty = empty_launch()
    stage = suppressor(this_tree("riou_stage", ["NMS_SUPPRESS_STAGE_ONLY"]))
    others = {}
    if args.parent_src:
        others["parent"] = suppressor(kernels.build_variant(
            args.parent_src, "riou_parent", "riou")[0])
    staged_k = kernels.library("riou").nms_suppress_staged
    dtimer = cs.DeviceTimer(dev)
    for path, path_calls in calls.items():
        for i, (bits, valid) in enumerate(path_calls):
            B, K = valid.shape
            keep = riou.nms_suppress(bits, valid)
            want = riou.nms_suppress_plain(bits, valid)
            torch.cuda.synchronize()
            if not torch.equal(keep, want):
                sys.exit(f"{path} {i}: keep differs from the plain version")
            staged = bool(staged_k(K))
            rounds = []
            if not torch.equal(riou.nms_suppress_walk_plain(
                    bits.cpu(), valid.cpu(), rounds), keep.cpu()):
                sys.exit(f"{path} {i}: the walk mirror's keep differs")
            busy = [n for n in rounds if n]
            nbytes = bits.numel() * 4 + 2 * valid.numel()
            line = (f"{path} nms_suppress {i}: rows {B}, K {K} "
                    f"({'staged' if staged else 'read in place'}), valid "
                    f"{valid.sum(1).tolist()}, kept {keep.sum(1).tolist()}, "
                    f"overlaps {int(riou.unpack_bits(bits, K).sum())}; "
                    f"keep exact; {len(rounds)} words, {len(busy)} with "
                    f"rounds ({sum(busy)} in all, at most "
                    f"{max(busy, default=0)}); bound "
                    f"{1e3 * nbytes / cs.HBM_BYTES_PER_S:.6f} ms (bytes)")
            fns = {"port": lambda: riou.nms_suppress(bits, valid),
                   "staging": lambda: stage(bits, valid),
                   "empty": lambda: empty(bits)}
            for name, fn in others.items():
                if not torch.equal(fn(bits, valid), keep):
                    sys.exit(f"{path} {i}: {name}'s keep differs")
                fns[name] = lambda fn=fn: fn(bits, valid)
            # in turns: the others, port, staging, empty, and back
            names = [*others, "port", "staging", "empty"]
            order = names + names[::-1]
            times = dtimer([fns[n] for n in order], REPS)
            by = {}
            for n, t in zip(order, times):
                by.setdefault(n, []).append(t)
            print(line + "; device ms " + "; ".join(
                f"{n} {', '.join(f'{t:.5f}' for t in ts)}"
                for n, ts in by.items()))


if __name__ == "__main__":
    main()
