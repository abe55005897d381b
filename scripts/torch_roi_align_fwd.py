"""The rotated ROI-align forward on the two-stage eval forward's real call,
on one card: its device time split into the layout copy, the staging and
the main loop, beside the parent's kernel in turns.

    python3 scripts/torch_roi_align_fwd.py [--parent_src ROI_ALIGN_CU]

Captures the `roi_align_fwd` call of one two-stage eval forward
(chip_smoke.py's 2st eval phase: second_car_fhd.config as stage 1, fp32,
the fhd bench input, batch 4, 40 000 voxels, 512 proposals an example; the
trunk [4, 128, 200, 176], 2048 rois x 28 x 28 samples) and prints:

- the samples' layout: taps inside the map and the distinct pixels they
  touch, and the call's bound (chip_smoke's count: the coordinates, each
  touched pixel's channels and the output, over the card's memory rate);
- the port's `roi_align_fwd` bitwise against `roi_align_plain`;
- its device time by kernel (torch.profiler, REPS calls each after an L2
  flush): the channels-last copy (`roi_align_transpose_kernel`) and the
  crops (`roi_align_fwd_kernel`), the crops split again by a build with
  ROI_ALIGN_FWD_STAGE_ONLY defined (the copy and the taps' staging alone:
  staging = that build's crop kernel, main loop = the rest);
- the library pair (`F.grid_sample` + `F.avg_pool2d`, chip_smoke's
  `roi_library`) by device time;
- with `--parent_src` (the parent's roi_align.cu, unpacked with git into a
  gitignored directory), the parent's forward built with the port's flags
  for roi_align and timed in turns with the port's: parent, port, port,
  parent. The parent's C entry is `roi_align_fwd(feat, coords, out, type,
  B, C, H, W, N, oh, ow, s, stream)`, with no scratch.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import roi_align  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import TrainState  # noqa: E402
from second_tpu_torch.train.steps_multistage import \
    make_two_stage_steps  # noqa: E402

REPS = 5
_TYPES = {(torch.bfloat16, torch.float32): 0,
          (torch.float32, torch.float32): 1,
          (torch.float64, torch.float64): 2}


def build_lib(src, name, extra=()):
    """`src` built with the port's flags for roi_align (and `extra`) into
    the build directory as lib<name>.so, loaded."""
    return kernels.build_variant(src, name, "roi_align", extra)[0]


def port_forward(lib):
    """The port's forward entry of a build of this tree's roi_align.cu as
    a function (feat, coords, s) → crops."""
    fwd, ldc = lib.roi_align_fwd, lib.roi_align_fwd_ldc
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    ldc.argtypes = [ctypes.c_int] * 2
    fwd.restype = ldc.restype = ctypes.c_int

    def forward(feat, coords, s):
        code = _TYPES[(feat.dtype, coords.dtype)]
        B, N, SH, SW, _ = coords.shape
        C, H, W = feat.shape[1:]
        out = torch.empty((B * N, C, SH // s, SW // s), dtype=coords.dtype,
                          device=feat.device)
        fhwc = torch.empty((B * H * W * ldc(code, C),), dtype=feat.dtype,
                           device=feat.device)
        rc = fwd(feat.data_ptr(), coords.data_ptr(), fhwc.data_ptr(),
                 out.data_ptr(), code, B, C, H, W, N, SH // s, SW // s, s,
                 kernels.stream_ptr(feat.device))
        if rc:
            sys.exit(f"a build's forward failed: CUDA error {rc}")
        return out
    return forward


def parent_forward(src):
    """The parent's forward as a function (feat, coords, s) → crops."""
    fwd = build_lib(src, "roi_align_parent").roi_align_fwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fwd.restype = ctypes.c_int

    def forward(feat, coords, s):
        code = _TYPES[(feat.dtype, coords.dtype)]
        B, N, SH, SW, _ = coords.shape
        C, H, W = feat.shape[1:]
        out = torch.empty((B * N, C, SH // s, SW // s), dtype=coords.dtype,
                          device=feat.device)
        rc = fwd(feat.data_ptr(), coords.data_ptr(), out.data_ptr(), code, B,
                 C, H, W, N, SH // s, SW // s, s,
                 kernels.stream_ptr(feat.device))
        if rc:
            sys.exit(f"the parent's forward failed: CUDA error {rc}")
        return out
    return forward


def print_split(name, by):
    total = sum(ms for ms, _ in by.values())
    print(f"{name}: device {total:.4f} ms a call, by kernel:")
    for k, (ms, n) in by.items():
        print(f"  {ms:9.4f} ms  x{n:g}  {k[:110]}")
    return total


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path,
                        help="the parent's roi_align.cu, whose forward to "
                        "time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    cfg = load_pipeline_config(cs.CONFIG)
    net, spec, info, assigner, _ = cs.build_two_stage(cfg.model, dev)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     cs.MAX_VOXELS)
    points, mask, anchors = cs.build_inputs(cfg, assigner, info, dev)
    batch = {"points": points, "points_mask": mask, "anchors": anchors}
    with torch.no_grad():
        with cs.recording([(roi_align, "roi_align_fwd")]) as calls:
            make_two_stage_steps(spec, vspec)[1](TrainState(net, None),
                                                  batch)
            torch.cuda.synchronize()
        (feat, coords, s), _ = calls["roi_align_fwd"][0]
        del net, calls, batch
        B, C, H, W = feat.shape
        print(f"roi_align_fwd call: map {tuple(feat.shape)} {feat.dtype}, "
              f"coords {tuple(coords.shape)}, s {s}")
        n_in, pixels = cs.roi_pixels(feat, coords)
        out_bytes = coords.shape[0] * coords.shape[1] * C * \
            (coords.shape[2] // s) * (coords.shape[3] // s) * \
            coords.element_size()
        nbytes = coords.numel() * coords.element_size() + \
            pixels * C * feat.element_size() + out_bytes
        print(f"layout: {n_in} taps inside the map, {pixels} distinct "
              f"pixels; bound {1e3 * nbytes / cs.HBM_BYTES_PER_S:.4f} ms "
              f"(bytes: {nbytes / 1e6:.1f} MB at 3.35 TB/s)")
        want = roi_align.roi_align_plain(feat, coords, s)
        versions = {"port": lambda: roi_align.roi_align_fwd(feat, coords,
                                                            s)}
        if args.parent_src:
            parent = parent_forward(args.parent_src)
            versions["parent"] = lambda: parent(feat, coords, s)
        stage_lib = build_lib(kernels.CSRC / "roi_align.cu",
                              "roi_align_stage",
                              ["-DROI_ALIGN_FWD_STAGE_ONLY"])
        stage = port_forward(stage_lib)
        ints = torch.int64 if want.dtype == torch.float64 else torch.int32
        for name, fn in versions.items():
            got = fn()
            torch.cuda.synchronize()
            same = torch.equal(got.view(ints), want.view(ints))
            print(f"{name}: bitwise the plain version {same}; max abs err "
                  f"{cs.errors(got, want)[0]:.3g}")
            if not same and name != "parent":
                sys.exit(1)
        dtimer = cs.DeviceTimer(dev)
        names = list(versions)
        # in turns: the others, port, port, the others in reverse
        order = names[:0:-1] + names[:1] + names[:1] + names[1:]
        totals = {}
        for name in order:
            totals.setdefault(name, []).append(print_split(
                name, cs.device_split(versions[name], dtimer, REPS)))
        staged = print_split("port, the copy and the staging alone",
                             cs.device_split(lambda: stage(feat, coords, s),
                                             dtimer, REPS))
        full = cs.device_split(versions["port"], dtimer, REPS)
        copy_ms = sum(ms for k, (ms, _) in full.items() if "transpose" in k)
        crop_ms = sum(ms for k, (ms, _) in full.items() if "fwd_kernel" in k)
        stage_ms = staged - copy_ms
        print(f"port split: copy {copy_ms:.4f} ms, staging {stage_ms:.4f} "
              f"ms, main loop {crop_ms - stage_ms:.4f} ms (crops "
              f"{crop_ms:.4f})")
        lib_ms = cs.DeviceTimer(dev)([lambda: cs.roi_library(feat, coords,
                                                             s)])[0]
        print(f"library (F.grid_sample + F.avg_pool2d): device "
              f"{lib_ms:.4f} ms")
        print("device ms a call by turn: " + "; ".join(
            f"{k} {', '.join(f'{v:.4f}' for v in vs)}"
            for k, vs in totals.items()))


if __name__ == "__main__":
    main()
