"""The rotated ROI-align backward on the two-stage train step's real call,
on one card: its device time split by device kernel.

    python3 scripts/torch_roi_align_bwd.py [--parent_src ROI_ALIGN_CU]

Captures the `roi_align_bwd` call of one two-stage train step
(chip_smoke.py's 2st train phase: second_car_fhd.config as stage 1, bf16,
batch 4 synthetic scans, 16 000 voxels, 512 proposals an example; the
trunk [4, 128, 200, 176], 2048 rois x 28 x 28 samples) and prints:

- the samples' layout: samples, those with a tap inside the map, their
  distinct cells (b, y0, x0), the most samples on one cell, and the
  distinct map pixels their taps touch;
- the port's `roi_align_bwd` against autograd of the plain version
  (chip_smoke.ROI_BWD_TOL of each gradient's scale), bitwise over two
  calls;
- its device time by kernel name (torch.profiler: REPS calls, each after
  an L2 flush, each kernel's time summed and divided by REPS), and the
  same for the parent's backward where `--parent_src` names its
  roi_align.cu (keys a tap, a stable `torch.sort`, the crops' gradient
  transposed to [R, bins, C], its C `roi_align_bwd` with the chunk, fix-up
  and grad_coords kernels), built with the port's flags for roi_align; the
  two in turns: parent, port, port, parent.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import roi_align  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.steps_multistage import \
    make_two_stage_steps  # noqa: E402

REPS = 5
_TYPES = {(torch.bfloat16, torch.float32): 0,
          (torch.float32, torch.float32): 1,
          (torch.float64, torch.float64): 2}


def parent_backward(src):
    """The parent's backward as a function (feat, coords, grad, s) →
    (grad_feat, grad_coords), from its roi_align.cu built into the build
    directory."""
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    lib_path = kernels.BUILD_DIR / "libroi_align_parent.so"
    cmd = [kernels._nvcc(), *kernels._flags("roi_align"), "-o",
           str(lib_path), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc {src} failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    keys_fn, bwd_fn = lib.roi_align_keys, lib.roi_align_bwd
    keys_fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    bwd_fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    keys_fn.restype = bwd_fn.restype = ctypes.c_int
    chunks_fn = lib.roi_align_chunks
    chunks_fn.argtypes = [ctypes.c_longlong]
    chunks_fn.restype = ctypes.c_longlong

    def backward(feat, coords, grad, s):
        code = _TYPES[(feat.dtype, coords.dtype)]
        B, N, SH, SW, _ = coords.shape
        C, H, W = feat.shape[1:]
        oh, ow = SH // s, SW // s
        dev = feat.device
        stream = kernels.stream_ptr(dev)
        grad_feat = torch.zeros((B, C, H, W), dtype=coords.dtype, device=dev)
        grad_coords = torch.empty_like(coords)
        gt = grad.permute(0, 2, 3, 1).contiguous()
        keys = torch.empty((coords.numel() // 2 * 4,), dtype=torch.int32,
                           device=dev)
        rc = keys_fn(coords.data_ptr(), keys.data_ptr(), int(code == 2), B,
                     H, W, N, oh, ow, s, stream)
        sorted_keys, perm = torch.sort(keys, stable=True)
        chunks = chunks_fn(keys.numel())
        head = torch.empty((2, chunks, C), dtype=coords.dtype, device=dev)
        run_keys = torch.empty((2, chunks), dtype=torch.int32, device=dev)
        rc = rc or bwd_fn(
            feat.data_ptr(), coords.data_ptr(), gt.data_ptr(),
            sorted_keys.data_ptr(), perm.data_ptr(), head[0].data_ptr(),
            head[1].data_ptr(), run_keys.data_ptr(), grad_feat.data_ptr(),
            grad_coords.data_ptr(), code, B, C, H, W, N, oh, ow, s, stream)
        if rc:
            sys.exit(f"the parent's backward failed: CUDA error {rc}")
        return grad_feat, grad_coords
    return backward


def layout(feat, coords):
    """Counts of the call's samples: all, with a tap inside the map, their
    distinct cells and the most on one cell, the distinct pixels touched."""
    B, C, H, W = feat.shape
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    b = torch.arange(B, device=feat.device).view(B, 1, 1, 1).expand_as(x0)
    cell = ((b * (H + 1) + y0.long() + 1) * (W + 1) + x0.long() + 1)[inside]
    counts = torch.bincount(cell)
    n_in, pixels = cs.roi_pixels(feat, coords)
    return dict(samples=x0.numel(), in_map=int(inside.sum()),
                cells=int((counts > 0).sum()), most_on_a_cell=int(
                    counts.max()) if counts.numel() else 0,
                taps_in=n_in, pixels=pixels)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path,
                        help="the parent's roi_align.cu, whose backward to "
                        "split beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    print(cs.card_line())
    cfg = load_pipeline_config(cs.CONFIG)
    state, spec, info, assigner = cs.new_train_state(
        cfg, dev, cfg.train_config.enable_mixed_precision,
        build=cs.build_two_stage)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     cs.TRAIN_VOXELS, shuffle_overflow=True)
    batch = cs.train_inputs(cfg, assigner, info, dev, cs.TRAIN_BATCH)
    with cs.recording([(roi_align, "roi_align_bwd")]) as calls:
        make_two_stage_steps(spec, vspec)[0](state, batch)
        torch.cuda.synchronize()
    (feat, coords, grad, s), _ = calls["roi_align_bwd"][0]
    del state, batch, calls
    print(f"roi_align_bwd call: map {tuple(feat.shape)} {feat.dtype}, "
          f"coords {tuple(coords.shape)}, grad {tuple(grad.shape)}, s {s}")
    with torch.no_grad():
        print("layout", layout(feat, coords))
        want = roi_align.roi_align_backward_plain(feat.to(coords.dtype),
                                                  coords, grad, s)
        versions = {"port": lambda: roi_align.roi_align_bwd(feat, coords,
                                                            grad, s)}
        if args.parent_src:
            parent = parent_backward(args.parent_src)
            versions["parent"] = lambda: parent(feat, coords, grad, s)
        for name, fn in versions.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            errs = [cs.errors(g, w)[1] for g, w in zip(a, want)]
            print(f"{name}: bitwise over two calls {same}; the map's "
                  f"gradient {errs[0]:.2e}, the coordinates' {errs[1]:.2e} "
                  f"of their scale from autograd of the plain version")
            if not same or max(errs) > cs.ROI_BWD_TOL:
                sys.exit(1)
        dtimer = cs.DeviceTimer(dev)
        names = list(versions)
        # in turns: parent, port, port, parent
        order = names[:0:-1] + names[:1] + names[:1] + names[1:]
        for name in order:
            by = cs.device_split(versions[name], dtimer, REPS)
            total = sum(ms for ms, _ in by.values())
            print(f"{name}: device {total:.4f} ms a call, by kernel:")
            for k, (ms, n) in by.items():
                print(f"  {ms:9.4f} ms  x{n:g}  {k[:110]}")


if __name__ == "__main__":
    main()
