"""Device time of the 3-D IoU kernel on the IoU branch's real call, on one card.

    python3 scripts/torch_d3_iou.py [--parent_src RIOU_CU]
                                    [--variant_src RIOU_CU] [--rows N]

Captures the `d3_iou` call of one SECOND car.fhd train step with the IoU
branch (chip_smoke.py's fhd + IoU phase: batch 4 synthetic scans, 16 000
voxels, bf16; [4, 70 400, 7] x [4, 64, 7]) and prints:

- the pairs `d3_cull_plain` keeps (the kernel's clipped count, checked
  equal), the overlapping pairs, and how the kept pairs spread over the
  kernel's tiles of 128 and of 256 rows;
- the device time (chip_smoke.py's DeviceTimer: device-only, L2 flushed
  before each call, median of 5) and the event time of the kernel, in
  turns with: the parent's `d3_iou` where `--parent_src` names its
  `riou.cu` (whose `d3_iou` takes b1, b2, out, batch, n1, n2, stream);
  another version's where `--variant_src` names one (this interface); the
  kernel built with N rows a block where `--rows` gives N (a copy of
  csrc/riou.cu with D3_ROWS patched, in the build directory); all built
  with the port's flags for riou; a PyTorch fill of the same [B, N, K]
  output (the store alone); and the kernel on the same rows against gt
  slots that are all padding (every pair culled: no clip);
- each version's output against the plain version (within 1e-5,
  non-finite entries equal).
"""

import argparse
import ctypes
import functools
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import riou  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import make_train_step  # noqa: E402


def other_d3(src, tag, parent):
    """The `d3_iou` launch of another riou.cu, built into the build
    directory with the port's flags for riou: fn(b1, b2) → [B, N, K]. The
    parent's takes (b1, b2, out, batch, n1, n2, stream), another takes this
    riou.cu's arguments."""
    fn = kernels.build_variant(src, f"riou_{tag}", "riou")[0].d3_iou
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p] \
        if parent else riou._D3_ARGTYPES
    fn.restype = ctypes.c_int

    def call(b1, b2):
        B, N = b1.shape[:2]
        K = b2.shape[1]
        out = torch.empty((B, N, K), dtype=torch.float32, device=b1.device)
        stream = kernels.stream_ptr(b1.device)
        args = (B, N, K, stream) if parent else (None, B, N, K, stream)
        rc = fn(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), *args)
        if rc:
            sys.exit(f"the {tag}'s d3_iou launch failed: CUDA error {rc}")
        return out
    return call


def tile_spread(kept, rows):
    """(tiles, tiles with a kept pair, the most kept pairs in a tile) of
    kept [B, N, K] cut into tiles of `rows` rows."""
    B, N, K = kept.shape
    per_row = kept.sum(-1)
    pad = torch.nn.functional.pad(per_row, (0, -N % rows))
    per_tile = pad.view(B, -1, rows).sum(-1)
    return (per_tile.numel(), int((per_tile > 0).sum()),
            int(per_tile.max()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path,
                        help="the parent's riou.cu, whose d3_iou to time "
                        "beside")
    parser.add_argument("--variant_src", type=Path,
                        help="another riou.cu with this one's d3_iou "
                        "interface, to time beside")
    parser.add_argument("--rows", type=int,
                        help="also time csrc/riou.cu built with this many "
                        "rows a block (D3_ROWS)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = True
    print(cs.card_line())
    cfg = load_pipeline_config(cs.CONFIG)
    cfg.model.use_iou_branch = True
    state, spec, info, assigner = cs.new_train_state(
        cfg, dev, cfg.train_config.enable_mixed_precision)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     cs.TRAIN_VOXELS, shuffle_overflow=True)
    batch = cs.train_inputs(cfg, assigner, info, dev, cs.TRAIN_BATCH)
    with cs.recording([(riou, "d3_iou")]) as calls:
        make_train_step(spec, vspec)(state, batch)
        torch.cuda.synchronize()
    (b1, b2), _ = calls["d3_iou"][0]
    del state, batch, calls
    print("d3_iou call", tuple(b1.shape), tuple(b2.shape))

    with torch.no_grad():
        want = riou.d3_iou_plain(b1, b2)
        kept = ~riou.d3_cull_plain(b1, b2)
        got, clipped = riou.d3_iou(b1, b2, count=True)
        torch.cuda.synchronize()
        valid = (b2.abs().sum(-1) > 0).sum(-1)
        print("gt boxes with a nonzero field an example", valid.tolist())
        print("kept pairs", kept.sum((1, 2)).tolist(), "clipped",
              clipped.tolist(), "of", kept[0].numel(), "an example;",
              "overlapping", int((want > 0).sum()))
        if not torch.equal(clipped.long(), kept.sum((1, 2))):
            sys.exit("the clipped count differs from d3_cull_plain's")
        for rows in (128, 256):
            n, hit, most = tile_spread(kept, rows)
            print(f"tiles of {rows} rows: {n}, {hit} with a kept pair, at "
                  f"most {most} kept pairs in one")

        # each version as a callable of no argument on this call's boxes
        versions = {}
        for tag, src in (("parent", args.parent_src),
                         ("variant", args.variant_src)):
            if src:
                versions[tag] = functools.partial(
                    other_d3(src, tag, tag == "parent"), b1, b2)
        versions["kernel"] = functools.partial(riou.d3_iou, b1, b2)
        if args.rows:
            src = kernels.CSRC / "riou.cu"
            text, n = re.subn(r"constexpr int D3_ROWS = \d+;",
                              f"constexpr int D3_ROWS = {args.rows};",
                              src.read_text())
            if n != 1:
                sys.exit(f"{src}: no single D3_ROWS line to patch")
            kernels.BUILD_DIR.mkdir(exist_ok=True)
            copy = kernels.BUILD_DIR / f"riou_rows{args.rows}.cu"
            copy.write_text(text)
            versions[f"kernel at {args.rows} rows a block"] = \
                functools.partial(other_d3(copy, f"rows{args.rows}", False),
                                  b1, b2)
        out = torch.empty_like(want)
        versions["fill of the output"] = functools.partial(out.fill_, 0.0)
        versions["kernel, every gt slot padding"] = functools.partial(
            riou.d3_iou, b1, torch.zeros_like(b2))
        for name, fn in versions.items():
            if name.startswith("fill") or name.endswith("padding"):
                continue
            o = fn()
            torch.cuda.synchronize()
            ok = torch.equal(torch.isfinite(o), torch.isfinite(want)) and \
                torch.allclose(o, want, atol=cs.RIOU_TOL, rtol=0,
                               equal_nan=True)
            print(f"{name}: equals the plain version within "
                  f"{cs.RIOU_TOL}: {ok}")
            if not ok:
                sys.exit(1)
        names = list(versions)
        order = names + names[::-1]              # in turns, there and back
        dt = cs.DeviceTimer(dev)
        ts = dt([versions[n] for n in order], reps=5)
        timer = cs.Timer(dev)
        for i, n in enumerate(order):
            print(f"{n}: device {ts[i]:.4f} ms, event "
                  f"{timer(versions[n], 10):.4f} ms")
        nbytes = (b1.numel() + b2.numel() + want.numel()) * 4
        print(f"bytes bound {1e3 * nbytes / cs.HBM_BYTES_PER_S:.4f} ms "
              f"({nbytes / 1e6:.2f} MB at 3.35 TB/s)")


if __name__ == "__main__":
    main()
