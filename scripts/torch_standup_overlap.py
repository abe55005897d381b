"""The standup-NMS bitmask kernel on its real call and on crowded and dense
boxes, on one card: bits and keep against the plain chain, the bound, and the device
time beside an empty launch of the same grid and the parent's kernel.

    python3 scripts/torch_standup_overlap.py [--parent_src RIOU_CU]

The calls: the `standup_overlap` call of one two-stage eval forward
(second_car_fhd.config as stage 1, fp32, batch 4, the proposals' NMS at
K 2048, threshold 0.7), the card tests' crowded boxes
(`tests/test_torch_cuda.py` `_standup_boxes`: batch 3, a third duplicated,
a NaN box, 15% invalid) at K 2048 and 4096 in fp32 and fp64, and dense
boxes (batch 4, all valid, corners on a square of side DENSE_SIDE and
sides DENSE_SIZE, so that most pairs meet) at K 2048 and 4096 in fp32,
all at threshold 0.7. For each it prints:

- B, K, the valid rows, the bits set and the rows kept; the bits against
  `standup_overlap_plain` and the NMS keep (`nms_suppress` on the kernel's
  bits) against `nms_suppress_plain` on the plain bits, both exact;
- how the work falls: the valid pairs whose boxes meet (both widths > 0,
  the pairs that take a product and a quotient), and the (row, word) runs
  of 32 columns that hold at least one, with the pairs that meet in each
  of those on average;
- the pairs tested (the valid pairs of the upper triangle) and the bound:
  chip_smoke.py's count (`standup_bound`: STANDUP_TEST_OPS a pair tested,
  STANDUP_MEET_OPS more a pair that meets, STANDUP_AREA_OPS a box) at the
  card's fp32 rate (67 TF/s) or, for fp64 boxes, at its fp64 rate
  (34 TF/s, NVIDIA's H100 SXM data sheet), against the bytes over 3.35
  TB/s;
- device times (torch.profiler, REPS calls each after an L2 flush,
  chip_smoke's DeviceTimer) in turns: the parent's kernel (`--parent_src`,
  the parent's riou.cu unpacked with git into a gitignored directory, or
  any riou.cu with the same C entry, such as a variant of the kernel), the
  port's kernel, and an empty kernel launched with the port's grid (the
  live tiles of SU_ROWS rows by SU_WORDS words, as csrc/riou.cu compiles
  them, and a block a row tile for the words below the diagonal), the
  floor of a launch of that shape; then back in reverse. The parent's bits must equal
  the port's.
"""

import argparse
import ctypes
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import riou  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import TrainState  # noqa: E402
from second_tpu_torch.train.steps_multistage import \
    make_two_stage_steps  # noqa: E402
from test_torch_cuda import _standup_boxes  # noqa: E402

REPS = 9
THRESHOLD = 0.7
DENSE_SIDE, DENSE_SIZE = 4.0, (2.0, 6.0)
FP64_OPS_PER_S = 34e12
EMPTY_CU = """
extern "C" __global__ void standup_empty_kernel() {}
extern "C" int standup_empty(int words, int rows, int batch, int threads,
                             void* stream) {
  standup_empty_kernel<<<dim3(words, rows, batch), threads, 0,
                         (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch():
    """An empty kernel of the port's grid: (cand) → None."""
    src = kernels.BUILD_DIR / "standup_empty.cu"
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    src.write_text(EMPTY_CU)
    fn = kernels.build_variant(src, "standup_empty",
                               "gather")[0].standup_empty
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    R, T = su_tile()

    def launch(cand):
        # the port's grid: each example's live tiles, and a block a row
        # tile for the words at or below the diagonal
        B, K = cand.shape[:2]
        W = (K + 31) // 32
        live = sum(-(-(min(32 * T * (tx + 1), K) - 1) // R)
                   for tx in range(-(-W // T)))
        rc = fn(live + -(-K // R), 1, B, 32 * T,
                kernels.stream_ptr(cand.device))
        if rc:
            sys.exit(f"the empty launch failed: CUDA error {rc}")
    return launch


def su_tile():
    """(SU_ROWS, SU_WORDS): the standup kernel's tile in csrc/riou.cu."""
    src = (ROOT / "second_tpu_torch" / "csrc" / "riou.cu").read_text()
    tile = dict(re.findall(r"constexpr int (SU_ROWS|SU_WORDS) = (\d+);",
                           src))
    return int(tile["SU_ROWS"]), int(tile["SU_WORDS"])


def standup(lib):
    """The `standup_overlap` entry of a built riou.cu as a function (cand,
    valid, thr) → bits."""
    fn = lib.standup_overlap
    fn.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
         ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(cand, valid, thr):
        B, K = valid.shape
        over = torch.empty((B, K, (K + 31) // 32), dtype=torch.int32,
                           device=cand.device)
        rc = fn(cand.data_ptr(), valid.data_ptr(), over.data_ptr(), B, K,
                thr, int(cand.dtype == torch.float64),
                kernels.stream_ptr(cand.device))
        if rc:
            sys.exit(f"a build's standup_overlap failed: CUDA error {rc}")
        return over
    return run


def runs(cand, valid):
    """((row, word) runs with a pair that meets, (row, word) runs of the
    upper triangle) over the valid rows: the runs of 32 columns a warp
    walks, on the card."""
    B, K = valid.shape
    W = (K + 31) // 32
    meet = cs.standup_meets(cand, valid)
    hit = torch.nn.functional.pad(meet, (0, 32 * W - K)).view(
        B, K, W, 32).any(-1)
    cols = torch.arange(W, device=cand.device)
    rows = torch.arange(K, device=cand.device)
    tested = (32 * cols[None] + 31 > rows[:, None])[None] & valid[..., None]
    return int(hit.sum()), int(tested.sum())


def captured(dev):
    """[(what, cand, valid, thr)]: the two-stage eval forward's standup call,
    then the crowded boxes."""
    out = []
    cfg = load_pipeline_config(cs.CONFIG)
    net, spec, info, assigner, _ = cs.build_two_stage(cfg.model, dev)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     cs.MAX_VOXELS)
    points, mask, anchors = cs.build_inputs(cfg, assigner, info, dev)
    with torch.no_grad(), cs.recording([(riou, "standup_overlap")]) as calls:
        make_two_stage_steps(spec, vspec)[1](
            TrainState(net, None),
            {"points": points, "points_mask": mask, "anchors": anchors})
        torch.cuda.synchronize()
    for i, (args, _) in enumerate(calls["standup_overlap"]):
        out.append((f"2st eval {i}", *args))
    del net
    for K in (2048, 4096):
        for dtype in (torch.float32, torch.float64):
            boxes, valid = _standup_boxes(
                torch.Generator().manual_seed(47 + K), 3, K, dtype)
            out.append((f"crowded {str(dtype)[6:]}", boxes.to(dev),
                        valid.to(dev), THRESHOLD))
    for K in (2048, 4096):
        g = torch.Generator().manual_seed(53 + K)
        lo = torch.rand(4, K, 2, generator=g) * DENSE_SIDE
        size = DENSE_SIZE[0] + torch.rand(4, K, 2, generator=g) * \
            (DENSE_SIZE[1] - DENSE_SIZE[0])
        out.append(("dense float32", torch.cat([lo, lo + size], -1).to(dev),
                    torch.ones(4, K, dtype=torch.bool, device=dev),
                    THRESHOLD))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path,
                        help="the parent's riou.cu, whose standup kernel to "
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
    others = {}
    if args.parent_src:
        others["parent"] = standup(kernels.build_variant(
            args.parent_src, "riou_parent", "riou")[0])
    dtimer = cs.DeviceTimer(dev)
    for what, cand, valid, thr in calls:
        B, K = valid.shape
        cand, valid = cand.contiguous(), valid.contiguous()
        got = riou.standup_overlap(cand, valid, thr)
        want = riou.standup_overlap_plain(cand, valid, thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            sys.exit(f"{what}: bits differ from the plain version")
        keep = riou.nms_suppress(got, valid)
        if not torch.equal(keep, riou.nms_suppress_plain(want, valid)):
            sys.exit(f"{what}: keep differs from the plain chain's")
        peak = FP64_OPS_PER_S if cand.dtype == torch.float64 else \
            cs.PEAK_OPS_PER_S[torch.float32]
        bs, os_, tests, meet = cs.standup_bound(cand, valid, peak)
        hit, tested = runs(cand, valid)
        line = (f"{what} standup_overlap: B {B}, K {K}, {cand.dtype}, thr "
                f"{thr}, valid {valid.sum(1).tolist()}, bits "
                f"{int(riou.unpack_bits(got, K).sum())}, kept "
                f"{keep.sum(1).tolist()}; bits and keep exact; "
                f"{meet} pairs meet ({100 * meet / max(tests, 1):.1f}%), in "
                f"{hit} of {tested} (row, word) runs "
                f"({meet / max(hit, 1):.2f} a run that has one); "
                f"{tests:.0f} pair tests; bound {1e3 * max(bs, os_):.6f} "
                f"ms ({'bytes' if bs >= os_ else 'operations'}; bytes "
                f"{1e3 * bs:.6f}, operations {1e3 * os_:.6f})")
        fns = {"port": lambda: riou.standup_overlap(cand, valid, thr),
               "empty": lambda: empty(cand)}
        for name, fn in others.items():
            if not torch.equal(fn(cand, valid, thr), got):
                sys.exit(f"{what}: {name}'s bits differ")
            fns[name] = lambda fn=fn: fn(cand, valid, thr)
        # in turns: the others, port, empty, and back
        names = [*others, "port", "empty"]
        order = names + names[::-1]
        times = dtimer([fns[n] for n in order], REPS)
        by = {}
        for n, t in zip(order, times):
            by.setdefault(n, []).append(t)
        print(line + "; device ms " + "; ".join(
            f"{n} {', '.join(f'{t:.5f}' for t in ts)}"
            for n, ts in by.items()), flush=True)


if __name__ == "__main__":
    main()
