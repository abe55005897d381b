"""The NMS and soft-NMS kernels of `csrc/riou.cu` up to NMS_MAX_K against
another build of riou.cu (the parent's), and their wide routes past it, on
one card.

    python3 scripts/torch_nms_wide.py --parent_src RIOU_CU

- Up to NMS_MAX_K (K 1000, 2048 and 4096, batch 4, crowded boxes as
  chip_smoke.py's `crowded_nms_boxes` makes them): `nms_overlap` (bitmask
  and pair counts), `nms_suppress` (keep), `standup_overlap` (bitmask) and
  the two soft-NMS decays (picks and scores, 100 steps) of this tree
  against the parent's build on the same inputs: every output bit for bit
  equal; then each kernel's device time (chip_smoke.py's `DeviceTimer`,
  the median of 5 runs after an L2 flush) in turns, this, parent, parent,
  this, at K 4096.
- Past it (K 4097, 8192, 16384 at batch 4, and ROTATED_MAX_K at batch 1):
  the device time of each route by kernel (the wide overlap's prep, bound,
  scan and clip kernels), the pair counts, kept rows and the words the
  suppression walks, beside the time at K 4096; the pair decay up to
  PAIR_SEARCH_K (its pair search builds a [1, K, K] bound).

`--parent_src` is a riou.cu with the parent's C entries (e.g. `git show
HEAD~1:second_tpu_torch/csrc/riou.cu` written into a gitignored directory),
built with the port's flags for riou. Every line names the card and its
power limit.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops import nms as nms_ops  # noqa: E402
from second_tpu_torch.ops.cuda import riou  # noqa: E402

SAME_KS = (1000, 2048, 4096)
WIDE_KS = ((4097, 4), (8192, 4), (16384, 4), (riou.ROTATED_MAX_K, 1))
STEPS = 100
CAP, THR = cs.NMS_LARGE_CAP, cs.NMS_LARGE_THR
# the largest K whose rotated soft-NMS pair search (`soft_nms_pairs`: a
# [1, K, K] bound and its int64 running count) this script runs
PAIR_SEARCH_K = 16384


def checked(rc, what):
    if rc:
        sys.exit(f"{what}: CUDA error {rc}")


def parent_kernels(src):
    """The parent build's entries as functions of the wrappers' arguments:
    {name: fn}."""
    lib = kernels.build_variant(src, "riou_parent", "riou")[0]
    # the parent's overlap entry takes no scratch
    ov = lib.nms_overlap
    ov.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    ov.restype = ctypes.c_int
    sup = lib.nms_suppress
    sup.argtypes, sup.restype = riou._SUPPRESS_ARGTYPES, ctypes.c_int
    su = lib.standup_overlap
    su.argtypes, su.restype = riou._STANDUP_ARGTYPES, ctypes.c_int
    # the parent's standup decay takes no scratch
    st = lib.soft_nms_decay_standup
    st.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    st.restype = ctypes.c_int
    pa = lib.soft_nms_decay_pairs
    pa.argtypes, pa.restype = riou._SOFT_PAIRS_ARGTYPES, ctypes.c_int
    size = lib.soft_nms_pairs_scratch
    size.argtypes = [ctypes.c_int, ctypes.c_longlong]
    size.restype = ctypes.c_longlong

    def overlap(cand, valid):
        B, K = valid.shape
        over = torch.empty((B, K, (K + 31) // 32), dtype=torch.int32,
                           device=cand.device)
        maybe = torch.empty_like(over)
        count = torch.zeros(B, dtype=torch.int32, device=cand.device)
        checked(ov(cand.data_ptr(), valid.data_ptr(), over.data_ptr(),
                   maybe.data_ptr(), count.data_ptr(), B, K, THR, CAP,
                   riou.NMS_CLUSTER, kernels.stream_ptr(cand.device)),
                "parent nms_overlap")
        return over, count

    def suppress(bits, valid):
        keep = torch.empty(valid.shape, dtype=torch.bool, device=bits.device)
        checked(sup(bits.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                    *valid.shape, kernels.stream_ptr(bits.device)),
                "parent nms_suppress")
        return keep

    def standup(cand, valid):
        B, K = valid.shape
        over = torch.empty((B, K, (K + 31) // 32), dtype=torch.int32,
                           device=cand.device)
        checked(su(cand.data_ptr(), valid.data_ptr(), over.data_ptr(), B, K,
                   THR, 0, kernels.stream_ptr(cand.device)),
                "parent standup_overlap")
        return over

    def decay_standup(cand, scores):
        R, K = scores.shape
        picks = torch.empty((R, STEPS), dtype=torch.int64,
                            device=scores.device)
        picked = torch.empty((R, STEPS), device=scores.device)
        checked(st(cand.data_ptr(), scores.data_ptr(), picks.data_ptr(),
                   picked.data_ptr(), R, K, STEPS, 1, 0.5, 0.3,
                   kernels.stream_ptr(scores.device)), "parent standup decay")
        return picks, picked

    def decay_pairs(plist, ok, iou, scores):
        (R, K), P = scores.shape, plist.shape[1]
        picks = torch.empty((R, STEPS), dtype=torch.int64,
                            device=scores.device)
        picked = torch.empty((R, STEPS), device=scores.device)
        per_row = size(K, P)
        scratch = torch.empty(R * per_row, dtype=torch.uint8,
                              device=scores.device) if per_row else None
        checked(pa(plist.data_ptr(), ok.data_ptr(), iou.data_ptr(),
                   scores.data_ptr(), picks.data_ptr(), picked.data_ptr(),
                   scratch.data_ptr() if per_row else None, R, K, P, STEPS,
                   1, 0.5, 0.3, kernels.stream_ptr(scores.device)),
                "parent pair decay")
        return picks, picked

    return dict(nms_overlap=overlap, nms_suppress=suppress,
                standup_overlap=standup, soft_nms_standup=decay_standup,
                soft_nms_pairs=decay_pairs)


def inputs(g, B, K, dev):
    """The crowded boxes, their standup envelopes, the valid flags, the
    rotated bitmask, and the decays' rows (the first example's pair list
    at the cap, its IoU, its scores)."""
    boxes, scores = cs.crowded_nms_boxes(g, B, K)
    cand, scores = boxes.to(dev), scores.to(dev)
    valid = torch.isfinite(scores)
    pairs = None
    if K <= PAIR_SEARCH_K:
        plist, ok = nms_ops.soft_nms_pairs(cand[:1], valid[:1], CAP)
        pairs = (plist, ok, nms_ops.pair_iou(cand[:1], plist), scores[:1])
    return dict(cand=cand, standup=nms_ops.rbbox2d_to_near_bbox(cand),
                valid=valid, scores=scores,
                bits=riou.nms_overlap(cand, valid, THR, CAP)[0], pairs=pairs)


def calls(x):
    """{kernel: (this tree's call, the parent's arguments)} on inputs x."""
    top = x["scores"][:1]
    out = {
        "nms_overlap": (lambda: riou.nms_overlap(x["cand"], x["valid"], THR,
                                                 CAP), (x["cand"], x["valid"])),
        "nms_suppress": (lambda: riou.nms_suppress(x["bits"], x["valid"]),
                         (x["bits"], x["valid"])),
        "standup_overlap": (lambda: riou.standup_overlap(
            x["standup"], x["valid"], THR), (x["standup"], x["valid"])),
        "soft_nms_standup": (lambda: riou.soft_nms_decay_standup(
            x["standup"][:1].contiguous(), top, STEPS),
            (x["standup"][:1].contiguous(), top)),
    }
    if x["pairs"] is not None:
        out["soft_nms_pairs"] = (lambda: riou.soft_nms_decay_pairs(
            *x["pairs"], STEPS), x["pairs"])
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path, required=True,
                        help="the parent's riou.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}")
    kernels.build(("riou",))
    parent = parent_kernels(args.parent_src)
    dtimer = cs.DeviceTimer(dev)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for K in SAME_KS:
            x = inputs(g, 4, K, dev)
            for name, (mine, pargs) in calls(x).items():
                a, b = mine(), parent[name](*pargs)
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                torch.cuda.synchronize()
                if not all(torch.equal(u, v) for u, v in zip(a, b)):
                    sys.exit(f"K {K} {name}: this tree's output differs from "
                             f"the parent's")
            print(f"K {K} B 4: nms_overlap, nms_suppress, standup_overlap, "
                  f"the standup and pair decays ({STEPS} steps) bit for bit "
                  f"the parent's")
        for name, (mine, pargs) in calls(x).items():
            theirs = (lambda f=parent[name], a=pargs: f(*a))
            t = dtimer([mine, theirs, theirs, mine])
            print(f"K 4096 {name} device ms in turns (this, parent, parent, "
                  f"this): {', '.join(f'{v:.4f}' for v in t)}; card {card}")
        for K, B in WIDE_KS:
            x = inputs(g, B, K, dev)
            fns = calls(x)
            keep = riou.nms_suppress(x["bits"], x["valid"])
            count = riou.nms_overlap(x["cand"], x["valid"], THR, CAP)[1]
            print(f"K {K} B {B}: pair counts {count.tolist()}, kept "
                  f"{keep.sum(1).tolist()}, {(K + 31) // 32} words a row")
            for name, (mine, _) in fns.items():
                split = cs.device_split(mine, dtimer, reps=3)
                print(f"K {K} B {B} {name}: {cs.split_line(split)}; card "
                      f"{card}")
            del x, fns, keep
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
