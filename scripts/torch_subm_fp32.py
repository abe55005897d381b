"""The fp32 sparse gather-GEMM on the SECOND multi-class eval forward's 14
convs, on one card: device time and accuracy against fp64.

    python3 scripts/torch_subm_fp32.py [--parent_src SUBM_CU] [--random]

Captures the 14 sparse-conv calls of one mc eval forward (chip_smoke.py's
mc eval phase: second_multiclass.config, batch 3 of the fhd bench scene,
40 000 voxels, fp32 as the config asks) and prints, per call and summed:

- the found taps and the padded work of 128-row tiles (every row of a
  tile, every tap some row of it found), in operations;
- the device time (chip_smoke.DeviceTimer: device-only, L2 flushed before
  each call, median of 5) of the port's `gather_gemm`, and of the parent's
  fp32 entry where `--parent_src` names its subm.cu (its
  `subm_gather_gemm_fma` takes feat, tap_idx, found, w [K, C, D], out, B,
  N, Q, K, C, D, stream), built with the port's flags, in turns:
  parent, port, port, parent;
- the error of each kernel and of the fp32 plain version against the plain
  version in fp64 on the same inputs (max abs error over the largest
  |reference|), and the ratio chip_smoke's gate holds at 2;
- with `--random`, the same ratio for each kernel on random rulebooks
  (B = 2, N = 300, Q = 333, K = 27, 30% of the taps found, N(0, 1)
  features, and the same clamped at 0 as after a ReLU; seeds 3-5) at the
  widths the card tests take: short sums, where cuBLAS's fp32 GEMM lands
  within a few ulps of fp64.
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
from second_tpu_torch.models import build_voxelnet, detect  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import subm  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402


def parent_conv(src):
    """The parent's fp32 gather-GEMM as a function (feat, tap_idx, found,
    w) → out, from its subm.cu built into the build directory."""
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    lib_path = kernels.BUILD_DIR / "libsubm_parent.so"
    cmd = [kernels._nvcc(), *kernels._flags("subm"), "-o", str(lib_path),
           str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc {src} failed:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(str(lib_path)).subm_gather_gemm_fma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def conv(feat, tap_idx, found, w):
        B, N, C = feat.shape
        K, Q = tap_idx.shape[1:]
        D = w.shape[2]
        out = torch.empty((B, Q, D), dtype=torch.float32, device=feat.device)
        rc = fn(feat.data_ptr(), tap_idx.to(torch.int32).data_ptr(),
                found.data_ptr(), w.contiguous().data_ptr(), out.data_ptr(),
                B, N, Q, K, C, D, kernels.stream_ptr(feat.device))
        if rc:
            sys.exit(f"the parent's fp32 gather-GEMM failed: CUDA error {rc}")
        return out
    return conv


RANDOM_WIDTHS = ((4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
                 (3, 5), (3, 63), (33, 5), (33, 40), (33, 63), (64, 1),
                 (1, 64))


def random_ratios(versions, dev):
    """The largest ratio, by version, of its error against fp64 to the fp32
    plain version's, over RANDOM_WIDTHS x seeds 3-5, with N(0, 1) features
    and with them clamped at 0."""
    worst = {}
    for relu in (False, True):
        for C, D in RANDOM_WIDTHS:
            for seed in (3, 4, 5):
                g = torch.Generator().manual_seed(seed)
                B, N, Q, K = 2, 300, 333, 27
                f = torch.randn(B, N, C, generator=g)
                if relu:
                    f = f.clamp_min(0)
                w = torch.randn(K, C, D, generator=g) / (K * C) ** 0.5
                tap_idx = torch.randint(0, N, (B, K, Q), generator=g,
                                        dtype=torch.int32)
                found = torch.rand((B, K, Q), generator=g) < 0.3
                a = [t.to(dev) for t in (f, tap_idx, found, w)]
                want = subm.gather_gemm_plain(a[0].double(), a[1], a[2],
                                              a[3].double())
                plain = cs.errors(subm.gather_gemm_plain(*a).double(),
                                  want)[1]
                for name, fn in versions.items():
                    r = cs.errors(fn(*a).double(), want)[1] / plain
                    key = (name, relu)
                    if r > worst.get(key, (0.0,))[0]:
                        worst[key] = (r, C, D, seed)
    for (name, relu), (r, C, D, seed) in sorted(worst.items()):
        print(f"random rulebooks, {'clamped' if relu else 'N(0, 1)'} "
              f"features: {name} at most {r:.3f} times the fp32 plain "
              f"version's error against fp64 ({C}->{D}, seed {seed})")


def padded_ops(found, C, D, rows=128):
    """Operations of the padded product: 2 C D for every row of every
    (tile, tap) pair in which some row found the tap."""
    B, K, Q = found.shape
    f = found.permute(1, 0, 2).reshape(K, B * Q).to(torch.uint8)
    f = torch.nn.functional.pad(f, (0, -f.shape[1] % rows))
    return 2.0 * C * D * rows * int(f.view(K, -1, rows).amax(-1).sum())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent_src", type=Path,
                        help="the parent's subm.cu, whose fp32 kernel to "
                        "time beside")
    parser.add_argument("--random", action="store_true",
                        help="also each version's error ratio on random "
                        "rulebooks")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    cfg = load_pipeline_config(cs.MC_CONFIG)
    reader = cfg.eval_input_reader
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device=dev,
        mixed_precision=cfg.train_config.enable_mixed_precision, seed=0)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     reader.max_number_of_voxels)
    points, mask, anchors = cs.build_inputs(cfg, assigner, info, dev,
                                            reader.batch_size)
    with torch.no_grad():
        with cs.recording([(subm, "gather_gemm")]) as calls:
            detect(net, spec, vspec, points, mask, anchors, device=dev)
            torch.cuda.synchronize()
        convs = [a for a, _ in calls["gather_gemm"]]
        del calls, net
        versions = {"port": subm.gather_gemm}
        if args.parent_src:
            versions["parent"] = parent_conv(args.parent_src)
        names = list(versions)
        # in turns: parent, port, port, parent
        order = names[:0:-1] + names[:1] + names[:1] + names[1:]
        tot = {name: 0.0 for name in names}
        tot.update(ops=0.0, padded=0.0)
        worst = 0.0
        dtimer = cs.DeviceTimer(dev)
        for k, (f, tap_idx, found, w) in enumerate(convs):
            a = (f, tap_idx, found, w)
            want = subm.gather_gemm_plain(f.double(), tap_idx, found,
                                          w.double())
            plain_err = cs.errors(subm.gather_gemm_plain(*a).double(),
                                  want)[1]
            errs = {name: cs.errors(fn(*a).double(), want)[1]
                    for name, fn in versions.items()}
            worst = max(worst, errs["port"] / max(plain_err, 1e-30))
            times = dtimer(
                [lambda fn=versions[name]: fn(*a) for name in order])
            ms = {name: [t for o, t in zip(order, times) if o == name]
                  for name in names}
            ops = 2.0 * f.shape[2] * w.shape[2] * int(found.sum())
            padded = padded_ops(found, f.shape[2], w.shape[2])
            tot["ops"] += ops
            tot["padded"] += padded
            for name in names:
                tot[name] += sum(ms[name]) / len(ms[name])
            print(f"conv {k:2d} B,N,C={tuple(f.shape)} K,Q="
                  f"{tuple(tap_idx.shape[1:])} D={w.shape[2]}: found "
                  f"{int(found.sum())} ({ops / 1e9:.3f} GFLOP, padded "
                  f"{padded / 1e9:.3f}); device ms " + "; ".join(
                      f"{name} " + ", ".join(f"{t:.4f}" for t in ms[name])
                      for name in names) +
                  f"; error against fp64: fp32 plain {plain_err:.3e}, " +
                  ", ".join(f"{name} {e:.3e}" for name, e in errs.items()))
        print(f"{len(convs)} convs: device " + ", ".join(
            f"{name} {tot[name]:.4f} ms" for name in names) +
            f"; found taps {tot['ops'] / 1e9:.3f} GFLOP (at 67 TF/s "
            f"{tot['ops'] / 67e9:.4f} ms; x3 at 495 TF/s "
            f"{3 * tot['ops'] / 495e9:.4f} ms), padded "
            f"{tot['padded'] / 1e9:.3f} GFLOP (at 67 TF/s "
            f"{tot['padded'] / 67e9:.4f} ms; x3 at 495 TF/s "
            f"{3 * tot['padded'] / 495e9:.4f} ms)")
        print(f"largest ratio of the port's error to the fp32 plain "
              f"version's: {worst:.3f} (the gate: at most 2)")
        if args.random:
            random_ratios(versions, dev)


if __name__ == "__main__":
    main()
