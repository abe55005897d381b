"""The sparse conv's weight gradient past 128 channels on one card: its
error against fp64 and its device time by chunks a tap.

    python3 scripts/torch_wide_wgrad.py [--old_grad_src SUBM_GRAD_CU] \
        [--chunks 0 1 2 4 8 16 32] [--train vfe256|vfe1] [--no_stages]

The calls: the weight gradients of the vfe256 train step's first convs and
last conv (chip_smoke.py's VFE256_PATCHES, train batch; with --train vfe1
every weight gradient of the VFE1_PATCHES train step, whose first is
[27, 128, 16]), and random bf16 and fp32 features and output gradients of
256 x 256, 200 x 136, 128 x 128 and 256 x 16 over the rulebooks of stages
0 and 2 of the SECOND car.fhd eval forward (chip_smoke.py's fhd inputs;
not with --no_stages). For each: the largest error of this tree's kernel,
of the fp32 plain version (`gather_gemm_wgrad_plain`), of autograd of the
fp32 `gather_gemm_plain` (the yardstick chip_smoke.py's
`check_conv_backward` took before it took fp64) and, with --old_grad_src,
of another `subm_grad.cu` (built with this tree's flags; the same
`subm_wgrad` entry) against the plain version in fp64, over the fp64
result's largest entry, and how many entries rounded to bf16 miss one
bf16 unit of the larger of the two plus 1e-6 of that scale (the bound of
`check_conv_backward`), with the largest such miss over its bound; then,
for the stage calls, the
device-only ms (chip_smoke.py's DeviceTimer, L2 flushed, median of 5) with
each chunk count of --chunks forced (0: `wgrad_plan`'s own), with each
result's error against the fp32 plain version. Prints the card's name and
power limit first.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.models import build_voxelnet, detect  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops import sparse_conv  # noqa: E402
from second_tpu_torch.ops.cuda import subm  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import make_train_step  # noqa: E402


def errors(name, args, fns):
    """Each version's largest error against the fp64 plain version, over
    the fp64 result's largest entry, and its bf16-rounded misses."""
    want = subm.gather_gemm_wgrad_plain(*[a.double() if a.is_floating_point()
                                          else a for a in args])
    scale = want.abs().max().item()
    out = []
    for tag, fn in fns.items():
        if fn is None:
            got = subm.gather_gemm_wgrad_plain(*args)
        elif isinstance(fn, str):
            f, tap_idx, found, dout = args
            w = torch.zeros(tap_idx.shape[1], f.shape[2], dout.shape[2],
                            device=f.device, requires_grad=True)
            with torch.enable_grad():
                (subm.gather_gemm_plain(f.detach().float(), tap_idx, found,
                                        w) * dout.detach().float()
                 ).sum().backward()
            got = w.grad
        else:
            subm._wgrad_launch = fn
            got = subm.sparse_wgrad(*args)
        b = got.bfloat16().double()
        bound = 2.0 ** -7 * torch.maximum(b.abs(), want.abs()) + \
            1e-6 * scale
        margin = ((b - want).abs() / bound).max().item()
        miss = (b - want).abs() > bound
        err = (got.double() - want).abs().max().item() / scale
        out.append(f"{tag} {err:.3e} (bf16 misses {int(miss.sum())}, "
                   f"largest {margin:.3g} of the bound)")
    subm._wgrad_launch = fns["this"]
    print(f"{name}: scale {scale:.4g}; " + "; ".join(out), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old_grad_src", type=Path,
                        help="another subm_grad.cu with this tree's entry")
    parser.add_argument("--chunks", type=int, nargs="*",
                        default=[0, 1, 2, 4, 8, 16, 32])
    parser.add_argument("--train", choices=("vfe256", "vfe1"),
                        default="vfe256",
                        help="whose train step's weight gradients to hold")
    parser.add_argument("--no_stages", action="store_true",
                        help="skip the random calls on the stage rulebooks")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    kernels.build(("subm", "subm_grad"))
    fns = {"this": subm._resolve_wgrad(), "plain fp32": None,
           "autograd fp32": "autograd"}
    if args.old_grad_src:
        lib, _ = kernels.build_variant(args.old_grad_src, "wgrad_old",
                                       "subm_grad")
        fns["old"] = lib.subm_wgrad
        fns["old"].argtypes = subm._WGRAD_ARGTYPES
        fns["old"].restype = ctypes.c_int
    dt = cs.DeviceTimer(dev)
    plan = subm.wgrad_plan
    with torch.no_grad():
        patches = {"vfe256": cs.VFE256_PATCHES, "vfe1": cs.VFE1_PATCHES}
        cfg = cs.patched_config(patches[args.train])
        state, spec, info, assigner = cs.new_train_state(cfg, dev, True)
        vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                         cs.TRAIN_VOXELS,
                                         shuffle_overflow=True)
        batch = cs.train_inputs(cfg, assigner, info, dev, cs.TRAIN_BATCH)
        with cs.recording(cs.RECORDED_TRAIN) as calls:
            make_train_step(spec, vspec)(state, batch)
            torch.cuda.synchronize()
        for i, (a, _) in enumerate(calls["sparse_wgrad"]):
            if args.train == "vfe1" or \
                    i in (0, 1, len(calls["sparse_wgrad"]) - 1):
                errors(f"{args.train} train wgrad {i} {a[0].shape[2]} -> "
                       f"{a[3].shape[2]}", a, fns)
        del state, calls
        if args.no_stages:
            return
        cfg = cs.load_pipeline_config(cs.CONFIG)
        net, spec, info, assigner, _ = build_voxelnet(
            cfg.model, device=dev, mixed_precision=True, seed=0)
        vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                         cs.MAX_VOXELS)
        points, mask, anchors = cs.build_inputs(cfg, assigner, info, dev)
        with cs.recording([(sparse_conv, "subm_rulebook_b")]) as calls:
            detect(net, spec, vspec, points, mask, anchors, device=dev)
        del net
        g = torch.Generator(device=dev).manual_seed(20)
        for si in (0, 2):
            coords, keys, valid, grid = calls["subm_rulebook_b"][si][0][:4]
            tap_idx, found = sparse_conv.subm_rulebook_b(coords, keys, valid,
                                                         grid)
            B, K, N = tap_idx.shape
            for dtype in (torch.bfloat16, torch.float32):
                for C, D in ((256, 256), (200, 136), (128, 128), (256, 16)):
                    f = torch.randn(B, N, C, device=dev,
                                    generator=g).to(dtype)
                    dout = torch.randn(B, N, D, device=dev,
                                       generator=g).to(dtype)
                    a = (f, tap_idx, found, dout)
                    name = f"stage {si} N {N} {str(dtype)[6:]} {C} -> {D}"
                    errors(name, a, fns)
                    want = subm.gather_gemm_wgrad_plain(*a)
                    scale = want.abs().max().item()
                    res = []
                    for m in args.chunks:
                        def forced(M, K_, C_, D_, sms, m=m):
                            rows, ch = plan(M, K_, C_, D_, sms)
                            if m:
                                rows = -(-max(1, -(-M // m)) // 16) * 16
                                ch = max(1, -(-M // rows))
                            return rows, ch
                        subm.wgrad_plan = forced
                        err = (subm.sparse_wgrad(*a) - want).abs().max()
                        ms = dt([lambda: subm.sparse_wgrad(*a)])[0]
                        subm.wgrad_plan = plan
                        res.append(f"{m or 'plan'}: {ms:.4f} ms "
                                   f"({err.item() / scale:.1e})")
                    print(f"{name} by chunks a tap: " + "  ".join(res),
                          flush=True)


if __name__ == "__main__":
    main()
