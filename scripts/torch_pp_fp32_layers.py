"""Where the fp32 PointPillars train step loses precision, layer by layer.

    python scripts/torch_pp_fp32_layers.py      # CPU, about 30 s

The published PointPillars config (second_tpu_torch/configs/
pointpillars_car.config) on a quarter of its grid, one synthetic LiDAR scan
(SyntheticDataset(scan=True), seed 1) prepared with targets, flax's
initialisers (seed 0): one train-mode forward and backward in fp64 and in
fp32 from the same weights. Prints, for each module, the fp32 forward
activation's and the gradient of its output's largest error against fp64
(over the fp64 tensor's largest entry), the loss's relative error, every
parameter gradient's error, the ReLU inputs whose sign differs between
the two runs, and the gradients' errors when the fp32 run multiplies by
the fp64 run's ReLU masks instead. Imports torch and the port only.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from second_tpu_torch.config import loads_pipeline_config  # noqa: E402
from second_tpu_torch.data import ExamplePrep, PrepConfig  # noqa: E402
from second_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from second_tpu_torch.models import (build_voxelnet,  # noqa: E402
                                     compute_loss, init_train_weights_)
from second_tpu_torch.ops.voxelize import (VoxelizeSpec,  # noqa: E402
                                           device_voxelize)

CONFIG = (Path(__file__).resolve().parents[1] / "second_tpu_torch" /
          "configs" / "pointpillars_car.config")


def quarter_config():
    """The config on a range cropped to a quarter of its grid: every width
    and depth as published."""
    return (CONFIG.read_text()
            .replace("point_cloud_range: [0, -39.68, -3, 69.12, 39.68, 1]",
                     "point_cloud_range: [0, -19.84, -3, 34.56, 19.84, 1]")
            .replace("anchor_ranges: [0, -39.68, -1.78, 69.12, 39.68, -1.78]",
                     "anchor_ranges: [0, -19.84, -1.78, 34.56, 19.84, -1.78]"))


def step(dtype, masks=None):
    """(loss, activations, output gradients, parameter gradients, ReLU
    masks) of one forward and backward in `dtype`; with `masks`, each ReLU
    multiplies by the given mask."""
    cfg = loads_pipeline_config(quarter_config())
    vg, reader = cfg.model.voxel_generator, cfg.train_input_reader
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device="cpu", mixed_precision=False, seed=0)
    init_train_weights_(net, 0)
    net.to(dtype).train()
    prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=20000, training=True, shuffle_points=reader.shuffle_points,
        anchor_area_threshold=reader.anchor_area_threshold,
        voxel_size=tuple(vg.voxel_size), pc_range=tuple(vg.point_cloud_range)))
    scan = SyntheticDataset(1, seed=1, pc_range=tuple(vg.point_cloud_range),
                            scan=True)[0]
    batch = {k: torch.as_tensor(v) for k, v in prep.collate(
        [prep(scan, np.random.default_rng(0))]).items() if k != "image_idx"}
    vspec = VoxelizeSpec.from_config(vg, reader.max_number_of_voxels,
                                     shuffle_overflow=True)
    vox = device_voxelize(vspec, batch["points"], batch["points_mask"], "cpu")
    acts, grads, record = {}, {}, []

    def hook(name):
        def keep(module, args, out):
            out = out[0] if isinstance(out, tuple) else out
            acts[name] = out.detach().double()
            if out.requires_grad:
                out.register_hook(
                    lambda g: grads.__setitem__(name, g.detach().double()))
        return keep
    for name, m in net.named_modules():
        if name.startswith("vfe.layers.0.") or name in ("vfe", "middle") or \
                name.endswith(".norm") or name.startswith("rpn.head.") or \
                (name.count(".") == 3 and "trunk" in name):
            m.register_forward_hook(hook(name))
    relu, replay = torch.nn.functional.relu, iter(masks or ())

    def recording_relu(x, inplace=False):
        record.append(x.detach() > 0)
        return x * next(replay).to(x.dtype) if masks else relu(x)
    torch.nn.functional.relu = recording_relu
    try:
        preds = net(vox["voxels"].to(dtype), vox["num_points"],
                    vox["coordinates"], vox["voxel_valid"])
        loss = compute_loss(spec, preds, batch["labels"],
                            batch["reg_targets"], batch["anchors"].to(dtype))
        loss["loss"].backward()
    finally:
        torch.nn.functional.relu = relu
    return ({k: float(v.detach()) for k, v in loss.items()}, acts, grads,
            {n: p.grad.double() for n, p in net.named_parameters()}, record)


def err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()


def main():
    torch.set_num_threads(4)
    l64, a64, g64, p64, m64 = step(torch.float64)
    l32, a32, g32, p32, m32 = step(torch.float32)
    print("loss relative error:", {k: abs(l32[k] / l64[k] - 1)
                                   for k in l64 if l64[k]})
    print(f"{'module':28s} {'activation':>10s} {'d output':>10s}")
    for k in a64:
        print(f"{k:28s} {err(a32[k], a64[k]):10.2e} "
              f"{err(g32[k], g64[k]) if k in g64 else float('nan'):10.2e}")
    print("parameter gradients:")
    for k in p64:
        print(f"  {k:40s} {err(p32[k], p64[k]):.2e}")
    flips = [int((a != b).sum()) for a, b in zip(m32, m64)]
    print(f"ReLU inputs of another sign, by ReLU in forward order: {flips} "
          f"of {sum(m.numel() for m in m32)}")
    _, _, _, pr, _ = step(torch.float32, masks=m64)
    worst = max(p64, key=lambda k: err(p32[k], p64[k]))
    print(f"fp32: worst {worst} {err(p32[worst], p64[worst]):.2e}, "
          f"{sum(err(p32[k], p64[k]) > 1e-3 for k in p64)} of {len(p64)} "
          f"beyond 1e-3")
    worst = max(p64, key=lambda k: err(pr[k], p64[k]))
    print(f"fp32 with the fp64 ReLU masks: worst {worst} "
          f"{err(pr[worst], p64[worst]):.2e}")


if __name__ == "__main__":
    main()
