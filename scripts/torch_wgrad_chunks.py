"""Device time of the sparse weight gradient by its chunking, on one card.

    python3 scripts/torch_wgrad_chunks.py     # on the machine with the card

Captures the 14 `sparse_wgrad` calls of one SECOND car.fhd train step (the
batch, weights and voxel capacity of chip_smoke.py's train phase), prints
each call's shapes and pointer alignment, then times all 14 calls on the
card (chip_smoke.py's DeviceTimer: device-only time, L2 flushed before each
call, median of 5) for several settings of
`second_tpu_torch/ops/cuda/subm.py`: WGRAD_BLOCKS_PER_SM in waves of the
three blocks an SM holds, and WGRAD_MAX_CHUNKS (the chunks a tap); the sum
and each call in µs.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.ops.cuda import subm  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import make_train_step  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = True
    cfg = load_pipeline_config(cs.CONFIG)
    state, spec, info, assigner = cs.new_train_state(cfg, dev, True)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator,
                                     cs.TRAIN_VOXELS, shuffle_overflow=True)
    batch = cs.train_inputs(cfg, assigner, info, dev, cs.TRAIN_BATCH)
    with cs.recording(cs.RECORDED_TRAIN) as calls:
        make_train_step(spec, vspec)(state, batch)
        torch.cuda.synchronize()
    wc = [a for a, _ in calls["sparse_wgrad"]]
    print(cs.card_line())
    for i, (f, t, fo, d) in enumerate(wc):
        print(i, tuple(f.shape), tuple(t.shape), tuple(d.shape),
              "found", int(fo.sum()), "feat ptr % 16", f.data_ptr() % 16,
              "dout ptr % 16", d.data_ptr() % 16)
    dt = cs.DeviceTimer(dev)
    for waves in (1, 2, 3, 4, 6):
        for max_chunks in (32, 64):
            subm.WGRAD_BLOCKS_PER_SM = 3 * waves
            subm.WGRAD_MAX_CHUNKS = max_chunks
            ts = dt([lambda a=a: subm.sparse_wgrad(*a) for a in wc], reps=5)
            print(f"waves {waves} (blocks/SM {3 * waves}) max_chunks "
                  f"{max_chunks}: total "
                  f"{sum(ts):.4f} ms; per call "
                  + " ".join(f"{x * 1e3:.0f}" for x in ts))


if __name__ == "__main__":
    main()
