"""The sparse middle's fp32 ReLU inputs on the card against the CPU's, on
the inputs of the card test
`test_sparse_middle_weights_get_gradients_on_the_card` (SpMiddleFHD on a
[41, 64, 64] grid, 2 x 2048 sites, its seeds): one train-mode backward on
each device, then per ReLU the inputs whose sign the two devices see
differently, each as |x| over the layer's largest |x| (the CPU's), and per
sparse weight the largest difference of the card's own gradient from the
CPU's over the CPU's largest entry (the test's gate: 1e-3).

    python3 scripts/torch_relu_flips.py [--root CHECKOUT]

`--root` imports `second_tpu_torch` from another checkout (the parent
commit's, unpacked by `git archive`), so that its kernels take the same
inputs; the inputs come from this checkout's test file.
"""

import argparse
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]


class ReluTap:
    """Stands in for `torch` in `models/sparse_middle.py` (whose blocks call
    `torch.relu`): keeps each ReLU's input, in call order, in `pre`."""

    def __init__(self):
        self.pre = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def relu(self, x):
        self.pre.append(x.detach().clone())
        return torch.relu(x)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="the checkout whose second_tpu_torch to run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path[:0] = [str(args.root.resolve()), str(HERE / "tests")]
    import test_torch_cuda as t  # noqa: E402
    from second_tpu_torch.models import sparse_middle  # noqa: E402
    print(f"second_tpu_torch from {Path(sparse_middle.__file__).parents[1]}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the card test's model and inputs, drawn in its order
    grid = (41, 64, 64)
    g = torch.Generator().manual_seed(24)
    coords, _, valid, _ = t._active_set(torch.device("cpu"), 2, 2048, grid,
                                        25)
    feats = torch.randn(2, 2048, 4, generator=g) * valid[..., None]
    proto = sparse_middle.SparseMiddleFHD(grid, num_input_features=4)
    blocks = (sparse_middle.SubMBlock, sparse_middle.DownBlock)
    for m in proto.modules():
        if isinstance(m, blocks):
            K, cin, _ = m.weight.shape
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) *
                               (K * cin) ** -0.5)
    cot = None

    def run(device, tap):
        nonlocal cot
        mid = sparse_middle.SparseMiddleFHD(grid, num_input_features=4)
        mid.load_state_dict(proto.state_dict())
        mid = mid.to(device).train()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sparse_middle, "torch", tap)
            bev, _ = mid(feats.to(device), coords.to(device),
                         valid.to(device))
            if cot is None:
                cot = torch.randn(bev.shape, generator=g)
            (bev * cot.to(device)).sum().backward()
        return [m.weight.grad.cpu() for m in mid.modules()
                if isinstance(m, blocks)]

    card_tap, cpu_tap = ReluTap(), ReluTap()
    got = run(dev, card_tap)
    want = run(torch.device("cpu"), cpu_tap)
    flipped = 0
    for i, (x, y) in enumerate(zip(card_tap.pre, cpu_tap.pre)):
        flips = (x.cpu() > 0) != (y > 0)
        flipped += int(flips.sum())
        if flips.any():
            scale = y.abs().max().item()
            print(f"ReLU {i}: {int(flips.sum())} inputs on two sides of "
                  f"zero, |x| / scale " + ", ".join(
                      f"{v:.3e}" for v in (y[flips].abs() / scale).tolist()))
    print(f"{flipped} ReLU inputs on two sides of zero over "
          f"{len(cpu_tap.pre)} ReLUs")
    worst = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(got, want))
    print(f"the card's own sparse weight gradients: at most {worst:.3e} of "
          f"a tensor's largest entry from the CPU's (the test's gate 1e-3)")


if __name__ == "__main__":
    main()
