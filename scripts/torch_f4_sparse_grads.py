"""Fault F4 on the CPU: fp32 train-step gradients of the tiny sparse model
against fp64, tensor by tensor, with an fp64 witness from each side: the
port's fp32 step (port32), JAX's eager fp32 step (jax32), the port's fp64
step (port64) and the port's fp32 step with the fp64 step's ReLU masks
replayed in the sparse middle (replay32), each against JAX's eager fp64
step (`jax_grads64` in `tests/test_torch_multiclass.py`), as a share of the
tensor's largest entry (tensors with an entry beyond 1e-5 printed); then,
per sparse-middle ReLU, the sites where the port's fp32 forward and its
fp64 forward disagree on the sign of the ReLU input, with that input's
fp64 size and the layer's largest fp32 deviation, beside the same for
JAX's fp32 forward against its fp64 one (the norms' outputs, captured by
flax). For the 3-class model on
the batches of seeds 1 and 3 of the denser scenes (F4_SCENE) and of seed
0 of the sparse ones, and the IoU-branch model of
`tests/test_torch_iou_branch.py` on its weights. About
ten minutes:

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_f4_sparse_grads.py
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from second_tpu_torch.convert import grads_from_jax  # noqa: E402

import test_torch_iou_branch as tib  # noqa: E402
import test_torch_multiclass as t  # noqa: E402

# the sparse middle's norms in call order (the port's ReLU order)
ORDER = ["SubMBlock_0", "SubMBlock_1", "DownBlock_0", "SubMBlock_2",
         "SubMBlock_3", "DownBlock_1", "SubMBlock_4", "SubMBlock_5",
         "SubMBlock_6", "DownBlock_2", "SubMBlock_7", "SubMBlock_8",
         "SubMBlock_9", "DownBlock_3"]


def jax_relu_inputs(pipeline, variables, batch, x64):
    """JAX's train-mode forward, eagerly, in fp32 or (as `jax_grads64`)
    fp64: the sparse middle's norm outputs (its ReLU inputs) in ORDER."""
    jcfg = t.jax_loads(pipeline)
    module = t.jax_build_voxelnet(jcfg.model)[0]
    vspec = t.JVoxelizeSpec.from_config(jcfg.model.voxel_generator,
                                        t.MAX_VOXELS, shuffle_overflow=True)
    dt = np.float64 if x64 else np.float32

    def cast(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(dt) if a.dtype.kind == "f" else a)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64), \
            jax.disable_jit():
        if x64:
            mp.setattr(jnp, "float32", jnp.float64)
        v = jax.tree.map(cast, variables)
        b = {k: cast(x) for k, x in batch.items()}
        vox = t.jax_device_voxelize(vspec, b["points"], b["points_mask"])
        _, state = module.apply(
            v, vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"], train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: type(mdl).__name__ ==
            "MaskedBatchNorm")
        found = {}
        for path, x in jax.tree_util.tree_flatten_with_path(
                state["intermediates"])[0]:
            keys = [getattr(k, "key", None) for k in path]
            if "MaskedBatchNorm_0" in keys:
                found[keys[keys.index("MaskedBatchNorm_0") - 1]] = \
                    np.asarray(x, np.float64)
        return [found[name] for name in ORDER]


def flips(pre32, pre64):
    """Per ReLU: (sign flips, largest fp64 input at a flip, largest fp32
    deviation)."""
    out = []
    for a, b in zip(pre32, pre64):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        f = (a > 0) != (b > 0)
        out.append((int(f.sum()), float(np.abs(b[f]).max()) if f.any()
                    else 0.0, float(np.abs(a - b).max())))
    return out


def report(what, run):
    jax32 = grads_from_jax(run["jgrads"])
    want = run["jgrads64"]
    print(f"{what}: loss port {float(run['tm']['loss']):.9g} jax "
          f"{float(run['jm']['loss']):.9g}; stage_overflow "
          f"{int(run['tm']['stage_overflow'])}")
    cols = {"port32": run["tgrads"], "jax32": jax32,
            "port64": run["grads64"]}
    if "replayed32" in run:
        cols["replay32"] = run["replayed32"]
    print(f"  {'tensor':32s} " + " ".join(f"{c:>10s}" for c in cols) +
          "  (against jax64, of scale)")
    worst = {c: 0.0 for c in cols}
    for name in run["grads64"]:
        errs = {c: t._rel_err(g[name], want[name]) for c, g in cols.items()}
        for c, e in errs.items():
            worst[c] = max(worst[c], e)
        if max(errs.values()) > 1e-5:
            print(f"  {name:32s} " +
                  " ".join(f"{e:10.2e}" for e in errs.values()))
    print(f"  {'largest':32s} " +
          " ".join(f"{e:10.2e}" for e in worst.values()))
    port = flips(run["pre32"], run["pre64"])
    pipeline = run.get("pipeline", t.TINY_SPARSE_MULTICLASS)
    jax_side = flips(
        jax_relu_inputs(pipeline, run["variables"], run["batch"], False),
        jax_relu_inputs(pipeline, run["variables"], run["batch"], True))
    print(f"  {'ReLU':4s} {'port: flips':>11s} {'at':>9s} {'fp32 dev':>9s}"
          f"   {'jax: flips':>10s} {'at':>9s} {'fp32 dev':>9s}")
    for i, (p, j) in enumerate(zip(port, jax_side)):
        print(f"  {i:4d} {p[0]:11d} {p[1]:9.3g} {p[2]:9.3g}   "
              f"{j[0]:10d} {j[1]:9.3g} {j[2]:9.3g}")


def main():
    report("3-class, F4_SCENE seed 3", t.mc_train(3, scene=t.F4_SCENE))
    report("3-class, F4_SCENE seed 1", t.mc_train(1, scene=t.F4_SCENE))
    report("3-class, SCENE seed 0", t.mc_train(0))
    report("IoU branch, its test's weights",
           dict(tib.iou_train_runs._get_wrapped_function()(),
                pipeline=tib.IOU_PIPELINE))


if __name__ == "__main__":
    main()
