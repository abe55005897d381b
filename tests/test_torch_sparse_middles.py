"""The port's sparse middles and their blocks (`second_tpu_torch.models.
sparse_middle`, `ops/sparse_conv.py` `sparse_max_pool3d_b`) against the JAX
package's, on the CPU, with the same numpy-drawn weights carried across by
the converter: `SparseBasicBlock` (fp32 and bf16), `SparseBottleneck`, the
max pool and its tie gradient, and whole `SpMiddleResNetFHD` (fp32 and
bf16), `SpMiddleFHDLite`, `SpMiddleFHDLarge`, `SpMiddleFHDV2`, a stack spec
with every op kind, a stack whose bottleneck feeds 256 channels to sparse
convs, and `SparseMiddleExtractor` fed 128 channels. Also: the
registries hold JAX's names, each stack's op spec is JAX's, and the new
trees convert leaf for leaf. Then the tiny sparse pipeline with
`SpMiddleResNetFHD` (the middle the reference's conv fusion config names)
end to end: voxelize → forward → predict in fp32 (voxels exact,
predictions within 1e-4, `valid` exact), the whole tree through the
converter, and one train step's gradient in fp64 against JAX's (jitted,
x64, `jnp.float32` read as fp64: `jax_grads64`) within GRAD64_TOL of each
tensor's largest entry.

The JAX side never initialises eagerly (`jax.eval_shape` of the init, the
tree filled from numpy) and compiles each function once; the port runs on
one thread. fp32 outputs agree within 1e-4 (`TOL`, as the model tests'),
integer outputs (sites, keys, masks, rulebook hits, overflow counts)
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import second_tpu.models.sparse_middle as jsm
from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.data import ExamplePrep, PrepConfig
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import predict as jax_predict
from second_tpu.models.middle import MIDDLE_REGISTRY as JAX_MIDDLES
from second_tpu.models.voxel_encoder import VFE_REGISTRY as JAX_VFES
from second_tpu.ops import sparse_conv as jsp
from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.state import sum_stage_overflow
from second_tpu_torch import convert
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.models import build_voxelnet, detect
from second_tpu_torch.models import sparse_middle as tsm
from second_tpu_torch.models.middle import MIDDLE_REGISTRY
from second_tpu_torch.models.voxel_encoder import VFE_REGISTRY
from second_tpu_torch.ops import sparse_conv as sp
from second_tpu_torch.ops.voxelize import VoxelizeSpec

from test_torch_model import (MAX_VOXELS, TOL, _assert_bf16_rounding_equal,
                              _random_variables)
from test_torch_multiclass import GRAD64_TOL, _port_grads, _rel_err, \
    jax_grads64
from test_torch_temporal import one_thread
from test_torch_train import _tiny_batch


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield

# every op kind, a bottleneck among them: SubM, two residual blocks (the
# first with a projection), a strided conv, a bottleneck (16 → 4·8 = 32,
# with its projection), a max pool, a bottleneck without projection
# (32 → 4·8), a z-only strided conv
EVERY_OP = (("subm", 16), ("res", 24), ("res", 24),
            ("down", 16, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
            ("bottleneck", 8), ("maxpool", (2, 1, 1)), ("bottleneck", 8),
            ("down", 32, (3, 1, 1), (2, 1, 1), (0, 0, 0)))


BOTTLENECK_256 = (("subm", 16), ("bottleneck", 64), ("subm", 256),
                  ("down", 32, (3, 3, 3), (2, 2, 2), (1, 1, 1)))


def _active_set(rng, grid, B, N, C, n_valid):
    """B examples of N rows: n_valid distinct active sites each (unsorted,
    the rest padding), fp32 features [B, N, C]."""
    D, H, W = grid
    coords = np.zeros((B, N, 3), np.int32)
    for b in range(B):
        lin = rng.choice(D * H * W, size=n_valid, replace=False)
        coords[b, :n_valid] = np.stack([lin // (H * W), (lin // W) % H,
                                        lin % W], 1)
    feats = rng.normal(0, 1, (B, N, C)).astype(np.float32)
    valid = np.arange(N)[None, :] < n_valid
    valid = np.repeat(valid, B, 0)
    perm = rng.permutation(N)
    return (np.ascontiguousarray(feats[:, perm]),
            np.ascontiguousarray(coords[:, perm]),
            np.ascontiguousarray(valid[:, perm]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_state(tree_params, tree_stats):
    """The converter's entries of a lone middle tree, by the middle's own
    parameter names."""
    out = {}
    convert._middle(out, "m", tree_params, tree_stats)
    return {k[2:]: v for k, v in out.items()}


def _jax_middle(module, inputs, seed=1, compile_opts=None):
    """A flax middle's random variables (eval_shape, then numpy), its
    jitted eval output and its summed stage overflow."""
    args = tuple(jnp.asarray(a) for a in inputs)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    variables = _random_variables(shapes, np.random.default_rng(seed))

    def fwd(v, *a):
        out, state = module.apply(v, *a, mutable=["intermediates"])
        return out, sum_stage_overflow(state.get("intermediates", {}))
    lowered = jax.jit(fwd).lower(variables, *args)
    out, overflow = lowered.compile(compile_opts)(variables, *args)
    return variables, np.asarray(out.astype(jnp.float32)), int(overflow)


def _port_middle(name, kwargs, variables):
    m = MIDDLE_REGISTRY[name](**kwargs).eval()
    m.load_state_dict(_port_state(variables["params"],
                                  variables["batch_stats"]), strict=True)
    return m


# (name, constructor kwargs beyond output_shape, zyx grid, input width,
# valid rows a example, bf16): the grids are those of
# `test_round2_parity.py` (`TestMiddleVariants.CASES`), 16 x 16 in BEV
MIDDLE_CASES = {
    "resnet": ("SpMiddleResNetFHD", {}, (41, 16, 16), 4, 200, False),
    "resnet_bf16": ("SpMiddleResNetFHD", {}, (41, 16, 16), 4, 200, True),
    "lite": ("SpMiddleFHDLite", {}, (41, 16, 16), 4, 200, False),
    "large": ("SpMiddleFHDLarge", {}, (41, 16, 16), 4, 200, False),
    "fhd_v2": ("SpMiddleFHDV2", {}, (41, 16, 16), 4, 200, False),
    "every_op": ("stack", {"ops": EVERY_OP}, (21, 16, 16), 8, 150, False),
    # a bottleneck's 4 x 64 = 256 channels into a 256 -> 256 submanifold
    # conv and a 256 -> 32 strided conv, through the gather-GEMM at 256
    "bottleneck_256": ("stack", {"ops": BOTTLENECK_256}, (21, 16, 16), 8,
                       150, False),
    "extractor_128": ("SparseMiddleExtractor",
                      {"num_filters_down1": (32,),
                       "num_filters_down2": (16, 16)},
                      (21, 16, 16), 128, 150, False),
}


@pytest.mark.parametrize("case", sorted(MIDDLE_CASES))
def test_middle_matches_jax(case):
    """The dense BEV map (NHWC in JAX, NCHW here) within 1e-4 in fp32, and
    the stage overflow count exactly (capacities that cut sites: the fhd
    family's 1024-rounded caps at 40 rows a stage are not cut, the stacks'
    int(N · 1.0) are). In bf16 (JAX compiled without the CPU's excess
    precision, so each bf16 cast rounds), the one-unit rounding
    differences of the blocks (see the block test) grow through the
    stages: the map agrees within 2^-6 of its largest entry."""
    name, extra, grid, cin, n_valid, bf16 = MIDDLE_CASES[case]
    rng = np.random.default_rng(sorted(MIDDLE_CASES).index(case))
    inputs = _active_set(rng, grid, 2, 256, cin, n_valid)
    if name == "stack":
        jmod = jsm.SparseMiddleStack(output_shape=grid, num_input_features=cin,
                                     **extra)
        kwargs = dict(output_shape=grid, num_input_features=cin, **extra)
        name = None
    else:
        jkw = dict(extra, output_shape=grid, num_input_features=cin)
        if name == "SparseMiddleExtractor":
            jkw["num_input_features"] = 4      # JAX infers the 128 in
        if bf16:
            jkw["dtype"] = "bfloat16"
        jmod = JAX_MIDDLES[name](**jkw)
        kwargs = dict(extra, output_shape=grid, num_input_features=cin)
        if name == "SparseMiddleExtractor":
            kwargs.update(num_input_features=4, in_channels=cin)
        if bf16:
            kwargs["dtype"] = torch.bfloat16
    opts = {"xla_allow_excess_precision": False} if bf16 else None
    variables, want, want_ovf = _jax_middle(jmod, inputs, compile_opts=opts)
    if name is None:
        port = tsm.SparseMiddleStack(**kwargs).eval()
        port.load_state_dict(_port_state(variables["params"],
                                         variables["batch_stats"]))
    else:
        port = _port_middle(name, kwargs, variables)
    with torch.no_grad():
        got, ovf = port(*(_t(a) for a in inputs))
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert port.out_channels == want.shape[-1]
    if bf16:
        assert got.dtype == np.float32 and port.dtype == torch.bfloat16
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **TOL)
    assert int(ovf) == want_ovf
    if case == "every_op":
        assert want_ovf > 0         # the stack's unrounded capacity cuts


def test_registries_hold_jax_names():
    assert sorted(MIDDLE_REGISTRY) == sorted(JAX_MIDDLES)
    assert sorted(VFE_REGISTRY) == sorted(JAX_VFES)


@pytest.mark.parametrize("name", sorted(
    n for n in JAX_MIDDLES if n not in ("SpMiddleFHD", "SpMiddleFHDLite",
                                        "SpMiddleResNetFHD",
                                        "PointPillarsScatter")))
def test_stack_spec_matches_jax(name):
    """Each registry stack's op spec is JAX's (the flax module's `ops`
    field; nothing is compiled), and for `SparseMiddleExtractor` the
    spec its widths give, where the config's `num_input_features` is the
    first strided conv's width when `num_filters_down1` is empty."""
    variants = [{}]
    if name == "SparseMiddleExtractor":
        variants = [{}, {"num_filters_down1": (16,),
                         "num_filters_down2": (16, 32)},
                    {"num_filters_down2": (8,), "num_input_features": 12}]
    for kw in variants:
        kw = dict({"output_shape": (41, 16, 16)}, **kw)
        want = JAX_MIDDLES[name](**kw).ops
        got = MIDDLE_REGISTRY[name](**kw).ops
        assert got == tuple(tuple(o) for o in want), (name, kw)


def _jax_block(block, feats, coords, valid, grid, dtype=None, train=False):
    """A flax block applied to the sorted active set, jitted: its random
    variables (numpy), output and the sorted set."""
    def run(v, f, c, m):
        c, f, m, k = jax.vmap(lambda c_, f_, m_: jsp.sort_active(
            c_, f_, m_, grid))(c, f, m)
        if dtype is not None:
            f = f.astype(dtype)
        out = block.apply(v, f, c, k, m, train,
                          mutable=["batch_stats"] if train else False)
        return (out[0] if train else out), c, f, m, k
    args = tuple(jnp.asarray(a) for a in (feats, coords, valid))

    def init():
        c, f, m, k = jax.vmap(lambda c_, f_, m_: jsp.sort_active(
            c_, f_, m_, grid))(args[1], args[0], args[2])
        return block.init(jax.random.PRNGKey(0), f if dtype is None
                          else f.astype(dtype), c, k, m)
    variables = _random_variables(jax.eval_shape(init),
                                  np.random.default_rng(3))
    lowered = jax.jit(run).lower(variables, *args)
    out = lowered.compile({"xla_allow_excess_precision": False})(
        variables, *args)
    return variables, out


def _load_block(port, variables):
    sd = {}
    convert._middle(sd, "m", {"SparseBasicBlock_0": variables["params"]}
                    if isinstance(port, tsm.SparseBasicBlock) else
                    {"SparseBottleneck_0": variables["params"]},
                    None if "batch_stats" not in variables else
                    {"SparseBasicBlock_0": variables["batch_stats"],
                     "SparseBottleneck_0": variables["batch_stats"]})
    attr = "res" if isinstance(port, tsm.SparseBasicBlock) else "bottleneck"
    port.load_state_dict({k[len(f"m.{attr}.0."):]: v for k, v in sd.items()},
                         strict=True)


@pytest.mark.parametrize("kind,cin,features,bf16", [
    ("res", 12, 16, False), ("res", 16, 16, True), ("res", 8, 16, True),
    ("bottleneck", 12, 8, False), ("bottleneck", 32, 8, False)])
def test_residual_block_matches_jax(kind, cin, features, bf16):
    """`SparseBasicBlock` and `SparseBottleneck` in eval mode on JAX's
    sorted set and rulebook, with and without the projection: fp32 within
    1e-4; bf16 as JAX rounds it (one bf16 conv launch on the input, one
    fp32 on the first norm's output, one cast back at the end:
    `_assert_bf16_rounding_equal`)."""
    grid = (9, 12, 12)
    rng = np.random.default_rng(cin * 100 + features)
    feats, coords, valid = _active_set(rng, grid, 2, 192, cin, 150)
    jcls = jsm.SparseBasicBlock if kind == "res" else jsm.SparseBottleneck
    dtype = jnp.bfloat16 if bf16 else None
    variables, (want, c, f, m, k) = _jax_block(
        jcls(features, grid), feats, coords, valid, grid, dtype)
    port = (tsm.SparseBasicBlock if kind == "res" else tsm.SparseBottleneck)(
        cin, features).eval()
    _load_block(port, variables)
    tf = _t(f.astype(jnp.float32))
    if bf16:
        tf = tf.bfloat16()
    tc, tm, tk = _t(c), _t(m), _t(k)
    with torch.no_grad():
        rb = sp.subm_rulebook_b(tc, tk, tm, grid)
        got = port(tf, tc, tk, tm, grid, rb)
    if bf16:
        _assert_bf16_rounding_equal(got, want, f"{kind} {cin}->{features}")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pool_inputs(seed):
    """An active set whose features tie often: post-ReLU zeros and values
    on a grid of quarters."""
    grid = (10, 8, 8)
    rng = np.random.default_rng(seed)
    feats, coords, valid = _active_set(rng, grid, 2, 160, 6, 130)
    feats = np.maximum(np.round(feats * 2) / 4, 0).astype(np.float32)
    return grid, feats, coords, valid


@pytest.mark.parametrize("cap", [128, 40])
def test_max_pool_matches_jax(cap):
    """`sparse_max_pool3d_b` (2, 1, 1) against JAX's: output sites, keys,
    valid mask, site count and the found taps exactly (JAX's `lookup_many_b`
    against the port's rulebook), the pooled features exactly, with a
    capacity that holds every site and one that cuts (the rank-stratified
    subset); the gradient of a weighted sum of the output against
    `jax.grad` within 1e-6, ties (shared evenly by both) among them."""
    grid, feats, coords, valid = _pool_inputs(cap)
    kernel = (2, 1, 1)
    r = np.random.default_rng(7).normal(size=(2, cap, 6)).astype(np.float32)

    def jax_pool(f, c, m):
        c, f, m, k = jax.vmap(lambda c_, f_, m_: jsp.sort_active(
            c_, f_, m_, grid))(c, f, m)
        out, oc, ok, ov, _, nu = jsp.sparse_max_pool3d_b(
            f, c, k, m, grid, kernel, cap)
        return out, oc, ok, ov, nu, c, f, m, k

    def jax_found(c, f, m):
        c, f, m, k = jax.vmap(lambda c_, f_, m_: jsp.sort_active(
            c_, f_, m_, grid))(c, f, m)
        oc, ov, _, _, _ = jsp._gen_output_sites_b(c, m, grid, kernel, kernel,
                                                  (0, 0, 0), cap)
        offs = jsp._offsets(kernel)
        qks, inbs = [], []
        for o in range(offs.shape[0]):
            ic = oc * np.array(kernel, np.int32) + offs[o]
            inb = ((ic >= 0) & (ic < np.array(grid))).all(-1) & ov
            qks.append(jnp.where(inb, jsp.linearize(ic, grid),
                                 jsp.sentinel(grid)))
            inbs.append(inb)
        return jsp.lookup_many_b(k, jnp.stack(qks, 1), jnp.stack(inbs, 1))

    def jax_loss(f, c, m):
        return (jax_pool(f, c, m)[0] * r).sum()

    args = tuple(jnp.asarray(a) for a in (feats, coords, valid))
    out, oc, ok, ov, nu, c, f, m, k = jax.jit(jax_pool)(*args)
    jidx, jfound = jax.jit(jax_found)(args[1], args[0], args[2])
    jgrad = jax.jit(jax.grad(jax_loss))(*args)

    tc, tf, tm, tk = sp.sort_active(_t(coords), _t(feats), _t(valid), grid)
    tf.requires_grad_(True)
    got, gc, gk, gv, ggrid, gnu = sp.sparse_max_pool3d_b(
        tf, tc, tk, tm, grid, kernel, cap)
    for name, g, w in (("coords", gc, oc), ("keys", gk, ok),
                       ("valid", gv, ov), ("n_unique", gnu, nu)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert ggrid == sp.out_grid(grid, kernel, kernel, (0, 0, 0))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    base = gc * torch.tensor(kernel, dtype=torch.int32)
    tidx, tfound = sp.build_rulebook_b(tk, base, gv, grid, kernel)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tidx.numpy()[tfound.numpy()],
                                  np.asarray(jidx)[np.asarray(jfound)])
    (got * _t(r)).sum().backward()
    # JAX's gradient is by input row, the port's by sorted row (the sorted
    # sets agree, valid rows have distinct keys): map JAX's through the
    # stable sort by key
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
    keys = np.where(valid, (coords[..., 0] * grid[1] + coords[..., 1]) *
                    grid[2] + coords[..., 2], np.prod(grid))
    pos = np.argsort(keys, axis=1, kind="stable")
    want = np.take_along_axis(np.asarray(jgrad), pos[..., None], axis=1)
    np.testing.assert_allclose(tf.grad.numpy(), want, rtol=0, atol=1e-6)
    # ties: valid outputs where two found taps both hold the max
    rows = tf.detach()[torch.arange(2)[:, None, None], tidx.long()]
    at_max = tfound[..., None] & (rows == got.detach()[:, None])
    assert ((at_max.sum(1) >= 2) & gv[..., None]).any()
    assert (int(nu.max()) > cap) == (cap == 40)


def test_max_pool_block_counts_overflow():
    """`MaxPoolBlock` adds its cut sites to the overflow count, as
    `DownBlock` does: the sites over the capacity, per example, summed."""
    grid, feats, coords, valid = _pool_inputs(40)
    tc, tf, tm, tk = sp.sort_active(_t(coords), _t(feats), _t(valid), grid)
    with torch.no_grad():
        *_, nu = sp.sparse_max_pool3d_b(tf, tc, tk, tm, grid, (2, 1, 1), 40)
        *_, ovf = tsm.MaxPoolBlock((2, 1, 1))(tf, tc, tk, tm, grid, 40)
    assert int(ovf) == int(torch.clamp(nu - 40, min=0).sum()) > 0


def test_convert_new_middle_trees():
    """Every leaf of the every-op stack's tree (SubMBlock, SparseBasicBlock
    with and without `proj`, SparseBottleneck with and without `proj`,
    DownBlock; the max pool has none) lands in the port's state_dict under
    its documented name, unchanged, and the port has nothing else."""
    grid = (21, 16, 16)
    jmod = jsm.SparseMiddleStack(output_shape=grid, ops=EVERY_OP)
    inputs = _active_set(np.random.default_rng(5), grid, 1, 64, 8, 50)
    args = tuple(jnp.asarray(a) for a in inputs)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    v = _random_variables(shapes, np.random.default_rng(2))
    port = tsm.SparseMiddleStack(grid, ops=EVERY_OP, num_input_features=8)
    sd = port.state_dict()
    p, s = v["params"], v["batch_stats"]
    expect = {}
    names = {"SubMBlock": "subm", "DownBlock": "down",
             "SparseBasicBlock": "res", "SparseBottleneck": "bottleneck"}
    for key, tree in p.items():
        kind, i = key.rsplit("_", 1)
        pre = f"{names[kind]}.{i}"
        for leaf, val in tree.items():
            if leaf.startswith("MaskedBatchNorm"):
                j = leaf.rsplit("_", 1)[1]
                bn = f"{pre}.bn" if "kernel" in tree else f"{pre}.bn{j}"
                st = s[key][leaf]
                expect.update({f"{bn}.weight": val["scale"],
                               f"{bn}.bias": val["bias"],
                               f"{bn}.running_mean": st["mean"],
                               f"{bn}.running_var": st["var"]})
            else:
                expect[f"{pre}.weight" if leaf == "kernel"
                       else f"{pre}.{leaf}"] = val
    assert {k.split(".")[0] for k in expect} == {"subm", "down", "res",
                                                 "bottleneck"}
    assert any(k.endswith("proj") for k in expect)
    got = _port_state(p, s)
    assert set(sd) == set(expect) == set(got)
    for k, want in expect.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want),
                                      err_msg=k)
    grads = convert.grads_from_jax({"middle": p, "rpn": {
        "trunk": {}, "head": {}}})
    assert {k[len("middle."):] for k in grads} == {
        n for n, _ in port.named_parameters()}


# ------------------------------------------- SpMiddleResNetFHD end to end

RESNET_PIPELINE = TINY_SPARSE_PIPELINE.replace(
    'module_class_name: "SpMiddleFHD"',
    'module_class_name: "SpMiddleResNetFHD"')
assert RESNET_PIPELINE != TINY_SPARSE_PIPELINE


@pytest.fixture(scope="module")
def resnet_run():
    """JAX's jitted eval forward and predict and the port's `detect` on the
    same two scenes and weights, and the training batch of the same
    pipeline."""
    jcfg = jax_loads(RESNET_PIPELINE)
    module, jspec, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=3000, training=False))
    batch = _tiny_batch(prep, seed=0)
    pts, mask, anchors = batch["points"], batch["points_mask"], \
        batch["anchors"]
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)
    vox = jax.device_get(jax_device_voxelize(vspec, jnp.asarray(pts),
                                             jnp.asarray(mask)))
    args = tuple(jnp.asarray(vox[k]) for k in (
        "voxels", "num_points", "coordinates", "voxel_valid"))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    preds = jax.device_get(jax.jit(lambda v, *a: module.apply(v, *a))(
        variables, *args))
    jdet = jax.device_get(jax.jit(lambda p, a: jax_predict(jspec, p, a))(
        preds, jnp.asarray(anchors)))
    cfg = loads_pipeline_config(RESNET_PIPELINE)
    net, spec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tvspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    tdet, tvox, tpreds = detect(net, spec, tvspec, pts, mask, anchors,
                                device="cpu")
    tprep = ExamplePrep(assigner, info.feature_map_size,
                        PrepConfig(max_points=3000, training=True))
    train_batch = {k: v for k, v in _tiny_batch(tprep, seed=1).items()
                   if k != "image_idx"}
    return dict(vox=vox, preds=preds, jdet=jdet, variables=variables,
                net=net, spec=spec, cfg=cfg, tdet=tdet, tvox=tvox,
                tpreds=tpreds, train_batch=train_batch)


def test_resnet_pipeline_matches_jax(resnet_run):
    """voxelize → forward → predict: voxels exact, predictions within
    1e-4, `valid` and labels exact, boxes and scores within 1e-4."""
    for k in ("voxels", "num_points", "coordinates", "voxel_valid"):
        np.testing.assert_array_equal(resnet_run["tvox"][k].numpy(), resnet_run["vox"][k],
                                      err_msg=k)
    assert type(resnet_run["net"].middle).__name__ == "SparseMiddleResNetFHD"
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        got = resnet_run["tpreds"][k]
        np.testing.assert_allclose(
            got.numpy(), np.asarray(resnet_run["preds"][k]).reshape(got.shape),
            **TOL, err_msg=k)
    jdet, tdet = resnet_run["jdet"], resnet_run["tdet"]
    valid = np.asarray(jdet["valid"])
    np.testing.assert_array_equal(tdet["valid"].numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(tdet["boxes"].numpy()[valid],
                               np.asarray(jdet["boxes"])[valid], **TOL)
    np.testing.assert_allclose(tdet["scores"].numpy(),
                               np.asarray(jdet["scores"]), **TOL)
    np.testing.assert_array_equal(tdet["labels"].numpy()[valid],
                                  np.asarray(jdet["labels"])[valid])


def test_resnet_tree_converts(resnet_run):
    """The whole tree: the four `SparseBasicBlock_i` (the first with its
    4 -> 16 `proj`) land on `middle.res.i` with `kernel0/1` and `bn0/1`,
    the `DownBlock_i` on `middle.down.i`, unchanged; the gradient map names
    every parameter of the port's model once."""
    p = resnet_run["variables"]["params"]["middle"]
    s = resnet_run["variables"]["batch_stats"]["middle"]
    sd = resnet_run["net"].state_dict()
    assert sorted(p) == [f"DownBlock_{i}" for i in range(4)] + \
        [f"SparseBasicBlock_{i}" for i in range(4)]
    assert "proj" in p["SparseBasicBlock_0"]
    assert all("proj" not in p[f"SparseBasicBlock_{i}"] for i in (1, 2, 3))
    for i in range(4):
        b, bs = p[f"SparseBasicBlock_{i}"], s[f"SparseBasicBlock_{i}"]
        for leaf in ("proj", "kernel0", "kernel1"):
            if leaf in b:
                np.testing.assert_array_equal(
                    sd[f"middle.res.{i}.{leaf}"].numpy(), b[leaf])
        for j in range(2):
            bn, st = b[f"MaskedBatchNorm_{j}"], bs[f"MaskedBatchNorm_{j}"]
            for port, want in (("weight", bn["scale"]), ("bias", bn["bias"]),
                               ("running_mean", st["mean"]),
                               ("running_var", st["var"])):
                np.testing.assert_array_equal(
                    sd[f"middle.res.{i}.bn{j}.{port}"].numpy(), want)
        np.testing.assert_array_equal(sd[f"middle.down.{i}.weight"].numpy(),
                                      p[f"DownBlock_{i}"]["kernel"])
    grads = grads_from_jax(resnet_run["variables"]["params"])
    assert set(grads) == {n for n, _ in resnet_run["net"].named_parameters()}


def test_resnet_train_step_fp64_grads_match_jax(resnet_run):
    """One train-mode forward and backward in fp64 on a training batch:
    the port's gradients (the residual blocks' `proj`, both kernels and
    norms among them) within GRAD64_TOL of JAX's fp64 gradients (jitted)
    for every tensor, each nonzero."""
    cfg = resnet_run["cfg"]
    tvspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    got = _port_grads(resnet_run["net"], resnet_run["spec"], tvspec, resnet_run["train_batch"],
                      torch.float64)
    want = jax_grads64(RESNET_PIPELINE, resnet_run["variables"], resnet_run["train_batch"])
    assert set(got) == set(want)
    assert any(".res.0.proj" in n for n in got)
    for name, g in got.items():
        assert g is not None and g.abs().max() > 0, name
        assert _rel_err(g.numpy(), want[name].numpy()) < GRAD64_TOL, name
