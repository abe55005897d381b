"""The port's sparse-conv backward and the norms' training statistics against
the JAX package, on the CPU: `GatherGemm`'s gradients (the plain versions of
the gather-GEMM on the transposed rulebook and of the weight-gradient
kernel) against `jax.grad` of JAX's `subm_conv3d_b` and `sparse_conv3d_b`
on the same rulebooks, the transposed rulebook against the reversed-tap
identity, the wrappers that have no backward (they raise instead of
detaching), the flax BatchNorm semantics of both norms in training, and
flax's initialisers for training."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.models.sparse_middle import \
    MaskedBatchNorm as JMaskedBatchNorm
from second_tpu.ops import sparse_conv as jsp
from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.models import build_voxelnet, init_train_weights_
from second_tpu_torch.models.layers import FlaxBatchNorm2d
from second_tpu_torch.models.sparse_middle import DownBlock, SubMBlock
from second_tpu_torch.models.sparse_middle import MaskedBatchNorm
from second_tpu_torch.ops import sparse_conv as sp
from second_tpu_torch.ops.cuda import gather, riou, subm

from test_torch_sparse_conv import make_batch, sorted_pair

GRID = (8, 16, 16)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _sorted(rng, cap, cin, fill=(0.4, 0.9)):
    coords, feats, valid = make_batch(rng, GRID, cap, cin, fill=fill)
    return sorted_pair(coords, feats, valid, GRID)


def _jax_grads(fn, feats, w, cot):
    """(dX, dW) of sum(fn(feats, w) * cot) by jax.grad."""
    return jax.grad(lambda f, ww: jnp.sum(fn(f, ww) * cot),
                    argnums=(0, 1))(feats, w)


def _port_grads(fn, feats, w, cot):
    f = feats.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    (fn(f, ww) * cot).sum().backward()
    return f.grad, ww.grad


@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 32), (64, 64)])
def test_subm_conv_grads_match_jax(cin, cout):
    """Submanifold conv: dX through the gather-GEMM on the transposed
    rulebook and dW through the weight gradient's plain version, fp32
    within 1e-5, against jax.grad of JAX's einsum apply."""
    rng = np.random.default_rng(10)
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _sorted(rng, 256, cin)
    w = rng.normal(0, 1 / np.sqrt(27 * cin), (27, cin, cout)).astype(
        np.float32)
    cot = rng.normal(0, 1, (2, 256, cout)).astype(np.float32)
    want = _jax_grads(
        lambda f, ww: jsp.subm_conv3d_b(f, jc, jk, jv, GRID, ww), jf,
        jnp.asarray(w), jnp.asarray(cot))
    got = _port_grads(
        lambda f, ww: sp.subm_conv3d_b(f, tc, tk, tv, GRID, ww), tf,
        torch.from_numpy(w), torch.from_numpy(cot))
    for g, j, name in zip(got, want, ("dX", "dW")):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD_TOL,
                                   err_msg=name)
    assert np.abs(np.asarray(want[0])).max() > 0


@pytest.mark.parametrize("kernel,stride,padding,cap", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 48),       # over capacity
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 256),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 256),
])
def test_strided_conv_grads_match_jax(kernel, stride, padding, cap):
    """Strided conv, the capacity cut included: the same dX and dW as
    jax.grad, fp32 within 1e-5."""
    rng = np.random.default_rng(11)
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _sorted(rng, 256, 8,
                                                  fill=(0.8, 0.95))
    K = int(np.prod(kernel))
    w = rng.normal(0, 0.1, (K, 8, 16)).astype(np.float32)
    cot = rng.normal(0, 1, (2, cap, 16)).astype(np.float32)
    args = (kernel, stride, padding, cap)
    want = _jax_grads(
        lambda f, ww: jsp.sparse_conv3d_b(f, jc, jk, jv, GRID, ww, *args)[0],
        jf, jnp.asarray(w), jnp.asarray(cot))
    n_unique = sp.sparse_conv3d_b(tf, tc, tk, tv, GRID,
                                  torch.from_numpy(w), *args)[5]
    if cap == 48:
        assert (n_unique > cap).all()
    got = _port_grads(
        lambda f, ww: sp.sparse_conv3d_b(f, tc, tk, tv, GRID, ww, *args)[0],
        tf, torch.from_numpy(w), torch.from_numpy(cot))
    for g, j, name in zip(got, want, ("dX", "dW")):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD_TOL,
                                   err_msg=name)


def test_bf16_conv_grads_round_as_documented():
    """bf16 features: dX is the fp32 gather-GEMM of dOut rounded to bf16,
    itself rounded to bf16; dW the fp32 weight gradient of the bf16 taps
    and bf16 dOut, rounded to bf16 (the weights' cast) and back to fp32.
    Against jax.grad, which keeps dOut in fp32 and rounds its own sums
    (XLA's CPU dot of bf16 operands), each entry is within one bf16 unit of
    its value (2^-7 relative) plus 2^-8 of the largest entry: entries that
    are sums of many terms that cancel round differently in the two
    (measured: 0.0082 and 0.0125 from the exact fp32 sum at a largest dX of
    2.64)."""
    rng = np.random.default_rng(12)
    (jc, jf, jv, jk), (tc, tf, tv, tk) = _sorted(rng, 256, 16)
    w = rng.normal(0, 0.05, (27, 16, 32)).astype(np.float32)
    cot = rng.normal(0, 1, (2, 256, 32)).astype(np.float32)
    tfb = tf.bfloat16()
    rb = sp.subm_rulebook_b(tc, tk, tv, GRID)
    f = tfb.clone().requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True)
    out = sp.subm_conv3d_b(f, tc, tk, tv, GRID, ww, rulebook=rb)
    (out * torch.from_numpy(cot)).sum().backward()
    assert f.grad.dtype == torch.bfloat16 and ww.grad.dtype == torch.float32
    g = torch.where(tv[..., None], torch.from_numpy(cot), 0.0).bfloat16()
    inv = sp.transpose_rulebook_b(*rb, tf.shape[1])
    want_dx = subm.gather_gemm_plain(g, *inv, ww.detach().transpose(1, 2)
                                     ).bfloat16()
    want_dw = subm.gather_gemm_wgrad_plain(tfb, *rb, g).bfloat16().float()
    assert torch.equal(f.grad, want_dx)
    assert torch.equal(ww.grad, want_dw)
    jdx, jdw = _jax_grads(
        lambda ff, wj: jsp.subm_conv3d_b(ff, jc, jk, jv, GRID, wj),
        jf.astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(cot))
    for got, want in ((f.grad.float(), jdx.astype(jnp.float32)),
                      (ww.grad, jdw)):
        got, want = got.numpy(), np.asarray(want)
        bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + \
            2.0 ** -8 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("cap", [64, 512])
def test_transposed_rulebook_is_reversed_taps_for_subm(cap):
    """For a submanifold conv, tap k of query q finds row n exactly when tap
    26 - k of query n finds row q: the transposed rulebook is the forward
    one with its taps reversed."""
    rng = np.random.default_rng(13)
    coords, feats, valid = make_batch(rng, GRID, cap, 2)
    tc, _, tv, tk = sp.sort_active(torch.from_numpy(coords),
                                   torch.from_numpy(feats),
                                   torch.from_numpy(valid), GRID)
    tap_idx, found = sp.subm_rulebook_b(tc, tk, tv, GRID)
    inv_idx, inv_found = sp.transpose_rulebook_b(tap_idx, found, cap)
    assert found.any()
    assert torch.equal(inv_found, found.flip(1))
    assert torch.equal(inv_idx[inv_found], tap_idx.flip(1)[inv_found])
    assert not inv_idx[~inv_found].any()


def test_transposed_rulebook_of_strided_conv_inverts_it():
    """Strided conv over capacity: each found (b, k, q) → n of the forward
    rulebook appears once as (b, k, n) → q in the transposed one, and
    nothing else does."""
    rng = np.random.default_rng(14)
    coords, feats, valid = make_batch(rng, GRID, 256, 2, fill=(0.8, 0.95))
    tc, _, tv, tk = sp.sort_active(torch.from_numpy(coords),
                                   torch.from_numpy(feats),
                                   torch.from_numpy(valid), GRID)
    oc, ov, _, _, nu = sp.downsample_coords_b(tc, tv, GRID, (3, 3, 3),
                                              (2, 2, 2), (1, 1, 1), 48)
    assert (nu > 48).all()
    base = oc * 2 - 1
    tap_idx, found = sp.build_rulebook_b(tk, base, ov, GRID, (3, 3, 3))
    inv_idx, inv_found = sp.transpose_rulebook_b(tap_idx, found, 256)
    assert int(inv_found.sum()) == int(found.sum())
    b, k, q = found.nonzero(as_tuple=True)
    n = tap_idx[b, k, q].long()
    assert inv_found[b, k, n].all()
    assert torch.equal(inv_idx[b, k, n].long(), q)


def test_gather_gemm_grads_flow_through_the_function(monkeypatch):
    """R1 on the CPU: with a stub standing in for the CUDA launch (the CPU
    has no card), the middle's sparse weights get their gradients through
    `GatherGemm`'s backward: the forward, dX and dW calls each go through
    the stub's counted path, and every sparse weight's gradient is finite
    and not all zero."""
    calls = {"launch": 0, "wgrad": 0}

    def fake_apply(features, tap_idx, found, weights):
        calls["launch"] += 1
        return subm.gather_gemm_plain(features, tap_idx, found, weights), \
            True

    def fake_wgrad(features, tap_idx, found, grad_out):
        calls["wgrad"] += 1
        return subm.gather_gemm_wgrad_plain(features, tap_idx, found,
                                            grad_out)

    monkeypatch.setattr(subm, "_apply", fake_apply)
    monkeypatch.setattr(subm, "sparse_wgrad", fake_wgrad)
    monkeypatch.setattr(subm, "launches", 0)
    monkeypatch.setattr(subm, "launches_dgrad", 0)
    cfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    net = build_voxelnet(cfg.model, device="cpu")[0]
    init_train_weights_(net, 0)
    net.train()
    rng = np.random.default_rng(15)
    coords, feats, valid = make_batch(rng, net.middle.grid0, 512, 4)
    bev, _ = net.middle(torch.from_numpy(feats), torch.from_numpy(coords),
                        torch.from_numpy(valid))
    (bev * torch.from_numpy(rng.normal(size=bev.shape).astype(
        np.float32))).sum().backward()
    assert subm.launches == 14 and subm.launches_dgrad == 13
    assert calls == {"launch": 27, "wgrad": 14}
    sparse = [m for m in net.middle.modules()
              if isinstance(m, (SubMBlock, DownBlock))]
    assert len(sparse) == 14
    for m in sparse:
        g = m.weight.grad
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0


def test_wrappers_without_backward_refuse_grad():
    """R1: the row gather and the rotated-IoU wrappers have no backward; given
    an input that requires grad under grad mode they raise, on the CPU as on
    the card, instead of returning a detached result. Under no_grad they
    run."""
    src = torch.randn(5, 3, requires_grad=True)
    idx = torch.tensor([0, 1])
    boxes = torch.tensor([[0.0, 0.0, 2.0, 4.0, 0.1],
                          [0.5, 0.0, 2.0, 4.0, 0.3]], requires_grad=True)
    cand, valid = boxes[None], torch.ones(1, 2, dtype=torch.bool)
    calls = [lambda: gather.gather_rows(src, idx),
             lambda: gather.flat_rows(src[None], idx[None]),
             lambda: riou.riou_pairs(boxes, boxes, idx[:1], idx[1:]),
             lambda: riou.riou_matrix(boxes, boxes),
             lambda: riou.nms_overlap(cand, valid, 0.1, 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    over = torch.zeros(1, 2, 1, dtype=torch.int32, requires_grad=False)
    riou.nms_suppress(over, valid)


def _flax_bn_train(x, scale, bias, mean, var):
    """flax BatchNorm (eps 1e-3, momentum 0.99) over the last axis in
    training: its output and updated statistics."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    y, upd = bn.apply(variables, x, mutable=["batch_stats"])
    return y, upd["batch_stats"]


def test_batchnorm2d_training_matches_flax():
    """R2, the RPN's norm: a step in training mode gives flax's output and
    running statistics, with the biased variance, on n = 2 x 3 x 5 = 30
    values a channel (torch's BatchNorm2d is off by n/(n-1) in
    running_var)."""
    rng = np.random.default_rng(16)
    x = rng.normal(1.0, 2.0, (2, 3, 5, 6)).astype(np.float32)   # NHWC
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    mean = rng.normal(0, 0.1, 6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    want, stats = _flax_bn_train(x, scale, bias, mean, var)
    bn = FlaxBatchNorm2d(6, eps=1e-3, momentum=0.01)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    bn.train()
    got = bn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6,
                               atol=1e-7)
    torch_bn = torch.nn.BatchNorm2d(6, eps=1e-3, momentum=0.01)
    torch_bn.load_state_dict(bn.state_dict())
    with torch.no_grad():
        torch_bn.running_var.copy_(torch.from_numpy(var))
    torch_bn.train()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert not np.allclose(torch_bn.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-6, atol=1e-7)


def test_masked_batchnorm_training_matches_jax():
    """R2, the sparse middle's norm: the masked mean and biased variance over
    the valid rows (n = 37 of 64), the output zero on invalid rows, the
    running update: as JAX's MaskedBatchNorm with train=True."""
    rng = np.random.default_rng(17)
    x = rng.normal(0.5, 1.5, (2, 32, 8)).astype(np.float32)
    mask = np.zeros((2, 32), bool)
    mask[0, :20] = True
    mask[1, :17] = True
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean = rng.normal(0, 0.1, 8).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = JMaskedBatchNorm().apply(variables, x, mask, True,
                                         mutable=["batch_stats"])
    bn = MaskedBatchNorm(8)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    bn.train()
    got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert not got[~torch.from_numpy(mask)].any()
    for name, t in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(upd["batch_stats"][name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    bn.eval()
    y_eval = bn(torch.from_numpy(x), torch.from_numpy(mask))
    assert not torch.allclose(y_eval, got)


def test_init_train_weights_uses_flax_initialisers():
    """R3: sparse kernels normal with std (K · Cin)^-0.5, dense kernels
    truncated normal with std fan_in^-0.5 (each tensor's sample std within
    10%, no sample past 2 std for the truncated ones), zero biases, norms
    at scale 1, bias 0 and running statistics 0 and 1."""
    cfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    net = build_voxelnet(cfg.model, device="cpu", seed=3)[0]
    init_train_weights_(net, 3)
    checked = 0
    for m in net.modules():
        if isinstance(m, (SubMBlock, DownBlock)):
            K, cin, _ = m.weight.shape
            std, trunc = (K * cin) ** -0.5, False
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) else \
                w.shape[0] * w.shape[2] * w.shape[3]
            std, trunc = fan_in ** -0.5, True
            if m.bias is not None:
                assert not m.bias.any()
        else:
            if isinstance(m, (MaskedBatchNorm, torch.nn.BatchNorm2d)):
                assert torch.equal(m.weight, torch.ones_like(m.weight))
                assert not m.bias.any() and not m.running_mean.any()
                assert torch.equal(m.running_var,
                                   torch.ones_like(m.running_var))
            continue
        w = m.weight.detach()
        assert abs(w.std().item() / std - 1) < 0.1, (m, w.std().item(), std)
        if trunc:
            assert w.abs().max().item() <= 2 * std / 0.87962566103423978
        checked += 1
    assert checked == 14 + len(net.rpn.trunk.convs) + \
        len(net.rpn.trunk.deconvs) + 3
