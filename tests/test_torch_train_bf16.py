"""One mixed-precision train step of the tiny sparse pipeline in the port
against JAX's `make_train_step` (run eagerly, so every bf16 cast rounds),
from the same converted weights on the same batch."""

import numpy as np

from second_tpu_torch.convert import grads_from_jax

from test_torch_train import _jax_run, _port_run


def test_bf16_train_step_matches_jax():
    """One mixed-precision step (bf16 middle and RPN trunk, fp32 sums, norms
    and heads), JAX run eagerly so every bf16 cast rounds. bf16 keeps 8
    mantissa bits, and on this random-weight model the bf16 gradients of
    either framework lie some 30% (median relative norm over the tensors)
    from the fp32 gradients of the same weights (measured: port 0.33, JAX
    0.35): rounding flips activations at the ReLUs' zero and the flips grow
    through the 14 sparse convs. So the bound is the bf16 one: the loss
    within 3e-3 relative (measured 1.2e-3), and each gradient pointing the
    same way as JAX's, cosine at least 0.9 (measured 0.95 at the lowest),
    within 0.6 of its norm (measured 0.34 at the highest)."""
    batch, variables, jout = _jax_run(True, 1)
    tout = _port_run(batch, variables, True, 1)
    np.testing.assert_allclose(float(tout[0]["metrics"]["loss"]),
                               jout[0]["loss"], rtol=3e-3)
    want = grads_from_jax(jout[0]["grads"])
    assert set(want) == set(tout[0]["grads"])
    for name, w in want.items():
        w = w.numpy().ravel().astype(np.float64)
        g = tout[0]["grads"][name].numpy().ravel().astype(np.float64)
        assert np.isfinite(g).all(), name
        cos = (w @ g) / max(np.linalg.norm(w) * np.linalg.norm(g), 1e-30)
        assert cos >= 0.9, (name, cos)
        assert np.linalg.norm(g - w) <= 0.6 * np.linalg.norm(w), name
