"""One train step of the tiny sparse pipeline under the config's optimizer
(one-cycle Adam, β2 0.99, decoupled weight decay 0.01, the clip at 10) in
the port against JAX's `make_train_step` run eagerly, from the same
converted weights on the same batch. Why one step and not three, and why
the parameters are compared where the gradient's sign is settled: see
`test_torch_train.py`."""

import numpy as np

from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax

from test_torch_train import (GRAD_TOL, LOSS_RTOL, PARAM_ATOL, STAT_TOL,
                              _jax_run, _port_run)


def test_adam_train_step_matches_jax():
    """One step under the config's optimizer: one-cycle Adam (β2 0.99) with
    decoupled weight decay 0.01 and the clip. The loss and gradients as in
    the SGD steps; the parameters within PARAM_ATOL where the gradient is
    above 1e-3 of its tensor's largest entry (its sign settled: the two
    gradients agree to 4.3e-5 of it), and elsewhere within the most Adam's
    first step can move a parameter, lr · (2 + wd · |p|)."""
    batch, variables, jout = _jax_run(False, 1)
    tout = _port_run(batch, variables, False, 1)
    j, t = jout[0], tout[0]
    np.testing.assert_allclose(float(t["metrics"]["loss"]), j["loss"],
                               rtol=LOSS_RTOL)
    grads = grads_from_jax(j["grads"])
    want = state_dict_from_jax(j["variables"])
    before = state_dict_from_jax(variables)
    lr = 3e-4                         # one-cycle at count 0: lr_max / 10
    settled = 0
    for name, g in grads.items():
        g = g.numpy()
        scale = np.abs(g).max()
        np.testing.assert_allclose(t["grads"][name].numpy(), g, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
        diff = np.abs(t["state"][name].numpy() - want[name].numpy())
        sure = np.abs(g) > 1e-3 * scale
        settled += int(sure.sum())
        assert np.all(diff[sure] <= PARAM_ATOL), name
        assert np.all(diff <= lr * (2 + 0.01 * np.abs(before[name].numpy()))
                      + PARAM_ATOL), name
    assert settled > 0.9 * sum(g.numel() for g in grads.values())
    for name in want:
        if "running" in name:
            np.testing.assert_allclose(t["state"][name].numpy(),
                                       want[name].numpy(), **STAT_TOL,
                                       err_msg=name)
