"""The port's flow-matching scheduler and RoPE tables against the JAX
package on the CPU (float32, tolerance 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import scheduler as jsched
from self_forcing_tpu.models.wan import rope as jrope
from self_forcing_tpu_torch import scheduler as tsched
from self_forcing_tpu_torch.models.wan import rope as trope

TOL = 1e-6


def _close(out_t, ref_j, tol=TOL):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_j), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kw", [dict(shift=8.0, training=True),
                                dict(shift=5.0, extra_one_step=False),
                                dict(shift=3.0, denoising_strength=0.7)])
def test_scheduler_tables(kw):
    j = jsched.FlowMatchScheduler.create(1000, **kw)
    t = tsched.FlowMatchScheduler.create(1000, device="cpu", **kw)
    _close(t.sigmas, j.sigmas)
    _close(t.timesteps, j.timesteps)
    if kw.get("training"):
        _close(t.training_weights, j.training_weights)


def test_add_noise_and_flow_to_x0():
    rng = np.random.default_rng(0)
    j = jsched.FlowMatchScheduler.create(1000, shift=8.0)
    t = tsched.FlowMatchScheduler.create(1000, shift=8.0, device="cpu")
    x0 = rng.standard_normal((4, 16, 6, 6)).astype(np.float32)
    eps = rng.standard_normal((4, 16, 6, 6)).astype(np.float32)
    ts = np.array([999.0, 937.5, 500.2, 3.0], np.float32)
    _close(t.add_noise(torch.from_numpy(x0), torch.from_numpy(eps),
                       torch.from_numpy(ts)),
           j.add_noise(x0, eps, jnp.asarray(ts)))
    _close(t.convert_flow_pred_to_x0(torch.from_numpy(eps),
                                     torch.from_numpy(x0),
                                     torch.from_numpy(ts)),
           j.convert_flow_pred_to_x0(eps, x0, jnp.asarray(ts)))


def test_warp_denoising_steps():
    j = jsched.FlowMatchScheduler.create(1000, shift=8.0, training=True)
    t = tsched.FlowMatchScheduler.create(1000, shift=8.0, training=True,
                                         device="cpu")
    steps = [1000, 750, 500, 250]
    np.testing.assert_allclose(tsched.warp_denoising_steps(t, steps),
                               jsched.warp_denoising_steps(j, steps),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("head_dim,grid,start", [(64, (3, 4, 5), 6),
                                                 (128, (3, 30, 52), 18),
                                                 (64, (2, 2, 2), 1023)])
def test_angles_for_grid(head_dim, grid, start):
    j = jrope.RopeTables.create(head_dim)
    t = trope.RopeTables.create(head_dim, device="cpu")
    cj, sj = j.angles_for_grid(*grid, jnp.int32(start))
    ct, st = t.angles_for_grid(*grid, start)
    _close(ct, cj)
    _close(st, sj)


def test_sinusoidal_embedding_1d():
    pos = np.array([[0.0, 1.0, 999.0], [250.0, 937.5, 12.25]], np.float32)
    _close(trope.sinusoidal_embedding_1d(256, torch.from_numpy(pos)),
           jrope.sinusoidal_embedding_1d(256, jnp.asarray(pos)))
