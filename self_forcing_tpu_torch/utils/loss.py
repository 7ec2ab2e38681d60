"""Denoising losses and their registry (port of
``self_forcing_tpu/utils/loss.py``).  Each takes the rollout sample x,
the critic's prediction, the noise and timesteps, and returns a scalar
fp32 mean."""
from __future__ import annotations

import torch


def _mse(a: torch.Tensor, b: torch.Tensor,
         weight: torch.Tensor | None = None) -> torch.Tensor:
    d = (a.float() - b.float()) ** 2
    if weight is not None:
        d = d * weight.reshape((-1,) + (1,) * (d.dim() - 1))
    return d.mean()


def x0_pred_loss(*, x, x_pred, weight=None, **_):
    return _mse(x, x_pred, weight)


def noise_pred_loss(*, noise, noise_pred, weight=None, **_):
    return _mse(noise, noise_pred, weight)


def v_pred_loss(*, x, x_pred, alphas_cumprod=None, timestep=None,
                weight=None, **_):
    """1 / (1 - alphas_cumprod[t])-weighted x0 MSE; flow matching has no
    alphas_cumprod, so it raises there (as the reference would)."""
    if alphas_cumprod is None:
        raise ValueError("denoising_loss_type='v' needs a scheduler with "
                         "alphas_cumprod (DDPM-style); flow matching has "
                         "none - use 'flow', 'x0' or 'noise'")
    w = 1.0 / (1.0 - alphas_cumprod[timestep.long()])
    d = (x.float() - x_pred.float()) ** 2
    w = w.reshape(w.shape + (1,) * (d.dim() - w.dim()))
    if weight is not None:
        w = w * weight.reshape((-1,) + (1,) * (d.dim() - 1))
    return (w * d).mean()


def flow_pred_loss(*, x, noise, flow_pred, weight=None, **_):
    """Flow matching: target v = noise - x0."""
    return _mse(noise - x, flow_pred, weight)


DENOISING_LOSSES = {
    "x0": x0_pred_loss,
    "noise": noise_pred_loss,
    "v": v_pred_loss,
    "flow": flow_pred_loss,
}


def get_denoising_loss(name: str):
    return DENOISING_LOSSES[name]
