"""Causal diffusion (teacher-forcing) finetuning (port of
``self_forcing_tpu/training/objectives/causal_diffusion.py``).

The flow-matching loss of the causal model at per-block random
timesteps, weighted by the scheduler's training weight.  With teacher
forcing the model sees the doubled [clean | noisy] sequence under the
teacher-forcing mask, the clean half optionally noise-augmented to a
per-block timestep below ``noise_augmentation_max_timestep``; without,
the noisy latents alone under the block-causal mask.

Draws come from a ``torch.Generator`` or through ``draws``: ``idx`` (the
scheduler timestep indices [B, F]), ``noise`` and ``aug_idx`` (the
augmentation's indices).
"""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.ops.masks import (block_causal_mask,
                                              teacher_forcing_mask)
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler
from self_forcing_tpu_torch.training.objectives.base import (
    sample_timestep_per_block)
from self_forcing_tpu_torch.training.objectives.dmd import _noise_like


def generator_loss(gen_params, cfg: WanConfig, rope: RopeTables,
                   scheduler: FlowMatchScheduler,
                   clean_latent: torch.Tensor, context: torch.Tensor,
                   num_frame_per_block: int,
                   generator: torch.Generator | None = None,
                   teacher_forcing: bool = True,
                   noise_augmentation_max_timestep: int = 0,
                   independent_first_frame: bool = False,
                   draws: dict | None = None, kernels: bool = True):
    """The loss and its log (the mean timestep, the x0 prediction's
    MSE)."""
    draws = draws or {}
    B, F, C, H, W = clean_latent.shape
    dev = clean_latent.device

    def indices(hi, given):
        if given is None:
            given = sample_timestep_per_block(
                0, hi, B, F, num_frame_per_block, independent_first_frame,
                generator=generator, device=dev)
        return torch.as_tensor(given, device=dev).long()

    def flat(a):
        return a.reshape((B * F,) + tuple(a.shape[2:]))
    t = scheduler.timesteps[indices(scheduler.timesteps.shape[0],
                                    draws.get("idx"))]
    noise = _noise_like(clean_latent, generator, draws.get("noise"))
    noisy = scheduler.add_noise(flat(clean_latent), flat(noise),
                                t.reshape(-1)).reshape(clean_latent.shape)
    target = noise - clean_latent

    clean_aug, aug_t = clean_latent, None
    if noise_augmentation_max_timestep > 0:
        aug_t = scheduler.timesteps[indices(noise_augmentation_max_timestep,
                                            draws.get("aug_idx"))]
        clean_aug = scheduler.add_noise(
            flat(clean_latent), flat(noise),
            aug_t.reshape(-1)).reshape(clean_latent.shape)

    fs = (H // cfg.patch_size[1]) * (W // cfg.patch_size[2])
    if teacher_forcing:
        mask = teacher_forcing_mask(F, fs, num_frame_per_block)
        flow = dit.forward_train(gen_params, cfg, noisy, t, context, mask,
                                 rope, clean_x=clean_aug, aug_t=aug_t,
                                 kernels=kernels)
    else:
        mask = block_causal_mask(F, fs, num_frame_per_block,
                                 cfg.local_attn_size)
        flow = dit.forward_train(gen_params, cfg, noisy, t, context, mask,
                                 rope, kernels=kernels)

    per_frame = ((flow.float() - target.float()) ** 2).mean(dim=(2, 3, 4))
    w = scheduler.training_weight(t.reshape(-1)).reshape(B, F)
    loss = (per_frame * w).mean()
    with torch.no_grad():
        x0_pred = scheduler.convert_flow_pred_to_x0(
            flat(flow), flat(noisy), t.reshape(-1)).reshape(
                clean_latent.shape)
        x0_mse = ((x0_pred.float() - clean_latent.float()) ** 2).mean()
    return loss, {"timestep_mean": t.mean(), "x0_pred_mse": x0_mse}
