"""ODE-regression initialisation (port of
``self_forcing_tpu/training/objectives/ode_regression.py``): regress the
causal generator onto precomputed ODE-solver trajectories.  Each block
takes one snapshot of the trajectory at random, the generator predicts
x0 from it, and the loss is the MSE to the trajectory's last snapshot
over the frames whose timestep is not 0.

The snapshot index runs over the trajectory's T snapshots, and its
timestep is ``step_list[idx]``.  Where T exceeds the list's length (5
snapshots against 4 warped steps: the data-prep script writes 5, and the
warp appends no 0), the JAX package's gather clamps the index to the
list's last entry, and so does this port (torch would raise).

Draws come from a ``torch.Generator`` or through ``draws``: ``idx``, the
snapshot index [B, F] (int).
"""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.ops.masks import block_causal_mask
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler
from self_forcing_tpu_torch.training.objectives.base import (
    sample_timestep_per_block)


def gather_steps(step_list, idx: torch.Tensor) -> torch.Tensor:
    """``step_list[idx]`` as float32, each index clamped into the list as
    the JAX package's gather clamps it."""
    steps = torch.as_tensor(step_list, dtype=torch.float32,
                            device=idx.device)
    return steps[idx.clamp(0, len(steps) - 1)]


def prepare_generator_input(ode_latent: torch.Tensor, step_list,
                            num_frame_per_block: int, i2v: bool = False,
                            generator: torch.Generator | None = None,
                            draws: dict | None = None):
    """ode_latent [B, T, F, C, H, W] -> (noisy input [B, F, C, H, W], its
    timestep [B, F]); the first frame of an i2v trajectory is its last
    snapshot."""
    B, T, F = ode_latent.shape[:3]
    idx = (draws or {}).get("idx")
    if idx is None:
        idx = sample_timestep_per_block(0, T, B, F, num_frame_per_block,
                                        generator=generator,
                                        device=ode_latent.device)
    idx = torch.as_tensor(idx, device=ode_latent.device).long().clone()
    if i2v:
        idx[:, 0] = T - 1
    t = gather_steps(step_list, idx)
    b_ids = torch.arange(B, device=idx.device)[:, None]
    f_ids = torch.arange(F, device=idx.device)[None, :]
    return ode_latent[b_ids, idx, f_ids], t


def generator_loss(gen_params, cfg: WanConfig, rope: RopeTables,
                   scheduler: FlowMatchScheduler, ode_latent: torch.Tensor,
                   context: torch.Tensor, step_list,
                   num_frame_per_block: int,
                   generator: torch.Generator | None = None,
                   i2v: bool = False, draws: dict | None = None,
                   kernels: bool = True, split=None):
    """The regression loss and its log: the per-sample MSE
    (``unnormalized_loss`` [B]), the mean timestep per sample
    (``timestep`` [B]) and the input / output latents.  ``split`` (a
    ``parallel.mesh.DataSharding``: this rank holds its rows of the
    batch): the masked sum is divided by the whole batch's count, times
    the ranks that split it, so the ranks' mean is the whole batch's
    loss."""
    B, T, F, C, H, W = ode_latent.shape
    target = ode_latent[:, -1]
    noisy, t = prepare_generator_input(ode_latent, step_list,
                                       num_frame_per_block, i2v, generator,
                                       draws)
    fs = (H // cfg.patch_size[1]) * (W // cfg.patch_size[2])
    mask = block_causal_mask(F, fs, num_frame_per_block, cfg.local_attn_size)
    flow = dit.forward_train(gen_params, cfg, noisy, t, context, mask, rope,
                             kernels=kernels)

    def flat(a):
        return a.reshape((B * F,) + tuple(a.shape[2:]))
    pred = scheduler.convert_flow_pred_to_x0(
        flat(flow), flat(noisy), t.reshape(-1)).reshape(noisy.shape)
    m = (t != 0.0).float()[..., None, None, None]
    diff = (pred.float() - target.float()) ** 2
    count = (m * torch.ones_like(diff)).sum()
    if split is not None and split.count > 1:
        loss = (diff * m).sum() / torch.clamp_min(split.sum(count), 1.0) \
            * split.count
    else:
        loss = (diff * m).sum() / torch.clamp_min(count, 1.0)
    log = {"unnormalized_loss": diff.detach().mean(dim=(1, 2, 3, 4)),
           "timestep": t.mean(dim=1), "input": noisy.detach(),
           "output": pred.detach()}
    return loss, log
