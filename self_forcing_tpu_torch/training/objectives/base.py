"""Shared machinery of the distillation objectives (port of
``self_forcing_tpu/training/objectives/base.py``): the model bundle
(causal generator, bidirectional real and fake scores), timestep
sampling and the generator rollout.

Random draws come from a ``torch.Generator`` or are handed in (``draws``),
so that tests can give both packages the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.pipelines.self_forcing_training import (
    SelfForcingTrainingPipeline)
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler


@dataclasses.dataclass(frozen=True)
class ObjectiveConfig:
    """Distillation hyperparameters."""

    num_train_timestep: int = 1000
    real_guidance_scale: float = 3.0
    fake_guidance_scale: float = 0.0
    timestep_shift: float = 5.0
    ts_schedule: bool = True
    ts_schedule_max: bool = False
    min_score_timestep: int = 0
    num_frame_per_block: int = 3
    same_step_across_blocks: bool = True
    last_step_only: bool = False
    num_training_frames: int = 21
    context_noise: float = 0.0
    denoising_loss_type: str = "flow"
    sid_alpha: float = 1.0

    @property
    def min_step(self) -> int:
        return int(0.02 * self.num_train_timestep)

    @property
    def max_step(self) -> int:
        return int(0.98 * self.num_train_timestep)


def sample_timestep(min_t: int, max_t: int, batch: int, num_frame: int,
                    shift: float, clamp_lo: int, clamp_hi: int,
                    generator: torch.Generator | None = None,
                    device: str | torch.device = "cuda",
                    draws: torch.Tensor | None = None) -> torch.Tensor:
    """One uniform integer timestep in [min_t, max_t) per batch entry
    (``draws`` [batch, 1] when given), broadcast over the frames, shifted
    and clamped.  Returns float32 [batch, num_frame]."""
    if draws is None:
        draws = torch.randint(min_t, max_t, (batch, 1), generator=generator,
                              device=device)
    t = draws.to(device=device, dtype=torch.float32).reshape(batch, 1)
    t = t.expand(batch, num_frame)
    if shift > 1:
        t = shift * (t / 1000) / (1 + (shift - 1) * (t / 1000)) * 1000
    return torch.clamp(t, clamp_lo, clamp_hi)


def sample_timestep_per_block(min_t: int, max_t: int, batch: int,
                              num_frame: int, num_frame_per_block: int,
                              independent_first_frame: bool = False,
                              generator: torch.Generator | None = None,
                              device: str | torch.device = "cuda"
                              ) -> torch.Tensor:
    """Per-block random integer timesteps, equal within each block (the
    first frame on its own with ``independent_first_frame``).  Returns
    int64 [batch, num_frame]."""
    def draw(*shape):
        return torch.randint(min_t, max_t, shape, generator=generator,
                             device=device)
    if independent_first_frame:
        nb = (num_frame - 1) // num_frame_per_block
        tb = draw(batch, nb, 1).expand(batch, nb, num_frame_per_block)
        return torch.cat([draw(batch, 1), tb.reshape(batch, -1)], dim=1)
    nb = num_frame // num_frame_per_block
    return draw(batch, nb, 1).expand(batch, nb, num_frame_per_block
                                     ).reshape(batch, num_frame)


def score_x0(params, cfg: WanConfig, rope: RopeTables,
             scheduler: FlowMatchScheduler, noisy: torch.Tensor,
             t: torch.Tensor, context: torch.Tensor, remat: bool = True,
             kernels: bool = True) -> torch.Tensor:
    """A bidirectional score model's x0 prediction of ``noisy`` at
    timesteps ``t`` [B, F]."""
    B, F, C, H, W = noisy.shape
    flow = dit.forward_train(params, cfg, noisy, t, context, None, rope,
                             remat=remat, kernels=kernels)
    return scheduler.convert_flow_pred_to_x0(
        flow.reshape(B * F, C, H, W), noisy.reshape(B * F, C, H, W),
        t.reshape(-1)).reshape(B, F, C, H, W)


def cfg_combined_score(params, cfg: WanConfig, rope: RopeTables,
                       scheduler: FlowMatchScheduler, noisy, t, context,
                       neg_context, guidance_scale: float,
                       remat: bool = True, kernels: bool = True):
    """Classifier-free guidance: cond + (cond - uncond) * scale (one
    forward when the scale is 0)."""
    pos = score_x0(params, cfg, rope, scheduler, noisy, t, context, remat,
                   kernels)
    if guidance_scale == 0.0:
        return pos
    uncond = score_x0(params, cfg, rope, scheduler, noisy, t, neg_context,
                      remat, kernels)
    return pos + (pos - uncond) * guidance_scale


@dataclasses.dataclass
class ModelBundle:
    """Configs, scheduler, RoPE tables and rollout pipeline of one
    distillation setup (generator causal, real and fake bidirectional)."""

    generator_cfg: WanConfig
    critic_cfg: WanConfig          # fake_score
    teacher_cfg: WanConfig         # real_score
    scheduler: FlowMatchScheduler
    rope_g: RopeTables
    rope_c: RopeTables
    rope_t: RopeTables
    pipeline: SelfForcingTrainingPipeline
    independent_first_frame: bool = False

    @classmethod
    def create(cls, generator_cfg: WanConfig, critic_cfg: WanConfig,
               teacher_cfg: WanConfig, obj: ObjectiveConfig,
               denoising_step_list, scheduler=None,
               independent_first_frame: bool = False,
               device: str | torch.device = "cuda"):
        scheduler = scheduler or FlowMatchScheduler.create(
            1000, shift=obj.timestep_shift, training=True, device=device)
        pipeline = SelfForcingTrainingPipeline(
            denoising_step_list, scheduler,
            num_frame_per_block=obj.num_frame_per_block,
            same_step_across_blocks=obj.same_step_across_blocks,
            last_step_only=obj.last_step_only,
            num_max_frames=obj.num_training_frames,
            context_noise=obj.context_noise)
        return cls(generator_cfg, critic_cfg, teacher_cfg, scheduler,
                   RopeTables.create(generator_cfg.head_dim, device=device),
                   RopeTables.create(critic_cfg.head_dim, device=device),
                   RopeTables.create(teacher_cfg.head_dim, device=device),
                   pipeline, independent_first_frame=independent_first_frame)

    def run_generator(self, gen_params, noise, ctx_kv, exit_idx,
                      generator: torch.Generator | None = None,
                      eps: Optional[list] = None, kernels: bool = True):
        """Rollout -> (trajectory of the last 21 frames, gradient mask or
        None, t_from, t_to)."""
        pred, t_from, t_to = self.pipeline.inference_with_trajectory(
            gen_params, self.generator_cfg, self.rope_g, noise, ctx_kv,
            exit_idx, generator=generator, eps=eps, kernels=kernels)
        pred, gradient_mask = self.trim_rollout(pred)
        return pred, gradient_mask, t_from, t_to

    def trim_rollout(self, pred: torch.Tensor):
        """Rollouts of at most 21 frames pass as they are.  Longer ones
        need the boundary frame decoded and re-encoded by the VAE; the
        port's VAE has both halves, but the trainer does not hold VAE
        parameters yet (ROADMAP Queue A item 7): they raise, as the JAX
        package does without VAE parameters."""
        if pred.shape[1] <= 21:
            return pred, None
        raise ValueError(
            "rollouts longer than 21 frames need the VAE for the "
            "boundary-frame re-encode; the trainer holds no VAE parameters")
