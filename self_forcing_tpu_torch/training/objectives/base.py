"""Shared machinery of the distillation objectives (port of
``self_forcing_tpu/training/objectives/base.py``): the model bundle
(causal generator, bidirectional real and fake scores), timestep
sampling and the generator rollout.

Random draws come from a ``torch.Generator`` (or a
``utils.draws.SplitGenerator``: the global batch's draws, this rank's
rows) or are handed in (``draws``), so that tests can give both packages
the same numbers.
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
from self_forcing_tpu_torch.utils import draws as rand


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
        draws = rand.randint(min_t, max_t, (batch, 1), generator, device)
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
        return rand.randint(min_t, max_t, shape, generator, device)
    if independent_first_frame:
        nb = (num_frame - 1) // num_frame_per_block
        tb = draw(batch, nb, 1).expand(batch, nb, num_frame_per_block)
        return torch.cat([draw(batch, 1), tb.reshape(batch, -1)], dim=1)
    nb = num_frame // num_frame_per_block
    return draw(batch, nb, 1).expand(batch, nb, num_frame_per_block
                                     ).reshape(batch, num_frame)


def align_cond_window(cond: Optional[dict], f_roll: int, f_pred: int
                      ) -> Optional[dict]:
    """``cond['y']`` aligned with a (possibly trimmed) rollout: the rollout
    consumed ``y[:, :f_roll]`` and :meth:`ModelBundle.trim_rollout` keeps
    its last ``f_pred`` frames, so the score models see the trailing
    window ``y[:, f_roll - f_pred:f_roll]``."""
    if not cond or cond.get("y") is None:
        return cond
    return dict(cond, y=cond["y"][:, :f_roll][:, f_roll - f_pred:])


def model_cond(cfg: WanConfig, cond: Optional[dict]):
    """(y, clip_fea): the conditioning entries a model consumes, ``y``
    only when ``in_dim > out_dim`` (channel concat), ``clip_fea`` only
    for an i2v model."""
    if not cond:
        return None, None
    y = cond.get("y") if cfg.in_dim > cfg.out_dim else None
    clip_fea = cond.get("clip_fea") if cfg.model_type == "i2v" else None
    return y, clip_fea


def score_x0(params, cfg: WanConfig, rope: RopeTables,
             scheduler: FlowMatchScheduler, noisy: torch.Tensor,
             t: torch.Tensor, context: torch.Tensor, remat: bool = True,
             kernels: bool = True, y: torch.Tensor | None = None,
             clip_fea: torch.Tensor | None = None, sp_mesh=None,
             sp_axis: str = "sp", sp_param_specs=None) -> torch.Tensor:
    """A bidirectional score model's x0 prediction of ``noisy`` at
    timesteps ``t`` [B, F].  ``sp_mesh``: the forward runs
    sequence-parallel over that mesh's ``sp_axis`` (ring attention, the
    14B teacher's route: ``ModelBundle.teacher_sp_mesh``; the gradient
    reaches ``noisy``, not the weights); ``sp_param_specs``: the
    ZeRO-3-over-sp layout of ``params`` (``mesh.combined_fsdp_specs``),
    gathered a layer at a time; under grad that route always recomputes
    each layer, its gather included, in the backward)."""
    B, F, C, H, W = noisy.shape
    if sp_mesh is not None:
        from self_forcing_tpu_torch.parallel.sequence import (
            forward_train_sp)
        flow = forward_train_sp(params, cfg, noisy, t, context, rope,
                                sp_mesh, axis_name=sp_axis, y=y,
                                clip_fea=clip_fea,
                                param_specs=sp_param_specs)
    else:
        flow = dit.forward_train(params, cfg, noisy, t, context, None, rope,
                                 remat=remat, kernels=kernels, y=y,
                                 clip_fea=clip_fea)
    return scheduler.convert_flow_pred_to_x0(
        flow.reshape(B * F, C, H, W), noisy.reshape(B * F, C, H, W),
        t.reshape(-1)).reshape(B, F, C, H, W)


def cfg_combined_score(params, cfg: WanConfig, rope: RopeTables,
                       scheduler: FlowMatchScheduler, noisy, t, context,
                       neg_context, guidance_scale: float,
                       remat: bool = True, kernels: bool = True,
                       cond: Optional[dict] = None, sp_mesh=None,
                       sp_axis: str = "sp", sp_param_specs=None):
    """Classifier-free guidance: cond + (cond - uncond) * scale (one
    forward when the scale is 0).  The image / pose conditioning rides
    both branches; ``sp_*`` as :func:`score_x0`."""
    y, clip_fea = model_cond(cfg, cond)
    sp = dict(sp_mesh=sp_mesh, sp_axis=sp_axis,
              sp_param_specs=sp_param_specs)
    pos = score_x0(params, cfg, rope, scheduler, noisy, t, context, remat,
                   kernels, y, clip_fea, **sp)
    if guidance_scale == 0.0:
        return pos
    uncond = score_x0(params, cfg, rope, scheduler, noisy, t, neg_context,
                      remat, kernels, y, clip_fea, **sp)
    return pos + (pos - uncond) * guidance_scale


@dataclasses.dataclass
class ModelBundle:
    """Configs, scheduler, RoPE tables and rollout pipeline of one
    distillation setup (generator causal, real and fake bidirectional).

    On a mesh (the trainer sets them): ``teacher_sp_mesh`` runs the real
    score sequence-parallel over its ``teacher_sp_axis``;
    ``teacher_param_sp_specs`` is the real score's ZeRO-3-over-sp layout;
    ``rollout_act_shard`` (``mesh.rollout_cache_constraint``) shards the
    rollout's KV cache."""

    generator_cfg: WanConfig
    critic_cfg: WanConfig          # fake_score
    teacher_cfg: WanConfig         # real_score
    scheduler: FlowMatchScheduler
    rope_g: RopeTables
    rope_c: RopeTables
    rope_t: RopeTables
    pipeline: SelfForcingTrainingPipeline
    # the VAE of the boundary re-encode of rollouts past 21 frames
    vae_params: Optional[dict] = None
    vae_cfg: Optional[object] = None
    independent_first_frame: bool = False
    teacher_sp_mesh: Optional[object] = None
    teacher_sp_axis: str = "sp"
    teacher_param_sp_specs: Optional[object] = None
    rollout_act_shard: Optional[object] = None

    @classmethod
    def create(cls, generator_cfg: WanConfig, critic_cfg: WanConfig,
               teacher_cfg: WanConfig, obj: ObjectiveConfig,
               denoising_step_list, scheduler=None, vae_params=None,
               vae_cfg=None, independent_first_frame: bool = False,
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
                   pipeline, vae_params=vae_params, vae_cfg=vae_cfg,
                   independent_first_frame=independent_first_frame)

    def run_generator(self, gen_params, noise, ctx_kv, exit_idx,
                      generator: torch.Generator | None = None,
                      eps: Optional[list] = None, kernels: bool = True,
                      cond: Optional[dict] = None):
        """Rollout -> (trajectory of the last 21 frames, gradient mask or
        None, t_from, t_to).  ``cond`` {add_condition, y, clip_fea} covers
        the whole training window; the rollout takes its leading ``F``
        frames (``clip_fea`` is already in ``ctx_kv``)."""
        cond = cond or {}
        F = noise.shape[1]
        fs = ((noise.shape[3] // self.generator_cfg.patch_size[1])
              * (noise.shape[4] // self.generator_cfg.patch_size[2]))
        y, _ = model_cond(self.generator_cfg, cond)
        add_condition = cond.get("add_condition")
        if y is not None:
            y = y[:, :F]
        if add_condition is not None:
            if add_condition.shape[1] < F * fs:
                raise ValueError(
                    f"add_condition covers {add_condition.shape[1] // fs} "
                    f"latent frames and the rollout {F}: a rollout of F "
                    f"latent frames needs a pose video of 4F - 3 pixel "
                    f"frames")
            add_condition = add_condition[:, :F * fs]
        pred, t_from, t_to = self.pipeline.inference_with_trajectory(
            gen_params, self.generator_cfg, self.rope_g, noise, ctx_kv,
            exit_idx, generator=generator, eps=eps, kernels=kernels, y=y,
            add_condition=add_condition, act_shard=self.rollout_act_shard)
        pred, gradient_mask = self.trim_rollout(pred)
        return pred, gradient_mask, t_from, t_to

    def trim_rollout(self, pred: torch.Tensor):
        """Rollouts of at most 21 frames pass as they are.  A longer one
        keeps its last 21 frames: the boundary frame is the no-grad VAE
        decode of ``pred[:, :-20]``, whose last pixel frame is re-encoded
        as an image latent; the first block (the first frame under
        ``independent_first_frame``) is masked out of the gradient."""
        if pred.shape[1] <= 21:
            return pred, None
        if self.vae_params is None:
            raise ValueError(
                "rollouts longer than 21 frames need the VAE for the "
                "boundary-frame re-encode; pass vae_params / vae_cfg to "
                "the trainer or the ModelBundle")
        from self_forcing_tpu_torch.models.wan import vae as vae_mod
        vdt = self.vae_params["conv2"]["w"].dtype
        with torch.no_grad():
            head = pred[:, :-20].detach().permute(0, 1, 3, 4, 2).to(vdt)
            pixels = vae_mod.decode(self.vae_params, self.vae_cfg, head)
            image_latent = vae_mod.encode(self.vae_params, self.vae_cfg,
                                          pixels[:, -1:])
            image_latent = image_latent.permute(0, 1, 4, 2, 3).to(pred.dtype)
        out = torch.cat([image_latent, pred[:, -20:]], dim=1)
        mask = torch.ones(out.shape, dtype=torch.bool, device=out.device)
        lead = 1 if self.independent_first_frame \
            else self.pipeline.num_frame_per_block
        mask[:, :lead] = False
        return out, mask
