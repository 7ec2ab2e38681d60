"""DMD, Distribution Matching Distillation (port of
``self_forcing_tpu/training/objectives/dmd.py``).

- KL gradient: the normalised (fake_x0 - real_x0_cfg) on a re-noised
  rollout sample, applied through loss = 1/2 |x - sg(x - grad)|^2.
- Critic: the flow-matching denoising loss of the fake score on a
  no-grad rollout sample.

Draws (rollout eps, the DMD / critic timestep and noise) come from a
``torch.Generator`` or are handed in through ``draws``: a dict with any of
``eps`` (the rollout's, see ``SelfForcingTrainingPipeline``), ``t`` (the
integer timestep [B, 1] before the shift) and ``noise``.  ``mark(name)``,
when given, is called after the rollout and after the score forwards
(the trainer's timing).  ``cond`` ({add_condition, y, clip_fea}, from
``PoseImageConditioner.build_conditioning``) reaches the rollout, the
score forwards and the critic, each model taking what it consumes
(``base.model_cond``); after a trimmed rollout the score models see the
trailing window of ``y`` (``base.align_cond_window``).
"""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.training.objectives.base import (
    ModelBundle, ObjectiveConfig, align_cond_window, cfg_combined_score,
    model_cond, sample_timestep, score_x0)
from self_forcing_tpu_torch.utils.loss import get_denoising_loss


def _add_noise_bf(scheduler, x, noise, t):
    B, F = x.shape[:2]

    def flat(a):
        return a.reshape((B * F,) + tuple(a.shape[2:]))
    return scheduler.add_noise(flat(x), flat(noise), t.reshape(-1)
                               ).reshape(x.shape)


def _timestep_range(obj: ObjectiveConfig, t_from, t_to):
    min_t = t_to if (obj.ts_schedule and t_to is not None) \
        else obj.min_score_timestep
    max_t = t_from if (obj.ts_schedule_max and t_from is not None) \
        else obj.num_train_timestep
    return int(min_t), int(max_t)


def _noise_like(x, generator, given):
    if given is not None:
        return given.to(device=x.device, dtype=x.dtype)
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32).to(x.dtype)


def _mark(mark, name):
    if mark is not None:
        mark(name)


def _lead_y(cond, F: int):
    """``cond`` with ``y`` cut to the first ``F`` frames (a no-op after
    :func:`align_cond_window`; it covers direct short-rollout callers)."""
    if cond and cond.get("y") is not None:
        return dict(cond, y=cond["y"][:, :F])
    return cond


def make_ctx(gen_params, cfg, context, cond=None) -> dict:
    """The generator's cross-attention K/V, with the image K/V of
    ``cond['clip_fea']`` for an i2v generator."""
    clip_fea = (cond or {}).get("clip_fea") \
        if cfg.model_type == "i2v" else None
    return dit.precompute_context(gen_params, cfg, context, clip_fea)


@torch.no_grad()
def compute_kl_grad(bundle: ModelBundle, obj: ObjectiveConfig,
                    fake_params, real_params, noisy, pred, t, context,
                    neg_context, kernels: bool = True, cond=None):
    """The DMD gradient direction (fp32), from no-grad score forwards:
    the fake score (guidance ``fake_guidance_scale``) and the real score
    with CFG, normalised by mean |pred - real_x0| per sample."""
    fake_x0 = cfg_combined_score(
        fake_params, bundle.critic_cfg, bundle.rope_c, bundle.scheduler,
        noisy, t, context, neg_context, obj.fake_guidance_scale,
        kernels=kernels, cond=cond)
    real_x0 = cfg_combined_score(
        real_params, bundle.teacher_cfg, bundle.rope_t, bundle.scheduler,
        noisy, t, context, neg_context, obj.real_guidance_scale,
        kernels=kernels, cond=cond)
    grad = fake_x0.float() - real_x0.float()
    p_real = pred.detach().float() - real_x0.float()
    normalizer = p_real.abs().mean(dim=(1, 2, 3, 4), keepdim=True)
    grad = torch.nan_to_num(grad / normalizer)
    return grad, {"dmdtrain_gradient_norm": grad.abs().mean()}


def distribution_matching_loss(bundle: ModelBundle, obj: ObjectiveConfig,
                               fake_params, real_params, pred, context,
                               neg_context, t_from, t_to,
                               gradient_mask=None,
                               generator: torch.Generator | None = None,
                               draws: dict | None = None,
                               kernels: bool = True, mark=None, cond=None):
    """The DMD loss of a rollout ``pred`` that carries the generator's
    gradient."""
    draws = draws or {}
    B, F = pred.shape[:2]
    cond = _lead_y(cond, F)
    min_t, max_t = _timestep_range(obj, t_from, t_to)
    t = sample_timestep(min_t, max_t, B, F, obj.timestep_shift,
                        obj.min_step, obj.max_step, generator=generator,
                        device=pred.device, draws=draws.get("t"))
    noise = _noise_like(pred, generator, draws.get("noise"))
    with torch.no_grad():
        noisy = _add_noise_bf(bundle.scheduler, pred.detach(), noise, t)
    grad, log = compute_kl_grad(bundle, obj, fake_params, real_params,
                                noisy, pred, t, context, neg_context,
                                kernels, cond)
    _mark(mark, "score_forwards")
    target = (pred.float() - grad).detach()
    diff = (pred.float() - target) ** 2
    if gradient_mask is not None:
        loss = 0.5 * (diff * gradient_mask).sum() / torch.clamp_min(
            gradient_mask.sum(), 1)
    else:
        loss = 0.5 * diff.mean()
    log["timestep_mean"] = t.mean()
    return loss, log


def generator_loss(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                   fake_params, real_params, noise, context, neg_context,
                   exit_idx, generator: torch.Generator | None = None,
                   draws: dict | None = None, gradient_mask=None,
                   kernels: bool = True, mark=None, cond=None):
    """Rollout with gradient, then the DMD loss."""
    draws = draws or {}
    ctx_kv = make_ctx(gen_params, bundle.generator_cfg, context, cond)
    pred, roll_mask, t_from, t_to = bundle.run_generator(
        gen_params, noise, ctx_kv, exit_idx, generator=generator,
        eps=draws.get("eps"), kernels=kernels, cond=cond)
    _mark(mark, "rollout")
    if gradient_mask is None:
        gradient_mask = roll_mask
    cond = align_cond_window(cond, noise.shape[1], pred.shape[1])
    return distribution_matching_loss(
        bundle, obj, fake_params, real_params, pred, context, neg_context,
        t_from, t_to, gradient_mask, generator=generator, draws=draws,
        kernels=kernels, mark=mark, cond=cond)


def critic_loss(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                fake_params, noise, context, neg_context, exit_idx,
                generator: torch.Generator | None = None,
                draws: dict | None = None, kernels: bool = True, mark=None,
                cond=None):
    """No-grad rollout, then the fake score's denoising loss on it (the
    gradient goes to ``fake_params``)."""
    draws = draws or {}
    with torch.no_grad():
        ctx_kv = make_ctx(gen_params, bundle.generator_cfg, context, cond)
        pred, _, t_from, t_to = bundle.run_generator(
            gen_params, noise, ctx_kv, exit_idx, generator=generator,
            eps=draws.get("eps"), kernels=kernels, cond=cond)
    _mark(mark, "rollout")
    B, F = pred.shape[:2]
    min_t, max_t = _timestep_range(obj, t_from, t_to)
    t = sample_timestep(min_t, max_t, B, F, obj.timestep_shift,
                        obj.min_step, obj.max_step, generator=generator,
                        device=pred.device, draws=draws.get("t"))
    critic_noise = _noise_like(pred, generator, draws.get("noise"))
    noisy = _add_noise_bf(bundle.scheduler, pred, critic_noise, t)
    y_c, clip_c = model_cond(bundle.critic_cfg, align_cond_window(
        cond, noise.shape[1], F))
    pred_fake = score_x0(fake_params, bundle.critic_cfg, bundle.rope_c,
                         bundle.scheduler, noisy, t, context,
                         kernels=kernels, y=y_c, clip_fea=clip_c)
    _mark(mark, "score_forwards")

    def flat(a):
        return a.reshape((B * F,) + tuple(a.shape[2:]))
    loss_fn = get_denoising_loss(obj.denoising_loss_type)
    if obj.denoising_loss_type == "flow":
        flow_pred = bundle.scheduler.convert_x0_to_flow_pred(
            flat(pred_fake), flat(noisy), t.reshape(-1))
        loss = loss_fn(x=flat(pred), noise=flat(critic_noise),
                       flow_pred=flow_pred)
    else:
        noise_pred = bundle.scheduler.convert_x0_to_noise(
            flat(pred_fake), flat(noisy), t.reshape(-1))
        loss = loss_fn(x=flat(pred), x_pred=flat(pred_fake),
                       noise=flat(critic_noise), noise_pred=noise_pred,
                       alphas_cumprod=None, timestep=t.reshape(-1))
    return loss, {"critic_timestep_mean": t.mean()}
