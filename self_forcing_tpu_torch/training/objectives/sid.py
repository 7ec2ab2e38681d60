"""SiD, Score identity Distillation (port of
``self_forcing_tpu/training/objectives/sid.py``).

Generator loss on a re-noised rollout sample:
    L = (s_real - s_fake) * ((s_real - x0) - alpha * (s_real - s_fake))
divided by mean |x0 - s_real| per sample (no gradient through it),
nan_to_num, mean.  Unlike DMD the score forwards are not detached: the
gradient flows through the noised sample and both score models (the real
one with CFG) into the generator, so the generator update runs the flash
backward.  The score models' parameters get no gradient.  The critic loss
is DMD's.

Draws as in ``objectives/dmd.py``: ``eps``, ``t`` and ``noise``; so is
``cond``.
"""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.training.objectives.base import (
    ModelBundle, ObjectiveConfig, align_cond_window, cfg_combined_score,
    model_cond, sample_timestep, score_x0)
from self_forcing_tpu_torch.training.objectives.dmd import (
    _add_noise_bf, _lead_y, _mark, _noise_like, _timestep_range,
    critic_loss, make_ctx)
from self_forcing_tpu_torch.utils import tree

__all__ = ["generator_loss", "critic_loss", "distribution_matching_loss"]


def distribution_matching_loss(bundle: ModelBundle, obj: ObjectiveConfig,
                               fake_params, real_params, pred, context,
                               neg_context, t_from, t_to,
                               gradient_mask=None,
                               generator: torch.Generator | None = None,
                               draws: dict | None = None,
                               kernels: bool = True, mark=None, cond=None):
    """The SiD loss of a rollout ``pred`` that carries the generator's
    gradient."""
    draws = draws or {}
    B, F = pred.shape[:2]
    cond = _lead_y(cond, F)
    min_t, max_t = _timestep_range(obj, t_from, t_to)
    t = sample_timestep(min_t, max_t, B, F, obj.timestep_shift,
                        obj.min_step, obj.max_step, generator=generator,
                        device=pred.device, draws=draws.get("t"))
    noise = _noise_like(pred, generator, draws.get("noise"))
    noisy = _add_noise_bf(bundle.scheduler, pred, noise, t)
    y_c, clip_c = model_cond(bundle.critic_cfg, cond)
    fake_x0 = score_x0(tree.detached(fake_params),
                       bundle.critic_cfg, bundle.rope_c, bundle.scheduler,
                       noisy, t, context, kernels=kernels, y=y_c,
                       clip_fea=clip_c)
    real_x0 = cfg_combined_score(
        tree.detached(real_params), bundle.teacher_cfg,
        bundle.rope_t, bundle.scheduler, noisy, t, context, neg_context,
        obj.real_guidance_scale, kernels=kernels, cond=cond)
    _mark(mark, "score_forwards")
    rf, ff, pf = real_x0.float(), fake_x0.float(), pred.float()
    sid = (rf - ff) * ((rf - pf) - obj.sid_alpha * (rf - ff))
    normalizer = (pf - rf).abs().mean(dim=(1, 2, 3, 4), keepdim=True)
    sid = torch.nan_to_num(sid / normalizer.detach())
    if gradient_mask is not None:
        loss = (sid * gradient_mask).sum() / torch.clamp_min(
            gradient_mask.sum(), 1)
    else:
        loss = sid.mean()
    return loss, {"dmdtrain_gradient_norm": torch.zeros(()),
                  "timestep_mean": t.mean()}


def generator_loss(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                   fake_params, real_params, noise, context, neg_context,
                   exit_idx, generator: torch.Generator | None = None,
                   draws: dict | None = None, gradient_mask=None,
                   kernels: bool = True, mark=None, cond=None):
    """Rollout with gradient, then the SiD loss."""
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
