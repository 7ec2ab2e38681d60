"""The GAN distillation objective (port of
``self_forcing_tpu/training/objectives/gan.py``).

The discriminator is the critic (fake score) backbone with the GAN head
of ``dit.forward_classify``.  Fake and real samples go through it in one
call of batch 2B at one shared critic timestep.

- generator: softplus(-D(fake)) (relativistic: softplus(-(D(fake) -
  D(real)))), times ``gan_g_weight``.  The discriminator is frozen (its
  parameters get no gradient); the gradient reaches the rollout through
  the discriminator's input.
- critic: softplus(-D(real)) + softplus(D(fake)) (relativistic:
  softplus(-(D(real) - D(fake)))), times ``gan_d_weight``, plus the R1 /
  R2 finite-difference penalties around the real and the fake samples,
  each with its own draw (the JAX package's fix of the reference's
  ``r2_loss``).

Draws come from a ``torch.Generator`` or through ``draws``: ``eps`` (the
rollout's), ``t`` (the integer critic timestep [B, 1] before the shift)
and ``noise``; the generator loss also takes ``real_noise`` (the real
sample's), the critic loss ``r1_noise`` and ``r2_noise`` (before the
sigma).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.training.objectives.base import (
    ModelBundle, ObjectiveConfig, sample_timestep)
from self_forcing_tpu_torch.training.objectives.dmd import (_add_noise_bf,
                                                            _noise_like,
                                                            _timestep_range)
from self_forcing_tpu_torch.utils import tree


def _discriminate(bundle: ModelBundle, fake_params, cls_params, noisy, t,
                  context, concat_time_embeddings: bool,
                  kernels: bool = True) -> torch.Tensor:
    _, logits = dit.forward_classify(
        fake_params, cls_params, bundle.critic_cfg, noisy, t, context,
        bundle.rope_c, concat_time_embeddings=concat_time_embeddings,
        kernels=kernels)
    return logits


def _critic_t(obj: ObjectiveConfig, B: int, F_: int, t_from, t_to,
              critic_shift: float, generator, device, draws):
    min_t, max_t = _timestep_range(obj, t_from, t_to)
    return sample_timestep(min_t, max_t, B, F_, critic_shift, obj.min_step,
                           obj.max_step, generator=generator, device=device,
                           draws=draws)


def generator_loss(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                   fake_params, cls_params, noise, clean_latent, context,
                   neg_context, exit_idx,
                   generator: torch.Generator | None = None,
                   draws: dict | None = None, gan_g_weight: float = 1e-2,
                   relativistic: bool = False,
                   concat_time_embeddings: bool = False,
                   critic_shift: float | None = None, kernels: bool = True):
    """Rollout with gradient, then the discriminator's generator loss."""
    del neg_context
    draws = draws or {}
    ctx_kv = dit.precompute_context(gen_params, bundle.generator_cfg,
                                    context)
    pred, _, t_from, t_to = bundle.run_generator(
        gen_params, noise, ctx_kv, exit_idx, generator=generator,
        eps=draws.get("eps"), kernels=kernels)
    B, F_ = pred.shape[:2]
    t = _critic_t(obj, B, F_, t_from, t_to,
                  critic_shift or obj.timestep_shift, generator,
                  pred.device, draws.get("t"))
    critic_noise = _noise_like(pred, generator, draws.get("noise"))
    real_noise = _noise_like(clean_latent, generator,
                             draws.get("real_noise"))
    noisy_fake = _add_noise_bf(bundle.scheduler, pred, critic_noise, t)
    noisy_real = _add_noise_bf(bundle.scheduler, clean_latent.detach(),
                               real_noise, t)
    logits = _discriminate(
        bundle, tree.detached(fake_params), tree.detached(cls_params),
        torch.cat([noisy_fake, noisy_real]), torch.cat([t, t]),
        torch.cat([context, context]), concat_time_embeddings, kernels)
    fake_logit, real_logit = logits.chunk(2)
    arg = fake_logit - real_logit if relativistic else fake_logit
    g_loss = F.softplus(-arg.float()).mean() * gan_g_weight
    return g_loss, {"gan_g_loss": g_loss.detach(),
                    "fake_logit_mean": fake_logit.detach().mean()}


def critic_loss(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                fake_params, cls_params, noise, real_latent, context,
                neg_context, exit_idx,
                generator: torch.Generator | None = None,
                draws: dict | None = None, gan_d_weight: float = 1e-2,
                relativistic: bool = False,
                concat_time_embeddings: bool = False,
                r1_weight: float = 0.0, r2_weight: float = 0.0,
                r1_sigma: float = 0.01, r2_sigma: float = 0.01,
                critic_shift: float | None = None, kernels: bool = True):
    """No-grad rollout, then the discriminator loss on the (fake, real)
    pair and the R1 / R2 penalties; the gradient goes to ``fake_params``
    and ``cls_params``."""
    del neg_context
    draws = draws or {}
    with torch.no_grad():
        ctx_kv = dit.precompute_context(gen_params, bundle.generator_cfg,
                                        context)
        pred, _, t_from, t_to = bundle.run_generator(
            gen_params, noise, ctx_kv, exit_idx, generator=generator,
            eps=draws.get("eps"), kernels=kernels)
    B, F_ = pred.shape[:2]
    t = _critic_t(obj, B, F_, t_from, t_to,
                  critic_shift or obj.timestep_shift, generator,
                  pred.device, draws.get("t"))
    critic_noise = _noise_like(pred, generator, draws.get("noise"))
    noisy_fake = _add_noise_bf(bundle.scheduler, pred, critic_noise, t)
    noisy_real = _add_noise_bf(bundle.scheduler, real_latent, critic_noise,
                               t)

    def disc(x, tt, ctx):
        return _discriminate(bundle, fake_params, cls_params, x, tt, ctx,
                             concat_time_embeddings, kernels)
    logits = disc(torch.cat([noisy_fake, noisy_real]), torch.cat([t, t]),
                  torch.cat([context, context]))
    fake_logit, real_logit = logits.chunk(2)
    if relativistic:
        d_loss = F.softplus(-(real_logit - fake_logit).float()).mean()
    else:
        d_loss = (F.softplus(-real_logit.float()).mean()
                  + F.softplus(fake_logit.float()).mean())
    d_loss = d_loss * gan_d_weight

    zero = torch.zeros((), device=pred.device)
    r1_loss = r2_loss = zero
    if r1_weight > 0:
        eps = r1_sigma * _noise_like(noisy_real, generator,
                                     draws.get("r1_noise"))
        r1_grad = (disc(noisy_real + eps, t, context) - real_logit) / r1_sigma
        r1_loss = r1_weight * (r1_grad.float() ** 2).mean()
    if r2_weight > 0:
        eps = r2_sigma * _noise_like(noisy_fake, generator,
                                     draws.get("r2_noise"))
        r2_grad = (disc(noisy_fake + eps, t, context) - fake_logit) / r2_sigma
        r2_loss = r2_weight * (r2_grad.float() ** 2).mean()
    total = d_loss + r1_loss + r2_loss
    return total, {"gan_d_loss": d_loss.detach(),
                   "r1_loss": r1_loss.detach(),
                   "r2_loss": r2_loss.detach(),
                   "noisy_real_logit": real_logit.detach().mean(),
                   "noisy_fake_logit": fake_logit.detach().mean()}
