"""The CausVid baseline objective (port of
``self_forcing_tpu/training/objectives/causvid.py``): no rollout.  Clean
teacher latents are noised to a timestep of the denoising list chosen per
block at random (frames at timestep 0 stay clean), the generator runs
once without a KV cache (block-causal, or teacher forcing), and its x0
prediction takes the DMD loss.  The critic takes DMD's denoising loss on
the no-grad predictions.

Draws come from a ``torch.Generator`` or through ``draws``: ``idx`` (the
list index per frame [B, F]), ``gen_noise`` (the noise on the clean
latents), and the DMD / critic ``t`` and ``noise``.
"""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.ops.masks import (block_causal_mask,
                                              teacher_forcing_mask)
from self_forcing_tpu_torch.training.objectives.base import (
    ModelBundle, ObjectiveConfig, sample_timestep, sample_timestep_per_block,
    score_x0)
from self_forcing_tpu_torch.training.objectives.dmd import (
    _add_noise_bf, _noise_like, distribution_matching_loss)
from self_forcing_tpu_torch.training.objectives.ode_regression import (
    gather_steps)
from self_forcing_tpu_torch.utils.loss import get_denoising_loss


def _run_generator(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                   clean_latent, context, step_list, teacher_forcing: bool,
                   generator, draws: dict, kernels: bool):
    """One generator forward on the noised clean latents -> its x0
    prediction."""
    B, F, C, H, W = clean_latent.shape
    idx = draws.get("idx")
    if idx is None:
        idx = sample_timestep_per_block(0, len(step_list), B, F,
                                        obj.num_frame_per_block,
                                        generator=generator,
                                        device=clean_latent.device)
    t = gather_steps(step_list, torch.as_tensor(
        idx, device=clean_latent.device).long())
    noise = _noise_like(clean_latent, generator, draws.get("gen_noise"))
    noisy = _add_noise_bf(bundle.scheduler, clean_latent, noise, t)
    noisy = torch.where((t == 0.0)[..., None, None, None], clean_latent,
                        noisy)
    cfg = bundle.generator_cfg
    fs = (H // cfg.patch_size[1]) * (W // cfg.patch_size[2])
    if teacher_forcing:
        mask = teacher_forcing_mask(F, fs, obj.num_frame_per_block)
        flow = dit.forward_train(gen_params, cfg, noisy, t, context, mask,
                                 bundle.rope_g, clean_x=clean_latent,
                                 kernels=kernels)
    else:
        mask = block_causal_mask(F, fs, obj.num_frame_per_block,
                                 cfg.local_attn_size)
        flow = dit.forward_train(gen_params, cfg, noisy, t, context, mask,
                                 bundle.rope_g, kernels=kernels)

    def flat(a):
        return a.reshape((B * F,) + tuple(a.shape[2:]))
    return bundle.scheduler.convert_flow_pred_to_x0(
        flat(flow), flat(noisy), t.reshape(-1)).reshape(clean_latent.shape)


def generator_loss(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                   fake_params, real_params, clean_latent, context,
                   neg_context, generator: torch.Generator | None = None,
                   teacher_forcing: bool = False, draws: dict | None = None,
                   kernels: bool = True):
    """The one-step prediction, then the DMD loss."""
    draws = draws or {}
    pred = _run_generator(bundle, obj, gen_params, clean_latent, context,
                          bundle.pipeline.denoising_step_list,
                          teacher_forcing, generator, draws, kernels)
    return distribution_matching_loss(
        bundle, obj, fake_params, real_params, pred, context, neg_context,
        None, None, generator=generator, draws=draws, kernels=kernels)


def critic_loss(bundle: ModelBundle, obj: ObjectiveConfig, gen_params,
                fake_params, clean_latent, context, neg_context,
                generator: torch.Generator | None = None,
                teacher_forcing: bool = False, draws: dict | None = None,
                kernels: bool = True):
    """The fake score's denoising loss on the no-grad one-step
    predictions."""
    del neg_context
    draws = draws or {}
    with torch.no_grad():
        pred = _run_generator(bundle, obj, gen_params, clean_latent, context,
                              bundle.pipeline.denoising_step_list,
                              teacher_forcing, generator, draws, kernels)
    B, F = pred.shape[:2]
    t = sample_timestep(obj.min_score_timestep, obj.num_train_timestep, B, F,
                        obj.timestep_shift, obj.min_step, obj.max_step,
                        generator=generator, device=pred.device,
                        draws=draws.get("t"))
    critic_noise = _noise_like(pred, generator, draws.get("noise"))
    noisy = _add_noise_bf(bundle.scheduler, pred, critic_noise, t)
    pred_fake = score_x0(fake_params, bundle.critic_cfg, bundle.rope_c,
                         bundle.scheduler, noisy, t, context,
                         kernels=kernels)

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
                       alphas_cumprod=getattr(bundle.scheduler,
                                              "alphas_cumprod", None),
                       timestep=t.reshape(-1))
    return loss, {"critic_timestep_mean": t.mean()}
