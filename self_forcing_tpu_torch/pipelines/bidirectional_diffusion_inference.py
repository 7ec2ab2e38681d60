"""Many-step CFG sampling with the bidirectional Wan model, the quality
reference path (port of
``self_forcing_tpu/pipelines/bidirectional_diffusion_inference.py``).

50 UniPC (or DPM-Solver++) steps over the whole video, each a positive
and a negative cache-free forward (``dit.forward_train`` with no mask:
full self-attention through the flash kernel on the card) and the guided
flow ``u + g (c - u)`` in float32.  The sample and the solver state stay
in the noise's dtype; only the DiT's input is cast to the pipeline's
``dtype``.  The JAX package scans the steps inside one jit; here they are
a Python loop.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.pipelines.causal_diffusion_inference import (
    guided_flow)
from self_forcing_tpu_torch.solvers import CoeffSolver, make_solver


def sample_cfg(params, cfg: WanConfig, rope: RopeTables,
               solver: CoeffSolver, noise: torch.Tensor,
               context: torch.Tensor, neg_context: torch.Tensor,
               guidance_scale: float,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole solver schedule from ``noise`` [B, F, C, H, W]; the DiT
    sees the sample in ``dtype`` (default the noise's).  Returns the
    latents in the noise's dtype."""
    B, F = noise.shape[:2]
    dtype = noise.dtype if dtype is None else dtype

    def model(x, t_val, i):
        t = torch.full((B, F), t_val, dtype=torch.float32, device=x.device)
        xin = x.to(dtype)
        cond = dit.forward_train(params, cfg, xin, t, context, None, rope,
                                 remat=False)
        uncond = dit.forward_train(params, cfg, xin, t, neg_context, None,
                                   rope, remat=False)
        return guided_flow(cond, uncond, guidance_scale)

    return solver.sample(model, noise)


class BidirectionalDiffusionInferencePipeline:
    """``args`` holds sampling_steps (50), sample_solver ('unipc'),
    guidance_scale (5.0), negative_prompt and ``shift`` (8.0): this
    pipeline reads ``shift``, where the causal one reads
    ``timestep_shift``, as the JAX package does."""

    def __init__(self, args, generator_params, model_cfg: WanConfig,
                 text_encoder=None, vae_params=None,
                 vae_cfg: vae_mod.VAEConfig = vae_mod.WAN_VAE,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
        self.args = args
        self.params = generator_params
        self.cfg = model_cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.text_encoder = text_encoder
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        self.sampling_steps = int(getattr(args, "sampling_steps", 50))
        self.sample_solver = str(getattr(args, "sample_solver", "unipc"))
        self.shift = float(getattr(args, "shift", 8.0))
        self.guidance_scale = float(getattr(args, "guidance_scale", 5.0))
        self.solver = make_solver(self.sample_solver, self.sampling_steps,
                                  self.shift, device=self.device)
        self.rope = RopeTables.create(self.cfg.head_dim, device=self.device)

    def inference(self, noise: torch.Tensor,
                  text_prompts: Optional[List[str]] = None,
                  context: Optional[torch.Tensor] = None,
                  neg_context: Optional[torch.Tensor] = None,
                  return_latents: bool = False):
        """noise [B, F, C, H, W] -> video [B, F_pix, 3, H*8, W*8] in [0, 1]
        (None without VAE parameters)."""
        if context is None:
            context = self.text_encoder(text_prompts)
            neg_context = self.text_encoder(
                [getattr(self.args, "negative_prompt", "")]
                * noise.shape[0])
        latents = sample_cfg(self.params, self.cfg, self.rope, self.solver,
                             noise, context.to(self.device, self.dtype),
                             neg_context.to(self.device, self.dtype),
                             self.guidance_scale, self.dtype)
        video = None
        if self.vae_params is not None:
            vdt = self.vae_params["conv2"]["w"].dtype
            lat = latents.permute(0, 1, 3, 4, 2)
            lat = lat.to(torch.promote_types(lat.dtype, vdt))
            video = vae_mod.decode(self.vae_params, self.vae_cfg, lat)
            video = (video * 0.5 + 0.5).clamp(0, 1).permute(0, 1, 4, 2, 3)
        if return_latents:
            return video, latents
        return video
