"""Chunk-wise autoregressive sampling with a many-step CFG solver, the
50-step causal path with UniAnimate pose conditioning (port of
``self_forcing_tpu/pipelines/causal_diffusion_inference.py``).

Against the few-step pipeline (``causal_inference.py``):
- two KV caches, one for the prompt and one for the negative prompt,
  written in lock-step: every solver step runs a positive and a negative
  forward, each rewriting the block's slot of its cache, and the t = 0
  refresh of the clean block rewrites both once more;
- a fresh UniPC / DPM-Solver++ schedule a block (``solvers.py``), the
  classifier-free guidance ``u + g (c - u)`` on the flow;
- optional pose conditioning: the DWPose 3D-CNN embedding sliced a block
  into ``add_condition`` tokens (by the block's RoPE frame), the
  reference-pose 2D-CNN map folded into a y-consuming model's ``y``;
- optional image conditioning (``input_image`` with an ``image_encoder``):
  CLIP image tokens, which both contexts carry on an i2v model, and the
  masked first-frame VAE latent as ``y`` (the reference-pose map added
  to it);
- ``start_frame_index`` moves the RoPE positions away from the cache
  positions.

The sample and the solver state stay in the noise's dtype (float32 from
the CLI) and the guided flow is combined in float32; only the DiT's input
is cast to the pipeline's ``dtype`` (bf16 on the card, whose decode
kernel takes a bf16 cache only).  The JAX package scans the 50 steps of a
block inside one jit; here they are a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from self_forcing_tpu_torch import conditioning as cond_mod
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.solvers import (CoeffSolver, init_solver_state,
                                            make_solver)
from self_forcing_tpu_torch.utils.profiling import PhaseTimer


def guided_flow(flow_c: torch.Tensor, flow_u: torch.Tensor,
                guidance_scale: float) -> torch.Tensor:
    """u + g (c - u) in float32: a large g amplifies the rounding of the
    difference of two close flows."""
    u = flow_u.float()
    return u + guidance_scale * (flow_c.float() - u)


def _forward_pair(params, cfg, rope, x, t, ctx_pos, ctx_neg, cache_pos,
                  cache_neg, start_frame, **kw):
    """The positive and the negative forward of ``x`` at ``t``, each on
    its own cache.  Returns (flow_c, flow_u, cache_pos, cache_neg)."""
    flow_c, cache_pos = dit.forward_inference(
        params, cfg, x, t, ctx_pos, cache_pos, start_frame, rope, **kw)
    flow_u, cache_neg = dit.forward_inference(
        params, cfg, x, t, ctx_neg, cache_neg, start_frame, rope, **kw)
    return flow_c, flow_u, cache_pos, cache_neg


def denoise_block_cfg(params, cfg: WanConfig, rope: RopeTables,
                      solver: CoeffSolver, noisy: torch.Tensor,
                      ctx_pos: dict, ctx_neg: dict, cache_pos: dit.KVCache,
                      cache_neg: dit.KVCache, start_frame: int,
                      cache_start_frame: int, guidance_scale: float,
                      add_condition: torch.Tensor | None = None,
                      y: torch.Tensor | None = None,
                      dtype: torch.dtype | None = None,
                      static_kv_hi: int | None = None):
    """The solver's steps on one block, each a positive and a negative
    forward (both writing the block's K/V) and the guided flow, then the
    t = 0 refresh of the clean block in both caches.  ``dtype``: the DiT
    input's (default the sample's).  Returns (x0, cache_pos, cache_neg),
    x0 in the sample's dtype."""
    B, Fb = noisy.shape[:2]
    dtype = noisy.dtype if dtype is None else dtype
    kw = dict(cache_start_frame=cache_start_frame, static_kv_hi=static_kv_hi,
              y=y, add_condition=add_condition)
    x = noisy
    state = init_solver_state(noisy.shape, noisy.device, noisy.dtype)
    for i, t_val in enumerate(solver.timesteps):
        t = torch.full((B, Fb), float(t_val), dtype=torch.float32,
                       device=x.device)
        flow_c, flow_u, cache_pos, cache_neg = _forward_pair(
            params, cfg, rope, x.to(dtype), t, ctx_pos, ctx_neg, cache_pos,
            cache_neg, start_frame, **kw)
        state, x = solver.step(i, state,
                               guided_flow(flow_c, flow_u, guidance_scale), x)
    t0 = torch.zeros((B, Fb), dtype=torch.float32, device=x.device)
    _, _, cache_pos, cache_neg = _forward_pair(
        params, cfg, rope, x.to(dtype), t0, ctx_pos, ctx_neg, cache_pos,
        cache_neg, start_frame, **kw)
    return x, cache_pos, cache_neg


def prime_block_cfg(params, cfg: WanConfig, rope: RopeTables, ctx_pos: dict,
                    ctx_neg: dict, cache_pos: dit.KVCache,
                    cache_neg: dit.KVCache, latents: torch.Tensor,
                    start_frame: int, cache_start_frame: int,
                    static_kv_hi: int | None = None):
    """Write clean context latents into both caches at t = 0."""
    B, Fb = latents.shape[:2]
    t = torch.zeros((B, Fb), dtype=torch.float32, device=latents.device)
    _, _, cache_pos, cache_neg = _forward_pair(
        params, cfg, rope, latents, t, ctx_pos, ctx_neg, cache_pos,
        cache_neg, start_frame, cache_start_frame=cache_start_frame,
        static_kv_hi=static_kv_hi)
    return cache_pos, cache_neg


class CausalDiffusionInferencePipeline:
    """The 50-step causal sampler.  ``args`` holds the config keys
    sampling_steps (50), sample_solver ('unipc'), timestep_shift (8.0),
    guidance_scale (5.0), num_frame_per_block, independent_first_frame and
    negative_prompt.  ``dwpose_params`` / ``randomref_params``: the pose
    CNNs' weights (``conditioning.py``); ``image_encoder``: the CLIP
    vision tower as (clip_params, clip_cfg), or its bare params.
    ``dtype``: the DiT's activations and the caches'."""

    def __init__(self, args, generator_params, model_cfg: WanConfig,
                 text_encoder=None, vae_params=None,
                 vae_cfg: vae_mod.VAEConfig = vae_mod.WAN_VAE,
                 dwpose_params=None, randomref_params=None,
                 image_encoder=None,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
        self.args = args
        self.params = generator_params
        self.device = torch.device(device)
        self.dtype = dtype
        self.cfg = dataclasses.replace(
            model_cfg,
            num_frame_per_block=int(getattr(args, "num_frame_per_block", 1)),
            independent_first_frame=bool(
                getattr(args, "independent_first_frame", False)))
        self.text_encoder = text_encoder
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        self.image_encoder = image_encoder
        self.dwpose_params = dwpose_params
        self.randomref_params = randomref_params
        self.sampling_steps = int(getattr(args, "sampling_steps", 50))
        self.sample_solver = str(getattr(args, "sample_solver", "unipc"))
        self.shift = float(getattr(args, "timestep_shift", 8.0))
        self.guidance_scale = float(getattr(args, "guidance_scale", 5.0))
        self.solver = make_solver(self.sample_solver, self.sampling_steps,
                                  self.shift, device=self.device)
        self.rope = RopeTables.create(self.cfg.head_dim, device=self.device)
        self.num_frame_per_block = self.cfg.num_frame_per_block
        self.independent_first_frame = self.cfg.independent_first_frame
        self.profile_ms: dict = {}  # the last inference(profile=True)

    def encode_image(self, image: torch.Tensor, num_frames: int,
                     height: int, width: int):
        """CLIP image tokens and the masked first-frame latent ``y`` of
        ``image`` ([B, 3, H, W] in [-1, 1], or [B, H, W, 3] uint8) for
        ``num_frames`` latent frames at height x width pixels.  Returns
        (clip_fea [B, 257, 1280], y [B, F, 20, h, w])."""
        if self.image_encoder is None:
            raise ValueError(
                "input_image given but the pipeline has no image_encoder "
                "(pass image_encoder=(clip_params, clip_cfg))")
        if self.vae_params is None:
            raise ValueError("input_image conditioning needs vae_params for "
                             "the first-frame latent")
        enc = self.image_encoder
        clip_params, clip_cfg = enc if isinstance(enc, tuple) else (enc, None)
        conditioner = cond_mod.PoseImageConditioner(
            dwpose_params=self.dwpose_params,
            randomref_params=self.randomref_params, clip_params=clip_params,
            clip_cfg=clip_cfg, vae_params=self.vae_params,
            vae_cfg=self.vae_cfg)
        return conditioner.encode_image(image.to(self.device), num_frames,
                                        height, width)

    def _check_frames(self, F: int, initial_latent) -> None:
        """Raise where the block schedule would drop noise frames or leave
        context frames unprimed."""
        nb, iff = self.num_frame_per_block, self.independent_first_frame
        n_gen = F - (1 if (iff and initial_latent is None) else 0)
        if n_gen % nb != 0:
            raise ValueError(
                f"noise frame count {F} is not consumable by "
                f"num_frame_per_block={nb} (independent_first_frame={iff}, "
                f"initial_latent={initial_latent is not None}): "
                f"{n_gen % nb} frames would be silently dropped")
        if initial_latent is not None:
            n_prime = initial_latent.shape[1] - (1 if iff else 0)
            if n_prime % nb != 0:
                raise ValueError(
                    f"initial_latent frame count {initial_latent.shape[1]} "
                    f"is not consumable by num_frame_per_block={nb} "
                    f"(independent_first_frame={iff}): the last "
                    f"{n_prime % nb} context frames would never be primed "
                    "into the KV cache")

    def _pose_inputs(self, B: int, F: int, dwpose_data, random_ref_dwpose,
                     image_y=None):
        """(the DWPose embedding or None, ``y`` or None).  The reference
        pose map is added to the image's ``y`` where there is one; alone
        it becomes ``y`` (repeated a frame) on a y-consuming model only: a
        t2v model (in_dim == out_dim) has no y channels, so there it is
        dropped."""
        emb, y = None, image_y
        if dwpose_data is not None:
            emb = cond_mod.dwpose_embedding(
                self.dwpose_params,
                cond_mod.prepare_dwpose_input(dwpose_data.to(self.device)))
        if (random_ref_dwpose is not None
                and self.randomref_params is not None
                and (y is not None or self.cfg.in_dim > self.cfg.out_dim)):
            ref = random_ref_dwpose.to(self.device).float() / 255.0
            if ref.dim() == 3:
                ref = ref[None]
            rr = cond_mod.randomref_embedding(self.randomref_params,
                                              ref.permute(0, 3, 1, 2))
            if y is not None:
                y = y + rr[:, None].to(y.dtype)
            else:
                y = rr[:, None].to(self.dtype).expand(B, F, *rr.shape[1:])
        return emb, y

    def inference(self, noise: torch.Tensor,
                  text_prompts: Optional[List[str]] = None,
                  context: Optional[torch.Tensor] = None,
                  neg_context: Optional[torch.Tensor] = None,
                  input_image: Optional[torch.Tensor] = None,
                  dwpose_data: Optional[torch.Tensor] = None,
                  random_ref_dwpose: Optional[torch.Tensor] = None,
                  initial_latent: Optional[torch.Tensor] = None,
                  return_latents: bool = False,
                  start_frame_index: int = 0, profile: bool = False):
        """noise [B, F, C, H, W] -> video [B, F_pix, 3, H*8, W*8] in [0, 1]
        (None without VAE parameters).  ``input_image`` [B, 3, H0, W0] in
        [-1, 1] or [B, H0, W0, 3] uint8 (needs ``image_encoder`` and the
        VAE): its CLIP tokens and first-frame ``y`` condition every block.
        ``dwpose_data`` [B, 3, 4F' - 3,
        H*8, W*8] uint8 (F' >= the last block's RoPE frame + 1);
        ``random_ref_dwpose`` [(B,) H*8, W*8, 3] uint8; ``initial_latent``
        [B, F0, C, H, W]: clean frames primed into both caches first and
        put in front of the output.  ``profile=True`` synchronises the
        device after the set-up, each block and the decode, prints each
        one's host-clock ms and keeps them in ``self.profile_ms``."""
        clock = PhaseTimer(noise.device, on=profile)
        B, F, C, H, W = noise.shape
        nb = self.num_frame_per_block
        fs = (H // self.cfg.patch_size[1]) * (W // self.cfg.patch_size[2])
        self._check_frames(F, initial_latent)
        if context is None:
            context = self.text_encoder(text_prompts)
        if neg_context is None:
            if self.text_encoder is None:
                raise ValueError(
                    "CFG needs negative embeddings: pass neg_context "
                    "alongside context, or construct the pipeline with a "
                    "text encoder to encode the negative prompt")
            neg_context = self.text_encoder(
                [getattr(self.args, "negative_prompt", "")] * B)
        # the image's CLIP tokens ride both contexts (an i2v model's); its
        # y conditions every generated frame
        clip_fea = image_y = None
        if input_image is not None:
            clip_fea, image_y = self.encode_image(input_image, F, H * 8,
                                                  W * 8)
            image_y = image_y.to(self.dtype)
            clip_fea = (clip_fea.to(self.dtype)
                        if self.cfg.model_type == "i2v" else None)
        ctx_pos = dit.precompute_context(
            self.params, self.cfg, context.to(self.device, self.dtype),
            clip_fea)
        ctx_neg = dit.precompute_context(
            self.params, self.cfg, neg_context.to(self.device, self.dtype),
            clip_fea)
        F0 = 0 if initial_latent is None else initial_latent.shape[1]
        caches = [dit.init_kv_cache(self.cfg, B, fs, max(F + F0, 21),
                                    self.dtype, self.device)
                  for _ in range(2)]
        dwpose_emb, y = self._pose_inputs(B, F, dwpose_data,
                                          random_ref_dwpose, image_y)
        windowed = self.cfg.local_attn_size != -1

        def hint(cache_start):  # tokens already cached (global cache)
            return None if windowed else cache_start * fs

        current_start = int(start_frame_index)   # RoPE frame
        cache_start = 0                          # cache frame
        outputs = []
        if initial_latent is not None:
            outputs.append(initial_latent.to(noise.dtype))
            lead = 1 if self.independent_first_frame else 0
            blocks = [(0, lead)] if lead else []
            blocks += [(lead + b * nb, nb) for b in range((F0 - lead) // nb)]
            for lo, n in blocks:
                caches = prime_block_cfg(
                    self.params, self.cfg, self.rope, ctx_pos, ctx_neg,
                    *caches, initial_latent[:, lo:lo + n].to(self.dtype),
                    current_start, cache_start, hint(cache_start))
                current_start += n
                cache_start += n
        clock.lap("init_ms")

        sizes = [nb] * ((F - (1 if (self.independent_first_frame
                                    and initial_latent is None) else 0))
                        // nb)
        if self.independent_first_frame and initial_latent is None:
            sizes = [1] + sizes
        noise_ptr = 0
        for b, n in enumerate(sizes):
            add_condition = None
            if dwpose_emb is not None:
                # pose frames follow the RoPE frame, not the noise
                add_condition = cond_mod.pose_tokens_for_block(
                    dwpose_emb, current_start, n).to(self.dtype)
            x0, *caches = denoise_block_cfg(
                self.params, self.cfg, self.rope, self.solver,
                noise[:, noise_ptr:noise_ptr + n], ctx_pos, ctx_neg,
                *caches, current_start, cache_start, self.guidance_scale,
                add_condition=add_condition,
                y=None if y is None else y[:, noise_ptr:noise_ptr + n],
                dtype=self.dtype, static_kv_hi=hint(cache_start))
            outputs.append(x0)
            current_start += n
            cache_start += n
            noise_ptr += n
            clock.lap(f"block{b}_ms")
        del caches
        latents = torch.cat(outputs, dim=1)
        video = None
        if self.vae_params is not None:
            vdt = self.vae_params["conv2"]["w"].dtype
            lat = latents.permute(0, 1, 3, 4, 2)
            lat = lat.to(torch.promote_types(lat.dtype, vdt))
            video = vae_mod.decode(self.vae_params, self.vae_cfg, lat)
            video = (video * 0.5 + 0.5).clamp(0, 1).permute(0, 1, 4, 2, 3)
            clock.lap("vae_ms")
        if profile:
            self.profile_ms = clock.lap_report()
        if return_latents:
            return video, latents
        return video
