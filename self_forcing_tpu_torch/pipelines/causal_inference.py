"""Chunk-wise autoregressive few-step inference (port of
``self_forcing_tpu/pipelines/causal_inference.py``).

Per block of ``num_frame_per_block`` latent frames: ``denoise_block`` runs
the 4 denoising DiT forwards (``write_cache=False``), then
``refresh_block`` runs one forward at ``context_noise`` that writes the
block's K/V into the cache.  The block loop is a plain Python loop (the
JAX package scans it inside one jit).  The noise of each re-noising step
comes from a ``torch.Generator`` or is injected as ``eps``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.scheduler import (FlowMatchScheduler,
                                              warp_denoising_steps)


def denoise_block(params, cfg: WanConfig, scheduler: FlowMatchScheduler,
                  rope: RopeTables, ctx_kv: dict, cache: dit.KVCache,
                  noise_blk: torch.Tensor, steps: Sequence[float],
                  start_frame: int, static_kv_hi: int | None = None,
                  eps: Sequence[torch.Tensor] | None = None,
                  generator: torch.Generator | None = None):
    """One block's few-step denoise without the cache refresh.

    ``eps``: the len(steps) - 1 re-noising draws, each shaped like
    ``noise_blk``; drawn from ``generator`` when not given.
    Returns (x0 [B, nb, C, H, W], cache)."""
    B, nb, C, H, W = noise_blk.shape
    noisy = x0 = noise_blk
    for i, t_val in enumerate(steps):
        t = torch.full((B, nb), t_val, dtype=torch.float32,
                       device=noise_blk.device)
        flow, cache = dit.forward_inference(
            params, cfg, noisy, t, ctx_kv, cache, start_frame, rope,
            static_kv_hi=static_kv_hi, write_cache=False)
        x0 = scheduler.convert_flow_pred_to_x0(
            flow.reshape(B * nb, C, H, W), noisy.reshape(B * nb, C, H, W),
            t.reshape(-1)).reshape(B, nb, C, H, W)
        if i < len(steps) - 1:
            if eps is not None:
                e = eps[i].to(x0.dtype)
            else:
                e = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=torch.float32
                                ).to(x0.dtype)
            t_next = torch.full((B * nb,), steps[i + 1],
                                dtype=torch.float32, device=x0.device)
            noisy = scheduler.add_noise(
                x0.reshape(B * nb, C, H, W), e.reshape(B * nb, C, H, W),
                t_next).reshape(B, nb, C, H, W)
    return x0, cache


def refresh_block(params, cfg: WanConfig, rope: RopeTables, ctx_kv: dict,
                  cache: dit.KVCache, x0: torch.Tensor,
                  context_noise: float, start_frame: int,
                  static_kv_hi: int | None = None) -> dit.KVCache:
    """Re-run the denoised block, clean, at timestep ``context_noise`` to
    write its K/V into the cache."""
    B, nb = x0.shape[:2]
    t_ctx = torch.full((B, nb), float(context_noise), dtype=torch.float32,
                       device=x0.device)
    _, cache = dit.forward_inference(params, cfg, x0, t_ctx, ctx_kv, cache,
                                     start_frame, rope,
                                     static_kv_hi=static_kv_hi)
    return cache


class CausalInferencePipeline:
    """Few-step chunk-wise AR sampler.  ``args`` holds the config keys
    denoising_step_list, warp_denoising_step, timestep_shift,
    num_frame_per_block, independent_first_frame and context_noise."""

    def __init__(self, args, generator_params, model_cfg: WanConfig,
                 vae_params=None, vae_cfg: vae_mod.VAEConfig = vae_mod.WAN_VAE,
                 scheduler: FlowMatchScheduler | None = None,
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
        if self.cfg.independent_first_frame:
            raise NotImplementedError(
                "independent_first_frame is not ported yet")
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        shift = float(getattr(args, "timestep_shift", 8.0))
        self.scheduler = scheduler or FlowMatchScheduler.create(
            1000, shift=shift, training=True, device=self.device)
        self.rope = RopeTables.create(self.cfg.head_dim, device=self.device)
        steps = [float(s) for s in args.denoising_step_list]
        if getattr(args, "warp_denoising_step", False):
            steps = [float(s) for s in warp_denoising_steps(
                self.scheduler, [int(s) for s in args.denoising_step_list])]
        self.denoising_step_list = tuple(steps)
        self.context_noise = float(getattr(args, "context_noise", 0))
        self.num_frame_per_block = self.cfg.num_frame_per_block
        self._cache: dit.KVCache | None = None
        self._cache_sig = None

    def _init_cache(self, batch: int, fs: int,
                    num_frames: int) -> dit.KVCache:
        """Reuse the previous call's cache when the geometry matches (only
        the indices are reset: stale rows are never visible)."""
        sig = (batch, fs, num_frames)
        if self._cache is not None and self._cache_sig == sig:
            return dit.reset_kv_cache(self._cache)
        self._cache = None  # free the old buffers before allocating
        self._cache_sig = sig
        self._cache = dit.init_kv_cache(self.cfg, batch, fs, num_frames,
                                        self.dtype, self.device)
        return self._cache

    def _blocks(self, F: int):
        nb = self.num_frame_per_block
        if F % nb:
            raise ValueError(f"{F} latent frames are not a whole number of "
                             f"{nb}-frame blocks")
        return [(b * nb, nb) for b in range(F // nb)]

    def stream(self, noise: torch.Tensor, context: torch.Tensor,
               eps: Optional[Sequence[Sequence[torch.Tensor]]] = None,
               generator: torch.Generator | None = None
               ) -> Iterator[torch.Tensor]:
        """Yield denoised latent blocks [B, nb, C, H, W] one at a time, each
        before its cache refresh (the refresh is skipped after the last
        block).  ``eps[b]`` are block b's re-noising draws."""
        B, F, C, H, W = noise.shape
        fs = (H // self.cfg.patch_size[1]) * (W // self.cfg.patch_size[2])
        ctx_kv = dit.precompute_context(self.params, self.cfg, context)
        cache = self._init_cache(B, fs, max(F, 21))
        blocks = self._blocks(F)
        for i, (lo, n) in enumerate(blocks):
            hint = lo * fs   # tokens already cached: the live window
            blk, cache = denoise_block(
                self.params, self.cfg, self.scheduler, self.rope, ctx_kv,
                cache, noise[:, lo:lo + n], self.denoising_step_list, lo,
                static_kv_hi=hint, eps=None if eps is None else eps[i],
                generator=generator)
            yield blk
            if i < len(blocks) - 1:
                cache = refresh_block(self.params, self.cfg, self.rope,
                                      ctx_kv, cache, blk,
                                      self.context_noise, lo,
                                      static_kv_hi=hint)
        self._cache = cache

    def inference(self, noise: torch.Tensor, context: torch.Tensor,
                  return_latents: bool = False,
                  eps: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                  generator: torch.Generator | None = None):
        """noise [B, F, C, H, W] -> video [B, F_pix, 3, H*8, W*8] in [0, 1]
        (None without VAE parameters).  Every block, the last included, is
        refreshed into the cache."""
        B, F, C, H, W = noise.shape
        fs = (H // self.cfg.patch_size[1]) * (W // self.cfg.patch_size[2])
        ctx_kv = dit.precompute_context(self.params, self.cfg, context)
        cache = self._init_cache(B, fs, max(F, 21))
        outs = []
        for i, (lo, n) in enumerate(self._blocks(F)):
            blk, cache = denoise_block(
                self.params, self.cfg, self.scheduler, self.rope, ctx_kv,
                cache, noise[:, lo:lo + n], self.denoising_step_list, lo,
                static_kv_hi=lo * fs, eps=None if eps is None else eps[i],
                generator=generator)
            cache = refresh_block(self.params, self.cfg, self.rope, ctx_kv,
                                  cache, blk, self.context_noise, lo,
                                  static_kv_hi=lo * fs)
            outs.append(blk)
        self._cache = cache
        latents = torch.cat(outs, dim=1)
        video = None
        if self.vae_params is not None:
            lat = latents.permute(0, 1, 3, 4, 2)
            video = vae_mod.decode(self.vae_params, self.vae_cfg, lat)
            video = (video * 0.5 + 0.5).clamp(0, 1).permute(0, 1, 4, 2, 3)
        if return_latents:
            return video, latents
        return video
