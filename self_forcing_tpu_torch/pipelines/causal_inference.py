"""Chunk-wise autoregressive few-step inference (port of
``self_forcing_tpu/pipelines/causal_inference.py``).

Per block of ``num_frame_per_block`` latent frames: ``denoise_block`` runs
the 4 denoising DiT forwards (``write_cache=False``), then
``refresh_block`` runs one forward at ``context_noise`` that writes the
block's K/V into the cache.  The block loop is a plain Python loop (the
JAX package scans it inside one jit).  The noise of each re-noising step
comes from a ``torch.Generator`` or is injected as ``eps``.  With a
windowed config ``stream`` tracks the buffer's fill on the host and
compacts it exactly before the block that would overflow it;
``inference`` sizes the buffer to the window and lets each forward
compact.
"""
from __future__ import annotations

import dataclasses
import time
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
                  generator: torch.Generator | None = None,
                  assume_compacted: bool = True):
    """One block's few-step denoise without the cache refresh.

    ``eps``: the len(steps) - 1 re-noising draws, each shaped like
    ``noise_blk``; drawn from ``generator`` when not given.
    ``assume_compacted``: the caller compacted a windowed buffer for this
    block (False: the first forward compacts it if the block would
    overflow it).
    Returns (x0 [B, nb, C, H, W], cache)."""
    B, nb, C, H, W = noise_blk.shape
    noisy = x0 = noise_blk
    for i, t_val in enumerate(steps):
        t = torch.full((B, nb), t_val, dtype=torch.float32,
                       device=noise_blk.device)
        flow, cache = dit.forward_inference(
            params, cfg, noisy, t, ctx_kv, cache, start_frame, rope,
            static_kv_hi=static_kv_hi, write_cache=False,
            assume_compacted=assume_compacted)
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
                  static_kv_hi: int | None = None,
                  assume_compacted: bool = True) -> dit.KVCache:
    """Re-run the denoised block, clean, at timestep ``context_noise`` to
    write its K/V into the cache (the denoise made room for it)."""
    B, nb = x0.shape[:2]
    t_ctx = torch.full((B, nb), float(context_noise), dtype=torch.float32,
                       device=x0.device)
    _, cache = dit.forward_inference(params, cfg, x0, t_ctx, ctx_kv, cache,
                                     start_frame, rope,
                                     static_kv_hi=static_kv_hi,
                                     assume_compacted=assume_compacted)
    return cache


def prime_block(params, cfg: WanConfig, rope: RopeTables, ctx_kv: dict,
                cache: dit.KVCache, latents: torch.Tensor,
                start_frame: int) -> dit.KVCache:
    """Write clean context latents [B, F, C, H, W] into the KV cache at
    timestep 0 (image-to-video / video-extension priming)."""
    B, Fb = latents.shape[:2]
    t = torch.zeros((B, Fb), dtype=torch.float32, device=latents.device)
    _, cache = dit.forward_inference(params, cfg, latents, t, ctx_kv, cache,
                                     start_frame, rope)
    return cache


class _PhaseClock:
    """Host-clock ms of consecutive phases, each ended by a device
    synchronise; does nothing when off."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on, self.ms = device, on, {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.on:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            self.ms[name] = (now - self._t) * 1e3
            self._t = now

    def report(self) -> dict:
        self.ms["total_ms"] = sum(self.ms.values())
        print("Profiling results: " + ", ".join(
            f"{k} {v:.2f}" for k, v in self.ms.items()), flush=True)
        return dict(self.ms)


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
        self.compactions = 0  # windowed buffer compactions of the last stream
        self.profile_ms: dict = {}  # the last inference(profile=True)

    def _init_cache(self, batch: int, fs: int, num_frames: int,
                    slack: bool = True) -> dit.KVCache:
        """Reuse the previous call's cache when the geometry matches (only
        the indices are reset).  ``slack=False`` (``inference``, which
        compacts inside the forwards): a windowed buffer is sized to the
        window even where the config asks for a larger one, as in the JAX
        package."""
        cfg = self.cfg
        if not slack and cfg.local_attn_size != -1:
            cfg = dataclasses.replace(cfg, windowed_buffer_frames=None)
        sig = (batch, fs, num_frames, self.dtype,
               -1 if cfg.local_attn_size == -1 else cfg.buffer_frames)
        if self._cache is not None and self._cache_sig == sig:
            return dit.reset_kv_cache(self._cache)
        self._cache = None  # free the old buffers before allocating
        self._cache_sig = sig
        self._cache = dit.init_kv_cache(cfg, batch, fs, num_frames,
                                        self.dtype, self.device)
        return self._cache

    def _blocks(self, F: int, first: int = 0):
        """(first frame, frames) of each generated block of frames
        ``[first, first + F)``: a 1-frame block first for an
        independent-first-frame model when ``first == 0``, then blocks of
        num_frame_per_block."""
        nb = self.num_frame_per_block
        lead = [(0, 1)] if self.cfg.independent_first_frame and first == 0 \
            else []
        lo = first + len(lead)
        if (F - len(lead)) % nb:
            raise ValueError(f"{F - len(lead)} latent frames are not a whole "
                             f"number of {nb}-frame blocks")
        return lead + [(lo + b * nb, nb) for b in range((F - len(lead)) // nb)]

    def stream(self, noise: torch.Tensor, context: torch.Tensor,
               eps: Optional[Sequence[Sequence[torch.Tensor]]] = None,
               generator: torch.Generator | None = None
               ) -> Iterator[torch.Tensor]:
        """Yield denoised latent blocks [B, n, C, H, W] one at a time, each
        before its cache refresh (the refresh is skipped after the last
        block).  ``eps[b]`` are block b's re-noising draws.  A windowed
        buffer is compacted exactly when the next block would overflow
        it."""
        B, F, C, H, W = noise.shape
        fs = (H // self.cfg.patch_size[1]) * (W // self.cfg.patch_size[2])
        ctx_kv = dit.precompute_context(self.params, self.cfg, context)
        cache = self._init_cache(B, fs, max(F, 21))
        blocks = self._blocks(F)
        windowed = self.cfg.local_attn_size != -1
        content = 0  # tokens in the windowed buffer
        self.compactions = 0
        for i, (lo, n) in enumerate(blocks):
            # tokens already cached: the live window (global cache only)
            hint = None if windowed else lo * fs
            if windowed:
                buf_tok, post = dit.windowed_compaction_schedule(
                    self.cfg, fs, n * fs)
                if content + n * fs > buf_tok:
                    cache = dit.compact_cache(self.cfg, cache, n * fs)
                    self.compactions += 1
                    content = post
                content += n * fs
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
                  initial_latent: torch.Tensor | None = None,
                  return_latents: bool = False,
                  eps: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                  generator: torch.Generator | None = None,
                  profile: bool = False):
        """noise [B, F, C, H, W] -> video [B, F_pix, 3, H*8, W*8] in [0, 1]
        (None without VAE parameters).  ``initial_latent`` [B, F0, C, H,
        W]: clean context frames primed into the cache first (timestep 0)
        and put in front of the output.  Every generated block, the last
        included, is refreshed into the cache.  The latents reach the VAE
        in the wider of their dtype and the VAE's, as ``jnp`` promotes
        them.  ``profile=True`` synchronises the device at the ends of the
        set-up (context K/V, cache, priming), the generation and the
        decode, prints each one's host-clock ms and keeps them in
        ``self.profile_ms``."""
        clock = _PhaseClock(noise.device, profile)
        B, F, C, H, W = noise.shape
        fs = (H // self.cfg.patch_size[1]) * (W // self.cfg.patch_size[2])
        ctx_kv = dit.precompute_context(self.params, self.cfg, context)
        F0 = 0 if initial_latent is None else initial_latent.shape[1]
        cache = self._init_cache(B, fs, max(F + F0, 21), slack=False)
        outs = []
        if initial_latent is not None:
            outs.append(initial_latent)
            for lo, n in self._blocks(F0):
                cache = prime_block(self.params, self.cfg, self.rope, ctx_kv,
                                    cache, initial_latent[:, lo:lo + n], lo)
        clock.lap("init_ms")
        windowed = self.cfg.local_attn_size != -1
        for i, (lo, n) in enumerate(self._blocks(F, first=F0)):
            hint = None if windowed else lo * fs
            blk, cache = denoise_block(
                self.params, self.cfg, self.scheduler, self.rope, ctx_kv,
                cache, noise[:, lo - F0:lo - F0 + n],
                self.denoising_step_list, lo, static_kv_hi=hint,
                eps=None if eps is None else eps[i], generator=generator,
                assume_compacted=False)
            cache = refresh_block(self.params, self.cfg, self.rope, ctx_kv,
                                  cache, blk, self.context_noise, lo,
                                  static_kv_hi=hint, assume_compacted=False)
            outs.append(blk)
        self._cache = cache
        latents = torch.cat(outs, dim=1)
        clock.lap("diffusion_ms")
        video = None
        if self.vae_params is not None:
            vdt = self.vae_params["conv2"]["w"].dtype
            lat = latents.permute(0, 1, 3, 4, 2)
            lat = lat.to(torch.promote_types(lat.dtype, vdt))
            video = vae_mod.decode(self.vae_params, self.vae_cfg, lat)
            video = (video * 0.5 + 0.5).clamp(0, 1).permute(0, 1, 4, 2, 3)
            clock.lap("vae_ms")
        if profile:
            self.profile_ms = clock.report()
        if return_latents:
            return video, latents
        return video
