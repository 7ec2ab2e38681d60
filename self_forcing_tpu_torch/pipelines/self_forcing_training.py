"""Training-time autoregressive rollout with gradient, the heart of
Self-Forcing (port of ``self_forcing_tpu/pipelines/self_forcing_training.py``).

Per block of ``num_frame_per_block`` frames the generator denoises
through steps[0..exit] with its KV-cached forward and then refreshes the
cache with the denoised block re-noised at ``context_noise``.  Only the
exit-step forward of each block in the last 21 frames carries a gradient;
the other forwards run under ``torch.no_grad()`` (the JAX package's
``stop_gradient``).  The exit forward is rematerialised twice, as in the
JAX package: the whole forward is checkpointed and, inside, every layer.

The cache is written in place by each refresh, while the exit forwards of
earlier blocks still have to be replayed in the backward.  A block reads
only rows [attn_lo, write_at) and later blocks write only at or past
that, so the replay reads what the forward read (the decode attention's
backward checks the window's edge rows, ``ops/attention.py``).

The i2v / pose conditioning (``y`` [B, F, Cy, H, W], ``add_condition``
[B, F*frame_seqlen, 5120]) covers the generated frames; each block's
forwards take its slice, detached wherever the forward runs without
gradient.

Randomness: the re-noising draws come from a ``torch.Generator``, or are
injected per block as ``eps[b] = (denoise_draws, refresh_draw)``, where
``denoise_draws`` holds the exit's draws (one per step before it).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.ops import attention as attn_ops
from self_forcing_tpu_torch.pipelines.causal_inference import prime_block
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler


def _draw(shape, like: torch.Tensor, generator: torch.Generator | None,
          given: torch.Tensor | None) -> torch.Tensor:
    if given is not None:
        return given.to(device=like.device, dtype=like.dtype)
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=torch.float32).to(like.dtype)


def _exit_forward(params, cfg: WanConfig, noisy, t, ctx_kv, cache,
                  start_frame: int, rope, kernels: bool, y_blk=None,
                  cond_blk=None):
    """The with-grad exit-step forward, checkpointed as a whole (and per
    layer inside): the backward replays it from (params, noisy) and the
    cache."""
    def fwd(p, nz):
        flow, _ = dit.forward_inference(p, cfg, nz, t, ctx_kv, cache,
                                        start_frame, rope, write_cache=False,
                                        remat=True, kernels=kernels,
                                        y=y_blk, add_condition=cond_blk)
        return flow
    return checkpoint(fwd, params, noisy, use_reentrant=False)


def _denoise_to_exit(params, cfg: WanConfig, scheduler: FlowMatchScheduler,
                     rope: RopeTables, ctx_kv: dict, cache: dit.KVCache,
                     noise_blk: torch.Tensor, steps: Sequence[float],
                     exit_idx: int, with_grad: bool, start_frame: int,
                     eps: Sequence[torch.Tensor] | None,
                     generator: torch.Generator | None, kernels: bool,
                     y_blk=None, cond_blk=None):
    """Denoise one block through steps[0..exit_idx]; only the exit-step
    forward carries gradient (iff ``with_grad``).  The cache is read only.
    ``y_blk`` / ``cond_blk``: this block's conditioning.  Returns x0
    [B, nb, C, H, W]."""
    B, nb, C, H, W = noise_blk.shape
    noisy = x0 = noise_blk
    for i in range(exit_idx + 1):
        t = torch.full((B, nb), float(steps[i]), dtype=torch.float32,
                       device=noise_blk.device)
        if i == exit_idx and with_grad:
            flow = _exit_forward(params, cfg, noisy, t, ctx_kv, cache,
                                 start_frame, rope, kernels, y_blk, cond_blk)
        else:
            with torch.no_grad():
                flow, _ = dit.forward_inference(
                    params, cfg, noisy, t, ctx_kv, cache, start_frame, rope,
                    write_cache=False, kernels=kernels, y=y_blk,
                    add_condition=cond_blk)
        x0 = scheduler.convert_flow_pred_to_x0(
            flow.reshape(B * nb, C, H, W), noisy.reshape(B * nb, C, H, W),
            t.reshape(-1)).reshape(B, nb, C, H, W)
        if i < exit_idx:
            with torch.no_grad():
                e = _draw(x0.shape, x0, generator,
                          None if eps is None else eps[i])
                t_next = torch.full((B * nb,), float(steps[i + 1]),
                                    dtype=torch.float32, device=x0.device)
                noisy = scheduler.add_noise(
                    x0.reshape(B * nb, C, H, W), e.reshape(B * nb, C, H, W),
                    t_next).reshape(B, nb, C, H, W)
    return x0


def _rollout_blocks(params, cfg: WanConfig, scheduler: FlowMatchScheduler,
                    rope: RopeTables, ctx_kv: dict, cache: dit.KVCache,
                    noise: torch.Tensor, steps: Sequence[float], exits,
                    context_noise: float, with_grad: bool, start_frame0: int,
                    eps, generator, kernels: bool, y=None,
                    add_condition=None):
    """Blocks of ``noise`` one after another, each denoised to its exit
    (``exits[b]``) and then refreshed into the cache without gradient;
    ``y`` / ``add_condition`` cover these blocks and are sliced a block.
    Returns (frames [B, F, C, H, W], cache)."""
    B, F, C, H, W = noise.shape
    nb = F // len(exits)
    lb = None if add_condition is None \
        else add_condition.shape[1] // len(exits)
    outs = []
    for blk, exit_idx in enumerate(exits):
        start = start_frame0 + blk * nb
        draws = None if eps is None else eps[blk]
        y_blk = None if y is None else y[:, blk * nb:(blk + 1) * nb]
        cond_blk = None if add_condition is None \
            else add_condition[:, blk * lb:(blk + 1) * lb]
        x0 = _denoise_to_exit(params, cfg, scheduler, rope, ctx_kv, cache,
                              noise[:, blk * nb:(blk + 1) * nb], steps,
                              int(exit_idx), with_grad, start,
                              None if draws is None else draws[0],
                              generator, kernels, y_blk, cond_blk)
        with torch.no_grad():
            e = _draw(x0.shape, x0, generator,
                      None if draws is None else draws[1])
            t_ctx = torch.full((B * nb,), context_noise, dtype=torch.float32,
                               device=x0.device)
            renoised = scheduler.add_noise(
                x0.detach().reshape(B * nb, C, H, W),
                e.reshape(B * nb, C, H, W), t_ctx).reshape(B, nb, C, H, W)
            _, cache = dit.forward_inference(
                params, cfg, renoised,
                torch.full((B, nb), context_noise, dtype=torch.float32,
                           device=x0.device),
                ctx_kv, cache, start, rope, kernels=kernels, y=y_blk,
                add_condition=cond_blk)
        outs.append(x0)
    return torch.cat(outs, dim=1), cache


class SelfForcingTrainingPipeline:
    """The training rollout: ``denoising_step_list`` drops a trailing 0
    step; ``same_step_across_blocks`` / ``last_step_only`` choose the
    exits; the KV cache holds ``num_max_frames`` frames."""

    def __init__(self, denoising_step_list, scheduler: FlowMatchScheduler,
                 num_frame_per_block: int = 3,
                 independent_first_frame: bool = False,
                 same_step_across_blocks: bool = True,
                 last_step_only: bool = False,
                 num_max_frames: int = 21,
                 context_noise: float = 0.0,
                 frame_seqlen: int = 1560):
        steps = [float(s) for s in denoising_step_list]
        if steps and steps[-1] == 0:
            steps = steps[:-1]
        self.denoising_step_list = tuple(steps)
        self.scheduler = scheduler
        self.num_frame_per_block = num_frame_per_block
        self.independent_first_frame = independent_first_frame
        self.same_step_across_blocks = same_step_across_blocks
        self.last_step_only = last_step_only
        self.num_max_frames = num_max_frames
        self.context_noise = float(context_noise)
        self.frame_seqlen = frame_seqlen

    def sample_exit_index(self, rng: np.random.Generator,
                          num_blocks: int | None = None):
        """Host-side draw of the exit step(s): an int when
        same_step_across_blocks, else an int32 array of per-block exits
        (pass ``num_blocks``)."""
        n = len(self.denoising_step_list)
        if self.last_step_only:
            return n - 1
        if self.same_step_across_blocks or num_blocks is None:
            return int(rng.integers(0, n))
        return np.asarray(rng.integers(0, n, size=num_blocks), np.int32)

    def denoised_timestep_bounds(self, exit_idx: int):
        """(from, to) of the exit step, for the timestep schedule."""
        timesteps = self.scheduler.timesteps.cpu().numpy()
        steps = self.denoising_step_list

        def t_of(step_val):
            return 1000 - int(np.argmin(np.abs(timesteps - step_val)))

        if exit_idx == len(steps) - 1:
            return t_of(steps[exit_idx]), 0
        return t_of(steps[exit_idx]), t_of(steps[exit_idx + 1])

    def inference_with_trajectory(self, params, cfg: WanConfig,
                                  rope: RopeTables, noise: torch.Tensor,
                                  ctx_kv: dict, exit_idx,
                                  generator: torch.Generator | None = None,
                                  eps: Optional[Sequence] = None,
                                  initial_latent: torch.Tensor | None = None,
                                  kernels: bool = True,
                                  y: torch.Tensor | None = None,
                                  add_condition: torch.Tensor | None = None):
        """Returns (trajectory [B, F_out, C, H, W], denoised_timestep_from,
        denoised_timestep_to).  Gradient flows (when grad mode is on) only
        through the exit-step forwards of the blocks in the final 21
        frames.  ``exit_idx``: an int shared by every block or one exit a
        block.  ``eps[b]``: block b's (denoise_draws, refresh_draw).
        ``y`` [B, F, Cy, H, W] and ``add_condition`` [B, F*fs, 5120]
        cover the noise frames; gradient reaches them only through the
        exit forwards of the grad suffix."""
        B, F, C, H, W = noise.shape
        nb = self.num_frame_per_block
        if F % nb:
            raise ValueError(f"{F} frames are not whole {nb}-frame blocks")
        num_blocks = F // nb
        fs = (H // cfg.patch_size[1]) * (W // cfg.patch_size[2])
        num_input = initial_latent.shape[1] if initial_latent is not None \
            else 0
        # the decode kernels read a bf16 cache (they round float32 q / k /
        # v to bf16 at their inputs); off the kernel route the cache
        # keeps the parameters' dtype, as the JAX package's does
        cache_dtype = (torch.bfloat16 if attn_ops._kernel_route(noise)
                       else dit._param_dtype(params))
        cache = dit.init_kv_cache(cfg, B, fs, self.num_max_frames,
                                  cache_dtype, noise.device)
        per_block = not isinstance(exit_idx, int)
        exits = ([int(e) for e in exit_idx] if per_block
                 else [exit_idx] * num_blocks)

        start = 0
        outputs = []
        if initial_latent is not None:
            outputs.append(initial_latent.detach())
            with torch.no_grad():
                cache = prime_block(params, cfg, rope, ctx_kv, cache,
                                    initial_latent, start)
            start += num_input

        # blocks before the last 21 frames run without gradient
        start_gradient_frame = F + num_input - 21
        grad_start_block = max(
            0, -(-max(0, start_gradient_frame - num_input) // nb))
        split = grad_start_block * nb

        def cut(a, lo, hi):
            return None if a is None else a[:, lo:hi]
        steps, cn = self.denoising_step_list, self.context_noise
        if grad_start_block > 0:
            with torch.no_grad():
                pre, cache = _rollout_blocks(
                    params, cfg, self.scheduler, rope, ctx_kv, cache,
                    noise[:, :split], steps, exits[:grad_start_block], cn,
                    False, start, None if eps is None
                    else eps[:grad_start_block], generator, kernels,
                    cut(y, 0, split), cut(add_condition, 0, split * fs))
            outputs.append(pre)
            start += split
        post, cache = _rollout_blocks(
            params, cfg, self.scheduler, rope, ctx_kv, cache,
            noise[:, split:], steps, exits[grad_start_block:], cn,
            torch.is_grad_enabled(), start,
            None if eps is None else eps[grad_start_block:], generator,
            kernels, cut(y, split, None), cut(add_condition, split * fs,
                                                None))
        outputs.append(post)
        trajectory = torch.cat(outputs, dim=1)
        if self.same_step_across_blocks and not per_block:
            return (trajectory, *self.denoised_timestep_bounds(exit_idx))
        return trajectory, None, None
