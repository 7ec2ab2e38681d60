"""Few-step bidirectional sampler (port of
``self_forcing_tpu/pipelines/bidirectional_inference.py``): the
full-attention model denoises the whole video at each step of
``denoising_step_list``, re-noising the prediction between steps.  The
re-noising draws come from a ``torch.Generator`` or are injected as
``eps`` (the JAX package draws them inside its jit)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.scheduler import (FlowMatchScheduler,
                                              warp_denoising_steps)


def sample_few_step(params, cfg: WanConfig, scheduler: FlowMatchScheduler,
                    rope: RopeTables, noise: torch.Tensor,
                    context: torch.Tensor, steps: Sequence[float],
                    eps: Sequence[torch.Tensor] | None = None,
                    generator: torch.Generator | None = None,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """noise [B, F, C, H, W] -> x0 [B, F, C, H, W] in the noise's dtype;
    the DiT sees the sample in ``dtype`` (default the noise's).  ``eps``:
    the len(steps) - 1 re-noising draws, each shaped like the noise."""
    B, F, C, H, W = noise.shape
    dtype = noise.dtype if dtype is None else dtype
    noisy = x0 = noise
    for i, t_val in enumerate(steps):
        t = torch.full((B, F), t_val, dtype=torch.float32,
                       device=noise.device)
        flow = dit.forward_train(params, cfg, noisy.to(dtype), t, context,
                                 None, rope, remat=False)
        x0 = scheduler.convert_flow_pred_to_x0(
            flow.to(noise.dtype).reshape(B * F, C, H, W),
            noisy.reshape(B * F, C, H, W), t.reshape(-1)
        ).reshape(B, F, C, H, W)
        if i < len(steps) - 1:
            if eps is not None:
                e = eps[i].to(x0.device, x0.dtype)
            else:
                e = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=torch.float32
                                ).to(x0.dtype)
            t_next = torch.full((B * F,), steps[i + 1], dtype=torch.float32,
                                device=x0.device)
            noisy = scheduler.add_noise(
                x0.reshape(B * F, C, H, W), e.reshape(B * F, C, H, W),
                t_next).reshape(B, F, C, H, W)
    return x0


class BidirectionalInferencePipeline:
    """``args`` holds denoising_step_list, warp_denoising_step and
    timestep_shift (8.0)."""

    def __init__(self, args, generator_params, model_cfg: WanConfig,
                 scheduler: FlowMatchScheduler | None = None,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
        self.args = args
        self.params = generator_params
        self.cfg = model_cfg
        self.device = torch.device(device)
        self.dtype = dtype
        shift = float(getattr(args, "timestep_shift", 8.0))
        self.scheduler = scheduler or FlowMatchScheduler.create(
            1000, shift=shift, training=True, device=self.device)
        steps = [float(s) for s in args.denoising_step_list]
        if getattr(args, "warp_denoising_step", False):
            steps = [float(s) for s in warp_denoising_steps(
                self.scheduler, [int(s) for s in args.denoising_step_list])]
        self.denoising_step_list = tuple(steps)
        self.rope = RopeTables.create(model_cfg.head_dim, device=self.device)

    def inference(self, noise: torch.Tensor, context: torch.Tensor,
                  eps: Optional[Sequence[torch.Tensor]] = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
        return sample_few_step(self.params, self.cfg, self.scheduler,
                               self.rope, noise,
                               context.to(self.device, self.dtype),
                               self.denoising_step_list, eps=eps,
                               generator=generator, dtype=self.dtype)
