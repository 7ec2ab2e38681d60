"""Generate ODE-regression training pairs with the bidirectional teacher
(port of ``scripts/generate_ode_pairs.py``).

    python -m self_forcing_tpu_torch.scripts.generate_ode_pairs \\
        --output_folder PAIRS --caption_path prompts.txt --model_dir CKPTS \\
        [--guidance_scale 6.0] [--num_steps 48] [--device cuda]

``--num_steps`` CFG x0 steps a prompt (two forwards each), snapshotting
the trajectory at ``--snapshots`` (default [0, 12, 24, 36, final]); one
``.npz`` a prompt: {prompt, latents [1, S, 21, 16, H, W] fp16}.  One
process takes every prompt (the JAX script splits them over its
processes); a prompt's starting noise comes from a ``torch.Generator``
seeded with ``seed + prompt index``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from self_forcing_tpu_torch.data.datasets import TextDataset
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler


@torch.no_grad()
def cfg_x0_step(params, cfg, rope: RopeTables,
                scheduler: FlowMatchScheduler, latents: torch.Tensor,
                t_val: float, ctx: torch.Tensor, neg_ctx: torch.Tensor,
                guidance_scale: float) -> torch.Tensor:
    """One sampler step of the bidirectional teacher: x0 of the
    conditional and unconditional forwards combined with CFG, back to a
    flow, then the scheduler's Euler step."""
    B, F = latents.shape[:2]
    t = torch.full((B, F), float(t_val), dtype=torch.float32,
                   device=latents.device)

    def flat(a):
        return a.reshape((B * F,) + tuple(a.shape[2:]))

    def x0(context):
        flow = dit.forward_train(params, cfg, latents, t, context, None,
                                 rope, remat=False)
        return scheduler.convert_flow_pred_to_x0(flat(flow), flat(latents),
                                                 t.reshape(-1))
    x0_c, x0_u = x0(ctx), x0(neg_ctx)
    x0_cfg = x0_u + guidance_scale * (x0_c - x0_u)
    flow = scheduler.convert_x0_to_flow_pred(x0_cfg, flat(latents),
                                             t.reshape(-1))
    out = scheduler.step(flow, t.reshape(-1), flat(latents))
    return out.reshape(latents.shape)


def generate_pairs(params, cfg, encode_text, prompts, output_folder: str,
                   negative_prompt: str, guidance_scale: float = 6.0,
                   num_steps: int = 48, snapshots=(0, 12, 24, 36, -1),
                   latent_shape=(1, 21, 16, 60, 104), seed: int = 0,
                   device: str | torch.device = "cuda") -> list[float]:
    """Sample each prompt's trajectory and save its snapshots; returns the
    milliseconds of each prompt (host clock, synchronised)."""
    device = torch.device(device)
    rope = RopeTables.create(cfg.head_dim, device=device)
    scheduler = FlowMatchScheduler.create(num_steps, shift=8.0,
                                          extra_one_step=True, device=device)
    timesteps = scheduler.timesteps.cpu().numpy()
    neg = encode_text([negative_prompt])
    os.makedirs(output_folder, exist_ok=True)
    times = []
    for index, prompt in enumerate(prompts):
        t0 = time.perf_counter()
        ctx = encode_text([prompt])
        g = torch.Generator(device=device).manual_seed(seed + index)
        latents = torch.randn(tuple(latent_shape), generator=g,
                              device=device)
        trajectory = []
        for t_val in timesteps:
            trajectory.append(latents.half().cpu().numpy())
            latents = cfg_x0_step(params, cfg, rope, scheduler, latents,
                                  float(t_val), ctx, neg, guidance_scale)
        trajectory.append(latents.half().cpu().numpy())
        snaps = np.stack([trajectory[i] for i in snapshots], axis=1)
        np.savez(os.path.join(output_folder, f"{index:05d}.npz"),
                 prompt=prompt, latents=snaps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        print(f"saved {index:05d} ({prompt[:40]}...)", flush=True)
    return times


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--caption_path", required=True)
    ap.add_argument("--guidance_scale", type=float, default=6.0)
    ap.add_argument("--model_dir", default="wan_models")
    ap.add_argument("--num_steps", type=int, default=48)
    ap.add_argument("--snapshots", type=int, nargs="+",
                    default=[0, 12, 24, 36, -1])
    ap.add_argument("--latent_shape", type=int, nargs=5,
                    default=[1, 21, 16, 60, 104])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from self_forcing_tpu_torch.runtime import load_wan_models
    models = load_wan_models(args.model_dir, load_vae=False,
                             device=args.device)
    return generate_pairs(models.generator, models.generator_cfg,
                          models.encode_text,
                          TextDataset(args.caption_path).prompt_list,
                          args.output_folder,
                          models.negative_prompt, args.guidance_scale,
                          args.num_steps, args.snapshots, args.latent_shape,
                          args.seed, args.device)


if __name__ == "__main__":
    main()
