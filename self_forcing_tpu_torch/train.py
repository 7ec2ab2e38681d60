"""Training entry point of the PyTorch package (port of ``train.py``).

    python -m self_forcing_tpu_torch.train --config_path configs/self_forcing_dmd.yaml \\
        --max_steps N [--logdir logs/run] [--no_save] [--no_visualize] [--device cuda]

The config is merged over ``default_config.yaml`` beside it, and its
``trainer`` picks the trainer: ``score_distillation`` (DMD or SiD, by
``distribution_loss``), ``gan``, ``ode`` or ``diffusion``.  The models
load from ``model_dir`` where it exists (``runtime.load_dit_params``; the
tiny size always draws), else start from random weights drawn from the
config's seed, at the config's ``model_size``.  Text contexts come from
the T5 encoder where ``model_dir`` holds it, else they are
pseudo-embeddings, ``randn(512, text_dim)`` from a ``torch.Generator``
seeded by the prompt's crc32.

The data (:func:`data_batches`): the ODE trainer reads the record shard
at ``data_path`` (it raises without one), the diffusion and GAN trainers
a directory of shards there (without one they train on stand-in latents
drawn from the seed), pose distillation (``use_pose_conditioning``) a
directory of pose shards there (``PoseShardingDataset``: each row's
``dwpose_data``, ``random_ref_dwpose`` and ``first_frame`` reach the
trainer's conditioner), and otherwise ``data_path`` is a prompt file, or
the prompts are placeholders.  Pose distillation also loads the VAE and
CLIP of ``model_dir`` (``load_wan_models(load_t5=False,
load_dit=False)``, ``load_clip_vision``); without them the first-frame
image conditioning raises and rollouts past 21 frames cannot trim.
Metrics go to ``<logdir>/metrics.jsonl``; checkpoints (``torch.save``)
every ``log_iters`` steps and at the end unless ``--no_save``.
``--no_visualize`` drops the ODE trainer's latent triplet
(``last_visual``); decoding it into a logged video is not ported (ROADMAP
Queue A item 11).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zlib

import numpy as np
import torch

from self_forcing_tpu_torch.config import load_config
from self_forcing_tpu_torch.data.datasets import (ODERegressionDataset,
                                                  PoseShardingDataset,
                                                  ShardingDataset,
                                                  TextDataset)
from self_forcing_tpu_torch.data.loader import DataLoader
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import (WAN_1_3B, WAN_14B,
                                                       WAN_TINY,
                                                       apply_model_kwargs)
from self_forcing_tpu_torch.runtime import (load_clip_vision,
                                            load_dit_params, load_wan_models)
from self_forcing_tpu_torch.training.trainer_diffusion import (
    DiffusionTrainer)
from self_forcing_tpu_torch.training.trainer_distillation import (
    ScoreDistillationTrainer)
from self_forcing_tpu_torch.training.trainer_gan import GANTrainer
from self_forcing_tpu_torch.training.trainer_ode import ODETrainer

TRAINERS = ("score_distillation", "gan", "ode", "diffusion")


def build_models(config, dtype: torch.dtype, device: torch.device):
    """(cfg, generator, fake, real): the Wan weights of ``model_dir`` (the
    generator with ``generator_ckpt``'s 'generator' laid over them, where
    that file exists) when the directory exists and the size is not tiny,
    else random weights from the seed."""
    size = str(getattr(config, "model_size", "1.3b")).lower()
    cfg = apply_model_kwargs({"1.3b": WAN_1_3B, "14b": WAN_14B,
                              "tiny": WAN_TINY}[size], config)
    model_dir = str(getattr(config, "model_dir", "wan_models"))
    if size != "tiny" and os.path.isdir(model_dir):
        gen_ckpt = getattr(config, "generator_ckpt", None)
        generator = load_dit_params(
            model_dir, cfg,
            gen_ckpt if gen_ckpt and os.path.exists(gen_ckpt) else None,
            checkpoint_key="generator", dtype=dtype, device=device)
        fake = load_dit_params(model_dir, cfg, dtype=dtype, device=device)
        real = load_dit_params(model_dir, cfg, dtype=dtype, device=device)
        return cfg, generator, fake, real
    if size != "tiny":
        print(f"[train] no weights at {model_dir}; random init", flush=True)
    seed = int(getattr(config, "seed", 0))
    generator = dit.init_params(cfg, seed, dtype, device, causal=True)
    fake = dit.init_params(cfg, seed + 1, dtype, device, causal=False)
    real = dit.init_params(cfg, seed + 2, dtype, device, causal=False)
    return cfg, generator, fake, real


def make_context_fn(config, cfg, device: torch.device):
    """Prompts -> text contexts [B, 512, text_dim]: the T5 encoder of
    ``model_dir`` where its file exists (bf16), else pseudo embeddings
    (fp32)."""
    model_dir = str(getattr(config, "model_dir", "wan_models"))
    if os.path.exists(os.path.join(model_dir,
                                   "models_t5_umt5-xxl-enc-bf16.pth")):
        return load_wan_models(model_dir, load_vae=False, load_dit=False,
                               device=device).encode_text

    def pseudo(prompts):
        out = []
        for p in prompts:
            g = torch.Generator(device=device).manual_seed(
                zlib.crc32(p.encode()) % (2 ** 31))
            out.append(torch.randn(512, cfg.text_dim, generator=g,
                                   device=device))
        return torch.stack(out)
    return pseudo


def data_batches(config, trainer_kind: str, batch_size: int):
    """Endless batches of the config's data, numpy (collated): the ODE
    shard at ``data_path`` for the ODE trainer, the pose shard directory
    there for pose distillation, the shard directory there for the
    diffusion and GAN trainers, else the prompt file there (through
    ``TextDataset`` and the prefetching ``DataLoader``), else placeholder
    prompts from the seed."""
    path = str(getattr(config, "data_path", ""))
    ds = None
    if trainer_kind == "ode" and os.path.exists(path):
        ds = ODERegressionDataset(path)
    elif trainer_kind == "score_distillation" and getattr(
            config, "use_pose_conditioning", False) and os.path.isdir(path):
        ds = PoseShardingDataset(path)
    elif trainer_kind in ("diffusion", "gan") and os.path.isdir(path):
        ds = ShardingDataset(path)
    elif os.path.exists(path):
        ds = TextDataset(path)
    if ds is not None:
        yield from DataLoader(ds, batch_size, infinite=True)
        return
    rng = np.random.default_rng(int(getattr(config, "seed", 0)))
    while True:
        yield {"prompts": [f"placeholder prompt {rng.integers(1000)}"
                           for _ in range(batch_size)]}


def pose_models(config, device: torch.device) -> dict:
    """The VAE and CLIP of ``model_dir`` for pose distillation, as the
    trainer's keyword arguments (None where a file is missing, with a
    warning)."""
    model_dir = str(getattr(config, "model_dir", "wan_models"))
    m = load_wan_models(model_dir, load_t5=False, load_dit=False,
                        device=device)
    clip_params, clip_cfg = load_clip_vision(model_dir, device=device)
    missing = [n for n, p in (("VAE", m.vae_params), ("CLIP", clip_params))
               if p is None]
    if missing:
        print(f"[train] pose conditioning without {'/'.join(missing)} "
              f"weights: first_frame image conditioning will raise if the "
              f"dataset provides images", flush=True)
    return dict(vae_params=m.vae_params, vae_cfg=m.vae_cfg,
                clip_params=clip_params, clip_cfg=clip_cfg)


def make_trainer(config, trainer_kind: str, cfg, generator, fake, real,
                 context_fn, batch_size: int, device: torch.device,
                 visualize: bool = True, timing: bool = False):
    """The config's trainer over the models of :func:`build_models`."""
    if trainer_kind == "score_distillation":
        neg = context_fn([str(getattr(config, "negative_prompt", ""))]
                         * batch_size)
        extra = pose_models(config, device) if getattr(
            config, "use_pose_conditioning", False) else {}
        return ScoreDistillationTrainer(config, generator, fake, real, cfg,
                                        cfg, cfg, neg, device=device,
                                        timing=timing, **extra)
    if trainer_kind == "gan":
        return GANTrainer(config, generator, fake, cfg, cfg, device=device,
                          timing=timing)
    if trainer_kind == "ode":
        return ODETrainer(config, generator, cfg, visualize=visualize,
                          device=device)
    if trainer_kind == "diffusion":
        return DiffusionTrainer(config, generator, cfg, device=device)
    raise ValueError(f"unknown trainer {trainer_kind!r}")


def make_batch(config, trainer_kind: str, raw: dict, context_fn, shape,
               rng: np.random.Generator, device: torch.device) -> dict:
    """A trainer's batch from a :func:`data_batches` batch: the prompts'
    text context, a pose shard's ``dwpose_data`` / ``random_ref_dwpose`` /
    ``first_frame`` (numpy, as read), an ODE shard's trajectories
    (``ode_latent``, and their last snapshot as ``latents``), and for the
    diffusion and GAN trainers without shards stand-in latents of
    ``shape`` drawn from ``rng``."""
    out = {"context": context_fn(list(raw["prompts"]))}
    for k in ("dwpose_data", "random_ref_dwpose", "first_frame"):
        if k in raw:
            out[k] = np.asarray(raw[k])
    if "ode_latent" in raw:
        out["ode_latent"] = torch.as_tensor(raw["ode_latent"], device=device)
        out["latents"] = out["ode_latent"][:, -1]
    elif trainer_kind in ("diffusion", "gan"):
        g = torch.Generator(device=device).manual_seed(
            int(rng.integers(2 ** 31)))
        out["latents"] = torch.randn(tuple(shape), generator=g,
                                     device=device)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--logdir", default="logs/run")
    ap.add_argument("--no_save", action="store_true")
    ap.add_argument("--no_visualize", action="store_true")
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = load_config(args.config_path, os.path.join(
        os.path.dirname(args.config_path), "default_config.yaml"))
    trainer_kind = str(getattr(config, "trainer", "score_distillation"))
    if trainer_kind not in TRAINERS:
        raise ValueError(f"unknown trainer {trainer_kind!r}; the trainers "
                         f"are {', '.join(TRAINERS)}")
    data_path = str(getattr(config, "data_path", ""))
    if trainer_kind == "ode" and not os.path.exists(data_path):
        raise FileNotFoundError(
            f"the ode trainer regresses onto ODE trajectories read from "
            f"data_path, and {data_path!r} does not exist")
    device = torch.device(args.device)
    # float32 products (activations over bf16 weights) in TF32 on the
    # tensor cores, as XLA's default precision runs float32 dots on a GPU
    torch.backends.cuda.matmul.allow_tf32 = True
    dtype = torch.bfloat16 if getattr(config, "mixed_precision", False) \
        else torch.float32
    cfg, generator, fake, real = build_models(config, dtype, device)
    context_fn = make_context_fn(config, cfg, device)
    shape = list(getattr(config, "image_or_video_shape",
                         [1, 21, 16, 60, 104]))
    B = int(getattr(config, "batch_size", shape[0]))
    shape[0] = B
    trainer = make_trainer(config, trainer_kind, cfg, generator, fake, real,
                           context_fn, B, device,
                           visualize=not args.no_visualize)
    batches = data_batches(config, trainer_kind, B)
    rng = np.random.default_rng(int(getattr(config, "seed", 0)))

    os.makedirs(args.logdir, exist_ok=True)
    log_iters = int(getattr(config, "log_iters", 50))
    with open(os.path.join(args.logdir, "metrics.jsonl"), "a") as metrics:
        for step in range(args.max_steps):
            t0 = time.time()
            batch = make_batch(config, trainer_kind, next(batches),
                               context_fn, shape, rng, device)
            log = trainer.train_step(batch)
            log["step_time_s"] = round(time.time() - t0, 3)
            metrics.write(json.dumps({"step": step, **log}) + "\n")
            if step % 10 == 0 or step == args.max_steps - 1:
                print(f"[{step}] " + json.dumps(
                    {k: round(v, 5) for k, v in log.items()}), flush=True)
            if not args.no_save and step and step % log_iters == 0:
                trainer.save(os.path.join(
                    args.logdir, f"checkpoint_model_{step:06d}.pt"))
    batches.close()
    if not args.no_save:
        trainer.save(os.path.join(args.logdir, "final.pt"))


if __name__ == "__main__":
    main()
