"""Training entry point of the PyTorch package (port of ``train.py``).

    python -m self_forcing_tpu_torch.train --config_path configs/self_forcing_dmd.yaml \\
        --max_steps N [--logdir logs/run] [--no_save] [--device cuda]

The config is merged over ``default_config.yaml`` beside it.  Only
``trainer: score_distillation`` (the DMD objective) is ported.  The models
load from ``model_dir`` where it exists (``runtime.load_dit_params``; the
tiny size always draws), else start from random weights drawn from the
config's seed, at the config's ``model_size``.  Text contexts come from
the T5 encoder where ``model_dir`` holds it, else they are
pseudo-embeddings, ``randn(512, text_dim)`` from a ``torch.Generator``
seeded by the prompt's crc32; prompts come from ``data_path`` (one per
line, in a seeded shuffled order) or are placeholders.  Metrics go to
``<logdir>/metrics.jsonl``; checkpoints (``torch.save``) every
``log_iters`` steps and at the end unless ``--no_save``.
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
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import (WAN_1_3B, WAN_14B,
                                                       WAN_TINY,
                                                       apply_model_kwargs)
from self_forcing_tpu_torch.runtime import load_dit_params, load_wan_models
from self_forcing_tpu_torch.training.trainer_distillation import (
    ScoreDistillationTrainer)


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


def prompt_batches(config, batch_size: int):
    """Batches of prompts: ``data_path``'s non-empty lines in a seeded
    shuffled order, epoch after epoch, or placeholders."""
    rng = np.random.default_rng(int(getattr(config, "seed", 0)))
    path = str(getattr(config, "data_path", ""))
    if not os.path.isfile(path):
        while True:
            yield [f"placeholder prompt {rng.integers(1000)}"
                   for _ in range(batch_size)]
    with open(path, encoding="utf-8") as f:
        prompts = [line.rstrip("\n") for line in f if line.strip()]
    while True:
        order = rng.permutation(len(prompts))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield [prompts[j] for j in order[i:i + batch_size]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--logdir", default="logs/run")
    ap.add_argument("--no_save", action="store_true")
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = load_config(args.config_path, os.path.join(
        os.path.dirname(args.config_path), "default_config.yaml"))
    trainer_kind = str(getattr(config, "trainer", "score_distillation"))
    if trainer_kind != "score_distillation":
        raise NotImplementedError(
            f"trainer {trainer_kind!r} is not ported to the PyTorch package "
            "(ROADMAP Queue A item 7)")
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
    neg = context_fn([str(getattr(config, "negative_prompt", ""))] * B)
    trainer = ScoreDistillationTrainer(config, generator, fake, real, cfg,
                                       cfg, cfg, neg, device=device)
    batches = prompt_batches(config, B)

    os.makedirs(args.logdir, exist_ok=True)
    log_iters = int(getattr(config, "log_iters", 50))
    with open(os.path.join(args.logdir, "metrics.jsonl"), "a") as metrics:
        for step in range(args.max_steps):
            t0 = time.time()
            log = trainer.train_step({"context": context_fn(next(batches))})
            log["step_time_s"] = round(time.time() - t0, 3)
            metrics.write(json.dumps({"step": step, **log}) + "\n")
            if step % 10 == 0 or step == args.max_steps - 1:
                print(f"[{step}] " + json.dumps(
                    {k: round(v, 5) for k, v in log.items()}), flush=True)
            if not args.no_save and step and step % log_iters == 0:
                trainer.save(os.path.join(
                    args.logdir, f"checkpoint_model_{step:06d}.pt"))
    if not args.no_save:
        trainer.save(os.path.join(args.logdir, "final.pt"))


if __name__ == "__main__":
    main()
