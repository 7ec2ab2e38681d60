"""Training entry point of the PyTorch package (port of ``train.py``).

    python -m self_forcing_tpu_torch.train --config_path configs/self_forcing_dmd.yaml \\
        --max_steps N [--logdir logs/run] [--no_save] [--no_visualize] [--device cuda]
    torchrun --nproc_per_node N -m self_forcing_tpu_torch.train \\
        --config_path ... --dist_backend nccl|gloo ...

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
Metrics go through ``utils/metrics.MetricsLogger`` to
``<logdir>/metrics.jsonl`` (and wandb where it is importable and
configured, unless ``--disable-wandb``); checkpoints
(``torch.save``) every ``log_iters`` steps and at the end unless
``--no_save``.  Every ``visualize_every`` steps the ODE trainer's latent
triplet (``last_visual``) is decoded by the VAE of ``model_dir`` on rank
0 and logged as videos, when that VAE exists; ``--no_visualize`` drops
the triplet.

Under ``torchrun`` (or in a process group the caller initialised) the
ranks form a ``("dp", "fsdp", "sp")`` mesh (:func:`setup_mesh`): the
models are ZeRO-3 slices, each trainer splits the batch
(``parallel/mesh.py``'s ``batch_sharding``), and rank 0 alone logs and
writes checkpoints (every rank gathers for them).  ``--dist_backend``:
``nccl`` (one card a rank) or ``gloo`` (several ranks may share a card;
NCCL refuses two ranks on one device).
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
from self_forcing_tpu_torch.parallel import fsdp
from self_forcing_tpu_torch.parallel import mesh as mesh_mod
from self_forcing_tpu_torch.runtime import (load_clip_vision,
                                            load_dit_params, load_wan_models)
from self_forcing_tpu_torch.training.trainer_diffusion import (
    DiffusionTrainer)
from self_forcing_tpu_torch.training.trainer_distillation import (
    ScoreDistillationTrainer)
from self_forcing_tpu_torch.training.trainer_gan import GANTrainer
from self_forcing_tpu_torch.training.trainer_ode import ODETrainer
from self_forcing_tpu_torch.utils.metrics import MetricsLogger
from self_forcing_tpu_torch.utils.misc import set_seed

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


def setup_mesh(config, generator, fake, real, device_type: str = "cuda"):
    """ZeRO-3 over the initialised world's ranks (the reference's FSDP,
    ``sharding_strategy`` 'hybrid_full' by default): (mesh, generator,
    fake, real), the trees as ``fsdp.ShardedParams``.  No mesh (the trees
    as they are) for one rank or ``sharding_strategy`` 'none' /
    'no_shard'.  dp: ``dp_size``, else under a 'hybrid' strategy the
    hosts (world / LOCAL_WORLD_SIZE), else 1; sp: ``sp_size`` (the
    teacher's sequence parallelism); fsdp takes the rest.  Leaves under
    ``fsdp_min_param_size`` elements stay replicated; under
    ``teacher_zero3_sp`` with sp > 1 the teacher is sliced over
    ("fsdp", "sp")."""
    d = torch.distributed
    strategy = str(getattr(config, "sharding_strategy", "hybrid_full"))
    n = d.get_world_size() if d.is_initialized() else 1
    if n == 1 or strategy in ("none", "no_shard"):
        return None, generator, fake, real
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    dp = int(getattr(config, "dp_size", 0) or 0) or (
        n // local if strategy.startswith("hybrid") and n % local == 0
        else 1)
    sp = int(getattr(config, "sp_size", 1) or 1)
    mesh = mesh_mod.create_mesh(dp=dp, sp=sp, fsdp=n // (dp * sp),
                                device_type=device_type)
    min_size = int(getattr(config, "fsdp_min_param_size", 2 ** 16))
    generator = mesh_mod.shard_params(generator, mesh, min_size=min_size)
    fake = mesh_mod.shard_params(fake, mesh, min_size=min_size)
    if sp > 1 and bool(getattr(config, "teacher_zero3_sp", False)) \
            and bool(getattr(config, "teacher_sequence_parallel", True)):
        real = mesh_mod.shard_params(real, mesh, specs=mesh_mod
                                     .combined_fsdp_specs(real, mesh,
                                                          min_size=min_size))
    else:
        real = mesh_mod.shard_params(real, mesh, min_size=min_size)
    return mesh, generator, fake, real


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every tensor or array entry whose leading size
    dp x fsdp (else dp) divides (the DistributedSampler's split,
    ``mesh.batch_sharding``); other entries as they are.  The trainers
    take whole batches and apply the same rule themselves."""
    if mesh is None:
        return batch

    def put(v):
        if not (hasattr(v, "shape") and len(getattr(v, "shape", ())) >= 1):
            return v
        return mesh_mod.batch_sharding(mesh, int(v.shape[0])).slice(v)
    return {k: put(v) for k, v in batch.items()}


def _join_group(backend: str, device: torch.device) -> torch.device:
    """The process group of ``torchrun``'s environment, joined when there
    is more than one rank and nobody joined it yet; returns this rank's
    device (``cuda:LOCAL_RANK`` modulo the cards)."""
    d = torch.distributed
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    if not d.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        d.init_process_group(backend)
    if d.is_initialized() and d.get_backend() != backend:
        raise SystemExit(f"--dist_backend {backend}: the group's backend "
                         f"is {d.get_backend()}")
    return device


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
                 visualize: bool = True, timing: bool = False, mesh=None):
    """The config's trainer over the models of :func:`build_models` (of
    :func:`setup_mesh` on a mesh)."""
    if trainer_kind == "score_distillation":
        neg = context_fn([str(getattr(config, "negative_prompt", ""))]
                         * batch_size)
        extra = pose_models(config, device) if getattr(
            config, "use_pose_conditioning", False) else {}
        return ScoreDistillationTrainer(config, generator, fake, real, cfg,
                                        cfg, cfg, neg, device=device,
                                        timing=timing, mesh=mesh, **extra)
    if trainer_kind == "gan":
        return GANTrainer(config, generator, fake, cfg, cfg, device=device,
                          timing=timing, mesh=mesh)
    if trainer_kind == "ode":
        return ODETrainer(config, generator, cfg, visualize=visualize,
                          device=device, mesh=mesh)
    if trainer_kind == "diffusion":
        return DiffusionTrainer(config, generator, cfg, device=device,
                                mesh=mesh)
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


def video_logger(config, trainer, logger: MetricsLogger,
                 device: torch.device, visualize: bool = True):
    """``visualize(step)``: the trainer's ``last_visual`` latents decoded
    by the VAE of ``model_dir`` (sample 0, [-1, 1] to [0, 1]) and logged
    as one video each, on the main rank; None when there is nothing to
    decode with (no ``last_visual``, no VAE file, ``--no_visualize``, not
    rank 0)."""
    model_dir = str(getattr(config, "model_dir", "wan_models"))
    if not (visualize and logger.is_main and hasattr(trainer, "last_visual")
            and os.path.isdir(model_dir)):
        return None
    from self_forcing_tpu_torch.wrappers import WanVAEWrapper
    models = load_wan_models(model_dir, load_dit=False, load_t5=False,
                             device=device)
    if models.vae_params is None:
        return None
    vae = WanVAEWrapper(models.vae_params, models.vae_cfg)

    @torch.no_grad()
    def visualize_step(step: int) -> None:
        if trainer.last_visual is None:
            return
        for name, lat in trainer.last_visual.items():
            px = vae.decode_to_pixel(lat[:1].float())
            video = (px[0].permute(0, 2, 3, 1).float() * 0.5 + 0.5).cpu()
            logger.log_video(name, video.numpy(), step)
    return visualize_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--logdir", default="logs/run")
    ap.add_argument("--no_save", action="store_true")
    ap.add_argument("--no_visualize", action="store_true")
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist_backend", default="nccl",
                    choices=("nccl", "gloo"),
                    help="the process group's backend under torchrun")
    ap.add_argument("--disable-wandb", action="store_true",
                    help="log to the JSONL file only (else wandb too, "
                         "when it is importable and configured)")
    ap.add_argument("--wandb-save-dir", default="")
    args = ap.parse_args(argv)
    d = torch.distributed
    joined = d.is_initialized()
    try:
        _run(args)
    finally:
        if not joined and d.is_initialized():
            d.destroy_process_group()


def _run(args) -> None:
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
    device = _join_group(args.dist_backend, torch.device(args.device))
    set_seed(int(getattr(config, "seed", 0)))
    is_main = fsdp.is_main()
    # float32 products (activations over bf16 weights) in TF32 on the
    # tensor cores, as XLA's default precision runs float32 dots on a GPU
    torch.backends.cuda.matmul.allow_tf32 = True
    dtype = torch.bfloat16 if getattr(config, "mixed_precision", False) \
        else torch.float32
    cfg, generator, fake, real = build_models(config, dtype, device)
    mesh, generator, fake, real = setup_mesh(config, generator, fake, real,
                                             device.type)
    if mesh is not None and is_main:
        shape = mesh_mod.mesh_shape(mesh)
        print(f"[train] mesh dp={shape['dp']} fsdp={shape['fsdp']} "
              f"sp={shape['sp']} over {torch.distributed.get_world_size()} "
              f"ranks "
              f"({torch.distributed.get_backend()})", flush=True)
    context_fn = make_context_fn(config, cfg, device)
    shape = list(getattr(config, "image_or_video_shape",
                         [1, 21, 16, 60, 104]))
    B = int(getattr(config, "batch_size", shape[0]))
    shape[0] = B
    trainer = make_trainer(config, trainer_kind, cfg, generator, fake, real,
                           context_fn, B, device,
                           visualize=not args.no_visualize, mesh=mesh)
    batches = data_batches(config, trainer_kind, B)
    rng = np.random.default_rng(int(getattr(config, "seed", 0)))
    wandb_kwargs = {
        "entity": getattr(config, "wandb_entity", None),
        "project": getattr(config, "wandb_project", None),
        "name": os.path.basename(args.config_path).rsplit(".", 1)[0],
        "dir": args.wandb_save_dir or None}
    logger = MetricsLogger(
        args.logdir, disable_wandb=args.disable_wandb,
        wandb_kwargs={k: v for k, v in wandb_kwargs.items() if v},
        is_main=is_main)
    visualize = video_logger(config, trainer, logger, device,
                             not args.no_visualize)
    visualize_every = int(getattr(config, "visualize_every", 100))
    log_iters = int(getattr(config, "log_iters", 50))
    try:
        for step in range(args.max_steps):
            t0 = time.time()
            batch = make_batch(config, trainer_kind, next(batches),
                               context_fn, shape, rng, device)
            log = trainer.train_step(batch)
            log["step_time_s"] = round(time.time() - t0, 3)
            logger.log(log, step=step)
            if visualize is not None and step % visualize_every == 0:
                visualize(step)
            if is_main and (step % 10 == 0 or step == args.max_steps - 1):
                print(f"[{step}] " + json.dumps(
                    {k: round(v, 5) for k, v in log.items()}), flush=True)
            if not args.no_save and step and step % log_iters == 0:
                trainer.save(os.path.join(
                    args.logdir, f"checkpoint_model_{step:06d}.pt"))
        if not args.no_save:
            trainer.save(os.path.join(args.logdir, "final.pt"))
    finally:
        batches.close()
        logger.close()


if __name__ == "__main__":
    main()
