"""Inference CLI of the PyTorch package (port of ``inference.py``): text-
or image-to-video over a prompt file, one mp4 a prompt at 16 fps.

    python -m self_forcing_tpu_torch.inference --config_path configs/self_forcing_dmd.yaml \\
        --checkpoint_path checkpoints/self_forcing_dmd.pt \\
        --data_path prompts/MovieGenVideoBench.txt --output_folder videos/ \\
        [--i2v] [--dwpose_path pose.npz] [--device cuda]

    torchrun --nproc_per_node N -m self_forcing_tpu_torch.inference --tp N \\
        [--dist_backend nccl|gloo] --config_path ... (as above)

The config is merged over ``default_config.yaml`` beside it.  A config
with ``denoising_step_list`` runs the few-step ``CausalInferencePipeline``;
any other config the 50-step ``CausalDiffusionInferencePipeline`` (CFG
against the config's ``negative_prompt``, encoded once a run), which
``--dwpose_path`` conditions on a pose video: an ``.npz`` with
``dwpose_data`` [3, 4F - 3, H*8, W*8] uint8 and optionally
``random_ref_dwpose`` [H*8, W*8, 3] uint8, through the pose CNNs whose
weights ``pose_weights_path`` names (a UniAnimate checkpoint; random
weights on ``model_size: tiny``).  ``model_size: tiny`` draws random weights
(WAN_TINY, a tiny VAE widened to 16 latent channels) and a pseudo text
context from the prompt's crc32; any other size loads Wan2.1-T2V-1.3B,
the T5 encoder, its tokenizer and the VAE from ``model_dir``
(``runtime.load_wan_models``).  ``--i2v`` reads a ``TextImagePairDataset``
directory: each image is resized (``utils.resize.resize_cubic``, the
``jax.image.resize`` cubic) and encoded as an
independent first latent frame.  The prompts are split over the ranks of
an initialised ``torch.distributed`` group (else rank 0 of 1).  ``--tp N``
(the few-step pipeline only; N must divide the model's heads and ffn
width) runs the DiT tensor-parallel over N ranks launched by
``torchrun``: each rank reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``,
joins a process group of ``--dist_backend`` (NCCL by default; gloo for
ranks that share one card, which NCCL refuses, and on the CPU), loads the
models, keeps its shard of the DiT and samples every prompt with the
others; rank 0 writes the videos.  It runs on
the card unless ``--device cpu`` is given.  Writing the mp4 needs ``cv2``
or ``imageio``; the tokenizer needs ``transformers``, ``--i2v`` PIL.
On the card the DiT runs bf16 activations (the context and the DiT's input
are cast to the parameters' dtype), where the JAX CLI's float32 noise
promotes them to float32; the 50-step path keeps its sample and solver
state in float32.
"""
from __future__ import annotations

import argparse
import os
import zlib

import numpy as np
import torch

from self_forcing_tpu_torch import conditioning as cond_mod
from self_forcing_tpu_torch.config import load_config
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import (LATENT_HEIGHT,
                                                       LATENT_WIDTH,
                                                       WAN_1_3B, WAN_TINY,
                                                       apply_model_kwargs)
from self_forcing_tpu_torch.pipelines.causal_diffusion_inference import (
    CausalDiffusionInferencePipeline)
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline)
from self_forcing_tpu_torch.utils.resize import resize_cubic

# the tiny model's VAE: VAE_TINY's geometry widened to the DiT's 16
# latent channels
TINY_VAE = vae_mod.VAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2),
                             num_res_blocks=1)


def generate(pipeline, context: torch.Tensor, num_frames: int,
             latent_hw: tuple[int, int], seed: int,
             image: torch.Tensor | None = None,
             noise: torch.Tensor | None = None, eps=None,
             profile: bool = False, neg_context: torch.Tensor | None = None,
             dwpose_data: torch.Tensor | None = None,
             random_ref_dwpose: torch.Tensor | None = None) -> torch.Tensor:
    """One prompt, from its text context [1, Lc, text_dim] to uint8 frames
    [F_px, H*8, W*8, 3] on the pipeline's device.

    The noise [1, n, C, H, W] is drawn in float32 from a
    ``torch.Generator`` seeded with ``seed`` on the device.  The few-step
    pipeline gets it cast to its dtype and draws its re-noising steps from
    the same generator; the 50-step ``CausalDiffusionInferencePipeline``
    keeps it in float32 and takes ``neg_context`` and the pose inputs
    (``dwpose_data`` [1, 3, F_px, H*8, W*8], ``random_ref_dwpose``
    [1, H*8, W*8, 3], both uint8).  With an ``image`` [H0, W0, 3] in
    [-1, 1] (image to video), the image is resized to the video's size,
    encoded by the pipeline's VAE as the first latent frame, and
    ``num_frames - 1`` frames are generated after it.  A given ``noise``
    (float32, shaped as drawn) and ``eps`` (the few-step pipeline's
    re-noising draws) replace the seeded ones, as another sampler's draws
    are replayed."""
    H, W = latent_hw
    dev, dtype = pipeline.device, pipeline.dtype
    diffusion = isinstance(pipeline, CausalDiffusionInferencePipeline)
    initial_latent = None
    n_noise = num_frames
    if image is not None:
        vdt = pipeline.vae_params["conv2"]["w"].dtype
        img = resize_cubic(image.to(dev).permute(2, 0, 1), H * 8,
                           W * 8).permute(1, 2, 0).to(vdt)
        z = vae_mod.encode(pipeline.vae_params, pipeline.vae_cfg,
                           img[None, None])
        initial_latent = z.permute(0, 1, 4, 2, 3)
        n_noise = num_frames - 1
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (1, n_noise, pipeline.cfg.out_dim, H, W)
    if noise is None:
        noise = torch.randn(shape, generator=g, device=dev)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise {tuple(noise.shape)}: expected {shape}")
    if diffusion:
        video = pipeline.inference(
            noise.to(dev), context=context, neg_context=neg_context,
            initial_latent=initial_latent, dwpose_data=dwpose_data,
            random_ref_dwpose=random_ref_dwpose, profile=profile)
    else:
        video = pipeline.inference(
            noise.to(dev, dtype), context.to(dev, dtype),
            initial_latent=None if initial_latent is None
            else initial_latent.to(dtype),
            eps=eps, generator=g, profile=profile)
    return frames_uint8(video[0])


def load_pose_weights(config, size: str, device: torch.device):
    """(dwpose, randomref) pose-CNN weights for ``--dwpose_path``: from the
    checkpoint ``config.pose_weights_path`` names (its
    ``dwpose_embedding.*`` / ``randomref_embedding_pose.*`` keys), drawn
    from seeds 7 and 8 on ``model_size: tiny``; any other model without
    that file raises."""
    path = getattr(config, "pose_weights_path", None)
    if path and os.path.exists(str(path)):
        from self_forcing_tpu_torch.utils import checkpoints as ckpt
        return cond_mod.load_pose_embedding_weights(
            ckpt.load_torch_state_dict(str(path)), device=device)
    if size == "tiny":
        return (cond_mod.init_dwpose_params(7, device=device),
                cond_mod.init_randomref_params(8, device=device))
    raise ValueError(
        "--dwpose_path given but config.pose_weights_path is missing "
        "(UniAnimate LoRA checkpoint with the dwpose_embedding. weights)")


def load_pose_npz(path: str, device: torch.device):
    """An ``.npz`` of ``dwpose_data`` [3, F_px, H, W] uint8 and optionally
    ``random_ref_dwpose`` [H, W, 3] uint8 -> both with a batch axis of 1
    on ``device`` (None for a missing reference pose)."""
    with np.load(path) as pose:
        dwpose = torch.from_numpy(pose["dwpose_data"])[None].to(device)
        ref = None
        if "random_ref_dwpose" in pose:
            ref = torch.from_numpy(pose["random_ref_dwpose"])[None].to(device)
    return dwpose, ref


def frames_uint8(video: torch.Tensor) -> torch.Tensor:
    """[T, 3, H, W] in [0, 1] -> [T, H, W, 3] uint8: times 255 in float32,
    truncated, as numpy's astype truncates."""
    return (video.permute(0, 2, 3, 1).float() * 255).to(torch.uint8)


def _pseudo_encoder(text_dim: int, device: torch.device):
    """Prompts -> [B, 512, text_dim] float32, seeded by each prompt's
    crc32 (the tiny model has no text encoder)."""
    def encode(prompts):
        out = []
        for p in prompts:
            g = torch.Generator(device=device).manual_seed(
                zlib.crc32(p.encode()) % (2 ** 31))
            out.append(torch.randn(512, text_dim, generator=g,
                                   device=device))
        return torch.stack(out)
    return encode


def _rank_world() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--output_folder", default="videos/out")
    ap.add_argument("--num_output_frames", type=int, default=21,
                    help="latent frames (21 -> 81 pixel frames)")
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save_with_index", action="store_true")
    ap.add_argument("--i2v", action="store_true",
                    help="image-to-video over a TextImagePairDataset "
                         "directory")
    ap.add_argument("--dwpose_path", default=None,
                    help=".npz of pose data for the 50-step diffusion "
                         "pipeline")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree of the few-step pipeline "
                         "(launch N ranks with torchrun)")
    ap.add_argument("--dist_backend", default="nccl",
                    choices=("nccl", "gloo"),
                    help="the --tp process group's backend")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dist = torch.distributed
    joined = dist.is_initialized()
    try:
        _run(args)
    finally:
        if not joined and dist.is_initialized():  # --tp joined a group
            dist.destroy_process_group()


def _join_tp_group(tp: int, backend: str, device: torch.device):
    """This process's rank of the --tp group: the one the caller
    initialised, else one joined now from torchrun's environment (after
    picking the card ``LOCAL_RANK`` names, modulo the cards there are).
    Returns the device."""
    dist = torch.distributed
    launch = (f"launch {tp} ranks: torchrun --nproc_per_node {tp} -m "
              f"self_forcing_tpu_torch.inference --tp {tp} ...")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", 1)) != tp:
            raise SystemExit(f"--tp {tp} needs {tp} ranks: {launch}")
        dist.init_process_group(backend)
    if dist.get_world_size() != tp:
        raise SystemExit(f"--tp {tp} needs {tp} ranks, the group has "
                         f"{dist.get_world_size()}: {launch}")
    if dist.get_backend() != backend:
        raise SystemExit(f"--dist_backend {backend}: the group's backend "
                         f"is {dist.get_backend()}")
    return device


def _run(args) -> None:
    """The CLI's work on the parsed arguments."""
    config = load_config(args.config_path, os.path.join(
        os.path.dirname(args.config_path), "default_config.yaml"))
    few_step = bool(getattr(config, "denoising_step_list", None))
    if args.dwpose_path and few_step:
        raise ValueError(
            "--dwpose_path needs the 50-step diffusion pipeline "
            "(a config without denoising_step_list)")
    tp = args.tp if args.tp > 1 else 0
    if tp and not few_step:
        raise SystemExit("--tp is supported on the few-step pipeline "
                         "(configs with denoising_step_list)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    size = str(getattr(config, "model_size", "1.3b")).lower()
    cfg = WAN_TINY if size == "tiny" else WAN_1_3B
    if tp:
        if cfg.num_heads % tp or cfg.ffn_dim % tp:
            raise SystemExit(f"--tp {tp} does not divide num_heads="
                             f"{cfg.num_heads} / ffn_dim={cfg.ffn_dim}")
        device = _join_tp_group(tp, args.dist_backend, device)
    if size == "tiny":
        dtype = torch.float32
        params = dit.init_params(cfg, 0, dtype, device, causal=True)
        vae_cfg = TINY_VAE
        vae_params = vae_mod.init_params(vae_cfg, seed=1, dtype=dtype,
                                         device=device)
        H = W = 8
        encode = _pseudo_encoder(cfg.text_dim, device)
    else:
        from self_forcing_tpu_torch.runtime import load_wan_models
        dtype = torch.bfloat16
        models = load_wan_models(
            str(getattr(config, "model_dir", "wan_models")), model_cfg=cfg,
            checkpoint_path=args.checkpoint_path,
            checkpoint_key="generator_ema" if args.use_ema else "generator",
            dtype=dtype, device=device)
        if models.vae_params is None:
            raise FileNotFoundError(f"no Wan2.1_VAE.pth under "
                                    f"{getattr(config, 'model_dir', '')}")
        params, vae_params, vae_cfg = (models.generator, models.vae_params,
                                       models.vae_cfg)
        encode = models.encode_text
        H, W = LATENT_HEIGHT, LATENT_WIDTH
    cfg = apply_model_kwargs(cfg, config)
    dwpose = random_ref = None
    mesh = None
    if tp:
        from self_forcing_tpu_torch.parallel import tensor as tpmod
        mesh = tpmod.tp_mesh(tp, device.type)
        params = tpmod.shard_params_tp(params, mesh)
    if few_step:
        pipeline = CausalInferencePipeline(config, params, cfg,
                                           vae_params=vae_params,
                                           vae_cfg=vae_cfg, device=device,
                                           dtype=dtype, mesh=mesh)
    else:
        dwpose_params = randomref_params = None
        if args.dwpose_path:
            dwpose, random_ref = load_pose_npz(args.dwpose_path, device)
            dwpose_params, randomref_params = load_pose_weights(
                config, size, device)
        pipeline = CausalDiffusionInferencePipeline(
            config, params, cfg, vae_params=vae_params, vae_cfg=vae_cfg,
            dwpose_params=dwpose_params, randomref_params=randomref_params,
            device=device, dtype=dtype)

    data_path = args.data_path or str(getattr(config, "data_path", ""))
    if args.i2v:
        from self_forcing_tpu_torch.data.datasets import TextImagePairDataset
        dataset = TextImagePairDataset(data_path)
    else:
        from self_forcing_tpu_torch.data.datasets import TextDataset
        dataset = TextDataset(data_path)
    # the ranks of a --tp group sample every prompt together; rank 0
    # writes
    rank, world = (0, 1) if tp else _rank_world()
    writes = not tp or torch.distributed.get_rank() == 0
    os.makedirs(args.output_folder, exist_ok=True)

    # the frame arithmetic, checked before any prompt runs: blocks of
    # num_frame_per_block after an independent first frame where the
    # config has one; --i2v's image is that first frame
    F = int(args.num_output_frames)
    nb = int(getattr(config, "num_frame_per_block", 1))
    iff = bool(getattr(config, "independent_first_frame", False))
    n_gen = F - 1 if args.i2v else (F - 1 if iff else F)
    if args.i2v and not iff:
        raise SystemExit(
            "--i2v encodes the image as one independent first latent "
            "frame, which requires independent_first_frame: true in the "
            "config (got false)")
    if n_gen % nb != 0:
        raise SystemExit(
            f"--num_output_frames {F} is not reachable with "
            f"num_frame_per_block={nb} (independent_first_frame={iff}, "
            f"i2v={args.i2v}): {n_gen} generated frames must be a "
            f"multiple of {nb}; try {F - n_gen % nb} or "
            f"{F + nb - n_gen % nb} output frames")

    from self_forcing_tpu_torch.utils.video_io import save_video
    # the same for every prompt: one encode a run
    neg = None if few_step else encode(
        [str(getattr(config, "negative_prompt", ""))])
    for idx in range(rank, len(dataset), world):
        item = dataset[idx]
        prompt = item["prompts"]
        frames = generate(pipeline, encode([prompt]), F, (H, W),
                          args.seed + idx,
                          image=item["image"] if args.i2v else None,
                          neg_context=neg, dwpose_data=dwpose,
                          random_ref_dwpose=random_ref)
        if not writes:
            continue
        name = f"output_{idx:03d}.mp4" if args.save_with_index else \
            f"{prompt[:100].replace('/', '_')}.mp4"
        out_path = os.path.join(args.output_folder, name)
        save_video(frames.cpu().numpy(), out_path, fps=16)
        print(f"[{rank}] wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
