"""Inference CLI of the PyTorch package (port of ``inference.py``): text-
or image-to-video over a prompt file, one mp4 a prompt at 16 fps.

    python -m self_forcing_tpu_torch.inference --config_path configs/self_forcing_dmd.yaml \\
        --checkpoint_path checkpoints/self_forcing_dmd.pt \\
        --data_path prompts/MovieGenVideoBench.txt --output_folder videos/ \\
        [--i2v] [--device cuda]

The config is merged over ``default_config.yaml`` beside it.  A config
with ``denoising_step_list`` runs the few-step ``CausalInferencePipeline``
(the only pipeline ported).  ``model_size: tiny`` draws random weights
(WAN_TINY, a tiny VAE widened to 16 latent channels) and a pseudo text
context from the prompt's crc32; any other size loads Wan2.1-T2V-1.3B,
the T5 encoder, its tokenizer and the VAE from ``model_dir``
(``runtime.load_wan_models``).  ``--i2v`` reads a ``TextImagePairDataset``
directory: each image is resized (``resize_cubic``) and encoded as an
independent first latent frame.  The prompts are split over the ranks of
an initialised ``torch.distributed`` group (else rank 0 of 1).  It runs on
the card unless ``--device cpu`` is given.  Writing the mp4 needs ``cv2``
or ``imageio``; the tokenizer needs ``transformers``, ``--i2v`` PIL.
On the card the DiT runs bf16 activations (the noise and context are cast
to the parameters' dtype), where the JAX CLI's float32 noise promotes
them to float32.
"""
from __future__ import annotations

import argparse
import os
import zlib

import numpy as np
import torch

from self_forcing_tpu_torch.config import load_config
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import (LATENT_HEIGHT,
                                                       LATENT_WIDTH,
                                                       WAN_1_3B, WAN_TINY,
                                                       apply_model_kwargs)
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline)

# the tiny model's VAE: VAE_TINY's geometry widened to the DiT's 16
# latent channels
TINY_VAE = vae_mod.VAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2),
                             num_res_blocks=1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = -0.5) at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``jax.image.resize``'s "cubic"
    along one axis: half-pixel centres, the kernel stretched by the
    shrink factor when shrinking (antialiasing), each column renormalised
    to sum 1 (the borders), columns whose sample falls outside the input
    zero."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - pos[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(image: torch.Tensor, height: int, width: int
                 ) -> torch.Tensor:
    """``jax.image.resize(image, (height, width, C), "cubic")`` of an
    [H, W, C] image, in float32: separable Keys-cubic weights, applied as
    two products."""
    x = image.float()
    H, W = x.shape[:2]
    if H != height:
        x = torch.einsum("hwc,hH->Hwc", x,
                         _resize_weights(H, height, x.device))
    if W != width:
        x = torch.einsum("hwc,wW->hWc", x,
                         _resize_weights(W, width, x.device))
    return x


def generate(pipeline: CausalInferencePipeline, context: torch.Tensor,
             num_frames: int, latent_hw: tuple[int, int], seed: int,
             image: torch.Tensor | None = None,
             noise: torch.Tensor | None = None, eps=None,
             profile: bool = False) -> torch.Tensor:
    """One prompt, from its text context [1, Lc, text_dim] to uint8 frames
    [F_px, H*8, W*8, 3] on the pipeline's device.

    The noise [1, n, C, H, W] is drawn from a ``torch.Generator`` seeded
    with ``seed`` on the device (float32, then cast to the pipeline's
    dtype), and the same generator draws the re-noising steps.  With an
    ``image`` [H0, W0, 3] in [-1, 1] (image to video), the image is resized
    to the video's size, encoded by the pipeline's VAE as the first latent
    frame, and ``num_frames - 1`` frames are generated after it.  A given
    ``noise`` (float32, shaped as drawn) and ``eps`` (the pipeline's
    re-noising draws) replace the seeded ones, as another sampler's draws
    are replayed."""
    H, W = latent_hw
    dev, dtype = pipeline.device, pipeline.dtype
    initial_latent = None
    n_noise = num_frames
    if image is not None:
        vdt = pipeline.vae_params["conv2"]["w"].dtype
        img = resize_cubic(image.to(dev), H * 8, W * 8).to(vdt)
        z = vae_mod.encode(pipeline.vae_params, pipeline.vae_cfg,
                           img[None, None])
        initial_latent = z.permute(0, 1, 4, 2, 3).to(dtype)
        n_noise = num_frames - 1
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (1, n_noise, pipeline.cfg.in_dim, H, W)
    if noise is None:
        noise = torch.randn(shape, generator=g, device=dev)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise {tuple(noise.shape)}: expected {shape}")
    video = pipeline.inference(noise.to(dev, dtype), context.to(dev, dtype),
                               initial_latent=initial_latent, eps=eps,
                               generator=g, profile=profile)
    return frames_uint8(video[0])


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
                    help="tensor-parallel degree of the few-step pipeline")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = load_config(args.config_path, os.path.join(
        os.path.dirname(args.config_path), "default_config.yaml"))
    few_step = bool(getattr(config, "denoising_step_list", None))
    if args.dwpose_path:
        if few_step:
            raise ValueError(
                "--dwpose_path needs the 50-step diffusion pipeline "
                "(a config without denoising_step_list)")
        raise NotImplementedError(
            "pose conditioning is not ported (ROADMAP Queue A item 6)")
    if not few_step:
        raise NotImplementedError(
            "the 50-step diffusion pipeline (a config without "
            "denoising_step_list) is not ported (ROADMAP Queue A item 8)")
    if args.tp and args.tp > 1:
        raise NotImplementedError(
            "--tp: tensor parallelism is not ported (ROADMAP Queue A "
            "item 10); one H100 holds the models")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    size = str(getattr(config, "model_size", "1.3b")).lower()
    if size == "tiny":
        cfg, dtype = WAN_TINY, torch.float32
        params = dit.init_params(cfg, 0, dtype, device, causal=True)
        vae_cfg = TINY_VAE
        vae_params = vae_mod.init_params(vae_cfg, seed=1, dtype=dtype,
                                         device=device)
        H = W = 8
        encode = _pseudo_encoder(cfg.text_dim, device)
    else:
        from self_forcing_tpu_torch.runtime import load_wan_models
        cfg, dtype = WAN_1_3B, torch.bfloat16
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
    pipeline = CausalInferencePipeline(config, params, cfg,
                                       vae_params=vae_params,
                                       vae_cfg=vae_cfg, device=device,
                                       dtype=dtype)

    data_path = args.data_path or str(getattr(config, "data_path", ""))
    if args.i2v:
        from self_forcing_tpu_torch.data.datasets import TextImagePairDataset
        dataset = TextImagePairDataset(data_path)
    else:
        from self_forcing_tpu_torch.data.datasets import TextDataset
        dataset = TextDataset(data_path)
    rank, world = _rank_world()
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
    for idx in range(rank, len(dataset), world):
        item = dataset[idx]
        prompt = item["prompts"]
        frames = generate(pipeline, encode([prompt]), F, (H, W),
                          args.seed + idx,
                          image=item["image"] if args.i2v else None)
        name = f"output_{idx:03d}.mp4" if args.save_with_index else \
            f"{prompt[:100].replace('/', '_')}.mp4"
        out_path = os.path.join(args.output_folder, name)
        save_video(frames.cpu().numpy(), out_path, fps=16)
        print(f"[{rank}] wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
