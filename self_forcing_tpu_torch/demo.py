"""Streaming demo server of the PyTorch package (port of ``demo.py``):
block-by-block generation pushed to the browser over WebSocket.

    python -m self_forcing_tpu_torch.demo --config_path configs/self_forcing_dmd.yaml \\
        [--checkpoint_path checkpoints/self_forcing_dmd.pt] [--port 5001] \\
        [--quantize] [--taehv] [--warmup] [--device cuda]
    python -m self_forcing_tpu_torch.demo --config_path configs/tiny_test.yaml --device cpu

The config is merged over ``default_config.yaml`` beside it, and its
``model_kwargs`` apply (a windowed config streams up to 40 blocks).
``model_size: tiny`` draws random weights (WAN_TINY, the tiny VAE, a
random TAEHV decoder when no checkpoint is found) and a pseudo text
context from each prompt's crc32; any other size loads Wan2.1-T2V-1.3B,
the T5 encoder (kept on the host, streamed to the card a layer at a time
per prompt), its tokenizer and the VAE from ``model_dir``
(``runtime.load_wan_models``).  Each request picks its decoder (the
streaming Wan VAE, or TAEHV when ``--taehv_checkpoint`` exists) and
whether the DiT runs quantized (W8A8 linears by default, built at the
first such request, with the card's demo attention, ``ops/chip.py``);
``--taehv`` and ``--quantize`` set the defaults.  ``--warmup`` builds the
CUDA kernels and runs one throwaway stream before serving.  It runs on
the card unless ``--device cpu`` is given.  JPEG frames need ``cv2``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from self_forcing_tpu_torch.config import load_config
from self_forcing_tpu_torch.inference import TINY_VAE, _pseudo_encoder
from self_forcing_tpu_torch.models import taehv as taehv_mod
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import (LATENT_HEIGHT,
                                                       LATENT_WIDTH,
                                                       WAN_1_3B, WAN_TINY,
                                                       apply_model_kwargs)
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline)
from self_forcing_tpu_torch.serving.demo_server import DemoApp


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", default="configs/self_forcing_dmd.yaml")
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--port", type=int, default=5001)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--quantize", action="store_true",
                    help="quantized DiT linears by default (mode per "
                         "--quantize_mode or ops/chip.py)")
    ap.add_argument("--quantize_mode", default=None,
                    choices=["w8a8", "w8", "fp8"],
                    help="w8a8: int8 weights and activations (the W8A8 "
                         "kernels); w8: int8 weights; fp8: e4m3; default: "
                         "the card's entry of ops/chip.py")
    ap.add_argument("--taehv", action="store_true",
                    help="the TAEHV fast decoder by default")
    ap.add_argument("--taehv_checkpoint", default="checkpoints/taew2_1.pth")
    ap.add_argument("--fps", type=float, default=6.0)
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and run one throwaway stream "
                         "before accepting requests")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_app(args: argparse.Namespace) -> DemoApp:
    """The demo's ``DemoApp`` from parsed arguments, as ``main`` serves
    it."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    config = load_config(args.config_path, os.path.join(
        os.path.dirname(args.config_path), "default_config.yaml"))
    size = str(getattr(config, "model_size", "1.3b")).lower()

    if size == "tiny":
        cfg, dtype = WAN_TINY, torch.float32
        params = dit.init_params(cfg, 0, dtype, device, causal=True)
        vae_cfg = TINY_VAE
        vae_params = vae_mod.init_params(vae_cfg, seed=1, dtype=dtype,
                                         device=device)
        H = W = 8
        F = int(getattr(config, "num_frames", 3))
        encode = _pseudo_encoder(cfg.text_dim, device)
    else:
        from self_forcing_tpu_torch.runtime import load_wan_models
        cfg, dtype = WAN_1_3B, torch.bfloat16
        # the T5 stays on the host: DiT, KV cache and VAE hold the card
        models = load_wan_models(
            str(getattr(config, "model_dir", "wan_models")), model_cfg=cfg,
            checkpoint_path=args.checkpoint_path, dtype=dtype,
            t5_on_host=True, device=device)
        if models.vae_params is None:
            raise FileNotFoundError(f"no Wan2.1_VAE.pth under "
                                    f"{getattr(config, 'model_dir', '')}")
        params, vae_params, vae_cfg = (models.generator, models.vae_params,
                                       models.vae_cfg)
        encode = models.encode_text
        H, W, F = LATENT_HEIGHT, LATENT_WIDTH, 21
    # model_kwargs (local_attn_size, sink_size, ...: windowed streaming)
    cfg = apply_model_kwargs(cfg, config)
    pipeline = CausalInferencePipeline(config, params, cfg, device=device,
                                       dtype=dtype)

    def quantized_params_fn():
        """The quantized DiT tree, built at the first quantized request."""
        from self_forcing_tpu_torch.ops.quant import quantize_dit_params
        mode = args.quantize_mode
        if mode is None:
            from self_forcing_tpu_torch.ops.chip import chip_defaults
            mode = chip_defaults()["matmul_quant"]
        print(f"[demo] quantizing DiT linears ({mode})", flush=True)
        return quantize_dit_params(params, mode=mode,
                                   min_dim=64 if size == "tiny" else 512)

    # the chunk decoders: the streaming Wan VAE, and TAEHV where available
    state = {"cache": None}

    def reset_decoder():
        state["cache"] = None

    def decode_chunk(latents):
        """Latent block [1, n, 16, h, w] -> uint8 frames [T, H, W, 3] on
        the device (the first block of a video gives 1 + 4 (n - 1)
        frames, later ones 4 n)."""
        z = latents.to(torch.float32).permute(0, 1, 3, 4, 2)
        if state["cache"] is None:
            state["cache"] = vae_mod.init_decoder_cache(
                vae_params, vae_cfg, z.shape[0], z.shape[2], z.shape[3],
                torch.float32, z.device)
            out0, state["cache"] = vae_mod.decode_frame(
                vae_params, vae_cfg, z[:, :1], state["cache"], True)
            outs, rest = [out0], range(1, z.shape[1])
        else:
            outs, rest = [], range(z.shape[1])
        for i in rest:
            y, state["cache"] = vae_mod.decode_frame(
                vae_params, vae_cfg, z[:, i:i + 1], state["cache"], False)
            outs.append(y)
        px = torch.clamp(torch.cat(outs, dim=1) * 0.5 + 0.5, 0, 1)
        return (px[0] * 255).to(torch.uint8)

    taehv_decoder = None
    tae_params = None
    if os.path.exists(args.taehv_checkpoint):
        from self_forcing_tpu_torch.utils.checkpoints import (
            load_torch_state_dict)
        tae_params = taehv_mod.convert_taehv_state_dict(
            load_torch_state_dict(args.taehv_checkpoint), device=device)
    elif size == "tiny":   # random decoder weights
        tae_params = taehv_mod.init_decoder_params(seed=2, device=device)
    if tae_params is not None:
        streamer = taehv_mod.TAEHVStreamer(tae_params, overlap=3)

        def decode_chunk_tae(latents):
            px = streamer.decode_chunk(latents.to(torch.float32))
            return (torch.clamp(px[0].permute(0, 2, 3, 1), 0, 1)
                    * 255).to(torch.uint8)

        taehv_decoder = (decode_chunk_tae, streamer.reset)

    app = DemoApp(pipeline, encode, decode_chunk,
                  latent_shape=(1, F, 16, H, W), fps=args.fps,
                  reset_decoder_fn=reset_decoder,
                  taehv_decoder=taehv_decoder,
                  quantized_params_fn=quantized_params_fn,
                  default_taehv=args.taehv,
                  default_quantize=args.quantize)
    if args.warmup:
        # build every CUDA kernel (nvcc, all sources at once) and run one
        # throwaway stream, so the first request streams at steady speed
        t0 = time.perf_counter()
        print("[demo] warmup: building the kernels, one throwaway stream",
              flush=True)
        if device.type == "cuda":
            from self_forcing_tpu_torch.ops import build
            for name in build.build_all():
                build.load(name)
        g = torch.Generator(device=device).manual_seed(0)
        wnoise = torch.randn((1, F, 16, H, W), generator=g,
                             device=device).to(dtype)
        with torch.inference_mode():
            wctx = encode(["warmup"]).to(device, dtype)
            reset_decoder()
            for blk in pipeline.stream(wnoise, wctx, generator=g):
                decode_chunk(blk)
            reset_decoder()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"[demo] warmup done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    return app


def main(argv=None) -> None:
    args = parse_args(argv)
    build_app(args).serve(args.host, args.port)


if __name__ == "__main__":
    main()
