"""Model loading: find the reference's checkpoint files under a model
directory and convert them into the port's trees (port of
``self_forcing_tpu/runtime.py``).

The layout looked for:
- Wan2.1-T2V-1.3B/  (a diffusers directory of *.safetensors, or one .pth)
- models_t5_umt5-xxl-enc-bf16.pth
- Wan2.1_VAE.pth
- google/umt5-xxl/  (the tokenizer)
- self_forcing_dmd.pt  ({'generator', 'generator_ema'[, 'critic']})

A missing DiT raises; a missing T5, tokenizer or VAE leaves its field
None.  Everything lands on ``device`` ("cuda" unless the caller asks for
the CPU); ``t5_on_host`` keeps the T5 encoder on the host, and
``encode_text`` then streams it to the device one layer at a time.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional

import torch

from self_forcing_tpu_torch.models.wan import t5 as t5_mod
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B, WanConfig
from self_forcing_tpu_torch.utils import checkpoints as ckpt
from self_forcing_tpu_torch.utils import tree

# the shared negative prompt of the reference's configs
NEGATIVE_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)


@dataclasses.dataclass
class WanModels:
    generator: Optional[dict]
    generator_cfg: WanConfig
    t5_params: Optional[dict] = None
    t5_cfg: Optional[t5_mod.T5Config] = None
    vae_params: Optional[dict] = None
    vae_cfg: Optional[vae_mod.VAEConfig] = None
    tokenizer: Optional[object] = None
    negative_prompt: str = NEGATIVE_PROMPT
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"))

    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        """Prompts -> DiT context [B, seq_len, 4096], padding zeroed."""
        if self.t5_params is None or self.tokenizer is None:
            raise ValueError("encode_text needs the T5 encoder and its "
                             "tokenizer (models_t5_umt5-xxl-enc-bf16.pth and "
                             "google/umt5-xxl under the model directory)")
        ids, mask = self.tokenizer(prompts)
        on = tree.leaves(self.t5_params)[0].device
        if on.type != torch.device(self.device).type:
            # the host-resident encoder (t5_on_host=True)
            return t5_mod.encode_streamed(self.t5_params, self.t5_cfg, ids,
                                          mask, device=self.device)
        return t5_mod.encode_for_dit(self.t5_params, self.t5_cfg, ids, mask)


def _find(model_dir: str, *patterns: str) -> Optional[str]:
    """The first match of the first pattern that matches (sorted);
    '**/' recurses."""
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(model_dir, pat),
                                recursive=True))
        if hits:
            return hits[0]
    return None


def load_dit_params(model_dir: str, cfg: WanConfig,
                    checkpoint_path: str | None = None,
                    checkpoint_key: str = "generator_ema",
                    dtype=torch.bfloat16,
                    device: str | torch.device = "cuda") -> dict:
    """The Wan base DiT (a directory of safetensors shards, or one .pth /
    .pt), with a self-forcing checkpoint's state dict laid over it when
    given, as ``load_state_dict(strict=False)`` would: the checkpoint's
    keys replace the base's, the others keep the base weights."""
    base_dir = _find(model_dir, "Wan2.1-T2V-1.3B", "Wan2.1-T2V-14B",
                     "wan_models/Wan2.1-T2V-1.3B") or model_dir
    sd = {}
    for shard in sorted(glob.glob(os.path.join(base_dir, "*.safetensors"))):
        sd.update(ckpt.load_torch_state_dict(shard))
    if not sd:
        pth = _find(base_dir, "*.pth", "*.pt")
        if pth:
            sd = ckpt.load_torch_state_dict(pth)
    if not sd:
        raise FileNotFoundError(f"no DiT weights under {base_dir}")

    if checkpoint_path:
        st = ckpt.load_torch_state_dict(checkpoint_path)
        if checkpoint_key in st:
            st = st[checkpoint_key]
        elif "generator" in st:
            st = st["generator"]
        sd = {**sd, **ckpt.strip_prefix(st, "model.")}
    return ckpt.convert_dit_state_dict(sd, cfg, dtype, device=device)


def load_wan_models(model_dir: str, model_cfg: WanConfig | None = None,
                    checkpoint_path: str | None = None,
                    checkpoint_key: str = "generator_ema",
                    dtype=torch.bfloat16,
                    load_t5: bool = True, load_vae: bool = True,
                    load_dit: bool = True,
                    t5_on_host: bool = False,
                    device: str | torch.device = "cuda") -> WanModels:
    """``load_dit=False`` skips the DiT for callers that hold one already
    (a trainer); the VAE loads in float32, as in the JAX package.  The
    JAX signature's ``causal`` is not taken: both DiTs share one
    checkpoint layout."""
    device = torch.device(device)
    cfg = model_cfg or WAN_1_3B
    generator = None
    if load_dit:
        generator = load_dit_params(model_dir, cfg, checkpoint_path,
                                    checkpoint_key, dtype, device)

    t5_params = t5_cfg = vae_params = vae_cfg = tokenizer = None
    if load_t5:
        t5_path = _find(model_dir, "models_t5_umt5-xxl-enc-bf16.pth",
                        "**/models_t5_umt5-xxl-enc-bf16.pth")
        if t5_path:
            t5_cfg = t5_mod.UMT5_XXL
            t5_params = ckpt.convert_t5_state_dict(
                ckpt.load_torch_state_dict(t5_path), t5_cfg, dtype,
                device="cpu" if t5_on_host else device)
            if t5_on_host and device.type == "cuda":
                # pinned: each streamed layer's copy runs at full rate
                t5_params = tree.map_tree(lambda t: t.pin_memory(),
                                          t5_params)
        tok_path = _find(model_dir, "google/umt5-xxl", "**/google/umt5-xxl")
        if tok_path:
            from self_forcing_tpu_torch.tokenizer import HuggingfaceTokenizer
            tokenizer = HuggingfaceTokenizer(tok_path, seq_len=512,
                                             clean="whitespace")
    if load_vae:
        vae_path = _find(model_dir, "Wan2.1_VAE.pth", "**/Wan2.1_VAE.pth")
        if vae_path:
            vae_cfg = vae_mod.WAN_VAE
            vae_params = ckpt.convert_vae_state_dict(
                ckpt.load_torch_state_dict(vae_path), vae_cfg,
                torch.float32, device=device)

    return WanModels(generator=generator, generator_cfg=cfg,
                     t5_params=t5_params, t5_cfg=t5_cfg,
                     vae_params=vae_params, vae_cfg=vae_cfg,
                     tokenizer=tokenizer, device=device)
