"""Model wrappers with the reference's names and call conventions (port
of ``self_forcing_tpu/wrappers.py``): ``WanTextEncoder``,
``WanVAEWrapper`` and ``WanDiffusionWrapper``, thin callables over
``models/wan/{t5,vae,dit}.py`` and ``scheduler.py``.

Only the t2v DiT is ported: the classify mode and its GAN head, the CLIP
image features, the i2v ``y`` conditioning and pose conditioning raise
``NotImplementedError`` (ROADMAP Queue A item 6).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import t5 as t5_mod
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B, WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.ops.masks import (block_causal_mask,
                                              block_causal_mask_i2v,
                                              teacher_forcing_mask)
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler
from self_forcing_tpu_torch.utils import tree

_ITEM_6 = "is not ported (ROADMAP Queue A item 6)"


class WanTextEncoder:
    """umt5-xxl callable: prompts -> {'prompt_embeds': [B, 512, 4096]}
    with the padding zeroed."""

    def __init__(self, params, cfg: t5_mod.T5Config = t5_mod.UMT5_XXL,
                 tokenizer=None, seq_len: int = 512):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.seq_len = seq_len

    def __call__(self, text_prompts: List[str]) -> dict:
        if self.tokenizer is None:
            raise ValueError("WanTextEncoder: construct with a tokenizer")
        ids, mask = self.tokenizer(text_prompts)
        return {"prompt_embeds": t5_mod.encode_for_dit(self.params, self.cfg,
                                                       ids, mask)}


class WanVAEWrapper:
    """``encode_to_latent`` / ``decode_to_pixel`` at the reference's
    channels-first boundary ([B, T, C, H, W]); the Wan latent
    normalization lives in ``models/wan/vae.py``."""

    def __init__(self, params, cfg: vae_mod.VAEConfig = vae_mod.WAN_VAE):
        self.params = params
        self.cfg = cfg
        self._cache = None

    def encode_to_latent(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, T_px, 3, H, W] in [-1, 1] -> [B, T_lat, 16, H/8, W/8]."""
        z = vae_mod.encode(self.params, self.cfg,
                           pixels.permute(0, 1, 3, 4, 2))
        return z.permute(0, 1, 4, 2, 3)

    def decode_to_pixel(self, latent: torch.Tensor,
                        use_cache: bool = False) -> torch.Tensor:
        """[B, T_lat, 16, h, w] -> [B, T_px, 3, H, W] in [-1, 1].
        ``use_cache=True`` streams: the decoder's conv caches carry over
        from one call to the next (``reset_cache`` starts anew)."""
        z = latent.permute(0, 1, 3, 4, 2)
        if not use_cache:
            return vae_mod.decode(self.params, self.cfg, z).permute(
                0, 1, 4, 2, 3)
        first = self._cache is None
        if first:
            self._cache = vae_mod.init_decoder_cache(
                self.params, self.cfg, z.shape[0], z.shape[2], z.shape[3],
                z.dtype, z.device)
        px, self._cache = vae_mod.decode_block(self.params, self.cfg, z,
                                               self._cache, first=first)
        return px.clamp(-1, 1).permute(0, 1, 4, 2, 3)

    def reset_cache(self):
        self._cache = None


class WanDiffusionWrapper:
    """One facade over the causal / bidirectional t2v DiT: the KV-cached
    streaming forward, teacher forcing (``clean_x``) and the cache-free
    forward, returning (flow_pred, pred_x0) as the reference does, with
    the new cache beside them on the cached path."""

    def __init__(self, params, model_cfg: WanConfig = WAN_1_3B,
                 is_causal: bool = True, timestep_shift: float = 5.0):
        self.params = params
        self.cfg = model_cfg
        self.is_causal = is_causal
        self.uniform_timestep = not is_causal
        device = tree.leaves(params)[0].device
        self.rope = RopeTables.create(model_cfg.head_dim, device=device)
        self.scheduler = FlowMatchScheduler.create(
            1000, shift=timestep_shift, training=True, device=device)
        self.seq_len = 32760  # 21 frames x 1560 tokens

    def get_scheduler(self) -> FlowMatchScheduler:
        return self.scheduler

    def _mask_for(self, num_frames: int, frame_seqlen: int):
        make = (block_causal_mask_i2v if self.cfg.independent_first_frame
                else block_causal_mask)
        return make(num_frames, frame_seqlen, self.cfg.num_frame_per_block,
                    self.cfg.local_attn_size)

    def __call__(self, *a, **k):
        return self.forward(*a, **k)

    def forward(self, noisy_image_or_video: torch.Tensor,
                conditional_dict: dict, timestep: torch.Tensor,
                kv_cache: Optional[dit.KVCache] = None,
                crossattn_cache: Optional[dict] = None,
                current_start: Optional[int] = None,
                cache_start: Optional[int] = None,
                classify_mode: bool = False,
                concat_time_embeddings: bool = False,
                clean_x: Optional[torch.Tensor] = None,
                aug_t: Optional[torch.Tensor] = None,
                add_condition: Optional[torch.Tensor] = None,
                clip_feature: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None):
        if classify_mode or concat_time_embeddings:
            raise NotImplementedError(f"the classify mode {_ITEM_6}")
        for name, v in (("add_condition", add_condition),
                        ("clip_feature", clip_feature), ("y", y)):
            if v is not None or conditional_dict.get(name) is not None:
                raise NotImplementedError(f"{name} conditioning {_ITEM_6}")
        x = noisy_image_or_video
        B, F, C, H, W = x.shape
        fs = (H // self.cfg.patch_size[1]) * (W // self.cfg.patch_size[2])
        context = conditional_dict["prompt_embeds"]
        t = torch.as_tensor(timestep, dtype=torch.float32, device=x.device)
        if t.ndim == 1:
            t = t[:, None].expand(B, F)

        new_cache = None
        if kv_cache is not None:
            ctx_kv = (crossattn_cache if crossattn_cache is not None
                      else dit.precompute_context(self.params, self.cfg,
                                                  context))
            flow, new_cache = dit.forward_inference(
                self.params, self.cfg, x, t, ctx_kv, kv_cache,
                (current_start or 0) // fs, self.rope,
                cache_start_frame=(None if cache_start is None
                                   else cache_start // fs))
        elif clean_x is not None:
            mask = teacher_forcing_mask(F, fs, self.cfg.num_frame_per_block)
            flow = dit.forward_train(self.params, self.cfg, x, t, context,
                                     mask, self.rope, clean_x=clean_x,
                                     aug_t=aug_t)
        else:
            mask = self._mask_for(F, fs) if self.is_causal else None
            flow = dit.forward_train(self.params, self.cfg, x, t, context,
                                     mask, self.rope)

        def flat(a):
            return a.reshape((B * F,) + a.shape[2:])
        pred_x0 = self.scheduler.convert_flow_pred_to_x0(
            flat(flow), flat(x), t.reshape(-1)).reshape(x.shape)
        if new_cache is not None:
            return (flow, pred_x0), new_cache
        return flow, pred_x0

    def adding_cls_branch(self, *args, **kwargs):
        raise NotImplementedError(f"the GAN classify branch {_ITEM_6}")
