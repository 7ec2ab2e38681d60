"""CLIP (XLM-Roberta + ViT-H/14), the image encoder of image-to-video and
pose conditioning (port of ``self_forcing_tpu/models/clip.py``).

The vision tower gives the 257 x 1280 image tokens of the first 31 of its
32 layers (``use_31_block=True``), which the i2v DiT's ``img_emb`` takes;
the XLM-Roberta text tower (post-norm, pad keys masked) and its pooled
head are here for completeness.  The configuration is open-clip's
XLM-R-Large ViT-Huge-14: image 224, patch 14, vision dim 1280 x 32
layers x 16 heads (exact GELU), text dim 1024 x 24 layers, embed_dim 1024.

Parameters are a plain dict with the JAX package's keys: blocks stacked
on axis 0, linear weights [in, out], the patch embedding a
[ph * pw * 3, dim] matrix over patches flattened in (ph, pw, C) order.
Attention is plain PyTorch (matmul, float32 scores, softmax), as the JAX
package computes it with einsums outside any Pallas kernel; layer norms
compute in float32.  The tower runs in float32, as ``load_clip_vision``
loads it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.utils import tree

Params = dict

# CLIP's normalization constants (the reference's torchvision transforms)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 1024
    image_size: int = 224
    patch_size: int = 14
    vision_dim: int = 1280
    vision_mlp_ratio: float = 4
    vision_heads: int = 16
    vision_layers: int = 32
    activation: str = "gelu"
    vocab_size: int = 250002
    max_text_len: int = 514
    pad_id: int = 1
    text_dim: int = 1024
    text_heads: int = 16
    text_layers: int = 24
    eps: float = 1e-5


CLIP_XLM_ROBERTA_VIT_H_14 = CLIPConfig()
CLIP_TINY = CLIPConfig(embed_dim=16, image_size=28, patch_size=14,
                       vision_dim=32, vision_heads=2, vision_layers=3,
                       vocab_size=128, max_text_len=16, text_dim=32,
                       text_heads=2, text_layers=2)

# the reference's weights file of the vision tower
CLIP_WEIGHTS = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"


def _ln(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * p["w"] + p["b"]).to(x.dtype)


def _lin(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = x @ p["w"]
    return out + p["b"] if "b" in p else out


def _attn(p: Params, x: torch.Tensor, num_heads: int,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional self-attention with a fused qkv projection, scores in
    float32.  ``mask``: optional bool [B, L]; False keys are excluded (the
    text tower masks its pad positions)."""
    B, L, C = x.shape
    qkv = _lin(p["to_qkv"], x).reshape(B, L, 3, num_heads, -1)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, N, L, d]
    d = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (d ** -0.5)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = (a @ v).transpose(1, 2).reshape(B, L, C)
    return _lin(p["proj"], o)


def _mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = _lin(p["fc1"], x)
    if activation == "quick_gelu":
        h = h * torch.sigmoid(1.702 * h)
    else:
        h = F.gelu(h, approximate="none")
    return _lin(p["fc2"], h)


def _block(p: Params, x: torch.Tensor, num_heads: int, activation: str,
           eps: float, post_norm: bool = False,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    if post_norm:  # XLM-R
        x = _ln(p["norm1"], x + _attn(p["attn"], x, num_heads, mask), eps)
        return _ln(p["norm2"], x + _mlp(p["mlp"], x, activation), eps)
    # ViT, pre-norm
    x = x + _attn(p["attn"], _ln(p["norm1"], x, eps), num_heads, mask)
    return x + _mlp(p["mlp"], _ln(p["norm2"], x, eps), activation)


# ---------------------------------------------------------------- vision

def vision_forward(params: Params, cfg: CLIPConfig, x: torch.Tensor,
                   use_31_block: bool = True) -> torch.Tensor:
    """x: [B, 3, H, W] normalized -> tokens [B, 1 + patches, vision_dim]:
    the class token and the patch tokens after all layers but the last
    (``use_31_block``), or after every layer and the post-norm."""
    B = x.shape[0]
    ph = cfg.patch_size
    xt = x.permute(0, 2, 3, 1)                       # NHWC
    h, w = xt.shape[1] // ph, xt.shape[2] // ph
    xt = xt.reshape(B, h, ph, w, ph, 3).permute(0, 1, 3, 2, 4, 5)
    tokens = _lin(params["patch_embedding"], xt.reshape(B, h * w,
                                                        ph * ph * 3))
    cls = params["cls_embedding"].to(tokens.dtype).expand(
        B, 1, cfg.vision_dim)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + params["pos_embedding"].to(tokens.dtype)
    tokens = _ln(params["pre_norm"], tokens, cfg.eps)
    n_layers = cfg.vision_layers - (1 if use_31_block else 0)
    for i in range(n_layers):
        tokens = _block(tree.index(params["blocks"], i), tokens,
                        cfg.vision_heads, cfg.activation, cfg.eps)
    if not use_31_block:
        tokens = _ln(params["post_norm"], tokens, cfg.eps)
    return tokens


def _torch_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Interpolation matrix [out, in] of ``F.interpolate(mode='bicubic',
    align_corners=False, antialias=False)``: cubic convolution with
    a = -0.75, no antialias prefilter, border taps clamped to the edge
    (not the Keys a = -0.5 antialiased cubic of ``jax.image.resize``)."""
    a = -0.75
    scale = in_size / out_size
    W = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            t = abs(x - (x0 + k))
            if t <= 1:
                w = (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
            elif t < 2:
                w = a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
            else:
                w = 0.0
            W[i, int(np.clip(x0 + k, 0, in_size - 1))] += w
    return W


def preprocess_images(images: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> resized to image_size (the bicubic
    above, in float32) and CLIP-normalized: ((x * 0.5 + 0.5) - mean) /
    std."""
    H, W = images.shape[-2:]
    dev = images.device
    wh = torch.from_numpy(_torch_bicubic_matrix(H, cfg.image_size)).to(dev)
    ww = torch.from_numpy(_torch_bicubic_matrix(W, cfg.image_size)).to(dev)
    x = torch.einsum("oh,bchw->bcow", wh, images.float())
    x = torch.einsum("pw,bcow->bcop", ww, x).to(images.dtype)
    x = x * 0.5 + 0.5
    mean = torch.from_numpy(CLIP_MEAN).to(dev)[None, :, None, None]
    std = torch.from_numpy(CLIP_STD).to(dev)[None, :, None, None]
    return (x - mean) / std


def encode_image(params: Params, cfg: CLIPConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """The i2v conditioning path: [B, 3, H, W] in [-1, 1] -> the 31-layer
    vision tokens [B, 257, 1280]."""
    return vision_forward(params, cfg, preprocess_images(images, cfg),
                          use_31_block=True)


# ---------------------------------------------------------------- text

def text_forward(params: Params, cfg: CLIPConfig,
                 ids: torch.Tensor) -> torch.Tensor:
    """The XLM-Roberta tower: embeddings (RoBERTa position ids: pad
    positions keep pad_id, the others count from pad_id + 1) and the
    post-norm blocks with the pad keys masked -> [B, L, text_dim]."""
    mask = ids != cfg.pad_id
    pos = torch.cumsum(mask.long(), dim=1) * mask + cfg.pad_id
    x = (params["token_embedding"][ids] + params["pos_embedding"][pos]
         + params["type_embedding"][0])
    x = _ln(params["norm_emb"], x, cfg.eps)
    for i in range(cfg.text_layers):
        x = _block(tree.index(params["blocks"], i), x, cfg.text_heads,
                   "gelu", cfg.eps, post_norm=True, mask=mask)
    return x


def text_pooled(params: Params, cfg: CLIPConfig,
                ids: torch.Tensor) -> torch.Tensor:
    """The text head: the mean of the non-pad tokens through an exact-GELU
    MLP to embed_dim."""
    x = text_forward(params, cfg, ids)
    mask = (ids != cfg.pad_id).to(x.dtype)[..., None]
    pooled = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
    h = F.gelu(pooled @ params["head"]["fc1"]["w"], approximate="none")
    return h @ params["head"]["fc2"]["w"]


# ---------------------------------------------------------------- init

def _lin_init(g, din, dout, dtype, device, bias=True) -> Params:
    lim = 1 / math.sqrt(din)
    w = (torch.rand(din, dout, generator=g, device=device) * 2 - 1) * lim
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(dout, dtype=dtype, device=device)
    return p


def _norm_init(dim, dtype, device) -> Params:
    return {"w": torch.ones(dim, dtype=dtype, device=device),
            "b": torch.zeros(dim, dtype=dtype, device=device)}


def _block_init(g, dim, mlp_dim, dtype, device) -> Params:
    return {
        "norm1": _norm_init(dim, dtype, device),
        "attn": {"to_qkv": _lin_init(g, dim, dim * 3, dtype, device),
                 "proj": _lin_init(g, dim, dim, dtype, device)},
        "norm2": _norm_init(dim, dtype, device),
        "mlp": {"fc1": _lin_init(g, dim, mlp_dim, dtype, device),
                "fc2": _lin_init(g, mlp_dim, dim, dtype, device)},
    }


def _randn(g, shape, scale, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def init_vision_params(cfg: CLIPConfig, seed: int = 0,
                       dtype=torch.float32,
                       device: str | torch.device = "cuda") -> Params:
    """Random vision-tower parameters from a ``torch.Generator`` seeded
    with ``seed`` on ``device``; each layer is drawn and copied into the
    preallocated stack before the next.  The patch embedding has no bias
    (the reference's pre-norm tower)."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = cfg.vision_dim
    P = (cfg.image_size // cfg.patch_size) ** 2
    gain = 1.0 / math.sqrt(d)
    mlp = int(d * cfg.vision_mlp_ratio)
    return {
        "patch_embedding": {"w": _randn(
            g, (cfg.patch_size * cfg.patch_size * 3, d), gain, dtype,
            device)},
        "cls_embedding": _randn(g, (1, 1, d), gain, dtype, device),
        "pos_embedding": _randn(g, (1, P + 1, d), gain, dtype, device),
        "pre_norm": _norm_init(d, dtype, device),
        "post_norm": _norm_init(d, dtype, device),
        "blocks": tree.stack((_block_init(g, d, mlp, dtype, device)
                              for _ in range(cfg.vision_layers)),
                             cfg.vision_layers),
    }


def init_text_params(cfg: CLIPConfig, seed: int = 0, dtype=torch.float32,
                     device: str | torch.device = "cuda") -> Params:
    """Random text-tower parameters (as :func:`init_vision_params`)."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = cfg.text_dim
    mid = (d + cfg.embed_dim) // 2
    return {
        "token_embedding": _randn(g, (cfg.vocab_size, d), 0.02, dtype,
                                  device),
        "pos_embedding": _randn(g, (cfg.max_text_len, d), 0.02, dtype,
                                device),
        "type_embedding": _randn(g, (1, d), 0.02, dtype, device),
        "norm_emb": _norm_init(d, dtype, device),
        "blocks": tree.stack((_block_init(g, d, d * 4, dtype, device)
                              for _ in range(cfg.text_layers)),
                             cfg.text_layers),
        "head": {"fc1": _lin_init(g, d, mid, dtype, device, bias=False),
                 "fc2": _lin_init(g, mid, cfg.embed_dim, dtype, device,
                                  bias=False)},
    }


# ---------------------------------------------------------------- convert

def convert_clip_vision_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig,
                                   dtype=torch.float32,
                                   device: str | torch.device = "cuda"
                                   ) -> Params:
    """The reference XLMRobertaCLIP state dict's ``visual.`` subtree -> the
    vision tree (linear weights transposed to [in, out], the patch conv
    [D, 3, ph, pw] flattened in (ph, pw, C) order)."""
    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return x.to(device=device, dtype=dtype).contiguous()

    def lin(name):
        p = {"w": put(torch.as_tensor(sd[name + ".weight"]).T)}
        if name + ".bias" in sd:
            p["b"] = put(sd[name + ".bias"])
        return p

    def ln(name):
        return {"w": put(sd[name + ".weight"]), "b": put(sd[name + ".bias"])}

    pe = torch.as_tensor(sd["visual.patch_embedding.weight"])  # [D,3,ph,pw]
    out: Params = {
        "patch_embedding": {"w": put(pe.permute(2, 3, 1, 0).reshape(
            -1, pe.shape[0]))},
        "cls_embedding": put(sd["visual.cls_embedding"]),
        "pos_embedding": put(sd["visual.pos_embedding"]),
        "pre_norm": ln("visual.pre_norm"),
        "post_norm": ln("visual.post_norm"),
    }
    if "visual.patch_embedding.bias" in sd:
        out["patch_embedding"]["b"] = put(sd["visual.patch_embedding.bias"])

    def block(i):
        pre = f"visual.transformer.{i}"
        return {"norm1": ln(pre + ".norm1"),
                "attn": {"to_qkv": lin(pre + ".attn.to_qkv"),
                         "proj": lin(pre + ".attn.proj")},
                "norm2": ln(pre + ".norm2"),
                "mlp": {"fc1": lin(pre + ".mlp.0"),
                        "fc2": lin(pre + ".mlp.2")}}

    out["blocks"] = tree.stack((block(i) for i in range(cfg.vision_layers)),
                               cfg.vision_layers)
    return out
