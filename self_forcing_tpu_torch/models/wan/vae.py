"""Wan2.1 3D causal VAE, decode half (port of
``self_forcing_tpu/models/wan/vae.py``).

The public functions keep the JAX package's channels-last layout:
latents [B, T, h, w, z] in, pixels [B, T, H, W, 3] out.  Inside, a
tensor is logically [B, C, T, H, W] so that torch's conv3d/conv2d (cuDNN
on the card) take it; a permuted channels-last tensor is exactly
``torch.channels_last_3d``, so no copy is made at the boundary.  Conv
weights are in torch's layout (OIDHW / OIHW; ``params.params_from_jax``
converts the JAX tree).  The per-conv streaming caches hold the last
CACHE_T input frames, [B, C, 2, h, w], in decoder visit order.

The encoder is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

Params = dict
CACHE_T = 2

LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: tuple[bool, ...] = (False, True, True)

    @property
    def temperal_upsample(self) -> tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))


WAN_VAE = VAEConfig()
VAE_TINY = VAEConfig(dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


# ============================================================ primitives

def causal_conv3d(p: Params, x: torch.Tensor, cache: torch.Tensor | None,
                  stride=(1, 1, 1), kernel=(3, 3, 3)):
    """Temporally causal conv3d; x [B, C, T, H, W].  ``cache`` holds the
    previous kt-1 input frames (zeros = causal zero padding) or is None
    for kt == 1.  Returns (y, new_cache)."""
    kt = kernel[0]
    pad = (0, kernel[1] // 2, kernel[2] // 2)
    if kt == 1:
        return F.conv3d(x, p["w"], p["b"], stride, pad), cache
    if cache is None:
        cache = x.new_zeros((x.shape[0], x.shape[1], kt - 1, *x.shape[3:]))
    xin = torch.cat([cache.to(x.dtype), x], dim=2)
    y = F.conv3d(xin, p["w"], p["b"], stride, pad)
    T = x.shape[2]
    if T >= kt - 1:
        new_cache = x[:, :, -(kt - 1):]
    else:
        new_cache = torch.cat([cache[:, :, -(kt - 1 - T):].to(x.dtype), x],
                              dim=2)
    return y, new_cache


def rms_norm_channel(gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """F.normalize over channels * sqrt(C) * gamma; x [B, C, T, H, W].

    x / sqrt(sum x^2 + 1e-24) * sqrt(C) == x / sqrt(mean x^2 + 1e-24 / C),
    so this is an RMS norm over the channel axis, computed in fp32 by one
    fused pass over the channels-last view."""
    C = x.shape[1]
    xc = x.permute(0, 2, 3, 4, 1)
    y = F.rms_norm(xc.float(), (C,), gamma.float(), eps=1e-24 / C)
    return y.to(x.dtype).permute(0, 4, 1, 2, 3)


# ============================================================ blocks

def residual_block(p: Params, x: torch.Tensor, cache: list):
    """ResidualBlock; consumes 2 cache slots."""
    if p.get("shortcut"):
        h, _ = causal_conv3d(p["shortcut"], x, None, kernel=(1, 1, 1))
    else:
        h = x
    y = F.silu(rms_norm_channel(p["norm1"], x))
    y, c0 = causal_conv3d(p["conv1"], y, cache[0])
    y = F.silu(rms_norm_channel(p["norm2"], y))
    y, c1 = causal_conv3d(p["conv2"], y, cache[1])
    return y + h, [c0, c1]


def attention_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Single-head spatial self-attention per frame (plain torch, as the
    JAX package leaves it to XLA)."""
    B, C, T, H, W = x.shape
    h = rms_norm_channel(p["norm"], x)
    h = h.permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C)
    qkv = h @ p["to_qkv"]["w"] + p["to_qkv"]["b"]
    q, k, v = qkv.chunk(3, dim=-1)
    scores = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * C ** -0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.bmm(probs, v)
    o = o @ p["proj"]["w"] + p["proj"]["b"]
    return x + o.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)


def _spatial_resample_up(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample + 3x3 conv to C/2, per frame."""
    B, C, T, H, W = x.shape
    x2 = x.permute(0, 2, 1, 3, 4).reshape(B * T, C, H, W)
    x2 = F.interpolate(x2, scale_factor=2.0, mode="nearest")
    y = F.conv2d(x2, p["conv"]["w"], p["conv"]["b"], padding=1)
    return y.reshape(B, T, -1, 2 * H, 2 * W).permute(0, 2, 1, 3, 4)


def upsample3d(p: Params, x: torch.Tensor, cache_entry, first: bool):
    """Temporal + spatial 2x upsample.  On the first latent frame the
    temporal conv is skipped and the next frame convolves against zeros;
    afterwards time_conv (C -> 2C) doubles T by interleaving the two
    channel groups."""
    B, C, T, H, W = x.shape
    if first:
        return (_spatial_resample_up(p, x),
                x.new_zeros((B, C, CACHE_T, H, W)))
    y, new_cache = causal_conv3d(p["time_conv"], x, cache_entry,
                                 kernel=(3, 1, 1))
    # channels-last [B, T, H, W, (2, C)] -> [B, (T, 2), H, W, C]: frame
    # 2t + i takes channel group i
    y = y.permute(0, 2, 3, 4, 1).reshape(B, T, H, W, 2, C)
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(B, 2 * T, H, W, C)
    return _spatial_resample_up(p, y.permute(0, 4, 1, 2, 3)), new_cache


# ============================================================ init

def _conv_init(g, cin, cout, kernel, dtype, device):
    fan_in = cin * int(np.prod(kernel))
    lim = 1 / math.sqrt(fan_in)

    def u(*shape):
        return ((torch.rand(*shape, generator=g, device=device) * 2 - 1)
                * lim).to(dtype)

    return {"w": u(cout, cin, *kernel), "b": u(cout)}


def _res_init(g, cin, cout, dtype, device):
    p = {
        "norm1": torch.ones(cin, dtype=dtype, device=device),
        "conv1": _conv_init(g, cin, cout, (3, 3, 3), dtype, device),
        "norm2": torch.ones(cout, dtype=dtype, device=device),
        "conv2": _conv_init(g, cout, cout, (3, 3, 3), dtype, device),
    }
    if cin != cout:
        p["shortcut"] = _conv_init(g, cin, cout, (1, 1, 1), dtype, device)
    return p


def _attn_init(g, c, dtype, device):
    lim = 1 / math.sqrt(c)
    w = (torch.rand(c, 3 * c, generator=g, device=device) * 2 - 1) * lim
    return {
        "norm": torch.ones(c, dtype=dtype, device=device),
        "to_qkv": {"w": w.to(dtype),
                   "b": torch.zeros(3 * c, dtype=dtype, device=device)},
        "proj": {"w": torch.zeros(c, c, dtype=dtype, device=device),
                 "b": torch.zeros(c, dtype=dtype, device=device)},
    }


def init_params(cfg: VAEConfig = WAN_VAE, seed: int = 0,
                dtype=torch.float32,
                device: str | torch.device = "cuda") -> Params:
    """Random decoder-side parameters ("conv2" + "decoder"), drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    ddims = [cfg.dim * u for u in (cfg.dim_mult[-1],)
             + tuple(reversed(cfg.dim_mult))]
    dec: Params = {"conv1": _conv_init(g, cfg.z_dim, ddims[0], (3, 3, 3),
                                       dtype, device)}
    dec["mid_res1"] = _res_init(g, ddims[0], ddims[0], dtype, device)
    dec["mid_attn"] = _attn_init(g, ddims[0], dtype, device)
    dec["mid_res2"] = _res_init(g, ddims[0], ddims[0], dtype, device)
    stages = []
    for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2   # the previous upsample halved the channels
        blocks = []
        c = cin
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_res_init(g, c, cout, dtype, device))
            c = cout
        stage = {"blocks": blocks}
        if i != len(cfg.dim_mult) - 1:
            stage["resample"] = {"conv": _conv_init(g, cout, cout // 2,
                                                    (3, 3), dtype, device)}
            if cfg.temperal_upsample[i]:
                stage["resample"]["time_conv"] = _conv_init(
                    g, cout, cout * 2, (3, 1, 1), dtype, device)
        stages.append(stage)
    dec["stages"] = stages
    dec["head_norm"] = torch.ones(ddims[-1], dtype=dtype, device=device)
    dec["head_conv"] = _conv_init(g, ddims[-1], 3, (3, 3, 3), dtype, device)
    return {"conv2": _conv_init(g, cfg.z_dim, cfg.z_dim, (1, 1, 1), dtype,
                                device),
            "decoder": dec}


# ============================================================ decoder

def _decoder_pass(p: Params, cfg: VAEConfig, x: torch.Tensor, cache: list,
                  first: bool):
    """Decoder3d forward; the cache is consumed in visit order."""
    new_cache = list(cache)
    slot = iter(range(len(cache)))

    def res(bp, x):
        i0, i1 = next(slot), next(slot)
        x, (new_cache[i0], new_cache[i1]) = residual_block(
            bp, x, [cache[i0], cache[i1]])
        return x

    i = next(slot)
    x, new_cache[i] = causal_conv3d(p["conv1"], x, cache[i])
    x = res(p["mid_res1"], x)
    x = attention_block(p["mid_attn"], x)
    x = res(p["mid_res2"], x)
    for stage in p["stages"]:
        for bp in stage["blocks"]:
            x = res(bp, x)
        if "resample" in stage:
            if "time_conv" in stage["resample"]:
                i = next(slot)
                x, new_cache[i] = upsample3d(stage["resample"], x, cache[i],
                                             first)
            else:
                x = _spatial_resample_up(stage["resample"], x)
    x = F.silu(rms_norm_channel(p["head_norm"], x))
    i = next(slot)
    x, new_cache[i] = causal_conv3d(p["head_conv"], x, cache[i])
    return x, new_cache


def init_decoder_cache(params: Params, cfg: VAEConfig, batch: int,
                       latent_h: int, latent_w: int, dtype=torch.float32,
                       device: str | torch.device = "cuda") -> list:
    """Zero caches in decoder visit order, [B, C, CACHE_T, h, w] each."""
    h, w = latent_h, latent_w
    cache = []
    p = params["decoder"]

    def conv_cache(conv):
        c = conv["w"].shape[1]
        cache.append(torch.zeros(batch, CACHE_T, h, w, c, dtype=dtype,
                                 device=device).permute(0, 4, 1, 2, 3))

    conv_cache(p["conv1"])
    for res in (p["mid_res1"], p["mid_res2"]):
        conv_cache(res["conv1"])
        conv_cache(res["conv2"])
    for stage in p["stages"]:
        for bp in stage["blocks"]:
            conv_cache(bp["conv1"])
            conv_cache(bp["conv2"])
        if "resample" in stage:
            if "time_conv" in stage["resample"]:
                conv_cache(stage["resample"]["time_conv"])
            h, w = h * 2, w * 2
    conv_cache(p["head_conv"])
    return cache


def decode_frame(params: Params, cfg: VAEConfig, z: torch.Tensor,
                 cache: list, first: bool):
    """Decode latent frames [B, T, h, w, z] (one frame on the streaming
    path) -> (pixels [B, T', H, W, 3], new cache).  The first frame yields
    1 pixel frame, each later one 4."""
    zc = z.shape[-1]
    mean = torch.as_tensor(LATENT_MEAN[:zc], dtype=z.dtype, device=z.device)
    std = torch.as_tensor(LATENT_STD[:zc], dtype=z.dtype, device=z.device)
    x = (z * std + mean).permute(0, 4, 1, 2, 3)
    x, _ = causal_conv3d(params["conv2"], x, None, kernel=(1, 1, 1))
    y, cache = _decoder_pass(params["decoder"], cfg, x, cache, first)
    return y.permute(0, 2, 3, 4, 1), cache


def decode_block(params: Params, cfg: VAEConfig, z: torch.Tensor,
                 cache: list, first: bool):
    """Decode a multi-frame latent block frame by frame with a carried
    cache.  z: [B, T, h, w, zc] -> (pixels [B, T*4 (-3 if first), H, W, 3],
    new cache).  No clipping."""
    outs = []
    for i in range(z.shape[1]):
        y, cache = decode_frame(params, cfg, z[:, i:i + 1], cache,
                                first=first and i == 0)
        outs.append(y)
    return torch.cat(outs, dim=1), cache


def decode(params: Params, cfg: VAEConfig,
           latents: torch.Tensor) -> torch.Tensor:
    """latents [B, T, h, w, z] -> pixels [B, 1+(T-1)*4, H, W, 3] in
    [-1, 1]."""
    B, T, h, w, _ = latents.shape
    cache = init_decoder_cache(params, cfg, B, h, w, latents.dtype,
                               latents.device)
    out, _ = decode_block(params, cfg, latents, cache, first=True)
    return out.clamp(-1.0, 1.0)
