"""Wan2.1 3D causal VAE, encoder and decoder (port of
``self_forcing_tpu/models/wan/vae.py``).

The public functions keep the JAX package's channels-last layout: pixels
[B, T, H, W, 3] in and latents [B, T', h, w, z] out of ``encode``, the
reverse for ``decode``.  Inside, a tensor is logically [B, C, T, H, W] so
that torch's conv3d/conv2d (cuDNN on the card) take it; a permuted
channels-last tensor is exactly ``torch.channels_last_3d``, so no copy is
made at the boundary, and the conv kernels read the same storage as
[B, T, H, W, C].  Conv weights are in torch's layout (OIDHW / OIHW;
``params.params_from_jax`` converts the JAX tree).  The per-conv streaming
caches hold the last CACHE_T input frames, [B, C, 2, h, w], in visit
order (the encoder's temporal downsamples one frame, [B, C, 1, h, w]).

Conv backends (``set_conv_backend``), as in the JAX package: None runs
every conv through torch (cuDNN); 'pallas' sends each 3x3x3 stride-1
causal conv that ``ops/conv.py::conv3d_fused`` accepts to the conv kernel;
'fused' runs each residual block whose two convs ``norm_silu_conv3d``
accepts (batch 1) as two fused norm + SiLU + conv (+ residual) kernels,
whose caches then hold the raw conv inputs.  On the CPU the same routes
run the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.ops import conv as conv_ops
from self_forcing_tpu_torch.utils.tree import map_tree

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

_CONV_BACKEND: str | None = None


def set_conv_backend(name: str | None) -> None:
    """Select the conv implementation: None (torch convs, the default),
    'pallas' (the conv kernel for every 3x3x3 stride-1 causal conv it
    accepts) or 'fused' (fused norm + SiLU + conv residual blocks), the
    JAX package's ``set_conv_backend`` (vae.py:85-91)."""
    global _CONV_BACKEND
    if name not in (None, "pallas", "fused"):
        raise ValueError(f"conv backend must be None, 'pallas' or 'fused', "
                         f"got {name!r}")
    _CONV_BACKEND = name


def _use_pallas_conv() -> bool:
    return _CONV_BACKEND == "pallas"


def _use_fused_resblock() -> bool:
    return _CONV_BACKEND == "fused"


def _cl(x: torch.Tensor) -> torch.Tensor:
    """Logical [B, C, T, H, W] -> the channels-last view [B, T, H, W, C]."""
    return x.permute(0, 2, 3, 4, 1)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """Channels-last [B, T, H, W, C] -> the logical [B, C, T, H, W] view."""
    return x.permute(0, 4, 1, 2, 3)


def _zeros(B: int, C: int, T: int, H: int, W: int,
           like: torch.Tensor) -> torch.Tensor:
    """Zeros [B, C, T, H, W] in channels-last storage."""
    return _ncdhw(like.new_zeros((B, T, H, W, C)))


def _cat_frames(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The timeline [a | x] along the frame axis, in x's dtype and in
    channels-last storage (torch.cat along dim 2 may fall back to the
    contiguous format where a frame axis has length 1, and the conv
    kernels would then copy it)."""
    return _ncdhw(torch.cat([_cl(a.to(x.dtype)), _cl(x)], dim=1))


def _tail_cache(cache: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` frames of the timeline [cache | x] (dim 2)."""
    T = x.shape[2]
    if T >= n:
        return x[:, :, -n:]
    return _cat_frames(cache[:, :, -(n - T):], x)


def causal_conv3d(p: Params, x: torch.Tensor, cache: torch.Tensor | None,
                  stride=(1, 1, 1), kernel=(3, 3, 3)):
    """Temporally causal conv3d; x [B, C, T, H, W].  ``cache`` holds the
    previous kt-1 input frames (zeros = causal zero padding) or is None
    for kt == 1.  Returns (y, new_cache).  Under the 'pallas' backend a
    3x3x3 stride-1 conv takes the conv kernel where it accepts the shape
    (vae.py:120-130)."""
    kt = kernel[0]
    pad = (0, kernel[1] // 2, kernel[2] // 2)
    if kt == 1:
        return F.conv3d(x, p["w"], p["b"], stride, pad), cache
    if cache is None:
        cache = _zeros(x.shape[0], x.shape[1], kt - 1, *x.shape[3:], like=x)
    if (tuple(kernel) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
            and _use_pallas_conv()):
        y = conv_ops.conv3d_fused(_cl(x), _cl(cache.to(x.dtype)), p["w"],
                                  p["b"])
        if y is not None:
            return _ncdhw(y), _tail_cache(cache, x, kt - 1)
    y = F.conv3d(_cat_frames(cache, x), p["w"], p["b"], stride, pad)
    return y, _tail_cache(cache, x, kt - 1)


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

def _fused_block_accepts(p: Params, x: torch.Tensor) -> bool:
    """Whether the whole residual block runs fused: batch 1 and both of
    its convs accepted by ``norm_silu_conv3d`` (the second with its
    residual).  Decided before anything is launched, where the JAX
    package computes conv1 and drops it when conv2 declines
    (vae.py:190-205)."""
    B, C, _, H, W = x.shape
    Cout = p["conv1"]["w"].shape[0]
    bpe = x.element_size()
    return (B == 1
            and conv_ops.nsc_tile(H, W, C, Cout, bpe, False) is not None
            and conv_ops.nsc_tile(H, W, Cout, p["conv2"]["w"].shape[0], bpe,
                                  True) is not None)


def _residual_block_fused(p: Params, x: torch.Tensor, cache: list):
    """The whole ResidualBlock as two fused norm + SiLU + conv calls
    (vae.py:179-206).  The caches hold RAW conv inputs (x, then conv1's
    output), not the activated values the unfused block caches: the same
    function, since the norm and SiLU are per pixel and silu(norm(0)) is
    0.  None where the block declines."""
    if not _fused_block_accepts(p, x):
        conv_ops.decline_counts["norm_silu_conv3d"] += 1
        return None
    x0 = _cl(x)[0]
    c0 = _cl(cache[0].to(x.dtype))[0]
    v = conv_ops.norm_silu_conv3d(x0, c0, p["norm1"], p["conv1"]["w"],
                                  p["conv1"]["b"])
    if p.get("shortcut"):
        h, _ = causal_conv3d(p["shortcut"], x, None, kernel=(1, 1, 1))
    else:
        h = x
    v5 = _ncdhw(v[None])
    c1 = _cl(cache[1].to(v.dtype))[0]
    y = conv_ops.norm_silu_conv3d(v, c1, p["norm2"], p["conv2"]["w"],
                                  p["conv2"]["b"], residual=_cl(h)[0])
    return _ncdhw(y[None]), [_tail_cache(cache[0], x, CACHE_T),
                             _tail_cache(cache[1], v5, CACHE_T)]


def residual_block(p: Params, x: torch.Tensor, cache: list):
    """ResidualBlock; consumes 2 cache slots."""
    if _use_fused_resblock():
        out = _residual_block_fused(p, x, cache)
        if out is not None:
            return out
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


def _spatial_resample_down(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ZeroPad2d((0, 1, 0, 1)) + 3x3 stride-2 conv, per frame."""
    B, C, T, H, W = x.shape
    x2 = x.permute(0, 2, 1, 3, 4).reshape(B * T, C, H, W)
    y = F.conv2d(F.pad(x2, (0, 1, 0, 1)), p["conv"]["w"], p["conv"]["b"],
                 stride=2)
    return y.reshape(B, T, *y.shape[1:]).permute(0, 2, 1, 3, 4)


def downsample3d(p: Params, x: torch.Tensor, cache_entry, first: bool):
    """Spatial 2x downsample, then the temporal stride-2 ``time_conv``
    (3x1x1) over [cache frame | x].  The first chunk skips the temporal
    conv; every chunk caches its last post-resample frame."""
    x = _spatial_resample_down(p, x)
    if first:
        return x, x[:, :, -1:]
    y = F.conv3d(_cat_frames(cache_entry, x), p["time_conv"]["w"],
                 p["time_conv"]["b"], stride=(2, 1, 1))
    return y, x[:, :, -1:]


def upsample3d(p: Params, x: torch.Tensor, cache_entry, first: bool):
    """Temporal + spatial 2x upsample.  On the first latent frame the
    temporal conv is skipped and the next frame convolves against zeros;
    afterwards time_conv (C -> 2C) doubles T by interleaving the two
    channel groups."""
    B, C, T, H, W = x.shape
    if first:
        return (_spatial_resample_up(p, x),
                _zeros(B, C, CACHE_T, H, W, like=x))
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
    """Random parameters of both halves, the JAX tree's keys in its order
    ("encoder", "conv1", "conv2", "decoder"), drawn from a
    ``torch.Generator`` seeded with ``seed`` (encoder first)."""
    g = torch.Generator(device=device).manual_seed(seed)
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    enc: Params = {"conv1": _conv_init(g, 3, dims[0], (3, 3, 3), dtype,
                                       device)}
    stages = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        blocks = []
        c = cin
        for _ in range(cfg.num_res_blocks):
            blocks.append(_res_init(g, c, cout, dtype, device))
            c = cout
        stage = {"blocks": blocks}
        if i != len(cfg.dim_mult) - 1:
            stage["resample"] = {"conv": _conv_init(g, cout, cout, (3, 3),
                                                    dtype, device)}
            if cfg.temperal_downsample[i]:
                stage["resample"]["time_conv"] = _conv_init(
                    g, cout, cout, (3, 1, 1), dtype, device)
        stages.append(stage)
    enc["stages"] = stages
    z2 = cfg.z_dim * 2
    enc["mid_res1"] = _res_init(g, dims[-1], dims[-1], dtype, device)
    enc["mid_attn"] = _attn_init(g, dims[-1], dtype, device)
    enc["mid_res2"] = _res_init(g, dims[-1], dims[-1], dtype, device)
    enc["head_norm"] = torch.ones(dims[-1], dtype=dtype, device=device)
    enc["head_conv"] = _conv_init(g, dims[-1], z2, (3, 3, 3), dtype, device)

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
    return {"encoder": enc,
            "conv1": _conv_init(g, z2, z2, (1, 1, 1), dtype, device),
            "conv2": _conv_init(g, cfg.z_dim, cfg.z_dim, (1, 1, 1), dtype,
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


def pad_decoder_channels(params: Params, align: int = 128) -> Params:
    """Exact rewrite of the decoder's last stage with its width padded up
    to ``align`` channels (vae.py:495-556): the padded output channels
    have zero weights and biases, so they stay zero through the convs, the
    SiLU and the residual adds, and the channel RMS norm's sqrt(C) factor
    is compensated by scaling gamma by sqrt(C / Cp) (the zeros do not
    change the sum of squares).  Pads only a width below ``align``; the
    decoder caches size themselves from the padded weights.  Returns a new
    tree sharing the untouched leaves."""
    dec = params["decoder"]
    C = dec["stages"][-1]["blocks"][-1]["conv2"]["w"].shape[0]
    if C % align == 0 or C > align:
        return params
    Cp = align
    scale = math.sqrt(C / Cp)

    def pad_conv(p, cin, cout):
        w = p["w"]     # [O, I, ...]: pad I to cin, O to cout
        zeros = (0, 0) * (w.dim() - 2)
        return {**p, "w": F.pad(w, zeros + (0, cin - w.shape[1],
                                             0, cout - w.shape[0])),
                "b": F.pad(p["b"], (0, cout - p["b"].shape[0]))}

    def pad_norm(g):
        return F.pad(g * scale, (0, Cp - g.shape[0]))

    out = map_tree(lambda t: t, params)   # fresh containers, same leaves
    dec = out["decoder"]
    feeder = dec["stages"][-2]["resample"]["conv"]
    dec["stages"][-2]["resample"]["conv"] = pad_conv(
        feeder, feeder["w"].shape[1], Cp)
    for bp in dec["stages"][-1]["blocks"]:
        cin = bp["conv1"]["w"].shape[1]
        cin_p = Cp if cin == C else cin
        bp["norm1"] = pad_norm(bp["norm1"])
        bp["conv1"] = pad_conv(bp["conv1"], cin_p, Cp)
        bp["norm2"] = pad_norm(bp["norm2"])
        bp["conv2"] = pad_conv(bp["conv2"], Cp, Cp)
        if bp.get("shortcut"):
            bp["shortcut"] = pad_conv(bp["shortcut"], cin_p, Cp)
    dec["head_norm"] = pad_norm(dec["head_norm"])
    dec["head_conv"] = pad_conv(dec["head_conv"], Cp,
                                dec["head_conv"]["w"].shape[0])
    return out


def decode_frame(params: Params, cfg: VAEConfig, z: torch.Tensor,
                 cache: list, first: bool):
    """Decode latent frames [B, T, h, w, z] (one frame on the streaming
    path) -> (pixels [B, T', H, W, 3], new cache).  The first frame yields
    1 pixel frame, each later one 4."""
    zc = z.shape[-1]
    mean = torch.as_tensor(LATENT_MEAN[:zc], dtype=z.dtype, device=z.device)
    std = torch.as_tensor(LATENT_STD[:zc], dtype=z.dtype, device=z.device)
    # a permuted latent (the DiT's [B, T, C, h, w] seen as channels-last)
    # is made contiguous once, so every conv after it gets channels-last
    x = _ncdhw((z * std + mean).contiguous())
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


# ============================================================ encoder

def _encoder_pass(p: Params, cfg: VAEConfig, x: torch.Tensor, cache: list,
                  first: bool):
    """Encoder3d forward (vae.py:640-675); the cache is consumed in visit
    order."""
    new_cache = list(cache)
    slot = iter(range(len(cache)))

    def res(bp, x):
        i0, i1 = next(slot), next(slot)
        x, (new_cache[i0], new_cache[i1]) = residual_block(
            bp, x, [cache[i0], cache[i1]])
        return x

    i = next(slot)
    x, new_cache[i] = causal_conv3d(p["conv1"], x, cache[i])
    for stage in p["stages"]:
        for bp in stage["blocks"]:
            x = res(bp, x)
        if "resample" in stage:
            if "time_conv" in stage["resample"]:
                i = next(slot)
                x, new_cache[i] = downsample3d(stage["resample"], x,
                                               cache[i], first)
            else:
                x = _spatial_resample_down(stage["resample"], x)
    x = res(p["mid_res1"], x)
    x = attention_block(p["mid_attn"], x)
    x = res(p["mid_res2"], x)
    x = F.silu(rms_norm_channel(p["head_norm"], x))
    i = next(slot)
    x, new_cache[i] = causal_conv3d(p["head_conv"], x, cache[i])
    return x, new_cache


def init_encoder_cache(params: Params, cfg: VAEConfig, batch: int,
                       height: int, width: int, dtype=torch.float32,
                       device: str | torch.device = "cuda") -> list:
    """Zero caches in encoder visit order: [B, C, CACHE_T, h, w] for each
    causal conv, [B, C, 1, h, w] for each temporal downsample (one
    post-resample frame)."""
    h, w = height, width
    cache = []
    p = params["encoder"]

    def conv_cache(c, frames=CACHE_T):
        cache.append(torch.zeros(batch, frames, h, w, c, dtype=dtype,
                                 device=device).permute(0, 4, 1, 2, 3))

    conv_cache(p["conv1"]["w"].shape[1])
    for stage in p["stages"]:
        for bp in stage["blocks"]:
            conv_cache(bp["conv1"]["w"].shape[1])
            conv_cache(bp["conv2"]["w"].shape[1])
        if "resample" in stage:
            h, w = h // 2, w // 2
            if "time_conv" in stage["resample"]:
                conv_cache(stage["resample"]["time_conv"]["w"].shape[1], 1)
    for res in (p["mid_res1"], p["mid_res2"]):
        conv_cache(res["conv1"]["w"].shape[1])
        conv_cache(res["conv2"]["w"].shape[1])
    conv_cache(p["head_conv"]["w"].shape[1])
    return cache


def encode_chunk(params: Params, cfg: VAEConfig, x: torch.Tensor,
                 cache: list, first: bool):
    """Encode one pixel chunk [B, T, H, W, 3] (1 frame first, then 4) to
    one latent frame of unnormalized moments [B, 1, h, w, 2z] (``encode``
    applies conv1 and the scaling); returns (moments, new cache)."""
    y, cache = _encoder_pass(params["encoder"], cfg, _ncdhw(x), cache, first)
    return _cl(y), cache


def encode(params: Params, cfg: VAEConfig,
           pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, T, H, W, 3], T = 1 + 4k -> latents [B, 1 + k, h, w, z],
    normalized by the Wan latent mean / std; the reference's 1 + 4k
    chunking (vae.py:712-743)."""
    B, T, H, W, _ = pixels.shape
    if (T - 1) % 4:
        raise ValueError(f"pixel frame count must be 1 + 4k, got {T}")
    cache = init_encoder_cache(params, cfg, B, H, W, pixels.dtype,
                               pixels.device)
    outs = []
    for lo, hi in [(0, 1)] + [(1 + 4 * i, 5 + 4 * i)
                              for i in range((T - 1) // 4)]:
        y, cache = encode_chunk(params, cfg, pixels[:, lo:hi], cache,
                                first=lo == 0)
        outs.append(y)
    moments = _ncdhw(torch.cat(outs, dim=1))
    moments, _ = causal_conv3d(params["conv1"], moments, None,
                               kernel=(1, 1, 1))
    mu = _cl(moments)[..., :moments.shape[1] // 2]
    zc = mu.shape[-1]
    mean = torch.as_tensor(LATENT_MEAN[:zc], dtype=mu.dtype, device=mu.device)
    std = torch.as_tensor(LATENT_STD[:zc], dtype=mu.dtype, device=mu.device)
    return (mu - mean) / std
