"""Pose conditioning (UniAnimate-DiT), the inference half (port of
``self_forcing_tpu/conditioning.py``).

- ``dwpose_embedding``: a 3D CNN mapping a DWPose skeleton video
  [B, 3, 4F, H, W] in [0, 1] (``prepare_dwpose_input`` puts three copies
  of the first frame in front of the 4F - 3 pose frames) to per-latent-
  frame features [B, 5120, F, H/16, W/16]: temporal strides
  (1,1,1,1,2,2,1), spatial strides (1,1,1,2,2,2,2), so 480x832 pixels give
  30x52, the patchified 60x104 latent's 1560 tokens a frame.
- ``randomref_embedding``: a 2D CNN mapping the reference pose image
  [B, 3, H, W] to a 20-channel latent-resolution map [B, 20, H/8, W/8],
  the bias a y-consuming model adds to its ``y`` channels.

Weights keep torch's layouts, OIDHW for the 3D convs and OIHW for the 2D
ones (the UniAnimate checkpoint's own), and the convs are ``F.conv3d`` /
``F.conv2d``: the JAX package computes them with
``lax.conv_general_dilated``, outside any Pallas kernel.  On the card
cuDNN runs float32 convs in TF32 unless ``torch.backends.cudnn.allow_tf32``
is turned off.  ``PoseImageConditioner``, the training-side combiner with
CLIP image features, is not ported (ROADMAP Queue A item 6).
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

Params = dict
CONCAT_DIM = 4
RANDOMREF_DIM = 20
POSE_CHANNELS = 5120

# (out_ch, kernel, stride) a layer; SiLU between all but the last
_DWPOSE_LAYERS = (
    (CONCAT_DIM * 4, (3, 3, 3), (1, 1, 1)),
    (CONCAT_DIM * 4, (3, 3, 3), (1, 1, 1)),
    (CONCAT_DIM * 4, (3, 3, 3), (1, 1, 1)),
    (CONCAT_DIM * 4, (3, 3, 3), (1, 2, 2)),
    (CONCAT_DIM * 4, (3, 3, 3), (2, 2, 2)),
    (CONCAT_DIM * 4, (3, 3, 3), (2, 2, 2)),
    (POSE_CHANNELS, (1, 2, 2), (1, 2, 2)),
)
_RANDOMREF_LAYERS = (
    (CONCAT_DIM * 4, 3, 1),
    (CONCAT_DIM * 4, 3, 1),
    (CONCAT_DIM * 4, 3, 1),
    (CONCAT_DIM * 4, 3, 2),
    (CONCAT_DIM * 4, 3, 2),
    (RANDOMREF_DIM, 3, 2),
)


def _conv_init(g: torch.Generator, cin: int, cout: int, kernel, dtype,
               device) -> Params:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights [cout, cin,
    *kernel] and bias."""
    lim = 1.0 / math.sqrt(cin * math.prod(kernel))

    def u(*shape):
        return ((torch.rand(*shape, generator=g, device=device) * 2 - 1)
                * lim).to(dtype)

    return {"w": u(cout, cin, *kernel), "b": u(cout)}


def init_dwpose_params(seed: int = 0, dtype=torch.float32,
                       device: str | torch.device = "cuda") -> Params:
    g = torch.Generator(device=device).manual_seed(seed)
    layers, cin = [], 3
    for cout, kern, _ in _DWPOSE_LAYERS:
        layers.append(_conv_init(g, cin, cout, kern, dtype, device))
        cin = cout
    return {"layers": layers}


def init_randomref_params(seed: int = 0, dtype=torch.float32,
                          device: str | torch.device = "cuda") -> Params:
    g = torch.Generator(device=device).manual_seed(seed)
    layers, cin = [], 3
    for cout, kern, _ in _RANDOMREF_LAYERS:
        layers.append(_conv_init(g, cin, cout, (kern, kern), dtype, device))
        cin = cout
    return {"layers": layers}


def dwpose_embedding(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, T, H, W] in [0, 1] -> [B, 5120, T', H', W'].  Padding 1 on
    the 3x3x3 layers (torch's symmetric padding is the JAX package's
    explicit (1, 1) at stride 2 too), none on the last 1x2x2 layer."""
    h = x
    last = len(_DWPOSE_LAYERS) - 1
    for i, (p, (_, kern, stride)) in enumerate(
            zip(params["layers"], _DWPOSE_LAYERS)):
        pad = 0 if kern == (1, 2, 2) else tuple(k // 2 for k in kern)
        h = F.conv3d(h, p["w"].to(h.dtype), p["b"].to(h.dtype),
                     stride=stride, padding=pad)
        if i != last:
            h = F.silu(h)
    return h


def randomref_embedding(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W] in [0, 1] -> [B, 20, H/8, W/8]."""
    h = x
    last = len(_RANDOMREF_LAYERS) - 1
    for i, (p, (_, _, stride)) in enumerate(
            zip(params["layers"], _RANDOMREF_LAYERS)):
        h = F.conv2d(h, p["w"].to(h.dtype), p["b"].to(h.dtype),
                     stride=stride, padding=1)
        if i != last:
            h = F.silu(h)
    return h


def prepare_dwpose_input(dwpose_data: torch.Tensor) -> torch.Tensor:
    """[B, 3, F_px, H, W] uint8 -> the first frame three times in front,
    float32 in [0, 1]."""
    first = dwpose_data[:, :, :1].expand(-1, -1, 3, -1, -1)
    return torch.cat([first, dwpose_data], dim=2).float() / 255.0


def pose_tokens_for_block(dwpose_emb: torch.Tensor, start_frame: int,
                          num_frames: int) -> torch.Tensor:
    """This block's pose features [B, C, F, h, w] as tokens
    [B, num_frames*h*w, C] ('b c f h w -> b (f h w) c').  A pose sequence
    that does not cover the block raises: slicing would silently give
    fewer frames."""
    if start_frame + num_frames > dwpose_emb.shape[2]:
        raise ValueError(
            f"dwpose_data has fewer frames than required: block needs "
            f"[{start_frame}, {start_frame + num_frames}) but pose "
            f"features cover {dwpose_emb.shape[2]} frames")
    blk = dwpose_emb[:, :, start_frame:start_frame + num_frames]
    B, C = blk.shape[:2]
    return blk.permute(0, 2, 3, 4, 1).reshape(B, -1, C)


def load_pose_embedding_weights(state_dict: Mapping[str, Any],
                                dtype=torch.float32,
                                device: str | torch.device = "cuda"
                                ) -> tuple[Params | None, Params | None]:
    """The ``dwpose_embedding.`` and ``randomref_embedding_pose.`` weights
    of a UniAnimate LoRA checkpoint as (dwpose, randomref) trees, None for
    a prefix the checkpoint lacks.  The conv weights stay in the
    checkpoint's OIDHW / OIHW layout (the JAX package transposes them to
    DHWIO / HWIO); the Sequential's indices step by 2 past the SiLUs."""
    def collect(prefix):
        layers, i = [], 0
        while f"{prefix}{i}.weight" in state_dict:
            layers.append({
                k: torch.as_tensor(state_dict[f"{prefix}{i}.{name}"]
                                   ).detach().to(device=device, dtype=dtype)
                for k, name in (("w", "weight"), ("b", "bias"))})
            i += 2
        return {"layers": layers} if layers else None

    return (collect("dwpose_embedding."),
            collect("randomref_embedding_pose."))


def export_pose_state_dict(dwpose: Params, randomref: Params) -> dict:
    """The inverse of :func:`load_pose_embedding_weights`: pose-CNN trees
    as a UniAnimate checkpoint's keys, host tensors."""
    sd = {}
    for prefix, params in (("dwpose_embedding.", dwpose),
                           ("randomref_embedding_pose.", randomref)):
        for i, p in enumerate(params["layers"]):
            sd[f"{prefix}{2 * i}.weight"] = p["w"].detach().cpu()
            sd[f"{prefix}{2 * i}.bias"] = p["b"].detach().cpu()
    return sd
