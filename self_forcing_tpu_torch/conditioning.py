"""Pose and image conditioning (UniAnimate-DiT) (port of
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
is turned off.
- ``PoseImageConditioner``: the training-side combiner of the pose tokens,
  the image conditioning (CLIP tokens and the masked first-frame VAE
  latent ``y``) and the reference-pose bias, with condition dropout.
  Its keep mask is drawn from a ``torch.Generator`` the caller passes
  (the JAX package takes a PRNG key), or given as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.models import clip as clip_mod
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.utils.resize import resize_cubic

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


def first_frame_condition(vae_params: Params, vae_cfg, img: torch.Tensor,
                          num_frames: int, height: int,
                          width: int) -> torch.Tensor:
    """The image-to-video ``y`` [B, F, 4 + 16, h, w] of a first frame
    [B, 3, H0, W0] in [-1, 1]: a 4-channel mask (1 on the first latent
    frame) beside the VAE latent of [the frame resized to height x width
    (``jax.image.resize``'s cubic), then (F - 1) * 4 zero frames]."""
    B = img.shape[0]
    h, w = height // 8, width // 8
    if tuple(img.shape[-2:]) != (height, width):
        img = resize_cubic(img, height, width)
    vdt = vae_params["conv2"]["w"].dtype
    frames = torch.cat([img[:, None], img.new_zeros(
        B, (num_frames - 1) * 4, 3, height, width)], dim=1)
    z = vae_mod.encode(vae_params, vae_cfg,
                       frames.permute(0, 1, 3, 4, 2).to(vdt))
    z = z.permute(0, 1, 4, 2, 3)                      # [B, F, 16, h, w]
    mask = z.new_zeros(B, num_frames, 4, h, w)
    mask[:, 0] = 1.0
    return torch.cat([mask, z], dim=2)


def _keep_mask(B: int, drop: float, generator, keep, device):
    """The condition-dropout keep mask [B] (bool): ``keep`` as given, else
    uniform < 1 - drop from ``generator``, else None (no dropout)."""
    if keep is not None:
        return torch.as_tensor(keep, device=device).bool().reshape(B)
    if drop > 0 and generator is not None:
        return torch.rand(B, generator=generator,
                          device=generator.device).to(device) < 1.0 - drop
    return None


@dataclasses.dataclass
class PoseImageConditioner:
    """The training-side conditioning combiner: the per-batch dict of pose
    tokens and optional CLIP / VAE image conditioning, with condition
    dropout.  ``build_conditioning`` returns {"add_condition" [B, L, 5120],
    "clip_fea" [B, 257, 1280], "y" [B, F, 20, h, w]}, the keys the
    objectives pass to the generator and the score models."""

    dwpose_params: Params
    randomref_params: Params | None = None
    drop_prob: float = 0.0
    clip_params: Params | None = None
    clip_cfg: Any = None
    vae_params: Params | None = None
    vae_cfg: Any = None

    def __call__(self, dwpose_data: torch.Tensor,
                 random_ref_dwpose: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 keep: Optional[torch.Tensor] = None) -> dict:
        """{"dwpose_emb"[, "randomref_emb"]}; ``random_ref_dwpose``
        [B, 3, H, W] uint8.  With dropout (``drop_prob`` and a
        ``generator``, or a given ``keep`` [B]) a dropped sample's pose
        embedding is zero."""
        emb = dwpose_embedding(self.dwpose_params,
                               prepare_dwpose_input(dwpose_data))
        out = {"dwpose_emb": emb}
        if random_ref_dwpose is not None and self.randomref_params is not None:
            out["randomref_emb"] = randomref_embedding(
                self.randomref_params, random_ref_dwpose.float() / 255.0)
        keep = _keep_mask(emb.shape[0], self.drop_prob, generator, keep,
                          emb.device)
        if keep is not None:
            k = keep.reshape((-1,) + (1,) * (emb.dim() - 1))
            out["dwpose_emb"] = torch.where(k, emb, torch.zeros_like(emb))
        return out

    def encode_image(self, first_frame: torch.Tensor, num_frames: int,
                     height: int, width: int):
        """CLIP image tokens and the masked first-frame latent.
        ``first_frame``: [B, H0, W0, 3] uint8 (the dataset's layout) or
        [B, 3, H0, W0] in [-1, 1]; ``num_frames``: latent frames;
        height / width: pixels.  Returns (clip_fea [B, 257, 1280],
        y [B, F, 20, h, w])."""
        if self.clip_params is None or self.vae_params is None:
            raise ValueError("encode_image needs clip_params and vae_params")
        img = first_frame
        if img.dim() == 4 and img.shape[-1] == 3:    # [B, H, W, 3] uint8
            img = img.permute(0, 3, 1, 2)
        img = img.float()
        # uint8 values -> [-1, 1]
        img = torch.where(img.max() > 1.0, img * (2.0 / 255.0) - 1.0, img)
        clip_fea = clip_mod.encode_image(
            self.clip_params,
            self.clip_cfg or clip_mod.CLIP_XLM_ROBERTA_VIT_H_14, img)
        return clip_fea, first_frame_condition(
            self.vae_params, self.vae_cfg, img, num_frames, height, width)

    def build_conditioning(self, dwpose_data: torch.Tensor,
                           first_frame: Optional[torch.Tensor] = None,
                           random_ref_dwpose: Optional[torch.Tensor] = None,
                           num_frames: int = 21, height: int = 480,
                           width: int = 832,
                           generator: Optional[torch.Generator] = None,
                           pose_drop_prob: Optional[float] = None,
                           keep: Optional[torch.Tensor] = None) -> dict:
        """Pose tokens, the image ``y`` and the reference-pose bias, with
        condition dropout (``pose_drop_prob``, else ``drop_prob``, drawn
        from ``generator``; or a given ``keep`` [B]): a dropped sample's
        ``add_condition`` is zero and its ``y`` the bare image ``y`` (zero
        without an image)."""
        drop = self.drop_prob if pose_drop_prob is None else pose_drop_prob
        emb = dwpose_embedding(self.dwpose_params,
                               prepare_dwpose_input(dwpose_data))
        B, C = emb.shape[:2]
        out = {"add_condition": emb.permute(0, 2, 3, 4, 1).reshape(B, -1, C)}
        image_y = None
        if first_frame is not None:
            if self.clip_params is None or self.vae_params is None:
                raise ValueError(
                    "first_frame conditioning needs clip_params and "
                    "vae_params on the PoseImageConditioner (the image y is "
                    "CLIP tokens and a VAE first-frame latent): refusing to "
                    "drop the image")
            out["clip_fea"], image_y = self.encode_image(
                first_frame, num_frames, height, width)

        randomref = None
        if random_ref_dwpose is not None and self.randomref_params is not None:
            ref = random_ref_dwpose
            if ref.dim() == 4 and ref.shape[-1] == 3:   # [B, H, W, 3] uint8
                ref = ref.permute(0, 3, 1, 2)
            randomref = randomref_embedding(self.randomref_params,
                                            ref.float() / 255.0)

        y = image_y
        if y is not None and randomref is not None:
            y = y + randomref[:, None]
        elif randomref is not None:
            # no image: the reference-pose map alone, repeated a frame
            y = randomref[:, None].expand(B, num_frames, *randomref.shape[1:])

        keep = _keep_mask(B, drop, generator, keep, emb.device)
        if keep is not None:
            out["add_condition"] = torch.where(
                keep[:, None, None], out["add_condition"],
                torch.zeros_like(out["add_condition"]))
            if y is not None:
                base = image_y if image_y is not None else torch.zeros_like(y)
                y = torch.where(keep[:, None, None, None, None], y, base)
        if y is not None:
            out["y"] = y
        return out
