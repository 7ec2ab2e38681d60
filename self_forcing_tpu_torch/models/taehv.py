"""TAEHV tiny video autoencoder, the demo configuration's fast VAE (port
of ``self_forcing_tpu/models/taehv.py``).

Activations are channels-last [N, T, H, W, C] as in the JAX package; each
conv folds T into the batch and runs torch's conv2d on the NCHW view of
that tensor, which is ``torch.channels_last`` memory, so cuDNN takes it
without a copy.  Conv weights are in torch's OIHW layout, the layout of
the reference's ``taew2_1.pth`` (``convert_taehv_state_dict`` reads it;
``params.params_from_jax(tree, "taehv")`` converts the JAX package's
HWIO tree).

The decoder's only temporal mixing is the MemBlocks' one-frame lookback,
so ``decode_video_stateful`` carries each MemBlock's last input frame and
a chunked decode equals the whole-video decode.

``quantize_decoder_params`` (opt-in) turns every conv into a W8A8 int8
conv (``_conv_q``) whose int8 products are summed exactly, as the JAX
package's s8 x s8 -> s32 conv: on the card by ``torch._int_mm`` on the
unfolded input, elsewhere by a float64 product of the same operands
(every partial sum is an integer below 2^53, so float64 is exact where
float32, TF32 or a cuDNN algorithm would round once a sum passes 2^24).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

Params = dict
LATENT_CHANNELS = 16
IMAGE_CHANNELS = 3
N_F = (256, 128, 64, 64)

# decoder spec: (kind, param key or None, extra).  TGrow (a 1x1 conv) runs
# before the nearest 2x upsample: the two act on disjoint axes and
# commute exactly, and the 1x1 conv then sees a quarter of the pixels.
_DECODER_SPEC = (
    ("clamp", None, None),
    ("conv", "conv_in", None),        # 16 -> 256
    ("relu", None, None),
    ("mem", "mem0_0", None), ("mem", "mem0_1", None), ("mem", "mem0_2", None),
    ("tgrow", "tgrow0", 1), ("up", None, 2), ("conv", "conv0", None),
    ("mem", "mem1_0", None), ("mem", "mem1_1", None), ("mem", "mem1_2", None),
    ("tgrow", "tgrow1", 2), ("up", None, 2), ("conv", "conv1", None),
    ("mem", "mem2_0", None), ("mem", "mem2_1", None), ("mem", "mem2_2", None),
    ("tgrow", "tgrow2", 2), ("up", None, 2), ("conv", "conv2", None),
    ("relu", None, None),
    ("conv", "conv_out", None),       # 64 -> 3
)

FRAMES_TO_TRIM = 3  # 2**2 - 1 warm-up frames of the 4x temporal upscale

# encoder spec: conv(3, 64) -> [TPool(2), conv s2, 3x MemBlock] x 2 ->
# [TPool(1), conv s2, 3x MemBlock] -> conv(64, 16); 4x temporal and 8x
# spatial downsample
_ENCODER_SPEC = (
    ("conv", "enc_in", None),          # 3 -> 64
    ("relu", None, None),
    ("tpool", "tpool0", 2), ("conv_s2", "enc_conv0", None),
    ("mem", "emem0_0", None), ("mem", "emem0_1", None), ("mem", "emem0_2", None),
    ("tpool", "tpool1", 2), ("conv_s2", "enc_conv1", None),
    ("mem", "emem1_0", None), ("mem", "emem1_1", None), ("mem", "emem1_2", None),
    ("tpool", "tpool2", 1), ("conv_s2", "enc_conv2", None),
    ("mem", "emem2_0", None), ("mem", "emem2_1", None), ("mem", "emem2_2", None),
    ("conv", "enc_out", None),         # 64 -> 16
)


# int8 operand bytes of one unfolded chunk on the card (the full-width
# decoder's last stage unfolds to 5.5 GB for a 3-latent block)
_UNFOLD_BYTES = 1 << 30


def _unfold(xq: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """NHWC [n, H, W, C] -> [n, Ho, Wo, k*k*C]: the k x k taps of each
    output pixel, tap (kh, kw) major and channel minor."""
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    Ho = (xq.shape[1] - k) // stride + 1
    Wo = (xq.shape[2] - k) // stride + 1
    return torch.cat([xq[:, i:i + stride * (Ho - 1) + 1:stride,
                         j:j + stride * (Wo - 1) + 1:stride]
                      for i in range(k) for j in range(k)], dim=-1)


def _int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 a [M, K] x int8 b [O, K]^T, as float32 (the
    rounding of JAX's ``astype(float32)`` of the int32 result).  K and O
    are zero padded to multiples of 8 and M to 17 rows, the shapes
    ``torch._int_mm`` takes."""
    M, K = a.shape
    O = b.shape[0]
    a = F.pad(a, (0, -K % 8, 0, max(17 - M, 0)))
    b = F.pad(b, (0, -K % 8, 0, -O % 8))
    if a.is_cuda:
        y = torch._int_mm(a, b.t())
    else:
        y = a.double() @ b.double().t()
    return y[:M, :O].float()


def _int8_conv(xq: torch.Tensor, w_q: torch.Tensor, stride: int,
               pad: int) -> torch.Tensor:
    """int8 NHWC x [n, H, W, C] (*) int8 OIHW w -> exact sums [n, Ho, Wo,
    O] as float32, unfolded a chunk of frames at a time."""
    O, C, k, _ = w_q.shape
    wm = w_q.permute(0, 2, 3, 1).reshape(O, k * k * C)
    n, H, W = xq.shape[:3]
    per = max(1, _UNFOLD_BYTES // max(H * W * k * k * C // stride ** 2, 1))
    outs = []
    for lo in range(0, n, per):
        cols = _unfold(xq[lo:lo + per], k, stride, pad)
        y = _int8_product(cols.reshape(-1, cols.shape[-1]), wm)
        outs.append(y.reshape(cols.shape[:3] + (O,)))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _conv_q(p: Params, x: torch.Tensor, stride: int,
            pad: int) -> torch.Tensor:
    """W8A8 int8 conv of NHWC x: a dynamic per-tensor activation scale, the
    per-output-channel weight scales of ``quantize_decoder_params``, the
    int8 products summed exactly, dequantized and biased in float32."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax() / xf.new_tensor(127.0), 1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    y = _int8_conv(xq, p["w_q"], stride, pad) * (sx * p["w_scale"])
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def _conv(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3x3 conv, padding 1, of NHWC x [n, H, W, C]."""
    if "w_q" in p:
        return _conv_q(p, x, stride, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p.get("b"), stride=stride,
                 padding=1)
    return y.permute(0, 2, 3, 1)


def _conv1x1(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in p:
        return _conv_q(p, x, 1, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p.get("b"))
    return y.permute(0, 2, 3, 1)


def quantize_decoder_params(params: Params) -> Params:
    """The opt-in int8 W8A8 decoder: every 4-D conv weight ``w`` becomes
    ``w_q`` (int8, OIHW) and ``w_scale`` (float32 [O], per output channel,
    symmetric); biases stay as they are."""
    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() == 4:
                wf = w.float()
                s = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3))
                                    / wf.new_tensor(127.0), 1e-8)
                out = {"w_q": torch.clamp(torch.round(
                    wf / s[:, None, None, None]), -127, 127).to(torch.int8),
                    "w_scale": s}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def _memblock(p: Params, x: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """MemBlock: conv([x | past]) + skip(x), ReLU."""
    h = torch.cat([x, mem], dim=-1)
    h = F.relu(_conv(p["conv0"], h))
    h = F.relu(_conv(p["conv1"], h))
    h = _conv(p["conv2"], h)
    skip = _conv1x1(p["skip"], x) if "skip" in p else x
    return F.relu(h + skip)


def _shift_mem(x5: torch.Tensor) -> torch.Tensor:
    """[N, T, H, W, C] shifted one frame later, zeros first."""
    return torch.cat([torch.zeros_like(x5[:, :1]), x5[:, :-1]], dim=1)


def _up2(h: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest s x s spatial upsample of [N, T, H, W, C]."""
    N_, T_, H_, W_, C_ = h.shape
    h = h[:, :, :, None, :, None, :].expand(N_, T_, H_, s, W_, s, C_)
    return h.reshape(N_, T_, H_ * s, W_ * s, C_)


def _per_frame(fn, h: torch.Tensor, *args) -> torch.Tensor:
    """Apply an NHWC map to every frame of [N, T, H, W, C]."""
    N_, T_ = h.shape[:2]
    out = fn(*args, h.reshape((N_ * T_,) + h.shape[2:]))
    return out.reshape((N_, T_) + out.shape[1:])


def _mem_layer(p: Params, h: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """A MemBlock over every frame of [N, T, H, W, C] with its lookback
    ``mem`` (the same shape)."""
    N_, T_ = h.shape[:2]
    flat = _memblock(p, h.reshape((N_ * T_,) + h.shape[2:]),
                     mem.reshape((N_ * T_,) + mem.shape[2:]))
    return flat.reshape((N_, T_) + flat.shape[1:])


def encode_video(params: Params, x: torch.Tensor) -> torch.Tensor:
    """RGB [N, T, 3, H, W] in ~[0, 1] -> latents [N, T/4, 16, H/8, W/8]
    (the reference's parallel encode; T must be divisible by 4)."""
    T = x.shape[1]
    if T % 4:
        raise ValueError(f"TAEHV encode needs T divisible by 4, got {T}")
    h = x.permute(0, 1, 3, 4, 2)  # channels last [N, T, H, W, C]
    for kind, key, extra in _ENCODER_SPEC:
        if kind == "relu":
            h = F.relu(h)
        elif kind == "conv":
            h = _per_frame(_conv, h, params[key])
        elif kind == "conv_s2":
            h = _per_frame(functools.partial(_conv, stride=2), h,
                           params[key])
        elif kind == "mem":
            h = _mem_layer(params[key], h, _shift_mem(h))
        elif kind == "tpool":
            # each group of ``extra`` consecutive frames side by side along
            # the channels (frame t of a group in channel slot t), then a
            # 1x1 conv back to C
            N_, T_, Hh, Ww, C_ = h.shape
            g = h.reshape(N_, T_ // extra, extra, Hh, Ww, C_)
            g = g.permute(0, 1, 3, 4, 2, 5).reshape(
                N_, T_ // extra, Hh, Ww, extra * C_)
            h = _per_frame(_conv1x1, g, params[key])
    return h.permute(0, 1, 4, 2, 3)


def decode_video_stateful(params: Params, x: torch.Tensor,
                          state: Params | None = None,
                          trim: bool = True
                          ) -> tuple[torch.Tensor, Params]:
    """Exact streaming decode: latents [N, T, 16, H, W] -> (RGB frames
    [N, 4T (- 3 with ``trim``), 3, 8H, 8W] in ~[0, 1], carry state).

    ``state=None`` starts from zero memory (the first chunk; trim its 3
    warm-up frames); pass the returned state, with ``trim=False``, for the
    next chunk."""
    h = x.permute(0, 1, 3, 4, 2)  # channels last [N, T, H, W, C]
    new_state: Params = {}
    for kind, key, extra in _DECODER_SPEC:
        if kind == "clamp":
            h = torch.tanh(h / 3.0) * 3.0
        elif kind == "relu":
            h = F.relu(h)
        elif kind == "conv":
            h = _per_frame(_conv, h, params[key])
        elif kind == "mem":
            if state is None:
                mem = _shift_mem(h)
            else:
                mem = torch.cat([state[key].to(h.dtype), h[:, :-1]], dim=1)
            new_state[key] = h[:, -1:]
            h = _mem_layer(params[key], h, mem)
        elif kind == "up":
            h = _up2(h, extra)
        elif kind == "tgrow":
            # channel group g of the 1x1 conv's output becomes frame g
            N_, T_, Hh, Ww, C_ = h.shape
            y = _per_frame(_conv1x1, h, params[key])
            y = y.reshape(N_, T_, Hh, Ww, extra, C_).permute(0, 1, 4, 2, 3, 5)
            h = y.reshape(N_, T_ * extra, Hh, Ww, C_)
    out = h.permute(0, 1, 4, 2, 3)
    if trim:
        out = out[:, FRAMES_TO_TRIM:]
    return out, new_state


def decode_video(params: Params, x: torch.Tensor,
                 trim: bool = True) -> torch.Tensor:
    """latents [N, T, 16, H, W] -> RGB [N, 4T (- 3), 3, 8H, 8W] in
    ~[0, 1], the whole video at once."""
    return decode_video_stateful(params, x, None, trim)[0]


class TAEHVStreamer:
    """Streaming chunk decode.

    Default: the exact stateful path (``decode_video_stateful``, equal to
    a whole-video decode).  ``stateful=False`` is the reference demo's
    overlap scheme: keep the last ``overlap`` latent frames, re-decode
    [overlap | new] with ``decode_fn`` and drop the overlap's pixels.  As
    in the JAX package, ``overlap`` and ``decode_fn`` are not used on the
    stateful path."""

    def __init__(self, params: Params, overlap: int = 3, decode_fn=None,
                 stateful: bool = True):
        self.params = params
        self.overlap = overlap
        self.stateful = stateful
        self._decode_fn = decode_fn or decode_video
        self.reset()

    def reset(self) -> None:
        self._tail = None
        self._state = None

    def decode_chunk(self, latents: torch.Tensor) -> torch.Tensor:
        """[N, T_new, 16, h, w] -> pixel frames for the new latents."""
        if self.stateful:
            out, self._state = decode_video_stateful(
                self.params, latents, self._state, trim=self._state is None)
            return out
        if self._tail is None:
            joint = latents
            out = self._decode_fn(self.params, joint, trim=True)
        else:
            joint = torch.cat([self._tail, latents], dim=1)
            out = self._decode_fn(self.params, joint, trim=True)
            # the first (tail frames * 4 - trim) pixel frames re-decode
            # the tail (its own length: a short first chunk leaves a
            # shorter tail than ``overlap``)
            out = out[:, max(0, self._tail.shape[1] * 4 - FRAMES_TO_TRIM):]
        # the overlap comes from [old tail | new]: a chunk shorter than
        # the overlap must not shrink it
        self._tail = joint[:, -self.overlap:]
        return out


# ---------------------------------------------------------------- init

def _conv_init(g: torch.Generator, cin: int, cout: int, k: int, dtype,
               device, bias: bool = True) -> Params:
    lim = 1 / math.sqrt(cin * k * k)
    w = (torch.rand(cout, cin, k, k, generator=g, device=device) * 2 - 1) \
        * lim
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(cout, dtype=dtype, device=device)
    return p


def init_decoder_params(seed: int = 0, dtype=torch.float32,
                        device: str | torch.device = "cuda") -> Params:
    """Random decoder parameters (OIHW), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    p: Params = {"conv_in": _conv_init(g, LATENT_CHANNELS, N_F[0], 3, dtype,
                                       device)}
    for s, (cin, cout) in enumerate(zip(N_F[:-1], N_F[1:])):
        for m in range(3):
            p[f"mem{s}_{m}"] = {
                "conv0": _conv_init(g, cin * 2, cin, 3, dtype, device),
                "conv1": _conv_init(g, cin, cin, 3, dtype, device),
                "conv2": _conv_init(g, cin, cin, 3, dtype, device),
            }
        stride = 1 if s == 0 else 2
        p[f"tgrow{s}"] = {"w": (torch.randn(
            cin * stride, cin, 1, 1, generator=g, device=device) * 0.02
        ).to(dtype)}
        p[f"conv{s}"] = _conv_init(g, cin, cout, 3, dtype, device,
                                   bias=False)
    p["conv_out"] = _conv_init(g, N_F[-1], IMAGE_CHANNELS, 3, dtype, device)
    return p


def init_encoder_params(seed: int = 0, dtype=torch.float32,
                        device: str | torch.device = "cuda") -> Params:
    """Random encoder parameters (OIHW), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    p: Params = {"enc_in": _conv_init(g, IMAGE_CHANNELS, 64, 3, dtype,
                                      device)}
    for s, stride in enumerate((2, 2, 1)):
        p[f"tpool{s}"] = {"w": (torch.randn(
            64, 64 * stride, 1, 1, generator=g, device=device) * 0.02
        ).to(dtype)}
        p[f"enc_conv{s}"] = _conv_init(g, 64, 64, 3, dtype, device,
                                       bias=False)
        for m in range(3):
            p[f"emem{s}_{m}"] = {
                "conv0": _conv_init(g, 128, 64, 3, dtype, device),
                "conv1": _conv_init(g, 64, 64, 3, dtype, device),
                "conv2": _conv_init(g, 64, 64, 3, dtype, device),
            }
    p["enc_out"] = _conv_init(g, 64, LATENT_CHANNELS, 3, dtype, device)
    return p


# ---------------------------------------------------------------- convert

# the reference's Sequential indices (taehv.py: the decoder's Clamp, ReLU
# and Upsample layers and the encoder's ReLU hold no parameters)
_DECODER_KEYS = {"conv_in": 1, "mem0_0": 3, "mem0_1": 4, "mem0_2": 5,
                 "tgrow0": 7, "conv0": 8, "mem1_0": 9, "mem1_1": 10,
                 "mem1_2": 11, "tgrow1": 13, "conv1": 14, "mem2_0": 15,
                 "mem2_1": 16, "mem2_2": 17, "tgrow2": 19, "conv2": 20,
                 "conv_out": 22}
_ENCODER_KEYS = {"enc_in": 0, "tpool0": 2, "enc_conv0": 3, "emem0_0": 4,
                 "emem0_1": 5, "emem0_2": 6, "tpool1": 7, "enc_conv1": 8,
                 "emem1_0": 9, "emem1_1": 10, "emem1_2": 11, "tpool2": 12,
                 "enc_conv2": 13, "emem2_0": 14, "emem2_1": 15,
                 "emem2_2": 16, "enc_out": 17}
# a MemBlock's convs in its ``conv`` Sequential (ReLUs between them)
_MEM_CONVS = (("conv0", 0), ("conv1", 2), ("conv2", 4))
# TGrow strides of this decoder (1, 2, 2: 4x temporal upscale)
_TGROW_STRIDE = {"tgrow0": 1, "tgrow1": 2, "tgrow2": 2}


def _convert(sd: Mapping[str, Any], part: str, keys: dict, dtype,
             device) -> Params:
    def t(name):
        return torch.as_tensor(sd[name]).to(device=device, dtype=dtype)

    def conv_p(base):
        p = {"w": t(base + ".weight")}
        if base + ".bias" in sd:
            p["b"] = t(base + ".bias")
        return p

    out: Params = {}
    for key, i in keys.items():
        base = f"{part}.{i}"
        if key.startswith(("mem", "emem")):
            out[key] = {name: conv_p(f"{base}.conv.{j}")
                        for name, j in _MEM_CONVS}
            if base + ".skip.weight" in sd:
                out[key]["skip"] = conv_p(base + ".skip")
        elif key.startswith("tgrow"):
            # a checkpoint trained with a larger stride: keep its last
            # timestep's channels (the reference's patch)
            w = t(base + ".conv.weight")
            want = w.shape[1] * _TGROW_STRIDE[key]
            out[key] = {"w": w[-want:] if w.shape[0] > want else w}
        elif key.startswith("tpool"):
            out[key] = {"w": t(base + ".conv.weight")}
        else:
            out[key] = conv_p(base)
    return out


def convert_taehv_state_dict(sd: Mapping[str, Any], dtype=torch.float32,
                             device: str | torch.device = "cuda") -> Params:
    """The reference's ``taew2_1.pth`` state dict (``decoder.{i}.*``, and
    ``encoder.{i}.*`` when present; torch tensors or numpy arrays) -> the
    port's tree on ``device``.  Both are OIHW: the keys move, the values
    do not."""
    out = _convert(sd, "decoder", _DECODER_KEYS, dtype, device)
    if "encoder.0.weight" in sd:
        out.update(convert_taehv_encoder_state_dict(sd, dtype, device))
    return out


def convert_taehv_encoder_state_dict(sd: Mapping[str, Any],
                                     dtype=torch.float32,
                                     device: str | torch.device = "cuda"
                                     ) -> Params:
    """The encoder half (``encoder.{i}.*``) of a ``taew2_1.pth`` state
    dict -> the port's tree."""
    return _convert(sd, "encoder", _ENCODER_KEYS, dtype, device)


def export_taehv_state_dict(params: Params) -> dict:
    """The inverse of ``convert_taehv_state_dict``: a tree (the decoder,
    and the encoder where it holds one) -> the reference's state dict
    keys, host tensors."""
    sd = {}
    for part, keys in (("decoder", _DECODER_KEYS), ("encoder", _ENCODER_KEYS)):
        for key, i in keys.items():
            if key not in params:
                continue
            base, node = f"{part}.{i}", params[key]
            if key.startswith(("mem", "emem")):
                subs = [(f"{base}.conv.{j}", node[name])
                        for name, j in _MEM_CONVS]
                if "skip" in node:
                    subs.append((base + ".skip", node["skip"]))
            elif key.startswith(("tgrow", "tpool")):
                subs = [(base + ".conv", node)]
            else:
                subs = [(base, node)]
            for name, p in subs:
                sd[name + ".weight"] = p["w"].detach().cpu()
                if "b" in p:
                    sd[name + ".bias"] = p["b"].detach().cpu()
    return sd
