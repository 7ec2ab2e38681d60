"""TAEHV tiny video decoder, the demo configuration's fast VAE (port of
the decoder half of ``self_forcing_tpu/models/taehv.py``).

Activations are channels-last [N, T, H, W, C] as in the JAX package; each
conv folds T into the batch and runs torch's conv2d on the NCHW view of
that tensor, which is ``torch.channels_last`` memory, so cuDNN takes it
without a copy.  Conv weights are in torch's OIHW layout
(``params.params_from_jax(tree, "taehv")`` converts the JAX package's
HWIO tree).

The decoder's only temporal mixing is the MemBlocks' one-frame lookback,
so ``decode_video_stateful`` carries each MemBlock's last input frame and
a chunked decode equals the whole-video decode.

Not ported yet: the encoder, ``quantize_decoder_params`` (opt-in int8
convs) and ``convert_taehv_state_dict`` (checkpoint loading).
"""
from __future__ import annotations

import math

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


def _conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """3x3 conv, padding 1, of NHWC x [n, H, W, C]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p.get("b"), padding=1)
    return y.permute(0, 2, 3, 1)


def _conv1x1(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p.get("b"))
    return y.permute(0, 2, 3, 1)


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
            N_, T_ = h.shape[:2]
            flat = _memblock(params[key], h.reshape((N_ * T_,) + h.shape[2:]),
                             mem.reshape((N_ * T_,) + mem.shape[2:]))
            h = flat.reshape((N_, T_) + flat.shape[1:])
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
