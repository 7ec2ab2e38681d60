"""3D rotary position embedding for the Wan DiT (port of
``self_forcing_tpu/models/wan/rope.py``).

cos/sin tables are built per axis in float64 on the host and stored as
float32.  For head_dim d, frame gets d - 4*(d//6) dims, height and width
2*(d//6) each (44/42/42 for d=128).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_POS = 1024  # table length per axis


def _freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
    return np.outer(np.arange(MAX_POS, dtype=np.float64), inv)  # [P, dim/2]


@dataclasses.dataclass(frozen=True)
class RopeTables:
    """cos/sin tables per axis, [MAX_POS, d_axis/2] float32."""

    cos_f: torch.Tensor
    sin_f: torch.Tensor
    cos_h: torch.Tensor
    sin_h: torch.Tensor
    cos_w: torch.Tensor
    sin_w: torch.Tensor

    @classmethod
    def create(cls, head_dim: int,
               device: str | torch.device = "cuda") -> "RopeTables":
        d = head_dim
        df = d - 4 * (d // 6)
        dh = dw = 2 * (d // 6)
        af, ah, aw = _freqs(df), _freqs(dh), _freqs(dw)

        def f32(x):
            return torch.tensor(x.astype(np.float32), device=device)

        return cls(f32(np.cos(af)), f32(np.sin(af)),
                   f32(np.cos(ah)), f32(np.sin(ah)),
                   f32(np.cos(aw)), f32(np.sin(aw)))

    def angles_for_grid(self, f: int, h: int, w: int, start_frame: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-token (cos, sin), each [f*h*w, head_dim/2].

        Like the JAX package's dynamic slice, a ``start_frame`` past
        MAX_POS - f is clamped so the last f table rows are used."""
        s = max(0, min(int(start_frame), MAX_POS - f))
        cf, sf = self.cos_f[s:s + f], self.sin_f[s:s + f]
        ch, sh = self.cos_h[:h], self.sin_h[:h]
        cw, sw = self.cos_w[:w], self.sin_w[:w]

        def combine(tf, th, tw):
            a = tf[:, None, None, :].expand(f, h, w, tf.shape[-1])
            b = th[None, :, None, :].expand(f, h, w, th.shape[-1])
            c = tw[None, None, :, :].expand(f, h, w, tw.shape[-1])
            return torch.cat([a, b, c], dim=-1).reshape(f * h * w, -1)

        return combine(cf, ch, cw), combine(sf, sh, sw)


def qk_half_perm(head_dim: int, num_heads: int) -> np.ndarray:
    """Column permutation from interleaved RoPE pairs to the half layout.

    The reference rotates adjacent feature pairs (2i, 2i+1) of each head;
    the DiT's parameters store the self-attention q/k columns (and their
    RMS-norm weights) permuted per head, pair element 0 at i and element 1
    at i + head_dim/2, so RoPE is ``x*cos + rotate_half(x)*sin``.  QK^T is
    invariant under a permutation shared by q and k.  The checkpoint
    converters apply it (``utils/checkpoints.py``); random init needs
    none."""
    half = np.empty(head_dim, np.int64)
    half[:head_dim // 2] = np.arange(0, head_dim, 2)
    half[head_dim // 2:] = np.arange(1, head_dim, 2)
    return (np.arange(num_heads)[:, None] * head_dim
            + half[None, :]).reshape(-1)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoidal time embedding: [...] -> [..., dim] f32."""
    assert dim % 2 == 0
    half = dim // 2
    pos = position.to(torch.float32).reshape(-1)
    # correctly rounded float32 frequencies (as the JAX package gets them)
    freqs = torch.tensor(np.power(10000.0, -np.arange(half) / half).astype(
        np.float32), device=pos.device)
    sinusoid = pos[:, None] * freqs[None, :]
    out = torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)
    return out.reshape(*position.shape, dim)
