"""``jax.image.resize(..., "cubic")`` in PyTorch: the resize of images fed
to the Wan VAE (the CLI's ``--i2v`` first frame, ``WanI2V``'s first frame
and ``PoseImageConditioner.encode_image``).  It is not CLIP's resize,
which is PyTorch's bicubic (``models/clip.py``)."""
from __future__ import annotations

import numpy as np
import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = -0.5) at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``jax.image.resize``'s "cubic"
    along one axis: half-pixel centres, the kernel stretched by the
    shrink factor when shrinking (antialiasing), each column renormalised
    to sum 1 (the borders), columns whose sample falls outside the input
    zero."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - pos[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(image: torch.Tensor, height: int, width: int
                 ) -> torch.Tensor:
    """``jax.image.resize(image, (..., height, width), "cubic")`` of an
    image [..., H, W] (the leading axes kept), in float32: separable
    Keys-cubic weights, applied as two products (rows, then columns)."""
    x = image.float()
    H, W = x.shape[-2:]
    if H != height:
        x = torch.einsum("...hw,hH->...Hw", x,
                         _resize_weights(H, height, x.device))
    if W != width:
        x = torch.einsum("...hw,wW->...hW", x,
                         _resize_weights(W, width, x.device))
    return x
