"""Parameter bridge: the JAX package's parameter trees (as numpy) -> torch.

The keys and the stacked-block layout (blocks on axis 0) stay as they
are.  Linear weights keep their [in, out] layout.  In the VAE tree (both
halves: the encoder's 2D stride-2 resample convs and (3, 1, 1)
``time_conv`` too) conv weights go from JAX's DHWIO / HWIO to torch's
OIDHW / OIHW, in the TAEHV tree from HWIO to OIHW (its int8 ``w_q``
too).  Other quantized leaves are carried as they are: int8
weights, float8_e4m3fn weights (through their uint8 view) and f32 scales
(``w_scale`` keeps float32 whatever ``dtype`` says), and so does the T5
tree's relative-position table ``pos_emb``.  A W8A8 linear
(``w_qa``) is stored once in the kernels' K-contiguous layout ``w_qa_t``,
``w_qa`` becoming its transposed view (ops/quant.py).
"""
from __future__ import annotations

import numpy as np
import torch

from self_forcing_tpu_torch.ops.quant import kernel_layout


def params_from_jax(tree, kind: str, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None):
    """Convert a nested dict/list tree of numpy arrays (``kind`` 'dit',
    'vae', 'taehv', 't5' or 'clip') into the same tree of tensors on
    ``device``; floating leaves other than scales and T5's ``pos_emb`` are
    cast to ``dtype`` when given.  The CLIP tree's linear weights stay
    [in, out] and its patch embedding is already a [ph * pw * 3, dim]
    matrix, so nothing in it is transposed.  The GAN discriminator head
    (``dit.init_cls_branch_params``: register tokens, norms, linears and
    a list of attention blocks) holds nothing 'dit' transposes, so
    ``kind='dit'`` carries it too."""
    if kind not in ("dit", "vae", "taehv", "t5", "clip"):
        raise ValueError(f"kind must be 'dit', 'vae', 'taehv', 't5' or "
                         f"'clip', got {kind!r}")
    keep_f32 = ("w_scale", "pos_emb") if kind == "t5" else ("w_scale",)

    def leaf(key, a):
        a = np.asarray(a)
        if a.dtype.name == "float8_e4m3fn":   # numpy has no native fp8
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn).to(device)
        if a.dtype.name == "bfloat16":   # numpy has no native bfloat16
            a = a.astype(np.float32)
        if kind == "vae" and key == "w" and a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)      # DHWIO -> OIDHW
        elif kind in ("vae", "taehv") and a.ndim == 4 and (
                key == "w" or (kind == "taehv" and key == "w_q")):
            a = a.transpose(3, 2, 0, 1)         # HWIO -> OIHW
        t = torch.tensor(a, device=device)
        if dtype is not None and t.is_floating_point() and \
                key not in keep_f32:
            t = t.to(dtype)
        return t

    def conv(key, node):
        if isinstance(node, dict):
            out = {k: conv(k, v) for k, v in node.items()}
            if "w_qa" in out:
                out["w_qa"], out["w_qa_t"] = kernel_layout(out["w_qa"])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(conv(key, v) for v in node)
        return leaf(key, node)

    return conv(None, tree)
