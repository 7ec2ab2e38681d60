"""Parameter bridge: the JAX package's parameter trees (as numpy) -> torch.

The keys and the stacked-block layout (blocks on axis 0) stay as they
are.  Linear weights keep their [in, out] layout.  In the VAE tree conv
weights go from JAX's DHWIO / HWIO to torch's OIDHW / OIHW.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, kind: str, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None):
    """Convert a nested dict/list tree of numpy arrays (``kind`` 'dit' or
    'vae') into the same tree of tensors on ``device``; floating leaves
    are cast to ``dtype`` when given."""
    if kind not in ("dit", "vae"):
        raise ValueError(f"kind must be 'dit' or 'vae', got {kind!r}")

    def leaf(key, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # numpy has no native bfloat16
            a = a.astype(np.float32)
        if kind == "vae" and key == "w" and a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)      # DHWIO -> OIDHW
        elif kind == "vae" and key == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)         # HWIO -> OIHW
        t = torch.tensor(a, device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def conv(key, node):
        if isinstance(node, dict):
            return {k: conv(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(key, v) for v in node)
        return leaf(key, node)

    return conv(None, tree)
