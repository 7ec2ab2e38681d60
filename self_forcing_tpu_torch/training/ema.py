"""EMA of a parameter tree in an fp32 shadow (port of
``self_forcing_tpu/training/ema.py``)."""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.utils import tree


def init_ema(params):
    return tree.map_tree(lambda x: x.detach().float().clone(), params)


@torch.no_grad()
def update_ema(ema, params, decay: float):
    """ema <- decay * ema + (1 - decay) * params, in place; returns ema."""
    for e, p in zip(tree.leaves(ema), tree.leaves(params)):
        e.mul_(decay).add_(p.detach().float(), alpha=1.0 - decay)
    return ema


def ema_to_params(ema, like):
    """The EMA tree as parameters: each leaf in the dtype of ``like``'s
    leaf at its place."""
    out = iter(tree.leaves(like))
    return tree.map_tree(lambda e: e.detach().to(next(out).dtype).clone(),
                         ema)
