"""Small utilities (port of ``self_forcing_tpu/utils/misc.py``)."""
from __future__ import annotations

import random
from typing import Sequence

import numpy as np
import torch


def set_seed(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators (the port's
    draws that matter take their own ``torch.Generator``s)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def merge_dict_list(dict_list: Sequence[dict]) -> dict:
    """Step logs merged: numbers and size-1 arrays averaged, larger arrays
    stacked, keys in the order they first appear."""
    if not dict_list:
        return {}
    out = {}
    keys = {k: None for d in dict_list for k in d}
    for k in keys:
        vals = [d[k] for d in dict_list if k in d]
        vals = [v.detach().cpu().numpy() if hasattr(v, "detach") else v
                for v in vals]
        if isinstance(vals[0], (int, float)) or \
                getattr(np.asarray(vals[0]), "size", 2) == 1:
            out[k] = float(np.mean([np.asarray(v) for v in vals]))
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out
