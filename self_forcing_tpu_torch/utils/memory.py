"""Device-memory tools of the demo server (port of
``self_forcing_tpu/utils/memory.py``).

``get_hbm_stats`` keeps the JAX package's key names, which
``templates/demo.html`` reads through ``/api/status``; on a CUDA device
they come from ``torch.cuda.mem_get_info`` (the device's free and total
memory) and the caching allocator (``torch.cuda.memory_stats``).
"""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.utils import tree as tree_mod


def get_hbm_stats(device=None) -> dict:
    """bytes_in_use / bytes_limit / peak_bytes_in_use of a CUDA device
    (CUDA device 0 by default): the card's total memory, the part of it in
    use device-wide (this process's reserved segments, its CUDA context
    and any other process), and the allocator's peak of allocated tensor
    bytes.  Zeros where there is no CUDA device."""
    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {"bytes_in_use": 0, "bytes_limit": 0, "peak_bytes_in_use": 0}
    free, total = torch.cuda.mem_get_info(device)
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(total - free),
        "bytes_limit": int(total),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
    }


def get_free_memory_gb(device=None) -> float:
    s = get_hbm_stats(device)
    if s["bytes_limit"]:
        return (s["bytes_limit"] - s["bytes_in_use"]) / 1024 ** 3
    return 0.0


def move_to_device(tree, device: str | torch.device = "cuda"):
    """Every tensor of a nested dict / list tree copied to ``device``."""
    return tree_mod.map_tree(lambda t: t.to(device), tree)


def offload_to_host(tree):
    """Every tensor of a nested dict / list tree copied to the host."""
    return tree_mod.map_tree(lambda t: t.cpu(), tree)
