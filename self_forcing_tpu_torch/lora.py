"""LoRA adapters as extra keys of a linear's parameter dict (port of
``self_forcing_tpu/lora.py``): ``lora_A`` [in, r], ``lora_B`` [r, out]
and ``lora_scale`` (alpha / r), stacked over the layers like the base
weights; ``models/wan/dit.py::linear`` adds ``(x @ A) @ B * scale``.
Loading LoRA weights from files is not ported (there are no LoRA files in
the repository).
"""
from __future__ import annotations

import math

import torch

from self_forcing_tpu_torch.utils import tree

Params = dict

# target linears inside each block
TARGET_LINEARS = (
    ("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"),
    ("self_attn", "o"),
    ("cross_attn", "q"), ("cross_attn", "k"), ("cross_attn", "v"),
    ("cross_attn", "o"),
    ("ffn", "fc1"), ("ffn", "fc2"),
)


def _resolve_targets(targets) -> tuple:
    """The config's lora_targets aliases: q/k/v/o name both attention
    modules, ffn.0 / ffn.2 the FFN linears."""
    if targets is None:
        return TARGET_LINEARS
    out = []
    for t in targets:
        t = str(t)
        if t in ("q", "k", "v", "o"):
            out += [("self_attn", t), ("cross_attn", t)]
        elif t == "ffn.0":
            out.append(("ffn", "fc1"))
        elif t == "ffn.2":
            out.append(("ffn", "fc2"))
        else:
            raise ValueError(f"unknown lora target {t!r}")
    return tuple(out)


def apply_lora(params: Params, rank: int = 16, alpha: float = 16.0,
               seed: int = 0, dtype: torch.dtype = torch.float32,
               targets=None) -> Params:
    """Attach adapters to the target linears of ``params['blocks']``: A
    drawn N(0, 1/rank) from a ``torch.Generator`` seeded with ``seed``
    (on the weights' device), B zero, so the model is unchanged at init.
    Returns a new tree sharing the other leaves."""
    out = dict(params)
    out["blocks"] = blocks = tree.map_tree(lambda x: x, params["blocks"])
    for path in _resolve_targets(targets):
        node = blocks
        for p in path[:-1]:
            node = node[p]
        leaf = dict(node[path[-1]])
        L, d_in, d_out = leaf["w"].shape
        dev = leaf["w"].device
        g = torch.Generator(device=dev).manual_seed(seed)
        seed += 1
        leaf["lora_A"] = (torch.randn(L, d_in, rank, generator=g, device=dev)
                          / math.sqrt(rank)).to(dtype)
        leaf["lora_B"] = torch.zeros(L, rank, d_out, dtype=dtype, device=dev)
        leaf["lora_scale"] = torch.full((L,), alpha / rank, dtype=dtype,
                                        device=dev)
        node[path[-1]] = leaf
    return out


def has_lora(params: Params) -> bool:
    """True when any adapter is attached."""
    return any("lora_A" in path for path, _ in tree.items(params))


def lora_label_tree(params: Params, train_pose_proj: bool = True) -> Params:
    """'train' for lora_A / lora_B (and pose_proj), 'frozen' for the rest:
    the labels of the LoRA-only optimizer."""
    def label(path):
        if "lora_A" in path or "lora_B" in path:
            return "train"
        if train_pose_proj and "pose_proj" in path:
            return "train"
        return "frozen"

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return label(path)
    return walk(params, ())


def merge_lora(params: Params) -> Params:
    """Fold B.A.scale into the base weights and drop the adapters."""
    def merge_node(node):
        if not isinstance(node, dict):
            return node
        if "lora_A" in node and "w" in node:
            A, B, scale = node["lora_A"], node["lora_B"], node["lora_scale"]
            delta = (torch.einsum("lir,lro->lio", A, B) * scale[:, None, None]
                     if A.dim() == 3 else (A @ B) * scale)
            new = {k: v for k, v in node.items()
                   if k not in ("lora_A", "lora_B", "lora_scale")}
            new["w"] = (node["w"].float() + delta.float()).to(node["w"].dtype)
            return new
        return {k: merge_node(v) for k, v in node.items()}
    return merge_node(params)
