"""LoRA adapters as extra keys of a linear's parameter dict (port of
``self_forcing_tpu/lora.py``): ``lora_A`` [in, r], ``lora_B`` [r, out]
and ``lora_scale`` (alpha / r), stacked over the layers like the base
weights; ``models/wan/dit.py::linear`` adds ``(x @ A) @ B * scale``.
:func:`load_lora_weights` reads a torch LoRA state dict in the native,
diffusers or peft key format into those keys.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from self_forcing_tpu_torch.models.wan.rope import qk_half_perm

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


# a state dict's projection names -> (module, linear)
_PROJ_ALIASES = {
    "q": ("self_attn", "q"), "k": ("self_attn", "k"),
    "v": ("self_attn", "v"), "o": ("self_attn", "o"),
    "ffn.0": ("ffn", "fc1"), "ffn.2": ("ffn", "fc2"),
}
_PREFIXES = ("base_model.model.", "diffusion_model.", "model.")


def _match(rest: str):
    """(module, linear) of a key's tail after ``blocks.{i}.``, or None."""
    for alias, path in _PROJ_ALIASES.items():
        token = alias if alias.startswith("ffn") else f"{alias}."
        if rest.startswith(f"cross_attn.{alias}."):
            return ("cross_attn", alias)
        if rest.startswith(f"self_attn.{alias}.") or rest.startswith(token):
            return path
    return None


def load_lora_weights(params: Params, state_dict: Mapping[str, Any],
                      alpha: float | None = None,
                      dtype: torch.dtype = torch.float32,
                      head_dim: int = 128) -> Params:
    """Torch LoRA weights into the stacked-layer tree: every target that
    the state dict names gets ``lora_A`` [L, in, r], ``lora_B`` [L, r, out]
    (zero for a layer it lacks) and ``lora_scale`` alpha / r (1 without
    ``alpha``).  Keys: native ``blocks.{i}.self_attn.q.lora_A.weight``
    [r, in], diffusers ``lora_A.default.weight`` / ``lora.down.weight``
    (``lora_B`` / ``lora.up`` [out, r]) and peft
    ``base_model.model.blocks...``; a ``diffusion_model.`` or ``model.``
    prefix is dropped.  The self-attention q / k ``lora_B`` columns take
    the base weights' RoPE half permutation (``rope.qk_half_perm`` over
    ``head_dim``)."""
    found: dict[tuple, dict] = {}
    for key, value in state_dict.items():
        kk = key
        for prefix in _PREFIXES:
            if kk.startswith(prefix):
                kk = kk[len(prefix):]
        if not kk.startswith("blocks.") or "lora" not in kk:
            continue
        parts = kk.split(".")
        rest = ".".join(parts[2:])
        if "lora_A" in rest or "lora.down" in rest:
            ab = "A"
        elif "lora_B" in rest or "lora.up" in rest:
            ab = "B"
        else:
            continue
        path = _match(rest)
        if path is not None:
            found.setdefault((int(parts[1]),) + path, {})[ab] = \
                torch.as_tensor(value).detach().to("cpu", torch.float32)
    if not found:
        raise ValueError("no LoRA weights matched the blocks.* layout")

    num_layers = params["blocks"]["modulation"].shape[0]
    out = dict(params)
    out["blocks"] = tree.map_tree(lambda x: x, params["blocks"])
    targets: dict[tuple, dict] = {}
    for (layer, module, proj), ab in found.items():
        targets.setdefault((module, proj), {})[layer] = ab
    for (module, proj), per_layer in targets.items():
        leaf = dict(out["blocks"][module][proj])
        _, d_in, d_out = leaf["w"].shape
        dev = leaf["w"].device
        r = next(iter(per_layer.values()))["A"].shape[0]
        A = torch.zeros(num_layers, d_in, r)
        B = torch.zeros(num_layers, r, d_out)
        for layer, ab in per_layer.items():
            A[layer] = ab["A"].T           # [r, in] -> [in, r]
            B[layer] = ab["B"].T           # [out, r] -> [r, out]
        if module == "self_attn" and proj in ("q", "k"):
            if d_out % head_dim:
                raise ValueError(f"{d_out} q / k columns are not whole "
                                 f"heads of {head_dim}")
            B = B[:, :, torch.from_numpy(qk_half_perm(head_dim,
                                                      d_out // head_dim))]
        leaf["lora_A"] = A.to(device=dev, dtype=dtype)
        leaf["lora_B"] = B.to(device=dev, dtype=dtype)
        leaf["lora_scale"] = torch.full(
            (num_layers,), (alpha / r) if alpha is not None else 1.0,
            dtype=dtype, device=dev)
        out["blocks"][module][proj] = leaf
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
