"""Fold a LoRA checkpoint into a base Wan checkpoint (port of
``scripts/merge_lora.py``): the teacher's preparation for pose
distillation.

    python -m self_forcing_tpu_torch.scripts.merge_lora --base BASE.pth \\
        --lora LORA.pt --output merged.pt [--alpha 16] [--model 14b]

The base state dict goes through ``convert_dit_state_dict``, the LoRA one
through ``load_lora_weights``; the merged tree is saved as
{"generator": tree} with ``save_pytree`` (a ``torch.save`` file, where the
JAX script writes an orbax checkpoint).
"""
from __future__ import annotations

import argparse
import os

import torch

from self_forcing_tpu_torch.lora import load_lora_weights, merge_lora
from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B, WAN_14B
from self_forcing_tpu_torch.utils.checkpoints import (convert_dit_state_dict,
                                                      load_torch_state_dict,
                                                      save_pytree)


def merge(base_sd, lora_sd, cfg, alpha: float | None = None,
          dtype=torch.bfloat16) -> dict:
    """The base weights (``dtype``, bf16 as the JAX script converts them)
    with the float32 adapters folded in."""
    params = convert_dit_state_dict(base_sd, cfg, dtype=dtype, device="cpu")
    return merge_lora(load_lora_weights(params, lora_sd, alpha=alpha,
                                        head_dim=cfg.head_dim))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--lora", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--model", default="14b", choices=["1.3b", "14b"])
    args = ap.parse_args(argv)
    cfg = WAN_14B if args.model == "14b" else WAN_1_3B
    merged = merge(load_torch_state_dict(args.base),
                   load_torch_state_dict(args.lora), cfg, args.alpha)
    save_pytree(os.path.abspath(args.output), {"generator": merged})
    print(f"merged -> {args.output}")


if __name__ == "__main__":
    main()
