"""Whether a parallel inference program fits the card: each rank's bytes
of device memory, estimated before any weight exists (the purpose of
``self_forcing_tpu/parallel/aot.py``, which compiles the JAX programs
against deviceless TPU topologies and reads XLA's memory analysis; CUDA
has no such compiler, so this module counts).

A rank holds:

- its parameters: the tree ``dit.init_params`` builds, made on the
  ``meta`` device (shapes, no values), each leaf divided by the ranks
  where tensor parallelism splits it (``tensor.tp_param_specs``);
  sequence parallelism replicates the whole tree;
- the KV cache (the few-step sampler): ``dit.init_kv_cache``'s shape with
  the rank's heads, and its per-layer kmax;
- the per-prompt cross-attention K/V of every layer (text, and image for
  an i2v model), the rank's heads;
- activations, an analytic term for the widest moment of one block (the
  model runs a layer at a time and frees the last): the residual stream
  and the float32 temporaries of its norms (4 x tokens x dim x 4 bytes),
  q, k, v and the attention output (4 x tokens x dim / tp), the FFN
  hidden and its GELU (2 x tokens x ffn / tp), the row-sharded product
  before its all-reduce (tokens x dim); the ring attention adds its
  float32 query, output and running sums (2 x tokens x dim x 4 + 2 x
  heads x tokens x 4), the resident and the received K/V shard (4 x
  tokens x dim) and three score buffers of its chunk
  (``sequence.SCORE_BYTES`` each).

The limit is the card's own memory (``torch.cuda.mem_get_info``), or
what the caller passes.  The allocator's peak on the card
(``max_memory_allocated``) is the measurement the estimate answers to.
"""
from __future__ import annotations

import dataclasses

import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import (WAN_14B, WAN_I2V_14B,
                                                       WanConfig)
from self_forcing_tpu_torch.parallel import sequence, tensor
from self_forcing_tpu_torch.utils import tree

TEXT_LEN, IMAGE_TOKENS = 512, 257


def card_limit() -> int:
    """The card's total memory in bytes."""
    return torch.cuda.mem_get_info()[1]


def param_bytes(cfg: WanConfig, tp: int = 1, dtype=torch.bfloat16,
                causal: bool = True) -> int:
    """One rank's bytes of the DiT parameters under tensor parallelism
    over ``tp`` ranks (``tp`` 1: the whole tree).  The tree is made with
    one layer; the stacked block leaves count ``cfg.num_layers`` times."""
    params = dit.init_params(dataclasses.replace(cfg, num_layers=1),
                             dtype=dtype, device="meta", causal=causal)
    specs = tensor.tp_param_specs(params)
    return sum(leaf.numel() // (1 if sp is None else tp)
               * leaf.element_size()
               * (cfg.num_layers if path[0] == "blocks" else 1)
               for (path, leaf), (_, sp) in zip(tree.items(params),
                                                tree.items(specs)))


def _activation_bytes(cfg: WanConfig, tokens: int, tp: int, itemsize: int,
                      ring: bool = False) -> int:
    a = tokens * (4 * cfg.dim * 4 + 4 * cfg.dim // tp * itemsize
                  + 2 * cfg.ffn_dim // tp * itemsize + cfg.dim * itemsize)
    if ring:
        a += (2 * tokens * cfg.dim * 4 + 2 * cfg.num_heads * tokens * 4
              + 4 * tokens * cfg.dim * itemsize + 3 * sequence.SCORE_BYTES)
    return a


def _result(label: str, parts: dict, limit: int | None) -> dict:
    limit = card_limit() if limit is None else limit
    total = sum(parts.values())
    return {"label": label, **parts, "total": total, "limit": limit,
            "fits": total <= limit}


def tp_sampler_fit(cfg: WanConfig = WAN_14B, tp: int = 1,
                   height: int = 480, width: int = 832,
                   num_frame_per_block: int = 3, frames: int = 21,
                   dtype=torch.bfloat16, limit: int | None = None) -> dict:
    """One rank of the tensor-parallel few-step sampler (``aot.py``'s
    ``tp_sampler_fit`` program: a block's denoise at the full window of a
    ``frames``-frame cache), bytes by part, their total, the limit and
    whether it fits."""
    item = torch.empty((), dtype=dtype).element_size()
    fs = (height // 8 // cfg.patch_size[1]) * (width // 8 // cfg.patch_size[2])
    local = tensor.tp_local_config(cfg, tp)
    cache = dit.init_kv_cache(local, 1, fs, frames, dtype, "meta")
    heads = local.num_heads * local.head_dim
    return _result(f"tp_sampler tp={tp}", {
        "params": param_bytes(cfg, tp, dtype),
        "kv_cache": sum(t.numel() * t.element_size()
                        for t in (cache.k, cache.v, cache.kmax)),
        "context": 2 * cfg.num_layers * TEXT_LEN * heads * item,
        "activations": _activation_bytes(cfg, num_frame_per_block * fs, tp,
                                         item)}, limit)


def sp_forward_fit(cfg: WanConfig = WAN_I2V_14B, sp: int = 1,
                   height: int = 480, width: int = 832,
                   frame_num: int = 81, dtype=torch.bfloat16,
                   limit: int | None = None) -> dict:
    """One rank of the sequence-parallel bidirectional forward
    (``wan_generate.WanI2V`` with an sp mesh; sp 1 is the single-card
    forward, no ring): bytes by part, their total, the limit and whether
    it fits."""
    item = torch.empty((), dtype=dtype).element_size()
    fs = (height // 8 // cfg.patch_size[1]) * (width // 8 // cfg.patch_size[2])
    frames = (frame_num - 1) // 4 + 1
    local_frames = -(-frames // sp)
    keys = TEXT_LEN + (IMAGE_TOKENS if cfg.model_type == "i2v" else 0)
    return _result(f"sp_forward sp={sp}", {
        "params": param_bytes(cfg, 1, dtype, causal=False),
        "kv_cache": 0,
        "context": 2 * cfg.num_layers * keys * cfg.dim * item,
        "activations": _activation_bytes(cfg, local_frames * fs, 1, item,
                                         ring=sp > 1)}, limit)


def table(limit: int | None = None) -> list[dict]:
    """The estimates of ``aot.py``'s programs: the Wan-14B sampler at tp
    1 / 2 / 4 and the Wan-I2V-14B sequence-parallel forward at sp 1 / 2 /
    4."""
    return ([tp_sampler_fit(tp=tp, limit=limit) for tp in (1, 2, 4)]
            + [sp_forward_fit(sp=sp, limit=limit) for sp in (1, 2, 4)])

