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

:func:`sp_dmd_fit` is the training side: the DMD generator step under
ZeRO-3 over ("fsdp", "sp") with a sequence-parallel teacher.  Its
persistent state is counted exactly, leaf by leaf, from the layouts
``parallel/mesh.py`` gives (the JAX package's ``per_device_bytes`` over
the same specs); the step's transient peak is an analytic term.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import (WAN_14B, WAN_I2V_14B,
                                                       WanConfig)
from self_forcing_tpu_torch.parallel import mesh as mesh_mod
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



# ---------------------------------------------------------------------
# the DMD generator step, ZeRO-3 over ("fsdp", "sp")
# ---------------------------------------------------------------------

def spec_bytes(shapes, specs, sizes: dict) -> int:
    """One rank's bytes of a tree (tensors on the ``meta`` device) laid
    out by ``specs`` over a mesh of axis ``sizes``: each leaf's elements
    divided by the ranks of its spec's axes (the JAX package's
    ``aot.per_device_bytes``)."""
    total = 0
    for (_, leaf), (_, sp) in zip(tree.items(shapes), tree.items(specs)):
        div = 1 if sp is None else int(np.prod([sizes[a] for a in sp.axes]))
        total += leaf.numel() // div * leaf.element_size()
    return total


def adam_bytes(param_bytes: int) -> int:
    """An AdamW state over a tree of ``param_bytes``: the two moments in
    the parameters' dtype and layout, and the int32 step count."""
    return 2 * param_bytes + 4


def dmd_state_bytes(student_cfg: WanConfig, teacher_cfg: WanConfig,
                    fsdp: int, sp: int, dtype=torch.bfloat16,
                    teacher_zero3: bool = False,
                    min_size: int = 2 ** 16) -> dict:
    """Per-rank bytes of the DMD trainer's persistent state, by part:
    generator, critic (fake score), their Adam states and the generator
    EMA sliced over ("fsdp", "sp"); the teacher over "fsdp", or over
    ("fsdp", "sp") with ``teacher_zero3``.  The EMA counts as the
    generator's tree, as the JAX package's accounting does (the port's
    EMA is float32: :func:`sp_dmd_fit` adds the difference to its peak)."""
    sizes = {"dp": 1, "fsdp": fsdp, "sp": sp}
    both = ("fsdp", "sp")
    gen = dit.init_params(dataclasses.replace(
        student_cfg, num_frame_per_block=3), dtype=dtype, device="meta",
        causal=True)
    fake = dit.init_params(student_cfg, dtype=dtype, device="meta",
                           causal=False)
    real = dit.init_params(teacher_cfg, dtype=dtype, device="meta",
                           causal=False)
    gen_b = spec_bytes(gen, mesh_mod.combined_fsdp_specs(
        gen, sizes, both, min_size), sizes)
    fake_b = spec_bytes(fake, mesh_mod.combined_fsdp_specs(
        fake, sizes, both, min_size), sizes)
    real_specs = (mesh_mod.combined_fsdp_specs(real, sizes, both, min_size)
                  if teacher_zero3 else
                  mesh_mod.fsdp_shardings(real, sizes, "fsdp", min_size))
    return {"generator_params": gen_b, "generator_opt": adam_bytes(gen_b),
            "fake_score_params": fake_b, "critic_opt": adam_bytes(fake_b),
            "real_score_params": spec_bytes(real, real_specs, sizes),
            "generator_ema": gen_b}


def _layer_bytes(cfg: WanConfig, dtype) -> int:
    """One transformer block's parameter bytes, whole."""
    one = dit.init_params(dataclasses.replace(cfg, num_layers=1),
                          dtype=dtype, device="meta", causal=False)
    return sum(t.numel() * t.element_size()
               for t in tree.leaves(one["blocks"]))


def sp_dmd_fit(student_cfg: WanConfig, teacher_cfg: WanConfig = WAN_14B,
               fsdp: int = 4, sp: int = 4, height: int = 480,
               width: int = 832, frames: int = 21,
               num_frame_per_block: int = 3, dtype=torch.bfloat16,
               teacher_zero3: bool = False, cache_sharded: bool = True,
               guidance: bool = True, limit: int | None = None) -> dict:
    """One rank of the DMD generator step (``aot.py``'s ``sp_dmd_fit``
    program: the student's rollout with gradient, the critic and the
    teacher, CFG, forward) on fsdp x sp ranks: the persistent state
    (:func:`dmd_state_bytes`, exact) and an analytic peak of the step,
    bytes by part, their total, the limit and whether it fits.

    The peak's terms: the rollout's KV cache (bf16, B*N over sp and S
    over fsdp under ``cache_sharded``, the rollout cache constraint) and
    one layer of it gathered (k and v); one student layer gathered and
    its gradient's reduce-scatter buffer; the generator's gradient
    slices; the widest block of activations
    (``_activation_bytes``) of the exit forward (one block of frames,
    float32: the trainer's noise is float32) in the backward, of the
    critic's whole-sequence forward, and of the teacher's ring forward
    over its sp shard of the frames, with one teacher layer gathered
    (whole under ZeRO-3 over sp, else the fsdp slices gathered); and the
    port's float32 EMA beyond the bf16 one the state counts."""
    item = torch.empty((), dtype=dtype).element_size()
    state = dmd_state_bytes(student_cfg, teacher_cfg, fsdp, sp, dtype,
                            teacher_zero3)
    fs = (height // 8 // student_cfg.patch_size[1]) \
        * (width // 8 // student_cfg.patch_size[2])
    tokens = frames * fs
    S = tokens if tokens <= 2048 else -(-tokens // 2048) * 2048
    heads = student_cfg.num_heads
    bn_div = sp if cache_sharded and heads % sp == 0 else 1
    s_div = fsdp if cache_sharded and S % fsdp == 0 else 1
    layer_cache = 2 * heads * S * student_cfg.head_dim * 2
    stud_layer = _layer_bytes(student_cfg, dtype)
    teach_layer = _layer_bytes(teacher_cfg, dtype)
    f32 = 4
    rollout = _activation_bytes(student_cfg, num_frame_per_block * fs, 1,
                                f32)
    critic = _activation_bytes(student_cfg, tokens, 1, f32)
    local_frames = -(-frames // sp)
    teacher = _activation_bytes(teacher_cfg, local_frames * fs, 1, item,
                                ring=sp > 1)
    parts = {
        "state": sum(state.values()),
        "ema_float32": state["generator_ema"] * (4 // item - 1),
        "kv_cache": student_cfg.num_layers * layer_cache
        // (bn_div * s_div),
        "cache_layer_gathered": layer_cache if bn_div * s_div > 1 else 0,
        "layer_gathered": stud_layer + teach_layer,
        "grads": state["generator_params"] + stud_layer,
        "activations": max(rollout, critic, teacher)
        * (2 if guidance else 1),
    }
    out = _result(f"sp_dmd fsdp={fsdp} sp={sp}"
                  f"{' zero3' if teacher_zero3 else ''}", parts, limit)
    out["state_bytes_per_device"] = state
    return out
