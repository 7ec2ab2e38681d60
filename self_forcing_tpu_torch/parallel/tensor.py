"""Megatron tensor parallelism of the Wan DiT and its few-step sampler
over a ``("tp",)`` ``DeviceMesh`` (port of
``self_forcing_tpu/parallel/tensor.py``).

Every rank runs the port's unchanged single-card functions on a local
config (:func:`tp_local_config`: the tp-th of the heads and of the ffn
columns, ``head_dim`` kept, ``tp_group`` set) and on its shard of the
parameters (:func:`shard_params_tp`): q / k / v / k_img / v_img / fc1
column-sharded, o / fc2 row-sharded, the q / k norm gains sliced with
their heads, everything else replicated.  The blocks then make the only
collectives tensor parallelism needs (``models/wan/dit.py``): the
all-reduce of the row-sharded products (``_out_linear``) and of the
q / k RMS-norm statistics (``_qk_rms_norm``), with their gradient rules
(``_tp_in`` where a replicated activation enters the column-sharded
products).  Tokens, timesteps and
the latents stay replicated; each rank's KV cache holds its own heads of
the folded [L, B*N, S, D] layout, which needs B = 1 (the fold b*N + n is
then head-contiguous).  ``KVCache.kmax`` is a bound over the rank's own
heads; it is all-reduced (MAX) after each operation, as the JAX package
``pmax``es it, so every rank holds the global bound.

The re-noising draws of the sampler must be the same on every rank: the
caller seeds each rank's generator alike (or passes ``eps``).  Quantized
parameters are refused (:func:`tp_param_specs`): the W8A8 products run
outside ``_out_linear``'s all-reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.parallel import comm
from self_forcing_tpu_torch.pipelines import causal_inference as ci

AXIS = "tp"
_QUANTIZED = ("w_q", "w_qa", "w_qa_t", "w_f8", "w_scale")


def tp_mesh(tp: int | None = None, device_type: str = "cuda",
            axis: str = AXIS):
    """The ``(axis,)`` mesh of ``tp`` ranks that this rank belongs to:
    the world's ranks in consecutive runs of ``tp`` (a world larger than
    ``tp`` holds world / tp replicas).  Needs an initialised default
    process group; every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    tp = world if tp is None else tp
    if world % tp:
        raise ValueError(f"tp {tp} does not divide the world size {world}")
    if tp == world:
        return DeviceMesh(device_type, torch.arange(world),
                          mesh_dim_names=(axis,))
    return DeviceMesh(device_type, torch.arange(world).reshape(-1, tp),
                      mesh_dim_names=("dp", axis))[axis]


def mesh_rank_size(mesh, axis: str = AXIS) -> tuple[int, int]:
    """(this rank's index, ranks) along ``axis`` of ``mesh``."""
    return mesh.get_local_rank(axis), mesh.get_group(axis).size()


def tp_local_config(cfg: WanConfig, tp: int, group=None) -> WanConfig:
    """A rank's view of the model: a tp-th of the heads and of the ffn
    columns, head_dim kept, the all-reduces over ``group``."""
    if cfg.num_heads % tp or cfg.ffn_dim % tp:
        raise ValueError(f"tp {tp} does not divide num_heads "
                         f"{cfg.num_heads} / ffn_dim {cfg.ffn_dim}")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp, ffn_dim=cfg.ffn_dim // tp,
        head_dim_override=cfg.head_dim, tp_group=group)


def _mesh_config(cfg: WanConfig, mesh, axis: str) -> WanConfig:
    return tp_local_config(cfg, mesh.get_group(axis).size(),
                           mesh.get_group(axis))


def _block_leaf_dim(path: tuple[str, ...]) -> int | None:
    """The axis of one layer's leaf (no leading layer axis) that tensor
    parallelism splits, or None (replicated)."""
    parent, leaf = path[-2], path[-1]
    if parent in ("q", "k", "v", "k_img", "v_img", "fc1"):
        # output columns: the rank's heads / ffn slice
        return {"w": 1, "b": 0, "lora_B": 1}.get(leaf)
    if parent in ("o", "fc2"):
        # input rows; bias and lora_B replicated (the partial products are
        # all-reduced before they are added)
        return {"w": 0, "lora_A": 0}.get(leaf)
    if parent in ("norm_q", "norm_k", "norm_k_img"):
        return 0
    return None  # modulation, norm3, lora_scale


def _refuse_quantized(path: tuple[str, ...]) -> None:
    if any(k in _QUANTIZED for k in path):
        raise ValueError(
            f"tensor parallelism takes no quantized params (leaf "
            f"{'/'.join(map(str, path))}): quantization is a single-card "
            f"speed toggle")


def tp_param_specs(params: dict) -> dict:
    """The split axis of every leaf of the stacked DiT tree (None:
    replicated), the counterpart of the JAX package's PartitionSpec tree.
    Raises ValueError on quantized leaves, whose products bypass the
    all-reduces."""
    def spec(path, node):
        if isinstance(node, dict):
            return {k: spec(path + (k,), v) for k, v in node.items()}
        _refuse_quantized(path)
        if "blocks" in path:
            d = _block_leaf_dim(path)
            return None if d is None else d + 1   # the stacked layer axis
        return None

    return spec((), params)


def shard_layer(block: dict, rank: int, tp: int) -> dict:
    """Rank ``rank``'s shard of one layer's parameters (no leading layer
    axis; e.g. ``dit.init_params(block_fn=...)``, so that a rank draws the
    full model layer by layer and keeps its shard)."""
    def shard(path, node):
        if isinstance(node, dict):
            return {k: shard(path + (k,), v) for k, v in node.items()}
        _refuse_quantized(path)
        d = _block_leaf_dim(("blocks",) + path)
        return node if d is None else node.chunk(tp, d)[rank].clone()

    return shard((), block)


def shard_params(params: dict, rank: int, tp: int) -> dict:
    """Rank ``rank``'s shard of the full stacked DiT tree (from
    ``init_params`` or ``params.params_from_jax``): each split leaf is
    cut into ``tp`` equal chunks along its axis and copied."""
    specs = tp_param_specs(params)

    def shard(node, sp):
        if isinstance(node, dict):
            return {k: shard(v, sp[k]) for k, v in node.items()}
        return node if sp is None else node.chunk(tp, sp)[rank].clone()

    return shard(params, specs)


def shard_params_tp(params: dict, mesh, axis: str = AXIS) -> dict:
    """This rank's shard of the full DiT tree along ``axis`` of
    ``mesh``."""
    rank, tp = mesh_rank_size(mesh, axis)
    return shard_params(params, rank, tp)


def _reduce_kmax(cache: dit.KVCache, mesh, axis: str) -> dit.KVCache:
    """The cache with its per-layer bound made global over the ranks."""
    if cache.kmax is None:
        return cache
    kmax = comm.all_reduce(cache.kmax.clone(), mesh.get_group(axis), "max")
    return dataclasses.replace(cache, kmax=kmax)


def init_kv_cache_tp(cfg: WanConfig, mesh, batch_size: int,
                     frame_seqlen: int, frames: int, dtype=torch.bfloat16,
                     device: str | torch.device = "cuda",
                     axis: str = AXIS) -> dit.KVCache:
    """This rank's zeroed cache: its heads of the folded cache (B = 1)."""
    if batch_size != 1:
        raise ValueError("tensor-parallel inference shards the folded B*N "
                         "cache axis: batch 1 only")
    return dit.init_kv_cache(_mesh_config(cfg, mesh, axis), batch_size,
                             frame_seqlen, frames, dtype, device)


def precompute_context_tp(params: dict, cfg: WanConfig,
                          context: torch.Tensor, mesh,
                          clip_fea: torch.Tensor | None = None,
                          axis: str = AXIS) -> dict:
    """This rank's heads of the per-prompt cross-attention K/V."""
    return dit.precompute_context(params, _mesh_config(cfg, mesh, axis),
                                  context, clip_fea)


def forward_inference_tp(params: dict, cfg: WanConfig, x: torch.Tensor,
                         t: torch.Tensor, ctx_kv: dict,
                         cache: dit.KVCache, start_frame: int, rope, mesh,
                         axis: str = AXIS, **kw):
    """The KV-cached forward (:func:`dit.forward_inference`, keywords
    passed on) tensor-parallel over ``axis``: the output replicated, the
    cache this rank's heads, its kmax all-reduced.  Batch 1."""
    if x.shape[0] != 1:
        raise ValueError("tensor-parallel inference needs batch 1")
    out, cache = dit.forward_inference(params, _mesh_config(cfg, mesh, axis),
                                       x, t, ctx_kv, cache, start_frame,
                                       rope, **kw)
    return out, _reduce_kmax(cache, mesh, axis)


def forward_train_tp(params: dict, cfg: WanConfig, x: torch.Tensor,
                     t: torch.Tensor, context: torch.Tensor, mask, rope,
                     mesh, axis: str = AXIS, **kw) -> torch.Tensor:
    """The no-cache forward (:func:`dit.forward_train`) tensor-parallel
    over ``axis``, every activation replicated.  Differentiable: the
    row-sharded products' all-reduce passes its gradient through as it is
    (the output is replicated), a replicated activation entering the
    column-sharded products sums the ranks' gradients, and the q / k
    norm's all-reduced statistic all-reduces its gradient
    (``comm.reduce_from`` / ``copy_to`` / ``all_reduce_both``).  Each
    rank's gradient of a split leaf is its shard of the one-card
    gradient, of a replicated leaf the whole one."""
    return dit.forward_train(params, _mesh_config(cfg, mesh, axis), x, t,
                             context, mask, rope, **kw)


def denoise_block_tp(params: dict, cfg: WanConfig, scheduler, rope,
                     ctx_kv: dict, cache: dit.KVCache,
                     noise_blk: torch.Tensor, steps: Sequence[float],
                     start_frame: int, mesh, axis: str = AXIS, **kw):
    """One block's few-step denoise (``causal_inference.denoise_block``,
    keywords passed on) tensor-parallel over ``axis``."""
    x0, cache = ci.denoise_block(params, _mesh_config(cfg, mesh, axis),
                                 scheduler, rope, ctx_kv, cache, noise_blk,
                                 steps, start_frame, **kw)
    return x0, _reduce_kmax(cache, mesh, axis)


def refresh_block_tp(params: dict, cfg: WanConfig, rope, ctx_kv: dict,
                     cache: dit.KVCache, x0: torch.Tensor,
                     context_noise: float, start_frame: int, mesh,
                     axis: str = AXIS, **kw) -> dit.KVCache:
    """The cache-refresh pass (``causal_inference.refresh_block``)
    tensor-parallel over ``axis``."""
    cache = ci.refresh_block(params, _mesh_config(cfg, mesh, axis), rope,
                             ctx_kv, cache, x0, context_noise, start_frame,
                             **kw)
    return _reduce_kmax(cache, mesh, axis)


def prime_block_tp(params: dict, cfg: WanConfig, rope, ctx_kv: dict,
                   cache: dit.KVCache, latents: torch.Tensor,
                   start_frame: int, mesh,
                   axis: str = AXIS) -> dit.KVCache:
    """Context priming (``causal_inference.prime_block``: clean latents
    written at timestep 0) tensor-parallel over ``axis``."""
    cache = ci.prime_block(params, _mesh_config(cfg, mesh, axis), rope,
                           ctx_kv, cache, latents, start_frame)
    return _reduce_kmax(cache, mesh, axis)


def generate_blocks_tp(params: dict, cfg: WanConfig, scheduler, rope,
                       ctx_kv: dict, cache: dit.KVCache,
                       noise: torch.Tensor, blocks, steps: Sequence[float],
                       context_noise: float, mesh, axis: str = AXIS, **kw):
    """The whole-video block loop (``causal_inference.generate_blocks``)
    tensor-parallel over ``axis``.  Each rank's kmax bounds its own heads
    at every step, so it is all-reduced once, at the end."""
    out, cache = ci.generate_blocks(params, _mesh_config(cfg, mesh, axis),
                                    scheduler, rope, ctx_kv, cache, noise,
                                    blocks, steps, context_noise, **kw)
    return out, _reduce_kmax(cache, mesh, axis)
