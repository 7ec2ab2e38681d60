"""Sequence parallelism of the bidirectional Wan forward: ring attention
over frame shards (port of the inference half of
``self_forcing_tpu/parallel/sequence.py``; the reference's xDiT USP
path, which the 14B quality samplers ``wan_generate.WanT2V`` / ``WanI2V``
take with an sp mesh).

The frames are split over the ranks of the mesh's ``sp`` dimension (each
rank its slice of the RoPE positions).  Patch embedding, AdaLN, the
cross attention (local: the text and image tokens are replicated, and on
the card it runs the port's ``cross_attention`` kernel) and the FFN are
per-token; the self-attention is a ring (:func:`ring_attention`): each
rank attends its queries to the K/V shard it holds, then passes that
shard on to the next rank, ``sp - 1`` times, accumulating an online
softmax.  The attention is plain PyTorch in float32, as the JAX package
computes it in XLA outside any Pallas kernel.  The output frames are
all-gathered, so every rank returns the whole prediction.  Forward only.
With ``param_specs`` the weights are ZeRO-3 slices over ("fsdp", "sp"),
gathered a layer at a time (the 14B teacher of the DMD trainer).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.parallel import comm

# the f32 score buffer of one ring step's K/V chunk is capped at this
SCORE_BYTES = 768 * 2 ** 20


def _chunk(Lk: int, per_key: int, kv_chunk: int) -> int:
    """The largest divisor of ``Lk`` at most ``kv_chunk`` keys whose score
    buffer (``per_key`` bytes a key) stays within :data:`SCORE_BYTES`."""
    cap = max(1, SCORE_BYTES // max(1, per_key))
    return max((c for c in range(1, min(kv_chunk, cap, Lk) + 1)
                if Lk % c == 0), default=Lk)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, scale: float | None = None,
                   kv_valid: int | None = None,
                   kv_chunk: int = 1024) -> torch.Tensor:
    """Bidirectional attention of the global sequence, each rank of
    ``group`` holding one contiguous shard: q / k / v [B, L_loc, N, D] ->
    [B, L_loc, N, D] in q's dtype.

    ``sp - 1`` rotations pass the K/V shards round the ring (none after
    the last step).  Each step accumulates its resident K/V in chunks of
    at most ``kv_chunk`` keys (an online softmax in float32; the chunk's
    score buffer at most :data:`SCORE_BYTES`).  ``kv_valid``: the global
    number of real tokens; keys at or past it (frames padded to an sp
    multiple) are masked out."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    sp, idx = dist.get_world_size(group), dist.get_rank(group)
    B, Lq, N, D = q.shape
    qf = q.transpose(1, 2).float() * scale                  # [B, N, Lq, D]
    m = torch.full((B, N, Lq, 1), -1e30, device=q.device)
    l = torch.zeros((B, N, Lq, 1), device=q.device)
    o = torch.zeros_like(qf)
    Lk = k.shape[1]
    cw = _chunk(Lk, B * N * Lq * 4, kv_chunk)
    kc, vc = k, v
    for step in range(sp):
        src = (idx - step) % sp  # the rank the resident K/V came from
        for c0 in range(0, Lk, cw):
            kf = kc[:, c0:c0 + cw].transpose(1, 2).float()
            vf = vc[:, c0:c0 + cw].transpose(1, 2).float()
            s = qf @ kf.transpose(-1, -2)                   # [B, N, Lq, cw]
            if kv_valid is not None:
                col = src * Lk + c0 + torch.arange(cw, device=q.device)
                s = torch.where(col < kv_valid, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr + p @ vf
            m = m_new
        if step < sp - 1:  # the last rotation's result would go unread
            kc, vc = comm.ring_pass([kc, vc], group)
    out = o / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def forward_train_sp(params, cfg: WanConfig, x: torch.Tensor,
                     t: torch.Tensor, context: torch.Tensor,
                     rope: RopeTables, mesh, axis_name: str = "sp",
                     y: torch.Tensor | None = None,
                     clip_fea: torch.Tensor | None = None,
                     param_specs=None) -> torch.Tensor:
    """The bidirectional no-cache forward (``dit.forward_train`` with no
    mask) with the frames sharded over ``axis_name`` of ``mesh``.

    x [B, F, C, H, W] and t [B, F] replicated on every rank; F is padded
    to a multiple of sp (zero frames at the last timestep, their keys
    masked out of the ring).  An i2v model's ``y`` [B, F, Cy, H, W] is
    concatenated to x's channels before the frames are split, and
    ``clip_fea`` [B, 257, 1280] is replicated.  Returns the whole flow
    prediction [B, F, C_out, H, W] on every rank.

    ``param_specs``: the ZeRO-3-over-sp teacher (the JAX package's
    ``_sp_gather`` schedule).  ``params`` then holds this rank's slices of
    a tree laid out by ``param_specs`` (``mesh.combined_fsdp_specs`` over
    ("fsdp", "sp")); each layer's leaves are all-gathered over their
    axes inside the layer loop and freed after it, the other leaves
    where they are read.  ``params`` may also be a ZeRO-3 view
    (``fsdp.ShardedParams.view``), which gathers the same way.  Forward
    only: the ring and the gathers carry no gradient rule, so a call
    under autograd with inputs that need one raises."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (x, context, y,
                                                        clip_fea)):
        raise ValueError("forward_train_sp is forward only (the frozen "
                         "teacher): call it under torch.no_grad()")
    if param_specs is not None and isinstance(params, dict):
        from self_forcing_tpu_torch.parallel import fsdp
        params = fsdp.ShardedParams(params, param_specs, mesh).view(
            detached=True)
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=2)
    group = mesh.get_group(axis_name)
    sp, idx = group.size(), mesh.get_local_rank(axis_name)
    B, F, C, H, W = x.shape
    h, w = H // cfg.patch_size[1], W // cfg.patch_size[2]
    fs = h * w
    F_pad = -(-F // sp) * sp
    if F_pad != F:
        x = torch.cat([x, x.new_zeros(B, F_pad - F, C, H, W)], dim=1)
        t = torch.cat([t, t[:, -1:].expand(B, F_pad - F)], dim=1)
    kv_valid = F * fs if F_pad != F else None
    F_loc = F_pad // sp
    lo = idx * F_loc
    tokens, grid = dit.patchify(params, cfg, x[:, lo:lo + F_loc])
    e, e0 = dit.time_embed(params, cfg, t[:, lo:lo + F_loc], tokens.dtype)
    cos, sin = rope.angles_for_grid(F_loc, h, w, lo)
    ctx_kv = dit.precompute_context(params, cfg, context, clip_fea)

    def attn(q, k, v):
        return ring_attention(q, k, v, group, kv_valid=kv_valid)

    for bp, layer_ctx in zip(dit.split_layers(params["blocks"]),
                             dit.layer_context(ctx_kv)):
        tokens = dit._block_train(bp, cfg, tokens, e0, cos, sin, None,
                                  layer_ctx, fs, attn_fn=attn)
    out = dit.unpatchify(cfg, dit.head_forward(params, cfg, tokens, e, fs),
                         grid)
    return torch.cat(comm.all_gather(out, group), dim=1)[:, :F]
