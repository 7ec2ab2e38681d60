"""Sequence parallelism of the bidirectional Wan forward: ring attention
over frame shards (port of ``self_forcing_tpu/parallel/sequence.py``;
the reference's xDiT USP
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
all-gathered, so every rank returns the whole prediction.  With
``param_specs`` the weights are ZeRO-3 slices over ("fsdp", "sp"),
gathered a layer at a time (the 14B teacher of the distillation
trainers).

The forward is differentiable with respect to its inputs, as the JAX
package's is under ``shard_map``: the ring has a flash-style backward
that passes the shards' dK / dV round the ring beside them, and the
frame split and gather carry ``shard_map``'s transpose rules
(``comm.split_replicated`` / ``comm.gather_replicated``); SiD's generator
loss differentiates through the sequence-parallel teacher.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.parallel import comm
from self_forcing_tpu_torch.utils import tree

# the f32 score buffer of one ring step's K/V chunk is capped at this
SCORE_BYTES = 768 * 2 ** 20


def _chunk(Lk: int, per_key: int, kv_chunk: int) -> int:
    """The largest divisor of ``Lk`` at most ``kv_chunk`` keys whose score
    buffer (``per_key`` bytes a key) stays within :data:`SCORE_BYTES`."""
    cap = max(1, SCORE_BYTES // max(1, per_key))
    return max((c for c in range(1, min(kv_chunk, cap, Lk) + 1)
                if Lk % c == 0), default=Lk)


def _ring_forward(q, k, v, group, scale: float, kv_valid, kv_chunk: int,
                  with_lse: bool):
    """The ring's online softmax (see :func:`ring_attention`): returns the
    float32 output [B, N, Lq, D] and, ``with_lse``, each query's
    log-sum-exp [B, N, Lq, 1]."""
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
    l = l.clamp_min(1e-30)
    return o / l, (m + torch.log(l) if with_lse else None)


def _ring_backward(q, k, v, out, lse, do, group, scale: float, kv_valid,
                   kv_chunk: int):
    """dq, dk, dv of the ring (flash style, float32): each step recomputes
    p = exp(s - lse) chunk by chunk of the resident K/V, adds the queries'
    dq here and the shard's dK / dV to buffers that travel round the ring
    with it; after ``sp - 1`` rotations each buffer sits one rank short
    of the shard's owner, and one more pass hands it back."""
    sp, idx = dist.get_world_size(group), dist.get_rank(group)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    qf = q.transpose(1, 2).float() * scale                  # [B, N, Lq, D]
    dof = do.transpose(1, 2).float()
    delta = (dof * out).sum(dim=-1, keepdim=True)           # [B, N, Lq, 1]
    dq = torch.zeros_like(qf)
    dk = q.new_zeros((B, N, Lk, D), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    cw = _chunk(Lk, B * N * Lq * 4, kv_chunk)
    kc, vc = k, v
    for step in range(sp):
        src = (idx - step) % sp
        for c0 in range(0, Lk, cw):
            kf = kc[:, c0:c0 + cw].transpose(1, 2).float()
            vf = vc[:, c0:c0 + cw].transpose(1, 2).float()
            s = qf @ kf.transpose(-1, -2)                   # [B, N, Lq, cw]
            if kv_valid is not None:
                col = src * Lk + c0 + torch.arange(cw, device=q.device)
                s = torch.where(col < kv_valid, s, -1e30)
            p = s.sub_(lse).exp_()              # masked keys: exactly 0
            ds = (dof @ vf.transpose(-1, -2)).sub_(delta).mul_(p)
            dq += ds @ kf
            dk[:, :, c0:c0 + cw] += ds.transpose(-1, -2) @ qf
            dv[:, :, c0:c0 + cw] += p.transpose(-1, -2) @ dof
            del s, p, ds   # freed before the next chunk's are made
        if step < sp - 1:
            kc, vc, dk, dv = comm.ring_pass([kc, vc, dk, dv], group)
    if sp > 1:
        dk, dv = comm.ring_pass([dk, dv], group)
    return ((dq * scale).transpose(1, 2).to(q.dtype),
            dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


class _Ring(torch.autograd.Function):
    """:func:`ring_attention` with its backward (:func:`_ring_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale, kv_valid, kv_chunk):
        out, lse = _ring_forward(q, k, v, group, scale, kv_valid, kv_chunk,
                                 with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, scale, kv_valid, kv_chunk)
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_backward(q, k, v, out, lse, do, *ctx.args),
                None, None, None, None)


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
    multiple) are masked out, and get no gradient.

    Under autograd (an input requiring grad) the forward also keeps the
    local shards, its float32 output and each query's log-sum-exp for
    the backward, which runs the ring again with the shards' dK / dV
    travelling beside them (:func:`_ring_backward`); otherwise it keeps
    nothing."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Ring.apply(q, k, v, group, scale, kv_valid, kv_chunk)
    out, _ = _ring_forward(q, k, v, group, scale, kv_valid, kv_chunk,
                           with_lse=False)
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
    axes in one collective inside the layer loop, its cross-attention K/V
    computed from them there, and freed after it; the other leaves are
    gathered once.  ``params`` may also be a ZeRO-3 view
    (``fsdp.ShardedParams.view``), which gathers the same way.

    Under autograd the gradient reaches the inputs (``x``, ``y``, the
    context and image tokens), never the weights (the frozen teacher's;
    a view is read detached, a plain tree must not require grad).  The
    rules are those of JAX's ``shard_map`` transpose, every rank holding
    the same loss: the gathered output's gradient is cut to the rank's
    own frames (no sum over ranks), ``x``'s is the all-gather of the
    ranks' frame gradients (each rank ends with the whole of it; padded
    frames get none), and the replicated context's is summed over the
    ranks.  Each layer is then recomputed in the backward
    (``torch.utils.checkpoint``), its gather included, so that one
    gathered layer at a time is alive."""
    grad = torch.is_grad_enabled()
    if param_specs is not None and isinstance(params, dict):
        from self_forcing_tpu_torch.parallel import fsdp
        params = fsdp.ShardedParams(params, param_specs, mesh).view(
            detached=True)
    elif hasattr(params, "detached"):
        params = params.detached()
    elif grad and any(p.requires_grad for p in tree.leaves(params)):
        raise ValueError("forward_train_sp gives its weights no gradient: "
                         "pass them detached (a frozen teacher)")
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=2)
    group = mesh.get_group(axis_name)
    sp = group.size()
    context = comm.copy_to(context, group)
    if clip_fea is not None:
        clip_fea = comm.copy_to(clip_fea, group)
    B, F, C, H, W = x.shape
    h, w = H // cfg.patch_size[1], W // cfg.patch_size[2]
    fs = h * w
    F_pad = -(-F // sp) * sp
    if F_pad != F:
        x = torch.cat([x, x.new_zeros(B, F_pad - F, C, H, W)], dim=1)
        t = torch.cat([t, t[:, -1:].expand(B, F_pad - F)], dim=1)
    kv_valid = F * fs if F_pad != F else None
    F_loc = F_pad // sp
    lo = mesh.get_local_rank(axis_name) * F_loc
    tokens, grid = dit.patchify(params, cfg,
                                comm.split_replicated(x, group, 1))
    e, e0 = dit.time_embed(params, cfg, t[:, lo:lo + F_loc], tokens.dtype)
    cos, sin = rope.angles_for_grid(F_loc, h, w, lo)

    def attn(q, k, v):
        return ring_attention(q, k, v, group, kv_valid=kv_valid)

    ctx = dit.embed_text(params, cfg, context)
    img = (dit.embed_image(params, clip_fea) if clip_fea is not None
           and cfg.model_type == "i2v" else None)

    def layer(bp, tokens):
        bp = dit._layer_params(bp)
        return dit._block_train(bp, cfg, tokens, e0, cos, sin, None,
                                dit.cross_kv(bp["cross_attn"], cfg, ctx, img),
                                fs, attn_fn=attn)
    if grad:
        layer = partial(checkpoint, layer, use_reentrant=False)
    for bp in dit.split_layers(params["blocks"]):
        tokens = layer(bp, tokens)
    out = dit.unpatchify(cfg, dit.head_forward(params, cfg, tokens, e, fs),
                         grid)
    return comm.gather_replicated(out, group, 1)[:, :F]
