"""Attention ops: the plain references and the dispatch seam (port of
``self_forcing_tpu/ops/attention.py``).

On a CUDA tensor the seam calls the hand-written kernels of
``ops/cuda_attention.py`` (or, with ``kernels=False``, their plain
PyTorch versions, for holding a whole forward against the kernels).  On a
CPU tensor it calls the references below, which follow the JAX package's
XLA path: for ``softmax='free'`` they run the base-e softmax at
``scale * ln 2``.
"""
from __future__ import annotations

import math

import torch

from self_forcing_tpu_torch.ops import cuda_attention

_NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v.

    q: [B, Lq, N, D], k/v: [B, Lk, N, D] -> [B, Lq, N, D]; fp32 softmax,
    probabilities cast to v's dtype, output in q's dtype."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None,
                    heads_packed: int | None = None,
                    kernels: bool = True) -> torch.Tensor:
    """Cross-attention onto a small static K/V (512 text / 257 image
    tokens).  ``heads_packed=N``: q and the output are [B, Lq, N*D];
    otherwise q is [B, Lq, N, D].  k/v: [B, Lk, N, D]."""
    if q.is_cuda and k.shape[1] <= 1024:
        N = k.shape[2]
        qp = q if heads_packed is not None else q.reshape(*q.shape[:2], -1)
        fn = (cuda_attention.cross_attention if kernels
              else cuda_attention.cross_attention_ref)
        out = fn(qp, k, v, num_heads=N, scale=scale)
        return out if heads_packed is not None else out.reshape(q.shape)
    if heads_packed is not None:
        NH = heads_packed
        q4 = q.reshape(*q.shape[:2], NH, q.shape[-1] // NH)
        out = dense_attention(q4, k, v, scale=scale)
        return out.reshape(*out.shape[:2], -1)
    return dense_attention(q, k, v, scale=scale)


def unfold_kv(a: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Folded cache [B*N, S, D] -> [B, S, N, D]."""
    if a.dim() == 3:
        BN, S, D = a.shape
        return a.reshape(BN // num_heads, num_heads, S, D).permute(
            0, 2, 1, 3)
    return a


def decode_attention_fresh(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, kv_start: int, kv_end: int,
                           scale: float | None = None,
                           static_hi: int | None = None,
                           layer_idx: int | None = None,
                           heads_packed: int | None = None,
                           softmax: str | None = None,
                           sink_end: int | None = None,
                           kernels: bool = True) -> torch.Tensor:
    """KV-cache attention where the current block's K/V are not in the
    cache yet: queries see ``cache[kv_start:kv_end)`` (plus
    ``[0, sink_end)``) and all of k_new/v_new.

    Layouts: heads-packed [B, L, N*D] q/k_new/v_new with
    ``heads_packed=N``, or folded [B*N, L, D].  The cache is stacked
    [L, B*N, S, D] with ``layer_idx``, or one layer [B*N, S, D].
    ``softmax='free'``: the caller folded ``head_dim**-0.5 * log2(e)`` into
    q and passes ``scale=1.0``.  ``static_hi`` is an upper bound on the
    visible cache columns (the kernel skips tiles past it; the CPU
    reference, like the JAX package's, does not need it)."""
    sk = 0 if sink_end is None else int(sink_end)
    if q.is_cuda:
        if softmax != "free":
            raise NotImplementedError(
                "only the offset-free ('free') decode softmax is ported to "
                "CUDA")
        N = heads_packed if heads_packed is not None else 1
        fn = (cuda_attention.decode_fresh_free if kernels
              else cuda_attention.decode_fresh_free_ref)
        return fn(q, k_cache, v_cache, k_new, v_new,
                  layer_idx=0 if layer_idx is None else int(layer_idx),
                  kv_start=int(kv_start), kv_end=int(kv_end), sink_end=sk,
                  static_hi=static_hi, num_heads=N,
                  scale=1.0 if scale is None else scale)
    if softmax == "free":
        # base-2 softmax of (s * scale) == base-e softmax at scale * ln(2)
        scale = (1.0 if scale is None else scale) * math.log(2.0)
    if k_cache.dim() == 4 and layer_idx is not None:
        k_cache, v_cache = k_cache[int(layer_idx)], v_cache[int(layer_idx)]
    if heads_packed is not None:
        NH = heads_packed
        q4, kn4, vn4 = (a.reshape(*a.shape[:2], NH, a.shape[-1] // NH)
                        for a in (q, k_new, v_new))
        out = decode_attention_fresh_ref(
            q4, unfold_kv(k_cache, NH), unfold_kv(v_cache, NH), kn4, vn4,
            kv_start, kv_end, scale=scale, sink_end=sk)
        return out.reshape(*out.shape[:2], -1)
    # folded [BN, ., D] operands == singleton-head 4-D attention
    out = decode_attention_fresh_ref(
        q[:, :, None], k_cache[:, :, None], v_cache[:, :, None],
        k_new[:, :, None], v_new[:, :, None], kv_start, kv_end,
        scale=scale, sink_end=sk)
    return out[:, :, 0]


def decode_attention_fresh_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, kv_start: int,
                               kv_end: int, scale: float | None = None,
                               sink_end: int = 0) -> torch.Tensor:
    """Plain reference of :func:`decode_attention_fresh`: concat
    [cache | new] and mask cache positions outside
    ``[0, sink_end) + [kv_start, kv_end)``.  q: [B, Lq, N, D]; caches
    [B, S, N, D]; k_new/v_new [B, Lf, N, D]."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    S, Lf = k_cache.shape[1], k_new.shape[1]
    k_all = torch.cat([k_cache, k_new.to(k_cache.dtype)], dim=1)
    v_all = torch.cat([v_cache, v_new.to(v_cache.dtype)], dim=1)
    j = torch.arange(S + Lf, device=q.device)
    vis = torch.where(j < S, (j < sink_end) | ((j >= kv_start) & (j < kv_end)),
                      True)
    s = torch.einsum("bqnd,bknd->bnqk", q.float() * scale, k_all.float())
    s = torch.where(vis, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bnqk,bknd->bnqd", p, v_all.float())
    out = o / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(q.dtype)
