"""Attention ops: the plain references and the dispatch seam (port of
``self_forcing_tpu/ops/attention.py``).

On a CUDA tensor the seam calls the hand-written kernels of
``ops/cuda_attention.py`` (or, with ``kernels=False``, their plain
PyTorch versions, for holding a whole forward against the kernels).  On a
CPU tensor it calls the references below, which follow the JAX package's
XLA path: for ``softmax='free'`` they run the base-e softmax at
``scale * ln 2``.  The one exception is the int8-QK decode attention
(``quant='int8qk'`` with ``softmax='free'``): its result depends on the
quantization tiles, so on the CPU it runs the kernel's plain version,
which computes the Pallas kernel's function.
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_tiles(Lq: int, S: int, Lf: int, quant: str | None = None,
                 softmax: str | None = None, tk_align: int | None = None,
                 tq: int = 512, tk: int = 2048) -> tuple[int, int, int]:
    """(tq, tk, tf): the query, cache and fresh tiles that the JAX
    package's ``decode_attention_fresh_pallas`` picks for these lengths
    (its tile heuristics without the ``SF_TPU_ATTN_TQ``/``TK`` environment
    overrides).  The int8-QK decode attention quantizes over exactly
    these tiles: one q scale per (head, tq rows), one k scale per tk
    cache rows or tf fresh rows.  ``tq``/``tk`` are the Pallas wrapper's
    requested sizes (its defaults 512 and 2048)."""
    if softmax in ("free", "free_noclamp") and quant in (None, "int8qk") \
            and tq == 512:
        # free mode has room for wider q tiles; the windowed path's
        # frame-aligned cache tiles leave more
        tq = 800 if tk_align is None else 960
    # exact fit: the tile count from the requested size, then the smallest
    # multiple of 8 that covers the length in that many tiles
    qt = _cdiv(Lq, min(tq, max(128, 1 << (Lq - 1).bit_length())))
    tq = max(8, -(-_cdiv(Lq, qt) // 8) * 8)
    if tk_align is not None and S % tk_align == 0 and tk_align % 8 == 0:
        # frame-aligned cache tiles: the largest whole number of frames
        # dividing the buffer that fits in max(tk, tk_align)
        m = S // tk_align
        d = max((x for x in range(1, m + 1)
                 if m % x == 0 and x * tk_align <= max(tk, tk_align)),
                default=1)
        tk = d * tk_align
    elif S % tk:
        ntk = _cdiv(S, min(tk, max(128, 1 << (S - 1).bit_length())))
        tk = max(8, -(-_cdiv(S, ntk) // 8) * 8)
    cap = (min(tk, 1280) if quant == "int8"
           else min(tk, 1600) if quant == "int8qk" else tk)
    ntf = _cdiv(Lf, min(cap, max(128, 1 << (Lf - 1).bit_length())))
    gran = 32 if quant in ("int8", "int8qk") else 8
    tf = max(gran, -(-_cdiv(Lf, ntf) // gran) * gran)
    return tq, tk, tf


def decode_attention_fresh(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, kv_start: int, kv_end: int,
                           scale: float | None = None,
                           static_hi: int | None = None,
                           layer_idx: int | None = None,
                           heads_packed: int | None = None,
                           softmax: str | None = None,
                           sink_end: int | None = None,
                           quant: str | None = None,
                           tk_align: int | None = None,
                           window_static: tuple[int, int] | None = None,
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
    reference, like the JAX package's, does not need it).

    ``quant='int8qk'`` (with ``softmax='free'``): int8 QK^T with per-tile
    scales, bf16 P.V (the int8-QK kernel on CUDA, its plain version on the
    CPU).  ``tk_align`` aligns the cache tiles to whole frames (the
    windowed caller passes frame_seqlen).  ``window_static``: the
    windowed caller's (sink_tokens, recent_tokens) promise that the
    window holds at most that many tokens in each interval; the Pallas
    kernel sizes a compressed grid from it, the CUDA kernel skips dead
    tiles anyway, so here it is only checked.  On CUDA any other
    ``quant``, or ``int8qk`` without the free softmax, raises; on the CPU
    a ``quant`` without the free softmax is ignored, as in the JAX
    package off the TPU."""
    sk = 0 if sink_end is None else int(sink_end)
    if window_static is not None:
        sink_tok, recent_tok = window_static
        if sk > sink_tok or int(kv_end) - int(kv_start) > recent_tok:
            raise ValueError(
                f"window [0, {sk}) + [{kv_start}, {kv_end}) exceeds "
                f"window_static {window_static}")
    if q.is_cuda:
        if quant not in (None, "int8qk"):
            raise NotImplementedError(
                f"decode attention quant={quant!r} is not ported to CUDA "
                "(only 'int8qk')")
        if softmax != "free":
            raise NotImplementedError(
                "only the offset-free ('free') decode softmax is ported to "
                "CUDA, and int8qk exists only with it")
    int8qk = quant == "int8qk" and softmax == "free"
    if q.is_cuda or int8qk:
        N = heads_packed if heads_packed is not None else 1
        args = dict(layer_idx=0 if layer_idx is None else int(layer_idx),
                    kv_start=int(kv_start), kv_end=int(kv_end), sink_end=sk,
                    static_hi=static_hi, num_heads=N,
                    scale=1.0 if scale is None else scale)
        if int8qk:
            S = k_cache.shape[-2]
            tq, tk, tf = decode_tiles(q.shape[1], S, k_new.shape[1],
                                      quant, softmax, tk_align)
            fn = (cuda_attention.decode_fresh_int8qk if kernels
                  else cuda_attention.decode_fresh_int8qk_ref)
            return fn(q, k_cache, v_cache, k_new, v_new, tq=tq, tk=tk,
                      tf=tf, **args)
        fn = (cuda_attention.decode_fresh_free if kernels
              else cuda_attention.decode_fresh_free_ref)
        return fn(q, k_cache, v_cache, k_new, v_new, **args)
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
