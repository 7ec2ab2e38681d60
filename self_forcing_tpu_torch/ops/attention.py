"""Attention ops: the plain references and the dispatch seam (port of
``self_forcing_tpu/ops/attention.py``).

Where :func:`_kernel_route` holds (a CUDA tensor: the counterpart of the
JAX package's Pallas route) the seam runs the functions of the TPU
kernels: the hand-written kernels of ``ops/cuda_attention.py`` (or, with
``kernels=False``, their plain PyTorch versions, for holding a whole
forward against the kernels), in every softmax mode the Pallas wrappers
dispatch: the offset-free ``softmax='free'``, the bounded softmax
(``fixed_m0``), the online softmax (neither), and for the decode
attention the int8 quantizations (``quant='int8qk'`` with the free
softmax; ``quant='int8'`` with a bound, 'tile' or 'global' by
``int8_bound``, or online without).  A test may force the route on the
CPU, where the wrappers run the plain versions through the same
dispatch.  Off the route the seam calls the references below, which
follow the JAX package's XLA path: the modes and bounds are ignored, and
``softmax='free'`` runs the base-e softmax at ``scale * ln 2``.  The one
exception is the int8-QK decode attention (``quant='int8qk'`` with
``softmax='free'``): its result depends on the quantization tiles, so on
the CPU it always runs the kernel's plain version, which computes the
Pallas kernel's function.

The cache-window attention (:func:`decode_attention`, the JAX package's
``decode_attention`` entry point) runs the decode window kernel on the
route (bf16, or float32 when any operand is not bf16) and the port of
``decode_attention_xla`` off it.

Gradients, as the JAX package's custom VJPs give them: the masked flash
attention through :class:`FlashAttention` (the flash backward kernels on
the route, at the forward mode's scale against its base-e lse); the
decode and cross attention through autograd functions whose backward
recomputes the attention (no TPU kernel: the JAX package replays its XLA
reference): on CUDA operands with the kernels, SDPA's backward on the
gathered visible keys (``cuda_attention.decode_fresh_bwd`` /
``cross_attention_bwd``); on the CPU, or with ``kernels=False``, the
fp32 recomputations (``decode_fresh_bwd_ref`` /
``cross_attention_bwd_ref``).  No
gradient flows through a bound ``fixed_m0`` (the output does not depend
on it).  The decode backward reads the KV cache by reference, not as a
saved tensor: the cache is written in place by later blocks, and the
rows a backward reads must be the ones its forward read (checked at the
window's edges).

The kernels take bf16 operands.  Float32 activations (the JAX package's
promotion of float32 latents over bf16 weights, which the trainer runs)
are rounded to bf16 at the kernels' inputs and the result is cast back,
so the gradients flow through both casts.
"""
from __future__ import annotations

import math

import torch

from self_forcing_tpu_torch.ops import cuda_attention
from self_forcing_tpu_torch.ops.masks import IntervalMask

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


def _kernel_route(t: torch.Tensor) -> bool:
    """Whether the attention on ``t`` runs the TPU kernels' functions
    (the kernels, or their plain versions with ``kernels=False``): on
    CUDA tensors.  The port's counterpart of the JAX package's
    ``_use_pallas``, which also gates the DiT's bounds
    (``models/wan/dit.py``); a test forces it to run the plain versions
    on the CPU."""
    return t.is_cuda


def _bound(fixed_m0, device) -> torch.Tensor | None:
    """A score bound as a float32 tensor on ``device`` that carries no
    gradient."""
    if fixed_m0 is None:
        return None
    return torch.as_tensor(fixed_m0, dtype=torch.float32,
                           device=device).detach()


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _bf16(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The operands of a CUDA kernel, in the kernels' bf16."""
    return tuple(t.to(torch.bfloat16) for t in tensors)


def _wider(*tensors: torch.Tensor) -> torch.dtype | None:
    """The promoted dtype of CUDA operands that are not all bf16 (the
    dtype the result is cast back to), else None."""
    if not tensors[0].is_cuda or all(t.dtype == torch.bfloat16
                                     for t in tensors):
        return None
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


class _CrossAttention(torch.autograd.Function):
    """Cross attention (heads-packed q) with the recomputing backward of
    ``_cross_op_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kernels):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.kernels = scale, kernels
        return _cross_dispatch(q, k, v, scale, k.shape[2], kernels)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        fn = (cuda_attention.cross_attention_bwd
              if ctx.kernels and q.is_cuda
              else cuda_attention.cross_attention_bwd_ref)
        dq, dk, dv = fn(q, k, v, g.contiguous(), num_heads=k.shape[2],
                        scale=ctx.scale)
        return dq, dk, dv, None, None


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None,
                    heads_packed: int | None = None,
                    kernels: bool = True) -> torch.Tensor:
    """Cross-attention onto a small static K/V (512 text / 257 image
    tokens).  ``heads_packed=N``: q and the output are [B, Lq, N*D];
    otherwise q is [B, Lq, N, D].  k/v: [B, Lk, N, D]."""
    wide = _wider(q, k, v) if k.shape[1] <= 1024 else None
    if wide is not None:
        return cross_attention(*_bf16(q, k, v), scale, heads_packed,
                               kernels).to(wide)
    if _needs_grad(q, k, v):
        qp = q if heads_packed is not None else q.reshape(*q.shape[:2], -1)
        out = _CrossAttention.apply(qp, k, v, scale, kernels)
        return out if heads_packed is not None else out.reshape(q.shape)
    return _cross_dispatch(q, k, v, scale, heads_packed, kernels)


def _cross_dispatch(q, k, v, scale, heads_packed, kernels):
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


# =====================================================================
# cache-window attention (no fresh keys)
# =====================================================================

def decode_attention_xla(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_start, kv_end,
                         scale: float | None = None,
                         kv_chunk: int = 1560) -> torch.Tensor:
    """KV-cache attention, all queries see ``cache[kv_start:kv_end)``
    (port of the JAX package's ``decode_attention_xla``): q [B, Lq, N, D],
    caches [B, S, N, D]; ``kv_start`` / ``kv_end`` ints or scalar tensors
    (they stay on the device).  The chunked online softmax in float32 with
    the JAX package's masked score -1e30, so an empty window averages v
    uniformly there, where the kernel gives 0."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    Lq = q.shape[1]
    lo = torch.as_tensor(kv_start, device=q.device)
    hi = torch.as_tensor(kv_end, device=q.device)

    def visible_fn(idx):
        vis = (idx >= lo) & (idx < hi)
        return vis[None, :].expand(Lq, -1)

    return _chunked_online_attention(q, k_cache, v_cache, scale, visible_fn,
                                     kv_chunk)[0]


class _DecodeWindow(torch.autograd.Function):
    """The cache-window attention with the backward of ``_decode_op_bwd``:
    the plain version recomputed under autograd, gradients for q and
    both caches (the window bounds carry none)."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, kv_start, kv_end, scale, kernels):
        ctx.save_for_backward(q, k_cache, v_cache)
        ctx.window = (kv_start, kv_end, scale)
        fn = (cuda_attention.decode_window if kernels
              else cuda_attention.decode_window_ref)
        return fn(q, k_cache, v_cache, kv_start, kv_end, scale=scale)

    @staticmethod
    def backward(ctx, g):
        lo, hi, scale = ctx.window
        with torch.enable_grad():
            ops = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = cuda_attention.decode_window_ref(*ops, lo, hi, scale=scale)
            grads = torch.autograd.grad(out, ops, g)
        return (*grads, None, None, None, None)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_start, kv_end,
                     scale: float | None = None, kv_chunk: int = 1560,
                     kernels: bool = True) -> torch.Tensor:
    """KV-cache window attention (port of the JAX package's
    ``decode_attention``): every query sees ``cache[kv_start:kv_end)``.
    q [B, Lq, N, D] with caches [B, S, N, D] or pre-folded [B*N, S, D],
    or folded q [BN, Lq, D] with folded caches; ``kv_start`` / ``kv_end``
    ints or device scalars.  On the kernel route the decode window kernel
    (``cuda_attention.decode_window``; ``kernels=False``: its plain
    version) in bf16 when every operand is bf16, else in float32 (the
    result cast to q's dtype), with the gradient of the JAX package's
    custom VJP; off it the port of ``decode_attention_xla`` on the folded
    layout (``cuda_attention.decode_window_ref``) under autograd."""
    if not _kernel_route(q):
        return cuda_attention.decode_window_ref(
            q, k_cache, v_cache, kv_start, kv_end, scale=scale,
            kv_chunk=kv_chunk)
    ops = (q, k_cache, v_cache)
    if not all(t.dtype == torch.bfloat16 for t in ops):
        ops = tuple(t.float() for t in ops)
    if _needs_grad(*ops):
        out = _DecodeWindow.apply(*ops, kv_start, kv_end, scale, kernels)
    else:
        fn = (cuda_attention.decode_window if kernels
              else cuda_attention.decode_window_ref)
        out = fn(*ops, kv_start, kv_end, scale=scale)
    return out.to(q.dtype)


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
                           fixed_m0=None, int8_bound: str = "tile",
                           kernels: bool = True,
                           save_cache: bool = False) -> torch.Tensor:
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

    ``softmax=None``: with ``fixed_m0`` (a float32 bound on every score
    at ``scale``, a tensor that stays on the device) the bounded softmax,
    else the online softmax; ``scale`` defaults to head_dim**-0.5.

    ``quant='int8qk'`` (with ``softmax='free'``): int8 QK^T with per-tile
    scales, bf16 P.V.  ``quant='int8'`` (without the free softmax): int8
    QK^T and P.V, p quantized against the row's max in each Pallas tile
    (``fixed_m0`` with ``int8_bound='tile'``), against the bound
    (``'global'``), or against the running max (no bound).  The tiles
    are the Pallas kernel's (:func:`decode_tiles`).  ``tk_align`` aligns
    the cache tiles to whole frames (the windowed caller passes
    frame_seqlen).  ``save_cache``: under autograd the backward's cache
    is saved with ``save_for_backward`` (a gathered copy that nothing
    writes, which a remat'd layer drops and regathers), not held by
    reference.  ``window_static``: the windowed caller's
    (sink_tokens, recent_tokens) promise that the window holds at most
    that many tokens in each interval; the Pallas kernel sizes a
    compressed grid from it, the CUDA kernels skip dead tiles anyway, so
    here it is only checked.  On the kernel route the combinations the
    Pallas wrapper does not take raise: the free softmax with a quant
    other than int8qk or with ``fixed_m0``, and ``int8qk`` without the
    free softmax.  Off it (the CPU) a mode, a bound and a quant without
    the free softmax are ignored, as in the JAX package off the TPU."""
    sk = 0 if sink_end is None else int(sink_end)
    if window_static is not None:
        sink_tok, recent_tok = window_static
        if sk > sink_tok or int(kv_end) - int(kv_start) > recent_tok:
            raise ValueError(
                f"window [0, {sk}) + [{kv_start}, {kv_end}) exceeds "
                f"window_static {window_static}")
    wide = _wider(q, k_new, v_new)
    if wide is not None:
        q_bf, kn_bf, vn_bf = _bf16(q, k_new, v_new)
        return decode_attention_fresh(
            q_bf, k_cache, v_cache, kn_bf, vn_bf, kv_start, kv_end, scale,
            static_hi, layer_idx, heads_packed, softmax, sink_end, quant,
            tk_align, window_static, fixed_m0, int8_bound, kernels,
            save_cache).to(wide)
    args = dict(kv_start=int(kv_start), kv_end=int(kv_end), scale=scale,
                static_hi=static_hi, layer_idx=layer_idx,
                heads_packed=heads_packed, softmax=softmax, sink_end=sk,
                quant=quant, tk_align=tk_align,
                fixed_m0=_bound(fixed_m0, q.device), int8_bound=int8_bound,
                kernels=kernels)
    if _needs_grad(q, k_new, v_new):
        return _DecodeFresh.apply(q, k_new, v_new, k_cache, v_cache, args,
                                  save_cache)
    return _decode_dispatch(q, k_cache, v_cache, k_new, v_new, **args)


def _window_rows(k_cache, v_cache, layer_idx, kv_start, kv_end, sink_end):
    """Copies of the cache rows at the edges of the visible window of
    layer ``layer_idx``: a witness that a backward reads the rows its
    forward read (None for an empty window)."""
    kc = k_cache[layer_idx] if k_cache.dim() == 4 else k_cache
    vc = v_cache[layer_idx] if v_cache.dim() == 4 else v_cache
    S = kc.shape[-2]
    idx = sorted({i for i in (0, sink_end - 1, kv_start, kv_end - 1)
                  if 0 <= i < S and (i < sink_end or kv_start <= i < kv_end)})
    if not idx:
        return None
    return torch.stack([kc[..., idx, :], vc[..., idx, :]]).clone()


class _DecodeFresh(torch.autograd.Function):
    """Decode attention with the recomputing backward of
    ``_decode_fresh_op_bwd``.  The cache is held by reference (it is
    written in place after the forward); gradients go to q, k_new and
    v_new only, as the cache is stop-gradient in the JAX package."""

    @staticmethod
    def forward(ctx, q, k_new, v_new, k_cache, v_cache, args,
                save_cache=False):
        if q.dim() != 3:
            raise ValueError("the decode attention's gradient takes "
                             "heads-packed or folded 3-D operands")
        if save_cache:
            ctx.save_for_backward(q, k_new, v_new, k_cache, v_cache)
            ctx.cache = None
        else:
            ctx.save_for_backward(q, k_new, v_new)
            ctx.cache = (k_cache, v_cache)
        ctx.args = args
        li = args["layer_idx"] or 0
        ctx.witness = _window_rows(k_cache, v_cache, li, args["kv_start"],
                                   args["kv_end"], args["sink_end"])
        return _decode_dispatch(q, k_cache, v_cache, k_new, v_new, **args)

    @staticmethod
    def backward(ctx, g):
        q, k_new, v_new, *saved = ctx.saved_tensors
        (k_cache, v_cache), a = ctx.cache or saved, ctx.args
        li = a["layer_idx"] or 0
        now = _window_rows(k_cache, v_cache, li, a["kv_start"], a["kv_end"],
                           a["sink_end"])
        if (now is None) != (ctx.witness is None) or (
                now is not None and not torch.equal(now, ctx.witness)):
            raise RuntimeError(
                "decode attention backward: the KV cache rows of the "
                "window changed after the forward (only rows past the "
                "window may be written before the backward)")
        N = a["heads_packed"] or 1
        if a["softmax"] in ("free", "free_noclamp"):
            # base-2 softmax of s * scale == base-e softmax at scale * ln 2
            scale = (1.0 if a["scale"] is None else a["scale"]) \
                * math.log(2.0)
        else:
            scale = ((q.shape[-1] // N) ** -0.5 if a["scale"] is None
                     else a["scale"])
        fn = (cuda_attention.decode_fresh_bwd
              if a["kernels"] and q.is_cuda
              else cuda_attention.decode_fresh_bwd_ref)
        dq, dkn, dvn = fn(
            q, k_cache, v_cache, k_new, v_new, g.contiguous(),
            layer_idx=li, kv_start=a["kv_start"], kv_end=a["kv_end"],
            sink_end=a["sink_end"], num_heads=N, scale=scale)
        return dq, dkn, dvn, None, None, None, None


def _decode_kernel(softmax, quant, fixed_m0, int8_bound) -> tuple[str, str]:
    """(kernel, mode) of the decode attention on the kernel route, as the
    JAX package's ``decode_attention_fresh_pallas`` dispatches: 'bf16' in a
    ``cuda_attention.DECODE_MODES`` mode, 'int8qk', or 'int8' in an
    ``INT8_MODES`` mode."""
    if softmax in ("free", "free_noclamp"):
        if fixed_m0 is not None:
            raise ValueError("the free softmax takes no score bound")
        if quant == "int8qk" and softmax == "free":
            return "int8qk", "free"
        if quant is not None:
            raise ValueError(f"softmax={softmax!r} is a bf16 mode (or "
                             f"'free' with int8qk), not quant={quant!r}")
        return "bf16", softmax
    if softmax is not None:
        raise ValueError(f"unknown decode softmax {softmax!r}")
    if quant == "int8qk":
        raise ValueError("int8qk exists only with the free softmax")
    if quant == "int8":
        if fixed_m0 is None:
            return "int8", "online"
        if int8_bound not in ("tile", "global"):
            raise ValueError(f"unknown int8_bound {int8_bound!r}")
        return "int8", int8_bound
    if quant is not None:
        raise ValueError(f"unknown decode quant {quant!r}")
    return "bf16", "online" if fixed_m0 is None else "bounded"


def _decode_dispatch(q, k_cache, v_cache, k_new, v_new, *, kv_start, kv_end,
                     scale, static_hi, layer_idx, heads_packed, softmax,
                     sink_end, quant, tk_align, fixed_m0, int8_bound,
                     kernels):
    sk = sink_end
    int8qk = quant == "int8qk" and softmax == "free"
    if _kernel_route(q) or int8qk:
        kind, mode = _decode_kernel(softmax, quant, fixed_m0, int8_bound)
        N = heads_packed if heads_packed is not None else 1
        if scale is None:   # the free modes' caller folded it into q
            scale = 1.0 if kind == "int8qk" or mode.startswith("free") \
                else (q.shape[-1] // N) ** -0.5
        args = dict(layer_idx=0 if layer_idx is None else int(layer_idx),
                    kv_start=int(kv_start), kv_end=int(kv_end), sink_end=sk,
                    static_hi=static_hi, num_heads=N, scale=scale)
        if kind == "bf16":
            fn = (cuda_attention.decode_fresh if kernels
                  else cuda_attention.decode_fresh_ref)
            return fn(q, k_cache, v_cache, k_new, v_new, mode=mode,
                      m0=fixed_m0, **args)
        tq, tk, tf = decode_tiles(q.shape[1], k_cache.shape[-2],
                                  k_new.shape[1], quant, softmax, tk_align)
        if kind == "int8qk":
            fn = (cuda_attention.decode_fresh_int8qk if kernels
                  else cuda_attention.decode_fresh_int8qk_ref)
            return fn(q, k_cache, v_cache, k_new, v_new, tq=tq, tk=tk,
                      tf=tf, **args)
        fn = (cuda_attention.decode_fresh_int8 if kernels
              else cuda_attention.decode_fresh_int8_ref)
        return fn(q, k_cache, v_cache, k_new, v_new, mode=mode, m0=fixed_m0,
                  tq=tq, tk=tk, tf=tf, **args)
    if softmax in ("free", "free_noclamp"):
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


# =====================================================================
# masked long-sequence attention (training)
# =====================================================================

def _chunked_online_attention(q, k, v, scale, visible_fn, kv_chunk):
    """Online-softmax attention over KV chunks (the JAX package's XLA
    reference).  q: [B, Lq, N, D]; k/v: [B, Lk, N, D];
    ``visible_fn(kv_idx) -> bool [Lq, C]``.  Returns (out [B, Lq, N, D],
    lse [B, N, Lq] fp32, 0 where a row saw nothing)."""
    Lk = k.shape[1]
    qf = q.transpose(1, 2).float() * scale          # [B, N, Lq, D]
    kf, vf = k.transpose(1, 2), v.transpose(1, 2)
    B, N, Lq, D = qf.shape
    m = torch.full((B, N, Lq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((B, N, Lq, 1), device=q.device)
    o = torch.zeros((B, N, Lq, D), device=q.device)
    for lo in range(0, Lk, kv_chunk):
        kc, vc = kf[:, :, lo:lo + kv_chunk].float(), \
            vf[:, :, lo:lo + kv_chunk].float()
        s = qf @ kc.transpose(-1, -2)
        idx = torch.arange(lo, lo + kc.shape[2], device=q.device)
        s = torch.where(visible_fn(idx), s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + p @ vc
        m = m_new
    out = (o / torch.clamp_min(l, 1e-30)).transpose(1, 2).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), 0.0)
    return out, lse[..., 0]


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: IntervalMask | None = None,
                        scale: float | None = None, kv_chunk: int = 1024,
                        return_lse: bool = False):
    """Masked long-sequence attention, chunked online softmax (port of the
    JAX ``flash_attention_xla``): the CPU route of :func:`flash_attention`.
    q/k/v: [B, L, N, D]; ``mask`` covers queries [0, Lq) and keys [0, Lk);
    None is full attention.  ``return_lse``: also the base-e row
    log-sum-exp [B, N, Lq] the backward needs."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    Lq = q.shape[1]
    if mask is None:
        def visible_fn(idx):
            return torch.ones((Lq, idx.shape[0]), dtype=torch.bool,
                              device=q.device)
    else:
        s1, e1, s2, e2 = (torch.from_numpy(a[:Lq].astype("int64")).to(
            q.device)[:, None] for a in (mask.start1, mask.end1,
                                         mask.start2, mask.end2))

        def visible_fn(idx):
            j = idx[None, :]
            return ((j >= s1) & (j < e1)) | ((j >= s2) & (j < e2))
    out, lse = _chunked_online_attention(q, k, v, scale, visible_fn,
                                         kv_chunk)
    return (out, lse) if return_lse else out


class FlashAttention(torch.autograd.Function):
    """Masked flash attention with the gradient of the JAX package's
    ``flash_attention_pallas`` custom VJP; saves (q, k, v, out, lse).

    ``mode`` ('free', 'bounded' or 'online'; the kernel route):
    ``cuda_attention.flash_fwd`` in that mode (bound ``m0``) and the
    backward ``flash_bwd`` (dq, dk, dv in one kernel) against its base-e
    lse, at ln 2 for 'free' (q carries head_dim**-0.5 * log2(e)) and at
    ``scale`` otherwise (the kernels, or the plain versions
    ``flash_bwd_dq_ref`` / ``flash_bwd_dkv_ref`` with ``kernels=False``).
    ``mode=None`` (off the route): the online-softmax reference forward
    at ``scale`` and the plain backward at it."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, mode, m0, kernels):
        ca = cuda_attention
        if mode is None:
            out, lse = flash_attention_xla(q, k, v, mask, scale=scale,
                                           return_lse=True)
            bwd_scale = scale
        else:
            out, lse = (ca.flash_fwd if kernels else ca.flash_fwd_ref)(
                q, k, v, mask, mode, scale, m0)
            bwd_scale = ca.LN2 if mode == "free" else scale
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.scale = mask, bwd_scale
        ctx.kernels = kernels
        return out

    @staticmethod
    def backward(ctx, do):
        ca = cuda_attention
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = ca.flash_delta(out, do)
        args = (q, k, v, do, lse, delta, ctx.mask, ctx.scale)
        if ctx.kernels:
            dq, dk, dv = ca.flash_bwd(*args)
        else:
            dq = ca.flash_bwd_dq_ref(*args)
            dk, dv = ca.flash_bwd_dkv_ref(*args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: IntervalMask | None = None,
                    scale: float | None = None, fixed_m0=None,
                    softmax: str | None = None,
                    kernels: bool = True) -> torch.Tensor:
    """Masked long-sequence self-attention, q/k/v [B, L, N, D], with its
    gradient.  On the kernel route the flash kernels (or, with
    ``kernels=False``, their plain versions) in the Pallas wrapper's
    modes: ``softmax='free'`` (the caller folded head_dim**-0.5 *
    log2(e) into q; no bound), the bounded softmax with ``fixed_m0`` (a
    float32 bound on every score at ``scale``, kept on the device), else
    the online softmax; ``scale`` defaults to head_dim**-0.5.  Off the
    route (the CPU), as the JAX package off the TPU: the online softmax
    at ``scale`` (``ln 2`` for 'free'; the bound is ignored)."""
    if softmax not in (None, "free"):
        raise ValueError(f"unknown flash softmax {softmax!r}")
    if _kernel_route(q):
        if softmax == "free":
            if fixed_m0 is not None:
                raise ValueError("the free softmax takes no score bound")
            mode, scale = "free", 1.0
        else:
            mode = "online" if fixed_m0 is None else "bounded"
            scale = q.shape[-1] ** -0.5 if scale is None else scale
        wide = _wider(q, k, v)
        ops = _bf16(q, k, v) if wide is not None else (q, k, v)
        out = FlashAttention.apply(*ops, mask, scale, mode,
                                   _bound(fixed_m0, q.device), kernels)
        return out if wide is None else out.to(wide)
    if softmax == "free":
        scale = math.log(2.0)
    elif scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, mask, scale, None, None, False)
