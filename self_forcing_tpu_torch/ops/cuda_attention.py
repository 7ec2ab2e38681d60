"""Hand-written CUDA attention kernels and their plain PyTorch versions.

Port of the kernels of ``self_forcing_tpu/ops/pallas_attention.py``
that the streaming sampler runs:

- ``decode_fresh_free`` (csrc/decode_fresh.cu) replaces
  ``_decode_fresh_kernel`` in 'free' mode (``decode_attention_fresh_pallas``
  with ``softmax='free'``);
- ``decode_fresh_int8qk`` (csrc/decode_int8qk.cu: the pre-pass
  ``int8qk_quantize`` and the attention ``int8qk_attend``) replaces
  ``_decode_fresh_int8_kernel`` in 'free_qk' mode
  (``decode_attention_fresh_pallas`` with ``softmax='free',
  quant='int8qk'``);
- ``cross_attention`` (csrc/cross_attention.cu) replaces ``_cross_kernel``
  (``cross_attention_pallas``).

Each wrapper runs its plain version (``*_ref``, same signature) for a
tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.
Every launch adds one to ``launch_counts[name]``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.ops import build

HEAD_DIM = 128  # the head dim the kernels are compiled for

launch_counts = {"decode_fresh_free": 0, "int8qk_quantize": 0,
                 "decode_fresh_int8qk": 0, "cross_attention": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


# =====================================================================
# decode attention with fresh K/V, offset-free base-2 softmax
# =====================================================================

def _cache_lim(S: int, kv_start: int, kv_end: int, sink_end: int,
               static_hi: int | None) -> int:
    """Cache columns at or past this index are never visible."""
    lim = min(S, max(sink_end, kv_end))
    if static_hi is not None:
        lim = min(lim, static_hi)
    return max(lim, 0)


def _stacked(k_cache: torch.Tensor, layer_idx: int) -> torch.Tensor:
    """The chosen layer [BN, S, D] of a stacked [L, BN, S, D] cache (or a
    3-D cache as it is)."""
    return k_cache[layer_idx] if k_cache.dim() == 4 else k_cache


def decode_fresh_free_ref(q, k_cache, v_cache, k_new, v_new, *,
                          layer_idx: int, kv_start: int, kv_end: int,
                          sink_end: int = 0, static_hi: int | None = None,
                          num_heads: int, scale: float = 1.0
                          ) -> torch.Tensor:
    """Plain version of :func:`decode_fresh_free`: the same visibility,
    clamp, exp2 and bf16 rounding of p, one head at a time (the score
    block of one head at the 1.3B shapes is ~0.6 GB in fp32)."""
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    kc, vc = _stacked(k_cache, layer_idx), _stacked(v_cache, layer_idx)
    S = kc.shape[1]
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    j = torch.arange(lim, device=q.device)
    vis = (j < sink_end) | ((j >= kv_start) & (j < kv_end))
    out = torch.empty_like(q)
    for b in range(B):
        for n in range(N):
            cols = slice(n * D, (n + 1) * D)
            qh = q[b, :, cols].float()
            k = torch.cat([kc[b * N + n, :lim].float(),
                           k_new[b, :, cols].float()])
            v = torch.cat([vc[b * N + n, :lim].float(),
                           v_new[b, :, cols].float()])
            s = (qh @ k.T) * scale
            p = torch.exp2(torch.clamp_max(s, 80.0))
            p[:, :lim] = torch.where(vis, p[:, :lim], 0.0)
            l = p.sum(dim=-1, keepdim=True)
            acc = p.to(torch.bfloat16).float() @ v
            out[b, :, cols] = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out


def decode_fresh_free(q, k_cache, v_cache, k_new, v_new, *,
                      layer_idx: int, kv_start: int, kv_end: int,
                      sink_end: int = 0, static_hi: int | None = None,
                      num_heads: int, scale: float = 1.0) -> torch.Tensor:
    """Decode attention of a block's queries onto the cache window
    ``[0, sink_end) + [kv_start, kv_end)`` of layer ``layer_idx`` plus all
    of the block's fresh K/V, with the offset-free base-2 softmax (the
    caller folded ``head_dim**-0.5 * log2(e)`` into q).

    q, k_new, v_new: heads-packed [B, L, N*D]; k_cache/v_cache: stacked
    [L, B*N, S, D] (or one layer [B*N, S, D]).  ``static_hi``: a promise
    that no visible cache column lies at or past it; cache tiles from
    there on are not visited.  The folded [B*N, L, D] layout is this with
    ``num_heads=1``.  Returns [B, Lq, N*D]."""
    args = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
                sink_end=sink_end, static_hi=static_hi,
                num_heads=num_heads, scale=scale)
    if not q.is_cuda:
        return decode_fresh_free_ref(q, k_cache, v_cache, k_new, v_new,
                                     **args)
    kc, vc = _stacked(k_cache, layer_idx), _stacked(v_cache, layer_idx)
    _check_cuda("decode_fresh_free", q, kc, vc, k_new, v_new)
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    BN, S, Dc = kc.shape
    Lf = k_new.shape[1]
    if D != HEAD_DIM or Dc != D or BN != B * N or vc.shape != kc.shape \
            or k_new.shape != (B, Lf, ND) or v_new.shape != k_new.shape:
        raise ValueError(
            f"decode_fresh_free: unsupported shapes q {tuple(q.shape)}, "
            f"cache {tuple(kc.shape)}, fresh {tuple(k_new.shape)} with "
            f"{N} heads (the kernel takes head_dim {HEAD_DIM})")
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    out = torch.empty_like(q)
    fn = build.function("decode_fresh", "decode_fresh_free_launch",
              [_P] * 6 + [_I] * 9 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), out.data_ptr(), B, N, Lq, Lf, S,
             int(kv_start), int(kv_end), int(sink_end), lim, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("decode_fresh_free", err)
    launch_counts["decode_fresh_free"] += 1
    return out


# =====================================================================
# decode attention with fresh K/V, int8 QK^T (per-tile scales), bf16 P.V
# =====================================================================

class Int8QK(NamedTuple):
    """What the int8-QK pre-pass hands the attention: int8 q, cache K and
    fresh K folded [B*N, tiles * tile, D] (zero rows past each length),
    and their f32 scales [B*N, tiles].  A cache tile that the window does
    not meet is never read: its scale is 0 (its rows are 0 in the plain
    version and not written by the kernel)."""
    q8: torch.Tensor
    qs: torch.Tensor
    kc8: torch.Tensor
    ksc: torch.Tensor
    kn8: torch.Tensor
    ksf: torch.Tensor


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def live_cache_tiles(n_tiles: int, tk: int, kv_start: int, kv_end: int,
                     sink_end: int) -> list[bool]:
    """Which cache tiles of ``tk`` rows the window [0, sink_end) +
    [kv_start, kv_end) meets: the tiles the Pallas kernel visits, and the
    only ones quantized."""
    return [t * tk < sink_end or (t * tk < kv_end and t * tk + tk > kv_start)
            for t in range(n_tiles)]


def _fold(a: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Heads-packed [B, L, N*D] -> folded [B*N, L, D]."""
    B, L, ND = a.shape
    D = ND // num_heads
    return a.reshape(B, L, num_heads, D).permute(0, 2, 1, 3).reshape(
        B * num_heads, L, D)


def _tile_quant(x: torch.Tensor, T: int, n: int, q_scale: bool):
    """Symmetric int8 of float rows x [BN, R, D] over ``n`` tiles of ``T``
    rows (rows past R count as zero): (int8 [BN, n*T, D], scales [BN, n]).
    q's scale is max(amax, 1e-8) / 127, k's max(amax / 127, 1e-8), as in
    the TPU kernel.  The 127 is a tensor: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, not the kernels' true
    division."""
    BN, R, D = x.shape
    rows = n * T
    x = x[:, :rows] if R >= rows else F.pad(x, (0, 0, 0, rows - R))
    t = x.reshape(BN, n, T, D)
    amax = t.abs().amax(dim=(2, 3))
    c127 = x.new_tensor(127.0)
    s = (torch.clamp_min(amax, 1e-8) / c127 if q_scale
         else torch.clamp_min(amax / c127, 1e-8))
    q8 = torch.clamp(torch.round(t / s[:, :, None, None]), -127, 127)
    return q8.to(torch.int8).reshape(BN, rows, D), s


def int8qk_quantize_ref(q, k_cache, k_new, *, layer_idx: int, kv_start: int,
                        kv_end: int, sink_end: int = 0,
                        static_hi: int | None = None, num_heads: int,
                        tq: int, tk: int, tf: int) -> Int8QK:
    """Plain version of :func:`int8qk_quantize`."""
    N = num_heads
    kc = _stacked(k_cache, layer_idx)
    lim = _cache_lim(kc.shape[1], kv_start, kv_end, sink_end, static_hi)
    q8, qs = _tile_quant(_fold(q, N).float(), tq, _cdiv(q.shape[1], tq),
                         True)
    ntc = _cdiv(lim, tk)
    kc8, ksc = _tile_quant(kc.float(), tk, ntc, False)
    live = torch.tensor(live_cache_tiles(ntc, tk, kv_start, kv_end,
                                         sink_end), dtype=torch.bool,
                        device=q.device)
    ksc = torch.where(live, ksc, 0.0)
    kc8 = (kc8.reshape(kc8.shape[0], ntc, tk, kc.shape[2])
           * live[:, None, None].to(torch.int8)).reshape(kc8.shape)
    kn8, ksf = _tile_quant(_fold(k_new, N).float(), tf,
                           _cdiv(k_new.shape[1], tf), False)
    return Int8QK(q8, qs, kc8, ksc, kn8, ksf)


def int8qk_attend_ref(qq: Int8QK, q, v_cache, v_new, *, layer_idx: int,
                      kv_start: int, kv_end: int, sink_end: int = 0,
                      static_hi: int | None = None, num_heads: int,
                      scale: float = 1.0, tq: int, tk: int, tf: int
                      ) -> torch.Tensor:
    """Plain version of :func:`int8qk_attend`, one head at a time.  The
    int8 products are summed in float32, which is exact (every partial
    sum is an integer below 2**24)."""
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    vc = _stacked(v_cache, layer_idx)
    S = vc.shape[1]
    Lf = v_new.shape[1]
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    j = torch.arange(lim, device=q.device)
    vis = (j < sink_end) | ((j >= kv_start) & (j < kv_end))
    qs_row = qq.qs.repeat_interleave(tq, dim=1)[:, :Lq]
    ks_col = torch.cat([qq.ksc.repeat_interleave(tk, dim=1)[:, :lim],
                        qq.ksf.repeat_interleave(tf, dim=1)[:, :Lf]], dim=1)
    out = torch.empty_like(q)
    for b in range(B):
        for n in range(N):
            bn = b * N + n
            cols = slice(n * D, (n + 1) * D)
            k8 = torch.cat([qq.kc8[bn, :lim], qq.kn8[bn, :Lf]]).float()
            a = qs_row[bn, :, None] * ks_col[bn, None, :]
            if scale != 1.0:
                a = a * scale
            s = (qq.q8[bn, :Lq].float() @ k8.T) * a
            s[:, :lim] = torch.where(vis, s[:, :lim], float("-inf"))
            p = torch.exp2(torch.clamp_max(s, 80.0))
            l = p.sum(dim=-1, keepdim=True)
            v = torch.cat([vc[bn, :lim].float(), v_new[b, :, cols].float()])
            acc = p.to(torch.bfloat16).float() @ v
            out[b, :, cols] = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out


def decode_fresh_int8qk_ref(q, k_cache, v_cache, k_new, v_new, *,
                            layer_idx: int, kv_start: int, kv_end: int,
                            sink_end: int = 0, static_hi: int | None = None,
                            num_heads: int, scale: float = 1.0, tq: int,
                            tk: int, tf: int) -> torch.Tensor:
    """Plain version of :func:`decode_fresh_int8qk`: the function of the
    TPU kernel ``_decode_fresh_int8_kernel`` in 'free_qk' mode."""
    win = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
               sink_end=sink_end, static_hi=static_hi, num_heads=num_heads,
               tq=tq, tk=tk, tf=tf)
    qq = int8qk_quantize_ref(q, k_cache, k_new, **win)
    return int8qk_attend_ref(qq, q, v_cache, v_new, scale=scale, **win)


def _check_tiles(name: str, tq: int, tk: int, tf: int,
                 min_k: int = 1) -> None:
    if tq < 1 or min(tk, tf) < min_k:
        raise ValueError(f"{name}: tiles {(tq, tk, tf)} (the kernel takes "
                         f"tq >= 1 and tk, tf >= {min_k})")


def int8qk_quantize(q, k_cache, k_new, *, layer_idx: int, kv_start: int,
                    kv_end: int, sink_end: int = 0,
                    static_hi: int | None = None, num_heads: int, tq: int,
                    tk: int, tf: int) -> Int8QK:
    """The pre-pass of the int8-QK decode attention: q, the cache tiles of
    layer ``layer_idx`` that the window [0, sink_end) + [kv_start,
    kv_end) meets below ``static_hi``, and k_new, each quantized to int8
    with one scale per tile of tq / tk / tf rows (the TPU kernel's
    tiles).  Operands as in :func:`decode_fresh_free`."""
    win = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
               sink_end=sink_end, static_hi=static_hi, num_heads=num_heads,
               tq=tq, tk=tk, tf=tf)
    if not q.is_cuda:
        return int8qk_quantize_ref(q, k_cache, k_new, **win)
    kc = _stacked(k_cache, layer_idx)
    _check_cuda("int8qk_quantize", q, kc, k_new)
    _check_tiles("int8qk_quantize", tq, tk, tf)
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    BN, S, Dc = kc.shape
    Lf = k_new.shape[1]
    if D != HEAD_DIM or Dc != D or BN != B * N \
            or k_new.shape != (B, Lf, ND):
        raise ValueError(
            f"int8qk_quantize: unsupported shapes q {tuple(q.shape)}, "
            f"cache {tuple(kc.shape)}, fresh {tuple(k_new.shape)} with "
            f"{N} heads (the kernel takes head_dim {HEAD_DIM})")
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    qt, ntc, ntf = _cdiv(Lq, tq), _cdiv(lim, tk), _cdiv(Lf, tf)
    i8, f32 = torch.int8, torch.float32
    qq = Int8QK(q8=q.new_empty(BN, qt * tq, D, dtype=i8),
                qs=q.new_empty(BN, qt, dtype=f32),
                kc8=q.new_empty(BN, ntc * tk, D, dtype=i8),
                ksc=q.new_empty(BN, ntc, dtype=f32),
                kn8=q.new_empty(BN, ntf * tf, D, dtype=i8),
                ksf=q.new_empty(BN, ntf, dtype=f32))
    fn = build.function("decode_int8qk", "int8qk_quantize_launch",
                        [_P] * 9 + [_I] * 12 + [_P])
    err = fn(q.data_ptr(), kc.data_ptr(), k_new.data_ptr(),
             *(t.data_ptr() for t in qq), B, N, Lq, Lf, S, int(kv_start),
             int(kv_end), int(sink_end), lim, tq, tk, tf,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("int8qk_quantize", err)
    launch_counts["int8qk_quantize"] += 1
    return qq


def int8qk_attend(qq: Int8QK, q, v_cache, v_new, *, layer_idx: int,
                  kv_start: int, kv_end: int, sink_end: int = 0,
                  static_hi: int | None = None, num_heads: int,
                  scale: float = 1.0, tq: int, tk: int, tf: int
                  ) -> torch.Tensor:
    """The attention of the int8-QK decode attention: the pre-pass's int8
    q onto its int8 K (scores dequantized with the tile scales, times
    ``scale``), the offset-free base-2 softmax, bf16 P.V with V of layer
    ``layer_idx`` and v_new.  ``q`` gives the output's shape and type.
    Returns [B, Lq, N*D]."""
    win = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
               sink_end=sink_end, static_hi=static_hi, num_heads=num_heads,
               scale=scale, tq=tq, tk=tk, tf=tf)
    if not q.is_cuda:
        return int8qk_attend_ref(qq, q, v_cache, v_new, **win)
    vc = _stacked(v_cache, layer_idx)
    _check_cuda("int8qk_attend", q, vc, v_new)
    # a 64-key tile of the kernel meets at most two k-scale tiles
    _check_tiles("int8qk_attend", tq, tk, tf, min_k=64)
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    BN, S, Dc = vc.shape
    Lf = v_new.shape[1]
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    qt, ntc, ntf = _cdiv(Lq, tq), _cdiv(lim, tk), _cdiv(Lf, tf)
    want = [(BN, qt * tq, D), (BN, qt), (BN, ntc * tk, D), (BN, ntc),
            (BN, ntf * tf, D), (BN, ntf)]
    if D != HEAD_DIM or Dc != D or BN != B * N \
            or v_new.shape != (B, Lf, ND) \
            or [tuple(t.shape) for t in qq] != want:
        raise ValueError(
            f"int8qk_attend: unsupported shapes q {tuple(q.shape)}, "
            f"cache {tuple(vc.shape)}, fresh {tuple(v_new.shape)}, int8 "
            f"operands {[tuple(t.shape) for t in qq]} with {N} heads and "
            f"tiles {(tq, tk, tf)}")
    for t, dt in zip(qq, (torch.int8, torch.float32) * 3):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise TypeError("int8qk_attend: the int8 operands must be the "
                            "pre-pass's contiguous int8 / float32 tensors "
                            "on q's device")
    out = torch.empty_like(q)
    fn = build.function("decode_int8qk", "int8qk_attend_launch",
                        [_P] * 9 + [_I] * 12 + [ctypes.c_float, _P])
    err = fn(*(t.data_ptr() for t in qq), vc.data_ptr(), v_new.data_ptr(),
             out.data_ptr(), B, N, Lq, Lf, S, int(kv_start), int(kv_end),
             int(sink_end), lim, tq, tk, tf, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("int8qk_attend", err)
    launch_counts["decode_fresh_int8qk"] += 1
    return out


def decode_fresh_int8qk(q, k_cache, v_cache, k_new, v_new, *,
                        layer_idx: int, kv_start: int, kv_end: int,
                        sink_end: int = 0, static_hi: int | None = None,
                        num_heads: int, scale: float = 1.0, tq: int, tk: int,
                        tf: int) -> torch.Tensor:
    """:func:`decode_fresh_free` with QK^T in int8: the pre-pass
    (:func:`int8qk_quantize`) quantizes q per (head, tq rows) and K per
    tk cache rows / tf fresh rows, then :func:`int8qk_attend` runs the
    attention with bf16 P.V.  The tiles are the TPU kernel's
    (``ops/attention.py::decode_tiles``), so the result is its function.
    Returns [B, Lq, N*D]."""
    win = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
               sink_end=sink_end, static_hi=static_hi, num_heads=num_heads,
               tq=tq, tk=tk, tf=tf)
    if not q.is_cuda:
        return decode_fresh_int8qk_ref(q, k_cache, v_cache, k_new, v_new,
                                       scale=scale, **win)
    qq = int8qk_quantize(q, k_cache, k_new, **win)
    return int8qk_attend(qq, q, v_cache, v_new, scale=scale, **win)


# =====================================================================
# cross attention onto a small static K/V
# =====================================================================

def cross_attention_ref(q, k, v, *, num_heads: int,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version of :func:`cross_attention`, in fp32."""
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    scale = D ** -0.5 if scale is None else scale
    q4 = q.reshape(B, Lq, N, D).float()
    s = torch.einsum("bqnd,bknd->bnqk", q4, k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bnqk,bknd->bnqd", p, v.float())
    out = pv / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).reshape(B, Lq, ND).to(q.dtype)


def cross_attention(q, k, v, *, num_heads: int,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(scale * q k^T) v with the whole (<= 1024-token) K/V in one
    pass.  q: heads-packed [B, Lq, N*D]; k/v: [B, Lk, N, D]; returns
    [B, Lq, N*D].  ``scale`` defaults to head_dim**-0.5."""
    if not q.is_cuda:
        return cross_attention_ref(q, k, v, num_heads=num_heads,
                                   scale=scale)
    _check_cuda("cross_attention", q, k, v)
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    Lk = k.shape[1]
    if D != HEAD_DIM or k.shape != (B, Lk, N, D) or v.shape != k.shape \
            or not 1 <= Lk <= 1024:
        raise ValueError(
            f"cross_attention: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)} with {N} heads (the kernel takes head_dim "
            f"{HEAD_DIM} and 1..1024 keys)")
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    fn = build.function("cross_attention", "cross_attention_launch",
              [_P] * 4 + [_I] * 4 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, N, Lq, Lk, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("cross_attention", err)
    launch_counts["cross_attention"] += 1
    return out
