"""Hand-written CUDA attention kernels and their plain PyTorch versions.

Port of the kernels of ``self_forcing_tpu/ops/pallas_attention.py``
that the streaming sampler and the training step run:

- ``decode_fresh`` (csrc/decode_fresh.cu) replaces ``_decode_fresh_kernel``
  in its bf16 modes (``decode_attention_fresh_pallas``): 'free' and
  'free_noclamp' (``softmax=``), 'bounded' (``fixed_m0``) and online
  (neither); ``decode_fresh_free`` is its 'free' mode, the sampler's
  default;
- ``decode_fresh_int8qk`` (csrc/decode_int8qk.cu: the pre-pass
  ``int8qk_quantize`` and the attention ``int8qk_attend``) replaces
  ``_decode_fresh_int8_kernel`` in 'free_qk' mode (``softmax='free',
  quant='int8qk'``);
- ``decode_fresh_int8`` (the same pre-pass for q and K,
  csrc/decode_int8.cu's ``int8_quantize_v`` for V and ``int8_attend``)
  replaces ``_decode_fresh_int8_kernel`` in its 'tile', 'global' and
  online modes (``quant='int8'``, with a bound or without);
- ``cross_attention`` (csrc/decode_fresh.cu's ``cross_attention_launch``:
  the decode kernel's online mode with no cache, P.V from the hi and lo
  bf16 parts of p) replaces ``_cross_kernel`` (``cross_attention_pallas``);
- ``decode_window`` (csrc/decode_fresh.cu's ``decode_window_launch``)
  replaces ``_decode_kernel`` (``decode_attention_pallas``): the cache
  window alone, bounds read on the device, in bf16 (the online decode
  kernel with no fresh keys, counted as ``decode_window``) or float32 (a
  3xTF32 kernel, ``decode_window_f32``);
- ``flash_fwd`` (csrc/flash_attention.cu) replaces ``_flash_kernel`` in
  its free, bounded and online modes (``flash_attention_pallas``);
- ``flash_bwd`` (csrc/flash_bwd.cu: dq, dk and dv in one pass) replaces
  both ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` (the
  backward ``_flash_bwd``).

A bound ``m0`` is a float32 tensor that the kernels read from device
memory, so no layer waits for the host.  Each wrapper runs its plain
version (``*_ref``, same signature) for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises.  Every launch adds one to
``launch_counts[name]`` (the decode and flash modes count under their
own names).

The gradients: :class:`FlashAttention` (the flash forward and its
backward kernel) and the plain-PyTorch backward of the decode and cross
attention (:func:`decode_fresh_bwd`, :func:`cross_attention_bwd`), which
recompute the attention as the JAX package's XLA backward does.
"""
from __future__ import annotations

import ctypes
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.ops import build

HEAD_DIM = 128  # the head dim the kernels are compiled for

launch_counts = {"decode_fresh_free": 0, "decode_fresh_free_noclamp": 0,
                 "decode_fresh_bounded": 0, "decode_fresh_online": 0,
                 "int8qk_quantize": 0, "decode_fresh_int8qk": 0,
                 "int8_quantize_v": 0, "decode_fresh_int8_tile": 0,
                 "decode_fresh_int8_global": 0, "decode_fresh_int8_online": 0,
                 "cross_attention": 0, "flash_fwd": 0, "flash_fwd_online": 0,
                 "flash_fwd_bounded": 0, "flash_bwd": 0, "decode_window": 0,
                 "decode_window_f32": 0}


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
# decode attention with fresh K/V: the bf16 softmax modes
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


# the softmax modes of the bf16 decode kernel: the offset-free base-2
# softmax with and without its overflow clamp (the caller folded
# head_dim**-0.5 * log2(e) into q), the base-e softmax offset by the
# caller's score bound m0, and the online softmax (running row max)
DECODE_MODES = {"free": 0, "free_noclamp": 1, "bounded": 2, "online": 3}


def _m0_tensor(m0, mode: str, device) -> torch.Tensor | None:
    """The bound of 'bounded' mode as a float32 tensor on ``device`` (a
    tensor stays where it is: the kernels read it from device memory, so
    no layer waits for the host)."""
    if mode not in ("bounded", "tile", "global"):
        return None
    if m0 is None:
        raise ValueError(f"softmax mode {mode!r} needs the score bound m0")
    return torch.as_tensor(m0, dtype=torch.float32, device=device)


def decode_fresh_ref(q, k_cache, v_cache, k_new, v_new, *, mode: str,
                     m0=None, layer_idx: int, kv_start: int, kv_end: int,
                     sink_end: int = 0, static_hi: int | None = None,
                     num_heads: int, scale: float = 1.0) -> torch.Tensor:
    """Plain version of :func:`decode_fresh`, one head at a time (the
    score block of one head at the 1.3B shapes is ~0.6 GB in fp32): the
    Pallas kernel's function in each mode.  'free' / 'free_noclamp' and
    'bounded' round p to bf16 for P.V; 'online' keeps p in float32, as
    the interpreted Pallas kernel does (its online mode stages q, K and V
    in float32), and equals the exact softmax."""
    if mode not in DECODE_MODES:
        raise ValueError(f"unknown decode softmax mode {mode!r}")
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    kc, vc = _stacked(k_cache, layer_idx), _stacked(v_cache, layer_idx)
    S = kc.shape[1]
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    j = torch.arange(lim + k_new.shape[1], device=q.device)
    vis = (j >= lim) | (j < sink_end) | ((j >= kv_start) & (j < kv_end))
    m0 = _m0_tensor(m0, mode, q.device)
    out = torch.empty_like(q)
    for b in range(B):
        for n in range(N):
            cols = slice(n * D, (n + 1) * D)
            qh = q[b, :, cols].float()
            k = torch.cat([kc[b * N + n, :lim].float(),
                           k_new[b, :, cols].float()])
            v = torch.cat([vc[b * N + n, :lim].float(),
                           v_new[b, :, cols].float()])
            if mode == "online":
                s = torch.where(vis, (qh * scale) @ k.T, float("-inf"))
                p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            else:
                s = (qh @ k.T) * scale
                if mode == "free":
                    p = torch.exp2(torch.clamp_max(s, 80.0))
                elif mode == "free_noclamp":
                    p = torch.exp2(s)
                else:
                    p = torch.exp(s - m0)
                p = torch.where(vis, p, 0.0)
            l = p.sum(dim=-1, keepdim=True)
            pv = p if mode == "online" else p.to(torch.bfloat16).float()
            out[b, :, cols] = ((pv @ v) / torch.clamp_min(l, 1e-30)
                               ).to(q.dtype)
    return out


def decode_fresh(q, k_cache, v_cache, k_new, v_new, *, mode: str, m0=None,
                 layer_idx: int, kv_start: int, kv_end: int,
                 sink_end: int = 0, static_hi: int | None = None,
                 num_heads: int, scale: float = 1.0) -> torch.Tensor:
    """Decode attention of a block's queries onto the cache window
    ``[0, sink_end) + [kv_start, kv_end)`` of layer ``layer_idx`` plus all
    of the block's fresh K/V, in softmax ``mode`` (:data:`DECODE_MODES`):
    'free' / 'free_noclamp' p = 2^(scale * q.k) (with / without the clamp
    at 80); 'bounded' p = exp(scale * q.k - m0), ``m0`` a float32 bound
    on every score (a 1-element tensor, read by the kernel on the card);
    'online' the running-max softmax at ``scale``.

    q, k_new, v_new: heads-packed [B, L, N*D]; k_cache/v_cache: stacked
    [L, B*N, S, D] (or one layer [B*N, S, D]).  ``static_hi``: a promise
    that no visible cache column lies at or past it; cache tiles from
    there on are not visited.  The folded [B*N, L, D] layout is this with
    ``num_heads=1``.  Returns [B, Lq, N*D]."""
    args = dict(mode=mode, m0=m0, layer_idx=layer_idx, kv_start=kv_start,
                kv_end=kv_end, sink_end=sink_end, static_hi=static_hi,
                num_heads=num_heads, scale=scale)
    if not q.is_cuda:
        return decode_fresh_ref(q, k_cache, v_cache, k_new, v_new, **args)
    if mode not in DECODE_MODES:
        raise ValueError(f"unknown decode softmax mode {mode!r}")
    kc, vc = _stacked(k_cache, layer_idx), _stacked(v_cache, layer_idx)
    _check_cuda("decode_fresh", q, kc, vc, k_new, v_new)
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    BN, S, Dc = kc.shape
    Lf = k_new.shape[1]
    if D != HEAD_DIM or Dc != D or BN != B * N or vc.shape != kc.shape \
            or k_new.shape != (B, Lf, ND) or v_new.shape != k_new.shape:
        raise ValueError(
            f"decode_fresh: unsupported shapes q {tuple(q.shape)}, "
            f"cache {tuple(kc.shape)}, fresh {tuple(k_new.shape)} with "
            f"{N} heads (the kernel takes head_dim {HEAD_DIM})")
    m0t = _m0_tensor(m0, mode, q.device)
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    out = torch.empty_like(q)
    fn = build.function("decode_fresh", "decode_fresh_launch",
                        [_P] * 7 + [_I] * 10 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), None if m0t is None else m0t.data_ptr(),
             out.data_ptr(), B, N, Lq, Lf, S, int(kv_start), int(kv_end),
             int(sink_end), lim, DECODE_MODES[mode], float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("decode_fresh", err)
    launch_counts[f"decode_fresh_{mode}"] += 1
    return out


def decode_fresh_free_ref(q, k_cache, v_cache, k_new, v_new, **kw):
    """:func:`decode_fresh_ref` in 'free' mode."""
    return decode_fresh_ref(q, k_cache, v_cache, k_new, v_new, mode="free",
                            **kw)


def decode_fresh_free(q, k_cache, v_cache, k_new, v_new, **kw):
    """:func:`decode_fresh` in 'free' mode (the sampler's default)."""
    return decode_fresh(q, k_cache, v_cache, k_new, v_new, mode="free",
                        **kw)


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
# decode attention with fresh K/V, int8 QK^T and int8 P.V
# =====================================================================

INT8_MODES = {"tile": 0, "global": 1, "online": 2}
LN127 = math.log(127.0)
_NEG_INF = -1e30        # the Pallas kernels' masked score
P_GROUP = 16            # keys a P fragment permutes within
# P.V runs mma.sync m16n8k32 s8 with P in registers: the scores' s32
# accumulator layout puts keys {2t, 2t+1, 8+2t, 9+2t} of a 16-key group
# in the lane that the A fragment gives k slots 4t..4t+3.  V^T stores its
# keys in that order, so the product contracts each key with itself:
# slot k of a group holds key KEY_OF_SLOT[k].
KEY_OF_SLOT = [2 * (k // 4) + (k % 2) + 8 * (k % 4 // 2)
               for k in range(P_GROUP)]
V_PAD = 64              # a V^T tile's keys are padded to this


class Int8V(NamedTuple):
    """What the full-int8 pre-pass adds for V: int8 cache and fresh V per
    Pallas tile, K-major [B*N, tiles, D, tile padded to 64] with the keys
    of every 16-key group in :data:`KEY_OF_SLOT` order (zero past each
    length), and their f32 scales [B*N, tiles] (0, rows unwritten, for a
    cache tile the window does not meet)."""
    vc8: torch.Tensor
    vsc: torch.Tensor
    vn8: torch.Tensor
    vsf: torch.Tensor


def _kmajor(v8: torch.Tensor, n: int, T: int) -> torch.Tensor:
    """int8 rows [BN, n*T, D] -> the K-major tiles of :class:`Int8V`."""
    BN, _, D = v8.shape
    Tp = _cdiv(T, V_PAD) * V_PAD
    t = F.pad(v8.reshape(BN, n, T, D), (0, 0, 0, Tp - T))
    t = t.reshape(BN, n, Tp // P_GROUP, P_GROUP, D)[:, :, :, KEY_OF_SLOT]
    return t.permute(0, 1, 4, 2, 3).reshape(BN, n, D, Tp).contiguous()


def _rows(vt: torch.Tensor, T: int) -> torch.Tensor:
    """K-major tiles [BN, n, D, Tp] -> int8 rows [BN, n*T, D]."""
    BN, n, D, Tp = vt.shape
    slot = [0] * P_GROUP
    for k, key in enumerate(KEY_OF_SLOT):
        slot[key] = k
    t = vt.reshape(BN, n, D, Tp // P_GROUP, P_GROUP)[..., slot]
    return t.permute(0, 1, 3, 4, 2).reshape(BN, n, Tp, D)[:, :, :T] \
        .reshape(BN, n * T, D)


def int8_quantize_v_ref(v_cache, v_new, *, layer_idx: int, kv_start: int,
                        kv_end: int, sink_end: int = 0,
                        static_hi: int | None = None, num_heads: int,
                        tk: int, tf: int) -> Int8V:
    """Plain version of :func:`int8_quantize_v`."""
    N = num_heads
    vc = _stacked(v_cache, layer_idx)
    lim = _cache_lim(vc.shape[1], kv_start, kv_end, sink_end, static_hi)
    ntc, ntf = _cdiv(lim, tk), _cdiv(v_new.shape[1], tf)
    vc8, vsc = _tile_quant(vc.float(), tk, ntc, False)
    live = torch.tensor(live_cache_tiles(ntc, tk, kv_start, kv_end,
                                         sink_end), dtype=torch.bool,
                        device=vc.device)
    vsc = torch.where(live, vsc, 0.0)
    vc8 = (vc8.reshape(vc8.shape[0], ntc, tk, vc.shape[2])
           * live[:, None, None].to(torch.int8)).reshape(vc8.shape)
    vn8, vsf = _tile_quant(_fold(v_new, N).float(), tf, ntf, False)
    return Int8V(_kmajor(vc8, ntc, tk), vsc, _kmajor(vn8, ntf, tf), vsf)


def _int8_tiles(ntc: int, ntf: int, *, kv_start: int, kv_end: int,
                sink_end: int, lim: int, fresh_len: int, tk: int, tf: int,
                device) -> list:
    """The Pallas tiles an int8 attention visits, in its order: (fresh,
    tile index, tile rows, visible columns [rows] bool) for the cache
    tiles the window meets, then every fresh tile."""
    out = []
    live = live_cache_tiles(ntc, tk, kv_start, kv_end, sink_end)
    for t in range(ntc):
        if live[t]:
            j = torch.arange(t * tk, t * tk + tk, device=device)
            out.append((False, t, tk, (j < lim) & (
                (j < sink_end) | ((j >= kv_start) & (j < kv_end)))))
    for t in range(ntf):
        j = torch.arange(t * tf, t * tf + tf, device=device)
        out.append((True, t, tf, j < fresh_len))
    return out


def int8_attend_ref(qq: Int8QK, vv: Int8V, q, *, mode: str, m0=None,
                    layer_idx: int, kv_start: int, kv_end: int,
                    sink_end: int = 0, static_hi: int | None = None,
                    num_heads: int, scale: float, tq: int, tk: int,
                    tf: int, cache_len: int, fresh_len: int
                    ) -> torch.Tensor:
    """Plain version of :func:`int8_attend`: the Pallas kernel's int8
    modes step by step, one head and one Pallas tile at a time (the cache
    tiles that the window meets, then the fresh tiles).  Per tile, with
    s = float(q8.k8) * (qs * (ks * scale)) and -1e30 where masked:
    'tile'   p = exp(s - (m_t - ln 127)), m_t the row's max in the tile,
             w = exp(m_t - m0); l += sum(p) * w,
             acc += float(round(p).v8) * (vs * w);
    'global' p = min(exp(s + (ln 127 - m0)), 127) on visible columns;
             l += sum(p), acc += float(round(p).v8) * vs;
    'online' the running max m, updated once a tile: p against
             m - ln 127, l and acc rescaled by exp(m_prev - m).
    out = acc / max(l, 1e-30).  The int8 products are summed exactly
    (float64 sums of integers) and rounded once to float32, as the
    kernel's int32 sums are."""
    if mode not in INT8_MODES:
        raise ValueError(f"unknown int8 decode mode {mode!r}")
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    f32 = torch.float32
    dev = q.device
    lim = _cache_lim(cache_len, kv_start, kv_end, sink_end, static_hi)
    tiles = _int8_tiles(qq.ksc.shape[1], qq.ksf.shape[1], kv_start=kv_start,
                        kv_end=kv_end, sink_end=sink_end, lim=lim,
                        fresh_len=fresh_len, tk=tk, tf=tf, device=dev)
    v8 = {False: _rows(vv.vc8, tk), True: _rows(vv.vn8, tf)}
    k8 = {False: qq.kc8, True: qq.kn8}
    ks = {False: qq.ksc, True: qq.ksf}
    vs = {False: vv.vsc, True: vv.vsf}
    m0 = _m0_tensor(m0, mode, dev)
    ln127 = torch.tensor(LN127, dtype=f32, device=dev)
    sc = torch.tensor(scale, dtype=f32, device=dev)
    qs_row = qq.qs.repeat_interleave(tq, dim=1)[:, :Lq, None]
    out = torch.empty_like(q)
    for bn in range(B * N):
        q8 = qq.q8[bn, :Lq].double()
        m = torch.full((Lq, 1), _NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((Lq, 1), dtype=f32, device=dev)
        acc = torch.zeros((Lq, D), dtype=f32, device=dev)
        for fresh, t, T, vis in tiles:
            rows = slice(t * T, t * T + T)
            vt = v8[fresh][bn, rows].double()
            vst = vs[fresh][bn, t]
            s = (q8 @ k8[fresh][bn, rows].double().T).to(f32) \
                * (qs_row[bn] * (ks[fresh][bn, t] * sc))
            if mode == "global":
                p = torch.exp(s + (ln127 - m0))
                p = torch.clamp_max(torch.where(vis, p, 0.0), 127.0)
                l = l + p.sum(dim=-1, keepdim=True)
                acc = acc + (torch.round(p).double() @ vt).to(f32) * vst
                continue
            s = torch.where(vis, s, _NEG_INF)
            m_t = s.amax(dim=-1, keepdim=True)
            if mode == "tile":
                p = torch.exp(s - (m_t - ln127))
                w = torch.exp(m_t - m0)
                l = l + p.sum(dim=-1, keepdim=True) * w
                acc = acc + (torch.round(p).double() @ vt).to(f32) \
                    * (vst * w)
            else:
                m_new = torch.maximum(m, m_t)
                p = torch.exp(s - (m_new - ln127))
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + (torch.round(p).double() @ vt).to(f32) \
                    * vst
                m = m_new
        b, n = divmod(bn, N)
        out[b, :, n * D:(n + 1) * D] = (
            acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out


def decode_fresh_int8_ref(q, k_cache, v_cache, k_new, v_new, *, mode: str,
                          m0=None, layer_idx: int, kv_start: int,
                          kv_end: int, sink_end: int = 0,
                          static_hi: int | None = None, num_heads: int,
                          scale: float, tq: int, tk: int,
                          tf: int) -> torch.Tensor:
    """Plain version of :func:`decode_fresh_int8`: the function of the TPU
    kernel ``_decode_fresh_int8_kernel`` in 'tile', 'global' or online
    mode."""
    win = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
               sink_end=sink_end, static_hi=static_hi, num_heads=num_heads,
               tk=tk, tf=tf)
    qq = int8qk_quantize_ref(q, k_cache, k_new, tq=tq, **win)
    vv = int8_quantize_v_ref(v_cache, v_new, **win)
    return int8_attend_ref(qq, vv, q, mode=mode, m0=m0, scale=scale, tq=tq,
                           cache_len=k_cache.shape[-2],
                           fresh_len=k_new.shape[1], **win)


def int8_quantize_v(v_cache, v_new, *, layer_idx: int, kv_start: int,
                    kv_end: int, sink_end: int = 0,
                    static_hi: int | None = None, num_heads: int, tk: int,
                    tf: int) -> Int8V:
    """The V half of the full-int8 pre-pass: the cache tiles of layer
    ``layer_idx`` that the window meets below ``static_hi``, and v_new,
    each quantized to int8 with one scale per tile of tk / tf rows (the
    Pallas kernel's tiles), stored K-major as :class:`Int8V` says.
    Operands as in :func:`decode_fresh`."""
    win = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
               sink_end=sink_end, static_hi=static_hi, num_heads=num_heads,
               tk=tk, tf=tf)
    if not v_new.is_cuda:
        return int8_quantize_v_ref(v_cache, v_new, **win)
    vc = _stacked(v_cache, layer_idx)
    _check_cuda("int8_quantize_v", vc, v_new)
    _check_tiles("int8_quantize_v", 1, tk, tf)
    B, Lf, ND = v_new.shape
    N = num_heads
    D = ND // N
    BN, S, Dc = vc.shape
    if D != HEAD_DIM or Dc != D or BN != B * N:
        raise ValueError(
            f"int8_quantize_v: unsupported shapes cache {tuple(vc.shape)}, "
            f"fresh {tuple(v_new.shape)} with {N} heads (the kernel takes "
            f"head_dim {HEAD_DIM})")
    lim = _cache_lim(S, kv_start, kv_end, sink_end, static_hi)
    ntc, ntf = _cdiv(lim, tk), _cdiv(Lf, tf)
    tpc, tpf = _cdiv(tk, V_PAD) * V_PAD, _cdiv(tf, V_PAD) * V_PAD
    i8, f32 = torch.int8, torch.float32
    vv = Int8V(vc8=vc.new_empty(BN, ntc, D, tpc, dtype=i8),
               vsc=vc.new_empty(BN, ntc, dtype=f32),
               vn8=vc.new_empty(BN, ntf, D, tpf, dtype=i8),
               vsf=vc.new_empty(BN, ntf, dtype=f32))
    fn = build.function("decode_int8", "int8_quantize_v_launch",
                        [_P] * 6 + [_I] * 10 + [_P])
    err = fn(vc.data_ptr(), v_new.data_ptr(), *(t.data_ptr() for t in vv),
             B, N, Lf, S, int(kv_start), int(kv_end), int(sink_end), lim, tk,
             tf, torch.cuda.current_stream(vc.device).cuda_stream)
    build.raise_on("int8_quantize_v", err)
    launch_counts["int8_quantize_v"] += 1
    return vv


def int8_attend(qq: Int8QK, vv: Int8V, q, *, mode: str, m0=None,
                layer_idx: int, kv_start: int, kv_end: int,
                sink_end: int = 0, static_hi: int | None = None,
                num_heads: int, scale: float, tq: int, tk: int, tf: int,
                cache_len: int, fresh_len: int) -> torch.Tensor:
    """The full-int8 attention: the pre-passes' int8 q onto int8 K, p
    quantized to int8 in [0, 127] in ``mode`` (:data:`INT8_MODES`, as
    :func:`int8_attend_ref` spells out) and int8 P.V, with the Pallas
    kernel's tiles; ``m0`` (tile, global) a float32 bound on the scores
    (a 1-element tensor, read on the card).  ``q`` gives the output's
    shape and type; ``cache_len`` / ``fresh_len`` are the cache's S and
    the fresh rows.  Returns [B, Lq, N*D]."""
    args = dict(mode=mode, m0=m0, layer_idx=layer_idx, kv_start=kv_start,
                kv_end=kv_end, sink_end=sink_end, static_hi=static_hi,
                num_heads=num_heads, scale=scale, tq=tq, tk=tk, tf=tf,
                cache_len=cache_len, fresh_len=fresh_len)
    if not q.is_cuda:
        return int8_attend_ref(qq, vv, q, **args)
    if mode not in INT8_MODES:
        raise ValueError(f"unknown int8 decode mode {mode!r}")
    _check_cuda("int8_attend", q)
    _check_tiles("int8_attend", tq, tk, tf)
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    BN = B * N
    lim = _cache_lim(cache_len, kv_start, kv_end, sink_end, static_hi)
    qt, ntc, ntf = _cdiv(Lq, tq), _cdiv(lim, tk), _cdiv(fresh_len, tf)
    tpc, tpf = _cdiv(tk, V_PAD) * V_PAD, _cdiv(tf, V_PAD) * V_PAD
    want = [(BN, qt * tq, D), (BN, qt), (BN, ntc * tk, D), (BN, ntc),
            (BN, ntf * tf, D), (BN, ntf), (BN, ntc, D, tpc), (BN, ntc),
            (BN, ntf, D, tpf), (BN, ntf)]
    ops = list(qq) + list(vv)
    if D != HEAD_DIM or [tuple(t.shape) for t in ops] != want:
        raise ValueError(
            f"int8_attend: unsupported shapes q {tuple(q.shape)}, int8 "
            f"operands {[tuple(t.shape) for t in ops]} with {N} heads and "
            f"tiles {(tq, tk, tf)}")
    for t, dt in zip(ops, (torch.int8, torch.float32) * 5):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise TypeError("int8_attend: the int8 operands must be the "
                            "pre-passes' contiguous int8 / float32 "
                            "tensors on q's device")
    m0t = _m0_tensor(m0, mode, q.device)
    out = torch.empty_like(q)
    fn = build.function("decode_int8", "int8_attend_launch",
                        [_P] * 12 + [_I] * 12 + [ctypes.c_float, _P])
    err = fn(*(t.data_ptr() for t in ops),
             None if m0t is None else m0t.data_ptr(), out.data_ptr(), B, N,
             Lq, fresh_len, int(kv_start), int(kv_end), int(sink_end), lim,
             tq, tk, tf, INT8_MODES[mode], float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("int8_attend", err)
    launch_counts[f"decode_fresh_int8_{mode}"] += 1
    return out


def decode_fresh_int8(q, k_cache, v_cache, k_new, v_new, *, mode: str,
                      m0=None, layer_idx: int, kv_start: int, kv_end: int,
                      sink_end: int = 0, static_hi: int | None = None,
                      num_heads: int, scale: float, tq: int, tk: int,
                      tf: int) -> torch.Tensor:
    """:func:`decode_fresh` with both products in int8 (the Pallas
    kernel's ``quant='int8'``): the pre-passes (:func:`int8qk_quantize`
    for q and K, :func:`int8_quantize_v` for V) quantize over the Pallas
    tiles (``ops/attention.py::decode_tiles``), then :func:`int8_attend`.
    Returns [B, Lq, N*D]."""
    win = dict(layer_idx=layer_idx, kv_start=kv_start, kv_end=kv_end,
               sink_end=sink_end, static_hi=static_hi, num_heads=num_heads,
               tk=tk, tf=tf)
    if not q.is_cuda:
        return decode_fresh_int8_ref(q, k_cache, v_cache, k_new, v_new,
                                     mode=mode, m0=m0, scale=scale, tq=tq,
                                     **win)
    qq = int8qk_quantize(q, k_cache, k_new, tq=tq, **win)
    vv = int8_quantize_v(v_cache, v_new, **win)
    return int8_attend(qq, vv, q, mode=mode, m0=m0, scale=scale, tq=tq,
                       cache_len=k_cache.shape[-2], fresh_len=k_new.shape[1],
                       **win)


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
    fn = build.function("decode_fresh", "cross_attention_launch",
                        [_P] * 4 + [_I] * 4 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, N, Lq, Lk, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("cross_attention", err)
    launch_counts["cross_attention"] += 1
    return out


# =====================================================================
# cache-window attention (decode_attention): no fresh keys
# =====================================================================

def _window_layout(q, k_cache, v_cache):
    """(q as heads-packed [B, Lq, N*D], the caches folded [B*N, S, D], B,
    N) for q [B, Lq, N, D] or folded [BN, Lq, D] (N = 1) and caches
    [B, S, N, D] (folded here, a copy, as the JAX wrapper's ``_fold_kv``
    transposes) or folded [B*N, S, D]."""
    if q.dim() == 4:
        B, Lq, N, D = q.shape
        qp = q.reshape(B, Lq, N * D)
    else:
        B, Lq, D = q.shape
        N, qp = 1, q

    def fold(a):
        if a.dim() == 4:
            Bc, S, Nc, Dc = a.shape
            return a.permute(0, 2, 1, 3).reshape(Bc * Nc, S, Dc)
        return a

    return qp, fold(k_cache).contiguous(), fold(v_cache).contiguous(), B, N


def _window_bounds(kv_start, kv_end, device) -> torch.Tensor:
    """[lo, hi] as int32 on ``device`` (device scalars stay there)."""
    return torch.stack([torch.as_tensor(kv_start, device=device).reshape(()),
                        torch.as_tensor(kv_end, device=device).reshape(())]
                       ).to(torch.int32)


def decode_window_ref(q, k_cache, v_cache, kv_start, kv_end, *,
                      scale: float | None = None,
                      kv_chunk: int = 1560) -> torch.Tensor:
    """Plain version of :func:`decode_window`: the port of the JAX
    package's ``decode_attention_xla`` (``ops/attention.py``) on the
    folded layout, each (batch, head) a singleton-head attention; float32
    operands stay float32.  Differentiable (the backward of
    ``attention.decode_attention`` recomputes it)."""
    from self_forcing_tpu_torch.ops import attention   # imports this module
    qp, kc, vc, B, N = _window_layout(q, k_cache, v_cache)
    Lq, D = qp.shape[1], kc.shape[-1]
    qf = qp.reshape(B, Lq, N, D).transpose(1, 2).reshape(B * N, Lq, 1, D)
    out = attention.decode_attention_xla(qf, kc[:, :, None], vc[:, :, None],
                                         kv_start, kv_end, scale=scale,
                                         kv_chunk=kv_chunk)
    return out.reshape(B, N, Lq, D).transpose(1, 2).reshape(q.shape)


def decode_window(q, k_cache, v_cache, kv_start, kv_end, *,
                  scale: float | None = None) -> torch.Tensor:
    """Attention of every query onto the cache window ``[kv_start,
    kv_end)`` (ints or device scalars; an empty window gives 0), online
    softmax at ``scale`` (default head_dim**-0.5).  q [B, Lq, N, D] with
    caches [B, S, N, D] or folded [B*N, S, D], or folded q [BN, Lq, D];
    returns q's layout and dtype.  bf16 operands run the online
    decode kernel with no fresh keys (p rounded to bf16 for P.V); float32
    operands the 3xTF32 kernel (float32-accurate products).  All three
    share one dtype."""
    if not q.is_cuda:
        return decode_window_ref(q, k_cache, v_cache, kv_start, kv_end,
                                 scale=scale)
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32) or k_cache.dtype != dt \
            or v_cache.dtype != dt:
        raise TypeError(f"decode_window: the kernel takes bfloat16 or "
                        f"float32 operands of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    qp, kc, vc, B, N = _window_layout(q, k_cache, v_cache)
    qp = qp.contiguous()
    Lq, D = qp.shape[1], qp.shape[2] // N
    BN, S, Dc = kc.shape
    if D != HEAD_DIM or Dc != D or BN != B * N or vc.shape != kc.shape:
        raise ValueError(
            f"decode_window: unsupported shapes q {tuple(q.shape)}, cache "
            f"{tuple(k_cache.shape)} (the kernel takes head_dim {HEAD_DIM})")
    for t in (qp, kc, vc):
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError("decode_window: operands must be on one card "
                             "and 16-byte aligned")
    scale = D ** -0.5 if scale is None else scale
    bounds = _window_bounds(kv_start, kv_end, q.device)
    out = torch.empty_like(qp)
    fn = build.function("decode_fresh", "decode_window_launch",
                        [_P] * 5 + [_I] * 4 + [ctypes.c_float, _I, _P])
    err = fn(qp.data_ptr(), kc.data_ptr(), vc.data_ptr(), bounds.data_ptr(),
             out.data_ptr(), B, N, Lq, S, float(scale),
             int(dt == torch.float32),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("decode_window", err)
    launch_counts["decode_window" if dt == torch.bfloat16
                  else "decode_window_f32"] += 1
    return out.reshape(q.shape)


# =====================================================================
# plain backward of the decode and cross attention (no TPU kernel: the
# JAX package replays its XLA reference under jax.vjp)
# =====================================================================

_SCORES = 1 << 25  # fp32 scores in a chunk of the plain versions (134 MB:
                   # 1024 query rows x 32760 keys)


def _row_chunks(Lq: int, keys: int) -> list[slice]:
    """Query-row chunks of at most ``_SCORES`` scores onto ``keys`` keys."""
    rows = max(1, _SCORES // max(keys, 1))
    return [slice(r0, min(r0 + rows, Lq)) for r0 in range(0, Lq, rows)]


def _softmax_vjp_rows(qf, keys, vals, gf, scale):
    """One chunk of query rows of softmax(scale * q k^T) v, recomputed in
    fp32: returns (dq, dk, dv) of the chunk (dk, dv over all keys)."""
    s = (qf @ keys.T) * scale
    p = torch.softmax(s, dim=-1)
    dp = gf @ vals.T
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return scale * (ds @ keys), scale * (ds.T @ qf), p.T @ gf


def decode_fresh_bwd(q, k_cache, v_cache, k_new, v_new, g, *,
                     layer_idx: int, kv_start: int, kv_end: int,
                     sink_end: int = 0, num_heads: int, scale: float):
    """Gradients (dq, dk_new, dv_new) of the decode attention of
    :func:`decode_fresh_free`'s operands at base-e ``scale`` (a free-mode
    caller passes its scale times ln 2): softmax attention of q onto the
    visible cache columns ``[0, sink_end) + [kv_start, kv_end)`` of layer
    ``layer_idx`` and all of k_new / v_new, recomputed in fp32 one head and
    chunk of query rows at a time (the scores of a whole layer at the
    last training block are 7.4 GB).  The port of
    ``_decode_fresh_op_bwd``; the cache gets no gradient."""
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    kc, vc = _stacked(k_cache, layer_idx), _stacked(v_cache, layer_idx)
    lim = _cache_lim(kc.shape[1], kv_start, kv_end, sink_end, None)
    j = torch.arange(lim, device=q.device)
    cols = j[(j < sink_end) | ((j >= kv_start) & (j < kv_end))]
    nc = cols.numel()
    dq, dkn, dvn = (torch.empty_like(t) for t in (q, k_new, v_new))
    for b in range(B):
        for n in range(N):
            hc = slice(n * D, (n + 1) * D)
            keys = torch.cat([kc[b * N + n, cols].float(),
                              k_new[b, :, hc].float()])
            vals = torch.cat([vc[b * N + n, cols].float(),
                              v_new[b, :, hc].float()])
            dk = torch.zeros_like(keys)
            dv = torch.zeros_like(vals)
            for r in _row_chunks(Lq, keys.shape[0]):
                dq_r, dk_r, dv_r = _softmax_vjp_rows(
                    q[b, r, hc].float(), keys, vals, g[b, r, hc].float(),
                    scale)
                dq[b, r, hc] = dq_r.to(q.dtype)
                dk += dk_r
                dv += dv_r
            dkn[b, :, hc] = dk[nc:].to(k_new.dtype)
            dvn[b, :, hc] = dv[nc:].to(v_new.dtype)
    return dq, dkn, dvn


def cross_attention_bwd(q, k, v, g, *, num_heads: int,
                        scale: float | None = None):
    """Gradients (dq, dk, dv) of :func:`cross_attention` (q heads-packed
    [B, Lq, N*D], k/v [B, Lk, N, D]), recomputed in fp32 per head and
    chunk of query rows; the port of ``_cross_op_bwd``."""
    B, Lq, ND = q.shape
    N = num_heads
    D = ND // N
    scale = D ** -0.5 if scale is None else scale
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        for n in range(N):
            hc = slice(n * D, (n + 1) * D)
            kf, vf = k[b, :, n].float(), v[b, :, n].float()
            dk_acc, dv_acc = torch.zeros_like(kf), torch.zeros_like(vf)
            for r in _row_chunks(Lq, kf.shape[0]):
                dq_r, dk_r, dv_r = _softmax_vjp_rows(
                    q[b, r, hc].float(), kf, vf, g[b, r, hc].float(), scale)
                dq[b, r, hc] = dq_r.to(q.dtype)
                dk_acc += dk_r
                dv_acc += dv_r
            dk[b, :, n] = dk_acc.to(k.dtype)
            dv[b, :, n] = dv_acc.to(v.dtype)
    return dq, dk, dv


# =====================================================================
# masked flash attention (training), offset-free base-2 softmax
# =====================================================================

FLASH_ROWS = 128      # query rows of a flash_fwd CTA
FLASH_KEYS = 64       # keys of a flash_fwd K/V tile
FLASH_BWD_KEYS = 128  # keys of a flash_bwd CTA
FLASH_BWD_Q = 64      # query rows of a tile flash_bwd streams
FLASH_MAX_TILES = 4096  # tile-state row a CTA keeps in shared memory
LN2 = math.log(2.0)


def flash_intervals(mask, Lq: int, Lk: int):
    """The mask's four interval arrays (s1, e1, s2, e2) for queries
    [0, Lq) as numpy int32; no mask is [0, Lk) for every row."""
    if mask is None:
        z = np.zeros(Lq, np.int32)
        return z, np.full(Lq, Lk, np.int32), z, z
    return tuple(np.asarray(a, np.int32)[:Lq]
                 for a in (mask.start1, mask.end1, mask.start2, mask.end2))


def flash_tile_states(mask, Lq: int, Lk: int, rows: int, cols: int,
                      whole_rows: bool) -> np.ndarray:
    """Tile states [ceil(Lq / rows), ceil(Lk / cols)] uint8 of query tiles
    of ``rows`` against key tiles of ``cols``: 0 dead (no row sees a key
    of the tile), 2 fully visible (every row sees every key by one of its
    intervals, the tile lies below Lk and, with ``whole_rows``, the query
    tile has no row past Lq), else 1 (masked per element).  The Pallas
    wrapper's ``_tile_states`` classifies each row by either interval;
    this table asks one interval to cover all rows, which marks a few
    more tiles partial and never a partial tile full."""
    s1, e1, s2, e2 = (a.astype(np.int64) for a in
                      flash_intervals(mask, Lq, Lk))
    nq, nk = _cdiv(Lq, rows), _cdiv(Lk, cols)
    big = np.int64(2 ** 40)

    def tiles(a, fill):
        out = np.full(nq * rows, fill, np.int64)
        out[:Lq] = a
        return out.reshape(nq, rows)

    def live(s, e):   # the union of the nonempty intervals of the tile
        empty = e <= s
        return (tiles(np.where(empty, big, s), big).min(1)[:, None],
                tiles(np.where(empty, -big, e), -big).max(1)[:, None])

    def cover(s, e):  # the range every row's interval covers
        return (tiles(s, -big).max(1)[:, None],
                tiles(e, big).min(1)[:, None])

    a = np.arange(nk, dtype=np.int64)[None, :] * cols
    hi = a + cols
    (lo1, hi1), (lo2, hi2) = live(s1, e1), live(s2, e2)
    (c1l, c1h), (c2l, c2h) = cover(s1, e1), cover(s2, e2)
    alive = ((a < hi1) & (hi > lo1)) | ((a < hi2) & (hi > lo2))
    full = (hi <= Lk) & (((c1l <= a) & (c1h >= hi)) | ((c2l <= a)
                                                       & (c2h >= hi)))
    if whole_rows:
        full &= (np.arange(1, nq + 1) * rows <= Lq)[:, None]
    return np.where(alive, np.where(full, 2, 1), 0).astype(np.uint8)


class FlashGeometry(NamedTuple):
    """What the flash kernels read besides q, k and v: the intervals
    [4, lq_pad] int32 (zero rows past Lq), the tile states of the
    128-query tiles against the 64-key tiles (flash_fwd) and of the
    128-key tiles against the 64-query tiles (flash_bwd, a row per key
    tile; a query tile with rows past Lq is never fully visible)."""
    iv: torch.Tensor
    states_q: torch.Tensor
    states_kv: torch.Tensor
    lq_pad: int


# Geometry of mask=None per (Lq, Lk, device), and of each IntervalMask
# for as long as the mask lives (a mask built anew for every forward
# takes its device tables with it when it goes).
_flash_geometry_full: dict = {}
_flash_geometry: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def flash_geometry(mask, Lq: int, Lk: int,
                   device: torch.device) -> FlashGeometry:
    """The kernels' interval and tile-state tensors on ``device``, built
    once per (mask, Lq, Lk, device)."""
    cache = (_flash_geometry_full if mask is None
             else _flash_geometry.setdefault(mask, {}))
    key = (Lq, Lk, str(device))
    hit = cache.get(key)
    if hit is not None:
        return hit
    lq_pad = _cdiv(Lq, FLASH_ROWS) * FLASH_ROWS
    iv = np.zeros((4, lq_pad), np.int32)
    iv[:, :Lq] = np.stack(flash_intervals(mask, Lq, Lk))
    sq = flash_tile_states(mask, Lq, Lk, FLASH_ROWS, FLASH_KEYS, False)
    skv = flash_tile_states(mask, Lq, Lk, FLASH_BWD_Q, FLASH_BWD_KEYS,
                            True).T
    geo = FlashGeometry(
        iv=torch.from_numpy(iv).to(device),
        states_q=torch.from_numpy(np.ascontiguousarray(sq)).to(device),
        states_kv=torch.from_numpy(np.ascontiguousarray(skv)).to(device),
        lq_pad=lq_pad)
    cache[key] = geo
    return geo


def _visible(mask, r: slice, Lk: int, device) -> torch.Tensor:
    """[rows, Lk] bool visibility of query rows ``r``."""
    s1, e1, s2, e2 = (torch.from_numpy(a[r].astype(np.int64)).to(device)[
        :, None] for a in flash_intervals(mask, r.stop, Lk))
    j = torch.arange(Lk, device=device)[None, :]
    return ((j >= s1) & (j < e1)) | ((j >= s2) & (j < e2))


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to the operands' type (a no-op for fp32), as the
    kernels feed p and ds to the tensor cores."""
    return x.to(dtype).float()


FLASH_MODES = {"free": 0, "bounded": 1, "online": 2}


def flash_fwd_ref(q, k, v, mask=None, mode: str = "free",
                  scale: float = 1.0, m0=None):
    """Plain version of :func:`flash_fwd`, per head and chunk of query
    rows: the Pallas ``_flash_kernel``'s function in ``mode``.  'free'
    p = 2^min(q.k, 80) on visible keys (``scale`` unused: the caller
    folded it into q); 'bounded' p = exp(scale * q.k - m0); both round p
    to bf16 for P.V.  'online': the exact softmax at ``scale`` with p in
    float32, as the interpreted Pallas kernel keeps it.  out = P.V /
    max(sum p, 1e-30); lse = ln(sum p), plus m0 (bounded) or the row max
    (online), 0 for a row that sees nothing."""
    if mode not in FLASH_MODES:
        raise ValueError(f"unknown flash softmax mode {mode!r}")
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    m0 = _m0_tensor(m0, mode, q.device)
    out = torch.empty_like(q)
    lse = torch.empty(B, N, Lq, dtype=torch.float32, device=q.device)
    for b in range(B):
        for n in range(N):
            kf, vf = k[b, :, n].float(), v[b, :, n].float()
            for r in _row_chunks(Lq, Lk):
                vis = _visible(mask, r, Lk, q.device)
                if mode == "online":
                    s = torch.where(vis, (q[b, r, n].float() * scale) @ kf.T,
                                    float("-inf"))
                    m = s.amax(dim=-1)
                    m = torch.where(torch.isfinite(m), m, 0.0)
                    p = torch.exp(s - m[:, None])
                else:
                    s = q[b, r, n].float() @ kf.T
                    p = (torch.exp2(torch.clamp_max(s, 80.0))
                         if mode == "free" else torch.exp(s * scale - m0))
                    p = torch.where(vis, p, 0.0)
                    m = 0.0 if mode == "free" else m0
                l = p.sum(dim=-1)
                acc = (p if mode == "online"
                       else _rounded(p, torch.bfloat16)) @ vf
                out[b, r, n] = (acc / torch.clamp_min(l, 1e-30)[:, None]
                                ).to(q.dtype)
                lse[b, n, r] = torch.where(
                    l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), 0.0)
    return out, lse


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * out) in fp32, [B, N, Lq] (the backward's row
    term; XLA code in the JAX package)."""
    return (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1
                                                         ).contiguous()


def _flash_bwd_chunks(q, k, v, do, lse, delta, mask, scale):
    """Per head and chunk of query rows: (b, n, rows, q, do, k, p, ds) in
    fp32, p = exp(scale * q.k - lse) on visible keys, ds = p * (do.v -
    delta)."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    for b in range(B):
        for n in range(N):
            kf, vf = k[b, :, n].float(), v[b, :, n].float()
            for r in _row_chunks(Lq, Lk):
                qf, dof = q[b, r, n].float(), do[b, r, n].float()
                s = (qf @ kf.T) * scale - lse[b, n, r, None]
                p = torch.where(_visible(mask, r, Lk, q.device),
                                torch.exp(s), 0.0)
                ds = p * (dof @ vf.T - delta[b, n, r, None])
                yield b, n, r, qf, dof, kf, p, ds


def flash_bwd_dq_ref(q, k, v, do, lse, delta, mask=None,
                     scale: float = LN2):
    """Plain version of :func:`flash_bwd`'s dq: dq = scale * ds.k with ds
    rounded to the operands' type."""
    dq = torch.empty_like(q)
    for b, n, r, _, _, kf, _, ds in _flash_bwd_chunks(
            q, k, v, do, lse, delta, mask, scale):
        dq[b, r, n] = (scale * (_rounded(ds, q.dtype) @ kf)).to(q.dtype)
    return dq


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, mask=None,
                      scale: float = LN2):
    """Plain version of :func:`flash_bwd`'s dk and dv: dk = scale *
    ds^T.q and dv = p^T.do, with p and ds rounded to the operands'
    type."""
    B, Lk, N, D = k.shape
    dk = torch.zeros(B, Lk, N, D, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for b, n, r, qf, dof, _, p, ds in _flash_bwd_chunks(
            q, k, v, do, lse, delta, mask, scale):
        dk[b, :, n] += scale * (_rounded(ds, q.dtype).T @ qf)
        dv[b, :, n] += _rounded(p, q.dtype).T @ dof
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_flash(name: str, q, k, v, *more) -> tuple[int, int, int, int]:
    _check_cuda(name, q, k, v, *more)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    if D != HEAD_DIM or k.shape != (B, Lk, N, D) or v.shape != k.shape \
            or any(t.shape != q.shape for t in more) \
            or _cdiv(Lk, FLASH_KEYS) > FLASH_MAX_TILES \
            or _cdiv(Lq, FLASH_BWD_Q) > FLASH_MAX_TILES:
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)} (the kernels take [B, L, N, {HEAD_DIM}] and "
            f"at most {FLASH_MAX_TILES} tiles a row)")
    return B, Lq, N, Lk


def _rows_padded(x: torch.Tensor, name: str, B: int, N: int, Lq: int,
                 lq_pad: int, device) -> torch.Tensor:
    """A per-row fp32 array [B, N, Lq] as the kernels' [B*N, lq_pad]."""
    if x.shape != (B, N, Lq) or x.dtype != torch.float32 \
            or x.device != device:
        raise ValueError(f"{name}: expected float32 [{B}, {N}, {Lq}] on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return F.pad(x.reshape(B * N, Lq), (0, lq_pad - Lq)).contiguous()


def flash_fwd(q, k, v, mask=None, mode: str = "free", scale: float = 1.0,
              m0=None):
    """Masked flash attention forward: q, k, v [B, L, N, D] bf16; ``mask``
    an IntervalMask over queries [0, Lq) and keys [0, Lk) or None (full
    visibility).  ``mode`` (:data:`FLASH_MODES`): 'free', the offset-free
    base-2 softmax of q.k (the caller folded head_dim**-0.5 * log2(e)
    into q); 'bounded', exp(scale * q.k - m0) with ``m0`` a float32 bound
    on every score (a 1-element tensor, read on the card); 'online', the
    running-max softmax at ``scale``.  Returns (out [B, Lq, N, D] bf16,
    lse [B, N, Lq] fp32, base e, of the scores at ``scale``; the free
    mode's scores are its base-2 ones at ln 2)."""
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, mask, mode, scale, m0)
    if mode not in FLASH_MODES:
        raise ValueError(f"unknown flash softmax mode {mode!r}")
    B, Lq, N, Lk = _check_flash("flash_fwd", q, k, v)
    m0t = _m0_tensor(m0, mode, q.device)
    geo = flash_geometry(mask, Lq, Lk, q.device)
    out = torch.empty_like(q)
    lse = torch.zeros(B * N, geo.lq_pad, dtype=torch.float32,
                      device=q.device)
    fn = build.function("flash_attention", "flash_fwd_launch",
                        [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if m0t is None else m0t.data_ptr(), out.data_ptr(),
             lse.data_ptr(), geo.iv.data_ptr(), geo.states_q.data_ptr(), B,
             N, Lq, Lk, geo.lq_pad, FLASH_MODES[mode], float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("flash_fwd", err)
    launch_counts["flash_fwd" if mode == "free"
                  else f"flash_fwd_{mode}"] += 1
    return out, lse.view(B, N, geo.lq_pad)[:, :, :Lq]


def flash_bwd(q, k, v, do, lse, delta, mask=None, scale: float = LN2):
    """The backward of the masked flash attention in one kernel: dq, dk
    and dv from the forward's base-e ``lse`` and ``delta`` =
    :func:`flash_delta` ([B, N, Lq] fp32) at ``scale`` (ln 2 for the free
    forward, the forward's scale otherwise).  Returns (dq [B, Lq, N, D],
    dk, dv [B, Lk, N, D]) bf16.  dk and dv are the same bits run after
    run; dq sums the key tiles' partials in fp32 in an order that changes
    from run to run, so its last bits may differ."""
    if not q.is_cuda:
        return (flash_bwd_dq_ref(q, k, v, do, lse, delta, mask, scale),
                *flash_bwd_dkv_ref(q, k, v, do, lse, delta, mask, scale))
    B, Lq, N, Lk = _check_flash("flash_bwd", q, k, v, do)
    geo = flash_geometry(mask, Lq, Lk, q.device)
    lse_p = _rows_padded(lse, "flash_bwd lse", B, N, Lq, geo.lq_pad,
                         q.device)
    dl_p = _rows_padded(delta, "flash_bwd delta", B, N, Lq, geo.lq_pad,
                        q.device)
    acc = torch.zeros(B * N, geo.lq_pad, HEAD_DIM, dtype=torch.float32,
                      device=q.device)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = build.function("flash_bwd", "flash_bwd_launch",
                        [_P] * 12 + [_I] * 5 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse_p.data_ptr(), dl_p.data_ptr(), acc.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), geo.iv.data_ptr(),
             geo.states_kv.data_ptr(), B, N, Lq, Lk, geo.lq_pad,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("flash_bwd", err)
    launch_counts["flash_bwd"] += 1
    return dq, dk, dv
