"""Hand-written CUDA attention kernels and their plain PyTorch versions.

Port of the two kernels of ``self_forcing_tpu/ops/pallas_attention.py``
that the streaming sampler runs:

- ``decode_fresh_free`` (csrc/decode_fresh.cu) replaces
  ``_decode_fresh_kernel`` in 'free' mode (``decode_attention_fresh_pallas``
  with ``softmax='free'``);
- ``cross_attention`` (csrc/cross_attention.cu) replaces ``_cross_kernel``
  (``cross_attention_pallas``).

Each wrapper runs its plain version (``*_ref``, same signature) for a
tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.
Every launch adds one to ``launch_counts[name]``.
"""
from __future__ import annotations

import ctypes

import torch

from self_forcing_tpu_torch.ops import build

HEAD_DIM = 128  # the head dim the kernels are compiled for

launch_counts = {"decode_fresh_free": 0, "cross_attention": 0}


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
