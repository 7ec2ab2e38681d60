"""Causal 3x3x3 conv entry points of the Wan VAE's conv backends (port of
``self_forcing_tpu/ops/pallas_conv.py``).

Four entry points, each with the JAX wrapper's accept / decline rule as a
plain predicate on shapes and dtype (the TPU's 16 MB VMEM budget survives
only as that rule: it decides which convs of the VAE take a kernel, and
so which streaming caches hold raw inputs under the 'fused' backend):

- :func:`conv3d_fused` (``_conv3d_fused``): the single-call 27-tap conv;
  None where :func:`fused_tile` declines;
- :func:`causal_conv3d_pallas`: the fused route, else the 3-call
  temporal split (:func:`conv3d_split`: ``_conv2d_9tap`` per temporal
  tap, the bias on the last, the three partials summed in the input
  dtype); None where both decline;
- :func:`causal_conv3d_pallas_v2`: the same conv, asserting W % 8,
  C % 128, Cout % 128 and a strip height as the JAX wrapper asserts;
- :func:`norm_silu_conv3d` (``norm_silu_conv3d_pallas``):
  ``silu(rms_norm_channel(x))`` of the raw timeline (per-pixel RMS over
  C with eps 1e-24, times sqrt(C) and gamma, rounded to x's dtype after
  the SiLU), the conv, plus an optional residual; None where
  :func:`nsc_tile` declines.

Layouts are the JAX package's: activations channels-last [B, T, H, W, C]
(the nsc entry point [T, H, W, C], B = 1), the causal cache [B, 2, H, W,
C] of the two frames before x, weights in torch's OIDHW [Cout, C, 3, 3,
3], bias [Cout].  The timeline [cache | x] is read through two pointers,
never concatenated.  The conv is SAME in space (zeros outside the frame,
after the activation for nsc) and accumulates in float32 before its one
rounding to x's dtype.

Dispatch: for tensors on the CPU each entry point runs its plain version
(``*_ref``: F.conv3d / F.conv2d over the upcast timeline); for CUDA
tensors it launches the kernel of ``ops/cuda_conv.py`` or raises.  Both
decline exactly where the JAX wrapper declines; every decline adds one to
``decline_counts[name]``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.ops import cuda_conv

VMEM_BUDGET = 16_000_000   # the TPU kernels' VMEM budget, in bytes
NSC_EPS = 1e-24

decline_counts = {"conv3d_fused": 0, "conv2d_9tap": 0,
                  "norm_silu_conv3d": 0}


def reset_decline_counts() -> None:
    for name in decline_counts:
        decline_counts[name] = 0


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


# =====================================================================
# the JAX wrappers' routing rules (None = the Pallas kernel declines)
# =====================================================================

def fused_tile(H: int, W: int, C: int, Cout: int, bpe: int) -> int | None:
    """Strip height of ``_conv3d_fused`` (pallas_conv.py:162-180), or
    None where it declines."""
    Wp, Cp, Cop = _up(W + 2, 8), _up(C, 128), _up(Cout, 128)
    w_bytes = 27 * Cp * Cop * bpe

    def fits(t):
        scratch = 3 * (t + 2) * Wp * Cp * bpe
        acc = 5 * t * Wp * Cop * 4
        out = 2 * t * W * Cop * bpe
        return w_bytes + scratch + acc + out + 2_000_000 <= VMEM_BUDGET

    return next((t for t in range(8, 0, -1) if H % t == 0 and fits(t)),
                None)


def split_tile(H: int, W: int, C: int, Cout: int, bpe: int) -> int | None:
    """Strip height of ``_conv2d_9tap`` (pallas_conv.py:64-88), one
    temporal tap of the split route, or None where it declines."""
    Wp, Cp, Cop = _up(W + 2, 8), _up(C, 128), _up(Cout, 128)
    w_bytes = 9 * Cp * Cop * bpe

    def fits(t):
        scratch = (t + 2) * Wp * Cp * bpe
        acc = 5 * t * Wp * Cop * 4
        out = 2 * t * W * Cop * bpe
        return w_bytes + scratch + acc + out + 2_000_000 <= VMEM_BUDGET

    return next((t for t in range(8, 0, -1) if H % t == 0 and fits(t)),
                None)


def v2_tile(H: int, W: int, C: int, Cout: int, bpe: int,
            th: int = 8) -> int | None:
    """Strip height of ``causal_conv3d_pallas_v2`` (pallas_conv.py:336-355;
    th >= 4), or None where the JAX wrapper's assertion fails."""
    if W % 8 or C % 128 or Cout % 128:
        return None
    w_bytes = 27 * C * Cout * bpe

    def fits(t):
        scratch = 3 * (t + 2) * W * C * bpe
        acc = 3 * t * W * Cout * 4
        out = 2 * t * W * Cout * bpe
        return w_bytes + scratch + acc + out + 2_300_000 <= VMEM_BUDGET

    return next((t for t in range(min(th, 8), 3, -1)
                 if H % t == 0 and fits(t) and H >= t + 2), None)


def nsc_tile(H: int, W: int, C: int, Cout: int, bpe: int, residual: bool,
             th: int = 8) -> int | None:
    """Strip height of ``norm_silu_conv3d_pallas`` (pallas_conv.py:487-507:
    W % 8, C % 128, Cout % 128, ``fits()`` and th >= 4), or None where it
    declines."""
    if W % 8 or C % 128 or Cout % 128:
        return None
    w_bytes = 27 * C * Cout * bpe

    def fits(t):
        scratch = 3 * (t + 2) * W * C * bpe * 2
        accv = 2 * t * W * Cout * 4
        out = 2 * t * W * Cout * bpe
        res = t * W * Cout * bpe if residual else 0
        return (w_bytes + scratch + accv + out + res + 2_000_000
                <= VMEM_BUDGET)

    return next((t for t in range(min(th, 8), 3, -1)
                 if H % t == 0 and fits(t) and H >= t + 2), None)


# =====================================================================
# plain versions
# =====================================================================

def _timeline_f32(x: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """[cache | x] as float32 NCDHW [B, C, 2 + T, H, W]."""
    xin = torch.cat([cache.to(x.dtype), x], dim=1)
    return xin.float().permute(0, 4, 1, 2, 3)


def _out(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 NCDHW -> channels-last [B, T, H, W, Cout] in ``dtype``."""
    return y.permute(0, 2, 3, 4, 1).to(dtype)


def conv3d_ref(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Plain version of the 27-tap conv (``_conv3d_kernel`` and
    ``_conv3d_v2_kernel``): float32 products and sums (TF32 off), then
    + b, rounded once to x's dtype."""
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv3d(_timeline_f32(x, cache), w.float(), None,
                     padding=(0, 1, 1))
    return _out(y + b.float().view(1, -1, 1, 1, 1), x.dtype)


def conv2d_tap_ref(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None, tau: int) -> torch.Tensor:
    """Plain version of one temporal tap of the split route
    (``_conv2d_kernel``): output frame t convolves timeline frame
    t + tau with ``w[:, :, tau]`` (3x3 SAME), + b where given, rounded
    to x's dtype."""
    B, T, H, W, C = x.shape
    xin = torch.cat([cache.to(x.dtype), x], dim=1)[:, tau:tau + T]
    frames = xin.reshape(B * T, H, W, C).float().permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv2d(frames, w[:, :, tau].float(), None, padding=1)
    if b is not None:
        y = y + b.float().view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype).reshape(B, T, H, W, -1)


def split_ref(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Plain version of the split route: the three taps' partials, each
    rounded to x's dtype, summed in x's dtype (pallas_conv.py:239-248)."""
    acc = None
    for tau in range(3):
        y = conv2d_tap_ref(x, cache, w, b if tau == 2 else None, tau)
        acc = y if acc is None else acc + y
    return acc


def norm_silu_ref(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = NSC_EPS) -> torch.Tensor:
    """The nsc prologue on channels-last frames [..., C]: per-pixel
    ``u = x * rsqrt(sum x^2 + eps) * sqrt(C) * gamma`` in float32, then
    ``u * sigmoid(u)`` rounded to x's dtype (pallas_conv.py:428-432)."""
    C = x.shape[-1]
    xf = x.float()
    inv = torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) + eps)
    u = xf * inv * math.sqrt(C) * gamma.float()
    return (u * torch.sigmoid(u)).to(x.dtype)


def nsc_ref(x: torch.Tensor, cache: torch.Tensor, gamma: torch.Tensor,
            w: torch.Tensor, b: torch.Tensor,
            residual: torch.Tensor | None = None,
            eps: float = NSC_EPS) -> torch.Tensor:
    """Plain version of :func:`norm_silu_conv3d`: x [T, H, W, C] and
    cache [2, H, W, C] raw; the activated timeline through the 27-tap
    conv, + b, + residual [T, H, W, Cout] in float32, rounded once."""
    act = norm_silu_ref(torch.cat([cache.to(x.dtype), x], dim=0), gamma, eps)
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv3d(act.float().permute(3, 0, 1, 2)[None], w.float(), None,
                     padding=(0, 1, 1))[0]
    y = y.permute(1, 2, 3, 0) + b.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


# =====================================================================
# entry points
# =====================================================================

def _check_conv(name: str, x: torch.Tensor, cache: torch.Tensor,
                w: torch.Tensor) -> None:
    if x.dim() != 5 or cache.shape != (x.shape[0], 2, *x.shape[2:]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and cache "
                         f"{tuple(cache.shape)} must be [B, T, H, W, C] "
                         f"and [B, 2, H, W, C]")
    if tuple(w.shape[1:]) != (x.shape[-1], 3, 3, 3):
        raise ValueError(f"{name}: weight {tuple(w.shape)} for "
                         f"{x.shape[-1]} input channels")


def conv3d_fused(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor | None:
    """27-tap causal conv of ``_conv3d_fused``: x [B, T, H, W, C], cache
    [B, 2, H, W, C], w [Cout, C, 3, 3, 3] -> [B, T, H, W, Cout], or None
    where the JAX kernel declines."""
    _check_conv("conv3d_fused", x, cache, w)
    _, _, H, W, C = x.shape
    if fused_tile(H, W, C, w.shape[0], x.element_size()) is None:
        decline_counts["conv3d_fused"] += 1
        return None
    if not x.is_cuda:
        return conv3d_ref(x, cache, w, b)
    return cuda_conv.conv3d(x, cache, w, b, "conv3d_fused")


def causal_conv3d_pallas(x: torch.Tensor, cache: torch.Tensor,
                         w: torch.Tensor, b: torch.Tensor
                         ) -> torch.Tensor | None:
    """``causal_conv3d_pallas``: the fused route where it fits, else the
    3-call temporal split (pallas_conv.py:229-248), else None."""
    fused = conv3d_fused(x, cache, w, b)
    return fused if fused is not None else conv3d_split(x, cache, w, b)


def conv3d_split(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor | None:
    """The split route of ``causal_conv3d_pallas`` alone: one launch a
    temporal tap (``_conv2d_9tap``), the bias on the last, the partials
    summed in x's dtype; None where ``_conv2d_9tap`` declines."""
    _check_conv("conv3d_split", x, cache, w)
    _, _, H, W, C = x.shape
    if split_tile(H, W, C, w.shape[0], x.element_size()) is None:
        decline_counts["conv2d_9tap"] += 1
        return None
    if not x.is_cuda:
        return split_ref(x, cache, w, b)
    acc = None
    for tau in range(3):
        y = cuda_conv.conv2d_tap(x, cache, w, b if tau == 2 else None, tau)
        acc = y if acc is None else acc + y
    return acc


def causal_conv3d_pallas_v2(x: torch.Tensor, cache: torch.Tensor,
                            w: torch.Tensor, b: torch.Tensor,
                            th: int = 8) -> torch.Tensor:
    """``causal_conv3d_pallas_v2``: the 27-tap conv with no host pads.
    Asserts where the JAX wrapper asserts (W % 8, C and Cout % 128, a
    strip height >= 4)."""
    _check_conv("causal_conv3d_pallas_v2", x, cache, w)
    _, _, H, W, C = x.shape
    Cout = w.shape[0]
    if W % 8 or C % 128 or Cout % 128:
        raise AssertionError((W, C, Cout))
    if v2_tile(H, W, C, Cout, x.element_size(), th) is None:
        raise AssertionError(f"no strip height fits VMEM for "
                             f"{(H, W, C, Cout)}")
    if not x.is_cuda:
        return conv3d_ref(x, cache, w, b)
    return cuda_conv.conv3d(x, cache, w, b, "conv3d_v2")


def norm_silu_conv3d(x: torch.Tensor, cache: torch.Tensor,
                     gamma: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     residual: torch.Tensor | None = None,
                     eps: float = NSC_EPS) -> torch.Tensor | None:
    """``norm_silu_conv3d_pallas`` over the raw timeline [cache | x]:
    x [T, H, W, C], cache [2, H, W, C], gamma [C], w [Cout, C, 3, 3, 3],
    residual [T, H, W, Cout] or None -> [T, H, W, Cout], or None where the
    JAX kernel declines."""
    T, H, W, C = x.shape
    Cout = w.shape[0]
    if cache.shape != (2, H, W, C) or tuple(w.shape[1:]) != (C, 3, 3, 3):
        raise ValueError(f"norm_silu_conv3d: x {tuple(x.shape)}, cache "
                         f"{tuple(cache.shape)}, weight {tuple(w.shape)}")
    if nsc_tile(H, W, C, Cout, x.element_size(), residual is not None) is None:
        decline_counts["norm_silu_conv3d"] += 1
        return None
    if not x.is_cuda:
        return nsc_ref(x, cache, gamma, w, b, residual, eps)
    return cuda_conv.norm_silu_conv3d(x, cache, gamma, w, b, residual, eps)
