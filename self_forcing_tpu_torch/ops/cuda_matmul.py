"""Hand-written CUDA W8A8 kernels and their plain PyTorch versions.

Port of the kernels of ``self_forcing_tpu/ops/pallas_matmul.py`` that the
demo configuration runs: ``quantize_rows`` in csrc/w8a8.cu, and every
product on the one int8 wgmma kernel of csrc/w8a8_fc1.cu, in one of its
three epilogues:

- ``quantize_rows`` replaces ``_quantize_rows_kernel``
  (``quantize_rows_pallas``; csrc/w8a8.cu);
- ``w8a8_matmul`` replaces ``_kernel`` (``w8a8_matmul``): the linear
  epilogue;
- ``w8a8_matmul_bf16x`` replaces ``_kernel_bf16x``
  (``w8a8_matmul_bf16x``): the GEMM from raw bf16 x (K <= 1536), which the
  TPU kernel quantizes per token in its prologue; here the
  ``quantize_rows`` kernel runs first, then the linear epilogue;
- ``w8a8_ffn`` replaces ``w8a8_ffn``: ``w8a8_ffn1`` (``s_x=None``, raw x:
  ``_ffn1_kernel_bf16x``, again as ``quantize_rows`` then the int8-x
  kernel; with ``s_x``, int8 x quantized beforehand: ``_ffn1_kernel``,
  the Wan-14B route, counted as ``w8a8_ffn1_xq``), the fc1 epilogue, then
  ``w8a8_ffn2`` (``_ffn2_kernel``), the fc2 epilogue.

``quantize_rows``, ``w8a8_matmul``, ``w8a8_matmul_bf16x`` and ``w8a8_ffn``
return None where the JAX function declines the shape (the same tile
rules, through this module's copy of ``_pick_tile``), so ``ops/quant.py``
takes the JAX package's route at every shape.  For a tensor on the CPU
every entry point runs its plain version (``*_ref``, same signature, same
None rule).
For a CUDA tensor it launches the kernel or raises.  Every launch adds
one to ``launch_counts[name]``; the ``quantize_rows`` pre-pass of a raw-x
entry point is part of that entry point's launch and is not counted as a
``quantize_rows`` launch.

Weights come as the K-contiguous ``[N, K]`` int8 copy (``w_qa_t`` in the
parameter tree, made by ``ops/quant.py``); scales ``[N]`` f32; per-token
activation scales ``[M, 1]`` f32 (the TPU kernels' lane broadcast is not
kept).  The integer products of the plain versions run in float64, which
holds every int32 sum of int8 products exactly.
"""
from __future__ import annotations

import ctypes

import torch

from self_forcing_tpu_torch.ops import build

launch_counts = {"quantize_rows": 0, "w8a8_matmul": 0,
                 "w8a8_matmul_bf16x": 0, "w8a8_ffn1": 0, "w8a8_ffn1_xq": 0,
                 "w8a8_ffn2": 0}

ACT_FLOOR = 1e-8      # per-token activation scale floor
HIDDEN_FLOOR = 1e-6   # gelu hidden: whole rows can be ~0 after gating
SQRT_2_OVER_PI = 0.7978845834732056  # float32 of sqrt(2 / pi)

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _pick_tile(dim: int, mult: int, cap: int) -> int | None:
    """Largest divisor of ``dim`` that is a multiple of ``mult``, <= cap."""
    best = None
    for t in range(mult, min(dim, cap) + 1, mult):
        if dim % t == 0:
            best = t
    return best


# =====================================================================
# the JAX package's tile rules (None = the Pallas kernel declines)
# =====================================================================

def quantize_rows_tiling(M: int, K: int) -> int | None:
    """Row tile of ``quantize_rows_pallas``, or None where it declines."""
    tm = _pick_tile(M, 8, 2048)
    if tm is None or K % 128 or K > 4096:
        return None
    while tm is not None and tm * (3 * K + 512) > 14 * 2 ** 20:
        tm = _pick_tile(M, 8, tm - 1) if tm > 8 else None
    return tm


def matmul_tiling(M: int, K: int, N: int) -> bool:
    """Whether ``w8a8_matmul`` takes the shape."""
    tm = _pick_tile(M, 8, 1024)
    tn = _pick_tile(N, 128, 896)
    if tm is None or tn is None or K % 128:
        return False
    budget = int(10e6) - 4 * tm * tn - 2 * tm * tn
    tk_cap = max(128, budget // (2 * (tm + tn)))
    return _pick_tile(K, 128, min(K, tk_cap, 1536)) is not None


def bf16x_tiling(M: int, K: int, N: int) -> bool:
    """Whether ``w8a8_matmul_bf16x`` takes the shape (K in one tile)."""
    return (_pick_tile(M, 8, 1024) is not None
            and _pick_tile(N, 128, 896) is not None
            and K % 128 == 0 and K <= 1536)


def ffn_group(M: int, K: int, H: int, N: int, raw_x: bool) -> int | None:
    """Hidden group width of ``w8a8_ffn`` (fc1's column tile = fc2's
    K tile), or None where it declines."""
    tm = _pick_tile(M, 8, 1024)
    tg = _pick_tile(H, 128, 896)
    tn2 = _pick_tile(N, 128, 896)
    tk1 = _pick_tile(K, 128, 1536)
    if tm is None or tg is None or tn2 is None or tk1 is None \
            or (raw_x and tk1 != K):
        return None
    return tg


# =====================================================================
# plain versions
# =====================================================================

def _quant_rows(xf: torch.Tensor, floor: float):
    """Per-row absmax int8 of float32 rows: (q int8, s [rows, 1]).  The
    127 is a tensor: PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal, which is not the true division of the kernels."""
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), floor) \
        / xf.new_tensor(127.0)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _int_dot(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 . b_t [N, K]^T as the f32 rounding of the exact
    int32 sum (float64 holds it exactly)."""
    return (a.double() @ b_t.double().T).float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu with the tanh approximation, op for op as jax.nn.gelu."""
    inner = SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _f32(v: torch.Tensor | None, n: int, like: torch.Tensor) -> torch.Tensor:
    if v is None:
        return torch.zeros(n, dtype=torch.float32, device=like.device)
    return v.float().reshape(n).contiguous()


def quantize_rows_ref(x: torch.Tensor):
    """Plain version of :func:`quantize_rows`."""
    M, K = x.shape
    if quantize_rows_tiling(M, K) is None:
        return None
    return _quant_rows(x.float(), ACT_FLOOR)


def w8a8_matmul_ref(x_q, s_x, w_t, w_scale, bias=None,
                    out_dtype=torch.bfloat16):
    """Plain version of :func:`w8a8_matmul`."""
    M, K = x_q.shape
    N = w_t.shape[0]
    if not matmul_tiling(M, K, N):
        return None
    y = _int_dot(x_q, w_t) * s_x.float().reshape(M, 1) \
        * _f32(w_scale, N, x_q) + _f32(bias, N, x_q)
    return y.to(out_dtype)


def w8a8_matmul_bf16x_ref(x, w_t, w_scale, bias=None,
                          out_dtype=torch.bfloat16):
    """Plain version of :func:`w8a8_matmul_bf16x`: x quantized per token
    as ``_quant_rows`` does (floor 1e-8 before the division by 127), then
    the plain GEMM and its epilogue."""
    M, K = x.shape
    N = w_t.shape[0]
    if not bf16x_tiling(M, K, N):
        return None
    x_q, s_x = _quant_rows(x.float(), ACT_FLOOR)
    y = _int_dot(x_q, w_t) * s_x * _f32(w_scale, N, x) + _f32(bias, N, x)
    return y.to(out_dtype)


def w8a8_ffn1_ref(x, s_x, w1_t, w1_scale, b1, tg: int):
    """Plain version of :func:`w8a8_ffn1` (``s_x=None``, raw x) and of
    the JAX package's ``_ffn1_kernel`` (int8 x with its ``s_x``)."""
    M = x.shape[0]
    H = w1_t.shape[0]
    if s_x is None:
        x_q, s = _quant_rows(x.float(), ACT_FLOOR)
    else:
        x_q, s = x, s_x.float().reshape(M, 1)
    y = _int_dot(x_q, w1_t) * s * _f32(w1_scale, H, x) + _f32(b1, H, x)
    g = gelu_tanh(y).reshape(M, H // tg, tg)
    h_q, h_s = _quant_rows(g, HIDDEN_FLOOR)
    return h_q.reshape(M, H), h_s.reshape(M, H // tg)


def w8a8_ffn2_ref(h_q, h_s, w2_t, w2_scale, b2, tg: int,
                  out_dtype=torch.bfloat16):
    """Plain version of :func:`w8a8_ffn2`."""
    M, H = h_q.shape
    N = w2_t.shape[0]
    acc = torch.zeros(M, N, dtype=torch.float32, device=h_q.device)
    for g in range(H // tg):
        cols = slice(g * tg, (g + 1) * tg)
        acc = acc + _int_dot(h_q[:, cols], w2_t[:, cols]) * h_s[:, g:g + 1]
    return (acc * _f32(w2_scale, N, h_q) + _f32(b2, N, h_q)).to(out_dtype)


def w8a8_ffn_ref(x, s_x, w1_t, w1_scale, b1, w2_t, w2_scale, b2,
                 out_dtype=torch.bfloat16):
    """Plain version of :func:`w8a8_ffn`.  With ``s_x`` given, ``x`` is
    already int8 (the JAX package's ``_ffn1_kernel`` route)."""
    M, K = x.shape
    H, N = w1_t.shape[0], w2_t.shape[0]
    tg = ffn_group(M, K, H, N, raw_x=s_x is None)
    if tg is None:
        return None
    h_q, h_s = w8a8_ffn1_ref(x, s_x, w1_t, w1_scale, b1, tg)
    return w8a8_ffn2_ref(h_q, h_s, w2_t, w2_scale, b2, tg, out_dtype)


# =====================================================================
# kernels
# =====================================================================

def _check(name: str, dtypes: list, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t, want in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != want:
            raise TypeError(f"{name}: the kernel takes {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _launch(lib: str, name: str, fn: str, *args, count: bool = True) -> None:
    """Call the C launcher ``fn`` of ``csrc/<lib>.cu`` (tensors as
    pointers, ints, then the current stream), raise on its error, and
    count it under ``name`` (``count=False``: the pre-pass of the launch
    that follows)."""
    types = [_P if isinstance(a, torch.Tensor) else _I for a in args]
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
            for a in args]
    f = build.function(lib, fn, types + [_P])
    build.raise_on(name, f(*vals, torch.cuda.current_stream(
        args[0].device).cuda_stream))
    if count:
        launch_counts[name] += 1


def _quantize_pre_pass(name: str, x: torch.Tensor):
    """The ``quantize_rows`` kernel as the first step of the raw-x entry
    point ``name``: (x_q int8 [M, K], s_x f32 [M, 1]), not counted."""
    M, K = x.shape
    q = torch.empty(M, K, dtype=torch.int8, device=x.device)
    s = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    _launch("w8a8", name, "quantize_rows_launch", x, q, s, M, K, count=False)
    return q, s


def quantize_rows(x: torch.Tensor):
    """Per-token symmetric int8 quantization of bf16 ``x`` [M, K]:
    (x_q int8 [M, K], s_x f32 [M, 1]), or None where the JAX kernel
    declines the shape."""
    if not x.is_cuda:
        return quantize_rows_ref(x)
    M, K = x.shape
    if quantize_rows_tiling(M, K) is None:
        return None
    _check("quantize_rows", [torch.bfloat16], x)
    q = torch.empty(M, K, dtype=torch.int8, device=x.device)
    s = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    _launch("w8a8", "quantize_rows", "quantize_rows_launch", x, q, s, M, K)
    return q, s


def w8a8_matmul(x_q: torch.Tensor, s_x: torch.Tensor, w_t: torch.Tensor,
                w_scale: torch.Tensor, bias: torch.Tensor | None = None,
                out_dtype=torch.bfloat16):
    """(x_q int8 [M, K], s_x f32 [M, 1]) . (w_t int8 [N, K],
    w_scale [N]) + bias -> [M, N] ``out_dtype``: the int32 product, then
    ``acc * s_x * w_scale + b`` in f32.  None where the JAX kernel
    declines the shape."""
    if not x_q.is_cuda:
        return w8a8_matmul_ref(x_q, s_x, w_t, w_scale, bias, out_dtype)
    M, K = x_q.shape
    N = w_t.shape[0]
    if w_t.shape != (N, K):
        raise ValueError(f"w8a8_matmul: weight {tuple(w_t.shape)} for "
                         f"input {tuple(x_q.shape)}")
    if not matmul_tiling(M, K, N):
        return None
    if out_dtype != torch.bfloat16:
        raise TypeError("w8a8_matmul: the kernel writes bfloat16")
    tn = _pick_tile(N, 128, 896)
    s_x = s_x.float().reshape(M, 1).contiguous()
    ws, b = _f32(w_scale, N, x_q), _f32(bias, N, x_q)
    _check("w8a8_matmul", [torch.int8, torch.float32, torch.int8,
                           torch.float32, torch.float32], x_q, s_x, w_t, ws, b)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x_q.device)
    _launch("w8a8_fc1", "w8a8_matmul", "w8a8_linear_xq_launch", x_q, s_x, w_t,
            ws, b, out, M, N, K, tn)
    return out


def w8a8_matmul_bf16x(x: torch.Tensor, w_t: torch.Tensor,
                      w_scale: torch.Tensor, bias: torch.Tensor | None = None,
                      out_dtype=torch.bfloat16):
    """The W8A8 GEMM from raw bf16 ``x`` [M, K]: x quantized per token by
    the ``quantize_rows`` kernel, the int32 product with w_t [N, K] int8,
    then ``acc * s_x * w_scale + b`` in f32 -> bf16 [M, N] (w8a8_fc1.cu's
    linear epilogue).  None where the JAX kernel declines the shape
    (K > 1536)."""
    if not x.is_cuda:
        return w8a8_matmul_bf16x_ref(x, w_t, w_scale, bias, out_dtype)
    M, K = x.shape
    N = w_t.shape[0]
    if w_t.shape != (N, K):
        raise ValueError(f"w8a8_matmul_bf16x: weight {tuple(w_t.shape)} "
                         f"for input {tuple(x.shape)}")
    if not bf16x_tiling(M, K, N):
        return None
    if out_dtype != torch.bfloat16:
        raise TypeError("w8a8_matmul_bf16x: the kernel writes bfloat16")
    tn = _pick_tile(N, 128, 896)
    ws, b = _f32(w_scale, N, x), _f32(bias, N, x)
    _check("w8a8_matmul_bf16x", [torch.bfloat16, torch.int8, torch.float32,
                                 torch.float32], x, w_t, ws, b)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    xq, sx = _quantize_pre_pass("w8a8_matmul_bf16x", x)
    _launch("w8a8_fc1", "w8a8_matmul_bf16x", "w8a8_linear_xq_launch", xq,
            sx, w_t, ws, b, out, M, N, K, tn)
    return out


def w8a8_ffn1(x: torch.Tensor, w1_t: torch.Tensor, w1_scale: torch.Tensor,
              b1: torch.Tensor | None, tg: int,
              s_x: torch.Tensor | None = None):
    """fc1 of the fused FFN, w1_t [H, K] int8: from raw bf16 ``x`` [M, K]
    (``s_x=None``) x is quantized per token by the ``quantize_rows``
    kernel first; from int8 ``x`` with its per-token scales ``s_x``
    [M, 1] (counted as ``w8a8_ffn1_xq``) the product starts at once.  Then
    the int32 product, ``acc * s_x * w1_scale + b1``, gelu-tanh, and int8
    per (token, group of ``tg`` columns): (h_q int8 [M, H], h_s f32
    [M, H / tg]).  One kernel for both (w8a8_fc1.cu)."""
    if not x.is_cuda:
        return w8a8_ffn1_ref(x, s_x, w1_t, w1_scale, b1, tg)
    M, K = x.shape
    H = w1_t.shape[0]
    if w1_t.shape != (H, K) or H % tg:
        raise ValueError(f"w8a8_ffn1: weight {tuple(w1_t.shape)}, group "
                         f"{tg} for input {tuple(x.shape)}")
    ws1, bb1 = _f32(w1_scale, H, x), _f32(b1, H, x)
    h_q = torch.empty(M, H, dtype=torch.int8, device=x.device)
    h_s = torch.empty(M, H // tg, dtype=torch.float32, device=x.device)
    if s_x is None:
        name = "w8a8_ffn1"
        _check(name, [torch.bfloat16, torch.int8, torch.float32,
                      torch.float32], x, w1_t, ws1, bb1)
        xq, sx = _quantize_pre_pass(name, x)
    else:
        name, xq = "w8a8_ffn1_xq", x
        sx = s_x.float().reshape(M, 1).contiguous()
        _check(name, [torch.int8, torch.float32, torch.int8, torch.float32,
                      torch.float32], xq, sx, w1_t, ws1, bb1)
    _launch("w8a8_fc1", name, "w8a8_ffn1_xq_launch", xq, sx, w1_t, ws1, bb1,
            h_q, h_s, M, K, H, tg)
    return h_q, h_s


def w8a8_ffn2(h_q: torch.Tensor, h_s: torch.Tensor, w2_t: torch.Tensor,
              w2_scale: torch.Tensor, b2: torch.Tensor | None, tg: int):
    """fc2 of the fused FFN: h_q [M, H] int8 with its group scales h_s
    [M, H / tg] times w2_t [N, H] int8; each group's int32 product times
    its scale, summed over the groups in order in f32, then ``* w2_scale
    + b2`` -> bf16 [M, N]."""
    if not h_q.is_cuda:
        return w8a8_ffn2_ref(h_q, h_s, w2_t, w2_scale, b2, tg)
    M, H = h_q.shape
    N = w2_t.shape[0]
    if w2_t.shape != (N, H) or H % tg or h_s.shape != (M, H // tg):
        raise ValueError(f"w8a8_ffn2: weight {tuple(w2_t.shape)}, scales "
                         f"{tuple(h_s.shape)}, group {tg} for hidden "
                         f"{tuple(h_q.shape)}")
    ws2, bb2 = _f32(w2_scale, N, h_q), _f32(b2, N, h_q)
    _check("w8a8_ffn2", [torch.int8, torch.float32, torch.int8,
                         torch.float32, torch.float32], h_q, h_s, w2_t, ws2,
           bb2)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=h_q.device)
    _launch("w8a8_fc1", "w8a8_ffn2", "w8a8_ffn2_launch", h_q, h_s, w2_t, ws2,
            bb2, out, M, N, H, tg)
    return out


def w8a8_ffn(x: torch.Tensor, s_x: torch.Tensor | None, w1_t: torch.Tensor,
             w1_scale: torch.Tensor, b1: torch.Tensor | None,
             w2_t: torch.Tensor, w2_scale: torch.Tensor,
             b2: torch.Tensor | None, out_dtype=torch.bfloat16):
    """Fused W8A8 FFN fc2(gelu_tanh(fc1(x))) from raw bf16 ``x`` [M, K]
    (``s_x=None``: fc1 quantizes x per token) or from int8 ``x`` with its
    per-token scales ``s_x`` [M, 1]: fc1 dequantizes, adds the bias,
    applies gelu and quantizes the hidden per (token, group of tg
    columns); fc2 sums each group's int product times its scale in f32.
    w1_t [H, K], w2_t [N, H] int8.  None where the JAX kernels decline."""
    if not x.is_cuda:
        return w8a8_ffn_ref(x, s_x, w1_t, w1_scale, b1, w2_t, w2_scale, b2,
                            out_dtype)
    M, K = x.shape
    H, N = w1_t.shape[0], w2_t.shape[0]
    if w1_t.shape != (H, K) or w2_t.shape != (N, H):
        raise ValueError(f"w8a8_ffn: weights {tuple(w1_t.shape)}, "
                         f"{tuple(w2_t.shape)} for input {tuple(x.shape)}")
    tg = ffn_group(M, K, H, N, raw_x=s_x is None)
    if tg is None:
        return None
    if out_dtype != torch.bfloat16:
        raise TypeError("w8a8_ffn: the kernel writes bfloat16")
    h_q, h_s = w8a8_ffn1(x, w1_t, w1_scale, b1, tg, s_x)
    return w8a8_ffn2(h_q, h_s, w2_t, w2_scale, b2, tg)
