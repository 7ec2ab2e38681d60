"""Quantized linears, the demo configuration's speed toggle (port of
``self_forcing_tpu/ops/quant.py``).

Three modes, all symmetric, per output channel for weights and per token
for activations:

- ``w8``: int8 weights (``w_q``), bf16 activations; plain PyTorch.
- ``w8a8``: int8 weights (``w_qa``) and int8 activations quantized at run
  time; the int8 product and its dequantizing epilogue run in the CUDA
  kernels of ``ops/cuda_matmul.py`` (their plain versions on the CPU),
  following the JAX package's Pallas route and its fallbacks shape by
  shape.
- ``fp8``: e4m3 weights (``w_f8``) and activations; plain PyTorch (the
  product is upcast to float32, which computes the same numbers as the
  JAX package's f32-accumulated fp8 dot).

The tree keeps the JAX package's keys and [in, out] layout.  ``w8a8``
stores its int8 weight once, K-contiguous as ``w_qa_t`` [out, in] (the
int8 tensor-core product wants B contiguous along K), and ``w_qa`` is the
[in, out] transposed view of it: the same values in another layout, one
int8 copy (14.06 GB at Wan-14B width).

The scales divide by tensors, not by Python scalars: on CUDA, PyTorch
turns a division by a scalar into a multiplication by its reciprocal,
which is not the true division of the JAX package (and of the kernels).
"""
from __future__ import annotations

import torch

from self_forcing_tpu_torch.ops import cuda_matmul as cm
from self_forcing_tpu_torch.utils import tree

Params = dict

FP8_MAX = 448.0  # float8_e4m3fn largest finite


def _absmax_scale(xf: torch.Tensor, axis: int, top: float,
                  keepdim: bool = False) -> torch.Tensor:
    """max(absmax(xf) / top, 1e-8) along ``axis``, dividing by a tensor
    (a true division on CUDA too)."""
    return torch.clamp_min(xf.abs().amax(dim=axis, keepdim=keepdim)
                           / xf.new_tensor(top), 1e-8)


def _quantize_weight(w: torch.Tensor, axis: int):
    """Per-output-channel symmetric int8: returns (w_q int8, scale f32)."""
    wf = w.float()
    scale = _absmax_scale(wf, axis, 127.0)
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127)
    return w_q.to(torch.int8), scale


def _quantize_weight_fp8(w: torch.Tensor, axis: int):
    """Per-output-channel symmetric e4m3: returns (w_f8, scale f32)."""
    wf = w.float()
    scale = _absmax_scale(wf, axis, FP8_MAX)
    return (wf / scale.unsqueeze(axis)).to(torch.float8_e4m3fn), scale


def kernel_layout(w_q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_qa, w_qa_t) of an int8 [..., in, out] weight: the K-contiguous
    [..., out, in] copy that the W8A8 kernels read, and ``w_qa`` as its
    transposed view (one int8 copy)."""
    w_t = w_q.transpose(-1, -2).contiguous()
    return w_t.transpose(-1, -2), w_t


def quantize_linear_params(p: Params, mode: str = "w8a8") -> Params:
    """{'w': [in, out] float} -> {'w_q'|'w_qa' (+ 'w_qa_t'): int8 |
    'w_f8': e4m3, 'w_scale': f32, ...}.  Stacked-block weights
    [L, in, out] are quantized along axis 1."""
    if "lora_A" in p:
        # quantized_linear applies no LoRA delta: quantizing an unmerged
        # adapter would silently revert to the base model
        raise ValueError("cannot quantize a linear with unmerged LoRA "
                         "params; merge the adapter first")
    w = p["w"]
    axis = w.dim() - 2
    out = {k: v for k, v in p.items() if k != "w"}
    if mode == "fp8":
        out["w_f8"], out["w_scale"] = _quantize_weight_fp8(w, axis)
        return out
    w_q, scale = _quantize_weight(w, axis)
    if mode == "w8a8":
        out["w_qa"], out["w_qa_t"] = kernel_layout(w_q)
        del w_q
    else:
        out["w_q"] = w_q
    out["w_scale"] = scale
    return out


def quantize_activations(x: torch.Tensor):
    """Dynamic per-token (last-axis) symmetric int8: (x_q, scale[..., 1])."""
    xf = x.float()
    s = _absmax_scale(xf, -1, 127.0, keepdim=True)
    x_q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return x_q, s


def quantize_activations_fp8(x: torch.Tensor):
    """Dynamic per-token symmetric e4m3: (x_f8, scale[..., 1])."""
    xf = x.float()
    s = _absmax_scale(xf, -1, FP8_MAX, keepdim=True)
    return (xf / s).to(torch.float8_e4m3fn), s


def _kernel_ops(kernels: bool):
    """The W8A8 entry points, or their plain versions (``kernels=False``
    holds a whole forward against the kernels on the card)."""
    if kernels:
        return (cm.quantize_rows, cm.w8a8_matmul, cm.w8a8_ffn,
                cm.w8a8_matmul_bf16x)
    return (cm.quantize_rows_ref, cm.w8a8_matmul_ref, cm.w8a8_ffn_ref,
            cm.w8a8_matmul_bf16x_ref)


def _bias_f32(p: Params, y: torch.Tensor) -> torch.Tensor:
    return y + p["b"].float() if "b" in p else y


def quantized_linear(p: Params, x: torch.Tensor,
                     kernels: bool = True) -> torch.Tensor:
    """Dispatch on the quantized-weight key.

    w8:   x @ w_q in f32, times the weight scale.
    w8a8: the JAX package's kernel chain, step for step: per-token int8 x
          (``quantize_rows``) times w_qa in int32, then ``acc * s_x *
          w_scale + b`` (``w8a8_matmul``).  Where ``quantize_rows``
          declines the shape (K > 4096 at Wan-14B width): the GEMM from
          raw x with the quantization in its prologue
          (``w8a8_matmul_bf16x``, K <= 1536), else per-token quantization
          (``quantize_activations``) into ``w8a8_matmul``, whose K steps
          sum the int32 products; where the GEMM declines too, a plain int
          product scaled by ``s_x * w_scale``.
    fp8:  e4m3 x and w_f8, product in f32, times ``s_x * w_scale``."""
    if "w_f8" in p:
        x_f8, s_x = quantize_activations_fp8(x)
        y = x_f8.float() @ p["w_f8"].float()
        y = _bias_f32(p, y * (s_x * p["w_scale"]))
        return y.to(x.dtype)
    if "w_qa" in p:
        quantize_rows, w8a8_matmul, _, matmul_bf16x = _kernel_ops(kernels)
        lead, K = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, K)
        w_t = p["w_qa_t"]
        q2 = quantize_rows(x2)
        if q2 is None:
            y = matmul_bf16x(x2, w_t, p["w_scale"], p.get("b"),
                             out_dtype=x.dtype)
            if y is not None:
                return y.reshape(*lead, y.shape[-1])
            q2 = quantize_activations(x2)
        x_q, s_x = q2
        y = w8a8_matmul(x_q, s_x, w_t, p["w_scale"], p.get("b"),
                        out_dtype=x.dtype)
        if y is not None:
            return y.reshape(*lead, y.shape[-1])
        y = cm._int_dot(x_q, w_t) * (s_x * p["w_scale"].float())
        y = y.reshape(*lead, y.shape[-1])
    else:
        y = (x.float() @ p["w_q"].float()) * p["w_scale"]
    return _bias_f32(p, y).to(x.dtype)


def quantized_ffn(p1: Params, p2: Params, x: torch.Tensor,
                  kernels: bool = True) -> torch.Tensor:
    """fc2(gelu_tanh(fc1(x))) with both linears W8A8 and the chain between
    the products (dequant, bias, gelu, re-quantization per token and
    column group) fused into ``w8a8_ffn``.  Where fc1 cannot quantize x
    in its prologue (K over one 1536-wide tile, as at Wan-14B width):
    ``w8a8_ffn`` from x quantized by ``quantize_activations``; where the
    kernels decline the shape, two quantized linears, as the JAX package
    falls back."""
    if "w_qa" in p1 and "w_qa" in p2:
        w8a8_ffn = _kernel_ops(kernels)[2]
        lead, K = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, K)
        args = (p1["w_qa_t"], p1["w_scale"], p1.get("b"), p2["w_qa_t"],
                p2["w_scale"], p2.get("b"))
        y = w8a8_ffn(x2, None, *args, out_dtype=x.dtype)
        if y is None:
            x_q, s_x = quantize_activations(x2)
            y = w8a8_ffn(x_q, s_x, *args, out_dtype=x.dtype)
        if y is not None:
            return y.reshape(*lead, y.shape[-1])
    h = cm.gelu_tanh(quantized_linear(p1, x, kernels))
    return quantized_linear(p2, h, kernels)


def _fuse_qkv(sa: Params) -> Params:
    """Concatenate the self-attention q/k/v projections into one
    [in, 3*out] linear under the key ``qkv`` (models/wan/dit.py splits the
    output).  Per-output-channel weight scales and the per-token
    activation scale are both kept exactly, so the fused int8 product is
    bit-identical to the three separate ones."""
    q, k, v = sa["q"], sa["k"], sa["v"]
    if any("lora_A" in p for p in (q, k, v)):
        raise ValueError("cannot fuse q/k/v with unmerged LoRA params; "
                         "merge the adapter first")
    fused = {"w": torch.cat([q["w"], k["w"], v["w"]], dim=-1)}
    if "b" in q:
        fused["b"] = torch.cat([q["b"], k["b"], v["b"]], dim=-1)
    out = {kk: vv for kk, vv in sa.items() if kk not in ("q", "k", "v")}
    out["qkv"] = fused
    return out


def quantize_block(block: Params, num_layers: int, min_dim: int = 512,
                   mode: str = "w8a8", fuse_qkv: bool = True) -> Params:
    """One layer's block tree (a layer of a stack of ``num_layers``)
    quantized as :func:`quantize_dit_params` quantizes that layer of the
    stack.  Quantization is per (layer, output channel), so stacking the
    quantized layers (``utils.tree.stack``) gives the whole stack's
    values, keys and layout.  A linear is chosen on its stacked weight's
    two last dims, as the whole-stack walk chooses it."""
    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor):
                shape = (num_layers, *w.shape)
                if shape[-2] >= min_dim and shape[-1] >= min_dim:
                    if w.dim() < 2:
                        raise ValueError(
                            f"min_dim {min_dim} selects a stacked {shape} "
                            f"leaf that is not a linear")
                    return quantize_linear_params(node, mode)
            return {k: walk(v) for k, v in node.items()}
        return node

    sa = block.get("self_attn", {})
    if fuse_qkv and all(k in sa for k in ("q", "k", "v")):
        block = dict(block)
        block["self_attn"] = _fuse_qkv(sa)
    return walk(block)


def quantize_dit_params(params: Params, min_dim: int = 512,
                        mode: str = "w8a8",
                        fuse_qkv: bool = True) -> Params:
    """Quantize every big linear in the DiT block stack (q/k/v/o, ffn):
    a linear whose two last weight dims are both >= ``min_dim``.
    Embeddings, norms, modulation and the output head stay as they are.
    ``fuse_qkv`` first merges the three self-attention projections into
    one (exact; see _fuse_qkv).  The stack is quantized one layer at a
    time (:func:`quantize_block`), so the float32 temporaries are one
    layer's, not the stack's."""
    blocks = params["blocks"]
    L = tree.leaves(blocks)[0].shape[0]
    out = dict(params)
    out["blocks"] = tree.stack(
        (quantize_block(tree.index(blocks, i), L, min_dim, mode, fuse_qkv)
         for i in range(L)), L)
    return out
