"""Wan2.1 block-causal DiT (port of ``self_forcing_tpu/models/wan/dit.py``):
the KV-cached streaming forward and the training forward.

Parameters are a plain dict with the JAX package's keys; the transformer
blocks are stacked on axis 0 and linear weights are [in, out] (``x @ w +
b``).  Videos are [B, F, C, H, W] at the API, tokens [B, L, D] inside.

Linears dispatch on their keys as in the JAX package: ``w_q``/``w_qa``/
``w_f8`` go to ``ops/quant.py`` (the demo configuration's W8A8 kernels),
a fused ``qkv`` is split after one product, and an FFN whose two linears
are ``w_qa`` runs as one fused W8A8 FFN.

``forward_inference`` has both cache branches: the global cache, where
the block's self-attention reads the window ``[attn_lo, write_at)`` plus
its own fresh K/V, and the windowed cache (``local_attn_size != -1``),
which reads the sink frames ``[0, sink_hi)`` and the recent window
``[attn_lo, write_at)`` of an append buffer that is compacted when it
fills.  The cache is written after the layer (or not at all with
``write_cache=False``).  Differences from the JAX mechanisms: the layer
scan is a Python loop, the cache indices are Python ints, and the KV
cache tensors are updated in place (the returned ``KVCache`` shares them,
so only the returned cache may be used afterwards, as with the JAX
package's donated buffers).

The attention's softmax follows ``cfg.attn_softmax`` and
``cfg.attn_quant`` where the kernels run (``ops/attention.py``'s
``_kernel_route``, the counterpart of the JAX package's Pallas route):
'free' folds head_dim**-0.5 * log2(e) into the q-norm gain; 'bounded'
passes the Cauchy-Schwarz score bound m0 = head_dim**-0.5 * max|q_row| *
max|k_row| (``_max_row_norm``; the decode bound takes the cached keys'
from ``KVCache.kmax``, kept per layer on the device and raised at each
cache write of the global cache); any other setting runs the online
softmax, as does 'bounded' on the windowed cache, which keeps no kmax.
``attn_quant='int8'`` turns 'free' into 'bounded' (the full-int8 decode
needs the bound).  Off the route the references run and the bounds are
not computed, as in the JAX package off the TPU.

``forward_train`` is the no-cache forward of the score models and the
teacher-forcing generator: full-sequence self-attention under an
``IntervalMask`` (or none), through the flash attention of
``ops/attention.py``.  ``forward_classify`` is the GAN discriminator: the
unmasked forward with its GAN head (``init_cls_branch_params``) reading
three tapped layers into logits.
Under autograd the stacked block parameters are split once per forward
(:func:`split_layers`), and ``remat=True`` recomputes each layer in the
backward (``torch.utils.checkpoint``, non-reentrant), as the JAX
package's per-layer ``jax.checkpoint`` does.

Both forwards take the UniAnimate conditioning: ``y`` is concatenated to
the latent's channels before the patch embedding (a y-consuming model has
``in_dim`` = 16 + its y channels), and ``add_condition`` (pose tokens
[B, L, 5120]) is projected by ``pose_proj`` and added to the tokens (on
the teacher-forcing path to the noisy half only).  The image-to-video
model (``model_type='i2v'``) also attends to 257 CLIP image tokens:
``img_emb`` embeds them (:func:`embed_image`), each layer's cross
attention projects them with its own ``k_img`` / ``v_img``, and the
layer adds a second cross attention onto those keys to the text one
(two softmaxes, not one over both key sets).

Activations take the dtype ``jnp`` promotion gives them: float32 latents
or text context over bf16 weights run a float32 residual stream with
float32 linears, as the JAX trainer does.  The attention kernels take
bf16 operands; ``ops/attention.py`` rounds them at the kernels' inputs.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import (RopeTables,
                                                    sinusoidal_embedding_1d)
from self_forcing_tpu_torch.ops import attention as attn_ops
from self_forcing_tpu_torch.ops import quant
from self_forcing_tpu_torch.ops.attention import (cross_attention,
                                                  decode_attention_fresh,
                                                  flash_attention)
from self_forcing_tpu_torch.ops.masks import IntervalMask
from self_forcing_tpu_torch.parallel import comm
from self_forcing_tpu_torch.utils import tree

Params = dict

LOG2E = 1.4426950408889634  # the offset-free softmax works in base 2


# =====================================================================
# primitives
# =====================================================================

def linear(p: Params, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """x @ w + b (+ the LoRA term ``(x @ lora_A) @ lora_B * lora_scale``),
    or the quantized linear for a quantized weight key (``kernels=False``:
    the W8A8 kernels' plain versions on CUDA).  Each product runs in the
    promoted dtype of its operands, as ``jnp`` promotes: float32
    activations over bf16 weights stay float32, and float32 adapters make
    a bf16 linear's output float32."""
    if "w_q" in p or "w_qa" in p or "w_f8" in p:
        return quant.quantized_linear(p, x, kernels)
    out = _matmul(x, p["w"])
    if "b" in p:
        out = out + p["b"]
    if "lora_A" in p:
        delta = _matmul(_matmul(x, p["lora_A"]), p["lora_B"])
        out = out + delta * p["lora_scale"]
    return out


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _param_dtype(params: Params) -> torch.dtype:
    """The parameters' dtype (of a leaf never quantized)."""
    return params["head"]["modulation"].dtype


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """WanRMSNorm: fp32 statistics, cast back, scale."""
    xf = x.float()
    n = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return n.to(x.dtype) * weight.to(x.dtype)


def _qk_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                 cfg: WanConfig) -> torch.Tensor:
    """The q / k RMSNorm, over the full packed width of the heads.  Under
    tensor parallelism x holds only the rank's head columns (every rank
    the same width), so the float32 mean of squares over the full width
    is the all-reduced sum of the ranks' means over their columns,
    divided by the ranks: at one rank, ``rms_norm``'s own arithmetic.
    Under autograd the sum's gradient is all-reduced too (every rank's
    heads use it)."""
    if cfg.tp_group is None:
        return rms_norm(x, weight, cfg.eps)
    xf = x.float()
    ms = comm.all_reduce_both(xf.pow(2).mean(dim=-1, keepdim=True),
                              cfg.tp_group)
    tp = torch.distributed.get_world_size(cfg.tp_group)
    if tp > 1:
        ms = ms / tp
    n = xf * torch.rsqrt(ms + cfg.eps)
    return n.to(x.dtype) * weight.to(x.dtype)


def _out_linear(p: Params, x: torch.Tensor, cfg: WanConfig,
                kernels: bool = True) -> torch.Tensor:
    """A row-sharded output projection (attention o, ffn fc2).  Under
    tensor parallelism each rank holds a row shard of w: its product is a
    partial sum, all-reduced over ``cfg.tp_group``; the replicated bias is
    added once after the reduction, then the all-reduced LoRA term.  The
    reduced output is replicated, so its gradient reaches each rank's
    partial product as it is (``comm.reduce_from``)."""
    if cfg.tp_group is None:
        return linear(p, x, kernels)
    if "w_q" in p or "w_qa" in p or "w_f8" in p:
        raise ValueError("tensor parallelism takes no quantized linear")
    out = comm.reduce_from(_matmul(x, p["w"]), cfg.tp_group)
    if "b" in p:
        out = out + p["b"]
    if "lora_A" in p:
        delta = comm.reduce_from(_matmul(_matmul(x, p["lora_A"]),
                                         p["lora_B"]), cfg.tp_group)
        out = out + delta * p["lora_scale"]
    return out


def _tp_in(x: torch.Tensor, cfg: WanConfig) -> torch.Tensor:
    """A replicated activation entering the rank's column-sharded
    products under tensor parallelism: its gradient is the sum of the
    ranks' (``comm.copy_to``)."""
    return x if cfg.tp_group is None else comm.copy_to(x, cfg.tp_group)


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """WanLayerNorm: fp32 statistics, cast back, optional affine."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    n = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        n = n * weight.to(x.dtype) + bias.to(x.dtype)
    return n


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# CLIP ViT-H/14's token width: the image embedding's input at any DiT width
CLIP_DIM = 1280


# =====================================================================
# parameter init (random weights at any width)
# =====================================================================

def _linear_init(g: torch.Generator, d_in: int, d_out: int, dtype, device,
                 zero: bool = False, std: float | None = None) -> Params:
    if zero:
        w = torch.zeros(d_in, d_out, device=device)
    elif std is not None:
        w = torch.randn(d_in, d_out, generator=g, device=device) * std
    else:  # xavier uniform
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = (torch.rand(d_in, d_out, generator=g, device=device) * 2 - 1) * lim
    return {"w": w.to(dtype), "b": torch.zeros(d_out, dtype=dtype,
                                               device=device)}


def _block_init(g, cfg: WanConfig, dtype, device) -> Params:
    d = cfg.dim

    def ones():
        return {"w": torch.ones(d, dtype=dtype, device=device)}

    def attn(cross: bool):
        p = {n: _linear_init(g, d, d, dtype, device) for n in "qkvo"}
        if cfg.qk_norm:
            p["norm_q"], p["norm_k"] = ones(), ones()
        if cross and cfg.model_type == "i2v":
            p["k_img"] = _linear_init(g, d, d, dtype, device)
            p["v_img"] = _linear_init(g, d, d, dtype, device)
            if cfg.qk_norm:
                p["norm_k_img"] = ones()
        return p

    p = {
        "self_attn": attn(False),
        "cross_attn": attn(True),
        "ffn": {"fc1": _linear_init(g, d, cfg.ffn_dim, dtype, device),
                "fc2": _linear_init(g, cfg.ffn_dim, d, dtype, device)},
        "modulation": (torch.randn(1, 6, d, generator=g, device=device)
                       / d ** 0.5).to(dtype),
    }
    if cfg.cross_attn_norm:
        p["norm3"] = {"w": torch.ones(d, dtype=dtype, device=device),
                      "b": torch.zeros(d, dtype=dtype, device=device)}
    return p


def init_params(cfg: WanConfig, seed: int = 0, dtype=torch.bfloat16,
                device: str | torch.device = "cuda",
                causal: bool = True, block_fn=None) -> Params:
    """Random DiT parameters (blocks stacked on axis 0), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  As in the
    JAX package the output layer starts at zero, an i2v model carries the
    image embedding ``img_emb`` (CLIP's 1280-wide tokens -> dim) and each
    layer's ``k_img`` / ``v_img`` / ``norm_k_img``, and a causal model
    (the generator) carries the pose-conditioning projection 5120 -> dim
    (``pose_proj``, absent when dim is 5120), which the optimizer's weight
    decay moves even without a gradient.

    ``block_fn``: applied to each drawn layer's block tree before the next
    layer is drawn (e.g. ``quant.quantize_block``, so that a Wan-14B
    W8A8 tree never holds its bf16 stack: the result equals
    ``quantize_dit_params(init_params(...))``, from the same random
    stream).  Each layer is copied into the preallocated stack as it is
    made.  On the ``meta`` device the tree has its shapes and dtypes and
    no values (the memory estimate's input)."""
    if cfg.model_type not in ("t2v", "i2v"):
        raise ValueError(f"model_type must be 't2v' or 'i2v', got "
                         f"{cfg.model_type!r}")
    g = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d = cfg.dim
    patch_in = cfg.in_dim * int(np.prod(cfg.patch_size))
    params: Params = {
        "patch_embedding": _linear_init(g, patch_in, d, dtype, device),
        "text_embedding": {
            "fc1": _linear_init(g, cfg.text_dim, d, dtype, device, std=0.02),
            "fc2": _linear_init(g, d, d, dtype, device, std=0.02)},
        "time_embedding": {
            "fc1": _linear_init(g, cfg.freq_dim, d, dtype, device, std=0.02),
            "fc2": _linear_init(g, d, d, dtype, device, std=0.02)},
        "time_projection": {"fc": _linear_init(g, d, d * 6, dtype, device)},
        "head": {
            "head": _linear_init(g, d, cfg.out_dim * int(np.prod(
                cfg.patch_size)), dtype, device, zero=True),
            "modulation": (torch.randn(1, 2, d, generator=g, device=device)
                           / d ** 0.5).to(dtype)},
    }
    fn = block_fn if block_fn is not None else (lambda b: b)
    params["blocks"] = tree.stack(
        (fn(_block_init(g, cfg, dtype, device))
         for _ in range(cfg.num_layers)), cfg.num_layers)
    if cfg.model_type == "i2v":
        def norm(n):
            return {"w": torch.ones(n, dtype=dtype, device=device),
                    "b": torch.zeros(n, dtype=dtype, device=device)}
        params["img_emb"] = {
            "norm1": norm(CLIP_DIM),
            "fc1": _linear_init(g, CLIP_DIM, CLIP_DIM, dtype, device),
            "fc2": _linear_init(g, CLIP_DIM, d, dtype, device),
            "norm2": norm(d)}
    if causal and d != 5120:
        params["pose_proj"] = _linear_init(g, 5120, d, dtype, device)
    return params


def _layer_params(bp: Params) -> Params:
    """A layer's parameters as a plain dict: a ZeRO-3 layer view
    (``parallel/fsdp.py``) gathers them here, in one collective."""
    return bp.materialize() if hasattr(bp, "materialize") else bp


def split_layers(blocks: Params) -> list[Params]:
    """Every layer's parameters out of the stacked block tree, from one
    ``unbind`` of each leaf: under autograd the stacked gradient is then
    assembled once per forward, where an index per layer would build a
    zero tensor the size of the whole stack for every layer.  A ZeRO-3
    tree (``parallel/fsdp.py``) returns its layers' views, which a block
    gathers as it starts (:func:`_layer_params`)."""
    if hasattr(blocks, "layers"):
        return blocks.layers()
    per = tree.map_tree(lambda t: t.unbind(0), blocks)
    return [_pick(per, i) for i in range(len(tree.leaves(blocks)[0]))]


def _pick(node, i: int):
    if isinstance(node, dict):
        return {k: _pick(v, i) for k, v in node.items()}
    return node[i]


# =====================================================================
# pieces of the forward pass
# =====================================================================

def patchify(params: Params, cfg: WanConfig, x: torch.Tensor
             ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """[B, F, C, H, W] -> tokens [B, F*h*w, D]; feature layout (C, ph, pw)."""
    B, Fr, C, H, W = x.shape
    pf, ph, pw = cfg.patch_size
    assert pf == 1, "Wan uses temporal patch 1"
    h, w = H // ph, W // pw
    xt = x.reshape(B, Fr, C, h, ph, w, pw).permute(0, 1, 3, 5, 2, 4, 6)
    xt = xt.reshape(B, Fr * h * w, C * ph * pw)
    return linear(params["patch_embedding"], xt), (Fr, h, w)


def unpatchify(cfg: WanConfig, tokens: torch.Tensor,
               grid: tuple[int, int, int]) -> torch.Tensor:
    """tokens [B, L, pf*ph*pw*C] -> [B, F, C, H, W]."""
    Fr, h, w = grid
    pf, ph, pw = cfg.patch_size
    C = cfg.out_dim
    B = tokens.shape[0]
    u = tokens.reshape(B, Fr, h, w, pf, ph, pw, C)
    u = u.permute(0, 1, 4, 7, 2, 5, 3, 6)
    return u.reshape(B, Fr * pf, C, h * ph, w * pw)


def time_embed(params: Params, cfg: WanConfig, t: torch.Tensor, dtype
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """t [B, F] -> (e [B, F, D], e0 [B, F, 6, D])."""
    B, Fr = t.shape
    emb = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1)).to(dtype)
    te = params["time_embedding"]
    e = linear(te["fc2"], F.silu(linear(te["fc1"], emb)))
    e0 = linear(params["time_projection"]["fc"], F.silu(e))
    return e.reshape(B, Fr, cfg.dim), e0.reshape(B, Fr, 6, cfg.dim)


def embed_text(params: Params, cfg: WanConfig,
               context: torch.Tensor) -> torch.Tensor:
    """Text MLP over the context zero-padded to text_len tokens."""
    B, L, _ = context.shape
    if L < cfg.text_len:
        context = F.pad(context, (0, 0, 0, cfg.text_len - L))
    h = gelu_tanh(linear(params["text_embedding"]["fc1"], context))
    return linear(params["text_embedding"]["fc2"], h)


def embed_image(params: Params, clip_fea: torch.Tensor) -> torch.Tensor:
    """The i2v model's projection of the CLIP image tokens [B, 257, 1280]
    -> [B, 257, dim]: LayerNorm (eps 1e-5, affine), exact-GELU MLP,
    LayerNorm."""
    p = params["img_emb"]
    x = layer_norm(clip_fea, 1e-5, p["norm1"]["w"], p["norm1"]["b"])
    x = linear(p["fc2"], F.gelu(linear(p["fc1"], x), approximate="none"))
    return layer_norm(x, 1e-5, p["norm2"]["w"], p["norm2"]["b"])


def _heads(cfg: WanConfig, x: torch.Tensor) -> torch.Tensor:
    B, L, _ = x.shape
    return x.reshape(B, L, cfg.num_heads, cfg.head_dim)


def _fold_heads(cfg: WanConfig, t: torch.Tensor) -> torch.Tensor:
    """[B, L, N*D] -> the folded [B*N, L, D] layout."""
    B, L, _ = t.shape
    return t.reshape(B, L, cfg.num_heads, cfg.head_dim).permute(
        0, 2, 1, 3).reshape(B * cfg.num_heads, L, cfg.head_dim)


def _unfold_heads(cfg: WanConfig, t: torch.Tensor) -> torch.Tensor:
    """Folded [B*N, L, D] back to [B, L, N*D]."""
    BN, L, D = t.shape
    B = BN // cfg.num_heads
    return t.reshape(B, cfg.num_heads, L, D).permute(0, 2, 1, 3).reshape(
        B, L, cfg.num_heads * D)


def _rope_half(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on [..., L, D] rows whose L axis is axis -2 of a
    folded [BN, L, D] tensor or axis 1 of [B, L, N, D]; cos/sin [L, D/2].
    q/k columns are stored in the half layout (pair element 0 at i,
    element 1 at i + D/2)."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    if x.dim() == 4:      # [B, L, N, D]
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                 # [BN, L, D]
        c, s = cos[None], sin[None]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def _free_softmax(cfg: WanConfig, x: torch.Tensor) -> bool:
    """The offset-free softmax (and its q-gain fold) runs where the
    kernels run (``attn_ops._kernel_route``: CUDA tensors)."""
    return cfg.attn_softmax == "free" and attn_ops._kernel_route(x)


def _max_row_norm(t: torch.Tensor, heads_packed: int | None) -> torch.Tensor:
    """Max 2-norm over per-head token rows, a float32 scalar on t's
    device: t [B, L, N*D] heads-packed (``heads_packed=N``), or rows of D
    already ([BN, L, D] folded, [B, L, N, D]).  The bounded softmax's
    score bound is built from it (Cauchy-Schwarz)."""
    tf = t.float()
    if heads_packed is not None:
        tf = tf.reshape(*t.shape[:-1], heads_packed, -1)
    return torch.sqrt((tf * tf).sum(dim=-1).amax())


def _packed_ok(cfg: WanConfig) -> bool:
    """The heads-packed [B, L, N*D] kernel layout is used for head_dim
    multiples of 128 (production Wan); tiny geometries fold."""
    return cfg.head_dim % 128 == 0


def _qkv_project(p: Params, x: torch.Tensor, kernels: bool = True):
    """Self-attention input projections: three linears, or the fused
    [in, 3*out] ``qkv`` linear of ``quantize_dit_params(fuse_qkv=True)``
    split after its one product.  q and k leave the split through new
    tensors (norm, RoPE); v is copied out, since the attention kernel
    takes contiguous operands."""
    if "qkv" in p:
        qkv = linear(p["qkv"], x, kernels)
        n = qkv.shape[-1] // 3
        return qkv[..., :n], qkv[..., n:2 * n], qkv[..., 2 * n:].contiguous()
    return (linear(p["q"], x, kernels), linear(p["k"], x, kernels),
            linear(p["v"], x, kernels))


def _qk_normed(p: Params, cfg: WanConfig, x: torch.Tensor,
               q_gain: float | None, kernels: bool = True):
    q, k, v = _qkv_project(p, _tp_in(x, cfg), kernels)
    if cfg.qk_norm:
        wq = p["norm_q"]["w"]
        if q_gain is not None:
            wq = wq * torch.tensor(q_gain, dtype=wq.dtype, device=wq.device)
        q = _qk_rms_norm(q, wq, cfg)
        k = _qk_rms_norm(k, p["norm_k"]["w"], cfg)
    elif q_gain is not None:
        q = q * torch.tensor(q_gain, dtype=q.dtype, device=q.device)
    return q, k, v


def _qkv_rope_packed(p: Params, cfg: WanConfig, x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     q_gain: float | None = None, kernels: bool = True):
    """q/k/v in the [B, L, N*D] layout with RoPE applied to q and k.
    ``q_gain`` is folded into the q-norm gain (the free softmax's
    head_dim**-0.5 * log2(e); RoPE commutes with it)."""
    q, k, v = _qk_normed(p, cfg, x, q_gain, kernels)
    B, L, _ = q.shape

    def rope(t):
        return _rope_half(_heads(cfg, t), cos, sin).reshape(B, L, -1)

    return rope(q), rope(k), v


def _qkv_rope_folded(p: Params, cfg: WanConfig, x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     q_gain: float | None = None, kernels: bool = True):
    """q/k/v in the folded [B*N, L, D] layout with RoPE applied."""
    q, k, v = _qk_normed(p, cfg, x, q_gain, kernels)
    return (_rope_half(_fold_heads(cfg, q), cos, sin),
            _rope_half(_fold_heads(cfg, k), cos, sin),
            _fold_heads(cfg, v))


def precompute_context(params: Params, cfg: WanConfig,
                       context: torch.Tensor,
                       clip_fea: torch.Tensor | None = None) -> dict:
    """Per-prompt cross-attention K/V of every layer, stacked
    [layers, B, Lc, N, D] under "k_txt" / "v_txt"; for an i2v model given
    ``clip_fea`` [B, 257, 1280] also the image K/V under "k_img" /
    "v_img", from the layers' own ``k_img`` / ``v_img`` projections of
    :func:`embed_image`'s tokens."""
    layers = split_layers(params["blocks"]["cross_attn"])

    def kv(ctx, k_name, v_name, norm_name):
        ctx = _tp_in(ctx, cfg)
        ks, vs = [], []
        for p in layers:
            p = _layer_params(p)
            k = linear(p[k_name], ctx)
            if cfg.qk_norm:
                k = _qk_rms_norm(k, p[norm_name]["w"], cfg)
            ks.append(_heads(cfg, k))
            vs.append(_heads(cfg, linear(p[v_name], ctx)))
        return torch.stack(ks), torch.stack(vs)

    out = dict(zip(("k_txt", "v_txt"), kv(embed_text(params, cfg, context),
                                          "k", "v", "norm_k")))
    if clip_fea is not None and cfg.model_type == "i2v":
        out.update(zip(("k_img", "v_img"),
                       kv(embed_image(params, clip_fea), "k_img", "v_img",
                          "norm_k_img")))
    return out


def layer_context(ctx_kv: dict) -> list[dict]:
    """:func:`precompute_context`'s stacked K/V split into one dict a
    layer (the text keys, and the image keys where there are any)."""
    per = {k: v.unbind(0) for k, v in ctx_kv.items()}
    return [{k: v[i] for k, v in per.items()}
            for i in range(len(per["k_txt"]))]


def _cross_attention(bp: Params, cfg: WanConfig, x: torch.Tensor,
                     ctx_kv_layer: dict, kernels: bool = True
                     ) -> torch.Tensor:
    """Cross-attention with precomputed K/V: onto the text keys, plus (an
    i2v layer context) a second attention onto the image keys, the two
    outputs summed before the output projection."""
    p = bp["cross_attn"]
    q = linear(p["q"], _tp_in(x, cfg), kernels)
    if cfg.qk_norm:
        q = _qk_rms_norm(q, p["norm_q"]["w"], cfg)
    packed = _packed_ok(cfg)
    if not packed:
        q = _heads(cfg, q)

    def attend(kind):
        return cross_attention(
            q, ctx_kv_layer["k_" + kind], ctx_kv_layer["v_" + kind],
            heads_packed=cfg.num_heads if packed else None, kernels=kernels)

    out = attend("txt")
    if "k_img" in ctx_kv_layer:
        out = out + attend("img")
    if packed:
        return _out_linear(p["o"], out, cfg, kernels)
    B, Lq = out.shape[:2]
    return _out_linear(p["o"], out.reshape(B, Lq,
                                           cfg.num_heads * cfg.head_dim),
                       cfg, kernels)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale_: torch.Tensor,
              frame_seqlen: int) -> torch.Tensor:
    """Per-frame AdaLN: x [B, F*fs, D] * (1 + scale[B,F,1,D]) + shift."""
    B, L, D = x.shape
    xf = x.reshape(B, shift.shape[1], frame_seqlen, D)
    return (xf * (1.0 + scale_) + shift).reshape(B, L, D)


def _ffn(bp: Params, cfg: WanConfig, x: torch.Tensor,
         kernels: bool = True) -> torch.Tensor:
    """fc2(gelu_tanh(fc1(x))), fc2 row-sharded under tensor parallelism;
    the fused W8A8 FFN when both linears are ``w_qa``."""
    fc1, fc2 = bp["ffn"]["fc1"], bp["ffn"]["fc2"]
    if "w_qa" in fc1 and "w_qa" in fc2:
        return quant.quantized_ffn(fc1, fc2, x, kernels)
    return _out_linear(fc2, gelu_tanh(linear(fc1, _tp_in(x, cfg), kernels)),
                       cfg, kernels)


def _gate(x: torch.Tensor, g: torch.Tensor,
          frame_seqlen: int) -> torch.Tensor:
    B, L, D = x.shape
    return (x.reshape(B, g.shape[1], frame_seqlen, D) * g).reshape(B, L, D)


def head_forward(params: Params, cfg: WanConfig, x: torch.Tensor,
                 e: torch.Tensor, frame_seqlen: int) -> torch.Tensor:
    """Final AdaLN head; e is [B, F, D]."""
    hp = params["head"]
    mod = hp["modulation"].float()                 # [1, 2, D]
    em = mod[:, None] + e.float()[:, :, None, :]   # [B, F, 2, D]
    shift = em[:, :, 0:1].to(x.dtype)
    scale_ = em[:, :, 1:2].to(x.dtype)
    xn = layer_norm(x, cfg.eps)
    return linear(hp["head"], _modulate(xn, shift, scale_, frame_seqlen))


def _maybe_add_condition(params: Params, x: torch.Tensor,
                         add_condition: torch.Tensor | None,
                         kernels: bool = True) -> torch.Tensor:
    """Pose conditioning: tokens + pose_proj(add_condition) (5120 -> dim,
    in the tokens' dtype; added as it is where the model has no
    ``pose_proj``, dim 5120)."""
    if add_condition is None:
        return x
    cond = add_condition.to(x.dtype)
    if "pose_proj" in params:
        cond = linear(params["pose_proj"], cond, kernels)
    return x + cond


# =====================================================================
# KV cache
# =====================================================================

@dataclasses.dataclass
class KVCache:
    """Static-shape per-layer KV cache, k/v [L, B*N, S, D] in the
    attention kernels' folded layout.  ``global_end`` is the absolute
    token index past the newest cached token, ``local_end`` its position
    in the cache (equal on the global path).  ``kmax`` [L] float32: per
    layer, the max 2-norm of the cached K rows, the bounded softmax's
    bound on the cached keys; zero when empty, raised by the global
    cache's writes under the bounded softmax on the kernel route.  None
    (a cache built without it) knows no bound: 'bounded' then runs the
    online softmax, as on the windowed cache.  ``shard`` (the training
    rollout's cache constraint, ``parallel/fsdp.ShardedCache``): k / v
    hold this rank's slice, a layer is all-gathered where a block reads it
    and a write goes to the slice's rows."""

    k: torch.Tensor
    v: torch.Tensor
    global_end: int = 0
    local_end: int = 0
    kmax: torch.Tensor | None = None
    shard: object | None = None


def init_kv_cache(cfg: WanConfig, batch_size: int, frame_seqlen: int,
                  num_frames: int, dtype=torch.bfloat16,
                  device: str | torch.device = "cuda") -> KVCache:
    """Zeroed cache, shaped as the JAX package's: a windowed config gets
    ``cfg.buffer_frames`` frames; the global cache ``num_frames`` frames
    with S rounded up to a multiple of 2048."""
    if cfg.local_attn_size != -1:
        S = cfg.buffer_frames * frame_seqlen
    else:
        S = num_frames * frame_seqlen
        if S > 2048:
            S = -(-S // 2048) * 2048
    shape = (cfg.num_layers, batch_size * cfg.num_heads, S, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   kmax=torch.zeros(cfg.num_layers, dtype=torch.float32,
                                    device=device))


def _keep_recent(cfg: WanConfig, frame_seqlen: int, new_tokens: int) -> int:
    """Recent tokens that survive a compaction before a write of
    ``new_tokens``: the window less the sinks and the new block."""
    return max(0, cfg.max_attention_size(frame_seqlen)
               - cfg.sink_size * frame_seqlen - new_tokens)


def _compact(cfg: WanConfig, cache: KVCache, new_tokens: int,
             frame_seqlen: int) -> KVCache:
    """Compaction of the windowed buffer before an advancing write of
    ``new_tokens``: the sink frames stay, the most recent ``window - sinks
    - new_tokens`` tokens move to just after them, and ``local_end`` drops
    to the end of what was kept (``global_end`` is unchanged).  In place;
    the moved rows are cloned first, because with buffer == window the
    source and destination overlap (window 12, sink 1, 3-frame blocks:
    frames 4-12 move to 1-9).  The clone is scratch on the cache's own
    device."""
    sink_tokens = cfg.sink_size * frame_seqlen
    keep = _keep_recent(cfg, frame_seqlen, new_tokens)
    if keep:
        src = cache.local_end - keep
        for kv in (cache.k, cache.v):
            kv[:, :, sink_tokens:sink_tokens + keep] = \
                kv[:, :, src:src + keep].clone()
    return dataclasses.replace(cache, local_end=sink_tokens + keep)


def compact_cache(cfg: WanConfig, cache: KVCache,
                  new_tokens: int) -> KVCache:
    """Unconditional compaction (:func:`_compact`) of a buffer of
    ``cfg.buffer_frames`` frames, for host-scheduled eviction."""
    return _compact(cfg, cache, new_tokens,
                    cache.k.shape[2] // cfg.buffer_frames)


def _windowed_compact(cfg: WanConfig, cache: KVCache, new_tokens: int,
                      frame_seqlen: int) -> KVCache:
    """:func:`_compact` when a write of ``new_tokens`` at ``local_end``
    would overflow the buffer; the cache as it is otherwise."""
    if new_tokens + cache.local_end > cache.k.shape[2]:
        return _compact(cfg, cache, new_tokens, frame_seqlen)
    return cache


def evict_for(cfg: WanConfig, cache: KVCache, new_tokens: int) -> KVCache:
    """Compact the windowed buffer ahead of an advancing write of
    ``new_tokens`` if it would overflow (no-op on the global cache), for
    callers that do not track the buffer fill themselves."""
    if cfg.local_attn_size == -1:
        return cache
    return _windowed_compact(cfg, cache, new_tokens,
                             cache.k.shape[2] // cfg.buffer_frames)


def windowed_compaction_schedule(cfg: WanConfig, frame_seqlen: int,
                                 new_tokens: int) -> tuple[int, int]:
    """(buffer_tokens, post_compact_tokens) for a host-side fill tracker:
    compact when ``content + new_tokens > buffer_tokens``; after the
    compaction the content is ``post_compact_tokens``."""
    S = cfg.buffer_frames * frame_seqlen
    return S, cfg.sink_size * frame_seqlen + _keep_recent(
        cfg, frame_seqlen, new_tokens)


def reset_kv_cache(cache: KVCache) -> KVCache:
    """Rewind the cache indices and zero ``kmax``.  Stale rows are never
    attended to; with int8 attention the ones inside a live cache tile
    still enter its k (and v) scale, as in the JAX package."""
    kmax = None if cache.kmax is None else torch.zeros_like(cache.kmax)
    return dataclasses.replace(cache, global_end=0, local_end=0, kmax=kmax)


# =====================================================================
# transformer block, decode with fresh K/V
# =====================================================================

def _block_decode_fresh(bp: Params, cfg: WanConfig, x: torch.Tensor,
                        e0: torch.Tensor, rope_cos: torch.Tensor,
                        rope_sin: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, attn_lo: int, cache_hi: int,
                        ctx_kv_layer: dict, frame_seqlen: int,
                        static_kv_hi: int | None = None,
                        layer_idx: int | None = None,
                        emit_kv: bool = True, kernels: bool = True,
                        sink_hi: int | None = None,
                        tk_align: int | None = None,
                        window_static: tuple[int, int] | None = None,
                        kmax_layer: torch.Tensor | None = None):
    """One block whose self-attention reads the cache window
    ``[attn_lo, cache_hi)`` (plus the sinks ``[0, sink_hi)`` on the
    windowed path) of layer ``layer_idx`` (read only) plus the block's
    fresh K/V.  Returns (x, k_new, v_new, kn_norm); the fresh K/V come
    folded [B*N, L, D] for the cache write, or None when ``emit_kv`` is
    False; ``kn_norm`` is the fresh K's max row norm (the caller's kmax
    update) under the bounded softmax, else None.

    On the kernel route, as the JAX package on its Pallas route:
    'free' folds head_dim**-0.5 * log2(e) into the q-norm gain and runs
    at scale 1 (``cfg.attn_quant='int8qk'``: int8-QK attention); the
    full-int8 quant forces 'bounded'; 'bounded' with ``kmax_layer`` (this
    layer's ``KVCache.kmax``) passes m0 = head_dim**-0.5 * max|q_row| *
    max(kmax_layer, max|k_new_row|); everything else is the online
    softmax.  Off the route the unfolded base-e reference runs (quant
    ignored).  A sharded cache layer (``KVCache.shard``'s ``layer``) is
    all-gathered here, inside a remat'd block, and the attention saves
    the gathered layer for its backward (a recompute gathers it again)."""
    save_cache = hasattr(k_cache, "gathered")
    if save_cache:
        k_cache, v_cache, layer_idx = k_cache.gathered(), v_cache.gathered(), 0
    bp = _layer_params(bp)
    mod = bp["modulation"].float()[:, None]
    e = (mod + e0.float()).to(x.dtype)
    e_shift, e_scale, e_gate = e[:, :, 0:1], e[:, :, 1:2], e[:, :, 2:3]
    f_shift, f_scale, f_gate = e[:, :, 3:4], e[:, :, 4:5], e[:, :, 5:6]

    mode = cfg.attn_softmax
    if mode == "free" and cfg.attn_quant not in (None, "int8qk"):
        mode = "bounded"  # the full-int8 kernels need the m0 bound
    bounded = (mode == "bounded" and kmax_layer is not None
               and attn_ops._kernel_route(x))
    free = mode == "free" and _free_softmax(cfg, x)
    q_gain = (cfg.head_dim ** -0.5) * LOG2E if free else None
    quant_mode = cfg.attn_quant
    if quant_mode == "int8qk" and not free:
        quant_mode = None  # int8qk exists only on the free path
    attn_args = dict(scale=1.0 if free else None, static_hi=static_kv_hi,
                     layer_idx=layer_idx, softmax="free" if free else None,
                     sink_end=sink_hi, tk_align=tk_align,
                     window_static=window_static, quant=quant_mode,
                     kernels=kernels)
    if save_cache:
        attn_args["save_cache"] = True
    kn_norm = None

    def bound(q_, k_, heads):
        # s <= scale * max|q_row| * max|k_row| over the window: the cached
        # bound and this block's fresh K
        nonlocal kn_norm
        kn_norm = _max_row_norm(k_, heads).detach()
        return (cfg.head_dim ** -0.5) * _max_row_norm(q_, heads) \
            * torch.maximum(kmax_layer, kn_norm)

    xn = _modulate(layer_norm(x, cfg.eps), e_shift, e_scale, frame_seqlen)
    if _packed_ok(cfg):
        qp, kp, vp = _qkv_rope_packed(bp["self_attn"], cfg, xn, rope_cos,
                                      rope_sin, q_gain, kernels)
        m0 = bound(qp, kp, cfg.num_heads) if bounded else None
        attn = decode_attention_fresh(qp, k_cache, v_cache, kp, vp, attn_lo,
                                      cache_hi, heads_packed=cfg.num_heads,
                                      fixed_m0=m0, **attn_args)
        y = _out_linear(bp["self_attn"]["o"], attn, cfg, kernels)
        kf = vf = None
    else:
        qf, kf, vf = _qkv_rope_folded(bp["self_attn"], cfg, xn, rope_cos,
                                      rope_sin, q_gain, kernels)
        m0 = bound(qf, kf, None) if bounded else None
        attn = decode_attention_fresh(qf, k_cache, v_cache, kf, vf, attn_lo,
                                      cache_hi, fixed_m0=m0, **attn_args)
        y = _out_linear(bp["self_attn"]["o"], _unfold_heads(cfg, attn), cfg,
                        kernels)
    x = x + _gate(y, e_gate, frame_seqlen)

    if "norm3" in bp:
        xc = layer_norm(x, cfg.eps, bp["norm3"]["w"], bp["norm3"]["b"])
    else:
        xc = x
    x = x + _cross_attention(bp, cfg, xc, ctx_kv_layer, kernels)

    xn = _modulate(layer_norm(x, cfg.eps), f_shift, f_scale, frame_seqlen)
    x = x + _gate(_ffn(bp, cfg, xn, kernels), f_gate, frame_seqlen)
    if not emit_kv:
        return x, None, None, kn_norm
    if kf is None:
        kf, vf = _fold_heads(cfg, kp), _fold_heads(cfg, vp)
    return x, kf, vf, kn_norm


# =====================================================================
# streaming forward
# =====================================================================

def forward_inference(params: Params, cfg: WanConfig, x: torch.Tensor,
                      t: torch.Tensor, ctx_kv: dict, cache: KVCache,
                      start_frame: int, rope: RopeTables,
                      cache_start_frame: int | None = None,
                      static_kv_hi: int | None = None,
                      write_cache: bool = True,
                      assume_compacted: bool = False,
                      kernels: bool = True,
                      remat: bool = False,
                      y: torch.Tensor | None = None,
                      add_condition: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, KVCache]:
    """KV-cached streaming forward of one chunk.

    x: [B, F_blk, C, H, W]; t: [B, F_blk]; ``ctx_kv`` from
    :func:`precompute_context`; ``start_frame``: absolute frame index of
    the chunk (RoPE position); ``cache_start_frame`` decouples the cache
    write position (defaults to ``start_frame``).  ``static_kv_hi``: the
    number of tokens already cached, an upper bound that lets the
    attention kernel skip the rest of the cache (global cache only).
    ``write_cache=False`` (the denoise steps) leaves the cache and its
    indices untouched: the refresh pass writes the block afterwards.

    Windowed cache: an advancing chunk that would overflow the buffer
    first compacts it (:func:`_windowed_compact`), unless
    ``assume_compacted`` says the caller did (the streaming pipeline
    schedules :func:`compact_cache` itself); the compacted cache is
    returned even with ``write_cache=False``.  The chunk then attends to
    the sink frames and the recent window.

    ``kernels=False`` runs the attention and the W8A8 linears through the
    kernels' plain versions on CUDA.  ``remat=True`` checkpoints each
    layer (a with-grad forward recomputes it in the backward); the cache
    is read by reference, so it must not be written inside the window
    before the backward.  ``y`` [B, F_blk, C_y, H, W]: channels
    concatenated to x; ``add_condition`` [B, F_blk*h*w, 5120]: pose
    tokens (:func:`_maybe_add_condition`).
    Returns (flow_pred [B, F_blk, C, H, W], cache)."""
    if y is not None:
        x = torch.cat([x, y], dim=2)
    tokens, grid = patchify(params, cfg, x)
    Fb, h, w = grid
    frame_seqlen = h * w
    tokens = _maybe_add_condition(params, tokens, add_condition, kernels)
    e, e0 = time_embed(params, cfg, t, tokens.dtype)
    cos, sin = rope.angles_for_grid(Fb, h, w, int(start_frame))
    if cache_start_frame is None:
        cache_start_frame = start_frame

    Lq = Fb * frame_seqlen
    current_end = int(cache_start_frame) * frame_seqlen + Lq
    window = {}
    if cfg.local_attn_size != -1:
        if cache.shard is not None:
            raise ValueError("a sharded KV cache is global: the windowed "
                             "cache's compaction moves rows across slices")
        if not assume_compacted and current_end > cache.global_end:
            cache = _windowed_compact(cfg, cache, Lq, frame_seqlen)
        sink_tokens = cfg.sink_size * frame_seqlen
        keep_recent = _keep_recent(cfg, frame_seqlen, Lq)
        local_end = cache.local_end + (current_end - cache.global_end)
        write_at = local_end - Lq
        sink_hi = min(sink_tokens, write_at)
        attn_lo = max(sink_hi, write_at - keep_recent)
        # frame-aligned cache tiles: the window's bounds are whole frames
        window = dict(sink_hi=sink_hi, window_static=(sink_tokens,
                                                      keep_recent),
                      tk_align=frame_seqlen if frame_seqlen % 8 == 0
                      else None)
        static_kv_hi = None
    else:
        local_end = cache.local_end + (current_end - cache.global_end)
        write_at = local_end - Lq
        attn_lo = max(0, local_end - cfg.max_attention_size(frame_seqlen))

    # the global cache's per-layer kmax bounds the bounded softmax; the
    # windowed branch passes none (its eviction could not track one), so
    # 'bounded' runs the online softmax there
    kmax = None if window else cache.kmax
    block = (partial(checkpoint, _block_decode_fresh, use_reentrant=False)
             if remat else _block_decode_fresh)
    kn_norms = []
    for li, (bp, layer_ctx) in enumerate(zip(split_layers(params["blocks"]),
                                             layer_context(ctx_kv))):
        kc, vc = (cache.k, cache.v) if cache.shard is None \
            else cache.shard.layer(cache, li)
        tokens, k_new, v_new, kn_norm = block(
            bp, cfg, tokens, e0, cos, sin, kc, vc, attn_lo,
            write_at, layer_ctx, frame_seqlen, static_kv_hi, layer_idx=li,
            emit_kv=write_cache, kernels=kernels,
            kmax_layer=None if kmax is None else kmax[li], **window)
        if write_cache and cache.shard is not None:
            cache.shard.write(cache, li, write_at, k_new, v_new)
        elif write_cache:
            # later layers read only their own layer: writing now is the
            # same as the JAX package's single write after the layer scan
            cache.k[li, :, write_at:write_at + Lq] = k_new
            cache.v[li, :, write_at:write_at + Lq] = v_new
            if kn_norm is not None:
                kn_norms.append(kn_norm)
    if write_cache:
        kmax = cache.kmax
        if kn_norms:   # the incremental update of the cached-K bound
            kmax = torch.maximum(kmax, torch.stack(kn_norms))
        cache = KVCache(k=cache.k, v=cache.v, global_end=current_end,
                        local_end=local_end, kmax=kmax, shard=cache.shard)

    out_tokens = head_forward(params, cfg, tokens, e, frame_seqlen)
    return unpatchify(cfg, out_tokens, grid), cache


# =====================================================================
# training forward (no cache)
# =====================================================================

def _block_train(bp: Params, cfg: WanConfig, x: torch.Tensor,
                 e0: torch.Tensor, rope_cos: torch.Tensor,
                 rope_sin: torch.Tensor, mask: IntervalMask | None,
                 ctx_kv_layer: dict, frame_seqlen: int,
                 kernels: bool = True, attn_fn=None) -> torch.Tensor:
    """One block with full-sequence self-attention under ``mask``.  On the
    kernel route, as the JAX package on its Pallas route: 'free' folds
    head_dim**-0.5 * log2(e) into the q-norm gain (the flash kernels at
    scale 1, their backward at ln 2); 'bounded' passes the bound m0 =
    head_dim**-0.5 * max|q_row| * max|k_row|; anything else runs the
    online softmax.  Off the route the base-e reference at
    head_dim**-0.5, as the JAX package off the TPU.

    ``attn_fn(q, k, v) -> [B, L, N, D]`` (q, k, v [B, L, N, D], RoPE
    applied, no gain folded) replaces the flash attention: the
    sequence-parallel ring attention plugs in here, so the block's math
    is not forked."""
    bp = _layer_params(bp)
    mod = bp["modulation"].float()[:, None]
    e = (mod + e0.float()).to(x.dtype)
    e_shift, e_scale, e_gate = e[:, :, 0:1], e[:, :, 1:2], e[:, :, 2:3]
    f_shift, f_scale, f_gate = e[:, :, 3:4], e[:, :, 4:5], e[:, :, 5:6]

    xn = _modulate(layer_norm(x, cfg.eps), e_shift, e_scale, frame_seqlen)
    free = attn_fn is None and _free_softmax(cfg, x)
    q_gain = (cfg.head_dim ** -0.5) * LOG2E if free else None
    q, k, v = _qk_normed(bp["self_attn"], cfg, xn, q_gain, kernels)
    q = _rope_half(_heads(cfg, q), rope_cos, rope_sin)
    k = _rope_half(_heads(cfg, k), rope_cos, rope_sin)
    if attn_fn is not None:
        attn = attn_fn(q, k, _heads(cfg, v))
    else:
        m0 = None
        if not free and cfg.attn_softmax == "bounded" \
                and attn_ops._kernel_route(x):
            m0 = (cfg.head_dim ** -0.5) * _max_row_norm(q, None) \
                * _max_row_norm(k, None)
        attn = flash_attention(q, k, _heads(cfg, v), mask, fixed_m0=m0,
                               softmax="free" if free else None,
                               kernels=kernels)
    B, L = attn.shape[:2]
    # num_heads * head_dim, not dim: under tensor parallelism only the
    # rank's heads are here
    y = _out_linear(bp["self_attn"]["o"],
                    attn.reshape(B, L, cfg.num_heads * cfg.head_dim), cfg,
                    kernels)
    x = x + _gate(y, e_gate, frame_seqlen)

    if "norm3" in bp:
        xc = layer_norm(x, cfg.eps, bp["norm3"]["w"], bp["norm3"]["b"])
    else:
        xc = x
    x = x + _cross_attention(bp, cfg, xc, ctx_kv_layer, kernels)

    xn = _modulate(layer_norm(x, cfg.eps), f_shift, f_scale, frame_seqlen)
    return x + _gate(_ffn(bp, cfg, xn, kernels), f_gate, frame_seqlen)


def forward_train(params: Params, cfg: WanConfig, x: torch.Tensor,
                  t: torch.Tensor, context: torch.Tensor,
                  mask: IntervalMask | None, rope: RopeTables,
                  clean_x: torch.Tensor | None = None,
                  aug_t: torch.Tensor | None = None,
                  remat: bool = True, kernels: bool = True,
                  y: torch.Tensor | None = None,
                  add_condition: torch.Tensor | None = None,
                  clip_fea: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """No-cache forward: bidirectional (``mask=None``, the score models)
    or masked causal training, with the teacher-forcing [clean | noisy]
    doubled sequence when ``clean_x`` is given (its timestep ``aug_t``,
    default 0; both halves get the same RoPE positions).

    x: [B, F, C, H, W]; t: [B, F]; context: [B, <=512, text_dim].
    ``remat``: recompute each layer in the backward.  ``y`` is
    concatenated to x's channels (not to ``clean_x``); ``add_condition``
    goes onto x's tokens before the clean half is put in front;
    ``clip_fea`` [B, 257, 1280]: an i2v model's CLIP image tokens.
    Returns the flow prediction [B, F, C, H, W]."""
    if y is not None:
        x = torch.cat([x, y], dim=2)
    tokens, grid = patchify(params, cfg, x)
    frame_seqlen = grid[1] * grid[2]
    tokens = _maybe_add_condition(params, tokens, add_condition, kernels)
    e, e0 = time_embed(params, cfg, t, tokens.dtype)
    cos, sin = rope.angles_for_grid(*grid, 0)
    if clean_x is not None:
        clean_tokens, _ = patchify(params, cfg, clean_x)
        tokens = torch.cat([clean_tokens, tokens], dim=1)
        if aug_t is None:
            aug_t = torch.zeros_like(t)
        _, e0_clean = time_embed(params, cfg, aug_t, tokens.dtype)
        e0 = torch.cat([e0_clean, e0], dim=1)
        cos, sin = torch.cat([cos, cos]), torch.cat([sin, sin])

    ctx_kv = precompute_context(params, cfg, context, clip_fea)
    block = (partial(checkpoint, _block_train, use_reentrant=False)
             if remat else _block_train)
    for bp, layer_ctx in zip(split_layers(params["blocks"]),
                             layer_context(ctx_kv)):
        tokens = block(bp, cfg, tokens, e0, cos, sin, mask, layer_ctx,
                       frame_seqlen, kernels)
    if clean_x is not None:
        tokens = tokens[:, tokens.shape[1] // 2:]
    out_tokens = head_forward(params, cfg, tokens, e, frame_seqlen)
    return unpatchify(cfg, out_tokens, grid)


# =====================================================================
# GAN discriminator extras: the register tokens, the three 1-query
# cross-attention blocks and the classifier over the tapped layers
# =====================================================================

GAN_FFN_DIM = 8192  # the hidden width of a GAN attention block's FFN


def default_gan_taps(num_layers: int) -> tuple[int, ...]:
    """The feature-tap layers: 13 / 21 / 29 of the 30-layer 1.3B, scaled
    to other depths and clamped to the last layer (so a shallow model
    taps one layer more than once)."""
    return tuple(min(num_layers - 1, round(f * num_layers))
                 for f in (13 / 30, 21 / 30, 29 / 30))


def init_cls_branch_params(cfg: WanConfig, seed: int = 0,
                           num_class: int = 1, time_embed_dim: int = 0,
                           dtype=torch.float32,
                           device: str | torch.device = "cuda") -> Params:
    """The GAN head, drawn from a ``torch.Generator`` seeded with
    ``seed``: 3 register tokens (std 0.02) with their RMSNorm gain, 3 GAN
    attention blocks (LayerNorm, 1-query cross attention with q / k
    RMSNorms, an FFN of width :data:`GAN_FFN_DIM`) and the classifier
    (LayerNorm + MLP over the 3 taps' tokens, plus ``time_embed_dim``
    inputs for the time embedding)."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, num_registers = cfg.dim, 3

    def ones(n=d):
        return torch.ones(n, dtype=dtype, device=device)

    def ca_block():
        attn = {n: _linear_init(g, d, d, dtype, device) for n in "qkvo"}
        attn.update(norm_q={"w": ones()}, norm_k={"w": ones()})
        return {
            "norm3": {"w": ones(), "b": torch.zeros_like(ones())},
            "cross_attn": attn,
            "ffn": {"fc1": _linear_init(g, d, GAN_FFN_DIM, dtype, device),
                    "fc2": _linear_init(g, GAN_FFN_DIM, d, dtype, device)},
        }

    in_dim = d * num_registers + time_embed_dim
    registers = (torch.randn(num_registers, d, generator=g, device=device)
                 * 0.02).to(dtype)
    return {
        "registers": registers,
        "register_norm": {"w": ones()},
        "ca_blocks": [ca_block() for _ in range(num_registers)],
        "cls": {"ln": {"w": ones(in_dim), "b": torch.zeros_like(ones(in_dim))},
                "fc1": _linear_init(g, in_dim, d, dtype, device),
                "fc2": _linear_init(g, d, num_class, dtype, device)},
    }


def _gan_ca_block(bp: Params, cfg: WanConfig, x: torch.Tensor,
                  token: torch.Tensor) -> torch.Tensor:
    """One GAN attention block: the register token [B, 1, D] attends to
    the tapped tokens x (plain attention: one query), then an FFN
    residual."""
    B = x.shape[0]
    xn = layer_norm(x, cfg.eps, bp["norm3"]["w"], bp["norm3"]["b"])
    p = bp["cross_attn"]
    q = rms_norm(linear(p["q"], token), p["norm_q"]["w"], cfg.eps)
    k = rms_norm(linear(p["k"], xn), p["norm_k"]["w"], cfg.eps)
    v = linear(p["v"], xn)
    out = attn_ops.dense_attention(_heads(cfg, q), _heads(cfg, k),
                                   _heads(cfg, v))
    tok = token + linear(p["o"], out.reshape(B, 1, cfg.dim))
    y = linear(bp["ffn"]["fc2"], gelu_tanh(linear(
        bp["ffn"]["fc1"], layer_norm(tok, cfg.eps))))
    return y + tok


def forward_classify(params: Params, cls_params: Params, cfg: WanConfig,
                     x: torch.Tensor, t: torch.Tensor,
                     context: torch.Tensor, rope: RopeTables,
                     concat_time_embeddings: bool = False,
                     remat: bool = True, kernels: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bidirectional forward with the GAN feature taps: returns (the
    flow prediction [B, F, C, H, W], logits [B, num_class]).

    The layers run unmasked (the flash attention with no mask); after
    each tap layer of :func:`default_gan_taps` its register token reads
    the tokens through a GAN attention block, and the classifier takes
    the three outputs (and ``10 * e[:, 0]``, the first frame's time
    embedding, with ``concat_time_embeddings``).  ``remat``: recompute
    each layer in the backward."""
    B = x.shape[0]
    tokens, grid = patchify(params, cfg, x)
    frame_seqlen = grid[1] * grid[2]
    e, e0 = time_embed(params, cfg, t, tokens.dtype)
    cos, sin = rope.angles_for_grid(*grid, 0)
    ctx_kv = precompute_context(params, cfg, context)
    block = (partial(checkpoint, _block_train, use_reentrant=False)
             if remat else _block_train)
    registers = rms_norm(cls_params["registers"],
                         cls_params["register_norm"]["w"]).to(tokens.dtype)
    taps = default_gan_taps(cfg.num_layers)
    feats = []
    for i, (bp, layer_ctx) in enumerate(zip(split_layers(params["blocks"]),
                                            layer_context(ctx_kv))):
        tokens = block(bp, cfg, tokens, e0, cos, sin, None, layer_ctx,
                       frame_seqlen, kernels)
        for j, tap in enumerate(taps):
            if tap == i:
                token = registers[j][None, None].expand(B, 1, cfg.dim)
                feats.append(_gan_ca_block(cls_params["ca_blocks"][j], cfg,
                                           tokens, token))
    h = torch.cat(feats, dim=1).reshape(B, -1)              # [B, 3D]
    if concat_time_embeddings:
        h = torch.cat([h, 10.0 * e[:, 0]], dim=-1)
    c = cls_params["cls"]
    h = layer_norm(h, 1e-5, c["ln"]["w"], c["ln"]["b"])
    logits = linear(c["fc2"], F.silu(linear(c["fc1"], h)))
    out_tokens = head_forward(params, cfg, tokens, e, frame_seqlen)
    return unpatchify(cfg, out_tokens, grid), logits
