"""umT5-XXL text encoder (port of ``self_forcing_tpu/models/wan/t5.py``).

24 pre-norm blocks with a relative position bias per layer (umT5 shares
none), a gated tanh-GELU FFN, no attention scaling (the T5 convention)
and a final T5LayerNorm.  umt5-xxl: vocab 256384, dim 4096, dim_attn
4096, ffn 10240, 64 heads, 24 layers, 32 relative-position buckets.

Parameters are the JAX package's tree: linear weights [in, out], blocks
stacked on axis 0, ``pos_emb`` [num_buckets, heads] in float32 whatever
dtype the rest takes.  The numerics follow the JAX code step by step:
scores in float32 (the products of the weights' dtype summed in float32),
plus the float32 position bias and a -1e30 padding bias; the softmax in
float32 and its probabilities cast to v's dtype before P.V; the norm and
the GELU in float32, rounded back to the activations' dtype; the residual
stream in the parameters' dtype.  The products are ``torch.matmul``: the
encoder runs no kernel of its own.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.utils import tree

Params = dict


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    eps: float = 1e-6


UMT5_XXL = T5Config()
T5_TINY = T5Config(vocab_size=256, dim=64, dim_attn=64, dim_ffn=128,
                   num_heads=4, num_layers=2, num_buckets=8)


# ---------------------------------------------------------------- init

def _lin(g, d_in, d_out, std, dtype, device) -> Params:
    return {"w": (torch.randn(d_in, d_out, generator=g, device=device)
                  * std).to(dtype)}


def _block_init(g, cfg: T5Config, dtype, device) -> Params:
    d, da, dff, nh = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads
    return {
        "norm1": {"w": torch.ones(d, dtype=dtype, device=device)},
        "attn": {
            "q": _lin(g, d, da, (d * da) ** -0.5, dtype, device),
            "k": _lin(g, d, da, d ** -0.5, dtype, device),
            "v": _lin(g, d, da, d ** -0.5, dtype, device),
            "o": _lin(g, da, d, (nh * (da // nh)) ** -0.5, dtype, device),
        },
        "norm2": {"w": torch.ones(d, dtype=dtype, device=device)},
        "ffn": {
            "gate": _lin(g, d, dff, d ** -0.5, dtype, device),
            "fc1": _lin(g, d, dff, d ** -0.5, dtype, device),
            "fc2": _lin(g, dff, d, dff ** -0.5, dtype, device),
        },
        "pos_emb": torch.randn(cfg.num_buckets, nh, generator=g,
                               device=device)
        * (2 * cfg.num_buckets * nh) ** -0.5,
    }


def init_params(cfg: T5Config, seed: int = 0, dtype=torch.bfloat16,
                device: str | torch.device = "cuda") -> Params:
    """Random encoder parameters with the JAX package's distributions,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the layers first, each copied into the preallocated stack as it is
    drawn, then the embedding table).  ``pos_emb`` stays float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    blocks = tree.stack((_block_init(g, cfg, dtype, device)
                         for _ in range(cfg.num_layers)), cfg.num_layers)
    emb = torch.empty(cfg.vocab_size, cfg.dim, dtype=dtype, device=device)
    rows = max(1, (1 << 26) // cfg.dim)   # draw the table in float32 slabs
    for lo in range(0, cfg.vocab_size, rows):
        n = min(rows, cfg.vocab_size - lo)
        emb[lo:lo + n] = torch.randn(n, cfg.dim, generator=g, device=device)
    return {"token_embedding": emb, "blocks": blocks,
            "norm": {"w": torch.ones(cfg.dim, dtype=dtype, device=device)}}


# ---------------------------------------------------------------- forward

def t5_layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """RMS-style T5LayerNorm: no mean subtraction, float32 inside."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (w.float() * n).to(x.dtype)


def gelu_erf_free(x: torch.Tensor) -> torch.Tensor:
    """The reference's hand-written tanh GELU, 0.5 x (1 + tanh(sqrt(2 /
    pi) (x + 0.044715 x^3))), computed in float32, rounded to x's dtype."""
    # F.gelu's tanh form is this formula, in float32 for bf16 inputs, in
    # one pass
    return F.gelu(x, approximate="tanh")


def relative_position_buckets(L: int, num_buckets: int,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket matrix [L, L], int64, on the host."""
    rel = np.arange(L)[None, :] - np.arange(L)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_dist / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets


def _encoder_block(bp: Params, cfg: T5Config, x: torch.Tensor,
                   buckets: torch.Tensor, pad_bias: torch.Tensor
                   ) -> torch.Tensor:
    """One encoder block (self-attention + gated-GELU FFN); shared by the
    resident and the weight-streamed forward."""
    B, L, _ = x.shape
    nh = cfg.num_heads
    hd = cfg.dim_attn // nh
    # [B, nh, L, L], gathered head-major; adding the padding bias to the
    # position bias first gives the same sums: pos + 0 is pos, and both
    # orders round to -1e30 where the bias is -1e30
    bias = bp["pos_emb"].float().t()[:, buckets] + pad_bias
    h = t5_layer_norm(x, bp["norm1"]["w"], cfg.eps)
    q = (h @ bp["attn"]["q"]["w"]).view(B, L, nh, hd).transpose(1, 2)
    k = (h @ bp["attn"]["k"]["w"]).view(B, L, nh, hd).transpose(1, 2)
    v = (h @ bp["attn"]["v"]["w"]).view(B, L, nh, hd).transpose(1, 2)
    # products of the weights' dtype are exact in float32: the scores are
    # those products summed in float32, as preferred_element_type=f32 is
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores.add_(bias), dim=-1).to(v.dtype)
    a = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, cfg.dim_attn)
    x = x + a @ bp["attn"]["o"]["w"]

    h = t5_layer_norm(x, bp["norm2"]["w"], cfg.eps)
    ff = (h @ bp["ffn"]["fc1"]["w"]) * gelu_erf_free(
        h @ bp["ffn"]["gate"]["w"])
    return x + ff @ bp["ffn"]["fc2"]["w"]


def _pad_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] {0, 1} -> [B, 1, 1, L] additive float32 padding bias."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, -1e30)


def _buckets(cfg: T5Config, L: int, device) -> torch.Tensor:
    return torch.from_numpy(relative_position_buckets(
        L, cfg.num_buckets, cfg.max_dist)).to(device)


def encode(params: Params, cfg: T5Config, ids: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """ids [B, L], mask [B, L] {0, 1} -> embeddings [B, L, dim] in the
    parameters' dtype; per-layer position bias and the padding mask as
    additive biases, float32 softmax, no attention scaling."""
    dev = params["token_embedding"].device
    ids, mask = ids.to(dev, torch.int64), mask.to(dev)
    x = params["token_embedding"][ids]
    buckets = _buckets(cfg, ids.shape[1], dev)
    pad_bias = _pad_bias(mask)
    for i in range(cfg.num_layers):
        x = _encoder_block(tree.index(params["blocks"], i), cfg, x, buckets,
                           pad_bias)
    return t5_layer_norm(x, params["norm"]["w"], cfg.eps)


def encode_for_dit(params: Params, cfg: T5Config, ids: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """The encoder output with the padding positions zeroed: the context
    the DiT takes."""
    ctx = encode(params, cfg, ids, mask)
    return ctx * (mask.to(ctx.device)[..., None] > 0)


def encode_streamed(params_host: Params, cfg: T5Config, ids: torch.Tensor,
                    mask: torch.Tensor,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """``encode_for_dit`` with the parameters kept on the host: each
    layer's weights are copied to ``device`` just before it runs and freed
    before the next layer's arrive, so the device holds one layer plus the
    activations (~0.4 GB of weights for umt5-xxl instead of ~11 GB).  The
    embedding gather runs on the host (the [vocab, dim] table never
    moves).  Pinned host tensors copy asynchronously."""
    device = torch.device(device)
    ids = ids.to("cpu", torch.int64)
    x = params_host["token_embedding"][ids].to(device)
    mask_d = mask.to(device)
    buckets = _buckets(cfg, ids.shape[1], device)
    pad_bias = _pad_bias(mask_d)
    for i in range(cfg.num_layers):
        bp = tree.map_tree(lambda t: t[i].to(device, non_blocking=True),
                           params_host["blocks"])
        x = _encoder_block(bp, cfg, x, buckets, pad_bias)
        del bp
    out = t5_layer_norm(x, params_host["norm"]["w"].to(device), cfg.eps)
    return out * (mask_d[..., None] > 0)
