"""The Wan-14B W8A8 route at a CPU-sized width, port against the JAX
package (float32, inputs from numpy seeds).

Past one 1536-wide K tile, fc1 cannot quantize its input in its prologue:
the FFN quantizes x with ``quantize_activations`` and runs fc1 from the
int8 x in K steps (the JAX package's ``_ffn1_kernel``); past K = 4096 a
linear's ``quantize_rows`` and ``w8a8_matmul_bf16x`` decline and it takes
``quantize_activations`` into the multi-K-step ``w8a8_matmul``.  The JAX
side runs its TPU route with the Pallas W8A8 kernels interpreted
(``_use_pallas`` forced on for ops/quant.py only); the port on the CPU
runs the kernels' plain versions.  Also: the 14B tree is quantized one
layer at a time, as it is drawn, to the whole stack's values and layout.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.ops import pallas_matmul as jpm
from self_forcing_tpu.ops import quant as jquant
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.ops import cuda_matmul as cm
from self_forcing_tpu_torch.ops import quant as tquant
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.utils import tree

# dim 2048 > 1536 (fc1 from pre-quantized x), 16 heads of 128, ffn 2304
# (three 768-column hidden groups, the 14B group width)
WIDE = WanConfig(dim=2048, ffn_dim=2304, num_heads=16, num_layers=2,
                 text_dim=64, freq_dim=32, num_frame_per_block=3)
B, NB, C, H, W = 1, 3, 16, 8, 8
FS = (H // 2) * (W // 2)


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setattr(jquant, "_use_pallas", lambda: True)
    for name in ("quantize_rows_pallas", "w8a8_matmul", "w8a8_matmul_bf16x",
                 "w8a8_ffn"):
        monkeypatch.setattr(jpm, name, functools.partial(
            getattr(jpm, name), interpret=True))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _quantized_pair(rng, d_in, d_out, scale):
    w = (rng.standard_normal((d_in, d_out)) * scale).astype(np.float32)
    b = (rng.standard_normal(d_out) * 0.1).astype(np.float32)
    return (jquant.quantize_linear_params({"w": jnp.asarray(w),
                                           "b": jnp.asarray(b)}),
            tquant.quantize_linear_params({"w": torch.from_numpy(w),
                                           "b": torch.from_numpy(b)}))


def _jax_ffn1_xq(x_q, s_x, w1, ws, b, tg, tk):
    """The JAX package's ``_ffn1_kernel`` run alone, interpreted."""
    M, K = x_q.shape
    Hh = w1.shape[1]
    nk = K // tk
    return pl.pallas_call(
        functools.partial(jpm._ffn1_kernel, nk=nk),
        grid=(M // 8, Hh // tg, nk),
        in_specs=[pl.BlockSpec((8, tk), lambda i, j, k: (i, k)),
                  pl.BlockSpec((8, 1), lambda i, j, k: (i, 0)),
                  pl.BlockSpec((tk, tg), lambda i, j, k: (k, j)),
                  pl.BlockSpec((1, tg), lambda i, j, k: (0, j)),
                  pl.BlockSpec((1, tg), lambda i, j, k: (0, j))],
        out_specs=[pl.BlockSpec((8, tg), lambda i, j, k: (i, j)),
                   pl.BlockSpec((8, 128), lambda i, j, k: (i, j))],
        out_shape=[jax.ShapeDtypeStruct((M, Hh), jnp.int8),
                   jax.ShapeDtypeStruct((M, (Hh // tg) * 128), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((8, tg), jnp.int32)],
        interpret=True,
    )(x_q, s_x, w1, ws.reshape(1, Hh), b.reshape(1, Hh))


@pytest.mark.parametrize("M,K,Hh,N", [(48, 2048, 2304, 512),
                                      (40, 5120, 1536, 640)])
def test_ffn_from_prequantized_x_matches_pallas(M, K, Hh, N):
    """fc1 from int8 x and its per-token scales (``w8a8_ffn1_ref`` with
    ``s_x``) against the interpreted ``_ffn1_kernel`` at K 2048 and at the
    14B tiles (K 5120 in four 1280-wide steps, 768-column groups), then
    the whole FFN.  The int32 sums over the K steps are exact on both
    sides.  The int8 hidden is equal; a group scale may differ by an ulp
    (XLA evaluates the f32 epilogue and gelu's tanh in another order: 30-40%
    of the scales here), so 1e-6 relative; the FFN output to 1e-3
    relative L2."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[3] = 0.0
    (j1, t1), (j2, t2) = (_quantized_pair(rng, K, Hh, 0.03),
                          _quantized_pair(rng, Hh, N, 0.03))
    assert cm.ffn_group(M, K, Hh, N, raw_x=True) is None
    tg = cm.ffn_group(M, K, Hh, N, raw_x=False)
    assert tg == 768
    jxq, jsx = jquant.quantize_activations(jnp.asarray(x))
    txq, tsx = tquant.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))

    tk = jpm._pick_tile(K, 128, 1536)
    jhq, jhs = (np.asarray(a) for a in jax.jit(functools.partial(
        _jax_ffn1_xq, tg=tg, tk=tk))(jxq, jsx, j1["w_qa"], j1["w_scale"],
                                     j1["b"]))
    hq, hs = cm.w8a8_ffn1_ref(txq, tsx, t1["w_qa_t"], t1["w_scale"],
                              t1["b"], tg)
    np.testing.assert_array_equal(hq.numpy(), jhq)
    np.testing.assert_allclose(hs.numpy(), jhs[:, ::128], rtol=1e-6, atol=0)

    jy = jpm.w8a8_ffn(jxq, jsx, j1["w_qa"], j1["w_scale"], j1["b"],
                      j2["w_qa"], j2["w_scale"], j2["b"],
                      out_dtype=jnp.float32, interpret=True)
    ty = cm.w8a8_ffn_ref(txq, tsx, t1["w_qa_t"], t1["w_scale"], t1["b"],
                         t2["w_qa_t"], t2["w_scale"], t2["b"],
                         out_dtype=torch.float32)
    assert _rel_l2(ty.numpy(), jy) < 1e-3


def test_linear_past_4096_takes_the_quantize_activations_route(
        pallas_route, monkeypatch):
    """K 4224: ``quantize_rows`` and the bf16x GEMM decline on both sides,
    then per-token quantization feeds the 3-K-step ``w8a8_matmul`` (exact
    int32 sums, equal scales: 1e-5 relative L2)."""
    rng = np.random.default_rng(22)
    K, N = 4224, 384
    x = rng.standard_normal((2, 24, K)).astype(np.float32)
    jl, tl = _quantized_pair(rng, K, N, 0.02)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            calls.append((name, out is None))
            return out
        return wrapped

    for name in ("quantize_rows", "w8a8_matmul_bf16x", "w8a8_matmul"):
        monkeypatch.setattr(cm, name, spy(name, getattr(cm, name)))
    monkeypatch.setattr(tquant, "quantize_activations", spy(
        "quantize_activations", tquant.quantize_activations))
    ty = tquant.quantized_linear(tl, torch.from_numpy(x))
    jy = jquant.quantized_linear(jl, jnp.asarray(x))
    assert calls == [("quantize_rows", True), ("w8a8_matmul_bf16x", True),
                     ("quantize_activations", False),
                     ("w8a8_matmul", False)]
    assert cm.matmul_tiling(48, K, N)
    assert _rel_l2(ty.numpy(), jy) < 1e-5


def _whole_stack(params, min_dim):
    """The whole-stack quantization: every selected stacked linear
    quantized along its axis 1 in one call (fused qkv first)."""
    blocks = dict(params["blocks"])
    blocks["self_attn"] = tquant._fuse_qkv(blocks["self_attn"])

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() >= 2 and \
                    w.shape[-2] >= min_dim and w.shape[-1] >= min_dim:
                return tquant.quantize_linear_params(node, "w8a8")
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(blocks)


def test_per_layer_quantization_equals_the_whole_stack():
    """``quantize_dit_params`` quantizes layer by layer and
    ``init_params(block_fn=quantize_block)`` quantizes each block as it is
    drawn: both give the whole stack's keys, values, dtypes and strides,
    from the same random stream; ``w_qa`` is a transposed view of
    ``w_qa_t`` (one int8 copy)."""
    cfg = dataclasses.replace(WIDE, dim=256, ffn_dim=768, num_heads=2,
                              num_layers=3)
    p = tdit.init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    whole = _whole_stack(p, 256)
    per_layer = tquant.quantize_dit_params(p, min_dim=256)["blocks"]
    drawn = tdit.init_params(
        cfg, seed=5, dtype=torch.float32, device="cpu",
        block_fn=functools.partial(tquant.quantize_block, num_layers=3,
                                   min_dim=256))
    ref = dict(tree.items(whole))
    for got in (dict(tree.items(per_layer)),
                dict(tree.items(drawn["blocks"]))):
        assert got.keys() == ref.keys()
        for k, v in got.items():
            assert v.dtype == ref[k].dtype and v.stride() == ref[k].stride()
            assert torch.equal(v, ref[k]), k
    for k, v in tree.items(drawn):
        if k[0] != "blocks":
            assert torch.equal(v, dict(tree.items(p))[k]), k
    fc1 = drawn["blocks"]["ffn"]["fc1"]
    assert fc1["w_qa_t"].is_contiguous()
    assert fc1["w_qa"].data_ptr() == fc1["w_qa_t"].data_ptr()
    assert torch.equal(fc1["w_qa"], fc1["w_qa_t"].transpose(-1, -2))


def test_wide_w8a8_forward_matches_jax(pallas_route, monkeypatch):
    """A 2-layer W8A8 forward at dim 2048 (block 0 written to the cache,
    block 1 read against it): the FFN runs fc1 from pre-quantized x on
    both sides.  The text K/V, one quantized linear deep, agree to 1e-6.
    Tolerance on the flow 5e-3 relative L2, as the 1.3B-layout demo
    forward's (tests/test_torch_demo.py; measured 2.7e-3 here): the float32
    glue (norms, attention, gelu) rounds in another order, about 1e-6
    relative, so an activation within that of a .5 tie of its int8 grid
    rounds to the other step, and each flip moves a product term by one
    step through the two layers.  The test shows that floor: a 1e-6
    relative perturbation of the port's own input moves its flow by more
    than 1e-4 (3.8e-3 measured).  Below the tie noise, each block-1 FFN is
    held at its own grain: its input captured from the port's forward
    goes through both packages' FFN (JAX's interpreted ``_ffn1_kernel``
    route), to 1e-6 relative L2 (9e-8 measured)."""
    ffn_inputs = []
    ffn = tquant.quantized_ffn

    def spy(p1, p2, x, kernels=True):
        ffn_inputs.append((p1, p2, x.detach().clone()))
        return ffn(p1, p2, x, kernels)

    monkeypatch.setattr(tquant, "quantized_ffn", spy)
    rng = np.random.default_rng(23)
    # every field but the port's tp_group (a process group; the JAX
    # package names its mesh axis instead, tp_axis)
    jc = dataclasses.replace(J_TINY, **{
        f.name: getattr(WIDE, f.name) for f in dataclasses.fields(WIDE)
        if f.name != "tp_group"})
    jp = jdit.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    ctx = rng.standard_normal((B, 16, WIDE.text_dim)).astype(np.float32)
    xs = rng.standard_normal((2, B, NB, C, H, W)).astype(np.float32)
    t_np = np.full((B, NB), 750.0, np.float32)
    jq = jquant.quantize_dit_params(jax.tree.map(jnp.asarray, jp),
                                    min_dim=256)
    tq = tquant.quantize_dit_params(params_from_jax(jp, "dit", device="cpu"),
                                    min_dim=256)
    assert cm.ffn_group(NB * FS, WIDE.dim, WIDE.ffn_dim, WIDE.dim,
                        raw_x=True) is None

    @functools.partial(jax.jit, static_argnames=("start", "write"))
    def jforward(params, x, ctx_kv, cache, start, write):
        return jdit.forward_inference(
            params, jc, x, jnp.asarray(t_np), ctx_kv, cache,
            jnp.int32(start), JRope.create(jc.head_dim),
            static_kv_hi=start * FS, write_cache=write)

    jctx = jdit.precompute_context(jq, jc, jnp.asarray(ctx))
    tctx = tdit.precompute_context(tq, WIDE, torch.from_numpy(ctx))
    for k in ("k_txt", "v_txt"):
        assert _rel_l2(tctx[k].numpy(), jctx[k]) < 1e-6
    jcache = jdit.init_kv_cache(jc, B, FS, 21, jnp.float32)
    tcache = tdit.init_kv_cache(WIDE, B, FS, 21, torch.float32, "cpu")
    trope = TRope.create(WIDE.head_dim, device="cpu")
    errs = []
    for x, start, write in ((xs[0], 0, True), (xs[1], NB, False)):
        jflow, jcache = jforward(jq, jnp.asarray(x), jctx, jcache, start,
                                 write)
        tflow, tcache = tdit.forward_inference(
            tq, WIDE, torch.from_numpy(x), torch.from_numpy(t_np), tctx,
            tcache, start, trope, static_kv_hi=start * FS, write_cache=write)
        assert tflow.shape == (B, NB, C, H, W)
        errs.append(_rel_l2(tflow.numpy(), jflow))
    assert max(errs) < 5e-3, errs

    # the tie floor: block 1 again from an input 1e-6 relative away
    x1 = xs[1] * (1 + 1e-6 * rng.standard_normal(xs[1].shape)
                  ).astype(np.float32)
    tflow1, _ = tdit.forward_inference(
        tq, WIDE, torch.from_numpy(x1), torch.from_numpy(t_np), tctx,
        tcache, NB, trope, static_kv_hi=NB * FS, write_cache=False)
    assert _rel_l2(tflow1.numpy(), tflow.numpy()) > 1e-4

    # each layer's FFN of block 1 on the forward's own activations
    block1 = ffn_inputs[WIDE.num_layers:2 * WIDE.num_layers]
    assert len(block1) == WIDE.num_layers
    for p1, p2, x in block1:
        j1, j2 = (jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                               {k: v for k, v in p.items() if k != "w_qa_t"})
                  for p in (p1, p2))
        jy = jquant.quantized_ffn(j1, j2, jnp.asarray(x.numpy()))
        ty = ffn(p1, p2, x)
        assert _rel_l2(ty.numpy(), jy) < 1e-6
