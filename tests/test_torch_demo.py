"""The demo configuration's W8A8 DiT forward, port on the CPU against the
JAX package, float32: ``quantize_dit_params(min_dim=256)`` on both sides
(fused qkv), dim 256 with 2 heads of 128 (the heads-packed layout), 2
layers, ffn 1792 (two 896-column hidden groups), 8x8 latents (48 tokens a
3-frame block) and 16 text tokens.  Block 0 is written to the cache, then
block 1 is run without writing (it reads block 0 from the cache).

The JAX side runs its TPU route, the Pallas W8A8 kernels interpreted
(``_use_pallas`` forced on for ops/quant.py only): its CPU route
quantizes the FFN hidden per token, a different function.  The port on
the CPU runs the kernels' plain versions, which compute the Pallas
kernels' function.

Tolerance 5e-3 relative L2 on the flow (measured 1.8e-3): the float32
glue (norms, attention) sums in another order, about 1e-5 relative, so
an activation near a .5 tie of its int8 grid may round to the other step;
each such flip moves one product term by one step, and the two layers
carry it on.  The text K/V, one quantized linear deep, agree to 1e-7."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

TOL = 5e-3
DEMO = WanConfig(dim=256, ffn_dim=1792, num_heads=2, num_layers=2,
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


def test_w8a8_forward_matches_jax(pallas_route):
    rng = np.random.default_rng(0)
    # every field but the port's tp_group (a process group; the JAX
    # package names its mesh axis instead, tp_axis)
    jc = dataclasses.replace(J_TINY, **{
        f.name: getattr(DEMO, f.name) for f in dataclasses.fields(DEMO)
        if f.name != "tp_group"})
    jp = jdit.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    ctx = rng.standard_normal((B, 16, DEMO.text_dim)).astype(np.float32)
    xs = rng.standard_normal((2, B, NB, C, H, W)).astype(np.float32)
    t_np = np.full((B, NB), 750.0, np.float32)

    jq = jquant.quantize_dit_params(jax.tree.map(jnp.asarray, jp),
                                    min_dim=256)
    tq = tquant.quantize_dit_params(params_from_jax(jp, "dit", device="cpu"),
                                    min_dim=256)
    sa = tq["blocks"]["self_attn"]
    assert "w_qa" in sa["qkv"] and "w_qa" in tq["blocks"]["ffn"]["fc1"]
    assert cm.ffn_group(NB * FS, DEMO.dim, DEMO.ffn_dim, DEMO.dim,
                        raw_x=True) == 896

    @functools.partial(jax.jit, static_argnames=("start", "write"))
    def jforward(params, x, ctx_kv, cache, start, write):
        return jdit.forward_inference(
            params, jc, x, jnp.asarray(t_np), ctx_kv, cache,
            jnp.int32(start), JRope.create(jc.head_dim),
            static_kv_hi=start * FS, write_cache=write)

    jctx = jdit.precompute_context(jq, jc, jnp.asarray(ctx))
    tctx = tdit.precompute_context(tq, DEMO, torch.from_numpy(ctx))
    for k in ("k_txt", "v_txt"):
        assert _rel_l2(tctx[k].numpy(), jctx[k]) < 1e-5
    jcache = jdit.init_kv_cache(jc, B, FS, 21, jnp.float32)
    tcache = tdit.init_kv_cache(DEMO, B, FS, 21, torch.float32, "cpu")
    trope = TRope.create(DEMO.head_dim, device="cpu")
    for x, start, write in ((xs[0], 0, True), (xs[1], NB, False)):
        jflow, jcache = jforward(jq, jnp.asarray(x), jctx, jcache, start,
                                 write)
        tflow, tcache = tdit.forward_inference(
            tq, DEMO, torch.from_numpy(x), torch.from_numpy(t_np), tctx,
            tcache, start, trope, static_kv_hi=start * FS, write_cache=write)
        assert tflow.shape == (B, NB, C, H, W)
        assert _rel_l2(tflow.numpy(), jflow) < TOL
    assert _rel_l2(tcache.k.numpy(), jcache.k) < TOL


def test_fused_qkv_split_keeps_the_attention_operands_contiguous():
    """The fused qkv product is split by slicing; q and k leave through
    new tensors (norm, RoPE) and v is copied out, so the decode kernel,
    which takes contiguous operands, gets them on CUDA."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((256, 768)).astype(np.float32))
    p = tquant.quantize_linear_params({"w": w}, "w8a8")
    x = torch.from_numpy(rng.standard_normal((1, 48, 256)).astype(np.float32))
    q, k, v = tdit._qkv_project({"qkv": p}, x)
    assert v.is_contiguous()
    torch.testing.assert_close(torch.cat([q, k, v], dim=-1),
                               tquant.quantized_linear(p, x))
