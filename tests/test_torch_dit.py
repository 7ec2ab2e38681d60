"""The port's DiT inference half against the JAX package on the CPU:
precompute_context and two blocks of forward_inference (write_cache True
and False) with weights crossed over by self_forcing_tpu_torch.params, on
WAN_TINY (folded head layout) and a head_dim-128 geometry (heads-packed
layout).  float32; tolerance 1e-4."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY, WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.params import params_from_jax

TOL = 1e-4
PACKED = WanConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                   text_dim=64, freq_dim=32)
B, NB, C, H, W = 1, 2, 16, 8, 8
FS = (H // 2) * (W // 2)


def _jcfg(cfg: WanConfig):
    # every field but the port's tp_group (a process group; the JAX
    # package names its mesh axis instead, tp_axis)
    return dataclasses.replace(J_TINY, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "tp_group"})


def _setup(cfg, seed):
    """JAX params with every leaf perturbed (so zero-initialised leaves
    such as the output layer take part), as numpy, and the port's copy."""
    rng = np.random.default_rng(seed)
    jp = jdit.init_params(jax.random.PRNGKey(seed), _jcfg(cfg),
                          dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    ctx = rng.standard_normal((B, 10, cfg.text_dim)).astype(np.float32)
    xs = rng.standard_normal((3, B, NB, C, H, W)).astype(np.float32)
    return jp, params_from_jax(jp, "dit", device="cpu"), ctx, xs


def _close(out_t, ref_j, tol=TOL):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_j), rtol=tol,
                               atol=tol)


@partial(jax.jit, static_argnames=("cfg", "static_kv_hi", "write_cache"))
def _jforward(params, cfg, x, t, ctx_kv, cache, start, rope,
              static_kv_hi=None, write_cache=True):
    return jdit.forward_inference(params, cfg, x, t, ctx_kv, cache, start,
                                  rope, static_kv_hi=static_kv_hi,
                                  write_cache=write_cache)


@pytest.mark.parametrize("cfg", [WAN_TINY, PACKED],
                         ids=["tiny_folded", "hd128_packed"])
def test_forward_inference_matches_jax(cfg):
    jp, tp, ctx, xs = _setup(cfg, 0)
    jc = _jcfg(cfg)
    jctx = jdit.precompute_context(jp, jc, ctx)
    tctx = tdit.precompute_context(tp, cfg, torch.from_numpy(ctx))
    for k in ("k_txt", "v_txt"):
        _close(tctx[k], jctx[k])

    jrope, trope = JRope.create(cfg.head_dim), TRope.create(cfg.head_dim,
                                                            device="cpu")
    jcache = jdit.init_kv_cache(jc, B, FS, 21, jnp.float32)
    tcache = tdit.init_kv_cache(cfg, B, FS, 21, torch.float32, "cpu")
    assert tuple(tcache.k.shape) == jcache.k.shape
    t_np = np.array([[750.0, 750.0]], np.float32)
    # block 0 written, block 1 denoised without writing, block 1 written
    for x, start, write in ((xs[0], 0, True), (xs[1], NB, False),
                            (xs[2], NB, True)):
        hint = start * FS
        jflow, jcache = _jforward(jp, jc, x, t_np, jctx, jcache,
                                  jnp.int32(start), jrope,
                                  static_kv_hi=hint, write_cache=write)
        tflow, tcache = tdit.forward_inference(
            tp, cfg, torch.from_numpy(x), torch.from_numpy(t_np), tctx,
            tcache, start, trope, static_kv_hi=hint, write_cache=write)
        assert tflow.shape == (B, NB, C, H, W)
        _close(tflow, jflow)
        assert tcache.global_end == int(jcache.global_end)
        assert tcache.local_end == int(jcache.local_end)
        _close(tcache.k, jcache.k)
        _close(tcache.v, jcache.v)
    assert tcache.global_end == 2 * NB * FS


def test_free_softmax_fold_matches_plain_path(monkeypatch):
    """The kernel path's q-gain fold with the base-2 softmax, run through
    the CPU references, equals the unfolded base-e path (head_dim 128)."""
    _, tp, ctx, xs = _setup(PACKED, 1)
    rope = TRope.create(PACKED.head_dim, device="cpu")
    tctx = tdit.precompute_context(tp, PACKED, torch.from_numpy(ctx))
    t = torch.full((B, NB), 500.0)
    flows = []
    for free in (False, True):
        monkeypatch.setattr(tdit, "_free_softmax", lambda cfg, x, f=free: f)
        cache = tdit.init_kv_cache(PACKED, B, FS, 21, torch.float32, "cpu")
        _, cache = tdit.forward_inference(tp, PACKED, torch.from_numpy(xs[0]),
                                          t, tctx, cache, 0, rope)
        flow, _ = tdit.forward_inference(tp, PACKED, torch.from_numpy(xs[1]),
                                         t, tctx, cache, NB, rope,
                                         write_cache=False)
        flows.append(flow)
    torch.testing.assert_close(flows[1], flows[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("buffer", [None, 6])
def test_windowed_cache_has_the_jax_shape(buffer):
    """A windowed config's cache is sized by its buffer (the window when
    windowed_buffer_frames is None), as the JAX package's is."""
    cfg = dataclasses.replace(WAN_TINY, local_attn_size=4, sink_size=1,
                              windowed_buffer_frames=buffer)
    tcache = tdit.init_kv_cache(cfg, 1, FS, 21, torch.float32, "cpu")
    jcache = jdit.init_kv_cache(_jcfg(cfg), 1, FS, 21, jnp.float32)
    assert tuple(tcache.k.shape) == jcache.k.shape
    assert tcache.k.shape[2] == (buffer or 4) * FS
