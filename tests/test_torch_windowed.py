"""The port's windowed (attention sink + rolling window) streaming against
the JAX package on the CPU:

- the buffer compaction (``compact_cache``, ``evict_for``,
  ``windowed_compaction_schedule``), buffer == window included, where the
  moved rows overlap their destination;
- ``stream`` and ``inference`` of the tiny model with the JAX package's
  noise draws injected as ``eps`` (float32, tolerance 1e-4), through
  several compactions, with and without an independent first frame, and
  ``inference`` priming context frames (``prime_block``);
- a long horizon: 16 blocks through an 8-frame slack buffer (4
  compactions) against the rolled cache (buffer == window, compacted
  before each of the last 14 blocks; 2e-5) and against the JAX stream
  (1e-4), the late blocks included;
- one W8A8 + int8-QK windowed forward at dim 256 (2 heads of 128) against
  the JAX package's TPU route run interpreted.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.config import Config as JConfig
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.ops import attention as jattn
from self_forcing_tpu.ops import pallas_attention as jpa
from self_forcing_tpu.ops import pallas_matmul as jpm
from self_forcing_tpu.ops import quant as jquant
from self_forcing_tpu.pipelines.causal_inference import (
    CausalInferencePipeline as JPipe)
from self_forcing_tpu_torch.config import Config as TConfig
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY, WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.ops import quant as tquant
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline as TPipe)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: under the suite's six
    workers the default (one a core) oversubscribes the machine, and the
    idle threads' spinning slowed these tests ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
FS = (H // 2) * (W // 2)


def _jcfg(cfg: WanConfig):
    # every field but the port's tp_group (a process group; the JAX
    # package names its mesh axis instead, tp_axis)
    return dataclasses.replace(J_TINY, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "tp_group"})


# ------------------------------------------------------------ compaction

@pytest.mark.parametrize("local,sink,buffer,nb,content", [
    (12, 1, None, 3, 12),   # buffer == window: frames 4-12 move to 1-9
    (4, 1, 6, 2, 6),        # slack buffer, full
    (4, 1, 6, 2, 5),        # slack buffer, room for no block
    (3, 0, None, 1, 3),     # no sink
])
def test_compaction_matches_jax(local, sink, buffer, nb, content):
    """compact_cache, evict_for and windowed_compaction_schedule leave the
    same buffer (stale rows included) and indices as the JAX package's,
    on a cache holding ``content`` frames."""
    fs = 2
    cfg = dataclasses.replace(WAN_TINY, local_attn_size=local,
                              sink_size=sink, windowed_buffer_frames=buffer)
    jc = _jcfg(cfg)
    S = cfg.buffer_frames * fs
    rng = np.random.default_rng(content)
    k, v = (rng.standard_normal((2, 4, S, 8)).astype(np.float32)
            for _ in range(2))
    new = nb * fs
    assert tdit.windowed_compaction_schedule(cfg, fs, new) == \
        jdit.windowed_compaction_schedule(jc, fs, new)

    def jcache():
        return jdit.KVCache(jnp.asarray(k), jnp.asarray(v),
                            jnp.int32(content * fs + 40),
                            jnp.int32(content * fs), jnp.zeros((2,)))

    def tcache():
        return tdit.KVCache(torch.tensor(k), torch.tensor(v),
                            content * fs + 40, content * fs)

    for jfn, tfn in ((jdit.compact_cache, tdit.compact_cache),
                     (jdit.evict_for, tdit.evict_for)):
        jout = jfn(jc, jcache(), new)
        tout = tfn(cfg, tcache(), new)
        assert tout.local_end == int(jout.local_end)
        assert tout.global_end == int(jout.global_end)
        np.testing.assert_array_equal(tout.k.numpy(), np.asarray(jout.k))
        np.testing.assert_array_equal(tout.v.numpy(), np.asarray(jout.v))


# ------------------------------------------------------------- sampler

ARGS = {"denoising_step_list": [1000, 750, 500, 250],
        "warp_denoising_step": True, "timestep_shift": 8.0,
        "context_noise": 0}


def _pipes(seed, cfg, nb, first_frame=False):
    rng = np.random.default_rng(seed)
    jp = jdit.init_params(jax.random.PRNGKey(seed), J_TINY,
                          dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    ctx = rng.standard_normal((B, 12, cfg.text_dim)).astype(np.float32)
    args = dict(ARGS, num_frame_per_block=nb,
                independent_first_frame=first_frame)
    jpipe = JPipe(JConfig(args), jp, _jcfg(cfg))
    tpipe = TPipe(TConfig(args), params_from_jax(jp, "dit", device="cpu"),
                  cfg, device="cpu", dtype=torch.float32)
    return jpipe, tpipe, ctx, rng


def _draws(key, shape, n_steps=4):
    """JAX's per-step re-noising draws of one block (denoise_block)."""
    out = []
    for _ in range(n_steps - 1):
        key, k = jax.random.split(key)
        out.append(torch.tensor(np.asarray(jax.random.normal(
            k, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("buffer,first_frame,compactions", [
    (6, False, 2), (None, False, 4), (6, True, 2)])
def test_windowed_stream_matches_jax_with_injected_eps(
        buffer, first_frame, compactions):
    """local_attn_size 4, sink 1, 2-frame blocks, 6 blocks (an
    independent first frame makes the cadence 1, 2, 2, ...): the buffer
    of 6 frames compacts twice, buffer == window every block from the
    third."""
    nb = 2
    cfg = dataclasses.replace(WAN_TINY, local_attn_size=4, sink_size=1,
                              windowed_buffer_frames=buffer)
    jpipe, tpipe, ctx, rng = _pipes(0, cfg, nb, first_frame)
    F = 6 * nb - (1 if first_frame else 0)
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jblocks = list(jpipe.stream(noise, ctx, rng=key))
    blocks = tpipe._blocks(F)
    eps = []
    for i, (_, n) in enumerate(blocks):
        key, k1 = jax.random.split(key)
        eps.append(_draws(k1, (B, n, C, H, W)))
        if i < len(blocks) - 1:
            key, _ = jax.random.split(key)
    tblocks = list(tpipe.stream(torch.from_numpy(noise),
                                torch.from_numpy(ctx), eps=eps))
    assert tpipe.compactions == compactions
    assert len(tblocks) == len(jblocks) == 6
    for t, j in zip(tblocks, jblocks):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)
    cache = tpipe._cache
    assert tuple(cache.k.shape) == (2, 2, cfg.buffer_frames * FS, 64)


@pytest.mark.parametrize("windowed", [True, False])
def test_inference_priming_matches_jax_with_injected_eps(windowed):
    """inference() with 3 clean context frames primed into the cache (one
    independent first frame, then a 2-frame block) before 4 generated
    frames; windowed, the buffer is sized to the window whatever the
    config asks, and the forwards compact it."""
    nb = 2
    cfg = dataclasses.replace(WAN_TINY, local_attn_size=4, sink_size=1,
                              windowed_buffer_frames=6) if windowed \
        else WAN_TINY
    jpipe, tpipe, ctx, rng = _pipes(1, cfg, nb, first_frame=True)
    init = rng.standard_normal((B, 3, C, H, W)).astype(np.float32)
    noise = rng.standard_normal((B, 4, C, H, W)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    _, jlat = jpipe.inference(noise, context=ctx, initial_latent=init,
                              return_latents=True, rng=key)
    _, k = jax.random.split(key)
    eps = [_draws(kb, (B, nb, C, H, W)) for kb in jax.random.split(k, 2)]
    _, tlat = tpipe.inference(torch.from_numpy(noise), torch.from_numpy(ctx),
                              initial_latent=torch.from_numpy(init),
                              return_latents=True, eps=eps)
    assert tlat.shape == (B, 7, C, H, W)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=TOL,
                               atol=TOL)
    if windowed:
        assert tpipe._cache.k.shape[2] == 4 * FS


def test_windowed_long_horizon_matches_rolled_cache_and_jax():
    """tests/test_pipeline.py's long-horizon check for the port: a
    16-block stream (2-frame blocks, window 4, sink 1) through the 8-frame
    slack buffer compacts 4 times and must match the rolled cache (the
    reference's sizing: buffer == window, 14 compactions) on every block,
    the last four (behind every compaction) named again, within float32
    rounding (2e-5); and the JAX package's slack stream with its draws
    injected within 1e-4."""
    base = dict(dim=96, ffn_dim=192, num_heads=2, num_layers=2,
                text_dim=32, freq_dim=16, num_frame_per_block=2,
                local_attn_size=4, sink_size=1)
    cfg_roll = dataclasses.replace(WAN_TINY, **base)
    cfg_slack = dataclasses.replace(cfg_roll, windowed_buffer_frames=8)
    args = {"denoising_step_list": [1000, 500], "warp_denoising_step": False,
            "timestep_shift": 5.0, "num_frame_per_block": 2,
            "independent_first_frame": False, "context_noise": 0}
    rng = np.random.default_rng(3)
    jp = jdit.init_params(jax.random.PRNGKey(0), _jcfg(cfg_roll),
                          dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    tp = params_from_jax(jp, "dit", device="cpu")
    F = 32
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    ctx = rng.standard_normal((B, 8, 32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jblocks = list(JPipe(JConfig(args), jp, _jcfg(cfg_slack)).stream(
        noise, ctx, rng=key))
    eps = []
    for i in range(16):
        key, k1 = jax.random.split(key)
        eps.append(_draws(k1, (B, 2, C, H, W), n_steps=2))
        if i < 15:
            key, _ = jax.random.split(key)
    outs, compactions = {}, {}
    for name, cfg in (("roll", cfg_roll), ("slack", cfg_slack)):
        pipe = TPipe(TConfig(args), tp, cfg, device="cpu",
                     dtype=torch.float32)
        chunks = list(pipe.stream(torch.from_numpy(noise),
                                  torch.from_numpy(ctx), eps=eps))
        assert len(chunks) == 16
        outs[name] = torch.cat(chunks, dim=1).numpy()
        compactions[name] = pipe.compactions
        assert pipe._cache.k.shape[2] == cfg.buffer_frames * FS
    assert compactions == {"roll": 14, "slack": 4}
    np.testing.assert_allclose(outs["slack"], outs["roll"], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(outs["slack"][:, -8:], outs["roll"][:, -8:],
                               rtol=2e-5, atol=2e-5)
    jout = np.concatenate([np.asarray(b) for b in jblocks], axis=1)
    np.testing.assert_allclose(outs["slack"], jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs["slack"][:, -8:], jout[:, -8:],
                               rtol=TOL, atol=TOL)


# ------------------------------------------- W8A8 + int8-QK, windowed

WIN = WanConfig(dim=256, ffn_dim=1792, num_heads=2, num_layers=2,
                text_dim=64, freq_dim=32, num_frame_per_block=2,
                local_attn_size=4, sink_size=1, windowed_buffer_frames=6,
                attn_quant="int8qk")


@pytest.fixture
def tpu_route(monkeypatch):
    """The JAX package's TPU route, its Pallas kernels interpreted."""
    monkeypatch.setattr(jattn, "_use_pallas", lambda: True)
    monkeypatch.setattr(jquant, "_use_pallas", lambda: True)
    for mod, name in ((jpa, "cross_attention_pallas"),
                      (jpm, "quantize_rows_pallas"), (jpm, "w8a8_matmul"),
                      (jpm, "w8a8_matmul_bf16x"), (jpm, "w8a8_ffn")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))
    modes = []
    decode = jpa.decode_attention_fresh_pallas

    def decode_interpreted(*args, **kw):
        modes.append((kw.get("softmax"), kw.get("quant")))
        return decode(*args, interpret=True, **kw)

    monkeypatch.setattr(jpa, "decode_attention_fresh_pallas",
                        decode_interpreted)
    # the port's kernel path (free softmax, int8qk), run by the plain
    # versions on the CPU
    monkeypatch.setattr(tdit, "_free_softmax", lambda cfg, x: True)
    return modes


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_w8a8_int8qk_windowed_forward_matches_jax(tpu_route):
    """Three 2-frame blocks written into a 6-frame buffer, then a fourth
    run without writing: it compacts the full buffer (sink frame + the
    most recent frame kept) and attends to the sink and the window.
    Tolerance 5e-3 relative L2 on the flow (measured 1.6e-3 to 2.1e-3),
    as the W8A8 demo forward (test_torch_demo.py): an activation near a
    .5 tie of its int8 grid, q and k included now, may round to the
    other step."""
    rng = np.random.default_rng(0)
    jc = _jcfg(WIN)
    jp = jdit.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    ctx = rng.standard_normal((B, 16, WIN.text_dim)).astype(np.float32)
    xs = rng.standard_normal((4, B, 2, C, H, W)).astype(np.float32)
    t_np = np.full((B, 2), 750.0, np.float32)
    jq = jquant.quantize_dit_params(jax.tree.map(jnp.asarray, jp),
                                    min_dim=256)
    tq = tquant.quantize_dit_params(params_from_jax(jp, "dit", device="cpu"),
                                    min_dim=256)

    @functools.partial(jax.jit, static_argnames=("start", "write"))
    def jforward(params, x, ctx_kv, cache, start, write):
        return jdit.forward_inference(
            params, jc, x, jnp.asarray(t_np), ctx_kv, cache,
            jnp.int32(start), JRope.create(jc.head_dim), write_cache=write)

    jctx = jdit.precompute_context(jq, jc, jnp.asarray(ctx))
    tctx = tdit.precompute_context(tq, WIN, torch.from_numpy(ctx))
    jcache = jdit.init_kv_cache(jc, B, FS, 21, jnp.float32)
    tcache = tdit.init_kv_cache(WIN, B, FS, 21, torch.float32, "cpu")
    trope = TRope.create(WIN.head_dim, device="cpu")
    for i, x in enumerate(xs):
        write = i < 3
        jflow, jcache = jforward(jq, jnp.asarray(x), jctx, jcache, 2 * i,
                                 write)
        tflow, tcache = tdit.forward_inference(
            tq, WIN, torch.from_numpy(x), torch.from_numpy(t_np), tctx,
            tcache, 2 * i, trope, write_cache=write)
        assert tflow.shape == (B, 2, C, H, W)
        assert _rel_l2(tflow.numpy(), jflow) < 5e-3
        assert tcache.local_end == int(jcache.local_end)
        assert tcache.global_end == int(jcache.global_end)
    assert tcache.local_end == 2 * FS     # compacted: sink + one frame
    assert _rel_l2(tcache.k.numpy(), jcache.k) < 5e-3
    assert set(tpu_route) == {("free", "int8qk")}
