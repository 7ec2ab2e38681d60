"""The port's bounded and online attention softmax and its full-int8 decode
attention against the JAX package on the CPU.

- The CUDA kernels' plain versions (``ops/cuda_attention.py``) against the
  Pallas kernels they replace, run with ``interpret=True`` at the sizes of
  ``tests/test_pallas_attention.py`` (2 heads of 128, 96 queries, 256-320
  cached keys): ``decode_fresh_ref`` in 'bounded' (bound slack 0 and 5
  nats), online and 'free_noclamp' modes; ``decode_fresh_int8_ref`` in
  'tile' (slack 0.5 / 11 / 40 nats and an empty window), 'global' (a
  tight bound) and online modes; the seam's packed layout with a stacked
  cache and its folded layout; ``flash_fwd_ref`` online and bounded, and
  the flash gradients of both modes.
- The DiT on the kernel route (``ops/attention._kernel_route`` forced on
  the CPU, so the plain versions run through the same dispatch) against
  the JAX package on its TPU route with the Pallas kernels interpreted:
  ``_block_decode_fresh`` under 'bounded', 'online' and
  ``attn_quant='int8'``; a two-block global stream whose ``KVCache.kmax``
  equals JAX's after each refresh and after a reset; a windowed forward
  under 'bounded' (which runs the online kernels); ``forward_train``
  values and gradients under 'bounded' and 'online'.

Inputs come from numpy seeds and run in float32.  Each test states its
tolerance.
"""
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
from self_forcing_tpu.ops import attention as jattn
from self_forcing_tpu.ops import masks as jmasks
from self_forcing_tpu.ops import pallas_attention as jpa
from self_forcing_tpu.pipelines import causal_inference as jci
from self_forcing_tpu.scheduler import FlowMatchScheduler as JSched
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.ops import attention as tattn
from self_forcing_tpu_torch.ops import cuda_attention as ca
from self_forcing_tpu_torch.ops import masks as tmasks
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.pipelines import causal_inference as tci
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler as TSched


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: under the suite's six
    workers the default (one a core) oversubscribes the machine, and the
    idle threads' spinning slowed these tests ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N, D, LQ = 2, 128, 96
SCALE = D ** -0.5
LOG2E = 1.4426950408889634


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _decode_inputs(seed, S, layers=2):
    """Heads-packed q / k_new / v_new [1, 96, N*D], stacked cache
    [layers, N, S, D]."""
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.standard_normal((1, LQ, N * D)).astype(np.float32)
                 for _ in range(3))
    kc, vc = (rng.standard_normal((layers, N, S, D)).astype(np.float32)
              for _ in range(2))
    return q, kc, vc, kn, vn


def _scores(q, kc, kn, li, lo, hi, sink=0):
    """The visible scores [N, Lq, keys] at SCALE."""
    qh = q.reshape(LQ, N, D).transpose(1, 0, 2)
    keys = np.concatenate([kc[li][:, :sink], kc[li][:, lo:hi],
                           kn.reshape(LQ, N, D).transpose(1, 0, 2)], axis=1)
    return np.einsum("nld,nsd->nls", qh, keys) * SCALE, qh, keys


def _cs_bound(q, kc, kn, li, lo, hi, sink=0):
    """The DiT's Cauchy-Schwarz bound over the visible keys."""
    _, qh, keys = _scores(q, kc, kn, li, lo, hi, sink)
    return SCALE * np.linalg.norm(qh, axis=-1).max() * np.linalg.norm(
        keys, axis=-1).max()


def _pallas(q, kc, vc, kn, vn, lo, hi, li, **kw):
    return np.asarray(jpa.decode_attention_fresh_pallas(
        q, kc, vc, kn, vn, jnp.int32(lo), jnp.int32(hi), tq=32, tk=64,
        interpret=True, layer_idx=jnp.int32(li), heads_packed=N, **kw))


# ------------------------------------------------ bf16 decode, plain vs Pallas

@pytest.mark.parametrize("lo,hi,slack", [(0, 192, 0.0), (64, 320, 5.0),
                                         (0, 0, 5.0)])
def test_decode_bounded_ref_matches_pallas(lo, hi, slack):
    """'bounded' at the Cauchy-Schwarz bound plus 0 or 5 nats: 5e-3 (the
    JAX tests' tolerance; both round p to bf16, which may round either way
    for scores summed in another order; measured ~1e-4)."""
    q, kc, vc, kn, vn = _decode_inputs(20, 320)
    m0 = np.float32(_cs_bound(q, kc, kn, 1, lo, hi) + slack)
    ref = _pallas(q, kc, vc, kn, vn, lo, hi, 1, fixed_m0=m0)
    out = ca.decode_fresh_ref(*_t(q, kc, vc, kn, vn), mode="bounded",
                              m0=torch.tensor(m0), layer_idx=1, kv_start=lo,
                              kv_end=hi, num_heads=N, scale=SCALE)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("lo,hi,sink", [(32, 200, 0), (128, 256, 32)])
def test_decode_online_ref_matches_pallas(lo, hi, sink):
    """Online (running max; both keep p in float32): 1e-4."""
    q, kc, vc, kn, vn = _decode_inputs(21, 256)
    ref = _pallas(q, kc, vc, kn, vn, lo, hi, 0, sink_end=jnp.int32(sink))
    out = ca.decode_fresh_ref(*_t(q, kc, vc, kn, vn), mode="online",
                              layer_idx=0, kv_start=lo, kv_end=hi,
                              sink_end=sink, num_heads=N, scale=SCALE)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_decode_free_noclamp_ref_matches_pallas():
    """'free_noclamp' (q carries head_dim**-0.5 * log2(e), scale 1):
    5e-3, as the free mode (p rounded to bf16 in both)."""
    q, kc, vc, kn, vn = _decode_inputs(22, 256)
    q = q * np.float32(SCALE * LOG2E)
    ref = _pallas(q, kc, vc, kn, vn, 0, 160, 1, scale=1.0,
                  softmax="free_noclamp")
    out = ca.decode_fresh_ref(*_t(q, kc, vc, kn, vn), mode="free_noclamp",
                              layer_idx=1, kv_start=0, kv_end=160,
                              num_heads=N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-3, atol=5e-3)


# ------------------------------------------------ int8 decode, plain vs Pallas

INT8_CASES = {
    "tile_slack_0.5": ("tile", 32, 200, 0.5),
    "tile_slack_11": ("tile", 32, 200, 11.0),
    "tile_slack_40": ("tile", 32, 200, 40.0),
    "tile_empty_window": ("tile", 0, 0, 20.0),
    "global_tight": ("global", 32, 200, 0.5),
    "online": ("online", 32, 200, None),
}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_decode_int8_ref_matches_pallas(case):
    """quant='int8' (tiles 32 / 64 / 64 from decode_tiles at Lq 96, S 256):
    output relative L2 <= 1e-3 against the interpreted Pallas kernel
    (measured ~1e-7: the same int8 p and scales; the bound is the max
    score plus the slack, as tests/test_pallas_attention.py sets it).
    The scales equal a jnp transcription of the Pallas kernel's
    quantization exactly, and the error against the exact softmax stays
    at the JAX tests' int8 bounds."""
    mode, lo, hi, slack = INT8_CASES[case]
    q, kc, vc, kn, vn = _decode_inputs(30, 256)
    s, _, _ = _scores(q, kc, kn, 1, 32, 200)
    kw = {}
    m0 = None
    if slack is not None:
        m0 = np.float32(s.max() + slack)
        kw = dict(fixed_m0=m0, int8_bound=mode)
    ref = _pallas(q, kc, vc, kn, vn, lo, hi, 1, quant="int8", **kw)
    tq, tk, tf = tattn.decode_tiles(LQ, 256, LQ, "int8", None, tq=32, tk=64)
    args = dict(layer_idx=1, kv_start=lo, kv_end=hi, num_heads=N, tq=tq,
                tk=tk, tf=tf)
    tin = _t(q, kc, vc, kn, vn)
    out = ca.decode_fresh_int8_ref(
        *tin, mode=mode, m0=None if m0 is None else torch.tensor(m0),
        scale=SCALE, **args)
    assert _rel_l2(out.numpy(), ref) <= 1e-3, _rel_l2(out.numpy(), ref)
    # the scales: max(max|q| over the tile, 1e-8) / 127 per (head, tq
    # rows); max(max|x| / 127, 1e-8) per tk / tf rows of K and V
    qq = ca.int8qk_quantize_ref(tin[0], tin[1], tin[3], **args)
    vv = ca.int8_quantize_v_ref(tin[2], tin[4], **{
        k: v for k, v in args.items() if k != "tq"})
    qf = jnp.asarray(q.reshape(LQ, N, D).transpose(1, 0, 2))
    qs = jnp.stack([jnp.maximum(jnp.max(jnp.abs(qf[:, i:i + tq]),
                                        axis=(1, 2)), 1e-8) / 127.0
                    for i in range(0, LQ, tq)], axis=1)
    np.testing.assert_array_equal(qq.qs.numpy(), np.asarray(qs))
    vf = jnp.asarray(vn.reshape(LQ, N, D).transpose(1, 0, 2))
    vs = jnp.stack([jnp.maximum(jnp.max(jnp.abs(vf[:, i:i + tf]),
                                        axis=(1, 2)) / 127.0, 1e-8)
                    for i in range(0, LQ, tf)], axis=1)
    np.testing.assert_array_equal(vv.vsf.numpy(), np.asarray(vs))
    exact = jattn.decode_attention_fresh_xla(
        *(jnp.asarray(a.reshape(1, -1, N, D)) for a in (q,)),
        jnp.asarray(kc[1].transpose(1, 0, 2)[None]),
        jnp.asarray(vc[1].transpose(1, 0, 2)[None]),
        jnp.asarray(kn.reshape(1, LQ, N, D)),
        jnp.asarray(vn.reshape(1, LQ, N, D)), jnp.int32(lo), jnp.int32(hi))
    d = np.abs(out.numpy().reshape(1, LQ, N, D) - np.asarray(exact))
    bound = 0.10 if mode == "global" else 0.05
    assert d.max() < bound * max(np.abs(np.asarray(exact)).max(), 1.0)


def test_int8_v_layout_round_trips():
    """The K-major V^T tiles hold every key of a 16-key group once, in
    the P fragment's order, padded with zeros to 64 keys."""
    rng = np.random.default_rng(31)
    v8 = torch.from_numpy(rng.integers(-127, 128, (2, 3 * 40, D),
                                       dtype=np.int8))
    vt = ca._kmajor(v8, 3, 40)
    assert vt.shape == (2, 3, D, 64)
    assert sorted(ca.KEY_OF_SLOT) == list(range(16))
    torch.testing.assert_close(ca._rows(vt, 40), v8, rtol=0, atol=0)
    assert int(vt.reshape(2, 3, D, 4, 16)[:, :, :, 3].abs().sum()) == 0


# ----------------------------------------------- the seam, packed and folded

@pytest.mark.parametrize("folded", [False, True])
def test_seam_bounded_layouts_match_pallas(folded, monkeypatch):
    """The seam on the kernel route (forced on the CPU) in the bounded
    mode with a stacked cache, heads-packed and folded, against the
    Pallas kernel with the same layout and the per-layer bound: 5e-3."""
    monkeypatch.setattr(tattn, "_kernel_route", lambda t: True)
    q, kc, vc, kn, vn = _decode_inputs(23, 256)
    for li in range(2):
        m0 = np.float32(_cs_bound(q, kc, kn, li, 0, 192))
        if folded:
            fold = lambda a: a.reshape(1, LQ, N, D).transpose(0, 2, 1, 3) \
                .reshape(N, LQ, D)
            qa, kna, vna, heads = fold(q), fold(kn), fold(vn), None
        else:
            qa, kna, vna, heads = q, kn, vn, N
        ref = jpa.decode_attention_fresh_pallas(
            qa, kc, vc, kna, vna, jnp.int32(0), jnp.int32(192), tq=32,
            tk=64, interpret=True, layer_idx=jnp.int32(li),
            heads_packed=heads, fixed_m0=m0)
        out = tattn.decode_attention_fresh(
            *_t(qa, kc, vc, kna, vna), 0, 192, layer_idx=li,
            heads_packed=heads, fixed_m0=torch.tensor(m0))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-3,
                                   atol=5e-3)


# ------------------------------------------------- flash, plain vs Pallas

@pytest.mark.parametrize("mode", ["online", "bounded"])
def test_flash_modes_match_pallas(mode):
    """flash_fwd_ref against the interpreted ``_flash_kernel`` (block-causal
    mask, 4 frames of 64): out and lse 1e-4 online (float32 p in both),
    5e-3 bounded (p rounded to bf16 in both; the JAX tests' tolerance);
    dq, dk, dv through the seam's autograd function against jax.grad of
    the interpreted op: 2e-4 (the backward recomputes p in float32 from
    lse in both)."""
    jm = jmasks.block_causal_mask(4, 64, num_frame_per_block=2)
    tm = tmasks.block_causal_mask(4, 64, num_frame_per_block=2)
    rng = np.random.default_rng(40)
    q, k, v = (rng.standard_normal((1, 256, N, D)).astype(np.float32)
               for _ in range(3))
    m0 = None
    tol = 1e-4
    if mode == "bounded":
        m0 = np.float32(SCALE * np.linalg.norm(q, axis=-1).max()
                        * np.linalg.norm(k, axis=-1).max())
        tol = 5e-3
    s1, e1, s2, e2 = (np.asarray(a)[:256] for a in (
        jm.start1, jm.end1, jm.start2, jm.end2))
    jout, jlse = jpa._flash_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), s1, e1, s2, e2, SCALE, 128,
        128, True, m0=m0, bounded=m0 is not None)
    tm0 = None if m0 is None else torch.tensor(m0)
    out, lse = ca.flash_fwd_ref(*_t(q, k, v), tm, mode, SCALE, tm0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(lse.reshape(N, 256).numpy(),
                               np.asarray(jlse)[:, :256], rtol=1e-4,
                               atol=1e-4)

    def jloss(a, b, c):
        return jnp.sum(jpa.flash_attention_pallas(
            a, b, c, jm, tq=128, tk=128, interpret=True, fixed_m0=m0) ** 2)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq_, tk_, tv_ = (x.requires_grad_(True) for x in _t(q, k, v))
    o = tattn.FlashAttention.apply(tq_, tk_, tv_, tm, SCALE, mode, tm0,
                                   True)
    (o ** 2).sum().backward()
    for a, b in zip((tq_.grad, tk_.grad, tv_.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4 if mode == "online" else 2e-2)


# --------------------------------------------------------- the DiT modules

PACKED = WanConfig(dim=256, ffn_dim=256, num_heads=2, num_layers=2,
                   text_dim=64, freq_dim=32, num_frame_per_block=2)
B, NB, C, H, W = 1, 2, 16, 8, 8
FS = (H // 2) * (W // 2)


def _jcfg(cfg: WanConfig):
    # every field but the port's tp_group (a process group; the JAX
    # package names its mesh axis instead, tp_axis)
    return dataclasses.replace(J_TINY, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "tp_group"})


@pytest.fixture
def routes(monkeypatch):
    """The JAX package's TPU route with its Pallas attention interpreted,
    and the port's kernel route forced on the CPU (the plain versions).
    Returns the JAX decode calls' (softmax, quant, bounded) modes."""
    monkeypatch.setattr(jattn, "_use_pallas", lambda: True)
    modes = []
    decode = jpa.decode_attention_fresh_pallas

    def decode_interpreted(*args, **kw):
        modes.append((kw.get("softmax"), kw.get("quant"),
                      kw.get("fixed_m0") is not None))
        return decode(*args, interpret=True, **kw)

    monkeypatch.setattr(jpa, "decode_attention_fresh_pallas",
                        decode_interpreted)
    for name in ("cross_attention_pallas", "flash_attention_pallas"):
        monkeypatch.setattr(jpa, name, functools.partial(
            getattr(jpa, name), interpret=True))
    monkeypatch.setattr(tattn, "_kernel_route", lambda t: True)
    return modes


def _setup(cfg, seed):
    rng = np.random.default_rng(seed)
    jp = jdit.init_params(jax.random.PRNGKey(seed), _jcfg(cfg),
                          dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    ctx = rng.standard_normal((B, 10, cfg.text_dim)).astype(np.float32)
    xs = rng.standard_normal((3, B, NB, C, H, W)).astype(np.float32)
    return jp, params_from_jax(jp, "dit", device="cpu"), ctx, xs, rng


@pytest.mark.parametrize("softmax,quant", [("bounded", None),
                                           ("online", None),
                                           ("free", "int8")])
def test_block_decode_fresh_modes_match_jax(softmax, quant, routes):
    """One layer of ``_block_decode_fresh`` over a random cache (window
    [0, 2 frames) of 4, kmax the cached rows' norm bound): the block's
    output, its fresh K/V and the fresh K's norm.  'free' with
    attn_quant='int8' runs the tile-bounded int8 kernel.  Tolerance 1e-4
    (float32; bounded rounds p to bf16 in both, int8 rounds p to the
    same int8; measured <= 3e-6); kn_norm 1e-6 relative."""
    cfg = dataclasses.replace(PACKED, attn_softmax=softmax, attn_quant=quant)
    jc = _jcfg(cfg)
    jp, tp, ctx, xs, rng = _setup(cfg, 3)
    S = 4 * FS
    kc, vc = (rng.standard_normal((2, B * N, S, D)).astype(np.float32)
              for _ in range(2))
    kmax = np.linalg.norm(kc[:, :, :2 * FS], axis=-1).max(axis=(1, 2))
    t = np.full((B, NB), 500.0, np.float32)
    jtok, (Fb, h, w) = jdit.patchify(jp, jc, jnp.asarray(xs[0]))
    _, je0 = jdit.time_embed(jp, jc, jnp.asarray(t), jtok.dtype)
    jcos, jsin = JRope.create(D).angles_for_grid(Fb, h, w, 2)
    jctx = jdit.precompute_context(jp, jc, jnp.asarray(ctx))
    jout = jdit._block_decode_fresh(
        jax.tree.map(lambda a: a[1], jp["blocks"]), jc, jtok, je0, jcos,
        jsin, jnp.asarray(kc), jnp.asarray(vc), jnp.int32(0),
        jnp.int32(2 * FS), {"k_txt": jctx["k_txt"][1],
                            "v_txt": jctx["v_txt"][1]}, FS, 2 * FS,
        layer_idx=jnp.int32(1), kmax_layer=jnp.asarray(kmax[1]))

    ttok, _ = tdit.patchify(tp, cfg, torch.from_numpy(xs[0]))
    _, te0 = tdit.time_embed(tp, cfg, torch.from_numpy(t), ttok.dtype)
    tcos, tsin = TRope.create(D, device="cpu").angles_for_grid(Fb, h, w, 2)
    tctx = tdit.precompute_context(tp, cfg, torch.from_numpy(ctx))
    tout = tdit._block_decode_fresh(
        tdit.split_layers(tp["blocks"])[1], cfg, ttok, te0, tcos, tsin,
        *_t(kc, vc), 0, 2 * FS, {"k_txt": tctx["k_txt"][1],
                                 "v_txt": tctx["v_txt"][1]}, FS, 2 * FS,
        layer_idx=1, kmax_layer=torch.tensor(kmax[1]))
    for a, b in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    if softmax == "online":
        assert tout[3] is None and jout[3] is None
    else:
        np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                                   rtol=1e-6)
    want = {("bounded", None): (None, None, True),
            ("online", None): (None, None, False),
            ("free", "int8"): (None, "int8", True)}[(softmax, quant)]
    assert routes == [want]


def test_bounded_stream_kmax_matches_jax(routes):
    """Two 2-frame blocks of the global sampler under 'bounded'
    (denoise_block in 2 steps, then refresh_block; the re-noising draw is
    JAX's): the denoised blocks within 1e-4.  After each refresh
    ``KVCache.kmax`` equals, per layer, the max row norm of the K rows
    cached so far exactly (the incremental update), and JAX's kmax within
    1e-5 relative (the fresh K carries the forward's float32 rounding:
    2.5e-6 measured on layer 1); zero before the first refresh and after
    a reset."""
    cfg = dataclasses.replace(PACKED, attn_softmax="bounded")
    jc = _jcfg(cfg)
    jp, tp, ctx, xs, rng = _setup(cfg, 4)
    steps = (1000.0, 500.0)
    jsched = JSched.create(shift=5.0)
    tsched = TSched.create(shift=5.0, device="cpu")
    jrope, trope = JRope.create(D), TRope.create(D, device="cpu")
    jctx = jdit.precompute_context(jp, jc, jnp.asarray(ctx))
    tctx = tdit.precompute_context(tp, cfg, torch.from_numpy(ctx))
    jcache = jdit.init_kv_cache(jc, B, FS, 4, jnp.float32)
    tcache = tdit.init_kv_cache(cfg, B, FS, 4, torch.float32, "cpu")
    assert not tcache.kmax.any()
    key = jax.random.PRNGKey(9)
    for blk in range(2):
        start = blk * NB
        key, k = jax.random.split(key)
        jx0, jcache = jci.denoise_block(jp, jc, jsched, jrope, jctx, jcache,
                                        jnp.asarray(xs[blk]), k, steps,
                                        jnp.int32(start), static_kv_hi=start
                                        * FS)
        eps, kk = [], k
        for _ in range(len(steps) - 1):
            kk, k2 = jax.random.split(kk)
            eps.append(torch.from_numpy(np.array(jax.random.normal(
                k2, xs[blk].shape, jnp.float32))))
        tx0, tcache = tci.denoise_block(tp, cfg, tsched, trope, tctx, tcache,
                                        torch.from_numpy(xs[blk]), steps,
                                        start, static_kv_hi=start * FS,
                                        eps=eps)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-4,
                                   atol=1e-4)
        jcache = jci.refresh_block(jp, jc, jrope, jctx, jcache, jx0, k, 0.0,
                                   jnp.int32(start), static_kv_hi=start * FS)
        tcache = tci.refresh_block(tp, cfg, trope, tctx, tcache, tx0, 0.0,
                                   start, static_kv_hi=start * FS)
        cached = tcache.k[:, :, :tcache.local_end]
        torch.testing.assert_close(
            tcache.kmax, torch.stack([tdit._max_row_norm(c, None)
                                      for c in cached]), rtol=0, atol=0)
        np.testing.assert_allclose(tcache.kmax.numpy(),
                                   np.asarray(jcache.kmax), rtol=1e-5)
    tcache = tdit.reset_kv_cache(tcache)
    jcache = jdit.reset_kv_cache(jcache)
    np.testing.assert_array_equal(tcache.kmax.numpy(), np.asarray(jcache.kmax))
    assert not tcache.kmax.any() and tcache.local_end == 0
    assert set(routes) == {(None, None, True)}


def test_windowed_bounded_forward_runs_online(routes):
    """A windowed cache (sink 1, window 4, buffer 6 frames) under
    'bounded': the windowed branch passes no kmax, so JAX runs the online
    decode kernel and the port its online plain version; three written
    blocks and one that compacts, flows within 1e-4, kmax untouched."""
    cfg = dataclasses.replace(PACKED, attn_softmax="bounded",
                              local_attn_size=4, sink_size=1,
                              windowed_buffer_frames=6)
    jc = _jcfg(cfg)
    jp, tp, ctx, _, rng = _setup(cfg, 5)
    xs = rng.standard_normal((4, B, NB, C, H, W)).astype(np.float32)
    t = np.full((B, NB), 750.0, np.float32)
    jrope, trope = JRope.create(D), TRope.create(D, device="cpu")
    jctx = jdit.precompute_context(jp, jc, jnp.asarray(ctx))
    tctx = tdit.precompute_context(tp, cfg, torch.from_numpy(ctx))
    jcache = jdit.init_kv_cache(jc, B, FS, 21, jnp.float32)
    tcache = tdit.init_kv_cache(cfg, B, FS, 21, torch.float32, "cpu")
    for i, x in enumerate(xs):
        write = i < 3
        jflow, jcache = jdit.forward_inference(
            jp, jc, jnp.asarray(x), jnp.asarray(t), jctx, jcache,
            jnp.int32(NB * i), jrope, write_cache=write)
        tflow, tcache = tdit.forward_inference(
            tp, cfg, torch.from_numpy(x), torch.from_numpy(t), tctx, tcache,
            NB * i, trope, write_cache=write)
        np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow),
                                   rtol=1e-4, atol=1e-4)
        assert tcache.local_end == int(jcache.local_end)
    assert not tcache.kmax.any()
    assert set(routes) == {(None, None, False)}


@pytest.mark.parametrize("softmax", ["bounded", "online"])
def test_forward_train_modes_match_jax(softmax, routes):
    """forward_train (block-causal, teacher forcing off, no remat) under
    'bounded' / 'online' on the kernel route: the flow within 1e-4 and
    the gradient of sum(flow * w) with respect to every parameter leaf
    within 1e-3 relative L2 over all leaves (the flash backward recomputes
    p in float32 in both; bounded's bf16 p moves the forward by ~1e-5)."""
    cfg = dataclasses.replace(PACKED, attn_softmax=softmax)
    jc = _jcfg(cfg)
    jp, tp, ctx, xs, rng = _setup(cfg, 6)
    x = np.concatenate([xs[0], xs[1]], axis=1)       # 4 frames
    t = np.full((B, 4), 500.0, np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jm = jmasks.block_causal_mask(4, FS, num_frame_per_block=NB)
    tm = tmasks.block_causal_mask(4, FS, num_frame_per_block=NB)
    jrope = JRope.create(D)

    def jloss(params):
        out = jdit.forward_train(params, jc, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(ctx), jm, jrope, remat=False)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    leaves = [t_.requires_grad_(True) for t_ in
              jax.tree_util.tree_leaves(tp)]
    tp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                      leaves)
    tout = tdit.forward_train(tp, cfg, torch.from_numpy(x),
                              torch.from_numpy(t), torch.from_numpy(ctx), tm,
                              TRope.create(D, device="cpu"), remat=False)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-4)
    (tout * torch.from_numpy(w)).sum().backward()
    tg = np.concatenate([(torch.zeros_like(lf) if lf.grad is None
                          else lf.grad).numpy().ravel() for lf in leaves])
    jg = np.concatenate([np.asarray(g).ravel()
                         for g in jax.tree_util.tree_leaves(jgrad)])
    assert _rel_l2(tg, jg) < 1e-3, _rel_l2(tg, jg)
