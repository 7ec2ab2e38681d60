"""The port's conv entry points (self_forcing_tpu_torch/ops/conv.py) against
the JAX package's Pallas conv kernels on the CPU.

The JAX side runs each Pallas entry point with ``interpret=True``.  The
port's CPU path runs the kernels' plain versions, so these tests hold the
plain versions (the oracles of the CUDA kernel) to the TPU kernels'
function: float32, tolerance 3e-5 (the JAX kernel tests' own).  The
routing predicates are held to the JAX wrappers' accept / decline at the
full-width shapes of the Wan VAE (traced abstractly, no compute), and the
port's whole VAE, run on the meta device, takes the JAX package's routes
conv by conv and block by block."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu.ops import attention as jatt
from self_forcing_tpu.ops import pallas_conv as jpc
from self_forcing_tpu_torch.models.wan import vae as tvae
from self_forcing_tpu_torch.ops import conv as tconv

TOL = 3e-5


def _close(out_t, ref_j):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_j), rtol=TOL,
                               atol=TOL)


def _operands(seed, B, T, H, W, C, Cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    cache = rng.standard_normal((B, 2, H, W, C)).astype(np.float32)
    w = (0.05 * rng.standard_normal((3, 3, 3, C, Cout))).astype(np.float32)
    b = (0.1 * rng.standard_normal(Cout)).astype(np.float32)
    return x, cache, w, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oidhw(w):
    return _t(w.transpose(4, 3, 0, 1, 2))


def test_conv3d_fused_matches_jax():
    x, cache, w, b = _operands(0, 1, 2, 8, 16, 16, 24)
    ref = jpc._conv3d_fused(x, cache, w, b, True)
    out = tconv.conv3d_fused(_t(x), _t(cache), _oidhw(w), _t(b))
    assert out.shape == (1, 2, 8, 16, 24)
    _close(out, ref)


def test_split_route_matches_jax(monkeypatch):
    """The 3-call temporal split of causal_conv3d_pallas, forced on both
    sides by making the fused route decline."""
    x, cache, w, b = _operands(1, 1, 3, 8, 16, 16, 8)
    monkeypatch.setattr(jpc, "_conv3d_fused", lambda *a, **k: None)
    monkeypatch.setattr(tconv, "conv3d_fused", lambda *a, **k: None)
    ref = jpc.causal_conv3d_pallas(x, cache, w, b, interpret=True)
    out = tconv.causal_conv3d_pallas(_t(x), _t(cache), _oidhw(w), _t(b))
    _close(out, ref)


def test_causal_conv3d_pallas_takes_the_fused_route():
    x, cache, w, b = _operands(2, 1, 1, 8, 8, 8, 16)
    ref = jpc.causal_conv3d_pallas(x, cache, w, b, interpret=True)
    out = tconv.causal_conv3d_pallas(_t(x), _t(cache), _oidhw(w), _t(b))
    _close(out, ref)


def test_v2_matches_jax():
    x, cache, w, b = _operands(3, 1, 2, 8, 16, 128, 128)
    ref = jpc.causal_conv3d_pallas_v2(x, cache, w, b, interpret=True)
    out = tconv.causal_conv3d_pallas_v2(_t(x), _t(cache), _oidhw(w), _t(b))
    _close(out, ref)


@pytest.mark.parametrize("residual", [False, True])
def test_norm_silu_conv3d_matches_jax(residual):
    """Raw non-zero cache frames, jittered gammas; the timeline is
    [cache | x] on both sides (JAX takes it concatenated)."""
    x, cache, w, b = _operands(4, 1, 2, 8, 16, 128, 128)
    rng = np.random.default_rng(5)
    gamma = (1.0 + 0.2 * rng.standard_normal(128)).astype(np.float32)
    res = rng.standard_normal((2, 8, 16, 128)).astype(np.float32) \
        if residual else None
    xt = np.concatenate([cache[0], x[0]], axis=0)
    ref = jpc.norm_silu_conv3d_pallas(xt, gamma, w, b, residual=res,
                                      interpret=True)
    out = tconv.norm_silu_conv3d(_t(x[0]), _t(cache[0]), _t(gamma),
                                 _oidhw(w), _t(b),
                                 None if res is None else _t(res))
    _close(out, ref)


@pytest.mark.parametrize("route", ["fused", "split"])
def test_float32_convs_match_pallas(route):
    """The float32 mode of ``_conv3d_kernel`` (96 channels, as the
    decoder's full-resolution stage) and of ``_conv2d_kernel`` (384
    channels: at float32 the fused rule declines them and the split route
    runs, as at the 384-channel stages): the plain version (float32
    products and sums, TF32 off) against the interpreted Pallas conv,
    (the CUDA kernel's 3xTF32 products are held to the same plain version
    on the card).  Both sum 27 * C float32 products in another
    order: 1e-5 relative L2, and elementwise the JAX kernel tests' 3e-5."""
    C = 96 if route == "fused" else 384
    x, cache, w, b = _operands(7, 1, 2, 8, 16, C, C)
    assert (tconv.fused_tile(8, 16, C, C, 4) is not None) == (route == "fused")
    assert tconv.split_tile(8, 16, C, C, 4) is not None
    tconv.reset_decline_counts()
    ref = jpc.causal_conv3d_pallas(x, cache, w, b, interpret=True)
    out = tconv.causal_conv3d_pallas(_t(x), _t(cache), _oidhw(w), _t(b))
    assert out.dtype == torch.float32
    assert tconv.decline_counts["conv3d_fused"] == (route == "split")
    ref = np.asarray(ref, np.float64)
    err = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
    assert err < 1e-5, err
    _close(out, ref)
    # the full-width shapes the float32 rules send to each route
    assert tconv.fused_tile(480, 832, 96, 96, 4) is not None
    assert tconv.fused_tile(60, 104, 384, 384, 4) is None
    assert tconv.split_tile(60, 104, 384, 384, 4) is not None


# ---------------------------------------------------------------- routing

def _meta_vae(dtype):
    """The WAN_VAE tree abstractly on the JAX side and as meta tensors in
    the port's layout (OIDHW / OIHW)."""
    tree = jax.eval_shape(lambda: jvae.init_params(jax.random.PRNGKey(0),
                                                   jvae.WAN_VAE, dtype))

    def conv(key, a):
        if isinstance(a, dict):
            return {k: conv(k, v) for k, v in a.items()}
        if isinstance(a, list):
            return [conv(key, v) for v in a]
        shape = a.shape
        if key == "w" and len(shape) == 5:
            shape = tuple(shape[i] for i in (4, 3, 0, 1, 2))
        elif key == "w" and len(shape) == 4:
            shape = tuple(shape[i] for i in (3, 2, 0, 1))
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    return tree, conv(None, tree)


def _conv_shapes():
    """(H, W, C, Cout) of every 3x3x3 stride-1 conv of the full-width
    decoder (60x104 latents, before and after pad_decoder_channels) and
    encoder (480x832 pixels)."""
    shapes = {(60, 104, 16, 384), (60, 104, 384, 384), (120, 208, 192, 384),
              (120, 208, 384, 384), (240, 416, 192, 192),
              (480, 832, 96, 96), (480, 832, 96, 3),
              (480, 832, 128, 128), (480, 832, 128, 3)}   # padded stage
    h, w = 480, 832
    shapes.add((h, w, 3, 96))
    for i, (cin, cout) in enumerate(((96, 96), (96, 192), (192, 384),
                                     (384, 384))):
        shapes.update({(h, w, cin, cout), (h, w, cout, cout)})
        if i < 3:
            h, w = h // 2, w // 2
    shapes.add((h, w, 384, 32))
    return sorted(shapes)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_predicates_match_jax_wrappers(dtype):
    """Each routing predicate accepts or declines exactly as its JAX
    wrapper does, at every conv shape of the full-width VAE (abstract
    traces with interpret=True: no compute)."""
    jdt = jnp.dtype(dtype)
    bpe = jdt.itemsize
    S = jax.ShapeDtypeStruct
    seen = {"fused": 0, "split": 0, "v2": 0, "nsc": 0}
    for H, W, C, Cout in _conv_shapes():
        x, cache = S((1, 2, H, W, C), jdt), S((1, 2, H, W, C), jdt)
        w, b = S((3, 3, 3, C, Cout), jdt), S((Cout,), jdt)
        got = jax.eval_shape(
            lambda x, c, w, b: jpc._conv3d_fused(x, c, w, b, True),
            x, cache, w, b)
        assert (got is not None) == (
            tconv.fused_tile(H, W, C, Cout, bpe) is not None), (H, W, C, Cout)
        seen["fused"] += got is not None
        # causal_conv3d_pallas pads the tap's weight to 128-multiples
        Cp, Cop = -(-C // 128) * 128, -(-Cout // 128) * 128
        got = jax.eval_shape(
            lambda f, w, b: jpc._conv2d_9tap(f, w, b, True),
            S((2, H, W, C), jdt), S((3, 3, Cp, Cop), jdt), S((Cop,), jdt))
        assert (got is not None) == (
            tconv.split_tile(H, W, C, Cout, bpe) is not None), (H, W, C, Cout)
        seen["split"] += got is not None
        try:
            jax.eval_shape(lambda x, c, w, b: jpc.causal_conv3d_pallas_v2(
                x, c, w, b, interpret=True), x, cache, w, b)
            ok = True
        except AssertionError:
            ok = False
        assert ok == (tconv.v2_tile(H, W, C, Cout, bpe) is not None), \
            (H, W, C, Cout)
        seen["v2"] += ok
        for res in (False, True):
            r = S((2, H, W, Cout), jdt) if res else None
            got = jax.eval_shape(
                lambda xt, g, w, b, r: jpc.norm_silu_conv3d_pallas(
                    xt, g, w, b, residual=r, interpret=True),
                S((4, H, W, C), jdt), S((C,), jdt), w, b, r)
            assert (got is None) == (tconv.nsc_tile(
                H, W, C, Cout, bpe, res) is None), (H, W, C, Cout, res)
            seen["nsc"] += got is not None
    # at bf16 (the VAE's working type) every conv fits the fused route, as
    # the route survey found, and the v2 and nsc rules both accept and
    # decline; at float32 the fused rule declines some, v2 and nsc all
    n = len(_conv_shapes())
    if dtype == "bfloat16":
        assert seen["fused"] == n and 0 < seen["nsc"] < 2 * n \
            and 0 < seen["v2"] < n, seen
    else:
        assert 0 < seen["fused"] < n and seen["nsc"] == seen["v2"] == 0, seen


@pytest.mark.parametrize("backend", ["pallas", "fused"])
@pytest.mark.parametrize("part", ["decode_first", "decode_step",
                                  "encode_first", "encode_step"])
def test_full_width_routes_match_jax(monkeypatch, backend, part):
    """The route survey: one decode step (60x104 latents) and one encode
    chunk (480x832 pixels) of the full-width bf16 VAE, JAX traced with
    jax.eval_shape (Pallas in interpret mode) and the port run on the
    meta device; every 3x3x3 conv ('pallas') and every residual block
    ('fused', after pad_decoder_channels) takes the same route in both,
    in the same order.  Under 'pallas' all 30 decoder convs and all 22
    encoder convs take the kernel; under 'fused' 5 decoder and 4 encoder
    blocks run fused."""
    monkeypatch.setattr(jatt, "_ATTENTION_BACKEND", "pallas")
    monkeypatch.setattr(jvae, "_CONV_BACKEND", backend)
    monkeypatch.setattr(tvae, "_CONV_BACKEND", backend)
    jrec, trec = [], []
    j_conv, t_conv = jpc._conv3d_fused, tconv.conv3d_fused
    j_blk, t_blk = jvae._residual_block_fused, tvae._residual_block_fused

    def j_conv_spy(x, c, w, b, interpret=False):
        y = j_conv(x, c, w, b, True)
        jrec.append(("conv", tuple(x.shape), w.shape[-1], y is not None))
        return y

    def t_conv_spy(x, c, w, b):
        y = t_conv(x, c, w, b)
        trec.append(("conv", tuple(x.shape), w.shape[0], y is not None))
        return y

    def j_blk_spy(p, x, c):
        y = j_blk(p, x, c)
        jrec.append(("block", tuple(x.shape), y is not None))
        return y

    def t_blk_spy(p, x, c):
        y = t_blk(p, x, c)
        trec.append(("block", tuple(tvae._cl(x).shape), y is not None))
        return y

    monkeypatch.setattr(jpc, "_conv3d_fused", j_conv_spy)
    monkeypatch.setattr(tconv, "conv3d_fused", t_conv_spy)
    monkeypatch.setattr(jvae, "_residual_block_fused", j_blk_spy)
    monkeypatch.setattr(tvae, "_residual_block_fused", t_blk_spy)

    jtree, tp = _meta_vae(jnp.bfloat16)
    if backend == "fused":
        jtree = jax.eval_shape(jvae.pad_decoder_channels, jtree)
        tp = tvae.pad_decoder_channels(tp)
    bf = jnp.bfloat16
    first = part.endswith("first")
    if part.startswith("decode"):
        shapes = jax.eval_shape(lambda: jvae.init_decoder_cache(
            jtree, jvae.WAN_VAE, 1, 60, 104, bf))
        x = (1, 1, 60, 104, 16)
        jax.eval_shape(lambda p, z, c: jvae.decode_frame(
            p, jvae.WAN_VAE, z, c, first), jtree, jax.ShapeDtypeStruct(x, bf),
            shapes)
        fn = tvae.decode_frame
    else:
        shapes = jax.eval_shape(lambda: jvae.init_encoder_cache(
            jtree, jvae.WAN_VAE, 1, 480, 832, bf))
        x = (1, 1 if first else 4, 480, 832, 3)
        jax.eval_shape(lambda p, z, c: jvae.encode_chunk(
            p, jvae.WAN_VAE, z, c, first), jtree,
            jax.ShapeDtypeStruct(x, bf), shapes)
        fn = tvae.encode_chunk
    cache = [torch.empty(s.shape, dtype=torch.bfloat16,
                         device="meta").permute(0, 4, 1, 2, 3)
             for s in shapes]
    y, _ = fn(tp, tvae.WAN_VAE, torch.empty(x, dtype=torch.bfloat16,
                                            device="meta"), cache, first)
    assert trec == jrec
    taken = sum(r[-1] for r in trec)
    want = {("pallas", "decode"): 30, ("pallas", "encode"): 22,
            ("fused", "decode"): 5, ("fused", "encode"): 4}
    assert taken == want[backend, part.split("_")[0]]
    assert tuple(y.shape) == ((1, 4 if part == "decode_step" else 1, 480,
                               832, 3) if part.startswith("decode")
                              else (1, 1, 60, 104, 32))


# ---------------------------------------------------------------- work plan

def _items(B, T, H, W, C, Cout, taps_t, bn, splits):
    """The wide route's work items as csrc/conv3d.cu's decode_item lists
    them (split fastest, then channel tile, column tile, row tile, frame):
    (b, t, h0, w0, n0, k0, k1, s) for output rows h0..h0 + TR - 1, columns
    w0..w0 + TW - 1 (those inside H x W), channels n0..n0 + bn - 1 (those
    below Cout) and K steps [k0, k1) of split s.  A model of the kernel's
    decoding; the card tests run the kernel itself at these edges."""
    cc = tconv.cuda_conv
    mt, wt, nt = -(-H // cc.TR), -(-W // cc.TW), -(-Cout // bn)
    ks = taps_t * -(-C // cc.CK)
    for i in range(B * T * mt * wt * nt * splits):
        s, r = i % splits, i // splits
        n, r = r % nt, r // nt
        w, r = r % wt, r // wt
        h, fr = r % mt, r // mt
        yield (fr // T, fr % T, h * cc.TR, w * cc.TW, n * bn,
               s * ks // splits, (s + 1) * ks // splits, s)


@pytest.mark.parametrize("B,T,H,W,C,Cout,taps_t,splits", [
    (1, 1, 60, 104, 384, 384, 3, 4),       # 96-channel tiles, split 4
    (1, 1, 60, 104, 384, 32, 3, None),     # the plan's K split
    (1, 2, 120, 208, 192, 384, 3, None),   # no split
    (2, 3, 9, 70, 40, 192, 1, 2),          # ragged tiles, one temporal tap
    (1, 4, 5, 63, 96, 64, 3, 7),           # uneven runs of K steps
    (1, 2, 6, 70, 96, 3, 3, None),         # the RGB head: a masked tile
])
def test_conv_items_cover_every_pixel_and_k_step_once(B, T, H, W, C, Cout,
                                                       taps_t, splits):
    """The wide route's work items (_items, at conv_plan's channel tile and
    at its K split or a split the launcher also takes): every output pixel
    of every frame, every output-channel tile and every K step (temporal
    tap x 32 channels) belongs to exactly one item, each item's K steps
    are a non-empty run, and the plan's grid is no larger than its items."""
    cc = tconv.cuda_conv
    plan = cc.conv_plan(B, T, H, W, C, Cout, taps_t, 132)
    bn = plan["bn"]
    splits = plan["splits"] if splits is None else splits
    ks = taps_t * -(-C // cc.CK)
    count = np.zeros((B, T, H, W, Cout, ks), np.int32)
    items = list(_items(B, T, H, W, C, Cout, taps_t, bn, splits))
    for b, t, h0, w0, n0, k0, k1, s in items:
        assert 0 <= k0 < k1 <= ks and n0 % bn == 0 and 0 <= s < splits
        count[b, t, h0:h0 + cc.TR, w0:w0 + cc.TW, n0:n0 + bn, k0:k1] += 1
    assert (count == 1).all()
    assert len(items) == plan["tiles"] * splits
    assert 1 <= plan["grid"] == min(plan["tiles"] * plan["splits"], 132)


def test_conv_plan_routes_and_splits_at_the_vae_shapes():
    """Every bf16 conv of the full-width VAE takes the wide route but the
    RGB input; the 60x104 stage at 384 channels and T = 1 takes 96-channel
    tiles (120 items on 132 SMs, where 192 gives 60), the larger stages
    the widest tile that divides Cout, the encoder head (384 -> 32 at
    60x104, 30 tiles) a K split, but not as a norm + SiLU conv; the RGB
    head one 32-channel tile."""
    cc = tconv.cuda_conv
    narrow = {(C, Cout) for H, W, C, Cout in _conv_shapes()
              if cc.conv_plan(1, 1, H, W, C, Cout, 3, 132)["route"]
              == "narrow"}
    assert narrow == {(3, 96)}

    def plan(*shape):
        p = cc.conv_plan(*shape, 3, 132)
        return p["route"], p["bn"], p["splits"]

    assert plan(1, 1, 60, 104, 384, 384) == ("wide", 96, 1)
    assert plan(1, 1, 60, 104, 384, 32) == ("wide", 32, 4)
    assert cc.conv_plan(1, 1, 60, 104, 384, 32, 3, 132,
                        norm=True)["splits"] == 1
    assert plan(1, 4, 480, 832, 96, 3) == ("wide", 32, 1)
    assert plan(1, 4, 480, 832, 96, 96) == ("wide", 96, 1)
    assert plan(1, 4, 240, 416, 192, 192) == ("wide", 192, 1)
    assert plan(1, 4, 480, 832, 128, 128) == ("wide", 128, 1)
    assert plan(1, 2, 120, 208, 384, 384) == ("wide", 192, 1)
    assert cc.conv_plan(1, 4, 480, 832, 3, 96, 3, 132) == dict(
        route="narrow", bn=0, tiles=None, ksteps=None, splits=1, grid=0)
