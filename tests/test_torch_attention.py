"""The port's attention references (self_forcing_tpu_torch.ops) against
the JAX package on the CPU: the dispatch seam against
self_forcing_tpu.ops.attention, and the plain versions of the CUDA kernels
against the Pallas kernels run in interpret mode.  Inputs come from a
numpy seed and run in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.ops import attention as jattn
from self_forcing_tpu.ops import pallas_attention
from self_forcing_tpu.ops.pallas_attention import (
    cross_attention_pallas, decode_attention_fresh_pallas)
from self_forcing_tpu_torch.ops import attention as tattn
from self_forcing_tpu_torch.ops import cuda_attention as ca

LOG2E = 1.4426950408889634


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(out_t, ref_j, tol):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_j),
                               rtol=tol, atol=tol)


def test_dense_attention_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 2, 20, 2, 16), _rand(rng, 2, 33, 2, 16), \
        _rand(rng, 2, 33, 2, 16)
    for scale in (None, 0.3):
        ref = jattn.dense_attention(q, k, v, scale=scale)
        out = tattn.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), scale=scale)
        _close(out, ref, 1e-5)


@pytest.mark.parametrize("Lk", [257, 512])
@pytest.mark.parametrize("packed", [False, True])
def test_cross_attention_matches_jax(Lk, packed):
    rng = np.random.default_rng(Lk)
    B, Lq, N, D = 1, 40, 2, 32
    q = _rand(rng, B, Lq, N, D)
    k, v = _rand(rng, B, Lk, N, D), _rand(rng, B, Lk, N, D)
    if packed:
        q = q.reshape(B, Lq, N * D)
    hp = N if packed else None
    ref = jattn.cross_attention(q, k, v, heads_packed=hp)
    out = tattn.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), heads_packed=hp)
    _close(out, ref, 1e-5)


def _decode_inputs(rng, B, N, D, Lq, Lf, S, L=3):
    return (_rand(rng, B, Lq, N * D), _rand(rng, L, B * N, S, D),
            _rand(rng, L, B * N, S, D), _rand(rng, B, Lf, N * D),
            _rand(rng, B, Lf, N * D))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("softmax", [None, "free"])
def test_decode_attention_fresh_matches_jax(packed, softmax):
    """Stacked cache with layer_idx, a static_hi bound, a sink interval
    and both softmax modes (free: q pre-scaled by head_dim**-0.5*log2e)."""
    rng = np.random.default_rng(3)
    B, N, D, Lq, Lf, S = 2, 2, 16, 24, 24, 96
    q, kc, vc, kn, vn = _decode_inputs(rng, B, N, D, Lq, Lf, S)
    scale = None
    if softmax == "free":
        q = q * (D ** -0.5 * LOG2E)
        scale = 1.0
    if not packed:   # folded [B*N, L, D] operands
        fold = lambda a: a.reshape(B, -1, N, D).transpose(0, 2, 1, 3).reshape(
            B * N, -1, D)
        q, kn, vn = fold(q), fold(kn), fold(vn)
    args = dict(kv_start=40, kv_end=80, scale=scale, static_hi=90,
                layer_idx=1, heads_packed=N if packed else None,
                softmax=softmax, sink_end=16)
    ref = jattn.decode_attention_fresh(
        q, kc, vc, kn, vn, **{**args, "kv_start": jnp.int32(40),
                              "kv_end": jnp.int32(80),
                              "sink_end": jnp.int32(16),
                              "layer_idx": jnp.int32(1)})
    out = tattn.decode_attention_fresh(
        *(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), **args)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("lo,hi,sink,static_hi,li",
                         [(0, 128, 0, 128, 0), (64, 192, 32, 192, 2),
                          (0, 0, 0, 0, 1)])
def test_decode_fresh_free_ref_matches_pallas(lo, hi, sink, static_hi, li):
    """The CUDA kernel's plain version against the TPU kernel it replaces
    (free mode, heads-packed, stacked cache), Pallas in interpret mode.
    Tolerance 5e-3: both round p to bf16 before p.v."""
    rng = np.random.default_rng(4)
    B, N, D, Lq, Lf, S = 1, 2, 128, 96, 64, 256
    q, kc, vc, kn, vn = _decode_inputs(rng, B, N, D, Lq, Lf, S)
    q = q * (D ** -0.5 * LOG2E)
    ref = decode_attention_fresh_pallas(
        q, kc, vc, kn, vn, jnp.int32(lo), jnp.int32(hi), scale=1.0,
        tq=32, tk=64, interpret=True, static_hi=static_hi,
        layer_idx=jnp.int32(li), heads_packed=N, softmax="free",
        sink_end=jnp.int32(sink))
    out = ca.decode_fresh_free_ref(
        *(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), layer_idx=li,
        kv_start=lo, kv_end=hi, sink_end=sink, static_hi=static_hi,
        num_heads=N)
    _close(out, ref, 5e-3)


@pytest.mark.parametrize("Lk", [257, 512])
def test_cross_attention_ref_matches_pallas(Lk):
    """The CUDA kernel's plain version against the TPU kernel it replaces
    (heads-packed), Pallas in interpret mode; tolerance 2e-5 (fp32)."""
    rng = np.random.default_rng(Lk + 1)
    B, N, D, Lq = 1, 2, 128, 96
    q = _rand(rng, B, Lq, N * D)
    k, v = _rand(rng, B, Lk, N, D), _rand(rng, B, Lk, N, D)
    ref = cross_attention_pallas(q, k, v, tq=32, interpret=True,
                                 heads_packed=N)
    out = ca.cross_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), num_heads=N)
    _close(out, ref, 2e-5)


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the kernel wrappers compute their plain versions and
    count no launch."""
    rng = np.random.default_rng(5)
    q, kc, vc, kn, vn = (torch.from_numpy(a) for a in _decode_inputs(
        rng, 1, 2, 128, 16, 16, 64))
    ca.reset_launch_counts()
    args = dict(layer_idx=1, kv_start=8, kv_end=40, sink_end=4,
                static_hi=48, num_heads=2)
    torch.testing.assert_close(ca.decode_fresh_free(q, kc, vc, kn, vn,
                                                    **args),
                               ca.decode_fresh_free_ref(q, kc, vc, kn, vn,
                                                        **args))
    k = torch.from_numpy(_rand(rng, 1, 20, 2, 128))
    torch.testing.assert_close(ca.cross_attention(q, k, k, num_heads=2),
                               ca.cross_attention_ref(q, k, k, num_heads=2))
    tiles = dict(tq=8, tk=16, tf=32)
    torch.testing.assert_close(
        ca.decode_fresh_int8qk(q, kc, vc, kn, vn, **args, **tiles),
        ca.decode_fresh_int8qk_ref(q, kc, vc, kn, vn, **args, **tiles))
    assert set(ca.launch_counts.values()) == {0}


def test_free_softmax_is_base_e_at_scale_ln2():
    """The base-2 free softmax at scale 1 on q*scale*log2e equals the
    ordinary softmax at scale (the rule the CPU references use)."""
    rng = np.random.default_rng(6)
    q, kc, vc, kn, vn = (torch.from_numpy(a) for a in _decode_inputs(
        rng, 1, 2, 16, 12, 12, 32))
    base = tattn.decode_attention_fresh(q, kc, vc, kn, vn, 0, 20,
                                        layer_idx=0, heads_packed=2)
    free = tattn.decode_attention_fresh(q * (16 ** -0.5 * LOG2E), kc, vc,
                                        kn, vn, 0, 20, scale=1.0,
                                        layer_idx=0, heads_packed=2,
                                        softmax="free")
    torch.testing.assert_close(free, base, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- int8-QK decode

def _int8qk_pallas(q, kc, vc, kn, vn, lo, hi, sink, li, N, tq, tk,
                   tk_align=None, window_static=None, static_hi=None):
    """The TPU kernel in 'free_qk' mode, interpreted, and the (tq, tk, tf)
    it ran with (captured from its inner op)."""
    seen = {}
    inner = pallas_attention._decode_fresh_op

    def spy(*args):
        seen["tiles"] = args[11:14]
        return inner(*args)

    pallas_attention._decode_fresh_op = spy
    try:
        out = decode_attention_fresh_pallas(
            q, kc, vc, kn, vn, jnp.int32(lo), jnp.int32(hi), scale=1.0,
            tq=tq, tk=tk, interpret=True, static_hi=static_hi,
            layer_idx=jnp.int32(li), heads_packed=N, softmax="free",
            quant="int8qk", sink_end=jnp.int32(sink), tk_align=tk_align,
            window_static=window_static)
    finally:
        pallas_attention._decode_fresh_op = inner
    return np.asarray(out), seen["tiles"]


INT8QK_TOL = 2e-4  # see test_decode_fresh_int8qk_ref_matches_pallas
# (lo, hi, sink, tq, tk, tk_align, window_static, static_hi):
INT8QK_CASES = {
    # global tiles: 2 q tiles of 64 for Lq 120, cache tiles of 216 rows
    # (the last one past S = 640), one fresh tile of 128 for Lf 100
    "global": (64, 300, 0, 64, 256, None, None, 300),
    # windowed tiles: frame-aligned cache tiles of 128 (tk_align 64), a
    # sink frame and a window that starts past a dead gap
    "windowed": (320, 576, 64, 512, 256, 64, (64, 256), None),
    # the default request (tq 512 -> one q tile of 120, tk 2048 -> 216)
    "defaults": (0, 432, 0, 512, 2048, None, None, None),
}


@pytest.mark.parametrize("case", list(INT8QK_CASES))
def test_decode_fresh_int8qk_ref_matches_pallas(case):
    """The int8-QK kernel's plain version against the TPU kernel it
    replaces ('free_qk' mode, heads-packed, stacked cache, Pallas in
    interpret mode), with the tiles the Pallas wrapper picked, which
    decode_tiles reproduces.  The int8 products are exact integers and
    the scales equal, so the f32 sums of l and p.v, taken in another
    order, differ by ~2e-7.  Tolerance 2e-4: XLA may round one score's p
    to the other side of a bf16 step (8.7e-5 on one row of the windowed
    case, where a float64 evaluation of the function agrees with the
    plain version to 2e-7)."""
    lo, hi, sink, tq, tk, align, ws, static_hi = INT8QK_CASES[case]
    rng = np.random.default_rng(11)
    B, N, D, Lq, Lf, S = 1, 2, 128, 120, 100, 640
    q, kc, vc, kn, vn = _decode_inputs(rng, B, N, D, Lq, Lf, S)
    q = q * (D ** -0.5 * LOG2E)
    ref, tiles = _int8qk_pallas(q, kc, vc, kn, vn, lo, hi, sink, 1, N, tq,
                                tk, align, ws, static_hi)
    assert tattn.decode_tiles(Lq, S, Lf, "int8qk", "free", align, tq=tq,
                              tk=tk) == tuple(tiles)
    out = ca.decode_fresh_int8qk_ref(
        *(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), layer_idx=1,
        kv_start=lo, kv_end=hi, sink_end=sink, static_hi=static_hi,
        num_heads=N, tq=tiles[0], tk=tiles[1], tf=tiles[2])
    _close(out, ref, INT8QK_TOL)


def test_int8qk_k_scale_spans_masked_rows_like_pallas():
    """Cache rows past kv_end inside a live tile are masked, yet they set
    that tile's k scale: poisoning them moves the TPU kernel's output,
    and the plain version moves with it (the same scale domain)."""
    rng = np.random.default_rng(12)
    B, N, D, Lq, Lf, S = 1, 2, 128, 120, 100, 640
    q, kc, vc, kn, vn = _decode_inputs(rng, B, N, D, Lq, Lf, S)
    q = q * (D ** -0.5 * LOG2E)
    lo, hi = 64, 300                     # tile [216, 432) is live to 300
    outs = []
    for poison in (False, True):
        kcp = kc.copy()
        if poison:
            kcp[1, :, hi:432] = 40.0
        ref, tiles = _int8qk_pallas(q, kcp, vc, kn, vn, lo, hi, 0, 1, N,
                                    64, 256)
        out = ca.decode_fresh_int8qk_ref(
            *(torch.from_numpy(a) for a in (q, kcp, vc, kn, vn)),
            layer_idx=1, kv_start=lo, kv_end=hi, num_heads=N, tq=tiles[0],
            tk=tiles[1], tf=tiles[2])
        _close(out, ref, INT8QK_TOL)
        outs.append((out.numpy(), ref))
    moved = np.abs(outs[1][1] - outs[0][1]).max()
    assert moved > 1e-3
    np.testing.assert_allclose(outs[1][0] - outs[0][0],
                               outs[1][1] - outs[0][1], atol=INT8QK_TOL)


def test_decode_tiles_at_the_production_shapes(monkeypatch):
    """The tiles of the global demo path and of the windowed path at
    Wan-1.3B (4680 queries and fresh keys a 3-frame block, 12 heads), as
    the Pallas wrapper picks them: traced with abstract shapes, its inner
    op replaced by a stub that records the tiles.  q: 6 tiles of 784
    rows (780 rounded up to a multiple of 8) or 5 of 936."""
    seen = []

    def stub(q, *args):
        seen.append(tuple(args[10:13]))
        return jnp.zeros(q.shape, q.dtype)

    monkeypatch.setattr(pallas_attention, "_decode_fresh_op", stub)
    for S, align, ws, want in ((32768, None, None, (784, 2048, 1568)),
                               (37440, 1560, (1560, 12480),
                                (936, 1560, 1568))):
        act = jax.ShapeDtypeStruct((1, 4680, 1536), jnp.bfloat16)
        cache = jax.ShapeDtypeStruct((30, 12, S, 128), jnp.bfloat16)
        jax.eval_shape(lambda q, kc, vc, kn, vn: decode_attention_fresh_pallas(
            q, kc, vc, kn, vn, jnp.int32(0), jnp.int32(S // 2), scale=1.0,
            layer_idx=jnp.int32(3), heads_packed=12, softmax="free",
            quant="int8qk", sink_end=jnp.int32(0), tk_align=align,
            window_static=ws), act, cache, cache, act, act)
        assert seen[-1] == want
        assert tattn.decode_tiles(4680, S, 4680, "int8qk", "free",
                                  align) == want


def test_int8qk_seam_on_the_cpu():
    """On the CPU the seam sends int8qk with the free softmax to the
    plain version (with decode_tiles' tiles) and ignores quant without
    it, as the JAX package does off the TPU; a window larger than
    window_static is refused."""
    rng = np.random.default_rng(13)
    q, kc, vc, kn, vn = (torch.from_numpy(a) for a in _decode_inputs(
        rng, 1, 2, 128, 40, 40, 256))
    q = q * (128 ** -0.5 * LOG2E)
    args = dict(layer_idx=0, heads_packed=2, sink_end=32)
    out = tattn.decode_attention_fresh(q, kc, vc, kn, vn, 64, 192,
                                       scale=1.0, softmax="free",
                                       quant="int8qk", tk_align=32, **args)
    tq, tk, tf = tattn.decode_tiles(40, 256, 40, "int8qk", "free", 32)
    ref = ca.decode_fresh_int8qk_ref(q, kc, vc, kn, vn, layer_idx=0,
                                     kv_start=64, kv_end=192, sink_end=32,
                                     num_heads=2, tq=tq, tk=tk, tf=tf)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    base = tattn.decode_attention_fresh(q, kc, vc, kn, vn, 64, 192, **args)
    torch.testing.assert_close(
        tattn.decode_attention_fresh(q, kc, vc, kn, vn, 64, 192,
                                     quant="int8qk", **args), base)
    with pytest.raises(ValueError):
        tattn.decode_attention_fresh(q, kc, vc, kn, vn, 32, 192, scale=1.0,
                                     softmax="free", quant="int8qk",
                                     window_static=(32, 128), **args)


# ------------------------------------------- the cache-window attention

def _window_case(seed, Lq, S, B=1, N=2, D=128):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, Lq, N, D), _rand(rng, B, S, N, D),
            _rand(rng, B, S, N, D))


def _fold(a):
    B, L, N, D = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * N, L, D))


@pytest.mark.parametrize("route", [False, True], ids=["plain", "route"])
@pytest.mark.parametrize("layout", ["4d", "folded_cache", "folded"])
@pytest.mark.parametrize("lo,hi", [(0, 96), (0, 320), (64, 256)])
def test_decode_attention_matches_pallas(monkeypatch, route, layout, lo, hi):
    """``decode_attention`` (the cases of the JAX package's
    test_decode_matches_xla) against the interpreted ``_decode_kernel``
    at 2e-5, on both layouts, with the bounds as device scalars; with the
    kernel route forced the CPU runs the decode window kernel's plain
    version through the same dispatch."""
    if route:
        monkeypatch.setattr(tattn, "_kernel_route", lambda t: True)
    q, k, v = _window_case(0, 96, 320)
    ref = pallas_attention.decode_attention_pallas(
        q, k, v, jnp.int32(lo), jnp.int32(hi), tq=128, tk=128,
        interpret=True)
    ref = np.asarray(ref)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    if layout == "folded_cache":
        kt, vt = torch.from_numpy(_fold(k)), torch.from_numpy(_fold(v))
    elif layout == "folded":
        qt, kt, vt = (torch.from_numpy(_fold(a)) for a in (q, k, v))
        ref = _fold(ref)
    out = tattn.decode_attention(qt, kt, vt, torch.tensor(lo),
                                 torch.tensor(hi))
    assert out.shape == qt.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_decode_attention_window_excludes_the_rest(monkeypatch):
    """The JAX package's test_decode_window_excludes_rest: keys and
    values outside [lo, hi) set to +-99 do not move the output (1e-6);
    the kernel route's plain version, against the interpreted kernel."""
    monkeypatch.setattr(tattn, "_kernel_route", lambda t: True)
    q, k, v = _window_case(1, 32, 256)
    lo, hi = 32, 128
    k2, v2 = k.copy(), v.copy()
    k2[:, hi:], v2[:, hi:] = 99.0, 99.0
    k2[:, :lo], v2[:, :lo] = -99.0, -99.0
    outs = [tattn.decode_attention(*(torch.from_numpy(a) for a in (q, kk, vv)),
                                   lo, hi) for kk, vv in ((k, v), (k2, v2))]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-6,
                               atol=1e-6)
    ref = pallas_attention.decode_attention_pallas(
        q, k2, v2, jnp.int32(lo), jnp.int32(hi), tq=128, tk=128,
        interpret=True)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("route", [False, True], ids=["plain", "route"])
@pytest.mark.parametrize("folded", [False, True])
def test_decode_attention_gradients_match_jax(monkeypatch, route, folded):
    """Gradients for q, k_cache and v_cache through one cotangent: the
    port's autograd (off the route) or its custom backward (the plain
    recomputation, on it) against ``jax.vjp`` of
    ``decode_attention_pallas`` (whose backward replays
    ``decode_attention_xla``), 1e-4."""
    if route:
        monkeypatch.setattr(tattn, "_kernel_route", lambda t: True)
    q, k, v = _window_case(2, 96, 320)
    g = _rand(np.random.default_rng(3), *q.shape)
    lo, hi = 64, 256
    if folded:
        q, k, v, g = (_fold(a) for a in (q, k, v, g))

    def jf(q_, k_, v_):
        return pallas_attention.decode_attention_pallas(
            q_, k_, v_, jnp.int32(lo), jnp.int32(hi), tq=128, tk=128,
            interpret=True)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.decode_attention(*ts, lo, hi)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for t, jg in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-4)


def test_decode_window_wrapper_runs_the_plain_version_on_the_cpu():
    """The CUDA wrapper on CPU tensors is ``decode_attention_xla``'s port
    (int bounds or scalar tensors)."""
    q, k, v = (torch.from_numpy(a) for a in _window_case(4, 40, 200))
    out = ca.decode_window(q, k, v, 16, torch.tensor(150))
    ref = tattn.decode_attention_xla(q, k, v, 16, 150)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
