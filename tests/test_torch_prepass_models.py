"""Models of two kernels' work on the CPU, where no kernel runs: the
full-int8 V pre-pass's split of each tile over a cluster of CTAs
(csrc/decode_int8.cu, ``int8_quantize_v_kernel``) and the RGB conv's
packed K (csrc/conv3d.cu, the narrow route).

Each model follows the kernel's own indexing (as
``tests/test_torch_conv.py::_items`` follows the wide conv's), so a
change to one without the other fails here; the card tests run the
kernels themselves at these edges.  The RGB model builds the im2col
through the packed weight the wrapper hands the kernel
(``cuda_conv.rgb_weight``) with the kernel's addressing (halo rows of
W * C values, element C pixel + k % 3C of row k / 3C) and holds it to
the plain conv, which ``tests/test_torch_conv.py`` holds to the JAX
kernel."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from self_forcing_tpu_torch.ops import conv as tconv
from self_forcing_tpu_torch.ops import cuda_attention as ca
from self_forcing_tpu_torch.ops import cuda_conv as cc
from self_forcing_tpu_torch.ops.attention import decode_tiles

# csrc/decode_int8.cu: CTAs a cluster, rows a CTA may stage
VCL, V_SHARE = 8, 896


def _cdiv(a, b):
    return -(-a // b)


def _v_ctas(BN, S, Lf, kv_start, kv_end, sink_end, cache_lim, tk, tf):
    """The V pre-pass's CTAs as int8_quantize_v_launch launches them and
    int8_quantize_v_kernel decodes its block index: per CTA (matrix,
    'cache' or 'fresh', tile, first group, groups written, rows read from
    the tile's first key of the share, writes the dead scales)."""
    ntc, ntf = _cdiv(cache_lim, tk), _cdiv(Lf, tf)
    a1 = min(ntc, _cdiv(max(sink_end, 0), tk))
    b2 = max(a1, max(kv_start, 0) // tk)
    c2 = max(b2, min(ntc, _cdiv(max(kv_end, 0), tk)))
    n_live = a1 + max(c2 - b2, 0)
    for block in range(VCL * BN * (n_live + ntf)):
        idx, rank = block // VCL, block % VCL
        if idx < BN * ntf:
            kind, m, t = "fresh", idx // ntf, idx % ntf
            first, tile, rows = t == 0, tf, Lf
        else:
            idx -= BN * ntf
            kind, m, t = "cache", idx // n_live, idx % n_live
            first, tile, rows = ntf == 0 and t == 0, tk, S
            t = t if t < a1 else b2 + (t - a1)
        groups = _cdiv(tile, 64) * 64 // 16
        share = _cdiv(groups, VCL)
        g0 = min(rank * share, groups)
        n_grp = min(share, groups - g0)
        n_read = max(0, min(16 * n_grp, min(tile, rows - t * tile) - 16 * g0))
        yield m, kind, t, g0, n_grp, n_read, first and rank == 0


def _v_cases():
    """(label, S, Lf, window, tiles): the 1.3B global demo window at block
    7, the windowed steady state (a sink tile, a window from mid-buffer),
    a sink inside a tile with kv_start mid-tile, and tiles that are no
    multiple of 16 (nor 64)."""
    lq = 4680
    glob = dict(kv_start=0, kv_end=18 * 1560, sink_end=0,
                static_hi=18 * 1560)
    yield "global", 32768, lq, glob, decode_tiles(lq, 32768, lq, "int8")
    s_win = 24 * 1560
    yield ("windowed", s_win, lq,
           dict(kv_start=s_win - lq - 8 * 1560, kv_end=s_win - lq,
                sink_end=1560, static_hi=None),
           decode_tiles(lq, s_win, lq, "int8", None, 1560))
    yield ("sink inside a tile", 5000, 300,
           dict(kv_start=2600, kv_end=4100, sink_end=700, static_hi=None),
           (8, 1000, 224))
    yield ("ragged tiles", 2000, 75,
           dict(kv_start=1010, kv_end=1930, sink_end=0, static_hi=1999),
           (8, 1003, 37))


@pytest.mark.parametrize("label,S,Lf,win,tiles", list(_v_cases()),
                         ids=[c[0] for c in _v_cases()])
def test_int8_v_prepass_split_covers_each_live_group_once(label, S, Lf, win,
                                                          tiles):
    """Every 16-key group of every live cache tile and every fresh tile,
    the padding to 64 keys included, is written by exactly one CTA, and
    every row of data is read by exactly one (the one that writes its
    group); no CTA touches a cache tile the window does not meet, and one
    CTA of each matrix writes the dead tiles' scales; no CTA stages more
    rows than its shared memory holds."""
    _, tk, tf = tiles
    BN = 3
    lim = ca._cache_lim(S, win["kv_start"], win["kv_end"], win["sink_end"],
                        win["static_hi"])
    ntc, ntf = _cdiv(lim, tk), _cdiv(Lf, tf)
    live = ca.live_cache_tiles(ntc, tk, win["kv_start"], win["kv_end"],
                               win["sink_end"])
    tp = {"cache": _cdiv(tk, 64) * 64, "fresh": _cdiv(tf, 64) * 64}
    written = {k: np.zeros((BN, n, tp[k] // 16), np.int32)
               for k, n in (("cache", ntc), ("fresh", ntf))}
    read = {k: np.zeros((BN, n, tp[k]), np.int32)
            for k, n in (("cache", ntc), ("fresh", ntf))}
    dead_scales = np.zeros(BN, np.int32)
    for m, kind, t, g0, n_grp, n_read, dead in _v_ctas(
            BN, S, Lf, win["kv_start"], win["kv_end"], win["sink_end"], lim,
            tk, tf):
        assert 16 * n_grp <= V_SHARE
        written[kind][m, t, g0:g0 + n_grp] += 1
        read[kind][m, t, 16 * g0:16 * g0 + n_read] += 1
        dead_scales[m] += dead
    assert (written["fresh"] == 1).all()
    for t in range(ntc):
        assert (written["cache"][:, t] == int(live[t])).all(), t
    for kind, n, T, rows in (("cache", ntc, tk, S), ("fresh", ntf, tf, Lf)):
        for t in range(n):
            has = min(T, rows - t * T)
            want = int(kind == "fresh" or live[t])
            assert (read[kind][:, t, :has] == want).all(), (kind, t)
            assert not read[kind][:, t, has:].any(), (kind, t)
    assert (dead_scales == 1).all()


def _rgb_im2col(x, cache, C, taps_t, tau0):
    """A [B, T, H, W, 96] as the narrow route's threads build it: the
    timeline zero padded by one pixel, seen as rows of (W + 2) C values;
    k < 9 C taps_t reads row (kt, di) = divmod(k // 3C, 3) at element
    C w + k % 3C of frame t + tau0 + kt, image row h + di; the rest are
    zeros."""
    B, T, H, W, _ = x.shape
    tl = F.pad(torch.cat([cache, x], dim=1).double(), (0, 0, 1, 1, 1, 1))
    rows = tl.reshape(B, T + 2, H + 2, (W + 2) * C)
    A = torch.zeros(B, T, H, W, cc.RGB_K, dtype=torch.float64)
    ws = torch.arange(W)
    for k in range(9 * C * taps_t):
        kt, di = divmod(k // (3 * C), 3)
        e = k % (3 * C)
        for t in range(T):
            A[:, t, :, :, k] = rows[:, t + tau0 + kt, di:di + H,
                                    C * ws + e]
    return A


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("taps_t,tau0", [(3, 0), (1, 0), (1, 2)])
def test_rgb_packed_weight_matches_plain_conv(C, taps_t, tau0):
    """The narrow route's K order: the im2col of a random timeline through
    the packed weight (from k = 9 C tau0, as the kernel loads it), plus
    the bias, equals the plain conv (27 taps, or one temporal tap)."""
    rng = np.random.default_rng(40 + C)
    B, T, H, W, Cout = 1, 3, 5, 7, 6
    x = torch.from_numpy(rng.standard_normal((B, T, H, W, C))).float()
    cache = torch.from_numpy(rng.standard_normal((B, 2, H, W, C))).float()
    w = torch.from_numpy(0.2 * rng.standard_normal((Cout, C, 3, 3, 3))) \
        .float().to(torch.bfloat16).float()
    b = torch.from_numpy(0.1 * rng.standard_normal(Cout)).float()
    wp = cc.rgb_weight(w)
    assert wp.shape == (Cout, cc.RGB_K) and wp.dtype == torch.bfloat16
    assert not wp[:, 27 * C:].any()
    k0 = 9 * C * tau0
    wk = torch.zeros(Cout, cc.RGB_K, dtype=torch.float64)
    wk[:, :9 * C * taps_t] = wp[:, k0:k0 + 9 * C * taps_t].double()
    out = _rgb_im2col(x, cache, C, taps_t, tau0) @ wk.T + b.double()
    ref = (tconv.conv3d_ref(x, cache, w, b) if taps_t == 3
           else tconv.conv2d_tap_ref(x, cache, w, b, tau0))
    torch.testing.assert_close(out.float(), ref, rtol=1e-5, atol=1e-5)
    assert cc.rgb_weight(w) is wp
    plan = cc.conv_plan(B, T, H, W, C, Cout, taps_t, 132)
    assert plan == dict(route="narrow", bn=0, tiles=None, ksteps=None,
                        splits=1, grid=0)


def test_conv_plan_pads_other_narrow_widths_to_the_wide_route():
    """C % 8 != 0 above 3 channels: the wide route's plan at C rounded up
    to 8 (the wrapper zero pads the activations)."""
    for C in (4, 5, 12, 30):
        C8 = _cdiv(C, 8) * 8
        assert cc.conv_plan(1, 2, 9, 70, C, 96, 3, 132) == \
            cc.conv_plan(1, 2, 9, 70, C8, 96, 3, 132)
        assert cc.conv_plan(1, 2, 9, 70, C, 96, 3, 132)["route"] == "wide"
