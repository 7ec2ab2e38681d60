"""The float32 kernels' host-side code and models of their arithmetic on
the CPU, where no kernel runs: the tf32 split of the conv weights
(``cuda_conv.split_tf32`` / ``f32_weight``), the float32 conv's plan and
work items (csrc/conv3d.cu, ``conv_igemm_f32``), and models of both
kernels' 3xTF32 products that follow their indexing: the window
attention's pre-pass layout (V^T stored 0, 2, 4, 6, 1, 3, 5, 7 within
each group of 8 keys), its P fragments and its folded O chains
(csrc/decode_fresh.cu, ``window_split_f32`` and
``decode_window_f32_kernel``), and the conv's per-K-step chains on the
wrapper's split weights.  Each model is held to the plain version
(``decode_window_ref`` / ``conv3d_ref``), which ``tests/test_torch_
attention.py`` and ``tests/test_torch_conv.py`` hold to the JAX package;
the card tests run the kernels themselves."""
import math

import numpy as np
import pytest
import torch

from self_forcing_tpu_torch.ops import conv as tconv
from self_forcing_tpu_torch.ops import cuda_attention as ca
from self_forcing_tpu_torch.ops import cuda_conv as cc

# csrc/decode_fresh.cu: keys a stage (wf::BK), stages an O chain sums
# (wf::FLUSH)
BK, FLUSH = 32, 32
LOG2E = 1.4426950408889634


def _parts(x):
    """The tf32 parts of float32 ``x`` as float64 (exact)."""
    big, small = cc.split_tf32(x.float())
    return big.double(), small.double()


# ------------------------------------------------------------ the split

@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7e4])
def test_split_tf32_parts_are_the_nearest_tf32_values(scale):
    """big is the tf32 value nearest x (ties away from zero), small the
    one nearest x - big: both float32 words with their low 13 mantissa
    bits zero, and big + small within 2^-22 of |x|."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(4096, generator=g) * scale
    big, small = cc.split_tf32(x)
    for part in (big, small):
        assert part.dtype == torch.float32
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    xd, bd, sd = x.double(), big.double(), small.double()
    ulp = torch.exp2(torch.floor(torch.log2(xd.abs())) - 10)
    assert ((xd - bd).abs() <= ulp / 2).all()
    assert ((xd - bd - sd).abs() <= 2.0 ** -22 * xd.abs()).all()


def test_split_tf32_rounds_ties_away_from_zero():
    """At a tie (the dropped bits exactly half a tf32 step) big takes the
    larger magnitude, as cvt.rna does; the residual is then exact."""
    ties = np.array([0x3F801000, 0xBF801000, 0x3F803000], np.uint32)
    x = torch.from_numpy(ties.view(np.int32)).view(torch.float32)
    big, small = cc.split_tf32(x)
    want = np.array([0x3F802000, 0xBF802000, 0x3F804000], np.uint32)
    assert torch.equal(big.view(torch.int32),
                       torch.from_numpy(want.view(np.int32)))
    assert torch.equal(big.double() + small.double(), x.double())


def test_f32_weight_is_made_once_per_parameter():
    """The kernel's weights, [Cout, 27, Cp] (Cp = C rounded up to 4,
    taps in (kt, di, dj) order) in big and small parts that sum back to
    the float32 weight, made once and again after an in-place write."""
    g = torch.Generator().manual_seed(8)
    w = torch.randn(5, 6, 3, 3, 3, generator=g)
    big, small = cc.f32_weight(w)
    assert big.shape == small.shape == (5, 27, 8)
    wk = w.permute(0, 2, 3, 4, 1).reshape(5, 27, 6).double()
    both = big[..., :6].double() + small[..., :6].double()
    torch.testing.assert_close(both, wk, rtol=2.0 ** -21, atol=0)
    assert (big[..., 6:] == 0).all() and (small[..., 6:] == 0).all()
    assert cc.f32_weight(w)[0] is big
    with torch.no_grad():
        w.mul_(2)
    assert torch.equal(cc.f32_weight(w)[0], 2 * big)


# ------------------------------------------------------- the conv's plan

def _f32_items(B, T, H, W, C, Cout, taps_t, bn, splits):
    """conv_igemm_f32's work items as decode_item lists them (split
    fastest, then channel tile, column tile, row tile, frame): (b, t, h0,
    w0, n0, k0, k1, s), K steps of CK_F32 channels of C rounded up to 4."""
    mt, wt, nt = -(-H // cc.TR), -(-W // cc.TW), -(-Cout // bn)
    ks = taps_t * -(-(-(-C // 4) * 4) // cc.CK_F32)
    for i in range(B * T * mt * wt * nt * splits):
        s, r = i % splits, i // splits
        n, r = r % nt, r // nt
        w, r = r % wt, r // wt
        h, fr = r % mt, r // mt
        yield (fr // T, fr % T, h * cc.TR, w * cc.TW, n * bn,
               s * ks // splits, (s + 1) * ks // splits, s)


@pytest.mark.parametrize("B,T,H,W,C,Cout,taps_t", [
    (1, 4, 9, 70, 96, 96, 3),      # bn 96, two column tiles
    (1, 1, 8, 64, 384, 96, 3),     # 15 K splits
    (1, 2, 9, 10, 16, 384, 3),     # bn 64, 3 K splits
    (1, 1, 5, 16, 96, 32, 1),      # bn 32, one temporal tap, 6 K splits
    (2, 3, 7, 13, 3, 96, 3),       # C % 4 != 0: padded to 4 channels
])
def test_f32_conv_items_cover_every_pixel_and_k_step_once(B, T, H, W, C,
                                                          Cout, taps_t):
    """The float32 conv's items at conv_plan(f32=True)'s tile and split:
    every output pixel, output channel and K step (temporal tap x 16
    channels) belongs to exactly one item, each item's K steps a
    non-empty run, and the grid is no larger than the items."""
    plan = cc.conv_plan(B, T, H, W, C, Cout, taps_t, 132, f32=True)
    bn, splits = plan["bn"], plan["splits"]
    assert plan["route"] == "wide" and bn in (96, 64, 32)
    assert plan["ksteps"] == taps_t * -(-(-(-C // 4) * 4) // cc.CK_F32)
    ks = plan["ksteps"]
    count = np.zeros((B, T, H, W, Cout, ks), np.int32)
    items = list(_f32_items(B, T, H, W, C, Cout, taps_t, bn, splits))
    for b, t, h0, w0, n0, k0, k1, s in items:
        assert 0 <= k0 < k1 <= ks and 0 <= s < splits
        count[b, t, h0:h0 + cc.TR, w0:w0 + cc.TW, n0:n0 + bn, k0:k1] += 1
    assert (count == 1).all()
    assert len(items) == plan["tiles"] * splits
    assert 1 <= plan["grid"] == min(len(items), 132)


def test_f32_conv_plan_at_the_vae_shapes():
    """Every float32 conv takes the wide route, the RGB input too (at 4
    channels); 96-channel tiles where 96 divides Cout (the running sums
    beside the chains hold twice the accumulators, so no 128 or 192), the
    384 -> 32 head a K split, the phase-2 shape none."""
    def plan(*shape, taps_t=3):
        p = cc.conv_plan(*shape, taps_t, 132, f32=True)
        return p["route"], p["bn"], p["splits"]

    assert plan(1, 4, 480, 832, 96, 96) == ("wide", 96, 1)
    assert plan(1, 4, 480, 832, 3, 96) == ("wide", 96, 1)
    assert plan(1, 4, 480, 832, 96, 3) == ("wide", 32, 1)
    assert plan(1, 2, 120, 208, 384, 384) == ("wide", 96, 1)
    assert plan(1, 1, 60, 104, 384, 32) == ("wide", 32, 4)
    assert plan(1, 1, 60, 104, 384, 384, taps_t=1) == ("wide", 96, 1)


# ------------------------------------------------------ the conv's model

def _conv_model(x, cache, w, b, taps_t, tau0):
    """conv_igemm_f32's arithmetic: the wrapper's channel padding and
    split weights, each halo element split once, each K step (temporal
    tap kt, 16 channels from c0) one chain over its 9 spatial taps of
    small_x big_w + big_x small_w + big_x big_w, added to the running sum;
    + bias.  float64 sums of the tf32 parts' exact products."""
    B, T, H, W, C = x.shape
    pad = -C % 4
    tl = torch.cat([cache, x], dim=1)
    tl = torch.nn.functional.pad(tl, (0, pad, 1, 1, 1, 1))
    xb, xs = _parts(tl)
    wb, ws = (p.double() for p in cc.f32_weight(w))
    run = torch.zeros(B, T, H, W, w.shape[0], dtype=torch.float64)
    for kt in range(taps_t):
        for c0 in range(0, C + pad, cc.CK_F32):
            chain = 0
            for s in range(9):
                di, dj = divmod(s, 3)
                tap, c = 9 * (kt + tau0) + s, slice(c0, c0 + cc.CK_F32)
                f = slice(tau0 + kt, tau0 + kt + T)
                ab = xb[:, f, di:di + H, dj:dj + W, c]
                asm = xs[:, f, di:di + H, dj:dj + W, c]
                chain = chain + (asm @ wb[:, tap, c].T + ab @ ws[:, tap, c].T
                                 + ab @ wb[:, tap, c].T)
            run = run + chain
    return run if b is None else run + b.double()


@pytest.mark.parametrize("B,T,H,W,C,Cout,taps_t,tau0", [
    (1, 2, 5, 7, 24, 8, 3, 0),     # two K steps a temporal tap
    (1, 2, 4, 6, 6, 5, 3, 0),      # C % 4 != 0, odd Cout
    (1, 2, 4, 5, 16, 8, 1, 0),     # taps_t 1 at each frame offset
    (1, 2, 4, 5, 16, 8, 1, 1),
    (2, 1, 4, 5, 16, 8, 1, 2),
])
def test_f32_conv_model_matches_plain(B, T, H, W, C, Cout, taps_t, tau0):
    """The conv model on float32 operands with full mantissas against the
    plain float32 conv (27 taps, or one tap at tau0): 1e-5 relative L2
    (each 3xTF32 product within ~2^-21 of the exact one)."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(B, T, H, W, C, generator=g)
    cache = torch.randn(B, 2, H, W, C, generator=g)
    w = torch.randn(Cout, C, 3, 3, 3, generator=g) * (27 * C) ** -0.5
    b = torch.randn(Cout, generator=g) * 0.1
    got = _conv_model(x, cache, w, b, taps_t, tau0)
    ref = (tconv.conv3d_ref(x, cache, w, b) if taps_t == 3
           else tconv.conv2d_tap_ref(x, cache, w, b, tau0)).double()
    assert float((got - ref).norm() / ref.norm()) < 1e-5


# ------------------------------------------------ the window's model

def _vt_keys(S_pad):
    """The key the pre-pass stores at each V^T position: within each
    group of 8 keys, 0, 2, 4, 6, 1, 3, 5, 7 (position 4 q + e of a stage
    holds key 8 (q // 2) + q % 2 + 2 e)."""
    p = torch.arange(S_pad)
    pos = p % BK
    q, e = pos // 4, pos % 4
    return p - pos + 8 * (q // 2) + q % 2 + 2 * e


def _a_keys():
    """The key of each k-column of a stage's P.V A operand: a thread's
    accumulators s[4 i + e] (columns 8 i + 2 t + e % 2) packed as
    (s[4 i], s[4 i + 2], s[4 i + 1], s[4 i + 3]) make k-column t of step
    i key 8 i + 2 t and k-column t + 4 key 8 i + 2 t + 1."""
    kc = torch.arange(BK)
    i, c = kc // 8, kc % 8
    return 8 * i + 2 * (c % 4) + c // 4


def _window_model(q, k, v, lo, hi, scale, flush=FLUSH):
    """decode_window_f32's arithmetic on folded q [BN, Lq, D] and caches
    [BN, S, D]: the pre-pass (keys outside [lo, hi) zeroed; K and V^T in
    tf32 parts, V^T in its stored order), then per 32-key stage S in
    3xTF32, the online softmax in base 2, P.V from P's parts in the A
    operand's k-column order against V^T's stored rows, each O chain of
    `flush` stages folded into out (out = out 2^(mf - m) + O), the last
    fold divided by l.  float64 sums of the tf32 parts' exact products."""
    BN, S, D = k.shape
    lo, hi = max(lo, 0), min(hi, S)
    if lo >= hi:
        return torch.zeros(q.shape, dtype=torch.float64)
    S_pad = -(-S // BK) * BK
    j = torch.arange(S)
    keep = ((j >= lo) & (j < hi)).view(1, S, 1)
    kz = torch.zeros(BN, S_pad, D)   # TMA reads zeros past S
    kz[:, :S] = k * keep
    kb, ks = _parts(kz)
    vt = torch.zeros(BN, D, S_pad)
    vt[:, :, :S] = (v * keep).transpose(1, 2)
    vb, vs = _parts(vt[:, :, _vt_keys(S_pad)])
    qb, qs = _parts(q)
    mul = scale * LOG2E
    m = torch.full(q.shape[:2], -math.inf, dtype=torch.float64)
    l = torch.zeros(q.shape[:2], dtype=torch.float64)
    mf, out, o = m.clone(), None, 0
    since, prev = 0, None

    def pv(p, t):
        pb, ps = _parts(p[..., _a_keys()].float())
        c = slice(t * BK, (t + 1) * BK)
        vbt, vst = vb[:, :, c].transpose(1, 2), vs[:, :, c].transpose(1, 2)
        return ps @ vbt + pb @ vst + pb @ vbt

    for t in range(lo // BK, -(-hi // BK)):
        c = slice(t * BK, (t + 1) * BK)
        s = (qs @ kb[:, c].transpose(1, 2) + qb @ ks[:, c].transpose(1, 2)
             + qb @ kb[:, c].transpose(1, 2))
        jj = torch.arange(t * BK, (t + 1) * BK)
        s[..., (jj < lo) | (jj >= hi)] = -math.inf
        m_new = torch.maximum(m, s.max(-1).values * mul)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * mul - m_new[..., None])
        l = l * corr + p.sum(-1)
        if prev is not None:   # the previous stage's P.V, issued with S
            o = (o + pv(*prev)) * corr[..., None]
            since += 1
            if since == flush:
                out = o if out is None else (
                    out * torch.exp2(mf - m_new)[..., None] + o)
                mf, o, since = m_new, 0, 0
        m, prev = m_new, (p, t)
    o = o + pv(*prev)
    if out is not None:
        o = out * torch.exp2(mf - m)[..., None] + o
    return o / l.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("Lq,S,lo,hi,flush", [
    (20, 300, 37, 291, FLUSH),     # bounds inside stages, no fold
    (9, 1400, 5, 1390, FLUSH),     # 44 stages: one fold at 32
    (9, 700, 0, 700, 3),           # a fold every 3 stages
    (9, 64, 40, 41, 3),            # one key
])
def test_window_f32_model_matches_plain(Lq, S, lo, hi, flush):
    """The window model against ``decode_window_ref`` (float32): 1e-5
    relative L2.  A V^T order that did not match the A operand's k-column
    order, or a fold at the wrong max, would be off by O(1)."""
    g = torch.Generator().manual_seed(10)
    BN, D = 2, 128
    q = torch.randn(BN, Lq, D, generator=g)
    k = torch.randn(BN, S, D, generator=g)
    v = torch.randn(BN, S, D, generator=g)
    got = _window_model(q, k, v, lo, hi, D ** -0.5, flush)
    ref = ca.decode_window_ref(q, k, v, lo, hi).double()
    assert float((got - ref).norm() / ref.norm()) < 1e-5


def test_window_f32_orders_pair_up():
    """The pre-pass's V^T order and the A operand's k-column order are
    the same permutation of each stage's 32 keys, so k-column c multiplies
    V^T row position c: key for key."""
    assert torch.equal(_vt_keys(BK), _a_keys())
    assert sorted(_a_keys().tolist()) == list(range(BK))
