"""The port's CUDA kernels (attention, the W8A8 linears and the VAE's
causal convs) against their plain PyTorch versions, on the card.  Small and ragged shapes (edges the
main path's shapes do not reach) plus the 1.3B shapes.

These tests need an NVIDIA Hopper card and nvcc; they skip elsewhere.  On
a machine with the card (where JAX is not installed) run them with

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from self_forcing_tpu_torch.ops import attention
from self_forcing_tpu_torch.ops import conv as tconv
from self_forcing_tpu_torch.ops import cuda_attention as ca
from self_forcing_tpu_torch.ops import cuda_conv as cc
from self_forcing_tpu_torch.ops import cuda_matmul as cm
from self_forcing_tpu_torch.ops import quant
from self_forcing_tpu_torch.utils.tree import map_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _bf16(g, *shape, dev, scale=1.0):
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


@pytest.mark.parametrize(
    "B,N,Lq,Lf,S,lo,hi,sink,static_hi,li",
    [
        (1, 2, 100, 100, 256, 0, 0, 0, 0, 0),          # empty cache
        (2, 2, 130, 70, 512, 64, 300, 0, None, 1),     # ragged tiles
        (1, 3, 64, 64, 640, 200, 500, 70, 512, 2),     # sink + window
        (1, 1, 33, 17, 128, 10, 128, 130, None, 0),    # sink past kv_end
    ])
def test_decode_fresh_free_matches_plain(dev, B, N, Lq, Lf, S, lo, hi, sink,
                                         static_hi, li):
    """Tolerance 1e-2 relative L2: both round p to bf16, but the two
    may round it on either side for scores summed in another order."""
    g = torch.Generator(device=dev).manual_seed(0)
    D = 128
    q = _bf16(g, B, Lq, N * D, dev=dev, scale=0.12)
    kc = _bf16(g, 3, B * N, S, D, dev=dev)
    vc = _bf16(g, 3, B * N, S, D, dev=dev)
    kn = _bf16(g, B, Lf, N * D, dev=dev)
    vn = _bf16(g, B, Lf, N * D, dev=dev)
    args = dict(layer_idx=li, kv_start=lo, kv_end=hi, sink_end=sink,
                static_hi=static_hi, num_heads=N)
    out = ca.decode_fresh_free(q, kc, vc, kn, vn, **args)
    ref = ca.decode_fresh_free_ref(q, kc, vc, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2


DECODE_CASES = [
    (1, 2, 100, 100, 256, 0, 0, 0, 0, 0),          # empty cache
    (2, 2, 130, 70, 512, 64, 300, 0, None, 1),     # ragged tiles
    (1, 3, 64, 64, 640, 200, 500, 70, 512, 2),     # sink + window
]


def _score_bound(q, kc, kn, li, lo, hi, sink, N, slack):
    """The DiT's Cauchy-Schwarz bound over the visible keys, plus slack,
    as a float32 tensor on the card."""
    D = 128
    B, Lq, _ = q.shape
    rows = torch.cat([torch.arange(sink), torch.arange(lo, hi)]).to(q.device)
    kmax = kn.float().reshape(B, -1, N, D).norm(dim=-1).amax()
    if rows.numel():
        kmax = torch.maximum(kmax, kc[li][:, rows].float().norm(dim=-1).amax())
    qmax = q.float().reshape(B, Lq, N, D).norm(dim=-1).amax()
    return D ** -0.5 * qmax * kmax + slack


@pytest.mark.parametrize("mode", ["free_noclamp", "bounded", "online"])
@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_decode_fresh_modes_match_plain(dev, mode, case):
    """The bounded (bound 3 nats loose), online and unclamped free modes
    against their plain versions.  Tolerance 1e-2 relative L2: the
    kernel rounds p to bf16 in every mode (the plain online version keeps
    it in float32, 2^-9 relative an element)."""
    B, N, Lq, Lf, S, lo, hi, sink, static_hi, li = DECODE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(10 + case)
    D = 128
    free = mode == "free_noclamp"
    q = _bf16(g, B, Lq, N * D, dev=dev,
              scale=D ** -0.5 * 1.4427 if free else 1.0)
    kc = _bf16(g, 3, B * N, S, D, dev=dev)
    vc = _bf16(g, 3, B * N, S, D, dev=dev)
    kn = _bf16(g, B, Lf, N * D, dev=dev)
    vn = _bf16(g, B, Lf, N * D, dev=dev)
    m0 = (_score_bound(q, kc, kn, li, lo, hi, sink, N, 3.0)
          if mode == "bounded" else None)
    args = dict(mode=mode, m0=m0, layer_idx=li, kv_start=lo, kv_end=hi,
                sink_end=sink, static_hi=static_hi, num_heads=N,
                scale=1.0 if free else D ** -0.5)
    out = ca.decode_fresh(q, kc, vc, kn, vn, **args)
    ref = ca.decode_fresh_ref(q, kc, vc, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2, _rel_l2(out, ref)


@pytest.mark.parametrize("B,N,Lq,Lk", [(1, 2, 100, 512), (2, 1, 65, 257),
                                       (1, 2, 64, 1), (1, 1, 70, 1024)])
def test_cross_attention_matches_plain(dev, B, N, Lq, Lk):
    """Tolerance 2e-3 relative L2: p.v keeps ~16 mantissa bits of p, the
    output is rounded to bf16 (2^-9 relative) in both."""
    g = torch.Generator(device=dev).manual_seed(1)
    D = 128
    q = _bf16(g, B, Lq, N * D, dev=dev)
    k = _bf16(g, B, Lk, N, D, dev=dev)
    v = _bf16(g, B, Lk, N, D, dev=dev)
    out = ca.cross_attention(q, k, v, num_heads=N)
    ref = ca.cross_attention_ref(q, k, v, num_heads=N)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 2e-3


def _decode_operands(g, dev, B, N, Lq, Lf, S, layers=3, q_scale=0.12):
    D = 128
    return (_bf16(g, B, Lq, N * D, dev=dev, scale=q_scale),
            _bf16(g, layers, B * N, S, D, dev=dev),
            _bf16(g, layers, B * N, S, D, dev=dev),
            _bf16(g, B, Lf, N * D, dev=dev), _bf16(g, B, Lf, N * D, dev=dev))


@pytest.mark.parametrize("kv_end", [0, 28080])
def test_decode_fresh_free_at_the_1p3b_geometry(dev, kv_end):
    """One layer at the Wan-1.3B shapes of the sampler: 4680 queries, 12
    heads, the fresh block's 4680 keys and the cache up to kv_end (0:
    block 1; 28080: block 7) of a 32760-token buffer; q carries the folded
    head_dim**-0.5 * log2(e).  Tolerance 1e-2 relative L2."""
    g = torch.Generator(device=dev).manual_seed(40)
    q, kc, vc, kn, vn = _decode_operands(g, dev, 1, 12, 4680, 4680, 32760,
                                         layers=1,
                                         q_scale=128 ** -0.5 * 1.4427)
    args = dict(layer_idx=0, kv_start=0, kv_end=kv_end, sink_end=0,
                static_hi=kv_end, num_heads=12)
    out = ca.decode_fresh_free(q, kc, vc, kn, vn, **args)
    ref = ca.decode_fresh_free_ref(q, kc, vc, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2, _rel_l2(out, ref)


@pytest.mark.parametrize("mode", list(ca.DECODE_MODES))
@pytest.mark.parametrize("Lq,Lf", [(4680, 200), (200, 1), (1, 200)])
def test_decode_fresh_ragged_lengths(dev, mode, Lq, Lf):
    """Lq and Lf multiples of neither 64 nor 128, two batches: the query
    tile past Lq and the fresh tile past Lf read zeros (never the next
    batch's rows) and rows past Lq are not written.  Tolerance 1e-2."""
    B, N, S = 2, 2, 640
    g = torch.Generator(device=dev).manual_seed(41)
    free = mode.startswith("free")
    q, kc, vc, kn, vn = _decode_operands(
        g, dev, B, N, Lq, Lf, S, q_scale=128 ** -0.5 * 1.4427 if free
        else 1.0)
    m0 = (_score_bound(q, kc, kn, 1, 130, 520, 10, N, 3.0)
          if mode == "bounded" else None)
    args = dict(mode=mode, m0=m0, layer_idx=1, kv_start=130, kv_end=520,
                sink_end=10, static_hi=None, num_heads=N,
                scale=1.0 if free else 128 ** -0.5)
    out = ca.decode_fresh(q, kc, vc, kn, vn, **args)
    ref = ca.decode_fresh_ref(q, kc, vc, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2, _rel_l2(out, ref)


# (sink_end, kv_start, kv_end, static_hi) with S = 1024: each bound
# inside a 128-key tile (70 in tile 0, 200 in 1, 900 in 7, 840 in 6)
STRADDLE_CASES = {"sink_start_end": (70, 200, 900, None),
                  "static_hi": (70, 200, 900, 840)}


@pytest.mark.parametrize("mode", list(ca.DECODE_MODES))
@pytest.mark.parametrize("case", list(STRADDLE_CASES))
def test_decode_fresh_tiles_straddling_each_bound(dev, mode, case):
    """Every mode where a key tile straddles sink_end, kv_start, kv_end or
    static_hi (the tiles that apply the mask; the others skip it).
    Tolerance 1e-2 relative L2."""
    sink, lo, hi, static_hi = STRADDLE_CASES[case]
    B, N, Lq, Lf, S = 1, 2, 130, 90, 1024
    g = torch.Generator(device=dev).manual_seed(42)
    free = mode.startswith("free")
    q, kc, vc, kn, vn = _decode_operands(
        g, dev, B, N, Lq, Lf, S, q_scale=128 ** -0.5 * 1.4427 if free
        else 1.0)
    m0 = (_score_bound(q, kc, kn, 2, lo, hi, sink, N, 3.0)
          if mode == "bounded" else None)
    args = dict(mode=mode, m0=m0, layer_idx=2, kv_start=lo, kv_end=hi,
                sink_end=sink, static_hi=static_hi, num_heads=N,
                scale=1.0 if free else 128 ** -0.5)
    out = ca.decode_fresh(q, kc, vc, kn, vn, **args)
    ref = ca.decode_fresh_ref(q, kc, vc, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2, _rel_l2(out, ref)


def _nan_tail(x, rows=128):
    """x [B, L, C] as a view of a buffer whose next ``rows`` rows are NaN."""
    B, L, C = x.shape
    buf = torch.full((B * L + rows, C), float("nan"), dtype=x.dtype,
                     device=x.device)
    buf[:B * L] = x.reshape(B * L, C)
    return buf[:B * L].view(B, L, C)


@pytest.mark.parametrize("mode", list(ca.DECODE_MODES))
@pytest.mark.parametrize("sink", [20, 0])
def test_decode_fresh_reads_nothing_outside_the_window(dev, mode, sink):
    """The cache rows no query may see are poisoned.  Those in a key tile
    the kernel loads (it must mask them) hold 3e4.  Every row it must
    never read holds NaN: the other two layers, the chosen layer's rows in
    tiles outside the window, and the rows past the fresh K/V's last
    batch.  A tile read across a bound (past S = 700, 5.5 tiles, into the
    next head's rows, which sink 0 leaves unread; the last head's into the
    next layer; past Lf beyond the last batch) then puts NaN into P.V
    (0 * NaN), which the isfinite check catches.  The output must equal
    the plain version's on copies with the poisoned rows zero, within the
    decode tolerance (1e-2 relative L2): the mask and the tensor maps'
    bounds keep them out."""
    B, N, Lq, Lf, S, li, lo = 2, 3, 150, 70, 700, 1, 300
    g = torch.Generator(device=dev).manual_seed(43)
    free = mode.startswith("free")
    q, kc, vc, kn, vn = _decode_operands(
        g, dev, B, N, Lq, Lf, S, q_scale=128 ** -0.5 * 1.4427 if free
        else 1.0)
    kn, vn = _nan_tail(kn), _nan_tail(vn)
    j = torch.arange(S, device=dev)
    j0 = j // 128 * 128   # the first key of j's tile
    layer = (torch.arange(3, device=dev) == li).view(3, 1, 1, 1)
    seen = layer & ((j < sink) | (j >= lo)).view(1, 1, S, 1)
    loaded = layer & ((j0 < sink) | (j0 + 128 > lo)).view(1, 1, S, 1)
    poisoned = [torch.where(seen, c, torch.where(
        loaded, torch.full_like(c, 3e4), torch.full_like(c, float("nan"))))
        for c in (kc, vc)]
    zeroed = [torch.where(seen, c, torch.zeros_like(c)) for c in (kc, vc)]
    m0 = (_score_bound(q, zeroed[0], kn, li, lo, S, sink, N, 3.0)
          if mode == "bounded" else None)
    args = dict(mode=mode, m0=m0, layer_idx=li, kv_start=lo, kv_end=S,
                sink_end=sink, static_hi=None, num_heads=N,
                scale=1.0 if free else 128 ** -0.5)
    out = ca.decode_fresh(q, *poisoned, kn, vn, **args)
    ref = ca.decode_fresh_ref(q, *zeroed, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2, _rel_l2(out, ref)


@pytest.mark.parametrize("B,N,Lq,Lk", [(1, 12, 4680, 512)]
                         + [(2, 2, 200, lk) for lk in (1, 77, 257, 512, 1024)])
def test_cross_attention_key_lengths(dev, B, N, Lq, Lk):
    """The cross attention at the 1.3B geometry (4680 queries, 12 heads,
    512 text tokens) and at every key count class: one key, ragged tiles,
    the CLIP tokens, two full 128-key tiles... up to the 1024 limit.
    Tolerance 2e-3 relative L2."""
    g = torch.Generator(device=dev).manual_seed(44)
    D = 128
    q = _bf16(g, B, Lq, N * D, dev=dev)
    k = _bf16(g, B, Lk, N, D, dev=dev)
    v = _bf16(g, B, Lk, N, D, dev=dev)
    out = ca.cross_attention(q, k, v, num_heads=N)
    ref = ca.cross_attention_ref(q, k, v, num_heads=N)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 2e-3, _rel_l2(out, ref)


def test_cross_attention_i2v_pair(dev):
    """The i2v DiT's cross attention at Wan-I2V-14B's shapes: 32760
    heads-packed queries, 40 heads, one call onto the 512 text keys and
    one onto the 257 image keys, summed (two softmaxes).  Each call and
    the sum within 2e-3 relative L2 of the plain version."""
    g = torch.Generator(device=dev).manual_seed(45)
    N, D, Lq = 40, 128, 32760
    q = _bf16(g, 1, Lq, N * D, dev=dev)
    outs, refs = [], []
    for Lk in (512, 257):
        k = _bf16(g, 1, Lk, N, D, dev=dev)
        v = _bf16(g, 1, Lk, N, D, dev=dev)
        outs.append(ca.cross_attention(q, k, v, num_heads=N))
        refs.append(ca.cross_attention_ref(q, k, v, num_heads=N))
        torch.cuda.synchronize()
        assert torch.isfinite(outs[-1].float()).all()
        assert _rel_l2(outs[-1], refs[-1]) < 2e-3, (Lk, _rel_l2(
            outs[-1], refs[-1]))
    assert _rel_l2(outs[0] + outs[1], refs[0] + refs[1]) < 2e-3


# (B, N, Lq, Lf, S, lo, hi, sink, static_hi, tiles or tk_align)
INT8QK_CASES = {
    # ragged Lq and Lf against 100-row q tiles and 96-row fresh tiles;
    # 216-row cache tiles, the last one past S
    "ragged": (2, 2, 130, 70, 640, 64, 300, 0, None, (100, 216, 96)),
    # sink + window, frame-aligned windowed tiles (tk_align 64 -> 128)
    "sink_window": (1, 3, 150, 150, 640, 320, 576, 64, None, 64),
    # the global tiles of decode_tiles (264, 224, 224): 64-key CUDA tiles
    # straddle two cache tiles; static_hi inside the window
    "global": (1, 2, 260, 200, 1100, 0, 700, 0, 650, None),
    # 40-row cache and 48-row fresh tiles: a 128-key stage meets three or
    # four k-scale tiles
    "three_k_tiles": (1, 2, 200, 300, 512, 0, 400, 0, None, (64, 40, 48)),
    # 100-row q tiles: 64-row consumer tiles straddle two q tiles
    "q_straddle": (2, 1, 330, 128, 384, 0, 256, 0, None, (100, 128, 128)),
    # windowed, frame-aligned cache tiles of 96 rows (7 frames: tk = the
    # frame, not a multiple of 128); the stage at the sink's end reads a
    # dead tile's unwritten rows
    "windowed_frames": (1, 3, 150, 150, 672, 288, 576, 96, None, 96),
    # the 14B model's 40 heads
    "heads_40": (1, 40, 100, 64, 256, 0, 200, 0, None, (64, 128, 64)),
    # q, cache and fresh tiles of fewer rows than the pre-pass's cluster
    # of 8 CTAs: some CTAs take no row
    "short_tiles": (1, 2, 40, 17, 128, 0, 100, 0, None, (7, 6, 5)),
    # windowed, frame-aligned cache tiles of two 120-row frames (tk 240):
    # each of the 8 CTAs of a tile's cluster holds 30 of its rows, so a
    # frame spans four of them
    "windowed_wide_frames": (1, 2, 150, 150, 960, 480, 840, 120, None, 120),
}


def _int8qk_tiles(case, Lq, S, Lf):
    tiles = INT8QK_CASES[case][-1]
    if isinstance(tiles, tuple):
        return tiles
    return attention.decode_tiles(Lq, S, Lf, "int8qk", "free", tiles,
                                  tk=256)


def _int8qk_inputs(g, dev, B, N, Lq, Lf, S):
    D = 128
    q = _bf16(g, B, Lq, N * D, dev=dev, scale=D ** -0.5 * 1.4427)
    kc = _bf16(g, 3, B * N, S, D, dev=dev)
    vc = _bf16(g, 3, B * N, S, D, dev=dev)
    kn = _bf16(g, B, Lf, N * D, dev=dev)
    vn = _bf16(g, B, Lf, N * D, dev=dev)
    return q, kc, vc, kn, vn


@pytest.mark.parametrize("case", list(INT8QK_CASES))
def test_decode_fresh_int8qk_matches_plain(dev, case):
    """The pre-pass gives the plain version's int8 values and scales
    exactly (true division, half to even; the dead cache tiles' rows are
    not written and not compared).  The attention: 1e-2 relative L2, as
    decode_fresh_free (both round p to bf16; the scores are exact
    integers times the same scales, but exp2 differs by an ulp)."""
    B, N, Lq, Lf, S, lo, hi, sink, static_hi, _ = INT8QK_CASES[case]
    tq, tk, tf = _int8qk_tiles(case, Lq, S, Lf)
    g = torch.Generator(device=dev).manual_seed(6)
    q, kc, vc, kn, vn = _int8qk_inputs(g, dev, B, N, Lq, Lf, S)
    win = dict(layer_idx=1, kv_start=lo, kv_end=hi, sink_end=sink,
               static_hi=static_hi, num_heads=N, tq=tq, tk=tk, tf=tf)
    qq = ca.int8qk_quantize(q, kc, kn, **win)
    qq_ref = ca.int8qk_quantize_ref(q, kc, kn, **win)
    torch.cuda.synchronize()
    live = torch.tensor(ca.live_cache_tiles(qq.ksc.shape[1], tk, lo, hi,
                                            sink), device=dev)
    rows = live.repeat_interleave(tk)
    for name in ("q8", "qs", "ksc", "kn8", "ksf"):
        torch.testing.assert_close(getattr(qq, name), getattr(qq_ref, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(qq.kc8[:, rows], qq_ref.kc8[:, rows], rtol=0,
                               atol=0)
    out = ca.decode_fresh_int8qk(q, kc, vc, kn, vn, **win)
    ref = ca.decode_fresh_int8qk_ref(q, kc, vc, kn, vn, **win)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2


def test_int8qk_dead_gap_does_not_move_the_output(dev):
    """Poison in the dead gap [sink_end, kv_start) (whole frame-aligned
    tiles) is never read: the output stays bit for bit."""
    B, N, Lq, Lf, S = 1, 2, 150, 150, 640
    tq, tk, tf = attention.decode_tiles(Lq, S, Lf, "int8qk", "free", 64,
                                        tk=256)
    g = torch.Generator(device=dev).manual_seed(7)
    q, kc, vc, kn, vn = _int8qk_inputs(g, dev, B, N, Lq, Lf, S)
    win = dict(layer_idx=2, kv_start=384, kv_end=640, sink_end=128,
               num_heads=N, tq=tq, tk=tk, tf=tf)
    out = ca.decode_fresh_int8qk(q, kc, vc, kn, vn, **win)
    kc[2, :, 128:384] = 1e4
    vc[2, :, 128:384] = float("nan")
    poisoned = ca.decode_fresh_int8qk(q, kc, vc, kn, vn, **win)
    torch.cuda.synchronize()
    torch.testing.assert_close(poisoned, out, rtol=0, atol=0)


# (B, N, Lq, S, kv_start, kv_end, sink_end)
DECODE_BWD_CASES = {
    "sink_window": (1, 3, 600, 2048, 900, 1700, 130),
    "block1_empty_window": (2, 2, 520, 1024, 0, 0, 0),
}


@pytest.mark.parametrize("case", list(DECODE_BWD_CASES))
def test_decode_fresh_bwd_matches_plain(dev, case):
    """SDPA's backward on the gathered visible keys (bf16, the rollout's
    operands) against the fp32 plain version: 2e-2 relative L2 per
    gradient, as the flash backward (bf16 products and p, ds rounded to
    bf16 where the plain version keeps fp32); and the seam's gradient
    with the kernels goes through it (one count a backward)."""
    B, N, Lq, S, lo, hi, sink = DECODE_BWD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(41)
    q, kc, vc, kn, vn = _decode_operands(g, dev, B, N, Lq, Lq, S,
                                         q_scale=1.0)
    go = _bf16(g, B, Lq, N * 128, dev=dev)
    kw = dict(layer_idx=1, kv_start=lo, kv_end=hi, sink_end=sink,
              num_heads=N, scale=128 ** -0.5)
    ca.reset_launch_counts()
    got = ca.decode_fresh_bwd(q, kc, vc, kn, vn, go, **kw)
    want = ca.decode_fresh_bwd_ref(q, kc, vc, kn, vn, go, **kw)
    torch.cuda.synchronize()
    assert ca.launch_counts["decode_fresh_bwd"] == 1
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert _rel_l2(a, b) < 2e-2, _rel_l2(a, b)
    grads = []
    for kernels in (True, False):
        ts = [t.clone().requires_grad_() for t in (q, kn, vn)]
        out = attention.decode_attention_fresh(
            ts[0], kc, vc, ts[1], ts[2], lo, hi, layer_idx=1,
            heads_packed=N, sink_end=sink, kernels=kernels)
        out.backward(go)
        grads.append([t.grad for t in ts])
    assert ca.launch_counts["decode_fresh_bwd"] == 2
    for a, b in zip(*grads):
        assert _rel_l2(a, b) < 2e-2, _rel_l2(a, b)


def test_cross_attention_bwd_matches_plain(dev):
    """The cross backward (SDPA's on the [B, N, L, D] views, bf16) against
    the fp32 plain version at Lk 512: 2e-2 relative L2."""
    g = torch.Generator(device=dev).manual_seed(42)
    B, N, Lq, Lk = 1, 3, 900, 512
    q = _bf16(g, B, Lq, N * 128, dev=dev)
    k, v = (_bf16(g, B, Lk, N, 128, dev=dev) for _ in range(2))
    go = _bf16(g, B, Lq, N * 128, dev=dev)
    ca.reset_launch_counts()
    got = ca.cross_attention_bwd(q, k, v, go, num_heads=N)
    want = ca.cross_attention_bwd_ref(q, k, v, go, num_heads=N)
    torch.cuda.synchronize()
    assert ca.launch_counts["cross_attention_bwd"] == 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        assert _rel_l2(a, b) < 2e-2, _rel_l2(a, b)


# the int8-QK cases and the edges of the full-int8 kernel's tile-relative
# 128-key stages
INT8_CASES = {
    **INT8QK_CASES,
    # tk 200 and tf 72: each Pallas tile walked from its first key, the
    # last stage partial; fresh tiles of less than one stage
    "tiles_off_128": (1, 2, 300, 250, 1000, 0, 900, 0, None,
                      (100, 200, 72)),
    # one 512-row cache tile holds the sink [0, 100), a dead gap and the
    # window from 300: stages straddle sink_end and kv_start, one is dead
    "sink_tile_straddles_window": (1, 2, 200, 150, 1024, 300, 900, 100,
                                   None, (96, 512, 160)),
    # whole dead cache tiles [128, 384) between the sink and the window
    "dead_gap": (1, 2, 150, 150, 640, 384, 640, 128, None, (64, 128, 96)),
    # 2 batches x 12 heads x 10 query tiles: 240 items, more than the
    # card's SMs, so persistent CTAs take several
    "more_items_than_sms": (2, 12, 1200, 300, 2048, 0, 1500, 0, None,
                            None),
}


@pytest.mark.parametrize("mode", ["tile", "global", "online"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_decode_fresh_int8_matches_plain(dev, mode, case):
    """Full int8 (quant='int8'): the V pre-pass gives the plain version's
    K-major int8 values and scales exactly (dead cache tiles are not
    written and not compared); the attention is within 1e-2 relative L2
    of its plain version (exp2 against exp may round a p at a .5 tie of
    its int8 grid the other way, one step of 127).  'global' gets a
    tight bound (the max score + 0.5), the other bounded mode 11 nats of
    slack."""
    B, N, Lq, Lf, S, lo, hi, sink, static_hi, tiles = INT8_CASES[case]
    if isinstance(tiles, tuple):
        tq, tk, tf = tiles
    else:
        tq, tk, tf = attention.decode_tiles(Lq, S, Lf, "int8", None, tiles,
                                            tk=256)
    g = torch.Generator(device=dev).manual_seed(16)
    q, kc, vc, kn, vn = _int8qk_inputs(g, dev, B, N, Lq, Lf, S)
    q = (q.float() * 8.0).to(torch.bfloat16)   # unfolded: scale D**-0.5
    win = dict(layer_idx=1, kv_start=lo, kv_end=hi, sink_end=sink,
               static_hi=static_hi, num_heads=N, tk=tk, tf=tf)
    vv = ca.int8_quantize_v(vc, vn, **win)
    vv_ref = ca.int8_quantize_v_ref(vc, vn, **win)
    torch.cuda.synchronize()
    live = torch.tensor(ca.live_cache_tiles(vv.vsc.shape[1], tk, lo, hi,
                                            sink), device=dev)
    for name in ("vsc", "vn8", "vsf"):
        torch.testing.assert_close(getattr(vv, name), getattr(vv_ref, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(vv.vc8[:, live], vv_ref.vc8[:, live], rtol=0,
                               atol=0)
    m0 = None
    if mode != "online":
        m0 = _score_bound(q, kc, kn, 1, lo, hi, sink, N, 11.0)
        if mode == "global":   # the true max score + 0.5
            vis = torch.cat([torch.arange(sink), torch.arange(lo, hi)])
            vis = vis[vis < (S if static_hi is None else static_hi)]
            qh = q.float().reshape(B, Lq, N, 128).transpose(1, 2)
            keys = torch.cat(
                [kc[1].float().reshape(B, N, S, 128)[:, :, vis.to(dev)],
                 kn.float().reshape(B, Lf, N, 128).transpose(1, 2)], dim=2)
            m0 = (qh @ keys.transpose(-1, -2)).amax() * 128 ** -0.5 + 0.5
    args = dict(mode=mode, m0=m0, scale=128 ** -0.5, tq=tq, **win)
    out = ca.decode_fresh_int8(q, kc, vc, kn, vn, **args)
    ref = ca.decode_fresh_int8_ref(q, kc, vc, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2, _rel_l2(out, ref)


# (B, N, S, Lf, kv_start, kv_end, sink_end, static_hi, tk, tf)
INT8V_CASES = {
    # the 1.3B global demo window at block 7, 2 heads
    "global": (1, 2, 32768, 4680, 0, 28080, 0, 28080, 2048, 1184),
    # the windowed steady state: the sink tile, a window from mid-buffer
    "windowed": (1, 2, 37440, 4680, 19500, 32760, 1560, None, 1560, 1184),
    # a sink inside a tile, kv_start mid-tile, batch 2
    "sink_in_tile": (2, 3, 5000, 300, 2600, 4100, 700, None, 1000, 224),
    # tiles of no multiple of 16, a partial last cache tile
    "ragged": (1, 2, 2000, 75, 1010, 1930, 0, 1999, 1003, 37),
    # the largest tile a cluster holds: 7168 padded keys
    "largest_tile": (1, 1, 8000, 100, 0, 7168, 0, None, 7168, 64),
}


@pytest.mark.parametrize("case", list(INT8V_CASES))
def test_int8_quantize_v_bit_equal(dev, case):
    """The V pre-pass against its plain version bit for bit: the scales
    (0 for the cache tiles the window does not meet) and every live tile's
    K-major int8, its padding to 64 keys included; two runs equal."""
    B, N, S, Lf, lo, hi, sink, static_hi, tk, tf = INT8V_CASES[case]
    g = torch.Generator(device=dev).manual_seed(35)
    vc = _bf16(g, 2, B * N, S, 128, dev=dev, scale=3.0)
    vn = _bf16(g, B, Lf, N * 128, dev=dev)
    win = dict(layer_idx=1, kv_start=lo, kv_end=hi, sink_end=sink,
               static_hi=static_hi, num_heads=N, tk=tk, tf=tf)
    ca.reset_launch_counts()
    vv = ca.int8_quantize_v(vc, vn, **win)
    again = ca.int8_quantize_v(vc, vn, **win)
    ref = ca.int8_quantize_v_ref(vc, vn, **win)
    torch.cuda.synchronize()
    assert ca.launch_counts["int8_quantize_v"] == 2
    live = torch.tensor(ca.live_cache_tiles(vv.vsc.shape[1], tk, lo, hi,
                                            sink), device=dev)
    for got in (vv, again):
        for name in ("vsc", "vn8", "vsf"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert torch.equal(got.vc8[:, live], ref.vc8[:, live])
    assert (vv.vsc[:, ~live] == 0).all()


def test_int8_quantize_v_refuses_a_tile_past_the_cluster(dev):
    g = torch.Generator(device=dev).manual_seed(36)
    vc = _bf16(g, 1, 1, 8000, 128, dev=dev)
    vn = _bf16(g, 1, 64, 128, dev=dev)
    with pytest.raises(ValueError):
        ca.int8_quantize_v(vc, vn, layer_idx=0, kv_start=0, kv_end=7232,
                           num_heads=1, tk=7232, tf=64)


@pytest.mark.parametrize("mode", ["tile", "global", "online"])
def test_int8_dead_gap_does_not_move_the_output(dev, mode):
    """Poison in the whole cache tiles between the sink and the window
    (never quantized, never loaded) leaves the full-int8 output bit for
    bit, in each mode."""
    B, N, Lq, Lf, S, lo, hi, sink, _, (tq, tk, tf) = INT8_CASES["dead_gap"]
    g = torch.Generator(device=dev).manual_seed(17)
    q, kc, vc, kn, vn = _int8qk_inputs(g, dev, B, N, Lq, Lf, S)
    q = (q.float() * 8.0).to(torch.bfloat16)   # unfolded: scale D**-0.5
    m0 = (None if mode == "online"
          else _score_bound(q, kc, kn, 1, lo, hi, sink, N, 11.0))
    args = dict(mode=mode, m0=m0, scale=128 ** -0.5, layer_idx=1,
                kv_start=lo, kv_end=hi, sink_end=sink, num_heads=N, tq=tq,
                tk=tk, tf=tf)
    out = ca.decode_fresh_int8(q, kc, vc, kn, vn, **args)
    kc[1, :, sink:lo] = 1e4
    vc[1, :, sink:lo] = float("nan")
    poisoned = ca.decode_fresh_int8(q, kc, vc, kn, vn, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(poisoned, out, rtol=0, atol=0)


def test_seam_refuses_unported_quant_modes(dev):
    """What the Pallas wrapper does not take raises on the kernel route:
    the free softmax with a bound, int8qk without the free softmax."""
    q = torch.zeros(1, 8, 256, dtype=torch.bfloat16, device=dev)
    kc = torch.zeros(2, 2, 64, 128, dtype=torch.bfloat16, device=dev)
    args = dict(layer_idx=0, heads_packed=2, scale=1.0)
    with pytest.raises(ValueError):
        attention.decode_attention_fresh(q, kc, kc, q, q, 0, 8,
                                         softmax="free", fixed_m0=1.0,
                                         **args)
    with pytest.raises(ValueError):
        attention.decode_attention_fresh(q, kc, kc, q, q, 0, 8,
                                         quant="int8qk", **args)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2 * 64, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        ca.cross_attention(q, k, k, num_heads=2)      # head_dim 64
    with pytest.raises(TypeError):
        ca.cross_attention(q.float(), k.float(), k.float(), num_heads=2)


# ------------------------------------------------------------ W8A8 linears

def _x_edges(g, M, K, dev):
    """bf16 rows with a zero row (the scale floor) and a row of .5 ties
    (its max is 127, so the scale is 1 and x / s lands on the ties)."""
    x = torch.randn(M, K, generator=g, device=dev)
    x[3] = 0.0
    x[5] = torch.randint(-100, 100, (K,), generator=g, device=dev) + 0.5
    x[5, 0] = 127.0
    return x.to(torch.bfloat16)


def _int8_close(out, ref):
    """int8 outputs: at most one step apart, on at most 0.1% of them."""
    step = (out.int() - ref.int()).abs()
    assert int(step.max()) <= 1
    assert float((step > 0).float().mean()) <= 1e-3


def _weight(g, d_in, d_out, dev, scale=0.05):
    w = torch.randn(d_in, d_out, generator=g, device=dev) * scale
    b = torch.randn(d_out, generator=g, device=dev) * 0.1
    return quant.quantize_linear_params({"w": w, "b": b}, "w8a8")


@pytest.mark.parametrize("M,K", [(4680, 1536), (512, 1536), (520, 4096),
                                 (8, 128)])
def test_quantize_rows_matches_plain(dev, M, K):
    """Both divide x by s (true division) and round half to even: equal
    int8, equal scales; the tie row rounds to even."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = _x_edges(g, max(M, 8), K, dev)[:M]
    q, s = cm.quantize_rows(x)
    q_ref, s_ref = cm.quantize_rows_ref(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(q, q_ref, rtol=0, atol=0)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=0)
    assert float(s[3, 0]) == pytest.approx(1e-8 / 127.0)
    torch.testing.assert_close(q[5], torch.round(x[5].float()).to(torch.int8),
                               rtol=0, atol=0)


# every fc1 group width the JAX tile rule admits (H = 2 TG: two groups)
FC1_GROUPS = (128, 256, 384, 512, 640, 768, 896)


@pytest.mark.parametrize("M,K,N", [(4680, 1536, 4608), (4680, 1536, 1536),
                                   (512, 1536, 1536), (520, 8960, 1536),
                                   (40, 128, 128), (520, 5120, 1536)]
                         + [(200, 1536, 2 * tn) for tn in FC1_GROUPS])
def test_w8a8_matmul_matches_plain(dev, M, K, N):
    """Exact int32 sums on both sides and the same f32 epilogue, each
    product and sum rounded on its own: the bf16 outputs are equal bit for
    bit (N = 2 tn gives every column tile of the linear, tn / 4 = 32 ..
    224)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = _x_edges(g, M, K, dev)
    p = _weight(g, K, N, dev)
    q = cm.quantize_rows_ref(x) or quant.quantize_activations(x)
    cm.reset_launch_counts()
    out = cm.w8a8_matmul(*q, p["w_qa_t"], p["w_scale"], p["b"])
    ref = cm.w8a8_matmul_ref(*q, p["w_qa_t"], p["w_scale"], p["b"])
    torch.cuda.synchronize()
    assert cm.launch_counts["w8a8_matmul"] == 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("M,N,H,tg", [
    ((40, 200, 520)[i % 3], (256, 384)[i % 2], k * tg, tg)
    for i, (k, tg) in enumerate((k, tg) for tg in FC1_GROUPS for k in (2, 3))
] + [(520, 5120, 13824, 768)])          # the 14B tiling: 18 groups of 768
def test_w8a8_ffn2_folds_each_group_with_its_own_scale(dev, M, N, H, tg):
    """fc2 from a seeded int8 hidden whose group scales differ by up to
    10^6 between groups and rows (M ragged to the 128-row tile): each
    group's exact int32 partial times its own row scale, folded into f32
    in the groups' order, then the f32 epilogue.  Bit-equal to the plain
    version, so a wrong group, a wrong row scale or another order of the
    fold fails."""
    rng = np.random.default_rng(35)
    ng = H // tg
    hq = torch.from_numpy(rng.integers(-127, 128, (M, H), dtype=np.int8))
    hs = torch.from_numpy((10.0 ** rng.uniform(-3, 3, (M, ng)))
                          .astype(np.float32))
    w2 = torch.from_numpy(rng.integers(-127, 128, (N, H), dtype=np.int8))
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-3, N).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(N) * 0.1).astype(np.float32))
    args = [t.to(dev) for t in (hq, hs, w2, ws, b)]
    cm.reset_launch_counts()
    out = cm.w8a8_ffn2(*args, tg)
    ref = cm.w8a8_ffn2_ref(*args, tg)
    torch.cuda.synchronize()
    assert cm.launch_counts["w8a8_ffn2"] == 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("M,K,H,N,bias", [
    (4680, 1536, 8960, 1536, True),      # the 1.3B FFN: 10 groups of 896
    (520, 1536, 1792, 1536, True),       # two groups, M ragged to 128
    (40, 256, 1792, 256, False),         # M ragged to 32, zero rows hit
] + [(200, 1536, 2 * tg, 256, True)      # the hidden's 1e-6 floor; then
     for tg in FC1_GROUPS])              # each group width at M 200
def test_w8a8_ffn_matches_plain(dev, M, K, H, N, bias):
    """fc1's int8 hidden: CUDA's tanhf and PyTorch's may differ by an ulp,
    so a value may round one step the other way (<= 0.1%); its group
    scales to 1e-5.  fc2 from the same hidden: 1e-3 (bf16 output).  The
    fused FFN: 1e-2 relative L2."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = _x_edges(g, M, K, dev)
    p1, p2 = _weight(g, K, H, dev, 0.06), _weight(g, H, N, dev, 0.03)
    b1, b2 = (p1["b"], p2["b"]) if bias else (None, None)
    tg = cm.ffn_group(M, K, H, N, raw_x=True)
    cm.reset_launch_counts()
    hq, hs = cm.w8a8_ffn1(x, p1["w_qa_t"], p1["w_scale"], b1, tg)
    assert cm.launch_counts["w8a8_ffn1"] == 1
    assert cm.launch_counts["quantize_rows"] == 0   # its pre-pass
    hq_ref, hs_ref = cm.w8a8_ffn1_ref(x, None, p1["w_qa_t"], p1["w_scale"],
                                      b1, tg)
    torch.cuda.synchronize()
    _int8_close(hq, hq_ref)
    torch.testing.assert_close(hs, hs_ref, rtol=1e-5, atol=0)
    if not bias:
        assert float(hs[3].min()) == pytest.approx(1e-6 / 127.0)
    y = cm.w8a8_ffn2(hq, hs, p2["w_qa_t"], p2["w_scale"], b2, tg)
    y_ref = cm.w8a8_ffn2_ref(hq, hs, p2["w_qa_t"], p2["w_scale"], b2, tg)
    torch.cuda.synchronize()
    assert _rel_l2(y, y_ref) < 1e-3
    args = (p1["w_qa_t"], p1["w_scale"], b1, p2["w_qa_t"], p2["w_scale"], b2)
    out = cm.w8a8_ffn(x, None, *args)
    ref = cm.w8a8_ffn_ref(x, None, *args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2


def test_w8a8_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    x = _x_edges(g, 16, 256, dev)
    p = _weight(g, 256, 128, dev)
    q, s = cm.quantize_rows(x)
    with pytest.raises(TypeError):
        cm.w8a8_matmul(q, s, p["w_qa_t"], p["w_scale"], out_dtype=torch.float32)
    with pytest.raises(ValueError):
        cm.w8a8_matmul(q, s, p["w_qa_t"][:, :128].contiguous(), p["w_scale"])
    with pytest.raises(TypeError):
        cm.quantize_rows(x.float())


# (B, N, Lq, Lk, mask): ragged lengths against the forward's 128-row and
# 128-key tiles and the backward's 128-key and 64-row tiles, both
# intervals, batch > 1, Lq != Lk, rows and a whole query tile that see
# nothing, more work items than the card has SMs
FLASH_CASES = {
    "no_mask": (1, 2, 256, 256, None),
    "teacher_forcing": (1, 2, 200, 200, ("tf", 5, 20, 1)),
    "block_causal": (2, 1, 300, 300, ("bc", 6, 50, 2)),
    "local_window": (1, 3, 130, 130, ("bc", 10, 13, 3, 2)),
    # Lk not a multiple of 128 and Lq != Lk, no mask
    "ragged_keys": (1, 2, 200, 333, None),
    # both intervals end (and start) mid-tile, row by row; Lq != Lk
    "mid_tile_intervals": (1, 2, 260, 500, ("mid",)),
    # rows [20, 40) and the whole query tile [128, 256) see no key
    "rows_see_nothing": (1, 2, 300, 300, ("none",)),
    "batch_heads": (2, 3, 384, 384, ("bc", 6, 64, 2)),
    # 37 query tiles x 4 heads = 148 work items on at most 132 SMs
    "many_items": (1, 4, 4680, 4680, ("bc", 3, 1560, 1)),
}


def _flash_mask(spec, Lq=None, Lk=None):
    from self_forcing_tpu_torch.ops import masks
    if spec is None:
        return None
    if spec[0] == "tf":
        return masks.teacher_forcing_mask(*spec[1:])
    if spec[0] == "bc":
        return masks.block_causal_mask(*spec[1:])
    i = np.arange(Lq)
    if spec[0] == "mid":
        iv = (i % 37, 70 + i % 50, 200 + i % 30, np.minimum(390 + i % 7, Lk))
    else:   # "none"
        e1 = np.full(Lq, Lk)
        e1[20:40] = 0
        e1[128:256] = 0
        iv = (np.zeros(Lq), e1, np.zeros(Lq), np.zeros(Lq))
    return masks.IntervalMask(*(np.asarray(a, np.int32) for a in iv))


def _flash_case(case):
    """(B, N, Lq, Lk, mask) of FLASH_CASES[case]."""
    B, N, Lq, Lk, spec = FLASH_CASES[case]
    return B, N, Lq, Lk, _flash_mask(spec, Lq, Lk)


def _flash_inputs(g, dev, B, N, Lq, Lk=None):
    D = 128
    Lk = Lq if Lk is None else Lk
    q = _bf16(g, B, Lq, N, D, dev=dev, scale=D ** -0.5 * 1.4427)
    k = _bf16(g, B, Lk, N, D, dev=dev)
    v = _bf16(g, B, Lk, N, D, dev=dev)
    do = _bf16(g, B, Lq, N, D, dev=dev)
    return q, k, v, do


def _sees_nothing(mask, Lq, Lk, dev):
    """[Lq] bool: the query rows that see no key below Lk."""
    if mask is None:
        return torch.zeros(Lq, dtype=torch.bool, device=dev)
    return ~ca._visible(mask, slice(0, Lq), Lk, dev).any(dim=1)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_fwd_matches_plain(dev, case):
    """Tolerance 1e-2 relative L2 on out (both round p to bf16, which may
    round either way for scores summed in another order); lse 1e-4
    absolute (fp32 sums).  A row that sees no key has out 0 and lse 0."""
    B, N, Lq, Lk, mask = _flash_case(case)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, _ = _flash_inputs(g, dev, B, N, Lq, Lk)
    out, lse = ca.flash_fwd(q, k, v, mask)
    ref, ref_lse = ca.flash_fwd_ref(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    blind = _sees_nothing(mask, Lq, Lk, dev)
    assert not out[:, blind].any() and not lse[:, :, blind].any()


@pytest.mark.parametrize("mode", ["free", "bounded", "online"])
def test_flash_fwd_reads_nothing_the_mask_hides(dev, mode):
    """Keys [100, 300) of Lk = 400 are hidden from every one of 300
    queries: the 128-key tile [128, 256) is dead, [0, 128), [256, 384) and
    [384, 400) are partial, the last one past Lk (k and v are the first
    400 rows of a 512-row buffer).  K holds NaN in every hidden row and
    past Lk (the mask drops those scores before any use); V holds NaN in
    the dead tile and past Lk, and 3e4 in the hidden rows of the partial
    tiles (the kernel loads those rows and multiplies them by p = 0, and
    0 * NaN would be NaN).  out and lse must equal, bit for bit, the
    kernel's result with those rows zero, and the plain version's
    (1e-2 relative L2, lse 1e-4)."""
    B, N, Lq, Lk, lo, hi = 1, 2, 300, 400, 100, 300
    from self_forcing_tpu_torch.ops import masks
    mask = masks.IntervalMask(*(np.full(Lq, x, np.int32)
                                for x in (0, lo, hi, Lk)))
    g = torch.Generator(device=dev).manual_seed(16)
    q, kb, vb, _ = _flash_inputs(g, dev, B, N, Lq, 512)
    if mode != "free":
        q = (q.float() * 8.0).to(torch.bfloat16)
    m0 = (128 ** -0.5 * q.float().norm(dim=-1).amax()
          * kb[:, :Lk].float().norm(dim=-1).amax()) if mode == "bounded" \
        else None
    args = dict(mode=mode, scale=128 ** -0.5, m0=m0)
    j = torch.arange(512, device=dev).view(1, 512, 1, 1)
    hidden = (j >= lo) & (j < hi)
    dead = ((j >= 128) & (j < 256)) | (j >= Lk)
    nan = float("nan")
    zeroed = [torch.where(hidden | (j >= Lk), torch.zeros_like(t), t)
              for t in (kb, vb)]
    poisoned = [torch.where(hidden | (j >= Lk), torch.full_like(kb, nan), kb),
                torch.where(dead, torch.full_like(vb, nan),
                            torch.where(hidden, torch.full_like(vb, 3e4),
                                        vb))]
    got = ca.flash_fwd(q, *(t[:, :Lk] for t in poisoned), mask, **args)
    clean = ca.flash_fwd(q, *(t[:, :Lk] for t in zeroed), mask, **args)
    ref = ca.flash_fwd_ref(q, *(t[:, :Lk] for t in zeroed), mask, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0].float()).all()
    assert torch.equal(got[0], clean[0]) and torch.equal(got[1], clean[1])
    assert _rel_l2(got[0], ref[0]) < 1e-2
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_bwd_matches_plain(dev, case):
    """dq, dk, dv of the one backward kernel against the plain backward on
    the same out, lse and delta: 2e-2 relative L2 (both feed bf16 p and ds
    to the products; ds is a difference of near-equal terms, so its bf16
    rounding may differ by an ulp)."""
    B, N, Lq, Lk, mask = _flash_case(case)
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = _flash_inputs(g, dev, B, N, Lq, Lk)
    out, lse = ca.flash_fwd_ref(q, k, v, mask)
    delta = ca.flash_delta(out, do)
    dq, dk, dv = ca.flash_bwd(q, k, v, do, lse, delta, mask)
    dq_r = ca.flash_bwd_dq_ref(q, k, v, do, lse, delta, mask)
    dk_r, dv_r = ca.flash_bwd_dkv_ref(q, k, v, do, lse, delta, mask)
    torch.cuda.synchronize()
    for name, a, b in (("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, b) < 2e-2, (name, _rel_l2(a, b))


def _hidden_band_mask(L, lo, hi):
    """Every query sees keys [0, lo) and [hi, L): keys [lo, hi) are hidden
    from all of them."""
    from self_forcing_tpu_torch.ops import masks
    return masks.IntervalMask(*(np.full(L, x, np.int32)
                                for x in (0, lo, hi, L)))


def test_flash_bwd_reads_nothing_the_mask_hides(dev):
    """Keys [100, 300) of L = 400 are hidden from every query: the 128-key
    tile [128, 256) is dead, [0, 128) and [256, 384) are partial.  The
    hidden rows of K and V hold 3e4 in the partial tiles (the kernel loads
    them and must mask them: exp2 of such a score is inf) and NaN in the
    dead tile.  dq, and dk and dv of the visible keys, must equal the
    kernel's result with those rows zero (within 1e-3 relative L2: dq's
    partials are summed in another order each run) and the plain
    version's (2e-2); dk and dv of every hidden key must be exactly 0."""
    B, N, L, lo, hi = 1, 2, 400, 100, 300
    mask = _hidden_band_mask(L, lo, hi)
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v, do = _flash_inputs(g, dev, B, N, L)
    j = torch.arange(L, device=dev).view(1, L, 1, 1)
    hidden = (j >= lo) & (j < hi)
    dead = (j >= 128) & (j < 256)
    zeroed = [torch.where(hidden, torch.zeros_like(t), t) for t in (k, v)]
    poisoned = [torch.where(dead, torch.full_like(t, float("nan")),
                            torch.where(hidden, torch.full_like(t, 3e4), t))
                for t in (k, v)]
    out, lse = ca.flash_fwd_ref(q, *zeroed, mask)
    delta = ca.flash_delta(out, do)
    got = ca.flash_bwd(q, *poisoned, do, lse, delta, mask)
    clean = ca.flash_bwd(q, *zeroed, do, lse, delta, mask)
    plain = (ca.flash_bwd_dq_ref(q, *zeroed, do, lse, delta, mask),
             *ca.flash_bwd_dkv_ref(q, *zeroed, do, lse, delta, mask))
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv"), got, clean, plain):
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, b) < 1e-3, (name, _rel_l2(a, b))
        assert _rel_l2(a, c) < 2e-2, (name, _rel_l2(a, c))
    for name, a in (("dk", got[1]), ("dv", got[2])):
        assert torch.equal(a[:, lo:hi], torch.zeros_like(a[:, lo:hi])), name


def test_flash_bwd_is_deterministic_but_for_dq(dev):
    """Two runs on the same inputs: dk and dv (one owner each, a fixed
    order) are the same bits; dq sums the key tiles' partials in L2 in an
    order that may change, so it agrees within 1e-3 relative L2."""
    B, N, Lq, Lk, mask = _flash_case("block_causal")
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v, do = _flash_inputs(g, dev, B, N, Lq, Lk)
    out, lse = ca.flash_fwd_ref(q, k, v, mask)
    delta = ca.flash_delta(out, do)
    a = ca.flash_bwd(q, k, v, do, lse, delta, mask)
    b = ca.flash_bwd(q, k, v, do, lse, delta, mask)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert _rel_l2(a[0], b[0]) < 1e-3, _rel_l2(a[0], b[0])


def test_flash_attention_gradient_kernels_vs_plain(dev):
    """The autograd function end to end: the seam's flash attention with
    the kernels against the same with their plain versions."""
    B, N, Lq, Lk, mask = _flash_case("block_causal")
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v, do = _flash_inputs(g, dev, B, N, Lq, Lk)
    grads = []
    for kernels in (True, False):
        ca.reset_launch_counts()
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attention.flash_attention(*qkv, mask, softmax="free",
                                        kernels=kernels)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in qkv])
        assert (ca.launch_counts["flash_bwd"] > 0) == kernels
    for a, b in zip(*grads):
        assert _rel_l2(a, b) < 2e-2


@pytest.mark.parametrize("mode", ["bounded", "online"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_fwd_modes_match_plain(dev, mode, case):
    """The bounded (bound 3 nats loose) and online forward modes against
    their plain versions: 1e-2 relative L2 on out (the kernel rounds p to
    bf16, the plain online version keeps it in float32); lse 1e-4
    absolute (fp32 sums)."""
    B, N, Lq, Lk, mask = _flash_case(case)
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, _ = _flash_inputs(g, dev, B, N, Lq, Lk)
    q = (q.float() * 8.0).to(torch.bfloat16)   # unfolded: scale D**-0.5
    m0 = None
    if mode == "bounded":
        m0 = (128 ** -0.5 * q.float().norm(dim=-1).amax()
              * k.float().norm(dim=-1).amax() + 3.0)
    args = dict(mode=mode, scale=128 ** -0.5, m0=m0)
    out, lse = ca.flash_fwd(q, k, v, mask, **args)
    ref, ref_lse = ca.flash_fwd_ref(q, k, v, mask, **args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2, _rel_l2(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bounded", [True, False])
def test_flash_modes_gradient_kernels_vs_plain(dev, bounded):
    """The autograd function in the bounded and online modes: kernels
    against plain versions, out and gradients (2e-2, as the free mode)."""
    B, N, Lq, Lk, mask = _flash_case("block_causal")
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = _flash_inputs(g, dev, B, N, Lq, Lk)
    q = (q.float() * 8.0).to(torch.bfloat16)
    m0 = (128 ** -0.5 * q.float().norm(dim=-1).amax()
          * k.float().norm(dim=-1).amax()) if bounded else None
    grads = []
    for kernels in (True, False):
        ca.reset_launch_counts()
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attention.flash_attention(*qkv, mask, fixed_m0=m0,
                                        kernels=kernels)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in qkv])
        assert (ca.launch_counts["flash_bwd"] > 0) == kernels
    for a, b in zip(*grads):
        assert _rel_l2(a, b) < 2e-2, _rel_l2(a, b)


def test_flash_seam_refuses_unported_modes(dev):
    """The free softmax takes no bound; the kernels take bf16 only."""
    q = torch.zeros(1, 64, 1, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q, softmax="free", fixed_m0=1.0)
    with pytest.raises(TypeError):
        ca.flash_fwd(q.float(), q.float(), q.float())


# ---------------------------------------------------------------- convs
# Tolerance 4e-3 relative L2: kernel and plain version sum the same bf16
# products in float32 in other orders and round once to bf16, so outputs
# differ by at most an ulp (2^-8 relative) where they straddle a rounding
# boundary.

def _conv_operands(g, dev, B, T, H, W, C, Cout):
    x = _bf16(g, B, T, H, W, C, dev=dev)
    cache = _bf16(g, B, 2, H, W, C, dev=dev)
    w = _bf16(g, Cout, C, 3, 3, 3, dev=dev, scale=(27 * C) ** -0.5)
    b = _bf16(g, Cout, dev=dev, scale=0.1)
    return x, cache, w, b


@pytest.mark.parametrize("B,T,H,W,C,Cout", [
    (1, 1, 7, 13, 3, 96),      # the encoder's RGB input (scalar A loads)
    (1, 2, 9, 10, 16, 384),    # the decoder's 16-channel input
    (1, 3, 5, 6, 96, 3),       # the RGB head (BN 32, odd Cout)
    (1, 2, 6, 8, 384, 32),     # the encoder head (BN 32)
    (2, 1, 4, 5, 40, 64),      # batch 2, BN 64, C not a multiple of 32
    (1, 4, 12, 20, 96, 96),    # 4 frames: taps from cache and x
])
def test_conv3d_fused_matches_plain(dev, B, T, H, W, C, Cout):
    g = torch.Generator(device=dev).manual_seed(20)
    x, cache, w, b = _conv_operands(g, dev, B, T, H, W, C, Cout)
    cc.reset_launch_counts()
    out = tconv.conv3d_fused(x, cache, w, b)
    ref = tconv.conv3d_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert cc.launch_counts["conv3d_fused"] == 1
    assert out.shape == (B, T, H, W, Cout)
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 4e-3


def test_conv_split_route_matches_plain(dev, monkeypatch):
    """The 3-call temporal split (one launch a temporal tap, the partials
    rounded to bf16 and summed in bf16 as in the plain version), reached
    through causal_conv3d_pallas with its fused route declining."""
    g = torch.Generator(device=dev).manual_seed(21)
    x, cache, w, b = _conv_operands(g, dev, 1, 3, 9, 14, 96, 96)
    monkeypatch.setattr(tconv, "conv3d_fused", lambda *a, **k: None)
    cc.reset_launch_counts()
    out = tconv.causal_conv3d_pallas(x, cache, w, b)
    ref = tconv.split_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert cc.launch_counts["conv2d_9tap"] == 3
    assert _rel_l2(out, ref) < 4e-3


def test_conv3d_v2_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(22)
    x, cache, w, b = _conv_operands(g, dev, 1, 2, 8, 16, 128, 128)
    out = tconv.causal_conv3d_pallas_v2(x, cache, w, b)
    ref = tconv.conv3d_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert _rel_l2(out, ref) < 4e-3


@pytest.mark.parametrize("T,H,W,C,Cout,residual", [
    (2, 8, 16, 128, 128, False),
    (1, 12, 24, 256, 128, True),
    (3, 8, 8, 128, 256, True),
])
def test_norm_silu_conv3d_matches_plain(dev, T, H, W, C, Cout, residual):
    """Raw cache frames, jittered gammas; 1e-2 relative L2: the activated
    input is rounded to bf16 in both, but from an rsqrt and exp of other
    precision, so a share of its elements differ by an ulp."""
    g = torch.Generator(device=dev).manual_seed(23)
    x, cache, w, b = _conv_operands(g, dev, 1, T, H, W, C, Cout)
    gamma = (1 + 0.2 * torch.randn(C, generator=g, device=dev)).to(
        torch.bfloat16)
    res = _bf16(g, T, H, W, Cout, dev=dev) if residual else None
    cc.reset_launch_counts()
    out = tconv.norm_silu_conv3d(x[0], cache[0], gamma, w, b, res)
    ref = tconv.nsc_ref(x[0], cache[0], gamma, w, b, res)
    torch.cuda.synchronize()
    assert cc.launch_counts["norm_silu_conv3d"] == 1
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2


@pytest.mark.parametrize("C", [3, 16, 96, 384])
@pytest.mark.parametrize("Cout", [3, 12, 32, 96])
def test_conv3d_channel_widths_match_plain(dev, C, Cout):
    """Every input width of the VAE's convs (the RGB input takes the
    narrow route) against every output width class (the RGB head, a
    ragged 12 and the encoder head's 32 in one masked or exact 32-channel
    tile, 96), over a frame whose width is no multiple of the 64-column
    tile."""
    g = torch.Generator(device=dev).manual_seed(26)
    x, cache, w, b = _conv_operands(g, dev, 1, 2, 6, 70, C, Cout)
    out = tconv.conv3d_fused(x, cache, w, b)
    ref = tconv.conv3d_ref(x, cache, w, b)
    torch.cuda.synchronize()
    route = cc.conv_plan(1, 2, 6, 70, C, Cout, 3, cc._sm_count(x.device))
    assert route["route"] == ("narrow" if C == 3 else "wide")
    assert _rel_l2(out, ref) < 4e-3


@pytest.mark.parametrize("H,W", [(5, 63), (4, 64), (9, 65), (3, 130),
                                 (60, 104), (2, 200)])
def test_conv3d_halo_edges_match_plain(dev, H, W):
    """Halo tiles at the frame's edges: W below, at and above the
    64-column tile (the last tile's halo reaches past W, its columns past
    W are not stored), H not a multiple of the 4-row tile; every pixel
    against the plain version, the frame's border pixels too."""
    g = torch.Generator(device=dev).manual_seed(27)
    x, cache, w, b = _conv_operands(g, dev, 1, 2, H, W, 64, 128)
    out = tconv.conv3d_fused(x, cache, w, b)
    ref = tconv.conv3d_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert cc.conv_plan(1, 2, H, W, 64, 128, 3,
                        cc._sm_count(x.device))["route"] == "wide"
    assert _rel_l2(out, ref) < 4e-3
    edge = torch.ones(H, W, dtype=torch.bool, device=dev)
    edge[1:-1, 1:-1] = False
    assert _rel_l2(out[:, :, edge], ref[:, :, edge]) < 4e-3


@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("tau", [0, 1, 2])
def test_conv2d_tap_frames_cross_the_cache(dev, T, tau):
    """One temporal tap at frame offset tau over T output frames: frames
    t + tau < 2 come from the cache, the rest from x, each against the
    plain version; and the 27-tap conv at the same T."""
    g = torch.Generator(device=dev).manual_seed(28)
    x, cache, w, b = _conv_operands(g, dev, 1, T, 7, 66, 96, 96)
    out = cc.conv2d_tap(x, cache, w, b, tau)
    ref = tconv.conv2d_tap_ref(x, cache, w, b, tau)
    full = tconv.conv3d_fused(x, cache, w, b)
    full_ref = tconv.conv3d_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert _rel_l2(out, ref) < 4e-3
    assert _rel_l2(full, full_ref) < 4e-3


def test_conv2d_tap_past_the_cache_reads_no_cache(dev):
    """A taps_t 1, tau 2 launch reads x alone: NaN in the cache changes
    nothing, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(29)
    x, cache, w, b = _conv_operands(g, dev, 1, 2, 8, 70, 96, 192)
    clean = cc.conv2d_tap(x, cache, w, b, 2)
    poisoned = cc.conv2d_tap(x, torch.full_like(cache, float("nan")), w, b,
                             2)
    torch.cuda.synchronize()
    assert torch.isfinite(clean.float()).all()
    assert torch.equal(clean, poisoned)


@pytest.mark.parametrize("T", [1, 2])
def test_conv_split_k_is_deterministic(dev, T):
    """K splits write f32 partials that a second pass sums in split order,
    so two runs are bit-equal: the encoder head (384 -> 32 at 60x104),
    which conv_plan splits, at T = 1 (an encode chunk) and 2, against the
    plain version; the launcher refuses a split of the norm + SiLU conv."""
    g = torch.Generator(device=dev).manual_seed(30)
    x, cache, w, b = _conv_operands(g, dev, 1, T, 60, 104, 384, 32)
    plan = cc.conv_plan(1, T, 60, 104, 384, 32, 3, cc._sm_count(x.device))
    assert plan["splits"] > 1
    runs = [tconv.conv3d_fused(x, cache, w, b) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert _rel_l2(runs[0], tconv.conv3d_ref(x, cache, w, b)) < 4e-3
    wk = cc.kernel_weight(w)
    inv = torch.empty(1, 2 + T, 60, 104, device=dev)
    gamma = torch.ones(384, device=dev)
    ws = torch.empty(plan["splits"], T * 60 * 104, 32, device=dev)
    with pytest.raises(RuntimeError):
        cc._launch("norm_silu_conv3d", "conv3d_launch", x, cache, wk,
                   b.float(), None, inv, gamma, torch.empty_like(runs[0]),
                   ws, 1, T, 60, 104, 384, 384, 32, 3, 0, plan["bn"],
                   plan["splits"], plan["grid"], 1.0)


@pytest.mark.parametrize("M,K", [(13, 8), (4683, 1544), (4683, 4096),
                                 (1, 1536)])
def test_quantize_rows_kernel_bit_equal_at_ragged_shapes(dev, M, K):
    """The kernel itself (the pre-pass launcher, which takes K % 8 == 0
    where the JAX tile rule asks K % 128) at M not a multiple of the 8
    rows a CTA takes and K not a multiple of its 16-element chunks: int8
    and scales equal the plain version's bit for bit; an all-zero row
    takes the scale floor and quantizes to zeros."""
    g = torch.Generator(device=dev).manual_seed(31)
    x = (torch.randn(M, K, generator=g, device=dev) * 3).to(torch.bfloat16)
    x[M // 2] = 0
    q, s = cm._quantize_pre_pass("quantize_rows", x)
    q_ref, s_ref = cm._quant_rows(x.float(), cm.ACT_FLOOR)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    assert float(s[M // 2, 0]) == pytest.approx(1e-8 / 127.0)
    assert not q[M // 2].any()


def test_conv_wrappers_reject_what_the_kernels_do_not_take(dev):
    """float16 is not a conv kernel's type (bf16 and, since the float32
    mode was ported, float32 are); x and cache must share one; the norm +
    SiLU conv takes bf16 only."""
    g = torch.Generator(device=dev).manual_seed(24)
    x, cache, w, b = _conv_operands(g, dev, 1, 1, 4, 8, 16, 16)
    with pytest.raises(TypeError):
        cc.conv3d(x.half(), cache.half(), w, b)
    with pytest.raises(ValueError):
        cc.conv3d(x.float(), cache, w, b)
    with pytest.raises(ValueError):
        cc.conv3d(x, cache[:, :1], w, b)
    with pytest.raises(TypeError):
        cc.norm_silu_conv3d(x[0].float(), cache[0].float(), b.float(), w, b)


# the RGB input's route (C <= 3): K packed as 27 taps x C, one output row
# of 64 pixels an item, its halo one TMA box a temporal tap (rows of W C
# values, padded by the wrapper to a multiple of 8 where W C is not)
RGB_CASES = {
    "T1_W832": (1, 1, 6, 832, 3, 96),      # the first frame: cache frames
    "T4_W832": (1, 4, 5, 832, 3, 96),      # an encode chunk's width
    "T2_W63": (1, 2, 7, 63, 3, 96),        # below one 64-pixel item
    "T3_W64": (1, 3, 9, 64, 3, 32),        # exactly one item
    "T4_W65": (2, 4, 3, 65, 3, 3),         # one pixel past it, batch 2
    "T2_W130_C2": (1, 2, 4, 130, 2, 12),   # two channels, ragged Cout
    "T1_W70_C1": (1, 1, 11, 70, 1, 384),   # one channel, 4 channel tiles
}


@pytest.mark.parametrize("case", list(RGB_CASES))
def test_conv3d_rgb_route_matches_plain(dev, case):
    """The narrow route against the plain conv: every pixel (1e-2 relative
    L2, the VAE's conv rows' limit; the kernel sums bf16 products in f32
    from the bias in another order), the frame's border pixels alone (the
    halo columns past the frame are zeroed in shared memory, the rows
    past it loaded from past the tensor's end), cache frames with other
    values than x; two runs bit-equal."""
    B, T, H, W, C, Cout = RGB_CASES[case]
    g = torch.Generator(device=dev).manual_seed(32)
    x, cache, w, b = _conv_operands(g, dev, B, T, H, W, C, Cout)
    cc.reset_launch_counts()
    out = tconv.conv3d_fused(x, cache, w, b)
    again = tconv.conv3d_fused(x, cache, w, b)
    ref = tconv.conv3d_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert cc.launch_counts["conv3d_rgb"] == 2
    assert cc.launch_counts["conv3d_fused"] == 2
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2
    edge = torch.ones(H, W, dtype=torch.bool, device=dev)
    edge[1:-1, 1:-1] = False
    assert _rel_l2(out[:, :, edge], ref[:, :, edge]) < 1e-2
    assert _rel_l2(out[:, :1], ref[:, :1]) < 1e-2


@pytest.mark.parametrize("T,tau", [(1, 0), (2, 1), (3, 2)])
def test_conv2d_tap_rgb_route_matches_plain(dev, T, tau):
    """One temporal tap on the narrow route (the weights from k = 9 C tau
    of the packed copy): frames from the cache and from x."""
    g = torch.Generator(device=dev).manual_seed(33)
    x, cache, w, b = _conv_operands(g, dev, 1, T, 7, 66, 3, 96)
    out = cc.conv2d_tap(x, cache, w, b, tau)
    ref = tconv.conv2d_tap_ref(x, cache, w, b, tau)
    torch.cuda.synchronize()
    assert _rel_l2(out, ref) < 1e-2


def test_conv_rgb_route_takes_unaligned_views_and_pads_other_widths(dev):
    """A contiguous view whose base is not 16-byte aligned is copied first
    (one layout copy; its rows of W * C = 48 values need no padding); 5
    channels are zero padded to 8 and take the wide route (two copies: x
    and the cache)."""
    g = torch.Generator(device=dev).manual_seed(34)
    xs, cache, w, b = _conv_operands(g, dev, 1, 2, 7, 16, 3, 32)
    buf = torch.empty(xs.numel() + 1, dtype=xs.dtype, device=dev)
    x = buf[1:].view(xs.shape)   # 2 bytes past the allocation's base
    x.copy_(xs)
    assert x.is_contiguous() and x.data_ptr() % 16
    cc.reset_launch_counts()
    out = tconv.conv3d_fused(x, cache, w, b)
    torch.cuda.synchronize()
    assert cc.layout_copies["activations"] == 1
    assert cc.launch_counts["conv3d_rgb"] == 1
    assert _rel_l2(out, tconv.conv3d_ref(x, cache, w, b)) < 1e-2
    x5, cache5, w5, b5 = _conv_operands(g, dev, 1, 2, 6, 70, 5, 64)
    cc.reset_launch_counts()
    out = tconv.conv3d_fused(x5, cache5, w5, b5)
    torch.cuda.synchronize()
    assert cc.layout_copies["activations"] == 2
    assert cc.launch_counts["conv3d_rgb"] == 0
    assert _rel_l2(out, tconv.conv3d_ref(x5, cache5, w5, b5)) < 4e-3


def test_kernel_weight_is_made_once_and_follows_writes(dev):
    g = torch.Generator(device=dev).manual_seed(25)
    _, _, w, _ = _conv_operands(g, dev, 1, 1, 4, 8, 12, 8)
    wk = cc.kernel_weight(w)
    assert wk.shape == (8, 27, 16) and cc.kernel_weight(w) is wk
    assert (wk[..., 12:] == 0).all()
    torch.testing.assert_close(wk[..., :12], w.permute(0, 2, 3, 4, 1)
                               .reshape(8, 27, 12), rtol=0, atol=0)
    w.mul_(2)
    assert cc.kernel_weight(w) is not wk


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_vae_decode_under_conv_backend_matches_torch_convs(dev, backend):
    """A small streaming decode in bf16 through the kernels is as close to
    the float32 decode of the same weights (torch convs, TF32 off) as the
    bf16 decode on torch's convs is: within 1.5x its relative L2 (both
    round every conv's output to bf16, through 30 convs; under 'fused'
    the activations are rounded at other points)."""
    from self_forcing_tpu_torch.models.wan import vae
    cfg = vae.VAEConfig(dim=32, z_dim=4, dim_mult=(1, 2, 4, 4),
                        num_res_blocks=1)
    p = vae.init_params(cfg, seed=3, dtype=torch.bfloat16, device=dev)
    if backend == "fused":
        p = vae.pad_decoder_channels(p)
    z = torch.randn(1, 3, 8, 8, 4, device=dev).to(torch.bfloat16)
    p32 = map_tree(lambda t: t.float(), p)
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = vae.decode(p32, cfg, z.float())
        outs = []
        for be in (None, backend):
            vae.set_conv_backend(be)
            cc.reset_launch_counts()
            outs.append(vae.decode(p, cfg, z))
            torch.cuda.synchronize()
    finally:
        vae.set_conv_backend(None)
    name = "conv3d_fused" if backend == "pallas" else "norm_silu_conv3d"
    assert cc.launch_counts[name] > 0
    e_torch, e_kern = _rel_l2(outs[0], ref), _rel_l2(outs[1], ref)
    assert e_kern < 1.5 * e_torch, (e_kern, e_torch)



# ------------------------------------------------ slice 7: true division,
# fc1 from pre-quantized x, the bf16x GEMM, the decode window, f32 convs

@pytest.mark.parametrize("name", ["quantize_activations",
                                  "quantize_activations_fp8",
                                  "_quantize_weight", "_quantize_weight_fp8"])
def test_quantization_helpers_divide_on_cuda_as_on_cpu(dev, name):
    """The four helpers on CUDA equal the same calls on the CPU bit for
    bit (scales and values), on rows where x * (1 / 127) != x / 127: a
    division by a Python scalar would become a reciprocal multiply on
    CUDA (tests/test_torch_quant.py holds the CPU results to JAX's)."""
    g = torch.Generator().manual_seed(30)
    x = torch.rand(4000, 64, generator=g) * 2 - 1
    x[torch.arange(4000), torch.randint(0, 64, (4000,), generator=g)] = \
        0.5 + 0.5 * torch.rand(4000, generator=g)
    args = (0,) if name.startswith("_quantize_weight") else ()
    if args:
        x = x.T.contiguous()
    fn = getattr(quant, name)
    v_cpu, s_cpu = fn(x, *args)
    v_dev, s_dev = fn(x.to(dev), *args)
    torch.cuda.synchronize()
    assert torch.equal(s_dev.cpu(), s_cpu)
    assert torch.equal(v_dev.cpu().view(torch.uint8), v_cpu.view(torch.uint8))


@pytest.mark.parametrize("M,K,H,N", [
    (520, 5120, 1536, 640),     # the 14B tiles: K 5120, groups of 768
    (40, 2048, 1792, 256),      # groups of 896, M ragged to 32
    (4680, 5120, 3072, 640),    # M of a 14B block, 4 groups of 768
    (4680, 1536, 8960, 1536),   # the 1.3B FFN from int8 x
] + [(200, 5120, 2 * tg, 256) for tg in FC1_GROUPS])
def test_w8a8_ffn_from_prequantized_x_matches_plain(dev, M, K, H, N):
    """fc1 from int8 x and s_x (``w8a8_ffn1_xq``) against its plain
    version: int8 hidden equal but for one-step flips (<= 0.1%: CUDA's
    tanhf and PyTorch's may differ by an ulp), group scales to 1e-5; the
    FFN through ``w8a8_ffn`` to 1e-2 relative L2."""
    g = torch.Generator(device=dev).manual_seed(31)
    x = _x_edges(g, M, K, dev)
    p1, p2 = _weight(g, K, H, dev, 0.03), _weight(g, H, N, dev, 0.03)
    xq, sx = quant.quantize_activations(x)
    tg = cm.ffn_group(M, K, H, N, raw_x=False)
    assert tg is not None
    if K > 1536:
        assert cm.ffn_group(M, K, H, N, raw_x=True) is None
    cm.reset_launch_counts()
    hq, hs = cm.w8a8_ffn1(xq, p1["w_qa_t"], p1["w_scale"], p1["b"], tg, sx)
    hq_ref, hs_ref = cm.w8a8_ffn1_ref(xq, sx, p1["w_qa_t"], p1["w_scale"],
                                      p1["b"], tg)
    torch.cuda.synchronize()
    assert cm.launch_counts["w8a8_ffn1_xq"] == 1
    _int8_close(hq, hq_ref)
    torch.testing.assert_close(hs, hs_ref, rtol=1e-5, atol=0)
    args = (p1["w_qa_t"], p1["w_scale"], p1["b"], p2["w_qa_t"],
            p2["w_scale"], p2["b"])
    out = cm.w8a8_ffn(xq, sx, *args)
    ref = cm.w8a8_ffn_ref(xq, sx, *args)
    torch.cuda.synchronize()
    assert cm.launch_counts["w8a8_ffn1_xq"] == 2
    assert torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-2


@pytest.mark.parametrize("tg", [128, 512, 896])
def test_w8a8_ffn1_group_max_spans_the_cluster(dev, tg):
    """fc1 splits each group's columns over a cluster of 4 CTAs.  Row r's
    largest gelu value lies in quarter (r + j) % 4 of group j (x has one
    large feature k = r % 4; w's column for k in group j sits in that
    quarter and makes y ~ 120, where tanh is exactly 1 and gelu(y) = y on
    both sides): the group scales equal the plain version's bit for bit,
    which needs the maximum of all four CTAs' partial maxima."""
    g = torch.Generator(device=dev).manual_seed(34)
    M, K, H = 200, 256, 2 * tg
    q4 = tg // 4
    x = torch.randn(M, K, generator=g, device=dev) * 0.1
    rows = torch.arange(M, device=dev)
    x[rows, rows % 4] = 4.0
    w = torch.randn(K, H, generator=g, device=dev) * 0.02
    big = {}
    for j in range(H // tg):
        for k in range(4):
            big[j, k] = j * tg + ((k + j) % 4) * q4 + 5 + 3 * k
            w[k, big[j, k]] = 30.0
    p = quant.quantize_linear_params({"w": w, "b": torch.zeros(H,
                                                               device=dev)},
                                     "w8a8")
    xb = x.to(torch.bfloat16)
    hq, hs = cm.w8a8_ffn1(xb, p["w_qa_t"], p["w_scale"], p["b"], tg)
    hq_ref, hs_ref = cm.w8a8_ffn1_ref(xb, None, p["w_qa_t"], p["w_scale"],
                                      p["b"], tg)
    torch.cuda.synchronize()
    for j in range(H // tg):
        cols = torch.tensor([big[j, int(k)] for k in rows % 4], device=dev)
        assert bool((hq_ref[rows, cols] == 127).all())   # the construction
    assert torch.equal(hs, hs_ref)
    _int8_close(hq, hq_ref)


@pytest.mark.parametrize("M,K,N", [(4680, 1536, 4608), (520, 1536, 1536),
                                   (40, 256, 384), (48, 128, 896)]
                         + [(200, 1536, 2 * tn) for tn in FC1_GROUPS])
def test_w8a8_matmul_bf16x_matches_plain(dev, M, K, N):
    """The GEMM quantizing raw bf16 x in its prologue: the same int8 x and
    scales as ``quantize_rows`` (true division, half to even), exact int32
    sums, the same f32 epilogue: 1e-3 relative L2 (bf16 output)."""
    g = torch.Generator(device=dev).manual_seed(32)
    x = _x_edges(g, M, K, dev)
    p = _weight(g, K, N, dev)
    cm.reset_launch_counts()
    out = cm.w8a8_matmul_bf16x(x, p["w_qa_t"], p["w_scale"], p["b"])
    ref = cm.w8a8_matmul_bf16x_ref(x, p["w_qa_t"], p["w_scale"], p["b"])
    torch.cuda.synchronize()
    assert cm.launch_counts["w8a8_matmul_bf16x"] == 1
    assert cm.launch_counts["quantize_rows"] == 0   # its pre-pass
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) < 1e-3
    assert cm.w8a8_matmul_bf16x(x[:, :K - 8].contiguous(), p["w_qa_t"][
        :, :K - 8].contiguous(), p["w_scale"]) is None      # K % 128
    with pytest.raises(TypeError):
        cm.w8a8_matmul_bf16x(x.float(), p["w_qa_t"], p["w_scale"])


def test_wan14b_linear_routes_launch_their_kernels(dev):
    """At dim 5120: a linear takes quantize_activations into the
    multi-K-step w8a8_matmul (quantize_rows and bf16x decline) and the
    FFN runs fc1 from pre-quantized x, each against the plain chain."""
    g = torch.Generator(device=dev).manual_seed(33)
    x = (torch.randn(1, 96, 5120, generator=g, device=dev)).to(torch.bfloat16)
    p = _weight(g, 5120, 640, dev, 0.02)
    f1, f2 = _weight(g, 5120, 1536, dev, 0.02), _weight(g, 1536, 5120, dev,
                                                       0.02)
    cm.reset_launch_counts()
    y = quant.quantized_linear(p, x)
    h = quant.quantized_ffn(f1, f2, x)
    torch.cuda.synchronize()
    counts = dict(cm.launch_counts)
    assert counts["quantize_rows"] == counts["w8a8_matmul_bf16x"] == 0
    assert counts["w8a8_matmul"] == 1 and counts["w8a8_ffn1_xq"] == 1
    assert counts["w8a8_ffn2"] == 1 and counts["w8a8_ffn1"] == 0
    assert _rel_l2(y, quant.quantized_linear(p, x, kernels=False)) < 1e-3
    assert _rel_l2(h, quant.quantized_ffn(f1, f2, x, kernels=False)) < 1e-2


def _window_operands(g, dev, B, N, Lq, S, dtype):
    q = torch.randn(B, Lq, N, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, N, 128, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, N, 128, generator=g, device=dev).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,N,Lq,S,lo,hi,folded", [
    (1, 2, 96, 320, 64, 256, False),
    (2, 3, 130, 700, 0, 700, True),      # ragged tiles, the whole cache
    (1, 2, 33, 512, 100, 101, False),    # one key
    (1, 1, 200, 256, -5, 300, True),     # bounds past the cache: clamped
    (2, 3, 200, 700, 37, 611, False),    # bounds inside 32-key stages
    (1, 2, 130, 2600, 5, 2590, True),    # 81 stages: O chains folded
])
def test_decode_window_matches_plain(dev, dtype, B, N, Lq, S, lo, hi,
                                     folded):
    """The cache-window kernel against ``decode_attention_xla``'s port
    (float32, TF32 off), bounds as device scalars.  bf16: 1e-2 relative
    L2 (p rounded to bf16 for P.V); float32: 1e-4 (3xTF32 products, each
    within ~2^-21 of the f32 product, and sums in another order; the
    float32 kernel folds each 32-stage O chain into the output, which the
    81-stage case crosses twice).  Two runs are equal."""
    g = torch.Generator(device=dev).manual_seed(34)
    q, k, v = _window_operands(g, dev, B, N, Lq, S, dtype)
    if folded:
        q, k, v = (a.permute(0, 2, 1, 3).reshape(B * N, -1, 128).contiguous()
                   for a in (q, k, v))
    lo_t, hi_t = (torch.tensor(i, device=dev) for i in (lo, hi))
    name = "decode_window" if dtype == torch.bfloat16 else \
        "decode_window_f32"
    ca.reset_launch_counts()
    out = ca.decode_window(q, k, v, lo_t, hi_t)
    ref = ca.decode_window_ref(q, k, v, max(lo, 0), min(hi, S))
    torch.cuda.synchronize()
    assert ca.launch_counts[name] == 1
    assert out.shape == q.shape and out.dtype == dtype
    assert _rel_l2(out, ref) < (1e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(ca.decode_window(q, k, v, lo_t, hi_t), out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_decode_window_edges(dev, dtype):
    """An empty window gives 0 (as the TPU kernel: dead tiles skipped, l
    floored at 1e-30); keys outside the window do not move the output; a
    cache in [B, S, N, D] with q folded is folded by the wrapper."""
    g = torch.Generator(device=dev).manual_seed(35)
    q, k, v = _window_operands(g, dev, 1, 2, 64, 384, dtype)
    out = ca.decode_window(q, k, v, torch.tensor(200, device=dev),
                           torch.tensor(200, device=dev))
    assert torch.equal(out, torch.zeros_like(out))
    k2, v2 = k.clone(), v.clone()
    k2[:, :64], v2[:, 300:] = 50.0, -50.0
    a = ca.decode_window(q, k, v, 64, 300)
    b = ca.decode_window(q, k2, v2, 64, 300)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    qf = q.permute(0, 2, 1, 3).reshape(2, 64, 128).contiguous()
    c = ca.decode_window(qf, k, v, 64, 300)
    torch.testing.assert_close(c, a.permute(0, 2, 1, 3).reshape(2, 64, 128),
                               rtol=0, atol=0)
    with pytest.raises(TypeError):
        ca.decode_window(q, k.float() if dtype == torch.bfloat16 else
                         k.bfloat16(), v, 0, 10)


def test_decode_attention_gradient_kernels_vs_plain(dev):
    """The seam's autograd function: forward by the kernel (float32), the
    backward the plain recomputation, for q and both caches."""
    g = torch.Generator(device=dev).manual_seed(36)
    q, k, v = _window_operands(g, dev, 1, 2, 80, 256, torch.float32)
    grads = []
    for kernels in (True, False):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention.decode_attention(*ts, 32, 200, kernels=kernels)
        out.square().sum().backward()
        grads.append([t.grad for t in ts] + [out.detach()])
    for a, b in zip(*grads):
        assert _rel_l2(a, b) < 1e-4


def _f32_conv_operands(g, dev, B, T, H, W, C, Cout):
    """float32 operands with all 24 mantissa bits (bf16 values would leave
    the small tf32 parts zero)."""
    x = torch.randn(B, T, H, W, C, generator=g, device=dev)
    cache = torch.randn(B, 2, H, W, C, generator=g, device=dev)
    w = torch.randn(Cout, C, 3, 3, 3, generator=g, device=dev) * (
        27 * C) ** -0.5
    b = torch.randn(Cout, generator=g, device=dev) * 0.1
    return x, cache, w, b


@pytest.mark.parametrize("B,T,H,W,C,Cout", [
    (1, 1, 7, 13, 3, 96),      # C % 4 != 0: padded to 4 channels
    (1, 2, 9, 10, 16, 384),    # bn 64, a K split
    (1, 3, 5, 6, 96, 3),       # bn 32, odd Cout
    (2, 1, 4, 5, 40, 64),      # bn 64
    (1, 4, 12, 20, 96, 96),
    (1, 2, 6, 70, 8, 32),      # bn 32, two column tiles
    (1, 1, 5, 9, 6, 64),       # C % 4 != 0
    (1, 1, 8, 64, 384, 96),    # 15 K splits
    (1, 1, 5, 16, 96, 32),     # bn 32, 9 K splits
])
def test_conv3d_float32_matches_plain(dev, B, T, H, W, C, Cout):
    """The float32 conv (3xTF32 products on tf32 wgmma) against the plain
    float32 version with TF32 off: 1e-4 relative L2 (the products are
    float32-accurate; the sums run in another order, each K step's chain
    of products added to the running sum once).  Two runs are equal."""
    g = torch.Generator(device=dev).manual_seed(37)
    x, cache, w, b = _f32_conv_operands(g, dev, B, T, H, W, C, Cout)
    cc.reset_launch_counts()
    out = cc.conv3d(x, cache, w, b)
    ref = tconv.conv3d_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert cc.launch_counts["conv3d_f32"] == 1
    assert out.dtype == torch.float32 and out.shape == (B, T, H, W, Cout)
    assert _rel_l2(out, ref) < 1e-4
    assert torch.equal(cc.conv3d(x, cache, w, b), out)


@pytest.mark.parametrize("B,T,H,W,C,Cout", [
    (1, 2, 6, 8, 384, 384),    # bn 96
    (1, 2, 6, 70, 3, 32),      # C % 4 != 0, bn 32
    (1, 1, 8, 64, 384, 96),    # 12 K splits a tap
])
def test_conv_float32_split_route_matches_plain(dev, B, T, H, W, C, Cout):
    """The split route at float32 (at 384 channels the fused rule
    declines): one float32 launch a temporal tap, each tap (taps_t 1 at
    its frame offset tau0) against its plain version, and the route
    against ``split_ref``: 1e-4 relative L2.  Two runs are equal."""
    g = torch.Generator(device=dev).manual_seed(38)
    x, cache, w, b = _f32_conv_operands(g, dev, B, T, H, W, C, Cout)
    for tau in range(3):
        y = cc.conv2d_tap(x, cache, w, b, tau)
        assert _rel_l2(y, tconv.conv2d_tap_ref(x, cache, w, b, tau)) < 1e-4
        assert torch.equal(cc.conv2d_tap(x, cache, w, b, tau), y)
    cc.reset_launch_counts()
    # where the fused rule declines, causal_conv3d_pallas takes the route
    route = (tconv.causal_conv3d_pallas
             if tconv.fused_tile(H, W, C, Cout, 4) is None
             else tconv.conv3d_split)
    out = route(x, cache, w, b)
    ref = tconv.split_ref(x, cache, w, b)
    torch.cuda.synchronize()
    assert cc.launch_counts["conv3d_f32"] == 3
    assert _rel_l2(out, ref) < 1e-4


@pytest.mark.parametrize("n,H,W,cin,cout,k,stride", [
    (2, 6, 7, 512, 256, 3, 1),     # the decoder's widest conv: sums > 2^24
    (3, 5, 9, 64, 3, 3, 1),        # conv_out: 3 columns padded to 8
    (4, 9, 11, 3, 64, 3, 2),       # the encoder's RGB input, stride 2
    (1, 2, 3, 128, 256, 1, 1),     # a 1x1 TGrow, 6 rows padded to 17
])
def test_taehv_int8_conv_on_the_card_equals_the_cpu(dev, n, H, W, cin,
                                                    cout, k, stride):
    """The opt-in int8 TAEHV conv (``taehv._conv_q``): ``torch._int_mm``
    on the unfolded input on the card, a float64 product on the CPU; both
    sum the int8 products exactly, so the outputs are bit-equal (the
    largest positive inputs and weights make the 3x3 x 512 sums pass
    2^24, where a float32 sum would round)."""
    from self_forcing_tpu_torch.models import taehv
    g = torch.Generator().manual_seed(n + k + cin)
    x = torch.rand(n, H, W, cin, generator=g) * 3
    p = {"w_q": torch.randint(90, 128, (cout, cin, k, k), generator=g,
                              dtype=torch.int8),
         "w_scale": torch.rand(cout, generator=g) * 1e-3 + 1e-4,
         "b": torch.randn(cout, generator=g)}
    pad = (k - 1) // 2
    ref = taehv._conv_q(p, x, stride, pad)
    out = taehv._conv_q({key: v.to(dev) for key, v in p.items()},
                        x.to(dev), stride, pad)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)
