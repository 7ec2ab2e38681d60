"""The port's masked flash attention and the attention gradients against
the JAX package on the CPU, mirroring ``tests/test_pallas_attention.py``:

- the IntervalMask families equal the JAX package's interval arrays, and
  the kernels' tile tables agree with the Pallas wrapper's
  ``_tile_states`` (the same dead tiles; a tile the port calls fully
  visible is fully visible there too);
- ``flash_attention_xla`` (the CPU route) against the JAX
  ``flash_attention_xla`` and ``flash_attention_pallas(interpret=True)``
  for block-causal, teacher-forcing, no mask and an odd length of 200;
- the free-mode plain forward ``flash_fwd_ref`` (the CUDA forward's
  function) against the interpreted Pallas kernel in free mode;
- dq, dk, dv of both routes against ``jax.grad`` of the interpreted
  Pallas op (2e-4, as the JAX tests use), and the one backward
  ``flash_bwd`` against the Pallas ``_flash_bwd`` on the same residuals
  in the free and online modes;
- the decode and cross attention gradients against the JAX custom VJPs,
  including a KV cache written past the window after the forward.

Inputs come from numpy and are handed to both packages in float32.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from self_forcing_tpu.ops import attention as jattn
from self_forcing_tpu.ops import masks as jmasks
from self_forcing_tpu.ops import pallas_attention as jpa
from self_forcing_tpu_torch.ops import attention as tattn
from self_forcing_tpu_torch.ops import cuda_attention as ca
from self_forcing_tpu_torch.ops import masks as tmasks

B, N, D = 1, 2, 128
LOG2E = 1.4426950408889634
FWD_TOL = 2e-5   # as the JAX tests: fp32 sums in another order
GRAD_TOL = 2e-4

MASKS = {
    "block_causal": ("block_causal_mask", (4, 64, 2)),
    "block_causal_local": ("block_causal_mask", (6, 16, 3, 2)),
    "i2v": ("block_causal_mask_i2v", (5, 16, 2)),
    "teacher_forcing": ("teacher_forcing_mask", (2, 64, 1)),
    "teacher_forcing_odd": ("teacher_forcing_mask", (5, 20, 1)),
}


def _masks(name):
    fn, args = MASKS[name]
    return getattr(jmasks, fn)(*args), getattr(tmasks, fn)(*args)


def _qkv(seed, Lq, Lk):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, L, N, D)).astype(np.float32)
                 for L in (Lq, Lk, Lk))


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("name", list(MASKS))
def test_masks_equal_jax(name):
    jm, tm = _masks(name)
    for f in ("start1", "end1", "start2", "end2"):
        np.testing.assert_array_equal(getattr(tm, f), np.asarray(
            getattr(jm, f)))
    np.testing.assert_array_equal(tm.materialize(),
                                  np.asarray(jm.materialize()))


@pytest.mark.parametrize("name", ["block_causal", "teacher_forcing_odd",
                                  "block_causal_local"])
def test_tile_states_agree_with_pallas(name):
    """Dead tiles equal; a tile the port marks fully visible is fully
    visible in the Pallas table (the port may mask a few more)."""
    jm, tm = _masks(name)
    L = tm.seq_len
    for rows, cols, whole in ((128, 64, False), (128, 128, False),
                              (64, 128, True), (32, 64, True),
                              (16, 16, True)):
        ours = ca.flash_tile_states(tm, L, L, rows, cols, whole)
        qt, kt = ours.shape
        theirs = jpa._tile_states(*(np.asarray(a) for a in (
            jm.start1, jm.end1, jm.start2, jm.end2)), L, L, rows, cols, qt,
            kt)
        np.testing.assert_array_equal(ours == 0, theirs == 0)
        assert not np.any((ours == 2) & (theirs != 2))


@pytest.mark.parametrize("name", list(MASKS) + ["none", "sees_nothing"])
def test_flash_tile_lists_walk_every_live_tile_heaviest_first(name):
    """flash_fwd's tile lists, counts, query-tile order and runs against
    its tile states at 128 x 128: each query tile lists exactly its live
    key tiles in order with their partial bit; a query tile that sees no
    key lists tile 0 as partial; the order holds every query tile once,
    by live-tile count, most first; each position's run spans exactly
    the positions of its count; and the kernel's item walk (run by run,
    head by head) visits every (query tile, head) once, most live tiles
    first."""
    if name == "none":
        mask, L = None, 300
    elif name == "sees_nothing":   # queries [128, 256) see no key
        L = 400
        e1 = np.full(L, L, np.int32)
        e1[128:256] = 0
        z = np.zeros(L, np.int32)
        mask = tmasks.IntervalMask(z, e1, z, z)
    else:
        mask = _masks(name)[1]
        L = mask.seq_len
    states = ca.flash_tile_states(mask, L, L, ca.FLASH_ROWS, ca.FLASH_KEYS,
                                  False)
    tiles, count, order, run = ca.flash_tile_lists(states)
    geo = ca.flash_geometry(mask, L, L, torch.device("cpu"))
    for got, want in zip((geo.tiles_q, geo.count_q, geo.order_q,
                          geo.runs_q), (tiles, count, order, run)):
        np.testing.assert_array_equal(got.numpy(), want)
    for qt in range(states.shape[0]):
        live = np.flatnonzero(states[qt])
        want = (2 * live + (states[qt, live] == 1) if live.size
                else np.array([1]))
        np.testing.assert_array_equal(tiles[qt, :count[qt]], want)
        assert not tiles[qt, count[qt]:].any()
    nq = states.shape[0]
    assert sorted(order.tolist()) == list(range(nq))
    assert np.all(np.diff(count[order]) <= 0)
    for p in range(nq):
        s, n = run[:, p]
        same = np.flatnonzero(count[order] == count[order[p]])
        np.testing.assert_array_equal(same, np.arange(s, s + n))
    BN = 3   # the kernel's item w -> (query tile, b*n)
    items = []
    for w in range(nq * BN):
        s, n = run[:, w // BN]
        o = w - BN * s
        items.append((order[s + o % n], o // n))
    assert sorted(items) == [(q, b) for q in range(nq) for b in range(BN)]
    assert np.all(np.diff([count[q] for q, _ in items]) <= 0)
    if name == "sees_nothing":
        assert count[1] == 1 and tiles[1, 0] == 1


def test_flash_geometry_lives_with_its_mask():
    """The kernels' tables are built once per (mask, lengths, device) and
    held only while the mask lives: masks built anew for every forward
    leave nothing behind."""
    cpu = torch.device("cpu")
    m = tmasks.block_causal_mask(4, 64, 2)
    geo = ca.flash_geometry(m, 256, 256, cpu)
    assert ca.flash_geometry(m, 256, 256, cpu) is geo
    np.testing.assert_array_equal(geo.iv[:, :256].numpy(), np.stack(
        ca.flash_intervals(m, 256, 256)))
    full = ca.flash_geometry(None, 256, 256, cpu)
    assert ca.flash_geometry(None, 256, 256, cpu) is full
    held = len(ca._flash_geometry)
    for _ in range(3):
        ca.flash_geometry(tmasks.block_causal_mask(4, 64, 2), 256, 256, cpu)
    gc.collect()
    assert len(ca._flash_geometry) == held
    del m
    gc.collect()
    assert len(ca._flash_geometry) == held - 1


FLASH_CASES = {
    "block_causal": (256, "block_causal"),
    "teacher_forcing": (256, "teacher_forcing"),
    "no_mask": ((128, 192), None),
    "odd_length": (200, "teacher_forcing_odd"),
}


def _case(name):
    L, mask_name = FLASH_CASES[name]
    Lq, Lk = (L, L) if isinstance(L, int) else L
    jm, tm = _masks(mask_name) if mask_name else (None, None)
    return Lq, Lk, jm, tm


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_xla_matches_jax(case):
    Lq, Lk, jm, tm = _case(case)
    q, k, v = _qkv(2, Lq, Lk)
    out = tattn.flash_attention_xla(*_t(q, k, v), tm).numpy()
    ref = jattn.flash_attention_xla(q, k, v, jm)
    pal = jpa.flash_attention_pallas(q, k, v, jm, tq=128, tk=128,
                                     interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(out, np.asarray(pal), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("case", ["block_causal", "odd_length"])
def test_flash_gradients_match_pallas(case):
    """The CPU route's gradient (the plain FA2 backward at head_dim**-0.5
    from the online forward's lse) against jax.grad of the interpreted
    Pallas kernels."""
    Lq, Lk, jm, tm = _case(case)
    q, k, v = _qkv(5, Lq, Lk)
    gj = jax.grad(lambda a, b, c: jnp.sum(jpa.flash_attention_pallas(
        a, b, c, jm, tq=128, tk=128, interpret=True) ** 2),
        argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = _t(q, k, v, grad=True)
    (tattn.flash_attention(tq, tk, tv, tm) ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("case", ["block_causal", "odd_length"])
def test_flash_free_mode_matches_pallas(case):
    """The CUDA kernels' function in free mode (base-2, no running max, p
    rounded to bf16 for P.V; the backward at ln 2 against the base-e lse)
    against the interpreted Pallas kernel in free mode: forward, lse and
    gradients."""
    Lq, Lk, jm, tm = _case(case)
    q, k, v = _qkv(50, Lq, Lk)
    qp = q * np.float32(D ** -0.5 * LOG2E)
    out, lse = ca.flash_fwd_ref(*_t(qp, k, v), tm)
    s1, e1, s2, e2 = (np.asarray(a)[:Lq] for a in (
        jm.start1, jm.end1, jm.start2, jm.end2))
    jout, jlse = jpa._flash_fwd(*_j(qp, k, v), s1, e1, s2, e2, 1.0, 128, 128,
                                True, bounded="free")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.reshape(B * N, Lq).numpy(),
                               np.asarray(jlse)[:, :Lq], rtol=FWD_TOL,
                               atol=FWD_TOL)
    gj = jax.grad(lambda a, b, c: jnp.sum(jpa.flash_attention_pallas(
        a, b, c, jm, tq=128, tk=128, interpret=True, softmax="free") ** 2),
        argnums=(0, 1, 2))(*_j(qp, k, v))
    tq, tk, tv = _t(qp, k, v, grad=True)
    o = tattn.FlashAttention.apply(tq, tk, tv, tm, 1.0, "free", None, True)
    (o ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("mode", ["free", "online"])
@pytest.mark.parametrize("case", ["block_causal", "odd_length", "no_mask"])
def test_flash_bwd_matches_pallas(case, mode):
    """The one backward (``flash_bwd``: dq, dk and dv; on the CPU its
    plain versions) against the Pallas backward ``_flash_bwd`` (both
    kernels, interpreted), fed the same q, k, v, out, lse and dO: the
    free mode's forward at ln 2 (q carrying head_dim**-0.5 * log2(e)) and
    the online mode's at head_dim**-0.5, out and lse from the interpreted
    Pallas forward of that mode.  GRAD_TOL (2e-4): fp32 sums in another
    order."""
    Lq, Lk, jm, tm = _case(case)
    q, k, v = _qkv(60, Lq, Lk)
    do = np.random.default_rng(61).standard_normal(q.shape).astype(
        np.float32)
    free = mode == "free"
    if free:
        q = q * np.float32(D ** -0.5 * LOG2E)
    fwd_scale, scale = (1.0, np.log(2.0)) if free else (D ** -0.5,) * 2
    iv = ca.flash_intervals(tm, Lq, Lk)
    out, lse = jpa._flash_fwd(*_j(q, k, v), *iv, fwd_scale, 128, 128, True,
                              bounded="free" if free else False)
    out, lse = np.array(out), np.array(lse[:, :Lq])
    gj = jpa._flash_bwd(*_j(q, k, v, out, lse, do), *iv, float(scale), 128,
                        128, True)
    tq, tk, tv, tout, tdo = _t(q, k, v, out, do)
    delta = ca.flash_delta(tout, tdo)
    got = ca.flash_bwd(tq, tk, tv, tdo,
                       torch.from_numpy(lse.reshape(B, N, Lq)), delta, tm,
                       float(scale))
    for a, b in zip(got, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# ------------------------------------------------ decode / cross grads

def _decode_inputs(seed, Lq, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, N, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, N, D)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, Lq, N, D)).astype(np.float32)
              for _ in range(2))
    return q, kc, vc, kn, vn


def _packed(a):
    return torch.from_numpy(a.reshape(B, a.shape[1], N * D).copy())


def _folded_cache(a):
    """[B, S, N, D] -> the port's stacked [1, B*N, S, D] cache."""
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(1, B * N, a.shape[1], D)))


@pytest.mark.parametrize("free", [False, True])
def test_decode_gradient_matches_jax_vjp(free):
    """dq, dk_new, dv_new of the decode attention (heads-packed, stacked
    cache) for one cotangent against the JAX custom VJP of the interpreted
    Pallas op (as test_decode_fresh_grad_matches_xla and, in free mode,
    test_decode_fresh_free_softmax_grad); the cache rows past the window
    are overwritten between the forward and the backward."""
    Lq, S, lo, hi = 64, 256, 32, 160
    q, kc, vc, kn, vn = _decode_inputs(10 + free, Lq, S)
    if free:
        q = q * np.float32(D ** -0.5 * LOG2E)
    g = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    kw = dict(scale=1.0, softmax="free") if free else {}
    kcj, vcj = _j(kc, vc)
    _, vjp = jax.vjp(lambda a, b, c: jpa.decode_attention_fresh_pallas(
        a, kcj, vcj, b, c, jnp.int32(lo), jnp.int32(hi), tq=32, tk=64,
        interpret=True, **kw), *_j(q, kn, vn))
    gj = vjp(jnp.asarray(g))
    tq, tkn, tvn = (_packed(a).requires_grad_(True) for a in (q, kn, vn))
    k_cache, v_cache = _folded_cache(kc), _folded_cache(vc)
    out = tattn.decode_attention_fresh(tq, k_cache, v_cache, tkn, tvn, lo,
                                       hi, layer_idx=0, heads_packed=N, **kw)
    k_cache[:, :, hi:] = 7.0   # a later block's write, past the window
    v_cache[:, :, hi:] = -7.0
    out.backward(_packed(g))
    for a, b in zip((tq.grad, tkn.grad, tvn.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(
            a.shape), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_decode_gradient_refuses_a_rewritten_window(remat):
    """A write inside the window between the forward and the backward
    raises, also when the forward is checkpointed (its replay reads the
    rewritten cache; the check runs with the first forward's rows)."""
    Lq, S, lo, hi = 16, 64, 0, 48
    q, kc, vc, kn, vn = _decode_inputs(12, Lq, S)
    tq, tkn, tvn = (_packed(a).requires_grad_(True) for a in (q, kn, vn))
    k_cache, v_cache = _folded_cache(kc), _folded_cache(vc)

    def attend(a, b, c):
        return tattn.decode_attention_fresh(a, k_cache, v_cache, b, c, lo,
                                            hi, layer_idx=0, heads_packed=N)
    out = (checkpoint(attend, tq, tkn, tvn, use_reentrant=False) if remat
           else attend(tq, tkn, tvn))
    k_cache[:, :, hi - 1] = 0.0
    with pytest.raises(RuntimeError, match="changed after the forward"):
        out.sum().backward()


def test_cross_attention_gradient_matches_jax_vjp():
    """As test_cross_attention_grad_matches_dense: q, k, v grads of the
    heads-packed cross attention for one cotangent against the JAX custom
    VJP of the interpreted Pallas op."""
    rng = np.random.default_rng(22)
    q = rng.standard_normal((B, 64, N * D)).astype(np.float32)
    k, v = (rng.standard_normal((B, 96, N, D)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jpa.cross_attention_pallas(
        a, b, c, tq=32, interpret=True, heads_packed=N), *_j(q, k, v))
    gj = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, grad=True)
    tattn.cross_attention(tq, tk, tv, heads_packed=N).backward(
        torch.from_numpy(g))
    for a, b in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("op", ["decode", "cross", "flash"])
def test_plain_versions_agree_across_row_chunks(op, monkeypatch):
    """The plain versions chunk query rows by score count (``_SCORES``);
    many small chunks give what one chunk gives, fp32 sums aside."""
    rng = np.random.default_rng(31)
    Lq, Lk = 40, 96
    q, kn, vn, g = (torch.from_numpy(rng.standard_normal(
        (B, Lq, N * D)).astype(np.float32)) for _ in range(4))
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (1, B * N, Lk, D)).astype(np.float32)) for _ in range(2))
    k4, v4 = (t[0].reshape(B, N, Lk, D).permute(0, 2, 1, 3).contiguous()
              for t in (kc, vc))
    q4, g4 = (t.reshape(B, Lq, N, D) for t in (q, g))
    mask = tmasks.block_causal_mask(4, 10, 1)

    def run():
        if op == "decode":
            return ca.decode_fresh_bwd_ref(q, kc, vc, kn, vn, g,
                                           layer_idx=0, kv_start=8,
                                           kv_end=80, num_heads=N,
                                           scale=0.05)
        if op == "cross":
            return ca.cross_attention_bwd_ref(q, k4, v4, g, num_heads=N)
        kq = k4[:, :Lq]
        out, lse = ca.flash_fwd_ref(q4 * 0.1, kq, v4[:, :Lq], mask)
        delta = ca.flash_delta(out, g4)
        return (out, lse,
                ca.flash_bwd_dq_ref(q4 * 0.1, kq, v4[:, :Lq], g4, lse, delta,
                                    mask),
                *ca.flash_bwd_dkv_ref(q4 * 0.1, kq, v4[:, :Lq], g4, lse,
                                      delta, mask))
    whole = run()
    monkeypatch.setattr(ca, "_SCORES", 7 * Lk)   # 7 rows a chunk
    assert len(ca._row_chunks(Lq, Lk)) == 6
    for a, b in zip(run(), whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
