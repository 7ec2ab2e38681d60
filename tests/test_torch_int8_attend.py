"""The full-int8 decode attention's plain version (``ops/cuda_attention.py``)
on the CPU: the identity its CUDA kernel's max pass rests on, and the
plain version against the interpreted Pallas kernel where a cache tile
holds the sink, a dead gap and the start of the window.

- The kernel takes a Pallas tile's row max as an integer: m_t =
  float(max s32) * a with a = qs * (ks * scale), the max over the visible
  columns.  It equals the max of the plain version's float scores
  (``_int8_scores``, masked columns at -1e30) bit for bit, because a > 0,
  float(s32) is exact below 2**24 and rounding a product is monotone.
- ``decode_fresh_int8_ref`` against ``decode_attention_fresh_pallas(...,
  quant='int8', sink_end=..., interpret=True)`` in 'tile', 'global' and
  online mode: relative L2 <= 1e-3, as tests/test_torch_softmax_modes.py
  holds the window without a sink.

Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.ops import pallas_attention as jpa
from self_forcing_tpu_torch.ops import attention as tattn
from self_forcing_tpu_torch.ops import cuda_attention as ca

N, D, LQ = 2, 128, 96
INT_MIN = -2 ** 31


# (seed, columns, log10 range of qs, ks and scale, share of masked columns)
MAX_CASES = {
    "extremes": (40, 300, (-3, 1), 0.3),
    "tiny_scales": (41, 129, (-9, -5), 0.5),
    "one_visible": (42, 64, (-2, 2), None),
}


@pytest.mark.parametrize("case", list(MAX_CASES))
def test_integer_row_max_equals_the_float_max(case):
    """float(max s32) * a against the max of the plain version's float
    scores, bit for bit, per row; the int8 values reach +-127, so the
    int32 sums reach 127**2 * 128, and masked columns (the plain version's
    -1e30, the kernel's INT_MIN) hold the largest sums."""
    seed, cols, (lo, hi), masked = MAX_CASES[case]
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-127, 128, (LQ, D), dtype=np.int8)
    k8 = rng.integers(-127, 128, (cols, D), dtype=np.int8)
    q8[:4] = 127
    k8[:3] = 127          # the largest sum, in masked columns below
    k8[3] = -127
    k8[4] = q8[4]         # a row's largest visible sum is its own square
    qs = (10.0 ** rng.uniform(lo, hi, (LQ, 1))).astype(np.float32)
    ks = np.float32(10.0 ** rng.uniform(lo, hi))
    scale = np.float32(10.0 ** rng.uniform(lo, hi))
    if masked is None:
        vis = np.zeros(cols, bool)
        vis[4] = True
    else:
        vis = rng.random(cols) >= masked
        vis[:3] = False
        vis[3:5] = True
    tq8, tk8 = torch.from_numpy(q8), torch.from_numpy(k8)
    tqs, tvis = torch.from_numpy(qs), torch.from_numpy(vis)
    s = ca._int8_scores(tq8, tk8, tqs, torch.tensor(ks), torch.tensor(scale))
    want = torch.where(tvis, s, ca._NEG_INF).amax(dim=-1)
    s32 = tq8.long() @ tk8.long().T
    assert int(s32.abs().max()) == 127 ** 2 * D
    imax = torch.where(tvis, s32, INT_MIN).amax(dim=-1)
    a = tqs[:, 0] * (torch.tensor(ks) * torch.tensor(scale))
    got = imax.to(torch.float32) * a
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _inputs(seed, S):
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.standard_normal((1, LQ, N * D)).astype(np.float32)
                 for _ in range(3))
    kc, vc = (rng.standard_normal((2, N, S, D)).astype(np.float32)
              for _ in range(2))
    return q, kc, vc, kn, vn


@pytest.mark.parametrize("mode", ["tile", "global", "online"])
def test_int8_ref_matches_pallas_with_a_sink_inside_a_tile(mode):
    """Cache tiles of 64 rows (decode_tiles at Lq 96, S 256, tq 32, tk
    64); the sink [0, 20) and the window from 40 share tile 0, tiles 1-2
    hold the window, tile 3 is past it; 'tile' gets the max score + 11,
    'global' + 0.5."""
    S, sink, lo, hi = 256, 20, 40, 180
    q, kc, vc, kn, vn = _inputs(50, S)
    qh = q.reshape(LQ, N, D).transpose(1, 0, 2)
    keys = np.concatenate([kc[1][:, :sink], kc[1][:, lo:hi],
                           kn.reshape(LQ, N, D).transpose(1, 0, 2)], axis=1)
    smax = (np.einsum("nld,nsd->nls", qh, keys) * D ** -0.5).max()
    kw, m0 = {}, None
    if mode != "online":
        m0 = np.float32(smax + (0.5 if mode == "global" else 11.0))
        kw = dict(fixed_m0=m0, int8_bound=mode)
    ref = np.asarray(jpa.decode_attention_fresh_pallas(
        q, kc, vc, kn, vn, jnp.int32(lo), jnp.int32(hi), tq=32, tk=64,
        interpret=True, layer_idx=jnp.int32(1), heads_packed=N,
        sink_end=jnp.int32(sink), quant="int8", **kw))
    tq, tk, tf = tattn.decode_tiles(LQ, S, LQ, "int8", None, tq=32, tk=64)
    out = ca.decode_fresh_int8_ref(
        *(torch.from_numpy(a) for a in (q, kc, vc, kn, vn)), mode=mode,
        m0=None if m0 is None else torch.tensor(m0), layer_idx=1,
        kv_start=lo, kv_end=hi, sink_end=sink, num_heads=N,
        scale=D ** -0.5, tq=tq, tk=tk, tf=tf)
    err = float(np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref))
    assert err <= 1e-3, err
