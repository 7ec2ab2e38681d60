"""The card path of the decode and cross attention backward (SDPA's
backward on the gathered visible keys: ``cuda_attention.decode_fresh_bwd``
and ``cross_attention_bwd``), called directly on CPU tensors in float32,
against the JAX custom VJPs of the interpreted Pallas ops (which replay
the XLA reference under ``jax.vjp``), as
``tests/test_torch_flash.py::test_decode_gradient_matches_jax_vjp`` does
for the seam; and the seam's routing of the CPU to the fp32 plain
versions (``*_bwd_ref``).

Inputs come from numpy and are handed to both packages in float32.
Tolerance 1e-4: fp32 sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.ops import pallas_attention as jpa
from self_forcing_tpu_torch.ops import attention as tattn
from self_forcing_tpu_torch.ops import cuda_attention as ca

B, N, D = 1, 2, 128
LOG2E = 1.4426950408889634
TOL = 1e-4

# (Lq, S, kv_start, kv_end, sink_end)
DECODE_CASES = {
    "sink_and_window": (48, 256, 96, 224, 32),
    "window_past_zero": (40, 192, 70, 150, 0),
    "empty_window": (32, 128, 0, 0, 0),
    "sink_only": (32, 160, 100, 100, 48),
}


def _np(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _packed(a):
    """[B, L, N, D] numpy -> heads-packed [B, L, N*D] torch."""
    return torch.from_numpy(a.reshape(a.shape[0], a.shape[1], -1).copy())


def _folded_cache(a):
    """[B, S, N, D] -> the port's stacked [1, B*N, S, D] cache."""
    Bc, S, Nc, Dc = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(1, Bc * Nc, S, Dc)))


@pytest.mark.parametrize("free", [False, True])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_fresh_bwd_matches_jax_vjp(case, free):
    """dq, dk_new, dv_new of SDPA's backward on the gathered visible keys
    (sinks, a window starting past 0, an empty window) against the JAX
    custom VJP of the interpreted Pallas op for one cotangent; in free
    mode the port's base-e scale is the free softmax's scale times ln 2."""
    Lq, S, lo, hi, sink = DECODE_CASES[case]
    q, kc, vc, kn, vn, g = _np(40 + free, (B, Lq, N, D), (B, S, N, D),
                               (B, S, N, D), (B, Lq, N, D), (B, Lq, N, D),
                               (B, Lq, N, D))
    if free:
        q = q * np.float32(D ** -0.5 * LOG2E)
    kw = dict(scale=1.0, softmax="free") if free else {}
    kcj, vcj = jnp.asarray(kc), jnp.asarray(vc)
    _, vjp = jax.vjp(lambda a, b, c: jpa.decode_attention_fresh_pallas(
        a, kcj, vcj, b, c, jnp.int32(lo), jnp.int32(hi), tq=32, tk=64,
        interpret=True, sink_end=jnp.int32(sink), **kw),
        *(jnp.asarray(x) for x in (q, kn, vn)))
    gj = vjp(jnp.asarray(g))
    scale = np.log(2.0) if free else D ** -0.5
    got = ca.decode_fresh_bwd(
        _packed(q), _folded_cache(kc), _folded_cache(vc), _packed(kn),
        _packed(vn), _packed(g), layer_idx=0, kv_start=lo, kv_end=hi,
        sink_end=sink, num_heads=N, scale=float(scale))
    for a, b in zip(got, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("Lk", [96, 512])
def test_cross_attention_bwd_matches_jax_vjp(Lk):
    """q, k, v grads of SDPA's backward on the [B, N, L, D] views against
    the JAX custom VJP of the interpreted cross-attention Pallas op."""
    q, k, v, g = _np(50 + Lk, (B, 64, N * D), (B, Lk, N, D), (B, Lk, N, D),
                     (B, 64, N * D))
    _, vjp = jax.vjp(lambda a, b, c: jpa.cross_attention_pallas(
        a, b, c, tq=32, interpret=True, heads_packed=N),
        *(jnp.asarray(x) for x in (q, k, v)))
    gj = vjp(jnp.asarray(g))
    got = ca.cross_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, g)),
                                 num_heads=N)
    for a, b in zip(got, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("Bt,Nt,sink,lo,hi", [
    (2, 3, 24, 40, 120),    # two batches, three heads
    (1, 2, 90, 40, 120),    # the sinks overlap the window
    (2, 1, 0, 0, 130),      # folded layout (N = 1), the window from 0
])
def test_decode_fresh_bwd_matches_the_plain_version(Bt, Nt, sink, lo, hi):
    """The gather of every (batch, head) at once against the fp32 plain
    version's per-head loop, in float32 (the cache row past the window is
    never read: NaN there stays out of the gradients)."""
    Lq, S = 24, 128
    q, kn, vn, g = _np(60, *[(Bt, Lq, Nt * D)] * 4)
    kc, vc = _np(61, (2, Bt * Nt, S, D), (2, Bt * Nt, S, D))
    kc[1, :, max(sink, hi):] = np.nan
    vc[1, :, max(sink, hi):] = np.nan
    args = [torch.from_numpy(x) for x in (q, kc, vc, kn, vn, g)]
    kw = dict(layer_idx=1, kv_start=lo, kv_end=hi, sink_end=sink,
              num_heads=Nt, scale=0.07)
    got = ca.decode_fresh_bwd(*args, **kw)
    want = ca.decode_fresh_bwd_ref(*args, **kw)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lim,lo,hi,sink", [
    (200, 40, 120, 24), (200, 40, 120, 90), (120, 40, 200, 0),
    (100, 0, 0, 0), (64, 80, 100, 30), (150, 150, 150, 200)])
def test_visible_columns_are_the_plain_versions_columns(lim, lo, hi, sink):
    """The gathered cache columns, made without a host sync, are the plain
    version's boolean selection, in the same order."""
    j = torch.arange(lim)
    want = j[(j < sink) | ((j >= lo) & (j < hi))]
    torch.testing.assert_close(ca.visible_columns(lim, lo, hi, sink, "cpu"),
                               want, rtol=0, atol=0)


@pytest.mark.parametrize("route", [False, True])
def test_seam_routes_the_cpu_to_the_fp32_backward(route, monkeypatch):
    """On CPU tensors the decode and cross autograd functions take the
    fp32 plain versions, also where a test forces the kernel route; the
    SDPA backward runs on CUDA tensors only."""
    monkeypatch.setattr(tattn, "_kernel_route", lambda t: route)
    called = []

    def refuse(*a, **k):
        raise AssertionError("the card backward ran on CPU tensors")

    def spy(name):
        fn = getattr(ca, name)

        def wrapped(*a, **k):
            called.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("decode_fresh_bwd", "cross_attention_bwd"):
        monkeypatch.setattr(ca, name, refuse)
        monkeypatch.setattr(ca, name + "_ref", spy(name + "_ref"))
    q, kn, vn = (t.requires_grad_(True) for t in (
        torch.from_numpy(x) for x in _np(70, *[(B, 16, N * D)] * 3)))
    kc, vc = (torch.from_numpy(x) for x in _np(71, (1, B * N, 64, D),
                                               (1, B * N, 64, D)))
    out = tattn.decode_attention_fresh(q, kc, vc, kn, vn, 8, 40,
                                       layer_idx=0, heads_packed=N)
    k4, v4 = (t.requires_grad_(True) for t in (
        torch.from_numpy(x) for x in _np(72, (B, 24, N, D), (B, 24, N, D))))
    out = out + tattn.cross_attention(q, k4, v4, heads_packed=N)
    out.square().sum().backward()
    assert sorted(called) == ["cross_attention_bwd_ref",
                              "decode_fresh_bwd_ref"]


def test_sdpa_backward_counts_its_calls():
    """Each call of the card backward adds one to its launch count (the
    count a train step's run reads), and the plain versions add none."""
    q, kn, vn, g = (torch.from_numpy(x) for x in _np(80, *[(B, 8, N * D)] * 4))
    kc, vc = (torch.from_numpy(x) for x in _np(81, (1, B * N, 32, D),
                                               (1, B * N, 32, D)))
    k4, v4 = (torch.from_numpy(x) for x in _np(82, (B, 8, N, D),
                                               (B, 8, N, D)))
    ca.reset_launch_counts()
    kw = dict(layer_idx=0, kv_start=0, kv_end=16, num_heads=N, scale=0.1)
    ca.decode_fresh_bwd(q, kc, vc, kn, vn, g, **kw)
    ca.decode_fresh_bwd_ref(q, kc, vc, kn, vn, g, **kw)
    for _ in range(2):
        ca.cross_attention_bwd(q, k4, v4, g, num_heads=N)
    ca.cross_attention_bwd_ref(q, k4, v4, g, num_heads=N)
    assert ca.launch_counts["decode_fresh_bwd"] == 1
    assert ca.launch_counts["cross_attention_bwd"] == 2
