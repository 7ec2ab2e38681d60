"""The port's attention references (self_forcing_tpu_torch.ops) against
the JAX package on the CPU: the dispatch seam against
self_forcing_tpu.ops.attention, and the plain versions of the CUDA kernels
against the Pallas kernels run in interpret mode.  Inputs come from a
numpy seed and run in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.ops import attention as jattn
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
    assert ca.launch_counts == {"decode_fresh_free": 0, "cross_attention": 0}


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
