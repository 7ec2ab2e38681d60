"""The port's CUDA attention kernels against their plain PyTorch versions,
on the card.  Small and ragged shapes (edges the main path's shapes do not
reach) plus one call at the 1.3B shapes each.

These tests need an NVIDIA Hopper card and nvcc; they skip elsewhere.  On
a machine with the card (where JAX is not installed) run them with

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest
"""
import pytest
import torch

from self_forcing_tpu_torch.ops import cuda_attention as ca

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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2 * 64, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        ca.cross_attention(q, k, k, num_heads=2)      # head_dim 64
    with pytest.raises(TypeError):
        ca.cross_attention(q.float(), k.float(), k.float(), num_heads=2)
