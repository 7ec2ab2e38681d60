"""The port's umT5 encoder against the JAX package on the CPU, at
``T5_TINY`` with ids and a padding mask in and the weights crossed over by
``params_from_jax(..., 't5')``: ``encode`` in float32 within 1e-5
relative L2, in bf16 within 2e-2 (5 bf16 ulps of 2^-8: XLA's CPU
fusions keep elementwise intermediates in float32 where the port rounds
each operation to bf16, as the JAX code's dtypes say; 7.2e-3 measured);
``encode_for_dit``'s padded rows exactly zero; the relative-position
buckets equal; the streamed encode equal to the resident one; the bf16
tree keeping ``pos_emb`` in float32; ``init_params``' tree, shapes and
dtypes those of the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.models.wan import t5 as jt5
from self_forcing_tpu_torch.models.wan import t5 as tt5
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.utils import tree

CFG = tt5.T5_TINY
L = 18


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_params(seed, dtype=jnp.float32):
    """JAX init with every leaf perturbed (the norms start at ones)."""
    rng = np.random.default_rng(seed)
    jp = jt5.init_params(jax.random.PRNGKey(seed), jt5.T5_TINY, jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    if dtype != jnp.float32:   # pos_emb stays float32, as init_params has it
        jp = jax.tree_util.tree_map_with_path(
            lambda p, a: a if "pos_emb" in jax.tree_util.keystr(p)
            else np.asarray(jnp.asarray(a, dtype)), jp)
    return jp


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, (2, L)).astype(np.int32)
    mask = np.ones((2, L), np.int32)
    mask[0, 12:] = 0
    mask[1, 7:] = 0
    ids[mask == 0] = 0
    return ids, mask


def test_encode_matches_jax_float32():
    jp = _jax_params(0)
    ids, mask = _inputs(1)
    ref = np.asarray(jt5.encode(jp, jt5.T5_TINY, jnp.asarray(ids),
                                jnp.asarray(mask)))
    tp = params_from_jax(jp, "t5", device="cpu")
    out = tt5.encode(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (2, L, CFG.dim)
    assert rel_l2(out.numpy(), ref) < 1e-5


def test_encode_matches_jax_bf16():
    jp = _jax_params(2, jnp.bfloat16)
    ids, mask = _inputs(3)
    ref = jt5.encode(jax.tree.map(jnp.asarray, jp), jt5.T5_TINY,
                     jnp.asarray(ids), jnp.asarray(mask))
    tp = params_from_jax(jp, "t5", device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 if path[-1] == "pos_emb"
               else t.dtype == torch.bfloat16 for path, t in tree.items(tp))
    out = tt5.encode(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    assert rel_l2(out.float().numpy(), np.asarray(ref, np.float32)) < 2e-2


def test_encode_for_dit_zeroes_padding_and_matches_jax():
    jp = _jax_params(4)
    ids, mask = _inputs(5)
    ref = np.asarray(jt5.encode_for_dit(jp, jt5.T5_TINY, jnp.asarray(ids),
                                        jnp.asarray(mask)))
    tp = params_from_jax(jp, "t5", device="cpu")
    out = tt5.encode_for_dit(tp, CFG, torch.from_numpy(ids),
                             torch.from_numpy(mask))
    assert torch.all(out[torch.from_numpy(mask) == 0] == 0)
    assert (out[torch.from_numpy(mask) == 1] != 0).any()
    assert rel_l2(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("length,buckets,max_dist",
                         [(1, 32, 128), (7, 32, 128), (512, 32, 128),
                          (7, 8, 16), (512, 8, 128)])
def test_relative_position_buckets_equal_jax(length, buckets, max_dist):
    out = tt5.relative_position_buckets(length, buckets, max_dist)
    ref = jt5.relative_position_buckets(length, buckets, max_dist)
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, ref)


def test_encode_streamed_matches_encode():
    cfg = tt5.T5Config(dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
                       num_layers=3, vocab_size=128, num_buckets=8,
                       max_dist=16)
    params = tt5.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    ids = torch.tensor([[5, 9, 2, 0, 0]])
    mask = torch.tensor([[1, 1, 1, 0, 0]])
    ref = tt5.encode_for_dit(params, cfg, ids, mask)
    out = tt5.encode_streamed(params, cfg, ids, mask, device="cpu")
    assert torch.equal(out, ref)
    assert torch.all(out[0, 3:] == 0)


def test_gelu_and_layer_norm_match_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 64)) * 3).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tt5.gelu_erf_free(torch.from_numpy(x)).numpy(),
        np.asarray(jt5.gelu_erf_free(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tt5.t5_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                          1e-6).numpy(),
        np.asarray(jt5.t5_layer_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_tree_matches_jax(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ref = jax.eval_shape(lambda k: jt5.init_params(k, jt5.T5_TINY, jdt),
                         jax.random.PRNGKey(0))
    ref_items = {jax.tree_util.keystr(p): v for p, v in
                 jax.tree_util.tree_flatten_with_path(ref)[0]}
    tp = tt5.init_params(CFG, seed=0, dtype=dtype, device="cpu")
    items = {"".join(f"['{k}']" for k in path): t
             for path, t in tree.items(tp)}
    assert items.keys() == ref_items.keys()
    for k, t in items.items():
        assert tuple(t.shape) == ref_items[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(ref_items[k].dtype), k
    # the JAX package's scales: q by (d * d_attn)^-0.5, the embedding N(0, 1)
    assert abs(float(tp["token_embedding"].float().std()) - 1) < 0.05
    q_std = float(tp["blocks"]["attn"]["q"]["w"].float().std())
    assert abs(q_std * CFG.dim - 1) < 0.1
