"""The port's per-rank memory estimate (``self_forcing_tpu_torch/
parallel/fit.py``) against the JAX package's byte accounting
(``parallel/aot.py::per_device_bytes`` of ``ShapeDtypeStruct`` trees
sharded by ``parallel/tensor.py``'s specs on the conftest's CPU mesh,
shapes only, nothing compiled) at Wan-14B's shapes, and against the
bytes a rank's shard actually holds at a tiny size.  Byte counts are
exact."""
import jax
import jax.numpy as jnp
import pytest
import torch

from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_14B as J_14B
from self_forcing_tpu.parallel import aot
from self_forcing_tpu.parallel import tensor as jtp
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import (WAN_14B, WAN_I2V_14B,
                                                       WanConfig)
from self_forcing_tpu_torch.parallel import fit, tensor
from self_forcing_tpu_torch.utils import tree

FS, FRAMES = 1560, 21


def _bytes(t):
    return sum(a.numel() * a.element_size() for a in tree.leaves(t))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_bytes_match_jax_at_wan14b(tp):
    """Parameters, KV cache and context K/V of one rank of the Wan-14B
    sampler, against the JAX package's specs."""
    mesh = jtp.tp_mesh(tp)
    p_shapes = jax.eval_shape(
        lambda: jdit.init_params(jax.random.PRNGKey(0), J_14B, jnp.bfloat16))
    jparams = aot.per_device_bytes(
        aot._structs(mesh, p_shapes, jtp.tp_param_specs(p_shapes)))
    c_shapes = jax.eval_shape(
        lambda: jdit.init_kv_cache(J_14B, 1, FS, FRAMES, jnp.bfloat16))
    jcache = aot.per_device_bytes(
        aot._structs(mesh, c_shapes, jtp._cache_specs()))
    ctx_shapes = jax.eval_shape(
        lambda p, c: jdit.precompute_context(p, J_14B, c), p_shapes,
        jax.ShapeDtypeStruct((1, 512, J_14B.text_dim), jnp.bfloat16))
    jctx = aot.per_device_bytes(
        aot._structs(mesh, ctx_shapes, jtp._ctx_specs(ctx_shapes)))
    est = fit.tp_sampler_fit(tp=tp, limit=80 * 2 ** 30)
    assert est["params"] == jparams
    # the JAX cache also keeps its two indices on the device (int32
    # scalars); the port's are Python ints
    assert est["kv_cache"] + 8 == jcache
    assert est["context"] == jctx
    assert est["total"] == sum(est[k] for k in (
        "params", "kv_cache", "context", "activations"))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_bytes_are_what_a_rank_holds(tp):
    cfg = WanConfig(dim=128, ffn_dim=256, num_heads=4, num_layers=2,
                    text_dim=64, freq_dim=32, model_type="i2v", in_dim=36)
    full = dit.init_params(cfg, 0, torch.float32, "cpu")
    held = [_bytes(tensor.shard_params(full, r, tp)) for r in range(tp)]
    assert held == [fit.param_bytes(cfg, tp, torch.float32)] * tp
    assert fit.param_bytes(cfg, 1, torch.float32) == _bytes(full)


def test_table_covers_the_aot_programs():
    rows = fit.table(limit=80 * 2 ** 30)
    assert [r["label"] for r in rows] == [
        "tp_sampler tp=1", "tp_sampler tp=2", "tp_sampler tp=4",
        "sp_forward sp=1", "sp_forward sp=2", "sp_forward sp=4"]
    tp1, tp2, tp4 = rows[:3]
    kmax = 4 * WAN_14B.num_layers   # the replicated per-layer bound
    assert tp1["kv_cache"] - kmax == 2 * (tp2["kv_cache"] - kmax) == \
        4 * (tp4["kv_cache"] - kmax)
    assert tp1["params"] > tp2["params"] > tp4["params"]
    sp1, sp2, sp4 = rows[3:]
    # sequence parallelism replicates the parameters
    assert sp1["params"] == sp2["params"] == sp4["params"] == \
        fit.param_bytes(WAN_I2V_14B, causal=False)
    assert sp1["activations"] > sp4["activations"]
    assert tp1["params"] == fit.param_bytes(WAN_14B)


def test_the_limit_is_the_cards():
    """Without a limit the estimate reads the card's memory: off the card
    it raises rather than guess."""
    if torch.cuda.is_available():
        assert fit.tp_sampler_fit(tp=2)["limit"] == \
            torch.cuda.mem_get_info()[1]
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            fit.tp_sampler_fit(tp=2)
