"""The port's tensor parallelism (``self_forcing_tpu_torch/parallel/
tensor.py``) against the JAX package's on the conftest's 8-device CPU
mesh: four gloo ranks (``tests/torch_parallel_workers.py``, spawned once
for the module) run tp 4 and, as two replicas, tp 2 on the JAX tests'
geometry (dim 128, 4 heads of 32, ffn 256, 2 layers; float32), the
weights handed across with ``params_from_jax``.  Tolerances are the JAX
package's own (tests/test_tensor_parallel.py): 2e-4 for forwards and
caches, 5e-4 for the sampler; the CLI's frames within 1 uint8 level."""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WanConfig as JConfig
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.parallel import tensor as jtp
from self_forcing_tpu.pipelines.causal_inference import (
    CausalInferencePipeline as JPipe)
from self_forcing_tpu_torch import inference as tinf
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.ops import quant as tquant
from self_forcing_tpu_torch.parallel import launch, tensor
from self_forcing_tpu_torch.params import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dim=128, ffn_dim=256, num_heads=4, num_layers=2, text_dim=64,
          freq_dim=32, num_frame_per_block=2)
JCFG, CFG = JConfig(**KW), WanConfig(**KW)
B, F, C, H, W = 1, 2, 16, 8, 8
FS = (H // 2) * (W // 2)
TOL, PIPE_TOL = 2e-4, 5e-4
PIPE_ARGS = {"denoising_step_list": [1000, 500], "num_frame_per_block": 2,
             "independent_first_frame": False, "context_noise": 0.0,
             "timestep_shift": 8.0}
PIPES = {"global": ({}, 4),
         # 5 blocks of 2 frames through an 8-frame buffer: the fifth
         # compacts it
         "windowed": ({"local_attn_size": 4, "sink_size": 1,
                       "windowed_buffer_frames": 8}, 10)}


def _np(t):
    return np.asarray(t)


def _params(seed):
    """JAX init with every leaf moved off its init value (zero heads and
    unit gains would hide a mis-sharded leaf)."""
    rng = np.random.default_rng(seed)
    jp = jdit.init_params(jax.random.PRNGKey(seed), JCFG, dtype=jnp.float32)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)


def _stream_eps(rng, blocks, shape):
    """The JAX stream's re-noising draws (one a block at two steps): per
    block split(rng) for the denoise, one split inside it, then split(rng)
    for the refresh of every block but the last."""
    eps, key = [], rng
    for i in range(blocks):
        key, k1 = jax.random.split(key)
        _, k = jax.random.split(k1)
        eps.append([torch.tensor(_np(jax.random.normal(k, shape,
                                                       jnp.float32)))])
        if i < blocks - 1:
            key, _ = jax.random.split(key)
    return eps


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs saved, the four ranks started, the JAX references computed
    while they run (each JAX function jitted: shard_map dispatched op by
    op took 13-27 s a call), then the ranks' outputs read."""
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("tp")
    jp = _params(0)
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((B, 16, CFG.text_dim)).astype(np.float32)
    xs = [rng.standard_normal((B, F, C, H, W)).astype(np.float32)
          for _ in range(2)]
    x_train = rng.standard_normal((B, 4, C, H, W)).astype(np.float32)
    t_train = np.full((B, 4), 600.0, np.float32)
    key = jax.random.PRNGKey(11)
    noises = {name: rng.standard_normal((B, frames, C, H, W)).astype(
        np.float32) for name, (_, frames) in PIPES.items()}
    pipes = {name: {"over": over, "noise": torch.from_numpy(noises[name]),
                    "eps": _stream_eps(key, frames // 2, (B, 2, C, H, W))}
             for name, (over, frames) in PIPES.items()}
    # inference(): 2 clean latent frames primed, then 2 blocks; JAX draws
    # split(rng) once, then split(k, blocks) and a split a step per block
    inf_noise = rng.standard_normal((B, 4, C, H, W)).astype(np.float32)
    init = 0.1 * rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
    _, k = jax.random.split(key)
    inf_eps = [[torch.tensor(_np(jax.random.normal(
        jax.random.split(kb)[1], (B, 2, C, H, W), jnp.float32)))]
        for kb in jax.random.split(k, 2)]
    torch.save({"cfg": KW, "params": params_from_jax(jp, "dit", "cpu"),
                "inference": {"noise": torch.from_numpy(inf_noise),
                              "init": torch.from_numpy(init),
                              "eps": inf_eps},
                "ctx": torch.from_numpy(ctx),
                "x": [torch.from_numpy(x) for x in xs],
                "x_train": torch.from_numpy(x_train),
                "t_train": torch.from_numpy(t_train),
                "pipe_args": PIPE_ARGS, "pipes": pipes}, d / "inp.pt")
    ranks = launch.start(workers.tp_worker, 4, "gloo", str(d / "inp.pt"),
                         str(d))

    jref = {}
    for name, (over, _) in PIPES.items():
        jpipe = JPipe(types.SimpleNamespace(**PIPE_ARGS), jp,
                      dataclasses.replace(JCFG, **over))
        jref[name] = [_np(b) for b in jpipe.stream(noises[name], ctx,
                                                   rng=key)]
    _, jlat = JPipe(types.SimpleNamespace(**PIPE_ARGS), jp, JCFG).inference(
        inf_noise, context=ctx, initial_latent=init, return_latents=True,
        rng=key)
    jref["inference"] = _np(jlat)
    # the JAX package's tensor-parallel functions at tp 2 and 4
    rope = JRope.create(JCFG.head_dim)
    for tp in (2, 4):
        mesh = jtp.tp_mesh(tp)
        ptp = jtp.shard_params_tp(jp, mesh)
        ctx_kv = jax.jit(lambda p, c: jtp.precompute_context_tp(
            p, JCFG, c, mesh))(ptp, ctx)
        cache = jtp.init_kv_cache_tp(JCFG, mesh, B, FS, 4, jnp.float32)
        fwd = jax.jit(lambda p, x, t, c, cache, s: jtp.forward_inference_tp(
            p, JCFG, x, t, c, cache, s, rope, mesh))
        flows, caches = [], []
        for blk, x in enumerate(xs):
            t = jnp.full((B, F), 500.0, jnp.float32)
            flow, cache = fwd(ptp, x, t, ctx_kv, cache, jnp.int32(blk * F))
            flows.append(_np(flow))
            caches.append({"k": _np(cache.k), "v": _np(cache.v),
                           "kmax": _np(cache.kmax)})
        jref[f"tp{tp}"] = {"ctx_kv": {k: _np(v) for k, v in ctx_kv.items()},
                           "flows": flows, "caches": caches}
        if tp == 4:
            jref["train"] = _np(jax.jit(lambda p, x, t, c: jtp.forward_train_tp(
                p, JCFG, x, t, c, None, rope, mesh, remat=False))(
                    ptp, x_train, t_train, ctx))
    ranks.join()
    return [torch.load(d / f"rank{r}.pt", weights_only=True)
            for r in range(4)], jref


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _heads(a, tp, r):
    """Rank r's heads of a folded [L, N, S, D] cache (B = 1)."""
    n = a.shape[1] // tp
    return a[:, r * n:(r + 1) * n]


@pytest.mark.parametrize("tp", [2, 4])
def test_forward_inference_tp_matches_jax(run, tp):
    ranks, jref = run
    j = jref[f"tp{tp}"]
    for rank in ranks:
        o = rank[f"tp{tp}"]
        r = o["local_rank"]
        for blk in range(2):
            _close(o["flows"][blk], j["flows"][blk])
            for kv in ("k", "v"):
                assert o["caches"][blk][kv].shape == \
                    _heads(j["caches"][blk][kv], tp, r).shape
                _close(o["caches"][blk][kv],
                       _heads(j["caches"][blk][kv], tp, r))
            np.testing.assert_array_equal(o["caches"][blk]["kmax"],
                                          j["caches"][blk]["kmax"])
        assert o["caches"][1]["global_end"] == 2 * F * FS


def test_precompute_context_tp_matches_jax(run):
    ranks, jref = run
    for rank in ranks:
        o = rank["tp4"]
        for key, a in jref["tp4"]["ctx_kv"].items():
            n = a.shape[3] // 4
            r = o["local_rank"]
            _close(o["ctx_kv"][key], a[:, :, :, r * n:(r + 1) * n])


def test_forward_train_tp_matches_jax(run):
    ranks, jref = run
    for rank in ranks:
        _close(rank["train"], jref["train"])


def test_bounded_kmax_is_the_single_card_bound(run):
    """Under the bounded softmax each rank bounds its own heads' keys; the
    all-reduced (max) bound equals the single-card forward's."""
    ranks, _ = run
    for rank in ranks:
        b = rank["bounded"]
        assert float(b["kmax_1"].min()) > 0
        _close(b["kmax_tp"], b["kmax_1"], 1e-5)
        # the kernel route's plain versions round p to bf16, as the
        # kernels do: a last-place difference in q or k can flip one
        _close(b["flow_tp"], b["flow_1"], 1e-3)


@pytest.mark.parametrize("name", ["global", "windowed"])
def test_tp_stream_matches_jax(run, name):
    """The TP pipeline's stream against the JAX package's single-device
    stream (its slow tests hold its TP stream to the same), with JAX's
    re-noising draws injected."""
    ranks, jref = run
    for rank in ranks:
        assert len(rank[name]) == len(jref[name])
        for a, b in zip(rank[name], jref[name]):
            _close(a, b, PIPE_TOL)
    if name == "windowed":
        assert all(r["windowed_compactions"] == 1 for r in ranks)


def test_tp_inference_matches_jax(run):
    """``inference`` with two primed latent frames (``prime_block_tp``)
    and the whole-video loop (``generate_blocks_tp``) against the JAX
    package's single-device ``inference``, its draws injected."""
    ranks, jref = run
    for rank in ranks:
        assert tuple(rank["inference"].shape) == jref["inference"].shape
        _close(rank["inference"], jref["inference"], PIPE_TOL)


def test_tp_rejects_quantized_params():
    p = params_from_jax(_params(9), "dit", "cpu")
    qp = tquant.quantize_dit_params(p, min_dim=64, mode="w8a8")
    with pytest.raises(ValueError, match="quantized"):
        tensor.tp_param_specs(qp)
    with pytest.raises(ValueError, match="quantized"):
        tensor.shard_params(qp, 0, 2)


def test_tp_local_config_and_shards():
    cfg = tensor.tp_local_config(CFG, 4)
    assert (cfg.num_heads, cfg.ffn_dim, cfg.head_dim) == (1, 64, 32)
    with pytest.raises(ValueError, match="does not divide"):
        tensor.tp_local_config(CFG, 3)
    p = params_from_jax(_params(3), "dit", "cpu")
    s = tensor.shard_params(p, 1, 2)
    blk = s["blocks"]
    assert blk["self_attn"]["q"]["w"].shape == (2, 128, 64)
    assert blk["self_attn"]["o"]["w"].shape == (2, 64, 128)
    assert blk["self_attn"]["o"]["b"].shape == (2, 128)
    assert blk["ffn"]["fc1"]["b"].shape == (2, 128)
    torch.testing.assert_close(blk["self_attn"]["norm_q"]["w"],
                               p["blocks"]["self_attn"]["norm_q"]["w"][:, 64:])


def _cli_argv(tmp_path, out, tp):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a fox in the snow\n")
    argv = ["--config_path", os.path.join(REPO, "configs", "tiny_test.yaml"),
            "--data_path", str(prompts), "--output_folder", str(out),
            "--num_output_frames", "3", "--save_with_index", "--device",
            "cpu"]
    return argv + (["--tp", str(tp), "--dist_backend", "gloo"] if tp else [])


def test_cli_tp2_matches_tp0(tmp_path, monkeypatch):
    """``--tp 2`` over two gloo ranks against ``--tp 0`` in one process:
    rank 0 alone writes, its frames within 1 uint8 level."""
    from self_forcing_tpu_torch.utils import video_io
    d1, d2 = tmp_path / "tp0", tmp_path / "tp2"
    d1.mkdir()
    d2.mkdir()
    monkeypatch.setattr(video_io, "save_video", lambda frames, path, fps=16:
                        np.save(d1 / ("rank0_" + os.path.basename(path)
                                      + ".npy"), frames))
    tinf.main(_cli_argv(tmp_path, d1 / "o", 0))
    launch.spawn(workers.cli_worker, 2, "gloo",
                 _cli_argv(tmp_path, d2 / "o", 2), str(d2))
    name = "output_000.mp4.npy"
    assert sorted(os.listdir(d2)) == ["o", f"rank0_{name}"]
    a = np.load(d1 / f"rank0_{name}").astype(int)
    b = np.load(d2 / f"rank0_{name}").astype(int)
    assert a.shape == b.shape == (9, 64, 64, 3)
    assert np.abs(a - b).max() <= 1


def test_cli_tp_needs_its_ranks(tmp_path):
    argv = _cli_argv(tmp_path, tmp_path / "o", 2)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        tinf.main(argv)
    assert not torch.distributed.is_initialized()
