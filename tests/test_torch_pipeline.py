"""The port's streaming sampler against the JAX pipeline on the CPU: a
2-block tiny rollout with the JAX package's noise draws injected as
``eps`` (float32, tolerance 1e-4); and a scan of the port's sources for
imports of JAX or of the JAX package, and for module-level imports of the
packages the card's machine lacks."""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from self_forcing_tpu.config import Config as JConfig
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.pipelines.causal_inference import (
    CausalInferencePipeline as JPipe)
from self_forcing_tpu_torch.config import Config as TConfig
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline as TPipe)

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, NB, C, H, W = 1, 3, 16, 8, 8
NBLOCKS = 2
ARGS = {"denoising_step_list": [1000, 750, 500, 250],
        "warp_denoising_step": True, "timestep_shift": 8.0,
        "num_frame_per_block": NB, "context_noise": 0}


def _setup(seed):
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(WAN_TINY, num_frame_per_block=NB)
    jp = jdit.init_params(jax.random.PRNGKey(seed), J_TINY,
                          dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    noise = rng.standard_normal((B, NB * NBLOCKS, C, H, W)).astype(
        np.float32)
    ctx = rng.standard_normal((B, 12, cfg.text_dim)).astype(np.float32)
    jpipe = JPipe(JConfig(ARGS), jp, J_TINY)
    tpipe = TPipe(TConfig(ARGS), params_from_jax(jp, "dit", device="cpu"),
                  cfg, device="cpu", dtype=torch.float32)
    return jpipe, tpipe, noise, ctx


def _draws(key, n_steps):
    """JAX's per-step re-noising draws of one block (denoise_block)."""
    out = []
    for _ in range(n_steps - 1):
        key, k = jax.random.split(key)
        out.append(torch.tensor(np.asarray(jax.random.normal(
            k, (B, NB, C, H, W), jnp.float32))))
    return out


def test_stream_matches_jax_with_injected_eps():
    jpipe, tpipe, noise, ctx = _setup(0)
    rng = jax.random.PRNGKey(7)
    jblocks = list(jpipe.stream(noise, ctx, rng=rng))
    # rebuild the stream's key sequence: per block split(rng) for the
    # denoise, then split(rng) for the refresh of every block but the last
    eps, key = [], rng
    for i in range(NBLOCKS):
        key, k1 = jax.random.split(key)
        eps.append(_draws(k1, 4))
        if i < NBLOCKS - 1:
            key, _ = jax.random.split(key)
    tblocks = list(tpipe.stream(torch.from_numpy(noise),
                                torch.from_numpy(ctx), eps=eps))
    assert len(tblocks) == len(jblocks) == NBLOCKS
    for t, j in zip(tblocks, jblocks):
        assert t.shape == (B, NB, C, H, W)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)
    # the cache the second block read: block 0 written at [0, NB*16)
    assert tpipe._cache.global_end == NB * (H // 2) * (W // 2)


def test_inference_matches_jax_with_injected_eps():
    jpipe, tpipe, noise, ctx = _setup(1)
    rng = jax.random.PRNGKey(5)
    _, jlat = jpipe.inference(noise, context=ctx, return_latents=True,
                              rng=rng)
    # inference(): split(rng) once, then split(k, num_blocks) per block
    _, k = jax.random.split(rng)
    eps = [_draws(kb, 4) for kb in jax.random.split(k, NBLOCKS)]
    video, tlat = tpipe.inference(torch.from_numpy(noise),
                                  torch.from_numpy(ctx), return_latents=True,
                                  eps=eps)
    assert video is None
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=TOL,
                               atol=TOL)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "self_forcing_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    rel = {os.path.relpath(f, REPO) for f in files}
    for part in ("training/trainer_distillation.py", "training/optim.py",
                 "training/ema.py", "training/objectives/base.py",
                 "training/objectives/dmd.py", "utils/loss.py",
                 "pipelines/self_forcing_training.py", "lora.py",
                 "train.py", "ops/masks.py", "ops/conv.py",
                 "ops/cuda_conv.py", "models/wan/vae.py",
                 "models/wan/t5.py", "tokenizer.py", "utils/checkpoints.py",
                 "runtime.py", "wrappers.py", "utils/video_io.py",
                 "data/datasets.py", "inference.py", "conditioning.py",
                 "training/objectives/sid.py", "scripts/__init__.py",
                 "scripts/generate_ode_pairs.py",
                 "scripts/create_sharded_dataset.py",
                 "scripts/create_shards_iterative.py",
                 "scripts/create_pose_shards.py", "scripts/merge_lora.py"):
        assert os.path.join("self_forcing_tpu_torch", part) in rel, part
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "self_forcing_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def _top_level_imports(path):
    """Imports a module runs when it is imported: those outside every
    function and class body."""
    with open(path) as f:
        body = ast.parse(f.read(), path).body
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            stack += [n for n in ast.iter_child_nodes(node)
                      if isinstance(n, ast.stmt)]
            for h in getattr(node, "handlers", []):
                stack += h.body


def test_port_imports_no_optional_package_at_module_level():
    """The card's machine has no transformers, PIL, cv2, imageio or
    safetensors: the port imports them where they are used."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "self_forcing_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(os.path.relpath(p, REPO), mod) for p in files
           for mod in _top_level_imports(p)
           if mod.split(".")[0] in ("transformers", "tokenizers", "PIL",
                                    "cv2", "imageio", "safetensors")]
    assert not bad, bad
