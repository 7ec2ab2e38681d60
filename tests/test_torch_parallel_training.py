"""The port's parallel training (``self_forcing_tpu_torch/parallel/fsdp.py``
and the trainers' ``mesh=``) against the JAX package's sharded trainers
on the conftest's 8-device CPU mesh.  Two gloo ranks
(``tests/torch_parallel_workers.training_worker``, spawned once for the
module) run:

- on an fsdp-2 mesh: a DMD and a SiD step of the distillation trainer
  (batch 1, whole on both ranks; and DMD with batch 2 split), two ODE,
  two diffusion and two GAN steps with batch 2 split, against the JAX
  trainers on ``create_mesh(fsdp=2)`` with the JAX draws injected;
- the training rollout with and without the cache constraint;
- ``forward_train_tp``'s gradients at tp 2 against ``jax.grad`` of the
  one-device forward;
- on an sp-2 mesh: ``forward_train_sp(param_specs=...)`` (the ZeRO-3-over-
  sp teacher) against the JAX forward, and a DMD step with a wider
  teacher (dim 256, 4 heads) sliced over ("fsdp", "sp") against the JAX
  trainer with the whole teacher;
- ``shard_params`` then a gather, ``train.shard_batch``,
  ``train.setup_mesh`` and ``train.main`` for two steps.

Tolerances: losses 1e-4 relative, the other logs 1e-3 relative (as
``tests/test_torch_trainers.py``'s); parameters and EMA after the
updates 1e-4 absolute; Adam moments 1e-4 relative to each leaf's largest
entry; the forwards 5e-4 and the tp gradients 5e-4 (the JAX package's
own tensor- and sequence-parallel tolerances); the
cache constraint, the gather and the CLI's checkpoint (batch 1, whole on
both ranks) against one process exactly or within 1e-6.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_workers as workers
from self_forcing_tpu.config import load_config as jload_config
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.configs import WanConfig as JConfig
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.parallel.mesh import create_mesh as jcreate_mesh
from self_forcing_tpu.parallel.mesh import shard_params as jshard_params
from self_forcing_tpu.training.objectives.base import (
    sample_timestep_per_block as jspb)
from self_forcing_tpu.training.trainer_diffusion import (
    DiffusionTrainer as JDiffusionTrainer)
from self_forcing_tpu.training.trainer_gan import GANTrainer as JGANTrainer
from self_forcing_tpu.training.trainer_distillation import (
    ScoreDistillationTrainer as JSDTrainer)
from self_forcing_tpu.training.trainer_ode import ODETrainer as JODETrainer
from self_forcing_tpu_torch import train
from self_forcing_tpu_torch.config import load_config
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.parallel import launch
from self_forcing_tpu_torch.training.objectives import dmd as tdmd
from self_forcing_tpu_torch.training.trainer_distillation import (
    ScoreDistillationTrainer)
from self_forcing_tpu_torch.utils import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TOL, FWD_TOL = 1e-4, 5e-4
C, H, W = 16, 8, 8
WIDE = dict(dim=256, ffn_dim=512, num_heads=4, num_layers=2, text_dim=64,
            freq_dim=32)
TP_KW = dict(dim=128, ffn_dim=256, num_heads=4, num_layers=2, text_dim=64,
             freq_dim=32)
SP_KW = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, text_dim=64,
             freq_dim=32)


def _np(x):
    return torch.from_numpy(np.array(x))


def _perturbed(tree_j, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(a.shape).astype(np.float32), tree_j)


def _t(tree_np):
    return params_from_jax(jax.tree.map(np.asarray, tree_np), "dit",
                           device="cpu")


def _configs(name, **kw):
    """(port config as a dict, JAX config) of a config file with
    overrides (seed 3, lr 1e-3 unless given)."""
    c = load_config(os.path.join(CONFIGS, name),
                    os.path.join(CONFIGS, "default_config.yaml"))
    j = jload_config(os.path.join(CONFIGS, name),
                     os.path.join(CONFIGS, "default_config.yaml"))
    kw = dict({"seed": 3, "lr": 1e-3}, **kw)
    for x in (c, j):
        x.update(**kw)
    return c.to_dict(), j


def _jax_rollout_eps(rng_roll, exits, shape_blk):
    """The JAX rollout's draws: block b's key is split(rng2, blocks)[b],
    split once per step before the exit; the refresh folds in 7."""
    _, rng2 = jax.random.split(rng_roll)
    keys = jax.random.split(rng2, len(exits))
    eps = []
    for b, e in enumerate(exits):
        r, draws = keys[b], []
        for _ in range(int(e)):
            r, k = jax.random.split(r)
            draws.append(_np(jax.random.normal(k, shape_blk, jnp.float32)))
        eps.append((draws, _np(jax.random.normal(
            jax.random.fold_in(keys[b], 7), shape_blk, jnp.float32))))
    return eps


def _jax_dmd_draws(jtr, B, steps):
    """The draws of ``steps`` JAX distillation train_steps, rebuilt from a
    copy of its host RNG: the rollout length, exit and key of each
    update, and from the key the update's noise, the rollout's eps and
    the DMD / critic timestep and noise (the JAX objectives' splits)."""
    rng = copy.deepcopy(jtr.host_rng)
    obj, pipe = jtr.obj, jtr.bundle.pipeline
    nb = obj.num_frame_per_block
    shape = list(jtr.config.image_or_video_shape)
    out = []

    def rollout_shape(base):
        n = int(rng.integers(min(21, obj.num_training_frames) // nb,
                             obj.num_training_frames // nb + 1))
        return [B, n * nb] + list(base[2:])

    def t_draw(key, exit_idx):
        bounds = pipe.denoised_timestep_bounds(exit_idx)
        lo, hi = tdmd._timestep_range(obj, *bounds)
        return _np(jax.random.randint(key, (B, 1), lo, hi))

    for step in range(steps):
        d = {}
        shape = rollout_shape(shape)
        exit_idx = pipe.sample_exit_index(rng, num_blocks=shape[1] // nb)
        blk = (B, nb) + tuple(shape[2:])
        if step % jtr.dfake_gen_update_ratio == 0:
            key = jax.random.PRNGKey(int(rng.integers(2 ** 31)))
            key, k = jax.random.split(key)
            rng_roll, rng_dmd = jax.random.split(key)
            rng_t, rng_n = jax.random.split(rng_dmd)
            d["generator"] = {
                "noise_in": _np(jax.random.normal(k, shape, jnp.float32)),
                "eps": _jax_rollout_eps(rng_roll,
                                        [exit_idx] * (shape[1] // nb), blk),
                "t": t_draw(rng_t, exit_idx),
                "noise": _np(jax.random.normal(rng_n, shape, jnp.float32))}
        shape = rollout_shape(shape)
        exit_idx = pipe.sample_exit_index(rng, num_blocks=shape[1] // nb)
        key = jax.random.PRNGKey(int(rng.integers(2 ** 31)))
        key, k = jax.random.split(key)
        rng_roll, rng_t, rng_n = jax.random.split(key, 3)
        d["critic"] = {
            "noise_in": _np(jax.random.normal(k, shape, jnp.float32)),
            "eps": _jax_rollout_eps(rng_roll, [exit_idx] * (shape[1] // nb),
                                    blk),
            "t": t_draw(rng_t, exit_idx),
            "noise": _np(jax.random.normal(rng_n, shape, jnp.float32))}
        out.append(d)
    return out


def _jax_gan_draws(jtr, shape, steps):
    """The draws of ``steps`` JAX GAN train_steps on latents of ``shape``,
    rebuilt from a copy of its host RNG: each update's exit and key, the
    update's noise (the key folded with 1 / 2), the rollout's eps and the
    discriminator's timestep and noises (``gan.generator_loss`` splits
    the key in 3, ``critic_loss`` in 4)."""
    rng = copy.deepcopy(jtr.host_rng)
    obj, pipe = jtr.obj, jtr.bundle.pipeline
    B, F = shape[:2]
    nb = obj.num_frame_per_block
    blk = (B, nb) + tuple(shape[2:])

    def normal(k):
        return _np(jax.random.normal(k, shape, jnp.float32))

    def t_draw(key, exit_idx):
        _, t_to = pipe.denoised_timestep_bounds(exit_idx)
        lo = t_to if obj.ts_schedule else obj.min_score_timestep
        return _np(jax.random.randint(key, (B, 1), int(lo),
                                      obj.num_train_timestep))

    out = []
    for step in range(steps):
        d = {}
        if step >= jtr.discriminator_warmup_steps and \
                step % jtr.dfake_gen_update_ratio == 0:
            exit_idx = pipe.sample_exit_index(rng)
            key = jax.random.PRNGKey(int(rng.integers(2 ** 31)))
            rng_roll, rng_t, rng_n = jax.random.split(key, 3)
            d["generator"] = {
                "noise_in": normal(jax.random.fold_in(key, 1)),
                "eps": _jax_rollout_eps(rng_roll, [exit_idx] * (F // nb),
                                        blk),
                "t": t_draw(rng_t, exit_idx), "noise": normal(rng_n),
                "real_noise": normal(jax.random.fold_in(rng_n, 1))}
        exit_idx = pipe.sample_exit_index(rng)
        key = jax.random.PRNGKey(int(rng.integers(2 ** 31)))
        rng_roll, rng_t, rng_n, rng_r = jax.random.split(key, 4)
        d["critic"] = {
            "noise_in": normal(jax.random.fold_in(key, 2)),
            "eps": _jax_rollout_eps(rng_roll, [exit_idx] * (F // nb), blk),
            "t": t_draw(rng_t, exit_idx), "noise": normal(rng_n),
            "r1_noise": normal(rng_r),
            "r2_noise": normal(jax.random.fold_in(rng_r, 1))}
        out.append(d)
    return out


def _single_draws(kind, B, F, steps, seed=3):
    """The JAX ODE / diffusion trainers' draws (one key a step from the
    host RNG seeded with the config's seed)."""
    seeds, out = np.random.default_rng(seed), []
    for _ in range(steps):
        key = jax.random.PRNGKey(int(seeds.integers(2 ** 31)))
        if kind == "ode":
            out.append({"idx": _np(jspb(key, 0, 5, B, F, 3))})
        else:
            rng_t, rng_n, _ = jax.random.split(key, 3)
            out.append({"idx": _np(jspb(rng_t, 0, 1000, B, F, 1)),
                        "noise": _np(jax.random.normal(rng_n,
                                                       (B, F, C, H, W)))})
    return out


def _adam(state):
    """The (mu, nu) trees of an optax chain(clip, adamw) state."""
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no Adam state")


def _jax_state(jtr):
    """A JAX trainer's weights, Adam moments and EMA in the port's layout
    and leaf order."""
    if hasattr(jtr, "cls_params"):
        out = {"gen": _t(jtr.generator), "fake": _t(jtr.fake_score),
               "cls": _t(jtr.cls_params)}
        for name, st in (("gen_opt", jtr.gen_opt_state),
                         ("critic_opt", jtr.critic_opt_state),
                         ("cls_opt", jtr.cls_opt_state)):
            mu, nu = _adam(st)
            out[name] = {"mu": tree.leaves(_t(mu)),
                         "nu": tree.leaves(_t(nu))}
        if jtr.generator_ema is not None:
            out["ema"] = _t(jtr.generator_ema)
        return out
    if hasattr(jtr, "state"):
        s = jtr.state
        out = {"gen": _t(s.generator), "fake": _t(s.fake_score)}
        for name, st in (("gen_opt", s.gen_opt_state),
                         ("critic_opt", s.critic_opt_state)):
            mu, nu = _adam(st)
            out[name] = {"mu": tree.leaves(_t(mu)),
                         "nu": tree.leaves(_t(nu))}
        if s.generator_ema is not None:
            out["ema"] = _t(s.generator_ema)
        return out
    mu, nu = _adam(jtr.opt_state)
    out = {"gen": _t(jtr.params), "opt": {"mu": tree.leaves(_t(mu)),
                                          "nu": tree.leaves(_t(nu))}}
    if jtr.ema is not None:
        out["ema"] = _t(jtr.ema)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs saved, the two ranks started, the JAX trainers (and the
    port's one-process CLI run) computed while they run, then the ranks'
    outputs read."""
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("ptrain")
    key = jax.random.PRNGKey(0)
    jm = {"gen": _perturbed(jdit.init_params(key, J_TINY,
                                             dtype=jnp.float32), 1),
          "fake": _perturbed(jdit.init_params(jax.random.fold_in(key, 1),
                                              J_TINY, dtype=jnp.float32,
                                              causal=False), 2),
          "real": _perturbed(jdit.init_params(jax.random.fold_in(key, 2),
                                              J_TINY, dtype=jnp.float32,
                                              causal=False), 3),
          "real_wide": _perturbed(jdit.init_params(
              jax.random.fold_in(key, 3), JConfig(**WIDE),
              dtype=jnp.float32, causal=False), 4),
          "cls": _perturbed(jdit.init_cls_branch_params(
              jax.random.fold_in(key, 5), J_TINY), 5)}
    rng = np.random.default_rng(4)
    ctx, neg = (rng.standard_normal((1, 8, 64)).astype(np.float32)
                for _ in range(2))
    ctx2 = np.concatenate([ctx, rng.standard_normal(ctx.shape).astype(
        np.float32)])
    models = {k: _t(v) for k, v in jm.items()}
    models["neg"] = torch.from_numpy(neg)

    # lr 2e-5 (the real configs' scale): with beta1 0 Adam moves an
    # element by ~lr whatever its gradient's size, so a near-zero
    # gradient's rounding moves it by up to 2 lr; the Adam moments hold
    # the gradients themselves
    dist = dict(image_or_video_shape=[1, 2, C, H, W], num_training_frames=2,
                dfake_gen_update_ratio=1, ema_weight=0.9, ema_start_step=0,
                lr=2e-5)
    cases, jtrainers = {}, {}
    jmesh = jcreate_mesh(fsdp=2, devices=jax.devices()[:2])

    def jshard(p):
        return jshard_params(p, jmesh, min_size=1024)

    for name, over, B in (("dmd", {}, 1),
                          ("sid", {"distribution_loss": "sid"}, 1),
                          ("dmd_b2", {"image_or_video_shape":
                                      [2, 2, C, H, W]}, 2)):
        c, j = _configs("tiny_test.yaml", **dict(dist, **over))
        jtr = JSDTrainer(j, jshard(jm["gen"]), jshard(jm["fake"]),
                         jshard(jm["real"]), J_TINY, J_TINY, J_TINY,
                         np.broadcast_to(neg, (B,) + neg.shape[1:]),
                         mesh=jmesh)
        draws = _jax_dmd_draws(jtr, B, 1)
        context = ctx if B == 1 else ctx2
        cases[name] = {"kind": "sid" if name == "sid" else "dmd",
                       "config": c, "batch": {"context":
                                              torch.from_numpy(context)},
                       "draws": draws, "steps": 1}
        jtrainers[name] = (jtr, {"context": context})
    cases["dmd"]["save_state"] = str(d / "state.pt")
    data = rng.standard_normal((2, 5, 3, C, H, W)).astype(np.float32)
    lat = rng.standard_normal((2, 3, C, H, W)).astype(np.float32)
    for name, file, over, batch_j in (
            ("ode", "ode_init.yaml", {"num_frame_per_block": 3},
             {"ode_latent": data, "context": ctx2}),
            ("diffusion", "causal_diffusion.yaml",
             {"num_frame_per_block": 1},
             {"latents": lat, "context": ctx2})):
        c, j = _configs(file, **over)
        jtr = (JODETrainer(j, jm["gen"], J_TINY, visualize=False,
                           mesh=jmesh) if name == "ode"
               else JDiffusionTrainer(j, jm["gen"], J_TINY, mesh=jmesh))
        cases[name] = {"kind": name, "config": c, "steps": 2,
                       "batch": {k: torch.from_numpy(v)
                                 for k, v in batch_j.items()},
                       "draws": _single_draws(name, 2, 3, 2)}
        jtrainers[name] = (jtr, batch_j)
    # the GAN steps at lr and lr_critic 2e-5, as the distillation cases
    c, j = _configs("self_forcing_gan.yaml", num_frame_per_block=1,
                    image_or_video_shape=[2, 2, C, H, W],
                    num_training_frames=2, lr=2e-5, lr_critic=2e-5,
                    ema_weight=0.9, ema_start_step=0)
    jtr = JGANTrainer(j, jshard(jm["gen"]), jshard(jm["fake"]), J_TINY,
                      J_TINY, cls_params=jshard(jm["cls"]), mesh=jmesh)
    cases["gan"] = {"kind": "gan", "config": c, "steps": 2,
                    "batch": {"context": torch.from_numpy(ctx2),
                              "latents": torch.from_numpy(lat[:, :2])},
                    "draws": _jax_gan_draws(jtr, [2, 2, C, H, W], 2)}
    jtrainers["gan"] = (jtr, {"context": ctx2, "latents": lat[:, :2]})
    # the sp-2 mesh: a DMD step whose wider teacher is sliced over
    # ("fsdp", "sp") and runs the ring forward
    c, j = _configs("tiny_test.yaml", teacher_zero3_sp=True, **dist)
    jtr = JSDTrainer(j, jm["gen"], jm["fake"], jm["real_wide"], J_TINY,
                     J_TINY, JConfig(**WIDE), neg)
    sp_cases = {"dmd_wide": {"kind": "dmd", "config": c, "steps": 1,
                             "real": "real_wide", "teacher_cfg": WIDE,
                             "batch": {"context": torch.from_numpy(ctx)},
                             "draws": _jax_dmd_draws(jtr, 1, 1)}}
    jtrainers["dmd_wide"] = (jtr, {"context": ctx})

    # the rollout (3 frames, exit 2) with its draws and weights
    g = torch.Generator().manual_seed(6)
    noise = torch.randn(1, 3, C, H, W, generator=g)
    rollout = {"ctx": torch.from_numpy(ctx), "noise": noise,
               "w": torch.randn(noise.shape, generator=g),
               "eps": [([torch.randn(1, 1, C, H, W, generator=g)
                         for _ in range(2)],
                        torch.randn(1, 1, C, H, W, generator=g))
                       for _ in range(3)]}
    # tp: the JAX tensor-parallel tests' geometry
    jtp = _perturbed(jdit.init_params(jax.random.PRNGKey(7),
                                      JConfig(**TP_KW),
                                      dtype=jnp.float32), 8)
    x_tp = rng.standard_normal((1, 2, C, H, W)).astype(np.float32)
    ctx_tp = rng.standard_normal((1, 16, 64)).astype(np.float32)
    tp = {"cfg": TP_KW, "params": _t(jtp), "x": torch.from_numpy(x_tp),
          "t": torch.full((1, 2), 300.0), "ctx": torch.from_numpy(ctx_tp)}
    jsp = _perturbed(jdit.init_params(jax.random.PRNGKey(9),
                                      JConfig(**SP_KW),
                                      dtype=jnp.float32, causal=False), 10)
    x_sp = rng.standard_normal((1, 4, C, H, W)).astype(np.float32)
    sp = {"cfg": SP_KW, "params": _t(jsp), "x": torch.from_numpy(x_sp),
          "t": torch.full((1, 4), 700.0), "ctx": torch.from_numpy(ctx_tp)}

    cli_cfg = d / "cli.yaml"
    with open(os.path.join(CONFIGS, "tiny_test.yaml")) as f:
        cc = yaml.safe_load(f)
    cc.update(image_or_video_shape=[1, 2, C, H, W], num_training_frames=2,
              dfake_gen_update_ratio=1,
              data_path=os.path.join(REPO, "prompts", "test_prompts.txt"))
    cli_cfg.write_text(yaml.safe_dump(cc))

    def cli_argv(logdir):
        return ["--config_path", str(cli_cfg), "--max_steps", "2",
                "--device", "cpu", "--dist_backend", "gloo", "--logdir",
                str(logdir), "--no_visualize"]

    inp = {"models": models, "cases": cases, "sp_cases": sp_cases,
           "rollout": rollout, "tp": tp, "sp": sp,
           "cli_argv": cli_argv(d / "cli2")}
    torch.save(inp, d / "inp.pt")
    ranks = launch.start(workers.training_worker, 2, "gloo",
                         str(d / "inp.pt"), str(d))

    jout = {}
    for name, (jtr, batch) in jtrainers.items():
        jout[name] = {"logs": [jtr.train_step(batch)],
                      "state": _jax_state(jtr)}
    for name in ("ode", "diffusion", "gan"):
        jtr, batch = jtrainers[name]
        jout[name]["logs"].append(jtr.train_step(batch))
        jout[name]["state"] = _jax_state(jtr)
    train.main(["--config_path", str(cli_cfg), "--max_steps", "2",
                "--device", "cpu", "--logdir", str(d / "cli1"),
                "--no_visualize"])

    def tp_loss(p):
        return jnp.sum(jdit.forward_train(
            p, JConfig(**TP_KW), x_tp, np.full((1, 2), 300.0, np.float32),
            ctx_tp, None, JRope.create(32), remat=False) ** 2)
    jtp_grads = _t(jax.grad(tp_loss)(jax.tree.map(jnp.asarray, jtp)))
    jsp_flow = np.asarray(jdit.forward_train(
        jsp, JConfig(**SP_KW), x_sp, np.full((1, 4), 700.0, np.float32),
        ctx_tp, None, JRope.create(64), remat=False))
    ranks.join()
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]
    return {"outs": outs, "jax": jout, "dir": d,
            "inp": inp, "jtp_grads": jtp_grads, "jsp_flow": jsp_flow}


def _logs_close(got, want):
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=TOL if k.endswith("loss") else 1e-3,
            atol=1e-6, err_msg=k)


def _trees_close(a, b, tol=TOL):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=0, atol=tol)


def _moments_close(a, b, tol=TOL):
    for x, y in zip(a, b):
        if x is None:
            continue
        scale = max(float(y.abs().max()), 1e-12)
        np.testing.assert_allclose(x.numpy() / scale, y.numpy() / scale,
                                   rtol=0, atol=tol)


# ------------------------------------------------------------ layouts

def test_shard_params_then_gather_is_exact(run):
    for out in run["outs"]:
        assert out["layout"]["exact"]


def test_replicate_gives_every_rank_rank_0s_tree(run):
    for out in run["outs"]:
        assert torch.equal(out["layout"]["replicated"], torch.zeros(3))


def test_shard_batch_splits_like_jax(run):
    """The DistributedSampler's split: 8 rows over dp x fsdp = 2 (rank r
    rows 4r..4r+3, JAX's P(('dp', 'fsdp'))), a leading 3 stays whole,
    non-arrays untouched."""
    for r, out in enumerate(run["outs"]):
        lay = out["layout"]
        assert torch.equal(lay["context"][:, 0],
                           torch.arange(4.0 * r, 4.0 * r + 4))
        assert lay["odd"].shape == (3, 2) and lay["prompts"] == ["a"]


def test_setup_mesh_shards_params_and_respects_no_shard(run):
    lay = run["outs"][0]["layout"]
    assert lay["mesh_shape"]["dp"] * lay["mesh_shape"]["fsdp"] == 2
    assert lay["sharded_fraction"] > 0.5
    assert lay["no_shard"]
    config = load_config(os.path.join(CONFIGS, "tiny_test.yaml"))
    mesh, *_ = train.setup_mesh(config, {}, {}, {}, "cpu")
    assert mesh is None   # one process: no mesh, as JAX on one device


# ----------------------------------------------------------- trainers

@pytest.mark.parametrize("name", ["dmd", "sid", "dmd_b2", "ode",
                                  "diffusion", "gan"])
def test_sharded_trainer_matches_jax(run, name):
    """Both ranks' logs, and the whole updated weights, Adam moments and
    EMA gathered from the slices, against the JAX trainer's on its
    fsdp-2 mesh."""
    want = run["jax"][name]
    for out in run["outs"]:
        got = out["trainers"][name]
        for lt, lj in zip(got["logs"], want["logs"]):
            assert set(lt) == set(lj)
            _logs_close(lt, lj)
        st, sj = got["state"], want["state"]
        assert set(st) == set(sj)
        for k in st:
            if k.endswith("opt"):
                _moments_close(st[k]["mu"], sj[k]["mu"])
                _moments_close(st[k]["nu"], sj[k]["nu"])
            else:
                _trees_close(st[k], sj[k])


def test_dmd_step_with_wider_zero3_sp_teacher_matches_jax(run):
    """sp 2, ``teacher_zero3_sp``: the teacher (dim 256, 4 heads) sliced
    over ("fsdp", "sp") and gathered a layer at a time inside the ring
    forward, against the JAX trainer with the whole teacher on one
    device."""
    want = run["jax"]["dmd_wide"]
    for out in run["outs"]:
        got = out["sp_trainers"]["dmd_wide"]
        _logs_close(got["logs"][0], want["logs"][0])
        _trees_close(got["state"]["gen"], want["state"]["gen"])
        _trees_close(got["state"]["fake"], want["state"]["fake"])
        _moments_close(got["state"]["gen_opt"]["mu"],
                       want["state"]["gen_opt"]["mu"])


def test_forward_train_sp_zero3_matches_jax(run):
    for out in run["outs"]:
        np.testing.assert_allclose(out["sp"]["flow"].numpy(),
                                   run["jsp_flow"], rtol=FWD_TOL,
                                   atol=FWD_TOL)
        # the big leaves are halved; small ones (< 1024) stay whole
        assert out["sp"]["bytes"] < 0.6 * out["sp"]["whole_bytes"]


def test_forward_train_tp_grads_match_jax(run):
    """Each rank's gradient of every leaf of its tp shard: the JAX
    one-device gradient's slice (split leaves) or the whole of it."""
    want = run["jtp_grads"]
    for out in run["outs"]:
        t = out["tp"]
        r = t["rank"]
        for (path, g), (_, sp), (_, gj) in zip(
                tree.items(_tree_like(want, t["grads"])),
                tree.items(t["specs"]), tree.items(want)):
            gj = gj if sp is None else gj.chunk(2, sp)[r]
            g = torch.zeros_like(gj) if g is None else g
            scale = max(float(gj.abs().max()), 1e-6)
            np.testing.assert_allclose(g.numpy() / scale,
                                       gj.numpy() / scale, rtol=0,
                                       atol=FWD_TOL, err_msg=str(path))


def _tree_like(like, leaves):
    it = iter(leaves)
    return tree.map_tree(lambda _: next(it), like)


def test_rollout_cache_constraint_changes_no_value(run):
    """The rollout's trajectory, loss and every gradient slice are equal
    with the cache held sharded (S over fsdp 2) and without; each rank
    holds half the cache's bytes."""
    for out in run["outs"]:
        a, b = out["rollout"][False], out["rollout"][True]
        assert torch.equal(a["traj"], b["traj"])
        assert torch.equal(a["loss"], b["loss"])
        for x, y in zip(a["grads"], b["grads"]):
            assert torch.equal(x, y)
        S = -(-3 * 16 // 2048) * 2048 if 3 * 16 > 2048 else 3 * 16
        whole = WAN_TINY.num_layers * b["bn_whole"] * S \
            * WAN_TINY.head_dim * 4
        assert b["cache_bytes"] * 2 == whole


def test_sharded_save_state_restores_in_one_process(run, tmp_path):
    """The fsdp-2 DMD trainer's ``save_state`` (gathered, written by rank
    0) loaded into a one-process trainer equals the ranks' gathered
    state."""
    case = run["inp"]["cases"]["dmd"]
    m = run["inp"]["models"]
    p = {k: tree.map_tree(lambda t: t.clone(), m[k])
         for k in ("gen", "fake", "real")}
    from self_forcing_tpu_torch.config import Config
    tr = ScoreDistillationTrainer(Config(case["config"]), p["gen"],
                                  p["fake"], p["real"], WAN_TINY, WAN_TINY,
                                  WAN_TINY, m["neg"].clone(), device="cpu")
    tr.load_state(case["save_state"])
    got = run["outs"][0]["trainers"]["dmd"]["state"]
    for x, y in zip(tr.gen_leaves, tree.leaves(got["gen"])):
        assert torch.equal(x.detach(), y)
    for x, y in zip(tree.leaves(tr.state.generator_ema),
                    tree.leaves(got["ema"])):
        assert torch.equal(x, y)
    for x, y in zip(tr.state.gen_opt_state["mu"], got["gen_opt"]["mu"]):
        assert x is None or torch.equal(x, y)
    assert tr.state.step == 1


def test_train_cli_on_two_ranks(run):
    """``train.main`` for 2 steps on 2 ranks: one metrics.jsonl of 2
    lines (rank 0's), and a final checkpoint equal to the one-process
    run's."""
    d = run["dir"]
    lines = [json.loads(ln) for ln in
             (d / "cli2" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    one = [json.loads(ln) for ln in
           (d / "cli1" / "metrics.jsonl").read_text().splitlines()]
    for a, b in zip(lines, one):
        for k in ("generator_loss", "critic_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    two = torch.load(d / "cli2" / "final.pt", weights_only=True)
    ref = torch.load(d / "cli1" / "final.pt", weights_only=True)
    assert set(two) == set(ref)
    for k in ref:
        _trees_close(two[k], ref[k], 1e-6)
