"""The port's training path against the JAX package on the CPU (float32,
WAN_TINY, every parameter leaf perturbed so that the zero-initialised
output layer and LoRA B take part):

- the scheduler's training functions, the YAML configs, LoRA;
- ``forward_train`` output and parameter gradients with LoRA adapters,
  masked, bidirectional and teacher-forcing;
- ``inference_with_trajectory`` with the JAX package's rollout draws
  injected: the trajectory and the gradient of a scalar loss, for a
  shared exit and for per-block exits;
- ``compute_kl_grad``, ``generator_loss`` (the DMD loss) and
  ``critic_loss`` with injected draws: values and gradients;
- one optimizer update against optax, weight decay on a leaf without a
  gradient included;
- two ``train_step``s and the ``self_forcing_tpu_torch.train`` CLI.

Tolerances: 1e-4 on values (float32, sums in another order); gradients
1e-4 relative to each leaf's largest entry.
"""
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from self_forcing_tpu import lora as jlora
from self_forcing_tpu.config import load_config as jload_config
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.ops import masks as jmasks
from self_forcing_tpu.scheduler import FlowMatchScheduler as JSched
from self_forcing_tpu.scheduler import shift_timestep as jshift
from self_forcing_tpu.training.objectives import dmd as jdmd
from self_forcing_tpu.training.objectives.base import (
    ModelBundle as JBundle, ObjectiveConfig as JObj)
from self_forcing_tpu.training.optim import make_optimizer
from self_forcing_tpu_torch import lora as tlora
from self_forcing_tpu_torch.config import load_config as tload_config
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.ops import masks as tmasks
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler as TSched
from self_forcing_tpu_torch.scheduler import shift_timestep as tshift
from self_forcing_tpu_torch.training.objectives import dmd as tdmd
from self_forcing_tpu_torch.training.objectives.base import (
    ModelBundle as TBundle, ObjectiveConfig as TObj,
    sample_timestep_per_block)
from self_forcing_tpu_torch.training.optim import AdamW
from self_forcing_tpu_torch.training.trainer_distillation import (
    ScoreDistillationTrainer)
from self_forcing_tpu_torch.utils import tree


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: under the suite's six
    workers the default (one a core) oversubscribes the machine, and the
    idle threads' spinning slowed these tests ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
NB = 1                    # frames per block
STEPS = [1000.0, 500.0]   # the rollout's denoising steps


def _jcfg(cfg):
    # every field but the port's tp_group (a process group; the JAX
    # package names its mesh axis instead, tp_axis)
    return dataclasses.replace(J_TINY, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "tp_group"})


GEN_CFG = dataclasses.replace(WAN_TINY, num_frame_per_block=NB)


def _perturbed(tree_j, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(a.shape).astype(np.float32), tree_j)


@pytest.fixture(scope="module")
def models():
    """JAX parameter trees (numpy) and the port's copies: a causal
    generator with rank-4 LoRA adapters, a fake and a real score."""
    key = jax.random.PRNGKey(0)
    gen = jdit.init_params(key, J_TINY, dtype=jnp.float32)
    gen = jlora.apply_lora(gen, rank=4, alpha=4.0,
                           targets=["q", "k", "v", "o", "ffn.0", "ffn.2"],
                           key=jax.random.PRNGKey(1))
    gen = _perturbed(gen, 1)
    fake = _perturbed(jdit.init_params(jax.random.fold_in(key, 1), J_TINY,
                                       dtype=jnp.float32, causal=False), 2)
    real = _perturbed(jdit.init_params(jax.random.fold_in(key, 2), J_TINY,
                                       dtype=jnp.float32, causal=False), 3)
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((B, 8, WAN_TINY.text_dim)).astype(np.float32)
    neg = rng.standard_normal((B, 8, WAN_TINY.text_dim)).astype(np.float32)
    return dict(gen=gen, fake=fake, real=real, ctx=ctx, neg=neg)


def _torch_tree(tree_np):
    return params_from_jax(tree_np, "dit", device="cpu")


def _leaf_grads(loss, params):
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _with_grad(params):
    for t in tree.leaves(params):
        t.requires_grad_(True)
    return params


def _grads_close(grads_t, grads_j, tol=TOL):
    """Each leaf within tol of the JAX gradient, relative to the leaf's
    largest entry."""
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for gt, gj in zip(grads_t, flat_j):
        gj = np.asarray(gj)
        scale = max(float(np.abs(gj).max()), 1e-6)
        np.testing.assert_allclose(gt.numpy() / scale, gj / scale, rtol=0,
                                   atol=tol)


# ---------------------------------------------------------- scheduler

def test_scheduler_training_functions_match_jax():
    js = JSched.create(1000, shift=5.0, training=True)
    ts = TSched.create(1000, shift=5.0, training=True, device="cpu")
    rng = np.random.default_rng(0)
    x0, xt, v = (rng.standard_normal((6, 4, 3)).astype(np.float32)
                 for _ in range(3))
    t = np.array([999.0, 750.0, 500.0, 251.3, 40.0, 3.0], np.float32)
    tt = [torch.from_numpy(a) for a in (x0, xt, v, t)]
    for name in ("convert_x0_to_flow_pred", "convert_x0_to_noise",
                 "convert_noise_to_x0", "convert_flow_pred_to_x0"):
        np.testing.assert_allclose(
            getattr(ts, name)(tt[0], tt[1], tt[3]).numpy(),
            np.asarray(getattr(js, name)(x0, xt, t)), rtol=1e-5, atol=1e-5)
    for final in (False, True):
        np.testing.assert_allclose(
            ts.step(tt[2], tt[3], tt[1], to_final=final).numpy(),
            np.asarray(js.step(v, t, xt, to_final=final)), rtol=1e-6,
            atol=1e-6)
    np.testing.assert_array_equal(ts.training_target(tt[0], tt[2], tt[3])
                                  .numpy(), np.asarray(
                                      js.training_target(x0, v, t)))
    np.testing.assert_allclose(ts.training_weight(tt[3]).numpy(),
                               np.asarray(js.training_weight(t)), rtol=1e-6)
    np.testing.assert_allclose(tshift(tt[3], 5.0).numpy(),
                               np.asarray(jshift(t, 5.0)), rtol=1e-6)


def test_sample_timestep_per_block_is_constant_per_block():
    """Integer timesteps in [min_t, max_t), one draw a block (the first
    frame on its own with an independent first frame)."""
    g = torch.Generator().manual_seed(0)
    t = sample_timestep_per_block(20, 980, 2, 7, 3, True, generator=g,
                                  device="cpu")
    assert t.shape == (2, 7) and t.dtype == torch.int64
    assert int(t.min()) >= 20 and int(t.max()) < 980
    assert torch.equal(t[:, 1:4], t[:, 1:2].expand(2, 3))
    assert torch.equal(t[:, 4:7], t[:, 4:5].expand(2, 3))
    t = sample_timestep_per_block(20, 980, 1, 6, 3, generator=g,
                                  device="cpu")
    assert torch.equal(t[:, :3], t[:, :1].expand(1, 3))


def test_configs_load_as_in_jax():
    """Every YAML config merged over default_config.yaml gives the JAX
    package's Config."""
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(paths) > 5
    default = os.path.join(REPO, "configs", "default_config.yaml")
    for p in paths:
        assert tload_config(p, default).to_dict() == \
            jload_config(p, default).to_dict(), p


def test_lora_apply_merge_and_labels(models):
    """Adapters leave the model unchanged at init; merging folds them into
    the base weights as the JAX merge_lora does; the LoRA-only labels."""
    p = _torch_tree(jax.tree.map(np.asarray, jdit.init_params(
        jax.random.PRNGKey(3), J_TINY, dtype=jnp.float32)))
    lp = tlora.apply_lora(p, rank=4, alpha=8.0, seed=5)
    assert tlora.has_lora(lp) and not tlora.has_lora(p)
    x = torch.randn(3, WAN_TINY.dim)
    lin = tdit.split_layers(lp["blocks"])[1]["self_attn"]["q"]
    base = tdit.split_layers(p["blocks"])[1]["self_attn"]["q"]
    torch.testing.assert_close(tdit.linear(lin, x), tdit.linear(base, x))
    gen_t = _torch_tree(models["gen"])
    merged = tlora.merge_lora(gen_t)
    ref = jlora.merge_lora(models["gen"])
    for (path, a), b in zip(tree.items(merged), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
    labels = tlora.lora_label_tree(gen_t)
    jl = jlora.lora_label_tree(models["gen"])
    assert tree.leaves(labels) == jax.tree.leaves(jl)


# ------------------------------------------------------- forward_train

@pytest.mark.parametrize("kind", ["bidirectional", "block_causal",
                                  "teacher_forcing"])
def test_forward_train_matches_jax(models, kind):
    """The flow and (bidirectional) the gradient of every generator leaf,
    LoRA adapters included, of sum(flow * w)."""
    F = 4
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    t = np.tile(rng.uniform(0, 1000, (B, 1)).astype(np.float32), (1, F))
    w = rng.standard_normal(x.shape).astype(np.float32)
    fs = (H // 2) * (W // 2)
    jm = tm = clean = None
    if kind == "block_causal":
        jm, tm = (m.block_causal_mask(F, fs, 2) for m in (jmasks, tmasks))
    elif kind == "teacher_forcing":
        jm, tm = (m.teacher_forcing_mask(F, fs, 2) for m in (jmasks, tmasks))
        clean = rng.standard_normal(x.shape).astype(np.float32)
    jrope, trope = JRope.create(J_TINY.head_dim), TRope.create(
        WAN_TINY.head_dim, device="cpu")

    def jloss(p):
        flow = jdit.forward_train(p, J_TINY, x, t, models["ctx"], jm, jrope,
                                  clean_x=clean)
        return jnp.sum(flow * w), flow
    pt = _with_grad(_torch_tree(models["gen"]))
    flow_t = tdit.forward_train(pt, WAN_TINY, torch.from_numpy(x),
                                torch.from_numpy(t),
                                torch.from_numpy(models["ctx"]), tm, trope,
                                clean_x=None if clean is None
                                else torch.from_numpy(clean))
    if kind != "bidirectional":
        _, flow_j = jloss(models["gen"])
        np.testing.assert_allclose(flow_t.detach().numpy(),
                                   np.asarray(flow_j), rtol=TOL, atol=TOL)
        return
    (_, flow_j), gj = jax.value_and_grad(jloss, has_aux=True)(models["gen"])
    np.testing.assert_allclose(flow_t.detach().numpy(), np.asarray(flow_j),
                               rtol=TOL, atol=TOL)
    _grads_close(_leaf_grads((flow_t * torch.from_numpy(w)).sum(), pt), gj)


def test_forward_train_promotes_float32_inputs_over_bf16_weights(models):
    """bf16 weights (LoRA adapters included) with float32 latents and text
    context, as the trainer runs them: the activations stay float32, as
    jnp promotes them, so the flow equals the JAX package's at the
    float32 tolerance."""
    F = 2
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    t = np.full((B, F), 700.0, np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), models["gen"])
    flow_j = jdit.forward_train(jp, J_TINY, x, t, models["ctx"], None,
                                JRope.create(J_TINY.head_dim))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "dit", device="cpu",
                         dtype=torch.bfloat16)
    flow_t = tdit.forward_train(tp, WAN_TINY, torch.from_numpy(x),
                                torch.from_numpy(t),
                                torch.from_numpy(models["ctx"]), None,
                                TRope.create(WAN_TINY.head_dim, device="cpu"))
    assert flow_j.dtype == jnp.float32 and flow_t.dtype == torch.float32
    np.testing.assert_allclose(flow_t.numpy(), np.asarray(flow_j), rtol=TOL,
                               atol=TOL)


# ----------------------------------------------------------- rollout

def _jax_rollout_eps(rng_roll, exits, shape_blk):
    """The draws of the JAX rollout (no prefix blocks): block b's key is
    split(rng2, blocks)[b]; each step before its exit splits it once, the
    refresh folds 7 into it."""
    _, rng2 = jax.random.split(rng_roll)
    keys = jax.random.split(rng2, len(exits))
    eps = []
    for b, e in enumerate(exits):
        r, draws = keys[b], []
        for _ in range(int(e)):
            r, k = jax.random.split(r)
            draws.append(torch.from_numpy(np.array(
                jax.random.normal(k, shape_blk, jnp.float32))))
        refresh = jax.random.normal(jax.random.fold_in(keys[b], 7),
                                    shape_blk, jnp.float32)
        eps.append((draws, torch.from_numpy(np.array(refresh))))
    return eps


def _bundles():
    jobj = JObj(num_frame_per_block=NB, num_training_frames=2,
                timestep_shift=5.0)
    tobj = TObj(num_frame_per_block=NB, num_training_frames=2,
                timestep_shift=5.0)
    jb = JBundle.create(_jcfg(GEN_CFG), J_TINY, J_TINY, jobj, STEPS)
    tb = TBundle.create(GEN_CFG, WAN_TINY, WAN_TINY, tobj, STEPS,
                        device="cpu")
    return jobj, tobj, jb, tb


@pytest.mark.parametrize("exits", [1, (1, 0)])
def test_rollout_trajectory_and_gradient_match_jax(models, exits):
    """inference_with_trajectory (2 blocks of 1 frame, steps [1000, 500])
    with the JAX draws: the trajectory and the gradient of sum(traj * w)
    with respect to every generator leaf (through the exit forwards and
    the text context)."""
    _, _, jb, tb = _bundles()
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
    w = rng.standard_normal(noise.shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    j_exit = exits if isinstance(exits, int) else np.asarray(exits, np.int32)
    ex = [exits] * 2 if isinstance(exits, int) else list(exits)
    eps = _jax_rollout_eps(key, ex, (B, NB, C, H, W))

    def jloss(p):
        ctx_kv = jdit.precompute_context(p, jb.generator_cfg, models["ctx"])
        traj, _, _ = jb.pipeline.inference_with_trajectory(
            p, jb.generator_cfg, jb.rope_g, noise, ctx_kv, j_exit, key)
        return jnp.sum(traj * w), traj
    (_, traj_j), gj = jax.value_and_grad(jloss, has_aux=True)(models["gen"])
    pt = _with_grad(_torch_tree(models["gen"]))
    ctx_kv = tdit.precompute_context(pt, tb.generator_cfg,
                                     torch.from_numpy(models["ctx"]))
    traj_t, tf, tt = tb.pipeline.inference_with_trajectory(
        pt, tb.generator_cfg, tb.rope_g, torch.from_numpy(noise), ctx_kv,
        exits if isinstance(exits, int) else np.asarray(exits), eps=eps)
    np.testing.assert_allclose(traj_t.detach().numpy(), np.asarray(traj_j),
                               rtol=TOL, atol=TOL)
    if isinstance(exits, int):
        assert (tf, tt) == jb.pipeline.denoised_timestep_bounds(exits)
    _grads_close(_leaf_grads((traj_t * torch.from_numpy(w)).sum(), pt), gj)


# ------------------------------------------------------ DMD and critic

def _draws(rng_t, rng_n, obj, bounds, shape):
    min_t = bounds[1] if obj.ts_schedule and bounds[1] is not None else 0
    t = jax.random.randint(rng_t, (shape[0], 1), min_t, 1000)
    n = jax.random.normal(rng_n, shape, jnp.float32)
    return (torch.from_numpy(np.array(t)), torch.from_numpy(np.array(n)))


def test_dmd_generator_loss_matches_jax(models):
    """generator_loss (rollout with gradient, compute_kl_grad with CFG
    3.0, the DMD loss): value, logs and the generator's gradient."""
    jobj, tobj, jb, tb = _bundles()
    rng = np.random.default_rng(12)
    noise = rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
    key, exit_idx = jax.random.PRNGKey(13), 1
    (lj, logj), gj = jax.value_and_grad(
        lambda gp: jdmd.generator_loss(jb, jobj, gp, models["fake"],
                                       models["real"], noise, models["ctx"],
                                       models["neg"], exit_idx, key),
        has_aux=True)(models["gen"])
    rng_roll, rng_dmd = jax.random.split(key)
    rng_t, rng_n = jax.random.split(rng_dmd)
    t, n = _draws(rng_t, rng_n, jobj,
                  jb.pipeline.denoised_timestep_bounds(exit_idx),
                  noise.shape)
    draws = {"eps": _jax_rollout_eps(rng_roll, [exit_idx] * 2,
                                     (B, NB, C, H, W)), "t": t, "noise": n}
    pt = _with_grad(_torch_tree(models["gen"]))
    lt, logt = tdmd.generator_loss(
        tb, tobj, pt, _torch_tree(models["fake"]),
        _torch_tree(models["real"]), torch.from_numpy(noise),
        torch.from_numpy(models["ctx"]), torch.from_numpy(models["neg"]),
        exit_idx, draws=draws)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=TOL)
    for k in logj:
        np.testing.assert_allclose(float(logt[k]), float(logj[k]), rtol=TOL)
    _grads_close(_leaf_grads(lt, pt), gj)


def test_compute_kl_grad_matches_jax(models):
    jobj, tobj, jb, tb = _bundles()
    rng = np.random.default_rng(14)
    pred, noisy = (rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
                   for _ in range(2))
    t = np.full((B, 2), 600.0, np.float32)
    gj, logj = jdmd.compute_kl_grad(jb, jobj, models["fake"], models["real"],
                                    noisy, pred, t, models["ctx"],
                                    models["neg"])
    gt, logt = tdmd.compute_kl_grad(
        tb, tobj, _torch_tree(models["fake"]), _torch_tree(models["real"]),
        *(torch.from_numpy(a) for a in (noisy, pred, t, models["ctx"],
                                        models["neg"])))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(logt["dmdtrain_gradient_norm"]),
                               float(logj["dmdtrain_gradient_norm"]),
                               rtol=TOL)


def test_critic_loss_matches_jax(models):
    """critic_loss (no-grad rollout with per-block exits, the fake score's
    flow loss): value and the fake score's gradient."""
    jobj, tobj, jb, tb = _bundles()
    rng = np.random.default_rng(15)
    noise = rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
    key, exits = jax.random.PRNGKey(16), np.asarray([1, 0], np.int32)
    (lj, logj), gj = jax.value_and_grad(
        lambda fp: jdmd.critic_loss(jb, jobj, models["gen"], fp, noise,
                                    models["ctx"], models["neg"], exits,
                                    key), has_aux=True)(models["fake"])
    rng_roll, rng_t, rng_n = jax.random.split(key, 3)
    t, n = _draws(rng_t, rng_n, jobj, (None, None), noise.shape)
    draws = {"eps": _jax_rollout_eps(rng_roll, exits, (B, NB, C, H, W)),
             "t": t, "noise": n}
    ft = _with_grad(_torch_tree(models["fake"]))
    lt, logt = tdmd.critic_loss(
        tb, tobj, _torch_tree(models["gen"]), ft, torch.from_numpy(noise),
        torch.from_numpy(models["ctx"]), torch.from_numpy(models["neg"]),
        exits, draws=draws)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=TOL)
    np.testing.assert_allclose(float(logt["critic_timestep_mean"]),
                               float(logj["critic_timestep_mean"]),
                               rtol=TOL)
    _grads_close(_leaf_grads(lt, ft), gj)


# ----------------------------------------------------------- optimizer

@pytest.mark.parametrize("grad_scale", [0.01, 100.0])
def test_adamw_matches_optax(grad_scale):
    """Two updates of clip + AdamW (below and above the clip norm), with
    a leaf that has no gradient (it still decays)."""
    rng = np.random.default_rng(17)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32),
              "pose": rng.standard_normal((4,)).astype(np.float32)}
    grads = [{"a": grad_scale * rng.standard_normal((5, 3)).astype(
        np.float32), "b": grad_scale * rng.standard_normal((3,)).astype(
        np.float32), "pose": np.zeros(4, np.float32)} for _ in range(2)]
    kw = dict(lr=1e-3, beta1=0.0, beta2=0.999, weight_decay=0.01,
              max_grad_norm=10.0)
    opt = make_optimizer(**kw)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = opt.init(pj)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b", "pose")]
    topt = AdamW(**kw)
    st = topt.init(tp)
    for g in grads:
        u, sj = opt.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, u)
        st = topt.update(tp, [torch.from_numpy(g["a"]),
                              torch.from_numpy(g["b"]), None], st)
    for t, k in zip(tp, ("a", "b", "pose")):
        np.testing.assert_allclose(t.numpy(), np.asarray(pj[k]), rtol=1e-6,
                                   atol=1e-7)
    assert not np.allclose(tp[2].numpy(), params["pose"])


# ----------------------------------------------------------- trainer

def test_two_train_steps(models):
    """Step 0 updates the generator and the critic, step 1 the critic
    only; losses finite, the LoRA and fake-score leaves move."""
    config = tload_config(os.path.join(REPO, "configs", "tiny_test.yaml"),
                          os.path.join(REPO, "configs",
                                       "default_config.yaml"))
    config.update(lora_rank=4, lora_alpha=4, dfake_gen_update_ratio=2,
                  image_or_video_shape=[B, 2, C, H, W],
                  num_training_frames=2, seed=1)
    gen = tdit.init_params(WAN_TINY, 0, torch.float32, "cpu")
    fake = tdit.init_params(WAN_TINY, 1, torch.float32, "cpu", causal=False)
    real = tdit.init_params(WAN_TINY, 2, torch.float32, "cpu", causal=False)
    for p in (gen, fake, real):   # random output layers: nonzero flows
        p["head"]["head"]["w"].normal_(0, 0.1)
    ctx = torch.randn(B, 8, WAN_TINY.text_dim)
    trainer = ScoreDistillationTrainer(config, gen, fake, real, WAN_TINY,
                                       WAN_TINY, WAN_TINY, ctx.clone(),
                                       device="cpu", timing=True)
    before = [t.detach().clone() for t in trainer.gen_leaves
              + trainer.fake_leaves]
    logs = [trainer.train_step({"context": ctx}) for _ in range(2)]
    assert "generator_loss" in logs[0] and "generator_loss" not in logs[1]
    assert "generator_rollout_ms" in logs[0] and "critic_backward_ms" in \
        logs[1]
    for log in logs:
        assert all(np.isfinite(v) for v in log.values()), log
    moved = [not torch.equal(a, b.detach()) for a, b in zip(
        before, trainer.gen_leaves + trainer.fake_leaves)]
    n_gen = len(trainer.gen_leaves)
    assert any(moved[:n_gen]) and any(moved[n_gen:])
    paths = [p for p, _ in tree.items(trainer.state.generator)]
    lora_b = [m for p, m in zip(paths, moved) if "lora_B" in p]
    assert lora_b and all(lora_b)


def test_save_state_round_trip(tmp_path):
    """save_state / load_state restore the parameters, the optimizer
    moments and the step, so a resumed trainer continues identically."""
    config = tload_config(os.path.join(REPO, "configs", "tiny_test.yaml"))
    config.update(image_or_video_shape=[B, 1, C, H, W],
                  num_training_frames=1, denoising_step_list=[1000])

    def trainer():
        p = [tdit.init_params(WAN_TINY, i, torch.float32, "cpu",
                              causal=i == 0) for i in range(3)]
        for x in p:
            x["head"]["head"]["w"].normal_(0, 0.1)
        return ScoreDistillationTrainer(config, *p, WAN_TINY, WAN_TINY,
                                        WAN_TINY, torch.zeros(B, 8, 64),
                                        device="cpu")
    ctx = {"context": torch.ones(B, 8, WAN_TINY.text_dim)}
    a, b = trainer(), trainer()
    a.train_step(ctx)
    a.save_state(str(tmp_path / "state.pt"))
    b.load_state(str(tmp_path / "state.pt"))
    assert b.state.step == 1
    for x, y in zip(a.gen_leaves + a.fake_leaves, b.gen_leaves
                    + b.fake_leaves):
        assert torch.equal(x.detach(), y.detach())
    for x, y in zip(a.state.critic_opt_state["nu"],
                    b.state.critic_opt_state["nu"]):
        assert torch.equal(x, y)


def test_train_cli_two_steps(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "self_forcing_tpu_torch.train",
         "--config_path", "configs/tiny_test.yaml", "--max_steps", "2",
         "--no_save", "--device", "cpu", "--logdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[1]" in out.stdout and "critic_loss" in out.stdout
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2
