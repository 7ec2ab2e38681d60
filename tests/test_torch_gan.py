"""The port's GAN discriminator and GAN distillation against the JAX
package on the CPU (float32, WAN_TINY widths, every parameter leaf
perturbed so that the zero-initialised output layer takes part):

- ``forward_classify``: the flow, the logits and the gradient of every
  backbone and GAN-head leaf, at 6 layers (taps 3, 4, 5), with and
  without the time embedding in the classifier;
- ``WanDiffusionWrapper``'s classify mode and ``adding_cls_branch``;
- ``gan.generator_loss`` / ``critic_loss`` with the JAX package's draws
  injected: values, logs and gradients, plain, relativistic, and with
  the R1 / R2 penalties; the discriminator gets no gradient from the
  generator loss;
- ``GANTrainer``: the discriminator warmup, the update ratio, the GAN
  head's learning rate, and ``load_state`` with ``force_start_w_ema`` /
  ``force_reset_zero_step``.

Tolerances: 1e-4 on values (float32, sums in another order); gradients
1e-4 relative to each leaf's largest entry (1e-3 with the R1 / R2
penalties, whose finite differences scale the rounding by 1 / sigma).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import wrappers as jwrappers
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.training.objectives import gan as jgan
from self_forcing_tpu.training.objectives.base import (
    ModelBundle as JBundle, ObjectiveConfig as JObj)
from self_forcing_tpu_torch import wrappers as twrappers
from self_forcing_tpu_torch.config import load_config
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.training.objectives import gan as tgan
from self_forcing_tpu_torch.training.objectives.base import (
    ModelBundle as TBundle, ObjectiveConfig as TObj)
from self_forcing_tpu_torch.training.trainer_gan import GANTrainer
from self_forcing_tpu_torch.utils import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
NB, FR = 1, 2             # frames per block, frames
STEPS = [1000.0, 500.0]
J_SIX = dataclasses.replace(J_TINY, num_layers=6)
T_SIX = dataclasses.replace(WAN_TINY, num_layers=6)


def _perturbed(tree_j, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(a.shape).astype(np.float32), tree_j)


def _t(tree_np):
    return params_from_jax(tree_np, "dit", device="cpu")


def _with_grad(params):
    for t in tree.leaves(params):
        t.requires_grad_(True)
    return params


def _leaf_grads(loss, leaves):
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _grads_close(grads_t, grads_j, tol=TOL):
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for gt, gj in zip(grads_t, flat_j):
        gj = np.asarray(gj)
        scale = max(float(np.abs(gj).max()), 1e-6)
        np.testing.assert_allclose(gt.numpy() / scale, gj / scale, rtol=0,
                                   atol=tol)


def _np(x):
    return torch.from_numpy(np.array(x))


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


@pytest.fixture(scope="module")
def models():
    """JAX trees (numpy): a 2-layer causal generator and bidirectional
    critic with their GAN heads, a 6-layer critic and its head, a text
    context and real latents."""
    key = jax.random.PRNGKey(0)
    gen = _perturbed(jdit.init_params(key, J_TINY, dtype=jnp.float32), 1)
    fake = _perturbed(jdit.init_params(jax.random.fold_in(key, 1), J_TINY,
                                       dtype=jnp.float32, causal=False), 2)
    cls = _perturbed(jdit.init_cls_branch_params(
        jax.random.fold_in(key, 3), J_TINY), 3)
    six = _perturbed(jdit.init_params(jax.random.fold_in(key, 4), J_SIX,
                                      dtype=jnp.float32, causal=False), 4)
    cls_te = {te: _perturbed(jdit.init_cls_branch_params(
        jax.random.fold_in(key, 5), J_SIX,
        time_embed_dim=J_SIX.dim if te else 0), 5) for te in (False, True)}
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((B, 8, WAN_TINY.text_dim)).astype(np.float32)
    real = rng.standard_normal((B, FR, C, H, W)).astype(np.float32)
    return dict(gen=gen, fake=fake, cls=cls, six=six, cls_te=cls_te,
                ctx=ctx, real=real)


# ---------------------------------------------------- forward_classify

def test_default_gan_taps_match_jax():
    for n in (1, 2, 6, 30, 40):
        assert tdit.default_gan_taps(n) == jdit.default_gan_taps(n)
    assert tdit.default_gan_taps(6) == (3, 4, 5)
    assert tdit.default_gan_taps(30) == (13, 21, 29)


@pytest.mark.parametrize("concat_te", [False, True])
def test_forward_classify_matches_jax(models, concat_te):
    """Flow and logits of the 6-layer classify forward, and the gradient
    of sum(flow * w) + sum(logits * u) with respect to every backbone and
    GAN-head leaf."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, FR, C, H, W)).astype(np.float32)
    t = np.tile(rng.uniform(0, 1000, (B, 1)).astype(np.float32), (1, FR))
    w = rng.standard_normal(x.shape).astype(np.float32)
    u = rng.standard_normal((B, 1)).astype(np.float32)
    cls = models["cls_te"][concat_te]

    def jloss(p, c):
        flow, logits = jdit.forward_classify(
            p, c, J_SIX, x, t, models["ctx"], JRope.create(J_SIX.head_dim),
            concat_time_embeddings=concat_te)
        return jnp.sum(flow * w) + jnp.sum(logits * u), (flow, logits)
    # jitted: one compile of the 6-layer forward and its gradient is ~3x
    # cheaper than eager JAX's per-operation dispatch
    (_, (flow_j, logits_j)), (gp, gc) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(models["six"], cls)
    pt, ct = _with_grad(_t(models["six"])), _with_grad(_t(cls))
    flow_t, logits_t = tdit.forward_classify(
        pt, ct, T_SIX, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(models["ctx"]),
        TRope.create(T_SIX.head_dim, device="cpu"),
        concat_time_embeddings=concat_te)
    assert logits_t.shape == (B, 1)
    np.testing.assert_allclose(flow_t.detach().numpy(), np.asarray(flow_j),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=TOL, atol=TOL)
    loss = (flow_t * torch.from_numpy(w)).sum() \
        + (logits_t * torch.from_numpy(u)).sum()
    leaves_p, leaves_c = tree.leaves(pt), tree.leaves(ct)
    grads = _leaf_grads(loss, leaves_p + leaves_c)
    _grads_close(grads[:len(leaves_p)], gp)
    _grads_close(grads[len(leaves_p):], gc)


def test_wrapper_classify_mode_and_cls_branch(models):
    """The classify mode returns (flow, pred_x0, logits) as the JAX
    wrapper does; without a head it raises; ``adding_cls_branch``
    attaches a float32 head of the JAX head's structure and shapes."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, FR, C, H, W)).astype(np.float32)
    t = np.full((B,), 700.0, np.float32)
    jw = jwrappers.WanDiffusionWrapper(models["fake"], J_TINY,
                                       is_causal=False,
                                       cls_params=models["cls"])
    tw = twrappers.WanDiffusionWrapper(_t(models["fake"]), WAN_TINY,
                                       is_causal=False,
                                       cls_params=_t(models["cls"]))
    out_j = jax.jit(lambda a: jw(a, {"prompt_embeds": models["ctx"]}, t,
                                 classify_mode=True))(x)
    with torch.no_grad():
        out_t = tw(torch.from_numpy(x),
                   {"prompt_embeds": torch.from_numpy(models["ctx"])},
                   torch.from_numpy(t), classify_mode=True)
    assert len(out_t) == len(out_j) == 3
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    bare = twrappers.WanDiffusionWrapper(_t(models["fake"]), WAN_TINY,
                                         is_causal=False)
    with pytest.raises(ValueError, match="adding_cls_branch"):
        bare(torch.from_numpy(x),
             {"prompt_embeds": torch.from_numpy(models["ctx"])},
             torch.from_numpy(t), classify_mode=True)
    head_t = bare.adding_cls_branch(num_class=2, time_embed_dim=8, seed=3)
    head_j = jwrappers.WanDiffusionWrapper(
        models["fake"], J_TINY, is_causal=False).adding_cls_branch(
        num_class=2, time_embed_dim=8)
    assert bare.cls_params is head_t
    shapes_t = {p: (tuple(a.shape), a.dtype) for p, a in tree.items(head_t)}
    shapes_j = {tuple(getattr(k, "key", getattr(k, "idx", None))
                      for k in path): (b.shape, torch.float32)
                for path, b in jax.tree_util.tree_flatten_with_path(
                    head_j)[0]}
    assert shapes_t == shapes_j


# ------------------------------------------------------------ losses

def _bundles(jobj, tobj):
    gcfg_t = dataclasses.replace(WAN_TINY, num_frame_per_block=NB)
    gcfg_j = dataclasses.replace(J_TINY, num_frame_per_block=NB)
    jb = JBundle.create(gcfg_j, J_TINY, J_TINY, jobj, STEPS)
    tb = TBundle.create(gcfg_t, WAN_TINY, WAN_TINY, tobj, STEPS,
                        device="cpu")
    return jb, tb


def _objs():
    kw = dict(num_frame_per_block=NB, num_training_frames=FR,
              timestep_shift=5.0)
    return JObj(**kw), TObj(**kw)


def _critic_draw(jobj, jb, rng_t, exit_idx):
    t_from, t_to = jb.pipeline.denoised_timestep_bounds(exit_idx)
    min_t = t_to if jobj.ts_schedule else jobj.min_score_timestep
    return _np(jax.random.randint(rng_t, (B, 1), int(min_t),
                                  jobj.num_train_timestep))


@pytest.mark.parametrize("relativistic", [False, True])
def test_gan_generator_loss_matches_jax(models, relativistic):
    """Rollout with gradient, the batched fake|real discriminator pass:
    value, logs and the generator's gradient (critic shift 3.0)."""
    jobj, tobj = _objs()
    jb, tb = _bundles(jobj, tobj)
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((B, FR, C, H, W)).astype(np.float32)
    key, exit_idx = jax.random.PRNGKey(10), 1
    kw = dict(gan_g_weight=0.5, relativistic=relativistic, critic_shift=3.0)
    (lj, logj), gj = jax.value_and_grad(
        lambda gp: jgan.generator_loss(
            jb, jobj, gp, models["fake"], models["cls"], noise,
            models["real"], models["ctx"], None, exit_idx, key, **kw),
        has_aux=True)(models["gen"])
    rng_roll, rng_t, rng_n = jax.random.split(key, 3)
    draws = {"eps": _jax_rollout_eps(rng_roll, [exit_idx] * FR,
                                     (B, NB, C, H, W)),
             "t": _critic_draw(jobj, jb, rng_t, exit_idx),
             "noise": _np(jax.random.normal(rng_n, noise.shape)),
             "real_noise": _np(jax.random.normal(jax.random.fold_in(
                 rng_n, 1), noise.shape))}
    gt = _with_grad(_t(models["gen"]))
    ft, ct = _with_grad(_t(models["fake"])), _with_grad(_t(models["cls"]))
    lt, logt = tgan.generator_loss(
        tb, tobj, gt, ft, ct, torch.from_numpy(noise),
        torch.from_numpy(models["real"]), torch.from_numpy(models["ctx"]),
        None, exit_idx, draws=draws, **kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=TOL)
    assert set(logt) == set(logj)
    for k in logj:
        np.testing.assert_allclose(float(logt[k]), float(logj[k]),
                                   rtol=TOL, atol=1e-6)
    leaves_g = tree.leaves(gt)
    others = tree.leaves(ft) + tree.leaves(ct)
    grads = torch.autograd.grad(lt, leaves_g + others, allow_unused=True)
    # the frozen discriminator gets no gradient; the generator's matches
    assert all(g is None for g in grads[len(leaves_g):])
    _grads_close([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves_g, grads[:len(leaves_g)])], gj)


@pytest.mark.parametrize("case", ["plain", "relativistic", "r1_r2"])
def test_gan_critic_loss_matches_jax(models, case):
    """No-grad rollout, the discriminator loss and the R1 / R2
    penalties: value, logs and the gradient of every critic and GAN-head
    leaf."""
    jobj, tobj = _objs()
    jb, tb = _bundles(jobj, tobj)
    rng = np.random.default_rng(11)
    noise = rng.standard_normal((B, FR, C, H, W)).astype(np.float32)
    key, exit_idx = jax.random.PRNGKey(12), 0
    kw = dict(gan_d_weight=0.3, relativistic=case == "relativistic")
    if case == "r1_r2":
        kw.update(r1_weight=0.2, r2_weight=0.1, r1_sigma=0.05,
                  r2_sigma=0.02)
    (lj, logj), (gfj, gcj) = jax.value_and_grad(
        lambda fp, cp: jgan.critic_loss(
            jb, jobj, models["gen"], fp, cp, noise, models["real"],
            models["ctx"], None, exit_idx, key, **kw),
        argnums=(0, 1), has_aux=True)(models["fake"], models["cls"])
    rng_roll, rng_t, rng_n, rng_r = jax.random.split(key, 4)
    draws = {"eps": _jax_rollout_eps(rng_roll, [exit_idx] * FR,
                                     (B, NB, C, H, W)),
             "t": _critic_draw(jobj, jb, rng_t, exit_idx),
             "noise": _np(jax.random.normal(rng_n, noise.shape)),
             "r1_noise": _np(jax.random.normal(rng_r, noise.shape)),
             "r2_noise": _np(jax.random.normal(jax.random.fold_in(rng_r, 1),
                                               noise.shape))}
    ft, ct = _with_grad(_t(models["fake"])), _with_grad(_t(models["cls"]))
    lt, logt = tgan.critic_loss(
        tb, tobj, _t(models["gen"]), ft, ct, torch.from_numpy(noise),
        torch.from_numpy(models["real"]), torch.from_numpy(models["ctx"]),
        None, exit_idx, draws=draws, **kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=TOL)
    assert set(logt) == set(logj)
    for k in logj:
        np.testing.assert_allclose(float(logt[k]), float(logj[k]),
                                   rtol=TOL, atol=1e-6)
    if case == "r1_r2":
        assert float(logt["r1_loss"]) > 0 and float(logt["r2_loss"]) > 0
    lf, lc = tree.leaves(ft), tree.leaves(ct)
    grads = _leaf_grads(lt, lf + lc)
    # the penalties divide the difference of two discriminator passes by
    # sigma (0.02), which scales each pass's float32 rounding up ~50x:
    # their gradients agree within 1e-3 (measured 2.7e-4)
    gtol = 1e-3 if case == "r1_r2" else TOL
    _grads_close(grads[:len(lf)], gfj, gtol)
    _grads_close(grads[len(lf):], gcj, gtol)


# ----------------------------------------------------------- trainer

def _gan_config(**kw):
    config = load_config(os.path.join(REPO, "configs",
                                      "self_forcing_gan.yaml"),
                         os.path.join(REPO, "configs",
                                      "default_config.yaml"))
    config.update(image_or_video_shape=[B, FR, C, H, W],
                  num_training_frames=FR, num_frame_per_block=NB,
                  denoising_step_list=[1000, 500], warp_denoising_step=False,
                  lr=1e-3, lr_critic=1e-3, seed=1, **kw)
    return config


def _gan_trainer(config):
    gen = tdit.init_params(WAN_TINY, 0, torch.float32, "cpu")
    fake = tdit.init_params(WAN_TINY, 1, torch.float32, "cpu",
                            causal=False)
    for p in (gen, fake):   # random output layers: nonzero flows
        p["head"]["head"]["w"].normal_(0, 0.1, generator=torch.Generator(
            ).manual_seed(2))
    return GANTrainer(config, gen, fake, WAN_TINY, WAN_TINY, device="cpu")


def _batch():
    g = torch.Generator().manual_seed(3)
    return {"context": torch.randn(B, 8, WAN_TINY.text_dim, generator=g),
            "latents": torch.randn(B, FR, C, H, W, generator=g)}


def test_gan_trainer_warmup_and_update_ratio():
    """Warmup 1 step, ratio 2: the generator updates at step 2 only, the
    critic and its head every step; logs finite; the head's optimizer
    runs at lr_critic * discriminator_lr_multiplier."""
    trainer = _gan_trainer(_gan_config(discriminator_warmup_steps=1,
                                       dfake_gen_update_ratio=2,
                                       discriminator_lr_multiplier=4.0))
    assert trainer.critic_optimizer.lr == pytest.approx(1e-3)
    assert trainer.cls_optimizer.lr == pytest.approx(4e-3)
    batch = _batch()
    for step in range(4):
        gen0 = [p.detach().clone() for p in trainer.gen_leaves]
        crit0 = [p.detach().clone() for p in trainer.fake_leaves
                 + trainer.cls_leaves]
        log = trainer.train_step(batch)
        assert all(np.isfinite(v) for v in log.values()), log
        gen_moved = any(not torch.equal(a, b.detach())
                        for a, b in zip(gen0, trainer.gen_leaves))
        assert ("generator_loss" in log) == (step == 2) == gen_moved
        assert all(not torch.equal(a, b.detach()) for a, b in zip(
            crit0[len(trainer.fake_leaves):], trainer.cls_leaves))
        assert any(not torch.equal(a, b.detach()) for a, b in zip(
            crit0, trainer.fake_leaves))
        assert {"critic_loss", "gan_d_loss", "r1_loss"} <= set(log)
    assert trainer.step == 4


def test_gan_trainer_load_state_forces(tmp_path):
    """save_state -> load_state restores every leaf and the step;
    force_start_w_ema puts the checkpoint's EMA into the live generator,
    force_reset_zero_step restarts the step; a checkpoint without EMA
    refuses force_start_w_ema."""
    config = _gan_config(ema_weight=0.5, ema_start_step=0)
    a = _gan_trainer(config)
    batch = _batch()
    for _ in range(2):
        a.train_step(batch)
    assert a.generator_ema is not None
    path = str(tmp_path / "gan_state.pt")
    a.save_state(path)

    b = _gan_trainer(config)
    b.load_state(path)
    assert b.step == 2
    for x, y in zip(a.gen_leaves + a.fake_leaves + a.cls_leaves,
                    b.gen_leaves + b.fake_leaves + b.cls_leaves):
        assert torch.equal(x.detach(), y.detach())
    for x, y in zip(a.cls_opt_state["nu"], b.cls_opt_state["nu"]):
        assert torch.equal(x, y)

    c = _gan_trainer(config)
    c.load_state(path, force_start_w_ema=True, force_reset_zero_step=True)
    assert c.step == 0
    for x, e in zip(c.gen_leaves, tree.leaves(a.generator_ema)):
        assert torch.equal(x.detach(), e.to(x.dtype))
    assert any(not torch.equal(x.detach(), y.detach())
               for x, y in zip(a.gen_leaves, c.gen_leaves))
    log = c.train_step(batch)   # step 0 again: the generator updates
    assert "generator_loss" in log

    plain = _gan_trainer(_gan_config())
    plain.train_step(batch)
    path2 = str(tmp_path / "no_ema.pt")
    plain.save_state(path2)
    with pytest.raises(ValueError, match="no EMA"):
        _gan_trainer(_gan_config()).load_state(path2, force_start_w_ema=True)
