"""Pose-conditioned Self-Forcing distillation in the port against the JAX
package on the CPU (float32, WAN_TINY widths at 1 layer, every parameter
leaf perturbed, the JAX side's draws injected):

- ``align_cond_window`` and ``model_cond`` (exact);
- the training rollout with ``y`` and ``add_condition``: a shared exit,
  per-block exits, and a 22-frame rollout with a 1-block no-grad prefix;
- the DMD generator and critic losses and SiD's generator loss with a
  conditioning dict, for a pose-only t2v setup and a tiny i2v one
  (``in_dim`` 36, ``model_type`` i2v), so that ``y`` and ``clip_fea``
  reach every model: values and gradients;
- ``trim_rollout`` at 24 frames on a tiny VAE (the boundary re-encode,
  the gradient mask, the trailing ``y`` window), and a pose video too
  short for the rollout;
- the pose ``ScoreDistillationTrainer``: its conditioning dict for one
  batch and one keep mask, its host RNG's rollout lengths and exits over
  six steps, and one real step;
- ``load_lora_weights`` in each key format.

Tolerances: 1e-4 on values (float32, sums in another order); gradients
1e-4 relative to each leaf's largest entry; the conditioning dict 1e-5
relative L2; the LoRA trees, the masks and the windows exactly.  The
weights are drawn by the port's inits and handed to the JAX package as
numpy; its VAE, CLIP and pose CNNs run jitted (one compile a shape).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import conditioning as jcond
from self_forcing_tpu import lora as jlora
from self_forcing_tpu.config import Config as JConfig
from self_forcing_tpu.models import clip as jclip
from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.pipelines.self_forcing_training import (
    SelfForcingTrainingPipeline as JPipe)
from self_forcing_tpu.scheduler import FlowMatchScheduler as JSched
from self_forcing_tpu.training.objectives import base as jbase
from self_forcing_tpu.training.objectives import dmd as jdmd
from self_forcing_tpu.training.objectives import sid as jsid
from self_forcing_tpu.training.trainer_distillation import (
    ScoreDistillationTrainer as JTrainer)
from self_forcing_tpu_torch import conditioning as tcond
from self_forcing_tpu_torch import inference as tinf
from self_forcing_tpu_torch import lora as tlora
from self_forcing_tpu_torch.config import Config as TConfig
from self_forcing_tpu_torch.models import clip as tclip
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan import vae as tvae
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.pipelines.self_forcing_training import (
    SelfForcingTrainingPipeline as TPipe)
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler as TSched
from self_forcing_tpu_torch.training.objectives import base as tbase
from self_forcing_tpu_torch.training.objectives import dmd as tdmd
from self_forcing_tpu_torch.training.objectives import sid as tsid
from self_forcing_tpu_torch.training.trainer_distillation import (
    ScoreDistillationTrainer as TTrainer)
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


TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
FS = (H // 2) * (W // 2)
N_IMG = 257
STEPS = [1000.0, 500.0]
ONE = dict(num_layers=1)
SETUPS = {
    # (generator, score models) configs; y / clip_fea reach a model only
    # where it consumes them
    "pose": (dataclasses.replace(J_TINY, num_frame_per_block=1, **ONE),
             dataclasses.replace(J_TINY, **ONE)),
    "i2v": (dataclasses.replace(J_TINY, num_frame_per_block=1,
                                model_type="i2v", in_dim=36, **ONE),
            dataclasses.replace(J_TINY, model_type="i2v", in_dim=36, **ONE)),
}
J_VAE = jvae.VAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2),
                       num_res_blocks=1)
J_CLIP = jclip.CLIPConfig(image_size=28, patch_size=14, vision_dim=1280,
                          vision_heads=8, vision_layers=2)
T_CLIP = tclip.CLIPConfig(image_size=28, patch_size=14, vision_dim=1280,
                          vision_heads=8, vision_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_encoders():
    """The JAX package's VAE, CLIP and pose-CNN entry points jitted for
    this module (one compile a shape where eager dispatch compiles each
    op); the functions are the package's own."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, static in ((jvae, "encode", (1,)),
                                  (jvae, "decode", (1,)),
                                  (jclip, "encode_image", (1,)),
                                  (jcond, "dwpose_embedding", ()),
                                  (jcond, "randomref_embedding", ())):
            mp.setattr(mod, name, jax.jit(getattr(mod, name),
                                          static_argnums=static))
        yield


def _tcfg(jcfg):
    """The port's WanConfig with a JAX config's values."""
    return dataclasses.replace(WAN_TINY, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(WAN_TINY)})


def _jax_layout(node, key=None):
    """A port tree as numpy in the JAX package's layout (conv weights
    OIDHW -> DHWIO, OIHW -> HWIO)."""
    if isinstance(node, dict):
        return {k: _jax_layout(v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_jax_layout(v, key) for v in node)
    a = node.numpy()
    if key == "w" and a.ndim == 5:
        return a.transpose(2, 3, 4, 1, 0)
    if key == "w" and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a


def _perturbed(tree_np, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(np.shape(a)).astype(np.float32),
                        tree_np)


@functools.lru_cache(maxsize=None)
def _models(setup):
    """(JAX numpy tree, port tree) of the generator, fake and real score."""
    gcfg, scfg = SETUPS[setup]
    out = []
    for i, (cfg, causal) in enumerate(((gcfg, True), (scfg, False),
                                       (scfg, False))):
        jp = _perturbed(_jax_layout(tdit.init_params(
            _tcfg(cfg), seed=i + 1, dtype=torch.float32, device="cpu",
            causal=causal)), i + 10)
        out.append(jp)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _tp(jp):
    return params_from_jax(jp, "dit", device="cpu")


def _with_grad(params):
    for t in tree.leaves(params):
        t.requires_grad_(True)
    return params


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(a.detach() if isinstance(a, torch.Tensor) else a),
        np.asarray(b), rtol=tol, atol=tol)


def _grads_close(loss, params, grads_j, tol=TOL):
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_j) == len(leaves)
    for p, gt, gj in zip(leaves, grads, flat_j):
        gt = torch.zeros_like(p) if gt is None else gt
        gj = np.asarray(gj)
        scale = max(float(np.abs(gj).max()), 1e-6)
        np.testing.assert_allclose(gt.numpy() / scale, gj / scale, rtol=0,
                                   atol=tol)


def _cond(seed, F, setup):
    """A conditioning dict: pose tokens and y always (a t2v model ignores
    y), CLIP tokens for the i2v setup."""
    rng = np.random.default_rng(seed)
    cond = {"add_condition": rng.standard_normal((B, F * FS, 5120)).astype(
                np.float32),
            "y": rng.standard_normal((B, F, 20, H, W)).astype(np.float32)}
    if setup == "i2v":
        cond["clip_fea"] = rng.standard_normal((B, N_IMG, 1280)).astype(
            np.float32)
    return cond


def _tcond(cond):
    return {k: _t(v) for k, v in cond.items()}


def _text(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, 8, J_TINY.text_dim)).astype(np.float32)
            for _ in range(2)]


def _jax_rollout_eps(rng_roll, exits, shape_blk, pre_blocks=0):
    """The JAX rollout's draws: split(rng) gives the no-grad prefix's and
    the grad suffix's keys, split over their blocks; a block's key splits
    once a step before its exit; the refresh folds in 7."""
    rng1, rng2 = jax.random.split(rng_roll)
    keys = list(jax.random.split(rng1, pre_blocks)) if pre_blocks else []
    keys += list(jax.random.split(rng2, len(exits) - pre_blocks))
    eps = []
    for key, e in zip(keys, exits):
        r, draws = key, []
        for _ in range(int(e)):
            r, k = jax.random.split(r)
            draws.append(_t(jax.random.normal(k, shape_blk, jnp.float32)))
        eps.append((draws, _t(jax.random.normal(
            jax.random.fold_in(key, 7), shape_blk, jnp.float32))))
    return eps


# ------------------------------------------------------------- helpers

def test_align_cond_window_and_model_cond_match_jax():
    """The trailing window of a trimmed rollout, the whole rollout when
    untrimmed, dicts without y untouched; and which model takes y and
    clip_fea."""
    y = np.arange(25, dtype=np.float32).reshape(1, 25, 1, 1, 1)
    for f_roll, f_pred in ((23, 21), (21, 21), (24, 21), (2, 2)):
        want = jbase.align_cond_window({"y": jnp.asarray(y)}, f_roll,
                                       f_pred)["y"]
        got = tbase.align_cond_window({"y": _t(y)}, f_roll, f_pred)["y"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tbase.align_cond_window(None, 21, 21) is None
    only = {"add_condition": _t(y)}
    assert tbase.align_cond_window(only, 24, 21) is only
    cond = {"y": _t(y), "clip_fea": _t(y[:, :3])}
    for setup in SETUPS:
        for jcfg in SETUPS[setup]:
            jy, jc = jbase.model_cond(jcfg, {"y": y, "clip_fea": y[:, :3]})
            ty, tc = tbase.model_cond(_tcfg(jcfg), cond)
            assert (ty is None) == (jy is None)
            assert (tc is None) == (jc is None)
            assert ty is None or ty is cond["y"]
            assert tc is None or tc is cond["clip_fea"]
    assert tbase.model_cond(WAN_TINY, None) == (None, None)


# ------------------------------------------------------------- rollout

@pytest.mark.parametrize("case", ["shared", "per_block", "prefix"])
def test_conditioned_rollout_matches_jax(case):
    """``inference_with_trajectory`` of the i2v generator with y, the
    pose tokens and the image K/V: one exit for every block, an exit a
    block, and 22 frames (the first block a no-grad prefix, the cache 22
    frames long)."""
    gcfg = SETUPS["i2v"][0]
    jgen = _models("i2v")[0]
    F = 22 if case == "prefix" else 2
    exit_idx = [0, 1] if case == "per_block" else 1
    cond = _cond(20, F, "i2v")
    noise = np.random.default_rng(21).standard_normal(
        (B, F, C, H, W)).astype(np.float32)
    ctx, _ = _text(22)
    key = jax.random.PRNGKey(23)
    jsched = JSched.create(1000, shift=5.0, training=True)
    jpipe = JPipe(STEPS, jsched, num_frame_per_block=1, num_max_frames=F)

    @jax.jit
    def run(p, noise, ctx, cond):
        kv = jdit_precompute(p, gcfg, ctx, cond["clip_fea"])
        return jpipe.inference_with_trajectory(
            p, gcfg, JRope.create(gcfg.head_dim), noise, kv, exit_idx if
            isinstance(exit_idx, int) else np.asarray(exit_idx, np.int32),
            key, y=cond["y"], add_condition=cond["add_condition"])[0]
    want = run(jgen, noise, ctx, cond)

    tcfg = _tcfg(gcfg)
    tpipe = TPipe(STEPS, TSched.create(1000, shift=5.0, training=True,
                                       device="cpu"),
                  num_frame_per_block=1, num_max_frames=F)
    tgen = _tp(jgen)
    tc = _tcond(cond)
    kv = tdit.precompute_context(tgen, tcfg, _t(ctx), tc["clip_fea"])
    exits = exit_idx if isinstance(exit_idx, list) else [exit_idx] * F
    eps = _jax_rollout_eps(key, exits, (B, 1, C, H, W),
                           pre_blocks=1 if case == "prefix" else 0)
    with torch.no_grad():
        got, _, _ = tpipe.inference_with_trajectory(
            tgen, tcfg, TRope.create(tcfg.head_dim, device="cpu"),
            _t(noise), kv, exit_idx, eps=eps, kernels=False, y=tc["y"],
            add_condition=tc["add_condition"])
    assert got.shape == (B, F, C, H, W)
    _close(got, want)


def jdit_precompute(p, cfg, ctx, clip_fea):
    from self_forcing_tpu.models.wan import dit as jdit
    return jdit.precompute_context(p, cfg, ctx, clip_fea)


# ---------------------------------------------------------- objectives

def _bundles(setup, frames=2, vae=None):
    gcfg, scfg = SETUPS[setup]
    kw = dict(num_frame_per_block=1, num_training_frames=frames,
              timestep_shift=5.0, sid_alpha=0.7)
    jobj, tobj = jbase.ObjectiveConfig(**kw), tbase.ObjectiveConfig(**kw)
    jvp, tvp = (None, None) if vae is None else vae
    jb = jbase.ModelBundle.create(gcfg, scfg, scfg, jobj, STEPS,
                                  vae_params=jvp, vae_cfg=J_VAE)
    tb = tbase.ModelBundle.create(_tcfg(gcfg), _tcfg(scfg), _tcfg(scfg),
                                  tobj, STEPS, vae_params=tvp,
                                  vae_cfg=tinf.TINY_VAE, device="cpu")
    return jobj, tobj, jb, tb


@pytest.mark.parametrize("objective,which,setup", [
    ("dmd", "generator", "pose"), ("dmd", "critic", "pose"),
    ("dmd", "generator", "i2v"), ("dmd", "critic", "i2v"),
    ("sid", "generator", "pose"), ("sid", "generator", "i2v")])
def test_conditioned_losses_match_jax(objective, which, setup):
    """The loss with a conditioning dict (pose tokens, y, and CLIP tokens
    for i2v) threaded through the rollout, the score forwards and the
    critic: value, logs and the trained model's gradient."""
    jobj, tobj, jb, tb = _bundles(setup)
    jgen, jfake, jreal = _models(setup)
    cond = _cond(30, 2, setup)
    noise = np.random.default_rng(31).standard_normal(
        (B, 2, C, H, W)).astype(np.float32)
    ctx, neg = _text(32)
    key, exit_idx = jax.random.PRNGKey(33), 1
    jmod = jdmd if objective == "dmd" else jsid
    if which == "generator":
        fn = jax.jit(jax.value_and_grad(
            lambda p, c: jmod.generator_loss(jb, jobj, p, jfake, jreal,
                                             noise, ctx, neg, exit_idx, key,
                                             cond=c), has_aux=True))
        (lj, logj), gj = fn(jgen, cond)
        rng_roll, rng_loss = jax.random.split(key)
        rng_t, rng_n = jax.random.split(rng_loss)
    else:
        fn = jax.jit(jax.value_and_grad(
            lambda p, c: jdmd.critic_loss(jb, jobj, jgen, p, noise, ctx, neg,
                                          exit_idx, key, cond=c),
            has_aux=True))
        (lj, logj), gj = fn(jfake, cond)
        rng_roll, rng_t, rng_n = jax.random.split(key, 3)
    lo = jb.pipeline.denoised_timestep_bounds(exit_idx)[1]
    draws = {"eps": _jax_rollout_eps(rng_roll, [exit_idx] * 2,
                                     (B, 1, C, H, W)),
             "t": _t(jax.random.randint(rng_t, (B, 1), int(lo), 1000)),
             "noise": _t(jax.random.normal(rng_n, noise.shape))}
    args = [_t(a) for a in (noise, ctx, neg)]
    tc = _tcond(cond)
    if which == "generator":
        pt = _with_grad(_tp(jgen))
        tmod = tdmd if objective == "dmd" else tsid
        lt, logt = tmod.generator_loss(tb, tobj, pt, _tp(jfake), _tp(jreal),
                                       *args, exit_idx, draws=draws,
                                       kernels=False, cond=tc)
    else:
        pt = _with_grad(_tp(jfake))
        lt, logt = tdmd.critic_loss(tb, tobj, _tp(jgen), pt, *args, exit_idx,
                                    draws=draws, kernels=False, cond=tc)
    _close(lt, lj)
    assert set(logt) == set(logj)
    for k in logj:
        _close(logt[k], logj[k])
    _grads_close(lt, pt, gj)


# ------------------------------------------------------- long rollouts

@functools.lru_cache(maxsize=None)
def _vae():
    jvp = _perturbed(_jax_layout(tvae.init_params(
        tinf.TINY_VAE, seed=2, device="cpu")), 2)
    return jvp, params_from_jax(jvp, "vae", device="cpu")


def test_trim_rollout_long_matches_jax():
    """24 frames: the boundary frame is the VAE decode of the first 4
    frames, its last pixel frame re-encoded; the last 20 pass as they are;
    the first block is masked; the trailing y window pairs the kept frames
    with their conditioning.  21 frames pass untrimmed."""
    jvp, tvp = _vae()
    _, _, jb, tb = _bundles("pose", frames=24, vae=(jvp, tvp))
    for b in (jb, tb):
        b.pipeline.num_frame_per_block = 3
    pred = np.random.default_rng(40).standard_normal(
        (B, 24, C, H, W)).astype(np.float32)
    jout, jmask = jb.trim_rollout(jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    tout, tmask = tb.trim_rollout(tp)
    assert tout.shape == (B, 21, C, H, W)
    _close(tout, jout)
    np.testing.assert_array_equal(tout[:, 1:].detach().numpy(),
                                  pred[:, -20:])
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert not tmask[:, :3].any() and tmask[:, 3:].all()
    # the re-encoded boundary frame carries no gradient
    g, = torch.autograd.grad(tout[:, :1].sum() + 0 * tout.sum(), tp)
    assert not g[:, :4].any()
    y = np.random.default_rng(41).standard_normal((B, 24, 20, H, W)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tbase.align_cond_window({"y": _t(y)}, 24, 21)["y"].numpy(),
        np.asarray(jbase.align_cond_window({"y": y}, 24, 21)["y"]))
    short = _t(pred[:, :21])
    assert tb.trim_rollout(short) == (short, None)
    _, _, _, bare = _bundles("pose", frames=24)
    with pytest.raises(ValueError, match="need the VAE"):
        bare.trim_rollout(_t(pred))


def test_pose_video_shorter_than_rollout_raises():
    """A 24-frame rollout needs pose tokens of 24 latent frames (a pose
    video of 93 pixel frames).  With 21 frames of tokens the JAX rollout
    fails on a reshape inside its block scan; the port says why."""
    _, _, jb, tb = _bundles("pose", frames=24)
    jgen = _models("pose")[0]
    noise = np.zeros((B, 24, C, H, W), np.float32)
    ctx, _ = _text(42)
    short = {"add_condition": np.zeros((B, 21 * FS, 5120), np.float32)}
    with pytest.raises(TypeError):
        jax.eval_shape(lambda n, c: jb.run_generator(
            jgen, n, jdit_precompute(jgen, jb.generator_cfg, ctx, None), 1,
            jax.random.PRNGKey(0), cond=c), noise, short)
    tgen = _tp(jgen)
    kv = tdit.precompute_context(tgen, tb.generator_cfg, _t(ctx))
    with pytest.raises(ValueError, match="4F - 3 pixel frames"):
        tb.run_generator(tgen, _t(noise), kv, 1, kernels=False,
                         cond=_tcond(short))


# ------------------------------------------------------------- trainer

def _pose_weights(path):
    """A UniAnimate-layout pose-CNN file (seeded) and its trees."""
    dw = tcond.init_dwpose_params(seed=50, device="cpu")
    rr = tcond.init_randomref_params(seed=51, device="cpu")
    torch.save(tcond.export_pose_state_dict(dw, rr), path)


def _trainer_config(tmp_path, **kw):
    pose = str(tmp_path / "pose.pt")
    if not os.path.exists(pose):
        _pose_weights(pose)
    base = {"denoising_step_list": [1000, 500], "num_train_timestep": 1000,
            "timestep_shift": 5.0, "guidance_scale": 3.0,
            "denoising_loss_type": "flow", "num_frame_per_block": 1,
            "num_training_frames": 2, "same_step_across_blocks": True,
            "ts_schedule": True, "context_noise": 0, "lr": 1e-3,
            "weight_decay": 0.01, "dfake_gen_update_ratio": 2,
            "ema_weight": 0.0, "seed": 3,
            "image_or_video_shape": [B, 2, C, H, W],
            "use_pose_conditioning": True, "pose_drop_prob": 0.5,
            "pose_weights_path": pose}
    base.update(kw)
    return JConfig(dict(base)), TConfig(dict(base))


def _pose_batch(seed, nb, F, image=True):
    rng = np.random.default_rng(seed)
    out = {"dwpose_data": rng.integers(0, 256, (nb, 3, 4 * F - 3, 8 * H,
                                                8 * W), dtype=np.uint8),
           "random_ref_dwpose": rng.integers(0, 256, (nb, 8 * H, 8 * W, 3),
                                             dtype=np.uint8)}
    if image:
        out["first_frame"] = rng.integers(0, 256, (nb, 48, 40, 3),
                                          dtype=np.uint8)
    return out


def _encoders():
    cp = _jax_layout(tclip.init_vision_params(T_CLIP, seed=3, device="cpu"))
    jvp, tvp = _vae()
    return (dict(vae_params=jvp, vae_cfg=J_VAE, clip_params=cp,
                 clip_cfg=J_CLIP),
            dict(vae_params=tvp, vae_cfg=tinf.TINY_VAE,
                 clip_params=params_from_jax(cp, "clip", device="cpu"),
                 clip_cfg=T_CLIP))


def _trainers(tmp_path, setup="i2v", encoders=True, **kw):
    jconfig, tconfig = _trainer_config(tmp_path, **kw)
    gcfg, scfg = SETUPS[setup]
    jgen, jfake, jreal = _models(setup)
    ctx, neg = _text(60)
    jenc, tenc = _encoders() if encoders else ({}, {})
    jtr = JTrainer(jconfig, jgen, jfake, jreal, gcfg, scfg, scfg, neg,
                   **jenc)
    ttr = TTrainer(tconfig, _tp(jgen), _tp(jfake), _tp(jreal), _tcfg(gcfg),
                   _tcfg(scfg), _tcfg(scfg), _t(neg), device="cpu", **tenc)
    return jtr, ttr, ctx


def test_pose_trainer_conditioning_matches_jax(tmp_path):
    """The trainers' conditioners (the pose CNNs read from one UniAnimate
    file, CLIP and the VAE given) on one batch of 2: pose tokens, CLIP
    tokens, y; the port takes JAX's keep mask, drawn from the host RNG's
    first integer in both."""
    jtr, ttr, ctx = _trainers(tmp_path)
    batch = _pose_batch(61, 2, 2)
    shape = [2, 2, C, H, W]
    seed = int(np.random.default_rng(3).integers(2 ** 31))
    keep = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5,
                                           (2,)))
    jout = jtr._build_cond(batch, shape)
    tout = ttr._build_cond(batch, shape, keep=_t(keep))
    assert set(tout) == set(jout) == {"add_condition", "clip_fea", "y"}
    for k in jout:
        a, b = tout[k].numpy().astype(np.float64), np.asarray(jout[k])
        assert a.shape == b.shape, k
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), k
    assert jtr.host_rng.integers(2 ** 31) == ttr.host_rng.integers(2 ** 31)
    assert ttr._build_cond({"context": ctx}, shape) is None


def _record_draws(trainer, out):
    """Wrap the trainer's rollout-length and exit draws to append them to
    ``out``."""
    shape_fn = trainer._sample_rollout_shape
    pipe = trainer.bundle.pipeline
    exit_fn = pipe.sample_exit_index

    def shape(base):
        s = shape_fn(base)
        out.append(("frames", s[1]))
        return s

    def exits(rng, num_blocks=None):
        e = exit_fn(rng, num_blocks=num_blocks)
        out.append(("exit", np.asarray(e).tolist()))
        return e
    trainer._sample_rollout_shape = shape
    pipe.sample_exit_index = exits


@pytest.mark.parametrize("same_step", [True, False])
def test_pose_trainer_draws_match_jax(tmp_path, same_step):
    """Six steps of each trainer with the updates stubbed out (the JAX
    trainer's jitted steps return their inputs, the port's losses are
    zero): the conditioning's draw comes before the rollout length, so
    the rollout lengths (21 or 24 frames) and exits stay JAX's."""
    jtr, ttr, ctx = _trainers(
        tmp_path, setup="pose", encoders=False, num_frame_per_block=3,
        num_training_frames=24, image_or_video_shape=[B, 24, C, H, W],
        same_step_across_blocks=same_step)
    jdraws, tdraws = [], []
    _record_draws(jtr, jdraws)
    _record_draws(ttr, tdraws)

    def gen_stub(key):
        return lambda g, f, r, o, *a: (g, o, {})

    def critic_stub(key):
        return lambda g, f, o, *a: (f, o, {})
    jtr._make_gen_step, jtr._make_critic_step = gen_stub, critic_stub

    def zero(*a, **k):
        return ttr.fake_leaves[0].sum() * 0 + ttr.gen_leaves[0].sum() * 0, {}
    ttr._generator_loss = zero
    batch = {"context": ctx, **_pose_batch(62, 1, 24, image=False)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdmd, "critic_loss", zero)
        for _ in range(6):
            jtr.train_step(batch)
            ttr.train_step({"context": _t(ctx), **batch})
    assert tdraws == jdraws
    frames = {v for k, v in jdraws if k == "frames"}
    assert frames == {21, 24}


def test_pose_trainer_step(tmp_path):
    """One real step of the i2v pose trainer (the generator and the
    critic update) with a LoRA file at lora_path: its log keys are the
    JAX trainer's (traced with jax.eval_shape), every value finite, the
    LoRA and pose_proj leaves move."""
    lora_file = str(tmp_path / "lora.pt")
    gcfg = SETUPS["i2v"][0]
    rng = np.random.default_rng(63)
    sd = {}
    for i in range(gcfg.num_layers):
        for name, (din, dout) in (("self_attn.q", (gcfg.dim, gcfg.dim)),
                                  ("ffn.0", (gcfg.dim, gcfg.ffn_dim))):
            sd[f"blocks.{i}.{name}.lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((4, din)).astype(np.float32))
            sd[f"blocks.{i}.{name}.lora_B.weight"] = torch.from_numpy(
                0.1 * rng.standard_normal((dout, 4)).astype(np.float32))
    torch.save(sd, lora_file)
    jtr, ttr, ctx = _trainers(tmp_path, lora_rank=4, lora_alpha=4,
                              lora_path=lora_file, pose_drop_prob=0.1)
    qa = ttr.state.generator["blocks"]["self_attn"]["q"]["lora_A"]
    np.testing.assert_array_equal(
        qa[0].detach().numpy(), sd["blocks.0.self_attn.q.lora_A.weight"].T)
    before = {p: t.detach().clone() for p, t in tree.items(
        ttr.state.generator)}
    log = ttr.train_step({"context": _t(ctx), **_pose_batch(64, 1, 2)})
    st = jtr.state
    cond = jax.eval_shape(lambda: jtr._build_cond(_pose_batch(64, 1, 2),
                                                  [B, 2, C, H, W]))
    noise = jax.ShapeDtypeStruct((B, 2, C, H, W), jnp.float32)
    _, _, glog = jax.eval_shape(
        jtr._make_gen_step(1), st.generator, st.fake_score, jtr.real_params,
        st.gen_opt_state, noise, ctx, jtr.neg_context,
        jax.random.PRNGKey(0), None, cond)
    _, _, clog = jax.eval_shape(
        jtr._make_critic_step(1), st.generator, st.fake_score,
        st.critic_opt_state, noise, ctx, jtr.neg_context,
        jax.random.PRNGKey(0), None, cond)
    assert set(log) == set(glog) | set(clog)
    assert all(np.isfinite(v) for v in log.values()), log
    moved = {p for p, t in tree.items(ttr.state.generator)
             if not torch.equal(before[p], t.detach())}
    assert any("pose_proj" in p for p in moved)
    assert any("lora_A" in p for p in moved)
    assert any("lora_B" in p for p in moved)


# ---------------------------------------------------------------- LoRA

@pytest.mark.parametrize("fmt", ["native", "diffusers", "diffusers_down_up",
                                 "peft", "diffusion_model"])
def test_load_lora_weights_matches_jax(fmt):
    """Every target of a 2-layer tree from a state dict in one key format
    (layer 1 lacks the cross-attention k adapter, which stays zero
    there), alpha 8 over rank 4: the port's tree equals JAX's, the
    self-attention q / k lora_B columns in the RoPE half order."""
    cfg = dataclasses.replace(J_TINY, num_layers=2)
    jp = _jax_layout(tdit.init_params(_tcfg(cfg), seed=70,
                                      dtype=torch.float32, device="cpu"))
    rng = np.random.default_rng(71)
    dims = {"q": (cfg.dim, cfg.dim), "k": (cfg.dim, cfg.dim),
            "v": (cfg.dim, cfg.dim), "o": (cfg.dim, cfg.dim),
            "ffn.0": (cfg.dim, cfg.ffn_dim), "ffn.2": (cfg.ffn_dim, cfg.dim)}
    names = {"native": ("lora_A.weight", "lora_B.weight"),
             "diffusers": ("lora_A.default.weight", "lora_B.default.weight"),
             "diffusers_down_up": ("lora.down.weight", "lora.up.weight"),
             "peft": ("lora_A.weight", "lora_B.weight"),
             "diffusion_model": ("lora_A.weight", "lora_B.weight")}[fmt]
    prefix = {"peft": "base_model.model.",
              "diffusion_model": "diffusion_model."}.get(fmt, "")
    sd = {}
    for i in range(2):
        for mod in ("self_attn.", "cross_attn.", ""):
            for proj, (din, dout) in dims.items():
                if (mod == "") != proj.startswith("ffn") or (
                        i == 1 and mod == "cross_attn." and proj == "k"):
                    continue
                key = f"{prefix}blocks.{i}.{mod}{proj}."
                sd[key + names[0]] = torch.from_numpy(
                    rng.standard_normal((4, din)).astype(np.float32))
                sd[key + names[1]] = torch.from_numpy(
                    rng.standard_normal((dout, 4)).astype(np.float32))
    sd["blocks.0.self_attn.norm_q.weight"] = torch.ones(cfg.dim)
    want = jlora.load_lora_weights(jp, sd, alpha=8.0,
                                   head_dim=cfg.head_dim)
    got = tlora.load_lora_weights(params_from_jax(jp, "dit", device="cpu"),
                                  sd, alpha=8.0, head_dim=cfg.head_dim)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_w = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
              for p, v in flat_w.items()}
    flat_g = dict(tree.items(got))
    assert set(flat_g) == set(flat_w)
    for p, v in flat_g.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flat_w[p]),
                                      err_msg=str(p))
    k1 = got["blocks"]["cross_attn"]["k"]["lora_B"][1]
    assert not k1.any() and got["blocks"]["cross_attn"]["k"]["lora_B"][0].any()
    assert float(got["blocks"]["ffn"]["fc1"]["lora_scale"][0]) == 2.0
    with pytest.raises(ValueError, match="no LoRA weights"):
        tlora.load_lora_weights(got, {"blocks.0.norm.weight": torch.ones(2)})
