"""The port's ODE-regression, causal-diffusion, CausVid and SiD objectives
and their trainers against the JAX package on the CPU (float32, WAN_TINY,
every parameter leaf perturbed so that the zero-initialised output layer
takes part), with the JAX package's draws injected:

- ``ode_regression.generator_loss``: value, logs and the generator's
  gradient, for a trajectory of as many snapshots as steps, of one more
  (the snapshot index past the step list: JAX's gather clamps it, and so
  does the port) and for i2v (the first frame's index is the last);
- ``causal_diffusion.generator_loss``: teacher forcing with and without
  noise augmentation, and the block-causal branch;
- ``causvid`` and ``sid``: the generator and the critic loss;
- two ``train_step``s of ``ODETrainer`` and ``DiffusionTrainer`` against
  the JAX trainers (loss, grad_norm, the timestep-bucket keys), and of
  the SiD ``ScoreDistillationTrainer`` (its log keys against the JAX
  trainer's, traced with ``jax.eval_shape``);
- ``self_forcing_tpu_torch.train.main`` on tiny copies of the four
  configs, two steps each (the ODE and the shard data written by the
  port's ``RecordWriter``).

Tolerances: 1e-4 on values (float32, sums in another order); gradients
1e-4 relative to each leaf's largest entry; the trainers' logs 1e-3
relative and the parameters after two AdamW updates 2e-5 absolute (Adam
moves an element by a share of lr whatever its gradient's size, so a
near-zero gradient's rounding shows at that scale).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from self_forcing_tpu.config import load_config as jload_config
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.scheduler import FlowMatchScheduler as JSched
from self_forcing_tpu.scheduler import warp_denoising_steps
from self_forcing_tpu.training.objectives import causal_diffusion as jcd
from self_forcing_tpu.training.objectives import causvid as jcv
from self_forcing_tpu.training.objectives import ode_regression as jode
from self_forcing_tpu.training.objectives import sid as jsid
from self_forcing_tpu.training.objectives.base import (
    ModelBundle as JBundle, ObjectiveConfig as JObj,
    sample_timestep_per_block as jspb)
from self_forcing_tpu.training.trainer_diffusion import (
    DiffusionTrainer as JDiffusionTrainer)
from self_forcing_tpu.training.trainer_distillation import (
    ScoreDistillationTrainer as JSDTrainer)
from self_forcing_tpu.training.trainer_ode import ODETrainer as JODETrainer
from self_forcing_tpu_torch import train
from self_forcing_tpu_torch.config import load_config
from self_forcing_tpu_torch.data.recordstore import (RecordWriter,
                                                     store_arrays,
                                                     write_shape_header)
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler as TSched
from self_forcing_tpu_torch.training.objectives import causal_diffusion as tcd
from self_forcing_tpu_torch.training.objectives import causvid as tcv
from self_forcing_tpu_torch.training.objectives import ode_regression as tode
from self_forcing_tpu_torch.training.objectives import sid as tsid
from self_forcing_tpu_torch.training.objectives.base import (
    ModelBundle as TBundle, ObjectiveConfig as TObj)
from self_forcing_tpu_torch.training.trainer_diffusion import DiffusionTrainer
from self_forcing_tpu_torch.training.trainer_distillation import (
    ScoreDistillationTrainer)
from self_forcing_tpu_torch.training.trainer_ode import ODETrainer
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
CONFIGS = os.path.join(REPO, "configs")
TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
FR = 3
STEPS = [1000.0, 500.0]


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


def _np(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(
        a, torch.Tensor) else a), np.asarray(b), rtol=tol, atol=tol)


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
    key = jax.random.PRNGKey(0)
    gen = _perturbed(jdit.init_params(key, J_TINY, dtype=jnp.float32), 1)
    fake = _perturbed(jdit.init_params(jax.random.fold_in(key, 1), J_TINY,
                                       dtype=jnp.float32, causal=False), 2)
    real = _perturbed(jdit.init_params(jax.random.fold_in(key, 2), J_TINY,
                                       dtype=jnp.float32, causal=False), 3)
    rng = np.random.default_rng(4)
    ctx, neg = (rng.standard_normal((B, 8, WAN_TINY.text_dim)).astype(
        np.float32) for _ in range(2))
    return dict(gen=gen, fake=fake, real=real, ctx=ctx, neg=neg)


def _scheds():
    return (JSched.create(1000, shift=5.0, training=True),
            TSched.create(1000, shift=5.0, training=True, device="cpu"))


def _ropes():
    return (JRope.create(J_TINY.head_dim),
            TRope.create(WAN_TINY.head_dim, device="cpu"))


# --------------------------------------------------- ODE regression

def test_ode_step_gather_clamps_like_jax():
    """An index past the step list takes its last entry in both
    packages."""
    steps = [1000.0, 937.5, 833.3, 625.0]
    idx = np.array([[0, 3, 4, 5]], np.int32)
    np.testing.assert_array_equal(
        tode.gather_steps(steps, torch.from_numpy(idx)).numpy(),
        np.asarray(jnp.asarray(steps, jnp.float32)[idx]))


@pytest.mark.parametrize("case", ["in_range", "past_the_list", "i2v"])
def test_ode_regression_loss_matches_jax(models, case):
    """Value, logs (per-sample loss, timestep, input, output) and the
    generator's gradient, with warped steps [1000, 750, 500, 250] (4) and
    4 or 5 snapshots; 'past_the_list' uses a draw that picks snapshot 4,
    'i2v' always does for the first frame."""
    js, ts = _scheds()
    jr, tr = _ropes()
    steps = [float(s) for s in warp_denoising_steps(js, [1000, 750, 500,
                                                         250])]
    T = 4 if case == "in_range" else 5
    rng = np.random.default_rng(5)
    ode = rng.standard_normal((B, T, FR, C, H, W)).astype(np.float32)
    key = None
    for k in range(50):
        cand = jax.random.PRNGKey(k)
        idx = np.asarray(jspb(cand, 0, T, B, FR, 1))
        if case != "past_the_list" or idx.max() == T - 1:
            key = cand
            break
    i2v = case == "i2v"
    (lj, logj), gj = jax.value_and_grad(
        lambda p: jode.generator_loss(p, J_TINY, jr, js, ode, models["ctx"],
                                      steps, 1, key, i2v), has_aux=True)(
        models["gen"])
    pt = _with_grad(_t(models["gen"]))
    lt, logt = tode.generator_loss(
        pt, WAN_TINY, tr, ts, torch.from_numpy(ode),
        torch.from_numpy(models["ctx"]), steps, 1, i2v=i2v,
        draws={"idx": _np(idx)})
    if case != "in_range":
        assert int(idx.max()) >= len(steps) or i2v
    _close(lt, lj)
    assert set(logt) == set(logj)
    for k in logj:
        _close(logt[k], logj[k])
    _grads_close(lt, pt, gj)


# ------------------------------------------------- causal diffusion

@pytest.mark.parametrize("case", ["teacher_forcing", "teacher_forcing_aug",
                                  "block_causal"])
def test_causal_diffusion_loss_matches_jax(models, case):
    """Value, logs and the generator's gradient (blocks of 1 frame)."""
    js, ts = _scheds()
    jr, tr = _ropes()
    rng = np.random.default_rng(6)
    clean = rng.standard_normal((B, FR, C, H, W)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(teacher_forcing=case != "block_causal",
              noise_augmentation_max_timestep=300 if case.endswith("aug")
              else 0)
    (lj, logj), gj = jax.value_and_grad(
        lambda p: jcd.generator_loss(p, J_TINY, jr, js, clean,
                                     models["ctx"], 1, key, **kw),
        has_aux=True)(models["gen"])
    rng_t, rng_n, rng_aug = jax.random.split(key, 3)
    draws = {"idx": _np(jspb(rng_t, 0, 1000, B, FR, 1)),
             "noise": _np(jax.random.normal(rng_n, clean.shape)),
             "aug_idx": _np(jspb(rng_aug, 0, 300, B, FR, 1))}
    pt = _with_grad(_t(models["gen"]))
    lt, logt = tcd.generator_loss(pt, WAN_TINY, tr, ts,
                                  torch.from_numpy(clean),
                                  torch.from_numpy(models["ctx"]), 1,
                                  draws=draws, **kw)
    _close(lt, lj)
    assert set(logt) == set(logj)
    for k in logj:
        _close(logt[k], logj[k])
    _grads_close(lt, pt, gj)


# ------------------------------------------------------ CausVid, SiD

def _bundles(nb=1, frames=2):
    kw = dict(num_frame_per_block=nb, num_training_frames=frames,
              timestep_shift=5.0)
    jobj, tobj = JObj(**kw), TObj(**kw)
    jb = JBundle.create(dataclasses.replace(J_TINY, num_frame_per_block=nb),
                        J_TINY, J_TINY, jobj, STEPS)
    tb = TBundle.create(dataclasses.replace(WAN_TINY,
                                            num_frame_per_block=nb),
                        WAN_TINY, WAN_TINY, tobj, STEPS, device="cpu")
    return jobj, tobj, jb, tb


def _t_draw(rng_t, lo):
    return _np(jax.random.randint(rng_t, (B, 1), int(lo), 1000))


@pytest.mark.parametrize("which", ["generator", "critic"])
def test_causvid_loss_matches_jax(models, which):
    """The one-step generator (block-causal) with the DMD loss, and the
    critic's denoising loss on its no-grad prediction: value and the
    trained model's gradient."""
    jobj, tobj, jb, tb = _bundles()
    rng = np.random.default_rng(8)
    clean = rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    args_t = [torch.from_numpy(a) for a in (clean, models["ctx"],
                                            models["neg"])]
    if which == "generator":
        (lj, logj), gj = jax.value_and_grad(
            lambda p: jcv.generator_loss(jb, jobj, p, models["fake"],
                                         models["real"], clean,
                                         models["ctx"], models["neg"], key),
            has_aux=True)(models["gen"])
        rng_gen, rng_dmd = jax.random.split(key)
        rng_t, rng_n = jax.random.split(rng_dmd)
    else:
        (lj, logj), gj = jax.value_and_grad(
            lambda p: jcv.critic_loss(jb, jobj, models["gen"], p, clean,
                                      models["ctx"], models["neg"], key),
            has_aux=True)(models["fake"])
        rng_gen, rng_t, rng_n = jax.random.split(key, 3)
    rng_i, rng_gn = jax.random.split(rng_gen)
    draws = {"idx": _np(jspb(rng_i, 0, len(STEPS), B, 2, 1)),
             "gen_noise": _np(jax.random.normal(rng_gn, clean.shape)),
             "t": _t_draw(rng_t, jobj.min_score_timestep),
             "noise": _np(jax.random.normal(rng_n, clean.shape))}
    if which == "generator":
        pt = _with_grad(_t(models["gen"]))
        lt, logt = tcv.generator_loss(tb, tobj, pt, _t(models["fake"]),
                                      _t(models["real"]), *args_t,
                                      draws=draws)
    else:
        pt = _with_grad(_t(models["fake"]))
        lt, logt = tcv.critic_loss(tb, tobj, _t(models["gen"]), pt, *args_t,
                                   draws=draws)
    _close(lt, lj)
    for k in logj:
        _close(logt[k], logj[k])
    _grads_close(lt, pt, gj)


@pytest.mark.parametrize("which", ["generator", "critic"])
def test_sid_loss_matches_jax(models, which):
    """SiD's generator loss (rollout with gradient, score forwards not
    detached, CFG 3.0, alpha 0.7) and its critic loss: value, logs and
    the trained model's gradient."""
    kw = dict(num_frame_per_block=1, num_training_frames=2,
              timestep_shift=5.0, sid_alpha=0.7)
    jobj, tobj = JObj(**kw), TObj(**kw)
    _, _, jb, tb = _bundles()
    rng = np.random.default_rng(10)
    noise = rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
    key, exit_idx = jax.random.PRNGKey(11), 1
    args_t = [torch.from_numpy(a) for a in (noise, models["ctx"],
                                            models["neg"])]
    if which == "generator":
        (lj, logj), gj = jax.value_and_grad(
            lambda p: jsid.generator_loss(
                jb, jobj, p, models["fake"], models["real"], noise,
                models["ctx"], models["neg"], exit_idx, key),
            has_aux=True)(models["gen"])
        rng_roll, rng_sid = jax.random.split(key)
        rng_t, rng_n = jax.random.split(rng_sid)
        lo = jb.pipeline.denoised_timestep_bounds(exit_idx)[1]
    else:
        (lj, logj), gj = jax.value_and_grad(
            lambda p: jsid.critic_loss(
                jb, jobj, models["gen"], p, noise, models["ctx"],
                models["neg"], exit_idx, key), has_aux=True)(models["fake"])
        rng_roll, rng_t, rng_n = jax.random.split(key, 3)
        lo = jb.pipeline.denoised_timestep_bounds(exit_idx)[1]
    draws = {"eps": _jax_rollout_eps(rng_roll, [exit_idx] * 2,
                                     (B, 1, C, H, W)),
             "t": _t_draw(rng_t, lo),
             "noise": _np(jax.random.normal(rng_n, noise.shape))}
    if which == "generator":
        pt = _with_grad(_t(models["gen"]))
        fake, real = _with_grad(_t(models["fake"])), _t(models["real"])
        lt, logt = tsid.generator_loss(tb, tobj, pt, fake, real, *args_t,
                                       exit_idx, draws=draws)
        # the score models get no gradient from the generator loss
        assert all(g is None for g in torch.autograd.grad(
            lt, tree.leaves(fake), allow_unused=True, retain_graph=True))
    else:
        pt = _with_grad(_t(models["fake"]))
        lt, logt = tsid.critic_loss(tb, tobj, _t(models["gen"]), pt, *args_t,
                                    exit_idx, draws=draws)
    _close(lt, lj)
    assert set(logt) == set(logj)
    for k in logj:
        _close(logt[k], logj[k])
    _grads_close(lt, pt, gj)


# ---------------------------------------------------------- trainers

def _config(name, **kw):
    config = load_config(os.path.join(CONFIGS, name),
                         os.path.join(CONFIGS, "default_config.yaml"))
    jconfig = jload_config(os.path.join(CONFIGS, name),
                           os.path.join(CONFIGS, "default_config.yaml"))
    for c in (config, jconfig):
        c.update(seed=3, lr=1e-3, **kw)
    return config, jconfig


@pytest.mark.parametrize("kind", ["ode", "diffusion"])
def test_single_model_trainer_two_steps_match_jax(models, kind):
    """Two steps of the ODE (4 warped steps, 5 snapshots, blocks of 3)
    and the diffusion (teacher forcing) trainer with the JAX trainer's
    draws: loss, grad_norm and the other log entries, the bucket keys
    included, and the generator after the second update."""
    rng = np.random.default_rng(12)
    if kind == "ode":
        config, jconfig = _config("ode_init.yaml", num_frame_per_block=3)
        data = rng.standard_normal((B, 5, FR, C, H, W)).astype(np.float32)
        batch_j = {"ode_latent": data, "context": models["ctx"]}
        jtr = JODETrainer(jconfig, models["gen"], J_TINY, visualize=False)
        ttr = ODETrainer(config, _t(models["gen"]), WAN_TINY,
                         visualize=True, device="cpu")
        key_name = "ode_latent"
    else:
        config, jconfig = _config("causal_diffusion.yaml",
                                  num_frame_per_block=1)
        data = rng.standard_normal((B, FR, C, H, W)).astype(np.float32)
        batch_j = {"latents": data, "context": models["ctx"]}
        jtr = JDiffusionTrainer(jconfig, models["gen"], J_TINY)
        ttr = DiffusionTrainer(config, _t(models["gen"]), WAN_TINY,
                               device="cpu")
        key_name = "latents"
    seeds = np.random.default_rng(3)
    batch_t = {key_name: torch.from_numpy(data),
               "context": torch.from_numpy(models["ctx"])}
    for _ in range(2):
        key = jax.random.PRNGKey(int(seeds.integers(2 ** 31)))
        if kind == "ode":
            draws = {"idx": _np(jspb(key, 0, 5, B, FR, 3))}
        else:
            rng_t, rng_n, _ = jax.random.split(key, 3)
            draws = {"idx": _np(jspb(rng_t, 0, 1000, B, FR, 1)),
                     "noise": _np(jax.random.normal(rng_n, data.shape))}
        log_j = jtr.train_step(batch_j)
        log_t = ttr.train_step(batch_t, draws=draws)
        assert set(log_t) == set(log_j)
        for k in log_j:
            np.testing.assert_allclose(log_t[k], log_j[k], rtol=1e-3,
                                       atol=1e-5, err_msg=k)
    if kind == "ode":
        assert any(k.startswith("loss_bucket_") for k in log_t)
        assert ttr.last_visual["output"].shape == (B, FR, C, H, W)
    assert ttr.step == 2 and ttr.ema is not None
    # Adam moves an element by ~lr * m / sqrt(v) whatever its gradient's
    # size, so a near-zero gradient's rounding can move it by a share of
    # lr (1e-3): the parameters agree within 2% of lr (measured 1.2e-5)
    for a, b in zip(ttr.leaves, jax.tree.leaves(jtr.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=2e-5)


def test_sid_trainer_two_steps(models):
    """The SiD ScoreDistillationTrainer: step 0 updates the generator and
    the critic, step 1 the critic; its log keys are the JAX trainer's
    (traced with jax.eval_shape); every value finite, both models
    move."""
    config, jconfig = _config("tiny_test.yaml", distribution_loss="sid",
                              dfake_gen_update_ratio=2,
                              image_or_video_shape=[B, 2, C, H, W],
                              num_training_frames=2)
    tp = [_t(models[k]) for k in ("gen", "fake", "real")]
    ctx = torch.from_numpy(models["ctx"])
    trainer = ScoreDistillationTrainer(config, *tp, WAN_TINY, WAN_TINY,
                                       WAN_TINY, ctx.clone(), device="cpu")
    assert trainer.objective == "sid"
    before = [t.detach().clone() for t in trainer.gen_leaves
              + trainer.fake_leaves]
    logs = [trainer.train_step({"context": ctx}) for _ in range(2)]

    jtr = JSDTrainer(jconfig, models["gen"], models["fake"], models["real"],
                     J_TINY, J_TINY, J_TINY, models["neg"])
    exit_idx = jtr.bundle.pipeline.sample_exit_index(
        np.random.default_rng(0))
    noise = jax.ShapeDtypeStruct((B, 2, C, H, W), jnp.float32)
    st = jtr.state
    _, _, glog = jax.eval_shape(
        jtr._make_gen_step(exit_idx), st.generator, st.fake_score,
        jtr.real_params, st.gen_opt_state, noise, models["ctx"],
        models["neg"], jax.random.PRNGKey(0))
    _, _, clog = jax.eval_shape(
        jtr._make_critic_step(exit_idx), st.generator, st.fake_score,
        st.critic_opt_state, noise, models["ctx"], models["neg"],
        jax.random.PRNGKey(0))
    assert set(logs[0]) == set(glog) | set(clog)
    assert set(logs[1]) == set(clog)
    for log in logs:
        assert all(np.isfinite(v) for v in log.values()), log
    moved = [not torch.equal(a, b.detach()) for a, b in zip(
        before, trainer.gen_leaves + trainer.fake_leaves)]
    n_gen = len(trainer.gen_leaves)
    assert any(moved[:n_gen]) and any(moved[n_gen:])


# --------------------------------------------------------------- CLI

def _write_shards(d):
    """An ODE shard (2 rows [5, 3, 16, 8, 8] fp16) and a directory of two
    latent shards and a stray file, through the port's writer."""
    rng = np.random.default_rng(13)
    with RecordWriter(os.path.join(d, "ode.rs")) as w:
        lat = rng.standard_normal((2, 5, FR, C, H, W)).astype(np.float16)
        store_arrays(w, {"latents": lat, "prompts": ["a cat", "a dog"]})
        write_shape_header(w, "latents", lat.shape)
    os.makedirs(os.path.join(d, "shards"))
    for s in range(2):
        with RecordWriter(os.path.join(d, "shards", f"{s}.rs")) as w:
            lat = rng.standard_normal((2, FR, C, H, W)).astype(np.float16)
            store_arrays(w, {"latents": lat, "prompts": ["x", "y"]})
            write_shape_header(w, "latents", lat.shape)
    with open(os.path.join(d, "shards", "README"), "w") as f:
        f.write("not a shard")


@pytest.mark.parametrize("name", ["ode_init", "causal_diffusion",
                                  "self_forcing_gan", "self_forcing_sid"])
def test_train_cli_runs_each_config(tmp_path, name):
    """``train.main`` on a tiny copy of the config (WAN_TINY, 3 frames of
    8x8 latents): two steps with finite logs in metrics.jsonl and the
    final checkpoint, its trainer's keys."""
    _write_shards(str(tmp_path))
    with open(os.path.join(CONFIGS, f"{name}.yaml")) as f:
        c = yaml.safe_load(f)
    c.update(model_size="tiny", image_or_video_shape=[B, FR, C, H, W],
             num_training_frames=FR)
    c.pop("generator_ckpt", None)
    if name == "ode_init":
        c["data_path"] = str(tmp_path / "ode.rs")
    elif name == "self_forcing_sid":
        c.update(num_frame_per_block=1, dfake_gen_update_ratio=1,
                 data_path=os.path.join(REPO, "prompts", "test_prompts.txt"))
    else:
        c.update(num_frame_per_block=1, data_path=str(tmp_path / "shards"))
    cfg_path = tmp_path / f"{name}.yaml"
    cfg_path.write_text(yaml.safe_dump(c))
    logdir = tmp_path / "log"
    train.main(["--config_path", str(cfg_path), "--max_steps", "2",
                "--device", "cpu", "--logdir", str(logdir)])
    lines = [json.loads(ln) for ln in
             (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    for ln in lines:
        assert all(np.isfinite(v) for v in ln.values()), ln
    want = {"ode_init": "loss", "causal_diffusion": "x0_pred_mse",
            "self_forcing_gan": "gan_d_loss",
            "self_forcing_sid": "generator_loss"}[name]
    assert want in lines[0]
    saved = torch.load(logdir / "final.pt", weights_only=True)
    assert "generator" in saved
    if name == "self_forcing_gan":
        assert {"critic", "critic_cls"} <= set(saved)


def test_train_cli_ode_without_shard_names_data_path(tmp_path):
    c = {"trainer": "ode", "model_size": "tiny",
         "data_path": str(tmp_path / "missing.rs"),
         "denoising_step_list": [1000]}
    cfg_path = tmp_path / "ode.yaml"
    cfg_path.write_text(yaml.safe_dump(c))
    with pytest.raises(FileNotFoundError, match="missing.rs"):
        train.main(["--config_path", str(cfg_path), "--max_steps", "1",
                    "--device", "cpu", "--logdir", str(tmp_path / "log")])
