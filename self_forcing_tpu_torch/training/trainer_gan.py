"""The GAN distillation trainer (port of
``self_forcing_tpu/training/trainer_gan.py``).

Alternating updates: the generator every ``dfake_gen_update_ratio``
steps once the ``discriminator_warmup_steps`` are over, the critic (the
fake score backbone) and its GAN head every step.  Three AdamWs: the
generator's, the critic's and the head's, whose learning rate is
``lr_critic * discriminator_lr_multiplier``.  R1 / R2 penalties, an
optional generator EMA, and checkpoints with the {generator, critic,
critic_cls, generator_ema} layout; ``load_state`` can start from the
EMA weights (``force_start_w_ema``) and restart the step count
(``force_reset_zero_step``).

``train_step`` takes {'context': [B, L, text_dim], 'latents': real clean
latents [B, F, C, H, W]}.  The exit steps come from the host numpy RNG
(the config's seed), and each update's draws from a ``torch.Generator``
seeded by it.  ``mesh``: the generator, the critic and its GAN head are
ZeRO-3 slices (``parallel/fsdp.py``) and the batch is split as in the
distillation trainer (``trainer_distillation.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.scheduler import warp_denoising_steps
from self_forcing_tpu_torch.training import ema as ema_lib
from self_forcing_tpu_torch.training.objectives import gan as gan_obj
from self_forcing_tpu_torch.training.objectives.base import (ModelBundle,
                                                            ObjectiveConfig)
from self_forcing_tpu_torch.training.optim import AdamW
from self_forcing_tpu_torch.parallel import fsdp
from self_forcing_tpu_torch.training.trainer_distillation import (
    TrainedModel, _copy_leaves, _like_opt, _Marks, batch_split, grads_of,
    local_rows, mean_log, min_param_size)
from self_forcing_tpu_torch.utils import tree
from self_forcing_tpu_torch.utils.draws import split_generator
from self_forcing_tpu_torch.utils.checkpoints import (restore_pytree,
                                                      save_pytree)


class GANTrainer:
    def __init__(self, config, generator_params, fake_params,
                 generator_cfg: WanConfig, critic_cfg: WanConfig,
                 cls_params=None, device: str | torch.device = "cuda",
                 timing: bool = False, mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = torch.device(device)
        self.timing = timing
        obj = ObjectiveConfig(
            num_train_timestep=int(getattr(config, "num_train_timestep",
                                           1000)),
            timestep_shift=float(getattr(config, "timestep_shift", 1.0)),
            ts_schedule=bool(getattr(config, "ts_schedule", True)),
            ts_schedule_max=bool(getattr(config, "ts_schedule_max", False)),
            min_score_timestep=int(getattr(config, "min_score_timestep", 0)),
            num_frame_per_block=int(getattr(config, "num_frame_per_block",
                                            1)),
            same_step_across_blocks=bool(
                getattr(config, "same_step_across_blocks", True)),
            num_training_frames=int(getattr(config, "num_training_frames",
                                            21)),
            context_noise=float(getattr(config, "context_noise", 0)),
        )
        self.obj = obj
        gen_cfg = dataclasses.replace(
            generator_cfg, num_frame_per_block=obj.num_frame_per_block,
            independent_first_frame=bool(
                getattr(config, "independent_first_frame", False)))
        self.bundle = ModelBundle.create(
            gen_cfg, critic_cfg, critic_cfg, obj,
            [int(s) for s in config.denoising_step_list],
            device=self.device)
        if getattr(config, "warp_denoising_step", False):
            warped = warp_denoising_steps(
                self.bundle.scheduler,
                [int(s) for s in config.denoising_step_list])
            self.bundle.pipeline.denoising_step_list = tuple(
                float(s) for s in warped if s != 0)

        self.concat_te = bool(getattr(config, "concat_time_embeddings",
                                      False))
        if cls_params is None:
            cls_params = dit.init_cls_branch_params(
                critic_cfg, int(getattr(config, "seed", 0)) + 7,
                num_class=int(getattr(config, "num_class", 1)),
                time_embed_dim=critic_cfg.dim if self.concat_te else 0,
                device=self.device)
        min_size = min_param_size(config)
        self.gen = TrainedModel(generator_params, mesh, min_size)
        self.fake = TrainedModel(fake_params, mesh, min_size)
        self.cls = TrainedModel(cls_params, mesh, min_size)
        self.generator, self.fake_score = self.gen.tree, self.fake.tree
        self.cls_params = self.cls.tree
        self.gen_leaves = self.gen.leaves
        self.fake_leaves = self.fake.leaves
        self.cls_leaves = self.cls.leaves

        wd = float(getattr(config, "weight_decay", 0.01))
        lr_critic = float(getattr(config, "lr_critic", config.lr))

        def critic_opt(lr):
            return AdamW(lr=lr,
                         beta1=float(getattr(config, "beta1_critic", 0.0)),
                         beta2=float(getattr(config, "beta2_critic", 0.999)),
                         weight_decay=wd,
                         max_grad_norm=float(getattr(
                             config, "max_grad_norm_critic", 10.0)))
        self.gen_optimizer = AdamW(
            lr=float(config.lr), beta1=float(getattr(config, "beta1", 0.0)),
            beta2=float(getattr(config, "beta2", 0.999)), weight_decay=wd,
            max_grad_norm=float(getattr(config, "max_grad_norm_generator",
                                        10.0)))
        self.critic_optimizer = critic_opt(lr_critic)
        self.cls_optimizer = critic_opt(lr_critic * float(getattr(
            config, "discriminator_lr_multiplier", 1.0)))
        self.gen_opt_state = self.gen_optimizer.init(self.gen_leaves)
        self.critic_opt_state = self.critic_optimizer.init(self.fake_leaves)
        self.cls_opt_state = self.cls_optimizer.init(self.cls_leaves)

        self.generator_ema = None
        self.ema_weight = float(getattr(config, "ema_weight", 0.0) or 0.0)
        self.ema_start_step = int(getattr(config, "ema_start_step", 0))
        self.dfake_gen_update_ratio = int(
            getattr(config, "dfake_gen_update_ratio", 1))
        self.discriminator_warmup_steps = int(
            getattr(config, "discriminator_warmup_steps", 0))
        self.gen_kw = dict(
            gan_g_weight=float(getattr(config, "gan_g_weight", 1e-2)),
            relativistic=bool(getattr(config, "relativistic_discriminator",
                                      False)),
            concat_time_embeddings=self.concat_te,
            critic_shift=float(getattr(config, "critic_timestep_shift",
                                       getattr(config, "timestep_shift",
                                               1.0))))
        self.critic_kw = dict(
            gan_d_weight=float(getattr(config, "gan_d_weight", 1e-2)),
            relativistic=self.gen_kw["relativistic"],
            concat_time_embeddings=self.concat_te,
            r1_weight=float(getattr(config, "r1_weight", 0.0)),
            r2_weight=float(getattr(config, "r2_weight", 0.0)),
            r1_sigma=float(getattr(config, "r1_sigma", 0.01)),
            r2_sigma=float(getattr(config, "r2_sigma", 0.01)),
            critic_shift=self.gen_kw["critic_shift"])
        self.step = 0
        self.host_rng = np.random.default_rng(int(getattr(config, "seed",
                                                          0)))

    def _draw(self, shape, split=None, given: dict | None = None):
        """The update's generator and noise (the whole batch's, this
        rank's rows under a split; ``given['noise_in']``, already this
        rank's rows, when given)."""
        g = torch.Generator(device=self.device).manual_seed(
            int(self.host_rng.integers(2 ** 31)))
        if given is not None and "noise_in" in given:
            return split_generator(g, split), \
                given["noise_in"].to(self.device)
        noise = torch.randn(shape, generator=g, device=self.device)
        return split_generator(g, split), local_rows(split, noise)

    def train_step(self, batch: dict, draws: dict | None = None) -> dict:
        """One step: the generator update (outside the warmup, every
        ``dfake_gen_update_ratio`` steps), then the critic's.  ``draws``
        ({'generator': ..., 'critic': ...}, each the objective's draws and
        the update's input ``noise_in``, the whole batch's) replaces the
        updates' draws (the host RNG is drawn all the same)."""
        context, real = batch["context"], batch["latents"]
        log: dict = {}
        in_warmup = self.step < self.discriminator_warmup_steps
        shape = list(real.shape)
        split = batch_split(self.mesh, shape[0])
        context, real = local_rows(split, context), local_rows(split, real)
        draws = {k: tree.map_tree(lambda t: local_rows(split, t), v)
                 for k, v in (draws or {}).items()}
        if not in_warmup and self.step % self.dfake_gen_update_ratio == 0:
            exit_idx = self.bundle.pipeline.sample_exit_index(self.host_rng)
            g, noise = self._draw(shape, split, draws.get("generator"))
            mark = _Marks(self.timing, self.device, "generator", log)
            loss, glog = gan_obj.generator_loss(
                self.bundle, self.obj, self.gen.fwd(), self.fake.fwd(),
                self.cls.fwd(), noise, real, context, None, exit_idx,
                generator=g, draws=draws.get("generator"), **self.gen_kw)
            mark("forward")
            grads, = grads_of(loss, self.gen)
            mark("backward")
            gnorm = self.gen.norm(grads)
            self.gen_opt_state = self.gen_optimizer.update(
                self.gen_leaves, grads, self.gen_opt_state,
                norm_fn=self.gen.norm_fn)
            del grads
            mark("optimizer")
            log.update(mean_log(split, dict(glog, generator_loss=loss)),
                       generator_grad_norm=float(gnorm))
            if self.ema_weight > 0 and self.step >= self.ema_start_step:
                if self.generator_ema is None:
                    self.generator_ema = ema_lib.init_ema(self.generator)
                else:
                    ema_lib.update_ema(self.generator_ema, self.generator,
                                       decay=self.ema_weight)

        exit_idx = self.bundle.pipeline.sample_exit_index(self.host_rng)
        g, noise = self._draw(shape, split, draws.get("critic"))
        mark = _Marks(self.timing, self.device, "critic", log)
        loss, clog = gan_obj.critic_loss(
            self.bundle, self.obj, self.gen.fwd(), self.fake.fwd(),
            self.cls.fwd(), noise, real, context, None, exit_idx,
            generator=g, draws=draws.get("critic"), **self.critic_kw)
        mark("forward")
        gf, gc = grads_of(loss, self.fake, self.cls)
        mark("backward")
        gnorm = self.fake.norm(gf)
        self.critic_opt_state = self.critic_optimizer.update(
            self.fake_leaves, gf, self.critic_opt_state,
            norm_fn=self.fake.norm_fn)
        self.cls_opt_state = self.cls_optimizer.update(
            self.cls_leaves, gc, self.cls_opt_state,
            norm_fn=self.cls.norm_fn)
        del gf, gc
        mark("optimizer")
        log.update(mean_log(split, dict(clog, critic_loss=loss)),
                   critic_grad_norm=float(gnorm))
        self.step += 1
        return log

    # ------------------------------------------------------ checkpoints
    def save(self, path: str) -> None:
        """The weights: generator, critic, critic_cls (and
        generator_ema)."""
        out = {"generator": self.gen.full(), "critic": self.fake.full(),
               "critic_cls": self.cls.full()}
        if self.generator_ema is not None:
            out["generator_ema"] = self.gen.full(self.generator_ema)
        if fsdp.is_main():
            save_pytree(path, out)

    def save_state(self, path: str) -> None:
        """The whole training state, so that the warmup and the update
        ratio (both keyed on the step) carry over a restart (whole trees
        on a mesh: gathered, rank 0 writes)."""
        out = {"generator": self.gen.full(), "critic": self.fake.full(),
               "critic_cls": self.cls.full(),
               "gen_opt_state": self.gen.full_opt(self.gen_opt_state),
               "critic_opt_state": self.fake.full_opt(self.critic_opt_state),
               "cls_opt_state": self.cls.full_opt(self.cls_opt_state),
               "ema": None if self.generator_ema is None
               else self.gen.full(self.generator_ema), "step": self.step}
        if fsdp.is_main():
            save_pytree(path, out)

    def load_state(self, path: str, force_start_w_ema: bool = False,
                   force_reset_zero_step: bool = False) -> None:
        """Restore a :meth:`save_state` file (the parameters in place; on
        a mesh each rank keeps its slices).  ``force_start_w_ema``: the
        live generator takes the checkpoint's EMA weights;
        ``force_reset_zero_step``: the step count restarts at 0, so the
        warmup and the update ratio replay."""
        saved = restore_pytree(path, device=self.device)
        _copy_leaves(self.gen_leaves, self.gen.shard_tree(saved["generator"]))
        _copy_leaves(self.fake_leaves, self.fake.shard_tree(saved["critic"]))
        _copy_leaves(self.cls_leaves, self.cls.shard_tree(
            saved["critic_cls"]))
        self.gen_opt_state = self.gen.shard_opt(
            _like_opt(saved["gen_opt_state"], self.gen_opt_state))
        self.critic_opt_state = self.fake.shard_opt(
            _like_opt(saved["critic_opt_state"], self.critic_opt_state))
        self.cls_opt_state = self.cls.shard_opt(
            _like_opt(saved["cls_opt_state"], self.cls_opt_state))
        self.generator_ema = self.gen.shard_tree(saved["ema"])
        self.step = int(saved["step"])
        if force_start_w_ema:
            if saved["ema"] is None:
                raise ValueError(
                    "force_start_w_ema: the checkpoint carries no EMA state")
            _copy_leaves(self.gen_leaves, ema_lib.ema_to_params(
                self.generator_ema, self.generator))
        if force_reset_zero_step:
            self.step = 0
