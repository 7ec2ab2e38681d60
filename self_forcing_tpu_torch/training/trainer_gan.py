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
seeded by it.
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
from self_forcing_tpu_torch.training.trainer_distillation import (
    _copy_leaves, _Marks, _trainable)
from self_forcing_tpu_torch.utils.checkpoints import (restore_pytree,
                                                      save_pytree)


class GANTrainer:
    def __init__(self, config, generator_params, fake_params,
                 generator_cfg: WanConfig, critic_cfg: WanConfig,
                 cls_params=None, device: str | torch.device = "cuda",
                 timing: bool = False):
        self.config = config
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
        self.generator, self.fake_score = generator_params, fake_params
        self.cls_params = cls_params
        self.gen_leaves = _trainable(generator_params)
        self.fake_leaves = _trainable(fake_params)
        self.cls_leaves = _trainable(cls_params)

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

    def _draw(self, shape):
        g = torch.Generator(device=self.device).manual_seed(
            int(self.host_rng.integers(2 ** 31)))
        return g, torch.randn(shape, generator=g, device=self.device)

    def train_step(self, batch: dict) -> dict:
        """One step: the generator update (outside the warmup, every
        ``dfake_gen_update_ratio`` steps), then the critic's."""
        context, real = batch["context"], batch["latents"]
        log: dict = {}
        in_warmup = self.step < self.discriminator_warmup_steps
        shape = list(real.shape)
        if not in_warmup and self.step % self.dfake_gen_update_ratio == 0:
            exit_idx = self.bundle.pipeline.sample_exit_index(self.host_rng)
            g, noise = self._draw(shape)
            mark = _Marks(self.timing, self.device, "generator", log)
            loss, glog = gan_obj.generator_loss(
                self.bundle, self.obj, self.generator, self.fake_score,
                self.cls_params, noise, real, context, None, exit_idx,
                generator=g, **self.gen_kw)
            mark("forward")
            grads = torch.autograd.grad(loss, self.gen_leaves,
                                        allow_unused=True)
            mark("backward")
            gnorm = AdamW.global_norm(grads)
            self.gen_opt_state = self.gen_optimizer.update(
                self.gen_leaves, grads, self.gen_opt_state)
            del grads
            mark("optimizer")
            log.update({k: float(v) for k, v in glog.items()},
                       generator_loss=float(loss.detach()),
                       generator_grad_norm=float(gnorm))
            if self.ema_weight > 0 and self.step >= self.ema_start_step:
                if self.generator_ema is None:
                    self.generator_ema = ema_lib.init_ema(self.generator)
                else:
                    ema_lib.update_ema(self.generator_ema, self.generator,
                                       decay=self.ema_weight)

        exit_idx = self.bundle.pipeline.sample_exit_index(self.host_rng)
        g, noise = self._draw(shape)
        mark = _Marks(self.timing, self.device, "critic", log)
        loss, clog = gan_obj.critic_loss(
            self.bundle, self.obj, self.generator, self.fake_score,
            self.cls_params, noise, real, context, None, exit_idx,
            generator=g, **self.critic_kw)
        mark("forward")
        n_fake = len(self.fake_leaves)
        grads = torch.autograd.grad(loss, self.fake_leaves + self.cls_leaves,
                                    allow_unused=True)
        mark("backward")
        gf, gc = list(grads[:n_fake]), list(grads[n_fake:])
        gnorm = AdamW.global_norm(gf)
        self.critic_opt_state = self.critic_optimizer.update(
            self.fake_leaves, gf, self.critic_opt_state)
        self.cls_opt_state = self.cls_optimizer.update(
            self.cls_leaves, gc, self.cls_opt_state)
        del grads, gf, gc
        mark("optimizer")
        log.update({k: float(v) for k, v in clog.items()},
                   critic_loss=float(loss.detach()),
                   critic_grad_norm=float(gnorm))
        self.step += 1
        return log

    # ------------------------------------------------------ checkpoints
    def save(self, path: str) -> None:
        """The weights: generator, critic, critic_cls (and
        generator_ema)."""
        out = {"generator": self.generator, "critic": self.fake_score,
               "critic_cls": self.cls_params}
        if self.generator_ema is not None:
            out["generator_ema"] = self.generator_ema
        save_pytree(path, out)

    def _state_tree(self, ema_like) -> dict:
        return {"generator": self.generator, "critic": self.fake_score,
                "critic_cls": self.cls_params,
                "gen_opt_state": self.gen_opt_state,
                "critic_opt_state": self.critic_opt_state,
                "cls_opt_state": self.cls_opt_state,
                "ema": ema_like, "step": self.step}

    def save_state(self, path: str) -> None:
        """The whole training state, so that the warmup and the update
        ratio (both keyed on the step) carry over a restart."""
        save_pytree(path, self._state_tree(self.generator_ema))

    def load_state(self, path: str, force_start_w_ema: bool = False,
                   force_reset_zero_step: bool = False) -> None:
        """Restore a :meth:`save_state` file (the parameters in place).
        ``force_start_w_ema``: the live generator takes the checkpoint's
        EMA weights; ``force_reset_zero_step``: the step count restarts
        at 0, so the warmup and the update ratio replay."""
        ema_like = self.generator_ema
        if ema_like is None and self.ema_weight > 0:
            ema_like = ema_lib.init_ema(self.generator)
        saved = restore_pytree(path, self._state_tree(ema_like), self.device)
        _copy_leaves(self.gen_leaves, saved["generator"])
        _copy_leaves(self.fake_leaves, saved["critic"])
        _copy_leaves(self.cls_leaves, saved["critic_cls"])
        self.gen_opt_state = saved["gen_opt_state"]
        self.critic_opt_state = saved["critic_opt_state"]
        self.cls_opt_state = saved["cls_opt_state"]
        self.generator_ema = saved["ema"]
        self.step = int(saved["step"])
        if force_start_w_ema:
            if saved["ema"] is None:
                raise ValueError(
                    "force_start_w_ema: the checkpoint carries no EMA state")
            _copy_leaves(self.gen_leaves, ema_lib.ema_to_params(
                saved["ema"], self.generator))
        if force_reset_zero_step:
            self.step = 0
