"""Score-distillation trainer, the main Self-Forcing trainer (port of
``self_forcing_tpu/training/trainer_distillation.py``) with the DMD or
the SiD objective (``distribution_loss``).

``train_step`` updates the generator every ``dfake_gen_update_ratio``
steps and the critic (fake score) every step.  The rollout length and the
exit steps come from a host numpy RNG seeded with the config's seed, as
in the JAX package; every update draws its noise, timesteps and rollout
eps from a ``torch.Generator`` seeded by that RNG.  Gradients are
``torch.autograd.grad`` of the loss with respect to the updated model's
leaves; a leaf without a gradient (``pose_proj``) gets a zero one.

Pose conditioning in the trainer and loading LoRA weights from a file
raise ``NotImplementedError`` (ROADMAP Queue A item 7); the port has no
meshes.  Checkpoints go through ``utils/checkpoints.py``'s
``save_pytree`` / ``restore_pytree`` (``torch.save`` files).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from self_forcing_tpu_torch import lora as lora_mod
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.scheduler import warp_denoising_steps
from self_forcing_tpu_torch.training import ema as ema_lib
from self_forcing_tpu_torch.training.objectives import dmd, sid
from self_forcing_tpu_torch.training.objectives.base import (ModelBundle,
                                                            ObjectiveConfig)
from self_forcing_tpu_torch.training.optim import AdamW
from self_forcing_tpu_torch.utils import tree
from self_forcing_tpu_torch.utils.checkpoints import (restore_pytree,
                                                      save_pytree)

_QUEUED = "is not ported to the PyTorch package (ROADMAP Queue A item 7)"


@dataclasses.dataclass
class TrainState:
    generator: Any
    fake_score: Any
    gen_opt_state: Any
    critic_opt_state: Any
    generator_ema: Any | None
    step: int = 0


class _Marks:
    """Milliseconds between named points of an update, synchronising the
    card at each (only when ``enabled``)."""

    def __init__(self, enabled: bool, device: torch.device, prefix: str,
                 log: dict):
        self.enabled, self.device = enabled, device
        self.prefix, self.log = prefix, log
        self.last = self._now()

    def _now(self) -> float:
        if self.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.enabled:
            now = self._now()
            self.log[f"{self.prefix}_{name}_ms"] = (now - self.last) * 1e3
            self.last = now


def _trainable(params) -> list[torch.Tensor]:
    """The tree's leaves, each float leaf marked as requiring grad."""
    out = tree.leaves(params)
    for t in out:
        if t.is_floating_point():
            t.requires_grad_(True)
    return out


class ScoreDistillationTrainer:
    """DMD distillation of a causal generator against a frozen real score
    and a trained fake score.  Parameter trees come in as the port's
    dicts; ``neg_context`` is the negative prompt's text context.
    ``timing=True`` adds per-phase milliseconds (synchronised) to the
    log: rollout, score forwards, backward and optimizer of each update."""

    def __init__(self, config, generator_params, fake_params, real_params,
                 generator_cfg: WanConfig, critic_cfg: WanConfig,
                 teacher_cfg: WanConfig, neg_context,
                 objective: str | None = None,
                 device: str | torch.device = "cuda",
                 timing: bool = False):
        self.config = config
        self.device = torch.device(device)
        self.timing = timing
        obj = ObjectiveConfig(
            num_train_timestep=int(getattr(config, "num_train_timestep",
                                           1000)),
            real_guidance_scale=float(getattr(
                config, "real_guidance_scale",
                getattr(config, "guidance_scale", 3.0))),
            fake_guidance_scale=float(getattr(config, "fake_guidance_scale",
                                              0.0)),
            timestep_shift=float(getattr(config, "timestep_shift", 1.0)),
            ts_schedule=bool(getattr(config, "ts_schedule", True)),
            ts_schedule_max=bool(getattr(config, "ts_schedule_max", False)),
            min_score_timestep=int(getattr(config, "min_score_timestep", 0)),
            num_frame_per_block=int(getattr(config, "num_frame_per_block",
                                            1)),
            same_step_across_blocks=bool(
                getattr(config, "same_step_across_blocks", True)),
            last_step_only=bool(getattr(config, "last_step_only", False)),
            num_training_frames=int(getattr(config, "num_training_frames",
                                            21)),
            context_noise=float(getattr(config, "context_noise", 0)),
            denoising_loss_type=str(getattr(config, "denoising_loss_type",
                                            "flow")),
            sid_alpha=float(getattr(config, "sid_alpha", 1.0)),
        )
        self.obj = obj
        self.objective = objective or str(
            getattr(config, "distribution_loss", "dmd"))
        if self.objective not in ("dmd", "sid"):
            raise ValueError(f"unknown distribution_loss "
                             f"{self.objective!r}")
        self._generator_loss = (dmd if self.objective == "dmd"
                                else sid).generator_loss
        if getattr(config, "use_pose_conditioning", False):
            raise NotImplementedError(f"pose conditioning {_QUEUED}")

        gen_cfg = dataclasses.replace(
            generator_cfg, num_frame_per_block=obj.num_frame_per_block,
            independent_first_frame=bool(
                getattr(config, "independent_first_frame", False)))
        self.bundle = ModelBundle.create(
            gen_cfg, critic_cfg, teacher_cfg, obj,
            [int(s) for s in config.denoising_step_list],
            independent_first_frame=gen_cfg.independent_first_frame,
            device=self.device)
        if getattr(config, "warp_denoising_step", False):
            warped = warp_denoising_steps(
                self.bundle.scheduler,
                [int(s) for s in config.denoising_step_list])
            self.bundle.pipeline.denoising_step_list = tuple(
                float(s) for s in warped if s != 0)

        lora_rank = int(getattr(config, "lora_rank", 0) or 0)
        self.train_lora_only = bool(
            getattr(config, "train_lora_only", False)) and lora_rank > 0
        if lora_rank > 0 and not lora_mod.has_lora(generator_params):
            generator_params = lora_mod.apply_lora(
                generator_params, rank=lora_rank,
                alpha=float(getattr(config, "lora_alpha", lora_rank)),
                targets=getattr(config, "lora_targets", None),
                seed=int(getattr(config, "seed", 0)) + 1337)
            lora_path = getattr(config, "lora_path", None) or \
                getattr(config, "generator_lora_path", None)
            if lora_path and os.path.exists(str(lora_path)):
                raise NotImplementedError(f"loading LoRA weights {_QUEUED}")

        self.gen_leaves = _trainable(generator_params)
        self.fake_leaves = _trainable(fake_params)
        wd = float(getattr(config, "weight_decay", 0.01))
        labels = None
        if self.train_lora_only:
            labels = [lab == "train" for lab in tree.leaves(
                lora_mod.lora_label_tree(generator_params))]
        self.gen_optimizer = AdamW(
            lr=float(config.lr), beta1=float(getattr(config, "beta1", 0.0)),
            beta2=float(getattr(config, "beta2", 0.999)), weight_decay=wd,
            max_grad_norm=float(getattr(config, "max_grad_norm_generator",
                                        10.0)), trainable=labels)
        self.critic_optimizer = AdamW(
            lr=float(getattr(config, "lr_critic", config.lr)),
            beta1=float(getattr(config, "beta1_critic", 0.0)),
            beta2=float(getattr(config, "beta2_critic", 0.999)),
            weight_decay=wd,
            max_grad_norm=float(getattr(config, "max_grad_norm_critic",
                                        10.0)))
        self.state = TrainState(
            generator=generator_params, fake_score=fake_params,
            gen_opt_state=self.gen_optimizer.init(self.gen_leaves),
            critic_opt_state=self.critic_optimizer.init(self.fake_leaves),
            generator_ema=None)
        self.real_params = real_params
        self.neg_context = neg_context
        self.ema_weight = float(getattr(config, "ema_weight", 0.0) or 0.0)
        self.ema_start_step = int(getattr(config, "ema_start_step", 0))
        self.dfake_gen_update_ratio = int(
            getattr(config, "dfake_gen_update_ratio", 5))
        self.host_rng = np.random.default_rng(int(getattr(config, "seed",
                                                          0)))

    # -------------------------------------------------------------- api
    def _sample_rollout_shape(self, base_shape):
        """A random rollout length in whole blocks."""
        nb = self.obj.num_frame_per_block
        min_blocks = min(21, self.obj.num_training_frames) // nb
        max_blocks = self.obj.num_training_frames // nb
        n = int(self.host_rng.integers(min_blocks, max_blocks + 1))
        shape = list(base_shape)
        shape[1] = n * nb
        return shape

    def _draw(self, shape):
        """A generator seeded from the host RNG, and the update's noise."""
        g = torch.Generator(device=self.device).manual_seed(
            int(self.host_rng.integers(2 ** 31)))
        noise = torch.randn(shape, generator=g, device=self.device)
        return g, noise

    def train_step(self, batch: dict) -> dict:
        """One alternating update: the generator every
        dfake_gen_update_ratio steps, the critic every step."""
        context = batch["context"]
        log: dict = {}
        B = context.shape[0]
        nb = self.obj.num_frame_per_block
        base_shape = list(getattr(self.config, "image_or_video_shape",
                                  [B, 21, 16, 60, 104]))
        shape = self._sample_rollout_shape(base_shape)
        shape[0] = B
        exit_idx = self.bundle.pipeline.sample_exit_index(
            self.host_rng, num_blocks=shape[1] // nb)

        if self.state.step % self.dfake_gen_update_ratio == 0:
            g, noise = self._draw(shape)
            mark = _Marks(self.timing, self.device, "generator", log)
            loss, glog = self._generator_loss(
                self.bundle, self.obj, self.state.generator,
                self.state.fake_score, self.real_params, noise, context,
                self.neg_context, exit_idx, generator=g, mark=mark)
            grads = torch.autograd.grad(loss, self.gen_leaves,
                                        allow_unused=True)
            mark("backward")
            gnorm = AdamW.global_norm(grads)
            self.state.gen_opt_state = self.gen_optimizer.update(
                self.gen_leaves, grads, self.state.gen_opt_state)
            del grads
            mark("optimizer")
            log.update({k: float(v) for k, v in glog.items()},
                       generator_loss=float(loss.detach()),
                       generator_grad_norm=float(gnorm))
            if self.ema_weight > 0 and self.state.step >= self.ema_start_step:
                if self.state.generator_ema is None:
                    self.state.generator_ema = ema_lib.init_ema(
                        self.state.generator)
                else:
                    ema_lib.update_ema(self.state.generator_ema,
                                       self.state.generator,
                                       decay=self.ema_weight)

        shape = self._sample_rollout_shape(shape)
        shape[0] = B
        exit_idx = self.bundle.pipeline.sample_exit_index(
            self.host_rng, num_blocks=shape[1] // nb)
        g, noise = self._draw(shape)
        mark = _Marks(self.timing, self.device, "critic", log)
        loss, clog = dmd.critic_loss(
            self.bundle, self.obj, self.state.generator,
            self.state.fake_score, noise, context, self.neg_context,
            exit_idx, generator=g, mark=mark)
        grads = torch.autograd.grad(loss, self.fake_leaves,
                                    allow_unused=True)
        mark("backward")
        gnorm = AdamW.global_norm(grads)
        self.state.critic_opt_state = self.critic_optimizer.update(
            self.fake_leaves, grads, self.state.critic_opt_state)
        del grads
        mark("optimizer")
        log.update({k: float(v) for k, v in clog.items()},
                   critic_loss=float(loss.detach()), critic_grad_norm=float(gnorm))
        self.state.step += 1
        return log

    # ------------------------------------------------------ checkpoints
    def save(self, path: str) -> None:
        """The weights under the reference's keys (generator, critic,
        generator_ema), one ``torch.save`` file."""
        out = {"generator": self.state.generator,
               "critic": self.state.fake_score}
        if self.state.generator_ema is not None:
            out["generator_ema"] = self.state.generator_ema
        save_pytree(path, out)

    def _state_tree(self, ema_like) -> dict:
        s = self.state
        return {"generator": s.generator, "fake_score": s.fake_score,
                "gen_opt_state": s.gen_opt_state,
                "critic_opt_state": s.critic_opt_state,
                "generator_ema": ema_like, "step": s.step}

    def save_state(self, path: str) -> None:
        """The whole training state, optimizer moments and step
        included."""
        save_pytree(path, self._state_tree(self.state.generator_ema))

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` file into this trainer (the
        parameters in place, so the optimizers keep their leaves)."""
        saved = restore_pytree(path, self._state_tree(None), self.device)
        _copy_leaves(self.gen_leaves, saved["generator"])
        _copy_leaves(self.fake_leaves, saved["fake_score"])
        self.state.gen_opt_state = saved["gen_opt_state"]
        self.state.critic_opt_state = saved["critic_opt_state"]
        self.state.generator_ema = saved["generator_ema"]
        self.state.step = int(saved["step"])


@torch.no_grad()
def _copy_leaves(leaves: list[torch.Tensor], saved) -> None:
    """Write a restored tree's leaves into the live ones, in order."""
    new = tree.leaves(saved)
    if len(new) != len(leaves):
        raise ValueError(f"restored tree has {len(new)} leaves, the model "
                         f"{len(leaves)}")
    for p, v in zip(leaves, new):
        p.copy_(v)
