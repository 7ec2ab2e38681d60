"""The causal diffusion (teacher-forcing) finetuning trainer (port of
``self_forcing_tpu/training/trainer_diffusion.py``): one AdamW over the
generator and an optional EMA, on batches of clean latents.

``train_step`` takes {'latents': [B, F, C, H, W], 'context': [B, L,
text_dim]}; ``teacher_forcing`` (default on) and
``noise_augmentation_max_timestep`` come from the config.  ``mesh``: as
the ODE trainer's (``trainer_ode.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler
from self_forcing_tpu_torch.training.objectives import causal_diffusion
from self_forcing_tpu_torch.training.trainer_distillation import (
    batch_split, local_rows, mean_log)
from self_forcing_tpu_torch.training.trainer_ode import SingleModelTrainer


class DiffusionTrainer(SingleModelTrainer):
    def __init__(self, config, generator_params, generator_cfg: WanConfig,
                 device: str | torch.device = "cuda", mesh=None):
        super().__init__(config, generator_params, device, mesh)
        self.cfg = dataclasses.replace(
            generator_cfg,
            num_frame_per_block=int(getattr(config, "num_frame_per_block",
                                            1)),
            independent_first_frame=bool(getattr(
                config, "independent_first_frame", False)))
        self.rope = RopeTables.create(self.cfg.head_dim, device=self.device)
        self.scheduler = FlowMatchScheduler.create(
            1000, shift=float(getattr(config, "timestep_shift", 5.0)),
            training=True, device=self.device)
        self.teacher_forcing = bool(getattr(config, "teacher_forcing", True))
        self.aug = int(getattr(config, "noise_augmentation_max_timestep", 0))

    def train_step(self, batch: dict, draws: dict | None = None) -> dict:
        """One update; the log holds loss, grad_norm, timestep_mean and
        x0_pred_mse.  ``draws`` are the whole batch's."""
        split = batch_split(self.mesh, batch["latents"].shape[0])
        if draws is not None:
            draws = {k: local_rows(split, torch.as_tensor(v))
                     for k, v in draws.items()}
        loss, log = causal_diffusion.generator_loss(
            self.model.fwd(), self.cfg, self.rope, self.scheduler,
            local_rows(split, batch["latents"]),
            local_rows(split, batch["context"]),
            self.cfg.num_frame_per_block, generator=self._generator(split),
            teacher_forcing=self.teacher_forcing,
            noise_augmentation_max_timestep=self.aug,
            independent_first_frame=self.cfg.independent_first_frame,
            draws=draws)
        out = self._update(loss, split)
        out.update(mean_log(split, log))
        return out
