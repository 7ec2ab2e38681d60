"""The ODE-regression initialisation trainer (port of
``self_forcing_tpu/training/trainer_ode.py``): one AdamW over the
generator, regressed onto precomputed ODE trajectories, an optional EMA,
and the loss broken down by 250-step timestep buckets for the log.

``train_step`` takes {'ode_latent': [B, T, F, C, H, W], 'context': [B, L,
text_dim]}; each step's draws come from a ``torch.Generator`` seeded
from the host numpy RNG (the config's seed).  With ``visualize`` the
step's (input, output, ground truth) latents stay in ``last_visual``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.scheduler import (FlowMatchScheduler,
                                              warp_denoising_steps)
from self_forcing_tpu_torch.training import ema as ema_lib
from self_forcing_tpu_torch.training.objectives import ode_regression
from self_forcing_tpu_torch.training.optim import AdamW
from self_forcing_tpu_torch.training.trainer_distillation import (
    _copy_leaves, _trainable)
from self_forcing_tpu_torch.utils.checkpoints import (restore_pytree,
                                                      save_pytree)


class SingleModelTrainer:
    """One generator, one AdamW (beta1 0.9 by default) and an optional
    EMA (the ODE and the diffusion trainers): the update, the EMA and the
    checkpoints."""

    def __init__(self, config, generator_params, device):
        self.config = config
        self.device = torch.device(device)
        self.params = generator_params
        self.leaves = _trainable(generator_params)
        self.optimizer = AdamW(
            lr=float(config.lr), beta1=float(getattr(config, "beta1", 0.9)),
            beta2=float(getattr(config, "beta2", 0.999)),
            weight_decay=float(getattr(config, "weight_decay", 0.01)),
            max_grad_norm=float(getattr(config, "max_grad_norm", 10.0)))
        self.opt_state = self.optimizer.init(self.leaves)
        self.ema_weight = float(getattr(config, "ema_weight", 0.0) or 0.0)
        self.ema = None
        self.step = 0
        self.host_rng = np.random.default_rng(int(getattr(config, "seed",
                                                          0)))

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            int(self.host_rng.integers(2 ** 31)))

    def _update(self, loss: torch.Tensor) -> dict:
        """Gradient, AdamW and EMA; returns loss and grad_norm."""
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        gnorm = AdamW.global_norm(grads)
        self.opt_state = self.optimizer.update(self.leaves, grads,
                                               self.opt_state)
        del grads
        if self.ema_weight > 0:
            if self.ema is None:
                self.ema = ema_lib.init_ema(self.params)
            else:
                ema_lib.update_ema(self.ema, self.params,
                                   decay=self.ema_weight)
        self.step += 1
        return {"loss": float(loss.detach()), "grad_norm": float(gnorm)}

    # ------------------------------------------------------ checkpoints
    def _state_tree(self, ema_like) -> dict:
        return {"params": self.params, "opt_state": self.opt_state,
                "ema": ema_like, "step": self.step}

    def save_state(self, path: str) -> None:
        """Parameters, optimizer moments, EMA and step."""
        save_pytree(path, self._state_tree(self.ema))

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` file (the parameters in place)."""
        ema_like = self.ema
        if ema_like is None and self.ema_weight > 0:
            ema_like = ema_lib.init_ema(self.params)
        saved = restore_pytree(path, self._state_tree(ema_like),
                               self.device)
        _copy_leaves(self.leaves, saved["params"])
        self.opt_state = saved["opt_state"]
        self.ema = saved["ema"]
        self.step = int(saved["step"])

    def save(self, path: str) -> None:
        """The weights under the reference's keys (generator,
        generator_ema)."""
        out = {"generator": self.params}
        if self.ema is not None:
            out["generator_ema"] = self.ema
        save_pytree(path, out)


class ODETrainer(SingleModelTrainer):
    def __init__(self, config, generator_params, generator_cfg: WanConfig,
                 visualize: bool = True,
                 device: str | torch.device = "cuda"):
        super().__init__(config, generator_params, device)
        self.visualize = bool(visualize)
        self.cfg = dataclasses.replace(
            generator_cfg, num_frame_per_block=int(getattr(
                config, "num_frame_per_block", 1)))
        self.rope = RopeTables.create(self.cfg.head_dim, device=self.device)
        self.scheduler = FlowMatchScheduler.create(
            1000, shift=float(getattr(config, "timestep_shift", 5.0)),
            training=True, device=self.device)
        steps = [int(s) for s in config.denoising_step_list]
        if getattr(config, "warp_denoising_step", False):
            steps = warp_denoising_steps(self.scheduler, steps)
        self.denoising_step_list = [float(s) for s in steps]
        self.i2v = bool(getattr(config, "i2v", False))
        self.last_visual = None

    def train_step(self, batch: dict, draws: dict | None = None) -> dict:
        """One update; the log holds loss, grad_norm and the mean
        per-sample loss of each 250-step timestep bucket the batch hit
        (``loss_bucket_<lo>``)."""
        ode_latent = batch["ode_latent"]
        loss, log = ode_regression.generator_loss(
            self.params, self.cfg, self.rope, self.scheduler, ode_latent,
            batch["context"], self.denoising_step_list,
            self.cfg.num_frame_per_block, generator=self._generator(),
            i2v=self.i2v, draws=draws)
        out = self._update(loss)
        if self.visualize:
            self.last_visual = {"input": log["input"],
                                "output": log["output"],
                                "ground_truth": ode_latent[:, -1]}
        t = log["timestep"].cpu().numpy()
        ul = log["unnormalized_loss"].float().cpu().numpy()
        for lo in range(0, 1000, 250):
            m = (t >= lo) & (t < lo + 250)
            if m.any():
                out[f"loss_bucket_{lo}"] = float(ul[m].mean())
        return out
