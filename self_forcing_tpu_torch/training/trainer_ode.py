"""The ODE-regression initialisation trainer (port of
``self_forcing_tpu/training/trainer_ode.py``): one AdamW over the
generator, regressed onto precomputed ODE trajectories, an optional EMA,
and the loss broken down by 250-step timestep buckets for the log.

``train_step`` takes {'ode_latent': [B, T, F, C, H, W], 'context': [B, L,
text_dim]}; each step's draws come from a ``torch.Generator`` seeded
from the host numpy RNG (the config's seed).  With ``visualize`` the
step's (input, output, ground truth) latents stay in ``last_visual``.

``mesh``: the generator, its moments and EMA are ZeRO-3 slices
(``parallel/fsdp.py``), and a batch is split over dp x fsdp (else dp)
where its size divides, each rank drawing the whole batch's numbers and
keeping its rows; the loss is normalised by the whole batch's count, so
a sharded step equals the one-process step.  ``last_visual`` then holds
this rank's rows (rank 0: the first ones).
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
from self_forcing_tpu_torch.parallel import fsdp
from self_forcing_tpu_torch.training.trainer_distillation import (
    TrainedModel, _copy_leaves, _like_opt, batch_split, grads_of,
    local_rows, mean_log, min_param_size)
from self_forcing_tpu_torch.utils.checkpoints import (restore_pytree,
                                                      save_pytree)
from self_forcing_tpu_torch.utils.draws import split_generator


class SingleModelTrainer:
    """One generator, one AdamW (beta1 0.9 by default) and an optional
    EMA (the ODE and the diffusion trainers): the update, the EMA and the
    checkpoints."""

    def __init__(self, config, generator_params, device, mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh
        self.model = TrainedModel(generator_params, mesh,
                                  min_param_size(config))
        self.params = self.model.tree
        self.leaves = self.model.leaves
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

    def _generator(self, split=None) -> torch.Generator:
        return split_generator(torch.Generator(device=self.device)
                               .manual_seed(int(self.host_rng.integers(
                                   2 ** 31))), split)

    def _update(self, loss: torch.Tensor, split=None) -> dict:
        """Gradient, AdamW and EMA; returns loss (averaged over the ranks
        that split the batch) and grad_norm."""
        grads, = grads_of(loss, self.model)
        gnorm = self.model.norm(grads)
        self.opt_state = self.optimizer.update(self.leaves, grads,
                                               self.opt_state,
                                               norm_fn=self.model.norm_fn)
        del grads
        if self.ema_weight > 0:
            if self.ema is None:
                self.ema = ema_lib.init_ema(self.params)
            else:
                ema_lib.update_ema(self.ema, self.params,
                                   decay=self.ema_weight)
        self.step += 1
        return dict(mean_log(split, {"loss": loss}),
                    grad_norm=float(gnorm))

    # ------------------------------------------------------ checkpoints
    def save_state(self, path: str) -> None:
        """Parameters, optimizer moments, EMA and step (whole trees on a
        mesh: gathered, rank 0 writes)."""
        out = {"params": self.model.full(),
               "opt_state": self.model.full_opt(self.opt_state),
               "ema": None if self.ema is None else self.model.full(self.ema),
               "step": self.step}
        if fsdp.is_main():
            save_pytree(path, out)

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` file (the parameters in place; on
        a mesh each rank keeps its slices)."""
        saved = restore_pytree(path, device=self.device)
        _copy_leaves(self.leaves, self.model.shard_tree(saved["params"]))
        self.opt_state = self.model.shard_opt(
            _like_opt(saved["opt_state"], self.opt_state))
        self.ema = self.model.shard_tree(saved["ema"])
        self.step = int(saved["step"])

    def save(self, path: str) -> None:
        """The weights under the reference's keys (generator,
        generator_ema); on a mesh every rank calls it and rank 0
        writes."""
        out = {"generator": self.model.full()}
        if self.ema is not None:
            out["generator_ema"] = self.model.full(self.ema)
        if fsdp.is_main():
            save_pytree(path, out)


class ODETrainer(SingleModelTrainer):
    def __init__(self, config, generator_params, generator_cfg: WanConfig,
                 visualize: bool = True,
                 device: str | torch.device = "cuda", mesh=None):
        super().__init__(config, generator_params, device, mesh)
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
        (``loss_bucket_<lo>``).  ``draws`` ({'idx': [B, F]}) are the whole
        batch's."""
        ode_latent = batch["ode_latent"]
        split = batch_split(self.mesh, ode_latent.shape[0])
        ode_latent = local_rows(split, ode_latent)
        if draws is not None:
            draws = {k: local_rows(split, torch.as_tensor(v))
                     for k, v in draws.items()}
        loss, log = ode_regression.generator_loss(
            self.model.fwd(), self.cfg, self.rope, self.scheduler,
            ode_latent, local_rows(split, batch["context"]),
            self.denoising_step_list, self.cfg.num_frame_per_block,
            generator=self._generator(split), i2v=self.i2v, draws=draws,
            split=split)
        out = self._update(loss, split)
        if self.visualize:
            self.last_visual = {"input": log["input"],
                                "output": log["output"],
                                "ground_truth": ode_latent[:, -1]}
        t = _gathered(split, log["timestep"]).cpu().numpy()
        ul = _gathered(split, log["unnormalized_loss"]).float().cpu().numpy()
        for lo in range(0, 1000, 250):
            m = (t >= lo) & (t < lo + 250)
            if m.any():
                out[f"loss_bucket_{lo}"] = float(ul[m].mean())
        return out


def _gathered(split, t: torch.Tensor) -> torch.Tensor:
    """The whole batch's rows of a per-sample log entry."""
    return t if split is None else split.gather(t)
