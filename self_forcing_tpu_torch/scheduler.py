"""Flow-matching noise schedule (port of ``self_forcing_tpu/scheduler.py``).

Sigma tables are built in float64 on the host with numpy, then stored as
float32 tensors on the scheduler's device; the conversions run in float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchScheduler:
    """Shifted rectified-flow schedule:
    sigma' = shift * s / (1 + (shift - 1) * s) over a linspace s, and
    ``timesteps = num_train_timesteps * sigmas``."""

    sigmas: torch.Tensor             # [num_steps] f32, descending
    timesteps: torch.Tensor          # [num_steps] f32, descending
    training_weights: torch.Tensor | None
    shift: float = 5.0
    num_train_timesteps: int = 1000

    @classmethod
    def create(cls, num_inference_steps: int = 1000, shift: float = 5.0,
               sigma_min: float = 0.0, sigma_max: float = 1.0,
               extra_one_step: bool = True, training: bool = False,
               num_train_timesteps: int = 1000,
               denoising_strength: float = 1.0,
               device: str | torch.device = "cuda") -> "FlowMatchScheduler":
        sigma_start = sigma_min + (sigma_max - sigma_min) * denoising_strength
        if extra_one_step:
            sigmas = np.linspace(sigma_start, sigma_min,
                                 num_inference_steps + 1, dtype=np.float64)[:-1]
        else:
            sigmas = np.linspace(sigma_start, sigma_min,
                                 num_inference_steps, dtype=np.float64)
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        timesteps = sigmas * num_train_timesteps

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        training_weights = None
        if training:
            y = np.exp(-2 * ((timesteps - num_inference_steps / 2)
                             / num_inference_steps) ** 2)
            y_shifted = y - y.min()
            training_weights = f32(
                y_shifted * (num_inference_steps / y_shifted.sum()))
        return cls(sigmas=f32(sigmas), timesteps=f32(timesteps),
                   training_weights=training_weights, shift=shift,
                   num_train_timesteps=num_train_timesteps)

    def timestep_id(self, timestep: torch.Tensor) -> torch.Tensor:
        """Nearest-timestep index, same shape as ``timestep``."""
        t = timestep.to(torch.float32)
        d = (self.timesteps[None, :] - t.reshape(-1)[:, None]).abs()
        return d.argmin(dim=1).reshape(t.shape)

    def sigma(self, timestep: torch.Tensor) -> torch.Tensor:
        return self.sigmas[self.timestep_id(timestep)]

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timestep: torch.Tensor) -> torch.Tensor:
        """x_t = (1 - sigma_t) x_0 + sigma_t eps; ``timestep`` is [B]
        matching sample.shape[0]."""
        sigma = _bcast(self.sigma(timestep), sample)
        out = (1.0 - sigma) * sample.float() + sigma * noise.float()
        return out.to(noise.dtype)

    def step(self, model_output: torch.Tensor, timestep: torch.Tensor,
             sample: torch.Tensor, to_final: bool = False) -> torch.Tensor:
        """Euler step x_{t-1} = x_t + v * (sigma_next - sigma_t)."""
        tid = self.timestep_id(timestep)
        sigma = _bcast(self.sigmas[tid], sample)
        n = self.sigmas.shape[0]
        next_sigma = torch.where(
            tid + 1 >= n, 0.0, self.sigmas[torch.clamp_max(tid + 1, n - 1)])
        if to_final:
            next_sigma = torch.zeros_like(next_sigma)
        next_sigma = _bcast(next_sigma, sample)
        out = sample.float() + model_output.float() * (next_sigma - sigma)
        return out.to(sample.dtype)

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timestep: torch.Tensor) -> torch.Tensor:
        """Flow-matching target v = eps - x0."""
        del timestep
        return noise - sample

    def training_weight(self, timestep: torch.Tensor) -> torch.Tensor:
        """Per-timestep Gaussian weights (needs ``create(training=True)``)."""
        if self.training_weights is None:
            raise ValueError("training_weight needs create(training=True)")
        return self.training_weights[self.timestep_id(timestep)]

    def convert_flow_pred_to_x0(self, flow_pred: torch.Tensor,
                                xt: torch.Tensor,
                                timestep: torch.Tensor) -> torch.Tensor:
        """x0 = x_t - sigma_t * v."""
        sigma = _bcast(self.sigma(timestep), xt)
        out = xt.float() - sigma * flow_pred.float()
        return out.to(flow_pred.dtype)

    def convert_x0_to_flow_pred(self, x0_pred: torch.Tensor,
                                xt: torch.Tensor,
                                timestep: torch.Tensor) -> torch.Tensor:
        """v = (x_t - x0) / sigma_t."""
        sigma = _bcast(self.sigma(timestep), xt)
        out = (xt.float() - x0_pred.float()) / sigma
        return out.to(x0_pred.dtype)

    def convert_x0_to_noise(self, x0: torch.Tensor, xt: torch.Tensor,
                            timestep: torch.Tensor) -> torch.Tensor:
        """eps = (x_t - (1 - sigma) x0) / sigma (rectified flow)."""
        sigma = _bcast(self.sigma(timestep), xt)
        out = (xt.float() - (1.0 - sigma) * x0.float()) / sigma
        return out.to(x0.dtype)

    def convert_noise_to_x0(self, noise: torch.Tensor, xt: torch.Tensor,
                            timestep: torch.Tensor) -> torch.Tensor:
        """x0 = (x_t - sigma eps) / (1 - sigma)."""
        sigma = _bcast(self.sigma(timestep), xt)
        out = (xt.float() - sigma * noise.float()) / (1.0 - sigma)
        return out.to(noise.dtype)


def _bcast(per_batch: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a [B] tensor to [B, 1, 1, ...] matching ``like``'s rank."""
    return per_batch.reshape(per_batch.shape
                             + (1,) * (like.dim() - per_batch.dim()))


def shift_timestep(timestep: torch.Tensor, shift: float,
                   num_train_timesteps: int = 1000) -> torch.Tensor:
    """t' = shift*(t/T) / (1 + (shift-1)*(t/T)) * T, the trainer-side
    timestep warp."""
    t = timestep.float() / num_train_timesteps
    return shift * t / (1 + (shift - 1) * t) * num_train_timesteps


def warp_denoising_steps(scheduler: FlowMatchScheduler,
                         denoising_step_list: list[int]) -> np.ndarray:
    """Map raw [1000, 750, 500, 250] steps through the shifted schedule:
    timesteps[1000 - t] with a trailing 0 appended."""
    timesteps = np.concatenate(
        [scheduler.timesteps.cpu().numpy(), np.zeros((1,), np.float32)])
    return timesteps[scheduler.num_train_timesteps
                     - np.asarray(denoising_step_list)]
