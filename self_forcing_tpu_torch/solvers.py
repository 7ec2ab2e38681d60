"""Flow-matching multistep ODE solvers, UniPC and DPM-Solver++ (port of
``self_forcing_tpu/solvers.py``).

Every coefficient depends only on the sigma schedule, so the whole solver
is a per-step linear combination

    UniPC corrector:   x   <- a_x * last + a_m0 * m1 + a_m1 * m2 + a_mt * x0
    UniPC predictor:   x'  <- b_x * x    + b_m0 * x0 + b_m1 * m1
    DPM++  (midpoint): x'  <- b_x * x    + b_m0 * x0 + b_m1 * m1

with the coefficient tables built in float64 numpy at construction, as the
JAX package builds them, and kept as float32 tensors on the solver's
device.  The combinations run in float32 whatever the flow's dtype; the
state (the two previous x0 predictions and the sample fed to the last
predictor) and the next sample are stored in the sample's dtype, as the
JAX package's scan carries them in the noise's: a float32 sample keeps
the whole state float32.

- UniPC: solver_order 2, bh2, predict_x0, lower_order_final, corrector on
  every step > 0, final sigma 0.
- DPM++: dpmsolver++, midpoint, order 2, lower_order_final.
- flow-prediction conversion x0 = x_t - sigma_t * v; the model's
  timestep is ``floor(sigma * 1000)`` in float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """The shifted sigma ladder of DPM++."""
    sigma = np.linspace(1, 0, sampling_steps + 1)[:sampling_steps]
    return shift * sigma / (1 + (shift - 1) * sigma)


def _lam(sigma: np.ndarray) -> np.ndarray:
    """lambda = log(alpha) - log(sigma) with alpha = 1 - sigma (flow)."""
    with np.errstate(divide="ignore"):
        return np.log(1.0 - sigma) - np.log(sigma)


@dataclasses.dataclass
class SolverState:
    """Multistep state: the x0 predictions of steps i-1 and i-2 and (UniPC)
    the sample fed to the last predictor, for the corrector."""

    m1: torch.Tensor
    m2: torch.Tensor
    last: torch.Tensor


def init_solver_state(shape, device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32) -> SolverState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return SolverState(m1=z, m2=z, last=z)


@dataclasses.dataclass(frozen=True)
class CoeffSolver:
    """A solver as its coefficient tables: ``pred`` [N, 3] (b_x, b_m0,
    b_m1) and ``corr`` [N, 4] (a_x, a_m0, a_m1, a_mt; zeros when there is
    no corrector), float32 on the device; ``timesteps`` [N] host float32,
    the model's t at each step."""

    sigmas: torch.Tensor     # [N+1] f32 (the final sigma appended)
    timesteps: np.ndarray    # [N] host f32
    pred: torch.Tensor       # [N, 3]
    corr: torch.Tensor       # [N, 4]
    has_corrector: bool

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def convert_to_x0(self, flow_pred: torch.Tensor, sample: torch.Tensor,
                      i: int) -> torch.Tensor:
        return sample.float() - self.sigmas[i] * flow_pred.float()

    def step(self, i: int, state: SolverState, flow_pred: torch.Tensor,
             sample: torch.Tensor) -> tuple[SolverState, torch.Tensor]:
        """One solver step.  Returns (new_state, next sample), both in
        the sample's dtype."""
        x0 = self.convert_to_x0(flow_pred, sample, i)
        s = sample.float()
        if self.has_corrector and i > 0:
            a = self.corr[i]
            s = (a[0] * state.last.float() + a[1] * state.m1.float()
                 + a[2] * state.m2.float() + a[3] * x0)
        b = self.pred[i]
        x_next = b[0] * s + b[1] * x0 + b[2] * state.m1.float()
        dt = sample.dtype
        return SolverState(m1=x0.to(dt), m2=state.m1, last=s.to(dt)), \
            x_next.to(dt)

    def sample(self, model_fn, noise: torch.Tensor) -> torch.Tensor:
        """The whole schedule: ``model_fn(x, t, i) -> flow_pred`` with t a
        Python float."""
        x = noise
        state = init_solver_state(noise.shape, noise.device, noise.dtype)
        for i, t in enumerate(self.timesteps):
            state, x = self.step(i, state, model_fn(x, float(t), i), x)
        return x


def _unipc_coeffs(sigmas: np.ndarray, order: int = 2):
    """Per-step UniPC-bh2 predictor / corrector coefficients."""
    N = len(sigmas) - 1  # sigmas includes the appended final 0
    lam = _lam(sigmas)
    alpha = 1.0 - sigmas
    pred = np.zeros((N, 3), np.float64)
    corr = np.zeros((N, 4), np.float64)

    def phi_b(hh):
        """(h_phi_1, B_h, b1, b2) for bh2 at signed step hh."""
        h_phi_1 = math.expm1(hh)
        B_h = h_phi_1  # bh2: B(h) = expm1(hh)
        b1 = (h_phi_1 / hh - 1.0) / B_h
        h_phi_2 = h_phi_1 / hh - 1.0
        h_phi_3 = h_phi_2 / hh - 0.5
        b2 = h_phi_3 * 2.0 / B_h
        return h_phi_1, B_h, b1, b2

    lower_order_nums = 0
    prev_order = 0
    for i in range(N):
        # corrector (prev_order, sigma_i / sigma_{i-1})
        if i > 0:
            h_c = lam[i] - lam[i - 1]
            h_phi_1c, B_hc, b1c, b2c = phi_b(-h_c)
            cx = sigmas[i] / sigmas[i - 1]
            cm = -alpha[i] * h_phi_1c
            if prev_order == 1:
                # x = cx*last + cm*m0 - alpha*B_h*0.5*(mt - m0)
                rho_mt = 0.5
                corr[i] = [cx, cm + alpha[i] * B_hc * rho_mt, 0.0,
                           -alpha[i] * B_hc * rho_mt]
            else:
                r0 = (lam[i - 2] - lam[i - 1]) / h_c
                # solve [[1,1],[r0,1]] rho = [b1, b2]
                det = 1.0 - r0
                rho0 = (b1c - b2c) / det
                rho1 = (b2c - r0 * b1c) / det
                k = -alpha[i] * B_hc
                corr[i] = [cx, cm + k * (-rho0 / r0) + k * (-rho1),
                           k * (rho0 / r0), k * rho1]

        # the predictor's order for this step
        this_order = min(order, N - i)          # lower_order_final
        this_order = min(this_order, lower_order_nums + 1)
        prev_order = this_order
        if lower_order_nums < order:
            lower_order_nums += 1

        # predictor (sigma_{i+1} / sigma_i)
        if sigmas[i + 1] == 0.0:
            pred[i] = [0.0, 1.0, 0.0]
            continue
        h = lam[i + 1] - lam[i]
        h_phi_1, B_h, _, _ = phi_b(-h)
        bx = sigmas[i + 1] / sigmas[i]
        bm0 = -alpha[i + 1] * h_phi_1
        bm1 = 0.0
        if this_order == 2:
            r0 = (lam[i - 1] - lam[i]) / h
            k = -alpha[i + 1] * B_h * 0.5 / r0   # 0.5 * (m1 - m0) / r0
            bm0 += -k
            bm1 = k
        pred[i] = [bx, bm0, bm1]
    return pred, corr


def _dpmpp_coeffs(sigmas: np.ndarray, order: int = 2):
    """DPM-Solver++(2M) midpoint coefficients."""
    N = len(sigmas) - 1
    lam = _lam(sigmas)
    alpha = 1.0 - sigmas
    pred = np.zeros((N, 3), np.float64)

    lower_order_nums = 0
    for i in range(N):
        this_order = min(order, lower_order_nums + 1)
        if i == N - 1:   # lower_order_final: first order onto sigma 0
            this_order = 1
        if lower_order_nums < order:
            lower_order_nums += 1

        if sigmas[i + 1] == 0.0:
            pred[i] = [0.0, 1.0, 0.0]
            continue
        h = lam[i + 1] - lam[i]
        bx = sigmas[i + 1] / sigmas[i]
        e = math.expm1(-h)          # exp(-h) - 1
        bm0 = -alpha[i + 1] * e
        bm1 = 0.0
        if this_order == 2:
            r0 = (lam[i] - lam[i - 1]) / h
            # D1 = (m0 - m1) / r0; the midpoint adds -0.5 * alpha_t * e * D1
            k = -0.5 * alpha[i + 1] * e / r0
            bm0 += k
            bm1 = -k
        pred[i] = [bx, bm0, bm1]
    return pred


def _finalize(sigmas: np.ndarray, pred, corr, has_corrector: bool,
              device) -> CoeffSolver:
    # the model is fed floor(sigma * 1000), the reference's int64 cast
    timesteps = np.floor(sigmas[:-1] * 1000.0).astype(np.float32)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return CoeffSolver(sigmas=f32(sigmas), timesteps=timesteps,
                       pred=f32(pred), corr=f32(corr),
                       has_corrector=has_corrector)


def flow_unipc(num_inference_steps: int = 50, shift: float = 8.0,
               num_train_timesteps: int = 1000, solver_order: int = 2,
               device: str | torch.device = "cuda") -> CoeffSolver:
    """FlowUniPCMultistepScheduler: the training schedule's sigmas in
    [0, 1 - 1/T], shifted, with a final sigma 0."""
    sigma_max = 1.0 - 1.0 / num_train_timesteps
    sigmas = np.linspace(sigma_max, 0.0, num_inference_steps + 1)[:-1]
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    sigmas = np.concatenate([sigmas, [0.0]])
    pred, corr = _unipc_coeffs(sigmas, solver_order)
    return _finalize(sigmas, pred, corr, True, device)


def flow_dpmpp(num_inference_steps: int = 50, shift: float = 8.0,
               solver_order: int = 2,
               device: str | torch.device = "cuda") -> CoeffSolver:
    """FlowDPMSolverMultistepScheduler fed by ``get_sampling_sigmas``, with
    a final sigma 0."""
    sigmas = np.concatenate(
        [get_sampling_sigmas(num_inference_steps, shift), [0.0]])
    pred = _dpmpp_coeffs(sigmas, solver_order)
    corr = np.zeros((num_inference_steps, 4), np.float64)
    return _finalize(sigmas, pred, corr, False, device)


def make_solver(name: str, sampling_steps: int, shift: float,
                device: str | torch.device = "cuda") -> CoeffSolver:
    """'unipc' | 'dpm++' (also 'dpmpp', 'dpm')."""
    if name == "unipc":
        return flow_unipc(sampling_steps, shift, device=device)
    if name in ("dpm++", "dpmpp", "dpm"):
        return flow_dpmpp(sampling_steps, shift, device=device)
    raise NotImplementedError(f"Unsupported solver {name!r}")
