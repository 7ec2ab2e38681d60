"""The trainers' optimizer (port of ``self_forcing_tpu/training/optim.py``):
AdamW after clipping by the global norm, computing what
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(lr, b1, b2,
weight_decay=wd))`` computes:

- clip: when the global norm g is not below ``max_norm``, every gradient
  becomes ``grad / g * max_norm`` (``torch.nn.utils.clip_grad_norm_``
  divides by ``g + 1e-6`` instead, a different function);
- moments ``mu = (1 - b1) grad + b1 mu`` and ``nu = (1 - b2) grad^2 + b2
  nu``, kept in each parameter's dtype as optax keeps them, bias-corrected
  by ``1 - b^count`` (computed in float32, then cast);
- update ``mu_hat / (sqrt(nu_hat) + eps) + wd * param`` (eps outside the
  square root, decoupled weight decay), times ``-lr``, added to the
  parameter in its dtype.

The global norm is taken in float32 (optax sums in the leaves' dtype).
Under ZeRO-3 (``parallel/fsdp.py``) the parameters, gradients and moments
are this rank's slices and the clip takes the whole tree's norm
(``update``'s ``norm_fn``), so the step equals the one-process step.
A leaf without a gradient counts as a zero gradient: it still decays.
``trainable`` (the LoRA-only variant, ``make_lora_optimizer``): the other
leaves are frozen, as ``optax.set_to_zero`` freezes them, and the clip
sees only the trainable ones.
"""
from __future__ import annotations

import numpy as np
import torch


class AdamW:
    def __init__(self, lr: float, beta1: float = 0.0, beta2: float = 0.999,
                 weight_decay: float = 0.01, max_grad_norm: float = 10.0,
                 eps: float = 1e-8, trainable: list[bool] | None = None):
        self.lr, self.b1, self.b2 = float(lr), float(beta1), float(beta2)
        self.wd, self.max_norm = float(weight_decay), float(max_grad_norm)
        self.eps = float(eps)
        self.trainable = trainable

    def _mask(self, n: int) -> list[bool]:
        return [True] * n if self.trainable is None else list(self.trainable)

    def init(self, params: list[torch.Tensor]) -> dict:
        mask = self._mask(len(params))
        zeros = [torch.zeros_like(p) if m else None
                 for p, m in zip(params, mask)]
        return {"count": 0, "mu": zeros,
                "nu": [None if z is None else torch.zeros_like(z)
                       for z in zeros]}

    @staticmethod
    def global_norm(grads: list[torch.Tensor | None]) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient, in float32."""
        sq = [g.float().pow(2).sum() for g in grads if g is not None]
        return torch.sqrt(torch.stack(sq).sum()) if sq else \
            torch.zeros(())

    @torch.no_grad()
    def update(self, params: list[torch.Tensor],
               grads: list[torch.Tensor | None], state: dict,
               norm_fn=None) -> dict:
        """One step on ``params`` in place; returns the new state.
        ``norm_fn(grads, index)``: the global norm of the gradients at
        ``index`` (ZeRO-3 slices: ``fsdp.ShardedParams.global_norm``, which
        sums the slices' squares over the ranks), else
        :meth:`global_norm` of the given ones."""
        mask = self._mask(len(params))
        idx = [i for i, m in enumerate(mask) if m]
        g = {i: grads[i] if grads[i] is not None
             else torch.zeros_like(params[i]) for i in idx}
        norm = (norm_fn(g, idx) if norm_fn is not None
                else self.global_norm([g[i] for i in idx]))
        if not bool(norm < self.max_norm):
            g = {i: (x / norm.to(x.dtype)) * self.max_norm
                 for i, x in g.items()}
        count = state["count"] + 1
        bc1 = np.float32(1.0) - np.float32(self.b1) ** np.int32(count)
        bc2 = np.float32(1.0) - np.float32(self.b2) ** np.int32(count)
        mu, nu = list(state["mu"]), list(state["nu"])
        for i in idx:
            p, x = params[i], g[i]
            mu[i] = (1 - self.b1) * x + self.b1 * mu[i]
            nu[i] = (1 - self.b2) * (x * x) + self.b2 * nu[i]
            mu_hat = mu[i] / torch.tensor(float(bc1), device=p.device
                                          ).to(mu[i].dtype)
            nu_hat = nu[i] / torch.tensor(float(bc2), device=p.device
                                          ).to(nu[i].dtype)
            upd = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            upd = upd + self.wd * p
            p.copy_((p + (-self.lr) * upd).to(p.dtype))
        return {"count": count, "mu": mu, "nu": nu}
