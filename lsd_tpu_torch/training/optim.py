"""The trainers' optimizer: the counterpart of the reference's optax chain

    optax.chain(optax.clip_by_global_norm(grad_clip),
                optax.adamw(optax.warmup_cosine_decay_schedule(
                    0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1)),
                    weight_decay=weight_decay))

(``lsd_tpu/training/trainer.py:53-57``, ``mono3d.py:220-223``,
``yolo.py:188-191``), written out with ``torch._foreach_*`` operations in
optax's own order of arithmetic:

- the gradients' global norm ``n``; where ``n >= grad_clip`` each gradient
  becomes ``g / n * grad_clip`` (no epsilon, unlike ``clip_grad_norm_``);
- Adam's moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  bias-corrected by ``1 - b^count`` with the count after the increment;
- ``update = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * param``: the
  decay is decoupled and applies to every parameter, biases and norm
  scales included;
- ``param += -lr(count) * update``, where the schedule reads the count
  before the increment: the first update has lr 0 while the moments
  advance; the cosine decays to 0 at ``max(total_steps, warmup_steps + 1)``.

The step reads nothing back from the device: the norm's test is a
``torch.where`` on the device, and the learning rate and bias corrections
come from the step count, which the host keeps.  The state (``state_dict``)
is optax's: ``count`` and ``mu``/``nu`` per parameter of ``ScaleByAdamState``
and the count of ``ScaleByScheduleState``; ``convert.optimizer_state_*``
carry it to and from optax.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

_F = np.float32


def warmup_cosine_decay(count: int, peak: float, warmup_steps: int, decay_steps: int,
                        init: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup_steps,
    decay_steps)`` (end value 0, exponent 1) at ``count``, in float32 as
    optax computes it."""
    if count < warmup_steps:
        frac = _F(1) - _F(max(count, 0)) / _F(warmup_steps)
        return float((_F(init) - _F(peak)) * frac + _F(peak))
    span = decay_steps - warmup_steps
    c = _F(min(count - warmup_steps, span))
    cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c / _F(span)))
    return float(_F(peak) * cosine)


class ClippedAdamW:
    """Global-norm clipping, then AdamW on a warmup-cosine schedule, over
    named parameters (a module's ``named_parameters()``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], lr: float,
                 warmup_steps: int, total_steps: int, weight_decay: float = 1e-4,
                 grad_clip: float = 10.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr, self.warmup_steps = lr, warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0              # ScaleByAdamState.count
        self.schedule_count = 0     # ScaleByScheduleState.count

    def lr_at(self, count: int) -> float:
        return warmup_cosine_decay(count, self.lr, self.warmup_steps, self.decay_steps)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad``."""
        grads = [p.grad for p in self.params]
        c = self.grad_clip
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < c
        # g, or g / n * c: dividing by 1 and multiplying by 1 is exact
        grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, torch.full_like(norm, c)))

        self.count += 1
        lr = self.lr_at(self.schedule_count)
        self.schedule_count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        bc1 = float(_F(1) - _F(self.b1) ** _F(self.count))
        bc2 = float(_F(1) - _F(self.b2) ** _F(self.count))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> Dict:
        """{"count", "schedule_count": int, "mu", "nu": {name: tensor}}."""
        return dict(count=self.count, schedule_count=self.schedule_count,
                    mu=dict(zip(self.names, self.mu)), nu=dict(zip(self.names, self.nu)))

    def load_state_dict(self, state: Dict) -> None:
        """Take a state of this optimizer's parameters (the moments are copied
        onto each parameter's device and type)."""
        missing = set(self.names) ^ set(state["mu"]) | set(self.names) ^ set(state["nu"])
        if missing:
            raise ValueError(f"the optimizer state does not fit the parameters: {sorted(missing)}")
        self.count, self.schedule_count = int(state["count"]), int(state["schedule_count"])
        with torch.no_grad():
            for name, p, mu, nu in zip(self.names, self.params, self.mu, self.nu):
                mu.copy_(state["mu"][name])
                nu.copy_(state["nu"][name])
