"""Train state and optimizer (port of ``avr_tpu/training/state.py``).

The optimizer is optax's Adam (b1 0.9, b2 0.999, eps 1e-8) with a constant
or warmup-cosine learning rate, wrapped in ``skip_nonfinite_by_norm``: when
the global gradient norm is not finite the update of the parameters **and**
of both moments (and of Adam's step count) is skipped and
``total_notfinite`` grows by one.  Every decision is a ``torch.where`` on
device tensors, so a step never waits on the host, and the element-wise
arithmetic runs as multi-tensor (``torch._foreach_*``) launches over all
parameters at once: a step of the full model has ~150 parameter tensors,
and one launch per tensor and operation would cost the host thousands of
launches.

:class:`TrainState` holds the model's own parameter and BatchNorm tensors
(by name), which the step updates in place, plus the optimizer state and an
optional EMA of the parameters.  The optimizer's element-wise update is
plain PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional

import torch
from torch import nn

__all__ = ["TrainState", "AdamState", "Optimizer", "create_train_state", "make_optimizer",
           "ema_update", "global_norm", "warmup_cosine_schedule"]

Tensors = Dict[str, torch.Tensor]


@dataclass
class AdamState:
    count: torch.Tensor  # int32 scalar: Adam's bias-correction step
    mu: Tensors
    nu: Tensors
    total_notfinite: torch.Tensor  # int32 scalar: skipped updates


def global_norm(tensors: Tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, float32."""
    norms = torch._foreach_norm([t.float() for t in tensors.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def warmup_cosine_schedule(lr: float, total_steps: int,
                           warmup_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """optax ``warmup_cosine_decay_schedule(lr / 10, lr, warmup, total, lr / 20)``:
    linear from ``lr / 10`` to ``lr`` over ``warmup`` steps, then cosine decay
    to ``lr / 20`` at ``total_steps``."""
    init, end = lr / 10.0, lr / 20.0
    alpha = end / lr
    decay = float(total_steps - warmup_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = (init - lr) * (1.0 - torch.clamp(c, 0.0, float(warmup_steps)) / warmup_steps) + lr
        t = torch.clamp(c - warmup_steps, max=decay)
        cos = (1.0 - alpha) * (0.5 * (1.0 + torch.cos(math.pi * t / decay))) + alpha
        return torch.where(c < warmup_steps, warm, lr * cos)

    return schedule


@dataclass(frozen=True)
class Optimizer:
    """Adam that skips a non-finite update; ``lr`` is a float or a schedule
    of Adam's step count."""

    lr: object
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Tensors) -> AdamState:
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros(),
                         torch.zeros((), dtype=torch.int32, device=dev))

    def update(self, grads: Tensors, state: AdamState, grad_norm: Optional[torch.Tensor] = None):
        """``(updates, new_state)``; the updates are added to the parameters."""
        ok = torch.isfinite(global_norm(grads) if grad_norm is None else grad_norm)
        count = state.count + 1
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        c1 = 1.0 - self.b1 ** count.float()
        c2 = 1.0 - self.b2 ** count.float()
        names = list(grads)
        g = [grads[k] for k in names]
        mu0, nu0 = [state.mu[k] for k in names], [state.nu[k] for k in names]
        m = torch._foreach_mul(g, 1.0 - self.b1)  # (1 - b1) g + b1 mu, optax's order
        torch._foreach_add_(m, torch._foreach_mul(mu0, self.b1))
        v = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2)
        torch._foreach_add_(v, torch._foreach_mul(nu0, self.b2))
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(m, c1)
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, -lr)
        zero = torch.zeros((), dtype=u[0].dtype, device=u[0].device)
        updates = {k: torch.where(ok, a, zero) for k, a in zip(names, u)}
        mu = {k: torch.where(ok, a, b) for k, a, b in zip(names, m, mu0)}
        nu = {k: torch.where(ok, a, b) for k, a, b in zip(names, v, nu0)}
        new = AdamState(torch.where(ok, count, state.count), mu, nu,
                        state.total_notfinite + (~ok).to(torch.int32))
        return updates, new


def make_optimizer(lr: float = 1e-4, schedule: str = "constant",
                   total_steps: Optional[int] = None, warmup_steps: int = 500) -> Optimizer:
    """Adam with non-finite-update skipping (the JAX package's production
    optimizer, ``skip_impl="norm"``)."""
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("schedule='cosine' needs total_steps")
        warmup = min(warmup_steps, max(total_steps // 10, 1))
        return Optimizer(warmup_cosine_schedule(lr, total_steps, warmup))
    if schedule != "constant":
        raise ValueError(f"unknown lr schedule {schedule!r}")
    return Optimizer(lr)


@dataclass
class TrainState:
    step: torch.Tensor  # int32 scalar
    params: Tensors  # the model's parameters, updated in place
    batch_stats: Tensors  # the model's BatchNorm running statistics, updated in place
    opt_state: AdamState
    ema_params: Optional[Tensors] = field(default=None)

    @contextlib.contextmanager
    def eval_variables(self) -> Iterator["TrainState"]:
        """Evaluate with the EMA parameters when the state keeps them, else
        the raw ones (JAX's ``TrainState.eval_variables``,
        ``avr_tpu/training/state.py:150-161``)::

            with state.eval_variables():
                out = render_full_image(model, ...)

        The EMA values are copied into the model's own parameter tensors
        and the raw values copied back on exit.  The copies are in place,
        so every parameter's version counter moves both ways: a kernel
        wrapper that keeps data derived from a weight by its version (K3's
        bf16 forward keeps its weight fragments so) rebuilds it for the EMA
        weights and again after."""
        if self.ema_params is None:
            yield self
            return
        names = list(self.params)
        live = [self.params[k] for k in names]
        with torch.no_grad():
            saved = [p.detach().clone() for p in live]
            for p, k in zip(live, names):
                p.copy_(self.ema_params[k])
        try:
            yield self
        finally:
            with torch.no_grad():
                for p, v in zip(live, saved):
                    p.copy_(v)


def create_train_state(model: nn.Module, optimizer: Optimizer, ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    stats = dict(model.named_buffers())
    dev = next(iter(params.values())).device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev), params=params, batch_stats=stats,
        opt_state=optimizer.init(params),
        ema_params={k: p.detach().clone() for k, p in params.items()} if ema else None)


def ema_update(ema_params: Tensors, new_params: Tensors, decay: float) -> Tensors:
    """One EMA step: ``ema <- decay * ema + (1 - decay) * params``."""
    return {k: e * decay + new_params[k].detach().to(e.dtype) * (1.0 - decay)
            for k, e in ema_params.items()}
