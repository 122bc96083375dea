"""The train step (port of ``avr_tpu/training/step.py`` ``apply_gradients``
and ``make_train_step`` with ``ray_chunks=1`` and ``rng_mode="per_ray"``).

One step: encode the source views with BatchNorm in train mode (the running
statistics update in place), derive per-ray seeds from the key words and
the global ray ids (``derive(k0, k1, global_ray_ids(SB, R))``, as the JAX
step does with its key), render, take the loss, differentiate every
parameter (on CUDA tensors through the backward kernels of K1–K3), and
apply the optimizer.  The parameters are the model's own tensors and are
updated in place; the returned state is the same object, advanced.

Not ported yet: ``ray_chunks > 1``, ``make_chunked_call_train_step`` and the
device-resident ``sampler=`` (ROADMAP P6/P7).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops.hashrng import derive, global_ray_ids
from avr_tpu_torch.training.loss import LossParams, loss_fn
from avr_tpu_torch.training.state import Optimizer, TrainState, ema_update, global_norm

__all__ = ["apply_gradients", "loss_and_grads", "make_train_step"]


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor], optimizer: Optimizer,
                    ema_decay: float, grad_norm: torch.Tensor = None) -> TrainState:
    """Optimizer update (in place on the parameters) + step bump +
    (optional) parameter-EMA update."""
    updates, state.opt_state = optimizer.update(grads, state.opt_state, grad_norm)
    with torch.no_grad():
        names = list(state.params)
        torch._foreach_add_([state.params[n] for n in names], [updates[n] for n in names])
    if state.ema_params is not None and ema_decay > 0.0:
        state.ema_params = ema_update(state.ema_params, state.params, ema_decay)
    state.step = state.step + 1
    return state


def loss_and_grads(model: RadFieldRenderer, params: Dict[str, torch.Tensor],
                   loss_params: LossParams, src_images, src_poses, focal, c, model_input, gt,
                   key_words: Tuple[int, int]):
    """``(loss, grads by parameter name)`` of one batch, the encoder's
    BatchNorm in train mode (its running statistics update in place)."""
    names = list(params)
    with torch.enable_grad():
        cond = model.encode(src_images, src_poses, focal, c, train=True)
        SB, R = gt.shape[:2]
        seeds = derive(key_words[0], key_words[1], global_ray_ids(SB, R, device=gt.device))
        out = model.render(cond, model_input["x_pix"], model_input["intrinsics"],
                           model_input["cam2world"], seeds)
        loss = loss_fn(out, gt, loss_params)
        raw = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, raw)}
    return loss.detach(), grads


def make_train_step(model: RadFieldRenderer, optimizer: Optimizer, loss_params: LossParams,
                    ema_decay: float = 0.999) -> Callable:
    """Build the train step::

        state, metrics = step(state, src_images, src_poses, focal, c,
                              model_input, gt, key_words)

    ``model_input = {x_pix, cam2world, intrinsics}`` holds the ray batch,
    ``gt (SB, R, 3)`` the target colours in [0, 1] and ``key_words = (k0,
    k1)`` the two key words :func:`~avr_tpu_torch.ops.hashrng.derive` reads.
    Metrics (device scalars): ``loss``, ``grad_norm``, ``notfinite``.  The
    step runs where the model and tensors are (the card unless they were
    put on the CPU).  It runs the whole batch as one chunk and draws the
    band samples from the per-ray hash.
    """

    def step(state: TrainState, src_images, src_poses, focal, c, model_input, gt,
             key_words: Tuple[int, int]):
        loss, grads = loss_and_grads(model, state.params, loss_params, src_images, src_poses,
                                     focal, c, model_input, gt, key_words)
        grad_norm = global_norm(grads)
        state = apply_gradients(state, grads, optimizer, ema_decay, grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "notfinite": state.opt_state.total_notfinite}
        return state, metrics

    return step
