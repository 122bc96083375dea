"""The train step (port of ``avr_tpu/training/step.py`` ``apply_gradients``,
``make_train_step`` and ``make_chunked_call_train_step``, ``rng_mode="per_ray"``).

One step: encode the source views with BatchNorm in train mode (the running
statistics update in place, once), derive per-ray seeds from the key words
and the global ray ids (``derive(k0, k1, global_ray_ids(SB, R))``, as the
JAX step does with its key), render, take the loss, differentiate every
parameter (on CUDA tensors through the backward kernels of K1–K3), and
apply the optimizer.  The parameters are the model's own tensors and are
updated in place; the returned state is the same object, advanced.

The rays go through ``ray_chunks = C`` chunks (``C = 1``: the whole batch,
the same code): each renders ``R / C`` contiguous rays of every scene with
the matching slice of the one global seed map, so the random numbers equal
the unchunked step's.  A chunk differentiates its
loss against the parameters and a detached copy of the latent, so its graph
dies with it; the parameter gradients and the latent cotangent sum in
float32, are scaled by ``1 / C``, and the latent cotangent is pulled back
through the encoder's kept graph once.  The NaN guard of the loss applies
per chunk (``avr_tpu/training/step.py:100-103``).  JAX has two programs for
this (one scan, or ``C + 2`` calls); run eagerly they are one computation,
so :func:`make_chunked_call_train_step` is :func:`make_train_step` with
``ray_chunks``.  Chunks bound the memory a step holds: at ``C = 8`` a VR
step's decoder calls keep their activation stash under the 6 GiB budget
(the stash backward); at ``C = 1`` its 1,048,576 coarse and 1,572,864 fine
points take the recompute backward (``RECOMPUTE_CHUNK`` in
:mod:`avr_tpu_torch.ops.kernels.resnetfc`).

Not ported yet: the device-resident ``sampler=`` (ROADMAP P6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops.hashrng import RaySeeds, derive, global_ray_ids
from avr_tpu_torch.training.loss import LossParams, loss_fn
from avr_tpu_torch.training.state import Optimizer, TrainState, ema_update, global_norm

__all__ = ["apply_gradients", "loss_and_grads", "make_train_step",
           "make_chunked_call_train_step"]


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
                   key_words: Tuple[int, int], ray_chunks: int = 1):
    """``(loss, grads by parameter name)`` of one batch over ``ray_chunks``
    chunks of its rays, the encoder's BatchNorm in train mode (its running
    statistics update in place, once).  One chunk is the same computation:
    its sums and the ``1 / C`` scaling are then exact."""
    names = list(params)
    SB, R = gt.shape[:2]
    C = ray_chunks
    if R % C:
        raise ValueError(f"ray batch {R} not divisible by ray_chunks {C}")
    seeds = derive(key_words[0], key_words[1], global_ray_ids(SB, R, device=gt.device))
    with torch.enable_grad():
        cond = model.encode(src_images, src_poses, focal, c, train=True)

    def chunk(a, i):  # (SB, R, ...) -> chunk i, (SB, R / C, ...)
        return a.reshape(SB, C, R // C, *a.shape[2:])[:, i]

    gp = {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
    gc = torch.zeros_like(cond.latent, dtype=torch.float32)
    lsum = torch.zeros((), dtype=torch.float32, device=gt.device)
    for i in range(C):
        latent = cond.latent.detach().requires_grad_(True)
        with torch.enable_grad():
            out = model.render(dataclasses.replace(cond, latent=latent),
                               chunk(model_input["x_pix"], i), model_input["intrinsics"],
                               chunk(model_input["cam2world"], i),
                               RaySeeds(chunk(seeds.seeds, i)))
            loss = loss_fn(out, chunk(gt, i), loss_params)
            raw = torch.autograd.grad(loss, [params[n] for n in names] + [latent],
                                      allow_unused=True)
        for n, g in zip(names, raw[:-1]):
            if g is not None:
                gp[n] += g
        if raw[-1] is not None:
            gc += raw[-1]
        lsum += loss.detach()
    scale = 1.0 / C
    # the encoder's parameters get their gradient here, the rest none
    raw = torch.autograd.grad(cond.latent, [params[n] for n in names],
                              (gc * scale).to(cond.latent.dtype), allow_unused=True)
    grads = {n: gp[n] * scale for n in names}
    for n, g in zip(names, raw):
        if g is not None:
            grads[n] += g
    return lsum * scale, {n: g.to(params[n].dtype) for n, g in grads.items()}


def make_train_step(model: RadFieldRenderer, optimizer: Optimizer, loss_params: LossParams,
                    ray_chunks: int = 1, ema_decay: float = 0.999) -> Callable:
    """Build the train step::

        state, metrics = step(state, src_images, src_poses, focal, c,
                              model_input, gt, key_words)

    ``model_input = {x_pix, cam2world, intrinsics}`` holds the ray batch,
    ``gt (SB, R, 3)`` the target colours in [0, 1] and ``key_words = (k0,
    k1)`` the two key words :func:`~avr_tpu_torch.ops.hashrng.derive` reads.
    Metrics (device scalars): ``loss``, ``grad_norm``, ``notfinite``.  The
    step runs where the model and tensors are (the card unless they were
    put on the CPU).  ``ray_chunks`` splits the rays into that many chunks
    (``R`` must divide), summing their gradients before the update.
    """
    if ray_chunks < 1:
        raise ValueError(f"ray_chunks must be >= 1, got {ray_chunks}")

    def step(state: TrainState, src_images, src_poses, focal, c, model_input, gt,
             key_words: Tuple[int, int]):
        loss, grads = loss_and_grads(model, state.params, loss_params, src_images, src_poses,
                                     focal, c, model_input, gt, key_words, ray_chunks)
        grad_norm = global_norm(grads)
        state = apply_gradients(state, grads, optimizer, ema_decay, grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "notfinite": state.opt_state.total_notfinite}
        return state, metrics

    return step


def make_chunked_call_train_step(model: RadFieldRenderer, optimizer: Optimizer,
                                 loss_params: LossParams, ray_chunks: int,
                                 ema_decay: float = 0.999) -> Callable:
    """JAX's ``C + 2``-call chunked step (encode, ``C`` chunk calls, finish):
    in eager PyTorch the same computation as ``make_train_step(...,
    ray_chunks=ray_chunks)``, which it returns."""
    return make_train_step(model, optimizer, loss_params, ray_chunks, ema_decay)
