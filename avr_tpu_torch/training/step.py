"""The train step (port of ``avr_tpu/training/step.py`` ``apply_gradients``,
``make_train_step`` and ``make_chunked_call_train_step``).

One step: encode the source views with BatchNorm in train mode (the running
statistics update in place, once), render with the step's key, take the
loss, differentiate every parameter (on CUDA tensors through the backward
kernels of K1–K3), and apply the optimizer.  The parameters are the model's
own tensors and are updated in place; the returned state is the same
object, advanced.

The key's two words are a threefry key (:class:`~avr_tpu_torch.ops.threefry.Key`;
a plain ``(k0, k1)`` tuple reads the same).  ``rng_mode`` picks the
stream, as in JAX: ``"per_ray"`` (the default) derives per-ray seeds from
the key words and the global ray ids (``derive(k0, k1, global_ray_ids(SB,
R))``); ``"legacy"`` renders with the threefry key itself, whose draws go
through K7.

The rays go through ``ray_chunks = C`` chunks (``C = 1``: the whole batch,
the same code): each renders ``R / C`` contiguous rays of every scene.  In
``"per_ray"`` mode chunk ``i`` takes the matching slice of the one global
seed map, so the random numbers equal the unchunked step's; in
``"legacy"`` mode it renders with ``split(key, C)[i]`` (the key itself at
``C = 1``), as JAX's scan and chunked-call steps do.  A chunk differentiates its
loss against the parameters and a detached copy of the latent, so its graph
dies with it; the parameter gradients and the latent cotangent sum in
float32, are scaled by ``1 / C``, and the latent cotangent is pulled back
through the encoder's kept graph once.  The NaN guard of the loss applies
per chunk (``avr_tpu/training/step.py:100-103``).  JAX has two programs for
this (one scan, or ``C + 2`` calls); run eagerly they are one computation,
so :func:`make_chunked_call_train_step` is :func:`make_train_step` with
``ray_chunks`` (in ``"legacy"`` mode at ``C = 1`` it renders with ``split(key,
1)[0]``, as JAX's does).  Chunks bound the memory a step holds: at ``C = 8`` a VR
step's decoder calls keep their activation stash under the 6 GiB budget
(the stash backward); at ``C = 1`` its 1,048,576 coarse and 1,572,864 fine
points take the recompute backward (``RECOMPUTE_CHUNK`` in
:mod:`avr_tpu_torch.ops.kernels.resnetfc`).

A batch that is one rank's block of a global batch (the sharded steps of
:mod:`avr_tpu_torch.parallel.sharded_step`) passes ``block=((SB_global,
R_global), (sb0, r0))`` to :func:`loss_and_grads`: ``"per_ray"`` seeds then
hash the block's global ray ids, and a ``"legacy"`` key draws the global
batch's stream and keeps the block (:class:`~avr_tpu_torch.ops.hashrng.KeyBlock`).

With ``sampler=`` (:func:`avr_tpu_torch.data.device.make_device_sampler`)
the step is ``step(state)``: it draws its batch from the device-resident
set with ``k_batch`` and renders with ``k_render``, ``(k_batch, k_render) =
split(fold_in(sampler_key, step))`` (``avr_tpu/training/step.py:236-246``).
The step count is a device scalar; the step reads it to the host only when
the state's step tensor is not the one it produced last (a fresh or
restored state, or a count set or changed in place) and counts on the host
from there, so a step never waits on the card for its key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.ops.hashrng import (KeyBlock, KeyLike, RaySeeds, derive, global_ray_ids,
                                       shard_ray_ids)
from avr_tpu_torch.training.loss import LossParams, loss_fn
from avr_tpu_torch.training.state import Optimizer, TrainState, ema_update, global_norm

__all__ = ["apply_gradients", "loss_and_grads", "make_train_step",
           "make_chunked_call_train_step", "make_eval_step", "RNG_MODES"]

RNG_MODES = ("per_ray", "legacy")


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


def _chunk_keys(key, SB: int, R: int, C: int, rng_mode: str, device: torch.device,
                block=None) -> List[KeyLike]:
    """The render key of each of ``C`` chunks of ``R`` rays a scene; with
    ``block``, of the block of a global batch (module docstring)."""
    if rng_mode == "per_ray":
        if block is None:
            ids = global_ray_ids(SB, R, device=device)
        else:
            (_, Rg), (s0, r0) = block
            ids = shard_ray_ids(SB, R, s0 // SB, r0 // R, Rg // R, device=device)
        seeds = derive(key[0], key[1], ids).seeds
        return [RaySeeds(s) for s in seeds.reshape(SB, C, R // C).unbind(1)]
    key = threefry.Key(*key)
    if block is not None:
        if C != 1:
            raise ValueError("a legacy key's block of a global batch renders in one chunk")
        return [KeyBlock(key, *block)]
    return [key] if C == 1 else threefry.split(key, C)


def loss_and_grads(model: RadFieldRenderer, params: Dict[str, torch.Tensor],
                   loss_params: LossParams, src_images, src_poses, focal, c, model_input, gt,
                   key, ray_chunks: int = 1, rng_mode: str = "per_ray", block=None):
    """``(loss, grads by parameter name)`` of one batch over ``ray_chunks``
    chunks of its rays, the encoders' BatchNorm in train mode (their running
    statistics update in place, once) and the decoders' (``--bn``, at each
    of a chunk's queries), the render keys from ``key`` by
    ``rng_mode`` (and ``block``, a global batch's block: module docstring).
    One chunk is the same computation: its sums and the ``1 / C`` scaling
    are then exact."""
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    names = list(params)
    SB, R = gt.shape[:2]
    C = ray_chunks
    if R % C:
        raise ValueError(f"ray batch {R} not divisible by ray_chunks {C}")
    keys = _chunk_keys(key, SB, R, C, rng_mode, gt.device, block)
    with torch.enable_grad():
        cond = model.encode(src_images, src_poses, focal, c, train=True)
    # the encoders' outputs, detached for each chunk's render and pulled
    # back through the encoders once; stop_encoder_grad: the latent has no
    # graph (BatchNorm's statistics still update), the encoder's gradients
    # stay zero
    pulled = [f for f in ("latent", "global_latent")
              if getattr(cond, f) is not None and getattr(cond, f).requires_grad]

    def chunk(a, i):  # (SB, R, ...) -> chunk i, (SB, R / C, ...)
        return a.reshape(SB, C, R // C, *a.shape[2:])[:, i]

    gp = {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
    gc = {f: torch.zeros_like(getattr(cond, f), dtype=torch.float32) for f in pulled}
    lsum = torch.zeros((), dtype=torch.float32, device=gt.device)
    for i in range(C):
        leaves = {f: getattr(cond, f).detach().requires_grad_() for f in pulled}
        with torch.enable_grad():
            out = model.render(dataclasses.replace(cond, **leaves),
                               chunk(model_input["x_pix"], i), model_input["intrinsics"],
                               chunk(model_input["cam2world"], i), keys[i], train=True)
            loss = loss_fn(out, chunk(gt, i), loss_params)
            raw = torch.autograd.grad(loss, [params[n] for n in names] + list(leaves.values()),
                                      allow_unused=True)
        for n, g in zip(names, raw[:len(names)]):
            if g is not None:
                gp[n] += g
        for f, g in zip(pulled, raw[len(names):]):
            if g is not None:
                gc[f] += g
        lsum += loss.detach()
    scale = 1.0 / C
    grads = {n: gp[n] * scale for n in names}
    if pulled:
        # the encoders' parameters get their gradient here, the rest none
        outs = [getattr(cond, f) for f in pulled]
        raw = torch.autograd.grad(outs, [params[n] for n in names],
                                  [(gc[f] * scale).to(o.dtype) for f, o in zip(pulled, outs)],
                                  allow_unused=True)
        for n, g in zip(names, raw):
            if g is not None:
                grads[n] += g
    return lsum * scale, {n: g.to(params[n].dtype) for n, g in grads.items()}


def make_train_step(model: RadFieldRenderer, optimizer: Optimizer, loss_params: LossParams,
                    ray_chunks: int = 1, ema_decay: float = 0.999, rng_mode: str = "per_ray",
                    sampler: Optional[Callable] = None,
                    sampler_key: Optional[threefry.Key] = None) -> Callable:
    """Build the train step::

        state, metrics = step(state, src_images, src_poses, focal, c,
                              model_input, gt, key)

    ``model_input = {x_pix, cam2world, intrinsics}`` holds the ray batch,
    ``gt (SB, R, 3)`` the target colours in [0, 1] and ``key`` the step's
    threefry key (or its two words), used by ``rng_mode`` (``"per_ray"`` or
    ``"legacy"``).  Metrics (device scalars): ``loss``, ``grad_norm``,
    ``notfinite``.  The step runs where the model and tensors are (the card
    unless they were put on the CPU).  ``ray_chunks`` splits the rays into
    that many chunks (``R`` must divide), summing their gradients before the
    update.  With ``sampler`` (and ``sampler_key``, default ``PRNGKey(0)``)
    the step is ``step(state)`` and draws its own batch (module docstring).
    """
    return _make_step(model, optimizer, loss_params, ray_chunks, ema_decay, rng_mode, sampler,
                      sampler_key, split_one=False)


def _make_step(model, optimizer, loss_params, ray_chunks, ema_decay, rng_mode, sampler,
               sampler_key, split_one: bool) -> Callable:
    if ray_chunks < 1:
        raise ValueError(f"ray_chunks must be >= 1, got {ray_chunks}")
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r}")

    def step(state: TrainState, src_images, src_poses, focal, c, model_input, gt, key):
        if split_one and rng_mode == "legacy" and ray_chunks == 1:
            key = threefry.split(threefry.Key(*key), 1)[0]
        loss, grads = loss_and_grads(model, state.params, loss_params, src_images, src_poses,
                                     focal, c, model_input, gt, key, ray_chunks, rng_mode)
        grad_norm = global_norm(grads)
        state = apply_gradients(state, grads, optimizer, ema_decay, grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "notfinite": state.opt_state.total_notfinite}
        return state, metrics

    if sampler is None:
        return step
    base = threefry.PRNGKey(0) if sampler_key is None else threefry.Key(*sampler_key)
    # the host's copy of the step count, and the step tensor (and its
    # version) this step produced last
    count = {"tensor": None, "version": None, "step": 0}

    def device_data_step(state: TrainState):
        t = state.step
        if t is not count["tensor"] or t._version != count["version"]:
            # a state this step did not produce (a fresh or restored state,
            # or a step count set or changed in place): read its count
            count["step"] = int(t)
        k_batch, k_render = threefry.split(threefry.fold_in(base, count["step"]))
        state, metrics = step(state, *sampler(k_batch), k_render)
        count["step"] += 1
        count["tensor"], count["version"] = state.step, state.step._version
        return state, metrics

    return device_data_step


def make_chunked_call_train_step(model: RadFieldRenderer, optimizer: Optimizer,
                                 loss_params: LossParams, ray_chunks: int,
                                 ema_decay: float = 0.999, rng_mode: str = "per_ray") -> Callable:
    """JAX's ``C + 2``-call chunked step (encode, ``C`` chunk calls, finish):
    in eager PyTorch the computation of ``make_train_step(...,
    ray_chunks=ray_chunks)``; in ``"legacy"`` mode it splits the key for
    every ``C``, one included, as JAX's does."""
    return _make_step(model, optimizer, loss_params, ray_chunks, ema_decay, rng_mode, None,
                      None, split_one=True)


def make_eval_step(model: RadFieldRenderer, loss_params: LossParams) -> Callable:
    """The eval step (JAX's ``make_eval_step``): encode with the BatchNorm
    running statistics, render, loss; no gradients::

        out, loss = eval_step(src_images, src_poses, focal, c, model_input, gt, key)

    It renders with the model's current parameters; under ``with
    state.eval_variables():`` those are the EMA ones when the state keeps
    them (JAX passes ``state.eval_variables()`` as its first argument)."""

    def eval_step(src_images, src_poses, focal, c, model_input, gt, key):
        with torch.inference_mode():
            cond = model.encode(src_images, src_poses, focal, c, train=False)
            out = model.render(cond, model_input["x_pix"], model_input["intrinsics"],
                               model_input["cam2world"], key)
            return out, loss_fn(out, gt, loss_params)

    return eval_step
