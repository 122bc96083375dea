"""Sharded train steps over the ``(data, rays)`` mesh (port of
``avr_tpu/parallel/sharded_step.py``).

Both of JAX's flavours, with ``make_train_step``'s signature and metrics.
Each rank calls the step with its block of the global batch
(:func:`~avr_tpu_torch.parallel.mesh.shard_train_inputs`) and runs the
port's own :func:`~avr_tpu_torch.training.step.loss_and_grads` on it, its
kernels (K1–K3 forward and backward, K7 under ``rng_mode="legacy"``) on
the block's shapes.  The loss, the gradients and the BatchNorm running
statistics then go into one flat bucket for one all-reduce (a sum, divided
by the number of ranks on every rank: gloo has no average, and one sum
order gives every rank the same bits), and
:func:`~avr_tpu_torch.training.step.apply_gradients` runs on every rank, so
parameters, Adam's moments and the EMA stay bitwise replicated.  The
non-finite skip sees the reduced gradients, so every rank skips together.

* :func:`make_shardmap_train_step` (JAX's ``shard_map`` step): each rank's
  BatchNorm normalises over its own scenes; ``"per_ray"`` seeds hash the
  block's global ray ids (the single-device stream), and a ``"legacy"`` key
  is ``fold_in(key, data_index * rays_size + rays_index)`` (decorrelated
  draws of the block's shape, not the single-device ones).
* :func:`make_sharded_train_step` (JAX's GSPMD step, the single-device
  program partitioned): ``"per_ray"`` as above, a ``"legacy"`` key draws the
  global batch's stream and keeps the block, so both streams are the
  single-device step's; and BatchNorm normalises with the global batch's
  moments (a differentiable mean, forward and backward: over the ``data``
  axis for the encoder's, over the whole mesh for the decoder's
  ``--bn``), as XLA's partitioning of JAX's step does.  Up to summation
  order it is the single-device step.

The running statistics are averaged over the mesh after the step: under
``shard_map`` that is JAX's ``pmean`` of each rank's statistics; under GSPMD
the ranks' statistics are already the global ones, and the mean keeps them
bitwise equal.  On a mesh of one rank every reduction is exact and each
flavour is ``make_train_step`` bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from avr_tpu_torch.models.resnet import batch_moments
from avr_tpu_torch.models.wrapper import RadFieldRenderer
from avr_tpu_torch.ops import threefry
from avr_tpu_torch.parallel.mesh import Mesh
from avr_tpu_torch.training.loss import LossParams
from avr_tpu_torch.training.state import Optimizer, TrainState, global_norm
from avr_tpu_torch.training.step import RNG_MODES, apply_gradients, loss_and_grads

__all__ = ["make_sharded_train_step", "make_shardmap_train_step", "replicate_state",
           "mean_over_mesh", "state_tensors"]


def _buckets(tensors: List[torch.Tensor]):
    """The tensors' positions, grouped by (device, dtype)."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return groups.values()


def mean_over_mesh(tensors: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean of each tensor over the mesh's ranks: the tensors flattened
    into one bucket (one for each dtype), one all-reduce (sum), divided by
    the number of ranks.  Without a process group, the tensors themselves."""
    if not mesh.grouped:
        return list(tensors)
    out: List[torch.Tensor] = [None] * len(tensors)
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat = flat / mesh.size
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of the train state: step, parameters, BatchNorm
    statistics, Adam's count, moments and skip count, the EMA."""
    o = state.opt_state
    ts = [state.step, *state.params.values(), *state.batch_stats.values(), o.count,
          *o.mu.values(), *o.nu.values(), o.total_notfinite]
    return ts + list((state.ema_params or {}).values())


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Every rank's state set, in place, to rank 0's (one broadcast a
    bucket); the same state object is returned."""
    if not mesh.grouped:
        return state
    ts = state_tensors(state)
    with torch.no_grad():
        for idx in _buckets(ts):
            flat = torch.cat([ts[i].detach().reshape(-1) for i in idx])
            dist.broadcast(flat, 0)
            for i, part in zip(idx, flat.split([ts[i].numel() for i in idx])):
                ts[i].copy_(part.view(ts[i].shape))
    return state


class _MeanOverGroup(torch.autograd.Function):
    """The mean of a tensor over a process group's ranks, differentiable:
    its backward is the same mean of the cotangents (each rank's loss reads
    the mean of every rank's input)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def _mean_moments(group, n: int):
    def reduce(moments):
        both = _MeanOverGroup.apply(torch.stack(moments), group, n)
        return both[0], both[1]

    return reduce


def _partitioned_moments(mesh: Mesh):
    """BatchNorm's moment reductions, or ``None`` where there is nothing to
    reduce: the encoder's over the ``data`` axis (the ranks that hold the
    global batch's scenes between them), the decoder's over the whole mesh
    (every rank holds a block of the global batch's points)."""
    if not mesh.grouped or mesh.size == 1:
        return None
    images = (_mean_moments(mesh.data_group, mesh.shape[mesh.axis_names[0]])
              if mesh.data_group is not None else None)
    return batch_moments(images, points=_mean_moments(dist.group.WORLD, mesh.size))


def _make(model: RadFieldRenderer, optimizer: Optimizer, loss_params: LossParams, mesh: Mesh,
          ema_decay: float, rng_mode: str, partitioned: bool) -> Callable:
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r}")

    def step(state: TrainState, src_images, src_poses, focal, c, model_input, gt, key):
        block = mesh.block(*gt.shape[:2])
        if rng_mode == "legacy" and not partitioned:
            key, block = threefry.fold_in(threefry.Key(*key), mesh.rank), None
        sync = _partitioned_moments(mesh) if partitioned else None
        with sync or contextlib.nullcontext():
            loss, grads = loss_and_grads(model, state.params, loss_params, src_images,
                                         src_poses, focal, c, model_input, gt, key,
                                         rng_mode=rng_mode, block=block)
        names, stats = list(grads), list(state.batch_stats.values())
        reduced = mean_over_mesh([loss, *grads.values(), *stats], mesh)
        loss, grads = reduced[0], dict(zip(names, reduced[1:1 + len(names)]))
        with torch.no_grad():
            for s, m in zip(stats, reduced[1 + len(names):]):
                if m is not s:
                    s.copy_(m)
        grad_norm = global_norm(grads)
        state = apply_gradients(state, grads, optimizer, ema_decay, grad_norm)
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "notfinite": state.opt_state.total_notfinite}

    return step


def make_shardmap_train_step(model: RadFieldRenderer, optimizer: Optimizer,
                             loss_params: LossParams, mesh: Mesh, ema_decay: float = 0.999,
                             rng_mode: str = "per_ray") -> Callable:
    """JAX's ``shard_map`` step (module docstring)::

        state, metrics = step(state, src_images, src_poses, focal, c,
                              model_input, gt, key)

    each argument this rank's block (``shard_train_inputs``), ``key`` the
    step's threefry key, the same on every rank; metrics ``loss``,
    ``grad_norm`` and ``notfinite``, the same on every rank."""
    return _make(model, optimizer, loss_params, mesh, ema_decay, rng_mode, partitioned=False)


def make_sharded_train_step(model: RadFieldRenderer, optimizer: Optimizer,
                            loss_params: LossParams, mesh: Mesh, ema_decay: float = 0.999,
                            rng_mode: str = "per_ray") -> Callable:
    """JAX's GSPMD step, the single-device program partitioned (module
    docstring); called as :func:`make_shardmap_train_step`."""
    return _make(model, optimizer, loss_params, mesh, ema_decay, rng_mode, partitioned=True)
