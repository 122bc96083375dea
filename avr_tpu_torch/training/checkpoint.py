"""Checkpoint save/restore (port of ``avr_tpu/training/checkpoint.py``).

The paths follow JAX's epoch-tagged naming,
``{root}/checkpoints/experiments/{name}_epoch{e}`` and ``{name}_best``; each
is one file written by ``torch.save`` (JAX writes an Orbax directory there).
The payload is the whole :class:`TrainState`: the step, the parameters, the
BatchNorm statistics, the EMA when kept and, with ``include_opt_state``,
Adam's count, moments and the non-finite skip count, so a resume is exact.
It is read back with ``torch.load(weights_only=True)`` onto the template's
device.

Restore follows JAX's rules:

* a missing file warns and keeps the template, unless ``strict``;
* an optimizer state that does not match the template's (another
  optimizer, or none saved) restores the rest and keeps the template's
  fresh optimizer state, with a warning;
* parameters or BatchNorm statistics whose names or shapes do not match
  the model raise;
* a checkpoint saved without an EMA seeds the template's EMA from the
  restored parameters.

:func:`restore_checkpoint` returns a **new** :class:`TrainState`, as JAX's
``state.replace`` does.  Its ``params`` and ``batch_stats`` are still the
model's own tensors (the restored values are copied into them, so their
version counters move); the step, the optimizer state and the EMA are new
tensors.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import torch

from avr_tpu_torch.training.state import AdamState, TrainState

__all__ = ["checkpoint_path", "save_checkpoint", "restore_checkpoint"]

Tensors = Dict[str, torch.Tensor]


def checkpoint_path(root_dir: str, name: str, epoch) -> str:
    """Epoch-tagged checkpoint path.  ``epoch`` is an int for the regular
    per-epoch saves, or the string ``"best"`` for the best-val checkpoint
    ``{name}_best``."""
    tag = f"epoch{epoch}" if not isinstance(epoch, str) else epoch
    return os.path.join(os.path.abspath(root_dir), "checkpoints", "experiments",
                        f"{name}_{tag}")


def _host(tensors: Tensors) -> Tensors:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def save_checkpoint(root_dir: str, name: str, epoch, state: TrainState,
                    include_opt_state: bool = True) -> str:
    """Save a train state; returns the checkpoint's path.  The file is
    written beside its path and moved into place, so a reader never sees a
    partial file."""
    path = checkpoint_path(root_dir, name, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "step": state.step.detach().cpu(),
        "params": _host(state.params),
        "batch_stats": _host(state.batch_stats or {}),
    }
    if state.ema_params is not None:
        payload["ema_params"] = _host(state.ema_params)
    if include_opt_state:
        o = state.opt_state
        payload["opt_state"] = {"count": o.count.detach().cpu(), "mu": _host(o.mu),
                                "nu": _host(o.nu),
                                "total_notfinite": o.total_notfinite.detach().cpu()}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _matches(got: Optional[Tensors], want: Tensors) -> bool:
    return (isinstance(got, dict) and got.keys() == want.keys()
            and all(isinstance(got[k], torch.Tensor) and got[k].shape == want[k].shape
                    for k in want))


def _opt_state(raw, template: AdamState, dev) -> Optional[AdamState]:
    """The saved optimizer state if it has the template's structure."""
    if not isinstance(raw, dict) or set(raw) != {"count", "mu", "nu", "total_notfinite"}:
        return None
    if not (_matches(raw["mu"], template.mu) and _matches(raw["nu"], template.nu)):
        return None
    to = lambda d: {k: v.to(dev) for k, v in d.items()}
    return AdamState(raw["count"].to(dev, torch.int32), to(raw["mu"]), to(raw["nu"]),
                     raw["total_notfinite"].to(dev, torch.int32))


def restore_checkpoint(root_dir: str, name: str, epoch, state: TrainState,
                       strict: bool = False) -> TrainState:
    """Restore into a template state (module docstring for the rules)."""
    path = checkpoint_path(root_dir, name, epoch)
    if not os.path.exists(path):
        if strict:
            raise FileNotFoundError(path)
        warnings.warn(f"{path} does not exist, not loaded!! Model stays initialized.")
        return state
    dev = state.step.device
    raw = torch.load(path, map_location=dev, weights_only=True)
    for piece in ("params", "batch_stats"):
        want = getattr(state, piece) or {}
        got = raw.get(piece) or {}
        if want and not _matches(got, want):
            shapes = lambda d: {k: tuple(v.shape) for k, v in d.items()}
            raise ValueError(
                f"{path}: checkpoint {piece!r} structure does not match the model "
                f"(checkpoint {shapes(got)} vs template {shapes(want)}) — wrong "
                "model/config for this checkpoint?")
    opt = _opt_state(raw.get("opt_state"), state.opt_state, dev)
    if opt is None:
        warnings.warn(
            f"{path}: optimizer state structure does not match the template (different "
            "optimizer or checkpoint saved without opt state); restoring "
            "params/batch_stats/step and keeping a fresh optimizer init.")
        opt = state.opt_state
    with torch.no_grad():
        for piece in ("params", "batch_stats"):
            for k, t in (getattr(state, piece) or {}).items():
                t.copy_(raw[piece][k])
    ema = None
    if state.ema_params is not None:
        # EMA requested but the checkpoint predates it: seed the average
        # from the restored params rather than keeping the template's init
        src = raw.get("ema_params")
        if not _matches(src, state.ema_params):
            src = state.params
        ema = {k: v.detach().to(dev).clone() for k, v in src.items()}
    return TrainState(step=raw["step"].to(dev, torch.int32), params=state.params,
                      batch_stats=state.batch_stats, opt_state=opt, ema_params=ema)
