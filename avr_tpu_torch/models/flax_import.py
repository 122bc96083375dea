"""Carry weights between the JAX package and the port, both ways.

:func:`load_flax_variables` takes the Flax ``RadFieldRenderer`` variables
(``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays —
the caller converts the JAX tree; this module imports no JAX) and fills the
port's modules in place.  The inverse of ``avr_tpu/models/torch_import.py``:

  * ``nn.Dense`` kernels ``(in, out)`` -> ``nn.Linear`` weights ``(out, in)``,
  * convolution kernels HWIO -> OIHW; the custom encoder's transposed
    convolutions (``deconv*``) HWIO -> ``nn.ConvTranspose2d``'s ``(in, out,
    kh, kw)`` flipped spatially (Flax's ``ConvTranspose`` does not flip its
    kernel, PyTorch's does),
  * BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats),
  * LSTM ``w_ih (C, 4H)``, ``w_hh (H, 4H)``, ``b_ih``, ``b_hh`` as they are,
  * ``out_layer`` and the decoders' ``lin_in``, ``lin_z_k``, ``scale_z_k``,
    ``block_k/fc_0|fc_1``, ``block_k/bn_0``, ``lin_out`` (ImplicitNet's
    ``lin_k``), and the global encoder's ``fc``, Dense kernels and biases.

A leaf missing on either side is an error, named.  :func:`to_flax_variables`
is the inverse: the port's parameters and BatchNorm statistics as the
Flax-named numpy tree, and :func:`to_flax_tree` maps any tensors named like
the port's parameters (gradients, Adam moments) the same way;
:func:`from_flax_tree` maps such a Flax tree back to tensors keyed by the
port's names.  GroupNorm's ``scale`` and ``bias`` are parameters like
BatchNorm's; the "group", "instance" and "none" norms have no
``batch_stats``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_variables", "to_flax_variables", "to_flax_tree", "from_flax_tree"]

_STATS = ("mean", "var")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _flax_path(name: str) -> Tuple[str, ...]:
    """Port state-dict name -> Flax variables path."""
    name = re.sub(r"(^|\.)stages\.", r"\1", name)
    name = re.sub(r"(^|\.)(lin_z|scale_z)\.(\d+)\.", r"\1\2_\3.", name)
    name = re.sub(r"(^|\.)blocks\.(\d+)\.", r"\1block_\2.", name)
    *mods, leaf = name.split(".")
    if leaf in _STATS:
        return ("batch_stats", *mods, leaf)
    return ("params", *mods, "kernel" if leaf == "weight" else leaf)


def _deconv(name: str) -> bool:
    """A transposed convolution's weight (``models/encoder.py ConvTranspose``)."""
    return re.search(r"(^|\.)deconv[^.]*\.weight$", name) is not None


def _convert(value: np.ndarray, target: torch.Tensor, name: str) -> np.ndarray:
    value = np.array(value, np.float32)
    leaf = name.rsplit(".", 1)[-1]
    if _deconv(name):
        value = np.transpose(value, (2, 3, 0, 1))[:, :, ::-1, ::-1]  # HWIO -> IOHW, flipped
    elif leaf == "weight" and target.ndim == 4:
        value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    elif leaf == "weight":
        value = value.T  # Dense (in, out) -> Linear (out, in)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"shape mismatch: {tuple(value.shape)} vs {tuple(target.shape)}")
    return value


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``model`` (a :class:`~avr_tpu_torch.models.wrapper.RadFieldRenderer`,
    or any of its submodules given the matching subtree) from the Flax
    variables tree; returns the model."""
    flat = _flatten(variables)
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    used, missing = set(), []
    with torch.no_grad():
        for name, target in targets.items():
            path = _flax_path(name)
            if path not in flat:
                missing.append(f"{name} (flax {'/'.join(path)})")
                continue
            try:
                value = _convert(flat[path], target, name)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
            target.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            used.add(path)
    extra = sorted("/".join(p) for p in set(flat) - used)
    if missing or extra:
        raise KeyError(f"flax variables do not match the port: missing {missing}, "
                       f"unused {extra}")
    return model


def from_flax_tree(model: nn.Module, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax-named tree of arrays (``{"params": ...}``, e.g. a gradient or
    an Adam moment; ``"batch_stats"`` too where given) -> float32 tensors
    keyed by ``model``'s parameter (and buffer) names, in the port's
    layouts, on the model's device."""
    flat = _flatten(tree)
    targets = dict(model.named_parameters())
    if "batch_stats" in tree:
        targets.update(model.named_buffers())
    out = {}
    for name, target in targets.items():
        path = _flax_path(name)
        if path not in flat:
            raise KeyError(f"{name} (flax {'/'.join(path)}) is not in the tree")
        value = _convert(flat[path], target, name)
        out[name] = torch.from_numpy(np.ascontiguousarray(value)).to(target.device)
    return out


def _to_flax(value: torch.Tensor, name: str) -> np.ndarray:
    a = np.array(value.detach().float().cpu().numpy())  # a copy, not a view
    leaf = name.rsplit(".", 1)[-1]
    if _deconv(name):
        return np.ascontiguousarray(np.transpose(a[:, :, ::-1, ::-1], (2, 3, 0, 1)))
    if leaf == "weight" and a.ndim == 4:
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))  # OIHW -> HWIO
    if leaf == "weight":
        return np.ascontiguousarray(a.T)  # Linear (out, in) -> Dense (in, out)
    return a


def to_flax_tree(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed by the port's parameter or buffer names -> the nested
    Flax variables tree (``{"params": ..., "batch_stats": ...}``) of numpy
    arrays, in the Flax layouts."""
    tree: Dict[str, Any] = {}
    for name, value in tensors.items():
        *mods, leaf = _flax_path(name)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = _to_flax(value, name)
    return tree


def to_flax_variables(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters and BatchNorm statistics as the Flax
    variables tree that :func:`load_flax_variables` reads."""
    return to_flax_tree({**dict(model.named_parameters()), **dict(model.named_buffers())})
