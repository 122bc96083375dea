"""Numerical debugging helpers (port of ``avr_tpu/utils/debug.py``).

The reference's tools are ``torch.autograd.set_detect_anomaly`` and a
NaN->1e-6 loss guard.  Here:

  * :func:`enable_nan_debugging` turns on autograd's anomaly mode: a
    backward that produces NaN raises and names the forward op that made
    it (JAX's ``jax_debug_nans``; the CLI's ``--anomaly_detection``);
  * :func:`checked` wraps a function so a NaN or inf in any floating-point
    tensor it returns raises, the counterpart of JAX's ``checkify`` float
    checks (out-of-bounds indexing already raises in PyTorch).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

__all__ = ["enable_nan_debugging", "checked"]


def enable_nan_debugging(enabled: bool = True) -> None:
    """Autograd's anomaly detection on (or off) for the whole process."""
    torch.autograd.set_detect_anomaly(enabled)


def _tensors(tree: Any, path: str = "out"):
    """``(path, tensor)`` for every tensor in nested tuples, lists, dicts and
    dataclass-like namedtuples."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}.{fields[i]}" if fields else f"{path}[{i}]")


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so a non-finite value in a floating-point tensor of its
    result raises ``FloatingPointError`` naming where it is::

        safe_step = checked(train_step)
        state, metrics = safe_step(state, ...)   # raises on NaN/inf

    The check reads one flag a tensor back to the host, so it waits for the
    device."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"{getattr(fn, '__name__', 'fn')}: non-finite value "
                                         f"(NaN or inf) in {path}")
        return out

    return wrapper
