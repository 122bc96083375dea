"""Plain MLP decoder, the ``type = mlp`` path (port of
``avr_tpu/models/implicit.py`` ``ImplicitNet``).

A stack of ``n_layers`` linears (``lin_0`` ..., Kaiming-initialised) on
the latent concatenated before the point feature, the activation between
them, the input re-injected at the ``skip_in`` layers (``[h, input] /
sqrt(2)``), and the source views pooled by ``combine_type`` at
``combine_layer`` (the input too, for later skips) or after the last layer.
JAX runs it through XLA, with no TPU kernel: plain PyTorch here, on the
card too.  The interface is :class:`~avr_tpu_torch.models.mlp.ResnetFC`'s:
``(x, z, train)`` with ``(SB, NS, B, d)`` inputs, ``(SB, B, d_out)`` out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avr_tpu_torch.models.mlp import activation, combine

__all__ = ["ImplicitNet"]


class ImplicitNet(nn.Module):
    def __init__(self, d_in: int, d_out: int = 4, n_layers: int = 8, d_hidden: int = 256,
                 d_latent: int = 0, skip_in: Sequence[int] = (4,), beta: float = 0.0,
                 combine_layer: int = 1000, combine_type: str = "average",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.skip_in = n_layers, tuple(skip_in)
        self.beta, self.combine_layer, self.combine_type = beta, combine_layer, combine_type
        self.dtype = dtype
        d_inp = d_in + d_latent
        width = d_inp
        for i in range(n_layers):
            if i in self.skip_in and i > 0:
                width += d_inp
            out = d_out if i == n_layers - 1 else d_hidden
            setattr(self, f"lin_{i}", nn.Linear(width, out))
            width = out

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        cd = self.dtype
        act = activation(self.beta)
        inp = (x if z is None else torch.cat([z.to(x.dtype), x], dim=-1)).to(cd)
        h = inp
        combined = False
        for i in range(self.n_layers):
            if i == self.combine_layer:
                h = combine(h, self.combine_type)
                inp = combine(inp, self.combine_type)
                combined = True
            if i in self.skip_in and i > 0:
                h = torch.cat([h, inp], dim=-1) / math.sqrt(2.0)
            lin = getattr(self, f"lin_{i}")
            h = F.linear(h, lin.weight.to(cd), lin.bias.to(cd))
            if i < self.n_layers - 1:
                h = act(h)
        if not combined:
            h = combine(h, self.combine_type)
        return h
