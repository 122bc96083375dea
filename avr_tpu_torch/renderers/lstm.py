"""LSTM cell parameters for the ray-marcher (port of
``avr_tpu/renderers/lstm.py`` ``MarchLSTMCell``).

torch ``nn.LSTMCell`` semantics with gate order (i, f, g, o), weights
stored transposed as in the Flax tree: ``w_ih (C, 4H)``, ``w_hh (H, 4H)``,
``b_ih``/``b_hh (4H,)``.  The step itself runs inside the march kernel
(:mod:`avr_tpu_torch.ops.kernels.march`), which takes the combined bias.

:func:`clamp_grad` is the reference's hidden-state gradient hook
(``register_hook(lambda x: x.clamp(-10, 10))``) as an identity whose
backward clips the cotangent, as ``avr_tpu/renderers/lstm.py:31-45``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["MarchLSTMCell", "clamp_grad"]


class _ClampGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.limit, ctx.limit), None


def clamp_grad(x: torch.Tensor, limit: float = 10.0) -> torch.Tensor:
    """Identity whose cotangent is clipped elementwise to ``[-limit, limit]``."""
    return _ClampGrad.apply(x, float(limit))


class MarchLSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden_size))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden_size))

    def fused_bias(self) -> torch.Tensor:
        return self.b_ih + self.b_hh
