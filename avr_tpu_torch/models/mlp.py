"""Latent-conditioned FC-ResNet decoder (port of ``avr_tpu/models/mlp.py``
``ResnetFC``, the configuration the fused kernel covers: ReLU, no
BatchNorm, additive latent injection, average pooling over source views).

The module owns the parameters (``nn.Linear`` layout, names as in the Flax
tree); the computation, positional-encoding prologue and output epilogue
included, is the K2 kernel wrapper
(:func:`avr_tpu_torch.ops.kernels.resnetfc.fused_resnetfc`), whose plain
version runs for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from avr_tpu_torch.ops.kernels.resnetfc import CodeSpec, DecoderWeights, fused_resnetfc

__all__ = ["ResnetBlockFC", "ResnetFC"]


class ResnetBlockFC(nn.Module):
    """Pre-activation 2-linear residual block: ``h + fc_1(relu(fc_0(relu(h))))``."""

    def __init__(self, size: int):
        super().__init__()
        self.fc_0 = nn.Linear(size, size)
        self.fc_1 = nn.Linear(size, size)


class ResnetFC(nn.Module):
    """``n_blocks`` residual blocks, latent injection before the first
    ``min(combine_layer, n_blocks)``, mean over source views after them.

    ``d_in`` is ``lin_in``'s width: the encoded width when ``code_spec`` is
    set (the module then takes the raw ``code_spec.d_raw`` lanes).
    ``stash`` picks the kernels' backward (``fused_resnetfc``'s argument).
    """

    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5, d_latent: int = 512,
                 d_hidden: int = 128, combine_layer: int = 1000,
                 code_spec: Optional[CodeSpec] = None, activate_out: bool = False,
                 dtype: torch.dtype = torch.float32, stash: Union[bool, str] = "auto"):
        super().__init__()
        if code_spec is not None and code_spec.d_enc != d_in:
            raise ValueError(f"code_spec encodes to {code_spec.d_enc} lanes, d_in is {d_in}")
        self.n_blocks = n_blocks
        self.n_lin_z = min(combine_layer, n_blocks)
        self.code_spec, self.activate_out, self.dtype = code_spec, activate_out, dtype
        self.stash = stash
        self.lin_in = nn.Linear(d_in, d_hidden)
        self.lin_z = nn.ModuleList(nn.Linear(d_latent, d_hidden) for _ in range(self.n_lin_z))
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden) for _ in range(n_blocks))
        self.lin_out = nn.Linear(d_hidden, d_out)

    def weights(self) -> DecoderWeights:
        stack = lambda mods, attr: torch.stack([getattr(m, attr) for m in mods])
        fc0 = [b.fc_0 for b in self.blocks]
        fc1 = [b.fc_1 for b in self.blocks]
        return DecoderWeights(
            self.lin_in.weight, self.lin_in.bias,
            stack(self.lin_z, "weight"), stack(self.lin_z, "bias"),
            stack(fc0, "weight"), stack(fc0, "bias"),
            stack(fc1, "weight"), stack(fc1, "bias"),
            self.lin_out.weight, self.lin_out.bias,
        )

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """``x (SB, NS, B, d)``, ``z (SB, NS, B, d_latent)`` -> ``(SB, B, d_out)``
        float32."""
        SB, NS, B, _ = x.shape
        xt = x.transpose(0, 1).reshape(NS, SB * B, x.shape[-1])
        zt = z.transpose(0, 1).reshape(NS, SB * B, z.shape[-1])
        out = fused_resnetfc(xt, zt, self.weights(), n_blocks=self.n_blocks,
                             n_lin_z=self.n_lin_z, compute_dtype=self.dtype,
                             code=self.code_spec, activate_out=self.activate_out,
                             stash=self.stash)
        return out.reshape(SB, B, -1)
