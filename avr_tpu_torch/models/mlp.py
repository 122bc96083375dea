"""Latent-conditioned FC-ResNet decoder (port of ``avr_tpu/models/mlp.py``
``ResnetFC``).

The module owns the parameters (``nn.Linear`` layout, names as in the Flax
tree).  It takes JAX's route: where JAX's ``_use_fused`` would run the
fused kernel (``supports`` below: ReLU, no BatchNorm, additive latent
injection, a latent and an input, the hidden width a multiple of 128,
average pooling when there are several views), the computation, the
positional-encoding prologue and output epilogue included, is the K2
kernel wrapper (:func:`avr_tpu_torch.ops.kernels.resnetfc.fused_resnetfc`,
whose plain version runs for CPU tensors).  Every other configuration is
JAX's XLA path, with no TPU kernel to port: plain PyTorch here, on the card
too.  Its options: a BatchNorm (``bn``) shared by both linears of a block,
softplus ``beta``, SPADE injection (``use_spade``: ``scale_z_k(z) * h +
lin_z_k(z)``), ``combine_type = "max"``, no input (``d_in = 0``) and no
latent (``z is None`` or ``d_latent = 0``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from avr_tpu_torch.models.resnet import BatchNorm
from avr_tpu_torch.ops.kernels.resnetfc import (CodeSpec, DecoderWeights, encode_features,
                                                fused_resnetfc)

__all__ = ["ResnetBlockFC", "ResnetFC", "supports", "activation", "combine",
           "PointBatchNorm"]


def supports(*, n_blocks: int, n_lin_z: int, d_hidden: int, d_latent: int, d_in: int,
             bn: bool, beta: float, ns: int = 1, combine_type: str = "average") -> bool:
    """Whether the fused kernel covers a decoder configuration: JAX's
    ``avr_tpu/ops/pallas/resnetfc.py supports``, the same conditions."""
    return (not bn and beta <= 0.0 and d_in > 0 and d_latent > 0 and d_hidden % 128 == 0
            and 0 < n_lin_z <= n_blocks and (ns == 1 or combine_type == "average"))


def activation(beta: float):
    """ReLU, or for ``beta > 0`` ``softplus(beta * x) / beta``."""
    if beta > 0:
        return lambda x: F.softplus(beta * x) / beta
    return torch.relu


def combine(x: torch.Tensor, combine_type: str, dim: int = 1) -> torch.Tensor:
    """Pool the source-view axis: ``"average"`` or ``"max"``."""
    if combine_type == "average":
        return x.mean(dim=dim)
    if combine_type == "max":
        return x.amax(dim=dim)
    raise NotImplementedError(f"Unsupported combine type {combine_type}")


class PointBatchNorm(BatchNorm):
    """Flax ``nn.BatchNorm`` over every axis but the last (channels-last
    points ``(..., C)``): :class:`~avr_tpu_torch.models.resnet.BatchNorm`
    on the points as ``(M, C, 1, 1)``.  Inside ``batch_moments`` its train
    mode reduces its moments with ``points`` (a rank's points are its
    share of the global batch's)."""

    over = "points"

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        C = x.shape[-1]
        return super().forward(x.reshape(-1, C, 1, 1), train).reshape(x.shape)


class ResnetBlockFC(nn.Module):
    """Pre-activation residual block: ``h + fc_1(act(fc_0(act(h))))``; with
    ``bn`` one BatchNorm (``bn_0``) before both linears, its statistics
    updated at each use in train mode, as the Flax block's shared
    ``bn_0``."""

    def __init__(self, size: int, bn: bool = False, beta: float = 0.0):
        super().__init__()
        self.fc_0 = nn.Linear(size, size)
        self.fc_1 = nn.Linear(size, size)
        if bn:
            self.bn_0 = PointBatchNorm(size)
        self.beta = beta

    def forward(self, h: torch.Tensor, train: bool = False) -> torch.Tensor:
        act = activation(self.beta)
        norm = (lambda t: self.bn_0(t, train)) if hasattr(self, "bn_0") else (lambda t: t)
        lin = lambda m, t: F.linear(t, m.weight.to(t.dtype), m.bias.to(t.dtype))
        net = lin(self.fc_0, act(norm(h)))
        return h + lin(self.fc_1, act(norm(net)))


class ResnetFC(nn.Module):
    """``n_blocks`` residual blocks, latent injection before the first
    ``min(combine_layer, n_blocks)``, the source views pooled by
    ``combine_type`` at ``combine_layer`` (after the last block if it is not
    below ``n_blocks``).

    ``d_in`` is ``lin_in``'s width: the encoded width when ``code_spec`` is
    set (the module then takes the raw ``code_spec.d_raw`` lanes); 0 means
    no input (the trunk starts at zero).  ``stash`` picks the kernels'
    backward (``fused_resnetfc``'s argument).
    """

    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5, d_latent: int = 512,
                 d_hidden: int = 128, combine_layer: int = 1000,
                 code_spec: Optional[CodeSpec] = None, activate_out: bool = False,
                 dtype: torch.dtype = torch.float32, stash: Union[bool, str] = "auto",
                 beta: float = 0.0, combine_type: str = "average", use_spade: bool = False,
                 bn: bool = False):
        super().__init__()
        if code_spec is not None and code_spec.d_enc != d_in:
            raise ValueError(f"code_spec encodes to {code_spec.d_enc} lanes, d_in is {d_in}")
        self.n_blocks, self.combine_layer = n_blocks, combine_layer
        self.n_lin_z = min(combine_layer, n_blocks)
        self.d_in, self.d_latent, self.d_hidden = d_in, d_latent, d_hidden
        self.code_spec, self.activate_out, self.dtype = code_spec, activate_out, dtype
        self.stash = stash
        self.beta, self.combine_type, self.use_spade, self.bn = beta, combine_type, use_spade, bn
        if d_in > 0:
            self.lin_in = nn.Linear(d_in, d_hidden)
        n_z = self.n_lin_z if d_latent > 0 else 0
        self.lin_z = nn.ModuleList(nn.Linear(d_latent, d_hidden) for _ in range(n_z))
        if use_spade:
            self.scale_z = nn.ModuleList(nn.Linear(d_latent, d_hidden) for _ in range(n_z))
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden, bn, beta) for _ in range(n_blocks))
        self.lin_out = nn.Linear(d_hidden, d_out)

    def fuses(self, ns: int, has_z: bool = True) -> bool:
        """Whether a call with ``ns`` source views runs the fused kernel:
        JAX's ``_use_fused`` (every ``fused_mlp`` the port takes fuses)."""
        return (not self.use_spade and has_z
                and supports(n_blocks=self.n_blocks, n_lin_z=self.n_lin_z,
                             d_hidden=self.d_hidden, d_latent=self.d_latent, d_in=self.d_in,
                             bn=self.bn, beta=self.beta, ns=ns,
                             combine_type=self.combine_type))

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

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """``x (SB, NS, B, d)``, ``z (SB, NS, B, d_latent)`` or ``None`` ->
        ``(SB, B, d_out)`` (float32 on the fused route, the compute dtype on
        the plain one).  ``train`` puts the blocks' BatchNorm in train
        mode."""
        SB, NS, B, _ = x.shape
        if not self.fuses(NS, z is not None):
            return self._plain(x, z, train)
        xt = x.transpose(0, 1).reshape(NS, SB * B, x.shape[-1])
        zt = z.transpose(0, 1).reshape(NS, SB * B, z.shape[-1])
        out = fused_resnetfc(xt, zt, self.weights(), n_blocks=self.n_blocks,
                             n_lin_z=self.n_lin_z, compute_dtype=self.dtype,
                             code=self.code_spec, activate_out=self.activate_out,
                             stash=self.stash)
        return out.reshape(SB, B, -1)

    def _plain(self, x, z, train):
        """JAX's XLA path (``avr_tpu/models/mlp.py:241-271``), in the compute
        dtype."""
        cd = self.dtype
        lin = lambda m, t: F.linear(t.to(cd), m.weight.to(cd), m.bias.to(cd))
        if self.code_spec is not None:
            x = encode_features(x.float(), self.code_spec)
        if self.d_in > 0:
            h = lin(self.lin_in, x)
        else:
            h = torch.zeros((*z.shape[:-1], self.d_hidden), dtype=cd, device=z.device)
        combined = False
        for k, block in enumerate(self.blocks):
            if k == self.combine_layer:
                h = combine(h, self.combine_type)
                combined = True
            if z is not None and self.d_latent > 0 and k < self.n_lin_z:
                tz = lin(self.lin_z[k], z)
                h = lin(self.scale_z[k], z) * h + tz if self.use_spade else h + tz
            h = block(h, train)
        if not combined:
            h = combine(h, self.combine_type)
        out = lin(self.lin_out, activation(self.beta)(h))
        if self.activate_out:
            out = torch.cat([torch.sigmoid(out[..., :3]), torch.relu(out[..., 3:])], dim=-1)
        return out
