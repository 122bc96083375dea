"""ResNet backbone trunk for the pixel-aligned encoder (port of
``avr_tpu/models/resnet.py``).

NCHW inside (PyTorch's convolution layout); parameters are float32 and cast
to the compute dtype at use.  Padding is explicit ``(1, 1)`` for 3x3,
``(3, 3)`` for the 7x7 stem, and the stem's max-pool pads with -inf, as the
Flax trunk does.  The norm is picked by ``norm_type``, as JAX's
``make_norm``: ``"batch"`` (:class:`BatchNorm`: the running statistics, or
with ``train=True`` the batch statistics, updating the running ones),
``"group"`` (:class:`GroupNorm`, 32 groups), ``"instance"`` (one channel a
group, no scale and no bias) and ``"none"`` (the identity).  Module and
parameter names follow the Flax tree so weights carry across by name
(``models/flax_import.py``).  The convolutions stay cuDNN's: the JAX
package has no Pallas kernel here.

Inside :func:`batch_moments` train-mode BatchNorm reduces its batch moments
with other ranks' (the partitioned step of ``parallel/sharded_step.py``,
whose statistics are the global batch's, as XLA's partitioning of JAX's
step makes them): the encoder's over the ranks that share the images, the
decoder's (``models/mlp.py PointBatchNorm``) over those that share the
points.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNetTrunk", "RESNET_STAGES", "BatchNorm", "GroupNorm", "Conv", "make_norm",
           "batch_moments"]

Moments = Tuple[torch.Tensor, torch.Tensor]
Reduce = Callable[[Moments], Moments]
# reduces train-mode BatchNorm's (mean, E[x^2]) over other batches, by what
# the norm normalises ("images" or "points"); absent: this batch's own
_reduce_moments: Dict[str, Reduce] = {}


@contextlib.contextmanager
def batch_moments(reduce: Optional[Reduce],
                  points: Optional[Reduce] = None) -> Iterator[None]:
    """Within the block, every train-mode :class:`BatchNorm` normalises with
    ``reduce((mean, mean_sq))`` of its batch's float32 per-channel moments
    (a differentiable mean over ranks: the global batch's moments when the
    ranks' batches are equal in size), and updates its running statistics
    with them; a BatchNorm over points (``over = "points"``) with
    ``points``.  ``None`` keeps a batch's own moments."""
    global _reduce_moments
    prev = _reduce_moments
    _reduce_moments = {k: r for k, r in (("images", reduce), ("points", points)) if r}
    try:
        yield
    finally:
        _reduce_moments = prev

# (blocks per stage, channels per stage)
RESNET_STAGES = {
    "resnet18": ((2, 2, 2, 2), (64, 128, 256, 512)),
    "resnet34": ((3, 4, 6, 3), (64, 128, 256, 512)),
}


class Conv(nn.Module):
    """Bias-free convolution; ``weight`` is OIHW float32, run in the input's dtype."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, pad: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.stride, self.pad = stride, pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=self.pad)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32 (Flax's
    normalization order), result in the input's dtype.

    ``train=True`` normalises with the batch mean and the **biased**
    variance ``E[x^2] - E[x]^2`` over (N, H, W) (clipped at 0, Flax's
    ``use_fast_variance``), and updates the running statistics in place:
    ``stat <- 0.9 * stat + 0.1 * batch_stat``.  (``F.batch_norm`` would
    store the unbiased variance.)
    """

    momentum = 0.9
    # what a batch holds: "images", or "points" (the decoder's)
    over = "images"

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        view = lambda t: t.view(1, -1, 1, 1)
        xf = x.float()
        if train:
            mean, sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
            reduce = _reduce_moments.get(self.over)
            if reduce is not None:
                mean, sq = reduce((mean, sq))
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - view(mean)) * view(mul) + view(self.bias)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` on NCHW: the statistics of each sample's group
    of channels over (channels of the group, H, W), in float32 whatever the
    input's dtype, the variance ``E[x^2] - E[x]^2`` clipped at 0 (Flax's
    ``use_fast_variance``; ``F.group_norm`` takes ``E[(x - mean)^2]``), then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, the result
    in the input's dtype.  ``epsilon`` 1e-6, Flax's default (BatchNorm's is
    1e-5).  ``affine=False`` has no ``scale`` and no ``bias`` (the
    ``"instance"`` norm).  ``train`` is accepted and ignored: the
    statistics are the input's in both modes."""

    def __init__(self, c: int, num_groups: int, eps: float = 1e-6, affine: bool = True):
        super().__init__()
        if num_groups <= 0 or c % num_groups:
            raise ValueError(f"Number of groups ({num_groups}) does not divide the number "
                             f"of channels ({c}).")
        self.num_groups, self.eps = num_groups, eps
        if affine:
            self.scale = nn.Parameter(torch.ones(c))
            self.bias = nn.Parameter(torch.zeros(c))
        else:
            self.scale = self.bias = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        N, C, H, W = x.shape
        G = self.num_groups
        # each group's statistics in one reduction over its contiguous
        # (C / G, H, W) block, applied by broadcasting
        xg = x.float().reshape(N, G, C // G, H, W)
        flat = xg.reshape(N, G, -1)
        mean = flat.mean(dim=2)
        var = torch.clamp((flat * flat).mean(dim=2) - mean * mean, min=0.0)
        mean = mean[:, :, None, None, None]
        mul = torch.rsqrt(var + self.eps)[:, :, None, None, None]
        if self.scale is not None:
            mul = mul * self.scale.view(1, G, C // G, 1, 1)
        y = (xg - mean) * mul
        if self.bias is not None:
            y = y + self.bias.view(1, G, C // G, 1, 1)
        return y.reshape(N, C, H, W).to(x.dtype)


class Identity(nn.Module):
    """The ``"none"`` norm."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x


def make_norm(norm_type: str):
    """``c -> norm module`` for ``norm_type`` (JAX's ``make_norm``,
    ``avr_tpu/models/resnet.py:39-59``)."""
    if norm_type == "batch":
        return BatchNorm
    if norm_type == "group":
        return lambda c: GroupNorm(c, 32)
    if norm_type == "instance":
        return lambda c: GroupNorm(c, c, affine=False)
    if norm_type == "none":
        return lambda c: Identity()
    raise NotImplementedError(f"normalization layer [{norm_type}] is not found")


class BasicBlock(nn.Module):
    """3x3-3x3 residual block with optional strided 1x1 projection."""

    def __init__(self, c_in: int, c_out: int, stride: int, norm_type: str = "batch"):
        super().__init__()
        norm = make_norm(norm_type)
        self.conv1 = Conv(c_in, c_out, 3, stride, 1)
        self.bn1 = norm(c_out)
        self.conv2 = Conv(c_out, c_out, 3, 1, 1)
        self.bn2 = norm(c_out)
        if stride != 1 or c_in != c_out:
            self.down_conv = Conv(c_in, c_out, 1, stride, 0)
            self.down_bn = norm(c_out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x), train)
        return torch.relu(y + x)


class ResNetTrunk(nn.Module):
    """Stem + the first ``num_layers - 1`` residual stages; returns every
    stage's feature map (NCHW), ``num_layers=4`` giving 64+64+128+256 = 512
    channels in all."""

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 use_first_pool: bool = True, norm_type: str = "batch"):
        super().__init__()
        blocks, channels = RESNET_STAGES[backbone]
        self.num_layers, self.use_first_pool = num_layers, use_first_pool
        self.conv1 = Conv(3, 64, 7, 2, 3)
        self.bn1 = make_norm(norm_type)(64)
        self.stages = nn.ModuleDict()
        c_in = 64
        for stage in range(num_layers - 1):
            for blk in range(blocks[stage]):
                stride = 2 if (stage > 0 and blk == 0) else 1
                self.stages[f"layer{stage + 1}_block{blk}"] = BasicBlock(
                    c_in, channels[stage], stride, norm_type)
                c_in = channels[stage]
        self.blocks_per_stage = blocks

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x), train))
        feats = [x]
        for stage in range(self.num_layers - 1):
            if stage == 0 and self.use_first_pool:
                x = F.max_pool2d(x, 3, stride=2, padding=1)
            for blk in range(self.blocks_per_stage[stage]):
                x = self.stages[f"layer{stage + 1}_block{blk}"](x, train)
            feats.append(x)
        return feats

    @staticmethod
    def latent_size(backbone: str, num_layers: int) -> int:
        return 64 + sum(RESNET_STAGES[backbone][1][: num_layers - 1])
