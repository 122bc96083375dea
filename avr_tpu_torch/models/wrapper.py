"""Top-level model: radiance field + adaptive renderer as one ``nn.Module``
(port of ``avr_tpu/models/wrapper.py`` ``RadFieldRenderer``).

``encode`` produces the :class:`Conditioning` once per source view set;
``render`` marches and integrates a ray batch.  Parameter names follow the
Flax tree (``net``, ``lstm``, ``out_layer``) so ``models/flax_import.py``
carries weights across.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
from torch import nn

from avr_tpu_torch.config import Conf, parse_conf
from avr_tpu_torch.models.pixelnerf import Conditioning, ModelConfig, PixelNeRFNet
from avr_tpu_torch.ops.hashrng import RaySeeds
from avr_tpu_torch.renderers.adaptive import render_adaptive
from avr_tpu_torch.renderers.base import AdaptiveRendererConfig, RenderOutput
from avr_tpu_torch.renderers.lstm import MarchLSTMCell
from avr_tpu_torch.renderers.raymarch import lstm_march
from avr_tpu_torch.utils.device import resolve_device

__all__ = ["RadFieldRenderer", "make_model", "init_weights"]

DEFAULT_CONF = os.path.join(os.path.dirname(__file__), "..", "..", "conf", "default_mv.conf")


class RadFieldRenderer(nn.Module):
    def __init__(self, model_cfg: ModelConfig, renderer_cfg: AdaptiveRendererConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.renderer_cfg, self.dtype = renderer_cfg, dtype
        self.net = PixelNeRFNet(model_cfg, dtype)
        self.lstm = MarchLSTMCell(self.net.latent_size, renderer_cfg.hidden_size)
        self.out_layer = nn.Linear(renderer_cfg.hidden_size, 1)

    def encode(self, images: torch.Tensor, poses: torch.Tensor, focal,
               c=None, train: bool = False) -> Conditioning:
        return self.net.encode(images, poses, focal, c, train)

    def render(self, cond: Conditioning, xy_pix: torch.Tensor, intrinsics: torch.Tensor,
               cam2world: torch.Tensor, key: RaySeeds) -> RenderOutput:
        """``xy_pix (SB, R, 2)``, ``intrinsics (SB, 3, 3)``, ``cam2world (SB, R,
        4, 4)``, per-ray seeds ``(SB, R)``."""
        def field(xyz, viewdirs, coarse):
            return self.net(cond, xyz, viewdirs, coarse)

        def march_fn(k, ros, rds):
            return lstm_march(self.renderer_cfg, k, cond, self.lstm, self.out_layer,
                              ros, rds, self.dtype)

        return render_adaptive(self.renderer_cfg, key, field, march_fn, xy_pix,
                               intrinsics, cam2world)


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights: matrices ``N(0, 1/fan_in)``, biases and
    BatchNorm at their identity values, the LSTM forget-gate biases 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                # (in, 4H) LSTM matrices; (out, in[, kh, kw]) linears and convs
                fan_in = p.shape[0] if name.endswith(("w_ih", "w_hh")) else p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        for cell in (m for m in model.modules() if isinstance(m, MarchLSTMCell)):
            H = cell.hidden_size
            cell.b_ih[H:2 * H] = 1.0
            cell.b_hh[H:2 * H] = 1.0


def make_model(conf: Union[str, Conf, None] = None, dtype: torch.dtype = torch.bfloat16,
               seed: int = 0, device: Optional[Union[str, torch.device]] = None
               ) -> RadFieldRenderer:
    """The adaptive renderer at the width of ``conf`` (default
    ``conf/default_mv.conf``) with seeded random weights, on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    if conf is None or isinstance(conf, str):
        conf = parse_conf(conf or DEFAULT_CONF)
    model = RadFieldRenderer(ModelConfig.from_conf(conf["model"]),
                             AdaptiveRendererConfig.from_conf(conf["adaptive_renderer"]),
                             dtype)
    init_weights(model, seed)
    return model.to(dev).eval()
