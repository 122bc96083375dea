"""Top-level model: radiance field + renderer as one ``nn.Module`` (port of
``avr_tpu/models/wrapper.py`` ``RadFieldRenderer``).

``encode`` produces the :class:`Conditioning` once per source view set;
``render`` renders a ray batch with the renderer its config's type selects:
the classic volume renderer, the Raymarcher or the adaptive renderer.
Parameter names follow the Flax tree (``net``, and ``lstm`` and
``out_layer`` for the marching renderers only) so ``models/flax_import.py``
carries weights across.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch
from torch import nn

from avr_tpu_torch.config import Conf, parse_conf
from avr_tpu_torch.models.pixelnerf import Conditioning, ModelConfig, PixelNeRFNet
from avr_tpu_torch.ops.hashrng import KeyLike
from avr_tpu_torch.renderers.adaptive import FUSED_INTEGRAL, render_adaptive
from avr_tpu_torch.renderers.base import (AdaptiveRendererConfig, RaymarcherConfig,
                                          RendererConfig, RenderOutput, VolumeRendererConfig,
                                          renderer_config_from_conf)
from avr_tpu_torch.renderers.lstm import MarchLSTMCell
from avr_tpu_torch.renderers.raymarch import lstm_march, render_raymarcher
from avr_tpu_torch.renderers.volume import render_volume
from avr_tpu_torch.utils.device import resolve_device

__all__ = ["RadFieldRenderer", "make_model", "init_weights", "bench_weights", "add_sigma_bias"]

DEFAULT_CONF = os.path.join(os.path.dirname(__file__), "..", "..", "conf", "default_mv.conf")


class RadFieldRenderer(nn.Module):
    """``fused_integral`` picks the adaptive renderer's band compositing, as
    JAX's attribute of that name (``avr_tpu/models/wrapper.py:53-61``):
    ``"never"`` (the default) the plain volume integral, ``"always"`` the K4
    wrapper, ``"auto"`` the K4 wrapper on the card and the plain integral on
    the CPU, as JAX fuses on the TPU only."""

    def __init__(self, model_cfg: ModelConfig, renderer_cfg: RendererConfig,
                 dtype: torch.dtype = torch.float32, fused_integral: str = "never"):
        super().__init__()
        if not isinstance(renderer_cfg, (VolumeRendererConfig, RaymarcherConfig,
                                         AdaptiveRendererConfig)):
            raise TypeError(f"unknown renderer config {type(renderer_cfg)}")
        if fused_integral not in FUSED_INTEGRAL:
            raise ValueError(f"fused_integral {fused_integral!r} not in {FUSED_INTEGRAL}")
        self.renderer_cfg, self.dtype = renderer_cfg, dtype
        self.fused_integral = fused_integral
        self.net = PixelNeRFNet(model_cfg, dtype)
        if self.has_marcher:
            self.lstm = MarchLSTMCell(self.net.latent_size, renderer_cfg.hidden_size)
            self.out_layer = nn.Linear(renderer_cfg.hidden_size, 1)

    @property
    def has_marcher(self) -> bool:
        return isinstance(self.renderer_cfg, (RaymarcherConfig, AdaptiveRendererConfig))

    def encode(self, images: torch.Tensor, poses: torch.Tensor, focal,
               c=None, train: bool = False) -> Conditioning:
        return self.net.encode(images, poses, focal, c, train)

    def render(self, cond: Conditioning, xy_pix: torch.Tensor, intrinsics: torch.Tensor,
               cam2world: torch.Tensor, key: KeyLike, train: bool = False) -> RenderOutput:
        """``xy_pix (SB, R, 2)``, ``intrinsics (SB, 3, 3)``, ``cam2world (SB, R,
        4, 4)``, ``key`` per-ray seeds ``(SB, R)`` (``RaySeeds``) or a threefry
        ``Key`` (the legacy stream); ``train`` puts the decoders' BatchNorm
        (``--bn``) in train mode, as JAX's ``render(train=True)``."""
        cfg = self.renderer_cfg

        def field(xyz, viewdirs, coarse):
            return self.net(cond, xyz, viewdirs, coarse, train)

        if isinstance(cfg, VolumeRendererConfig):
            return render_volume(cfg, key, field, xy_pix, intrinsics, cam2world)

        def march_fn(k, ros, rds):
            return lstm_march(cfg, k, cond, self.lstm, self.out_layer, ros, rds, self.dtype)

        if isinstance(cfg, RaymarcherConfig):
            return render_raymarcher(key, field, march_fn, xy_pix, intrinsics, cam2world)
        return render_adaptive(cfg, key, field, march_fn, xy_pix, intrinsics, cam2world,
                               self.fused_integral)


def _normal(shape, std, gen):
    return torch.randn(shape, generator=gen) * std


def _truncated_normal(shape, std, gen):
    """``jax.nn.initializers.truncated_normal`` as ``lecun_normal`` draws it:
    a standard normal cut at +-2, scaled so the variance is ``std**2``."""
    t = torch.randn(shape, generator=gen)
    out = t.abs() > 2.0
    while bool(out.any()):
        t[out] = torch.randn(int(out.sum()), generator=gen)
        out = t.abs() > 2.0
    return t * (std / 0.87962566103423978)


def _orthogonal_rows(shape, gen):
    """``nn.initializers.orthogonal(column_axis=0)`` on ``(H, 4H)``: the rows
    orthonormal."""
    a = torch.randn(shape[1], shape[0], generator=gen)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).T.contiguous()


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded weights by the JAX package's scheme (``init_all``):

    * the decoders' ``lin_in``, ``lin_z``, ``scale_z``, ``fc_0``, ``lin_out``
      and ImplicitNet's ``lin_k``: Kaiming normal, variance 2 / fan_in
      (``avr_tpu/models/mlp.py:33``); ``fc_1``
      zero, so a fresh block is the identity (``:77-88``);
    * the LSTM's ``w_ih``: Kaiming normal; ``w_hh``: orthogonal rows
      (``column_axis=0``); both biases zero but the forget quarter, 1
      (``avr_tpu/renderers/lstm.py:48-52,70-78``);
    * the encoders' convolutions (a transposed one's fan-in is its input
      channels times its taps), the global encoder's ``fc`` and the march's
      ``out_layer``: Flax's default LeCun normal (truncated, variance 1 /
      fan_in), zero bias;
    * BatchNorm scale 1, bias 0.

    The draws are not JAX's (another generator); the scheme is."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "w_hh":
                p.copy_(_orthogonal_rows(p.shape, gen))
            elif leaf == "w_ih":  # (in, 4H)
                p.copy_(_normal(p.shape, (2.0 / p.shape[0]) ** 0.5, gen))
            elif ".fc_1." in name:
                p.zero_()
            elif p.ndim >= 2 and ".mlp_" in name:
                p.copy_(_normal(p.shape, (2.0 / p[0].numel()) ** 0.5, gen))
            elif ".deconv" in name and p.ndim == 4:  # transposed (in, out, kh, kw)
                fan_in = p.shape[0] * p[0, 0].numel()
                p.copy_(_truncated_normal(p.shape, (1.0 / fan_in) ** 0.5, gen))
            elif p.ndim >= 2:  # convolutions (out, in, kh, kw), out_layer (out, in)
                p.copy_(_truncated_normal(p.shape, (1.0 / p[0].numel()) ** 0.5, gen))
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()
        _forget_bias(model)


def bench_weights(model: nn.Module, seed: int) -> None:
    """Seeded benchmark weights: every matrix ``N(0, 1/fan_in)`` (``fc_1``
    too), biases and BatchNorm at their identity values, the LSTM
    forget-gate biases 1.  The card's checks run on these: with JAX's
    zero ``fc_1`` every ``fc_0`` cotangent of the decoder's backward would
    be exactly zero, and its kernels would be held to zeros."""
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
        _forget_bias(model)


def _forget_bias(model: nn.Module) -> None:
    for cell in (m for m in model.modules() if isinstance(m, MarchLSTMCell)):
        H = cell.hidden_size
        cell.b_ih[H:2 * H] = 1.0
        cell.b_hh[H:2 * H] = 1.0


def add_sigma_bias(model: RadFieldRenderer, value: float) -> None:
    """Add ``value`` to the raw-sigma bias (channel 3 of ``lin_out``) of
    both decoders, so the density starts positive: the JAX CLI's
    ``--sigma_bias_init`` (``avr_tpu/cli/train.py:276-284``)."""
    with torch.no_grad():
        for head in (model.net.mlp_coarse, model.net.mlp_fine):
            # a ResnetFC's rgb + raw sigma (no fine decoder, or ImplicitNet: none)
            if hasattr(head, "lin_out") and head.lin_out.bias.shape[-1] == 4:
                head.lin_out.bias[3] += value


def make_model(conf: Union[str, Conf, None] = None, dtype: torch.dtype = torch.bfloat16,
               seed: int = 0, device: Optional[Union[str, torch.device]] = None,
               renderer: str = "", gather_impl: str = "auto",
               fused_integral: str = "never", norm_type: str = "batch",
               stop_encoder_grad: bool = False, raymarch_steps: int = 10,
               fused_mlp: str = "auto", fused_march: str = "auto",
               bn: bool = False) -> RadFieldRenderer:
    """The model at the width of ``conf`` (default ``conf/default_mv.conf``)
    with seeded weights by JAX's scheme (:func:`init_weights`), on the card
    unless ``device`` says otherwise.  ``renderer`` is the experiment name whose prefix picks the
    renderer (:func:`renderer_config_from_conf`): ``"VR..."`` the volume
    renderer, ``"...Raymarcher..."`` the Raymarcher, anything else (the
    default) the adaptive renderer.  ``gather_impl`` sets
    ``ModelConfig.gather_impl`` (``"pallas_proj"``: the K5 gather) and
    ``fused_integral`` the adaptive renderer's band compositing (``"auto"``
    or ``"always"``: K4); with both the adaptive renderer runs the fused
    path of the JAX package's ``--gather_impl pallas_proj`` and
    ``fused_integral``.  ``norm_type`` is the encoder's norm (JAX's
    ``--norm_type``: ``"batch"``, ``"group"``, ``"instance"``, ``"none"``)
    and ``stop_encoder_grad`` keeps gradients out of the encoder.

    The JAX CLI's other model flags: ``raymarch_steps`` the Raymarcher's
    march steps (``renderer_config_from_conf``'s argument; the adaptive
    renderer reads its conf), ``fused_mlp`` the decoder's backward
    (``FUSED_MLP_STASH``), ``fused_march`` and ``bn`` (BatchNorm in the
    decoders' blocks).  The model options of ``conf``'s ``model`` subtree
    are JAX's (``ModelConfig``); ``ModelConfig.check_supported`` refuses
    JAX's XLA-only values (``models/pixelnerf.py XLA_ONLY``) before a module
    is built."""
    dev = resolve_device(device)
    if conf is None or isinstance(conf, str):
        conf = parse_conf(conf or DEFAULT_CONF)
    model_cfg = ModelConfig.from_conf(conf["model"], stop_encoder_grad=stop_encoder_grad, bn=bn)
    model_cfg = dataclasses.replace(
        model_cfg, gather_impl=gather_impl, fused_mlp=fused_mlp,
        encoder=dataclasses.replace(model_cfg.encoder, norm_type=norm_type))
    model_cfg.check_supported(fused_march)
    model = RadFieldRenderer(model_cfg, renderer_config_from_conf(conf, renderer, raymarch_steps),
                             dtype, fused_integral)
    init_weights(model, seed)
    return model.to(dev).eval()
