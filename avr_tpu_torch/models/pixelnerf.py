"""Image-conditioned PixelNeRF radiance field (port of
``avr_tpu/models/pixelnerf.py``), for the configuration the serving path
uses: pixel-aligned ResNet conditioning, rotated xyz point features with the
positional encoding and raw view directions folded into the decoder.

Conventions pinned for parity: world->cam poses ``[R^T | -R^T t]``; focal
with **fy negated**; principal point defaulting to the image centre;
``uv = -xy/z * focal + c`` and grid ``uv * latent_scaling / image_shape - 1``;
outputs ``sigmoid(rgb) / relu(sigma)`` in float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from avr_tpu_torch.models.encoder import SpatialEncoder
from avr_tpu_torch.models.mlp import ResnetFC
from avr_tpu_torch.models.resnet import ResNetTrunk
from avr_tpu_torch.ops.grid_sample import grid_sample_2d
from avr_tpu_torch.ops.kernels.gather import gather_bilinear_projected
from avr_tpu_torch.ops.kernels.march import pack_projection
from avr_tpu_torch.ops.kernels.resnetfc import CodeSpec

__all__ = ["Conditioning", "ModelConfig", "MLPConfig", "EncoderConfig", "CodeConfig",
           "PixelNeRFNet"]


@dataclass(frozen=True)
class CodeConfig:
    num_freqs: int = 6
    freq_factor: float = 1.5
    include_input: bool = True

    @classmethod
    def from_conf(cls, conf):
        return cls(
            num_freqs=conf.get_int("num_freqs", 6),
            freq_factor=conf.get_float("freq_factor", 3.141592653589793),
            include_input=conf.get_bool("include_input", True),
        )


@dataclass(frozen=True)
class MLPConfig:
    type: str = "resnet"
    n_blocks: int = 5
    d_hidden: int = 512
    beta: float = 0.0
    combine_layer: int = 1000
    combine_type: str = "average"
    use_spade: bool = False

    @classmethod
    def from_conf(cls, conf):
        return cls(
            type=conf.get_string("type", "resnet"),
            n_blocks=conf.get_int("n_blocks", 5),
            d_hidden=conf.get_int("d_hidden", 128),
            beta=conf.get_float("beta", 0.0),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            use_spade=conf.get_bool("use_spade", False),
        )


@dataclass(frozen=True)
class EncoderConfig:
    backbone: str = "resnet34"
    num_layers: int = 4
    use_first_pool: bool = True
    # the trunk's norm (models/resnet.py make_norm); as in JAX the conf
    # does not set it, the caller does (the JAX CLI's --norm_type)
    norm_type: str = "batch"

    @classmethod
    def from_conf(cls, conf):
        return cls(
            backbone=conf.get_string("backbone", "resnet34"),
            num_layers=conf.get_int("num_layers", 4),
            use_first_pool=conf.get_bool("use_first_pool", True),
        )


FUSED_MLP_STASH = {"auto": "auto", "always": False, "stash": True, "always_stash": True}
# the field query's gather: "auto" and "pallas" project outside and run K1
# on the grid, "pallas_proj" runs K5 on the world points (projection inside)
GATHER_IMPLS = ("auto", "pallas", "pallas_proj")


@dataclass(frozen=True)
class ModelConfig:
    """The ``model`` conf subtree, with the JAX package's defaults."""

    use_encoder: bool = True
    use_global_encoder: bool = False
    use_xyz: bool = True
    normalize_z: bool = True
    use_code: bool = True
    use_code_viewdirs: bool = False
    use_viewdirs: bool = True
    # no gradient reaches the encoder through the gathered latent
    # (avr_tpu/models/pixelnerf.py:529, wrapper.py:235): its parameters get
    # zero gradients; train-mode BatchNorm still updates its statistics
    stop_encoder_grad: bool = False
    # BatchNorm in the decoder (JAX's --bn, avr_tpu/models/pixelnerf.py:127):
    # not ported, check_supported refuses it
    bn: bool = False
    # the decoder's backward, as JAX's fused_mlp values map to the kernel's
    # stash argument (avr_tpu/models/mlp.py:218-221): FUSED_MLP_STASH
    fused_mlp: str = "auto"
    # the gather, as JAX's gather_impl (avr_tpu/models/pixelnerf.py:128-131):
    # GATHER_IMPLS
    gather_impl: str = "auto"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    code: CodeConfig = field(default_factory=CodeConfig)
    mlp_coarse: MLPConfig = field(default_factory=MLPConfig)
    mlp_fine: MLPConfig = field(default_factory=MLPConfig)

    @classmethod
    def from_conf(cls, conf, stop_encoder_grad: bool = False, bn: bool = False):
        return cls(
            use_encoder=conf.get_bool("use_encoder", True),
            use_global_encoder=conf.get_bool("use_global_encoder", False),
            use_xyz=conf.get_bool("use_xyz", False),
            normalize_z=conf.get_bool("normalize_z", True),
            use_code=conf.get_bool("use_code", False),
            use_code_viewdirs=conf.get_bool("use_code_viewdirs", True),
            use_viewdirs=conf.get_bool("use_viewdirs", False),
            stop_encoder_grad=stop_encoder_grad,
            bn=bn,
            encoder=EncoderConfig.from_conf(conf["encoder"]),
            code=CodeConfig.from_conf(conf["code"]) if "code" in conf else CodeConfig(),
            mlp_coarse=MLPConfig.from_conf(conf["mlp_coarse"]),
            mlp_fine=MLPConfig.from_conf(conf["mlp_fine"]),
        )

    def check_supported(self) -> None:
        """The port covers the serving configuration of ``conf/default*.conf``;
        the rest waits for ROADMAP Queue 1, P10."""
        want = dict(use_encoder=True, use_global_encoder=False, use_xyz=True,
                    normalize_z=True, use_code=True, use_code_viewdirs=False,
                    use_viewdirs=True)
        bad = {k: getattr(self, k) for k, v in want.items() if getattr(self, k) != v}
        for name, mc in (("mlp_coarse", self.mlp_coarse), ("mlp_fine", self.mlp_fine)):
            if (mc.type, mc.beta > 0, mc.combine_type, mc.use_spade) != \
                    ("resnet", False, "average", False):
                bad[name] = mc
        if self.fused_mlp not in FUSED_MLP_STASH:
            bad["fused_mlp"] = self.fused_mlp  # "never": a plain path on the card
        if self.gather_impl not in GATHER_IMPLS:
            bad["gather_impl"] = self.gather_impl  # "xla": a plain path on the card
        if self.bn:
            bad["bn"] = True  # BatchNorm in the decoder
        if bad:
            raise NotImplementedError(f"avr_tpu_torch does not port these settings yet "
                                      f"(ROADMAP Queue 1, P10): {bad}")


@dataclass
class Conditioning:
    """The encoded source views; ``B = SB * NS`` views flattened on axis 0."""

    latent: torch.Tensor  # (B, H', W', C) in the compute dtype
    latent_scaling: torch.Tensor  # (2,)
    poses: torch.Tensor  # (B, 3, 4) world->cam [R^T | -R^T t]
    focal: torch.Tensor  # (Bf, 2) [fx, -fy]; Bf in {1, B}
    c: torch.Tensor  # (Bc, 2) principal point, pixels
    image_shape: torch.Tensor  # (2,) [W, H]
    num_views: int = 1


def _pairs(v, device) -> torch.Tensor:
    """A scalar, ``(2,)``, ``(B,)`` or ``(B, 2)`` intrinsic -> ``(Bx, 2)`` float32."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.ndim == 0:
        return t.expand(1, 2)
    if t.ndim == 1:
        return t[None, :] if t.shape[0] == 2 else t[:, None].expand(-1, 2)
    return t


class PixelNeRFNet(nn.Module):
    """PixelNeRF radiance field: pixel-aligned CNN conditioning + FC-ResNet."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg.check_supported()
        self.cfg, self.dtype = cfg, dtype
        self.encoder = SpatialEncoder(cfg.encoder.backbone, cfg.encoder.num_layers,
                                      cfg.encoder.use_first_pool, dtype, cfg.encoder.norm_type)
        self.latent_size = ResNetTrunk.latent_size(cfg.encoder.backbone,
                                                   cfg.encoder.num_layers)
        code = CodeSpec(num_freqs=cfg.code.num_freqs, freq_factor=cfg.code.freq_factor,
                        include_input=cfg.code.include_input, d_coded=3, d_pass=3)
        self.d_in = code.d_enc

        def mlp(mc: MLPConfig) -> ResnetFC:
            return ResnetFC(self.d_in, 4, mc.n_blocks, self.latent_size, mc.d_hidden,
                            mc.combine_layer, code_spec=code, activate_out=True, dtype=dtype,
                            stash=FUSED_MLP_STASH[cfg.fused_mlp])

        self.mlp_coarse = mlp(cfg.mlp_coarse)
        self.mlp_fine = mlp(cfg.mlp_fine)

    def encode(self, images: torch.Tensor, poses: torch.Tensor, focal,
               c=None, train: bool = False) -> Conditioning:
        """``images (SB, NS, H, W, 3)`` in [-1, 1] (NHWC), ``poses (SB, NS, 4, 4)``
        cam2world, scalar / per-view focal and principal point; ``train``
        puts the encoder's BatchNorm in train mode.  With
        ``stop_encoder_grad`` the encoder runs without autograd: the latent
        has no graph, and the encoder's parameters get no gradient."""
        SB, NS, H, W, _ = images.shape
        dev = images.device
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.cfg.stop_encoder_grad):
            latent, latent_scaling = self.encoder(images.reshape(SB * NS, H, W, 3), train)
        flat = poses.reshape(SB * NS, 4, 4).float()
        rot = flat[:, :3, :3].transpose(1, 2)
        trans = -torch.einsum("bij,bj->bi", rot, flat[:, :3, 3])
        image_shape = torch.tensor([W, H], dtype=torch.float32, device=dev)
        focal = _pairs(focal, dev) * torch.tensor([1.0, -1.0], device=dev)
        cc = (image_shape * 0.5)[None, :] if c is None else _pairs(c, dev)
        return Conditioning(latent, latent_scaling, torch.cat([rot, trans[..., None]], -1),
                            focal, cc, image_shape, NS)

    def rotate(self, cond: Conditioning, xyz: torch.Tensor) -> tuple:
        """World points ``(SB, B, 3)`` -> (rotated points ``(SB, NS, B, 3)``,
        rotation ``(SB, NS, 3, 3)``, translation ``(SB, NS, 3)``)."""
        SB = xyz.shape[0]
        poses = cond.poses.reshape(SB, cond.num_views, 3, 4)
        R, t = poses[..., :3], poses[..., 3]
        return torch.einsum("snij,sbj->snbi", R, xyz), R, t

    def grid(self, cond: Conditioning, xyz_rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Rotated points ``(SB, NS, B, 3)`` -> grid coords ``(SB * NS, B, 2)``."""
        SB, NS, B, _ = xyz_rot.shape
        xyz_cam = xyz_rot + t[:, :, None, :]
        uv = -xyz_cam[..., :2] / xyz_cam[..., 2:3]
        focal, cc = cond.focal, cond.c
        if focal.shape[0] > 1:
            focal = focal.reshape(SB, NS, 1, 2)
        if cc.shape[0] > 1:
            cc = cc.reshape(SB, NS, 1, 2)
        uv = uv * focal + cc
        grid = uv * (cond.latent_scaling / cond.image_shape) - 1.0
        return grid.reshape(SB * NS, B, 2)

    def forward(self, cond: Conditioning, xyz: torch.Tensor, viewdirs: torch.Tensor,
                coarse: bool = True) -> torch.Tensor:
        """``(r, g, b, sigma)`` at world points ``(SB, B, 3)`` -> ``(SB, B, 4)`` float32."""
        SB, B, _ = xyz.shape
        NS = cond.num_views
        xyz_rot, R, t = self.rotate(cond, xyz)
        vd = torch.einsum("snij,sbj->snbi", R, viewdirs)
        if self.cfg.gather_impl == "pallas_proj":
            # K5: the projection runs in the kernel, on the points broadcast
            # over the views (avr_tpu/models/pixelnerf.py:481-490)
            proj = pack_projection(cond.poses, cond.focal, cond.c, cond.latent_scaling,
                                   cond.image_shape)
            pts = xyz[:, None].expand(SB, NS, B, 3).reshape(SB * NS, B, 3)
            latent = gather_bilinear_projected(cond.latent, pts.float().contiguous(), proj)
        else:
            latent = grid_sample_2d(cond.latent, self.grid(cond, xyz_rot, t))
        mlp = self.mlp_coarse if coarse else self.mlp_fine
        return mlp(torch.cat([xyz_rot, vd], dim=-1), latent.reshape(SB, NS, B, -1)).float()
