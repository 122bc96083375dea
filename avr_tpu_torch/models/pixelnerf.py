"""Image-conditioned PixelNeRF radiance field (port of
``avr_tpu/models/pixelnerf.py``): pixel-aligned CNN conditioning (a ResNet
trunk or the custom conv backbone), an optional global image latent
broadcast and concatenated before the pixel-aligned one, the point feature
(rotated or camera-space xyz, or its depth alone) with the positional
encoding and the view directions, and a decoder (``ResnetFC`` or, for
``type = mlp``, ``ImplicitNet``) per coarse and fine pass; ``mlp_fine``
``type = empty`` is coarse only.

The decoder takes JAX's route (``models/mlp.py``): where JAX fuses, the K2
kernel runs with the encoding folded in (``CodeSpec``) and the output
activation too; with ``use_code = False`` the features go in as they are
and the head is applied here.

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

from avr_tpu_torch.models.encoder import CUSTOM_LATENT, ImageEncoder, SpatialEncoder
from avr_tpu_torch.models.implicit import ImplicitNet
from avr_tpu_torch.models.mlp import ResnetFC
from avr_tpu_torch.models.resnet import ResNetTrunk
from avr_tpu_torch.ops.grid_sample import grid_sample_2d
from avr_tpu_torch.ops.kernels.gather import gather_bilinear_projected
from avr_tpu_torch.ops.kernels.march import pack_projection
from avr_tpu_torch.ops.kernels.resnetfc import CodeSpec, encode_features

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
    backbone: str = "resnet34"  # resnet18, resnet34, or custom (ConvEncoder)
    num_layers: int = 4
    use_first_pool: bool = True
    feature_scale: float = 1.0
    # the trunk's norm (models/resnet.py make_norm); as in JAX the conf
    # does not set it, the caller does (the JAX CLI's --norm_type)
    norm_type: str = "batch"

    @classmethod
    def from_conf(cls, conf):
        return cls(
            backbone=conf.get_string("backbone", "resnet34"),
            num_layers=conf.get_int("num_layers", 4),
            use_first_pool=conf.get_bool("use_first_pool", True),
            feature_scale=conf.get_float("feature_scale", 1.0),
        )


FUSED_MLP_STASH = {"auto": "auto", "always": False, "stash": True, "always_stash": True}
# the field query's gather: "auto" and "pallas" project outside and run K1
# on the grid, "pallas_proj" runs K5 on the world points (projection inside)
GATHER_IMPLS = ("auto", "pallas", "pallas_proj")
# JAX's XLA paths beside a TPU kernel that computes the same function: on
# the card the port has one implementation of each (ROADMAP: no
# implementation switch), so these values are refused, here and by the CLIs
XLA_ONLY = {"fused_mlp": "never", "fused_march": "never", "gather_impl": "xla"}


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
    # BatchNorm in the decoder's blocks (JAX's --bn): the plain path
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
    # None: mlp_fine { type = empty }, the coarse decoder answers fine queries
    mlp_fine: Optional[MLPConfig] = field(default_factory=MLPConfig)
    global_encoder_backbone: str = "resnet34"
    global_latent_size: int = 128

    @classmethod
    def from_conf(cls, conf, stop_encoder_grad: bool = False, bn: bool = False):
        use_global = conf.get_bool("use_global_encoder", False)
        glob = conf["global_encoder"] if use_global and "global_encoder" in conf else None
        fine = conf.get("mlp_fine")
        return cls(
            use_encoder=conf.get_bool("use_encoder", True),
            use_global_encoder=use_global,
            use_xyz=conf.get_bool("use_xyz", False),
            normalize_z=conf.get_bool("normalize_z", True),
            use_code=conf.get_bool("use_code", False),
            use_code_viewdirs=conf.get_bool("use_code_viewdirs", True),
            use_viewdirs=conf.get_bool("use_viewdirs", False),
            stop_encoder_grad=stop_encoder_grad,
            bn=bn,
            encoder=EncoderConfig.from_conf(conf["encoder"]),
            code=(CodeConfig.from_conf(conf["code"]) if conf.get_bool("use_code", False)
                  else CodeConfig()),
            mlp_coarse=MLPConfig.from_conf(conf["mlp_coarse"]),
            mlp_fine=(MLPConfig.from_conf(fine) if fine is not None
                      and fine.get_string("type", "resnet") != "empty" else None),
            global_encoder_backbone=(glob.get_string("backbone", "resnet34") if glob
                                     else "resnet34"),
            global_latent_size=glob.get_int("latent_size", 128) if glob else 128,
        )

    def check_supported(self, fused_march: str = "auto") -> None:
        """Refuse JAX's XLA-only values (:data:`XLA_ONLY`: this config's and
        the march's ``fused_march``, ``avr_tpu/models/wrapper.py:48-52``,
        whose other values run K3) and decoder types JAX does not have."""
        values = {"fused_mlp": self.fused_mlp, "gather_impl": self.gather_impl,
                  "fused_march": fused_march}
        bad = {k: v for k, v in XLA_ONLY.items() if values[k] == v}
        if bad:
            raise NotImplementedError(
                f"{bad}: JAX's XLA path beside its kernel; avr_tpu_torch runs one "
                f"implementation on the card (the kernel), so it refuses {XLA_ONLY}")
        for mc in (self.mlp_coarse, self.mlp_fine):
            if mc is not None and mc.type not in ("resnet", "mlp"):
                raise NotImplementedError(f"Unsupported MLP type {mc.type!r}")

    @property
    def latent_size(self) -> int:
        """The pixel-aligned latent's channels."""
        if self.encoder.backbone == "custom":
            return CUSTOM_LATENT
        return ResNetTrunk.latent_size(self.encoder.backbone, self.encoder.num_layers)

    @property
    def d_latent(self) -> int:
        """The decoders' latent width: the global latent, then the
        pixel-aligned one."""
        return ((self.latent_size if self.use_encoder else 0)
                + (self.global_latent_size if self.use_global_encoder else 0))

    def code_spec(self) -> Optional[CodeSpec]:
        """The encoding the decoders fold in (``avr_tpu/models/pixelnerf.py:
        293-320``): the point feature (3 lanes, or 1 without ``use_xyz``)
        coded and the view directions passed through, or with
        ``use_code_viewdirs`` both coded; ``None`` without ``use_code``."""
        if not self.use_code:
            return None
        d_base = 3 if self.use_xyz else 1
        coded_vd = self.use_viewdirs and self.use_code_viewdirs
        return CodeSpec(num_freqs=self.code.num_freqs, freq_factor=self.code.freq_factor,
                        include_input=self.code.include_input,
                        d_coded=d_base + 3 if coded_vd else d_base,
                        d_pass=3 if self.use_viewdirs and not coded_vd else 0)

    @property
    def d_in(self) -> int:
        """The decoders' input width (``avr_tpu/models/pixelnerf.py:222-237``)."""
        spec = self.code_spec()
        if spec is not None:
            return spec.d_enc
        return (3 if self.use_xyz else 1) + (3 if self.use_viewdirs else 0)


@dataclass
class Conditioning:
    """The encoded source views; ``B = SB * NS`` views flattened on axis 0."""

    latent: Optional[torch.Tensor]  # (B, H', W', C) in the compute dtype; None without
    latent_scaling: torch.Tensor  # (2,)
    poses: torch.Tensor  # (B, 3, 4) world->cam [R^T | -R^T t]
    focal: torch.Tensor  # (Bf, 2) [fx, -fy]; Bf in {1, B}
    c: torch.Tensor  # (Bc, 2) principal point, pixels
    image_shape: torch.Tensor  # (2,) [W, H]
    num_views: int = 1
    global_latent: Optional[torch.Tensor] = None  # (B, Lg) with use_global_encoder


def _pairs(v, device) -> torch.Tensor:
    """A scalar, ``(2,)``, ``(B,)`` or ``(B, 2)`` intrinsic -> ``(Bx, 2)`` float32."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.ndim == 0:
        return t.expand(1, 2)
    if t.ndim == 1:
        return t[None, :] if t.shape[0] == 2 else t[:, None].expand(-1, 2)
    return t


class PixelNeRFNet(nn.Module):
    """PixelNeRF radiance field: image-conditioned decoders."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg.check_supported()
        self.cfg, self.dtype = cfg, dtype
        enc = cfg.encoder
        if cfg.use_encoder:
            self.encoder = SpatialEncoder(enc.backbone, enc.num_layers, enc.use_first_pool,
                                          dtype, enc.norm_type, enc.feature_scale)
        if cfg.use_global_encoder:
            self.global_encoder = ImageEncoder(cfg.global_encoder_backbone,
                                               cfg.global_latent_size, dtype=dtype)
        self.latent_size = cfg.latent_size
        self.d_in = cfg.d_in
        code = cfg.code_spec()

        def mlp(mc: MLPConfig) -> nn.Module:
            if mc.type == "mlp":
                # JAX's PixelNeRFNet keeps ImplicitNet's default skip_in=(4,)
                return ImplicitNet(self.d_in, 4, mc.n_blocks, mc.d_hidden, cfg.d_latent,
                                   beta=mc.beta, combine_layer=mc.combine_layer,
                                   combine_type=mc.combine_type, dtype=dtype)
            return ResnetFC(self.d_in, 4, mc.n_blocks, cfg.d_latent, mc.d_hidden,
                            mc.combine_layer, code_spec=code, activate_out=code is not None,
                            dtype=dtype, stash=FUSED_MLP_STASH[cfg.fused_mlp], beta=mc.beta,
                            combine_type=mc.combine_type, use_spade=mc.use_spade, bn=cfg.bn)

        self.mlp_coarse = mlp(cfg.mlp_coarse)
        self.mlp_fine = mlp(cfg.mlp_fine) if cfg.mlp_fine is not None else None

    def encode(self, images: torch.Tensor, poses: torch.Tensor, focal,
               c=None, train: bool = False) -> Conditioning:
        """``images (SB, NS, H, W, 3)`` in [-1, 1] (NHWC), ``poses (SB, NS, 4, 4)``
        cam2world, scalar / per-view focal and principal point; ``train``
        puts the encoders' BatchNorm in train mode.  With
        ``stop_encoder_grad`` the spatial encoder runs without autograd: the
        latent has no graph, and the encoder's parameters get no gradient."""
        SB, NS, H, W, _ = images.shape
        dev = images.device
        flat_images = images.reshape(SB * NS, H, W, 3)
        latent = None
        latent_scaling = torch.ones(2, dtype=torch.float32, device=dev)
        if self.cfg.use_encoder:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not self.cfg.stop_encoder_grad):
                latent, latent_scaling = self.encoder(flat_images, train)
        flat = poses.reshape(SB * NS, 4, 4).float()
        rot = flat[:, :3, :3].transpose(1, 2)
        trans = -torch.einsum("bij,bj->bi", rot, flat[:, :3, 3])
        image_shape = torch.tensor([W, H], dtype=torch.float32, device=dev)
        focal = _pairs(focal, dev) * torch.tensor([1.0, -1.0], device=dev)
        cc = (image_shape * 0.5)[None, :] if c is None else _pairs(c, dev)
        glob = self.global_encoder(flat_images, train) if self.cfg.use_global_encoder else None
        return Conditioning(latent, latent_scaling, torch.cat([rot, trans[..., None]], -1),
                            focal, cc, image_shape, NS, glob)

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

    def forward(self, cond: Conditioning, xyz: torch.Tensor, viewdirs: Optional[torch.Tensor],
                coarse: bool = True, train: bool = False) -> torch.Tensor:
        """``(r, g, b, sigma)`` at world points ``(SB, B, 3)`` -> ``(SB, B, 4)``
        float32.  ``train`` puts the decoder's BatchNorm (``--bn``) in train
        mode."""
        cfg = self.cfg
        SB, B, _ = xyz.shape
        NS = cond.num_views
        xyz_rot, R, t = self.rotate(cond, xyz)
        src = xyz_rot if cfg.normalize_z else xyz_rot + t[:, :, None, :]
        feature = src if cfg.use_xyz else -src[..., 2:3]
        if cfg.use_viewdirs:
            feature = torch.cat([feature, torch.einsum("snij,sbj->snbi", R, viewdirs)], dim=-1)
        mlp = self.mlp_coarse if (coarse or self.mlp_fine is None) else self.mlp_fine
        if getattr(mlp, "code_spec", None) is None and cfg.use_code:
            # the decoder without the encoding folded in (ImplicitNet): JAX's
            # PositionalEncoding, whose lanes are the CodeSpec's
            feature = encode_features(feature.float(), cfg.code_spec())
        z = None
        if cfg.use_encoder:
            if cfg.gather_impl == "pallas_proj":
                # K5: the projection runs in the kernel, on the points broadcast
                # over the views (avr_tpu/models/pixelnerf.py:481-490)
                proj = pack_projection(cond.poses, cond.focal, cond.c, cond.latent_scaling,
                                       cond.image_shape)
                pts = xyz[:, None].expand(SB, NS, B, 3).reshape(SB * NS, B, 3)
                z = gather_bilinear_projected(cond.latent, pts.float().contiguous(), proj)
            else:
                z = grid_sample_2d(cond.latent, self.grid(cond, xyz_rot, t))
            z = z.reshape(SB, NS, B, -1)
        if cfg.use_global_encoder:
            g = cond.global_latent.reshape(SB, NS, 1, -1).expand(SB, NS, B, -1)
            z = g if z is None else torch.cat([g.to(z.dtype), z], dim=-1)
        out = mlp(feature, z, train)
        if getattr(mlp, "activate_out", False):
            return out.float()  # the decoder applied sigmoid(rgb) / relu(sigma)
        return torch.cat([torch.sigmoid(out[..., :3]), torch.relu(out[..., 3:4])],
                         dim=-1).float()
