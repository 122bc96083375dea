"""Weight import: torch state dicts -> the port's modules (port of
``avr_tpu/models/torch_import.py``).

Lets users bring ImageNet-pretrained torchvision ResNet weights for the
spatial encoder (the reference trains from ``pretrained=True``,
``models.py:227``; the CLI's ``--encoder_weights``) and the reference
model's LSTM cell and decoders.  The state dict comes as an ``.npz``
(``np.savez(path, **{k: v.numpy() for k, v in sd.items()})``), read with
numpy: nothing is downloaded.

The port's modules are PyTorch's already, so the importers rename keys and
keep layouts (convolutions OIHW, linear weights ``(out, in)``), with two
exceptions that follow the port's own parameters:

  * BatchNorm's ``weight``/``bias``/``running_mean``/``running_var`` ->
    ``scale``/``bias``/``mean``/``var`` (Flax's names, which the port keeps);
  * ``nn.LSTMCell``'s ``weight_ih``/``weight_hh`` ``(4H, D)`` -> ``w_ih``/``w_hh``
    ``(D, 4H)`` (``renderers/lstm.py MarchLSTMCell`` stores them transposed).

Each importer returns float32 tensors keyed as the target module's
``state_dict``; load them with ``module.load_state_dict(..., strict=True)``,
which refuses a state dict of another architecture.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["import_torchvision_resnet", "import_lstm_cell", "import_resnetfc"]

Tensors = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _bn(sd: Mapping[str, np.ndarray], prefix: str, to: str) -> Tensors:
    return {f"{to}.scale": _t(sd[f"{prefix}.weight"]), f"{to}.bias": _t(sd[f"{prefix}.bias"]),
            f"{to}.mean": _t(sd[f"{prefix}.running_mean"]),
            f"{to}.var": _t(sd[f"{prefix}.running_var"])}


def import_torchvision_resnet(sd: Mapping[str, np.ndarray], blocks_per_stage=(3, 4, 6, 3),
                              num_layers: int = 4) -> Tensors:
    """A torchvision resnet18/34 state dict -> a ``models/resnet.py
    ResNetTrunk`` state dict (``norm_type="batch"``): the stem and the first
    ``num_layers - 1`` stages.  Use ``blocks_per_stage=(2, 2, 2, 2)`` for
    resnet18."""
    out = {"conv1.weight": _t(sd["conv1.weight"]), **_bn(sd, "bn1", "bn1")}
    for stage in range(num_layers - 1):
        for blk in range(blocks_per_stage[stage]):
            t = f"layer{stage + 1}.{blk}"
            name = f"stages.layer{stage + 1}_block{blk}"
            out[f"{name}.conv1.weight"] = _t(sd[f"{t}.conv1.weight"])
            out.update(_bn(sd, f"{t}.bn1", f"{name}.bn1"))
            out[f"{name}.conv2.weight"] = _t(sd[f"{t}.conv2.weight"])
            out.update(_bn(sd, f"{t}.bn2", f"{name}.bn2"))
            if f"{t}.downsample.0.weight" in sd:
                out[f"{name}.down_conv.weight"] = _t(sd[f"{t}.downsample.0.weight"])
                out.update(_bn(sd, f"{t}.downsample.1", f"{name}.down_bn"))
    return out


def import_lstm_cell(sd: Mapping[str, np.ndarray], prefix: str = "lstm") -> Tensors:
    """torch ``nn.LSTMCell`` -> a ``renderers/lstm.py MarchLSTMCell`` state
    dict (the gate order is torch's in both)."""
    return {"w_ih": _t(sd[f"{prefix}.weight_ih"]).T.contiguous(),
            "w_hh": _t(sd[f"{prefix}.weight_hh"]).T.contiguous(),
            "b_ih": _t(sd[f"{prefix}.bias_ih"]), "b_hh": _t(sd[f"{prefix}.bias_hh"])}


def import_resnetfc(sd: Mapping[str, np.ndarray], prefix: str, n_blocks: int,
                    n_lin_z: int) -> Tensors:
    """The reference ``ResnetFC`` subtree under ``prefix`` -> a
    ``models/mlp.py ResnetFC`` state dict.  A block's ``shortcut`` (the
    reference's projection between unequal widths) is carried too; the
    port's blocks have none, so loading it fails as it should."""
    def lin(name: str, to: str) -> Tensors:
        return {f"{to}.weight": _t(sd[f"{prefix}.{name}.weight"]),
                f"{to}.bias": _t(sd[f"{prefix}.{name}.bias"])}

    out = {**lin("lin_in", "lin_in"), **lin("lin_out", "lin_out")}
    for i in range(n_blocks):
        out.update(lin(f"blocks.{i}.fc_0", f"blocks.{i}.fc_0"))
        out.update(lin(f"blocks.{i}.fc_1", f"blocks.{i}.fc_1"))
        if f"{prefix}.blocks.{i}.shortcut.weight" in sd:
            out[f"blocks.{i}.shortcut.weight"] = _t(sd[f"{prefix}.blocks.{i}.shortcut.weight"])
    for i in range(n_lin_z):
        out.update(lin(f"lin_z.{i}", f"lin_z.{i}"))
    return out
