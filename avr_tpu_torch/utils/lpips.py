"""LPIPS perceptual distance (VGG-16 backbone) in PyTorch (port of
``avr_tpu/utils/lpips.py``).

The weights come from a local ``.npz`` archive in the torch LPIPS
state-dict layout (``net.slice{1..5}.{i}.weight / .bias`` OIHW for the VGG
convolutions, ``lin{0..4}.model.1.weight`` for the 1x1 calibration heads,
``scaling_layer.shift / .scale``), so no transpose is needed here.
:func:`random_state` builds the deterministic random-VGG archive (numpy
only, the same draws as ``scripts/make_lpips_weights.py --random``): it
carries the ``_uncalibrated`` marker, and such an archive reports its
distance as ``lpips_rand``, never as published LPIPS.

Computation: VGG features at relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
(3x3 convolutions padded by 1, 2x2 max-pools between the slices), unit-
normalized across channels, squared differences, the 1x1 calibration,
averaged over space, summed over the slices.  The convolutions are cuDNN's:
the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from avr_tpu_torch.utils.device import resolve_device

__all__ = ["LPIPS", "random_state"]

# torchvision VGG16 `features` conv indices per LPIPS slice, and each
# slice's output channels (the real VGG-16 plan)
_VGG_SLICES = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
_CHANS = [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512], [512, 512, 512]]
# the LPIPS ScalingLayer constants
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32).reshape(1, 3, 1, 1)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32).reshape(1, 3, 1, 1)


def random_state(seed: int) -> Dict[str, np.ndarray]:
    """The random-VGG LPIPS archive: He-normal VGG-16 convolutions, zero
    biases, uniform non-negative calibration heads, the ``_uncalibrated``
    marker."""
    rng = np.random.default_rng(seed)
    state = {
        "scaling_layer.shift": _SHIFT,
        "scaling_layer.scale": _SCALE,
        "_uncalibrated": np.asarray([1], np.int32),
        "_seed": np.asarray([seed], np.int32),
    }
    cin = 3
    for s, layer_ids in enumerate(_VGG_SLICES):
        for li, lid in enumerate(layer_ids):
            cout = _CHANS[s][li]
            fan_in = cin * 9
            w = rng.normal(0.0, np.sqrt(2.0 / fan_in), (cout, cin, 3, 3))
            state[f"net.slice{s + 1}.{lid}.weight"] = w.astype(np.float32)
            state[f"net.slice{s + 1}.{lid}.bias"] = np.zeros(cout, np.float32)
            cin = cout
        state[f"lin{s}.model.1.weight"] = np.full((1, cin, 1, 1), 1.0 / cin, np.float32)
    return state


class LPIPS:
    """Callable LPIPS distance; inputs are NHWC images in [-1, 1] (numpy
    arrays or tensors), the result a numpy ``(B,)`` array.  Runs on the card
    unless ``device`` says otherwise."""

    def __init__(self, weights_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if weights_path is None or not os.path.exists(weights_path or ""):
            raise FileNotFoundError(
                "LPIPS needs a local VGG weight archive (no network egress to "
                "download one). Convert torch lpips.LPIPS(net='vgg') weights "
                "to .npz and pass its path.")
        self.device = resolve_device(device)
        raw = dict(np.load(weights_path))
        self.calibrated = "_uncalibrated" not in raw
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        self.shift = t(raw["scaling_layer.shift"]).reshape(1, 3, 1, 1)
        self.scale = t(raw["scaling_layer.scale"]).reshape(1, 3, 1, 1)
        self.convs: List[List[tuple]] = [
            [(t(raw[f"net.slice{s + 1}.{lid}.weight"]), t(raw[f"net.slice{s + 1}.{lid}.bias"]))
             for lid in layer_ids]
            for s, layer_ids in enumerate(_VGG_SLICES)]
        self.lins = [t(raw[f"lin{s}.model.1.weight"][:, :, 0, 0].T)[:, 0] for s in range(5)]

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - self.shift) / self.scale
        feats = []
        for s, slice_convs in enumerate(self.convs):
            if s > 0:
                x = F.max_pool2d(x, 2, 2)
            for w, b in slice_convs:
                x = torch.relu(F.conv2d(x, w, b, padding=1))
            feats.append(x)
        return feats

    def _distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa, fb = self._features(a), self._features(b)
        total = 0.0
        for s in range(5):
            na = fa[s] / torch.sqrt(torch.sum(fa[s] ** 2, dim=1, keepdim=True) + 1e-10)
            nb = fb[s] / torch.sqrt(torch.sum(fb[s] ** 2, dim=1, keepdim=True) + 1e-10)
            cal = torch.einsum("bchw,c->bhw", (na - nb) ** 2, self.lins[s])
            total = total + cal.mean(dim=(1, 2))
        return total

    def __call__(self, a, b) -> np.ndarray:
        """LPIPS distance between NHWC [-1, 1] image batches."""
        nchw = lambda x: torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                                         else x).to(self.device, torch.float32).permute(0, 3, 1, 2)
        with torch.inference_mode():
            return self._distance(nchw(a), nchw(b)).cpu().numpy()
