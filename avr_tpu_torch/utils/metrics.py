"""Image quality metrics: PSNR and SSIM (skimage-compatible), LPIPS gate
(port of ``avr_tpu/utils/metrics.py``, the same numpy code; render outputs
may hold torch tensors, on any device).

The reference computes metrics with ``skimage.metrics`` (reference
``utils.py:431-461``) and LPIPS-VGG at test time (reference ``test.py:24``).
Neither package ships in this environment, so:

  * :func:`psnr` / :func:`ssim` are from-scratch numpy implementations
    matching skimage's definitions for the settings the reference uses
    (``data_range=1``, ``channel_axis=-1``, default 7x7 uniform window with
    sample-covariance normalization, border crop of ``(win-1)//2``),
  * :func:`lpips_vgg` requires a locally provided VGG-LPIPS weight file
    (this environment has no network egress to download one) and raises a
    clear error otherwise.

:func:`get_metrics` mirrors the reference's API over render outputs, but
averages over *all* scenes/views (the reference accidentally returns the
last view's value; SURVEY.md §2 "Metrics").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["psnr", "ssim", "get_metrics", "lpips_vgg"]


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio, matching skimage.peak_signal_noise_ratio."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    mse = np.mean((pred - gt) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _window_mean(x: np.ndarray, win: int) -> np.ndarray:
    """Mean over all valid win x win windows of a 2D array (integral image)."""
    s = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), axis=0), axis=1)
    sums = (
        s[win:, win:] - s[:-win, win:] - s[win:, :-win] + s[:-win, :-win]
    )
    return sums / (win * win)


def _ssim_single(x: np.ndarray, y: np.ndarray, win: int, data_range: float) -> float:
    """SSIM of one 2D channel: skimage defaults (uniform filter, crop)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    NP = win * win
    cov_norm = NP / (NP - 1)  # sample covariance

    ux = _window_mean(x, win)
    uy = _window_mean(y, win)
    uxx = _window_mean(x * x, win)
    uyy = _window_mean(y * y, win)
    uxy = _window_mean(x * y, win)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux * ux + uy * uy + C1) * (vx + vy + C2)
    )
    return float(S.mean())


def ssim(
    pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0, win_size: int = 7
) -> float:
    """Structural similarity matching skimage.structural_similarity defaults.

    ``pred``/``gt`` are ``(H, W)`` or ``(H, W, C)`` (``channel_axis=-1``);
    multichannel SSIM is the mean of the per-channel values.
    """
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    if pred.ndim == 2:
        return _ssim_single(pred, gt, win_size, data_range)
    return float(
        np.mean(
            [
                _ssim_single(pred[..., ch], gt[..., ch], win_size, data_range)
                for ch in range(pred.shape[-1])
            ]
        )
    )


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def get_metrics(render_out, gts, fine: bool = True) -> Tuple[float, float]:
    """(mean PSNR, mean SSIM) of a render against ground truth.

    Args:
      render_out: a RenderOutput (or reference-style 4-tuple).
      gts: ``(SB, NV, sl*sl, 3)`` or ``(SB, sl*sl, 3)`` ground truth in [0,1].
      fine: score the fine image (else coarse).
    """
    rgbs = render_out[1] if fine else render_out[0]
    rgbs = _numpy(rgbs)
    gts = _numpy(gts)
    if rgbs.ndim == 4:
        SB, NV, sl2, _ = rgbs.shape
    else:
        SB, sl2, _ = rgbs.shape
        NV = 1
    sl = int(np.sqrt(sl2))
    rgbs = rgbs.reshape(SB, NV, sl, sl, 3)
    gts = gts.reshape(SB, NV, sl, sl, 3)

    psnrs, ssims = [], []
    for sb in range(SB):
        for nv in range(NV):
            psnrs.append(psnr(rgbs[sb, nv], gts[sb, nv], data_range=1.0))
            ssims.append(ssim(rgbs[sb, nv], gts[sb, nv], data_range=1.0))
    return float(np.mean(psnrs)), float(np.mean(ssims))


def lpips_vgg(weights_path: str = None):
    """Perceptual LPIPS-VGG metric factory.

    This zero-egress environment cannot download pretrained VGG weights;
    supply ``weights_path`` pointing at a converted weight archive to
    enable the metric.  See ``avr_tpu_torch/utils/lpips.py``.
    """
    from avr_tpu_torch.utils.lpips import LPIPS

    return LPIPS(weights_path)
