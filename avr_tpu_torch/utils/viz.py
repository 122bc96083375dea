"""Visualization helpers (port of ``avr_tpu/utils/viz.py``): prediction,
ground truth and depth panels, and loss curves, written to files
(matplotlib with the Agg backend, imported inside the functions).

Counterpart of the reference's plotting utilities
(the reference's ``utils.py:407-429`` and ``train.py:316-317``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["plot_output_ground_truth", "plot_losses"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_output_ground_truth(render_out, gt, resolution, fine: bool = True,
                             save_path: Optional[str] = None):
    """3-panel figure: prediction, ground truth, depth (first scene).
    ``render_out`` is a ``RenderOutput`` (or its tuple: ``rgb_coarse,
    rgb_fine, _, depth``); ``resolution`` is ``(H, W, 3)``."""
    plt = _pyplot()
    rgbs = render_out[1] if fine else render_out[0]
    depth = render_out[3]
    img = _np(rgbs)[0].reshape(*resolution)
    gt_img = _np(gt)[0].reshape(*resolution)
    depth_img = _np(depth)[0].reshape(*resolution[:2])

    fig, axes = plt.subplots(1, 3, figsize=(18, 6), squeeze=False)
    axes[0, 0].imshow(np.clip(img, 0, 1))
    axes[0, 0].set_title("Trained MLP")
    axes[0, 1].imshow(np.clip(gt_img, 0, 1))
    axes[0, 1].set_title("Ground Truth")
    im = axes[0, 2].imshow(depth_img, cmap="Greys")
    axes[0, 2].set_title("Depth")
    for j in range(3):
        axes[0, j].set_axis_off()
    fig.colorbar(im, ax=axes[0, 2])
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_losses(losses: Sequence[float], start_epoch: int, save_path: str) -> str:
    """The mean loss of each epoch against its epoch number, to ``save_path``."""
    plt = _pyplot()
    fig = plt.figure()
    plt.plot(range(start_epoch, start_epoch + len(losses)), losses)
    plt.xlabel("epoch")
    plt.ylabel("mean loss")
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path
