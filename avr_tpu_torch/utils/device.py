"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks.

    ``None`` means ``cuda``; without a usable card that raises instead of
    carrying on on the CPU.  Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels on the host (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "avr_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
