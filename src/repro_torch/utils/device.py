"""Device choice for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The given device, or ``cuda`` when none is given.

    Without CUDA and without an explicit device this raises: the port never
    falls back to the CPU silently (pass ``device="cpu"`` to ask for it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return torch.device("cuda")
