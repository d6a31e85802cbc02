"""Carry parameters between the JAX package and the port as numpy arrays.

Both packages keep the same layout (``w`` (F, C), ``b`` (C,), stacked client
state with a leading M axis), so a conversion is a copy, leaf by leaf."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree, device="cpu") -> Dict:
    """A (nested) dict of numpy-convertible arrays -> dict of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_to_numpy(tree) -> Dict:
    """Inverse of :func:`params_from_jax`: dict of tensors -> dict of numpy
    arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
