"""Plain PyTorch version of the pairwise-ℓ1 kernel."""
from __future__ import annotations

import torch


def pairwise_l1(x: torch.Tensor) -> torch.Tensor:
    """x: (M, D) -> (M, M) ℓ1 distances in f32, one row at a time so that
    no (M, M, D) intermediate is formed."""
    x = x.float()
    return torch.stack([(x - row).abs().sum(-1) for row in x]) if len(x) \
        else x.new_zeros((0, 0))
