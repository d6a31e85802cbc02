"""Device-routed pairwise ℓ1: the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.l1_distance import kernel, ref


def pairwise_l1(x: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M, M) f32 ℓ1 distances (paper Eq. 3)."""
    return kernel.pairwise_l1(x) if x.is_cuda else ref.pairwise_l1(x)
