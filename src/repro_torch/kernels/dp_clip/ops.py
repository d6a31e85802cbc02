"""Device-routed dp_clip passes: the CUDA kernels on a CUDA tensor, the
plain versions in ``ref`` on a CPU tensor. There is no other route: a CUDA
tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.dp_clip import kernel, ref


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N,) f32."""
    return kernel.sq_norms(x) if x.is_cuda else ref.sq_norms(x)


def clip_scale_accumulate(x: torch.Tensor, sq: torch.Tensor, clip: float,
                          denom: float = 1.0) -> torch.Tensor:
    """(M, B, D), (M, B) -> (M, D) f32."""
    if x.is_cuda:
        return kernel.scale_accumulate(x, sq, clip, denom)
    return ref.clip_scale_accumulate(x, sq, clip, denom)


def clip_accumulate(x: torch.Tensor, clip: float, denom: float = 1.0) -> torch.Tensor:
    """(M, B, D) per-example flat grads -> Σ_b clipped(g_b)/denom (M, D) f32.

    Two passes over the matrix with the client axis written out: squared
    norms of all M·B rows, then the clip-scale-accumulate pass."""
    M, B, D = x.shape
    sq = sq_norms(x.reshape(M * B, D)).reshape(M, B)
    return clip_scale_accumulate(x, sq, clip, denom)
