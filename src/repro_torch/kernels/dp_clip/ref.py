"""Plain PyTorch versions of the dp_clip kernels (the CPU path, and what the
CUDA kernels are held against on the card)."""
from __future__ import annotations

from typing import Optional

import torch


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> per-row Σ g² (...), f32."""
    x = x.float()
    return (x * x).sum(-1)


def scale_accumulate(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(..., B, D), (..., B) -> Σ_b scales_b · x_b (..., D), f32."""
    return (x.float() * scales.float().unsqueeze(-1)).sum(-2)


def clip_scales(sq: torch.Tensor, clip: float, denom: float = 1.0) -> torch.Tensor:
    """min(1, C / max(‖g‖, 1e-12)) / denom from squared norms (Eq. 10, with
    the 1/denom mean folded in)."""
    norms = torch.sqrt(sq)
    return torch.clamp(clip / torch.clamp(norms, min=1e-12), max=1.0) / denom


def clip_scale_accumulate(x: torch.Tensor, sq: torch.Tensor, clip: float,
                          denom: float = 1.0) -> torch.Tensor:
    """The CUDA ``scale_accumulate`` kernel's function: clip scales from the
    squared norms, then Σ_b s_b · x_b."""
    return scale_accumulate(x, clip_scales(sq, clip, denom))


def clip_accumulate(x: torch.Tensor, clip: float, denom: float = 1.0) -> torch.Tensor:
    """Σ_b clip(g_b)/denom over (..., B, D) -> (..., D)."""
    return clip_scale_accumulate(x, sq_norms(x), clip, denom)


def add_flat_noise(out: torch.Tensor, z: Optional[torch.Tensor], sigma: float,
                   clip: float, denom: float) -> torch.Tensor:
    """Eq. 11 noise on a flat buffer: out + (2C/denom)·σ·z, z ~ N(0, 1) of
    ``out``'s shape from the run's random source.

    σ > 0 without a draw is a silent privacy violation, so it raises. The
    scale is an f32 product of f32(2C/denom) and f32(σ), as in the JAX
    package."""
    if not sigma:
        return out
    if z is None:
        raise ValueError("sigma > 0 requires a noise draw (refusing to return "
                         "unnoised gradients from a DP path)")
    scale = (torch.tensor(2.0 * clip / denom, dtype=torch.float32)
             * torch.tensor(float(sigma), dtype=torch.float32))
    return out + scale.to(out.device) * z
