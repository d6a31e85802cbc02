"""The paper's linear client model (§4.1): one layer + softmax on ScatterNet
features. Parameters keep the JAX layout: ``w`` (F, C), ``b`` (C,)."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def linear_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: (..., B, F) -> logits (..., B, C); leading axes batch over clients."""
    return torch.matmul(x, params["w"].float()) + params["b"].unsqueeze(-2)


def linear_from_normal(z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``fan_in`` init from a standard-normal (F, C) draw: w = z/√F, b = 0."""
    F, C = z.shape
    return {"w": z.float() / math.sqrt(F),
            "b": torch.zeros((C,), dtype=torch.float32, device=z.device)}


def init_linear(feat_dim: int, num_classes: int,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """w ~ N(0, 1)/√F, b = 0 (``repro.models.module.init_params`` fan_in)."""
    z = torch.randn((feat_dim, num_classes), generator=generator,
                    device=device, dtype=torch.float32)
    return linear_from_normal(z)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the last (example) axis: (..., B, C), (..., B) -> (...)."""
    return (torch.argmax(logits, -1) == labels).float().mean(-1)
