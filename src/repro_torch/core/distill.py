"""Deep-mutual-learning losses between proxy and private models (paper
Eqs. 6–9). The other model's logits are a detached target."""
from __future__ import annotations

import torch

from repro_torch.models.layers import kl_divergence, softmax_cross_entropy


def proxy_loss(proxy_logits: torch.Tensor, private_logits: torch.Tensor,
               labels: torch.Tensor, alpha: float,
               temperature: float = 1.0) -> torch.Tensor:
    """Eq. 8: L_w = (1−α)·CE(f_w, y) + α·KL(f_w ‖ f_θ)."""
    ce = softmax_cross_entropy(proxy_logits, labels)
    kl = kl_divergence(proxy_logits, private_logits.detach(), temperature)
    return (1.0 - alpha) * ce + alpha * kl


def private_loss(private_logits: torch.Tensor, proxy_logits: torch.Tensor,
                 labels: torch.Tensor, beta: float,
                 temperature: float = 1.0) -> torch.Tensor:
    """Eq. 9: L_θ = (1−β)·CE(f_θ, y) + β·KL(f_θ ‖ f_w)."""
    ce = softmax_cross_entropy(private_logits, labels)
    kl = kl_divergence(private_logits, proxy_logits.detach(), temperature)
    return (1.0 - beta) * ce + beta * kl
