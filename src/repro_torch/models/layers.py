"""Losses (counterpart of ``repro.models.layers``, without mask or z-loss)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE; logits (..., V) in f32, labels int (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - ll)


def kl_divergence(p_logits: torch.Tensor, q_logits: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """KL(p ‖ q) over the last axis — the paper's Eq. 7 distillation loss."""
    t = temperature
    p = F.log_softmax(p_logits.float() / t, dim=-1)
    q = F.log_softmax(q_logits.float() / t, dim=-1)
    return torch.mean(torch.sum(torch.exp(p) * (p - q), dim=-1)) * t * t
