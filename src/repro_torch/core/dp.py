"""Differential privacy machinery (paper §3.3 Phase 2, Eqs. 10–12).

* ``noble_sigma`` — Eq. 12 (Noble et al. 2022 bound with l = M' = 1).
* ``rdp_increment`` / ``rdp_to_epsilon`` / ``rdp_epsilon`` /
  ``calibrate_sigma`` — the Rényi-DP accountant for the subsampled Gaussian
  (Mironov 2017). Pure math, copied verbatim from the JAX package.
* ``dp_gradients`` — exact per-example clipped and noised gradients for a
  stack of M clients: per-example gradients by ``torch.func.vmap(grad)``
  over clients and examples, then the dispatch pipeline on the flat
  (M, B, D) matrix (Eqs. 10–11).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch.func import grad, vmap

from repro_torch.config import KernelConfig
from repro_torch.kernels import dispatch


# ---------------------------------------------------------------------------
# Eq. 12 — Noble et al. σ bound (P2P: l = M' = 1)
# ---------------------------------------------------------------------------

def noble_sigma(epsilon: float, delta: float, *, sample_rate: float = 1.0,
                rounds: int = 100, local_steps: int = 1, client_ratio: float = 1.0,
                num_aggregated: int = 1) -> float:
    """σ_g = s·sqrt(l·T·K·log(2Tl/δ)·log(2/δ)) / (ε·sqrt(M'))  (Eq. 12)."""
    s, T, K, l, M = sample_rate, rounds, local_steps, client_ratio, num_aggregated
    return float(s * math.sqrt(l * T * K * math.log(2 * T * l / delta)
                               * math.log(2 / delta)) / (epsilon * math.sqrt(M)))


# ---------------------------------------------------------------------------
# RDP accountant (subsampled Gaussian)
# ---------------------------------------------------------------------------

RDP_ORDERS = tuple([1.5, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 128])


def _rdp_gaussian(sigma: float, alpha: float) -> float:
    return alpha / (2.0 * sigma ** 2)


def _log_comb(n, k):
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def _rdp_subsampled(q: float, sigma: float, alpha: int) -> float:
    """Mironov et al. computable bound for Poisson-subsampled Gaussian,
    integer α ≥ 2."""
    if q == 1.0:
        return _rdp_gaussian(sigma, alpha)
    if q == 0.0:
        return 0.0
    # log of sum_{k=0}^{alpha} C(alpha,k) (1-q)^{alpha-k} q^k exp(k(k-1)/(2σ²))
    logs = []
    for k in range(alpha + 1):
        log_term = (_log_comb(alpha, k) + (alpha - k) * math.log1p(-q)
                    + k * math.log(q) + (k * (k - 1)) / (2.0 * sigma ** 2))
        logs.append(log_term)
    m = max(logs)
    total = m + math.log(sum(math.exp(l - m) for l in logs))
    return total / (alpha - 1)


def rdp_increment(q: float, sigma: float, alpha: float) -> float:
    """Per-step RDP of the subsampled Gaussian at order ``alpha``; orders the
    subsampled bound cannot use (non-integer α when q < 1) return ``inf``."""
    if q >= 1.0:
        return _rdp_gaussian(sigma, alpha)
    if alpha == int(alpha) and alpha >= 2:
        return _rdp_subsampled(q, sigma, int(alpha))
    return math.inf


def rdp_to_epsilon(rdp: float, alpha: float, delta: float) -> float:
    """RDP(α) → (ε, δ)-DP via the Balle et al. / Canonne conversion."""
    if not math.isfinite(rdp):
        return math.inf
    return rdp + math.log1p(-1.0 / alpha) - math.log(delta * alpha) / (alpha - 1)


def rdp_epsilon(sigma: float, q: float, steps: int, delta: float) -> float:
    """(ε, δ)-DP of ``steps`` compositions of the subsampled Gaussian."""
    return min(rdp_to_epsilon(steps * rdp_increment(q, sigma, alpha),
                              alpha, delta)
               for alpha in RDP_ORDERS)


def calibrate_sigma(target_eps: float, delta: float, q: float, steps: int,
                    lo: float = 0.2, hi: float = 200.0) -> float:
    """Binary-search the smallest σ meeting (ε, δ) after ``steps`` rounds."""
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if rdp_epsilon(mid, q, steps, delta) > target_eps:
            lo = mid
        else:
            hi = mid
    return hi


# ---------------------------------------------------------------------------
# DP gradients — exact per-example, clients written out
# ---------------------------------------------------------------------------

def per_example_grads(loss_fn: Callable, params: Dict, batch: Dict) -> Dict:
    """Gradients of ``loss_fn(p, batch_of_one)`` for every example of every
    client: params lead with M, batch leaves with (M, B); the result's
    leaves lead with (M, B)."""
    def one(p, ex):
        return grad(loss_fn)(p, {k: v.unsqueeze(0) for k, v in ex.items()})
    return vmap(vmap(one, in_dims=(None, 0)))(params, batch)


def dp_gradients(loss_fn: Callable, params: Dict, batch: Dict,
                 z: Optional[torch.Tensor], *, clip: float, sigma: float,
                 microbatches: int = 0, per_example_chunk: int = 0,
                 kernels: Optional[KernelConfig] = None) -> Dict:
    """Clipped + noised gradient of ``loss_fn(params, batch) -> scalar`` for
    each of M clients (leading axis of ``params`` and of every batch leaf).

    Exact per-example DP-SGD: per-example gradients, flattened to one
    (M, B, D) f32 matrix, then the dispatch pipeline reads it twice (norm
    pass, clip-scale-accumulate pass) and adds (2C/B)·σ·z with ``z`` the
    (M, D) standard-normal draw. Only ``microbatches == 0`` and
    ``per_example_chunk == 0`` are ported."""
    if microbatches or per_example_chunk:
        raise NotImplementedError("only exact per-example DP (microbatches=0, "
                                  "per_example_chunk=0) is ported")
    n = next(iter(batch.values())).shape[1]
    return dispatch.dp_clip(per_example_grads(loss_fn, params, batch), clip, z,
                            sigma=sigma, denom=float(n), kernels=kernels)
