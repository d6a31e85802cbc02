"""The single entry point through which the port reaches its kernels.

Backend policy (``KernelConfig.backend``):

  * ``auto`` — by the tensor's device: the hand-written CUDA kernel on a
    CUDA tensor, the plain PyTorch version on a CPU tensor.
  * ``cuda`` — the CUDA kernel; a CPU tensor raises instead of degrading.

Fused DP-SGD entry points (paper Eqs. 10–11): ``dp_clip`` / ``dp_clip_flat``
read the (M, B, D) per-example matrix twice (norm pass, clip-scale-
accumulate pass with the 1/denom mean folded into the scales) and add the
Eq. 11 noise once on the (M, D) output.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import KernelConfig
from repro_torch.kernels.dp_clip import kernel as dp_kernel, ops as dp_ops, ref as dp_ref
from repro_torch.kernels.l1_distance import kernel as l1_kernel, ops as l1_ops
from repro_torch.utils.pytree import flatten_concat, unflatten_concat

_BACKENDS = ("auto", "cuda")
KERNELS = {"sq_norms": dp_kernel.sq_norms,
           "scale_accumulate": dp_kernel.scale_accumulate,
           "pairwise_l1": l1_kernel.pairwise_l1}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _check_backend(x: torch.Tensor, kernels: Optional[KernelConfig]) -> None:
    requested = (kernels or KernelConfig()).backend
    if requested not in _BACKENDS:
        raise ValueError(f"unknown kernel backend {requested!r}; "
                         f"expected one of {_BACKENDS}")
    if requested == "cuda" and not x.is_cuda:
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got device "
                         f"{x.device}; use backend='auto' for the plain version")


def clip_accumulate(flat: torch.Tensor, clip: float, *, denom: float = 1.0,
                    kernels: Optional[KernelConfig] = None) -> torch.Tensor:
    """flat: (M, B, D) per-example grads -> Σ_b clipped(g_b)/denom (M, D) f32."""
    _check_backend(flat, kernels)
    return dp_ops.clip_accumulate(flat, clip, denom)


def dp_clip_flat(flat: torch.Tensor, clip: float, z: Optional[torch.Tensor] = None,
                 *, sigma: float = 0.0, denom: float = 1.0,
                 kernels: Optional[KernelConfig] = None) -> torch.Tensor:
    """Clipped mean plus Eq. 11 noise on a flat (M, B, D) matrix; ``z`` is
    the (M, D) standard-normal draw. σ > 0 without ``z`` raises before the
    clip passes run."""
    if sigma and z is None:
        raise ValueError("sigma > 0 requires a noise draw (privacy guard)")
    out = clip_accumulate(flat, clip, denom=denom, kernels=kernels)
    return dp_ref.add_flat_noise(out, z, sigma, clip, denom)


def dp_clip(per_example_grads: Dict, clip: float, z: Optional[torch.Tensor] = None,
            *, sigma: float = 0.0, denom: Optional[float] = None,
            kernels: Optional[KernelConfig] = None) -> Dict:
    """Flatten→norm→scale→accumulate→noise over a per-example gradient dict
    whose leaves lead with (M, B) -> noised mean dict with leaves (M, ...)."""
    flat = flatten_concat(per_example_grads, batch_dims=2)       # (M, B, D)
    if denom is None:
        denom = float(flat.shape[1])
    out = dp_clip_flat(flat, clip, z, sigma=sigma, denom=denom, kernels=kernels)
    return unflatten_concat(out, _first_example(per_example_grads))


def _first_example(tree):
    if isinstance(tree, dict):
        return {k: _first_example(v) for k, v in tree.items()}
    return tree[0, 0]


def pairwise_l1(weights: torch.Tensor,
                kernels: Optional[KernelConfig] = None) -> torch.Tensor:
    """weights: (M, D) -> (M, M) ℓ1 distances (paper Eq. 3)."""
    _check_backend(weights, kernels)
    return l1_ops.pairwise_l1(weights)
