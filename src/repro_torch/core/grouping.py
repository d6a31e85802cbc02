"""Phase 1 — decentralized group formation (paper §3.3, Eqs. 3–5).

Dissimilarity is the ℓ1 norm between flattened proxy weights after the
bootstrap (DP) local steps. The M×M distance matrix goes through
``repro_torch.kernels.dispatch`` (the CUDA kernel on the card, the plain
version on the CPU); the greedy procedure itself is host-side NumPy, a copy
of the JAX package's, so identical distances give identical groups.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import KernelConfig
from repro_torch.kernels import dispatch
from repro_torch.utils.pytree import flatten_concat


def flatten_clients(stacked_params: Dict) -> torch.Tensor:
    """Stacked client params (M, ...) dict -> (M, D) f32 weight matrix."""
    return flatten_concat(stacked_params, batch_dims=1)


def pairwise_l1(weights: torch.Tensor,
                kernels: Optional[KernelConfig] = None) -> torch.Tensor:
    """weights: (M, D) -> (M, M) ℓ1 distances (Eq. 3), backend-dispatched."""
    return dispatch.pairwise_l1(weights, kernels=kernels)


def greedy_group_formation(dist: np.ndarray, group_size: int,
                           sample_peers: int = 35, seed: int = 0,
                           neighborhoods: Optional[np.ndarray] = None,
                           ) -> List[List[int]]:
    """The paper's three-step greedy procedure. ``dist`` is the full M×M
    matrix; sampling masks it to H peers per client (decentralized view).

    ``neighborhoods`` (optional (M, M) boolean adjacency) restricts each
    client's peer sampling to its communication-graph neighbors — clients can
    only measure dissimilarity against peers they can actually reach, so group
    formation respects a configured topology instead of assuming a clique.
    """
    rng = np.random.default_rng(seed)
    M = dist.shape[0]
    H = min(sample_peers, M - 1)

    # -- sampled visibility mask (each client only knows H random peers) ----
    known = np.zeros((M, M), bool)
    for i in range(M):
        if neighborhoods is not None:
            cands = [j for j in range(M)
                     if j != i and bool(neighborhoods[i, j])]
        else:
            cands = [j for j in range(M) if j != i]
        h = min(H, len(cands))
        if h > 0:
            peers = rng.choice(cands, h, replace=False)
            known[i, peers] = True
    known |= known.T                      # measurements are symmetric
    masked = np.where(known, dist, np.inf)

    # -- step 2: mutual pairs ------------------------------------------------
    ungrouped = set(range(M))
    groups: List[List[int]] = []
    best = np.argmin(masked + np.where(np.eye(M, dtype=bool), np.inf, 0), axis=1)
    for i in range(M):
        j = int(best[i])
        if i < j and best[j] == i and i in ungrouped and j in ungrouped:
            groups.append([i, j])
            ungrouped -= {i, j}
    # unpaired clients join most-similar ungrouped peer
    for i in sorted(ungrouped):
        if i not in ungrouped:
            continue
        cands = [j for j in sorted(ungrouped) if j != i]
        if not cands:
            break
        j = min(cands, key=lambda j: masked[i, j])
        if not np.isfinite(masked[i, j]):
            j = int(rng.choice(cands))
        groups.append([i, j])
        ungrouped -= {i, j}
    for i in sorted(ungrouped):          # odd leftover joins a random pair
        if groups:
            groups[rng.integers(len(groups))].append(i)
        else:
            # no pair ever formed (M == 1, or every peer unreachable under a
            # restricted neighborhood): a degenerate singleton group is the
            # only valid answer — rng.integers(0) would raise
            groups.append([i])

    # -- step 3: merge groups until size T ----------------------------------
    def gdist(a: Sequence[int], b: Sequence[int]) -> float:
        # paper: group similarity ≈ max member-pair similarity (min distance)
        vals = [masked[i, j] for i in a for j in b if np.isfinite(masked[i, j])]
        return min(vals) if vals else np.inf

    while True:
        mergeable = [g for g in groups if len(g) < group_size]
        merged = False
        for g in list(mergeable):
            if g not in groups:
                continue
            partners = [h for h in groups
                        if h is not g and len(h) + len(g) <= group_size]
            if not partners:
                continue
            finite = [h for h in partners if np.isfinite(gdist(g, h))]
            h = (min(finite, key=lambda h: gdist(g, h)) if finite
                 else partners[rng.integers(len(partners))])
            groups.remove(g)
            groups.remove(h)
            groups.append(sorted(g + h))
            merged = True
        if not merged:
            break
    return [sorted(g) for g in groups]


def random_groups(M: int, group_size: int, seed: int = 0) -> List[List[int]]:
    """Ablation baseline (paper §4.4 i)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(M)
    return [sorted(perm[i : i + group_size].tolist())
            for i in range(0, M, group_size)]


def group_ids(groups: List[List[int]], M: int) -> np.ndarray:
    ids = np.zeros((M,), np.int32)
    for gi, g in enumerate(groups):
        for i in g:
            ids[i] = gi
    return ids
