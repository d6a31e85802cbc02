"""Client-side batching utilities for the P4 experiments."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def train_test_split(idx: np.ndarray, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(idx)
    n_test = max(1, int(len(perm) * test_frac))
    return perm[n_test:], perm[:n_test]


def client_batches(images: np.ndarray, labels: np.ndarray, idx: np.ndarray,
                   batch_size: int, rng: np.random.Generator):
    """One epoch of shuffled batches for a client's index set."""
    perm = rng.permutation(idx)
    for i in range(0, len(perm) - batch_size + 1, batch_size):
        sel = perm[i : i + batch_size]
        yield images[sel], labels[sel]


def stack_client_data(images, labels, client_idx: List[np.ndarray], n: int):
    """(M, n, ...) stacked arrays for vmapped multi-client training
    (clients are vmapped on the host CPU; on the production mesh each pod
    hosts a client group — see DESIGN.md §4)."""
    xs, ys = [], []
    for idx in client_idx:
        take = np.resize(idx, n)
        xs.append(images[take])
        ys.append(labels[take])
    return np.stack(xs), np.stack(ys)
