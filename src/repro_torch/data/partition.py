"""The paper's two non-IID partitioners (§4.1).

shard-based (Li et al. [29]): L classes × P shards each; every client gets N
random classes with one random shard per class → M = L·P/N clients.

alpha-based (Hsu et al. [20] / Noble et al. [40]): per client, γ% of samples
drawn IID from all classes, (1−γ)% from one client-specific class.
"""
from __future__ import annotations

from typing import List

import numpy as np


def shard_partition(labels: np.ndarray, num_clients: int, classes_per_client: int,
                    samples_per_client: int, seed: int = 0) -> List[np.ndarray]:
    """Returns per-client index arrays. N = classes_per_client."""
    rng = np.random.default_rng(seed)
    L = int(labels.max()) + 1
    by_class = [rng.permutation(np.where(labels == l)[0]) for l in range(L)]
    per_class = samples_per_client // classes_per_client
    # P shards per class so that M * N = L * P
    P = int(np.ceil(num_clients * classes_per_client / L))
    shard_list = [(l, s) for l in range(L) for s in range(P)]
    rng.shuffle(shard_list)
    clients = []
    ptr = 0
    for _ in range(num_clients):
        idxs = []
        for _ in range(classes_per_client):
            l, s = shard_list[ptr % len(shard_list)]
            ptr += 1
            cls_idx = by_class[l]
            start = (s * per_class) % max(len(cls_idx) - per_class, 1)
            idxs.append(cls_idx[start : start + per_class])
        clients.append(np.concatenate(idxs))
    return clients


def alpha_partition(labels: np.ndarray, num_clients: int, gamma: float,
                    samples_per_client: int, seed: int = 0) -> List[np.ndarray]:
    """γ of each client's data IID over all classes; 1−γ from its own class."""
    rng = np.random.default_rng(seed)
    L = int(labels.max()) + 1
    all_idx = np.arange(len(labels))
    by_class = [np.where(labels == l)[0] for l in range(L)]
    clients = []
    for c in range(num_clients):
        own = c % L
        n_iid = int(round(gamma * samples_per_client))
        n_own = samples_per_client - n_iid
        iid_part = rng.choice(all_idx, n_iid, replace=True)
        own_part = rng.choice(by_class[own], n_own, replace=True)
        clients.append(np.concatenate([iid_part, own_part]))
    return clients
