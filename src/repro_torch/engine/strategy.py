"""Strategy interface + registry for the federation engine.

A federated method is a ``Strategy``: ``init → local_update → aggregate →
evaluate`` hooks over client state dicts whose leaves lead with the
client axis M. The engine (``repro_torch.engine.loop``) owns the round loop,
batch sampling, eval cadence and history.

Registry: ``@register_strategy("name")`` on the class; ``get_strategy("name")``
returns the class.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

_REGISTRY: Dict[str, type] = {}

# noise(step, (M, D)) -> the round's Eq. 11 standard-normal draw for one
# local step, handed to ``Strategy.local_update`` by the round schedule
NoiseFn = Callable[[int, Tuple[int, int]], torch.Tensor]


def register_strategy(name: str) -> Callable[[type], type]:
    """Class decorator: register a Strategy subclass under ``name``."""
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_strategy(name: str) -> type:
    if name not in _REGISTRY:
        raise KeyError(f"unknown strategy {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@dataclass(eq=False)
class FederatedData:
    """Client-stacked datasets on the run's device for the whole run:
    ``train_x (M, R, F)``, ``train_y (M, R)`` int64; test likewise."""
    train_x: torch.Tensor
    train_y: torch.Tensor
    test_x: torch.Tensor
    test_y: torch.Tensor

    def __post_init__(self):
        devices = {t.device for t in (self.train_x, self.train_y,
                                      self.test_x, self.test_y)}
        if len(devices) != 1:
            raise ValueError(f"FederatedData tensors span devices {devices}")

    @property
    def num_clients(self) -> int:
        return self.train_y.shape[0]


@dataclass(eq=False)
class Strategy:
    """Base class for federated methods run by the engine."""

    name = "base"

    def init(self, draws, data: FederatedData, batch_size: Optional[int]):
        """Build the initial client-stacked state."""
        raise NotImplementedError

    def local_update(self, state, xs, ys, r: int, noise: NoiseFn):
        """One round of local training on the sampled (M, B, ...) batches.
        Returns ``(state, metrics)``, metrics a dict of 0-d tensors."""
        raise NotImplementedError

    def aggregate(self, state, r: int):
        """Communication/aggregation after the local updates (identity by
        default)."""
        return state

    def evaluate(self, state, test_x, test_y) -> torch.Tensor:
        """(M,) per-client test accuracy."""
        raise NotImplementedError
