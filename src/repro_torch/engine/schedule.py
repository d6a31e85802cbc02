"""Round schedules: who participates in a round and how updates merge.
Only ``FullParticipation`` (every client, every round, synchronous
aggregation) is ported.

Per-round draws are asked of the run's random source by (phase, round):
batch indices first, then the local steps' noise."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.config import ScheduleConfig


def sample_client_batches(train_x: torch.Tensor, train_y: torch.Tensor, draws,
                          phase: int, r: int, batch_size: Optional[int]):
    """Per-client minibatches (M, B, ...), (M, B) gathered on the data's
    device. ``batch_size=None`` means full batch: the stacks unchanged and
    no draw (P4's bootstrap phase)."""
    if batch_size is None:
        return train_x, train_y
    M, R = train_y.shape
    idx = draws.batch_indices(phase, r, (M, batch_size), R).to(train_y.device)
    rows = torch.arange(M, device=train_y.device).unsqueeze(1)
    return train_x[rows, idx], train_y[rows, idx]


@dataclass(eq=False)
class RoundSchedule:
    """Owns one round: sample, local update, aggregate."""

    name = "base"

    def client_fraction(self, M: Optional[int] = None) -> float:
        """Expected fraction of clients participating per round."""
        return 1.0

    def run_round(self, strategy, state, data, r: int, draws, phase: int,
                  batch_size: Optional[int]):
        raise NotImplementedError


@dataclass(eq=False)
class FullParticipation(RoundSchedule):
    """Every client, every round, synchronous aggregation."""

    name = "full"

    def run_round(self, strategy, state, data, r, draws, phase, batch_size):
        xs, ys = sample_client_batches(data.train_x, data.train_y, draws,
                                       phase, r, batch_size)
        state, metrics = strategy.local_update(
            state, xs, ys, r, lambda step, shape: draws.noise(phase, r, step, shape))
        return strategy.aggregate(state, r), metrics


def make_schedule(cfg: ScheduleConfig) -> RoundSchedule:
    if cfg.kind != "full":
        raise NotImplementedError(f"schedule {cfg.kind!r} is not ported; "
                                  f"only 'full' is")
    return FullParticipation()
