"""The federated-simulation engine: one round loop for every method.

A plain Python loop over rounds; the round itself is owned by a
``RoundSchedule``. Every method shares the eval cadence and the ``History``
record. An optional ``PrivacyLedger`` is advanced per chunk of rounds
between eval points and its cumulative (ε, δ) lands in ``History.metrics``
at every eval round.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.engine.accounting import PrivacyLedger
from repro_torch.engine.schedule import FullParticipation, RoundSchedule
from repro_torch.engine.strategy import FederatedData, Strategy


@dataclass
class History:
    """Metrics record shared by every trainer."""
    rounds: List[int] = field(default_factory=list)
    accuracy: List[float] = field(default_factory=list)
    metrics: Dict[str, List[float]] = field(default_factory=dict)

    @staticmethod
    def _scalar(key: str, v) -> float:
        if isinstance(v, (bool, int, float)):
            return float(v)
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            return float(v)
        raise TypeError(f"History.record: metric {key!r} must be a scalar or "
                        f"0-d tensor, got {type(v).__name__} {v!r}")

    def record(self, r: int, acc, metrics: Optional[Dict] = None) -> None:
        self.rounds.append(int(r))
        self.accuracy.append(self._scalar("accuracy", acc))
        for k, v in (metrics or {}).items():
            self.metrics.setdefault(k, []).append(self._scalar(k, v))


def eval_rounds(start: int, rounds: int, eval_every: int) -> List[int]:
    """After round r when r % eval_every == 0, plus the final round."""
    ev = max(int(eval_every), 1)
    out = [r for r in range(start, rounds) if r % ev == 0]
    if rounds - 1 >= start and (rounds - 1) not in out:
        out.append(rounds - 1)
    return out


@dataclass(eq=False)
class Engine:
    """Owns the round loop; the strategy owns the method."""
    strategy: Strategy
    eval_every: int = 20
    schedule: Optional[RoundSchedule] = None
    ledger: Optional[PrivacyLedger] = None

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = FullParticipation()

    def run_rounds(self, state, data: FederatedData, draws, phase: int,
                   start: int, stop: int, batch_size: Optional[int]):
        """Rounds [start, stop); returns (state, {metric: per-round list})."""
        metrics: Dict[str, List[torch.Tensor]] = {}
        for r in range(start, stop):
            state, m = self.schedule.run_round(self.strategy, state, data, r,
                                               draws, phase, batch_size)
            for k, v in m.items():
                metrics.setdefault(k, []).append(v)
        return state, metrics

    def fit(self, data: FederatedData, *, rounds: int, draws, phase: int,
            batch_size: Optional[int] = None, start_round: int = 0,
            state=None, evaluate: bool = True,
            history: Optional[History] = None):
        """Run one phase of training: rounds [start_round, rounds).

        ``state=None`` initializes via the strategy. With ``evaluate=False``
        the phase runs with no eval (P4's bootstrap). ``phase`` names the
        phase to the random source."""
        history = history if history is not None else History()
        if state is None:
            state = self.strategy.init(draws, data, batch_size)
        boundaries = (eval_rounds(start_round, rounds, self.eval_every)
                      if evaluate else [])
        cursor = start_round
        for ev in boundaries:
            state, metrics = self.run_rounds(state, data, draws, phase,
                                             cursor, ev + 1, batch_size)
            if self.ledger is not None:
                self.ledger.advance(ev + 1 - cursor)
            cursor = ev + 1
            acc = self.strategy.evaluate(state, data.test_x, data.test_y)
            chunk_means = {k: torch.stack(v).mean() for k, v in metrics.items()}
            if self.ledger is not None:
                chunk_means.update(self.ledger.metrics())
            history.record(ev, acc.mean(), chunk_means)
        if cursor < rounds:   # tail (or the whole phase when evaluate=False)
            state, _ = self.run_rounds(state, data, draws, phase, cursor,
                                       rounds, batch_size)
            if self.ledger is not None:
                self.ledger.advance(rounds - cursor)
        return state, history
