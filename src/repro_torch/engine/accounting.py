"""Engine-native DP accounting: a composable Rényi-DP ledger (a copy of
``repro.engine.accounting``; pure Python).

The ledger accumulates per-order RDP across training segments that may
differ in sampling rate (P4's full-batch bootstrap at q = 1, then the
co-train phase) and converts to the tightest (ε, δ) on demand. ``Engine.fit``
advances it once per executed chunk of rounds and records the cumulative
spend in ``History.metrics`` at every eval round.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.core import dp as dp_lib


class PrivacyLedger:
    """Cumulative (ε, δ) of a run, composed round-by-round in RDP space.

    One ledger instance follows one training run. ``advance`` adds rounds
    (each ``local_steps`` compositions of the subsampled Gaussian at the
    segment's effective rate); ``epsilon()`` converts the accumulated
    per-order RDP to (ε, δ)-DP, minimized over orders. Segments with
    different q compose exactly because RDP is additive per order.
    """

    def __init__(self, *, sigma: float, delta: float, sample_rate: float = 1.0,
                 client_rate: float = 1.0, local_steps: int = 1):
        self.sigma = float(sigma)
        self.delta = float(delta)
        self.sample_rate = float(sample_rate)
        self.client_rate = float(client_rate)
        self.local_steps = max(int(local_steps), 1)
        self.rounds_seen = 0
        self._rdp: Dict[float, float] = {a: 0.0 for a in dp_lib.RDP_ORDERS}

    # ------------------------------------------------------------------
    @property
    def q(self) -> float:
        """Effective per-step sampling rate: client cohort × data batch."""
        return min(1.0, self.sample_rate * self.client_rate)

    def advance(self, rounds: int, q: Optional[float] = None,
                sigma: Optional[float] = None) -> None:
        """Account ``rounds`` more rounds (``rounds × local_steps`` steps) at
        sampling rate ``q`` (default: the ledger's effective rate) and noise
        ``sigma`` (default: the ledger's)."""
        rounds = int(rounds)
        if rounds <= 0:
            return
        q = self.q if q is None else float(q)
        sigma = self.sigma if sigma is None else float(sigma)
        steps = rounds * self.local_steps
        for a in self._rdp:
            if sigma <= 0.0:
                self._rdp[a] = math.inf    # noiseless release: no DP guarantee
            else:
                self._rdp[a] += steps * dp_lib.rdp_increment(q, sigma, a)
        self.rounds_seen += rounds

    # ------------------------------------------------------------------
    def epsilon(self) -> float:
        """Tightest ε at the ledger's δ for everything advanced so far."""
        if self.rounds_seen == 0:
            return 0.0
        return min(dp_lib.rdp_to_epsilon(r, a, self.delta)
                   for a, r in self._rdp.items())

    def spend(self) -> Tuple[float, float]:
        return self.epsilon(), self.delta

    def metrics(self) -> Dict[str, float]:
        """The per-eval-round History payload."""
        return {"dp_epsilon": self.epsilon(), "dp_delta": self.delta}

    # ------------------------------------------------------------------
    def calibrate(self, target_epsilon: float, rounds: int) -> float:
        """σ such that ``rounds`` future rounds at the ledger's effective rate
        spend at most ``target_epsilon`` — the request-ε-instead-of-σ hook.
        Sets (and returns) the ledger's σ so subsequent ``advance`` calls
        account at the calibrated noise. Raises if no σ in the bisection
        bracket meets the target (silently running over a budget the caller
        explicitly requested is the one thing an accountant must not do)."""
        return self.calibrate_segments(target_epsilon, [(int(rounds), None)])

    def calibrate_segments(self, target_epsilon: float, segments,
                           lo: float = 0.2, hi: float = 200.0) -> float:
        """Like ``calibrate`` but for a run composed of segments with
        different sampling rates — e.g. P4's full-batch bootstrap at q = 1
        followed by a subsampled co-train phase. ``segments`` is a list of
        ``(rounds, q)`` pairs (q = None means the ledger's effective rate);
        bisects the smallest σ whose total composed spend meets the target.

        Spend already accumulated on this ledger (e.g. rounds restored by a
        checkpoint resume) composes into the target: the calibrated σ makes
        the WHOLE trajectory — past plus future segments — land on
        ``target_epsilon``, so calibrate-then-resume cannot overrun the
        budget the caller asked for."""
        segs = [(int(r), self.q if q is None else float(q))
                for r, q in segments if r > 0]
        base = dict(self._rdp)   # RDP already spent before this calibration

        def spend(sigma: float) -> float:
            return min(
                dp_lib.rdp_to_epsilon(
                    base[a]
                    + sum(r * self.local_steps * dp_lib.rdp_increment(q, sigma, a)
                          for r, q in segs),
                    a, self.delta)
                for a in dp_lib.RDP_ORDERS)

        if spend(hi) > target_epsilon:
            raise ValueError(
                f"target epsilon {target_epsilon} unreachable: even sigma={hi} "
                f"spends {spend(hi):.4g} over segments {segs} at delta="
                f"{self.delta}")
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if spend(mid) > target_epsilon:
                lo = mid
            else:
                hi = mid
        self.sigma = hi
        return hi
