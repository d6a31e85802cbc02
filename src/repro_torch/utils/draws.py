"""The injectable random source: every random number the slice consumes.

The JAX package derives its draws from a threefry key chain, which PyTorch
cannot reproduce. So the port asks a ``Draws`` object for each draw by
where it sits in the run — (phase, round, local step) — and a test can
hand in a source that replays the JAX package's own draws. The default,
:class:`TorchDraws`, serves them from one seeded ``torch.Generator`` on the
run's device, in the order the run asks for them.

The draws:
  * ``init_normal(which, (F, C))`` — standard normal for the ``fan_in``
    init of the private and proxy linear models;
  * ``batch_indices(phase, r, (M, bs), high)`` — per-client minibatch
    indices in [0, high) for round ``r`` (not asked for in full-batch
    rounds);
  * ``noise(phase, r, step, (M, D))`` — the Eq. 11 standard-normal noise of
    local step ``step`` for each client, on the flat parameter layout.
"""
from __future__ import annotations

from typing import Tuple

import torch


class Draws:
    """Interface of a random source (see the module docstring)."""

    def init_normal(self, which: str, shape: Tuple[int, ...]) -> torch.Tensor:
        raise NotImplementedError

    def batch_indices(self, phase: int, r: int, shape: Tuple[int, int],
                      high: int) -> torch.Tensor:
        raise NotImplementedError

    def noise(self, phase: int, r: int, step: int,
              shape: Tuple[int, int]) -> torch.Tensor:
        raise NotImplementedError


class TorchDraws(Draws):
    """Draws from one seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def init_normal(self, which, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def batch_indices(self, phase, r, shape, high):
        return torch.randint(0, int(high), shape, generator=self.generator,
                             device=self.device)

    def noise(self, phase, r, step, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)
