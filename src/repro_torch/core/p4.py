"""P4 — the paper's algorithm (Phases 1 + 2) on a stack of M clients.

``P4Trainer`` keeps every client's private and proxy linear models as dicts
whose leaves lead with M. A local step runs all clients at once: the clean
private gradient (Eq. 9) by ``torch.func.vmap(grad)`` over clients, and the
DP proxy gradient (Eqs. 8, 10–11) by per-example gradients over clients and
examples, clipped and accumulated by the CUDA dp_clip kernels. Rounds end
with a group mean of the proxies; grouping is the greedy procedure on the
ℓ1 distances of the bootstrap weights (CUDA pairwise-ℓ1 kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.func import grad, vmap

from repro_torch.config import RunConfig
from repro_torch.core import distill, dp as dp_lib
from repro_torch.core.grouping import (flatten_clients, greedy_group_formation,
                                       group_ids, pairwise_l1, random_groups)
from repro_torch.core.small_models import accuracy, linear_apply, linear_from_normal
from repro_torch.engine.accounting import PrivacyLedger
from repro_torch.engine.loop import Engine
from repro_torch.engine.schedule import make_schedule
from repro_torch.engine.strategy import (FederatedData, NoiseFn, Strategy,
                                         register_strategy)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.draws import TorchDraws
from repro_torch.utils.pytree import param_count, tree_map


def group_mean(stacked: Dict, ids: torch.Tensor, num_groups: int) -> Dict:
    """Per-group mean of a stacked (M, ...) dict, broadcast back to (M, ...)."""
    M = ids.shape[0]
    counts = torch.zeros((num_groups,), dtype=torch.float32, device=ids.device)
    counts.index_add_(0, ids, torch.ones((M,), dtype=torch.float32, device=ids.device))

    def f(x):
        sums = torch.zeros((num_groups,) + x.shape[1:], dtype=x.dtype, device=x.device)
        sums.index_add_(0, ids, x)
        mean = sums / counts.reshape((-1,) + (1,) * (x.dim() - 1))
        return mean[ids].to(x.dtype)

    return tree_map(f, stacked)


@dataclass(eq=False)
class P4Trainer:
    feat_dim: int
    num_classes: int
    cfg: RunConfig
    model: str = "linear"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.model != "linear":
            raise NotImplementedError(f"model {self.model!r} is not ported; "
                                      f"only 'linear' is")
        self.device = resolve_device(self.device)
        dpc = self.cfg.dp
        if dpc.noise_multiplier > 0:
            self.sigma = dpc.noise_multiplier
        elif dpc.enabled:
            # δ for Eq. 12 defaults to 1e-3; the ledger's to 1/R (see fit)
            delta = dpc.delta or 1e-3
            self.sigma = dp_lib.noble_sigma(
                dpc.epsilon, delta, sample_rate=dpc.sample_rate,
                rounds=dpc.rounds, local_steps=dpc.local_steps)
        else:
            self.sigma = 0.0

    # ------------------------------------------------------------------
    def init_clients(self, draws, M: int) -> Dict:
        """COMMON initialization across clients (standard FL), so Phase 1's
        ℓ1 metric measures data-driven divergence, not init distance."""
        def bcast(which):
            z = draws.init_normal(which, (self.feat_dim, self.num_classes))
            p = linear_from_normal(z.to(self.device))
            return {k: v.unsqueeze(0).repeat((M,) + (1,) * v.dim())
                    for k, v in p.items()}
        return {"private": bcast("private"), "proxy": bcast("proxy")}

    # ------------------------------------------------------------------
    def _client_step(self, private: Dict, proxy: Dict, x, y,
                     z: Optional[torch.Tensor], lr: float):
        """One local step for all M clients: x (M, B, F), y (M, B), z the
        (M, D) Eq. 11 draw (None when σ = 0)."""
        p4c, dpc = self.cfg.p4, self.cfg.dp
        proxy_logits = linear_apply(proxy, x)

        # private model: clean gradient of Eq. 9
        def private_obj(theta, xc, yc, proxy_lg):
            return distill.private_loss(linear_apply(theta, xc), proxy_lg, yc,
                                        p4c.beta, p4c.distill_temperature)
        g_priv = vmap(grad(private_obj))(private, x, y, proxy_logits)

        # proxy model: DP gradient of Eq. 8; the private logits are a target
        def proxy_obj(w, batch):
            return distill.proxy_loss(linear_apply(w, batch["x"]), batch["tgt"],
                                      batch["y"], p4c.alpha,
                                      p4c.distill_temperature)
        batch = {"x": x, "y": y, "tgt": linear_apply(private, x).detach()}
        if dpc.enabled:
            g_prox = dp_lib.dp_gradients(
                proxy_obj, proxy, batch, z, clip=dpc.clip_norm, sigma=self.sigma,
                microbatches=dpc.microbatches,
                per_example_chunk=dpc.per_example_chunk,
                kernels=self.cfg.kernels)
        else:
            g_prox = vmap(grad(proxy_obj))(proxy, batch)

        new_private = tree_map(lambda p, g: p - lr * g, private, g_priv)
        new_proxy = tree_map(lambda p, g: p - lr * g, proxy, g_prox)
        return new_private, new_proxy

    def _metrics(self, private: Dict, proxy: Dict, x, y) -> Dict[str, torch.Tensor]:
        """Per-client (M,) losses of the round's final models on its batch.
        The JAX package reads these by rerunning a DP step with lr = 0; they
        are computed directly here, which spends one DP step fewer."""
        p4c = self.cfg.p4
        priv_lg, prox_lg = linear_apply(private, x), linear_apply(proxy, x)
        return {
            "private_loss": vmap(lambda a, b, c: distill.private_loss(a, b, c, p4c.beta))(
                priv_lg, prox_lg, y),
            "proxy_loss": vmap(lambda a, b, c: distill.proxy_loss(a, b, c, p4c.alpha))(
                prox_lg, priv_lg, y),
        }

    def local_round(self, states: Dict, xs, ys, noise: NoiseFn):
        """K local steps for all clients. xs: (M, B, F), ys: (M, B)."""
        lr = self.cfg.train.learning_rate
        M = ys.shape[0]
        pr, px = states["private"], states["proxy"]
        noisy = self.cfg.dp.enabled and self.sigma > 0
        for k in range(self.cfg.dp.local_steps):
            z = noise(k, (M, param_count(px) // M)).to(self.device) if noisy else None
            pr, px = self._client_step(pr, px, xs, ys, z, lr)
        return {"private": pr, "proxy": px}, self._metrics(pr, px, xs, ys)

    # ------------------------------------------------------------------
    def form_groups(self, states: Dict, seed: int = 0) -> List[List[int]]:
        """Phase-1 grouping on the proxies' ℓ1 distances."""
        p4c = self.cfg.p4
        M = states["proxy"]["b"].shape[0]
        if p4c.similarity == "random":
            return random_groups(M, p4c.group_size, seed)
        weights = flatten_clients(states["proxy"])
        dist = pairwise_l1(weights, kernels=self.cfg.kernels).cpu().numpy()
        return greedy_group_formation(dist, p4c.group_size, p4c.sample_peers, seed)

    def evaluate(self, states: Dict, xs, ys) -> torch.Tensor:
        """Per-client test accuracy of the PERSONALIZED (private) model."""
        return accuracy(linear_apply(states["private"], xs), ys)

    # ------------------------------------------------------------------
    def fit(self, train_x, train_y, test_x, test_y, *, rounds: Optional[int] = None,
            eval_every: int = 20, batch_size: Optional[int] = None,
            groups: Optional[List[List[int]]] = None, seed: int = 0,
            bootstrap_rounds: int = 4, draws=None):
        """Full P4: a full-batch bootstrap phase (no aggregation, no eval),
        host-side grouping on the DP weights, then the co-training phase.

        Inputs are arrays or tensors; they are moved to the trainer's
        device. ``draws`` is the random source (default: a ``TorchDraws``
        seeded with ``cfg.train.seed``). Bootstrap rounds are accounted at
        q = 1 (full batch, full participation)."""
        dev = self.device
        data = FederatedData(
            torch.as_tensor(train_x, dtype=torch.float32, device=dev),
            torch.as_tensor(train_y, device=dev).long(),
            torch.as_tensor(test_x, dtype=torch.float32, device=dev),
            torch.as_tensor(test_y, device=dev).long())
        rounds = rounds or self.cfg.dp.rounds
        draws = draws if draws is not None else TorchDraws(self.cfg.train.seed, dev)
        M, R = data.train_y.shape
        bs = batch_size or max(8, int(self.cfg.dp.sample_rate * R))
        strategy = P4Strategy(trainer=self)
        nb = max(1, bootstrap_rounds)
        dpc = self.cfg.dp

        schedule = make_schedule(self.cfg.schedule)
        ledger = None
        if dpc.enabled and self.cfg.schedule.accountant == "rdp":
            ledger = PrivacyLedger(sigma=self.sigma, delta=dpc.delta or 1.0 / R,
                                   sample_rate=bs / R,
                                   client_rate=schedule.client_fraction(M),
                                   local_steps=dpc.local_steps)

        # bootstrap local steps on the FULL local dataset (paper §3.3)
        bootstrap = Engine(strategy, eval_every=eval_every)
        states, _ = bootstrap.fit(data, rounds=nb, draws=draws, phase=0,
                                  batch_size=None, evaluate=False)
        if ledger is not None:
            ledger.advance(nb, q=1.0)
        if groups is None:
            groups = self.form_groups(states, seed)
        strategy.set_groups(groups, M)
        engine = Engine(strategy, eval_every=eval_every, schedule=schedule,
                        ledger=ledger)
        states, history = engine.fit(data, rounds=rounds, draws=draws, phase=1,
                                     batch_size=bs, start_round=nb, state=states)
        return states, groups, history


# ---------------------------------------------------------------------------
# Engine strategy: P4's co-training round as init/local_update/aggregate hooks
# ---------------------------------------------------------------------------

@register_strategy("p4")
@dataclass(eq=False)
class P4Strategy(Strategy):
    """P4 as an engine Strategy. Groups are set between the bootstrap and
    co-training phases via ``set_groups``; until then ``aggregate`` is the
    identity."""
    trainer: P4Trainer = None
    groups: Optional[List[List[int]]] = None
    ids: Optional[torch.Tensor] = None
    num_groups: int = 0

    def set_groups(self, groups: List[List[int]], M: int) -> None:
        self.groups = groups
        self.ids = torch.as_tensor(group_ids(groups, M), dtype=torch.long,
                                   device=self.trainer.device)
        self.num_groups = len(groups)

    def init(self, draws, data: FederatedData, batch_size):
        return self.trainer.init_clients(draws, data.num_clients)

    def local_update(self, states, xs, ys, r, noise):
        states, metrics = self.trainer.local_round(states, xs, ys, noise)
        return states, {k: v.mean() for k, v in metrics.items()}

    def aggregate(self, states, r):
        if self.ids is None:          # bootstrap phase: no groups yet
            return states
        return {"private": states["private"],
                "proxy": group_mean(states["proxy"], self.ids, self.num_groups)}

    def evaluate(self, states, test_x, test_y):
        return self.trainer.evaluate(states, test_x, test_y)
