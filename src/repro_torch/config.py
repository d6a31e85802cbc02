"""Run configuration: copies of the ``repro.config`` dataclasses, holding
only the fields the ported slice reads."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DPConfig:
    """Differential privacy (paper §3.3 Phase 2, Eqs. 10–12)."""
    enabled: bool = True
    epsilon: float = 15.0           # paper's default target budget
    delta: float = 0.0              # 0 => 1e-3 for σ (Eq. 12), 1/R for the ledger
    clip_norm: float = 1.0          # C
    # σ_g: 0 => derive from (ε, δ) via Eq. 12 (Noble et al. with l = M' = 1)
    noise_multiplier: float = 0.0
    sample_rate: float = 1.0        # s — data (batch) subsampling ratio
    local_steps: int = 1            # K — local steps between exchanges
    rounds: int = 100               # T — paper fixes T=100 communication rounds
    microbatches: int = 0           # only 0 (exact per-example) is ported
    per_example_chunk: int = 0      # only 0 (one pass over the batch) is ported


@dataclass(frozen=True)
class P4Config:
    """Phase 1 grouping and Phase 2 co-training knobs."""
    group_size: int = 8             # T in Eq. 5 (paper: 8, CIFAR-100: 4)
    sample_peers: int = 35          # H — peers sampled for similarity (§4.5)
    similarity: str = "l1"          # paper metric (Eq. 3); "random" => ablation
    alpha: float = 0.5              # Eq. 8 proxy   = (1-a) CE + a KL(w ‖ θ)
    beta: float = 0.5               # Eq. 9 private = (1-b) CE + b KL(θ ‖ w)
    distill_temperature: float = 1.0


@dataclass(frozen=True)
class ScheduleConfig:
    """Round schedule + privacy accounting; only ``kind="full"`` is ported."""
    kind: str = "full"
    accountant: str = "rdp"         # rdp | none — (ε, δ) ledger into History


@dataclass(frozen=True)
class KernelConfig:
    """Kernel backend: ``auto`` picks by the tensor's device (hand-written
    CUDA kernel on a CUDA tensor, plain PyTorch on a CPU tensor); ``cuda``
    demands the kernel and raises on a CPU tensor."""
    backend: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4     # plain SGD step of P4Trainer
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    train: TrainConfig = field(default_factory=TrainConfig)
    dp: DPConfig = field(default_factory=DPConfig)
    p4: P4Config = field(default_factory=P4Config)
    kernels: KernelConfig = field(default_factory=KernelConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
