#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Setup: print the card's name and power limit, build every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel), turn TF32 off for matmuls and cuDNN.
2. Kernels against their plain PyTorch versions on the card, at ragged small
   shapes in f32 and bf16 and at the main path's shapes; one JSON line per
   kernel with errors, times (kernel, plain version, one PyTorch library
   call) and the least time the card could take (``bound_ms``).
3. The main path on a small input, once on the card and once on the CPU
   with the same draws: groups, ε and parameters must agree.
4. The main path at full width: ``P4Trainer.fit`` on the paper's CIFAR-10
   linear model over the cached ScatterNet feature pool (F = 15,552
   features, C = 10 classes, M = 260 clients), 2 bootstrap rounds then
   co-training to round 6. Kernel launch counters are zeroed just before
   and read just after; every kernel of the path must have run.
5. One more co-training round under ``torch.profiler``: device time by
   kernel and the device's idle share (Chrome trace in ``build/``).

The last two lines are the ``kernels`` JSON object and the result object
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FEATURES = ROOT / "results" / "features_cifar10_60_0_0.9.npz"

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 on CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
RTOL, ATOL_REL = 1e-4, 1e-5    # |got-want| <= ATOL_REL*max|want| + RTOL*|want|

# paper Table 1 / configs/paper_linear.py: CIFAR-10, linear model
M_CLIENTS, R_SAMPLES, CLASSES_PER_CLIENT = 260, 200, 2
BOOTSTRAP_ROUNDS, ROUNDS, EVAL_EVERY = 2, 6, 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(got: torch.Tensor, want: torch.Tensor, atol_rel: float = ATOL_REL):
    """(ok, max_abs_err, max_rel_err) under |got-want| <= atol_rel*max|want|
    + RTOL*|want| elementwise; max_rel_err is max|got-want| / max|want|."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item() if want.numel() else 0.0
    diff = (got - want).abs()
    max_abs = diff.max().item() if diff.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= atol_rel * scale + RTOL * want.abs()).all())
    return ok, max_abs, (max_abs / scale if scale else max_abs)


def bound_ms(bytes_moved: float, ops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(dev, main_M: int, main_B: int, D: int, clip: float):
    from repro_torch.kernels.dp_clip import kernel as dpk, ref as dpr
    from repro_torch.kernels.l1_distance import kernel as l1k, ref as l1r

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rows(n, d, dtype, norms=(0.1, 10.0)):
        """(n, d) normal rows with l2 norms spread log-uniformly over
        ``norms``, so the clip scale is 1 for some rows and < 1 for others."""
        x = torch.randn((n, d), generator=g, device=dev)
        lo, hi = math.log(norms[0]), math.log(norms[1])
        target = torch.exp(lo + (hi - lo) * torch.rand((n, 1), generator=g, device=dev))
        return (x * target / math.sqrt(d)).to(dtype)

    results = {}
    failures = []

    def check(name, shape, dtype, got, want):
        ok, max_abs, max_rel = compare(got, want)
        emit({"check": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
              "ok": ok, "max_abs_err": max_abs, "max_rel_err": max_rel,
              "rtol": RTOL, "atol": f"{ATOL_REL}*max|want|"})
        if not ok:
            failures.append(f"{name} {shape} {dtype}")
        return max_abs, max_rel

    # ragged small shapes, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        for B, d in ((5, 333), (8, 1000), (16, 4096)):
            x = rows(B, d, dtype)
            check("sq_norms", (B, d), dtype, dpk.sq_norms(x), dpr.sq_norms(x))
            x3 = rows(3 * B, d, dtype).reshape(3, B, d)
            sq = dpr.sq_norms(x3)
            check("scale_accumulate", (3, B, d), dtype,
                  dpk.scale_accumulate(x3, sq, clip, float(B)),
                  dpr.clip_scale_accumulate(x3, sq, clip, float(B)))
        for m, d in ((7, 129), (10, 500), (16, 2048), (70, 333)):
            x = rows(m, d, dtype, norms=(1.0, 30.0))
            check("pairwise_l1", (m, d), dtype, l1k.pairwise_l1(x), l1r.pairwise_l1(x))

    # the main path's shapes, f32: the per-example matrix and the weight matrix
    N = main_M * main_B
    x = rows(N, D, torch.float32)
    sq = dpk.sq_norms(x)
    err = check("sq_norms", (N, D), torch.float32, sq, dpr.sq_norms(x))
    b, ops = bound_ms(4.0 * N * D + 4.0 * N, 2.0 * N * D)
    results["sq_norms"] = dict(
        max_abs_err=err[0], max_rel_err=err[1],
        ms=time_ms(lambda: dpk.sq_norms(x), 5),
        plain_ms=time_ms(lambda: dpr.sq_norms(x), 3),
        library_ms=time_ms(lambda: torch.linalg.vecdot(x, x, dim=1), 5),
        bound_ms=b, bound_by=ops)

    x3, sq2 = x.view(main_M, main_B, D), sq.view(main_M, main_B)
    denom = float(main_B)
    err = check("scale_accumulate", (main_M, main_B, D), torch.float32,
                dpk.scale_accumulate(x3, sq2, clip, denom),
                dpr.clip_scale_accumulate(x3, sq2, clip, denom))
    scales = dpr.clip_scales(sq2, clip, denom)
    b, ops = bound_ms(4.0 * N * D + 4.0 * N + 4.0 * main_M * D, 2.0 * N * D)
    results["scale_accumulate"] = dict(
        max_abs_err=err[0], max_rel_err=err[1],
        ms=time_ms(lambda: dpk.scale_accumulate(x3, sq2, clip, denom), 5),
        plain_ms=time_ms(lambda: dpr.clip_scale_accumulate(x3, sq2, clip, denom), 3),
        library_ms=time_ms(lambda: torch.einsum("mbd,mb->md", x3, scales), 5),
        bound_ms=b, bound_by=ops)
    del x, x3, sq, sq2, scales
    torch.cuda.empty_cache()

    w = rows(main_M, D, torch.float32, norms=(1.0, 30.0))
    err = check("pairwise_l1", (main_M, D), torch.float32, l1k.pairwise_l1(w),
                l1r.pairwise_l1(w))
    pairs = main_M * (main_M - 1) / 2
    b, ops = bound_ms(4.0 * main_M * D + 4.0 * main_M * main_M, 3.0 * pairs * D)
    results["pairwise_l1"] = dict(
        max_abs_err=err[0], max_rel_err=err[1],
        ms=time_ms(lambda: l1k.pairwise_l1(w), 10),
        plain_ms=time_ms(lambda: l1r.pairwise_l1(w), 2),
        library_ms=time_ms(lambda: torch.cdist(w, w, p=1), 3),
        bound_ms=b, bound_by=ops)
    del w
    torch.cuda.empty_cache()

    for name, r in results.items():
        emit({"kernel": name, "shape": "main path", "dtype": "float32",
              "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
              "rtol": RTOL, "atol": f"{ATOL_REL}*max|want|",
              "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
              "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
              "bound_by": r["bound_by"]})
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    return results


# ---------------------------------------------------------------------------
# Phases 3-4: the main path
# ---------------------------------------------------------------------------

class NumpyDraws:
    """A random source (``repro_torch.utils.draws.Draws``) from a seeded numpy
    generator, so that a CPU run and a GPU run consume identical draws."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def init_normal(self, which, shape):
        return torch.from_numpy(self.rng.standard_normal(shape, dtype=np.float32))

    def batch_indices(self, phase, r, shape, high):
        return torch.from_numpy(self.rng.integers(0, high, shape))

    def noise(self, phase, r, step, shape):
        return torch.from_numpy(self.rng.standard_normal(shape, dtype=np.float32))


def client_split(feats, labels, M, R, N, seed=0):
    """``benchmarks/common.py::client_split`` (mode 'shard') with the port's
    copies of the partitioners."""
    from repro_torch.data.partition import shard_partition
    from repro_torch.data.pipeline import stack_client_data, train_test_split
    idxs = shard_partition(labels, M, N, R, seed)
    tr, te = zip(*[train_test_split(idx, 0.2, seed) for idx in idxs])
    n_tr, n_te = min(len(t) for t in tr), min(len(t) for t in te)
    return (*stack_client_data(feats, labels, list(tr), n_tr),
            *stack_client_data(feats, labels, list(te), n_te))


def paper_linear_config():
    """``configs/paper_linear.py:config("cifar10")``: ε = 15, T = 100,
    C = 1.0, |g| = 8, H = 35, SGD at lr 0.5."""
    from repro_torch.config import DPConfig, P4Config, RunConfig, TrainConfig
    return RunConfig(dp=DPConfig(epsilon=15.0, rounds=100, clip_norm=1.0),
                     p4=P4Config(group_size=8, sample_peers=35),
                     train=TrainConfig(learning_rate=0.5))


def cross_check(data, F, C):
    """The main path on the first 8 clients, on the card and on the CPU with
    the same draws: same groups and ε, accuracy within one prediction, and
    parameters within |gpu − cpu| ≤ 1e-4·max|cpu| + 1e-4·|cpu| elementwise.

    Why 1e-4 and not the kernels' 1e-5: on the unnormalised ScatterNet
    features the logits grow to the hundreds or thousands within a few steps
    (printed as ``max_abs_logit``), where one f32 ulp of a logit is 1e-5 to
    1e-4. So every softmax, and every gradient after it, carries that
    relative rounding, whatever the order of the sums; two correct f32
    implementations (cuBLAS and the CUDA kernels, against the CPU) drift
    apart by about that much per local step, and the private model takes 4."""
    from repro_torch.core.p4 import P4Trainer
    trx, try_, tex, tey = (a[:8] for a in data)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        trainer = P4Trainer(F, C, paper_linear_config(), device=dev)
        runs[dev] = trainer.fit(trx, try_, tex, tey, rounds=4, eval_every=2,
                                bootstrap_rounds=2, draws=NumpyDraws(1))
        emit({"cross_check": dev, "seconds": time.perf_counter() - t0,
              "accuracy": runs[dev][2].accuracy,
              "dp_epsilon": runs[dev][2].metrics["dp_epsilon"]})
    (gs, ggroups, ghist), (cs, cgroups, chist) = runs["cuda"], runs["cpu"]
    if ggroups != cgroups:
        fail(f"cross-check groups differ: {ggroups} vs {cgroups}")
    if ghist.metrics["dp_epsilon"] != chist.metrics["dp_epsilon"]:
        fail("cross-check epsilon trajectories differ")
    n_test = tex.shape[1]
    if max(abs(a - b) for a, b in zip(ghist.accuracy, chist.accuracy)) > 1.0 / (8 * n_test) + 1e-7:
        fail(f"cross-check accuracy differs: {ghist.accuracy} vs {chist.accuracy}")
    from repro_torch.core.small_models import linear_apply
    emit({"cross_check": "conditioning", "max_abs_logit":
          linear_apply(cs["private"], torch.as_tensor(trx)).abs().max().item()})
    for model in ("private", "proxy"):
        for leaf in ("w", "b"):
            ok, max_abs, max_rel = compare(gs[model][leaf].cpu(), cs[model][leaf],
                                           atol_rel=1e-4)
            emit({"cross_check_param": f"{model}.{leaf}", "ok": ok,
                  "max_abs_err": max_abs, "max_rel_err": max_rel,
                  "max_abs_value": cs[model][leaf].abs().max().item()})
            if not ok:
                fail(f"cross-check {model}.{leaf} differs beyond tolerance")


def main_path(data, F, C, dispatch):
    from repro_torch.core.p4 import P4Trainer
    from repro_torch.engine.schedule import FullParticipation

    per_round = []
    run_round = FullParticipation.run_round

    def timed_round(self, strategy, state, data_, r, draws, phase, batch_size):
        before = dispatch.launch_counts()
        t0 = time.perf_counter()
        out = run_round(self, strategy, state, data_, r, draws, phase, batch_size)
        torch.cuda.synchronize()
        after = dispatch.launch_counts()
        per_round.append({"round": r, "seconds": time.perf_counter() - t0,
                          "launches": {k: after[k] - before[k] for k in after}})
        return out

    FullParticipation.run_round = timed_round
    try:
        trainer = P4Trainer(F, C, paper_linear_config(), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        states, groups, hist = trainer.fit(*data, rounds=ROUNDS, eval_every=EVAL_EVERY,
                                           bootstrap_rounds=BOOTSTRAP_ROUNDS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dispatch.launch_counts()
    finally:
        FullParticipation.run_round = run_round
    return trainer, states, groups, hist, seconds, launches, per_round


def profile_round(trainer, states, groups, data):
    """One more co-training round under ``torch.profiler``: device time by
    kernel name and the device's busy share of the round's wall time. The
    Chrome trace goes to ``build/round_trace.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.p4 import P4Strategy
    from repro_torch.engine.schedule import FullParticipation
    from repro_torch.engine.strategy import FederatedData
    from repro_torch.utils.draws import TorchDraws

    strategy = P4Strategy(trainer=trainer)
    strategy.set_groups(groups, len(data[1]))
    fed = FederatedData(*(torch.as_tensor(a, device="cuda") for a in data))
    draws = TorchDraws(2, "cuda")
    schedule = FullParticipation()
    bs = fed.train_y.shape[1]
    schedule.run_round(strategy, states, fed, ROUNDS, draws, 1, bs)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        schedule.run_round(strategy, states, fed, ROUNDS + 1, draws, 1, bs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = []   # device kernels only: CPU-side ops also carry their kernels' time
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            events.append((dev_us, e.key, e.count))
    events.sort(reverse=True)
    busy_ms = sum(e[0] for e in events) / 1e3
    for dev_us, key, count in events[:12]:
        emit({"profile_kernel": key[:90], "device_ms": dev_us / 1e3, "count": count})
    emit({"profile_round_wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
          "device_idle_share": (1.0 - busy_ms / (1e3 * wall)) if wall else None})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "round_trace.json"))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir() or not FEATURES.exists():
        fail(f"run from a checkout of the repository: {ROOT / 'src' / 'repro_torch'} "
             f"or {FEATURES} is missing")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, dispatch

    # -- phase 1: setup ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = _build.build_all()
    emit({"build_seconds": build_s, "sources": _build.sources()})
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # the data fixes the main path's shapes, so it is loaded first
    with np.load(FEATURES) as z:
        feats, labels = z["feats"].astype(np.float32), z["labels"].astype(np.int64)
    data = client_split(feats, labels, M_CLIENTS, R_SAMPLES, CLASSES_PER_CLIENT)
    M, B, F = data[0].shape
    C = int(labels.max()) + 1
    D = C + F * C
    emit({"data": str(FEATURES.relative_to(ROOT)), "M": M, "train_per_client": B,
          "test_per_client": data[2].shape[1], "F": F, "C": C, "D": D,
          "per_example_gb": 4.0 * M * B * D / 1e9})
    if (F, C) != (15552, 10):
        fail(f"expected the CIFAR-10 ScatterNet width F=15552, C=10, got {F}, {C}")
    clip = paper_linear_config().dp.clip_norm

    # -- phase 2: kernels against their plain versions -----------------------
    results = kernel_checks(dev, M, B, D, clip)

    # -- phase 3: the main path on a small input, card against CPU -----------
    cross_check(data, F, C)

    # -- phase 4: the main path at full width --------------------------------
    print(f"main path: M = {M} clients (not cut), F = {F}, C = {C}, D = {D}", flush=True)
    trainer, states, groups, hist, seconds, launches, per_round = main_path(
        data, F, C, dispatch)
    emit({"groups": groups})
    for i, r in enumerate(hist.rounds):
        emit({"eval_round": r, "mean_accuracy": hist.accuracy[i],
              **{k: v[i] for k, v in hist.metrics.items()}})
    for entry in per_round:
        emit(entry)
    emit({"fit_seconds": seconds, "rounds": ROUNDS,
          "seconds_per_round": [e["seconds"] for e in per_round],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sigma": trainer.sigma, "launches": launches})

    values = [*hist.accuracy, *(v for vs in hist.metrics.values() for v in vs)]
    if not all(math.isfinite(v) for v in values):
        fail(f"non-finite history values: {hist.accuracy} {hist.metrics}")
    for model in ("private", "proxy"):
        for leaf, t in states[model].items():
            if t.shape != ((M, F, C) if leaf == "w" else (M, C)) or not torch.isfinite(t).all():
                fail(f"{model}.{leaf}: shape {tuple(t.shape)} or non-finite values")
    eps = hist.metrics["dp_epsilon"]
    if not all(b > a for a, b in zip(eps, eps[1:])):
        fail(f"epsilon does not grow from one eval round to the next: {eps}")
    if sorted(i for g in groups for i in g) != list(range(M)):
        fail("groups do not partition the clients")
    K = trainer.cfg.dp.local_steps
    if len(per_round) != ROUNDS or any(
            e["launches"]["sq_norms"] != K or e["launches"]["scale_accumulate"] != K
            for e in per_round):
        fail(f"dp_clip kernels did not run once per local step in every round: {per_round}")
    if launches["pairwise_l1"] != 1 or any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was not launched as expected: {launches}")

    sources = {"sq_norms": ("src/repro_torch/kernels/csrc/dp_clip.cu",
                            "src/repro/kernels/dp_clip/kernel.py:38"),
               "scale_accumulate": ("src/repro_torch/kernels/csrc/dp_clip.cu",
                                    "src/repro/kernels/dp_clip/kernel.py:67"),
               "pairwise_l1": ("src/repro_torch/kernels/csrc/l1_distance.cu",
                               "src/repro/kernels/l1_distance/kernel.py:54")}
    # -- phase 5: where one co-training round's device time goes -----------
    profile_round(trainer, states, groups, data)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in results.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
