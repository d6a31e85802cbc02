"""The ported slice as a whole: ``repro_torch`` P4Trainer.fit against the JAX
package's on the same data, with JAX's own draws replayed, plus the port's
hygiene (no JAX, no silent CPU fallback)."""
import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro import config as jcfg
from repro.core.p4 import P4Trainer as JaxP4Trainer
from repro.core.p4 import group_mean as jax_group_mean
from repro_torch import config as tcfg
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.p4 import P4Trainer, group_mean
from repro_torch.utils.draws import Draws

REPO = Path(__file__).resolve().parents[1]


class JaxReplayDraws(Draws):
    """Hands back the JAX package's draws for P4Trainer.fit(key=PRNGKey(seed)):
    the key chain of ``engine/loop.py`` (phase keys), ``schedule.py`` (batch
    indices), ``core/p4.py`` (per-client, per-step noise keys) and
    ``models/module.py`` (init)."""

    def __init__(self, seed: int):
        self.root = jax.random.PRNGKey(seed)

    def _keys(self, phase):
        key = jax.random.fold_in(self.root, phase)
        return jax.random.split(jax.random.fold_in(key, 0x9e37))

    def _round_key(self, phase, r):
        return jax.random.fold_in(self._keys(phase)[1], r)

    def init_normal(self, which, shape):
        k_private, k_proxy = jax.random.split(self._keys(0)[0])
        k = {"private": k_private, "proxy": k_proxy}[which]
        _, k_w = jax.random.split(k, 2)          # one key per leaf: b, then w
        return torch.from_numpy(np.array(jax.random.normal(k_w, shape, jnp.float32)))

    def batch_indices(self, phase, r, shape, high):
        k = jax.random.fold_in(self._round_key(phase, r), 0)
        return torch.from_numpy(np.array(jax.random.randint(k, shape, 0, high))).long()

    def noise(self, phase, r, step, shape):
        M, D = shape
        keys = jax.random.split(jax.random.fold_in(self._round_key(phase, r), 1), M)
        z = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, step), (D,),
                                                 jnp.float32))(keys)
        return torch.from_numpy(np.array(z))


def _configs(local_steps=2, rounds=6):
    kw_dp = dict(epsilon=15.0, rounds=rounds, sample_rate=0.5, local_steps=local_steps,
                 clip_norm=1.0)
    kw_p4 = dict(group_size=4, sample_peers=5)
    jax_run = jcfg.RunConfig(dp=jcfg.DPConfig(**kw_dp), p4=jcfg.P4Config(**kw_p4),
                             train=jcfg.TrainConfig(learning_rate=0.5, seed=0))
    port_run = tcfg.RunConfig(dp=tcfg.DPConfig(**kw_dp), p4=tcfg.P4Config(**kw_p4),
                              train=tcfg.TrainConfig(learning_rate=0.5, seed=0))
    return jax_run, port_run


def _task(M=8, R=16, n_test=6, F=24, C=5, seed=0):
    """Two latent tasks so grouping has structure to find."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(2, C, F)).astype(np.float32)
    task = np.arange(M) % 2

    def draw(n):
        y = rng.integers(0, C, (M, n))
        x = protos[task[:, None], y] + 0.8 * rng.normal(size=(M, n, F))
        return x.astype(np.float32), y.astype(np.int32)

    return (*draw(R), *draw(n_test))


def test_p4_fit_matches_jax():
    """Same groups, same ε trajectory, parameters and losses within rtol 1e-4 /
    atol 1e-5 (f32 sums taken in another order by XLA and by PyTorch, over 6
    rounds of K = 2 steps), mean accuracy within one test prediction,
    1/(M·n_test)."""
    M, n_test = 8, 6
    trx, try_, tex, tey = _task(M=M, n_test=n_test)
    jax_run, port_run = _configs()
    jt = JaxP4Trainer(feat_dim=trx.shape[-1], num_classes=5, cfg=jax_run)
    jstates, jgroups, jhist = jt.fit(trx, try_, jnp.asarray(tex), jnp.asarray(tey),
                                     rounds=6, eval_every=2, bootstrap_rounds=2)
    pt = P4Trainer(trx.shape[-1], 5, port_run, device="cpu")
    pstates, pgroups, phist = pt.fit(trx, try_, tex, tey, rounds=6, eval_every=2,
                                     bootstrap_rounds=2, draws=JaxReplayDraws(0))

    assert pt.sigma == jt.sigma
    assert pgroups == jgroups
    assert phist.rounds == jhist.rounds == [2, 4, 5]
    np.testing.assert_allclose(phist.metrics["dp_epsilon"], jhist.metrics["dp_epsilon"],
                               rtol=1e-12, atol=0)
    assert phist.metrics["dp_delta"] == jhist.metrics["dp_delta"]
    assert all(b > a for a, b in zip(phist.metrics["dp_epsilon"],
                                     phist.metrics["dp_epsilon"][1:]))
    for k in ("private_loss", "proxy_loss"):
        np.testing.assert_allclose(phist.metrics[k], jhist.metrics[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(phist.accuracy, jhist.accuracy, rtol=0,
                               atol=1.0 / (M * n_test) + 1e-7)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstates))
    for model in ("private", "proxy"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(pstates[model][leaf].numpy(),
                                       want[model][leaf].numpy(), rtol=1e-4, atol=1e-5)


def test_init_matches_jax():
    """Replayed init draws give JAX's initial client state bit for bit: the
    fan_in division is one correctly rounded f32 op in both packages."""
    jax_run, port_run = _configs()
    M, F, C = 4, 24, 5
    jt = JaxP4Trainer(feat_dim=F, num_classes=C, cfg=jax_run)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    init_key, _ = jax.random.split(jax.random.fold_in(key, 0x9e37))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.init_clients(init_key, M)))
    got = P4Trainer(F, C, port_run, device="cpu").init_clients(JaxReplayDraws(0), M)
    for model in ("private", "proxy"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[model][leaf].numpy(),
                                          want[model][leaf].numpy())


def test_group_mean_matches_jax():
    """Segment mean by index_add_ against jax.ops.segment_sum: rtol 1e-6 (one
    f32 sum of at most 4 terms, then one division)."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(7, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(7, 3)).astype(np.float32)}
    ids = np.array([0, 1, 0, 2, 1, 0, 2], np.int32)
    want = jax_group_mean(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids), 3)
    got = group_mean(params_from_jax(tree), torch.as_tensor(ids).long(), 3)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_convert_round_trip():
    tree = {"proxy": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "b": np.ones(3, np.float32)}}
    back = params_to_numpy(params_from_jax(tree))
    np.testing.assert_array_equal(back["proxy"]["w"], tree["proxy"]["w"])
    np.testing.assert_array_equal(back["proxy"]["b"], tree["proxy"]["b"])


# ---------------------------------------------------------------------------
# Hygiene
# ---------------------------------------------------------------------------

def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """Importing every port module leaves jax and repro out of sys.modules."""
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
            for p in sorted((REPO / "src" / "repro_torch").rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax():
    for path in _port_files():
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("from repro.") or s.startswith("import repro.")
                        or s.startswith("from repro import")), (path, line)


def test_trainer_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_run = _configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P4Trainer(8, 3, port_run)


def test_init_linear_fan_in():
    """w = N(0, 1)/√F from the generator, b = 0: the seed fixes the draw, and
    the sample std of 4000 draws is within 10% of 1/√F."""
    from repro_torch.core.small_models import init_linear
    gen = lambda: torch.Generator().manual_seed(5)
    p = init_linear(400, 10, gen())
    assert p["w"].shape == (400, 10) and p["b"].shape == (10,)
    assert not p["b"].any()
    np.testing.assert_array_equal(p["w"].numpy(), init_linear(400, 10, gen())["w"].numpy())
    assert abs(p["w"].std().item() * 20.0 - 1.0) < 0.1
