"""The port's DP core against the JAX package: the accountant (pure math,
held to 1e-12 relative), the losses, and ``dp_gradients`` with σ = 0 and
with the JAX noise draw injected."""
import pytest

torch = pytest.importorskip("torch")

import math

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import distill as jdistill, dp as jdp
from repro.core.small_models import linear_apply as jlinear_apply
from repro.engine.accounting import PrivacyLedger as JaxLedger
from repro.kernels.dp_clip import ref as jdp_ref
from repro.models import layers as jlayers
from repro_torch.convert import params_from_jax
from repro_torch.core import distill, dp
from repro_torch.core.small_models import linear_apply
from repro_torch.engine.accounting import PrivacyLedger
from repro_torch.kernels.dp_clip import ref as dp_ref
from repro_torch.models import layers

REL = 1e-12


def _close(a, b):
    if math.isinf(a) or math.isinf(b):
        assert a == b
    else:
        assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("eps,delta,s,T,K", [(15.0, 1e-3, 1.0, 100, 1),
                                              (1.0, 1e-5, 0.5, 40, 3),
                                              (8.0, 1.0 / 96, 0.25, 10, 2)])
def test_noble_sigma(eps, delta, s, T, K):
    _close(dp.noble_sigma(eps, delta, sample_rate=s, rounds=T, local_steps=K),
           jdp.noble_sigma(eps, delta, sample_rate=s, rounds=T, local_steps=K))


def test_rdp_functions():
    for q in (1.0, 0.5, 0.01, 0.0):
        for sigma in (0.7, 2.0, 6.4):
            for alpha in dp.RDP_ORDERS:
                _close(dp.rdp_increment(q, sigma, alpha), jdp.rdp_increment(q, sigma, alpha))
                r = 3 * jdp.rdp_increment(q, sigma, alpha)
                _close(dp.rdp_to_epsilon(r, alpha, 1e-3), jdp.rdp_to_epsilon(r, alpha, 1e-3))
            _close(dp.rdp_epsilon(sigma, q, 50, 1e-4), jdp.rdp_epsilon(sigma, q, 50, 1e-4))
    assert dp.RDP_ORDERS == jdp.RDP_ORDERS


def test_calibrate_sigma():
    for eps, q, steps in ((15.0, 1.0, 100), (2.0, 0.1, 300), (0.5, 0.02, 50)):
        _close(dp.calibrate_sigma(eps, 1e-4, q, steps),
               jdp.calibrate_sigma(eps, 1e-4, q, steps))


def test_privacy_ledger():
    kw = dict(sigma=1.3, delta=1.0 / 96, sample_rate=0.5, local_steps=2)
    mine, ref = PrivacyLedger(**kw), JaxLedger(**kw)
    assert mine.epsilon() == ref.epsilon() == 0.0
    for rounds, q in ((2, 1.0), (3, None), (1, 0.25)):
        mine.advance(rounds, q=q)
        ref.advance(rounds, q=q)
        _close(mine.epsilon(), ref.epsilon())
        assert mine.metrics().keys() == ref.metrics().keys()
        assert mine.rounds_seen == ref.rounds_seen
    _close(mine.calibrate_segments(30.0, [(2, 1.0), (5, None)]),
           ref.calibrate_segments(30.0, [(2, 1.0), (5, None)]))
    _close(mine.calibrate(40.0, 4), ref.calibrate(40.0, 4))
    zero = PrivacyLedger(sigma=0.0, delta=1e-3)
    zero.advance(1)
    assert zero.epsilon() == math.inf
    with pytest.raises(ValueError, match="unreachable"):
        PrivacyLedger(sigma=1.0, delta=1e-3).calibrate(1e-6, 1000)


def test_losses_match_jax():
    """rtol 1e-6: a logsumexp and a softmax over 5 classes in f32."""
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(6, 5)) * 3).astype(np.float32)
    b = (rng.normal(size=(6, 5)) * 3).astype(np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)
    ta, tb, ty = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(y)
    pairs = [
        (layers.softmax_cross_entropy(ta, ty), jlayers.softmax_cross_entropy(a, y)),
        (layers.kl_divergence(ta, tb, 2.0), jlayers.kl_divergence(a, b, 2.0)),
        (distill.proxy_loss(ta, tb, ty, 0.3, 1.5), jdistill.proxy_loss(a, b, y, 0.3, 1.5)),
        (distill.private_loss(ta, tb, ty, 0.7), jdistill.private_loss(a, b, y, 0.7)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_add_flat_noise_matches_jax():
    """Same draw, same f32 scale product: equal to 1 ulp."""
    key = jax.random.PRNGKey(7)
    out = np.random.default_rng(1).normal(size=(33,)).astype(np.float32)
    z = np.array(jax.random.normal(key, (33,), jnp.float32))
    want = jdp_ref.add_flat_noise(jnp.asarray(out), key, 1.7, 0.9, 12.0)
    got = dp_ref.add_flat_noise(torch.from_numpy(out), torch.from_numpy(z), 1.7, 0.9, 12.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7, atol=0)
    assert dp_ref.add_flat_noise(torch.from_numpy(out), None, 0.0, 1.0, 1.0) is not None
    with pytest.raises(ValueError, match="sigma > 0"):
        dp_ref.add_flat_noise(torch.from_numpy(out), None, 1.0, 1.0, 1.0)


def _dp_problem(M=3, B=6, F=11, C=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.normal(size=(M, F, C)) * 0.5).astype(np.float32),
              "b": (rng.normal(size=(M, C)) * 0.1).astype(np.float32)}
    x = (rng.normal(size=(M, B, F)) * rng.uniform(0.05, 3.0, (M, B, 1))).astype(np.float32)
    y = rng.integers(0, C, (M, B)).astype(np.int32)
    tgt = rng.normal(size=(M, B, C)).astype(np.float32)
    return params, {"x": x, "y": y, "tgt": tgt}


def _jax_loss(p, batch):
    return jdistill.proxy_loss(jlinear_apply(p, batch["x"]), batch["tgt"], batch["y"], 0.5)


def _torch_loss(p, batch):
    return distill.proxy_loss(linear_apply(p, batch["x"]), batch["tgt"], batch["y"], 0.5)


@pytest.mark.parametrize("sigma", [0.0, 1.3])
def test_dp_gradients_match_jax(sigma):
    """Per client, the JAX dp_gradients (vmapped over clients, ref backend)
    against the port's stacked call, with the JAX noise draw normal(key_i, (D,))
    injected: rtol 1e-5 / atol 1e-6 (f32 sums over 6 examples and the clip
    norms over 48 parameters, in another order)."""
    params, batch = _dp_problem()
    M = params["w"].shape[0]
    D = params["w"][0].size + params["b"][0].size
    keys = jax.random.split(jax.random.PRNGKey(3), M)
    want = jax.vmap(lambda p, bt, k: jdp.dp_gradients(_jax_loss, p, bt, k, clip=0.8,
                                                      sigma=sigma))(params, batch, keys)
    z = np.stack([np.asarray(jax.random.normal(k, (D,), jnp.float32)) for k in keys])
    got = dp.dp_gradients(_torch_loss, params_from_jax(params),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.from_numpy(z) if sigma else None, clip=0.8, sigma=sigma)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)


def test_dp_gradients_guards():
    params, batch = _dp_problem()
    tp = params_from_jax(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="sigma > 0"):
        dp.dp_gradients(_torch_loss, tp, tb, None, clip=1.0, sigma=1.0)
    for kw in ({"microbatches": 2}, {"per_example_chunk": 3}):
        with pytest.raises(NotImplementedError):
            dp.dp_gradients(_torch_loss, tp, tb, None, clip=1.0, sigma=0.0, **kw)
