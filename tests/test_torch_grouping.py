"""Phase-1 grouping in the port against the JAX package: the flat layout the
ℓ1 distances are taken on, the distances, and the groups."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import config as jcfg
from repro.core import grouping as jgrouping
from repro.core.p4 import P4Trainer as JaxP4Trainer
from repro.utils.pytree import tree_flatten_concat, tree_unflatten_concat
from repro_torch import config as tcfg
from repro_torch.convert import params_from_jax
from repro_torch.core import grouping
from repro_torch.core.p4 import P4Trainer
from repro_torch.utils.pytree import flatten_concat, unflatten_concat


def _tree(seed=0, lead=()):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=lead + (5, 3)).astype(np.float32),
            "b": rng.normal(size=lead + (3,)).astype(np.float32),
            "nested": {"z": rng.normal(size=lead + (2,)).astype(np.float32),
                       "a": rng.normal(size=lead + (4, 1)).astype(np.float32)}}


def test_flatten_concat_order_matches_jax():
    """Sorted-key leaf order (b, nested.a, nested.z, w), as tree_leaves."""
    tree = _tree()
    want = np.asarray(tree_flatten_concat(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = flatten_concat(params_from_jax(tree))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[:3].tolist() == tree["b"].tolist()
    back = unflatten_concat(got, params_from_jax(tree))
    jback = tree_unflatten_concat(jnp.asarray(want), tree)
    for k in ("w", "b"):
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
    np.testing.assert_array_equal(back["nested"]["a"].numpy(), tree["nested"]["a"])


def test_flatten_clients_matches_jax():
    stacked = _tree(1, lead=(6,))
    want = np.asarray(jgrouping.flatten_clients(jax.tree_util.tree_map(jnp.asarray, stacked)))
    got = grouping.flatten_clients(params_from_jax(stacked))
    np.testing.assert_array_equal(got.numpy(), want)
    per_client = {k: v[0] for k, v in params_from_jax(stacked).items() if k != "nested"}
    per_client["nested"] = {k: v[0] for k, v in params_from_jax(stacked)["nested"].items()}
    back = unflatten_concat(got, per_client)
    np.testing.assert_array_equal(back["w"].numpy(), stacked["w"])


@pytest.mark.parametrize("M,D", [(5, 17), (12, 300), (33, 1000)])
def test_pairwise_l1_matches_jax(M, D):
    """rtol 1e-5 / atol 1e-4: ℓ1 sums of up to 1000 |a−b| terms (~1100 in
    magnitude) in f32, in another order."""
    w = (np.random.default_rng(M).normal(size=(M, D))).astype(np.float32)
    want = np.asarray(jgrouping.pairwise_l1(jnp.asarray(w)))
    got = grouping.pairwise_l1(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M,size,peers,seed", [(16, 4, 5, 0), (17, 4, 35, 1),
                                               (30, 8, 6, 2), (9, 3, 2, 3)])
def test_greedy_groups_identical(M, size, peers, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(M, 4))
    dist = np.abs(pts[:, None] - pts[None]).sum(-1).astype(np.float32)
    want = jgrouping.greedy_group_formation(dist, size, peers, seed)
    assert grouping.greedy_group_formation(dist, size, peers, seed) == want
    assert grouping.random_groups(M, size, seed) == jgrouping.random_groups(M, size, seed)
    np.testing.assert_array_equal(grouping.group_ids(want, M), jgrouping.group_ids(want, M))


def test_form_groups_matches_jax():
    """The trainer's Phase-1 step on the same stacked proxies gives the same
    groups in both packages (ℓ1 distances on the flat layout, then greedy)."""
    M, F, C = 16, 20, 4
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(4, F, C)).astype(np.float32)
    proxy = {"w": (centers[np.arange(M) % 4] + 0.1 * rng.normal(size=(M, F, C))).astype(np.float32),
             "b": (0.1 * rng.normal(size=(M, C))).astype(np.float32)}
    states = {"private": proxy, "proxy": proxy}
    kw = dict(group_size=4, sample_peers=6)
    jt = JaxP4Trainer(feat_dim=F, num_classes=C,
                      cfg=jcfg.RunConfig(p4=jcfg.P4Config(**kw)))
    pt = P4Trainer(F, C, tcfg.RunConfig(p4=tcfg.P4Config(**kw)), device="cpu")
    want = jt.form_groups(jax.tree_util.tree_map(jnp.asarray, states), seed=2)
    got = pt.form_groups(params_from_jax(states), seed=2)
    assert got == want
    assert sorted(i for g in got for i in g) == list(range(M))
