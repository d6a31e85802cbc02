"""Flat-vector views of parameter dicts.

Leaves are visited in sorted-key order (``"b"`` before ``"w"``), which is the
order ``jax.tree_util.tree_leaves`` gives the JAX package's dicts: the Eq. 11
noise vector and the Eq. 3 ℓ1 distances are defined on this layout."""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a (nested) dict of tensors in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over dicts of identical structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def flatten_concat(tree, batch_dims: int = 0, dtype=torch.float32) -> torch.Tensor:
    """(*lead, D) vector of every leaf, where ``lead`` is the first
    ``batch_dims`` axes shared by all leaves (e.g. clients, examples)."""
    leaves = tree_leaves(tree)
    lead = leaves[0].shape[:batch_dims]
    return torch.cat([l.reshape(lead + (-1,)).to(dtype) for l in leaves], dim=-1)


def unflatten_concat(flat: torch.Tensor, template) -> Dict:
    """Inverse of :func:`flatten_concat`: ``template`` gives each leaf's
    shape without the leading axes, which are taken from ``flat[..., :]``."""
    lead = flat.shape[:-1]
    off = 0

    def take(t):
        nonlocal off
        n = math.prod(t.shape)
        out = flat[..., off:off + n].reshape(lead + tuple(t.shape)).to(t.dtype)
        off += n
        return out

    return _rebuild(template, take)


def _rebuild(template, take):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], take) for k in sorted(template)}
    return take(template)


def param_count(tree) -> int:
    return int(sum(l.numel() for l in tree_leaves(tree)))
