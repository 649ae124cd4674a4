"""Pytree vector-space helpers over tensors (``torch.utils._pytree``).

Counterpart of ``optimization_tpu/core/tree.py`` (the ops the ported
solvers use): solvers treat variables and tangents as pytrees of tensors
(a flat tensor, a tuple, a dict, ...) and do their vector algebra through
these helpers.  :func:`tree_flatten` orders leaves as ``jax.tree_util``
does, for state shared with the JAX package (``core/checkpoint.py``).
"""

from __future__ import annotations

import functools
import operator
from typing import Any, Callable, List, Tuple

import torch
from torch.utils import _pytree as pytree

PyTree = Any


def tree_map(fn, tree: PyTree, *rests: PyTree) -> PyTree:
    """Map ``fn`` over the tensor leaves.  ``None`` is an empty subtree, as
    in JAX (e.g. an unused ``init`` field of a carried NamedTuple)."""
    return pytree.tree_map(
        lambda leaf, *others: None if leaf is None else fn(leaf, *others),
        tree, *rests)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: PyTree
                 ) -> Tuple[List[Any], Callable[[List[Any]], PyTree]]:
    """``(leaves, unflatten)`` in ``jax.tree_util``'s order: tuples, lists
    and NamedTuples in order, dicts by sorted key, ``None`` and empty
    containers without leaves; ``unflatten(new_leaves)`` rebuilds the tree
    with the leaves replaced in that order.  (``torch.utils._pytree`` keeps
    a dict's insertion order; checkpoints shared with the JAX package need
    the sorted one.)"""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        counts = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, pos = {}, 0
            for k, (_, fn), c in zip(keys, parts, counts):
                out[k] = fn(leaves[pos:pos + c])
                pos += c
            return out
        return [leaf for p in parts for leaf in p[0]], rebuild
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(x) for x in tree]
        counts = [len(p[0]) for p in parts]

        def rebuild(leaves):
            items, pos = [], 0
            for (_, fn), c in zip(parts, counts):
                items.append(fn(leaves[pos:pos + c]))
                pos += c
            if _is_namedtuple(tree):
                return type(tree)(*items)
            return type(tree)(items)
        return [leaf for p in parts for leaf in p[0]], rebuild
    return [tree], lambda leaves: leaves[0]


def tree_leaves(tree: PyTree):
    return [leaf for leaf in pytree.tree_leaves(tree) if leaf is not None]


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(alpha, a: PyTree) -> PyTree:
    return tree_map(lambda x: alpha * x, a)


def tree_axpy(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_axpy_like(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha * x + y, cast back to each y-leaf's dtype (the storage-dtype
    preserving axpy of the bf16-storage / f32-scalar tier)."""
    return tree_map(lambda xi, yi: (alpha * xi + yi).to(yi.dtype), x, y)


def tree_neg(a: PyTree) -> PyTree:
    return tree_map(torch.neg, a)


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Euclidean inner product <a, b> over all leaves (scalar)."""
    terms = tree_leaves(tree_map(lambda x, y: torch.sum(x * y), a, b))
    return functools.reduce(operator.add, terms)


def tree_norm(a: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_where(pred, a: PyTree, b: PyTree) -> PyTree:
    """Leafwise select: pred ? a : b (pred is a scalar boolean tensor)."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_select(pred, a: PyTree, b: PyTree) -> PyTree:
    """Alias of tree_where (kept for readability at call sites)."""
    return tree_where(pred, a, b)
