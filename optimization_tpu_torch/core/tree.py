"""Pytree vector-space helpers over tensors (``torch.utils._pytree``).

Counterpart of ``optimization_tpu/core/tree.py`` (the ops the ported
solvers use): solvers treat variables and tangents as pytrees of tensors
(a flat tensor, a tuple, a dict, ...) and do their vector algebra through
these helpers.
"""

from __future__ import annotations

import functools
import operator
from typing import Any

import torch
from torch.utils import _pytree as pytree

PyTree = Any


def tree_map(fn, tree: PyTree, *rests: PyTree) -> PyTree:
    """Map ``fn`` over the tensor leaves.  ``None`` is an empty subtree, as
    in JAX (e.g. an unused ``init`` field of a carried NamedTuple)."""
    return pytree.tree_map(
        lambda leaf, *others: None if leaf is None else fn(leaf, *others),
        tree, *rests)


def tree_leaves(tree: PyTree):
    return [leaf for leaf in pytree.tree_leaves(tree) if leaf is not None]


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


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


def tree_where(pred, a: PyTree, b: PyTree) -> PyTree:
    """Leafwise select: pred ? a : b (pred is a scalar boolean tensor)."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)
