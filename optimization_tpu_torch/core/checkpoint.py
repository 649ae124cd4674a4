"""Checkpoint / resume of solver state as a ``.npz`` file.

Counterpart of ``optimization_tpu/core/checkpoint.py``: the leaves of a
state tree (tuples, lists, dicts, NamedTuples of tensors, arrays and
numbers) are written as ``leaf_0``, ``leaf_1``, ... and read back
positionally into a template tree of the same structure.  Leaves are
ordered as ``jax.tree_util`` orders them — containers in order, dicts by
sorted key, ``None`` and empty containers holding no leaf — so a file the
JAX package's ``drive_lobpcg(checkpoint_path=...)`` wrote loads into the
port's ``warm_start``, and the other way round.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .tree import tree_flatten

__all__ = ["save_pytree", "load_pytree"]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)      # numpy has no bf16; f32 is exact
        return t.numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Serialize a tree of tensors / arrays / numbers to ``path`` (.npz)."""
    leaves, unflatten = tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    structure = unflatten(["*"] * len(leaves))
    np.savez(path, __treedef__=np.asarray(repr(structure)), **arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Load a tree saved by :func:`save_pytree` (or by the JAX package's).

    ``like`` supplies the structure; stored leaves are matched
    positionally.  Where the template's leaf is a tensor the loaded one is
    a tensor on the template's device and of its dtype; elsewhere it is the
    stored numpy array.
    """
    data = np.load(path, allow_pickle=False)
    leaves, unflatten = tree_flatten(like)
    n = len([k for k in data.files if k.startswith("leaf_")])
    if n != len(leaves):
        raise ValueError(
            f"Checkpoint has {n} leaves but template has {len(leaves)}")
    loaded = []
    for i, tmpl in enumerate(leaves):
        a = data[f"leaf_{i}"]
        if isinstance(tmpl, torch.Tensor):
            a = torch.from_numpy(np.array(a)).to(device=tmpl.device,
                                                 dtype=tmpl.dtype)
        loaded.append(a)
    return unflatten(loaded)
