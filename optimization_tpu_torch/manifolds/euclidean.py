"""Euclidean space R^n as a trivial manifold (counterpart of
``optimization_tpu/manifolds/euclidean.py``): the metric is the standard
inner product, the retraction is addition, projection is the identity.
Variables may be arbitrary pytrees of tensors."""

from __future__ import annotations

import torch

from ..core.tree import tree_add, tree_dot
from .base import Manifold


def _retract(x, v):
    return tree_add(x, v)


def _inner(x, u, v):
    return tree_dot(u, v)


def _proj(x, v):
    return v


def _egrad_to_rgrad(x, g):
    return g


def _rand(generator, *shape, dtype=torch.float32, device=None):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device if device is None else device)


EUCLIDEAN = Manifold(
    name="euclidean",
    retract=_retract,
    inner=_inner,
    proj=_proj,
    egrad_to_rgrad=_egrad_to_rgrad,
    rand=_rand,
)


def euclidean() -> Manifold:
    return EUCLIDEAN
