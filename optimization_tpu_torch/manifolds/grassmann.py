"""Grassmann manifold Gr(n, p): p-dimensional subspaces of R^n
(counterpart of ``optimization_tpu/manifolds/grassmann.py``).

Points are orthonormal bases X in St(n, p), and the geometry is the
quotient of the Stiefel manifold by the right O(p) action: the tangent
(horizontal) space is {V : X'V = 0}, which removes the within-subspace
rotations that stall Stiefel trust-region solves on O(p)-invariant
objectives.

- horizontal projection:  P_X(V) = V - X (X'V)
- retraction: the polar retraction of ``stiefel`` (orthonormal factor of
  X + V), which represents the retracted subspace
- metric: Frobenius inner product on horizontal vectors.
"""

from __future__ import annotations

import torch

from .base import Manifold
from .stiefel import _acc, _mm, _polar_retract, _rand_stiefel

__all__ = ["GRASSMANN", "grassmann"]


def _proj(x, v):
    # bf16 storage: the products accumulate in f32 (stiefel._acc), the
    # result returns in the storage dtype
    return (_acc(v) - _mm(x, _mm(x.mT, v))).to(v.dtype)


def _inner(x, u, v):
    return torch.sum(_acc(u) * _acc(v))


GRASSMANN = Manifold(
    name="grassmann",
    retract=_polar_retract,
    inner=_inner,
    proj=_proj,
    egrad_to_rgrad=_proj,
    rand=_rand_stiefel,
)


def grassmann() -> Manifold:
    return GRASSMANN
