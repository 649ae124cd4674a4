"""Manifold protocol: a frozen bundle of pure geometry functions.

Counterpart of ``optimization_tpu/manifolds/base.py``.  Every manifold
supplies:

- ``retract(x, v) -> x'``      retraction of tangent v at x
- ``inner(x, u, v) -> scalar`` Riemannian metric
- ``proj(x, v) -> v'``         orthogonal projection onto T_x(M)
- ``egrad_to_rgrad(x, g)``     Euclidean -> Riemannian gradient
- ``rand(generator, *dims, dtype=, device=)`` a random point, drawn from
  an explicit ``torch.Generator``
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["Manifold"]


@dataclasses.dataclass(frozen=True, eq=False)
class Manifold:
    name: str
    retract: Callable[[Any, Any], Any]
    inner: Callable[[Any, Any, Any], Any]
    proj: Callable[[Any, Any], Any]
    egrad_to_rgrad: Callable[[Any, Any], Any]
    rand: Callable[..., Any]

    def norm(self, x, v):
        return torch.sqrt(self.inner(x, v, v))
