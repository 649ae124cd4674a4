"""Product manifolds M1 x M2 x ... over tuple-structured variables
(counterpart of ``optimization_tpu/manifolds/product.py``): ``x = (x_1,
x_2, ...)`` with one entry per factor, each op zipped over the factors."""

from __future__ import annotations

from typing import Sequence

from .base import Manifold

__all__ = ["product"]


def product(factors: Sequence[Manifold]) -> Manifold:
    """Product of manifolds acting on a tuple-structured variable.

    ``rand(generator, *shapes, **kw)`` takes one shape tuple per factor and
    draws the factors one after another from the one generator."""

    factors = tuple(factors)

    def _retract(x, v):
        return tuple(m.retract(xi, vi) for m, xi, vi in zip(factors, x, v))

    def _inner(x, u, v):
        total = 0.0
        for m, xi, ui, vi in zip(factors, x, u, v):
            total = total + m.inner(xi, ui, vi)
        return total

    def _proj(x, v):
        return tuple(m.proj(xi, vi) for m, xi, vi in zip(factors, x, v))

    def _egrad_to_rgrad(x, g):
        return tuple(m.egrad_to_rgrad(xi, gi)
                     for m, xi, gi in zip(factors, x, g))

    def _rand(generator, *shapes, **kw):
        return tuple(m.rand(generator, *s, **kw)
                     for m, s in zip(factors, shapes))

    return Manifold(
        name="x".join(m.name for m in factors),
        retract=_retract,
        inner=_inner,
        proj=_proj,
        egrad_to_rgrad=_egrad_to_rgrad,
        rand=_rand,
    )
