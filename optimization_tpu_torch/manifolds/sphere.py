"""Unit sphere S^{n-1} = { x in R^n : |x| = 1 } (counterpart of
``optimization_tpu/manifolds/sphere.py``):

- tangent projection:  P_x(v) = v - <x, v> x
- retraction:          R_x(v) = (x + v) / |x + v|   (metric projection)
- metric:              induced Euclidean inner product

The sphere acts on the trailing axis; leading axes broadcast.
"""

from __future__ import annotations

import torch

from .base import Manifold


def _acc(u):
    """Accumulation view: sub-f32 storage (bf16/f16) is promoted to f32
    for reductions — the bf16-storage / f32-accumulate tier.  A no-op for
    f32/f64 inputs."""
    return u.to(torch.promote_types(u.dtype, torch.float32))


def _proj(x, v):
    s = torch.sum(_acc(x) * _acc(v), dim=-1, keepdim=True)
    return (_acc(v) - s * _acc(x)).to(v.dtype)


def _retract(x, v):
    y = x + v
    nrm = torch.linalg.vector_norm(_acc(y), dim=-1, keepdim=True)
    return (y / nrm).to(y.dtype)


def _inner_scalar(x, u, v):
    return torch.sum(_acc(u) * _acc(v))


def _egrad_to_rgrad(x, g):
    return _proj(x, g)


def _rand(generator, *shape, dtype=torch.float32, device=None):
    x = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device if device is None else device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


SPHERE = Manifold(
    name="sphere",
    retract=_retract,
    inner=_inner_scalar,
    proj=_proj,
    egrad_to_rgrad=_egrad_to_rgrad,
    rand=_rand,
)


def sphere() -> Manifold:
    return SPHERE
