"""Stiefel manifold St(n, p) = { X in R^{n x p} : X^T X = I_p } and SO(d)
(counterpart of ``optimization_tpu/manifolds/stiefel.py``).

Geometry (canonical embedded metric):

- tangent projection:  P_X(V) = V - X sym(X^T V),  sym(A) = (A + A^T)/2
- retraction:          polar retraction R_X(V) = uf(X + V), the orthogonal
  factor of X + V, from a symmetric eigendecomposition of the small p x p
  Gram matrix (one batched ``torch.linalg.eigh``)
- metric: Frobenius inner product.

``SO(d)`` is St(d, d) restricted to determinant +1; the polar retraction
keeps the connected component, so the same ops apply.  A product of N
rotations is a stacked (N, d, d) tensor, every op broadcasting over the
leading axes.

Products run in full f32 at least: nothing here turns TF32 on, and sub-f32
storage (bf16) is promoted to f32 for every product and reduction, the
result cast back to the storage dtype (the bf16-storage / f32-accumulate
tier of ``sphere._acc``).
"""

from __future__ import annotations

import torch

from .base import Manifold

__all__ = ["STIEFEL", "ROTATIONS", "stiefel", "rotations"]


def _sym(a):
    return 0.5 * (a + a.mT)


def _acc(u):
    """Accumulation view: bf16/f16 storage promoted to f32; a no-op for
    f32/f64."""
    return u.to(torch.promote_types(u.dtype, torch.float32))


def _mm(a, b):
    return torch.matmul(_acc(a), _acc(b))


def _proj(x, v):
    xtv = _mm(x.mT, v)
    return (_acc(v) - _mm(x, _sym(xtv))).to(v.dtype)


def _inner(x, u, v):
    return torch.sum(_acc(u) * _acc(v))


def _polar_retract(x, v):
    """Polar retraction R_X(V) = (X+V) ((X+V)'(X+V))^{-1/2}.

    The Gram matrix is computed exactly (not as I + V'V), so the result is
    orthonormal for ANY ambient V: a trust-region step that carries a small
    non-tangent part still lands on the manifold.  bf16 storage: the whole
    computation runs in f32 and only the factor is cast back, so the stored
    iterate is one bf16 rounding from orthonormal.

    A non-finite step gives a non-finite point (NaN), as JAX's eigh does,
    where ``torch.linalg.eigh`` would raise: TNT's gain ratio then rejects
    it and shrinks the radius."""
    y = _acc(x) + _acc(v)
    g = _mm(y.mT, y)
    g = 0.5 * (g + g.mT)
    finite = torch.isfinite(g).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True)
    g = torch.where(finite, g, torch.eye(g.shape[-1], dtype=g.dtype,
                                         device=g.device))
    w, q = torch.linalg.eigh(g)
    w = torch.clamp(w, min=torch.finfo(g.dtype).tiny)
    inv_sqrt = _mm(q * (1.0 / torch.sqrt(w))[..., None, :], q.mT)
    inv_sqrt = torch.where(finite, inv_sqrt, float("nan"))
    return _mm(y, inv_sqrt).to(x.dtype)


def _egrad_to_rgrad(x, g):
    return _proj(x, g)


def _rand_stiefel(generator, *shape, dtype=torch.float32, device=None):
    """Random point via QR of a Gaussian, shape (..., n, p), drawn on the
    generator's device (in f32 for sub-f32 dtypes) and moved to ``device``."""
    work = torch.promote_types(dtype, torch.float32)
    a = torch.randn(shape, generator=generator, dtype=work,
                    device=generator.device)
    q, r = torch.linalg.qr(a)
    # sign fix, so that the factorization (hence the sample) is unique
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    q = q * d[..., None, :]
    return q.to(dtype=dtype,
                device=generator.device if device is None else device)


def _flip_first_column(q, flip):
    """``q`` with column 0 of each (..., d, d) block multiplied by ``flip``
    (shape (...)), out of place."""
    return torch.cat([q[..., :, :1] * flip[..., None, None], q[..., :, 1:]],
                     dim=-1)


STIEFEL = Manifold(
    name="stiefel",
    retract=_polar_retract,
    inner=_inner,
    proj=_proj,
    egrad_to_rgrad=_egrad_to_rgrad,
    rand=_rand_stiefel,
)


def stiefel() -> Manifold:
    return STIEFEL


def _rand_rotation(generator, *shape, dtype=torch.float32, device=None):
    """Random rotation(s) in SO(d); shape (..., d, d)."""
    work = torch.promote_types(dtype, torch.float32)
    q = _rand_stiefel(generator, *shape, dtype=work)
    # flip one column where det = -1 to land in SO(d)
    det = torch.linalg.det(q)
    q = _flip_first_column(q, torch.where(det < 0, -1.0, 1.0).to(work))
    return q.to(dtype=dtype,
                device=generator.device if device is None else device)


ROTATIONS = Manifold(
    name="so",
    retract=_polar_retract,
    inner=_inner,
    proj=_proj,
    egrad_to_rgrad=_egrad_to_rgrad,
    rand=_rand_rotation,
)


def rotations() -> Manifold:
    """SO(d) (or a product of rotations when tensors carry leading axes)."""
    return ROTATIONS
