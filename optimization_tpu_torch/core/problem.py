"""Problem protocols: a problem is a frozen bundle of pure functions with
the uniform signature ``fn(x, ..., data)``.

Counterpart of ``optimization_tpu/core/problem.py`` (``RiemannianProblem``,
``LeastSquaresProblem`` and ``CompositeProblem``).  Derivatives default to ``torch.func``: the
gradient is ``torch.func.grad`` pushed through the manifold's
``egrad_to_rgrad``, the Hessian-vector product is ``torch.func.jvp`` of the
Riemannian gradient field followed by tangent projection (exact for
Riemannian submanifolds; cf. the QuadraticModel seam at reference
``TNT.h:209-222``; on a ``DTensor`` iterate two reverse passes instead),
and the Jacobian pair of a residual map is
``torch.func.jvp`` / ``torch.func.vjp`` (reference ``TNLS.h:246-248``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..manifolds.base import Manifold
from ..manifolds.euclidean import EUCLIDEAN
from .tree import tree_dot, tree_leaves, tree_zeros_like

__all__ = ["RiemannianProblem", "LeastSquaresProblem",
           "CompositeProblem"]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(leaf, DTensor) for leaf in tree_leaves(x))


@dataclasses.dataclass(frozen=True, eq=False)
class RiemannianProblem:
    """min_x f(x) over a Riemannian manifold.

    - ``f(x, data) -> scalar``: objective.
    - ``manifold``: geometry bundle (defaults to Euclidean space).
    - ``grad(x, data) -> tangent``: optional Riemannian gradient override.
    - ``hess_vec(x, v, data) -> tangent``: optional Riemannian
      Hessian-vector product override.
    - ``precon(x, v, data) -> tangent``: optional positive-definite
      preconditioner (reference ``TNT.h:234-237``).
    - ``quadratic_model(x, data) -> (grad, hvp_fn)``: optional model
      constructor, called once per outer iterate.

    The flat-engine seams keep the JAX package's signatures:

    - ``flat_qm(x, data[, aux]) -> (A0, U, B[, init])``: the structured
      model Hessian H = A0 + U B U' for ``linalg.flat_cg.stpcg_flat``
      (A0 elementwise, U a tuple of entries, B (k, k)); the optional
      fourth element is a ``FlatCGInit`` dot group.  The metric must be
      the ambient Euclidean dot.
    - ``flat_solve(grad, x, data, aux, Delta, params) -> FlatCGResult``:
      a bring-your-own subproblem engine (the streamed CUDA kernel,
      ``kernels/streamed_cg.py``); takes priority over ``flat_qm``.
    - ``flat_prec(x, data) -> (v -> M^{-1/2} v)``: elementwise
      preconditioner for the flat engine.
    - ``step_eval(x, h, data) -> (x_prop, f_prop, grad_prop,
      gradnorm_prop[, aux])``: fused trial-step evaluator, algebraically
      retract + value + rgrad, valid at h = 0; ``aux`` is carried by TNT
      into ``flat_qm(x, data, aux)`` / ``flat_solve``.
    """

    f: Callable[..., Any]
    manifold: Manifold = EUCLIDEAN
    grad: Optional[Callable[..., Any]] = None
    hess_vec: Optional[Callable[..., Any]] = None
    precon: Optional[Callable[..., Any]] = None
    quadratic_model: Optional[Callable[..., Any]] = None
    flat_qm: Optional[Callable[..., Any]] = None
    flat_solve: Optional[Callable[..., Any]] = None
    flat_prec: Optional[Callable[..., Any]] = None
    step_eval: Optional[Callable[..., Any]] = None

    def value(self, x, data=None):
        return self.f(x, data)

    def rgrad(self, x, data=None):
        if self.grad is not None:
            return self.grad(x, data)
        eg = torch.func.grad(lambda y: self.f(y, data))(x)
        return self.manifold.egrad_to_rgrad(x, eg)

    def _reverse_hvp(self, x, data):
        """``(rgrad(x), v -> Hess f(x)[v])`` by reverse passes only, for
        an iterate sharded as ``DTensor``s (``parallel.sharding``), where
        forward mode has no sharding rules: u -> J' u (J the Jacobian of
        the gradient field) is linear, and its vjp with cotangent v is J v
        (the "transpose" trick).  Both pullbacks are recorded once; each
        product is then one backward pass."""
        g, pullback = torch.func.vjp(lambda y: self.rgrad(y, data), x)
        _, transpose = torch.func.vjp(lambda u: pullback(u)[0],
                                      tree_zeros_like(g))
        return g, lambda v: self.manifold.proj(x, transpose(v)[0])

    def hvp(self, x, v, data=None):
        """Riemannian Hessian-vector product Hess f(x)[v] (one-shot); on
        a ``DTensor`` iterate by two reverse passes (``_reverse_hvp``)."""
        if self.hess_vec is not None:
            return self.hess_vec(x, v, data)
        if _is_dtensor(x):
            return self._reverse_hvp(x, data)[1](v)
        _, dv = torch.func.jvp(lambda y: self.rgrad(y, data), (x,), (v,))
        return self.manifold.proj(x, dv)

    def qm(self, x, data=None):
        """Quadratic model at x: (gradient, Hessian-vector closure), built
        once per outer iterate (reference ``QuadraticModel``,
        ``TNT.h:209-222``).  The default closure is a jvp of the gradient
        field followed by projection (on a ``DTensor`` iterate, the
        reverse-pass product of ``_reverse_hvp``)."""
        if self.quadratic_model is not None:
            return self.quadratic_model(x, data)
        if self.hess_vec is not None:
            return (self.rgrad(x, data),
                    lambda v: self.hess_vec(x, v, data))
        if _is_dtensor(x):
            return self._reverse_hvp(x, data)
        return (self.rgrad(x, data),
                lambda v: self.hvp(x, v, data))

    def apply_precon(self, x, v, data=None):
        if self.precon is None:
            return v
        return self.precon(x, v, data)


@dataclasses.dataclass(frozen=True, eq=False)
class LeastSquaresProblem:
    """min_x |F(x)| with F: M -> R^m (for TNLS, reference
    ``TNLS.h:226-264``).

    - ``residual(x, data) -> y``: the residual map F.
    - ``manifold``: domain geometry.
    - ``jvp(x, v, data)`` / ``vjp(x, w, data)``: optional Jacobian and
      adjoint overrides; default to ``torch.func.jvp`` / ``torch.func.vjp``
      (+ tangent projection).
    - ``inner_y(u, v, data) -> scalar``: inner product on the codomain
      (defaults to the Euclidean pytree dot).
    - ``precon``: optional *right*-preconditioner pair ``(M, Mt)`` with
      ``M(x, v, data)`` and ``Mt(x, v, data)`` (reference ``TNLS.h:60-63``).
    """

    residual: Callable[..., Any]
    manifold: Manifold = EUCLIDEAN
    jvp: Optional[Callable[..., Any]] = None
    vjp: Optional[Callable[..., Any]] = None
    inner_y: Optional[Callable[..., Any]] = None
    precon: Optional[tuple] = None

    def F(self, x, data=None):
        return self.residual(x, data)

    def J(self, x, v, data=None):
        """Jacobian-vector product gradF(x)[v] (one-shot)."""
        if self.jvp is not None:
            return self.jvp(x, v, data)
        _, dv = torch.func.jvp(lambda y: self.residual(y, data), (x,), (v,))
        return dv

    def Jt(self, x, w, data=None):
        """Jacobian-adjoint product gradF(x)^T w, projected into T_x(M)."""
        if self.vjp is not None:
            return self.vjp(x, w, data)
        _, pullback = torch.func.vjp(lambda y: self.residual(y, data), x)
        (g,) = pullback(w)
        return self.manifold.proj(x, g)

    def jacobian(self, x, data=None):
        """(J, J^T) operator pair at x, the reference's JacobianPairFunction
        seam (``TNLS.h:246-248``): built once per outer iterate and shared
        by every inner LSQR iteration, which then pushes only tangents and
        cotangents (``torch.func.linearize`` and ``torch.func.vjp`` hold
        the residual's forward pass)."""
        if self.jvp is not None or self.vjp is not None:
            return (lambda v: self.J(x, v, data),
                    lambda w: self.Jt(x, w, data))
        F_at = lambda y: self.residual(y, data)
        _, lin = torch.func.linearize(F_at, x)
        _, pullback = torch.func.vjp(F_at, x)

        def Jt_op(w):
            (g,) = pullback(w)
            return self.manifold.proj(x, g)

        return lin, Jt_op

    def inner_Y(self, u, v, data=None):
        if self.inner_y is not None:
            return self.inner_y(u, v, data)
        return tree_dot(u, v)


@dataclasses.dataclass(frozen=True, eq=False)
class CompositeProblem:
    """min_x f(x) + g(x), f smooth, g prox-friendly (for proximal gradient,
    reference ``ProximalGradient.h:125-147``).

    - ``f(x, data) -> scalar``; ``grad_f`` optional (defaults to
      ``torch.func.grad``).
    - ``g(x, data) -> scalar``: the nonsmooth term.
    - ``prox_g(x, lam, data) -> x'``: proximal operator of g.
    """

    f: Callable[..., Any]
    g: Callable[..., Any]
    prox_g: Callable[..., Any]
    grad_f: Optional[Callable[..., Any]] = None

    def value_f(self, x, data=None):
        return self.f(x, data)

    def value_g(self, x, data=None):
        return self.g(x, data)

    def value(self, x, data=None):
        return self.f(x, data) + self.g(x, data)

    def gradient_f(self, x, data=None):
        if self.grad_f is not None:
            return self.grad_f(x, data)
        return torch.func.grad(lambda y: self.f(y, data))(x)

    def prox(self, x, lam, data=None):
        return self.prox_g(x, lam, data)
