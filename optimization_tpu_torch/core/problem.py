"""Problem protocols: a problem is a frozen bundle of pure functions with
the uniform signature ``fn(x, ..., data)``.

Counterpart of ``optimization_tpu/core/problem.py`` (``RiemannianProblem``
only).  Derivatives default to ``torch.func``: the gradient is
``torch.func.grad`` pushed through the manifold's ``egrad_to_rgrad``, and
the Hessian-vector product is ``torch.func.jvp`` of the Riemannian
gradient field followed by tangent projection (exact for Riemannian
submanifolds; cf. the QuadraticModel seam at reference
``TNT.h:209-222``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..manifolds.base import Manifold
from ..manifolds.euclidean import EUCLIDEAN

__all__ = ["RiemannianProblem"]


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

    def hvp(self, x, v, data=None):
        """Riemannian Hessian-vector product Hess f(x)[v] (one-shot)."""
        if self.hess_vec is not None:
            return self.hess_vec(x, v, data)
        _, dv = torch.func.jvp(lambda y: self.rgrad(y, data), (x,), (v,))
        return self.manifold.proj(x, dv)

    def qm(self, x, data=None):
        """Quadratic model at x: (gradient, Hessian-vector closure), built
        once per outer iterate (reference ``QuadraticModel``,
        ``TNT.h:209-222``).  The default closure is a jvp of the gradient
        field followed by projection."""
        if self.quadratic_model is not None:
            return self.quadratic_model(x, data)
        if self.hess_vec is not None:
            return (self.rgrad(x, data),
                    lambda v: self.hess_vec(x, v, data))
        return (self.rgrad(x, data),
                lambda v: self.hvp(x, v, data))

    def apply_precon(self, x, v, data=None):
        if self.precon is None:
            return v
        return self.precon(x, v, data)
