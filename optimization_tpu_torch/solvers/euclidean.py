"""Euclidean entry points.

Counterpart of ``optimization_tpu/solvers/euclidean.py`` (reference
``EuclideanGradientDescent`` / ``EuclideanTNT``, ``GradientDescent.h:420-433``,
``TNT.h:757-805``): the Euclidean manifold is every problem's default, so
these wrap plain functions into a ``RiemannianProblem`` (or, for
``euclidean_tnls``, a ``LeastSquaresProblem``) and solve.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..core.problem import LeastSquaresProblem, RiemannianProblem
from . import gradient_descent as _gd
from . import tnls as _tnls
from . import tnt as _tnt

__all__ = ["euclidean_gradient_descent", "euclidean_tnt", "euclidean_tnls"]


def euclidean_gradient_descent(
    f: Callable[..., Any],
    x0: Any,
    params: Optional[_gd.GradientDescentParams] = None,
    data: Any = None,
    grad: Optional[Callable[..., Any]] = None,
) -> _gd.GradientDescentResult:
    """Minimize ``f(x, data)`` over R^n by Armijo gradient descent
    (reference ``EuclideanGradientDescent``, ``GradientDescent.h:420-428``).
    ``grad`` defaults to ``torch.func.grad``."""
    problem = RiemannianProblem(f=f, grad=grad)
    return _gd.solve(problem, x0, params or _gd.GradientDescentParams(), data)


def euclidean_tnt(
    f: Callable[..., Any],
    x0: Any,
    params: Optional[_tnt.TNTParams] = None,
    data: Any = None,
    grad: Optional[Callable[..., Any]] = None,
    hess_vec: Optional[Callable[..., Any]] = None,
    precon: Optional[Callable[..., Any]] = None,
    user_function=None,
) -> _tnt.TNTResult:
    """Minimize ``f(x, data)`` over R^n by truncated-Newton trust region
    (reference ``EuclideanTNT``, ``TNT.h:757-805``).  The gradient and
    Hessian-vector product default to ``torch.func``; with
    ``TNTParams(fused_dots=True)`` the CG reductions run in the fused
    kernels (``kernels/fused.py``)."""
    problem = RiemannianProblem(f=f, grad=grad, hess_vec=hess_vec,
                                precon=precon)
    return _tnt.solve(problem, x0, params or _tnt.TNTParams(), data,
                      user_function=user_function)


def euclidean_tnls(
    F: Callable[..., Any],
    x0: Any,
    params: Optional[_tnls.TNLSParams] = None,
    data: Any = None,
    precon: Optional[tuple] = None,
    user_function=None,
) -> _tnls.TNLSResult:
    """Minimize ``|F(x, data)|`` over R^n by truncated-Newton least squares
    (reference ``EuclideanTNLS``, ``TNLS.h:747-757``).  Jacobian/adjoint
    products default to ``torch.func`` of F."""
    problem = LeastSquaresProblem(residual=F, precon=precon)
    return _tnls.solve(problem, x0, params or _tnls.TNLSParams(), data,
                       user_function=user_function)
