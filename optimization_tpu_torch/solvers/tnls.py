"""Truncated-Newton nonlinear least squares (TNLS) over LSQR.

Counterpart of ``optimization_tpu/solvers/tnls.py`` (reference ``TNLS``,
``Riemannian/TNLS.h:265-765``): minimizes L(x) = |F(x)| for a residual map
F from a Riemannian manifold into a Euclidean space, with a trust-region
outer loop whose subproblems  min_h |gradF(x) h + F(x)|^2, |h| <= Delta
are solved by :func:`..linalg.lsqr.lsqr`.  Jacobian and adjoint products
default to ``torch.func`` of the residual map.  The JAX package compiles
the outer loop into one ``lax.while_loop``; here it is an eager Python loop
that reads its status back to the host once per outer iteration (and LSQR
once per inner iteration).

Functional contract (the reference's, as in the JAX package):

- gradient of the loss  gradL = gradF(x)' F(x) / |F(x)|  (``TNLS.h:425,638``);
- inexact-Newton forcing term  eta_k = min(|F|^theta, kappa_fgr) as LSQR's
  btol (``TNLS.h:525``);
- optional *right* preconditioner pair (M, M'): LSQR works in
  preconditioned coordinates and the update is mapped back
  (``TNLS.h:428-456,534-539``);
- gain ratio on *squared* residual norms, the model's from LSQR's ``rsq``
  recurrence  rho = (|F|^2 - |F+|^2) / (|F|^2 - |gradF h + F|^2)
  (``TNLS.h:562-583``);
- ``ROOT`` status when |F(x)| < root_tolerance (``TNLS.h:508-512``);
- a NaN rho (or a non-positive model decrease) rejects and shrinks
  (``TNLS.h:594,644-648``);
- the reference's parameter names and defaults (``TNLS.h:107-169``);
- fixed-length traces, NaN-padded beyond ``num_iterations``.

A fleet (the JAX package's ``jax.vmap(solve)``) is a loop of solves, each
rank of a batch mesh looping over its own instances:
``parallel.sharding.batch_sharded_solve``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.problem import LeastSquaresProblem
from ..core.tree import tree_map, tree_neg, tree_where
from ..core.types import SmoothOptimizerParams, TNLSStatus, trace_fill
from ..linalg.lsqr import lsqr
from .tnt import step_decision

__all__ = ["TNLSParams", "TNLSResult", "solve"]


@dataclasses.dataclass(frozen=True)
class TNLSParams(SmoothOptimizerParams):
    """Mirrors ``TNLSParams`` (reference ``TNLS.h:107-169``)."""

    Delta0: float = 1.0
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    max_LSQR_iterations: int = 1000
    kappa_fgr: float = 0.1
    theta: float = 0.5
    lam: float = 0.0          # Tikhonov regularization for the subproblem
    Atol: float = 1e-6
    Acond_limit: float = 1e8
    root_tolerance: float = 1e-6
    Delta_tolerance: float = 1e-6

    def validate(self) -> None:
        super().validate()
        if self.Delta0 <= 0:
            raise ValueError(
                "Initial trust-region radius must be a positive real value")
        if not (0 < self.eta1 < 1):
            raise ValueError("eta1 must satisfy 0 < eta1 < 1")
        if self.eta1 > self.eta2 or self.eta2 >= 1:
            raise ValueError("eta2 must satisfy eta1 <= eta2 < 1")
        if not (0 < self.alpha1 < 1):
            raise ValueError("alpha1 must satisfy 0 < alpha1 < 1")
        if self.alpha2 <= 1:
            raise ValueError("alpha2 must satisfy alpha2 > 1")
        if not (0 < self.kappa_fgr < 1):
            raise ValueError("kappa_fgr must satisfy 0 < kappa_fgr < 1")
        if self.theta < 0:
            raise ValueError("theta must be a nonnegative real number")
        if self.lam < 0:
            raise ValueError("lambda must be a nonnegative real value")
        if self.root_tolerance < 0:
            raise ValueError("root_tolerance must be a nonnegative real value")
        if self.Delta_tolerance < 0:
            raise ValueError(
                "Delta_tolerance must be a nonnegative real value")


class TNLSResult(NamedTuple):
    x: Any
    f: torch.Tensor                # |F(x)| at the returned iterate
    gradfx_norm: torch.Tensor      # |gradL(x)|
    status: torch.Tensor           # TNLSStatus code
    num_iterations: torch.Tensor
    objective_values: torch.Tensor     # |F| trace
    gradient_norms: torch.Tensor
    trust_region_radius: torch.Tensor
    inner_iterations: torch.Tensor
    update_step_norms: torch.Tensor
    rho: torch.Tensor
    # Wall-clock seconds per recorded iteration: NaN here, as from the JAX
    # package's monolithic solve (filled only by the host driver).
    times: Optional[torch.Tensor] = None
    iterates: Optional[Any] = None


def solve(
    problem: LeastSquaresProblem,
    x0: Any,
    params: TNLSParams = TNLSParams(),
    data: Any = None,
    user_function: Optional[Callable[..., Any]] = None,
    Delta0=None,
) -> TNLSResult:
    """Minimize |F(x)| from ``x0``.

    ``user_function(k, x, Fx, Delta, inner_iters, h, dL, rho, accepted) ->
    bool`` is an optional stopping predicate called once per outer
    iteration before the update is applied (reference ``TNLSUserFunction``,
    ``TNLS.h:95-102,604-613``).  ``Delta0`` optionally overrides
    ``params.Delta0`` (a float or a tensor; the host driver's warm start).
    """
    params.validate()
    M = problem.manifold
    n_trace = params.max_iterations + 1
    n_step = max(params.max_iterations, 1)
    running = TNLSStatus.RUNNING.value

    def residual_norms(x):
        Fx = problem.F(x, data)
        Fx_sq = problem.inner_Y(Fx, Fx, data)
        return Fx, Fx_sq, torch.sqrt(Fx_sq)

    def gradL_norm_at(x, Fx, Fx_norm):
        g = problem.Jt(x, Fx, data)
        denom = torch.where(Fx_norm > 0, Fx_norm, torch.ones_like(Fx_norm))
        g = tree_map(lambda l: l / denom, g)
        return torch.sqrt(M.inner(x, g, g))

    x = x0
    Fx, Fx_sq, Fx_norm = residual_norms(x0)
    dtype, dev = Fx_norm.dtype, Fx_norm.device
    gradL_norm = gradL_norm_at(x0, Fx, Fx_norm)
    sqrt_eps = torch.finfo(dtype).eps ** 0.5

    objective_values = trace_fill(n_trace, dtype, dev)
    gradient_norms = trace_fill(n_trace, dtype, dev)
    trust_region_radius = trace_fill(n_trace, dtype, dev)
    inner_iterations = torch.zeros((n_step,), dtype=torch.int32, device=dev)
    update_step_norms = trace_fill(n_step, dtype, dev)
    rho_trace = trace_fill(n_step, dtype, dev)
    iterates = (tree_map(lambda l: torch.zeros((n_trace,) + tuple(l.shape),
                                               dtype=l.dtype,
                                               device=l.device), x0)
                if params.log_iterates else None)

    Delta = torch.as_tensor(params.Delta0 if Delta0 is None else Delta0,
                            dtype=dtype, device=dev)
    status = torch.tensor(running, dtype=torch.int32, device=dev)

    def record(k):
        objective_values[k] = Fx_norm
        gradient_norms[k] = gradL_norm
        trust_region_radius[k] = Delta
        if iterates is not None:
            tree_map(lambda tr, l: tr.__setitem__(k, l), iterates, x)

    k = 0
    while k < params.max_iterations:
        # the one host read of the outer iteration: status and the
        # convergence test together
        conv_status = torch.where(
            Fx_norm < params.root_tolerance, TNLSStatus.ROOT.value,
            torch.where(gradL_norm < params.gradient_tolerance,
                        TNLSStatus.GRADIENT.value, running)).to(torch.int32)
        st_host, conv_host = torch.stack([status, conv_status]).tolist()
        if st_host != running:
            break
        record(k)
        k += 1
        if conv_host != running:
            status = conv_status
            break

        # ---- do_iter ----
        ridx = k - 1
        # Jacobian pair built once per outer iterate (reference
        # TNLS.h:422); with a right preconditioner (Mp, Mpt) LSQR works in
        # the preconditioned coordinates (reference TNLS.h:428-456)
        J_op, Jt_op = problem.jacobian(x, data)
        if problem.precon is not None:
            Mp, Mpt = problem.precon
            A_op = lambda v, x=x: J_op(Mp(x, v, data))
            At_op = lambda w, x=x: Mpt(x, Jt_op(w), data)
        else:
            A_op, At_op = J_op, Jt_op
        inner_X = lambda u, v, x=x: M.inner(x, u, v)
        inner_Y = lambda u, v: problem.inner_Y(u, v, data)

        # forcing term (reference TNLS.h:525)
        etak = torch.clamp(Fx_norm ** params.theta, max=params.kappa_fgr)

        ls = lsqr(A_op, At_op, tree_neg(Fx), inner_X, inner_Y,
                  max_iterations=params.max_LSQR_iterations,
                  lam=params.lam, btol=etak, Atol=params.Atol,
                  cond_limit=params.Acond_limit, Delta=Delta)
        h, h_M_norm = ls.x, ls.xnorm
        if problem.precon is not None:
            h = Mp(x, h, data)       # back to un-preconditioned coordinates
        h_norm = torch.sqrt(M.inner(x, h, h))

        # trial point and gain ratio on squared residuals (TNLS.h:551-583);
        # |J h + F|^2 from LSQR's rsq recurrence, not a second Jacobian
        # product
        x_prop = M.retract(x, h)
        Fx_prop, Fx_prop_sq, Fn_prop = residual_norms(x_prop)
        dq = Fx_sq - ls.rsq
        dL = Fx_norm - Fn_prop
        df2 = Fx_sq - Fx_prop_sq
        relative_decrease = dL / (sqrt_eps + Fx_norm)
        rho = df2 / dq
        # dq <= 0 is a numerical failure flag treated like a NaN rho
        accepted, very_successful, unsuccessful = step_decision(
            rho, dq, params.eta1, params.eta2)

        if user_function is not None:
            user_stop = torch.as_tensor(user_function(
                ridx, x, Fx, Delta, ls.num_iterations, h, dL, rho, accepted),
                device=dev)
        else:
            user_stop = torch.zeros((), dtype=torch.bool, device=dev)

        apply = accepted & ~user_stop
        x_new = tree_where(apply, x_prop, x)
        Fx_new = tree_where(apply, Fx_prop, Fx)
        Fn_new = torch.where(apply, Fn_prop, Fx_norm)
        Fsq_new = torch.where(apply, Fx_prop_sq, Fx_sq)
        gln_new = torch.where(apply, gradL_norm_at(x_new, Fx_new, Fn_new),
                              gradL_norm)

        new_status = torch.where(
            user_stop, TNLSStatus.USER_FUNCTION.value,
            torch.where(
                apply & (relative_decrease
                         < params.relative_decrease_tolerance),
                TNLSStatus.RELATIVE_DECREASE.value,
                torch.where(apply & (h_norm < params.stepsize_tolerance),
                            TNLSStatus.STEPSIZE.value,
                            running))).to(torch.int32)

        # trust-region radius update (same scheme as TNT; TNLS.h:643-657)
        Delta_new = torch.where(
            very_successful,
            torch.maximum(params.alpha2 * h_M_norm, Delta),
            torch.where(unsuccessful, params.alpha1 * h_M_norm, Delta))
        tr_collapse = unsuccessful & (Delta_new < params.Delta_tolerance)
        is_running = new_status == running
        Delta_new = torch.where(is_running, Delta_new, Delta)
        status = torch.where(is_running & tr_collapse,
                             TNLSStatus.TRUST_REGION.value,
                             new_status).to(torch.int32)

        inner_iterations[ridx] = ls.num_iterations
        update_step_norms[ridx] = h_norm
        rho_trace[ridx] = rho
        x, Fx, Fx_norm, Fx_sq = x_new, Fx_new, Fn_new, Fsq_new
        gradL_norm = gln_new
        Delta = Delta_new.to(dtype)

    status = torch.where(status == running,
                         TNLSStatus.ITERATION_LIMIT.value,
                         status).to(torch.int32)
    record(k)

    return TNLSResult(
        x=x, f=Fx_norm, gradfx_norm=gradL_norm, status=status,
        num_iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        objective_values=objective_values,
        gradient_norms=gradient_norms,
        trust_region_radius=trust_region_radius,
        inner_iterations=inner_iterations,
        update_step_norms=update_step_norms,
        rho=rho_trace,
        times=trace_fill(n_trace, torch.float32, dev),
        iterates=iterates,
    )
