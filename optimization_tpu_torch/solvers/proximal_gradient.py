"""Proximal gradient (ISTA) and accelerated proximal gradient (FISTA).

Counterpart of ``optimization_tpu/solvers/proximal_gradient.py`` (reference
``ProximalGradient``, ``Convex/ProximalGradient.h:149-448``): minimizes
h(x) = f(x) + g(x) with f smooth and g prox-friendly.  The JAX package
compiles the outer loop and the Beck-Teboulle backtracking line search into
nested ``lax.while_loop``s; here both are eager Python loops.  Each outer
iteration reads the host once for the previous iteration's status, and each
backtracking test once; everything else stays on the iterate's device.

Functional contract (the reference's, as in the JAX package):

- FISTA momentum  t+ = (1 + sqrt(1 + 4 t^2)) / 2,
  y = x + ((t - 1)/t+) (x - x_prev)  (``ProximalGradient.h:389-390``);
- O'Donoghue-Candes adaptive restart iff <dx, y - x> > 0
  (``ProximalGradient.h:380-387``);
- composite gradient  G_lam = -(x - y)/lam  and the Goldstein FASTA eq. (42)
  relative criterion with the +1e-6 floor (``ProximalGradient.h:314-329``);
- stepsize lam persists (only shrinks) across iterations;
- identical parameter names/defaults (``ProximalGradient.h:60-101``);
- the backtracking test uses |x - y|^2 (Beck-Teboulle's quadratic model),
  the JAX package's documented deviation from the reference's |x - y|.

Not ported: batching a scenario fleet by ``jax.vmap(solve)``; solve the
instances one by one, or stack them in the problem's own batch dimension.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple, Optional

import torch

from ..core.problem import CompositeProblem
from ..core.tree import (tree_axpy, tree_dot, tree_map, tree_sub, tree_where,
                         tree_zeros_like)
from ..core.types import (OptimizerParams, ProximalGradientStatus,
                          trace_fill)

__all__ = ["ProximalGradientMode", "ProximalGradientParams",
           "ProximalGradientResult", "solve"]


class ProximalGradientMode(enum.Enum):
    SIMPLE = "simple"
    ACCELERATED = "accelerated"


@dataclasses.dataclass(frozen=True)
class ProximalGradientParams(OptimizerParams):
    """Mirrors ``ProximalGradientParams`` (reference ``ProximalGradient.h:60-101``)."""

    mode: ProximalGradientMode = ProximalGradientMode.ACCELERATED
    L: float = 1.0                   # Lipschitz estimate for grad f
    linesearch: bool = True
    beta: float = 0.5                # stepsize shrink factor
    adaptive_restart: bool = True
    max_LS_iterations: int = 100
    composite_gradient_tolerance: float = 1e-3
    relative_composite_gradient_tolerance: float = 1e-3

    def validate(self) -> None:
        super().validate()
        if self.L <= 0:
            raise ValueError("Lipschitz estimate (L) must be a positive real value")
        if not (0 < self.beta < 1):
            raise ValueError("Stepsize shrink factor (beta) must be in (0,1)")


class ProximalGradientResult(NamedTuple):
    x: Any
    f: torch.Tensor                 # composite objective at x
    status: torch.Tensor
    num_iterations: torch.Tensor
    objective_values: torch.Tensor
    composite_gradient_norms: torch.Tensor
    relative_composite_gradient_norms: torch.Tensor
    # Backtracking line-search iterations per outer iteration (zero when
    # ``linesearch=False``): the reference callback's ``linesearch_iters``
    # (``ProximalGradient.h:45-49``); entries [0, num_iterations) valid.
    linesearch_iterations: Optional[torch.Tensor] = None
    # The LAST iteration's composite update step dx = x_k - x_{k-1} (the
    # reference callback's ``dx``); at chunk_iterations=1 the host driver's
    # observer sees it per iteration.
    dx: Optional[Any] = None
    # Wall-clock seconds per recorded iteration; NaN from ``solve``, filled
    # by the host-chunked driver (core/driver.py).
    times: Optional[torch.Tensor] = None
    # (x_prev, y, t_prev, lam): pass back as ``warm_start=`` to resume the
    # momentum sequence exactly (used by the host-chunked driver).
    warm_start: Optional[tuple] = None
    iterates: Optional[Any] = None


def solve(
    problem: CompositeProblem,
    x0: Any,
    params: ProximalGradientParams = ProximalGradientParams(),
    data: Any = None,
    warm_start: Optional[tuple] = None,
    user_function: Optional[Any] = None,
    *,
    iteration_offset: int = 0,
) -> ProximalGradientResult:
    """``warm_start`` is a ``result.warm_start`` tuple from a previous solve:
    resumes the FISTA momentum sequence and stepsize exactly (the seam used by
    the host-chunked driver, core/driver.py).

    ``user_function(k, x, F, G_lambda, linesearch_iters, dx, dF) -> bool`` is
    an optional stopping predicate evaluated once per iteration with the
    arguments of the reference's ``ProximalGradientUserFunction``
    (``ProximalGradient.h:45-49``: iteration, iterate at the start of the
    iteration, its objective value, composite gradient norm, line-search
    iterations, composite update step, objective decrease), but
    *terminating*, like the other solvers' user functions.  A true return
    stops the solve with status USER_FUNCTION before the update is applied.

    ``iteration_offset`` is added to the ``k`` the predicate sees: the host
    driver passes the iterations its earlier chunks completed, so that under
    chunking the predicate sees the global iteration, as the reference's
    callback does (in the JAX package k restarts at 0 in every chunk)."""
    params.validate()
    n_trace = max(params.max_iterations, 1)  # 0-iteration solves must trace
    accelerated = params.mode == ProximalGradientMode.ACCELERATED
    running = ProximalGradientStatus.RUNNING.value

    F0 = torch.as_tensor(problem.value(x0, data))
    dtype, dev = F0.dtype, F0.device
    # Rounding slack of the backtracking test: near convergence
    # F_x - Q(x, y) sinks below the floating-point resolution of the
    # objective (acute in f32); without it the loop chatters to failure.
    eps = torch.finfo(dtype).eps

    objective_values = trace_fill(n_trace, dtype, dev)
    composite_gradient_norms = trace_fill(n_trace, dtype, dev)
    relative_composite_gradient_norms = trace_fill(n_trace, dtype, dev)
    linesearch_iterations = torch.zeros((n_trace,), dtype=torch.int32,
                                        device=dev)
    iterates = (tree_map(lambda l: torch.zeros((n_trace,) + tuple(l.shape),
                                               dtype=l.dtype,
                                               device=l.device), x0)
                if params.log_iterates else None)

    if warm_start is None:
        x_prev, y = x0, x0
        t_prev = torch.ones((), dtype=dtype, device=dev)
        lam = torch.as_tensor(1.0 / params.L, dtype=dtype, device=dev)
    else:
        x_prev, y, t_prev, lam = warm_start
    x = x0
    F_x, F_prev = F0, F0
    dx = tree_zeros_like(x0)
    status = torch.tensor(running, dtype=torch.int32, device=dev)

    def prox_step(y, grad_f_y, lam):
        hat_y = tree_axpy(-lam, grad_f_y, y)
        x = problem.prox(hat_y, lam, data)
        return hat_y, x, torch.as_tensor(problem.value(x, data))

    k = 0
    while k < params.max_iterations:
        # the one host read of the outer iteration: the last one's status
        if k > 0 and int(status) != running:
            break
        grad_f_y = problem.gradient_f(y, data)
        hat_y, x_new, F_new = prox_step(y, grad_f_y, lam)

        ls_iters = 0
        if params.linesearch:
            f_y = torch.as_tensor(problem.value_f(y, data))

            def violated():
                xmy = tree_sub(x_new, y)
                q = (f_y + tree_dot(xmy, grad_f_y)
                     + tree_dot(xmy, xmy) / (2.0 * lam)
                     + torch.as_tensor(problem.value_g(x_new, data)))
                slack = 10.0 * eps * (torch.abs(F_new) + torch.abs(f_y))
                return bool(F_new > q + slack)     # a host read per test

            while ls_iters <= params.max_LS_iterations and violated():
                lam = lam * params.beta
                hat_y, x_new, F_new = prox_step(y, grad_f_y, lam)
                ls_iters += 1
        ls_failed = ls_iters > params.max_LS_iterations

        # --- iteration analysis (reference ProximalGradient.h:304-329) ---
        dx_new = tree_sub(x_new, x_prev)
        x_minus_y = tree_sub(x_new, y)
        G = tree_dot(x_minus_y, x_minus_y)
        composite_gradient_norm = torch.sqrt(G) / lam
        grad_f_x = problem.gradient_f(x_new, data)
        subgrad_g_x = tree_map(lambda hy, xi: (hy - xi) / lam, hat_y, x_new)
        denom = torch.maximum(
            torch.sqrt(tree_dot(grad_f_x, grad_f_x)),
            torch.sqrt(tree_dot(subgrad_g_x, subgrad_g_x))) + 1e-6
        relative_norm = composite_gradient_norm / denom

        # --- record traces (the reference records the *previous*
        # objective, and the iterate at the start of the iteration) ---
        if iterates is not None:
            tree_map(lambda tr, l: tr.__setitem__(k, l), iterates, x_prev)
        objective_values[k] = F_prev
        composite_gradient_norms[k] = composite_gradient_norm
        relative_composite_gradient_norms[k] = relative_norm
        linesearch_iterations[k] = ls_iters

        # Terminating user predicate with the reference callback's state
        # (``ProximalGradient.h:45-49``; see above): iterate/objective at
        # the START of the iteration, this iteration's composite gradient
        # norm, line-search count, update step, and objective decrease.
        if user_function is not None:
            user_stop = torch.as_tensor(user_function(
                iteration_offset + k, x_prev, F_prev, composite_gradient_norm,
                ls_iters, dx_new, F_prev - F_new), device=dev).to(torch.bool)
        else:
            user_stop = torch.zeros((), dtype=torch.bool, device=dev)

        converged = ((composite_gradient_norm
                      < params.composite_gradient_tolerance)
                     | (relative_norm
                        < params.relative_composite_gradient_tolerance))
        if ls_failed:
            step_status = torch.full_like(
                status, ProximalGradientStatus.LINESEARCH.value)
        else:
            step_status = torch.where(
                converged, ProximalGradientStatus.PROX_GRAD_RESIDUAL.value,
                running)
        status = torch.where(
            user_stop, ProximalGradientStatus.USER_FUNCTION.value,
            step_status).to(torch.int32)

        # --- momentum update (reference ProximalGradient.h:376-403) ---
        if accelerated:
            t_eff = t_prev
            if params.adaptive_restart:
                restart = tree_dot(dx_new, tree_sub(y, x_new)) > 0
                t_eff = torch.where(restart, torch.ones_like(t_prev), t_prev)
            t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t_eff * t_eff)) / 2.0
            y_new = tree_axpy((t_eff - 1.0) / t_new, dx_new, x_new)
        else:
            y_new = x_new
            t_new = t_prev

        # On a line-search failure or a user stop the iterate is not
        # advanced (lam and k are)
        if ls_failed:
            keep = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            keep = ~user_stop
        x = tree_where(keep, x_new, x)
        x_prev = tree_where(keep, x_new, x_prev)
        y = tree_where(keep, y_new, y)
        F_x = torch.where(keep, F_new, F_x)
        F_prev = torch.where(keep, F_new, F_prev)
        t_prev = torch.where(keep, t_new, t_prev)
        dx = tree_where(keep, dx_new, dx)
        k += 1

    status = torch.where(status == running,
                         ProximalGradientStatus.ITERATION_LIMIT.value,
                         status).to(torch.int32)

    return ProximalGradientResult(
        x=x, f=F_x, status=status,
        num_iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        objective_values=objective_values,
        composite_gradient_norms=composite_gradient_norms,
        relative_composite_gradient_norms=relative_composite_gradient_norms,
        linesearch_iterations=linesearch_iterations,
        dx=dx,
        times=trace_fill(n_trace, torch.float32, dev),
        warm_start=(x_prev, y, t_prev, lam),
        iterates=iterates,
    )
