"""Riemannian gradient descent with Armijo backtracking line search.

Counterpart of ``optimization_tpu/solvers/gradient_descent.py`` (reference
``GradientDescent``, ``Riemannian/GradientDescent.h:124-434``).  The JAX
package compiles the outer loop and the line search into nested
``lax.while_loop``s; here both are eager Python loops.  Each outer
iteration reads the host once (the previous step's status together with
the gradient test), and each line-search step once (its Armijo test);
everything else stays on the iterate's device.

Functional contract (the reference's, as in the JAX package):

- Armijo accept rule  f(x) - f(R_x(-t g)) > sigma t |g|^2, with
  t <- beta t starting from t = alpha (``GradientDescent.h:263-286``);
- stopping: |g| < gradient_tolerance, relative decrease, stepsize,
  line-search failure (the iterate is kept), iteration limit, and the
  terminating ``user_function`` (``GradientDescent.h:256-339``);
- fixed-length traces, NaN-padded beyond ``num_iterations``.  A rejected
  step (line-search failure or user stop) writes the padding value into
  ``update_step_norms[num_iterations]``, as the JAX package does: that
  slot lies past the completed iterations the trace reports, so it is
  padding in both packages (``OPTTPU_DEBUG_NANS`` makes it 0.0 in both).

A fleet (the JAX package's ``jax.vmap(solve)``) is a loop of solves, each
rank of a batch mesh looping over its own instances:
``parallel.sharding.batch_sharded_solve`` (the solve is an eager loop with
host reads, which ``torch.vmap`` cannot batch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.debug import pad_value
from ..core.problem import RiemannianProblem
from ..core.tree import tree_map, tree_scale, tree_where
from ..core.types import (GradientDescentStatus, SmoothOptimizerParams,
                          trace_fill)

__all__ = ["GradientDescentParams", "GradientDescentResult", "solve"]


@dataclasses.dataclass(frozen=True)
class GradientDescentParams(SmoothOptimizerParams):
    """Mirrors ``GradientDescentParams`` (reference
    ``GradientDescent.h:44-58``)."""

    alpha: float = 1.0           # initial stepsize
    beta: float = 0.5            # backtracking shrink factor
    sigma: float = 0.5           # Armijo sufficient-decrease fraction
    max_ls_iterations: int = 100

    def validate(self) -> None:
        super().validate()
        if self.alpha <= 0:
            raise ValueError("Initial stepsize (alpha) must be a positive real value")
        if not (0 < self.beta < 1):
            raise ValueError("Stepsize reduction factor (beta) must be in (0,1)")
        if not (0 < self.sigma < 1):
            raise ValueError("Sufficient decrease parameter (sigma) must be in (0,1)")


class GradientDescentResult(NamedTuple):
    x: Any
    f: torch.Tensor
    gradfx_norm: torch.Tensor
    status: torch.Tensor            # GradientDescentStatus code
    num_iterations: torch.Tensor    # completed outer iterations
    # Traces: entries [0, num_iterations] are valid; NaN beyond.
    objective_values: torch.Tensor
    gradient_norms: torch.Tensor
    update_step_norms: torch.Tensor       # per completed iteration
    linesearch_iterations: torch.Tensor   # per completed iteration
    # Wall-clock seconds per recorded iteration: NaN here, as from the JAX
    # package's monolithic solve (filled only by a host driver).
    times: torch.Tensor
    iterates: Optional[Any] = None        # only when params.log_iterates


# Statuses that stop the solve before the step is applied: the iteration
# does not count as completed.
_NOT_COMPLETED = (GradientDescentStatus.USER_FUNCTION.value,
                  GradientDescentStatus.LINE_SEARCH.value)


def solve(
    problem: RiemannianProblem,
    x0: Any,
    params: GradientDescentParams = GradientDescentParams(),
    data: Any = None,
    user_function: Optional[Callable[..., Any]] = None,
) -> GradientDescentResult:
    """Minimize ``problem`` from ``x0``.

    ``user_function(k, t, x, f, grad, h, df) -> bool`` is an optional
    stopping predicate called once per outer iteration with the reference's
    ``GradientDescentUserFunction`` arguments (``GradientDescent.h:22-40``:
    iteration, accepted stepsize, iterate, objective, gradient, update
    step, objective decrease).  As in the JAX package it is terminating: a
    true return stops the solve before the update is applied, with status
    ``USER_FUNCTION``.
    """
    params.validate()
    M = problem.manifold
    n_trace = params.max_iterations + 1
    n_step = max(params.max_iterations, 1)
    running = GradientDescentStatus.RUNNING.value

    x = x0
    f = torch.as_tensor(problem.value(x0, data))
    dtype, dev = f.dtype, f.device
    grad = problem.rgrad(x0, data)
    gradnorm = torch.sqrt(M.inner(x0, grad, grad))
    sqrt_eps = torch.finfo(dtype).eps ** 0.5

    objective_values = trace_fill(n_trace, dtype, dev)
    gradient_norms = trace_fill(n_trace, dtype, dev)
    update_step_norms = trace_fill(n_step, dtype, dev)
    linesearch_iterations = torch.zeros((n_step,), dtype=torch.int32,
                                        device=dev)
    iterates = (tree_map(lambda l: torch.zeros((n_trace,) + tuple(l.shape),
                                               dtype=l.dtype,
                                               device=l.device), x0)
                if params.log_iterates else None)

    def record(k):
        objective_values[k] = f
        gradient_norms[k] = gradnorm
        if iterates is not None:
            tree_map(lambda tr, l: tr.__setitem__(k, l), iterates, x)

    status = torch.tensor(running, dtype=torch.int32, device=dev)
    k = 0
    stepped = False
    while True:
        # the one host read of the outer iteration: the last step's status
        # (which also says whether it completed) and the gradient test
        conv = (gradnorm < params.gradient_tolerance).to(torch.int32)
        st_host, conv_host = torch.stack([status, conv]).tolist()
        if stepped and st_host not in _NOT_COMPLETED:
            k += 1
        if st_host != running or k >= params.max_iterations:
            break
        record(k)
        if conv_host:
            status = torch.tensor(GradientDescentStatus.GRADIENT.value,
                                  dtype=torch.int32, device=dev)
            break

        # Armijo backtracking (reference GradientDescent.h:263-286); one
        # host read per trial step
        t = torch.as_tensor(params.alpha / params.beta, dtype=dtype,
                            device=dev)
        ls_iters, accepted = 0, False
        x_prop, f_prop = x, f
        df = torch.zeros((), dtype=dtype, device=dev)
        while not accepted and ls_iters < params.max_ls_iterations:
            t = t * params.beta
            x_prop = M.retract(x, tree_scale(-t, grad))
            f_prop = torch.as_tensor(problem.value(x_prop, data))
            df = f - f_prop
            ls_iters += 1
            accepted = bool(df > params.sigma * t * gradnorm * gradnorm)

        h_norm = t * gradnorm
        relative_decrease = df / (torch.abs(f) + sqrt_eps)
        if user_function is not None:
            user_stop = torch.as_tensor(user_function(
                k, t, x, f, grad, tree_scale(-t, grad), df), device=dev)
        else:
            user_stop = torch.zeros((), dtype=torch.bool, device=dev)
        # a line-search failure keeps the current iterate and stops
        # (reference GradientDescent.h:294-298); a user stop fires before
        # the update is applied
        apply = torch.tensor(accepted, device=dev) & ~user_stop

        x_new = tree_where(apply, x_prop, x)
        g_new = problem.rgrad(x_new, data)
        gn_new = torch.sqrt(M.inner(x_new, g_new, g_new))
        if accepted:
            step_status = torch.where(
                relative_decrease < params.relative_decrease_tolerance,
                GradientDescentStatus.RELATIVE_DECREASE.value,
                torch.where(h_norm < params.stepsize_tolerance,
                            GradientDescentStatus.STEPSIZE.value, running))
        else:
            step_status = torch.tensor(GradientDescentStatus.LINE_SEARCH.value,
                                       device=dev)
        status = torch.where(user_stop,
                             GradientDescentStatus.USER_FUNCTION.value,
                             step_status).to(torch.int32)

        update_step_norms[k] = torch.where(apply, h_norm, pad_value())
        linesearch_iterations[k] = ls_iters
        x = x_new
        f = torch.where(apply, f_prop, f)
        grad = tree_where(apply, g_new, grad)
        gradnorm = torch.where(apply, gn_new, gradnorm)
        stepped = True

    # the iteration limit is the default status (GradientDescent.h:207)
    status = torch.where(status == running,
                         GradientDescentStatus.ITERATION_LIMIT.value,
                         status).to(torch.int32)
    # final trace entry (reference GradientDescent.h:346-358); the slot may
    # repeat an in-loop record when a top-of-loop criterion fired
    record(k)

    return GradientDescentResult(
        x=x, f=f, gradfx_norm=gradnorm, status=status,
        num_iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        objective_values=objective_values,
        gradient_norms=gradient_norms,
        update_step_norms=update_step_norms,
        linesearch_iterations=linesearch_iterations,
        times=trace_fill(n_trace, torch.float32, dev),
        iterates=iterates,
    )
