"""ADMM (alternating direction method of multipliers), optionally
Nesterov-accelerated, for problems of the form

    min  f(x) + g(y)   s.t.   A x + B y = c

Counterpart of ``optimization_tpu/solvers/admm.py`` (reference ``ADMM``,
``Convex/ADMM.h:265-645``).  The user supplies the two augmented-Lagrangian
minimizers ``minLx``/``minLy`` (reference ``ADMM.h:45-53``) plus the linear
operators A, B, A'; the solver owns the outer loop, an eager Python loop
that reads the host once per iteration (the previous iteration's status);
every select of the JAX loop body stays a ``torch.where`` on the device.

Functional contract (the reference's, as in the JAX package):

- dual update  lambda+ = lambda(+hat) + rho (A x + B y - c)  (``ADMM.h:399-402``);
- monotone merit  m_k = sqrt(rho |B dy|^2 + rho |r|^2); accelerated step
  accepted iff m_k < eta m_{k-1}, else restart with alpha = 1, y_hat = y_prev
  (Goldstein et al. Alg. 8; ``ADMM.h:404-451``);
- modified dual residual  s = rho A'(B y - B y_hat|B y_prev)  held over
  restart iterations (``ADMM.h:453-468``);
- combined absolute+relative stopping on primal/dual residuals
  (Boyd Sec. 3.3.1; ``ADMM.h:526-543``);
- He-Yang-Wang residual-balancing rho adaptation inside a window, which in
  accelerated mode forces a restart (``ADMM.h:545-566``);
- identical parameter names/defaults (``ADMM.h:104-183``).

Not ported: the consensus form over a device mesh
(``optimization_tpu.parallel.consensus``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.tree import (local_scalar, tree_axpy, tree_dot, tree_map,
                         tree_sub, tree_where, tree_zeros_like)
from ..core.types import (ADMMIterationType, ADMMStatus, OptimizerParams,
                          trace_fill)

__all__ = ["ADMMMode", "ADMMPenaltyAdaptation", "ADMMParams", "ADMMProblem",
           "ADMMResult", "solve"]


class ADMMMode(enum.Enum):
    SIMPLE = "simple"
    ACCELERATED = "accelerated"


class ADMMPenaltyAdaptation(enum.Enum):
    NONE = "none"
    RESIDUAL_BALANCE = "residual_balance"


@dataclasses.dataclass(frozen=True)
class ADMMParams(OptimizerParams):
    """Mirrors ``ADMMParams`` (reference ``ADMM.h:104-183``).

    One departure from the JAX package: under ``RESIDUAL_BALANCE`` with the
    default ``penalty_adaptation_window`` (2**62, "always") this solver
    adapts rho, as the reference does.  The JAX package compares the window
    with an int32 counter, which never holds for 2**62, so there rho stays
    fixed and the same default parameters give another trajectory.  To
    reproduce a JAX run, give the window explicitly (below 2**31), or
    ``penalty_adaptation_mode=NONE`` for a JAX run made at the default."""

    rho: float = 1.0
    penalty_adaptation_mode: ADMMPenaltyAdaptation = ADMMPenaltyAdaptation.NONE
    penalty_adaptation_period: int = 2
    penalty_adaptation_window: int = 2**62
    residual_balance_mu: float = 10.0
    residual_balance_tau: float = 2.0
    mode: ADMMMode = ADMMMode.SIMPLE
    eta: float = 0.999
    eps_abs_pri: float = 1e-2
    eps_abs_dual: float = 1e-2
    eps_rel: float = 1e-3

    def validate(self) -> None:
        super().validate()
        if self.rho <= 0:
            raise ValueError("Penalty parameter (rho) must be a positive real value")
        if not (0 < self.eta < 1):
            raise ValueError("Acceleration acceptance threshold (eta) must be in (0,1)")
        if self.residual_balance_mu <= 1:
            raise ValueError("residual_balance_mu must be greater than 1")
        if self.residual_balance_tau <= 1:
            raise ValueError("residual_balance_tau must be greater than 1")


@dataclasses.dataclass(frozen=True, eq=False)
class ADMMProblem:
    """The user-supplied seam of the ADMM splitting (reference ``ADMM.h:45-53``).

    - ``minLx(y, lam, rho, data) -> x``: argmin_x L_rho(x, y; lam)
    - ``minLy(x, lam, rho, data) -> y``: argmin_y L_rho(x, y; lam)
    - ``A(x, data)``, ``B(y, data)``, ``At(r, data)``: linear operators.
    """

    minLx: Callable[..., Any]
    minLy: Callable[..., Any]
    A: Callable[..., Any]
    B: Callable[..., Any]
    At: Callable[..., Any]
    inner_x: Optional[Callable[..., Any]] = None
    inner_r: Optional[Callable[..., Any]] = None

    # inner products of sharded (``DTensor``) blocks come back as plain
    # scalars, which every rank holds (``core.tree.local_scalar``)
    def ipx(self, u, v):
        return local_scalar((self.inner_x or tree_dot)(u, v))

    def ipr(self, u, v):
        return local_scalar((self.inner_r or tree_dot)(u, v))


class ADMMResult(NamedTuple):
    x: Any
    y: Any               # y_hat in accelerated mode (reference ADMM.h:592-593)
    lam: Any             # lambda_hat in accelerated mode
    status: torch.Tensor
    num_iterations: torch.Tensor
    primal_residuals: torch.Tensor
    dual_residuals: torch.Tensor
    m_k: torch.Tensor
    penalty_parameters: torch.Tensor
    iteration_types: torch.Tensor  # ADMMIterationType codes
    # The LAST iteration's primal residual VECTOR r = Ax + By - c and
    # (restart-held) dual residual VECTOR s = rho A'(By - By_ref): the
    # reference callback's ``r``/``s`` (``ADMM.h:71-76``); at
    # chunk_iterations=1 the host driver's observer sees them per iteration.
    r: Optional[Any] = None
    s: Optional[Any] = None
    # Wall-clock seconds per recorded iteration; NaN from ``solve``, filled
    # by the host-chunked driver (core/driver.py).
    times: Optional[torch.Tensor] = None
    # Per-iteration x history when ``params.log_iterates`` (reference
    # ``ADMM.h:514-515`` via ``Base/Concepts.h:50-52``); else None.
    iterates: Optional[Any] = None
    # Full internal loop state; pass back as ``warm_start=`` to resume the
    # iteration (including acceleration history) exactly.
    warm_start: Optional[tuple] = None


def solve(
    problem: ADMMProblem,
    c: Any,
    x0: Any,
    y0: Any,
    params: ADMMParams = ADMMParams(),
    data: Any = None,
    warm_start: Optional[tuple] = None,
    user_function: Optional[Callable[..., Any]] = None,
    *,
    iteration_offset: int = 0,
) -> ADMMResult:
    """``warm_start`` is a ``result.warm_start`` tuple from a previous solve:
    resumes the loop state (dual variable, penalty, acceleration history)
    exactly (the seam used by the host-chunked driver, core/driver.py).

    ``user_function(k, x, y, lam, rho, r, s) -> bool`` is an optional
    stopping predicate evaluated once per iteration with the arguments of the
    reference's ``ADMMUserFunction`` (``ADMM.h:71-76``: iteration, the
    iterates/dual/penalty at the END of the iteration, and the primal/dual
    residual VECTORS ``r``/``s``), but *terminating*, like the other
    solvers' user functions.  A true return stops the solve with status
    USER_FUNCTION after the iteration's updates.

    ``iteration_offset`` is the number of iterations that earlier chunks of
    the same run completed (the host driver passes it): it is added to the
    ``k`` the predicate sees and to the ``k`` of the penalty-adaptation
    schedule, so that a chunked run sees the global iteration in both, as
    the reference does, and equals the monolithic run whatever the chunk
    size (in the JAX package both restart at 0 in every chunk)."""
    params.validate()
    accelerated = params.mode == ADMMMode.ACCELERATED
    balance = (params.penalty_adaptation_mode
               == ADMMPenaltyAdaptation.RESIDUAL_BALANCE)
    n_trace = max(params.max_iterations, 1)  # 0-iteration solves must trace
    running = ADMMStatus.RUNNING.value
    RESTART = ADMMIterationType.RESTART.value
    STANDARD = ADMMIterationType.STANDARD.value
    ACCELERATED = ADMMIterationType.ACCELERATED.value

    A = lambda x: problem.A(x, data)
    B = lambda y: problem.B(y, data)
    At = lambda r: problem.At(r, data)

    c_norm = torch.sqrt(problem.ipr(c, c))
    dtype, dev = c_norm.dtype, c_norm.device
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    def itype_of(code):
        return torch.tensor(code, dtype=torch.int32, device=dev)

    # --- initialization (reference ADMM.h:338-360) ---
    if warm_start is None:
        rho = torch.as_tensor(params.rho, dtype=dtype, device=dev)
        By0 = B(y0)
        r0 = tree_sub(tree_axpy(1.0, A(x0), By0), c)
        lam = tree_map(lambda l: rho * l, r0)
        y_prev, By_prev, y_hat, lam_hat, lam_prev = y0, By0, y0, lam, lam
        alpha, m_prev, dual_residual = one, big, big
        iteration_type = itype_of(RESTART if accelerated else STANDARD)
    else:
        lam, rho, carry = warm_start
        y_prev, By_prev, y_hat, lam_hat, lam_prev = (
            carry["y_prev"], carry["By_prev"], carry["y_hat"],
            carry["lam_hat"], carry["lam_prev"])
        alpha, m_prev, dual_residual, iteration_type = (
            carry["alpha"], carry["m_prev"], carry["dual_residual"],
            carry["iteration_type"])

    x, y = x0, y0
    r_vec, s_vec = tree_zeros_like(c), tree_zeros_like(x0)
    status = torch.tensor(running, dtype=torch.int32, device=dev)
    primal_residuals = trace_fill(n_trace, dtype, dev)
    dual_residuals = trace_fill(n_trace, dtype, dev)
    m_trace = trace_fill(n_trace, dtype, dev)
    penalty_parameters = trace_fill(n_trace, dtype, dev)
    iteration_types = torch.zeros((n_trace,), dtype=torch.int32, device=dev)
    iterates = (tree_map(lambda l: torch.zeros((n_trace,) + tuple(l.shape),
                                               dtype=l.dtype,
                                               device=l.device), x0)
                if params.log_iterates else None)

    k = 0
    while k < params.max_iterations:
        # the one host read of the iteration: the last one's status
        if k > 0 and int(status) != running:
            break
        y_in = y_hat if accelerated else y
        lam_in = lam_hat if accelerated else lam

        # --- x / y / lambda updates (reference ADMM.h:378-402) ---
        x = problem.minLx(y_in, lam_in, rho, data)
        y = problem.minLy(x, lam_in, rho, data)
        Ax = A(x)
        By = B(y)
        r = tree_sub(tree_axpy(1.0, Ax, By), c)
        primal = torch.sqrt(problem.ipr(r, r))
        lam = tree_axpy(rho, r, lam_in)

        # --- monotone merit m_k (reference ADMM.h:404-410) ---
        By_ref = B(y_hat) if accelerated else By_prev
        By_diff = tree_sub(By, By_ref)
        m_k = torch.sqrt(rho * problem.ipr(r, r)
                         + rho * problem.ipr(By_diff, By_diff))

        # --- Nesterov acceleration / restart (reference ADMM.h:416-451) ---
        if accelerated:
            accept = m_k < params.eta * m_prev
            alpha_next_acc = (1.0 + torch.sqrt(1.0 + 4.0 * alpha ** 2)) / 2.0
            w = (alpha - 1.0) / alpha_next_acc
            y_hat_acc = tree_axpy(w, tree_sub(y, y_prev), y)
            lam_hat_acc = tree_axpy(w, tree_sub(lam, lam_prev), lam)
            type_acc = torch.where(iteration_type == RESTART, STANDARD,
                                   ACCELERATED)

            alpha_next = torch.where(accept, alpha_next_acc, one)
            y_hat = tree_where(accept, y_hat_acc, y_prev)
            lam_hat = tree_where(accept, lam_hat_acc, lam)
            m_k = torch.where(accept, m_k, m_prev)
            itype = torch.where(accept, type_acc, RESTART).to(torch.int32)
        else:
            alpha_next = alpha
            itype = itype_of(STANDARD)

        # --- dual residual, held over restarts (reference ADMM.h:461-468) ---
        dual_ref = (tree_where(itype == ACCELERATED, B(y_hat), By_prev)
                    if accelerated else By_prev)
        s = tree_map(lambda l: rho * l, At(tree_sub(By, dual_ref)))
        dual_now = torch.sqrt(problem.ipx(s, s))
        is_restart = itype == RESTART
        dual = torch.where(is_restart, dual_residual, dual_now)
        # the dual residual VECTOR, held over restarts exactly like its norm
        # (exposed through the result / user callback, reference ADMM.h:71-76)
        s_held = tree_where(is_restart, s_vec, s)

        # --- record traces (iterate history per reference ADMM.h:514-515) ---
        primal_residuals[k] = primal
        dual_residuals[k] = dual
        m_trace[k] = m_k
        penalty_parameters[k] = rho
        iteration_types[k] = itype
        if iterates is not None:
            tree_map(lambda tr, l: tr.__setitem__(k, l), iterates, x)

        # --- stopping criteria (reference ADMM.h:526-543) ---
        Ax_norm = torch.sqrt(problem.ipr(Ax, Ax))
        By_norm = torch.sqrt(problem.ipr(By, By))
        eps_pri = (params.eps_abs_pri + params.eps_rel
                   * torch.maximum(torch.maximum(Ax_norm, By_norm), c_norm))
        At_lam = At(lam)
        eps_dual = (params.eps_abs_dual
                    + params.eps_rel * torch.sqrt(problem.ipx(At_lam, At_lam)))
        stop = (primal < eps_pri) & (dual < eps_dual)
        status = torch.where(stop, ADMMStatus.RESIDUAL_TOLERANCE.value,
                             running).to(torch.int32)

        # --- penalty adaptation (reference ADMM.h:545-566) ---
        rho_next = rho
        k_global = iteration_offset + k
        if (balance and k_global % params.penalty_adaptation_period == 0
                and k_global < params.penalty_adaptation_window):
            adapt = ~stop
            rho_up = torch.where(primal > params.residual_balance_mu * dual,
                                 rho * params.residual_balance_tau, rho)
            rho_new = torch.where(dual > params.residual_balance_mu * primal,
                                  rho / params.residual_balance_tau, rho_up)
            changed = adapt & (rho_new != rho)
            rho_next = torch.where(adapt, rho_new, rho)
            if accelerated:
                # A rho change invalidates the merit history: force a restart
                alpha_next = torch.where(changed, one, alpha_next)
                y_hat = tree_where(changed, y_prev, y_hat)
                lam_hat = tree_where(changed, lam, lam_hat)
                itype = torch.where(changed, RESTART, itype).to(torch.int32)

        m_next = torch.where(itype == RESTART, big, m_k) if accelerated else m_k

        # Terminating user predicate with the reference callback's
        # end-of-iteration state (``ADMM.h:71-76``; see above): evaluated
        # after the penalty adaptation so ``rho`` is the end-of-iteration
        # value, with the residual VECTORS r / (restart-held) s.
        if user_function is not None:
            user_stop = torch.as_tensor(user_function(
                k_global, x, y, lam, rho_next, r, s_held),
                device=dev).to(torch.bool)
            status = torch.where(user_stop, ADMMStatus.USER_FUNCTION.value,
                                 status).to(torch.int32)

        rho = rho_next
        y_prev, By_prev, lam_prev = y, By, lam
        alpha, m_prev = alpha_next, m_next
        dual_residual, iteration_type = dual, itype
        r_vec, s_vec = r, s_held
        k += 1

    status = torch.where(status == running, ADMMStatus.ITERATION_LIMIT.value,
                         status).to(torch.int32)

    carry_out = dict(
        y_prev=y_prev, By_prev=By_prev, y_hat=y_hat, lam_hat=lam_hat,
        lam_prev=lam_prev, alpha=alpha, m_prev=m_prev,
        dual_residual=dual_residual, iteration_type=iteration_type)
    return ADMMResult(
        x=x,
        y=y_hat if accelerated else y,
        lam=lam_hat if accelerated else lam,
        status=status,
        num_iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        primal_residuals=primal_residuals,
        dual_residuals=dual_residuals,
        m_k=m_trace,
        penalty_parameters=penalty_parameters,
        iteration_types=iteration_types,
        r=r_vec, s=s_vec,
        times=trace_fill(n_trace, torch.float32, dev),
        iterates=iterates,
        warm_start=(lam, rho, carry_out),
    )
