"""Riemannian truncated-Newton trust-region (TNT) method.

Counterpart of ``optimization_tpu/solvers/tnt.py`` (reference ``TNT``,
``Riemannian/TNT.h:242-689``, Algorithm 6.1.1 of Conn-Gould-Toint).  The
JAX package compiles the whole solve into one ``lax.while_loop``; here the
outer loop is an eager Python loop that reads its status back to the host
once per outer iteration.  Everything else stays on the iterate's device.
The trust-region subproblem runs in one of three engines, as in the JAX
package: a problem-supplied ``flat_solve`` (the streamed CUDA kernel), the
flat pair engine (``flat_qm``), or generic STPCG.

Functional contract (the reference's, as in the JAX package):

- model decrease dm from the engine's scalar recurrence, gain ratio
  rho = df/dm, accept iff !isnan(rho) && rho > eta1 && dm > 0
  (:func:`step_decision`, ``TNT.h:511-532``);
- radius update: very successful -> Delta = max(alpha2 |h|_M, Delta);
  unsuccessful -> Delta = alpha1 |h|_M, TrustRegion stop when
  Delta < Delta_tolerance (``TNT.h:590-603``);
- stopping: gradient, preconditioned gradient, relative decrease,
  stepsize, trust region, iteration limit, user function;
- fixed-length traces, NaN-padded beyond ``num_iterations``.

``solve_escalated`` (bf16 -> f32 dtype escalation) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.problem import RiemannianProblem
from ..core.tree import tree_map, tree_where, tree_zeros_like
from ..core.types import SmoothOptimizerParams, TNTStatus, trace_fill
from ..linalg.stpcg import stpcg

__all__ = ["TNTParams", "TNTResult", "solve", "step_decision"]


@dataclasses.dataclass(frozen=True)
class TNTParams(SmoothOptimizerParams):
    """Mirrors ``TNTParams`` (reference ``TNT.h:76-130``), with the JAX
    package's extensions (same names, defaults and meanings):
    ``fused_dots`` (generic STPCG on fused reduction kernels — not ported
    yet, ``True`` raises), ``flat_s_steps`` (s-step flat engine — values
    above 1 raise, not ported yet), ``flat_kernel_check`` and
    ``floor_acceptance`` (accept a step whose predicted decrease is below
    the objective's resolution when the objective did not measurably
    increase; the radius is then held)."""

    Delta0: float = 1.0
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    max_TPCG_iterations: int = 1000
    kappa_fgr: float = 0.1
    theta: float = 0.5
    preconditioned_gradient_tolerance: float = 1e-6
    Delta_tolerance: float = 1e-6
    fused_dots: bool = False
    flat_s_steps: int = 1
    flat_kernel_check: bool = True
    floor_acceptance: bool = False

    def validate(self) -> None:
        super().validate()
        if self.preconditioned_gradient_tolerance < 0:
            raise ValueError(
                "Preconditioned gradient tolerance must be a nonnegative real value")
        if self.Delta_tolerance < 0:
            raise ValueError(
                "Trust-region radius tolerance must be a nonnegative real value")
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
        if not (1 <= self.flat_s_steps <= 3):
            raise ValueError("flat_s_steps must be 1, 2, or 3")
        if not self.flat_kernel_check and self.flat_s_steps > 1:
            raise ValueError("flat_kernel_check=False requires the pair "
                             "engine (flat_s_steps=1)")


class TNTResult(NamedTuple):
    x: Any
    f: torch.Tensor
    gradfx_norm: torch.Tensor
    preconditioned_grad_f_x_norm: torch.Tensor
    status: torch.Tensor           # TNTStatus code
    num_iterations: torch.Tensor   # outer iterations entered
    # Traces over outer iterations; entries [0, num_iterations] valid.
    objective_values: torch.Tensor
    gradient_norms: torch.Tensor
    preconditioned_gradient_norms: torch.Tensor
    trust_region_radius: torch.Tensor
    # Per attempted step (entries [0, num_iterations) valid):
    inner_iterations: torch.Tensor
    update_step_norms: torch.Tensor
    update_step_M_norms: torch.Tensor
    gain_ratios: torch.Tensor
    # Wall-clock seconds per recorded iteration: NaN here, as from the JAX
    # package's monolithic solve (filled only by a host driver).
    times: Optional[torch.Tensor] = None
    iterates: Optional[Any] = None


def step_decision(rho, dm, eta1, eta2):
    """Trust-region step decision ``(accepted, very_successful,
    unsuccessful)`` from the gain ratio and the model decrease.

    Reference semantics (``TNT.h:511-532,590-603``): accept iff
    ``!isnan(rho) && rho > eta1``; a NaN rho rejects and shrinks.  As in
    the JAX package, a non-positive model decrease is treated like a NaN
    rho (an exact STPCG step always has dm > 0)."""
    model_ok = dm > 0
    accepted = ~torch.isnan(rho) & (rho > eta1) & model_ok
    very_successful = ~torch.isnan(rho) & (rho >= eta2) & model_ok
    unsuccessful = torch.isnan(rho) | (rho < eta1) | ~model_ok
    return accepted, very_successful, unsuccessful


def solve(
    problem: RiemannianProblem,
    x0: Any,
    params: TNTParams = TNTParams(),
    data: Any = None,
    user_function: Optional[Callable[..., Any]] = None,
    Delta0=None,
) -> TNTResult:
    """Minimize ``problem`` from ``x0`` by truncated-Newton trust region.

    ``user_function(k, x, f, grad, Delta, inner_iters, h, df, rho,
    accepted) -> bool`` is an optional stopping predicate called once per
    outer iteration before the update is applied (reference
    ``TNT.h:64-71,545-552``).  ``Delta0`` optionally overrides
    ``params.Delta0`` (a float or a tensor).
    """
    params.validate()
    M = problem.manifold
    n_trace = params.max_iterations + 1
    n_step = max(params.max_iterations, 1)

    def grad_and_norms(x):
        g = problem.rgrad(x, data)
        gn = torch.sqrt(M.inner(x, g, g))
        if problem.precon is not None:
            pg = problem.apply_precon(x, g, data)
            pgn = torch.sqrt(M.inner(x, pg, pg))
        else:
            pgn = gn
        return g, gn, pgn

    # Seed the step_eval aux carry at h = 0 (see the JAX solve): with an
    # evaluator the initial point, objective and gradient come from it.
    use_step_eval = (problem.step_eval is not None
                     and problem.precon is None)
    aux = None
    if use_step_eval:
        out0 = problem.step_eval(x0, tree_zeros_like(x0), data)
        x, f, grad, gradnorm = (out0[0], torch.as_tensor(out0[1]), out0[2],
                                out0[3])
        pgradnorm = gradnorm
        if len(out0) >= 5:
            aux = out0[4]
    else:
        x = x0
        f = torch.as_tensor(problem.value(x0, data))
        grad, gradnorm, pgradnorm = grad_and_norms(x0)
    dtype, dev = f.dtype, f.device
    finfo = torch.finfo(dtype)
    sqrt_eps = finfo.eps ** 0.5

    objective_values = trace_fill(n_trace, dtype, dev)
    gradient_norms = trace_fill(n_trace, dtype, dev)
    preconditioned_gradient_norms = trace_fill(n_trace, dtype, dev)
    trust_region_radius = trace_fill(n_trace, dtype, dev)
    inner_iterations = torch.zeros((n_step,), dtype=torch.int32, device=dev)
    update_step_norms = trace_fill(n_step, dtype, dev)
    update_step_M_norms = trace_fill(n_step, dtype, dev)
    gain_ratios = trace_fill(n_step, dtype, dev)
    iterates = (tree_map(lambda l: torch.zeros((n_trace,) + tuple(l.shape),
                                               dtype=l.dtype,
                                               device=l.device), x)
                if params.log_iterates else None)

    Delta = torch.as_tensor(params.Delta0 if Delta0 is None else Delta0,
                            dtype=dtype, device=dev)
    running = TNTStatus.RUNNING.value
    status = torch.tensor(running, dtype=torch.int32, device=dev)

    def record(k):
        objective_values[k] = f
        gradient_norms[k] = gradnorm
        preconditioned_gradient_norms[k] = pgradnorm
        trust_region_radius[k] = Delta
        if iterates is not None:
            tree_map(lambda tr, l: tr.__setitem__(k, l), iterates, x)

    k = 0
    while k < params.max_iterations:
        # the one host read of the outer iteration: status and the
        # convergence test together
        conv_status = torch.where(
            gradnorm < params.gradient_tolerance,
            TNTStatus.GRADIENT.value,
            torch.where(pgradnorm < params.preconditioned_gradient_tolerance,
                        TNTStatus.PRECONDITIONED_GRADIENT.value,
                        running)).to(torch.int32)
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
        inner = lambda u, v, x=x: M.inner(x, u, v)

        # STEP 2: trust-region subproblem (reference TNT.h:489-492)
        use_flat = problem.flat_qm is not None and (
            problem.precon is None or problem.flat_prec is not None)
        in_flat_branch = True
        if problem.flat_solve is not None and (
                problem.precon is None or problem.flat_prec is not None):
            # bring-your-own subproblem engine (the streamed kernel)
            cg = problem.flat_solve(grad, x, data, aux, Delta, params)
        elif use_flat:
            from ..linalg.flat_cg import stpcg_flat

            if aux is not None:
                qm_out = problem.flat_qm(x, data, aux)
            else:
                qm_out = problem.flat_qm(x, data)
            A0, Uf, Bf = qm_out[:3]
            initd = qm_out[3] if len(qm_out) > 3 else None
            prec_fn = (problem.flat_prec(x, data)
                       if problem.flat_prec is not None else None)
            if params.flat_s_steps > 1 or prec_fn is not None:
                initd = None
            cg = stpcg_flat(grad, A0, Uf, Bf, Delta,
                            max_iterations=params.max_TPCG_iterations,
                            kappa_fgr=params.kappa_fgr, theta=params.theta,
                            s_steps=params.flat_s_steps, init=initd,
                            kernel_check=params.flat_kernel_check,
                            prec=prec_fn)
        else:
            in_flat_branch = False
            _, Hv = problem.qm(x, data)
            precon_fn = None
            if problem.precon is not None:
                precon_fn = lambda r, x=x: (problem.apply_precon(x, r, data),
                                            None)
            cg = stpcg(grad, Hv, inner, Delta,
                       max_iterations=params.max_TPCG_iterations,
                       kappa_fgr=params.kappa_fgr, theta=params.theta,
                       precon=precon_fn, fused_dots=params.fused_dots)
        dm = cg.predicted_decrease
        h, h_M_norm = cg.s, cg.update_step_M_norm
        h_norm = (h_M_norm
                  if in_flat_branch and problem.flat_prec is None
                  else torch.sqrt(inner(h, h)))

        # STEP 3: trial point and gain ratio (reference TNT.h:505-532)
        if use_step_eval:
            out = problem.step_eval(x, h, data)
            x_prop, fx_prop, g_acc, gn_acc = out[:4]
            aux_prop = out[4] if aux is not None else None
            fx_prop = torch.as_tensor(fx_prop)
            pgn_acc = gn_acc
        else:
            aux_prop = None
            x_prop = M.retract(x, h)
            fx_prop = torch.as_tensor(problem.value(x_prop, data))
        df = f - fx_prop
        relative_decrease = df / (sqrt_eps + torch.abs(f))
        rho = df / dm
        accepted, very_successful, unsuccessful = step_decision(
            rho, dm, params.eta1, params.eta2)
        acc_floor = torch.zeros((), dtype=torch.bool, device=dev)
        if params.floor_acceptance:
            floor = 4.0 * finfo.eps * (torch.abs(f) + finfo.eps)
            acc_floor = ((dm > 0) & (dm <= floor) & (df >= -floor)
                         & ~accepted)
            accepted = accepted | acc_floor
            very_successful = very_successful & ~acc_floor
            unsuccessful = unsuccessful & ~acc_floor

        if user_function is not None:
            user_stop = torch.as_tensor(user_function(
                ridx, x, f, grad, Delta, cg.num_iterations, h, df, rho,
                accepted), device=dev)
        else:
            user_stop = torch.zeros((), dtype=torch.bool, device=dev)

        # accepted-step updates (reference TNT.h:555-585); a user stop
        # fires before the update is applied
        apply = accepted & ~user_stop
        x_new = tree_where(apply, x_prop, x)
        f_new = torch.where(apply, fx_prop, f)
        if not use_step_eval:
            g_acc, gn_acc, pgn_acc = grad_and_norms(x_prop)
        grad = tree_where(apply, g_acc, grad)
        if aux_prop is not None:
            aux = tree_where(apply, aux_prop, aux)
        gn_new = torch.where(apply, gn_acc, gradnorm)
        pgn_new = torch.where(apply, pgn_acc, pgradnorm)

        # floor-accepted steps do not fire the relative-decrease stop
        apply_meas = apply & ~acc_floor
        new_status = torch.where(
            user_stop,
            TNTStatus.USER_FUNCTION.value,
            torch.where(
                apply_meas
                & (relative_decrease < params.relative_decrease_tolerance),
                TNTStatus.RELATIVE_DECREASE.value,
                torch.where(apply & (h_norm < params.stepsize_tolerance),
                            TNTStatus.STEPSIZE.value,
                            running))).to(torch.int32)

        # STEP 4: trust-region radius update (reference TNT.h:590-603),
        # skipped when a stopping criterion already fired
        Delta_new = torch.where(
            very_successful,
            torch.maximum(params.alpha2 * h_M_norm, Delta),
            torch.where(unsuccessful, params.alpha1 * h_M_norm, Delta))
        tr_collapse = unsuccessful & (Delta_new < params.Delta_tolerance)
        is_running = new_status == running
        Delta_new = torch.where(is_running, Delta_new, Delta)
        status = torch.where(is_running & tr_collapse,
                             TNTStatus.TRUST_REGION.value,
                             new_status).to(torch.int32)

        inner_iterations[ridx] = cg.num_iterations.to(torch.int32)
        update_step_norms[ridx] = h_norm
        update_step_M_norms[ridx] = h_M_norm
        gain_ratios[ridx] = rho
        x, f, gradnorm, pgradnorm = x_new, f_new, gn_new, pgn_new
        Delta = Delta_new.to(dtype)

    status = torch.where(status == running,
                         TNTStatus.ITERATION_LIMIT.value,
                         status).to(torch.int32)
    record(k)   # final trace entry (reference TNT.h:616-624)

    return TNTResult(
        x=x, f=f, gradfx_norm=gradnorm,
        preconditioned_grad_f_x_norm=pgradnorm,
        status=status,
        num_iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        objective_values=objective_values,
        gradient_norms=gradient_norms,
        preconditioned_gradient_norms=preconditioned_gradient_norms,
        trust_region_radius=trust_region_radius,
        inner_iterations=inner_iterations,
        update_step_norms=update_step_norms,
        update_step_M_norms=update_step_M_norms,
        gain_ratios=gain_ratios,
        times=trace_fill(n_trace, torch.float32, dev),
        iterates=iterates,
    )
