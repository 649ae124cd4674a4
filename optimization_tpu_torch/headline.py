"""The headline solve: TNT minimizing the Rayleigh quotient on S^(n-1).

Port of the problem construction of ``bench.py:run_tier`` (round-5 JAX
package): f(x) = <x, A x> on the unit sphere in R^n with the SPD diagonal
A = diag(1 + b i), b = (kappa - 1)/(n - 1) (spectrum 1..kappa, so f* = 1;
kappa = 1000 is the headline), 30 outer TNT iterations with at most 50 CG
iterations each.  Two storage tiers:

- f32: the trust-region subproblem runs in ``stpcg_flat_streamed`` through
  the ``flat_solve`` seam (the CUDA kernel on a CUDA tensor; its plain
  version on a CPU tensor), threading the init dot group from the fused
  trial-step evaluator;
- bf16 storage / f32 accumulation: the flat pair engine through
  ``flat_qm``.

``engine`` picks the subproblem route: ``"streamed"`` (the f32 tier's),
``"streamed_reference"`` (the same route with the kernel's plain version,
the comparison ``chip_smoke.py`` makes) or ``"flat"`` (the bf16 tier's).
The trial step is always ``sphere_rayleigh_step``, and the gradient is
cast to the iterate's dtype, so one problem serves every storage dtype (and
both stages of ``tnt.solve_escalated``).

``jacobi_power=e`` adds the shifted-Jacobi preconditioner
P = (|2a - rq| + 1)^(-e) (e = 1/4 is the half power of the JAX package's
``benchmarks/config13_streamed_prec.py``): the flat route folds it through
``flat_prec``, the streamed routes through the kernel's ``JacobiPower``
descriptor; no init group is threaded then (it would be untransformed).

The diagonal is regenerated from its index inside the kernels; the eager
PyTorch paths hold it as one stored f32 vector with the same values.  The
trial step is ``kernels.sphere_step.sphere_rayleigh_step`` of a
``DiagonalElem``, which carries the diagonal's descriptor, so on the card
every trial step is one launch of ``csrc/sphere_step.cu``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from .core.problem import RiemannianProblem
from .core.profiling import annotate
from .kernels.streamed_cg import (AffineDiagonal, JacobiPower,
                                  sphere_rayleigh_streamed,
                                  stpcg_flat_streamed,
                                  stpcg_flat_streamed_reference)
from .kernels.sphere_step import DiagonalElem, sphere_rayleigh_step
from .linalg.flat_cg import sphere_rayleigh_flat
from .manifolds.sphere import sphere
from .solvers import tnt

__all__ = ["ENGINES", "make_problem", "tier_params", "initial_point",
           "run_tier", "TierRun"]

ENGINES = ("streamed", "streamed_reference", "flat")


def make_problem(n: int, device, engine: str = "flat", *,
                 kappa: float = 1000.0,
                 jacobi_power: Optional[float] = None) -> RiemannianProblem:
    """The headline ``RiemannianProblem`` at size n, diagonal spread
    ``kappa``, optionally preconditioned (module docstring)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}")
    M = sphere()
    diag = AffineDiagonal(1.0, (kappa - 1.0) / (n - 1))
    A_elem = DiagonalElem(diag, n, device)
    desc = None if jacobi_power is None else JacobiPower(1.0, jacobi_power)

    def f(x, dd):
        return torch.dot(x.to(torch.float32), A_elem(x))

    def grad(x, dd):
        return M.proj(x, (2.0 * A_elem(x)).to(x.dtype))

    def flat_qm(x, dd, aux=None):
        # aux: the step_eval carry (trial Rayleigh quotient + the flat
        # engine's pre-loop dot group)
        rq = aux.rq if aux is not None else None
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
        if desc is not None:
            return A0, U, B
        return A0, U, B, (aux.init if aux is not None else None)

    flat_prec = None
    if desc is not None:
        def flat_prec(x, dd):
            return desc.map(diag,
                            torch.dot(x.to(torch.float32), 2.0 * A_elem(x)),
                            n, x.device)

    flat_solve = None
    if engine != "flat":
        solver = (stpcg_flat_streamed if engine == "streamed"
                  else stpcg_flat_streamed_reference)
        a0c, weights, B_fn = sphere_rayleigh_streamed(diag)

        def flat_solve(g, x, dd, aux, Delta, params):
            rq = aux.rq
            if desc is None:
                kw = dict(init=aux.init)
            else:
                with annotate("headline.prec_map"):
                    kw = dict(prec_chunk=desc,
                              prec=desc.map(diag, rq, n, x.device))
            return solver(
                g, x, B_fn(rq), Delta, aux_scalars=(rq,), a0_chunk=a0c,
                weights=weights, max_iterations=params.max_TPCG_iterations,
                kappa_fgr=params.kappa_fgr, theta=params.theta, **kw)

    return RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm,
                             flat_solve=flat_solve, flat_prec=flat_prec,
                             step_eval=sphere_rayleigh_step(A_elem))


def tier_params(grad_tol: float, max_tpcg: int = 50,
                max_iterations: int = 30) -> tnt.TNTParams:
    """``bench.py``'s fixed-effort TNT params: tolerance 0 everywhere but
    the gradient."""
    return tnt.TNTParams(
        max_iterations=max_iterations, max_TPCG_iterations=max_tpcg,
        gradient_tolerance=grad_tol, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)


def initial_point(n: int, dtype: torch.dtype, device,
                  seed: int) -> torch.Tensor:
    """A uniform random point on S^(n-1), drawn in f32 from a seeded
    generator on ``device`` and cast to the storage dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return sphere().rand(gen, n, dtype=torch.float32,
                         device=device).to(dtype)


class TierRun(NamedTuple):
    cg_per_s: float
    outer: int
    inner: int
    seconds: float
    fstar: float
    result: tnt.TNTResult


def run_tier(problem: RiemannianProblem, x0: torch.Tensor,
             params: tnt.TNTParams) -> TierRun:
    """One timed TNT solve.  The wall clock closes after the device has
    finished (``torch.cuda.synchronize`` on a CUDA iterate)."""
    cuda = x0.is_cuda
    if cuda:
        torch.cuda.synchronize(x0.device)
    t0 = time.perf_counter()
    res = tnt.solve(problem, x0, params)
    if cuda:
        torch.cuda.synchronize(x0.device)
    dt = time.perf_counter() - t0
    outer = int(res.num_iterations)
    inner = int(res.inner_iterations[:outer].sum())
    return TierRun(inner / dt if dt > 0 else 0.0, outer, inner, dt,
                   float(res.f), res)
