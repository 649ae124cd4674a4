"""Plain TNT on the sphere Rayleigh quotient: the benchmark's reference.

    f(x) = <x, A x> on S^(n-1),  A = diag(a),  a_i = 1 + (kappa - 1) i/(n - 1)

minimized by the truncated-Newton trust-region method (Conn, Gould and
Toint, Algorithm 6.1.1, as ``TNT.h`` of github.com/david-m-rosen/Optimization
states it) with Steihaug-Toint CG for the subproblem, written from the
textbook in whole-vector torch operations.  It imports nothing of the
program and takes nothing the program made: the harness hands it the start
point and the configuration, and it builds the diagonal and the
preconditioner itself.

The Riemannian Hessian at a unit x, with rq = <x, 2Ax>, is applied on the
whole space as  H v = (2a - rq) v + U B U' v,  U = (x, 2a x),
B = [[2 rq, -1], [-1, 0]]  (equal to P_x(2Av) - rq v on tangent v).  With a
preconditioner P = diag((|2a - rq| + 1)^(-e)), CG runs on P H P with the
gradient P g, the trust region bounds the transformed step (|P^-1 s|, the
step's M-norm), and the step is s = P s_hat.

``storage`` is the dtype every vector is rounded to when it is stored:
float64 for the reference; bfloat16 for the control, whose scalars and
reductions are then float32 (bf16 storage with f32 accumulation).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch

GRADIENT, TRUST_REGION, ITERATION_LIMIT = 1, 5, 6


@dataclass
class SolveParams:
    max_iterations: int
    max_cg: int
    gradient_tolerance: float
    kappa_fgr: float = 0.1
    theta: float = 0.5
    eta1: float = 0.05
    eta2: float = 0.9
    alpha1: float = 0.25
    alpha2: float = 2.5
    Delta0: float = 1.0
    Delta_tolerance: float = 1e-6
    epsilon: float = 1e-8


@dataclass
class Call:
    """One trial-step evaluation: from iterate x and step h (None for the
    start), the stated objective and gradient at the retracted point."""

    x: torch.Tensor
    h: Optional[torch.Tensor]
    f: float
    g: torch.Tensor


@dataclass
class Solve:
    """What one solve states, with what it did on the way."""

    x: torch.Tensor
    f: float
    g: torch.Tensor
    status: int
    num_iterations: int
    calls: List[Call] = field(default_factory=list)
    radius: List[float] = field(default_factory=list)   # before each step
    rho: List[float] = field(default_factory=list)
    dm: List[float] = field(default_factory=list)       # stated decrease


class SphereRayleigh:
    """The objective, its Hessian and the subproblem for one (n, kappa, e)
    on a device."""

    def __init__(self, n: int, kappa: float, jacobi_power: Optional[float],
                 device, storage: torch.dtype = torch.float64):
        self.n, self.e, self.storage = n, jacobi_power, storage
        self.acc = (torch.float64 if storage == torch.float64
                    else torch.float32)
        i = torch.arange(n, dtype=torch.float64, device=device)
        self.a = (1.0 + (kappa - 1.0) * i / (n - 1)).to(self.acc)

    def st(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(self.storage)

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> float:
        return float(torch.dot(u.to(self.acc), v.to(self.acc)))

    def evaluate(self, u: torch.Tensor):
        """(x, f, g) at the retraction x = u / |u| of a point u."""
        u = u.to(self.acc)
        au = self.a * u
        n2 = self.dot(u, u)
        f = self.dot(u, au) / n2
        c = 1.0 / math.sqrt(n2)
        return self.st(c * u), f, self.st((2.0 * c) * au - (2.0 * f * c) * u)

    def precon(self, rq: float) -> Optional[torch.Tensor]:
        if self.e is None:
            return None
        return (torch.abs(2.0 * self.a - rq) + 1.0) ** (-self.e)

    def hess(self, x, rq: float, v) -> torch.Tensor:
        """H v at x (unpreconditioned), in the accumulation type."""
        x, v = x.to(self.acc), v.to(self.acc)
        u2 = 2.0 * self.a * x
        c1, c2 = self.dot(x, v), self.dot(u2, v)
        return (2.0 * self.a - rq) * v + (2.0 * rq * c1 - c2) * x - c1 * u2

    def model(self, g, x, rq: float, s) -> float:
        """The quadratic model's value <g, s> + <s, H s> / 2 at step s."""
        return self.dot(g, s) + 0.5 * self.dot(s, self.hess(x, rq, s))

    def m_norm(self, s, rq: float) -> float:
        """|P^-1 s| (|s| without a preconditioner)."""
        p = self.precon(rq)
        s = s.to(self.acc)
        return math.sqrt(self.dot(s, s) if p is None
                         else self.dot(s / p, s / p))

    def stpcg(self, g, x, rq: float, Delta: float, prm: SolveParams):
        """Steihaug-Toint CG: (step, M-norm of the step, CG iterations,
        predicted decrease)."""
        a0 = 2.0 * self.a - rq
        u1 = x.to(self.acc)
        u2 = 2.0 * self.a * u1
        r = g.to(self.acc)
        pv = self.precon(rq)
        if pv is not None:
            a0, u1, u2, r = pv * pv * a0, pv * u1, pv * u2, pv * r
        a0, u1, u2, r = self.st(a0), self.st(u1), self.st(u2), self.st(r)

        def hess(v):
            c1, c2 = self.dot(u1, v), self.dot(u2, v)
            return self.st(a0.to(self.acc) * v.to(self.acc)
                           + (2.0 * rq * c1 - c2) * u1.to(self.acc)
                           - c1 * u2.to(self.acc))

        rv = self.dot(r, r)
        r0n = math.sqrt(rv)
        target = r0n * min(prm.kappa_fgr, r0n ** prm.theta)
        s = torch.zeros_like(r)
        p = None
        rv_prev = sk2 = m = 0.0
        k, boundary = 0, False
        while k < prm.max_cg and math.sqrt(rv) > target:
            p = self.st(-r.to(self.acc) if p is None
                        else -r.to(self.acc) + (rv / rv_prev) * p.to(self.acc))
            q = hess(p)
            kap, pp, qq = self.dot(p, q), self.dot(p, p), self.dot(q, q)
            sp = self.dot(s, p)
            alpha = rv / kap if kap != 0.0 else math.inf
            sk2_next = sk2 + 2.0 * alpha * sp + alpha * alpha * pp
            in_kernel = qq < prm.epsilon ** 2 * pp
            if in_kernel or kap <= 0.0 or sk2_next > Delta * Delta:
                pr = self.dot(p, r)
                sign = -1.0 if (in_kernel and pr > 0.0) else 1.0
                spe = sign * sp
                disc = max(spe * spe + pp * (Delta * Delta - sk2), 0.0)
                sigma = (-spe + math.sqrt(disc)) / pp
                s = self.st(s.to(self.acc) + (sign * sigma) * p.to(self.acc))
                m += sign * sigma * pr + 0.5 * sigma * sigma * kap
                boundary = True
                break
            s = self.st(s.to(self.acc) + alpha * p.to(self.acc))
            r = self.st(r.to(self.acc) + alpha * q.to(self.acc))
            m -= 0.5 * alpha * rv
            rv_prev, rv = rv, self.dot(r, r)
            sk2 = sk2_next
            k += 1
        m_norm = Delta if boundary else math.sqrt(sk2)
        if pv is not None:
            s = self.st(pv * s.to(self.acc))
        return s, m_norm, k, -m


def radius_update(Delta: float, rho: float, model_ok: bool, m_norm: float,
                  prm: SolveParams) -> float:
    """The trust region's radius after a step (``TNT.h:590-603``)."""
    if model_ok and rho >= prm.eta2:
        return max(prm.alpha2 * m_norm, Delta)
    if not model_ok or math.isnan(rho) or rho < prm.eta1:
        return prm.alpha1 * m_norm
    return Delta


def solve(problem: SphereRayleigh, x0: torch.Tensor,
          prm: SolveParams) -> Solve:
    """TNT from x0 with the program's stopping rules at the benchmark's
    settings (relative-decrease, stepsize and preconditioned-gradient
    tolerances 0, so only the gradient, the trust region's collapse and
    the iteration limit stop it)."""
    x, f, g = problem.evaluate(x0.to(problem.storage))
    out = Solve(x=x, f=f, g=g, status=0, num_iterations=0,
                calls=[Call(x0, None, f, g)])
    Delta = prm.Delta0
    k = 0
    while k < prm.max_iterations:
        k += 1
        if math.sqrt(problem.dot(g, g)) < prm.gradient_tolerance:
            out.status = GRADIENT
            break
        rq = 2.0 * f
        s, m_norm, _, dm = problem.stpcg(g, x, rq, Delta, prm)
        xp, fp, gp = problem.evaluate(x.to(problem.acc) + s.to(problem.acc))
        out.calls.append(Call(x, s, fp, gp))
        out.radius.append(Delta)
        rho = (f - fp) / dm if dm != 0.0 else math.nan
        model_ok = dm > 0
        out.rho.append(rho)
        out.dm.append(dm)
        if model_ok and not math.isnan(rho) and rho > prm.eta1:
            x, f, g = xp, fp, gp
        Delta = radius_update(Delta, rho, model_ok, m_norm, prm)
        if Delta < prm.Delta_tolerance:
            out.status = TRUST_REGION
            break
    out.radius.append(Delta)
    if out.status == 0:
        out.status = ITERATION_LIMIT
    out.x, out.f, out.g, out.num_iterations = x, f, g, k
    return out
