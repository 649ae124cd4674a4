"""Riemannian GD + TNT on the sphere (counterpart of
``examples/riemannian_optimization.py``, BASELINE config 2).

Minimizes |X - P|^2 over S^2 (the reference's example) by gradient descent
and TNT, then the Rayleigh quotient <x, diag(1..1000) x> on S^4095 (its
smallest eigenpair) by TNT through the generic STPCG engine; no kernel is
launched.  Run:  python -m optimization_tpu_torch.examples.riemannian_optimization [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from optimization_tpu_torch import RiemannianProblem
from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.manifolds import sphere
from optimization_tpu_torch.solvers import gradient_descent as gd
from optimization_tpu_torch.solvers import tnt


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"x0": (n,) start on the sphere}`` for the Rayleigh
    quotient (default: n = 4096, drawn from a generator seeded 0)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    kw = dict(dtype=dtype, device=dev)

    # --- |X - P|^2 over S^2 (the reference example) ---
    P = torch.tensor([0.0, 0.0, 1.0], **kw)
    problem = RiemannianProblem(f=lambda x, p: torch.sum((x - p) ** 2),
                                manifold=sphere())
    x0 = torch.tensor([-0.5, -0.5, -0.707107], **kw)
    out = {}
    res, wall = C.timed(lambda: gd.solve(problem, x0, gd.GradientDescentParams(
        max_iterations=100000, gradient_tolerance=tol,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0), data=P), dev)
    out["gd_sphere"] = C.summary(res, wall, x=res.x.tolist())
    res, wall = C.timed(lambda: tnt.solve(problem, x0, tnt.TNTParams(
        gradient_tolerance=tol, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0),
        data=P), dev)
    out["tnt_sphere"] = C.summary(res, wall, x=res.x.tolist())

    # --- Rayleigh quotient on S^{n-1}: smallest eigenpair of diag(1..n) ---
    x0 = C.take(data, "x0", lambda: sphere().rand(C.generator(dev, 0), 4096,
                                                  **kw))
    d = torch.linspace(1.0, 1000.0, x0.shape[0], **kw)
    rq = RiemannianProblem(f=lambda x, dd: torch.dot(x, dd * x),
                           manifold=sphere())
    res, wall = C.timed(lambda: tnt.solve(rq, x0, tnt.TNTParams(
        max_iterations=200, gradient_tolerance=tol,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0), data=d), dev)
    out["tnt_rayleigh"] = C.summary(res, wall)
    return out


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    for name, key in (("GD  sphere", "gd_sphere"), ("TNT sphere", "tnt_sphere")):
        C.report(name, out[key], f"x={np.array(out[key]['x'])}")
    r = out["tnt_rayleigh"]
    C.report("TNT rayleigh-4096", r, f"lambda_min~{r['f']:.6f} (true 1.0)")
    return out


if __name__ == "__main__":
    main()
