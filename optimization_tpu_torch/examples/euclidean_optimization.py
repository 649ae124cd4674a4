"""Euclidean GD + TNT on the (chained) Rosenbrock function (counterpart of
``examples/euclidean_optimization.py``, BASELINE config 1).

The reference's 2-dim Rosenbrock by GD and TNT, then the 100-dim chained
Rosenbrock by TNT (generic STPCG; no kernel is launched).
Run:  python -m optimization_tpu_torch.examples.euclidean_optimization [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from optimization_tpu_torch import RiemannianProblem
from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.manifolds import euclidean
from optimization_tpu_torch.solvers import gradient_descent as gd
from optimization_tpu_torch.solvers import tnt


def rosenbrock2(x, data):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def chained_rosenbrock(x, data):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def run(device, dtype=None, data=None) -> dict:
    """No random draws: ``data`` is unused."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    tol = 1e-6 if dtype == torch.float64 else 1e-3
    kw = dict(dtype=dtype, device=dev)
    stops = dict(relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)

    problem2 = RiemannianProblem(f=rosenbrock2, manifold=euclidean())
    x0 = torch.tensor([-1.2, 1.0], **kw)
    out = {}
    res, wall = C.timed(lambda: gd.solve(problem2, x0, gd.GradientDescentParams(
        max_iterations=200000, gradient_tolerance=tol, **stops)), dev)
    out["gd_2d"] = C.summary(res, wall, x=res.x.tolist())
    tparams = dict(gradient_tolerance=tol, preconditioned_gradient_tolerance=0.0,
                   **stops)
    res, wall = C.timed(lambda: tnt.solve(problem2, x0, tnt.TNTParams(
        max_iterations=1000, **tparams)), dev)
    out["tnt_2d"] = C.summary(res, wall, x=res.x.tolist())

    problem100 = RiemannianProblem(f=chained_rosenbrock, manifold=euclidean())
    x100 = torch.full((100,), -1.0, **kw)
    res, wall = C.timed(lambda: tnt.solve(problem100, x100, tnt.TNTParams(
        max_iterations=2000, **tparams)), dev)
    out["tnt_100d"] = C.summary(
        res, wall, dist=float(torch.linalg.vector_norm(res.x - 1.0)))
    return out


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    C.report("GD  rosenbrock-2d", out["gd_2d"], f"x={np.array(out['gd_2d']['x'])}")
    C.report("TNT rosenbrock-2d", out["tnt_2d"], f"x={np.array(out['tnt_2d']['x'])}")
    C.report("TNT rosenbrock-100d", out["tnt_100d"],
             f"|x-1|={out['tnt_100d']['dist']:.2e}")
    return out


if __name__ == "__main__":
    main()
