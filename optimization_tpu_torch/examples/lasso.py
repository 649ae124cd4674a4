"""LASSO via FISTA and ADMM, and a batch-sharded FISTA fleet (counterpart
of ``examples/lasso.py``, BASELINE config 4).

The reference's group LASSO by FISTA, the dense 600 x 2000 LASSO by ADMM
(Boyd Sec. 11.1; the x-update a Cholesky solve), then a fleet of 8 LASSO
instances solved through ``parallel.sharding.batch_sharded_solve`` over
the mesh's batch axis: each rank loops FISTA over its slice of the fleet
(JAX vmaps one solve).  No kernel is launched.
Run:  python -m optimization_tpu_torch.examples.lasso [--device cpu]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from optimization_tpu_torch import CompositeProblem
from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.parallel.sharding import batch_sharded_solve
from optimization_tpu_torch.solvers import admm
from optimization_tpu_torch.solvers import proximal_gradient as pg
from optimization_tpu_torch.solvers.prox import (group_soft_threshold,
                                                 soft_threshold)


def fista_group_lasso(dev, dtype) -> dict:
    kw = dict(dtype=dtype, device=dev)
    A = torch.diag(torch.tensor([1000.0, 1.0], **kw))
    b = torch.tensor([1.0, 1.0], **kw)
    mu = 10.0
    problem = CompositeProblem(
        f=lambda x, d: torch.sum((A @ x - b) ** 2),
        g=lambda x, d: mu * torch.linalg.vector_norm(x),
        prox_g=lambda x, lam, d: group_soft_threshold(x, mu * lam))
    res, wall = C.timed(lambda: pg.solve(
        problem, torch.tensor([4.0, 4.0], **kw), pg.ProximalGradientParams(
            max_iterations=1000000, composite_gradient_tolerance=1e-4)), dev)
    return C.summary(res, wall, x=res.x.tolist())


def lasso_data(gen, m, n, nnz, dtype):
    """A with unit columns, a sparse x_true, b = A x_true + noise."""
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    A = torch.randn((m, n), **kw)
    A = A / torch.linalg.vector_norm(A, dim=0, keepdim=True)
    x_true = torch.zeros(n, dtype=dtype, device=gen.device)
    idx = torch.randint(0, n, (nnz,), generator=gen, device=gen.device)
    x_true[idx] = torch.randn(nnz, **kw)
    return A, A @ x_true + torch.randn(m, **kw)


def admm_lasso(dev, dtype, data, m=600, n=2000, nnz=60) -> dict:
    A, b = C.take(data, "admm", lambda: lasso_data(C.generator(dev, 0), m, n,
                                                   nnz, dtype))
    m, n = A.shape
    Atb = A.T @ b
    mu = 0.1 * torch.max(torch.abs(Atb))
    AtA = A.T @ A
    eye = torch.eye(n, dtype=dtype, device=dev)
    factor = {}

    def minLx(y, lam, rho, d):
        # rho stays fixed unless penalty adaptation is on (it is off
        # here): one Cholesky factor per value of rho
        key = float(rho)
        if key not in factor:
            factor.clear()
            factor[key] = torch.linalg.cholesky(AtA + rho * eye)
        rhs = (Atb + rho * y - lam)[:, None]
        return torch.cholesky_solve(rhs, factor[key])[:, 0]

    problem = admm.ADMMProblem(
        minLx=minLx,
        minLy=lambda x, lam, rho, d: soft_threshold(x + lam / rho, mu / rho),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    params = admm.ADMMParams(max_iterations=250, eps_rel=1e-4,
                             eps_abs_pri=1e-2, eps_abs_dual=1e-2)
    z = torch.zeros(n, dtype=dtype, device=dev)
    res, wall = C.timed(lambda: admm.solve(problem, z, z, z, params), dev)
    return dict(status=int(res.status), iters=int(res.num_iterations),
                wall=wall, m=m, n=n)


def sharded_fista_fleet(dev, dtype, data, batch=8, m=128, n=512) -> dict:
    """A fleet of LASSO instances over the mesh's batch axis (DP)."""
    def draw():
        gen = C.generator(dev, 1)
        kw = dict(generator=gen, dtype=dtype, device=dev)
        return (torch.randn((batch, m, n), **kw) / math.sqrt(m),
                torch.randn((batch, m), **kw))

    A, b = C.take(data, "fleet", draw)
    mu = 0.05
    problem = CompositeProblem(
        f=lambda x, d: 0.5 * torch.sum((d[0] @ x - d[1]) ** 2),
        g=lambda x, d: mu * torch.sum(torch.abs(x)),
        prox_g=lambda x, lam, d: soft_threshold(x, mu * lam))
    params = pg.ProximalGradientParams(
        max_iterations=5000, composite_gradient_tolerance=1e-6)
    x0s = torch.zeros((A.shape[0], A.shape[2]), dtype=dtype, device=dev)
    with C.batch_mesh(dev) as mesh:
        run = batch_sharded_solve(
            lambda x0, d: pg.solve(problem, x0, params, data=d), mesh)
        res, wall = C.timed(lambda: run(x0s, (A, b)), dev)
        ranks = mesh.size()
    return dict(statuses=res.status.tolist(),
                iters=res.num_iterations.tolist(), f=res.f.tolist(),
                batch=A.shape[0], ranks=ranks, wall=wall)


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"admm": (A (600, 2000), b (600,)), "fleet": (A (8, 128,
    512), b (8, 128))}`` (default: drawn from generators seeded 0 and 1)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    return {"fista": fista_group_lasso(dev, dtype),
            "admm": admm_lasso(dev, dtype, data),
            "fleet": sharded_fista_fleet(dev, dtype, data)}


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    r = out["fista"]
    print(f"[FISTA group-lasso] status={r['status']} iters={r['iters']} "
          f"F={r['f']:.6f} x={np.array(r['x'])} wall={r['wall']:.2f}s")
    r = out["admm"]
    print(f"[ADMM lasso {r['m']}x{r['n']}] status={r['status']} "
          f"iters={r['iters']} wall={r['wall']:.2f}s")
    r = out["fleet"]
    print(f"[FISTA fleet x{r['batch']} on {r['ranks']} devices] "
          f"statuses={np.array(r['statuses'])} wall={r['wall']:.2f}s")
    return out


if __name__ == "__main__":
    main()
