"""Low-rank matrix completion on the Grassmann manifold, RTRMC-style
(counterpart of ``examples/matrix_completion_example.py``).

Recovers a rank-4 400 x 300 matrix from 25% noisy observations: spectral
initialization (an SVD), then Riemannian TNT over the column space with
the batched per-column ridge solve inside the objective.  No kernel is
launched.  Run:  python -m optimization_tpu_torch.examples.matrix_completion_example [--device cpu]
"""

from __future__ import annotations

import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.models import matrix_completion as mc
from optimization_tpu_torch.solvers import tnt

SIZES = dict(m=400, n=300, k=4, frac=0.25, noise=0.01)


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"instance": (M_true, CompletionData)}`` (default: the
    400 x 300 rank-4 instance from a generator seeded 0)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    m, n, k, frac, noise = SIZES.values()
    M_true, cdata = C.take(data, "instance", lambda: mc.random_instance(
        C.generator(dev, 0), m, n, k, frac=frac, noise=noise, lam=1e-8,
        dtype=dtype))
    U0 = mc.spectral_init(cdata, k)
    f32 = M_true.dtype == torch.float32
    params = tnt.TNTParams(
        max_iterations=100, gradient_tolerance=(1e-4 if f32 else 1e-9),
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0, max_TPCG_iterations=200)
    res, wall = C.timed(lambda: tnt.solve(mc.make_problem(), U0, params,
                                          data=cdata), dev)
    M_hat = mc.predict(res.x, cdata)
    rel = float(torch.linalg.norm(M_hat - M_true) / torch.linalg.norm(M_true))
    return C.summary(res, wall, rel_err=rel, **SIZES)


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    r = run(dev, dtype)
    print(f"m x n = {r['m']} x {r['n']}, rank {r['k']}, {r['frac']:.0%} "
          f"observed, noise {r['noise']}")
    C.report("matrix-completion", r,
             extra=f"rel-err(all entries)={r['rel_err']:.2e} "
                   f"(noise {r['noise']})")
    return r


if __name__ == "__main__":
    main()
