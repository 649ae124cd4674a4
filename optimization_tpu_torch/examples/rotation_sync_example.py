"""Riemannian TNT rotation synchronization and a batch-sharded fleet
(counterpart of ``examples/rotation_sync_example.py``, BASELINE config 5).

SE-Sync-style: n = 64 absolute rotations from noisy relative ones, a
spectral (chordal) initialization by LOBPCG on the connection Laplacian,
then TNT over SO(3)^n; then a fleet of 4 instances over one edge set,
each with its own spectral init, solved through
``parallel.sharding.batch_sharded_solve`` over the mesh's batch axis (a
loop per rank; JAX vmaps one solve).  In f32 on the card every spectral
init runs its Gram stages in the ``gram_pair`` kernel.
Run:  python -m optimization_tpu_torch.examples.rotation_sync_example [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.models import rotation_sync as rs
from optimization_tpu_torch.parallel.sharding import batch_sharded_solve
from optimization_tpu_torch.solvers import tnt


def params(dtype) -> tnt.TNTParams:
    return tnt.TNTParams(
        max_iterations=200,
        gradient_tolerance=1e-8 if dtype == torch.float64 else 1e-4,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"instance": (R_true, RotationSyncData), "fleet":
    RotationSyncData with Rij (B, E, 3, 3)}``, and optionally the spectral
    starts ``"R0"`` (n, 3, 3) and ``"R0s"`` (B, n, 3, 3) (default: n = 64
    and B = 4 drawn from generators seeded 0 and 7; each start from
    ``spectral_init``)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    n, d = 64, 3
    p = params(dtype)
    problem = rs.make_problem()
    R_true, inst = C.take(data, "instance", lambda: rs.random_instance(
        C.generator(dev, 0), n, d, extra_edges=2 * n, noise=0.05,
        dtype=dtype))
    n = R_true.shape[0]
    # SE-Sync pipeline: chordal (spectral) initialization via LOBPCG on the
    # connection Laplacian, then TNT refinement
    R0 = C.take(data, "R0",
                lambda: rs.spectral_init(inst, n, d).to(dtype))
    res, wall = C.timed(lambda: tnt.solve(problem, R0, p, data=inst), dev)
    out = {"single": C.summary(res, wall, n=n, err=float(
        rs.mean_rotation_error(res.x, R_true)))}

    # --- batched fleet over the mesh's batch axis: one shared edge
    # topology, per-instance measurements, spectral init per instance ---
    fleet = C.take(data, "fleet", lambda: rs.random_fleet(
        C.generator(dev, 7), 4, n, d, extra_edges=2 * n, noise=0.05,
        dtype=dtype)[1])
    B = fleet.Rij.shape[0]
    R0s = C.take(data, "R0s", lambda: torch.stack([
        rs.spectral_init(fleet._replace(Rij=fleet.Rij[i]), n, d)
        for i in range(B)]).to(dtype))
    with C.batch_mesh(dev) as mesh:
        solve = batch_sharded_solve(
            lambda r0, rij: tnt.solve(problem, r0, p,
                                      data=fleet._replace(Rij=rij)), mesh)
        fl, wall = C.timed(lambda: solve(R0s, fleet.Rij), dev)
    out["fleet"] = dict(statuses=fl.status.tolist(),
                        iters=fl.num_iterations.tolist(), f=fl.f.tolist(),
                        grad=fl.gradfx_norm.tolist(), batch=B, wall=wall)
    return out


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    r = out["single"]
    print(f"[rotation-sync n={r['n']}] status={r['status']} "
          f"iters={r['iters']} f={r['f']:.4e} aligned-err={r['err']:.4f} "
          f"wall={r['wall']:.2f}s")
    r = out["fleet"]
    print(f"[rotation-sync fleet x{r['batch']}] "
          f"statuses={np.array(r['statuses'])} "
          f"f={np.array(r['f']).round(4)} wall={r['wall']:.2f}s")
    return out


if __name__ == "__main__":
    main()
