"""Online re-solving with warm starts: a growing rotation-sync problem
(counterpart of ``examples/online_warm_start.py``).

The deployment story: a SLAM / mapping session keeps appending relative
measurements to its graph.  Re-solving each snapshot from a cold spectral
initialization wastes the fact that the previous optimum is (nearly) a
critical point of the grown problem; warm-starting TNT from it converges
in a handful of outer iterations, and the SE-Sync certificate
(``rotation_sync.certify``) confirms that each snapshot is still the
global optimum.

Mechanics (all public seams): a fixed edge set with a weight mask
(``kappa`` zeroes the not-yet-seen edges, cast to the data's dtype), the
warm start as TNT's initial iterate, and ``certify(..., rr_method="chol",
precondition=True)``, the cheap certificate configuration.  One cold
spectral init, from the first snapshot only.  In f32 on the card that
init and every certificate run their Gram stages in the ``gram_pair``
kernel.  Raises ``SystemExit`` at the first snapshot left uncertified.
Run:  python -m optimization_tpu_torch.examples.online_warm_start [--device cpu]
"""

from __future__ import annotations

import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.models import rotation_sync as rs
from optimization_tpu_torch.solvers import tnt


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"instance": (R_true, RotationSyncData)}`` (default:
    n = 40 with 3n extra edges, from a generator seeded 0).  Stops after the
    first snapshot that is not certified, as the JAX example does."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    n, d = 40, 3
    # the full measurement set, revealed in chunks: a spanning chain first
    # (keeps every snapshot connected), then batches of loop closures
    R_true, data_full = C.take(data, "instance", lambda: rs.random_instance(
        C.generator(dev, 0), n, d, extra_edges=3 * n, noise=0.03,
        dtype=dtype))
    n = R_true.shape[0]
    E = int(data_full.src.shape[0])
    chunks = [n - 1] + [n] * ((E - (n - 1) + n - 1) // n)
    params_cold = tnt.TNTParams(
        max_iterations=100,
        gradient_tolerance=(1e-9 if dtype == torch.float64 else 2e-3),
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    edge = torch.arange(E, device=dev)

    def solve_snapshot(mask, R0):
        data_t = data_full._replace(kappa=mask.to(dtype))
        res = tnt.solve(rs.make_problem(), R0, params_cold, data=data_t)
        cert = rs.certify(res.x, data_t, rr_method="chol",
                          precondition=True)
        return res, cert

    def solve_all():
        # one cold init, ever: from the first snapshot only (no peeking at
        # future measurements)
        R = rs.spectral_init(data_full._replace(
            kappa=(edge < chunks[0]).to(dtype)), n, d)
        shown, rows = 0, []
        for grow in chunks:
            shown = min(E, shown + grow)
            res, cert = solve_snapshot(edge < shown, R)
            R = res.x
            rows.append(dict(edges=shown, iters=int(res.num_iterations),
                             status=int(res.status), f=float(res.f),
                             certified=bool(cert.certified),
                             lam_min=float(cert.lam_min)))
            if not rows[-1]["certified"]:
                break
        return rows

    rows, wall = C.timed(solve_all, dev)
    return dict(n=n, E=E, snapshots=len(chunks), rows=rows, wall=wall)


def accept(out):
    """The JAX example's check: every snapshot certified."""
    if not all(r["certified"] for r in out["rows"]):
        raise SystemExit("snapshot lost certified optimality")


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    print(f"online rotation sync: n={out['n']}, {out['E']} total edges, "
          f"{out['snapshots']} snapshots (one cold init, warm starts)")
    for t, r in enumerate(out["rows"]):
        print(f"  t={t}: edges={r['edges']:3d}  outer_iters={r['iters']:3d}  "
              f"f*={r['f']:9.4f}  certified={r['certified']!s:5} "
              f"lam_min={r['lam_min']:+.1e}")
    accept(out)
    print("all snapshots certified globally optimal; warm-started "
          "re-solves converged in a handful of outer iterations")
    return out


if __name__ == "__main__":
    main()
