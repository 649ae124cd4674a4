"""Fleet certification: solve and globally certify many rotation-sync
instances over one measurement topology (counterpart of
``examples/certification_fleet.py``).

The user story: a mapping / SfM pipeline produces a stream of rotation
synchronization problems over the same topology (one session a day over a
fixed camera rig).  Each instance runs the whole pipeline: spectral init
(LOBPCG, one-eigh chol Rayleigh-Ritz), TNT, and the SE-Sync
global-optimality certificate (LOBPCG on S = L - Lambda, chol).  The port
runs the instances one after the other, an eager pipeline each; it does
not batch them into one solve as the JAX example's ``vmap`` does.  In f32
on the card every LOBPCG Gram stage runs in the ``gram_pair`` kernel.
Raises ``SystemExit`` when an instance is left uncertified.
Run:  python -m optimization_tpu_torch.examples.certification_fleet [--device cpu]
"""

from __future__ import annotations

import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.models import rotation_sync as rs
from optimization_tpu_torch.solvers import tnt


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"fleet": RotationSyncData with Rij (B, E, 3, 3)}``
    (default: B = 8 instances of n = 30 rotations from a generator seeded
    0)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    B, n, d = 8, 30, 3          # fleet of 8 instances, 30 rotations each
    fleet = C.take(data, "fleet", lambda: rs.random_fleet(
        C.generator(dev, 0), B, n, d, extra_edges=2 * n, noise=0.03,
        dtype=dtype)[1])
    B = fleet.Rij.shape[0]
    n = int(torch.max(torch.maximum(fleet.src, fleet.dst))) + 1
    params = tnt.TNTParams(
        max_iterations=100,
        gradient_tolerance=(1e-9 if dtype == torch.float64 else 2e-3),
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)

    def one(Rij):
        data_i = fleet._replace(Rij=Rij)
        R0 = rs.spectral_init(data_i, n, d, rr_method="chol")
        res = tnt.solve(rs.make_problem(), R0, params, data=data_i)
        cert = rs.certify(res.x, data_i, rr_method="chol")
        return dict(f=float(res.f), status=int(res.status),
                    iters=int(res.num_iterations),
                    certified=bool(cert.certified),
                    lam_min=float(cert.lam_min),
                    stationarity=float(cert.stationarity))

    rows, wall = C.timed(lambda: [one(fleet.Rij[b]) for b in range(B)], dev)
    return dict(B=B, n=n, d=d, instances=rows, wall=wall,
                n_cert=sum(r["certified"] for r in rows))


def accept(out):
    """The JAX example's check: every instance certified."""
    if out["n_cert"] != out["B"]:
        raise SystemExit("uncertified instance in a noise-floor fleet")


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    print(f"fleet of {out['B']} instances (n={out['n']} rotations, "
          f"d={out['d']}):")
    for b, r in enumerate(out["instances"]):
        print(f"  [{b}] f* = {r['f']:10.4f}   "
              f"certified = {r['certified']!s:5}   "
              f"lam_min = {r['lam_min']:+9.2e}   "
              f"stationarity = {r['stationarity']:.1e}")
    print(f"{out['n_cert']}/{out['B']} certified globally optimal")
    accept(out)
    return out


if __name__ == "__main__":
    main()
