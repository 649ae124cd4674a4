"""Range-aided pose synchronization (counterpart of
``examples/range_aided.py``; ``models/range_sync.py``).

A spanning chain of noisy SE(3) odometry edges gives a translation
estimate that drifts; adding range measurements (distance only, no
bearing) and jointly refining poses and unit range bearings with one
Riemannian TNT solve on SO(3)^n x R^(3n) x (S^2)^K recovers most of the
lost accuracy.  Every derivative is automatic.  The solves run in f32, the
function's default (as in JAX); the pose-only contrast sets the range
weights rho to 0.  In f32 on the card each spectral init runs its LOBPCG
Gram stages in the ``gram_pair`` kernel; the automatic Hessian-vector
product is eager torch.
Run:  python -m optimization_tpu_torch.examples.range_aided [--device cpu]
"""

from __future__ import annotations

import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.models import range_sync as rg
from optimization_tpu_torch.models.pose_sync import alignment_errors


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"instance": (R_true, t_true, RangeSyncData)}``
    (default: n = 30 poses, 60 ranges from a generator seeded 3)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    n, n_ranges = 30, 60
    R_true, t_true, rdata = C.take(data, "instance", lambda: rg.random_instance(
        C.generator(dev, 3), n, 3, extra_edges=0, n_ranges=n_ranges,
        noise=0.05, range_noise=0.001, dtype=dtype))
    n = R_true.shape[0]
    t_ref = t_true - t_true[0][None]

    out, wall = C.timed(lambda: rg.solve_range_aided(rdata, n), dev)
    rot_err, t_err = alignment_errors(out.R, out.t, R_true, t_ref)
    res = out.result
    ranged = C.summary(res, wall, grad_norm=float(res.gradfx_norm),
                       rot_err=float(rot_err), t_err=float(t_err))

    data0 = rdata._replace(rho=torch.zeros_like(rdata.dists))
    out0, wall = C.timed(lambda: rg.solve_range_aided(data0, n), dev)
    _, t_err0 = alignment_errors(out0.R, out0.t, R_true, t_ref)
    pose_only = C.summary(out0.result, wall, t_err=float(t_err0))
    return {"ranged": ranged, "pose_only": pose_only}


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    r, r0 = out["ranged"], out["pose_only"]
    print(f"range-aided: {r['iters']} TNT iters, f = {r['f']:.3e}, "
          f"|g| = {r['grad_norm']:.2e}, rot_err {r['rot_err']:.4f}, "
          f"max t_err {r['t_err']:.4f} [{r['wall']:.2f}s]")
    print(f"pose-only  : max t_err {r0['t_err']:.4f}  "
          f"(ranges tighten translations {r0['t_err'] / r['t_err']:.1f}x "
          f"on this chain) [{r0['wall']:.2f}s]")
    return out


if __name__ == "__main__":
    main()
