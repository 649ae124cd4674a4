"""Outlier-robust SE(3) pose synchronization, Geman-McClure GNC
(counterpart of ``examples/robust_pose_graph.py``).

Draws a pose graph with 20% corrupted edges (half full SE(3) outliers, a
random rotation and offset; half translation-only outliers, the channel a
rotation-only robust solver cannot see) and recovers the poses with
``pose_sync.solve_robust_se``: graduated non-convexity over the
translation-marginalized SE-Sync objective, reweighting both information
channels of every edge.  The non-robust marginalized solve (f32, the
function's default, as in JAX) is the contrast.  In f32 on the card every
spectral init runs its LOBPCG Gram stages in the ``gram_pair`` kernel.
Run:  python -m optimization_tpu_torch.examples.robust_pose_graph [--device cpu]
"""

from __future__ import annotations

import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.io.g2o import PoseGraph
from optimization_tpu_torch.models import pose_sync
from optimization_tpu_torch.models import rotation_sync as rs


def synthesize(dev, dtype, n=80, noise=0.01, outlier_frac=0.2,
               seed=7) -> dict:
    gen = C.generator(dev, seed)
    kw = dict(generator=gen, dtype=dtype, device=dev)
    R_true = rs.ROTATIONS.rand(gen, n, 3, 3, dtype=dtype)
    t_true = 2.0 * torch.randn((n, 3), **kw)
    rnd = lambda: torch.randint(0, n, (4 * n,), generator=gen, device=dev)
    src = torch.cat([torch.arange(n - 1, device=dev), rnd()])
    dst = torch.cat([torch.arange(1, n, device=dev), rnd()])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    E = int(src.shape[0])

    Rt = R_true.mT
    Mij = Rt[src] @ R_true[dst]
    tij = (Rt[src] @ (t_true[dst] - t_true[src])[..., None])[..., 0]
    w = noise * torch.randn((E, 3, 3), **kw)
    skew = 0.5 * (w - w.mT)
    eye = torch.eye(3, dtype=dtype, device=dev)
    Mij = rs._orthonormalize(eye + skew + 0.5 * (skew @ skew)) @ Mij
    tij = tij + noise * torch.randn((E, 3), **kw)

    n_out = int(outlier_frac * E)
    out_idx = torch.randperm(E, generator=gen, device=dev)[:n_out]
    full = out_idx[: n_out // 2]
    Mij[full] = rs.ROTATIONS.rand(gen, len(full), 3, 3, dtype=dtype)
    tij[out_idx] = 10.0 * torch.randn((n_out, 3), **kw)
    return dict(R_true=R_true, t_true=t_true, src=src, dst=dst, Mij=Mij,
                tij=tij, out_idx=out_idx, full=full)


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"graph": {"R_true", "t_true", "src", "dst", "Mij",
    "tij", "out_idx", "full"}}`` (default: :func:`synthesize`, n = 80 from
    a generator seeded 7)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    s = C.take(data, "graph", lambda: synthesize(dev, dtype))
    n, E = int(s["R_true"].shape[0]), int(s["src"].shape[0])
    f64 = lambda a: a.to(torch.float64)

    # non-robust baseline: dragged far off by the 10-sigma offsets
    g = PoseGraph(n_vertices=n, dim=3, src=s["src"], dst=s["dst"],
                  Rij=s["Mij"], tij=s["tij"], kappa=None)
    plain, wall_plain = C.timed(lambda: pose_sync.solve_pose_graph(
        g, marginalized=True, device=dev), dev)
    pr, pt = pose_sync.alignment_errors(f64(plain.R), f64(plain.t),
                                        s["R_true"], s["t_true"])

    rob, wall = C.timed(lambda: pose_sync.solve_robust_se(
        s["src"], s["dst"], s["Mij"], s["tij"], n), dev)
    rr, tt = pose_sync.alignment_errors(f64(rob.R), f64(rob.t), s["R_true"],
                                        s["t_true"])
    inl = torch.ones(E, dtype=torch.bool, device=dev)
    inl[s["out_idx"]] = False
    w_tr = rob.w_tr
    return dict(n=n, E=E, n_out=len(s["out_idx"]), n_full=len(s["full"]),
                plain_rot_err=float(pr), plain_t_err=float(pt),
                plain_status=int(plain.rotation_result.status),
                plain_wall=wall_plain, rot_err=float(rr), t_err=float(tt),
                status=int(rob.result.status),
                w_out_max=float(w_tr[s["out_idx"]].max()),
                w_in_median=float(rs._median(w_tr[inl])), wall=wall)


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    print("== robust SE(3) pose synchronization (GM-GNC, marginalized) ==")
    r = run(dev, dtype)
    print(f"n={r['n']} poses, E={r['E']} edges, {r['n_out']} corrupted "
          f"({r['n_full']} full SE(3), {r['n_out'] - r['n_full']} "
          f"translation-only)")
    print(f"non-robust marginalized solve: rot_err={r['plain_rot_err']:.4f} "
          f"t_err={r['plain_t_err']:.3f}")
    print(f"GNC robust solve:              rot_err={r['rot_err']:.4f} "
          f"t_err={r['t_err']:.3f}  (noise floor 0.01)")
    print(f"weights: max over corrupted edges = {r['w_out_max']:.4f}, "
          f"median over inliers = {r['w_in_median']:.3f}")
    return r


if __name__ == "__main__":
    main()
