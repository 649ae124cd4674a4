"""SE(3) pose synchronization from a g2o file, end to end (counterpart of
``examples/pose_graph_g2o.py``).

Pipeline: the C++ g2o loader (the Python parser where no compiler is) ->
SE-Sync chordal / spectral initialization (LOBPCG on the connection
Laplacian) -> Riemannian TNT on SO(3)^n -> translation recovery by
matrix-free LSQR -> the global-optimality certificate.  In f32 on the card
the spectral init and the certificate run their LOBPCG Gram stages in the
``gram_pair`` kernel.

Run:  python -m optimization_tpu_torch.examples.pose_graph_g2o [file.g2o] [--device cpu]
(with no file, a synthetic noisy pose graph is drawn and written to a
temporary g2o file first, so the whole loader path runs).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.io import load_g2o, native_available
from optimization_tpu_torch.io.g2o import rotmat_to_quat
from optimization_tpu_torch.models import pose_sync
from optimization_tpu_torch.models import rotation_sync as rs


def synthesize(dev, dtype, n=64, noise=0.03, seed=0) -> dict:
    """A noisy synthetic SE(3) pose graph in the g2o convention
    (M_e = R_i' R_j, t_e = R_i'(t_j - t_i)): a chain plus 2n random edges."""
    gen = C.generator(dev, seed)
    kw = dict(generator=gen, dtype=dtype, device=dev)
    R_true = rs.ROTATIONS.rand(gen, n, 3, 3, dtype=dtype)
    t_true = 3.0 * torch.randn((n, 3), **kw)
    src = torch.arange(n - 1, device=dev)
    dst = src + 1
    src = torch.cat([src, torch.randint(0, n, (2 * n,), generator=gen,
                                        device=dev)])
    dst = torch.cat([dst, torch.randint(0, n, (2 * n,), generator=gen,
                                        device=dev)])
    Rt = R_true.mT
    Mij = Rt[src] @ R_true[dst]
    tij = (Rt[src] @ (t_true[dst] - t_true[src])[..., None])[..., 0]
    w = noise * torch.randn((src.shape[0], 3, 3), **kw)
    skew = 0.5 * (w - w.mT)
    eye = torch.eye(3, dtype=dtype, device=dev)
    Mij = rs._orthonormalize(eye + skew + 0.5 * (skew @ skew)) @ Mij
    tij = tij + noise * torch.randn(tij.shape, **kw)
    return dict(R_true=R_true, t_true=t_true, src=src, dst=dst, Mij=Mij,
                tij=tij)


def write_g2o(path, src, dst, Mij, tij):
    """EDGE_SE3:QUAT lines with unit information, 12 decimals."""
    info = np.zeros(21)
    info[[0, 6, 11, 15, 18, 20]] = 1.0
    info_s = " ".join(map(str, info))
    src, dst = src.cpu().numpy(), dst.cpu().numpy()
    Mij = Mij.cpu().double().numpy()
    tij = tij.cpu().double().numpy()
    lines = []
    for e in range(src.shape[0]):
        x, y, z, qw = rotmat_to_quat(Mij[e])
        tx, ty, tz = tij[e]
        lines.append(
            f"EDGE_SE3:QUAT {int(src[e])} {int(dst[e])} "
            f"{tx:.12f} {ty:.12f} {tz:.12f} "
            f"{x:.12f} {y:.12f} {z:.12f} {qw:.12f} {info_s}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def solve(path, dev, dtype, truth=None) -> dict:
    g = load_g2o(path)
    out = dict(path=path, n=g.n_vertices, E=len(g.src), dim=g.dim,
               native=native_available())
    res, wall = C.timed(lambda: pose_sync.solve_pose_graph(
        g, dtype=dtype, certify=True, device=dev), dev)
    rr, c = res.rotation_result, res.certificate
    out.update(status=int(rr.status), f=float(rr.f),
               grad_norm=float(rr.gradfx_norm),
               iters=int(rr.num_iterations),
               lsqr_residual=float(res.translation_residual),
               certified=bool(c.certified), lam_min=float(c.lam_min),
               stationarity=float(c.stationarity), wall=wall)
    if truth is not None:
        err_R, err_t = pose_sync.alignment_errors(
            res.R, res.t, truth["R_true"].to(dtype), truth["t_true"].to(dtype))
        out.update(err_R=float(err_R), err_t=float(err_t))
    return out


def run(device, dtype=None, data=None, path=None) -> dict:
    """Solve the g2o file at ``path``, or (``path=None``) a synthetic graph
    written to a temporary file: ``data`` is ``{"graph": {"R_true",
    "t_true", "src", "dst", "Mij", "tij"}}`` (default: :func:`synthesize`,
    n = 64 from a generator seeded 0)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    if path is not None:
        return solve(path, dev, dtype)
    truth = C.take(data, "graph", lambda: synthesize(dev, dtype))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.g2o")
        write_g2o(path, truth["src"], truth["dst"], truth["Mij"],
                  truth["tij"])
        out = solve(path, dev, dtype, truth)
    out["synthesized"] = True
    return out


def main(argv=None) -> dict:
    p = C.parser(__doc__)
    p.add_argument("graph", nargs="?", default=None,
                   help="a .g2o file (default: a synthetic graph)")
    args = p.parse_args(argv)
    dev, dtype = C.setup(args.device)
    r = run(dev, dtype, path=args.graph)
    if r.get("synthesized"):
        print(f"synthesized pose graph -> {r['path']} (a temporary file)")
    print(f"loaded {r['path']}: {r['n']} poses, {r['E']} edges, "
          f"SE({r['dim']}), native parser: {r['native']}")
    print(f"rotations: status={r['status']} f={r['f']:.6e} "
          f"|grad|={r['grad_norm']:.3e} iters={r['iters']}")
    print(f"translations: LSQR residual={r['lsqr_residual']:.3e}")
    print(f"certificate: certified={r['certified']} "
          f"lam_min={r['lam_min']:.3e} "
          f"stationarity={r['stationarity']:.2e}")
    if "err_R" in r:
        print(f"gauge-aligned errors: rotations {r['err_R']:.4f}, "
              f"translations (max) {r['err_t']:.4f}")
    return r


if __name__ == "__main__":
    main()
