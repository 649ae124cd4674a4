"""LOBPCG smallest-k eigenpairs of a structured SPD operator (counterpart of
``examples/lobpcg_example.py``, BASELINE config 3).

The reference's diagonal spectrum (m = 500, nx = 10, nev = 5), then the
matrix-free 10^5-row operator diag(linspace(1, 1000)) + 1-D Laplacian
stencil, preconditioned by the inverse diagonal (nx = 16, nev = 4).  In
f32 on the card both Gram stages of every iteration run in the
``gram_pair`` kernel: 1 + iterations launches a solve (100,000 x 48 for
the big operator).  Run:  python -m optimization_tpu_torch.examples.lobpcg_example [--device cpu]
"""

from __future__ import annotations

import torch

from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.linalg.lobpcg import lobpcg


def _summary(res, wall):
    return dict(iters=int(res.num_iterations), nc=int(res.num_converged),
                theta=res.theta.tolist(), wall=wall)


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"X0_diag": (500, 10), "X0_big": (100000, 16)}`` start
    blocks (default: drawn from generators seeded 0 and 1, which also draw
    LOBPCG's norm-estimate blocks)."""
    dev = C.device_of(device)
    dtype = dtype or C.default_dtype(dev)
    tau = 1e-6 if dtype == torch.float64 else 1e-4
    kw = dict(dtype=dtype, device=dev)
    out = {}

    # --- reference example: diagonal operator, m = 500 ---
    m = 500
    diag = torch.linspace(1.0, m, m, **kw)
    gen = C.generator(dev, 0)
    X0 = C.take(data, "X0_diag",
                lambda: torch.randn((m, 10), generator=gen, **kw))
    res, wall = C.timed(lambda: lobpcg(
        lambda S: diag[:, None] * S, X0=X0, nev=5, max_iterations=m, tau=tau,
        generator=gen), dev)
    out["diag"] = _summary(res, wall)

    # --- benchmark config: 10^5-dim structured SPD operator, matrix-free ---
    n = 100_000
    spec = torch.linspace(1.0, 1000.0, n, **kw)

    def A_big(S):
        up = torch.cat([S[1:], torch.zeros_like(S[:1])], dim=0)
        down = torch.cat([torch.zeros_like(S[:1]), S[:-1]], dim=0)
        return spec[:, None] * S + (2.0 * S - up - down)

    gen = C.generator(dev, 1)
    X0 = C.take(data, "X0_big",
                lambda: torch.randn((n, 16), generator=gen, **kw))
    res, wall = C.timed(lambda: lobpcg(
        A_big, T=lambda S: S / spec[:, None], X0=X0, nev=4,
        max_iterations=500, tau=tau, generator=gen), dev)
    out["big"] = _summary(res, wall)
    return out


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, dtype = C.setup(args.device)
    out = run(dev, dtype)
    r = out["diag"]
    print(f"[LOBPCG diag-500] iters={r['iters']} nc={r['nc']} "
          f"theta={r['theta']} wall={r['wall']:.2f}s (true: 1..5)")
    r = out["big"]
    print(f"[LOBPCG structured-1e5] iters={r['iters']} nc={r['nc']} "
          f"theta={r['theta']} wall={r['wall']:.2f}s")
    return out


if __name__ == "__main__":
    main()
