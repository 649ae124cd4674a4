"""A fixture system: SO(3) synchronization through the port's TNT, a fresh
instance each solve.  No cell of ``BENCHMARK.json`` names it.

The CPU tests give it a configuration, a mix and a cell in a temporary
benchmark root, and run that cell through ``bench.measure`` and
``control.readings``: a solve whose input is a measurement set, and not a
point on the sphere, fits the harness with new files alone.

The input of a solve (``draw``): ``rotation_sync.random_instance`` in SO(3)
at the mix's ``vertices``, ``extra_edges`` and ``noise``, drawn on the
device from
the draw's own generator, with the start its odometry gives (R_0 = I,
R_{i+1} = R~_{i,i+1}' R_i along the spanning path).  The program is
``tnt.solve`` on ``rotation_sync.make_problem()`` (the chordal cost) in
f32.

The judge holds each sampled answer against a float64 Gauss-Newton solve
of the redrawn instance from the same start, written here in plain torch
(:func:`reference_solve`), by two numbers:

- ``rotations``: the largest |R_i - Q_i G|_F, Q the reference's answer and
  G in SO(3) the rotation that aligns Q to R best (the cost is blind to a
  common rotation);
- ``cost``: the program's stated cost against the reference's, relative.

The control is the reference on the instance stored in bfloat16.
"""

from __future__ import annotations

import torch

from .. import traffic

NUMBERS = ("rotations", "cost")
KERNELS = ()
TEST_MIX = {"vertices": 64, "extra_edges": 128, "noise": 0.05,
            "warmup_solves": 1, "check_solves": 2, "check_within": 2,
            "sync_solves": 1}
TEST_OVERRIDES = {}
MIX_KEYS = {"vertices": (int, 2), "extra_edges": (int, 0),
            "noise": (float, 0.0)}


def check_mix(mix: dict) -> None:
    for key, (kind, least) in MIX_KEYS.items():
        if not isinstance(mix.get(key), kind) or mix[key] < least:
            raise ValueError(f"an SO(3) mix states {key} as a {kind.__name__}"
                             f" >= {least}, not {mix.get(key)!r}")


def draw(config: dict, mix: dict, seed: int, stream: int, index: int,
         device):
    """(start, instance) of one solve, from its own generator."""
    from optimization_tpu_torch.models import rotation_sync

    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.draw_seed(seed, stream, index))
    n = mix["vertices"]
    _, data = rotation_sync.random_instance(
        gen, n, 3, extra_edges=mix["extra_edges"], noise=mix["noise"])
    return odometry(data.Rij[:n - 1]), data


def odometry(Rij: torch.Tensor) -> torch.Tensor:
    """R_0 = I, R_{i+1} = Rij[i]' R_i."""
    R = [torch.eye(3, dtype=Rij.dtype, device=Rij.device)]
    for M in Rij:
        R.append(M.mT @ R[-1])
    return torch.stack(R)


class System:
    """The port's TNT on the chordal cost of one instance."""

    def __init__(self, config: dict, mix: dict, device, engine: str = None):
        from optimization_tpu_torch.models import rotation_sync
        from optimization_tpu_torch.solvers import tnt

        self.n = mix["vertices"]
        self._tnt = tnt
        self.problem = rotation_sync.make_problem()
        self.params = tnt.TNTParams(
            max_iterations=config["max_iterations"],
            gradient_tolerance=config["gradient_tolerance"],
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)

    def solve(self, inp):
        R0, data = inp
        return self._tnt.solve(self.problem, R0, self.params, data=data)

    def solve_recorded(self, inp):
        return (self.solve(inp),)

    def recording_bytes(self, solves: int) -> int:
        return self.n * 9 * 4 * solves

    @staticmethod
    def counters(res) -> tuple:
        return (res.num_iterations, res.inner_iterations, res.status, res.f)

    @staticmethod
    def read_counters(c: tuple) -> dict:
        outer = int(c[0])
        return {"outer": outer, "inner": [int(v) for v in c[1][:outer]],
                "status": int(c[2]), "f": float(c[3])}

    @staticmethod
    def trail(recorded):
        """(answer, stated cost)."""
        res = recorded[0]
        return res.x, float(res.f)


# ---- the plain reference: float64, nothing of the program ----

def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the (..., 3, 3) skew matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _cost(R, src, dst, Rij) -> float:
    return float(torch.sum((R[src] - Rij @ R[dst]) ** 2))


def reference_solve(R0, data, storage=torch.float64, iterations=50):
    """Gauss-Newton on sum_e |R_i - R~_e R_j|_F^2 over SO(3)^n from R0, in
    float64, R_0 held (the gauge), halving a step that raises the cost.
    ``storage`` rounds the instance and the start first.  Returns (answer,
    cost)."""
    def st(t):
        return t.to(storage).to(torch.float64)

    src, dst, Rij = data.src, data.dst, st(data.Rij)
    R = st(R0)
    n, E = R.shape[0], src.numel()
    gens = _hat(torch.eye(3, dtype=torch.float64, device=R.device))
    e = torch.arange(E, device=R.device)
    f = _cost(R, src, dst, Rij)
    for _ in range(iterations):
        r = (R[src] - Rij @ R[dst]).reshape(E, 9)
        J = torch.zeros(E, 9, n, 3, dtype=torch.float64, device=R.device)
        # d r_e / d w_i,a = R_i hat(e_a);  d r_e / d w_j,a = -R~_e R_j hat(e_a)
        J[e, :, src, :] += (R[src][:, None] @ gens).reshape(E, 3, 9).mT
        J[e, :, dst, :] -= ((Rij @ R[dst])[:, None] @ gens).reshape(
            E, 3, 9).mT
        J = J.reshape(E * 9, n * 3)[:, 3:]
        g = J.mT @ r.reshape(-1)
        if float(torch.linalg.vector_norm(g)) < 1e-13 * max(f, 1.0):
            break
        w = torch.linalg.solve(J.mT @ J, -g)
        w = torch.cat([w.new_zeros(3), w]).reshape(n, 3)
        for _ in range(30):
            R_new = R @ torch.linalg.matrix_exp(_hat(w))
            f_new = _cost(R_new, src, dst, Rij)
            if f_new <= f:
                break
            w = 0.5 * w
        else:
            break
        R, f = R_new, f_new
    return R, f


def _aligned_gap(R, Q) -> float:
    """max_i |R_i - Q_i G|_F with G = argmin_{SO(3)} sum_i |R_i - Q_i G|^2."""
    R = R.to(torch.float64)
    U, _, Vh = torch.linalg.svd(torch.sum(Q.mT @ R, 0))
    D = torch.ones(3, dtype=torch.float64, device=R.device)
    D[2] = torch.sign(torch.linalg.det(U @ Vh))
    G = (U * D) @ Vh
    return float(torch.linalg.matrix_norm(R - Q @ G).max())


def judge(config: dict, mix: dict, samples, input_of, device) -> dict:
    """Worst readings over ``samples`` [(index, (answer, cost))], each held
    against the reference's solve of the redrawn ``input_of(index)``."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for index, (R, f) in samples:
        Q, f_ref = reference_solve(*input_of(index))
        got = {"rotations": _aligned_gap(R, Q),
               "cost": abs(f - f_ref) / f_ref}
        for k, v in got.items():
            worst[k] = max(worst[k], v) if v == v else float("inf")
    return worst


def control(config: dict, mix: dict, inp):
    """The reference with the instance and the start stored in bfloat16."""
    return reference_solve(*inp, storage=torch.bfloat16)
