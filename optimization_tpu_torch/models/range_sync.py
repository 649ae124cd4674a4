"""Range-aided pose synchronization (CORA-style unit-vector relaxation).

Counterpart of ``optimization_tpu/models/range_sync.py``.  Pose-graph SLAM
with auxiliary **range** measurements: on top of the SE(d) relative-pose
edges, each range edge k = (i, j) observes only the distance d_k between
t_i and t_j.  One unit vector u_k per range edge makes the problem

    f(R, t, u) = sum_e  kappa_e |R_j - R_i Rtilde_e|_F^2
               + sum_e  tau_e   |t_j - t_i - R_i ttilde_e|^2
               + sum_k  rho_k   |t_j - t_i - d_k u_k|^2 ,

quadratic in (R, t, u) jointly; at the per-k optimum u_k = (t_j - t_i) /
|t_j - t_i| it is the original range cost.  The user writes only the
objective: the variable is the tuple ``(R, t, u)`` on the product manifold
SO(d)^n x R^{n d} x (S^{d-1})^m, the Riemannian gradient is
``torch.func.grad`` plus projection and the Hessian-vector product is
``torch.func.jvp`` of the gradient field (``RiemannianProblem``'s
defaults), and the solver is the stock TNT trust region.  Results are
reported after the anchor gauge t[anchor] = 0; compare with the truth
through ``pose_sync.alignment_errors``.  As in the JAX module, the
certificate covers the rotation stage only and the joint refinement is a
local solve.

What differs from the JAX module:

- ``key=`` is ``generator=`` (a ``torch.Generator``); ``random_instance``
  seeds its numpy RNG (the graph's topology) from the generator where JAX
  draws ``jax.random.randint``, and draws the pose and range noise from
  the generator one after another (JAX reuses one key for the rotation
  and the translation noise).
- ``random_instance`` makes its data on the card unless ``device="cpu"``
  is asked for; the other functions run on the device of the data.
- The objective sums its small batched products elementwise in at least
  f32 (JAX's ``Precision.HIGHEST`` einsums): no TF32, whatever
  ``torch.backends.cuda.matmul.allow_tf32`` says.
- Indices are int64 on the data's device; ``None`` weights are ones in the
  working dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.problem import RiemannianProblem
from ..kernels.segment_sum import planned_gather
from ..manifolds import euclidean, product, rotations, sphere
from ..solvers import tnt
from . import pose_sync as ps
from . import rotation_sync as rs
from .graph import _index

__all__ = ["RangeSyncData", "RangeSyncResult", "make_problem",
           "initial_guess", "solve_range_aided", "random_instance"]


class RangeSyncData(NamedTuple):
    """Pose edges (src -> dst: Rij, tij, weights kappa/tau) plus range
    edges (rsrc -> rdst: dists, weights rho)."""

    src: torch.Tensor       # (E,) int64
    dst: torch.Tensor       # (E,)
    Rij: torch.Tensor       # (E, d, d) relative rotations
    tij: torch.Tensor       # (E, d) relative translations (frame of src)
    rsrc: torch.Tensor      # (K,) int64
    rdst: torch.Tensor      # (K,)
    dists: torch.Tensor     # (K,) measured ranges
    kappa: Optional[torch.Tensor] = None   # (E,) rotation weights
    tau: Optional[torch.Tensor] = None     # (E,) translation weights
    rho: Optional[torch.Tensor] = None     # (K,) range weights


class RangeSyncResult(NamedTuple):
    R: torch.Tensor         # (n, d, d)
    t: torch.Tensor         # (n, d)
    u: torch.Tensor         # (K, d) unit range bearings
    result: tnt.TNTResult   # the joint TNT solve


def _weights(data: RangeSyncData, dtype):
    E, K = data.src.shape[0], data.rsrc.shape[0]
    dev = data.dists.device
    one = lambda w, m: (torch.ones((m,), dtype=dtype, device=dev)
                        if w is None else w.to(dtype))
    return one(data.kappa, E), one(data.tau, E), one(data.rho, K)


def make_problem(data: RangeSyncData) -> RiemannianProblem:
    """The joint problem over ``x = (R, t, u)``: objective only, every
    derivative automatic (module docstring)."""
    M = product((rotations(), euclidean(), sphere()))
    dev = data.dists.device
    src, dst = _index(data.src, dev), _index(data.dst, dev)
    rsrc, rdst = _index(data.rsrc, dev), _index(data.rdst, dev)

    def f(x, dd):
        R, t, u = x
        dt = torch.promote_types(R.dtype, torch.float32)
        R, t, u = R.to(dt), t.to(dt), u.to(dt)
        kap, tau, rho = _weights(data, dt)
        Rij, tij, dists = data.Rij.to(dt), data.tij.to(dt), data.dists.to(dt)

        Rs, Rd = planned_gather(R, (src, dst))
        # R_i Rtilde_e and R_i ttilde_e, summed elementwise (no TF32)
        pred = torch.sum(Rs[:, :, :, None] * Rij[:, None, :, :], dim=2)
        fr = torch.sum(kap * torch.sum((Rd - pred) ** 2, dim=(1, 2)))
        tpred = torch.sum(Rs * tij[:, None, :], dim=2)
        # t in four single gathers: its gradient's four terms then add in
        # the order of plain indexing's pullbacks
        ft = torch.sum(tau * torch.sum((planned_gather(t, dst)
                                        - planned_gather(t, src) - tpred) ** 2,
                                       dim=1))
        dr_k = planned_gather(t, rdst) - planned_gather(t, rsrc)
        fu = torch.sum(rho * torch.sum((dr_k - dists[:, None] * u) ** 2,
                                       dim=1))
        return fr + ft + fu

    return RiemannianProblem(f=f, manifold=M)


def initial_guess(data: RangeSyncData, n: int, *,
                  generator: Optional[torch.Generator] = None,
                  dtype=torch.float32):
    """(R0, t0, u0): chordal spectral init for rotations
    (``rotation_sync.spectral_init``), LSQR translation recovery given R0
    (``pose_sync.recover_translations``), and bearings from the recovered
    translation differences, with random unit rows from ``generator``
    (default: seeded 0 on the data's device) where a difference is
    degenerate."""
    d = data.Rij.shape[-1]
    dev = data.Rij.device
    gen = rs._generator(generator, dev)
    rot_data = ps._transposed_rotation_data(data.src, data.dst, data.Rij,
                                            data.kappa)
    Q0 = rs.spectral_init(rot_data, n, d, generator=gen)
    R0 = Q0.mT.to(dtype)
    t0, _ = ps.recover_translations(R0, data.src, data.dst,
                                    data.tij.to(dtype), weights=data.tau)
    rsrc, rdst = _index(data.rsrc, dev), _index(data.rdst, dev)
    t0_src, t0_dst = planned_gather(t0, (rsrc, rdst))
    diff = t0_dst - t0_src
    nrm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    rnd = sphere().rand(gen, diff.shape[0], d, dtype=dtype, device=dev)
    u0 = torch.where(nrm > 1e-6, diff / torch.clamp(nrm, min=1e-30), rnd)
    return R0, t0.to(dtype), u0.to(dtype)


def solve_range_aided(data: RangeSyncData, n: int, *,
                      params: Optional[tnt.TNTParams] = None,
                      generator: Optional[torch.Generator] = None,
                      anchor: int = 0,
                      dtype=torch.float32) -> RangeSyncResult:
    """Initialize (rotations spectral, translations LSQR, bearings from
    the recovered geometry) and jointly refine with one Riemannian TNT
    solve on the product manifold, on the data's device.  The default
    params are JAX's: 100 outer iterations, gradient tolerance 1e-3 in f32
    and 1e-9 otherwise.  t is re-anchored so that t[anchor] = 0."""
    problem = make_problem(data)
    x0 = initial_guess(data, n, generator=generator, dtype=dtype)
    if params is None:
        f32 = dtype == torch.float32
        params = tnt.TNTParams(
            max_iterations=100, gradient_tolerance=(1e-3 if f32 else 1e-9),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)
    res = tnt.solve(problem, x0, params)
    R, t, u = res.x
    t = t - t[anchor][None, :]
    return RangeSyncResult(R=R, t=t, u=u, result=res)


def random_instance(generator: Optional[torch.Generator], n: int,
                    d: int = 3, *, extra_edges: int = 0, n_ranges: int = 0,
                    noise: float = 0.0, range_noise: float = 0.0,
                    box: float = 10.0, dtype=torch.float32, device=None):
    """Synthetic instance: a spanning path of pose edges (+ ``extra_edges``
    random ones) over ground-truth poses in a ``box``-sized world, plus
    ``n_ranges`` random range edges (self-loops dropped).  Drawn from
    ``generator`` (truth, the topology's numpy seed, rotation noise,
    translation noise, range noise) on its device, and placed on
    ``device`` (default: the generator's; with no generator, one seeded 0
    on the card).  Returns ``(R_true, t_true, RangeSyncData)``."""
    gen = rs._generator(generator, device)
    gdev = gen.device
    out = gdev if device is None else torch.device(device)
    R_true = rs.ROTATIONS.rand(gen, n, d, d, dtype=dtype)
    t_true = box * torch.rand((n, d), generator=gen, dtype=dtype,
                              device=gdev)

    # 2**31 - 1: the seed range JAX draws from
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gdev))
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, extra_edges)])
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, extra_edges)])
    keep = src != dst
    src = torch.as_tensor(src[keep], dtype=torch.int64, device=gdev)
    dst = torch.as_tensor(dst[keep], dtype=torch.int64, device=gdev)

    # noisy relative measurements in the src frame
    E = src.shape[0]
    eye = torch.eye(d, dtype=dtype, device=gdev).expand(E, d, d)
    Rn = rs.ROTATIONS.retract(
        eye, noise * torch.randn((E, d, d), generator=gen, dtype=dtype,
                                 device=gdev))
    Rt_src = R_true[src].mT
    Rij = Rt_src @ (Rn @ R_true[dst])
    tij = (Rt_src @ (t_true[dst] - t_true[src])[..., None])[..., 0]
    tij = tij + noise * torch.randn(tij.shape, generator=gen, dtype=dtype,
                                    device=gdev)

    rr = rng.integers(0, n, (2, max(n_ranges, 0)))
    keep_r = rr[0] != rr[1]
    rsrc = torch.as_tensor(rr[0][keep_r], dtype=torch.int64, device=gdev)
    rdst = torch.as_tensor(rr[1][keep_r], dtype=torch.int64, device=gdev)
    dists = torch.linalg.vector_norm(t_true[rdst] - t_true[rsrc], dim=-1)
    dists = torch.clamp(
        dists + range_noise * torch.randn(dists.shape, generator=gen,
                                          dtype=dtype, device=gdev),
        min=1e-3)

    to = lambda a: a.to(out)
    return to(R_true), to(t_true), RangeSyncData(
        src=to(src), dst=to(dst), Rij=to(Rij), tij=to(tij),
        rsrc=to(rsrc), rdst=to(rdst), dists=to(dists))
