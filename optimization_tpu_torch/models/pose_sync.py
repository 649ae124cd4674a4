"""SE(d) pose synchronization, the full SE-Sync pipeline (counterpart of
``optimization_tpu/models/pose_sync.py``).

The model composes the port's pieces into the pipeline for g2o pose
graphs:

1. **Rotation stage**: chordal/spectral initialization (LOBPCG on the
   connection Laplacian, its Gram stage in the ``gram_pair`` kernel for
   f32) and Riemannian TNT on SO(d)^n (``models/rotation_sync.py``), or the
   single-stage objective with the translations marginalized out
   (:func:`marginalized_problem`), or the Riemannian staircase.
2. **Translation stage**: with the rotations fixed, a sparse linear least
   squares problem solved matrix-free by the port's LSQR over the graph
   incidence operator (:func:`recover_translations`).

**Measurement convention.**  A g2o edge (i, j) stores the pose of j in the
frame of i:  ``M_e ~= R_i' R_j`` and ``t_e ~= R_i' (t_j - t_i)``.  The
chordal model measures ``R_i R_j'``; the two agree exactly in the
transposed variables Q_k = R_k':

    |R_j - R_i M_e|_F  =  |Q_j - M_e' Q_i|_F,

i.e. rotation sync over edges (src=j, dst=i) with measurements M_e', then
R = Q'.

What differs from the JAX module:

- ``key=`` is ``generator=`` (a ``torch.Generator``), and the entry points
  that take a graph take ``device=`` (default ``"cuda"``; there is no CPU
  fallback: without a card they raise unless asked for ``"cpu"``).  The
  other functions run on the device of the tensors they are given.
- Indices are int64 on the data's device; products are ``torch.matmul``
  in the data's dtype (nothing here turns TF32 on).
- The inner loops are eager Python loops that read one stopping flag back
  to the host per iteration: the Jacobi-PCG of the weighted Laplacian (one
  per objective, gradient and Hessian-vector product of the marginalized
  problem), LSQR, and, in the flat engine, one read per group of s
  iterations.  ``with_iters`` counts are Python ints.
- ``jnp.median`` averages the two middle values of an even count;
  ``rotation_sync._median`` matches it (``torch.median`` does not).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..core.problem import RiemannianProblem
from ..linalg.lsqr import lsqr
from ..solvers import tnt
from . import rotation_sync as rs
from .graph import _index, edge_accumulator, laplacian_apply

__all__ = ["PoseSyncResult", "solve_pose_graph", "recover_translations",
           "marginalized_problem", "solve_robust_se", "RobustSEResult",
           "gnc_identifiability", "alignment_errors"]


class PoseSyncResult(NamedTuple):
    R: torch.Tensor           # (n, d, d) world-frame rotations
    t: torch.Tensor           # (n, d) world-frame translations (anchor at 0)
    rotation_result: Any      # TNTResult of the rotation stage
    translation_residual: torch.Tensor  # |A t - b| of the recovery LS
    certificate: Any = None   # rotation_sync.CertificateResult when asked


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the pose-graph entry points run "
                           "on the card unless given device='cpu'")
    return dev


def _tensor(a, dtype, device) -> torch.Tensor:
    """An array (numpy or tensor) as ``dtype`` on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _transposed_rotation_data(src, dst, Mij, kappa=None):
    """g2o-convention measurements -> the chordal model in transposed
    variables (indices as int64 on ``Mij``'s device)."""
    dev = Mij.device
    return rs.RotationSyncData(src=_index(dst, dev), dst=_index(src, dev),
                               Rij=Mij.mT, kappa=kappa)


def _default_params(dtype, max_iterations):
    f32 = dtype == torch.float32
    return tnt.TNTParams(
        max_iterations=max_iterations,
        gradient_tolerance=(2e-3 if f32 else 1e-8),
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)


def solve_rotations_g2o(src, dst, Mij, n: int, kappa=None,
                        params: Optional[tnt.TNTParams] = None,
                        generator: Optional[torch.Generator] = None) -> tuple:
    """Rotation stage for g2o-convention measurements M_e ~= R_i' R_j, on
    ``Mij``'s device.  Returns ``(R, tnt_result)`` with R of shape
    (n, d, d)."""
    d = Mij.shape[-1]
    data = _transposed_rotation_data(src, dst, Mij, kappa)
    Q0 = rs.spectral_init(data, n, d, generator=generator).to(Mij.dtype)
    if params is None:
        params = _default_params(Mij.dtype, 100)
    res = tnt.solve(rs.make_problem(), Q0, params, data=data)
    return res.x.mT, res


def recover_translations(R, src, dst, tij, weights=None, *, anchor: int = 0,
                         max_iterations: int = 2000, btol: float = 1e-8,
                         Atol: float = 1e-8, scatter_method="scatter"):
    """Translation recovery: min_t sum_e w_e |t_j - t_i - R_i t_e|^2, on
    ``R``'s device.

    Solved matrix-free by LSQR over the weighted incidence operator (one
    gather and one accumulation per product; no matrix is formed).  The
    global-translation gauge is fixed by re-anchoring t[anchor] = 0.
    ``scatter_method`` picks the A' accumulation (``graph.edge_accumulator``;
    ``"adjacency"`` takes its gather form).  Returns ``(t, residual_norm)``.
    """
    n = R.shape[0]
    dt, dev = R.dtype, R.device
    src, dst = _index(src, dev), _index(dst, dev)
    acc = edge_accumulator(
        src, dst, n,
        method=("gather" if scatter_method == "adjacency"
                else scatter_method))
    w = (torch.sqrt(_tensor(weights, dt, dev))[:, None]
         if weights is not None
         else torch.ones((src.shape[0], 1), dtype=dt, device=dev))

    # b_e = R_i t_e rotated into the world frame, weighted
    b = w * torch.matmul(R[src], _tensor(tij, dt, dev)[:, :, None])[..., 0]

    def A(t):
        return w * (t[dst] - t[src])

    def At(r):
        rw = w * r
        return acc(-rw, rw)

    inner = lambda u, v: torch.sum(u * v)
    res = lsqr(A, At, b, inner, inner, max_iterations=max_iterations,
               btol=btol, Atol=Atol)
    t = res.x - res.x[anchor][None, :]
    r = A(t) - b
    return t, torch.sqrt(torch.sum(r * r))


def _weighted_laplacian_solver(src, dst, tau, n, *, max_iterations=400,
                               rtol=None, jacobi=True, with_iters=False,
                               engine="cg", s_steps=2,
                               scatter_method="scatter"):
    """Matrix-free (P)CG solve of the weighted graph Laplacian L_tau z = r
    (L_tau = A' diag(tau) A, A the edge incidence), columnwise on (n, k)
    right-hand sides, on ``tau``'s device.  Consistent singular systems
    (columns of r summing to zero) stay in range(L_tau) when started at
    zero, so CG returns the minimum-norm solution.

    ``jacobi=True`` preconditions with the Laplacian diagonal (the weighted
    vertex degree).

    ``engine="cg"`` (default) is the Jacobi-PCG loop with the preconditioned
    residual re-projected onto range(L) every iteration (its mean removed)
    and a curvature guard: the loop stops when <p, L p> or <r, M r> turns
    non-positive (round-off at the attainable residual).  One host read per
    iteration (the stopping test).

    ``engine="flat"`` runs the s-step engine (``linalg/flat_cg.py``,
    ``solve_mode``, ``s_steps``) on the symmetrically Jacobi-transformed
    system Lt = D^-1/2 L D^-1/2, all k columns stacked into one flat system
    with one joint truncation target, and Lt's null direction
    e = D^1/2 1 / |D^1/2 1| grounded through the engine's low-rank term:
    (Lt + sum_c e_c e_c') y = rt with rt projected onto range(Lt) once.
    One host read per group of s iterations.  The JAX package's record of
    this engine (slower than ``"cg"`` wherever it was tried) is a TPU
    measurement; the port's card time is in ``PERF.md``.

    ``rtol`` defaults to ``50 * eps(dtype)``: CG pushed past its attainable
    residual in f32 loses orthogonality and corrupts the marginalized
    objective, so the tolerance tracks the dtype.

    ``with_iters=True`` makes the solve return ``(z, k)`` with k the
    iteration count (a Python int).

    ``scatter_method`` selects the L-apply (``graph.laplacian_apply``:
    ``"scatter"``, ``"gather"``, ``"sort"`` or ``"adjacency"``).  On the
    card ``"scatter"`` sums with atomics, in an order that varies from run
    to run.
    """
    L = laplacian_apply(src, dst, tau, n, method=scatter_method)
    dev = tau.device
    src_t, dst_t = _index(src, dev), _index(dst, dev)
    deg = tau.new_zeros((n,)).index_add(0, src_t, tau).index_add(0, dst_t,
                                                                   tau)
    tiny = torch.finfo(tau.dtype).tiny
    inv_deg = 1.0 / torch.clamp(deg, min=tiny)

    if engine == "flat":
        from ..linalg.flat_cg import stpcg_flat

        dsq = (torch.sqrt(torch.clamp(deg, min=tiny)) if jacobi
               else torch.ones_like(deg))
        inv_dsq = 1.0 / dsq
        e = dsq / torch.sqrt(torch.sum(dsq * dsq))

        def solve_flat(r):
            """All k columns as ONE flat (n*k,) system with one joint
            truncation target over the stacked residual; each column gets
            its own grounding vector through the engine's U B U' term."""
            tol = (50.0 * torch.finfo(r.dtype).eps if rtol is None else rtol)
            k = r.shape[-1]
            rt = inv_dsq[:, None] * r
            rt = rt - e[:, None] * (e @ rt)     # into range(Lt), once

            def A0(v):
                z = inv_dsq[:, None] * v.reshape(-1, k)
                return (inv_dsq[:, None] * L(z)).reshape(-1)

            ecols = []
            for c in range(k):
                col = e.new_zeros((e.shape[0], k))
                col[:, c] = e
                ecols.append(col.reshape(-1))
            Bk = torch.eye(k, dtype=r.dtype, device=r.device)

            sol = stpcg_flat(-rt.reshape(-1), A0, tuple(ecols), Bk, math.inf,
                             max_iterations=max_iterations,
                             kappa_fgr=float(tol), theta=0.0,
                             s_steps=s_steps, solve_mode=True)
            z = inv_dsq[:, None] * sol.s.reshape(-1, k)
            if with_iters:
                return z, int(sol.num_iterations)
            return z

        return solve_flat

    def M(res):
        if not jacobi:
            return res
        v = res * inv_deg[:, None]
        return v - torch.mean(v, dim=0, keepdim=True)

    def solve(r):
        tol = (50.0 * torch.finfo(r.dtype).eps if rtol is None else rtol)
        r0n = torch.sqrt(torch.sum(r * r))
        k = 0
        z = torch.zeros_like(r)
        res = r
        p = M(r)
        rz = torch.sum(r * p)
        ok = torch.ones((), dtype=torch.bool, device=r.device)
        while k < max_iterations and bool(
                ok & (torch.sqrt(torch.sum(res * res)) > tol * r0n)):
            Lp = L(p)
            curv = torch.sum(p * Lp)
            good = curv > 0
            alpha = torch.where(good, rz / torch.where(good, curv, 1.0), 0.0)
            z = z + alpha * p
            res = res - alpha * Lp
            v = M(res)
            rz_new = torch.sum(res * v)
            p = v + (rz_new / rz) * p
            rz = rz_new
            ok = good & (rz_new > 0)
            k += 1
        return (z, k) if with_iters else z

    return solve


def marginalized_problem(src, dst, Mij, tij, kappa=None, tau=None,
                         *, n=None, cg_iterations=400, cg_rtol=None,
                         jacobi=True,
                         inner_engine="cg", inner_s_steps=2,
                         scatter_method="scatter"):
    """The full SE-Sync rotation problem with the translations
    marginalized out, on ``Mij``'s device.

    The SE(d) cost  sum_e kappa_e |R_j - R_i M_e|^2 + tau_e |t_j - t_i -
    R_i t_e|^2  is quadratic in t for fixed R; with the optimal
    translations plugged in it is a quadratic form in the (transposed,
    stacked) rotations:

        f(X) = tr(X' L_conn X) + <B(X), W (I - P) W B(X)>,

    B(X)_e = t_e' X_{i(e)}, W = diag(sqrt(tau)), and P the orthogonal
    projector onto range(W A), applied through the matrix-free weighted
    Laplacian solve of :func:`_weighted_laplacian_solver`.

    Returns ``(problem, Q_op, n)``: a :class:`RiemannianProblem` over
    SO(d)^n in the transposed variables Q_k = R_k' (solve it like rotation
    sync, then transpose) and the symmetric PSD operator ``Q_op`` on
    (n d, k) blocks (for ``rotation_sync.certify``).

    The Riemannian gradient and Hessian are analytic: no autodiff passes
    the inner solve (its loop reads a stopping flag on the host).  For
    f = tr(X'QX) on a product of rotations, with G = 2 Q X,

        Hess f(X)[V] = proj_X( 2 Q V - V sym(X_i' G_i) ),

    the Weingarten term inside the projection.

    ``cg_rtol`` / ``cg_iterations`` set the inner solve's tolerance and cap
    (loose settings build the certificate-grade operator of
    :func:`solve_pose_graph`); ``inner_engine`` / ``inner_s_steps`` / the
    ``jacobi`` flag go to the inner solver; ``scatter_method`` picks the
    accumulation of every adjoint (``"adjacency"``: the incidence adjoints
    take the padded-incidence gather).
    """
    d = Mij.shape[-1]
    dtype, dev = Mij.dtype, Mij.device
    src, dst = _index(src, dev), _index(dst, dev)
    if n is None:
        # edge-derived: undercounts graphs with trailing isolated vertices;
        # solve_pose_graph passes graph.n_vertices
        n = int(torch.maximum(src.max(), dst.max())) + 1
    tau = (torch.ones(src.shape, dtype=dtype, device=dev) if tau is None
           else _tensor(tau, dtype, dev))
    sqw = torch.sqrt(tau)

    acc_method = "gather" if scatter_method == "adjacency" else scatter_method
    acc_inc = edge_accumulator(src, dst, n, method=acc_method)
    acc_src = edge_accumulator(src, dst, n, method=acc_method,
                               sides=("src",))

    rot_data = _transposed_rotation_data(src, dst, Mij, kappa)
    L_conn = rs.connection_laplacian_op(rot_data, n, d,
                                        scatter_method=scatter_method)
    lap_solve = _weighted_laplacian_solver(src, dst, tau, n,
                                           max_iterations=cg_iterations,
                                           rtol=cg_rtol,
                                           jacobi=jacobi,
                                           engine=inner_engine,
                                           s_steps=inner_s_steps,
                                           scatter_method=scatter_method)

    tijd = _tensor(tij, dtype, dev)

    def Bop(X):
        # (E, k): rows t_e' X_{src(e)}
        k = X.shape[-1]
        Xb = X.reshape(n, d, k)
        return torch.matmul(tijd[:, None, :], Xb[src])[:, 0, :]

    def Bt(Y):
        # adjoint: block i accumulates sum_{e: src=i} t_e (x) Y_e
        k = Y.shape[-1]
        contrib = tijd[:, :, None] * Y[:, None, :]          # (E, d, k)
        return acc_src(contrib, None).reshape(n * d, k)

    def A_inc(z):
        return z[dst] - z[src]

    def At_inc(y):
        return acc_inc(-y, y)

    def proj_complement(Y):
        # (I - P) Y with P the projector onto range(W A), per column
        rhs = At_inc(sqw[:, None] * Y)
        z = lap_solve(rhs)
        return Y - sqw[:, None] * A_inc(z)

    def Q_tau(V):
        return Bt(sqw[:, None] * proj_complement(sqw[:, None] * Bop(V)))

    def Q_op(V):
        return L_conn(V) + Q_tau(V)

    def f(Qr, data):
        X = Qr.reshape(n * d, d)
        WB = sqw[:, None] * Bop(X)
        ft = torch.sum(WB * proj_complement(WB))
        return torch.trace(torch.matmul(X.T, L_conn(X))) + ft

    def _sym(a):
        return 0.5 * (a + a.mT)

    def _egrad(Qr):
        return (2.0 * Q_op(Qr.reshape(n * d, d))).reshape(n, d, d)

    def grad(Qr, data):
        return rs.ROTATIONS.proj(Qr, _egrad(Qr))

    def quadratic_model(Qr, data):
        G = _egrad(Qr)
        g = rs.ROTATIONS.proj(Qr, G)
        S = _sym(torch.matmul(Qr.mT, G))

        def hvp(V):
            GV = _egrad(V)
            corr = torch.matmul(V, S)
            return rs.ROTATIONS.proj(Qr, GV - corr)

        return g, hvp

    def hess_vec(Qr, V, data):
        _, hvp = quadratic_model(Qr, data)
        return hvp(V)

    problem = RiemannianProblem(f=f, manifold=rs.ROTATIONS, grad=grad,
                                hess_vec=hess_vec,
                                quadratic_model=quadratic_model)
    return problem, Q_op, n


def gnc_identifiability(w, src, dst, n, base=None, threshold=0.5,
                        rel_cut=0.02):
    """Per-vertex identifiability of a GNC/IRLS fit from its final weights.

    An edge counts as *retained* when its final weight clears
    ``rel_cut * median(w)`` (``jnp.median``'s median): at the Geman-McClure
    endpoint clean inliers sit at w ~ 0.25 with a noise tail to ~1e-2, and
    rejected outliers fall to ~1e-6..1e-9; the relative cut sits in the gap
    between the two populations.  ``frac_i`` is the base-weighted retained
    fraction of vertex i's incident edges; ``identifiable_i = frac_i >=
    threshold`` (strict inlier majority).  A vertex that loses the majority
    sits between (near-)equal-cost robust basins and is reported as
    ambiguous.

    Returns ``(identifiable (n,) bool, frac (n,))``.
    """
    dev = w.device
    src, dst = _index(src, dev), _index(dst, dev)
    base = torch.ones_like(w) if base is None else base
    retained = (w >= rel_cut * rs._median(w)).to(w.dtype)
    mass = (w.new_zeros((n,)).index_add(0, src, base * retained)
            .index_add(0, dst, base * retained))
    total = w.new_zeros((n,)).index_add(0, src, base).index_add(0, dst, base)
    frac = mass / torch.clamp(total, min=torch.finfo(w.dtype).tiny)
    return frac >= threshold, frac


class RobustSEResult(NamedTuple):
    R: torch.Tensor            # (n, d, d) robust rotations
    t: torch.Tensor            # (n, d) robust translations
    w_rot: torch.Tensor        # (E,) final rotation-channel GNC weights
    w_tr: torch.Tensor         # (E,) final translation-channel GNC weights
    result: Any                # TNTResult of the last GNC stage
    # per-vertex flag (gnc_identifiability, min over both channels) and its
    # conjunction: False marks vertices whose incident inlier mass lost the
    # majority
    identifiable: torch.Tensor
    all_identifiable: torch.Tensor


def solve_robust_se(src, dst, Mij, tij, n, *, kappa=None, tau=None,
                    params: Optional[tnt.TNTParams] = None,
                    gnc_steps: int = 6, mu0: float = 64.0,
                    c2_rot=None, c2_tr=None, anchor: int = 0,
                    generator: Optional[torch.Generator] = None,
                    weight_floor: float = 1e-4,
                    scatter_method: str = "scatter") -> RobustSEResult:
    """Outlier-robust SE(d) pose synchronization, on ``Mij``'s device:
    Geman-McClure graduated non-convexity over the marginalized objective,
    reweighting both channels of every edge through kappa (rotation) and
    tau (translation).  Each GNC stage solves :func:`marginalized_problem`
    with the current weights, recovers the translations and sets

        w_e^rot = ( mu c_rot^2 / (mu c_rot^2 + r_e^rot) )^2,
        w_e^tr  = ( mu c_tr^2  / (mu c_tr^2  + r_e^tr ) )^2,

    r_e^rot = kappa_e |R_j - R_i M_e|_F^2, r_e^tr = tau_e |t_j - t_i -
    R_i t_e|^2, annealing mu from ``mu0`` down to 1.  Translation-only
    outliers are caught through the tau channel.

    The initial fit is the spectral rotation start (``generator`` draws its
    LOBPCG block) and five Geman-McClure IRLS rounds of the translation
    recovery, so that large translation outliers do not inflate the
    median-based scales ``c2_rot`` / ``c2_tr`` (default: the median
    residuals of that fit).  ``weight_floor`` clamps the weights used in the
    solves from below (the returned weights are unfloored), which caps the
    inner Laplacian's conditioning.

    Returns a :class:`RobustSEResult` ``(R, t, w_rot, w_tr, result,
    identifiable, all_identifiable)``; ``identifiable`` is
    :func:`gnc_identifiability` at the final weights, min over both
    channels.
    """
    dtype, dev = Mij.dtype, Mij.device
    src, dst = _index(src, dev), _index(dst, dev)
    tij = _tensor(tij, dtype, dev)
    ones = torch.ones(src.shape, dtype=dtype, device=dev)
    base_kappa = ones if kappa is None else _tensor(kappa, dtype, dev)
    base_tau = ones if tau is None else _tensor(tau, dtype, dev)

    def rot_residuals(R):
        diff = R[dst] - torch.matmul(R[src], Mij)
        return base_kappa * torch.sum(diff * diff, dim=(-1, -2))

    def tr_residuals(R, t):
        pred = torch.matmul(R[src], tij[:, :, None])[..., 0]
        diff = t[dst] - t[src] - pred
        return base_tau * torch.sum(diff * diff, dim=-1)

    if params is None:
        params = _default_params(dtype, 60)

    tiny_c2 = torch.as_tensor(1e-12, dtype=dtype, device=dev)
    rot_data = _transposed_rotation_data(src, dst, Mij, base_kappa)
    Q = rs.spectral_init(rot_data, n, Mij.shape[-1],
                         generator=generator).to(dtype)
    R = Q.mT
    wt = torch.ones_like(ones)
    for _ in range(5):
        t, _ = recover_translations(R, src, dst, tij,
                                    weights=base_tau * wt, anchor=anchor,
                                    scatter_method=scatter_method)
        r_tr = tr_residuals(R, t)
        c2t_cur = torch.maximum(rs._median(r_tr), tiny_c2)
        wt = (c2t_cur / (c2t_cur + r_tr)) ** 2
    r_rot = rot_residuals(R)
    r_tr = tr_residuals(R, t)

    def scale(c2, r):
        c = rs._median(r) if c2 is None else torch.as_tensor(
            c2, dtype=dtype, device=dev)
        return torch.maximum(c.to(dtype), tiny_c2)

    c2r = scale(c2_rot, r_rot)
    c2t = scale(c2_tr, r_tr)

    res = None
    w_rot = torch.ones_like(r_rot)
    w_tr = torch.ones_like(r_tr)
    floor = torch.as_tensor(weight_floor, dtype=dtype, device=dev)
    for mu in rs._gnc_schedule(mu0, gnc_steps, dtype, dev):
        w_rot = ((mu * c2r) / (mu * c2r + r_rot)) ** 2
        w_tr = ((mu * c2t) / (mu * c2t + r_tr)) ** 2
        problem, _, _ = marginalized_problem(
            src, dst, Mij, tij,
            kappa=base_kappa * torch.maximum(w_rot, floor),
            tau=base_tau * torch.maximum(w_tr, floor), n=n,
            scatter_method=scatter_method)
        res = tnt.solve(problem, Q, params)
        Q = res.x
        R = Q.mT
        t, _ = recover_translations(
            R, src, dst, tij,
            weights=base_tau * torch.maximum(w_tr, floor), anchor=anchor,
            scatter_method=scatter_method)
        r_rot = rot_residuals(R)
        r_tr = tr_residuals(R, t)

    id_rot, _ = gnc_identifiability(w_rot, src, dst, n, base_kappa)
    id_tr, _ = gnc_identifiability(w_tr, src, dst, n, base_tau)
    identifiable = id_rot & id_tr
    return RobustSEResult(R=R, t=t, w_rot=w_rot, w_tr=w_tr, result=res,
                          identifiable=identifiable,
                          all_identifiable=torch.all(identifiable))


def alignment_errors(R, t, R_true, t_true):
    """Errors after the optimal world-gauge alignment, on ``R``'s device in
    its dtype (the others may be numpy or tensors).

    The pose-graph gauge is a global rigid motion acting on the left:
    R_i -> G R_i, t_i -> G t_i + c.  Returns ``(mean_rot_err, max_t_err)``:
    the chordal mean |G R_i - R_true_i|_F / sqrt(n) and the largest
    translation deviation after the optimal (G, c).
    """
    dtype, dev = R.dtype, R.device
    t = _tensor(t, dtype, dev)
    R_true = _tensor(R_true, dtype, dev)
    t_true = _tensor(t_true, dtype, dev)
    n = R.shape[0]
    M = torch.einsum("nij,nkj->ik", R_true, R)     # sum R_true R'
    # polar factor restricted to SO(d)
    u, _, vt = torch.linalg.svd(M)
    s = torch.ones(M.shape[0], dtype=dtype, device=dev)
    s[-1] = torch.sign(torch.linalg.det(u @ vt))
    G = (u * s[None, :]) @ vt
    diff = torch.matmul(G, R) - R_true
    rot_err = torch.sqrt(torch.sum(diff * diff) / n)
    tG = t @ G.T
    c = torch.mean(t_true - tG, dim=0)
    t_err = torch.max(torch.abs(tG + c - t_true))
    return rot_err, t_err


def solve_pose_graph(graph, *, dtype=torch.float32,
                     params: Optional[tnt.TNTParams] = None,
                     anchor: int = 0,
                     generator: Optional[torch.Generator] = None,
                     certify: bool = False,
                     cert_fast: bool = False,
                     marginalized: bool = False,
                     tau=None, inner_engine="cg",
                     inner_s_steps=2, staircase: bool = False,
                     scatter_method: str = "scatter",
                     device="cuda") -> PoseSyncResult:
    """Full SE(d) pose synchronization of an ``io.g2o.PoseGraph`` (numpy
    fields), solved on ``device`` (default: the card; raises without one
    unless given ``"cpu"``).

    ``certify=True`` checks the rotation estimate for global optimality
    with the SE-Sync dual certificate (``rotation_sync.certify``: the
    smallest eigenvalue of S = Q - Lambda by LOBPCG).  ``cert_fast=True``
    runs it in its cheap configuration: one-eigh shifted-Cholesky
    Rayleigh-Ritz and the block-Jacobi certificate preconditioner (the
    latter on the chordal path only).

    ``marginalized=True`` minimizes the single-stage SE-Sync objective with
    the translations marginalized out (:func:`marginalized_problem`);
    ``tau`` supplies per-edge translational weights (default 1).  Its
    certificate is chol RR on the same operator; in f32 that operator's
    inner Laplacian solve is loose (60 iterations, rtol 1e-4): the
    certificate's slack eta = 1e3 eps(dtype) |L| is ~1.2e-4 |L| in f32, and
    a 1e-4 relative projector residual moves lam_min well inside it.  In
    f64 eta ~ 2e-13 |L| and the certificate keeps the optimizer-grade
    operator.

    ``staircase=True`` runs the Riemannian staircase
    (``rotation_sync.solve_staircase``) as the rotation stage; exclusive
    with ``marginalized``.  ``generator`` draws the spectral start's LOBPCG
    block (default: seeded 0 on ``device``).  ``scatter_method`` picks the
    edge->vertex accumulation of the operators.
    """
    dev = _device(device)
    src = _index(graph.src, dev)
    dst = _index(graph.dst, dev)
    Mij = _tensor(graph.Rij, dtype, dev)
    tij = _tensor(graph.tij, dtype, dev)
    kappa = (_tensor(graph.kappa, dtype, dev)
             if graph.kappa is not None else None)
    if tau is not None:
        tau = _tensor(tau, dtype, dev)

    if marginalized:
        problem, Q_op, n = marginalized_problem(src, dst, Mij, tij,
                                                kappa=kappa, tau=tau,
                                                n=graph.n_vertices,
                                                inner_engine=inner_engine,
                                                inner_s_steps=inner_s_steps,
                                                scatter_method=scatter_method)
        rot_data = _transposed_rotation_data(src, dst, Mij, kappa)
        Q0 = rs.spectral_init(rot_data, n, Mij.shape[-1],
                              generator=generator,
                              scatter_method=scatter_method).to(dtype)
        if params is None:
            params = _default_params(dtype, 100)
        rres = tnt.solve(problem, Q0, params)
        R = rres.x.mT
        cert_op = Q_op
        if dtype == torch.float32:
            _, cert_op, _ = marginalized_problem(
                src, dst, Mij, tij, kappa=kappa, tau=tau,
                n=graph.n_vertices, cg_iterations=60, cg_rtol=1e-4,
                inner_engine=inner_engine, inner_s_steps=inner_s_steps,
                scatter_method=scatter_method)
        cert_x = rres.x
    elif staircase:
        sdata = _transposed_rotation_data(src, dst, Mij, kappa)
        out = rs.solve_staircase(sdata, graph.n_vertices, Mij.shape[-1],
                                 params=params, generator=generator)
        R = out.R.mT
        rres = out.result
        cert_op = None
        cert_x = out.R
    else:
        R, rres = solve_rotations_g2o(src, dst, Mij, graph.n_vertices,
                                      kappa=kappa, params=params,
                                      generator=generator)
        cert_op = None
        cert_x = R.mT

    t, tres = recover_translations(R, src, dst, tij,
                                   weights=tau, anchor=anchor,
                                   scatter_method=scatter_method)
    cert = None
    if certify:
        # in the transposed variables, on the objective the rotation stage
        # minimized (L for the chordal model, Q when marginalized)
        cert = rs.certify(cert_x,
                          _transposed_rotation_data(src, dst, Mij, kappa),
                          operator=cert_op,
                          rr_method=("chol" if (cert_fast or marginalized)
                                     else "eigh"),
                          precondition=cert_fast,
                          scatter_method=scatter_method)
    return PoseSyncResult(R=R, t=t, rotation_result=rres,
                          translation_residual=tres, certificate=cert)
