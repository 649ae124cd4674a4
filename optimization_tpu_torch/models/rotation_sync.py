"""Rotation synchronization (SE-Sync-style) on SO(d)^n (counterpart of
``optimization_tpu/models/rotation_sync.py``).

Estimates n absolute rotations {R_i} from noisy relative measurements
R~_ij ~ R_i R_j^T over a graph, by minimizing the chordal cost

    f(R) = sum_{(i,j) in E}  kappa_e | R_i - R~_ij R_j |_F^2

over SO(d)^n, a stacked (n, d, d) tensor.  Gradients and Hessian-vector
products come from ``torch.func`` through the edge gathers and scatters
(``models/graph.py``); the spectral initialization and the global-optimality
certificate run the port's LOBPCG on the connection Laplacian (its Gram
stage in the ``gram_pair`` kernel for f32), and the Riemannian staircase
lifts a failed certificate to St(p, d)^n.

What differs from the JAX module:

- ``key=`` is ``generator=`` (a ``torch.Generator``); torch and JAX draw
  different numbers, so LOBPCG starts from another block, and spectral
  init and certificates agree with JAX only up to convergence and gauge.
  Where the JAX code reuses one key (every certificate of a staircase, the
  certificate's LOBPCG and its norm-estimate block), the port gives each
  use a generator in the same starting state.
- Products are ``torch.matmul`` in the data's dtype: f32 products run in
  full f32 (nothing here turns TF32 on).
- Indices are int64 on the data's device; ``random_instance`` and
  ``random_fleet`` make their data on the card unless told otherwise.
- ``random_fleet`` makes the data only; its fleet is solved instance by
  instance (``parallel.sharding.batch_sharded_solve``), where JAX vmaps
  one solve.
- ``jnp.median`` averages the two middle values of an even count where
  ``torch.median`` returns the lower one; the GNC scales go through
  :func:`_median`, which matches ``jnp.median``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from ..core.problem import RiemannianProblem
from ..manifolds.stiefel import ROTATIONS, STIEFEL, _flip_first_column
from .graph import adjacency_tables, edge_accumulator

__all__ = ["RotationSyncData", "CertificateResult", "certify",
           "make_problem", "random_instance", "random_fleet",
           "solve_staircase", "StaircaseResult", "round_lifted",
           "mean_rotation_error", "solve_robust", "RobustResult"]


class RotationSyncData(NamedTuple):
    src: torch.Tensor     # (E,) int64: edge sources i
    dst: torch.Tensor     # (E,) int64: edge targets j
    Rij: torch.Tensor     # (E, d, d): measured relative rotations
    # optional per-edge rotational information weights (SE-Sync's kappa)
    kappa: Optional[torch.Tensor] = None    # (E,)


def _weights(data: RotationSyncData, dtype) -> torch.Tensor:
    if data.kappa is not None:
        return data.kappa.to(dtype)
    return torch.ones(data.src.shape, dtype=dtype, device=data.src.device)


def _degree(data: RotationSyncData, n: int, w: torch.Tensor) -> torch.Tensor:
    return (w.new_zeros((n,)).index_add(0, data.src, w)
            .index_add(0, data.dst, w))


def chordal_cost(R: torch.Tensor, data: RotationSyncData) -> torch.Tensor:
    """f(R) = sum_e kappa_e |R_i - R~_e R_j|_F^2 (kappa = 1 when absent)."""
    diff = R[data.src] - torch.matmul(data.Rij, R[data.dst])
    sq = torch.sum(diff * diff, dim=(-1, -2))
    if data.kappa is not None:
        sq = data.kappa * sq
    return torch.sum(sq)


def jacobi_precon(x, v, data: RotationSyncData):
    """Block-Jacobi preconditioner of the chordal Hessian: the per-vertex
    scalar 1 / (2 deg_i) (weighted degree), which keeps tangency on SO(d)^n
    exactly (see the JAX module)."""
    deg = _degree(data, x.shape[0], _weights(data, x.dtype))
    inv = 1.0 / (2.0 * torch.clamp(deg, min=torch.finfo(x.dtype).tiny))
    return v * inv[:, None, None]


def make_problem(preconditioned: bool = False,
                 flat: bool = False) -> RiemannianProblem:
    """The chordal rotation-sync problem; ``preconditioned=True`` installs
    :func:`jacobi_precon`.  ``flat=True`` routes the trust-region
    subproblem through the flat pair engine (``linalg/flat_cg.py``) with the
    full Riemannian Hessian closure as its operator and no low-rank term
    (U = None); the ambient Frobenius metric is the Euclidean dot that
    engine requires.  With ``preconditioned`` the flat route is not taken
    (TNT's generic engine applies the preconditioner)."""
    base = RiemannianProblem(f=chordal_cost, manifold=ROTATIONS,
                             precon=jacobi_precon if preconditioned else None)
    if not flat or preconditioned:
        return base

    def flat_qm(x, data):
        _, hvp = base.qm(x, data)
        return hvp, None, None

    return dataclasses.replace(base, flat_qm=flat_qm)


def _generator(generator, device) -> torch.Generator:
    """``generator``, or one seeded 0 on ``device`` (default: the card)."""
    if generator is not None:
        return generator
    return torch.Generator(
        device=device if device is not None else "cuda").manual_seed(0)


def _same_start(generator, device) -> torch.Generator:
    """A new generator in ``generator``'s current state (the JAX code's
    reuse of one key), or one seeded 0 on ``device``."""
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


def _perturbations(generator, E: int, d: int, noise: float, dtype):
    """Small rotations exp(noise * skew), by the 2nd-order expansion
    re-orthonormalized."""
    w = noise * torch.randn((E, d, d), generator=generator, dtype=dtype,
                            device=generator.device)
    skew = 0.5 * (w - w.mT)
    eye = torch.eye(d, dtype=dtype, device=generator.device)
    return _orthonormalize(eye + skew + 0.5 * (skew @ skew))


def _chain_plus_random(generator, n: int, extra_edges: int):
    src = torch.arange(n - 1, device=generator.device)
    dst = src + 1
    if extra_edges:
        e_src = torch.randint(0, n, (extra_edges,), generator=generator,
                              device=generator.device)
        e_dst = torch.randint(0, n, (extra_edges,), generator=generator,
                              device=generator.device)
        src = torch.cat([src, e_src])
        dst = torch.cat([dst, e_dst])
    return src, dst


def random_instance(generator: Optional[torch.Generator], n: int, d: int = 3,
                    extra_edges: int = 0, noise: float = 0.05,
                    dtype=torch.float32, device=None):
    """A connected instance: a spanning path plus ``extra_edges`` random
    edges, measurements perturbed by small random rotations.  Drawn from
    ``generator`` in order (truth, extra sources, extra targets, noise) on
    its device; placed on ``device`` (default: the generator's; with no
    generator, one seeded 0 on the card).  Returns ``(R_true, data)``."""
    gen = _generator(generator, device)
    out = gen.device if device is None else torch.device(device)
    R_true = ROTATIONS.rand(gen, n, d, d, dtype=dtype)
    src, dst = _chain_plus_random(gen, n, extra_edges)
    Rij_clean = R_true[src] @ R_true[dst].mT
    Rij = _perturbations(gen, src.shape[0], d, noise, dtype) @ Rij_clean
    return R_true.to(out), RotationSyncData(src=src.to(out), dst=dst.to(out),
                                            Rij=Rij.to(out))


def random_fleet(generator: Optional[torch.Generator], B: int, n: int,
                 d: int = 3, extra_edges: int = 0, noise: float = 0.05,
                 dtype=torch.float32, device=None):
    """B instances sharing ONE edge topology: ``(R_trues, data)`` with
    ``R_trues`` (B, n, d, d) and ``data.Rij`` (B, E, d, d).  The data only:
    solve it with ``parallel.sharding.batch_sharded_solve``."""
    gen = _generator(generator, device)
    out = gen.device if device is None else torch.device(device)
    src, dst = _chain_plus_random(gen, n, extra_edges)
    R_trues, Rijs = [], []
    for _ in range(B):
        R_true = ROTATIONS.rand(gen, n, d, d, dtype=dtype)
        Rij_clean = R_true[src] @ R_true[dst].mT
        R_trues.append(R_true)
        Rijs.append(_perturbations(gen, src.shape[0], d, noise, dtype)
                    @ Rij_clean)
    return (torch.stack(R_trues).to(out),
            RotationSyncData(src=src.to(out), dst=dst.to(out),
                             Rij=torch.stack(Rijs).to(out)))


def _orthonormalize(M):
    """Project (..., d, d) matrices onto O(d) via the polar factor."""
    g = M.mT @ M
    w, q = torch.linalg.eigh(g)
    inv_sqrt = (q * (1.0 / torch.sqrt(w))[..., None, :]) @ q.mT
    return M @ inv_sqrt


def connection_laplacian_op(data: RotationSyncData, n: int, d: int,
                            scatter_method: str = "scatter"):
    """Matrix-free connection Laplacian L of the measurement graph, on
    (n*d, k) blocks: block row i gets  deg_i X_i - sum_{e: i->j} R~_e X_j -
    sum_{e: j->i} R~_e^T X_j.

    ``scatter_method`` picks the edge->vertex accumulation
    (``graph.edge_accumulator``), or ``"adjacency"``: the weighted
    (transposed where reversed) measurement blocks are gathered per vertex
    slot once at construction, laid out (n, d, slots*d), and every apply is
    one neighbor gather + one batched (d, slots*d) x (slots*d, k) product —
    no scatter, no E-sized intermediate."""
    dtype = data.Rij.dtype
    w = _weights(data, dtype)
    deg = _degree(data, n, w)

    if scatter_method == "adjacency":
        nb, eid, fwd, slots = adjacency_tables(data.src, data.dst, n)
        R_slots = torch.cat([data.Rij, data.Rij.new_zeros((1, d, d))])[eid]
        R_slots = torch.where(fwd[:, :, None, None], R_slots, R_slots.mT)
        w_slots = torch.cat([w, w.new_zeros((1,))])[eid]
        blocks = (w_slots[:, :, None, None] * R_slots)      # (n, s, d, d)
        blocks = blocks.permute(0, 2, 1, 3).reshape(n, d, slots * d)

        def L_adj(S):
            k = S.shape[-1]
            X = S.reshape(n, d, k)
            X_ext = torch.cat([X, X.new_zeros((1, d, k))], 0)
            nbr = torch.bmm(blocks, X_ext[nb].reshape(n, slots * d, k))
            return (deg[:, None, None] * X - nbr).reshape(n * d, k)

        return L_adj

    acc = edge_accumulator(data.src, data.dst, n, method=scatter_method)

    def L(S):
        k = S.shape[-1]
        X = S.reshape(n, d, k)
        RX_j = w[:, None, None] * (data.Rij @ X[data.dst])
        RtX_i = w[:, None, None] * (data.Rij.mT @ X[data.src])
        out = deg[:, None, None] * X + acc(-RX_j, -RtX_i)
        return out.reshape(n * d, k)

    return L


def spectral_init(data: RotationSyncData, n: int, d: int = 3,
                  generator: Optional[torch.Generator] = None,
                  max_iterations: int = 200, tau: float = 1e-3,
                  rr_method: str = "chol",
                  scatter_method: str = "scatter") -> torch.Tensor:
    """SE-Sync-style chordal initialization: the d smallest eigenvectors of
    the connection Laplacian (the port's LOBPCG, one-eigh chol RR by
    default), reshaped to (n, d, d) blocks and projected onto SO(d).  The
    start block is drawn in the data's dtype from ``generator`` (default:
    seeded 0 on the data's device)."""
    from ..linalg.lobpcg import lobpcg

    dtype, dev = data.Rij.dtype, data.Rij.device
    gen = _generator(generator, dev)
    L = connection_laplacian_op(data, n, d, scatter_method=scatter_method)
    nx = min(2 * d + 2, n * d)
    X0 = torch.randn((n * d, nx), generator=gen, dtype=dtype,
                     device=gen.device).to(dev)
    res = lobpcg(L, X0=X0, nev=d, max_iterations=max_iterations, tau=tau,
                 generator=gen, rr_method=rr_method)
    blocks = res.X.reshape(n, d, d)
    R = _orthonormalize(blocks)
    # a block of lower rank (a vertex where the eigenvectors nearly vanish,
    # as on a long chain in f32) has no inverse square root: its eigh
    # polar factor is NaN, as in JAX; the SVD's polar factor U V' is
    # defined for every block and replaces it (ROADMAP Queue 3)
    bad = ~torch.isfinite(R).all(dim=-1).all(dim=-1)
    if bool(bad.any()):
        U, _, Vh = torch.linalg.svd(torch.nan_to_num(blocks[bad]))
        R[bad] = U @ Vh
    # land in SO(d): negating column 0 of a block is a right multiplication
    # by diag(-1, 1, ..), so per-block flips stay consistent up to gauge
    det = torch.linalg.det(R)
    return _flip_first_column(R, torch.where(det < 0, -1.0, 1.0).to(dtype))


def _median(a: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all entries: the mean of the two middle values of
    the sorted entries for an even count (``torch.median`` returns the lower
    one), NaN when any entry is NaN."""
    flat = a.reshape(-1)
    s = torch.sort(flat).values
    n = s.numel()
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(flat).any(), flat.new_full((), math.nan),
                       mid)


def _gnc_schedule(mu0: float, steps: int, dtype, device):
    """The GNC annealing values ``jnp.logspace(log10(mu0), 0, steps)`` as 0-d
    tensors of ``dtype``: 10 ** (start (1 - i/(steps-1)) + 0 i/(steps-1))
    in float64, the last exactly 10 ** 0 (the JAX package's linspace
    formula)."""
    start = math.log10(mu0)
    if steps > 1:
        step = torch.arange(steps - 1, dtype=torch.float64) / (steps - 1)
        lin = torch.cat([start * (1 - step) + 0.0 * step,
                         torch.zeros(1, dtype=torch.float64)])
    else:
        lin = torch.full((steps,), start, dtype=torch.float64)
    return list(torch.pow(10.0, lin).to(dtype=dtype, device=device))


class RobustResult(NamedTuple):
    R: torch.Tensor            # (n, d, d) robust rotations
    weights: torch.Tensor      # (E,) final GNC weights (outliers -> ~0)
    result: Any                # TNTResult of the last GNC stage
    identifiable: torch.Tensor  # (n,) per-vertex inlier-majority flag
    all_identifiable: torch.Tensor


def solve_robust(data: RotationSyncData, n: int, d: int = 3, *,
                 params=None, gnc_steps: int = 6, mu0: float = 64.0,
                 c2: Optional[float] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> RobustResult:
    """Outlier-robust rotation synchronization: Geman-McClure by graduated
    non-convexity (GNC), as reweighted chordal solves over the per-edge
    ``kappa`` seam.  Each stage solves the weighted chordal problem with
    TNT, then sets

        w_e = ( mu c^2 / (mu c^2 + r_e) )^2,      r_e = |R_i - M_e R_j|_F^2,

    annealing ``mu`` from ``mu0`` down to 1 (mu -> inf is the convex
    quadratic, mu = 1 Geman-McClure).  ``c2`` is the inlier scale (a squared
    residual); default: the median residual of the spectral start
    (``generator`` draws its LOBPCG block).

    Returns a :class:`RobustResult` ``(R, weights, result, identifiable,
    all_identifiable)``: the estimate, the final per-edge weights, the last
    TNT result, and ``pose_sync.gnc_identifiability``'s per-vertex flag at
    the final weights.
    """
    from ..solvers import tnt as _tnt

    dtype = data.Rij.dtype
    if params is None:
        f32 = dtype == torch.float32
        params = _tnt.TNTParams(
            max_iterations=50,
            gradient_tolerance=(2e-3 if f32 else 1e-8),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)

    def residuals(R):
        diff = R[data.src] - torch.matmul(data.Rij, R[data.dst])
        return torch.sum(diff * diff, dim=(-1, -2))

    base_kappa = _weights(data, dtype)
    R = spectral_init(data, n, d, generator=generator).to(dtype)
    r = residuals(R)
    c2 = _median(r) if c2 is None else torch.as_tensor(c2, dtype=dtype,
                                                        device=r.device)
    c2 = torch.clamp(c2.to(dtype), min=1e-12)

    res = None
    w = torch.ones_like(r)
    for mu in _gnc_schedule(mu0, gnc_steps, dtype, r.device):
        w = ((mu * c2) / (mu * c2 + r)) ** 2
        wdata = RotationSyncData(src=data.src, dst=data.dst, Rij=data.Rij,
                                 kappa=base_kappa * w)
        res = _tnt.solve(make_problem(), R, params, data=wdata)
        R = res.x
        r = residuals(R)

    from .pose_sync import gnc_identifiability
    identifiable, _ = gnc_identifiability(w, data.src, data.dst, n,
                                          base_kappa)
    return RobustResult(R=R, weights=w, result=res,
                        identifiable=identifiable,
                        all_identifiable=torch.all(identifiable))


class CertificateResult(NamedTuple):
    certified: torch.Tensor        # bool: S = L - Lambda is PSD up to eta
    lam_min: torch.Tensor          # smallest eigenvalue estimate of S
    eta: torch.Tensor              # the tolerance actually used
    stationarity: torch.Tensor     # |S X|_F / |X|_F (0 at critical points)
    num_iterations: torch.Tensor   # LOBPCG iterations
    # eigenvector of lam_min, shape (n d,): the staircase's escape direction
    eigvec: Optional[torch.Tensor] = None


def certify(R: torch.Tensor, data: RotationSyncData, *,
            eta: Optional[float] = None, nx: int = 8,
            max_iterations: int = 200, tau: float = 1e-3,
            generator: Optional[torch.Generator] = None, operator=None,
            rr_method: str = "eigh", precondition: bool = False,
            scatter_method: str = "scatter") -> CertificateResult:
    """Global-optimality certificate for a rotation-sync critical point
    (SE-Sync's): with X = R.reshape(n d, p), Lambda_i = sym((L X)_i X_i')
    and S = L - BlockDiag(Lambda), S >= 0 certifies that R is a global
    optimizer of the relaxation.  The PSD check is the port's LOBPCG on the
    matrix-free S.

    ``eta``: PSD slack; default ``1e3 * eps(dtype) * |L|_est`` with the
    norm estimated on a Gaussian (n d, nx) block.  ``generator`` draws the
    LOBPCG start block and (from the same starting state, as the JAX code
    reuses its key) that block; default: seeded 0 on R's device.
    ``operator`` replaces the connection Laplacian; ``rr_method`` goes to
    LOBPCG; ``precondition`` applies the clamped inverses of S's closed-form
    diagonal blocks (deg_i I - Lambda_i; ignored with ``operator``).  R may
    carry a trailing rank-p axis, (n, d, p >= d), the staircase lift.
    """
    from ..linalg.lobpcg import lobpcg

    n, d = R.shape[0], R.shape[1]
    dtype, dev = R.dtype, R.device
    L = (operator if operator is not None
         else connection_laplacian_op(data, n, d,
                                      scatter_method=scatter_method))
    p = R.shape[-1]
    X = R.reshape(n * d, p)
    Rb = X.reshape(n, d, p)
    Lam = L(X).reshape(n, d, p) @ Rb.mT
    Lam = 0.5 * (Lam + Lam.mT)

    def S_op(V):
        k = V.shape[-1]
        return L(V) - (Lam @ V.reshape(n, d, k)).reshape(n * d, k)

    SX = S_op(X)
    stationarity = torch.sqrt(torch.sum(SX * SX) / torch.sum(X * X))

    T_op = None
    if precondition and operator is None:
        deg = _degree(data, n, _weights(data, dtype))
        blocks = deg[:, None, None] * torch.eye(d, dtype=dtype,
                                                device=dev) - Lam
        wb, qb = torch.linalg.eigh(blocks)
        floor_b = 1e-2 * torch.mean(deg) + torch.finfo(dtype).tiny
        inv = (qb / torch.maximum(wb, floor_b)[:, None, :]) @ qb.mT

        def T_op(V):
            k = V.shape[-1]
            return (inv @ V.reshape(n, d, k)).reshape(n * d, k)

    gen = _same_start(generator, dev)
    X0 = torch.randn((n * d, nx), generator=gen, dtype=dtype,
                     device=gen.device).to(dev)
    res = lobpcg(S_op, T=T_op, X0=X0, nev=1, max_iterations=max_iterations,
                 tau=tau, generator=gen, rr_method=rr_method)
    lam_min = res.theta[0]

    if eta is None:
        # scale-aware tolerance from the Laplacian norm estimate
        g2 = _same_start(generator, dev)
        omega = torch.randn((n * d, nx), generator=g2, dtype=dtype,
                            device=g2.device).to(dev)
        Lnorm = torch.linalg.norm(L(omega)) / torch.linalg.norm(omega)
        eta_val = 1e3 * torch.finfo(dtype).eps * Lnorm
    else:
        eta_val = torch.as_tensor(eta, dtype=dtype, device=dev)

    return CertificateResult(
        certified=lam_min >= -eta_val, lam_min=lam_min, eta=eta_val,
        stationarity=stationarity, num_iterations=res.num_iterations,
        eigvec=res.X[:, 0])


class StaircaseResult(NamedTuple):
    R: torch.Tensor            # (n, d, d) rounded + polished SO(d) estimate
    certified: torch.Tensor    # certificate of the RETURNED R
    cert: Any                  # CertificateResult at R
    p_final: int               # relaxation rank the staircase stopped at
    rank_gap: float            # sigma_{d+1}/sigma_1 of the final lifted X
    result: Any                # TNTResult of the last solve
    # per-level history: (p, f, lam_min, sdp_certified)
    levels: tuple


def _lifted_problem(n: int, d: int) -> RiemannianProblem:
    """The rank-p relaxation  min tr(X' L X)  over block-row-orthonormal X,
    stored as Y of shape (n, p, d): a product of Stiefel St(p, d) factors,
    X the stacked Y_i' blocks."""
    def f(Y, data):
        p = Y.shape[-2]
        L = connection_laplacian_op(data, n, d)
        X = Y.mT.reshape(n * d, p)
        return torch.sum(X * L(X))

    return RiemannianProblem(f=f, manifold=STIEFEL)


def round_lifted(Y: torch.Tensor):
    """Round a rank-p staircase iterate to SO(d)^n (SE-Sync rounding): the
    top-d SVD factor of X = stacked Y_i' blocks, the global orientation by
    the majority determinant sign, each block projected to SO(d).  Returns
    ``(R, rank_gap)``, rank_gap = sigma_{d+1}/sigma_1 (0 when p = d).  The
    SVD's signs differ from JAX's, so R agrees with it up to a global
    gauge."""
    n, p, d = Y.shape
    X = Y.mT.reshape(n * d, p)
    U, s, _ = torch.linalg.svd(X, full_matrices=False)
    Xd = (U[:, :d] * s[None, :d]).reshape(n, d, d)
    rank_gap = (s[d] / s[0]) if p > d else Y.new_zeros(())
    R = _orthonormalize(Xd)
    det = torch.linalg.det(R)
    flip = torch.where(torch.sum(torch.sign(det)) < 0, -1.0, 1.0).to(R.dtype)
    R = _flip_first_column(R, flip.expand(n))
    det = torch.linalg.det(R)
    return (_flip_first_column(R, torch.where(det < 0, -1.0, 1.0)
                               .to(R.dtype)), rank_gap)


def solve_staircase(data: RotationSyncData, n: int, d: int = 3, *,
                    p_max: Optional[int] = None, params=None, R0=None,
                    generator: Optional[torch.Generator] = None,
                    cert_nx: int = 8, cert_tau: float = 1e-3,
                    cert_max_iterations: int = 200,
                    escape_ts=None) -> StaircaseResult:
    """Certifiably-global rotation synchronization by the Riemannian
    staircase (SE-Sync):

    1. solve on SO(d)^n (spectral init unless ``R0``, then TNT) and certify;
    2. while the certificate fails and p < p_max: lift to rank p + 1 (a zero
       row on each Stiefel factor), step along the certificate's negative
       eigenvector at the best of ``escape_ts`` (default logspace(-4, 1,
       11)), re-solve with TNT on St(p, d)^n and re-certify;
    3. round back to SO(d)^n (:func:`round_lifted`), polish with TNT, and
       certify the returned R.

    The rank loop runs on the host.  ``generator`` feeds the spectral init
    and, from one starting state each, every certificate (the JAX code's
    one ``key``).
    """
    from ..solvers import tnt as _tnt

    dtype, dev = data.Rij.dtype, data.Rij.device
    if p_max is None:
        p_max = d + 3
    if params is None:
        f32 = dtype == torch.float32
        params = _tnt.TNTParams(
            max_iterations=100,
            gradient_tolerance=(2e-3 if f32 else 1e-8),
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)
    if escape_ts is None:
        escape_ts = torch.logspace(-4.0, 1.0, 11, dtype=torch.float64)
    cert_kw = dict(nx=cert_nx, tau=cert_tau,
                   max_iterations=cert_max_iterations)

    def cert_of(R):
        return certify(R, data, generator=_same_start(generator, dev),
                       **cert_kw)

    if R0 is None:
        R0 = spectral_init(data, n, d,
                           generator=_same_start(generator, dev)).to(dtype)
    res = _tnt.solve(make_problem(), R0, params, data=data)
    R = res.x
    cert = cert_of(R)
    levels = [(d, float(res.f), float(cert.lam_min), bool(cert.certified))]
    rank_gap = 0.0

    Y = R.mT                                   # (n, d, d), Y_i = R_i'
    lifted = _lifted_problem(n, d)
    p = d
    while not bool(cert.certified) and p < p_max:
        p += 1
        # lift: pad a zero row; the lifted point is the same critical
        # point, now a strict saddle of the rank-p relaxation
        Y = torch.cat([Y, Y.new_zeros((n, 1, d))], dim=1)
        Ydot = torch.zeros_like(Y)
        Ydot[:, -1, :] = cert.eigvec.reshape(n, d).to(Y.dtype)
        fs = torch.stack([lifted.value(STIEFEL.retract(Y, float(t) * Ydot),
                                       data) for t in escape_ts])
        t_best = float(escape_ts[int(torch.argmin(fs))])
        Y = STIEFEL.retract(Y, t_best * Ydot)

        res = _tnt.solve(lifted, Y, params, data=data)
        Y = res.x
        cert = cert_of(Y.mT)
        levels.append((p, float(res.f), float(cert.lam_min),
                       bool(cert.certified)))

    if p > d:
        R, gap = round_lifted(Y)
        rank_gap = float(gap)
        # polish the rounded point on SO(d)^n, then certify what is returned
        res = _tnt.solve(make_problem(), R.to(dtype), params, data=data)
        R = res.x
        cert_R = cert_of(R)
    else:
        cert_R = cert

    return StaircaseResult(R=R, certified=cert_R.certified, cert=cert_R,
                           p_final=p, rank_gap=rank_gap, result=res,
                           levels=tuple(levels))


def mean_rotation_error(R: torch.Tensor, R_true: torch.Tensor) -> torch.Tensor:
    """Gauge-aligned mean chordal error |R G - R_true|_F / sqrt(n), the
    global gauge G the polar factor of sum_i R_i^T R_true_i."""
    M = torch.einsum("nij,nik->jk", R, R_true)
    G = _orthonormalize(M)
    diff = R @ G - R_true
    return torch.sqrt(torch.sum(diff * diff) / R.shape[0])
