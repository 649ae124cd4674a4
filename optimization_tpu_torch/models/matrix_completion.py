"""Low-rank matrix completion on the Grassmann manifold, RTRMC-style
(counterpart of ``optimization_tpu/models/matrix_completion.py``).

    min_{U in Gr(m, k)}  f(U),
    f(U) = min_W  1/2 |P_Omega(U W - M)|_F^2 + lam/2 |W|_F^2,

P_Omega masking to the observed entries.  For fixed U the inner problem is
a ridge least-squares per column of M, W[:, j] = (U' D_j U + lam I)^{-1}
U' D_j m_j, all n (k x k) systems solved together by a fixed 2k-sweep
batched CG (:func:`solve_W`).  f goes through the solved W; the envelope
theorem makes the U-gradient the partial gradient, and ``torch.func``
(grad through the batched solve, jvp for Hessian-vector products) gives the
exact Riemannian gradient and Hessian on the quotient.

The n normal matrices G[j] = U' D_j U are one product, maskᵀ @ (the
row-wise outer products U ⊗ U as an (m, k²) matrix): a pairwise
``einsum("mj,mp,mq->jpq")`` would build an (m, n, k) intermediate (800 MB
at 5000 x 4000, k = 10).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core.problem import RiemannianProblem
from ..manifolds.grassmann import GRASSMANN

__all__ = ["CompletionData", "make_problem", "solve_W", "predict",
           "random_instance", "spectral_init"]


class CompletionData(NamedTuple):
    M_obs: torch.Tensor    # (m, n) observed values (0 where unobserved)
    mask: torch.Tensor     # (m, n) {0,1} observation mask
    lam: torch.Tensor      # ridge weight on W (keeps the inner solve SPD)


def solve_W(U: torch.Tensor, data: CompletionData) -> torch.Tensor:
    """The inner ridge least-squares, all n columns batched: W is (k, n).

    A fixed 2k-sweep batched CG on the (k x k) SPD normal equations (CG
    ends in at most k steps in exact arithmetic).  Converged columns are
    masked with SAFE denominators: the sweeps run past convergence
    (rs -> 0), and differentiating rs'/rs there would divide by ~0 and
    poison the gradient and its jvp with NaNs; ``torch.where`` evaluates
    each division only with a denominator that is 1 where inactive."""
    m, k = U.shape
    UU = (U[:, :, None] * U[:, None, :]).reshape(m, k * k)
    G = (data.mask.mT @ UU).reshape(-1, k, k)           # (n, k, k)
    b = data.M_obs.mT @ U                                # (n, k)
    A = G + data.lam * torch.eye(k, dtype=U.dtype, device=U.device)

    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=-1)
    floor = 1e-10 * rs + 1e-30
    one = torch.ones_like(rs)
    for _ in range(2 * k):
        active = rs > floor
        Ap = (A @ p[:, :, None])[:, :, 0]
        pAp = torch.sum(p * Ap, dim=-1)
        alpha = torch.where(active, rs / torch.where(active, pAp, one),
                            torch.zeros_like(rs))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = torch.sum(r * r, dim=-1)
        beta = torch.where(active, rs_new / torch.where(active, rs, one),
                           torch.zeros_like(rs))
        p = r + beta[:, None] * p
        rs = rs_new
    return x.mT


def _f(U, data: CompletionData):
    W = solve_W(U, data)
    R = data.mask * (U @ W - data.M_obs)
    return 0.5 * torch.sum(R * R) + 0.5 * data.lam * torch.sum(W * W)


def make_problem() -> RiemannianProblem:
    return RiemannianProblem(f=_f, manifold=GRASSMANN)


def predict(U: torch.Tensor, data: CompletionData) -> torch.Tensor:
    """The completed matrix U W(U)."""
    return U @ solve_W(U, data)


def spectral_init(data: CompletionData, k: int) -> torch.Tensor:
    """Top-k left singular subspace of the zero-filled, rescaled observed
    matrix.  The SVD's signs differ from JAX's: compare subspaces."""
    frac = torch.clamp(torch.mean(data.mask), min=1e-6)
    Uf, _, _ = torch.linalg.svd(data.M_obs / frac, full_matrices=False)
    return Uf[:, :k]


def random_instance(generator: Optional[torch.Generator], m: int, n: int,
                    k: int, frac: float = 0.3, noise: float = 0.0,
                    lam: float = 1e-6, dtype=torch.float32, device=None):
    """A rank-k ground truth and a Bernoulli(frac) observation mask, drawn
    from ``generator`` on its device (default: seeded 0 on ``device``, the
    card unless told otherwise) and placed on ``device`` (default: the
    generator's).  Returns ``(M_true, data)``."""
    if generator is None:
        generator = torch.Generator(
            device=device if device is not None else "cuda").manual_seed(0)
    gd = generator.device
    out = gd if device is None else torch.device(device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=gd)

    L = randn(m, k)
    Rf = randn(k, n)
    M_true = (L @ Rf) / math.sqrt(float(k))
    mask = (torch.rand((m, n), generator=generator, dtype=dtype, device=gd)
            < frac).to(dtype)
    M_obs = mask * (M_true + noise * randn(m, n))
    return M_true.to(out), CompletionData(
        M_obs=M_obs.to(out), mask=mask.to(out),
        lam=torch.tensor(lam, dtype=dtype, device=out))
