"""Batched small-matrix symmetric eigensolver: parallel-ordered cyclic Jacobi.

Counterpart of ``optimization_tpu/linalg/jacobi.py``: the same Brent-Luk
parallel ordering (pairs are the adjacent index pairs (2i, 2i+1); between
rotation rounds the matrix is conjugated by one fixed tournament
permutation whose n-1 iterates make every index pair adjacent once per
sweep), the same Rutishauser threshold pivot test, odd-n padding with a
decoupled sentinel, batch dims iterated in lockstep and the ``v0`` warm
start.  The ``while_loop`` over sweeps and the ``fori_loop`` over rounds
are Python loops; whether any instance rotated in a sweep is one host read
per sweep.  Each round is a few elementwise tensor ops (no matmul), so the
f32 carry is exact as in the JAX package.

Like the JAX module this is a standalone high-relative-accuracy eigensolver
(graded spectra) and the seeded eigh of ``rr_method="chol_warm"``; the
LOBPCG default eigh is ``torch.linalg.eigh``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["jacobi_eigh"]


@lru_cache(maxsize=None)
def _tournament_perm(n: int) -> np.ndarray:
    """Fixed position permutation whose iterates enumerate all pairings.

    Arrangement space: a list L of n players with pairing (L[i], L[n-1-i])
    (round-robin circle method: L[0] fixed, the rest rotate one step per
    round).  The layout lam places pair i at adjacent positions (2i, 2i+1).
    ``new_A = old_A[perm][:, perm]`` advances one round, and over n-1 rounds
    every unordered index pair is adjacent exactly once."""
    half = n // 2
    lam = np.empty(n, np.int32)
    for i in range(half):
        lam[i] = 2 * i
        lam[n - 1 - i] = 2 * i + 1
    lam_inv = np.argsort(lam)
    rho_src = np.empty(n, np.int32)
    rho_src[0] = 0
    rho_src[1] = n - 1
    for j in range(2, n):
        rho_src[j] = j - 1
    return lam[rho_src[lam_inv]].astype(np.int32)


def _round(A: torch.Tensor, V: torch.Tensor, perm: torch.Tensor,
           reltol: float, floor: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One parallel rotation round: zero A[2i, 2i+1] for all i, then advance
    the pairing by the tournament permutation.  Returns the per-instance
    "rotated anything" flag of the threshold-Jacobi test."""
    n = A.shape[-1]
    half = n // 2
    batch = A.shape[:-2]

    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    app = diag[..., 0::2]
    aqq = diag[..., 1::2]
    apq = torch.diagonal(A[..., 0::2, 1::2], dim1=-2, dim2=-1)

    # Threshold-Jacobi pivot skip (Rutishauser): a pivot negligible relative
    # to its diagonal pair stays; the absolute floor handles zero diagonals.
    small = ((apq.abs() <= reltol * torch.sqrt((app * aqq).abs()))
             | (apq.abs() <= floor[..., None]))
    rotated = torch.any(~small, dim=-1)

    apq_safe = torch.where(small, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * apq_safe)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, torch.ones_like(t), t)
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c

    # left update J'A: rows (2i, 2i+1) mix
    Ar = A.reshape(batch + (half, 2, n))
    r0, r1 = Ar[..., 0, :], Ar[..., 1, :]
    cs, sn = c[..., None], s[..., None]
    A = torch.stack([cs * r0 - sn * r1, sn * r0 + cs * r1],
                    dim=-2).reshape(batch + (n, n))

    # right update (.)J: columns (2i, 2i+1) mix
    Ac = A.reshape(batch + (n, half, 2))
    c0, c1 = Ac[..., 0], Ac[..., 1]
    cs, sn = c[..., None, :], s[..., None, :]
    A = torch.stack([cs * c0 - sn * c1, sn * c0 + cs * c1],
                    dim=-1).reshape(batch + (n, n))

    Vc = V.reshape(batch + (n, half, 2))
    v0, v1 = Vc[..., 0], Vc[..., 1]
    V = torch.stack([cs * v0 - sn * v1, sn * v0 + cs * v1],
                    dim=-1).reshape(batch + (n, n))

    # advance the tournament: conjugate by the fixed permutation
    A = A[..., perm][..., perm, :]
    V = V[..., perm]
    return A, V, rotated


def jacobi_eigh(A: torch.Tensor, *, max_sweeps: int = 12,
                tol: Optional[float] = None, sort: bool = True,
                v0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a (batch of) symmetric matrices by parallel
    cyclic Jacobi.

    - ``A``: (..., n, n) symmetric (symmetrized internally); all leading
      batch instances iterate in lockstep.
    - ``max_sweeps``: cap on sweeps (one sweep = n-1 rotation rounds).
    - ``tol``: the threshold-Jacobi pivot cutoff (default ``eps(dtype)``): a
      pivot ``A[p,q]`` rotates only while ``|A[p,q]| > tol * sqrt(|A[p,p]
      A[q,q]|)`` and above the floor ``tol * ||A||_F / n``.  Sweeping stops
      once a full sweep rotates nothing in any instance.
    - ``sort``: eigenvalues ascending (stable order).
    - ``v0``: an (..., n, n) orthonormal warm-start seed: A is conjugated to
      ``v0' A v0`` and the returned V composes the seed back in.

    Returns ``(w, V)`` with ``A ~ V diag(w) V'`` — the ``torch.linalg.eigh``
    contract.  Odd n is padded with a decoupled sentinel eigenvalue that
    sorts last and is sliced away.
    """
    n_in = A.shape[-1]
    if v0 is not None:
        A = v0.mT @ A @ v0
    A = 0.5 * (A + A.mT)
    dtype, device = A.dtype, A.device
    batch = A.shape[:-2]

    n = n_in + (n_in & 1)
    if n != n_in:
        # a decoupled diagonal entry above every instance's Gershgorin bound
        big = A.abs().sum(dim=-1).amax(dim=-1) + 1.0
        pad = torch.zeros(batch + (n, n), dtype=dtype, device=device)
        pad[..., :n_in, :n_in] = A
        pad[..., n_in, n_in] = big
        A = pad

    if tol is None:
        tol = float(torch.finfo(dtype).eps)

    perm = torch.as_tensor(_tournament_perm(n), dtype=torch.long,
                           device=device)
    V = torch.eye(n, dtype=dtype, device=device).expand(
        batch + (n, n)).clone()
    fro2 = (A * A).sum(dim=(-2, -1))
    # per-instance absolute pivot floor
    floor = tol * torch.sqrt(fro2) / float(n) + torch.finfo(dtype).tiny

    sweeps, rotated = 0, True
    while sweeps < max_sweeps and rotated:
        rot = torch.zeros(batch, dtype=torch.bool, device=device)
        for _ in range(n - 1):
            A, V, r = _round(A, V, perm, tol, floor)
            rot = rot | r
        # one resymmetrization per sweep bounds roundoff drift
        A = 0.5 * (A + A.mT)
        sweeps += 1
        rotated = bool(rot.any())

    w = torch.diagonal(A, dim1=-2, dim2=-1)
    if sort:
        order = torch.argsort(w, dim=-1, stable=True)
        w = torch.take_along_dim(w, order, dim=-1)
        V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    w, V = w[..., :n_in], V[..., :n_in, :n_in]
    if v0 is not None:
        V = v0 @ V
    return w, V
