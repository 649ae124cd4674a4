"""LSQR: Golub-Kahan bidiagonalization least squares with a trust region.

Counterpart of ``optimization_tpu/linalg/lsqr.py``.  Approximately solves

    min_x |A x - b|^2 + lambda |x|^2    s.t.  |x| <= Delta

with one ``A`` and one ``A^T`` application per iteration (Jacobian-vector /
vector-Jacobian products when driven by TNLS) plus scalar plane-rotation
recurrences.  The JAX package compiles the loop into one
``lax.while_loop``; here it is an eager Python loop that reads one stopping
flag back to the host per iteration, and every scalar stays a tensor on
the vectors' device.

Functional contract (reference ``LSQR``, ``IterativeSolvers.h:552-875``):

- the damping plane rotation eliminating sqrt(lambda) and the bidiagonal
  rotation (``IterativeSolvers.h:726-747``);
- incremental estimates |Abar|, cond(Abar) = |Abar| |D|_F, |rbar|,
  |Abar' rbar| (``IterativeSolvers.h:753-818``);
- trust-region steplength clipping so x ends *on* the boundary
  (``IterativeSolvers.h:777-794``; both steplengths are formed and one
  selected, where the JAX package branches with ``lax.cond``);
- stopping tests S1 (residual), S2 (gradient), S3 (conditioning), S4 (trust
  region) (``IterativeSolvers.h:824-841``) and an optional ``user_function``;
- ``rsq``: |b - A x|^2 at the returned x by scalar recurrence (what lets
  TNLS skip an explicit Jacobian product for its model decrease).

As in the JAX package, ``num_iterations`` counts *completed* iterations
(the reference's bookkeeping undercounts by one when a test fires).
Vectors are arbitrary pytrees of tensors; the inner products are injected.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.tree import tree_axpy, tree_scale, tree_where, tree_zeros_like

__all__ = ["LSQRResult", "lsqr"]


class LSQRResult(NamedTuple):
    x: Any
    xnorm: torch.Tensor
    num_iterations: torch.Tensor
    # |b - A x|^2 at the returned x, tracked by scalar recurrence (exact in
    # exact arithmetic, also through the trust-region clip)
    rsq: torch.Tensor


def _validate(lam, btol, Atol, cond_limit) -> None:
    if lam < 0:
        raise ValueError("Tikhonov regularization parameter (lambda) must be "
                         "a nonnegative real value")
    if btol < 0:
        raise ValueError("Stopping tolerance btol must be a nonnegative real number")
    if Atol < 0:
        raise ValueError("Stopping tolerance Atol must be a nonnegative real number")
    if cond_limit <= 0:
        raise ValueError(
            "Stopping tolerance Abar_cond_limit must be a positive real number")


def lsqr(
    A: Callable[[Any], Any],
    At: Callable[[Any], Any],
    b: Any,
    inner_x: Callable[[Any, Any], torch.Tensor],
    inner_y: Optional[Callable[[Any, Any], torch.Tensor]] = None,
    *,
    max_iterations: int = 1000,
    lam: float = 0.0,
    btol=1e-6,
    Atol: float = 1e-6,
    cond_limit: float = 1e8,
    Delta=None,
    user_function: Optional[Callable[..., Any]] = None,
) -> LSQRResult:
    """Run LSQR.  ``Delta`` and ``btol`` may be tensors (TNLS passes its
    radius and its forcing term).

    ``user_function(k, x, xnorm, rbar_norm, Abar_rbar_norm, Abar_norm_est,
    Abar_cond_est) -> bool`` is an optional stopping predicate evaluated at
    the end of each iteration (reference ``LSQRUserFunction``,
    ``IterativeSolvers.h:450-456,843-851``); ``k`` is the 0-based index of
    the iteration just completed.

    ``inner_y`` defaults to ``inner_x`` (``IterativeSolvers.h:859-875``).
    """
    if inner_y is None:
        inner_y = inner_x
    # Python-number arguments are checked here; tensor tolerances (TNLS's
    # forcing term) are checked by their producer
    number = lambda v: v if isinstance(v, (int, float)) else 0.0
    _validate(number(lam), number(btol), number(Atol), cond_limit)

    def safe_div(t, s):
        denom = torch.where(s > 0, s, torch.ones_like(s))
        return tree_scale(1.0 / denom, t)

    # --- initialization (reference IterativeSolvers.h:588-692) ---
    u0 = b
    v0 = At(u0)
    alpha0 = torch.sqrt(inner_x(v0, v0))
    beta0 = torch.sqrt(inner_y(u0, u0))
    dtype, dev = alpha0.dtype, alpha0.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    sqrt_lam = torch.sqrt(lam)
    if Delta is None:
        Delta = math.sqrt(torch.finfo(dtype).max)
    Delta = torch.as_tensor(Delta, dtype=dtype, device=dev)
    btol = torch.as_tensor(btol, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    u = safe_div(u0, beta0)
    has_alpha = alpha0 > 0
    v = tree_where(has_alpha, safe_div(v0, alpha0), v0)
    # the initial alpha came from the unnormalized u = b: a factor of beta
    # too large (reference IterativeSolvers.h:656-664)
    alpha = torch.where(has_alpha & (beta0 > 0), alpha0 / beta0, alpha0)
    w = v
    x = tree_zeros_like(v)
    bnorm = beta0
    rhobar, phibar = alpha, beta0
    cs2, sn2 = -torch.ones((), dtype=dtype, device=dev), zero
    z = res2 = Abar_norm = D_Fnorm2 = xnorm = xxnorm = zero
    rsq = beta0 * beta0            # x = 0: |b - A x|^2 = |b|^2
    # b is already a least-squares solution (A'b = 0): return at once
    stop = alpha * beta0 == 0

    k = 0
    while k < max_iterations and not bool(stop):
        # --- bidiagonalization step (IterativeSolvers.h:706-724) ---
        u_t = tree_axpy(-alpha, u, A(v))
        beta = torch.sqrt(inner_y(u_t, u_t))
        beta_pos = beta > 0
        u_new = safe_div(u_t, beta)
        Abar_norm = torch.where(
            beta_pos,
            torch.sqrt(Abar_norm ** 2 + alpha ** 2 + beta ** 2 + lam),
            Abar_norm)
        v_t = tree_axpy(-beta, v, At(u_new))
        alpha_t = torch.sqrt(inner_x(v_t, v_t))
        v_cand = tree_where(alpha_t > 0, safe_div(v_t, alpha_t), v_t)
        v_new = tree_where(beta_pos, v_cand, v)
        alpha = torch.where(beta_pos, alpha_t, alpha)
        u = tree_where(beta_pos, u_new, u_t)

        # --- rotation eliminating the damping parameter ---
        rhobar1 = torch.sqrt(rhobar ** 2 + lam)
        cs1 = rhobar / rhobar1
        sn1 = sqrt_lam / rhobar1
        psi = sn1 * phibar
        phibar = cs1 * phibar

        # --- rotation eliminating the subdiagonal element beta ---
        rho = torch.sqrt(rhobar1 ** 2 + beta ** 2)
        cs = rhobar1 / rho
        sn = beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        # --- right rotation for the |x| estimate ---
        delta = sn2 * rho
        gammabar = -cs2 * rho
        rhs = phi - delta * z
        zbar = rhs / gammabar
        gamma = torch.sqrt(gammabar ** 2 + theta ** 2)
        cs2 = gammabar / gamma
        sn2 = theta / gamma
        z = rhs / gamma

        # --- x / w update with trust-region clipping
        # (IterativeSolvers.h:777-794): the full step, or the steplength
        # that lands x exactly on the boundary ---
        wk2 = inner_x(w, w)
        dk2 = wk2 / (rho * rho)
        xnorm_full = torch.sqrt(xxnorm + zbar ** 2)
        xxnorm = xxnorm + z * z
        t2 = -theta / rho
        xtx = inner_x(x, x)
        wtx = inner_x(w, x)
        disc = wtx * wtx + wk2 * (Delta * Delta - xtx)
        t1_bnd = (-wtx + torch.sqrt(torch.clamp(disc, min=0.0))) / wk2
        inside = xnorm_full <= Delta
        t1 = torch.where(inside, phi / rho, t1_bnd)
        xnorm = torch.where(inside, xnorm_full, Delta)

        x = tree_axpy(t1, w, x)
        w = tree_axpy(t2, w, v_new)
        v = v_new

        # --- norm / conditioning / residual estimates ---
        D_Fnorm2 = D_Fnorm2 + dk2
        Abar_cond = Abar_norm * torch.sqrt(D_Fnorm2)
        res2 = res2 + psi * psi
        rbar_norm = torch.sqrt(phibar * phibar + res2)
        Abar_rbar_norm = alpha * torch.abs(tau)

        # undamped |b - A x|^2 by recurrence: along the search direction
        # |rbar(x + t w)|^2 = phibar^2 + res2 + (t rho - phi)^2, less the
        # damping term lam |x|^2 (the JAX package's lsqr.py:250-263)
        clip = t1 * rho - phi
        rsq = torch.clamp(phibar * phibar + res2 + clip * clip
                          - lam * xnorm * xnorm, min=0.0)

        # --- stopping tests S1-S4 (IterativeSolvers.h:824-841) ---
        s1 = rbar_norm <= btol * bnorm + Atol * Abar_norm * xnorm
        s2 = Abar_rbar_norm <= Atol * Abar_norm * rbar_norm
        s3 = Abar_cond >= cond_limit
        s4 = xnorm >= Delta
        stop = s1 | s2 | s3 | s4
        if user_function is not None:
            stop = stop | torch.as_tensor(
                user_function(k, x, xnorm, rbar_norm, Abar_rbar_norm,
                              Abar_norm, Abar_cond), device=dev)
        k += 1

    return LSQRResult(x=x, xnorm=xnorm,
                      num_iterations=torch.tensor(k, dtype=torch.int32,
                                                  device=dev),
                      rsq=rsq)
