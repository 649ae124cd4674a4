"""Steihaug-Toint truncated preconditioned *projected* conjugate gradient.

Counterpart of ``optimization_tpu/linalg/stpcg.py`` — same recurrences,
same rotated loop (p_k formed at the top of iteration k), same exits:

- truncation  |r_k|_P <= |r_0|_P * min(kappa_fgr, |r_0|_P^theta)
  (``IterativeSolvers.h:275-291``);
- kernel-of-H escape |H p| / |p| < epsilon with the descent-aligned sign
  (flip p when <p, r> > 0; the adjudicated deviation from
  ``IterativeSolvers.h:320-326`` documented in the JAX package);
- negative-curvature / overlong-step boundary exit with the sigma step;
- the M-norm recurrences, the constraint preconditioner with ``At``, and
  the ``predicted_decrease`` recurrence.

The loop is an eager Python loop; its scalars stay tensors on the
vectors' device, and the loop condition is read back once per iteration.
Vectors are arbitrary pytrees; the caller supplies ``inner``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..core.tree import (tree_axpy, tree_axpy_like, tree_neg, tree_where,
                         tree_zeros_like)

__all__ = ["STPCGResult", "stpcg"]


class STPCGResult(NamedTuple):
    s: Any
    update_step_M_norm: torch.Tensor
    num_iterations: torch.Tensor
    # Predicted model decrease -(<g,s> + 1/2 <s,Hs>) by scalar recurrence
    # (same contract as flat_cg.FlatCGResult.predicted_decrease).
    predicted_decrease: torch.Tensor = None


def _validate(max_iterations, kappa_fgr, theta, epsilon) -> None:
    if max_iterations < 0:
        raise ValueError(
            "Maximum number of iterations (max_iterations) must be a "
            "nonnegative integer")
    if not (0 <= kappa_fgr < 1):
        raise ValueError(
            "Target fractional reduction of the gradient norm (kappa_fgr) "
            "must be a real value in the range [0,1)")
    if not (0 <= theta <= 1):
        raise ValueError(
            "Target superlinear convergence rate (theta) must be a real "
            "value in the range [0,1]")
    if not (0 < epsilon < 1):
        raise ValueError(
            "Relative norm tolerance for declaring a vector to lie in the "
            "kernel of H (epsilon) should be a small positive number in (0,1)")


def stpcg(
    g: Any,
    Hv: Callable[[Any], Any],
    inner: Callable[[Any, Any], torch.Tensor],
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    precon: Optional[Callable[[Any], Tuple[Any, Any]]] = None,
    At: Optional[Callable[[Any], Any]] = None,
    user_function: Optional[Callable[..., Any]] = None,
    epsilon: float = 1e-8,
    fused_dots: bool = False,
) -> STPCGResult:
    """Run STPCG.  ``Delta`` may be a tensor (TNT passes its radius in).

    - ``g``: model gradient (any pytree of tensors).
    - ``Hv(v)``: symmetric model-Hessian operator.
    - ``inner(u, v)``: ambient inner product.
    - ``precon(r) -> (v, lambda)``: optional constraint preconditioner
      (plain SPD preconditioning is lambda = None with no ``At``).
    - ``At(lambda)``: optional constraint-transpose operator.
    - ``user_function(k, s, r, v, p, alpha) -> bool``: optional stopping
      predicate evaluated each iteration before the update is applied.
    - ``fused_dots``: take the per-iteration reductions from the fused
      kernels (``kernels.cg_dots`` for <p,Hp>, <Hp,Hp>, <p,p>, <p,r>;
      ``kernels.axpy_selfdot`` for the residual update and its norm): one
      pass over (p, Hp, r) and one over (Hp, r), in place of a product
      pass and a sum pass per inner product.  Valid
      only for one flat tensor tangent with the plain Euclidean ``inner``
      and no preconditioner.  As in the JAX package the fused dots are
      summed in f32 whatever the vectors' dtype.
    """
    _validate(max_iterations, kappa_fgr, theta, epsilon)
    if fused_dots and (precon is not None
                       or not isinstance(g, torch.Tensor) or g.dim() != 1):
        raise ValueError(
            "fused_dots requires a flat single-array tangent space with no "
            "preconditioner")
    if fused_dots:
        from ..kernels.fused import axpy_selfdot, cg_dots

    def apply_P(r):
        if precon is None:
            return r, r
        v, lam = precon(r)
        if At is not None:
            r = tree_axpy(-1.0, At(lam), r)
        return v, r

    # --- initialization (reference IterativeSolvers.h:207-283) ---
    s = tree_zeros_like(g)
    r = g
    v, r = apply_P(r)
    rv = torch.as_tensor(inner(r, v))
    dtype, device = rv.dtype, rv.device
    Delta = torch.as_tensor(Delta, dtype=dtype, device=device)
    Delta2 = Delta * Delta
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)

    r0_norm = torch.sqrt(rv)
    target_rk_norm = r0_norm * torch.minimum(
        torch.as_tensor(kappa_fgr, dtype=dtype, device=device),
        r0_norm ** theta)

    has_precon = precon is not None
    k = torch.zeros((), dtype=torch.int32, device=device)
    p_prev = tree_zeros_like(v)
    beta = zero
    alpha_prev = zero
    s_M_p_prev = zero
    sk_M_2 = zero
    p_M_2_prev = zero
    mval = zero
    done = torch.zeros((), dtype=torch.bool, device=device)
    boundary = torch.zeros((), dtype=torch.bool, device=device)

    def cond():
        return bool((k < max_iterations) & ~done
                    & (torch.sqrt(rv) > target_rk_norm))

    while cond():
        v_k = v if has_precon else r
        p = tree_axpy_like(beta, p_prev, tree_neg(v_k))
        sk_M_pk = beta * (s_M_p_prev + alpha_prev * p_M_2_prev)
        pk_M_2 = rv + beta * beta * p_M_2_prev

        Hp = Hv(p)
        if fused_dots:
            kappa, Hp_norm2, p_norm2, pr = cg_dots(p, Hp, r)
        else:
            kappa = inner(p, Hp)
            Hp_norm2 = inner(Hp, Hp)
            p_norm2 = inner(p, p)
            pr = inner(p, r)
        in_kernel = torch.sqrt(Hp_norm2) < epsilon * torch.sqrt(p_norm2)

        # descent alignment of a kernel direction: walk +p only if
        # <p, r> < 0 (see module docstring)
        sign = torch.where(in_kernel & (pr > 0), -one, one)
        sk_M_pk_eff = sign * sk_M_pk

        disc = sk_M_pk_eff ** 2 + pk_M_2 * (Delta2 - sk_M_2)
        sigma = (-sk_M_pk_eff + torch.sqrt(torch.clamp(disc, min=0.0))) \
            / pk_M_2

        alpha = rv / kappa
        skplus1_M_2 = sk_M_2 + 2.0 * alpha * sk_M_pk + alpha * alpha * pk_M_2
        bnd = in_kernel | (kappa <= 0) | (skplus1_M_2 > Delta2)

        m_int = mval - 0.5 * alpha * rv
        m_bnd = mval + sigma * sign * pr + 0.5 * sigma * sigma * kappa

        s_boundary = tree_axpy_like(sigma * sign, p, s)
        s_int = tree_axpy_like(alpha, p, s)
        if fused_dots:
            # identity preconditioner: v = r and <r, v> = |r|^2, fused with
            # the residual update in one pass
            r_int, rv_int = axpy_selfdot(alpha, Hp, r)
            v_int = r_int
        else:
            r_int = tree_axpy_like(alpha, Hp, r)
            v_int, r_int = apply_P(r_int)
            rv_int = inner(r_int, v_int)
        beta_next = rv_int / (alpha * kappa)

        if user_function is not None:
            user_stop = torch.as_tensor(
                user_function(k, s, r, v_k, p, alpha), device=device)
        else:
            user_stop = torch.zeros((), dtype=torch.bool, device=device)
        # a user stop fires before the update, on interior steps only
        user_stop = user_stop & ~bnd
        exit_now = bnd | user_stop

        s = tree_where(bnd, s_boundary, tree_where(user_stop, s, s_int))
        r_new = tree_where(exit_now, r, r_int)
        if has_precon:
            v = tree_where(exit_now, v, v_int)
        r = r_new
        p_prev = p
        k = torch.where(exit_now, k, k + 1)
        beta = torch.where(exit_now, zero, beta_next)
        alpha_prev = torch.where(exit_now, alpha_prev, alpha)
        s_M_p_prev = torch.where(exit_now, s_M_p_prev, sk_M_pk)
        sk_M_2 = torch.where(exit_now, sk_M_2, skplus1_M_2)
        p_M_2_prev = torch.where(exit_now, p_M_2_prev, pk_M_2)
        rv = torch.where(exit_now, rv, rv_int)
        mval = torch.where(user_stop, mval, torch.where(bnd, m_bnd, m_int))
        done = exit_now
        boundary = bnd

    update_step_M_norm = torch.where(boundary, Delta, torch.sqrt(sk_M_2))
    return STPCGResult(s=s, update_step_M_norm=update_step_M_norm,
                       num_iterations=k, predicted_decrease=-mval)
