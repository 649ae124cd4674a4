"""Single-synchronization Steihaug-Toint CG engine for flat tangent spaces.

Counterpart of ``optimization_tpu/linalg/flat_cg.py`` (the pair engine
only).  Same functional contract as the reference STPCG
(``LinearAlgebra/IterativeSolvers.h:166-426``): truncation target
|r_k| <= |r_0| min(kappa_fgr, |r_0|^theta), negative-curvature/overlong
boundary exit with the sigma steplength, kernel-of-H escape with descent
alignment, and the |s|/<s,p>/|p| trust-region recurrences.

**Structured operator**: H v = A0(v) + U B (U' v) with A0 an elementwise
linear map, U a tuple of a few (n,) entries, B a (k, k) symmetric coupling.
Each CG iteration is one pass over s/r/p plus ONE group of dot products
(Chronopoulos-Gear kappa, q = Hp recomputed from p and the carried U'p,
s updates merged across iteration pairs); every scalar assembly stays at
moment order <= 2.

In eager PyTorch the loop is a Python loop whose scalars stay tensors on
the vectors' device; the loop condition is read back once per loop body
(one pair of iterations, or one iteration for the single body).

``prec=`` folds an elementwise M^{-1/2} in symmetrically
(:func:`_fold_prec`).

**The s-step engine** (``s_steps >= 2``, or ``solve_mode``;
:func:`_stpcg_flat_sstep`): one reduction group per s CG iterations.  Every
vector a group manipulates lives in the Krylov coefficient space over the
basis {H^i r, H^i p}_{i=0..2s} of its two input vectors; the group's one
set of dots (the moments <H^i r, H^j r>, <H^i r, H^j p>, <H^i p, H^j p>,
i + j <= 2s, and the low-rank dots U'(A0^j r), U'(A0^j p)) gives every
scalar CG needs for its s steps as small bilinear forms, and one pass then
materializes the committed r, p and s update, H-chains them and
accumulates the next group's dots.  Step 0 of a group has the full
reference semantics; a later step is taken only when it is provably an
interior step with a well-conditioned scalar assembly (else the group
commits the steps before it: "demotion", semantically invisible).  In the
eager port the loop reads its stopping flag once per group.  The JAX
package's record of this engine (slower than the pair engine wherever it
was tried) is a TPU measurement.  ``solve_mode`` runs it as a plain
truncated-CG linear solver: a curvature or kernel breakdown stops at the
current iterate instead of stepping to the boundary.

Storage-dtype generic: vectors may be bf16; every dot accumulates in (at
least) f32 and every stored output casts back to the storage dtype.

The sphere Rayleigh-quotient Hessian fits the contract through its
symmetrization  P H P = A0 + U B U'  with  A0 = 2A - rq I,  U = (x, 2Ax),
B = [[2 rq, -1], [-1, 0]]  (:func:`sphere_rayleigh_flat`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["FlatCGResult", "FlatCGInit", "stpcg_flat", "flat_init_dots",
           "sphere_rayleigh_flat", "sphere_rayleigh_step", "SphereStepAux"]


class FlatCGResult(NamedTuple):
    s: torch.Tensor
    update_step_M_norm: torch.Tensor
    num_iterations: torch.Tensor
    # Predicted model decrease  -(<g,s> + 1/2 <s,Hs>)  tracked by scalar
    # recurrence — algebraically the reference's explicit
    # dm = -<g,h> - 1/2 <h,Hh>  (TNT.h:511-521), at no extra Hessian
    # application.
    predicted_decrease: torch.Tensor


def _acc_dt(x):
    return torch.promote_types(x.dtype, torch.float32)


def _dot(a, b):
    dt = torch.promote_types(_acc_dt(a), _acc_dt(b))
    return torch.sum(a.to(dt) * b.to(dt))


class _UEntry(NamedTuple):
    """A normalized low-rank vector: ``mat()`` materializes it, ``dot(v)``
    computes ``<u, v>`` in f32+, and ``mat_scaled(c)`` materializes
    ``c * u`` (for ``(base, elem_fn)`` entries as ``elem_fn(c * base)``)."""
    mat: Callable[[], torch.Tensor]
    dot: Callable[[torch.Tensor], torch.Tensor]
    mat_scaled: Callable[[torch.Tensor], torch.Tensor]


def _norm_U(U, B, sdt, device):
    """Normalize the low-rank term to (tuple of :class:`_UEntry`, B).

    Accepted entry forms:
    - an (n,) tensor;
    - a nullary callable returning the vector;
    - a ``(base, elem_fn)`` pair with ``elem_fn`` a LINEAR, SELF-ADJOINT,
      ELEMENTWISE map: the entry is ``u = elem_fn(base)``, and every dot
      uses the adjoint identity ``<u, v> = <base, elem_fn(v)>``."""
    if U is None or len(U) == 0:
        return (), torch.zeros((0, 0), dtype=sdt, device=device)

    def norm(u):
        if isinstance(u, _UEntry):      # idempotent
            return u
        if isinstance(u, tuple):
            base, elem = u
            return _UEntry(mat=lambda: elem(base),
                           dot=lambda v: _dot(base, elem(v)),
                           mat_scaled=lambda c: elem(
                               c * base.to(_acc_dt(base))))
        if callable(u):
            return _UEntry(mat=u, dot=lambda v: _dot(u(), v),
                           mat_scaled=lambda c: c * u().to(_acc_dt(u())))
        return _UEntry(mat=lambda: u, dot=lambda v: _dot(u, v),
                       mat_scaled=lambda c: c * u.to(_acc_dt(u)))

    return (tuple(norm(u) for u in U),
            torch.as_tensor(B, dtype=sdt, device=device))


class FlatCGInit(NamedTuple):
    """The pair engine's init reduction group over r0 = g (see
    :func:`flat_init_dots`); supplying it to :func:`stpcg_flat` removes
    every pre-loop pass and reduction from the engine."""

    rv: torch.Tensor           # <g, g>
    ar: torch.Tensor           # <A0 g, g>
    nr: torch.Tensor           # |A0 g|^2
    m: torch.Tensor            # U' g                 (k,)
    mA: torch.Tensor           # U' (A0 g)            (k,)
    UU: torch.Tensor           # U' U                 (k, k)


def flat_init_dots(g, A0, U, B=None) -> FlatCGInit:
    """Compute the pair engine's init dot group for ``stpcg_flat(init=)``:
    exactly the reductions ``_stpcg_flat_pair`` runs before its loop (same
    helper, same accumulation dtypes), so threading the result through
    ``init=`` is numerically invisible."""
    sdt = _acc_dt(g)
    if U is not None and len(U) and B is None:
        raise ValueError("flat_init_dots: B is required when U is "
                         "non-empty (same contract as stpcg_flat)")
    U, B = _norm_U(U, B, sdt, g.device)
    k_lr = len(U)

    def Udots(v):
        if k_lr == 0:
            return torch.zeros((0,), dtype=sdt, device=g.device)
        return torch.stack([u.dot(v) for u in U])

    A0g = A0(g).to(sdt)
    UU = (torch.stack([Udots(u.mat()) for u in U]) if k_lr
          else torch.zeros((0, 0), dtype=sdt, device=g.device))
    return FlatCGInit(rv=_dot(g, g), ar=_dot(A0g, g), nr=_dot(A0g, A0g),
                      m=Udots(g), mA=Udots(A0g), UU=UU)


class _PairState(NamedTuple):
    """Three n-vectors (s, r, p) plus the carried dot group and scalar
    recurrences (see ``optimization_tpu/linalg/flat_cg.py:_PairState``)."""

    k: torch.Tensor
    s: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor            # p_{k-1}
    rv: torch.Tensor           # <r_k, r_k>
    ar: torch.Tensor           # <A0 r_k, r_k>
    nr: torch.Tensor           # |A0 r_k|^2
    m: torch.Tensor            # U' r_k               (k_lr,)
    mA: torch.Tensor           # U' (A0 r_k)          (k_lr,)
    pa: torch.Tensor           # <A0 r_k, A0 p_{k-1}>
    mB: torch.Tensor           # U' (A0 p_{k-1})      (k_lr,)
    nAp: torch.Tensor          # |A0 p_{k-1}|^2
    mp: torch.Tensor           # U' p_{k-1}           (k_lr,)
    rv_prev: torch.Tensor
    alpha_prev: torch.Tensor
    pr: torch.Tensor           # <p_{k-1}, r_{k-1}>
    kappa_prev: torch.Tensor
    s_p: torch.Tensor          # <s_{k-1}, p_{k-1}>
    sk2: torch.Tensor          # |s_k|^2
    pp_prev: torch.Tensor      # |p_{k-1}|^2
    mval: torch.Tensor         # model value <g,s_k> + 1/2 <s_k, H s_k>
    done: torch.Tensor
    boundary: torch.Tensor


def _stpcg_flat_pair(
    g: torch.Tensor,
    A0: Callable[[torch.Tensor], torch.Tensor],
    U,
    B,
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    init: Optional[FlatCGInit] = None,
    body_kind: str = "auto",
    kernel_check: bool = True,
) -> FlatCGResult:
    """The pair-deferred engine: one pass + one dot group per CG iteration
    (s updates merged across iteration pairs, q = Hp recomputed from p,
    Chronopoulos-Gear kappa).  ``init`` supplies the pre-loop dot group;
    ``kernel_check=False`` drops the kernel-of-H safeguard (see the JAX
    engine's docstring for the exact semantics delta)."""
    dtype = g.dtype
    dev = g.device
    sdt = _acc_dt(g)

    U, B = _norm_U(U, B, sdt, dev)
    k_lr = len(U)

    Delta = torch.as_tensor(Delta, dtype=sdt, device=dev)
    Delta2 = Delta * Delta
    zero = torch.zeros((), dtype=sdt, device=dev)
    one = torch.ones((), dtype=sdt, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    tiny = torch.finfo(sdt).tiny

    def Udots(v):
        if k_lr == 0:
            return torch.zeros((0,), dtype=sdt, device=dev)
        return torch.stack([u.dot(v) for u in U])

    def H_of(v, mv):
        """H v given mv = U'v."""
        out = A0(v).to(sdt)
        if k_lr:
            c = B @ mv
            for j in range(k_lr):
                out = out + U[j].mat_scaled(c[j]).to(sdt)
        return out

    r0 = g
    if init is None:
        init = flat_init_dots(g, A0, U, B)
    rv0, ar0, nr0, m0, mA0 = init.rv, init.ar, init.nr, init.m, init.mA

    r0_norm = torch.sqrt(rv0)
    target = r0_norm * torch.minimum(
        torch.as_tensor(kappa_fgr, dtype=sdt, device=dev), r0_norm ** theta)

    st = _PairState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        s=torch.zeros_like(g), r=r0, p=torch.zeros_like(g),
        rv=rv0, ar=ar0, nr=nr0, m=m0, mA=mA0,
        pa=zero, mB=torch.zeros((k_lr,), dtype=sdt, device=dev), nAp=zero,
        mp=torch.zeros((k_lr,), dtype=sdt, device=dev),
        rv_prev=zero, alpha_prev=one,
        pr=zero, kappa_prev=one,
        s_p=zero, sk2=zero, pp_prev=zero, mval=zero,
        done=false, boundary=false,
    )

    eps2 = torch.as_tensor(epsilon, dtype=sdt, device=dev) ** 2
    UU = init.UU

    def cond(st: _PairState) -> bool:
        return bool((st.k < max_iterations) & ~st.done
                    & (torch.sqrt(st.rv) > target))

    def half(st: _PairState, pend, apply_s: bool):
        """One CG iteration.  ``s`` is touched only in the applying half:
        the deferring half returns its step coefficient as ``pend`` and the
        applying half folds ``pend * p_prev`` into its own s update.
        ``frozen`` gates everything, so exits fire with identical semantics
        whichever half they land in."""
        frozen = (st.done | (st.k >= max_iterations)
                  | (torch.sqrt(st.rv) <= target))

        first = st.rv_prev == 0
        beta = torch.where(first, zero,
                           st.rv / torch.where(first, one, st.rv_prev))

        Bm = B @ st.m
        wr = st.ar + st.m @ Bm
        kappa = wr - (beta / st.alpha_prev) * st.rv

        pp_k = st.rv + beta * beta * st.pp_prev
        pr_k = -st.rv + beta * (st.pr + st.alpha_prev * st.kappa_prev)
        sp_k = beta * (st.s_p + st.alpha_prev * st.pp_prev)

        if kernel_check:
            Bmp = B @ st.mp
            ww = st.nr + 2.0 * (st.mA @ Bm) + Bm @ (UU @ Bm)
            wq = st.pa + st.mA @ Bmp + Bm @ st.mB + Bm @ (UU @ Bmp)
            qq_prev = st.nAp + 2.0 * (st.mB @ Bmp) + Bmp @ (UU @ Bmp)
            qq_k = ww - 2.0 * beta * wq + beta * beta * qq_prev
            in_kernel = qq_k < eps2 * pp_k
            sign = torch.where(in_kernel & (pr_k > 0), -one, one)
        else:
            in_kernel = false
            sign = one
        sp_eff = sign * sp_k
        disc = sp_eff * sp_eff + pp_k * (Delta2 - st.sk2)
        sigma = ((-sp_eff + torch.sqrt(torch.clamp(disc, min=0.0)))
                 / torch.clamp(pp_k, min=tiny))

        alpha = st.rv / kappa
        sk2_next = st.sk2 + 2.0 * alpha * sp_k + alpha * alpha * pp_k
        boundary = (in_kernel | (kappa <= 0) | (sk2_next > Delta2)) & ~frozen

        cs = torch.where(boundary, sigma * sign, alpha)
        cs = torch.where(frozen, zero, cs)
        cr = torch.where(boundary | frozen, zero, alpha)

        m_int = st.mval - 0.5 * alpha * st.rv
        m_bnd = st.mval + sigma * sign * pr_k + 0.5 * sigma * sigma * kappa
        m_new = torch.where(frozen, st.mval,
                            torch.where(boundary, m_bnd, m_int))

        mp_k = -st.m + beta * st.mp

        # --- THE pass: form p, recompute q = H p, update r (and s in the
        # applying half), accumulate the dot group ---
        p2 = -st.r.to(sdt) + beta * st.p.to(sdt)
        q2 = H_of(p2, mp_k)
        r2 = (st.r.to(sdt) + cr * q2).to(dtype)
        if apply_s:
            s2 = (st.s.to(sdt) + pend * st.p.to(sdt) + cs * p2).to(dtype)
            pend_out = zero
        else:
            s2 = st.s
            pend_out = cs
        p2 = p2.to(dtype)

        mB2 = -st.mA + beta * st.mB
        m2 = st.m + cr * (mB2 + (UU @ (B @ mp_k) if k_lr else mB2 * 0))
        A0r2 = A0(r2).to(sdt)
        rv2 = _dot(r2, r2)
        ar2 = _dot(A0r2, r2)
        mA2 = Udots(A0r2)
        if kernel_check:
            A0p2 = A0(p2).to(sdt)
            nr2 = _dot(A0r2, A0r2)
            pa2 = _dot(A0r2, A0p2)
            nAp2 = st.nr - 2.0 * beta * st.pa + beta * beta * st.nAp
        else:
            nr2 = pa2 = nAp2 = zero

        exit_now = boundary | frozen

        return _PairState(
            k=torch.where(exit_now, st.k, st.k + 1),
            s=s2,
            r=torch.where(exit_now, st.r, r2),
            p=p2,
            rv=torch.where(exit_now, st.rv, rv2),
            ar=ar2, nr=nr2, m=m2, mA=mA2,
            pa=pa2, mB=mB2, nAp=nAp2, mp=mp_k,
            rv_prev=torch.where(exit_now, st.rv_prev, st.rv),
            alpha_prev=torch.where(exit_now, st.alpha_prev, alpha),
            pr=torch.where(exit_now, st.pr, pr_k),
            kappa_prev=torch.where(exit_now, st.kappa_prev, kappa),
            s_p=torch.where(exit_now, st.s_p, sp_k),
            sk2=torch.where(exit_now, st.sk2, sk2_next),
            pp_prev=torch.where(exit_now, st.pp_prev, pp_k),
            mval=m_new,
            done=st.done | boundary,
            boundary=torch.where(frozen, st.boundary, boundary),
        ), pend_out

    # "auto" is the pair body: the JAX engine's TPU residency rule
    # (resolve_body) is a TPU measurement and does not carry over.
    if body_kind not in ("auto", "single", "pair"):
        raise ValueError('body_kind must be "auto", "single" or "pair"')
    while cond(st):
        if body_kind == "single":
            st, _ = half(st, zero, apply_s=True)
        else:
            st, pend = half(st, zero, apply_s=False)
            st, _ = half(st, pend, apply_s=True)

    update_step_M_norm = torch.where(st.boundary, Delta, torch.sqrt(st.sk2))
    return FlatCGResult(s=st.s, update_step_M_norm=update_step_M_norm,
                        num_iterations=st.k,
                        predicted_decrease=-st.mval)


def _fold_prec(g, A0, U, B, prec, sdt):
    """Symmetric preconditioner folding: the change of variables s = P shat
    with P = ``prec`` (an elementwise, linear, self-adjoint, positive map
    applying M^{-1/2}) turns the M-preconditioned trust-region subproblem
    into a plain one over

        ghat = P g,   A0hat = P A0 P,   Uhat_j = P U_j.

    Euclidean norms in the transformed space are the reference's
    preconditioned norms: |rhat| = |r|_{M^{-1}} (the truncation norm,
    ``IterativeSolvers.h:275-291``) and |shat| = |s|_M (the trust-region /
    step norm, ``IterativeSolvers.h:388-420``), so the unmodified engine on
    the transformed data runs the reference's preconditioned STPCG."""
    U, B = _norm_U(U, B, sdt, g.device)

    def wrap(u: _UEntry) -> _UEntry:
        # self-adjointness: <P u, v> = <u, P v>, so the transformed dot
        # reuses the entry's own (possibly adjoint-form) reduction
        return _UEntry(mat=lambda: prec(u.mat()),
                       dot=lambda v: u.dot(prec(v)),
                       mat_scaled=lambda c: prec(u.mat_scaled(c)))

    ghat = prec(g.to(sdt)).to(g.dtype)
    A0hat = lambda v: prec(A0(prec(v)).to(sdt))
    return ghat, A0hat, tuple(wrap(u) for u in U), B


def stpcg_flat(
    g: torch.Tensor,
    A0: Callable[[torch.Tensor], torch.Tensor],
    U,
    B,
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    s_steps: int = 1,
    solve_mode: bool = False,
    init: Optional[FlatCGInit] = None,
    body_kind: str = "auto",
    kernel_check: bool = True,
    prec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> FlatCGResult:
    """Approximately solve  min <g,s> + 1/2 <s, Hs>  s.t. |s| <= Delta  for
    H = A0 + U B U', with STPCG truncation/boundary/kernel semantics.

    - ``A0``: elementwise *linear* operator on (n,) tensors.
    - ``U``: tuple of (n,) tensors, nullary callables, or
      ``(base, elem_fn)`` adjoint-form pairs; ``B``: (k, k) symmetric.
      Pass None/None for a purely elementwise Hessian.
    - ``body_kind``: ``"auto"`` (default) is ``"pair"`` — two iterations
      per loop body with the s update deferred across them; ``"single"``
      applies s every iteration.  Same semantics; the JAX package's
      ``"auto"`` choice followed a TPU memory boundary that does not carry
      over, so the port always takes the pair body.
    - ``init``: optional :class:`FlatCGInit` computed in an earlier pass
      (e.g. a TNT ``step_eval``); the engine then runs no pre-loop pass.
    - ``kernel_check=False`` drops the kernel-of-H epsilon safeguard.
    - ``prec``: optional elementwise, linear, self-adjoint, positive map
      applying M^{-1/2}, folded in symmetrically (:func:`_fold_prec`):
      truncation runs in |.|_{M^{-1}}, the trust region and the reported
      step norm in |.|_M, and the kernel-of-H safeguard tests the folded
      operator P H P.  Incompatible with ``init=`` (its dot group is
      computed in untransformed coordinates).
    - ``s_steps >= 2`` selects the s-step engine (s capped at 3);
      ``solve_mode`` (either s) runs it as a plain truncated-CG linear
      solver for H s = -g (pass ``g = -rhs``, read the solution from
      ``s``; use ``Delta = inf`` and ``theta = 0`` for the plain
      relative-residual target ``kappa_fgr |r0|``).  Neither takes
      ``init=`` or ``kernel_check=False``.
    """
    if prec is not None:
        if init is not None:
            raise ValueError(
                "init= (the precomputed pre-loop dot group) is computed in "
                "untransformed coordinates and cannot be combined with "
                "prec=; compute the group on the transformed data instead")
        sdt = _acc_dt(g)
        ghat, A0hat, Uhat, Bhat = _fold_prec(g, A0, U, B, prec, sdt)
        res = stpcg_flat(ghat, A0hat, Uhat, Bhat, Delta,
                         max_iterations=max_iterations, kappa_fgr=kappa_fgr,
                         theta=theta, epsilon=epsilon, s_steps=s_steps,
                         solve_mode=solve_mode, body_kind=body_kind,
                         kernel_check=kernel_check)
        # un-transform the step; the M-norm and model decrease already are
        # the reference's preconditioned quantities (see _fold_prec)
        return res._replace(s=prec(res.s.to(sdt)).to(g.dtype))
    if s_steps <= 1 and not solve_mode:
        return _stpcg_flat_pair(g, A0, U, B, Delta,
                                max_iterations=max_iterations,
                                kappa_fgr=kappa_fgr, theta=theta,
                                epsilon=epsilon, init=init,
                                body_kind=body_kind,
                                kernel_check=kernel_check)
    if init is not None:
        raise ValueError(
            "init= (the precomputed pre-loop dot group) is only supported "
            "by the pair engine (s_steps=1, solve_mode=False); the s-step "
            "engine's init set is the depth-2S moment/low-rank group")
    if not kernel_check:
        raise ValueError(
            "kernel_check=False is a pair-engine optimization (s_steps=1, "
            "solve_mode=False); the s-step engine keeps the safeguard")
    return _stpcg_flat_sstep(g, A0, U, B, Delta,
                             max_iterations=max_iterations,
                             kappa_fgr=kappa_fgr, theta=theta,
                             epsilon=epsilon, s_steps=s_steps,
                             solve_mode=solve_mode)


# A step-t (t >= 1) scalar assembly is trusted only if the surviving value
# exceeds this fraction of the absolute mass of its terms; below it the
# step is demoted to the next group's honest dots.
CANCEL_GUARD = 1e-4


class _State(NamedTuple):
    """Three n-vectors (s, r, p), the honest dot set of the previous pass,
    and the scalar recurrences."""

    k: torch.Tensor
    s: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    h: torch.Tensor            # (2s+1, 3) moments [<.,.>_rr, _rp, _pp]
    a: torch.Tensor            # (2s, 2, k) U'(A0^j r), U'(A0^j p)
    rv_prev: torch.Tensor      # <r,r> of the previous committed iterate
    alpha_prev: torch.Tensor
    s_p: torch.Tensor          # <s, p> after the last committed step
    sk2: torch.Tensor          # |s|^2
    mval: torch.Tensor         # model value <g,s> + 1/2 <s,Hs>
    done: torch.Tensor
    boundary: torch.Tensor


def _stpcg_flat_sstep(
    g: torch.Tensor,
    A0: Callable[[torch.Tensor], torch.Tensor],
    U,
    B,
    Delta,
    *,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    s_steps: int = 2,
    solve_mode: bool = False,
) -> FlatCGResult:
    """The s-step coefficient-space engine (module docstring); dispatched
    from :func:`stpcg_flat` for s_steps >= 2 and for solve_mode at s = 1.

    The coefficient vectors are Python lists whose structurally zero
    entries are the one ``zero`` object, so every bilinear form and
    materialization skips them (the JAX engine prunes the same terms at
    trace time).  The planning scalars stay tensors on the vectors'
    device; the loop reads its condition once per group."""
    dtype, dev = g.dtype, g.device
    sdt = _acc_dt(g)
    S = max(1, min(int(s_steps), 3))
    K = 2 * S                   # max H-power whose moments are carried
    dim = 2 * (K + 1)           # coefficient basis {H^i r}_{0..K} + {H^i p}

    U, B = _norm_U(U, B, sdt, dev)
    k_lr = len(U)

    Delta = torch.as_tensor(Delta, dtype=sdt, device=dev)
    Delta2 = Delta * Delta
    zero = torch.zeros((), dtype=sdt, device=dev)
    one = torch.ones((), dtype=sdt, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    ione = torch.ones((), dtype=torch.int32, device=dev)
    eps2 = torch.as_tensor(epsilon, dtype=sdt, device=dev) ** 2
    guard = torch.as_tensor(CANCEL_GUARD, dtype=sdt, device=dev)
    tiny = torch.finfo(sdt).tiny

    def Udots(v):
        """U' v accumulated in f32+: (k,)."""
        if k_lr == 0:
            return torch.zeros((0,), dtype=sdt, device=dev)
        return torch.stack([u.dot(v) for u in U])

    def lowrank(c):
        """U B c as a vector."""
        out = None
        if k_lr:
            d = B @ c
            for j in range(k_lr):
                term = d[j] * U[j].mat().to(sdt)
                out = term if out is None else out + term
        return out

    def H_of(v, uv):
        """H v = A0 v + U B (U'v) given the carried/recurred scalar U'v."""
        out = A0(v).to(sdt)
        lr = lowrank(uv)
        return out if lr is None else out + lr

    # --- k x k couplings G_j = U'(A0^j U), j <= K-2 (setup-only dots) ---
    if k_lr:
        Gs = []
        cols = [u.mat().to(sdt) for u in U]
        for _ in range(max(K - 1, 1)):
            # [i, l] = u_i' A0^j u_l
            Gs.append(torch.stack([Udots(c) for c in cols]).T)
            cols = [A0(c).to(sdt) for c in cols]
    else:
        Gs = [torch.zeros((0, 0), dtype=sdt, device=dev)] * max(K - 1, 1)

    def u_chain(a_v):
        """u_m = U'(H^m v) for m <= K-1 from honest a_j = U'(A0^j v):
        c_{i,0} = a_i,  c_{i,m} = c_{i+1,m-1} + G_i B c_{0,m-1}."""
        c = {(i, 0): a_v[i] for i in range(K)}
        for m in range(1, K):
            for i in range(K - m):
                c[(i, m)] = c[(i + 1, m - 1)] + Gs[i] @ (B @ c[(0, m - 1)])
        return [c[(0, m)] for m in range(K)]

    # --- coefficient-space helpers (length-dim lists over the basis) ---
    def basis(i, block):
        e = [zero] * dim
        e[block * (K + 1) + i] = one
        return e

    def shift(co):
        """Coefficients of H * (the vector with coefficients co)."""
        out = [zero] * dim
        for b in range(2):
            for i in range(K):
                out[b * (K + 1) + i + 1] = co[b * (K + 1) + i]
        return out

    def axpy_co(a_, x_co, y_co):
        out = []
        for x_, y_ in zip(x_co, y_co):
            if x_ is zero:
                out.append(y_)
            elif y_ is zero:
                out.append(a_ * x_)
            else:
                out.append(a_ * x_ + y_)
        return out

    def scale_co(a_, x_co):
        return [zero if x_ is zero else a_ * x_ for x_ in x_co]

    def where_co(c, x_co, y_co):
        return [zero if (x_ is zero and y_ is zero)
                else torch.where(c, x_, y_) for x_, y_ in zip(x_co, y_co)]

    def mom_entry(h, i, j, b1, b2, absval=False):
        m = i + j
        if m > K:
            return zero  # only reachable with a zero coefficient
        col = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (1, 1): 2}[(b1, b2)]
        v = h[m, col]
        return torch.abs(v) if absval else v

    def bilin(h, x_co, y_co, absval=False):
        """x' Gram y over the basis; absval=True gives the absolute mass
        |x|' |Gram| |y| of the cancellation guard."""
        tot = zero
        for ia in range(dim):
            b1, i = divmod(ia, K + 1)
            if x_co[ia] is zero:
                continue
            for ja in range(dim):
                b2, j = divmod(ja, K + 1)
                if y_co[ja] is zero or i + j > K:
                    continue
                xa = torch.abs(x_co[ia]) if absval else x_co[ia]
                ya = torch.abs(y_co[ja]) if absval else y_co[ja]
                term = xa * ya * mom_entry(h, i, j, b1, b2, absval)
                tot = term if tot is zero else tot + term
        return tot

    # --- initialization: honest dot set of (r0 = g, p_{-1} = 0) ---
    r0 = g
    r0f = r0.to(sdt)
    Vr = [r0f]
    for m in range(S):
        Vr.append(H_of(Vr[m], Udots(Vr[m])))
    h0 = []
    for m in range(K + 1):
        i = min(m, S)
        h0.append(torch.stack([_dot(Vr[i], Vr[m - i]), zero, zero]))
    h0 = torch.stack(h0)                                # (K+1, 3)
    a0 = []
    acc = r0f
    for _ in range(K):
        a0.append(torch.stack([Udots(acc),
                               torch.zeros((k_lr,), dtype=sdt, device=dev)]))
        acc = A0(acc).to(sdt)
    a0 = torch.stack(a0)

    rv0 = h0[0, 0]
    r0_norm = torch.sqrt(rv0)
    target = r0_norm * torch.minimum(
        torch.as_tensor(kappa_fgr, dtype=sdt, device=dev), r0_norm ** theta)
    target2 = target * target

    st = _State(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        s=torch.zeros_like(g), r=r0, p=torch.zeros_like(g),
        h=h0, a=a0,
        rv_prev=zero, alpha_prev=one,
        s_p=zero, sk2=zero, mval=zero,
        done=false, boundary=false,
    )

    def cond(st: _State) -> bool:
        return bool((st.k < max_iterations) & ~st.done
                    & (st.h[0, 0] > target2))

    def body(st: _State) -> _State:
        h = st.h
        # ---------- scalar phase: plan up to S steps in coefficient space
        r_co = basis(0, 0)
        p_prev_co = basis(0, 1)
        rv = h[0, 0]
        rv_prev = st.rv_prev
        alpha_prev = st.alpha_prev
        pp_prev = h[0, 2]
        s_p, sk2, mval = st.s_p, st.sk2, st.mval

        committed = true
        n_comm = izero
        exit_boundary = false
        out_r_co, out_p_co = r_co, p_prev_co
        out_sadd_co = [zero] * dim
        out_rv, out_rvp = rv, rv_prev
        out_ap = alpha_prev
        out_sp, out_sk2, out_mval = s_p, sk2, mval

        for t in range(S):
            first = rv_prev == 0
            beta = torch.where(first, zero,
                               rv / torch.where(first, one, rv_prev))
            p_co = axpy_co(beta, p_prev_co, scale_co(-one, r_co))
            Sp_co = shift(p_co)
            kappa = bilin(h, p_co, Sp_co)
            qq = bilin(h, Sp_co, Sp_co)
            ppn = bilin(h, p_co, p_co)
            pr = bilin(h, p_co, r_co)

            in_kernel = qq < eps2 * ppn
            sign = torch.where(in_kernel & (pr > 0), -one, one)
            sp_t = beta * (s_p + alpha_prev * pp_prev)
            sp_eff = sign * sp_t
            disc = sp_eff * sp_eff + ppn * (Delta2 - sk2)
            sigma = ((-sp_eff + torch.sqrt(torch.clamp(disc, min=0.0)))
                     / torch.clamp(ppn, min=tiny))
            if solve_mode:
                sigma = zero   # breakdown => stop at the current iterate

            alpha = rv / kappa
            sk2_next = sk2 + 2.0 * alpha * sp_t + alpha * alpha * ppn
            boundary_t = in_kernel | (kappa <= 0) | (sk2_next > Delta2)

            r_next_co = axpy_co(alpha, Sp_co, r_co)
            rv_next = bilin(h, r_next_co, r_next_co)

            if t == 0:
                # full reference semantics: an interior step, or the sigma
                # step to the boundary (kernel escape sign included) and exit
                take_int = committed & ~boundary_t
                take_bnd = committed & boundary_t
                coeff = torch.where(take_bnd, sigma * sign,
                                    torch.where(take_int, alpha, zero))
                out_sadd_co = axpy_co(coeff, p_co, out_sadd_co)
                out_p_co = p_co
                out_r_co = where_co(take_int, r_next_co, out_r_co)
                out_rv = torch.where(take_int, rv_next, out_rv)
                out_rvp = torch.where(take_int, rv, out_rvp)
                out_ap = torch.where(take_int, alpha, out_ap)
                # carried <s,p>: the before-step value of the last formed p
                out_sp = torch.where(take_int, sp_t, out_sp)
                out_sk2 = torch.where(
                    take_int, sk2_next,
                    torch.where(take_bnd, sk2 + 2.0 * sigma * sp_eff
                                + sigma * sigma * ppn, out_sk2))
                out_mval = torch.where(
                    take_int, mval - 0.5 * alpha * rv,
                    torch.where(take_bnd, mval + sigma * sign * pr
                                + 0.5 * sigma * sigma * kappa, out_mval))
                n_comm = n_comm + torch.where(take_int, ione, izero)
                exit_boundary = take_bnd
                committed = take_int
            else:
                # interior-only: demote on any exit condition, the
                # iteration limit, truncation, or heavy cancellation
                trunc = rv <= target2
                over = st.k + t + 1 > max_iterations
                kap_mass = bilin(h, p_co, Sp_co, absval=True)
                qq_mass = bilin(h, Sp_co, Sp_co, absval=True)
                rv_mass = bilin(h, r_next_co, r_next_co, absval=True)
                shaky = ((torch.abs(kappa) < guard * kap_mass)
                         | (qq < guard * qq_mass)
                         | (rv_next < guard * rv_mass))
                take = committed & ~(boundary_t | trunc | over | shaky)
                # select after the product: planning coefficients can be
                # inf/NaN when step 0 exited, and 0 * NaN would poison
                out_sadd_co = where_co(take,
                                       axpy_co(alpha, p_co, out_sadd_co),
                                       out_sadd_co)
                out_p_co = where_co(take, p_co, out_p_co)
                out_r_co = where_co(take, r_next_co, out_r_co)
                out_rv = torch.where(take, rv_next, out_rv)
                out_rvp = torch.where(take, rv, out_rvp)
                out_ap = torch.where(take, alpha, out_ap)
                out_sp = torch.where(take, sp_t, out_sp)
                out_sk2 = torch.where(take, sk2_next, out_sk2)
                out_mval = torch.where(take, mval - 0.5 * alpha * rv,
                                       out_mval)
                n_comm = n_comm + torch.where(take, ione, izero)
                committed = take

            # advance the planning scalars for the next t
            mval = mval - 0.5 * alpha * rv
            rv_prev, rv = rv, rv_next
            alpha_prev = alpha
            pp_prev = ppn
            s_p = sp_t
            sk2 = sk2_next
            r_co, p_prev_co = r_next_co, p_co

        # ---------- the pass: materialize the outputs, H-chain them, and
        # accumulate the next honest dot set
        u_r = u_chain([st.a[j, 0] for j in range(K)])
        u_p = u_chain([st.a[j, 1] for j in range(K)])

        Vr = [st.r.to(sdt)]
        Vp = [st.p.to(sdt)]
        for m in range(S):
            Vr.append(H_of(Vr[m], u_r[m]))
            Vp.append(H_of(Vp[m], u_p[m]))

        def u_of(co, i=0):
            """U' (H^i x_co) by exact recurrence (no reduction)."""
            tot = torch.zeros((k_lr,), dtype=sdt, device=dev)
            for m in range(S + 1):
                for b, u_ch in ((0, u_r), (1, u_p)):
                    cmb = co[b * (K + 1) + m]
                    if cmb is zero:
                        continue
                    assert m + i < K, "Krylov support exceeded"
                    tot = tot + cmb * u_ch[m + i]
            return tot

        def mat(co):
            """Materialize a coefficient vector (support <= S)."""
            tot = None
            for m in range(S + 1):
                for b, V in ((0, Vr), (1, Vp)):
                    cmb = co[b * (K + 1) + m]
                    if cmb is zero:
                        continue
                    term = cmb * V[m]
                    tot = term if tot is None else tot + term
            return tot if tot is not None else torch.zeros_like(Vr[0])

        R0 = mat(out_r_co)
        P0 = mat(out_p_co)
        s_new = (st.s.to(sdt) + mat(out_sadd_co)).to(dtype)

        # H-chains of the outputs to depth S (U-dots by exact recurrence)
        Rch = [R0]
        Pch = [P0]
        for i in range(S):
            Rch.append(H_of(Rch[i], u_of(out_r_co, i)))
            Pch.append(H_of(Pch[i], u_of(out_p_co, i)))

        h_new = []
        for m in range(K + 1):
            i = min(m, S)
            j = m - i
            h_new.append(torch.stack([
                _dot(Rch[i], Rch[j]),
                _dot(Rch[i], Pch[j]),
                _dot(Pch[i], Pch[j]),
            ]))
        h_new = torch.stack(h_new)

        a_rows = []
        accR, accP = R0, P0
        for j in range(K):
            a_rows.append(torch.stack([Udots(accR), Udots(accP)]))
            if j + 1 < K:
                accR = A0(accR).to(sdt)
                accP = A0(accP).to(sdt)

        return _State(
            k=st.k + n_comm,
            s=s_new, r=R0.to(dtype), p=P0.to(dtype),
            h=h_new, a=torch.stack(a_rows),
            rv_prev=out_rvp, alpha_prev=out_ap,
            s_p=out_sp, sk2=out_sk2, mval=out_mval,
            done=st.done | exit_boundary,
            boundary=st.boundary | exit_boundary,
        )

    while cond(st):
        st = body(st)

    update_step_M_norm = torch.where(st.boundary, Delta, torch.sqrt(st.sk2))
    return FlatCGResult(s=st.s, update_step_M_norm=update_step_M_norm,
                        num_iterations=st.k,
                        predicted_decrease=-st.mval)


class SphereStepAux(NamedTuple):
    """The ``sphere_rayleigh_step`` aux carry: the trial Rayleigh quotient
    plus the flat engine's pre-loop dot group at the trial point."""

    rq: torch.Tensor
    init: Optional[FlatCGInit]


def sphere_rayleigh_step(A_elem, with_init: bool = True):
    """Fused TNT trial-step evaluator for f(x) = <x, A x> on S^{n-1}
    (the ``RiemannianProblem.step_eval`` seam; A applied elementwise by
    ``A_elem``, f32+ accumulation).

    From the unnormalized trial point u = x + h, with n2 = <u,u>,
    fu = <u, Au>, na2 = |Au|^2 and c = 1/sqrt(n2):

        x_prop = c u,                      f_prop = fu / n2,
        rq'    = 2 f_prop,                 grad   = 2c Au - rq' c u,

    algebraically identical to retract -> f -> proj(2 A x_prop).  Returns
    ``step_eval(x, h, data) -> (x_prop, f_prop, grad, gradnorm, aux)``
    with ``aux`` a :class:`SphereStepAux`; with ``with_init=True`` it also
    carries the flat engine's pre-loop dot group (:func:`flat_init_dots`)
    evaluated on the cast trial point and gradient, and |grad| comes from
    that group's <g, g>.

    n2, fu and na2 are accumulated in float64 (then rounded to the compute
    dtype): at n = 2^24 an f32 sum on the card (each thread adds ~10^2
    terms in turn) is off by ~1e-6 relative, the size of the objective's
    late decreases, and the gain ratio df/dm turns to noise there (the
    JAX package's TPU reductions add in a tree).
    """
    def step_eval(x, h, data):
        sdt = _acc_dt(x)
        u = x.to(sdt) + h.to(sdt)
        au = A_elem(u).to(sdt)
        n2 = torch.sum(u * u, dtype=torch.float64)
        fu = torch.sum(u * au, dtype=torch.float64)
        c = (1.0 / torch.sqrt(n2)).to(sdt)
        f_prop = (fu / n2).to(sdt)
        rqp = 2.0 * f_prop
        x_prop = (c * u).to(x.dtype)
        g = ((2.0 * c) * au - (rqp * c) * u).to(x.dtype)
        if not with_init:
            # |grad| by the identity 4 na2/n2 - rq'^2 (cancels near the
            # optimum: fine for fixed-effort runs only)
            na2 = torch.sum(au * au, dtype=torch.float64)
            gn = torch.sqrt(torch.clamp(4.0 * na2 / n2 - (fu / n2 * 2.0) ** 2,
                                        min=0.0)).to(sdt)
            return x_prop, f_prop, g, gn, SphereStepAux(rq=rqp, init=None)
        A0p, Up, Bp, _ = sphere_rayleigh_flat(x_prop, A_elem, rq=rqp)
        init = flat_init_dots(g, A0p, Up, Bp)
        gn = torch.sqrt(init.rv)
        return x_prop, f_prop, g, gn, SphereStepAux(rq=rqp, init=init)

    return step_eval


def sphere_rayleigh_flat(x, A_elem, rq=None):
    """Flat-operator structure of the sphere Rayleigh-quotient Hessian.

    For f(x) = <x, A x> on S^{n-1} (A symmetric, applied elementwise by
    ``A_elem``), the symmetrized Riemannian Hessian  P H P  at unit x is

        A0 = 2A - rq I,   U = (x, 2Ax),   B = [[2 rq, -1], [-1, 0]],

    with rq = <x, 2Ax>.  y = 2Ax enters as the adjoint-form pair
    ``(x, 2A.)``.  Returns ``(A0, U, B, rq)``.
    """
    if rq is None:
        rq = _dot(x, 2.0 * A_elem(x))

    def A0(v):
        return 2.0 * A_elem(v) - rq * v.to(_acc_dt(v))

    U = (x, (x, lambda v: 2.0 * A_elem(v)))
    acc = _acc_dt(x)
    rq_t = torch.as_tensor(rq, dtype=acc, device=x.device)
    minus_one = torch.full((), -1.0, dtype=acc, device=x.device)
    B = torch.stack([torch.stack([2.0 * rq_t, minus_one]),
                     torch.stack([minus_one, torch.zeros_like(rq_t)])])
    return A0, U, B, rq
