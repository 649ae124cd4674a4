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

Not ported yet (they raise ``NotImplementedError``): the s-step engine
(``s_steps >= 2``, ``_stpcg_flat_sstep``), ``solve_mode``, and the folded
elementwise preconditioner (``prec=``, ``_fold_prec``).

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
    - ``s_steps >= 2``, ``solve_mode`` and ``prec`` are not ported yet and
      raise ``NotImplementedError``.
    """
    if prec is not None:
        raise NotImplementedError(
            "stpcg_flat(prec=) needs the folded preconditioner (_fold_prec), "
            "which is not ported yet")
    if solve_mode or s_steps > 1:
        raise NotImplementedError(
            "stpcg_flat(s_steps >= 2) and solve_mode need the s-step engine "
            "(_stpcg_flat_sstep), which is not ported yet")
    return _stpcg_flat_pair(g, A0, U, B, Delta,
                            max_iterations=max_iterations,
                            kappa_fgr=kappa_fgr, theta=theta,
                            epsilon=epsilon, init=init,
                            body_kind=body_kind,
                            kernel_check=kernel_check)


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
    """
    def step_eval(x, h, data):
        sdt = _acc_dt(x)
        u = x.to(sdt) + h.to(sdt)
        au = A_elem(u).to(sdt)
        n2 = torch.sum(u * u)
        fu = torch.sum(u * au)
        na2 = torch.sum(au * au)
        c = 1.0 / torch.sqrt(n2)
        f_prop = fu / n2
        rqp = 2.0 * f_prop
        x_prop = (c * u).to(x.dtype)
        g = ((2.0 * c) * au - (rqp * c) * u).to(x.dtype)
        if not with_init:
            # |grad| by the identity 4 na2/n2 - rq'^2 (cancels near the
            # optimum: fine for fixed-effort runs only)
            gn = torch.sqrt(torch.clamp(4.0 * na2 / n2 - rqp * rqp, min=0.0))
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
