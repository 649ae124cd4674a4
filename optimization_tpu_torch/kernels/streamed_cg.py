"""Whole-loop streamed trust-region CG: the Hopper kernel and its plain version.

Counterpart of ``optimization_tpu/kernels/streamed_cg.py``.  One call solves
one Steihaug-Toint trust-region subproblem for H = A0 + U B U' with the
Chronopoulos-Gear recurrences of ``linalg/flat_cg._stpcg_flat_pair`` (one
pass + one grid-wide reduction per CG iteration, the pair-deferred s
update, the boundary sigma-step, the kernel-of-H escape, the truncation
target |r_k| <= |r_0| min(kappa, |r_0|^theta)).

- On a CUDA tensor, :func:`stpcg_flat_streamed` launches the hand-written
  kernel ``csrc/streamed_cg.cu`` (one persistent cooperative launch per
  subproblem; the scalars it returns stay on the card).  It raises if the
  kernel does not build or launch; it never falls back.
- On a CPU tensor it runs :func:`stpcg_flat_streamed_reference`, the plain
  PyTorch transcription of the Pallas kernel's recurrences over whole
  vectors: same init group, same ``half()``, same pair and single bodies.

Operator contract.  The Pallas kernel traced Python chunk generators into
its body; a CUDA kernel cannot take them, so the port describes the sphere
Rayleigh family with descriptors:

- the diagonal a(i): an :class:`AffineDiagonal` ``c + b*i`` (regenerated
  in registers, evaluated in f32) or a stored (n,) f32 tensor;
- ``a0_chunk = ShiftedDiagonal(a)``: A0 = diag(2a - aux[0]);
- ``weights = (None, ScaledDiagonal(a))``: U = (x, 2a .* x), so k = 2;
- ``B``: any 2x2.

:func:`sphere_rayleigh_streamed` builds that bundle.

The elementwise preconditioner P = M^(-1/2) (``prec_chunk``/``prec``, the
Pallas kernel's folding s = P shat) is described the same way, by
``prec_chunk``:

- a :class:`JacobiPower` (c, e): p(i) = (|2a(i) - aux[0]| + c)^(-e), e
  in {1/2, 1/4}, on the operator's own diagonal a (regenerated in
  registers);
- or a stored (n,) f32 tensor p (one more read per pass).

``prec`` is the whole-array map v -> p .* v (``JacobiPower.map(a, rq, n,
device)``), as in the JAX package: both forms or neither, and never with
``init=``.  The plain version folds p over whole vectors and un-transforms
its step with ``prec``; the kernel un-transforms in its own tail pass from
the descriptor, so ``prec`` must be the same map.  General k and arbitrary
chunk generators are not ported:
every caller in the JAX package is the k = 2 sphere family.  Nor are the
TPU's VMEM knobs (``chunk_rows``, ``pin_x``): x streams every iteration,
and n may be any size.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Union

import torch

from ..linalg.flat_cg import FlatCGInit, FlatCGResult

__all__ = ["stpcg_flat_streamed", "stpcg_flat_streamed_reference",
           "sphere_rayleigh_streamed", "AffineDiagonal", "ShiftedDiagonal",
           "ScaledDiagonal", "JacobiPower"]

_STORAGE = (torch.float32, torch.bfloat16)
_ALIGN = 16                     # bytes per vector load in the kernel


@dataclasses.dataclass(frozen=True)
class AffineDiagonal:
    """The diagonal a(i) = c + b*i, evaluated in f32 (f32(c) + f32(b) *
    f32(i), a separate multiply and add)."""

    c: float
    b: float

    def values(self, n: int, device) -> torch.Tensor:
        i = torch.arange(n, dtype=torch.float32, device=device)
        b = torch.tensor(self.b, dtype=torch.float32, device=device)
        c = torch.tensor(self.c, dtype=torch.float32, device=device)
        return b * i + c


Diagonal = Union[AffineDiagonal, torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class ShiftedDiagonal:
    """The A0 chunk generator  a0(i) = 2 a(i) - aux[0]."""

    a: Diagonal


@dataclasses.dataclass(frozen=True, eq=False)
class ScaledDiagonal:
    """The U weight  w(i) = 2 a(i)  (u = w .* x)."""

    a: Diagonal


def _diag_values(a: Diagonal, n: int, device) -> torch.Tensor:
    if isinstance(a, AffineDiagonal):
        return a.values(n, device)
    return a.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class JacobiPower:
    """The shifted-Jacobi power  p(i) = (|2 a(i) - aux[0]| + c)^(-e),
    e = 1/2 or 1/4, on the diagonal ``a`` of the operator it preconditions
    (A0 = 2a - aux[0]; the kernel and the plain version take ``a`` from
    ``a0_chunk``).  c = 1, e = 1/2 is the regularized Jacobi M^(-1/2);
    c = 0, e = 1/2 the exact Jacobi of a positive-definite A0; c = 1,
    e = 1/4 the half-power Jacobi of the JAX package's config13.  Evaluated
    in f32, the quarter power as rsqrt(sqrt(d))."""

    c: float = 1.0
    e: float = 0.5

    def values(self, a: Diagonal, aux0, n: int, device) -> torch.Tensor:
        """p as an (n,) f32 tensor on the diagonal ``a`` for the aux scalar
        ``aux0``."""
        d = torch.abs(2.0 * _diag_values(a, n, device)
                      - _f32(aux0, device)) + self.c
        return torch.rsqrt(d if self.e == 0.5 else torch.sqrt(d))

    def map(self, a: Diagonal, aux0, n: int, device):
        """The whole-array form ``prec``: v -> p .* v (in f32 or wider); p
        is computed at the first call and kept (the kernel never calls
        it)."""
        held = []

        def apply(v):
            if not held:
                held.append(self.values(a, aux0, n, device))
            return v * held[0]
        return apply


Prec = Union[JacobiPower, torch.Tensor]


def sphere_rayleigh_streamed(a_diag: Diagonal):
    """Streamed-kernel operator bundle for the sphere Rayleigh quotient.

    ``a_diag`` is the diagonal of A; ``aux[0]`` must be the Rayleigh
    quotient rq = <x, 2Ax>.  Returns ``(a0_chunk, weights, B_fn)``
    implementing A0 = 2A - rq I, U = (x, 2Ax), B = [[2rq, -1], [-1, 0]]
    (``flat_cg.sphere_rayleigh_flat``; reference Hessian seam
    ``TNT.h:394-426``).  ``B_fn(rq)`` builds B on rq's device without a
    host round trip."""

    def B_fn(rq):
        rq = torch.as_tensor(rq, dtype=torch.float32)
        m1 = torch.full((), -1.0, dtype=torch.float32, device=rq.device)
        return torch.stack([torch.stack([2.0 * rq, m1]),
                            torch.stack([m1, torch.zeros_like(rq)])])

    return ShiftedDiagonal(a_diag), (None, ScaledDiagonal(a_diag)), B_fn


def _check(g, x, B, aux_scalars, a0_chunk, weights, body_kind, init,
           prec_chunk, prec):
    """Validate the call (shared by the kernel and the plain version) and
    return the diagonal descriptor."""
    if (prec_chunk is None) != (prec is None):
        raise ValueError(
            "preconditioning needs both forms of the same elementwise "
            "M^{-1/2}: prec_chunk (the descriptor the kernel folds) and prec "
            "(the whole-array map)")
    if prec_chunk is not None and init is not None:
        raise ValueError(
            "init= (the precomputed pre-loop dot group) is computed in "
            "untransformed coordinates and cannot be combined with "
            "prec_chunk= (same contract as linalg/flat_cg.stpcg_flat)")
    if g.dtype not in _STORAGE:
        raise ValueError("streamed kernel storage dtype must be f32 or "
                         "bf16 (all compute accumulates in f32)")
    if x.dtype != g.dtype:
        raise ValueError("g and x must share the storage dtype")
    if g.dim() != 1 or x.shape != g.shape:
        raise ValueError("g and x must be flat (n,) tensors of one shape")
    if x.device != g.device:
        raise ValueError("g and x must be on one device")
    if body_kind not in ("single", "pair"):
        raise ValueError('body_kind must be "single" or "pair"')
    if (not isinstance(a0_chunk, ShiftedDiagonal) or len(weights) != 2
            or weights[0] is not None
            or not isinstance(weights[1], ScaledDiagonal)
            or weights[1].a is not a0_chunk.a):
        raise NotImplementedError(
            "the port's streamed kernel takes the sphere Rayleigh family "
            "only (sphere_rayleigh_streamed): A0 = 2a - aux[0], "
            "U = (x, 2a .* x); general k and generators are not ported yet")
    if len(aux_scalars) != 1:
        raise ValueError("the sphere Rayleigh family takes one aux scalar")
    if tuple(torch.as_tensor(B).shape) != (2, 2):
        raise ValueError("B must be (k, k) with k = len(weights)")
    a = a0_chunk.a
    if isinstance(a, torch.Tensor) and (
            a.shape != g.shape or a.dtype != torch.float32
            or a.device != g.device):
        raise ValueError("a stored diagonal must be an (n,) f32 tensor on "
                         "g's device")
    if isinstance(prec_chunk, JacobiPower):
        if prec_chunk.e not in (0.5, 0.25) or prec_chunk.c < 0:
            raise ValueError("JacobiPower takes e = 1/2 or 1/4 and c >= 0")
    elif isinstance(prec_chunk, torch.Tensor):
        if (prec_chunk.shape != g.shape or prec_chunk.dtype != torch.float32
                or prec_chunk.device != g.device):
            raise ValueError("a stored preconditioner must be an (n,) f32 "
                             "tensor on g's device")
    elif prec_chunk is not None:
        raise NotImplementedError(
            "prec_chunk takes a JacobiPower or a stored (n,) f32 tensor; "
            "arbitrary chunk generators are not ported")
    return a


def _prec_values(pc: Prec, a: Diagonal, aux0, n: int,
                 device) -> torch.Tensor:
    if isinstance(pc, JacobiPower):
        return pc.values(a, aux0, n, device)
    return pc


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def stpcg_flat_streamed_reference(
    g: torch.Tensor,
    x: torch.Tensor,
    B,
    Delta,
    aux_scalars=(),
    *,
    a0_chunk: ShiftedDiagonal,
    weights: Sequence[Optional[ScaledDiagonal]],
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    body_kind: str = "pair",
    init: Optional[FlatCGInit] = None,
    prec_chunk=None,
    prec=None,
) -> FlatCGResult:
    """The plain PyTorch version of the kernel: the recurrences of
    ``optimization_tpu/kernels/streamed_cg.py:_mk_kernel`` over whole
    vectors, in f32 with storage-dtype vectors, on any device.  Like the
    kernel it reads r from g on the first iteration, allocates s and p
    uninitialized (guarded by select, not by scaling), and returns s = 0
    when no CG step is taken.  With a preconditioner it folds p over whole
    vectors (ghat = p g, a0hat = p^2 a0, uhat = p u) and un-transforms the
    step with ``prec``, as the JAX wrapper does.  The loop condition is read
    back once per loop body."""
    a = _check(g, x, B, aux_scalars, a0_chunk, weights, body_kind, init,
               prec_chunk, prec)
    dev = g.device
    n = g.shape[0]
    sdt = g.dtype
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)

    av = _diag_values(a, n, dev)
    aux0 = _f32(aux_scalars[0], dev)
    a0 = 2.0 * av - aux0
    xf = x.to(f32)
    if prec_chunk is None:
        us = (xf, (2.0 * av) * xf)
    else:
        # the Pallas kernel's folding, in its multiplication order
        pv = _prec_values(prec_chunk, a, aux0, n, dev)
        a0 = pv * pv * a0
        us = (pv * xf, (pv * (2.0 * av)) * xf)
    Bt = _f32(B, dev)
    Bl = [[Bt[0, 0], Bt[0, 1]], [Bt[1, 0], Bt[1, 1]]]
    Delta_t = _f32(Delta, dev)
    Delta2 = Delta_t * Delta_t
    eps2 = _f32(epsilon, dev) ** 2
    tiny = torch.finfo(f32).tiny

    def kdot(u, v):
        return u[0] * v[0] + u[1] * v[1]

    def matk(M, v):
        return [kdot(row, v) for row in M]

    def dot(u, v):
        return torch.sum(u * v)

    if init is not None:
        rv0, ar0, nr0 = (_f32(init.rv, dev), _f32(init.ar, dev),
                         _f32(init.nr, dev))
        m0 = [_f32(init.m[j], dev) for j in range(2)]
        mA0 = [_f32(init.mA[j], dev) for j in range(2)]
        UU = [[_f32(init.UU[i, j], dev) for j in range(2)] for i in range(2)]
    else:
        gf = g.to(f32) if prec_chunk is None else pv * g.to(f32)
        a0g = a0 * gf
        rv0, ar0, nr0 = dot(gf, gf), dot(a0g, gf), dot(a0g, a0g)
        m0 = [dot(u, gf) for u in us]
        mA0 = [dot(u, a0g) for u in us]
        u01 = dot(us[0], us[1])
        UU = [[dot(us[0], us[0]), u01], [u01, dot(us[1], us[1])]]

    r0n = torch.sqrt(rv0)
    target = r0n * torch.minimum(_f32(kappa_fgr, dev), r0n ** theta)

    # the carry of the Pallas kernel (optimization_tpu/kernels/
    # streamed_cg.py:329-331); r starts as g itself (ghat, stored)
    s = torch.empty_like(g)
    r = g if prec_chunk is None else gf.to(sdt)
    p = torch.empty_like(g)
    c = dict(k=torch.zeros((), dtype=torch.int32, device=dev),
             rv=rv0, ar=ar0, nr=nr0, pa=zero, nAp=zero, rv_prev=zero,
             alpha_prev=one, pr=zero, kappa_prev=one, s_p=zero, sk2=zero,
             pp_prev=zero, mval=zero, done=zero, bnd=zero, s_valid=zero,
             p_valid=zero, m=m0, mA=mA0, mB=[zero, zero], mp=[zero, zero])

    def half(c, pend, apply_s):
        nonlocal s, r, p
        frozen = ((c["done"] != 0) | (c["k"] >= max_iterations)
                  | (torch.sqrt(c["rv"]) <= target))
        first = c["rv_prev"] == 0
        beta = torch.where(first, zero,
                           c["rv"] / torch.where(first, one, c["rv_prev"]))
        m, mA, mB, mp = c["m"], c["mA"], c["mB"], c["mp"]

        Bm = matk(Bl, m)
        wr = c["ar"] + kdot(m, Bm)
        kappa = wr - (beta / c["alpha_prev"]) * c["rv"]
        pp_k = c["rv"] + beta * beta * c["pp_prev"]
        pr_k = -c["rv"] + beta * (c["pr"] + c["alpha_prev"] * c["kappa_prev"])
        sp_k = beta * (c["s_p"] + c["alpha_prev"] * c["pp_prev"])

        # kernel-of-H safeguard via the |q|^2 recurrence
        Bmp = matk(Bl, mp)
        UUBm = matk(UU, Bm)
        UUBmp = matk(UU, Bmp)
        ww = c["nr"] + 2.0 * kdot(mA, Bm) + kdot(Bm, UUBm)
        wq = c["pa"] + kdot(mA, Bmp) + kdot(Bm, mB) + kdot(Bm, UUBmp)
        qq_prev = c["nAp"] + 2.0 * kdot(mB, Bmp) + kdot(Bmp, UUBmp)
        qq_k = ww - 2.0 * beta * wq + beta * beta * qq_prev
        in_kernel = qq_k < eps2 * pp_k
        sign = torch.where(in_kernel & (pr_k > 0), -one, one)

        sp_eff = sign * sp_k
        disc = sp_eff * sp_eff + pp_k * (Delta2 - c["sk2"])
        sigma = ((-sp_eff + torch.sqrt(torch.clamp(disc, min=0.0)))
                 / torch.clamp(pp_k, min=tiny))

        alpha = c["rv"] / kappa
        sk2_next = c["sk2"] + 2.0 * alpha * sp_k + alpha * alpha * pp_k
        boundary = ((in_kernel | (kappa <= 0) | (sk2_next > Delta2))
                    & ~frozen)

        cs = torch.where(boundary, sigma * sign, alpha)
        cs = torch.where(frozen, zero, cs)
        crr = torch.where(boundary | frozen, zero, alpha)
        m_new = torch.where(
            frozen, c["mval"],
            torch.where(boundary,
                        c["mval"] + sigma * sign * pr_k
                        + 0.5 * sigma * sigma * kappa,
                        c["mval"] - 0.5 * alpha * c["rv"]))

        mp_k = [-m[j] + beta * mp[j] for j in range(2)]
        mB2 = [-mA[j] + beta * mB[j] for j in range(2)]
        Bmpk = matk(Bl, mp_k)
        UUBmpk = matk(UU, Bmpk)
        m2 = [m[j] + crr * (mB2[j] + UUBmpk[j]) for j in range(2)]
        nAp2 = c["nr"] - 2.0 * beta * c["pa"] + beta * beta * c["nAp"]

        # ---- the streamed pass over whole vectors ----
        rc = r.to(f32)
        pc = p.to(f32)
        p2 = torch.where(first, -rc, -rc + beta * pc)
        q2 = a0 * p2
        q2 = q2 + Bmpk[0] * us[0]
        q2 = q2 + Bmpk[1] * us[1]
        r2 = rc + crr * q2
        a0r2 = a0 * r2
        a0p2 = a0 * p2
        rv2, ar2, nr2, pa2 = (dot(r2, r2), dot(a0r2, r2), dot(a0r2, a0r2),
                              dot(a0r2, a0p2))
        mA2 = [dot(u, a0r2) for u in us]
        if apply_s:
            # s and p hold garbage (possibly NaN) before their first
            # write, and 0 * NaN = NaN: select, don't scale
            sc = s.to(f32)
            s = (torch.where(c["s_valid"] != 0, sc, zero)
                 + torch.where(c["p_valid"] != 0, pend * pc, zero)
                 + cs * p2).to(sdt)
        r = r2.to(sdt)
        p = p2.to(sdt)

        exit_now = boundary | frozen

        def keep(old, new):
            return torch.where(exit_now, old, new)

        out = dict(
            k=torch.where(exit_now, c["k"], c["k"] + 1),
            rv=keep(c["rv"], rv2), ar=ar2, nr=nr2, pa=pa2, nAp=nAp2,
            rv_prev=keep(c["rv_prev"], c["rv"]),
            alpha_prev=keep(c["alpha_prev"], alpha),
            pr=keep(c["pr"], pr_k),
            kappa_prev=keep(c["kappa_prev"], kappa),
            s_p=keep(c["s_p"], sp_k),
            sk2=keep(c["sk2"], sk2_next),
            pp_prev=keep(c["pp_prev"], pp_k),
            mval=m_new,
            done=torch.where(boundary, one, c["done"]),
            bnd=torch.where(frozen, c["bnd"],
                            torch.where(boundary, one, c["bnd"])),
            s_valid=one if apply_s else c["s_valid"],
            p_valid=one,
            m=m2, mA=mA2, mB=mB2, mp=mp_k)
        return out, (zero if apply_s else cs)

    def cond(c) -> bool:
        return bool((c["k"] < max_iterations) & (c["done"] == 0)
                    & (torch.sqrt(c["rv"]) > target))

    while cond(c):
        if body_kind == "pair":
            c, pend = half(c, zero, apply_s=False)
            c, _ = half(c, pend, apply_s=True)
        else:
            c, _ = half(c, zero, apply_s=True)

    if not bool(c["s_valid"] != 0):
        s = torch.zeros_like(g)    # no CG step was taken
    if prec is not None:
        s = prec(s.to(f32)).to(sdt)
    boundary = c["bnd"] > 0.5
    m_norm = torch.where(boundary, Delta_t, torch.sqrt(c["sk2"]))
    return FlatCGResult(s=s, update_step_M_norm=m_norm,
                        num_iterations=c["k"],
                        predicted_decrease=-c["mval"])


def _lib() -> ctypes.CDLL:
    from ..csrc.build import load

    lib = load("streamed_cg")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
        lib.streamed_cg_grid.argtypes = [i32, i32, i64, ctypes.POINTER(i32)]
        lib.streamed_cg_grid.restype = i32
        lib.streamed_cg_nacc.argtypes = []
        lib.streamed_cg_nacc.restype = i32
        lib.streamed_cg_error_string.argtypes = [i32]
        lib.streamed_cg_error_string.restype = ctypes.c_char_p
        lib.streamed_cg_launch.argtypes = [
            i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i64, f, f,
            i32, f, f, f, i32, i32, i32, vp, f, i32, vp]
        lib.streamed_cg_launch.restype = i32
        lib._argtypes_set = True
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.streamed_cg_error_string(code).decode()
        raise RuntimeError(f"streamed_cg {what} failed: CUDA error {code} "
                           f"({msg})")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % _ALIGN == 0 else t.clone()


def stpcg_flat_streamed(
    g: torch.Tensor,
    x: torch.Tensor,
    B,
    Delta,
    aux_scalars=(),
    *,
    a0_chunk: ShiftedDiagonal,
    weights: Sequence[Optional[ScaledDiagonal]],
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    body_kind: str = "pair",
    init: Optional[FlatCGInit] = None,
    prec_chunk=None,
    prec=None,
) -> FlatCGResult:
    """Solve the flat trust-region subproblem for the sphere Rayleigh
    family (module docstring).  ``g``/``x`` are flat (n,) f32 or bf16 of
    any length; ``B`` (2, 2); ``Delta``, ``aux_scalars``, ``B`` and the
    ``init`` group may be tensors on the card (nothing is read back).
    Returns the :class:`FlatCGResult` of ``stpcg_flat``: s in the storage
    dtype, and the M-norm, iteration count and predicted decrease as
    tensors on g's device.

    ``body_kind``: ``"pair"`` (default) defers each even iteration's s
    coefficient into the next iteration's s update (5n words deferring,
    7n applying); ``"single"`` applies s every iteration (7n).

    ``init``: an optional ``FlatCGInit`` (the pre-loop dot group computed
    by the caller, e.g. TNT's ``sphere_rayleigh_step`` aux).  The kernel
    then skips its init pass; its first iteration reads r from g.  The
    threaded group is accumulated in another order than the kernel's own,
    so this is contract parity, not bitwise.

    ``prec_chunk`` / ``prec``: the elementwise M^(-1/2) (module docstring):
    truncation in |r|_{M^{-1}}, trust region and reported step norm in
    |s|_M, the kernel-of-H safeguard on P H P, as
    ``linalg.flat_cg.stpcg_flat(prec=)``.

    On a CPU tensor this runs :func:`stpcg_flat_streamed_reference`; on a
    CUDA tensor it launches the kernel (counted in
    ``stpcg_flat_streamed.launches``) or raises.
    """
    a = _check(g, x, B, aux_scalars, a0_chunk, weights, body_kind, init,
               prec_chunk, prec)
    if g.device.type == "cpu":
        return stpcg_flat_streamed_reference(
            g, x, B, Delta, aux_scalars, a0_chunk=a0_chunk, weights=weights,
            max_iterations=max_iterations, kappa_fgr=kappa_fgr, theta=theta,
            epsilon=epsilon, body_kind=body_kind, init=init,
            prec_chunk=prec_chunk, prec=prec)
    if g.device.type != "cuda":
        raise ValueError(f"stpcg_flat_streamed runs on CUDA tensors (the "
                         f"kernel) or CPU tensors (the plain version), not "
                         f"{g.device.type}")
    dev = g.device
    n = g.shape[0]
    bf16 = int(g.dtype == torch.bfloat16)
    g, x = _aligned(g), _aligned(x)
    diag = _aligned(a) if isinstance(a, torch.Tensor) else None
    # 0: none, 1: the generated JacobiPower, 2: a stored p
    generated = isinstance(prec_chunk, JacobiPower)
    prec_kind = 0 if prec_chunk is None else 1 if generated else 2
    stored_p = _aligned(prec_chunk) if prec_kind == 2 else None

    parts = [_f32(Delta, dev).reshape(1), _f32(aux_scalars[0], dev).reshape(1),
             _f32(B, dev).reshape(4)]
    if init is not None:
        parts += [_f32(init.rv, dev).reshape(1), _f32(init.ar, dev).reshape(1),
                  _f32(init.nr, dev).reshape(1), _f32(init.m, dev).reshape(2),
                  _f32(init.mA, dev).reshape(2), _f32(init.UU, dev).reshape(4)]
    scal = torch.cat(parts)

    lib = _lib()
    with torch.cuda.device(dev):
        grid = ctypes.c_int(0)
        _raise_on(lib, lib.streamed_cg_grid(bf16, prec_kind, n,
                                            ctypes.byref(grid)),
                  "occupancy query")
        s = torch.empty_like(g)
        r = torch.empty_like(g)
        p = torch.empty_like(g)
        res = torch.empty(4, dtype=torch.float32, device=dev)
        partial = torch.empty(2 * grid.value * lib.streamed_cg_nacc(),
                              dtype=torch.float64, device=dev)
        aff = a if isinstance(a, AffineDiagonal) else AffineDiagonal(0.0, 0.0)
        code = lib.streamed_cg_launch(
            bf16, g.data_ptr(), x.data_ptr(),
            diag.data_ptr() if diag is not None else None,
            s.data_ptr(), r.data_ptr(), p.data_ptr(), scal.data_ptr(),
            res.data_ptr(), partial.data_ptr(), grid.value, n,
            aff.c, aff.b, int(max_iterations), float(kappa_fgr), float(theta),
            float(epsilon), int(body_kind == "pair"), int(init is not None),
            prec_kind,
            stored_p.data_ptr() if stored_p is not None else None,
            float(prec_chunk.c) if generated else 0.0,
            int(generated and prec_chunk.e == 0.25),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, code, "launch")
    stpcg_flat_streamed.launches += 1

    boundary = res[1] > 0.5
    m_norm = torch.where(boundary, scal[0], torch.sqrt(res[2]))
    return FlatCGResult(s=s, update_step_M_norm=m_norm,
                        num_iterations=res[0].to(torch.int32),
                        predicted_decrease=-res[3])


# Kernel launches made by this process (the plain version does not count).
stpcg_flat_streamed.launches = 0
