"""Whole-loop streamed trust-region CG: the Hopper kernel and its plain version.

Counterpart of ``optimization_tpu/kernels/streamed_cg.py``.  One call solves
one Steihaug-Toint trust-region subproblem for H = A0 + U B U' with the
Chronopoulos-Gear recurrences of ``linalg/flat_cg._stpcg_flat_pair`` (one
pass + one grid-wide reduction per CG iteration, the pair-deferred s
update, the boundary sigma-step, the kernel-of-H escape, the truncation
target |r_k| <= |r_0| min(kappa, |r_0|^theta)).

- On a CUDA tensor, :func:`stpcg_flat_streamed` launches the hand-written
  kernel (one persistent cooperative launch per subproblem; the scalars it
  returns stay on the card): ``csrc/streamed_cg.cu`` at k = 1-4 (the
  K-sized state in registers) and ``csrc/streamed_cg_any.cu`` at k >= 5
  (the streams staged by TMA in a ring of shared-memory stages, the
  weight 1 and the generated weights folded into one affine form a pass,
  the K-sized state in shared memory or device memory past its lines:
  :func:`any_k_plan`).  It raises if the kernel does not build or launch;
  it never falls back.
- On a CPU tensor it runs :func:`stpcg_flat_streamed_reference`, the plain
  PyTorch transcription of the Pallas kernel's recurrences over whole
  vectors: same init group, same ``half()``, same pair and single bodies.

Operator contract: A0 = diag(a0), U = (w_1 .* x, ..., w_k .* x), B any
k x k (a tensor; it may live on the card), any number of aux scalars.  The
Pallas kernel traced Python chunk generators of (i0, aux) into its body; a
CUDA kernel cannot, so each per-element term t(i) is a descriptor:

- an :class:`AffineDiagonal` ``c + b*i``, regenerated in registers
  (evaluated in f32; no bytes);
- a stored (n,) f32 tensor (one read per pass);
- an :class:`ElementwiseFn` wrapping a whole-array callable
  ``fn(i, aux) -> (n,)``, the counterpart of a chunk generator: evaluated
  once a call into a stored f32 vector on g's device (one n-word write),
  then read like one.

``a0_chunk`` is a :class:`ShiftedDiagonal` ``(a)`` (a0 = 2a - aux[0]) or
any term, taken as a0 itself.  ``weights`` is a tuple of k >= 1 entries,
each ``None`` (u = x), a :class:`ScaledDiagonal` ``(a)`` (w = 2a) or any
term.  :func:`sphere_rayleigh_streamed` builds the sphere Rayleigh bundle
(k = 2: A0 = 2a - rq, U = (x, 2a .* x)).  Both routes take any k >= 1.
A rank-3 call, with a0 and the third weight stored::

    stpcg_flat_streamed(g, x, B3, Delta, (lam, q), a0_chunk=a0,
                        weights=(None, AffineDiagonal(1.0, b), c))

The elementwise preconditioner P = M^(-1/2) (``prec_chunk``/``prec``, the
Pallas kernel's folding s = P shat) is described the same way, by
``prec_chunk``:

- a :class:`JacobiPower` (c, e): p(i) = (|a0(i)| + c)^(-e), e in {1/2,
  1/4}, on the operator's own A0 (regenerated in registers from a0's
  descriptor; for the sphere family (|2a - aux[0]| + c)^(-e));
- a stored (n,) f32 tensor p, or an :class:`ElementwiseFn` (one more read
  per pass).

``prec`` is the whole-array map v -> p .* v, as in the JAX package: both
forms or neither, and never with ``init=``.  The plain version folds p over
whole vectors and un-transforms its step with ``prec``; the kernel
un-transforms in its own tail pass from the descriptor and never calls
``prec``.  So that the two routes cannot differ, ``prec`` must be the
descriptor's own map, a :class:`PrecMap` from :func:`prec_map` (or
``JacobiPower.map(a, rq, n, device)`` for the sphere family,
:func:`stored_prec_map` for a stored p): any other callable, or a map of
another descriptor, A0 or aux scalars, raises ``ValueError`` on both
routes.  The TPU's VMEM knobs (``chunk_rows``, ``pin_x``, ``interpret``)
are not ported: x streams every iteration, and n may be any size.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Callable, Optional, Sequence, Union

import torch

from ..core.profiling import annotate
from ..linalg.flat_cg import FlatCGInit, FlatCGResult

__all__ = ["stpcg_flat_streamed", "stpcg_flat_streamed_reference",
           "sphere_rayleigh_streamed", "AffineDiagonal", "ShiftedDiagonal",
           "ScaledDiagonal", "ElementwiseFn", "JacobiPower", "PrecMap",
           "prec_map", "stored_prec_map", "AnyKPlan", "any_k_plan",
           "any_k_layout"]

_STORAGE = (torch.float32, torch.bfloat16)
_ALIGN = 16                     # bytes per vector load in the kernel
_UNROLLED_K = 4                 # csrc/streamed_cg.cu's ranks; above, _any.cu


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


@dataclasses.dataclass(frozen=True, eq=False)
class ElementwiseFn:
    """A per-element term given by a whole-array callable ``fn(i, aux) ->
    (n,)``: ``i`` is the int64 index vector 0..n-1 and ``aux`` the tuple of
    aux scalars as f32 tensors, both on g's device.  The counterpart of the
    Pallas kernel's chunk generator of (i0, aux); evaluated once a call into
    a stored f32 vector."""

    fn: Callable

    def values(self, n: int, aux, device) -> torch.Tensor:
        i = torch.arange(n, device=device)
        v = torch.as_tensor(self.fn(i, tuple(aux)))
        if v.shape != (n,):
            raise ValueError(f"ElementwiseFn: fn(i, aux) gave shape "
                             f"{tuple(v.shape)}, not ({n},)")
        return v.to(device=device, dtype=torch.float32).contiguous()


Diagonal = Union[AffineDiagonal, torch.Tensor]
Term = Union[AffineDiagonal, torch.Tensor, ElementwiseFn]
_TERMS = (AffineDiagonal, torch.Tensor, ElementwiseFn)


@dataclasses.dataclass(frozen=True, eq=False)
class ShiftedDiagonal:
    """The A0 chunk generator  a0(i) = 2 a(i) - aux[0]."""

    a: Term


@dataclasses.dataclass(frozen=True, eq=False)
class ScaledDiagonal:
    """The U weight  w(i) = 2 a(i)  (u = w .* x)."""

    a: Term


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _term_values(t: Term, n: int, aux, device) -> torch.Tensor:
    """A term's (n,) f32 values; ``aux`` the f32 aux scalars."""
    if isinstance(t, AffineDiagonal):
        return t.values(n, device)
    if isinstance(t, ElementwiseFn):
        return t.values(n, aux, device)
    return t.to(torch.float32)


def _a0_values(a0_chunk, n: int, aux, device) -> torch.Tensor:
    if isinstance(a0_chunk, ShiftedDiagonal):
        return 2.0 * _term_values(a0_chunk.a, n, aux, device) - aux[0]
    return _term_values(a0_chunk, n, aux, device)


def _weight_values(w, n: int, aux, device) -> Optional[torch.Tensor]:
    if w is None:
        return None
    if isinstance(w, ScaledDiagonal):
        return 2.0 * _term_values(w.a, n, aux, device)
    return _term_values(w, n, aux, device)


@dataclasses.dataclass(frozen=True)
class JacobiPower:
    """The shifted-Jacobi power  p(i) = (|a0(i)| + c)^(-e), e = 1/2 or 1/4,
    on the diagonal of the A0 it preconditions (the kernel and the plain
    version take it from ``a0_chunk``; for the sphere family, a0 = 2a -
    aux[0]).  c = 1, e = 1/2 is the regularized Jacobi M^(-1/2); c = 0,
    e = 1/2 the exact Jacobi of a positive-definite A0; c = 1, e = 1/4 the
    half-power Jacobi of the JAX package's config13.  Evaluated in f32, the
    quarter power as rsqrt(sqrt(d))."""

    c: float = 1.0
    e: float = 0.5

    def of(self, a0: torch.Tensor) -> torch.Tensor:
        """p on A0's diagonal values ``a0`` (f32)."""
        d = torch.abs(a0) + self.c
        return torch.rsqrt(d if self.e == 0.5 else torch.sqrt(d))

    def values(self, a: Diagonal, aux0, n: int, device) -> torch.Tensor:
        """p as an (n,) f32 tensor for the sphere family: A0 = 2a - aux0 on
        the diagonal ``a``."""
        return self.of(2.0 * _term_values(a, n, (), device)
                       - _f32(aux0, device))

    def map(self, a: Diagonal, aux0, n: int, device) -> "PrecMap":
        """The whole-array form ``prec`` for the sphere family (A0 = 2a -
        aux0): v -> p .* v (in f32 or wider); p is computed at the first
        call and kept (the kernel never calls it).  Any other A0:
        :func:`prec_map`."""
        return PrecMap(self, ShiftedDiagonal(a), (aux0,), n, device)


def _same_scalar(u, v) -> bool:
    """One aux scalar: the same object, or equal values (tensors that are
    distinct objects are compared on their device, which reads the host)."""
    if u is v:
        return True
    if isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor):
        return (u.device == v.device and u.numel() == v.numel() == 1
                and bool(u.reshape(()).float() == v.reshape(()).float()))
    return float(u) == float(v)


def _same_tensor(u: torch.Tensor, v: torch.Tensor) -> bool:
    return u is v or (u.data_ptr() == v.data_ptr() and u.shape == v.shape
                      and u.stride() == v.stride() and u.dtype == v.dtype
                      and u.device == v.device)


def _same_term(u, v) -> bool:
    if isinstance(u, ShiftedDiagonal) or isinstance(v, ShiftedDiagonal):
        return (isinstance(u, ShiftedDiagonal)
                and isinstance(v, ShiftedDiagonal) and _same_term(u.a, v.a))
    if isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor):
        return _same_tensor(u, v)
    if isinstance(u, ElementwiseFn) and isinstance(v, ElementwiseFn):
        return u is v or u.fn is v.fn
    return (isinstance(u, AffineDiagonal) and isinstance(v, AffineDiagonal)
            and u == v)


def _aux_read(a0_chunk, aux):
    """The aux scalars A0's descriptor reads: aux[0] for a shifted diagonal,
    all of them where a wrapped callable is involved, none otherwise."""
    inner = a0_chunk.a if isinstance(a0_chunk, ShiftedDiagonal) else a0_chunk
    if isinstance(inner, ElementwiseFn):
        return tuple(aux)
    return tuple(aux[:1]) if isinstance(a0_chunk, ShiftedDiagonal) else ()


def _same_aux(u, v) -> bool:
    return len(u) == len(v) and all(_same_scalar(a, b) for a, b in zip(u, v))


class PrecMap:
    """The whole-array form of a ``prec_chunk`` descriptor, v -> p .* v,
    carrying what it was built from (the descriptor, and for a
    :class:`JacobiPower` A0's descriptor, for an :class:`ElementwiseFn` or
    a generated A0 the aux scalars), so that :func:`stpcg_flat_streamed`
    can hold the two forms to one map."""

    def __init__(self, descriptor, a0=None, aux=(), n: Optional[int] = None,
                 device=None):
        self.descriptor, self.a0, self.aux = descriptor, a0, tuple(aux)
        self._n, self._device, self._p = n, device, None

    def values(self) -> torch.Tensor:
        if self._p is None:
            d, n, dev = self.descriptor, self._n, self._device
            aux = tuple(_f32(a, dev) for a in self.aux)
            if isinstance(d, torch.Tensor):
                self._p = d
            elif isinstance(d, ElementwiseFn):
                self._p = d.values(n, aux, dev)
            else:
                self._p = d.of(_a0_values(self.a0, n, aux, dev))
        return self._p

    def __call__(self, v):
        return v * self.values()

    def describes(self, prec_chunk, a0_chunk, aux) -> bool:
        """Whether this is the map of ``prec_chunk`` for the operator of
        ``a0_chunk`` and the aux scalars ``aux``."""
        d = self.descriptor
        if isinstance(d, torch.Tensor) or isinstance(prec_chunk,
                                                     torch.Tensor):
            return (isinstance(d, torch.Tensor)
                    and isinstance(prec_chunk, torch.Tensor)
                    and _same_tensor(d, prec_chunk))
        if isinstance(d, ElementwiseFn) or isinstance(prec_chunk,
                                                      ElementwiseFn):
            return (_same_term(d, prec_chunk)
                    and _same_aux(self.aux, tuple(aux)))
        return (d == prec_chunk and _same_term(self.a0, a0_chunk)
                and _same_aux(_aux_read(self.a0, self.aux),
                              _aux_read(a0_chunk, tuple(aux))))


def prec_map(prec_chunk, a0_chunk=None, aux_scalars=(), n: Optional[int] = None,
             device=None) -> PrecMap:
    """The whole-array form ``prec`` of any ``prec_chunk`` descriptor: a
    :class:`JacobiPower` on the operator of ``a0_chunk`` with
    ``aux_scalars``, an :class:`ElementwiseFn` (evaluated with
    ``aux_scalars``) or a stored (n,) p."""
    if isinstance(prec_chunk, torch.Tensor):
        return PrecMap(prec_chunk)
    return PrecMap(prec_chunk, a0_chunk, aux_scalars, n, device)


def stored_prec_map(p: torch.Tensor) -> PrecMap:
    """The whole-array form ``prec`` of a stored (n,) preconditioner p
    (``prec_chunk=p``)."""
    return PrecMap(p)


def sphere_rayleigh_streamed(a_diag: Diagonal, n_aux: int = 1):
    """Streamed-kernel operator bundle for the sphere Rayleigh quotient.

    ``a_diag`` is the diagonal of A; ``aux[0]`` must be the Rayleigh
    quotient rq = <x, 2Ax> (``n_aux``, the count of aux scalars the caller
    passes, is the JAX signature's and changes nothing).  Returns
    ``(a0_chunk, weights, B_fn)`` implementing A0 = 2A - rq I, U = (x, 2Ax),
    B = [[2rq, -1], [-1, 0]] (``flat_cg.sphere_rayleigh_flat``; reference
    Hessian seam ``TNT.h:394-426``).  ``B_fn(rq)`` builds B on rq's device
    without a host round trip."""

    def B_fn(rq):
        rq = torch.as_tensor(rq, dtype=torch.float32)
        m1 = torch.full((), -1.0, dtype=torch.float32, device=rq.device)
        return torch.stack([torch.stack([2.0 * rq, m1]),
                            torch.stack([m1, torch.zeros_like(rq)])])

    return ShiftedDiagonal(a_diag), (None, ScaledDiagonal(a_diag)), B_fn


def _check_term(t, g, what: str, noun: str) -> None:
    if not isinstance(t, _TERMS):
        raise TypeError(
            f"{what} must be an AffineDiagonal, a stored (n,) f32 tensor or "
            f"an ElementwiseFn wrapping a whole-array callable fn(i, aux); "
            f"chunk generators cannot run in the kernel (got "
            f"{type(t).__name__})")
    if isinstance(t, torch.Tensor) and (
            t.shape != g.shape or t.dtype != torch.float32
            or t.device != g.device):
        raise ValueError(f"{what}: a stored {noun} must be an (n,) f32 "
                         f"tensor on g's device")


def _check(g, x, B, aux_scalars, a0_chunk, weights, body_kind, init,
           prec_chunk, prec) -> None:
    """Validate the call (shared by the kernel and the plain version): the
    JAX wrapper's rules (``optimization_tpu/kernels/streamed_cg.py:588-619``)
    and the descriptors'."""
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
    k = len(weights)
    if k == 0:
        raise ValueError("weights must hold at least one entry (k >= 1): "
                         "the Pallas kernel takes no rank-0 operator")
    if tuple(torch.as_tensor(B).shape) != (k, k):
        raise ValueError("B must be (k, k) with k = len(weights)")
    if isinstance(a0_chunk, ShiftedDiagonal):
        _check_term(a0_chunk.a, g, "ShiftedDiagonal.a", "diagonal")
        if len(aux_scalars) < 1:
            raise ValueError("ShiftedDiagonal reads aux[0]: pass at least "
                             "one aux scalar")
    else:
        _check_term(a0_chunk, g, "a0_chunk", "diagonal")
    for j, w in enumerate(weights):
        if isinstance(w, ScaledDiagonal):
            _check_term(w.a, g, f"weights[{j}].a", "diagonal")
        elif w is not None:
            _check_term(w, g, f"weights[{j}]", "weight")
    if isinstance(prec_chunk, JacobiPower):
        if prec_chunk.e not in (0.5, 0.25) or prec_chunk.c < 0:
            raise ValueError("JacobiPower takes e = 1/2 or 1/4 and c >= 0")
    elif prec_chunk is not None:
        _check_term(prec_chunk, g, "prec_chunk", "preconditioner")
        if isinstance(prec_chunk, AffineDiagonal):
            raise TypeError("prec_chunk takes a JacobiPower, a stored (n,) "
                            "f32 tensor or an ElementwiseFn")
    if prec_chunk is not None and not (
            isinstance(prec, PrecMap)
            and prec.describes(prec_chunk, a0_chunk, aux_scalars)):
        raise ValueError(
            "prec must be the whole-array map of prec_chunk itself "
            "(prec_map(prec_chunk, a0_chunk, aux, n, device) on the "
            "operator's own A0 and aux scalars, JacobiPower.map(a, aux[0], "
            "n, device) for the sphere family, or stored_prec_map(p) of the "
            "stored p): the kernel un-transforms its step from prec_chunk, "
            "the plain version with prec, and they must be one map")


class _Evaluated:
    """Each :class:`ElementwiseFn` of one call evaluated once, on g's
    device."""

    def __init__(self, n: int, aux, device):
        self.n, self.aux, self.device, self._cache = n, aux, device, {}

    def __call__(self, t):
        if isinstance(t, ElementwiseFn):
            if id(t) not in self._cache:
                self._cache[id(t)] = t.values(self.n, self.aux, self.device)
            return self._cache[id(t)]
        return t


def _resolve(ev: _Evaluated, t):
    """A descriptor with its wrapped callables replaced by their values."""
    if isinstance(t, ShiftedDiagonal):
        return ShiftedDiagonal(ev(t.a))
    if isinstance(t, ScaledDiagonal):
        return ScaledDiagonal(ev(t.a))
    return ev(t)


def stpcg_flat_streamed_reference(
    g: torch.Tensor,
    x: torch.Tensor,
    B,
    Delta,
    aux_scalars=(),
    *,
    a0_chunk,
    weights: Sequence,
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
    vectors for any rank k, in f32 with storage-dtype vectors, on any
    device.  Like the kernel it reads r from g on the first iteration,
    allocates s and p uninitialized (guarded by select, not by scaling), and
    returns s = 0 when no CG step is taken.  With a preconditioner it folds
    p over whole vectors (ghat = p g, a0hat = p^2 a0, uhat_j = (p w_j) x)
    and un-transforms the step with ``prec``, as the JAX wrapper does.  The
    loop condition is read back once per loop body."""
    _check(g, x, B, aux_scalars, a0_chunk, weights, body_kind, init,
           prec_chunk, prec)
    dev = g.device
    n = g.shape[0]
    sdt = g.dtype
    f32 = torch.float32
    k_lr = len(weights)
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)

    aux = tuple(_f32(a, dev) for a in aux_scalars)
    ev = _Evaluated(n, aux, dev)
    a0 = _a0_values(_resolve(ev, a0_chunk), n, aux, dev)
    ws = [_weight_values(_resolve(ev, w), n, aux, dev) for w in weights]
    xf = x.to(f32)
    if prec_chunk is None:
        us = [xf if w is None else w * xf for w in ws]
    else:
        # the Pallas kernel's folding, in its multiplication order
        pv = (prec_chunk.of(a0) if isinstance(prec_chunk, JacobiPower)
              else _term_values(ev(prec_chunk), n, aux, dev))
        a0 = pv * pv * a0
        us = [pv * xf if w is None else (pv * w) * xf for w in ws]
    Bm_ = _f32(B, dev).reshape(k_lr, k_lr)
    Delta_t = _f32(Delta, dev)
    Delta2 = Delta_t * Delta_t
    eps2 = _f32(epsilon, dev) ** 2
    tiny = torch.finfo(f32).tiny

    # the k-vector algebra in the Pallas kernel's order (_kdot, _matk: a
    # sum over j = 0..k-1, each product rounded, then added), a column of
    # M at a time
    def kdot(u, v):
        uv = u * v
        t = uv[0]
        for j in range(1, k_lr):
            t = t + uv[j]
        return t

    def matk(M, v):
        t = M[:, 0] * v[0]
        for j in range(1, k_lr):
            t = t + M[:, j] * v[j]
        return t

    def dot(u, v):
        return torch.sum(u * v)

    if init is not None:
        rv0, ar0, nr0 = (_f32(init.rv, dev), _f32(init.ar, dev),
                         _f32(init.nr, dev))
        m0 = _f32(init.m, dev).reshape(k_lr)
        mA0 = _f32(init.mA, dev).reshape(k_lr)
        UU = _f32(init.UU, dev).reshape(k_lr, k_lr)
    else:
        gf = g.to(f32) if prec_chunk is None else pv * g.to(f32)
        a0g = a0 * gf
        rv0, ar0, nr0 = dot(gf, gf), dot(a0g, gf), dot(a0g, a0g)
        m0 = torch.stack([dot(u, gf) for u in us])
        mA0 = torch.stack([dot(u, a0g) for u in us])
        # the upper triangle of U'U, mirrored
        UU = [[None] * k_lr for _ in range(k_lr)]
        for i in range(k_lr):
            for j in range(i, k_lr):
                UU[i][j] = UU[j][i] = dot(us[i], us[j])
        UU = torch.stack([torch.stack(row) for row in UU])

    r0n = torch.sqrt(rv0)
    target = r0n * torch.minimum(_f32(kappa_fgr, dev), r0n ** theta)

    # the carry of the Pallas kernel (optimization_tpu/kernels/
    # streamed_cg.py:329-331); r starts as g itself (ghat, stored)
    s = torch.empty_like(g)
    r = g if prec_chunk is None else gf.to(sdt)
    p = torch.empty_like(g)
    zk = torch.zeros(k_lr, dtype=f32, device=dev)
    c = dict(k=torch.zeros((), dtype=torch.int32, device=dev),
             rv=rv0, ar=ar0, nr=nr0, pa=zero, nAp=zero, rv_prev=zero,
             alpha_prev=one, pr=zero, kappa_prev=one, s_p=zero, sk2=zero,
             pp_prev=zero, mval=zero, done=zero, bnd=zero, s_valid=zero,
             p_valid=zero, m=m0, mA=mA0, mB=zk, mp=zk)

    def half(c, pend, apply_s):
        nonlocal s, r, p
        frozen = ((c["done"] != 0) | (c["k"] >= max_iterations)
                  | (torch.sqrt(c["rv"]) <= target))
        first = c["rv_prev"] == 0
        beta = torch.where(first, zero,
                           c["rv"] / torch.where(first, one, c["rv_prev"]))
        m, mA, mB, mp = c["m"], c["mA"], c["mB"], c["mp"]

        Bm = matk(Bm_, m)
        wr = c["ar"] + kdot(m, Bm)
        kappa = wr - (beta / c["alpha_prev"]) * c["rv"]
        pp_k = c["rv"] + beta * beta * c["pp_prev"]
        pr_k = -c["rv"] + beta * (c["pr"] + c["alpha_prev"] * c["kappa_prev"])
        sp_k = beta * (c["s_p"] + c["alpha_prev"] * c["pp_prev"])

        # kernel-of-H safeguard via the |q|^2 recurrence
        Bmp = matk(Bm_, mp)
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

        mp_k = -m + beta * mp
        mB2 = -mA + beta * mB
        Bmpk = matk(Bm_, mp_k)
        UUBmpk = matk(UU, Bmpk)
        m2 = m + crr * (mB2 + UUBmpk)
        nAp2 = c["nr"] - 2.0 * beta * c["pa"] + beta * beta * c["nAp"]

        # ---- the streamed pass over whole vectors ----
        rc = r.to(f32)
        pc = p.to(f32)
        p2 = torch.where(first, -rc, -rc + beta * pc)
        q2 = a0 * p2
        for j in range(k_lr):
            q2 = q2 + Bmpk[j] * us[j]
        r2 = rc + crr * q2
        a0r2 = a0 * r2
        a0p2 = a0 * p2
        rv2, ar2, nr2, pa2 = (dot(r2, r2), dot(a0r2, r2), dot(a0r2, a0r2),
                              dot(a0r2, a0p2))
        mA2 = torch.stack([dot(u, a0r2) for u in us])
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


class _Term(ctypes.Structure):
    """``struct Term`` of ``csrc/streamed_cg.cu``."""

    _fields_ = [("ptr", ctypes.c_void_p), ("c", ctypes.c_float),
                ("b", ctypes.c_float), ("mode", ctypes.c_int),
                ("form", ctypes.c_int)]


_ONE, _AFFINE, _STORED = 0, 1, 2          # Term.mode
_SELF, _TWICE, _SHIFT = 0, 1, 2           # Term.form


def _lib(name: str = "streamed_cg") -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu`` (``streamed_cg`` or
    ``streamed_cg_any``) with its C signatures set."""
    from ..csrc.build import load

    lib = load(name)
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
        lib.streamed_cg_error_string = getattr(lib, f"{name}_error_string")
        lib.streamed_cg_error_string.argtypes = [i32]
        lib.streamed_cg_error_string.restype = ctypes.c_char_p
        if name == "streamed_cg":
            lib.streamed_cg_grid.argtypes = [i32, i32, i32, i32, i64,
                                             ctypes.POINTER(i32)]
            lib.streamed_cg_nacc.argtypes = [i32]
            lib.streamed_cg_launch.argtypes = [
                i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp,
                i32, vp, vp, vp, i32, i64, i32, f, f, f, i32, i32, vp, f, i32,
                vp]
        else:
            lib.streamed_cg_any_grid.argtypes = [
                i32, i32, i32, i32, i32, i32, i64, ctypes.POINTER(i32),
                ctypes.POINTER(i64)]
            lib.streamed_cg_any_plan.argtypes = [
                i32, i32, i32, i32, i32, i32, ctypes.POINTER(i64)]
            lib.streamed_cg_any_launch.argtypes = [
                i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, i32, vp,
                vp, vp, i32, i64, i32, f, f, f, i32, i32, vp, f, i32, vp]
        lib._argtypes_set = True
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.streamed_cg_error_string(code).decode()
        raise RuntimeError(f"streamed_cg {what} failed: CUDA error {code} "
                           f"({msg})")


# csrc/streamed_cg_any.cu's plan constants
SMEM_BLOCK = 232_448           # an H100 block's opt-in shared memory
_TILE = 1024                   # elements a staged tile: a quad a consumer
_RING_STAGES = 4               # the ring's deepest
_VECS = 13                     # the block's K-vectors
_MATS_CAP = 65_536             # B' and U'U in shared memory up to
_FIXED = 1024                  # barriers and block reductions
_LAYOUT = ("group", "chunks", "stages", "stage_bytes", "tables",
           "vectors", "slots", "B_and_UU", "init_rows", "smem_bytes")
_PLACED = ("tables", "vectors", "slots", "B_and_UU", "init_rows")


def _as_f32(v: float) -> float:
    """v rounded to f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", v))[0]


def _round16(b: int) -> int:
    return -(-b // 16) * 16


@dataclasses.dataclass(frozen=True)
class AnyKPlan:
    """The launch plan of ``csrc/streamed_cg_any.cu`` (its ``make_plan``):
    the weights in three classes and where the kernel keeps each array.

    - ``one``: the j of each weight 1 (u = x);
    - ``generated``: (j, c, b) with w_j(i) = c + b f32(i), the form's factor
      (2 for a :class:`ScaledDiagonal`) taken into c and b (f32 values);
    - ``stored``: (j, scale), w_j = scale t_j with t_j read from device
      memory (a stored tensor, or a wrapped callable once evaluated).

    The weight 1 and the generated weights are folded: a pass adds
    (C + D f32(i)) p x into q = Hp (:meth:`fold`), and their dots
    U'(A0 r) come from two sums, sum p x a0r and sum f32(i) p x a0r.  A
    stage of the ring holds a tile of ``_TILE`` elements of r (g on the
    first iteration), p, x, s, a stored a0, a stored P and ``group`` stored
    weights: all of them (``chunks`` = 1) while two such stages fit, else
    ``chunks`` stages a tile (the dots then read the stored weights a
    second time, through L2).  The
    init pass (without ``init=``) rides the same ring and keeps a tile's
    four basis rows (ghat, a0 ghat, p x, (f32(i) - n/2) p x) in
    ``init_rows``.  The placements are True in shared memory, False in
    device memory."""

    k: int
    one: tuple
    generated: tuple
    stored: tuple
    group: int
    chunks: int
    stages: int
    stage_bytes: int
    tables: bool
    vectors: bool
    slots: bool
    B_and_UU: bool
    init_rows: bool
    smem_bytes: int

    def folded(self) -> tuple:
        """The folded weights as the kernel's table has them, in j order:
        (j, c, b); the weight 1 is (j, 1, 0)."""
        return tuple(sorted([(j, 1.0, 0.0) for j in self.one]
                            + list(self.generated)))

    def fold(self, beta) -> tuple:
        """(C, D) with sum_j beta_j w_j(i) = C + D f32(i) over the folded
        weights, summed in double and rounded to f32 as the kernel does."""
        c = d = 0.0
        for j, cj, bj in self.folded():
            c += float(beta[j]) * cj
            d += float(beta[j]) * bj
        return _as_f32(c), _as_f32(d)

    def layout(self) -> dict:
        """The fields the C side computes itself (:func:`any_k_layout`)."""
        return {name: getattr(self, name) for name in _LAYOUT}


def _weight_class(w):
    """("one", ...), ("generated", c, b) or ("stored", scale) of a
    resolved or unresolved weight."""
    scale = 1.0
    if isinstance(w, ScaledDiagonal):
        w, scale = w.a, 2.0
    if w is None:
        return ("one",)
    if isinstance(w, AffineDiagonal):
        return ("generated", scale * _as_f32(w.c), scale * _as_f32(w.b))
    return ("stored", scale)


def any_k_plan(weights: Sequence, *, a0_stored: bool = False,
               storage=torch.float32, prec_kind: int = 0,
               with_init: bool = False, smem: int = SMEM_BLOCK) -> AnyKPlan:
    """The plan of ``csrc/streamed_cg_any.cu`` for these weights (the
    descriptors of :func:`stpcg_flat_streamed`), ``a0_stored`` when A0's
    descriptor is read from device memory (a stored or wrapped a0),
    ``storage`` the vectors' dtype, ``prec_kind`` 0 none, 1 a JacobiPower,
    2 a stored or wrapped P, ``with_init`` when the init group is threaded,
    and ``smem`` bytes of shared memory a block.  The same arithmetic as the
    C side's ``make_plan``: the fixed area, the tables (16 bytes a weight),
    the K-vectors, the dot slots, B' and U'U each placed in shared memory
    while the ring's least (two stages of one stored weight) still fits
    beside them (B' and U'U up to ``_MATS_CAP``); the init pass's four
    basis rows of a tile (16 KiB, unless ``with_init``) over the slots and
    B', U'U; the ring takes the rest."""
    k = len(weights)
    if k < 1:
        raise ValueError("any_k_plan: at least one weight")
    classes = [_weight_class(w) for w in weights]
    one = tuple(j for j, c in enumerate(classes) if c[0] == "one")
    generated = tuple((j, c[1], c[2]) for j, c in enumerate(classes)
                      if c[0] == "generated")
    stored = tuple((j, c[1]) for j, c in enumerate(classes)
                   if c[0] == "stored")
    ks = len(stored)
    size = 2 if storage == torch.bfloat16 else 4
    base = _TILE * (4 * size + 4 * int(a0_stored) + 4 * int(prec_kind == 2))
    term = 4 * _TILE
    reserve = 2 * (base + term)
    used = _FIXED
    placed = {}
    for name, nbytes in (("tables", 16 * k), ("vectors", 4 * _VECS * k)):
        nbytes = _round16(nbytes)
        placed[name] = used + nbytes + reserve <= smem
        used += nbytes if placed[name] else 0
    region = used
    slots = _round16(64 * max(1, ks))
    placed["slots"] = used + slots + reserve <= smem
    used += slots if placed["slots"] else 0
    mats = _round16(8 * k * k)
    placed["B_and_UU"] = mats <= _MATS_CAP and used + mats + reserve <= smem
    used += mats if placed["B_and_UU"] else 0
    rows = 0 if with_init else 16 * _TILE
    placed["init_rows"] = region + rows + reserve <= smem
    if placed["init_rows"]:
        used = max(used, region + rows)
    avail = smem - used
    every = base + term * ks
    if 2 * every <= avail:
        group, chunks, stages = ks, 1, min(_RING_STAGES, avail // every)
    else:
        stages = 3
        group = (avail // 3 - base) // term
        if group < 1:
            stages = 2
            group = (avail // 2 - base) // term
        chunks = -(-ks // group)
    stage_bytes = base + term * group
    used += stages * stage_bytes
    return AnyKPlan(k, one, generated, stored, group, chunks, stages,
                    stage_bytes, placed["tables"],
                    placed["vectors"], placed["slots"], placed["B_and_UU"],
                    placed["init_rows"], used)


def any_k_layout(k: int, n_stored: int = 0, *, a0_stored: bool = False,
                 bf16: bool = False, prec_kind: int = 0,
                 with_init: bool = False, device=None) -> dict:
    """The C side's plan (``csrc/streamed_cg_any.cu``, on the current
    card's shared memory) for rank ``k`` with ``n_stored`` stored weights:
    the fields of :meth:`AnyKPlan.layout` (the placements True in shared
    memory).  Needs the card."""
    lib = _lib("streamed_cg_any")
    out = (ctypes.c_longlong * len(_LAYOUT))()
    with torch.cuda.device(device):
        _raise_on(lib, lib.streamed_cg_any_plan(
            int(bf16), prec_kind, k, n_stored, int(a0_stored),
            int(with_init), out), "plan query")
    return {name: (bool(out[q]) if name in _PLACED else int(out[q]))
            for q, name in enumerate(_LAYOUT)}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % _ALIGN == 0 else t.clone()


def _term_struct(t, form: int, keep: list) -> _Term:
    """The kernel's descriptor of a resolved term (no ElementwiseFn left);
    stored tensors are aligned and kept alive in ``keep``."""
    if t is None:
        return _Term(None, 0.0, 0.0, _ONE, _SELF)
    if isinstance(t, AffineDiagonal):
        return _Term(None, t.c, t.b, _AFFINE, form)
    t = _aligned(t)
    keep.append(t)
    return _Term(t.data_ptr(), 0.0, 0.0, _STORED, form)


def stpcg_flat_streamed(
    g: torch.Tensor,
    x: torch.Tensor,
    B,
    Delta,
    aux_scalars=(),
    *,
    a0_chunk,
    weights: Sequence,
    max_iterations: int = 1000,
    kappa_fgr: float = 0.1,
    theta: float = 0.5,
    epsilon: float = 1e-8,
    body_kind: str = "pair",
    init: Optional[FlatCGInit] = None,
    prec_chunk=None,
    prec=None,
) -> FlatCGResult:
    """Solve the flat trust-region subproblem for H = A0 + U B U' (module
    docstring).  ``g``/``x`` are flat (n,) f32 or bf16 of any length; ``B``
    (k, k) with k = len(weights); ``Delta``, ``aux_scalars``, ``B`` and the
    ``init`` group may be tensors on the card (nothing is read back).
    Returns the :class:`FlatCGResult` of ``stpcg_flat``: s in the storage
    dtype, and the M-norm, iteration count and predicted decrease as
    tensors on g's device.

    ``body_kind``: ``"pair"`` (default) defers each even iteration's s
    coefficient into the next iteration's s update (5n words deferring,
    7n applying); ``"single"`` applies s every iteration (7n).  Each stored
    or wrapped term adds n words a pass.

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
    ``stpcg_flat_streamed.launches``): ``csrc/streamed_cg.cu`` for
    k <= 4, ``csrc/streamed_cg_any.cu`` above.  A launch is two spans
    (``core.profiling.annotate``): ``streamed_cg.prepare`` (the checks, the
    descriptors, the scalar vector) and ``streamed_cg.launch``.
    """
    if g.device.type == "cpu":
        # the plain version checks the call itself
        return stpcg_flat_streamed_reference(
            g, x, B, Delta, aux_scalars, a0_chunk=a0_chunk, weights=weights,
            max_iterations=max_iterations, kappa_fgr=kappa_fgr, theta=theta,
            epsilon=epsilon, body_kind=body_kind, init=init,
            prec_chunk=prec_chunk, prec=prec)
    with annotate("streamed_cg.prepare"):
        _check(g, x, B, aux_scalars, a0_chunk, weights, body_kind, init,
               prec_chunk, prec)
        if g.device.type != "cuda":
            raise ValueError(f"stpcg_flat_streamed runs on CUDA tensors "
                             f"(the kernel) or CPU tensors (the plain "
                             f"version), not {g.device.type}")
        k_lr = len(weights)
        dev = g.device
        n = g.shape[0]
        bf16 = int(g.dtype == torch.bfloat16)
        g, x = _aligned(g), _aligned(x)
        aux = tuple(_f32(a, dev).reshape(()) for a in aux_scalars)
        ev = _Evaluated(n, aux, dev)
        keep: list = []
        terms = (_Term * (1 + k_lr))()
        a0r = _resolve(ev, a0_chunk)
        terms[0] = (_term_struct(a0r.a, _SHIFT, keep)
                    if isinstance(a0r, ShiftedDiagonal)
                    else _term_struct(a0r, _SELF, keep))
        ws = [_resolve(ev, w) for w in weights]
        for j, w in enumerate(ws):
            terms[1 + j] = (_term_struct(w.a, _TWICE, keep)
                            if isinstance(w, ScaledDiagonal)
                            else _term_struct(w, _SELF, keep))
        # the sphere family (2a - aux[0]; 1, 2a on one a) has its own
        # instantiation, which evaluates a once
        sphere = int(k_lr == 2 and isinstance(a0r, ShiftedDiagonal)
                     and ws[0] is None and isinstance(ws[1], ScaledDiagonal)
                     and _same_term(ws[1].a, a0r.a))
        # 0: none, 1: the generated JacobiPower, 2: a stored (or wrapped) p
        generated = isinstance(prec_chunk, JacobiPower)
        prec_kind = 0 if prec_chunk is None else 1 if generated else 2
        stored_p = _aligned(ev(prec_chunk)) if prec_kind == 2 else None

        parts = [_f32(Delta, dev).reshape(1)] + [a.reshape(1) for a in aux]
        if init is not None:
            parts += [_f32(init.rv, dev).reshape(1),
                      _f32(init.ar, dev).reshape(1),
                      _f32(init.nr, dev).reshape(1),
                      _f32(init.m, dev).reshape(k_lr),
                      _f32(init.mA, dev).reshape(k_lr),
                      _f32(init.UU, dev).reshape(k_lr * k_lr)]
        scal = torch.cat(parts)
        Bd = _f32(B, dev).reshape(k_lr, k_lr)
        if k_lr > _UNROLLED_K:
            plan = any_k_plan(ws, a0_stored=terms[0].mode == _STORED,
                              storage=g.dtype, prec_kind=prec_kind,
                              with_init=init is not None)
            tables = _any_tables(plan, ws, keep, dev)
            Bd = Bd.T.contiguous()
        else:
            Bd = Bd.reshape(k_lr * k_lr).contiguous()
    if k_lr > _UNROLLED_K:
        res = _launch_any(plan, bf16, prec_kind, g, x, terms[0], tables, Bd,
                          scal, len(aux), n, stored_p, prec_chunk,
                          max_iterations, kappa_fgr, theta, epsilon,
                          body_kind, init)
        return _result(*res, scal)

    with annotate("streamed_cg.launch"), torch.cuda.device(dev):
        lib = _lib()
        grid = ctypes.c_int(0)
        _raise_on(lib, lib.streamed_cg_grid(bf16, prec_kind, k_lr, sphere,
                                            n, ctypes.byref(grid)),
                  "occupancy query")
        s = torch.empty_like(g)
        r = torch.empty_like(g)
        p = torch.empty_like(g)
        res = torch.empty(4, dtype=torch.float32, device=dev)
        partial = torch.empty(2 * grid.value * lib.streamed_cg_nacc(k_lr),
                              dtype=torch.float64, device=dev)
        code = lib.streamed_cg_launch(
            bf16, prec_kind, k_lr, sphere, g.data_ptr(), x.data_ptr(),
            ctypes.addressof(terms),
            s.data_ptr(), r.data_ptr(), p.data_ptr(), scal.data_ptr(),
            len(aux), Bd.data_ptr(), res.data_ptr(), partial.data_ptr(),
            grid.value, n, int(max_iterations), float(kappa_fgr),
            float(theta), float(epsilon), int(body_kind == "pair"),
            int(init is not None),
            stored_p.data_ptr() if stored_p is not None else None,
            float(prec_chunk.c) if generated else 0.0,
            int(generated and prec_chunk.e == 0.25),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, code, "launch")
    stpcg_flat_streamed.launches += 1
    return _result(s, res, scal)


def _any_tables(plan: AnyKPlan, ws, keep: list, dev) -> torch.Tensor:
    """The kernel's table on the card: a StoredTerm (pointer, j, scale) for
    each stored weight, then a FoldedTerm (j, c, b) for each folded one,
    16 bytes each, sent through pinned memory without a host wait; the
    stored tensors are aligned and kept alive in ``keep``."""
    out = bytearray()
    for j, scale in plan.stored:
        w = ws[j].a if isinstance(ws[j], ScaledDiagonal) else ws[j]
        t = _aligned(w)
        keep.append(t)
        out += struct.pack("=Qif", t.data_ptr(), j, scale)
    for j, c, b in plan.folded():
        out += struct.pack("=iffi", j, c, b, 0)
    raw = torch.frombuffer(out, dtype=torch.uint8)
    return raw.pin_memory().to(dev, non_blocking=True)


def _launch_any(plan, bf16, prec_kind, g, x, a0_term, tables, Bt, scal,
                n_aux, n, stored_p, prec_chunk, max_iterations, kappa_fgr,
                theta, epsilon, body_kind, init):
    """One launch of ``csrc/streamed_cg_any.cu`` (k >= 5) on ``plan``
    (:func:`any_k_plan`): the weights' table ``tables`` a device array
    (:func:`_any_tables`), a0's descriptor by value, B as ``Bt`` = B' (its
    threads read B's columns), and the global scratch sized by the library
    for the grid it picks.  Returns (s, res)."""
    dev = g.device
    k = plan.k
    generated = prec_kind == 1
    ks = len(plan.stored)
    a0_stored = int(a0_term.mode == _STORED)
    with annotate("streamed_cg.launch"), torch.cuda.device(dev):
        lib = _lib("streamed_cg_any")
        grid, nbytes = ctypes.c_int(0), ctypes.c_longlong(0)
        _raise_on(lib, lib.streamed_cg_any_grid(
            bf16, prec_kind, k, ks, a0_stored, int(init is not None), n,
            ctypes.byref(grid), ctypes.byref(nbytes)), "occupancy query")
        s = torch.empty_like(g)
        r = torch.empty_like(g)
        p = torch.empty_like(g)
        res = torch.empty(4, dtype=torch.float32, device=dev)
        scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        code = lib.streamed_cg_any_launch(
            bf16, prec_kind, k, ks, g.data_ptr(), x.data_ptr(),
            ctypes.addressof(a0_term), tables.data_ptr(), s.data_ptr(),
            r.data_ptr(), p.data_ptr(), scal.data_ptr(), n_aux,
            Bt.data_ptr(), res.data_ptr(), scratch.data_ptr(), grid.value, n,
            int(max_iterations), float(kappa_fgr), float(theta),
            float(epsilon), int(body_kind == "pair"), int(init is not None),
            stored_p.data_ptr() if stored_p is not None else None,
            float(prec_chunk.c) if generated else 0.0,
            int(generated and prec_chunk.e == 0.25),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, code, "launch")
    stpcg_flat_streamed.launches += 1
    return s, res


def _result(s, res, scal) -> FlatCGResult:
    """The FlatCGResult of a launch's s and res = (k, boundary, |s|^2,
    model value), on the card."""
    boundary = res[1] > 0.5
    m_norm = torch.where(boundary, scal[0], torch.sqrt(res[2]))
    return FlatCGResult(s=s, update_step_M_norm=m_norm,
                        num_iterations=res[0].to(torch.int32),
                        predicted_decrease=-res[3])


# Kernel launches made by this process (the plain version does not count).
stpcg_flat_streamed.launches = 0
