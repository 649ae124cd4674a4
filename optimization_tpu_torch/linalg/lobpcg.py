"""LOBPCG block eigensolver (Duersch-Shao-Yang-Gu robust variant).

Counterpart of ``optimization_tpu/linalg/lobpcg.py``: the ``nev``
algebraically-smallest eigenpairs of ``A x = lambda B x`` (B SPD) by
Rayleigh-Ritz on the three-block subspace S = [X | W | P], with the same
static-shape soft locking (locked W/P columns zeroed, the Gram pencil
repaired on the masked diagonal, fake pairs classified by their basis
energy and sorted last), randomized 2-norm estimates, the scale-invariant
convergence test, the RR-breakdown freeze, the three ``rr_method`` routes
and the ``warm_start`` carry.

What differs from the JAX module, and why:

- **The Gram stage goes through a hand-written kernel.**  For f32 (and
  bf16) storage ``X0'AX0, X0'BX0`` at the init and ``S'AS, S'BS`` in every
  iteration come from :func:`optimization_tpu_torch.kernels.gram_pair`:
  f32 products and f32 accumulation, the JAX ``_mm`` HIGHEST-precision
  contract.  On a CUDA tensor that launches ``csrc/gram_pair.cu``'s kernel; on
  a CPU tensor it runs its plain version.  float64 keeps ``torch.matmul``:
  the kernel takes f32 or bf16 storage only, and JAX's ``gram_pair`` would
  cut f64 to f32.
- **One batched loop.**  ``lobpcg_fleet``'s ``jax.vmap`` is a leading fleet
  axis written out, and ``lobpcg`` is that loop with a fleet of one.  The
  batched ``while_loop`` semantics of the JAX fleet are kept: every
  instance steps while any is active, and an instance whose own loop
  condition is false keeps its state (so it freezes at its own
  ``num_iterations``).  The loop condition is one host read per iteration.
- **Cholesky does not raise.**  ``torch.linalg.cholesky`` raises where
  JAX's returns NaN; ``cholesky_ex`` and its ``info`` reproduce the NaN
  factor, and the default eigh never sees a non-finite matrix (an instance
  whose pencil is not finite gets NaN eigenpairs without a LAPACK call),
  so a broken pencil freezes the run as in JAX instead of raising.
- **Random numbers.**  ``key=`` is ``generator: torch.Generator | None``,
  which draws the default X0 and the norm-estimate block omega.  The
  default is a generator seeded 0 on the card: on ``X0``'s device when
  ``X0`` is given, on ``data``'s device for a fleet, else on the current
  CUDA device (and no card then raises).  A CPU solve is asked for with
  CPU inputs or a CPU generator.  torch and JAX draw different numbers.
- **Matmul precision.**  Nothing here changes
  ``torch.backends.cuda.matmul.allow_tf32`` or the float32 matmul
  precision: the port relies on PyTorch's full-f32 defaults, which
  ``chip_smoke.py`` asserts before its LOBPCG phase.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..core.debug import pad_value
from ..core.tree import tree_leaves, tree_map

__all__ = ["LOBPCGResult", "lobpcg", "lobpcg_fleet", "rayleigh_ritz"]

_GRAM_DTYPES = (torch.float32, torch.bfloat16)


def _gram(S: torch.Tensor, AS: torch.Tensor, BS: torch.Tensor):
    """``(S'AS, S'BS)`` in S's dtype: the gram_pair kernel (or its plain
    version on the CPU) for f32/bf16 storage, ``torch.matmul`` for f64."""
    if S.dtype in _GRAM_DTYPES:
        # imported here: kernels/ imports linalg/ (flat_cg) at import time
        from ..kernels.fused import gram_pair
        ga, gb = gram_pair(S, AS, BS)
        return ga.to(S.dtype), gb.to(S.dtype)
    St = S.mT
    return St @ AS, St @ BS


def _eigh(M: torch.Tensor):
    """``torch.linalg.eigh`` returning NaN eigenpairs for a non-finite
    matrix, as JAX's eigh does, instead of handing it to LAPACK (which may
    raise "failed to converge").  Batched; no host read."""
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    w, V = torch.linalg.eigh(torch.where(finite[..., None, None], M, eye))
    nan = M.new_full((), float("nan"))      # made on the device: no copy
    return (torch.where(finite[..., None], w, nan),
            torch.where(finite[..., None, None], V, nan))


def _cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization fails (JAX's
    ``jnp.linalg.cholesky`` contract)."""
    L, info = torch.linalg.cholesky_ex(M)
    nan = M.new_full((), float("nan"))
    return torch.where((info == 0)[..., None, None], L, nan)


def _equilibration(B: torch.Tensor) -> torch.Tensor:
    eps = torch.finfo(B.dtype).eps
    bdiag = torch.diagonal(B, dim1=-2, dim2=-1)
    return 1.0 / torch.sqrt(torch.maximum(
        bdiag, eps * bdiag.amax(dim=-1, keepdim=True)))


def rayleigh_ritz(A: torch.Tensor, B: torch.Tensor,
                  eigh_fn: Optional[Callable[[torch.Tensor], Tuple[
                      torch.Tensor, torch.Tensor]]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Robust Rayleigh-Ritz for the dense symmetric pencil (A, B), B PSD.

    Returns ``(Theta, C)`` with ``C' A C = diag(Theta)`` and ``C' B C = I``
    on the numerically independent subspace, eigenvalues ascending: B is
    equilibrated by its diagonal, whitened through its eigendecomposition
    with spectral filtering (directions of relative eigenvalue below
    ``n eps`` deflate: zero C columns, a Gershgorin-bound sentinel Ritz
    value that sorts last), then the whitened A is solved.  Leading batch
    dims are instances.  ``eigh_fn`` overrides the dense symmetric
    eigensolver (default ``torch.linalg.eigh``, guarded against non-finite
    input).
    """
    if eigh_fn is None:
        eigh_fn = _eigh
    n = B.shape[-1]
    eps = torch.finfo(B.dtype).eps
    d = _equilibration(B)
    A_eq = A * d[..., :, None] * d[..., None, :]
    B_eq = B * d[..., :, None] * d[..., None, :]
    B_eq = 0.5 * (B_eq + B_eq.mT)

    w, Q = eigh_fn(B_eq)
    good = w > (n * eps) * w.amax(dim=-1, keepdim=True)
    inv_sqrt_w = torch.where(
        good, 1.0 / torch.sqrt(torch.where(good, w, torch.ones_like(w))),
        torch.zeros_like(w))
    W_half = Q * inv_sqrt_w[..., None, :]     # W' B_eq W = I on the good set
    At = (W_half.mT @ A_eq) @ W_half
    At = 0.5 * (At + At.mT)
    # deflated rows/cols of At are zero: a Gershgorin-bound sentinel on
    # their diagonal decouples them and sorts their fake eigenvalues last
    big = At.abs().sum(dim=-1).amax(dim=-1, keepdim=True) + 1.0
    At = At + torch.diag_embed(torch.where(good, torch.zeros_like(w), big))
    theta, U = eigh_fn(At)
    C = W_half @ U
    return theta, C * d[..., :, None]


def _rayleigh_ritz_chol(A: torch.Tensor, B: torch.Tensor, eigh_fn=None,
                        u_prev=None, jacobi_sweeps: int = 6):
    """Rayleigh-Ritz via two-pass shifted Cholesky whitening: one eigh per
    call instead of :func:`rayleigh_ritz`'s two (the fleet default).

    As in the JAX module: factor ``B_eq + 16 n eps I`` (``8 n^2 eps`` where
    that fails), whiten twice (the second pass at shift 1/8 collapses the
    first pass's kappa*eps orthonormality error), solve the whitened
    pencil, then deflate columns whose true B-mass is below 0.5 (zero
    column, sentinel Ritz value) and B-normalize the rest with unshifted
    Rayleigh quotients.  ``ok`` reports genuine breakdown only (non-finite
    Ritz values).  ``u_prev`` warm-starts the eigh as a threshold-Jacobi
    solve (``rr_method="chol_warm"``) and adds the raw eigenvectors to the
    return.  Returns ``(theta, C, ok)`` or ``(theta, C, ok, U)``,
    eigenvalues ascending (stable order), deflated columns last.  Leading
    batch dims are instances.
    """
    if eigh_fn is None:
        eigh_fn = _eigh
    n = B.shape[-1]
    eps = torch.finfo(B.dtype).eps
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    d = _equilibration(B)
    A_eq = A * d[..., :, None] * d[..., None, :]
    B_eq = 0.5 * (B + B.mT) * d[..., :, None] * d[..., None, :]

    def tri_inv(L):
        return torch.linalg.solve_triangular(L, eye, upper=False)

    # sharp shift first, safe shift where the sharp factor fails
    d_lo = 16.0 * n * eps
    d_hi = 8.0 * n * n * eps
    L1a = _cholesky(B_eq + d_lo * eye)
    sharp_ok = torch.isfinite(L1a).all(dim=-1).all(dim=-1)
    delta = torch.where(sharp_ok, B.new_full((), d_lo), B.new_full((), d_hi))
    L1 = torch.where(sharp_ok[..., None, None], L1a,
                     _cholesky(B_eq + d_hi * eye))
    L1i = tri_inv(L1)
    A1 = (L1i @ A_eq) @ L1i.mT
    B1 = (L1i @ B_eq) @ L1i.mT              # ~ I up to kappa*eps + shift
    L2 = _cholesky(0.5 * (B1 + B1.mT) + 0.125 * eye)
    L2i = tri_inv(L2)
    At = (L2i @ A1) @ L2i.mT
    At = 0.5 * (At + At.mT)
    if u_prev is not None:
        from .jacobi import jacobi_eigh
        theta0, U = jacobi_eigh(At, v0=u_prev, max_sweeps=jacobi_sweeps)
    else:
        theta0, U = eigh_fn(At)
    C = (L2i @ L1i).mT @ U

    # true (unshifted) per-column B-mass: deflation detect + polish
    BC = B_eq @ C
    b = (C * BC).sum(dim=-2)
    finite = (torch.isfinite(C).all(dim=-2) & torch.isfinite(b)
              & torch.isfinite(theta0))
    spurious = (b < 0.5) | ~finite
    C = torch.where(spurious[..., None, :], torch.zeros_like(C),
                    C / torch.sqrt(torch.maximum(
                        b, delta[..., None]))[..., None, :])
    # unshifted Rayleigh refresh (B-normalized columns: denominator 1)
    theta = (C * (A_eq @ C)).sum(dim=-2)
    big = At.abs().sum(dim=-1).amax(dim=-1, keepdim=True) + 1.0
    theta = torch.where(spurious, big.expand_as(theta), theta)
    ok = torch.isfinite(theta0).all(dim=-1)
    order = torch.argsort(theta, dim=-1, stable=True)
    theta = torch.take_along_dim(theta, order, dim=-1)
    C = torch.take_along_dim(C, order[..., None, :], dim=-1) * d[..., :, None]
    if u_prev is not None:
        return theta, C, ok, torch.take_along_dim(U, order[..., None, :],
                                                  dim=-1)
    return theta, C, ok


class LOBPCGResult(NamedTuple):
    theta: torch.Tensor           # (nev,) Ritz values
    X: torch.Tensor               # (m, nev) Ritz vectors
    num_iterations: torch.Tensor
    num_converged: torch.Tensor
    residual_norms: torch.Tensor  # (nev,) at exit
    # True iff every iteration's repaired pencil decoupled as designed (the
    # masked fake pairs were all identified by their basis energy).
    pencil_consistent: Any = True
    # Per-iteration traces (NaN/-1 beyond num_iterations): max residual over
    # the nev wanted pairs, and the converged-prefix count.
    residual_trace: Optional[torch.Tensor] = None
    nc_trace: Optional[torch.Tensor] = None
    # Full loop state; pass back as ``warm_start=`` to resume exactly.
    warm_start: Optional[tuple] = None


class _State(NamedTuple):
    k: torch.Tensor
    X: torch.Tensor
    AX: torch.Tensor
    BX: torch.Tensor
    R: torch.Tensor
    P: torch.Tensor
    theta: torch.Tensor
    nc: torch.Tensor
    r: torch.Tensor
    done: torch.Tensor
    ok: torch.Tensor
    residual_trace: torch.Tensor
    nc_trace: torch.Tensor
    # raw eigenvector seed of the whitened RR pencil ("chol_warm" only;
    # () otherwise, so the carry's structure stays uniform)
    Useed: object = ()


_CARRY = ("X", "AX", "BX", "R", "P", "theta", "nc", "r", "ok", "Useed")


def _randn(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """Standard normals drawn on the generator's device, moved to
    ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def _where(pred: torch.Tensor, new, old):
    """Per-instance select over a leading fleet axis (``()`` passes)."""
    if isinstance(new, tuple):
        return new
    return torch.where(pred.reshape(pred.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _block(size: int, axis, device):
    """``(total, offset)`` of this rank's block of ``size`` rows (or
    instances) along a mesh axis: the all-gathered sizes, summed, and the
    ones of the ranks before it."""
    import torch.distributed as dist

    from ..parallel.collectives import axis_group

    group = axis_group(axis)
    mine = torch.tensor([size], dtype=torch.int64, device=device)
    sizes = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(sizes, mine, group=group)
    sizes = [int(t) for t in sizes]
    return sum(sizes), sum(sizes[:dist.get_rank(group)])


def _run(Aop, Bop, Top, has_B: bool, *, X0, fleet: int, m: int, nx: int,
         nev: int, max_iterations: int, tau, generator, user_function,
         warm_start, eigh_fn, rr_method: str, dtype, device, row_axis=None,
         row_block=None, fleet_block=None) -> LOBPCGResult:
    """The batched LOBPCG loop over a leading fleet axis of size ``fleet``.
    ``Aop``/``Bop``/``Top`` map (F, m, k) blocks to (F, m, k) blocks;
    ``eigh_fn`` takes (F, n, n) batches; ``user_function`` (fleet of one
    only) sees the unbatched iterate.

    ``row_axis``, ``row_block = (total, offset)``: the m rows are this
    rank's block of a basis row-sharded over that mesh axis; every
    reduction over rows is all-reduced (the Gram stage through
    ``collectives.sharded_gram_pair``).  ``fleet_block = (total,
    offset)``: the instances are this block of a larger fleet.  Either way
    omega is drawn whole and sliced, so every instance sees the numbers of
    the unsharded solve."""
    warm_rr = rr_method == "chol_warm"
    if row_axis is None:
        gram = _gram
        norm = torch.linalg.vector_norm
    else:
        from ..parallel import collectives

        def gram(S, AS, BS):
            return collectives.sharded_gram_pair(S, AS, BS, row_axis)

        def norm(M, dim):
            return torch.sqrt(collectives.psum_scalar(
                (M * M).sum(dim=dim), row_axis))
    if rr_method == "eigh":
        def rr_init(Am, Bm):
            th, Cm = rayleigh_ritz(Am, Bm, eigh_fn=eigh_fn)
            return th, Cm, torch.ones(th.shape[:-1], dtype=torch.bool,
                                      device=th.device)
    else:
        def rr_init(Am, Bm):
            return _rayleigh_ritz_chol(Am, Bm, eigh_fn=eigh_fn)

    def rr(Am, Bm, useed):
        """(theta, C, ok, next seed); the init pencil is never seeded."""
        if warm_rr:
            return _rayleigh_ritz_chol(Am, Bm, eigh_fn=eigh_fn, u_prev=useed)
        return (*rr_init(Am, Bm), useed)

    # randomized 2-norm estimates (reference LOBPCG.h:199-214)
    if row_block is None and fleet_block is None:
        omega = _randn((fleet, m, nx), generator, dtype, device)
        omega_norm = torch.linalg.vector_norm(omega, dim=(-2, -1))
    else:
        f_tot, f_off = fleet_block or (fleet, 0)
        m_tot, m_off = row_block or (m, 0)
        omega = _randn((f_tot, m_tot, nx), generator, dtype, device)[
            f_off:f_off + fleet]
        omega_norm = torch.linalg.vector_norm(omega, dim=(-2, -1))
        omega = omega[:, m_off:m_off + m]
    A2normest = norm(Aop(omega), dim=(-2, -1)) / omega_norm
    B2normest = (norm(Bop(omega), dim=(-2, -1))
                 / omega_norm if has_B
                 else torch.ones(fleet, dtype=dtype, device=device))
    # sentinel eigenvalue of the masked basis columns (fake pairs are
    # identified by energy, so its value carries no correctness weight)
    pos_sent = 16.0 * (A2normest + B2normest) + 1.0

    n_trace = max(max_iterations, 1)
    residual_trace = torch.full((fleet, n_trace), pad_value(), dtype=dtype,
                                device=device)
    nc_trace = torch.full((fleet, n_trace), -1, dtype=torch.int32,
                          device=device)

    if warm_start is None:
        # initialization: B-orthonormalize X0 (reference LOBPCG.h:218-230)
        AX = Aop(X0)
        BX = Bop(X0)
        theta0, C0, ok0 = rr_init(*gram(X0, AX, BX))
        X = X0 @ C0
        AX = AX @ C0
        BX = BX @ C0
        R = AX - BX * theta0[:, None, :]
        k0 = torch.zeros(fleet, dtype=torch.int32, device=device)
        st = _State(
            k=k0, X=X, AX=AX, BX=BX, R=R, P=torch.zeros_like(X),
            theta=theta0,
            nc=torch.zeros(fleet, dtype=torch.int32, device=device),
            r=norm(R[:, :, :nev], dim=-2),
            done=torch.zeros(fleet, dtype=torch.bool, device=device),
            ok=ok0, residual_trace=residual_trace, nc_trace=nc_trace,
            Useed=(torch.eye(3 * nx, dtype=dtype, device=device).expand(
                fleet, 3 * nx, 3 * nx).clone() if warm_rr else ()))
    else:
        k0, carry = warm_start
        # done survives the resume for both stop channels: converged, and
        # the RR-breakdown freeze (ok False)
        st = _State(k=k0, done=(carry["nc"] >= nev) | ~carry["ok"],
                    residual_trace=residual_trace, nc_trace=nc_trace,
                    **{key: carry[key] for key in _CARRY})

    col = torch.arange(nx, device=device)
    slots = torch.arange(n_trace, device=device)
    ones_x = torch.ones(fleet, nx, dtype=torch.bool, device=device)
    n_s = 3 * nx

    def body(st: _State) -> _State:
        k = st.k + 1

        # preconditioned search directions (reference LOBPCG.h:247)
        W = Top(st.R)
        # soft locking: only the active trailing columns of W and P enter
        w_mask = col[None, :] >= st.nc[:, None]
        p_mask = w_mask & (k > 1)[:, None]
        S = torch.cat([st.X, W * w_mask[:, None, :],
                       st.P * p_mask[:, None, :]], dim=-1)
        AS = Aop(S)
        BS = Bop(S)
        StAS, StBS = gram(S, AS, BS)

        # repair the pencil on masked columns: unit B-diagonal, sentinel
        # A-diagonal => exact decoupling into the active block plus fakes
        mask_s = torch.cat([ones_x, w_mask, p_mask], dim=-1).to(dtype)
        off = 1.0 - mask_s
        mm = mask_s[:, :, None] * mask_s[:, None, :]
        StAS = StAS * mm + torch.diag_embed(pos_sent[:, None] * off)
        StBS = StBS * mm + torch.diag_embed(off)

        theta_all, C, rr_ok, Useed_new = rr(StAS, StBS, st.Useed)

        # fake pairs carry energy 1 on the masked coordinates, active ones
        # 0: sorting (theta, fakes -> +inf) makes the wanted pairs the
        # static leading window
        energy = ((C * off[:, :, None]) ** 2).sum(dim=-2)
        is_fake = energy > 0.5
        sort_key = torch.where(is_fake, theta_all.new_full((), float("inf")),
                               theta_all)
        order = torch.argsort(sort_key, dim=-1, stable=True)[:, :nx]
        theta = torch.take_along_dim(theta_all, order, dim=-1)
        C_x = (torch.take_along_dim(C, order[:, None, :], dim=-1)
               * mask_s[:, :, None])

        n_fake = (n_s - mask_s.sum(dim=-1)).to(torch.int32)
        ok = st.ok & rr_ok & (is_fake.sum(dim=-1).to(torch.int32) == n_fake)

        X_new = S @ C_x
        AX_new = AS @ C_x
        BX_new = BS @ C_x
        R_new = AX_new - BX_new * theta[:, None, :]
        # implicit-difference block P (reference LOBPCG.h:288)
        P_new = S[:, :, nx:] @ C_x[:, nx:, :]

        # convergence test (reference LOBPCG.h:292-318)
        r = norm(R_new[:, :, :nev], dim=-2)
        x_norms = norm(X_new[:, :, :nev], dim=-2)
        tolerances = tau * (A2normest[:, None] + B2normest[:, None]
                            * theta[:, :nev].abs()) * x_norms
        converged = r <= tolerances
        # contiguous converged prefix (soft locking respects order)
        nc = torch.cumprod(converged.to(torch.int32), dim=-1).sum(
            dim=-1).to(torch.int32)

        done = nc >= nev
        if user_function is not None:
            stop = user_function(k[0], nev, theta[0], X_new[0], r[0], nc[0])
            done = done | torch.as_tensor(stop, device=device).reshape(1)

        # RR breakdown (the chol routes): freeze at the last good state and
        # stop, flagged, instead of letting NaN poison the iterate
        X_new, AX_new, BX_new = (_where(rr_ok, X_new, st.X),
                                 _where(rr_ok, AX_new, st.AX),
                                 _where(rr_ok, BX_new, st.BX))
        R_new, P_new = _where(rr_ok, R_new, st.R), _where(rr_ok, P_new, st.P)
        theta, nc, r = (_where(rr_ok, theta, st.theta),
                        _where(rr_ok, nc, st.nc), _where(rr_ok, r, st.r))
        if warm_rr:
            Useed_new = _where(rr_ok, Useed_new, st.Useed)
        done = done | ~rr_ok

        at = slots[None, :] == (k - 1 - k0)[:, None]
        return _State(
            k=k, X=X_new, AX=AX_new, BX=BX_new, R=R_new, P=P_new,
            theta=theta, nc=nc, r=r, done=done, ok=ok,
            residual_trace=torch.where(at, r.amax(dim=-1)[:, None],
                                       st.residual_trace),
            nc_trace=torch.where(at, nc[:, None], st.nc_trace),
            Useed=Useed_new if warm_rr else ())

    while True:
        # the batched while_loop: step while any instance is active; an
        # inactive instance keeps its state (one host read per iteration)
        active = (st.k - k0 < max_iterations) & ~st.done
        if not bool(active.any()):
            break
        new = body(st)
        # (a fleet of one is active here, so nothing needs selecting)
        st = new if fleet == 1 else _State(
            *(_where(active, a, b) for a, b in zip(new, st)))

    carry = dict(X=st.X, AX=st.AX, BX=st.BX, R=st.R, P=st.P, theta=st.theta,
                 nc=st.nc, r=st.r, ok=st.ok, Useed=st.Useed)
    return LOBPCGResult(
        theta=st.theta[:, :nev], X=st.X[:, :, :nev],
        num_iterations=st.k, num_converged=st.nc, residual_norms=st.r,
        pencil_consistent=st.ok, residual_trace=st.residual_trace,
        nc_trace=st.nc_trace, warm_start=(st.k, carry))


def _check(rr_method: str, m: int, nx: int, nev: int) -> None:
    if rr_method not in ("eigh", "chol", "chol_warm"):
        raise ValueError('rr_method must be "eigh", "chol", or "chol_warm"')
    if nev > nx:
        raise ValueError("Block size nx must be greater than or equal to "
                         "the number nev of desired eigenpairs")
    if nx > m:
        raise ValueError("Block size nx must be less than or equal to "
                         "the dimension m of the problem")


def _default_generator(generator, like: Optional[torch.Tensor]):
    """``generator``, or one seeded 0 on ``like``'s device, or on the card
    when there is no ``like``: the CPU is what a caller asks for."""
    if generator is not None:
        return generator
    if like is None and not torch.cuda.is_available():
        raise RuntimeError(
            "LOBPCG draws its default X0 on the card and there is no CUDA "
            "device: pass X0, or a generator (a CPU one for a CPU solve)")
    device = like.device if like is not None else torch.device("cuda")
    return torch.Generator(device=device).manual_seed(0)


def lobpcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    B: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    T: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    X0: Optional[torch.Tensor] = None,
    m: Optional[int] = None,
    nx: Optional[int] = None,
    nev: int,
    max_iterations: int = 100,
    tau: float = 1e-6,
    generator: Optional[torch.Generator] = None,
    user_function: Optional[Callable[..., Any]] = None,
    warm_start: Optional[tuple] = None,
    eigh_fn: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                     torch.Tensor]]] = None,
    rr_method: str = "eigh",
    axis=None,
) -> LOBPCGResult:
    """Smallest ``nev`` eigenpairs of ``A x = lambda B x``.

    - ``A(S)``: symmetric block operator on (m, k) matrices.
    - ``B``: optional SPD block operator (absent => standard eigenproblem).
    - ``T``: optional SPD preconditioner approximating A^{-1}.
    - ``X0``: (m, nx) initial block; if omitted, a Gaussian block of shape
      (m, nx) in the default dtype is drawn from ``generator``, on its
      device.
    - ``tau``: scale-invariant convergence tolerance.
    - ``generator``: draws the default X0 and the norm-estimate block
      (default: seeded 0, on X0's device, or on the card when X0 is
      omitted; a CPU generator asks for a CPU solve).
    - ``user_function(k, nev, theta, X, r, nc) -> bool``: optional stopping
      predicate.
    - ``warm_start``: a ``result.warm_start`` tuple from a previous call with
      the same operators and shapes: resumes the iteration exactly
      (``max_iterations`` then counts additional iterations).
    - ``eigh_fn``: dense symmetric eigensolver for the Rayleigh-Ritz pencils
      (default ``torch.linalg.eigh``); called on (n, n) matrices.
    - ``rr_method``: ``"eigh"`` (deflating eigh whitening), ``"chol"``
      (shifted-Cholesky whitening: one eigh per iteration, ill-conditioning
      reported via ``pencil_consistent``) or ``"chol_warm"`` (the chol
      route with its eigh a threshold-Jacobi solve seeded by the previous
      iteration's rotation).
    - ``axis``: a mesh axis (``parallel.collectives``) over which the
      basis is row-sharded.  Then ``X0`` (or ``m``) is this rank's block
      of rows, ``A``/``B``/``T`` map this rank's rows of a block, every
      reduction over rows is all-reduced (the Gram stage through
      ``collectives.sharded_gram_pair``, the kernel on this rank's
      rows), and the random blocks are drawn whole and sliced.  Every
      rank of the axis makes the call; each returns its rows of X.

    f32 and bf16 storage take the Gram stage through the ``gram_pair``
    kernel (its plain version on the CPU); f64 through ``torch.matmul``.
    """
    if X0 is None:
        if m is None or nx is None:
            raise ValueError("Either X0 or (m, nx) must be supplied")
    else:
        m, nx = X0.shape
    generator = _default_generator(generator, X0)
    m_tot, m_off = ((m, 0) if axis is None else _block(
        m, axis, generator.device if X0 is None else X0.device))
    _check(rr_method, m_tot, nx, nev)
    if X0 is None:
        X0 = _randn((m_tot, nx), generator, torch.get_default_dtype(),
                    generator.device)[m_off:m_off + m]
    if eigh_fn is not None:
        user_eigh = eigh_fn

        def eigh_fn(M):
            w, V = user_eigh(M[0])
            return w[None], V[None]

    if warm_start is not None:
        k0, carry = warm_start
        warm_start = (torch.as_tensor(k0, device=X0.device).reshape(1),
                      tree_map(lambda t: t[None], carry))
    res = _run(lambda S: A(S[0])[None],
               (lambda S: B(S[0])[None]) if B is not None else (lambda S: S),
               (lambda S: T(S[0])[None]) if T is not None else (lambda S: S),
               B is not None, X0=X0[None], fleet=1, m=m, nx=nx, nev=nev,
               max_iterations=max_iterations, tau=tau, generator=generator,
               user_function=user_function, warm_start=warm_start,
               eigh_fn=eigh_fn, rr_method=rr_method, dtype=X0.dtype,
               device=X0.device, row_axis=axis,
               row_block=None if axis is None else (m_tot, m_off))
    return tree_map(lambda t: t[0], res)


def lobpcg_fleet(
    A: Callable[[torch.Tensor, Any], torch.Tensor],
    data: Any,
    *,
    B: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None,
    T: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None,
    X0: Optional[torch.Tensor] = None,
    m: Optional[int] = None,
    nx: Optional[int] = None,
    nev: int,
    max_iterations: int = 100,
    tau: float = 1e-6,
    generator: Optional[torch.Generator] = None,
    eigh_fn: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                     torch.Tensor]]] = None,
    rr_method: str = "chol",
    warm_start: Optional[tuple] = None,
    axis=None,
) -> LOBPCGResult:
    """Fleet-batched LOBPCG: one three-block iteration across many
    same-shaped pencils.

    - ``A(S, data_i)`` (and optional ``B``/``T``): per-instance operators
      reading the instance slice of ``data`` (a pytree of tensors stacked on
      a leading fleet axis); they are applied to the fleet through
      ``torch.func.vmap``.
    - ``X0``: optional (fleet, m, nx) initial blocks; default Gaussian
      blocks from ``generator``, on ``data``'s device.
    - ``generator``: default seeded 0 on ``data``'s device.
    - ``eigh_fn``: takes the (fleet, n, n) batch (``torch.linalg.eigh`` and
      ``jacobi_eigh`` batch natively).
    - Remaining arguments as :func:`lobpcg`.

    A resume (``warm_start``) takes the same ``X0``/``m``/``nx`` as the
    first call, as :func:`lobpcg` does, and draws the same omega.  (The JAX
    fleet ignores ``X0`` on a resume and draws a default X0 first, so there
    it needs ``m, nx`` and a first call with ``X0`` resumes with another
    omega: ROADMAP Queue 3.)

    Every instance steps while any is active, as the JAX package's vmapped
    ``while_loop`` does: an instance that converges (or freezes) early keeps
    its state from then on and reports its own ``num_iterations``.  The
    Gram stage is one batched ``gram_pair`` launch per iteration, the
    Rayleigh-Ritz eigh/cholesky/triangular solves batch natively.

    ``axis``: a mesh axis (``parallel.collectives``) over which the fleet
    is split: ``data`` (and ``X0``) hold this rank's contiguous block of
    instances, the same count on every rank.  The random blocks are drawn
    for the whole fleet and sliced, no collective runs inside the loop
    (the instances do not interact), and the results are all-gathered:
    every rank returns the whole fleet's, equal to the unsharded fleet's.
    A sharded fleet does not take ``warm_start``.

    Returns an :class:`LOBPCGResult` whose fields carry a leading fleet axis
    (``warm_start`` too, which resumes the fleet).
    """
    leaf = tree_leaves(data)[0]
    fleet = leaf.shape[0]
    generator = _default_generator(generator, leaf)
    block = None
    if axis is not None:
        if warm_start is not None:
            raise ValueError("a fleet sharded over an axis does not resume "
                             "from warm_start")
        import torch.distributed as dist

        from ..parallel.collectives import axis_group
        block = _block(fleet, axis, leaf.device)
        if block[0] != fleet * dist.get_world_size(axis_group(axis)):
            raise ValueError("a sharded fleet needs the same number of "
                             "instances on every rank")

    def per_instance(op):
        batched = torch.func.vmap(op)
        return lambda S: batched(S, data)

    if warm_start is not None:
        # the resume draws what the first call drew before omega (the
        # default X0, unless X0 is given), so every chunk draws one omega
        X_like = warm_start[1]["X"]
        m, nx = X_like.shape[-2:]
        dtype, device = X_like.dtype, X_like.device
        if X0 is None:
            _randn((fleet, m, nx), generator, dtype, device)
        X0 = None
    else:
        if X0 is None:
            if m is None or nx is None:
                raise ValueError("Either X0 or (m, nx) must be supplied")
            f_tot, f_off = block or (fleet, 0)
            X0 = _randn((f_tot, m, nx), generator, torch.get_default_dtype(),
                        leaf.device)[f_off:f_off + fleet]
        m, nx = X0.shape[-2:]
        dtype, device = X0.dtype, X0.device
    _check(rr_method, m, nx, nev)
    res = _run(per_instance(A),
               per_instance(B) if B is not None else (lambda S: S),
               per_instance(T) if T is not None else (lambda S: S),
               B is not None, X0=X0, fleet=fleet, m=m, nx=nx, nev=nev,
               max_iterations=max_iterations, tau=tau, generator=generator,
               user_function=None, warm_start=warm_start, eigh_fn=eigh_fn,
               rr_method=rr_method, dtype=dtype, device=device,
               fleet_block=block)
    if axis is None:
        return res
    from ..parallel.sharding import _all_gather_batch
    return _all_gather_batch(res, axis)
