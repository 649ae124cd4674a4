"""The port's LOBPCG == the JAX package's, on one numpy input.

``optimization_tpu_torch/linalg/lobpcg.py`` against
``optimization_tpu/linalg/lobpcg.py``: the two Rayleigh-Ritz routes on the
n = 7 invariants fixture, then ``lobpcg`` on ``tests/test_lobpcg.py``'s
fixture (A = diag(linspace(-N/2, N/2)), B = diag(1..N), T = |A|, N = 1000,
nx = 10, nev = 5, f64) and ``lobpcg_fleet``, X0 made with numpy and given to
both.  Tolerances, each with its reason:

- the norm-estimate block omega is drawn from each package's own random
  numbers, so ``A2normest`` — and with it the convergence tolerances —
  differ by a few percent.  Iterate parity is therefore held with the test
  disarmed (tau = 1e-30, a fixed K = 30): every Ritz value within 1e-9
  relative, every per-iteration residual within 1e-8 relative (LAPACK
  builds round the small eigh differently; measured ~1e-11 after 30
  Rayleigh-Ritz steps);
- converged runs: the same ``num_converged``, theta within 1e-9 relative
  of JAX's, and ``num_iterations`` within 1 — except the eigh route on the
  two preconditioned problems, which crawl for 400+ iterations (T = |A| is
  a poor preconditioner) and whose count drifts with the eigh's rounding
  (measured 410/405 and 426/434): within 3% there;
- eigenvectors only up to sign: subspaces are compared through
  |X_t' X_j| (singular values 1 within 1e-8);
- f32 (the Gram stage through ``gram_pair``'s plain version): with the
  test disarmed (tau = 1e-30, K = 4) theta within 1e-4 of JAX's f32 theta
  (measured 7e-6; each package is 8e-5 from its own f64 run, so 1e-4 is
  f32 rounding, while a Gram-stage error moves theta by far more).
  Converged (tau = 1e-4): theta within 5e-2 of the truth in both packages
  (config3's f32 floor: eps * ||A|| ~ 2.4e-3 at m = 2e4) and within 2e-2
  of JAX's (measured 8.1e-3: the pairs soft-lock at tolerances made from
  each package's own omega, so they freeze at other residuals, and a
  Ritz value is only as close as r^2 / gap); iterations within 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optimization_tpu.linalg.lobpcg import (
    _rayleigh_ritz_chol as j_rr_chol, lobpcg as j_lobpcg,
    lobpcg_fleet as j_lobpcg_fleet, rayleigh_ritz as j_rayleigh_ritz)
from optimization_tpu_torch.core.debug import pad_value
from optimization_tpu_torch.kernels import fused as F
from optimization_tpu_torch.linalg.lobpcg import (
    _rayleigh_ritz_chol as t_rr_chol, lobpcg as t_lobpcg,
    lobpcg_fleet as t_lobpcg_fleet, rayleigh_ritz as t_rayleigh_ritz)

torch.set_num_threads(1)

N = 1000
NX = 10
NEV = 5
TAU = 1e-8

AD = np.linspace(-0.5 * N, 0.5 * N, N)
BD = np.linspace(1.0, N, N)
X0 = np.random.default_rng(0).standard_normal((N, NX))


def _ops(problem):
    """(JAX kwargs, torch kwargs) of the fixture's A, B, T for one of the
    four problems of tests/test_lobpcg.py."""
    aj, bj = jnp.asarray(AD), jnp.asarray(BD)
    at, bt = torch.from_numpy(AD), torch.from_numpy(BD)
    jk = dict(A=lambda S: aj[:, None] * S)
    tk = dict(A=lambda S: at[:, None] * S)
    if problem in ("generalized", "preconditioned_generalized"):
        jk["B"] = lambda S: bj[:, None] * S
        tk["B"] = lambda S: bt[:, None] * S
    if problem in ("preconditioned", "preconditioned_generalized"):
        jk["T"] = lambda S: jnp.abs(aj)[:, None] * S
        tk["T"] = lambda S: at.abs()[:, None] * S
    return jk, tk


def _truth(problem):
    if problem in ("generalized", "preconditioned_generalized"):
        return np.sort(AD / BD)[:NEV]
    return AD[:NEV]


def _solve(problem, x0=X0, **kw):
    jk, tk = _ops(problem)
    jr = j_lobpcg(jk.pop("A"), X0=jnp.asarray(x0), **jk, **kw)
    tr = t_lobpcg(tk.pop("A"), X0=torch.from_numpy(x0), **tk, **kw)
    return jr, tr


def _assert_padded(trace):
    """Trace slots past the count hold the padding: NaN, or 0.0 under the
    OPTTPU_DEBUG_NANS sanitizer tier."""
    t = trace.numpy()
    np.testing.assert_array_equal(t, np.full_like(t, pad_value()))


def _assert_same_subspace(Xt, Xj, atol=1e-8):
    """Column spaces equal: the singular values of Q_t' Q_j are all 1."""
    qt, _ = np.linalg.qr(Xt)
    qj, _ = np.linalg.qr(Xj)
    s = np.linalg.svd(qt.T @ qj, compute_uv=False)
    np.testing.assert_allclose(s, 1.0, atol=atol)


# ---------------------------------------------------------------------------
# Rayleigh-Ritz
# ---------------------------------------------------------------------------


def _invariants_pencil():
    n = 7
    rng = np.random.default_rng(5)
    AL = rng.uniform(-1, 1, (n, n))
    BL = rng.uniform(-1, 1, (n, n))
    return -AL @ AL.T, BL @ BL.T + 1e-3 * np.eye(n)


@pytest.mark.parametrize("route", ["eigh", "chol"])
def test_rayleigh_ritz_invariants_match_jax(route):
    A, B = _invariants_pencil()
    if route == "eigh":
        tj, Cj = j_rayleigh_ritz(jnp.asarray(A), jnp.asarray(B))
        tt, Ct = t_rayleigh_ritz(torch.from_numpy(A), torch.from_numpy(B))
    else:
        tj, Cj, okj = j_rr_chol(jnp.asarray(A), jnp.asarray(B))
        tt, Ct, okt = t_rr_chol(torch.from_numpy(A), torch.from_numpy(B))
        assert bool(okt) and bool(okj)
    tj, Cj, tt, Ct = np.asarray(tj), np.asarray(Cj), tt.numpy(), Ct.numpy()
    np.testing.assert_allclose(tt, tj, rtol=1e-10, atol=1e-12)
    assert (np.diff(tt) >= 0).all()
    # C' A C = diag(theta), C' B C = I (the JAX test's bounds)
    assert np.linalg.norm(Ct.T @ A @ Ct - np.diag(tt)) < 1e-8
    assert np.linalg.norm(Ct.T @ B @ Ct - np.eye(7)) < 1e-8
    sign = np.sign(np.sum(Ct * Cj, axis=0))
    np.testing.assert_allclose(Ct, Cj * sign, rtol=0, atol=1e-8)


def test_rayleigh_ritz_deflates_like_jax():
    """A rank-deficient B: the deflated directions come back as zero C
    columns with the Gershgorin sentinel, sorted last, in both packages."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((9, 5))
    B = X @ X.T                                   # rank 5 of 9
    A = rng.standard_normal((9, 9))
    A = A + A.T
    tj, Cj = j_rayleigh_ritz(jnp.asarray(A), jnp.asarray(B))
    tt, Ct = t_rayleigh_ritz(torch.from_numpy(A), torch.from_numpy(B))
    tj, Cj, tt, Ct = np.asarray(tj), np.asarray(Cj), tt.numpy(), Ct.numpy()
    np.testing.assert_allclose(tt, tj, rtol=1e-8)
    assert np.all(Ct[:, 5:] == 0) and np.all(Cj[:, 5:] == 0)
    assert np.all(tt[5:] > np.abs(tt[:5]).max())


def test_chol_route_matches_eigh_route_and_jax():
    rng = np.random.default_rng(11)
    C = rng.standard_normal((24, 24))
    B = C @ C.T + 24 * np.eye(24)
    A = rng.standard_normal((24, 24))
    A = A + A.T
    td, _ = t_rayleigh_ritz(torch.from_numpy(A), torch.from_numpy(B))
    tc, Cc, ok = t_rr_chol(torch.from_numpy(A), torch.from_numpy(B))
    tj, _, _ = j_rr_chol(jnp.asarray(A), jnp.asarray(B))
    assert bool(ok)
    np.testing.assert_allclose(tc.numpy(), td.numpy(), rtol=1e-10)
    np.testing.assert_allclose(tc.numpy(), np.asarray(tj), rtol=1e-10)
    G = Cc.numpy().T @ B @ Cc.numpy()
    np.testing.assert_allclose(G, np.eye(24), atol=1e-10)


@pytest.mark.nan_traces  # JAX's cholesky NaNs by design here
def test_chol_breakdown_returns_nan_not_raise():
    """An indefinite B fails both shifted factorizations: JAX's cholesky
    returns NaN; the port's must too (cholesky_ex), with the eigh guarded,
    so the route reports ok False instead of raising."""
    A = np.diag([1.0, 2.0, 3.0])
    B = np.diag([1.0, -1.0, 1.0])
    tj, _, okj = j_rr_chol(jnp.asarray(A), jnp.asarray(B))
    tt, Ct, okt = t_rr_chol(torch.from_numpy(A), torch.from_numpy(B))
    assert not bool(okj) and not bool(okt)
    assert np.isnan(np.asarray(tj)).all() and torch.isnan(tt).all()


def test_rayleigh_ritz_batches_per_instance():
    rng = np.random.default_rng(3)
    As, Bs = [], []
    for _ in range(3):
        a = rng.standard_normal((12, 12))
        b = rng.standard_normal((12, 12))
        As.append(a + a.T)
        Bs.append(b @ b.T + 12 * np.eye(12))
    A, B = torch.from_numpy(np.stack(As)), torch.from_numpy(np.stack(Bs))
    for rr in (t_rayleigh_ritz, t_rr_chol):
        batched = rr(A, B)[0].numpy()
        for i in range(3):
            np.testing.assert_allclose(batched[i], rr(A[i], B[i])[0].numpy(),
                                       rtol=1e-12)


# ---------------------------------------------------------------------------
# lobpcg on the reference fixture
# ---------------------------------------------------------------------------


PROBLEMS = ["standard", "preconditioned", "generalized",
            "preconditioned_generalized"]


@pytest.mark.parametrize("rr_method", ["eigh", "chol"])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_converged_solve_matches_jax(problem, rr_method):
    jr, tr = _solve(problem, nev=NEV, max_iterations=N, tau=TAU,
                    rr_method=rr_method)
    assert int(tr.num_converged) == int(jr.num_converged) == NEV
    assert bool(tr.pencil_consistent) and bool(jr.pencil_consistent)
    kj, kt = int(jr.num_iterations), int(tr.num_iterations)
    slack = (int(0.03 * kj) if rr_method == "eigh"
             and problem.startswith("preconditioned") else 1)
    assert abs(kt - kj) <= slack, (kt, kj)
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               rtol=1e-9)
    assert np.linalg.norm(tr.theta.numpy() - _truth(problem)) < 1e-4
    _assert_same_subspace(tr.X.numpy(), np.asarray(jr.X))
    # the traces: NaN / -1 past the count, as in JAX
    assert np.isfinite(tr.residual_trace[:kt].numpy()).all()
    _assert_padded(tr.residual_trace[kt:])
    assert (tr.nc_trace[kt:].numpy() == -1).all()
    assert int(tr.nc_trace[kt - 1]) == NEV


@pytest.mark.parametrize("problem,rr_method", [
    ("standard", "eigh"), ("preconditioned", "eigh"),
    ("generalized", "eigh"), ("preconditioned_generalized", "eigh"),
    ("preconditioned_generalized", "chol")])
def test_disarmed_iterates_match_jax(problem, rr_method):
    """tau = 1e-30: no pair converges, so no tolerance (and no omega) steers
    the run; K = 30 iterations visit the same iterates."""
    K = 30
    jr, tr = _solve(problem, nev=NEV, max_iterations=K, tau=1e-30,
                    rr_method=rr_method)
    assert int(tr.num_iterations) == int(jr.num_iterations) == K
    assert int(tr.num_converged) == int(jr.num_converged) == 0
    np.testing.assert_allclose(tr.warm_start[1]["theta"].numpy(),
                               np.asarray(jr.warm_start[1]["theta"]),
                               rtol=1e-9)
    np.testing.assert_allclose(tr.residual_trace.numpy(),
                               np.asarray(jr.residual_trace), rtol=1e-8)
    np.testing.assert_allclose(tr.residual_norms.numpy(),
                               np.asarray(jr.residual_norms), rtol=1e-8)
    _assert_same_subspace(tr.X.numpy(), np.asarray(jr.X))


def test_user_function_stops_like_jax():
    stop = lambda k, nev, theta, X, r, nc: k >= 3
    jk, tk = _ops("standard")
    jr = j_lobpcg(jk["A"], X0=jnp.asarray(X0), nev=NEV, max_iterations=N,
                  tau=TAU, user_function=stop)
    tr = t_lobpcg(tk["A"], X0=torch.from_numpy(X0), nev=NEV,
                  max_iterations=N, tau=TAU, user_function=stop)
    assert int(tr.num_iterations) == int(jr.num_iterations) == 3
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               rtol=1e-9)


def test_warm_start_chunked_equals_monolithic():
    """Chunks resumed through warm_start visit the monolithic run's iterates
    exactly (bitwise in the port, as in JAX), and both reach JAX's."""
    _, tk = _ops("preconditioned")
    kw = dict(T=tk["T"], X0=torch.from_numpy(X0), nev=NEV, tau=TAU)
    mono = t_lobpcg(tk["A"], max_iterations=N, **kw)
    r, done = None, 0
    while True:
        r = t_lobpcg(tk["A"], max_iterations=37, warm_start=(
            r.warm_start if r is not None else None), **kw)
        if int(r.num_iterations) - done < 37:
            break
        done = int(r.num_iterations)
    assert int(r.num_iterations) == int(mono.num_iterations)
    assert torch.equal(r.theta, mono.theta) and torch.equal(r.X, mono.X)
    assert bool(r.pencil_consistent)
    jr, _ = _solve("preconditioned", nev=NEV, max_iterations=N, tau=TAU)
    np.testing.assert_allclose(r.theta.numpy(), np.asarray(jr.theta),
                               rtol=1e-9)


def test_chol_warm_converges_like_chol_and_jax():
    """rr_method="chol_warm" (Jacobi seeded by the last rotation) on the
    JAX TestWarmRR problem, smaller: the chol route's eigenvalues, and
    JAX's."""
    m, nx, nev = 200, 4, 2
    d = np.linspace(1.0, 60.0, m)
    x0 = np.random.default_rng(1).standard_normal((m, nx))
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    kw = dict(nev=nev, max_iterations=80, tau=1e-8)
    jr = j_lobpcg(lambda S: dj[:, None] * S, T=lambda S: S / dj[:, None],
                  X0=jnp.asarray(x0), rr_method="chol_warm", **kw)
    tw = t_lobpcg(lambda S: dt[:, None] * S, T=lambda S: S / dt[:, None],
                  X0=torch.from_numpy(x0), rr_method="chol_warm", **kw)
    tc = t_lobpcg(lambda S: dt[:, None] * S, T=lambda S: S / dt[:, None],
                  X0=torch.from_numpy(x0), rr_method="chol", **kw)
    assert int(tw.num_converged) >= nev and bool(tw.pencil_consistent)
    assert abs(int(tw.num_iterations) - int(jr.num_iterations)) <= 1
    np.testing.assert_allclose(tw.theta.numpy(), d[:nev], atol=1e-6)
    np.testing.assert_allclose(tw.theta.numpy(), tc.theta.numpy(), atol=1e-8)
    np.testing.assert_allclose(tw.theta.numpy(), np.asarray(jr.theta),
                               rtol=1e-9)
    assert tw.warm_start[1]["Useed"].shape == (3 * nx, 3 * nx)


def _breaking_eigh(lib):
    """An eigh that NaNs on the (3nx)^2 iteration pencils (not the nx^2
    init pencil): the RR breakdown of tests/test_lobpcg.py."""
    def eigh(M):
        w, V = lib.linalg.eigh(M)
        if M.shape[0] == 3 * 8:
            return w * float("nan"), V * float("nan")
        return w, V
    return eigh


@pytest.mark.nan_traces  # deliberately NaN-injecting eigh fixture
def test_rr_breakdown_freezes_like_jax():
    d = np.linspace(1.0, 100.0, 300)
    x0 = np.random.default_rng(4).standard_normal((300, 8))
    kw = dict(nev=3, max_iterations=50, tau=1e-9, rr_method="chol")
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    jr = j_lobpcg(lambda S: dj[:, None] * S, X0=jnp.asarray(x0),
                  eigh_fn=_breaking_eigh(jnp), **kw)
    tr = t_lobpcg(lambda S: dt[:, None] * S, X0=torch.from_numpy(x0),
                  eigh_fn=_breaking_eigh(torch), **kw)
    assert int(tr.num_iterations) == int(jr.num_iterations) == 1
    assert not bool(tr.pencil_consistent) and not bool(jr.pencil_consistent)
    assert torch.isfinite(tr.theta).all() and torch.isfinite(tr.X).all()
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               rtol=1e-10)
    # resuming a frozen run stays frozen
    tr2 = t_lobpcg(lambda S: dt[:, None] * S, X0=torch.from_numpy(x0),
                   eigh_fn=_breaking_eigh(torch), warm_start=tr.warm_start,
                   **dict(kw, max_iterations=5))
    assert int(tr2.num_iterations) == 1 and not bool(tr2.pencil_consistent)
    assert torch.equal(tr2.X, tr.X)


def test_validation():
    A = lambda S: S
    cpu = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        t_lobpcg(A, m=N, nx=4, nev=5, generator=cpu)
    with pytest.raises(ValueError):
        t_lobpcg(A, m=3, nx=4, nev=2, generator=cpu)
    with pytest.raises(ValueError):
        t_lobpcg(A, m=10, nx=4, nev=2, rr_method="qr", generator=cpu)
    with pytest.raises(ValueError):
        t_lobpcg(A, nev=2, generator=cpu)


def test_default_draws_are_on_the_card(monkeypatch):
    """With neither X0 nor a generator the solve draws X0 on the card, so
    with no CUDA device it raises instead of quietly solving on the CPU
    (the drivers too).  The CPU is what a caller asks for: a CPU generator,
    CPU X0, or CPU fleet data."""
    from optimization_tpu_torch.core.driver import drive_lobpcg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = torch.linspace(1.0, 50.0, 60, dtype=torch.float32)
    A = lambda S: d[:, None] * S
    kw = dict(m=60, nx=4, nev=2, max_iterations=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lobpcg(A, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drive_lobpcg(A, **kw)
    asked = t_lobpcg(A, generator=torch.Generator().manual_seed(0), **kw)
    assert asked.X.device.type == "cpu" and asked.X.shape == (60, 2)
    # X0 on the CPU: the default generator follows it
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (60, 4)).astype(np.float32))
    assert t_lobpcg(A, X0=x0, nev=2, max_iterations=3).X.device.type == "cpu"
    # a fleet's default X0 follows its data
    fl = t_lobpcg_fleet(lambda S, dd: dd[:, None] * S, d[None].expand(2, 60),
                        **kw)
    assert fl.X.device.type == "cpu" and fl.X.shape == (2, 60, 2)


# ---------------------------------------------------------------------------
# f32: the Gram stage through gram_pair
# ---------------------------------------------------------------------------


def _count_gram(monkeypatch):
    """Count calls of gram_pair's plain version (what the wrapper runs on a
    CPU tensor)."""
    calls = []
    plain = F.gram_pair_reference

    def counted(*args):
        calls.append(args[0].dtype)
        return plain(*args)
    monkeypatch.setattr(F, "gram_pair_reference", counted)
    return calls


def test_f32_goes_through_gram_pair_and_matches_jax(monkeypatch):
    """config3's problem cut to m = 2e4 (tests/test_lobpcg.py::
    test_f32_ill_conditioned_preconditioned): A = diag(1..m), the exact
    inverse preconditioner, f32."""
    calls = _count_gram(monkeypatch)
    m = 20000
    d = np.linspace(1.0, float(m), m, dtype=np.float32)
    x0 = np.random.default_rng(3).standard_normal((m, 12)).astype(np.float32)
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    kw = dict(nev=5, max_iterations=50, tau=1e-4)
    jr = j_lobpcg(lambda S: dj[:, None] * S, T=lambda S: S / dj[:, None],
                  X0=jnp.asarray(x0), **kw)
    before = F.gram_pair.launches
    tr = t_lobpcg(lambda S: dt[:, None] * S, T=lambda S: S / dt[:, None],
                  X0=torch.from_numpy(x0), **kw)
    assert F.gram_pair.launches == before          # the CPU: no kernel
    assert tr.X.dtype == torch.float32 and tr.theta.dtype == torch.float32
    # both Gram stages: the init and one per iteration
    assert len(calls) == 1 + int(tr.num_iterations)
    assert set(calls) == {torch.float32}
    assert int(tr.num_converged) == int(jr.num_converged) == 5
    assert abs(int(tr.num_iterations) - int(jr.num_iterations)) <= 1
    assert int(tr.num_iterations) <= 10
    np.testing.assert_allclose(tr.theta.numpy().astype(np.float64),
                               np.arange(1.0, 6.0), atol=5e-2)
    np.testing.assert_allclose(np.asarray(jr.theta, np.float64),
                               np.arange(1.0, 6.0), atol=5e-2)
    # converged runs lock pairs at tolerances set by each package's own
    # random omega, so their theta differ by ~8e-3 (both ~5e-3 to 1e-2 from
    # the truth); 2e-2 is a few times that gap
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               atol=2e-2)
    assert bool(tr.pencil_consistent)
    # iterate parity with the test disarmed: the same 4 Rayleigh-Ritz steps.
    # The two packages' f32 theta differ by ~7e-6 here; 5e-5 is a few times
    # that, far below an error in the Gram stage
    kw = dict(nev=5, max_iterations=4, tau=1e-30)
    jr = j_lobpcg(lambda S: dj[:, None] * S, T=lambda S: S / dj[:, None],
                  X0=jnp.asarray(x0), **kw)
    del calls[:]
    tr = t_lobpcg(lambda S: dt[:, None] * S, T=lambda S: S / dt[:, None],
                  X0=torch.from_numpy(x0), **kw)
    assert len(calls) == 1 + 4
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               atol=5e-5)


def test_f64_keeps_matmul(monkeypatch):
    calls = _count_gram(monkeypatch)
    jk, tk = _ops("standard")
    tr = t_lobpcg(tk["A"], X0=torch.from_numpy(X0), nev=NEV,
                  max_iterations=5, tau=TAU)
    assert int(tr.num_iterations) == 5 and calls == []


# ---------------------------------------------------------------------------
# lobpcg_fleet
# ---------------------------------------------------------------------------


def _fleet_data():
    """A fleet of two (m = 250, nx = 8, nev = 3, tau = 1e-8): instance 0
    converges quickly, instance 1 has 20 eigenvalues within 2e-5 at the
    bottom (more than the block holds) and does not converge in 200."""
    m = 250
    d0 = np.linspace(1.0, 40.0, m)
    d1 = np.concatenate([1.0 + 1e-6 * np.arange(20),
                         np.linspace(2.0, 40.0, m - 20)])
    x0 = np.random.default_rng(3).standard_normal((2, m, 8))
    return np.stack([d0, d1]), x0


@pytest.mark.parametrize("rr_method", ["chol", "eigh"])
def test_fleet_matches_jax_per_instance(rr_method):
    """The JAX fleet is a vmapped while_loop: an instance that converges
    early freezes and keeps its own num_iterations (not the lockstep count
    its docstring names; ROADMAP Queue 3).  The port matches it."""
    ds, x0 = _fleet_data()
    kw = dict(nev=3, max_iterations=200, tau=1e-8, rr_method=rr_method)
    jr = j_lobpcg_fleet(lambda S, d: d[:, None] * S, jnp.asarray(ds),
                        X0=jnp.asarray(x0), **kw)
    tr = t_lobpcg_fleet(lambda S, d: d[:, None] * S, torch.from_numpy(ds),
                        X0=torch.from_numpy(x0), **kw)
    assert int(jr.num_iterations[0]) < 200 == int(jr.num_iterations[1])
    np.testing.assert_array_equal(tr.num_iterations.numpy(),
                                  np.asarray(jr.num_iterations))
    np.testing.assert_array_equal(tr.num_converged.numpy(),
                                  np.asarray(jr.num_converged))
    np.testing.assert_array_equal(tr.num_converged.numpy(), [3, 0])
    assert tr.theta.shape == (2, 3) and tr.X.shape == (2, 250, 3)
    np.testing.assert_allclose(tr.theta[0].numpy(), ds[0, :3], rtol=1e-9)
    np.testing.assert_allclose(tr.theta[0].numpy(), np.asarray(jr.theta[0]),
                               rtol=1e-9)
    # the frozen instance's trace stops at its own count
    k0 = int(tr.num_iterations[0])
    _assert_padded(tr.residual_trace[0, k0:])
    assert np.isfinite(tr.residual_trace[1].numpy()).all()


def test_fleet_instance_equals_standalone_solve():
    ds, x0 = _fleet_data()
    kw = dict(nev=3, max_iterations=200, tau=1e-8, rr_method="chol")
    fl = t_lobpcg_fleet(lambda S, d: d[:, None] * S, torch.from_numpy(ds),
                        X0=torch.from_numpy(x0), **kw)
    d0 = torch.from_numpy(ds[0])
    one = t_lobpcg(lambda S: d0[:, None] * S, X0=torch.from_numpy(x0[0]),
                   **kw)
    assert int(one.num_iterations) == int(fl.num_iterations[0])
    np.testing.assert_allclose(fl.theta[0].numpy(), one.theta.numpy(),
                               rtol=1e-12)


def test_fleet_warm_start_and_batched_gram(monkeypatch):
    """Chunked fleet == monolithic (bitwise), one batched Gram per
    iteration, f32 through gram_pair's plain version."""
    calls = _count_gram(monkeypatch)
    fleet, m = 3, 400
    ds = (np.arange(1.0, fleet + 1.0)[:, None]
          * np.linspace(1.0, 50.0, m)[None, :]).astype(np.float32)
    data = torch.from_numpy(ds)
    kw = dict(T=lambda S, d: S / d[:, None], m=m, nx=8, nev=3, tau=1e-4,
              generator=None)
    A = lambda S, d: d[:, None] * S
    mono = t_lobpcg_fleet(A, data, max_iterations=40, **kw)
    assert mono.X.device.type == "cpu"      # the default follows the data
    n_mono = len(calls)
    assert n_mono == 1 + int(mono.num_iterations.max())
    a = t_lobpcg_fleet(A, data, max_iterations=3, **kw)
    b = t_lobpcg_fleet(A, data, max_iterations=37, warm_start=a.warm_start,
                       **kw)
    assert torch.equal(b.theta, mono.theta) and torch.equal(b.X, mono.X)
    assert torch.equal(b.num_iterations, mono.num_iterations)
    assert bool((mono.num_converged >= 3).all())
    np.testing.assert_allclose(mono.theta.numpy(), ds[:, :3], rtol=1e-3)
