"""The port's flat pair engine == the JAX package's ``stpcg_flat``.

Both bodies (pair and single), with the kernel-of-H check on and off, on
stored, generated and adjoint-form U entries, across interior, truncation,
boundary, indefinite and kernel regimes; plus ``flat_init_dots``,
``sphere_rayleigh_flat`` and ``sphere_rayleigh_step`` against JAX, and init
threading (bitwise invisible within the port, as in the JAX package's
TestInitThreading).  float64 inputs from a numpy seed: iteration counts
EQUAL, steps and scalars within rtol 1e-9 (same recurrences, reduction
order differs).  The bf16-storage case compares in f32 to one bf16
rounding of the step (2^-8 relative).

``stpcg_flat(prec=)`` (the folded elementwise M^(-1/2)) against JAX's at
the same rtol 1e-9, and against the port's generic preconditioned
``stpcg`` at the tolerances of ``tests/test_flat_cg.py::
TestPreconditionedFlat`` (iterations equal, s rtol 1e-5, M-norm rtol 1e-6).

The s-step engine (``s_steps`` 2 in every trust-region regime, 3 in one,
the indefinite and kernel cases) and ``solve_mode`` (s = 1, 2) against
JAX's at the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.linalg import flat_cg as J
from optimization_tpu_torch.linalg import flat_cg as T
from optimization_tpu_torch.linalg.stpcg import stpcg

torch.set_num_threads(1)

RTOL = 1e-9


def _diag_lowrank(n=400, seed=0, rank=2, shift=1.0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 50.0, n) + shift
    Um = rng.normal(size=(n, rank)) / np.sqrt(n)
    Bm = rng.normal(size=(rank, rank))
    B = 0.5 * (Bm + Bm.T) + rank * np.eye(rank)
    g = rng.normal(size=n)
    return d, Um, B, g


def _ops(d, Um, B, g, form):
    """(jax args, torch args) for stpcg_flat with U in ``form``."""
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    ju = [jnp.asarray(Um[:, j]) for j in range(Um.shape[1])]
    tu = [torch.from_numpy(np.ascontiguousarray(Um[:, j]))
          for j in range(Um.shape[1])]
    if form == "callable":
        ju = [(lambda u=u: u) for u in ju]
        tu = [(lambda u=u: u) for u in tu]
    elif form == "adjoint":
        # u_1 = 3 * base through a linear self-adjoint elementwise map
        ju[1] = (ju[1] / 3.0, lambda v: 3.0 * v)
        tu[1] = (tu[1] / 3.0, lambda v: 3.0 * v)
    return ((jnp.asarray(g), lambda v: jd * v, tuple(ju), jnp.asarray(B)),
            (torch.from_numpy(g), lambda v: td * v, tuple(tu),
             torch.from_numpy(B)))


def _assert_same(jr, tr, rtol=RTOL):
    assert int(tr.num_iterations) == int(jr.num_iterations)
    np.testing.assert_allclose(tr.s.numpy(), np.asarray(jr.s), rtol=rtol,
                               atol=1e-12)
    np.testing.assert_allclose(float(tr.update_step_M_norm),
                               float(jr.update_step_M_norm), rtol=rtol)
    np.testing.assert_allclose(float(tr.predicted_decrease),
                               float(jr.predicted_decrease), rtol=rtol)


REGIMES = {"interior": (1e9, 1e-8, 0.999), "truncated": (1e9, 0.05, 0.5),
           "boundary": (0.5, 0.05, 0.5), "small_delta": (0.05, 0.05, 0.5)}


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("body", ["pair", "single"])
def test_bodies_match_jax(body, regime):
    Delta, kappa, theta = REGIMES[regime]
    (jg, jA0, jU, jB), (tg, tA0, tU, tB) = _ops(*_diag_lowrank(seed=5),
                                                "stored")
    kw = dict(max_iterations=500, kappa_fgr=kappa, theta=theta,
              body_kind=body)
    _assert_same(J.stpcg_flat(jg, jA0, jU, jB, Delta, **kw),
                 T.stpcg_flat(tg, tA0, tU, tB, Delta, **kw))


@pytest.mark.parametrize("form", ["callable", "adjoint"])
def test_u_entry_forms_match_jax(form):
    (jg, jA0, jU, jB), (tg, tA0, tU, tB) = _ops(*_diag_lowrank(seed=2),
                                                form)
    kw = dict(max_iterations=300, kappa_fgr=0.01, theta=0.5)
    _assert_same(J.stpcg_flat(jg, jA0, jU, jB, 1e9, **kw),
                 T.stpcg_flat(tg, tA0, tU, tB, 1e9, **kw))


@pytest.mark.parametrize("body", ["pair", "single"])
def test_kernel_check_off_matches_jax(body):
    (jg, jA0, jU, jB), (tg, tA0, tU, tB) = _ops(*_diag_lowrank(seed=8),
                                                "stored")
    kw = dict(max_iterations=300, kappa_fgr=0.01, theta=0.5,
              kernel_check=False, body_kind=body)
    _assert_same(J.stpcg_flat(jg, jA0, jU, jB, 0.3, **kw),
                 T.stpcg_flat(tg, tA0, tU, tB, 0.3, **kw))


def test_indefinite_and_kernel_regimes_match_jax():
    rng = np.random.default_rng(7)
    d = rng.uniform(-2.0, 5.0, 200)
    g = rng.normal(size=200)
    for diag, Delta in ((d, 2.0), (np.zeros(200), 3.0)):
        jd, td = jnp.asarray(diag), torch.from_numpy(diag)
        kw = dict(max_iterations=500, kappa_fgr=1e-8, theta=0.999)
        jr = J.stpcg_flat(jnp.asarray(g), lambda v: jd * v, None, None,
                          Delta, **kw)
        tr = T.stpcg_flat(torch.from_numpy(g), lambda v: td * v, None, None,
                          Delta, **kw)
        _assert_same(jr, tr)
        np.testing.assert_allclose(float(tr.update_step_M_norm), Delta,
                                   rtol=1e-12)


def _sphere_setup(n=500, seed=11):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 100.0, n)
    x = rng.normal(size=n)
    x /= np.linalg.norm(x)
    h = 0.1 * rng.normal(size=n)
    return d, x, h


def test_flat_init_dots_and_sphere_structure_match_jax():
    d, x, _ = _sphere_setup()
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    jA0, jU, jB, jrq = J.sphere_rayleigh_flat(jnp.asarray(x),
                                              lambda v: jd * v)
    tA0, tU, tB, trq = T.sphere_rayleigh_flat(torch.from_numpy(x),
                                              lambda v: td * v)
    np.testing.assert_allclose(float(trq), float(jrq), rtol=1e-14)
    np.testing.assert_allclose(tB.numpy(), np.asarray(jB), rtol=1e-14)
    g = np.random.default_rng(1).normal(size=x.shape[0])
    ji = J.flat_init_dots(jnp.asarray(g), jA0, jU, jB)
    ti = T.flat_init_dots(torch.from_numpy(g), tA0, tU, tB)
    for name in T.FlatCGInit._fields:
        np.testing.assert_allclose(getattr(ti, name).numpy(),
                                   np.asarray(getattr(ji, name)),
                                   rtol=1e-13, err_msg=name)
    with pytest.raises(ValueError, match="B is required"):
        T.flat_init_dots(torch.from_numpy(g), tA0, tU)


@pytest.mark.parametrize("with_init", [True, False])
def test_sphere_rayleigh_step_matches_jax(with_init):
    d, x, h = _sphere_setup(seed=3)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    jout = J.sphere_rayleigh_step(lambda v: jd * v, with_init)(
        jnp.asarray(x), jnp.asarray(h), None)
    tout = T.sphere_rayleigh_step(lambda v: td * v, with_init)(
        torch.from_numpy(x), torch.from_numpy(h), None)
    for t, j in zip(tout[:4], jout[:4]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-14)
    np.testing.assert_allclose(float(tout[4].rq), float(jout[4].rq),
                               rtol=1e-13)
    if with_init:
        for name in T.FlatCGInit._fields:
            np.testing.assert_allclose(
                getattr(tout[4].init, name).numpy(),
                np.asarray(getattr(jout[4].init, name)), rtol=1e-12,
                err_msg=name)
    else:
        assert tout[4].init is None


@pytest.mark.parametrize("body", ["pair", "single"])
def test_init_threading_is_invisible(body):
    """stpcg_flat(init=flat_init_dots(...)) is bitwise the engine's own
    init (same helper, same accumulation) — and matches JAX's run."""
    d, x, _ = _sphere_setup(seed=4)
    td = torch.from_numpy(d)
    A_elem = lambda v: td * v
    tx = torch.from_numpy(x)
    A0, U, B, rq = T.sphere_rayleigh_flat(tx, A_elem)
    g = 2.0 * A_elem(tx) - rq * tx
    kw = dict(max_iterations=300, kappa_fgr=0.01, theta=0.5, body_kind=body)
    plain = T.stpcg_flat(g, A0, U, B, 1.0, **kw)
    threaded = T.stpcg_flat(g, A0, U, B, 1.0,
                            init=T.flat_init_dots(g, A0, U, B), **kw)
    assert torch.equal(plain.s, threaded.s)
    for a, b in zip(plain[1:], threaded[1:]):
        assert torch.equal(a, b)
    jd = jnp.asarray(d)
    jA0, jU, jB, jrq = J.sphere_rayleigh_flat(jnp.asarray(x),
                                              lambda v: jd * v)
    jg = 2.0 * jd * jnp.asarray(x) - jrq * jnp.asarray(x)
    _assert_same(J.stpcg_flat(jg, jA0, jU, jB, 1.0, **kw), plain)


def test_bf16_storage_matches_jax():
    d, x, _ = _sphere_setup(n=1024, seed=6)
    d32 = d.astype(np.float32)
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    td, jd = torch.from_numpy(d32), jnp.asarray(d32)
    tA0, tU, tB, trq = T.sphere_rayleigh_flat(
        xb, lambda v: td * v.to(torch.float32))
    jA0, jU, jB, jrq = J.sphere_rayleigh_flat(
        xj, lambda v: jd * v.astype(jnp.float32))
    g = (2.0 * d32 * xb.float().numpy() - np.float32(trq)
         * xb.float().numpy()).astype(np.float32)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    jg = jnp.asarray(tg.float().numpy()).astype(jnp.bfloat16)
    kw = dict(max_iterations=200, kappa_fgr=0.05, theta=0.5)
    tr = T.stpcg_flat(tg, tA0, tU, tB, 0.3, **kw)
    jr = J.stpcg_flat(jg, jA0, jU, jB, 0.3, body_kind="pair", **kw)
    assert tr.s.dtype == torch.bfloat16
    assert tr.update_step_M_norm.dtype == torch.float32
    assert abs(int(tr.num_iterations) - int(jr.num_iterations)) <= 1
    scale = float(np.linalg.norm(np.asarray(jr.s, np.float32)))
    np.testing.assert_allclose(tr.s.float().numpy(),
                               np.asarray(jr.s, np.float32),
                               atol=2 ** -8 * scale)


@pytest.mark.parametrize("kw", [dict(s_steps=2), dict(solve_mode=True)],
                         ids=["s_steps", "solve_mode"])
def test_unported_engines_raise(kw):
    """The s-step engine (now ported) refuses the pair engine's options as
    JAX's does: ``init=`` and ``kernel_check=False`` raise ValueError; it
    runs without them."""
    (_, _, _, _), (tg, tA0, tU, tB) = _ops(*_diag_lowrank(seed=9), "stored")
    init = T.flat_init_dots(tg, tA0, tU, tB)
    with pytest.raises(ValueError, match="pair engine"):
        T.stpcg_flat(tg, tA0, tU, tB, 1.0, init=init, **kw)
    with pytest.raises(ValueError, match="pair-engine"):
        T.stpcg_flat(tg, tA0, tU, tB, 1.0, kernel_check=False, **kw)
    res = T.stpcg_flat(tg, tA0, tU, tB, 1.0, max_iterations=50, **kw)
    assert int(res.num_iterations) > 0 and bool(torch.isfinite(res.s).all())


@pytest.mark.parametrize("s,regime", [(2, r) for r in REGIMES]
                         + [(3, "boundary")])
def test_sstep_engine_matches_jax(s, regime):
    """The s-step engine in trust-region mode: iteration counts equal,
    steps and scalars within 1e-9, the pair engine's rtol.  (JAX compiles
    the s = 3 body for ~10 s on this CPU: one regime at s = 3, and
    ``tests/test_torch_pose_sync.py`` runs ``solve_mode`` at s = 3.)"""
    Delta, kappa, theta = REGIMES[regime]
    (jg, jA0, jU, jB), (tg, tA0, tU, tB) = _ops(*_diag_lowrank(seed=5),
                                                "stored")
    kw = dict(max_iterations=500, kappa_fgr=kappa, theta=theta, s_steps=s)
    _assert_same(J.stpcg_flat(jg, jA0, jU, jB, Delta, **kw),
                 T.stpcg_flat(tg, tA0, tU, tB, Delta, **kw))


def test_sstep_engine_kernel_and_indefinite_regimes_match_jax():
    rng = np.random.default_rng(7)
    d = rng.uniform(-2.0, 5.0, 200)
    g = rng.normal(size=200)
    for diag, Delta in ((d, 2.0), (np.zeros(200), 3.0)):
        jd, td = jnp.asarray(diag), torch.from_numpy(diag)
        kw = dict(max_iterations=500, kappa_fgr=1e-8, theta=0.999,
                  s_steps=2)
        _assert_same(J.stpcg_flat(jnp.asarray(g), lambda v: jd * v, None,
                                  None, Delta, **kw),
                     T.stpcg_flat(torch.from_numpy(g), lambda v: td * v,
                                  None, None, Delta, **kw))


@pytest.mark.parametrize("s", [1, 2])
def test_solve_mode_matches_jax(s):
    """``solve_mode`` (the plain truncated-CG linear solver of the pose
    inner solve): H s = rhs with Delta = inf and theta = 0 on an SPD
    diagonal + low-rank H, to rtol 1e-10 of |rhs|: counts equal, s within
    1e-9, and H s = rhs to the target."""
    d, Um, B, g = _diag_lowrank(seed=3)
    (jg, jA0, jU, jB), (tg, tA0, tU, tB) = _ops(d, Um, B, -g, "stored")
    kw = dict(max_iterations=500, kappa_fgr=1e-10, theta=0.0, s_steps=s,
              solve_mode=True)
    jr = J.stpcg_flat(jg, jA0, jU, jB, np.inf, **kw)
    tr = T.stpcg_flat(tg, tA0, tU, tB, np.inf, **kw)
    _assert_same(jr, tr)
    H = np.diag(d) + Um @ B @ Um.T
    res = np.linalg.norm(H @ tr.s.numpy() - g) / np.linalg.norm(g)
    assert res <= 1e-9


def test_auto_body_is_pair():
    (_, _, _, _), (tg, tA0, tU, tB) = _ops(*_diag_lowrank(seed=9), "stored")
    kw = dict(max_iterations=300, kappa_fgr=0.01, theta=0.5)
    auto = T.stpcg_flat(tg, tA0, tU, tB, 1e9, **kw)
    pair = T.stpcg_flat(tg, tA0, tU, tB, 1e9, body_kind="pair", **kw)
    assert torch.equal(auto.s, pair.s)
    with pytest.raises(ValueError):
        T.stpcg_flat(tg, tA0, tU, tB, 1e9, body_kind="triple", **kw)


def _prec_setup(seed=11, n=300, cond=1e4):
    """tests/test_flat_cg.py::TestPreconditionedFlat._setup in both
    packages: an ill-conditioned diagonal plus a rank-2 term, the Jacobi
    P = D^(-1/2)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, cond, n)
    Um = rng.normal(size=(n, 2)) / np.sqrt(n)
    Bm = rng.normal(size=(2, 2))
    B = 0.5 * (Bm + Bm.T) + 2.0 * np.eye(2)
    g = rng.normal(size=n)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    jU = (jnp.asarray(Um[:, 0]), jnp.asarray(Um[:, 1]))
    tU = tuple(torch.from_numpy(np.ascontiguousarray(Um[:, j]))
               for j in range(2))
    j = (jnp.asarray(g), lambda v: jd * v, jU, jnp.asarray(B),
         lambda v: v * jax.lax.rsqrt(jd))
    t = (torch.from_numpy(g), lambda v: td * v, tU, torch.from_numpy(B),
         lambda v: v * torch.rsqrt(td))
    tUm, tB = torch.from_numpy(Um), torch.from_numpy(B)
    Hv = lambda v: td * v + tUm @ (tB @ (tUm.T @ v))
    return d, Um, B, g, j, t, Hv, (lambda r: (r / td, None))


@pytest.mark.parametrize("body", ["pair", "single"])
@pytest.mark.parametrize("Delta", [1e9, 1.0, 1e-2])
def test_prec_matches_jax_and_generic_engine(Delta, body):
    _, _, _, _, (jg, jA0, jU, jB, jP), (tg, tA0, tU, tB, tP), Hv, pre = \
        _prec_setup(seed=23)
    kw = dict(max_iterations=400, kappa_fgr=0.05, theta=0.5)
    tr = T.stpcg_flat(tg, tA0, tU, tB, Delta, prec=tP, body_kind=body, **kw)
    _assert_same(J.stpcg_flat(jg, jA0, jU, jB, Delta, prec=jP,
                              body_kind=body, **kw), tr)
    ref = stpcg(tg, Hv, torch.dot, Delta, precon=pre, **kw)
    assert int(tr.num_iterations) == int(ref.num_iterations)
    np.testing.assert_allclose(tr.s.numpy(), ref.s.numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(float(tr.update_step_M_norm),
                               float(ref.update_step_M_norm), rtol=1e-6)


def test_prec_exact_regime_matches_direct():
    d, Um, B, g, _, (tg, tA0, tU, tB, tP), _, _ = _prec_setup()
    res = T.stpcg_flat(tg, tA0, tU, tB, 1e9, max_iterations=3000,
                       kappa_fgr=1e-10, theta=0.999, prec=tP)
    H = np.diag(d) + Um @ B @ Um.T
    s_direct = -np.linalg.solve(H, g)
    np.testing.assert_allclose(res.s.numpy(), s_direct, rtol=1e-6,
                               atol=1e-9)
    # the reported step norm is the M-norm |s|_D
    np.testing.assert_allclose(float(res.update_step_M_norm),
                               np.sqrt(s_direct @ (d * s_direct)), rtol=1e-6)


def test_prec_cuts_iterations_and_rejects_init():
    _, _, _, _, _, (tg, tA0, tU, tB, tP), _, _ = _prec_setup(seed=7,
                                                            cond=1e6)
    kw = dict(max_iterations=3000, kappa_fgr=1e-6, theta=0.9)
    plain = T.stpcg_flat(tg, tA0, tU, tB, 1e9, **kw)
    pc = T.stpcg_flat(tg, tA0, tU, tB, 1e9, prec=tP, **kw)
    assert int(pc.num_iterations) * 10 < int(plain.num_iterations)
    init = T.flat_init_dots(tg, tA0, tU, tB)
    with pytest.raises(ValueError, match="init"):
        T.stpcg_flat(tg, tA0, tU, tB, 1.0, prec=tP, init=init)
