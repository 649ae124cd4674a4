"""The port's ADMM == the JAX package's ``admm.solve``.

The cases of ``tests/test_convex.py`` (Boyd's dense LASSO with the x - y = 0
splitting: simple, accelerated, residual balancing; the terminating
``user_function`` with the reference callback's end-of-iteration state and
residual vectors; the dual residual vector held over restarts) on the same
float64 inputs in both packages.  Status, ``num_iterations``,
``iteration_types`` and the NaN padding must be EQUAL; x, y, lam, r, s,
every trace and every ``warm_start`` leaf within rtol 1e-10 (atol 1e-13: the
x-update is a dense solve, LAPACK in both packages but through different
drivers).  Residual balancing is given an explicit
``penalty_adaptation_window``: with the default 2**62 the JAX package's
``k < window`` on its int32 counter never holds and rho never adapts, while
the port compares Python integers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.solvers import admm as jadmm
from optimization_tpu.solvers.prox import soft_threshold as jsoft
from optimization_tpu_torch.core.types import ADMMIterationType, ADMMStatus
from optimization_tpu_torch.interop import params_from_jax, result_to_numpy
from optimization_tpu_torch.solvers import admm as tadmm
from optimization_tpu_torch.solvers.prox import soft_threshold as tsoft

torch.set_num_threads(1)


def lasso_setup(m=300, n=800, nnz=20, seed=11):
    """tests/test_convex.py::_lasso_setup as numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x_true = np.zeros(n)
    idx = rng.integers(0, n, nnz)
    x_true[idx] = rng.normal(size=nnz)
    b = A @ x_true + rng.normal(size=m)
    Atb = A.T @ b
    return A, b, Atb, float(0.1 * np.abs(Atb).max())


def lasso_problems(A, Atb, mu):
    """(JAX problem, port problem): x = (A'A + rho I)^{-1}(A'b + rho y -
    lam), y = soft(x + lam / rho, mu / rho) (ADMM_example.cpp:115-141)."""
    n = A.shape[1]
    jAtA, jAtb = jnp.asarray(A.T @ A), jnp.asarray(Atb)
    tAtA, tAtb = torch.from_numpy(A.T @ A), torch.from_numpy(Atb)
    eye = torch.eye(n, dtype=torch.float64)
    jp = jadmm.ADMMProblem(
        minLx=lambda y, lam, rho, d: jax.scipy.linalg.solve(
            jAtA + rho * jnp.eye(n), jAtb + rho * y - lam, assume_a="pos"),
        minLy=lambda x, lam, rho, d: jsoft(x + lam / rho, mu / rho),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    tp = tadmm.ADMMProblem(
        minLx=lambda y, lam, rho, d: torch.cholesky_solve(
            (tAtb + rho * y - lam)[:, None],
            torch.linalg.cholesky(tAtA + rho * eye))[:, 0],
        minLy=lambda x, lam, rho, d: tsoft(x + lam / rho, mu / rho),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    return jp, tp


PARAMS = jadmm.ADMMParams(max_iterations=250, eps_rel=1e-4, eps_abs_pri=1e-2,
                          eps_abs_dual=1e-2)
TIGHT = dict(eps_rel=1e-12, eps_abs_pri=1e-12, eps_abs_dual=1e-12)


def solve_both(jp, tp, n, params, **kw):
    z = np.zeros(n)
    jres = jadmm.solve(jp, jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                       params, **kw)
    tres = tadmm.solve(tp, torch.from_numpy(z), torch.from_numpy(z.copy()),
                       torch.from_numpy(z.copy()), params_from_jax(params),
                       **kw)
    return jres, tres


def assert_same(jres, tres, rtol=1e-10, atol=1e-13):
    t = result_to_numpy(tres)
    assert int(t.status) == int(jres.status)
    assert int(t.num_iterations) == int(jres.num_iterations)
    np.testing.assert_array_equal(t.iteration_types,
                                  np.asarray(jres.iteration_types))
    for name in ("x", "y", "lam", "r", "s", "primal_residuals",
                 "dual_residuals", "m_k", "penalty_parameters"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jres, name)),
                                   rtol=rtol, atol=atol, equal_nan=True,
                                   err_msg=name)
    assert np.isnan(t.times).all() and t.times.shape == jres.times.shape
    tl, jl = t.warm_start, jres.warm_start
    np.testing.assert_allclose(tl[0], np.asarray(jl[0]), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tl[1], np.asarray(jl[1]), rtol=rtol)
    assert sorted(tl[2]) == sorted(jl[2])
    for key in jl[2]:
        np.testing.assert_allclose(tl[2][key], np.asarray(jl[2][key]),
                                   rtol=rtol, atol=atol, err_msg=key)
    if jres.iterates is None:
        assert t.iterates is None
    else:
        np.testing.assert_allclose(t.iterates, np.asarray(jres.iterates),
                                   rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def big():
    # test_convex.py runs 300 x 800; the same law at 120 x 300 keeps the
    # dense x-update (a Cholesky per iteration in the port) cheap
    A, b, Atb, mu = lasso_setup(m=120, n=300, nnz=10)
    return (A, b, mu) + lasso_problems(A, Atb, mu)


@pytest.fixture(scope="module")
def small():
    A, b, Atb, mu = lasso_setup(m=60, n=40)
    return (A, b, mu) + lasso_problems(A, Atb, mu)


def objective(A, b, mu, x):
    return 0.5 * np.sum((A @ x - b) ** 2) + mu * np.sum(np.abs(x))


MODES = {
    "simple": {},
    "accelerated": dict(mode=jadmm.ADMMMode.ACCELERATED),
    "residual-balance": dict(
        penalty_adaptation_mode=jadmm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE,
        penalty_adaptation_period=2, penalty_adaptation_window=100,
        rho=20.0),
    "accelerated-residual-balance": dict(
        mode=jadmm.ADMMMode.ACCELERATED,
        penalty_adaptation_mode=jadmm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE,
        penalty_adaptation_period=3, penalty_adaptation_window=40,
        rho=20.0),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_lasso_matches_jax(big, mode):
    """test_convex.py::test_admm_lasso, test_admm_accelerated and
    test_admm_residual_balancing, and both options together (a rho change
    forces a restart): converged, and every field equal to JAX's."""
    A, b, mu, jp, tp = big
    params = dataclasses.replace(PARAMS, **MODES[mode])
    jres, tres = solve_both(jp, tp, A.shape[1], params)
    assert int(tres.status) == ADMMStatus.RESIDUAL_TOLERANCE
    k = int(tres.num_iterations)
    assert k <= 250
    assert torch.isfinite(tres.primal_residuals[:k]).all()
    assert set(tres.iteration_types[:k].tolist()) <= {0, 1, 2}
    assert_same(jres, tres)
    # the solution is as good as JAX's (which test_convex.py holds against
    # a tight FISTA solve)
    assert objective(A, b, mu, tres.y.numpy()) <= \
        objective(A, b, mu, np.asarray(jres.y)) * (1 + 1e-9)
    if "balance" in mode:
        assert len(set(tres.penalty_parameters[:k].tolist())) > 1
    if mode == "accelerated-residual-balance":
        # a rho change forced a restart where the merit test alone would
        # not have: the iteration after it runs with m_prev = max
        types = tres.iteration_types[:k].tolist()
        assert ADMMIterationType.RESTART.value in types[1:]


@pytest.mark.parametrize("kw", [
    dict(max_iterations=0), dict(log_iterates=True, max_iterations=12),
    dict(log_iterates=True, max_iterations=12,
         mode=jadmm.ADMMMode.ACCELERATED),
    dict(rho=3.0, eta=0.9, mode=jadmm.ADMMMode.ACCELERATED,
         max_iterations=40, **TIGHT)],
    ids=["zero-iterations", "log-iterates", "log-iterates-accelerated",
         "rho-eta"])
def test_small_lasso_matches_jax(small, kw):
    A, b, mu, jp, tp = small
    jres, tres = solve_both(jp, tp, A.shape[1],
                            dataclasses.replace(PARAMS, **kw))
    assert_same(jres, tres)
    if kw.get("log_iterates"):
        k = int(tres.num_iterations)
        assert torch.equal(tres.iterates[k - 1], tres.x)
    else:
        assert tres.iterates is None


def test_user_function_stops_and_exposes_residual_vectors(small):
    """test_convex.py::test_admm_user_function_stops_and_exposes_residual_
    vectors: USER_FUNCTION after K + 1 iterations, the exposed vectors'
    norms equal the recorded residuals, and the predicate sees the
    end-of-iteration state of the reference's callback."""
    A, b, mu, jp, tp = small
    K = 4
    seen = []

    def user_fn(k, x, y, lam, rho, r, s):
        if isinstance(x, torch.Tensor):
            seen.append((int(k), x.clone(), y.clone(), lam.clone(),
                         float(rho), r.clone(), s.clone()))
        return k == K

    params = dataclasses.replace(PARAMS, **TIGHT)
    jres, tres = solve_both(jp, tp, A.shape[1], params,
                            user_function=user_fn)
    assert int(tres.status) == ADMMStatus.USER_FUNCTION
    assert int(tres.num_iterations) == K + 1
    assert_same(jres, tres)
    np.testing.assert_allclose(float(torch.linalg.norm(tres.r)),
                               float(tres.primal_residuals[K]), rtol=1e-12)
    np.testing.assert_allclose(float(torch.linalg.norm(tres.s)),
                               float(tres.dual_residuals[K]), rtol=1e-12)
    assert [s[0] for s in seen] == list(range(K + 1))
    for k, x, y, lam, rho, r, s in seen:
        # r = A x + B y - c = x - y; lam is the updated dual; the norms are
        # the recorded ones
        assert torch.equal(r, x - y)
        assert float(torch.linalg.norm(r)) == pytest.approx(
            float(tres.primal_residuals[k]), rel=1e-12)
        assert float(torch.linalg.norm(s)) == pytest.approx(
            float(tres.dual_residuals[k]), rel=1e-12)
        assert rho == float(tres.penalty_parameters[k])
    assert torch.equal(seen[-1][1], tres.x) and torch.equal(seen[-1][3],
                                                            tres.lam)


def test_user_function_sees_end_of_iteration_rho(small):
    """The predicate runs after the penalty adaptation: where rho changes
    at iteration k, it sees the new rho, which the trace records at k + 1."""
    A, b, mu, jp, tp = small
    rhos = []
    params = dataclasses.replace(
        PARAMS, max_iterations=12, rho=50.0, **TIGHT,
        penalty_adaptation_mode=jadmm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE,
        penalty_adaptation_period=1, penalty_adaptation_window=100)

    def user_fn(k, x, y, lam, rho, r, s):
        if isinstance(x, torch.Tensor):
            rhos.append(float(rho))
        return False

    jres, tres = solve_both(jp, tp, A.shape[1], params,
                            user_function=user_fn)
    assert_same(jres, tres)
    trace = tres.penalty_parameters.tolist()
    assert len(set(trace)) > 1
    assert rhos[:-1] == trace[1:]


def test_default_window_adapts_where_jax_does_not(small):
    """The chosen behaviour at the default ``penalty_adaptation_window``
    (2**62): the port adapts rho, exactly as with any window the run never
    reaches, and so equals the JAX run given such a window explicitly; the
    JAX package at its default never adapts (``ADMMParams``' docstring)."""
    A, b, mu, jp, tp = small
    balance = dict(
        max_iterations=12, rho=50.0, **TIGHT, penalty_adaptation_period=1,
        penalty_adaptation_mode=jadmm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE)
    default = dataclasses.replace(PARAMS, **balance)
    assert default.penalty_adaptation_window == 2**62
    assert tadmm.ADMMParams().penalty_adaptation_window == 2**62
    jres_default, tres = solve_both(jp, tp, A.shape[1], default)
    k = int(tres.num_iterations)
    assert len(set(tres.penalty_parameters[:k].tolist())) > 1
    assert set(np.asarray(jres_default.penalty_parameters)[:k].tolist()) \
        == {50.0}
    windowed = dataclasses.replace(default,
                                   penalty_adaptation_window=2**31 - 1)
    jres, again = solve_both(jp, tp, A.shape[1], windowed)
    assert_same(jres, tres)
    assert torch.equal(again.x, tres.x)
    assert torch.equal(again.penalty_parameters, tres.penalty_parameters)


def test_accelerated_s_held_over_restart(small):
    """test_convex.py::test_admm_accelerated_user_function_s_held_over_
    restart: the exposed dual-residual vector is held over restart
    iterations like its recorded norm."""
    A, b, mu, jp, tp = small
    params = dataclasses.replace(PARAMS, mode=jadmm.ADMMMode.ACCELERATED,
                                 max_iterations=40, **TIGHT)
    jres, tres = solve_both(jp, tp, A.shape[1], params)
    k = int(tres.num_iterations)
    types = tres.iteration_types[:k].tolist()
    assert ADMMIterationType.RESTART.value in types[1:]
    np.testing.assert_allclose(float(torch.linalg.norm(tres.s)),
                               float(tres.dual_residuals[k - 1]), rtol=1e-12)
    assert_same(jres, tres)
    # on a restart iteration the recorded dual residual repeats
    d = tres.dual_residuals[:k].tolist()
    for i in range(1, k):
        if types[i] == ADMMIterationType.RESTART.value:
            assert d[i] == d[i - 1]


def test_warm_start_resumes_from_the_plain_y(small):
    """Two accelerated solves joined by ``warm_start`` equal one; the
    second starts from the carry's plain y, not from the reported y_hat."""
    A, b, mu, jp, tp = small
    n = A.shape[1]
    params = params_from_jax(dataclasses.replace(
        PARAMS, mode=jadmm.ADMMMode.ACCELERATED, max_iterations=30, **TIGHT))
    z = torch.zeros(n, dtype=torch.float64)
    mono = tadmm.solve(tp, z, z, z, params)
    a = tadmm.solve(tp, z, z, z, dataclasses.replace(params,
                                                     max_iterations=13))
    assert not torch.equal(a.y, a.warm_start[2]["y_prev"])
    b2 = tadmm.solve(tp, z, a.x, a.warm_start[2]["y_prev"],
                     dataclasses.replace(params, max_iterations=17),
                     warm_start=a.warm_start)
    assert torch.equal(b2.x, mono.x) and torch.equal(b2.y, mono.y)
    assert torch.equal(b2.primal_residuals, mono.primal_residuals[13:])
    assert torch.equal(b2.iteration_types, mono.iteration_types[13:])


def test_validate_messages_and_defaults():
    for kw, msg in ((dict(rho=0.0), "rho"), (dict(eta=1.0), "eta"),
                    (dict(residual_balance_mu=1.0), "mu"),
                    (dict(residual_balance_tau=0.5), "tau")):
        with pytest.raises(ValueError, match=msg) as ti:
            tadmm.ADMMParams(**kw).validate()
        with pytest.raises(ValueError) as ji:
            jadmm.ADMMParams(**kw).validate()
        assert str(ti.value) == str(ji.value)
    enums = ("mode", "penalty_adaptation_mode")
    jf = {f.name: f.default for f in dataclasses.fields(jadmm.ADMMParams)}
    tf = {f.name: f.default for f in dataclasses.fields(tadmm.ADMMParams)}
    assert {k: v for k, v in jf.items() if k not in enums} == \
        {k: v for k, v in tf.items() if k not in enums}
    assert all(jf[k].value == tf[k].value for k in enums)
