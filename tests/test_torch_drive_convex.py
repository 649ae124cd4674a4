"""The port's ``drive(proximal_gradient, ...)`` and ``drive_admm`` == the JAX
package's, on the convex cases of ``tests/test_driver.py`` and
``tests/test_convex.py``.

- chunked == monolithic in the port: status, iteration count, x bit for
  bit, every stitched trace (padding included), at chunk sizes that do not
  divide the run; and against JAX's chunked run at rtol 1e-9 (float64);
- the host facilities: verbose lines and the final report equal to JAX's
  character for character once the wall-clock fields are masked, observers
  per iteration with the reference callback's state, ``log_iterates``
  stitched and zero-padded, ``max_iterations=0``, ELAPSED_TIME, checkpoints
  (a file JAX's ``drive_admm`` wrote loads into the port's state), time
  interpolation;
- the iteration a terminating ``user_function`` sees under chunking: the
  global one in the port (the reference's contract), where the JAX package
  restarts at 0 in every chunk;
- ``interop``: a JAX ``warm_start`` carried over resumes to the same
  iterates.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import CompositeProblem as JComposite
from optimization_tpu.core import driver as JD
from optimization_tpu.solvers import admm as jadmm
from optimization_tpu.solvers import prox as jprox
from optimization_tpu.solvers import proximal_gradient as jpg
from optimization_tpu_torch import CompositeProblem as TComposite
from optimization_tpu_torch.core import driver as TD
from optimization_tpu_torch.core.checkpoint import load_pytree
from optimization_tpu_torch.core.types import (ADMMStatus,
                                               ProximalGradientStatus)
from optimization_tpu_torch.interop import (
    admm_warm_start_from_jax, params_from_jax,
    proximal_gradient_warm_start_from_jax, result_to_numpy)
from optimization_tpu_torch.solvers import admm as tadmm
from optimization_tpu_torch.solvers import prox as tprox
from optimization_tpu_torch.solvers import proximal_gradient as tpg

torch.set_num_threads(1)

X0 = np.array([-0.5, 0.5])
PG_TRACES = ("objective_values", "composite_gradient_norms",
             "relative_composite_gradient_norms", "linesearch_iterations")
ADMM_TRACES = ("primal_residuals", "dual_residuals", "m_k",
               "penalty_parameters", "iteration_types")


def _mask(text):
    text = re.sub(r"time: \d+\.\d+", "time: T", text)
    return re.sub(r"elapsed: \d+\.\d+ s", "elapsed: T s", text)


def small_lasso_pg():
    """tests/test_driver.py::test_proximal_gradient_momentum_carry."""
    A = np.array([[3.0, 0.5], [0.5, 1.0], [0.2, -0.7]])
    b = np.array([1.0, -2.0, 0.5])
    mu = 0.1
    Aj, bj, At, bt = (jnp.asarray(A), jnp.asarray(b), torch.from_numpy(A),
                      torch.from_numpy(b))
    return (
        JComposite(f=lambda x, d: 0.5 * jnp.sum((Aj @ x - bj) ** 2),
                   g=lambda x, d: mu * jnp.sum(jnp.abs(x)),
                   prox_g=lambda x, lam, d: jprox.soft_threshold(x, lam * mu)),
        TComposite(f=lambda x, d: 0.5 * torch.sum((At @ x - bt) ** 2),
                   g=lambda x, d: mu * torch.sum(torch.abs(x)),
                   prox_g=lambda x, lam, d: tprox.soft_threshold(x,
                                                                 lam * mu)))


def small_lasso_admm():
    """tests/test_driver.py::_small_lasso_admm."""
    A = np.array([[2.0, 0.3], [0.1, 1.5], [0.4, -0.2]])
    b = np.array([1.0, 0.5, -0.3])
    mu = 0.05
    AtA, Atb = A.T @ A, A.T @ b
    jAtA, jAtb = jnp.asarray(AtA), jnp.asarray(Atb)
    tAtA, tAtb = torch.from_numpy(AtA), torch.from_numpy(Atb)
    eye = torch.eye(2, dtype=torch.float64)
    jp = jadmm.ADMMProblem(
        minLx=lambda y, lam, rho, d: jnp.linalg.solve(
            jAtA + rho * jnp.eye(2), jAtb + rho * y - lam),
        minLy=lambda x, lam, rho, d: jprox.soft_threshold(x + lam / rho,
                                                          mu / rho),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    tp = tadmm.ADMMProblem(
        minLx=lambda y, lam, rho, d: torch.linalg.solve(
            tAtA + rho * eye, tAtb + rho * y - lam),
        minLy=lambda x, lam, rho, d: tprox.soft_threshold(x + lam / rho,
                                                          mu / rho),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    return jp, tp


ACCEL = jadmm.ADMMParams(max_iterations=150, mode=jadmm.ADMMMode.ACCELERATED,
                         eps_abs_pri=1e-7, eps_abs_dual=1e-7, eps_rel=1e-8)
PG = jpg.ProximalGradientParams(max_iterations=300,
                                composite_gradient_tolerance=1e-8,
                                relative_composite_gradient_tolerance=1e-8)


def tx0():
    return torch.from_numpy(X0.copy())


def t_admm(tp, params, **kw):
    return TD.drive_admm(tp, torch.zeros(2, dtype=torch.float64), tx0(),
                         tx0(), params_from_jax(params), **kw)


def j_admm(jp, params, **kw):
    return JD.drive_admm(jp, jnp.zeros(2), jnp.asarray(X0), jnp.asarray(X0),
                         params, **kw)


def _same(a, b, fields):
    assert int(a.status) == int(b.status)
    assert int(a.num_iterations) == int(b.num_iterations)
    assert torch.equal(a.x, b.x)
    for f in fields:
        u, v = getattr(a, f), getattr(b, f)
        assert u.shape == v.shape and u.dtype == v.dtype, f
        assert torch.equal(torch.nan_to_num(u, nan=-7.0),
                           torch.nan_to_num(v, nan=-7.0)), f


def _close_to_jax(t, j, fields, rtol=1e-9):
    t = result_to_numpy(t)
    assert int(t.status) == int(j.status)
    assert int(t.num_iterations) == int(j.num_iterations)
    np.testing.assert_allclose(t.x, np.asarray(j.x), rtol=rtol, atol=1e-14)
    for f in fields:
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(j, f)),
                                   rtol=1e-6 if "gradient" in f else rtol,
                                   atol=1e-13, equal_nan=True, err_msg=f)
        assert getattr(t, f).shape == np.asarray(getattr(j, f)).shape, f


@pytest.mark.parametrize("chunk", [11, 1, 300])
def test_proximal_gradient_momentum_carry(chunk):
    """test_driver.py::test_proximal_gradient_momentum_carry: LASSO keeps
    FISTA's momentum and restarts active across chunk boundaries."""
    jp, tp = small_lasso_pg()
    mono = tpg.solve(tp, tx0(), params_from_jax(PG))
    chunked = TD.drive(tpg, tp, tx0(), params_from_jax(PG),
                       chunk_iterations=chunk)
    assert int(mono.status) == ProximalGradientStatus.PROX_GRAD_RESIDUAL
    _same(chunked, mono, PG_TRACES)
    assert torch.equal(chunked.f, mono.f)
    k = int(mono.num_iterations)
    # the slot after the last iteration holds the closing timestamp
    assert torch.isfinite(chunked.times[:k + 1]).all()
    assert torch.isnan(chunked.times[k + 1:]).all()
    _close_to_jax(chunked, JD.drive(jpg, jp, jnp.asarray(X0), PG,
                                    chunk_iterations=chunk), PG_TRACES)


@pytest.mark.parametrize("chunk", [13, 1])
def test_admm_warm_start_carry(chunk):
    """test_driver.py::test_admm_warm_start_carry: acceleration and penalty
    history carry; the chunks resume from the plain y."""
    jp, tp = small_lasso_admm()
    z = torch.zeros(2, dtype=torch.float64)
    mono = tadmm.solve(tp, z, tx0(), tx0(), params_from_jax(ACCEL))
    chunked = t_admm(tp, ACCEL, chunk_iterations=chunk)
    assert int(mono.status) == ADMMStatus.RESIDUAL_TOLERANCE
    _same(chunked, mono, ADMM_TRACES)
    assert torch.equal(chunked.y, mono.y) and torch.equal(chunked.lam,
                                                          mono.lam)
    _close_to_jax(chunked, j_admm(jp, ACCEL, chunk_iterations=chunk),
                  ADMM_TRACES)


def test_admm_residual_balance_chunked_equals_monolithic():
    """The penalty-adaptation schedule counts global iterations: a chunk
    size that is no multiple of the period changes nothing."""
    _, tp = small_lasso_admm()
    params = dataclasses.replace(
        ACCEL, rho=30.0, max_iterations=60,
        penalty_adaptation_mode=jadmm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE,
        penalty_adaptation_period=2, penalty_adaptation_window=40)
    z = torch.zeros(2, dtype=torch.float64)
    mono = tadmm.solve(tp, z, tx0(), tx0(), params_from_jax(params))
    assert len(set(mono.penalty_parameters[:20].tolist())) > 1
    _same(t_admm(tp, params, chunk_iterations=7), mono, ADMM_TRACES)


def test_per_iteration_observer_parity():
    """test_driver.py (proximal-gradient part) and
    test_convex.py::test_pg_observer_chunk1_sees_reference_callback_state:
    at chunk_iterations=1 the observer sees each iteration's objective, dx,
    line-search count and composite gradient norm."""
    _, tp = small_lasso_pg()
    params = params_from_jax(dataclasses.replace(PG, max_iterations=8,
                                                 composite_gradient_tolerance=1e-12,
                                                 relative_composite_gradient_tolerance=1e-14))
    seen = []
    TD.drive(tpg, tp, tx0(), params, chunk_iterations=1,
             observer=lambda total, r, t: seen.append(
                 (total, r.dx.clone(), int(r.linesearch_iterations[0]),
                  float(r.composite_gradient_norms[0]),
                  float(r.objective_values[0]), t)))
    mono = tpg.solve(tp, tx0(), dataclasses.replace(params,
                                                    log_iterates=True))
    assert len(seen) == 8
    it = mono.iterates
    after = torch.cat([it[1:8], mono.x[None]])
    for k, (total, dx, ls, g, F, t) in enumerate(seen):
        assert total == k + 1 and t >= 0.0
        torch.testing.assert_close(dx, after[k] - it[k], rtol=1e-10,
                                   atol=1e-12)
        assert ls == int(mono.linesearch_iterations[k])
        assert g == float(mono.composite_gradient_norms[k])
        assert F == float(mono.objective_values[k])


def test_admm_per_iteration_observer_parity():
    """test_driver.py::test_admm_per_iteration_observer_parity and the
    observer part of test_convex.py::test_admm_user_function_stops_...:
    one call per iteration, each seeing that iteration's residuals and the
    residual vectors r / s."""
    _, tp = small_lasso_admm()
    params = dataclasses.replace(ACCEL, max_iterations=25)
    z = torch.zeros(2, dtype=torch.float64)
    mono = tadmm.solve(tp, z, tx0(), tx0(), params_from_jax(params))
    seen = []
    t_admm(tp, params, chunk_iterations=1,
           observer=lambda total, r, t: seen.append(
               (total, float(r.primal_residuals[0]),
                float(r.dual_residuals[0]), float(torch.linalg.norm(r.r)),
                float(torch.linalg.norm(r.s)), int(r.iteration_types[0]))))
    n = int(mono.num_iterations)
    assert [s[0] for s in seen] == list(range(1, n + 1))
    for k, (_, pr, du, rn, sn, itype) in enumerate(seen):
        assert pr == float(mono.primal_residuals[k])
        assert du == float(mono.dual_residuals[k])
        assert itype == int(mono.iteration_types[k])
        assert rn == pytest.approx(pr, rel=1e-12)
        # the held NORM crosses chunks in warm_start; the held VECTOR does
        # not (as in the JAX package), so a one-iteration chunk that
        # restarts shows s = 0
        if itype != 2:
            assert sn == pytest.approx(du, rel=1e-12)


def test_admm_log_iterates_roundtrip():
    """test_driver.py::test_admm_log_iterates_roundtrip: the chunked run
    logs the monolithic history, zero-padded to max_iterations, as JAX's."""
    jp, tp = small_lasso_admm()
    params = dataclasses.replace(ACCEL, max_iterations=60, log_iterates=True)
    z = torch.zeros(2, dtype=torch.float64)
    mono = tadmm.solve(tp, z, tx0(), tx0(), params_from_jax(params))
    k = int(mono.num_iterations)
    assert torch.equal(mono.iterates[k - 1], mono.x)
    chunked = t_admm(tp, params, chunk_iterations=7)
    assert chunked.iterates.shape == (60, 2)
    assert torch.equal(chunked.iterates[:k], mono.iterates[:k])
    assert not chunked.iterates[k:].any()
    jres = j_admm(jp, params, chunk_iterations=7)
    assert jres.iterates.shape == (60, 2)
    np.testing.assert_allclose(chunked.iterates.numpy(),
                               np.asarray(jres.iterates), rtol=1e-9,
                               atol=1e-14)
    off = tadmm.solve(tp, z, tx0(), tx0(), tadmm.ADMMParams(max_iterations=5))
    assert off.iterates is None


def test_pg_log_iterates_stitched():
    jp, tp = small_lasso_pg()
    params = dataclasses.replace(PG, max_iterations=20, log_iterates=True,
                                 composite_gradient_tolerance=1e-14,
                                 relative_composite_gradient_tolerance=1e-14)
    mono = tpg.solve(tp, tx0(), params_from_jax(params))
    chunked = TD.drive(tpg, tp, tx0(), params_from_jax(params),
                       chunk_iterations=6)
    jres = JD.drive(jpg, jp, jnp.asarray(X0), params, chunk_iterations=6)
    assert chunked.iterates.shape == tuple(jres.iterates.shape)
    assert torch.equal(chunked.iterates[:20], mono.iterates)
    np.testing.assert_allclose(chunked.iterates.numpy(),
                               np.asarray(jres.iterates), rtol=1e-9,
                               atol=1e-14)


@pytest.mark.parametrize("solver", ["proximal_gradient", "admm"])
def test_verbose_lines_and_final_report_match_jax(capsys, solver):
    """test_driver.py::test_final_report_admm and the per-iteration lines:
    the port prints what JAX prints, letter for letter."""
    if solver == "admm":
        jp, tp = small_lasso_admm()
        params = jadmm.ADMMParams(max_iterations=4, verbose=True,
                                  eps_abs_pri=1e-12, eps_abs_dual=1e-12,
                                  eps_rel=1e-14)
        t_admm(tp, params, chunk_iterations=2)
        t_out = capsys.readouterr().out
        j_admm(jp, params, chunk_iterations=2)
        j_out = capsys.readouterr().out
        assert "ADMM terminated: iteration limit reached" in t_out
        assert "primal residual:" in t_out and "rho:" in t_out
    else:
        jp, tp = small_lasso_pg()
        params = dataclasses.replace(PG, verbose=True, precision=5)
        TD.drive(tpg, tp, tx0(), params_from_jax(params))
        t_out = capsys.readouterr().out
        JD.drive(jpg, jp, jnp.asarray(X0), params)
        j_out = capsys.readouterr().out
        assert ("Proximal gradient terminated: composite gradient tolerance "
                "reached") in t_out
        assert "|G|:" in t_out
    assert len(t_out.splitlines()) > 5
    assert _mask(t_out) == _mask(j_out)


@pytest.mark.parametrize("solver", ["proximal_gradient", "admm"])
def test_zero_max_iterations(solver, capsys):
    if solver == "admm":
        jp, tp = small_lasso_admm()
        params = jadmm.ADMMParams(max_iterations=0, verbose=True)
        t, j = t_admm(tp, params), j_admm(jp, params)
        assert int(t.status) == ADMMStatus.ITERATION_LIMIT
        fields = ADMM_TRACES
    else:
        jp, tp = small_lasso_pg()
        params = dataclasses.replace(PG, max_iterations=0, verbose=True)
        t = TD.drive(tpg, tp, tx0(), params_from_jax(params))
        j = JD.drive(jpg, jp, jnp.asarray(X0), params)
        assert int(t.status) == ProximalGradientStatus.ITERATION_LIMIT
        fields = PG_TRACES
    assert int(t.num_iterations) == 0 and torch.equal(t.x, tx0())
    out = capsys.readouterr().out
    assert "nan" in out          # the summary of a run without iterations
    for f in fields + ("times",):
        assert tuple(getattr(t, f).shape) == tuple(getattr(j, f).shape), f


def test_elapsed_time_and_interpolation():
    """max_computation_time = 0 stops after the first chunk with the
    solver's ELAPSED_TIME code; test_driver.py::test_interpolation_admm."""
    _, tp = small_lasso_admm()
    _, tq = small_lasso_pg()
    r = t_admm(tp, dataclasses.replace(ACCEL, max_computation_time=0.0),
               chunk_iterations=5)
    assert int(r.status) == ADMMStatus.ELAPSED_TIME
    assert int(r.num_iterations) == 5
    r = TD.drive(tpg, tq, tx0(), params_from_jax(dataclasses.replace(
        PG, max_computation_time=0.0)), chunk_iterations=4)
    assert int(r.status) == ProximalGradientStatus.ELAPSED_TIME
    assert int(r.num_iterations) == 4
    params = jadmm.ADMMParams(max_iterations=30, eps_rel=0.0,
                              eps_abs_pri=0.0, eps_abs_dual=0.0)
    flat = t_admm(tp, params, chunk_iterations=11)
    interp = t_admm(tp, params, chunk_iterations=11, time_interpolation=True)
    assert torch.equal(interp.x, flat.x)
    n = int(interp.num_iterations)
    assert (np.diff(interp.times[:n].numpy()) > 0).all()
    tf = flat.times[:n].numpy()
    assert (np.diff(tf) >= 0).all() and (np.diff(tf) == 0).any()


@pytest.mark.parametrize("solver", ["proximal_gradient", "admm"])
def test_user_function_sees_the_global_iteration(solver):
    """The chosen contract for chunked runs: the predicate's k is the
    global iteration (the reference's), so a stop at k == K ends a chunked
    run exactly where it ends a monolithic one, in the port and in JAX's
    monolithic run alike.  (In the JAX package's chunked run k restarts at
    0 in every chunk.)"""
    K, ks = 7, []
    if solver == "admm":
        jp, tp = small_lasso_admm()

        def stop(k, x, y, lam, rho, r, s):
            if isinstance(x, torch.Tensor):
                ks.append(int(k))
            return k == K
        z = torch.zeros(2, dtype=torch.float64)
        mono = tadmm.solve(tp, z, tx0(), tx0(), params_from_jax(ACCEL),
                           user_function=stop)
        ks.clear()
        chunked = t_admm(tp, ACCEL, chunk_iterations=3, user_function=stop)
        jmono = jadmm.solve(jp, jnp.zeros(2), jnp.asarray(X0),
                            jnp.asarray(X0), ACCEL, user_function=stop)
        code, fields = ADMMStatus.USER_FUNCTION, ADMM_TRACES
    else:
        jp, tp = small_lasso_pg()

        def stop(k, x, F, G, ls, dx, dF):
            if isinstance(x, torch.Tensor):
                ks.append(int(k))
            return k == K
        mono = tpg.solve(tp, tx0(), params_from_jax(PG), user_function=stop)
        ks.clear()
        chunked = TD.drive(tpg, tp, tx0(), params_from_jax(PG),
                           chunk_iterations=3, user_function=stop)
        jmono = jpg.solve(jp, jnp.asarray(X0), PG, user_function=stop)
        code, fields = ProximalGradientStatus.USER_FUNCTION, PG_TRACES
    assert ks == list(range(K + 1))
    assert int(chunked.status) == code
    assert int(chunked.num_iterations) == K + 1 == int(jmono.num_iterations)
    _same(chunked, mono, fields)
    np.testing.assert_allclose(chunked.x.numpy(), np.asarray(jmono.x),
                               rtol=1e-9)


def test_checkpoints(tmp_path):
    """The port writes (x, warm_start) for proximal gradient and (x, y,
    warm_start) for ADMM, as the JAX package does; a file JAX's drive_admm
    wrote loads into the port's state (dict leaves in sorted-key order) and
    resumes to the monolithic run's iterates."""
    jp, tp = small_lasso_admm()
    _, tq = small_lasso_pg()
    path = str(tmp_path / "pg.npz")
    r = TD.drive(tpg, tq, tx0(), params_from_jax(PG), chunk_iterations=9,
                 checkpoint_path=path)
    x, ws = load_pytree(path, (r.x, r.warm_start))
    assert torch.equal(x, r.x)
    assert all(torch.equal(a, b) for a, b in zip(ws, r.warm_start))

    params = dataclasses.replace(ACCEL, max_iterations=12)
    jpath = str(tmp_path / "jadmm.npz")
    j_admm(jp, params, chunk_iterations=12, checkpoint_path=jpath)
    z = torch.zeros(2, dtype=torch.float64)
    like = tadmm.solve(tp, z, tx0(), tx0(), tadmm.ADMMParams(
        max_iterations=1, mode=tadmm.ADMMMode.ACCELERATED))
    x, y, ws = load_pytree(jpath, (like.x, like.y, like.warm_start))
    assert ws[2]["iteration_type"].dtype == torch.int32
    rest = tadmm.solve(tp, z, x, y, params_from_jax(dataclasses.replace(
        ACCEL, max_iterations=138)), warm_start=ws, iteration_offset=12)
    mono = tadmm.solve(tp, z, tx0(), tx0(), params_from_jax(ACCEL))
    torch.testing.assert_close(rest.x, mono.x, rtol=1e-9, atol=1e-14)
    assert int(rest.num_iterations) + 12 == int(mono.num_iterations)

    tpath = str(tmp_path / "tadmm.npz")
    r = t_admm(tp, params, chunk_iterations=5, checkpoint_path=tpath)
    x, y, ws = load_pytree(tpath, (like.x, like.y, like.warm_start))
    assert torch.equal(x, r.x) and torch.equal(y, r.warm_start[2]["y_prev"])


def test_jax_warm_start_carried_over_by_interop():
    """A run started in JAX resumes in the port through
    ``interop.*_warm_start_from_jax`` to the iterates of an uninterrupted
    run (float64, rtol 1e-9)."""
    jp, tp = small_lasso_admm()
    z = torch.zeros(2, dtype=torch.float64)
    head = jadmm.solve(jp, jnp.zeros(2), jnp.asarray(X0), jnp.asarray(X0),
                       dataclasses.replace(ACCEL, max_iterations=6))
    ws = admm_warm_start_from_jax(head.warm_start, device="cpu")
    assert ws[2]["y_prev"].dtype == torch.float64
    x = torch.from_numpy(np.asarray(head.x).copy())
    rest = tadmm.solve(tp, z, x, ws[2]["y_prev"], params_from_jax(
        dataclasses.replace(ACCEL, max_iterations=144)), warm_start=ws,
        iteration_offset=6)
    mono = tadmm.solve(tp, z, tx0(), tx0(), params_from_jax(ACCEL))
    assert int(rest.num_iterations) + 6 == int(mono.num_iterations)
    assert int(rest.status) == int(mono.status)
    torch.testing.assert_close(rest.x, mono.x, rtol=1e-9, atol=1e-14)
    torch.testing.assert_close(rest.y, mono.y, rtol=1e-9, atol=1e-14)

    jq, tq = small_lasso_pg()
    head = jpg.solve(jq, jnp.asarray(X0), dataclasses.replace(
        PG, max_iterations=15))
    ws = proximal_gradient_warm_start_from_jax(head.warm_start, device="cpu")
    rest = tpg.solve(tq, torch.from_numpy(np.asarray(head.x).copy()),
                     params_from_jax(dataclasses.replace(
                         PG, max_iterations=285)), warm_start=ws)
    mono = tpg.solve(tq, tx0(), params_from_jax(PG))
    assert int(rest.num_iterations) + 15 == int(mono.num_iterations)
    torch.testing.assert_close(rest.x, mono.x, rtol=1e-9, atol=1e-14)


def test_params_from_jax_carries_enums():
    p = params_from_jax(dataclasses.replace(
        ACCEL,
        penalty_adaptation_mode=jadmm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE))
    assert isinstance(p, tadmm.ADMMParams)
    assert p.mode is tadmm.ADMMMode.ACCELERATED
    assert p.penalty_adaptation_mode is \
        tadmm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE
    q = params_from_jax(dataclasses.replace(
        PG, mode=jpg.ProximalGradientMode.SIMPLE))
    assert q.mode is tpg.ProximalGradientMode.SIMPLE and q.L == PG.L
