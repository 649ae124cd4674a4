"""The port's host driver ``core.driver.drive`` == the JAX package's, on the
cases of ``tests/test_driver.py`` for gradient descent, TNT and TNLS (the
ADMM and proximal-gradient cases are in ``test_torch_drive_convex.py``).

- chunked == monolithic in the port: status, iteration count, x bit for
  bit, every stitched trace (NaN padding included), at chunk sizes that
  do not divide the run; and the port's chunked run against JAX's chunked
  run at the tolerances of ``tests/test_torch_tnt.py`` /
  ``test_torch_gradient_descent.py`` (float64, rtol 1e-9 where the solve
  stops before its rounding floor, 1e-7 on the Rosenbrock valley);
- the host facilities: ELAPSED_TIME, verbose lines and the final
  "<Solver> terminated: <reason>" report equal to JAX's character for
  character once the wall-clock fields are masked, observers per chunk
  and per iteration, checkpoints, time interpolation;
- ``max_iterations=0``, and a solver module without an adapter raising.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import LeastSquaresProblem as JLSP
from optimization_tpu import RiemannianProblem as JProblem
from optimization_tpu.core import driver as JD
from optimization_tpu.manifolds import sphere as jsphere
from optimization_tpu.solvers import gradient_descent as jgd
from optimization_tpu.solvers import tnls as jtnls
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import LeastSquaresProblem as TLSP
from optimization_tpu_torch import RiemannianProblem as TProblem
from optimization_tpu_torch.core import driver as TD
from optimization_tpu_torch.core.checkpoint import load_pytree
from optimization_tpu_torch.core.types import (GradientDescentStatus,
                                               TNTStatus)
from optimization_tpu_torch.interop import params_from_jax, result_to_numpy
from optimization_tpu_torch.manifolds import sphere
from optimization_tpu_torch.solvers import gradient_descent as tgd
from optimization_tpu_torch.solvers import tnls as ttnls
from optimization_tpu_torch.solvers import tnt as ttnt

torch.set_num_threads(1)

X0 = np.array([-0.5, 0.5])


def rosenbrock(x, data):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _mask(text):
    text = re.sub(r"time: \d+\.\d+", "time: T", text)
    return re.sub(r"elapsed: \d+\.\d+ s", "elapsed: T s", text)


def _same(a, b, fields):
    """Port results a and b are equal field by field (NaN padding too)."""
    assert int(a.status) == int(b.status)
    assert int(a.num_iterations) == int(b.num_iterations)
    assert torch.equal(a.x, b.x)
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)


def _close_to_jax(t, j, fields, rtol):
    tn = result_to_numpy(t)
    assert int(tn.status) == int(j.status)
    assert int(tn.num_iterations) == int(j.num_iterations)
    for f in ("x",) + tuple(fields):
        np.testing.assert_allclose(getattr(tn, f), np.asarray(getattr(j, f)),
                                   rtol=rtol, atol=1e-14, err_msg=f)


GD_PARAMS = jgd.GradientDescentParams(
    max_iterations=200, gradient_tolerance=1e-6,
    relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
TNT_PARAMS = jtnt.TNTParams(
    max_iterations=100, gradient_tolerance=1e-9,
    relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
    preconditioned_gradient_tolerance=0.0)
GD_TRACES = ("objective_values", "gradient_norms", "update_step_norms",
             "linesearch_iterations")
TNT_TRACES = ("objective_values", "gradient_norms",
              "preconditioned_gradient_norms", "trust_region_radius",
              "inner_iterations", "update_step_norms", "update_step_M_norms",
              "gain_ratios")


def test_gradient_descent_chunked_equals_monolithic_and_jax():
    params = params_from_jax(GD_PARAMS)
    tp = TProblem(f=rosenbrock)
    mono = tgd.solve(tp, torch.from_numpy(X0), params)
    chunked = TD.drive(tgd, tp, torch.from_numpy(X0), params,
                       chunk_iterations=17)
    _same(chunked, mono, GD_TRACES)
    n = int(chunked.num_iterations)
    assert np.isfinite(chunked.times[:n].numpy()).all()
    jres = JD.drive(jgd, JProblem(f=rosenbrock), jnp.asarray(X0), GD_PARAMS,
                    chunk_iterations=17)
    _close_to_jax(chunked, jres, GD_TRACES[:2], rtol=1e-7)


def test_tnt_delta_carry_chunked_equals_monolithic_and_jax():
    params = params_from_jax(TNT_PARAMS)
    tp = TProblem(f=rosenbrock)
    mono = ttnt.solve(tp, torch.from_numpy(X0), params)
    chunked = TD.drive(ttnt, tp, torch.from_numpy(X0), params,
                       chunk_iterations=7)
    _same(chunked, mono, TNT_TRACES)
    assert int(chunked.status) == TNTStatus.GRADIENT
    jres = JD.drive(jtnt, JProblem(f=rosenbrock), jnp.asarray(X0),
                    TNT_PARAMS, chunk_iterations=7)
    # ~30 steps down the curved valley: ulp differences reach ~1e-8
    _close_to_jax(chunked, jres, ("objective_values",
                                  "trust_region_radius"), rtol=1e-7)


def test_tnt_sphere_log_iterates():
    P = np.array([0.0, 0.0, 1.0])
    params = jtnt.TNTParams(max_iterations=50, gradient_tolerance=1e-8,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0,
                            log_iterates=True)
    x0 = np.array([1.0, 0.0, 0.0])
    tp = TProblem(f=lambda x, d: torch.sum((x - torch.from_numpy(P)) ** 2),
                  manifold=sphere())
    mono = ttnt.solve(tp, torch.from_numpy(x0), params_from_jax(params))
    chunked = TD.drive(ttnt, tp, torch.from_numpy(x0),
                       params_from_jax(params), chunk_iterations=3)
    n = int(mono.num_iterations)
    assert torch.equal(chunked.iterates[:n + 1], mono.iterates[:n + 1])
    jres = JD.drive(jtnt, JProblem(
        f=lambda x, d: jnp.sum((x - jnp.asarray(P)) ** 2),
        manifold=jsphere()), jnp.asarray(x0), params, chunk_iterations=3)
    np.testing.assert_allclose(chunked.iterates[:n + 1].numpy(),
                               np.asarray(jres.iterates)[:n + 1], rtol=1e-9,
                               atol=1e-14)


def test_tnls_chunked_equals_monolithic_and_jax():
    t = np.linspace(0.0, 2.0, 60)
    y = np.sin(1.7 * t + 0.4) + 0.01 * np.cos(13 * t)
    jt, jy, tt, ty = (jnp.asarray(t), jnp.asarray(y), torch.from_numpy(t),
                      torch.from_numpy(y))
    params = jtnls.TNLSParams(max_iterations=60, gradient_tolerance=1e-10,
                              root_tolerance=1e-12,
                              relative_decrease_tolerance=0.0,
                              stepsize_tolerance=0.0)
    b0 = np.array([1.5, 0.2])
    tp = TLSP(residual=lambda b, d: torch.sin(b[0] * tt + b[1]) - ty)
    mono = ttnls.solve(tp, torch.from_numpy(b0), params_from_jax(params))
    chunked = TD.drive(ttnls, tp, torch.from_numpy(b0),
                       params_from_jax(params), chunk_iterations=7)
    _same(chunked, mono, ("objective_values", "gradient_norms",
                          "trust_region_radius", "inner_iterations",
                          "update_step_norms", "rho"))
    jres = JD.drive(jtnls, JLSP(
        residual=lambda b, d: jnp.sin(b[0] * jt + b[1]) - jy),
        jnp.asarray(b0), params, chunk_iterations=7)
    _close_to_jax(chunked, jres, ("objective_values",
                                  "trust_region_radius"), rtol=1e-7)


def test_elapsed_time_status():
    params = tgd.GradientDescentParams(
        max_iterations=10**6, gradient_tolerance=0.0,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        max_computation_time=0.05)
    r = TD.drive(tgd, TProblem(f=rosenbrock), torch.from_numpy(X0), params,
                 chunk_iterations=50)
    assert int(r.status) == GradientDescentStatus.ELAPSED_TIME
    assert 0 < int(r.num_iterations) < 10**6


@pytest.mark.parametrize("solver", ["gradient_descent", "tnt"])
def test_verbose_lines_and_final_report_match_jax(capsys, solver):
    if solver == "gradient_descent":
        jp = jgd.GradientDescentParams(
            max_iterations=3, gradient_tolerance=0.0,
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            verbose=True, precision=4)
        jmod, tmod, chunk = jgd, tgd, None
        want = "Gradient descent terminated: iteration limit reached"
    else:
        jp = jtnt.TNTParams(**{**TNT_PARAMS.__dict__, "verbose": True})
        jmod, tmod, chunk = jtnt, ttnt, 10
        want = "TNT terminated: gradient norm tolerance reached"
    JD.drive(jmod, JProblem(f=rosenbrock), jnp.asarray(X0), jp,
             chunk_iterations=chunk)
    jax_out = capsys.readouterr().out
    r = TD.drive(tmod, TProblem(f=rosenbrock), torch.from_numpy(X0),
                 params_from_jax(jp), chunk_iterations=chunk)
    port_out = capsys.readouterr().out
    assert want in port_out and "elapsed:" in port_out
    assert port_out.count("Iter:") == int(r.num_iterations)
    if solver == "tnt":
        assert "|M^-1 g|:" in port_out
    assert _mask(port_out) == _mask(jax_out)


def test_observers_per_chunk_and_per_iteration():
    params = tgd.GradientDescentParams(
        max_iterations=20, gradient_tolerance=0.0,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
    seen = []
    TD.drive(tgd, TProblem(f=rosenbrock), torch.from_numpy(X0), params,
             chunk_iterations=5, observer=lambda k, r, t: seen.append(k))
    assert seen == [5, 10, 15, 20]
    # chunk_iterations=1: one call per iteration, each seeing the
    # iteration-start objective of the monolithic solve
    params = tgd.GradientDescentParams(
        max_iterations=12, gradient_tolerance=0.0,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
    mono = tgd.solve(TProblem(f=rosenbrock), torch.from_numpy(X0), params)
    fs, ks = [], []
    TD.drive(tgd, TProblem(f=rosenbrock), torch.from_numpy(X0), params,
             chunk_iterations=1,
             observer=lambda k, r, t: (
                 ks.append(k), fs.append(float(r.objective_values[0]))))
    n = int(mono.num_iterations)
    assert ks == list(range(1, n + 1))
    np.testing.assert_array_equal(fs, mono.objective_values[:n].numpy())


def test_checkpoint_written(tmp_path):
    params = ttnt.TNTParams(max_iterations=10, gradient_tolerance=0.0,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0)
    path = str(tmp_path / "ckpt.npz")
    r = TD.drive(ttnt, TProblem(f=rosenbrock), torch.from_numpy(X0), params,
                 chunk_iterations=5, checkpoint_path=path)
    x, Delta = load_pytree(path, (r.x, torch.zeros(())))
    assert torch.equal(x, r.x)
    assert float(Delta) == float(r.trust_region_radius[10])


def test_zero_max_iterations():
    params = tgd.GradientDescentParams(max_iterations=0,
                                       gradient_tolerance=1e-6)
    mono = tgd.solve(TProblem(f=rosenbrock), torch.from_numpy(X0), params)
    r = TD.drive(tgd, TProblem(f=rosenbrock), torch.from_numpy(X0), params)
    assert int(r.num_iterations) == int(mono.num_iterations) == 0
    assert torch.equal(r.x, torch.from_numpy(X0))


def test_fill_times_and_interpolation():
    counts, ends = [3, 2, 4], [0.3, 0.5, 0.9]
    for interpolate in (True, False):
        got = TD._fill_times(9, counts, ends, interpolate)
        want = JD._fill_times(9, counts, ends, interpolate)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 9
    t0, _ = TD._fill_times(3, [2, 0], [0.2, 0.3], True)
    np.testing.assert_allclose(t0[:2], [0.1, 0.2], rtol=1e-6)
    params = tgd.GradientDescentParams(
        max_iterations=40, gradient_tolerance=0.0,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
    flat = TD.drive(tgd, TProblem(f=rosenbrock), torch.from_numpy(X0),
                    params, chunk_iterations=17)
    interp = TD.drive(tgd, TProblem(f=rosenbrock), torch.from_numpy(X0),
                      params, chunk_iterations=17, time_interpolation=True)
    assert torch.equal(interp.x, flat.x)
    n = int(interp.num_iterations)
    t = interp.times[:n].numpy()
    assert np.isfinite(t).all() and (np.diff(t) > 0).all()
    tf = flat.times[:n].numpy()
    assert (np.diff(tf) >= 0).all() and (np.diff(tf) == 0).any()


def test_unported_solver_raises():
    """Every solver module of the package has an adapter now (the convex
    one since ``proximal_gradient`` was ported); a module without one
    raises."""
    from types import ModuleType

    from optimization_tpu_torch import CompositeProblem
    from optimization_tpu_torch.solvers import proximal_gradient as tpg
    res = TD.drive(tpg, CompositeProblem(
        f=lambda x, d: torch.sum(x * x), g=lambda x, d: 0.0 * torch.sum(x),
        prox_g=lambda x, lam, d: x), torch.ones(2, dtype=torch.float64),
        tpg.ProximalGradientParams(max_iterations=3), chunk_iterations=2)
    assert int(res.num_iterations) >= 1
    with pytest.raises(ValueError, match="No driver adapter"):
        TD.drive(ModuleType("lbfgs"), None, None,
                 tgd.GradientDescentParams())


def test_tnt_with_step_eval_chunked_equals_monolithic():
    """With a trial-step evaluator (the preconditioned headline problem,
    the kernel's plain version) the chunks resume through the port's
    warm_start carry, so chunked == monolithic bit for bit; the JAX
    driver's resume from x and the radius alone re-seeds the evaluator at
    x (ROADMAP Queue 3)."""
    from optimization_tpu_torch import headline

    n = 4096
    prob = headline.make_problem(n, "cpu", "streamed_reference", kappa=1e5,
                                 jacobi_power=0.25)
    params = ttnt.TNTParams(max_iterations=30, max_TPCG_iterations=100,
                            gradient_tolerance=1e-6,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0)
    x0 = headline.initial_point(n, torch.float32, "cpu", 3)
    mono = ttnt.solve(prob, x0, params)
    chunked = TD.drive(ttnt, prob, x0, params, chunk_iterations=10)
    _same(chunked, mono, TNT_TRACES)
    assert int(mono.inner_iterations.sum()) > 30
