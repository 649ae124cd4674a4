"""The port's TNLS (and ``euclidean_tnls``) == the JAX package's, on every
case of ``tests/test_tnls.py`` (reference ``TNLS_unit_test.cpp``): the
sinusoid fit sin(omega x + phi), m = 100 points on [-pi, pi], truth
(pi/2, pi/4), start (1, 1).

- root finding on clean data;
- the noisy fit, plain and with the QR right preconditioner;
- the user stop;
- a batch of 4 noise realizations, solved one by one (the JAX package
  vmaps the solve);
- ``euclidean_tnls``.

The same float64 inputs go to both packages.  Each case asserts the JAX
test's own contract on the port's result, then parity with JAX's run:
status and iteration count EQUAL, the inner (LSQR) iteration trace EQUAL,
x and every float trace within rtol 1e-7 (the same recurrences; reduction
orders differ, and late in a solve |F| is a difference of nearly equal
sums).  At a root the last |gradL| = |J'F| / |F| is the direction of a
residual at its rounding floor (|F| < 1e-6 from O(1) terms): it is held
to rtol 1e-5 there.  The gain ratios rho are held to rtol 1e-6 on the
steps that changed |F| by more than 1e-6 relative; late in a fit both
|F|^2 - |F+|^2 and the model decrease are ~1e-8 of |F|^2, and rho is a
quotient of cancelled differences (measured up to 17% apart, 8/7 against
0.975): there only the decision rho > eta1 is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import LeastSquaresProblem as JLSP
from optimization_tpu import euclidean_tnls as j_euclidean_tnls
from optimization_tpu.solvers import tnls as jtnls
from optimization_tpu_torch import LeastSquaresProblem as TLSP
from optimization_tpu_torch import euclidean_tnls as t_euclidean_tnls
from optimization_tpu_torch.core.types import TNLSStatus
from optimization_tpu_torch.interop import params_from_jax, result_to_numpy
from optimization_tpu_torch.solvers import tnls as ttnls

torch.set_num_threads(1)

EPS = 1e-6
M_PTS = 100
OMEGA, PHI = np.pi / 2, np.pi / 4
XS = np.linspace(-np.pi, np.pi, M_PTS)
Y_CLEAN = np.sin(OMEGA * XS + PHI)
BETA0 = np.array([1.0, 1.0])
JXS, TXS = jnp.asarray(XS), torch.from_numpy(XS)


def j_residual(beta, y):
    return y - jnp.sin(beta[0] * JXS + beta[1])


def t_residual(beta, y):
    return y - torch.sin(beta[0] * TXS + beta[1])


def _noisy(seed=3):
    z = 0.1 * np.random.default_rng(seed).uniform(-1, 1, M_PTS)
    return Y_CLEAN + z, float(np.linalg.norm(z))


NOISY_PARAMS = jtnls.TNLSParams(
    relative_decrease_tolerance=0.0, gradient_tolerance=EPS,
    stepsize_tolerance=0.0, Delta_tolerance=1e-10)


def _assert_matches(tres, jres, rtol=1e-7, grad_rtol=1e-7):
    t = result_to_numpy(tres)
    assert int(t.status) == int(jres.status)
    assert int(t.num_iterations) == int(jres.num_iterations)
    np.testing.assert_array_equal(t.inner_iterations,
                                  np.asarray(jres.inner_iterations))
    for name in ("x", "f", "gradfx_norm", "objective_values",
                 "gradient_norms", "trust_region_radius",
                 "update_step_norms", "times"):
        np.testing.assert_allclose(
            getattr(t, name), np.asarray(getattr(jres, name)),
            rtol=grad_rtol if "grad" in name else rtol, atol=1e-12,
            err_msg=name)
    # rho where the step changed |F| by more than 1e-6 relative; below
    # that it is a quotient of cancelled differences, and only its
    # decision (rho > eta1) is compared
    jrho = np.asarray(jres.rho)
    np.testing.assert_array_equal(np.isfinite(t.rho), np.isfinite(jrho))
    steps = int(np.isfinite(t.rho).sum())
    F = t.objective_values
    big = np.abs(F[:steps] - F[1:steps + 1]) > 1e-6 * F[:steps]
    np.testing.assert_allclose(t.rho[:steps][big], jrho[:steps][big],
                               rtol=1e-6, err_msg="rho")
    np.testing.assert_array_equal(t.rho[:steps] > 0.05,
                                  jrho[:steps] > 0.05)


def _solve(params, y, precon=None, grad_rtol=1e-7, **kw):
    jp = JLSP(residual=j_residual, precon=precon and precon[0])
    tp = TLSP(residual=t_residual, precon=precon and precon[1])
    jres = jtnls.solve(jp, jnp.asarray(BETA0), params, data=jnp.asarray(y),
                       **kw)
    tres = ttnls.solve(tp, torch.from_numpy(BETA0), params_from_jax(params),
                       data=torch.from_numpy(y), **kw)
    _assert_matches(tres, jres, grad_rtol=grad_rtol)
    return tres


def test_root_finding():
    params = jtnls.TNLSParams(
        relative_decrease_tolerance=0.0, gradient_tolerance=0.0,
        stepsize_tolerance=0.0, Delta_tolerance=0.0, root_tolerance=EPS)
    res = _solve(params, Y_CLEAN, grad_rtol=1e-5)
    assert int(res.status) == TNLSStatus.ROOT
    assert float(torch.linalg.norm(t_residual(res.x, torch.from_numpy(
        Y_CLEAN)))) < EPS
    np.testing.assert_allclose(res.x.numpy(), [OMEGA, PHI], atol=1e-5)


def _qr_precon(y):
    """The right preconditioner R^-1 from a QR of the Jacobian, in both
    packages (tests/test_tnls.py::test_noisy_least_squares_
    preconditioned)."""
    jy, ty = jnp.asarray(y), torch.from_numpy(y)

    def j_r(x):
        return jnp.linalg.qr(jax.jacfwd(lambda b: j_residual(b, jy))(x),
                             mode="r")

    def t_r(x):
        J = torch.func.jacfwd(lambda b: t_residual(b, ty))(x)
        return torch.linalg.qr(J, mode="r")[1]

    def t_solve(R, v, upper):
        return torch.linalg.solve_triangular(R, v[:, None],
                                             upper=upper)[:, 0]

    return ((lambda x, v, d: jax.scipy.linalg.solve_triangular(
                j_r(x), v, lower=False),
             lambda x, v, d: jax.scipy.linalg.solve_triangular(
                j_r(x).T, v, lower=True)),
            (lambda x, v, d: t_solve(t_r(x), v, True),
             lambda x, v, d: t_solve(t_r(x).T, v, False)))


@pytest.mark.parametrize("preconditioned", [False, True],
                         ids=["plain", "qr_precon"])
def test_noisy_least_squares(preconditioned):
    y, z_norm = _noisy()
    res = _solve(NOISY_PARAMS, y,
                 precon=_qr_precon(y) if preconditioned else None)
    assert int(res.status) == TNLSStatus.GRADIENT
    assert float(res.gradfx_norm) < EPS
    # the residual at the fit beats the residual at the planted signal
    assert float(torch.linalg.norm(t_residual(res.x, torch.from_numpy(
        y)))) < z_norm


def test_user_function_early_stop():
    params = jtnls.TNLSParams(max_iterations=50, root_tolerance=1e-10,
                              gradient_tolerance=1e-12,
                              relative_decrease_tolerance=0.0,
                              stepsize_tolerance=0.0)
    stop = lambda k, x, Fx, Delta, inner, h, dL, rho, acc: True
    res = _solve(params, Y_CLEAN, user_function=stop)
    assert int(res.status) == TNLSStatus.USER_FUNCTION
    np.testing.assert_array_equal(res.x.numpy(), BETA0)


def test_batch_of_four_as_a_loop():
    """tests/test_tnls.py::test_batched_tnls: the JAX package vmaps one
    solve over 4 noise realizations; the port solves them one by one, each
    matching the JAX fleet's instance."""
    rng = np.random.default_rng(7)
    ys = Y_CLEAN + 0.05 * rng.uniform(-1, 1, (4, M_PTS))
    jp = JLSP(residual=j_residual)
    jres = jax.vmap(lambda y: jtnls.solve(jp, jnp.asarray(BETA0),
                                          NOISY_PARAMS, data=y))(
        jnp.asarray(ys))
    tp = TLSP(residual=t_residual)
    for i in range(4):
        tres = ttnls.solve(tp, torch.from_numpy(BETA0),
                           params_from_jax(NOISY_PARAMS),
                           data=torch.from_numpy(ys[i]))
        np.testing.assert_allclose(tres.x.numpy(), [OMEGA, PHI], atol=0.05)
        _assert_matches(tres, jax.tree_util.tree_map(lambda l: l[i], jres))


def test_euclidean_tnls_matches_jax():
    y, _ = _noisy()
    j = j_euclidean_tnls(j_residual, jnp.asarray(BETA0), NOISY_PARAMS,
                         data=jnp.asarray(y))
    t = t_euclidean_tnls(t_residual, torch.from_numpy(BETA0),
                         params_from_jax(NOISY_PARAMS),
                         data=torch.from_numpy(y))
    _assert_matches(t, j)
    assert int(t.status) == TNLSStatus.GRADIENT


def test_params_validate():
    with pytest.raises(ValueError, match="lambda"):
        ttnls.TNLSParams(lam=-1.0).validate()
    with pytest.raises(ValueError, match="eta2"):
        ttnls.TNLSParams(eta1=0.5, eta2=0.4).validate()
