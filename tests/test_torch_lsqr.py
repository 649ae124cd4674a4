"""The port's LSQR == the JAX package's ``lsqr``, on every case of
``tests/test_lsqr.py`` (reference ``IterativeSolvers_unit_test.cpp``, LSQR
half): the trivial A'b = 0 system, consistent and inconsistent 4 x 3
systems, a binding trust region, Tikhonov damping, validation, the user
stop, and the ``rsq`` recurrence (fixed regimes and the random sweep).

The same float64 inputs go to both packages; each case asserts the JAX
test's own contract on the port's result, and iterations EQUAL to JAX's,
x and xnorm within rtol 1e-9, rsq within rtol 1e-9 (the same recurrences;
the reduction order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.linalg.lsqr import lsqr as j_lsqr
from optimization_tpu_torch.linalg import lsqr as t_lsqr

torch.set_num_threads(1)

EPS_ABS = 1e-6
EPS_REL = 1e-6
A = np.array([[10.0, 5.0, 10.0],
              [2.0, 9.0, 8.0],
              [10.0, 2.0, 10.0],
              [10.0, 5.0, 7.0]])
B_INC = np.array([1.0, 9.0, 10.0, 2.0])


def _both(Am, b, **kw):
    """(port result, JAX result) for min |A x - b| with kw."""
    jA, tA = jnp.asarray(Am), torch.from_numpy(Am)
    jinner = lambda u, v: jnp.dot(u, v)
    j = j_lsqr(lambda x: jA @ x, lambda y: jA.T @ y, jnp.asarray(b),
               jinner, jinner, **kw)
    t = t_lsqr(lambda x: tA @ x, lambda y: tA.T @ y, torch.from_numpy(b),
               torch.dot, torch.dot, **kw)
    assert int(t.num_iterations) == int(j.num_iterations)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-9,
                               atol=1e-13)
    np.testing.assert_allclose(float(t.xnorm), float(j.xnorm), rtol=1e-9,
                               atol=1e-13)
    np.testing.assert_allclose(float(t.rsq), float(j.rsq), rtol=1e-9,
                               atol=1e-13)
    return t


def test_trivial_solution():
    A0 = np.zeros((3, 2))
    A0[1:, :] = np.eye(2)
    t = _both(A0, np.array([1.0, 0.0, 0.0]))
    assert int(t.num_iterations) == 0
    assert float(t.xnorm) < EPS_ABS
    assert abs(float(torch.linalg.norm(t.x)) - float(t.xnorm)) < EPS_ABS


def test_consistent_overdetermined():
    b = A @ np.array([1.0, 2.0, 3.0])
    t = _both(A, b, btol=EPS_REL)
    r = A @ t.x.numpy() - b
    assert np.linalg.norm(r) < np.linalg.norm(b) * EPS_REL
    xn = float(np.linalg.norm(t.x.numpy()))
    assert abs(float(t.xnorm) - xn) < EPS_REL * xn
    assert int(t.num_iterations) < 4 * A.shape[1]


def test_inconsistent():
    xtrue = np.linalg.lstsq(A, B_INC, rcond=None)[0]
    t = _both(A, B_INC, btol=0.0, Atol=EPS_REL)
    xn = float(np.linalg.norm(t.x.numpy()))
    assert np.linalg.norm(t.x.numpy() - xtrue) < xn
    assert abs(float(t.xnorm) - xn) < EPS_REL * xn
    assert int(t.num_iterations) < 4 * A.shape[1]


def test_trust_region_binding():
    xLS = np.linalg.lstsq(A, B_INC, rcond=None)[0]
    Delta = float(np.linalg.norm(xLS)) / 2
    t = _both(A, B_INC, btol=0.0, Atol=0.0, cond_limit=1e12, Delta=Delta)
    assert int(t.num_iterations) < 4 * A.shape[1]
    assert abs(float(t.xnorm) - Delta) < EPS_ABS
    assert np.linalg.norm(A @ t.x.numpy() - B_INC) < np.linalg.norm(B_INC)


def test_tikhonov():
    lam = 1.0
    xtrue = np.linalg.solve(A.T @ A + lam * np.eye(3), A.T @ B_INC)
    t = _both(A, B_INC, lam=lam, btol=0.0, Atol=EPS_REL)
    xn = float(np.linalg.norm(t.x.numpy()))
    assert np.linalg.norm(t.x.numpy() - xtrue) < xn
    assert int(t.num_iterations) < 4 * A.shape[1]


def test_param_validation():
    tA = torch.from_numpy(A)
    op, opt = (lambda x: tA @ x), (lambda y: tA.T @ y)
    b = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="lambda"):
        t_lsqr(op, opt, b, torch.dot, lam=-1.0)
    with pytest.raises(ValueError, match="Abar_cond_limit"):
        t_lsqr(op, opt, b, torch.dot, cond_limit=0.0)


def test_user_function_early_stop():
    A2 = np.array([[2.0, 0.0], [0.0, 3.0], [1.0, 1.0]])
    stop = lambda k, x, xn, rn, Arn, An, cn: k >= 0   # after the 1st
    t = _both(A2, np.array([2.0, 3.0, 2.0]), max_iterations=100,
              user_function=stop)
    assert int(t.num_iterations) == 1


@pytest.mark.parametrize("lam,Delta", [(0.0, None), (0.0, 0.35), (1.0, None),
                                       (1.0, 0.2)])
def test_rsq_recurrence_matches_explicit(lam, Delta):
    t = _both(A, B_INC, lam=lam, btol=0.0, Atol=1e-10, cond_limit=1e14,
              Delta=Delta, max_iterations=50)
    r = B_INC - A @ t.x.numpy()
    assert float(t.rsq) == pytest.approx(float(r @ r), rel=1e-8, abs=1e-10)
    if Delta is not None:
        assert float(t.xnorm) == pytest.approx(Delta, abs=1e-9)


def test_rsq_recurrence_random_sweep():
    rng = np.random.default_rng(0)
    for trial in range(20):
        m, n = int(rng.integers(3, 12)), int(rng.integers(2, 8))
        Arnd = rng.normal(size=(m, n))
        b = rng.normal(size=(m,))
        lam = float(rng.choice([0.0, 0.0, 0.3, 2.0]))
        xLS = np.linalg.lstsq(Arnd, b, rcond=None)[0]
        Delta = (None if trial % 2 else
                 float(0.3 + 0.7 * rng.random()) * max(
                     float(np.linalg.norm(xLS)), 1e-3))
        for kmax in (1, 2, 5, 30):
            t = _both(Arnd, b, lam=lam, btol=0.0, Atol=1e-12,
                      cond_limit=1e14, Delta=Delta, max_iterations=kmax)
            r = b - Arnd @ t.x.numpy()
            assert float(t.rsq) == pytest.approx(
                float(r @ r), rel=1e-7, abs=1e-9), (trial, m, n, lam, Delta,
                                                    kmax)
