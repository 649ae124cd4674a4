"""The port's Euclidean entry points == the JAX package's, and the slice as
a whole.

- ``euclidean_gradient_descent`` and ``euclidean_tnt`` on the Rosenbrock
  fixture of ``tests/test_euclidean.py``, in both packages (float64; the
  tolerances of ``test_torch_gradient_descent.py`` and
  ``test_torch_tnt.py``, reasons there);
- the slice test: the SPD quadratic f(x) = 1/2 <x, A x> - <c, x> with
  A = diag(d) + 2I - S - S' (S the unit shift), n = 4096,
  d = 1 + 999 i/(n-1), c ~ N(0, 1) from numpy seed 0, x0 = 0, through
  ``euclidean_tnt(fused_dots=True)`` with the gradient A x - c and the
  Hessian-vector product A v taken from ``diag_stencil_matvec`` in each
  package (the port's plain versions; JAX's Pallas kernels in interpret
  mode).  Status, ``num_iterations`` and the ``inner_iterations`` trace
  must be EQUAL; f within rtol 1e-6 and x within 1e-5 |x|: both packages
  take their CG dots in f32, in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import euclidean_gradient_descent as j_gd
from optimization_tpu import euclidean_tnt as j_tnt
from optimization_tpu.kernels import diag_stencil_matvec as j_stencil
from optimization_tpu.solvers import gradient_descent as jgd
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import euclidean_gradient_descent as t_gd
from optimization_tpu_torch import euclidean_tnt as t_tnt
from optimization_tpu_torch.core.types import GradientDescentStatus, TNTStatus
from optimization_tpu_torch.interop import params_from_jax, result_to_numpy
from optimization_tpu_torch.kernels import fused

torch.set_num_threads(1)

X0 = np.array([-0.5, 0.5])
N = 4096


def rosenbrock(x, data):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def test_euclidean_gradient_descent_matches_jax():
    params = jgd.GradientDescentParams(max_iterations=20000,
                                       gradient_tolerance=1e-6,
                                       relative_decrease_tolerance=0.0,
                                       stepsize_tolerance=0.0)
    j = j_gd(rosenbrock, jnp.asarray(X0), params)
    t = t_gd(rosenbrock, torch.from_numpy(X0), params_from_jax(params))
    assert int(t.status) == int(j.status) == GradientDescentStatus.GRADIENT
    assert int(t.num_iterations) == int(j.num_iterations)
    np.testing.assert_array_equal(t.linesearch_iterations.numpy(),
                                  np.asarray(j.linesearch_iterations))
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-12)
    np.testing.assert_allclose(t.gradient_norms.numpy(),
                               np.asarray(j.gradient_norms), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(t.x.numpy(), [1.0, 1.0], atol=1e-4)


def test_euclidean_tnt_matches_jax():
    params = jtnt.TNTParams(max_iterations=200, gradient_tolerance=1e-8,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0)
    j = j_tnt(rosenbrock, jnp.asarray(X0), params)
    t = t_tnt(rosenbrock, torch.from_numpy(X0), params_from_jax(params))
    assert int(t.status) == int(j.status) == TNTStatus.GRADIENT
    assert int(t.num_iterations) == int(j.num_iterations)
    np.testing.assert_array_equal(t.inner_iterations.numpy(),
                                  np.asarray(j.inner_iterations))
    np.testing.assert_allclose(t.objective_values.numpy(),
                               np.asarray(j.objective_values), rtol=1e-7,
                               atol=1e-14)
    np.testing.assert_allclose(t.x.numpy(), [1.0, 1.0], atol=1e-6)


def _slice_data(n=N):
    d = 1.0 + 999.0 * np.arange(n) / (n - 1)
    c = np.random.default_rng(0).normal(size=n)
    return d, c


SLICE_PARAMS = jtnt.TNTParams(max_iterations=20, max_TPCG_iterations=100,
                              gradient_tolerance=0.0,
                              preconditioned_gradient_tolerance=0.0,
                              relative_decrease_tolerance=0.0,
                              stepsize_tolerance=0.0, fused_dots=True)


def _port_slice(c, matvec):
    """The slice problem in the port; ``matvec(v)`` applies A."""
    tc = torch.from_numpy(c)
    return t_tnt(lambda x, _: 0.5 * torch.dot(x, matvec(x)) - torch.dot(tc, x),
                 torch.zeros(len(c), dtype=torch.float64),
                 params_from_jax(SLICE_PARAMS),
                 grad=lambda x, _: matvec(x) - tc,
                 hess_vec=lambda x, v, _: matvec(v))


def test_slice_fused_tnt_on_stencil_matches_jax():
    d, c = _slice_data()
    jd, jc = jnp.asarray(d), jnp.asarray(c)
    j = j_tnt(lambda x, _: 0.5 * jnp.dot(x, j_stencil(jd, x)) - jnp.dot(jc, x),
              jnp.zeros(N), SLICE_PARAMS,
              grad=lambda x, _: j_stencil(jd, x) - jc,
              hess_vec=lambda x, v, _: j_stencil(jd, v))
    td = torch.from_numpy(d)
    t = _port_slice(c, lambda v: fused.diag_stencil_matvec(td, v))
    tn = result_to_numpy(t)
    k = int(j.num_iterations)
    assert int(tn.status) == int(j.status) == TNTStatus.TRUST_REGION
    assert int(tn.num_iterations) == k == 8
    np.testing.assert_array_equal(tn.inner_iterations[:k],
                                  np.asarray(j.inner_iterations)[:k])
    assert tn.inner_iterations[:k].tolist() == [15, 23, 35, 30, 38, 53, 75,
                                                100]
    np.testing.assert_allclose(float(tn.f), float(j.f), rtol=1e-6)
    jx = np.asarray(j.x)
    assert np.linalg.norm(tn.x - jx) <= 1e-5 * np.linalg.norm(jx)
    # |grad f| fell by ~9 orders from |c| (the stopping point of both)
    assert float(tn.gradfx_norm) < 1e-7 * np.linalg.norm(c)


def test_slice_affine_route_equals_stored_route():
    """The matrix-free variant of the slice: the affine stencil generates
    the diagonal the stored route reads (d = 1 + b i, built in f32 by both),
    so the two solves are identical, iterate for iterate."""
    n = 2048
    b = 999.0 / (n - 1)
    _, c = _slice_data(n)
    d32 = (torch.tensor(b, dtype=torch.float32)
           * torch.arange(n, dtype=torch.float32) + 1.0).double()
    stored = _port_slice(c, lambda v: fused.diag_stencil_matvec(d32, v))
    affine = _port_slice(c, lambda v: fused.affine_stencil_matvec(v, a=1.0,
                                                                  b=b))
    assert int(affine.num_iterations) == int(stored.num_iterations) > 3
    assert torch.equal(affine.inner_iterations, stored.inner_iterations)
    assert torch.equal(affine.x, stored.x)
