"""The port's matrix completion (``models/matrix_completion.py``) == the JAX
package's.

The instance is made by the JAX package and carried across with
``interop.completion_data_from_jax``; U comes from JAX's spectral init.  The
inner ridge solve, f, its Riemannian gradient and Hessian-vector product
agree within 1e-10 in float64 (the batched normal matrices are one product
here, an einsum there); the SVD's signs differ, so the spectral inits are
compared as projectors; a short TNT takes the same counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.models import matrix_completion as jmc
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import interop
from optimization_tpu_torch.models import matrix_completion as mc
from optimization_tpu_torch.solvers import tnt

torch.set_num_threads(1)

M, N, K = 30, 25, 3


@pytest.fixture(scope="module")
def inst():
    M_true, data = jmc.random_instance(jax.random.PRNGKey(5), M, N, K,
                                       frac=0.6, noise=0.05, lam=1e-3)
    U = np.array(jmc.spectral_init(data, K))
    return (np.asarray(M_true), data,
            interop.completion_data_from_jax(data, device="cpu"), U)


def test_interop_carries_the_data(inst):
    _, data, tdata, _ = inst
    assert tdata.mask.dtype == torch.float64 and tdata.lam.dim() == 0
    np.testing.assert_array_equal(tdata.M_obs.numpy(), np.asarray(data.M_obs))
    assert float(tdata.lam) == float(data.lam)


def test_solve_W_f_grad_hvp_match(inst):
    _, data, tdata, U = inst
    V = np.random.default_rng(1).normal(size=U.shape)
    tU, tV = torch.from_numpy(U), torch.from_numpy(V)
    jU = jnp.asarray(U)
    np.testing.assert_allclose(mc.solve_W(tU, tdata).numpy(),
                               np.asarray(jmc.solve_W(jU, data)), atol=1e-10)
    tp, jp = mc.make_problem(), jmc.make_problem()
    np.testing.assert_allclose(float(tp.value(tU, tdata)),
                               float(jax.jit(jp.value)(jU, data)), rtol=1e-10)
    np.testing.assert_allclose(tp.rgrad(tU, tdata).numpy(),
                               np.asarray(jax.jit(jp.rgrad)(jU, data)),
                               atol=1e-10)
    tv = tp.manifold.proj(tU, tV)
    np.testing.assert_allclose(
        tp.hvp(tU, tv, tdata).numpy(),
        np.asarray(jax.jit(jp.hvp)(jU, jnp.asarray(tv.numpy()), data)),
        atol=1e-10)
    np.testing.assert_allclose(mc.predict(tU, tdata).numpy(),
                               np.asarray(jmc.predict(jU, data)), atol=1e-10)


def test_solve_W_is_columnwise_ridge(inst):
    _, _, tdata, U = inst
    W = mc.solve_W(torch.from_numpy(U), tdata).numpy()
    mask, Mo, lam = (tdata.mask.numpy(), tdata.M_obs.numpy(),
                     float(tdata.lam))
    for j in range(N):
        A = U.T @ (mask[:, j:j + 1] * U) + lam * np.eye(K)
        np.testing.assert_allclose(W[:, j], np.linalg.solve(
            A, U.T @ (mask[:, j] * Mo[:, j])), atol=1e-10)


def test_spectral_init_subspace_matches(inst):
    _, _, tdata, U = inst
    tU = mc.spectral_init(tdata, K).numpy()
    np.testing.assert_allclose(tU @ tU.T, U @ U.T, atol=1e-10)


def test_short_tnt_matches_jax(inst):
    M_true, data, tdata, U = inst
    kw = dict(max_iterations=15, gradient_tolerance=1e-8,
              relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
              preconditioned_gradient_tolerance=0.0, max_TPCG_iterations=200)
    jres = jtnt.solve(jmc.make_problem(), jnp.asarray(U),
                      jtnt.TNTParams(**kw), data=data)
    res = tnt.solve(mc.make_problem(), torch.from_numpy(U),
                    tnt.TNTParams(**kw), data=tdata)
    k = int(res.num_iterations)
    assert k == int(jres.num_iterations) and int(res.status) == \
        int(jres.status)
    np.testing.assert_array_equal(res.inner_iterations[:k].numpy(),
                                  np.asarray(jres.inner_iterations[:k]))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-8)
    np.testing.assert_allclose(float(res.f), float(jres.f), rtol=1e-10)


def test_random_instance_draws_on_the_generator():
    gen = torch.Generator().manual_seed(3)
    M_true, data = mc.random_instance(gen, 12, 10, 2, frac=0.5,
                                      dtype=torch.float64)
    assert M_true.shape == (12, 10) and data.lam.dtype == torch.float64
    assert set(np.unique(data.mask.numpy())) <= {0.0, 1.0}
    np.testing.assert_allclose(data.M_obs.numpy(),
                               (data.mask * M_true).numpy())


def test_f32_stops_on_round_off_as_jax_does():
    """config9's f32 stop, witnessed at a small size: from the same f32 data
    and start, JAX's TNT and the port's both end on TRUST_REGION above the
    gradient tolerance (the gain ratio is f32 round-off of f there), with
    the same inner counts before it; the port in float64 from the same data
    reaches GRADIENT.  Config9's frac, noise, lam and TNT params; m, n and k
    cut to keep it quick (there JAX and the port stop 40x above 1e-3)."""
    from optimization_tpu_torch.core.types import TNTStatus

    m, n, k = 1000, 800, 5
    M_true, data = jmc.random_instance(jax.random.PRNGKey(0), m, n, k,
                                       frac=0.1, noise=0.01, lam=1e-8)
    data = jmc.CompletionData(*(a.astype(jnp.float32) for a in data))
    U = jmc.spectral_init(data, k)
    kw = dict(max_iterations=60, gradient_tolerance=1e-3,
              relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
              preconditioned_gradient_tolerance=0.0, max_TPCG_iterations=100)
    jres = jtnt.solve(jmc.make_problem(), U, jtnt.TNTParams(**kw), data=data)
    tdata = interop.completion_data_from_jax(data, device="cpu")
    tU = torch.from_numpy(np.array(U))
    res = tnt.solve(mc.make_problem(), tU, tnt.TNTParams(**kw), data=tdata)
    res64 = tnt.solve(mc.make_problem(), tU.double(), tnt.TNTParams(**kw),
                      data=mc.CompletionData(*(a.double() for a in tdata)))
    assert res.x.dtype == torch.float32 and jres.x.dtype == jnp.float32
    assert int(jres.status) == int(res.status) == TNTStatus.TRUST_REGION
    assert min(float(jres.gradfx_norm), float(res.gradfx_norm)) > 1e-3
    np.testing.assert_array_equal(res.inner_iterations[:6].numpy(),
                                  np.asarray(jres.inner_iterations[:6]))
    assert int(res64.status) == TNTStatus.GRADIENT
    assert float(res64.gradfx_norm) <= 1e-3
    np.testing.assert_allclose(float(res.f), float(res64.f), rtol=1e-5)
    np.testing.assert_allclose(float(jres.f), float(res64.f), rtol=1e-5)
