"""The port's rotation synchronization == the JAX package's.

Instances are made by the JAX package (``random_instance``, the ring of
``tests/test_rotation_sync.py``) and carried across with
``interop.rotation_sync_data_from_jax``; every function gets the same
float64 inputs.  Tolerances: the cost, the preconditioner and the
connection Laplacian (all four ``scatter_method``s, weighted and not)
within 1e-12 (sums in another order); TNT from one R0 takes the same outer
and inner counts and ends within 1e-8 on each route; LOBPCG starts from
another random block in each package (torch and JAX draw different
numbers), so the spectral initialization, the certificate and the
staircase agree up to convergence and a global gauge: spectral init and
``round_lifted`` within 1e-8 (``mean_rotation_error`` between the two),
the certificate's flag equal, ``lam_min`` within 1e-6 and its stationarity
(no LOBPCG in it) within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.models import rotation_sync as jrs
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import interop
from optimization_tpu_torch.models import rotation_sync as rs
from optimization_tpu_torch.solvers import tnt

torch.set_num_threads(1)

N, D = 24, 3
PARAMS = dict(max_iterations=100, gradient_tolerance=1e-8,
              relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
              preconditioned_gradient_tolerance=0.0)
METHODS = ["scatter", "gather", "sort", "adjacency"]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def inst():
    """(R_true, JAX data, port data, JAX spectral init at a tight tau)."""
    R_true, data = jrs.random_instance(jax.random.PRNGKey(6), N, D,
                                       extra_edges=2 * N, noise=0.05,
                                       dtype=jnp.float64)
    R0 = jrs.spectral_init(data, N, D, tau=1e-10, max_iterations=500)
    return (np.array(R_true), data,
            interop.rotation_sync_data_from_jax(data, device="cpu"),
            np.array(R0))


def _weighted(data, tdata):
    kappa = np.random.default_rng(1).uniform(0.5, 2.0, data.src.shape[0])
    return (data._replace(kappa=jnp.asarray(kappa)),
            tdata._replace(kappa=torch.from_numpy(kappa)))


def _rotations(seed, n=N):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, D, D)))
    q[..., :, 0] *= np.sign(np.linalg.det(q))[..., None]
    return q


def _gauge_err(a, b):
    return float(rs.mean_rotation_error(torch.as_tensor(np.array(a)),
                                        torch.as_tensor(np.array(b))))


def test_interop_carries_the_data(inst):
    _, data, tdata, _ = inst
    assert tdata.kappa is None and tdata.src.dtype == torch.int64
    assert tdata.Rij.dtype == torch.float64 and tdata.src.device.type == "cpu"
    np.testing.assert_array_equal(tdata.dst.numpy(), np.asarray(data.dst))
    wdata, _ = _weighted(data, tdata)
    carried = interop.rotation_sync_data_from_jax(wdata, device="cpu")
    np.testing.assert_array_equal(carried.kappa.numpy(),
                                  np.asarray(wdata.kappa))


@pytest.mark.parametrize("weighted", [False, True], ids=["kappa1", "kappa"])
def test_cost_and_precon_match(inst, weighted):
    _, data, tdata, _ = inst
    if weighted:
        data, tdata = _weighted(data, tdata)
    R = _rotations(2)
    V = np.random.default_rng(3).normal(size=R.shape)
    np.testing.assert_allclose(
        float(rs.chordal_cost(torch.from_numpy(R), tdata)),
        float(jrs.chordal_cost(jnp.asarray(R), data)), rtol=1e-12)
    np.testing.assert_allclose(
        rs.jacobi_precon(torch.from_numpy(R), torch.from_numpy(V),
                         tdata).numpy(),
        np.asarray(jrs.jacobi_precon(jnp.asarray(R), jnp.asarray(V), data)),
        rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("weighted", [False, True], ids=["kappa1", "kappa"])
@pytest.mark.parametrize("method", METHODS)
def test_connection_laplacian_matches(inst, method, weighted):
    _, data, tdata, _ = inst
    if weighted:
        data, tdata = _weighted(data, tdata)
    X = np.random.default_rng(4).normal(size=(N * D, 4))
    out = rs.connection_laplacian_op(tdata, N, D, scatter_method=method)(
        torch.from_numpy(X))
    ref = jrs.connection_laplacian_op(data, N, D, scatter_method=method)(
        jnp.asarray(X))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_spectral_init_matches_up_to_gauge(inst):
    R_true, _, tdata, jR0 = inst
    R0 = rs.spectral_init(tdata, N, D, generator=_gen(), tau=1e-10,
                          max_iterations=500)
    assert R0.dtype == torch.float64 and (torch.linalg.det(R0) > 0).all()
    assert _gauge_err(R0.numpy(), jR0) <= 1e-8
    assert float(rs.mean_rotation_error(R0, torch.from_numpy(R_true))) < 0.2


@pytest.mark.parametrize("route", ["plain", "preconditioned", "flat"])
def test_tnt_routes_match_jax(inst, route):
    """The N = 24 instance built by JAX solves to the same x in both
    packages, on each route, with equal counts."""
    R_true, data, tdata, jR0 = inst
    kw = {"plain": {}, "preconditioned": dict(preconditioned=True),
          "flat": dict(flat=True)}[route]
    jres = jtnt.solve(jrs.make_problem(**kw), jnp.asarray(jR0),
                      jtnt.TNTParams(**PARAMS), data=data)
    res = tnt.solve(rs.make_problem(**kw), torch.from_numpy(jR0),
                    tnt.TNTParams(**PARAMS), data=tdata)
    k = int(res.num_iterations)
    # GRADIENT, or (preconditioned) TRUST_REGION at |grad| 1.5e-8 in both
    assert int(res.status) == int(jres.status)
    assert float(res.gradfx_norm) < 1e-7
    assert k == int(jres.num_iterations)
    np.testing.assert_array_equal(res.inner_iterations[:k].numpy(),
                                  np.asarray(jres.inner_iterations[:k]))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-8)
    assert float(rs.mean_rotation_error(res.x, torch.from_numpy(R_true))) \
        < 0.1


@pytest.mark.parametrize("rr,precondition", [("eigh", False),
                                             ("chol", True)])
def test_certify_matches_jax(inst, rr, precondition):
    _, data, tdata, jR0 = inst
    R = jtnt.solve(jrs.make_problem(), jnp.asarray(jR0),
                   jtnt.TNTParams(**PARAMS), data=data).x
    kw = dict(eta=1e-6, tau=1e-8, max_iterations=500, rr_method=rr,
              precondition=precondition)
    jc = jrs.certify(R, data, **kw)
    tc = rs.certify(torch.from_numpy(np.array(R)), tdata, generator=_gen(),
                    **kw)
    assert bool(tc.certified) == bool(jc.certified)
    assert abs(float(tc.lam_min) - float(jc.lam_min)) <= 1e-6
    assert abs(float(tc.stationarity) - float(jc.stationarity)) <= 1e-10
    assert float(tc.eta) == 1e-6 and tc.eigvec.shape == (N * D,)


def test_certify_default_eta_and_rejects_non_optimum(inst):
    _, _, tdata, _ = inst
    c = rs.certify(torch.from_numpy(_rotations(5)), tdata, generator=_gen())
    assert not bool(c.certified) and float(c.lam_min) < -float(c.eta) < 0
    assert float(c.stationarity) > 1e-2


def test_round_lifted_matches_up_to_gauge():
    """A lifted Y of (p, d) orthonormal blocks, p = 5: the SVD's signs differ
    between the packages, R agrees up to a global gauge."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(N, 5, 5)))
    Y = q[:, :, :D]
    R, gap = rs.round_lifted(torch.from_numpy(Y))
    jR, jgap = jrs.round_lifted(jnp.asarray(Y))
    assert (torch.linalg.det(R) > 0).all()
    assert abs(float(gap) - float(jgap)) <= 1e-12
    assert _gauge_err(R.numpy(), jR) <= 1e-8


def _ring_instance(seed, n=12, d=3, noise=0.3):
    """``tests/test_rotation_sync.py``'s weakly connected ring (JAX)."""
    key = jax.random.PRNGKey(seed)
    R_true, _ = jrs.random_instance(key, n, d, extra_edges=0, noise=0.0,
                                    dtype=jnp.float64)
    src = jnp.concatenate([jnp.arange(n - 1, dtype=jnp.int32),
                           jnp.array([n - 1], jnp.int32)])
    dst = jnp.concatenate([jnp.arange(1, n, dtype=jnp.int32),
                           jnp.array([0], jnp.int32)])
    w = noise * jax.random.normal(jax.random.PRNGKey(100 + seed), (n, d, d),
                                  jnp.float64)
    skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
    pert = jrs._orthonormalize(jnp.eye(d) + skew + 0.5 * (skew @ skew))
    Rij = R_true[src] @ jnp.swapaxes(R_true[dst], -1, -2)
    return jrs.RotationSyncData(src=src, dst=dst, Rij=pert @ Rij)


def test_staircase_climbs_like_jax():
    """The ring from JAX's stuck R0 (tests/test_rotation_sync.py's
    test_staircase_escapes_stuck_critical_point): the same p_final, the
    same certified flag at every level, the rounded R up to gauge."""
    n, d = 12, 3
    params = dict(PARAMS, max_iterations=200, gradient_tolerance=1e-10)
    data = _ring_instance(0)
    R0 = jrs.ROTATIONS.rand(jax.random.PRNGKey(1000), n, d, d)
    jout = jrs.solve_staircase(data, n, d, params=jtnt.TNTParams(**params),
                               R0=R0, cert_tau=1e-6)
    out = rs.solve_staircase(
        interop.rotation_sync_data_from_jax(data, device="cpu"), n, d,
        params=tnt.TNTParams(**params), R0=torch.from_numpy(np.array(R0)),
        cert_tau=1e-6, generator=_gen())
    assert out.p_final == jout.p_final > d
    assert [lv[3] for lv in out.levels] == [lv[3] for lv in jout.levels]
    assert bool(out.certified) and bool(jout.certified)
    assert out.rank_gap < 1e-6
    np.testing.assert_allclose(out.levels[0][1], jout.levels[0][1],
                               rtol=1e-10)
    np.testing.assert_allclose(float(out.result.f), float(jout.result.f),
                               rtol=1e-8)
    assert _gauge_err(out.R.numpy(), jout.R) <= 1e-6


def test_random_instance_and_fleet_shapes():
    R_true, data = rs.random_instance(_gen(1), 10, 3, extra_edges=5,
                                      noise=0.0, dtype=torch.float64)
    assert data.src.shape == (14,) and data.Rij.shape == (14, 3, 3)
    assert float(rs.chordal_cost(R_true, data)) < 1e-20
    R_trues, fleet = rs.random_fleet(_gen(2), 3, 10, 3, extra_edges=5,
                                     dtype=torch.float64)
    assert R_trues.shape == (3, 10, 3, 3) and fleet.Rij.shape == (3, 14, 3, 3)
    assert (torch.linalg.det(R_trues) > 0).all()
