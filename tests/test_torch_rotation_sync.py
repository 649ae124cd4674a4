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
(no LOBPCG in it) within 1e-10.  ``solve_robust`` (GNC) from one spectral
start: R within 1e-6 up to gauge, the weights
within 1e-6, the same rejected edges.  On a graph whose hub takes half
the edges, the connection Laplacian (every ``scatter_method``), the Jacobi
preconditioner (the degree) and the lifted problem's gradient and Hessian-
vector product match JAX within 1e-12 through both branches of
``graph._scatter_add`` (``test_torch_graph.branch``).
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
from test_torch_graph import branch  # noqa: F401  (a fixture)

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


@pytest.fixture(scope="module")
def hub():
    """(JAX data, port data) of a graph whose vertex 0 takes half the edges
    (self-loops and parallel edges kept), random measurements, weights."""
    rng = np.random.default_rng(21)
    E = 4 * N
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst[: E // 2] = 0
    data = jrs.RotationSyncData(
        src=jnp.asarray(src, jnp.int32), dst=jnp.asarray(dst, jnp.int32),
        Rij=jnp.asarray(_rotations(22, E)),
        kappa=jnp.asarray(rng.uniform(0.5, 2.0, E)))
    return data, interop.rotation_sync_data_from_jax(data, device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_connection_laplacian_matches_on_a_hub_graph(hub, branch, method):
    data, tdata = hub
    X = np.random.default_rng(23).normal(size=(N * D, 4))
    out = rs.connection_laplacian_op(tdata, N, D, scatter_method=method)(
        torch.from_numpy(X))
    ref = jrs.connection_laplacian_op(data, N, D, scatter_method=method)(
        jnp.asarray(X))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_jacobi_precon_matches_on_a_hub_graph(hub, branch):
    data, tdata = hub
    R = _rotations(24)
    V = np.random.default_rng(25).normal(size=R.shape)
    np.testing.assert_allclose(
        rs.jacobi_precon(torch.from_numpy(R), torch.from_numpy(V),
                         tdata).numpy(),
        np.asarray(jrs.jacobi_precon(jnp.asarray(R), jnp.asarray(V), data)),
        rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("graph", ["instance", "hub"])
def test_lifted_problem_gradient_and_hvp_match(inst, hub, branch, graph):
    """The staircase's rank-p problem (p = d + 1): its Riemannian gradient
    and the jvp of it (the hvp TNT takes) through the connection
    Laplacian's default scatter."""
    data, tdata = (inst[1], inst[2]) if graph == "instance" else hub
    rng = np.random.default_rng(26)
    Y, _ = np.linalg.qr(rng.normal(size=(N, D + 1, D)))
    W = rng.normal(size=Y.shape)
    W = W - Y @ (0.5 * (np.swapaxes(Y, -1, -2) @ W
                        + np.swapaxes(W, -1, -2) @ Y))
    tp, jp = rs._lifted_problem(N, D), jrs._lifted_problem(N, D)
    g = tp.rgrad(torch.from_numpy(Y), tdata)
    hv = tp.hvp(torch.from_numpy(Y), torch.from_numpy(W), tdata)
    jg = jp.rgrad(jnp.asarray(Y), data)
    jhv = jp.hvp(jnp.asarray(Y), jnp.asarray(W), data)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-11)
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=1e-12,
                               atol=1e-11)


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


def test_solve_robust_matches_jax(monkeypatch):
    """``tests/test_rotation_sync.py::test_robust_gnc_rejects_outliers``'s
    instance (N = 24, 20 % of the edges random rotations): both packages
    from one spectral start (the GNC scale is the median residual of the
    start).  R within 1e-6 up to gauge, the
    weights within 1e-6, the same rejected edges and identifiability, and
    that test's gates."""
    from test_torch_pose_sync import same_spectral_start

    same_spectral_start(monkeypatch)
    R_true, data = jrs.random_instance(jax.random.PRNGKey(13), N, D,
                                       extra_edges=2 * N, noise=0.02,
                                       dtype=jnp.float64)
    E = int(data.src.shape[0])
    n_out = E // 5
    k1, k2 = jax.random.split(jax.random.PRNGKey(99))
    out_idx = np.asarray(jax.random.choice(k1, E, (n_out,), replace=False))
    bad = jrs.ROTATIONS.rand(k2, n_out, D, D).astype(jnp.float64)
    cdata = data._replace(Rij=data.Rij.at[out_idx].set(bad))
    params = dict(PARAMS, max_iterations=50)
    # three GNC stages (of the default six) bound the JAX run's compile
    # time; the gates hold at three
    jrob = jrs.solve_robust(cdata, N, D, params=jtnt.TNTParams(**params),
                            gnc_steps=3)
    rob = rs.solve_robust(
        interop.rotation_sync_data_from_jax(cdata, device="cpu"), N, D,
        params=tnt.TNTParams(**params), gnc_steps=3, generator=_gen())
    assert isinstance(rob, rs.RobustResult)
    assert _gauge_err(rob.R.numpy(), jrob.R) <= 1e-6
    w, jw = rob.weights.numpy(), np.asarray(jrob.weights)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(w < 0.02 * float(rs._median(rob.weights)),
                                  jw < 0.02 * np.median(jw))
    np.testing.assert_array_equal(rob.identifiable.numpy(),
                                  np.asarray(jrob.identifiable))
    assert bool(rob.all_identifiable)
    assert float(rs.mean_rotation_error(rob.R, torch.from_numpy(
        np.array(R_true)))) < 0.05
    inlier = np.ones(E, bool)
    inlier[out_idx] = False
    assert np.median(w[~inlier]) < 0.1 * np.median(w[inlier])


def test_spectral_init_rank_deficient_block_is_a_rotation(monkeypatch):
    """A vertex whose eigenvector block has lower rank (on a long chain in
    f32 LOBPCG can leave one): JAX's eigh polar factor is NaN there (a
    fault of the reference, ROADMAP Queue 3); the port takes the SVD's
    polar factor for that block and leaves every other block as JAX's."""
    import importlib

    L = importlib.import_module("optimization_tpu_torch.linalg.lobpcg")
    n, d = 6, 3
    X = torch.from_numpy(np.random.default_rng(2).normal(size=(n * d, d)))
    X[3 * d:4 * d] = torch.outer(torch.tensor([1.0, 2.0, 3.0]),
                                 torch.tensor([0.5, -1.0, 2.0]))   # rank 1
    monkeypatch.setattr(L, "lobpcg", lambda *a, **k: L.LOBPCGResult(
        theta=None, X=X, num_iterations=None, num_converged=None,
        residual_norms=None))
    _, data = rs.random_instance(torch.Generator().manual_seed(1), n, d,
                                 dtype=torch.float64, device="cpu")
    R = rs.spectral_init(data, n, d, generator=torch.Generator())
    assert bool(torch.isfinite(R).all())
    eye = torch.eye(d, dtype=R.dtype)
    np.testing.assert_allclose((R[3].mT @ R[3]).numpy(), eye.numpy(),
                               atol=1e-12)
    assert float(torch.linalg.det(R[3])) > 0
    ref = np.asarray(jrs._orthonormalize(jnp.asarray(X.numpy().reshape(
        n, d, d))))
    assert np.isnan(ref[3]).any()
    keep = [0, 1, 2, 4, 5]
    ref = ref[keep]
    ref[..., 0] *= np.where(np.linalg.det(ref) < 0, -1.0, 1.0)[:, None]
    np.testing.assert_allclose(R.numpy()[keep], ref, atol=1e-12)
