"""The port's ``parallel`` package on 4 gloo ranks == the JAX package on
its 8 fake devices.

Each case is the counterpart of a ``tests/test_parallel.py`` test.  The
inputs are the JAX tests' own (drawn with JAX's keys here, in float64) and
written to one ``inputs.npz``; ONE spawn of 4 CPU processes
(``tests/test_torch_children/parallel_rank.py``, rendezvous through a FileStore in
the module's temporary directory) runs every case and writes one
``results.npz``, while this process computes the JAX results.  A child
that fails or outlives 180 s fails the tests; they skip only when
spawning is forbidden.

Tolerances, as the JAX tests hold their sharded runs:

- scenario-sharded TNT (``batch_sharded_solve``): x within 1e-12 of JAX's
  vmapped solve, every status GRADIENT;
- block-partitioned TNT (``DTensor`` iterate, reverse-mode hvp): status
  GRADIENT, f within 1e-10 and |x| within 1e-6 of JAX's (and of the port's
  unsharded solve); two runs bitwise equal in x, f and traces;
- consensus ADMM: RESIDUAL_TOLERANCE, objective within 2% of full-data
  FISTA (JAX's);
- ``pdot`` / ``pmean_tree``, ``sharded_gram`` / ``sharded_gram_pair``,
  ``ring_gram``: within 1e-10 relative of the dense result;
- sharded-basis LOBPCG: nev converged, theta within 1e-8 of JAX's;
- the DP LOBPCG fleet: bitwise equal to the port's unsharded fleet, theta
  within 1e-8 of JAX's fleet (JAX draws other random blocks);
- five repeats of ``pdot`` / ``pnorm`` bitwise equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optimization_tpu import CompositeProblem, RiemannianProblem
from optimization_tpu.core.types import ADMMStatus, TNTStatus
from optimization_tpu.linalg.lobpcg import lobpcg, lobpcg_fleet
from optimization_tpu.manifolds import sphere
from optimization_tpu.solvers import proximal_gradient as pg
from optimization_tpu.solvers import tnt
from optimization_tpu.solvers.prox import soft_threshold

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "test_torch_children", "parallel_rank.py")
WORLD = 4
TIMEOUT = 180

PARAMS = tnt.TNTParams(
    gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
    stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)
BLOCK_PARAMS = tnt.TNTParams(
    gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
    stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0,
    max_iterations=500)


def _inputs():
    """The JAX tests' inputs, as numpy float64."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    r1, r2 = jax.random.split(jax.random.PRNGKey(3))
    rng = np.random.default_rng(21)
    N, mi, n = 8, 40, 64
    A = rng.normal(size=(N, mi, n))
    x_true = np.zeros(n)
    x_true[rng.integers(0, n, 8)] = rng.normal(size=8)
    b = A @ x_true + 0.01 * rng.normal(size=(N, mi))
    m_lob = 4096
    fleet, m_fleet = 8, 600
    arrays = dict(
        scen_Ps=sphere().rand(jax.random.PRNGKey(0), 8, 3),
        scen_x0s=jnp.tile(jnp.array([-0.5, -0.5, -0.707107]), (8, 1)),
        block_d=jnp.linspace(1.0, 100.0, 1024),
        block_x0=sphere().rand(jax.random.PRNGKey(42), 1024),
        cons_A=A, cons_b=b, cons_mu=np.float64(0.1),
        coll_u=jnp.arange(32.0), coll_v=jnp.ones(32),
        gram_S=jax.random.normal(k1, (1024, 6)),
        gram_AS=jax.random.normal(k2, (1024, 6)),
        gram_BS=jax.random.normal(k3, (1024, 6)),
        ring_S=jax.random.normal(r1, (256, 16)),
        ring_AS=jax.random.normal(r2, (256, 16)),
        lob_d=jnp.linspace(1.0, 400.0, m_lob),
        lob_X0=jax.random.normal(jax.random.PRNGKey(7), (m_lob, 8)),
        fleet_ds=(jnp.arange(1.0, fleet + 1.0)[:, None]
                  * jnp.linspace(1.0, 60.0, m_fleet)[None, :]),
        det_v=jax.random.normal(jax.random.PRNGKey(7), (4096,)),
        det_w=jax.random.normal(jax.random.PRNGKey(8), (4096,)),
    )
    return {k: np.asarray(v, dtype=np.float64) for k, v in arrays.items()}


class _Ranks:
    """The spawned ranks: started at once, waited for on first use."""

    def __init__(self, tmp):
        self.tmp, self.inputs = tmp, _inputs()
        np.savez(os.path.join(tmp, "inputs.npz"), **self.inputs)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        try:
            self.procs = [subprocess.Popen(
                [sys.executable, CHILD, tmp, str(r), str(WORLD)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env) for r in range(WORLD)]
        except OSError as e:  # the runtime forbids spawning
            pytest.skip(f"cannot spawn subprocesses: {e}")
        self._out = None

    def results(self):
        if self._out is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=TIMEOUT))
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                pytest.fail(f"the {WORLD} ranks outlived {TIMEOUT} s")
            for p, (out, err) in zip(self.procs, outs):
                assert p.returncode == 0 and "OK" in out, (
                    f"rank failed (rc={p.returncode}):\n{err[-3000:]}")
            with np.load(os.path.join(self.tmp, "results.npz")) as z:
                self._out = dict(z)
        return self._out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(str(tmp_path_factory.mktemp("torch_parallel")))
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()


def _f_sphere(x, data):
    d = x - data
    return jnp.sum(d * d)


def test_scenario_sharded_tnt_matches_jax(ranks):
    inp = ranks.inputs
    problem = RiemannianProblem(f=_f_sphere, manifold=sphere())
    ref = jax.vmap(lambda x, p: tnt.solve(problem, x, PARAMS, data=p))(
        jnp.asarray(inp["scen_x0s"]), jnp.asarray(inp["scen_Ps"]))
    out = ranks.results()
    np.testing.assert_allclose(out["scen_x"], np.asarray(ref.x), atol=1e-12)
    assert (out["scen_status"] == TNTStatus.GRADIENT).all()


def _block_reference(inp):
    problem = RiemannianProblem(f=lambda x, dd: jnp.dot(x, dd * x),
                                manifold=sphere())
    return tnt.solve(problem, jnp.asarray(inp["block_x0"]), BLOCK_PARAMS,
                     data=jnp.asarray(inp["block_d"]))


def test_block_partitioned_tnt_matches_jax(ranks):
    ref = _block_reference(ranks.inputs)
    out = ranks.results()
    assert int(out["block_status1"]) == TNTStatus.GRADIENT
    np.testing.assert_allclose(float(out["block_f1"]), float(ref.f),
                               atol=1e-10)
    np.testing.assert_allclose(np.abs(out["block_x1"]),
                               np.abs(np.asarray(ref.x)), atol=1e-6)
    # and the port's own unsharded solve
    np.testing.assert_allclose(float(out["block_f1"]),
                               float(out["block_f_plain"]), atol=1e-10)
    np.testing.assert_allclose(np.abs(out["block_x1"]),
                               np.abs(out["block_x_plain"]), atol=1e-6)


def test_block_partitioned_tnt_deterministic(ranks):
    out = ranks.results()
    for name in ("x", "f", "status", "num_iterations", "objective_values",
                 "gradient_norms", "inner_iterations"):
        np.testing.assert_array_equal(out[f"block_{name}1"],
                                      out[f"block_{name}2"])


def test_consensus_admm_lasso_matches_fista(ranks):
    inp = ranks.inputs
    A, b, mu = inp["cons_A"], inp["cons_b"], float(inp["cons_mu"])
    N, mi, n = A.shape
    Afull, bfull = jnp.asarray(A.reshape(N * mi, n)), jnp.asarray(
        b.reshape(N * mi))
    fista = CompositeProblem(
        f=lambda x, dd: 0.5 * jnp.sum((Afull @ x - bfull) ** 2),
        g=lambda x, dd: mu * N * jnp.sum(jnp.abs(x)),
        prox_g=lambda x, lam, dd: soft_threshold(x, mu * N * lam))
    ref = pg.solve(fista, jnp.zeros(n), pg.ProximalGradientParams(
        max_iterations=50000, composite_gradient_tolerance=1e-8,
        relative_composite_gradient_tolerance=1e-10))
    obj = lambda x: (0.5 * float(jnp.sum((Afull @ jnp.asarray(x) - bfull)
                                         ** 2))
                     + mu * N * float(jnp.sum(jnp.abs(jnp.asarray(x)))))
    out = ranks.results()
    assert int(out["cons_status"]) == ADMMStatus.RESIDUAL_TOLERANCE
    assert obj(out["cons_y"]) <= obj(ref.x) * 1.02 + 1e-8


def test_pdot_and_pmean_tree(ranks):
    inp = ranks.inputs
    out = ranks.results()
    np.testing.assert_allclose(float(out["coll_pdot"]),
                               float(np.dot(inp["coll_u"], inp["coll_v"])),
                               rtol=1e-14)
    np.testing.assert_allclose(float(out["coll_pmean"]),
                               float(inp["coll_u"].mean()), rtol=1e-14)


@pytest.mark.parametrize("which", ["gram", "gram_a", "gram_b"])
def test_sharded_gram_collectives(ranks, which):
    inp = ranks.inputs
    other = inp["gram_BS"] if which == "gram_b" else inp["gram_AS"]
    np.testing.assert_allclose(ranks.results()[which],
                               inp["gram_S"].T @ other, rtol=1e-10)


def test_ring_gram_matches_dense(ranks):
    inp = ranks.inputs
    np.testing.assert_allclose(ranks.results()["ring"],
                               inp["ring_S"].T @ inp["ring_AS"], rtol=1e-10)


def test_sharded_basis_lobpcg_matches_jax(ranks):
    inp = ranks.inputs
    d = jnp.asarray(inp["lob_d"])
    ref = lobpcg(lambda S: d[:, None] * S, T=lambda S: S / d[:, None],
                 X0=jnp.asarray(inp["lob_X0"]), nev=4, max_iterations=150,
                 tau=1e-8)
    out = ranks.results()
    assert int(out["lob_nc"]) == int(ref.num_converged) == 4
    np.testing.assert_allclose(out["lob_theta"], np.asarray(ref.theta),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(out["lob_theta"], out["lob_theta_plain"],
                               rtol=1e-8, atol=1e-8)


def test_dp_sharded_lobpcg_fleet_matches_unsharded(ranks):
    inp = ranks.inputs
    ds = jnp.asarray(inp["fleet_ds"])
    ref = lobpcg_fleet(lambda S, d: d[:, None] * S, ds,
                       T=lambda S, d: S / d[:, None], m=ds.shape[1], nx=8,
                       nev=3, max_iterations=60, tau=1e-8,
                       key=jax.random.PRNGKey(3))
    out = ranks.results()
    assert (out["fleet_num_converged"] >= 3).all()
    for name in ("theta", "X", "num_converged", "num_iterations"):
        np.testing.assert_array_equal(out[f"fleet_{name}"],
                                      out[f"fleet_{name}_plain"])
    np.testing.assert_allclose(out["fleet_theta"], np.asarray(ref.theta),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("which", ["pdot", "pnorm"])
def test_sharded_collectives_deterministic(ranks, which):
    inp = ranks.inputs
    reps = ranks.results()["det_" + which]
    assert len(set(reps.tolist())) == 1, reps
    v, w = inp["det_v"], inp["det_w"]
    ref = np.dot(v, w) if which == "pdot" else np.linalg.norm(v)
    np.testing.assert_allclose(reps[0], ref, rtol=1e-12)


def test_consensus_scenario_count_guard():
    """The JAX test's guards, word for word, on the port's
    ``consensus_problem`` (one process: the guard needs no mesh)."""
    import torch

    from optimization_tpu_torch.parallel import consensus

    local_argmin = lambda z, lam_i, rho, data_i: z - lam_i / rho

    problem = consensus.consensus_problem(local_argmin, n_scenarios=4)
    z = torch.zeros(3)
    lam = torch.zeros((4, 3))
    data = torch.zeros((4, 2))
    x = problem.minLx(z, lam, 1.0, data)
    assert x.shape == (4, 3)

    with pytest.raises(ValueError, match="leading axis 5"):
        problem.minLy(torch.zeros((5, 3)), torch.zeros((5, 3)), 1.0, data)

    inferred = consensus.consensus_problem(local_argmin)
    with pytest.raises(ValueError, match="scenario count is 7"):
        inferred.minLx(z, torch.zeros((4, 3)), 1.0, torch.zeros((7, 2)))

    with pytest.raises(ValueError, match="n_scenarios"):
        inferred.minLx(z, lam, 1.0, None)
