"""The port's examples (``optimization_tpu_torch/examples``) against the JAX
package on the JAX examples' own inputs, float64 on the CPU: the solver
examples here, the model examples in ``tests/test_torch_examples_models.py``.

Each test draws the JAX example's inputs with the JAX package itself (its
``jax.random.PRNGKey`` draws, numpy seeds and sizes; the example scripts
are not imported: their ``setup()`` changes JAX's global config), carries
them over with ``interop`` or numpy, calls the port's ``run(device="cpu",
data=...)`` and holds the result against the JAX package's functions on
the same inputs.  Engines that start from the same point are
deterministic: statuses and iteration counts are equal.  Where a LOBPCG
draws its own start or norm-estimate block (torch and JAX draw different
numbers), the spectral starts, certificates and staircase escapes agree
only up to convergence and gauge, and the tolerance says so.  Each test
states its tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optimization_tpu import CompositeProblem as JCompositeProblem
from optimization_tpu import RiemannianProblem as JProblem
from optimization_tpu.linalg.flat_cg import (sphere_rayleigh_flat as jflat,
                                             sphere_rayleigh_step as jstep)
from optimization_tpu.linalg.lobpcg import lobpcg as jlobpcg
from optimization_tpu.manifolds import euclidean as jeuclidean
from optimization_tpu.manifolds import sphere as jsphere
from optimization_tpu.models import matrix_completion as jmc
from optimization_tpu.solvers import admm as jadmm
from optimization_tpu.solvers import gradient_descent as jgd
from optimization_tpu.solvers import proximal_gradient as jpg
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu.solvers.prox import (group_soft_threshold as jgroup,
                                           soft_threshold as jsoft)
from optimization_tpu_torch import interop
from optimization_tpu_torch.examples import (dtype_escalation,
                                             euclidean_optimization, lasso,
                                             lobpcg_example,
                                             matrix_completion_example,
                                             riemannian_optimization)

torch.set_num_threads(1)

F64 = torch.float64
STOPS = dict(relative_decrease_tolerance=0.0, stepsize_tolerance=0.0)
TNT_STOPS = dict(preconditioned_gradient_tolerance=0.0, **STOPS)


def _t(a):
    """A JAX or numpy array as a CPU tensor (int arrays as int64)."""
    a = np.array(a)
    t = torch.from_numpy(a)
    return t.to(torch.int64) if a.dtype.kind == "i" else t


def test_riemannian_optimization_matches_jax():
    """GD and TNT on S^2 and TNT on the 4096-dim Rayleigh quotient from the
    JAX example's start: equal statuses and counts, x within 1e-10, f within
    1e-12 (the S^2 objective reaches ~1e-21) and 1e-10 relative."""
    n, tol = 4096, 1e-8
    x0 = jsphere().rand(jax.random.PRNGKey(0), n)
    out = riemannian_optimization.run("cpu", F64, data={"x0": _t(x0)})

    P = jnp.array([0.0, 0.0, 1.0])
    problem = JProblem(f=lambda x, p: jnp.sum((x - p) ** 2),
                       manifold=jsphere())
    xs = jnp.array([-0.5, -0.5, -0.707107])
    ref = {"gd_sphere": jgd.solve(problem, xs, jgd.GradientDescentParams(
        max_iterations=100000, gradient_tolerance=tol, **STOPS), data=P),
        "tnt_sphere": jtnt.solve(problem, xs, jtnt.TNTParams(
            gradient_tolerance=tol, **TNT_STOPS), data=P)}
    d = jnp.linspace(1.0, 1000.0, n)
    rq = JProblem(f=lambda x, dd: jnp.dot(x, dd * x), manifold=jsphere())
    ref["tnt_rayleigh"] = jtnt.solve(rq, x0, jtnt.TNTParams(
        max_iterations=200, gradient_tolerance=tol, **TNT_STOPS), data=d)
    for key, r in ref.items():
        got = out[key]
        assert (got["status"], got["iters"]) == (int(r.status),
                                                 int(r.num_iterations)), key
        assert abs(got["f"] - float(r.f)) <= 1e-12 + 1e-10 * abs(float(r.f))
        if "x" in got:
            np.testing.assert_allclose(got["x"], np.array(r.x), atol=1e-10)


def test_euclidean_optimization_matches_jax():
    """The 2-D Rosenbrock by GD and TNT and the chained 100-D one by TNT:
    equal statuses and counts; x within 1e-8 (GD stops at |grad| 1e-6 near
    a minimum whose Hessian has condition ~2500), |x - 1| both under
    1e-6."""
    tol = 1e-6
    out = euclidean_optimization.run("cpu", F64)
    p2 = JProblem(f=lambda x, d: (1.0 - x[0]) ** 2
                  + 100.0 * (x[1] - x[0] ** 2) ** 2, manifold=jeuclidean())
    x0 = jnp.array([-1.2, 1.0])
    ref = {"gd_2d": jgd.solve(p2, x0, jgd.GradientDescentParams(
        max_iterations=200000, gradient_tolerance=tol, **STOPS)),
        "tnt_2d": jtnt.solve(p2, x0, jtnt.TNTParams(
            max_iterations=1000, gradient_tolerance=tol, **TNT_STOPS))}
    p100 = JProblem(f=lambda x, d: jnp.sum(
        100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2),
        manifold=jeuclidean())
    ref["tnt_100d"] = jtnt.solve(p100, jnp.full((100,), -1.0), jtnt.TNTParams(
        max_iterations=2000, gradient_tolerance=tol, **TNT_STOPS))
    for key, r in ref.items():
        got = out[key]
        assert (got["status"], got["iters"]) == (int(r.status),
                                                 int(r.num_iterations)), key
        assert got["f"] < 1e-10 and float(r.f) < 1e-10
        if "x" in got:
            np.testing.assert_allclose(got["x"], np.array(r.x), atol=1e-8)
    assert out["tnt_100d"]["dist"] < 1e-6
    assert float(jnp.linalg.norm(ref["tnt_100d"].x - 1.0)) < 1e-6


def _lobpcg_start(seed, m, nx):
    """The start block JAX's ``lobpcg(key=PRNGKey(seed))`` draws."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return jax.random.normal(sub, (m, nx))


def test_lobpcg_example_matches_jax():
    """Both solves from the JAX example's start blocks: theta within 1e-9
    relative, every requested pair converged in both, iteration counts
    within 2 (the norm-estimate block behind the convergence test is each
    package's own draw)."""
    tau = 1e-6
    X0d, X0b = _lobpcg_start(0, 500, 10), _lobpcg_start(1, 100_000, 16)
    out = lobpcg_example.run("cpu", F64, data={"X0_diag": _t(X0d),
                                               "X0_big": _t(X0b)})
    diag = jnp.linspace(1.0, 500.0, 500)
    ref_d = jlobpcg(lambda S: diag[:, None] * S, m=500, nx=10, nev=5,
                    max_iterations=500, tau=tau, key=jax.random.PRNGKey(0))
    n = 100_000
    spec = jnp.linspace(1.0, 1000.0, n)

    def A_big(S):
        up = jnp.concatenate([S[1:], jnp.zeros_like(S[:1])], axis=0)
        down = jnp.concatenate([jnp.zeros_like(S[:1]), S[:-1]], axis=0)
        return spec[:, None] * S + (2.0 * S - up - down)

    ref_b = jlobpcg(A_big, T=lambda S: S / spec[:, None], m=n, nx=16, nev=4,
                    max_iterations=500, tau=tau, key=jax.random.PRNGKey(1))
    for key, r, nev in (("diag", ref_d, 5), ("big", ref_b, 4)):
        got = out[key]
        assert got["nc"] == int(r.num_converged) == nev, key
        assert abs(got["iters"] - int(r.num_iterations)) <= 2, key
        np.testing.assert_allclose(got["theta"], np.array(r.theta)[:nev],
                                   rtol=1e-9)


def _lasso_inputs():
    """The JAX example's numpy draws: the ADMM LASSO (seed 0) and the fleet
    (seed 1)."""
    m, n, nnz = 600, 2000, 60
    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n))
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x_true = np.zeros(n)
    x_true[rng.integers(0, n, nnz)] = rng.normal(size=nnz)
    b = A @ x_true + rng.normal(size=m)
    rng = np.random.default_rng(1)
    Af = rng.normal(size=(8, 128, 512)) / np.sqrt(128)
    bf = rng.normal(size=(8, 128))
    return (A, b), (Af, bf)


def test_lasso_matches_jax():
    """FISTA group LASSO, the ADMM LASSO and the FISTA fleet on the JAX
    example's inputs: equal statuses and iteration counts, F within 1e-10
    relative, the fleet's x within 1e-8 (JAX vmaps the fleet, the port
    loops it over the batch mesh's one rank)."""
    (A, b), (Af, bf) = _lasso_inputs()
    out = lasso.run("cpu", F64, data={"admm": (_t(A), _t(b)),
                                      "fleet": (_t(Af), _t(bf))})

    Ag = jnp.diag(jnp.array([1000.0, 1.0]))
    bg = jnp.array([1.0, 1.0])
    problem = JCompositeProblem(
        f=lambda x, d: jnp.sum((Ag @ x - bg) ** 2),
        g=lambda x, d: 10.0 * jnp.linalg.norm(x),
        prox_g=lambda x, lam, d: jgroup(x, 10.0 * lam))
    r = jpg.solve(problem, jnp.array([4.0, 4.0]), jpg.ProximalGradientParams(
        max_iterations=1000000, composite_gradient_tolerance=1e-4))
    got = out["fista"]
    assert (got["status"], got["iters"]) == (int(r.status),
                                             int(r.num_iterations))
    assert abs(got["f"] - float(r.f)) <= 1e-10 * abs(float(r.f))
    np.testing.assert_allclose(got["x"], np.array(r.x), atol=1e-10)

    Aj, Atb = jnp.asarray(A), jnp.asarray(A.T @ b)
    mu = 0.1 * np.abs(A.T @ b).max()
    AtA = Aj.T @ Aj
    n = A.shape[1]
    problem = jadmm.ADMMProblem(
        minLx=lambda y, lam, rho, d: jax.scipy.linalg.solve(
            AtA + rho * jnp.eye(n), Atb + rho * y - lam, assume_a="pos"),
        minLy=lambda x, lam, rho, d: jsoft(x + lam / rho, mu / rho),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    r = jadmm.solve(problem, jnp.zeros(n), jnp.zeros(n), jnp.zeros(n),
                    jadmm.ADMMParams(max_iterations=250, eps_rel=1e-4,
                                     eps_abs_pri=1e-2, eps_abs_dual=1e-2))
    assert (out["admm"]["status"], out["admm"]["iters"]) == (
        int(r.status), int(r.num_iterations))

    problem = JCompositeProblem(
        f=lambda x, d: 0.5 * jnp.sum((d[0] @ x - d[1]) ** 2),
        g=lambda x, d: 0.05 * jnp.sum(jnp.abs(x)),
        prox_g=lambda x, lam, d: jsoft(x, 0.05 * lam))
    params = jpg.ProximalGradientParams(max_iterations=5000,
                                        composite_gradient_tolerance=1e-6)
    r = jax.jit(jax.vmap(lambda x0, d: jpg.solve(problem, x0, params,
                                                 data=d)))(
        jnp.zeros((8, 512)), (jnp.asarray(Af), jnp.asarray(bf)))
    got = out["fleet"]
    assert got["statuses"] == np.array(r.status).tolist()
    assert got["iters"] == np.array(r.num_iterations).tolist()
    np.testing.assert_allclose(got["f"], np.array(r.f), rtol=1e-10)


def test_dtype_escalation_matches_jax():
    """bf16 -> f32 escalation at n = 2^16 from the JAX example's f32 start
    (its x64-off draw): both end GRADIENT under the 2e-3 tolerance (the JAX
    example's check), the bf16 stage already GRADIENT in both and the f32
    stage one outer iteration, f within 1e-5 of JAX's (the exact minimum is
    1; both march to within ~1e-5 of it).  The bf16 outer counts are not
    held: bf16 rounding in eager torch and in XLA's fused loops differs,
    and the port's march takes 84 outer iterations to JAX's 104 here
    (``ROADMAP.md`` Queue 3)."""
    n = 1 << 16
    x0 = jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32)
    x0 = x0 / jnp.linalg.norm(x0)
    out = dtype_escalation.run("cpu", data={"x0": _t(x0)})
    dtype_escalation.accept(out)

    b, M = 999.0 / (n - 1), jsphere()

    def A_elem(v):
        return (1.0 + b * jax.lax.iota(jnp.float32, n)) * v.astype(
            jnp.float32)

    def flat_qm(x, dd, aux=None):
        A0, U, B, _ = jflat(x, A_elem, rq=aux.rq if aux is not None else None)
        return A0, U, B, (aux.init if aux is not None else None)

    problem = JProblem(
        f=lambda x, dd: jnp.dot(x.astype(jnp.float32), A_elem(x)), manifold=M,
        grad=lambda x, dd: M.proj(x, (2.0 * A_elem(x)).astype(x.dtype)),
        flat_qm=flat_qm, step_eval=jstep(A_elem))
    params = jtnt.TNTParams(max_iterations=200, max_TPCG_iterations=25,
                            gradient_tolerance=2e-3, **TNT_STOPS)
    ref = jtnt.solve_escalated(problem, x0, params, data=None,
                               low_dtype=jnp.bfloat16,
                               high_dtype=jnp.float32)
    assert out["status"] == int(ref.status) == 1
    assert float(ref.gradfx_norm) <= 2e-3
    assert out["low_status"] == int(ref.stage_low.status) == 1
    assert out["high_iters"] == int(ref.stage_high.num_iterations) == 1
    assert abs(out["f"] - float(ref.f)) <= 1e-5


def test_matrix_completion_example_matches_jax():
    """The 400 x 300 rank-4 instance of the JAX example: equal status and
    outer count, f within 1e-9 relative, the relative error over all
    entries within 1e-9 (the SVD start differs from JAX's by column signs;
    TNT on the Grassmann manifold does not see them)."""
    M_true, data = jmc.random_instance(jax.random.PRNGKey(0), 400, 300, 4,
                                       frac=0.25, noise=0.01, lam=1e-8)
    out = matrix_completion_example.run("cpu", F64, data={
        "instance": (_t(M_true), interop.completion_data_from_jax(
            data, device="cpu"))})
    U0 = jmc.spectral_init(data, 4)
    res = jtnt.solve(jmc.make_problem(), U0, jtnt.TNTParams(
        max_iterations=100, gradient_tolerance=1e-9, max_TPCG_iterations=200,
        **TNT_STOPS), data=data)
    rel = float(jnp.linalg.norm(jmc.predict(res.x, data) - M_true)
                / jnp.linalg.norm(M_true))
    assert (out["status"], out["iters"]) == (int(res.status),
                                             int(res.num_iterations))
    assert abs(out["f"] - float(res.f)) <= 1e-9 * float(res.f)
    assert abs(out["rel_err"] - rel) <= 1e-9
