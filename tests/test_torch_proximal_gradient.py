"""The port's proximal gradient == the JAX package's
``proximal_gradient.solve``.

The cases of ``tests/test_convex.py`` (FISTA on the ill-conditioned group
LASSO, ISTA reaching FISTA's optimum, the terminating ``user_function`` with
the reference callback's state, the traced line-search counts) and a dense
LASSO, on the same float64 inputs in both packages.  Status,
``num_iterations``, the line-search counts and the NaN padding must be
EQUAL; x, f, dx and the ``warm_start`` leaves within rtol 1e-10; the
objective trace within rtol 1e-10; the two composite-gradient traces within
rtol 1e-6: G = |x - y| / lam is a difference of iterates ~1e-7 |x| apart
near convergence, so last-bit differences of the two packages' gradients
(``torch.func.grad`` against ``jax.grad``) show up ~1e7 times larger in it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import CompositeProblem as JComposite
from optimization_tpu.solvers import proximal_gradient as jpg
from optimization_tpu.solvers import prox as jprox
from optimization_tpu_torch import CompositeProblem as TComposite
from optimization_tpu_torch.core.types import ProximalGradientStatus
from optimization_tpu_torch.interop import params_from_jax, result_to_numpy
from optimization_tpu_torch.solvers import proximal_gradient as tpg
from optimization_tpu_torch.solvers import prox as tprox

torch.set_num_threads(1)

X0 = np.array([4.0, 4.0])


def group_lasso(diag, mu):
    """(JAX problem, port problem): f = |A x - 1|^2, g = mu |x|_2,
    A = diag(diag) (examples/proximal_gradient_example.cpp)."""
    Aj, At = jnp.diag(jnp.asarray(diag)), torch.diag(torch.tensor(diag, dtype=torch.float64))
    bj, bt = jnp.ones(2), torch.ones(2, dtype=torch.float64)
    return (
        JComposite(f=lambda x, d: jnp.sum((Aj @ x - bj) ** 2),
                   g=lambda x, d: mu * jnp.linalg.norm(x),
                   prox_g=lambda x, lam, d: jprox.group_soft_threshold(
                       x, mu * lam)),
        TComposite(f=lambda x, d: torch.sum((At @ x - bt) ** 2),
                   g=lambda x, d: mu * torch.linalg.norm(x),
                   prox_g=lambda x, lam, d: tprox.group_soft_threshold(
                       x, mu * lam)))


def dense_lasso(m=30, n=80, seed=3, dtype=np.float64):
    """(JAX problem, port problem, x0) with data = (A, b) given to solve:
    f = 1/2 |A x - b|^2, g = mu |x|_1, gradient supplied in closed form."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(dtype)
    xt = np.where(rng.random(n) < 0.1, rng.standard_normal(n), 0.0)
    b = (A @ xt + 0.01 * rng.standard_normal(m)).astype(dtype)
    mu = 0.1
    jp = JComposite(
        f=lambda x, d: 0.5 * jnp.sum((d[0] @ x - d[1]) ** 2),
        g=lambda x, d: mu * jnp.sum(jnp.abs(x)),
        prox_g=lambda x, lam, d: jprox.soft_threshold(x, lam * mu),
        grad_f=lambda x, d: d[0].T @ (d[0] @ x - d[1]))
    tp = TComposite(
        f=lambda x, d: 0.5 * torch.sum((d[0] @ x - d[1]) ** 2),
        g=lambda x, d: mu * torch.sum(torch.abs(x)),
        prox_g=lambda x, lam, d: tprox.soft_threshold(x, lam * mu),
        grad_f=lambda x, d: d[0].T @ (d[0] @ x - d[1]))
    return jp, tp, np.zeros(n, dtype), (A, b)


def solve_both(jp, tp, x0, params, data=None, **kw):
    jd = None if data is None else tuple(jnp.asarray(a) for a in data)
    td = None if data is None else tuple(torch.from_numpy(a) for a in data)
    jres = jpg.solve(jp, jnp.asarray(x0), params, jd, **kw)
    tres = tpg.solve(tp, torch.from_numpy(x0), params_from_jax(params), td,
                     **kw)
    return jres, tres


def assert_same(jres, tres, rtol=1e-10, trace_rtol=1e-6):
    t = result_to_numpy(tres)
    assert int(t.status) == int(jres.status)
    assert int(t.num_iterations) == int(jres.num_iterations)
    np.testing.assert_array_equal(t.linesearch_iterations,
                                  np.asarray(jres.linesearch_iterations))
    for name in ("x", "f", "dx", "objective_values"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jres, name)),
                                   rtol=rtol, atol=1e-14, equal_nan=True,
                                   err_msg=name)
    for name in ("composite_gradient_norms",
                 "relative_composite_gradient_norms"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jres, name)),
                                   rtol=trace_rtol, atol=1e-12,
                                   equal_nan=True, err_msg=name)
    assert np.isnan(t.times).all() and t.times.shape == jres.times.shape
    for a, b in zip(t.warm_start, jres.warm_start):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=1e-14)
    if jres.iterates is None:
        assert t.iterates is None
    else:
        np.testing.assert_allclose(t.iterates, np.asarray(jres.iterates),
                                   rtol=rtol, atol=1e-14)


def test_fista_group_lasso():
    """test_convex.py::test_fista_group_lasso in both packages."""
    jp, tp = group_lasso([1000.0, 1.0], 10.0)
    params = jpg.ProximalGradientParams(
        max_iterations=100000, composite_gradient_tolerance=1e-4)
    jres, tres = solve_both(jp, tp, X0, params)
    assert int(tres.status) == ProximalGradientStatus.PROX_GRAD_RESIDUAL
    k = int(tres.num_iterations) - 1
    assert (float(tres.composite_gradient_norms[k]) < 1e-4
            or float(tres.relative_composite_gradient_norms[k]) < 1e-3)
    # 2348 iterations at condition number 1e6: last-bit differences of the
    # two packages' gradients grow to 2.5e-10 of x (measured); 1e-8 here
    assert_same(jres, tres, rtol=1e-8)


@pytest.mark.parametrize("mode", list(jpg.ProximalGradientMode),
                         ids=lambda m: m.value)
def test_ista_and_fista_match_jax(mode):
    """test_convex.py::test_ista_matches_fista: each mode against JAX's."""
    jp, tp = group_lasso([20.0, 1.0], 1.0)
    params = jpg.ProximalGradientParams(
        max_iterations=200000, composite_gradient_tolerance=1e-6,
        relative_composite_gradient_tolerance=1e-8, mode=mode)
    jres, tres = solve_both(jp, tp, X0, params)
    assert int(tres.status) == ProximalGradientStatus.PROX_GRAD_RESIDUAL
    assert_same(jres, tres)
    if mode == jpg.ProximalGradientMode.SIMPLE:
        # ISTA reaches FISTA's optimum, in more iterations
        fista = jpg.solve(jp, jnp.asarray(X0), dataclasses.replace(
            params, mode=jpg.ProximalGradientMode.ACCELERATED))
        assert int(tres.num_iterations) > int(fista.num_iterations)
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(fista.x),
                                   atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(), dict(adaptive_restart=False), dict(linesearch=False, L=40.0),
    dict(mode=jpg.ProximalGradientMode.SIMPLE), dict(log_iterates=True),
    dict(max_iterations=0), dict(beta=0.8, L=0.01)],
    ids=["default", "no-restart", "no-linesearch", "ista", "log-iterates",
         "zero-iterations", "beta-0.8"])
def test_dense_lasso_matches_jax(kw):
    jp, tp, x0, data = dense_lasso()
    params = jpg.ProximalGradientParams(**{**dict(
        max_iterations=400, composite_gradient_tolerance=1e-9,
        relative_composite_gradient_tolerance=1e-9), **kw})
    jres, tres = solve_both(jp, tp, x0, params, data)
    assert_same(jres, tres)


def test_autodiff_gradient_default():
    """``grad_f=None``: ``torch.func.grad`` in place of ``jax.grad``."""
    jp, tp, x0, data = dense_lasso()
    jp, tp = (dataclasses.replace(p, grad_f=None) for p in (jp, tp))
    params = jpg.ProximalGradientParams(
        max_iterations=60, composite_gradient_tolerance=1e-9,
        relative_composite_gradient_tolerance=1e-9)
    jres, tres = solve_both(jp, tp, x0, params, data)
    assert_same(jres, tres)


def test_user_function_stops_and_matches_reference_state():
    """test_convex.py::test_pg_user_function_stops_and_matches_reference_
    state: a stop at k == K leaves the iterate where a K-iteration solve
    leaves it, sets USER_FUNCTION, counts K + 1 iterations; the predicate
    sees the reference callback's per-iteration state, which must equal
    the traces and what the JAX run records."""
    jp, tp = group_lasso([1000.0, 1.0], 10.0)
    params = jpg.ProximalGradientParams(
        max_iterations=50, composite_gradient_tolerance=1e-12,
        relative_composite_gradient_tolerance=1e-14)
    K = 5
    seen = []

    def user_fn(k, x, F, G, ls_iters, dx, dF):
        if isinstance(x, torch.Tensor):
            seen.append((int(k), x.numpy().copy(), float(F), float(G),
                         int(ls_iters), dx.numpy().copy(), float(dF)))
        return k == K

    jres, tres = solve_both(jp, tp, X0, params, user_function=user_fn)
    assert int(tres.status) == ProximalGradientStatus.USER_FUNCTION
    assert int(tres.num_iterations) == K + 1
    assert_same(jres, tres)

    res_K = tpg.solve(tp, torch.from_numpy(X0), params_from_jax(
        dataclasses.replace(params, max_iterations=K, log_iterates=True)))
    np.testing.assert_array_equal(tres.x.numpy(), res_K.x.numpy())
    it = res_K.iterates.numpy()
    np.testing.assert_allclose(tres.dx.numpy(), res_K.x.numpy() - it[K - 1],
                               rtol=1e-12, atol=1e-12)
    # the callback's state, iteration by iteration
    assert [s[0] for s in seen] == list(range(K + 1))
    t = result_to_numpy(tres)
    xs = np.concatenate([it, res_K.x.numpy()[None]])   # x_{k-1} at k
    for k, x, F, G, ls, dx, dF in seen:
        np.testing.assert_allclose(x, xs[k], rtol=1e-12)
        assert F == t.objective_values[k]
        assert G == t.composite_gradient_norms[k]
        assert ls == t.linesearch_iterations[k]
        if k < K:
            np.testing.assert_allclose(dx, xs[k + 1] - xs[k], rtol=1e-9,
                                       atol=1e-15)
            np.testing.assert_allclose(
                dF, t.objective_values[k] - t.objective_values[k + 1],
                rtol=1e-9, atol=1e-15)


def test_linesearch_iterations_traced():
    """test_convex.py::test_pg_linesearch_iterations_traced: an optimistic
    L makes the backtracking count nonzero, equal to JAX's per iteration;
    without line search the counts are zero."""
    jp, tp = group_lasso([1000.0, 1.0], 10.0)
    params = jpg.ProximalGradientParams(
        max_iterations=30, L=1e-4, composite_gradient_tolerance=1e-12,
        relative_composite_gradient_tolerance=1e-14)
    jres, tres = solve_both(jp, tp, X0, params)
    k = int(tres.num_iterations)
    assert int(tres.linesearch_iterations[:k].max()) > 0
    assert_same(jres, tres)
    jres, tres = solve_both(jp, tp, X0, dataclasses.replace(
        params, L=4e6, linesearch=False))
    assert not tres.linesearch_iterations.any()
    assert_same(jres, tres)


def test_linesearch_failure_keeps_the_iterate():
    """max_LS_iterations too small for the optimistic L: status LINESEARCH,
    x stays x0, but lam has shrunk and the iteration counts."""
    jp, tp = group_lasso([1000.0, 1.0], 10.0)
    params = jpg.ProximalGradientParams(max_iterations=30, L=1e-4,
                                        max_LS_iterations=3)
    jres, tres = solve_both(jp, tp, X0, params)
    assert int(tres.status) == ProximalGradientStatus.LINESEARCH
    assert int(tres.num_iterations) == 1
    np.testing.assert_array_equal(tres.x.numpy(), X0)
    assert float(tres.warm_start[3]) == 1e4 * 0.5 ** 4
    assert_same(jres, tres)


def test_warm_start_resumes_the_momentum():
    """Two solves joined by ``warm_start`` equal one, in both packages."""
    jp, tp, x0, data = dense_lasso()
    params = jpg.ProximalGradientParams(
        max_iterations=40, composite_gradient_tolerance=1e-12,
        relative_composite_gradient_tolerance=1e-12)
    half = dataclasses.replace(params, max_iterations=17)
    rest = dataclasses.replace(params, max_iterations=23)
    td = tuple(torch.from_numpy(a) for a in data)
    mono = tpg.solve(tp, torch.from_numpy(x0), params_from_jax(params), td)
    a = tpg.solve(tp, torch.from_numpy(x0), params_from_jax(half), td)
    b = tpg.solve(tp, a.x, params_from_jax(rest), td,
                  warm_start=a.warm_start)
    assert torch.equal(b.x, mono.x)
    assert torch.equal(b.objective_values,
                       mono.objective_values[17:])
    jd = tuple(jnp.asarray(a) for a in data)
    ja = jpg.solve(jp, jnp.asarray(x0), half, jd)
    jb = jpg.solve(jp, ja.x, rest, jd, warm_start=ja.warm_start)
    assert_same(jb, b)


def test_float32_traces_and_dtype():
    """f32 data: every result leaf is f32 (int32 counts), the statuses and
    iteration counts equal JAX's, x within 1e-5 (the slack of the
    backtracking test, 10 eps (|F| + |f|), is the f32 one in both)."""
    jp, tp, x0, data = dense_lasso(dtype=np.float32)
    params = jpg.ProximalGradientParams(
        max_iterations=300, composite_gradient_tolerance=1e-3,
        relative_composite_gradient_tolerance=1e-6)
    jres, tres = solve_both(jp, tp, x0, params, data)
    assert tres.x.dtype == tres.f.dtype == torch.float32
    assert tres.objective_values.dtype == torch.float32
    assert tres.linesearch_iterations.dtype == torch.int32
    assert int(tres.status) == int(jres.status) == \
        ProximalGradientStatus.PROX_GRAD_RESIDUAL
    assert abs(int(tres.num_iterations) - int(jres.num_iterations)) <= 2
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-4)


def test_validate_messages():
    for kw, msg in ((dict(L=0.0), "Lipschitz"), (dict(beta=1.0), "beta"),
                    (dict(max_iterations=-1), "max_iterations")):
        with pytest.raises(ValueError, match=msg) as ti:
            tpg.ProximalGradientParams(**kw).validate()
        with pytest.raises(ValueError) as ji:
            jpg.ProximalGradientParams(**kw).validate()
        assert str(ti.value) == str(ji.value)
    jf = {f.name: f.default for f in dataclasses.fields(
        jpg.ProximalGradientParams) if f.name != "mode"}
    tf = {f.name: f.default for f in dataclasses.fields(
        tpg.ProximalGradientParams) if f.name != "mode"}
    assert jf == tf
    assert tpg.ProximalGradientParams().mode.value == \
        jpg.ProximalGradientParams().mode.value
