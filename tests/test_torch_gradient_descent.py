"""The port's gradient descent == the JAX package's ``gradient_descent.solve``.

The fixtures of ``tests/test_gradient_descent.py`` (Euclidean Rosenbrock,
Riemannian GD on S^2, ``log_iterates``, validation, the terminating user
function) run in both packages on the same float64 inputs; ``vmap``
batching is not ported.  Status, ``num_iterations``, the line-search
counts and the NaN padding must be EQUAL; x and f within rtol 1e-12; the
traces within rtol 1e-7, atol 1e-10: the two packages' autodiff gradients
differ in the last bits, and near the optimum a gradient norm is a
difference of terms ~400 |x| large in Rosenbrock's ill-conditioned valley,
so its rounding differences reach ~3e-11 absolute while it falls to 1e-6
(1617 Rosenbrock iterations leave x within ~1e-16 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import RiemannianProblem as JProblem
from optimization_tpu.manifolds import euclidean as jeuclidean
from optimization_tpu.manifolds import sphere as jsphere
from optimization_tpu.solvers import gradient_descent as jgd
from optimization_tpu_torch import RiemannianProblem as TProblem
from optimization_tpu_torch.core.debug import pad_value
from optimization_tpu_torch.core.types import GradientDescentStatus
from optimization_tpu_torch.interop import params_from_jax, result_to_numpy
from optimization_tpu_torch.manifolds import euclidean, sphere
from optimization_tpu_torch.solvers import gradient_descent as tgd

torch.set_num_threads(1)

PARAMS = jgd.GradientDescentParams(max_iterations=100000,
                                   gradient_tolerance=1e-6,
                                   relative_decrease_tolerance=0.0,
                                   stepsize_tolerance=0.0)
P = np.array([0.0, 0.0, 1.0])


def rosenbrock(x, data):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _problems(kind):
    if kind == "rosenbrock":
        return (JProblem(f=rosenbrock, manifold=jeuclidean()),
                TProblem(f=rosenbrock, manifold=euclidean()),
                np.array([0.1, 0.1]), None)
    return (JProblem(f=lambda x, d: jnp.sum((x - d) ** 2), manifold=jsphere()),
            TProblem(f=lambda x, d: torch.sum((x - d) ** 2),
                     manifold=sphere()),
            np.array([-0.5, -0.5, -0.707107]), P)


def _solve_both(kind, params, user_function=None):
    jp, tp, x0, data = _problems(kind)
    kw = {} if user_function is None else dict(user_function=user_function)
    jres = jgd.solve(jp, jnp.asarray(x0), params,
                     data=None if data is None else jnp.asarray(data), **kw)
    tres = tgd.solve(tp, torch.from_numpy(x0), params_from_jax(params),
                     data=None if data is None else torch.from_numpy(data),
                     **kw)
    return tres, jres


def _assert_results_match(tres, jres):
    t = result_to_numpy(tres)
    assert int(t.status) == int(jres.status)
    assert int(t.num_iterations) == int(jres.num_iterations)
    np.testing.assert_array_equal(t.linesearch_iterations,
                                  np.asarray(jres.linesearch_iterations))
    for name in ("x", "f"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-12, atol=1e-15, err_msg=name)
    for name in ("gradfx_norm", "objective_values", "gradient_norms",
                 "update_step_norms", "times"):
        # NaN padding must sit in the same slots (assert_allclose checks)
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-7, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("kind", ["rosenbrock", "sphere"])
def test_matches_jax(kind):
    tres, jres = _solve_both(kind, PARAMS)
    _assert_results_match(tres, jres)
    assert int(tres.status) == GradientDescentStatus.GRADIENT
    if kind == "sphere":
        np.testing.assert_allclose(float(torch.linalg.norm(tres.x)), 1.0,
                                   atol=1e-12)
        np.testing.assert_allclose(tres.x.numpy(), P, atol=1e-4)
    else:
        np.testing.assert_allclose(tres.x.numpy(), [1.0, 1.0], atol=1e-4)


def test_log_iterates_matches_jax():
    params = jgd.GradientDescentParams(max_iterations=50,
                                       gradient_tolerance=1e-6,
                                       log_iterates=True)
    tres, jres = _solve_both("rosenbrock", params)
    _assert_results_match(tres, jres)
    assert int(tres.status) == GradientDescentStatus.ITERATION_LIMIT
    np.testing.assert_allclose(tres.iterates.numpy(),
                               np.asarray(jres.iterates), rtol=1e-12)
    np.testing.assert_array_equal(tres.iterates[0].numpy(), [0.1, 0.1])


@pytest.mark.parametrize("kw", [dict(beta=1.5), dict(gradient_tolerance=-1.0),
                                dict(alpha=0.0), dict(sigma=1.0),
                                dict(max_iterations=-1)],
                         ids=["beta", "gradient_tolerance", "alpha", "sigma",
                              "max_iterations"])
def test_validation_messages_match(kw):
    with pytest.raises(ValueError) as je:
        jgd.GradientDescentParams(**kw).validate()
    with pytest.raises(ValueError) as te:
        tgd.GradientDescentParams(**kw).validate()
    assert str(te.value) == str(je.value)


def test_user_function_stops_like_jax():
    params = jgd.GradientDescentParams(max_iterations=500,
                                       gradient_tolerance=1e-10,
                                       relative_decrease_tolerance=0.0,
                                       stepsize_tolerance=0.0)
    stop = lambda k, t, x, f, grad, h, df: k >= 5
    tres, jres = _solve_both("rosenbrock", params, user_function=stop)
    _assert_results_match(tres, jres)
    assert int(tres.status) == GradientDescentStatus.USER_FUNCTION
    assert int(tres.num_iterations) == 5


@pytest.mark.parametrize("variant", ["line_search_failure", "zero_iterations",
                                     "relative_decrease", "stepsize"])
def test_stops_match_jax(variant):
    """The other statuses.  ``line_search_failure``: one trial step from
    alpha = 1 overshoots, so the solve stops at k = 0 with the iterate
    kept.  Its rejected-step entry ``update_step_norms[0]`` is the padding
    value in both packages: that slot is index ``num_iterations``, past
    the completed iterations (the ADVICE.md note on gradient_descent.py:230
    takes it for a read slot; it is not, so the port matches)."""
    params = {
        "line_search_failure": jgd.GradientDescentParams(max_ls_iterations=1),
        "zero_iterations": jgd.GradientDescentParams(max_iterations=0),
        "relative_decrease": jgd.GradientDescentParams(
            relative_decrease_tolerance=1e-2, stepsize_tolerance=0.0),
        "stepsize": jgd.GradientDescentParams(stepsize_tolerance=1e-2,
                                              relative_decrease_tolerance=0.0),
    }[variant]
    tres, jres = _solve_both("rosenbrock", params)
    _assert_results_match(tres, jres)
    want = {"line_search_failure": GradientDescentStatus.LINE_SEARCH,
            "zero_iterations": GradientDescentStatus.ITERATION_LIMIT,
            "relative_decrease": GradientDescentStatus.RELATIVE_DECREASE,
            "stepsize": GradientDescentStatus.STEPSIZE}[variant]
    assert int(tres.status) == want
    if variant == "line_search_failure":
        assert int(tres.num_iterations) == 0
        assert int(tres.linesearch_iterations[0]) == 1
        # NaN, or 0.0 under the OPTTPU_DEBUG_NANS tier, as in the JAX package
        np.testing.assert_array_equal(float(tres.update_step_norms[0]),
                                      pad_value())
        np.testing.assert_array_equal(tres.x.numpy(), [0.1, 0.1])
