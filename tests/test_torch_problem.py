"""The port's ``RiemannianProblem`` derivatives == the JAX autodiff values.

The same objective, written once in jnp and once in torch, on the same
float64 inputs: ``rgrad`` (``torch.func.grad`` vs ``jax.grad``, pushed
through the manifold) and ``hvp``/``qm`` (``torch.func.jvp`` of the
gradient field vs ``jax.jvp``/``jax.linearize``, then projection) agree to
rtol 1e-12 — both are exact derivatives of one formula, so only rounding
order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import RiemannianProblem as JProblem
from optimization_tpu.manifolds import euclidean as jeuclidean
from optimization_tpu.manifolds import sphere as jsphere
from optimization_tpu_torch import RiemannianProblem as TProblem
from optimization_tpu_torch.manifolds import euclidean, sphere

torch.set_num_threads(1)

RTOL = 1e-12
N = 12
_rng = np.random.default_rng(0)
_Am = _rng.normal(size=(N, N))
A = _Am + _Am.T
D = _rng.normal(size=N)


def f_j(x, data):
    return x @ (data["A"] @ x) + jnp.sum(jnp.sin(x) * data["d"]) \
        + 0.25 * jnp.sum(x ** 4)


def f_t(x, data):
    return x @ (data["A"] @ x) + torch.sum(torch.sin(x) * data["d"]) \
        + 0.25 * torch.sum(x ** 4)


def _setup(seed, manifold):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N)
    if manifold == "sphere":
        x /= np.linalg.norm(x)
    v = rng.normal(size=N)
    jm, tm = ((jsphere(), sphere()) if manifold == "sphere"
              else (jeuclidean(), euclidean()))
    jdata = {"A": jnp.asarray(A), "d": jnp.asarray(D)}
    tdata = {"A": torch.from_numpy(A), "d": torch.from_numpy(D)}
    jp = JProblem(f=f_j, manifold=jm)
    tp = TProblem(f=f_t, manifold=tm)
    return (jp, jnp.asarray(x), jnp.asarray(v), jdata,
            tp, torch.from_numpy(x), torch.from_numpy(v), tdata)


@pytest.mark.parametrize("manifold", ["sphere", "euclidean"])
def test_value_and_rgrad_match_jax(manifold):
    jp, jx, jv, jd, tp, tx, tv, td = _setup(1, manifold)
    np.testing.assert_allclose(float(tp.value(tx, td)),
                               float(jp.value(jx, jd)), rtol=RTOL)
    np.testing.assert_allclose(tp.rgrad(tx, td).numpy(),
                               np.asarray(jp.rgrad(jx, jd)), rtol=RTOL,
                               atol=1e-13)


@pytest.mark.parametrize("manifold", ["sphere", "euclidean"])
def test_hvp_matches_jax(manifold):
    jp, jx, jv, jd, tp, tx, tv, td = _setup(2, manifold)
    if manifold == "sphere":       # a tangent direction
        jv = jsphere().proj(jx, jv)
        tv = sphere().proj(tx, tv)
    np.testing.assert_allclose(tp.hvp(tx, tv, td).numpy(),
                               np.asarray(jp.hvp(jx, jv, jd)), rtol=RTOL,
                               atol=1e-12)


def test_qm_matches_jax():
    jp, jx, jv, jd, tp, tx, tv, td = _setup(3, "sphere")
    jv = jsphere().proj(jx, jv)
    tv = sphere().proj(tx, tv)
    jg, jH = jp.qm(jx, jd)
    tg, tH = tp.qm(tx, td)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-13)
    np.testing.assert_allclose(tH(tv).numpy(), np.asarray(jH(jv)),
                               rtol=RTOL, atol=1e-12)


def test_overrides_take_priority():
    calls = []

    def grad(x, d):
        calls.append("grad")
        return 2 * x

    def hess_vec(x, v, d):
        calls.append("hess")
        return 3 * v

    tp = TProblem(f=f_t, manifold=euclidean(), grad=grad, hess_vec=hess_vec,
                  precon=lambda x, v, d: v / 2)
    x = torch.ones(3, dtype=torch.float64)
    assert torch.equal(tp.rgrad(x), 2 * x)
    assert torch.equal(tp.hvp(x, x), 3 * x)
    g, H = tp.qm(x)
    assert torch.equal(g, 2 * x) and torch.equal(H(x), 3 * x)
    assert torch.equal(tp.apply_precon(x, x), x / 2)
    assert calls == ["grad", "hess", "grad", "hess"]
    assert TProblem(f=f_t).apply_precon(x, x) is x


def test_quadratic_model_seam():
    model = (torch.zeros(2), lambda v: v)
    tp = TProblem(f=f_t, quadratic_model=lambda x, d: model)
    assert tp.qm(torch.ones(2)) is model


def test_composite_problem_matches_jax():
    """``CompositeProblem``: value_f / value_g / value / prox, and the
    gradient of f by autodiff (``torch.func.grad`` against ``jax.grad``)
    or from ``grad_f``."""
    from optimization_tpu import CompositeProblem as JComposite
    from optimization_tpu_torch import CompositeProblem as TComposite

    rng = np.random.default_rng(4)
    A, b, x = rng.normal(size=(5, 3)), rng.normal(size=5), rng.normal(size=3)
    jp = JComposite(f=lambda x, d: 0.5 * jnp.sum((d @ x - b) ** 2),
                    g=lambda x, d: 0.3 * jnp.sum(jnp.abs(x)),
                    prox_g=lambda x, lam, d: x / (1.0 + lam))
    tb = torch.from_numpy(b)
    tp = TComposite(f=lambda x, d: 0.5 * torch.sum((d @ x - tb) ** 2),
                    g=lambda x, d: 0.3 * torch.sum(torch.abs(x)),
                    prox_g=lambda x, lam, d: x / (1.0 + lam))
    jx, jA, tx, tA = jnp.asarray(x), jnp.asarray(A), torch.from_numpy(x), \
        torch.from_numpy(A)
    for name in ("value_f", "value_g", "value"):
        np.testing.assert_allclose(float(getattr(tp, name)(tx, tA)),
                                   float(getattr(jp, name)(jx, jA)),
                                   rtol=1e-14)
    np.testing.assert_allclose(tp.gradient_f(tx, tA).numpy(),
                               np.asarray(jp.gradient_f(jx, jA)), rtol=1e-12)
    np.testing.assert_allclose(tp.prox(tx, 0.5, tA).numpy(),
                               np.asarray(jp.prox(jx, 0.5, jA)), rtol=1e-15)
    import dataclasses
    tq = dataclasses.replace(tp, grad_f=lambda x, d: torch.full_like(x, 7.0))
    assert torch.equal(tq.gradient_f(tx, tA), torch.full_like(tx, 7.0))
    assert [f.name for f in dataclasses.fields(tp)] == \
        [f.name for f in dataclasses.fields(jp)]
