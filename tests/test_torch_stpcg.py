"""The port's generic ``stpcg`` == the JAX package's, regime by regime.

Interior (exact and truncated), trust-region boundary, negative curvature,
kernel-of-H escape, SPD and constraint (KKT) preconditioning, user stop,
zero gradient: the same float64 inputs from a numpy seed go through both,
and the iteration counts must be EQUAL, the steps and scalars within rtol
1e-9 (the same recurrences; only the reduction order differs, and the
longest runs here take ~100 iterations, over which CG amplifies ulp-level
differences to ~1e-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.linalg import stpcg as jstpcg
from optimization_tpu_torch.linalg import stpcg as tstpcg

torch.set_num_threads(1)

RTOL = 1e-9

_rng = np.random.default_rng(0)
SMALL_G = np.array([21.0, -0.4, 19.0])
SMALL_P = np.array([1000.0, 100.0, 1.0])
SMALL_M = np.array([100.0, 10.0, 1.0])
LARGE_G = _rng.uniform(-1, 1, 300)
LARGE_P = 2000.0 + 1000.0 * _rng.uniform(-1, 1, 300)
LARGE_M = 2000.0 + 1000.0 * _rng.uniform(-1, 1, 300)
INDEF_P = _rng.uniform(-2.0, 5.0, 300)


def _run_both(g, P, Delta, M=None, kkt=None, **kw):
    """Run JAX and torch stpcg on H = diag(P) (+ preconditioner diag(M),
    or a KKT constraint preconditioner)."""
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    jP, tP = jnp.asarray(P), torch.from_numpy(P)
    jkw, tkw = dict(kw), dict(kw)
    if M is not None:
        jM, tM = jnp.asarray(M), torch.from_numpy(M)
        jkw["precon"] = lambda v: (v / jM, None)
        tkw["precon"] = lambda v: (v / tM, None)
    if kkt is not None:
        Minv, A, m = kkt
        jMi, tMi = jnp.asarray(Minv), torch.from_numpy(Minv)
        jA, tA = jnp.asarray(A), torch.from_numpy(A)
        n = g.shape[0]

        def jpre(r):
            z = jMi @ jnp.concatenate([r, jnp.zeros(m)])
            return z[:n], z[n:]

        def tpre(r):
            z = tMi @ torch.cat([r, torch.zeros(m, dtype=r.dtype)])
            return z[:n], z[n:]

        jkw.update(precon=jpre, At=lambda lam: jA.T @ lam)
        tkw.update(precon=tpre, At=lambda lam: tA.T @ lam)
    jr = jstpcg(jg, lambda v: jP * v, lambda u, v: jnp.dot(u, v), Delta,
                **jkw)
    tr = tstpcg(tg, lambda v: tP * v, lambda u, v: torch.dot(u, v), Delta,
                **tkw)
    return jr, tr


def _assert_same(jr, tr):
    assert int(tr.num_iterations) == int(jr.num_iterations)
    np.testing.assert_allclose(tr.s.numpy(), np.asarray(jr.s), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(float(tr.update_step_M_norm),
                               float(jr.update_step_M_norm), rtol=RTOL)
    np.testing.assert_allclose(float(tr.predicted_decrease),
                               float(jr.predicted_decrease), rtol=RTOL)


def _kkt(m=20, n=300):
    A = 1000.0 * np.random.default_rng(1).uniform(-1, 1, (m, n))
    Mc = np.zeros((n + m, n + m))
    Mc[:n, :n] = np.diag(LARGE_M)
    Mc[:n, n:] = A.T
    Mc[n:, :n] = A
    return np.linalg.inv(Mc), A, m


CASES = {
    "exact": (SMALL_G, SMALL_P, np.inf, None, None,
              dict(max_iterations=3, kappa_fgr=1e-8, theta=0.999)),
    "negative_curvature": (SMALL_G, -SMALL_P, 1000.0, None, None,
                           dict(max_iterations=3, kappa_fgr=1e-8,
                                theta=0.999)),
    "exact_preconditioned": (SMALL_G, SMALL_P, np.inf, SMALL_M, None,
                             dict(max_iterations=3, kappa_fgr=1e-8,
                                  theta=0.999)),
    "truncated": (LARGE_G, LARGE_P, 1000.0, None, None,
                  dict(max_iterations=300, kappa_fgr=0.1, theta=0.7)),
    "truncated_preconditioned": (LARGE_G, LARGE_P, 1000.0, LARGE_M, None,
                                 dict(max_iterations=300, kappa_fgr=0.1,
                                      theta=0.7)),
    "interior_tight": (LARGE_G, LARGE_P, 1e9, None, None,
                       dict(max_iterations=300, kappa_fgr=1e-6,
                            theta=0.5)),
    "boundary": (LARGE_G, LARGE_P, 1e-4, None, None,
                 dict(max_iterations=300, kappa_fgr=1e-6, theta=0.5)),
    "indefinite": (LARGE_G, INDEF_P, 2.0, None, None,
                   dict(max_iterations=500, kappa_fgr=1e-8, theta=0.999)),
    "kernel_escape": (LARGE_G, np.zeros(300), 3.0, None, None,
                      dict(max_iterations=50, kappa_fgr=1e-8, theta=0.999)),
    "projected_kkt": (LARGE_G, LARGE_P, np.inf, None, "kkt",
                      dict(max_iterations=1500, kappa_fgr=1e-8, theta=0.7)),
    "zero_gradient": (np.zeros(3), SMALL_P, 1.0, None, None,
                      dict(max_iterations=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_regime_matches_jax(case):
    g, P, Delta, M, kkt, kw = CASES[case]
    jr, tr = _run_both(g, P, Delta, M=M, kkt=_kkt() if kkt else None, **kw)
    _assert_same(jr, tr)
    if case == "kernel_escape":
        # one kernel step to the boundary, walking downhill
        assert int(tr.num_iterations) == 0
        np.testing.assert_allclose(float(torch.linalg.norm(tr.s)), 3.0,
                                   rtol=1e-12)
        assert float(torch.dot(tr.s, torch.from_numpy(g))) < 0
    if case == "zero_gradient":
        assert int(tr.num_iterations) == 0
        assert not tr.s.any()


def test_user_function_stop_matches_jax():
    kw = dict(max_iterations=300, kappa_fgr=1e-8, theta=0.999)
    jr = jstpcg(jnp.asarray(LARGE_G), lambda v: jnp.asarray(LARGE_P) * v,
                jnp.dot, 1e9, user_function=lambda k, s, r, v, p, a: k >= 4,
                **kw)
    tr = tstpcg(torch.from_numpy(LARGE_G),
                lambda v: torch.from_numpy(LARGE_P) * v, torch.dot, 1e9,
                user_function=lambda k, s, r, v, p, a: k >= 4, **kw)
    assert int(tr.num_iterations) == int(jr.num_iterations) == 4
    np.testing.assert_allclose(tr.s.numpy(), np.asarray(jr.s), rtol=RTOL)


def test_pytree_vectors():
    """Vectors may be pytrees: a dict tangent gives the flat answer."""
    g = {"a": torch.from_numpy(LARGE_G[:100]),
         "b": torch.from_numpy(LARGE_G[100:])}
    P = {"a": torch.from_numpy(LARGE_P[:100]),
         "b": torch.from_numpy(LARGE_P[100:])}
    dot = lambda u, v: sum(torch.dot(u[k], v[k]) for k in u)
    tr = tstpcg(g, lambda v: {k: P[k] * v[k] for k in v}, dot, 1000.0,
                max_iterations=300, kappa_fgr=0.1, theta=0.7)
    jr = jstpcg(jnp.asarray(LARGE_G), lambda v: jnp.asarray(LARGE_P) * v,
                jnp.dot, 1000.0, max_iterations=300, kappa_fgr=0.1,
                theta=0.7)
    assert int(tr.num_iterations) == int(jr.num_iterations)
    s = torch.cat([tr.s["a"], tr.s["b"]]).numpy()
    np.testing.assert_allclose(s, np.asarray(jr.s), rtol=RTOL)


def test_fused_dots_not_ported_yet():
    with pytest.raises(NotImplementedError, match="cg_dots.*axpy_selfdot"):
        tstpcg(torch.ones(3), lambda v: v, torch.dot, 1.0, fused_dots=True)


@pytest.mark.parametrize("kw", [dict(max_iterations=-1), dict(kappa_fgr=1.0),
                                dict(theta=1.5), dict(epsilon=0.0)],
                         ids=["max_iterations", "kappa_fgr", "theta",
                              "epsilon"])
def test_validation_messages_match(kw):
    with pytest.raises(ValueError) as je:
        jstpcg(jnp.ones(3), lambda v: v, jnp.dot, 1.0, **kw)
    with pytest.raises(ValueError) as te:
        tstpcg(torch.ones(3), lambda v: v, torch.dot, 1.0, **kw)
    assert str(te.value) == str(je.value)
