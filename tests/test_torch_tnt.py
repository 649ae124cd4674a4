"""The port's TNT == the JAX package's ``tnt.solve``, branch by branch.

All three subproblem branches run on the same float64 problems on both
sides: generic STPCG (sphere and Euclidean, with and without a
preconditioner), the flat engine through ``flat_qm`` (with the
``step_eval`` aux carry and init threading), and a ``flat_solve`` engine.
Status, ``num_iterations``, f, x and every trace (NaN padding included)
must match; values within rtol 1e-9 (the same recurrences; reduction order
differs), or 1e-7 where a test says why.  Solves stop before the objective
reaches its rounding floor, where the gain ratio df/dm is a quotient of
cancelled differences and carries no comparable digits.

Also here: the elementwise preconditioner ``flat_prec`` (through the flat
engine and through ``flat_solve`` with the streamed kernel's plain
version, against the JAX package's preconditioned solves), and dtype
escalation (``solve_escalated``): f32 -> f64 against JAX to equal switch
and stage counts, bf16 -> f32 to the JAX test's own contract (bf16 rounds
in other places in the two frameworks, so its trajectory is not compared
iterate for iterate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu import RiemannianProblem as JProblem
from optimization_tpu.linalg import flat_cg as jflat
from optimization_tpu.manifolds import euclidean as jeuclidean
from optimization_tpu.manifolds import sphere as jsphere
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import RiemannianProblem as TProblem
from optimization_tpu_torch import headline
from optimization_tpu_torch.core.types import TNTStatus
from optimization_tpu_torch.interop import params_from_jax, result_to_numpy
from optimization_tpu_torch.linalg import flat_cg as tflat
from optimization_tpu_torch.manifolds import euclidean, sphere
from optimization_tpu_torch.solvers import tnt as ttnt

torch.set_num_threads(1)

RTOL = 1e-9
P = np.array([0.0, 0.0, 1.0])
X0 = np.array([-0.5, -0.5, -0.707107])
PARAMS = jtnt.TNTParams(gradient_tolerance=1e-8,
                        relative_decrease_tolerance=0.0,
                        stepsize_tolerance=0.0,
                        preconditioned_gradient_tolerance=0.0)


def _assert_results_match(tres, jres, rtol=RTOL):
    t = result_to_numpy(tres)
    assert int(t.status) == int(jres.status)
    assert int(t.num_iterations) == int(jres.num_iterations)
    for name in ("x", "f", "gradfx_norm", "preconditioned_grad_f_x_norm",
                 "objective_values", "gradient_norms",
                 "preconditioned_gradient_norms", "trust_region_radius",
                 "update_step_norms", "update_step_M_norms", "gain_ratios",
                 "times"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jres, name)),
                                   rtol=rtol, atol=1e-14, err_msg=name)
    np.testing.assert_array_equal(t.inner_iterations,
                                  np.asarray(jres.inner_iterations))


def _sphere_problems(**kw):
    jf = lambda x, d: jnp.sum((x - d) ** 2)
    tf = lambda x, d: torch.sum((x - d) ** 2)
    return (JProblem(f=jf, manifold=jsphere(), **kw.get("j", {})),
            TProblem(f=tf, manifold=sphere(), **kw.get("t", {})))


def test_generic_sphere_matches_jax():
    jp, tp = _sphere_problems()
    jres = jtnt.solve(jp, jnp.asarray(X0), PARAMS, data=jnp.asarray(P))
    tres = ttnt.solve(tp, torch.from_numpy(X0), params_from_jax(PARAMS),
                      data=torch.from_numpy(P))
    _assert_results_match(tres, jres)
    assert int(tres.status) == TNTStatus.GRADIENT


def test_generic_preconditioned_matches_jax():
    D = np.array([1.0, 2.0, 3.0])
    jD, tD = jnp.asarray(D), torch.from_numpy(D)
    jp, tp = _sphere_problems(j=dict(precon=lambda x, v, d: jD * v),
                              t=dict(precon=lambda x, v, d: tD * v))
    jres = jtnt.solve(jp, jnp.asarray(X0), PARAMS, data=jnp.asarray(P))
    tres = ttnt.solve(tp, torch.from_numpy(X0), params_from_jax(PARAMS),
                      data=torch.from_numpy(P))
    _assert_results_match(tres, jres)


def test_generic_euclidean_rosenbrock_matches_jax():
    def jf(x, d):
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    def tf(x, d):
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    params = jtnt.TNTParams(max_iterations=200, gradient_tolerance=1e-8,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0)
    x0 = np.array([-1.2, 1.0])
    jres = jtnt.solve(JProblem(f=jf, manifold=jeuclidean()),
                      jnp.asarray(x0), params)
    tres = ttnt.solve(TProblem(f=tf, manifold=euclidean()),
                      torch.from_numpy(x0), params_from_jax(params))
    # ~30 outer steps through a curved valley: rounding-order differences
    # reach ~1e-8 relative in late traces
    _assert_results_match(tres, jres, rtol=1e-7)
    np.testing.assert_allclose(tres.x.numpy(), [1.0, 1.0], atol=1e-6)


def test_user_function_matches_jax():
    jp, tp = _sphere_problems()
    stop = lambda k, x, f, g, Delta, ii, h, df, rho, acc: k >= 2
    jres = jtnt.solve(jp, jnp.asarray(X0), PARAMS, data=jnp.asarray(P),
                      user_function=stop)
    tres = ttnt.solve(tp, torch.from_numpy(X0), params_from_jax(PARAMS),
                      data=torch.from_numpy(P), user_function=stop)
    _assert_results_match(tres, jres)
    assert int(tres.status) == TNTStatus.USER_FUNCTION


@pytest.mark.parametrize("variant", ["Delta0", "floor_acceptance",
                                     "log_iterates", "zero_iterations"])
def test_options_match_jax(variant):
    jp, tp = _sphere_problems()
    params, kw = PARAMS, {}
    if variant == "Delta0":
        kw = dict(Delta0=0.05)
    elif variant == "floor_acceptance":
        params = jtnt.TNTParams(gradient_tolerance=0.0, max_iterations=40,
                                relative_decrease_tolerance=0.0,
                                stepsize_tolerance=0.0,
                                preconditioned_gradient_tolerance=0.0,
                                floor_acceptance=True)
    elif variant == "log_iterates":
        params = jtnt.TNTParams(**{**PARAMS.__dict__, "log_iterates": True})
    else:
        params = jtnt.TNTParams(**{**PARAMS.__dict__, "max_iterations": 0})
    jres = jtnt.solve(jp, jnp.asarray(X0), params, data=jnp.asarray(P),
                      **kw)
    tres = ttnt.solve(tp, torch.from_numpy(X0), params_from_jax(params),
                      data=torch.from_numpy(P), **kw)
    _assert_results_match(tres, jres)
    if variant == "log_iterates":
        n = int(tres.num_iterations)
        np.testing.assert_allclose(tres.iterates[: n + 1].numpy(),
                                   np.asarray(jres.iterates)[: n + 1],
                                   rtol=RTOL, atol=1e-14)


def test_zero_hessian_start_walks_downhill():
    """At x0 = e1 with target e3 the Riemannian Hessian vanishes: the
    kernel escape must walk downhill, as in the JAX package."""
    jp, tp = _sphere_problems()
    x0 = np.array([1.0, 0.0, 0.0])
    params = jtnt.TNTParams(max_iterations=100, gradient_tolerance=1e-8,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0)
    jres = jtnt.solve(jp, jnp.asarray(x0), params, data=jnp.asarray(P))
    tres = ttnt.solve(tp, torch.from_numpy(x0), params_from_jax(params),
                      data=torch.from_numpy(P))
    _assert_results_match(tres, jres)
    np.testing.assert_allclose(tres.x.numpy(), P, atol=1e-6)


STEPS = [(0.5, 1.0), (0.95, 1.0), (0.01, 1.0), (np.nan, 1.0), (2.0, -1.0),
         (0.5, 0.0)]


@pytest.mark.parametrize("rho,dm", STEPS)
def test_step_decision_matches_jax(rho, dm):
    t = ttnt.step_decision(torch.tensor(rho), torch.tensor(dm), 0.05, 0.9)
    j = jtnt.step_decision(jnp.asarray(rho), jnp.asarray(dm), 0.05, 0.9)
    assert [bool(v) for v in t] == [bool(v) for v in j]


def _rayleigh(n=300, seed=0, engine="flat_qm"):
    """The Rayleigh quotient on S^(n-1) with a random positive diagonal,
    built the bench.py way in both packages (f64)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 30.0, n)
    x0 = rng.normal(size=n)
    x0 /= np.linalg.norm(x0)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    out = []
    for pkg, M, dd, flat, dot in (
            ("j", jsphere(), jd, jflat, jnp.dot),
            ("t", sphere(), td, tflat, torch.dot)):
        A_elem = (lambda dd: lambda v: dd * v)(dd)
        f = (lambda A_elem, dot: lambda x, _: dot(x, A_elem(x)))(A_elem, dot)
        grad = (lambda M, A_elem: lambda x, _: M.proj(x, 2.0 * A_elem(x)))(
            M, A_elem)

        def flat_qm(x, _, aux=None, flat=flat, A_elem=A_elem):
            rq = aux.rq if aux is not None else None
            A0, U, B, _ = flat.sphere_rayleigh_flat(x, A_elem, rq=rq)
            return A0, U, B, (aux.init if aux is not None else None)

        def flat_solve(g, x, _, aux, Delta, params, flat=flat,
                       A_elem=A_elem):
            A0, U, B, _ = flat.sphere_rayleigh_flat(x, A_elem, rq=aux.rq)
            return flat.stpcg_flat(g, A0, U, B, Delta, init=aux.init,
                                   max_iterations=params.max_TPCG_iterations,
                                   kappa_fgr=params.kappa_fgr,
                                   theta=params.theta, body_kind="pair")

        kw = dict(f=f, manifold=M, grad=grad)
        if engine != "generic":
            kw.update(flat_qm=flat_qm,
                      step_eval=flat.sphere_rayleigh_step(A_elem))
        if engine == "flat_solve":
            kw.update(flat_solve=flat_solve)
        out.append((JProblem if pkg == "j" else TProblem)(**kw))
    return out[0], out[1], jnp.asarray(x0), torch.from_numpy(x0)


@pytest.mark.parametrize("engine", ["generic", "flat_qm", "flat_solve"])
def test_rayleigh_branches_match_jax(engine):
    jp, tp, jx0, tx0 = _rayleigh(engine=engine)
    # |grad| 1e-5 stops before f reaches its rounding floor (module doc)
    params = jtnt.TNTParams(max_iterations=25, max_TPCG_iterations=50,
                            gradient_tolerance=1e-5,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0)
    jres = jtnt.solve(jp, jx0, params)
    tres = ttnt.solve(tp, tx0, params_from_jax(params))
    # 25 outer x up to 50 CG steps: ulp differences grow to ~1e-8 in the
    # late traces of an ill-conditioned (kappa = 30) subproblem sequence
    _assert_results_match(tres, jres, rtol=1e-7)
    assert float(tres.f) < 2.0 * 1.0 + 1e-6


def test_unported_options_raise():
    """The s-step flat engine is ported: TNT on a flat_qm problem with
    flat_s_steps=2 runs it and matches JAX's run (the init group the
    step evaluator carries is dropped for it, as in JAX); the pair-engine
    option flat_kernel_check=False still raises beside it."""
    jp, tp, jx0, tx0 = _rayleigh(engine="flat_qm")
    params = jtnt.TNTParams(max_iterations=10, max_TPCG_iterations=50,
                            gradient_tolerance=1e-5,
                            relative_decrease_tolerance=0.0,
                            stepsize_tolerance=0.0,
                            preconditioned_gradient_tolerance=0.0,
                            flat_s_steps=2)
    _assert_results_match(ttnt.solve(tp, tx0, params_from_jax(params)),
                          jtnt.solve(jp, jx0, params), rtol=1e-7)
    with pytest.raises(ValueError, match="pair"):
        ttnt.TNTParams(flat_s_steps=2, flat_kernel_check=False).validate()


def test_flat_prec_matches_generic_precon_and_jax():
    """tests/test_flat_cg.py::TestPreconditionedFlat::test_tnt_flat_prec_
    matches_generic_precon in both packages (f64, n = 1024, d from 1 to
    1e5, Jacobi on 2d): the port's flat engine with ``flat_prec`` matches
    its generic preconditioned path (f rtol 1e-8) and JAX's flat run."""
    n = 1024
    d = np.linspace(1.0, 1e5, n)
    x0 = np.random.default_rng(9).normal(size=n)
    x0 /= np.linalg.norm(x0)
    params = jtnt.TNTParams(
        max_iterations=50, max_TPCG_iterations=200, gradient_tolerance=1e-8,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    probs = {}
    for pkg, M, dd, flat, dot, rsqrt in (
            ("j", jsphere(), jnp.asarray(d), jflat, jnp.dot,
             lambda v: 1.0 / jnp.sqrt(v)),
            ("t", sphere(), torch.from_numpy(d), tflat, torch.dot,
             torch.rsqrt)):
        kw = dict(
            f=lambda x, _, dd=dd, dot=dot: dot(x, dd * x), manifold=M,
            grad=lambda x, _, dd=dd, M=M: M.proj(x, 2.0 * dd * x),
            precon=lambda x, v, _, dd=dd, M=M: M.proj(x, v / (2.0 * dd)))
        P = (lambda dd, rsqrt: lambda v: v * rsqrt(2.0 * dd))(dd, rsqrt)
        flat_kw = dict(
            flat_qm=lambda x, _, dd=dd, flat=flat: flat.sphere_rayleigh_flat(
                x, lambda v: dd * v)[:3],
            flat_prec=lambda x, _, P=P: P)
        Prob = JProblem if pkg == "j" else TProblem
        probs[pkg] = (Prob(**kw, **flat_kw), Prob(**kw))
    jres = jtnt.solve(probs["j"][0], jnp.asarray(x0), params)
    tflat_res = ttnt.solve(probs["t"][0], torch.from_numpy(x0),
                           params_from_jax(params))
    tgen = ttnt.solve(probs["t"][1], torch.from_numpy(x0),
                      params_from_jax(params))
    np.testing.assert_allclose(float(tflat_res.f), float(tgen.f), rtol=1e-8)
    np.testing.assert_allclose(float(tflat_res.f), 1.0, atol=1e-4)
    assert int(tflat_res.num_iterations) == int(jres.num_iterations)
    assert int(tflat_res.status) == int(jres.status)
    np.testing.assert_allclose(float(tflat_res.f), float(jres.f), rtol=1e-9)
    np.testing.assert_array_equal(tflat_res.inner_iterations.numpy(),
                                  np.asarray(jres.inner_iterations))


def _jax_prec_problem(n):
    """The JAX package's preconditioned Rayleigh problem of
    tests/test_streamed_cg.py::test_tnt_flat_solve_prec_matches_flat_prec_
    engine on its XLA flat engine (flat_prec, precon; f32)."""
    b = 999.0 / (n - 1)
    M = jsphere()
    a = 1.0 + jnp.float32(b) * jnp.arange(n, dtype=jnp.float32)
    A_elem = lambda v: a * v.astype(jnp.float32)

    def flat_prec(x, dd):
        rq = jnp.dot(x.astype(jnp.float32), 2.0 * A_elem(x))
        return lambda v: v * jax.lax.rsqrt(jnp.abs(2.0 * a - rq) + 1.0)

    def precon(x, r, dd):
        rq = jnp.dot(x.astype(jnp.float32), 2.0 * A_elem(x))
        return r / (jnp.abs(2.0 * a - rq) + 1.0)

    return JProblem(
        f=lambda x, dd: jnp.dot(x.astype(jnp.float32), A_elem(x)),
        manifold=M,
        grad=lambda x, dd: M.proj(x, (2.0 * A_elem(x)).astype(x.dtype)),
        flat_qm=lambda x, dd, aux=None: jflat.sphere_rayleigh_flat(
            x, A_elem, rq=aux.rq if aux is not None else None)[:3],
        flat_prec=flat_prec, precon=precon,
        step_eval=jflat.sphere_rayleigh_step(A_elem))


@pytest.mark.parametrize("engine", ["flat", "streamed_reference"])
def test_flat_prec_routes_match_jax(engine):
    """The port's preconditioned headline problem (``headline.make_problem(
    jacobi_power=0.5)``, P = (|2a - rq| + 1)^(-1/2)) through the flat
    engine and through ``flat_solve`` with the streamed kernel's plain
    version, against the JAX package's preconditioned flat solve (f32,
    n = 8192): the same optimum (f within 5e-4 relative, the JAX test's
    stream-vs-flat tolerance, and within 5e-3 of f* = 1) and equal outer
    counts."""
    n = 8192
    params = jtnt.TNTParams(
        max_iterations=40, max_TPCG_iterations=40, gradient_tolerance=1e-3,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    x0 = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    x0 /= np.linalg.norm(x0)
    jres = jtnt.solve(_jax_prec_problem(n), jnp.asarray(x0), params)
    tres = ttnt.solve(headline.make_problem(n, "cpu", engine,
                                            jacobi_power=0.5),
                      torch.from_numpy(x0), params_from_jax(params))
    assert int(tres.status) == int(jres.status) == TNTStatus.GRADIENT
    assert int(tres.num_iterations) == int(jres.num_iterations)
    np.testing.assert_allclose(float(tres.f), 1.0, atol=5e-3)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=5e-4)


def _escalation_problems(d):
    """The Rayleigh problem of tests/test_tnt.py::test_bf16_f32_escalation
    (flat_qm, no step evaluator) in both packages, computing in the
    iterate's dtype widened to at least f32."""
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    jacc = lambda x: jnp.promote_types(x.dtype, jnp.float32)
    jA = lambda v: jd.astype(jacc(v)) * v.astype(jacc(v))
    jM = jsphere()
    jp = JProblem(f=lambda x, _: jnp.dot(x.astype(jacc(x)), jA(x)),
                  manifold=jM,
                  grad=lambda x, _: jM.proj(x, (2.0 * jA(x)).astype(x.dtype)),
                  flat_qm=lambda x, _: jflat.sphere_rayleigh_flat(x, jA)[:3])
    tacc = lambda x: torch.promote_types(x.dtype, torch.float32)
    tA = lambda v: td.to(tacc(v)) * v.to(tacc(v))
    tM = sphere()
    tp = TProblem(f=lambda x, _: torch.dot(x.to(tacc(x)), tA(x)),
                  manifold=tM,
                  grad=lambda x, _: tM.proj(x, (2.0 * tA(x)).to(x.dtype)),
                  flat_qm=lambda x, _: tflat.sphere_rayleigh_flat(x, tA)[:3])
    return jp, tp


ESC_PARAMS = jtnt.TNTParams(
    max_iterations=100, max_TPCG_iterations=100, gradient_tolerance=2e-4,
    relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
    preconditioned_gradient_tolerance=0.0)


def test_escalation_f32_to_f64_matches_jax():
    n = 4096
    d = np.linspace(1.0, 1000.0, n).astype(np.float32).astype(np.float64)
    jp, tp = _escalation_problems(d)
    x0 = np.random.default_rng(11).standard_normal(n)
    x0 /= np.linalg.norm(x0)
    params = jtnt.TNTParams(**{**ESC_PARAMS.__dict__,
                               "gradient_tolerance": 1e-9})
    jres = jtnt.solve_escalated(jp, jnp.asarray(x0), params,
                                low_dtype=jnp.float32, high_dtype=jnp.float64)
    tres = ttnt.solve_escalated(tp, torch.from_numpy(x0),
                                params_from_jax(params),
                                low_dtype=torch.float32,
                                high_dtype=torch.float64)
    assert tres.stage_low.x.dtype == torch.float32
    assert tres.x.dtype == torch.float64
    msg = (f"switch {int(tres.switch_iteration)} (JAX "
           f"{int(jres.switch_iteration)}), stage 2 "
           f"{int(tres.stage_high.num_iterations)} (JAX "
           f"{int(jres.stage_high.num_iterations)})")
    assert int(tres.switch_iteration) == int(jres.switch_iteration), msg
    assert (int(tres.stage_high.num_iterations)
            == int(jres.stage_high.num_iterations)), msg
    assert int(tres.status) == int(jres.status) == TNTStatus.GRADIENT, msg
    assert abs(float(tres.f) - float(jres.f)) <= 1e-8
    assert int(tres.stage_low.status) == int(jres.stage_low.status)


def test_escalation_bf16_to_f32_contract():
    """tests/test_tnt.py::test_bf16_f32_escalation's contract in the port:
    stage 1 in bf16, the final status GRADIENT with |g| < 2e-4, f within
    1e-4 of f* = 1; both packages' switch iterations in the message."""
    n = 4096
    d = np.linspace(1.0, 1000.0, n).astype(np.float32)
    jp, tp = _escalation_problems(d.astype(np.float64))
    x0 = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    x0 /= np.linalg.norm(x0)
    jres = jtnt.solve_escalated(jp, jnp.asarray(x0), ESC_PARAMS)
    tres = ttnt.solve_escalated(tp, torch.from_numpy(x0),
                                params_from_jax(ESC_PARAMS))
    msg = (f"switch {int(tres.switch_iteration)} (JAX "
           f"{int(jres.switch_iteration)}), total "
           f"{int(tres.num_iterations)} (JAX {int(jres.num_iterations)})")
    assert int(tres.switch_iteration) > 0, msg
    assert tres.stage_low.x.dtype == torch.bfloat16, msg
    assert tres.x.dtype == torch.float32, msg
    assert int(tres.stage_low.status) in (TNTStatus.TRUST_REGION,
                                          TNTStatus.GRADIENT), msg
    assert int(tres.status) == TNTStatus.GRADIENT, msg
    assert float(tres.gradfx_norm) < 2e-4, msg
    np.testing.assert_allclose(float(tres.f), 1.0, atol=1e-4, err_msg=msg)
    assert int(tres.stage_high.num_iterations) <= int(tres.num_iterations)
