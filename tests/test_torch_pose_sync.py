"""The port's SE(d) pose synchronization == the JAX package's.

Pose graphs come from ``tests/test_pose_sync.py`` (n = 20 SE(3) poses in
the g2o convention, float64) and are carried across with
``interop.pose_graph_from_jax``; every function gets the same inputs.

Tolerances:

- ``rotation_sync._median`` equals ``jnp.median`` exactly on odd and even
  lengths; ``gnc_identifiability`` is equal (flags) and within 1e-15
  (fractions); ``alignment_errors`` within 1e-12;
- ``recover_translations``: t and the residual within 1e-10;
- ``_weighted_laplacian_solver``: ``cg`` z within 1e-10 with equal
  ``with_iters`` counts (within one without the Jacobi preconditioner,
  where the last step is decided at round-off level); ``flat`` at s = 1, 2, 3 the edge differences
  within 1e-8 of JAX's flat run and of the port's cg run, counts equal to
  JAX's;
- ``marginalized_problem``: f, the Riemannian gradient, a Hessian-vector
  product and ``Q_op`` within 1e-10 relative (both inner engines; every
  ``scatter_method`` for ``Q_op``);
- whole pipelines (``solve_pose_graph``'s three routes with the
  certificate, ``solve_robust_se``): LOBPCG starts from another random
  block in each package, so they agree up to gauge: ``alignment_errors``
  between the two outputs within 1e-6, the same certificate decision, the
  same rejected-edge sets.  The GNC solves start both packages from one
  spectral initialization (the port's, converged to tau = 1e-10: the GNC
  scales are medians of the start's residuals);
- the loose certificate operator (60 inner iterations, rtol 1e-4) within
  1e-10 relative of JAX's on the same inputs; in f32 it reproduces the tight one's decision on a certifying and a perturbed
  point, lam_min within 0.5 eta (``tests/test_pose_sync.py::
  TestMarginalized::test_loose_certificate_operator_decision_parity``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.models import pose_sync as jps
from optimization_tpu.models import rotation_sync as jrs
from optimization_tpu_torch import interop
from optimization_tpu_torch.models import pose_sync as ps
from optimization_tpu_torch.models import rotation_sync as rs

import test_pose_sync as jtests

torch.set_num_threads(1)

D = 3
METHODS = ["scatter", "gather", "sort", "adjacency"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def noisy():
    """(JAX graph, port graph, R_true, t_true) of seed 5, noise 0.02."""
    g, R_true, t_true = jtests._make_pose_graph(5, noise_rot=0.02, noise_t=0.02)
    return g, interop.pose_graph_from_jax(g), R_true, t_true


def _rotations(seed, n):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, D, D)))
    q[..., :, 0] *= np.sign(np.linalg.det(q))[..., None]
    return q


@pytest.mark.parametrize("values", [
    [3.0], [2.0, 1.0], [5.0, 1.0, 3.0], [4.0, 1.0, 3.0, 2.0],
    [1.0, 1.0, 2.0, 2.0], [0.5, 7.0, 7.0, 1e-9, 3.0, 2.0],
    [1.0, float("nan"), 2.0, 3.0]],
    ids=["1", "2", "3", "4", "ties", "6", "nan"])
def test_median_matches_jnp(values):
    a = np.asarray(values)
    got = float(rs._median(torch.from_numpy(a)))
    want = float(jnp.median(jnp.asarray(a)))
    assert (np.isnan(got) and np.isnan(want)) or got == want
    if len(a) % 2 == 0 and not np.isnan(a).any():
        # torch.median is the lower middle value: not the same function
        assert float(torch.median(torch.from_numpy(a))) != want or \
            np.sort(a)[len(a) // 2 - 1] == np.sort(a)[len(a) // 2]


def test_gnc_identifiability_matches_jax(noisy):
    g, tg, _, _ = noisy
    rng = np.random.default_rng(2)
    E = len(g.src)
    w = rng.uniform(0.2, 1.0, E)
    w[rng.choice(E, E // 3, replace=False)] = 1e-7     # rejected edges
    base = rng.uniform(0.5, 2.0, E)
    for b in (None, base):
        jid, jfrac = jps.gnc_identifiability(
            jnp.asarray(w), jnp.asarray(g.src), jnp.asarray(g.dst), 20,
            None if b is None else jnp.asarray(b))
        tid, tfrac = ps.gnc_identifiability(
            _t(w), tg.src, tg.dst, 20, None if b is None else _t(b))
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_allclose(tfrac.numpy(), np.asarray(jfrac),
                                   rtol=0, atol=1e-15)


def test_alignment_errors_match_jax(noisy):
    _, _, R_true, t_true = noisy
    R = _rotations(4, 20)
    t = np.random.default_rng(5).normal(size=(20, D))
    je = jps.alignment_errors(jnp.asarray(R), jnp.asarray(t),
                              jnp.asarray(R_true), jnp.asarray(t_true))
    te = ps.alignment_errors(_t(R), _t(t), R_true, t_true)
    np.testing.assert_allclose([float(x) for x in te],
                               [float(x) for x in je], rtol=1e-12)


@pytest.mark.parametrize("weighted,method", [(False, "scatter"),
                                             (True, "scatter"),
                                             (True, "adjacency")])
def test_recover_translations_matches_jax(noisy, weighted, method):
    g, tg, R_true, _ = noisy
    w = np.linspace(0.5, 2.0, len(g.src)) if weighted else None
    jt, jr = jps.recover_translations(
        jnp.asarray(R_true), jnp.asarray(g.src), jnp.asarray(g.dst),
        jnp.asarray(g.tij), weights=None if w is None else jnp.asarray(w),
        scatter_method=method)
    tt, tr = ps.recover_translations(
        _t(R_true), tg.src, tg.dst, tg.tij,
        weights=None if w is None else _t(w), scatter_method=method)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(tr), float(jr), rtol=1e-10)


@pytest.fixture(scope="module")
def laplacian():
    """``TestFlatInnerSolver``'s graph (n = 50, tau over 4 decades) and a
    consistent (n, 3) right-hand side."""
    src, dst, tau = jtests.TestFlatInnerSolver()._graph()
    r = np.random.default_rng(1).normal(size=(50, 3))
    return (np.asarray(src), np.asarray(dst), np.asarray(tau),
            r - r.mean(axis=0, keepdims=True))


def _solvers(lap, **kw):
    src, dst, tau, _ = lap
    j = jps._weighted_laplacian_solver(
        jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
        jnp.asarray(tau), 50, max_iterations=5000, with_iters=True, **kw)
    t = ps._weighted_laplacian_solver(_t(src), _t(dst), _t(tau), 50,
                                      max_iterations=5000, with_iters=True,
                                      **kw)
    return j, t


@pytest.mark.parametrize("jacobi", [True, False], ids=["jacobi", "plain"])
def test_laplacian_cg_matches_jax(laplacian, jacobi):
    js, ts = _solvers(laplacian, engine="cg", jacobi=jacobi)
    r = laplacian[3]
    jz, jk = js(jnp.asarray(r))
    tz, tk = ts(_t(r))
    if jacobi:
        assert tk == int(jk)
    else:
        # unpreconditioned, tau over 4 decades: past n = 50 iterations the
        # residual falls about a decade an iteration at round-off level, and
        # the summation order decides the last step (67 here, 68 in JAX)
        assert abs(tk - int(jk)) <= 1
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("s", [1, 2, 3])
def test_laplacian_flat_matches_jax(laplacian, s):
    src, dst, _, r = laplacian
    js, ts = _solvers(laplacian, engine="flat", s_steps=s)
    _, cg = _solvers(laplacian, engine="cg")
    jz, jk = js(jnp.asarray(r))
    tz, tk = ts(_t(r))
    z0, _ = cg(_t(r))
    assert tk == int(jk)
    edge = lambda z: np.asarray(z)[dst] - np.asarray(z)[src]  # noqa: E731
    np.testing.assert_allclose(edge(tz.numpy()), edge(jz), rtol=0, atol=1e-8)
    np.testing.assert_allclose(edge(tz.numpy()), edge(z0.numpy()), rtol=0,
                               atol=1e-8)


def _marginalized(g, tg, **kw):
    j = jps.marginalized_problem(
        jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(g.Rij),
        jnp.asarray(g.tij), kappa=jnp.asarray(g.kappa), n=20, **kw)
    t = ps.marginalized_problem(_t(tg.src), _t(tg.dst), _t(tg.Rij),
                                _t(tg.tij), kappa=_t(tg.kappa), n=20, **kw)
    return j, t


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("engine", ["cg", "flat"])
def test_marginalized_problem_matches_jax(noisy, engine):
    g, tg, _, _ = noisy
    (jp, jQ, _), (tp, tQ, n) = _marginalized(g, tg, inner_engine=engine)
    assert n == 20
    Q = _rotations(6, n)
    V = np.random.default_rng(7).normal(size=Q.shape)
    X = np.random.default_rng(8).normal(size=(n * D, 4))
    _close(float(tp.value(_t(Q))), float(jp.value(jnp.asarray(Q))))
    jg, jh = jp.qm(jnp.asarray(Q), None)
    tgr, th = tp.qm(_t(Q), None)
    _close(tgr.numpy(), jg)
    _close(tp.rgrad(_t(Q)).numpy(), jg)
    Vt = rs.ROTATIONS.proj(_t(Q), _t(V))
    jhv = jh(jnp.asarray(Vt.numpy()))
    _close(th(Vt).numpy(), jhv)
    _close(tp.hvp(_t(Q), Vt).numpy(), jhv)
    if engine == "cg":      # Q_op of every scatter_method: the next test
        _close(tQ(_t(X)).numpy(), jQ(jnp.asarray(X)))


@pytest.mark.parametrize("method", METHODS)
def test_marginalized_operator_scatter_methods_match_jax(noisy, method):
    g, tg, _, _ = noisy
    (_, jQ, _), (_, tQ, _) = _marginalized(g, tg, scatter_method=method)
    X = np.random.default_rng(9).normal(size=(20 * D, 3))
    _close(tQ(_t(X)).numpy(), jQ(jnp.asarray(X)))


def test_loose_certificate_operator_matches_jax(noisy):
    """The certificate's loose operator (inner CG capped at 60 iterations,
    rtol 1e-4, what ``solve_pose_graph`` uses in f32) == JAX's on the same
    inputs, within 1e-10 relative as the default operator."""
    g, tg, _, _ = noisy
    (_, jQ, _), (_, tQ, _) = _marginalized(g, tg, cg_iterations=60,
                                           cg_rtol=1e-4)
    X = np.random.default_rng(10).normal(size=(20 * D, 3))
    _close(tQ(_t(X)).numpy(), jQ(jnp.asarray(X)))


def same_spectral_start(monkeypatch):
    """Make both packages' pipelines start from one point: each package's
    ``spectral_init`` returns the port's, converged to tau = 1e-10 (a GNC
    scale is a median of the start's residuals, so a start that differs by
    LOBPCG's default tolerance moves the whole GNC trajectory)."""
    tight = functools.partial(rs.spectral_init, tau=1e-10,
                              max_iterations=500)

    def port(data, n, d=3, **_):
        return tight(data, n, d, generator=torch.Generator(
            data.Rij.device).manual_seed(0))

    def jax_(data, n, d=3, **_):
        return jnp.asarray(port(interop.rotation_sync_data_from_jax(
            data, device="cpu"), n, d).numpy())

    monkeypatch.setattr(rs, "spectral_init", port)
    monkeypatch.setattr(jrs, "spectral_init", jax_)


@pytest.fixture
def tight_spectral_init(monkeypatch):
    same_spectral_start(monkeypatch)


ROUTES = {"chordal": {}, "marginalized": dict(marginalized=True),
          "staircase": dict(staircase=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_solve_pose_graph_routes_match_jax(noisy, route):
    g, tg, R_true, t_true = noisy
    kw = ROUTES[route]
    jres = jps.solve_pose_graph(g, dtype=jnp.float64, certify=True, **kw)
    tres = ps.solve_pose_graph(tg, dtype=torch.float64, certify=True,
                               device="cpu", **kw)
    assert tres.R.device.type == "cpu" and tres.R.dtype == torch.float64
    er, et = ps.alignment_errors(tres.R, tres.t, np.asarray(jres.R),
                                 np.asarray(jres.t))
    assert float(er) < 1e-6 and float(et) < 1e-6, (float(er), float(et))
    assert int(tres.rotation_result.status) == int(
        jres.rotation_result.status)
    np.testing.assert_allclose(float(tres.translation_residual),
                               float(jres.translation_residual), rtol=1e-6)
    assert bool(tres.certificate.certified) == bool(
        jres.certificate.certified)
    assert bool(tres.certificate.certified)
    np.testing.assert_allclose(float(tres.certificate.lam_min),
                               float(jres.certificate.lam_min), rtol=0,
                               atol=1e-6)
    er, et = ps.alignment_errors(tres.R, tres.t, R_true, t_true)
    assert float(er) < 0.05 and float(et) < 0.15


def test_solve_robust_se_matches_jax(tight_spectral_init):
    """``TestRobustSE``'s fixture (n = 30, 20 % corrupted: half full SE(3)
    outliers, half translation-only), its gates, and the JAX result up to
    gauge with the same rejected edges."""
    R_true, t_true, src, dst, Mij, tij, rng = jtests.TestRobustSE()._instance()
    E = int(src.shape[0])
    n_out = int(0.2 * E)
    out_idx = rng.choice(E, n_out, replace=False)
    full_out = out_idx[: n_out // 2]
    Mij_c = Mij.at[full_out].set(
        jrs.ROTATIONS.rand(jax.random.PRNGKey(123), len(full_out), 3, 3))
    tij_c = tij.at[out_idx].set(jnp.asarray(rng.normal(size=(n_out, 3))
                                            * 10.0))
    n = int(R_true.shape[0])
    # three GNC stages (of the default six) bound the JAX run's compile
    # time; the fixture's gates hold at three
    jrob = jps.solve_robust_se(src, dst, Mij_c, tij_c, n, gnc_steps=3)
    rob = ps.solve_robust_se(np.asarray(src), np.asarray(dst), _t(Mij_c),
                             np.asarray(tij_c), n, gnc_steps=3)
    er, et = ps.alignment_errors(rob.R, rob.t, np.asarray(jrob.R),
                                 np.asarray(jrob.t))
    assert float(er) < 1e-6 and float(et) < 1e-6, (float(er), float(et))
    for ours, theirs in ((rob.w_rot, jrob.w_rot), (rob.w_tr, jrob.w_tr)):
        theirs = np.asarray(theirs)
        np.testing.assert_array_equal(
            np.flatnonzero(ours.numpy() < 0.02 * float(rs._median(ours))),
            np.flatnonzero(theirs < 0.02 * np.median(theirs)))
    np.testing.assert_array_equal(rob.identifiable.numpy(),
                                  np.asarray(jrob.identifiable))
    # TestRobustSE's gates
    assert bool(rob.all_identifiable)
    rot_err, t_err = ps.alignment_errors(rob.R, rob.t, np.asarray(R_true),
                                         np.asarray(t_true))
    assert float(rot_err) < 0.05 and float(t_err) < 0.1
    w_tr, w_rot = rob.w_tr.numpy(), rob.w_rot.numpy()
    inlier = np.setdiff1d(np.arange(E), out_idx)
    assert w_tr[out_idx].max() < 0.05 and w_rot[full_out].max() < 0.05
    assert np.median(w_rot[inlier]) > 0.5 and np.median(w_tr[inlier]) > 0.5


def test_loose_certificate_operator_decision_parity():
    """The f32 certificate operator of ``solve_pose_graph(marginalized=
    True)`` (inner CG capped at 60 iterations, rtol 1e-4) gives the tight
    operator's decision on a certifying point (the solved optimum) and on a
    perturbed one, lam_min within 0.5 eta; the pipeline's own certificate
    (the loose operator) certifies."""
    g, _, _ = jtests._make_pose_graph(9, noise_rot=0.02, noise_t=0.02)
    tg = interop.pose_graph_from_jax(g)
    f32 = torch.float32
    src, dst = _t(tg.src), _t(tg.dst)
    Mij, tij = _t(tg.Rij).to(f32), _t(tg.tij).to(f32)
    kappa = _t(tg.kappa).to(f32)
    _, Q_tight, _ = ps.marginalized_problem(src, dst, Mij, tij, kappa=kappa,
                                            n=20)
    _, Q_loose, _ = ps.marginalized_problem(src, dst, Mij, tij, kappa=kappa,
                                            n=20, cg_iterations=60,
                                            cg_rtol=1e-4)
    rot_data = ps._transposed_rotation_data(src, dst, Mij, kappa)
    res = ps.solve_pose_graph(tg, dtype=f32, marginalized=True, certify=True,
                              device="cpu")
    assert bool(res.certificate.certified)
    X_opt = res.rotation_result.x
    ct = rs.certify(X_opt, rot_data, operator=Q_tight)
    cl = rs.certify(X_opt, rot_data, operator=Q_loose)
    assert bool(ct.certified) and bool(cl.certified)
    assert abs(float(cl.lam_min) - float(ct.lam_min)) <= 0.5 * float(ct.eta)
    pert = 0.3 * torch.randn(X_opt.shape, dtype=f32,
                             generator=torch.Generator().manual_seed(3))
    X_bad = rs._orthonormalize(X_opt + pert)
    assert not bool(rs.certify(X_bad, rot_data, operator=Q_tight).certified)
    assert not bool(rs.certify(X_bad, rot_data, operator=Q_loose).certified)


def test_entry_points_run_on_the_card_by_default(noisy, monkeypatch):
    """No CPU fallback: with no card, the default device raises."""
    _, tg, _, _ = noisy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.solve_pose_graph(tg)
