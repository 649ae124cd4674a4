"""The port's model examples (rotation sync, certification, the online
warm start, the staircase, pose graphs, robust SE(3), range sync) against
the JAX package on the JAX examples' own inputs, float64 on the CPU.

As ``tests/test_torch_examples.py`` (its module docstring says how the
inputs cross and what the tolerances mean); each test states its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.io import load_g2o as jload_g2o
from optimization_tpu.models import pose_sync as jps
from optimization_tpu.models import range_sync as jrg
from optimization_tpu.models import rotation_sync as jrs
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import interop
from optimization_tpu_torch.examples import (certification_fleet,
                                             online_warm_start,
                                             pose_graph_g2o, range_aided,
                                             robust_pose_graph,
                                             rotation_sync_example,
                                             staircase_escape)

from test_torch_examples import F64, TNT_STOPS, _t

torch.set_num_threads(1)


def _rot_data(data):
    return interop.rotation_sync_data_from_jax(data, device="cpu")


def _assert_same_stops(got, ref, tol):
    """Fleet stops: equal statuses and counts but for at most one instance
    that sits at the noise floor, where one package's trust region
    collapses (TRUST_REGION, 5) while the other takes one more step to
    GRADIENT (1): both |grad| then under 2 tol, the counts within 1 and f
    within 1e-12 relative (``ROADMAP.md`` Queue 3)."""
    status = np.array(ref.status).tolist()
    iters = np.array(ref.num_iterations).tolist()
    differ = [b for b in range(len(status))
              if (got["statuses"][b], got["iters"][b]) != (status[b], iters[b])]
    assert len(differ) <= 1, differ
    for b in differ:
        assert {got["statuses"][b], status[b]} <= {1, 5}
        assert abs(got["iters"][b] - iters[b]) <= 1
        assert got["grad"][b] < 2 * tol and float(ref.gradfx_norm[b]) < 2 * tol
        assert abs(got["f"][b] - float(ref.f[b])) <= 1e-12 * float(ref.f[b])


def test_rotation_sync_example_matches_jax():
    """The JAX example's instance (n = 64) and fleet (B = 4), from JAX's own
    spectral starts: the single solve's status and count equal, f within
    1e-9 relative, the aligned error within 1e-8; the fleet as
    :func:`_assert_same_stops` (instance 0 ends TRUST_REGION after 5 outer
    iterations in JAX at |grad| 1.70e-8 and GRADIENT after 6 in the port),
    f within 1e-9 relative.  JAX's eager instance draws and LOBPCG compile
    take ~20 s at any size, so there is no smaller case."""
    n, B, d, tol = 64, 4, 3, 1e-8
    R_true, data = jrs.random_instance(jax.random.PRNGKey(0), n, d,
                                       extra_edges=2 * n, noise=0.05,
                                       dtype=jnp.float64)
    R0 = jrs.spectral_init(data, n, d)
    _, fleet = jrs.random_fleet(jax.random.PRNGKey(7), B, n, d,
                                extra_edges=2 * n, noise=0.05,
                                dtype=jnp.float64)
    R0s = jnp.stack([jrs.spectral_init(fleet._replace(Rij=fleet.Rij[i]),
                                       n, d) for i in range(B)])
    out = rotation_sync_example.run("cpu", F64, data={
        "instance": (_t(R_true), _rot_data(data)), "R0": _t(R0),
        "fleet": _rot_data(fleet), "R0s": _t(R0s)})

    params = jtnt.TNTParams(max_iterations=200, gradient_tolerance=tol,
                            **TNT_STOPS)
    problem = jrs.make_problem()
    r = jtnt.solve(problem, R0, params, data=data)
    got = out["single"]
    assert (got["status"], got["iters"]) == (int(r.status),
                                             int(r.num_iterations))
    assert abs(got["f"] - float(r.f)) <= 1e-9 * float(r.f)
    assert abs(got["err"] - float(jrs.mean_rotation_error(r.x, R_true))) \
        <= 1e-8
    rf = jax.vmap(lambda r0, rij: jtnt.solve(
        problem, r0, params, data=fleet._replace(Rij=rij)))(R0s, fleet.Rij)
    _assert_same_stops(out["fleet"], rf, tol)
    np.testing.assert_allclose(out["fleet"]["f"], np.array(rf.f), rtol=1e-9)


def _jax_certified_solve(data, n, d, params, **cert_kw):
    """JAX's spectral init (chol), TNT and certificate of one instance."""
    R0 = jrs.spectral_init(data, n, d, rr_method="chol")
    res = jtnt.solve(jrs.make_problem(), R0, params, data=data)
    return res, jrs.certify(res.x, data, rr_method="chol", **cert_kw)


def test_certification_fleet_matches_jax():
    """The fleet of 8 from the JAX example's draws, each instance through
    the port's whole pipeline (its own spectral start): f* within 1e-9
    relative (one global optimum), equal certified flags, lam_min within
    1e-5 (each package's LOBPCG stops at tau = 1e-3 from its own start),
    stationarity under 1e-8 in both."""
    B, n, d = 8, 30, 3
    _, fleet = jrs.random_fleet(jax.random.PRNGKey(0), B, n, d,
                                extra_edges=2 * n, noise=0.03,
                                dtype=jnp.float64)
    out = certification_fleet.run("cpu", F64,
                                  data={"fleet": _rot_data(fleet)})
    certification_fleet.accept(out)
    params = jtnt.TNTParams(max_iterations=100, gradient_tolerance=1e-9,
                            **TNT_STOPS)
    one = jax.jit(lambda rij: _jax_certified_solve(
        fleet._replace(Rij=rij), n, d, params))
    for b, got in enumerate(out["instances"]):
        res, cert = one(fleet.Rij[b])
        assert abs(got["f"] - float(res.f)) <= 1e-9 * float(res.f), b
        assert got["certified"] == bool(cert.certified), b
        assert abs(got["lam_min"] - float(cert.lam_min)) <= 1e-5, b
        assert got["stationarity"] < 1e-8 and float(cert.stationarity) < 1e-8


def test_online_warm_start_matches_jax():
    """The growing n = 40 problem from the JAX example's draw: the same
    snapshots, each certified in both with f* within 1e-9 relative (the
    cold start is each package's own spectral init, so the first
    snapshot's outer count may differ by 1; the later warm starts are
    then equal up to that; the first snapshot is a tree, f* ~ 1e-20, hence
    an absolute 1e-12 beside), lam_min within 1e-5."""
    n, d = 40, 3
    R_true, data = jrs.random_instance(jax.random.PRNGKey(0), n, d,
                                       extra_edges=3 * n, noise=0.03,
                                       dtype=jnp.float64)
    out = online_warm_start.run("cpu", F64, data={
        "instance": (_t(R_true), _rot_data(data))})
    online_warm_start.accept(out)
    E = int(data.src.shape[0])
    chunks = [n - 1] + [n] * ((E - (n - 1) + n - 1) // n)
    assert out["E"] == E and len(out["rows"]) == len(chunks)
    params = jtnt.TNTParams(max_iterations=100, gradient_tolerance=1e-9,
                            **TNT_STOPS)

    @jax.jit
    def snapshot(mask, R0):
        data_t = data._replace(kappa=mask.astype(jnp.float64))
        res = jtnt.solve(jrs.make_problem(), R0, params, data=data_t)
        cert = jrs.certify(res.x, data_t, rr_method="chol",
                           precondition=True)
        return res.x, res.f, res.num_iterations, cert.certified, cert.lam_min

    R = jrs.spectral_init(data._replace(kappa=(jnp.arange(E) < chunks[0])
                                        .astype(jnp.float64)), n, d)
    shown = 0
    for got, grow in zip(out["rows"], chunks):
        shown = min(E, shown + grow)
        R, f, iters, certified, lam = snapshot(jnp.arange(E) < shown, R)
        assert got["edges"] == shown
        assert got["certified"] and bool(certified)
        assert abs(got["iters"] - int(iters)) <= 1
        assert abs(got["f"] - float(f)) <= 1e-12 + 1e-9 * float(f)
        assert abs(got["lam_min"] - float(lam)) <= 1e-5


def _jax_ring(n, d, noise, seed):
    """``examples/staircase_escape.py:ring_instance`` in the JAX package."""
    R_true, _ = jrs.random_instance(jax.random.PRNGKey(seed), n, d,
                                    extra_edges=0, noise=0.0,
                                    dtype=jnp.float64)
    src = jnp.arange(n, dtype=jnp.int32)
    dst = (src + 1) % n
    Rij = R_true[src] @ jnp.swapaxes(R_true[dst], -1, -2)
    w = noise * jax.random.normal(jax.random.PRNGKey(100 + seed), (n, d, d),
                                  jnp.float64)
    skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
    u, _, vt = jnp.linalg.svd(jnp.eye(d) + skew + 0.5 * (skew @ skew))
    return R_true, jrs.RotationSyncData(src=src, dst=dst, Rij=(u @ vt) @ Rij)


@pytest.mark.parametrize("with_staircase", [
    pytest.param(True, marks=pytest.mark.slow, id="staircase"),
    pytest.param(False, id="plain")])
def test_staircase_escape_matches_jax(with_staircase):
    """The ring n = 12, noise 0.3, from the JAX example's random start: the
    plain TNT equal (status, count; f within 1e-10 relative) and stuck
    (certificate failed in both, lam_min within 1e-4), the port's staircase
    meeting the JAX example's check; with JAX's staircase beside it (slow:
    ~15 s of JAX compiles), the same levels to the same p, certified in
    both, f per level within 1e-6 relative (each escape follows its own
    LOBPCG eigenvector)."""
    n, d, tau = 12, 3, 1e-6
    R_true, data = _jax_ring(n, d, 0.3, 0)
    R0 = jrs.ROTATIONS.rand(jax.random.PRNGKey(1000), n, d, d)
    out = staircase_escape.run("cpu", F64, data={
        "instance": (_t(R_true), _rot_data(data)), "R0": _t(R0)})
    staircase_escape.accept(out)
    params = jtnt.TNTParams(max_iterations=200, gradient_tolerance=1e-10,
                            **TNT_STOPS)
    res = jtnt.solve(jrs.make_problem(), R0, params, data=data)
    cert = jrs.certify(res.x, data, tau=tau)
    got = out["plain"]
    assert (got["status"], got["iters"]) == (int(res.status),
                                             int(res.num_iterations))
    assert abs(got["f"] - float(res.f)) <= 1e-10 * float(res.f)
    assert got["certified"] is False and not bool(cert.certified)
    assert abs(got["lam_min"] - float(cert.lam_min)) <= 1e-4
    assert out["staircase"]["certified"]
    if not with_staircase:
        return
    st = jrs.solve_staircase(data, n, d, params=params, R0=R0, cert_tau=tau)
    got = out["staircase"]
    assert bool(st.certified) and got["p_final"] == st.p_final
    assert [p for p, *_ in got["levels"]] == [p for p, *_ in st.levels]
    for (_, f, _, ok), (_, fj, _, okj) in zip(got["levels"], st.levels):
        assert abs(f - float(fj)) <= 1e-6 * max(float(fj), 1e-3)
        assert ok == bool(okj)


def _jax_pose_graph(n=64, noise=0.03, seed=0):
    """``examples/pose_graph_g2o.py:synthesize_g2o``'s draws in the JAX
    package (its arrays, not its file)."""
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(seed), 5)
    R_true = jrs.ROTATIONS.rand(k1, n, 3, 3)
    t_true = 3.0 * jax.random.normal(k2, (n, 3))
    src = jnp.concatenate([jnp.arange(n - 1, dtype=jnp.int32),
                           jax.random.randint(k3, (2 * n,), 0, n, jnp.int32)])
    dst = jnp.concatenate([jnp.arange(1, n, dtype=jnp.int32),
                           jax.random.randint(k4, (2 * n,), 0, n, jnp.int32)])
    Rt = jnp.swapaxes(R_true, -1, -2)
    Mij = jnp.einsum("eij,ejk->eik", Rt[src], R_true[dst])
    tij = jnp.einsum("eij,ej->ei", Rt[src], t_true[dst] - t_true[src])
    w = noise * jax.random.normal(k5, (src.shape[0], 3, 3))
    skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
    Mij = jrs._orthonormalize(jnp.eye(3) + skew + 0.5 * (skew @ skew)) @ Mij
    tij = tij + noise * jax.random.normal(k5, tij.shape)
    return {k: _t(v) for k, v in dict(R_true=R_true, t_true=t_true, src=src,
                                      dst=dst, Mij=Mij, tij=tij).items()}


def test_pose_graph_g2o_matches_jax(tmp_path):
    """The JAX example's synthetic graph, written by the port's
    ``write_g2o``, loaded and solved (certify=True, f64) by both packages:
    equal rotation status, f within 1e-9 relative (each starts from its own
    spectral init, so the outer counts may differ by 1), LSQR residual
    within 1e-8, certified in both, lam_min within 1e-5, aligned errors
    within 1e-7."""
    g = _jax_pose_graph()
    out = pose_graph_g2o.run("cpu", F64, data={"graph": g})
    path = str(tmp_path / "g.g2o")
    pose_graph_g2o.write_g2o(path, g["src"], g["dst"], g["Mij"], g["tij"])
    graph = jload_g2o(path)
    assert (out["n"], out["E"]) == (graph.n_vertices, len(graph.src))
    res = jps.solve_pose_graph(graph, dtype=jnp.float64, certify=True)
    rr = res.rotation_result
    assert out["status"] == int(rr.status)
    assert abs(out["iters"] - int(rr.num_iterations)) <= 1
    assert abs(out["f"] - float(rr.f)) <= 1e-9 * float(rr.f)
    assert abs(out["lsqr_residual"] - float(res.translation_residual)) <= 1e-8
    assert out["certified"] and bool(res.certificate.certified)
    assert abs(out["lam_min"] - float(res.certificate.lam_min)) <= 1e-5
    err_R, err_t = jps.alignment_errors(res.R, res.t,
                                        jnp.asarray(g["R_true"].numpy()),
                                        jnp.asarray(g["t_true"].numpy()))
    assert abs(out["err_R"] - float(err_R)) <= 1e-7
    assert abs(out["err_t"] - float(err_t)) <= 1e-7


def _jax_robust_graph(n, noise=0.01, outlier_frac=0.2, seed=7):
    """``examples/robust_pose_graph.py:synthesize`` in the JAX package."""
    rng = np.random.default_rng(seed)
    R_true = jrs.ROTATIONS.rand(jax.random.PRNGKey(seed), n, 3, 3)
    t_true = jnp.asarray(rng.normal(size=(n, 3)) * 2.0)
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, 4 * n)])
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, 4 * n)])
    keep = src != dst
    src = jnp.asarray(src[keep], jnp.int32)
    dst = jnp.asarray(dst[keep], jnp.int32)
    E = int(src.shape[0])
    Rt = jnp.swapaxes(R_true, -1, -2)
    Mij = jnp.einsum("eij,ejk->eik", Rt[src], R_true[dst])
    tij = jnp.einsum("eij,ej->ei", Rt[src], t_true[dst] - t_true[src])
    w = noise * jnp.asarray(rng.normal(size=(E, 3, 3)))
    skew = 0.5 * (w - jnp.swapaxes(w, -1, -2))
    Mij = jrs._orthonormalize(jnp.eye(3) + skew + 0.5 * (skew @ skew)) @ Mij
    tij = tij + noise * jnp.asarray(rng.normal(size=(E, 3)))
    n_out = int(outlier_frac * E)
    out_idx = rng.choice(E, n_out, replace=False)
    full = out_idx[: n_out // 2]
    Mij = Mij.at[full].set(
        jrs.ROTATIONS.rand(jax.random.PRNGKey(99), len(full), 3, 3))
    tij = tij.at[out_idx].set(jnp.asarray(rng.normal(size=(n_out, 3)) * 10.0))
    return dict(R_true=R_true, t_true=t_true, src=src, dst=dst, Mij=Mij,
                tij=tij, out_idx=out_idx, full=full)


@pytest.mark.parametrize("n", [pytest.param(80, marks=pytest.mark.slow,
                                          id="example"),
                               pytest.param(30, id="small")])
def test_robust_pose_graph_matches_jax(n):
    """The JAX example's corrupted graph: the non-robust marginalized solve
    (f32 in both, the function's default) dragged off alike (rotation
    error within 1e-3, translation error within 1e-2 relative); the port's
    GNC solve (f64) at the noise floor (errors under 0.05, every corrupted
    edge's translation weight under 1e-3).  At the example's n = 80 (slow:
    JAX compiles its GNC for ~20 s at any size), JAX's GNC beside it: the
    errors within 1e-4 relative, the largest weight over the corrupted
    edges within 1e-6 and the inliers' median weight within 5e-4 (each
    package's GNC starts from its own spectral init, and its stages end
    at the 60-outer cap or TRUST_REGION)."""
    s = _jax_robust_graph(n)
    out = robust_pose_graph.run("cpu", F64, data={
        "graph": {k: _t(v) for k, v in s.items()}})
    E = int(s["src"].shape[0])
    g = type("G", (), dict(src=np.asarray(s["src"]), dst=np.asarray(s["dst"]),
                           Rij=np.asarray(s["Mij"]), tij=np.asarray(s["tij"]),
                           kappa=None, n_vertices=n))()
    plain = jps.solve_pose_graph(g, marginalized=True)
    pr, pt = jps.alignment_errors(plain.R.astype(jnp.float64),
                                  plain.t.astype(jnp.float64), s["R_true"],
                                  s["t_true"])
    assert abs(out["plain_rot_err"] - float(pr)) <= 1e-3
    assert abs(out["plain_t_err"] - float(pt)) <= 1e-2 * float(pt)
    assert out["rot_err"] < 0.05 and out["t_err"] < 0.05
    assert out["w_out_max"] < 1e-3
    if n != 80:
        return
    rob = jps.solve_robust_se(s["src"], s["dst"], s["Mij"], s["tij"], n)
    rr, tt = jps.alignment_errors(rob.R, rob.t, s["R_true"], s["t_true"])
    assert abs(out["rot_err"] - float(rr)) <= 1e-4 * float(rr)
    assert abs(out["t_err"] - float(tt)) <= 1e-4 * float(tt)
    w_tr = np.asarray(rob.w_tr)
    inl = np.setdiff1d(np.arange(E), s["out_idx"])
    assert abs(out["w_out_max"] - w_tr[s["out_idx"]].max()) <= 1e-6
    assert abs(out["w_in_median"] - np.median(w_tr[inl])) <= 5e-4


@pytest.mark.parametrize("n, n_ranges", [
    pytest.param(30, 60, marks=pytest.mark.slow, id="example"),
    pytest.param(12, 24, id="small")])
def test_range_aided_matches_jax(n, n_ranges):
    """The JAX example's chain (at its n = 30 with 60 ranges, slow: both
    packages' automatic hvp in f32 take ~25 s here; and at n = 12 with 24),
    both solves in f32 (the function's default in both packages) from each
    package's own spectral start.  Both stop at the f32 floor of |grad|:
    GRADIENT or TRUST_REGION, |grad| under 1.5e-3 against the 1e-3
    tolerance (at n = 30, JAX ends GRADIENT after 9 outer iterations at
    |grad| 9.43e-4, the port TRUST_REGION after 12 at 1.27e-3; ``ROADMAP.md``
    Queue 3); f within 1e-5 relative, rotation error within 1e-4, the
    translation errors within 1e-2 relative (each package starts from its
    own spectral init and stops at that floor), and the ranges tighten the
    translations in both."""
    R_true, t_true, data = jrg.random_instance(
        jax.random.PRNGKey(3), n, 3, extra_edges=0, n_ranges=n_ranges,
        noise=0.05, range_noise=0.001)
    out = range_aided.run("cpu", F64, data={"instance": (
        _t(R_true), _t(t_true),
        interop.range_sync_data_from_jax(data, device="cpu"))})
    t_ref = t_true - t_true[0][None]
    ref = jrg.solve_range_aided(data, n)
    rot_err, t_err = jps.alignment_errors(ref.R, ref.t, R_true, t_ref)
    ref0 = jrg.solve_range_aided(
        data._replace(rho=jnp.zeros_like(data.dists)), n)
    _, t_err0 = jps.alignment_errors(ref0.R, ref0.t, R_true, t_ref)
    got, got0 = out["ranged"], out["pose_only"]
    assert {got["status"], int(ref.result.status)} <= {1, 5}
    assert got["grad_norm"] <= 1.5e-3
    assert float(ref.result.gradfx_norm) <= 1.5e-3
    assert abs(got["f"] - float(ref.result.f)) <= 1e-5 * float(ref.result.f)
    assert abs(got["rot_err"] - float(rot_err)) <= 1e-4
    assert abs(got["t_err"] - float(t_err)) <= 1e-2 * float(t_err)
    assert abs(got0["t_err"] - float(t_err0)) <= 1e-2 * float(t_err0)
    assert got0["t_err"] > got["t_err"] and float(t_err0) > float(t_err)
