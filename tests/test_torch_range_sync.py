"""The port's range-aided pose synchronization == the JAX package's.

Instances come from the JAX package's ``random_instance`` and cross with
``interop.range_sync_data_from_jax`` (float64, CPU); every function gets
the same inputs.  Tolerances:

- ``make_problem``: f, the Riemannian gradient and a Hessian-vector
  product within 1e-12 relative (unit and given weights);
- TNT from JAX's own ``initial_guess``: the same status and iteration
  count, x within 1e-8.  On the noiseless instance x is compared as is; on
  the noisy one the Hessian's gauge kernel (a global rigid motion) lets
  the inner CG counts part at round-off level, so x is compared after the
  optimal gauge alignment (``alignment_errors`` between the two results);
- ``initial_guess`` with both packages given one spectral start: the LSQR
  translations and the bearings within 1e-10;
- JAX's five tests (``tests/test_range_sync.py``) as contracts on the
  port's own instances at their sizes: noiseless recovery, ranges tighten
  the translations 1.5x, bearings match the geometry, the anchor gauge,
  the f32 tier;
- ``random_instance``'s shapes, dtypes and devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.models import range_sync as jrg
from optimization_tpu.models import rotation_sync as jrs
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import interop
from optimization_tpu_torch.core.types import TNTStatus
from optimization_tpu_torch.models import range_sync as trg
from optimization_tpu_torch.models import rotation_sync as trs
from optimization_tpu_torch.models.pose_sync import alignment_errors
from optimization_tpu_torch.solvers import tnt as ttnt

torch.set_num_threads(1)

F64 = torch.float64
JPARAMS = jtnt.TNTParams(
    max_iterations=100, gradient_tolerance=1e-9,
    relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
    preconditioned_gradient_tolerance=0.0)


def _jax_instance(seed, n, **kw):
    return jrg.random_instance(jax.random.PRNGKey(seed), n, 3, **kw)


def _to_torch(x):
    return tuple(torch.from_numpy(np.array(a)) for a in x)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _weighted(data):
    rng = np.random.default_rng(5)
    E, K = data.src.shape[0], data.rsrc.shape[0]
    return data._replace(kappa=jnp.asarray(rng.uniform(0.5, 2.0, E)),
                         tau=jnp.asarray(rng.uniform(0.5, 2.0, E)),
                         rho=jnp.asarray(rng.uniform(0.5, 2.0, K)))


@pytest.mark.parametrize("weights", ["unit", "given"])
def test_make_problem_matches_jax(weights):
    R_true, t_true, jd = _jax_instance(3, 20, n_ranges=40, noise=0.05,
                                       range_noise=0.001)
    if weights == "given":
        jd = _weighted(jd)
    td = interop.range_sync_data_from_jax(jd, device="cpu")
    # a point off the optimum on the product manifold
    key = jax.random.PRNGKey(11)
    R = jrs.ROTATIONS.retract(R_true, 0.1 * jax.random.normal(
        key, R_true.shape))
    t = t_true + 0.1 * jax.random.normal(key, t_true.shape)
    u = jax.random.normal(jax.random.PRNGKey(12), (jd.rsrc.shape[0], 3))
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    jx, tx = (R, t, u), _to_torch((R, t, u))
    jp, tp = jrg.make_problem(jd), trg.make_problem(td)
    assert _rel(tp.f(tx, None), jp.f(jx, None)) < 1e-12
    jg, tg = jp.rgrad(jx, None), tp.rgrad(tx, None)
    for a, b in zip(tg, jg):
        assert _rel(a, b) < 1e-12
    jh, th = jp.hvp(jx, jg, None), tp.hvp(tx, tg, None)
    for a, b in zip(th, jh):
        assert _rel(a, b) < 1e-12


@pytest.mark.parametrize("case", ["noiseless", "noisy"])
def test_tnt_from_jax_start_matches_jax(case):
    if case == "noiseless":
        n, kw = 12, dict(extra_edges=10, n_ranges=8, noise=0.0)
        _, _, jd = _jax_instance(0, n, **kw)
    else:
        n, kw = 20, dict(n_ranges=40, noise=0.05, range_noise=0.001)
        _, _, jd = _jax_instance(3, n, **kw)
    td = interop.range_sync_data_from_jax(jd, device="cpu")
    jx0 = jrg.initial_guess(jd, n, dtype=jnp.float64)
    jr = jtnt.solve(jrg.make_problem(jd), jx0, JPARAMS)
    tr = ttnt.solve(trg.make_problem(td), _to_torch(jx0),
                    interop.params_from_jax(JPARAMS))
    assert int(tr.status) == int(jr.status) == TNTStatus.GRADIENT
    assert int(tr.num_iterations) == int(jr.num_iterations)
    if case == "noiseless":
        for a, b in zip(tr.x, jr.x):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-8)
    else:
        rot_err, t_err = alignment_errors(tr.x[0], tr.x[1],
                                          np.asarray(jr.x[0]),
                                          np.asarray(jr.x[1]))
        assert float(rot_err) < 1e-8 and float(t_err) < 1e-8


def test_initial_guess_matches_jax_for_one_spectral_start(monkeypatch):
    n = 20
    R_true, _, jd = _jax_instance(3, n, n_ranges=40, noise=0.05,
                                  range_noise=0.001)
    td = interop.range_sync_data_from_jax(jd, device="cpu")
    # one spectral start for both: the truth, transposed, perturbed
    Q0 = np.swapaxes(np.asarray(jrs.ROTATIONS.retract(
        R_true, 0.05 * jax.random.normal(jax.random.PRNGKey(4),
                                         R_true.shape))), -1, -2)
    monkeypatch.setattr(jrs, "spectral_init",
                        lambda *a, **k: jnp.asarray(Q0))
    monkeypatch.setattr(trs, "spectral_init",
                        lambda *a, **k: torch.from_numpy(Q0.copy()))
    jR, jt, ju = jrg.initial_guess(jd, n, dtype=jnp.float64)
    tR, tt, tu = trg.initial_guess(td, n, dtype=F64,
                                   generator=torch.Generator())
    np.testing.assert_array_equal(tR.numpy(), np.asarray(jR))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-10)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-10)


def _solve(seed, n, **kw):
    dtype = kw.pop("dtype", F64)
    gen = torch.Generator().manual_seed(seed)
    R_true, t_true, data = trg.random_instance(gen, n, 3, dtype=F64,
                                               device="cpu", **kw)
    out = trg.solve_range_aided(data, n, dtype=dtype, generator=gen)
    rot_err, t_err = alignment_errors(out.R, out.t, R_true,
                                      t_true - t_true[0][None])
    return out, float(rot_err), float(t_err), data


def test_noiseless_exact_recovery():
    out, rot_err, t_err, _ = _solve(0, 12, extra_edges=10, n_ranges=8,
                                    noise=0.0)
    assert int(out.result.status) == TNTStatus.GRADIENT
    assert float(out.result.f) < 1e-18
    assert rot_err < 1e-9 and t_err < 1e-9
    assert float((torch.linalg.vector_norm(out.u, dim=-1) - 1.0).abs()
                 .max()) < 1e-12


def test_ranges_reduce_translation_error():
    gen = torch.Generator().manual_seed(3)
    n = 20
    R_true, t_true, data = trg.random_instance(
        gen, n, 3, extra_edges=0, n_ranges=40, noise=0.05,
        range_noise=0.001, dtype=F64, device="cpu")
    t_ref = t_true - t_true[0][None]
    out = trg.solve_range_aided(data, n, dtype=F64, generator=gen)
    _, t_err = alignment_errors(out.R, out.t, R_true, t_ref)
    data0 = data._replace(rho=torch.zeros_like(data.dists))
    out0 = trg.solve_range_aided(data0, n, dtype=F64, generator=gen)
    _, t_err0 = alignment_errors(out0.R, out0.t, R_true, t_ref)
    assert float(t_err) < float(t_err0) / 1.5, (t_err, t_err0)


def test_bearings_match_geometry():
    out, _, _, data = _solve(5, 10, extra_edges=6, n_ranges=12, noise=0.0)
    diff = out.t[data.rdst] - out.t[data.rsrc]
    diff = diff / torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    np.testing.assert_allclose(out.u.numpy(), diff.numpy(), atol=1e-8)


def test_anchor_gauge():
    out, _, _, _ = _solve(7, 8, extra_edges=4, n_ranges=5, noise=0.01,
                          range_noise=0.001)
    np.testing.assert_array_equal(out.t[0].numpy(), np.zeros(3))


def test_f32_tier():
    out, rot_err, t_err, _ = _solve(1, 10, extra_edges=8, n_ranges=8,
                                    noise=0.0, dtype=torch.float32)
    assert out.R.dtype == out.t.dtype == out.u.dtype == torch.float32
    assert float(out.result.f) < 1e-7
    assert rot_err < 1e-3 and t_err < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_random_instance_shapes_dtypes_devices(dtype):
    n, extra, K = 15, 9, 11
    gen = torch.Generator().manual_seed(2)
    R, t, data = trg.random_instance(gen, n, 3, extra_edges=extra,
                                     n_ranges=K, noise=0.01, dtype=dtype,
                                     device="cpu")
    E, Kk = data.src.shape[0], data.rsrc.shape[0]
    assert R.shape == (n, 3, 3) and t.shape == (n, 3)
    assert n - 1 <= E <= n - 1 + extra and Kk <= K
    assert data.Rij.shape == (E, 3, 3) and data.tij.shape == (E, 3)
    assert data.dists.shape == (Kk,) and bool((data.dists >= 1e-3).all())
    assert bool((data.src != data.dst).all())
    assert bool((data.rsrc != data.rdst).all())
    for a in (R, t, data.Rij, data.tij, data.dists):
        assert a.dtype == dtype and a.device.type == "cpu"
    for a in (data.src, data.dst, data.rsrc, data.rdst):
        assert a.dtype == torch.int64 and a.device.type == "cpu"
    assert data.kappa is data.tau is data.rho is None
    # the same generator state gives the same instance
    again = trg.random_instance(torch.Generator().manual_seed(2), n, 3,
                                extra_edges=extra, n_ranges=K, noise=0.01,
                                dtype=dtype, device="cpu")
    np.testing.assert_array_equal(again[2].Rij.numpy(), data.Rij.numpy())
    # the card is the default place: without one, a request for it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            trg.random_instance(None, n, 3)
