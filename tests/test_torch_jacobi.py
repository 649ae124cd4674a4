"""The port's ``jacobi_eigh`` == the JAX package's, on one numpy input.

``optimization_tpu_torch/linalg/jacobi.py`` against
``optimization_tpu/linalg/jacobi.py`` (and LAPACK through numpy): the
tournament permutation, graded spectra, odd n, a batch, ``v0``, ``sort``
and ``max_sweeps``.  Both run the same rotations in the same order, so
eigenvalues agree to a few roundings of ||A||; eigenvectors are compared up
to sign, column by column (distinct eigenvalues).  Tolerances:

- f64 eigenvalues vs JAX: 1e-13 ||A||_2 (the same rotation sequence; XLA
  may contract a multiply-add the eager loop rounds twice);
- f64 eigenvectors vs JAX: |V_t - s V_j| <= 1e-10, s the column sign
  (a rotation angle's rounding moves a vector by eps / gap);
- graded spectra: relative 1e-6 to the JAX eigenvalues, the accuracy the
  JAX test itself holds to LAPACK (the van der Sluis scaled condition
  ~1e10 times eps_f64);
- f32: 1e-5 ||A||_2 (Jacobi's O(n eps) backward error at n = 48).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optimization_tpu.linalg import jacobi as J
from optimization_tpu_torch.linalg import jacobi as T

torch.set_num_threads(1)


def _sym(rng, shape, dtype=np.float64):
    A = rng.standard_normal(shape)
    return (A + np.swapaxes(A, -1, -2)).astype(dtype)


def _both(A, **kw):
    wj, Vj = J.jacobi_eigh(jnp.asarray(A), **kw)
    v0 = kw.pop("v0", None)
    if v0 is not None:
        kw["v0"] = torch.from_numpy(np.asarray(v0))
    wt, Vt = T.jacobi_eigh(torch.from_numpy(A), **kw)
    return np.asarray(wj), np.asarray(Vj), wt.numpy(), Vt.numpy()


def _assert_vectors_match(Vt, Vj, atol):
    sign = np.sign(np.sum(Vt * Vj, axis=-2, keepdims=True))
    np.testing.assert_allclose(Vt, Vj * sign, rtol=0, atol=atol)


@pytest.mark.parametrize("n", [2, 4, 6, 10, 48, 64])
def test_tournament_perm_is_the_jax_one(n):
    np.testing.assert_array_equal(T._tournament_perm(n), J._tournament_perm(n))


@pytest.mark.parametrize("n,batch", [(2, ()), (5, ()), (7, (3, 2)),
                                     (12, (5,)), (48, (4,))])
def test_matches_jax_f64(n, batch):
    rng = np.random.default_rng(n)
    A = _sym(rng, batch + (n, n))
    wj, Vj, wt, Vt = _both(A)
    scale = np.max(np.abs(np.linalg.eigvalsh(A)))
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-13 * scale)
    np.testing.assert_allclose(wt, np.linalg.eigvalsh(A), rtol=0,
                               atol=1e-13 * scale)
    _assert_vectors_match(Vt, Vj, 1e-10)
    # the eigh contract on the port's own result
    res = A @ Vt - Vt * wt[..., None, :]
    assert np.max(np.abs(res)) <= 1e-12 * scale
    assert np.max(np.abs(np.swapaxes(Vt, -1, -2) @ Vt - np.eye(n))) <= 1e-12


def test_graded_spd_relative_accuracy():
    """The unit-diagonal near-singular Gram of the JAX test: the small
    eigenvalues keep their relative accuracy in both packages."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((48, 8))
    B = X @ X.T + 1e-8 * np.eye(48)
    dd = 1.0 / np.sqrt(np.diag(B))
    B = B * dd[:, None] * dd[None, :]
    wj, _, wt, _ = _both(B)
    np.testing.assert_allclose(wt, wj, rtol=1e-6)
    np.testing.assert_allclose(wt, np.linalg.eigvalsh(B), rtol=1e-5)


def test_logspace_graded_spectrum():
    """Eigenvalues 1e-6 .. 1e3 under a random rotation: both packages reach
    the same relative accuracy on the small end."""
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    lam = np.logspace(-6, 3, 16)
    A = (Q * lam) @ Q.T
    wj, _, wt, _ = _both(A)
    np.testing.assert_allclose(wt, wj, rtol=1e-6)
    np.testing.assert_allclose(wt, lam, rtol=1e-6)


def test_matches_jax_f32():
    rng = np.random.default_rng(1)
    A = _sym(rng, (4, 48, 48), np.float32)
    wj, _, wt, Vt = _both(A)
    assert wt.dtype == np.float32 and Vt.dtype == np.float32
    scale = np.max(np.abs(np.linalg.eigvalsh(A.astype(np.float64))))
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-5 * scale)


def test_warm_start_seed_composes():
    """``v0``: conjugate in, compose out — the same eigenpairs as the cold
    JAX solve, from a seed near the true eigenvectors."""
    rng = np.random.default_rng(3)
    A = _sym(rng, (4, 12, 12))
    w_ref, V_ref = np.linalg.eigh(A)
    P = rng.normal(size=(12, 12)) * 0.05
    Q, _ = np.linalg.qr(np.eye(12) + P - P.T)
    v0 = V_ref @ Q.T
    wj, Vj, wt, Vt = _both(A, v0=v0)
    np.testing.assert_allclose(wt, wj, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(wt, w_ref, rtol=1e-10, atol=1e-10)
    _assert_vectors_match(Vt, Vj, 1e-9)
    assert np.max(np.abs(A @ Vt - Vt * wt[..., None, :])) < 1e-8


def test_sort_false_and_sweep_cap():
    rng = np.random.default_rng(5)
    A = _sym(rng, (4, 10, 10))
    wj, Vj, wt, Vt = _both(A, sort=False)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-12 * np.abs(A).max())
    res = A @ Vt - Vt * wt[..., None, :]
    assert np.max(np.abs(res)) < 1e-12 * np.max(np.abs(A))
    # one sweep only: not converged, but the same unconverged diagonal
    wj1, _, wt1, _ = _both(A, max_sweeps=1, sort=False)
    np.testing.assert_allclose(wt1, wj1, rtol=0, atol=1e-12 * np.abs(A).max())
    assert np.max(np.abs(wt1 - wt)) > 1e-8


def test_batch_matches_singles():
    rng = np.random.default_rng(2)
    A = _sym(rng, (5, 12, 12))
    wb, _ = T.jacobi_eigh(torch.from_numpy(A))
    for i in range(5):
        wi, _ = T.jacobi_eigh(torch.from_numpy(A[i]))
        # lockstep batching may run extra sweeps for some instances
        np.testing.assert_allclose(wb[i].numpy(), wi.numpy(), rtol=0,
                                   atol=1e-12 * np.max(np.abs(wi.numpy())))


def test_degenerate_and_diagonal():
    Q, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((8, 8)))
    d = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 4.0, 4.0])
    A = (Q * d) @ Q.T
    wj, _, wt, Vt = _both(A)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-13 * 4)
    assert np.max(np.abs(A @ Vt - Vt * wt[None, :])) < 1e-12
    # already diagonal: no rotation, exact passthrough
    w, _ = T.jacobi_eigh(torch.diag(torch.tensor([3.0, -1.0, 2.0],
                                                 dtype=torch.float64)))
    np.testing.assert_array_equal(w.numpy(), [-1.0, 2.0, 3.0])
