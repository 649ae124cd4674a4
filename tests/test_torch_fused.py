"""The plain versions of the port's fused kernels == the JAX Pallas kernels.

``cg_dots``, ``axpy_selfdot``, ``diag_stencil_matvec`` and
``affine_stencil_matvec`` of ``optimization_tpu_torch/kernels/fused.py`` on
CPU tensors (their plain PyTorch versions, which the CUDA kernels are held
against on the card) against the Pallas kernels in interpret mode, at the
sizes of ``tests/test_kernels.py`` plus ragged ones, in f32 and f64, from
one numpy seed.  Tolerances, each with its reason:

- the reductions are f32 sums in both packages, added in other orders:
  within 2e-6 of sum |terms| (the f32 rounding of a sum of ~3e5 terms
  grows like log2(n) eps32, ~1e-6);
- elementwise results in the same dtype and operation order: within
  4 eps(dtype) of the magnitude of the terms (XLA may contract a multiply
  and an add into one rounding);
- the affine diagonal: the port builds d = a + b*i in f32 (one f32
  definition for kernel and plain version), the JAX kernel in v.dtype as
  (a + 2) + b*row + b*lane, so (d + 2) differs by a few f32 roundings of
  |d| + 2, times |v|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.kernels import fused as J
from optimization_tpu_torch.kernels import fused as T

torch.set_num_threads(1)

SIZES = [100, 1024, 4097, 12345, 300000]
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                      torch.float64)}
EPS32 = 2.0 ** -24


def _vecs(n, k, npdt, seed=0):
    rng = np.random.default_rng(seed + n)
    return [rng.normal(size=n).astype(npdt) for _ in range(k)]


def _eps(npdt):
    return float(np.finfo(npdt).eps)


def _is_f32_value(x: float) -> bool:
    return float(np.float32(x)) == x


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_cg_dots_matches_jax(n, dt):
    npdt, tdt = DTYPES[dt]
    p, hp, r = _vecs(n, 3, npdt)
    j = J.cg_dots(jnp.asarray(p), jnp.asarray(hp), jnp.asarray(r))
    before = T.cg_dots.launches
    t = T.cg_dots(torch.from_numpy(p), torch.from_numpy(hp),
                  torch.from_numpy(r))
    assert T.cg_dots.launches == before      # the plain version ran
    p64, hp64, r64 = (a.astype(np.float64) for a in (p, hp, r))
    for tv, jv, (u, v) in zip(t, j, ((p64, hp64), (hp64, hp64), (p64, p64),
                                     (p64, r64))):
        assert tv.dtype == tdt and tv.dim() == 0
        tol = 2e-6 * float(np.sum(np.abs(u * v)))
        assert abs(float(tv) - float(jv)) <= tol
        assert abs(float(tv) - float(np.dot(u, v))) <= tol
        # f64 vectors, f32 dots: the JAX contract (fused.py:76-82, 112)
        assert _is_f32_value(float(tv)) and _is_f32_value(float(jv))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_axpy_selfdot_matches_jax(n, dt):
    npdt, tdt = DTYPES[dt]
    x, y = _vecs(n, 2, npdt, seed=1)
    alpha = 0.37
    jo, jd = J.axpy_selfdot(alpha, jnp.asarray(x), jnp.asarray(y))
    to, td = T.axpy_selfdot(torch.tensor(alpha, dtype=torch.float64),
                            torch.from_numpy(x), torch.from_numpy(y))
    assert to.dtype == tdt and td.dtype == tdt and td.dim() == 0
    a = np.asarray(alpha, npdt)
    terms = np.abs(a * x) + np.abs(y)
    np.testing.assert_array_less(np.abs(to.numpy() - np.asarray(jo)),
                                 4 * _eps(npdt) * terms + 1e-300)
    o64 = to.numpy().astype(np.float64)
    tol = 2e-6 * float(np.sum(o64 * o64))
    assert abs(float(td) - float(jd)) <= tol
    assert _is_f32_value(float(td)) and _is_f32_value(float(jd))


def _stencil_terms(d, v, scale):
    v64 = v.astype(np.float64)
    up = np.concatenate([v64[1:], [0.0]])
    down = np.concatenate([[0.0], v64[:-1]])
    return (np.abs((d.astype(np.float64) + 2.0) * v64) + np.abs(up)
            + np.abs(down)) * abs(scale)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_diag_stencil_matvec_matches_jax(n, dt):
    npdt, tdt = DTYPES[dt]
    v, w = _vecs(n, 2, npdt, seed=2)
    d = (w * w + 1.0).astype(npdt)
    scale = 0.5
    j = np.asarray(J.diag_stencil_matvec(jnp.asarray(d), jnp.asarray(v),
                                         scale=scale))
    t = T.diag_stencil_matvec(torch.from_numpy(d), torch.from_numpy(v),
                              scale=scale)
    assert t.dtype == tdt and t.shape == (n,)
    np.testing.assert_array_less(np.abs(t.numpy() - j),
                                 4 * _eps(npdt) * _stencil_terms(d, v, scale)
                                 + 1e-300)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_affine_stencil_matvec_matches_jax(n, dt):
    npdt, tdt = DTYPES[dt]
    (v,) = _vecs(n, 1, npdt, seed=3)
    a, b, scale = 1.0, 999.0 / (n - 1), 0.5
    j = np.asarray(J.affine_stencil_matvec(jnp.asarray(v), a=a, b=b,
                                           scale=scale))
    t = T.affine_stencil_matvec(torch.from_numpy(v), a=a, b=b, scale=scale)
    assert t.dtype == tdt and t.shape == (n,)
    d = a + b * np.arange(n, dtype=np.float64)
    tol = (8 * EPS32 * (d + 2.0) * np.abs(v) * scale
           + 4 * _eps(npdt) * _stencil_terms(d, v, scale))
    np.testing.assert_array_less(np.abs(t.numpy() - j), tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_affine_is_the_stored_diagonal_it_generates(dt):
    """The affine stencil is the stored one with d = a + b*i in f32, bit for
    bit: the kernel's definition of its diagonal."""
    _, tdt = DTYPES[dt]
    n = 4097
    v = torch.from_numpy(_vecs(n, 1, DTYPES[dt][0], seed=4)[0])
    i = torch.arange(n, dtype=torch.float32)
    d = torch.tensor(3.5e-4, dtype=torch.float32) * i + torch.tensor(
        1.0, dtype=torch.float32)
    assert torch.equal(T.affine_stencil_matvec(v, a=1.0, b=3.5e-4, scale=2.0),
                       T.diag_stencil_matvec(d, v, scale=2.0))


def test_stencil_edges_and_tiny_n():
    """Zeros outside [0, n): the first and last rows see one neighbour; n = 1
    sees none."""
    v = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    d = torch.zeros(3, dtype=torch.float64)
    np.testing.assert_array_equal(T.diag_stencil_matvec(d, v).numpy(),
                                  [2 - 2, 4 - 3 - 1, 6 - 2])
    one = torch.tensor([5.0], dtype=torch.float64)
    assert float(T.diag_stencil_matvec(one, one)) == 35.0


def test_wrappers_reject_bad_inputs():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="one shape"):
        T.cg_dots(x, x, torch.ones(9))
    with pytest.raises(ValueError, match="flat"):
        T.axpy_selfdot(1.0, torch.ones(2, 4), torch.ones(2, 4))
    # neither CPU (plain version) nor CUDA (kernel): no silent route
    m = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.diag_stencil_matvec(m, m)
