"""The plain versions of the port's fused kernels == the JAX Pallas kernels.

``cg_dots``, ``axpy_selfdot``, ``diag_stencil_matvec``,
``affine_stencil_matvec``, ``stream3_probe`` and ``gram_pair`` of
``optimization_tpu_torch/kernels/fused.py`` on
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
  |d| + 2, times |v|;
- ``stream3_probe``: the same three roundings in the same order, equal bit
  for bit;
- ``gram_pair``: both cast to f32 and sum m products per entry in f32, in
  other orders (the JAX kernel block by block, torch's matmul in its own
  blocking): within 2e-6 of sum_r |S[r,i] X[r,j]| (~30 eps32; the rounding
  of an m-term f32 sum grows like sqrt(m) eps32 in practice);
  bf16 and f64 inputs become the same f32 values in both.
"""

import itertools
from pathlib import Path

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


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", [64, 1024, 4097])
def test_stream3_probe_matches_jax(n, dt):
    npdt, tdt = DTYPES[dt]
    v, w = _vecs(n, 2, npdt, seed=6)
    d = (w * w + 1.0).astype(npdt)
    j = np.asarray(J.stream3_probe(jnp.asarray(d), jnp.asarray(v), scale=0.5))
    before = T.stream3_probe.launches
    t = T.stream3_probe(torch.from_numpy(d), torch.from_numpy(v), scale=0.5)
    assert T.stream3_probe.launches == before
    assert t.dtype == tdt and t.shape == (n,)
    np.testing.assert_array_equal(t.numpy(), j)


# k > 64: LOBPCG's basis at nx = 33, 40 and 64, the card kernel's panel
# route, and the edges of its plan: k = 128 (two full slabs, one chunk),
# 129 (three slabs, two chunks, rows not 16-byte aligned), 256 (two full
# chunks); the plain version on the CPU has no panels, the contract is JAX's
GRAM_SHAPES = [(256, 8), (1000, 24), (513, 30), (300, 97), (600, 120),
               (451, 192), (700, 128), (700, 129), (400, 256)]
GRAM_INPUTS = {"f32": np.float32, "bf16": "bfloat16", "f64": np.float64}


def _gram_inputs(m, k, kind, seed=0):
    """(numpy S, AS, BS) of one input dtype; bf16 values made exactly
    representable (drawn in f32, rounded to bf16)."""
    rng = np.random.default_rng(seed + m + k)
    arrs = [rng.normal(size=(m, k)) for _ in range(3)]
    if kind == "bf16":
        return [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    return [a.astype(GRAM_INPUTS[kind]) for a in arrs]


def _to_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("kind", list(GRAM_INPUTS))
@pytest.mark.parametrize("m,k", GRAM_SHAPES)
def test_gram_pair_matches_jax(m, k, kind):
    S, AS, BS = _gram_inputs(m, k, kind)
    ja, jb = J.gram_pair(jnp.asarray(S), jnp.asarray(AS), jnp.asarray(BS))
    before = T.gram_pair.launches
    ta, tb = T.gram_pair(*(_to_torch(a) for a in (S, AS, BS)))
    assert T.gram_pair.launches == before      # the plain version ran
    S64 = np.abs(S.astype(np.float32).astype(np.float64))
    for t, j, X in ((ta, ja, AS), (tb, jb, BS)):
        assert t.dtype == torch.float32 and t.shape == (k, k)
        assert np.asarray(j).dtype == np.float32
        terms = S64.T @ np.abs(X.astype(np.float32).astype(np.float64))
        np.testing.assert_array_less(np.abs(t.numpy() - np.asarray(j)),
                                     2e-6 * terms + 1e-30)
        exact = (S.astype(np.float32).astype(np.float64).T
                 @ X.astype(np.float32).astype(np.float64))
        np.testing.assert_array_less(np.abs(t.numpy() - exact),
                                     2e-6 * terms + 1e-30)


@pytest.mark.parametrize("m,k", GRAM_SHAPES)
def test_gram_pair_with_S_as_BS_is_the_plain_version(m, k):
    """BS is S itself (LOBPCG without B, which the card's kernel reads once):
    on a CPU tensor the wrapper gives what the plain version gives on
    (S, AS, S.clone()), bit for bit."""
    S, AS, _ = (torch.from_numpy(a) for a in _gram_inputs(m, k, "f32"))
    ga, gb = T.gram_pair(S, AS, S)
    ra, rb = T.gram_pair_reference(S, AS, S.clone())
    assert torch.equal(ga, ra) and torch.equal(gb, rb)


def test_gram_pair_fleet_is_per_instance():
    """A (F, m, k) fleet gives the per-instance Grams: each (k, k) slice
    equals the single-instance result (the same f32 products and sums)."""
    rng = np.random.default_rng(9)
    S, AS, BS = (torch.from_numpy(rng.normal(size=(3, 300, 12)).astype(
        np.float32)) for _ in range(3))
    fa, fb = T.gram_pair(S, AS, BS)
    assert fa.shape == fb.shape == (3, 12, 12)
    for i in range(3):
        a, b = T.gram_pair(S[i], AS[i], BS[i])
        S64 = S[i].double().abs()
        for got, want, X in ((fa[i], a, AS[i]), (fb[i], b, BS[i])):
            tol = 2e-6 * (S64.mT @ X.double().abs())
            assert bool(((got.double() - want.double()).abs() <= tol).all())
    # BS may be S itself (B = None in LOBPCG): S'S, symmetric
    ga, gb = T.gram_pair(S[0], AS[0], S[0])
    torch.testing.assert_close(gb, S[0].mT @ S[0], rtol=0, atol=1e-4)


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
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.stream3_probe(m, m)
    g = torch.empty(16, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        T.gram_pair(g, g, g)
    with pytest.raises(ValueError, match="one shape"):
        T.gram_pair(torch.ones(16, 4), torch.ones(16, 4), torch.ones(16, 5))
    with pytest.raises(ValueError, match="one shape"):
        T.gram_pair(torch.ones(16), torch.ones(16), torch.ones(16))


# ---- gram_pair's launch plan (the host side of csrc/gram_pair.cu) ----


def _module(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan_shapes():
    """Every gram_pair shape held on the card: chip_smoke.py's phase 7 and
    test_torch_cuda.py's cases."""
    here = Path(__file__).resolve().parent
    cs = _module(here.parent / "chip_smoke.py", "_chip_smoke_shapes")
    cuda = _module(here / "test_torch_cuda.py", "_cuda_test_shapes")
    return sorted(set(cs.GRAM_SHAPES + cs.GRAM_WIDE + cs.GRAM_LONG)
                  | set(cuda.GRAM_CASES + cuda.GRAM_LONG))


PLAN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("shape", _plan_shapes(),
                         ids=["x".join(map(str, s)) for s in _plan_shapes()])
def test_gram_plan_fits_the_card(shape):
    """The plan of every card shape, f32 and bf16, BS distinct and BS = S,
    bases aligned or not: shared memory within the H100's 232,448 bytes a
    block, the cluster within the portable 8, the route by the rows'
    alignment, panels covering the output once, a ring of at least two
    stages, one wave of row streams."""
    m, k = shape[-2], shape[-1]
    fleet = shape[0] if len(shape) == 3 else 1
    for (dt, dtype), same, aligned in itertools.product(
            PLAN_DTYPES.items(), (False, True), (True, False)):
        p = T.gram_plan(m, k, dtype, same, fleet, aligned=aligned)
        size = 2 if dt == "bf16" else 4
        assert p.smem <= T.SMEM_CAP == 232_448
        assert 1 <= p.cluster <= 8
        row_aligned = aligned and (k * size) % 16 == 0
        assert (p.route == "tma2d") == row_aligned
        assert p.route in ("tma2d", "span", "rows")
        assert p.box_cols * size == 128
        # 64-column slabs of AS and BS by chunks of at most 128 S columns
        assert p.slabs * 64 >= k > (p.slabs - 1) * 64
        assert p.np % 16 == 0 and p.np <= 128 and p.chunks * p.np >= k
        assert (p.chunks - 1) * p.np < k
        assert p.panels == p.slabs * p.chunks
        assert p.reuse == (same and p.panels == 1)
        assert p.boxes == 2 * (64 // p.box_cols) + (
            0 if p.reuse else -(-p.np // p.box_cols))
        assert p.rows in (32, 64, 128) and 2 <= p.stages <= 8
        tiles = -(-m // p.rows)
        assert 1 <= p.grid <= tiles
        assert p.grid * p.panels * fleet <= 132 or p.grid == 1


def test_gram_plan_routes_and_edges():
    """The rows' alignment picks the route; spans that leave fewer than two
    stages go row by row; k = 64 is one panel, 65 two, 128 one chunk, 129
    two; BS = S shares S's slab only in one panel."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert T.gram_plan(100_000, 48, f32, True).route == "tma2d"
    assert T.gram_plan(100_000, 48, f32, True, aligned=False).route == "span"
    assert T.gram_plan(100_000, 97, f32, False).route == "span"
    assert T.gram_plan(100_000, 4, bf16, False).route == "span"   # 8 bytes
    assert T.gram_plan(100_000, 8, bf16, False).route == "tma2d"
    assert T.gram_plan(1000, 263, f32, False).route == "rows"
    assert T.gram_plan(1000, 263, bf16, False).route == "span"
    assert T.gram_plan(1000, 64, f32, True).panels == 1
    assert T.gram_plan(1000, 65, f32, True).panels == 2
    assert T.gram_plan(1000, 128, f32, True).chunks == 1
    assert T.gram_plan(1000, 129, f32, True).chunks == 2
    assert T.gram_plan(1000, 64, f32, True).reuse
    assert not T.gram_plan(1000, 65, f32, True).reuse
    # a fleet shares one wave: fewer row streams an instance
    assert T.gram_plan(10_000, 48, f32, False, 16).grid == 132 // 16
    with pytest.raises(ValueError, match=">= 1"):
        T.gram_plan(0, 48, f32, False)
