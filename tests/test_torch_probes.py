"""The plain versions of the probe kernels == the JAX probes.

``benchmarks/probe_pallas_stream.py``, ``probe_resident_kernel.py`` and
``probe_graph_stream.py`` are loaded as the JAX package's own test mode runs
them (``PROBE_TEST=1``: N = 2^13, 2^15 for the graph probe, the Pallas
kernels in interpret mode), and the same numpy inputs go through
``mk_pallas`` / ``mk_xla`` / ``mk_chunk_reader`` there and through the
port's wrappers, which on CPU tensors run the plain versions (the CUDA
kernels are held against these on the card: ``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: acc at the probes' own gates, 1e-5 relative for
``pinned_stream`` (f32 sums in other orders; the Pallas kernel starts acc
at 1 and the XLA arm at sum r^2, 4e-6 apart after 3 iterations) and 1e-3
for ``resident_body`` (a sum of order -6e9 with large cancellation between
the dots, bf16 storage); the returned vectors against a float64 numpy
transcription, norm to norm, 1e-6 in f32 and 1e-3 in bf16 (one storage
rounding, 2^-8 relative, flipped in a few elements an iteration; a
rounding left out altogether would show as ~4e-3).  The chunk reader:
within 1e-6 of the sum of |values read| (f32 sums of chunks in another
order), its LCG offsets equal to jnp's int32 expression.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu_torch import kernels as K
from optimization_tpu_torch.kernels import probes as P

torch.set_num_threads(1)

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
N = 1 << 13
ITER = 3


def _load(name, monkeypatch):
    monkeypatch.setenv("PROBE_TEST", "1")
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.TEST and mod.N == N
    return mod


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 1.0, N).astype(np.float32) for _ in range(3)]


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _pinned_f64(r, p, x, s, iterations):
    """The pinned-stream loop in float64 (the diagonal in f32, as every
    implementation generates it)."""
    n = r.shape[0]
    d = (np.float32(1.0) + np.float32(999.0 / (n - 1))
         * np.arange(n, dtype=np.float32)).astype(np.float64)
    r, p, x = (v.astype(np.float64) for v in (r, p, x))
    s = None if s is None else s.astype(np.float64)
    acc = 1.0
    for _ in range(iterations):
        a = 1e-12 * acc
        pn = -r + a * p
        rn = r + a * (d * pn) + a * a * x
        if s is not None:
            s = s + a * pn
        acc = np.sum(rn * rn) + np.sum(x * rn)
        r, p = rn, pn
    return r, p, s, acc


def _body_f64(r, p, x, iterations, store):
    """The CG chunk body in float64 with the storage rounding ``store``."""
    n = r.shape[0]
    a = (np.float32(1.0) + np.float32(999.0 / (n - 1))
         * np.arange(n, dtype=np.float32)).astype(np.float64)
    r, p, x = (v.astype(np.float64) for v in (r, p, x))
    dots = (np.sum(r * r), 0.0, 0.0, 0.0, 0.0, 0.0)
    for _ in range(iterations):
        rv, ar, nr, pa, m0, m1 = dots
        beta = 1e-7 * rv / (1.0 + abs(ar))
        crr = -1e-7 * rv / (1.0 + nr)
        c0 = 1e-9 * pa / (1.0 + abs(m0))
        c1 = 1e-9 * m1 / (1.0 + nr)
        rq = 500.0 + 1e-6 * rv
        a0 = 2.0 * a - rq
        u1 = 2.0 * a * x
        pn = -r + beta * p
        rn = r + crr * (a0 * pn + c0 * x + c1 * u1)
        a0r, a0p = a0 * rn, a0 * pn
        dots = (np.sum(rn * rn), np.sum(a0r * rn), np.sum(a0r * a0r),
                np.sum(a0r * a0p), np.sum(x * a0r), np.sum(u1 * a0r))
        r, p = store(rn), store(pn)
    return r, dots[0] + dots[3]


def _bf16(v):
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) \
        .to(torch.float64).numpy()


@pytest.mark.parametrize("with_s", [False, True], ids=["no-s", "with-s"])
def test_pinned_stream_matches_the_jax_probe(monkeypatch, with_s):
    mod = _load("probe_pallas_stream", monkeypatch)
    r, p, x = _inputs()
    s = np.zeros(N, np.float32)
    jargs = [jnp.asarray(v.reshape(mod.ROWS, 128)) for v in (r, p, x, s)]
    acc_pallas = float(mod.mk_pallas(ITER, with_s=with_s)(*jargs))
    acc_xla = float(mod.mk_xla(ITER, with_s=with_s)(*jargs))
    tr, tp, tx = (torch.from_numpy(v) for v in (r, p, x))
    ts = torch.from_numpy(s) if with_s else None
    out = K.pinned_stream(tr, tp, tx, ts, iterations=ITER)
    assert out[3].dtype == torch.float32 and out[3].shape == ()
    assert _rel(out[3], acc_pallas) <= 1e-5
    assert _rel(out[3], acc_xla) <= 1e-5
    # held / not held: the same function, bit for bit
    for kw in (dict(hold_x=False), dict(hold_x=True, l2_window=True)):
        again = K.pinned_stream(tr, tp, tx, ts, iterations=ITER, **kw)
        assert all(torch.equal(u, v) for u, v in zip(out, again)
                   if u is not None)
    want = _pinned_f64(r, p, x, s if with_s else None, ITER)
    for got, ref in zip(out[:3], want[:3]):
        if ref is None:
            assert got is None
            continue
        assert got.dtype == torch.float32 and got.shape == (N,)
        assert (np.linalg.norm(got.double().numpy() - ref)
                <= 1e-6 * np.linalg.norm(ref))
    assert _rel(out[3], want[3]) <= 1e-5
    assert K.pinned_stream.launches == 0     # CPU tensors never launch


def test_resident_body_matches_the_jax_probe(monkeypatch):
    mod = _load("probe_resident_kernel", monkeypatch)
    r, p, x = _inputs(1)
    jargs = [jnp.asarray(v.reshape(mod.ROWS, 128)).astype(jnp.bfloat16)
             for v in (r, p, x)]
    jargs.append(jnp.zeros((mod.ROWS, 128), jnp.bfloat16))
    acc_pallas = float(mod.mk_pallas(ITER)(*jargs))
    acc_xla = float(mod.mk_xla(ITER, with_s=False)(*jargs))
    tr, tp, tx = (torch.from_numpy(v).to(torch.bfloat16) for v in (r, p, x))
    r_out, acc = K.resident_body(tr, tp, tx, iterations=ITER)
    assert r_out.dtype == torch.bfloat16 and r_out.shape == (N,)
    assert acc.dtype == torch.float32 and acc.shape == ()
    assert _rel(acc, acc_pallas) <= 1e-3
    assert _rel(acc, acc_xla) <= 1e-3
    again = K.resident_body(tr, tp, tx, iterations=ITER, resident=False)
    assert torch.equal(r_out, again[0]) and torch.equal(acc, again[1])
    want_r, want_acc = _body_f64(_bf16(r), _bf16(p), _bf16(x), ITER, _bf16)
    assert (np.linalg.norm(r_out.double().numpy() - want_r)
            <= 1e-3 * np.linalg.norm(want_r))
    assert _rel(acc, want_acc) <= 1e-3
    assert K.resident_body.launches == 0


def test_resident_body_f32_storage():
    """f32 storage: no rounding of r and p, so the float64 transcription is
    met to 1e-6 norm to norm and acc to 1e-4 (cancellation between dots)."""
    r, p, x = _inputs(2)
    r_out, acc = K.resident_body(*(torch.from_numpy(v) for v in (r, p, x)),
                                 iterations=5)
    want_r, want_acc = _body_f64(r, p, x, 5, lambda v: v)
    assert r_out.dtype == torch.float32
    assert (np.linalg.norm(r_out.double().numpy() - want_r)
            <= 1e-6 * np.linalg.norm(want_r))
    assert _rel(acc, want_acc) <= 1e-4


@pytest.mark.parametrize("n", [100, 999, 4097])
def test_any_length(n):
    """n need not be a multiple of anything (the TPU probes need 128)."""
    rng = np.random.default_rng(n)
    r, p, x = (rng.uniform(0.5, 1.0, n).astype(np.float32) for _ in range(3))
    out = K.pinned_stream(*(torch.from_numpy(v) for v in (r, p, x)),
                          iterations=4)
    want = _pinned_f64(r, p, x, None, 4)
    assert (np.linalg.norm(out[0].double().numpy() - want[0])
            <= 1e-6 * np.linalg.norm(want[0]))
    assert _rel(out[3], want[3]) <= 1e-5
    rb, acc = K.resident_body(*(torch.from_numpy(v) for v in (r, p, x)),
                              iterations=4)
    want_r, want_acc = _body_f64(r, p, x, 4, lambda v: v)
    assert _rel(acc, want_acc) <= 1e-4 and rb.shape == (n,)


def test_wrappers_validate_and_never_take_a_silent_route():
    v = torch.ones(8)
    meta = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.pinned_stream(meta, meta, meta, iterations=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.resident_body(meta, meta, meta, iterations=2)
    with pytest.raises(ValueError, match="one device"):
        K.pinned_stream(v, v, meta, iterations=2)
    with pytest.raises(ValueError, match="float32"):
        K.pinned_stream(v.double(), v.double(), v.double(), iterations=2)
    with pytest.raises(ValueError, match="one dtype"):
        K.resident_body(v, v.bfloat16(), v, iterations=2)
    with pytest.raises(ValueError, match="bfloat16"):
        K.resident_body(v.half(), v.half(), v.half(), iterations=2)
    with pytest.raises(ValueError, match="one shape"):
        K.pinned_stream(v, v[:4], v, iterations=2)
    with pytest.raises(ValueError, match="one shape"):
        K.resident_body(v.reshape(2, 4), v.reshape(2, 4), v.reshape(2, 4),
                        iterations=2)
    with pytest.raises(ValueError, match="at least 2"):
        K.pinned_stream(v[:1], v[:1], v[:1], iterations=2)
    with pytest.raises(ValueError, match="iterations"):
        K.resident_body(v, v, v, iterations=0)
    assert P.pinned_stream.launches == 0 and P.resident_body.launches == 0


# ---- the graph probe's chunk reader ----


@pytest.fixture(scope="module")
def graph_probe():
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PROBE_TEST", "1")
        spec = importlib.util.spec_from_file_location(
            "_probe_probe_graph_stream", BENCH / "probe_graph_stream.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
    assert mod.TEST and mod.ROWS == 256
    return mod


@pytest.mark.parametrize("n_fetch", [1, 16])
@pytest.mark.parametrize("random_offsets", [False, True],
                         ids=["contiguous", "random"])
@pytest.mark.parametrize("gr", [8, 64])
def test_chunk_reader_matches_the_jax_probe(graph_probe, gr, random_offsets,
                                            n_fetch):
    v = np.random.default_rng(gr + n_fetch).standard_normal(
        (graph_probe.ROWS, 128)).astype(np.float32)
    want = float(np.asarray(graph_probe.mk_chunk_reader(
        gr, random_offsets, n_fetch)(jnp.asarray(v)))[0, 0])
    out = K.chunk_reader(torch.from_numpy(v), gr, random_offsets, n_fetch)
    assert out.shape == (1, 1) and out.dtype == torch.float32
    nch = graph_probe.ROWS // gr
    t = np.arange(n_fetch)
    off = ((np.abs((t * 1103515245 + 12345).astype(np.int32)) % nch)
           if random_offsets else t % nch)
    scale = np.abs(v.reshape(nch, -1)[off]).sum()
    assert abs(float(out) - want) <= 1e-6 * scale
    assert K.chunk_reader.launches == 0


def test_chunk_offsets_match_jnp_int32_lcg():
    """The LCG over a range of fetches holding t = 2,088,216,195, where
    h = INT32_MIN: jnp.abs keeps it negative and jnp's floor-% maps it into
    [0, nch) (3967 for nch = 4095)."""
    t0 = 2_088_216_195
    t = np.concatenate([np.arange(0, 2000),
                        np.arange(t0 - 1000, t0 + 1000),
                        np.arange((1 << 31) - 1000, 1 << 31)])
    for nch in (1, 7, 4095, 1 << 19):
        jt = jnp.asarray(t, jnp.int32)
        h = jt * jnp.int32(1103515245) + jnp.int32(12345)
        want = np.asarray(jnp.abs(h) % jnp.int32(nch))
        got = K.chunk_offsets(torch.from_numpy(t), nch).numpy()
        np.testing.assert_array_equal(got, want)
        assert ((got >= 0) & (got < nch)).all()
    got = K.chunk_offsets(torch.tensor([t0]), 4095)
    assert int(got) == 3967


def test_chunk_reader_start_and_ragged_rows():
    """Rows past nch * gr are never read; ``start`` continues the fetch
    sequence (the INT32_MIN fetch on a small v)."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1001, 128)).astype(np.float32))
    full = K.chunk_reader(v, 8, False, 125)
    np.testing.assert_allclose(float(full), float(v[:1000].sum()),
                               rtol=1e-5, atol=1e-3)
    a = K.chunk_reader(v, 1, True, 5,
                       start=2_088_216_193)
    off = K.chunk_offsets(torch.arange(2_088_216_193, 2_088_216_198), 1001)
    assert int(off[2]) == (-(1 << 31)) % 1001
    np.testing.assert_allclose(float(a), float(v[off].sum()), rtol=1e-6)


def test_chunk_reader_rejects_what_it_does_not_take():
    v = torch.ones(16, 128)
    with pytest.raises(ValueError, match="f32"):
        K.chunk_reader(v.double(), 1, False, 1)
    with pytest.raises(ValueError, match="rows, 128"):
        K.chunk_reader(torch.ones(16, 64), 1, False, 1)
    with pytest.raises(ValueError, match="gr <= rows"):
        K.chunk_reader(v, 17, False, 1)
    with pytest.raises(ValueError, match="gr <= rows"):
        K.chunk_reader(v, 0, False, 1)
    with pytest.raises(ValueError, match="n_fetch"):
        K.chunk_reader(v, 1, False, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        K.chunk_reader(v, 1, True, 2, start=(1 << 31) - 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.chunk_reader(torch.ones(128, 16).t(), 1, False, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.chunk_reader(torch.ones(16, 128, device="meta"), 1, False, 1)
