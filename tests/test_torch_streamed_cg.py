"""The streamed CG kernel's plain version == the JAX Pallas kernel.

``stpcg_flat_streamed_reference`` (what ``stpcg_flat_streamed`` runs on a
CPU tensor) against ``optimization_tpu``'s ``stpcg_flat_streamed`` in Pallas
interpret mode, at the JAX tests' size (N = 8192, chunk rows 16), f32 and
bf16, with and without the threaded init group, on the sphere Rayleigh
structure.  The inputs come from a numpy seed and go to both packages.

Tolerances are those of ``tests/test_streamed_cg.py``: where the run ends
within a few iterations (test_matches_flat_engine) iterations EQUAL, s
within 3e-5 |s|, M-norm rtol 2e-5, predicted decrease rtol 2e-3; on the
positive-definite multi-iteration fixture (test_interior_multi_iteration_
parity) iterations within 1, s within 2e-3 |s|, M-norm and predicted
decrease rtol 1e-3 — the two accumulate their f32 sums in another order and
CG may stop one step apart at the truncation threshold; bf16 storage
(test_bf16_storage_parity): iterations within 3, s within 3e-2 |s|.

With the elementwise preconditioner (``prec_chunk``/``prec``), the four
forms of P (the regularized Jacobi, its quarter power, the exact Jacobi and
a stored P) against the Pallas kernel folding the same P: f32 at the
tolerances of ``tests/test_streamed_cg.py::test_prec_matches_xla_prec_engine``
(iterations within 1, M-norm rtol 2e-4, s within 3e-4 |s|, predicted
decrease rtol 2e-3); bf16 storage within the bf16 tolerances above.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.kernels import streamed_cg as J
from optimization_tpu.linalg.flat_cg import flat_init_dots as j_init_dots
from optimization_tpu_torch.kernels import streamed_cg as T
from optimization_tpu_torch.linalg.flat_cg import (flat_init_dots,
                                                   sphere_rayleigh_flat,
                                                   stpcg_flat)

torch.set_num_threads(1)

CR = 16
N = 4 * CR * 128
B_PD = np.array([[1.0, 0.2], [0.2, 0.5]], np.float32)


def _fixture(kind, n=N):
    """(g, x, rq, B, b, solver kwargs) in f32 numpy: ``sphere`` is the true
    Rayleigh Hessian at a random point (spread 25), ``neg`` the same with
    spread 200 (negative curvature), ``pd`` the positive-definite operator
    of rq = 0.5 and B_PD (many interior iterations)."""
    seed, spread = {"sphere": (0, 25.0), "neg": (3, 200.0),
                    "pd": (7, 25.0)}[kind]
    b = spread / (n - 1)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x /= np.linalg.norm(x)
    a = np.float32(b) * np.arange(n, dtype=np.float32) + np.float32(1.0)
    y = 2.0 * a * x
    rq = np.float32(np.dot(x, y))
    g = (y - rq * x).astype(np.float32)
    B = np.array([[2 * rq, -1.0], [-1.0, 0.0]], np.float32)
    kw = dict(max_iterations=300, kappa_fgr=0.05, theta=0.5)
    if kind == "pd":
        rq, B = np.float32(0.5), B_PD
        kw = dict(max_iterations=400, kappa_fgr=1e-3, theta=0.9)
    elif kind == "neg":
        kw = dict(max_iterations=500, kappa_fgr=1e-8, theta=0.999)
    return g, x, rq, B, b, kw


def _a_chunk(b):
    def a_chunk(i0, aux):
        row = (jax.lax.broadcasted_iota(jnp.int32, (CR, 128), 0)
               .astype(jnp.float32) + jnp.float32(i0))
        lane = jax.lax.broadcasted_iota(jnp.int32, (CR, 128), 1).astype(
            jnp.float32)
        return 1.0 + jnp.float32(b) * (row * 128.0 + lane)
    return a_chunk


def _run_jax(g, x, rq, B, b, Delta, body, with_init, dtype, kw):
    a0c, weights, _ = J.sphere_rayleigh_streamed(_a_chunk(b))
    jg, jx = jnp.asarray(g).astype(dtype), jnp.asarray(x).astype(dtype)
    init = None
    if with_init:
        a = 1.0 + jnp.float32(b) * jnp.arange(g.shape[0], dtype=jnp.float32)
        A_elem = lambda v: a * v.astype(jnp.float32)
        A0 = lambda v: 2.0 * A_elem(v) - jnp.float32(rq) * v.astype(
            jnp.float32)
        init = j_init_dots(jg, A0, (jx, (jx, lambda v: 2.0 * A_elem(v))),
                           jnp.asarray(B))
    return J.stpcg_flat_streamed(
        jg, jx, jnp.asarray(B), Delta, aux_scalars=(jnp.float32(rq),),
        a0_chunk=a0c, weights=weights, chunk_rows=CR, interpret=True,
        body_kind=body, init=init, **kw)


def _run_torch(g, x, rq, B, b, Delta, body, with_init, dtype, kw,
               fn=T.stpcg_flat_streamed_reference, diag=None):
    diag = T.AffineDiagonal(1.0, b) if diag is None else diag
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    tg = torch.from_numpy(g).to(dtype)
    tx = torch.from_numpy(x).to(dtype)
    tB, trq = torch.from_numpy(B), torch.tensor(rq)
    init = None
    if with_init:
        a = T.AffineDiagonal(1.0, b).values(g.shape[0], "cpu")
        A_elem = lambda v: a * v.to(torch.float32)
        A0 = lambda v: 2.0 * A_elem(v) - trq * v.to(torch.float32)
        init = flat_init_dots(tg, A0, (tx, (tx, lambda v: 2.0 * A_elem(v))),
                              tB)
    return fn(tg, tx, tB, Delta, (trq,), a0_chunk=a0c, weights=weights,
              body_kind=body, init=init, **kw)


# (fixture, Delta, body, init, storage): ten interpret-mode Pallas runs
CASES = [
    ("sphere", 1e6, "pair", False, "f32"),
    ("sphere", 0.02, "single", True, "f32"),
    ("neg", 5.0, "pair", True, "f32"),
    ("pd", 1e6, "pair", False, "f32"),
    ("pd", 1e6, "single", True, "f32"),
    ("pd", 1.5, "pair", True, "f32"),
    ("pd", 0.5, "single", False, "f32"),
    ("pd", 1.0, "pair", False, "bf16"),
    ("pd", 1.0, "single", True, "bf16"),
    ("sphere", 0.5, "pair", True, "bf16"),
]


@pytest.mark.parametrize("kind,Delta,body,with_init,storage", CASES,
                         ids=[f"{c[0]}-{c[1]:g}-{c[2]}-init{int(c[3])}-"
                              f"{c[4]}" for c in CASES])
def test_plain_version_matches_pallas(kind, Delta, body, with_init,
                                      storage):
    g, x, rq, B, b, kw = _fixture(kind)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if storage == "bf16"
                else (jnp.float32, torch.float32))
    jr = _run_jax(g, x, rq, B, b, Delta, body, with_init, jdt, kw)
    tr = _run_torch(g, x, rq, B, b, Delta, body, with_init, tdt, kw)
    assert tr.s.dtype == tdt
    ki, kj = int(tr.num_iterations), int(jr.num_iterations)
    s_t = tr.s.float().numpy()
    s_j = np.asarray(jr.s, np.float32)
    scale = max(float(np.linalg.norm(s_j)), 1e-9)
    mn_t, mn_j = float(tr.update_step_M_norm), float(jr.update_step_M_norm)
    dm_t, dm_j = float(tr.predicted_decrease), float(jr.predicted_decrease)
    if storage == "bf16":
        assert abs(ki - kj) <= 3
        np.testing.assert_allclose(s_t, s_j, atol=3e-2 * scale)
    elif kind == "pd":
        assert abs(ki - kj) <= 1
        np.testing.assert_allclose(s_t, s_j, atol=2e-3 * scale)
        np.testing.assert_allclose(mn_t, mn_j, rtol=1e-3)
        np.testing.assert_allclose(dm_t, dm_j, rtol=1e-3)
    else:
        assert ki == kj
        np.testing.assert_allclose(s_t, s_j, atol=3e-5 * scale)
        np.testing.assert_allclose(mn_t, mn_j, rtol=2e-5)
        np.testing.assert_allclose(dm_t, dm_j, rtol=2e-3, atol=1e-8)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    g, x, rq, B, b, kw = _fixture("pd")
    before = T.stpcg_flat_streamed.launches
    args = (g, x, rq, B, b, 1e6, "pair", True, torch.float32, kw)
    via_wrapper = _run_torch(*args, fn=T.stpcg_flat_streamed)
    plain = _run_torch(*args)
    assert T.stpcg_flat_streamed.launches == before   # no kernel launch
    assert torch.equal(via_wrapper.s, plain.s)
    for a, c in zip(via_wrapper[1:], plain[1:]):
        assert torch.equal(a, c)
    assert int(plain.num_iterations) > 3


def test_ragged_n_and_stored_diagonal():
    """Any n (no chunk-multiple rule): the plain version on n = 8000 agrees
    with the port's flat engine on the same operator (f32 contract
    tolerances as above), and a stored diagonal gives bitwise the same
    result as the affine descriptor with the same values."""
    n = 8000
    g, x, rq, B, b, kw = _fixture("pd", n)
    args = (g, x, rq, B, b, 1e6, "pair", False, torch.float32, kw)
    res = _run_torch(*args)
    stored = _run_torch(*args, diag=T.AffineDiagonal(1.0, b).values(n, "cpu"))
    assert torch.equal(res.s, stored.s)
    a = T.AffineDiagonal(1.0, b).values(n, "cpu")
    A_elem = lambda v: a * v
    tx = torch.from_numpy(x)
    A0, U, _, _ = sphere_rayleigh_flat(tx, A_elem, rq=torch.tensor(rq))
    ref = stpcg_flat(torch.from_numpy(g), A0, U, torch.from_numpy(B), 1e6,
                     body_kind="single", **kw)
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= 1
    scale = float(torch.linalg.norm(ref.s))
    np.testing.assert_allclose(res.s.numpy(), ref.s.numpy(),
                               atol=2e-3 * scale)


@pytest.mark.parametrize("case", ["zero_gradient", "zero_iterations"])
def test_no_cg_step_gives_zero_step(case):
    """When no CG step is taken the port returns s = 0, as the JAX package's
    flat engine does.  (The JAX Pallas kernel never writes s then and
    returns its uninitialized buffer — NaN in interpret mode; see ROADMAP
    Queue 3.  The port fixes that rather than matching it.)"""
    g, x, rq, B, b, kw = _fixture("pd")
    if case == "zero_gradient":
        g = np.zeros_like(g)
    else:
        kw = dict(kw, max_iterations=0)
    res = _run_torch(g, x, rq, B, b, 1.0, "pair", False, torch.float32, kw)
    assert int(res.num_iterations) == 0
    assert not res.s.any()
    a = T.AffineDiagonal(1.0, b).values(N, "cpu")
    A_elem = lambda v: a * v
    A0, U, _, _ = sphere_rayleigh_flat(torch.from_numpy(x), A_elem,
                                       rq=torch.tensor(rq))
    flat = stpcg_flat(torch.from_numpy(g), A0, U, torch.from_numpy(B), 1.0,
                      **kw)
    assert torch.equal(res.s, flat.s)


def test_validation():
    g, x, rq, B, b, kw = _fixture("pd")
    tg, tx = torch.from_numpy(g), torch.from_numpy(x)
    a0c, weights, _ = T.sphere_rayleigh_streamed(T.AffineDiagonal(1.0, b))
    call = lambda **k: T.stpcg_flat_streamed(
        k.pop("g", tg), k.pop("x", tx), torch.from_numpy(B), 1.0,
        (torch.tensor(rq),), **{"a0_chunk": a0c, "weights": weights, **k})
    with pytest.raises(TypeError, match="chunk generators"):
        call(weights=(None, lambda i0, aux: 1.0))
    with pytest.raises(ValueError, match="storage dtype"):
        call(g=tg.double(), x=tx.double())
    with pytest.raises(ValueError, match="share the storage dtype"):
        call(x=tx.to(torch.bfloat16))
    with pytest.raises(ValueError, match="body_kind"):
        call(body_kind="triple")
    with pytest.raises(ValueError, match="stored diagonal"):
        bad = T.sphere_rayleigh_streamed(torch.ones(3))
        call(a0_chunk=bad[0], weights=bad[1])



# ------------------------------------------------------ preconditioning --

def _prec_forms(form, b, rq, n=N):
    """P in both packages: (JAX prec_chunk, JAX prec, port prec_chunk, port
    prec) for ``jacobi`` (|2a - rq| + 1)^(-1/2), ``quarter`` its square
    root (config13's half power), ``exact`` (2a - rq)^(-1/2) (positive
    definite fixtures only) and ``stored``, a P unrelated to a:
    (1 + (i mod 13)/4)^(-1/2), held as a tensor by the port."""
    a_chunk = _a_chunk(b)
    a_full = 1.0 + jnp.float32(b) * jnp.arange(n, dtype=jnp.float32)
    diag = T.AffineDiagonal(1.0, b)
    if form == "stored":
        def pj(idx):
            return jax.lax.rsqrt(1.0 + 0.25 * (idx % 13).astype(jnp.float32))

        def chunk(i0, aux):
            row = jax.lax.broadcasted_iota(jnp.int32, (CR, 128), 0) + i0
            lane = jax.lax.broadcasted_iota(jnp.int32, (CR, 128), 1)
            return pj(row * 128 + lane)

        pv = torch.rsqrt(1.0 + 0.25 * (torch.arange(n) % 13).float())
        pfull = pj(jnp.arange(n, dtype=jnp.int32))
        return chunk, (lambda v: v * pfull), pv, T.stored_prec_map(pv)
    c, e = {"jacobi": (1.0, 0.5), "quarter": (1.0, 0.25),
            "exact": (0.0, 0.5)}[form]

    def jp_of(a, r):
        d = 2.0 * a - r if form == "exact" else jnp.abs(2.0 * a - r) + c
        return jax.lax.rsqrt(d if e == 0.5 else jnp.sqrt(d))

    desc = T.JacobiPower(c, e)
    return ((lambda i0, aux: jp_of(a_chunk(i0, aux), aux[0])),
            (lambda v: v * jp_of(a_full, jnp.float32(rq))),
            desc, desc.map(diag, torch.tensor(rq), n, "cpu"))


# (fixture, P, Delta, body, storage): every P form, Delta, body and storage
PREC_CASES = [
    ("sphere", "jacobi", 1e6, "single", "f32"),
    ("sphere", "jacobi", 0.5, "pair", "f32"),
    ("sphere", "jacobi", 0.02, "single", "f32"),
    ("sphere", "quarter", 1e6, "pair", "f32"),
    ("sphere", "quarter", 0.02, "single", "bf16"),
    ("sphere", "stored", 0.02, "pair", "f32"),
    ("sphere", "jacobi", 0.5, "pair", "bf16"),
    ("pd", "jacobi", 1e6, "pair", "f32"),
    ("pd", "quarter", 0.5, "single", "f32"),
    ("pd", "exact", 1e6, "pair", "f32"),
    ("pd", "exact", 0.5, "single", "bf16"),
    ("pd", "stored", 1e6, "single", "f32"),
    ("pd", "stored", 0.5, "pair", "bf16"),
    ("pd", "jacobi", 0.02, "pair", "bf16"),
]


@pytest.mark.parametrize("kind,form,Delta,body,storage", PREC_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]:g}-{c[3]}-{c[4]}"
                              for c in PREC_CASES])
def test_prec_plain_version_matches_pallas(kind, form, Delta, body,
                                           storage):
    g, x, rq, B, b, kw = _fixture(kind)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if storage == "bf16"
                else (jnp.float32, torch.float32))
    jpc, jpf, tpc, tpf = _prec_forms(form, b, rq)
    a0c, weights, _ = J.sphere_rayleigh_streamed(_a_chunk(b))
    jr = J.stpcg_flat_streamed(
        jnp.asarray(g).astype(jdt), jnp.asarray(x).astype(jdt),
        jnp.asarray(B), Delta, aux_scalars=(jnp.float32(rq),),
        a0_chunk=a0c, weights=weights, chunk_rows=CR, interpret=True,
        body_kind=body, prec_chunk=jpc, prec=jpf, **kw)
    ta0, tw, _ = T.sphere_rayleigh_streamed(T.AffineDiagonal(1.0, b))
    tr = T.stpcg_flat_streamed_reference(
        torch.from_numpy(g).to(tdt), torch.from_numpy(x).to(tdt),
        torch.from_numpy(B), Delta, (torch.tensor(rq),), a0_chunk=ta0,
        weights=tw, body_kind=body, prec_chunk=tpc, prec=tpf, **kw)
    assert tr.s.dtype == tdt
    ki, kj = int(tr.num_iterations), int(jr.num_iterations)
    s_t, s_j = tr.s.float().numpy(), np.asarray(jr.s, np.float32)
    scale = max(float(np.linalg.norm(s_j)), 1e-9)
    if storage == "bf16":
        assert abs(ki - kj) <= 3
        np.testing.assert_allclose(s_t, s_j, atol=3e-2 * scale)
        return
    assert abs(ki - kj) <= 1
    np.testing.assert_allclose(s_t, s_j, atol=3e-4 * scale)
    np.testing.assert_allclose(float(tr.update_step_M_norm),
                               float(jr.update_step_M_norm), rtol=2e-4)
    np.testing.assert_allclose(float(tr.predicted_decrease),
                               float(jr.predicted_decrease), rtol=2e-3,
                               atol=1e-8)


def test_exact_jacobi_collapses_to_the_closed_form():
    """tests/test_streamed_cg.py::test_prec_cuts_iterations_on_ill_
    conditioned_fixture in the port: on a spread-4000 positive-definite
    diagonal with B = 0, the exact Jacobi P turns H into the identity: at
    most 2 CG iterations (at least 10x fewer than without P) and s = -g /
    (2a - rq) within 1e-5 |s|."""
    spread = 4000.0
    b = spread / (N - 1)
    rng = np.random.default_rng(13)
    x = rng.standard_normal(N).astype(np.float32)
    x /= np.linalg.norm(x)
    g = rng.standard_normal(N).astype(np.float32)
    diag = T.AffineDiagonal(1.0, b)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    rq = torch.tensor(0.5)
    desc = T.JacobiPower(0.0, 0.5)
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=400,
              kappa_fgr=1e-6, theta=0.0)
    args = (torch.from_numpy(g), torch.from_numpy(x), torch.zeros(2, 2),
            1e6, (rq,))
    plain = T.stpcg_flat_streamed(*args, **kw)
    prec = T.stpcg_flat_streamed(*args, prec_chunk=desc,
                                 prec=desc.map(diag, rq, N, "cpu"), **kw)
    assert int(prec.num_iterations) <= 2
    assert int(plain.num_iterations) >= 10 * int(prec.num_iterations)
    s_true = -g / (2.0 * diag.values(N, "cpu").numpy() - 0.5)
    np.testing.assert_allclose(prec.s.numpy(), s_true,
                               atol=1e-5 * np.linalg.norm(s_true))


def test_prec_validation():
    """The JAX package's rules (tests/test_streamed_cg.py::
    test_prec_validation): both forms or neither, and no init=; and the
    port's descriptor rules."""
    g, x, rq, B, b, kw = _fixture("pd")
    tg, tx = torch.from_numpy(g), torch.from_numpy(x)
    diag = T.AffineDiagonal(1.0, b)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    desc = T.JacobiPower()
    pmap = desc.map(diag, torch.tensor(rq), N, "cpu")
    call = lambda **k: T.stpcg_flat_streamed(
        tg, tx, torch.from_numpy(B), 1.0, (torch.tensor(rq),),
        **{"a0_chunk": a0c, "weights": weights, **k})
    with pytest.raises(ValueError, match="both forms"):
        call(prec_chunk=desc)
    with pytest.raises(ValueError, match="both forms"):
        call(prec=pmap)
    a = diag.values(N, "cpu")
    A0 = lambda v: 2.0 * a * v - float(rq) * v
    init = flat_init_dots(tg, A0, (tx, (tx, lambda v: 2.0 * a * v)),
                          torch.from_numpy(B))
    with pytest.raises(ValueError, match="init"):
        call(prec_chunk=desc, prec=pmap, init=init)
    with pytest.raises(TypeError, match="generators"):
        call(prec_chunk=lambda i0, aux: 1.0, prec=pmap)
    with pytest.raises(ValueError, match="e = 1/2 or 1/4"):
        call(prec_chunk=T.JacobiPower(1.0, 1.0), prec=pmap)
    with pytest.raises(ValueError, match="stored preconditioner"):
        call(prec_chunk=torch.ones(3), prec=pmap)


def test_prec_must_be_the_descriptors_own_map():
    """The kernel un-transforms its step from ``prec_chunk`` and never calls
    ``prec``; the plain version un-transforms with ``prec``.  So a ``prec``
    that is not recognisably the descriptor's own map is refused on both
    routes: a bare callable, the map of another descriptor, diagonal or aux
    scalar, a stored p's map beside a generated descriptor.  The matching
    map (another object of equal descriptor, diagonal and aux value) still
    gives the Pallas kernel's s."""
    g, x, rq, B, b, kw = _fixture("pd")
    tg, tx = torch.from_numpy(g), torch.from_numpy(x)
    diag = T.AffineDiagonal(1.0, b)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    desc = T.JacobiPower(1.0, 0.25)
    aux = (torch.tensor(rq),)
    p = torch.rsqrt(1.0 + 0.25 * (torch.arange(N) % 13).float())

    def call(fn, prec_chunk, prec):
        return fn(tg, tx, torch.from_numpy(B), 0.5, aux, a0_chunk=a0c,
                  weights=weights, prec_chunk=prec_chunk, prec=prec, **kw)

    good = desc.map(diag, torch.tensor(rq), N, "cpu")
    assert isinstance(good, T.PrecMap)
    pv = good.values()
    wrong = [
        lambda v: v * pv,                                   # a bare callable
        T.JacobiPower(1.0, 0.5).map(diag, aux[0], N, "cpu"),
        T.JacobiPower(2.0, 0.25).map(diag, aux[0], N, "cpu"),
        desc.map(T.AffineDiagonal(1.0, 2 * b), aux[0], N, "cpu"),
        desc.map(diag, torch.tensor(rq + 1.0), N, "cpu"),
        desc.map(diag.values(N, "cpu"), aux[0], N, "cpu"),  # another diagonal
        T.stored_prec_map(p),
    ]
    for fn in (T.stpcg_flat_streamed, T.stpcg_flat_streamed_reference):
        for prec in wrong:
            with pytest.raises(ValueError, match="own|itself"):
                call(fn, desc, prec)
        for prec in (good, lambda v: v * p, T.stored_prec_map(p.clone())):
            with pytest.raises(ValueError, match="itself"):
                call(fn, p, prec)
        call(fn, p, T.stored_prec_map(p))

    # the matching map: equal values, not the same objects
    jpc, jpf, _, _ = _prec_forms("quarter", b, rq)
    ja0, jw, _ = J.sphere_rayleigh_streamed(_a_chunk(b))
    jr = J.stpcg_flat_streamed(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(B), 0.5,
        aux_scalars=(jnp.float32(rq),), a0_chunk=ja0, weights=jw,
        chunk_rows=CR, interpret=True, prec_chunk=jpc, prec=jpf, **kw)
    tr = call(T.stpcg_flat_streamed, T.JacobiPower(1.0, 0.25),
              T.JacobiPower(1.0, 0.25).map(T.AffineDiagonal(1.0, b),
                                           torch.tensor(rq), N, "cpu"))
    assert abs(int(tr.num_iterations) - int(jr.num_iterations)) <= 1
    s_j = np.asarray(jr.s, np.float32)
    np.testing.assert_allclose(tr.s.numpy(), s_j,
                               atol=3e-4 * float(np.linalg.norm(s_j)))


# ---------------------------------------------------- the general rank k --
#
# H = diag(a0) + U B U', U = (w_1 .* x, ..., w_k .* x).  Each per-element
# term is a function of the index i (and of the aux scalars), written once
# for JAX's chunk generators and once for the port, which takes it as a
# descriptor (AffineDiagonal, ShiftedDiagonal, ScaledDiagonal), a stored
# tensor or a wrapped whole-array callable (ElementwiseFn).  A Pallas kernel
# cannot capture an array, so "stored" terms are index formulas on the JAX
# side and their values, as a tensor, on the port's.  The aux scalars are
# (0.5, 0.75): aux[0] is what ShiftedDiagonal subtracts, aux[1] the wrapped
# callables' coefficient.

AUX = (0.5, 0.75)
B_SPREAD = 8.0 / (N - 1)


def _idx(i0):
    row = jax.lax.broadcasted_iota(jnp.int32, (CR, 128), 0) + i0
    lane = jax.lax.broadcasted_iota(jnp.int32, (CR, 128), 1)
    return row * 128 + lane


def _term_pair(form):
    """(JAX chunk generator or None, port descriptor) of one term:
    ``affine`` 1 + b i, ``twice`` its double (ScaledDiagonal), ``shifted``
    2(1 + b i) - aux[0] (ShiftedDiagonal), ``stored`` 1 + (i mod 13)/4
    (a tensor), ``fn`` 0.5 + aux[1] (i mod 97)/8 (an ElementwiseFn), ``one``
    the weight 1 (None)."""
    aff = T.AffineDiagonal(1.0, B_SPREAD)
    if form == "one":
        return None, None
    if form in ("affine", "twice", "shifted"):
        def base(i0, aux):
            # a jnp scalar made outside the generator would be a
            # captured constant, which pallas_call refuses
            return 1.0 + jnp.float32(B_SPREAD) * _idx(i0).astype(jnp.float32)
        chunk = {"affine": base,
                 "twice": lambda i0, aux: 2.0 * base(i0, aux),
                 "shifted": lambda i0, aux: 2.0 * base(i0, aux) - aux[0]}
        port = {"affine": aff, "twice": T.ScaledDiagonal(aff),
                "shifted": T.ShiftedDiagonal(aff)}
        return chunk[form], port[form]
    if form == "stored":
        return ((lambda i0, aux: 1.0 + 0.25 * (_idx(i0) % 13).astype(
                    jnp.float32)),
                1.0 + 0.25 * (torch.arange(N) % 13).float())
    assert form == "fn"
    return ((lambda i0, aux: 0.5 + aux[1] * ((_idx(i0) % 97).astype(
                jnp.float32) / 8.0)),
            T.ElementwiseFn(lambda i, aux: 0.5 + aux[1] * (
                (i % 97).float() / 8.0)))


def _term_values(form):
    """The term's (n,) f32 values (numpy), as the port evaluates them."""
    _, d = _term_pair(form)
    aux = tuple(torch.tensor(a) for a in AUX)
    if d is None:
        return np.ones(N, np.float32)
    if isinstance(d, T.ShiftedDiagonal):
        v = 2.0 * d.a.values(N, "cpu") - aux[0]
    elif isinstance(d, T.ScaledDiagonal):
        v = 2.0 * d.a.values(N, "cpu")
    elif isinstance(d, T.AffineDiagonal):
        v = d.values(N, "cpu")
    elif isinstance(d, T.ElementwiseFn):
        v = d.values(N, aux, "cpu")
    else:
        v = d
    return v.numpy()


def _gen_inputs(k, seed, indefinite=False):
    """(g, x, B) in f32 numpy: a random unit g and unit x (the unconstrained
    step is O(1), so Delta = 0.5-5 is met after some interior iterations),
    and a k x k B, positive semi-definite (many interior iterations) or with
    a negative eigenvalue (a negative-curvature exit)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(N).astype(np.float32)
    g /= np.linalg.norm(g)
    x = rng.standard_normal(N).astype(np.float32)
    x /= np.linalg.norm(x)
    G = rng.standard_normal((k, k))
    B = 0.3 * G @ G.T / k
    if indefinite:
        B = B - 4.0 * np.eye(k)
    return g, x, B.astype(np.float32)


def _gen_run(g, x, B, a0_form, w_forms, Delta, body, with_init, storage,
             prec_form=None, fn=T.stpcg_flat_streamed_reference):
    """The JAX kernel (interpret mode) and the port on one subproblem."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if storage == "bf16"
                else (jnp.float32, torch.float32))
    ja0, ta0 = _term_pair(a0_form)
    jw, tw = zip(*[_term_pair(f) for f in w_forms])
    jg, jx = jnp.asarray(g).astype(jdt), jnp.asarray(x).astype(jdt)
    tg, tx = torch.from_numpy(g).to(tdt), torch.from_numpy(x).to(tdt)
    jaux = tuple(jnp.float32(a) for a in AUX)
    taux = tuple(torch.tensor(a) for a in AUX)
    kw = dict(max_iterations=300, kappa_fgr=1e-3, theta=0.9,
              body_kind=body)
    jkw, tkw = dict(kw), dict(kw)
    if with_init:
        a0v = _term_values(a0_form)
        ws = [_term_values(f) for f in w_forms]
        for pkg, gv, xv, Bv, arr, init_dots, kwd in (
                (jnp, jg, jx, jnp.asarray(B), jnp.asarray, j_init_dots, jkw),
                (torch, tg, tx, torch.from_numpy(B), torch.from_numpy,
                 flat_init_dots, tkw)):
            f32 = pkg.float32
            a0a = arr(a0v)
            U = tuple(arr(w) * (xv.astype(f32) if pkg is jnp
                                else xv.to(f32)) for w in ws)
            A0 = (lambda v, a0a=a0a, pkg=pkg, f32=f32: a0a * (
                v.astype(f32) if pkg is jnp else v.to(f32)))
            kwd["init"] = init_dots(gv, A0, U, Bv)
    if prec_form is not None:
        jpc, jpf, tpc, tpf = _gen_prec(prec_form, a0_form, ta0, taux)
        jkw.update(prec_chunk=jpc, prec=jpf)
        tkw.update(prec_chunk=tpc, prec=tpf)
    jr = J.stpcg_flat_streamed(jg, jx, jnp.asarray(B), Delta,
                               aux_scalars=jaux, a0_chunk=ja0, weights=jw,
                               chunk_rows=CR, interpret=True, **jkw)
    tr = fn(tg, tx, torch.from_numpy(B), Delta, taux, a0_chunk=ta0,
            weights=tw, **tkw)
    return jr, tr


def _gen_prec(form, a0_form, ta0, taux):
    """P in both packages on the operator's A0: (JAX prec_chunk, JAX prec,
    port prec_chunk, port prec).  ``jacobi`` and ``quarter`` are the
    JacobiPower (|a0| + 1)^(-1/2), ^(-1/4); ``stored`` is a P unrelated to
    A0, (1 + (i mod 13)/4)^(-1/2); ``fn`` is one from a wrapped callable,
    (1 + aux[1] (i mod 5))^(-1/2)."""
    a0_chunk, _ = _term_pair(a0_form)
    a0_full = jnp.asarray(_term_values(a0_form))
    if form in ("jacobi", "quarter"):
        e = 0.5 if form == "jacobi" else 0.25

        def jp(a0):
            d = jnp.abs(a0) + 1.0
            return jax.lax.rsqrt(d if e == 0.5 else jnp.sqrt(d))

        desc = T.JacobiPower(1.0, e)
        return ((lambda i0, aux: jp(a0_chunk(i0, aux))),
                (lambda v: v * jp(a0_full)), desc,
                T.prec_map(desc, ta0, taux, N, "cpu"))
    if form == "stored":
        def pj(idx):
            return jax.lax.rsqrt(1.0 + 0.25 * (idx % 13).astype(jnp.float32))

        pv = torch.rsqrt(1.0 + 0.25 * (torch.arange(N) % 13).float())
        return ((lambda i0, aux: pj(_idx(i0))),
                (lambda v: v * pj(jnp.arange(N, dtype=jnp.int32))), pv,
                T.stored_prec_map(pv))
    assert form == "fn"

    def pj(idx, aux):
        return jax.lax.rsqrt(1.0 + aux[1] * (idx % 5).astype(jnp.float32))

    full = pj(jnp.arange(N, dtype=jnp.int32), tuple(jnp.float32(a)
                                                    for a in AUX))
    desc = T.ElementwiseFn(
        lambda i, aux: torch.rsqrt(1.0 + aux[1] * (i % 5).float()))
    return ((lambda i0, aux: pj(_idx(i0), aux)), (lambda v: v * full),
            desc, T.prec_map(desc, ta0, taux, N, "cpu"))


def _assert_gen_parity(jr, tr, storage, prec=False):
    """The parity tests' tolerances (module docstring): bf16 iterations
    within 3 and s within 3e-2 |s|; f32 iterations within 1 and s within
    2e-3 |s|, M-norm and predicted decrease rtol 1e-3 (the long
    multi-iteration runs of test_interior_multi_iteration_parity); f32 with
    P those of test_prec_matches_xla_prec_engine (s within 3e-4 |s|, M-norm
    rtol 2e-4, predicted decrease rtol 2e-3)."""
    ki, kj = int(tr.num_iterations), int(jr.num_iterations)
    s_t, s_j = tr.s.float().numpy(), np.asarray(jr.s, np.float32)
    scale = max(float(np.linalg.norm(s_j)), 1e-9)
    assert np.isfinite(s_t).all()
    if storage == "bf16":
        assert abs(ki - kj) <= 3, (ki, kj)
        np.testing.assert_allclose(s_t, s_j, atol=3e-2 * scale)
        return
    assert abs(ki - kj) <= 1, (ki, kj)
    mn_t, mn_j = float(tr.update_step_M_norm), float(jr.update_step_M_norm)
    dm_t, dm_j = float(tr.predicted_decrease), float(jr.predicted_decrease)
    if prec:
        np.testing.assert_allclose(s_t, s_j, atol=3e-4 * scale)
        np.testing.assert_allclose(mn_t, mn_j, rtol=2e-4)
        np.testing.assert_allclose(dm_t, dm_j, rtol=2e-3, atol=1e-8)
    else:
        np.testing.assert_allclose(s_t, s_j, atol=2e-3 * scale)
        np.testing.assert_allclose(mn_t, mn_j, rtol=1e-3)
        np.testing.assert_allclose(dm_t, dm_j, rtol=1e-3, atol=1e-8)


# (a0, weights, Delta, body, init, storage, B indefinite): k = 1, 3, 4, 5,
# 6, 8, every term form in a0 and in the weights (k >= 5 is the card's
# csrc/streamed_cg_any.cu)
GEN_CASES = [
    ("affine", ("one",), 1e6, "pair", False, "f32", False),
    ("stored", ("stored",), 1.0, "single", True, "bf16", False),
    ("fn", ("twice",), 0.5, "pair", True, "f32", True),
    ("shifted", ("one", "twice", "stored"), 1e6, "pair", True, "f32", False),
    ("fn", ("fn", "one", "affine"), 0.4, "single", False, "f32", False),
    ("shifted", ("one", "twice", "stored"), 1.0, "pair", False, "bf16",
     False),
    ("stored", ("one", "twice", "fn"), 5.0, "single", False, "f32", True),
    ("stored", ("one", "twice", "stored", "fn"), 1e6, "pair", False, "f32",
     False),
    ("affine", ("stored", "fn", "one", "twice"), 0.5, "single", True, "f32",
     False),
    ("fn", ("one", "twice", "stored", "fn"), 0.4, "pair", True, "bf16",
     False),
    ("shifted", ("one", "twice", "stored", "fn", "affine"), 1e6, "pair",
     False, "f32", False),
    ("fn", ("one", "twice", "stored", "fn", "affine", "stored"), 1e6, "pair",
     True, "f32", False),
    ("shifted", ("stored", "one", "fn", "twice", "affine", "one"), 0.5,
     "single", False, "bf16", False),
    ("affine", ("one", "twice", "stored", "fn", "affine", "stored", "fn",
                "twice"), 1e6, "single", False, "f32", False),
    ("stored", ("fn", "one", "affine", "twice", "stored", "one", "fn",
                "stored"), 5.0, "pair", False, "f32", True),
    ("fn", ("twice", "stored", "one", "affine", "fn", "stored", "twice",
            "one"), 0.4, "pair", True, "bf16", False),
]


@pytest.mark.parametrize(
    "a0,ws,Delta,body,with_init,storage,indef", GEN_CASES,
    ids=[f"k{len(c[1])}-{c[0]}-{'.'.join(c[1])}-{c[2]:g}-{c[3]}-"
         f"init{int(c[4])}-{c[5]}{'-indef' if c[6] else ''}"
         for c in GEN_CASES])
def test_general_k_plain_version_matches_pallas(a0, ws, Delta, body,
                                                with_init, storage, indef):
    g, x, B = _gen_inputs(len(ws), seed=len(ws) + 10 * int(indef),
                          indefinite=indef)
    jr, tr = _gen_run(g, x, B, a0, ws, Delta, body, with_init, storage)
    assert tr.s.dtype == (torch.bfloat16 if storage == "bf16"
                          else torch.float32)
    if storage == "f32" and not indef and Delta >= 1e6:
        assert int(tr.num_iterations) > 3       # a multi-iteration run
    _assert_gen_parity(jr, tr, storage)


# (P, a0, weights, Delta, body, storage): every prec_chunk form at k = 1, 3,
# 4, and k = 6
GEN_PREC_CASES = [
    ("jacobi", "shifted", ("one", "twice", "stored"), 1e6, "pair", "f32"),
    ("quarter", "fn", ("one", "fn", "affine"), 0.5, "single", "bf16"),
    ("stored", "stored", ("one", "twice", "stored", "fn"), 0.6, "single",
     "f32"),
    ("fn", "affine", ("stored",), 1e6, "pair", "f32"),
    ("quarter", "stored", ("one", "twice", "fn", "affine"), 1e6, "pair",
     "f32"),
    ("jacobi", "fn", ("one", "stored", "twice", "affine", "fn", "stored"),
     1e6, "single", "f32"),
]


@pytest.mark.parametrize(
    "form,a0,ws,Delta,body,storage", GEN_PREC_CASES,
    ids=[f"{c[0]}-k{len(c[2])}-{c[1]}-{c[3]:g}-{c[4]}-{c[5]}"
         for c in GEN_PREC_CASES])
def test_general_k_prec_plain_version_matches_pallas(form, a0, ws, Delta,
                                                     body, storage):
    g, x, B = _gen_inputs(len(ws), seed=20 + len(ws))
    jr, tr = _gen_run(g, x, B, a0, ws, Delta, body, False, storage,
                      prec_form=form)
    _assert_gen_parity(jr, tr, storage, prec=True)


def test_sphere_family_in_the_general_form_is_bitwise_the_same():
    """The k = 2 sphere family written with general terms (a0 stored as
    2a - rq, weights (None, stored 2a)) gives bitwise the plain version's
    result with the sphere descriptors, with and without P (a JacobiPower
    on A0 is the sphere's (|2a - rq| + c)^(-e)), and through the wrapper's
    CPU route."""
    g, x, rq, B, b, kw = _fixture("pd")
    tg, tx, tB, trq = (torch.from_numpy(g), torch.from_numpy(x),
                       torch.from_numpy(B), torch.tensor(rq))
    diag = T.AffineDiagonal(1.0, b)
    a = diag.values(N, "cpu")
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag, n_aux=1)
    a0_stored, w_stored = 2.0 * a - trq, (None, 2.0 * a)
    desc = T.JacobiPower(1.0, 0.25)
    for extra in ({}, {"prec_chunk": desc}):
        def run(a0_chunk, w, fn=T.stpcg_flat_streamed_reference):
            kx = dict(kw, **extra)
            if extra:
                kx["prec"] = T.prec_map(desc, a0_chunk, (trq,), N, "cpu")
            return fn(tg, tx, tB, 1e6, (trq,), a0_chunk=a0_chunk,
                      weights=w, **kx)
        sphere = run(a0c, weights)
        general = run(a0_stored, w_stored)
        wrapped = run(a0_stored, w_stored, fn=T.stpcg_flat_streamed)
        assert int(sphere.num_iterations) > 3
        for res in (general, wrapped):
            assert torch.equal(res.s, sphere.s)
            assert all(torch.equal(u, v) for u, v in zip(res[1:],
                                                         sphere[1:]))
    # the sphere's own prec map is JacobiPower.map, and equals prec_map's
    assert torch.equal(desc.map(diag, trq, N, "cpu").values(),
                       T.prec_map(desc, a0c, (trq,), N, "cpu").values())


def test_general_validation_matches_jax():
    """The JAX wrapper's refusals, raised by both packages on the same call
    (B of the wrong shape, storage dtype, x's dtype, one form of P, init=
    with P), and the port's own: k = 0 (JAX's kernel fails on it with a
    ZeroDivisionError in interpret mode), a chunk generator or an unknown
    object where a term belongs, a stored term of the wrong shape, a
    ShiftedDiagonal without aux scalars."""
    g, x, B = _gen_inputs(3, seed=3)
    ja0, ta0 = _term_pair("shifted")
    jw, tw = zip(*[_term_pair(f) for f in ("one", "twice", "stored")])
    jaux = tuple(jnp.float32(a) for a in AUX)
    taux = tuple(torch.tensor(a) for a in AUX)
    jg, jx = jnp.asarray(g), jnp.asarray(x)
    tg, tx = torch.from_numpy(g), torch.from_numpy(x)
    a0v = _term_values("shifted")
    jinit = j_init_dots(jg, lambda v: jnp.asarray(a0v) * v,
                        (jx,), jnp.eye(1, dtype=jnp.float32))
    tinit = flat_init_dots(tg, lambda v: torch.from_numpy(a0v) * v, (tx,),
                           torch.eye(1))
    jpc, jpf, tpc, tpf = _gen_prec("jacobi", "shifted", ta0, taux)
    cases = [
        ("B must be", dict(B=np.eye(2, dtype=np.float32)), {}),
        ("storage dtype", dict(dtype=(jnp.float16, torch.float16)), {}),
        ("share the storage", dict(xdtype=(jnp.bfloat16, torch.bfloat16)),
         {}),
        ("(?i)both forms", dict(), dict(prec_chunk=(jpc, tpc))),
        ("(?i)both forms", dict(), dict(prec=(jpf, tpf))),
        ("init", dict(), dict(prec_chunk=(jpc, tpc), prec=(jpf, tpf),
                              init=(jinit, tinit))),
    ]
    for msg, inp, kwp in cases:
        Bv = inp.get("B", B)
        jd, td = inp.get("dtype", (jnp.float32, torch.float32))
        jxd, txd = inp.get("xdtype", (jd, td))
        jk = {name: v[0] for name, v in kwp.items()}
        tk = {name: v[1] for name, v in kwp.items()}
        with pytest.raises(ValueError, match=msg):
            J.stpcg_flat_streamed(
                jg.astype(jd), jx.astype(jxd), jnp.asarray(Bv), 1.0,
                aux_scalars=jaux, a0_chunk=ja0, weights=jw, chunk_rows=CR,
                interpret=True, **jk)
        for fn in (T.stpcg_flat_streamed, T.stpcg_flat_streamed_reference):
            with pytest.raises(ValueError, match=msg):
                fn(tg.to(td), tx.to(txd), torch.from_numpy(Bv), 1.0, taux,
                   a0_chunk=ta0, weights=tw, **tk)

    def call(**k):
        kw = dict(dict(a0_chunk=ta0, weights=tw), **k)
        Bk = kw.pop("B", torch.from_numpy(B))
        return T.stpcg_flat_streamed(tg, tx, Bk, 1.0, kw.pop("aux", taux),
                                     **kw)

    with pytest.raises(ValueError, match="at least one"):
        call(weights=(), B=torch.zeros(0, 0))
    with pytest.raises(TypeError, match="chunk generators"):
        call(a0_chunk=ja0)
    with pytest.raises(TypeError, match="chunk generators"):
        call(weights=(None, jw[1], 3.0))
    with pytest.raises(ValueError, match="stored weight"):
        call(weights=(None, None, torch.ones(7)))
    with pytest.raises(ValueError, match="aux"):
        call(aux=())


# ------------------------------------------ the rank-3 path: TNT, k = 3 --
#
# The sphere Rayleigh quotient with a quartic term, f(x) = <x, a x> +
# (mu/4) q^2, q = <x, c x>, a = 1 + b i (kappa = 1000), c in [0, 1], mu =
# 10.  On the unit sphere grad f = d x with d = 2a + mu q c, lam = <x, d x>,
# and the projected Hessian P (Hess f - lam) P is A0 + U B U' with
# A0 = d - lam, U = (x, a x, c x) and
# B = [[2 lam + 2 mu q^2, -2, -3 mu q], [-2, 0, 0], [-3 mu q, 0, 2 mu]]:
# weights (None, a, c), a0 a function of aux = (lam, q) and of c.  The JAX
# kernel cannot capture an array, so c is an index formula,
# ((s1 i + s0) mod 10007) / 10007 with (s0, s1) drawn by numpy from a seed.

MU = 10.0
R3_B = 999.0 / (N - 1)
R3_S0, R3_S1 = (int(v) for v in np.random.default_rng(11).integers(
    1, 10007, 2))


def _r3_c(i):
    """c(i) for an int32 (JAX) or int64 (torch) index array, f32."""
    if isinstance(i, torch.Tensor):
        return ((i * R3_S1 + R3_S0) % 10007).float() / 10007.0
    return ((i * R3_S1 + R3_S0) % 10007).astype(jnp.float32) / 10007.0


def rank3_operator(x, a, c, mu=MU):
    """(a0, U, B, lam, q) of the rank-3 operator at the unit x (torch, any
    float dtype): A0 = diag(a0), U = (x, a x, c x)."""
    q = torch.dot(x, c * x)
    lam = torch.dot(x, (2.0 * a + mu * q * c) * x)
    a0 = 2.0 * a + (mu * q) * c - lam
    z = torch.zeros((), dtype=x.dtype)
    B = torch.stack([torch.stack([2.0 * lam + 2.0 * mu * q * q, z - 2.0,
                                  -3.0 * mu * q]),
                     torch.stack([z - 2.0, z, z]),
                     torch.stack([-3.0 * mu * q, z, z + 2.0 * mu])])
    return a0, (x, a * x, c * x), B, lam, q


def test_rank3_operator_is_the_projected_hessian():
    """In f64 with autograd: (A0 + U B U') v == P Hess f v - lam v for
    tangent v at random points of the sphere."""
    n = 64
    rng = np.random.default_rng(5)
    a = torch.from_numpy(1.0 + 999.0 / (n - 1) * np.arange(n))
    c = torch.from_numpy(rng.uniform(0.0, 1.0, n))

    def f(x):
        q = torch.dot(x, c * x)
        return torch.dot(x, a * x) + 0.25 * MU * q * q

    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal(n))
        x = x / torch.linalg.vector_norm(x)
        v = torch.from_numpy(rng.standard_normal(n))
        v = v - torch.dot(x, v) * x
        a0, U, B, lam, _ = rank3_operator(x, a, c)
        Ut = torch.stack(U)
        Hv = a0 * v + Ut.T @ (B @ (Ut @ v))
        egrad = torch.func.grad(f)(x)
        ehv = torch.func.jvp(torch.func.grad(f), (x,), (v,))[1]
        ref = ehv - torch.dot(x, ehv) * x - lam * v
        torch.testing.assert_close(lam, torch.dot(x, egrad), rtol=1e-12,
                                   atol=0)
        torch.testing.assert_close(Hv, ref, rtol=1e-10, atol=1e-10)


def _r3_problems():
    """The rank-3 problem in both packages: (JAX problem with the
    interpret-mode kernel behind flat_solve, the port's problem with the
    plain version behind flat_solve, the port's problem with flat_qm)."""
    from optimization_tpu import RiemannianProblem as JProblem
    from optimization_tpu.manifolds import sphere as jsphere
    from optimization_tpu_torch import RiemannianProblem as TProblem
    from optimization_tpu_torch.manifolds import sphere as tsphere

    def idx(i0):
        return _idx(i0)

    def a_chunk(i0, aux):
        return 1.0 + jnp.float32(R3_B) * idx(i0).astype(jnp.float32)

    def c_chunk(i0, aux):
        return _r3_c(idx(i0))

    def a0_chunk(i0, aux):
        return (2.0 * a_chunk(i0, aux) + (MU * aux[1]) * c_chunk(i0, aux)
                - aux[0])

    ja = 1.0 + jnp.float32(R3_B) * jnp.arange(N, dtype=jnp.float32)
    jc = _r3_c(jnp.arange(N, dtype=jnp.int32))
    JM = jsphere()

    def jf(x, _):
        x = x.astype(jnp.float32)
        q = jnp.dot(x, jc * x)
        return jnp.dot(x, ja * x) + 0.25 * MU * q * q

    def jgrad(x, _):
        q = jnp.dot(x, jc * x)
        return JM.proj(x, (2.0 * ja + MU * q * jc) * x)

    def jflat_solve(g, x, _, aux, Delta, params):
        q = jnp.dot(x, jc * x)
        lam = jnp.dot(x, (2.0 * ja + MU * q * jc) * x)
        B = jnp.stack([
            jnp.stack([2.0 * lam + 2.0 * MU * q * q, -2.0, -3.0 * MU * q]),
            jnp.stack([jnp.float32(-2.0), 0.0, 0.0]),
            jnp.stack([-3.0 * MU * q, 0.0, 2.0 * MU])]).astype(jnp.float32)
        return J.stpcg_flat_streamed(
            g, x, B, Delta, aux_scalars=(lam, q), a0_chunk=a0_chunk,
            weights=(None, a_chunk, c_chunk), chunk_rows=CR, interpret=True,
            max_iterations=params.max_TPCG_iterations,
            kappa_fgr=params.kappa_fgr, theta=params.theta)

    diag = T.AffineDiagonal(1.0, R3_B)
    ta = diag.values(N, "cpu")
    tc = _r3_c(torch.arange(N))
    TM = tsphere()
    a0fn = T.ElementwiseFn(
        lambda i, aux: 2.0 * ta + (MU * aux[1]) * tc - aux[0])

    def tf(x, _):
        q = torch.dot(x, tc * x)
        return torch.dot(x, ta * x) + 0.25 * MU * q * q

    def tgrad(x, _):
        q = torch.dot(x, tc * x)
        return TM.proj(x, (2.0 * ta + MU * q * tc) * x)

    def tflat_solve(g, x, _, aux, Delta, params):
        _, _, B, lam, q = rank3_operator(x, ta, tc)
        return T.stpcg_flat_streamed(
            g, x, B, Delta, (lam, q), a0_chunk=a0fn,
            weights=(None, diag, tc),
            max_iterations=params.max_TPCG_iterations,
            kappa_fgr=params.kappa_fgr, theta=params.theta)

    def tflat_qm(x, _, aux=None):
        a0, U, B, _, _ = rank3_operator(x, ta, tc)
        return (lambda v: a0 * v), U, B

    return (JProblem(f=jf, manifold=JM, grad=jgrad, flat_solve=jflat_solve),
            TProblem(f=tf, manifold=TM, grad=tgrad, flat_solve=tflat_solve),
            TProblem(f=tf, manifold=TM, grad=tgrad, flat_qm=tflat_qm))


def test_rank3_tnt_through_flat_solve_matches_jax():
    """TNT through ``flat_solve`` on the rank-3 operator: the port's plain
    version against JAX's ``tnt.solve`` with the interpret-mode kernel, f32
    at n = 8192 from one numpy start (|grad| <= 2e-2 is reached at outer
    iteration 15, before f32's floor, where the late subproblems part):
    same status and outer count, CG counts within 1 an outer iteration, f
    within 1e-5 relative.  The port's eager flat engine through ``flat_qm``
    on the same problem ends the same way."""
    from optimization_tpu.solvers import tnt as jtnt
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.interop import params_from_jax
    from optimization_tpu_torch.solvers import tnt as ttnt

    jp, tp, tq = _r3_problems()
    params = jtnt.TNTParams(
        max_iterations=30, max_TPCG_iterations=50, gradient_tolerance=2e-2,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal(N).astype(np.float32)
    x0 /= np.linalg.norm(x0)
    jr = jtnt.solve(jp, jnp.asarray(x0), params)
    tparams = params_from_jax(params)
    tr = ttnt.solve(tp, torch.from_numpy(x0), tparams)
    qr = ttnt.solve(tq, torch.from_numpy(x0), tparams)
    k = int(jr.num_iterations)
    assert int(tr.status) == int(jr.status) == TNTStatus.GRADIENT
    assert int(tr.num_iterations) == k and k > 10
    ji = np.asarray(jr.inner_iterations)[:k]
    ti = tr.inner_iterations[:k].numpy()
    assert np.abs(ti - ji).max() <= 1, (ti, ji)
    assert ji.sum() > 100
    np.testing.assert_allclose(float(tr.f), float(jr.f), rtol=1e-5)
    assert int(qr.status) == int(tr.status)
    assert int(qr.num_iterations) == k
    np.testing.assert_allclose(float(qr.f), float(tr.f), rtol=1e-5)


# ------------------------------------------ the rank-8 path: TNT, k = 8 --
#
# The same family with six quartic terms, f(x) = <x, a x> + (mu/4) sum_j
# q_j^2, q_j = <x, c_j x>, j = 1..6: c_1..c_3 stored (index formulas on the
# JAX side, as the rank-3 path's c, from three seeds), c_4..c_6 affine
# (c0 + spread i / (n - 1), values in [0, 1]), so that a stored and a
# generated weight both run at k > 4.  On the unit sphere grad f = d x with
# d = 2a + mu sum_j q_j c_j, lam = <x, d x>, and the projected Hessian is
# A0 + U B U' with A0 = d - lam, U = (x, a x, c_1 x, ..., c_6 x) and
# B[0, 0] = 2 lam + 2 mu sum_j q_j^2, B[0, 1] = B[1, 0] = -2,
# B[0, 1 + j] = B[1 + j, 0] = -3 mu q_j, B[1 + j, 1 + j] = 2 mu (j >= 1).

R8_SEEDS = tuple(tuple(int(v) for v in np.random.default_rng(s).integers(
    1, 10007, 2)) for s in (21, 22, 23))
R8_AFFINE = ((0.25, 0.5), (0.9, -0.8), (0.1, 0.3))   # (c0, spread)


def _r8_stored(j, i):
    """c_(j+1)(i), j < 3, for an int32 (JAX) or int64 (torch) index, f32."""
    s0, s1 = R8_SEEDS[j]
    if isinstance(i, torch.Tensor):
        return ((i * s1 + s0) % 10007).float() / 10007.0
    return ((i * s1 + s0) % 10007).astype(jnp.float32) / 10007.0


def quartic_operator(x, a, cs, mu=MU):
    """(a0, U, B, lam, q) of the projected Hessian at the unit x of
    <x, a x> + (mu/4) sum_j <x, c_j x>^2 (torch, any float dtype):
    A0 = diag(a0), U = (x, a x, c_1 x, ...), q the (len(cs),) q_j."""
    q = torch.stack([torch.dot(x, c * x) for c in cs])
    d = 2.0 * a
    for qj, c in zip(q, cs):
        d = d + (mu * qj) * c
    lam = torch.dot(x, d * x)
    k = len(cs) + 2
    B = torch.zeros((k, k), dtype=x.dtype)
    B[0, 0] = 2.0 * lam + 2.0 * mu * torch.sum(q * q)
    B[0, 1] = B[1, 0] = -2.0
    B[0, 2:] = B[2:, 0] = -3.0 * mu * q
    B[2:, 2:] = 2.0 * mu * torch.eye(k - 2, dtype=x.dtype)
    return d - lam, (x, a * x, *(c * x for c in cs)), B, lam, q


def test_rank8_operator_is_the_projected_hessian():
    """In f64 with autograd: (A0 + U B U') v == P Hess f v - lam v for
    tangent v at random points of the sphere, six quartic terms (k = 8);
    and with one term it is the rank-3 operator."""
    n = 64
    rng = np.random.default_rng(9)
    a = torch.from_numpy(1.0 + 999.0 / (n - 1) * np.arange(n))
    cs = [torch.from_numpy(rng.uniform(0.0, 1.0, n)) for _ in range(6)]

    def f(x):
        t = torch.dot(x, a * x)
        for c in cs:
            q = torch.dot(x, c * x)
            t = t + 0.25 * MU * q * q
        return t

    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal(n))
        x = x / torch.linalg.vector_norm(x)
        v = torch.from_numpy(rng.standard_normal(n))
        v = v - torch.dot(x, v) * x
        a0, U, B, lam, _ = quartic_operator(x, a, cs)
        assert B.shape == (8, 8) and len(U) == 8
        Ut = torch.stack(U)
        Hv = a0 * v + Ut.T @ (B @ (Ut @ v))
        egrad = torch.func.grad(f)(x)
        ehv = torch.func.jvp(torch.func.grad(f), (x,), (v,))[1]
        ref = ehv - torch.dot(x, ehv) * x - lam * v
        torch.testing.assert_close(lam, torch.dot(x, egrad), rtol=1e-12,
                                   atol=0)
        torch.testing.assert_close(Hv, ref, rtol=1e-10, atol=1e-10)
        one = quartic_operator(x, a, cs[:1])
        for u, w in zip(one, rank3_operator(x, a, cs[0])):
            if isinstance(u, tuple):
                assert all(torch.allclose(p, r, rtol=1e-15) for p, r in
                           zip(u, w))
            else:
                torch.testing.assert_close(u.reshape(w.shape), w,
                                           rtol=1e-15, atol=0)


def _r8_problems():
    """The rank-8 problem in both packages: (JAX problem with the
    interpret-mode kernel behind flat_solve, the port's problem with the
    plain version behind flat_solve, the port's problem with flat_qm)."""
    from optimization_tpu import RiemannianProblem as JProblem
    from optimization_tpu.manifolds import sphere as jsphere
    from optimization_tpu_torch import RiemannianProblem as TProblem
    from optimization_tpu_torch.manifolds import sphere as tsphere

    def a_chunk(i0, aux):
        return 1.0 + jnp.float32(R3_B) * _idx(i0).astype(jnp.float32)

    def c_chunk(j):
        if j < 3:
            return lambda i0, aux: _r8_stored(j, _idx(i0))
        c0, sp = R8_AFFINE[j - 3]
        return lambda i0, aux: (jnp.float32(c0) + jnp.float32(sp / (N - 1))
                                * _idx(i0).astype(jnp.float32))

    c_chunks = [c_chunk(j) for j in range(6)]

    def a0_chunk(i0, aux):
        d = 2.0 * a_chunk(i0, aux)
        for j in range(6):
            d = d + (MU * aux[1 + j]) * c_chunks[j](i0, aux)
        return d - aux[0]

    ji = jnp.arange(N, dtype=jnp.int32)
    ja = 1.0 + jnp.float32(R3_B) * ji.astype(jnp.float32)
    jcs = [_r8_stored(j, ji) for j in range(3)] + [
        jnp.float32(c0) + jnp.float32(sp / (N - 1)) * ji.astype(jnp.float32)
        for c0, sp in R8_AFFINE]
    JM = jsphere()

    def jqd(x):
        q = [jnp.dot(x, c * x) for c in jcs]
        d = 2.0 * ja
        for qj, c in zip(q, jcs):
            d = d + MU * qj * c
        return q, d

    def jf(x, _):
        x = x.astype(jnp.float32)
        t = jnp.dot(x, ja * x)
        for c in jcs:
            q = jnp.dot(x, c * x)
            t = t + 0.25 * MU * q * q
        return t

    def jgrad(x, _):
        return JM.proj(x, jqd(x)[1] * x)

    def jflat_solve(g, x, _, aux, Delta, params):
        q, d = jqd(x)
        lam = jnp.dot(x, d * x)
        qv = jnp.stack(q)
        B = jnp.zeros((8, 8), jnp.float32)
        B = B.at[0, 0].set(2.0 * lam + 2.0 * MU * jnp.sum(qv * qv))
        B = B.at[0, 1].set(-2.0).at[1, 0].set(-2.0)
        B = B.at[0, 2:].set(-3.0 * MU * qv).at[2:, 0].set(-3.0 * MU * qv)
        B = B.at[2:, 2:].set(2.0 * MU * jnp.eye(6, dtype=jnp.float32))
        return J.stpcg_flat_streamed(
            g, x, B, Delta, aux_scalars=(lam, *q), a0_chunk=a0_chunk,
            weights=(None, a_chunk, *c_chunks), chunk_rows=CR,
            interpret=True, max_iterations=params.max_TPCG_iterations,
            kappa_fgr=params.kappa_fgr, theta=params.theta)

    diag = T.AffineDiagonal(1.0, R3_B)
    ta = diag.values(N, "cpu")
    ti = torch.arange(N)
    tstored = [_r8_stored(j, ti) for j in range(3)]
    taff = [T.AffineDiagonal(c0, sp / (N - 1)) for c0, sp in R8_AFFINE]
    tcs = tstored + [c.values(N, "cpu") for c in taff]
    TM = tsphere()

    def ta0(i, aux):
        d = 2.0 * ta
        for j, c in enumerate(tcs):
            d = d + (MU * aux[1 + j]) * c
        return d - aux[0]

    a0fn = T.ElementwiseFn(ta0)

    def tf(x, _):
        t = torch.dot(x, ta * x)
        for c in tcs:
            q = torch.dot(x, c * x)
            t = t + 0.25 * MU * q * q
        return t

    def tgrad(x, _):
        a0, _, _, lam, _ = quartic_operator(x, ta, tcs)
        return TM.proj(x, (a0 + lam) * x)

    def tflat_solve(g, x, _, aux, Delta, params):
        _, _, B, lam, q = quartic_operator(x, ta, tcs)
        return T.stpcg_flat_streamed(
            g, x, B, Delta, (lam, *q), a0_chunk=a0fn,
            weights=(None, diag, *tstored, *taff),
            max_iterations=params.max_TPCG_iterations,
            kappa_fgr=params.kappa_fgr, theta=params.theta)

    def tflat_qm(x, _, aux=None):
        a0, U, B, _, _ = quartic_operator(x, ta, tcs)
        return (lambda v: a0 * v), U, B

    return (JProblem(f=jf, manifold=JM, grad=jgrad, flat_solve=jflat_solve),
            TProblem(f=tf, manifold=TM, grad=tgrad, flat_solve=tflat_solve),
            TProblem(f=tf, manifold=TM, grad=tgrad, flat_qm=tflat_qm))


def test_rank8_tnt_through_flat_solve_matches_jax():
    """TNT through ``flat_solve`` on the rank-8 operator: the port's plain
    version against JAX's ``tnt.solve`` with the interpret-mode kernel (k =
    8), f32 at n = 8192 from one numpy start, |grad| <= 2e-2 (reached at
    outer iteration 16): same status and outer count, CG counts within 1 an
    outer iteration, f within 1e-5 relative; the port's eager flat engine
    through ``flat_qm`` ends the same way."""
    from optimization_tpu.solvers import tnt as jtnt
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.interop import params_from_jax
    from optimization_tpu_torch.solvers import tnt as ttnt

    jp, tp, tq = _r8_problems()
    params = jtnt.TNTParams(
        max_iterations=30, max_TPCG_iterations=50, gradient_tolerance=2e-2,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0)
    rng = np.random.default_rng(17)
    x0 = rng.standard_normal(N).astype(np.float32)
    x0 /= np.linalg.norm(x0)
    jr = jtnt.solve(jp, jnp.asarray(x0), params)
    tparams = params_from_jax(params)
    tr = ttnt.solve(tp, torch.from_numpy(x0), tparams)
    qr = ttnt.solve(tq, torch.from_numpy(x0), tparams)
    k = int(jr.num_iterations)
    assert int(tr.status) == int(jr.status) == TNTStatus.GRADIENT
    assert int(tr.num_iterations) == k and k > 10
    ji = np.asarray(jr.inner_iterations)[:k]
    ti = tr.inner_iterations[:k].numpy()
    assert np.abs(ti - ji).max() <= 1, (ti, ji)
    assert ji.sum() > 100
    np.testing.assert_allclose(float(tr.f), float(jr.f), rtol=1e-5)
    assert int(qr.status) == int(tr.status)
    assert int(qr.num_iterations) == k
    np.testing.assert_allclose(float(qr.f), float(tr.f), rtol=1e-5)


# ---- the any-rank kernel's host plan (csrc/streamed_cg_any.cu) ----

def _plan_weights(k, n_stored, n=N):
    """k weights, ``n_stored`` of them stored (tensors and wrapped
    callables, every third a ScaledDiagonal of one), the others the
    weight 1 (j = 0 when it is not stored), generated weights and
    ScaledDiagonals of generated ones, one of them crossing zero in
    [0, n)."""
    ws = []
    for j in range(k):
        if j >= k - n_stored:
            t = (torch.full((n,), 0.5 + j / k) if j % 2 else
                 T.ElementwiseFn(lambda i, aux, j=j: 0.5 + (i % (7 + j))
                                 .float() / (7 + j)))
            ws.append(T.ScaledDiagonal(t) if j % 3 == 0 else t)
        elif j == 0:
            ws.append(None)
        elif j == 1:
            ws.append(T.AffineDiagonal(-0.5, 1.0 / (n - 1)))
        elif j % 2:
            ws.append(T.AffineDiagonal(0.5 + 0.003 * j, 1.0 / (n - 1)))
        else:
            ws.append(T.ScaledDiagonal(T.AffineDiagonal(0.25 + 0.002 * j,
                                                        0.5 / (n - 1))))
    return tuple(ws)


PLAN_MIXES = [(5, 2), (8, 4), (16, 8), (32, 16), (32, 32), (64, 0),
              (212, 84)]


@pytest.mark.parametrize("k,n_stored", PLAN_MIXES,
                         ids=[f"K{k}-stored{s}" for k, s in PLAN_MIXES])
def test_any_k_plan_classes_partition_the_weights(k, n_stored):
    """any_k_plan sorts the K weights into the weight 1, generated (c and b
    as f32, times 2 for a ScaledDiagonal) and stored (scale 1 or 2), each
    j in exactly one class; the folded table is the weight 1 and the
    generated weights in j order."""
    ws = _plan_weights(k, n_stored)
    plan = T.any_k_plan(ws)
    one = list(plan.one)
    gen = [j for j, _, _ in plan.generated]
    st = [j for j, _ in plan.stored]
    assert sorted(one + gen + st) == list(range(k))
    assert len(st) == n_stored and len(set(one + gen + st)) == k
    for j, c, b in plan.generated:
        w, scale = ws[j], 1.0
        if isinstance(w, T.ScaledDiagonal):
            w, scale = w.a, 2.0
        assert isinstance(w, T.AffineDiagonal)
        assert c == scale * float(np.float32(w.c))
        assert b == scale * float(np.float32(w.b))
    for j, scale in plan.stored:
        scaled = isinstance(ws[j], T.ScaledDiagonal)
        assert scale == (2.0 if scaled else 1.0)
        inner = ws[j].a if scaled else ws[j]
        assert isinstance(inner, (torch.Tensor, T.ElementwiseFn))
    assert all(ws[j] is None for j in one)
    folded = plan.folded()
    assert [f[0] for f in folded] == sorted(one + gen)
    assert all(f[1:] == (1.0, 0.0) for f in folded if f[0] in one)


@pytest.mark.parametrize("seed", range(4))
def test_any_k_plan_fold_reproduces_the_folded_sum(seed):
    """plan.fold(beta) = (C, D) gives sum_j beta_j w_j(i) over the weight 1
    and the generated weights as C + D f32(i): at sampled i of n = 2^24
    (f32(i) exact), against the float64 sum of the plain version's own
    f32 weight values, within the f32 roundings of C, D and of each w_j(i)
    (2^-23 of the magnitudes summed), with a weight crossing zero."""
    n = 1 << 24
    k = 24
    ws = _plan_weights(k, 6, n=n)
    plan = T.any_k_plan(ws)
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal(k).astype(np.float32)
    C, D = plan.fold(beta)
    assert np.float32(C) == C and np.float32(D) == D
    i = np.concatenate([[0, 1, n // 2, n - 1],
                        rng.integers(0, n, 60)]).astype(np.int64)
    fi = torch.from_numpy(i.astype(np.float32))
    want = np.zeros(i.shape)
    mag = np.zeros(i.shape)
    for j, c, b in plan.folded():
        w = ws[j]
        if w is None:
            wv = np.ones(i.shape)
        else:
            scale = 2.0 if isinstance(w, T.ScaledDiagonal) else 1.0
            a = w.a if scale == 2.0 else w
            # AffineDiagonal.values' f32 arithmetic at the sampled i
            wv = scale * (torch.tensor(a.b, dtype=torch.float32) * fi
                          + torch.tensor(a.c, dtype=torch.float32)
                          ).double().numpy()
        want += float(beta[j]) * wv
        mag += abs(float(beta[j])) * (abs(c) + abs(b) * i + np.abs(wv))
    got = C + D * i.astype(np.float64)
    assert np.all(np.abs(got - want) <= 2.0 ** -23 * mag)
    # the crossing weight's value does change sign over [0, n)
    c1, b1 = [(c, b) for j, c, b in plan.generated if j == 1][0]
    assert c1 < 0 < c1 + b1 * (n - 1)


def _lines_weights(k, n_stored):
    return (tuple(torch.zeros(1) for _ in range(n_stored))
            + tuple(T.AffineDiagonal(0.5, 1e-3) for _ in range(k - n_stored)))


def test_any_k_plan_lines():
    """The layout lines at 232,448 bytes of shared memory a block (an H100)
    follow from the plan's arithmetic: a stage is 1,024 elements of r, p,
    x, s (16 B f32, 8 B bf16) and 4 B a stored weight; at K = 40 in f32
    the fixed area (1,024), the table (640) and the K-vectors (2,080) come
    first, then the init's basis rows (16,384) over the slots (1,344 at 21
    stored weights) and B', U'U (12,800), which leaves 212,320 bytes: two
    stages hold all stored weights up to 21 (2 (16,384 + 4,096 x 21) =
    204,800) and 22 come in two stages of 13 weights, three stages deep
    (without init= rows, 22 still fit one stage); B' and U'U (8 K^2) stay
    in shared memory up to K = 90 (64,800 <= 65,536); the basis rows leave
    shared memory only at K = 2,561 (with half the weights stored); a few
    stored weights leave the ring four stages deep."""
    plan = T.any_k_plan
    p21 = plan(_lines_weights(40, 21))
    p22 = plan(_lines_weights(40, 22))
    assert (p21.group, p21.chunks, p21.stages) == (21, 1, 2)
    assert (p22.group, p22.chunks, p22.stages) == (13, 2, 3)
    assert p21.smem_bytes == 1024 + 640 + 2080 + 16384 + 2 * (
        16384 + 4096 * 21)
    assert plan(_lines_weights(40, 22), with_init=True).chunks == 1
    assert plan(_lines_weights(90, 0)).B_and_UU
    assert not plan(_lines_weights(91, 0)).B_and_UU
    assert plan(_lines_weights(2560, 1280)).init_rows
    assert not plan(_lines_weights(2561, 1280)).init_rows
    for storage in (torch.float32, torch.bfloat16):
        p = plan(_lines_weights(8, 4), storage=storage)
        assert (p.chunks, p.stages) == (1, 4)
    # a stored a0 and P widen a stage by 8 KiB; bf16 narrows it by 8 KiB
    p = plan(_lines_weights(8, 4), a0_stored=True, prec_kind=2)
    assert p.stage_bytes == plan(_lines_weights(8, 4)).stage_bytes + 8192
    p = plan(_lines_weights(8, 4), storage=torch.bfloat16)
    assert p.stage_bytes == plan(_lines_weights(8, 4)).stage_bytes - 8192
