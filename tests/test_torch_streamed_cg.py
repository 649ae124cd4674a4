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
    with pytest.raises(NotImplementedError, match="sphere Rayleigh"):
        call(weights=(None, None))
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
        return chunk, (lambda v: v * pfull), pv, (lambda v: v * pv)
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
    with pytest.raises(NotImplementedError, match="generators"):
        call(prec_chunk=lambda i0, aux: 1.0, prec=pmap)
    with pytest.raises(ValueError, match="e = 1/2 or 1/4"):
        call(prec_chunk=T.JacobiPower(1.0, 1.0), prec=pmap)
    with pytest.raises(ValueError, match="stored preconditioner"):
        call(prec_chunk=torch.ones(3), prec=pmap)
