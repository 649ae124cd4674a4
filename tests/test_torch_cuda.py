"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; the kernels have no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances of the streamed kernel (those of ``chip_smoke.check_parity`` and
``tests/test_streamed_cg.py``, the step norm to norm): f32 iteration counts
within 1 and |s - s_ref| within 2e-3 |s_ref| (the kernel sums in another
order than ``torch.sum``, so CG may stop one step apart at the truncation
threshold; equal counts give ~1e-6); bf16 storage iterations within 3 and
s within 3e-2.  The same hold with the preconditioner: the kernel's
generated p (round-to-nearest rsqrt) and the plain version's
``torch.rsqrt`` may differ in the last bit, inside those tolerances.  A
stored P unrelated to the diagonal runs CG ~50 iterations to where |r|
creeps past the truncation target, and the order of the sums alone moves
the count there (``chip_smoke.permuted_plain`` measures 2): its counts are
held within 3.  Tolerances of the
fused kernels: those of ``chip_smoke.FUSED_TOLERANCES`` and
``chip_smoke.GRAM_TOLERANCES``, reasons there.  The two residency probe
kernels (``csrc/probes.cu``): ``chip_smoke.PROBE_TOLERANCES``, and every arm
of a kernel bit for bit equal to its other arms.  The chunk reader:
``chip_smoke.CHUNK_TOLERANCES``.  Further tests hold the convex solvers, the
``prec`` check of the streamed kernel, the matrix manifolds, the connection
Laplacian (within f32 tolerance of the CPU, which adds in another order),
the models' card defaults, the pose-graph CLI on the card by default and
the inner Laplacian engines on the card against the CPU.  The graph models
repeat bit for bit on the card: every path of
``profile_graph_routes.model_paths`` run twice, and raising no determinism
warning and dispatching no operation that adds in a varying order
(``profile_graph_routes.census``); each ``scatter_method`` of the
connection Laplacian and ``laplacian_apply``, the degree, the lifted
problem's hvp, both inner Laplacian engines, and, at config6's rotation
graph, ``spectral_init`` and phase 17's three TNT routes, each run twice.
"""

import pytest
import torch

from optimization_tpu_torch.examples import EXAMPLES, LOBPCG_EXAMPLES
from optimization_tpu_torch.kernels import fused as F
from optimization_tpu_torch.kernels import streamed_cg as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pd_fixture(n, dtype, dev, seed=7):
    """The positive-definite fixture (rq = 0.5, B_pd): many CG steps.  Delta
    is 1e6 in f32 and 1 in bf16, where a huge Delta is a knife-edge: once CG
    stalls at the storage floor a rounding-sign kappa <= 0 sends either run
    to the boundary (tests/test_streamed_cg.py test_bf16_storage_parity)."""
    diag = T.AffineDiagonal(1.0, 25.0 / (n - 1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    x = x / torch.linalg.vector_norm(x)
    a = diag.values(n, dev)
    y = 2.0 * a * x
    g = y - torch.dot(x, y) * x
    B = torch.tensor([[1.0, 0.2], [0.2, 0.5]], device=dev)
    rq = torch.tensor(0.5, device=dev)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=400,
              kappa_fgr=1e-3, theta=0.9)
    Delta = 1.0 if dtype == torch.bfloat16 else 1e6
    return (g.to(dtype), x.to(dtype), B, Delta, (rq,)), kw


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("body", ["pair", "single"])
@pytest.mark.parametrize("n", [1 << 18, 100_003])
def test_kernel_matches_plain_version(dev, storage, body, n):
    args, kw = _pd_fixture(n, storage, dev)
    before = T.stpcg_flat_streamed.launches
    res = T.stpcg_flat_streamed(*args, body_kind=body, **kw)
    ref = T.stpcg_flat_streamed_reference(*args, body_kind=body, **kw)
    torch.cuda.synchronize()
    assert T.stpcg_flat_streamed.launches == before + 1
    assert res.s.dtype == storage and res.s.device == args[0].device
    tol, dit = (3e-2, 3) if storage == torch.bfloat16 else (2e-3, 1)
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= dit
    if storage == torch.float32:
        assert int(ref.num_iterations) > 3       # a multi-iteration run
    _assert_step_close(res.s, ref.s, tol)


def _assert_step_close(s, s_ref, tol):
    """|s - s_ref| <= tol |s_ref|, 2-norms."""
    norm = torch.linalg.vector_norm
    rel = float(norm(s.float() - s_ref.float()) / norm(s_ref.float()))
    assert rel <= tol, rel


def test_two_runs_are_bitwise_equal(dev):
    args, kw = _pd_fixture(1 << 18, torch.float32, dev)
    r1 = T.stpcg_flat_streamed(*args, **kw)
    r2 = T.stpcg_flat_streamed(*args, **kw)
    assert torch.equal(r1.s, r2.s)
    assert all(torch.equal(a, b) for a, b in zip(r1[1:], r2[1:]))


def test_stored_diagonal_matches_affine(dev):
    (g, x, B, Delta, aux), kw = _pd_fixture(1 << 16, torch.float32, dev)
    n = g.shape[0]
    a = T.AffineDiagonal(1.0, 25.0 / (n - 1)).values(n, dev)
    a0c, weights, _ = T.sphere_rayleigh_streamed(a)
    stored = T.stpcg_flat_streamed(g, x, B, Delta, aux, **dict(
        kw, a0_chunk=a0c, weights=weights))
    affine = T.stpcg_flat_streamed(g, x, B, Delta, aux, **kw)
    assert torch.equal(stored.s, affine.s)


def test_zero_gradient_and_outputs_stay_on_card(dev):
    (g, x, B, Delta, aux), kw = _pd_fixture(4099, torch.float32, dev)
    res = T.stpcg_flat_streamed(torch.zeros_like(g), x, B, Delta, aux, **kw)
    assert int(res.num_iterations) == 0
    assert not res.s.any()
    for t in res[1:]:
        assert t.device.type == "cuda"


PREC_FORMS = ["jacobi", "quarter", "exact", "stored"]


def _prec(form, args):
    """(prec_chunk, prec, diagonal) for the pd fixture: the shifted-Jacobi
    powers on its diagonal (exact: c = 0, valid as 2a - 0.5 > 0) or a
    stored P unrelated to it, (1 + (i mod 13)/4)^(-1/2) (the P of
    tests/test_torch_streamed_cg.py): a kernel that generated p in place of
    reading it would disagree."""
    g, _, _, _, (rq,) = args
    n, dev = g.shape[0], g.device
    diag = T.AffineDiagonal(1.0, 25.0 / (n - 1))
    if form == "stored":
        p = torch.rsqrt(1.0 + 0.25 * (torch.arange(n, device=dev) % 13)
                        .float())
        return p, T.stored_prec_map(p), diag
    c, e = {"jacobi": (1.0, 0.5), "quarter": (1.0, 0.25),
            "exact": (0.0, 0.5)}[form]
    desc = T.JacobiPower(c, e)
    return desc, desc.map(diag, rq, n, dev), diag


@pytest.mark.parametrize("form", PREC_FORMS)
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("body", ["pair", "single"])
@pytest.mark.parametrize("n", [1 << 18, 100_003])
def test_prec_kernel_matches_plain_version(dev, form, storage, body, n):
    args, kw = _pd_fixture(n, storage, dev)
    pc, pmap, diag = _prec(form, args)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    kw = dict(kw, a0_chunk=a0c, weights=weights, prec_chunk=pc, prec=pmap)
    before = T.stpcg_flat_streamed.launches
    res = T.stpcg_flat_streamed(*args, body_kind=body, **kw)
    ref = T.stpcg_flat_streamed_reference(*args, body_kind=body, **kw)
    torch.cuda.synchronize()
    assert T.stpcg_flat_streamed.launches == before + 1
    assert res.s.dtype == storage and res.s.device == args[0].device
    tol, dit = (3e-2, 3) if storage == torch.bfloat16 else (2e-3, 1)
    if form == "stored":
        dit = 3
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= dit
    _assert_step_close(res.s, ref.s, tol)
    if storage == torch.float32:
        torch.testing.assert_close(res.update_step_M_norm,
                                   ref.update_step_M_norm, rtol=1e-3, atol=0)


def test_prec_kernel_is_bitwise_repeatable_and_exact_jacobi_collapses(dev):
    args, kw = _pd_fixture(1 << 18, torch.float32, dev)
    pc, pmap, diag = _prec("quarter", args)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    kw = dict(kw, a0_chunk=a0c, weights=weights)
    r1 = T.stpcg_flat_streamed(*args, prec_chunk=pc, prec=pmap, **kw)
    r2 = T.stpcg_flat_streamed(*args, prec_chunk=pc, prec=pmap, **kw)
    assert torch.equal(r1.s, r2.s)
    assert all(torch.equal(a, b) for a, b in zip(r1[1:], r2[1:]))
    # B = 0 and the exact Jacobi: P H P = I, one CG step to -g / (2a - rq)
    g, x, _, _, aux = args
    pc = T.JacobiPower(0.0, 0.5)
    pmap = pc.map(diag, aux[0], g.shape[0], dev)
    zkw = dict(kw, max_iterations=400, kappa_fgr=1e-6, theta=0.0)
    res = T.stpcg_flat_streamed(g, x, torch.zeros(2, 2, device=dev), 1e6,
                                aux, prec_chunk=pc, prec=pmap, **zkw)
    assert int(res.num_iterations) <= 2
    s_true = -g / (2.0 * diag.values(g.shape[0], dev) - aux[0])
    _assert_step_close(res.s, s_true, 1e-5)


def test_escalation_and_least_squares_stay_on_card(dev):
    """solve_escalated through the streamed kernel in both stages (bf16,
    then f32) and euclidean_tnls on a CUDA x0: every result on the card."""
    from optimization_tpu_torch import euclidean_tnls, headline
    from optimization_tpu_torch.core.types import TNLSStatus, TNTStatus
    from optimization_tpu_torch.solvers import tnt

    n = 1 << 16
    prob = headline.make_problem(n, dev, "streamed")
    params = tnt.TNTParams(max_iterations=200, max_TPCG_iterations=100,
                           gradient_tolerance=1e-3,
                           relative_decrease_tolerance=0.0,
                           stepsize_tolerance=0.0,
                           preconditioned_gradient_tolerance=0.0)
    before = T.stpcg_flat_streamed.launches
    res = tnt.solve_escalated(prob, headline.initial_point(n, torch.float32,
                                                           dev, 3), params)
    assert T.stpcg_flat_streamed.launches > before
    assert res.stage_low.x.dtype == torch.bfloat16
    assert res.x.dtype == torch.float32 and res.x.device.type == "cuda"
    assert int(res.status) == TNTStatus.GRADIENT
    assert float(torch.linalg.vector_norm(prob.rgrad(res.x))) <= 1e-3

    xs = torch.linspace(-3.14159, 3.14159, 1000, device=dev)
    y = torch.sin(1.5707964 * xs + 0.7853982)
    fit = euclidean_tnls(lambda b, d: d - torch.sin(b[0] * xs + b[1]),
                         torch.ones(2, device=dev), data=y)
    assert fit.x.device.type == "cuda" and fit.f.device.type == "cuda"
    assert int(fit.status) in (TNLSStatus.ROOT, TNLSStatus.GRADIENT)
    torch.testing.assert_close(fit.x.cpu(), torch.tensor([1.5707964,
                                                          0.7853982]),
                               rtol=0, atol=1e-3)



# ---- the general rank k: K = 1-4 (streamed_cg.cu), K >= 5 (_any.cu) ----

GEN_AUX = (0.5, 0.75)


def _gen_term(form, n, dev):
    """A port descriptor of one term (tests/test_torch_streamed_cg.py's
    forms): ``affine`` 1 + b i, ``twice`` / ``shifted`` its ScaledDiagonal /
    ShiftedDiagonal, ``stored`` 1 + (i mod 13)/4 as a tensor, ``fn``
    0.5 + aux[1] (i mod 97)/8 as an ElementwiseFn, ``one`` None."""
    aff = T.AffineDiagonal(1.0, 8.0 / (n - 1))
    return {
        "one": None, "affine": aff, "twice": T.ScaledDiagonal(aff),
        "shifted": T.ShiftedDiagonal(aff),
        "stored": 1.0 + 0.25 * (torch.arange(n, device=dev) % 13).float(),
        "fn": T.ElementwiseFn(
            lambda i, aux: 0.5 + aux[1] * ((i % 97).float() / 8.0)),
    }[form]


def _gen_args(k, n, dtype, dev, seed=3):
    """(g, x, B, aux): a unit g and x from a seeded generator on the card,
    B = 0.3 G G' / k (positive semi-definite: many interior iterations)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, generator=gen, device=dev)
    x = torch.randn(n, generator=gen, device=dev)
    G = torch.randn(k, k, generator=gen, device=dev)
    B = 0.3 * G @ G.T / k
    aux = tuple(torch.tensor(a, device=dev) for a in GEN_AUX)
    return ((g / torch.linalg.vector_norm(g)).to(dtype),
            (x / torch.linalg.vector_norm(x)).to(dtype), B, aux)


def _gen_init(g, x, B, a0_chunk, weights, aux):
    """The threaded init group of the operator, by the port's flat engine
    helper."""
    from optimization_tpu_torch.linalg.flat_cg import flat_init_dots

    n, dev = g.shape[0], g.device
    a0 = T._a0_values(a0_chunk, n, aux, dev)
    U = tuple(x.float() if w is None else T._weight_values(w, n, aux, dev)
              * x.float() for w in weights)
    return flat_init_dots(g, lambda v: a0 * v.float(), U, B)


GEN_FORMS = {
    1: ("affine", ("stored",)),
    3: ("shifted", ("one", "twice", "fn")),
    4: ("fn", ("one", "twice", "stored", "fn")),
}


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("body", ["pair", "single"])
@pytest.mark.parametrize("with_init", [False, True], ids=["", "init"])
@pytest.mark.parametrize("n", [1 << 18, 100_003])
def test_general_k_kernel_matches_plain_version(dev, k, storage, body,
                                                with_init, n):
    """The kernel at K = 1, 3, 4 against its plain version, every term form
    among the cases; the streamed kernel's tolerances (module docstring),
    Delta 1e6 (interior runs) in f32 and 0.4 (a boundary exit) in bf16."""
    g, x, B, aux = _gen_args(k, n, storage, dev)
    a0_form, w_forms = GEN_FORMS[k]
    a0c = _gen_term(a0_form, n, dev)
    weights = tuple(_gen_term(f, n, dev) for f in w_forms)
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=300,
              kappa_fgr=1e-3, theta=0.9, body_kind=body)
    if with_init:
        kw["init"] = _gen_init(g, x, B, a0c, weights, aux)
    Delta = 1e6 if storage == torch.float32 else 0.4
    before = T.stpcg_flat_streamed.launches
    res = T.stpcg_flat_streamed(g, x, B, Delta, aux, **kw)
    ref = T.stpcg_flat_streamed_reference(g, x, B, Delta, aux, **kw)
    torch.cuda.synchronize()
    assert T.stpcg_flat_streamed.launches == before + 1
    assert res.s.dtype == storage and res.s.device == g.device
    tol, dit = (3e-2, 3) if storage == torch.bfloat16 else (2e-3, 1)
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= dit
    if storage == torch.float32:
        assert int(ref.num_iterations) > 3
        torch.testing.assert_close(res.update_step_M_norm,
                                   ref.update_step_M_norm, rtol=1e-3, atol=0)
    _assert_step_close(res.s, ref.s, tol)


@pytest.mark.parametrize("form", ["jacobi", "quarter", "stored", "fn"])
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_general_k_prec_kernel_matches_plain_version(dev, form, storage):
    """Every prec_chunk form at K = 3 (JacobiPower on A0, a stored P
    unrelated to A0, a wrapped callable's P), within the preconditioned
    tolerances (stored and wrapped P: counts within 3)."""
    n = 1 << 18
    g, x, B, aux = _gen_args(3, n, storage, dev, seed=5)
    a0c = _gen_term("fn", n, dev)
    weights = (None, _gen_term("twice", n, dev), _gen_term("stored", n, dev))
    if form in ("jacobi", "quarter"):
        pc = T.JacobiPower(1.0, 0.5 if form == "jacobi" else 0.25)
    elif form == "stored":
        pc = torch.rsqrt(1.0 + 0.25 * (torch.arange(n, device=dev) % 13)
                         .float())
    else:
        pc = T.ElementwiseFn(
            lambda i, a: torch.rsqrt(1.0 + a[1] * (i % 5).float()))
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=300,
              kappa_fgr=1e-3, theta=0.9, prec_chunk=pc,
              prec=T.prec_map(pc, a0c, aux, n, dev))
    Delta = 1e6 if storage == torch.float32 else 0.4
    res = T.stpcg_flat_streamed(g, x, B, Delta, aux, **kw)
    ref = T.stpcg_flat_streamed_reference(g, x, B, Delta, aux, **kw)
    torch.cuda.synchronize()
    tol, dit = (3e-2, 3) if storage == torch.bfloat16 else (2e-3, 1)
    if form in ("stored", "fn"):
        dit = 3
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= dit
    _assert_step_close(res.s, ref.s, tol)


def test_sphere_family_in_the_general_form_is_bitwise_the_same_on_card(dev):
    """The sphere's a0 = 2a - rq and weight 2a as stored tensors give the
    kernel's sphere-descriptor result bit for bit (same values, same
    arithmetic), with and without the quarter-power Jacobi P; and the K = 2
    kernel is bitwise repeatable."""
    args, kw = _pd_fixture(1 << 18, torch.float32, dev)
    g, x, B, Delta, (rq,) = args
    n = g.shape[0]
    diag = T.AffineDiagonal(1.0, 25.0 / (n - 1))
    a = diag.values(n, dev)
    general = dict(kw, a0_chunk=2.0 * a - rq, weights=(None, 2.0 * a))
    desc = T.JacobiPower(1.0, 0.25)
    for extra in ({}, {"prec_chunk": desc}):
        runs = []
        for kx in (kw, general):
            kx = dict(kx, **extra)
            if extra:
                kx["prec"] = T.prec_map(desc, kx["a0_chunk"], (rq,), n, dev)
            runs.append(T.stpcg_flat_streamed(g, x, B, Delta, (rq,), **kx))
        assert int(runs[0].num_iterations) > 3
        assert torch.equal(runs[0].s, runs[1].s)
        assert all(torch.equal(u, v) for u, v in zip(runs[0][1:],
                                                     runs[1][1:]))


def _gen_weights(k, n, dev):
    """k distinct weights of order 1 (``chip_smoke.gen_weights``): the
    weight 1, then ScaledDiagonal, stored, wrapped and affine in turn, each
    with its own coefficients; weights repeated across j give H outliers
    at which the step count moves by 2 with the order of the sums alone."""
    forms = ("twice", "stored", "fn", "affine")

    def weight(j):
        form = forms[(j - 1) % 4]
        if form == "twice":
            return T.ScaledDiagonal(T.AffineDiagonal(0.25 + 0.002 * j,
                                                     0.5 / (n - 1)))
        if form == "affine":
            return T.AffineDiagonal(0.5 + 0.003 * j, 1.0 / (n - 1))
        if form == "stored":
            return 0.5 + ((torch.arange(n, device=dev) + 7 * j) % 13
                          ).float() / 12.0
        m = 89 + j
        return T.ElementwiseFn(
            lambda i, aux: 0.5 + aux[1] * ((i % m).float() / m))

    return (None,) + tuple(weight(j) for j in range(1, k))


# (K, n, storage, body, init, P[, weights]): csrc/streamed_cg_any.cu at
# K = 5, 6, 8, 16, 33, 64, 115, 116 and 212 on _gen_weights' mix (all
# stored weights in one stage up to K = 33, in several above; B' and U'U
# in device memory from K = 91); every term form
# (a0 from _gen_term's forms in turn), every P form, f32 and bf16, ragged
# n; and on _any_k_mix's weights: a generated weight crossing zero in
# [0, n), all weights generated (K = 64: folded, no stored weight), all
# stored (K = 32: two stages of them)
ANY_K_CASES = [
    (5, 1 << 20, torch.float32, "pair", False, None),
    (6, 100_003, torch.bfloat16, "single", True, None),
    (8, 1 << 18, torch.float32, "single", False, "jacobi"),
    (8, 100_003, torch.float32, "pair", True, None),
    (16, 1 << 20, torch.bfloat16, "pair", False, None),
    (16, 1 << 18, torch.float32, "pair", False, "stored"),
    (33, 100_003, torch.float32, "single", False, "quarter"),
    (33, 1 << 18, torch.bfloat16, "pair", False, "fn"),
    (64, 1 << 18, torch.float32, "pair", False, None),
    (64, 100_003, torch.float32, "single", True, None),
    (115, 1 << 16, torch.float32, "pair", False, None),
    (116, 1 << 16, torch.float32, "pair", False, None),
    (116, 65_539, torch.float32, "single", True, None),
    (212, 1 << 16, torch.float32, "single", False, None),
    (8, 1 << 18, torch.bfloat16, "pair", False, None),
    (8, 1 << 20, torch.float32, "pair", False, None, "crossing"),
    (8, 100_003, torch.float32, "single", False, "jacobi", "crossing"),
    (64, 1 << 18, torch.float32, "pair", False, None, "generated"),
    (64, 100_003, torch.bfloat16, "single", False, None, "generated"),
    (32, 1 << 18, torch.float32, "pair", True, None, "stored"),
    (32, 100_003, torch.float32, "single", False, "stored", "stored"),
]
A0_FORMS = ("shifted", "fn", "stored", "affine")


def _any_k_mix(mix, k, n, dev):
    """The weights of a named mix: ``crossing`` _gen_weights with its
    affine weight (j = 4) replaced by -0.5 + i / (n - 1), which crosses
    zero in [0, n); ``generated`` k distinct generated weights (affine and
    ScaledDiagonal in turn); ``stored`` k distinct stored weights (tensors
    and wrapped callables in turn, each its own period)."""
    if mix == "crossing":
        ws = list(_gen_weights(k, n, dev))
        ws[4] = T.AffineDiagonal(-0.5, 1.0 / (n - 1))
        return tuple(ws)
    if mix == "generated":
        return tuple(
            T.AffineDiagonal(0.5 + 0.003 * j, 1.0 / (n - 1)) if j % 2 else
            T.ScaledDiagonal(T.AffineDiagonal(0.25 + 0.002 * j,
                                              0.5 / (n - 1)))
            for j in range(k))
    i = torch.arange(n, device=dev)
    return tuple(
        0.5 + ((i + 3 * j) % (11 + j)).float() / (11 + j) if j % 2 else
        T.ElementwiseFn(lambda i, aux, m=11 + j: 0.5 + aux[1] * (
            (i % m).float() / m))
        for j in range(k))


@pytest.mark.parametrize(
    "case", ANY_K_CASES,
    ids=[f"K{c[0]}-{c[1]}-{str(c[2])[6:]}-{c[3]}"
         f"{'-init' if c[4] else ''}{'-' + c[5] if c[5] else ''}"
         f"{'-' + c[6] if len(c) > 6 else ''}" for c in ANY_K_CASES])
def test_kernel_matches_plain_version_above_four(dev, case):
    """Rank K >= 5 on the card (csrc/streamed_cg_any.cu) against the plain
    version at the K <= 4 cases' tolerances (module docstring; a stored or
    wrapped P unrelated to A0: counts within 3), Delta 1e6 in f32 and 0.4
    in bf16; one launch counted a call, and a second launch bit for bit
    the first."""
    k, n, storage, body, with_init, pform = case[:6]
    g, x, B, aux = _gen_args(k, n, storage, dev)
    a0c = _gen_term(A0_FORMS[k % 4], n, dev)
    weights = (_any_k_mix(case[6], k, n, dev) if len(case) > 6
               else _gen_weights(k, n, dev))
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=300,
              kappa_fgr=1e-3, theta=0.9, body_kind=body)
    if with_init:
        kw["init"] = _gen_init(g, x, B, a0c, weights, aux)
    if pform in ("jacobi", "quarter"):
        pc = T.JacobiPower(1.0, 0.5 if pform == "jacobi" else 0.25)
    elif pform == "stored":
        pc = torch.rsqrt(1.0 + 0.25 * (torch.arange(n, device=dev) % 13)
                         .float())
    elif pform == "fn":
        pc = T.ElementwiseFn(
            lambda i, a: torch.rsqrt(1.0 + a[1] * (i % 5).float()))
    if pform:
        kw.update(prec_chunk=pc, prec=T.prec_map(pc, a0c, aux, n, dev))
    Delta = 1e6 if storage == torch.float32 else 0.4
    before = T.stpcg_flat_streamed.launches
    res = T.stpcg_flat_streamed(g, x, B, Delta, aux, **kw)
    assert T.stpcg_flat_streamed.launches == before + 1
    again = T.stpcg_flat_streamed(g, x, B, Delta, aux, **kw)
    ref = T.stpcg_flat_streamed_reference(g, x, B, Delta, aux, **kw)
    torch.cuda.synchronize()
    assert torch.equal(res.s, again.s)
    assert all(torch.equal(u, v) for u, v in zip(res[1:], again[1:]))
    assert res.s.dtype == storage and res.s.device == g.device
    tol, dit = (3e-2, 3) if storage == torch.bfloat16 else (2e-3, 1)
    if pform in ("stored", "fn"):
        dit = 3
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= dit
    if storage == torch.float32:
        assert int(ref.num_iterations) > 3
        torch.testing.assert_close(res.update_step_M_norm,
                                   ref.update_step_M_norm, rtol=1e-3, atol=0)
    _assert_step_close(res.s, ref.s, tol)


@pytest.mark.parametrize("jacobi_power", [None, 0.25],
                         ids=["plain", "jacobi"])
def test_spans_once_a_launch_and_none_on_the_device(dev, jacobi_power):
    """The port's spans (``core.profiling.annotate``) on the card: a
    headline TNT solve through the kernel (k = 2) and a rank-8 launch
    (csrc/streamed_cg_any.cu) record one ``streamed_cg.prepare`` and one
    ``streamed_cg.launch`` span a launch; no span's name and no user
    annotation reaches the device's events; and every blocking host
    synchronization of the solve (the sync debug mode's warnings) is a
    ``host_sync/*`` span."""
    import warnings

    from optimization_tpu_torch import headline
    from optimization_tpu_torch.solvers import tnt

    n, outer = 1 << 18, 4
    problem = headline.make_problem(n, dev, "streamed",
                                    jacobi_power=jacobi_power)
    params = headline.tier_params(0.0, max_tpcg=20, max_iterations=outer)
    x0 = headline.initial_point(n, torch.float32, dev, seed=3)
    g, x, B, aux = _gen_args(8, n, torch.float32, dev)
    kw = dict(a0_chunk=_gen_term("shifted", n, dev),
              weights=_gen_weights(8, n, dev))
    tnt.solve(problem, x0, params)          # builds, outside the trace
    T.stpcg_flat_streamed(g, x, B, 1e6, aux, **kw)
    torch.cuda.synchronize()
    before = T.stpcg_flat_streamed.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tnt.solve(problem, x0, params)
        T.stpcg_flat_streamed(g, x, B, 1e6, aux, **kw)
        torch.cuda.synchronize()
    launches = T.stpcg_flat_streamed.launches - before
    assert launches == outer + 1
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if str(e.device_type()).endswith("CUDA")]
    host = [e.name() for e in events
            if str(e.device_type()).endswith("CPU")]
    assert host.count("streamed_cg.prepare") == launches
    assert host.count("streamed_cg.launch") == launches
    ours = {m for m in host if m.startswith(
        ("tnt.", "host_sync/", "streamed_cg.", "headline."))}
    assert {"tnt.solve", "host_sync/tnt.status"} <= ours
    assert not ours & {e.name() for e in on_card}
    assert not any(e.is_user_annotation() for e in on_card)

    # the first switch to the debug mode in a process warns once that the
    # mode is a prototype (a message that names synchronizing operations)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tnt.solve(problem, x0, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    assert syncs == sum(m.startswith("host_sync/") for m in host)


# ---- the trial step, csrc/sphere_step.cu ----

def _sphere_step_module():
    # the module (the package's ``kernels.sphere_step`` is the function)
    import importlib
    return importlib.import_module("optimization_tpu_torch.kernels.sphere_step")


def _step_case(n, storage, step, dev, seed=11):
    """A point on the sphere and a step h (zero, or |h| ~ 0.3 in random
    directions) in ``storage``, with the headline's diagonal at n."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    x = x / torch.linalg.vector_norm(x)
    h = (0.3 * torch.randn(n, generator=gen, device=dev) / n ** 0.5 if step
         else torch.zeros(n, device=dev))
    return (x.to(storage), h.to(storage),
            T.AffineDiagonal(1.0, 999.0 / max(n - 1, 1)))


def _f64_dots(xp, g, a, rq):
    """The init group's ten dots, float64, of the stored x_prop and g."""
    xs, gs, a = xp.double(), g.double(), a.double()
    a0g = 2.0 * a * gs - float(rq) * gs
    pairs = {"rv": (gs, gs), "ar": (a0g, gs), "nr": (a0g, a0g),
             "m0": (xs, gs), "m1": (xs, 2.0 * a * gs), "mA0": (xs, a0g),
             "mA1": (xs, 2.0 * a * a0g), "UU00": (xs, xs),
             "UU01": (xs, 2.0 * a * xs), "UU11": (xs, 4.0 * a * a * xs)}
    return {k: (float(torch.dot(u, v)), float(torch.dot(u.abs(), v.abs())))
            for k, (u, v) in pairs.items()}


def _init_dots(init):
    return {"rv": init.rv, "ar": init.ar, "nr": init.nr, "m0": init.m[0],
            "m1": init.m[1], "mA0": init.mA[0], "mA1": init.mA[1],
            "UU00": init.UU[0, 0], "UU01": init.UU[0, 1],
            "UU11": init.UU[1, 1]}


@pytest.mark.parametrize("step", [False, True], ids=["h0", "step"])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 3, 7])
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sphere_step_matches_plain_version_and_float64(dev, storage, n, step):
    """The kernel against the plain version on the card and a float64
    evaluation.  x_prop and g are the plain version's rounding of the same
    f32 arithmetic (norm-relative 1e-6 in f32; in bf16 one storage
    rounding, 4e-3); f_prop and |g| to 1e-6 / 1e-5 relative; each init dot
    within 1e-5 of sum |u_i v_i| of its float64 value over the stored
    x_prop and g (f32 sums of ~10^2-10^3 terms a thread, then double) and
    of the plain version's; with_init=False its |g| from the identity."""
    S = _sphere_step_module()
    x, h, diag = _step_case(n, storage, step, dev)
    elem = S.DiagonalElem(diag, n, dev)
    before = S.sphere_step.launches
    out = S.sphere_step(x, h, elem, True)
    out0 = S.sphere_step(x, h, elem, False)
    assert S.sphere_step.launches == before + 2
    ref = S.sphere_step_reference(x, h, elem, True)
    ref0 = S.sphere_step_reference(x, h, elem, False)
    torch.cuda.synchronize()
    vtol = 4e-3 if storage == torch.bfloat16 else 1e-6
    for got, want in ((out[0], ref[0]), (out[2], ref[2])):
        assert got.dtype == storage and got.device == x.device
        _assert_step_close(got, want, vtol)
    assert torch.equal(out0[0], out[0]) and torch.equal(out0[2], out[2])
    for got, want, rtol in ((out[1], ref[1], 1e-6), (out[3], ref[3], 1e-5),
                            (out[4].rq, ref[4].rq, 1e-6),
                            (out0[3], ref0[3], 1e-5)):
        assert got.dtype == torch.float32 and got.shape == ()
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    assert out0[4].init is None and ref0[4].init is None
    dots = _f64_dots(out[0], out[2], elem.a, out[4].rq)
    plain = _init_dots(ref[4].init)
    for k, got in _init_dots(out[4].init).items():
        exact, scale = dots[k]
        assert abs(float(got) - exact) <= 1e-5 * scale, (k, float(got), exact)
        assert abs(float(got) - float(plain[k])) <= 2e-5 * scale, k
    assert torch.equal(out[4].init.UU[0, 1], out[4].init.UU[1, 0])
    torch.testing.assert_close(out[3] ** 2, out[4].init.rv, rtol=1e-6,
                               atol=0)

    # float64 from the same stored x and h and the f32 diagonal
    u = x.double() + h.double()
    a = elem.a.double()
    n2, fu = float(torch.dot(u, u)), float(torch.dot(u, a * u))
    c, f = n2 ** -0.5, fu / n2
    _assert_step_close(out[0], c * u, vtol)
    _assert_step_close(out[2], 2.0 * c * a * u - 2.0 * f * c * u, vtol)
    assert abs(float(out[1]) - f) <= 1e-6 * abs(f)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sphere_step_repeats_bitwise(dev, storage):
    """Two calls, and a call through the routing evaluator, are bitwise
    equal."""
    S = _sphere_step_module()
    n = (1 << 20) + 3
    x, h, diag = _step_case(n, storage, True, dev)
    elem = S.DiagonalElem(diag, n, dev)
    runs = [S.sphere_step(x, h, elem, True), S.sphere_step(x, h, elem, True),
            S.sphere_rayleigh_step(elem)(x, h, None)]
    flat = [[r[0], r[1], r[2], r[3], r[4].rq, *r[4].init] for r in runs]
    for other in flat[1:]:
        assert all(torch.equal(p, q) for p, q in zip(flat[0], other))


def test_sphere_step_makes_no_host_sync(dev):
    """Neither the wrapper nor the routing evaluator's route to it
    synchronizes with the host (after the first call, which builds the
    library)."""
    S = _sphere_step_module()
    n = 1 << 16
    x, h, diag = _step_case(n, torch.float32, True, dev)
    elem = S.DiagonalElem(diag, n, dev)
    step_eval = S.sphere_rayleigh_step(elem)
    S.sphere_step(x, h, elem)
    S.sphere_step(x.bfloat16(), h.bfloat16(), elem)
    torch.cuda.synchronize()
    before = S.sphere_step.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for hh in (h, torch.zeros_like(h)):
            step_eval(x, hh, None)
            step_eval(x.bfloat16(), hh.bfloat16(), None)
            S.sphere_step(x, hh, elem, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert S.sphere_step.launches == before + 6


@pytest.mark.parametrize("engine,storage,jacobi_power", [
    ("streamed", torch.float32, None), ("streamed", torch.float32, 0.25),
    ("flat", torch.bfloat16, None)], ids=["streamed", "jacobi", "flat-bf16"])
def test_headline_solve_takes_the_step_kernel(dev, engine, storage,
                                              jacobi_power):
    """A headline TNT solve on the card launches the trial-step kernel once
    a trial step and once for the seed (outer + 1), each in one
    ``sphere_step.launch`` span, calls no ``cudaMalloc`` once warm, and
    ends as the same solve with the plain
    evaluator (``linalg.flat_cg``'s): same status and outer iterations, f
    within 1e-5 (bf16: 1e-3) relative."""
    import dataclasses

    from optimization_tpu_torch import headline
    from optimization_tpu_torch.linalg.flat_cg import sphere_rayleigh_step
    from optimization_tpu_torch.solvers import tnt

    S = _sphere_step_module()
    n, outer = 1 << 18, 5
    kappa = 1e5 if jacobi_power else 1e3
    problem = headline.make_problem(n, dev, engine, kappa=kappa,
                                    jacobi_power=jacobi_power)
    elem = S.DiagonalElem(T.AffineDiagonal(1.0, (kappa - 1.0) / (n - 1)),
                          n, dev)
    plain = dataclasses.replace(problem, step_eval=sphere_rayleigh_step(elem))
    params = headline.tier_params(0.0, max_tpcg=20, max_iterations=outer)
    x0 = headline.initial_point(n, storage, dev, seed=5)
    tnt.solve(problem, x0, params)          # builds, outside the trace
    torch.cuda.synchronize()
    before = S.sphere_step.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = tnt.solve(problem, x0, params)
        torch.cuda.synchronize()
    launches = S.sphere_step.launches - before
    iters = int(res.num_iterations)
    assert launches == iters + 1
    events = list(prof.profiler.kineto_results.events())
    host = [e.name() for e in events
            if str(e.device_type()).endswith("CPU")]
    assert host.count("sphere_step.launch") == launches
    assert host.count("tnt.trial_step") == iters
    # the outputs and the scratch come from the caching allocator
    assert not [e.name() for e in events if e.name().startswith("cudaMalloc")]

    before = S.sphere_step.launches
    ref = tnt.solve(plain, x0, params)
    assert S.sphere_step.launches == before
    assert int(ref.num_iterations) == iters == outer
    assert int(ref.status) == int(res.status)
    rtol = 1e-3 if storage == torch.bfloat16 else 1e-5
    torch.testing.assert_close(res.f, ref.f, rtol=rtol, atol=0)
    assert res.x.dtype == storage


def _lines_weights(k, n_stored):
    return (tuple(torch.zeros(1) for _ in range(n_stored))
            + tuple(T.AffineDiagonal(0.5, 1e-3) for _ in range(k - n_stored)))


def test_any_k_layout_lines(dev):
    """Where csrc/streamed_cg_any.cu keeps its arrays on this card (an
    H100: 232,448 bytes of shared memory a block; the arithmetic in
    tests/test_torch_streamed_cg.py::test_any_k_plan_lines): at K = 40 in
    f32 all stored weights ride in one stage, two stages deep, up to 21 of
    them, and 22 come in two stages of 13, three deep (one stage with
    init=, which needs no basis rows); B' and U'U in shared memory up to
    K = 90; four stages at K = 8 with 4 stored weights, f32 and bf16."""
    if torch.cuda.get_device_properties(0).major != 9:
        pytest.skip("the lines are stated for a Hopper card")
    lay = T.any_k_layout
    p21, p22 = lay(40, 21), lay(40, 22)
    assert (p21["group"], p21["chunks"], p21["stages"]) == (21, 1, 2)
    assert (p22["group"], p22["chunks"], p22["stages"]) == (13, 2, 3)
    assert lay(40, 22, with_init=True)["chunks"] == 1
    assert lay(90, 0)["B_and_UU"] and not lay(91, 0)["B_and_UU"]
    for bf16 in (False, True):
        p = lay(8, 4, bf16=bf16)
        assert (p["chunks"], p["stages"]) == (1, 4)
    assert lay(5, 2, with_init=True)["smem_bytes"] <= lay(5, 2)["smem_bytes"]


# (K, stored weights) of the plan comparisons: small mixes, the one-stage
# line at K = 40, all generated, all stored, past the B' and U'U line
PLAN_SHAPES = [(5, 2), (8, 4), (16, 8), (32, 16), (40, 21), (40, 22),
               (64, 0), (32, 32), (116, 46), (212, 84)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("prec_kind", [0, 1, 2],
                         ids=["noP", "jacobi", "storedP"])
def test_any_k_plan_is_the_c_sides(dev, bf16, prec_kind):
    """kernels/streamed_cg.py:any_k_plan equals csrc/streamed_cg_any.cu's
    own plan on this card (its opt-in shared memory a block, which the
    kernel's zero static shared memory leaves whole) for every shape of
    PLAN_SHAPES, with a generated and a stored a0, with and without
    init=."""
    from optimization_tpu_torch.kernels.probes import card_capacity

    cap = card_capacity(dev)
    smem = cap["shared_bytes"] // cap["sms"]
    storage = torch.bfloat16 if bf16 else torch.float32
    for k, ks in PLAN_SHAPES:
        for a0_stored in (False, True):
            for with_init in (False, True):
                want = T.any_k_plan(
                    _lines_weights(k, ks), a0_stored=a0_stored,
                    storage=storage, prec_kind=prec_kind,
                    with_init=with_init, smem=smem).layout()
                got = T.any_k_layout(k, ks, a0_stored=a0_stored, bf16=bf16,
                                     prec_kind=prec_kind,
                                     with_init=with_init, device=dev)
                assert got == want, (k, ks, a0_stored, with_init)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_unrolled_ranks_match_plain_version(dev, k):
    """K = 1-4 keep csrc/streamed_cg.cu's register instantiations (K = 2
    in the general layout here, not the sphere's) and match the plain
    version at their tolerances with _gen_weights' order-1 weights."""
    n = 1 << 18
    g, x, B, aux = _gen_args(k, n, torch.float32, dev)
    kw = dict(a0_chunk=_gen_term("shifted", n, dev),
              weights=_gen_weights(k, n, dev), max_iterations=300,
              kappa_fgr=1e-3, theta=0.9)
    before = T.stpcg_flat_streamed.launches
    res = T.stpcg_flat_streamed(g, x, B, 1e6, aux, **kw)
    ref = T.stpcg_flat_streamed_reference(g, x, B, 1e6, aux, **kw)
    torch.cuda.synchronize()
    assert T.stpcg_flat_streamed.launches == before + 1
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= 1
    assert int(ref.num_iterations) > 3
    torch.testing.assert_close(res.update_step_M_norm,
                               ref.update_step_M_norm, rtol=1e-3, atol=0)
    _assert_step_close(res.s, ref.s, 2e-3)

# ---- the fused kernels (kernels/fused.py, csrc/fused.cu) ----


def _fused_inputs(n, dtype, dev, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p, hp, r = (torch.randn(n, generator=gen, device=dev).to(dtype)
                for _ in range(3))
    d = (1.0 + 999.0 * torch.rand(n, generator=gen, device=dev)).to(dtype)
    return p, hp, r, d


def _assert_within(got, ref, tol):
    err = (got.double() - ref.double()).abs()
    assert bool(torch.isfinite(got.double()).all())
    assert bool((err <= tol).all()), float((err / tol).max())


FUSED_DTYPES = [torch.float32, torch.bfloat16]
FUSED_N = [100, 4099, 999_999, 1 << 20]


@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", FUSED_N)
def test_cg_dots_matches_plain_version(dev, dtype, n):
    p, hp, r, _ = _fused_inputs(n, dtype, dev)
    before = F.cg_dots.launches
    got = torch.stack(F.cg_dots(p, hp, r))
    assert F.cg_dots.launches == before + 1
    assert got.dtype == dtype and got.device == p.device
    ref = torch.stack(F.cg_dots_reference(p, hp, r))
    P, HP, R = p.double(), hp.double(), r.double()
    pairs = ((P, HP), (HP, HP), (P, P), (P, R))
    exact = torch.stack([torch.sum(u * v) for u, v in pairs])
    tol = 1e-5 * torch.stack([torch.sum((u * v).abs()) for u, v in pairs])
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * exact.abs()
    _assert_within(got, ref, tol)
    _assert_within(got, exact, tol)


@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", FUSED_N)
def test_axpy_selfdot_matches_plain_version(dev, dtype, n):
    _, x, y, _ = _fused_inputs(n, dtype, dev)
    alpha = torch.tensor(-0.61, device=dev)
    before = F.axpy_selfdot.launches
    out, dot = F.axpy_selfdot(alpha, x, y)
    assert F.axpy_selfdot.launches == before + 1
    assert out.dtype == dot.dtype == dtype and dot.dim() == 0
    out_ref, dot_ref = F.axpy_selfdot_reference(alpha, x, y)
    bf16 = dtype == torch.bfloat16
    terms = (alpha.to(dtype).double() * x.double()).abs() + y.double().abs()
    _assert_within(out, out_ref, (2.0 ** -7 if bf16 else 2.0 ** -22) * terms)
    O2 = torch.sum(out.double() ** 2)
    _assert_within(dot, dot_ref, 1e-5 * O2 + (2.0 ** -5 * torch.sum(
        terms ** 2) if bf16 else 0))
    _assert_within(dot, O2, 1e-5 * O2 + (2.0 ** -7 * O2 if bf16 else 0))


@pytest.mark.parametrize("affine", [False, True], ids=["stored", "affine"])
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", FUSED_N)
def test_stencil_matches_plain_version(dev, dtype, n, affine):
    v, _, _, d = _fused_inputs(n, dtype, dev)
    b = 999.0 / (n - 1)
    fn = F.affine_stencil_matvec if affine else F.diag_stencil_matvec
    before = fn.launches
    if affine:
        got = F.affine_stencil_matvec(v, a=1.0, b=b, scale=0.5)
        ref = F.affine_stencil_matvec_reference(v, a=1.0, b=b, scale=0.5)
        dd = T.AffineDiagonal(1.0, b).values(n, dev).double()
    else:
        got = F.diag_stencil_matvec(d, v, scale=0.5)
        ref = F.diag_stencil_matvec_reference(d, v, scale=0.5)
        dd = d.double()
    assert fn.launches == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    V = v.double()
    z = V.new_zeros(1)
    terms = (((dd + 2.0) * V).abs() + torch.cat([V[1:], z]).abs()
             + torch.cat([z, V[:-1]]).abs()) * 0.5
    bf16 = dtype == torch.bfloat16
    _assert_within(got, ref, (2.0 ** -5 if bf16 else 2.0 ** -22) * terms)
    if not bf16:
        # the same f32 roundings in the same order
        assert torch.equal(got, ref)


def test_fused_reductions_are_bitwise_repeatable(dev):
    p, hp, r, _ = _fused_inputs(1 << 20, torch.float32, dev)
    assert torch.equal(torch.stack(F.cg_dots(p, hp, r)),
                       torch.stack(F.cg_dots(p, hp, r)))
    alpha = torch.tensor(0.37, device=dev)
    (o1, d1), (o2, d2) = F.axpy_selfdot(alpha, hp, r), F.axpy_selfdot(
        alpha, hp, r)
    assert torch.equal(o1, o2) and torch.equal(d1, d2)


def test_fused_kernels_reject_other_dtypes(dev):
    x = torch.ones(16, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        F.cg_dots(x, x, x)
    with pytest.raises(ValueError, match="one dtype"):
        F.diag_stencil_matvec(x.float(), x.to(torch.bfloat16))


def test_fused_stpcg_on_card_matches_generic(dev):
    """stpcg(fused_dots=True) on the card: the kernels inside the CG loop,
    the same iterates as the generic route (f32 dots in other orders:
    the tolerances of tests/test_stpcg.py::test_fused_dots_matches_generic)."""
    from optimization_tpu_torch.linalg import stpcg

    n = 1 << 16
    d = torch.linspace(1.0, 50.0, n, device=dev)
    g = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    kw = dict(max_iterations=50, kappa_fgr=1e-6, theta=0.9)
    before = F.cg_dots.launches
    fused = stpcg(g, lambda v: d * v, torch.dot, 100.0, fused_dots=True, **kw)
    ref = stpcg(g, lambda v: d * v, torch.dot, 100.0, **kw)
    assert F.cg_dots.launches - before >= int(fused.num_iterations) > 5
    assert int(fused.num_iterations) == int(ref.num_iterations)
    torch.testing.assert_close(fused.s, ref.s, rtol=2e-4, atol=2e-5)


# ---- stream3_probe (csrc/fused.cu) and gram_pair (csrc/gram_pair.cu) ----


@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", FUSED_N)
def test_stream3_probe_matches_plain_version(dev, dtype, n):
    v, _, _, d = _fused_inputs(n, dtype, dev)
    before = F.stream3_probe.launches
    got = F.stream3_probe(d, v, scale=0.5)
    assert F.stream3_probe.launches == before + 1
    ref = F.stream3_probe_reference(d, v, scale=0.5)
    assert got.dtype == dtype and got.shape == (n,)
    if dtype == torch.float32:
        assert torch.equal(got, ref)        # the same three roundings
    else:
        terms = ((d.double() + 2.0) * v.double()).abs() * 0.5
        _assert_within(got, ref, 2.0 ** -6 * terms)


def _gram_inputs(shape, dtype, dev, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(3)]


# k across the kernel's plan (kernels/fused.py:gram_plan): 16-column
# chunk widths, rows 16-byte aligned at k % 4 == 0 in f32 and k % 8 == 0 in
# bf16 (else the span route), ragged m, fleets of sizes that do not divide
# the card's 132 SMs and instances that start off 16-byte boundaries
# (3 x 777 x 17); above 64 columns the panels (2 at k = 97, 120, 128; 6 at
# 129 and 192; 8 at 200 and 256; rows copied one by one at 263 in f32),
# aligned and not; odd k in bf16 (33)
GRAM_CASES = [(1000, 48), (999, 30), (3, 777, 17), (200, 96),
              (5, 1), (1, 1), (7, 8), (999, 16), (100_001, 17), (7, 48),
              (100_001, 48), (999, 64), (1, 95), (7, 2000, 48),
              (5, 999, 95), (13, 1000, 96), (1000, 97), (100_001, 120),
              (5, 999, 192), (7, 2000, 120), (999, 200), (3, 70, 97),
              (999, 128), (999, 129), (400, 256), (2000, 33), (1000, 263)]
# long row streams a block: the kernel folds its wgmma chains every row
# tile (chip_smoke.GRAM_LONG)
GRAM_LONG = [(400_000, 48), (2, 100_000, 48), (100_000, 96)]


@pytest.mark.parametrize("bs", ["distinct", "S"])
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GRAM_CASES,
                         ids=["x".join(map(str, c)) for c in GRAM_CASES])
def test_gram_pair_matches_plain_version(dev, dtype, shape, bs):
    S, AS, BS = _gram_inputs(shape, dtype, dev)
    if bs == "S":
        BS = S          # the kernel reads S once
    before = F.gram_pair.launches
    ga, gb = F.gram_pair(S, AS, BS)
    assert F.gram_pair.launches == before + 1
    ra, rb = F.gram_pair_reference(S, AS, BS.clone())
    k = shape[-1]
    assert ga.shape == shape[:-2] + (k, k) and ga.dtype == torch.float32
    Sd = S.double()
    for got, ref, X in ((ga, ra, AS), (gb, rb, BS)):
        terms = Sd.abs().mT @ X.double().abs()
        _assert_within(got, ref, 1e-5 * terms)
        _assert_within(got, Sd.mT @ X.double(), 1e-5 * terms)
    if bs == "S":
        # the S-once route against the three-array one on a copy of S
        ca, cb = F.gram_pair(S, AS, S.clone())
        terms = Sd.abs().mT @ Sd.abs()
        _assert_within(gb, cb, 1e-5 * terms)
        _assert_within(ga, ca, 1e-5 * (Sd.abs().mT @ AS.double().abs()))
    # bitwise repeat: fixed summation order, no atomics
    ga2, gb2 = F.gram_pair(S, AS, BS)
    assert torch.equal(ga, ga2) and torch.equal(gb, gb2)


@pytest.mark.parametrize("bs", ["distinct", "S"])
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GRAM_LONG,
                         ids=["x".join(map(str, c)) for c in GRAM_LONG])
def test_gram_pair_long_chains_match_f64(dev, dtype, shape, bs):
    """Long row streams: within 1e-5 sum|S||X| of the float64 product (the
    tensor cores' one-way drift would pass it unsplit).  The plain version
    is no yardstick here: its own f32 sums miss the tolerance on the fleet
    (2.8 and 6.9 times it in f32 and bf16 on an H100)."""
    S, AS, BS = _gram_inputs(shape, dtype, dev)
    if bs == "S":
        BS = S
    before = F.gram_pair.launches
    ga, gb = F.gram_pair(S, AS, BS)
    assert F.gram_pair.launches == before + 1
    Sd = S.double()
    for got, X in ((ga, AS), (gb, BS)):
        _assert_within(got, Sd.mT @ X.double(),
                       1e-5 * (Sd.abs().mT @ X.double().abs()))
    ga2, gb2 = F.gram_pair(S, AS, BS)
    assert torch.equal(ga, ga2) and torch.equal(gb, gb2)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=["f32", "bf16"])
def test_gram_plan_is_the_c_sides(dev, dtype, aligned):
    """kernels/fused.py:gram_plan equals csrc/gram_pair.cu's plan on this
    card (its SM count; one block an SM) at every card shape, and a call
    at an unaligned base runs the route that plan names."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = sorted(set(GRAM_CASES + GRAM_LONG))
    for shape in shapes:
        m, k = shape[-2], shape[-1]
        fleet = shape[0] if len(shape) == 3 else 1
        for same in (False, True):
            want = F.gram_plan(m, k, dtype, same, fleet, aligned=aligned,
                               sms=sms)
            got = F.card_gram_plan(m, k, dtype, same, fleet,
                                   aligned=aligned, device=dev)
            assert got == want, (shape, same)
    # a base 4 bytes off a 16-byte boundary: the span route, same results
    S, AS, BS = _gram_inputs((2001, 48), dtype, dev)
    off = [t.flatten()[2:2 + 2000 * 48].view(2000, 48) for t in (S, AS, BS)]
    ga, gb = F.gram_pair(*off)
    Sd = off[0].double()
    for got, X in ((ga, off[1]), (gb, off[2])):
        _assert_within(got, Sd.mT @ X.double(),
                       1e-5 * (Sd.abs().mT @ X.double().abs()))


def test_gram_pair_takes_S_twice_and_rejects(dev):
    """S as BS; any k, up to LOBPCG's 3 nx at nx = 33, 40, 64 (the kernel
    once refused k > 96 here): one launch a call, within
    chip_smoke.GRAM_TOLERANCES of the plain version; f64 still refused."""
    S, AS, _ = _gram_inputs((500, 24), torch.float32, dev)
    ga, gb = F.gram_pair(S, AS, S)
    _assert_within(gb, S.double().mT @ S.double(),
                   1e-5 * (S.double().abs().mT @ S.double().abs()))
    for k in (97, 120, 192):
        for dtype in FUSED_DTYPES:
            S, AS, BS = _gram_inputs((3000, k), dtype, dev, seed=k)
            before = F.gram_pair.launches
            got = F.gram_pair(S, AS, BS)
            assert F.gram_pair.launches == before + 1
            Sd = S.double().abs().mT
            for g, r, X in zip(got, F.gram_pair_reference(S, AS, BS),
                               (AS, BS)):
                assert g.shape == (k, k) and g.dtype == torch.float32
                _assert_within(g, r, 1e-5 * (Sd @ X.double().abs()))
    x = torch.ones(10, 4, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        F.gram_pair(x, x, x)


def test_eigensolver_defaults_are_the_card(dev):
    """With no X0 and no generator, lobpcg and its driver draw on the card
    and solve there; the interop helpers put tensors on the card."""
    import numpy as np

    from optimization_tpu_torch.core.driver import drive_lobpcg
    from optimization_tpu_torch.interop import tensor_from_numpy
    from optimization_tpu_torch.linalg import lobpcg

    m = 2000
    d = torch.linspace(1.0, float(m), m, device=dev)
    kw = dict(T=lambda S: S / d[:, None], m=m, nx=8, nev=4, tau=1e-4)
    res = lobpcg(lambda S: d[:, None] * S, max_iterations=30, **kw)
    assert res.X.device.type == "cuda" and res.X.dtype == torch.float32
    assert int(res.num_converged) >= 4
    chunked, _ = drive_lobpcg(lambda S: d[:, None] * S, max_iterations=30,
                              chunk_iterations=2, **kw)
    assert chunked.X.device.type == "cuda"
    torch.testing.assert_close(chunked.theta, res.theta, rtol=1e-6, atol=0)
    assert tensor_from_numpy(np.ones(3)).device.type == "cuda"


def test_lobpcg_f32_on_card_launches_gram_pair(dev):
    """A small f32 solve on the card: both Gram stages through the kernel,
    1 + num_iterations launches; the eigenvalues of diag(1..m)."""
    from optimization_tpu_torch.linalg import lobpcg

    m = 4000
    d = torch.linspace(1.0, float(m), m, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = F.gram_pair.launches
    res = lobpcg(lambda S: d[:, None] * S, T=lambda S: S / d[:, None],
                 m=m, nx=8, nev=4, max_iterations=50, tau=1e-4,
                 generator=gen, rr_method="chol")
    torch.cuda.synchronize()
    assert res.X.device.type == "cuda" and res.X.dtype == torch.float32
    assert F.gram_pair.launches - before == 1 + int(res.num_iterations)
    assert int(res.num_converged) >= 4 and bool(res.pencil_consistent)
    torch.testing.assert_close(res.theta.cpu(), torch.arange(1.0, 5.0),
                               rtol=0, atol=5e-2)


def test_lobpcg_nx40_on_card_matches_cpu_route(dev):
    """f32 LOBPCG at nx = 40 (a basis of 120 columns: gram_pair's panel
    route) on the card against the CPU route (the plain Gram stage) on the
    same X0.  Iterates with the convergence test disarmed (tau = 1e-30,
    4 iterations): theta within 5e-4, f32's eigenvalue floor eps ||A|| =
    4.8e-4 at m = 4000 (two f32 Gram stages that agree to 1e-5 sum|S||X|,
    then f32 Rayleigh-Ritz steps; measured 1.7e-4 on an H100; a Gram-stage
    error moves theta by far more).
    Converged (tau = 1e-4): both converge to the truth within 5e-2 (f32's
    floor at this m, as in chip_smoke phase 8), the card with 1 + its
    iterations launches."""
    import numpy as np

    from optimization_tpu_torch.linalg import lobpcg, lobpcg_fleet

    m, nx, nev = 4000, 40, 5
    d = np.linspace(1.0, float(m), m, dtype=np.float32)
    x0 = np.random.default_rng(40).standard_normal((m, nx)).astype(
        np.float32)

    def solve(device, **kw):
        dt = torch.from_numpy(d).to(device)
        return lobpcg(lambda S: dt[:, None] * S, T=lambda S: S / dt[:, None],
                      X0=torch.from_numpy(x0).to(device), nev=nev,
                      generator=torch.Generator(device=device).manual_seed(1),
                      **kw)

    fixed = dict(max_iterations=4, tau=1e-30)
    card, cpu = solve(dev, **fixed), solve("cpu", **fixed)
    assert int(card.num_iterations) == int(cpu.num_iterations) == 4
    torch.testing.assert_close(card.theta.cpu(), cpu.theta, rtol=0,
                               atol=5e-4)
    before = F.gram_pair.launches
    card = solve(dev, max_iterations=100, tau=1e-4)
    torch.cuda.synchronize()
    assert F.gram_pair.launches - before == 1 + int(card.num_iterations)
    cpu = solve("cpu", max_iterations=100, tau=1e-4)
    truth = torch.arange(1.0, nev + 1.0)
    for res in (card, cpu):
        assert int(res.num_converged) >= nev and bool(res.pencil_consistent)
        torch.testing.assert_close(res.theta.cpu(), truth, rtol=0, atol=5e-2)
    # a fleet of two at nx = 40: its batched Gram stage, (2, m, 120)
    ds = torch.from_numpy(np.stack([d, 2.0 * d])).to(dev)
    before = F.gram_pair.launches
    fl = lobpcg_fleet(lambda S, dd: dd[:, None] * S, ds,
                      T=lambda S, dd: S / dd[:, None], m=m, nx=nx, nev=nev,
                      max_iterations=100, tau=1e-4,
                      generator=torch.Generator(device=dev).manual_seed(2),
                      rr_method="chol")
    torch.cuda.synchronize()
    assert F.gram_pair.launches - before == 1 + int(fl.num_iterations.max())
    assert bool((fl.num_converged >= nev).all())
    torch.testing.assert_close(fl.theta.cpu(),
                               torch.stack([truth, 2.0 * truth]), rtol=0,
                               atol=1e-1)


# ---- the residency probe kernels (csrc/probes.cu) ----


def _probe_vectors(n, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(0.5 + 0.5 * torch.rand(n, generator=gen, device=dev)).to(dtype)
            for _ in range(3)]


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


@pytest.mark.parametrize("with_s", [False, True], ids=["no-s", "with-s"])
@pytest.mark.parametrize("K", [3, 10])
@pytest.mark.parametrize("n", [1 << 18, 100_003, 100])
def test_pinned_stream_matches_plain_version(dev, n, K, with_s):
    """Tolerances of ``chip_smoke.PROBE_TOLERANCES``: vectors 1e-5 norm to
    norm, acc 1e-5 relative; the held, shared-memory-only and streamed arms
    and a repeat bit for bit; one launch a call."""
    from optimization_tpu_torch.kernels import probes as P

    r, p, x = _probe_vectors(n, torch.float32, dev, n % 997)
    s = torch.zeros(n, device=dev) if with_s else None
    ref = P.pinned_stream_reference(r, p, x, s, iterations=K)
    before = P.pinned_stream.launches
    out = P.pinned_stream(r, p, x, s, iterations=K)
    assert P.pinned_stream.launches == before + 1
    assert P.pinned_stream.last_held["x_shared"] == 1.0   # these n fit
    arms = [P.pinned_stream(r, p, x, s, iterations=K, **kw)
            for kw in (dict(hold_x=False), dict(l2_window=True), dict())]
    torch.cuda.synchronize()
    for got, want in zip(out[:3], ref[:3]):
        if want is None:
            assert got is None
            continue
        assert got.device == r.device and got.dtype == torch.float32
        assert _rel(got, want) <= 1e-5
    assert out[3].device == r.device and out[3].shape == ()
    assert abs(float(out[3]) - float(ref[3])) <= 1e-5 * abs(float(ref[3]))
    for arm in arms:
        assert all(torch.equal(u, v) for u, v in zip(arm, out)
                   if u is not None)


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("K", [3, 10])
@pytest.mark.parametrize("n", [1 << 18, 100_003, 100, 6_000_001,
                               (1 << 23) + 3])
def test_resident_body_matches_plain_version(dev, n, K, storage):
    """r within 1e-3 (bf16: a flipped storage rounding here and there; a
    rounding left out would show as ~4e-3) or 1e-5 (f32) norm to norm, acc
    within 1e-3 / 1e-4; the resident and streamed arms and a repeat bit for
    bit.  The three small n fit shared memory whole; at 6,000,001 and
    2^23 + 3 a part is held (x in part, or r and p in part with the rest
    streamed: the held and streamed items share a thread's trips), and the
    arms stay bitwise equal there too."""
    from optimization_tpu_torch.kernels import probes as P

    r, p, x = _probe_vectors(n, storage, dev, n % 991)
    ref = P.resident_body_reference(r, p, x, iterations=K)
    before = P.resident_body.launches
    out = P.resident_body(r, p, x, iterations=K)
    assert P.resident_body.launches == before + 1
    held = P.resident_body.last_held
    if n <= 1 << 18:
        assert held["rp_shared"] == 1.0
    else:
        assert 0.0 < held["rp_shared"] <= 1.0
        assert held["rp_shared"] < 1.0 or held["x_shared"] < 1.0
    streamed = P.resident_body(r, p, x, iterations=K, resident=False)
    again = P.resident_body(r, p, x, iterations=K)
    torch.cuda.synchronize()
    bf16 = storage == torch.bfloat16
    assert out[0].dtype == storage and out[0].device == r.device
    assert _rel(out[0], ref[0]) <= (1e-3 if bf16 else 1e-5)
    assert abs(float(out[1]) - float(ref[1])) <= \
        (1e-3 if bf16 else 1e-4) * abs(float(ref[1]))
    for arm in (streamed, again):
        assert torch.equal(arm[0], out[0]) and torch.equal(arm[1], out[1])


def test_probe_kernels_partly_held_at_full_width(dev):
    """n = 2^24: shared memory holds a part of x (of r and p) only, the
    rest streams; still bitwise equal to the all-streamed arm, and within
    the small sizes' limits of the plain version (the streamed regions'
    code runs only here).  At n = 6,000,001 in bf16, r and p are resident
    and x in part."""
    from optimization_tpu_torch.kernels import probes as P

    n = 1 << 24
    r, p, x = _probe_vectors(n, torch.float32, dev, 5)
    s = torch.zeros(n, device=dev)
    for sv in (None, s):
        ref = P.pinned_stream_reference(r, p, x, sv, iterations=4)
        out = P.pinned_stream(r, p, x, sv, iterations=4)
        assert 0.2 < P.pinned_stream.last_held["x_shared"] < 1.0
        for got, want in zip(out[:3], ref[:3]):
            assert want is None or _rel(got, want) <= 1e-5
        assert abs(float(out[3]) - float(ref[3])) <= 1e-5 * abs(float(ref[3]))
    del ref, out, s
    held = P.pinned_stream(r, p, x, iterations=4)
    share = P.pinned_stream.last_held["x_shared"]
    assert 0.2 < share < 1.0
    assert P.pinned_stream.last_held["x_l2_window"] == 0.0
    streamed = P.pinned_stream(r, p, x, iterations=4, hold_x=False)
    windowed = P.pinned_stream(r, p, x, iterations=4, l2_window=True)
    assert P.pinned_stream.last_held["x_l2_window"] > 0.0
    for arm in (streamed, windowed):
        assert all(torch.equal(u, v) for u, v in zip(held, arm)
                   if u is not None)
    rb, pb, xb = (v.to(torch.bfloat16) for v in (r, p, x))
    res = P.resident_body(rb, pb, xb, iterations=4)
    assert 0.2 < P.resident_body.last_held["rp_shared"] < 1.0
    st = P.resident_body(rb, pb, xb, iterations=4, resident=False)
    assert torch.equal(res[0], st[0]) and torch.equal(res[1], st[1])
    for rv, pv, xv, tol_r, tol_acc in (
            (rb, pb, xb, 1e-3, 1e-3), (r, p, x, 1e-5, 1e-4),
            (rb[:6_000_001], pb[:6_000_001], xb[:6_000_001], 1e-3, 1e-3)):
        ref = P.resident_body_reference(rv, pv, xv, iterations=4)
        out = P.resident_body(rv, pv, xv, iterations=4)
        h = P.resident_body.last_held
        if rv.shape[0] == n:
            assert 0.0 < h["rp_shared"] < 1.0
        else:
            assert h["rp_shared"] == 1.0 and 0.0 < h["x_shared"] < 1.0
        assert _rel(out[0], ref[0]) <= tol_r
        assert abs(float(out[1]) - float(ref[1])) <= \
            tol_acc * abs(float(ref[1]))


def test_probe_kernels_reject_what_they_do_not_take(dev):
    from optimization_tpu_torch.kernels import probes as P

    v = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        P.pinned_stream(v.double(), v.double(), v.double(), iterations=2)
    with pytest.raises(ValueError, match="one device"):
        P.pinned_stream(v, v, v.cpu(), iterations=2)
    with pytest.raises(ValueError, match="bfloat16"):
        P.resident_body(v.half(), v.half(), v.half(), iterations=2)
    with pytest.raises(ValueError, match="iterations"):
        P.resident_body(v, v, v, iterations=0)


def test_prec_that_is_not_the_descriptors_map_raises_on_the_card(dev):
    """The kernel never calls ``prec``; a map that is not its descriptor's
    own would un-transform differently on the CPU route, so the wrapper
    refuses it on the card too (and launches nothing)."""
    args, kw = _pd_fixture(1 << 14, torch.float32, dev)
    g, _, _, _, (rq,) = args
    n = g.shape[0]
    pc, pmap, diag = _prec("quarter", args)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    kw = dict(kw, a0_chunk=a0c, weights=weights)
    pv = pmap.values()
    before = T.stpcg_flat_streamed.launches
    for wrong in (lambda v: v * pv,
                  T.JacobiPower(1.0, 0.5).map(diag, rq, n, dev),
                  pc.map(diag, rq + 1.0, n, dev),
                  T.stored_prec_map(pv)):
        with pytest.raises(ValueError, match="itself"):
            T.stpcg_flat_streamed(*args, prec_chunk=pc, prec=wrong, **kw)
    with pytest.raises(ValueError, match="itself"):
        T.stpcg_flat_streamed(*args, prec_chunk=pv, prec=pmap, **kw)
    assert T.stpcg_flat_streamed.launches == before
    # an equal map built anew is accepted, and gives the same step
    r1 = T.stpcg_flat_streamed(*args, prec_chunk=pc, prec=pmap, **kw)
    r2 = T.stpcg_flat_streamed(
        *args, prec_chunk=T.JacobiPower(1.0, 0.25),
        prec=T.JacobiPower(1.0, 0.25).map(diag, rq.clone(), n, dev), **kw)
    assert torch.equal(r1.s, r2.s)
    assert T.stpcg_flat_streamed.launches == before + 2


def test_convex_solvers_live_on_the_card(dev):
    """FISTA, ADMM and their drivers on card tensors: every result leaf on
    the card, the chunked drives bitwise equal to the monolithic solves."""
    import dataclasses

    from optimization_tpu_torch import CompositeProblem
    from optimization_tpu_torch.core.driver import drive, drive_admm
    from optimization_tpu_torch.core.tree import tree_leaves
    from optimization_tpu_torch.solvers import admm, prox
    from optimization_tpu_torch.solvers import proximal_gradient as pg

    m, n, mu = 60, 200, 0.1
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((m, n), generator=gen, device=dev) / m ** 0.5
    xt = torch.where(torch.rand(n, generator=gen, device=dev) < 0.05,
                     torch.randn(n, generator=gen, device=dev),
                     torch.zeros(n, device=dev))
    b = A @ xt + 0.01 * torch.randn(m, generator=gen, device=dev)
    problem = CompositeProblem(
        f=lambda x, d: 0.5 * torch.sum((d[0] @ x - d[1]) ** 2),
        g=lambda x, d: mu * torch.sum(torch.abs(x)),
        prox_g=lambda x, lam, d: prox.soft_threshold(x, lam * mu))
    params = pg.ProximalGradientParams(
        max_iterations=300, composite_gradient_tolerance=1e-3,
        relative_composite_gradient_tolerance=1e-6)
    x0 = torch.zeros(n, device=dev)
    res = pg.solve(problem, x0, params, (A, b))
    assert int(res.status) == 1
    assert all(t.device.type == "cuda" for t in tree_leaves(res))
    chunked = drive(pg, problem, x0, params, (A, b), chunk_iterations=7)
    assert torch.equal(chunked.x, res.x) and chunked.x.device.type == "cuda"

    AtA, Atb = A.T @ A, A.T @ b
    chol = torch.linalg.cholesky(AtA + torch.eye(n, device=dev))
    lasso = admm.ADMMProblem(
        minLx=lambda y, lam, rho, d: torch.cholesky_solve(
            (Atb + rho * y - lam)[:, None], chol)[:, 0],
        minLy=lambda x, lam, rho, d: prox.soft_threshold(x + lam / rho,
                                                         mu / rho),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    ap = admm.ADMMParams(max_iterations=250, eps_rel=1e-4, eps_abs_pri=1e-3,
                         eps_abs_dual=1e-3, mode=admm.ADMMMode.ACCELERATED)
    z = torch.zeros(n, device=dev)
    ares = admm.solve(lasso, z, z, z, ap)
    assert int(ares.status) == 1
    assert all(t.device.type == "cuda" for t in tree_leaves(ares))
    ach = drive_admm(lasso, z, z, z, ap, chunk_iterations=9)
    assert torch.equal(ach.x, ares.x) and torch.equal(ach.y, ares.y)
    assert float(torch.linalg.vector_norm(ares.y - res.x)) <= \
        5e-2 * float(torch.linalg.vector_norm(res.x))
    assert dataclasses.is_dataclass(ap)


# ---- the chunk reader (csrc/probes.cu) and the rotation-sync models ----


def _chunk_check(v, gr, rnd, n_fetch, start=0):
    """chunk_reader's result, after holding it and the plain version
    against the float64 sum of the chunks read (chip_smoke.CHUNK_TOLERANCES):
    bit for bit on integer-valued v, within 1e-7 sum|values read| else."""
    from optimization_tpu_torch.kernels import probes as P

    out = P.chunk_reader(v, gr, rnd, n_fetch, start=start)
    plain = P.chunk_reader_reference(v, gr, rnd, n_fetch, start=start)
    vd = v.double()
    ref, scale = (float(P.chunk_reader_reference(x, gr, rnd, n_fetch,
                                                 start=start))
                  for x in (vd, vd.abs()))
    tol = 0.0 if bool((v == v.round()).all()) else 1e-7 * scale
    assert abs(float(out) - ref) <= tol
    assert abs(float(plain) - ref) <= tol
    return out


def _chunk_v(rows, kind, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "integer":
        return torch.randint(-8, 9, (rows, 128), generator=gen,
                             device=dev).float()
    return torch.randn((rows, 128), generator=gen, device=dev)


@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("n_fetch", [1, 3, 2048, None])
@pytest.mark.parametrize("random_offsets", [False, True],
                         ids=["contiguous", "random"])
@pytest.mark.parametrize("gr", [1, 8, 64, 512])
@pytest.mark.parametrize("rows", [1 << 16, 1001])
def test_chunk_reader_matches_plain_version(dev, rows, gr, random_offsets,
                                            n_fetch, kind):
    """chunk_reader and its plain version equal to the float64 sum on
    integer-valued v, within 1e-7 of sum|values read| on normal v, at
    n_fetch 1, 3, 2048 and nch (None: one sweep, many pieces a warp); one
    launch a call."""
    from optimization_tpu_torch.kernels import probes as P

    v = _chunk_v(rows, kind, rows + gr, dev)
    before = P.chunk_reader.launches
    out = _chunk_check(v, gr, random_offsets, n_fetch or rows // gr)
    torch.cuda.synchronize()
    assert P.chunk_reader.launches == before + 1
    assert out.shape == (1, 1) and out.device == v.device


def test_chunk_reader_int32_min_offset_and_repeat(dev):
    """The fetch whose LCG value is INT32_MIN (t = 2,088,216,195), reached
    with start= on a small v: the floor-mod offset, as in the plain
    version; two runs bitwise equal; 65,536 random 4 KiB fetches over 2^26
    words equal to the float64 sum."""
    from optimization_tpu_torch.kernels import probes as P

    v = _chunk_v(1001, "integer", 1, dev)
    for gr in (1, 8):
        nch = 1001 // gr
        start = 2_088_216_194
        off = P.chunk_offsets(torch.arange(start, start + 3, device=dev), nch)
        assert int(off[1]) == (-(1 << 31)) % nch
        out = _chunk_check(v, gr, True, 3, start)
        assert torch.equal(out, P.chunk_reader(v, gr, True, 3, start=start))
    big = _chunk_v(1 << 19, "integer", 2, dev)
    a = _chunk_check(big, 8, True, 65536)
    assert torch.equal(a, P.chunk_reader(big, 8, True, 65536))


def test_chunk_reader_rejects_on_the_card(dev):
    from optimization_tpu_torch.kernels import probes as P

    v = torch.ones(16, 128, device=dev)
    before = P.chunk_reader.launches
    with pytest.raises(ValueError, match="f32"):
        P.chunk_reader(v.half(), 1, False, 1)
    with pytest.raises(ValueError, match="gr <= rows"):
        P.chunk_reader(v, 32, False, 1)
    with pytest.raises(ValueError, match="contiguous"):
        P.chunk_reader(torch.ones(128, 16, device=dev).t(), 1, False, 1)
    assert P.chunk_reader.launches == before


@pytest.mark.parametrize("name,shape", [("stiefel", (1000, 3)),
                                        ("rotations", (5000, 3, 3)),
                                        ("grassmann", (1000, 4))])
def test_matrix_manifolds_on_card_match_cpu(dev, name, shape):
    """proj and the polar retraction (batched eigh) on the card within f32
    tolerance of the CPU; retracted points orthonormal, det > 0 for SO(3).
    The retraction takes a tangent step, so X + V has singular values >= 1
    (an ambient step can make a block nearly singular, where the inverse
    square root amplifies the two eigh's last-bit differences)."""
    from optimization_tpu_torch import manifolds as Mf

    M = getattr(Mf, name)()
    gen = torch.Generator(device=dev).manual_seed(2)
    x = M.rand(gen, *shape)
    assert x.device.type == "cuda" and x.dtype == torch.float32
    a = 0.3 * torch.randn(shape, generator=gen, device=dev)
    v = M.proj(x, a)
    torch.testing.assert_close(v.cpu(), M.proj(x.cpu(), a.cpu()), rtol=1e-5,
                               atol=1e-5)
    y = M.retract(x, v)
    torch.testing.assert_close(y.cpu(), M.retract(x.cpu(), v.cpu()),
                               rtol=1e-5, atol=1e-5)
    eye = torch.eye(shape[-1], device=dev)
    assert float((y.mT @ y - eye).abs().max()) < 1e-5
    if name == "rotations":
        assert bool((torch.linalg.det(y) > 0).all())


@pytest.mark.parametrize("method", ["scatter", "gather", "sort",
                                    "adjacency"])
def test_connection_laplacian_on_card_matches_cpu(dev, method):
    """Each scatter_method on the card within f32 tolerance of the CPU
    apply (the card adds each vertex's contributions in another order than
    the CPU, the same order in every run)."""
    from optimization_tpu_torch.models import rotation_sync as rs

    gen = torch.Generator().manual_seed(3)
    _, data = rs.random_instance(gen, 2000, 3, extra_edges=4000, noise=0.05)
    X = torch.randn((6000, 5), generator=gen)
    ref = rs.connection_laplacian_op(data, 2000, 3,
                                     scatter_method=method)(X)
    card = rs.RotationSyncData(*(t.to(dev) for t in data[:3]))
    L = rs.connection_laplacian_op(card, 2000, 3, scatter_method=method)
    got = L(X.to(dev))
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-4)


def test_model_defaults_are_the_card(dev):
    """random_instance with no generator and no device draws and places on
    the card, as do the completion instance and the default certificate."""
    from optimization_tpu_torch.models import matrix_completion as mc
    from optimization_tpu_torch.models import rotation_sync as rs
    from optimization_tpu_torch.solvers import tnt

    R_true, data = rs.random_instance(None, 200, 3, extra_edges=400,
                                      noise=0.01)
    assert R_true.device.type == "cuda" and data.src.device.type == "cuda"
    assert data.src.dtype == torch.int64
    R0 = rs.spectral_init(data, 200, 3)
    res = tnt.solve(rs.make_problem(), R0, tnt.TNTParams(
        max_iterations=50, gradient_tolerance=2e-3,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0), data=data)
    assert res.x.device.type == "cuda"
    assert float(rs.mean_rotation_error(res.x, R_true)) < 0.04
    cert = rs.certify(res.x, data)
    assert bool(cert.certified)
    M_true, cdata = mc.random_instance(None, 50, 40, 2)
    assert M_true.device.type == "cuda" and cdata.lam.device.type == "cuda"


def _pose_graph(n, extra, noise, seed):
    """``chip_smoke.pose_graph``: a pose graph in the g2o convention, made
    on the host (t at scale 5)."""
    import chip_smoke

    return chip_smoke.pose_graph(torch, n, extra, noise, 5.0, seed)


def test_pose_cli_runs_on_the_card_by_default(dev, tmp_path, capsys):
    """``python -m optimization_tpu_torch solve --marginalized --certify``
    with no --device solves on the card: rc 0, certified, rotation error
    under 4 noise; ``solve_pose_graph`` with no device returns card
    tensors."""
    import json

    import numpy as np

    from optimization_tpu_torch import cli
    from optimization_tpu_torch.io import g2o
    from optimization_tpu_torch.models import pose_sync as ps

    graph, R, t = _pose_graph(300, 600, 0.01, seed=4)
    path = str(tmp_path / "g.g2o")
    g2o.save_g2o(path, graph)
    out = str(tmp_path / "sol.npz")
    rc = cli.main(["solve", path, "--marginalized", "--certify", "--json",
                   "--out", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["certified"] is True
    sol = np.load(out)
    err, _ = ps.alignment_errors(torch.from_numpy(sol["R"]).double(),
                                 sol["t"], R, t)
    assert float(err) < 0.04
    res = ps.solve_pose_graph(graph)
    assert res.R.device.type == "cuda" and res.t.device.type == "cuda"


@pytest.mark.parametrize("engine", ["cg", "flat"])
def test_laplacian_solver_on_card_matches_cpu(dev, engine):
    """The inner Laplacian solve on the card (f32) within 1e-4 of the CPU
    one through the edge differences (the card adds in another order)."""
    from optimization_tpu_torch.models import pose_sync as ps

    graph, _, _ = _pose_graph(2000, 4000, 0.01, seed=5)
    src = torch.as_tensor(graph.src).long()
    dst = torch.as_tensor(graph.dst).long()
    tau = torch.rand(src.numel(), generator=torch.Generator().manual_seed(1))
    tau = tau + 0.5
    r = torch.randn((2000, 3), generator=torch.Generator().manual_seed(2))
    r = r - r.mean(dim=0, keepdim=True)
    zs = []
    for device in ("cpu", dev):
        solve = ps._weighted_laplacian_solver(
            src.to(device), dst.to(device), tau.to(device), 2000,
            engine=engine)
        z = solve(r.to(device)).cpu()
        zs.append(z[dst] - z[src])
    rel = torch.linalg.vector_norm(zs[1] - zs[0]) / torch.linalg.vector_norm(
        zs[0])
    assert float(rel) < 1e-4


def _segment_cases():
    import chip_smoke

    return chip_smoke.SEGMENT_CASES


@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", _segment_cases(),
                         ids=lambda c: f"n{c[0]}-w{c[2]}-p{c[3]}"
                         + ("-hub" if c[4] else ""))
def test_segment_sum_matches_plain_version(dev, dtype, case, ids):
    """The kernel against its plain version on the same inputs, at
    ``chip_smoke.SEGMENT_CASES`` (the graph models' shapes: each width's
    instance, the generic one, a hub), on the int32 plan that
    ``segment_plan`` builds and on the same plan widened to int64: bit for
    bit the plain version on the CPU (both add each vertex's run in the
    plan's order from zero), within 1e-5 (f32) of the card's plain version
    (``index_add``, another order); one launch a call, a repeat bit for bit
    the first."""
    import importlib

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    n, E, trailing, n_parts, hub = case
    gen = torch.Generator(device=dev).manual_seed(11)
    index = [torch.randint(0, n, (E,), generator=gen, device=dev)
             for _ in range(n_parts)]
    if hub:
        index[-1][: E // 2] = 0
    parts = [torch.randn((E,) + trailing, generator=gen, dtype=dtype,
                         device=dev) for _ in range(n_parts)]
    plan = SS.segment_plan(index, n)
    assert plan.order.dtype == plan.starts.dtype == torch.int32
    if ids == "int64":
        plan = plan._replace(order=plan.order.long(),
                             starts=plan.starts.long())
    before = SS.segment_sum.launches
    got = SS.segment_sum(plan, parts)
    again = SS.segment_sum(plan, parts)
    torch.cuda.synchronize()
    assert SS.segment_sum.launches == before + 2
    assert got.shape == (n,) + trailing and got.device.type == "cuda"
    assert torch.equal(got, again)
    cpu = SS.segment_sum(SS.segment_plan([i.cpu() for i in index], n),
                         [p.cpu() for p in parts])
    assert torch.equal(got.cpu(), cpu)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, SS.segment_sum_reference(plan, parts),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", [c for c in _segment_cases() if c[3] == 2],
                         ids=lambda c: f"n{c[0]}-w{c[2]}"
                         + ("-hub" if c[4] else ""))
def test_split_segment_sum_matches_plain_version(dev, dtype, case):
    """``segment_sum(split=True)`` (the pullback of a gather by an edge's
    two endpoints) on the card at the two-part ``SEGMENT_CASES``: bit for
    bit its plain version on the CPU (two ``index_add``s added), a repeat
    bit for bit, one launch a call."""
    import importlib

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    n, E, trailing, _, hub = case
    gen = torch.Generator(device=dev).manual_seed(13)
    index = [torch.randint(0, n, (E,), generator=gen, device=dev)
             for _ in range(2)]
    if hub:
        index[-1][: E // 2] = 0
    parts = [torch.randn((E,) + trailing, generator=gen, dtype=dtype,
                         device=dev) for _ in range(2)]
    plan = SS.segment_plan(index, n)
    before = SS.segment_sum.launches
    got = SS.segment_sum(plan, parts, split=True)
    again = SS.segment_sum(plan, parts, split=True)
    torch.cuda.synchronize()
    assert SS.segment_sum.launches == before + 2 and torch.equal(got, again)
    cpu = SS.segment_sum_reference(
        SS.segment_plan([i.cpu() for i in index], n),
        [p.cpu() for p in parts], split=True)
    assert torch.equal(got.cpu(), cpu)


def test_segment_sum_rejects_on_the_card(dev):
    import importlib

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    idx = torch.arange(10, device=dev) % 4
    plan = SS.segment_plan((idx,), 4)
    before = SS.segment_sum.launches
    with pytest.raises(ValueError, match="f32 or f64"):
        SS.segment_sum(plan, (torch.ones(10, dtype=torch.bfloat16,
                                         device=dev),))
    with pytest.raises(ValueError, match="one device"):
        SS.segment_sum(plan, (torch.ones(10),))
    assert SS.segment_sum.launches == before


@pytest.mark.parametrize("trailing", [(), (3, 3), (3, 8), (2, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_planned_gather_pullback_is_the_cpu_routes(dev, dtype, trailing):
    """Gathers by graph indices (1-D, a pair of them, and a padded table,
    whose padding lies past the plan's runs) and elementwise products on the
    card: the forward equals the CPU route's bit for bit, and so does the
    pullback (one ``segment_sum`` launch a gather, the pair's split; each
    vertex's run added in the plan's order on both routes); two pullbacks
    repeat bit for bit."""
    import importlib

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    n = 5000
    gen = torch.Generator().manual_seed(17)
    idx = torch.randint(0, n, (15_000,), generator=gen)
    other = torch.randint(0, n, (15_000,), generator=gen)
    table = torch.randint(0, n + 1, (n, 7), generator=gen)
    table[:, 4:] = n
    x = torch.randn((n + 1,) + trailing, generator=gen, dtype=dtype)
    w = [torch.randn(i.shape + trailing, generator=gen, dtype=dtype)
         for i in (idx, table, idx, other)]
    cot = [torch.randn(i.shape + trailing, generator=gen, dtype=dtype)
           for i in (idx, table, idx, other)]
    outs = []
    for device in ("cpu", dev):
        xd, idd, od, tbd = (t.to(device) for t in (x, idx, other, table))
        wd = [t.to(device) for t in w]
        cd = tuple(t.to(device) for t in cot)

        def f(y):
            p, q = SS.planned_gather(y, (idd, od))
            return (SS.planned_gather(y, idd) * wd[0],
                    SS.planned_gather(y[:n], tbd, padded=True) * wd[1],
                    p * wd[2], q * wd[3])

        before = SS.segment_sum.launches
        fwd, pull = torch.func.vjp(f, xd)
        grads = [pull(cd)[0] for _ in range(2)]
        launched = SS.segment_sum.launches - before
        outs.append((fwd, grads, launched))
    (fc, gc, lc), (fd, gd, ld) = outs
    assert lc == 0 and ld == 6
    assert all(torch.equal(a, b.cpu()) for a, b in zip(fc, fd))
    assert torch.equal(gd[0], gd[1])
    assert torch.equal(gc[0], gd[0].cpu())


@pytest.mark.parametrize("kind", ["grad", "jvp of grad", "vmap of jvp",
                                  "jacfwd"])
def test_calls_that_skip_the_functions_equal_the_function_path_on_the_card(
        dev, kind, monkeypatch):
    """On the card's torch: the host fast path of ``kernels.segment_sum``
    (``_plainly``, which reads private transform state) against the
    Function path alone, bit for bit, on gathers (plain, padded) and a
    segment sum in f32 under ``grad``, the jvp of a gradient, ``vmap`` of
    a jvp and ``jacfwd``; the kernel launched on both paths."""
    import importlib

    from test_torch_segment_sum import _graph, _transformed

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    n = 40
    gen = torch.Generator().manual_seed(22)
    src, dst = (i.to(dev) for i in _graph(23, n, 150, True))
    table = torch.randint(0, n + 1, (n, 6), generator=gen).to(dev)
    plan = SS.segment_plan((src, dst), n)
    x, u = (torch.randn((n, 3), generator=gen).to(dev) for _ in range(2))
    xs = torch.randn((3, n, 3), generator=gen).to(dev)

    def f(y):
        a = SS.planned_gather(y, src) * SS.planned_gather(y, dst)
        b = SS.planned_gather(y, table, padded=True)
        s = SS.segment_sum(plan, (a, torch.sin(a)))
        return torch.sum(s ** 2 * y) + torch.sum(b ** 3)

    outs = []
    for skip in (True, False):
        monkeypatch.setattr(SS, "_SKIP_FUNCTIONS", skip)
        before = SS.segment_sum.launches
        outs.append(_tensors(_transformed(kind, f, x, u, xs)))
        torch.cuda.synchronize()
        assert SS.segment_sum.launches > before
    assert len(outs[0]) == len(outs[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("path", ["chordal gradient, hvp, precon",
                                  "TNT plain",
                                  "marginalized gradient, hvp cg",
                                  "range sync gradient, hvp"])
def test_model_gradients_launch_segment_sum(dev, card_paths, path):
    """A gradient of each graph model on the card pulls its gathers back
    through ``segment_sum`` (its launches counted) and dispatches no
    ``index_put`` with repeated indices (``profile_graph_routes.census``)."""
    import importlib

    import profile_graph_routes

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    before = SS.segment_sum.launches
    with profile_graph_routes.census(torch) as found:
        card_paths[path]()
    torch.cuda.synchronize()
    assert SS.segment_sum.launches > before
    assert not any("index_put" in f for f in found), found


def _tensors(out):
    """The tensors of a nested tuple of results, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) > 0 and all(torch.equal(x, y)
                                           for x, y in zip(ta, tb))


@pytest.fixture(scope="module")
def card_paths():
    import profile_graph_routes

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return profile_graph_routes.model_paths(torch, torch.device("cuda", 0),
                                            torch.float32)


def _path_names():
    import profile_graph_routes

    return profile_graph_routes.PATH_NAMES


@pytest.mark.parametrize("path", _path_names())
def test_model_path_repeats_bit_for_bit(dev, card_paths, path):
    """Each path of the graph models (forward, gradient, jvp of the
    gradient, whole solves) twice in f32 on the card: the same bits."""
    first = card_paths[path]()
    assert _same(first, card_paths[path]())


@pytest.mark.parametrize("path", _path_names())
def test_model_path_adds_in_a_fixed_order_on_the_card(dev, card_paths,
                                                      path):
    """The finder: each path once under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (turned
    off after) and ``profile_graph_routes.census``: no warning, no
    operation that adds in a varying order."""
    import warnings

    import profile_graph_routes

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profile_graph_routes.census(torch) as found:
                card_paths[path]()
    finally:
        torch.use_deterministic_algorithms(False)
    said = [str(w.message) for w in caught
            if "determinis" in str(w.message)]
    assert not said and not found, (said, found)


@pytest.mark.parametrize("method", ["scatter", "gather", "sort",
                                    "adjacency"])
@pytest.mark.parametrize("op", ["connection_laplacian_op",
                                "laplacian_apply"])
def test_graph_operators_repeat_bit_for_bit(dev, op, method):
    """Each scatter_method twice on a graph of 2,000 vertices whose vertex
    0 takes a quarter of the 6,000 edges (``"gather"`` falls back to
    ``"sort"``), with its degree."""
    from optimization_tpu_torch.models import graph as G
    from optimization_tpu_torch.models import rotation_sync as rs

    gen = torch.Generator(device=dev).manual_seed(3)
    _, data = rs.random_instance(gen, 2000, 3, extra_edges=4000, noise=0.05)
    dst = data.dst.clone()
    dst[::4] = 0
    data = data._replace(dst=dst)
    w = 0.5 + torch.rand(dst.shape, generator=gen, device=dev)
    if op == "connection_laplacian_op":
        data = data._replace(kappa=w)
        X = torch.randn((6000, 5), generator=gen, device=dev)
        run = lambda: rs.connection_laplacian_op(  # noqa: E731
            data, 2000, 3, scatter_method=method)(X)
    else:
        z = torch.randn((2000, 4), generator=gen, device=dev)
        run = lambda: G.laplacian_apply(  # noqa: E731
            data.src, data.dst, w, 2000, method=method)(z)
    first = run()
    assert first.device.type == "cuda"
    assert all(torch.equal(first, run()) for _ in range(3))
    deg = rs._degree(data, 2000, w)
    assert torch.equal(deg, rs._degree(data, 2000, w))
    assert torch.equal(deg, G.vertex_degree(data.src, data.dst, w, 2000))


def test_lifted_problem_hvp_repeats_bit_for_bit(dev):
    """The staircase's rank-(d + 1) gradient and hvp at config6's rotation
    graph, twice."""
    import chip_smoke

    from optimization_tpu_torch.models import rotation_sync as rs

    _, data = chip_smoke.rotation_graph(torch, dev)
    n = chip_smoke.ROTSYNC["n"]
    gen = torch.Generator(device=dev).manual_seed(4)
    Y = rs.STIEFEL.rand(gen, n, 4, 3)
    W = rs.STIEFEL.proj(Y, torch.randn(Y.shape, generator=gen, device=dev))
    prob = rs._lifted_problem(n, 3)

    def run():
        g, hvp = prob.qm(Y, data)
        return g, hvp(W)

    assert _same(run(), run())


def test_spectral_init_at_config6_repeats_bit_for_bit(dev):
    """Phase 17's spectral_init, twice: the same LOBPCG iteration count
    and the same R0, bit for bit."""
    import chip_smoke

    from optimization_tpu_torch.models import rotation_sync as rs

    _, data = chip_smoke.rotation_graph(torch, dev)
    runs = []
    with chip_smoke.lobpcg_log() as log:
        for _ in range(2):
            runs.append(rs.spectral_init(
                data, chip_smoke.ROTSYNC["n"], 3,
                generator=torch.Generator(device=dev).manual_seed(7)))
    assert log[0] == log[1] and log[0][0] > 1
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("route", ["plain", "preconditioned", "flat"])
def test_phase17_routes_repeat_bit_for_bit(dev, route):
    """Each of phase 17's TNT routes from its R0, twice: the same status,
    outer and CG counts and x, bit for bit."""
    import chip_smoke

    from optimization_tpu_torch.models import rotation_sync as rs
    from optimization_tpu_torch.solvers import tnt

    _, data = chip_smoke.rotation_graph(torch, dev)
    n = chip_smoke.ROTSYNC["n"]
    R0 = rs.spectral_init(data, n, 3,
                          generator=torch.Generator(device=dev).manual_seed(7))
    prob = dict(chip_smoke.rotation_routes(rs))[route]
    params = tnt.TNTParams(**chip_smoke.ROTSYNC_PARAMS)
    a, b = (tnt.solve(prob, R0, params, data=data) for _ in range(2))
    assert int(a.status) == int(b.status)
    assert chip_smoke.counts(a) == chip_smoke.counts(b)
    assert torch.equal(a.x, b.x)


@pytest.mark.parametrize("engine", ["cg", "flat"])
def test_laplacian_solver_repeats_bit_for_bit(dev, engine):
    """The inner Laplacian solve on config6's pose graph (f32), twice: the
    same iteration count and the same z."""
    from optimization_tpu_torch.models import pose_sync as ps

    graph, _, _ = _pose_graph(10_000, 20_000, 0.01, seed=0)
    src = torch.as_tensor(graph.src, device=dev).long()
    dst = torch.as_tensor(graph.dst, device=dev).long()
    gen = torch.Generator(device=dev).manual_seed(1)
    tau = 0.5 + torch.rand(src.numel(), generator=gen, device=dev)
    r = torch.randn((10_000, 3), generator=gen, device=dev)
    r = r - r.mean(dim=0, keepdim=True)
    solve = ps._weighted_laplacian_solver(src, dst, tau, 10_000,
                                          engine=engine, with_iters=True)
    (z1, k1), (z2, k2) = solve(r), solve(r)
    assert k1 == k2 > 1 and torch.equal(z1, z2)


@pytest.mark.parametrize("k", [24, 120])
def test_sharded_gram_pair_launches_the_kernel_at_world_one(dev, k):
    """``parallel.collectives.sharded_gram_pair`` on a one-rank NCCL mesh:
    the local pair is one ``gram_pair`` launch, held against the plain
    version (chip_smoke.GRAM_TOLERANCES), then one all-reduce; k = 120 is
    LOBPCG's Gram stage at nx = 40 (the panel route)."""
    import torch.distributed as dist

    from optimization_tpu_torch.parallel import collectives, model_mesh

    fresh = not dist.is_initialized()
    mesh = model_mesh(1)
    try:
        assert dist.get_backend() == "nccl"
        gen = torch.Generator(device=dev).manual_seed(9)
        S, AS, BS = (torch.randn(1000, k, generator=gen, device=dev)
                     for _ in range(3))
        before = F.gram_pair.launches
        ga, gb = collectives.sharded_gram_pair(S, AS, BS, mesh)
        assert F.gram_pair.launches == before + 1
        for got, ref, X in zip((ga, gb), F.gram_pair_reference(S, AS, BS),
                               (AS, BS)):
            tol = 1e-5 * (S.double().abs().mT @ X.double().abs())
            assert bool(((got.double() - ref.double()).abs() <= tol).all())
        same = collectives.sharded_gram_pair(S, AS, BS, mesh)
        assert torch.equal(same[0], ga) and torch.equal(same[1], gb)
    finally:
        if fresh:
            dist.destroy_process_group()


def test_range_sync_f32_pipeline_on_the_card(dev):
    """Range-aided pose sync at n = 200 in f32 with no generator and no
    device: the instance is made on the card, the spectral init launches
    ``gram_pair``, the joint TNT converges to the f32 tier's floor."""
    from optimization_tpu_torch.models import range_sync as rg
    from optimization_tpu_torch.models.pose_sync import alignment_errors

    R_true, t_true, data = rg.random_instance(None, 200, 3, extra_edges=200,
                                              n_ranges=200, noise=0.0)
    assert data.src.device.type == "cuda" and data.src.dtype == torch.int64
    before = F.gram_pair.launches
    out = rg.solve_range_aided(data, 200)
    assert F.gram_pair.launches > before
    assert out.R.device.type == "cuda" and out.R.dtype == torch.float32
    assert float(out.t[0].abs().max()) == 0.0
    assert float((torch.linalg.vector_norm(out.u, dim=-1) - 1).abs().max()) \
        < 1e-5
    rot_err, t_err = alignment_errors(out.R, out.t, R_true,
                                      t_true - t_true[0][None])
    assert float(rot_err) < 1e-3 and float(t_err) < 1e-2


# ---- the examples (optimization_tpu_torch/examples) ----

def _example(name):
    import importlib

    return importlib.import_module(f"optimization_tpu_torch.examples.{name}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_on_the_card_meets_its_check(dev, name):
    """``run(device="cuda")`` at the JAX example's sizes in f32: the JAX
    example's own acceptance check where it has one, every number finite,
    and gram_pair launched exactly by the examples that run LOBPCG."""
    import math

    from test_torch_examples_run import _numbers

    module = _example(name)
    before = F.gram_pair.launches
    out = module.run("cuda")
    if hasattr(module, "accept"):
        module.accept(out)
    assert all(math.isfinite(v) for v in _numbers(out))
    assert (F.gram_pair.launches > before) == (name in LOBPCG_EXAMPLES)


def test_lobpcg_example_launches_gram_pair_once_a_block_iteration(dev):
    """Each of the example's two f32 solves launches gram_pair 1 +
    iterations times (the initial Gram stage, then one an iteration)."""
    before = F.gram_pair.launches
    out = _example("lobpcg_example").run("cuda")
    assert out["diag"]["nc"] == 5 and out["big"]["nc"] == 4
    assert F.gram_pair.launches - before == (
        2 + out["diag"]["iters"] + out["big"]["iters"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_raises_without_a_card(name, monkeypatch):
    """Without a card, ``main()`` raises before any work unless it is given
    ``--device cpu`` (``tests/test_torch_examples_run.py`` runs that)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
