"""The port's manifolds == the JAX package's.

float64 inputs from a numpy seed go through both.  Sphere and Euclidean: the
elementwise formulas are the same, so results agree to 1e-14 relative
(reduction order differs).  Stiefel, SO(d), Grassmann: the products and the
3x3 eigendecompositions of the polar retraction agree within 1e-12.
The bf16-storage / f32-accumulate rule (``sphere._acc``) is checked on bf16
inputs: outputs stay bf16 and agree with JAX to one bf16 rounding (2^-8
relative), since the f32 sums feeding the final cast are taken in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.core.problem import RiemannianProblem as JProblem
from optimization_tpu.core.types import TNTStatus as JTNTStatus
from optimization_tpu.manifolds import euclidean as jeuclidean
from optimization_tpu.manifolds import grassmann as jgrassmann
from optimization_tpu.manifolds import product as jproduct
from optimization_tpu.manifolds import rotations as jrotations
from optimization_tpu.manifolds import sphere as jsphere
from optimization_tpu.manifolds import stiefel as jstiefel
from optimization_tpu.solvers import tnt as jtnt
from optimization_tpu_torch import RiemannianProblem
from optimization_tpu_torch.core.types import TNTStatus
from optimization_tpu_torch.manifolds import (EUCLIDEAN, GRASSMANN, ROTATIONS,
                                              STIEFEL, euclidean, grassmann,
                                              product, rotations, sphere,
                                              stiefel)
from optimization_tpu_torch.manifolds.base import Manifold
from optimization_tpu_torch.solvers import tnt

torch.set_num_threads(1)

RTOL = 1e-14


def _points(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    v = rng.normal(size=shape)
    u = rng.normal(size=shape)
    return x, u, v


@pytest.mark.parametrize("shape", [(7,), (3, 5)], ids=["flat", "batched"])
def test_sphere_proj_retract_match(shape):
    x, _, v = _points(shape)
    S, J = sphere(), jsphere()
    tx, tv = torch.from_numpy(x), torch.from_numpy(v)
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    np.testing.assert_allclose(S.proj(tx, tv).numpy(),
                               np.asarray(J.proj(jx, jv)), rtol=RTOL,
                               atol=1e-15)
    np.testing.assert_allclose(S.retract(tx, tv).numpy(),
                               np.asarray(J.retract(jx, jv)), rtol=RTOL)
    np.testing.assert_allclose(S.egrad_to_rgrad(tx, tv).numpy(),
                               np.asarray(J.egrad_to_rgrad(jx, jv)),
                               rtol=RTOL, atol=1e-15)
    # geometry: projections are tangent, retractions are unit
    assert np.abs(np.sum(x * S.proj(tx, tv).numpy(), axis=-1)).max() < 1e-14
    np.testing.assert_allclose(
        np.linalg.norm(S.retract(tx, tv).numpy(), axis=-1), 1.0, rtol=1e-15)


def test_sphere_inner_and_norm_match():
    x, u, v = _points((9,), 1)
    S, J = sphere(), jsphere()
    t = [torch.from_numpy(a) for a in (x, u, v)]
    j = [jnp.asarray(a) for a in (x, u, v)]
    np.testing.assert_allclose(float(S.inner(*t)), float(J.inner(*j)),
                               rtol=RTOL)
    np.testing.assert_allclose(float(S.norm(t[0], t[1])),
                               float(J.norm(j[0], j[1])), rtol=RTOL)


def test_sphere_bf16_storage_f32_accumulate():
    x, _, v = _points((4096,), 2)
    S, J = sphere(), jsphere()
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    jv = jnp.asarray(tv.float().numpy()).astype(jnp.bfloat16)
    for name in ("proj", "retract"):
        t_out = getattr(S, name)(tx, tv)
        j_out = getattr(J, name)(jx, jv)
        assert t_out.dtype == torch.bfloat16
        np.testing.assert_allclose(t_out.float().numpy(),
                                   np.asarray(j_out, np.float32),
                                   rtol=2 ** -8, atol=2 ** -8 * 1e-3)
    # the inner product accumulates in f32, not bf16
    ip = S.inner(tx, tv, tv)
    assert ip.dtype == torch.float32
    np.testing.assert_allclose(float(ip), float(J.inner(jx, jv, jv)),
                               rtol=1e-5)


def test_sphere_acc_is_identity_above_f32():
    x, _, v = _points((6,), 3)
    out = sphere().proj(torch.from_numpy(x), torch.from_numpy(v))
    assert out.dtype == torch.float64


def test_sphere_rand_generator():
    gen = torch.Generator().manual_seed(5)
    x = sphere().rand(gen, 4, 8, dtype=torch.float64)
    assert x.shape == (4, 8) and x.dtype == torch.float64
    np.testing.assert_allclose(np.linalg.norm(x.numpy(), axis=-1), 1.0,
                               rtol=1e-15)
    again = sphere().rand(torch.Generator().manual_seed(5), 4, 8,
                          dtype=torch.float64)
    assert torch.equal(x, again)


def test_euclidean_ops_on_pytrees():
    rng = np.random.default_rng(4)
    a = {"p": rng.normal(size=3), "q": rng.normal(size=(2, 2))}
    b = {"p": rng.normal(size=3), "q": rng.normal(size=(2, 2))}
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    E, J = euclidean(), jeuclidean()
    assert E is EUCLIDEAN and isinstance(E, Manifold)
    out = E.retract(ta, tb)
    jout = J.retract(ja, jb)
    for k in a:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=RTOL)
    np.testing.assert_allclose(float(E.inner(ta, ta, tb)),
                               float(J.inner(ja, ja, jb)), rtol=RTOL)
    assert E.proj(ta, tb) is tb and E.egrad_to_rgrad(ta, tb) is tb
    r = E.rand(torch.Generator().manual_seed(0), 3, dtype=torch.float64)
    assert r.shape == (3,) and r.dtype == torch.float64


# ---- the matrix manifolds (Stiefel, SO(d), Grassmann) and products ----

MATRIX = [("stiefel", (10, 3)), ("rotations", (4, 3, 3)),
          ("grassmann", (10, 3))]
PAIRS = {"stiefel": (stiefel, jstiefel), "rotations": (rotations, jrotations),
         "grassmann": (grassmann, jgrassmann)}


def _orthonormal(shape, seed, rotation=False):
    """Orthonormal (..., n, p) points from a numpy seed (det > 0 for
    rotations), and a Gaussian ambient direction."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=shape))
    if rotation:
        q[..., :, 0] *= np.sign(np.linalg.det(q))[..., None]
    return q, rng.normal(size=shape)


@pytest.mark.parametrize("name,shape", MATRIX)
@pytest.mark.parametrize("tangent", [True, False], ids=["tangent", "ambient"])
def test_matrix_manifold_ops_match(name, shape, tangent):
    """proj, inner and the polar retraction agree with JAX within 1e-12,
    for tangent and for ambient (unprojected) steps."""
    T, J = (f() for f in PAIRS[name])
    x, a = _orthonormal(shape, 10, rotation=name == "rotations")
    jx, ja = jnp.asarray(x), jnp.asarray(0.3 * a)
    tx, ta = torch.from_numpy(x), torch.from_numpy(0.3 * a)
    np.testing.assert_allclose(T.proj(tx, ta).numpy(),
                               np.asarray(J.proj(jx, ja)), atol=1e-12)
    np.testing.assert_allclose(T.egrad_to_rgrad(tx, ta).numpy(),
                               np.asarray(J.egrad_to_rgrad(jx, ja)),
                               atol=1e-12)
    tv = T.proj(tx, ta) if tangent else ta
    jv = J.proj(jx, ja) if tangent else ja
    y = T.retract(tx, tv).numpy()
    np.testing.assert_allclose(y, np.asarray(J.retract(jx, jv)), atol=1e-12)
    eye = np.swapaxes(y, -1, -2) @ y
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(shape[-1]),
                                                    eye.shape), atol=1e-12)
    if name == "rotations":
        assert (np.linalg.det(y) > 0).all()
    np.testing.assert_allclose(float(T.inner(tx, tv, ta)),
                               float(J.inner(jx, jv, ja)), rtol=1e-12)


@pytest.mark.parametrize("name,shape", MATRIX)
def test_matrix_manifold_bf16_tier(name, shape):
    """bf16 in, bf16 out; the retraction is orthonormal within one bf16
    rounding (tests/test_manifolds.py's 0.08 at p = 3) and within one bf16
    ulp of JAX (the f32 work before the last cast sums in another order)."""
    T, J = (f() for f in PAIRS[name])
    x, a = _orthonormal(shape, 11, rotation=name == "rotations")
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ta = torch.from_numpy(0.3 * a).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    ja = jnp.asarray(ta.float().numpy()).astype(jnp.bfloat16)
    for op in ("retract", "proj"):
        out = getattr(T, op)(tx, ta)
        ref = np.asarray(getattr(J, op)(jx, ja), np.float32)
        assert out.dtype == torch.bfloat16
        got = out.float().numpy()
        # one bf16 ulp of |ref| is 2^-8..2^-7 of it
        assert (np.abs(got - ref) <= 2 ** -7 * np.abs(ref) + 1e-6).all(), op
    y = T.retract(tx, ta).double().numpy()
    gram = np.swapaxes(y, -1, -2) @ y
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(shape[-1]),
                                                     gram.shape), atol=0.08)
    assert T.inner(tx, ta, ta).dtype == torch.float32


def test_matrix_manifold_rand():
    gen = torch.Generator().manual_seed(3)
    X = STIEFEL.rand(gen, 10, 3, dtype=torch.float64)
    np.testing.assert_allclose((X.mT @ X).numpy(), np.eye(3), atol=1e-14)
    R = ROTATIONS.rand(gen, 50, 3, 3, dtype=torch.float64)
    assert (torch.linalg.det(R) > 0).all()
    np.testing.assert_allclose((R.mT @ R).numpy(),
                               np.broadcast_to(np.eye(3), (50, 3, 3)),
                               atol=1e-14)
    G = GRASSMANN.rand(torch.Generator().manual_seed(3), 10, 3,
                       dtype=torch.float64)
    assert torch.equal(G, STIEFEL.rand(torch.Generator().manual_seed(3), 10,
                                       3, dtype=torch.float64))
    assert ROTATIONS.rand(gen, 2, 3, 3, dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    # a product draws its factors one after another from the one generator
    P = product((sphere(), STIEFEL))
    s, st = P.rand(torch.Generator().manual_seed(4), (5,), (6, 2),
                   dtype=torch.float64)
    g = torch.Generator().manual_seed(4)
    assert torch.equal(s, sphere().rand(g, 5, dtype=torch.float64))
    assert torch.equal(st, STIEFEL.rand(g, 6, 2, dtype=torch.float64))
    assert P.name == "spherexstiefel"


def test_product_manifold_tnt_matches_jax():
    """TNT over sphere x euclidean (tests/test_manifolds.py's
    test_product_manifold_tnt) in both packages: same status and counts, x
    within 1e-10."""
    P_np, c_np = np.array([0.0, 0.0, 1.0]), np.array([2.0, -1.0])
    params = dict(max_iterations=100, gradient_tolerance=1e-9,
                  relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
                  preconditioned_gradient_tolerance=0.0)

    def jf(xb, data):
        x, b = xb
        return jnp.sum((x - P_np) ** 2) + jnp.sum((b - c_np) ** 2)

    P_t, c_t = torch.from_numpy(P_np), torch.from_numpy(c_np)

    def tf(xb, data):
        x, b = xb
        return torch.sum((x - P_t) ** 2) + torch.sum((b - c_t) ** 2)

    jres = jtnt.solve(JProblem(f=jf, manifold=jproduct((jsphere(),
                                                        jeuclidean()))),
                      (jnp.array([1.0, 0.0, 0.0]), jnp.zeros(2)),
                      jtnt.TNTParams(**params))
    tres = tnt.solve(RiemannianProblem(f=tf, manifold=product((sphere(),
                                                               euclidean()))),
                     (torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64),
                      torch.zeros(2, dtype=torch.float64)),
                     tnt.TNTParams(**params))
    assert int(tres.status) == TNTStatus.GRADIENT == int(jres.status) == \
        JTNTStatus.GRADIENT
    k = int(tres.num_iterations)
    assert k == int(jres.num_iterations)
    np.testing.assert_array_equal(tres.inner_iterations[:k].numpy(),
                                  np.asarray(jres.inner_iterations[:k]))
    for t, j in zip(tres.x, jres.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-10)
    np.testing.assert_allclose(tres.x[0].numpy(), P_np, atol=1e-8)
