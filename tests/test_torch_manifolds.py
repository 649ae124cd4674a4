"""The port's sphere and Euclidean manifolds == the JAX package's.

float64 inputs from a numpy seed go through both; the elementwise formulas
are the same, so results agree to 1e-14 relative (reduction order differs).
The bf16-storage / f32-accumulate rule (``sphere._acc``) is checked on bf16
inputs: outputs stay bf16 and agree with JAX to one bf16 rounding (2^-8
relative), since the f32 sums feeding the final cast are taken in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.manifolds import euclidean as jeuclidean
from optimization_tpu.manifolds import sphere as jsphere
from optimization_tpu_torch.manifolds import EUCLIDEAN, euclidean, sphere
from optimization_tpu_torch.manifolds.base import Manifold

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
