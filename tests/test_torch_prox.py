"""The port's proximal operators == the JAX package's ``solvers/prox.py``.

The six operators on the same numpy inputs in float64 and float32 (scalar
and per-axis groups, lam as a number and as a 0-d array), to rtol 1e-12 in
f64 and 1e-6 in f32; and the zero-vector group case, where the 1e-300 guard
underflows in f32: both packages give 0, not NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_tpu.solvers import prox as jprox
from optimization_tpu_torch.solvers import prox as tprox

torch.set_num_threads(1)

DTYPES = [("f64", np.float64, 1e-12), ("f32", np.float32, 1e-6)]
OPERATORS = [
    ("soft_threshold", {}),
    ("group_soft_threshold", {}),
    ("group_soft_threshold", {"axis": 1}),
    ("group_soft_threshold", {"axis": 0}),
    ("prox_l2_squared", {}),
    ("prox_l2_squared", {"mu": 3.0}),
    ("project_box", {}),
    ("project_box", {"lo": -0.25, "hi": 0.5}),
    ("project_nonnegative", {}),
    ("prox_zero", {}),
]


@pytest.mark.parametrize("name,kw", OPERATORS,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'default'}"
                              for n, k in OPERATORS])
@pytest.mark.parametrize("tag,dt,rtol", DTYPES, ids=[d[0] for d in DTYPES])
def test_operator_matches_jax(name, kw, tag, dt, rtol):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 7)).astype(dt)
    for lam in (0.3, 1.7):
        want = np.asarray(getattr(jprox, name)(jnp.asarray(x), lam, **kw))
        got = getattr(tprox, name)(torch.from_numpy(x), lam, **kw)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol)
        # lam as a 0-d tensor (the solvers pass their stepsize that way)
        got_t = getattr(tprox, name)(torch.from_numpy(x),
                                     torch.tensor(lam, dtype=got.dtype), **kw)
        np.testing.assert_allclose(got_t.numpy(), want, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("tag,dt,rtol", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("axis", [None, 0])
def test_group_soft_threshold_of_zero_is_zero(tag, dt, rtol, axis):
    """|x| = 0: the guard under the division is 1e-300, which is 0 in f32,
    so lam / 0 = inf and the scale max(1 - inf, 0) = 0: the result is 0 in
    both packages, never NaN."""
    x = np.zeros((4, 3), dt)
    want = np.asarray(jprox.group_soft_threshold(jnp.asarray(x), 0.5,
                                                 axis=axis))
    got = tprox.group_soft_threshold(torch.from_numpy(x), 0.5, axis=axis)
    assert np.all(want == 0.0)
    assert torch.all(got == 0.0) and got.dtype == torch.from_numpy(x).dtype


def test_reference_examples():
    """tests/test_convex.py::test_prox_operators on the port."""
    x = torch.tensor([3.0, -0.5, 0.2], dtype=torch.float64)
    np.testing.assert_allclose(tprox.soft_threshold(x, 1.0).numpy(),
                               [2.0, 0.0, 0.0])
    y = tprox.group_soft_threshold(x, 1.0)
    np.testing.assert_allclose(float(torch.linalg.norm(y)),
                               float(torch.linalg.norm(x)) - 1.0, rtol=1e-12)
