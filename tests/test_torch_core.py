"""The port's core vocabulary == the JAX package's.

Params dataclasses (fields, defaults, ``validate()`` messages), status
enums, ``pad_value`` and the pytree vector-space helpers, fed the same
numpy inputs on both sides.  Tree ops run in float64 and must agree to
1e-15 relative (one rounding of the same elementwise formula).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_tpu.core.debug as jdebug
import optimization_tpu.core.tree as jtree
import optimization_tpu.core.types as jtypes
import optimization_tpu.solvers.tnt as jtnt
import optimization_tpu_torch.core.debug as tdebug
import optimization_tpu_torch.core.tree as ttree
import optimization_tpu_torch.core.types as ttypes
import optimization_tpu_torch.solvers.tnt as ttnt

torch.set_num_threads(1)

PARAMS = [("OptimizerParams", jtypes.OptimizerParams, ttypes.OptimizerParams),
          ("SmoothOptimizerParams", jtypes.SmoothOptimizerParams,
           ttypes.SmoothOptimizerParams),
          ("TNTParams", jtnt.TNTParams, ttnt.TNTParams)]


@pytest.mark.parametrize("name,jcls,tcls", PARAMS, ids=[p[0] for p in PARAMS])
def test_params_fields_and_defaults(name, jcls, tcls):
    jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
    assert jf == tf
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcls().max_iterations = 3


INVALID = [
    ("OptimizerParams", dict(max_iterations=-1)),
    ("OptimizerParams", dict(max_computation_time=-1.0)),
    ("SmoothOptimizerParams", dict(gradient_tolerance=-1.0)),
    ("SmoothOptimizerParams", dict(relative_decrease_tolerance=-1.0)),
    ("SmoothOptimizerParams", dict(stepsize_tolerance=-1.0)),
    ("TNTParams", dict(preconditioned_gradient_tolerance=-1.0)),
    ("TNTParams", dict(Delta_tolerance=-1.0)),
    ("TNTParams", dict(Delta0=0.0)),
    ("TNTParams", dict(eta1=1.0)),
    ("TNTParams", dict(eta1=0.5, eta2=0.4)),
    ("TNTParams", dict(alpha1=1.0)),
    ("TNTParams", dict(alpha2=1.0)),
    ("TNTParams", dict(kappa_fgr=0.0)),
    ("TNTParams", dict(theta=-0.1)),
    ("TNTParams", dict(flat_s_steps=4)),
    ("TNTParams", dict(flat_kernel_check=False, flat_s_steps=2)),
]


@pytest.mark.parametrize("name,kwargs", INVALID,
                         ids=[f"{n}-{'-'.join(k)}" for n, k in INVALID])
def test_validate_messages_match(name, kwargs):
    jcls, tcls = {p[0]: p[1:] for p in PARAMS}[name]
    with pytest.raises(ValueError) as je:
        jcls(**kwargs).validate()
    with pytest.raises(ValueError) as te:
        tcls(**kwargs).validate()
    assert str(te.value) == str(je.value)


def test_valid_params_pass():
    for _, _, tcls in PARAMS:
        tcls().validate()


ENUMS = ["GradientDescentStatus", "TNTStatus", "TNLSStatus",
         "ProximalGradientStatus", "ADMMStatus", "ADMMIterationType"]


@pytest.mark.parametrize("name", ENUMS)
def test_status_enums_match(name):
    je, te = getattr(jtypes, name), getattr(ttypes, name)
    assert [(m.name, m.value) for m in je] == [(m.name, m.value) for m in te]
    assert all(isinstance(m.value, int) for m in te)


def test_running_sentinel():
    assert ttypes.RUNNING == jtypes.RUNNING == 0


def test_pad_value_and_trace_fill():
    assert tdebug.DEBUG_NANS == jdebug.DEBUG_NANS
    jp, tp = jdebug.pad_value(), tdebug.pad_value()
    assert (math.isnan(jp) and math.isnan(tp)) or jp == tp
    tr = ttypes.trace_fill(4, torch.float64)
    jr = np.asarray(jtypes.trace_fill(4, jnp.float64))
    np.testing.assert_array_equal(tr.numpy(), jr)
    assert tr.dtype == torch.float64


def _pair_trees(seed=0):
    rng = np.random.default_rng(seed)
    a = {"u": rng.normal(size=5), "v": (rng.normal(size=(2, 3)),
                                        rng.normal(size=4))}
    b = {"u": rng.normal(size=5), "v": (rng.normal(size=(2, 3)),
                                        rng.normal(size=4))}
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    to_t = lambda t: ttree.tree_map(torch.from_numpy, t)
    return to_j(a), to_j(b), to_t(a), to_t(b)


def _assert_tree_close(t, j):
    tl = ttree.tree_leaves(t)
    jl = jax.tree_util.tree_leaves(j)
    assert len(tl) == len(jl)
    for x, y in zip(tl, jl):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-15,
                                   atol=1e-15)


TREE_OPS = ["tree_add", "tree_axpy", "tree_axpy_like", "tree_neg",
            "tree_zeros_like", "tree_where"]


@pytest.mark.parametrize("op", TREE_OPS)
def test_tree_ops_match(op):
    ja, jb, ta, tb = _pair_trees()
    args = {"tree_add": lambda m, a, b: (a, b),
            "tree_axpy": lambda m, a, b: (-1.5, a, b),
            "tree_axpy_like": lambda m, a, b: (2.25, a, b),
            "tree_neg": lambda m, a, b: (a,),
            "tree_zeros_like": lambda m, a, b: (a,),
            "tree_where": lambda m, a, b: (m.asarray(False), a, b)}[op]
    out_t = getattr(ttree, op)(*args(torch, ta, tb))
    out_j = getattr(jtree, op)(*args(jnp, ja, jb))
    _assert_tree_close(out_t, out_j)


def test_tree_dot():
    ja, jb, ta, tb = _pair_trees(1)
    np.testing.assert_allclose(float(ttree.tree_dot(ta, tb)),
                               float(jtree.tree_dot(ja, jb)), rtol=1e-14)


def test_tree_axpy_like_keeps_storage_dtype():
    x = torch.ones(4, dtype=torch.float32)
    y = torch.ones(4, dtype=torch.bfloat16)
    out = ttree.tree_axpy_like(torch.tensor(0.5), x, y)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.full(4, 1.5))


def test_tree_none_is_empty_subtree():
    # as in JAX: a None field of a carried NamedTuple has no leaves
    a = (torch.ones(2), None)
    out = ttree.tree_where(torch.tensor(True), a, (torch.zeros(2), None))
    assert out[1] is None
    assert len(ttree.tree_leaves(a)) == 1
