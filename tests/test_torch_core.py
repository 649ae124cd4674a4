"""The port's core vocabulary == the JAX package's.

Params dataclasses (fields, defaults, ``validate()`` messages), status
enums, ``pad_value`` and the pytree vector-space helpers, fed the same
numpy inputs on both sides; and the host helpers ``core.host`` and
``core.profiling``.  Tree ops run in float64 and must agree to
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
import optimization_tpu.solvers.tnls as jtnls
import optimization_tpu.solvers.tnt as jtnt
import optimization_tpu_torch.core.debug as tdebug
import optimization_tpu_torch.core.tree as ttree
import optimization_tpu_torch.core.types as ttypes
import optimization_tpu_torch.solvers.tnls as ttnls
import optimization_tpu_torch.solvers.tnt as ttnt
from optimization_tpu_torch.core import host, profiling

torch.set_num_threads(1)

PARAMS = [("OptimizerParams", jtypes.OptimizerParams, ttypes.OptimizerParams),
          ("SmoothOptimizerParams", jtypes.SmoothOptimizerParams,
           ttypes.SmoothOptimizerParams),
          ("TNTParams", jtnt.TNTParams, ttnt.TNTParams),
          ("TNLSParams", jtnls.TNLSParams, ttnls.TNLSParams)]


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
    ("TNLSParams", dict(Delta0=0.0)),
    ("TNLSParams", dict(eta1=0.5, eta2=0.4)),
    ("TNLSParams", dict(alpha2=1.0)),
    ("TNLSParams", dict(lam=-1.0)),
    ("TNLSParams", dict(root_tolerance=-1.0)),
    ("TNLSParams", dict(Delta_tolerance=-1.0)),
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
            "tree_scale", "tree_zeros_like", "tree_where", "tree_sub",
            "tree_select"]


@pytest.mark.parametrize("op", TREE_OPS)
def test_tree_ops_match(op):
    ja, jb, ta, tb = _pair_trees()
    args = {"tree_add": lambda m, a, b: (a, b),
            "tree_axpy": lambda m, a, b: (-1.5, a, b),
            "tree_axpy_like": lambda m, a, b: (2.25, a, b),
            "tree_neg": lambda m, a, b: (a,),
            "tree_scale": lambda m, a, b: (-0.75, a),
            "tree_zeros_like": lambda m, a, b: (a,),
            "tree_where": lambda m, a, b: (m.asarray(False), a, b),
            "tree_sub": lambda m, a, b: (a, b),
            "tree_select": lambda m, a, b: (m.asarray(True), a, b)}[op]
    out_t = getattr(ttree, op)(*args(torch, ta, tb))
    out_j = getattr(jtree, op)(*args(jnp, ja, jb))
    _assert_tree_close(out_t, out_j)


def test_tree_dot():
    ja, jb, ta, tb = _pair_trees(1)
    np.testing.assert_allclose(float(ttree.tree_dot(ta, tb)),
                               float(jtree.tree_dot(ja, jb)), rtol=1e-14)


def test_tree_norm():
    ja, _, ta, _ = _pair_trees(2)
    np.testing.assert_allclose(float(ttree.tree_norm(ta)),
                               float(jtree.tree_norm(ja)), rtol=1e-14)


def test_solve_info_matches_jax():
    assert ttypes.SolveInfo._fields == jtypes.SolveInfo._fields
    info = ttypes.SolveInfo(elapsed_time=1.5, chunks=3)
    assert info == jtypes.SolveInfo(1.5, 3)
    assert "SolveInfo" in ttypes.__all__


# Public names of the JAX package that the port does not have yet: the
# explicit list that later slices of the port shrink.  ``kernels.on_tpu`` is
# the TPU-only platform switch and gets no counterpart.
STILL_MISSING = {
    "": set(),
    "manifolds": set(),
    "kernels": {"on_tpu"},
    "solvers": set(),
    "core": set(),
    "linalg": set(),
    "models": set(),
    "parallel": set(),
}


@pytest.mark.parametrize("sub", list(STILL_MISSING),
                         ids=lambda s: s or "top-level")
def test_public_names_match_the_jax_package(sub):
    """Every public name of ``optimization_tpu`` (and of its subpackages)
    exists in the port, apart from the ones listed above; a name in the
    list that the port has meanwhile is a stale entry and fails too."""
    import ast
    import importlib

    def public(package):
        """The names the package's ``__init__`` binds itself (``dir`` would
        add every submodule some other test has imported meanwhile)."""
        mod = importlib.import_module(package)
        names = set()
        for node in ast.parse(open(mod.__file__).read()).body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names |= {(a.asname or a.name).split(".")[0]
                          for a in node.names}
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
        return {n for n in names if not n.startswith("_")
                and n != "annotations"}

    name = "." + sub if sub else ""
    J, T = public("optimization_tpu" + name), \
        public("optimization_tpu_torch" + name)
    assert J - T == STILL_MISSING[sub]
    if not sub:
        for n in ("driver", "Stopwatch", "CompositeProblem",
                  "RiemannianProblem", "LeastSquaresProblem"):
            assert n in T


@pytest.mark.parametrize("module", [
    "models.range_sync", "parallel.mesh", "parallel.sharding",
    "parallel.collectives", "parallel.consensus"])
def test_module_all_matches_the_jax_package(module):
    """Each module of the last slice has the JAX module's ``__all__``
    (``collectives.ring_gram`` included), and binds every name in it."""
    import importlib

    J = importlib.import_module("optimization_tpu." + module)
    T = importlib.import_module("optimization_tpu_torch." + module)
    assert list(T.__all__) == list(J.__all__)
    for name in T.__all__:
        assert hasattr(T, name), name


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


def test_stopwatch_and_profiling_helpers(tmp_path):
    """core.host.Stopwatch and core.profiling (torch.profiler in place of
    jax.profiler): the trace holds the annotated region, time_fn returns
    seconds per call (host clock on CPU tensors)."""
    watch = host.Stopwatch()
    x = torch.randn(1000)
    t = profiling.time_fn(lambda v: (v * 2.0).sum(), x, iters=5)
    assert 0.0 < t < 1.0
    assert watch.tock() >= t
    watch.tick()
    assert watch.tock() < 1.0
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("port_region"):
            (x * 3.0).sum()
    assert (tmp_path / "trace.json").exists()
    assert any(e.key == "port_region" for e in prof.key_averages())


def test_annotate_is_free_when_off_and_a_plain_cpu_op_when_on():
    """The port's span: with no profiler recording, ``annotate`` builds
    nothing (one shared no-op for every name) and the profiler started
    afterwards has no event of it; under a CPU ``torch.profiler`` each span
    is one CPU operation, not a user annotation (which the profiler would
    mirror onto the device's timeline), nested in the span around it."""
    off = profiling.annotate("port_off")
    assert off is profiling.annotate("port_other")
    with off:
        torch.ones(3).sum()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("port_outer"):
            with profiling.annotate("port_inner"):
                torch.ones(3).sum()
    events = {e.name: e for e in prof.events()}
    assert "port_off" not in events
    for name in ("port_outer", "port_inner"):
        assert [e.name for e in prof.events()].count(name) == 1
        assert events[name].device_type == torch.autograd.DeviceType.CPU
        assert not events[name].is_user_annotation
    assert events["port_inner"].cpu_parent.name == "port_outer"
    assert events["port_outer"].cpu_parent is None
    kin = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("port_")]
    assert len(kin) == 2 and not any(e.is_user_annotation() for e in kin)
