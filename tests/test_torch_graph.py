"""The port's graph operators (``models/graph.py``) == the JAX package's.

The same numpy multigraphs (self-loops, parallel edges, isolated vertices, a
hub that sends ``"gather"`` to its ``"sort"`` fallback, one-sided ``sides``)
and contributions go through both; every method agrees with JAX's same
method within 1e-12 in float64 (sums in another order), and the gradient
and the jvp of the gradient (TNT's Hessian-vector product) pass through
every method.  The hub tests run each route twice: through the segment
sum's plain version (``index_add`` of one side after the other) and
through :func:`kernel_order`, the card kernel's traversal of the plan (each
vertex's run of sorted slots added in order from zero), at the same
tolerances.  Every path of the graph models, its derivatives included,
adds only through the segment sum (``profile_graph_routes.census``, the
segment sum hidden as its kernel launch is on the card): no other
operation that adds in a varying order on the card, and no ``index_put``
with repeated indices.  In f32 with four threads the models' gradients
and hvps repeat bit for bit (a plain gather's pullback added with
atomics across threads), and a TNT solve builds each plan once.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import profile_graph_routes
from optimization_tpu.models import graph as jgraph
from optimization_tpu_torch.models import graph as tgraph
from test_torch_segment_sum import kernel_order

# the module (the package's ``kernels.segment_sum`` is the function)
SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
torch.set_num_threads(1)

METHODS = ["scatter", "gather", "sort"]
CPU = torch.device("cpu")


def _random_graph(seed, n, E, hub=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 1, E)      # vertex n - 1 stays isolated
    dst = rng.integers(0, n - 1, E)
    src[0] = dst[0] = 3              # self-loop
    src[1] = src[2] = dst[2] = 5     # parallel + another self-loop
    if hub:
        dst[: E // 2] = 0            # hub vertex
    return src, dst


@pytest.fixture(params=["plain", "kernel_order"])
def branch(request, monkeypatch):
    """Each route through the segment sum's plain version, or through the
    kernel's traversal of its plan."""
    if request.param == "kernel_order":
        monkeypatch.setattr(SS, "segment_sum_reference", kernel_order)
    return request.param


def _contrib(E, trailing, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E,) + trailing),
            rng.standard_normal((E,) + trailing))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("trailing", [(), (4,), (3, 2)])
def test_methods_match_jax(method, trailing):
    n, E = 23, 60
    src, dst = _random_graph(0, n, E)
    a, b = _contrib(E, trailing, 1)
    out = tgraph.edge_accumulator(src, dst, n, method=method, device=CPU)(
        torch.from_numpy(a), torch.from_numpy(b))
    ref = jgraph.edge_accumulator(src, dst, n, method=method)(
        jnp.asarray(a), jnp.asarray(b))
    assert out.shape == (n,) + trailing and out.device == CPU
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    touched = np.zeros(n, bool)
    touched[src] = touched[dst] = True
    assert not touched.all()
    np.testing.assert_array_equal(out.numpy()[~touched], 0.0)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("side", ["src", "dst"])
def test_one_sided_matches_jax(method, side):
    n, E = 11, 30
    src, dst = _random_graph(2, n, E)
    a, _ = _contrib(E, (5,), 3)
    args = (a, None) if side == "src" else (None, a)
    out = tgraph.edge_accumulator(src, dst, n, method=method, sides=(side,),
                                  device=CPU)(
        *(None if x is None else torch.from_numpy(x) for x in args))
    ref = jgraph.edge_accumulator(src, dst, n, method=method, sides=(side,))(
        *(None if x is None else jnp.asarray(x) for x in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_gather_hub_fallback_matches_jax():
    n, E = 400, 500
    src, dst = _random_graph(4, n, E, hub=True)
    a, b = _contrib(E, (), 5)
    out = tgraph.edge_accumulator(src, dst, n, method="gather",
                                  pad_factor=2.0, device=CPU)(
        torch.from_numpy(a), torch.from_numpy(b))
    ref = jgraph.edge_accumulator(src, dst, n, method="gather",
                                  pad_factor=2.0)(jnp.asarray(a),
                                                  jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        tgraph.edge_accumulator(np.array([0]), np.array([1]), 2,
                                method="magic", device=CPU)


@pytest.mark.parametrize("method", METHODS)
def test_grad_and_jvp_of_grad_match_jax(method):
    """loss(a) = sum acc(a, 2a)^3: its gradient and the jvp of the gradient
    along a direction, through each method, equal JAX's."""
    n, E = 9, 20
    src, dst = _random_graph(7, n, E)
    a, u = _contrib(E, (3,), 8)
    tacc = tgraph.edge_accumulator(src, dst, n, method=method, device=CPU)
    jacc = jgraph.edge_accumulator(src, dst, n, method=method)
    tloss = lambda x: torch.sum(tacc(x, 2.0 * x) ** 3)  # noqa: E731
    jloss = lambda x: jnp.sum(jacc(x, 2.0 * x) ** 3)  # noqa: E731
    ta, tu = torch.from_numpy(a), torch.from_numpy(u)
    g, hv = torch.func.jvp(torch.func.grad(tloss), (ta,), (tu,))
    jg, jhv = jax.jvp(jax.grad(jloss), (jnp.asarray(a),), (jnp.asarray(u),))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=1e-10,
                               atol=1e-12)


def test_adjacency_tables_match_jax():
    n, E = 17, 40
    src, dst = _random_graph(9, n, E)
    nb, eid, fwd, deg_max = tgraph.adjacency_tables(src, dst, n, device=CPU)
    jnb, jeid, jfwd, jdeg = jgraph.adjacency_tables(src, dst, n)
    assert deg_max == jdeg and nb.dtype == eid.dtype == torch.int64
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(eid.numpy(), np.asarray(jeid))
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jfwd))


@pytest.mark.parametrize("method", METHODS + ["adjacency"])
def test_laplacian_apply_matches_jax(method):
    n, E = 15, 45
    src, dst = _random_graph(10, n, E)
    rng = np.random.default_rng(11)
    tau = rng.uniform(0.5, 2.0, E)
    z = rng.standard_normal((n, 4))
    out = tgraph.laplacian_apply(src, dst, torch.from_numpy(tau), n,
                                 method=method)(torch.from_numpy(z))
    ref = jgraph.laplacian_apply(src, dst, jnp.asarray(tau), n,
                                 method=method)(jnp.asarray(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_tensor_indices_stay_on_their_device():
    src = torch.tensor([0, 1, 2])
    dst = torch.tensor([1, 2, 0])
    acc = tgraph.edge_accumulator(src, dst, 3, method="sort")
    out = acc(torch.ones(3), torch.ones(3))
    assert out.device == CPU
    np.testing.assert_array_equal(out.numpy(), [2.0, 2.0, 2.0])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("trailing", [(), (3, 2)])
def test_methods_match_jax_on_a_hub_graph(branch, method, trailing):
    """A hub takes half the edges (``"gather"`` falls back to ``"sort"``)."""
    n, E = 400, 500
    src, dst = _random_graph(12, n, E, hub=True)
    a, b = _contrib(E, trailing, 13)
    out = tgraph.edge_accumulator(src, dst, n, method=method, device=CPU)(
        torch.from_numpy(a), torch.from_numpy(b))
    ref = jgraph.edge_accumulator(src, dst, n, method=method)(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_grad_and_jvp_of_grad_match_jax_on_a_hub_graph(branch, method):
    """test_grad_and_jvp_of_grad_match_jax's loss on a hub graph."""
    n, E = 60, 150
    src, dst = _random_graph(14, n, E, hub=True)
    a, u = _contrib(E, (3,), 15)
    tacc = tgraph.edge_accumulator(src, dst, n, method=method, device=CPU)
    jacc = jgraph.edge_accumulator(src, dst, n, method=method)
    tloss = lambda x: torch.sum(tacc(x, 2.0 * x) ** 3)  # noqa: E731
    jloss = lambda x: jnp.sum(jacc(x, 2.0 * x) ** 3)  # noqa: E731
    g, hv = torch.func.jvp(torch.func.grad(tloss), (torch.from_numpy(a),),
                           (torch.from_numpy(u),))
    jg, jhv = jax.jvp(jax.grad(jloss), (jnp.asarray(a),), (jnp.asarray(u),))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("method", METHODS + ["adjacency"])
def test_laplacian_apply_matches_jax_on_a_hub_graph(branch, method):
    n, E = 60, 150
    src, dst = _random_graph(16, n, E, hub=True)
    rng = np.random.default_rng(17)
    tau = rng.uniform(0.5, 2.0, E)
    z = rng.standard_normal((n, 4))
    out = tgraph.laplacian_apply(src, dst, torch.from_numpy(tau), n,
                                 method=method)(torch.from_numpy(z))
    ref = jgraph.laplacian_apply(src, dst, jnp.asarray(tau), n,
                                 method=method)(jnp.asarray(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("hub", [False, True], ids=["plain", "hub"])
def test_vertex_degree_matches_jax(branch, hub):
    """The degree every model takes (JAX's ``.at[src].add(w).at[dst]
    .add(w)``), self-loops counted twice, isolated vertices 0."""
    n, E = 50, 120
    src, dst = _random_graph(18, n, E, hub=hub)
    w = np.random.default_rng(19).uniform(0.5, 2.0, E)
    out = tgraph.vertex_degree(torch.from_numpy(src), torch.from_numpy(dst),
                               torch.from_numpy(w), n)
    ref = jnp.zeros(n).at[src].add(w).at[dst].add(w)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    assert out[n - 1] == 0.0


@pytest.fixture(scope="module")
def model_paths():
    return profile_graph_routes.model_paths(torch, CPU, torch.float64)


@pytest.mark.parametrize("path", profile_graph_routes.PATH_NAMES)
def test_model_path_adds_in_a_fixed_order(model_paths, monkeypatch, path):
    """No path of the graph models (forward, gradient, jvp of the gradient)
    dispatches an operation that adds in a varying order on the card, the
    segment sum's plain version hidden from the census (on the card it is
    one launch of its kernel)."""
    plain = SS.segment_sum_reference

    def launch(plan, parts, **split):
        with _disable_current_modes():
            return plain(plan, parts, **split)

    monkeypatch.setattr(SS, "segment_sum_reference", launch)
    with profile_graph_routes.census(torch) as found:
        model_paths[path]()
    assert not found


@pytest.mark.parametrize("side", ["src", "dst"])
def test_scatter_with_one_side_none_matches_jax(side):
    """``"scatter"`` with the default sides adds nothing for a side given
    ``None``, as JAX's ``.at[].add`` pair does."""
    n, E = 13, 40
    src, dst = _random_graph(20, n, E)
    a, _ = _contrib(E, (2,), 21)
    args = (a, None) if side == "src" else (None, a)
    out = tgraph.edge_accumulator(src, dst, n, device=CPU)(
        *(None if x is None else torch.from_numpy(x) for x in args))
    ref = jgraph.edge_accumulator(src, dst, n)(
        *(None if x is None else jnp.asarray(x) for x in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def _twice_on_four_threads(fn):
    """fn() twice with four CPU threads (the thread count restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        return fn(), fn()
    finally:
        torch.set_num_threads(saved)


def _fault_chordal():
    from optimization_tpu_torch.models import rotation_sync as rs

    gen = torch.Generator().manual_seed(31)
    _, data = rs.random_instance(gen, 2000, 3, extra_edges=4000, noise=0.1,
                                 dtype=torch.float32, device=CPU)
    R = rs.ROTATIONS.rand(gen, 2000, 3, 3, dtype=torch.float32)
    V = torch.randn(R.shape, generator=gen, dtype=torch.float32)
    grad = torch.func.grad(lambda x: rs.chordal_cost(x, data))
    return lambda: torch.func.jvp(grad, (R,), (V,))


def _fault_marginalized():
    import chip_smoke
    from optimization_tpu_torch.models import pose_sync as ps
    from optimization_tpu_torch.models import rotation_sync as rs

    graph, _, _ = chip_smoke.pose_graph(torch, 2000, 4000, 0.01, 5.0, seed=32)
    f32 = torch.float32
    prob, _, _ = ps.marginalized_problem(
        torch.as_tensor(graph.src), torch.as_tensor(graph.dst),
        torch.as_tensor(graph.Rij, dtype=f32),
        torch.as_tensor(graph.tij, dtype=f32), n=2000, cg_iterations=50)
    gen = torch.Generator().manual_seed(33)
    Q = rs.ROTATIONS.rand(gen, 2000, 3, 3, dtype=f32)
    V = rs.ROTATIONS.proj(Q, torch.randn(Q.shape, generator=gen, dtype=f32))

    def run():
        g, hvp = prob.qm(Q, None)
        return g, hvp(V)
    return run


def _fault_range():
    from optimization_tpu_torch.manifolds import sphere
    from optimization_tpu_torch.models import range_sync as rg
    from optimization_tpu_torch.models import rotation_sync as rs

    gen = torch.Generator().manual_seed(34)
    _, _, data = rg.random_instance(gen, 2000, extra_edges=4000,
                                    n_ranges=2000, noise=0.01,
                                    dtype=torch.float32, device=CPU)
    x = (rs.ROTATIONS.rand(gen, 2000, 3, 3, dtype=torch.float32),
         torch.randn((2000, 3), generator=gen),
         sphere().rand(gen, data.rsrc.shape[0], 3, dtype=torch.float32,
                       device=CPU))
    problem = rg.make_problem(data)

    def run():
        g, hvp = problem.qm(x)
        return g, hvp(g)
    return run


@pytest.mark.parametrize("model", ["chordal", "marginalized", "range"])
def test_f32_derivatives_repeat_on_four_threads(model):
    """ROADMAP Queue 3's CPU fault: in f32 with several threads the pullback
    of a plain gather (``index_put(accumulate=True)``) adds with atomics,
    so gradients differed from run to run.  Through the planned gather
    (``kernels.segment_sum.planned_gather``: the segment sum of a plan
    built once) the gradient and the hvp of rotation sync's chordal cost,
    the marginalized pose problem and range sync's objective, at n = 2,000,
    repeat bit for bit."""
    run = {"chordal": _fault_chordal, "marginalized": _fault_marginalized,
           "range": _fault_range}[model]()
    first, second = _twice_on_four_threads(run)
    flat = lambda o: [o] if isinstance(o, torch.Tensor) else [  # noqa: E731
        t for x in o for t in flat(x)]
    a, b = flat(first), flat(second)
    assert len(a) == len(b) > 0
    assert all(x.dtype == torch.float32 and torch.equal(x, y)
               for x, y in zip(a, b))


def test_tnt_solve_builds_each_plan_once():
    """A preconditioned rotation-sync TNT builds its plans (the gathers by
    src and dst, the degree's) at its first gradient, and a second solve on
    the same data builds none."""
    from optimization_tpu_torch.models import rotation_sync as rs
    from optimization_tpu_torch.solvers import tnt

    gen = torch.Generator().manual_seed(35)
    _, data = rs.random_instance(gen, 30, 3, extra_edges=60, noise=0.05,
                                 dtype=torch.float64, device=CPU)
    R0 = rs.ROTATIONS.rand(gen, 30, 3, 3, dtype=torch.float64)
    problem = rs.make_problem(preconditioned=True)
    params = tnt.TNTParams(max_iterations=5)
    before = SS.segment_plan.builds
    res = tnt.solve(problem, R0, params, data=data)
    first = SS.segment_plan.builds - before
    assert int(res.num_iterations) > 1 and 1 <= first <= 3
    tnt.solve(problem, R0, params, data=data)
    assert SS.segment_plan.builds - before == first
