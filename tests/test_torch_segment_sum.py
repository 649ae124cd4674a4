"""The segment sum of the graph models (``kernels/segment_sum.py``) on the
CPU: its plan, its plain version, the card kernel's arithmetic and its
derivatives.

:func:`kernel_order` does on the CPU what ``csrc/segment_sum.cu`` does on
the card: it walks the plan (the slots sorted stably by vertex, each
vertex's run) and adds each run one slot after another from zero.  It
equals the plain version (``index_add`` of one part after the other) bit
for bit, in f32 and f64, on multigraphs with self-loops, isolated vertices
and a hub.  The gradient, the jvp, the jvp of the gradient, a second
backward and ``torch.func.vmap`` equal those of the same sum written with
``index_add`` within 1e-12 (f64).  The split sum (a pair gather's
pullback) is two ``index_add`` sums added, bit for bit.  The plan cache
builds a plan once for live index tensors.  The planned gather is
``x[idx]`` bit for bit (a padded table's padding a row of zeros, left out
of the plan), its pullback the one-thread ``index_put`` pullback bit for
bit, and its derivatives those of plain indexing; the calls that skip the
autograd Functions give the Function path's bits.  The kernel itself runs
on the card only (``tests/test_torch_cuda.py``).
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the module (the package's ``kernels.segment_sum`` is the function)
SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
CPU = torch.device("cpu")


def kernel_order(plan, parts, split=False):
    """``csrc/segment_sum.cu``'s arithmetic on the CPU: the slots in the
    plan's order, each vertex's run [starts[v], starts[v + 1]) added one
    after another from zero (with ``split``, part 0's and part 1's slots of
    the run into two sums, then the two added)."""
    flat = torch.cat([p.reshape(p.shape[0], -1) for p in parts])
    verts = torch.repeat_interleave(torch.arange(plan.n),
                                    torch.diff(plan.starts))
    order = plan.order[: int(plan.starts[-1])]   # a padded table's padding
    rows = flat[order]
    zeros = flat.new_zeros((plan.n, flat.shape[1]))
    if split and len(parts) == 2:
        second = order >= parts[0].shape[0]
        out = (zeros.index_add(0, verts[~second], rows[~second])
               + zeros.index_add(0, verts[second], rows[second]))
    else:
        out = zeros.index_add(0, verts, rows)
    return out.reshape((plan.n,) + tuple(parts[0].shape[1:]))


def _graph(seed, n, E, hub):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 1, E)          # vertex n - 1 stays isolated
    dst = rng.integers(0, n - 1, E)
    src[0] = dst[0] = 3                      # a self-loop
    if hub:
        dst[: E // 2] = 0
    return torch.from_numpy(src), torch.from_numpy(dst)


def _parts(E, trailing, dtype, n_parts, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((E,) + trailing, generator=gen, dtype=dtype)
            for _ in range(n_parts)]


@pytest.mark.parametrize("hub", [False, True], ids=["plain", "hub"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_plan_sorts_the_slots_stably(hub, n_parts):
    src, dst = _graph(0, 30, 200, hub)
    plan = SS.segment_plan((src, dst)[:n_parts], 30)
    verts = torch.cat((src, dst)[:n_parts])
    np.testing.assert_array_equal(
        plan.order.numpy(), np.argsort(verts.numpy(), kind="stable"))
    counts = np.bincount(verts.numpy(), minlength=30)
    np.testing.assert_array_equal(plan.starts.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    assert plan.n == 30 and all(i.dtype == torch.int64 for i in plan.index)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("trailing", [(), (3,), (3, 8)])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("hub", [False, True], ids=["plain", "hub"])
def test_kernel_order_is_the_plain_version_bit_for_bit(dtype, trailing,
                                                       n_parts, hub):
    n, E = 50, 400
    src, dst = _graph(2, n, E, hub)
    plan = SS.segment_plan((src, dst)[:n_parts], n)
    parts = _parts(E, trailing, dtype, n_parts)
    plain = SS.segment_sum(plan, parts)
    assert plain.shape == (n,) + trailing and plain.dtype == dtype
    assert torch.equal(kernel_order(plan, parts), plain)
    assert not plain[n - 1].any()
    ref = np.zeros((n,) + trailing)
    for idx, p in zip((src, dst), parts):
        np.add.at(ref, idx.numpy(), p.double().numpy())
    np.testing.assert_allclose(plain.double().numpy(), ref,
                               rtol=1e-5 if dtype == torch.float32 else 1e-12,
                               atol=1e-5 if dtype == torch.float32 else 1e-12)


def _index_add_sum(plan, parts):
    """The same sum by differentiable ``index_add``s (the reference of the
    derivatives)."""
    out = parts[0].new_zeros((plan.n,) + tuple(parts[0].shape[1:]))
    for idx, part in zip(plan.index, parts):
        out = out.index_add(0, idx, part)
    return out


@pytest.mark.parametrize("n_parts", [1, 2])
def test_grad_jvp_and_jvp_of_grad_match_index_add(n_parts):
    n, E = 20, 90
    src, dst = _graph(3, n, E, True)
    plan = SS.segment_plan((src, dst)[:n_parts], n)
    a, u = _parts(E, (3,), torch.float64, 2, seed=4)

    def loss(fn):
        def f(x):
            parts = [x, 2.0 * x][:n_parts]
            return torch.sum(fn(plan, parts) ** 3)
        return f

    for fn in (SS.segment_sum, _index_add_sum):
        out = torch.func.jvp(torch.func.grad(loss(fn)), (a,), (u,))
        if fn is SS.segment_sum:
            got = out
        else:
            ref = out
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                   atol=1e-12)
    parts = [a, u][:n_parts]
    tangents = [u, a][:n_parts]
    _, t1 = torch.func.jvp(lambda *p: SS.segment_sum(plan, p), tuple(parts),
                           tuple(tangents))
    _, t2 = torch.func.jvp(lambda *p: _index_add_sum(plan, p), tuple(parts),
                           tuple(tangents))
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_second_backward_and_one_tangent_match_index_add():
    n, E = 15, 60
    src, dst = _graph(5, n, E, False)
    plan = SS.segment_plan((src, dst), n)
    a, b = _parts(E, (2,), torch.float64, 2, seed=6)
    grads = []
    for fn in (SS.segment_sum, _index_add_sum):
        x = a.clone().requires_grad_(True)
        y = b.clone().requires_grad_(True)
        f = torch.sum(fn(plan, (x * x, y)) ** 2)
        gx, gy = torch.autograd.grad(f, (x, y), create_graph=True)
        hx, = torch.autograd.grad(torch.sum(gx * gy), (x,))
        # a tangent on one part only
        _, t = torch.func.jvp(lambda p: fn(plan, (p, b)), (a,), (b,))
        grads.append((gx, gy, hx, t))
    for x, y in zip(*grads):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batched", ["both", "first"])
def test_vmap_matches_a_loop(batched):
    n, E, B = 12, 40, 3
    src, dst = _graph(7, n, E, True)
    plan = SS.segment_plan((src, dst), n)
    gen = torch.Generator().manual_seed(8)
    a = torch.randn((B, E, 2), generator=gen, dtype=torch.float64)
    b = torch.randn((B, E, 2), generator=gen, dtype=torch.float64)
    if batched == "both":
        got = torch.func.vmap(lambda x, y: SS.segment_sum(plan, (x, y)))(a, b)
        want = [SS.segment_sum(plan, (a[i], b[i])) for i in range(B)]
    else:
        got = torch.func.vmap(lambda x: SS.segment_sum(plan, (x, b[0])))(a)
        want = [SS.segment_sum(plan, (a[i], b[0])) for i in range(B)]
    assert torch.equal(got, torch.stack(want))


def test_rejects_what_it_does_not_take():
    src, dst = _graph(9, 10, 20, False)
    plan = SS.segment_plan((src, dst), 10)
    a, b = _parts(20, (), torch.float64, 2)
    with pytest.raises(ValueError, match="the plan has 2 parts"):
        SS.segment_sum(plan, (a,))
    with pytest.raises(ValueError, match="a part of shape"):
        SS.segment_sum(plan, (a, b[:5]))
    with pytest.raises(ValueError, match="one device"):
        SS.segment_sum(plan, (a, b.float()))
    with pytest.raises(ValueError, match="one or two parts"):
        SS.segment_plan((src, dst, src), 10)
    meta = SS.segment_plan((src.to("meta"),), 10)
    with pytest.raises(ValueError, match="not meta"):
        SS.segment_sum(meta, (a.to("meta"),))
    before = SS.segment_sum.launches
    SS.segment_sum(plan, (a, b))
    assert SS.segment_sum.launches == before


def test_empty_parts_and_widths():
    plan = SS.segment_plan((torch.zeros(0, dtype=torch.int64),), 4)
    out = SS.segment_sum(plan, (torch.zeros((0, 3)),))
    assert out.shape == (4, 3) and not out.any()
    src, dst = _graph(10, 6, 12, False)
    plan = SS.segment_plan((src, dst), 6)
    out = SS.segment_sum(plan, (torch.zeros((12, 0)), torch.zeros((12, 0))))
    assert out.shape == (6, 0)


# ---- the plan cache and the planned gather ----

def test_plans_are_built_once_for_live_index_tensors():
    """The same index tensors and n give the same plan without a build; a
    change in place, another n or other tensors build anew; a plan dies
    with its index tensors; ids are int32 below 2^31 slots."""
    src, dst = _graph(11, 20, 60, False)
    before = SS.segment_plan.builds
    plan = SS.segment_plan((src, dst), 20)
    assert SS.segment_plan.builds == before + 1
    assert SS.segment_plan((src, dst), 20) is plan
    assert SS.segment_plan([src, dst], 20) is plan
    assert SS.segment_plan.builds == before + 1
    assert plan.order.dtype == plan.starts.dtype == torch.int32
    assert SS.segment_plan((src, dst), 21) is not plan
    assert SS.segment_plan((dst, src), 20) is not plan
    assert SS.segment_plan((src.clone(), dst), 20) is not plan
    assert SS.segment_plan.builds == before + 4
    src[0] = 7                                   # in place: a new plan
    moved = SS.segment_plan((src, dst), 20)
    assert moved is not plan and int(moved.index[0][0]) == 7
    keys = len(SS._PLANS)
    del src, dst, plan, moved
    import gc

    gc.collect()
    assert len(SS._PLANS) < keys
    # a plan holds copies of its indices, not the caller's tensors
    idx = torch.arange(5)
    p = SS.segment_plan((idx,), 5)
    assert p.index[0] is not idx and p.index[0]._base is not idx


@pytest.mark.parametrize("shape", [(90,), (15, 6)], ids=["1d", "table"])
@pytest.mark.parametrize("trailing", [(), (3,), (3, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_planned_gather_is_plain_indexing_bit_for_bit(shape, trailing,
                                                      dtype):
    """Forward: ``x[idx]`` bit for bit.  Pullback: the plain gather's
    (``index_put(accumulate=True)``) bit for bit at one thread, with a hub
    (the padding row of a padded table repeats as one)."""
    n = 20
    gen = torch.Generator().manual_seed(12)
    idx = torch.randint(0, n, shape, generator=gen)
    idx.view(-1)[: idx.numel() // 2] = n - 1           # a hub
    x = torch.randn((n,) + trailing, generator=gen, dtype=dtype)
    cot = torch.randn(shape + trailing, generator=gen, dtype=dtype)
    got = SS.planned_gather(x, idx)
    assert got.shape == shape + trailing and torch.equal(got, x[idx])
    _, pull = torch.func.vjp(lambda y: SS.planned_gather(y, idx), x)
    _, plain = torch.func.vjp(lambda y: y[idx], x)
    assert torch.equal(pull(cot)[0], plain(cot)[0])
    leaf = x.clone().requires_grad_(True)
    SS.planned_gather(leaf, idx).backward(cot)
    assert torch.equal(leaf.grad, plain(cot)[0])


def test_planned_gather_derivatives_match_plain_indexing():
    """jvp, the jvp of a gradient, a second backward and ``vmap`` (with the
    gradient under it) against ``x[idx]`` in f64."""
    n, B = 25, 3
    gen = torch.Generator().manual_seed(13)
    idx = torch.randint(0, n, (70,), generator=gen)
    table = torch.randint(0, n, (10, 4), generator=gen)
    x, u = (torch.randn((n, 3), generator=gen, dtype=torch.float64)
            for _ in range(2))
    xs = torch.randn((B, n, 3), generator=gen, dtype=torch.float64)

    def loss(gather):
        return lambda y: (torch.sum(gather(y, idx) ** 3)
                          + torch.sum(torch.sin(gather(y, table))))

    planned, plain = loss(SS.planned_gather), loss(lambda y, i: y[i])
    got, want = [], []
    for f, out in ((planned, got), (plain, want)):
        out.append(torch.func.jvp(f, (x,), (u,)))
        out.append(torch.func.jvp(torch.func.grad(f), (x,), (u,)))
        out.append(torch.func.grad(
            lambda y, f=f: torch.sum(torch.func.grad(f)(y) ** 2))(x))
        leaf = x.clone().requires_grad_(True)
        g, = torch.autograd.grad(f(leaf), leaf, create_graph=True)
        out.append(torch.autograd.grad(torch.sum(g * u), leaf)[0])
        out.append(torch.func.vmap(torch.func.grad(f))(xs))
    for a, b in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-12, atol=1e-12)
    batched = torch.func.vmap(lambda y: SS.planned_gather(y, table))(xs)
    assert torch.equal(batched, xs[:, table])
    # an unbatched x under vmap, and vmap over the second axis
    ys = torch.randn((B, 70, 3), generator=gen, dtype=torch.float64)
    assert torch.equal(torch.func.vmap(
        lambda y: SS.planned_gather(x, idx) * y)(ys), x[idx] * ys)
    assert torch.equal(torch.func.vmap(lambda y: SS.planned_gather(y, idx),
                                       in_dims=1)(xs.movedim(0, 1)),
                       xs[:, idx])


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def test_segment_sum_pullback_is_a_planned_gather():
    """The segment sum's pullback gathers through the plan: its own
    pullback (a second derivative) is a segment sum, and no derivative of
    any order dispatches ``index_put`` (hidden operations of the plain
    versions aside)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    src, dst = _graph(14, 20, 80, True)
    plan = SS.segment_plan((src, dst), 20)
    a, u = _parts(80, (3,), torch.float64, 2, seed=15)
    seen = set()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    f = lambda x: torch.sum(SS.segment_sum(plan, (x, x * x)) ** 3)  # noqa
    with Ops():
        torch.func.jvp(torch.func.grad(f), (a,), (u,))
        torch.func.grad(lambda x: torch.sum(torch.func.grad(f)(x) ** 2))(a)
    assert not any(op.startswith("aten.index_put") for op in seen)
    assert "aten.index_add" in seen


def test_planned_gather_rejects_what_it_does_not_take():
    """The segment sum's rejections: one device, CPU or CUDA, an integer
    index; the plain versions launch nothing."""
    x = torch.randn(10, 2, dtype=torch.float64)
    idx = torch.tensor([0, 3, 3, 9])
    with pytest.raises(ValueError, match="one device"):
        SS.planned_gather(x, idx.to("meta"))
    with pytest.raises(ValueError, match="not meta"):
        SS.planned_gather(x.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="integer index"):
        SS.planned_gather(x, idx.double())
    with pytest.raises(ValueError, match="integer index"):
        SS.planned_gather(x, idx > 2)
    before = SS.segment_sum.launches
    leaf = x.clone().requires_grad_(True)
    SS.planned_gather(leaf, idx).sum().backward()
    assert SS.segment_sum.launches == before
    assert torch.equal(leaf.grad[:, 0], torch.tensor(
        [1.0, 0, 0, 2, 0, 0, 0, 0, 0, 1], dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("hub", [False, True], ids=["plain", "hub"])
def test_split_sum_is_two_sums_added_bit_for_bit(dtype, hub):
    """``segment_sum(split=True)``: each part's rows added on their own in
    the plan's order, then the two sums: bit for bit two ``index_add``s
    onto zeros added, and the kernel's traversal (:func:`kernel_order`)."""
    n, E = 40, 300
    src, dst = _graph(16, n, E, hub)
    plan = SS.segment_plan((src, dst), n)
    parts = _parts(E, (3,), dtype, 2, seed=17)
    got = SS.segment_sum(plan, parts, split=True)
    zeros = parts[0].new_zeros((n, 3))
    want = (zeros.index_add(0, src, parts[0])
            + zeros.index_add(0, dst, parts[1]))
    assert torch.equal(got, want)
    assert torch.equal(kernel_order(plan, parts, split=True), want)
    assert not torch.equal(got, SS.segment_sum(plan, parts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_planned_gather_of_a_pair_is_two_gathers(dtype):
    """A gather by an edge's two endpoints in one call: ``(x[i0], x[i1])``
    bit for bit, its pullback the two plain gathers' pullbacks added bit
    for bit (one split segment sum over the plan of both), its jvp, second
    backward and ``vmap`` those of two plain gathers (f64 within 1e-12)."""
    n = 30
    gen = torch.Generator().manual_seed(18)
    i0 = torch.randint(0, n, (80,), generator=gen)
    i1 = torch.randint(0, n, (80,), generator=gen)
    i1[:30] = 2                                      # a hub
    x = torch.randn((n, 3), generator=gen, dtype=dtype)
    c0, c1 = (torch.randn((80, 3), generator=gen, dtype=dtype)
              for _ in range(2))
    a, b = SS.planned_gather(x, (i0, i1))
    assert torch.equal(a, x[i0]) and torch.equal(b, x[i1])
    assert isinstance(SS.planned_gather(x, [i0, i1]), tuple)
    _, pull = torch.func.vjp(lambda y: SS.planned_gather(y, (i0, i1)), x)
    _, plain = torch.func.vjp(lambda y: (y[i0], y[i1]), x)
    assert torch.equal(pull((c0, c1))[0], plain((c0, c1))[0])
    # one output unused: its cotangent is zero
    _, pull0 = torch.func.vjp(lambda y: SS.planned_gather(y, (i0, i1))[0], x)
    assert torch.equal(pull0(c0)[0], torch.func.vjp(lambda y: y[i0], x)[1](
        c0)[0])
    if dtype == torch.float64:
        u = torch.randn((n, 3), generator=gen, dtype=dtype)
        xs = torch.randn((3, n, 3), generator=gen, dtype=dtype)

        def loss(pair):
            def f(y):
                p, q = pair(y)
                return torch.sum(p ** 3 * q) + torch.sum(torch.cos(q))
            return f

        def derivatives(f):
            return [torch.func.jvp(torch.func.grad(f), (x,), (u,)),
                    torch.func.grad(lambda y: torch.sum(
                        torch.func.grad(f)(y) ** 2))(x),
                    torch.func.vmap(torch.func.grad(f))(xs)]

        got = derivatives(loss(lambda y: SS.planned_gather(y, (i0, i1))))
        want = derivatives(loss(lambda y: (y[i0], y[i1])))
        for g, w in zip(_flat(got), _flat(want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                       atol=1e-12)
        batched = torch.func.vmap(
            lambda y: SS.planned_gather(y, (i0, i1)))(xs)
        assert torch.equal(batched[0], xs[:, i0])
        assert torch.equal(batched[1], xs[:, i1])
    with pytest.raises(ValueError, match="one index or two"):
        SS.planned_gather(x, (i0, i1, i0))


def test_calls_no_derivative_can_reach_skip_the_functions():
    """Outside autograd and ``torch.func`` the gather is plain indexing and
    the sum the plain version (no autograd node); with a tensor that
    requires grad, or inside a transform, they go through the Functions."""
    src, dst = _graph(19, 12, 40, False)
    plan = SS.segment_plan((src, dst), 12)
    a, b = _parts(40, (2,), torch.float64, 2, seed=20)
    x = torch.randn((12, 2), dtype=torch.float64)
    assert SS.planned_gather(x, src).grad_fn is None
    assert SS.segment_sum(plan, (a, b)).grad_fn is None
    leaf = x.clone().requires_grad_(True)
    assert "PlannedGather" in type(SS.planned_gather(leaf, src).grad_fn
                                   ).__name__
    with torch.no_grad():
        assert SS.planned_gather(leaf, src).grad_fn is None
    parts = (a.clone().requires_grad_(True), b)
    assert "SegmentSum" in type(SS.segment_sum(plan, parts).grad_fn).__name__


@pytest.mark.parametrize("trailing", [(), (3,), (3, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_padded_gather_leaves_the_padding_out_of_the_plan(dtype, trailing):
    """A padded table (entry n = the padding): the forward is ``x`` with a
    zero row appended, gathered, bit for bit; the padding's slots lie past
    the plan's last run, and the pullback is the plain gather's of the
    extended ``x`` without its last row, bit for bit at one thread."""
    n = 20
    gen = torch.Generator().manual_seed(21)
    table = torch.randint(0, n, (n, 6), generator=gen)
    table[:, 3:] = n
    table[0, 1] = n
    x = torch.randn((n,) + trailing, generator=gen, dtype=dtype)
    cot = torch.randn(table.shape + trailing, generator=gen, dtype=dtype)
    ext = torch.cat([x, x.new_zeros((1,) + trailing)])
    got = SS.planned_gather(x, table, padded=True)
    assert torch.equal(got, ext[table])
    plan = SS.segment_plan((table,), n)
    assert int(plan.starts[-1]) == int((table < n).sum())
    _, pull = torch.func.vjp(
        lambda y: SS.planned_gather(y, table, padded=True), x)
    _, plain = torch.func.vjp(lambda y: y[table], ext)
    assert torch.equal(pull(cot)[0], plain(cot)[0][:n])
    # the kernel's traversal never reads the padding's slots
    rows = cot.reshape((table.numel(),) + trailing)
    assert torch.equal(kernel_order(plan, [rows]), pull(cot)[0])
    if dtype == torch.float64:
        u = torch.randn_like(x)
        xs = torch.randn((3,) + x.shape, generator=gen, dtype=dtype)

        def loss(gather):
            return lambda y: torch.sum(torch.sin(gather(y)) * gather(y) ** 2)

        planned = loss(lambda y: SS.planned_gather(y, table, padded=True))
        ext_loss = loss(lambda y: torch.cat(
            [y, y.new_zeros((1,) + tuple(y.shape[1:]))])[table])
        for f in (planned, ext_loss):
            f.out = [torch.func.jvp(torch.func.grad(f), (x,), (u,)),
                     torch.func.vmap(torch.func.grad(f))(xs)]
        for a, b in zip(_flat(planned.out), _flat(ext_loss.out)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


def _transformed(kind, f, x, u, xs):
    """One ``torch.func`` composition of ``f`` at ``x`` (tangent ``u``,
    batch ``xs``)."""
    grad = torch.func.grad(f)
    if kind == "grad":
        return grad(x)
    if kind == "jvp of grad":
        return torch.func.jvp(grad, (x,), (u,))
    if kind == "vmap of jvp":
        return torch.func.vmap(
            lambda y, v: torch.func.jvp(grad, (y,), (v,))[1])(xs, xs.flip(0))
    return torch.func.jacfwd(grad)(x)


@pytest.mark.parametrize("kind", ["grad", "jvp of grad", "vmap of jvp",
                                  "jacfwd"])
def test_calls_that_skip_the_functions_equal_the_function_path(kind,
                                                               monkeypatch):
    """The host fast path (``_plainly``: calls no derivative can reach skip
    the autograd Functions) against the Function path alone, bit for bit,
    on gathers (plain, padded) and a segment sum in f64."""
    n = 12
    gen = torch.Generator().manual_seed(22)
    src, dst = _graph(23, n, 40, True)
    table = torch.randint(0, n + 1, (n, 4), generator=gen)
    plan = SS.segment_plan((src, dst), n)
    x, u = (torch.randn((n, 2), generator=gen, dtype=torch.float64)
            for _ in range(2))
    xs = torch.randn((3, n, 2), generator=gen, dtype=torch.float64)

    def f(y):
        a = SS.planned_gather(y, src) * SS.planned_gather(y, dst)
        b = SS.planned_gather(y, table, padded=True)
        s = SS.segment_sum(plan, (a, torch.sin(a)))
        return torch.sum(s ** 2 * y) + torch.sum(b ** 3)

    fast = _transformed(kind, f, x, u, xs)
    monkeypatch.setattr(SS, "_SKIP_FUNCTIONS", False)
    slow = _transformed(kind, f, x, u, xs)
    assert all(torch.equal(a, b) for a, b in zip(_flat(fast), _flat(slow)))
    assert len(_flat(fast)) == len(_flat(slow)) > 0
