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
``index_add`` within 1e-12 (f64).  The kernel itself runs on the card
only (``tests/test_torch_cuda.py``).
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the module (the package's ``kernels.segment_sum`` is the function)
SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
CPU = torch.device("cpu")


def kernel_order(plan, parts):
    """``csrc/segment_sum.cu``'s arithmetic on the CPU: the slots in the
    plan's order, each vertex's run [starts[v], starts[v + 1]) added one
    after another from zero."""
    flat = torch.cat([p.reshape(p.shape[0], -1) for p in parts])
    verts = torch.repeat_interleave(torch.arange(plan.n),
                                    torch.diff(plan.starts))
    out = flat.new_zeros((plan.n, flat.shape[1])).index_add(
        0, verts, flat[plan.order])
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
