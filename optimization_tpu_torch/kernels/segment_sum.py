"""The edge->vertex segment sum of the graph models (``models/graph.py``):
a kernel for Hopper beside its plain version, and the planned gather whose
pullback it is.

A plan (:func:`segment_plan`) holds the vertex ids of one or two parts of
per-edge contributions (a source and a target side) and, built once on
their device, the slots of both parts sorted stably by vertex and each
vertex's run (int32 ids below 2^31 slots, else int64).
:func:`segment_sum` adds every part's rows onto their vertices: ``out[v] =
sum of part_p[e] over (p, e) with index_p[e] = v``, part 0 before part 1
and each in index order.  That order is fixed by the indices, so the card
repeats its results bit for bit, and it is the order of the plain version
(``index_add`` of one part after the other), so the kernel and the plain
version on the CPU give the same bits.

Plans are cached: :func:`segment_plan` keeps one plan for each live
tuple of index tensors (a weak reference to each, with its ``_version``
and ``n``), so a model's plans are built once, at first use, and not at
every call of its operators or derivatives (``segment_plan.builds``
counts the builds).  An index changed in place by PyTorch gets a new plan.

:func:`planned_gather` is ``x[index]`` whose pullback is the segment sum
of the cotangent over the plan of ``index`` (one part): every gather by a
graph index of the models goes through it.  The pullback of a plain
gather is ``index_put(accumulate=True)``, which on the card sorts the
indices again at every call and on the CPU adds with atomics across
threads in f32 (results that differ from run to run); through the plan it
is one launch of the kernel on the card and ``index_add`` on the CPU,
whose single-thread bits it keeps.  Given an edge's two endpoints,
``planned_gather(x, (src, dst))`` returns both gathers from one call, and
its pullback is one *split* segment sum over the plan of both (each
part's run summed on its own, the two sums then added: the bits of two
gathers' pullbacks added, as autograd adds them).  The models pair their
gathers where ``x``'s gradient has no other term, and gather singly
elsewhere, so that every CPU result keeps the bits of plain indexing.

A padded table (``planned_gather(x, table, padded=True)``) may hold
x.shape[0], which reads a row of zeros: those slots sort past the plan's
last run, so the pullback never reads their cotangent.

Each call of an autograd Function costs host time, most of all inside
``torch.func``'s transforms (a generated Function for every level of
every call): calls that no derivative can reach skip the Functions (plain
indexing, the plain sum or the kernel; :func:`_plainly`, the one place
that reads torch's private transform state, with the Function path as its
fallback), and a pair costs one call where two gathers cost two.

It replaces no Pallas kernel.  The JAX package sums with ``.at[].add`` and
``segment_sum`` (``optimization_tpu/models/graph.py:84-86, 135``); on the
card ``index_add`` adds with atomics in an order that varies from run to
run.

On a CUDA tensor :func:`segment_sum` launches ``csrc/segment_sum.cu``
(counted in ``.launches``; f32 and f64) or raises; on a CPU tensor it runs
:func:`segment_sum_reference`.  Both functions are differentiable both
ways: the segment sum's pullback is the planned gather of the output's
cotangent by each part's indices and the gather's the segment sum, each
one's tangent itself applied to the tangents (so the jvp of a gradient,
the TNT Hessian-vector product, passes, and no derivative of any order
reaches ``index_put``), and ``torch.func.vmap`` moves the batch into the
rows.  Indices lie in [0, n).
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import NamedTuple, Sequence

import torch

__all__ = ["SegmentPlan", "planned_gather", "segment_plan", "segment_sum",
           "segment_sum_reference"]


class SegmentPlan(NamedTuple):
    index: tuple             # each part's (E_p,) int64 vertex ids, flat
    order: torch.Tensor      # (sum E_p,) slots sorted stably by vertex
    starts: torch.Tensor     # (n + 1,): v's run [starts[v], starts[v+1])
    n: int                   # (order and starts int32 below 2^31 slots)


# live plans: (ids of the index tensors, n) -> (weak references to them,
# their versions, the plan)
_PLANS: dict = {}


def _build(index, n: int) -> SegmentPlan:
    # plain tensors even inside torch.func's transforms (a pullback builds
    # its plan there; a tensor made there would carry the transform's
    # level past its end), detached copies: the plan must not keep the
    # caller's tensors alive
    with torch._C._DisableFuncTorch():
        index = tuple(i.detach().reshape(-1).to(torch.int64) for i in index)
        verts = torch.cat(index) if len(index) == 2 else index[0]
        narrow = max(verts.numel(), n + 1) < 2 ** 31
        order = torch.argsort(verts, stable=True)
        starts = torch.searchsorted(
            verts[order], torch.arange(n + 1, device=verts.device),
            out_int32=narrow)
        if narrow:
            order = order.to(torch.int32)
    segment_plan.builds += 1
    return SegmentPlan(index=index, order=order, starts=starts, n=int(n))


def segment_plan(index: Sequence[torch.Tensor], n: int) -> SegmentPlan:
    """The plan of one or two parts with vertex ids ``index`` (tensors on one
    device, of any shape: a part's slots are its flattened entries), built
    there: a stable sort of the slots (part 0's slots first) and each
    vertex's run bounds.  No host round trip.  Built once for each live
    tuple of index tensors and ``n`` (module docstring)."""
    index = tuple(index)
    if not 1 <= len(index) <= 2:
        raise ValueError(f"segment_plan takes one or two parts, got "
                         f"{len(index)}")
    key = (tuple(map(id, index)), int(n))
    hit = _PLANS.get(key)
    if hit is not None and all(
            r() is i and v == i._version
            for r, v, i in zip(hit[0], hit[1], index)):
        return hit[2]
    plan = _build(index, n)
    if not any(i.is_inference() for i in index):
        def drop(ref, key=key):
            entry = _PLANS.get(key)
            if entry is not None and any(r is ref for r in entry[0]):
                del _PLANS[key]

        _PLANS[key] = (tuple(weakref.ref(i, drop) for i in index),
                       tuple(i._version for i in index), plan)
    return plan


# Plans built by this process.
segment_plan.builds = 0


def segment_sum_reference(plan: SegmentPlan, parts,
                          split: bool = False) -> torch.Tensor:
    """The plain PyTorch version of :func:`segment_sum`: ``index_add`` of
    one part after the other onto zeros (with ``split``, each part onto
    its own zeros, and the two sums added); a slot of vertex n adds
    nothing."""
    like = parts[0].new_zeros((plan.n + 1,) + tuple(parts[0].shape[1:]))
    if split:
        sums = [like.index_add(0, idx, part)
                for idx, part in zip(plan.index, parts)]
        out = sums[0] if len(sums) == 1 else sums[0] + sums[1]
    else:
        out = like
        for idx, part in zip(plan.index, parts):
            out = out.index_add(0, idx, part)
    return out[:plan.n]


def _lib() -> ctypes.CDLL:
    from ..csrc.build import load

    lib = load("segment_sum")
    if not getattr(lib, "_argtypes_set", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.segment_sum_error_string.argtypes = [i32]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        for fn in (lib.segment_sum_f32, lib.segment_sum_f64):
            fn.argtypes = [vp, vp, i64, i32, vp, vp, i32, i64, i64, vp, vp]
            fn.restype = i32
        lib._argtypes_set = True
    return lib


def _launch(plan: SegmentPlan, parts, split: bool) -> torch.Tensor:
    dev, dtype = parts[0].device, parts[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment_sum's kernel takes f32 or f64, got {dtype}")
    trailing = tuple(parts[0].shape[1:])
    width = math.prod(trailing)
    if plan.n * width == 0:
        return torch.zeros((plan.n,) + trailing, dtype=dtype, device=dev)
    order, starts = plan.order, plan.starts
    if order.dtype == torch.int32 and plan.n * width >= 2 ** 31:
        # the kernel's 32-bit word index would not reach every output word
        order, starts = order.long(), starts.long()
    rows = [p.reshape(p.shape[0], width).contiguous() for p in parts]
    out = torch.empty((plan.n,) + trailing, dtype=dtype, device=dev)
    lib = _lib()
    fn = lib.segment_sum_f32 if dtype == torch.float32 else lib.segment_sum_f64
    with torch.cuda.device(dev):
        code = fn(rows[0].data_ptr(),
                  rows[1].data_ptr() if len(rows) == 2 else None,
                  rows[0].shape[0], int(split and len(rows) == 2),
                  order.data_ptr(), starts.data_ptr(),
                  int(order.dtype == torch.int64), plan.n, width,
                  out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {code} "
                           f"({lib.segment_sum_error_string(code).decode()})")
    segment_sum.launches += 1
    return out


def _check_device(dev: torch.device, what: str) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA tensors (the kernel) or CPU "
                         f"tensors (the plain version), not {dev.type}")


def _forward(plan: SegmentPlan, parts, split: bool) -> torch.Tensor:
    dev = parts[0].device
    for i, p in zip(plan.index, parts):
        if p.device != dev or i.device != dev or p.dtype != parts[0].dtype:
            raise ValueError("segment_sum: parts and plan must share one "
                             "device and the parts one dtype")
        if p.shape[0] != i.shape[0] or p.shape[1:] != parts[0].shape[1:]:
            raise ValueError(f"segment_sum: a part of shape "
                             f"{tuple(p.shape)} for {i.shape[0]} indices")
    _check_device(dev, "segment_sum")
    if dev.type == "cpu":
        return segment_sum_reference(plan, parts, split=split)
    return _launch(plan, parts, split)


# Calls that no derivative can reach skip the autograd Functions
# (:func:`_plainly`); the tests turn this off to hold the two paths equal.
_SKIP_FUNCTIONS = True


def _plain_inputs(tensors, tangent: bool):
    """The plain tensors with which a call may skip the autograd Functions
    (:func:`_plainly`), or None.  The only code here that reads torch's
    private transform state; where any of it is missing or refuses, None:
    the Function path."""
    if not _SKIP_FUNCTIONS:
        return None
    try:
        recorded = torch.is_grad_enabled() and any(t.requires_grad
                                                   for t in tensors)
        forward_level = torch.autograd.forward_ad._current_level
        if (not recorded and forward_level < 0
                and not torch._C._are_functorch_transforms_active()):
            return list(tensors)
        if (not tangent or recorded or forward_level > 0
                or torch._C._functorch.maybe_current_level() != 1):
            return None
        plain = []
        for t in tensors:
            while torch._C._functorch.is_functorch_wrapped_tensor(t):
                t = torch._C._functorch.get_unwrapped(t)
            t.data_ptr()                  # raises where no storage holds t
            plain.append(t)
        return plain
    except (AttributeError, RuntimeError):
        return None


def _plainly(compute, tensors, tangent: bool = False):
    """``compute(plain tensors)`` where no derivative can reach the call,
    else None (the caller takes its autograd Function, right everywhere).

    A Function call costs far more host time than the work, most of all
    inside ``torch.func`` (a Function is generated for every transform
    level at every call).  No derivative can reach (1) a call outside every
    transform and forward-AD level that autograd does not record, nor (2)
    a jvp rule's tangent (``tangent``) in the outermost transform (level 1,
    on the first forward-AD level) that plain autograd does not record.  In
    (2) the tangents are unwrapped to the plain tensors under them and
    ``compute`` runs with functorch off, so a plain tensor comes back (the
    card's torch 2.11 rewraps an unwrapped tangent at its next op
    otherwise).  The tests hold both paths equal under ``grad``, the jvp of
    a gradient, ``vmap`` of a jvp and ``jacfwd``, on the CPU and the
    card."""
    plain = _plain_inputs(tensors, tangent)
    if plain is None:
        return None
    with torch._C._DisableFuncTorch():
        return compute(plain)


def _sum(plan: SegmentPlan, parts, split=False, padded=False,
         tangent=False):
    out = _plainly(lambda ps: _forward(plan, ps, split), parts, tangent)
    if out is None:
        out = _SegmentSum.apply(_Held((plan, split, padded)), *parts)
    return out


def _gather(x: torch.Tensor, index: tuple, padded: bool, tangent=False):
    out = _plainly(lambda xs: _indexed(xs[0], index, padded), (x,), tangent)
    if out is None:
        out = _PlannedGather.apply(x, _Held((index, padded)))
    return out


def _indexed(x: torch.Tensor, index: tuple, padded: bool):
    """x by each index (one tensor for one index, a tuple for two); with
    ``padded``, an entry x.shape[0] selects a row of zeros."""
    if padded:
        x = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out = tuple(x[i] for i in index)
    return out[0] if len(out) == 1 else out


class _Held:
    """A plan or an index handed through an autograd Function as it is:
    ``torch.func`` wraps every tensor that it finds in a Function's
    arguments (inside tuples and NamedTuples too), and a wrapped index is
    not the tensor that the plan cache knows."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _SegmentSum(torch.autograd.Function):
    # held: (plan, split, padded); padded: the plan's indices may hold n
    # (a padded gather's pullback), whose slots' rows add nothing
    @staticmethod
    def forward(held, *parts):
        plan, split, _ = held.value
        return _forward(plan, parts, split)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.split, ctx.padded = inputs[0].value
        ctx.like = [(p.shape, p.dtype, p.device) for p in inputs[1:]]

    @staticmethod
    def backward(ctx, grad):
        pulled = _gather(grad, ctx.plan.index, ctx.padded)
        return (None, *((pulled,) if len(ctx.plan.index) == 1 else pulled))

    @staticmethod
    def jvp(ctx, _, *tangents):
        tangents = [torch.zeros(s, dtype=dt, device=dv) if t is None else t
                    for t, (s, dt, dv) in zip(tangents, ctx.like)]
        return _sum(ctx.plan, tangents, ctx.split, ctx.padded, tangent=True)

    @staticmethod
    def vmap(info, in_dims, held, *parts):
        # the batch as axis 1 of every part: rows of a wider contribution
        moved = [p.movedim(d, 1) if d is not None
                 else p.unsqueeze(1).expand(p.shape[0], info.batch_size,
                                            *p.shape[1:])
                 for p, d in zip(parts, in_dims[1:])]
        return _SegmentSum.apply(held, *moved), 1


def segment_sum(plan: SegmentPlan, parts, split: bool = False):
    """(n, *trailing): the rows of ``parts`` (one tensor of shape (E_p,
    *trailing) for each part of the plan) added onto their vertices, in the
    plan's fixed order (module docstring).  With ``split`` (two parts),
    each part's rows are added on their own, in the same order, and the two
    sums then added: the pullback of a gather by two indices."""
    if len(parts) != len(plan.index):
        raise ValueError(f"segment_sum: the plan has {len(plan.index)} "
                         f"parts, got {len(parts)}")
    return _sum(plan, parts, split)


# Kernel launches made by this process (the plain version does not count).
segment_sum.launches = 0


class _PlannedGather(torch.autograd.Function):
    # held: (index, padded)
    @staticmethod
    def forward(x, held):
        return _indexed(x, *held.value)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, held = inputs
        (ctx.index, ctx.padded), ctx.like = held.value, (x.shape, x.dtype,
                                                         x.device)

    @staticmethod
    def backward(ctx, *grads):
        # a padded index's padding (entry n) lies past every vertex's run
        (n, *trailing), dtype, dev = ctx.like
        plan = segment_plan(ctx.index, n)
        rows = [torch.zeros((i.numel(), *trailing), dtype=dtype, device=dev)
                if g is None else g.reshape((i.numel(), *trailing))
                for i, g in zip(ctx.index, grads)]
        return _sum(plan, rows, split=True, padded=ctx.padded), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _gather(tangent, ctx.index, ctx.padded, tangent=True)

    @staticmethod
    def vmap(info, in_dims, x, held):
        # the batch as axis 1 of x: each gathered row carries it
        out = _PlannedGather.apply(x.movedim(in_dims[0], 1), held)
        dims = tuple(i.dim() for i in held.value[0])
        return out, (dims[0] if len(dims) == 1 else dims)


def planned_gather(x: torch.Tensor, index, padded: bool = False):
    """``x[index]`` (shape ``index.shape + x.shape[1:]``, the same bits),
    whose pullback is the segment sum of the cotangent over the cached plan
    of ``index`` with ``x.shape[0]`` vertices (module docstring).
    ``index`` is an integer tensor of any shape on ``x``'s device, with
    entries in [0, x.shape[0]); or a pair of them (an edge's two
    endpoints), which gives the pair ``(x[i0], x[i1])`` in one call, its
    pullback one split segment sum over the plan of both (the same bits as
    two gathers' pullbacks added).  With ``padded`` (a padded table), an
    entry may also be x.shape[0]: it selects a row of zeros, and its slots
    lie past every vertex's run of the plan, so its cotangent is never
    read."""
    pair = isinstance(index, (tuple, list))
    index = tuple(index) if pair else (index,)
    if not 1 <= len(index) <= 2:
        raise ValueError(f"planned_gather takes one index or two, got "
                         f"{len(index)}")
    for i in index:
        if i.dtype.is_floating_point or i.dtype.is_complex or \
                i.dtype == torch.bool:
            raise ValueError(f"planned_gather: an integer index, got "
                             f"{i.dtype}")
        if i.device != x.device:
            raise ValueError("planned_gather: x and the index must share "
                             "one device")
    _check_device(x.device, "planned_gather")
    return _gather(x, index, bool(padded))
