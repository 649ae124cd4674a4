"""The edge->vertex segment sum of the graph models (``models/graph.py``):
a kernel for Hopper beside its plain version.

A plan (:func:`segment_plan`) holds the vertex ids of one or two parts of
per-edge contributions (a source and a target side) and, built once on
their device, the slots of both parts sorted stably by vertex and each
vertex's run.  :func:`segment_sum` adds every part's rows onto their
vertices: ``out[v] = sum of part_p[e] over (p, e) with index_p[e] = v``,
part 0 before part 1 and each in index order.  That order is fixed by the
indices, so the card repeats its results bit for bit, and it is the order
of the plain version (``index_add`` of one part after the other), so the
kernel and the plain version on the CPU give the same bits.

It replaces no Pallas kernel.  The JAX package sums with ``.at[].add`` and
``segment_sum`` (``optimization_tpu/models/graph.py:84-86, 135``); on the
card ``index_add`` adds with atomics in an order that varies from run to
run, and ``index_put(accumulate=True)`` sorts the indices again at every
call.

On a CUDA tensor :func:`segment_sum` launches ``csrc/segment_sum.cu``
(counted in ``.launches``; f32 and f64) or raises; on a CPU tensor it runs
:func:`segment_sum_reference`.  It is differentiable both ways: the
pullback is a gather of the output's cotangent by each part's indices, the
tangent the same segment sum of the parts' tangents (so the jvp of a
gradient, the TNT Hessian-vector product, passes), and ``torch.func.vmap``
moves the batch into the rows.  Indices lie in [0, n).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch

__all__ = ["SegmentPlan", "segment_plan", "segment_sum",
           "segment_sum_reference"]


class SegmentPlan(NamedTuple):
    index: tuple             # each part's (E_p,) int64 vertex ids
    order: torch.Tensor      # (sum E_p,) slots sorted stably by vertex
    starts: torch.Tensor     # (n + 1,) int64: v's run [starts[v], starts[v+1])
    n: int


def segment_plan(index: Sequence[torch.Tensor], n: int) -> SegmentPlan:
    """The plan of one or two parts with vertex ids ``index`` (tensors on one
    device), built there: a stable sort of the slots (part 0's slots first)
    and each vertex's run bounds.  No host round trip."""
    index = tuple(i.to(torch.int64) for i in index)
    if not 1 <= len(index) <= 2:
        raise ValueError(f"segment_plan takes one or two parts, got "
                         f"{len(index)}")
    verts = torch.cat(index) if len(index) == 2 else index[0]
    order = torch.argsort(verts, stable=True)
    starts = torch.searchsorted(
        verts[order], torch.arange(n + 1, device=verts.device))
    return SegmentPlan(index=index, order=order, starts=starts, n=int(n))


def segment_sum_reference(plan: SegmentPlan, parts) -> torch.Tensor:
    """The plain PyTorch version of :func:`segment_sum`: ``index_add`` of
    one part after the other onto zeros."""
    out = parts[0].new_zeros((plan.n,) + tuple(parts[0].shape[1:]))
    for idx, part in zip(plan.index, parts):
        out = out.index_add(0, idx, part)
    return out


def _lib() -> ctypes.CDLL:
    from ..csrc.build import load

    lib = load("segment_sum")
    if not getattr(lib, "_argtypes_set", False):
        vp, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        for fn in (lib.segment_sum_f32, lib.segment_sum_f64):
            fn.argtypes = [vp, vp, i64, vp, vp, i64, i64, vp, vp]
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _launch(plan: SegmentPlan, parts) -> torch.Tensor:
    dev, dtype = parts[0].device, parts[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment_sum's kernel takes f32 or f64, got {dtype}")
    trailing = tuple(parts[0].shape[1:])
    width = math.prod(trailing)
    if plan.n * width == 0:
        return torch.zeros((plan.n,) + trailing, dtype=dtype, device=dev)
    rows = [p.reshape(p.shape[0], width).contiguous() for p in parts]
    out = torch.empty((plan.n,) + trailing, dtype=dtype, device=dev)
    lib = _lib()
    fn = lib.segment_sum_f32 if dtype == torch.float32 else lib.segment_sum_f64
    with torch.cuda.device(dev):
        code = fn(rows[0].data_ptr(),
                  rows[1].data_ptr() if len(rows) == 2 else None,
                  rows[0].shape[0], plan.order.data_ptr(),
                  plan.starts.data_ptr(), plan.n, width,
                  out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {code} "
                           f"({lib.segment_sum_error_string(code).decode()})")
    segment_sum.launches += 1
    return out


def _forward(plan: SegmentPlan, parts) -> torch.Tensor:
    dev = parts[0].device
    for i, p in zip(plan.index, parts):
        if p.device != dev or i.device != dev or p.dtype != parts[0].dtype:
            raise ValueError("segment_sum: parts and plan must share one "
                             "device and the parts one dtype")
        if p.shape[0] != i.shape[0] or p.shape[1:] != parts[0].shape[1:]:
            raise ValueError(f"segment_sum: a part of shape "
                             f"{tuple(p.shape)} for {i.shape[0]} indices")
    if dev.type == "cpu":
        return segment_sum_reference(plan, parts)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on CUDA tensors (the kernel) or "
                         f"CPU tensors (the plain version), not {dev.type}")
    return _launch(plan, parts)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(plan, *parts):
        return _forward(plan, parts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[0]
        ctx.like = [(p.shape, p.dtype, p.device) for p in inputs[1:]]

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad[i] for i in ctx.plan.index))

    @staticmethod
    def jvp(ctx, _, *tangents):
        tangents = [torch.zeros(s, dtype=dt, device=dv) if t is None else t
                    for t, (s, dt, dv) in zip(tangents, ctx.like)]
        return _SegmentSum.apply(ctx.plan, *tangents)

    @staticmethod
    def vmap(info, in_dims, plan, *parts):
        # the batch as axis 1 of every part: rows of a wider contribution
        moved = [p.movedim(d, 1) if d is not None
                 else p.unsqueeze(1).expand(p.shape[0], info.batch_size,
                                            *p.shape[1:])
                 for p, d in zip(parts, in_dims[1:])]
        return _SegmentSum.apply(plan, *moved), 1


def segment_sum(plan: SegmentPlan, parts) -> torch.Tensor:
    """(n, *trailing): the rows of ``parts`` (one tensor of shape (E_p,
    *trailing) for each part of the plan) added onto their vertices, in the
    plan's fixed order (module docstring)."""
    if len(parts) != len(plan.index):
        raise ValueError(f"segment_sum: the plan has {len(plan.index)} "
                         f"parts, got {len(parts)}")
    return _SegmentSum.apply(plan, *parts)


# Kernel launches made by this process (the plain version does not count).
segment_sum.launches = 0
