"""Scenario (DP) and block-partition (TP-analog) sharding drivers
(counterpart of ``optimization_tpu/parallel/sharding.py``).

**The route: ``DTensor``.**  The placements of the JAX package's
``NamedSharding`` become ``torch.distributed.tensor.DTensor``s on a
``DeviceMesh``: :func:`shard_batch` is ``Shard(0)`` over the batch axis,
:func:`shard_model_vector` ``Shard(-1)`` over the model axis.  As GSPMD
does in JAX, ``DTensor`` turns a sharded reduction into per-rank partial
sums plus an all-reduce, so a solver runs on a sharded iterate unchanged:

- **Block partitioning** (one huge variable over "model"): pass
  ``shard_model_vector(x0, mesh)`` and sharded data to ``tnt.solve``.
  Every inner product and norm of the sphere's projection and retraction
  is all-reduced by ``DTensor``; the solver's scalars come back as plain
  tensors that every rank holds (``core.tree.local_scalar``), and the
  Hessian-vector product is taken by two reverse passes, since forward
  mode has no sharding rules (``RiemannianProblem.hvp``).
- **The LOBPCG basis** is the exception: its Gram stage is the
  ``gram_pair`` kernel, which takes a plain tensor's memory.  A
  row-sharded basis is therefore passed as this rank's local rows to
  ``linalg.lobpcg(..., axis=...)``, whose Gram stage is then
  ``collectives.sharded_gram_pair`` and whose row norms are all-reduced;
  a ``DTensor`` never reaches the kernel.
- **Scenario batching** (a fleet over "batch"): the port's solvers are
  eager loops with host reads, so ``torch.vmap`` of a solve cannot work.
  :func:`batch_sharded_solve` loops the solve over each rank's contiguous
  slice of the batch and all-gathers the stacked results (the solvers'
  traces have a fixed length, so they stack).  ``linalg.lobpcg_fleet(...,
  axis=...)`` is the batched fleet's own counterpart.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ..core.tree import tree_flatten, tree_map
from .collectives import axis_group
from .mesh import BATCH, MODEL, placements

__all__ = ["batch_sharded_solve", "shard_batch", "shard_model_vector",
           "constrain_model"]


def _place(leaf, mesh: DeviceMesh, axis_name: str, last: bool):
    """``leaf`` as a ``DTensor`` split on its first (or last) dimension
    over ``axis_name`` (a 0-d leaf is replicated)."""
    ndim = leaf.dim()
    pspec = ([None] * (ndim - 1) + [axis_name] if last
             else [axis_name] + [None] * (ndim - 1)) if ndim else []
    pl = placements(mesh, pspec, ndim)
    if isinstance(leaf, DTensor):
        return leaf.redistribute(mesh, pl)
    return distribute_tensor(leaf.to(mesh.device_type), mesh, pl,
                             src_data_rank=None)


def shard_batch(tree: Any, mesh: DeviceMesh, axis_name: str = BATCH) -> Any:
    """Shard the leading (batch) axis of every leaf over ``axis_name``.
    Every rank passes the same global value (as JAX's ``device_put`` of a
    host array requires) and keeps its own block: no communication."""
    return tree_map(lambda leaf: _place(leaf, mesh, axis_name, False), tree)


def shard_model_vector(x: Any, mesh: DeviceMesh,
                       axis_name: str = MODEL) -> Any:
    """Shard the *last* axis of each leaf over the model axis (long-vector
    block partitioning)."""
    return tree_map(lambda leaf: _place(leaf, mesh, axis_name, True), x)


def constrain_model(x: Any, mesh: DeviceMesh, axis_name: str = MODEL) -> Any:
    """Keep a long vector block-partitioned over the model axis: a
    ``DTensor`` is redistributed there, a plain tensor distributed (use
    inside user operators to pin intermediate layouts)."""
    return shard_model_vector(x, mesh, axis_name)


def _all_gather_batch(tree: Any, axis) -> Any:
    """Every leaf's per-rank blocks (equal leading sizes) concatenated over
    the axis, in rank order, on every rank."""
    group = axis_group(axis)
    k = dist.get_world_size(group)
    leaves, rebuild = tree_flatten(tree)
    out = []
    for leaf in leaves:
        t = torch.as_tensor(leaf)
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(k)]
        dist.all_gather(parts, wire, group=group)
        out.append(torch.cat(parts).to(t.dtype))
    return rebuild(out)


def batch_sharded_solve(solve_fn: Callable, mesh: DeviceMesh,
                        axis_name: str = BATCH) -> Callable:
    """Run ``solve_fn(x0, data)`` over a leading batch axis with the batch
    split over the mesh's ``axis_name``.  Returns ``run(x0s, datas=None)``:
    the batched inputs (plain tensors that every rank holds, or
    :func:`shard_batch`'s ``DTensor``s) are split into contiguous slices,
    each rank loops ``solve_fn`` over its slice, and the per-instance
    results are stacked and all-gathered, so every rank returns one result
    of JAX's vmapped shape (leading axis B).  B must divide evenly over the
    axis, as JAX's sharding requires."""
    axis = (mesh, axis_name)
    k = mesh.size(mesh.mesh_dim_names.index(axis_name))

    def local(tree):
        sharded = shard_batch(tree, mesh, axis_name)
        return tree_map(lambda leaf: leaf.to_local(), sharded)

    def run(x0s, datas=None):
        B = tree_flatten(x0s)[0][0].shape[0]
        if B % k:
            raise ValueError(f"batch of {B} instances does not divide over "
                             f"the {k} ranks of axis {axis_name!r}")
        x_loc = local(x0s)
        d_loc = local(datas) if datas is not None else None
        results = []
        for i in range(B // k):
            pick = lambda leaf: leaf[i]
            results.append(solve_fn(
                tree_map(pick, x_loc),
                tree_map(pick, d_loc) if d_loc is not None else None))
        leaves = [tree_flatten(r)[0] for r in results]
        _, rebuild = tree_flatten(results[0])
        stacked = rebuild([torch.stack([torch.as_tensor(ls[j])
                                        for ls in leaves])
                           for j in range(len(leaves[0]))])
        return _all_gather_batch(stacked, axis)

    return run
