"""Named reduction primitives: the distributed seam of every solver
(counterpart of ``optimization_tpu/parallel/collectives.py``).

The reference's algorithms communicate only through injected inner
products, operator applications and Gram-matrix formation; these are the
points that become collectives over a mesh.  In the JAX package they are
``psum``s inside ``shard_map``; here each rank holds its local shard as a
plain tensor and each primitive is ``torch.distributed`` over the process
group of one mesh axis.

``axis`` names that mesh axis: a 1-D ``DeviceMesh``, a ``(DeviceMesh,
axis name)`` pair, or a ``ProcessGroup``.  Every rank of the axis must make
the same calls in the same order.  Results are new tensors (the inputs are
not reduced in place).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.tree import tree_dot, tree_map

__all__ = ["pdot", "pnorm", "pmean_tree", "sharded_inner", "psum_scalar",
           "sharded_gram", "sharded_gram_pair", "ring_gram"]


def axis_group(axis):
    """The process group of a mesh axis (see the module docstring)."""
    if isinstance(axis, DeviceMesh):
        return axis.get_group()
    if isinstance(axis, tuple):
        mesh, name = axis
        return mesh.get_group(name)
    return axis


def psum_scalar(x, axis) -> torch.Tensor:
    """The sum over the axis of every rank's ``x`` (any shape)."""
    out = torch.as_tensor(x).clone()
    dist.all_reduce(out, group=axis_group(axis))
    return out


def pdot(u: Any, v: Any, axis) -> torch.Tensor:
    """Distributed inner product: local pytree dot + all-reduce over
    ``axis``."""
    return psum_scalar(tree_dot(u, v), axis)


def pnorm(u: Any, axis) -> torch.Tensor:
    return torch.sqrt(pdot(u, u, axis))


def pmean_tree(tree: Any, axis) -> Any:
    """Leafwise mean over the axis: the consensus-averaging primitive."""
    k = dist.get_world_size(axis_group(axis))
    return tree_map(lambda leaf: psum_scalar(leaf, axis) / k, tree)


def sharded_gram(S_local: torch.Tensor, AS_local: torch.Tensor,
                 axis) -> torch.Tensor:
    """Distributed Gram matrix ``S' AS`` for a basis row-sharded over
    ``axis`` (the LOBPCG Gram stage, reference ``LOBPCG.h:271-272``): each
    rank forms its local (k x k) product with ``torch.matmul`` in the
    basis's dtype (no TF32 unless the caller turned it on), then one small
    all-reduce."""
    return psum_scalar(S_local.mT @ AS_local, axis)


def sharded_gram_pair(S_local, AS_local, BS_local, axis):
    """``(S'AS, S'BS)`` with one all-reduce of both Grams over ``axis``.
    The local pair is LOBPCG's Gram stage (``linalg.lobpcg._gram``): the
    ``gram_pair`` kernel for f32/bf16 storage on the card (its plain
    version on the CPU), ``torch.matmul`` for f64."""
    # imported here: linalg.lobpcg imports this module for sharded bases
    from ..linalg.lobpcg import _gram

    ga, gb = _gram(S_local, AS_local, BS_local)
    both = torch.stack((ga, gb))
    dist.all_reduce(both, group=axis_group(axis))
    return both[0], both[1]


def ring_gram(S_local: torch.Tensor, AS_local: torch.Tensor,
              axis) -> torch.Tensor:
    """Distributed Gram matrix ``S' AS`` for a basis COLUMN-blocked over
    ``axis``: each rank holds its (m, nx/k) column blocks of S and AS; the
    S block travels around the ring (``batch_isend_irecv`` to the next
    rank, from the previous one) while each rank accumulates its output
    column block ``S' AS_local``.  Returns the LOCAL output column block,
    shape (nx, nx/k): rank d's is ``G[:, d c:(d+1) c]``.

    As the JAX docstring adjudicates, row-sharding dominates at every
    feasible shape; this is the tested completeness of the ring design,
    not a production path.  Per rank the ring moves (k-1) messages of
    m nx/k words, about m nx words per Gram, where :func:`sharded_gram`'s
    one all-reduce moves about nx^2; LOBPCG bases have m >> nx, so the
    ring pays about m/nx times more communication.  Column blocking buys
    no memory either: a column block (m, nx/k) holds as many words as a
    row shard (m/k, nx).
    """
    group = axis_group(axis)
    k = dist.get_world_size(group)
    idx = dist.get_rank(group)
    c = S_local.shape[1]
    nxt = dist.get_global_rank(group, (idx + 1) % k)
    prv = dist.get_global_rank(group, (idx - 1) % k)
    blk = S_local.new_zeros((k * c, c))
    S_rot = S_local.contiguous()
    for t in range(k):
        owner = (idx - t) % k            # whose column block we hold
        blk[owner * c:(owner + 1) * c] = S_rot.mT @ AS_local
        if t < k - 1:
            recv = torch.empty_like(S_rot)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, S_rot, nxt, group),
                    dist.P2POp(dist.irecv, recv, prv, group)]):
                req.wait()
            S_rot = recv
    return blk


def sharded_inner(axis) -> Callable[[Any, Any, Any], torch.Tensor]:
    """A manifold-metric-shaped inner product (x, u, v) -> scalar that
    reduces across ``axis``: inject into a Manifold for solves on local
    shards."""

    def inner(x, u, v):
        return pdot(u, v, axis)

    return inner
