"""Edge->vertex accumulation strategies for graph-structured operators
(counterpart of ``optimization_tpu/models/graph.py``).

Every hot operator of the rotation/pose model family reduces per-edge
contributions onto vertices (the adjoint of the edge-incidence gather): the
weighted graph Laplacian, the connection Laplacian.  The strategies, chosen
per problem at construction time from concrete indices (the tables are
built on the host with numpy, as in the JAX package, then moved to the
device):

- ``"scatter"`` — a scatter-add of both sides.
- ``"gather"``  — a padded incidence table: each vertex row lists its (up
  to deg_max) incident entry slots; apply = one dense gather + a sum over
  the slot axis.  Falls back to ``"sort"`` when the padding would read more
  than ``pad_factor`` times the true entry count (a hub vertex).
- ``"sort"``    — entries sorted by vertex once at construction; apply =
  the sum of each vertex's run of sorted contributions.

All agree up to summation order, and each sums in an order fixed by the
indices, so the card repeats its results bit for bit.  ``"scatter"`` and
``"sort"`` are one computation here, the segment sum of
``kernels/segment_sum.py``: its plan sorts the slots by vertex once, on the
indices' device, and every apply adds each vertex's run in that order (on
the card in the kernel ``csrc/segment_sum.cu``, where ``index_add`` would
add with atomics in an order that varies from run to run; on the CPU by
``index_add``, one side after the other, the same order).  The degree of
every model (:func:`vertex_degree`) is such a sum too.  Every gather by a
graph index (an edge's endpoints, a padded table's slots) is
``kernels.segment_sum.planned_gather``: ``x[idx]`` whose pullback is the
segment sum over the cached plan of ``idx``.  So gradients and the jvp of
a gradient (the TNT Hessian-vector product) pass through every method,
add in an order fixed by the indices, and repeat on the card and on the
CPU with any number of threads: the pullback of a plain gather,
``index_put(accumulate=True)``, sorts the indices again at every call on
the card and adds with atomics across CPU threads (``torch.segment_reduce``
has no forward-mode formula).

Indices live on the device as int64: on ``src``'s device when it is a
tensor, else on ``device`` (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.segment_sum import planned_gather, segment_plan, segment_sum

__all__ = ["adjacency_tables", "edge_accumulator", "laplacian_apply",
           "vertex_degree"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _index(a, device) -> torch.Tensor:
    """Indices as an int64 tensor on ``device``, without a host round trip
    for a tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def _index_device(src, device):
    if device is not None:
        return torch.device(device)
    if isinstance(src, torch.Tensor):
        return src.device
    return torch.device("cuda")


def vertex_degree(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(n,) sums of the edge weights ``w`` at both endpoints of each edge
    (the weighted degree), on ``w``'s device."""
    return segment_sum(segment_plan((src, dst), n), (w, w))


def _padded_table(entries_vert: np.ndarray, n: int, n_slots: int):
    """(n, deg_max) table of entry-slot ids per vertex, sentinel ``n_slots``
    for padding (a padded ``planned_gather`` reads it as a row of
    zeros)."""
    order = np.argsort(entries_vert, kind="stable")
    sorted_vert = entries_vert[order]
    counts = np.bincount(entries_vert, minlength=n)
    deg_max = int(counts.max()) if counts.size else 0
    table = np.full((n, max(deg_max, 1)), n_slots, dtype=np.int64)
    # position of each sorted entry within its vertex's run
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(sorted_vert.size, dtype=np.int64) - \
        starts[sorted_vert]
    table[sorted_vert, within] = order
    return table, deg_max


def edge_accumulator(src, dst, n, *, method: str = "scatter",
                     sides=("src", "dst"), pad_factor: float = 8.0,
                     device=None):
    """Build ``acc(a_src, a_dst) -> (n, *trailing)`` summing per-edge
    contributions onto their incident vertices.

    ``a_src``/``a_dst`` are (E, ...) tensors of contributions accumulated
    at ``src[e]`` resp. ``dst[e]`` (pass ``None`` for a side excluded from
    ``sides``; ``"scatter"`` takes both sides and adds nothing for a side
    given ``None``, as JAX's).  Signs and weights are the caller's job.
    ``src``/``dst`` are tensors or arrays of concrete indices; the index
    tables go to ``device`` (default: ``src``'s device, or the card for
    arrays).

    ``method="gather"`` falls back to ``"sort"`` when the padded table
    would read more than ``pad_factor`` times the true entry count.
    """
    dev = _index_device(src, device)
    if method not in ("scatter", "gather", "sort"):
        raise ValueError(f"edge_accumulator: unknown method {method!r} "
                         "(expected 'scatter', 'gather', or 'sort')")
    if method == "scatter":
        sides = ("src", "dst")      # as JAX's: a side given None adds nothing
    index = [i for side, i in (("src", src), ("dst", dst)) if side in sides]

    def sided(a_src, a_dst):
        if method == "scatter" and (a_src is None) != (a_dst is None):
            given = a_src if a_src is not None else a_dst
            a_src, a_dst = (torch.zeros_like(given) if a is None else a
                            for a in (a_src, a_dst))
        chunks = [a for side, a in (("src", a_src), ("dst", a_dst))
                  if side in sides]
        if not chunks or any(c is None for c in chunks):
            raise ValueError(f"edge_accumulator: contributions for sides "
                             f"{tuple(sides)} are required")
        return chunks

    if method == "gather":
        entries_vert = (np.concatenate([_host(i) for i in index])
                        .astype(np.int64) if index
                        else np.zeros((0,), np.int64))
        n_slots = entries_vert.size
        counts = np.bincount(entries_vert, minlength=n)
        deg_max = int(counts.max()) if counts.size else 0
        if n * max(deg_max, 1) > pad_factor * max(n_slots, 1):
            method = "sort"

    if method == "gather":
        table_np, _ = _padded_table(entries_vert, n, n_slots)
        table = torch.as_tensor(table_np, device=dev)

        def acc_gather(a_src, a_dst):
            flat = torch.cat(sided(a_src, a_dst), 0)
            return torch.sum(planned_gather(flat, table, padded=True), dim=1)
        return acc_gather

    plan = segment_plan([_index(i, dev) for i in index], n)

    def acc_sorted(a_src, a_dst):
        return segment_sum(plan, sided(a_src, a_dst))
    return acc_sorted


def adjacency_tables(src, dst, n, device=None):
    """Padded neighbor tables for *adjacency-form* graph operators (one
    neighbor gather + a slot-axis contraction, no scatter and no E-sized
    intermediate).

    Every edge e = (src, dst) yields two directed slots: one at vertex
    ``src[e]`` pointing at ``dst[e]`` and one at ``dst[e]`` pointing at
    ``src[e]``.  Returns ``(nb, eid, fwd, deg_max)``, the tables on
    ``device`` (default: ``src``'s device, or the card for arrays):

    - ``nb``  (n, deg_max) int64 — neighbor vertex id per slot (padding
      points at vertex ``n``: ``planned_gather(z, nb, padded=True)`` reads
      it as a row of zeros);
    - ``eid`` (n, deg_max) int64 — the originating edge id per slot
      (padding = E);
    - ``fwd`` (n, deg_max) bool — True where the slot is the edge's forward
      direction (vertex == src);
    - ``deg_max`` int.

    Self-loops produce two slots at the same vertex (their Laplacian
    contribution cancels exactly, matching the incidence form).
    """
    dev = _index_device(src, device)
    src = _host(src).astype(np.int64)
    dst = _host(dst).astype(np.int64)
    E = src.shape[0]
    vert = np.concatenate([src, dst])
    nbr = np.concatenate([dst, src])
    eid = np.concatenate([np.arange(E), np.arange(E)])
    fwd = np.concatenate([np.ones(E, bool), np.zeros(E, bool)])

    order = np.argsort(vert, kind="stable")
    vert, nbr, eid, fwd = vert[order], nbr[order], eid[order], fwd[order]
    counts = np.bincount(vert, minlength=n)
    deg_max = int(counts.max()) if counts.size else 0
    deg_max = max(deg_max, 1)

    nb_t = np.full((n, deg_max), n, dtype=np.int64)
    eid_t = np.full((n, deg_max), E, dtype=np.int64)
    fwd_t = np.zeros((n, deg_max), dtype=bool)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(vert.size, dtype=np.int64) - starts[vert]
    nb_t[vert, within] = nbr
    eid_t[vert, within] = eid
    fwd_t[vert, within] = fwd
    return (torch.as_tensor(nb_t, device=dev),
            torch.as_tensor(eid_t, device=dev),
            torch.as_tensor(fwd_t, device=dev), deg_max)


def laplacian_apply(src, dst, tau, n, *, method: str = "scatter"):
    """Build ``L(z) -> (n, k)`` applying the weighted graph Laplacian
    L = A' diag(tau) A (A = edge incidence) to vertex fields, on ``tau``'s
    device.

    ``method`` in {"scatter", "gather", "sort"} routes the incidence
    adjoint through :func:`edge_accumulator`; ``"adjacency"`` uses the dense
    padded-neighbor form  L z = deg*z - sum_s w_s z[nb_s].
    """
    dev = tau.device
    src_t, dst_t = _index(src, dev), _index(dst, dev)
    deg = vertex_degree(src_t, dst_t, tau, n)

    if method == "adjacency":
        nb, eid, _, _ = adjacency_tables(src, dst, n, device=dev)
        w_slots = planned_gather(tau, eid, padded=True)

        def L_adj(z):
            return deg[:, None] * z - torch.sum(
                w_slots[:, :, None] * planned_gather(z, nb, padded=True),
                dim=1)
        return L_adj

    acc = edge_accumulator(src, dst, n, method=method, device=dev)

    def L(z):
        z_src, z_dst = planned_gather(z, (src_t, dst_t))
        dz = tau[:, None] * (z_dst - z_src)
        return acc(-dz, dz)
    return L
