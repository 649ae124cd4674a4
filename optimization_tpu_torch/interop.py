"""Carry the JAX package's state across to the port, and results back.

The ported problems have no learned weights: their state is the params
(``TNTParams``, ``TNLSParams``, ``GradientDescentParams``,
``ProximalGradientParams``, ``ADMMParams`` and their bases), the initial
point, the data (for the convex solvers A, b, c), and the ``warm_start``
carry of a LOBPCG, proximal-gradient or ADMM solve.
The model data (``RotationSyncData``, ``CompletionData``,
``RangeSyncData``, a g2o ``PoseGraph``) crosses the same way.  These functions carry them without importing JAX (arrays arrive
through numpy's array protocol).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.tree import tree_map
from .core.types import OptimizerParams, SmoothOptimizerParams
from .io.g2o import PoseGraph
from .models.matrix_completion import CompletionData
from .models.range_sync import RangeSyncData
from .models.rotation_sync import RotationSyncData
from .solvers import admm as _admm
from .solvers import proximal_gradient as _pg
from .solvers.gradient_descent import GradientDescentParams
from .solvers.tnls import TNLSParams
from .solvers.tnt import TNTParams

__all__ = ["params_from_jax", "tensor_from_numpy", "result_to_numpy",
           "lobpcg_warm_start_from_jax",
           "proximal_gradient_warm_start_from_jax",
           "admm_warm_start_from_jax", "rotation_sync_data_from_jax",
           "completion_data_from_jax", "pose_graph_from_jax",
           "range_sync_data_from_jax"]

_PARAMS = {cls.__name__: cls
           for cls in (OptimizerParams, SmoothOptimizerParams,
                       GradientDescentParams, TNTParams, TNLSParams,
                       _pg.ProximalGradientParams, _admm.ADMMParams)}
# enum-valued fields are carried by value into the port's enum of that name
_ENUMS = {cls.__name__: cls
          for cls in (_pg.ProximalGradientMode, _admm.ADMMMode,
                      _admm.ADMMPenaltyAdaptation)}


def params_from_jax(p):
    """The port's params dataclass of the same name, field by field."""
    cls = _PARAMS.get(type(p).__name__)
    if cls is None or not dataclasses.is_dataclass(p):
        raise TypeError(f"no port counterpart for {type(p).__name__}")
    port_fields = {f.name for f in dataclasses.fields(cls)}
    values = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    for name, v in values.items():
        if type(v).__name__ in _ENUMS:
            values[name] = _ENUMS[type(v).__name__](v.value)
    if set(values) != port_fields:
        raise TypeError(f"{type(p).__name__}: fields differ from the port's "
                        f"({sorted(set(values) ^ port_fields)})")
    return cls(**values)


def tensor_from_numpy(a, device="cuda", dtype=None) -> torch.Tensor:
    """A tensor from a numpy (or JAX) array, on the card unless ``device``
    says otherwise (``device="cpu"``).  bf16 arrays go through f32, which
    holds every bf16 value exactly, since torch takes no numpy bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def result_to_numpy(res):
    """A result NamedTuple with every tensor leaf as a numpy array (bf16 as
    f32, exactly), for comparison with the JAX package's result."""
    def conv(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(conv, res)


def lobpcg_warm_start_from_jax(ws, device="cuda"):
    """The port's ``warm_start`` from a JAX ``LOBPCGResult.warm_start``
    ``(k, carry)``: every array leaf a tensor on ``device`` (the card
    unless told ``device="cpu"``) of the same
    dtype, the carry's keys kept, an empty ``Useed`` ``()`` kept; so a solve
    started in JAX resumes in the port's ``lobpcg`` or ``lobpcg_fleet``."""
    k, carry = ws
    return (tensor_from_numpy(k, device),
            {key: () if isinstance(v, tuple) else tensor_from_numpy(v, device)
             for key, v in carry.items()})


def proximal_gradient_warm_start_from_jax(ws, device="cuda"):
    """The port's ``warm_start`` from a JAX
    ``ProximalGradientResult.warm_start`` ``(x_prev, y, t_prev, lam)``:
    every array leaf a tensor on ``device`` (the card unless told
    ``device="cpu"``) of the same dtype, so a FISTA run started in JAX
    resumes in the port's ``proximal_gradient.solve`` with its momentum and
    stepsize."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tuple(ws))


def admm_warm_start_from_jax(ws, device="cuda"):
    """The port's ``warm_start`` from a JAX ``ADMMResult.warm_start``
    ``(lam, rho, carry)``: every array leaf a tensor on ``device`` (the
    card unless told ``device="cpu"``) of the same dtype, the carry's keys
    kept.  Resume with ``admm.solve(problem, c, x, carry["y_prev"], ...,
    warm_start=...)``: the loop continues from the plain y, not from the
    ``y_hat`` an accelerated result reports."""
    lam, rho, carry = ws
    conv = lambda a: tensor_from_numpy(a, device)
    return (tree_map(conv, lam), conv(rho),
            {key: tree_map(conv, v) for key, v in carry.items()})


def rotation_sync_data_from_jax(data, device="cuda") -> RotationSyncData:
    """The port's ``RotationSyncData`` from the JAX package's: the edge
    indices as int64, ``Rij`` and ``kappa`` in their dtype, all on
    ``device`` (the card unless told ``device="cpu"``); a ``kappa`` of None
    stays None."""
    idx = lambda a: tensor_from_numpy(a, device, torch.int64)
    return RotationSyncData(
        src=idx(data.src), dst=idx(data.dst),
        Rij=tensor_from_numpy(data.Rij, device),
        kappa=(None if data.kappa is None
               else tensor_from_numpy(data.kappa, device)))


def completion_data_from_jax(data, device="cuda") -> CompletionData:
    """The port's ``CompletionData`` from the JAX package's, every array on
    ``device`` (the card unless told ``device="cpu"``) in its dtype."""
    return CompletionData(*(tensor_from_numpy(a, device) for a in data))


def pose_graph_from_jax(graph) -> PoseGraph:
    """The port's ``PoseGraph`` from the JAX package's (or any object with
    its fields): the arrays as numpy in the loaders' dtypes (int32 indices,
    float64 measurements), ``kappa`` of None kept.  Host arrays, as the
    loaders return them; ``solve_pose_graph`` moves them to its device."""
    f64 = lambda a: np.array(a, dtype=np.float64)
    return PoseGraph(
        n_vertices=int(graph.n_vertices), dim=int(graph.dim),
        src=np.array(graph.src, dtype=np.int32),
        dst=np.array(graph.dst, dtype=np.int32),
        Rij=f64(graph.Rij), tij=f64(graph.tij),
        kappa=None if graph.kappa is None else f64(graph.kappa))


def range_sync_data_from_jax(data, device="cuda") -> RangeSyncData:
    """The port's ``RangeSyncData`` from the JAX package's: the pose and
    range edge indices as int64, the measurements and weights in their
    dtype, all on ``device`` (the card unless told ``device="cpu"``); a
    weight of None stays None."""
    idx = lambda a: tensor_from_numpy(a, device, torch.int64)
    val = lambda a: None if a is None else tensor_from_numpy(a, device)
    return RangeSyncData(
        src=idx(data.src), dst=idx(data.dst), Rij=val(data.Rij),
        tij=val(data.tij), rsrc=idx(data.rsrc), rdst=idx(data.rdst),
        dists=val(data.dists), kappa=val(data.kappa), tau=val(data.tau),
        rho=val(data.rho))
