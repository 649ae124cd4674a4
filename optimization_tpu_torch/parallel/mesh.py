"""Device meshes and axis-name conventions (counterpart of
``optimization_tpu/parallel/mesh.py``).

Two canonical mesh axes, as in the JAX package:

- ``BATCH`` ("batch"): scenario/data parallelism — independent problem
  instances spread over the ranks; no cross-instance communication.
- ``MODEL`` ("model"): block partitioning of one huge variable; inner
  products and operator applications become per-rank work plus an
  all-reduce over this axis.

**The semantic gap.**  A JAX mesh is devices, driven by one program in one
process (per host).  A torch mesh (``torch.distributed.device_mesh
.DeviceMesh``) is *ranks*: one process per device, every process running
the same program on its own shard.  So a mesh of k devices needs k
processes in one process group: start them with ``torchrun`` or spawn
them, and call :func:`initialize_distributed` once in each.  A single
process asking for a mesh of one device gets a world of one on first use
(an in-memory store: no port, no file).

Backends: a ``"cuda"`` mesh is served by NCCL, a ``"cpu"`` mesh by gloo;
the mesh's device type chooses, and a CUDA mesh on a machine without a
card raises (there is no fallback to gloo or to the CPU).  Meshes are on
``"cuda"`` unless ``"cpu"`` is asked for.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..core.tree import tree_map

BATCH = "batch"
MODEL = "model"

__all__ = ["BATCH", "MODEL", "make_mesh", "batch_mesh", "model_mesh",
           "initialize_distributed"]


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh needs a CUDA device and there is none: ask for "
                "a CPU mesh (device_type='cpu') to run on gloo")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                     f"{device_type!r}")


def initialize_distributed(*, coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda", **kwargs) -> None:
    """Multi-process entry point: ``torch.distributed.init_process_group``
    with JAX's argument names.  ``coordinator_address="host:port"`` becomes
    ``init_method="tcp://host:port"``, ``num_processes`` the world size and
    ``process_id`` the rank; any other keyword (``init_method``,
    ``store``, ``timeout``, ...) passes through.  With none of them the
    group reads torchrun's environment (``env://``).

    The backend is NCCL for ``device_type="cuda"`` (each rank then takes
    the card ``rank % device_count``) and gloo for ``"cpu"``.  A no-op when
    a group is already initialized, as JAX's is.
    """
    if dist.is_initialized():
        return
    backend = _backend(device_type)
    if coordinator_address is not None:
        kwargs.setdefault("init_method", f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend, **kwargs)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = (BATCH, MODEL),
              devices: str = "cuda") -> DeviceMesh:
    """Build a mesh of the given logical shape over (a prefix of) the
    ranks.  ``devices`` is the device type of the ranks, ``"cuda"``
    (default) or ``"cpu"``.  A process with no group and a mesh of one
    device gets a world of one first."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if not dist.is_initialized() and n == 1:
        initialize_distributed(store=dist.HashStore(), world_size=1, rank=0,
                               device_type=devices)
    _backend(devices)
    have = _world_size()
    if have < n:
        raise ValueError(
            f"Mesh of shape {shape} needs {n} devices, have {have}")
    return DeviceMesh(devices, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def batch_mesh(n_devices: Optional[int] = None,
               devices: str = "cuda") -> DeviceMesh:
    """1-D mesh over the batch axis (pure scenario parallelism)."""
    n = n_devices if n_devices is not None else _world_size()
    return make_mesh((n,), (BATCH,), devices)


def model_mesh(n_devices: Optional[int] = None,
               devices: str = "cuda") -> DeviceMesh:
    """1-D mesh over the model axis (block-partitioned vectors)."""
    n = n_devices if n_devices is not None else _world_size()
    return make_mesh((n,), (MODEL,), devices)


def spec(*names) -> tuple:
    """A partition spec, as JAX's ``PartitionSpec``: per tensor dimension
    the mesh axis name it is split over, or None (replicated)."""
    return tuple(names)


def placements(mesh: DeviceMesh, pspec: Sequence, ndim: int) -> list:
    """The ``DTensor`` placements (one per mesh dimension) of a partition
    spec for a tensor of ``ndim`` dimensions: ``Shard(i)`` on the mesh
    dimension named at tensor dimension i, ``Replicate()`` elsewhere."""
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for i, name in enumerate(pspec):
        if name is not None:
            out[mesh.mesh_dim_names.index(name)] = Shard(i % max(ndim, 1))
    return out


def shard(tree, mesh: DeviceMesh, pspec: Sequence):
    """Place every leaf of a pytree as a ``DTensor`` with one partition
    spec (JAX's ``device_put`` with a uniform ``NamedSharding``).  Every
    rank passes the same global value and keeps its own block."""
    return tree_map(lambda leaf: distribute_tensor(
        leaf.to(mesh.device_type), mesh,
        placements(mesh, pspec, leaf.dim()), src_data_rank=None), tree)
