"""Carry the JAX package's state across to the port, and results back.

The headline problem has no learned weights: its state is the params, the
initial point and the diagonal.  These functions carry them without
importing JAX (arrays arrive through numpy's array protocol).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.tree import tree_map
from .core.types import OptimizerParams, SmoothOptimizerParams
from .solvers.tnt import TNTParams

__all__ = ["params_from_jax", "tensor_from_numpy", "result_to_numpy"]

_PARAMS = {cls.__name__: cls
           for cls in (OptimizerParams, SmoothOptimizerParams, TNTParams)}


def params_from_jax(p):
    """The port's params dataclass of the same name, field by field."""
    cls = _PARAMS.get(type(p).__name__)
    if cls is None or not dataclasses.is_dataclass(p):
        raise TypeError(f"no port counterpart for {type(p).__name__}")
    port_fields = {f.name for f in dataclasses.fields(cls)}
    values = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    if set(values) != port_fields:
        raise TypeError(f"{type(p).__name__}: fields differ from the port's "
                        f"({sorted(set(values) ^ port_fields)})")
    return cls(**values)


def tensor_from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    """A tensor from a numpy (or JAX) array.  bf16 arrays go through f32,
    which holds every bf16 value exactly, since torch takes no numpy bf16."""
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
