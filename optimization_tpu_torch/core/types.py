"""Core parameter / result / status vocabulary shared by every solver.

PyTorch counterpart of ``optimization_tpu/core/types.py``: frozen
dataclasses with the reference's field names, defaults and ``validate()``
messages (``Base/Concepts.h:42-88``, ``Riemannian/Concepts.h:116-148``),
and int status enums (``TNT.h:134-164`` and siblings).  Per-iteration
traces are fixed-length tensors, NaN-filled beyond ``num_iterations``,
so results compare entry for entry with the JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple

import torch

__all__ = [
    "OptimizerParams",
    "SmoothOptimizerParams",
    "GradientDescentStatus",
    "TNTStatus",
    "TNLSStatus",
    "ProximalGradientStatus",
    "ADMMStatus",
    "ADMMIterationType",
    "SolveInfo",
    "RUNNING",
]

# Status value meaning "no stopping criterion has fired yet".  Every
# per-solver enum reserves 0 for it.
RUNNING = 0


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    """Basic configuration common to all iterative optimizers
    (reference ``Base/Concepts.h:42-60``: same fields, same defaults)."""

    max_iterations: int = 100
    max_computation_time: float = math.inf
    log_iterates: bool = False
    verbose: bool = False
    precision: int = 3

    def validate(self) -> None:
        if self.max_iterations < 0:
            raise ValueError("max_iterations must be a nonnegative integer")
        if self.max_computation_time < 0:
            raise ValueError(
                "Maximum computation time must be a nonnegative real value")


@dataclasses.dataclass(frozen=True)
class SmoothOptimizerParams(OptimizerParams):
    """Configuration for smooth optimizers (reference
    ``Riemannian/Concepts.h:116-131``)."""

    gradient_tolerance: float = 1e-6
    relative_decrease_tolerance: float = 1e-6
    stepsize_tolerance: float = 1e-6

    def validate(self) -> None:
        super().validate()
        if self.gradient_tolerance < 0:
            raise ValueError("Gradient tolerance must be a nonnegative real value")
        if self.relative_decrease_tolerance < 0:
            raise ValueError(
                "Relative decrease tolerance must be a nonnegative real value")
        if self.stepsize_tolerance < 0:
            raise ValueError("Stepsize tolerance must be a nonnegative real value")


class GradientDescentStatus(enum.IntEnum):
    """Termination statuses for gradient descent (ref ``GradientDescent.h:62-85``)."""

    RUNNING = 0
    GRADIENT = 1
    RELATIVE_DECREASE = 2
    STEPSIZE = 3
    LINE_SEARCH = 4
    ITERATION_LIMIT = 5
    ELAPSED_TIME = 6
    USER_FUNCTION = 7


class TNTStatus(enum.IntEnum):
    """Termination statuses for TNT (ref ``TNT.h:134-164``)."""

    RUNNING = 0
    GRADIENT = 1
    PRECONDITIONED_GRADIENT = 2
    RELATIVE_DECREASE = 3
    STEPSIZE = 4
    TRUST_REGION = 5
    ITERATION_LIMIT = 6
    ELAPSED_TIME = 7
    USER_FUNCTION = 8


class TNLSStatus(enum.IntEnum):
    """Termination statuses for TNLS (ref ``TNLS.h:171-204``)."""

    RUNNING = 0
    ROOT = 1
    GRADIENT = 2
    RELATIVE_DECREASE = 3
    STEPSIZE = 4
    TRUST_REGION = 5
    ITERATION_LIMIT = 6
    ELAPSED_TIME = 7
    USER_FUNCTION = 8


class ProximalGradientStatus(enum.IntEnum):
    """Termination statuses for proximal gradient (ref ``ProximalGradient.h:103-108``)."""

    RUNNING = 0
    PROX_GRAD_RESIDUAL = 1
    ITERATION_LIMIT = 2
    LINESEARCH = 3
    ELAPSED_TIME = 4
    USER_FUNCTION = 5


class ADMMStatus(enum.IntEnum):
    """Termination statuses for ADMM (ref ``ADMM.h:186-198``)."""

    RUNNING = 0
    RESIDUAL_TOLERANCE = 1
    ITERATION_LIMIT = 2
    ELAPSED_TIME = 3
    USER_FUNCTION = 4


class ADMMIterationType(enum.IntEnum):
    """Per-iteration classification for ADMM (ref ``ADMM.h:200-212``)."""

    ACCELERATED = 0
    STANDARD = 1
    RESTART = 2


class SolveInfo(NamedTuple):
    """Host-side metadata attached to results by the chunked drivers."""

    elapsed_time: float
    chunks: int


def trace_fill(n: int, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """A trace buffer of length ``n``: NaN-filled by the result contract
    (entries beyond ``num_iterations`` are unread), zero-filled under the
    OPTTPU_DEBUG_NANS sanitizer tier (core/debug.py)."""
    from .debug import pad_value
    return torch.full((n,), pad_value(), dtype=dtype, device=device)
