"""optimization_tpu_torch — the PyTorch / CUDA port of ``optimization_tpu``.

A second package beside the JAX one, with the same module layout and
public names (``core/``, ``manifolds/``, ``linalg/``, ``kernels/``,
``solvers/``), so each counterpart sits at the same path.  It imports
``torch`` and never ``jax``; the JAX package is the reference its tests
hold it against.  Loops are eager Python loops, params are frozen
dataclasses with the reference's names and defaults, results are
NamedTuples with NaN-padded traces, statuses are int enums.

The port so far covers the headline path (``headline.py``): Riemannian TNT
minimizing the Rayleigh quotient on the sphere, with the trust-region
subproblem in the hand-written CUDA kernel ``csrc/streamed_cg.cu`` (f32
tier, through ``RiemannianProblem.flat_solve``) or the flat pair engine
(bf16 tier, through ``flat_qm``).
"""

from . import core, kernels, linalg, manifolds, solvers
from .core.problem import RiemannianProblem
from .core.types import (ADMMStatus, GradientDescentStatus,
                         ProximalGradientStatus, TNLSStatus, TNTStatus)

__version__ = "0.1.0"
