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
tier, through ``RiemannianProblem.flat_solve``, optionally with a folded
elementwise preconditioner) or the flat pair engine (bf16 tier, through
``flat_qm``; ``flat_prec`` folds a preconditioner), and dtype escalation
(``solvers.tnt.solve_escalated``); the Euclidean entry points
``euclidean_tnt`` (generic STPCG, with ``fused_dots=True`` on the fused
reduction kernels of ``csrc/fused.cu``), ``euclidean_gradient_descent`` and
``euclidean_tnls`` (least squares: ``linalg.lsqr``, ``solvers.tnls``,
``LeastSquaresProblem``); the eigensolvers ``linalg.lobpcg`` /
``linalg.lobpcg_fleet`` (their Gram stage in the ``gram_pair`` kernel of
``csrc/fused.cu``) and ``linalg.jacobi_eigh``; the convex solvers ``solvers.prox`` (six proximal
operators), ``solvers.proximal_gradient`` (ISTA / FISTA on a
``CompositeProblem``) and ``solvers.admm`` (simple, accelerated, residual
balancing); the host-chunked drivers ``driver.drive`` (gradient descent,
TNT, TNLS, proximal gradient) / ``drive_admm`` / ``drive_lobpcg`` /
``drive_lobpcg_fleet`` on the ``Stopwatch`` clock; the matrix manifolds
(``manifolds.stiefel`` / ``rotations`` / ``grassmann`` / ``product``) and
the models ``models.graph``, ``models.rotation_sync`` (spectral init,
TNT, the SE-Sync certificate and staircase) and
``models.matrix_completion``; and the probe kernels
``kernels.pinned_stream`` / ``kernels.resident_body`` /
``kernels.chunk_reader`` (``csrc/probes.cu``; ``probe_pinned_stream.py``,
``probe_resident_body.py`` and ``probe_graph_stream.py`` at the
repository root time them).
"""

from . import core, kernels, linalg, manifolds, solvers
from .core import driver
from .core.host import Stopwatch
from .core.problem import (CompositeProblem, LeastSquaresProblem,
                           RiemannianProblem)
from .core.types import (ADMMStatus, GradientDescentStatus,
                         ProximalGradientStatus, TNLSStatus, TNTStatus)
from .solvers.euclidean import (euclidean_gradient_descent, euclidean_tnls,
                                euclidean_tnt)

__version__ = "0.1.0"
