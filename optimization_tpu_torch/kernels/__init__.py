"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`streamed_cg` — the whole-loop trust-region CG
  (``stpcg_flat_streamed``) for A0 + U B U' of any rank k with generated,
  stored or wrapped-callable (``ElementwiseFn``) terms, and its
  preconditioned variant (a ``JacobiPower`` on A0, a stored or a wrapped
  P), CUDA C++ in ``csrc/streamed_cg.cu`` (k = 1-4) and
  ``csrc/streamed_cg_any.cu`` (k >= 5); replaces the Pallas kernel
  ``optimization_tpu/kernels/streamed_cg.py:_mk_kernel``.
- :mod:`fused` — ``cg_dots``, ``axpy_selfdot``, ``gram_pair``,
  ``diag_stencil_matvec``, ``stream3_probe`` and ``affine_stencil_matvec``,
  CUDA C++ in ``csrc/fused.cu`` (``gram_pair`` in ``csrc/gram_pair.cu``:
  TMA and ``wgmma``, its launch plan ``fused.gram_plan``); replace the
  Pallas kernels of the same names in
  ``optimization_tpu/kernels/fused.py`` (all six of them).
  ``gram_pair`` is the LOBPCG Gram stage (``linalg/lobpcg.py``),
  ``stream3_probe`` the measured bandwidth ceiling of ``chip_smoke.py``.

- :mod:`probes` — ``pinned_stream``, ``resident_body`` and
  ``chunk_reader``, CUDA C++ in ``csrc/probes.cu``; replace the Pallas
  kernels of the JAX package's ``benchmarks/probe_pallas_stream.py`` and
  ``benchmarks/probe_resident_kernel.py`` (``mk_pallas``: the two
  measurements behind the streamed CG kernel's residency design) and
  ``benchmarks/probe_graph_stream.py`` (``mk_chunk_reader``: the chunked
  gather behind the graph operators' verdict).
- :mod:`sphere_step` — ``sphere_step``, the sphere Rayleigh quotient's
  TNT trial step and the flat engine's init dot group at its output
  (``sphere_step.sphere_rayleigh_step``, the headline's ``step_eval``,
  sends a call there when its ``A_elem`` is a ``DiagonalElem``, and every
  other call to ``linalg.flat_cg.sphere_rayleigh_step``), CUDA C++ in
  ``csrc/sphere_step.cu``:
  two passes over x and h where the eager evaluator makes ~80.  It
  replaces no Pallas kernel (the JAX package leaves the trial step to XLA).
- :mod:`segment_sum` — ``segment_sum`` over a ``segment_plan``, CUDA C++
  in ``csrc/segment_sum.cu``: the edge->vertex sums of the graph models
  (``models/graph.py``) in an order fixed by the indices, and the pullback
  of ``planned_gather``, the models' gather by a graph index.  It replaces no
  Pallas kernel (the JAX package's ``.at[].add`` / ``segment_sum``, which
  XLA lowers).
"""

from .streamed_cg import (AffineDiagonal, ElementwiseFn,
                          JacobiPower, PrecMap, ScaledDiagonal,
                          ShiftedDiagonal, prec_map, sphere_rayleigh_streamed,
                          stored_prec_map, stpcg_flat_streamed,
                          stpcg_flat_streamed_reference)
from .fused import (affine_stencil_matvec,
                    affine_stencil_matvec_reference, axpy_selfdot,
                    axpy_selfdot_reference, cg_dots, cg_dots_reference,
                    diag_stencil_matvec, diag_stencil_matvec_reference,
                    gram_pair, gram_pair_reference, stream3_probe,
                    stream3_probe_reference)
from .probes import (chunk_offsets, chunk_reader, chunk_reader_reference,
                     pinned_stream, pinned_stream_reference, resident_body,
                     resident_body_reference)
from .segment_sum import (SegmentPlan, planned_gather, segment_plan,
                          segment_sum, segment_sum_reference)
from .sphere_step import DiagonalElem, sphere_step, sphere_step_reference

__all__ = ["AffineDiagonal", "ElementwiseFn", "JacobiPower", "PrecMap",
           "ScaledDiagonal", "ShiftedDiagonal", "prec_map", "stored_prec_map",
           "sphere_rayleigh_streamed", "stpcg_flat_streamed",
           "stpcg_flat_streamed_reference", "affine_stencil_matvec",
           "affine_stencil_matvec_reference", "axpy_selfdot",
           "axpy_selfdot_reference", "cg_dots", "cg_dots_reference",
           "diag_stencil_matvec", "diag_stencil_matvec_reference",
           "gram_pair", "gram_pair_reference", "stream3_probe",
           "stream3_probe_reference", "pinned_stream",
           "pinned_stream_reference", "resident_body",
           "resident_body_reference", "chunk_reader",
           "chunk_reader_reference", "chunk_offsets", "SegmentPlan",
           "planned_gather", "segment_plan", "segment_sum",
           "segment_sum_reference", "DiagonalElem", "sphere_step",
           "sphere_step_reference"]
