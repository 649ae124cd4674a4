"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`streamed_cg` — the whole-loop trust-region CG
  (``stpcg_flat_streamed``) for A0 + U B U' of any rank k (k <= 4 on the
  card) with generated, stored or wrapped-callable (``ElementwiseFn``)
  terms, and its preconditioned variant (a ``JacobiPower`` on A0, a stored
  or a wrapped P), CUDA C++ in ``csrc/streamed_cg.cu``; replaces the Pallas
  kernel ``optimization_tpu/kernels/streamed_cg.py:_mk_kernel``.
- :mod:`fused` — ``cg_dots``, ``axpy_selfdot``, ``gram_pair``,
  ``diag_stencil_matvec``, ``stream3_probe`` and ``affine_stencil_matvec``,
  CUDA C++ in ``csrc/fused.cu``; replace the Pallas kernels of the same
  names in ``optimization_tpu/kernels/fused.py`` (all six of them).
  ``gram_pair`` is the LOBPCG Gram stage (``linalg/lobpcg.py``),
  ``stream3_probe`` the measured bandwidth ceiling of ``chip_smoke.py``.

- :mod:`probes` — ``pinned_stream``, ``resident_body`` and
  ``chunk_reader``, CUDA C++ in ``csrc/probes.cu``; replace the Pallas
  kernels of the JAX package's ``benchmarks/probe_pallas_stream.py`` and
  ``benchmarks/probe_resident_kernel.py`` (``mk_pallas``: the two
  measurements behind the streamed CG kernel's residency design) and
  ``benchmarks/probe_graph_stream.py`` (``mk_chunk_reader``: the chunked
  gather behind the graph operators' verdict).
"""

from .streamed_cg import (KERNEL_MAX_K, AffineDiagonal, ElementwiseFn,
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

__all__ = ["AffineDiagonal", "ElementwiseFn", "JacobiPower", "PrecMap",
           "ScaledDiagonal", "ShiftedDiagonal", "prec_map", "stored_prec_map",
           "KERNEL_MAX_K",
           "sphere_rayleigh_streamed", "stpcg_flat_streamed",
           "stpcg_flat_streamed_reference", "affine_stencil_matvec",
           "affine_stencil_matvec_reference", "axpy_selfdot",
           "axpy_selfdot_reference", "cg_dots", "cg_dots_reference",
           "diag_stencil_matvec", "diag_stencil_matvec_reference",
           "gram_pair", "gram_pair_reference", "stream3_probe",
           "stream3_probe_reference", "pinned_stream",
           "pinned_stream_reference", "resident_body",
           "resident_body_reference", "chunk_reader",
           "chunk_reader_reference", "chunk_offsets"]
