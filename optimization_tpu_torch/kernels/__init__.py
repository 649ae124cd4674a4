"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`streamed_cg` — the whole-loop trust-region CG
  (``stpcg_flat_streamed``, with its preconditioned variant: a
  ``JacobiPower`` or stored P), CUDA C++ in ``csrc/streamed_cg.cu``;
  replaces the Pallas kernel
  ``optimization_tpu/kernels/streamed_cg.py:_mk_kernel``.
- :mod:`fused` — ``cg_dots``, ``axpy_selfdot``, ``gram_pair``,
  ``diag_stencil_matvec``, ``stream3_probe`` and ``affine_stencil_matvec``,
  CUDA C++ in ``csrc/fused.cu``; replace the Pallas kernels of the same
  names in ``optimization_tpu/kernels/fused.py`` (all six of them).
  ``gram_pair`` is the LOBPCG Gram stage (``linalg/lobpcg.py``),
  ``stream3_probe`` the measured bandwidth ceiling of ``chip_smoke.py``.

The three Pallas probe harnesses of the JAX package's ``benchmarks/`` are
not ported (see ROADMAP.md, Queue 2).
"""

from .streamed_cg import (AffineDiagonal, JacobiPower, ScaledDiagonal,
                          ShiftedDiagonal, sphere_rayleigh_streamed,
                          stpcg_flat_streamed, stpcg_flat_streamed_reference)
from .fused import (GRAM_MAX_K, affine_stencil_matvec,
                    affine_stencil_matvec_reference, axpy_selfdot,
                    axpy_selfdot_reference, cg_dots, cg_dots_reference,
                    diag_stencil_matvec, diag_stencil_matvec_reference,
                    gram_pair, gram_pair_reference, stream3_probe,
                    stream3_probe_reference)

__all__ = ["AffineDiagonal", "JacobiPower", "ScaledDiagonal",
           "ShiftedDiagonal",
           "sphere_rayleigh_streamed", "stpcg_flat_streamed",
           "stpcg_flat_streamed_reference", "affine_stencil_matvec",
           "affine_stencil_matvec_reference", "axpy_selfdot",
           "axpy_selfdot_reference", "cg_dots", "cg_dots_reference",
           "diag_stencil_matvec", "diag_stencil_matvec_reference",
           "GRAM_MAX_K", "gram_pair", "gram_pair_reference", "stream3_probe",
           "stream3_probe_reference"]
