"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`streamed_cg` — the whole-loop trust-region CG
  (``stpcg_flat_streamed``), CUDA C++ in ``csrc/streamed_cg.cu``; replaces
  the Pallas kernel ``optimization_tpu/kernels/streamed_cg.py:_mk_kernel``.

The JAX package's ``kernels/fused.py`` kernels are not ported yet (see
ROADMAP.md, Queue 2).
"""

from .streamed_cg import (AffineDiagonal, ScaledDiagonal, ShiftedDiagonal,
                          sphere_rayleigh_streamed, stpcg_flat_streamed,
                          stpcg_flat_streamed_reference)

__all__ = ["AffineDiagonal", "ScaledDiagonal", "ShiftedDiagonal",
           "sphere_rayleigh_streamed", "stpcg_flat_streamed",
           "stpcg_flat_streamed_reference"]
