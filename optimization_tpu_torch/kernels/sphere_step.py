"""The sphere Rayleigh quotient's TNT trial step: the Hopper kernel, its
plain version and the evaluator that routes between them.

One call evaluates ``linalg.flat_cg.sphere_rayleigh_step``'s trial step for
f(x) = <x, A x> on S^(n-1), A = diag(a): from x and the step h, the
retracted point x_prop, f_prop, the Riemannian gradient g, |g| and the
``SphereStepAux`` carry (the trial Rayleigh quotient and, with
``with_init``, the flat engine's pre-loop dot group ``FlatCGInit`` at
(x_prop, g)).  It replaces no Pallas kernel (the JAX package leaves the
trial step to XLA).

- On a CUDA tensor, :func:`sphere_step` launches ``csrc/sphere_step.cu``:
  one persistent cooperative launch, two passes over x and h, every scalar
  in one small f32 buffer on the card (the returned scalars are its
  views); nothing is read back and nothing is sent from the host but the
  launch's arguments.  It raises on what the kernel does not take; it never
  falls back.
- On a CPU tensor it runs :func:`sphere_step_reference`, the plain
  PyTorch evaluator ``linalg.flat_cg.sphere_rayleigh_step``.

The diagonal comes with its descriptor: a :class:`DiagonalElem` is the
elementwise operator ``v -> a * v.to(float32)`` that the plain version
applies, and carries ``diag``, an ``AffineDiagonal(c, b)``, which the
kernel regenerates as f32(c) + f32(b) * f32(i), bit for bit its
``values``.  :func:`sphere_rayleigh_step` is the ``step_eval`` that the
headline problem uses: it sends a call here when its ``A_elem`` is a
``DiagonalElem`` and the iterate a CUDA f32 or bf16 tensor
(:func:`on_kernel`), and every other call to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..core.profiling import annotate
from ..linalg import flat_cg
from ..linalg.flat_cg import FlatCGInit, SphereStepAux
from .streamed_cg import AffineDiagonal, _aligned

__all__ = ["DiagonalElem", "on_kernel", "sphere_rayleigh_step",
           "sphere_step", "sphere_step_reference"]

_STORAGE = (torch.float32, torch.bfloat16)
# csrc/sphere_step.cu: the scalar outputs (enum Out) and the doubles of
# scratch a block (kN1 + kN2)
_N_OUT = 15
_PARTIALS = 13


class DiagonalElem:
    """The elementwise operator v -> a .* v, evaluated in f32, of the
    diagonal ``diag`` (an :class:`AffineDiagonal`); ``a`` holds its values
    on ``device``."""

    def __init__(self, diag: AffineDiagonal, n: int, device):
        self.diag = diag
        self.a = diag.values(n, device)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.a * v.to(torch.float32)


def _refusal(A_elem, x, h) -> Optional[str]:
    """Why the kernel does not take the call, or None if it does."""
    if not isinstance(A_elem, DiagonalElem):
        return ("A_elem must be a DiagonalElem (the kernel reads its "
                "diagonal's descriptor)")
    if x.dtype not in _STORAGE or h.dtype != x.dtype:
        return (f"x and h must share an f32 or bf16 dtype, not {x.dtype} "
                f"and {h.dtype}")
    if x.device.type != "cuda":
        return (f"the kernel runs on CUDA tensors, not {x.device.type} "
                f"(the plain version takes CPU tensors)")
    return None


def on_kernel(A_elem, x, h) -> bool:
    """Whether :func:`sphere_rayleigh_step` sends a call to the kernel: a
    CUDA iterate in f32 or bf16, h of its dtype, and a
    :class:`DiagonalElem`."""
    return _refusal(A_elem, x, h) is None


def sphere_step_reference(x, h, A_elem, with_init: bool = True):
    """The plain version: one call of the eager evaluator
    ``linalg.flat_cg.sphere_rayleigh_step``."""
    return flat_cg.sphere_rayleigh_step(A_elem, with_init)(x, h, None)


def sphere_rayleigh_step(A_elem, with_init: bool = True):
    """``linalg.flat_cg.sphere_rayleigh_step``'s ``step_eval`` (same
    signature, same outputs up to reduction order) that takes the kernel
    where it can.  Call by call: a CUDA iterate in f32 or bf16, with h of
    its dtype, and a :class:`DiagonalElem` ``A_elem`` launch
    :func:`sphere_step`; every other call (a CPU tensor, an opaque
    ``A_elem`` callable, float64) runs the plain evaluator."""
    plain = flat_cg.sphere_rayleigh_step(A_elem, with_init)

    def step_eval(x, h, data):
        if on_kernel(A_elem, x, h):
            return sphere_step(x, h, A_elem, with_init)
        return plain(x, h, data)

    return step_eval


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ..csrc.build import load

    lib = load("sphere_step")
    vp, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
    lib.sphere_step_error_string.argtypes = [i32]
    lib.sphere_step_error_string.restype = ctypes.c_char_p
    lib.sphere_step_capacity.argtypes = [i32, ctypes.POINTER(i32)]
    lib.sphere_step_launch.argtypes = [i32, vp, vp, f, f, vp, vp, vp, vp,
                                       i32, i64, vp]
    return lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _lib().sphere_step_error_string(code).decode()
        raise RuntimeError(f"sphere_step {what} failed: CUDA error {code} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def _capacity(index: int, bf16: int) -> int:
    """Co-resident blocks of the dtype's instance on card ``index``."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().sphere_step_capacity(bf16, ctypes.byref(blocks)),
                  "occupancy query")
    return blocks.value


def _check(x, h, A_elem) -> None:
    why = _refusal(A_elem, x, h)
    if why is not None:
        raise ValueError(f"sphere_step: {why}")
    if x.dim() != 1 or h.shape != x.shape or h.device != x.device:
        raise ValueError(f"sphere_step: x and h must be (n,) vectors on one "
                         f"device, not {tuple(x.shape)} on {x.device} and "
                         f"{tuple(h.shape)} on {h.device}")


def sphere_step(x: torch.Tensor, h: torch.Tensor, A_elem: DiagonalElem,
                with_init: bool = True):
    """The trial step at x + h (module docstring): ``(x_prop, f_prop, g,
    |g|, SphereStepAux)``, x_prop and g in x's dtype, the scalars f32.  With
    ``with_init=False`` the carry holds no init group and |g| comes from
    the identity 4 |a u|^2 / n2 - rq^2 (the plain version's); the kernel's
    work is the same.

    On a CPU tensor this runs :func:`sphere_step_reference`; on a CUDA
    tensor it launches the kernel (counted in ``sphere_step.launches``)
    inside the span ``sphere_step.launch`` (``core.profiling.annotate``).
    """
    if x.device.type == "cpu":
        return sphere_step_reference(x, h, A_elem, with_init)
    with annotate("sphere_step.launch"):
        _check(x, h, A_elem)
        dev = x.device
        x, h = _aligned(x), _aligned(h)
        bf16 = int(x.dtype == torch.bfloat16)
        cap = _capacity(dev.index, bf16)
        diag = A_elem.diag
        xp = torch.empty_like(x)
        g = torch.empty_like(x)
        out = torch.empty(_N_OUT, dtype=torch.float32, device=dev)
        partial = torch.empty(cap * _PARTIALS, dtype=torch.float64,
                              device=dev)
        with torch.cuda.device(dev):
            code = _lib().sphere_step_launch(
                bf16, x.data_ptr(), h.data_ptr(), diag.c, diag.b,
                xp.data_ptr(), g.data_ptr(), out.data_ptr(),
                partial.data_ptr(), cap, x.shape[0],
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(code, "launch")
    sphere_step.launches += 1
    f_prop, rq, gn, gn_no_init, rv, ar, nr = out[:7].unbind()
    if not with_init:
        return xp, f_prop, g, gn_no_init, SphereStepAux(rq=rq, init=None)
    init = FlatCGInit(rv=rv, ar=ar, nr=nr, m=out[7:9], mA=out[9:11],
                      UU=out[11:15].view(2, 2))
    return xp, f_prop, g, gn, SphereStepAux(rq=rq, init=init)


# Kernel launches made by this process (the plain version does not count).
sphere_step.launches = 0
