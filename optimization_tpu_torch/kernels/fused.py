"""Fused reductions and the stencil operator: Hopper kernels and their plain
versions.

Counterpart of ``optimization_tpu/kernels/fused.py``, all six of its
kernels:

- :func:`cg_dots` — ``(<p,Hp>, <Hp,Hp>, <p,p>, <p,r>)`` in one read of
  (p, Hp, r): the STPCG per-iteration reductions (``fused_dots=True``);
- :func:`axpy_selfdot` — ``out = alpha*x + y`` and ``<out,out>`` in one
  pass: the STPCG residual update and its norm;
- :func:`diag_stencil_matvec` / :func:`affine_stencil_matvec` —
  ``scale*(diag(d) + 2I - S - S')v`` with S the unit shift, d stored or
  ``d_i = a + b*i``: the matrix-free SPD operator;
- :func:`stream3_probe` — ``(d + 2)*v*scale``: the stencil's read-read-write
  stream with no stencil work, the measured bandwidth ceiling;
- :func:`gram_pair` — ``(S'AS, S'BS)`` from (m, k) blocks, or a fleet of
  them (F, m, k), on the tensor cores (S read once when ``BS`` is ``S``):
  the LOBPCG Gram stage; its kernel is ``csrc/gram_pair.cu`` (TMA and
  ``wgmma``), and :func:`gram_plan` is its launch plan.

Each wrapper takes a tensor on the CPU to its plain PyTorch version
(``*_reference``), the function the CPU tests hold against the JAX kernels,
and a tensor on a CUDA device to the hand-written kernel of
``csrc/fused.cu`` or ``csrc/gram_pair.cu`` (f32 or bf16 storage; any
other dtype raises).  It never
falls back.  Each kernel launch adds one to the wrapper's ``launches``.

The plain versions keep the JAX package's contracts:

- ``cg_dots`` casts its inputs to f32, sums in f32, and returns the four
  sums cast to ``p.dtype``: under float64 the dots are f32-accurate, as in
  the JAX package (``fused.py:76-82, 112``);
- ``axpy_selfdot`` computes ``out`` in ``x.dtype`` with ``alpha`` cast to
  ``x.dtype``, and the norm in f32 cast to ``x.dtype``;
- the stencils and ``stream3_probe`` compute in ``v.dtype``; the affine
  diagonal is built in f32 (``f32(b) * f32(i) + f32(a)``, the kernel's
  order) whatever ``v.dtype``;
- ``gram_pair`` casts its inputs to f32 and returns f32 Grams with f32
  products and sums: under float64 they are f32-accurate, as in the JAX
  package (``fused.py:172-176, 211-212``).

The elementwise kernels compute in f32 and round once on store: in f32 that
equals the plain versions' results bit for bit, in bf16 the plain versions
round after every operation (the JAX contract) and differ by a few bf16
ulps.  The TPU-only knobs and helpers (``block_rows``, ``on_tpu``, the
``_boundaries`` halo arrays, the (8, 128) padding) have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .streamed_cg import AffineDiagonal, _aligned

__all__ = ["cg_dots", "cg_dots_reference", "axpy_selfdot",
           "axpy_selfdot_reference", "diag_stencil_matvec",
           "diag_stencil_matvec_reference", "affine_stencil_matvec",
           "affine_stencil_matvec_reference", "stream3_probe",
           "stream3_probe_reference", "gram_pair", "gram_pair_reference",
           "gram_plan", "GramPlan"]

_STORAGE = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def cg_dots_reference(p: torch.Tensor, Hp: torch.Tensor, r: torch.Tensor):
    """``(<p,Hp>, <Hp,Hp>, <p,p>, <p,r>)``: f32 products and sums, cast to
    ``p.dtype``."""
    f32 = torch.float32
    p32, hp32, r32 = p.to(f32), Hp.to(f32), r.to(f32)
    o = torch.stack([torch.sum(p32 * hp32), torch.sum(hp32 * hp32),
                     torch.sum(p32 * p32), torch.sum(p32 * r32)]).to(p.dtype)
    return o[0], o[1], o[2], o[3]


def axpy_selfdot_reference(alpha, x: torch.Tensor, y: torch.Tensor):
    """``(alpha*x + y, <out,out>)``: out in ``x.dtype``, the norm summed in
    f32 and cast to ``x.dtype``."""
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    out = (a * x + y).to(x.dtype)
    o32 = out.to(torch.float32)
    return out, torch.sum(o32 * o32).to(x.dtype)


def _stencil_reference(d: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    z = v.new_zeros(1)
    up = torch.cat([v[1:], z])         # v[i+1], 0 past the end
    down = torch.cat([z, v[:-1]])      # v[i-1], 0 before the start
    return ((d.to(v.dtype) + 2.0) * v - up - down) * scale


def diag_stencil_matvec_reference(d: torch.Tensor, v: torch.Tensor, *,
                                  scale: float = 1.0) -> torch.Tensor:
    """``scale*((d + 2)*v - v[i+1] - v[i-1])`` in ``v.dtype``."""
    return _stencil_reference(d, v, scale)


def affine_stencil_matvec_reference(v: torch.Tensor, *, a: float, b: float,
                                    scale: float = 1.0) -> torch.Tensor:
    """:func:`diag_stencil_matvec_reference` with ``d_i = a + b*i`` built in
    f32."""
    d = AffineDiagonal(a, b).values(v.shape[0], v.device)
    return _stencil_reference(d, v, scale)


def stream3_probe_reference(d: torch.Tensor, v: torch.Tensor, *,
                            scale: float = 1.0) -> torch.Tensor:
    """``((d + 2)*v)*scale`` in ``v.dtype``."""
    return (d.to(v.dtype) + 2.0) * v * scale


def gram_pair_reference(S: torch.Tensor, AS: torch.Tensor, BS: torch.Tensor):
    """``(S'AS, S'BS)`` in f32 from f32 casts of the inputs: (m, k) blocks
    give (k, k) Grams, (F, m, k) fleets (F, k, k)."""
    S32 = S.to(torch.float32).mT
    return S32 @ AS.to(torch.float32), S32 @ BS.to(torch.float32)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..csrc.build import load

    lib = load("fused")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
        lib.fused_grid.argtypes = [i32, i64, ctypes.POINTER(i32)]
        lib.fused_grid.restype = i32
        lib.fused_error_string.argtypes = [i32]
        lib.fused_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.fused_error_string
        lib.fused_cg_dots.argtypes = [i32, vp, vp, vp, i64, i32, vp, vp, vp]
        lib.fused_cg_dots.restype = i32
        lib.fused_axpy_selfdot.argtypes = [i32, vp, vp, vp, vp, i64, i32, vp,
                                           vp, vp]
        lib.fused_axpy_selfdot.restype = i32
        lib.fused_stencil.argtypes = [i32, vp, vp, vp, i64, f, f, f, i32, vp]
        lib.fused_stencil.restype = i32
        lib.fused_stream3.argtypes = [i32, vp, vp, vp, i64, f, i32, vp]
        lib.fused_stream3.restype = i32
        lib._argtypes_set = True
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _on_card(name: str, *ts: torch.Tensor) -> bool:
    """Validate flat vectors of one shape on one device; True for CUDA
    tensors (the kernel), False for CPU tensors (the plain version)."""
    t0 = ts[0]
    if any(t.dim() != 1 or t.shape != t0.shape for t in ts):
        raise ValueError(f"{name}: inputs must be flat (n,) tensors of one "
                         f"shape")
    if any(t.device != t0.device for t in ts):
        raise ValueError(f"{name}: inputs must be on one device")
    if t0.device.type == "cpu":
        return False
    if t0.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors (the kernel) or CPU "
                         f"tensors (the plain version), not "
                         f"{t0.device.type}")
    if t0.dtype not in _STORAGE or any(t.dtype != t0.dtype for t in ts):
        raise ValueError(f"{name}: the kernel takes f32 or bf16 storage, one "
                         f"dtype for all vectors (got "
                         f"{[str(t.dtype) for t in ts]})")
    return True


def _launch_setup(t: torch.Tensor):
    """(lib, bf16 flag, grid, stream handle) for a launch over t."""
    lib = _lib()
    bf16 = int(t.dtype == torch.bfloat16)
    grid = ctypes.c_int(0)
    _raise_on(lib, lib.fused_grid(bf16, t.shape[0], ctypes.byref(grid)),
              "fused_grid")
    return lib, bf16, grid.value, torch.cuda.current_stream(t.device).cuda_stream


def cg_dots(p: torch.Tensor, Hp: torch.Tensor, r: torch.Tensor):
    """``(<p,Hp>, <Hp,Hp>, <p,p>, <p,r>)`` in one pass over (p, Hp, r), as
    four 0-d tensors of ``p.dtype`` on p's device (nothing is read back).
    Accumulation is f32."""
    if not _on_card("cg_dots", p, Hp, r):
        return cg_dots_reference(p, Hp, r)
    p, Hp, r = _aligned(p), _aligned(Hp), _aligned(r)
    with torch.cuda.device(p.device):
        lib, bf16, grid, stream = _launch_setup(p)
        part = torch.empty(4 * grid, dtype=torch.float64, device=p.device)
        out = torch.empty(4, dtype=torch.float32, device=p.device)
        _raise_on(lib, lib.fused_cg_dots(
            bf16, p.data_ptr(), Hp.data_ptr(), r.data_ptr(), p.shape[0], grid,
            part.data_ptr(), out.data_ptr(), stream), "cg_dots launch")
    cg_dots.launches += 1
    o = out.to(p.dtype)
    return o[0], o[1], o[2], o[3]


def axpy_selfdot(alpha, x: torch.Tensor, y: torch.Tensor):
    """``out = alpha*x + y`` and ``<out, out>`` in one pass.  ``alpha`` may
    be a 0-d tensor on the card (the kernel reads it there: no host sync)
    or a number.  Returns ``(out, dot)`` with ``out`` in ``x.dtype`` and
    ``dot`` a 0-d ``x.dtype`` tensor."""
    if not _on_card("axpy_selfdot", x, y):
        return axpy_selfdot_reference(alpha, x, y)
    x, y = _aligned(x), _aligned(y)
    # alpha rounded to x.dtype, as the plain version does, then held in f32
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    a = a.to(torch.float32).reshape(1).contiguous()
    with torch.cuda.device(x.device):
        lib, bf16, grid, stream = _launch_setup(x)
        part = torch.empty(grid, dtype=torch.float64, device=x.device)
        out = torch.empty_like(x)
        dot = torch.empty(1, dtype=torch.float32, device=x.device)
        _raise_on(lib, lib.fused_axpy_selfdot(
            bf16, a.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            x.shape[0], grid, part.data_ptr(), dot.data_ptr(), stream),
            "axpy_selfdot launch")
    axpy_selfdot.launches += 1
    return out, dot.reshape(()).to(x.dtype)


def _stencil(d, v, a: float, b: float, scale: float) -> torch.Tensor:
    v = _aligned(v)
    d = _aligned(d) if d is not None else None
    with torch.cuda.device(v.device):
        lib, bf16, grid, stream = _launch_setup(v)
        out = torch.empty_like(v)
        _raise_on(lib, lib.fused_stencil(
            bf16, d.data_ptr() if d is not None else None, v.data_ptr(),
            out.data_ptr(), v.shape[0], a, b, scale, grid, stream),
            "stencil launch")
    return out


def diag_stencil_matvec(d: torch.Tensor, v: torch.Tensor, *,
                        scale: float = 1.0) -> torch.Tensor:
    """``scale * (diag(d) + 2 I - S - S') v`` in one pass (reads d and v,
    writes the product: 3n words)."""
    if not _on_card("diag_stencil_matvec", d, v):
        return diag_stencil_matvec_reference(d, v, scale=scale)
    out = _stencil(d, v, 0.0, 0.0, float(scale))
    diag_stencil_matvec.launches += 1
    return out


def affine_stencil_matvec(v: torch.Tensor, *, a: float, b: float,
                          scale: float = 1.0) -> torch.Tensor:
    """``scale * (diag(a + b*i) + 2 I - S - S') v``, the diagonal generated
    from the index (reads v, writes the product: 2n words)."""
    if not _on_card("affine_stencil_matvec", v):
        return affine_stencil_matvec_reference(v, a=a, b=b, scale=scale)
    out = _stencil(None, v, float(a), float(b), float(scale))
    affine_stencil_matvec.launches += 1
    return out


def stream3_probe(d: torch.Tensor, v: torch.Tensor, *,
                  scale: float = 1.0) -> torch.Tensor:
    """``(d + 2)*v*scale`` in one pass: reads d and v, writes the product
    (3n words, the stored stencil's stream with no stencil work), so its
    bandwidth is the ceiling the streaming kernels are measured against."""
    if not _on_card("stream3_probe", d, v):
        return stream3_probe_reference(d, v, scale=scale)
    d, v = _aligned(d), _aligned(v)
    with torch.cuda.device(v.device):
        lib, bf16, grid, stream = _launch_setup(v)
        out = torch.empty_like(v)
        _raise_on(lib, lib.fused_stream3(
            bf16, d.data_ptr(), v.data_ptr(), out.data_ptr(), v.shape[0],
            float(scale), grid, stream), "stream3_probe launch")
    stream3_probe.launches += 1
    return out


def _gram_on_card(S: torch.Tensor, AS: torch.Tensor, BS: torch.Tensor) -> bool:
    """Validate (m, k) or (F, m, k) blocks of one shape on one device; True
    for CUDA tensors (the kernel), False for CPU tensors (the plain
    version)."""
    if S.dim() not in (2, 3) or AS.shape != S.shape or BS.shape != S.shape:
        raise ValueError(f"gram_pair: S, AS, BS must be (m, k) or (F, m, k) "
                         f"blocks of one shape (got {tuple(S.shape)}, "
                         f"{tuple(AS.shape)}, {tuple(BS.shape)})")
    if AS.device != S.device or BS.device != S.device:
        raise ValueError("gram_pair: inputs must be on one device")
    if S.device.type == "cpu":
        return False
    if S.device.type != "cuda":
        raise ValueError(f"gram_pair runs on CUDA tensors (the kernel) or CPU "
                         f"tensors (the plain version), not {S.device.type}")
    if S.dtype not in _STORAGE or AS.dtype != S.dtype or BS.dtype != S.dtype:
        raise ValueError(f"gram_pair: the kernel takes f32 or bf16 storage, "
                         f"one dtype for all blocks (got {S.dtype}, "
                         f"{AS.dtype}, {BS.dtype})")
    if S.numel() == 0:
        raise ValueError(f"gram_pair: the kernel takes a non-empty block "
                         f"(got {tuple(S.shape)})")
    return True


# ---- gram_pair's launch plan (csrc/gram_pair.cu:make_plan, the same) ----

SMEM_CAP = 232_448       # a block's opt-in shared memory on the H100
_SLACK, _BAR_BYTES, _MAX_STAGES, _NP_MAX = 1024, 256, 8, 128
_SPAN = 144              # route "rows": a row's landing slot (bytes)


class GramPlan(NamedTuple):
    """How ``csrc/gram_pair.cu`` runs one call (the C side's ``GramPlan``
    field for field, then ``grid``)."""

    route: str      # "tma2d": row tiles by 2-D tensor map; "span": a tile's
    #                 rows of each array by one bulk copy; "rows": each
    #                 row's box by a bulk copy (rows not 16-byte aligned)
    box_cols: int   # columns of a 128-byte box: 32 f32, 64 bf16
    slabs: int      # 64-column M slabs of AS and of BS
    chunks: int     # N chunks of S's columns
    np: int         # columns of a chunk (a multiple of 16, <= 128)
    panels: int     # slabs x chunks blocks a row stream
    cluster: int    # blocks a cluster
    rows: int       # rows of a staged tile
    stages: int     # the ring's depth
    boxes: int      # 128-byte boxes a stage
    reuse: bool     # S's chunk is the BS slab (BS is S, one panel)
    smem: int       # dynamic shared memory bytes
    grid: int       # row streams per instance (one wave of the card)


ROUTES = ("tma2d", "span", "rows")


def _landing(route, boxes, size, k, same, rows):
    """Bytes a stage lands before the consumers lay them out ("span": each
    array's rows and 32 bytes for its ends; "rows": 144 bytes a row and
    box), in whole KiB."""
    if route == "span":
        b = (2 if same else 3) * (-(-(rows * k * size + 32) // 16) * 16)
    elif route == "rows":
        b = boxes * rows * _SPAN
    else:
        b = 0
    return -(-b // 1024) * 1024


def _fit(route, boxes, np_, bf16, k, same):
    """(rows, stages, smem): the longest tile of 128, 64, 32 rows that
    leaves three stages, f32's four transposed chunks beside the ring."""
    size = 2 if bf16 else 4
    budget = SMEM_CAP - _SLACK - _BAR_BYTES
    for rows in (128, 64, 32):
        stage = boxes * rows * 128 + _landing(route, boxes, size, k, same,
                                              rows)
        trans = 0 if bf16 else 4 * np_ * rows * 4
        stages = min(_MAX_STAGES, (budget - trans) // stage)
        smem = _SLACK + _BAR_BYTES + stages * stage + trans
        if stages >= 3:
            break
    return rows, stages, smem


def gram_plan(m: int, k: int, dtype, same: bool, fleet: int = 1, *,
              aligned: bool = True, sms: int = 132,
              blocks_per_sm: int = 1) -> GramPlan:
    """The launch plan of ``gram_pair`` on the card for (F, m, k) blocks of
    ``dtype`` (f32 or bf16), ``same`` when BS is S, ``aligned`` when the
    three bases are 16-byte aligned; ``sms`` and ``blocks_per_sm`` (the
    kernel's occupancy) set the row streams.

    Output: (2k x k, transposed) in ``slabs`` x ``chunks`` panels of 2
    slabs of 64 X columns (one a warpgroup) by ``np`` S columns, one block
    each.  A row tile of ``rows`` rows lands in a stage of ``boxes``
    128-byte boxes a row: AS's slab, BS's (S's when BS is S), S's chunk
    unless that is BS's slab.  Rows not 16-byte aligned land unswizzled
    first ("span", or "rows" where a span leaves fewer than two stages).
    See :func:`_fit` for the tile and the ring."""
    if k < 1 or m < 1 or fleet < 1:
        raise ValueError(f"gram_plan: m, k, fleet must be >= 1 (got {m}, "
                         f"{k}, {fleet})")
    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    route = "tma2d" if aligned and (k * size) % 16 == 0 else "span"
    box_cols = 128 // size
    slabs = -(-k // 64)
    chunks = -(-k // _NP_MAX)
    per = -(-k // chunks)               # S columns a chunk
    np_ = -(-per // 16) * 16
    panels = slabs * chunks
    reuse = bool(same) and panels == 1
    boxes = 2 * (64 // box_cols) + (0 if reuse else -(-np_ // box_cols))
    rows, stages, smem = _fit(route, boxes, np_, bf16, k, same)
    if route == "span" and stages < 2:
        route = "rows"
        rows, stages, smem = _fit(route, boxes, np_, bf16, k, same)
    tiles = -(-m // rows)
    grid = max(1, min(tiles, sms * blocks_per_sm // (fleet * panels)))
    return GramPlan(route, box_cols, slabs, chunks, np_, panels, 1, rows,
                    stages, boxes, reuse, smem, grid)


def _gram_lib() -> ctypes.CDLL:
    from ..csrc.build import load

    lib = load("gram_pair")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gram_pair_error_string.argtypes = [i32]
        lib.gram_pair_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.gram_pair_error_string
        lib.gram_pair_plan.argtypes = [i32, i32, i64, i32, i32, i32,
                                       ctypes.POINTER(i32)]
        lib.gram_pair_plan.restype = i32
        lib.gram_pair_geometry.argtypes = [i32, i32, i64, i32, i32, i32,
                                           ctypes.POINTER(i32)]
        lib.gram_pair_geometry.restype = i32
        lib.gram_pair_run.argtypes = [i32, vp, vp, vp, i32, i64, i32, i32,
                                      i32, vp, vp, vp]
        lib.gram_pair_run.restype = i32
        lib._argtypes_set = True
    return lib


def card_gram_plan(m: int, k: int, dtype, same: bool, fleet: int = 1, *,
                   aligned: bool = True, device=None) -> GramPlan:
    """The C side's plan of the same call, on the current card (its SM
    count and the kernel's occupancy set ``grid``)."""
    with torch.cuda.device(device):
        lib = _gram_lib()
        out = (ctypes.c_int * 13)()
        _raise_on(lib, lib.gram_pair_plan(
            int(dtype == torch.bfloat16), fleet, m, k, int(same),
            int(aligned), out), "gram_pair_plan")
    v = list(out)
    return GramPlan(ROUTES[v[0]], *v[1:10], bool(v[10]), *v[11:])


@functools.lru_cache(maxsize=None)
def _gram_geometry(device: int, bf16: int, fleet: int, m: int, k: int,
                   same: int, aligned: int) -> int:
    """Row streams per instance of a gram_pair launch: one wave over the
    fleet's panels, from the card's SM count and the kernel's occupancy,
    asked once per shape (which also opts the kernel in to its shared
    memory)."""
    lib = _gram_lib()
    grid = ctypes.c_int(0)
    _raise_on(lib, lib.gram_pair_geometry(
        bf16, fleet, m, k, same, aligned, ctypes.byref(grid)),
        "gram_pair_geometry")
    return grid.value


def gram_pair(S: torch.Tensor, AS: torch.Tensor, BS: torch.Tensor):
    """``(S'AS, S'BS)``: (m, k) blocks give two (k, k) f32 Grams, a fleet
    (F, m, k) two (F, k, k), in one launch sequence.  On the card, f32
    storage takes 3xTF32 tensor-core products (f32-accurate) and bf16
    storage exact bf16 products, both summed in f32; the blocks' partial
    sums are added in a fixed order, so a repeat is bitwise.  ``BS`` may be
    ``S`` itself, and S is then read once.  Any k: above 64 columns the
    kernel computes the Grams in panels (``csrc/gram_pair.cu``,
    :func:`gram_plan`), with the same summation order."""
    if not _gram_on_card(S, AS, BS):
        return gram_pair_reference(S, AS, BS)
    same = int(BS.data_ptr() == S.data_ptr() and BS.stride() == S.stride())
    single = S.dim() == 2
    S3, AS3, BS3 = (t.contiguous() if t.dim() == 3 else
                    t.contiguous().unsqueeze(0) for t in (S, AS, BS))
    fleet, m, k = S3.shape
    bf16 = int(S.dtype == torch.bfloat16)
    with torch.cuda.device(S.device):
        lib = _gram_lib()
        aligned = int((S3.data_ptr() | AS3.data_ptr() | BS3.data_ptr()) % 16
                      == 0)
        grid = _gram_geometry(S.device.index, bf16, fleet, m, k, same,
                              aligned)
        part = torch.empty(fleet * grid * 2 * k * k, dtype=torch.float32,
                           device=S.device)
        out = torch.empty((fleet, 2, k, k), dtype=torch.float32,
                          device=S.device)
        stream = torch.cuda.current_stream(S.device).cuda_stream
        _raise_on(lib, lib.gram_pair_run(
            bf16, S3.data_ptr(), AS3.data_ptr(), BS3.data_ptr(), fleet, m, k,
            same, grid, part.data_ptr(), out.data_ptr(), stream),
            "gram_pair launch")
    gram_pair.launches += 1
    if single:
        return out[0, 0], out[0, 1]
    return out[:, 0], out[:, 1]


# Kernel launches made by this process (the plain versions do not count).
cg_dots.launches = 0
axpy_selfdot.launches = 0
diag_stencil_matvec.launches = 0
affine_stencil_matvec.launches = 0
stream3_probe.launches = 0
gram_pair.launches = 0
