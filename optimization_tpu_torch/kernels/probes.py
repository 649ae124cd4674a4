"""The probe kernels for Hopper, each beside its plain version: the two
CG-body residency probes and the graph probe's chunk reader.

Counterparts of the Pallas kernels of the JAX package's
``benchmarks/probe_pallas_stream.py`` (``mk_pallas``: x pinned on chip, r, p
and optionally s streamed in place) and ``benchmarks/probe_resident_kernel.py``
(``mk_pallas``: x, r and p all on chip, no device-memory traffic in the
loop).  They are the measurements behind the streamed CG kernel's design:
is it worth keeping the loop-invariant x, or the loop's own r and p, on chip
across CG iterations, instead of streaming everything every iteration as
``csrc/streamed_cg.cu`` does?

- :func:`pinned_stream` — K iterations of ``a = 1e-12 acc; pn = -r + a p;
  rn = r + a (d .* pn) + a^2 x; [sn = s + a pn;] acc = sum rn^2 +
  sum x .* rn`` with ``d(i) = 1 + 999 i / (n - 1)`` regenerated from the
  index and acc starting at 1; f32 vectors of any length n >= 2.
- :func:`resident_body` — K iterations of the streamed kernel's chunk body
  (``a0 = 2a - rq`` regenerated, ``u1 = 2a x``, the p and r updates, the six
  dots) coupled by the probe's ``coefs_from``; bf16 or f32 storage, f32
  arithmetic, r and p rounded to storage at the end of every iteration;
  returns r and ``dots[0] + dots[3]``.

- :func:`chunk_reader` — the sum of ``n_fetch`` chunks of ``gr`` rows of a
  (rows, 128) f32 tensor, read at contiguous or LCG-random chunk offsets
  (:func:`chunk_offsets`): the counterpart of ``mk_chunk_reader`` of the JAX
  package's ``benchmarks/probe_graph_stream.py``, the gather primitive a
  chunked graph-operator kernel would be built from.

On a CUDA tensor each wrapper launches its kernel of ``csrc/probes.cu``
(for the residency probes one persistent cooperative launch for all K
iterations; counted in ``.launches``) or raises; on a CPU tensor it runs its plain version
(``*_reference``); any other device raises.  ``hold_x`` / ``resident``
choose between the arm that keeps data on chip and the arm that streams
everything; both arms of a kernel run one geometry and give bitwise equal
results (where the data lives must not change the answer), and the plain
versions ignore the choice.  What a card can hold is a part only (a block
has at most 227 KB of shared memory): after a launch ``.last_held`` says
which share of each vector was held where.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .streamed_cg import _STORAGE, _aligned

__all__ = ["pinned_stream", "pinned_stream_reference", "resident_body",
           "resident_body_reference", "card_capacity", "chunk_reader",
           "chunk_reader_reference", "chunk_offsets"]


def _affine(n: int, device) -> torch.Tensor:
    """d(i) = 1 + b i in f32, b = f32(999 / (n - 1)): a separate multiply
    and add, as the kernels and the JAX probes evaluate it."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    b = torch.tensor(999.0 / (n - 1), dtype=torch.float32, device=device)
    return 1.0 + b * i


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def pinned_stream_reference(r: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
                            s: Optional[torch.Tensor] = None, *,
                            iterations: int):
    """The plain PyTorch version of :func:`pinned_stream` over whole
    vectors, in the vectors' dtype, on any device: ``(r, p, s, acc)``."""
    d = _affine(r.shape[0], r.device).to(r.dtype)
    acc = torch.ones((), dtype=r.dtype, device=r.device)
    for _ in range(iterations):
        a = 1e-12 * acc
        pn = -r + a * p
        rn = r + a * (d * pn) + (a * a) * x
        if s is not None:
            s = s + a * pn
        acc = torch.sum(rn * rn) + torch.sum(x * rn)
        r, p = rn, pn
    return r, p, s, acc


def _coefs_from(dots):
    """The probe's cross-iteration scalar coupling (every dot stays live,
    the values stay tame)."""
    rv, ar, nr, pa, m0, m1 = dots
    beta = 1e-7 * rv / (1.0 + torch.abs(ar))
    crr = -1e-7 * rv / (1.0 + nr)
    c0 = 1e-9 * pa / (1.0 + torch.abs(m0))
    c1 = 1e-9 * m1 / (1.0 + nr)
    rq = 500.0 + 1e-6 * rv
    return beta, crr, c0, c1, rq


def resident_body_reference(r: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
                            *, iterations: int):
    """The plain PyTorch version of :func:`resident_body`: f32 arithmetic
    over whole vectors, r and p rounded to their storage dtype after every
    iteration; ``(r, dots[0] + dots[3])`` with the sum in f32."""
    f32 = torch.float32
    sdt = r.dtype
    a = _affine(r.shape[0], r.device)
    xf = x.to(f32)
    z = torch.zeros((), dtype=f32, device=r.device)
    dots = (torch.sum(r.to(f32) ** 2), z, z, z, z, z)
    for _ in range(iterations):
        beta, crr, c0, c1, rq = _coefs_from(dots)
        rc, pc = r.to(f32), p.to(f32)
        a0 = 2.0 * a - rq
        u1 = (2.0 * a) * xf
        pn = -rc + beta * pc
        q = a0 * pn + c0 * xf + c1 * u1
        rn = rc + crr * q
        a0r = a0 * rn
        a0p = a0 * pn
        dots = (torch.sum(rn * rn), torch.sum(a0r * rn), torch.sum(a0r * a0r),
                torch.sum(a0r * a0p), torch.sum(xf * a0r),
                torch.sum(u1 * a0r))
        r, p = rn.to(sdt), pn.to(sdt)
    return r, dots[0] + dots[3]


# The JAX probe's LCG: h = t * 1103515245 + 12345 in int32 arithmetic.
_LCG_A, _LCG_C = 1103515245, 12345
_INT32_MIN = -(1 << 31)
# The most warps an SM holds: the reader's partials, one a warp of its grid.
_WARPS_PER_SM = 64


def chunk_offsets(t: torch.Tensor, nch: int) -> torch.Tensor:
    """Chunk offsets of the random mode for fetch indices ``t`` (int64,
    0 <= t < 2^31): h = int32(t * 1103515245 + 12345), wrapping at 32 bits,
    then |h| mod nch computed as ``jnp.abs`` and jnp's floor-``%`` compute
    them — |INT32_MIN| stays INT32_MIN (h = INT32_MIN at t = 2,088,216,195),
    and the floor-mod of that negative value lies in [0, nch)."""
    t = torch.as_tensor(t, dtype=torch.int64)
    h = (t * _LCG_A + _LCG_C) & 0xFFFFFFFF
    h = torch.where(h >= (1 << 31), h - (1 << 32), h)
    a = torch.where(h == _INT32_MIN, h, h.abs())
    return torch.remainder(a, nch)


def chunk_reader_reference(v: torch.Tensor, gr: int, random_offsets: bool,
                           n_fetch: int, *, start: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`chunk_reader`: gathers the
    chunks as rows of ``v[:nch gr].view(nch, gr 128)`` and sums them in
    f32; a (1, 1) tensor on v's device."""
    nch = v.shape[0] // gr
    t = torch.arange(start, start + n_fetch, device=v.device)
    off = chunk_offsets(t, nch) if random_offsets else t % nch
    chunks = v[:nch * gr].reshape(nch, gr * v.shape[1])[off]
    return torch.sum(chunks).reshape(1, 1)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from ..csrc.build import load

    lib = load("probes")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pi32, pi64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
        lib.probes_error_string.argtypes = [i32]
        lib.probes_error_string.restype = ctypes.c_char_p
        lib.probes_nacc.argtypes = []
        lib.probes_nacc.restype = i32
        lib.probes_card_capacity.argtypes = [pi32, pi32, pi32]
        lib.probes_card_capacity.restype = i32
        lib.probes_pinned_geometry.argtypes = [i64, pi32, pi32, pi64]
        lib.probes_pinned_geometry.restype = i32
        lib.probes_pinned_stream.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32,
            i64, ctypes.POINTER(ctypes.c_double), vp]
        lib.probes_pinned_stream.restype = i32
        lib.probes_body_geometry.argtypes = [i32, i64, pi32, pi32, pi64, pi64]
        lib.probes_body_geometry.restype = i32
        lib.probes_resident_body.argtypes = [
            i32, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i64,
            i64, vp]
        lib.probes_resident_body.restype = i32
        lib.probes_chunk_reader.argtypes = [vp, i64, i64, i64, i64, i32, i32,
                                            vp, i64, vp, vp]
        lib.probes_chunk_reader.restype = i32
        lib._argtypes_set = True
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.probes_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def card_capacity(device) -> dict:
    """The card's own on-chip sizes (device attributes, not what the
    kernels reach): ``sms``, ``shared_bytes`` = SMs x the most shared memory
    one block may opt in to, and ``l2_bytes``."""
    lib = _lib()
    sms, optin, l2 = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on(lib, lib.probes_card_capacity(
            ctypes.byref(sms), ctypes.byref(optin), ctypes.byref(l2)),
            "card capacity")
    return {"sms": sms.value, "shared_bytes": sms.value * optin.value,
            "l2_bytes": l2.value}


def _on_card(name: str, dtypes, iterations: int, *ts: torch.Tensor) -> bool:
    """Validate flat vectors of one shape, dtype and device; True for CUDA
    tensors (the kernel), False for CPU tensors (the plain version)."""
    t0 = ts[0]
    if any(t.dim() != 1 or t.shape != t0.shape for t in ts):
        raise ValueError(f"{name}: inputs must be flat (n,) tensors of one "
                         f"shape")
    if t0.shape[0] < 2:
        raise ValueError(f"{name}: n must be at least 2 (the diagonal is "
                         f"1 + 999 i / (n - 1))")
    if any(t.device != t0.device for t in ts):
        raise ValueError(f"{name}: inputs must be on one device")
    if t0.dtype not in dtypes or any(t.dtype != t0.dtype for t in ts):
        raise ValueError(f"{name} takes {' or '.join(map(str, dtypes))} "
                         f"vectors of one dtype (got "
                         f"{[str(t.dtype) for t in ts]})")
    if int(iterations) < 1:
        raise ValueError(f"{name}: iterations must be at least 1")
    if t0.device.type == "cpu":
        return False
    if t0.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors (the kernel) or CPU "
                         f"tensors (the plain version), not "
                         f"{t0.device.type}")
    return True


def pinned_stream(r: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
                  s: Optional[torch.Tensor] = None, *, iterations: int,
                  hold_x: bool = True, l2_window: bool = False):
    """K = ``iterations`` steps of the pinned-stream loop (module
    docstring) on f32 vectors: ``(r, p, s, acc)`` with ``s`` None when none
    was given and ``acc`` a 0-d f32 tensor on the vectors' device.

    ``hold_x=True`` keeps x on chip as far as the card can: every block
    copies its slice of x's held region into shared memory once.  With
    ``l2_window=True`` an L2 access-policy window (persisting hits) also
    lies over the rest of x for this launch; the call then waits for the
    kernel and gives the set-aside L2 back.  (The window is an arm to
    measure, off by default: on the H100 it made the loop slower, the
    set-aside lines costing r and p more than they save on x; ``PERF.md``.)
    ``hold_x=False`` streams x from device memory every iteration (5n
    words an iteration, 7n with s, against 4n and 6n when all of x is
    held).  All arms give bitwise equal results.
    ``pinned_stream.last_held`` holds the shares of x in shared memory and
    under the window after a launch.  Raises if the launch is refused."""
    vecs = (r, p, x) if s is None else (r, p, x, s)
    if not _on_card("pinned_stream", (torch.float32,), iterations, *vecs):
        return pinned_stream_reference(r, p, x, s, iterations=iterations)
    r, p, x = _aligned(r), _aligned(p), _aligned(x)
    s = _aligned(s) if s is not None else None
    dev, n = r.device, r.shape[0]
    lib = _lib()
    with torch.cuda.device(dev):
        grid, smem, g_held = ctypes.c_int(0), ctypes.c_int(0), \
            ctypes.c_longlong(0)
        _raise_on(lib, lib.probes_pinned_geometry(
            n, ctypes.byref(grid), ctypes.byref(smem), ctypes.byref(g_held)),
            "pinned_stream geometry")
        r_out, p_out = torch.empty_like(r), torch.empty_like(p)
        s_out = torch.empty_like(s) if s is not None else None
        acc = torch.empty(1, dtype=torch.float32, device=dev)
        partial = torch.empty(2 * grid.value * lib.probes_nacc(),
                              dtype=torch.float64, device=dev)
        l2_share = ctypes.c_double(0.0)
        code = lib.probes_pinned_stream(
            r.data_ptr(), p.data_ptr(), x.data_ptr(),
            s.data_ptr() if s is not None else None,
            r_out.data_ptr(), p_out.data_ptr(),
            s_out.data_ptr() if s is not None else None,
            acc.data_ptr(), partial.data_ptr(), n, int(iterations),
            int(bool(hold_x)), int(bool(hold_x and l2_window)), grid.value,
            smem.value, g_held.value, ctypes.byref(l2_share),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, code, "pinned_stream launch")
    pinned_stream.launches += 1
    pinned_stream.last_held = {
        "grid": grid.value, "shared_bytes_per_block": smem.value if hold_x
        else 0,
        "x_shared": min(1.0, g_held.value * 4 / n) if hold_x else 0.0,
        "x_l2_window": l2_share.value}
    return r_out, p_out, s_out, acc.reshape(())


def resident_body(r: torch.Tensor, p: torch.Tensor, x: torch.Tensor, *,
                  iterations: int, resident: bool = True):
    """K = ``iterations`` steps of the CG chunk body (module docstring) on
    bf16 or f32 storage: ``(r, acc)`` with r in the storage dtype and
    ``acc = dots[0] + dots[3]`` a 0-d f32 tensor on the vectors' device.

    ``resident=True`` keeps every block's slices of r and p (and of x,
    where room is left) in shared memory for all K iterations and writes r
    back once; what does not fit streams.  ``resident=False`` streams r, p
    and x from device memory every iteration (5n storage words).  Both
    arms give bitwise equal results.  ``resident_body.last_held`` holds the
    shares of r/p and of x in shared memory after a launch.  Raises if the
    launch is refused."""
    if not _on_card("resident_body", _STORAGE, iterations, r, p, x):
        return resident_body_reference(r, p, x, iterations=iterations)
    r, p, x = _aligned(r), _aligned(p), _aligned(x)
    dev, n = r.device, r.shape[0]
    bf16 = int(r.dtype == torch.bfloat16)
    width = 8 if bf16 else 4
    lib = _lib()
    with torch.cuda.device(dev):
        grid, smem = ctypes.c_int(0), ctypes.c_int(0)
        g1, g2 = ctypes.c_longlong(0), ctypes.c_longlong(0)
        _raise_on(lib, lib.probes_body_geometry(
            bf16, n, ctypes.byref(grid), ctypes.byref(smem), ctypes.byref(g1),
            ctypes.byref(g2)), "resident_body geometry")
        r_out, p_scratch = torch.empty_like(r), torch.empty_like(p)
        acc = torch.empty(1, dtype=torch.float32, device=dev)
        partial = torch.empty(2 * grid.value * lib.probes_nacc(),
                              dtype=torch.float64, device=dev)
        code = lib.probes_resident_body(
            bf16, r.data_ptr(), p.data_ptr(), x.data_ptr(), r_out.data_ptr(),
            p_scratch.data_ptr(), acc.data_ptr(), partial.data_ptr(), n,
            int(iterations), int(bool(resident)), grid.value, smem.value,
            g1.value, g2.value, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, code, "resident_body launch")
    resident_body.launches += 1
    resident_body.last_held = {
        "grid": grid.value,
        "shared_bytes_per_block": smem.value if resident else 0,
        "rp_shared": min(1.0, g2.value * width / n) if resident else 0.0,
        "x_shared": min(1.0, g1.value * width / n) if resident else 0.0}
    return r_out, acc.reshape(())


def chunk_reader(v: torch.Tensor, gr: int, random_offsets: bool,
                 n_fetch: int, *, start: int = 0) -> torch.Tensor:
    """The sum, as a (1, 1) f32 tensor on v's device, of the chunks read by
    fetches t = start, ..., start + n_fetch - 1 of the (rows, 128) f32
    tensor v: chunk ``off(t)`` is rows ``[off gr, off gr + gr)``, with
    nch = rows // gr chunks (rows past nch gr are never read) and off(t) =
    t mod nch, or :func:`chunk_offsets` with ``random_offsets``.  The JAX
    probe's fetches start at t = 0; ``start`` reaches any t below 2^31
    (where the LCG's INT32_MIN lies) without reading all the fetches
    before it.

    On a CUDA tensor it launches ``csrc/probes.cu``'s reader (a reader and
    a finishing kernel, counted once in ``.launches``; two runs are bitwise
    equal) or raises; on a CPU tensor it runs
    :func:`chunk_reader_reference`."""
    if v.dim() != 2 or v.shape[1] != 128:
        raise ValueError(f"chunk_reader: v must be (rows, 128), got "
                         f"{tuple(v.shape)}")
    if v.dtype != torch.float32:
        raise ValueError(f"chunk_reader takes f32, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError("chunk_reader: v must be contiguous")
    gr, n_fetch, start = int(gr), int(n_fetch), int(start)
    if not 1 <= gr <= v.shape[0]:
        raise ValueError(f"chunk_reader: need 1 <= gr <= rows, got gr = {gr} "
                         f"for {v.shape[0]} rows")
    if n_fetch < 1 or start < 0 or start + n_fetch > (1 << 31):
        raise ValueError(f"chunk_reader: need n_fetch >= 1 and fetches in "
                         f"[0, 2^31) (an int32 LCG), got start {start}, "
                         f"n_fetch {n_fetch}")
    if v.device.type == "cpu":
        return chunk_reader_reference(v, gr, random_offsets, n_fetch,
                                      start=start)
    if v.device.type != "cuda":
        raise ValueError(f"chunk_reader runs on CUDA tensors (the kernel) or "
                         f"CPU tensors (the plain version), not "
                         f"{v.device.type}")
    v = _aligned(v)
    dev = v.device
    lib = _lib()
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        part = torch.empty(sms * _WARPS_PER_SM, dtype=torch.float32,
                           device=dev)
        out = torch.empty((1, 1), dtype=torch.float32, device=dev)
        code = lib.probes_chunk_reader(
            v.data_ptr(), gr, v.shape[0] // gr, start, n_fetch,
            int(bool(random_offsets)), sms, part.data_ptr(), part.numel(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, code, "chunk_reader launch")
    chunk_reader.launches += 1
    return out


# Kernel launches made by this process (the plain versions do not count).
pinned_stream.launches = 0
resident_body.launches = 0
chunk_reader.launches = 0
pinned_stream.last_held = None
resident_body.last_held = None
