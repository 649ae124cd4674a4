"""The sphere trial-step kernel's times on one CUDA card.

    python3 profile_sphere_step.py [verbose]

For n = 2^24 and 2^26, in f32 and bf16 storage: ``kernels.sphere_step``
(``csrc/sphere_step.cu``) timed by CUDA events, cold (a 512 MiB write
between launches flushes the L2, as after the streamed CG kernel, which
leaves the ends of other vectors there) and warm (back to back, the least
of three readings); its bytes
bound, 6n words less what the L2 can hold of pass 1's reads for pass 2
(min(2n words, the L2)), at 3.35 TB/s (NVIDIA H100 SXM data sheet), and the
cold time's fraction of it; the plain version's time on the card (the
eager evaluator, ~140 launches); and the host's microseconds to issue one
trial step on each route (no wait), the evaluator's share of an outer
iteration's issue.  Each line carries the card's name and power limit.
``verbose`` prints the kernel build's ``-Xptxas -v`` report (registers,
shared memory, spills).
"""
import importlib
import subprocess
import sys
import time

import torch

HBM = 3.35e12
SIZES = (1 << 24, 1 << 26)
REPS = 20


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def warm_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def cold_ms(fn, flush, reps=REPS):
    """Mean ms a call with the L2 flushed before it (the flush, which keeps
    the card busy while the host issues the call, is outside the events)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def host_us(fn, reps=REPS):
    """Microseconds the host takes to issue one call (no wait)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def main(argv):
    from optimization_tpu_torch.csrc.build import build
    from optimization_tpu_torch.kernels.streamed_cg import AffineDiagonal
    from optimization_tpu_torch.linalg.flat_cg import sphere_rayleigh_step

    S = importlib.import_module("optimization_tpu_torch.kernels.sphere_step")
    if "verbose" in argv:
        build("sphere_step", verbose=True)
    dev = torch.device("cuda", 0)
    label = card()
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    flush = torch.empty(1 << 27, dtype=torch.float32, device=dev)
    print(f"# {label}; L2 {l2} bytes; {REPS} launches a reading", flush=True)
    for n in SIZES:
        diag = AffineDiagonal(1.0, 999.0 / (n - 1))
        elem = S.DiagonalElem(diag, n, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(n, generator=gen, device=dev)
        x /= torch.linalg.vector_norm(x)
        h = 0.3 * torch.randn(n, generator=gen, device=dev) / n ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            xs, hs = x.to(dtype), h.to(dtype)
            w = xs.element_size()
            kernel = lambda: S.sphere_step(xs, hs, elem)          # noqa: E731
            plain_eval = sphere_rayleigh_step(elem)
            plain = lambda: plain_eval(xs, hs, None)              # noqa: E731
            cold = cold_ms(kernel, flush)
            warm = min(warm_ms(kernel) for _ in range(3))
            bound = (6 * n * w - min(2 * n * w, l2)) / HBM * 1e3
            plain_ms = warm_ms(plain, reps=5)
            print(f"n=2^{n.bit_length() - 1} {str(dtype)[6:]}: kernel "
                  f"{cold:.4f} ms cold, {warm:.4f} warm; bound {bound:.4f} "
                  f"ms (fraction {bound / cold:.3f} cold, "
                  f"{bound / warm:.3f} warm); 6n words {6 * n * w / HBM * 1e3:.4f}"
                  f" ms; plain {plain_ms:.4f} ms; host issue "
                  f"{host_us(kernel):.1f} us kernel, "
                  f"{host_us(plain, reps=5):.1f} us plain [{label}]",
                  flush=True)
            del xs, hs
        del x, h, elem
        torch.cuda.empty_cache()
    print(f"launches {S.sphere_step.launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
