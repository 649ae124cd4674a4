"""Profile the port's LOBPCG path on one CUDA card.

Runs config3 (m = 1e5, nx = 16, nev = 5, A = diag(linspace(1, m)), the
exact-inverse preconditioner, f32) on the eigh and chol routes and the
config10 fleet (16 x m = 1e4, chol), 20 fixed iterations each with the
convergence test disarmed.  Prints for each: the wall unprofiled and under
``torch.profiler``, the device-busy time (the sum of the kernels' device
times), the idle share against both walls, and the top kernels and copies
by device time with their counts (the device-to-host copies are the host
round trips per iteration).

    python3 profile_lobpcg.py
"""
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from optimization_tpu_torch.linalg import lobpcg, lobpcg_fleet  # noqa: E402

K = 20


def dev_time(e):
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, k):
            return getattr(e, k)
    return 0.0


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_lobpcg.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    m, nx, nev = 100_000, 16, 5
    d = torch.linspace(1.0, float(m), m, device=dev)
    fleet, mf = 16, 10_000
    ds = (torch.arange(1.0, fleet + 1.0, device=dev)[:, None]
          * torch.linspace(1.0, mf / 10.0, mf, device=dev)[None, :])

    def c3(rr, k):
        gen = torch.Generator(device=dev).manual_seed(3)
        return lobpcg(lambda S: d[:, None] * S, T=lambda S: S / d[:, None],
                      m=m, nx=nx, nev=nev, max_iterations=k, tau=1e-30,
                      generator=gen, rr_method=rr)

    def c10(rr, k):
        gen = torch.Generator(device=dev).manual_seed(5)
        return lobpcg_fleet(lambda S, dd: dd[:, None] * S, ds,
                            T=lambda S, dd: S / dd[:, None], m=mf, nx=nx,
                            nev=nev, max_iterations=k, tau=1e-30,
                            generator=gen, rr_method=rr)

    for name, fn, rr in (("config3 eigh", c3, "eigh"),
                         ("config3 chol", c3, "chol"),
                         ("config10 fleet chol", c10, "chol")):
        fn(rr, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(rr, K)
        torch.cuda.synchronize()
        wall_np = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(rr, K)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        busy = sum(dev_time(e) for e in ka) / 1e3
        print(f"== {name}: {K} iterations; wall {wall_np * 1e3:.1f} ms "
              f"unprofiled ({wall_np / K * 1e3:.2f} ms/it), "
              f"{wall * 1e3:.1f} ms profiled; device busy {busy:.1f} ms "
              f"(idle share {1 - busy / (wall_np * 1e3):.3f} against the "
              f"unprofiled wall, {1 - busy / (wall * 1e3):.3f} against the "
              f"profiled)", flush=True)
        for e in sorted(ka, key=dev_time, reverse=True)[:14]:
            if dev_time(e) > 0:
                print(f"  {dev_time(e) / 1e3:9.3f} ms  {e.count:6d}x  "
                      f"{e.key[:100]}")


if __name__ == "__main__":
    main()
