#!/usr/bin/env python3
"""Where ``gram_pair``'s time goes on one NVIDIA GPU: design variants side
by side.

Run from the repository root:  python3 profile_gram_pair.py

Builds ``optimization_tpu_torch/csrc/fused.cu`` as it is and in a few
variants, each made by editing one constant or line of a copy of the
source (all built at once, one nvcc each), then, for each variant, calls
``gram_pair`` at config3's 100,000 x 48 (BS distinct and BS = S) and
config10's 16 x 10,000 x 48 in f32, and at 100,000 x 48 BS = S in bf16,
and prints per call: the time by CUDA events (``chip_smoke.time_ms``), its
fraction of the bound (``chip_smoke.gram_bound``), the device time of the
product kernel and of the finishing kernel (``torch.profiler``, 20 calls),
and the error over the 1e-5 sum|S||X| tolerance against a float64
product.  The variants:

- ``built``: the source as it is;
- ``ring2``: a two-stage cp.async ring (one tile in flight);
- ``rows32``: 32-row f32 (64-row bf16) tiles, twice the barriers;
- ``two_blocks``: ``__launch_bounds__(256, 2)`` and a 100 KB ring, so two
  blocks share an SM;
- ``one_tf32``: hi * hi products only (plain TF32: it breaks the accuracy
  contract, err/tol above 1 is expected; it shows the products' cost);
- ``no_products``: no mma at all (wrong results; the staging alone).

Every line is labelled with the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "optimization_tpu_torch", "csrc", "fused.cu")
OUT = os.path.join(ROOT, "optimization_tpu_torch", "_build", "variants")

SMALL_PRODUCTS = ("        mma_tf32(acc[a][b], al, bh[b]);\n"
                  "        mma_tf32(acc[a][b], ah, bl[b]);\n")
ALL_PRODUCTS = (
    (SMALL_PRODUCTS + "        mma_tf32(acc[a][b], ah, bh[b]);\n", ""),
    ("      for (int b = 0; b < NW; ++b) mma_bf16(acc[a][b], af, bf[b]);\n",
     ""))
VARIANTS = {
    "built": (),
    "ring2": (("kRingBytes = 200 * 1024", "kRingBytes = 0"),),
    "rows32": (("kStepsPerTile = 8", "kStepsPerTile = 4"),),
    "two_blocks": (("kRingBytes = 200 * 1024", "kRingBytes = 100 * 1024"),
                   ("__launch_bounds__(kThreads, 1)",
                    "__launch_bounds__(kThreads, 2)")),
    "one_tf32": ((SMALL_PRODUCTS, ""),),
    "no_products": ALL_PRODUCTS,
}
CALLS = (((100_000, 48), False, "float32"), ((100_000, 48), True, "float32"),
         ((16, 10_000, 48), False, "float32"),
         ((100_000, 48), True, "bfloat16"))


def variant_source(edits):
    text = open(SRC).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"profile_gram_pair: the source no longer holds "
                             f"{old.strip()!r}; update VARIANTS")
        text = text.replace(old, new)
    return text


def build(name):
    """Compile one variant (beside the original, so its headers resolve)."""
    from optimization_tpu_torch.csrc import build as B

    src = os.path.join(os.path.dirname(SRC), f"_variant_{name}.cu")
    lib = os.path.join(OUT, f"libfused_{name}.so")
    with open(src, "w") as f:
        f.write(variant_source(VARIANTS[name]))
    try:
        proc = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", lib, src],
                              capture_output=True, text=True)
    finally:
        os.remove(src)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return lib


def profile_split(torch, fn):
    """Device ms per call of the product and the finishing kernel."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    split = {"product": 0.0, "finish": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = t if t is not None else getattr(e, "cuda_time_total", 0.0)
        if "gram_pair_kernel" in e.key:
            split["product"] += t / 20 / 1e3
        elif "gram_finish_kernel" in e.key:
            split["finish"] += t / 20 / 1e3
    return split


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_gram_pair: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from optimization_tpu_torch.csrc import build as B
    from optimization_tpu_torch.kernels import fused as F

    _, label = CS.card_label(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    inputs = {}
    for shape, _, dt in CALLS:
        gen = torch.Generator(device=dev).manual_seed(4)
        inputs[shape, dt] = [torch.randn(shape, generator=gen, device=dev)
                             .to(getattr(torch, dt)) for _ in range(3)]
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        B.load = lambda _name, lib=lib: lib      # the wrapper's library
        F._gram_geometry.cache_clear()
        for shape, same, dt in CALLS:
            S, AS, BS = inputs[shape, dt]
            X = S if same else BS
            ga, gb = F.gram_pair(S, AS, X)
            Sd = S.double()
            err = max(float(((g.double() - Sd.mT @ Y.double()).abs()
                             / (1e-5 * (Sd.abs().mT @ Y.double().abs())))
                            .max()) for g, Y in ((ga, AS), (gb, X)))
            ms = CS.time_ms(torch, lambda: F.gram_pair(S, AS, X), 50)
            bound_ms, _ = CS.gram_bound(shape, same, S.dtype, torch)
            split = profile_split(torch, lambda: F.gram_pair(S, AS, X))
            print(f"  {name:11s} {'x'.join(map(str, shape))} "
                  f"{'BS = S' if same else 'BS distinct'} {dt}: {ms:.4f} ms "
                  f"({bound_ms / ms:.3f} of the bound), product kernel "
                  f"{split['product']:.4f} ms, finish (with its wait) "
                  f"{split['finish']:.4f} "
                  f"ms, err/tol {err:.3g} [{label}]", flush=True)


if __name__ == "__main__":
    main()
