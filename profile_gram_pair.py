#!/usr/bin/env python3
"""Where ``gram_pair``'s time goes on one NVIDIA GPU: design variants side
by side, or this checkout against another one in turns.

Run from the repository root:

    python3 profile_gram_pair.py            # design variants
    python3 profile_gram_pair.py PARENT     # against the checkout at PARENT

Builds ``optimization_tpu_torch/csrc/fused.cu`` as it is and in a few
variants, each made by editing one constant or line of a copy of the
source (all built at once, one nvcc each), then, for each variant, calls
``gram_pair`` at config3's 100,000 x 48 (BS distinct and BS = S) and
config10's 16 x 10,000 x 48 in f32, at 100,000 x 48 BS = S in bf16 and
at 100,000 x 30 in f32 (rows not 16-byte aligned), and prints per call: the time by CUDA events (``chip_smoke.time_ms``), its
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
- ``no_products``: no mma at all (wrong results; the staging alone);
- ``no_split``: k <= 96 never splits a warp's accumulator chain, however
  long (kSplitSteps unbounded);
- ``stagger``: at k > 96, panel q of a row stream walks its tiles from
  q ntiles / npan^2 on (wrapping round), so the panels that stage one row
  tile do so far apart in time and cannot share it in L2 (the same sums
  in another order);
- ``no_products_stagger``: ``no_products`` with ``stagger``'s order.
  Beside ``no_products``, what the panels' sharing of L2 is worth: were
  each panel's tiles read from device memory anyway, the two would take
  the same time.

Each variant also runs k <= 96 shapes whose warps run chains longer than
kSplitSteps (400,000 x 48, a fleet of 2 x 100,000 x 48 and 100,000 x 96)
and the panel route's shapes (k = 120 and 192 at m = 100,000, BS
distinct and BS = S, f32 and bf16).

With PARENT, the variants are PARENT's ``fused.cu`` (built from its own
tree, driven through this checkout's wrapper, whose C interface it
shares) and ``built``, run in turns (parent, built, built, parent) at the
shapes above and the long chains, and every output of ``built`` at the
shapes above is held bit for bit against PARENT's; the panel shapes
follow for ``built``.

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

# the products of the k <= 96 instances and of the panel route's (which
# go into a zeroed fragment d first)
SMALL_PRODUCTS = ("          mma_tf32(acc[a][b], al, bh[b]);\n"
                  "          mma_tf32(acc[a][b], ah, bl[b]);\n")
SMALL_SPLIT = ("          mma_tf32(d, al, bh[b]);\n"
               "          mma_tf32(d, ah, bl[b]);\n")
ONE_TF32 = ((SMALL_PRODUCTS, ""), (SMALL_SPLIT, ""))
ALL_PRODUCTS = (
    (SMALL_PRODUCTS + "          mma_tf32(acc[a][b], ah, bh[b]);\n", ""),
    ("          mma_bf16(acc[a][b], af, bf[b]);\n", ""),
    (SMALL_SPLIT + "          mma_tf32(d, ah, bh[b]);\n", ""),
    ("          mma_bf16(d, af, bf[b]);\n", ""))
# panel q of a row stream starts q ntiles / npan^2 tiles on
STAGGER = (("const long long r0 = ((long long)tile * gx + bx) * ROWS;",
            "const long long r0 = ((long long)((tile + q * (ntiles / "
            "(npan * npan))) % ntiles) * gx + bx) * ROWS;"),)
VARIANTS = {
    "built": (),
    "ring2": (("kRingBytes = 200 * 1024", "kRingBytes = 0"),),
    "rows32": (("kStepsPerTile = 8", "kStepsPerTile = 4"),),
    "two_blocks": (("kRingBytes = 200 * 1024", "kRingBytes = 100 * 1024"),
                   ("__launch_bounds__(kThreads, 1)",
                    "__launch_bounds__(kThreads, 2)")),
    "one_tf32": ONE_TF32,
    "no_products": ALL_PRODUCTS,
    "no_split": (("kSplitSteps = 40", "kSplitSteps = 1 << 30"),),
    "stagger": STAGGER,
    "no_products_stagger": ALL_PRODUCTS + STAGGER,
}
CALLS = (((100_000, 48), False, "float32"), ((100_000, 48), True, "float32"),
         ((16, 10_000, 48), False, "float32"),
         ((100_000, 48), True, "bfloat16"),
         ((100_000, 30), False, "float32"))     # rows not 16-byte aligned
# k <= 96 with a warp's chain past kSplitSteps: 96, 48 and 96 k-steps
LONG_CALLS = (((400_000, 48), True, "float32"),
              ((2, 100_000, 48), True, "float32"),
              ((100_000, 96), True, "float32"),
              ((400_000, 48), True, "bfloat16"))
WIDE_CALLS = tuple(((100_000, k), same, dt) for dt in ("float32", "bfloat16")
                   for k in (120, 192) for same in (False, True))


def variant_source(edits):
    text = open(SRC).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"profile_gram_pair: the source no longer holds "
                             f"{old.strip()!r}; update VARIANTS")
        text = text.replace(old, new)
    return text


def build(name, parent=None):
    """Compile one variant (beside the original, so its headers resolve),
    or PARENT's source as it is."""
    from optimization_tpu_torch.csrc import build as B

    lib = os.path.join(OUT, f"libfused_{name}.so")
    if parent is not None:
        src = os.path.join(parent, "optimization_tpu_torch", "csrc",
                           "fused.cu")
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-o", lib, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    else:
        src = os.path.join(os.path.dirname(SRC), f"_variant_{name}.cu")
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


def run_calls(torch, CS, F, name, inputs, calls, label):
    """Each call once for its outputs, then timed and profiled; returns
    {call: outputs}."""
    outs = {}
    for shape, same, dt in calls:
        S, AS, BS = inputs[shape, dt]
        X = S if same else BS
        ga, gb = F.gram_pair(S, AS, X)
        outs[shape, same, dt] = (ga.clone(), gb.clone())
        Sd = S.double()
        err = max(float(((g.double() - Sd.mT @ Y.double()).abs()
                         / (1e-5 * (Sd.abs().mT @ Y.double().abs())))
                        .max()) for g, Y in ((ga, AS), (gb, X)))
        ms = CS.time_ms(torch, lambda: F.gram_pair(S, AS, X), 50)
        bound_ms, _ = CS.gram_bound(shape, same, S.dtype, torch)
        split = profile_split(torch, lambda: F.gram_pair(S, AS, X))
        print(f"  {name:19s} {'x'.join(map(str, shape))} "
              f"{'BS = S' if same else 'BS distinct'} {dt}: {ms:.4f} ms "
              f"({bound_ms / ms:.3f} of the bound), product kernel "
              f"{split['product']:.4f} ms, finish (with its wait) "
              f"{split['finish']:.4f} "
              f"ms, err/tol {err:.3g} [{label}]", flush=True)
    return outs


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_gram_pair: no CUDA device")
    parent = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else None
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from optimization_tpu_torch.csrc import build as B
    from optimization_tpu_torch.kernels import fused as F

    _, label = CS.card_label(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    jobs = ({"parent": parent, "built": None} if parent is not None
            else {name: None for name in VARIANTS})
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(j, jobs[j]), jobs)))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    inputs = {}
    for shape, _, dt in CALLS + LONG_CALLS + WIDE_CALLS:
        gen = torch.Generator(device=dev).manual_seed(4)
        inputs[shape, dt] = [torch.randn(shape, generator=gen, device=dev)
                             .to(getattr(torch, dt)) for _ in range(3)]
    order = (("parent", "built", "built", "parent") if parent is not None
             else tuple(VARIANTS))
    # against a parent, the k > 96 calls (which it refuses) follow for
    # ``built`` alone
    calls = CALLS + LONG_CALLS + (() if parent is not None else WIDE_CALLS)
    outs = {}
    for name in order:
        lib = ctypes.CDLL(libs[name])
        B.load = lambda _name, lib=lib: lib      # the wrapper's library
        F._gram_geometry.cache_clear()
        outs[name] = run_calls(torch, CS, F, name, inputs, calls, label)
    if parent is not None:
        same = all(torch.equal(a, b) for call in CALLS
                   for a, b in zip(outs["built"][call], outs["parent"][call]))
        print(f"  built against parent, k <= 96: bitwise equal {same}",
              flush=True)
        if not same:
            raise SystemExit("profile_gram_pair: the k <= 96 outputs differ "
                             "from the parent's")
        lib = ctypes.CDLL(libs["built"])
        B.load = lambda _name, lib=lib: lib
        F._gram_geometry.cache_clear()
        run_calls(torch, CS, F, "built", inputs, WIDE_CALLS, label)


if __name__ == "__main__":
    main()
