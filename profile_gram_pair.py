#!/usr/bin/env python3
"""Where ``gram_pair``'s time goes on one NVIDIA GPU: design variants side
by side, or this checkout against another one in turns.

Run from the repository root:

    python3 profile_gram_pair.py            # design variants
    python3 profile_gram_pair.py --only built,no_products   # some of them
    python3 profile_gram_pair.py PARENT [--json FILE]   # against PARENT

Builds ``optimization_tpu_torch/csrc/gram_pair.cu`` as it is and in a few
variants, each made by editing one constant or line of a copy of the
source (all built at once, one nvcc each), then, for each variant, calls
``gram_pair`` at the phase-7 timed shapes (``chip_smoke.GRAM_TIMED``) in
f32 and bf16 and prints per call: the time by CUDA events warm
(``chip_smoke.time_ms``) and, where the inputs fit in the 50 MB L2, cold
(``chip_smoke.time_cold_ms``: L2 flushed between the calls), its fraction
of the bound (``chip_smoke.gram_bound``, on the cold time where there is
one), the device time of the product kernel and of the finishing kernel
(``torch.profiler``, 20 calls), and the error over the 1e-5 sum|S||X|
tolerance against a float64 product.  The variants:

- ``built``: the source as it is;
- ``ring2`` / ``ring4``: at most two / four stages in the ring;
- ``one_tf32``: hi * hi products only (plain TF32: it breaks the accuracy
  contract, err/tol above 1 is expected; it shows the products' cost);
- ``no_products``: no wgmma at all (wrong results; the staging, the
  transposition and the fold alone);
- ``no_fold``: one wgmma chain over a block's whole row stream (the drift
  the fold prevents; err/tol at the long streams shows it);
- ``no_finish``: the finishing kernel not launched (wrong results; what
  the blocks' partial sums cost to add);
- ``span_always``: every shape on the span route (one bulk copy of a
  tile's rows an array, laid out by the consumers), aligned rows too;
- ``no_pdl``: the finishing kernel launched after the product kernel
  ends, not early;
- ``no_repack``: rows not 16-byte aligned land but are not laid out
  (wrong results; what the layout costs the span and rows routes);
  ``repack_noload`` lays out constants (the layout's stores alone);
- ``no_fence``: without the proxy fences after the consumers' writes
  (unsafe; what the fences cost);
- ``trace``: block (0, 0) records the device clock at each step of each
  tile; printed per call as the mean ns a tile of: the producer waiting
  for a free stage and issuing its copies, the first consumer waiting for
  its tile, laying it out (and transposing S), issuing the products,
  waiting for them, and folding (with the barrier), and the tile period.

With PARENT, the calls are PARENT's kernel (its ``fused.cu``, built from
its own tree and driven through its own C interface,
``fused_gram_geometry`` / ``fused_gram_pair``) and this checkout's, in
turns (parent, built, built, parent) at every shape above in both dtypes,
then the plain version and ``torch.matmul(S.mT, [AS | BS])`` once each.
Both are held against the float64 product at the phase-7 tolerance
(gated for ``built``; the parent's ratio is printed), and the largest
|built - parent| is printed beside it: the two sum in other orders, so
they are not bitwise equal.  With ``--json FILE``, PARENT mode writes
every number to FILE.

Every line is labelled with the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "optimization_tpu_torch", "csrc", "gram_pair.cu")
OUT = os.path.join(ROOT, "optimization_tpu_torch", "_build", "variants")

F32_PRODUCTS = ("    Wgmma<NP>::tf32(acc, al[s], dh, s ? 1 : scale0);\n"
                "    Wgmma<NP>::tf32(acc, ah[s], dl, 1);\n"
                "    Wgmma<NP>::tf32(acc, ah[s], dh, 1);\n")
BF16_PRODUCTS = ("        Wgmma<NP>::bf16(acc, da + (uint64_t)(s * 128),\n"
                 "                        db + (uint64_t)(s * 128), s | keep);"
                 "\n")
VARIANTS = {
    "built": (),
    "ring2": (("kMaxStages = 8;", "kMaxStages = 2;"),),
    "ring4": (("kMaxStages = 8;", "kMaxStages = 4;"),),
    "one_tf32": ((F32_PRODUCTS,
                  "    Wgmma<NP>::tf32(acc, ah[s], dh, s ? 1 : scale0);\n"),),
    "no_products": ((F32_PRODUCTS, ""), (BF16_PRODUCTS, "")),
    "no_fold": (("kFoldChains = true;", "kFoldChains = false;"),),
    "no_finish": (("  const int nent = 2 * k * k;\n",
                   "  return 0;\n  const int nent = 2 * k * k;\n"),),
    "span_always": (("p.route = aligned && (k * size) % 16 == 0 ? 0 : 1;",
                     "p.route = 1;"),),
    "no_pdl": (("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;"),),
    "no_repack": (("      repack<T, XB, W>(stage, stage + land_off, lspan, a, x0, n0, valid,\n"
                   "                       shift);\n", ""),),
    "repack_noload": (("        v = load_chunk<T>(p, a.k - col0);\n",
                       "        v = make_uint4(1u, 2u, 3u, 4u);\n"),),
    "trace": (("kTrace = false;", "kTrace = true;"),),
    "no_fence": (("      fence_proxy_async();\n      consumer_sync();\n      // the producer",
                  "      consumer_sync();\n      // the producer"),
                 ("                          box_bytes, hi, hi + NP * R * 4, R);\n      fence_proxy_async();\n",
                  "                          box_bytes, hi, hi + NP * R * 4, R);\n"),),
}
# the long row streams (chip_smoke.GRAM_LONG) where the fold matters
LONG_CALLS = (((400_000, 48), True), ((2, 100_000, 48), True))


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
    or PARENT's fused.cu as it is."""
    from optimization_tpu_torch.csrc import build as B

    lib = os.path.join(OUT, f"libgram_{name}.so")
    if parent is not None:
        src = os.path.join(parent, "optimization_tpu_torch", "csrc",
                           "fused.cu")
        proc = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", lib, src],
                              capture_output=True, text=True)
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
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib


def parent_call(torch, lib):
    """PARENT's gram_pair wrapper on its own C interface (its
    ``kernels/fused.py`` at that commit, unchanged)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_gram_geometry.argtypes = [i32, i32, i64, i32, i32,
                                        ctypes.POINTER(i32)]
    lib.fused_gram_pair.argtypes = [i32, vp, vp, vp, i32, i64, i32, i32, i32,
                                    vp, vp, vp]
    grids = {}

    def gram_pair(S, AS, BS):
        same = int(BS.data_ptr() == S.data_ptr())
        S3, AS3, BS3 = (t if t.dim() == 3 else t.unsqueeze(0)
                        for t in (S, AS, BS))
        fleet, m, k = S3.shape
        bf16 = int(S.dtype == torch.bfloat16)
        key = (bf16, fleet, m, k, same)
        if key not in grids:
            g = ctypes.c_int(0)
            if lib.fused_gram_geometry(bf16, fleet, m, k, same,
                                       ctypes.byref(g)):
                raise RuntimeError("parent fused_gram_geometry failed")
            grids[key] = g.value
        grid = grids[key]
        part = torch.empty(fleet * grid * 2 * k * k, dtype=torch.float32,
                           device=S.device)
        out = torch.empty((fleet, 2, k, k), dtype=torch.float32,
                          device=S.device)
        code = lib.fused_gram_pair(
            bf16, S3.data_ptr(), AS3.data_ptr(), BS3.data_ptr(), fleet, m, k,
            same, grid, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"parent fused_gram_pair failed: {code}")
        return (out[0, 0], out[0, 1]) if S.dim() == 2 else (out[:, 0],
                                                            out[:, 1])
    return gram_pair


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


def print_trace(lib, shape, same, dt, label):
    """Mean ns a tile of each step block (0, 0) traced (the ``trace``
    variant's events: 0/1 the producer after its empty wait and after its
    copies; 2/3 the first consumer before and after its full wait, 4 after
    the layout and transposition, 5 after issuing the products, 6 after
    their wait, 7 at the tile's end), over its middle tiles."""
    n = 64 * 8
    buf = (ctypes.c_longlong * n)()
    if lib.gram_pair_trace(buf, n, 0):
        raise RuntimeError("gram_pair_trace failed")
    ev = [list(buf[t * 8:(t + 1) * 8]) for t in range(64)]
    tiles = [t for t in range(64) if all(ev[t][j] > 0 for j in range(8))]
    # the middle tiles (the first and last few ramp up and drain)
    mid = [t for t in tiles if 1 <= t and t + 1 in tiles][1:-1] or tiles
    if not mid:
        return
    steps = {"producer waits": (None, 0), "producer issues": (0, 1),
             "consumer waits": (2, 3), "lays out": (3, 4),
             "issues": (None, 5), "drains": (5, 6), "folds": (6, 7)}

    def mean(f):
        return sum(f(t) for t in mid) / len(mid)
    parts = []
    for name, (a, b) in steps.items():
        if name == "producer waits":
            v = mean(lambda t: ev[t][0] - ev[t - 1][1])
        elif name == "issues":
            v = mean(lambda t: ev[t][5] - max(ev[t][4], ev[t - 1][7]))
        else:
            v = mean(lambda t: ev[t][b] - ev[t][a])
        parts.append(f"{name} {v:.0f}")
    period = mean(lambda t: ev[t][7] - ev[t - 1][7])
    print(f"    trace {'x'.join(map(str, shape))} "
          f"{'BS = S' if same else 'BS distinct'} {str(dt)[6:]}: ns a tile "
          f"over {len(mid)} tiles: {', '.join(parts)}; period {period:.0f} "
          f"[{label}]", flush=True)


def err_over_tol(torch, got, S, X):
    Sd = S.double()
    return float(((got.double() - Sd.mT @ X.double()).abs()
                  / (1e-5 * (Sd.abs().mT @ X.double().abs()))).max())


def time_call(torch, CS, fn, shape, same, dtype, flush):
    """(warm ms, cold ms or None, bound ms, bound_by, fraction of the
    bound on the cold time where there is one)."""
    warm = CS.time_ms(torch, fn, 50)
    cold = (CS.time_cold_ms(torch, fn, 20, flush)
            if CS.gram_fits_l2(shape, same, dtype, torch) else None)
    bound_ms, bound_by = CS.gram_bound(shape, same, dtype, torch)
    return warm, cold, bound_ms, bound_by, bound_ms / (cold or warm)


def fmt(warm, cold, bound_ms, bound_by, frac):
    c = f", cold {cold:.4f}" if cold is not None else ""
    return (f"warm {warm:.4f} ms{c}, bound {bound_ms:.4f} ({bound_by}), "
            f"{frac:.3f} of it")


def calls(torch, CS):
    dts = (torch.float32, torch.bfloat16)
    return [(shape, same, dt) for dt in dts for shape, same in CS.GRAM_TIMED]


def inputs_for(torch, dev, shape, dtype):
    gen = torch.Generator(device=dev).manual_seed(4)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(3)]


def run_variants(torch, CS, F, B, libs, dev, label, flush):
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        B.load = lambda _name, lib=lib: lib      # the wrapper's library
        F._gram_geometry.cache_clear()
        for shape, same, dt in calls(torch, CS) + [
                (s, sm, torch.float32) for s, sm in LONG_CALLS]:
            S, AS, BS = inputs_for(torch, dev, shape, dt)
            X = S if same else BS
            ga, gb = F.gram_pair(S, AS, X)
            err = max(err_over_tol(torch, ga, S, AS),
                      err_over_tol(torch, gb, S, X))
            t = time_call(torch, CS, lambda: F.gram_pair(S, AS, X), shape,
                          same, dt, flush)
            split = profile_split(torch, lambda: F.gram_pair(S, AS, X))
            if name == "trace":
                lib.gram_pair_trace.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int, ctypes.c_int]
                torch.cuda.synchronize()
                lib.gram_pair_trace(None, 0, 1)
                F.gram_pair(S, AS, X)
                torch.cuda.synchronize()
                print_trace(lib, shape, same, dt, label)
            print(f"  {name:11s} {'x'.join(map(str, shape))} "
                  f"{'BS = S' if same else 'BS distinct'} {str(dt)[6:]}: "
                  f"{fmt(*t)}; product {split['product']:.4f} ms, finish "
                  f"(with its wait) {split['finish']:.4f} ms, err/tol "
                  f"{err:.3g} [{label}]", flush=True)


def run_parent(torch, CS, F, B, libs, dev, label, flush, result=None):
    built_lib = ctypes.CDLL(libs["built"])
    B.load = lambda _name: built_lib
    F._gram_geometry.cache_clear()
    parent = parent_call(torch, ctypes.CDLL(libs["parent"]))
    fns = {"built": F.gram_pair, "parent": parent}
    rows, failed = [], []
    for shape, same, dt in calls(torch, CS):
        S, AS, BS = inputs_for(torch, dev, shape, dt)
        X = S if same else BS
        row = {"shape": list(shape), "bs": "S" if same else "distinct",
               "dtype": str(dt)[6:]}
        outs = {}
        for name, fn in fns.items():
            outs[name] = [g.clone() for g in fn(S, AS, X)]
            row[f"{name}_err_over_tol"] = max(
                err_over_tol(torch, outs[name][0], S, AS),
                err_over_tol(torch, outs[name][1], S, X))
        row["max_abs_built_minus_parent"] = max(
            float((a - b).abs().max())
            for a, b in zip(outs["built"], outs["parent"]))
        if row["built_err_over_tol"] > 1:
            failed.append(row)
        for turn, name in enumerate(("parent", "built", "built", "parent")):
            fn = fns[name]
            warm, cold, bound_ms, bound_by, frac = time_call(
                torch, CS, lambda: fn(S, AS, X), shape, same, dt, flush)
            row.setdefault(name, []).append({"warm_ms": warm,
                                             "cold_ms": cold})
            row["bound_ms"], row["bound_by"] = bound_ms, bound_by
        row["plain_ms"] = CS.time_ms(
            torch, lambda: F.gram_pair_reference(S, AS, X), 20)
        SX = torch.cat((AS, X), -1)
        row["library_ms"] = CS.time_ms(torch, lambda: torch.matmul(S.mT, SX),
                                       50)
        row["label"] = label
        rows.append(row)
        tag = (f"{'x'.join(map(str, shape))} "
               f"{'BS = S' if same else 'BS distinct'} {str(dt)[6:]}")
        for name in ("parent", "built"):
            ts = row[name]
            best = min((t["cold_ms"] or t["warm_ms"]) for t in ts)
            warm = ", ".join(f"{t['warm_ms']:.4f}" for t in ts)
            cold = ("" if ts[0]["cold_ms"] is None else ", cold " + ", ".join(
                f"{t['cold_ms']:.4f}" for t in ts))
            err = row[name + "_err_over_tol"]
            print(f"  {name:6s} {tag}: warm {warm} ms{cold}; "
                  f"{row['bound_ms'] / best:.3f} of the bound "
                  f"{row['bound_ms']:.4f} ({row['bound_by']}); err/tol vs "
                  f"f64 {err:.3g} [{label}]", flush=True)
        print(f"         {tag}: plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, max |built - parent| "
              f"{row['max_abs_built_minus_parent']:.3g} [{label}]",
              flush=True)
    if result is not None:
        os.makedirs(os.path.dirname(os.path.abspath(result)), exist_ok=True)
        with open(result, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {result}", flush=True)
    if failed:
        raise SystemExit(f"profile_gram_pair: built misses the tolerance at "
                         f"{[(r['shape'], r['bs'], r['dtype']) for r in failed]}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_gram_pair: no CUDA device")
    args = sys.argv[1:]
    only = result = None
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1].split(",")
        del args[i:i + 2]
    if "--json" in args:
        i = args.index("--json")
        result = args[i + 1]
        del args[i:i + 2]
    parent = os.path.abspath(args[0]) if args else None
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
            else {name: None for name in VARIANTS
                  if only is None or name in only})
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(j, jobs[j]), jobs)))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    flush = CS.l2_flush_buffer(torch, dev)
    if parent is not None:
        run_parent(torch, CS, F, B, libs, dev, label, flush, result)
    else:
        run_variants(torch, CS, F, B, libs, dev, label, flush)


if __name__ == "__main__":
    main()
