#!/usr/bin/env python3
"""What each part of ``resident_body``'s design buys on one NVIDIA GPU:
design variants of ``csrc/probes.cu`` side by side.

Run from the repository root:  python3 profile_resident_body.py

Builds ``optimization_tpu_torch/csrc/probes.cu`` as it is and in a few
variants, each made by editing a line or a constant of a copy of the source
(all built at once, one nvcc each), then, for each variant in turns (every
variant, then every one again in the reverse order), times
``resident_body`` at n = 2^24 in bf16 (both arms, ms an iteration by the
two-point slope over K = 40 and 400: ``chip_smoke.slope_ms``) and holds
one K = 40 call of each arm against the plain version (|dr| / |r|) and
the two arms against each other bit for bit.  The variants:

- ``built``: the source as it is;
- ``x_evict_last``: x loaded with an L2 evict_last policy (createpolicy and
  ld.global.L2::cache_hint);
- ``rp_evict_first``: the streamed r and p loaded and stored evict_first
  (``__ldcs`` / ``__stcs``);
- ``x_persist``: ``x_evict_last`` with the card's persisting L2 carve-out
  set around each launch (the limit set to its most, reset after the
  kernel);
- ``no_prefetch``: each trip issues its own loads (none in flight across
  trips or across the grid-wide sum);
- ``one_way``: every iteration walks the trips forwards;
- ``x_free``: x is never read (taken as 0: wrong results; the time x's
  reads cost);
- ``x_in_l2``: x read from its first 2 MB only, which L2 keeps (wrong
  results; beside ``built``, what x's misses in L2 cost);
- ``no_trips``: no items (wrong results): the per-iteration cost of the
  grid-wide sum alone;
- ``serial_sum``: the grid-wide sum reading one block's partial at a time;
- ``threads_512``: one block of 512 threads an SM;
- ``two_blocks``: two blocks of 512 an SM, each with half the shared
  memory (the geometry of the first design; at most 64 registers a
  thread).

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
SRC = os.path.join(ROOT, "optimization_tpu_torch", "csrc", "probes.cu")
OUT = os.path.join(ROOT, "optimization_tpu_torch", "_build", "variants")

# the L2 eviction hints, added back: x loaded evict_last (a policy made by
# createpolicy), the streamed r and p loaded and stored evict_first (.cs)
HINT_FNS = ("// The chunk body on one group at element i", """\
__device__ __forceinline__ uint4 load_last(const void* p) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"
               : "=l"(pol));
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], %5;\\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

// The chunk body on one group at element i""")
X_LAST = (HINT_FNS,
          ("if (!(RES && j < L0)) t.hx = load_group(x, i, P.n);",
           "if (!(RES && j < L0)) t.hx = i + W <= P.n ? load_last(x + i) "
           ": load_group(x, i, P.n);"),
          ("t.sx = load_group(x, i, P.n);",
           "t.sx = i + W <= P.n ? load_last(x + i) : load_group(x, i, P.n);"))
RP_FIRST = (
    ("if (i + Store<T>::W <= n) return *reinterpret_cast<const uint4*>(p + i);",
     "if (i + Store<T>::W <= n) return __ldcs(reinterpret_cast<const uint4*>(p + i));"),
    ("if (i + Store<T>::W <= n) *reinterpret_cast<uint4*>(p + i) = Raw<T>::pack(v);",
     "if (i + Store<T>::W <= n) __stcs(reinterpret_cast<uint4*>(p + i), Raw<T>::pack(v));"),
    # x goes through the plain path
    ("t.sx = load_group(x, i, P.n);", "t.sx = load_x(x, i, P.n);"),
    ("if (!(RES && j < L0)) t.hx = load_group(x, i, P.n);",
     "if (!(RES && j < L0)) t.hx = load_x(x, i, P.n);"),
    ("// The chunk body on one group at element i", """\
template <typename T>
__device__ __forceinline__ uint4 load_x(const T* p, long long i, long long n) {
  if (i + Store<T>::W <= n) return *reinterpret_cast<const uint4*>(p + i);
  float f[Store<T>::W];
  Store<T>::load(p, i, n, f);
  return Raw<T>::pack(f);
}

// The chunk body on one group at element i"""))
PIPELINE = ("""      Trip nxt;
      const bool last = u + 1 == trips;
      if (!last) load_trip(j + (back ? -NT : NT), rs, ps, nxt);
      run_trip(j, cur, c, part);
      // the next iteration's first trip is this one: its loads go after
      // this trip's stores, which they read back
      if (last && k + 1 < P.iterations) load_trip(j, r_out, p_out, nxt);
      cur = nxt;
""", """      load_trip(j, rs, ps, cur);
      run_trip(j, cur, c, part);
""")
SERIAL_SUM = ("""    for (unsigned b0 = lane; b0 < gridDim.x; b0 += 32 * 8) {
      double t[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const unsigned b = b0 + 32 * q;
        t[q] = b < gridDim.x ? part[(size_t)b * kMaxAcc + a] : 0.0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) v += t[q];
    }
""", """    for (unsigned b = lane; b < gridDim.x; b += 32)
      v += part[(size_t)b * kMaxAcc + a];
""")
PERSIST = ("""  return (int)launch(body_kernel(bf16, resident), kBodyThreads, args, grid,
                     resident ? smem_bytes : 0, nullptr, (cudaStream_t)stream);""",
           """  int dev = 0, most = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxPersistingL2CacheSize, dev);
  cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)most);
  const cudaError_t e = launch(body_kernel(bf16, resident), kBodyThreads,
                               args, grid, resident ? smem_bytes : 0,
                               nullptr, (cudaStream_t)stream);
  cudaStreamSynchronize((cudaStream_t)stream);
  cudaCtxResetPersistingL2Cache();
  cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
  return (int)e;""")
VARIANTS = {
    "built": (),
    "x_evict_last": X_LAST,
    "rp_evict_first": RP_FIRST,
    "x_persist": X_LAST + (PERSIST,),
    "no_prefetch": (PIPELINE,),
    "one_way": (("const bool back = k & 1;", "const bool back = false;"),
                ("if (last && k + 1 < P.iterations) load_trip(j, r_out, p_out, nxt);",
                 "if (last && k + 1 < P.iterations) "
                 "load_trip(threadIdx.x, r_out, p_out, nxt);")),
    "x_free": (("t.hx = load_group(x, i, P.n);",
                "t.hx = make_uint4(0u, 0u, 0u, 0u);"),
               ("t.sx = load_group(x, i, P.n);",
                "t.sx = make_uint4(0u, 0u, 0u, 0u);")),
    "x_in_l2": (("t.hx = load_group(x, i, P.n);",
                 "t.hx = load_group(x, i & ((1LL << 20) - 1), P.n);"),
                ("t.sx = load_group(x, i, P.n);",
                 "t.sx = load_group(x, i & ((1LL << 20) - 1), P.n);")),
    "no_trips": (("const long long LT = LH > LS ? LH : LS;",
                  "const long long LT = 0;"),),
    "serial_sum": (SERIAL_SUM,),
    "threads_512": (("kBodyThreads = 768", "kBodyThreads = 512"),),
    "two_blocks": (("kBodyThreads = 768", "kBodyThreads = 512"),
                   ("kBodyBlocksPerSM = 1", "kBodyBlocksPerSM = 2")),
}


def variant_source(edits):
    text = open(SRC).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"profile_resident_body: the source no longer "
                             f"holds {old.strip()[:60]!r}; update VARIANTS")
        text = text.replace(old, new)
    return text


def build(name):
    """Compile one variant beside the original, so its headers resolve."""
    from optimization_tpu_torch.csrc import build as B

    src = os.path.join(os.path.dirname(SRC), f"_variant_{name}.cu")
    lib = os.path.join(OUT, f"libprobes_{name}.so")
    with open(src, "w") as f:
        f.write(variant_source(VARIANTS[name]))
    try:
        proc = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-Xptxas", "-v",
                               "-o", lib, src], capture_output=True,
                              text=True)
    finally:
        os.remove(src)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    # ptxas -v: "Compiling entry function '<name>'" (or "Function
    # properties for <name>"), then its spills and "Used N registers"
    regs, spills, body = [], [], False
    for line in proc.stderr.splitlines():
        if "entry function" in line or "Function properties for" in line:
            body = "resident_body_kernel" in line
        elif body and "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
        elif body and "spill stores" in line and " 0 bytes spill" not in line:
            spills.append(line.strip())
    return lib, regs, spills


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_resident_body: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from optimization_tpu_torch.csrc import build as B
    from optimization_tpu_torch.kernels import probes as P

    _, label = CS.card_label(torch)
    dev = torch.device("cuda", 0)
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    n, K = CS.N_MAIN, CS.PROBE_K[0]
    r, p, x = CS.probe_vectors(torch, n, torch.bfloat16, dev, 2)
    ref = P.resident_body_reference(r, p, x, iterations=K)
    names = list(built)
    for name in names + names[::-1]:
        path, regs, spills = built[name]
        lib = ctypes.CDLL(path)
        B.load = lambda _name, lib=lib: lib      # the wrapper's library
        lib._argtypes_set = False
        times = {}
        for res in (False, True):
            times[res] = CS.slope_ms(torch, lambda k: P.resident_body(
                r, p, x, iterations=k, resident=res))
        held = P.resident_body.last_held
        outs = [P.resident_body(r, p, x, iterations=K, resident=res)
                for res in (False, True)]
        rel = CS._rel_norm(torch, outs[1][0], ref[0])
        same = (torch.equal(outs[0][0], outs[1][0])
                and torch.equal(outs[0][1], outs[1][1]))
        print(f"  {name:13s} resident {times[True]:.4f} ms an iteration, "
              f"streamed {times[False]:.4f}; r, p held "
              f"{held['rp_shared']:.4f} (grid {held['grid']}); |dr|/|r| "
              f"{rel:.2e}, arms bitwise equal {same}; registers {regs}"
              f"{'; ' + ' | '.join(spills) if spills else ''} [{label}]",
              flush=True)


if __name__ == "__main__":
    main()
