"""Probe: does keeping the CG loop's own state on chip beat streaming it, on
one CUDA card?

The card's counterpart of the JAX package's
``benchmarks/probe_resident_kernel.py``.  Both arms run the streamed CG
kernel's chunk body (``optimization_tpu_torch.kernels.resident_body``: the
regenerated diagonal, the sphere U group, the p and r updates, six dots,
coupled from one iteration to the next), bf16 storage, f32 arithmetic, in
one persistent cooperative launch:

  body_streamed  read r, p, x; write r, p from device memory (5n words)
  body_resident  every block's slices of r and p (then x) stay in shared
                 memory; what does not fit streams

at n = 2^24 (shared memory holds about 45 % of r and p) and at n = 2^22
(everything fits), or at the sizes ``--n`` gives.  Prints one line an arm:
ms an iteration by the two-point slope over K = 40 and 400 (CUDA events,
``chip_smoke.time_ms``), GB/s of the words that really come from device
memory over the ceiling ``stream3_probe`` measures in the same run, the
shares held, both bounds (bytes of the streamed arm, operations), and the
card's name and power limit.

    python3 probe_resident_body.py [--n N [N ...]]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[chip_smoke.N_MAIN, 1 << 22])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_resident_body.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi, label = chip_smoke.card_label(torch)
    print(smi, flush=True)
    ceiling = chip_smoke.stream3_ceiling(torch, dev)
    print(f"measured ceiling: stream3_probe {ceiling:.0f} GB/s at n = 2^24 "
          f"f32 [{label}]", flush=True)
    arms = chip_smoke.resident_body_arms(torch, dev, label, ceiling,
                                         sizes=tuple(args.n))
    for n in args.n:
        print(f"n = {n}: body_resident / body_streamed = "
              f"{arms[('body_resident', n)][0] / arms[('body_streamed', n)][0]:.3f}",
              flush=True)


if __name__ == "__main__":
    main()
