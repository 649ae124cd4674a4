"""Probe: does holding the loop-invariant x on chip beat streaming it, in a
CG-like loop on one CUDA card?

The card's counterpart of the JAX package's
``benchmarks/probe_pallas_stream.py``.  All arms run the same loop
(``optimization_tpu_torch.kernels.pinned_stream``: a projected-Hv-like
update of r and p, optionally s, with a scalar carried from one iteration
to the next so that nothing folds), f32, n = 2^24 unless ``--n`` says
otherwise, in one persistent cooperative launch:

  stream5  read r, p, x; write r, p          5n words an iteration
  stream7  the same with s read and written  7n
  pin4     x held on chip                    4n when all of x is held
  pin6     the same with s                   6n

"Held" is what the card can do: each block keeps its slice of x in shared
memory (132 SMs x 227 KB hold about 45 % of a 64 MiB x), and, in the second
pin arm, an L2 access-policy window with persisting hits lies over the
rest.  Prints one line an arm: ms an iteration by the two-point slope over
K = 40 and 400 (CUDA events, ``chip_smoke.time_ms``), GB/s of the words that
really come from device memory over the ceiling ``stream3_probe`` measures
in the same run, the share of x held, and the card's name and power limit.

    python3 probe_pinned_stream.py [--n N]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=chip_smoke.N_MAIN)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_pinned_stream.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi, label = chip_smoke.card_label(torch)
    print(smi, flush=True)
    ceiling = chip_smoke.stream3_ceiling(torch, dev)
    print(f"measured ceiling: stream3_probe {ceiling:.0f} GB/s at n = 2^24 "
          f"f32 [{label}]", flush=True)
    arms = chip_smoke.pinned_stream_arms(torch, dev, label, ceiling, n=args.n,
                                         window=True)
    s5 = arms["stream5"][0]
    for name, (ms, _) in arms.items():
        if name.startswith("pin4"):
            print(f"{name} / stream5 = {ms / s5:.3f}", flush=True)


if __name__ == "__main__":
    main()
