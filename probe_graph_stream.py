"""Probe: what does one CUDA card deliver when a kernel gathers a vector in
chunks at random offsets, and what does the port's connection-Laplacian
apply achieve on a production-shaped pose graph?

The card's counterpart of the JAX package's
``benchmarks/probe_graph_stream.py``: would a whole-loop kernel for the
rotation-sync Hessians, which must read the rows of each vertex's graph
neighbours (spread over the whole vector for odometry + random loop
closures), be fed at a useful rate by chunked gathers?  Arms (f32):

  ctg[g]  ``kernels.chunk_reader`` at contiguous chunk offsets, g rows of
          128 words (512 B) a chunk, g in 1, 8, 64, 512, 2048
  rnd[g]  the same at the JAX probe's int32-LCG random offsets
  scatter / gather / sort / adjacency
          ``models.rotation_sync.connection_laplacian_op`` at n_rot = 2^21,
          d = 3, on the probe's edge set (odometry chain + 2n random
          closures, self-loops dropped), against the probe's floor
          (2 n d^2 + 3 E d^2) 4 bytes an apply

The source vector is N = 2^26 f32 words (256 MiB, above the 50 MB L2).
Each chunk arm prints microseconds a chunk by the two-point slope over
nch / 4 and nch fetches (one sweep of the vector at the larger; each call
after a pass that evicts the vector from L2; the JAX probe's 2048 / 8192
too where it is above the timing noise) and GB/s over the
``stream3_probe`` ceiling measured in the same run and over 3.35 TB/s, the
random arms with the share of fetches that re-read a chunk the L2 can still
hold;
each operator arm ms an apply, GB/s of the floor, peak memory, the share
of edges within a 1 MiB chunk window, and its agreement with an f64 apply.
Every line carries the card's name and power limit.  The functions are
``chip_smoke.chunk_reader_arms`` and ``chip_smoke.laplacian_arms``
(``chip_smoke.py`` phase 16 runs them too); what the H100 measured is in
``PERF.md``.

    python3 probe_graph_stream.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_graph_stream.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, label = chip_smoke.card_label(torch)
    print(smi, flush=True)
    ceiling = chip_smoke.stream3_ceiling(torch, dev)
    print(f"measured ceiling: stream3_probe {ceiling:.0f} GB/s at n = 2^24 "
          f"f32 [{label}]", flush=True)
    print(f"chunk_reader over N = 2^26 f32 words [{label}]", flush=True)
    chip_smoke.chunk_reader_arms(torch, dev, label, ceiling)
    print(f"connection Laplacian at n_rot = 2^21, d = 3, f32 [{label}]",
          flush=True)
    chip_smoke.laplacian_arms(torch, dev, label, ceiling)


if __name__ == "__main__":
    main()
