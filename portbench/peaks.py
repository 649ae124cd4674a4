"""The card's peaks and on-chip capacity, for roofline shares.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense, no
sparsity), at its 700 W limit: 3.35 TB/s of HBM3, 67 TFLOP/s in f32
outside the tensor cores.  On-chip capacity is read from the device: the L2
cache, every SM's shared memory and every SM's register file, which is all
a kernel could hold data in between two passes.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAKS = {
    "NVIDIA H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}

REGISTER_BYTES = 4


@dataclass(frozen=True)
class Card:
    name: str
    hbm_bytes_per_s: float
    f32_flops_per_s: float
    l2_bytes: int
    smem_bytes: int          # all SMs
    register_bytes: int      # all SMs

    @property
    def on_chip_bytes(self) -> int:
        return self.l2_bytes + self.smem_bytes + self.register_bytes


def card(torch, index: int = 0) -> Card:
    """The card's peaks (by the data sheet of its family) and capacity (as
    the device reports it).  Raises for a card the table lacks."""
    p = torch.cuda.get_device_properties(index)
    name = torch.cuda.get_device_name(index)
    family = next((k for k in PEAKS if name.startswith(k)), None)
    if family is None:
        raise ValueError(f"no peaks for {name!r}")
    sms = p.multi_processor_count
    smem = getattr(p, "shared_memory_per_multiprocessor", 0)
    regs = getattr(p, "regs_per_multiprocessor", 0)
    return Card(name=name, l2_bytes=int(p.L2_cache_size),
                smem_bytes=int(sms * smem),
                register_bytes=int(sms * regs * REGISTER_BYTES),
                **PEAKS[family])
