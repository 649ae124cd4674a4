"""Shared example harness: device selection, timing and result printing
(counterpart of ``examples/_common.py``).

The examples run on the card unless given ``--device cpu``; without a
card and without that flag they raise, as the CLI does.  The default dtype
follows the JAX examples' x64 rule: float64 on the CPU, float32 on the
card.  Products run in full f32 (TF32 off), the counterpart of JAX's
``jax_default_matmul_precision="highest"``.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` flag."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; there is no fallback: "
                        "use --device cpu to run on the CPU)")
    return p


def device_of(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on the card "
                           "unless given --device cpu")
    return dev


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on the card (the JAX examples' rule)."""
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def setup(device):
    """Pick the device (raising without a card unless it is the CPU), turn
    TF32 off, print the device; returns ``(device, default dtype)``."""
    dev = device_of(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev} ({name}) dtype={default_dtype(dev)}")
    return dev, default_dtype(dev)


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def take(data, key, draw):
    """``data[key]`` where ``data`` gives it, else ``draw()``: the parity
    tests replace an example's random draws with the JAX example's."""
    return data[key] if data is not None and key in data else draw()


def timed(fn, device):
    """``(fn(), wall seconds)``, the card synchronized on both sides."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def summary(res, wall, **extra) -> dict:
    """A solver result's status, iterations and f as Python numbers."""
    return dict(status=int(res.status), iters=int(res.num_iterations),
                f=float(res.f), wall=wall, **extra)


def report(name, r, extra=""):
    print(f"[{name}] status={r['status']} iters={r['iters']}"
          f" f={r['f']:.6e} wall={r['wall']:.2f}s {extra}")


@contextlib.contextmanager
def batch_mesh(device):
    """A mesh over the batch axis of this process group's ranks on
    ``device``'s type: a world of one when no group exists, which is then
    closed on exit."""
    import torch.distributed as dist

    from optimization_tpu_torch.parallel import batch_mesh as _batch_mesh

    fresh = not dist.is_initialized()
    try:
        yield _batch_mesh(devices=torch.device(device).type)
    finally:
        if fresh and dist.is_initialized():
            dist.destroy_process_group()
