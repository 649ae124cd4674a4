"""One run of one cell: set-up, the measured window, the check, the line.

The window is a closed loop with one caller, as a library user calls the
solver: one solve after another, each on a fresh input that the
configuration's system draws from the seed (``draw``, drawn before the
solve's timed interval), until ``--seconds`` have passed and the solve in
flight has returned.  The host clock around each solve closes on a synchronize.
With ``--trace 1`` the window runs under ``torch.profiler``; the host's
blocking reads are then counted on a few more solves after it, under the
sync debug mode, so their warnings do not slow the traced window.

``memory_peak_bytes`` is the program's own peak: read after the warm-up
solve, before the check's recordings take any memory.  Once the window has
closed, the program's state is freed and the sampled answers are held
against the plain reference (the configuration's ``systems/<system>.py``
``judge``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from . import traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optimization_tpu")


class NoCard(RuntimeError):
    """The cell's chips are not there; the run prints no result."""


@dataclass
class Run:
    """What one run measured: every metric reader reads from this."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float = math.nan
    window_s: float = math.nan
    walls: list = field(default_factory=list)       # s, each solve
    solves: list = field(default_factory=list)      # read_counters dicts
    trace: Optional[object] = None                  # tracing.Trace
    syncs_per_solve: Optional[float] = None
    card: Optional[object] = None                   # peaks.Card
    kernels: tuple = ()             # the system's kernel names
    memory_peak: int = 0            # bytes, the program's own peak


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str):
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, cfg


def load_config(entry: dict, root: Path = ROOT) -> dict:
    config = json.loads((root / entry["file"]).read_text())
    config.setdefault("name", entry["name"])
    return config


def system_module(config: dict):
    return importlib.import_module(f"portbench.systems.{config['system']}")


def load_cell(name: str, root: Path = ROOT):
    """(spec, cell, configuration, mix, system module) of the cell
    ``name`` of the benchmark under ``root``, its mix checked by the
    common rules and by the system's own."""
    spec = load_spec(root)
    cell, entry = find_cell(spec, name)
    config = load_config(entry, root)
    mix = traffic.load(cell["traffic"], root)
    sysmod = system_module(config)
    sysmod.check_mix(mix)
    return spec, cell, config, mix, sysmod


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded from its file."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def count_syncs(torch, fn) -> int:
    """Blocking host reads while ``fn`` runs: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def run_window(torch, system, draw, seconds, device, sample):
    """The closed loop, solve ``i`` on ``draw(WINDOW, i)``.  Returns
    (window seconds, walls, counters, the recorded solves of ``sample``)."""
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    walls, counters, kept = [], [], {}
    sync()
    t_start = time.perf_counter()
    i = 0
    while True:
        inp = draw(traffic.WINDOW, i)
        sync()
        t0 = time.perf_counter()
        if i in sample:
            kept[i] = system.solve_recorded(inp)
            res = kept[i][0]
        else:
            res = system.solve(inp)
        sync()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        counters.append(system.counters(res))
        del res
        i += 1
        if t1 - t_start >= seconds:
            return t1 - t_start, walls, counters, kept


def measure(cell_name: str, seed: int, seconds: float, trace: bool, *,
            t_process: float, require_card: bool = True, device=None,
            engine: Optional[str] = None, root: Path = ROOT):
    """One run of ``cell_name``.  Returns (result line dict, compared
    numbers).  ``require_card=False`` (tests only) runs on ``device``."""
    import torch

    spec, cell, config, mix, sysmod = load_cell(cell_name, root)
    if require_card:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell needs {cell['chips']}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    run = Run(cell=cell, config=config, mix=mix, kernels=sysmod.KERNELS)

    def draw(stream, index):
        return sysmod.draw(config, mix, seed, stream, index, device)

    # ---- set-up: the program, the kernel's build, one warm solve a shape
    stamps = [("imports", time.perf_counter())]
    system = sysmod.System(config, mix, device, engine=engine)
    stamps.append(("problem", time.perf_counter()))
    for w in range(mix["warmup_solves"]):
        system.solve(draw(traffic.WARMUP, w))
        if cuda:
            torch.cuda.synchronize(device)
        stamps.append((f"warm solve {w}", time.perf_counter()))
    if cuda:
        # the program's peak: its problem and a whole solve at the cell's
        # size, before any memory of the check is taken (every solve of
        # the window is the same work, the recorded ones aside)
        run.memory_peak = torch.cuda.max_memory_allocated(device)
        # the recorded solves' memory, reserved now so that no allocation
        # from the device runs inside the window
        reserve = torch.empty(system.recording_bytes(mix["check_solves"]),
                              dtype=torch.uint8, device=device)
        del reserve
        torch.cuda.synchronize(device)
        from . import peaks
        run.card = peaks.card(torch, device.index or 0)
    run.setup_s = time.perf_counter() - t_process
    stamps.append(("reserve", time.perf_counter()))
    log("set-up by phase: " + ", ".join(
        f"{name} {t - t0:.2f} s" for (name, t), (_, t0) in
        zip(stamps, [("", t_process)] + stamps[:-1])))

    # ---- the window
    sample = traffic.sample_indices(seed, mix["check_solves"],
                                    mix["check_within"])
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from .tracing import Trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            run.window_s, run.walls, counters, kept = run_window(
                torch, system, draw, seconds, device, sample)
            t_stop = time.perf_counter()
        t_read = time.perf_counter()
        run.trace = Trace.from_profiler(prof, run.window_s)
        del prof
        log(f"profiler stop {t_read - t_stop:.1f} s, trace read "
            f"{time.perf_counter() - t_read:.1f} s "
            f"({len(run.trace.device_ops)} device ops)")
        if cuda:
            n_sync = mix["sync_solves"]
            reads = count_syncs(torch, lambda: [
                system.solve(draw(traffic.SYNCS, j)) for j in range(n_sync)])
            run.syncs_per_solve = reads / n_sync
    else:
        run.window_s, run.walls, counters, kept = run_window(
            torch, system, draw, seconds, device, sample)
    run.solves = [system.read_counters(c) for c in counters]
    del counters

    log(f"set-up {run.setup_s:.1f} s, window {run.window_s:.1f} s, "
        f"{len(run.solves)} solves")
    t_check = time.perf_counter()

    # ---- the check, after the program's state is freed
    samples = [(i, system.trail(kept[i])) for i in sorted(kept)]
    del kept, system
    if cuda:
        torch.cuda.empty_cache()
    worst = sysmod.judge(config, mix, samples,
                         lambda i: draw(traffic.WINDOW, i), device)
    log(f"check {time.perf_counter() - t_check:.1f} s")
    limits = config.get("limits") or {}
    failed = sum(1 for s in run.solves if not math.isfinite(s["f"]))
    correct = (failed == 0 and bool(samples) and all(
        limits.get(k) is not None and v <= limits[k]
        for k, v in worst.items()))
    compared = {k: {"value": v if math.isfinite(v) else repr(v),
                    "limit": limits.get(k)} for k, v in worst.items()}

    metrics = {}
    for m in metrics_for(spec, cell_name, trace):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": len(run.solves),
            "failed": failed, "metrics": metrics,
            "device": device_entry(torch, device, cell, run)}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["compared"] = compared
    return line, compared


def device_entry(torch, device, cell, run) -> dict:
    if device.type == "cuda":
        entry = {"platform": "gpu",
                 "kind": torch.cuda.get_device_name(device),
                 "count": cell["chips"],
                 "memory_peak_bytes": int(run.memory_peak)}
    else:
        entry = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0}
    if run.trace is not None:
        entry["busy_s"] = run.trace.busy_s()
        entry["window_s"] = run.trace.window_s
    return entry
