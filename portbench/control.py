"""The readings that the limits of ``correct`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 ...

For each seed, the input of the window's first solve goes through the
program (as the window drives it) and through the control (the system's
``control``: the reference put in the program's place, one precision
lower), and the system's ``judge`` holds both answers against the plain
reference by the cell's own numbers.  Prints one JSON line a seed, then the
largest program reading and the smallest control reading of each number.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell_name: str, seeds, device, engine=None, root=None):
    """[(seed, program readings, control readings)]."""
    import torch

    from portbench import bench, traffic

    _, _, config, mix, sysmod = bench.load_cell(cell_name, root or bench.ROOT)
    device = torch.device(device)

    def draw(seed, stream):
        return sysmod.draw(config, mix, seed, stream, 0, device)

    system = sysmod.System(config, mix, device, engine=engine)
    system.solve(draw(0, traffic.WARMUP))
    out = []
    for seed in seeds:
        x = draw(seed, traffic.WINDOW)

        def judge(trail):
            return sysmod.judge(config, mix, [(0, trail)], lambda i: x,
                                device)

        prog = judge(system.trail(system.solve_recorded(x)))
        ctl = judge(sysmod.control(config, mix, x))
        out.append((seed, prog, ctl))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    rows = readings(args.workload, args.seeds, "cuda")
    for seed, prog, ctl in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctl}),
              flush=True)
    names = rows[0][1].keys()
    print(json.dumps({
        "workload": args.workload,
        "program_max": {k: max(r[1][k] for r in rows) for k in names},
        "control_min": {k: min(r[2][k] for r in rows) for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
