"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Exits with 2, printing no result, without
the CUDA devices the cell asks for; with 3 if JAX or the JAX package was
loaded.  The last line of standard output is the result; the numbers
compared for ``correct`` are the last lines of standard error too.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of the program's toolchain stay inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from portbench import bench

    try:
        line, compared = bench.measure(args.workload, args.seed,
                                       args.seconds, bool(args.trace),
                                       t_process=T_PROCESS)
    except bench.NoCard as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    found = bench.forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for k, c in compared.items():
        print(f"compared {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
