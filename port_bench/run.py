"""Run one cell of the benchmark of ``dispu_tpu_torch`` on the card this
process sees, and print its result as the last line of standard output.
Python's bytecode is cached in ``_bench_cache/`` at the root of the
checkout.

    python3 port_bench/run.py --workload up4x-2k --seed 7 --seconds 30 \\
        --trace 0

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
``dispu_tpu`` is loaded once the window has closed.  Kernels build into
the program's own ``dispu_tpu_torch/_build`` inside the checkout.
"""

import os
import sys
import time


# set-up is timed from here: the interpreter's own start-up is before it
STARTED = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Python's bytecode at a fixed path inside the checkout, so that only a
# checkout's first run compiles it: the program's first request imports
# torch's compiler stack, thousands of modules
sys.pycache_prefix = os.path.join(ROOT, "_bench_cache", "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "dispu_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench.lib.bench import run
    from port_bench.lib.cell import Cell

    chips = Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"this process sees {seen}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, args.trace,
                 torch.device("cuda", 0), STARTED)
    bad = loaded_forbidden()
    if bad:
        print(f"port_bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
