"""Run one cell of the port's benchmark once:

    python3 amgbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result's JSON object; the
numbers the judging compared, each beside its limit, are the last lines
of standard error.  Exits non-zero, with no result, without enough CUDA
devices, without the program in the checkout, or when JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    sys.path.insert(0, str(ROOT))
    from amgbench import harness
    sys.exit(harness.main(args, T_START, ROOT))
