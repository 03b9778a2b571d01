"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for (BENCHMARK.json). The last line of standard output is the result, one
JSON object; an earlier line names the card, its power limit, clocks and
temperature and the library versions. The last lines of standard error are
the numbers the correctness check compared, each beside its limit. Without
a CUDA device, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded, the run prints no result and exits with 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import harness

    t_start = harness.process_start_time()
    harness.set_cache_dirs()
    line = harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=t_start)
    if line is None:
        return 1
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
