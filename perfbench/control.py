"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--out <file.json>]

For each seed of --seeds: the program's first three steps, as a run's
set-up takes them, against the float32 reference: the lower readings of
each number (perfbench/check.py). For each seed of --control-seeds, the
reference put in the program's place, twice: computed in float8 (the
control) and with half of each batch left out, the mean taken over the rest
(a planted fault). A state left unchanged reads 1 by construction and
needs no run. Prints one line a reading and, with --out, writes them all as
JSON. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="another batch than the cell's (a witness run)")
    p.add_argument("--set", action="append", default=[],
                   help="a program setting key=value over the cell's, as "
                        "model.dtype=float32 (a witness run)")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import cells, check, harness

    harness.set_cache_dirs()
    cell = cells.load_cell(args.workload, ROOT)
    if args.batch:
        cell["workload"]["batch"] = args.batch
    for kv in args.set:
        key, _, value = kv.partition("=")
        cell["config"]["settings"][key] = json.loads(value)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    for seed in sorted(set(seeds) | set(controls)):
        t0 = time.perf_counter()
        prog = harness.Program(cell, seed, args.device)
        warm = prog.warm()
        batches = [prog.batch_of(i) for i in range(harness.WARM_STEPS)]
        init, dev = prog.init, prog.dev
        prog.free()
        del prog
        ref = check.follow(cell["config"], init, batches, seed, dev)
        kinds = []
        if seed in seeds:
            kinds.append(("program", warm))
        if seed in controls:
            kinds.append(("control_fp8", check.follow(
                cell["config"], init, batches, seed, dev, precision="fp8")))
            kinds.append(("half_batch", check.follow(
                cell["config"], init, batches, seed, dev, half_batch=True)))
        for kind, reading in kinds:
            numbers = check.compare(reading, ref)
            row = {"cell": args.workload, "seed": seed, "kind": kind,
                   "losses": reading.losses, "ref_losses": ref.losses,
                   **numbers, "worst": check.worst_leaves(reading, ref)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
