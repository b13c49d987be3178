#!/usr/bin/env python
"""Readings that the limits of ``correct`` are set from (not part of a
benchmark run).

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--json PATH]

For each seed, one sound run of the cell (a short window) and its numbers
compared; then, on the same inputs, the control: the plain reference in
the program's place, computed in the precision below the configuration's
(the driver's ``control``), judged by the same numbers.  Where the driver
has them, the program's own reduced-precision paths are read beside it
(``program_variants``).  All seeds run in one process.  Prints one JSON
line per seed and, with ``--json``, writes them all.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--json")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        driver, ctx, out = run.execute(args.workload, seed, args.seconds,
                                       False)
        row = {"seed": seed, "correct": out["correct"],
               "program": {k: c["value"] for k, c in out["checks"].items()},
               "metrics": {k: m["value"] for k, m in out["metrics"].items()}}
        if not args.no_control:
            row["control"] = driver.control(ctx)
            for name, fn in getattr(driver, "program_variants",
                                    {}).items():
                row[name] = fn(ctx)
        if hasattr(driver, "fault_readings") and not args.no_control:
            row["faults"] = driver.fault_readings(ctx)
        if hasattr(driver, "diagnose"):
            row["detail"] = driver.diagnose(ctx)
        row["seconds"] = time.time() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del driver, ctx
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
