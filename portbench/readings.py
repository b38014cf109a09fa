"""The readings that the limits of ``traffic/<mix>.json`` were set from,
and the one entry point of the configuration's lower-precision control:
the compared numbers of the program on a dozen seeds or more, of the
control on three or more, and of the program with a fault planted
(``faults.py``), one window unit each, in one process (the set-up is
shared)::

    python3 -m portbench.readings --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --fault frozen --fault-seeds 4,5,6

Prints one JSON line a seed: the cell, the seed, what ran (``program``,
``control`` or the fault's name), the numbers compared and whether each
is within its limit. The fault is planted last, as it stays in the
process. The benchmark's own runs never run the control or a fault.
A cell held out of ``BENCHMARK.json`` (``held/``) is read here too.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.run import ROOT


def reading(cell, seed: int) -> dict:
    """Set-up of ``seed``, one unit of the window and the check."""
    t0 = time.perf_counter()
    cell.setup(seed)
    win = cell.window(0.0)
    checks = cell.check(win)
    numbers = checks["numbers"]
    return {"seed": seed, "units": win.units, "wall_s": win.wall_s,
            "seconds": time.perf_counter() - t0,
            "correct": checks["failed"] == 0 and all(
                v["value"] <= v["limit"] for v in numbers.values()),
            "numbers": {k: v["value"] for k, v in numbers.items()},
            "within": {k: v["value"] <= v["limit"]
                       for k, v in numbers.items()},
            "checks": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from portbench.driver import Cell
    from portbench.faults import FAULTS
    from portbench.spec import load
    spec = load(ROOT, args.workload, held=True)
    runs = [("program", args.seeds), ("control", args.control_seeds),
            (args.fault, args.fault_seeds if args.fault else "")]
    for what, seeds in runs:
        if not seeds:
            continue
        if what in FAULTS:
            FAULTS[what]()
        cell = Cell(spec.config, spec.traffic, args.device,
                    control=what == "control")
        for seed in (int(s) for s in seeds.split(",")):
            row = reading(cell, seed)
            del row["checks"]
            print(json.dumps({"workload": args.workload, "what": what,
                              **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
