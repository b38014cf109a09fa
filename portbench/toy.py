"""Toy-sized runs of the benchmark's cells on the CPU, for its tests: the
cell's configuration cut to a few thousand points, the program on its
plain PyTorch path, one torch thread, in a process of its own.

``python -m portbench.toy CELL SIZE K [--control] [--fault NAME]
[--trace]`` prints the run's result line, then the top-level names of
every module the process loaded. ``--fault`` breaks the program's timed
path underneath the harness (``faults.FAULTS``) before the run;
``--control`` reads the configuration's control through
``portbench.readings`` and prints its ``correct`` and ``checks``.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench.run import ROOT, measure


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("size", type=int)
    ap.add_argument("k", type=int)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)
    from portbench.faults import FAULTS
    from portbench.spec import load, plugin
    spec = load(ROOT, args.cell, held=True)
    points = spec.config["points"]
    spec.config["points"] = plugin("pointsets", points["kind"]).cut(
        points, args.size)
    spec.config["k"] = args.k
    if args.fault:
        FAULTS[args.fault]()
    if args.control:
        from portbench.driver import Cell
        from portbench.readings import reading
        row = reading(Cell(spec.config, spec.traffic, "cpu", control=True),
                      args.seed)
        out = {"correct": row["correct"], "checks": row["checks"]}
    else:
        out = measure(spec, args.seed, 0.0, args.trace, "cpu")
    print(json.dumps(out))
    print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
