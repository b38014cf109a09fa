#!/usr/bin/env python3
"""Where the distributed partitioner balances: the final imbalance of
``make_distributed_partitioner`` (the §4.1 SFC redistribution, then
balanced k-means on each rank's stretch of the curve) on uniform points
in [0, 1)^3 from seed 0, over a grid of point counts n and block counts
k, beside two solves of the same points that sample their warm-up
differently. Run from the root of a checkout::

    python3 tools/redistribute_balance.py                  # the port, card
    python3 tools/redistribute_balance.py --n 65536 --k 256 --devices 1 \\
        --reference                                     # the JAX package

The port's run (on the card; ``--device cpu`` on the host) launches P
ranks once per ``--devices`` entry and solves every (n, k) inside it. A
line gives P, n, k, the final imbalance, the movement iterations and the
imbalance after each of them, then (P = 1) the same points through
``partition()``, whose warm-up samples a random permutation, and through
the distributed partitioner with ``warmup=False``. The redistributed
warm-up samples a prefix of every rank's slots, which the sort has put in
curve order: a small corner of the box at first. ``--reference`` runs the
reference's ``make_distributed_partitioner`` on P virtual host devices
instead (JAX on the CPU; the final imbalance only, which is all it
returns). It gates nothing.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EPS = 0.03


def points(n: int):
    import numpy as np
    return np.random.default_rng(0).uniform(0.0, 1.0, (n, 3))


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def port_grid(grid, device):
    """Rank body: every (n, k) of ``grid`` through the port's distributed
    partitioner on this launch's ranks; rank 0's lines."""
    import numpy as np
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.core.partitioner import make_distributed_partitioner
    from repro_torch.dist import current
    from repro_torch.partition import PartitionProblem, partition
    comm = current()
    P, r = comm.size, comm.rank
    lines = []
    for n, k in grid:
        pts = points(n)
        mine = pts[r * (n // P):(r + 1) * (n // P)]
        t0 = time.perf_counter()
        out = make_distributed_partitioner(
            P, BKMConfig(k=k, epsilon=EPS), device=device)(
                mine, return_stats=True)
        wall = time.perf_counter() - t0
        st = out[7]
        it = int(st["iters"])
        hist = " ".join(f"{x:.3g}" for x in st["history"]["imbalance"][:it])
        line = (f"P={P} n={n} k={k}: imbalance {float(out[5]):.6f}, iters "
                f"{it}, {wall:.2f} s; after each iteration: {hist}")
        if P == 1:
            prob = PartitionProblem(points=pts, k=k, epsilon=EPS, seed=0)
            single = partition(prob, device=device).imbalance()
            cold = make_distributed_partitioner(
                1, BKMConfig(k=k, epsilon=EPS, warmup=False),
                device=device)(mine)[5]
            line += (f"; partition() {single:.6f}; warmup=False "
                     f"{float(cold):.6f}")
        lines.append(line)
    return lines


def reference_grid(grid, devices):
    """The reference's distributed partitioner on P virtual host devices,
    for each P of ``devices``."""
    import warnings
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_"
                          f"count={max(devices)}")
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core.balanced_kmeans import BKMConfig
        from repro.core.partitioner import make_distributed_partitioner
    for P in devices:
        mesh = Mesh(np.array(jax.devices()[:P]), ("data",))
        for n, k in grid:
            pts = jnp.asarray(points(n), jnp.float32)
            t0 = time.perf_counter()
            run = make_distributed_partitioner(mesh, BKMConfig(k=k,
                                                               epsilon=EPS))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                out = run(pts, jnp.ones(n, jnp.float32))
            imb = float(out[5])
            print(f"reference P={P} n={n} k={k}: imbalance {imb:.6f}, "
                  f"{time.perf_counter() - t0:.1f} s (JAX on the CPU)",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[1 << 16, 1 << 18, 1 << 20, 1 << 22])
    ap.add_argument("--k", type=int, nargs="+", default=[64, 256, 1024])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", action="store_true",
                    help="run the JAX package's partitioner on the CPU")
    args = ap.parse_args()
    grid = [(n, k) for n in args.n for k in args.k]
    if args.reference:
        reference_grid(grid, args.devices)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist import launch
    print(card_line() if args.device == "cuda" else args.device, flush=True)
    for P in args.devices:
        for line in launch.launch(port_grid, P, args=(grid, args.device),
                                  device=args.device, timeout=1800):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
