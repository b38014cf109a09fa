#!/usr/bin/env python3
"""Label agreement of the port's sharded solve on the card against the
same solve on CPU ranks, and of the single-device solve on the card
against the CPU, run on a machine with an H100 from the root of a
checkout::

    python3 tools/sharded_agreement.py                     # the defaults
    python3 tools/sharded_agreement.py --k 64 1024 --devices 1 2 4

Instances: the first ``--n`` points of the main cell (uniform [0, 1)^3
from seed 0, n = 2^22) and uniform points from each ``--seeds`` seed, cut
into each ``--k`` blocks with ``warmup=False``. For every instance it
prints, single-device and for each P of ``--devices`` (P ranks sharing
the card over gloo, NCCL at P = 1; CPU ranks as threads over gloo), the
fraction of equal labels, the movement iterations, the sweeps and the
imbalance of both sides, and the agreement of the card's sharded labels
with its own single-device labels. It gates nothing: it measures how far
float sums taken in another order move the labels.

Near-ties. For every point whose labels differ between the card (block
a) and the CPU (block b), each side's final centers and influence give
its effective distances to both blocks, ``|p - c|^2 / influence^2`` in
float64; the side's relative gap is ``|e(a) - e(b)| / max(e(a), e(b))``.
A point is a near-tie under a relative threshold when the gaps of both
sides are within it. Each card / CPU line is followed by the gaps'
quantiles, the agreement with the near-ties exempt at ``--tie-rtol`` (and
at a tenth and ten times it), and how far the two sides' final states
lie apart (the largest center shift over the mean block radius, the
largest relative influence difference). Two controls follow: the same
near-tie line for the CPU's own single-device solve against its own
ranks (sums in another order, no card), and the card's ranks against the
CPU's after one movement iteration (``max_iter=1``), where the states
differ only by the rounding of the sharded sums.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sweeps(res) -> int:
    st = res.stats["levels"][0]
    it = int(st["iters"])
    return int(round(float(st["history"]["balance_iters"][:it].sum()))
               + int(st["final_balance_iters"]))


def row(tag, a, b) -> str:
    import numpy as np
    return (f"{tag}: agree {float(np.mean(a.labels == b.labels)):.4f}, "
            f"iters {int(a.stats['levels'][0]['iters'])} / "
            f"{int(b.stats['levels'][0]['iters'])}, sweeps {sweeps(a)} / "
            f"{sweeps(b)}, imbalance {a.imbalance():.5f} / "
            f"{b.imbalance():.5f}")


def effective(points, res, blocks):
    """[m] float64 effective distance of each point to its block."""
    import numpy as np
    c = np.asarray(res.centers, np.float64)[blocks]
    infl = np.asarray(res.influence, np.float64)[blocks]
    return np.sum((points - c) ** 2, axis=1) / infl ** 2


def near_ties(tag, points, a, b, rtol) -> str:
    """The near-tie line of two results of one problem (a: the card's)."""
    import numpy as np
    points = np.asarray(points, np.float64)
    diff = np.nonzero(a.labels != b.labels)[0]
    n = len(a.labels)
    ca = np.asarray(a.centers, np.float64)
    cb = np.asarray(b.centers, np.float64)
    # mean block radius: the rms distance of a block's points to its center
    r = np.sqrt(np.mean(np.sum((points - ca[a.labels]) ** 2, axis=1)))
    shift = float(np.max(np.linalg.norm(ca - cb, axis=1))) / r
    ia = np.asarray(a.influence, np.float64)
    ib = np.asarray(b.influence, np.float64)
    dinfl = float(np.max(np.abs(ia - ib) / np.abs(ib)))
    apart = (f"states apart: center shift {shift:.3g} of the mean block "
             f"radius, influence {dinfl:.3g}")
    if not len(diff):
        return f"{tag}: no disagreements; {apart}"
    p = points[diff]
    la, lb = a.labels[diff], b.labels[diff]
    gaps = []
    for res in (a, b):
        ea, eb = effective(p, res, la), effective(p, res, lb)
        gaps.append(np.abs(ea - eb) / np.maximum(np.maximum(ea, eb),
                                                 1e-300))
    gap = np.maximum(*gaps)
    q = np.quantile(gap, [0.5, 0.9, 1.0])
    exempt = ", ".join(
        f"{np.mean(a.labels == b.labels) + np.sum(gap <= t) / n:.4f} at "
        f"rtol {t:g} ({int(np.sum(gap <= t))} of {len(diff)} exempt)"
        for t in (rtol / 10, rtol, rtol * 10))
    return (f"{tag}: {len(diff)} disagreeing points, relative gap median "
            f"{q[0]:.3g}, 90% {q[1]:.3g}, max {q[2]:.3g}; agreement with "
            f"near-ties exempt {exempt}; {apart}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--k", type=int, nargs="+", default=[64])
    ap.add_argument("--seeds", type=int, nargs="*", default=[21])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--tie-rtol", type=float, default=1e-3,
                    help="relative gap under which a disagreeing point is "
                    "a near-tie (the tool also prints a tenth and ten "
                    "times it)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sharded_agreement: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist import launch
    from repro_torch.partition import PartitionProblem, partition
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    main_pts = np.random.default_rng(0).uniform(0.0, 1.0, (1 << 22, 3))
    instances = [("main cell prefix", main_pts[:args.n], 0)]
    instances += [(f"seed {s}", np.random.default_rng(s).uniform(
        0.0, 1.0, (args.n, 3)), s) for s in args.seeds]
    for name, pts, seed in instances:
        for k in args.k:
            prob = PartitionProblem(points=pts, k=k, seed=seed)
            tag = f"{name} n={args.n} k={k} warmup=False"
            gpu = partition(prob, warmup=False)
            cpu = partition(prob, warmup=False, device="cpu")
            print(row(f"{tag}, single device, card / CPU", gpu, cpu),
                  flush=True)
            print(near_ties(f"{tag}, single device, near-ties", pts, gpu,
                            cpu, args.tie_rtol), flush=True)
            for P in args.devices:
                on_card = partition(prob, devices=P, warmup=False)
                on_cpu = launch.launch(
                    partition, P, args=(prob,),
                    kwargs={"device": "cpu", "devices": P,
                            "warmup": False},
                    device="cpu", threads=True, timeout=900)
                print(row(f"{tag}, devices={P} "
                          f"({on_card.stats['backend']}), card / CPU",
                          on_card, on_cpu), flush=True)
                print(near_ties(f"{tag}, devices={P}, near-ties", pts,
                                on_card, on_cpu, args.tie_rtol), flush=True)
                print(near_ties(f"{tag}, devices={P}, CPU ranks / CPU "
                                "single device (control)", pts, on_cpu, cpu,
                                args.tie_rtol), flush=True)
                first = [partition(prob, devices=P, warmup=False,
                                   max_iter=1)]
                first.append(launch.launch(
                    partition, P, args=(prob,),
                    kwargs={"device": "cpu", "devices": P, "warmup": False,
                            "max_iter": 1},
                    device="cpu", threads=True, timeout=900))
                print(near_ties(f"{tag}, devices={P}, one movement "
                                "iteration, card / CPU", pts, *first,
                                args.tie_rtol), flush=True)
                print(row(f"{tag}, devices={P} card / single card",
                          on_card, gpu), flush=True)
    print(f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
