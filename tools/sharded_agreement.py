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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--k", type=int, nargs="+", default=[64])
    ap.add_argument("--seeds", type=int, nargs="*", default=[21])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
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
                print(row(f"{tag}, devices={P} card / single card",
                          on_card, gpu), flush=True)
    print(f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
