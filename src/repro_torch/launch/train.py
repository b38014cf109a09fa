"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--device cpu] [...]`` (reference: ``repro/launch/train.py``, with the
same flags plus ``--device``).

Trains the smoke config of ``--arch`` by default (``--full``: its
``CONFIG``) on ``SyntheticLM`` batches through ``Trainer.fit``, on the
card unless ``--device cpu``, with checkpoints and resume under
``--ckpt-dir``. As in the reference, a resumed run replays the data
stream from batch 0 (ROADMAP.md queue 3 item 21).

``--data-parallel D --model-parallel M`` trains over a ``(data,
model)`` mesh of D x M ranks (``launch.mesh.make_host_mesh(D, M)``: the
batch's rows over ``data``, heads, channels, experts and the vocabulary
over ``model``): called inside a rank of D x M (``torchrun
--nproc-per-node D*M -m repro_torch.launch.train ...``, or a
``dist.launch`` rank), it trains on that rank; called outside one, it
launches D x M ranks on ``--device`` (``dist.launch``: processes; ranks
sharing one card reduce over gloo, ranks with a card each over NCCL) and
each runs the same command. Rank 0 prints what a one-rank run prints,
with the mesh's shape.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import current, launch
from repro_torch.dist.rules import resolve_rules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import Trainer, TrainerConfig, TrainHParams


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, print the last
    metrics; returns (trainer, history). With a mesh of several ranks
    (``--data-parallel``, ``--model-parallel``) called outside a rank,
    the ranks' trainers stay in their processes: returns (None, rank 0's
    history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="production config (default: smoke config)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = make_host_mesh(args.data_parallel, args.model_parallel,
                          device=args.device)
    if mesh.size > 1 and current() is None:
        history = launch.launch(_rank_main, mesh.size, args=(list(
            argv if argv is not None else sys.argv[1:]),),
            device=args.device)
        return None, history
    if mesh.size > 1:           # a rank (torchrun's too) on its own card
        dev = launch.rank_device(mesh.device, mesh.comm.rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_host_mesh(args.data_parallel, args.model_parallel,
                              device=dev)
    cfg = configs.get_config(args.arch, smoke=not args.full)
    rules = resolve_rules(mesh, cfg, "train", batch_size=args.batch,
                          overrides=configs.sharding_overrides(
                              args.arch, "train"))
    hp = TrainHParams(microbatches=args.microbatches,
                      lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps,
                      grad_compress=args.grad_compress)
    tc = TrainerConfig(steps=args.steps, log_every=args.log_every,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, rules, hp, tc)
    data = SyntheticLM(cfg, args.batch, args.seq)
    _, history = trainer.fit(iter(data))
    comm = mesh.comm
    if comm is None or comm.rank == 0:
        print(json.dumps(history[-3:], indent=1))
        where = trainer.device if comm is None else (
            f"{args.data_parallel} data ranks x {args.model_parallel} model "
            f"ranks (mesh {mesh.shape}) on {trainer.device}")
        print(f"final loss: {history[-1]['loss']:.4f} on {where}",
              flush=True)
    return trainer, history


def _rank_main(argv):
    """Body of a rank that ``main`` launched: the same command on the
    rank; its history."""
    return main(argv)[1]


if __name__ == "__main__":
    main()
