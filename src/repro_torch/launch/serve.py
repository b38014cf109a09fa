"""Serving driver: ``python -m repro_torch.launch.serve [--device cpu]``.

Initializes random parameters for the smoke config of ``--arch`` from a
seeded ``torch.Generator``, admits a batch of synthetic requests and
decodes them through the batched ``ServeEngine`` (reference:
``repro/launch/serve.py``, with the same flags and default arch plus
``--device``). Runs on the card unless ``--device cpu``. Codebook archs
get ``[prompt_len, n_codebooks]`` prompts; an embeddings arch exits, as
the reference's driver does.

``--data-parallel D --model-parallel M`` serves over a ``(D, M)`` mesh of
ranks (``launch.mesh.make_host_mesh(D, M)``): each rank makes only its
shards of the parameters (``models.model.init_params(..., rules=)``,
bit-equal to ``shard_params`` of the whole: heads, ``mlp``, experts and
vocabulary over ``model``, Mamba's channels and RWKV's heads) and holds
its data rows of the batch, and every rank prints nothing but rank 0. Called inside a rank of D x M
(``torchrun --nproc-per-node D*M -m repro_torch.launch.serve ...``, or a
``dist.launch`` rank) it serves on that rank; called outside one, it
launches D x M ranks on ``--device`` (processes: ranks sharing one card
reduce over gloo, ranks with a card each over NCCL), each running the
same command, and returns rank 0's transcripts.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.dist import current, launch
from repro_torch.dist.rules import resolve_rules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    """Parse ``argv`` (default: the command line), serve, print; returns
    the requests' transcripts (rank 0's when it launched the ranks)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = make_host_mesh(args.data_parallel, args.model_parallel,
                          device=args.device)
    if mesh.size > 1 and current() is None:
        return launch.launch(_rank_main, mesh.size, args=(list(
            argv if argv is not None else sys.argv[1:]),),
            device=args.device)
    dev = resolve_device(args.device)
    comm = mesh.comm
    if comm is not None:        # a rank (torchrun's too) on its own card
        dev = launch.rank_device(mesh.device, comm.rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_host_mesh(args.data_parallel, args.model_parallel,
                              device=dev)
    cfg = configs.get_config(args.arch, smoke=True)
    if cfg.input_mode == "embeddings":
        raise SystemExit("VLM stub serves via precomputed embeddings; "
                         "use a token arch for this driver")
    rules = resolve_rules(mesh, cfg, "decode", batch_size=args.batch,
                          overrides=configs.sharding_overrides(
                              args.arch, "decode"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, device=dev, rules=rules)
    engine = ServeEngine(cfg, rules, params, batch=args.batch,
                         max_seq=args.max_seq)
    rng = np.random.default_rng(0)
    shape = ((args.prompt_len,) if cfg.input_mode == "tokens"
             else (args.prompt_len, cfg.n_codebooks))
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, shape)
                    .astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    if comm is None or comm.rank == 0:
        n_tok = sum(len(r.out) for r in reqs)
        for r in reqs[:3]:
            print(f"req {r.uid}: {r.out[:10]} ...")
        where = dev if comm is None else \
            f"{mesh.shape} ranks on {dev.type}"
        print(f"{len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
              f"({n_tok / dt:.1f} tok/s host-loop) on {where}", flush=True)
    return [r.out for r in reqs]


def _rank_main(argv):
    """Body of a rank that ``main`` launched: the same command on the
    rank; its transcripts."""
    return main(argv)


if __name__ == "__main__":
    main()
