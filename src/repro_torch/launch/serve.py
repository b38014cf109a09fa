"""Serving driver: ``python -m repro_torch.launch.serve [--device cpu]``.

Initializes random parameters for the smoke config of ``--arch`` from a
seeded ``torch.Generator``, admits a batch of synthetic requests and
decodes them through the batched ``ServeEngine`` (reference:
``repro/launch/serve.py``, with the same flags and default arch plus
``--device``). Runs on the card unless ``--device cpu``. Codebook archs
get ``[prompt_len, n_codebooks]`` prompts; an embeddings arch exits, as
the reference's driver does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, smoke=True)
    if cfg.input_mode == "embeddings":
        raise SystemExit("VLM stub serves via precomputed embeddings; "
                         "use a token arch for this driver")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, device=dev)
    engine = ServeEngine(cfg, None, params, batch=args.batch,
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
    n_tok = sum(len(r.out) for r in reqs)
    for r in reqs[:3]:
        print(f"req {r.uid}: {r.out[:10]} ...")
    print(f"{len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s host-loop) on {dev}")


if __name__ == "__main__":
    main()
