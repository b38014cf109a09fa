"""Serving: the single-token ``serve_step`` factory and the batched
request engine (reference: ``repro/serve/engine.py``).

``make_serve_step`` builds the one-token greedy decode: logits from the
KV-cache decode path, padded vocab masked with -inf, argmax (one token a
codebook for musicgen-style configs). PyTorch runs it eagerly; there is
nothing to compile. ``ServeEngine`` admits requests into fixed slots,
prefills each slot's cache by stepping the shared position-aligned decode
path over the prompt, and masks finished rows: the reference's static
batching, round for round. Codebook prompts are ``[P, n_codebooks]`` and
a transcript holds codebook 0, as the reference's does. An
``embeddings``-mode config has no token table to feed its outputs back
through: it is served by ``make_serve_step`` with embedding inputs, and
``ServeEngine.run`` raises for it (the reference's engine fails on it too).

Over a ``(data, model)`` mesh of ranks (``rules``; every rank runs the
same host loop over all B slots): a rank holds ``models.model.
shard_params``' shards and its own cache, and decodes its data rows
``[d*B/D, (d+1)*B/D)`` (all of them where ``act_batch`` does not divide
B); the next tokens and the logits are all-gathered over ``data``, so
every request's transcript is the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.dist.rules import gather_split, local_range
from repro_torch.models import model as M


def make_serve_step(cfg, rules=None, sample: str = "greedy",
                    unroll: bool = False):
    """Returns serve_step(params, cache, tokens, pos) ->
    (next_tokens [B,1] (or [B,1,n_codebooks]) int32, cache, logits);
    ``tokens`` is the [B,1,D] embeddings batch of an ``embeddings``-mode
    config. ``tokens`` holds all B rows; ``params`` and ``cache`` are the
    rank's (``M.shard_params``, ``M.init_cache`` with ``rules``); the
    next tokens and the logits come back whole on every rank.

    Only greedy decoding exists. The reference accepts any ``sample`` and
    decodes greedily all the same; the port raises ``ValueError`` for
    anything but ``"greedy"`` instead, on purpose, so that a caller who
    asks for sampling is not handed argmax tokens silently."""
    if sample != "greedy":
        raise ValueError(f"sample={sample!r}: only greedy is implemented")

    key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"

    def serve_step(params, cache, tokens, pos):
        B = tokens.shape[0]
        b0, b1 = local_range(rules, "act_batch", B)
        logits, new_cache = M.decode_step(params, cache,
                                          {key: tokens[b0:b1]}, pos, cfg,
                                          rules, unroll=unroll)
        logits = gather_split(logits, rules, "act_batch", B, 0)
        lf = logits.float()
        if cfg.vocab_size < cfg.vocab_padded:
            pad = torch.arange(cfg.vocab_padded,
                               device=lf.device) >= cfg.vocab_size
            lf = torch.where(pad, float("-inf"), lf)
        nxt = torch.argmax(lf, dim=-1).to(torch.int32)
        return nxt, new_cache, logits

    return serve_step


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # [P] (or [P, n_codebooks])
    max_new: int = 16
    eos_id: int | None = None
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Batched greedy decoding over fixed slots (static shapes).

    Rounds: admit up to B requests; all slots share the step position;
    shorter prompts emit pad tokens that are masked out of their
    transcript. Decode proceeds until every admitted request hit
    ``max_new`` or EOS. Runs on the device that holds ``params``."""

    def __init__(self, cfg, rules, params, batch: int, max_seq: int,
                 pad_id: int = 0):
        self.cfg = cfg
        self.rules = rules
        self.params = params
        self.B = batch
        self.max_seq = max_seq
        self.pad_id = pad_id
        self.device = next(M._leaves(params)).device
        self.step_fn = make_serve_step(cfg, rules)

    def _fresh_cache(self):
        return M.init_cache(self.cfg, self.B, self.max_seq, self.rules,
                            device=self.device)

    def run(self, requests: list[Request]) -> list[Request]:
        if self.cfg.input_mode == "embeddings":
            raise ValueError(
                f"{self.cfg.name}: an embeddings-mode config takes no token "
                "prompts; serve it through make_serve_step with [B, 1, "
                "d_model] embeddings")
        for base in range(0, len(requests), self.B):
            self._run_group(requests[base:base + self.B])
        return requests

    def _run_group(self, group: list) -> None:
        B = self.B
        plens = [len(r.prompt) for r in group]
        pmax = max(plens)
        shape = (B, pmax) if self.cfg.input_mode != "codebooks" else \
            (B, pmax, self.cfg.n_codebooks)
        toks = np.full(shape, self.pad_id, np.int32)
        for i, r in enumerate(group):
            toks[i, :plens[i]] = r.prompt
        toks = torch.from_numpy(toks).to(self.device)
        cache = self._fresh_cache()
        params = self.params
        # prefill by stepping the decode path over the prompt
        assert pmax >= 1, "empty prompts unsupported"
        cur = None
        for p in range(pmax):
            cur, cache, _ = self.step_fn(params, cache, toks[:, p:p + 1], p)
        max_new = max(r.max_new for r in group)
        done = np.zeros(B, bool)
        for t in range(max_new):
            pos = pmax + t
            if pos >= self.max_seq:
                break
            host = cur.cpu().numpy()
            for i, r in enumerate(group):
                if not done[i] and t < r.max_new:
                    tok_val = int(host[i].reshape(-1)[0])
                    r.out.append(tok_val)
                    if r.eos_id is not None and tok_val == r.eos_id:
                        done[i] = True
                elif t >= r.max_new:
                    done[i] = True
            if done.all():
                break
            cur, cache, _ = self.step_fn(params, cache, cur, pos)
        for r in group:
            r.done = True
