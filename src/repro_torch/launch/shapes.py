"""Assigned input-shape cells and abstract input specs (reference:
``repro/launch/shapes.py``).

* ``train_4k``    -> train_step   (tokens + labels, global batch 256, S=4096)
* ``prefill_32k`` -> prefill      (forward + cache, B=32, S=32768)
* ``decode_32k``  -> serve_step   (one token, B=128, KV cache of 32768)
* ``long_500k``   -> serve_step   (one token, B=1, context 524288;
                                   sub-quadratic archs only)

``input_specs`` returns the cell's batch as ``meta`` tensors (shapes and
dtypes, no storage) in the arch's modality: tokens, EnCodec codebooks or
precomputed patch embeddings; with ``rules``, the batch a rank is handed
(``BATCH_ARGUMENT``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.dist.rules import local_range

#: the batch argument of a rank's step, by mode: the train step is handed
#: the global batch and deals itself its rows (``train.step``), the serve
#: step all B rows, of which it decodes its own (``serve.engine``); a
#: prefill is handed the rank's own rows. The reference's jitted steps
#: take each the rows' shard.
BATCH_ARGUMENT = {"train": "global", "prefill": "rank rows",
                  "decode": "global", "long_decode": "global"}


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    mode: str                     # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "long_decode"),
}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok_spec(cfg, B, S):
    if cfg.input_mode == "codebooks":
        return _meta((B, S, cfg.n_codebooks), torch.int32)
    if cfg.input_mode == "embeddings":
        return _meta((B, S, cfg.d_model), cfg.act_dtype)
    return _meta((B, S), torch.int32)


def _label_spec(cfg, B, S):
    if cfg.input_mode == "codebooks":
        return _meta((B, S, cfg.n_codebooks), torch.int32)
    return _meta((B, S), torch.int32)


def input_specs(cfg, cell: ShapeCell, rules=None) -> dict:
    """Abstract batch of the cell's step function; with ``rules``, as the
    rank is handed it (``BATCH_ARGUMENT``: a prefill's rows are the
    rank's ``act_batch`` range)."""
    B, S = cell.batch, cell.seq
    if BATCH_ARGUMENT[cell.mode] == "rank rows":
        b0, b1 = local_range(rules, "act_batch", B)
        B = b1 - b0
    key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
    if cell.mode == "train":
        return {key: _tok_spec(cfg, B, S), "labels": _label_spec(cfg, B, S)}
    if cell.mode == "prefill":
        return {key: _tok_spec(cfg, B, S)}
    # decode cells: one new token; the cache (built apart) carries S
    return {key: _tok_spec(cfg, B, 1)}


def batch_logical_specs(cfg, cell: ShapeCell) -> dict:
    """Logical axes of the batch tree (resolved by ``dist.rules``)."""
    tok = (("act_batch", None, None) if cfg.input_mode in
           ("codebooks", "embeddings") else ("act_batch", None))
    lab = (("act_batch", None, None) if cfg.input_mode == "codebooks"
           else ("act_batch", None))
    key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
    if cell.mode == "train":
        return {key: tok, "labels": lab}
    return {key: tok}
