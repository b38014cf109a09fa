"""Data pipeline (reference: ``repro/data/pipeline.py``): synthetic token,
codebook and embedding streams, and SFC-locality ordering.

Host numpy, as in the reference, and bit-equal to it: each batch ``i``
comes from ``np.random.default_rng((seed, i))`` drawn in the reference's
order. Batches stay numpy arrays; the trainer moves each one to the
state's device. A one-deep background ``Prefetcher`` overlaps batch
production with the step.

``sfc_batch_order`` orders examples along a Hilbert curve (the paper's
redistribution key, ``core.sfc.hilbert_index_np``), so that consecutive
batches touch nearby data.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.core.sfc import hilbert_index_np


class SyntheticLM:
    """Markov-chain token stream: cheap, deterministic, learnable.

    Tokens follow ``t' = (a * t + b + eta) mod V`` with small noise, so a
    model can bring its loss well below the uniform entropy within a few
    hundred steps. Infinite; batch ``i`` depends only on (seed, i)."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def _tokens(self, rng, shape):
        V = self.cfg.vocab_size
        a, b = 31, 7
        t = rng.integers(0, V, size=shape[:-1] + (1,))
        cols = [t]
        for _ in range(shape[-1] - 1):
            noise = rng.integers(0, 3, size=t.shape)
            t = (a * t + b + noise) % V
            cols.append(t)
        return np.concatenate(cols, axis=-1).astype(np.int32)

    def __iter__(self):
        i = 0
        while True:
            rng = np.random.default_rng((self.seed, i))
            cfg = self.cfg
            B, S = self.batch, self.seq
            if cfg.input_mode == "tokens":
                toks = self._tokens(rng, (B, S + 1))
                batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            elif cfg.input_mode == "codebooks":
                toks = np.stack([self._tokens(rng, (B, S + 1))
                                 for _ in range(cfg.n_codebooks)], axis=-1)
                batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            else:  # embeddings (modality stub): random patch embeddings
                emb = rng.standard_normal((B, S, cfg.d_model)).astype(
                    np.float32)
                lab = self._tokens(rng, (B, S))
                batch = {"embeddings": emb, "labels": lab}
            yield batch
            i += 1


def sfc_batch_order(coords: np.ndarray, batch: int):
    """Order examples along a Hilbert curve.

    ``coords``: [n, d] (d in {2, 3}) coordinates of each example. Returns
    (``[n // batch, batch]`` indices, each row a spatially compact batch;
    the ``n % batch`` indices left over)."""
    keys = hilbert_index_np(coords)
    order = np.argsort(keys, kind="stable")
    n_full = (len(order) // batch) * batch
    return order[:n_full].reshape(-1, batch), order[n_full:]


class Prefetcher:
    """Background prefetch of up to ``depth`` items of ``it``.

    The producer thread ends the stream with a sentinel whether ``it``
    is exhausted or raises: an exception in the producer ends the
    iteration with ``StopIteration`` (as the reference's ``finally``
    does), and is not re-raised."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for x in self._it:
                self._q.put(x)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x
