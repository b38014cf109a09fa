"""Faults planted in the program's timed path underneath the harness, for
the tests and readings that show the comparison deciding ``correct``
fails where it must. ``FAULTS[name]()`` patches the program in
this process; a traffic kind's ``faults(traffic)`` lists the ones its
cells can have (no cell has an exchange between chips).
"""
from __future__ import annotations

import importlib


def _alter_labels(labels, k):
    """Every 7th answer moved to the next block, where it is produced."""
    import numpy as np
    out = np.array(labels, copy=True)
    out[::7] = (out[::7] + 1) % k
    return out


def _refine_module():
    return importlib.import_module("repro_torch.partition.refine")


def fault_altered():
    """The answer altered where it is produced: the solve's labels where
    the solver hands them back, the refined labels where the rounds end."""
    from repro_torch.core import partitioner
    orig = partitioner._labels

    def broken(A, perm):
        labels = orig(A, perm)
        return _alter_labels(labels, int(labels.max()) + 1)
    partitioner._labels = broken
    refine = _refine_module()
    orig_rounds = refine._lp_rounds

    def altered_rounds(labels, indptr, indices, iw, keys, k, *args, **kw):
        out = orig_rounds(labels, indptr, indices, iw, keys, k, *args, **kw)
        return (_alter_labels(out[0], k),) + tuple(out[1:])
    refine._lp_rounds = altered_rounds


def fault_half():
    """Half of the points left out of the solve: its moments and balance
    are taken over the other half only."""
    import torch
    from repro_torch.core import balanced_kmeans, partitioner
    orig = balanced_kmeans.balanced_kmeans

    def broken(points, cfg, weights=None, *args, **kwargs):
        n = points.shape[0]
        w = (torch.ones(n, dtype=points.dtype, device=points.device)
             if weights is None else weights.clone())
        w[n // 2:] = 0.0
        return orig(points, cfg, w, *args, **kwargs)
    partitioner.balanced_kmeans = broken


def fault_frozen():
    """The solve returns its state as it came in: the centers never move
    (no movement iteration), while the balance loop runs at its default,
    so the labels agree with the centers and are balanced. A cold solve
    keeps the bootstrap's centers, a warm one the previous step's."""
    from dataclasses import replace

    from repro_torch.core import partitioner
    orig = partitioner.balanced_kmeans

    def frozen(points, cfg, *args, **kwargs):
        return orig(points, replace(cfg, max_iter=0), *args, **kwargs)
    partitioner.balanced_kmeans = frozen


def fault_unchanged():
    """The refinement returns its state as it came in: the rounds hand
    back their input labels."""
    refine = _refine_module()
    orig_rounds = refine._lp_rounds

    def no_rounds(labels, *args, **kwargs):
        out = orig_rounds(labels, *args, **kwargs)
        return (labels,) + tuple(out[1:])
    refine._lp_rounds = no_rounds


FAULTS = {"altered": fault_altered, "half": fault_half,
          "frozen": fault_frozen, "unchanged": fault_unchanged}

