"""What a configuration's deployment hands the partitioner, made from the
run's seed on the device and handed over as numpy arrays, as a simulation
code holds them.

A configuration file (``configs/<name>.json``) names its point set under
``"points": {"kind": ...}`` (a module of ``pointsets/``) and its weights
under ``"weights": {"kind": ...}`` (a module of ``weights/``). Every draw
comes from a ``torch.Generator`` on the device seeded from (the run's
seed, the call's index), so a seed gives the same inputs on every run and
the reference can make them again after the window.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.spec import plugin, refuse_unread


def stream_seed(seed: int, index: int) -> int:
    """A 63-bit seed for draw ``index`` of run ``seed`` (any integers)."""
    state = np.random.SeedSequence([seed % 2**64, index % 2**64])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator_module(package: str, spec: dict, what: str):
    """The ``package`` module of ``spec["kind"]``, refusing a parameter
    that it does not read."""
    mod = plugin(package, spec["kind"])
    refuse_unread(what, {k: v for k, v in spec.items() if k != "kind"},
                  mod.KEYS)
    return mod


class Inputs:
    """The point sets, graph and weights of one configuration."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        self.points_spec = config["points"]
        self.weights_spec = config["weights"]
        self.seed = seed
        self.device = device
        self._points = generator_module("pointsets", self.points_spec,
                                        f"{config['name']} points")
        self._weights = generator_module("weights", self.weights_spec,
                                         f"{config['name']} weights")
        self.n, self.d = self._points.size(self.points_spec)
        self._graph = None

    def generator(self, index: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, index))
        return gen

    def points(self, index: int) -> torch.Tensor:
        """[n, d] float64 on the device: the point set of call ``index``."""
        return self._points.points(self.points_spec, self.generator(index),
                                   self.device)

    def weights(self, points: torch.Tensor, index: int):
        """[n] float32 on the device: the configuration's weights of call
        ``index``; None for unit weights."""
        return self._weights.weights(self.weights_spec, points, 0,
                                     self.generator(-1 - index))

    def graph(self):
        """(indptr, indices) int64 numpy of the mesh, made once on the
        device; None for a point set without one."""
        if self._graph is None:
            g = self._points.graph(self.points_spec, self.device)
            self._graph = (False if g is None else
                           tuple(a.cpu().numpy() for a in g))
        return self._graph or None

    def problem_arrays(self, index: int) -> dict:
        """Keyword arrays of a ``PartitionProblem`` for call ``index``:
        points, weights (and the graph) as numpy, and the per-call
        permutation seed."""
        pts = self.points(index)
        w = self.weights(pts, index)
        out = {"points": pts.cpu().numpy(),
               "weights": None if w is None else w.cpu().numpy(),
               "seed": stream_seed(self.seed, index) % 2**32}
        graph = self.graph()
        if graph is not None:
            out["indptr"], out["indices"] = graph
        return out
