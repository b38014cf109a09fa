"""The general traffic driver: set-up, the measured window and the check
of what the window produced, for any configuration and traffic mix named
in ``BENCHMARK.json``.

A traffic file (``traffic/<name>.json``) is data. Every mix has
``"kind"`` (the module of ``kinds/`` that drives it), ``"why"``,
``"metric"`` (the end-to-end metric the window reports), ``"warmup"``
(calls or steps run in set-up), ``"check"`` (how many units of the
window the check samples, drawn from the seed) and ``"limits"`` (the
limit of each compared number; ``"epsilon"`` is the configuration's);
its other keys are its kind's parameters.

The program is called as its users call it: ``repro_torch.partition``'s
front doors, on numpy arrays in a ``PartitionProblem``. Every timed call
ends in a device synchronize; its wall time is the host clock around it.
"""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.inputs import Inputs, stream_seed
from portbench.spec import plugin, refuse_unread
from portbench.trace import CALL, WINDOW

TRAFFIC_KEYS = ("kind", "why", "metric", "warmup", "check", "limits")
# what the driver and the inputs act on, and what only describes the
# deployment for its reader
CONFIG_KEYS = ("points", "weights", "k", "epsilon", "method", "options",
               "control")
DESCRIBES = ("name", "deployment", "source", "assumed", "reduced")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@dataclass
class Window:
    """What one measured window did: a record per timed call (or warm
    step), its total wall time, and the answers kept for the check."""
    calls: list = field(default_factory=list)
    wall_s: float = 0.0
    kept: list = field(default_factory=list)     # sampled answers
    units: int = 0                                # calls or episodes
    start_ns: int = 0          # perf_counter_ns as the window's span began


class Cell:
    """One configuration under one traffic mix on one device. ``control``
    runs the configuration's lower-precision control in the program's
    place."""

    def __init__(self, config: dict, traffic: dict, device, *,
                 control: bool = False, spans: bool = False):
        refuse_unread(f"configuration {config.get('name')!r}", config,
                      CONFIG_KEYS + DESCRIBES)
        self.kind = plugin("kinds", traffic["kind"])
        refuse_unread(f"traffic kind {traffic['kind']!r}", traffic,
                      TRAFFIC_KEYS + self.kind.KEYS)
        self.config, self.traffic = config, traffic
        self.dev = torch.device(device)
        self.spans = spans
        self.opts = dict(config.get("options", {}))
        if control:
            self.opts.update(config["control"])
        from repro_torch.kernels import ops
        from repro_torch.partition import (PartitionProblem,
                                           PartitionResult, partition,
                                           repartition)
        self._ops = ops
        self.Problem = PartitionProblem
        self.Result = PartitionResult
        self._partition = partition
        self._repartition = repartition
        self.warm = False

    # -- the program, called as a user calls it -------------------------

    def problem(self, **arrays):
        c = self.config
        return self.Problem(k=c["k"], epsilon=c["epsilon"], **arrays)

    def timed(self, fn):
        """(result, wall seconds, kernel sweeps) of ``fn()``: launch
        counters reset just before, read just after a synchronize."""
        _sync(self.dev)
        self._ops.reset_launch_counts()
        with _span(CALL, self.spans):
            t0 = time.perf_counter()
            res = fn()
            _sync(self.dev)
            wall = time.perf_counter() - t0
        counts = self._ops.launch_counts()
        sweeps = sum(v for name, v in counts.items()
                     if name.startswith("assign_")
                     and not name.endswith("_plain"))
        return res, wall, sweeps

    def partition(self, problem, refine: bool = False):
        return self.timed(lambda: self._partition(
            problem, self.config["method"], device=self.dev,
            refine=True if refine else None, **self.opts))

    def repartition(self, problem, previous):
        return self.timed(lambda: self._repartition(
            problem, previous, self.config["method"], device=self.dev,
            **self.opts))

    # -- set-up, window, check ------------------------------------------

    def setup(self, seed: int) -> None:
        """Inputs of ``seed``; the program warmed up on this traffic's
        shapes (once a process)."""
        self.seed = seed
        self.inputs = Inputs(self.config, seed, self.dev)
        self.kind.setup(self)
        self.warm = True

    def window(self, seconds: float) -> Window:
        """Timed units (calls, or whole episodes) until their wall time
        reaches ``seconds``; at least one. The check's sample is drawn
        from the seed as the window goes (reservoir sampling), so only the
        sampled answers are kept."""
        win = Window()
        rng = np.random.default_rng(stream_seed(self.seed, -1000))
        size = self.traffic.get("check", 1)
        with _span(WINDOW, self.spans):
            win.start_ns = time.perf_counter_ns()
            while win.units == 0 or win.wall_s < seconds:
                recs, unit = self.kind.unit(self, win.units)
                win.calls.extend(recs)
                win.wall_s += sum(r["wall"] for r in recs)
                if len(win.kept) < size:
                    win.kept.append(unit)
                else:
                    slot = int(rng.integers(0, win.units + 1))
                    if slot < size:
                        win.kept[slot] = unit
                win.units += 1
        return win

    def check(self, win: Window) -> dict:
        """Each compared number's worst value over the sampled answers and
        its limit: {name: {"value": v, "limit": l}}, and the count of
        checked calls or steps that failed a limit."""
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        rows = [row for a in win.kept for row in self.kind.check(self, a)]
        limits = self.limits()
        worst = {name: max(r[name] for r in rows) for name in limits}
        failed = sum(any(r[name] > limits[name] for name in limits)
                     for r in rows)
        return {"numbers": {name: {"value": worst[name],
                                   "limit": limits[name]}
                            for name in limits},
                "failed": failed, "checked": len(rows)}

    def limits(self) -> dict:
        out = {}
        for name, limit in self.traffic["limits"].items():
            out[name] = self.config["epsilon"] if limit == "epsilon" \
                else float(limit)
        return out


def solver_stats(stats: dict) -> dict:
    """The solve's own spans and counts from ``result.stats``."""
    level = (stats.get("levels") or [{}])[0]
    out = {}
    seconds = level.get("seconds")
    if seconds:
        out["bootstrap_s"] = float(seconds["bootstrap"])
        out["kmeans_s"] = float(seconds["kmeans"])
    if "iters" in level:
        out["iters"] = int(level["iters"])
    return out
