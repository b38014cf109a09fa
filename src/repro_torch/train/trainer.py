"""Fault-tolerant training loop (reference: ``repro/train/trainer.py``).

* resumes from the latest complete checkpoint (manifest-validated),
  restoring into ``abstract_train_state`` (``meta`` tensors) on the
  device: no random init of the state that the checkpoint replaces, and
  no second copy of it;
* periodic and final checkpoints, and a save on ``KeyboardInterrupt`` or
  ``SystemExit`` before re-raising (preemption);
* a one-deep host prefetch of the (numpy) batches, each moved to the
  state's device;
* metrics kept on the host every ``log_every`` steps, with ``wall_s``.

The loop owns no model logic: it drives ``train.step.make_train_step``,
whose step updates the state's tensors in place across hundreds of
operations (the reference's step is a pure function). An interrupt in the
middle of one would leave a torn state that a save would label as a
whole step. So ``fit`` defers SIGINT while a step runs: its handler
records the signal, and ``KeyboardInterrupt`` is raised once the step
has returned. The state saved is always that of the last completed step
(a deliberate departure: ROADMAP.md queue 3 item 22). The handler is
installed in the main thread only, where Python delivers signals.

As in the reference, a resumed run is fed whatever ``data_iter`` the
caller gives: the checkpoint holds no data position, and
``launch/train.py`` replays its stream from batch 0 (ROADMAP.md queue 3
item 21).

**Ranks.** With ``rules`` over a ``(data, model)`` mesh, a ``Trainer``
runs on each rank (``dist.launch`` or ``torchrun``): it holds the rank's
shards of the state (a new state made from the seed on every rank, each
leaf cut as it is made, ``train.step.init_train_state(..., rules=)``; a
resume reads each rank's cuts), every rank draws the same batches and
the step takes the rank's rows of each. Saves are collective: every rank
joins its shards over the mesh, rank 0 writes the whole state.
Preemption over ranks is not handled: a SIGINT seen by one rank saves on
that rank alone and leaves the others in a collective, until the
launcher's stop or timeout ends them (ROADMAP.md queue 3 item 24).
"""
from __future__ import annotations

import contextlib
import signal
import threading
import time
from dataclasses import dataclass

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import resolve_device

from .step import (TrainHParams, abstract_train_state, init_train_state,
                   make_train_step, state_shardings)


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0               # 0 = only final
    ckpt_dir: str | None = None
    keep_n: int = 3
    async_ckpt: bool = False
    resume: bool = True
    seed: int = 0


class _SigintDeferral:
    """SIGINT handling of one ``fit``: inside ``step()`` the signal is
    recorded and delivered once the step has returned; outside it is
    delivered at once. Delivering calls the handler that was installed
    before (``KeyboardInterrupt`` by default)."""

    def __init__(self):
        self._in_step = False
        self._pending = False
        self._installed = False
        self._old = None

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._old = signal.signal(signal.SIGINT, self._handle)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            signal.signal(signal.SIGINT, self._old)
            self._installed = False

    def _deliver(self, frame=None):
        if callable(self._old):
            self._old(signal.SIGINT, frame)
        elif self._old != signal.SIG_IGN:
            raise KeyboardInterrupt

    def _handle(self, signum, frame):
        if self._in_step:
            self._pending = True
        else:
            self._deliver(frame)

    @contextlib.contextmanager
    def step(self):
        self._in_step = True
        try:
            yield
        finally:
            self._in_step = False
        if self._pending:
            self._pending = False
            self._deliver()


class Trainer:
    """The training loop of ``cfg`` under ``hp`` and ``tc``. The state
    lives on ``rules.mesh.device`` (``dist.rules.resolve_rules`` of a
    ``launch.mesh.make_host_mesh``), or on the card without rules; over
    ranks, as this rank's shards."""

    def __init__(self, cfg, rules, hp: TrainHParams, tc: TrainerConfig):
        self.cfg = cfg
        self.rules = rules
        self.hp = hp
        self.tc = tc
        self.device = (rules.mesh.device if rules is not None
                       else resolve_device(None))
        self.step_fn = make_train_step(cfg, rules, hp)
        self.ckpt = (CheckpointManager(tc.ckpt_dir, tc.keep_n, tc.async_ckpt)
                     if tc.ckpt_dir else None)
        self.history: list[dict] = []

    def init_or_resume(self):
        """(state, first step): the latest checkpoint restored into the
        abstract state on the device, or a new state from a generator
        seeded with ``tc.seed``; over ranks, the rank's shards."""
        shardings = self._shardings()
        if self.ckpt and self.tc.resume and self.ckpt.latest_step() is not None:
            return self.ckpt.restore(
                abstract_train_state(self.cfg, self.hp), device=self.device,
                shardings=shardings)
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        return init_train_state(self.cfg, gen, self.hp, device=self.device,
                                rules=self.rules), 0

    def _shardings(self):
        """The state's shardings over the ranks (``train.step.
        state_shardings``), None on one rank."""
        if self.rules is None or self.rules.mesh.size == 1:
            return None
        return state_shardings(self.cfg, self.rules, self.hp)

    def _save(self, step, state, shardings):
        if shardings is None:
            self.ckpt.save(step, state)
        else:
            self.ckpt.save(step, state, shardings,
                           abstract_train_state(self.cfg, self.hp))

    def fit(self, data_iter, state=None, start_step: int | None = None):
        """Train until ``tc.steps``; returns (state, history)."""
        if state is None:
            state, start_step = self.init_or_resume()
        elif start_step is None:
            start_step = int(state["opt"]["step"])
        data = iter(Prefetcher(data_iter))
        shardings = self._shardings()
        step = start_step
        t0 = time.perf_counter()
        with _SigintDeferral() as sigint:
            try:
                while step < self.tc.steps:
                    batch = {k: torch.as_tensor(v, device=self.device)
                             for k, v in next(data).items()}
                    with sigint.step():
                        state, metrics = self.step_fn(state, batch)
                        step += 1
                    if step % self.tc.log_every == 0 or step == self.tc.steps:
                        m = {k: float(v) for k, v in metrics.items()}
                        m["wall_s"] = time.perf_counter() - t0
                        self.history.append(m)
                    if (self.ckpt and self.tc.ckpt_every
                            and step % self.tc.ckpt_every == 0):
                        self._save(step, state, shardings)
            except (KeyboardInterrupt, SystemExit):
                if self.ckpt:                   # preemption: save, re-raise
                    self._save(step, state, shardings)
                    self.ckpt.wait()
                raise
        if self.ckpt:
            self._save(step, state, shardings)
            self.ckpt.wait()
        return state, self.history
