"""The port's training loop (``repro_torch.train.Trainer``) and driver
(``repro_torch.launch.train``) on the CPU:

* ``Trainer.fit`` from the reference's initial state
  (``convert.train_state_from_numpy``) against the reference's
  ``Trainer.fit`` on the same ``SyntheticLM`` batches, gemma3 and granite
  SMOKE in float32, with the tolerances of tests/test_torch_train.py: the
  logged metrics within 1e-5 relative; parameters and moments within
  1e-4 relative and 1e-5 absolute; granite's influence within 1e-6
  relative;
* preemption: a SIGINT that lands inside ``adamw_update`` is deferred
  until the step returns, the trainer saves that completed step and
  re-raises, and a fresh trainer resumed from the checkpoint on the rest
  of the stream ends bit-equal to an uninterrupted run (one intra-op
  thread); the same signal outside the loop tears the state, which is
  what the deferral prevents (ROADMAP.md queue 3 item 22);
* the reference's own trainer test (tests/test_train_substrate.py) on the
  port; a resume restores into the abstract state without an init;
  ``launch.train.main`` runs and resumes on the CPU; the loop's entry
  points go to the card unless asked for the CPU.
"""
import contextlib
import dataclasses
import itertools
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.dist.rules import resolve_rules as ref_resolve_rules
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro.train import TrainHParams as RTrainHParams
from repro.train import init_train_state as ref_init_train_state
from repro_torch import configs
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.dist.rules import resolve_rules
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw as ADAMW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import Trainer, TrainerConfig, TrainHParams
from repro_torch.train import step as STEP
from repro_torch.train import trainer as TR

torch.set_num_threads(1)

GRANITE = "granite_moe_3b_a800m"
HP = dict(lr_peak=5e-3, warmup_steps=2, total_steps=50, z_loss=1e-4)


def _rules(cfg):
    return resolve_rules(make_host_mesh(device="cpu"), cfg, "train")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.mark.parametrize("arch,micro", [("gemma3_1b", 1), (GRANITE, 2)])
def test_fit_matches_reference(arch, micro):
    """Both trainers from one state on the same batches, four steps,
    metrics logged every step."""
    rcfg = _f32(ref_configs.get_config(arch, smoke=True))
    pcfg = _f32(configs.get_config(arch, smoke=True))
    rhp, php = RTrainHParams(microbatches=micro, **HP), \
        TrainHParams(microbatches=micro, **HP)
    rstate = ref_init_train_state(rcfg, jax.random.PRNGKey(0), rhp)
    pstate = train_state_from_numpy(jax.tree.map(np.asarray, rstate), "cpu")
    rt = RefTrainer(rcfg, ref_resolve_rules(ref_host_mesh(), rcfg, "train"),
                    rhp, RefTrainerConfig(steps=4, log_every=1))
    pt = Trainer(pcfg, _rules(pcfg), php, TrainerConfig(steps=4,
                                                        log_every=1))
    rstate, rhist = rt.fit(iter(RefSyntheticLM(rcfg, 4, 32)), rstate, 0)
    pstate, phist = pt.fit(iter(SyntheticLM(pcfg, 4, 32)), pstate, 0)
    assert len(phist) == len(rhist) == 4
    for p, r in zip(phist, rhist):
        assert p.keys() == r.keys()
        for key in p:
            if key != "wall_s":
                np.testing.assert_allclose(p[key], r[key], rtol=1e-5,
                                           atol=1e-7, err_msg=key)
    want = jax.tree_util.tree_flatten_with_path(
        {k: rstate[k] for k in ("params", "opt")})[0]
    got = tree_leaves({k: pstate[k] for k in ("params", "opt")})
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    assert ("influence" in pstate) == (arch == GRANITE)
    if arch == GRANITE:
        np.testing.assert_allclose(_np(pstate["influence"]),
                                   _np(rstate["influence"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def sigint_inside_update(at_step):
    """Send SIGINT from inside ``adamw_update`` of the step that makes
    ``at_step``, after half its leaves were updated in place."""
    inner_update, inner_slices = STEP.adamw_update, ADAMW._slices
    left = [0]          # _slices calls until the signal

    def update(params, grads, opt_state, cfg, lr):
        if int(opt_state["step"]) + 1 == at_step:
            n = len(tree_leaves(params))
            left[0] = n + n // 2      # global_norm's calls, then half
        return inner_update(params, grads, opt_state, cfg, lr)

    def slices(*ts):
        if left[0]:
            left[0] -= 1
            if not left[0]:
                signal.raise_signal(signal.SIGINT)
        yield from inner_slices(*ts)

    STEP.adamw_update, ADAMW._slices = update, slices
    try:
        yield
    finally:
        STEP.adamw_update, ADAMW._slices = inner_update, inner_slices


def _granite(tmp_path, name, steps=6, **tc):
    cfg = configs.get_config(GRANITE, smoke=True)
    hp = TrainHParams(microbatches=2, **HP)
    tc = TrainerConfig(steps=steps, log_every=1,
                       ckpt_dir=str(tmp_path / name), **tc)
    return Trainer(cfg, _rules(cfg), hp, tc)


def _data(trainer, start=0):
    return itertools.islice(iter(SyntheticLM(trainer.cfg, 4, 32)), start,
                            None)


def _metrics(history):
    return [{k: v for k, v in m.items() if k != "wall_s"} for m in history]


def _leaf_files(path):
    return {f: (path / f).read_bytes() for f in sorted(os.listdir(path))
            if f.startswith("leaf_")}


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_sigint_inside_adamw_update_resumes_bit_equal(tmp_path, async_ckpt):
    """granite SMOKE in its bf16 activations, two microbatches, six steps.
    The interrupted run completes the step the signal landed in, saves it
    (the same files as the uninterrupted run's checkpoint of that step)
    and re-raises; a fresh trainer resumed from it on batches 3 onward
    ends bit-equal, final state and last three steps' metrics."""
    a = _granite(tmp_path, "a", ckpt_every=1, keep_n=10,
                 async_ckpt=async_ckpt)
    want, hist_a = a.fit(_data(a))
    b = _granite(tmp_path, "b", async_ckpt=async_ckpt)
    before = signal.getsignal(signal.SIGINT)
    with sigint_inside_update(3), pytest.raises(KeyboardInterrupt):
        b.fit(_data(b))
    assert signal.getsignal(signal.SIGINT) is before
    assert b.ckpt.all_steps() == [3] and len(b.history) == 2
    assert _leaf_files(tmp_path / "b" / "step_000000003") == \
        _leaf_files(tmp_path / "a" / "step_000000003")
    c = _granite(tmp_path, "b", async_ckpt=async_ckpt)
    state, start = c.init_or_resume()
    assert start == 3
    got, hist_c = c.fit(_data(c, start), state, start)
    assert _metrics(hist_c) == _metrics(hist_a[3:])
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g.detach(), w.detach())
    assert c.ckpt.latest_step() == 6


def test_sigint_inside_adamw_update_tears_an_undeferred_step():
    """The hazard the deferral removes: the same signal under the default
    handler, around a bare step, stops ``adamw_update`` half way: the
    first leaves moved, the last did not."""
    cfg = configs.get_config(GRANITE, smoke=True)
    hp = TrainHParams(**HP)
    state = STEP.init_train_state(cfg, torch.Generator().manual_seed(0),
                                  hp, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(SyntheticLM(cfg, 4, 32))).items()}
    step = STEP.make_train_step(cfg, None, hp)
    state, _ = step(state, batch)           # lr > 0 from the second step
    old = [p.detach().clone() for p in tree_leaves(state["params"])]
    with sigint_inside_update(2), pytest.raises(KeyboardInterrupt):
        step(state, batch)
    moved = [not torch.equal(o, p.detach())
             for o, p in zip(old, tree_leaves(state["params"]))]
    assert moved[0] and not moved[-1]
    assert int(state["opt"]["step"]) == 1


def test_sigint_outside_a_step_is_delivered_at_once(tmp_path,
                                                    monkeypatch):
    """A SIGINT during a periodic save (outside a step) interrupts at once;
    the trainer saves the last completed step and re-raises."""
    t = _granite(tmp_path, "s", steps=4, ckpt_every=1)
    inner = t.ckpt.save

    def save(step, state):
        inner(step, state)
        if step == 2:
            signal.raise_signal(signal.SIGINT)

    monkeypatch.setattr(t.ckpt, "save", save)
    with pytest.raises(KeyboardInterrupt):
        t.fit(_data(t))
    assert t.ckpt.all_steps() == [1, 2] and len(t.history) == 2


def test_trainer_resume_after_interrupt(tmp_path):
    """The reference's test on the port: train, 'lose the node', resume
    from the latest checkpoint and reach the target step count."""
    cfg = configs.get_config("gemma3_1b", smoke=True)
    rules = _rules(cfg)
    hp = TrainHParams(lr_peak=1e-3, warmup_steps=2, total_steps=20)
    tc = TrainerConfig(steps=6, log_every=2, ckpt_every=2,
                       ckpt_dir=str(tmp_path), keep_n=2)
    t1 = Trainer(cfg, rules, hp, tc)
    data = SyntheticLM(cfg, batch=2, seq=32)
    state, _ = t1.fit(iter(data))
    assert t1.ckpt.latest_step() == 6 and t1.ckpt.all_steps() == [4, 6]
    tc2 = TrainerConfig(steps=10, log_every=2, ckpt_every=2,
                        ckpt_dir=str(tmp_path), keep_n=2)
    t2 = Trainer(cfg, rules, hp, tc2)     # fresh process analogue
    state2, start = t2.init_or_resume()
    assert start == 6                     # resumed, not restarted
    state2, hist = t2.fit(iter(data), state2, start)
    assert int(state2["opt"]["step"]) == 10
    assert [m["step"] for m in hist] == [8.0, 10.0]


def test_resume_restores_without_an_init(tmp_path, monkeypatch):
    """With a checkpoint, ``init_or_resume`` fills the abstract (meta)
    state from disk: no random init to throw away; every leaf on the
    trainer's device in the checkpoint's dtype."""
    t = _granite(tmp_path, "r", steps=1)
    want, _ = t.fit(_data(t))

    def refuse(*a, **k):
        raise AssertionError("init_train_state called on a resume")

    monkeypatch.setattr(TR, "init_train_state", refuse)
    state, start = _granite(tmp_path, "r").init_or_resume()
    assert start == 1
    for g, w in zip(tree_leaves(state), tree_leaves(want)):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        assert torch.equal(g, w.detach())


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: four steps with
    checkpoints, then a run to six that resumes from step 4 (its stream
    replayed from batch 0, as the reference's driver does)."""
    argv = ["--arch", "gemma3-1b", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1", "--device", "cpu"]
    trainer, hist = LT.main(argv + ["--steps", "4"])
    assert trainer.device.type == "cpu" and len(hist) == 4
    assert trainer.ckpt.all_steps() == [2, 4]
    assert np.isfinite([m["loss"] for m in hist]).all()
    trainer, hist = LT.main(argv + ["--steps", "6"])
    assert [m["step"] for m in hist] == [5.0, 6.0]
    assert trainer.ckpt.all_steps() == [2, 4, 6]
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--data-parallel", "--model-parallel"])
def test_launch_train_launches_parallel_training(flag, monkeypatch):
    """``--data-parallel 2`` or ``--model-parallel 2`` called outside a
    rank launches two ranks running the same command (here thread ranks,
    for time; tests/test_torch_train_ranks.py and
    tests/test_torch_train_model_state.py spawn the processes) and
    returns rank 0's history."""
    argv = ["--arch", "gemma3-1b", flag, "2", "--device", "cpu"]
    launched = []
    inner = LT.launch.launch

    def threads(fn, nranks, **kw):
        launched.append((fn, nranks, kw["args"]))
        return inner(fn, nranks, args=kw["args"], device=kw["device"],
                     threads=True, timeout=120)

    monkeypatch.setattr(LT.launch, "launch", threads)
    argv += ["--steps", "2", "--batch", "2", "--seq", "16",
             "--log-every", "1"]
    trainer, hist = LT.main(argv)
    assert trainer is None and [m["step"] for m in hist] == [1.0, 2.0]
    assert launched == [(LT._rank_main, 2, (argv,))]


def test_the_loop_defaults_to_the_card():
    """The trainer without rules, and the driver without ``--device``,
    run on the card: without one they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = configs.get_config("gemma3_1b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, None, TrainHParams(), TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LT.main(["--arch", "gemma3-1b", "--steps", "1"])
