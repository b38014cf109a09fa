"""A model-sharded train state in the port: ``init_train_state(...,
rules=)`` making only a rank's shards, checkpoints written and restored
across ``(1, 1)``, ``(1, 2)`` and ``(2, 2)`` meshes (Mamba's ``in_proj``
by halves), read and written by the reference, and ``launch.train
--model-parallel 2`` over two rank processes.

Set-up: tests/train_model_cases.py. States and checkpoints are held bit
for bit. The driver trains the SMOKE config as it is, in bfloat16: each
rank's partial sums round to bfloat16 before their all-reduce, so its
losses are held within 1e-4 relative and grad_norm within 1e-2 of one
rank (chip_smoke.py's limits for the same comparison on the card).
"""
import multiprocessing

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt import CheckpointManager as RefCheckpointManager
from repro.train import TrainHParams as RTrainHParams
from repro.train import init_train_state as ref_init_train_state
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.dist import launch
from repro_torch.launch import train as LT
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (Trainer, TrainerConfig, TrainHParams,
                               abstract_train_state)
from repro_torch.train import step as STEP

from train_model_cases import (B, CPU, DEADLINE, HP, JAMBA, SEQ, f32,
                               ranks, rules_for)

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 2)]


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_train_state_makes_the_shards_of_the_whole(arch, mesh):
    """``init_train_state(..., rules=)`` on every rank is bit-equal to
    ``shard_state`` of the whole state from the same seed (int8: the
    error-feedback tree too), and ``whole_state`` of the shards is the
    whole state: Mamba's ``in_proj`` by halves, RWKV's heads whole."""
    pcfg = configs.get_config(arch, smoke=True)
    hp = TrainHParams(grad_compress="int8")

    def made(rules=None):
        return STEP.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                     hp, device=CPU, rules=rules)

    def run():
        rules = rules_for(pcfg, mesh)
        mine, whole = made(rules), made()
        return (_same(mine, STEP.shard_state(whole, pcfg, rules, hp)),
                _same(STEP.whole_state(mine, pcfg, rules, hp), whole),
                any(a.shape != b.shape for a, b in
                    zip(tree_leaves(mine), tree_leaves(whole))))

    got = ranks(run, mesh[0] * mesh[1])
    assert got == [(True, True, True)] * len(got)


def _trainer(tmp, mesh, steps, cfg, hp, resume=True):
    """``Trainer.fit`` of ``cfg`` on the ranks of ``mesh`` to ``steps``
    (from a checkpoint in ``tmp`` when there is one): on every rank, (the
    first step, whether the state it started from is ``shard_state`` of
    the whole state on disk, the steps trained, the whole final state)."""
    def run():
        rules = rules_for(cfg, mesh)
        t = Trainer(cfg, rules, hp, TrainerConfig(
            steps=steps, log_every=1, ckpt_dir=str(tmp), resume=resume))
        state, start = t.init_or_resume()
        same = None
        if start:
            on_disk, _ = CheckpointManager(str(tmp)).restore(
                abstract_train_state(cfg, hp), device=CPU)
            same = _same(state, STEP.shard_state(on_disk, cfg, rules, hp))
        state, hist = t.fit(iter(SyntheticLM(cfg, B, SEQ)), state, start)
        return (start, same, [m["step"] for m in hist],
                STEP.whole_state(state, cfg, rules, hp))

    return [run()] if mesh == (1, 1) else ranks(run, mesh[0] * mesh[1])


@pytest.mark.parametrize("written,read", [((1, 2), (1, 1)),
                                          ((1, 2), (2, 2)),
                                          ((1, 1), (1, 2)),
                                          ((2, 2), (1, 2))],
                         ids=["1x2-1x1", "1x2-2x2", "1x1-1x2", "2x2-1x2"])
def test_checkpoints_cross_meshes(tmp_path, written, read):
    """jamba (Mamba's ``in_proj`` cut by halves, attention, MoE) trained
    one step on the ``written`` mesh and saved (every rank joins its
    shards, rank 0 writes): the file is the whole state, bit for bit;
    the ``read`` mesh restores each rank's cut of it bit for bit and
    trains on."""
    cfg = f32(configs.get_config(JAMBA, smoke=True))
    hp = TrainHParams(**HP, microbatches=2)
    saved = _trainer(tmp_path, written, 1, cfg, hp)[0][3]
    on_disk, step = CheckpointManager(str(tmp_path)).restore(
        abstract_train_state(cfg, hp), device=CPU)
    assert step == 1 and _same(on_disk, saved)
    got = _trainer(tmp_path, read, 2, cfg, hp)
    assert [g[:3] for g in got] == [(1, True, [2.0])] * len(got)


def test_reference_reads_a_checkpoint_of_two_model_ranks(tmp_path):
    """The reference's ``CheckpointManager`` restores a checkpoint the port
    wrote on (1, 2) (jamba in float32): the port's whole state."""
    cfg = f32(configs.get_config(JAMBA, smoke=True))
    hp = TrainHParams(**HP, microbatches=2)
    saved = _trainer(tmp_path, (1, 2), 1, cfg, hp)[0][3]
    rcfg = f32(ref_configs.get_config(JAMBA, smoke=True))
    like = jax.eval_shape(lambda: ref_init_train_state(
        rcfg, jax.random.PRNGKey(0), RTrainHParams(**HP, microbatches=2)))
    rstate, step = RefCheckpointManager(str(tmp_path)).restore(like)
    assert step == 1
    for got, want in zip(jax.tree.leaves(rstate), tree_leaves(saved)):
        np.testing.assert_array_equal(np.asarray(got),
                                      want.detach().numpy())


def test_two_model_ranks_read_a_reference_checkpoint(tmp_path):
    """The port on (1, 2) resumes from the reference's checkpoint of its
    jamba state (float32): each rank's state is its cut of the
    reference's, bit for bit, and it trains on."""
    rcfg = f32(ref_configs.get_config(JAMBA, smoke=True))
    rhp = RTrainHParams(**HP, microbatches=2)
    rstate = ref_init_train_state(rcfg, jax.random.PRNGKey(0), rhp)
    RefCheckpointManager(str(tmp_path)).save(1, rstate)
    cfg = f32(configs.get_config(JAMBA, smoke=True))
    hp = TrainHParams(**HP, microbatches=2)
    whole = train_state_from_numpy(jax.tree.map(np.asarray, rstate), CPU)
    got = _trainer(tmp_path, (1, 2), 2, cfg, hp)
    # the state saved as step 1 is the reference's initial one: its
    # optimizer's step, which the metrics report, is 0 before the step
    assert [g[:3] for g in got] == [(1, True, [1.0])] * 2
    on_disk, _ = CheckpointManager(str(tmp_path)).restore(
        abstract_train_state(cfg, hp), step=1, device=CPU)
    assert _same(on_disk, whole)


def test_launch_train_model_parallel_spawns_two_ranks(capfd, monkeypatch):
    """``launch.train.main([..., "--model-parallel", "2", "--device",
    "cpu"])`` outside a rank spawns two rank processes (gloo), each
    holding its shards of granite; rank 0 prints the mesh and its
    history comes back within the step's tolerances of one rank."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", DEADLINE)
    argv = ["--arch", "granite-moe-3b-a800m", "--steps", "2", "--batch",
            "4", "--seq", "16", "--microbatches", "2", "--log-every", "1",
            "--device", "cpu"]
    trainer, hist = LT.main(argv + ["--model-parallel", "2"])
    out = capfd.readouterr().out
    assert trainer is None and [m["step"] for m in hist] == [1.0, 2.0]
    assert "final loss" in out and "1 data ranks x 2 model ranks" in out
    assert not multiprocessing.active_children()
    _, one = LT.main(argv)
    for a, b in zip(hist, one):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-2)
