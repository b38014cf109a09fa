"""Training over the ``model`` axis in the port (``train.step`` with the
layers' ``reduce_partial`` / ``enter_split`` / ``gather_split``, a
model-sharded train state) against the reference's jitted step on
``make_host_mesh(1, 2)``, and the gradients of one step at ``model=2``
against the one-rank step's, leaf by leaf. The ``(2, 2)`` mesh and int8
compression: tests/test_torch_train_model_mesh.py.

Set-up and tolerances: tests/train_model_cases.py.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.dist.comm import current
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainHParams, make_train_step
from repro_torch.train import step as STEP

from train_model_cases import (ARCHS, B, CPU, GRANITE, HP, JAMBA, SEQ,
                               assert_ranks_agree, assert_step, f32,
                               port_steps, ranks, reference, rules_for)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != JAMBA])
def test_model_parallel_step_matches_reference(arch):
    """model=2 on thread ranks against the reference's step on a (1, 2)
    host mesh: batch 4 x 32 in 2 microbatches, three steps, held after
    the first (lr 0) and the third; every rank's metrics and whole state
    the same bits (jamba's case, the slowest to compile in the
    reference, is in tests/test_torch_train_model_mesh.py)."""
    hp = dict(HP, microbatches=2)
    rstate_np, pcfg, want, batches = reference(arch, hp, (1, 2))
    got = port_steps(rstate_np, pcfg, TrainHParams(**hp), batches, (1, 2))
    assert_ranks_agree(got)
    for (pm, pstate), (rm, rstate) in zip(got[0], want):
        assert_step(pm, pstate, rm, rstate)


def _step_grads(pcfg, mesh, whole, batch, one=None):
    """Each rank's gradients of one step from the whole state ``whole``
    (what reaches ``adamw_update``), in rank order, each with the rank's
    cut of the gradients ``one`` and whether each leaf is split."""
    hp = TrainHParams(**HP, microbatches=2)
    seen = {}
    inner = STEP.adamw_update

    def record(params, grads, *args, **kw):
        rank = 0 if current() is None else current().rank
        seen[rank] = [g.detach().clone() for g in tree_leaves(grads)]
        return inner(params, grads, *args, **kw)

    def run():
        rules = rules_for(pcfg, mesh)
        state = STEP.shard_state(_clone(whole), pcfg, rules, hp)
        make_train_step(pcfg, rules, hp)(state, batch)
        if one is None:
            return None, None
        sh = tree_leaves(M.rank_shardings(pcfg, rules))
        shapes = [x.shape for x in tree_leaves(M.abstract_params(pcfg))]
        return ([s.local(g) for s, g in zip(sh, one)],
                [bool(s.split_dims(x)) for s, x in zip(sh, shapes)])

    STEP.adamw_update = record
    try:
        out = [run()] if mesh == (1, 1) else ranks(run, mesh[0] * mesh[1])
    finally:
        STEP.adamw_update = inner
    return [(seen[r], *out[r]) for r in range(len(out))]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_one_rank(arch):
    """After one step at (1, 2): every leaf whose cut of the one-rank
    gradient is not zero gets a gradient on its model rank; each leaf
    held whole has the same gradient bits on both; each leaf's gradient
    is the rank's cut of the one-rank gradient, within the parameters'
    tolerance (a missing all-reduce of an entered value leaves a
    gradient partial, a doubled one doubles it)."""
    pcfg = f32(configs.get_config(arch, smoke=True))
    whole = STEP.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                  TrainHParams(**HP), device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(SyntheticLM(pcfg, B, SEQ))).items()}
    [(one, _, _)] = _step_grads(pcfg, (1, 1), whole, batch)
    two = _step_grads(pcfg, (1, 2), whole, batch, one)
    assert any(bool(torch.any(g != 0)) for g in one)
    for r, (got, cut, _) in enumerate(two):
        for i, (g, c) in enumerate(zip(got, cut)):
            if bool(torch.any(c != 0)):
                assert bool(torch.any(g != 0)), (r, i)
            np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"rank {r} leaf {i}")
    for i, split in enumerate(two[0][2]):
        if not split:                               # whole: the same bits
            assert torch.equal(two[0][0][i], two[1][0][i]), i


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def test_remat_recompute_keeps_the_rank_communicator():
    """The backward may run on another thread than the forward (on the
    card, the autograd engine's device thread): remat's recompute of a
    layer then gathers and all-reduces through the forward's
    communicator. A model=2 forward on each thread rank, its backward on
    a fresh thread where no rank's communicator is set: the gradients are
    the same bits as those of the backward on the rank's own thread."""
    pcfg = f32(configs.get_config(GRANITE, smoke=True))
    whole = STEP.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                  TrainHParams(**HP), device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(SyntheticLM(pcfg, B, SEQ))).items()}

    def run():
        rules = rules_for(pcfg, (1, 2))
        state = STEP.shard_state(_clone(whole), pcfg, rules,
                                 TrainHParams(**HP))
        leaves = tree_leaves(state["params"])
        grads = []
        for elsewhere in (False, True):
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None
            logits, _, _ = M.forward(state["params"], batch, pcfg, rules,
                                     remat=True,
                                     influence=state["influence"])
            loss = M.loss_fn(logits, batch["labels"], pcfg)
            if elsewhere:
                failed = []

                def backward():
                    try:
                        loss.backward()
                    except Exception as e:      # noqa: BLE001 - reported
                        failed.append(repr(e))

                t = threading.Thread(target=backward)
                t.start()
                t.join()
                assert not failed, failed
            else:
                loss.backward()
            grads.append([p.grad.clone() for p in leaves if p.grad is not
                          None])
        return len(grads[0]) == len(grads[1]) and all(
            torch.equal(a, b) for a, b in zip(*grads))

    assert ranks(run, 2) == [True, True]
