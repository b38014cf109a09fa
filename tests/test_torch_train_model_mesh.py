"""Training over the ``model`` axis in the port on the meshes that take
longest: jamba on ``(1, 2)``, granite and jamba on ``(2, 2)`` (rows over
``data`` with FSDP of the ``embed`` leaves, heads, channels, experts and
the vocabulary over ``model``) against the reference's jitted step on
``make_host_mesh``, granite on the ``(pod, data, model)`` = ``(2, 2, 2)``
mesh (each microbatch's rows dealt over ``pod`` x ``data``, pod-major;
the FSDP leaves' gradients summed over ``pod`` too) against the
reference's on the same mesh, and int8 compression on ``(2, 2)`` against
the port's one rank.

Set-up and tolerances: tests/train_model_cases.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainHParams

from train_model_cases import (GRANITE, HP, JAMBA, assert_ranks_agree,
                               assert_step, port_steps, reference)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,mesh,micro", [
    (JAMBA, (1, 2), 2), (GRANITE, (2, 2), 2), (JAMBA, (2, 2), 2),
    (GRANITE, (2, 2, 2), 1)],
    ids=["jamba-1x2", "granite-2x2", "jamba-2x2", "granite-2x2x2"])
def test_step_matches_reference_on_the_mesh(arch, mesh, micro):
    """The port's step on the ranks of ``mesh`` against the reference's
    step on the same host mesh: batch 4 x 32 in ``micro`` microbatches
    (one on ``(2, 2, 2)``, whose four batch ranks then take a row each),
    three steps, held after the first (lr 0) and the third; every rank's
    metrics and whole state the same bits."""
    hp = dict(HP, microbatches=micro)
    rstate_np, pcfg, want, batches = reference(arch, hp, mesh)
    got = port_steps(rstate_np, pcfg, TrainHParams(**hp), batches, mesh)
    assert_ranks_agree(got)
    for (pm, pstate), (rm, rstate) in zip(got[0], want):
        assert_step(pm, pstate, rm, rstate)


def test_int8_on_data_and_model_equals_one_rank():
    """int8 compression on (2, 2) (the port's own noise, so against the
    port's one rank): the whole leaf's scale by an all-reduce max over
    the mesh, the shard's noise cut from the whole leaf's stream."""
    hp = dict(HP, microbatches=2, grad_compress="int8")
    rstate_np, pcfg, _, batches = reference(GRANITE, hp, (1, 1), keep=())
    one = port_steps(rstate_np, pcfg, TrainHParams(**hp), batches, (1, 1))
    got = port_steps(rstate_np, pcfg, TrainHParams(**hp), batches, (2, 2))
    assert_ranks_agree(got)
    for (m2, s2), (m1, s1) in zip(got[0], one[0]):
        np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-5)
        np.testing.assert_allclose(m2["grad_norm"], m1["grad_norm"],
                                   rtol=1e-3)
        for a, b in zip(tree_leaves(s2), tree_leaves(s1)):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=1e-4,
                                       atol=1e-4)
