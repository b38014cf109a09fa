"""The dry run's argument bytes against the reference's: every config's
SMOKE train, prefill and decode cell through
``repro_torch.launch.dryrun.run_cell`` on ``meta`` tensors, against
``memory_analysis().argument_size_in_bytes`` of the reference's step for
the same cell compiled on one CPU device
(``tests/reference_calls.py::dryrun_argument_bytes``; the reference's
``repro.launch.dryrun`` is never imported in a test process: its first
lines rewrite ``XLA_FLAGS``). The train state, parameters, batch and
cache the port builds on ``meta`` hold the bytes the reference's
abstract trees hold."""
import pytest

from reference_calls import dryrun_argument_bytes

from repro_torch import configs
from repro_torch.launch import dryrun as D

from test_torch_dryrun import SMOKE_CELLS, smoke_overrides


@pytest.mark.parametrize("cell", SMOKE_CELLS, ids=lambda c: c.mode)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_argument_bytes_equal_reference(arch, cell):
    rec = D.run_cell(arch, cell, do_roofline=False,
                     cfg_overrides=smoke_overrides(arch))
    want = dryrun_argument_bytes(arch, cell.seq, cell.batch, cell.mode)
    assert rec["memory"]["argument_size_in_bytes"] == want
