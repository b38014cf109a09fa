"""The comparison that decides ``correct`` fails where it must, at a toy
size on the CPU: the configuration's lower-precision control (the
program's bfloat16 cross term) in every cell, and the program broken
underneath the harness by each fault the cell can have (its traffic
kind's ``faults``)."""
import json

import pytest

from portbench.spec import HERE, benchmark, plugin
from portbench.test_portbench_runs import TOY, toy

# the refine control needs coordinates large enough for bfloat16's
# rounding of the cross term to move labels past the limit
CONTROL_SIZE = {"tri2d-n4M-k1024.refine": ("256", "32")}


def _faults():
    bench = benchmark(HERE.parent, held=True)
    traffic = {w["name"]: w["traffic"] for w in bench["workloads"]}
    out = []
    for cell in sorted(TOY):
        mix = json.loads((HERE / "traffic" / f"{traffic[cell]}.json")
                         .read_text())
        out += [(cell, f) for f in plugin("kinds", mix["kind"]).faults(mix)]
    return out


@pytest.mark.parametrize("cell", sorted(TOY))
def test_control_is_not_correct(cell):
    out, _ = toy(cell, "--control", size=CONTROL_SIZE.get(cell))
    assert out["correct"] is False, out["checks"]
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.parametrize("cell,fault", _faults())
def test_fault_is_not_correct(cell, fault):
    out, _ = toy(cell, "--fault", fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(TOY))
def test_frozen_centers_fail_the_center_gap(cell):
    """Centers that never move are caught by ``center_gap`` itself, not
    only through the balance their labels may miss."""
    out, _ = toy(cell, "--fault", "frozen")
    gap = out["checks"]["center_gap"]
    assert gap["value"] > gap["limit"], out["checks"]
