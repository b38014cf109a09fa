"""Helpers that the per-layer metric readers (``metrics/<name>.py``) share.

A reader is ``read(record) -> float | None``: the metric's value from a
``Record`` of the traced run, or None where the run holds nothing to read
(the harness then leaves the metric out of its line).
"""
from __future__ import annotations

from dataclasses import dataclass

from portbench.trace import TraceSummary


@dataclass
class Record:
    """What a traced run hands the readers."""
    device_type: str          # "cuda" or "cpu"
    device_kind: str          # torch.cuda.get_device_name(), or "cpu"
    n: int
    d: int
    k: int
    calls: list               # one dict a timed call or warm step
    trace: TraceSummary | None


def mean_of(record: Record, key: str) -> float | None:
    """Mean of ``key`` over the timed calls that carry it."""
    vals = [c[key] for c in record.calls if key in c]
    return sum(vals) / len(vals) if vals else None


def kernel_sweeps(record: Record) -> float | None:
    """Mean assign-kernel launches a call; None off the card, where the
    sweeps run through plain PyTorch and launch no kernel."""
    if record.device_type != "cuda":
        return None
    return mean_of(record, "sweeps")


def device_idle(record: Record) -> float | None:
    """% of the traced window in which the device ran nothing."""
    t = record.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_time(record: Record, names) -> tuple[float, int]:
    """(device seconds, launches) of the kernels whose profiler name
    holds one of ``names``."""
    sec, calls = 0.0, 0
    if record.trace is not None:
        for name, (s, c) in record.trace.kernels.items():
            if any(part in name for part in names):
                sec, calls = sec + s, calls + c
    return sec, calls
