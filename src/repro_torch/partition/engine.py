"""``partition()`` — the front door (counterpart of
``repro/partition/engine.py``)::

    from repro_torch.partition import PartitionProblem, partition

    prob = PartitionProblem.from_mesh(mesh, k=64, epsilon=0.03)
    res = partition(prob, method="geographer")           # on the card
    res = partition(prob, method="rcb", device="cpu")    # any registry name
    res.labels, res.imbalance(), res.evaluate()

The flat path only: ``hierarchy=``, ``devices=`` and ``refine=`` raise
``NotYetPortedError`` until their slices land.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .problem import NotYetPortedError, PartitionProblem, PartitionResult
from .registry import get_algorithm, resolve_method


def partition(problem: PartitionProblem, method: str = "geographer", *,
              device: torch.device | str | None = None,
              hierarchy=None, devices=None, refine=None,
              refine_eps: float | None = None, evaluate: bool = False,
              with_diameter: bool = False, **opts) -> PartitionResult:
    """Partition ``problem`` with ``method`` (a registry name).

    Args:
        problem: the ``PartitionProblem`` to cut into ``problem.k``
            balanced blocks.
        method: registry name; aliases resolve, unknown names raise
            ``UnknownMethodError``.
        device: where the solve runs; None means ``cuda``, and a machine
            without a card raises instead of running on the CPU. Pass
            ``"cpu"`` to run on the host.
        hierarchy, devices, refine, refine_eps: not ported yet; any value
            other than None raises ``NotYetPortedError``.
        evaluate: fill ``result.quality`` with the paper's metric set.
        with_diameter: include per-block diameters in the evaluation.
        **opts: BKMConfig fields for geographer (``backend``, ``fused``,
            ``assign_precision``, ...); unknown options raise TypeError.

    Returns:
        A ``PartitionResult`` (labels in original point order, the
        centers/influence warm-start state for geographer, ``stats``).
    """
    if not isinstance(problem, PartitionProblem):
        raise TypeError(
            f"partition() takes a PartitionProblem, got {type(problem)}; "
            "wrap raw arrays with PartitionProblem(points=..., k=...)")
    resolve_method(method)                 # fail fast on unknown names
    for name, value, slice_ in (
            ("hierarchy", hierarchy, "the batched/hierarchical slice"),
            ("devices", devices, "the torch.distributed slice"),
            ("refine", refine, "the refinement slice"),
            ("refine_eps", refine_eps, "the refinement slice")):
        if value is not None and value is not False:
            raise NotYetPortedError(f"partition({name}=...) comes with "
                                    f"{slice_}")
    dev = resolve_device(device)
    result = get_algorithm(method)(problem, device=dev, **opts)
    if evaluate:
        result.evaluate(with_diameter=with_diameter)
    return result
