"""``partition()`` — the front door (counterpart of
``repro/partition/engine.py``)::

    from repro_torch.partition import PartitionProblem, partition

    prob = PartitionProblem.from_mesh(mesh, k=64, epsilon=0.03)
    res = partition(prob, method="geographer")           # on the card
    res = partition(prob, method="rcb", device="cpu")    # any registry name
    res.labels, res.imbalance(), res.evaluate()

    res = partition(prob, hierarchy=(8, 8))              # k1 x k2 blocks
    res = partition(prob, method="rcb", refine=True)     # + label propagation
    res = partition(prob, devices=4)                     # 4 ranks, sharded

``devices=P`` (or ``(P1, P2)``) runs the sharded path over
``torch.distributed``: on the calling rank when the caller is one (under
``torchrun``, every rank calls with the same problem and gets the same
result), else on P local ranks that this call launches (see
``repro_torch.dist.launch``). With ``refine=``, the refinement rounds
run sharded over the same ranks after the solve.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import launch

from .hierarchical import hierarchical_partition
from .problem import PartitionProblem, PartitionResult
from .refine import refine as _refine
from .refine import resolve_refiner
from .registry import (distributed_methods, get_algorithm, resolve_method,
                       supports_devices)


def _parse_hierarchy(hierarchy) -> tuple[int, int]:
    if isinstance(hierarchy, str):
        parts = hierarchy.lower().split("x")
        if len(parts) != 2:
            raise ValueError(f"hierarchy string must be 'k1xk2', "
                             f"got {hierarchy!r}")
        return int(parts[0]), int(parts[1])
    k1, k2 = hierarchy
    return int(k1), int(k2)


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
        hierarchy: ``(k1, k2)`` tuple or ``"k1xk2"`` string — two-level
            recursive partitioning with ``k1*k2 == problem.k``.
        devices: run the sharded multi-device path over P ranks (the
            method must be registered with ``supports_devices``; with
            ``hierarchy``, the coarse cut is the sharded pass). A
            ``(P1, P2)`` tuple views the ranks as a 2-D mesh: the flat
            solve equals ``devices=P1*P2`` bit for bit, and the
            hierarchical refinement splits its blocks over the refine
            axis. Each rank runs on ``device``; on the card rank r binds
            to card ``r % device_count``, and the backend is NCCL when
            every rank has a card of its own, gloo otherwise.
        refine: quality-recovery post-pass over the solver's labels —
            True (= ``"label_prop"``) or a refiner registry name (see
            ``repro_torch.partition.refine``), run on ``device``, sharded
            over ``devices`` when set (bit for bit the single-device
            rounds). Requires the problem to carry a CSR graph; the
            returned result's ``method`` gains the refiner suffix (e.g.
            ``"sfc+lp"``).
        refine_eps: balance slack for the refinement budgets (None =
            ``problem.epsilon``); only meaningful with ``refine``.
        evaluate: fill ``result.quality`` with the paper's metric set.
        with_diameter: include per-block diameters in the evaluation.
        **opts: BKMConfig fields for geographer (``backend``, ``fused``,
            ``assign_precision``, ...), or ``refine_method`` /
            ``batched`` / ``coarse_epsilon`` in hierarchical mode; unknown
            options raise TypeError.

    Returns:
        A ``PartitionResult`` (labels in original point order, the
        centers/influence warm-start state for geographer, ``stats``).
    """
    if not isinstance(problem, PartitionProblem):
        raise TypeError(
            f"partition() takes a PartitionProblem, got {type(problem)}; "
            "wrap raw arrays with PartitionProblem(points=..., k=...)")
    resolve_method(method)                 # fail fast on unknown names
    if devices is not None and not supports_devices(method):
        raise ValueError(
            f"method {method!r} has no multi-device path; devices= is "
            f"supported by: {distributed_methods()}")
    if refine is not None and refine is not False:
        refine = resolve_refiner(refine)   # fail fast, before the solve
    else:
        refine = None
    dev = resolve_device(device)
    if launch.needed(devices):
        return launch.run(partition, devices, device, problem, method,
                          device=device, hierarchy=hierarchy,
                          devices=devices, refine=refine,
                          refine_eps=refine_eps, evaluate=evaluate,
                          with_diameter=with_diameter, **opts)
    if hierarchy is not None:
        k1, k2 = _parse_hierarchy(hierarchy)
        result = hierarchical_partition(problem, k1, k2, method=method,
                                        device=dev, devices=devices,
                                        **opts)
    else:
        if devices is not None:
            opts["devices"] = devices
        result = get_algorithm(method)(problem, device=dev, **opts)
    if refine is not None:
        result = _refine(problem, result, refine, device=dev,
                         devices=devices, eps=refine_eps)
    if evaluate:
        result.evaluate(with_diameter=with_diameter)
    return result
