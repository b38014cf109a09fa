"""Dynamic load-balancing simulation: perturb -> repartition -> measure
(counterpart of ``repro/core/timeseries.py``).

Two drivers with the same semantics over the time-evolving workloads of
``core.meshes`` (``WORKLOADS``):

* ``simulate_loadbalance`` — the host loop through the front doors
  (``partition`` / ``repartition``): every registry method, warm or cold.
* ``simulate_loadbalance_scan`` — the reference's single jitted
  ``lax.scan`` over T warm steps, here a plain loop on the device with
  the scan's semantics: the carry is (centers, influence, labels), the
  weights come from the step index on the device, the balance retries
  and the migration are computed as the scan computes them. On the
  permuted points it equals the host loop's warm path.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.device import resolve_device

from .balanced_kmeans import BKMConfig, balanced_kmeans


def _launches() -> dict:
    from repro_torch.kernels.ops import launch_counts
    return launch_counts()


def simulate_loadbalance(problem, workload, steps: int = 8, *,
                         method: str = "geographer", mode: str = "warm",
                         device: torch.device | str | None = None,
                         devices: int | None = None, **opts) -> dict:
    """Alternate perturb -> repartition for ``steps`` steps on the host.

    Step 0 is a cold ``partition()`` under ``workload.weights_at(points,
    0)``; steps 1..T re-weight the problem and call ``repartition``
    against the previous result — warm-started (``mode="warm"``) or cold
    and relabel-matched (``mode="cold"``).

    Args:
        problem: a ``partition.PartitionProblem``; its weights are
            replaced by the workload's per-step field.
        workload: an object with ``weights_at(points, t)`` (see
            ``core.meshes.WORKLOADS``); the weights are computed on
            ``device`` in float32.
        steps: number of repartition steps T (>= 1).
        method: registry method for every step.
        mode: "warm" or "cold".
        device: where the solves run; None means ``cuda``.
        devices: shard count P (or a (P1, P2) mesh) for the multi-device
            path: every step's solve is sharded over P ranks. Outside a
            process group the whole series runs in P ranks launched once
            (``dist.launch``) and rank 0's record comes back.
        **opts: forwarded to ``partition`` / ``repartition``.

    Returns:
        dict with ``"per_step"`` (step, iters, imbalance, balanced,
        migration_volume, migration_fraction, retained_fraction, time_s,
        and ``kernel_launches``: the kernel launches of the step by
        name), ``"summary"`` (means and maxima across steps), the run
        config, and the final ``PartitionResult`` at ``"final_result"``.
    """
    from repro_torch.dist import current, launch
    from repro_torch.partition import partition
    from repro_torch.partition.repartition import repartition

    if mode not in ("warm", "cold"):
        raise ValueError(f"mode must be 'warm' or 'cold', got {mode!r}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    if launch.needed(devices):
        return launch.run(simulate_loadbalance, devices, device, problem,
                          workload, steps, method=method, mode=mode,
                          device=device, devices=devices, **opts)
    if devices is not None:
        dev = launch.rank_device(dev, current().rank)
    pts = torch.from_numpy(np.asarray(problem.points)).to(dev)

    def weights(t):
        return workload.weights_at(pts, t).cpu().numpy()

    prev = partition(problem.replace(weights=weights(0)), method=method,
                     device=dev, devices=devices, **opts)
    records = []
    for t in range(1, steps + 1):
        prob_t = problem.replace(weights=weights(t))
        before = _launches()
        t0 = time.perf_counter()
        res = repartition(prob_t, prev, method=method, device=dev,
                          devices=devices, warm=(mode == "warm"), **opts)
        dt = time.perf_counter() - t0
        after = _launches()
        imb = res.imbalance()
        mig = res.stats["migration"]
        rec = {
            "step": t,
            "iters": res.stats.get("iters"),
            "imbalance": imb,
            "balanced": bool(imb <= problem.epsilon + 1e-6),
            "migration_volume": mig["volume"],
            "migration_fraction": mig["fraction"],
            "retained_fraction": mig["retained_fraction"],
            "time_s": dt,
            "kernel_launches": {name: after[name] - before[name]
                                for name in after
                                if after[name] != before[name]},
        }
        if res.quality:        # per-step cut/comm volume via evaluate=True
            rec.update({k: v for k, v in res.quality.items()
                        if k not in rec})
        records.append(rec)
        prev = res
    iters = [r["iters"] for r in records if r["iters"] is not None]
    summary = {
        "mean_iters": float(np.mean(iters)) if iters else None,
        "mean_migration_fraction": float(
            np.mean([r["migration_fraction"] for r in records])),
        "mean_migration_volume": float(
            np.mean([r["migration_volume"] for r in records])),
        "max_imbalance": float(max(r["imbalance"] for r in records)),
        "all_balanced": bool(all(r["balanced"] for r in records)),
        "total_time_s": float(sum(r["time_s"] for r in records)),
    }
    return {"mode": mode, "method": method, "devices": devices,
            "steps": steps, "n": problem.n, "k": problem.k,
            "epsilon": problem.epsilon,
            "workload": type(workload).__name__,
            "per_step": records, "summary": summary,
            "final_result": prev}


def simulate_loadbalance_scan(points, centers0, influence0, labels0,
                              workload, steps: int, cfg: BKMConfig, *,
                              device: torch.device | str | None = None):
    """T warm-started repartition steps with the reference scan's
    semantics, on ``device`` (default ``cuda``).

    The carry is the warm-start state (centers, influence, labels); each
    step computes the weights from the step index, warm-restarts balanced
    k-means (re-warming while the final imbalance exceeds ``epsilon +
    1e-6`` in ``cfg.dtype``, at most ``MAX_BALANCE_RETRIES`` times) and
    measures the migration against the step's weights in ``cfg.dtype`` on
    the device.

    Args:
        points: [n, d] — the PERMUTED points (the permutation the host
            path derives from the problem seed).
        centers0: [k, d] initial (cold-start) centers.
        influence0: [k] initial influence.
        labels0: [n] initial labels in the same permuted order.
        workload: a workload of ``core.meshes``.
        steps: number of steps T.
        cfg: BKMConfig; ``warmup`` is forced off.
        device: where the steps run; None means ``cuda``.

    Returns:
        (final_carry, per_step): final_carry = (centers [k, d], influence
        [k], labels [n] int32) on the device after step T; per_step maps
        "iters" (cumulative over retries), "imbalance" (the solver's final
        imbalance), "migration_volume", "migration_fraction",
        "retained_fraction" and "balance_retries" to [T] CPU tensors.
    """
    from repro_torch.partition.repartition import MAX_BALANCE_RETRIES
    dev = resolve_device(device)
    if cfg.warmup:
        cfg = replace(cfg, warmup=False)
    dtype = cfg.dtype

    def on_dev(x, dt):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        return x.to(dev).to(dt)

    pts = on_dev(points, dtype)
    centers = on_dev(centers0, dtype)
    infl = on_dev(influence0, dtype)
    labels = on_dev(labels0, torch.int32)
    # the scan compares the final imbalance with epsilon + 1e-6 in dtype
    eps_bar = float(torch.tensor(cfg.epsilon + 1e-6, dtype=dtype))
    names = ("iters", "imbalance", "migration_volume",
             "migration_fraction", "retained_fraction", "balance_retries")
    recs = {name: [] for name in names}
    for t in range(1, steps + 1):
        w_t = workload.weights_at(pts, t).to(dtype)
        attempt, total, imb = 0, 0, float("inf")
        c, i_, prev = centers, infl, labels
        while attempt < MAX_BALANCE_RETRIES + 1 and (
                attempt == 0 or imb > eps_bar):
            prev, c, i_, stats = balanced_kmeans(
                pts, cfg, w_t, c, influence0=i_, warm_start=True,
                prev_assignment=prev)
            total += int(stats["iters"])
            imb_t = stats["final_imbalance"]
            imb = float(imb_t)
            attempt += 1
        moved = torch.sum(torch.where(labels != prev, w_t,
                                      torch.zeros_like(w_t)))
        frac = moved / torch.clamp_min(torch.sum(w_t), 1e-12)
        for name, val in zip(names, (total, imb_t, moved, frac, 1.0 - frac,
                                     attempt - 1)):
            recs[name].append(torch.as_tensor(val).cpu())
        centers, infl, labels = c, i_, prev
    per_step = {name: torch.stack(vals) for name, vals in recs.items()}
    per_step["iters"] = per_step["iters"].to(torch.int32)
    per_step["balance_retries"] = per_step["balance_retries"].to(torch.int32)
    return (centers, infl, labels), per_step
