"""Batched balanced k-means: many independent subproblems in one call
(counterpart of ``repro/partition/batched.py``).

Every subproblem is padded to a common ``cap`` point count with *copies
of its own real points at weight zero*, so padding moves neither the
bounding box nor any weighted sum. The reference vmaps ``balanced_kmeans``
and its nested while-loops; a lane that is done stays frozen, so every
lane equals its own solve. The port runs the lanes one after another
through its own ``balanced_kmeans`` on the device (each lane builds its
own point layout and launches the assign kernel once a sweep) and stacks
the outputs: the same per-lane ``iters``, ``final_imbalance`` and
``history`` (of length ``cfg.max_iter``) as the vmap. A lane dimension in
the kernel is not there yet (ROADMAP.md, queue 2).

``sharded_batched_balanced_kmeans`` splits the lanes over the refine axis
of a ``(P1, P2)`` mesh of ranks: each rank solves its share with the same
lane loop, and one sum all-reduce over the refine axis brings every
lane's outputs to every rank, equal to ``batched_balanced_kmeans`` bit
for bit.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.balanced_kmeans import BKMConfig, balanced_kmeans
from repro_torch.device import resolve_device
from repro_torch.dist import launch
from repro_torch.dist.rules import comm_for, mesh_shape


def _tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), device=dev).to(dtype)


def _prep(points, weights, centers0, cfg: BKMConfig, target_weight, dev):
    """(points [B, n, d], weights [B, n], centers0 [B, k, d], target [B])
    on ``dev``. The default target is each lane's total weight over k as
    a true float32 division, as the reference computes it outside jit
    (not the solver's multiplication by the reciprocal of k)."""
    points = _tensor(points, cfg.dtype, dev)
    B, n, _ = points.shape
    weights = (torch.ones((B, n), dtype=cfg.dtype, device=dev)
               if weights is None else _tensor(weights, cfg.dtype, dev))
    centers0 = _tensor(centers0, cfg.dtype, dev)
    if target_weight is None:
        # one 1-D sum a lane: the reduction the solver makes of its weights
        sums = torch.stack([torch.sum(weights[b].clone()) for b in range(B)])
        target_weight = sums / torch.tensor(float(cfg.k), dtype=cfg.dtype,
                                            device=dev)
    else:
        target_weight = torch.broadcast_to(
            _tensor(target_weight, cfg.dtype, dev), (B,))
    return points, weights, centers0, target_weight


def _stack_stats(lanes: list) -> dict:
    """The lanes' stats dicts (``history`` a dict of its own) stacked along
    a leading lane axis, on the device of the lanes' ``final_sizes``."""
    dev = lanes[0]["final_sizes"].device
    out = {}
    for key, val in lanes[0].items():
        if isinstance(val, dict):
            out[key] = {name: torch.stack([lane[key][name].to(dev)
                                           for lane in lanes])
                        for name in val}
        else:
            out[key] = torch.stack([torch.as_tensor(lane[key]).to(dev)
                                    for lane in lanes])
    return out


def _solve_lanes(pts, w, c0, tw, cfg: BKMConfig, influence0=None,
                 prev_assignment=None, copy_of=None):
    """Each lane through ``balanced_kmeans`` (warm when ``influence0`` is
    given), every lane's inputs copied to fresh tensors so that a lane
    computes what a standalone solve of the same inputs computes.
    ``copy_of[b] = a`` reuses lane a's outputs for lane b (a filler lane
    whose inputs equal lane a's)."""
    out = []
    for b in range(pts.shape[0]):
        if copy_of is not None and copy_of[b] is not None:
            out.append(out[copy_of[b]])
            continue
        kw = {}
        if influence0 is not None:
            kw = {"influence0": influence0[b].clone(), "warm_start": True,
                  "prev_assignment": prev_assignment[b].clone()}
        out.append(balanced_kmeans(pts[b].clone(), cfg, w[b].clone(),
                                   c0[b].clone(), target_weight=tw[b].clone(),
                                   **kw))
    A = torch.stack([o[0] for o in out])
    C = torch.stack([o[1] for o in out])
    infl = torch.stack([o[2] for o in out])
    return A, C, infl, _stack_stats([o[3] for o in out])


def batched_balanced_kmeans(points, weights, centers0, cfg: BKMConfig,
                            target_weight=None, *,
                            device: torch.device | str | None = None):
    """Solve B balanced-k-means subproblems on ``device`` (default
    ``cuda``).

    points [B, n, d]; weights [B, n] (0 marks padded slots — pad with
    *copies of real points* so bounding boxes stay tight); centers0
    [B, k, d]. ``target_weight``: scalar or [B] per-subproblem balance
    target (default: each subproblem's total weight / k).

    Returns (labels [B, n] int32, centers [B, k, d], influence [B, k],
    stats with a leading lane axis), tensors on ``device``.
    """
    dev = resolve_device(device)
    args = _prep(points, weights, centers0, cfg, target_weight, dev)
    return _solve_lanes(*args, cfg)


def sequential_balanced_kmeans(points, weights, centers0, cfg: BKMConfig,
                               target_weight=None, *,
                               device: torch.device | str | None = None):
    """The reference loop: each subproblem taken from the caller's arrays
    and solved by a one-lane ``batched_balanced_kmeans`` call of its own.
    Bit for bit equal to ``batched_balanced_kmeans``; kept as its
    oracle."""
    B = len(points)
    tw = (None if target_weight is None else
          np.broadcast_to(np.asarray(target_weight.cpu() if isinstance(
              target_weight, torch.Tensor) else target_weight), (B,)))
    outs = [batched_balanced_kmeans(
        points[b:b + 1], None if weights is None else weights[b:b + 1],
        centers0[b:b + 1], cfg, None if tw is None else tw[b:b + 1],
        device=device) for b in range(B)]
    A, C, infl = (torch.cat([o[i] for o in outs]) for i in range(3))
    stats = {}
    for key, val in outs[0][3].items():
        stats[key] = ({name: torch.cat([o[3][key][name] for o in outs])
                       for name in val} if isinstance(val, dict)
                      else torch.cat([o[3][key] for o in outs]))
    return A, C, infl, stats


def _leaves(A, C, infl, stats) -> list:
    """The solve's output tensors in a fixed order."""
    out = [A, C, infl]
    for key, val in stats.items():
        out += ([val[name] for name in val] if isinstance(val, dict)
                else [val])
    return out


def _with_leaves(stats, leaves):
    """``stats`` with its tensors replaced by ``leaves`` (same order)."""
    it = iter(leaves)
    return {key: ({name: next(it) for name in val}
                  if isinstance(val, dict) else next(it))
            for key, val in stats.items()}


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """The bits of ``x`` as int32 words (booleans as 0/1)."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    return x.contiguous().view(torch.int32)


def _from_int32(words: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        return words.bool()
    return words.contiguous().view(like.dtype)


def _gather_lanes(leaves: list, mine: slice, lanes: int, comm) -> list:
    """Every lane's outputs on every rank of ``comm``: each rank's leaves
    hold the lanes ``mine``; their bits go into a [lanes, words] zero
    matrix at those rows, and one sum all-reduce fills the others (a
    word plus zeros is the word, so the floats come back bit for
    bit)."""
    words = [_as_int32(x).reshape(x.shape[0], -1) for x in leaves]
    widths = [w.shape[1] for w in words]
    full = torch.zeros(lanes, sum(widths), dtype=torch.int32,
                       device=words[0].device)
    full[mine] = torch.cat(words, dim=1)
    full = comm.all_reduce(full)
    out, c0 = [], 0
    for x, width in zip(leaves, widths):
        cols = full[:, c0:c0 + width].contiguous()
        out.append(_from_int32(cols, x).reshape((lanes,) + x.shape[1:]))
        c0 += width
    return out


def _to_device(out, dev):
    """The outputs of a solve (tensors, dicts of tensors) on ``dev``."""
    if isinstance(out, dict):
        return {key: _to_device(val, dev) for key, val in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_to_device(val, dev) for val in out)
    return out.to(dev) if isinstance(out, torch.Tensor) else out


def _sharded_batched_to_host(*args, **kwargs):
    """``sharded_batched_balanced_kmeans`` on a rank, its outputs moved
    to the host (what a launch sends home)."""
    return _to_device(sharded_batched_balanced_kmeans(*args, **kwargs),
                      torch.device("cpu"))


def sharded_batched_balanced_kmeans(points, weights, centers0,
                                    cfg: BKMConfig, *, devices,
                                    target_weight=None,
                                    device: torch.device | str | None = None
                                    ):
    """Solve B refinement subproblems split over the refine axis of the
    ``(P1, P2)`` mesh of ranks.

    Same contract as ``batched_balanced_kmeans`` plus ``devices=(P1,
    P2)``: the B lanes are padded to a multiple of P2 with copies of lane
    0 (their outputs are dropped), the refine column j of every coarse
    row solves lanes [j*Bp/P2, (j+1)*Bp/P2) with the lane loop (the coarse
    rows repeat the same work, as the reference's do), and a sum
    all-reduce over the refine axis gives every rank all B lanes. Each
    lane is solved exactly as in ``batched_balanced_kmeans``, so the
    results equal it bit for bit.

    Outside a process group the call launches the P1*P2 ranks and
    returns rank 0's outputs on ``device``.
    """
    shape = mesh_shape(devices)
    if len(shape) != 2:
        raise ValueError(f"devices must be a (P1, P2) mesh, got "
                         f"{devices!r}")
    if launch.needed(devices):
        out = launch.run(_sharded_batched_to_host, devices, device, points,
                         weights, centers0, cfg, devices=devices,
                         target_weight=target_weight, device=device)
        return _to_device(out, resolve_device(device))
    comm = comm_for(devices)
    dev = launch.rank_device(resolve_device(device), comm.rank)
    p2 = shape[1]
    pts, w, c0, tw = _prep(points, weights, centers0, cfg, target_weight,
                           dev)
    B = pts.shape[0]
    Bp = -(-B // p2) * p2                  # pad B to a multiple of P2
    if Bp != B:
        idx = torch.cat([torch.arange(B, device=dev),
                         torch.zeros(Bp - B, dtype=torch.int64,
                                     device=dev)])
        pts, w, c0, tw = (x[idx] for x in (pts, w, c0, tw))
    per = Bp // p2
    mine = slice(comm.refine_index * per, (comm.refine_index + 1) * per)
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        A, C, infl, stats = _solve_lanes(pts[mine], w[mine], c0[mine],
                                         tw[mine], cfg)
    leaves = _gather_lanes(_leaves(A, C, infl, stats), mine, Bp,
                           comm.refine_group())
    leaves = [x[:B] for x in leaves]
    return (leaves[0], leaves[1], leaves[2],
            _with_leaves(stats, leaves[3:]))


def _host_weights(weights, shape) -> np.ndarray:
    """The caller's weights on the host in float64 (ones when None): the
    per-slot metrics are the host metrics of these."""
    if weights is None:
        return np.ones(shape)
    if isinstance(weights, torch.Tensor):
        return weights.detach().cpu().double().numpy()
    return np.asarray(weights, np.float64)


def bucket_balanced_kmeans(points, weights, centers0, cfg: BKMConfig, *,
                           counts=None, valid=None, target_weight=None,
                           influence0=None, prev_assignment=None,
                           warm: bool = False,
                           device: torch.device | str | None = None):
    """Solve one serving *bucket* — S fixed slots padded to a common point
    cap — on ``device`` (default ``cuda``).

    Every slot is an independent subproblem padded with copies of its own
    real points at weight zero; slots past the end of a request group are
    filler copies flagged invalid.

    Args:
        points:   [S, cap, d] padded per-slot coordinates.
        weights:  [S, cap] weights, 0 on padded entries (None = ones).
        centers0: [S, k, d] initial centers.
        cfg: shared ``BKMConfig``.
        counts:   optional [S] real point counts per slot (<= cap),
            recorded in ``stats["counts"]``; the per-slot metrics are
            taken over each slot's first ``counts[s]`` entries.
        valid:    optional [S] bool slot-validity mask (False = filler
            slot); recorded in ``stats["valid"]``. A filler slot whose
            inputs equal slot 0's takes slot 0's outputs.
        target_weight: scalar or [S] balance target override.
        influence0: [S, k] warm influence (warm only; None = ones).
        prev_assignment: [S, cap] int32 previous labels in the padded
            order (warm only; enables no-op detection per slot).
        warm: resume every slot from (centers0, influence0).

    Returns:
        (labels [S, cap] int32, centers [S, k, d], influence [S, k],
        stats): the solver stats with a leading slot axis plus the host
        metrics ``"imbalance"`` [S] (and ``"migration_fraction"`` [S]
        when warm) of each slot's real entries, and ``"counts"`` /
        ``"valid"`` passed through.

    Raises:
        ValueError: shape mismatches, counts exceeding the cap, or warm
            state missing/present on the wrong path.
    """
    dev = resolve_device(device)
    pts, w, c0, tw = _prep(points, weights, centers0, cfg, target_weight,
                           dev)
    S, cap, _ = pts.shape
    if counts is not None:
        counts = np.asarray(counts)
        if counts.shape != (S,):
            raise ValueError(f"counts must be [{S}], got {counts.shape}")
        if counts.max() > cap or counts.min() < 1:
            raise ValueError(f"counts must lie in [1, cap={cap}], got "
                             f"range [{counts.min()}, {counts.max()}]")
    if valid is not None:
        valid = np.asarray(valid, bool)
        if valid.shape != (S,):
            raise ValueError(f"valid must be [{S}], got {valid.shape}")
    if warm:
        influence0 = (torch.ones((S, cfg.k), dtype=cfg.dtype, device=dev)
                      if influence0 is None
                      else _tensor(influence0, cfg.dtype, dev))
        if prev_assignment is None:
            raise ValueError("warm bucket solves need prev_assignment "
                             "(the [S, cap] warm-start labels)")
        prev_assignment = _tensor(prev_assignment, torch.int32, dev)
        if tuple(influence0.shape) != (S, cfg.k):
            raise ValueError(f"influence0 must be [{S}, {cfg.k}], got "
                             f"{tuple(influence0.shape)}")
        if tuple(prev_assignment.shape) != (S, cap):
            raise ValueError(f"prev_assignment must be [{S}, {cap}], got "
                             f"{tuple(prev_assignment.shape)}")
    elif influence0 is not None or prev_assignment is not None:
        raise ValueError("influence0/prev_assignment are warm-start "
                         "state; pass warm=True")
    lanes = [pts, w, c0, tw] + ([influence0, prev_assignment] if warm
                                else [])
    copy_of = None
    if valid is not None:
        copy_of = [0 if (not valid[s] and s > 0 and all(
            torch.equal(x[s], x[0]) for x in lanes)) else None
            for s in range(S)]
    A, C, infl, stats = _solve_lanes(
        pts, w, c0, tw, cfg, influence0 if warm else None,
        prev_assignment if warm else None, copy_of)
    lab = A.cpu().numpy()
    w_host = _host_weights(weights, (S, cap))
    real = counts if counts is not None else np.full(S, cap)
    stats["imbalance"] = np.array([
        metrics.imbalance(lab[s, :real[s]], cfg.k, w_host[s, :real[s]])
        for s in range(S)])
    if warm:
        prev = prev_assignment.cpu().numpy()
        stats["migration_fraction"] = np.array([
            float(metrics.migration_fraction(prev[s, :real[s]],
                                             lab[s, :real[s]],
                                             w_host[s, :real[s]]))
            for s in range(S)])
    if counts is not None:
        stats["counts"] = counts
    if valid is not None:
        stats["valid"] = valid
    return A, C, infl, stats


def build_refinement_batch(points: np.ndarray, weights: np.ndarray | None,
                           labels: np.ndarray, k1: int):
    """Gather the k1 coarse blocks into static-shape refinement inputs.

    Every block is padded to ``cap = max block count`` by cycling its own
    point indices (real coordinates, zero weight).

    Returns (bpts [k1, cap, d], bw [k1, cap], gather [k1, cap] int64,
    counts [k1]): ``gather[b, :counts[b]]`` are the original point ids of
    block b, the rest is padding.
    """
    n = points.shape[0]
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=k1)
    if counts.min() == 0:
        raise ValueError("empty coarse block; cannot refine")
    cap = int(counts.max())
    order = np.argsort(labels, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    gather = np.empty((k1, cap), np.int64)
    for b in range(k1):
        ids = order[starts[b]:starts[b + 1]]
        reps = -(-cap // len(ids))          # ceil
        gather[b] = np.tile(ids, reps)[:cap]
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    valid = np.arange(cap)[None, :] < counts[:, None]
    bpts = points[gather]                                 # [k1, cap, d]
    bw = np.where(valid, w[gather], 0.0)                  # [k1, cap]
    return bpts, bw, gather, counts
