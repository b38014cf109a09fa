"""AdamW with configurable moment dtypes and decoupled weight decay
(reference: ``repro/optim/adamw.py``).

The reference's arithmetic, op for op and in its order: the clip scale
from the pre-clip global norm, bias corrections ``1 - b**step`` in
float32, the moments in float32, ``mhat / (sqrt(vhat) + eps)``, the decay
added to that, the new parameter cast back to its dtype and the moments to
``moment_dtype``. ``torch.optim.AdamW`` is not used: it applies the decay
to the parameter before the step, another order.

The port updates the trees it is given in place and returns them, and it
works through each large leaf in slices of its leading dim (``_slices``):
a literal whole-leaf update keeps about six float32 temporaries of the
leaf's size alive (granite's stacked ``w_gate`` is 4.03 GB), and
elementwise float32 results do not depend on the slicing. Leaves are
walked in sorted key order, as ``jax.tree.leaves`` walks a dict.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# elements of one slice of a leaf's update (128 MB of float32)
_SLICE = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, keys sorted at every level (the
    order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, values):
    """A tree of ``tree``'s dict structure holding ``values``, given in
    ``tree_leaves`` order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def tree_map(fn, tree):
    """``fn`` of every leaf, in a tree of the same dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _slices(*ts):
    """Matching slices of same-shaped tensors along their leading dim,
    each about ``_SLICE`` elements or one row, or the tensors whole when
    they are 0-d or small."""
    t = ts[0]
    if t.dim() == 0 or t.numel() <= _SLICE:
        yield ts
        return
    rows = max(1, _SLICE // (t.numel() // t.shape[0]))
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in ts)


def global_norm(tree, counted=None, comm=None) -> torch.Tensor:
    """sqrt of the sum over leaves of ``sum(x^2)`` in float32 (each leaf
    summed slice by slice).

    Over ranks (``comm``, the whole mesh's communicator), the leaves are
    this rank's shards, and ``counted`` (``tree_leaves`` order) flags the
    ones this rank adds to the sum: each shard is counted by one rank
    (a leaf held whole over a mesh axis by the rank at coordinate 0 of
    it, so a leaf held whole everywhere by rank 0 alone), and one
    all-reduce sums the ranks' totals. Every rank gets the same bits (the
    all-reduce's result is every rank's), so the clip scale is the same
    on every rank."""
    leaves = tree_leaves(tree)
    if counted is None:
        counted = [True] * len(leaves)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x, count in zip(leaves, counted):
        if not count:
            continue
        for (s,) in _slices(x):
            total = total + torch.sum(torch.square(s.to(torch.float32)))
    if comm is not None:
        total = comm.all_reduce(total)
    return torch.sqrt(total)


def adamw_init(params, cfg: AdamWConfig):
    mdt = getattr(torch, cfg.moment_dtype)
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(params, grads, opt_state, cfg: AdamWConfig, lr, *,
                 counted=None, comm=None):
    """One AdamW step. Returns (params, opt_state, stats): ``params`` and
    the moments updated in place (the trees given, returned), a new step
    tensor, ``stats`` {"grad_norm" (pre-clip), "lr"}. ``lr`` is a float
    or a float32 scalar tensor. Over ranks the trees hold the rank's
    shards, and ``counted`` and ``comm`` make the norm the whole tree's
    (``global_norm``); the update itself is elementwise on each rank's
    shards."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, counted, comm)
    if cfg.grad_clip:
        scale = torch.minimum(torch.ones_like(gnorm),
                              cfg.grad_clip / torch.clamp_min(gnorm, 1e-12))
    else:
        scale = 1.0
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, sf)
    c2 = 1.0 - torch.pow(cfg.b2, sf)
    b1, b2 = cfg.b1, cfg.b2

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu_f = b1 * mu.to(torch.float32) + (1 - b1) * g
        nu_f = b2 * nu.to(torch.float32) + (1 - b2) * g * g
        mhat = mu_f / c1
        vhat = nu_f / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p, mu_f, nu_f

    with torch.no_grad():
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"])):
            for ps, gs, ms, ns in _slices(p, g, mu, nu):
                new_p, mu_f, nu_f = upd(ps, gs, ms, ns)
                ps.copy_(new_p.to(ps.dtype))
                ms.copy_(mu_f.to(ms.dtype))
                ns.copy_(nu_f.to(ns.dtype))
    opt_state = dict(opt_state, step=step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
