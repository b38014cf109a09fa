"""Fully sharded data parallelism of the leaves a train rule splits over
``data`` (reference: what GSPMD does with ``src/repro/dist/rules.py``'s
``embed -> data`` in train).

A rank holds each such leaf as its shard: chunk d of D along the
dimension the rule names, where D divides it (``NamedSharding.
split_dims``), and the leaf whole elsewhere. ``gather`` makes the leaf
whole where it is used, in an autograd function: its forward all-gathers
the shards along that dimension, its backward sums the whole gradient
over the ranks and keeps the rank's chunk (``Communicator.
reduce_scatter``), so the shard's ``.grad`` accumulates the sum over
ranks across every use, layer and microbatch. ``plan`` says, leaf by
leaf, where a tree of shards is split: ``(dim, communicator)`` or None.
"""
from __future__ import annotations

import torch

from .rules import axes_of


class _Gather(torch.autograd.Function):
    """The whole of a shard split along ``dim`` over ``comm``'s ranks."""

    @staticmethod
    def forward(ctx, shard, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.gather_along(shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce_scatter(grad, ctx.dim), None, None


def gather(x: torch.Tensor, split) -> torch.Tensor:
    """``x`` whole: the shards of ``split = (dim, comm)`` gathered (a
    differentiable all-gather), or ``x`` itself when ``split`` is None."""
    if split is None:
        return x
    dim, comm = split
    return _Gather.apply(x, comm, dim)


def gather_tree(tree, plan):
    """``gather`` of every leaf of a tree of dicts by the same tree of
    splits (``plan``); None: nothing split."""
    if plan is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, plan[k]) for k, v in tree.items()}
    return gather(tree, plan)


def plan(shardings, shapes, *, drop_leading: bool = False):
    """The split of each leaf over the ``data`` axis: ``(dim,
    communicator)`` for a leaf of the tree ``shapes`` (the whole leaves,
    ``meta`` tensors of their shapes, or the shapes themselves) held as a
    shard over ``data`` by its ``NamedSharding`` in ``shardings``, None
    for a leaf held whole there; None for a tree with no such leaf. A
    split over ``model`` is no FSDP: the layers compute on that shard
    (tensor parallelism).
    ``drop_leading``: the dims of one index of the leading (stacked
    repeat) dim, which is never split."""
    def walk(sh, x):
        if isinstance(sh, dict):
            sub = {k: walk(sh[k], x[k]) for k in sh}
            return sub if any(v is not None for v in sub.values()) \
                else None
        shape = tuple(getattr(x, "shape", x))
        split = [(dim, axis) for dim, axis in sh.split_dims(shape)
                 if "data" in axes_of(axis)]
        if not split:
            return None
        if len(split) > 1:
            raise NotImplementedError(
                f"a leaf split along {len(split)} dims over the data axis")
        dim, axis = split[0]
        if drop_leading:
            if dim == 0:
                raise ValueError("the stacked repeat dim is split")
            dim -= 1
        return dim, sh.mesh.axis_comm(axis)

    return walk(shardings, shapes)


def local(tree, shardings):
    """Each leaf's shard on this rank (its sharding's ``local``), copied
    into its own storage; leaves held whole are returned as they are."""
    if isinstance(tree, dict):
        return {k: local(v, shardings[k]) for k, v in tree.items()}
    part = shardings.local(tree)
    return part.clone() if part.shape != tree.shape else tree
