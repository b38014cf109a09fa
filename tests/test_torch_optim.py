"""The port's optimizer (``repro_torch.optim``: ``make_schedule``,
``AdamWConfig``, ``global_norm``, ``adamw_init``, ``adamw_update``)
against the JAX package's ``repro.optim``, on trees and gradients made
with seeded numpy and handed to both, plus the port's copies of the
reference's own optimizer tests (tests/test_train_substrate.py).

Tolerances: schedules within 1e-6 relative and 1e-6 of the peak
absolute (``cos`` may differ by one float32 ulp between XLA and PyTorch,
which ``1 + cos`` magnifies near the end of the cosine); AdamW parameters, moments and the
global norm within 1e-6 relative and 1e-7 absolute (float32 arithmetic in
the same order; on this CPU it reads bit-equal), bfloat16 moments within
one bfloat16 ulp (2^-8 relative) of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import global_norm as ref_global_norm
from repro.optim import make_schedule as ref_make_schedule
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               global_norm, make_schedule)
from repro_torch.optim import adamw as A

torch.set_num_threads(1)

SHAPES = {"a": (5, 7), "b": {"c": (3, 4, 6), "d": (11,)}, "e": (2, 9, 3)}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_trees(got, want, **tol):
    for g, w in zip(A.tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("floor", [0.0, 1e-5])
@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(kind, floor):
    want = ref_make_schedule(kind, 3e-4, 10, 100, floor)
    got = make_schedule(kind, 3e-4, 10, 100, floor)
    for s in range(121):
        g = got(torch.tensor(s, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(float(g), float(want(jnp.int32(s))),
                                   rtol=1e-6, atol=1e-6 * 3e-4,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(mdt, clip, wd):
    """Five steps on a tree of three ranks, gradients of norm ~40 (so the
    clip acts), a float lr and a float32 tensor lr."""
    rng = np.random.default_rng(1)
    p0 = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [_tree(lambda s: (3 * rng.standard_normal(s)).astype(np.float32))
             for _ in range(5)]
    rcfg = RAdamWConfig(weight_decay=wd, grad_clip=clip, moment_dtype=mdt)
    cfg = AdamWConfig(weight_decay=wd, grad_clip=clip, moment_dtype=mdt)
    rp = jax.tree.map(jnp.asarray, p0)
    ropt = ref_adamw_init(rp, rcfg)
    tp = jax.tree.map(torch.tensor, p0)
    topt = adamw_init(tp, cfg)
    assert topt["mu"]["a"].dtype == getattr(torch, mdt)
    for i, g in enumerate(grads):
        lr = 1e-2 if i % 2 else torch.tensor(1e-2, dtype=torch.float32)
        rp, ropt, rst = ref_adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                         ropt, rcfg, 1e-2)
        tp, topt, tst = adamw_update(tp, jax.tree.map(torch.from_numpy, g),
                                     topt, cfg, lr)
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(rst["grad_norm"]), rtol=1e-6)
        assert int(topt["step"]) == int(ropt["step"]) == i + 1
        assert topt["step"].dtype == torch.int32
        _assert_trees(tp, rp, rtol=1e-6, atol=1e-7)
        mtol = dict(rtol=2 ** -8, atol=0) if mdt == "bfloat16" else \
            dict(rtol=1e-6, atol=1e-7)
        _assert_trees(topt["mu"], ropt["mu"], **mtol)
        _assert_trees(topt["nu"], ropt["nu"], **mtol)


def test_update_in_slices_is_bit_equal_to_whole_leaves(monkeypatch):
    """``_slices`` cuts a large leaf along its leading dim: the same
    elementwise float32 values as one whole-leaf update."""
    rng = np.random.default_rng(2)
    p0 = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    gs = [_tree(lambda s: rng.standard_normal(s).astype(np.float32))
          for _ in range(3)]
    out = []
    for cut in (A._SLICE, 13):
        monkeypatch.setattr(A, "_SLICE", cut)
        cfg = AdamWConfig(moment_dtype="bfloat16")
        p = jax.tree.map(torch.tensor, p0)
        opt = adamw_init(p, cfg)
        for g in gs:
            p, opt, st = adamw_update(p, jax.tree.map(torch.from_numpy, g),
                                      opt, cfg, 3e-3)
        out.append({"params": p, "opt": opt})
    assert len(list(A._slices(torch.zeros(3, 4, 6)))) == 3
    for a, b in zip(A.tree_leaves(out[0]), A.tree_leaves(out[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    tree = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    rtree = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), tree)
    ttree = jax.tree.map(lambda x: torch.from_numpy(x).to(
        getattr(torch, dtype)), tree)
    np.testing.assert_allclose(float(global_norm(ttree)),
                               float(ref_global_norm(rtree)), rtol=1e-6)


def test_tree_leaves_walk_sorted_keys_as_jax_does():
    tree = {"z": 1, "a": {"y": 2, "b": 3}, "m": 4}
    assert A.tree_leaves(tree) == jax.tree.leaves(tree) == [3, 2, 4, 1]
    assert A.tree_unflatten(tree, [30, 20, 40, 10]) == \
        {"a": {"b": 30, "y": 20}, "m": 40, "z": 10}


# the reference's own optimizer tests (tests/test_train_substrate.py),
# on the port

def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params, cfg)
    target = torch.tensor([1.0, 1.0])
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        torch.sum((w - target) ** 2).backward()
        params, opt, _ = adamw_update(params, {"w": w.grad}, opt, cfg, 5e-2)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_adamw_moment_dtype():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones(4)}
    opt = adamw_init(params, cfg)
    assert opt["mu"]["w"].dtype == torch.bfloat16
    _, opt2, _ = adamw_update(params, {"w": torch.ones(4)}, opt, cfg, 1e-3)
    assert opt2["mu"]["w"].dtype == torch.bfloat16


def test_grad_clip_caps_update():
    cfg = AdamWConfig(weight_decay=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params, cfg)
    _, _, stats = adamw_update(params, {"w": torch.full((3,), 1e6)}, opt,
                               cfg, 1e-3)
    assert float(stats["grad_norm"]) > 1e5  # reported pre-clip


def test_schedules_warmup_and_decay():
    for kind in ("cosine", "linear", "constant"):
        f = make_schedule(kind, peak=1.0, warmup_steps=10, total_steps=100)
        assert float(f(torch.tensor(0, dtype=torch.int32))) == 0.0
        assert abs(float(f(torch.tensor(10, dtype=torch.int32))) - 1.0) < 0.11
        if kind != "constant":
            assert float(f(torch.tensor(100, dtype=torch.int32))) < 0.05
