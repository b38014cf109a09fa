"""The port's training step (``repro_torch.train``: ``TrainHParams``,
``init_train_state``, ``make_train_step``, ``_compress``) against the JAX
package's ``repro.train`` (its step jitted), from the same state (the
reference's ``init_train_state`` carried over by
``convert.train_state_from_numpy``) on the same batches (the reference's
``SyntheticLM``); remat against no remat; and the port's versions of the
reference's own train-step tests (tests/test_train_substrate.py).

The step runs granite SMOKE in float32 (``dtype`` replaced) for parity:
there it routes as the reference does token for token. The ``int8``
compression's noise comes from a ``torch.Generator`` in the port; the
parity case hands the port the reference's ``jax.random`` noise instead
(``_noise`` patched), so that the rest of its arithmetic is held.

Tolerances (float32 model): loss, grad_norm and lr within 1e-5 relative;
influence within 1e-6 relative (from integer loads); parameters and
moments within 1e-4 relative and 1e-5 absolute, 1e-4 absolute with bf16
or int8 compression (a gradient that rounds to the other neighbour of a
bfloat16 or int8 grid point moves its element's update by that much); the
error-feedback residual within 2e-4 absolute (one such rounding moves it
by a bfloat16 ulp of the gradient, ~1e-4 at the largest) and within 1e-6
for at least 99% of each leaf's elements. Remat is held bit for
bit (one intra-op thread: with two, the CPU's embedding backward sums in
a varying order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import SyntheticLM
from repro.dist.rules import resolve_rules
from repro.launch.mesh import make_host_mesh
from repro.train import TrainHParams as RTrainHParams
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro.train.step import _compress as ref_compress
from repro_torch import configs
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainHParams, init_train_state, make_train_step
from repro_torch.train import step as STEP

from lm_train_cases import (GRANITE, batch_for, influence,
                            port_loss_and_grad, ref_params)

torch.set_num_threads(1)

MESH = make_host_mesh()
LLAMA4 = "llama4_maverick_400b_a17b"


def _jax_noise(shape, step, leaf, device):
    """The reference's int8 noise for leaf ``leaf`` at ``step``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(17),
                                                step), leaf)
    return torch.from_numpy(np.asarray(jax.random.uniform(key, shape))) \
        .to(device)


def _setups(arch, cfg_fn=None, **kw):
    """(reference cfg, state, jitted step; port cfg, state, step) from one
    reference state. ``cfg_fn`` edits both configs alike."""
    rcfg = ref_configs.get_config(arch, smoke=True)
    pcfg = configs.get_config(arch, smoke=True)
    if cfg_fn is not None:
        rcfg, pcfg = cfg_fn(rcfg), cfg_fn(pcfg)
    hp = dict(lr_peak=5e-3, warmup_steps=2, total_steps=50, z_loss=1e-4)
    hp.update(kw)
    rhp, php = RTrainHParams(**hp), TrainHParams(**hp)
    rstate = ref_init_train_state(rcfg, jax.random.PRNGKey(0), rhp)
    pstate = train_state_from_numpy(jax.tree.map(np.asarray, rstate), "cpu")
    rstep = jax.jit(ref_make_train_step(
        rcfg, resolve_rules(MESH, rcfg, "train"), rhp))
    return rcfg, rstate, rstep, pcfg, pstate, make_train_step(pcfg, None,
                                                              php)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_tree(got, want, **tol):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(paths) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).rsplit(".", 1)[-1] == str(w.dtype)
        np.testing.assert_allclose(_np(g), _np(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_states(pstate, rstate, pm, rm, compress):
    for key in ("loss", "grad_norm", "lr", "moe_dropped_frac"):
        np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert int(pm["step"]) == int(rm["step"])
    tol = dict(rtol=1e-4, atol=1e-5 if compress == "none" else 1e-4)
    _assert_tree(pstate["params"], rstate["params"], **tol)
    _assert_tree(pstate["opt"]["mu"], rstate["opt"]["mu"], **tol)
    _assert_tree(pstate["opt"]["nu"], rstate["opt"]["nu"], **tol)
    np.testing.assert_allclose(_np(pstate["influence"]),
                               _np(rstate["influence"]), rtol=1e-6)
    assert ("ef" in pstate) == ("ef" in rstate)
    if "ef" in rstate:
        _assert_tree(pstate["ef"], rstate["ef"], rtol=0, atol=2e-4)
        for g, w in zip(tree_leaves(pstate["ef"]),
                        jax.tree.leaves(rstate["ef"])):
            far = np.abs(_np(g) - _np(w)) > 1e-6
            assert far.mean() <= 0.01


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.mark.parametrize("compress,micro", [("none", 1), ("none", 2),
                                            ("bf16", 1), ("bf16", 2),
                                            ("int8", 2)])
def test_train_step_matches_reference(compress, micro, monkeypatch):
    """granite SMOKE, batch 4 x 32 tokens, three steps: after the first
    (lr 0: moments, influence, metrics) and after the third (parameters
    moved twice)."""
    monkeypatch.setattr(STEP, "_noise", _jax_noise)
    rcfg, rstate, rstep, pcfg, pstate, pstep = _setups(
        GRANITE, _f32, microbatches=micro, grad_compress=compress)
    data = iter(SyntheticLM(rcfg, batch=4, seq=32))
    for i in range(3):
        b = next(data)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        if i in (0, 2):
            _assert_states(pstate, rstate, pm, rm, compress)


def test_bf16_grad_accumulation_matches_reference():
    """llama4 SMOKE with its TRAIN_HPARAMS (two microbatches, gradients
    summed in bfloat16): float32 parameters (an accumulator of their
    bf16 casts, as the reference's) and, its CONFIG's dtypes, bfloat16
    parameters and moments (the bf16 leaves' own ``.grad``)."""
    hp = configs.get(LLAMA4).TRAIN_HPARAMS
    for cfg_fn, tol in (
            (_f32, dict(rtol=1e-4, atol=1e-4)),
            (lambda c: dataclasses.replace(
                c, dtype="float32", param_dtype="bfloat16",
                moment_dtype="bfloat16"), dict(rtol=2 ** -7, atol=1e-4))):
        rcfg, rstate, rstep, pcfg, pstate, pstep = _setups(LLAMA4, cfg_fn,
                                                           **hp)
        data = iter(SyntheticLM(rcfg, batch=4, seq=32))
        for _ in range(3):
            b = next(data)
            rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
            pstate, pm = pstep(pstate, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-3)
        _assert_tree(pstate["params"], rstate["params"], **tol)
        _assert_tree(pstate["opt"]["nu"], rstate["opt"]["nu"], **tol)
        np.testing.assert_allclose(_np(pstate["influence"]),
                                   _np(rstate["influence"]), rtol=1e-6)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compress_matches_reference(kind, monkeypatch):
    """``_compress`` alone on a seeded gradient and residual tree (int8
    with the reference's noise): the dequantized gradients and the new
    residual within 1e-6 relative and 1e-8 absolute."""
    monkeypatch.setattr(STEP, "_noise", _jax_noise)
    rng = np.random.default_rng(21)
    shapes = {"a": (6, 5), "b": {"c": (4, 3, 2)}, "d": (7,)}

    def tree(scale, sh=shapes):
        return {k: tree(scale, v) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in sh.items()}

    g, ef = tree(1e-2), tree(1e-4)
    key = jax.random.fold_in(jax.random.PRNGKey(17), 3)
    wq, wef = ref_compress(jax.tree.map(jnp.asarray, g),
                           jax.tree.map(jnp.asarray, ef), kind, key)
    gq, gef = STEP._compress(jax.tree.map(torch.from_numpy, g),
                             jax.tree.map(torch.from_numpy, ef), kind, 3)
    _assert_tree(gq, wq, rtol=1e-6, atol=1e-8)
    _assert_tree(gef, wef, rtol=1e-6, atol=1e-8)


def test_int8_noise_is_seeded_by_step_and_leaf():
    """The port's own noise: uniform in [0, 1), the same for the same
    (step, leaf), another for another step or leaf."""
    a = STEP._noise((1000,), 3, 1, "cpu")
    assert a.dtype == torch.float32 and 0 <= float(a.min()) and \
        float(a.max()) < 1
    assert torch.equal(a, STEP._noise((1000,), 3, 1, "cpu"))
    assert not torch.equal(a, STEP._noise((1000,), 4, 1, "cpu"))
    assert not torch.equal(a, STEP._noise((1000,), 3, 2, "cpu"))
    assert abs(float(a.mean()) - 0.5) < 0.05


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_train_state_matches_reference(arch):
    """Keys, shapes and dtypes of every leaf (bf16 moments for jamba and
    llama4), the influence at ones and the zero moments, residuals and
    step; and ``train_state_from_numpy`` of the reference's state equal
    to it leaf for leaf."""
    cfg = configs.get_config(arch, smoke=True)
    hp = TrainHParams(grad_compress="bf16")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), hp,
                             device="cpu")
    rstate = ref_init_train_state(ref_configs.get_config(arch, smoke=True),
                                  jax.random.PRNGKey(0),
                                  RTrainHParams(grad_compress="bf16"))
    assert set(state) == set(rstate)
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    got = tree_leaves(state)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        name = jax.tree_util.keystr(path)
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).rsplit(".", 1)[-1] == str(w.dtype), name
        if "params" not in name:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    carried = train_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                     "cpu")
    for (path, w), g in zip(want, tree_leaves(carried)):
        assert str(g.dtype).rsplit(".", 1)[-1] == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_train_hparams_match_reference(arch):
    mod, ref = configs.get(arch), ref_configs.get(arch)
    assert hasattr(mod, "TRAIN_HPARAMS") == hasattr(ref, "TRAIN_HPARAMS")
    if hasattr(ref, "TRAIN_HPARAMS"):
        assert mod.TRAIN_HPARAMS == ref.TRAIN_HPARAMS
        TrainHParams(**mod.TRAIN_HPARAMS)


REMAT_CASES = {GRANITE: (1, 4096), "jamba_1p5_large_398b": (2, 256),
               "rwkv6_3b": (2, 64)}


@pytest.mark.parametrize("arch", sorted(REMAT_CASES))
def test_remat_is_bit_equal_and_training_forward_is_servings(arch):
    """``remat=True`` (each layer under ``torch.utils.checkpoint``: its
    kernels and router run again in the backward) against ``remat=False``:
    the same loss, logits and gradients bit for bit; and both forwards
    equal to the serving forward (no grad) bit for bit. granite at S=4096
    takes flash, jamba Mamba and MoE layers, rwkv6 the WKV scan; default
    bf16 activations."""
    B, S = REMAT_CASES[arch]
    cfg = configs.get_config(arch, smoke=True)
    batch = batch_for(cfg, B, S, 16)
    infl = influence(ref_configs.get_config(arch, smoke=True))
    out = {remat: port_loss_and_grad(arch, cfg, batch, infl, remat=remat)
           for remat in (False, True)}
    with torch.no_grad():
        serve, _, _ = M.forward(params_from_numpy(ref_params(arch), "cpu"),
                                {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, cfg, influence=None
                                if infl is None else torch.from_numpy(infl))
    (l0, lg0, g0), (l1, lg1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert torch.equal(lg0, lg1) and torch.equal(lg0.detach(), serve)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


# the reference's own train-step tests (tests/test_train_substrate.py), on
# the port: granite SMOKE in its default bf16 activations, from the port's
# own init_train_state

def _mini_setup(compress="none", micro=1):
    cfg = configs.get_config(GRANITE, smoke=True)
    hp = TrainHParams(microbatches=micro, grad_compress=compress,
                      lr_peak=5e-3, warmup_steps=2, total_steps=50,
                      z_loss=1e-4)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), hp,
                             device="cpu")
    data = (
        {k: torch.from_numpy(v) for k, v in b.items()}
        for b in SyntheticLM(ref_configs.get_config(GRANITE, smoke=True),
                             batch=4, seq=32))
    return cfg, state, make_train_step(cfg, None, hp), data


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
def test_loss_decreases(compress):
    cfg, state, step, data = _mini_setup(compress=compress)
    losses = []
    for _ in range(25):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_microbatch_equivalence():
    """grad accumulation over 2 microbatches ~= single big batch update."""
    _, s1, step1, data = _mini_setup(micro=1)
    _, s2, step2, _ = _mini_setup(micro=2)
    batch = next(data)
    s1n, m1 = step1(s1, batch)
    s2n, m2 = step2(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    d1 = tree_leaves(s1n["params"])[0]
    d2 = tree_leaves(s2n["params"])[0]
    np.testing.assert_allclose(_np(d1), _np(d2), rtol=5e-2, atol=5e-4)


def test_kmeans_router_influence_updates():
    """The balanced-k-means router state must move in response to load
    (paper Eq. 1 applied to experts) and stay positive."""
    cfg, state, step, data = _mini_setup()
    assert bool((state["influence"] == 1.0).all())
    for _ in range(3):
        state, m = step(state, next(data))
    infl = state["influence"].numpy()
    assert (infl > 0).all()
    assert not np.allclose(infl, 1.0)       # it actually adapts
    assert np.abs(np.log(infl)).max() < 1.0  # clipped at 5%/step
