"""Shared set-up of the tests of training over the ``model`` axis
(tests/test_torch_train_model*.py): the port's ``make_train_step`` on
``(data, model)`` thread ranks against the reference's jitted
``make_train_step`` on ``make_host_mesh(data, model)`` (virtual jax
devices: GSPMD over ``dist/rules.py``'s table), from the reference's
state (``init_train_state`` from ``PRNGKey(0)``) carried over by
``convert.train_state_from_numpy`` and cut to each rank's shards by
``train.step.shard_state``, and against the port's own one-rank step.

SMOKE configs in float32. Tolerances, tests/test_torch_train_ranks.py's:
loss and moe_dropped_frac within 1e-5 relative, grad_norm within 1e-3
relative, parameters and moments within 1e-4 relative and 1e-5 absolute
(1e-4 absolute with int8 compression), the influence within 1e-6
relative; every rank's metrics and whole leaves the same bits.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.dist.rules import resolve_rules as ref_resolve_rules
from repro.launch.mesh import make_compat_mesh as ref_compat_mesh
from repro.train import TrainHParams as RTrainHParams
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.convert import train_state_from_numpy
from repro_torch.dist import launch
from repro_torch.dist.comm import current
from repro_torch.dist.rules import resolve_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import make_train_step
from repro_torch.train import step as STEP

CPU = "cpu"
DEADLINE = 300.0
GRANITE, GEMMA = "granite_moe_3b_a800m", "gemma3_1b"
LLAMA4, MUSICGEN = "llama4_maverick_400b_a17b", "musicgen_large"
JAMBA, RWKV = "jamba_1p5_large_398b", "rwkv6_3b"
# one config for each kind of edge: MoE with its router leaf gathered;
# MQA with the KV head whole; a shared expert beside split experts;
# codebook inputs and heads; Mamba by channels with in_proj's halves;
# RWKV by heads with whole leaves sliced
ARCHS = [GRANITE, GEMMA, LLAMA4, MUSICGEN, JAMBA, RWKV]
HP = dict(lr_peak=5e-3, warmup_steps=2, total_steps=50, z_loss=1e-4)
B, SEQ = 4, 32


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def ranks(fn, nranks, *args):
    """``fn(*args)`` on every thread rank; their values in rank order."""
    out = {}

    def body():
        out[current().rank] = fn(*args)

    launch.launch(body, nranks, device=CPU, threads=True, timeout=DEADLINE)
    return [out[r] for r in range(nranks)]


def npf(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def assert_tree(got, want, **tol):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(paths) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(npf(g), npf(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def axes(mesh):
    """The axis names of a ``(data, model)`` or ``(pod, data, model)``
    mesh shape."""
    return ("data", "model") if len(mesh) == 2 else ("pod", "data", "model")


def rules_for(pcfg, mesh, batch=B):
    return resolve_rules(make_mesh(mesh, axes(mesh), device=CPU), pcfg,
                         "train", batch_size=batch)


def reference(arch, hp, mesh, steps=3, keep=(0, 2)):
    """The reference's jitted step on the host mesh of ``mesh``'s shape
    (``make_host_mesh``'s ``(data, model)``, or ``(pod, data, model)``): (its
    state as numpy, the SMOKE configs, its metrics and states after the
    steps in ``keep``, the batches); no step runs when ``keep`` is
    empty."""
    rcfg = f32(ref_configs.get_config(arch, smoke=True))
    pcfg = f32(configs.get_config(arch, smoke=True))
    rhp = RTrainHParams(**hp)
    rstate = ref_init_train_state(rcfg, jax.random.PRNGKey(0), rhp)
    rstate_np = jax.tree.map(np.asarray, rstate)
    rules = ref_resolve_rules(ref_compat_mesh(tuple(mesh), axes(mesh)),
                              rcfg, "train", batch_size=B)
    rstep = jax.jit(ref_make_train_step(rcfg, rules, rhp))
    batches = list(itertools.islice(iter(RefSyntheticLM(rcfg, batch=B,
                                                        seq=SEQ)), steps))
    kept = []
    for i, b in enumerate(batches if keep else []):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        if i in keep:
            kept.append((rm, rstate))
    return rstate_np, pcfg, kept, batches


def port_steps(rstate_np, pcfg, php, batches, mesh, keep=(0, 2)):
    """The port's step on the ranks of ``mesh`` from the reference's
    state on the global ``batches``: on every rank, the metrics and the
    whole state after each step in ``keep``."""
    def run():
        rules = rules_for(pcfg, mesh)
        state = STEP.shard_state(train_state_from_numpy(rstate_np, CPU),
                                 pcfg, rules, php)
        step = make_train_step(pcfg, rules, php)
        kept = []
        for i, b in enumerate(batches):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            if i in keep:
                whole = STEP.whole_state(state, pcfg, rules, php)
                kept.append(({k: float(v) for k, v in m.items()},
                             jax.tree.map(lambda x: x.detach().clone(),
                                          whole)))
        return kept

    n = int(np.prod(mesh))
    return [run()] if n == 1 else ranks(run, n)


def assert_step(pm, pstate, rm, rstate, compress="none"):
    for key in ("loss", "lr", "moe_dropped_frac"):
        np.testing.assert_allclose(pm[key], float(rm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(pm["grad_norm"], float(rm["grad_norm"]),
                               rtol=1e-3)
    assert int(pm["step"]) == int(rm["step"])
    tol = dict(rtol=1e-4, atol=1e-5 if compress == "none" else 1e-4)
    assert_tree(pstate["params"], rstate["params"], **tol)
    assert_tree(pstate["opt"]["mu"], rstate["opt"]["mu"], **tol)
    assert_tree(pstate["opt"]["nu"], rstate["opt"]["nu"], **tol)
    if "influence" in rstate:
        np.testing.assert_allclose(npf(pstate["influence"]),
                                   npf(rstate["influence"]), rtol=1e-6)


def assert_ranks_agree(ranks_out):
    """Every rank's metrics and whole state bit-equal to rank 0's: the
    leaves held whole are each rank's own (the influence among them),
    the split ones the same all-gather on every rank."""
    for kept in ranks_out[1:]:
        for (m, st), (m0, st0) in zip(kept, ranks_out[0]):
            assert m == m0
            for a, b in zip(tree_leaves(st), tree_leaves(st0)):
                assert torch.equal(a, b)
