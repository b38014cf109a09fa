"""Serving jamba (Mamba by ``mlp`` channels, beside attention by heads and
MoE by experts) and rwkv6 (RWKV by heads, its channel mix by ``mlp``)
over the ``model`` axis: the port's prefill, decode steps and
``ServeEngine`` on ``(1, 2)`` and ``(2, 2)`` thread ranks against the
reference's ``M.prefill`` and jitted ``make_serve_step`` on
``make_host_mesh``, SMOKE in float32 and jamba in bfloat16 too; the two
deliberate departures from the reference's shards (ROADMAP.md queue 3
items 26-27); RWKV heads never cut; ``init_params(rules=)`` bit-equal to
``shard_params`` of the whole tree for every config, without the whole
tree alive; and the serving driver over two CPU rank processes.
Set-up and tolerances: tests/serve_model_cases.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve_model_cases as C
from repro import configs as ref_configs
from repro.dist.rules import resolve_rules as ref_resolve_rules
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import model as RM
from repro.serve.engine import make_serve_step as ref_make_serve_step
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.dist.comm import current
from repro_torch.dist.rules import resolve_rules, splits
from repro_torch.launch import live_mem
from repro_torch.launch import serve as LS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve.engine import make_serve_step

torch.set_num_threads(1)

MESHES = C.MESHES
GRID = [(case, mesh) for mesh in MESHES for case in C.SSM_CASES]


def grid_id(item):
    case, mesh = item
    return f"{C.case_id(case)}-{mesh[0]}x{mesh[1]}"


@pytest.mark.parametrize("item", GRID, ids=grid_id)
def test_prefill_matches_reference(item):
    """The last position's logits of each rank's rows and each rank's
    cache (its rows; its KV heads, Mamba channels, RWKV heads) against
    the reference's."""
    C.check_prefill(*item)


@pytest.mark.parametrize("item", GRID, ids=grid_id)
def test_decode_steps_match_reference(item):
    C.check_decode(*item)


@pytest.mark.parametrize("item", GRID, ids=grid_id)
def test_engine_transcripts_match_reference(item):
    C.check_engine(*item)


@pytest.mark.parametrize("item", [g for g in GRID if g[0][0] == C.JAMBA],
                         ids=grid_id)
def test_routing_is_bit_equal_across_model_ranks(item):
    C.check_routing(*item)


@pytest.mark.parametrize("item", GRID, ids=grid_id)
def test_embedding_and_shard_shapes(item):
    C.check_embedding_and_shapes(*item)


def _cfg(arch, **kw):
    return dataclasses.replace(configs.get_config(arch, smoke=True),
                               dtype="float32", **kw)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_in_proj_holds_both_halves_departure_26(mesh):
    """Mamba's ``in_proj`` [R, d, 2*di] over ``("embed", "mlp")``: the
    reference's shard of model rank m is columns ``[m*2di/P,
    (m+1)*2di/P)`` (rank 0 the whole ``x`` half at P=2), which GSPMD
    re-lays; the port's is columns ``[m*di/P, (m+1)*di/P)`` of the ``x``
    half beside the same of the ``z`` half, the reference's shape with
    other contents, so that the product needs no collective."""
    rcfg, pcfg = C.cfgs((C.JAMBA, "float32", False))
    ref_p, whole = C.params(C.JAMBA)
    rmesh = ref_host_mesh(*mesh)
    rules = ref_resolve_rules(rmesh, rcfg, "decode", batch_size=C.B)
    spec = RM.param_logical_specs(rcfg)["layers"]["pos0"]["mamba"][
        "in_proj"]
    placed = jax.device_put(ref_p["layers"]["pos0"]["mamba"]["in_proj"],
                            rules.sharding(spec))
    ref_shards = {sh.device: np.asarray(sh.data)
                  for sh in placed.addressable_shards}
    full = C.f32(whole["layers"]["pos0"]["mamba"]["in_proj"])
    di = pcfg.mamba_expand * pcfg.d_model
    P = mesh[1]

    def body():
        hm = make_host_mesh(*mesh, device=C.CPU)
        drules = resolve_rules(hm, pcfg, "decode", batch_size=C.B)
        p = M.shard_params(whole, pcfg, drules)
        return (hm.coordinate("data"), hm.coordinate("model"),
                C.f32(p["layers"]["pos0"]["mamba"]["in_proj"]))

    for d, m, got in C._launch(body, mesh[0] * mesh[1]):
        ref = ref_shards[rmesh.devices[d, m]]
        w = 2 * di // P
        np.testing.assert_array_equal(ref, full[..., m * w:(m + 1) * w])
        assert got.shape == ref.shape == (*full.shape[:-1], w)
        c = di // P
        np.testing.assert_array_equal(got, np.concatenate(
            [full[..., m * c:(m + 1) * c],
             full[..., di + m * c:di + (m + 1) * c]], axis=-1))
        assert not np.array_equal(got, ref)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_rwkv_state_by_heads_departure_27(mesh):
    """RWKV's WKV state ``s`` [R, B, H, dh, dh]: the reference's spec
    holds it whole on every rank; a port rank holds its heads. The model
    ranks' states after prefill and after the decode steps, concatenated
    along the heads in rank order, are the reference's whole state."""
    case = (C.RWKV, "float32", False)
    rcfg, _ = C.cfgs(case)
    want = C.reference(case, mesh)
    ranks = C.port(case, mesh)
    H = rcfg.d_model // rcfg.rwkv_head_dim
    for d in range(mesh[0]):
        row = ranks[d * mesh[1]:(d + 1) * mesh[1]]
        b0, b1 = row[0]["rows"]
        assert [r["heads"] for r in row] == [
            (m * H // mesh[1], (m + 1) * H // mesh[1])
            for m in range(mesh[1])]
        for got, ref in ((lambda r: r["prefill"][1], want["prefill"][1]),
                         (lambda r: r["decode_cache"],
                          want["decode_cache"])):
            for pos, c in ref.items():
                whole = c["s"][:, b0:b1]
                assert whole.shape[2] == H
                parts = [got(r)[pos]["s"] for r in row]
                assert all(p.shape[2] == H // mesh[1] for p in parts)
                np.testing.assert_allclose(np.concatenate(parts, axis=2),
                                           whole, **C.TOL["float32"])


def test_rwkv_heads_are_never_cut():
    """rwkv6 SMOKE forced to 3 heads of 16 (d_model 48) at ``model=2``:
    ``heads_joined`` columns divide (48 = 2 x 24) but the heads do not,
    so every time-mix leaf and the state stay whole on both ranks, in
    ``shard_params`` and ``init_params(rules=)`` alike, while the channel
    mix is split by ``mlp``. Each rank's prefill logits and decode steps'
    logits against the reference's ``M.prefill`` and jitted
    ``make_serve_step`` on ``make_host_mesh(1, 2)`` (GSPMD places the
    same config with its heads' columns split), with the reference's
    parameters carried over."""
    overrides = dict(dtype="float32", d_model=48, n_heads=3, n_kv_heads=3)
    rcfg = dataclasses.replace(ref_configs.get_config(C.RWKV, smoke=True),
                               **overrides)
    cfg = _cfg(C.RWKV, **{k: v for k, v in overrides.items()
                          if k != "dtype"})
    ref_p = RM.init_params(rcfg, jax.random.PRNGKey(0))
    whole = params_from_numpy(jax.tree.map(np.asarray, ref_p), C.CPU)
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)

    rmesh = ref_host_mesh(1, 2)
    prules, drules = (ref_resolve_rules(rmesh, rcfg, phase, batch_size=2)
                      for phase in ("prefill", "decode"))
    want, _ = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, prules))(
        ref_p, {"tokens": jnp.asarray(tok)})
    step = jax.jit(ref_make_serve_step(rcfg, drules))
    c = RM.init_cache(rcfg, 2, 8, drules)
    want_steps = []
    for t in range(6):
        _, c, lg = step(ref_p, c, jnp.asarray(tok[:, t:t + 1]),
                        jnp.int32(t))
        want_steps.append(np.asarray(lg, np.float32))

    def serve():
        hm = make_host_mesh(1, 2, device=C.CPU)
        rules, pre = (resolve_rules(hm, cfg, phase, batch_size=2)
                      for phase in ("decode", "prefill"))
        p = M.shard_params(whole, cfg, rules)
        made = M.init_params(cfg, torch.Generator().manual_seed(0), C.CPU,
                             rules=rules)
        cut = M.shard_params(M.init_params(
            cfg, torch.Generator().manual_seed(0), C.CPU), cfg, rules)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(cut), tree_leaves(made)))
        with torch.no_grad():
            logits, _ = M.prefill(p, {"tokens": torch.from_numpy(tok)},
                                  cfg, pre)
            cache = M.init_cache(cfg, 2, 8, rules, device=C.CPU)
            shapes = {k: tuple(v.shape) for k, v in
                      {**p["layers"]["pos0"]["rwkv_t"],
                       "c_wk": p["layers"]["pos0"]["rwkv_c"]["wk"],
                       "s": cache["pos0"]["s"]}.items()}
            serve_step, steps = make_serve_step(cfg, rules), []
            for t in range(6):
                _, cache, lg = serve_step(
                    p, cache, torch.from_numpy(tok[:, t:t + 1]), t)
                steps.append(C.f32(lg))
        return (splits(rules, "heads_joined", 48),
                splits(rules, "heads_joined", 3), shapes, C.f32(logits),
                steps)

    R = cfg.n_repeats
    for cols, heads, shapes, logits, steps in C._launch(serve, 2):
        assert cols and not heads
        assert shapes["wr"] == shapes["wo"] == (R, 48, 48)
        assert shapes["u"] == (R, 3, 16)
        assert shapes["s"] == (R, 2, 3, 16, 16)
        assert shapes["c_wk"] == (R, 48, cfg.d_ff // 2)
        np.testing.assert_allclose(logits, C.f32(want), **C.TOL["float32"])
        np.testing.assert_array_equal(C.greedy(logits, cfg.vocab_size),
                                      C.greedy(want, cfg.vocab_size))
        for t, (g, w) in enumerate(zip(steps, want_steps)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **C.TOL["float32"],
                                       err_msg=f"step {t}")
            np.testing.assert_array_equal(
                C.greedy(g, cfg.vocab_size), C.greedy(w, cfg.vocab_size),
                err_msg=f"step {t}")


def _made_and_cut(arch, mesh):
    """On each rank of ``mesh``: whether ``init_params(rules=)`` equals
    ``shard_params(init_params(...))`` bit for bit (and dtype), the
    number of leaves, and the peak and live bytes ``LiveMemory`` saw
    while ``init_params(rules=)`` ran, with the bytes of the rank's
    shards, of the whole tree and of its largest leaf in float32."""
    cfg = configs.get_config(arch, smoke=True)

    def body():
        hm = make_host_mesh(*mesh, device=C.CPU)
        rules = resolve_rules(hm, cfg, "decode", batch_size=C.B)
        with live_mem.LiveMemory() as mem:
            mine = M.init_params(cfg, torch.Generator().manual_seed(0),
                                 C.CPU, rules=rules)
        whole = M.init_params(cfg, torch.Generator().manual_seed(0), C.CPU)
        cut = M.shard_params(whole, cfg, rules)
        a, b = tree_leaves(mine), tree_leaves(cut)
        same = len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
        return {"same": same, "n": len(a), "rank": current().rank,
                "peak": mem.peak, "live": mem.live,
                "shards": live_mem.storage_bytes(mine),
                "whole": live_mem.storage_bytes(whole),
                "leaf": max(x.numel() for x in tree_leaves(whole)) * 4}

    return C._launch(body, mesh[0] * mesh[1])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_params_rules_is_shard_params_bit_for_bit(arch, mesh):
    for res in _made_and_cut(arch, mesh):
        assert res["same"] and res["n"] > 0, res


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_params_rules_never_holds_the_whole_tree(arch):
    """On each rank of ``(1, 2)``: what ``init_params(rules=)`` leaves is
    its shards, and its peak is those shards and one whole leaf in
    float32 at most (an uncut leaf is kept, not copied), never the whole
    tree: below the whole tree's bytes where the shards are below half
    of them."""
    for res in _made_and_cut(arch, (1, 2)):
        assert res["live"] == res["shards"] < res["whole"], res
        assert res["peak"] <= res["shards"] + res["leaf"], res
        if 2 * res["shards"] <= res["whole"]:
            assert res["peak"] < res["whole"], res


def test_serve_driver_model_parallel_rwkv6_on_rank_processes(capfd):
    """``launch.serve --model-parallel 2`` for rwkv6 SMOKE: two CPU rank
    processes, each making its own shards, and rank 0's transcripts
    those of one rank."""
    base = ["--arch", "rwkv6-3b", "--requests", "2", "--max-new", "3",
            "--device", "cpu"]
    one = LS.main(base)
    got = LS.main(base + ["--model-parallel", "2"])
    assert got == one and [len(t) for t in got] == [3, 3]
    assert "{'data': 1, 'model': 2} ranks on cpu" in capfd.readouterr().out
