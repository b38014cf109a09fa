"""The port's granite serving path against the JAX package: granite SMOKE
with the reference's parameters (``init_params`` from ``PRNGKey(0)``)
carried over by ``convert.params_from_numpy``; token inputs made with
numpy and handed to both.

Tolerances: in float32 the forward, per-step decode and prefill logits and
the prefill cache agree within 1e-4 (rtol and atol: the two frameworks sum
float32 products in other orders, ~1e-6 relative, and the cosines of RoPE
may differ in the last ulp), and greedy tokens are equal. In bfloat16 the
reference's own decode-vs-forward tolerance, 5e-2
(tests/test_arch_smoke.py), since every product rounds to 8 bits in both
frameworks at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_moe_3b_a800m as ref_granite
from repro.dist.rules import resolve_rules
from repro.launch.mesh import make_host_mesh
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch import configs
from repro_torch.configs import granite_moe_3b_a800m as granite
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import router_near_tie_case
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serve import Request, ServeEngine

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)

MESH = make_host_mesh()
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _cfgs(dtype, capacity_factor=None):
    ref, port = ref_granite.SMOKE, granite.SMOKE
    ref = dataclasses.replace(ref, dtype=dtype)
    port = dataclasses.replace(port, dtype=dtype)
    if capacity_factor is not None:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(
            ref.moe, capacity_factor=capacity_factor))
        port = dataclasses.replace(port, moe=dataclasses.replace(
            port.moe, capacity_factor=capacity_factor))
    return ref, port


@pytest.fixture(scope="module")
def params():
    ref = RM.init_params(ref_granite.SMOKE, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref)
    return ref, params_from_numpy(tree, "cpu")


def _tokens(B, S, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _greedy(logits, vocab):
    return np.argmax(_np(logits)[..., :vocab], axis=-1)


def _ref_decode(params, cfg, toks, T):
    rules = resolve_rules(MESH, cfg, "decode")
    step = jax.jit(lambda p, c, t, pos:
                   RM.decode_step(p, c, {"tokens": t}, pos, cfg, rules))
    cache = RM.init_cache(cfg, toks.shape[0], T, rules)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        outs.append(_np(lg))
    return np.concatenate(outs, axis=1), cache


def _port_decode(params, cfg, toks, T, cache=None, start=0):
    if cache is None:
        cache = M.init_cache(cfg, toks.shape[0], T, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = M.decode_step(params, cache,
                                  {"tokens": torch.from_numpy(
                                      toks[:, t:t + 1])}, start + t, cfg)
        outs.append(_np(lg))
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(params, dtype):
    ref_p, port_p = params
    rcfg, pcfg = _cfgs(dtype)
    toks = _tokens(2, 32, 0, pcfg.vocab_size)
    rules = resolve_rules(MESH, rcfg, "train")
    want, _, wstats = jax.jit(lambda p: RM.forward(
        p, {"tokens": jnp.asarray(toks)}, rcfg, rules, remat=False))(ref_p)
    got, _, gstats = M.forward(port_p, {"tokens": torch.from_numpy(toks)},
                               pcfg)
    assert got.shape == (2, 32, pcfg.vocab_padded) and got.dtype == \
        pcfg.act_dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(gstats["moe_dropped_frac"]),
                               float(wstats["moe_dropped_frac"]), atol=1e-6)
    if dtype == "float32":
        np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                      _greedy(want, pcfg.vocab_size))


def test_forward_influence_update_matches_reference(params):
    """The router state carried through forward: new influence per layer
    (paper Eq. 1 on realized loads), float32."""
    ref_p, port_p = params
    rcfg, pcfg = _cfgs("float32")
    toks = _tokens(2, 32, 5, pcfg.vocab_size)
    rules = resolve_rules(MESH, rcfg, "train")
    infl0 = np.random.default_rng(5).uniform(
        0.8, 1.25, (rcfg.n_repeats, 1, rcfg.moe.n_experts)).astype(np.float32)
    assert MOE.init_router_state(pcfg, "cpu")["influence"].shape == \
        RMOE.init_router_state(rcfg)["influence"].shape == infl0.shape
    _, want, _ = jax.jit(lambda p: RM.forward(
        p, {"tokens": jnp.asarray(toks)}, rcfg, rules, remat=False,
        influence=jnp.asarray(infl0)))(ref_p)
    _, got, _ = M.forward(port_p, {"tokens": torch.from_numpy(toks)}, pcfg,
                          influence=torch.from_numpy(infl0))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_moe_apply_at_planted_near_ties_matches_reference(monkeypatch):
    """moe_apply with an adapted influence on integer-valued tokens and
    centroids whose planted pairs tie under the reference's divide
    (ref.router_near_tie_case, top_k 2, drop-free capacity): the port picks
    the reference's experts, so its output, new influence and load stats
    agree; routed by the multiply form instead, each token takes the other
    expert of its pair and the new influence moves away by the clip."""
    E, K, S = 18, 2, 6
    rcfg, pcfg = _cfgs("float32", capacity_factor=E / K)
    rcfg, pcfg = (dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=E, top_k=K)) for cfg in (rcfg, pcfg))
    D, F = rcfg.d_model, rcfg.moe.d_ff
    x, c, infl = router_near_tie_case(S, E, D, seed=10)
    rng = np.random.default_rng(10)
    p = {"centroids": c,
         "router": rng.standard_normal((D, E)) * D ** -0.5,
         "w_gate": rng.standard_normal((E, D, F)) * D ** -0.5,
         "w_up": rng.standard_normal((E, D, F)) * D ** -0.5,
         "w_down": rng.standard_normal((E, F, D)) * F ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    rules = resolve_rules(MESH, rcfg, "train")
    want, winf, wst = RMOE.moe_apply({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x[None]), rcfg,
                                     rules, influence=jnp.asarray(infl))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}

    def port():
        return MOE.moe_apply(tp, torch.from_numpy(x[None]), pcfg,
                             influence=torch.from_numpy(infl))

    got, ginf, gst = port()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ginf), _np(winf), rtol=1e-6, atol=0)
    assert float(gst["load_imbalance"]) == float(wst["load_imbalance"])
    monkeypatch.setattr(ops, "router_topk_divide",
                        lambda xx, cc, ii, k: ops.router_topk(xx, cc, ii, k))
    mout, minf, _ = port()
    assert not np.allclose(_np(mout), _np(want), rtol=1e-3, atol=1e-3)
    assert np.max(np.abs(_np(minf) / _np(winf) - 1)) > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(params, dtype):
    ref_p, port_p = params
    rcfg, pcfg = _cfgs(dtype)
    toks = _tokens(2, 12, 1, pcfg.vocab_size)
    want, wcache = _ref_decode(ref_p, rcfg, toks, 16)
    got, gcache = _port_decode(port_p, pcfg, toks, 16)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_allclose(_np(gcache["pos0"]["k"]),
                               _np(wcache["pos0"]["k"]), **TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                      _greedy(want, pcfg.vocab_size))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(params, dtype):
    ref_p, port_p = params
    rcfg, pcfg = _cfgs(dtype)
    toks = _tokens(2, 16, 2, pcfg.vocab_size)
    rules = resolve_rules(MESH, rcfg, "decode")
    want, wcache = jax.jit(lambda p: RM.prefill(
        p, {"tokens": jnp.asarray(toks)}, rcfg, rules))(ref_p)
    got, gcache = M.prefill(port_p, {"tokens": torch.from_numpy(toks)}, pcfg)
    assert got.shape == (2, 1, pcfg.vocab_padded)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    for kk in ("k", "v"):
        np.testing.assert_allclose(_np(gcache["pos0"][kk]),
                                   _np(wcache["pos0"][kk]), **TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                      _greedy(want, pcfg.vocab_size))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_extend_decode_matches_stepwise(params, dtype):
    """prefill -> extend_cache -> decode hands decode_step a cache that
    equals stepping token by token (the serving handoff). Drop-free
    capacity, as the reference's decode-vs-forward test: a full-sequence
    MoE drops tokens at expert capacity, a one-token step never does."""
    _, port_p = params
    _, pcfg = _cfgs(dtype, capacity_factor=16.0)
    B, P, EXTRA = 2, 16, 4
    toks = _tokens(B, P, 4, pcfg.vocab_size)
    logits_p, cache = M.prefill(port_p, {"tokens": torch.from_numpy(toks)},
                                pcfg)
    cache = M.extend_cache(cache, pcfg, P + EXTRA)
    assert cache["pos0"]["k"].shape[2] == P + EXTRA
    step_logits, cache2 = _port_decode(port_p, pcfg, toks, P + EXTRA)
    np.testing.assert_allclose(_np(logits_p), step_logits[:, -1:],
                               **TOL[dtype])
    nxt = _greedy(logits_p, pcfg.vocab_size).astype(np.int32)
    for t in range(EXTRA):
        lg_a, cache = M.decode_step(port_p, cache,
                                    {"tokens": torch.from_numpy(nxt)},
                                    P + t, pcfg)
        lg_b, cache2 = M.decode_step(port_p, cache2,
                                     {"tokens": torch.from_numpy(nxt)},
                                     P + t, pcfg)
        np.testing.assert_allclose(_np(lg_a), _np(lg_b), **TOL[dtype])
        nxt = _greedy(lg_b, pcfg.vocab_size).astype(np.int32)


def test_prefill_at_flash_length_matches_reference(params):
    """One prefill at the real FLASH_S_MIN = 4096, no monkeypatching: the
    reference takes its chunked _flash_full, the port ops.flash_attention
    (its plain version on the CPU), in every layer, and the router in
    every layer. float32."""
    ref_p, port_p = params
    rcfg, pcfg = _cfgs("float32")
    toks = _tokens(1, 4096, 3, pcfg.vocab_size)
    rules = resolve_rules(MESH, rcfg, "decode")
    want, wcache = jax.jit(lambda p: RM.prefill(
        p, {"tokens": jnp.asarray(toks)}, rcfg, rules))(ref_p)
    ops.reset_launch_counts()
    got, gcache = M.prefill(port_p, {"tokens": torch.from_numpy(toks)}, pcfg)
    counts = ops.launch_counts()
    assert counts["flash_attention_plain"] == pcfg.n_layers
    assert counts["router_topk_plain"] == pcfg.n_layers
    assert counts["flash_attention_tc"] == counts["flash_attention"] == 0
    assert counts["router_topk"] == 0
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    for kk in ("k", "v"):
        np.testing.assert_allclose(_np(gcache["pos0"][kk]),
                                   _np(wcache["pos0"][kk]),
                                   **TOL["float32"])
    np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                  _greedy(want, pcfg.vocab_size))


def _requests(cls, vocab, eos):
    rng = np.random.default_rng(7)
    lens = [5, 3, 7, 4, 6, 2]
    return [cls(uid=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                max_new=6, eos_id=eos.get(i)) for i, n in enumerate(lens)]


def test_serve_engine_transcripts_match_reference(params):
    """ServeEngine.run, 6 requests of mixed prompt lengths at batch 4 (the
    second group leaves two padded slots), float32: transcripts equal the
    reference engine's, EOS included (request 1 stops at the third token
    it would have emitted)."""
    ref_p, port_p = params
    rcfg, pcfg = _cfgs("float32")
    rules = resolve_rules(MESH, rcfg, "decode")
    probe = _requests(RRequest, rcfg.vocab_size, {})
    RServeEngine(rcfg, rules, ref_p, batch=4, max_seq=32).run(probe)
    eos = {1: probe[1].out[2]}
    want = _requests(RRequest, rcfg.vocab_size, eos)
    RServeEngine(rcfg, rules, ref_p, batch=4, max_seq=32).run(want)
    got = _requests(Request, pcfg.vocab_size, eos)
    ops.reset_launch_counts()
    ServeEngine(pcfg, None, port_p, batch=4, max_seq=32).run(got)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)
    assert len(got[1].out) <= 3 and got[1].out[-1] == eos[1]
    # decode steps: (7 prompt + 6) for the first group, (6 + 6) for the
    # second, one router call per layer each
    assert ops.launch_counts()["router_topk_plain"] == \
        pcfg.n_layers * (13 + 12)


def test_launch_serve_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out


def test_full_config_shapes_and_count():
    """The full granite config builds the reference's tree: 3,376,645,632
    parameters (shapes only, on the meta device)."""
    cfg = granite.CONFIG
    tree = M._param_tree(cfg, lambda shape, axes, scale, init="normal":
                         torch.empty(shape, device="meta"))
    assert M.param_count(tree) == 3_376_645_632
    assert cfg.param_count() == ref_granite.CONFIG.param_count()
    assert cfg == dataclasses.replace(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_granite.CONFIG)
    assert dataclasses.asdict(granite.SMOKE) == dataclasses.asdict(
        ref_granite.SMOKE)
    assert cfg.act_dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(configs.ALIASES))
def test_registry_knows_every_arch_and_serves_granite_only(name):
    """Every arch of the reference, by CLI alias: all ten are ported
    (granite first, the dense family next, the SSM archs jamba and rwkv6
    last) and return the reference's configs field for field; none raises
    NotYetPortedError (the name is kept from when granite was the only
    one served)."""
    from repro import configs as ref_configs
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.ALIASES == ref_configs.ALIASES
    assert sorted(configs.PORTED) == sorted(configs.ARCHS)
    assert configs.get_config("granite-moe-3b-a800m") is granite.CONFIG
    arch = configs.ALIASES[name]
    assert arch in configs.PORTED
    mod = configs.get(name)
    assert mod.__name__ == f"repro_torch.configs.{arch}"
    for smoke in (False, True):
        assert dataclasses.asdict(configs.get_config(name, smoke)) == \
            dataclasses.asdict(ref_configs.get_config(name, smoke))
    with pytest.raises(KeyError):
        configs.get("nope")


def test_serve_step_refuses_sampling_on_purpose():
    """A deliberate departure: the reference's make_serve_step accepts any
    ``sample`` and decodes greedily all the same; the port raises for
    anything but "greedy" rather than ignore the request."""
    from repro_torch.serve.engine import make_serve_step
    _, pcfg = _cfgs("float32")
    for sample in ("temperature", "top_p", "nucleus"):
        with pytest.raises(ValueError, match="only greedy"):
            make_serve_step(pcfg, sample=sample)
    assert callable(make_serve_step(pcfg, sample="greedy"))


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(granite.SMOKE, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(granite.SMOKE, 1, 8)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([])
