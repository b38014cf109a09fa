"""The port's serving path for the dense-family and SSM configs against
the JAX package: phi3-mini, phi4-mini, starcoder2 (dense MLP, swiglu and
gelu), gemma3 (sliding-window attention, 5:1 local/global, dual RoPE
theta), musicgen (codebook inputs), internvl2 (embedding inputs), llama4
(dense and MoE layers, a shared expert, bfloat16 parameters), jamba
(Mamba, attention and MoE layers) and rwkv6 (RWKV6 time and channel
mixes). Each
case runs a config's SMOKE with the reference's parameters
(``init_params`` from ``PRNGKey(0)``) carried over by
``convert.params_from_numpy``, on inputs made with numpy and handed to
both packages.

Tolerances, as tests/test_torch_lm.py's: float32 logits and caches within
1e-4 (rtol and atol) with equal greedy tokens, bfloat16 within 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.dist.rules import resolve_rules
from repro.launch.mesh import make_host_mesh
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.serve.engine import make_serve_step as ref_make_serve_step
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import make_serve_step

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)

MESH = make_host_mesh()
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
ARCHS = ["phi3_mini_3p8b", "phi4_mini_3p8b", "starcoder2_7b", "gemma3_1b",
         "musicgen_large", "internvl2_76b", "llama4_maverick_400b_a17b",
         "jamba_1p5_large_398b", "rwkv6_3b"]
SERVED = [a for a in ARCHS if a != "internvl2_76b"]
_PARAMS = {}


def _cfgs(arch, dtype):
    ref = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                              dtype=dtype)
    port = dataclasses.replace(configs.get_config(arch, smoke=True),
                               dtype=dtype)
    return ref, port


def _params(arch):
    """The reference's SMOKE parameters and the port's copy of them."""
    if arch not in _PARAMS:
        ref = RM.init_params(ref_configs.get_config(arch, smoke=True),
                             jax.random.PRNGKey(0))
        _PARAMS[arch] = (ref, params_from_numpy(
            jax.tree.map(np.asarray, ref), "cpu"))
    return _PARAMS[arch]


def _inputs(cfg, B, S, seed):
    """A batch for ``cfg``'s input mode, as numpy: token ids [B, S],
    codebook ids [B, S, n] or float32 embeddings [B, S, D]."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    shape = (B, S) if cfg.input_mode == "tokens" else (B, S, cfg.n_codebooks)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape)
            .astype(np.int32)}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tc(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _at(batch, t):
    return {k: v[:, t:t + 1] for k, v in batch.items()}


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _greedy(logits, vocab):
    return np.argmax(_np(logits)[..., :vocab], axis=-1)


def _next_input(cfg, logits, seed):
    """The next step's input: the greedy tokens of ``logits`` ([B, 1] or
    [B, 1, n]), or seeded embeddings [B, 1, D]."""
    if cfg.input_mode == "embeddings":
        B = logits.shape[0]
        return _inputs(cfg, B, 1, seed)
    return {"tokens": _greedy(logits, cfg.vocab_size).astype(np.int32)}


def _assert_caches(got, want, tol):
    """Every leaf of every position: K/V, or an SSM layer's state."""
    for pos, kv in want.items():
        assert set(got[pos]) == set(kv), pos
        for kk in kv:
            assert got[pos][kk].shape == kv[kk].shape, f"{pos} {kk}"
            np.testing.assert_allclose(_np(got[pos][kk]), _np(kv[kk]),
                                       **tol, err_msg=f"{pos} {kk}")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    mod, ref = configs.get(arch), ref_configs.get(arch)
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(mod, name)) == \
            dataclasses.asdict(getattr(ref, name))
    assert mod.LONG_CONTEXT_OK == ref.LONG_CONTEXT_OK
    assert configs.long_context_ok(arch) == ref_configs.long_context_ok(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_tree_and_count_match_reference(arch):
    """The full config builds the reference's tree, leaf for leaf (shapes
    only: on the meta device here, abstract in the reference)."""
    cfg = configs.get_config(arch)
    ref_cfg = ref_configs.get_config(arch)
    tree = M._param_tree(cfg, lambda shape, axes, scale, init="normal":
                         torch.empty(shape, device="meta"))
    ref_tree = RM.abstract_params(ref_cfg)
    got = {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
           jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
            jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert got == want
    assert M.param_count(tree) == RM.param_count(ref_tree)
    assert cfg.param_count() == ref_cfg.param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    ref_p, port_p = _params(arch)
    rcfg, pcfg = _cfgs(arch, dtype)
    batch = _inputs(pcfg, 2, 32, 0)
    rules = resolve_rules(MESH, rcfg, "train")
    want, _, wstats = jax.jit(lambda p: RM.forward(
        p, _jx(batch), rcfg, rules, remat=False))(ref_p)
    got, _, gstats = M.forward(port_p, _tc(batch), pcfg)
    assert got.shape == tuple(want.shape) and got.dtype == pcfg.act_dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(gstats["moe_dropped_frac"]),
                               float(wstats["moe_dropped_frac"]), atol=1e-6)
    if dtype == "float32":
        np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                      _greedy(want, pcfg.vocab_size))


def _ref_step(cfg):
    rules = resolve_rules(MESH, cfg, "decode")
    return jax.jit(lambda p, c, b, pos: RM.decode_step(p, c, b, pos, cfg,
                                                       rules))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    """12 one-token steps from an empty 16-position cache (gemma3's SWA
    layers past their window of 8)."""
    ref_p, port_p = _params(arch)
    rcfg, pcfg = _cfgs(arch, dtype)
    batch = _inputs(pcfg, 2, 12, 1)
    step = _ref_step(rcfg)
    wcache = RM.init_cache(rcfg, 2, 16, resolve_rules(MESH, rcfg, "decode"))
    gcache = M.init_cache(pcfg, 2, 16, device="cpu")
    for t in range(12):
        want, wcache = step(ref_p, wcache, _jx(_at(batch, t)), jnp.int32(t))
        got, gcache = M.decode_step(port_p, gcache, _tc(_at(batch, t)), t,
                                    pcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=f"step {t}")
        if dtype == "float32":
            np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                          _greedy(want, pcfg.vocab_size))
    _assert_caches(gcache, wcache, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_extend_decode_matches_reference(arch, dtype):
    """prefill (logits of the last position and the cache), then
    extend_cache and 4 decode steps, each fed the reference's greedy
    tokens (or the same seeded embeddings), in both packages."""
    ref_p, port_p = _params(arch)
    rcfg, pcfg = _cfgs(arch, dtype)
    P, EXTRA = 16, 4
    batch = _inputs(pcfg, 2, P, 2)
    rules = resolve_rules(MESH, rcfg, "decode")
    want, wcache = jax.jit(lambda p: RM.prefill(p, _jx(batch), rcfg,
                                                rules))(ref_p)
    got, gcache = M.prefill(port_p, _tc(batch), pcfg)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    _assert_caches(gcache, wcache, TOL[dtype])
    wcache = RM.extend_cache(wcache, rcfg, P + EXTRA)
    gcache = M.extend_cache(gcache, pcfg, P + EXTRA)
    step = _ref_step(rcfg)
    for t in range(EXTRA):
        if dtype == "float32":
            np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                          _greedy(want, pcfg.vocab_size))
        nxt = _next_input(pcfg, want, 10 + t)
        want, wcache = step(ref_p, wcache, _jx(nxt), jnp.int32(P + t))
        got, gcache = M.decode_step(port_p, gcache, _tc(nxt), P + t, pcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=f"step {t}")


def test_extend_cache_refuses_to_shrink_as_the_reference_does():
    """A prefill cache longer than max_seq: jnp.pad refuses a negative pad
    in the reference; the port raises ValueError (torch's pad would crop
    the cache without a word)."""
    ref_p, port_p = _params("gemma3_1b")
    rcfg, pcfg = _cfgs("gemma3_1b", "float32")
    batch = _inputs(pcfg, 1, 8, 9)
    _, wcache = RM.prefill(ref_p, _jx(batch), rcfg,
                           resolve_rules(MESH, rcfg, "decode"))
    _, gcache = M.prefill(port_p, _tc(batch), pcfg)
    with pytest.raises(ValueError):
        RM.extend_cache(wcache, rcfg, 4)
    with pytest.raises(ValueError, match="more than max_seq=4"):
        M.extend_cache(gcache, pcfg, 4)


def _requests(cls, cfg, eos):
    rng = np.random.default_rng(7)
    lens = [5, 3, 7, 4, 6, 2]
    shape = (() if cfg.input_mode == "tokens" else (cfg.n_codebooks,))
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab_size, (n, *shape))
                .astype(np.int32), max_new=6, eos_id=eos.get(i))
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", SERVED)
def test_serve_engine_transcripts_match_reference(arch):
    """ServeEngine.run, 6 requests of mixed prompt lengths at batch 4,
    float32: transcripts (codebook 0 for musicgen) equal the reference
    engine's, EOS included."""
    ref_p, port_p = _params(arch)
    rcfg, pcfg = _cfgs(arch, "float32")
    rules = resolve_rules(MESH, rcfg, "decode")
    probe = _requests(RRequest, rcfg, {})
    RServeEngine(rcfg, rules, ref_p, batch=4, max_seq=32).run(probe)
    eos = {1: probe[1].out[2]}
    want = _requests(RRequest, rcfg, eos)
    RServeEngine(rcfg, rules, ref_p, batch=4, max_seq=32).run(want)
    got = _requests(Request, pcfg, eos)
    ServeEngine(pcfg, None, port_p, batch=4, max_seq=32).run(got)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)
    assert len(got[1].out) <= 3 and got[1].out[-1] == eos[1]


def test_embeddings_mode_serve_step_matches_reference():
    """internvl2: make_serve_step over seeded [B, 1, D] embeddings, 8
    steps, in both packages (next tokens equal, logits within 1e-4). The
    engine takes token prompts, which an embeddings config has no table
    for: the reference's engine fails on it, the port's raises
    ValueError."""
    arch = "internvl2_76b"
    ref_p, port_p = _params(arch)
    rcfg, pcfg = _cfgs(arch, "float32")
    rules = resolve_rules(MESH, rcfg, "decode")
    ref_step = jax.jit(ref_make_serve_step(rcfg, rules))
    step = make_serve_step(pcfg)
    wcache = RM.init_cache(rcfg, 3, 8, rules)
    gcache = M.init_cache(pcfg, 3, 8, device="cpu")
    emb = _inputs(pcfg, 3, 8, 4)["embeddings"]
    for t in range(8):
        wn, wcache, wl = ref_step(ref_p, wcache, jnp.asarray(emb[:, t:t + 1]),
                                  jnp.int32(t))
        gn, gcache, gl = step(port_p, gcache, torch.from_numpy(
            emb[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(gl), _np(wl), **TOL["float32"])
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert ServeEngine(pcfg, None, port_p, batch=2, max_seq=16).device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="embeddings"):
        ServeEngine(pcfg, None, port_p, batch=2, max_seq=16).run(
            _requests(Request, dataclasses.replace(pcfg,
                                                   input_mode="tokens"), {}))
    with pytest.raises(Exception):
        RServeEngine(rcfg, rules, ref_p, batch=2, max_seq=16).run(
            _requests(RRequest, dataclasses.replace(rcfg,
                                                    input_mode="tokens"), {}))


def test_gemma3_prefill_at_flash_length_matches_reference():
    """One gemma3 SMOKE prefill at the real FLASH_S_MIN = 4096, float32:
    the five sliding-window layers take _local_band in both packages, the
    global layer the reference's _flash_full and the port's
    ops.flash_attention (its plain version on the CPU), once."""
    ref_p, port_p = _params("gemma3_1b")
    rcfg, pcfg = _cfgs("gemma3_1b", "float32")
    batch = _inputs(pcfg, 1, 4096, 3)
    rules = resolve_rules(MESH, rcfg, "decode")
    want, wcache = jax.jit(lambda p: RM.prefill(p, _jx(batch), rcfg,
                                                rules))(ref_p)
    ops.reset_launch_counts()
    got, gcache = M.prefill(port_p, _tc(batch), pcfg)
    counts = ops.launch_counts()
    assert counts["flash_attention_plain"] == 1
    assert counts["flash_attention_tc"] == counts["flash_attention"] == 0
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    _assert_caches(gcache, wcache, TOL["float32"])
    np.testing.assert_array_equal(_greedy(got, pcfg.vocab_size),
                                  _greedy(want, pcfg.vocab_size))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_cache_matches_reference_and_full_cache(dtype):
    """tests/test_ring_cache.py's case (gemma3 SMOKE, window 8, B=2, 24
    steps = 3 windows) with swa_ring_cache: the port's ring cache against
    the reference's, and against the port's own full-length cache within
    that test's 2e-2."""
    ref_p, port_p = _params("gemma3_1b")
    rcfg, pcfg = _cfgs("gemma3_1b", dtype)
    rring = dataclasses.replace(rcfg, swa_ring_cache=True)
    pring = dataclasses.replace(pcfg, swa_ring_cache=True)
    B, S = 2, 24
    toks = _inputs(pcfg, B, S, 0)
    rules = resolve_rules(MESH, rring, "decode")
    wcache = RM.init_cache(rring, B, S, rules)
    gcache = M.init_cache(pring, B, S, device="cpu")
    fcache = M.init_cache(pcfg, B, S, device="cpu")
    swa = [i for i, sp in enumerate(pcfg.pattern) if sp.attn == "swa"][0]
    assert gcache[f"pos{swa}"]["k"].shape[2] == pcfg.window
    assert fcache[f"pos{swa}"]["k"].shape[2] == S
    step = _ref_step(rring)
    for t in range(S):
        want, wcache = step(ref_p, wcache, _jx(_at(toks, t)), jnp.int32(t))
        got, gcache = M.decode_step(port_p, gcache, _tc(_at(toks, t)), t,
                                    pring)
        full, fcache = M.decode_step(port_p, fcache, _tc(_at(toks, t)), t,
                                     pcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(got), _np(full), rtol=2e-2,
                                   atol=2e-2, err_msg=f"step {t}")
    _assert_caches(gcache, wcache, TOL[dtype])


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [8, 512, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_band_matches_reference(dtype, window, softcap):
    """_local_band alone at S = 2048 (two band blocks of 1024), MQA 4:1,
    against the reference's on the same q, k, v: float32 out in both."""
    rcfg = dataclasses.replace(ref_configs.get_config("gemma3_1b",
                                                      smoke=True),
                               window=window, logit_softcap=softcap)
    pcfg = dataclasses.replace(configs.get_config("gemma3_1b", smoke=True),
                               window=window, logit_softcap=softcap)
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal((1, 2048, n, 16)).astype(np.float32)
               for n in (4, 1, 1))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = RL._local_band(*(jnp.asarray(a, jdt) for a in (q, k, v)), rcfg)
    got = L._local_band(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                        pcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_local_band_refuses_ragged_sequences_as_the_reference_does():
    """S not a multiple of the band block (1024 at window 512): the
    reference's assert fails, the port raises ValueError."""
    rcfg = ref_configs.get_config("gemma3_1b")
    pcfg = configs.get_config("gemma3_1b")
    q = np.zeros((1, 1536, 4, 16), np.float32)
    kv = np.zeros((1, 1536, 1, 16), np.float32)
    with pytest.raises(AssertionError):
        RL._local_band(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                       rcfg)
    with pytest.raises(ValueError, match="multiple of the band block 1024"):
        L._local_band(torch.from_numpy(q), torch.from_numpy(kv),
                      torch.from_numpy(kv), pcfg)


def test_swa_layers_rotate_at_the_local_theta():
    """gemma3: sliding-window layers use rope_theta (1e4), global layers
    rope_theta_global (1e6), in the reference and the port: one SWA
    attention call equals the reference's and differs from a run at the
    global theta."""
    ref_p, port_p = _params("gemma3_1b")
    rcfg, pcfg = _cfgs("gemma3_1b", "float32")
    rp = {kk: vv[0] for kk, vv in ref_p["layers"]["pos0"]["attn"].items()}
    pp = {kk: vv[0] for kk, vv in port_p["layers"]["pos0"]["attn"].items()}
    x = np.random.default_rng(6).standard_normal(
        (1, 24, rcfg.d_model)).astype(np.float32)
    rules = resolve_rules(MESH, rcfg, "decode")
    want, _ = RL.attention(rp, jnp.asarray(x), rcfg, rules, kind="swa")
    got, _ = L.attention(pp, torch.from_numpy(x), pcfg, kind="swa")
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    glob = dataclasses.replace(pcfg, rope_theta=pcfg.rope_theta_global)
    other, _ = L.attention(pp, torch.from_numpy(x), glob, kind="swa")
    assert not np.allclose(_np(other), _np(want), rtol=1e-3, atol=1e-3)


def test_params_from_numpy_carries_bfloat16_leaves():
    """llama4 keeps its parameters in bfloat16 (CONFIG's param_dtype; its
    SMOKE tree in that type here): numpy holds them as ml_dtypes.bfloat16,
    which torch.from_numpy refuses. The port's tree has the same bits as
    torch.bfloat16, and its float32 forward on them equals the
    reference's within 1e-4."""
    arch = "llama4_maverick_400b_a17b"
    pdt = configs.get_config(arch).param_dtype
    assert pdt == "bfloat16"
    rcfg, pcfg = (dataclasses.replace(c, param_dtype=pdt)
                  for c in _cfgs(arch, "float32"))
    ref_p = RM.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_p)
    leaf = tree["layers"]["pos1"]["moe"]["shared"]["w_gate"]
    assert leaf.dtype.name == "bfloat16"
    with pytest.raises(TypeError):
        torch.from_numpy(np.array(leaf))
    got = params_from_numpy(tree, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, a in flat:
        t = got
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    as32 = params_from_numpy(tree, "cpu", torch.float32)
    np.testing.assert_array_equal(
        as32["layers"]["pos1"]["moe"]["shared"]["w_gate"].numpy(),
        leaf.astype(np.float32))
    batch = _inputs(pcfg, 2, 16, 8)
    want, _, _ = RM.forward(ref_p, _jx(batch), rcfg,
                            resolve_rules(MESH, rcfg, "train"), remat=False)
    out, _, _ = M.forward(got, _tc(batch), pcfg)
    np.testing.assert_allclose(_np(out), _np(want), **TOL["float32"])


@pytest.mark.parametrize("arch", SERVED)
def test_launch_serve_runs_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                "--batch", "2", "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out


def test_launch_serve_exits_for_the_embeddings_arch():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="precomputed embeddings"):
        serve.main(["--device", "cpu", "--arch", "internvl2-76b"])
