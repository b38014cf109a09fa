"""Shared set-up of the tests of serving over the ``model`` axis
(tests/test_torch_serve_model*.py): the port's prefill, decode steps and
``ServeEngine`` on ``(data, model)`` thread ranks against the reference's
``M.prefill`` and jitted ``make_serve_step`` on ``make_host_mesh(data,
model)`` (virtual jax devices: GSPMD over ``dist/rules.py``'s table),
with the reference's SMOKE parameters (``init_params`` from
``PRNGKey(0)``) carried over by ``convert.params_from_numpy`` and cut to
each rank's shards by ``models.model.shard_params``.

Each (case, mesh) runs once a module: ``reference`` and ``port`` cache
their results, and the tests read them.

Tolerances, tests/test_torch_lm.py's: float32 logits and caches within
1e-4 (rtol and atol) with equal greedy tokens; bfloat16 within 5e-2, the
reference's own decode-vs-forward tolerance (a rank's partial sums of
``wo``, ``w_down`` and the experts round to bf16 before the all-reduce,
as GSPMD's do, but the two frameworks' products round at other places).
In bfloat16 the engine's transcripts are held token for token up to the
first step where the reference's top-2 logit gap is under that
tolerance (a near-tie either side may take); the row is exempt from
there on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec

from repro import configs as ref_configs
from repro.dist.rules import resolve_rules as ref_resolve_rules
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import model as RM
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro.serve.engine import make_serve_step as ref_make_serve_step
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.dist import launch
from repro_torch.dist.comm import current
from repro_torch.dist.rules import local_range, resolve_rules
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import make_serve_step

CPU = "cpu"
DEADLINE = 300.0
# batch, prompt, new tokens, cache length, decode steps (past gemma3
# SMOKE's window of 8, so its ring cache wraps)
B, P, NEW, MAX_SEQ, STEPS = 4, 12, 6, 24, 10
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
MESHES = [(1, 2), (2, 2)]
GRANITE, GEMMA = "granite_moe_3b_a800m", "gemma3_1b"
ARCHS = [GRANITE, GEMMA, "starcoder2_7b", "phi3_mini_3p8b",
         "llama4_maverick_400b_a17b", "musicgen_large", "internvl2_76b"]
# (arch, dtype, gemma3's ring cache)
CASES = ([(a, "float32", False) for a in ARCHS] +
         [(GEMMA, "float32", True), (GRANITE, "bfloat16", False),
          (GEMMA, "bfloat16", False)])
# jamba (Mamba by mlp channels, attention, MoE) and rwkv6 (RWKV by heads):
# tests/test_torch_serve_model_ssm.py
JAMBA, RWKV = "jamba_1p5_large_398b", "rwkv6_3b"
SSM_CASES = [(JAMBA, "float32", False), (RWKV, "float32", False),
             (JAMBA, "bfloat16", False)]
MOE = {GRANITE, "llama4_maverick_400b_a17b", JAMBA}
_PARAMS: dict = {}
_REF: dict = {}
_PORT: dict = {}


def case_id(case) -> str:
    arch, dtype, ring = case
    return f"{arch}-{dtype}" + ("-ring" if ring else "")


def cfgs(case):
    """(the reference's config, the port's) of a case."""
    arch, dtype, ring = case
    out = []
    for mod in (ref_configs, configs):
        cfg = dataclasses.replace(mod.get_config(arch, smoke=True),
                                  dtype=dtype)
        if ring:
            cfg = dataclasses.replace(cfg, swa_ring_cache=True)
        out.append(cfg)
    return tuple(out)


def params(arch):
    """The reference's SMOKE parameters and the port's whole copy."""
    if arch not in _PARAMS:
        ref = RM.init_params(ref_configs.get_config(arch, smoke=True),
                             jax.random.PRNGKey(0))
        _PARAMS[arch] = (ref, params_from_numpy(
            jax.tree.map(np.asarray, ref), CPU))
    return _PARAMS[arch]


def inputs(cfg, S, seed):
    """A batch of B rows for ``cfg``'s input mode, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    shape = (B, S) if cfg.input_mode == "tokens" else (B, S, cfg.n_codebooks)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape)
            .astype(np.int32)}


def step_input(batch, t):
    """Step t's [B, 1(, ...)] input of a batch's only key."""
    (v,) = batch.values()
    return v[:, t:t + 1]


def requests(cfg, pkg):
    """Four requests of prompts of P, P - 2, P and P - 4 tokens (the
    engine pads the shorter ones), ``NEW`` new tokens each."""
    rng = np.random.default_rng(7)
    out = []
    for uid, n in enumerate((P, P - 2, P, P - 4)):
        shape = (n,) if cfg.input_mode == "tokens" else (n, cfg.n_codebooks)
        out.append(pkg(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                                    shape).astype(np.int32),
                       max_new=NEW))
    return out


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def reference(case, mesh):
    """The reference on ``make_host_mesh(*mesh)``: prefill (last logits
    and cache), ``STEPS`` decode steps of its jitted serve step from an
    empty cache (logits a step, the final cache), and the engine's
    transcripts with the logits of every engine step."""
    key = (case, mesh)
    if key in _REF:
        return _REF[key]
    rcfg, pcfg = cfgs(case)
    ref_p, _ = params(case[0])
    rmesh = ref_host_mesh(*mesh)
    drules = ref_resolve_rules(rmesh, rcfg, "decode", batch_size=B)
    prules = ref_resolve_rules(rmesh, rcfg, "prefill", batch_size=B)
    pre = inputs(pcfg, P, 1)
    logits, cache = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, prules))(
        ref_p, {k: jnp.asarray(v) for k, v in pre.items()})
    step = jax.jit(ref_make_serve_step(rcfg, drules))
    dec_in = inputs(pcfg, STEPS, 2)
    c = RM.init_cache(rcfg, B, MAX_SEQ, drules)
    dec = []
    for t in range(STEPS):
        _, c, lg = step(ref_p, c, jnp.asarray(step_input(dec_in, t)),
                        jnp.int32(t))
        dec.append(f32(lg))
    out = {"prefill": (f32(logits), _tree_np(cache)),
           "decode": dec, "decode_cache": _tree_np(c)}
    if pcfg.input_mode != "embeddings":
        seen = []

        def recorded(p, cc, tok, pos):
            res = step(p, cc, tok, pos)
            seen.append(f32(res[2]))
            return res

        engine = RServeEngine(rcfg, drules, ref_p, batch=B, max_seq=MAX_SEQ)
        engine.step_fn = recorded
        reqs = engine.run(requests(rcfg, RRequest))
        out["engine"] = ([list(r.out) for r in reqs], seen)
    _REF[key] = out
    return out


def _launch(fn, nranks):
    got = {}

    def body():
        got[current().rank] = fn()

    launch.launch(body, nranks, device=CPU, threads=True, timeout=DEADLINE)
    return [got[r] for r in range(nranks)]


def _shapes(tree):
    return [tuple(x.shape) for x in tree_leaves(tree)]


def port(case, mesh):
    """The port on ``mesh`` thread ranks, the same inputs as
    ``reference``: on each rank, its (data, model) coordinates, prefill
    (its rows' logits and its cache), the decode steps' logits (whole)
    and final cache, the engine's transcripts, the experts each router
    call chose, whether the embedding of its rows is bit-equal to one
    rank's, and the shapes of its parameter shards and caches."""
    key = (case, mesh)
    if key in _PORT:
        return _PORT[key]
    _, pcfg = cfgs(case)
    _, whole = params(case[0])
    pre, dec_in = inputs(pcfg, P, 1), inputs(pcfg, STEPS, 2)
    routed: dict = {}
    inner = ops.router_topk_divide

    def recording(x, c, infl, k):
        idx, eff = inner(x, c, infl, k)
        routed.setdefault(current().rank, []).append(idx.clone())
        return idx, eff

    def body():
        torch.set_num_threads(1)
        hm = make_host_mesh(*mesh, device=CPU)
        drules = resolve_rules(hm, pcfg, "decode", batch_size=B)
        prules = resolve_rules(hm, pcfg, "prefill", batch_size=B)
        p = M.shard_params(whole, pcfg, drules)
        b0, b1 = local_range(drules, "act_batch", B)
        rows = {k: torch.from_numpy(v[b0:b1]) for k, v in pre.items()}
        with torch.no_grad():
            logits, cache = M.prefill(p, rows, pcfg, prules)
            emb_same = torch.equal(M._embed_input(p, rows, pcfg, drules),
                                   M._embed_input(whole, rows, pcfg))
            step = make_serve_step(pcfg, drules)
            c = M.init_cache(pcfg, B, MAX_SEQ, drules, device=CPU)
            cache_shapes = _shapes(c)
            dec = []
            for t in range(STEPS):
                _, c, lg = step(p, c, torch.from_numpy(
                    step_input(dec_in, t)), t)
                dec.append(f32(lg))
            res = {"coord": (hm.coordinate("data"), hm.coordinate("model")),
                   "rows": (b0, b1),
                   "kv": local_range(drules, "cache_kv", pcfg.n_kv_heads),
                   "mlp": local_range(drules, "mlp",
                                      pcfg.mamba_expand * pcfg.d_model),
                   "heads": local_range(drules, "heads_joined",
                                        pcfg.d_model // pcfg.rwkv_head_dim),
                   "prefill": (f32(logits), _tree_np(cache)),
                   "decode": dec, "decode_cache": _tree_np(c),
                   "emb_same": emb_same, "param_shapes": _shapes(p),
                   "cache_shapes": cache_shapes}
            if pcfg.input_mode != "embeddings":
                engine = ServeEngine(pcfg, drules, p, batch=B,
                                     max_seq=MAX_SEQ)
                reqs = engine.run(requests(pcfg, Request))
                res["engine"] = [list(r.out) for r in reqs]
        return res

    ops.router_topk_divide = recording
    try:
        ranks = _launch(body, mesh[0] * mesh[1])
    finally:
        ops.router_topk_divide = inner
    for r, res in enumerate(ranks):
        res["routed"] = routed.get(r, [])
    _PORT[key] = ranks
    return ranks


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return f32(tree)


# the dim of each cache leaf a rank holds a part of, and the key of the
# rank's range in ``port``'s results: attention's KV heads of k/v [R, B,
# T, KV, dh], Mamba's channels of h [R, B, di, ds] and conv [R, B, dk-1,
# di], RWKV's heads of s [R, B, H, dk, dv] (whole in the reference's
# spec: ROADMAP.md queue 3 item 27); RWKV's shifts whole
CACHE_PARTS = {"k": (3, "kv"), "v": (3, "kv"), "h": (2, "mlp"),
               "conv": (3, "mlp"), "s": (2, "heads")}


def cache_slice(tree, res):
    """The reference's whole cache at a rank's rows and parts
    (``CACHE_PARTS``) of ``port``'s rank result ``res``."""
    b0, b1 = res["rows"]
    out = {}
    for pos, c in tree.items():
        out[pos] = {}
        for k, v in c.items():
            v = v[:, b0:b1]
            if k in CACHE_PARTS:
                dim, key = CACHE_PARTS[k]
                lo, hi = res[key]
                v = v[(slice(None),) * dim + (slice(lo, hi),)]
            out[pos][k] = v
    return out


def assert_caches(got, want, tol, what):
    for pos, kv in want.items():
        for kk, w in kv.items():
            g = got[pos][kk]
            assert g.shape == w.shape, f"{what} {pos} {kk}"
            np.testing.assert_allclose(g, w, **tol,
                                       err_msg=f"{what} {pos} {kk}")


def greedy(logits, vocab):
    return np.argmax(np.asarray(logits)[..., :vocab], axis=-1)


def exempt_from(seen, transcripts, cfg, tol):
    """For each request: the index of its first transcript token whose
    logits' top-2 gap (codebook 0's for codebook configs) is under
    ``tol``, or its length (no near-tie). ``seen[k]`` holds the logits of
    the engine's call at position k; token j of a request comes from the
    call at ``pmax - 1 + j`` (every request's prompt is padded to
    ``pmax``)."""
    pmax = P
    out = []
    for i, toks in enumerate(transcripts):
        first = len(toks)
        for j in range(len(toks)):
            lg = np.asarray(seen[pmax - 1 + j][i], np.float32)
            row = lg.reshape(-1, lg.shape[-1])[0][:cfg.vocab_size]
            top = np.sort(row)[-2:]
            if top[1] - top[0] < tol:
                first = j
                break
        out.append(first)
    return out


def expected_shard_shapes(rcfg, mesh, tree, specs, phase="decode"):
    """The reference's shard shape of each leaf of ``tree`` (shapes) by
    its logical ``specs``: ``rules.sharding(spec).shard_shape`` where the
    extent divides the leaf, and where it does not (``jax.device_put``
    refuses such a leaf; ``Rules.shard`` drops the axis), the same shape
    taken one dimension at a time, each dimension whose shard_shape
    raises held whole."""
    rules = ref_resolve_rules(ref_host_mesh(*mesh), rcfg, phase,
                              batch_size=B)
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple))
    assert len(leaves) == len(spec_leaves)
    out = []
    for leaf, spec in zip(leaves, spec_leaves):
        shape = tuple(leaf.shape)
        try:
            out.append(tuple(rules.sharding(spec).shard_shape(shape)))
            continue
        except ValueError:
            pass
        dims = []
        for i, n in enumerate(shape):
            one = [None] * len(shape)
            one[i] = rules.spec(*spec)[i]
            try:
                dims.append(JaxNamedSharding(
                    rules.mesh, PartitionSpec(*one)).shard_shape(shape)[i])
            except ValueError:
                dims.append(n)
        out.append(tuple(dims))
    return out


def check_prefill(case, mesh):
    rcfg, pcfg = cfgs(case)
    want = reference(case, mesh)["prefill"]
    tol = TOL[case[1]]
    for res in port(case, mesh):
        b0, b1 = res["rows"]
        logits, cache = res["prefill"]
        assert logits.shape == want[0][b0:b1].shape
        np.testing.assert_allclose(logits, want[0][b0:b1], **tol)
        if case[1] == "float32":
            np.testing.assert_array_equal(
                greedy(logits, pcfg.vocab_size),
                greedy(want[0][b0:b1], pcfg.vocab_size))
        assert_caches(cache, cache_slice(want[1], res), tol, "prefill")


def check_decode(case, mesh):
    rcfg, pcfg = cfgs(case)
    want = reference(case, mesh)
    tol = TOL[case[1]]
    for res in port(case, mesh):
        for t, (got, w) in enumerate(zip(res["decode"], want["decode"])):
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, **tol, err_msg=f"step {t}")
            if case[1] == "float32":
                np.testing.assert_array_equal(
                    greedy(got, pcfg.vocab_size),
                    greedy(w, pcfg.vocab_size), err_msg=f"step {t}")
        assert_caches(res["decode_cache"],
                      cache_slice(want["decode_cache"], res), tol, "decode")


def check_engine(case, mesh):
    rcfg, pcfg = cfgs(case)
    want, seen = reference(case, mesh)["engine"]
    ranks = port(case, mesh)
    for res in ranks[1:]:
        assert res["engine"] == ranks[0]["engine"]
    got = ranks[0]["engine"]
    assert [len(t) for t in got] == [len(t) for t in want] == [NEW] * 4
    if case[1] == "float32":
        assert got == want
        return
    upto = exempt_from(seen, want, pcfg, TOL[case[1]]["atol"])
    for g, w, n in zip(got, want, upto):
        assert g[:n] == w[:n]


def check_routing(case, mesh):
    """Every router call's experts, bit-equal on the ranks that share a
    data coordinate (the model ranks of one row of the mesh)."""
    ranks = port(case, mesh)
    for res in ranks:
        assert res["routed"], "no router call"
        lead = ranks[res["coord"][0] * mesh[1]]
        assert len(res["routed"]) == len(lead["routed"])
        for a, b in zip(res["routed"], lead["routed"]):
            assert torch.equal(a, b)


def check_embedding_and_shapes(case, mesh):
    """The embedding of a rank's rows bit-equal to one rank's (a sum of
    one value and zeros), and each rank's parameter and cache shards of
    the reference's ``shard_shape``, but RWKV's ``s``: the rank's heads
    where the reference's spec holds it whole (ROADMAP.md queue 3 item
    27)."""
    rcfg, pcfg = cfgs(case)
    ref_p, _ = params(case[0])
    want_p = expected_shard_shapes(rcfg, mesh, ref_p,
                                     RM.param_logical_specs(rcfg))
    rules = ref_resolve_rules(ref_host_mesh(*mesh), rcfg, "decode",
                                batch_size=B)
    ref_cache = RM.init_cache(rcfg, B, MAX_SEQ, rules)
    want_c = expected_shard_shapes(rcfg, mesh, ref_cache,
                                   RM.cache_logical_specs(rcfg))
    keys = [path[-1].key for path, _ in
            jax.tree_util.tree_flatten_with_path(ref_cache)[0]]
    for res in port(case, mesh):
        h0, h1 = res["heads"]
        want = [(*w[:2], h1 - h0, *w[3:]) if k == "s" else w
                for k, w in zip(keys, want_c)]
        assert res["emb_same"]
        assert res["param_shapes"] == want_p
        assert res["cache_shapes"] == want
