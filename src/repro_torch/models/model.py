"""Unified decoder-only LM (reference: ``repro/models/model.py``): full and
sliding-window attention, Mamba and RWKV6 layers (``ssm.py``) with dense
or MoE MLPs (an RWKV layer's channel mix in the MLP's place), over token,
codebook (musicgen) or precomputed-embedding (internvl2) inputs.

Parameters are built through one structure function (``_param_tree``)
driven by a ``create`` callback, as in the reference, so the tree and its
key names match (``convert.params_from_numpy`` carries a reference tree
over). Layer stacks keep the leading ``repeat`` dim; the reference's
``lax.scan`` over repeats is a Python loop over the stacked ``[R, ...]``
weights here, each leaf unbound once a forward (one stack in the
backward, where a select per layer would allocate a zero tensor of the
whole leaf for each layer's gradient). ``unroll`` only shapes the
reference's compiled program and is accepted and ignored. ``rules``
(``dist.rules.Rules``) matters on a mesh of several data ranks in
train: a rank then holds each leaf that the rules split over ``data``
(every ``embed`` leaf) as its shard, and the forward makes it whole
where it is used (``dist.fsdp.gather``): the embedding table and the
head at their use, a layer's leaves inside the layer, so that remat's
recompute gathers them again. In serving (``prefill``, ``decode_step``,
``init_cache``) ``rules`` shard over ``model`` as well: a rank holds the
shards ``shard_params`` cuts (heads, ``mlp``, experts, vocabulary) and
its own cache, each layer computes on its shards and all-reduces its
partial sums once (``layers.py``, ``moe.py``), the embedding looks up
the rank's vocabulary range, zero elsewhere, and all-reduces (exact: one
value and zeros), and the head's logits are all-gathered along the
vocabulary (exact). Over ``data`` a rank holds its own batch rows.
Mamba layers are split by ``mlp`` channels and RWKV layers by heads
(``ssm.py``). ``init_params(..., rules=)`` makes only the rank's shards,
bit-equal to ``shard_params`` of the whole tree. ``abstract_params``
gives the tree as
``meta`` tensors, and ``param_logical_specs`` and ``cache_logical_specs``
its logical axis names, as the reference's do. ``remat`` with
gradients on wraps each layer in ``torch.utils.checkpoint`` (the
reference checkpoints each repeat of its scan): the backward recomputes
the layer's forward, kernels included, from its input.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist import fsdp
from repro_torch.dist.comm import current, using
from repro_torch.dist.rules import (enter_split, gather_split, local_range,
                                    param_shardings, reduce_partial,
                                    splits)

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import LayerSpec, ModelConfig


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _layer_params(cfg, spec: LayerSpec, create):
    p = {"ln1": L.rmsnorm_params(cfg.d_model, create),
         "ln2": L.rmsnorm_params(cfg.d_model, create)}
    if spec.attn in ("full", "swa"):
        p["attn"] = L.attention_params(cfg, create, spec.attn)
    elif spec.attn == "mamba":
        p["mamba"] = SSM.mamba_params(cfg, create)
    elif spec.attn == "rwkv":
        p["rwkv_t"] = SSM.rwkv_params(cfg, create)
    if spec.attn == "rwkv":
        p["rwkv_c"] = SSM.rwkv_channel_params(cfg, create)
    elif spec.mlp == "dense":
        p["mlp"] = L.mlp_params(cfg, create)
    else:
        p["moe"] = MOE.moe_params(cfg, create)
    return p


def _param_tree(cfg: ModelConfig, create):
    V, D = cfg.vocab_padded, cfg.d_model

    def stacked(shape, axes, scale, init="normal"):
        return create((cfg.n_repeats, *shape), ("repeat", *axes), scale, init)

    p: dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        p["embed"] = create((V, D), ("vocab", "embed"), 1.0)
    elif cfg.input_mode == "codebooks":
        p["embed"] = create((cfg.n_codebooks, V, D),
                            ("nil", "vocab", "embed"), 1.0)
    # embeddings mode: no input table (a modality frontend supplies them)
    p["layers"] = {f"pos{i}": _layer_params(cfg, spec, stacked)
                   for i, spec in enumerate(cfg.pattern)}
    p["final_norm"] = L.rmsnorm_params(D, create)
    if not cfg.tie_embeddings:
        if cfg.input_mode == "codebooks":
            p["lm_head"] = create((cfg.n_codebooks, D, V),
                                  ("nil", "embed", "vocab"), D ** -0.5)
        else:
            p["lm_head"] = create((D, V), ("embed", "vocab"), D ** -0.5)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                rules=None):
    """Random parameters in ``cfg.param_dtype``: normal draws of
    ``generator`` (made on the generator's device) times each leaf's
    scale; norms at one and the reference's constant inits for the SSM
    leaves (mixes at 0.5, Mamba's ``A_log`` at log(1..d_state), its
    ``dt_bias`` at -4.6, RWKV's ``w0`` at -0.7). ``device`` defaults to
    ``cuda``. The draws are not the reference's ``jax.random`` bits: tests
    carry the reference's parameters over with
    ``convert.params_from_numpy``.

    ``rules`` (a rank of several): only the rank's shards, bit-equal to
    ``shard_params(init_params(cfg, generator), cfg, rules)``. Each leaf
    is drawn whole, in the same order from the same generator, and cut at
    once (before its cast), so a rank holds its shards and one whole leaf
    in float32 at most, never the whole tree."""
    dev = resolve_device(device)
    pdt = getattr(torch, cfg.param_dtype)
    fills = {"ones": 1.0, "zeros": 0.0, "half": 0.5,
             "ssm_dt": -4.6,       # softplus^-1(0.01)
             "ssm_w0": -0.7}       # decay ~ exp(-exp(w0)) ~ 0.6 a step

    def create(shape, axes, scale, init="normal", cut=None):
        if init in fills:
            w = torch.full(shape, fills[init], dtype=pdt, device=dev)
        elif init == "ssm_a":      # A_log: log(1..d_state) per state dim
            w = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                       device=dev)).expand(shape)
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            w.mul_(scale if scale else 0.02)
        part = w if cut is None else cut(w)
        if part.shape == w.shape:
            return w.to(device=dev, dtype=pdt).contiguous()
        return _own(part.to(device=dev, dtype=pdt).contiguous(), w)

    if rules is None or rules.mesh.size == 1:
        return _param_tree(cfg, create)
    # a first pass numbers the leaves in the order _param_tree creates
    # them; the second creates them in that order again, each cut to the
    # rank's shard by its path
    count = itertools.count()
    paths = {n: path for path, n in _items(_param_tree(
        cfg, lambda *args, **kwargs: next(count)))}
    shardings = rank_shardings(cfg, rules)
    made = itertools.count()

    def create_cut(shape, axes, scale, init="normal"):
        return create(shape, axes, scale, init,
                      cut=_at(shardings, paths[next(made)]).local)

    return _param_tree(cfg, create_cut)


def abstract_params(cfg: ModelConfig, rules=None):
    """The parameter tree as ``meta`` tensors of ``cfg.param_dtype``: the
    shapes and dtypes without storage (the reference's
    ``ShapeDtypeStruct`` tree). ``rules`` (a rank of several): the
    rank's shards, cut as ``init_params(..., rules=)`` cuts them
    (``rank_shardings``)."""
    pdt = getattr(torch, cfg.param_dtype)
    tree = _param_tree(
        cfg, lambda shape, axes, scale, init="normal":
        torch.empty(shape, dtype=pdt, device="meta"))
    if rules is None or rules.mesh.size == 1:
        return tree

    def cut(x, sh):
        if isinstance(x, dict):
            return {k: cut(v, sh[k]) for k, v in x.items()}
        return torch.empty(sh.shard_shape(tuple(x.shape)), dtype=pdt,
                           device="meta")

    return cut(tree, rank_shardings(cfg, rules))


def param_shapes(cfg: ModelConfig):
    """The parameter tree's whole shapes, a ``torch.Size`` a leaf: what
    the step code reads of ``abstract_params`` with no tensor made (on a
    dry run's ``meta`` tensors a made tensor would count as memory)."""
    return _param_tree(
        cfg, lambda shape, axes, scale, init="normal": torch.Size(shape))


def param_logical_specs(cfg: ModelConfig):
    """The parameter tree's logical axis names, a tuple a leaf."""
    return _param_tree(
        cfg, lambda shape, axes, scale, init="normal": tuple(axes))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _index(tree, r: int):
    """Every leaf of ``tree`` at index ``r`` of its leading dim (a view)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unbind(tree, n: int) -> list:
    """``[_index(tree, r) for r in range(n)]``, each leaf unbound once:
    views of the same values, whose backward is one stack a leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in parts.items()} for r in range(n)]
    return torch.unbind(tree)


def _stack(trees: list):
    """Stack a list of identically shaped trees along a new leading dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _items(tree, path=()):
    """(path, leaf) of every leaf of a tree of dicts, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, (*path, k))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _own(part, whole):
    """``part`` in storage of its own: copied where it is a view of
    ``whole``'s (a cut, or a cast that changed nothing)."""
    if part.untyped_storage().data_ptr() == \
            whole.untyped_storage().data_ptr():
        return part.clone()
    return part


def param_count(params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def shard_params(params, cfg: ModelConfig, rules):
    """The rank's shards of the whole parameter tree ``params`` (from
    ``init_params`` or ``convert.params_from_numpy``) under ``rules``:
    each leaf split where the extent divides the dimension its logical
    spec names (``NamedSharding.local``; the reference's
    ``rules.sharding(spec).shard_shape``), copied into its own storage,
    and whole elsewhere; Mamba's ``in_proj`` by ``ssm.in_proj_local``,
    RWKV's heads never cut (``rank_shardings``). ``params`` itself
    without rules or on one rank."""
    if rules is None or rules.mesh.size == 1:
        return params
    shardings = rank_shardings(cfg, rules)

    def cut(tree, sh):
        if isinstance(tree, dict):
            return {k: cut(v, sh[k]) for k, v in tree.items()}
        part = sh.local(tree)
        return tree if part.shape == tree.shape else _own(part, tree)

    return cut(params, shardings)


def rank_shardings(cfg: ModelConfig, rules):
    """Each leaf's sharding on a rank, as the port cuts it: its logical
    spec's ``NamedSharding``, with RWKV's ``heads_joined`` held whole
    where the extent does not divide the heads (``splits`` on the head
    count, not on the ``H * dh`` columns: rwkv6's 40 heads at
    ``model=16`` would be cut at 2.5 a rank; the layers take the same
    decision, ``ssm.rwkv_time_mix``), and Mamba's ``in_proj`` cut by
    halves (``ssm.InProjSharding``: ``ssm.in_proj_local``). What cuts or
    joins a leaf goes through it: ``shard_params``, ``init_params(...,
    rules=)``, the train state's shards (``train.step.state_shardings``)
    and the checkpoints' save and restore."""
    specs = param_logical_specs(cfg)
    if not splits(rules, "heads_joined", cfg.d_model // cfg.rwkv_head_dim):
        specs = _map_specs(specs, lambda spec: tuple(
            None if a == "heads_joined" else a for a in spec))

    def cut(tree, key=None):
        if isinstance(tree, dict):
            return {k: cut(v, k) for k, v in tree.items()}
        return SSM.InProjSharding(tree) if key == "in_proj" else tree

    return cut(param_shardings(rules, specs))


def _map_specs(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_specs(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def fsdp_plan(cfg, rules):
    """Where the parameters of ``cfg`` are held as shards under
    ``rules`` (``dist.fsdp.plan``): {"top": the splits of ``embed`` and
    ``lm_head``, "layers": each pattern position's splits of one repeat's
    leaves}, or None when no leaf is split (one data rank, or a phase
    that does not shard ``embed``)."""
    if rules is None or rules.mesh.size == 1:
        return None
    shapes = param_shapes(cfg)
    sh = param_shardings(rules, param_logical_specs(cfg))
    top = fsdp.plan({k: sh[k] for k in ("embed", "lm_head") if k in sh},
                    {k: shapes[k] for k in ("embed", "lm_head")
                     if k in shapes})
    layers = fsdp.plan(sh["layers"], shapes["layers"], drop_leading=True)
    if top is None and layers is None:
        return None
    return {"top": top or {}, "layers": layers or {}}


def _top_leaf(params, key, plan):
    """``params[key]`` whole (gathered where ``plan`` splits it)."""
    split = None if plan is None else plan["top"].get(key)
    return fsdp.gather(params[key], split)


def _rank_rows(table, tok, cfg, rules):
    """``table[tok]`` in the activation dtype (gather, then cast: the
    same bits as the reference's cast-then-gather). On a mesh that splits
    ``vocab``, ``table`` is the rank's rows ``[v0, v1)`` and a token
    outside them reads zero: the caller sums the ranks' rows."""
    if not splits(rules, "vocab", cfg.vocab_padded):
        return table[tok].to(cfg.act_dtype)
    v0, v1 = local_range(rules, "vocab", cfg.vocab_padded)
    ids = tok - v0
    mine = (ids >= 0) & (ids < v1 - v0)
    rows = table[torch.where(mine, ids, 0)].to(cfg.act_dtype)
    return torch.where(mine[..., None], rows, 0)


def _embed_input(params, batch, cfg, rules=None, plan=None):
    """tokens: the table's rows times sqrt(d); codebooks ([B, S, n] ids):
    the sum of each codebook's rows, codebook 0 first, in the activation
    dtype and unscaled; embeddings: ``batch["embeddings"]`` [B, S, D] cast
    to the activation dtype. ``plan``: ``fsdp_plan``'s, the table
    gathered first. Over ``vocab``-split ranks, the ranks' rows
    (``_rank_rows``) are all-reduced once, before the codebooks' sum and
    the scale: a sum of one value and zeros, so ``x`` is bit-equal to one
    rank's."""
    dt = cfg.act_dtype
    V = cfg.vocab_padded
    if cfg.input_mode == "embeddings":
        return batch["embeddings"].to(dt)
    tok = batch["tokens"].long()
    emb = _top_leaf(params, "embed", plan)
    if cfg.input_mode == "codebooks":
        rows = reduce_partial(torch.stack([
            _rank_rows(emb[i], tok[..., i], cfg, rules)
            for i in range(cfg.n_codebooks)]), rules, "vocab", V)
        return sum(rows[i] for i in range(cfg.n_codebooks))
    x = reduce_partial(_rank_rows(emb, tok, cfg, rules), rules, "vocab", V)
    # sqrt(d) rounded to the activation dtype first, as the reference
    # does; the product of two such values is exact before its rounding
    scale = float(torch.tensor(cfg.d_model ** 0.5).to(dt))
    return x * scale


def _layer_apply(p, spec: LayerSpec, x, cfg, rules=None, positions=None,
                 cache=None, pos=None, influence=None, unroll_chunks=False,
                 want_cache=False):
    """One pattern-position layer. Returns (x, new_cache, new_infl, stats).

    ``want_cache`` (prefill): with cache=None, also emit the end-of-
    sequence cache in the decode layout.

    Decode updates ``cache`` in place and returns it: attention writes
    K/V at ``pos``; an SSM layer's state is replaced as a whole, so its
    new values are copied into the cache's own tensors (the views of the
    stacked cache that ``decode_step`` hands in)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    new_cache = None
    if spec.attn in ("full", "swa"):
        out, new_cache = L.attention(p["attn"], h, cfg, rules, spec.attn,
                                     positions, cache=cache, cache_pos=pos,
                                     want_cache=want_cache)
    elif spec.attn == "mamba":
        out, st = SSM.mamba_apply(p["mamba"], h, cfg, rules, state=cache,
                                  want_state=want_cache)
        if st is not None:
            new_cache = _store(cache, None, st)
    else:  # rwkv
        st = None if cache is None else {"s": cache["s"],
                                         "shift": cache["shift_t"]}
        out, st = SSM.rwkv_time_mix(p["rwkv_t"], h, cfg, rules, state=st,
                                    want_state=want_cache)
        if st is not None:
            new_cache = _store(cache, None,
                               {"s": st["s"], "shift_t": st["shift"]})
    x = x + out

    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    new_infl, stats = None, {}
    if spec.attn == "rwkv":
        st = None if cache is None else cache["shift_c"]
        out2, st = SSM.rwkv_channel_mix(p["rwkv_c"], h2, cfg, rules,
                                        state=st, want_state=want_cache)
        if st is not None:
            new_cache = _store(cache, new_cache, {"shift_c": st})
    elif spec.mlp == "dense":
        out2 = L.mlp(p["mlp"], h2, cfg, rules)
    else:
        out2, new_infl, stats = MOE.moe_apply(p["moe"], h2, cfg, rules,
                                              influence)
    return x + out2, new_cache, new_infl, stats


def _remat_layer(p, spec, x, cfg, rules, positions, influence, gather,
                 comm):
    """The layer ``torch.utils.checkpoint`` recomputes in the backward:
    its leaves made whole by ``gather`` (``dist.fsdp.gather_tree`` of the
    layer's splits: the recompute gathers them again) and
    ``_layer_apply`` at training (no cache), with ``comm`` (the rank's
    communicator when the forward ran, or None) the calling thread's:
    the recompute may run on the autograd engine's device thread (CUDA),
    where the rank's own is not set, and its collectives must go through
    the forward's. Its recompute routes as the first pass did (the
    router kernel is deterministic); the influence and loads it
    recomputes are dropped, the first pass's are kept."""
    with contextlib.nullcontext() if comm is None else using(comm):
        return _layer_apply(gather(p), spec, x, cfg, rules, positions,
                            influence=influence)


def _store(cache, built, state):
    """An SSM layer's new ``state`` (a dict): at decode (``cache`` given)
    copied into the cache's own tensors, and the cache returned; at
    prefill added to the cache ``built`` so far (a dict or None)."""
    if cache is None:
        return {**(built or {}), **state}
    for key, val in state.items():
        cache[key].copy_(val)
    return cache


def forward(params, batch, cfg: ModelConfig, rules=None, unroll: bool = False,
            remat: bool = True, influence=None, want_cache: bool = False,
            last_only: bool = False):
    """Training/prefill forward. Returns (logits, new_influence, moe_stats)
    or, with ``want_cache``, (logits, new_influence, moe_stats, cache).

    ``influence``: [n_repeats, n_moe, E] balanced-k-means router state;
    with it, ``moe_stats["moe_load"]`` holds each MoE layer's realized
    expert loads on this rank's rows, [n_repeats, n_moe, E] (what the
    train step sums over the data ranks).
    ``want_cache``: emit the populated decode cache (prefill).
    ``last_only``: unembed only the final position."""
    del unroll
    remat = remat and torch.is_grad_enabled() and not want_cache
    comm = current() if remat else None
    plan = fsdp_plan(cfg, rules)
    x = _embed_input(params, batch, cfg, rules, plan)
    S = x.shape[1]
    dev = x.device
    positions = torch.arange(S, device=dev)
    moe_positions = [i for i, s in enumerate(cfg.pattern) if s.mlp == "moe"
                     and s.attn != "rwkv"]
    use_infl = influence is not None
    E = cfg.moe.n_experts if cfg.moe else 1
    layer_plans = {} if plan is None else plan["layers"]
    gathers = [functools.partial(fsdp.gather_tree,
                                 plan=layer_plans.get(f"pos{i}"))
               for i in range(len(cfg.pattern))]
    ninfs, loads, drops, caches = [], [], [], []
    for r, p_r in enumerate(_unbind(params["layers"], cfg.n_repeats)):
        new_infls, loads_r = [], []
        drop = torch.zeros((), dtype=torch.float32, device=dev)
        cache_r = {}
        for i, spec in enumerate(cfg.pattern):
            li = moe_positions.index(i) if i in moe_positions else None
            inf_i = influence[r][li] if (use_infl and li is not None) \
                else None
            if remat:
                x, nc, ni, st = checkpoint(
                    _remat_layer, p_r[f"pos{i}"], spec, x, cfg, rules,
                    positions, inf_i, gathers[i], comm, use_reentrant=False)
            else:
                x, nc, ni, st = _layer_apply(gathers[i](p_r[f"pos{i}"]),
                                             spec, x, cfg, rules, positions,
                                             influence=inf_i,
                                             want_cache=want_cache)
            if want_cache:
                cache_r[f"pos{i}"] = nc
            if li is not None:
                new_infls.append(ni if ni is not None else
                                 torch.ones(E, dtype=torch.float32,
                                            device=dev))
                if "load" in st:
                    loads_r.append(st["load"])
                drop = drop + st.get("dropped_frac", 0.0)
        ninfs.append(torch.stack(new_infls) if new_infls else
                     torch.zeros((0, 1), dtype=torch.float32, device=dev))
        if loads_r:
            loads.append(torch.stack(loads_r))
        drops.append(drop)
        caches.append(cache_r)
    new_influence = torch.stack(ninfs) if use_infl else None
    drop_frac = torch.mean(torch.stack(drops))

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = _unembed(params, x, cfg, rules, plan)
    stats = {"moe_dropped_frac": drop_frac}
    if use_infl and loads:
        stats["moe_load"] = torch.stack(loads)
    if want_cache:
        return logits, new_influence, stats, _stack(caches)
    return logits, new_influence, stats


def prefill(params, batch, cfg: ModelConfig, rules=None, unroll: bool = False):
    """Serving prefill: full-sequence forward that returns the last-position
    logits and the populated decode cache (the layout of
    ``init_cache``/``decode_step``). Over ranks (``rules``): ``params``
    are the rank's shards (``shard_params``) and ``batch`` the rank's
    rows; the logits come back whole along the vocabulary, the cache is
    the rank's."""
    logits, _, _, cache = forward(params, batch, cfg, rules, unroll=unroll,
                                  remat=False, want_cache=True,
                                  last_only=True)
    return logits, cache


def _unembed(params, x, cfg, rules=None, plan=None):
    """Logits [B, S, V], or [B, S, n_codebooks, V] with one head a
    codebook. ``plan``: ``fsdp_plan``'s, the head gathered first. Over
    ``vocab``-split ranks, each rank's logits of its vocabulary range are
    all-gathered along the last dim (exact; the backward keeps the rank's
    range of the whole gradient), and ``x`` is entered
    (``dist.rules.enter_split``)."""
    dt = x.dtype
    # whole, feeding the rank's vocabulary range: entered for the backward
    x = enter_split(x, rules, "vocab", cfg.vocab_padded)
    if cfg.tie_embeddings:
        w = _top_leaf(params, "embed", plan).to(dt).T
    else:
        w = _top_leaf(params, "lm_head", plan).to(dt)
    if cfg.input_mode == "codebooks":
        logits = torch.einsum("bsd,ndv->bsnv", x, w)
    else:
        logits = x @ w
    return gather_split(logits, rules, "vocab", cfg.vocab_padded, -1)


def loss_fn(logits, labels, cfg, z_loss: float = 1e-4):
    """Mean cross entropy over the padded vocab in float32: padded ids
    masked at -1e30, ``logsumexp - gold``, plus ``z_loss * logsumexp^2``
    when ``z_loss``. ``logits`` [B, S, V] with ``labels`` [B, S], or
    [B, S, n, V] with [B, S, n] (codebooks)."""
    V = cfg.vocab_padded
    lf = logits.to(torch.float32)
    if cfg.vocab_size < V:
        pad = torch.arange(V, device=lf.device) >= cfg.vocab_size
        lf = torch.where(pad, -1e30, lf)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, rules=None,
               device=None):
    """Per-pattern-position caches stacked over repeats, zero-filled: K/V
    in the activation dtype, SSM states as ``ssm.mamba_state_init`` /
    ``ssm.rwkv_state_init`` make them. A ``swa`` layer of a config with
    ``swa_ring_cache`` gets a ring of ``min(max_seq, window)`` slots.
    ``device`` defaults to ``cuda``. With ``rules``, the rank's cache of
    a ``batch`` of global rows: its rows where ``act_batch`` divides
    ``batch``, its KV heads where ``cache_kv`` divides them (whole where
    not: gemma3's one KV head at ``model=2``), its Mamba channels and its
    RWKV heads as the layers hold them (``mlp``; ``heads_joined`` by
    whole heads). RWKV's ``s`` is the rank's heads where the reference's
    spec holds it whole (ROADMAP.md queue 3 item 27): whole, it would
    cost an all-gather a layer a step."""
    dev = resolve_device(device)
    dt = cfg.act_dtype
    R = cfg.n_repeats
    b0, b1 = local_range(rules, "act_batch", batch)
    batch = b1 - b0
    k0, k1 = local_range(rules, "cache_kv", cfg.n_kv_heads)
    c0, c1 = local_range(rules, "mlp", cfg.mamba_expand * cfg.d_model)
    h0, h1 = local_range(rules, "heads_joined",
                         cfg.d_model // cfg.rwkv_head_dim)
    cache = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.attn in ("mamba", "rwkv"):
            st = (SSM.mamba_state_init(cfg, batch, dt, dev, di=c1 - c0)
                  if spec.attn == "mamba" else
                  SSM.rwkv_state_init(cfg, batch, dev,
                                      heads=h1 - h0))
            cache[f"pos{i}"] = {k: v.expand(R, *v.shape).contiguous()
                                for k, v in st.items()}
            continue
        seq = max_seq
        if spec.attn == "swa" and cfg.swa_ring_cache:
            seq = min(max_seq, cfg.window)
        shape = (R, batch, seq, k1 - k0, cfg.hd)
        cache[f"pos{i}"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                            "v": torch.zeros(shape, dtype=dt, device=dev)}
    return cache


def extend_cache(cache, cfg: ModelConfig, max_seq: int):
    """Pad a prefill-produced cache (seq length = prompt) out to the decode
    horizon so ``decode_step`` can write positions >= prompt length."""
    out = {}
    for i, spec in enumerate(cfg.pattern):
        c = cache[f"pos{i}"]
        if spec.attn not in ("full", "swa"):     # SSM states pass through
            out[f"pos{i}"] = c
            continue
        pad = max_seq - c["k"].shape[2]
        if pad < 0:     # the reference's jnp.pad refuses it too
            raise ValueError(f"extend_cache: the cache holds "
                             f"{c['k'].shape[2]} positions, more than "
                             f"max_seq={max_seq}")
        out[f"pos{i}"] = {kk: torch.nn.functional.pad(
            v, (0, 0, 0, 0, 0, pad)) for kk, v in c.items()}
    return out


def cache_logical_specs(cfg: ModelConfig):
    """The decode cache's logical axis names, a tuple a leaf, in
    ``init_cache``'s tree."""
    specs = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.attn in ("full", "swa"):
            s = ("repeat", "act_batch", "cache_seq", "cache_kv", None)
            c = {"k": s, "v": s}
        elif spec.attn == "mamba":
            c = {"h": ("repeat", "act_batch", "act_mlp", None),
                 "conv": ("repeat", "act_batch", None, "act_mlp")}
        else:
            c = {"s": ("repeat", "act_batch", None, None, None),
                 "shift_t": ("repeat", "act_batch", None),
                 "shift_c": ("repeat", "act_batch", None)}
        specs[f"pos{i}"] = c
    return specs


def decode_step(params, cache, batch, pos, cfg: ModelConfig, rules=None,
                unroll: bool = False):
    """One-token decode. batch: {"tokens": [B,1]} ({"tokens": [B,1,n]}
    for codebooks, {"embeddings": [B,1,D]} for embeddings); pos: int.
    Returns (logits [B,1,V] or [B,1,n,V], cache), the cache updated in
    place. Over ranks (``rules``): ``params`` and ``cache`` are the
    rank's, ``batch`` its rows; the logits come back whole along the
    vocabulary."""
    del unroll
    x = _embed_input(params, batch, cfg, rules)
    for r in range(cfg.n_repeats):
        p_r = _index(params["layers"], r)
        c_r = _index(cache, r)
        for i, spec in enumerate(cfg.pattern):
            x, _, _, _ = _layer_apply(p_r[f"pos{i}"], spec, x, cfg, rules,
                                      cache=c_r[f"pos{i}"], pos=pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, x, cfg, rules)
    return logits, cache
