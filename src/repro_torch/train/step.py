"""Train-step factory (reference: ``repro/train/step.py``): microbatch
gradient accumulation, remat, z-loss, error-feedback gradient compression
and the balanced-k-means MoE router state (paper Eq. 1) threaded through
the step.

``train_step(state, batch)`` runs eagerly. ``state`` is a plain dict of
tensors on one device: ``params``, ``opt`` {mu, nu, step}, ``influence``
(configs with a balanced-k-means router) and ``ef`` (error feedback, with
compression). The step updates the parameter and moment tensors in place
and returns a new state dict holding them (the reference returns new
arrays; the port keeps one copy of the 54 GB of float32 state that
granite trains with on one card).

Where the reference differs in how, not what:

* microbatches: the reference scans them, summing each microbatch's
  gradients into a zero accumulator in ``grad_acc_dtype``; here each
  microbatch's ``.backward()`` adds into the leaves' ``.grad``, which is
  the same sum (``0 + g1 + g2 ...``) without a second set of gradient
  tensors. Where ``grad_acc_dtype`` is not a leaf's dtype, its gradient
  is cast and summed in an accumulator of that dtype after each
  microbatch, as the reference does;
* a leaf that the loss does not reach (the linear router's weights in a
  balanced-k-means config) has a zero gradient, as ``jax.grad`` gives;
* ``int8`` compression draws its stochastic-rounding noise from a
  ``torch.Generator`` seeded from (17, step, leaf index): ``jax.random``'s
  bits cannot be reproduced here (a deliberate departure; the rest of the
  arithmetic is the reference's).

``abstract_train_state`` mirrors ``init_train_state`` in ``meta``
tensors (no storage: what ``CheckpointManager.restore`` fills on a
resume), and ``train_state_logical_specs`` gives each leaf's logical
axis names, as the reference's do.

**Ranks.** With ``rules`` over a ``(data, model)`` mesh of D x M ranks
(``launch.mesh.make_host_mesh(D, M)``, the step called on every rank),
the step computes the one-rank step's result on the same global batch,
up to the order of float sums, as GSPMD does over the reference's table.

Over ``data``:

* the deal: every rank is handed the global batch; the step splits it
  into microbatches first and then takes data rank d's rows of each,
  ``[i*B/m + d*B/(m*D), i*B/m + (d+1)*B/(m*D))`` of microbatch i (the
  reference shards each microbatch's rows over ``data``). When D does not
  divide a microbatch (``resolve_rules`` drops ``act_batch`` when it does
  not divide B), every rank computes every row;
* the router (paper Eq. 1): the forward returns each MoE layer's loads on
  the rank's rows (``moe_stats["moe_load"]``, [R, n_moe, E]); the step
  sums them over the data ranks in one all-reduce a microbatch and
  updates each layer's influence from the global loads against the
  global target (``moe.update_influence``, the function ``moe_apply``
  uses: one rank's step gives the forward's influence bit for bit, and
  every rank the same bits). The loads come from the whole routing,
  which every model rank computes: they are reduced over ``data`` only;
* FSDP: a rank holds every leaf the train rules split over ``data`` (the
  ``embed`` leaves) as its shard (``shard_state``); the forward gathers
  it where it is used and its backward sums the gradient over the data
  ranks into the shard (``dist.fsdp``). Leaves held whole over ``data``
  get one all-reduce sum of their gradients over the data ranks after
  the last microbatch. Every gradient is divided once, by
  ``D * microbatches``;
* the loss and ``moe_dropped_frac`` are the global means, the same on
  every rank;
* on a ``(pod, data, model)`` mesh the batch ranks are ``pod`` x
  ``data``, pod-major: the deal, the loads', losses' and whole leaves'
  sums run over both, and an FSDP leaf's gradient, summed over ``data``
  backward, is summed over ``pod`` after the last microbatch.

Over ``model`` (tensor parallelism): a rank holds its heads, channels,
experts and vocabulary rows of every leaf the rules split over ``model``
(``models.model.rank_shardings``: Mamba's ``in_proj`` by halves, RWKV's
heads never cut) and the layers compute on them. Every tensor is whole
and the same on every model rank, the rank's own part, or a partial sum;
three differentiable moves join them (``dist.rules``): ``reduce_partial``
(all-reduce forward, identity backward), ``enter_split`` (identity
forward, all-reduce backward) on each edge where a whole value feeds
the rank's part of a computation, and ``gather_split`` (all-gather
forward, the rank's slice backward: the logits over ``vocab``, the router
leaf over ``expert``). So the gradient of each whole leaf is the same
bits on every model rank and each split leaf's is its own shard's: no
gradient is reduced over ``model``.

The optimizer runs on the rank's shards. ``global_norm`` counts each
shard once: a leaf's squares on the ranks at coordinate 0 of every mesh
axis it is held whole over, one all-reduce over the mesh summing them.
``int8`` compression takes the whole leaf's ``max|x|`` (an all-reduce
max) and cuts the shard's noise out of the whole leaf's (17, step,
leaf) stream with the leaf's own cut, so any mesh gives one rank's bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.dist import fsdp
from repro_torch.dist.rules import axes_of
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               make_schedule)
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class TrainHParams:
    microbatches: int = 1
    z_loss: float = 1e-4
    remat: bool = True
    unroll: bool = False                 # the reference's; ignored here
    grad_acc_dtype: str = "float32"      # bf16 for the 400B class
    grad_compress: str = "none"          # none | bf16 | int8
    lr_kind: str = "cosine"
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    adamw: AdamWConfig = AdamWConfig()


def init_train_state(cfg, generator: torch.Generator, hp: TrainHParams,
                     device=None, rules=None):
    """Parameters from ``generator`` (``model.init_params``), zero moments,
    the router's influence at 1 and, with compression, a zero float32
    error-feedback tree; on ``device`` (default ``cuda``). ``rules`` (a
    rank of several): only the rank's shards, bit-equal to
    ``shard_state`` of the whole state (``init_params(..., rules=)``)."""
    params = M.init_params(cfg, generator, device=device, rules=rules)
    dev = tree_leaves(params)[0].device
    state = {"params": params, "opt": adamw_init(params, _adamw_cfg(cfg, hp))}
    rs = MOE.init_router_state(cfg, device=dev)
    if rs is not None:
        state["influence"] = rs["influence"]
    if hp.grad_compress in ("bf16", "int8"):
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def _n_moe_with_influence(cfg) -> int:
    """MoE layers a repeat that carry the router's influence (0 without
    a balanced-k-means router)."""
    if cfg.moe is None or cfg.moe.router != "balanced_kmeans":
        return 0
    return sum(1 for s in cfg.pattern if s.mlp == "moe")


def abstract_train_state(cfg, hp: TrainHParams, rules=None):
    """``init_train_state``'s tree as ``meta`` tensors: shapes and dtypes,
    no storage. ``rules`` (a rank of several): the rank's shards, cut as
    ``init_train_state(..., rules=)`` cuts them (``state_shardings``)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    params = M.abstract_params(cfg, rules)
    mdt = getattr(torch, _adamw_cfg(cfg, hp).moment_dtype)
    state = {"params": params,
             "opt": {"mu": tree_map(lambda p: meta(p.shape, mdt), params),
                     "nu": tree_map(lambda p: meta(p.shape, mdt), params),
                     "step": meta((), torch.int32)}}
    n_moe = _n_moe_with_influence(cfg)
    if n_moe:
        state["influence"] = meta((cfg.n_repeats, n_moe, cfg.moe.n_experts),
                                  torch.float32)
    if hp.grad_compress in ("bf16", "int8"):
        state["ef"] = tree_map(lambda p: meta(p.shape, torch.float32),
                               params)
    return state


def train_state_logical_specs(cfg, hp: TrainHParams):
    """The logical axis names of every leaf of the train state."""
    pspec = M.param_logical_specs(cfg)
    state = {"params": pspec,
             "opt": {"mu": pspec, "nu": pspec, "step": ()}}
    if _n_moe_with_influence(cfg):
        state["influence"] = ("repeat", None, None)
    if hp.grad_compress in ("bf16", "int8"):
        state["ef"] = pspec
    return state


def _adamw_cfg(cfg, hp: TrainHParams) -> AdamWConfig:
    return AdamWConfig(
        b1=hp.adamw.b1, b2=hp.adamw.b2, eps=hp.adamw.eps,
        weight_decay=hp.adamw.weight_decay, grad_clip=hp.adamw.grad_clip,
        moment_dtype=cfg.moment_dtype)


def _noise(shape, step: int, leaf: int, device) -> torch.Tensor:
    """Uniform [0, 1) draws of a generator seeded from (17, step, leaf);
    on ``meta`` (the dry run: no values, no generator) an empty tensor of
    the shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device)
    seed = int(np.random.SeedSequence((17, step, leaf)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device)


def _compress(g, ef, kind: str, step: int, layout=None):
    """Error-feedback compression of the gradient tree ``g`` with the
    float32 residual tree ``ef``. Returns (g_compressed_f32, new_ef).
    ``layout`` (ranks: a ``_Layout``): the trees hold the rank's shards
    of its split leaves, whose int8 scale is the whole leaf's and whose
    noise is the shard's cut of the whole leaf's."""
    if kind == "none":
        return g, ef
    gl, el = tree_leaves(g), tree_leaves(ef)
    deq, new_ef = [], []
    for i, (x, e) in enumerate(zip(gl, el)):
        gf = x.to(torch.float32) + e
        if kind == "bf16":
            q = gf.to(torch.bfloat16)
        else:  # int8, stochastic rounding, per-tensor scale
            top = torch.max(torch.abs(gf))
            if layout is not None and layout.split[i]:   # the whole leaf's
                # over the whole mesh: the ranks that share a shard hold
                # the same values, and a max is exact in any order
                top = layout.comm.all_reduce(top, "max")
                noise = layout.shardings[i].local(_noise(
                    layout.shapes[i], step, i, gf.device))
            else:
                noise = _noise(gf.shape, step, i, gf.device)
            scale = torch.clamp_min(top, 1e-12) / 127.0
            noise = noise - 0.5
            qi = torch.clamp(torch.round(gf / scale + noise), -127, 127)
            q = qi.to(torch.int8).to(torch.float32) * scale
        d = q.to(torch.float32)
        deq.append(d)
        new_ef.append(gf - d)
    return tree_unflatten(g, deq), tree_unflatten(ef, new_ef)


class _Layout:
    """Where a rank's state is split, leaf by leaf in ``tree_leaves``
    order of the parameters: each leaf's sharding (``rank_shardings``)
    and whole shape, whether it is split at all (``split``), whether
    this rank counts its shard in a sum over the mesh (``counted``: the
    rank sits at coordinate 0 of every axis the leaf is held whole
    over), the communicator that sums its gradient over the batch axes
    it is held whole over (``reduce``: every batch axis for a leaf held
    whole over ``data``; ``pod`` alone for an FSDP leaf, whose sum over
    ``data`` came backward through ``dist.fsdp``; None where nothing is
    left), the batch axes' communicator (``data``, None on one batch
    rank) and the whole mesh's (``comm``)."""

    def __init__(self, cfg, rules):
        mesh = rules.mesh
        self.shardings = tree_leaves(M.rank_shardings(cfg, rules))
        self.shapes = [tuple(x) for x in tree_leaves(M.param_shapes(cfg))]
        axes = [{name for _, axis in sh.split_dims(shape)
                 for name in axes_of(axis)}
                for sh, shape in zip(self.shardings, self.shapes)]
        at = {name: mesh.coordinate(name) for name in mesh.axis_names}
        self.split = [bool(a) for a in axes]
        self.counted = [all(at[name] == 0 for name in mesh.axis_names
                            if name not in a) for a in axes]
        batch = _batch_axes(mesh)
        self.reduce = [mesh.axis_comm(tuple(n for n in batch if n not in a))
                       for a in axes]
        self.data = _data_comm(rules)
        self.comm = mesh.comm


def _batch_axes(mesh) -> tuple:
    """The mesh's data-parallel axes: ``pod`` and ``data``, those it has."""
    return tuple(n for n in ("pod", "data") if n in mesh.axis_names)


def _data_comm(rules):
    """The communicator over the batch axes of ``rules``' mesh (``data``,
    with ``pod`` before it on a multi-pod mesh), None on one batch rank
    (whatever the model axis' extent)."""
    if rules is None or rules.mesh.size == 1:
        return None
    return rules.mesh.axis_comm(_batch_axes(rules.mesh))


def state_shardings(cfg, rules, hp: TrainHParams):
    """Each train-state leaf's sharding under ``rules``: the reference's
    ``param_shardings`` of ``train_state_logical_specs``, each parameter,
    moment and error-feedback leaf cut as the parameter is
    (``models.model.rank_shardings``: Mamba's ``in_proj`` by halves,
    RWKV's heads never cut)."""
    psh = M.rank_shardings(cfg, rules)
    out = {"params": psh, "opt": {"mu": psh, "nu": psh,
                                  "step": rules.sharding(())}}
    if _n_moe_with_influence(cfg):
        out["influence"] = rules.sharding(("repeat", None, None))
    if hp.grad_compress in ("bf16", "int8"):
        out["ef"] = psh
    return out


def shard_state(state, cfg, rules, hp: TrainHParams):
    """A whole train state cut to this rank's shards (each split leaf a
    copy of its part; leaves held whole kept as they are): what a rank
    holds. The identity on one rank."""
    if rules is None or rules.mesh.size == 1:
        return state
    return fsdp.local(state, state_shardings(cfg, rules, hp))


def whole_state(state, cfg, rules, hp: TrainHParams):
    """The whole train state from this rank's shards: each split leaf
    joined over the mesh axes it is split over (``whole`` of its
    sharding), the inverse of ``shard_state``; every rank calls it. The
    state itself on one rank."""
    if rules is None or rules.mesh.size == 1:
        return state
    shapes = abstract_train_state(cfg, hp)

    def walk(x, sh, like):
        if isinstance(x, dict):
            return {k: walk(x[k], sh[k], like[k]) for k in x}
        return sh.whole(x, tuple(like.shape))

    return walk(state, state_shardings(cfg, rules, hp), shapes)


def _influence_from_loads(infl, loads, target, m):
    """Each MoE layer's ``moe.update_influence`` from its row of
    ``loads`` [R, n_moe, E]: the per-layer form, layer by layer."""
    return torch.stack([torch.stack([
        MOE.update_influence(infl[r][j], loads[r][j], target, m)
        for j in range(loads.shape[1])]) for r in range(loads.shape[0])])


def make_train_step(cfg, rules=None, hp: TrainHParams = TrainHParams()):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: the global batch, {"tokens": [B, S] (or [B, S, n]
    codebooks, or "embeddings" [B, S, D]), "labels": [B, S] (or [B, S,
    n])}, with B divisible by ``hp.microbatches``; each microbatch goes to
    the state's device as it is used. ``metrics`` holds float32 scalar
    tensors: loss, moe_dropped_frac, grad_norm (pre clip), lr, and the new
    step (int32). ``rules``: None or rules over one rank (the one-rank
    step), or train rules over a ``(data, model)`` mesh of ranks, the
    state then the rank's shards (``shard_state``, ``init_train_state(...,
    rules=)``; the module docstring)."""
    schedule = make_schedule(hp.lr_kind, hp.lr_peak, hp.warmup_steps,
                             hp.total_steps)
    acfg = _adamw_cfg(cfg, hp)
    use_infl = cfg.moe is not None and cfg.moe.router == "balanced_kmeans" \
        and any(s.mlp == "moe" for s in cfg.pattern)
    acc_dt = getattr(torch, hp.grad_acc_dtype)

    def train_step(state, batch):
        layout = None if rules is None or rules.mesh.size == 1 \
            else _Layout(cfg, rules)
        comm = None if layout is None else layout.data   # over data
        D = 1 if comm is None else comm.size
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        infl = state.get("influence")
        mbs = hp.microbatches
        dev = leaves[0].device
        B = next(iter(batch.values())).shape[0]
        # the rows of each microbatch are dealt over the data ranks where
        # the rules split act_batch and D divides a microbatch
        deal = comm is not None and rules.extent("act_batch") > 1 \
            and (B // mbs) % D == 0
        rows = B // mbs // D if deal else B // mbs
        d = rules.mesh.coordinate(_batch_axes(rules.mesh)) if deal else 0
        acc = [None] * len(leaves)      # leaves whose dtype is not acc_dt
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        drop_sum = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.enable_grad():
            for i in range(mbs):
                mb = {k: v.reshape(mbs, B // mbs, *v.shape[1:])[i][
                    d * rows:(d + 1) * rows].to(dev)
                    for k, v in batch.items()}
                logits, ninf, st = M.forward(params, mb, cfg, rules,
                                             remat=hp.remat, influence=infl)
                loss = M.loss_fn(logits, mb["labels"], cfg, z_loss=hp.z_loss)
                del logits
                loss.backward()
                for j, p in enumerate(leaves):
                    if p.grad is not None and p.dtype != acc_dt:
                        g = p.grad.to(acc_dt)
                        p.grad = None
                        acc[j] = g if acc[j] is None else acc[j].add_(g)
                if use_infl and comm is None:
                    infl = ninf.detach()
                elif use_infl:
                    load = st["moe_load"]
                    if deal:
                        load = rules.reduce(load, "act_batch")
                    m = cfg.moe
                    S = mb["labels"].shape[1]
                    infl = _influence_from_loads(
                        infl, load, m.top_k * (B // mbs) * S / m.n_experts,
                        m).detach()
                loss_sum = loss_sum + loss.detach()
                drop_sum = drop_sum + st["moe_dropped_frac"].detach()
        if comm is not None:
            sums = comm.all_reduce(torch.stack([loss_sum, drop_sum])) / D
            loss_sum, drop_sum = sums[0], sums[1]
        grads = []
        for j, (p, a) in enumerate(zip(leaves, acc)):
            g = p.grad if a is None else a
            if g is None:       # not reached by the loss: jax.grad's zeros
                g = torch.zeros(p.shape, dtype=acc_dt, device=p.device)
            elif layout is not None and layout.reduce[j] is not None:
                # a shard's sum over data came backward
                g = layout.reduce[j].all_reduce(g)
            if mbs * D > 1:
                g.div_(mbs * D)
            grads.append(g)
        grads = tree_unflatten(params, grads)

        ef = state.get("ef")
        # the noise's seed; a meta state (the dry run) has no step value
        step0 = int(state["opt"]["step"]) if hp.grad_compress == "int8" \
            and dev.type != "meta" else 0
        grads, new_ef = _compress(grads, ef, hp.grad_compress, step0, layout)
        lr = schedule(state["opt"]["step"])
        kw = {} if layout is None else {"counted": layout.counted,
                                        "comm": layout.comm}
        _, new_opt, ostats = adamw_update(params, grads, state["opt"], acfg,
                                          lr, **kw)
        for p in leaves:
            p.grad = None
        new_state = dict(state, params=params, opt=new_opt)
        if use_infl:
            new_state["influence"] = infl
        if ef is not None:
            new_state["ef"] = new_ef
        metrics = {"loss": loss_sum / mbs, "moe_dropped_frac": drop_sum / mbs,
                   "grad_norm": ostats["grad_norm"], "lr": lr,
                   "step": new_opt["step"]}
        return new_state, metrics

    return train_step
