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
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
                     device=None):
    """Parameters from ``generator`` (``model.init_params``), zero moments,
    the router's influence at 1 and, with compression, a zero float32
    error-feedback tree; on ``device`` (default ``cuda``)."""
    params = M.init_params(cfg, generator, device=device)
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


def abstract_train_state(cfg, hp: TrainHParams):
    """``init_train_state``'s tree as ``meta`` tensors: shapes and dtypes,
    no storage."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    params = M.abstract_params(cfg)
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


def _compress(g, ef, kind: str, step: int):
    """Error-feedback compression of the gradient tree ``g`` with the
    float32 residual tree ``ef``. Returns (g_compressed_f32, new_ef)."""
    if kind == "none":
        return g, ef
    gl, el = tree_leaves(g), tree_leaves(ef)
    deq, new_ef = [], []
    for i, (x, e) in enumerate(zip(gl, el)):
        gf = x.to(torch.float32) + e
        if kind == "bf16":
            q = gf.to(torch.bfloat16)
        else:  # int8, stochastic rounding, per-tensor scale
            scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0
            noise = _noise(gf.shape, step, i, gf.device) - 0.5
            qi = torch.clamp(torch.round(gf / scale + noise), -127, 127)
            q = qi.to(torch.int8).to(torch.float32) * scale
        d = q.to(torch.float32)
        deq.append(d)
        new_ef.append(gf - d)
    return tree_unflatten(g, deq), tree_unflatten(ef, new_ef)


def make_train_step(cfg, rules=None, hp: TrainHParams = TrainHParams()):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens": [B, S] (or [B, S, n] codebooks, or
    "embeddings" [B, S, D]), "labels": [B, S] (or [B, S, n])} on the
    state's device, with B divisible by ``hp.microbatches``. ``metrics``
    holds float32 scalar tensors: loss, moe_dropped_frac, grad_norm (pre
    clip), lr, and the new step (int32). ``rules`` is accepted for the
    reference's signature and ignored."""
    schedule = make_schedule(hp.lr_kind, hp.lr_peak, hp.warmup_steps,
                             hp.total_steps)
    acfg = _adamw_cfg(cfg, hp)
    use_infl = cfg.moe is not None and cfg.moe.router == "balanced_kmeans" \
        and any(s.mlp == "moe" for s in cfg.pattern)
    acc_dt = getattr(torch, hp.grad_acc_dtype)

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        infl = state.get("influence")
        mbs = hp.microbatches
        dev = leaves[0].device
        acc = [None] * len(leaves)      # leaves whose dtype is not acc_dt
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        drop_sum = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.enable_grad():
            for i in range(mbs):
                mb = {k: v.reshape(mbs, v.shape[0] // mbs, *v.shape[1:])[i]
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
                if use_infl:
                    infl = ninf.detach()
                loss_sum = loss_sum + loss.detach()
                drop_sum = drop_sum + st["moe_dropped_frac"].detach()
        grads = []
        for p, a in zip(leaves, acc):
            g = p.grad if a is None else a
            if g is None:       # not reached by the loss: jax.grad's zeros
                g = torch.zeros(p.shape, dtype=acc_dt, device=p.device)
            elif mbs > 1:
                g.div_(mbs)
            grads.append(g)
        grads = tree_unflatten(params, grads)

        ef = state.get("ef")
        # the noise's seed; a meta state (the dry run) has no step value
        step0 = int(state["opt"]["step"]) if hp.grad_compress == "int8" \
            and dev.type != "meta" else 0
        grads, new_ef = _compress(grads, ef, hp.grad_compress, step0)
        lr = schedule(state["opt"]["step"])
        _, new_opt, ostats = adamw_update(params, grads, state["opt"], acfg,
                                          lr)
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
