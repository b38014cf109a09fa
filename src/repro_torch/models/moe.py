"""Mixture-of-Experts layer with two routers (reference:
``repro/models/moe.py``):

* ``linear``          — learned-logits router;
* ``balanced_kmeans`` — the paper's assignment as expert routing: experts
  are centroids, tokens go to the top-k smallest effective distances
  ``sqdist(x, c) / influence^2``, and the per-expert influence is updated
  from the realized loads with the paper's Eq. (1)
  (``repro_torch.core.balanced_kmeans.adapt_influence``).

The balanced-k-means top-k is the CUDA router kernel in its divide form
(``ops.router_topk_divide``): ``max(sq, 0) / influence^2`` as the
reference's ``router_logits`` computes it, so the experts and gates are
the reference's bit for bit for the same ``sq``; without an influence (the
serving paths: ``decode_step`` and ``prefill`` pass none) it routes
unscaled, which is the reference's division by ones.

With gradients on (training), the kernel still chooses the experts, and
the gates come from ``router_logits`` over all experts (``[T, E]``, a
product the size of the router's own) gathered at the kernel's indices:
the same logits, differentiable in the tokens and the centroids, as the
reference's ``top_k`` of ``router_logits`` is. Gathering the chosen
centroids instead would make a ``[T, K, D]`` tensor, larger than the
product for every config.

Dispatch is the reference's gather-based scheme, integer for integer: the
capacity ``C``, the stable argsort of expert ids, ``starts``, ``valid``
and ``slot``.

On a mesh that splits ``expert`` over ``model`` (``rules``), a rank holds
its experts ``[e0, e1)`` of every expert leaf (``centroids`` and the
linear ``router`` included). It all-gathers the router's leaf once a
layer and routes every token on the whole, so the experts chosen, the
dispatch and the loads are the same bits on every rank (the layer's
input is, since the all-reduce before it gives every rank the same
bits). It computes its own experts' slots only, zero for the others',
adds the shared expert's partial sum (``mlp``-split), and makes one
all-reduce of the summed output. Where E (or the shared expert's width)
is not divided, that part is held whole and not reduced
(``dist.rules.splits``). In training (``dist.rules.enter_split``: the
gradient all-reduced in the backward), ``x`` is entered where it is
dispatched to the rank's experts, the gates where they weight the
rank's experts' outputs (the routing itself is whole: its gradient is
then whole, and the router leaf's gather keeps the rank's slice of it),
and the shared expert's input where the shared expert is split over
``mlp``; each only where its part is split.
"""
from __future__ import annotations

import torch

from repro_torch.core.balanced_kmeans import adapt_influence
from repro_torch.device import resolve_device
from repro_torch.dist.rules import (enter_split, gather_split, local_range,
                                    reduce_partial, splits)
from repro_torch.kernels import ops


def moe_params(cfg, create):
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.n_experts
    p = {
        "router": create((d, E), ("embed", "expert"), d ** -0.5),
        "w_gate": create((E, d, f), ("expert", "e_embed", "e_mlp"), d ** -0.5),
        "w_up": create((E, d, f), ("expert", "e_embed", "e_mlp"), d ** -0.5),
        "w_down": create((E, f, d), ("expert", "e_mlp", "e_embed"), f ** -0.5),
    }
    if m.n_shared_experts:
        fs = m.d_ff * m.n_shared_experts
        p["shared"] = {
            "w_gate": create((d, fs), ("embed", "mlp"), d ** -0.5),
            "w_up": create((d, fs), ("embed", "mlp"), d ** -0.5),
            "w_down": create((fs, d), ("mlp", "embed"), fs ** -0.5)}
    if m.router == "balanced_kmeans":
        p["centroids"] = create((E, d), ("expert", "embed"), d ** -0.5)
    return p


def init_router_state(cfg, device=None):
    """Per-MoE-layer influence vector (paper: initialized to 1), on
    ``device`` (default ``cuda``)."""
    if cfg.moe is None or cfg.moe.router != "balanced_kmeans":
        return None
    n_moe = sum(1 for s in cfg.pattern if s.mlp == "moe")
    return {"influence": torch.ones(cfg.n_repeats, n_moe, cfg.moe.n_experts,
                                    dtype=torch.float32,
                                    device=resolve_device(device))}


def router_logits(params, x, m, influence):
    """x: [T, D] -> logits [T, E] (higher = preferred)."""
    if m.router == "linear":
        return x.float() @ params["router"].float()
    c = params["centroids"].float()
    xf = x.float()
    sq = (torch.sum(xf * xf, -1, keepdim=True) + torch.sum(c * c, -1)[None]
          - 2.0 * xf @ c.T)
    eff = torch.clamp_min(sq, 0.0) / (influence * influence)[None]
    return -eff  # min effective distance == max logit


def router_gates(params, x, m, influence, eidx):
    """The logits of the experts ``eidx`` [T, K] (the router kernel's
    choice) of tokens x [T, D]: ``router_logits`` gathered, so
    differentiable in x and the centroids, where the kernel's eff carries
    no gradient. The influence stays out of the graph (None: ones)."""
    infl = (torch.ones(m.n_experts, dtype=torch.float32, device=x.device)
            if influence is None else influence.detach())
    return torch.gather(router_logits(params, x, m, infl), 1, eidx.long())


def _gather_rows(src, idx):
    """src [B, N, D], idx [B, M] -> src[b, idx[b, m]] as [B, M, D]."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[2]))


def moe_apply(params, x, cfg, rules=None, influence=None):
    """x: [B, S, D]. Returns (out, new_influence, load_stats), the stats
    holding ``dropped_frac``, ``load_imbalance`` and ``load`` [E] (the
    realized tokens an expert) of these rows.

    Dispatch groups are per batch row: capacity is ``top_k * S / E * cf``
    per group. With ``rules`` splitting ``expert``, ``params`` are the
    rank's experts and the output is whole on every rank."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    dt = x.dtype
    dev = x.device
    e0, e1 = local_range(rules, "expert", E)
    # the router's own leaf, whole: centroids [E, D] or weights [D, E]
    key = "centroids" if m.router == "balanced_kmeans" else "router"
    router = {key: gather_split(params[key], rules, "expert", E,
                                0 if key == "centroids" else 1)}

    if m.router == "balanced_kmeans":
        xt = x.reshape(B * S, D)
        eidx, eff = ops.router_topk_divide(xt, router["centroids"],
                                           influence, K)
        if torch.is_grad_enabled() and (xt.requires_grad or
                                        params["centroids"].requires_grad):
            gates = router_gates(router, xt, m, influence, eidx)
        else:
            gates = -eff                  # top-k logits, descending
    else:
        logits = router_logits(router, x.reshape(B * S, D), m, influence)
        # stable descending sort: ties keep the lower expert first, as
        # jax.lax.top_k orders them
        gates, eidx = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)
        gates, eidx = gates[:, :K], eidx[:, :K]
    gates = torch.softmax(gates.reshape(B, S, K), dim=-1).to(dt)
    # the gates weight the rank's experts' outputs only
    gates = enter_split(gates, rules, "expert", E)
    xe = enter_split(x, rules, "expert", E)     # dispatched to them

    C = int(max(1, round(K * S / E * m.capacity_factor)))
    T = S * K
    flat_e = eidx.reshape(B, T).long()
    # one-hot by comparison: F.one_hot checks its range on the host, a
    # device sync in every layer
    onehot = (flat_e[..., None] == torch.arange(E, device=dev)).long()
    cum = torch.cumsum(onehot, dim=1)
    pos = torch.gather(cum, 2, flat_e[..., None])[..., 0] - 1
    ok = pos < C
    slot = torch.where(ok, flat_e * C + pos, E * C)      # overflow -> sentinel
    # gather-based dispatch: slot (e, c) takes token order[b, starts[e]+c]
    order = torch.argsort(flat_e, dim=1, stable=True)    # [B, T]
    counts = torch.sum(onehot, dim=1)                    # [B, E]
    starts = torch.cumsum(counts, dim=1) - counts        # exclusive
    c_idx = torch.arange(C, device=dev)[None, None]
    # the rank's experts' slots only (all of them where E is held whole)
    El = e1 - e0
    src_pos = torch.clamp(starts[:, e0:e1, None] + c_idx, 0, T - 1)
    valid = c_idx < torch.clamp(counts[:, e0:e1], max=C)[:, :, None]
    tok_idx = torch.gather(order, 1, src_pos.reshape(B, El * C))
    if m.dispatch_no_repeat:
        hidden = _gather_rows(xe, tok_idx // K)
    else:
        src = torch.repeat_interleave(xe, K, dim=1) if K > 1 else xe
        hidden = _gather_rows(src, tok_idx)
    hidden = hidden * valid.reshape(B, El * C, 1).to(dt)
    hidden = hidden.reshape(B, El, C, D)

    g = torch.nn.functional.silu(torch.einsum(
        "becd,edf->becf", hidden, params["w_gate"].to(dt)))
    u = torch.einsum("becd,edf->becf", hidden, params["w_up"].to(dt))
    eo = torch.einsum("becf,efd->becd", g * u, params["w_down"].to(dt))
    # the other ranks' slots and the overflow sentinel read zero
    eo = torch.nn.functional.pad(eo.reshape(B, El * C, D),
                                 (0, 0, e0 * C, (E - e1) * C + 1))
    gathered = _gather_rows(eo, slot)                    # [B,S*K,D]
    w = (gates.reshape(B, S * K) * ok.to(dt))[..., None]
    out = torch.sum((gathered * w).reshape(B, S, K, D), dim=2)

    split = splits(rules, "expert", E)
    if m.n_shared_experts:
        sp = params["shared"]
        fs = m.d_ff * m.n_shared_experts
        xs = enter_split(x, rules, "mlp", fs)
        h = torch.nn.functional.silu(xs @ sp["w_gate"].to(dt)) * \
            (xs @ sp["w_up"].to(dt))
        shared = h @ sp["w_down"].to(dt)
        if splits(rules, "mlp", fs) == split:
            out = out + shared          # both partial, or both whole
        elif split:                     # experts partial, shared whole
            out = reduce_partial(out, rules, "expert", E) + shared
            split = False
        else:                           # experts whole, shared partial
            out = out + reduce_partial(shared, rules, "mlp", fs)
    if split:
        out = reduce_partial(out, rules, "expert", E)

    # --- paper Eq. (1): influence update from realized loads -------------
    load = torch.sum(onehot.float(), dim=(0, 1))                 # [E]
    stats = {"dropped_frac": 1.0 - torch.mean(ok.float()),
             "load_imbalance": torch.max(load) / (K * B * S / E) - 1.0,
             "load": load}
    new_infl = None
    if m.router == "balanced_kmeans":
        new_infl = update_influence(influence, load, K * B * S / E, m)
    return out, new_infl, stats


def update_influence(influence, load, target, m):
    """Paper Eq. (1) for one MoE layer: the influence [E] (None: the
    reference's ones) moved by the realized ``load`` [E] against
    ``target`` tokens an expert, then renormalized to geometric mean 1
    (only influence ratios matter). ``moe_apply`` calls it on its rows'
    loads; the data-parallel train step on the loads summed over the
    data ranks, with the global batch's target."""
    # no influence: the reference's ones, as the scalar 1.0 (the same
    # bits, one launch fewer)
    new_infl, _ = adapt_influence(
        1.0 if influence is None else influence, load, target,
        m.router_d_eff, m.router_influence_clip)
    return new_infl * torch.exp(-torch.mean(torch.log(
        torch.clamp_min(new_infl, 1e-12))))
