"""Core transformer layers: RMSNorm, RoPE, GQA / sliding-window attention
and the dense MLP (reference: ``repro/models/layers.py``).

* ``<mod>_params(cfg, create, ...)`` builds the parameter subtree through
  a ``create(shape, logical_axes, scale, init=...)`` callback, as in the
  reference, so the port's parameter tree has the reference's keys.
* ``attention(params, x, cfg, rules, ...)`` is the forward function. It
  covers full causal and sliding-window (``kind="swa"``) attention (train
  / prefill) and single-token decode against a KV cache, the window-sized
  ring cache included.

``rules`` (``dist.rules.Rules``) shards both over the ``model`` axis,
with one decision for every layer (``dist.rules.splits``: a leaf is held
as its shard where the extent divides the dimension its spec names, and
whole elsewhere). Attention keeps a rank's query heads of ``wq`` and
``wo`` and its KV heads of ``wk``/``wv`` and the cache; where the KV
heads are held whole and the query heads split (MQA at ``model=2``),
the rank reads the KV heads its query heads map to (``_rank_kv``). The
MLP keeps its columns of ``w_gate``/``w_up`` and rows of ``w_down``. A
product over a split dimension (``wo`` over heads, ``w_down`` over
``mlp``) gives partial sums, all-reduced once over ``model``
(``dist.rules.reduce_partial``); over a dimension held whole, nothing
is reduced. In training, the whole input of the rank's heads or columns
is entered (``dist.rules.enter_split``: its gradient all-reduced in the
backward): ``x`` where it feeds ``wq`` (and ``wk``/``wv`` where the KV
heads are split too), or, where the KV heads are held whole, ``x`` for
``wq`` alone and the whole ``k`` and ``v`` before the rank's KV heads
are read from them; ``x`` where it feeds the MLP's columns. Without
rules, or on one rank, nothing is split.

Numerics follow the reference where they decide routing and greedy
tokens: RMSNorm squares in the activation dtype before the float32 mean,
RoPE frequencies come from numpy float32, products the reference asks in
float32 (``preferred_element_type``) are float32 products of upcast
operands, and probabilities are cast to the activation dtype before the
PV product (but not in ``_local_band``, which keeps them in float32, as
the reference does). Weights are cast to the activation dtype where the
reference casts them, at each use. The GELU MLP uses the tanh
approximation, which is ``jax.nn.gelu``'s default (PyTorch's default is
the erf form).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.dist.rules import (enter_split, local_range,
                                    reduce_partial, splits)
from repro_torch.kernels import ops


def rmsnorm_params(d, create):
    return {"scale": create((d,), ("nil",), 0.0, init="ones")}


def rmsnorm(params, x, eps=1e-6):
    # square in the activation dtype, accumulate in float32 (reference)
    var = torch.mean(torch.square(x).float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device):
    """The reference's numpy float32 frequencies, copied to ``device``
    once (a host-to-device copy per call would stall the launch stream)."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(freqs).to(device)


def rope(x, positions, theta):
    """x: [..., S, H, dh]; positions: [S] integer tensor."""
    dh = x.shape[-1]
    half = dh // 2
    angles = positions[..., None].float() * _rope_freqs(
        theta, half, x.device)                         # [S, half]
    cos = torch.cos(angles)[..., None, :]              # [S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention_params(cfg, create, kind="full"):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": create((d, cfg.n_heads, hd), ("embed", "heads", "head_dim"),
                     d ** -0.5),
        "wk": create((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"),
                     d ** -0.5),
        "wv": create((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"),
                     d ** -0.5),
        "wo": create((cfg.n_heads, hd, d), ("heads", "head_dim", "embed"),
                     (cfg.n_heads * hd) ** -0.5),
    }


def _rank_kv(cfg, rules):
    """Which of the KV heads a rank holds its query heads read: None for
    all of them, in order (the heads held whole, or both split: the
    rank's KV shard is its heads' groups); else, with the query heads
    split and the KV heads whole, ``(lo, hi)`` when the rank's heads
    ``[h0, h1)`` fill whole groups of KV heads ``h // (H / KV)`` evenly
    (gemma3's 4:1 at ``model=2``: each rank keeps KV head 0), or the index
    tensor of each query head's KV head (groups straddled unevenly: K/V
    expanded to the rank's heads)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if not splits(rules, "heads", H) or splits(rules, "kv_heads", KV):
        return None
    h0, h1 = local_range(rules, "heads", H)
    of = [h // (H // KV) for h in range(h0, h1)]
    lo, hi = of[0], of[-1] + 1
    if all(of.count(j) == len(of) // (hi - lo) for j in range(lo, hi)):
        return lo, hi
    return torch.tensor(of)


def _select_kv(t, sel):
    """``t`` [B, T, KV, dh] at the KV heads ``_rank_kv`` chose: a view
    along the head axis (its strides stay the flash kernel's) or a
    gather."""
    if sel is None:
        return t
    if isinstance(sel, tuple):
        return t[:, :, sel[0]:sel[1]]
    return t.index_select(2, sel.to(t.device))


def _gqa_scores(q, k, cfg):
    """q: [B,S,H,dh], k: [B,T,KV,dh] -> scores [B,KV,H/KV,S,T] (f32)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    q = q.reshape(B, S, KV, H // KV, dh)
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    return s * (dh ** -0.5)


# sequences >= this take the flash kernel (ops.flash_attention), where the
# reference takes its chunked path _flash_full: the dense S x T score
# matrix at S=4096+ is what flash attention avoids. _QC / _KVC are the
# reference's query / key chunks; here they are handed to
# ops.flash_attention, which keeps them for the reference's signature only.
FLASH_S_MIN = 4096
_QC = 2048
_KVC = 2048


def _local_band(q, k, v, cfg):
    """Sliding-window attention as banded block attention: each block of
    ``bc = max(window, 1024)`` queries attends to the previous and its own
    key block, masked to the window (S * 2 bc scores instead of S^2).
    Scores, probabilities and the PV product stay in float32. S must be a
    multiple of ``bc``: the reference asserts it, the port raises
    ``ValueError``. Returns float32 [B, S, H, dh]."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    bc = max(cfg.window, 1024)
    if S % bc:
        raise ValueError(f"_local_band: S={S} is not a multiple of the "
                         f"band block {bc}")
    nb = S // bc
    dev = q.device
    qb = q.reshape(B, nb, bc, KV, G, dh).float()
    kb = k.reshape(B, nb, bc, KV, dh).float()
    vb = v.reshape(B, nb, bc, KV, dh).float()

    def with_prev(t):                      # [B, nb, 2 bc, KV, dh]
        prev = torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)
        return torch.cat([prev, t], dim=2)

    kcat, vcat = with_prev(kb), with_prev(vb)
    s = torch.einsum("bnqkgd,bntkd->bnkgqt", qb, kcat) * (dh ** -0.5)
    if cfg.logit_softcap:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    rel = (bc + torch.arange(bc, device=dev))[:, None] - \
        torch.arange(2 * bc, device=dev)[None, :]
    mask0 = (rel >= 0) & (rel < cfg.window)              # [bc, 2bc]
    first = torch.arange(2 * bc, device=dev)[None, :] >= bc  # block 0
    mask = torch.where(torch.arange(nb, device=dev)[:, None, None] == 0,
                       mask0[None] & first[None], mask0[None])
    s = torch.where(mask[None, :, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnkgqt,bntkd->bnqkgd", p, vcat)
    return out.reshape(B, S, H, dh)


def attention(params, x, cfg, rules=None, kind="full", positions=None,
              cache=None, cache_pos=None, want_cache=False,
              unroll_chunks=False):
    """Returns (out, new_cache). Train: cache=None, want_cache=False.
    Prefill: cache=None, want_cache=True -> new_cache holds the roped K/V
    for the whole sequence (the decode cache layout).

    Decode: x is [B,1,D]; cache = {"k": [B,T,KV,dh], "v": ...};
    cache_pos = int position. A ``swa`` layer with ``cfg.swa_ring_cache``
    writes at ``pos % T`` of a window-sized cache; every other layer at
    ``pos``. The cache tensors are updated in place (the reference returns
    updated copies; the serving loop hands the cache on either way) and
    returned. On a mesh that splits ``model`` (``rules``), ``params``
    are the rank's shards and ``cache`` its own; the output is whole on
    every rank (the partial sums of ``wo`` all-reduced where the heads
    are split). ``unroll_chunks`` is accepted for the reference's
    signature and ignored."""
    del unroll_chunks
    if kind not in ("full", "swa"):
        raise ValueError(f"attention kind={kind!r}: full or swa")
    B, S, D = x.shape
    dt = x.dtype
    theta = cfg.rope_theta
    if kind == "full" and cfg.rope_theta_global is not None:
        theta = cfg.rope_theta_global
    sel = _rank_kv(cfg, rules)
    xq = enter_split(x, rules, "heads", cfg.n_heads)
    xkv = xq if sel is None else x          # the KV heads: split or whole
    q = torch.einsum("bsd,dhk->bshk", xq, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", xkv, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xkv, params["wv"].to(dt))
    if sel is not None:     # whole K/V, of which the rank reads its heads'
        k = enter_split(k, rules, "heads", cfg.n_heads)
        v = enter_split(v, rules, "heads", cfg.n_heads)

    if cache is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
        kq, vq = _select_kv(k, sel), _select_kv(v, sel)
        if S >= FLASH_S_MIN and kind == "swa":
            out = _local_band(q, kq, vq, cfg).to(dt)
        elif S >= FLASH_S_MIN:
            out = ops.flash_attention(q, kq, vq, bq=_QC, bk=_KVC,
                                      softcap=cfg.logit_softcap or 0.0)
        else:
            scores = _gqa_scores(q, kq, cfg)
            qpos, kpos = positions[:, None], positions[None, :]
            mask = kpos <= qpos
            if kind == "swa":
                mask &= (qpos - kpos) < cfg.window
            if cfg.logit_softcap:
                scores = torch.tanh(scores / cfg.logit_softcap) * \
                    cfg.logit_softcap
            scores = torch.where(mask[None, None, None], scores, -1e30)
            probs = torch.softmax(scores, dim=-1).to(dt)
            out = torch.einsum("bkgst,btkd->bskgd", probs, vq)
        new_cache = {"k": k, "v": v} if want_cache else None
    else:
        # single-token decode
        pos = int(cache_pos)
        ck, cv = cache["k"], cache["v"]
        T = ck.shape[1]
        ring = kind == "swa" and cfg.swa_ring_cache
        wpos = pos % T if ring else pos
        if wpos + S > T:
            raise IndexError(f"decode position {pos} is past the cache "
                             f"length {T}")
        pos_s = torch.full((S,), pos, device=x.device)
        q = rope(q, pos_s, theta)
        k = rope(k, pos_s, theta)
        ck[:, wpos:wpos + S] = k.to(ck.dtype)
        cv[:, wpos:wpos + S] = v.to(cv.dtype)
        scores = _gqa_scores(q, _select_kv(ck, sel).to(dt),
                             cfg)                       # [B,KV,G,1,T]
        slots = torch.arange(T, device=x.device)
        # ring: slot s holds position pos - ((pos - s) mod T); slots not
        # yet written map to negative positions and are masked
        kpos = pos - torch.remainder(pos - slots, T) if ring else slots
        mask = (kpos <= pos) & (kpos >= 0)
        if kind == "swa":
            mask &= (pos - kpos) < cfg.window
        if cfg.logit_softcap:
            scores = torch.tanh(scores / cfg.logit_softcap) * cfg.logit_softcap
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bkgst,btkd->bskgd", probs,
                           _select_kv(cv, sel).to(dt))
        new_cache = {"k": ck, "v": cv}

    out = out.reshape(B, S, q.shape[2], cfg.hd)     # the rank's heads
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return reduce_partial(out, rules, "heads", cfg.n_heads), new_cache


def mlp_params(cfg, create):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": create((d, f), ("embed", "mlp"), d ** -0.5),
                "w_up": create((d, f), ("embed", "mlp"), d ** -0.5),
                "w_down": create((f, d), ("mlp", "embed"), f ** -0.5)}
    return {"w_up": create((d, f), ("embed", "mlp"), d ** -0.5),
            "w_down": create((f, d), ("mlp", "embed"), f ** -0.5)}


def mlp(params, x, cfg, rules=None):
    """swiglu: ``silu(x w_gate) * (x w_up) w_down``; gelu: ``gelu(x w_up)
    w_down`` with the tanh approximation. Weights cast to x's dtype. On
    a mesh that splits ``mlp``, the rank's columns and rows, and one
    all-reduce of the output (``x`` entered for the backward)."""
    dt = x.dtype
    x = enter_split(x, rules, "mlp", cfg.d_ff)
    w_up = params["w_up"].to(dt)
    if cfg.mlp_kind == "swiglu":
        h = torch.nn.functional.silu(x @ params["w_gate"].to(dt)) * (x @ w_up)
    else:
        h = torch.nn.functional.gelu(x @ w_up, approximate="tanh")
    return reduce_partial(h @ params["w_down"].to(dt), rules, "mlp",
                          cfg.d_ff)
