"""State-space / linear-recurrence blocks: Mamba (jamba) and RWKV6 (finch)
(reference: ``repro/models/ssm.py``), with the reference's names,
parameter trees, chunk rules and numerics.

Both blocks are chunked recurrences, as in the reference, computed from
the zero state at prefill by ``_ssm_scan`` and ``_rwkv_scan``. The
reference's ``lax.scan`` over chunks is a Python ``for`` loop here
(``unroll_chunks`` only shapes the reference's compiled program and is
accepted and ignored). Mamba's loop runs a whole chunk
at a time (its ``da``/``db`` are built per chunk); inside a chunk the
reference's ``associative_scan`` is a doubling (Hillis-Steele) scan:
``ceil(log2 C)`` steps of elementwise products over ``[B, C, di, ds]``,
the same values summed in another order. RWKV's loop carries only the
state, with each chunk's decay and input; the chunks' outputs are then
computed side by side. The recurrences run in float32 and their results
are cast to the activation dtype after them.

Chunk rules, kept exactly: Mamba takes chunks of ``chunk`` (128) when it
divides S, else one chunk of S; RWKV chunks of ``RWKV_CHUNK`` (16) when
it divides S, else one chunk of S. RWKV's intra-chunk factors
``exp(+-cum)`` stay inside float32 only for short chunks: at a ragged S
past about 176 (``k * exp(-cum)`` overflows once ``|cum|`` passes ~88)
the time mix returns non-finite values, in the reference as here.

Over ``model`` ranks (``rules`` that split ``mlp`` / ``heads_joined``,
serving) a rank holds its shards (``models.model.shard_params``) and
computes its own channels or heads, as GSPMD does with the reference's
specs; what contracts a split dimension is all-reduced once
(``dist.rules.reduce_partial``). Mamba by ``mlp`` channels: the rank's
``di/P`` channels of every channel leaf, and of both halves of
``in_proj`` (``in_proj_local``); ``x_proj``'s product (``dt_in``, B, C)
and ``out_proj``'s are the layer's two all-reduces, the convolution, the
scan, ``d_skip`` and the gate stay local. RWKV6 by heads: the rank's
heads of ``wr``/``wk``/``wv``/``wg``/``wo``, its heads' columns of the
decay (made whole, then sliced) and rows of ``u`` and ``ln_w`` (held
whole), one all-reduce of ``wo``'s product; heads are never cut (the
split is decided on the head count, ``D // rwkv_head_dim``: held whole
where the extent does not divide it). The channel mix by ``mlp``: one
all-reduce of ``wv``'s product, before the gate. A rank's decode state is its
channels (Mamba's ``h`` and ``conv``) or heads (RWKV's ``s``; the
shifts whole). In training, each whole value that feeds the rank's
channels or heads is entered (``dist.rules.enter_split``: its gradient
all-reduced in the backward): Mamba's ``x`` before ``in_proj`` and its
reduced ``x_proj`` product, which feeds ``dt_proj`` and the scan; RWKV's
mixes ``xr``/``xk``/``xv``/``xg`` before their split products, the
whole LoRA product and the whole leaves ``w0``, ``u`` and ``ln_w`` before
the rank's heads are sliced from them (``xw`` feeds the whole LoRA and is
not entered); the channel mix's ``xk`` before ``wk``. With one rank, or
rules that split nothing, every reduction is the identity and the path
is the one-rank path bit for bit.

``jax.nn.softplus`` has no threshold; ``torch.nn.functional.softplus``
returns x above 20, where the two differ by less than float32's ulp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist.rules import enter_split, local_range, reduce_partial


# ===========================================================================
# Mamba (selective SSM, as interleaved in Jamba)
# ===========================================================================

def mamba_params(cfg, create):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dk = cfg.mamba_d_conv
    dt_rank = max(d // 16, 1)
    return {
        "in_proj": create((d, 2 * di), ("embed", "mlp"), d ** -0.5),
        "conv_w": create((dk, di), ("conv", "mlp"), dk ** -0.5),
        "x_proj": create((di, dt_rank + 2 * ds), ("mlp", "nil"), di ** -0.5),
        "dt_proj": create((dt_rank, di), ("rank", "mlp"), dt_rank ** -0.5),
        "dt_bias": create((di,), ("mlp",), 0.0, init="ssm_dt"),
        "a_log": create((di, ds), ("mlp", "state"), 0.0, init="ssm_a"),
        "d_skip": create((di,), ("mlp",), 0.0, init="ones"),
        "out_proj": create((di, d), ("mlp", "embed"), di ** -0.5),
    }


def in_proj_local(w, sharding):
    """The rank's shard of Mamba's ``in_proj`` ``w`` ``[..., d, 2*di]``
    (one leaf, or stacked over repeats) under its ``NamedSharding``: each
    half (``x``, then ``z``) cut as a leaf of its own, side by side, so
    that ``torch.chunk`` of the rank's product gives the rank's channels
    ``[r*di/P, (r+1)*di/P)`` of both and no collective is needed. The
    reference's shard has this shape but holds contiguous columns (rank 0
    the ``x`` half, rank 1 the ``z`` half at ``P=2``), which GSPMD then
    re-lays (ROADMAP.md queue 3 item 26). The only code that cuts
    ``in_proj``: ``InProjSharding``, through which ``shard_params``,
    ``init_params(rules=)``, the train state's shards and the
    checkpoints' restore cut it. ``w`` itself where no
    dimension is cut; a new tensor where one is."""
    x, z = torch.chunk(w, 2, dim=-1)
    xl, zl = sharding.local(x), sharding.local(z)
    if xl.shape == x.shape:
        return w
    return torch.cat([xl, zl], dim=-1)


class InProjSharding:
    """The sharding of Mamba's ``in_proj`` (``inner``, its logical spec's
    ``NamedSharding``), whose cut is ``in_proj_local``: ``local`` cuts
    each half as a leaf of its own and ``whole`` joins each half from the
    ranks' shards and puts the halves back side by side. Everything else
    (``device``, ``mesh``, ``spec``, ``split_dims``, ``shard_shape``) is
    the inner sharding's."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        if name == "inner":         # not yet set (copy, pickle)
            raise AttributeError(name)
        return getattr(self.inner, name)

    def local(self, w):
        return in_proj_local(w, self.inner)

    def whole(self, x, shape):
        half = (*shape[:-1], shape[-1] // 2)
        return torch.cat([self.inner.whole(h, half)
                          for h in torch.chunk(x, 2, dim=-1)], dim=-1)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: [B,S,di], w: [dk,di].
    state: [B,dk-1,di] trailing context (decode), in any dtype; it is cast
    to x's. Returns (y, new_state), the new state in x's dtype."""
    dk = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], dk - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # [B, S+dk-1, di]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(dk))
    new_state = xp[:, -(dk - 1):]
    return y, new_state


def _ssm_chunk(h0, dt_c, b_c, x_c, cmat, a):
    """One chunk of the selective scan. The discretized transition and
    input tensors da/db ([B,C,di,ds]) are built here, per chunk: for the
    whole sequence they would hold S x di x ds float32 values (4 GB each
    for jamba at S=4096).

    h0: [B,di,ds]; dt_c/x_c: [B,C,di]; b_c/cmat: [B,C,ds]; a: [di,ds].
    Returns (y [B,C,di], hC)."""
    da = torch.exp(dt_c[..., None] * a)                    # [B,C,di,ds]
    db = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
    # inclusive scan of (a, b) under (al, bl) . (ar, br) = (al ar, bl ar + br),
    # doubling the reach each step
    C = da.shape[1]
    if torch.is_grad_enabled() and (da.requires_grad or db.requires_grad):
        # training: the same ops in the same order, out of place (autograd
        # refuses out=), so the forward is bit-equal to serving's
        step = 1
        while step < C:
            db = torch.cat([db[:, :step], torch.addcmul(
                db[:, step:], db[:, :-step], da[:, step:])], dim=1)
            da = torch.cat([da[:, :step],
                            torch.mul(da[:, :-step], da[:, step:])], dim=1)
            step *= 2
    else:
        # serving: each step writes into the other buffer of a pair (what
        # it reads is still needed while it writes)
        da2, db2 = torch.empty_like(da), torch.empty_like(db)
        step = 1
        while step < C:
            da2[:, :step] = da[:, :step]
            db2[:, :step] = db[:, :step]
            torch.addcmul(db[:, step:], db[:, :-step], da[:, step:],
                          out=db2[:, step:])
            torch.mul(da[:, :-step], da[:, step:], out=da2[:, step:])
            da, da2, db, db2 = da2, da, db2, db
            step *= 2
    h = da * h0[:, None] + db                              # [B,C,di,ds]
    y = torch.einsum("bcds,bcs->bcd", h, cmat)
    return y, h[:, -1]


def _ssm_scan(dtf, bf, xf, cf, a, chunk=128):
    """The selective scan over a whole sequence from the zero state, in
    chunks of ``chunk`` when it divides S, else in one chunk of S.
    dtf/xf: [B,S,di]; bf/cf: [B,S,ds]; a: [di,ds], all float32. Returns
    (y [B,S,di], h at the end [B,di,ds])."""
    B, S, di = xf.shape
    h = torch.zeros((B, di, a.shape[1]), dtype=torch.float32,
                    device=xf.device)
    csz = chunk if S % chunk == 0 else S
    ys = []
    for c0 in range(0, S, csz):
        sl = slice(c0, c0 + csz)
        y_i, h = _ssm_chunk(h, dtf[:, sl], bf[:, sl], xf[:, sl], cf[:, sl],
                            a)
        ys.append(y_i)
    return torch.cat(ys, dim=1), h


def mamba_apply(params, x, cfg, rules=None, state=None, chunk=128,
                unroll_chunks=False, want_state=False):
    """x: [B,S,D]. state (decode, S == 1): {"h": [B,di,ds], "conv":
    [B,dk-1,di]}, ``di`` the rank's channels over ``model``.
    ``want_state`` (prefill): return the end-of-sequence recurrent state.
    Returns (out, new_state)."""
    del unroll_chunks
    D = x.shape[-1]
    dt = x.dtype
    ds = cfg.mamba_d_state
    di = cfg.mamba_expand * D
    dt_rank = max(D // 16, 1)
    xz = enter_split(x, rules, "mlp", di) @ params["in_proj"].to(dt)
    xs, z = torch.chunk(xz, 2, dim=-1)             # the rank's channels
    conv_state = None if state is None else state["conv"]
    xs, new_conv = _causal_conv(xs, params["conv_w"].to(dt), conv_state)
    xs = F.silu(xs)
    dbc = reduce_partial(xs @ params["x_proj"].to(dt), rules, "mlp", di)
    dbc = enter_split(dbc, rules, "mlp", di)       # feeds the rank's channels
    dt_in, bmat, cmat = torch.split(dbc, [dt_rank, ds, ds], dim=-1)
    delta = F.softplus(dt_in @ params["dt_proj"].to(dt)
                       + params["dt_bias"].to(dt))
    a = -torch.exp(params["a_log"].float())                    # [di, ds]
    dtf, bf, xf, cf = delta.float(), bmat.float(), xs.float(), cmat.float()

    if state is not None:                                      # decode
        da0 = torch.exp(dtf[:, 0, :, None] * a)
        db0 = dtf[:, 0, :, None] * bf[:, 0, None, :] * xf[:, 0, :, None]
        h = state["h"] * da0 + db0
        y = torch.einsum("bds,bs->bd", h, cf[:, 0])[:, None]
        new_state = {"h": h, "conv": new_conv}
    else:
        y, h = _ssm_scan(dtf, bf, xf, cf, a, chunk)
        new_state = {"h": h, "conv": new_conv} if want_state else None
    y = y.to(dt) + xs * params["d_skip"].to(dt)
    out = (y * F.silu(z)) @ params["out_proj"].to(dt)
    return reduce_partial(out, rules, "mlp", di), new_state


def mamba_state_init(cfg, batch, dtype=torch.float32, device=None,
                     di=None):
    """Zero decode state on ``device`` (default ``cuda``): ``h`` in
    float32, ``conv`` in ``dtype`` (the activation dtype), of ``di``
    channels (default all; a rank's over ``model``)."""
    dev = resolve_device(device)
    if di is None:
        di = cfg.mamba_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.mamba_d_state),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=dtype, device=dev)}


# ===========================================================================
# RWKV6 ("finch": data-dependent per-channel decay)
# ===========================================================================

def rwkv_params(cfg, create):
    d = cfg.d_model
    r = cfg.rwkv_lora_rank
    H = d // cfg.rwkv_head_dim
    return {
        "mu": create((5, d), ("nil", "embed"), 0.0, init="half"),  # r,k,v,g,w
        "w0": create((d,), ("embed",), 0.0, init="ssm_w0"),
        "w_lora_a": create((d, r), ("embed", "rank"), d ** -0.5),
        "w_lora_b": create((r, d), ("rank", "embed"), 0.01 * r ** -0.5),
        "wr": create((d, d), ("embed", "heads_joined"), d ** -0.5),
        "wk": create((d, d), ("embed", "heads_joined"), d ** -0.5),
        "wv": create((d, d), ("embed", "heads_joined"), d ** -0.5),
        "wg": create((d, d), ("embed", "heads_joined"), d ** -0.5),
        "wo": create((d, d), ("heads_joined", "embed"), d ** -0.5),
        "u": create((H, cfg.rwkv_head_dim), ("nil", "nil"), 0.5),
        "ln_w": create((H, cfg.rwkv_head_dim), ("nil", "nil"), 0.0,
                       init="ones"),
    }


W_LOG_MIN = -5.0
RWKV_CHUNK = 16


def _rwkv_chunk_end(k, v, wlog):
    """What a chunk does to the state it carries: S_C = diag(decay) S_0 +
    kv. k/v: [..., C, H, dh]; wlog: [..., C, H, dk]. Returns (the
    inclusive cumsum of wlog, decay [..., H, dk], kv [..., H, dk, dv])."""
    cum = torch.cumsum(wlog, dim=-3)                   # inclusive
    decay_end = torch.exp(cum[..., -1, :, :])
    k_end = k * torch.exp(cum[..., -1:, :, :] - cum)   # bounded <= 1
    return cum, decay_end, torch.einsum("...chk,...chv->...hkv", k_end, v)


def _rwkv_chunk(s0, r, k, v, wlog, u):
    """One chunk, or several side by side (leading dims ``...``, each
    chunk with the state that enters it). s0: [...,H,dk,dv]; r/k/v:
    [...,C,H,dh]; wlog: [...,C,H,dk].
    out_t = r_t (u*k_t) v_t + r_t S_{t-1};  S_t = diag(w_t) S_{t-1} + k_t v_t
    Returns (out [...,C,H,dv], sC)."""
    cum, decay_end, kv = _rwkv_chunk_end(k, v, wlog)
    cum_prev = cum - wlog
    q = r * torch.exp(cum_prev)
    inter = torch.einsum("...chk,...hkv->...chv", q, s0)
    kd = k * torch.exp(-cum)                           # bounded by e^{C|w|}
    A = torch.einsum("...chk,...jhk->...hcj", q, kd)
    C = r.shape[-3]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    A = torch.where(mask, A, 0.0)
    diag = torch.einsum("...chk,...chk->...ch", r, u * k)
    intra = torch.einsum("...hcj,...jhv->...chv", A, v) + diag[..., None] * v
    return inter + intra, decay_end[..., None] * s0 + kv


def _rwkv_scan(r, k, v, wlog, u):
    """The WKV recurrence over a whole sequence from the zero state, in
    chunks of ``RWKV_CHUNK`` when it divides S, else in one chunk of S.
    r/k/v/wlog: [B,S,H,dh] float32; u: [H,dh]. Only the carried state is
    sequential: it is carried over the chunks with each chunk's (decay,
    kv), and then every chunk runs at once with the state that enters it.
    Returns (out [B,S,H,dv], the state at the end [B,H,dk,dv])."""
    B, S, H, dh = r.shape
    c = RWKV_CHUNK if S % RWKV_CHUNK == 0 else S
    rs, ks, vs, ws = (t.reshape(B, S // c, c, H, dh) for t in (r, k, v, wlog))
    _, decay, kv = _rwkv_chunk_end(ks, vs, ws)
    s = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    s_in = []
    for i in range(S // c):
        s_in.append(s)
        s = decay[:, i, ..., None] * s + kv[:, i]
    out, _ = _rwkv_chunk(torch.stack(s_in, dim=1), rs, ks, vs, ws, u)
    return out.reshape(B, S, H, dh), s


def rwkv_time_mix(params, x, cfg, rules=None, state=None, unroll_chunks=False,
                  want_state=False):
    """x: [B,S,D]. state (decode, S == 1): {"s": [B,H,dk,dv], "shift":
    [B,D]}, ``H`` the rank's heads over ``model``. ``want_state``
    (prefill): return the end-of-sequence WKV state. Returns (out,
    new_state)."""
    del unroll_chunks
    B, S, D = x.shape
    dt = x.dtype
    dh = cfg.rwkv_head_dim
    h0, h1 = local_range(rules, "heads_joined", D // dh)  # the rank's heads
    H, c0, c1 = h1 - h0, h0 * dh, h1 * dh

    def enter(t):           # a whole value feeding the rank's heads
        return enter_split(t, rules, "heads_joined", D // dh)

    if state is None:
        xprev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    else:
        xprev = state["shift"][:, None]
    mu = params["mu"].to(dt)
    xr, xk, xv, xg, xw = (x + (xprev - x) * mu[i] for i in range(5))
    xr, xk, xv, xg = (enter(t) for t in (xr, xk, xv, xg))
    r = (xr @ params["wr"].to(dt)).reshape(B, S, H, dh).float()
    k = (xk @ params["wk"].to(dt)).reshape(B, S, H, dh).float()
    v = (xv @ params["wv"].to(dt)).reshape(B, S, H, dh).float()
    g = xg @ params["wg"].to(dt)
    lora = enter(torch.tanh(xw @ params["w_lora_a"].to(dt)) @
                 params["w_lora_b"].to(dt))
    # the LoRA product is whole; the rank's heads' columns are taken
    # before the elementwise rest, so their bits are the one-rank path's
    wlog = -torch.exp(enter(params["w0"]).float()[c0:c1] +
                      lora.float()[..., c0:c1])
    wlog = torch.clamp(wlog, min=W_LOG_MIN).reshape(B, S, H, dh)
    u = enter(params["u"]).float()[h0:h1]

    if state is not None:                               # decode
        s0 = state["s"]
        r1, k1, v1, w1 = r[:, 0], k[:, 0], v[:, 0], wlog[:, 0]
        out = torch.einsum("bhk,bhkv->bhv", r1, s0) + \
            torch.einsum("bhk,bhk->bh", r1, u * k1)[..., None] * v1
        s_new = torch.exp(w1)[..., None] * s0 + \
            torch.einsum("bhk,bhv->bhkv", k1, v1)
        out = out[:, None]                              # [B,1,H,dv]
        new_state = {"s": s_new, "shift": x[:, -1]}
    else:
        out, s = _rwkv_scan(r, k, v, wlog, u)
        new_state = {"s": s, "shift": x[:, -1]} if want_state else None

    # per-head group norm (population variance, as jnp.var), gate, output
    mean = torch.mean(out, dim=-1, keepdim=True)
    var = torch.var(out, dim=-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 64e-5) * \
        enter(params["ln_w"]).float()[h0:h1]
    out = out.reshape(*out.shape[:-2], H * dh).to(dt) * F.silu(g)
    return reduce_partial(out @ params["wo"].to(dt), rules, "heads_joined",
                          D // dh), new_state


def rwkv_channel_params(cfg, create):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": create((2, d), ("nil", "embed"), 0.0, init="half"),  # k, r
        "wk": create((d, f), ("embed", "mlp"), d ** -0.5),
        "wv": create((f, d), ("mlp", "embed"), f ** -0.5),
        "wr": create((d, d), ("embed", "nil"), d ** -0.5),
    }


def rwkv_channel_mix(params, x, cfg, rules=None, state=None,
                     want_state=False):
    """Squared-ReLU channel mix with a one-token shift. state (decode):
    the previous token's input [B,D]. Over ``model`` ranks the rank's
    ``d_ff`` columns of ``wk`` and rows of ``wv``, whose product is
    all-reduced before the gate (where GSPMD reduces it). Returns (out,
    new_state)."""
    dt = x.dtype
    if state is None:
        xprev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        new_state = x[:, -1] if want_state else None
    else:
        xprev = state[:, None]
        new_state = x[:, -1]
    mu = params["mu"].to(dt)
    xk = enter_split(x + (xprev - x) * mu[0], rules, "mlp", cfg.d_ff)
    xr = x + (xprev - x) * mu[1]
    h = torch.square(torch.relu(xk @ params["wk"].to(dt)))
    kv = reduce_partial(h @ params["wv"].to(dt), rules, "mlp", cfg.d_ff)
    out = torch.sigmoid(xr @ params["wr"].to(dt)) * kv
    return out, new_state


def rwkv_state_init(cfg, batch, device=None, heads=None):
    """Zero decode state on ``device`` (default ``cuda``): the WKV state
    ``s`` of ``heads`` heads (default all; a rank's over ``model``) in
    float32, the time-mix and channel-mix shifts (whole) in the
    activation dtype."""
    dev = resolve_device(device)
    dh = cfg.rwkv_head_dim
    H = cfg.d_model // dh if heads is None else heads
    return {"s": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                             device=dev),
            "shift_t": torch.zeros((batch, cfg.d_model), dtype=cfg.act_dtype,
                                   device=dev),
            "shift_c": torch.zeros((batch, cfg.d_model), dtype=cfg.act_dtype,
                                   device=dev)}
