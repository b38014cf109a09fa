"""The port's SSM blocks (``repro_torch.models.ssm``: Mamba and RWKV6)
against the JAX package's ``repro.models.ssm``, function by function, at
the SMOKE widths of jamba (Mamba: d 64, d_inner 128, d_state 8) and rwkv6
(d 64, four heads of 16). Parameters come from the reference's own
``*_params`` functions driven by a seeded numpy ``create`` (the
reference's constant inits included) and inputs from seeded numpy; both
packages get the same arrays.

Tolerances, as tests/test_torch_archs.py's: float32 within 1e-4 (rtol and
atol; the port's doubling scan sums the Mamba recurrence in another order
than ``associative_scan``), bfloat16 within 5e-2. The reference's outputs
are computed once per module (``ref``) and shared between tests.
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
from repro.models import model as RM
from repro.models import ssm as RSSM
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM

# several pytest workers share a few cores: one intra-op thread each
torch.set_num_threads(1)

MESH = make_host_mesh()
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JAMBA, RWKV = "jamba_1p5_large_398b", "rwkv6_3b"
B = 2


def _cfgs(arch, dtype="float32"):
    ref = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                              dtype=dtype)
    port = dataclasses.replace(configs.get_config(arch, smoke=True),
                               dtype=dtype)
    return ref, port


def _create(seed):
    """A ``create`` callback drawing leaves from a seeded numpy generator,
    with the reference's constant inits (model.py's init_params)."""
    rng = np.random.default_rng(seed)

    def create(shape, axes, scale, init="normal"):
        if init == "ones":
            return np.ones(shape, np.float32)
        if init == "half":
            return np.full(shape, 0.5, np.float32)
        if init == "ssm_a":
            return np.broadcast_to(np.log(np.arange(
                1, shape[-1] + 1, dtype=np.float32)), shape).copy()
        if init == "ssm_dt":
            return np.full(shape, -4.6, np.float32)
        if init == "ssm_w0":
            return np.full(shape, -0.7, np.float32)
        return (rng.standard_normal(shape) * (scale or 0.02)) \
            .astype(np.float32)
    return create


PARAM_FNS = {"mamba": (JAMBA, "mamba_params"),
            "rwkv_t": (RWKV, "rwkv_params"),
            "rwkv_c": (RWKV, "rwkv_channel_params")}


def _params(kind, seed=0):
    """The numpy tree of ``kind`` and the same leaves for each package."""
    arch, fn = PARAM_FNS[kind]
    tree = getattr(RSSM, fn)(_cfgs(arch)[0], _create(seed))
    return tree, {k: jnp.asarray(v) for k, v in tree.items()}, \
        params_from_numpy(tree, "cpu")


def _x(S, D, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((B, S, D)) \
        .astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                               err_msg=what)


class _Reference:
    """The reference's outputs, each computed once (jitted) and kept."""

    def __init__(self):
        self.memo = {}

    def __call__(self, key, fn):
        if key not in self.memo:
            self.memo[key] = jax.tree.map(np.asarray, fn())
        return self.memo[key]


@pytest.fixture(scope="module")
def ref():
    return _Reference()


def _rules(cfg):
    return resolve_rules(MESH, cfg, "train")


# ---------------------------------------------------------------------------
# parameters and states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PARAM_FNS))
def test_param_functions_match_reference(kind):
    """The port's ``*_params``, driven by the same ``create``, gives the
    reference's keys, shapes, scales and inits (the same numpy draws)."""
    arch, fn = PARAM_FNS[kind]
    want = getattr(RSSM, fn)(_cfgs(arch)[0], _create(5))
    got = getattr(SSM, fn)(_cfgs(arch)[1], _create(5))
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_init_params_constant_leaves_match_reference(arch):
    """``init_params``' constant inits (mixes at 0.5, A_log at
    log(1..d_state), dt_bias at -4.6, w0 at -0.7, norms and d_skip at one)
    equal the reference's, bit for bit but for A_log's last ulp, in the
    tree the reference builds."""
    rcfg, pcfg = _cfgs(arch)
    want = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    got = M.init_params(pcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    pos0 = want["layers"]["pos0"]
    consts = {"mamba": ("dt_bias", "a_log", "d_skip"),
              "rwkv_t": ("mu", "w0", "ln_w"), "rwkv_c": ("mu",)}
    seen = 0
    for block, keys in consts.items():
        for key in keys if block in pos0 else ():
            # log(1..d_state): XLA's log and torch's may differ by an ulp
            ulp = dict(rtol=2 ** -23, atol=0) if key == "a_log" else \
                dict(rtol=0, atol=0)
            np.testing.assert_allclose(
                got["layers"]["pos0"][block][key].numpy(), pos0[block][key],
                **ulp, err_msg=f"{block}.{key}")
            seen += 1
    assert seen == (3 if arch == JAMBA else 4)
    assert M.param_count(got) == RM.param_count(want)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_state_inits_match_reference(arch):
    rcfg, pcfg = _cfgs(arch, "bfloat16")
    if arch == JAMBA:
        want = RSSM.mamba_state_init(rcfg, 3, jnp.bfloat16)
        got = SSM.mamba_state_init(pcfg, 3, torch.bfloat16, device="cpu")
        dtypes = {"h": torch.float32, "conv": torch.bfloat16}
    else:
        want = RSSM.rwkv_state_init(rcfg, 3)
        got = SSM.rwkv_state_init(pcfg, 3, device="cpu")
        dtypes = {"s": torch.float32, "shift_t": torch.bfloat16,
                  "shift_c": torch.bfloat16}
    assert set(got) == set(want) == set(dtypes)
    for key, t in got.items():
        assert t.dtype == dtypes[key] and t.shape == want[key].shape
        assert str(want[key].dtype) == str(dtypes[key]).split(".")[-1]
        assert not t.any()


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype, with_state):
    """The depthwise causal conv over 12 positions, from zeros or from a
    float32 trailing context (cast to the activation dtype in both); the
    new state comes back in the activation dtype."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 12, 128)).astype(np.float32)
    w = rng.standard_normal((4, 128)).astype(np.float32)
    st = rng.standard_normal((B, 3, 128)).astype(np.float32) \
        if with_state else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = RSSM._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             None if st is None else jnp.asarray(st))
    got = SSM._causal_conv(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(w).to(tdt),
                           None if st is None else torch.from_numpy(st))
    assert got[0].dtype == got[1].dtype == tdt
    assert tuple(got[1].shape) == (B, 3, 128)
    for g, wnt in zip(got, want):
        _close(g, wnt, dtype)


def _ref_mamba(ref, S, dtype, seed):
    rcfg, _ = _cfgs(JAMBA, dtype)
    _, jp, _ = _params("mamba")
    xj, _ = _x(S, rcfg.d_model, seed, dtype)
    return ref(("mamba", S, dtype, seed), lambda: jax.jit(
        lambda p, x: RSSM.mamba_apply(p, x, rcfg, _rules(rcfg),
                                      want_state=True))(jp, xj))


@pytest.mark.parametrize("S", [256, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_matches_reference(ref, dtype, S):
    """S=256: two chunks of 128; S=100: one ragged chunk of 100. The
    outputs and the end-of-sequence state (h in float32, conv in the
    activation dtype)."""
    want, wst = _ref_mamba(ref, S, dtype, S)
    _, pcfg = _cfgs(JAMBA, dtype)
    _, _, tp = _params("mamba")
    _, xt = _x(S, pcfg.d_model, S, dtype)
    got, gst = SSM.mamba_apply(tp, xt, pcfg, want_state=True)
    assert got.dtype == xt.dtype and gst["h"].dtype == torch.float32
    assert gst["conv"].dtype == xt.dtype
    _close(got, want, dtype)
    for key in ("h", "conv"):
        _close(gst[key], wst[key], dtype, key)


def test_mamba_train_forward_has_no_state():
    _, pcfg = _cfgs(JAMBA)
    _, _, tp = _params("mamba")
    _, xt = _x(8, pcfg.d_model, 0, "float32")
    out, st = SSM.mamba_apply(tp, xt, pcfg)
    assert st is None and tuple(out.shape) == (B, 8, pcfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_steps_match_reference_and_prefill(ref, dtype):
    """16 one-token steps from the zero state: each step's output and
    state equal the reference's step, the outputs equal the port's own
    prefill over the same 16 tokens at each position, and the last state
    equals the prefill's end-of-sequence state."""
    S = 16
    rcfg, pcfg = _cfgs(JAMBA, dtype)
    _, jp, tp = _params("mamba")
    xj, xt = _x(S, pcfg.d_model, 7, dtype)
    rules = _rules(rcfg)
    step = jax.jit(lambda p, x, st: RSSM.mamba_apply(p, x, rcfg, rules,
                                                     state=st))

    def ref_steps():
        st = RSSM.mamba_state_init(rcfg, B, getattr(jnp, dtype))
        outs = []
        for t in range(S):
            o, st = step(jp, xj[:, t:t + 1], st)
            outs.append(o)
        return jnp.concatenate(outs, axis=1), st

    want, wst = ref(("mamba-steps", dtype), ref_steps)
    st = SSM.mamba_state_init(pcfg, B, xt.dtype, device="cpu")
    outs = []
    for t in range(S):
        o, st = SSM.mamba_apply(tp, xt[:, t:t + 1], pcfg, state=st)
        outs.append(o)
    got = torch.cat(outs, dim=1)
    _close(got, want, dtype)
    for key in ("h", "conv"):
        _close(st[key], wst[key], dtype, key)
    pre, pst = SSM.mamba_apply(tp, xt, pcfg, want_state=True)
    _close(got, pre, dtype, "decode vs prefill")
    for key in ("h", "conv"):
        _close(st[key], pst[key], dtype, f"decode vs prefill {key}")


def test_ssm_chunk_scan_matches_a_sequential_recurrence():
    """The doubling scan inside one chunk against h_t = da_t h_{t-1} +
    db_t written as a loop, in float64 (no rounding to hide an order
    error), at C = 1, 5 and 37 (not powers of two)."""
    rng = np.random.default_rng(11)
    for C in (1, 5, 37):
        dt_c = torch.from_numpy(rng.uniform(0.01, 0.5, (B, C, 6)))
        b_c = torch.from_numpy(rng.standard_normal((B, C, 3)))
        x_c = torch.from_numpy(rng.standard_normal((B, C, 6)))
        cm = torch.from_numpy(rng.standard_normal((B, C, 3)))
        a = -torch.from_numpy(rng.uniform(0.5, 3.0, (6, 3)))
        h0 = torch.from_numpy(rng.standard_normal((B, 6, 3)))
        y, hC = SSM._ssm_chunk(h0, dt_c, b_c, x_c, cm, a)
        h, ys = h0, []
        for t in range(C):
            h = torch.exp(dt_c[:, t, :, None] * a) * h + \
                dt_c[:, t, :, None] * b_c[:, t, None, :] * x_c[:, t, :, None]
            ys.append(torch.einsum("bds,bs->bd", h, cm[:, t]))
        torch.testing.assert_close(y, torch.stack(ys, dim=1), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(hC, h, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _ref_time_mix(ref, S, dtype, seed):
    rcfg, _ = _cfgs(RWKV, dtype)
    _, jp, _ = _params("rwkv_t")
    xj, _ = _x(S, rcfg.d_model, seed, dtype)
    return ref(("rwkv", S, dtype, seed), lambda: jax.jit(
        lambda p, x: RSSM.rwkv_time_mix(p, x, rcfg, _rules(rcfg),
                                        want_state=True))(jp, xj))


@pytest.mark.parametrize("S", [48, 100, 160])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_time_mix_matches_reference(ref, dtype, S):
    """S=48: three chunks of 16; S=100 and 160: one ragged chunk each (160
    is the longest single chunk still finite at these widths). The
    outputs and the end-of-sequence WKV state and shift."""
    want, wst = _ref_time_mix(ref, S, dtype, S)
    _, pcfg = _cfgs(RWKV, dtype)
    _, _, tp = _params("rwkv_t")
    _, xt = _x(S, pcfg.d_model, S, dtype)
    got, gst = SSM.rwkv_time_mix(tp, xt, pcfg, want_state=True)
    assert got.dtype == xt.dtype and gst["s"].dtype == torch.float32
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    for key in ("s", "shift"):
        _close(gst[key], wst[key], dtype, key)


def test_rwkv_time_mix_is_non_finite_at_a_long_ragged_s_as_the_reference(
        ref):
    """The reference's own behaviour, kept: at S=200 (not a multiple of
    16) the whole sequence is one chunk, ``k * exp(-cum)`` overflows
    float32 once |cum| passes ~88 (w ~ -0.5 a step here), and the output
    holds non-finite values in both packages (the finite values around
    them carry the overflow too, and are not compared). At S=208, a
    multiple of 16, both are finite and agree."""
    _, pcfg = _cfgs(RWKV)
    _, _, tp = _params("rwkv_t")
    for S in (200, 208):
        want, _ = _ref_time_mix(ref, S, "float32", 1)
        _, xt = _x(S, pcfg.d_model, 1, "float32")
        got, _ = SSM.rwkv_time_mix(tp, xt, pcfg, want_state=True)
        finite = S % 16 == 0
        assert bool(np.isfinite(_np(want)).all()) is finite
        assert bool(torch.isfinite(got).all()) is finite
        if finite:
            _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_decode_steps_match_reference_and_prefill(ref, dtype):
    """20 one-token steps of the time mix from the zero state against the
    reference's steps, and against the port's prefill over the same 20
    tokens (a ragged single chunk), outputs and end states."""
    S = 20
    rcfg, pcfg = _cfgs(RWKV, dtype)
    _, jp, tp = _params("rwkv_t")
    xj, xt = _x(S, pcfg.d_model, 9, dtype)
    rules = _rules(rcfg)
    step = jax.jit(lambda p, x, st: RSSM.rwkv_time_mix(p, x, rcfg, rules,
                                                       state=st))

    def ref_steps():
        init = RSSM.rwkv_state_init(rcfg, B)
        st = {"s": init["s"], "shift": init["shift_t"]}
        outs = []
        for t in range(S):
            o, st = step(jp, xj[:, t:t + 1], st)
            outs.append(o)
        return jnp.concatenate(outs, axis=1), st

    want, wst = ref(("rwkv-steps", dtype), ref_steps)
    init = SSM.rwkv_state_init(pcfg, B, device="cpu")
    st = {"s": init["s"], "shift": init["shift_t"]}
    outs = []
    for t in range(S):
        o, st = SSM.rwkv_time_mix(tp, xt[:, t:t + 1], pcfg, state=st)
        outs.append(o)
    got = torch.cat(outs, dim=1)
    _close(got, want, dtype)
    for key in ("s", "shift"):
        _close(st[key], wst[key], dtype, key)
    pre, pst = SSM.rwkv_time_mix(tp, xt, pcfg, want_state=True)
    _close(got, pre, dtype, "decode vs prefill")
    _close(st["s"], pst["s"], dtype, "decode vs prefill s")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_channel_mix_matches_reference(dtype):
    """Prefill over 24 positions (with and without the end state), then
    one decode step from that state, in both packages."""
    rcfg, pcfg = _cfgs(RWKV, dtype)
    _, jp, tp = _params("rwkv_c")
    xj, xt = _x(25, pcfg.d_model, 4, dtype)
    rules = _rules(rcfg)
    want, wst = RSSM.rwkv_channel_mix(jp, xj[:, :24], rcfg, rules,
                                      want_state=True)
    got, gst = SSM.rwkv_channel_mix(tp, xt[:, :24], pcfg, want_state=True)
    _close(got, want, dtype)
    _close(gst, wst, dtype, "state")
    assert SSM.rwkv_channel_mix(tp, xt[:, :24], pcfg)[1] is None
    want, wst = RSSM.rwkv_channel_mix(jp, xj[:, 24:], rcfg, rules,
                                      state=wst)
    got, gst = SSM.rwkv_channel_mix(tp, xt[:, 24:], pcfg, state=gst)
    _close(got, want, dtype, "decode")
    _close(gst, wst, dtype, "decode state")


# ---------------------------------------------------------------------------
# the model's decode cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_decode_step_carries_the_ssm_state(arch):
    """``decode_step`` keeps the cache it is handed and writes each SSM
    layer's new state into it (the stacked tensors, through the per-repeat
    views): after two steps every SSM state differs from zero and equals
    the reference's, whose decode returns its new cache."""
    rcfg, pcfg = _cfgs(arch)
    ref_p = RM.init_params(rcfg, jax.random.PRNGKey(1))
    port_p = params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    toks = np.random.default_rng(2).integers(0, pcfg.vocab_size, (B, 2)) \
        .astype(np.int32)
    rules = resolve_rules(MESH, rcfg, "decode")
    wcache = RM.init_cache(rcfg, B, 4, rules)
    gcache = M.init_cache(pcfg, B, 4, device="cpu")
    before = {p: {k: v.data_ptr() for k, v in c.items()}
              for p, c in gcache.items()}
    for t in range(2):
        _, wcache = RM.decode_step(ref_p, wcache,
                                   {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                   jnp.int32(t), rcfg, rules)
        _, out = M.decode_step(port_p, gcache,
                               {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                               t, pcfg)
        assert out is gcache
    n_ssm = 0
    for i, spec in enumerate(pcfg.pattern):
        c = gcache[f"pos{i}"]
        assert {k: v.data_ptr() for k, v in c.items()} == before[f"pos{i}"]
        if spec.attn not in ("mamba", "rwkv"):
            continue
        for key, val in c.items():
            assert bool(val.any()), f"pos{i} {key} is still zero"
            _close(val, wcache[f"pos{i}"][key], "float32", f"pos{i} {key}")
            n_ssm += 1
    assert n_ssm == (14 if arch == JAMBA else 3)


def test_jamba_bfloat16_parameters_carry_over():
    """jamba's CONFIG keeps its parameters in bfloat16: its SMOKE tree in
    that type goes through ``convert.params_from_numpy`` bit for bit (the
    Mamba leaves included) and the float32 forward on it equals the
    reference's within 1e-4."""
    pdt = configs.get_config(JAMBA).param_dtype
    assert pdt == "bfloat16"
    rcfg, pcfg = (dataclasses.replace(c, param_dtype=pdt)
                  for c in _cfgs(JAMBA))
    ref_p = RM.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_p)
    got = params_from_numpy(tree, "cpu")
    for key, leaf in tree["layers"]["pos0"]["mamba"].items():
        t = got["layers"]["pos0"]["mamba"][key]
        assert leaf.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      leaf.view(np.int16), err_msg=key)
    toks = np.random.default_rng(8).integers(0, pcfg.vocab_size, (B, 16)) \
        .astype(np.int32)
    want, _, _ = RM.forward(ref_p, {"tokens": jnp.asarray(toks)}, rcfg,
                            _rules(rcfg), remat=False)
    out, _, _ = M.forward(got, {"tokens": torch.from_numpy(toks)}, pcfg)
    _close(out, want, "float32")
