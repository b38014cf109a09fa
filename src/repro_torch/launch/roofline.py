"""Roofline terms of a dry-run cell on the H100 (reference:
``repro/launch/roofline.py``).

Three terms per (arch x shape) cell, in seconds:

    compute    = FLOPs_per_device / peak_FLOPs_per_card
    memory     = bytes_per_device / HBM_bw_per_card
    collective = wire_bytes_per_device / link_bw_per_card

The dry run (``launch/dryrun.py``) counts FLOPs and bytes per aten op
of the cell's step on ``meta`` tensors, where the reference reads XLA's
``cost_analysis()``. Collective wire bytes follow the reference's ring
accounting per collective:

    all-gather         result_bytes * (G-1)/G
    all-reduce         2 * result_bytes * (G-1)/G     (reduce-scatter + AG)
    reduce-scatter     result_bytes * (G-1)           (operand = result * G)
    all-to-all         result_bytes * (G-1)/G
    collective-permute result_bytes

The reference parses the collectives out of XLA's HLO text, which the port
does not have: ``collective_wire`` takes them as ``(kind, result_bytes,
group_size)``, the kind, size and group of each collective that a rank's
``dist.comm.Communicator`` runs.

MODEL_FLOPS (the useful-work yardstick), the reference's arithmetic
operation for operation:

    train:    6 * N_active * tokens  + 3 * attn_fwd
    prefill:  2 * N_active * tokens  +     attn_fwd
    decode:   2 * N_active * batch   +     attn_decode
    attn_fwd = 4 * H*hd * L_attn * tokens * avg_ctx   (causal: avg_ctx=S/2,
               swa: min(window, S/2)); ssm/rwkv state terms added analog.

Hardware constants: the NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet's
figures, not measurements of this port.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit (spec
# figures, as chip_smoke.py uses them; a card set below 700 W runs slower)
PEAK_FLOPS = 989e12          # bf16 on the tensor cores, per card
HBM_BW = 3.35e12             # bytes/s per card
# NVLink 4: 900 GB/s per card over both directions (data sheet), so 450e9
# bytes/s each way; the reference's ICI_BW is a TPU v5e link's 50e9
NVLINK_BW = 450e9            # bytes/s per card, one direction

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def collective_wire(collectives, n_devices: int) -> dict:
    """Per-device wire bytes by collective kind (+ op counts), the
    reference's ``parse_collectives`` accounting over ``collectives``: an
    iterable of ``(kind, result_bytes, group_size)``. ``kind`` is XLA's
    spelling or the Communicator's (``all_reduce``); a ``group_size`` of
    None is the whole mesh (``n_devices``)."""
    out = dict.fromkeys(KINDS, 0.0)
    counts = dict.fromkeys(out, 0)
    for kind, rbytes, group in collectives:
        op = kind.replace("_", "-")
        if op not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        g = n_devices if group is None else max(int(group), 1)
        ring = (g - 1) / g if g > 1 else 0.0
        if op == "all-gather":
            wire = rbytes * ring
        elif op == "all-reduce":
            wire = 2.0 * rbytes * ring
        elif op == "reduce-scatter":
            wire = rbytes * (g - 1)            # operand = result * G
        elif op == "all-to-all":
            wire = rbytes * ring
        else:                                   # collective-permute
            wire = rbytes
        out[op] += wire
        counts[op] += 1
    out["total"] = sum(out.values())
    out["counts"] = counts
    return out


# ---------------------------------------------------------------------------
# model FLOPs (useful-work yardstick)
# ---------------------------------------------------------------------------

def _attn_layer_counts(cfg):
    full = sum(1 for s in cfg.pattern if s.attn == "full") * cfg.n_repeats
    swa = sum(1 for s in cfg.pattern if s.attn == "swa") * cfg.n_repeats
    mamba = sum(1 for s in cfg.pattern if s.attn == "mamba") * cfg.n_repeats
    rwkv = sum(1 for s in cfg.pattern if s.attn == "rwkv") * cfg.n_repeats
    return full, swa, mamba, rwkv


def model_flops(cfg, mode: str, batch: int, seq: int) -> float:
    """Analytic useful FLOPs for one step of this cell."""
    n_act = cfg.active_param_count()
    # the input embedding table is a gather, not a matmul — exclude it
    # from the 2N/6N term (the LM head stays: it is a real matmul)
    if cfg.input_mode == "tokens":
        n_act -= cfg.vocab_padded * cfg.d_model
    elif cfg.input_mode == "codebooks":
        n_act -= cfg.n_codebooks * cfg.vocab_padded * cfg.d_model
    full, swa, mamba, rwkv = _attn_layer_counts(cfg)
    hhd = cfg.n_heads * cfg.hd
    di, ds = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state

    if mode in ("decode", "long_decode"):
        toks = batch
        ctx_full, ctx_swa = seq, min(cfg.window, seq)
    else:
        toks = batch * seq
        ctx_full, ctx_swa = seq / 2.0, min(cfg.window, seq / 2.0)

    attn_fwd = 4.0 * hhd * toks * (full * ctx_full + swa * ctx_swa)
    ssm_fwd = toks * (mamba * 12.0 * di * ds + rwkv * 6.0 *
                      cfg.d_model * cfg.rwkv_head_dim)
    if mode == "train":
        return 6.0 * n_act * toks + 3.0 * (attn_fwd + ssm_fwd)
    return 2.0 * n_act * toks + attn_fwd + ssm_fwd


def three_terms(flops_per_dev: float, bytes_per_dev: float,
                wire_bytes_per_dev: float) -> dict:
    compute = flops_per_dev / PEAK_FLOPS
    memory = bytes_per_dev / HBM_BW
    collective = wire_bytes_per_dev / NVLINK_BW
    bound = max(compute, memory, collective)
    name = ("compute" if bound == compute else
            "memory" if bound == memory else "collective")
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "bound_s": bound,
            "bottleneck": name}


def summarize(cfg, mode, batch, seq, n_devices,
              flops_per_dev, bytes_per_dev, wire_per_dev) -> dict:
    terms = three_terms(flops_per_dev, bytes_per_dev, wire_per_dev)
    mf = model_flops(cfg, mode, batch, seq)
    mf_per_dev = mf / n_devices
    useful_s = mf_per_dev / PEAK_FLOPS
    terms.update({
        "model_flops": mf,
        # the reference's record keys; here the counts are of aten ops
        "hlo_flops_per_dev": flops_per_dev,
        "hlo_bytes_per_dev": bytes_per_dev,
        "wire_bytes_per_dev": wire_per_dev,
        "useful_ratio": mf_per_dev / max(flops_per_dev, 1.0),
        "roofline_frac": useful_s / max(terms["bound_s"], 1e-30),
    })
    return terms


def mfu(cfg, mode: str, batch: int, seq: int, seconds: float,
        n_devices: int = 1) -> float:
    """Model FLOPs utilization of a measured step: ``model_flops`` over
    ``seconds`` over the cards' bf16 peak."""
    return model_flops(cfg, mode, batch, seq) / seconds / (
        PEAK_FLOPS * n_devices)
