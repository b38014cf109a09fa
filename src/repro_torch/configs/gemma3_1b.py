"""gemma3-1b [dense]: 26L... pattern requires n_layers % period == 0, the
public model interleaves 5 local(sliding-window):1 global. 26 layers do not
divide the 6-layer pattern; following the released config (5:1 with the
final block truncated is not expressible in a scanned stack), we use the
exact 5:1 pattern with 24 scanned layers + config note, OR keep 26 via a
13-layer x (5:1+extra) — we keep the published pattern and round layers to
24 for the scan (noted in DESIGN.md; the dry-run FLOPs extrapolation uses
the pattern period exactly).

d_model=1152, 4H (GQA kv=1, head_dim=256), d_ff=6912, vocab=262144,
window=512, dual RoPE theta (10k local / 1M global), logit softcap.
[hf:google/gemma-3-1b-pt]

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``); sharding overrides and training
hyperparameters belong to later slices and are not carried."""
from repro_torch.models.config import LayerSpec, ModelConfig

_PATTERN = tuple([LayerSpec("swa", "dense")] * 5 +
                 [LayerSpec("full", "dense")])

CONFIG = ModelConfig(
    name="gemma3-1b",
    n_layers=24, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    mlp_kind="swiglu", window=512,
    rope_theta=1e4, rope_theta_global=1e6,
    pattern=_PATTERN,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    n_layers=6, d_model=48, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=256,
    mlp_kind="swiglu", window=8,
    rope_theta=1e4, rope_theta_global=1e6,
    pattern=_PATTERN,
)

# 5:1 local:global -> compute is dominated by the 512-token window; the
# occasional global layer is linear per decoded token. Sub-quadratic enough
# for the long_500k decode cell.
LONG_CONTEXT_OK = True
